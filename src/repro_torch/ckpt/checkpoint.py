"""Sharded checkpointing with manifests, async writes, and atomic commits.

Layout of a checkpoint directory (the reference package's format: a
checkpoint either package writes restores in the other):

    step_000123/
      manifest.json            # tree structure, shapes, dtypes, crc32s
      shard_p0.npz             # this process's leaves (single-host: all)
      COMMIT                   # written last: restore ignores dirs without it

Restart safety: writes go to ``step_X.tmp`` and are atomically renamed
after COMMIT; `latest_step` scans only committed directories.  The TMR
variant in :mod:`repro_torch.ckpt.tmr_store` layers X-replica majority
voting on top (the paper's §8.1 error-correction case study applied to
checkpoints).

Leaves are tensors (on any device) or numpy arrays, named as the
reference names them (:mod:`repro_torch.core.tree`).  A dtype numpy
lacks (``bfloat16``) is stored as its raw words with ``encoded: true``,
and a ``bfloat16`` leaf is read back by viewing those words as
``torch.bfloat16``.  Restored leaves take the dtype and the device of
their counterpart in ``tree_like``.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import zlib
from typing import Optional

import numpy as np
import torch

from repro_torch.core import tree as tree_util

#: numpy dtypes the npz format round-trips; anything else is encoded.
_PLAIN = (np.float64, np.float32, np.float16, np.int64, np.int32,
          np.int16, np.int8, np.uint64, np.uint32, np.uint16, np.uint8,
          np.bool_)
#: Raw-word views of an encoded leaf, by itemsize.
_WORDS = {1: (torch.uint8, np.uint8), 2: (torch.int16, np.uint16),
          4: (torch.int32, np.uint32)}


def _encode(arr: np.ndarray) -> tuple[np.ndarray, str, bool]:
    """``(array to store, dtype name, encoded)``: a dtype the npz format
    does not round-trip is stored as its raw words."""
    if arr.dtype in _PLAIN:
        return arr, str(arr.dtype), False
    return arr.view(_WORDS[arr.dtype.itemsize][1]), str(arr.dtype), True


def _to_numpy(leaf) -> tuple[np.ndarray, str, bool]:
    if not isinstance(leaf, torch.Tensor):
        return _encode(np.asarray(leaf))
    t = leaf.detach().cpu()
    try:
        return _encode(t.numpy())
    except TypeError:  # a dtype numpy lacks (bfloat16 etc.)
        view, words = _WORDS[t.element_size()]
        return (t.view(view).numpy().view(words),
                str(t.dtype).removeprefix("torch."), True)


def save(tree, directory: str, step: int, process: int = 0,
         blocking: bool = True) -> str:
    """Write a checkpoint; returns the committed path."""
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)

    arrays = {}
    manifest = {"step": step, "leaves": []}
    for i, (name, leaf) in enumerate(tree_util.flatten_with_path(tree)[0]):
        arr, dtype_name, encoded = _to_numpy(leaf)
        key = f"leaf_{i}"
        arrays[key] = arr
        manifest["leaves"].append({
            "name": name, "key": key, "shape": list(arr.shape),
            "dtype": dtype_name, "encoded": encoded,
            "crc32": zlib.crc32(np.ascontiguousarray(arr).tobytes()),
        })

    def _write():
        np.savez(os.path.join(tmp, f"shard_p{process}.npz"), **arrays)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        with open(os.path.join(tmp, "COMMIT"), "w") as f:
            f.write("ok")
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)

    if blocking:
        _write()
    else:
        t = threading.Thread(target=_write, daemon=True)
        t.start()
        t.join(timeout=0)  # fire and forget; tests use blocking=True
    return final


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = []
    for d in os.listdir(directory):
        if d.startswith("step_") and not d.endswith(".tmp"):
            if os.path.exists(os.path.join(directory, d, "COMMIT")):
                steps.append(int(d.split("_")[1]))
    return max(steps) if steps else None


def _leaf_like(arr, proto):
    """A restored array as ``proto``'s counterpart: a tensor of its dtype
    on its device (a numpy prototype gives a CPU tensor of its dtype);
    a prototype without a dtype gets the array as stored."""
    if not hasattr(proto, "dtype"):
        return arr
    if isinstance(arr, np.ndarray):
        arr = torch.from_numpy(arr)
    if isinstance(proto, torch.Tensor):
        return arr.to(device=proto.device, dtype=proto.dtype)
    return arr.to(torch.from_numpy(np.empty(0, proto.dtype)).dtype)


def restore(tree_like, directory: str, step: Optional[int] = None,
            process: int = 0, verify: bool = True):
    """Restore into the structure of ``tree_like`` (shapes must match)."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    data = np.load(os.path.join(path, f"shard_p{process}.npz"))
    by_name = {}
    for leaf in manifest["leaves"]:
        arr = data[leaf["key"]]
        if verify:
            crc = zlib.crc32(np.ascontiguousarray(arr).tobytes())
            if crc != leaf["crc32"]:
                raise IOError(
                    f"checkpoint corruption in {leaf['name']}: crc mismatch "
                    f"(have {crc}, want {leaf['crc32']}) — use the TMR "
                    f"store to self-heal (repro_torch.ckpt.tmr_store)")
        if leaf.get("encoded") and leaf["dtype"] == "bfloat16":
            arr = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        by_name[leaf["name"]] = arr

    named, structure = tree_util.flatten_with_path(tree_like)
    leaves = [_leaf_like(by_name[name], proto) for name, proto in named]
    return tree_util.unflatten(structure, leaves), step
