"""The port's TMR vote and checkpoint store against the reference's.

``repro_torch.pud.tmr``, ``repro_torch.ckpt.checkpoint`` and
``repro_torch.ckpt.tmr_store`` are held to ``repro.pud.tmr``,
``repro.ckpt.checkpoint`` and ``repro.ckpt.tmr_store``: votes bit for
bit over every dtype the store protects, the same ``manifest.json`` and
shard arrays for the same tree, checkpoints that restore across the two
packages in both directions, the same corruption verdicts, and the same
healed trees and unhealthy-replica counts.  The SDC model ``corrupt``
draws its flips either from a ``torch.Generator`` (its statistics held
to theory) or from a threefry key, and then flips the bits the
reference's ``jax.random.bernoulli`` flips under the same key.
"""

import json
import os
import zipfile

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.ckpt import checkpoint as ref_ckpt
from repro.ckpt import tmr_store as ref_store
from repro.pud import tmr as ref_tmr
from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.ckpt import tmr_store
from repro_torch.core import bitplanes as bp
from repro_torch.core import tree as tree_util
from repro_torch.kernels.majx import ops as majx_ops
from repro_torch.pud import tmr

DTYPES = ["float32", "bfloat16", "float16", "int8", "uint8", "int32"]


# ------------------------------------------------------- one array, both


def rand_np(rng, dtype: str, shape) -> np.ndarray:
    """Random finite values of ``dtype`` as numpy (bf16 as ml_dtypes)."""
    if dtype in ("float32", "float16"):
        return rng.standard_normal(shape).astype(dtype)
    if dtype == "bfloat16":
        f = rng.standard_normal(shape).astype(np.float32)
        return (f.view(np.uint32) >> 16).astype(np.uint16).view(
            ml_dtypes.bfloat16)
    info = np.iinfo(dtype)
    return rng.integers(info.min, info.max, shape, endpoint=True,
                        dtype=dtype)


def to_torch(a: np.ndarray) -> torch.Tensor:
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def bits(x) -> np.ndarray:
    """The raw bytes of a tensor or array, as uint8."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().contiguous()
        return x.view(torch.uint8).numpy().reshape(-1) if x.numel() else \
            np.zeros(0, np.uint8)
    return np.ascontiguousarray(np.asarray(x)).view(np.uint8).reshape(-1)


def flip_bytes(rng, a: np.ndarray, n: int) -> np.ndarray:
    out = a.copy()
    raw = out.view(np.uint8).reshape(-1)
    pos = rng.choice(raw.size, size=min(n, raw.size), replace=False)
    raw[pos] ^= rng.integers(1, 256, size=pos.size, dtype=np.uint8)
    return out


def replicas(rng, clean: np.ndarray, x: int) -> list[np.ndarray]:
    """``x`` replicas of ``clean``, the first floor(x/2) corrupted at
    random bytes (a minority, which the vote must heal)."""
    return [flip_bytes(rng, clean, 1 + clean.nbytes // 3)
            if i < x // 2 else clean.copy() for i in range(x)]


# ------------------------------------------------------------- the vote


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("x", [3, 5, 7, 9])
def test_vote_array_bit_exact(x, dtype):
    rng = np.random.default_rng(x * 100 + DTYPES.index(dtype))
    clean = rand_np(rng, dtype, (37,))          # ragged for 1- and 2-byte
    reps = replicas(rng, clean, x)
    want = ref_tmr.vote_array([jnp.asarray(r) for r in reps])
    got = tmr.vote_array([to_torch(r) for r in reps])
    assert str(got.dtype).removeprefix("torch.") == dtype
    assert tuple(got.shape) == clean.shape
    assert (bits(got) == bits(want)).all()
    assert (bits(got) == bits(clean)).all()
    kernel = majx_ops.vote([to_torch(r) for r in reps])
    assert (bits(kernel) == bits(clean)).all()


@pytest.mark.parametrize("x", [3, 5, 7, 9])
def test_vote_words_bit_exact(x):
    rng = np.random.default_rng(x)
    words = rng.integers(0, 2**32, (x, 4, 33), dtype=np.uint32)
    want = np.asarray(ref_tmr.vote_words(jnp.asarray(words)))
    assert (bp.to_u32(tmr.vote_words(bp.from_u32(words, "cpu")))
            == want).all()
    with pytest.raises(ValueError, match="odd"):
        tmr.vote_words(bp.from_u32(words[:2], "cpu"))


def test_vote_pytree_bit_exact():
    rng = np.random.default_rng(4)
    clean = {"a": rand_np(rng, "float32", (64,)),
             "b": {"c": rand_np(rng, "int32", (10,)),
                   "d": [rand_np(rng, "bfloat16", (3, 5)),
                         rand_np(rng, "int8", (7,))]}}
    flat_clean = jax.tree.leaves(clean)
    reps = [jax.tree.unflatten(jax.tree.structure(clean),
                               [flip_bytes(rng, a, 3) if i == 1 else a
                                for a in flat_clean]) for i in range(3)]
    want = ref_tmr.vote_pytree([jax.tree.map(jnp.asarray, r)
                                for r in reps])
    got = tmr.vote_pytree([jax.tree.map(to_torch, r) for r in reps])
    names = [n for n, _ in tree_util.flatten_with_path(got)[0]]
    assert names == [jax.tree_util.keystr(p) for p, _ in
                     jax.tree_util.tree_flatten_with_path(want)[0]]
    for g, w, c in zip(tree_util.flatten(got)[0], jax.tree.leaves(want),
                       flat_clean):
        assert (bits(g) == bits(w)).all() and (bits(g) == bits(c)).all()


def test_residual_word_error_rate_equals_reference():
    for p in (1e-3, 1e-2, 0.1):
        for x in (3, 5, 7, 9):
            assert tmr.residual_word_error_rate(p, x) == \
                ref_tmr.residual_word_error_rate(p, x)


def test_corrupt_and_vote_meet_theory():
    """The reference's statistical test (``test_tmr_erase.py``) at its
    size and tolerance, on flips drawn from a seeded generator."""
    x = torch.zeros(200_000, dtype=torch.int32)
    p = 1e-2
    gen = torch.Generator().manual_seed(3)
    reps = [tmr.corrupt(x, gen, p) for _ in range(3)]
    flipped = sum(int(bp.popcount(r).sum()) for r in reps)
    assert flipped / (3 * x.numel() * 32) == pytest.approx(p, rel=0.05)
    voted = tmr.vote_array(reps)
    bad = float((voted != x).float().mean())
    assert bad == pytest.approx(tmr.residual_word_error_rate(p, 3),
                                rel=0.25)
    again = tmr.corrupt(x, torch.Generator().manual_seed(3), p)
    assert torch.equal(again, reps[0])          # the seed fixes the flips


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_corrupt_keeps_shape_and_dtype(dtype):
    rng = np.random.default_rng(1)
    clean = to_torch(rand_np(rng, dtype, (4, 33)))
    hit = tmr.corrupt(clean, torch.Generator().manual_seed(0), 0.3)
    assert hit.shape == clean.shape and hit.dtype == clean.dtype
    assert (bits(hit) != bits(clean)).any()
    healed = tmr.vote_array([hit, clean, clean])
    assert (bits(healed) == bits(clean)).all()


# ------------------------------------------------------------ the format


def ref_tree(rng):
    """A numpy tree with every leaf kind the store protects: bf16, f32,
    a ragged int8, nested dict, list and tuple."""
    return {"w": rand_np(rng, "bfloat16", (16, 24)),
            "opt": [rand_np(rng, "float32", (8, 8)),
                    (rand_np(rng, "int32", (5,)),
                     rand_np(rng, "float16", (3, 3)))],
            "emb": rand_np(rng, "int8", (10, 33)),
            "meta": {"step_bits": rand_np(rng, "uint8", (7,)),
                     "b": {"c": rand_np(rng, "float32", (2,))}}}


def as_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def as_torch(tree):
    leaves, structure = tree_util.flatten(tree)
    return tree_util.unflatten(structure, [to_torch(a) for a in leaves])


def read_dir(path):
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(path, "shard_p0.npz")) as data:
        arrays = {k: data[k] for k in data.files}
    return manifest, arrays


def assert_tree_bits(got, want_np):
    """``got`` (port tree) holds ``want_np``'s leaves bit for bit, with
    their dtypes, in the same places."""
    names = [n for n, _ in tree_util.flatten_with_path(got)[0]]
    want_names = [n for n, _ in tree_util.flatten_with_path(want_np)[0]]
    assert names == want_names
    for g, w in zip(tree_util.flatten(got)[0],
                    tree_util.flatten(want_np)[0]):
        assert isinstance(g, torch.Tensor)
        assert str(g.dtype).removeprefix("torch.") == str(w.dtype)
        assert tuple(g.shape) == w.shape
        assert (bits(g) == bits(w)).all()


def test_manifest_equals_reference(tmp_path):
    tree = ref_tree(np.random.default_rng(0))
    ref_path = ref_ckpt.save(as_jax(tree), str(tmp_path / "ref"), 12)
    path = ckpt.save(as_torch(tree), str(tmp_path / "port"), 12)
    assert os.path.basename(path) == os.path.basename(ref_path) == \
        "step_00000012"
    assert sorted(os.listdir(path)) == sorted(os.listdir(ref_path)) == \
        ["COMMIT", "manifest.json", "shard_p0.npz"]
    manifest, arrays = read_dir(path)
    ref_manifest, ref_arrays = read_dir(ref_path)
    assert manifest == ref_manifest
    assert [leaf["name"] for leaf in manifest["leaves"]][:2] == \
        ["['emb']", "['meta']['b']['c']"]
    bf16 = [leaf for leaf in manifest["leaves"] if leaf["name"] == "['w']"]
    assert bf16[0]["dtype"] == "bfloat16" and bf16[0]["encoded"]
    assert arrays.keys() == ref_arrays.keys()
    for k in arrays:
        assert arrays[k].dtype == ref_arrays[k].dtype
        assert (arrays[k] == ref_arrays[k]).all()
    assert ckpt.latest_step(str(tmp_path / "port")) == 12


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    tree = ref_tree(np.random.default_rng(1))
    ref_ckpt.save(as_jax(tree), str(tmp_path), 3)
    got, step = ckpt.restore(as_torch(tree), str(tmp_path))
    assert step == 3
    assert_tree_bits(got, tree)


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    tree = ref_tree(np.random.default_rng(2))
    ckpt.save(as_torch(tree), str(tmp_path), 4)
    got, step = ref_ckpt.restore(as_jax(tree), str(tmp_path))
    assert step == 4
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(tree)):
        assert g.dtype == w.dtype and (bits(g) == bits(w)).all()


def test_restore_takes_the_prototypes_dtype_and_device(tmp_path):
    """A leaf restores as its counterpart in ``tree_like``: its dtype
    (cast as the reference casts) and its device."""
    tree = {"a": np.arange(6, dtype=np.float32).reshape(2, 3),
            "b": np.arange(4, dtype=np.int32)}
    ckpt.save(as_torch(tree), str(tmp_path), 0)
    like = {"a": torch.zeros((2, 3), dtype=torch.float16, device="meta"),
            "b": np.zeros(4, np.int32)}
    got, _ = ckpt.restore(like, str(tmp_path))
    assert got["a"].device.type == "meta" and got["a"].dtype == \
        torch.float16
    assert got["b"].dtype == torch.int32 and got["b"].tolist() == \
        [0, 1, 2, 3]
    ref, _ = ref_ckpt.restore({"a": jnp.zeros((2, 3), jnp.float16),
                               "b": np.zeros(4, np.int32)}, str(tmp_path))
    assert np.asarray(ref["a"]).dtype == np.float16


def rewrite_leaf(step_dir: str, key: str, rng) -> None:
    """Flip bytes of one leaf inside a shard, keeping the zip valid: the
    manifest's crc32 then fails while the shard still reads."""
    path = os.path.join(step_dir, "shard_p0.npz")
    with np.load(path) as data:
        arrays = {k: data[k] for k in data.files}
    arrays[key] = flip_bytes(rng, arrays[key], 5)
    np.savez(path, **arrays)


def flip_file_byte(step_dir: str) -> None:
    """Flip one byte in the middle of a shard file (the reference's
    test corrupts so): the zip's own CRC then fails on read."""
    path = os.path.join(step_dir, "shard_p0.npz")
    blob = bytearray(open(path, "rb").read())
    blob[len(blob) // 3] ^= 0xFF
    open(path, "wb").write(bytes(blob))


def _outcome(fn):
    try:
        fn()
        return None
    except Exception as e:  # noqa: BLE001 - compared across packages
        return type(e).__name__, str(e)


def test_corruption_is_detected(tmp_path):
    tree = ref_tree(np.random.default_rng(5))
    for sub, save in (("ref", lambda d: ref_ckpt.save(as_jax(tree), d, 1)),
                      ("port", lambda d: ckpt.save(as_torch(tree), d, 1))):
        rewrite_leaf(save(str(tmp_path / sub)), "leaf_2",
                     np.random.default_rng(9))
    ref = _outcome(lambda: ref_ckpt.restore(as_jax(tree),
                                            str(tmp_path / "ref")))
    port = _outcome(lambda: ckpt.restore(as_torch(tree),
                                         str(tmp_path / "port")))
    assert port[0] == ref[0] == "OSError"       # IOError
    head = "checkpoint corruption in ['meta']['step_bits']: crc mismatch"
    assert port[1].startswith(head) and ref[1].startswith(head)
    assert port[1].split(" — ")[0] == ref[1].split(" — ")[0]
    # verify=False reads the corrupted bytes back, as the reference does
    got, _ = ckpt.restore(as_torch(tree), str(tmp_path / "port"),
                          verify=False)
    want, _ = ref_ckpt.restore(as_jax(tree), str(tmp_path / "ref"),
                               verify=False)
    for g, w in zip(tree_util.flatten(got)[0], jax.tree.leaves(want)):
        assert (bits(g) == bits(w)).all()
    # a flipped file byte fails the zip's own CRC in both
    ref_ckpt.save(as_jax(tree), str(tmp_path / "ref"), 2)
    ckpt.save(as_torch(tree), str(tmp_path / "port"), 2)
    for sub in ("ref", "port"):
        flip_file_byte(str(tmp_path / sub / "step_00000002"))
    assert _outcome(lambda: ckpt.restore(as_torch(tree), str(
        tmp_path / "port")))[0] == _outcome(lambda: ref_ckpt.restore(
            as_jax(tree), str(tmp_path / "ref")))[0] == "BadZipFile"


# ----------------------------------------------------------- the TMR store


@pytest.mark.parametrize("use_kernel", [False, True],
                         ids=["plain", "kernel"])
@pytest.mark.parametrize("x,bad,how", [(3, [1], "leaf"), (5, [0, 3], "leaf"),
                                       (3, [1], "file"),
                                       (5, [2, 4], "file")])
def test_tmr_store_heals_like_reference(tmp_path, x, bad, how,
                                        use_kernel):
    rng = np.random.default_rng(x * 10 + len(bad))
    tree = {"w": rand_np(rng, "bfloat16", (8, 12)),
            "opt": [rand_np(rng, "float32", (6,)),
                    rand_np(rng, "int8", (5, 7))]}
    ref_store.save(as_jax(tree), str(tmp_path / "ref"), 2, replicas=x)
    tmr_store.save(as_torch(tree), str(tmp_path / "port"), 2, replicas=x)
    for sub in ("ref", "port"):
        for r in bad:
            step_dir = str(tmp_path / sub / f"replica_{r}" / "step_00000002")
            if how == "leaf":
                for key in ("leaf_0", "leaf_1", "leaf_2"):
                    rewrite_leaf(step_dir, key, np.random.default_rng(r))
            else:
                flip_file_byte(step_dir)
    want, ref_step, ref_bad = ref_store.restore(
        as_jax(tree), str(tmp_path / "ref"), use_kernel=use_kernel)
    before = majx_ops.launches
    got, step, n_bad = tmr_store.restore(
        as_torch(tree), str(tmp_path / "port"), use_kernel=use_kernel)
    assert majx_ops.launches == before          # the CPU route launches none
    assert (step, n_bad) == (ref_step, ref_bad) == (2, len(bad))
    assert_tree_bits(got, tree)
    for g, w in zip(tree_util.flatten(got)[0], jax.tree.leaves(want)):
        assert (bits(g) == bits(w)).all()
    # scrub rewrites every bad replica; then each restores verified
    assert tmr_store.scrub(as_torch(tree), str(tmp_path / "port")) == \
        ref_store.scrub(as_jax(tree), str(tmp_path / "ref")) == len(bad)
    for r in range(x):
        again, _ = ckpt.restore(as_torch(tree), str(
            tmp_path / "port" / f"replica_{r}"), verify=True)
        assert_tree_bits(again, tree)
    assert tmr_store.scrub(as_torch(tree), str(tmp_path / "port")) == 0


def test_tmr_store_refuses_even_replicas_and_empty_dirs(tmp_path):
    tree = {"a": np.zeros(3, np.float32)}
    for store in (ref_store, tmr_store):
        with pytest.raises(ValueError, match="odd"):
            store.save(tree, str(tmp_path), 0, replicas=2)
    os.makedirs(tmp_path / "empty")
    assert _outcome(lambda: tmr_store.restore(tree, str(tmp_path / "empty"))
                    ) == _outcome(lambda: ref_store.restore(
                        tree, str(tmp_path / "empty")))


def test_zip_layout_is_numpys(tmp_path):
    """The shard is a plain ``np.savez`` archive of ``leaf_i.npy``."""
    ckpt.save(as_torch(ref_tree(np.random.default_rng(3))),
              str(tmp_path), 0)
    with zipfile.ZipFile(tmp_path / "step_00000000" / "shard_p0.npz") as z:
        assert sorted(z.namelist()) == [f"leaf_{i}.npy" for i in range(7)]


def test_tree_names_and_order_are_jaxs():
    """The port's flattener names and orders leaves as JAX's pytree
    utilities do, and rebuilds the same containers."""
    import collections

    Pair = collections.namedtuple("Pair", "m v")
    tree = {"w": 1, "opt": [2, (3, None)], "b": {"z": 4, "a": 5},
            "n": Pair(6, 7), 3: 8,
            "o": collections.OrderedDict([("y", 9), ("x", 10)]),
            "empty": []}
    tree = {str(k): v for k, v in tree.items()}
    ref_leaves, ref_def = jax.tree_util.tree_flatten_with_path(tree)
    named, _ = tree_util.flatten_with_path(tree)
    assert [n for n, _ in named] == [jax.tree_util.keystr(p)
                                     for p, _ in ref_leaves]
    assert [v for _, v in named] == [v for _, v in ref_leaves]
    leaves, structure = tree_util.flatten(tree)
    rebuilt = tree_util.unflatten(structure, [v * 10 for v in leaves])
    assert rebuilt == jax.tree_util.tree_unflatten(
        ref_def, [v * 10 for _, v in ref_leaves])
    assert type(rebuilt["n"]) is Pair
    assert list(rebuilt["o"]) == ["y", "x"]
    with pytest.raises(ValueError, match="more leaves"):
        tree_util.unflatten(structure, leaves + [0])


def test_two_faulty_of_three_returns_the_failed_replica(tmp_path):
    """Pins a fault of the reference (ROADMAP queue 3), copied: replica
    0 readable but failing its crc32, replica 1 unreadable, replica 2
    healthy.  Two trees remain, the store drops the last to keep the
    count odd and returns replica 0's corrupted tree unvoted."""
    tree = {"a": rand_np(np.random.default_rng(0), "float32", (64,))}
    outs = []
    for sub, store, conv in (("ref", ref_store, as_jax),
                             ("port", tmr_store, as_torch)):
        store.save(conv(tree), str(tmp_path / sub), 1, replicas=3)
        rewrite_leaf(str(tmp_path / sub / "replica_0" / "step_00000001"),
                     "leaf_0", np.random.default_rng(1))
        flip_file_byte(str(tmp_path / sub / "replica_1" / "step_00000001"))
        got, _, bad = store.restore(conv(tree), str(tmp_path / sub))
        outs.append((bits(got["a"]), bad))
    (ref_bits, ref_bad), (port_bits, port_bad) = outs
    assert ref_bad == port_bad == 2
    assert (port_bits == ref_bits).all()
    assert (port_bits != bits(tree["a"])).any()    # not the healthy data


# ------------------------------------- inputs the reference takes, 64 bits


def _vote_inputs():
    w = np.random.default_rng(9).integers(0, 2**32, (3, 70), dtype=np.uint32)
    return w, {
        "numpy": w,
        "list_of_numpy_rows": list(w),
        "list_of_lists": w.tolist(),
        "int64_tensor": torch.from_numpy(w.astype(np.int64)),
        "uint32_tensor": torch.from_numpy(w.copy()),
        "list_of_int32_tensors": [bp.from_u32(r, "cpu") for r in w],
        "negative_int64_tensor": torch.from_numpy(
            w.astype(np.int64) - 2**32),
        "wide_int64_tensor": torch.from_numpy(w.astype(np.int64) + 7 * 2**32),
        "list_of_uint32_tensors": [torch.from_numpy(r.copy()) for r in w],
    }


@pytest.mark.parametrize("kind", sorted(_vote_inputs()[1]))
def test_vote_words_takes_what_the_reference_takes(kind):
    """``vote_words`` reads numpy arrays, lists of rows and uint32 or
    int64 tensors as the reference's ``jnp.asarray(.., jnp.uint32)``
    does (it raised ``TypeError`` on all but int32 tensors before)."""
    w, inputs = _vote_inputs()
    want = np.asarray(ref_tmr.vote_words(w if kind != "list_of_lists"
                                         else w.tolist()))
    got = tmr.vote_words(inputs[kind])
    assert got.dtype == torch.int32 and (bp.to_u32(got) == want).all()


@pytest.mark.parametrize("dtype", [np.int8, np.int16, np.uint8, np.bool_])
def test_vote_words_narrow_tensors_wrap_as_numpy(dtype):
    """Integer tensors narrower than a word (negative values too) vote as
    their ``np.asarray(.., np.uint32)`` words."""
    w = np.random.default_rng(3).integers(-128, 128, (3, 50)).astype(dtype)
    want = np.asarray(ref_tmr.vote_words(w.astype(np.uint32)))
    got = tmr.vote_words(torch.from_numpy(w))
    assert got.dtype == torch.int32 and (bp.to_u32(got) == want).all()


@pytest.mark.parametrize("dtype", ["uint32", "int64"])
def test_vote_words_converts_tensors_where_they_lie(dtype, monkeypatch):
    """uint32 and int64 replica tensors become words on their own device:
    no ``.cpu()``, ``.numpy()`` or upload through ``from_u32`` (the card's
    twin of this test is in ``test_torch_cuda.py``)."""
    w = np.random.default_rng(8).integers(0, 2**32, (3, 97), dtype=np.uint32)
    reps = torch.from_numpy(w.copy() if dtype == "uint32" else
                            w.astype(np.int64) - 2**32)
    want = np.asarray(ref_tmr.vote_words(w))

    def host_copy(*a, **kw):
        raise AssertionError("the replicas went through the host")

    with monkeypatch.context() as m:
        for obj, name in ((torch.Tensor, "cpu"), (torch.Tensor, "numpy"),
                          (bp, "from_u32")):
            m.setattr(obj, name, host_copy)
        got = tmr.vote_words(reps)
    assert got.dtype == torch.int32 and (bp.to_u32(got) == want).all()


WIDE_TREE = {"x": np.array([1 + 2**-40], np.float64),
             "i": np.array([2**40 + 1], np.int64)}


@pytest.mark.parametrize("use_kernel", [False, True],
                         ids=["plain", "kernel"])
def test_64bit_leaves_restore_exactly(tmp_path, use_kernel):
    """A float64 and an int64 leaf, saved as 3 replicas with replica 1
    corrupted: the port's TMR restore votes each 8-byte element as two
    words and returns both leaves exactly, with their dtypes.  The
    reference (ROADMAP queue 3) narrows both silently, with 64-bit types
    disabled: float32 [1.0] and int32 [1]."""
    for sub, store, tree in (("ref", ref_store, WIDE_TREE),
                             ("port", tmr_store, as_torch(WIDE_TREE))):
        store.save(tree, str(tmp_path / sub), 4, replicas=3)
        step_dir = str(tmp_path / sub / "replica_1" / "step_00000004")
        for key in ("leaf_0", "leaf_1"):
            rewrite_leaf(step_dir, key, np.random.default_rng(5))
    got, step, bad = tmr_store.restore(as_torch(WIDE_TREE),
                                       str(tmp_path / "port"),
                                       use_kernel=use_kernel)
    assert (step, bad) == (4, 1)
    assert_tree_bits(got, WIDE_TREE)
    assert got["x"].dtype == torch.float64 and got["i"].dtype == torch.int64
    want, _, ref_bad = ref_store.restore(WIDE_TREE, str(tmp_path / "ref"),
                                         use_kernel=use_kernel)
    assert ref_bad == 1
    assert want["x"].dtype == jnp.float32 and want["i"].dtype == jnp.int32
    assert float(want["x"][0]) == 1.0 and int(want["i"][0]) == 1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8", "int32"])
def test_corrupt_key_path_equals_reference(dtype):
    """``corrupt`` under a :mod:`repro_torch.core.rng` key flips the
    bits ``repro.pud.tmr.corrupt`` flips under the same jax key."""
    from repro_torch.core import rng as port_rng

    clean = rand_np(np.random.default_rng(2), dtype, (37, 5))
    for seed in (0, 11):
        want = ref_tmr.corrupt(jnp.asarray(clean), jax.random.PRNGKey(seed),
                               0.05)
        got = tmr.corrupt(to_torch(clean), port_rng.PRNGKey(seed), 0.05)
        assert got.dtype == to_torch(clean).dtype
        assert (bits(got) == bits(want)).all()
        assert (bits(got) != bits(clean)).any()
