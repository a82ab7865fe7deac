"""Multi-pod dry run: the port's real step over DTensors on a fake world.

For each (arch x shape) cell this sets up a "fake" process group of the
production mesh's size (256 ranks, or 512 with ``--multipod``) in its
own process, lays the abstract state (``meta`` tensors, no allocation)
out as DTensors by the logical-axis rules, runs the production step
eagerly (``make_train_step``, ``prefill`` or ``decode``) and counts, on
rank 0's local ops:

  * FLOPs per chip (``torch.utils.flop_counter``'s formulas on the local
    shards, not on the global DTensor ops),
  * bytes accessed per chip (each local op's inputs read and outputs
    written, views and collectives excluded: eager ops, nothing fused),
  * the peak of live local bytes, the per-chip memory a chip must hold,
  * every collective, read with ``CommDebugMode`` (kind, operand and
    result bytes; see :mod:`repro_torch.launch.roofline`).

Eager mode sees every layer and every attention chunk, so the counts are
at full depth and need no composition points; ``--skip-cost`` is kept
for the reference's command lines and has nothing to skip.  The
reference lowers and compiles with XLA instead
(``src/repro/launch/dryrun.py``).

Usage:
  python -m repro_torch.launch.dryrun --arch mixtral-8x22b --shape train_4k
  python -m repro_torch.launch.dryrun --all --multipod --out results.json
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback
import weakref

import torch
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.debug import CommDebugMode
from torch.distributed.tensor.experimental import implicit_replication
from torch.utils.flop_counter import flop_registry

from repro_torch.configs.base import TrainConfig
from repro_torch.configs.registry import (SHAPES, all_configs, get_config,
                                          shape_applicable)
from repro_torch.core import tree as tree_util
from repro_torch.dist import sharding as shd
from repro_torch.launch import roofline as rl
from repro_torch.launch import specs as sp
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import model as M
from repro_torch.train.step import make_train_step

#: Collective ops as DTensor issues them, by the reference's HLO kinds.
_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
    "broadcast": "broadcast",
}
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "c10d_functional",
                          "_c10d_functional_autograd", "_dtensor", "c10d")


def fake_world(size: int) -> None:
    """Set up a "fake" process group of ``size`` ranks in this process
    (this process is rank 0); a fake group of that size already up is
    kept, any other group raises."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_backend() == "fake" and dist.get_world_size() == size:
            return
        raise RuntimeError(f"a {dist.get_backend()} group of "
                           f"{dist.get_world_size()} ranks is up; the dry "
                           f"run needs a fake one of {size}")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=size)


_RELAXED: list = []


def relax_strict_views(device_mesh) -> None:
    """Let DTensor flatten a split inner dim in this process, where the
    installed release refuses it.

    Torch releases before 2.13 register ``view`` and ``_unsafe_view``
    (which every batched product and ``einsum`` flattens through) as
    strict: a flatten of ``(batch, seq)`` with the sequence split raises
    instead of redistributing; newer rules describe it with a strided
    shard.  A probe flattens such a DTensor over ``device_mesh``; where
    that fails, both ops are registered again with DTensor's own view
    rule, not strict, so the split dim is gathered first, as ``reshape``
    does.  Such a view is a gathered copy, not an alias: this is for the
    dry run's process alone, whose counts then include those gathers.
    Multi-card placement keeps the stock rules."""
    if _RELAXED:
        return
    from torch.distributed.tensor import Replicate, Shard

    n = device_mesh.size(device_mesh.ndim - 1)
    probe = DTensor.from_local(
        torch.empty((2, 1, 3), device="meta"), device_mesh,
        [Replicate()] * (device_mesh.ndim - 1) + [Shard(1)],
        run_check=False)
    try:
        probe.view(2 * n, 3)
    except Exception as refusal:   # the release's view rule refuses it
        import inspect

        from torch.distributed.tensor._op_schema import RuntimeSchemaInfo
        from torch.distributed.tensor._ops import _view_ops as views

        register = getattr(views, "register_op_strategy_map", None)
        if register is None or "strict_view" not in \
                inspect.signature(register).parameters:
            raise RuntimeError(
                "this torch's DTensor refuses to flatten a split inner dim "
                f"({refusal}) and has no non-strict view rule to register"
            ) from refusal
        aten = torch.ops.aten
        for op in (aten.view.default, aten._unsafe_view.default):
            register(op, torch.Tensor.view,
                     schema_info=RuntimeSchemaInfo(1), strict_view=False)
    _RELAXED.append(True)


def _tensors(tree) -> list:
    leaves = []
    for x in tree if isinstance(tree, (list, tuple)) else (tree,):
        if isinstance(x, torch.Tensor):
            leaves.append(x)
        elif isinstance(x, (list, tuple)):
            leaves.extend(_tensors(x))
    return leaves


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(tree))


def _storage_id(t: torch.Tensor) -> int:
    """The id of the storage under ``t`` (a DTensor's local block's)."""
    if isinstance(t, DTensor):
        t = t._local_tensor
    return id(t.untyped_storage())


_PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_DTENSOR = os.path.join("torch", "distributed", "tensor") + os.sep


def _issuer(last_op: str) -> tuple[str, str]:
    """``(op, source)`` of a collective being issued now (see
    :class:`~repro_torch.launch.roofline.CollectiveRecord`): read off the
    Python stack.  A collective under DTensor's op dispatch belongs to
    ``last_op``, the DTensor op the counter saw last; one under
    DTensor's public API to that call (the outermost one).  The source
    skips ``dist/sharding.py``'s helpers for the model code that called
    them."""
    op, source, dispatch = "", "", False
    frame = sys._getframe(1)
    while frame is not None:
        path = frame.f_code.co_filename
        if _DTENSOR in path:
            if path.endswith("_dispatch.py"):
                dispatch = True
            elif path.endswith("_api.py"):
                op = frame.f_code.co_name
            elif path.endswith("_redistribute.py") and \
                    frame.f_code.co_name == "backward":
                op = op or "redistribute.backward"
        elif not source and path.startswith(_PACKAGE) and \
                path not in (__file__, shd.__file__):
            rel = os.path.relpath(path, _PACKAGE).replace(os.sep, "/")
            source = f"{rel}:{frame.f_code.co_name}"
        frame = frame.f_back
    node = getattr(torch._C, "_current_autograd_node", lambda: None)()
    if node is not None:
        source += f" <{node.name()}>"
    return (last_op if dispatch or not op else op), source


def _is_view(func) -> bool:
    return any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns)


class Counter(CommDebugMode):
    """``CommDebugMode`` that also counts FLOPs, bytes and live memory.

    A DTensor op passes through (``NotImplemented``) so DTensor lowers it
    to local ops, which this mode sees next: FLOPs, bytes accessed and
    memory are counted on those, the local shards of rank 0.  Only ops
    on ``meta`` tensors count; DTensor's own bookkeeping on the host
    does not."""

    device = torch.device("meta")

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes_accessed = 0
        self.dtensor_ops = 0
        self.local_ops = 0
        self.collectives: list[rl.CollectiveRecord] = []
        self._last_op = ""
        self.live = 0
        self.peak = 0
        self._storages: dict[int, int] = {}

    def track(self, t: torch.Tensor) -> None:
        """Count ``t``'s storage as live until it is freed."""
        if isinstance(t, DTensor):
            t = t._local_tensor
        if t.device != self.device:
            return
        st = t.untyped_storage()
        key = _storage_id(t)
        if key in self._storages:
            return
        n = st.nbytes()
        self._storages[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self.live -= self._storages.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(t is DTensor for t in types):
            # CommDebugMode would also list each DTensor op with its
            # shapes and mesh; nothing here reads that list
            self.dtensor_ops += 1
            self._last_op = str(func)
            return NotImplemented
        collective = (isinstance(func, torch._ops.OpOverload)
                      and func.namespace in _COLLECTIVE_NAMESPACES)
        if not collective:   # CommDebugMode's own bookkeeping: comms only
            out = func(*args, **(kwargs or {}))
            if not isinstance(func, torch._ops.OpOverload):
                return out
        else:
            out = super().__torch_dispatch__(func, types, args, kwargs)
        ins = _tensors(list(args) + list((kwargs or {}).values()))
        outs = _tensors(out)
        if not any(t.device == self.device for t in ins + outs):
            return out
        self.local_ops += 1
        for t in outs:
            self.track(t)
        if collective:
            name = func._schema.name.split("::")[-1].rstrip("_")
            if name in _KINDS or name.startswith(("all", "reduce")):
                self.collectives.append(rl.CollectiveRecord(
                    _KINDS.get(name, name), _nbytes(ins[:1]), _nbytes(outs),
                    *_issuer(self._last_op)))
            return out
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **(kwargs or {}),
                                                out_val=out)
        if not _is_view(func):
            self.bytes_accessed += _nbytes(ins) + _nbytes(outs)
        return out


@dataclasses.dataclass
class CellCounts:
    """What :func:`count_cell` counted for one rank."""

    flops: float
    bytes_accessed: float
    argument_bytes: int
    output_bytes: int
    peak_bytes: int
    collectives: list
    comm_counts: dict
    dtensor_ops: int
    local_ops: int
    wall_s: float


def _place(x: torch.Tensor, sharding: shd.Sharding):
    """An abstract leaf laid out: a DTensor over several ranks; on a
    one-device mesh the ``meta`` tensor itself."""
    return x if sharding.mesh.size == 1 else sharding.place(x)


def _place_tree(tree, shardings):
    leaves, structure = tree_util.flatten(tree)
    shs = tree_util.flatten(shardings)[0]
    if len(shs) != len(leaves):
        raise ValueError(f"{len(leaves)} leaves but {len(shs)} shardings")
    return tree_util.unflatten(structure,
                               [_place(x, s) for x, s in zip(leaves, shs)])


def _step(cfg, shape, mesh, tc: TrainConfig):
    """``(fn, inputs)``: the cell's step and its placed abstract inputs."""
    if shape.kind == "train":
        state_abs, state_shard, _ = sp.state_specs(cfg, mesh)
        batch_abs, batch_shard = sp.batch_specs(cfg, shape, mesh, True)
        return make_train_step(cfg, tc), (_place_tree(state_abs, state_shard),
                                          _place_tree(batch_abs, batch_shard))
    params_abs, params_shard, _ = sp.params_specs(cfg, mesh)
    params = _place_tree(params_abs, params_shard)
    if shape.kind == "prefill":
        batch_abs, batch_shard = sp.batch_specs(cfg, shape, mesh, False)

        def prefill_step(params, batch):
            with torch.no_grad():
                return M.prefill(params, batch, cfg, shape.seq_len)[0]

        return prefill_step, (params, _place_tree(batch_abs, batch_shard))
    tok_abs, cache_abs, tok_shard, cache_shard = sp.decode_specs(cfg, shape,
                                                                 mesh)

    def decode_step(params, tokens, cache):
        with torch.no_grad():
            return M.decode(params, tokens, cache, cfg)

    return decode_step, (params, _place(tok_abs, tok_shard),
                         _place_tree(cache_abs, cache_shard))


def count_cell(cfg, shape, mesh, *, microbatches: int = 1,
               serve_rules: bool = False,
               tc: TrainConfig | None = None) -> CellCounts:
    """Run one cell's step on ``mesh`` and count it (rank 0's view).

    A mesh of several ranks needs a process group of its size
    (:func:`fake_world`); a one-device mesh runs the step on plain
    ``meta`` tensors.  ``tc`` overrides the train config (default: the
    reference dry run's, ``microbatches`` and no compression).
    """
    tc = tc or TrainConfig(microbatches=microbatches, compression="none")
    rules = (shd.use_rules(shd.SERVE_RULES) if serve_rules
             else contextlib.nullcontext())
    if mesh.size > 1:
        relax_strict_views(mesh.device_mesh())
    counter = Counter()
    with mesh, rules:
        fn, inputs = _step(cfg, shape, mesh, tc)
        for t in tree_util.flatten(inputs)[0]:
            counter.track(t)
        argument = counter.live
        t0 = time.perf_counter()
        with counter, implicit_replication():
            out = fn(*inputs)
        wall = time.perf_counter() - t0
    fresh = {_storage_id(t) for t in tree_util.flatten(out)[0]
             if isinstance(t, torch.Tensor)}
    fresh -= {_storage_id(t) for t in tree_util.flatten(inputs)[0]}
    output = sum(counter._storages.get(k, 0) for k in fresh)
    comm = {str(k): v for k, v in counter.get_comm_counts().items()}
    return CellCounts(flops=float(counter.flops),
                      bytes_accessed=float(counter.bytes_accessed),
                      argument_bytes=argument, output_bytes=output,
                      peak_bytes=counter.peak,
                      collectives=counter.collectives, comm_counts=comm,
                      dtensor_ops=counter.dtensor_ops,
                      local_ops=counter.local_ops, wall_s=wall)


def run_cell(arch: str, shape_name: str, multi_pod: bool = False,
             verbose: bool = True, microbatches: int = 4,
             serve_rules: bool = False) -> dict:
    """One cell in this process: its JSON row (``status`` ok/skipped)."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "status": "skipped",
                "reason": why}
    fake_world(512 if multi_pod else 256)
    mesh = make_production_mesh(multi_pod=multi_pod, device="fake")
    mesh_name = "x".join(str(s) for s in mesh.devices.shape)
    mb = microbatches if shape.kind == "train" else 1
    c = count_cell(cfg, shape, mesh, microbatches=mb,
                   serve_rules=serve_rules)
    coll = rl.collective_bytes(c.collectives)
    if sum(c.comm_counts.values()) != coll.n_ops:
        raise RuntimeError(f"{coll.n_ops} collectives recorded, "
                           f"CommDebugMode counted {c.comm_counts}")
    cost = rl.CostPoint(c.flops, c.bytes_accessed)
    report = rl.RooflineReport(
        arch=arch, shape=shape_name, mesh=mesh_name, n_chips=mesh.size,
        flops_per_chip=cost.flops, bytes_per_chip=cost.bytes_accessed,
        coll_bytes_per_chip=coll.total_bytes,
        coll_dominant_kind=coll.dominant,
        model_flops_global=rl.model_flops(cfg, shape),
        mem_per_chip_bytes=c.peak_bytes,
    )
    out = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "status": "ok", "compile_s": round(c.wall_s, 1),
        "memory": {
            "argument_gb": c.argument_bytes / 2**30,
            "output_gb": c.output_bytes / 2**30,
            "temp_gb": (c.peak_bytes - c.argument_bytes) / 2**30,
            "alias_gb": 0.0,
            "total_gb": c.peak_bytes / 2**30,
        },
        "collectives": {
            "per_kind_gb": {k: v / 2**30
                            for k, v in coll.bytes_by_kind.items()},
            "total_gb": coll.total_bytes / 2**30,
            "n_ops": coll.n_ops,
        },
        "deploy_cost": dataclasses.asdict(cost),
        "roofline": report.row(),
        "counts": {"flops_per_chip": c.flops,
                   "bytes_per_chip": c.bytes_accessed,
                   "dtensor_ops": c.dtensor_ops, "local_ops": c.local_ops,
                   "comm_counts": c.comm_counts},
    }
    if verbose:
        r = out["roofline"]
        print(f"[dryrun] {arch:24s} {shape_name:12s} mesh={mesh_name:10s} "
              f"mem={out['memory']['total_gb']:.2f}GB "
              f"tC={r['t_compute_s']:.3e} tM={r['t_memory_s']:.3e} "
              f"tX={r['t_collective_s']:.3e} bound={r['bottleneck']:<10s} "
              f"frac={r['roofline_fraction']:.3f} run={c.wall_s:.0f}s",
              flush=True)
    return out


def _cell_in_child(arch: str, shape_name: str, args) -> dict:
    """Run one cell in a child process (a process group is process-wide)
    and read back its row."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
           "--shape", shape_name, "--microbatches", str(args.microbatches),
           "--out", path]
    cmd += (["--multipod"] * args.multipod
            + ["--serve-rules"] * args.serve_rules)
    try:
        proc = subprocess.run(cmd, stdout=subprocess.PIPE, text=True)
        sys.stdout.write("".join(ln for ln in proc.stdout.splitlines(True)
                                 if not ln.startswith("[dryrun] wrote")
                                 and " ok, " not in ln))
        sys.stdout.flush()
        try:
            with open(path) as f:
                return json.load(f)[0]
        except (OSError, ValueError, IndexError):
            return {"arch": arch, "shape": shape_name, "status": "error",
                    "error": f"cell process exited with {proc.returncode}"}
    finally:
        os.unlink(path)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multipod", action="store_true")
    ap.add_argument("--skip-cost", action="store_true",
                    help="kept for the reference's command lines; the "
                         "counts are at full depth, so nothing is skipped")
    ap.add_argument("--microbatches", type=int, default=4,
                    help="grad-accumulation microbatches for train cells")
    ap.add_argument("--serve-rules", action="store_true",
                    help="decode cells: activation-stationary SERVE_RULES")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    cells = []
    if args.all:
        for arch in all_configs():
            for shape_name in SHAPES:
                cells.append((arch, shape_name))
    else:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape required (or --all)")
        cells = [(args.arch, args.shape)]

    if len(cells) > 1:
        from concurrent.futures import ThreadPoolExecutor

        # one process a cell, as many side by side as there are cores
        with ThreadPoolExecutor(os.cpu_count() or 1) as pool:
            results = list(pool.map(
                lambda cell: _cell_in_child(*cell, args), cells))
    else:
        try:
            results = [run_cell(args.arch, args.shape, args.multipod,
                                microbatches=args.microbatches,
                                serve_rules=args.serve_rules)]
        except Exception as e:
            traceback.print_exc()
            results = [{"arch": args.arch, "shape": args.shape,
                        "status": "error", "error": str(e)[:500]}]
    failures = sum(1 for r in results if r["status"] == "error")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
        print(f"[dryrun] wrote {args.out}")
    print(f"[dryrun] {sum(1 for r in results if r['status']=='ok')} ok, "
          f"{sum(1 for r in results if r['status']=='skipped')} skipped, "
          f"{failures} failed")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
