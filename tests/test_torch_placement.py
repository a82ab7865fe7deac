"""Multi-device placement of the port (DTensor) against the reference.

``Sharding.place``, ``constraint``, ``reshard`` and ``elastic_restart``
run in four CPU processes over a ``gloo`` process group, each process
one rank (rank ``r`` is ``mesh.devices.flat[r]``).  The group meets
through a file in ``tmp_path``, never a TCP port, because test workers
run side by side; every process has a timeout of its own.  Each rank's
local block is held to the block ``Sharding._block`` gives and to the
indices the reference's ``NamedSharding.devices_indices_map`` assigns
its device, computed in a subprocess that fakes four CPU devices.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs.registry import get_config
from repro_torch.core import tree as tree_util
from repro_torch.dist import sharding as port_sharding
from repro_torch.ft import elastic
from repro_torch.models import model as PM
from repro_torch.ckpt import checkpoint as port_ckpt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
#: Seconds each rank's process may take.
TIMEOUT = 240
#: (grid, spec) cases laid out over four ranks.
CASES = [((2, 2), ("data", "model")), ((2, 2), ("data", None)),
         ((2, 2), (None, "model")), ((2, 2), (("data", "model"), None)),
         ((4, 1), ("data", None)), ((4, 1), ("data", "model")),
         ((4, 1), (None, ("data", "model")))]
SHAPE = (8, 12)

#: What every rank runs: join the group, then one case of this file.
WORKER = r"""
import json, os, sys
import numpy as np
import torch
import torch.distributed as dist
sys.path[:0] = [os.path.join(sys.argv[5], "tests"),
                os.path.join(sys.argv[5], "src")]
import importlib
case, rank, world, rdzv, _, out, module = sys.argv[1:8]
T = importlib.import_module(module)
dist.init_process_group("gloo", init_method="file://" + rdzv,
                        rank=int(rank), world_size=int(world))
torch.set_num_threads(1)
try:
    result = getattr(T, "rank_" + case)(int(rank))
finally:
    dist.destroy_process_group()
with open(out, "w") as f:
    json.dump(result, f)
"""


def spawn(case: str, tmp_path, world: int = WORLD,
          module: str = "test_torch_placement") -> list:
    """Run ``rank_<case>(rank)`` of the test module ``module`` on
    ``world`` gloo ranks; each rank's JSON result, in rank order."""
    rdzv = tmp_path / f"rdzv_{case}"
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    procs, outs = [], []
    for r in range(world):
        out = tmp_path / f"{case}_{r}.json"
        outs.append(out)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", WORKER, case, str(r), str(world),
             str(rdzv), REPO, str(out), module], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    errors = []
    for r, p in enumerate(procs):
        try:
            _, err = p.communicate(timeout=TIMEOUT)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail(f"rank {r} of {case} ran past {TIMEOUT} s")
        if p.returncode:
            errors.append(f"rank {r}: {err[-3000:]}")
    assert not errors, "\n".join(errors)
    return [json.loads(o.read_text()) for o in outs]


def cpu_mesh(grid) -> port_sharding.Mesh:
    return elastic.make_mesh_from(["cpu"] * int(np.prod(grid)), grid)


def coords(mesh: port_sharding.Mesh, rank: int) -> dict:
    return dict(zip(mesh.axis_names,
                    np.unravel_index(rank, mesh.devices.shape)))


def bounds(index, shape) -> list:
    return [list(s.indices(n)[:2]) for s, n in zip(index, shape)]


def _x() -> torch.Tensor:
    return torch.arange(int(np.prod(SHAPE)), dtype=torch.float32).reshape(
        SHAPE)


# ------------------------------------------------------------ rank side


def rank_place(rank: int) -> dict:
    """Each case's local block, as bounds, and whether it equals
    ``x[_block]``; ``constraint`` from each case to the next."""
    from torch.distributed.tensor import DTensor

    x, out = _x(), {"blocks": [], "equal": [], "constrained": []}
    for grid, spec in CASES:
        mesh = cpu_mesh(grid)
        s = port_sharding.Sharding(mesh, spec)
        d = s.place(x)
        assert isinstance(d, DTensor) and tuple(d.placements) == \
            s.placements()
        index = s._block(coords(mesh, rank), SHAPE)
        out["blocks"].append(bounds(index, SHAPE))
        out["equal"].append(bool(torch.equal(d.to_local(), x[index])))
        # constraint: split rows over data, then move the split to cols
        with mesh:
            a = port_sharding.constraint(d, ("batch", None))
            b = port_sharding.constraint(a, (None, "tp"))
        want = port_sharding.sharding_for(SHAPE, (None, "tp"), mesh)
        out["constrained"].append(
            tuple(b.placements) == want.placements()
            and bool(torch.equal(b.to_local(),
                                 x[want._block(coords(mesh, rank), SHAPE)]))
            and bool(torch.equal(b.full_tensor(), x)))
    return out


def rank_plain_constraint(rank: int) -> dict:
    """A plain tensor inside a mesh: replicated stays as it is, a split
    places it."""
    mesh, x = cpu_mesh((2, 2)), _x()
    with mesh:
        same = port_sharding.constraint(x, (None, None)) is x
        d = port_sharding.constraint(x, ("batch", "tp"))
    index = port_sharding.sharding_for(SHAPE, ("batch", "tp"), mesh)._block(
        coords(mesh, rank), SHAPE)
    return {"same": same, "equal": bool(torch.equal(d.to_local(), x[index]))}


def _leaves_equal(a, b) -> bool:
    return all(x.dtype == y.dtype and torch.equal(x, y)
               for x, y in zip(tree_util.flatten(a)[0],
                               tree_util.flatten(b)[0]))


def rank_reshard(rank: int) -> dict:
    """``reshard`` of two smoke trees onto a (2, 2) mesh and back whole;
    each rank's block of every leaf is ``leaf[_block]``."""
    out = {}
    for arch in ("xlstm-125m", "chatglm3-6b"):
        params, axes = PM.init(0, get_config(arch, smoke=True), device="cpu")
        mesh = cpu_mesh((2, 2))
        new = elastic.reshard(params, axes, mesh)
        shs = tree_util.flatten(port_sharding.tree_shardings(axes, mesh))[0]
        blocks = all(
            torch.equal(d.to_local(), x[s._block(coords(mesh, rank),
                                                  x.shape)])
            for d, x, s in zip(tree_util.flatten(new)[0],
                               tree_util.flatten(params)[0], shs))
        whole = tree_util.unflatten(
            tree_util.flatten(new)[1],
            [d.full_tensor() for d in tree_util.flatten(new)[0]])
        out[arch] = {"blocks": blocks, "round_trip":
                     _leaves_equal(whole, params)}
    return out


def rank_elastic_restart(rank: int) -> dict:
    """Restore the checkpoint the test wrote onto a mesh of the four
    ranks, model-parallel 2; whole again, bit for bit."""
    import torch.distributed as dist

    params, axes = PM.init(0, get_config("chatglm3-6b", smoke=True),
                           device="cpu")
    ckpt_dir = os.environ["PLACEMENT_CKPT"]
    new, mesh, step = elastic.elastic_restart(
        params, axes, ckpt_dir, ["cpu"] * dist.get_world_size(),
        model_parallel=2)
    whole = tree_util.unflatten(
        tree_util.flatten(new)[1],
        [d.full_tensor() for d in tree_util.flatten(new)[0]])
    return {"step": step, "shape": mesh.shape,
            "round_trip": _leaves_equal(whole, params)}


def rank_forward(rank: int) -> dict:
    """A float32 smoke dense forward over the (2, 2) mesh against the
    same forward on one device: the largest difference and logit."""
    import dataclasses

    from torch.distributed.tensor.experimental import implicit_replication

    cfg = dataclasses.replace(get_config("chatglm3-6b", smoke=True),
                              dtype="float32")
    params, axes = PM.init(0, cfg, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (4, 16)).astype(np.int32))
    want, _ = PM.forward(params, {"tokens": tokens}, cfg)
    mesh = cpu_mesh((2, 2))
    placed = elastic.reshard(params, axes, mesh)
    tok = port_sharding.sharding_for(tokens.shape, ("batch", None),
                                     mesh).place(tokens)
    with mesh, implicit_replication(), torch.no_grad():
        got, _ = PM.forward(placed, {"tokens": tok}, cfg)
    got = got.full_tensor()
    return {"diff": float((got - want).abs().max()),
            "scale": float(want.abs().max())}


def _train_case(arch: str):
    """A float32 smoke config, its train state and a masked batch of 4
    rows whose masks differ in weight (so which rows share a microbatch
    shows in the loss).  MoE routes with room for every token, so the
    mesh's routing groups drop none."""
    import dataclasses

    from repro_torch.train.step import init_train_state

    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32")
    if cfg.is_moe:
        cfg = dataclasses.replace(cfg, capacity_factor=cfg.n_experts)
    state, axes = init_train_state(0, cfg, device="cpu")
    rng = np.random.default_rng(3)
    batch = {k: torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (4, 16)).astype(np.int32))
        for k in ("tokens", "labels")}
    keep = np.array([1.0, 0.25, 0.5, 0.75])[:, None]
    batch["mask"] = torch.from_numpy(
        (rng.random((4, 16)) < keep).astype(np.int32))
    return cfg, state, axes, batch


def _step_grads(cfg, state, batch, mb: int):
    """``(loss, grads)`` of one ``make_train_step`` step of ``mb``
    microbatches: the grads AdamW is handed."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.optim import adamw
    from repro_torch.train.step import make_train_step

    seen, apply = [], adamw.apply_updates

    def capture(params, opt, grads, tc):
        seen.append(grads)
        return apply(params, opt, grads, tc)

    adamw.apply_updates = capture
    try:
        _, metrics = make_train_step(cfg, TrainConfig(
            microbatches=mb, compression="none"))(state, batch)
    finally:
        adamw.apply_updates = apply
    return metrics["loss"], tree_util.flatten(seen[0])[0]


def rank_train_microbatches(rank: int) -> dict:
    """A train step of 2 microbatches over the (2, 2) mesh, the batch
    split over ``data``, against the same step on one device: a masked
    dense and a masked MoE config.  ``strided`` is the one-device step
    with every other row in a microbatch instead, the grouping a split
    that keeps each rank's own rows would give."""
    from torch.distributed.tensor.experimental import implicit_replication

    mesh, out = cpu_mesh((2, 2)), {}
    for arch in ("chatglm3-6b", "mixtral-8x22b"):
        cfg, state, axes, batch = _train_case(arch)
        want_loss, want = _step_grads(cfg, state, batch, 2)
        strided_loss, _ = _step_grads(
            cfg, state, {k: v[[0, 2, 1, 3]] for k, v in batch.items()}, 2)
        placed = elastic.reshard(state, axes, mesh)
        split = {k: port_sharding.sharding_for(v.shape, ("batch", None),
                                               mesh).place(v)
                 for k, v in batch.items()}
        with mesh, implicit_replication():
            got_loss, got = _step_grads(cfg, placed, split, 2)
        got_loss = float(got_loss.full_tensor()) \
            if hasattr(got_loss, "full_tensor") else float(got_loss)
        out[arch] = {
            "loss": got_loss, "want": float(want_loss),
            "strided": float(strided_loss),
            "grad_diff": max(float((g.full_tensor() - w).abs().max())
                             for g, w in zip(got, want)),
            "grad_scale": max(float(w.abs().max()) for w in want)}
    return out


# ------------------------------------------------------------ test side


@pytest.fixture(scope="module")
def reference_indices():
    """``devices_indices_map`` of every case, from the reference in a
    process with four faked CPU devices (device ``r`` is rank ``r``)."""
    script = r"""
import json, os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
cases, shape = json.loads(os.environ["CASES"]), tuple(json.loads(
    os.environ["SHAPE"]))
out = []
for grid, spec in cases:
    names = ("data", "model")
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(grid), names)
    spec = [tuple(e) if isinstance(e, list) else e for e in spec]
    m = NamedSharding(mesh, P(*spec)).devices_indices_map(shape)
    out.append([[list(s.indices(n)[:2]) for s, n in zip(m[d], shape)]
                for d in jax.devices()[:4]])
print(json.dumps(out))
"""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu", CASES=json.dumps(CASES),
               SHAPE=json.dumps(SHAPE))
    out = subprocess.run([sys.executable, "-c", script], env=env,
                         capture_output=True, text=True, timeout=TIMEOUT)
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_place_gives_each_rank_the_references_block(tmp_path,
                                                    reference_indices):
    ranks = spawn("place", tmp_path)
    for r, got in enumerate(ranks):
        assert all(got["equal"]), got
        assert got["blocks"] == [ref[r] for ref in reference_indices]


def test_constraint_redistributes(tmp_path):
    for got in spawn("place", tmp_path):
        assert all(got["constrained"]), got
    for got in spawn("plain_constraint", tmp_path):
        assert got == {"same": True, "equal": True}


def test_reshard_round_trips_a_smoke_tree(tmp_path):
    for got in spawn("reshard", tmp_path):
        assert got == {a: {"blocks": True, "round_trip": True}
                       for a in ("xlstm-125m", "chatglm3-6b")}


def test_elastic_restart_onto_four_ranks(tmp_path, monkeypatch):
    params, _ = PM.init(0, get_config("chatglm3-6b", smoke=True),
                        device="cpu")
    port_ckpt.save(params, str(tmp_path / "ck"), 5)
    monkeypatch.setenv("PLACEMENT_CKPT", str(tmp_path / "ck"))
    for got in spawn("elastic_restart", tmp_path):
        assert got == {"step": 5, "shape": {"data": 2, "model": 2},
                       "round_trip": True}


def test_forward_over_four_ranks_equals_one_device(tmp_path):
    for got in spawn("forward", tmp_path):
        assert got["diff"] <= 1e-5 * got["scale"], got


def test_train_step_microbatches_over_four_ranks_equal_one_device(
        tmp_path):
    """Consecutive rows make each microbatch, as on one device: the loss
    within 1e-5 and every grad within 1e-5 of the largest; the strided
    grouping's loss lies well outside that."""
    for ranks in spawn("train_microbatches", tmp_path):
        for arch, got in ranks.items():
            tol = 1e-5 * abs(got["want"])
            assert abs(got["loss"] - got["want"]) <= tol, (arch, got)
            assert got["grad_diff"] <= 1e-5 * got["grad_scale"], (arch, got)
            assert abs(got["strided"] - got["want"]) > 100 * tol, (arch, got)


@pytest.mark.parametrize("grid,spec", CASES[:3])
def test_place_without_a_group_raises(grid, spec):
    """No process group of the mesh's size: nothing lands on one device
    in silence."""
    import torch.distributed as dist

    assert not dist.is_initialized()
    s = port_sharding.Sharding(cpu_mesh(grid), spec)
    with pytest.raises(RuntimeError, match="process group of 4 ranks"):
        s.place(_x())
    with pytest.raises(RuntimeError, match="found none"):
        elastic.reshard({"w": _x()}, {"w": ("batch", None)}, cpu_mesh(grid))


def test_fake_devices_need_a_fake_group():
    """``device="fake"`` is a mesh over the ranks of an up "fake" group
    only; with none, building one raises and touches no card."""
    from repro_torch.launch import mesh as port_mesh

    with pytest.raises(RuntimeError, match="'fake' process group"):
        port_mesh.make_production_mesh(device="fake")


def test_placements_follow_the_blocks():
    """``placements`` splits a dim over several axes in mesh order (as
    ``_block``), and refuses an entry against that order."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = cpu_mesh((2, 2))
    s = port_sharding.Sharding(mesh, (("data", "model"), None))
    assert s.placements() == (Shard(0), Shard(0))
    assert port_sharding.Sharding(mesh, (None, "model")).placements() == \
        (Replicate(), Shard(1))
    with pytest.raises(ValueError, match="mesh order"):
        port_sharding.Sharding(mesh, (("model", "data"),)).placements()
