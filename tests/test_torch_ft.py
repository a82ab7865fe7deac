"""The port's fault-tolerant and mesh-placed sweep against the reference's.

``repro_torch.ft`` (failure injection, elastic membership, re-meshing),
the mesh half of ``repro_torch.dist.sharding``, ``repro_torch.launch.
mesh``, ``run_sweep_ft`` and the sweep's mesh path are held to their
``repro`` counterparts on the CPU.  The reference's meshes here hold
the one CPU device jax has; the port's meshes may repeat the CPU device
to stand in for several cards, which exercises the split of a batch
over a data axis.  Every fault-tolerance scenario of
``tests/test_sweep_ft.py`` is mirrored with shorter timeouts: worker
loss and re-dispatch change who executes a chunk, never what it
produces.
"""

import contextlib
import inspect
import io
import threading
import time

import jax
import numpy as np
import pytest
import torch

import repro.sweep as ref
import repro_torch.sweep as port
from repro.ckpt import checkpoint as ref_ckpt
from repro.configs.registry import get_config as ref_config
from repro.dist import sharding as ref_sharding
from repro.ft import elastic as ref_elastic
from repro.ft import failures as ref_failures
from repro.launch.mesh import make_test_mesh as ref_test_mesh
from repro.models import model as RM
from repro.sweep.run import main as ref_cli
from repro_torch.ckpt import checkpoint as port_ckpt
from repro_torch.configs.registry import get_config
from repro_torch.core import tree as tree_util
from repro_torch.dist import sharding as port_sharding
from repro_torch.ft import elastic, failures
from repro_torch.interop import params_from_jax
from repro_torch.launch import mesh as port_mesh
from repro_torch.models import model as PM
from repro_torch.sweep.run import main as port_cli

CPU = dict(device="cpu")
#: Four one-point chunks (``tests/test_sweep_ft.py``'s grid): with two
#: workers, whichever holds a chunk leaves the other a non-empty share.
FT_SPEC = dict(op="majx", x_values=(3, 5), n_act=(32,), seeds=(0, 1),
               rows=2, words=16, chunk=1)
TINY = dict(x_values=(3,), n_act=(4, 32), ideal=True, rows=2, words=16,
            chunk=2)


def cpu_mesh(data: int, model: int = 1) -> port_sharding.Mesh:
    """A port mesh whose every device is the CPU (stand-ins for cards)."""
    return elastic.make_mesh_from(["cpu"] * (data * model), (data, model))


def by_index(records):
    return sorted(records, key=lambda r: r["index"])


def as_ref(records):
    return [dict(r, backend="pallas" if r["backend"] == "cuda"
                 else r["backend"]) for r in records]


# ------------------------------------------------------------ membership


def membership_trace(mod):
    """Every observable of an ElasticMembership over a drop/join story."""
    m = mod.ElasticMembership(3)
    items = list(range(7))
    out = [(m.live, m.plan(items), m.generation)]
    for op, w in (("drop", 1), ("drop", 1), ("drop", 5), ("join", 1),
                  ("drop", 0), ("join", 4), ("drop", 2)):
        getattr(m, op)(w)
        out.append((op, w, m.live, list(m.dropped), m.generation,
                    m.plan(items), [m.share(items, v) for v in range(5)],
                    [m.is_live(v) for v in range(5)]))
    return out


def test_elastic_membership_equals_the_reference():
    assert membership_trace(elastic) == membership_trace(ref_elastic)
    for mod in (elastic, ref_elastic):
        with pytest.raises(ValueError, match="n_workers"):
            mod.ElasticMembership(0)


@pytest.mark.parametrize("n,mp,pods", [
    (8, 2, 1), (7, 2, 1), (16, 4, 2), (5, 1, 1), (512, 16, 2), (3, 4, 1),
    (4, 4, 2), (1, 1, 1)])
def test_plan_remesh_equals_the_reference(n, mp, pods):
    def call(mod):
        try:
            return mod.plan_remesh(n, mp, pods)
        except ValueError as e:
            return ("ValueError", str(e))
    assert call(elastic) == call(ref_elastic)


@pytest.mark.parametrize("shape", [(1, 1), (1, 1, 1)])
def test_make_mesh_from_equals_the_reference(shape):
    want = ref_elastic.make_mesh_from(jax.devices(), shape)
    got = elastic.make_mesh_from([torch.device("cpu")], shape)
    assert got.axis_names == want.axis_names
    assert got.shape == dict(want.shape)
    assert got.devices.shape == want.devices.shape
    big = elastic.make_mesh_from(["cpu"] * 9, (2, 2, 2))
    assert big.shape == {"pod": 2, "data": 2, "model": 2}
    assert big.size == 8


def test_failure_plan_and_heartbeat_equal_the_reference():
    def trace(mod):
        plan = mod.FailurePlan(at_steps=(2, 5), kind="node_loss")
        out = []
        for step in (0, 1, 2, 2, 3, 5, 5, 6):
            try:
                plan.check(step)
                out.append(None)
            except mod.SimulatedFailure as e:
                out.append(str(e))
        hb = mod.HeartbeatMonitor(deadline_s=10.0)
        out.append(hb.healthy(0.0))
        hb.beat(5.0)
        out += [hb.healthy(14.0), hb.healthy(15.0)]
        return out
    assert trace(failures) == trace(ref_failures)
    assert issubclass(failures.WorkerLost, failures.SimulatedFailure)
    assert issubclass(failures.SimulatedFailure, RuntimeError)


# ------------------------------------------------------------ fault tolerance


@pytest.mark.parametrize("backend", ["oracle", "sim"])
def test_ft_run_equals_the_reference_and_the_plain_run(tmp_path, backend):
    rspec = ref.SweepSpec(name="ft", backends=(backend,), **FT_SPEC)
    pspec = port.SweepSpec(name="ft", backends=(backend,), **FT_SPEC)
    want = ref.run_sweep_ft(rspec, str(tmp_path / "r"), n_workers=2)
    got = port.run_sweep_ft(pspec, str(tmp_path / "p"), n_workers=2, **CPU)
    plain = port.run_sweep(pspec, str(tmp_path / "plain"), **CPU)
    assert by_index(got.records) == by_index(want.records)
    assert by_index(got.records) == by_index(plain.records)
    assert got.lost_workers == want.lost_workers == []
    assert got.re_dispatched == want.re_dispatched == 0
    assert sum(got.worker_chunks.values()) == got.executed_chunks == 4
    assert got.summary().split(" [")[0] == want.summary().split(" [")[0]
    again = port.run_sweep_ft(pspec, str(tmp_path / "p"), n_workers=2, **CPU)
    assert again.executed_chunks == 0 and again.cached_chunks == 4
    assert by_index(again.records) == by_index(got.records)


def test_dead_worker_chunks_are_reassigned(tmp_path):
    """Worker 1 dies after both workers hold a chunk: the run still
    ends with every chunk, records untouched."""
    spec = port.SweepSpec(name="ft-dead", backends=("sim",), **FT_SPEC)
    plain = port.run_sweep(spec, str(tmp_path / "base"), **CPU)
    barrier = threading.Barrier(2, timeout=10)
    lock = threading.Lock()
    seen = set()

    def hook(wid, chunk):
        with lock:
            first = wid not in seen
            seen.add(wid)
        if first:
            barrier.wait()
        if wid == 1:
            raise failures.WorkerLost("injected")

    ft = port.run_sweep_ft(spec, str(tmp_path / "ft"), n_workers=2,
                           worker_hook=hook, **CPU)
    assert ft.lost_workers == [1]
    assert ft.worker_chunks.get(1, 0) == 0
    assert ft.worker_chunks[0] == ft.executed_chunks == len(port.plan(spec))
    assert by_index(ft.records) == by_index(plain.records)


def test_all_workers_lost_raises(tmp_path):
    spec = port.SweepSpec(name="ft-lost", backends=("sim",), **FT_SPEC)

    def hook(wid, chunk):
        raise failures.WorkerLost("injected")

    with pytest.raises(RuntimeError, match="workers lost"):
        port.run_sweep_ft(spec, str(tmp_path), n_workers=2,
                          worker_hook=hook, **CPU)
    with pytest.raises(ValueError, match="n_workers"):
        port.run_sweep_ft(spec, str(tmp_path), n_workers=0, **CPU)


def test_worker_exception_propagates(tmp_path):
    spec = port.SweepSpec(name="ft-crash", backends=("sim",), **FT_SPEC)

    def hook(wid, chunk):
        raise RuntimeError("kaboom")

    with pytest.raises(RuntimeError, match="worker failed") as err:
        port.run_sweep_ft(spec, str(tmp_path), n_workers=2,
                          worker_hook=hook, **CPU)
    assert "kaboom" in str(err.value.__cause__)


def test_straggler_chunk_is_redispatched(tmp_path):
    """Worker 1 stalls on its first chunk; past the timeout the monitor
    re-dispatches it and the run ends without waiting out the stall."""
    spec = port.SweepSpec(name="ft-straggle", backends=("sim",), **FT_SPEC)
    plain = port.run_sweep(spec, str(tmp_path / "base"), **CPU)
    stalled = threading.Event()

    def hook(wid, chunk):
        if wid == 1 and not stalled.is_set():
            stalled.set()
            time.sleep(4.0)

    t0 = time.monotonic()
    ft = port.run_sweep_ft(spec, str(tmp_path / "ft"), n_workers=2,
                           worker_hook=hook, straggler_timeout_s=0.15,
                           poll_s=0.02, **CPU)
    assert time.monotonic() - t0 < 4.0
    assert ft.re_dispatched >= 1
    assert by_index(ft.records) == by_index(plain.records)


def test_ft_on_the_cuda_route_equals_the_reference_pallas(tmp_path):
    """The fused ``cuda`` chunks (their CUDA-less route) under three
    workers sharing one compile cache."""
    rspec = ref.SweepSpec(name="ftc", backends=("pallas",), **TINY)
    pspec = port.SweepSpec(name="ftc", backends=("cuda",), **TINY)
    want = ref.run_sweep(rspec, str(tmp_path / "r")).records
    got = port.run_sweep_ft(pspec, str(tmp_path / "p"), n_workers=3, **CPU)
    assert as_ref(by_index(got.records)) == by_index(want)


# ------------------------------------------------------------ placement


def test_reshard_roundtrip_on_a_one_device_mesh():
    """The list-shaped ssm tree, placed by its logical axes."""
    cfg = get_config("xlstm-125m", smoke=True)
    params, axes = PM.init(0, cfg, device="cpu")
    mesh = port_mesh.make_test_mesh(model=1, device="cpu")
    new = elastic.reshard(params, axes, mesh)
    old_leaves, old_struct = tree_util.flatten(params)
    new_leaves, new_struct = tree_util.flatten(new)
    assert new_struct == old_struct and len(new_leaves) == len(old_leaves)
    for a, b in zip(old_leaves, new_leaves):
        assert b.device.type == "cpu" and torch.equal(a, b)


def test_elastic_restart_from_a_checkpoint(tmp_path):
    """The reference's restart test, both packages from one checkpoint
    of the reference's weights."""
    rcfg = ref_config("chatglm3-6b", smoke=True)
    rp, rax = RM.init(jax.random.PRNGKey(0), rcfg)
    ref_ckpt.save(rp, str(tmp_path / "r"), 5)
    pp = params_from_jax(jax.tree.map(np.asarray, rp), "cpu")
    port_ckpt.save(pp, str(tmp_path / "p"), 5)
    want, rmesh, rstep = ref_elastic.elastic_restart(
        rp, rax, str(tmp_path / "r"), jax.devices(), model_parallel=1)
    got, mesh, step = elastic.elastic_restart(
        pp, rax, str(tmp_path / "p"), [torch.device("cpu")],
        model_parallel=1)
    assert step == rstep == 5
    assert mesh.shape == dict(rmesh.shape)
    for a, b in zip(tree_util.flatten(got)[0], jax.tree.leaves(want)):
        assert a.view(torch.uint8).numpy().tobytes() == \
            np.asarray(b).tobytes()
    with pytest.raises(ValueError, match="TP degree"):
        elastic.elastic_restart(pp, rax, str(tmp_path / "p"),
                                [torch.device("cpu")], model_parallel=2)


class StandInMesh:
    """What the reference's ``_spec_entries`` reads of a mesh."""

    def __init__(self, shape: dict):
        self.axis_names = tuple(shape)
        self.shape = shape


SHAPED = [((3, 8), ("batch", "tp")), ((4, 8), ("batch", "tp")),
          ((8, 6, 4), ("kv_batch", None, "tp")), ((16,), ("fsdp",)),
          ((8, 16, 4), (None, "expert", "fsdp")), ((2, 2), ("sp", "tp"))]


@pytest.mark.parametrize("grid", [(1, 1), (2, 1), (2, 2), (4, 2),
                                  (2, 2, 2)])
@pytest.mark.parametrize("rules", ["DEFAULT_RULES", "SERVE_RULES"])
def test_sharding_entries_equal_the_reference(grid, rules):
    prules = getattr(port_sharding, rules)
    rrules = getattr(ref_sharding, rules)
    mesh = elastic.make_mesh_from(["cpu"] * int(np.prod(grid)), grid)
    stand_in = StandInMesh(mesh.shape)
    for shape, axes in SHAPED:
        got = port_sharding.sharding_for(shape, axes, mesh, prules)
        assert got.mesh is mesh
        assert list(got.spec) == ref_sharding._spec_entries(
            axes, stand_in, rrules, shape)
    _, axes_tree = PM.init(0, get_config("qwen3-moe-235b-a22b", smoke=True),
                           device="meta")
    got = tree_util.flatten(port_sharding.tree_shardings(axes_tree, mesh,
                                                         prules))[0]
    want = [ref_sharding._spec_entries(a, stand_in, rrules) for a in
            jax.tree.leaves(axes_tree, is_leaf=ref_sharding._is_axes_leaf)]
    assert [list(s.spec) for s in got] == want


def test_sharding_on_a_real_mesh_equals_the_reference():
    """On the one device both packages have: ``sharding_for`` and
    ``tree_shardings`` specs equal the reference's PartitionSpecs."""
    rmesh = ref_test_mesh(model=1)
    pmesh = port_mesh.make_test_mesh(model=1, device="cpu")
    assert pmesh.shape == dict(rmesh.shape)
    for shape, axes in SHAPED:
        want = ref_sharding.sharding_for(shape, axes, rmesh)
        assert port_sharding.sharding_for(shape, axes, pmesh).spec == \
            tuple(want.spec)
    cfg = ref_config("musicgen-medium", smoke=True)
    _, axes_tree = RM.init(jax.random.PRNGKey(0), cfg)
    want = jax.tree.leaves(ref_sharding.tree_shardings(axes_tree, rmesh),
                           is_leaf=lambda x: isinstance(
                               x, jax.sharding.Sharding))
    got = tree_util.flatten(port_sharding.tree_shardings(axes_tree,
                                                         pmesh))[0]
    assert [s.spec for s in got] == [tuple(w.spec) for w in want]


def test_serve_rules_swap_batch_mapping_inside_a_mesh():
    mesh = cpu_mesh(4, 2)
    assert port_sharding._current_mesh() is None
    with mesh:
        assert port_sharding._current_mesh() is mesh
        assert port_sharding.axis_extent("batch") == 4
        with port_sharding.use_rules(port_sharding.SERVE_RULES):
            assert port_sharding.axis_extent("batch") == 1
            assert port_sharding.axis_extent("kv_batch") == 4
        with cpu_mesh(1):
            assert port_sharding.axis_extent("batch") == 1
        assert port_sharding._current_mesh() is mesh
    assert port_sharding._current_mesh() is None
    # A mesh is entered per thread, as jax's is.
    seen = []
    with mesh:
        t = threading.Thread(
            target=lambda: seen.append(port_sharding._current_mesh()))
        t.start()
        t.join(timeout=10)
    assert not t.is_alive() and seen == [None]


def test_placement_on_one_device_and_over_several():
    x = torch.arange(48).reshape(8, 6)
    one = cpu_mesh(1)
    s = port_sharding.sharding_for(x.shape, ("batch", "tp"), one)
    assert s.spec == (None, None) and s.place(x) is x
    with one:
        assert port_sharding.constraint(x, ("batch", "tp")) is x
    grid = cpu_mesh(4, 2)
    s = port_sharding.sharding_for(x.shape, ("batch", "tp"), grid)
    assert s.spec == ("data", "model")
    shards = s.shards(x)
    assert len(shards) == 8
    rebuilt = torch.empty_like(x)
    for index, t in shards:
        rebuilt[index] = t
    assert torch.equal(rebuilt, x)
    # A dim split over data only: replicas over "model" are not repeated.
    s = port_sharding.sharding_for(x.shape, ("batch", None), grid)
    assert [tuple(i[0].indices(8)) for i, _ in s.shards(x)] == \
        [(0, 2, 1), (2, 4, 1), (4, 6, 1), (6, 8, 1)]
    # Over several devices placement needs a process group of 8 ranks.
    with pytest.raises(RuntimeError, match="process group of 8 ranks"):
        s.place(x)
    with grid:
        assert port_sharding.constraint(x, (None, None)) is x
        with pytest.raises(RuntimeError, match="found none"):
            port_sharding.constraint(x, ("batch", None))


def test_mesh_constructors_follow_the_reference():
    m = port_mesh.make_test_mesh(model=2, device="cpu")
    r = ref_test_mesh(model=2)
    assert m.shape == dict(r.shape) and m.axis_names == r.axis_names
    with pytest.raises(ValueError, match="Number of devices 1 must be >="):
        port_mesh.make_production_mesh(device="cpu")
    with pytest.raises(ValueError, match=r"\(2, 16, 16\)"):
        port_mesh.make_production_mesh(multi_pod=True, device="cpu")
    with pytest.raises(ValueError, match="Number of devices"):
        jax.make_mesh((16, 16), ("data", "model"))
    m = port_mesh.make_mesh((1, 1, 1), ("pod", "data", "model"),
                            device="cpu")
    assert m.shape == {"pod": 1, "data": 1, "model": 1}


def test_meshes_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal needs none")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_mesh.make_test_mesh(model=1)
    with pytest.raises(ValueError, match="'cuda' or 'cpu'"):
        port_mesh.devices("tpu")


# ------------------------------------------------------------ mesh sweep


@pytest.mark.parametrize("data", [1, 2])
def test_mesh_sweep_equals_the_plain_run_and_the_reference(tmp_path, data):
    rspec = ref.SweepSpec(name="mesh", backends=("pallas", "oracle"), **TINY)
    pspec = port.SweepSpec(name="mesh", backends=("cuda", "oracle"), **TINY)
    want = ref.run_sweep(rspec, str(tmp_path / "r"),
                         mesh=ref_test_mesh(model=1)).records
    plain = port.run_sweep(pspec, str(tmp_path / "plain"), **CPU).records
    got = port.run_sweep(pspec, str(tmp_path / "p"), mesh=cpu_mesh(data),
                         **CPU).records
    assert got == plain and as_ref(got) == want


def test_mesh_sweep_launches_one_majx_batch_a_shard(tmp_path, monkeypatch):
    from repro_torch.backends.cuda import CudaBackend

    calls = []
    real = CudaBackend.majx_batch
    monkeypatch.setattr(CudaBackend, "majx_batch", lambda self, p: (
        calls.append(tuple(p.shape)), real(self, p))[1])
    spec = port.SweepSpec(name="mesh-split", backends=("cuda",),
                          **dict(TINY, chunk=4, n_act=(4, 8, 16, 32)))
    port.run_sweep(spec, str(tmp_path), mesh=cpu_mesh(2), **CPU)
    assert calls == [(2, 3, 2, 16)] * 2


def test_adaptive_mesh_equals_the_plain_run_and_the_reference(tmp_path):
    r = ref.presets.adaptive_smoke_spec()
    p = port.presets.adaptive_smoke_spec()
    want = ref.run_adaptive(r, str(tmp_path / "r"),
                            mesh=ref_test_mesh(model=1))
    plain = port.run_adaptive(p, str(tmp_path / "plain"), **CPU)
    got = port.run_adaptive(p, str(tmp_path / "p"),
                            mesh=port_mesh.make_test_mesh(model=1,
                                                          device="cpu"),
                            **CPU)
    assert got.records == plain.records
    assert as_ref(got.records) == want.records
    assert [c.describe() for c in got.crossings] == \
        [c.describe() for c in want.crossings]


# ------------------------------------------------------------ CLI


def _run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue().splitlines()


def test_cli_workers_writes_the_reference_records(tmp_path):
    rc_r, want = _run(ref_cli, ["--smoke", "--workers", "2", "--root",
                                str(tmp_path / "r"), "--quiet"])
    rc_p, got = _run(port_cli, ["--smoke", "--workers", "2", "--root",
                                str(tmp_path / "p"), "--quiet",
                                "--device", "cpu"])
    assert rc_p == rc_r == 0
    assert got[0].startswith("ft-sweep 'smoke'")
    assert got[0].split(" [")[0] == want[0].split(" [")[0]
    assert [ln.replace("pallas", "cuda") for ln in want[1:]] == got[1:]
    [(_, rstore)] = list(ref.discover(str(tmp_path / "r")))
    [(_, pstore)] = list(port.discover(str(tmp_path / "p")))
    assert as_ref(by_index(pstore.records())) == by_index(rstore.records())
    rc, cached = _run(port_cli, ["--smoke", "--workers", "2", "--root",
                                 str(tmp_path / "p"), "--quiet",
                                 "--device", "cpu", "--expect-cached"])
    assert rc == 0 and " 0 chunks executed" in cached[0]


def test_entry_points_default_to_the_card():
    for fn in (port.run_sweep_ft, port.run_sweep, port.run_adaptive):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    for fn in (port_mesh.make_mesh, port_mesh.make_test_mesh,
               port_mesh.make_production_mesh):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
