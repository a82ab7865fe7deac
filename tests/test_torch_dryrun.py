"""The port's dry run (specs, roofline, counted cells) against the
reference's.

The reference lowers its cells with XLA on faked CPU devices, always in
a subprocess (the device count is fixed at jax's first use).  The port
runs its cells over DTensors on a "fake" process group, also in a
subprocess (a process group is process-wide), and its specs need no
group at all: a port ``Mesh`` of 256 or 512 devices stands in.
"""

import dataclasses
import json
import os
import subprocess
import sys

import pytest
import torch

from repro.configs.registry import get_config as ref_config
from repro.launch import roofline as ref_rl
from repro_torch.configs.registry import ARCH_IDS, SHAPES, get_config
from repro_torch.core import tree as tree_util
from repro_torch.ft import elastic
from repro_torch.launch import roofline as rl
from repro_torch.launch import specs as sp
from test_dryrun_small import SCRIPT as REF_SMALL_SCRIPT
from test_torch_placement import spawn

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 600
ENV = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
           JAX_PLATFORMS="cpu")


def run_script(script: str, *args: str) -> dict:
    """The last stdout line of ``script`` (given ``args``) in a fresh
    process, as JSON."""
    out = subprocess.run([sys.executable, "-c", script, *args], env=ENV,
                         capture_output=True, text=True, timeout=TIMEOUT)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


# ------------------------------------------------------------ specs

#: Each cell's (shape, dtype, spec) leaves from the reference's specs,
#: on a production mesh of 512 faked devices; eval_shape only.
REF_SPECS = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
import json, jax
from repro.configs.registry import ARCH_IDS, SHAPES, get_config
from repro.launch import specs as sp
from repro.launch.mesh import make_production_mesh

def norm(spec, ndim):
    out = []
    for e in spec:
        if isinstance(e, tuple):
            e = None if not e else (e[0] if len(e) == 1 else list(e))
        out.append(e)
    return out + [None] * (ndim - len(out))

def leaves(abstract, shardings):
    a = jax.tree.leaves(abstract)
    s = jax.tree.leaves(shardings, is_leaf=lambda x: isinstance(
        x, jax.sharding.Sharding))
    assert len(a) == len(s)
    return [[list(x.shape), str(x.dtype), norm(y.spec, len(x.shape))]
            for x, y in zip(a, s)]

out = {}
for multi in (False, True):
    mesh = make_production_mesh(multi_pod=multi)
    for arch in ARCH_IDS if not multi else ARCH_IDS[:3]:
        cfg = get_config(arch)
        with mesh:
            a, s, _ = sp.state_specs(cfg, mesh)
            out[f"{multi}/{arch}/state"] = leaves(a, s)
            a, s, _ = sp.params_specs(cfg, mesh)
            out[f"{multi}/{arch}/params"] = leaves(a, s)
            for name, shape in SHAPES.items():
                if shape.kind == "decode":
                    t, c, ts, cs = sp.decode_specs(cfg, shape, mesh)
                    out[f"{multi}/{arch}/{name}"] = leaves((t, c), (ts, cs))
                else:
                    a, s = sp.batch_specs(cfg, shape, mesh,
                                          shape.kind == "train")
                    out[f"{multi}/{arch}/{name}"] = leaves(a, s)
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def ref_specs():
    return run_script(REF_SPECS)


def _norm(spec, ndim):
    out = [list(e) if isinstance(e, tuple) else e for e in spec]
    return out + [None] * (ndim - len(out))


def _leaves(abstract, shardings):
    a = tree_util.flatten(abstract)[0]
    s = tree_util.flatten(shardings)[0]
    assert len(a) == len(s)
    return [[list(x.shape), str(x.dtype).split(".")[-1],
             _norm(y.spec, x.dim())] for x, y in zip(a, s)]


def _mesh(multi: bool):
    grid = (2, 16, 16) if multi else (16, 16)
    return elastic.make_mesh_from(["cpu"] * (512 if multi else 256), grid)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_specs_equal_the_reference(arch, ref_specs):
    """Shapes, dtypes and spec entries of every spec tree, every shape;
    single-pod for every arch, multi-pod for the first three."""
    cfg = get_config(arch)
    for multi in (False, True):
        if multi and arch not in ARCH_IDS[:3]:
            continue
        mesh = _mesh(multi)
        with mesh:
            a, s, _ = sp.state_specs(cfg, mesh)
            assert _leaves(a, s) == ref_specs[f"{multi}/{arch}/state"]
            a, s, _ = sp.params_specs(cfg, mesh)
            assert _leaves(a, s) == ref_specs[f"{multi}/{arch}/params"]
            for name, shape in SHAPES.items():
                if shape.kind == "decode":
                    t, c, ts, cs = sp.decode_specs(cfg, shape, mesh)
                    got = _leaves((t, c), (ts, cs))
                else:
                    got = _leaves(*sp.batch_specs(cfg, shape, mesh,
                                                  shape.kind == "train"))
                assert got == ref_specs[f"{multi}/{arch}/{name}"], name


def test_dp_axes_rules():
    """A batch that does not divide the data grid replicates; long_500k's
    batch of 1 replicates its cache's batch dims."""
    mesh = _mesh(False)
    assert sp._dp_axes(mesh, 256) == ("data",)
    assert sp._dp_axes(mesh, 1) == ()
    assert sp._dp_axes(_mesh(True), 32) == ("pod", "data")
    cfg = get_config("xlstm-125m")
    _, _, tok, cache = sp.decode_specs(cfg, SHAPES["long_500k"], mesh)
    assert tok.spec == (None, None)
    assert all("data" not in str(s.spec)
               for s in tree_util.flatten(cache)[0])


# ------------------------------------------------------------ roofline


def test_model_flops_and_composition_equal_the_reference():
    for arch in ARCH_IDS:
        for name in SHAPES:
            assert rl.model_flops(get_config(arch), SHAPES[name]) == \
                ref_rl.model_flops(ref_config(arch), SHAPES[name])
    pts = {0: (100.0, 10.0), 1: (150.0, 14.0), 6: (18.0, 1.8),
           7: (23.0, 2.3)}
    for arch in ("chatglm3-6b", "mixtral-8x22b", "musicgen-medium",
                 "zamba2-1.2b"):
        if arch == "zamba2-1.2b":
            use = {k: pts[k] for k in (0, 6, 7)}
        else:
            use = {k: pts[k] for k in (0, 1)}
        got = rl.compose(get_config(arch),
                         {k: rl.CostPoint(*v) for k, v in use.items()})
        want = ref_rl.compose(ref_config(arch),
                              {k: ref_rl.CostPoint(*v)
                               for k, v in use.items()})
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    seq = {64: (100.0, 50.0), 128: (164.0, 82.0)}
    got = rl.compose_seq(4096, {k: rl.CostPoint(*v) for k, v in seq.items()})
    want = ref_rl.compose_seq(4096, {k: ref_rl.CostPoint(*v)
                                     for k, v in seq.items()})
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    with pytest.raises(ValueError, match="no composition rule"):
        rl.compose(get_config("xlstm-125m"), {})


@pytest.mark.parametrize("flops,mem_bytes,coll", [
    (1e12, 1e9, 1e9), (1e15, 1e9, 1e9), (1e9, 1e12, 1e6), (0.0, 0.0, 0.0)])
def test_report_arithmetic_equals_the_reference(flops, mem_bytes, coll,
                                                monkeypatch):
    """The same formulas: with the reference's constants set to the H100
    ones (NVLink in place of ICI), every row value is equal."""
    monkeypatch.setattr(ref_rl, "PEAK_FLOPS", rl.PEAK_FLOPS)
    monkeypatch.setattr(ref_rl, "HBM_BW", rl.HBM_BW)
    monkeypatch.setattr(ref_rl, "ICI_BW", rl.NVLINK_BW)
    kw = dict(arch="a", shape="s", mesh="16x16", n_chips=256,
              flops_per_chip=flops, bytes_per_chip=mem_bytes,
              coll_bytes_per_chip=coll, coll_dominant_kind="all-gather",
              model_flops_global=200e12, mem_per_chip_bytes=8 * 2**30)
    got, want = rl.RooflineReport(**kw), ref_rl.RooflineReport(**kw)
    assert got.row() == want.row()
    assert got.t_compute == flops / 989e12
    assert got.t_memory == mem_bytes / 3.35e12
    assert got.t_collective == coll / 450e9


def test_collective_bytes_equal_the_references_hlo_parse():
    """Records equivalent to ``tests/test_roofline.py``'s HLO sample:
    the sample's printed shape is the all-gather's result and each other
    op's operand (the reference reads that shape; an all-reduce's result
    is its operand's size).  The reference multiplies an op inside the
    layer loop by the loop's trips; the eager run records each trip's op
    itself, so the records repeat those two ops 10 times."""
    from test_roofline import HLO_SAMPLE

    ag = 16 * 4096 * 256 * 2
    in_loop = [
        rl.CollectiveRecord("all-gather", ag // 16, ag),
        rl.CollectiveRecord("all-to-all", 64 * 64 * 4, 64 * 64 * 4),
    ]
    once = [
        rl.CollectiveRecord("all-reduce", 4096 * 4096 * 4,
                            4096 * 4096 * 4),
        rl.CollectiveRecord("reduce-scatter", 8 * 128 * 2, 8 * 128 * 2 // 4),
        rl.CollectiveRecord("collective-permute", 1024 * 4, 1024 * 4),
    ]
    got = rl.collective_bytes(in_loop * 10 + once)
    want = ref_rl.collective_bytes(HLO_SAMPLE, loop_multiplier=10)
    assert got.bytes_by_kind == want.bytes_by_kind
    assert (got.total_bytes, got.dominant) == (want.total_bytes,
                                               want.dominant)
    assert got.n_ops == 10 * len(in_loop) + len(once)
    assert rl.collective_bytes(in_loop + once).bytes_by_kind == \
        ref_rl.collective_bytes(HLO_SAMPLE).bytes_by_kind


# ------------------------------------------------------------ counted cells

#: Count one smoke cell on a fake world of 8; argv: arch, shape name,
#: seq, batch, the (data x model) grid, then ``key=value`` overrides of
#: the config, one count each.
PORT_CELL = r"""
import dataclasses, json, sys
from repro_torch.configs.registry import SHAPES, get_config
from repro_torch.launch import dryrun as D, roofline as rl
from repro_torch.launch.mesh import make_mesh
arch, shape_name, seq, batch = sys.argv[1], sys.argv[2], int(sys.argv[3]), \
    int(sys.argv[4])
grid = tuple(int(n) for n in sys.argv[5].split("x"))
D.fake_world(8)
mesh = make_mesh(grid, ("data", "model"), device="fake")
shape = dataclasses.replace(SHAPES[shape_name], seq_len=seq,
                            global_batch=batch)
base = get_config(arch, smoke=True)
out = {}
for spec in sys.argv[6:]:
    kw = dict(kv.split("=") for kv in spec.split(",")) if spec else {}
    kw = {k: (v if k == "remat" else int(v)) for k, v in kw.items()}
    c = D.count_cell(dataclasses.replace(base, **kw), shape, mesh)
    coll = rl.collective_bytes(c.collectives)
    out[spec] = {"flops": c.flops, "bytes": c.bytes_accessed,
                 "peak": c.peak_bytes, "coll_ops": coll.n_ops,
                 "coll_bytes": coll.total_bytes, "dominant": coll.dominant,
                 "kinds": sorted(coll.bytes_by_kind),
                 "comm": sum(c.comm_counts.values())}
print(json.dumps(out))
"""


def port_cell(arch, shape_name, seq, batch, *configs,
              grid: str = "4x2") -> dict:
    """:data:`PORT_CELL`'s counts on a ``grid`` mesh, one entry a config
    override."""
    return run_script(PORT_CELL, arch, shape_name, str(seq), str(batch),
                      grid, *configs)


#: The reference's cost-mode points of the same smoke dense train cell
#: (``_cost_points``: ``FORCE_DENSE``, no remat, not donated) on 8
#: faked devices: XLA's FLOPs, the FLOPs of the products in the
#: optimized HLO (2 x result size x contracted size a ``dot``) and the
#: collective kinds.
REF_POINTS = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import dataclasses, json, math, re
from repro.configs.registry import SHAPES, get_config
from repro.launch import roofline as rl
from repro.launch.dryrun import _cost_analysis, lower_cell
from repro.launch.mesh import make_mesh
from repro.models import attention as attention_mod

DEF = re.compile(r"^\s*(?:ROOT )?%([^ ]+) = [a-z0-9]+\[([0-9,]*)\]")
DOT = re.compile(r" dot\(%([^,]+), %([^)]+)\)")

def dims(text):
    return [int(n) for n in text.split(",") if n]

def dot_flops(hlo):
    shapes = {m.group(1): dims(m.group(2))
              for m in map(DEF.match, hlo.splitlines()) if m}
    total = 0
    for line in hlo.splitlines():
        if " dot(" not in line:
            continue
        lhs = shapes[DOT.search(line).group(1)]
        k = re.search(r"lhs_contracting_dims=\{([0-9,]*)\}", line).group(1)
        total += 2 * math.prod(dims(DEF.match(line).group(2))) * math.prod(
            lhs[i] for i in dims(k))
    return total

cfg = get_config("chatglm3-6b", smoke=True)
shape = dataclasses.replace(SHAPES["train_4k"], seq_len=64, global_batch=8)
mesh = make_mesh((4, 2), ("data", "model"))
attention_mod.FORCE_DENSE = True
out = {}
for d in (0, 1):
    c = dataclasses.replace(cfg, n_layers=d, remat="none")
    _, comp = lower_cell(c, shape, mesh, donate=False)
    hlo = comp.as_text()
    assert " while(" not in hlo   # each dot runs once
    coll = rl.collective_bytes(hlo).bytes_by_kind
    _, comp32 = lower_cell(dataclasses.replace(c, dtype="float32"), shape,
                           mesh, donate=False)
    out[d] = {"xla_flops": _cost_analysis(comp).get("flops", 0.0),
              "dot_flops": dot_flops(hlo), "kinds": sorted(coll),
              "bytes": coll,
              "bytes_f32": rl.collective_bytes(comp32.as_text()).bytes_by_kind}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def ref_points():
    """:data:`REF_POINTS`' counts, by depth."""
    return {int(d): v for d, v in run_script(REF_POINTS).items()}


@pytest.fixture(scope="module")
def dense_points():
    """A smoke dense train cell (chatglm3-6b, 8 x 64 on a (4, 2) mesh,
    no remat) counted at depth 0, 1 and its full 2 layers."""
    depths = (0, 1, get_config("chatglm3-6b", smoke=True).n_layers)
    got = port_cell("chatglm3-6b", "train_4k", 64, 8,
                    *(f"n_layers={d},remat=none" for d in depths))
    return {d: got[f"n_layers={d},remat=none"] for d in depths}


def test_depth_points_equal_the_references_products(dense_points,
                                                     ref_points):
    """The port's per-chip FLOPs at depth 0 and 1 equal the FLOPs of the
    products in the reference's compiled points for the same cell.
    XLA's own count adds elementwise work on top (1.20-1.23x here,
    printed).  The collective kinds: DTensor reduce-scatters a split
    gradient and a branch's output where XLA on the CPU all-reduces,
    and gathers the embedding's table where XLA moves the looked-up rows
    with all-to-alls (the bytes of each kind:
    :func:`test_collective_bytes_by_kind_beside_the_reference`)."""
    for d in (0, 1):
        got, ref = dense_points[d], ref_points[d]
        print(f"depth {d}: port {got['flops']:.0f}, reference products "
              f"{ref['dot_flops']:.0f}, XLA {ref['xla_flops']:.0f} "
              f"({ref['xla_flops'] / got['flops']:.3f}x); kinds "
              f"{got['kinds']} / {ref['kinds']}")
        assert got["flops"] == ref["dot_flops"] > 0, d
        assert ref["xla_flops"] >= ref["dot_flops"]
        assert got["kinds"] == ["all-gather", "all-reduce",
                                "reduce-scatter"], d
        assert ref["kinds"] == ["all-gather", "all-reduce", "all-to-all"], d


#: The port's collectives in the smoke chatglm3-6b train cell at float32
#: (8 x 64 on the (4, 2) mesh, no remat): wire bytes a chip by (kind,
#: issuing op, source), at depth 0 and for one layer (depth 1 less 0).
PORT_GROUPS = r"""
import collections, dataclasses, json
from repro_torch.configs.registry import SHAPES, get_config
from repro_torch.launch import dryrun as D, roofline as rl
from repro_torch.launch.mesh import make_mesh
D.fake_world(8)
mesh = make_mesh((4, 2), ("data", "model"), device="fake")
shape = dataclasses.replace(SHAPES["train_4k"], seq_len=64, global_batch=8)
cfg = dataclasses.replace(get_config("chatglm3-6b", smoke=True),
                          dtype="float32", remat="none")
out = {}
for d in (0, 1):
    c = D.count_cell(dataclasses.replace(cfg, n_layers=d), shape, mesh)
    groups = collections.Counter()
    for r in c.collectives:
        groups[" | ".join((r.kind, r.op, r.source))] += rl.wire_bytes(r)
    out[d] = {"groups": groups, "flops": c.flops}
print(json.dumps(out))
"""

_AG, _AR, _RS = "all-gather", "all-reduce", "reduce-scatter"
_BWD = "train/step.py:loss_and_grads <RedistributeBackward>"
_MM_BWD = "train/step.py:loss_and_grads <MmBackward0>"

#: What :data:`PORT_GROUPS` counts: each group's bytes and what it moves.
PORT_COLLECTIVES = {
    0: {
        # the embedding: its table's fsdp split gathered, the partial
        # rows of the split vocabulary summed; in the backward, the
        # activations' gradient gathered and the table's scattered
        (_AG, "redistribute", "models/model.py:_lookup"): 32768,
        (_AR, "redistribute", "models/model.py:_lookup"): 65536,
        (_AG, "redistribute.backward", _BWD): 32768,
        # the head: its input gathered over the sequence (once; its
        # gradient scattered back, below), its weight's fsdp split
        # gathered, and gathered again for the input's gradient
        (_AG, "redistribute", "models/model.py:_head"): 32768,
        (_AG, "aten.mm.default", "models/model.py:_head"): 32768,
        (_AG, "aten.mm.default", _MM_BWD): 32768,
        # the loss over the split vocabulary: the max, the sum of
        # exponentials and the label's logit summed across its split
        (_AR, "redistribute", "models/model.py:_replicate_vocab"): 3072,
        # the head input's gradient (32,768) and the table's (65,536)
        # scattered to their splits
        (_RS, "redistribute.backward", _BWD): 98304,
        # gradients brought to their params' layout: the head weight's
        # scattered over its fsdp split, the final norm's scale summed
        (_RS, "redistribute", "train/step.py:_in_layout"): 32768,
        (_AR, "redistribute", "train/step.py:_in_layout"): 1024,
        # the global norm's two partial sums of squares
        (_AR, "aten.sqrt.default", "optim/adamw.py:global_norm"): 16,
    },
    "layer": {
        # each weight's fsdp split gathered for its product (qkv 16,384,
        # the output projection 8,192, the MLP 36,864), and again in
        # the backward for the input's gradient
        (_AG, "aten.mm.default", "models/attention.py:_qkv"): 16384,
        (_AG, "aten.mm.default", "models/attention.py:_attend"): 8192,
        (_AG, "aten.mm.default", "models/mlp.py:mlp_forward"): 36864,
        (_AG, "aten.mm.default", _MM_BWD): 61440,
        # the block's input gathered over the sequence once for the
        # attention and once for the MLP; each branch's output summed
        # and scattered over the sequence; the backward of both: the
        # branch outputs' gradients gathered, the inputs' scattered
        (_AG, "redistribute", "models/attention.py:_qkv"): 32768,
        (_AG, "redistribute", "models/mlp.py:mlp_forward"): 32768,
        (_RS, "redistribute", "models/model.py:_tblock_forward"): 65536,
        (_AG, "redistribute.backward", _BWD): 65536,
        (_RS, "redistribute.backward", _BWD): 65536,
        # the layer's gradients: the weights' scattered over their fsdp
        # splits, the two norm scales summed
        (_RS, "redistribute", "train/step.py:_in_layout"): 61440,
        (_AR, "redistribute", "train/step.py:_in_layout"): 2048,
    },
}

#: The reference's wire bytes by kind for the same cell (its HLO).
REF_COLLECTIVES = {
    0: {_AG: 117760, _AR: 361536, "all-to-all": 65536},
    "layer": {_AG: 335872, _AR: 608368, "all-to-all": 32768},
}


def test_collective_bytes_by_kind_beside_the_reference(ref_points):
    """Each collective kind's wire bytes a chip in the smoke chatglm3-6b
    train cell (8 x 64 on a (4, 2) mesh, no remat), at depth 0 and for
    one layer, held to the reference's HLO.  The port runs the cell at
    float32: XLA on the CPU carries this bf16 config's products in
    float32 (its bytes are equal for both dtypes, asserted), so the same
    element size is compared.  The port's groups are
    :data:`PORT_COLLECTIVES` (asserted whole); no kind is equal, and
    each gap is this attribution:

    Depth 0 (embedding, final norm, head, loss, AdamW):

    * all-gather +46,080: the port gathers the table's fsdp split
      (32,768) where XLA gathers the token ids (3,072) and moves rows by
      all-to-all; it keeps the head's vocabulary split and gathers its
      input over the sequence (32,768) and its weight over the fsdp
      split twice, forward and backward (65,536), where XLA splits the
      head's batch 8 ways and gathers the weight whole once (81,920);
      the activations' gradient, 32,768, on both sides:
      29,696 + 32,768 - 16,384.
    * all-reduce -291,888: the partial rows of the lookup, 65,536 on
      both sides; XLA all-reduces the table's and the head's gradients
      whole (32,768 + 131,072 + 131,072) where the port reduce-scatters
      them; the port sums the loss over the split vocabulary (3,072) and
      the norm scale and norm partials (1,040 against XLA's 1,088).
    * reduce-scatter +131,072: those two gradients (65,536 + 32,768)
      and the head input's gradient (32,768); XLA has none.
    * all-to-all -65,536: XLA's row moves of the lookup and of its
      backward; the port has none.

    One layer:

    * all-gather -81,920: the port gathers each weight over its fsdp
      split only, forward and backward (122,880), where XLA gathers the
      weights whole, the tp split too (270,336); the port gathers the
      block's input over the sequence for each branch and each branch's
      output gradient (131,072), XLA two activation gradients (65,536).
    * reduce-scatter +192,512: the port's branch outputs and inputs'
      gradients over the sequence (131,072) and the weights' gradients
      (61,440, one operand each) where XLA all-reduces.
    * all-to-all -32,768: XLA's four head re-layouts in the attention;
      the port's attention runs on each rank's own heads.
    * all-reduce -606,320: the port sums only the two norm scales
      (2,048).  XLA's 608,368 hold its branch outputs (the attention's
      65,536 in the loop) and the layer's gradients whole (the in-loop
      weight gradients, 91,136) and, fused with the global norm's sums
      outside the loop, 451,696 that list each MLP gradient twice; that
      remainder is not attributed tensor by tensor (ROADMAP queue 3).
    """
    got = run_script(PORT_GROUPS)
    assert {int(d): v["flops"] for d, v in got.items()} == {
        d: ref_points[d]["dot_flops"] for d in (0, 1)}
    ports = {d: {tuple(k.split(" | ")): v
                 for k, v in got[str(d)]["groups"].items()} for d in (0, 1)}
    layer = {k: ports[1].get(k, 0) - ports[0].get(k, 0)
             for k in set(ports[0]) | set(ports[1])}
    assert ports[0] == PORT_COLLECTIVES[0]
    assert {k: v for k, v in layer.items() if v} == \
        PORT_COLLECTIVES["layer"]
    for d in (0, 1):
        assert ref_points[d]["bytes"] == ref_points[d]["bytes_f32"], d
    refs = {0: ref_points[0]["bytes"],
            "layer": {k: ref_points[1]["bytes"][k]
                      - ref_points[0]["bytes"].get(k, 0)
                      for k in ref_points[1]["bytes"]}}
    gaps = {0: {_AG: 46080, _AR: -291888, _RS: 131072, "all-to-all": -65536},
            "layer": {_AG: -81920, _AR: -606320, _RS: 192512,
                      "all-to-all": -32768}}
    for at in (0, "layer"):
        assert refs[at] == REF_COLLECTIVES[at], at
        port = {}
        for (kind, _, _), b in PORT_COLLECTIVES[at].items():
            port[kind] = port.get(kind, 0) + b
        for kind, gap in gaps[at].items():
            assert port.get(kind, 0) - refs[at].get(kind, 0) == gap, \
                (at, kind)


#: The smoke MoE cells counted with the expert FFN as it is (argv
#: ``egcd``) or in its earlier form (``gecd``-ordered einsums), on a fake
#: world of 8.
MOE_FORMS = r"""
import dataclasses, json, sys, torch
import torch.nn.functional as F
from repro_torch.configs.registry import SHAPES, get_config
from repro_torch.launch import dryrun as D, roofline as rl
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import moe

def gecd(params, buf):
    gate = torch.einsum("gecd,edf->gecf", buf, params["w_gate"])
    up = torch.einsum("gecd,edf->gecf", buf, params["w_up"])
    return torch.einsum("gecf,efd->gecd", F.silu(gate) * up,
                        params["w_down"])

D.fake_world(8)
mesh = make_mesh((4, 2), ("data", "model"), device="fake")
if sys.argv[1] == "gecd":
    moe._experts = gecd
out = {}
for arch in ("qwen3-moe-235b-a22b", "mixtral-8x22b"):
    for name, seq in (("train_4k", 64), ("decode_32k", 128)):
        shape = dataclasses.replace(SHAPES[name], seq_len=seq,
                                    global_batch=8)
        c = D.count_cell(get_config(arch, smoke=True), shape, mesh)
        out[f"{arch}/{name}"] = {
            "flops": c.flops, "bytes": c.bytes_accessed,
            "kinds": rl.collective_bytes(c.collectives).bytes_by_kind}
print(json.dumps(out))
"""


def test_moe_expert_products_count_as_before():
    """The expert FFN runs expert-major (``models/moe.py:_experts``), so
    torch 2.11's DTensor takes no view of a gathered block whose memory
    order its strides misdescribe.  Under this torch the smoke qwen3-moe
    (experts split) and mixtral (split within each expert) cells count
    the same FLOPs and collective bytes of each kind as with the earlier
    ``gecd``-ordered einsums, and the same bytes but in mixtral's
    decode: 16,384 fewer there, one ``cat`` that reassembled an
    all-gather along the second dim of an expert block which the new
    form gathers along its first.  Each form counts in a process of its
    own, in the same order: a process's first count of a cell reads
    more bytes than a second one (ROADMAP queue 3)."""
    now, before = run_script(MOE_FORMS, "egcd"), run_script(MOE_FORMS,
                                                           "gecd")
    assert len(now) == 4
    for key, new in now.items():
        old = before[key]
        assert new["flops"] == old["flops"] > 0, key
        assert new["kinds"] == old["kinds"], key
        less = 16384 if key == "mixtral-8x22b/decode_32k" else 0
        assert new["bytes"] == old["bytes"] - less, key


def test_full_depth_counts_equal_the_composition(dense_points):
    """The same cell at its full 2 layers: FLOPs equal ``compose`` of the
    depth-0 and depth-1 counts, as the reference composes its cost-mode
    points.  Bytes agree within 5 %: with no layer, the embedding feeds
    the head directly and DTensor moves the activations between other
    layouts, a step the composition does not see."""
    cfg = get_config("chatglm3-6b", smoke=True)
    pts = {d: rl.CostPoint(dense_points[d]["flops"], dense_points[d]["bytes"])
           for d in (0, 1)}
    full = dense_points[cfg.n_layers]
    composed = rl.compose(cfg, pts)
    assert pts[1].flops > pts[0].flops > 0
    assert full["flops"] == composed.flops
    assert abs(full["bytes"] - composed.bytes_accessed) <= \
        0.05 * full["bytes"]


@pytest.mark.parametrize("shape_name,seq", [("train_4k", 64),
                                            ("decode_32k", 128)])
def test_small_cells_beside_the_reference(shape_name, seq):
    """``tests/test_dryrun_small.py``'s xlstm cells (batch 8 on a (4, 2)
    mesh): FLOPs and collectives present, every collective seen by
    ``CommDebugMode``.  The per-chip memory is printed beside the
    reference's XLA figure (arguments, outputs and temporaries less
    aliases) and held to 0.4-0.8 of it: the readings are 0.54 (train)
    and 0.55 (decode), the peak of live local bytes against XLA's
    buffer assignment, which keeps more temporaries at once.  The
    dominant collective kind is printed beside it."""
    got = port_cell("xlstm-125m", shape_name, seq, 8, "")[""]
    script = REF_SMALL_SCRIPT
    if shape_name != "train_4k":
        script = script.replace(
            'SHAPES["train_4k"], seq_len=64, global_batch=8',
            'SHAPES["decode_32k"], seq_len=128, global_batch=8')
    script = script.replace(
        '"coll_bytes": coll.total_bytes,',
        '"coll_bytes": coll.total_bytes, "dominant": coll.dominant, '
        '"total_gb": (mem.argument_size_in_bytes + mem.temp_size_in_bytes'
        ' + mem.output_size_in_bytes - mem.alias_size_in_bytes) / 2**30,')
    want = run_script(script)
    print(f"{shape_name}: port peak {got['peak'] / 2**30:.6f} GB, "
          f"{got['dominant']}; reference {want['total_gb']:.6f} GB, "
          f"{want['dominant']}")
    assert got["flops"] > 0 and got["coll_ops"] > 0
    assert got["comm"] == got["coll_ops"]
    ratio = got["peak"] / 2**30 / want["total_gb"]
    assert 0.4 <= ratio <= 0.8, ratio


def test_cli_runs_a_full_width_cell_and_skips_the_inapplicable(tmp_path):
    """``python -m repro_torch.launch.dryrun`` on 256 fake ranks: a cell
    of the full xlstm-125m at long_500k is ``ok``; gemma-7b at long_500k
    is skipped with the reference's reason."""
    out = tmp_path / "cells.json"
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "xlstm-125m", "--shape", "long_500k", "--out", str(out)],
        env=ENV, capture_output=True, text=True, timeout=TIMEOUT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    (row,) = json.loads(out.read_text())
    assert row["status"] == "ok" and row["mesh"] == "16x16"
    assert row["roofline"]["hlo_flops_global"] > 0
    assert row["collectives"]["n_ops"] > 0
    assert "[dryrun] xlstm-125m" in proc.stdout
    from repro.configs.shapes import shape_applicable as ref_applicable
    from repro_torch.launch.dryrun import run_cell

    row = run_cell("gemma-7b", "long_500k")
    assert row == {"arch": "gemma-7b", "shape": "long_500k",
                   "status": "skipped",
                   "reason": ref_applicable(ref_config("gemma-7b"),
                                            SHAPES["long_500k"])[1]}


# ------------------------------------------------------------ split vocab

#: One smoke config of each family.
FAMILIES = ("chatglm3-6b", "mixtral-8x22b", "zamba2-1.2b", "xlstm-125m",
            "musicgen-medium", "phi-3-vision-4.2b")


def rank_loss(rank: int) -> dict:
    """Each family's float32 smoke loss over a (2, 2) mesh, its logits
    split along the vocabulary, against the loss on one device.  MoE
    configs route with no token dropped (capacity for every token), so
    the mesh's routing groups do not change which tokens an expert
    takes."""
    import numpy as np
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.dist import sharding as shd
    from repro_torch.models import model as PM

    mesh = elastic.make_mesh_from(["cpu"] * 4, (2, 2))
    out = {}
    for arch in FAMILIES:
        cfg = dataclasses.replace(get_config(arch, smoke=True),
                                  dtype="float32")
        if cfg.is_moe:
            cfg = dataclasses.replace(cfg, capacity_factor=cfg.n_experts)
        params, axes = PM.init(0, cfg, device="cpu")
        rng = np.random.default_rng(1)
        tshape = (4, 16, cfg.n_codebooks) if cfg.family == "audio" else \
            (4, 16)
        batch = {k: torch.from_numpy(rng.integers(
            0, cfg.vocab_size, tshape).astype(np.int32))
            for k in ("tokens", "labels")}
        if cfg.family == "vlm":
            batch["patches"] = torch.from_numpy(rng.standard_normal(
                (4, cfg.n_patches, cfg.d_model)).astype(np.float32))
        with torch.no_grad():
            want, _ = PM.loss_fn(params, batch, cfg)
            placed = elastic.reshard(params, axes, mesh)
            split = {k: shd.sharding_for(
                v.shape, ("batch",) + (None,) * (v.dim() - 1), mesh).place(v)
                for k, v in batch.items()}
            with mesh, implicit_replication():
                logits, _ = PM.forward(placed, split, cfg)
                got, _ = PM.loss_fn(placed, split, cfg)
        out[arch] = {"got": float(got.full_tensor()), "want": float(want),
                     "vocab_split": any(p.is_shard(logits.dim() - 1)
                                        for p in logits.placements)}
    return out


def rank_serve(rank: int) -> dict:
    """A float32 smoke dense model over a (2, 2) mesh: ``prefill`` of a
    prompt (the cache built from split keys) and one ``decode`` step (the
    new key written into a split cache), against one device."""
    import numpy as np
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.dist import sharding as shd
    from repro_torch.models import model as PM

    cfg = dataclasses.replace(get_config("chatglm3-6b", smoke=True),
                              dtype="float32")
    params, axes = PM.init(0, cfg, device="cpu")
    mesh = elastic.make_mesh_from(["cpu"] * 4, (2, 2))
    rng = np.random.default_rng(2)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 16))
                              .astype(np.int32))
    nxt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 1))
                           .astype(np.int32))
    with torch.no_grad():
        want_p, cache = PM.prefill(params, {"tokens": tokens}, cfg, 16)
        want_d, _ = PM.decode(params, nxt, PM.fresh_cache(cfg, 4, 16,
                                                         device="cpu"), cfg)
        placed = elastic.reshard(params, axes, mesh)

        def split(t):
            return shd.sharding_for(t.shape, ("batch",) + (None,) * (
                t.dim() - 1), mesh).place(t)

        with mesh, implicit_replication():
            got_p, got_cache = PM.prefill(placed, {"tokens": split(tokens)},
                                          cfg, 16)
            fresh = PM.fresh_cache(cfg, 4, 16, device="cpu")
            axes = sp.cache_axes_tree(cfg, fresh).layers
            layers = type(fresh.layers)(*(
                shd.sharding_for(t.shape, a, mesh).place(t)
                for t, a in zip(fresh.layers, axes)))
            got_d, _ = PM.decode(placed, split(nxt),
                                 PM.ServeCache(layers, None), cfg)
    scale = float(want_p.abs().max())
    return {"prefill": float((got_p.full_tensor() - want_p).abs().max())
            / scale,
            "cache_k": float((got_cache.layers.k.full_tensor()
                              - cache.layers.k).abs().max()),
            "decode": float((got_d.full_tensor() - want_d).abs().max())
            / float(want_d.abs().max())}


def test_prefill_and_decode_over_four_ranks_equal_one_device(tmp_path):
    """The cache a split prompt builds and the slot a split decode step
    writes (one-hot selects where DTensor has no ``index_put``) give the
    one-device logits within 1e-5 of the largest."""
    for got in spawn("serve", tmp_path, module="test_torch_dryrun"):
        assert got["prefill"] <= 1e-5 and got["decode"] <= 1e-5, got
        assert got["cache_k"] <= 1e-5, got


@pytest.mark.parametrize("arch,grid", [("musicgen-medium", "1x8"),
                                       ("chatglm3-6b", "2x4")])
def test_heads_that_do_not_divide_the_tp_axis(arch, grid):
    """4 query heads over a tp axis of 8 (sequence-parallel attention, the
    heads merged again in the backward) and 2 KV heads over 4 (gathered
    before the split): a smoke train cell counts, as musicgen-medium's 24
    and chatglm3-6b's 2 KV heads over 16 do at full width."""
    got = port_cell(arch, "train_4k", 64, 8, "", grid=grid)[""]
    assert got["flops"] > 0 and got["coll_ops"] > 0
    assert got["comm"] == got["coll_ops"]


def test_loss_on_split_vocabulary_equals_one_device(tmp_path):
    for ranks in spawn("loss", tmp_path, module="test_torch_dryrun"):
        for arch, got in ranks.items():
            assert got["vocab_split"], arch
            assert abs(got["got"] - got["want"]) <= 1e-5 * abs(got["want"]), \
                (arch, got)


def test_streaming_core_on_a_block_of_query_rows():
    """What one rank runs under sequence-parallel attention: its rows of
    the queries against every key.  The streaming core equals the dense
    one on those rows (and the full-sequence call is unchanged)."""
    from repro_torch.models import attention as attn

    cfg = dataclasses.replace(get_config("chatglm3-6b", smoke=True),
                              dtype="float32")
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((2, 32, 4, 16), generator=g) for _ in range(3))
    pos = torch.arange(32, dtype=torch.int32).expand(2, 32)
    want = attn._attend_dense(q, k, v, pos, pos, cfg)
    rows = slice(8, 16)
    got = attn._attend_streaming(q[:, rows], k, v, pos[:, rows], pos, cfg,
                                 q_chunk=4, kv_chunk=8)
    assert (got - want[:, rows]).abs().max() <= 1e-5
    full = attn._attend_streaming(q, k, v, pos, pos, cfg, q_chunk=8,
                                  kv_chunk=8)
    assert (full - want).abs().max() <= 1e-5


def test_split_vocabulary_helpers_equal_the_plain_ones():
    """On a plain tensor the loss keeps ``torch.gather`` and
    ``torch.logsumexp``: the one-device path is unchanged."""
    from repro_torch.models import model as PM

    g = torch.Generator().manual_seed(0)
    lg = torch.randn((3, 5, 11), generator=g)
    labels = torch.randint(0, 11, (3, 5), generator=g)
    assert torch.equal(PM._logsumexp(lg), torch.logsumexp(lg, dim=-1))
    assert torch.equal(PM._label_logit(lg, labels),
                       torch.gather(lg, -1, labels[..., None])[..., 0])
