"""Count one dry-run cell with config overrides and print its roofline
terms and top collectives (the perf-hypothesis loop's tool).

The counterpart of the reference's ``results/hillclimb.py``.  The cell
runs on a fake process group in this process, as
``python -m repro_torch.launch.dryrun`` runs it, and the top collectives
come from the :class:`~repro_torch.launch.roofline.CollectiveRecord`\\ s
of the count, grouped by kind, issuing op and source (where the
reference reads HLO text).

Usage:
  python -m repro_torch.paper.hillclimb --arch chatglm3-6b --shape train_4k
      --microbatches 4 --set remat=dots --show-collectives
  python -m repro_torch.paper.hillclimb --arch mixtral-8x22b
      --shape decode_32k --serve-rules
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import sys

from repro_torch.launch import roofline as rl


def top_collectives(records, n: int = 8) -> list:
    """The ``n`` largest groups of ``records`` by wire bytes, each
    ``(bytes, kind, op, source, count)``: the records of one kind, op
    and source (one product of every layer, say) summed."""
    groups: dict = collections.defaultdict(lambda: [0, 0])
    for rec in records:
        g = groups[(rec.kind, rec.op, rec.source)]
        g[0] += rl.wire_bytes(rec)
        g[1] += 1
    rows = [(b, *key, count) for key, (b, count) in groups.items()]
    rows.sort(key=lambda r: (-r[0], r[1:4]))
    return rows[:n]


def override(cfg, settings):
    """``cfg`` with each ``key=value`` of ``settings`` set, the value cast
    to the field's type."""
    for kv in settings:
        k, v = kv.split("=", 1)
        if k not in {f.name for f in dataclasses.fields(cfg)}:
            raise KeyError(f"no config field {k!r}")
        cast = type(getattr(cfg, k))
        val = v.lower() in ("1", "true") if cast is bool else cast(v)
        cfg = dataclasses.replace(cfg, **{k: val})
    return cfg


def main(argv=None) -> int:
    from repro_torch.configs.registry import SHAPES, get_config
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import make_production_mesh

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--microbatches", type=int, default=4)
    ap.add_argument("--serve-rules", action="store_true")
    ap.add_argument("--multipod", action="store_true")
    ap.add_argument("--set", action="append", default=[],
                    help="config override key=value")
    ap.add_argument("--show-collectives", action="store_true")
    args = ap.parse_args(argv)

    cfg = override(get_config(args.arch), args.set)
    shape = SHAPES[args.shape]
    D.fake_world(512 if args.multipod else 256)
    mesh = make_production_mesh(multi_pod=args.multipod, device="fake")
    mb = args.microbatches if shape.kind == "train" else 1
    c = D.count_cell(cfg, shape, mesh, microbatches=mb,
                     serve_rules=args.serve_rules)
    coll = rl.collective_bytes(c.collectives)
    print(f"cell={args.arch}/{args.shape} mb={mb} "
          f"serve_rules={args.serve_rules} overrides={args.set}")
    print(f"count={c.wall_s:.0f}s mem={c.peak_bytes / 2**30:.2f}GB "
          f"(arg {c.argument_bytes / 2**30:.2f} temp "
          f"{(c.peak_bytes - c.argument_bytes) / 2**30:.2f})")
    print(f"flops/chip={c.flops:.3e} bytes/chip={c.bytes_accessed:.3e}")
    kinds = {k: round(v / 2**30, 2) for k, v in coll.bytes_by_kind.items()}
    print(f"collectives: total={coll.total_bytes / 2**30:.2f}GB "
          f"t_coll={coll.total_bytes / rl.NVLINK_BW:.3f}s by kind={kinds}")
    if args.show_collectives:
        for b, kind, op, source, count in top_collectives(c.collectives):
            print(f"  {b / 2**30:8.2f}GB {kind:14s} x{count:<5d} {op:28s} "
                  f"{source}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
