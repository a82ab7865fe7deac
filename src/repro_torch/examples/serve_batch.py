"""Batched serving with continuous batching on a smoke-size Gemma, with
the engine's PUD integrity hook healing a corrupted parameter replica
(a majority vote through the ``cuda`` backend's kernels) before any
traffic is served.

The counterpart of the reference's ``examples/serve_batch.py``.

Usage:  python -m repro_torch.examples.serve_batch [--device cpu]
"""

import argparse
import time

import numpy as np

from repro_torch.configs.registry import get_config
from repro_torch.core import rng as threefry
from repro_torch.core import tree as tree_util
from repro_torch.models import model as M
from repro_torch.pud.tmr import corrupt
from repro_torch.serve.engine import Engine, Request


def main(argv=None, params=None):
    """``params`` (default: drawn from seed 0) are the smoke Gemma's
    weights on the device."""
    ap = argparse.ArgumentParser(description="batched serving with PUD")
    ap.add_argument("--device", default="cuda",
                    help="where the model and the votes run "
                         "(default: the card)")
    device = ap.parse_args(argv).device

    cfg = get_config("gemma-7b", smoke=True)
    if params is None:
        params, _ = M.init(0, cfg, device=device)
    # the backend is a one-string choice: "cuda" | "oracle" | "sim"
    engine = Engine(params, cfg, max_seq=96, pud_backend="cuda",
                    device=device)

    # PUD hook: one replica suffers silent data corruption; the engine
    # majority-votes the three replicas back to health in place
    key = threefry.PRNGKey(7)
    leaves, structure = tree_util.flatten(params)
    bad = tree_util.unflatten(structure, [
        corrupt(x, threefry.fold_in(key, x.numel()), 1e-5) for x in leaves])
    fixed = engine.heal_params([bad, params, params])
    ok = engine.verify_params(params)
    d = engine.pud_decisions[-1]
    print(f"[pud] healed {fixed} corrupted bits; param integrity "
          f"{ok*100:.4f}%; planner says bulk votes run on '{d.winner}' "
          f"({d.speedup:.1f}x)")

    rng = np.random.default_rng(0)
    reqs = []
    for i in range(8):
        plen = 12 if i % 2 else 16  # mixed prompt lengths
        reqs.append(Request(
            rid=i,
            prompt=rng.integers(0, cfg.vocab_size, (plen,), dtype=np.int32),
            max_new_tokens=12))

    t0 = time.time()
    done = engine.generate(reqs)
    dt = time.time() - t0
    n_tok = sum(len(r.out_tokens) for r in done)
    print(f"[serve] {len(done)} requests, {n_tok} new tokens in {dt:.1f}s")
    for r in done[:3]:
        print(f"  req {r.rid} ({len(r.prompt)}-token prompt): "
              f"{[int(t) for t in r.out_tokens[:6]]}...")


if __name__ == "__main__":
    main()
