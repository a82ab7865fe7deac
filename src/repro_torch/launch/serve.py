"""Serving launcher: batched generation with continuous batching.

  python -m repro_torch.launch.serve --arch gemma-7b --smoke --requests 8

Runs on the card; ``--device cpu`` runs on the host instead.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from repro_torch.configs.registry import get_config
from repro_torch.models import model as M
from repro_torch.serve.engine import Engine, Request


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=args.smoke)
    params, _ = M.init(0, cfg, device=args.device)
    engine = Engine(params, cfg, max_seq=args.max_seq, device=args.device)

    rng = np.random.default_rng(0)
    reqs = []
    for i in range(args.requests):
        if cfg.family == "audio":
            prompt = rng.integers(0, cfg.vocab_size,
                                  (args.prompt_len, cfg.n_codebooks),
                                  dtype=np.int32)
        else:
            prompt = rng.integers(0, cfg.vocab_size, (args.prompt_len,),
                                  dtype=np.int32)
        reqs.append(Request(rid=i, prompt=prompt, max_new_tokens=args.max_new))

    t0 = time.time()
    done = engine.generate(reqs)
    dt = time.time() - t0
    n_tok = sum(len(r.out_tokens) for r in done)
    print(f"[serve] {cfg.name}: {len(done)} requests, {n_tok} tokens in "
          f"{dt:.2f}s ({n_tok/dt:.1f} tok/s incl. compile)")
    for r in done[:2]:
        toks = [int(np.asarray(t).flat[0]) for t in r.out_tokens[:8]]
        print(f"  req {r.rid}: {toks} ...")
    return 0


if __name__ == "__main__":
    sys.exit(main())
