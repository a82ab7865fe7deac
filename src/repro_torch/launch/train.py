"""Training launcher.

Runs on the card; ``--device cpu`` trains on the host instead.  The
smoke configs train anywhere; the full configs (no ``--smoke``) are
sized for the card.

Examples:
  python -m repro_torch.launch.train --arch xlstm-125m --steps 8
  python -m repro_torch.launch.train --arch xlstm-125m --smoke --steps 50
  python -m repro_torch.launch.train --arch chatglm3-6b --smoke \
      --steps 100 --ckpt-dir /tmp/ck --tmr 3 --fail-at 30
"""

from __future__ import annotations

import argparse
import sys

from repro_torch.configs.base import TrainConfig
from repro_torch.configs.registry import get_config
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.ft.failures import FailurePlan
from repro_torch.train.trainer import Trainer, TrainerConfig


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--compression", default="none",
                    choices=("none", "int8", "topk"))
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--tmr", type=int, default=0,
                    help="TMR replica count for the checkpoint store (0=off)")
    ap.add_argument("--fail-at", type=int, action="append", default=[],
                    help="inject a simulated node failure at this step")
    ap.add_argument("--device", default="cuda",
                    help="where to train (default: the card)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=args.smoke)
    tc = TrainConfig(lr=args.lr, total_steps=args.steps,
                     warmup_steps=max(args.steps // 10, 1),
                     microbatches=args.microbatches,
                     compression=args.compression)
    loader = SyntheticLM(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq,
        global_batch=args.batch, n_codebooks=cfg.n_codebooks,
        n_patches=cfg.n_patches if cfg.family == "vlm" else 0,
        d_model=cfg.d_model))
    trainer = Trainer(
        cfg, tc, loader,
        TrainerConfig(ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                      tmr_replicas=args.tmr),
        failure_plan=FailurePlan(at_steps=tuple(args.fail_at)),
        device=args.device,
    )
    history = trainer.run(args.steps)
    first = history[0]["loss"] if history else float("nan")
    last = history[-1]["loss"] if history else float("nan")
    print(f"[train] {cfg.name}: loss {first:.4f} -> {last:.4f} "
          f"over {len(history)} recorded steps")
    return 0


if __name__ == "__main__":
    sys.exit(main())
