"""End-to-end training driver: a ~100M-parameter xLSTM for a few hundred
steps on the synthetic pipeline, with checkpoint-restart, an injected
node failure, and TMR-protected checkpoints.

The counterpart of the reference's ``examples/train_tiny_lm.py``, and
the small twin of ``python -m repro_torch.launch.train``: the same
``Trainer`` drives the full configs.

Usage:  python -m repro_torch.examples.train_tiny_lm [--steps 200]
            [--small] [--fail-at 120] [--device cpu]
(--small trains the reduced config, a quick demo on the CPU.)
"""

import argparse
import tempfile

from repro_torch.configs.base import TrainConfig
from repro_torch.configs.registry import get_config
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.ft.failures import FailurePlan
from repro_torch.train.trainer import Trainer, TrainerConfig


def main(argv=None):
    ap = argparse.ArgumentParser(description="train a small LM")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--small", action="store_true",
                    help="train the reduced config (fast CPU demo)")
    ap.add_argument("--fail-at", type=int, default=120)
    ap.add_argument("--device", default="cuda",
                    help="where the model trains (default: the card)")
    args = ap.parse_args(argv)

    if args.small:
        cfg = get_config("xlstm-125m", smoke=True)
        batch, seq = 8, 64
    else:
        # ~100M-param xLSTM (the assigned xlstm-125m config itself)
        cfg = get_config("xlstm-125m")
        batch, seq = 4, 128

    n = cfg.n_params()
    print(f"[example] training {cfg.name}: ~{n/1e6:.0f}M params, "
          f"{args.steps} steps, batch {batch} x seq {seq}")

    tc = TrainConfig(lr=1e-3, total_steps=args.steps,
                     warmup_steps=max(args.steps // 10, 1))
    loader = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                    global_batch=batch))
    with tempfile.TemporaryDirectory() as ckpt_dir:
        trainer = Trainer(
            cfg, tc, loader,
            TrainerConfig(ckpt_dir=ckpt_dir, ckpt_every=50, tmr_replicas=3,
                          log_every=20),
            failure_plan=FailurePlan(at_steps=(args.fail_at,)),
            device=args.device,
        )
        hist = trainer.run(args.steps)
    losses = [h["loss"] for h in hist]
    print(f"[example] loss: {losses[0]:.4f} -> {losses[-1]:.4f} "
          f"(survived 1 injected node failure via checkpoint-restart)")
    if not losses[-1] < losses[0]:
        raise RuntimeError("the loss did not decrease")


if __name__ == "__main__":
    main()
