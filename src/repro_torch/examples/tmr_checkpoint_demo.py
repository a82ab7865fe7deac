"""TMR-protected checkpointing: the paper's majority-vote error
correction (§8.1) applied to training state, healing silent data
corruption.

The counterpart of the reference's ``examples/tmr_checkpoint_demo.py``.

Usage:  python -m repro_torch.examples.tmr_checkpoint_demo [--device cpu]
"""

import argparse
import os
import tempfile

import torch

from repro_torch.ckpt import tmr_store
from repro_torch.configs.registry import get_config
from repro_torch.core import tree as tree_util
from repro_torch.train.step import init_train_state


def main(argv=None):
    ap = argparse.ArgumentParser(description="TMR-protected checkpoints")
    ap.add_argument("--device", default="cuda",
                    help="where the state lives (default: the card)")
    device = ap.parse_args(argv).device

    cfg = get_config("chatglm3-6b", smoke=True)
    state, _ = init_train_state(0, cfg, device=device)

    with tempfile.TemporaryDirectory() as d:
        paths = tmr_store.save(state, d, step=100, replicas=3)
        print(f"[tmr] wrote {len(paths)} replicas")

        # simulate silent data corruption in one replica's payload
        shard = os.path.join(d, "replica_1", "step_00000100", "shard_p0.npz")
        with open(shard, "rb") as f:
            blob = bytearray(f.read())
        for off in range(len(blob) // 2, len(blob) // 2 + 64):
            blob[off] ^= 0xA5
        with open(shard, "wb") as f:
            f.write(bytes(blob))
        print("[tmr] corrupted 64 bytes of replica_1 (SDC injection)")

        restored, step, healed = tmr_store.restore(state, d)
        exact = all(torch.equal(a, b) for a, b in zip(
            tree_util.flatten(state)[0], tree_util.flatten(restored)[0]))
        print(f"[tmr] restored step {step}: healed {healed} replica(s), "
              f"bit-exact={exact}")

        n_healed = tmr_store.scrub(state, d)
        print(f"[tmr] scrubber re-replicated {n_healed} corrupted replica(s)")
        _, _, healed2 = tmr_store.restore(state, d)
        print(f"[tmr] post-scrub restore: {healed2} unhealthy replicas")


if __name__ == "__main__":
    main()
