"""TMR/XMR-protected checkpoint store (the paper's §8.1 case study applied).

The paper shows MAJX implements X-way modular redundancy in memory: MAJ3
corrects one faulty replica, MAJ5/7/9 up to 2/3/4.  At 1000+-node scale,
silent data corruption in checkpoint storage is a real failure mode;
this store writes X independent replicas (on real deployments: different
hosts / storage domains) and majority-votes them bitwise on restore —
with ``use_kernel=True`` through the MAJX kernel
(:func:`repro_torch.kernels.majx.ops.vote`: one launch a leaf on the
card), else through the plain vote of :mod:`repro_torch.pud.tmr` —
healing any minority corruption without recomputation.  Leaves restore
onto the devices of their counterparts in ``tree_like``, so a tree that
lives on the card is voted there.

The restore path also *detects* which replicas disagreed (CRC vs
manifest), and :func:`scrub` rewrites each corrupted replica from the
healed state.
"""

from __future__ import annotations

import os
from typing import Optional

from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.core import tree as tree_util
from repro_torch.pud import tmr


def save(tree, directory: str, step: int, replicas: int = 3) -> list[str]:
    if replicas % 2 == 0:
        raise ValueError("replica count must be odd for majority voting")
    paths = []
    for r in range(replicas):
        rdir = os.path.join(directory, f"replica_{r}")
        paths.append(ckpt.save(tree, rdir, step))
    return paths


def restore(tree_like, directory: str, step: Optional[int] = None,
            use_kernel: bool = False):
    """Vote-restore; returns (tree, step, n_healed_replicas)."""
    rdirs = sorted(d for d in os.listdir(directory)
                   if d.startswith("replica_"))
    if not rdirs:
        raise FileNotFoundError(f"no replicas under {directory}")
    trees, healthy = [], []
    step_found = None
    for d in rdirs:
        try:
            t, s = ckpt.restore(tree_like, os.path.join(directory, d),
                                step, verify=True)
            trees.append(t)
            healthy.append(True)
            step_found = s
        except Exception:
            # CRC failure or unreadable replica: still try raw bytes so the
            # voter can out-vote the corruption (verify=False).
            try:
                t, s = ckpt.restore(tree_like, os.path.join(directory, d),
                                    step, verify=False)
                trees.append(t)
                healthy.append(False)
                step_found = s
            except Exception:
                healthy.append(False)
    if not trees:
        raise IOError("all replicas unreadable")
    if len(trees) == 1:
        return trees[0], step_found, sum(1 for h in healthy if not h)
    if len(trees) % 2 == 0:
        trees = trees[:-1]
    if use_kernel:
        from repro_torch.kernels.majx.ops import vote as kvote
        flats = [tree_util.flatten(t) for t in trees]
        voted = [kvote([f[0][i] for f in flats])
                 for i in range(len(flats[0][0]))]
        out = tree_util.unflatten(flats[0][1], voted)
    else:
        out = tmr.vote_pytree(trees)
    return out, step_found, sum(1 for h in healthy if not h)


def scrub(tree_like, directory: str, step: Optional[int] = None) -> int:
    """Background scrubber: vote, then rewrite any corrupted replica from
    the healed state.  Returns #healed."""
    healed_tree, s, bad = restore(tree_like, directory, step)
    if bad:
        rdirs = sorted(d for d in os.listdir(directory)
                       if d.startswith("replica_"))
        for d in rdirs:
            try:
                ckpt.restore(tree_like, os.path.join(directory, d), s,
                             verify=True)
            except Exception:
                ckpt.save(healed_tree, os.path.join(directory, d), s)
    return bad
