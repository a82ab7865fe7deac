"""Optimizer: AdamW with fp32 master weights and global-norm clipping
(:mod:`.adamw`), and gradient compression with error feedback
(:mod:`.compression`)."""
