"""The four assigned input shapes (LM-family; seq_len x global_batch)."""

from __future__ import annotations

from repro_torch.configs.base import ShapeConfig

SHAPES = {
    "train_4k": ShapeConfig("train_4k", seq_len=4096, global_batch=256,
                            kind="train"),
    "prefill_32k": ShapeConfig("prefill_32k", seq_len=32768, global_batch=32,
                               kind="prefill"),
    "decode_32k": ShapeConfig("decode_32k", seq_len=32768, global_batch=128,
                              kind="decode"),
    "long_500k": ShapeConfig("long_500k", seq_len=524288, global_batch=1,
                             kind="decode"),
}


def shape_applicable(arch_cfg, shape: ShapeConfig) -> tuple[bool, str]:
    """long_500k requires a sub-quadratic attention path (DESIGN.md §4)."""
    if shape.name == "long_500k" and not arch_cfg.subquadratic:
        return False, ("skip: pure full-attention arch has no sub-quadratic "
                       "path for 500k context (noted in DESIGN.md)")
    return True, ""
