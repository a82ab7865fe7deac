"""Distributed-execution utilities: logical-axis sharding rules."""

from repro_torch.dist.sharding import (  # noqa: F401
    AxisRules, DEFAULT_RULES, SERVE_RULES, axis_extent, constraint,
    use_rules,
)
