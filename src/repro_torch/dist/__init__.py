"""Distributed-execution utilities: logical-axis sharding rules, the
device mesh and placement."""

from repro_torch.dist.sharding import (  # noqa: F401
    AxisRules, DEFAULT_RULES, SERVE_RULES, Mesh, Sharding, axis_extent,
    constraint, sharding_for, tree_shardings, use_rules,
)
