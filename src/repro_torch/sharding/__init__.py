from repro_torch.sharding.api import (  # noqa: F401
    NamedSharding,
    ShardingContext,
    constrain,
    current_context,
    logical_to_pspec,
    mesh_view,
    placements,
    sharding_context,
)
from repro_torch.sharding.rules import RULE_PROFILES, rules_for  # noqa: F401
