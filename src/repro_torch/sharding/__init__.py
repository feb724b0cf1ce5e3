from .rules import (ShardingRules, constrain, current_rules, param_shardings,
                    param_specs, spec_to_placements, use_rules)

__all__ = ["ShardingRules", "constrain", "current_rules", "param_shardings",
           "param_specs", "spec_to_placements", "use_rules"]
