from .builder import Plan, PlanBuilder, Rel
from .executor import PlanExecutor, PlanResult
from .expr import col, lit, scalar_max, scalar_min, scalar_sum
from .nodes import PlanValidationError
from .optimizer import subtree_fingerprints
from .stats import StatsStore, scoped_store

__all__ = ["Plan", "PlanBuilder", "Rel", "PlanExecutor", "PlanResult",
           "col", "lit", "scalar_max", "scalar_min", "scalar_sum",
           "PlanValidationError", "StatsStore", "scoped_store",
           "subtree_fingerprints"]
