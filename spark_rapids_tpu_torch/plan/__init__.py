from .builder import Plan, PlanBuilder, Rel
from .executor import PlanExecutor, PlanResult
from .expr import col, lit
from .nodes import PlanValidationError

__all__ = ["Plan", "PlanBuilder", "Rel", "PlanExecutor", "PlanResult",
           "col", "lit", "PlanValidationError"]
