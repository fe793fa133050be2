"""Static analysis over physical plans.

Counterpart of `spark_rapids_tpu/analysis/`:

- `verifier`: the static plan verifier (schema, dtype typing, scan
  pruning, partitioning, and an optimizer rewrite's pair checks), the
  builder's validation, the executor's pre-execution gate under
  SPARK_RAPIDS_TORCH_VERIFY_PLANS and the optimizer's per-rule check;
- `fuzz`: the seeded plan fuzzer, which draws the reference's plans and
  tables and checks its properties 1-3.

The resource certifier (`footprint`) waits for ROADMAP queue A item 11.
"""
from .verifier import (PlanVerificationError, VerifyReport, Violation,
                       verify, verify_rewrite)

__all__ = ["PlanVerificationError", "VerifyReport", "Violation", "verify",
           "verify_rewrite"]
