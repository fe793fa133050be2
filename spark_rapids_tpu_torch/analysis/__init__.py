"""Static analysis over physical plans.

Counterpart of `spark_rapids_tpu/analysis/`:

- `verifier`: the static plan verifier (schema, dtype typing, scan
  pruning, partitioning, and an optimizer rewrite's pair checks), the
  builder's validation, the executor's pre-execution gate under
  SPARK_RAPIDS_TORCH_VERIFY_PLANS and the optimizer's per-rule check;
- `footprint`: the resource certifier, sound row and byte bounds per
  operator (the admission gate, the optimizer's certified estimates, the
  capped tier's cap seeding);
- `fuzz`: the seeded plan fuzzer, which draws the reference's plans and
  tables and checks its properties 1-5.
"""
from .footprint import (OpBound, ResourceAdmissionError, ResourceCert,
                        certify, certify_nodes, check_observed,
                        table_metadata)
from .verifier import (PlanVerificationError, VerifyReport, Violation,
                       verify, verify_rewrite)

__all__ = ["PlanVerificationError", "VerifyReport", "Violation", "verify",
           "verify_rewrite", "OpBound", "ResourceAdmissionError",
           "ResourceCert", "certify", "certify_nodes", "check_observed",
           "table_metadata"]
