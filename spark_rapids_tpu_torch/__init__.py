"""PyTorch/CUDA port of the Spark-exact columnar engine in `spark_rapids_tpu`.

The JAX package is the reference; each module here is the counterpart of
the module at the same path there (`ops/join_cuda.py` holds the CUDA
counterparts of the Pallas kernels in `ops/join_pallas.py`). The port
imports torch and numpy, never jax and nothing of `spark_rapids_tpu`.

Entry points take an explicit device and default to the CUDA card
(`device.resolve`); tensors are moved to it once, where a plan's inputs are
bound. The port runs NDS q3 (`nds_q3`) and q72 (`nds_q72`) through the
plan engine's eager and capped tiers:
fixed-width columns, filter, gather, inner/semi/anti join, group-by, sort,
and the hash-join build/probe kernels in CUDA. Columns also hold strings,
lists and structs (`interop.table_from_buffers` takes them from the JAX
package's buffers). It hashes rows of every kind as Spark does
(`ops.murmur_hash3_32`, `ops.xxhash64`, `api.Hash`) with a fused row-hash
kernel, converts tables to Spark's JCUDF rows and back
(`api.RowConversion`, two kernels), and counts a shuffle's partitions (`parallel.partition_ids`,
`parallel.partition_histogram`, the partition maps) with a histogram
kernel. DECIMAL128 columns are (n, 4) uint32 limbs, and Spark's decimal
add, subtract, multiply, divide and remainder (`ops.*_decimal128`,
`api.DecimalUtils`) run in one decimal kernel; `entry` is the counterpart
of the repo's entry step (`__graft_entry__.entry()`). All CUDA sources
are under `ops/csrc/`. Several tasks share one card through the runtime
(`runtime/`: the resource arbiter, memory budgets, admission, spill and
the health breaker; `faultinj`; `api.RmmSpark`), which the plan executor
runs under (`PlanExecutor(session=..., health=..., degrade=...)`).
"""
from . import dtypes
from .columnar import Column, Table
from .interop import table_from_buffers, table_from_numpy
from .plan import PlanBuilder, PlanExecutor, col, lit
from . import faultinj as _faultinj

# the fault injector loads its config at import when
# SPARK_RAPIDS_TORCH_FAULTINJ_CONFIG_PATH is set
_faultinj.maybe_install_from_env()

__all__ = ["dtypes", "Column", "Table", "table_from_numpy",
           "table_from_buffers", "PlanBuilder",
           "PlanExecutor", "col", "lit"]
