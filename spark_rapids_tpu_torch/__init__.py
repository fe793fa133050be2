"""PyTorch/CUDA port of the Spark-exact columnar engine in `spark_rapids_tpu`.

The JAX package is the reference; each module here is the counterpart of
the module at the same path there (`ops/join_cuda.py` holds the CUDA
counterparts of the Pallas kernels in `ops/join_pallas.py`). The port
imports torch and numpy, never jax and nothing of `spark_rapids_tpu`.

Entry points take an explicit device and default to the CUDA card
(`device.resolve`); tensors are moved to it once, where a plan's inputs are
bound. This slice runs NDS q3 (`nds_q3`) through the eager plan engine:
fixed-width columns, filter, gather, inner/semi/anti join, group-by, sort,
and the hash-join build/probe kernels in CUDA.
"""
from . import dtypes
from .columnar import Column, Table
from .interop import table_from_numpy
from .plan import PlanBuilder, PlanExecutor, col, lit

__all__ = ["dtypes", "Column", "Table", "table_from_numpy", "PlanBuilder",
           "PlanExecutor", "col", "lit"]
