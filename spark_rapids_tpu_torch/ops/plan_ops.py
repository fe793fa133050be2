"""The op table the plan executor calls through, under the JAX package's
public op names.

The JAX package's executor calls its public `ops` surface by module
attribute, so the admission wrappers and the fault injector's shims see
every op a plan dispatches. The port's executor chooses a kernel per
operator (the registry's `KernelChoice`), so its crossing point is this
table instead: each entry takes the choice and runs the kernel or, on CPU
tensors, its plain version. The eager tier and the degraded CPU tier call
every op through here, as `plan_ops.<name>(...)` looked up at call time,
in the order the JAX executor calls the same names on its fallback route:

| Operator     | Calls |
|--------------|-------|
| Filter       | `apply_boolean_mask(t, mask)` |
| FusedSelect  | `apply_boolean_mask(t, predicate=, needed=, choice=)` |
| HashJoin     | `inner_join` then `take_table` twice; `left_semi_join` or `left_anti_join` then `take_table` |
| HashAggregate (keyed) | `groupby_aggregate` |
| Sort         | `sort_table` |
| TopK         | `sort_table(..., limit=n)` then `slice_table` |
| Limit        | `slice_table` |
| Union        | `concat_tables` |

Each entry is admitted (`runtime.admission.admitted_op`) with the JAX
package's factor for its name, from `ops/__init__.py`'s
`_ADMITTED_FACTORS` (the JAX package's `spark_rapids_tpu/ops/__init__.py`
table); `slice_table` is not admitted there, nor here. The
capped tier does not call through this table: a CUDA graph replay runs no
Python, so it admits and injects once per attempt instead.
"""
from __future__ import annotations

from typing import Optional, Sequence

from ..runtime.admission import admitted_op as _admitted_op
from . import (_ADMITTED_FACTORS, aggregate, copying, gather, join, select,
               sort, topk)

__all__ = ["apply_boolean_mask", "take_table", "inner_join",
           "left_semi_join", "left_anti_join", "groupby_aggregate",
           "sort_table", "slice_table", "concat_tables"]


def _kernel(choice) -> bool:
    return choice is not None and not choice.fallback


def apply_boolean_mask(table, mask=None, *, predicate=None,
                       needed: Optional[Sequence[str]] = None, choice=None):
    """A Filter's rows where `mask` holds; or a FusedSelect's `needed`
    columns of the rows where `predicate` holds (the FusedSelect kernel
    where `choice` names it, else its plain version)."""
    if predicate is None:
        return gather.apply_boolean_mask(table, mask)
    if _kernel(choice):
        return choice.fn(table, predicate, needed)
    return select.fused_select_plain(table, predicate, needed)


def take_table(table, idx, _has_negative=None):
    return gather.take_table(table, idx, _has_negative=_has_negative)


def inner_join(lkeys, rkeys, *, choice=None):
    """Gather maps (left, right) of the inner equi-join: the hash-join
    kernels where `choice` names them, else the sort-based join."""
    if _kernel(choice):
        return choice.fn(lkeys, rkeys)
    return join.inner_join(lkeys, rkeys)


def left_semi_join(lkeys, rkeys, *, choice=None):
    if _kernel(choice):
        from . import join_cuda
        return join_cuda.left_semi_join_hash(lkeys, rkeys)
    return join.left_semi_join(lkeys, rkeys)


def left_anti_join(lkeys, rkeys, *, choice=None):
    if _kernel(choice):
        from . import join_cuda
        return join_cuda.left_anti_join_hash(lkeys, rkeys)
    return join.left_anti_join(lkeys, rkeys)


def groupby_aggregate(table, key_names, aggs, *, choice=None):
    return aggregate.groupby_aggregate(table, list(key_names), list(aggs),
                                       choice=choice)


def sort_table(table, key_names, ascending, *, limit: Optional[int] = None,
               choice=None, words=None):
    """The stable sort by `key_names`; with `limit`, a TopK: its first
    `limit` rows (the TopK kernels where `choice` names them)."""
    if limit is None:
        return sort.sort_table(table, key_names=list(key_names),
                               ascending=list(ascending))
    if _kernel(choice):
        return choice.fn(table, list(key_names), list(ascending), limit,
                         words=words)
    return topk.topk_plain(table, key_names, ascending, limit)


def slice_table(table, start: int, end: int):
    """Rows [start, end), clamped; the table itself when that is all of
    it (a TopK kernel's output already has at most its n rows)."""
    if start <= 0 and end >= table.num_rows:
        return table
    return copying.slice_table(table, start, end)


def concat_tables(tables):
    return copying.concat_tables(tables)


# the JAX package's factors, from the public surface's one table;
# slice_table is not admitted there
for _name in __all__:
    if _name in _ADMITTED_FACTORS:
        globals()[_name] = _admitted_op(globals()[_name],
                                        factor=_ADMITTED_FACTORS[_name])
del _name
