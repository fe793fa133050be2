"""NDS q23 for the port: its data and its plan.

- `datagen` is a numpy-only copy of the reference bench's generator
  (`benchmarks/bench_nds_q23.py::_datagen`): the same seed gives the same
  arrays. store_sales has n rows, catalog_sales n / 2 and web_sales n / 4,
  each (item_sk, cust_sk, qty, price) INT64, with zipf-skewed items (2,000)
  and customers (5,000). At scale 1 the bench uses n = 10,000,000.
- `q23_plan` is the DAG of `benchmarks/nds_plans.py::q23_plan`, built with
  the port's own builder. Its two subqueries are shared DAG nodes, run
  once a plan: the frequent items (count by item over store_sales, HAVING
  count > FREQ_THRESHOLD) and the best customers (revenue by customer,
  HAVING revenue > BEST_FRACTION * MAX(revenue), a scalar subquery). Both
  sides semi-join them and sum qty * price; a Union of the two one-row
  totals is summed into the result.
"""
from __future__ import annotations

from typing import Dict, Optional, Union

import numpy as np
import torch

from . import dtypes
from .columnar import Column, Table
from .plan import Plan, PlanBuilder, col, lit, scalar_max

N_SALES_SCALE_1 = 10_000_000
FREQ_THRESHOLD = 4
BEST_FRACTION = 0.95
SIDES = ("catalog", "web")


def datagen(n_sales: int, seed: int = 0):
    """(store, {"catalog", "web"}): dicts of INT64 numpy columns item_sk,
    cust_sk, qty and price."""
    rng = np.random.default_rng(seed)
    n_items, n_cust = 2_000, 5_000
    # zipf-ish skew so the HAVING clauses select non-trivial subsets
    items = (rng.zipf(1.3, n_sales) % n_items).astype(np.int64)
    custs = (rng.zipf(1.2, n_sales) % n_cust).astype(np.int64)
    store = {"item_sk": items, "cust_sk": custs,
             "qty": rng.integers(1, 10, n_sales).astype(np.int64),
             "price": rng.integers(1, 1000, n_sales).astype(np.int64)}
    sides = {}
    for name, frac in (("catalog", 2), ("web", 4)):
        m = max(n_sales // frac, 16)
        sides[name] = {
            "item_sk": (rng.zipf(1.3, m) % n_items).astype(np.int64),
            "cust_sk": (rng.zipf(1.2, m) % n_cust).astype(np.int64),
            "qty": rng.integers(1, 10, m).astype(np.int64),
            "price": rng.integers(1, 1000, m).astype(np.int64)}
    return store, sides


def q23_inputs(n_sales: int, seed: int = 0,
               device: Optional[Union[str, torch.device]] = None
               ) -> Dict[str, Table]:
    """{"store", "catalog", "web"} tables from `datagen`, every column
    INT64, bound as `nds_plans.q23_inputs` binds them. `device=None` means
    the CUDA card, as for every entry point."""
    store, sides = datagen(n_sales, seed)
    return {name: Table([Column.from_numpy(a, dtypes.INT64, device=device)
                         for a in d.values()], list(d))
            for name, d in (("store", store), *sides.items())}


def q23_plan() -> Plan:
    b = PlanBuilder()
    schema = ["item_sk", "cust_sk", "qty", "price"]
    store = b.scan("store", schema=schema)
    # subquery 1: frequent items, shared by both sides below
    freq = (store.aggregate(["item_sk"], [("qty", "count", "cnt")])
                 .filter(col("cnt") > FREQ_THRESHOLD))
    # subquery 2: best customers, HAVING sum > fraction * MAX(sum); the
    # scalar aggregate reduces over the live groups only in the capped tier
    best = (store.project([("cust_sk", col("cust_sk")),
                           ("rev", col("qty") * col("price"))])
                 .aggregate(["cust_sk"], [("rev", "sum", "rev")])
                 .filter(col("rev") >
                         lit(BEST_FRACTION) * scalar_max(col("rev"))))
    side_totals = []
    for name in SIDES:
        side = b.scan(name, schema=schema)
        tot = (side.join(freq, left_on="item_sk", right_on="item_sk",
                         how="left_semi")
                   .join(best, left_on="cust_sk", right_on="cust_sk",
                         how="left_semi")
                   .project([("rev", col("qty") * col("price"))])
                   .aggregate([], [("rev", "sum", "total")]))
        side_totals.append(tot)
    return (side_totals[0].union(side_totals[1])
            .aggregate([], [("total", "sum", "total")])
            .build())
