"""NDS q3 for the port: its data and its plan.

- `datagen` is a numpy-only copy of the reference bench's generator
  (`benchmarks/bench_nds_q3.py::_datagen`): the same seed gives the same
  arrays. At scale 1 the bench uses 10,000,000 store_sales rows against
  3,650 dates and 20,000 items.
- `q3_plan` is the DAG of `benchmarks/nds_plans.py::q3_plan`, built with
  the port's own builder: store_sales joined to date_dim (d_moy = 11) and
  item (i_manufact = 42), grouped by (d_year, i_brand) summing the price in
  cents, ordered by year ascending and revenue descending.
"""
from __future__ import annotations

from typing import Dict, Optional, Union

import numpy as np
import torch

from . import dtypes
from .columnar import Column, Table
from .plan import Plan, PlanBuilder, col

N_SALES_SCALE_1 = 10_000_000


def datagen(n_sales: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    n_dates, n_items = 365 * 10, 20_000         # 10 years, 20k items
    date_sk = np.arange(n_dates, dtype=np.int64)
    d_year = 1998 + date_sk // 365
    d_moy = (date_sk % 365) // 31 + 1
    item_sk = np.arange(n_items, dtype=np.int64)
    i_brand = rng.integers(0, 1000, n_items).astype(np.int64)
    i_manufact = rng.integers(0, 100, n_items).astype(np.int64)
    ss = {
        "sold_date_sk": rng.integers(0, n_dates, n_sales).astype(np.int64),
        "item_sk": rng.integers(0, n_items, n_sales).astype(np.int64),
        "price_cents": rng.integers(1, 10_000, n_sales).astype(np.int64),
    }
    return (date_sk, d_year, d_moy, item_sk, i_brand, i_manufact, ss)


def _table(names, arrays, device) -> Table:
    return Table([Column.from_numpy(a, dtypes.INT64, device=device)
                  for a in arrays], names)


def q3_inputs(n_sales: int, seed: int = 0,
              device: Optional[Union[str, torch.device]] = None
              ) -> Dict[str, Table]:
    """{"sales", "dates", "items"} tables from `datagen`, all INT64.
    `device=None` means the CUDA card, as for every entry point."""
    (date_sk, d_year, d_moy, item_sk, i_brand, i_manufact, ss) = \
        datagen(n_sales, seed)
    return {
        "sales": _table(["sold_date_sk", "item_sk", "price_cents"],
                        [ss["sold_date_sk"], ss["item_sk"],
                         ss["price_cents"]], device),
        "dates": _table(["d_date_sk", "d_year", "d_moy"],
                        [date_sk, d_year, d_moy], device),
        "items": _table(["i_item_sk", "i_brand", "i_manufact"],
                        [item_sk, i_brand, i_manufact], device),
    }


def q3_plan() -> Plan:
    b = PlanBuilder()
    sales = b.scan("sales", schema=["sold_date_sk", "item_sk", "price_cents"])
    dates = (b.scan("dates", schema=["d_date_sk", "d_year", "d_moy"])
             .filter(col("d_moy") == 11))
    items = (b.scan("items", schema=["i_item_sk", "i_brand", "i_manufact"])
             .filter(col("i_manufact") == 42))
    j = (sales.join(dates, left_on="sold_date_sk", right_on="d_date_sk")
              .join(items, left_on="item_sk", right_on="i_item_sk"))
    return (j.aggregate(["d_year", "i_brand"],
                        [("price_cents", "sum", "revenue")])
             .sort(["d_year", "revenue"], ascending=[True, False])
             .build())
