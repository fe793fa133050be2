"""NDS q72 for the port: its data and its plan.

- `datagen` is a numpy-only copy of the reference bench's generator
  (`benchmarks/bench_nds_q72.py::_datagen`): the same seed gives the same
  arrays. At scale 1 the bench uses 10,000,000 catalog_sales rows (five
  INT64 columns), inventory with one row per (item, week): 500 x 104 =
  52,000 rows, 500 items, 20 household demographics, 15 warehouses and
  730 dates.
- `q72_plan` is the DAG of `benchmarks/nds_plans.py::q72_plan`, built with
  the port's own builder: catalog_sales joined to household_demographics
  (buy potential 3), item and date_dim (year 1), the residual ship_days > 5,
  inventory on the composite (item, week) key, the residual inv_qty < qty
  and warehouse; counted by (item, warehouse, week) and ordered by the
  count descending, then the three keys ascending.
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
    """(cs, inv, items, hd, wh, dates): dicts of INT64 numpy columns."""
    rng = np.random.default_rng(seed)
    n_items, n_wh, n_hd, n_dates = 500, 15, 20, 365 * 2
    cs = {"item_sk": rng.integers(0, n_items, n_sales).astype(np.int64),
          "hd_sk": rng.integers(0, n_hd, n_sales).astype(np.int64),
          "sold_date_sk": rng.integers(0, n_dates - 10,
                                       n_sales).astype(np.int64),
          "ship_days": rng.integers(0, 14, n_sales).astype(np.int64),
          "qty": rng.integers(1, 20, n_sales).astype(np.int64)}
    # inventory: one row per (item, week) with a quantity on hand
    n_weeks = n_dates // 7
    item_g, week_g = np.meshgrid(np.arange(n_items), np.arange(n_weeks))
    inv = {"inv_item_sk": item_g.ravel().astype(np.int64),
           "inv_week": week_g.ravel().astype(np.int64),
           "inv_wh_sk": rng.integers(0, n_wh, item_g.size).astype(np.int64),
           "inv_qty": rng.integers(0, 25, item_g.size).astype(np.int64)}
    items = {"i_item_sk": np.arange(n_items, dtype=np.int64),
             "i_brand": rng.integers(0, 50, n_items).astype(np.int64)}
    hd = {"hd_demo_sk": np.arange(n_hd, dtype=np.int64),
          "hd_buy_potential": rng.integers(0, 5, n_hd).astype(np.int64)}
    wh = {"w_warehouse_sk": np.arange(n_wh, dtype=np.int64)}
    dates = {"d_date_sk": np.arange(n_dates, dtype=np.int64),
             "d_week": (np.arange(n_dates) // 7).astype(np.int64),
             "d_year": (np.arange(n_dates) // 365).astype(np.int64)}
    return cs, inv, items, hd, wh, dates


TABLES = ("cs", "inv", "items", "hd", "wh", "dates")


def q72_inputs(n_sales: int, seed: int = 0,
               device: Optional[Union[str, torch.device]] = None
               ) -> Dict[str, Table]:
    """{"cs", "inv", "items", "hd", "wh", "dates"} tables from `datagen`,
    every column INT64. `device=None` means the CUDA card, as for every
    entry point."""
    return {name: Table([Column.from_numpy(a, dtypes.INT64, device=device)
                         for a in d.values()], list(d))
            for name, d in zip(TABLES, datagen(n_sales, seed))}


def q72_plan() -> Plan:
    b = PlanBuilder()
    cs = b.scan("cs", schema=["item_sk", "hd_sk", "sold_date_sk",
                              "ship_days", "qty"])
    inv = b.scan("inv", schema=["inv_item_sk", "inv_week", "inv_wh_sk",
                                "inv_qty"])
    items = b.scan("items", schema=["i_item_sk", "i_brand"])
    hd = (b.scan("hd", schema=["hd_demo_sk", "hd_buy_potential"])
          .filter(col("hd_buy_potential") == 3))
    wh = b.scan("wh", schema=["w_warehouse_sk"])
    dates = (b.scan("dates", schema=["d_date_sk", "d_week", "d_year"])
             .filter(col("d_year") == 1))
    j = (cs.join(hd, "hd_sk", "hd_demo_sk")
           .join(items, "item_sk", "i_item_sk")
           .join(dates, "sold_date_sk", "d_date_sk")
           .filter(col("ship_days") > 5)
           # composite (item, week) key: one inventory row per combination
           .join(inv, ["i_item_sk", "d_week"], ["inv_item_sk", "inv_week"])
           .filter(col("inv_qty") < col("qty"))
           .join(wh, "inv_wh_sk", "w_warehouse_sk"))
    return (j.aggregate(["i_item_sk", "w_warehouse_sk", "d_week"],
                        [("qty", "size", "cnt")])
             .sort(["cnt", "i_item_sk", "w_warehouse_sk", "d_week"],
                   ascending=[False, True, True, True])
             .build())
