"""NDS q3 for the port: its data and its plan.

- `datagen` is a numpy-only copy of the reference bench's generator
  (`benchmarks/bench_nds_q3.py::_datagen`): the same seed gives the same
  arrays. At scale 1 the bench uses 10,000,000 store_sales rows against
  3,650 dates and 20,000 items.
- `q3_plan` is the DAG of `benchmarks/nds_plans.py::q3_plan`, built with
  the port's own builder: store_sales joined to date_dim (d_moy = 11) and
  item (i_manufact = 42), grouped by (d_year, i_brand) summing the price in
  cents, ordered by year ascending and revenue descending.
- `q3_tpcds_plan` and `q3_tpcds_inputs` are q3 as TPC-DS writes it: the
  same DAG ending in `order by d_year, sum_agg desc, brand_id limit 100`,
  over the same arrays with the key and dimension columns typed `int`, as
  Spark's TPC-DS schema (databricks/spark-sql-perf `TPCDSTables`) types
  them, and the price kept INT64 (the unscaled decimal(7,2)).
- `q3_tpcds_strings_plan` and `q3_tpcds_strings_inputs` are q3 with the
  item's brand as TPC-DS types it: `i_brand_id` INT32 and `i_brand` a
  STRING, one name per brand id (`brand_name`), grouped by (d_year,
  i_brand, i_brand_id) and ordered by d_year, revenue descending and
  i_brand_id, limit 100.
"""
from __future__ import annotations

from typing import Dict, Optional, Union

import numpy as np
import torch

from . import device as _device
from . import dtypes
from .columnar import Column, Table
from .ops.gather import take
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


def _table(names, arrays, device, dtypes_) -> Table:
    # torch.tensor converts each array to the column's storage dtype
    return Table([Column.from_numpy(a, dt, device=device)
                  for a, dt in zip(arrays, dtypes_)], names)


def _inputs(n_sales, seed, device, key) -> Dict[str, Table]:
    """The three tables from `datagen`, prices INT64 and every other
    column of dtype `key`."""
    (date_sk, d_year, d_moy, item_sk, i_brand, i_manufact, ss) = \
        datagen(n_sales, seed)
    return {
        "sales": _table(["sold_date_sk", "item_sk", "price_cents"],
                        [ss["sold_date_sk"], ss["item_sk"],
                         ss["price_cents"]], device,
                        [key, key, dtypes.INT64]),
        "dates": _table(["d_date_sk", "d_year", "d_moy"],
                        [date_sk, d_year, d_moy], device, [key] * 3),
        "items": _table(["i_item_sk", "i_brand", "i_manufact"],
                        [item_sk, i_brand, i_manufact], device, [key] * 3),
    }


def q3_inputs(n_sales: int, seed: int = 0,
              device: Optional[Union[str, torch.device]] = None
              ) -> Dict[str, Table]:
    """{"sales", "dates", "items"} tables from `datagen`, all INT64.
    `device=None` means the CUDA card, as for every entry point."""
    return _inputs(n_sales, seed, device, dtypes.INT64)


def q3_tpcds_inputs(n_sales: int, seed: int = 0,
                    device: Optional[Union[str, torch.device]] = None
                    ) -> Dict[str, Table]:
    """The same arrays as `q3_inputs`, with the keys and the dimension
    attributes INT32 and `price_cents` INT64: 16 bytes per sales row."""
    return _inputs(n_sales, seed, device, dtypes.INT32)


# the syllables dsdgen builds names from (TPC-DS's digit syllables)
SYLLABLES = ("ought", "able", "pri", "ese", "anti", "cally", "ation", "eing",
             "bar", "n st")


def brand_name(brand_id: int) -> str:
    """A brand's name as dsdgen forms `i_brand`: syllables, then " #" and a
    number; one name per id in [0, 1000), 12 to 18 bytes."""
    b = int(brand_id)
    return (SYLLABLES[(b // 100) % 10] + SYLLABLES[(b // 10) % 10]
            + SYLLABLES[b % 10] + f" #{b % 9 + 1}")


def q3_tpcds_strings_inputs(n_sales: int, seed: int = 0,
                            device: Optional[Union[str, torch.device]] = None
                            ) -> Dict[str, Table]:
    """`q3_tpcds_inputs`' tables with the item's brand as TPC-DS types it:
    items are (i_item_sk, i_brand_id INT32, i_brand STRING, i_manufact),
    `i_brand` the `brand_name` of `i_brand_id`. `device=None` means the
    CUDA card, as for every entry point."""
    t = q3_tpcds_inputs(n_sales, seed, "cpu")
    items = t["items"]
    names = Column.from_pylist([brand_name(b) for b in range(1000)],
                               dtypes.STRING, device="cpu")
    brand = take(names, items["i_brand"].data.to(torch.int64),
                 _has_negative=False)
    t["items"] = Table([items["i_item_sk"],
                        Column(dtypes.INT32, items.num_rows,
                               items["i_brand"].data),
                        brand, items["i_manufact"]],
                       ["i_item_sk", "i_brand_id", "i_brand", "i_manufact"])
    return {k: v.to(_device.resolve(device)) for k, v in t.items()}


def q3_tpcds_strings_plan(limit: Optional[int] = 100, builder=PlanBuilder,
                          col=col) -> Plan:
    """TPC-DS q3 as TPC-DS writes it: `q3_tpcds_plan`'s joins, grouped by
    (d_year, i_brand, i_brand_id) with `i_brand` a STRING, ordered by
    d_year, revenue descending and i_brand_id, limited to `limit` rows
    (None keeps every group). `builder` and `col` as in
    `nds_q74.q74_plan`."""
    b = builder()
    sales = b.scan("sales", schema=["sold_date_sk", "item_sk", "price_cents"])
    dates = (b.scan("dates", schema=["d_date_sk", "d_year", "d_moy"])
             .filter(col("d_moy") == 11))
    items = (b.scan("items", schema=["i_item_sk", "i_brand_id", "i_brand",
                                     "i_manufact"])
             .filter(col("i_manufact") == 42))
    j = (sales.join(dates, left_on="sold_date_sk", right_on="d_date_sk")
              .join(items, left_on="item_sk", right_on="i_item_sk"))
    ordered = (j.aggregate(["d_year", "i_brand", "i_brand_id"],
                           [("price_cents", "sum", "revenue")])
                .sort(["d_year", "revenue", "i_brand_id"],
                      ascending=[True, False, True]))
    return (ordered if limit is None else ordered.limit(limit)).build()


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


def q3_tpcds_plan(limit: Optional[int] = 100) -> Plan:
    """TPC-DS q3: `q3_plan`'s DAG ordered by d_year, revenue descending and
    i_brand, limited to `limit` rows (100, as TPC-DS writes it; None keeps
    every group). The item filter stays i_manufact = 42, not TPC-DS's 128:
    `datagen` draws i_manufact uniformly from [0, 100), so 128 would
    select nothing."""
    b = PlanBuilder()
    sales = b.scan("sales", schema=["sold_date_sk", "item_sk", "price_cents"])
    dates = (b.scan("dates", schema=["d_date_sk", "d_year", "d_moy"])
             .filter(col("d_moy") == 11))
    items = (b.scan("items", schema=["i_item_sk", "i_brand", "i_manufact"])
             .filter(col("i_manufact") == 42))
    j = (sales.join(dates, left_on="sold_date_sk", right_on="d_date_sk")
              .join(items, left_on="item_sk", right_on="i_item_sk"))
    ordered = (j.aggregate(["d_year", "i_brand"],
                           [("price_cents", "sum", "revenue")])
                .sort(["d_year", "revenue", "i_brand"],
                      ascending=[True, False, True]))
    return (ordered if limit is None else ordered.limit(limit)).build()
