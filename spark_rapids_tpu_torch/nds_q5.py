"""NDS q5 for the port: its data and its plan.

- `datagen` is a numpy-only copy of the reference bench's generator
  (`benchmarks/bench_nds_q5.py::_datagen`): the same seed gives the same
  arrays. Three channels (store, catalog, web) of n, n / 2 and n / 3 sales
  rows and a tenth as many returns each, every column INT64; 1,825 dates.
  At scale 1 the bench uses n = 10,000,000: 20,166,666 rows in all.
- `q5_plan` is the DAG of `benchmarks/nds_plans.py::q5_plan`, built with
  the port's own builder: per channel the sales rows (price, profit, 0, 0)
  and the returns rows (0, 0, amount, loss) in one Union, semi-joined to
  the 14-day date window and summed by entity; the three channels tagged
  0, 1 and 2 in a second Union that feeds both the per-channel subtotals
  and the grand total (channel -1); the two in a last Union, ordered by
  channel, then sales descending.
"""
from __future__ import annotations

from typing import Dict, Optional, Union

import numpy as np
import torch

from . import dtypes
from .columnar import Column, Table
from .plan import Plan, PlanBuilder, col, lit

N_SALES_SCALE_1 = 10_000_000
DATE_LO, DATE_HI = 700, 714          # the 14-day window of the real q5
CHANNELS = ("store", "catalog", "web")


def datagen(n_sales: int, seed: int = 0):
    """({channel: dict of INT64 numpy columns}, date_sk): sales columns
    s_sk, s_date, s_price, s_profit and returns columns r_sk, r_date,
    r_amt, r_loss per channel."""
    rng = np.random.default_rng(seed)
    n_dates = 365 * 5
    chans = {}
    for ci, name in enumerate(CHANNELS):
        n_s = n_sales // (ci + 1)           # store biggest, web smallest
        n_r = max(n_s // 10, 1)
        chans[name] = {
            "s_sk": rng.integers(0, 1000, n_s).astype(np.int64),
            "s_date": rng.integers(0, n_dates, n_s).astype(np.int64),
            "s_price": rng.integers(1, 10_000, n_s).astype(np.int64),
            "s_profit": rng.integers(-2_000, 5_000, n_s).astype(np.int64),
            "r_sk": rng.integers(0, 1000, n_r).astype(np.int64),
            "r_date": rng.integers(0, n_dates, n_r).astype(np.int64),
            "r_amt": rng.integers(1, 8_000, n_r).astype(np.int64),
            "r_loss": rng.integers(1, 3_000, n_r).astype(np.int64),
        }
    date_sk = np.arange(n_dates, dtype=np.int64)
    return chans, date_sk


_SALES = ("sk", "date_sk", "sales_price", "profit")
_RETURNS = ("sk", "date_sk", "return_amt", "net_loss")


def _table(names, arrays, device) -> Table:
    return Table([Column.from_numpy(a, dtypes.INT64, device=device)
                  for a in arrays], list(names))


def q5_inputs(n_sales: int, seed: int = 0,
              device: Optional[Union[str, torch.device]] = None
              ) -> Dict[str, Table]:
    """{"dates", "<channel>_sales", "<channel>_returns"} tables from
    `datagen`, every column INT64, bound as `nds_plans.q5_inputs` binds
    them. `device=None` means the CUDA card, as for every entry point."""
    chans, date_sk = datagen(n_sales, seed)
    out = {"dates": _table(["d_date_sk"], [date_sk], device)}
    for name, c in chans.items():
        out[f"{name}_sales"] = _table(
            _SALES, [c["s_sk"], c["s_date"], c["s_price"], c["s_profit"]],
            device)
        out[f"{name}_returns"] = _table(
            _RETURNS, [c["r_sk"], c["r_date"], c["r_amt"], c["r_loss"]],
            device)
    return out


def q5_plan() -> Plan:
    b = PlanBuilder()
    dates = (b.scan("dates", schema=["d_date_sk"])
             .filter((col("d_date_sk") >= DATE_LO) &
                     (col("d_date_sk") < DATE_HI)))
    sums = [("sales", "sum", "sales"), ("returns", "sum", "returns"),
            ("profit", "sum", "profit"), ("loss", "sum", "loss")]
    per = []
    for ci, name in enumerate(CHANNELS):
        s = b.scan(f"{name}_sales", schema=list(_SALES))
        r = b.scan(f"{name}_returns", schema=list(_RETURNS))
        s_rows = s.project([("sk", col("sk")), ("date_sk", col("date_sk")),
                            ("sales", col("sales_price")),
                            ("profit", col("profit")),
                            ("returns", lit(0)), ("loss", lit(0))])
        r_rows = r.project([("sk", col("sk")), ("date_sk", col("date_sk")),
                            ("sales", lit(0)), ("profit", lit(0)),
                            ("returns", col("return_amt")),
                            ("loss", col("net_loss"))])
        u = (s_rows.union(r_rows)
             .join(dates, left_on="date_sk", right_on="d_date_sk",
                   how="left_semi"))
        g = (u.aggregate(["sk"], sums)
              .project([("channel", lit(ci))] +
                       [(n, col(n)) for n in ("sk", "sales", "returns",
                                              "profit", "loss")]))
        per.append(g)
    allch = PlanBuilder.union(per)
    sub = allch.aggregate(["channel"], sums)
    tot = (allch.project([("channel", lit(-1))] +
                         [(n, col(n)) for n in ("sales", "returns",
                                                "profit", "loss")])
                .aggregate(["channel"], sums))
    return (sub.union(tot)
               .sort(["channel", "sales"], ascending=[True, False])
               .build())
