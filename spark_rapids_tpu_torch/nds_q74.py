"""TPC-DS q74 for the port: its data and its plan.

q74 ranks the customers whose year-over-year growth of net paid through
the web beats their growth through stores. Its `year_total` subquery is,
per channel, sales joined to customer and to date_dim (d_year 2001 or
2002), grouped by (c_customer_id, c_first_name, c_last_name, d_year)
with sum(net_paid); the outer query joins four of them on the STRING
customer_id (store 2002 to store 2001 to web 2002 to web 2001), keeps the
customers with positive 2001 totals in both channels whose web growth
beats their store growth, and orders by customer_id (the qualification's
`order by 1,1,1`), limit 100.

- `datagen` makes the arrays with numpy from a seed: store_sales at
  N_STORE_SALES rows (q3's scale), web_sales at N_WEB_SALES, customer at
  N_CUSTOMERS and TPC-DS's 73,049-row date_dim (d_date_sk from 2,415,022,
  1900-01-02). Sales dates are uniform over 1998-2002, so about 40% of
  the rows fall in the two years; customer keys are uniform with 4% null;
  net_paid is INT64 cents (the unscaled decimal(7,2)) in [0, 2,000,000).
  `c_customer_id` is TPC-DS's 16-character form ("AAAAAAAA", then the
  key's eight base-16 digits as the letters A-P, least significant
  first); first names (2-20 bytes) and last names (2-30 bytes) come from
  seeded vocabularies of 5,000 each, 3.5% null.
- `q74_inputs` binds them as port tables; `q74_plan` is the DAG, each
  channel's aggregate shared by its two year filters.

TPC-DS compares two quotients, w2 / w1 > s2 / s1, each guarded by a
positive denominator. Both denominators are positive where the filter
holds (s1 > 0 and w1 > 0 are its other terms), so the product form
w2 * s1 > s2 * w1 is the same test; the plan uses it because plan
expressions have no division.
"""
from __future__ import annotations

from typing import Dict, Optional, Union

import numpy as np
import torch

from . import device as _device
from . import dtypes
from .columnar import Column, Table, make_string_column
from .plan import Plan, PlanBuilder, col

N_STORE_SALES = 10_000_000
N_WEB_SALES = 2_500_000
N_CUSTOMERS = 500_000
N_DATES = 73_049              # TPC-DS date_dim: 1900-01-02 .. 2100-01-01
FIRST_DATE_SK = 2_415_022
YEARS = (2001, 2002)
NULL_CUSTOMER = 0.04
NULL_NAME = 0.035
VOCABULARY = 5_000
LIMIT = 100


def _vocabulary(rng, n: int, lo: int, hi: int):
    """n random capitalised words of lo..hi bytes: (chars, offsets)."""
    lens = rng.integers(lo, hi + 1, n)
    offs = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(lens, out=offs[1:])
    chars = rng.integers(ord("a"), ord("z") + 1, int(offs[-1])
                         ).astype(np.uint8)
    chars[offs[:-1]] -= 32                      # capitalised
    return chars, offs


def _pick(rng, vocab, n: int):
    """n rows drawn from `vocab`, NULL_NAME of them null (empty): (chars,
    int32 offsets, validity)."""
    chars, offs = vocab
    idx = rng.integers(0, offs.shape[0] - 1, n)
    valid = rng.random(n) >= NULL_NAME
    lens = np.where(valid, offs[idx + 1] - offs[idx], 0)
    out = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(lens, out=out[1:])
    row = np.repeat(np.arange(n), lens)
    data = chars[offs[idx][row] + np.arange(out[-1]) - out[row]]
    return data, out.astype(np.int32), valid


def customer_ids(sk: np.ndarray) -> np.ndarray:
    """(n, 16) uint8: TPC-DS's c_customer_id of each key."""
    ids = np.full((sk.shape[0], 16), ord("A"), np.uint8)
    ids[:, 8:] += ((sk[:, None].astype(np.int64) >> (4 * np.arange(8)))
                   & 15).astype(np.uint8)
    return ids


def datagen(n_store: int = N_STORE_SALES, n_web: int = N_WEB_SALES,
            n_customers: int = N_CUSTOMERS, seed: int = 0):
    """The four tables' arrays (see the module docstring)."""
    rng = np.random.default_rng(seed)
    date_sk = FIRST_DATE_SK + np.arange(N_DATES, dtype=np.int64)
    day = np.datetime64("1900-01-02") + np.arange(N_DATES)
    d_year = day.astype("datetime64[Y]").astype(np.int64) + 1970
    in_range = np.nonzero((d_year >= 1998) & (d_year <= 2002))[0]

    def sales(n):
        cust = rng.integers(1, n_customers + 1, n)
        return {"sold_date_sk": date_sk[in_range[rng.integers(
                    0, in_range.shape[0], n)]],
                "customer_sk": cust,
                "customer_valid": rng.random(n) >= NULL_CUSTOMER,
                "net_paid": rng.integers(0, 2_000_000, n).astype(np.int64)}

    store, web = sales(n_store), sales(n_web)
    sk = np.arange(1, n_customers + 1, dtype=np.int64)
    first = _pick(rng, _vocabulary(rng, VOCABULARY, 2, 20), n_customers)
    last = _pick(rng, _vocabulary(rng, VOCABULARY, 2, 30), n_customers)
    customer = {"sk": sk, "ids": customer_ids(sk), "first": first,
                "last": last}
    return {"store": store, "web": web, "customer": customer,
            "dates": {"d_date_sk": date_sk, "d_year": d_year}}


def _strings(data, offs, valid, device) -> Column:
    return make_string_column(
        torch.from_numpy(np.ascontiguousarray(data)).to(device),
        torch.from_numpy(np.ascontiguousarray(offs)).to(device),
        None if valid is None else torch.from_numpy(valid).to(device))


def q74_inputs(n_store: int = N_STORE_SALES, n_web: int = N_WEB_SALES,
               n_customers: int = N_CUSTOMERS, seed: int = 0,
               device: Optional[Union[str, torch.device]] = None,
               gen=None) -> Dict[str, Table]:
    """{"store_sales", "web_sales", "customer", "date_dim"} from `datagen`
    (or the given `gen`): keys and years INT32, net_paid INT64, the
    customer's id and names STRING. `device=None` means the CUDA card, as
    for every entry point."""
    dev = _device.resolve(device)
    g = gen if gen is not None else datagen(n_store, n_web, n_customers,
                                            seed)

    def i32(a, valid=None):
        return Column.from_numpy(a.astype(np.int32), dtypes.INT32, valid,
                                 device=dev)

    def sales(d, p):
        return Table([i32(d["sold_date_sk"]),
                      i32(d["customer_sk"], d["customer_valid"]),
                      Column.from_numpy(d["net_paid"], dtypes.INT64,
                                        device=dev)],
                     [f"{p}_sold_date_sk", f"{p}_customer_sk",
                      f"{p}_net_paid"])
    c = g["customer"]
    n = c["sk"].shape[0]
    id_offs = np.arange(0, 16 * (n + 1), 16, dtype=np.int32)
    customer = Table([i32(c["sk"]),
                      _strings(c["ids"].reshape(-1), id_offs, None, dev),
                      _strings(*c["first"], dev), _strings(*c["last"], dev)],
                     ["c_customer_sk", "c_customer_id", "c_first_name",
                      "c_last_name"])
    d = g["dates"]
    return {"store_sales": sales(g["store"], "ss"),
            "web_sales": sales(g["web"], "ws"), "customer": customer,
            "date_dim": Table([i32(d["d_date_sk"]), i32(d["d_year"])],
                              ["d_date_sk", "d_year"])}


def q74_plan(limit: Optional[int] = LIMIT, builder=PlanBuilder,
             col=col) -> Plan:
    """TPC-DS q74 (see the module docstring); `limit=None` keeps every
    qualifying customer, in customer_id order. `builder` and `col` are the
    plan builder and column reference to build with (the port's by
    default; another engine's with the same interface gives the same
    DAG)."""
    b = builder()
    customer = b.scan("customer", schema=["c_customer_sk", "c_customer_id",
                                          "c_first_name", "c_last_name"])
    dates = (b.scan("date_dim", schema=["d_date_sk", "d_year"])
             .filter((col("d_year") == YEARS[0])
                     | (col("d_year") == YEARS[1])))
    totals = {}
    for chan, p in (("s", "ss"), ("w", "ws")):
        sales = b.scan("store_sales" if chan == "s" else "web_sales",
                       schema=[f"{p}_sold_date_sk", f"{p}_customer_sk",
                               f"{p}_net_paid"])
        year_total = (
            sales.join(dates, left_on=f"{p}_sold_date_sk",
                       right_on="d_date_sk")
                 .join(customer, left_on=f"{p}_customer_sk",
                       right_on="c_customer_sk")
                 .aggregate(["c_customer_id", "c_first_name", "c_last_name",
                             "d_year"], [(f"{p}_net_paid", "sum", "total")]))
        for i, year in enumerate(YEARS, 1):
            name = f"{chan}{i}"
            picked = {f"{name}_id": col("c_customer_id"),
                      f"{name}_total": col("total")}
            if name == "s2":
                picked = {"customer_id": col("c_customer_id"),
                          "customer_first_name": col("c_first_name"),
                          "customer_last_name": col("c_last_name"),
                          "s2_total": col("total")}
            totals[name] = (year_total.filter(col("d_year") == year)
                            .project(picked))
    joined = (totals["s2"]
              .join(totals["s1"], left_on="customer_id", right_on="s1_id")
              .join(totals["w2"], left_on="customer_id", right_on="w2_id")
              .join(totals["w1"], left_on="customer_id", right_on="w1_id")
              .filter((col("s1_total") > 0) & (col("w1_total") > 0)
                      & (col("w2_total") * col("s1_total")
                         > col("s2_total") * col("w1_total")))
              .project({"customer_id": col("customer_id"),
                        "customer_first_name": col("customer_first_name"),
                        "customer_last_name": col("customer_last_name")})
              .sort(["customer_id"]))
    return (joined if limit is None else joined.limit(limit)).build()


def numpy_q74(gen, limit: Optional[int] = LIMIT):
    """q74 over `datagen`'s arrays with numpy alone, grouping and joining on
    the integer customer key (one-to-one with c_customer_id, and each
    customer has one name): the qualifying customers' keys in customer_id
    order, first `limit`."""
    c = gen["customer"]
    n_cust = c["sk"].shape[0]
    d = gen["dates"]

    def totals(s, year):
        yr = d["d_year"][s["sold_date_sk"] - FIRST_DATE_SK]
        keep = s["customer_valid"] & (yr == year)
        cust = s["customer_sk"][keep]
        tot = np.zeros(n_cust + 1, dtype=np.int64)
        np.add.at(tot, cust, s["net_paid"][keep])
        has = np.zeros(n_cust + 1, dtype=bool)
        has[cust] = True
        return tot, has
    s1, hs1 = totals(gen["store"], YEARS[0])
    s2, hs2 = totals(gen["store"], YEARS[1])
    w1, hw1 = totals(gen["web"], YEARS[0])
    w2, hw2 = totals(gen["web"], YEARS[1])
    ok = (hs1 & hs2 & hw1 & hw2 & (s1 > 0) & (w1 > 0)
          & (w2 * s1 > s2 * w1))
    sk = np.nonzero(ok)[0]
    ids = customer_ids(sk)
    order = np.lexsort(ids.T[::-1])
    sk = sk[order]
    return sk if limit is None else sk[:limit]
