"""NDS q3 through the port's eager plan engine against the JAX package's
`PlanExecutor(mode="eager", optimize=False)` on the same tables, bit for
bit; TPC-DS q3 (INT32 keys, LIMIT 100) through both optimizers and eager
executors; plus the port's datagen and plan DAG against the reference
bench's, and the eager node kinds q3 does not reach."""
import torch_threads  # noqa: F401  (one torch thread a worker)
import os
import re
import subprocess
import sys

import numpy as np
import numpy.testing as npt
import pytest
import torch

import spark_rapids_tpu  # noqa: F401
from spark_rapids_tpu import Column as JColumn
from spark_rapids_tpu import Table as JTable
from spark_rapids_tpu.plan import PlanBuilder as JPlanBuilder
from spark_rapids_tpu.plan import PlanExecutor as JPlanExecutor
from spark_rapids_tpu.plan import col as jcol
from spark_rapids_tpu.plan import lit as jlit

from benchmarks import bench_nds_q3, nds_plans

from spark_rapids_tpu_torch import dtypes as tdt
from spark_rapids_tpu_torch import nds_q3, table_from_numpy
from spark_rapids_tpu_torch.ops import join_cuda
from spark_rapids_tpu_torch.plan import (PlanBuilder, PlanExecutor,
                                         PlanValidationError, col, lit)
from spark_rapids_tpu_torch.plan import stats as torch_stats


@pytest.fixture(autouse=True, scope="module")
def _no_torch_stats_store():
    """No stats store for the port's runs: the static engine, as the
    reference's runs are with its store off (a shared store would make
    attempts, caps and optimizer decisions depend on the file order)."""
    with torch_stats.scoped_store(None):
        yield

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port(jt: JTable):
    return table_from_numpy(
        list(jt.names), [np.asarray(c.data) for c in jt.columns],
        [None if c.validity is None else np.asarray(c.validity)
         for c in jt.columns],
        [tdt.DType(tdt.Kind(c.dtype.kind.value), c.dtype.precision,
                   c.dtype.scale) for c in jt.columns], device="cpu")


def _assert_same(jt: JTable, tt):
    assert list(jt.names) == list(tt.names)
    assert jt.num_rows == tt.num_rows
    for jc, tc in zip(jt.columns, tt.columns):
        assert jc.dtype.kind.value == tc.dtype.kind.value
        data, valid = tc.to_numpy()
        npt.assert_array_equal(np.asarray(jc.data), data)
        jv = None if jc.validity is None else np.asarray(jc.validity)
        if jv is None or valid is None:
            assert (jv is None or jv.all()) and (valid is None or valid.all())
        else:
            npt.assert_array_equal(jv, valid)


def _q3_reference(n_sales):
    sales, dates, items = bench_nds_q3.build_tables(n_sales, seed=0)
    res = JPlanExecutor(mode="eager", optimize=False).execute(
        nds_plans.q3_plan(), nds_plans.q3_inputs(sales, dates, items))
    return res.table, {"sales": sales, "dates": dates, "items": items}


@pytest.mark.parametrize("force", [False, True])
def test_q3_matches_jax_eager(monkeypatch, force):
    ref, jinputs = _q3_reference(4096)
    if force:
        monkeypatch.setenv("SPARK_RAPIDS_TORCH_KERNELS", "hash_join=cuda")
    join_cuda.reset_counters()
    res = PlanExecutor(device="cpu", optimize=False).execute(
        nds_q3.q3_plan(), {k: _port(t) for k, t in jinputs.items()})
    _assert_same(ref, res.table)
    assert ref.num_rows > 0
    stamps = [m.kernel for m in res.metrics.values() if m.kind == "HashJoin"]
    if force:
        # the forced CUDA kernels run their plain versions on CPU tensors
        assert stamps == ["cuda:hash_join"] * 2
        assert join_cuda.PLAIN_CALLS == {"build": 2, "count": 2,
                                         "emit": 2, "exists": 0, "capped": 0}
    else:
        assert stamps == ["torch:hash_join"] * 2
        assert join_cuda.PLAIN_CALLS == {"build": 0, "count": 0,
                                         "emit": 0, "exists": 0, "capped": 0}
    assert join_cuda.LAUNCHES == {"build": 0, "count": 0,
                                  "emit": 0, "exists": 0, "capped": 0}
    rows = res.profile()
    assert {r["kind"] for r in rows} == {"Scan", "Filter", "HashJoin",
                                         "HashAggregate", "Sort"}
    assert all(r["wall_ms"] is not None and r["bytes_out"] >= 0
               for r in rows)
    joins = [r for r in rows if r["kind"] == "HashJoin"]
    assert joins[0]["rows_in"] == 4096 + 310     # build sides of 310 and 195
    assert "kernel:" in res.profile_text()


def test_datagen_matches_reference():
    a = nds_q3.datagen(5000, seed=3)
    b = bench_nds_q3._datagen(5000, seed=3)
    for x, y in zip(a[:6], b[:6]):
        npt.assert_array_equal(x, y)
        assert x.dtype == y.dtype
    for k in b[6]:
        npt.assert_array_equal(a[6][k], b[6][k])
    inputs = nds_q3.q3_inputs(5000, seed=3, device="cpu")
    jt = bench_nds_q3.build_tables(5000, seed=3)
    for name, j in zip(("sales", "dates", "items"), jt):
        _assert_same(j, inputs[name])


def _shape(plan):
    return [(n.kind, n.describe(), plan.schemas.get(id(n)),
             [plan.nodes.index(c) for c in n.children]) for n in plan.nodes]


def test_q3_plan_has_the_reference_dag():
    assert _shape(nds_q3.q3_plan()) == _shape(nds_plans.q3_plan())


def _mixed_plans(builder, c, l):
    b = builder()
    facts = b.scan("facts", schema=["k", "v", "w"])
    dims = b.scan("dims", schema=["dk", "tag"]).filter(c("tag") > 2)
    semi = facts.join(dims, left_on="k", right_on="dk", how="left_semi")
    anti = facts.join(dims, left_on="k", right_on="dk", how="left_anti")
    proj = (semi.project([("k", c("k")), ("v2", c("v") * 2 + l(1)),
                          ("w", c("w")), ("big", c("v") > 50)])
                .sort(["v2", "k"], ascending=[False, True]))
    glob = anti.aggregate([], [("v", "sum", "s"), ("w", "count", "n"),
                               ("v", "min", "lo"), ("w", "max", "hi"),
                               ("v", "size", "rows")])
    return proj.build(), glob.build()


def _mixed_inputs():
    rng = np.random.default_rng(12)
    n = 600
    facts = JTable([JColumn.from_numpy(rng.integers(0, 40, n)
                                       .astype(np.int64)),
                    JColumn.from_numpy(rng.integers(0, 100, n)
                                       .astype(np.int64)),
                    JColumn.from_numpy(rng.integers(-9, 9, n)
                                       .astype(np.int32),
                                       validity=rng.random(n) > 0.2)],
                   names=["k", "v", "w"])
    dims = JTable([JColumn.from_numpy(np.arange(30, dtype=np.int64)),
                   JColumn.from_numpy(rng.integers(0, 6, 30)
                                      .astype(np.int64))],
                  names=["dk", "tag"])
    return {"facts": facts, "dims": dims}


@pytest.mark.parametrize("which", [0, 1])
def test_semi_anti_project_global_agg_match_jax(which):
    inputs = _mixed_inputs()
    jplan = _mixed_plans(JPlanBuilder, jcol, jlit)[which]
    tplan = _mixed_plans(PlanBuilder, col, lit)[which]
    ref = JPlanExecutor(mode="eager", optimize=False).execute(jplan, inputs)
    got = PlanExecutor(device="cpu").execute(
        tplan, {k: _port(t) for k, t in inputs.items()})
    _assert_same(ref.table, got.table)


def test_unported_nodes_and_errors_name_their_roadmap_item():
    """Union runs in the eager tier (equal to the JAX package's), and so
    does an Exchange, which returns its child on one device as the
    reference's does; the plan errors match the reference's."""
    b = PlanBuilder()
    plan = b.scan("t", schema=["a"]).sort(["a"]).limit(3).build()
    t = table_from_numpy(["a"], [np.arange(5, dtype=np.int64)], [None],
                         ["int64"], device="cpu")
    u = table_from_numpy(["a"], [np.arange(7, 10, dtype=np.int64)],
                         [np.array([True, False, True])], ["int64"],
                         device="cpu")
    union = b.scan("t", schema=["a"]).union(b.scan("u", schema=["a"])).build()
    got = PlanExecutor(device="cpu").execute(union, {"t": t, "u": u}).table
    jb = JPlanBuilder()
    jt = {"t": JTable([JColumn.from_numpy(np.arange(5, dtype=np.int64))],
                      names=["a"]),
          "u": JTable([JColumn.from_numpy(np.arange(7, 10, dtype=np.int64),
                                          validity=np.array([True, False,
                                                             True]))],
                      names=["a"])}
    want = JPlanExecutor(mode="eager").execute(
        jb.scan("t", schema=["a"]).union(jb.scan("u", schema=["a"])).build(),
        jt).table
    _assert_same(want, got)
    assert got.to_pydict() == {"a": [0, 1, 2, 3, 4, 7, None, 9]}
    exchange = b.scan("t", schema=["a"]).exchange(["a"]).build()
    jexchange = jb.scan("t", schema=["a"]).exchange(["a"]).build()
    _assert_same(JPlanExecutor(mode="eager").execute(jexchange,
                                                     {"t": jt["t"]}).table,
                 PlanExecutor(device="cpu").execute(exchange,
                                                    {"t": t}).table)
    with pytest.raises(PlanValidationError, match="unbound"):
        PlanExecutor(device="cpu").execute(plan, {})
    with pytest.raises(PlanValidationError, match="does not match declared"):
        PlanExecutor(device="cpu").execute(
            b.scan("u", schema=["x"]).build(), {"u": t})
    with pytest.raises(PlanValidationError, match="not in"):
        b.scan("v", schema=["a"]).sort(["zz"]).build()
    capped = PlanExecutor(mode="capped", device="cpu").execute(
        union, {"t": t, "u": u})
    _assert_same(want, capped.compact())
    with pytest.raises(ValueError, match="unknown executor mode"):
        PlanExecutor(mode="jit", device="cpu")


def test_executor_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("asserts the behaviour where no CUDA device exists")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PlanExecutor()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PlanExecutor(device="cuda")


def test_port_imports_neither_jax_nor_the_reference():
    code = (
        "import sys\n"
        "from spark_rapids_tpu_torch import nds_q3\n"
        "from spark_rapids_tpu_torch.plan import PlanExecutor\n"
        "from spark_rapids_tpu_torch import api, parallel\n"
        "from spark_rapids_tpu_torch.ops import hash, hash_cuda\n"
        "from spark_rapids_tpu_torch.parallel import (partition,\n"
        "    partition_cuda, shuffle)\n"
        "from spark_rapids_tpu_torch.ops import (copying, select,\n"
        "    select_cuda, topk, topk_cuda)\n"
        "from spark_rapids_tpu_torch.plan import optimizer\n"
        "t = nds_q3.q3_tpcds_inputs(4096, device='cpu')\n"
        "r = PlanExecutor(device='cpu').execute(nds_q3.q3_tpcds_plan(), t)\n"
        "assert r.optimizer['rules_fired'] and r.table.num_rows > 0\n"
        "c = PlanExecutor(mode='capped', device='cpu').execute(\n"
        "    nds_q3.q3_tpcds_plan(), t)\n"
        "assert c.compact().num_rows == r.table.num_rows\n"
        "from spark_rapids_tpu_torch import nds_q5, nds_q23\n"
        "for q in (nds_q5, nds_q23):\n"
        "    make = getattr(q, q.__name__.split('_')[-1] + '_inputs')\n"
        "    plan = getattr(q, q.__name__.split('_')[-1] + '_plan')()\n"
        "    qi = make(4096, device='cpu')\n"
        "    e = PlanExecutor(device='cpu').execute(plan, qi)\n"
        "    k = PlanExecutor(mode='capped', device='cpu').execute(plan, qi)\n"
        "    assert k.compact().to_pydict() == e.table.to_pydict()\n"
        "inputs = nds_q3.q3_inputs(8192, device='cpu')\n"
        "res = PlanExecutor(device='cpu').execute(nds_q3.q3_plan(), inputs)\n"
        "assert res.table.num_rows > 0\n"
        "h = api.Hash.murmurHash32([inputs['sales']['item_sk']], 42)\n"
        "p = parallel.partition_ids(h.data, 8)\n"
        "assert int(parallel.partition_histogram(p, 8).sum()) == 8192\n"
        "assert api.Hash.xxhash64([inputs['sales']['item_sk']]).length\n"
        "from spark_rapids_tpu_torch.analysis import fuzz, verifier\n"
        "case = fuzz.gen_case(11, device='cpu')\n"
        "rc = fuzz.run_case(case, device='cpu')\n"
        "assert rc.ok and rc.executed and rc.parity, rc.error\n"
        "assert verifier.verify(case.plan).ok\n"
        "from spark_rapids_tpu_torch.analysis import footprint\n"
        "from spark_rapids_tpu_torch.plan import stats\n"
        "from spark_rapids_tpu_torch.utils import tracing\n"
        "assert footprint.certify(case.plan).root is not None\n"
        "with stats.scoped_store(stats.StatsStore(path='')) as st:\n"
        "    with tracing.range_ctx('x'):\n"
        "        PlanExecutor(mode='capped', device='cpu').execute(\n"
        "            nds_q3.q3_tpcds_plan(), t)\n"
        "assert st.generation == 1\n"
        "from spark_rapids_tpu_torch import version\n"
        "from spark_rapids_tpu_torch.columnar import Column\n"
        "from spark_rapids_tpu_torch import dtypes\n"
        "u = Column.from_pylist(['http://a.b/?q=1'], dtypes.STRING, 'cpu')\n"
        "assert api.ParseURI.parseURIQueryWithLiteral(u, 'q').to_pylist()\\\n"
        "    == ['1']\n"
        "j = Column.from_pylist(['{\"a\": 1}'], dtypes.STRING, 'cpu')\n"
        "assert api.MapUtils.extractRawMapFromJsonString(j).length == 1\n"
        "bf = api.BloomFilter.create(3, 128, device='cpu')\n"
        "v = Column.from_pylist([5], dtypes.INT64, 'cpu')\n"
        "assert api.BloomFilter.probe(api.BloomFilter.put(bf, v), v).data[0]\n"
        "assert version.version_info()['version']\n"
        "from spark_rapids_tpu_torch import io as pio\n"
        "from spark_rapids_tpu_torch.plan import PlanBuilder, col\n"
        "fx = 'tests/data/torch_parquet/snappy_dict_strings.parquet'\n"
        "assert pio.read_parquet(fx, device='cpu').num_rows == 300\n"
        "assert pio.read_footer_stats(fx)[0].num_rows == 128\n"
        "sp = (PlanBuilder().scan('f', parquet=fx).filter(col('k') > 2)\n"
        "      .aggregate(['k'], [('k', 'count', 'c')]).build())\n"
        "assert PlanExecutor(device='cpu').execute(sp).table.num_rows == 4\n"
        "from spark_rapids_tpu_torch.parallel import (autoretry, keys,\n"
        "    relational)\n"
        "from spark_rapids_tpu_torch.plan import distributed, transport\n"
        "from spark_rapids_tpu_torch.entry import dryrun_multichip\n"
        "dryrun_multichip(2, device='cpu')\n"
        "m = parallel.make_mesh(2, devices=['cpu'] * 2)\n"
        "d = PlanExecutor(device='cpu', mesh=m).execute(\n"
        "    nds_q3.q3_tpcds_plan(), t)\n"
        "assert d.table.to_pydict() == r.table.to_pydict()\n"
        "assert any(mm.n_peers == 2 for mm in d.metrics.values())\n"
        "bad = sorted(m for m in sys.modules if m == 'jax'\n"
        "             or m.startswith(('jax.', 'jaxlib'))\n"
        "             or m.split('.')[0] == 'spark_rapids_tpu')\n"
        "print('BAD', bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items()
           if k not in ("SPARK_RAPIDS_TORCH_KERNELS",)}
    env["PYTHONPATH"] = _REPO
    env["SPARK_RAPIDS_TORCH_VERIFY_PLANS"] = "1"      # the gate on
    out = subprocess.run([sys.executable, "-c", code], cwd=_REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "BAD []" in out.stdout


def _tpcds_reference(n_sales, limit=100):
    """TPC-DS q3 in the JAX package, optimizer on, eager, over the port's
    own INT32 inputs (`limit=None`: every group, sorted)."""
    inputs = nds_q3.q3_tpcds_inputs(n_sales, seed=0, device="cpu")
    jinputs = {}
    for name, t in inputs.items():
        jinputs[name] = JTable([JColumn.from_numpy(c.data.numpy())
                                for c in t.columns], names=list(t.names))
    b = JPlanBuilder()
    sales = b.scan("sales", schema=["sold_date_sk", "item_sk", "price_cents"])
    dates = (b.scan("dates", schema=["d_date_sk", "d_year", "d_moy"])
             .filter(jcol("d_moy") == 11))
    items = (b.scan("items", schema=["i_item_sk", "i_brand", "i_manufact"])
             .filter(jcol("i_manufact") == 42))
    j = (sales.join(dates, left_on="sold_date_sk", right_on="d_date_sk")
              .join(items, left_on="item_sk", right_on="i_item_sk"))
    plan = (j.aggregate(["d_year", "i_brand"],
                        [("price_cents", "sum", "revenue")])
             .sort(["d_year", "revenue", "i_brand"],
                   ascending=[True, False, True]))
    plan = (plan if limit is None else plan.limit(limit)).build()
    from spark_rapids_tpu.plan import stats
    with stats.scoped_store(None):
        res = JPlanExecutor(mode="eager", optimize=True).execute(plan,
                                                                 jinputs)
    return res, inputs


def test_tpcds_q3_matches_jax_optimized_eager():
    ref, inputs = _tpcds_reference(20_000)
    assert [c.dtype.kind.value for c in inputs["sales"].columns] == \
        ["int32", "int32", "int64"]
    res = PlanExecutor(device="cpu").execute(nds_q3.q3_tpcds_plan(), inputs)
    _assert_same(ref.table, res.table)
    assert 0 < res.table.num_rows <= 100
    assert res.optimizer["rules_fired"] == ref.optimizer["rules_fired"] == {
        "limit_pushdown": 1, "column_pruning": 4, "select_fusion": 2}
    assert res.optimizer["fingerprint"] == ref.optimizer["fingerprint"]
    strip = lambda s: re.sub(r"#\d+", "", s)            # noqa: E731
    assert strip(res.plan.explain()) == strip(ref.plan.explain())
    stamps = sorted(m.kernel for m in res.metrics.values() if m.kernel)
    assert stamps == ["torch:fused_select"] * 2 + ["torch:groupby"] + \
        ["torch:hash_join"] * 2 + ["torch:topk"]
    # the authored plan, unoptimized, gives the same rows
    off = PlanExecutor(device="cpu", optimize=False).execute(
        nds_q3.q3_tpcds_plan(), inputs)
    _assert_same(ref.table, off.table)


def test_tpcds_q3_every_group_matches_jax():
    # without its LIMIT the plan keeps a Sort, and every group of every
    # year comes out: what chip_smoke.py holds against numpy on the card
    ref, inputs = _tpcds_reference(20_000, limit=None)
    res = PlanExecutor(device="cpu").execute(
        nds_q3.q3_tpcds_plan(limit=None), inputs)
    _assert_same(ref.table, res.table)
    assert len(set(res.table["d_year"].data.tolist())) > 1
    assert res.optimizer["rules_fired"] == ref.optimizer["rules_fired"]
    assert res.optimizer["fingerprint"] == ref.optimizer["fingerprint"]
    assert [m.kind for m in res.metrics.values()].count("FusedSelect") == 2


# ---- TPC-DS q3 with its STRING i_brand ---------------------------------------

def _jax_table(t):
    """The JAX package's table of the port's CPU table, buffer for buffer."""
    from spark_rapids_tpu import dtypes as jdt
    import jax.numpy as jnp
    cols = []
    for c in t.columns:
        jd = (jdt.STRING if c.dtype.is_string else
              jdt.DType(jdt.Kind(c.dtype.kind.value), c.dtype.precision,
                        c.dtype.scale))
        cols.append(JColumn(
            dtype=jd, length=c.length, data=jnp.asarray(c.data.numpy()),
            validity=(None if c.validity is None
                      else jnp.asarray(c.validity.numpy())),
            offsets=(None if c.offsets is None
                     else jnp.asarray(c.offsets.numpy()))))
    return JTable(cols, names=list(t.names))


def _assert_same_strings(jt: JTable, tt):
    """_assert_same, a STRING column's offsets included."""
    _assert_same(jt, tt)
    for jc, tc in zip(jt.columns, tt.columns):
        if tc.offsets is not None:
            npt.assert_array_equal(np.asarray(jc.offsets),
                                   tc.offsets.numpy())


@pytest.mark.parametrize("optimize", [False, True])
@pytest.mark.parametrize("limit", [100, None])
def test_tpcds_q3_strings_matches_jax(optimize, limit):
    """TPC-DS q3 as TPC-DS types it (`i_brand` a STRING, `i_brand_id`
    INT32), authored and optimized, against the JAX package's eager
    executor on the same tables, bit for bit."""
    inputs = nds_q3.q3_tpcds_strings_inputs(20_000, seed=0, device="cpu")
    items = inputs["items"]
    assert [c.dtype.kind.value for c in items.columns] == \
        ["int32", "int32", "string", "int32"]
    assert items["i_brand"].to_pylist()[:2] == [
        nds_q3.brand_name(b) for b in items["i_brand_id"].data[:2].tolist()]
    lens = items["i_brand"].string_lengths()
    assert 10 <= int(lens.min()) and int(lens.max()) <= 22
    from spark_rapids_tpu.plan import stats
    jplan = nds_q3.q3_tpcds_strings_plan(limit, JPlanBuilder, jcol)
    with stats.scoped_store(None):
        ref = JPlanExecutor(mode="eager", optimize=optimize).execute(
            jplan, {k: _jax_table(t) for k, t in inputs.items()})
    res = PlanExecutor(device="cpu", optimize=optimize).execute(
        nds_q3.q3_tpcds_strings_plan(limit), inputs)
    _assert_same_strings(ref.table, res.table)
    assert res.table.names == ("d_year", "i_brand", "i_brand_id", "revenue")
    assert 0 < res.table.num_rows and (limit is None
                                       or res.table.num_rows <= limit)
    if optimize:
        assert res.optimizer["fingerprint"] == ref.optimizer["fingerprint"]
        stamps = sorted(m.kernel for m in res.metrics.values() if m.kernel)
        assert stamps.count("torch:fused_select") == 2
    # the INT32 variant groups the same rows: the brand ids agree
    ints = PlanExecutor(device="cpu", optimize=optimize).execute(
        nds_q3.q3_tpcds_plan(limit),
        nds_q3.q3_tpcds_inputs(20_000, seed=0, device="cpu")).table
    npt.assert_array_equal(ints["i_brand"].data.numpy(),
                           res.table["i_brand_id"].data.numpy())


def test_tpcds_q3_strings_capped_raises_naming_the_limit():
    inputs = nds_q3.q3_tpcds_strings_inputs(4096, seed=0, device="cpu")
    for optimize in (False, True):
        with pytest.raises(TypeError, match="max_string_length"):
            PlanExecutor(mode="capped", device="cpu",
                         optimize=optimize).execute(
                nds_q3.q3_tpcds_strings_plan(), inputs)
