"""NDS q3 through the port's eager plan engine against the JAX package's
`PlanExecutor(mode="eager", optimize=False)` on the same tables, bit for
bit; plus the port's datagen and plan DAG against the reference bench's,
and the eager node kinds q3 does not reach."""
import os
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
    res = PlanExecutor(device="cpu").execute(
        nds_q3.q3_plan(), {k: _port(t) for k, t in jinputs.items()})
    _assert_same(ref, res.table)
    assert ref.num_rows > 0
    stamps = [m.kernel for m in res.metrics.values() if m.kind == "HashJoin"]
    if force:
        # the forced CUDA kernels run their plain versions on CPU tensors
        assert stamps == ["cuda:hash_join"] * 2
        assert join_cuda.PLAIN_CALLS == {"build": 2, "count": 2, "emit": 2}
    else:
        assert stamps == ["torch:hash_join"] * 2
        assert join_cuda.PLAIN_CALLS == {"build": 0, "count": 0, "emit": 0}
    assert join_cuda.LAUNCHES == {"build": 0, "count": 0, "emit": 0}
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
    b = PlanBuilder()
    plan = b.scan("t", schema=["a"]).sort(["a"]).limit(3).build()
    t = table_from_numpy(["a"], [np.arange(5, dtype=np.int64)], [None],
                         ["int64"], device="cpu")
    with pytest.raises(PlanValidationError, match="queue A item 3"):
        PlanExecutor(device="cpu").execute(plan, {"t": t})
    with pytest.raises(PlanValidationError, match="unbound"):
        PlanExecutor(device="cpu").execute(plan, {})
    with pytest.raises(PlanValidationError, match="does not match declared"):
        PlanExecutor(device="cpu").execute(
            b.scan("u", schema=["x"]).build(), {"u": t})
    with pytest.raises(PlanValidationError, match="not in"):
        b.scan("v", schema=["a"]).sort(["zz"]).build()
    with pytest.raises(ValueError, match="queue A item 7"):
        PlanExecutor(mode="capped", device="cpu")


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
        "inputs = nds_q3.q3_inputs(8192, device='cpu')\n"
        "res = PlanExecutor(device='cpu').execute(nds_q3.q3_plan(), inputs)\n"
        "assert res.table.num_rows > 0\n"
        "h = api.Hash.murmurHash32([inputs['sales']['item_sk']], 42)\n"
        "p = parallel.partition_ids(h.data, 8)\n"
        "assert int(parallel.partition_histogram(p, 8).sum()) == 8192\n"
        "assert api.Hash.xxhash64([inputs['sales']['item_sk']]).length\n"
        "bad = sorted(m for m in sys.modules if m == 'jax'\n"
        "             or m.startswith(('jax.', 'jaxlib'))\n"
        "             or m.split('.')[0] == 'spark_rapids_tpu')\n"
        "print('BAD', bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items()
           if k not in ("SPARK_RAPIDS_TORCH_KERNELS",)}
    env["PYTHONPATH"] = _REPO
    out = subprocess.run([sys.executable, "-c", code], cwd=_REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "BAD []" in out.stdout
