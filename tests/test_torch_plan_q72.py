"""NDS q72 through the port's eager plan engine against the JAX package's
`PlanExecutor(mode="eager")` on the same tables, unoptimized and
optimized, bit for bit and row order included; plus the port's datagen
and plan DAG against the reference bench's.

q72's inventory join has 52,000 build rows on the unoptimized plan (the
hash join's large route: C = 131,072 slots); with the CUDA kernels forced,
the CPU runs their plain versions, the large route's layout included. The
tolerance is exact: every column is INT64."""
import torch_threads  # noqa: F401  (one torch thread a worker)
import os
import subprocess
import sys

import numpy as np
import numpy.testing as npt
import pytest

import spark_rapids_tpu  # noqa: F401
from spark_rapids_tpu.plan import PlanExecutor as JPlanExecutor

from benchmarks import bench_nds_q72, nds_plans

from spark_rapids_tpu_torch import nds_q72
from spark_rapids_tpu_torch.ops import join_cuda
from spark_rapids_tpu_torch.plan import PlanExecutor
from spark_rapids_tpu_torch.plan import stats as torch_stats


@pytest.fixture(autouse=True, scope="module")
def _no_torch_stats_store():
    """No stats store for the port's runs: the static engine, as the
    reference's runs are with its store off (a shared store would make
    attempts, caps and optimizer decisions depend on the file order)."""
    with torch_stats.scoped_store(None):
        yield

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_N_SALES = 3000
_REF = {}


def _reference(optimize):
    """The JAX executor's q72 table at _N_SALES rows (computed once)."""
    if optimize not in _REF:
        tables = dict(zip(nds_q72.TABLES,
                          bench_nds_q72.build_tables(_N_SALES, seed=0)))
        res = JPlanExecutor(mode="eager", optimize=optimize).execute(
            nds_plans.q72_plan(), tables)
        _REF[optimize] = res.table
    return _REF[optimize]


def _assert_same(jt, tt):
    assert list(jt.names) == list(tt.names)
    assert jt.num_rows == tt.num_rows
    for jc, tc in zip(jt.columns, tt.columns):
        assert jc.dtype.kind.value == tc.dtype.kind.value
        data, valid = tc.to_numpy()
        npt.assert_array_equal(np.asarray(jc.data), data)
        assert jc.validity is None or np.asarray(jc.validity).all()
        assert valid is None or valid.all()


@pytest.mark.parametrize("force", [False, True])
@pytest.mark.parametrize("optimize", [False, True])
def test_q72_matches_jax_eager(monkeypatch, optimize, force):
    ref = _reference(optimize)
    if force:
        monkeypatch.setenv("SPARK_RAPIDS_TORCH_KERNELS",
                           "hash_join=cuda,fused_select=cuda")
    join_cuda.reset_counters()
    res = PlanExecutor(device="cpu", optimize=optimize).execute(
        nds_q72.q72_plan(), nds_q72.q72_inputs(_N_SALES, device="cpu"))
    _assert_same(ref, res.table)
    assert ref.num_rows > 0
    joins = [m for m in res.metrics.values() if m.kind == "HashJoin"]
    assert len(joins) == 5
    want = "cuda:hash_join" if force else "torch:hash_join"
    assert [m.kernel for m in joins] == [want] * 5
    assert join_cuda.PLAIN_CALLS["build"] == (5 if force else 0)
    assert join_cuda.LAUNCHES == {"build": 0, "count": 0,
                                  "emit": 0, "exists": 0, "capped": 0}
    inv = [n for n in res.plan.nodes if n.kind == "HashJoin"
           and len(n.left_keys) == 2]
    assert len(inv) == 1
    # unoptimized, inventory (52,000 rows) is the build side; the optimizer
    # swaps the sides at this scale, as the reference's does
    sides = (inv[0].left_keys, inv[0].right_keys)
    inv_keys = ("inv_item_sk", "inv_week")
    assert sides[1 - int(optimize)] == inv_keys


def test_large_route_runs_on_the_unoptimized_plan(monkeypatch):
    """The unoptimized plan's inventory join builds 52,000 rows: with the
    kernels forced, its plain build takes the large route's capacity."""
    monkeypatch.setenv("SPARK_RAPIDS_TORCH_KERNELS", "hash_join=cuda")
    built = []
    build = join_cuda.build_table

    def spy(bcols, C):
        built.append((bcols[0].length, C))
        return build(bcols, C)
    monkeypatch.setattr(join_cuda, "build_table", spy)
    PlanExecutor(device="cpu", optimize=False).execute(
        nds_q72.q72_plan(), nds_q72.q72_inputs(_N_SALES, device="cpu"))
    assert (52_000, 131_072) in built
    assert join_cuda.is_large(131_072)
    assert all(not join_cuda.is_large(C) for n, C in built if n != 52_000)


def test_datagen_matches_reference():
    for seed in (0, 3):
        ours = nds_q72.datagen(2000, seed=seed)
        theirs = bench_nds_q72._datagen(2000, seed=seed)
        for a, b in zip(ours, theirs):
            assert list(a) == list(b)
            for k in a:
                npt.assert_array_equal(a[k], b[k])
                assert a[k].dtype == b[k].dtype


def _shape(plan):
    return [(n.kind, n.describe(), plan.schemas.get(id(n)),
             [plan.nodes.index(c) for c in n.children]) for n in plan.nodes]


def test_q72_plan_has_the_reference_dag():
    assert _shape(nds_q72.q72_plan()) == _shape(nds_plans.q72_plan())


def test_q72_runs_without_jax():
    code = (
        "import sys\n"
        "from spark_rapids_tpu_torch import nds_q72\n"
        "from spark_rapids_tpu_torch.plan import PlanExecutor\n"
        "t = nds_q72.q72_inputs(2000, device='cpu')\n"
        "r = PlanExecutor(device='cpu').execute(nds_q72.q72_plan(), t)\n"
        "assert r.table.num_rows > 0\n"
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
