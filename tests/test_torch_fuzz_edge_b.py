"""The fuzz corpus through both packages' `PlanExecutor`s on the CPU,
edge pass, seeds 12-23: each case's tables redrawn by
`fuzz.edge_tables` (±0.0, NaN, ±inf and 2^53 + 2 in about 40% of the
floats; INT64 min and max, 2^53 + 1, ±2^31 and -1 in about 20% of the
ints; about 15% nulls in every column), the same bytes handed to both
packages. Each case runs eager and capped, authored
and optimized; the port's `compact()` equals the JAX package's bit for
bit (names, dtypes, data bytes with NaN bits and the sign of zero,
validity), and an error raises with the same class name. In the capped
tier a JAX capped run that differs from the JAX eager one (XLA's literal
rewrites under jit, queue C) is held to the JAX eager run instead. The
port's verifier gate is on, as the reference's is under tests/conftest.py.
The corpus is split over files so that the test run spreads it."""
import torch_threads  # noqa: F401  (one torch thread a worker)
import pytest

from test_torch_fuzz_gen import check_parity
from spark_rapids_tpu_torch.plan import stats as torch_stats


@pytest.fixture(autouse=True, scope="module")
def _no_torch_stats_store():
    """No stats store for the port's runs: the static engine, as the
    reference's runs are with its store off (a shared store would make
    attempts, caps and optimizer decisions depend on the file order)."""
    with torch_stats.scoped_store(None):
        yield


@pytest.fixture(autouse=True)
def _gate_on(monkeypatch):
    monkeypatch.setenv("SPARK_RAPIDS_TORCH_VERIFY_PLANS", "1")


@pytest.mark.parametrize("optimize", [False, True])
@pytest.mark.parametrize("mode", ["eager", "capped"])
@pytest.mark.parametrize("seed", range(12, 24))
def test_corpus_matches_jax(seed, mode, optimize):
    check_parity(seed, True, mode, optimize)
