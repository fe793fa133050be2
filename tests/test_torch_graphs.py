"""The capped tier's CUDA graphs (`plan/executor.py`, `_run_program`): a
program launches from Python at its first run, is captured at its second
and replayed after, over static inputs that each run fills.

On the CPU, which has no graphs, a stand-in capture (`_FakeGraph`: its
replay reruns the attempt over the static inputs and copies the results
into the captured outputs, as a replay writes into fixed buffers) checks
the executor's side: one executor captures on seed 0's tables and then
runs seed 1's tables of the same shape, and every run equals a new
executor's run of the same tables at the same caps, bit for bit; a
capture that fails leaves the program running its kernels from Python
with `graph` False and the reason. The `cuda` tests do the same with
real graphs on the card, and skip without one. Plans: NDS q5 and q23 and
capped fuzz corpus seeds, plain and edge tables. Tolerance: exact."""
import torch_threads  # noqa: F401  (one torch thread a worker)
import contextlib

import numpy as np
import pytest
import torch

from spark_rapids_tpu_torch import nds_q23, nds_q5
from spark_rapids_tpu_torch.analysis import fuzz
from spark_rapids_tpu_torch.columnar import Column, Table
from spark_rapids_tpu_torch.plan import PlanExecutor
from spark_rapids_tpu_torch.plan import executor as ex_mod
from spark_rapids_tpu_torch.plan import stats as torch_stats


@pytest.fixture(autouse=True, scope="module")
def _no_torch_stats_store():
    """No stats store: the caps and programs depend on the runs here
    only, not on the file order."""
    with torch_stats.scoped_store(None):
        yield


_N = 2000
_NDS = {"q5": (nds_q5.q5_plan, nds_q5.q5_inputs),
        "q23": (nds_q23.q23_plan, nds_q23.q23_inputs)}
# capped corpus cases that run: joins, keyed aggregates, TopK, unions
_FUZZ_SEEDS = (0, 4, 6, 8, 17, 18)


def _redraw(tables, seed):
    """Tables of the same shape and layout with other rows: each column's
    values drawn again from its own values, a validity drawn again where
    the column has one."""
    rng = np.random.default_rng(seed)
    out = {}
    for name in sorted(tables):
        t = tables[name]
        cols = []
        for c in t.columns:
            data = c.data.cpu().numpy()
            valid = None
            if c.validity is not None:
                valid = rng.random(c.length) >= 0.15
            cols.append(Column.from_numpy(rng.choice(data, c.length),
                                          c.dtype, valid, c.data.device))
        out[name] = Table(cols, names=list(t.names))
    return out


def _same(got: Table, want: Table):
    assert got.names == want.names
    for a, b in zip(got.columns, want.columns):
        assert a.dtype == b.dtype
        assert torch.equal(a.data.cpu().view(torch.uint8)
                           if a.data.dtype.is_floating_point
                           else a.data.cpu(),
                           b.data.cpu().view(torch.uint8)
                           if b.data.dtype.is_floating_point
                           else b.data.cpu())
        assert (a.validity is None) == (b.validity is None)
        if a.validity is not None:
            assert torch.equal(a.validity.cpu(), b.validity.cpu())


def _cases():
    out = [pytest.param("nds", q, False, id=q) for q in _NDS]
    for seed in _FUZZ_SEEDS:
        for edge in (False, True):
            out.append(pytest.param("fuzz", seed, edge,
                                    id=f"fuzz{seed}{'-edge' if edge else ''}"))
    return out


def _case(kind, which, edge, device):
    """(plan, seed 0's tables, optimize)."""
    if kind == "nds":
        plan_fn, inputs = _NDS[which]
        return plan_fn(), inputs(_N, seed=0, device=device), True
    case = fuzz.gen_case(which, device="cpu")
    tabs = (fuzz.edge_tables(case, device="cpu") if edge
            else dict(case.tables))
    return case.plan, {k: t.to(device) for k, t in tabs.items()}, \
        bool(which % 2)


def _new_data_runs(plan, tables, optimize, device):
    """One executor: seed 0's tables three times (launched, captured,
    replayed), then two redraws of the same shape; each run held against
    a new executor's run of its tables at its final caps. Returns the
    results of the reused executor."""
    ex = PlanExecutor(mode="capped", optimize=optimize, device=device)
    runs = [tables, tables, tables, _redraw(tables, 1), _redraw(tables, 2)]
    results = []
    for tabs in runs:
        res = ex.execute(plan, tabs)
        want = PlanExecutor(mode="capped", optimize=optimize, device=device,
                            caps=dict(res.caps)).execute(plan, tabs)
        assert not want.graph
        _same(res.compact(), want.compact())
        results.append(res)
    return results


class _FakeGraph:
    """A capture's stand-in on the CPU: `replay` reruns the attempt over
    the static inputs and writes its results into the captured outputs."""

    def __init__(self, run, out):
        self.run, self.out = run, out

    def replay(self):
        new = self.run()
        for dst, src in zip(_flat(self.out), _flat(new)):
            dst.copy_(src)


def _flat(out):
    table, alive, counts, overflow = out
    bufs = []
    for c in table.columns:
        bufs.append(c.data)
        if c.validity is not None:
            bufs.append(c.validity)
    return bufs + [alive, counts, overflow]


def _fake_capture(self, plan, schemas, caps, inputs, prog):
    static_in = {n: ex_mod._clone_table(t) for n, t in inputs.items()}
    out = self._run_capped(plan, schemas, caps, static_in, prog)
    prog.graph = _FakeGraph(
        lambda: self._run_capped(plan, schemas, caps, static_in, prog), out)
    prog.static_in, prog.static_out = static_in, out


@pytest.fixture
def cpu_graphs(monkeypatch):
    """The CPU executor with graphs: no obstacle, no sync check (the CPU
    has no sync debug mode), the stand-in capture."""
    monkeypatch.setattr(PlanExecutor, "_graph_obstacle",
                        lambda self, plan, inputs: "")
    monkeypatch.setattr(ex_mod, "_sync_is_error", contextlib.nullcontext)
    monkeypatch.setattr(PlanExecutor, "_capture", _fake_capture)


@pytest.mark.parametrize("kind,which,edge", _cases())
def test_replay_on_new_tables_equals_a_new_executor(cpu_graphs, kind,
                                                    which, edge):
    """A captured program replays over other tables of the same shape:
    the static inputs are filled, every buffer of them, and the outputs
    cloned out, so each run equals a new executor's."""
    plan, tables, optimize = _case(kind, which, edge, "cpu")
    results = _new_data_runs(plan, tables, optimize, "cpu")
    assert [r.graph for r in results[:3]] == [False, True, True]
    # a redraw that fits the captured caps replays the same program
    for r in results[3:]:
        assert r.graph == (r.attempts == 1 and r.caps == results[2].caps)
    assert not any(r.graph_reason for r in results if r.graph)


def test_cpu_programs_say_why_they_are_not_captured():
    plan, tables, _ = _case("nds", "q23", False, "cpu")
    ex = PlanExecutor(mode="capped", device="cpu")
    for _ in range(3):
        res = ex.execute(plan, tables)
        assert not res.graph
        assert res.graph_reason == "the CPU has no CUDA graphs"


def test_failed_capture_launches_from_python_and_says_why(monkeypatch):
    """A capture that raises is not retried: that run and every later one
    launch the kernels from Python, equal to a new executor's run, with
    `graph` False and the error as the reason."""
    monkeypatch.setattr(PlanExecutor, "_graph_obstacle",
                        lambda self, plan, inputs: "")
    monkeypatch.setattr(ex_mod, "_sync_is_error", contextlib.nullcontext)
    calls = []

    def failing(self, *args):
        calls.append(1)
        raise RuntimeError("operation not permitted when stream is "
                           "capturing")
    monkeypatch.setattr(PlanExecutor, "_capture", failing)
    plan, tables, _ = _case("nds", "q5", False, "cpu")
    ex = PlanExecutor(mode="capped", device="cpu")
    want = PlanExecutor(mode="capped", device="cpu").execute(plan, tables)
    for i in range(4):
        res = ex.execute(plan, tables)
        _same(res.compact(), want.compact())
        assert not res.graph
        if i == 0:
            assert "first run" in res.graph_reason
        else:
            assert res.graph_reason.startswith(
                "its capture failed: RuntimeError: operation not permitted")
    assert calls == [1]


# ---- on the card ----------------------------------------------------------

def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs capture only there")


@pytest.mark.cuda
@pytest.mark.parametrize("kind,which,edge", _cases())
def test_card_replay_on_new_tables_equals_a_launched_run(kind, which, edge):
    """Real graphs: captured on seed 0's tables, replayed on redraws of
    the same shape, each run equal to a new executor's launched run; a
    replay launches nothing from Python."""
    _need_card()
    plan, tables, optimize = _case(kind, which, edge, "cuda")
    before = dict(ex_mod.GRAPH_COUNTS)
    results = _new_data_runs(plan, tables, optimize, "cuda")
    assert [r.graph for r in results[:3]] == [False, True, True], \
        [r.graph_reason for r in results]
    replays = sum(r.graph for r in results)
    assert ex_mod.GRAPH_COUNTS["replays"] - before["replays"] == replays
    for r in results[3:]:
        assert r.graph == (r.attempts == 1 and r.caps == results[2].caps)


@pytest.mark.cuda
def test_card_failed_capture_launches_from_python(monkeypatch):
    """A host read inside the capture fails it on the card: the program
    then launches from Python, equal to a new executor's run, and says
    why."""
    _need_card()
    real = PlanExecutor._run_capped

    def reading(self, plan, schemas, caps, inputs, prog):
        out = real(self, plan, schemas, caps, inputs, prog)
        if torch.cuda.is_current_stream_capturing():
            out[3].item()              # a host read: not capturable
        return out
    monkeypatch.setattr(PlanExecutor, "_run_capped", reading)
    plan, tables, _ = _case("nds", "q23", False, "cuda")
    ex = PlanExecutor(mode="capped")
    want = PlanExecutor(mode="capped").execute(plan, tables)
    for i in range(3):
        res = ex.execute(plan, tables)
        _same(res.compact(), want.compact())
        assert not res.graph
        if i:
            assert res.graph_reason.startswith("its capture failed: ")
