"""Per-fingerprint operator-stats store: the plan engine's feedback loop.

Counterpart of `spark_rapids_tpu/plan/stats.py` for the tables the port's
consumers read. Every successful execution records what it observed, keyed
by the backend it ran on first ("cuda" or "cpu"), and three consumers read
it back on the next execution of the same plan:

1. the optimizer (`plan/optimizer.py`): `_Estimator` takes an interior
   node's observed output rows before the static selectivity guesses, and
   every build-side decision names its source on `OptimizeReport`;
2. the executor (`plan/executor.py`): the capped tier floors its starting
   caps at the observed high-water caps, so a repeat plan runs in one
   attempt, across executors and (with SPARK_RAPIDS_TORCH_STATS_PATH)
   across processes;
3. the kernel registry (`ops/registry.py`): a kernel that has timed slower
   than its fallback past the hysteresis margin on one (op, backend,
   signature) loses the pick, `stats_demoted` stamped on the choice. On
   "cuda" the plain version is not a route, so no CUDA kernel is ever
   demoted; the logic runs on the CPU backend.

Adaptivity changes how a plan runs, never what it returns: a build-side
swap passes `verify_rewrite`, a cap is a starting capacity the overflow
ladder would have reached, and the fuzzer's property 4 runs every plan
twice under a fresh store and compares the bits.

A run on the CPU never seeds a run on the card: every table keys on the
backend first, and the executor passes the backend the result ran on.

Tables (the reference's placement table `walls`, its serving layer's
peak bytes and its fleet gossip, the `io` table's part in it included,
wait for ROADMAP queue A item 14):

- plans:    (backend, source fingerprint) -> {executed_fp, runs, caps
            {cap key: high-water}, ops {toposort index: row}}
- subtrees: (backend, subtree fingerprint) -> {rows (high-water), runs}
- kernels:  (backend, op, signature repr) -> {kernel name: {ms_per_krow
            (EWMA), runs}}
- io:       (backend, scan subtree fingerprint) -> {rows_per_ms (EWMA),
            runs}: a streaming scan's host decode throughput, from which
            `suggest_chunk_rows` sizes the chunks of a scan with no
            explicit bound (about `_TARGET_CHUNK_MS` of decode a chunk)

`generation` grows with every record; `rows_generation` only when what
`observed_rows` answers changes (a subtree's high-water rows grow, or a
subtree is first seen or evicted), and the executor's rewrite cache keys
on it, since the optimizer's rewrites read nothing else of the store (a
cached rewrite's "observed:<runs>" source gives the runs when it was
made); `kernel_epoch` grows only when a recorded timing flips a demotion
verdict (the capped program cache keys on it); `hits` counts consults that
found something.

Knobs (config.py): SPARK_RAPIDS_TORCH_STATS (on/off),
SPARK_RAPIDS_TORCH_STATS_CAPACITY, SPARK_RAPIDS_TORCH_STATS_PATH. Tests
install a store with `scoped_store(...)`, which outranks the knobs.
"""
from __future__ import annotations

import contextlib
import itertools
import json
import threading
from typing import Dict, Optional, Tuple

from ..utils.lru import LruDict

__all__ = ["StatsStore", "active_store", "default_store",
           "reset_default_store", "scoped_store"]

# a kernel must time this much slower than its fallback (per row) before it
# loses the pick: noise must not flap the choice, and with it the capped
# program cache
_DEMOTE_MARGIN = 1.25
_EWMA_ALPHA = 0.5
# adaptive chunk sizing: host decode time a streaming chunk aims at, and
# the fewest rows a suggested chunk has
_TARGET_CHUNK_MS = 25.0
_MIN_CHUNK_ROWS = 4096


def _ewma(old: Optional[float], new: float) -> float:
    return new if old is None else (1 - _EWMA_ALPHA) * old + _EWMA_ALPHA * new


class StatsStore:
    """Bounded feedback store, every table keyed by backend first (module
    docstring). `capacity` and `path` default from the knobs; `path=""`
    keeps a store in memory whatever SPARK_RAPIDS_TORCH_STATS_PATH says,
    as every fresh isolated store (the fuzzer's, the tests') must."""

    _uids = itertools.count()

    def __init__(self, capacity: Optional[int] = None,
                 path: Optional[str] = None):
        from .. import config
        # process-unique identity for the executor's cache keys (an id()
        # can be reused after a store is collected)
        self.uid = next(StatsStore._uids)
        self.capacity = (config.stats_capacity() if capacity is None
                         else max(1, int(capacity)))
        self.path = (config.stats_path() or None) if path is None else \
            (path or None)
        self._plans: Dict[Tuple, Dict] = LruDict(self.capacity)
        self._subtrees: Dict[Tuple, Dict] = LruDict(
            self.capacity * 16, on_evict=self._subtree_evicted)
        self._kernels: Dict[Tuple, Dict] = LruDict(self.capacity * 16)
        self._io: Dict[Tuple, Dict] = LruDict(self.capacity * 4)
        self._fps: Dict[int, Tuple] = LruDict(self.capacity)
        self.generation = 0
        self.rows_generation = 0
        self.kernel_epoch = 0
        self.hits = 0
        self._lock = threading.RLock()
        self._io_lock = threading.Lock()     # one JSONL line at a time
        if self.path:
            self._load(self.path)

    # ---- recording ---------------------------------------------------------

    def record_result(self, plan, result, *, backend: str,
                      source_fp: Optional[str] = None) -> None:
        """Record one successful execution. `plan` is the executed plan
        (the metric labels are its nodes'); `source_fp` the authored
        plan's fingerprint, under which the plan entry files, so that a
        stats-driven rewrite keeps the entry of its authored plan;
        `backend` the backend the result ran on: the executor passes
        "cpu" for a degraded result, so a salvage run never seeds the
        card."""
        source_fp = source_fp or plan.fingerprint
        sub = self._subtree_fps(plan.root)
        event = {"backend": backend, "source_fp": source_fp,
                 "executed_fp": plan.fingerprint, "caps": {}, "ops": {},
                 "subtrees": {}, "io": {}, "kernels": []}
        with self._lock:
            key = (backend, source_fp)
            ps = self._plans.get(key) or {
                "executed_fp": plan.fingerprint, "runs": 0, "caps": {},
                "ops": {}}
            ps["runs"] += 1
            ps["executed_fp"] = plan.fingerprint
            degraded = getattr(result, "degraded", False)
            if result.caps and result.mode == "capped" and not degraded:
                # the final (possibly escalated) caps: high-water. A
                # degraded result's caps are those of the failed device
                # attempts, not a completed sizing
                for k, v in result.caps.items():
                    ps["caps"][k] = max(int(ps["caps"].get(k, 0)), int(v))
                event["caps"] = dict(ps["caps"])
            for i, node in enumerate(plan.nodes):
                m = result.metrics.get(node.label)
                if m is None:
                    continue
                ps["ops"][i] = event["ops"][i] = {
                    "rows_out": int(m.rows_out),
                    "bytes_out": int(m.bytes_out),
                    "wall_ms": m.wall_ms, "kernel": m.kernel}
                sfp = sub[id(node)]
                e = self._observe_locked(backend, sfp, int(m.rows_out))
                event["subtrees"][sfp] = e["rows"]
                ksig = getattr(m, "_kernel_sig", None)
                if degraded and not m.degraded:
                    # ran on the card before the breaker tripped: its rows
                    # count on any backend, its timing is the card's
                    continue
                if m.io_decode_ms > 0 and m.rows_out > 0:
                    ioe = self._io_locked(backend, sfp,
                                          m.rows_out / m.io_decode_ms)
                    event["io"][sfp] = ioe["rows_per_ms"]
                if ksig is not None and m.kernel and m.wall_ms:
                    op, sig = ksig
                    name = m.kernel.split(":", 1)[0]
                    per_krow = m.wall_ms / max(int(m.rows_in), 1) * 1e3
                    self._record_kernel_locked(backend, op, sig, name,
                                               per_krow)
                    event["kernels"].append(
                        [op, self._sig_key(sig), name, per_krow])
            self._plans[key] = ps
            self.generation += 1
        if self.path:
            self._append(event)

    def _io_locked(self, backend: str, sfp: str, rows_per_ms: float) -> Dict:
        e = self._io.get((backend, sfp)) or {"rows_per_ms": None, "runs": 0}
        e["rows_per_ms"] = _ewma(e["rows_per_ms"], float(rows_per_ms))
        e["runs"] += 1
        self._io[(backend, sfp)] = e
        return e

    def suggest_chunk_rows(self, backend: str, scan_fp: str) -> int:
        """Chunk row bound from observed decode throughput: about
        `_TARGET_CHUNK_MS` of host decode a chunk. 0 is no suggestion
        (cold), which callers treat as an unset
        SPARK_RAPIDS_TORCH_IO_CHUNK_ROWS."""
        with self._lock:
            e = self._io.get((backend, scan_fp))
            if e is None or not e["rows_per_ms"]:
                return 0
            self.hits += 1
            return max(_MIN_CHUNK_ROWS,
                       int(e["rows_per_ms"] * _TARGET_CHUNK_MS))

    def _subtree_fps(self, root) -> Dict[int, str]:
        """`subtree_fingerprints(root)`, computed once per plan root (the
        entry holds the root, so its id is not reused while cached)."""
        from .optimizer import subtree_fingerprints
        hit = self._fps.get(id(root))
        if hit is None or hit[0] is not root:
            hit = (root, subtree_fingerprints(root))
            self._fps[id(root)] = hit
        return hit[1]

    def _observe_locked(self, backend: str, sfp: str, rows: int) -> Dict:
        """Fold one observed row count into a subtree's entry."""
        e = self._subtrees.get((backend, sfp))
        if e is None:
            e = {"rows": 0, "runs": 0}
            self.rows_generation += 1
        elif rows > int(e["rows"]):
            self.rows_generation += 1
        e["rows"] = max(int(e["rows"]), rows)
        e["runs"] += 1
        self._subtrees[(backend, sfp)] = e
        return e

    def _subtree_evicted(self, _entry) -> None:
        self.rows_generation += 1

    @staticmethod
    def _sig_key(sig) -> str:
        return "" if sig is None else repr(sig)

    @staticmethod
    def _verdict_pairs(m: Dict) -> frozenset:
        """Every (slower, faster) pair past the demotion margin: the
        verdicts `kernel_slower` can give for this signature now."""
        return frozenset(
            (a, b) for a in m for b in m
            if a != b and m[a]["ms_per_krow"] is not None
            and m[b]["ms_per_krow"] is not None
            and m[a]["ms_per_krow"] > m[b]["ms_per_krow"] * _DEMOTE_MARGIN)

    def _record_kernel_locked(self, backend: str, op: str, sig, name: str,
                              ms_per_krow: float) -> None:
        key = (backend, op, self._sig_key(sig))
        m = self._kernels.get(key) or {}
        before = self._verdict_pairs(m)
        e = m.get(name) or {"ms_per_krow": None, "runs": 0}
        e["ms_per_krow"] = _ewma(e["ms_per_krow"], float(ms_per_krow))
        e["runs"] += 1
        m[name] = e
        if self._verdict_pairs(m) != before:
            # a verdict flipped (an EWMA crossing the margin counts even
            # when the order is unchanged): programs cached under the old
            # epoch must not serve the new picks
            self.kernel_epoch += 1
        self._kernels[key] = m

    def record_kernel(self, backend: str, op: str, sig, name: str,
                      wall_ms: float, rows: int = 1000) -> None:
        """Public timing feed (benches, tests): `wall_ms` over `rows` rows,
        kept as ms per 1,000 rows."""
        with self._lock:
            self._record_kernel_locked(
                backend, op, sig, name, wall_ms / max(int(rows), 1) * 1e3)

    # ---- consults ----------------------------------------------------------

    def observed_rows(self, backend: str,
                      subtree_fp: str) -> Optional[Tuple[int, int]]:
        """(high-water rows, runs) of this operator subtree on `backend`;
        None when never seen."""
        with self._lock:
            e = self._subtrees.get((backend, subtree_fp))
            if e is None:
                return None
            self.hits += 1
            return int(e["rows"]), int(e["runs"])

    def observed_caps(self, backend: str, source_fp: str,
                      executed_fp: Optional[str] = None) -> Dict[str, int]:
        """The high-water caps of this authored plan on `backend`. When
        the executed fingerprint differs from the recorded one (a
        stats-driven rewrite changed the plan since), only the global cap
        keys carry over: per-node `row_cap:<i>` entries index a plan that
        no longer runs."""
        with self._lock:
            ps = self._plans.get((backend, source_fp))
            if ps is None or not ps["caps"]:
                return {}
            caps = dict(ps["caps"])
            if executed_fp is not None and \
                    ps.get("executed_fp") != executed_fp:
                caps = {k: v for k, v in caps.items() if ":" not in k}
            if caps:
                self.hits += 1
            return caps

    def plan_runs(self, backend: str, source_fp: str) -> int:
        with self._lock:
            ps = self._plans.get((backend, source_fp))
            return 0 if ps is None else int(ps["runs"])

    def op_stats(self, backend: str, source_fp: str) -> Dict[int, Dict]:
        """toposort index -> {rows_out, bytes_out, wall_ms, kernel} of the
        last recorded execution of this authored plan on `backend`."""
        with self._lock:
            ps = self._plans.get((backend, source_fp))
            return {} if ps is None else {
                int(i): dict(v) for i, v in ps["ops"].items()}

    def kernel_slower(self, backend: str, op: str, sig, name: str,
                      fallback_name: str
                      ) -> Optional[Tuple[float, float]]:
        """(candidate, fallback) ms per 1,000 rows when the candidate has
        timed slower than the fallback past `_DEMOTE_MARGIN` on this exact
        signature; None when a timing is missing or the candidate holds
        up."""
        if sig is None:
            return None
        with self._lock:
            m = self._kernels.get((backend, op, self._sig_key(sig)))
            if not m or name not in m or fallback_name not in m:
                return None
            a = m[name]["ms_per_krow"]
            b = m[fallback_name]["ms_per_krow"]
            if a is None or b is None or a <= b * _DEMOTE_MARGIN:
                return None
            self.hits += 1
            return float(a), float(b)

    # ---- persistence (JSONL) -----------------------------------------------

    def _append(self, event: Dict) -> None:
        try:
            with self._io_lock, open(self.path, "a", encoding="utf-8") as f:
                f.write(json.dumps(event) + "\n")
        except OSError:
            pass                # persistence is best effort

    def _load(self, path: str) -> None:
        try:
            with open(path, "r", encoding="utf-8") as f:
                lines = f.readlines()
        except OSError:
            return
        with self._lock:
            for line in lines:
                try:
                    self._replay(json.loads(line))
                except (KeyError, TypeError, ValueError):
                    continue    # a torn or foreign line

    def _replay(self, ev: Dict) -> None:
        backend = ev["backend"]
        key = (backend, ev["source_fp"])
        ps = self._plans.get(key) or {
            "executed_fp": ev["executed_fp"], "runs": 0, "caps": {},
            "ops": {}}
        ps["runs"] += 1
        ps["executed_fp"] = ev["executed_fp"]
        for k, v in (ev.get("caps") or {}).items():
            ps["caps"][k] = max(int(ps["caps"].get(k, 0)), int(v))
        for i, v in (ev.get("ops") or {}).items():
            ps["ops"][int(i)] = dict(v)
        self._plans[key] = ps
        for sfp, rows in (ev.get("subtrees") or {}).items():
            self._observe_locked(backend, sfp, int(rows))
        for sfp, rate in (ev.get("io") or {}).items():
            self._io_locked(backend, sfp, float(rate))
        for op, sig_key, name, per_krow in ev.get("kernels") or []:
            m = self._kernels.get((backend, op, sig_key)) or {}
            e = m.get(name) or {"ms_per_krow": None, "runs": 0}
            e["ms_per_krow"] = _ewma(e["ms_per_krow"], float(per_krow))
            e["runs"] += 1
            m[name] = e
            self._kernels[(backend, op, sig_key)] = m
        self.generation += 1


# ---- process wiring ---------------------------------------------------------

_default_store: Optional[StatsStore] = None
_default_lock = threading.Lock()
# the scope stack of `scoped_store`, per thread: one thread's isolated
# store must not leak into another thread's executions
_scope = threading.local()


def _scope_stack() -> list:
    stack = getattr(_scope, "stack", None)
    if stack is None:
        stack = _scope.stack = []
    return stack


def default_store() -> StatsStore:
    """The process's store (capacity and path read from the knobs when it
    is first made; `reset_default_store` makes the next call re-read)."""
    global _default_store
    with _default_lock:
        if _default_store is None:
            _default_store = StatsStore()
        return _default_store


def reset_default_store() -> None:
    global _default_store
    with _default_lock:
        _default_store = None


def active_store() -> Optional[StatsStore]:
    """The store consumers read and record through, or None when
    adaptivity is off: this thread's innermost `scoped_store` (a scoped
    None too), else the process default when SPARK_RAPIDS_TORCH_STATS is
    on."""
    stack = _scope_stack()
    if stack:
        return stack[-1]
    from .. import config
    if not config.stats_enabled():
        return None
    return default_store()


@contextlib.contextmanager
def scoped_store(store: Optional[StatsStore]):
    """Make `store` the active store on this thread for the block (None
    turns adaptivity off)."""
    stack = _scope_stack()
    stack.append(store)
    try:
        yield store
    finally:
        stack.pop()
