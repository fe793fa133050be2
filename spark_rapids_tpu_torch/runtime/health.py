"""Device health monitor and circuit breaker for the plan executor.

Counterpart of `spark_rapids_tpu/runtime/health.py`. It turns the
executor's failures into a policy:

- **transient**: an injected nonfatal assert or a substituted return
  code (and a `RetryOOM`, as in the reference, though the port's executor
  never records one: memory pressure leaves `execute()`). Retried, with
  jittered exponential backoff, while the plan attempt's shared retry
  *budget* lasts.
- **sticky**: the same operator keeps failing inside a time window, or the
  retry budget or the per-operator retry bound is spent. Stop retrying.
- **fatal**: `DeviceFatalError`, the device is poisoned until
  `reset_device()`. Never retried.

Sticky and fatal failures **trip the circuit breaker**:

    closed -- sticky/fatal --> open -- reset_device() -----> half_open
      ^                         ^ |      or cooldown_s elapsed   |
      +----- probe succeeds ----+-+--------- probe fails --------+

While the breaker is open the device is quarantined: the plan executor
runs the plan on the degraded CPU tier instead (plan/executor.py). The
breaker arms half-open on `reset_device()` or once `cooldown_s` has passed
since the trip; the next admission then runs a heartbeat probe, a tiny
torch op on the executor's device and a synchronize, through the same
fault-injection surface: success closes the breaker, failure opens it
again and restarts the cooldown.

Health metrics drain with get-and-reset semantics, as the arbiter's do.
Retry budgets key on (session, thread) and sticky windows on (session,
op), by `sessionctx.session_key()`; the breaker is per device.

The retry budget, the backoff, the sticky window and the cooldown are the
constants below, each a constructor argument of the monitor; the degrade
policy is the executor's (SPARK_RAPIDS_TORCH_BREAKER_DEGRADE, config.py).
"""
from __future__ import annotations

import collections
import random
import threading
import time
from typing import Callable, Deque, Dict, List, Optional

RETRY_BUDGET = 16          # fault retries per plan attempt, all operators
BACKOFF_BASE_MS = 10.0     # before the first retry; doubled, with jitter
BACKOFF_MAX_MS = 1000.0    # the backoff's ceiling
STICKY_THRESHOLD = 3       # failures of one op in the window: sticky
STICKY_WINDOW_S = 60.0
COOLDOWN_S = 30.0          # open until then; 0 waits for reset_device()

# breaker states
CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"

# failure classifications
TRANSIENT = "transient"
STICKY = "sticky"
FATAL = "fatal"


def device_probe(device=None) -> bool:
    """Heartbeat: one tiny computation on `device` (None: the card) and a
    synchronize, through the fault-injection surface (key "health.probe",
    also matched by `*` rules), so a poisoned device fails the probe as a
    real op does."""
    from .. import faultinj
    from .. import device as _device
    import torch
    inj = faultinj.active()
    if inj is not None:
        inj.on_compute("health.probe")
    dev = _device.resolve(device)
    x = torch.arange(8, dtype=torch.int32, device=dev)
    s = x.sum()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return int(s) == 28


class CircuitBreaker:
    """closed → open → half_open state machine over one device.

    `trip()` opens it (quarantine); `half_open()` is the reset_device
    lifecycle hook arming a probation period immediately; an OPEN breaker
    also self-arms HALF_OPEN once `cooldown_s` has elapsed since the trip,
    so a quarantine is never permanent — a device that recovered (or a
    pressure burst that passed) is re-discovered by the next admission
    without operator intervention. `probe()` runs the heartbeat and closes
    (success) or re-opens (failure, restarting the cooldown clock).

    `admit()` is the gate: closed admits, open refuses (until cooldown),
    half_open probes. `DeviceHealthMonitor.admit()` is the same gate with
    probe metrics counted — the state transitions live only here."""

    def __init__(self, probe: Optional[Callable[[], bool]] = None,
                 cooldown_s: float = COOLDOWN_S,
                 clock: Callable[[], float] = time.monotonic):
        self._probe = probe or device_probe
        self.cooldown_s = cooldown_s
        self._clock = clock
        self._lock = threading.Lock()
        self._state = CLOSED
        self._opened_at = 0.0
        self.trips = 0
        self.last_trip_reason: Optional[str] = None
        self.last_trip_error: Optional[str] = None

    @property
    def state(self) -> str:
        return self._state

    def trip(self, reason: str, detail: Optional[str] = None) -> None:
        with self._lock:
            self._state = OPEN
            self._opened_at = self._clock()
            self.trips += 1
            self.last_trip_reason = reason
            self.last_trip_error = detail

    def half_open(self) -> None:
        with self._lock:
            if self._state == OPEN:
                self._state = HALF_OPEN

    def maybe_cooldown(self) -> None:
        """Arm HALF_OPEN when an OPEN breaker's cooldown has elapsed
        (cooldown_s <= 0 disables: quarantine until reset_device())."""
        with self._lock:
            if (self._state == OPEN and self.cooldown_s > 0
                    and self._clock() - self._opened_at >= self.cooldown_s):
                self._state = HALF_OPEN

    def probe(self) -> bool:
        try:
            ok = bool(self._probe())
        except Exception:
            ok = False
        with self._lock:
            if ok:
                self._state = CLOSED
            else:
                self._state = OPEN
                self._opened_at = self._clock()   # restart the cooldown
        return ok

    def admit(self, probe: Optional[Callable[[], bool]] = None) -> bool:
        """ONE admission gate: closed admits, open refuses (until the
        cooldown arms half_open), half_open probes. `probe` overrides the
        probe call so callers can route it through counted wrappers
        (DeviceHealthMonitor.admit) without duplicating this dispatch."""
        self.maybe_cooldown()
        if self._state == CLOSED:
            return True
        if self._state == HALF_OPEN:
            return (probe or self.probe)()
        return False


class DeviceHealthMonitor:
    """Classifies device failures and owns the breaker + retry policy.

    One monitor guards one device (a PlanExecutor creates its own by
    default). Injectable `sleep`/`clock`/`rng`/`probe` keep tests fast and
    deterministic."""

    def __init__(self, *,
                 retry_budget: int = RETRY_BUDGET,
                 backoff_base_ms: float = BACKOFF_BASE_MS,
                 backoff_max_ms: float = BACKOFF_MAX_MS,
                 sticky_threshold: int = STICKY_THRESHOLD,
                 sticky_window_s: float = STICKY_WINDOW_S,
                 cooldown_s: float = COOLDOWN_S,
                 probe: Optional[Callable[[], bool]] = None,
                 sleep: Callable[[float], None] = time.sleep,
                 clock: Callable[[], float] = time.monotonic,
                 rng: Optional[random.Random] = None):
        self.retry_budget = retry_budget
        self.backoff_base_ms = backoff_base_ms
        self.backoff_max_ms = backoff_max_ms
        self.sticky_threshold = sticky_threshold
        self.sticky_window_s = sticky_window_s
        self.breaker = CircuitBreaker(probe=probe, cooldown_s=cooldown_s,
                                      clock=clock)
        self._sleep = sleep
        self._clock = clock
        self._rng = rng or random.Random()
        self._lock = threading.Lock()
        # retry budget is per plan attempt, keyed by (session, thread)
        # (sessionctx.session_key x executing thread): two sessions on one
        # thread never share a bound, and one session's concurrent plans
        # on different threads never refill or starve each other's.
        # Bounded: an evicted live entry refills on its next try_retry,
        # and 8192 keys sit far above the plans in flight at once.
        from ..utils.lru import LruDict
        self._budgets: Dict[tuple, int] = LruDict(8192)
        self._failures: Dict[tuple, Deque[float]] = {}
        self._reset_hooks: List[Callable[[], None]] = []
        self._metrics: Dict[str, float] = collections.defaultdict(float)

    # ---- classification ----------------------------------------------------

    def record_failure(self, op: str, exc: BaseException) -> str:
        """Record one failure of `op` and classify it. Fatal faults classify
        immediately; otherwise stickiness is N failures of the SAME op
        UNDER THE SAME SESSION within the window (old entries age out) —
        tenant A's flaky operator must not arm a sticky trip against
        tenant B's first failure of the same op."""
        from .. import faultinj
        from . import sessionctx
        now = self._clock()
        with self._lock:
            if isinstance(exc, faultinj.DeviceFatalError):
                self._metrics["fatal_faults"] += 1
                return FATAL
            dq = self._failures.setdefault((sessionctx.session_key(), op),
                                           collections.deque())
            dq.append(now)
            while dq and now - dq[0] > self.sticky_window_s:
                dq.popleft()
            if len(self._failures) > 4096:
                # dead-session residue: windows whose every entry has aged
                # out carry no sticky evidence — drop them instead of
                # growing per (session, op) forever
                self._failures = {
                    k: d for k, d in self._failures.items()
                    if d and now - d[-1] <= self.sticky_window_s}
            if len(dq) >= self.sticky_threshold:
                self._metrics["sticky_faults"] += 1
                return STICKY
            self._metrics["transient_faults"] += 1
            return TRANSIENT

    def record_success(self, op: str) -> None:
        """A unit that eventually SUCCEEDED proves its faults were not
        sticky: clear the op's failure window (for the session that ran
        it) so occasional absorbed transients (one per job, say) never
        accumulate across executions into a quarantine of a device that
        recovers every time. Sticky therefore means: repeated failures
        with no intervening success."""
        from . import sessionctx
        with self._lock:
            dq = self._failures.get((sessionctx.session_key(), op))
            if dq:
                dq.clear()

    # ---- retry budget + backoff --------------------------------------------

    def _budget_key(self) -> tuple:
        from . import sessionctx
        return (sessionctx.session_key(), threading.get_ident())

    def start_plan_attempt(self) -> None:
        """Refill this plan attempt's retry budget (keyed by session x
        thread — see __init__: tenants never alias across a shared
        worker thread, and one tenant's concurrent plans never refill or
        starve each other's bound mid-plan)."""
        with self._lock:
            self._budgets[self._budget_key()] = self.retry_budget

    def try_retry(self, attempt: int) -> Optional[float]:
        """Consume one unit of the plan attempt's retry budget and sleep a
        jittered exponential backoff for retry number `attempt` (0-based).
        Returns the milliseconds slept, or None when the budget is
        exhausted (the caller must escalate, not retry)."""
        key = self._budget_key()
        with self._lock:
            budget = self._budgets.get(key)
            if budget is None:
                budget = self.retry_budget
            if budget <= 0:
                self._metrics["budget_exhausted"] += 1
                return None
            self._budgets[key] = budget - 1
        delay_ms = min(self.backoff_max_ms,
                       self.backoff_base_ms * (2 ** attempt))
        delay_ms *= self._rng.uniform(0.5, 1.0)   # jitter: decorrelate peers
        self._sleep(delay_ms / 1e3)
        with self._lock:
            self._metrics["retries"] += 1
            self._metrics["backoff_ms"] += delay_ms
        return delay_ms

    # ---- breaker lifecycle -------------------------------------------------

    def trip(self, reason: str, exc: Optional[BaseException] = None) -> None:
        # the underlying error rides the snapshot: a degraded nightly run
        # must say WHICH failure tripped it, not just the classification
        detail = None if exc is None else f"{type(exc).__name__}: {exc}"[:300]
        self.breaker.trip(reason, detail=detail)
        with self._lock:
            self._metrics["trips"] += 1
            self._metrics[f"{reason}_trips"] += 1

    def probe(self) -> bool:
        ok = self.breaker.probe()
        with self._lock:
            self._metrics["probes"] += 1
            if not ok:
                self._metrics["probe_failures"] += 1
            else:
                # recovery (probed closed) restarts every stickiness window,
                # exactly like reset_device(): pre-trip failures must not
                # instantly re-trip the just-recovered device
                self._failures.clear()
        return ok

    def admit(self) -> bool:
        """The executor's device-admission gate: the breaker's single
        dispatch with the half-open probe routed through the counted
        `probe()` wrapper."""
        return self.breaker.admit(probe=self.probe)

    def note_degraded_plan(self) -> None:
        with self._lock:
            self._metrics["degraded_plans"] += 1

    def add_reset_hook(self, fn: Callable[[], None]) -> None:
        """Register a callable run by reset_device() (e.g. re-initializing a
        client) — the quarantine-exit lifecycle hook."""
        self._reset_hooks.append(fn)

    def reset_device(self) -> None:
        """Executor-restart analogue: clear the injector's poisoned-device
        state, run the registered lifecycle hooks, and arm the breaker
        HALF_OPEN so the next admission probes before trusting the device."""
        from .. import faultinj
        inj = faultinj.active()
        if inj is not None:
            inj.reset_device()
        for fn in self._reset_hooks:
            fn()
        with self._lock:
            # pre-recovery failures must not re-trip the breaker: the reset
            # starts a fresh stickiness window for every operator
            self._failures.clear()
        self.breaker.half_open()

    # ---- metrics -----------------------------------------------------------

    def get_and_reset_metrics(self) -> Dict[str, float]:
        """Drain the health counters (arbiter-style get-and-reset)."""
        with self._lock:
            snap = dict(self._metrics)
            self._metrics.clear()
        return snap
