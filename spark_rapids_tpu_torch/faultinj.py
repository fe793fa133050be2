"""Fault injector for the port's device-call surface.

Counterpart of `spark_rapids_tpu/faultinj.py` (reference: faultinj/faultinj.cu,
the CUPTI-based `libcufaultinj.so` loaded through CUDA_INJECTION64_PATH;
config schema from faultinj/README.md:61-170, SURVEY.md §2.3). The
interception points are the port's own device-call surface, under the JAX
package's names, so one config file means the same to both packages:

- every public op of `spark_rapids_tpu_torch.ops`;
- every op of `ops/plan_ops.py`, the table the plan executor calls
  through (`inner_join`, `take_table`, `apply_boolean_mask`,
  `groupby_aggregate`, `sort_table`, `slice_table`, ...), which holds the
  kernels' routes too;
- the executor's plan-level points `plan.<Kind>`, once per operator in
  the eager tier and once per operator per attempt in the capped tier;
- `health.probe`, and the arbiter-fronted memory calls
  (`MemoryBudget.acquire`, `try_acquire`, `release`).

Activation: set SPARK_RAPIDS_TORCH_FAULTINJ_CONFIG_PATH before importing
the package, or call `install(path)`.

Config (JSON; field names kept from faultinj/README.md):

    {
      "logLevel": 1,            # python logging level number, spdlog-style
      "seed": 12345,            # sampling RNG seed (reproducible runs)
      "dynamic": true,          # hot-reload on config-file mtime change
      "computeFaults":  { "<op name>|*": { rule } },
      "runtimeFaults":  { "<call name>|*": { rule } }
    }

    rule = {
      "percent": 50,              # injection probability per matched call
      "injectionType": 0|1|2,     # 0 fatal device fault (poisons the device:
                                  #   later calls fail until reset_device()),
                                  # 1 nonfatal device assert (recoverable),
                                  # 2 substitute return code
      "substituteReturnCode": 2,  # status code to surface (type 2)
      "interceptionCount": 1000   # how many matched calls remain eligible
    }

Every fault is injected in Python: a fatal one poisons the state this
injector holds, and no trap or assert kernel is launched, so the CUDA
context stays usable. `reset_device()` is the test harness's analogue of
restarting the executor.
"""
from __future__ import annotations

import json
import logging
import os
import random
import threading
from typing import Callable, Dict, Optional

log = logging.getLogger("spark_rapids_tpu_torch.faultinj")

ENV_CONFIG_PATH = "SPARK_RAPIDS_TORCH_FAULTINJ_CONFIG_PATH"

FAULT_FATAL = 0        # reference: PTX trap kernel (faultinj.cu:139)
FAULT_ASSERT = 1       # reference: device assert(0) kernel (faultinj.cu:141)
FAULT_SUBSTITUTE = 2   # reference: substitute CUresult (faultinj.cu:226-248)


class DeviceFatalError(RuntimeError):
    """Injected fatal fault: the device is unusable until reset_device().
    (Reference analogue: sticky CUDA_ERROR_ILLEGAL_INSTRUCTION after trap.)"""


class DeviceAssertError(RuntimeError):
    """Injected nonfatal fault: this call failed; the device is still good."""


class InjectedReturnCode(RuntimeError):
    """Injected substitute return code (injectionType 2)."""

    def __init__(self, api_name: str, code: int):
        super().__init__(f"injected return code {code} from {api_name}")
        self.code = code


class _Rule:
    def __init__(self, spec: Dict):
        self.percent = float(spec.get("percent", 0))
        self.injection_type = int(spec.get("injectionType", FAULT_ASSERT))
        self.substitute_code = int(spec.get("substituteReturnCode", 0))
        # remaining matched calls eligible for sampling
        self.count = int(spec.get("interceptionCount", 0x7FFFFFFF))
        self.lock = threading.Lock()

    def draw(self, rng: random.Random) -> bool:
        """One matched call: consume eligibility, sample the percent."""
        with self.lock:
            if self.count <= 0:
                return False
            self.count -= 1
        return rng.uniform(0, 100) < self.percent


class FaultInjector:
    """One loaded config + its interception state."""

    def __init__(self, config_path: str):
        self.config_path = config_path
        self._mtime = 0.0
        self._lock = threading.Lock()
        self._device_poisoned = False
        self._injected = 0
        self._load()

    # ---- config ------------------------------------------------------------

    def _load(self) -> None:
        with open(self.config_path) as f:
            cfg = json.load(f)
        self._mtime = os.stat(self.config_path).st_mtime
        self.dynamic = bool(cfg.get("dynamic", False))
        self.rng = random.Random(cfg.get("seed"))
        if "logLevel" in cfg:
            # spdlog numeric levels 0..6 ~ trace..off; map onto logging's 0..50
            log.setLevel(min(int(cfg["logLevel"]), 5) * 10)
        self.compute_rules = {k: _Rule(v)
                              for k, v in cfg.get("computeFaults", {}).items()}
        self.runtime_rules = {k: _Rule(v)
                              for k, v in cfg.get("runtimeFaults", {}).items()}
        log.info("faultinj config loaded from %s (dynamic=%s)",
                 self.config_path, self.dynamic)

    def _maybe_reload(self) -> None:
        if not self.dynamic:
            return
        try:
            m = os.stat(self.config_path).st_mtime
        except OSError:
            return
        if m != self._mtime:
            with self._lock:
                if m != self._mtime:
                    try:
                        self._load()
                    except (OSError, ValueError) as e:
                        log.warning("faultinj config reload failed: %s", e)

    # ---- interception ------------------------------------------------------

    def reset_device(self) -> None:
        """Clear the poisoned-device state (executor-restart analogue)."""
        with self._lock:
            self._device_poisoned = False

    @property
    def device_poisoned(self) -> bool:
        return self._device_poisoned

    def get_and_reset_injected(self) -> int:
        """Faults fired since the last drain (arbiter-style
        get-and-reset)."""
        with self._lock:
            n = self._injected
            self._injected = 0
        return n

    def on_call(self, api_name: str, which: str) -> None:
        """Interception callback — the CUPTI callback-handler analogue
        (faultinj.cu:158-260). Raises when a fault fires."""
        if getattr(_suppress, "on", False):
            return      # degraded CPU tier: no device, no device faults
        self._maybe_reload()
        if self._device_poisoned:
            raise DeviceFatalError(
                f"device is in a failed state (earlier injected fatal fault); "
                f"{api_name} refused")
        rules = getattr(self, which)  # looked up AFTER a possible hot reload
        rule = rules.get(api_name) or rules.get("*")
        if rule is None or not rule.draw(self.rng):
            return
        log.debug("injecting fault type %d into %s", rule.injection_type, api_name)
        with self._lock:
            self._injected += 1
            if rule.injection_type == FAULT_FATAL:
                # poison INSIDE the lock: under concurrent sessions a racing
                # reset_device() must observe either the un-poisoned or the
                # fully-poisoned state, never a torn interleaving where the
                # fatal was counted but the device stayed healthy
                self._device_poisoned = True
        if rule.injection_type == FAULT_FATAL:
            raise DeviceFatalError(f"injected fatal device fault in {api_name}")
        if rule.injection_type == FAULT_ASSERT:
            raise DeviceAssertError(f"injected device assert in {api_name}")
        if rule.injection_type == FAULT_SUBSTITUTE:
            raise InjectedReturnCode(api_name, rule.substitute_code)

    def on_compute(self, api_name: str) -> None:
        self.on_call(api_name, "compute_rules")

    def on_runtime(self, api_name: str) -> None:
        self.on_call(api_name, "runtime_rules")


# ---- thread-local suppression ----------------------------------------------

_suppress = threading.local()


class suppressed:
    """Context manager: disable interception on this thread.

    The degraded CPU tier (plan/executor.py, docs/robustness.md) runs
    device-free, so NO device-call interception — compute shims, the
    arbiter-fronted MemoryBudget shims, or a poisoned-device fail-fast —
    may fire inside it; a dead device must not be able to kill the
    fallback that exists to survive it."""

    def __enter__(self):
        self._prev = getattr(_suppress, "on", False)
        _suppress.on = True
        return self

    def __exit__(self, *exc):
        _suppress.on = self._prev
        return False


# ---- global install / uninstall --------------------------------------------

_active: Optional[FaultInjector] = None
_saved_ops: Dict[tuple, Callable] = {}
_saved_budget_methods: Dict[str, Callable] = {}
# install/uninstall swap module-global interception state (the shims AND
# the saved originals); two racing installs would save each other's shims
# as "originals" and uninstall could never restore the real ops
_install_lock = threading.Lock()


def active() -> Optional[FaultInjector]:
    return _active


def _wrap_op(name: str, fn: Callable) -> Callable:
    def shim(*args, **kwargs):
        inj = _active
        if inj is not None:
            inj.on_compute(name)
        return fn(*args, **kwargs)
    shim.__name__ = fn.__name__
    shim.__doc__ = fn.__doc__
    shim.__wrapped__ = fn
    shim.__faultinj_shim__ = True
    return shim


def install(config_path: Optional[str] = None) -> FaultInjector:
    """Load the config and intercept the device-call surface.

    Idempotent per-process like the reference's cuInit-time load; call
    uninstall() first to swap interception points.
    """
    with _install_lock:
        return _install_locked(config_path)


def _install_locked(config_path: Optional[str]) -> FaultInjector:
    global _active
    from . import config as _config
    path = config_path or _config.faultinj_config_path()
    if not path:
        raise ValueError(f"no config path given and ${ENV_CONFIG_PATH} unset")
    if _active is not None:
        # same interception points; just swap the config
        _active = FaultInjector(path)
        return _active
    _active = FaultInjector(path)

    from . import ops
    from .ops import plan_ops
    for mod in (ops, plan_ops):
        for name in mod.__all__:
            fn = getattr(mod, name)
            # skip non-callables (and classes) and our own shims
            if (callable(fn) and not isinstance(fn, type)
                    and not hasattr(fn, "__faultinj_shim__")):
                _saved_ops[(mod.__name__, name)] = fn
                setattr(mod, name, _wrap_op(name, fn))

    from .runtime import pool

    def patched(method_name):
        orig = getattr(pool.MemoryBudget, method_name)
        _saved_budget_methods[method_name] = orig

        def shim(self, *args, **kwargs):
            inj = _active
            if inj is not None:
                inj.on_runtime(f"MemoryBudget.{method_name}")
            return orig(self, *args, **kwargs)
        shim.__name__ = method_name
        shim.__wrapped__ = orig
        return shim

    for m in ("acquire", "try_acquire", "release"):
        setattr(pool.MemoryBudget, m, patched(m))
    log.info("faultinj installed over %d ops + MemoryBudget", len(_saved_ops))
    return _active


def uninstall() -> None:
    """Remove interception and restore the original callables."""
    with _install_lock:
        _uninstall_locked()


def _uninstall_locked() -> None:
    global _active
    _active = None
    if _saved_ops:
        import sys
        for (mod, name), fn in _saved_ops.items():
            setattr(sys.modules[mod], name, fn)
        _saved_ops.clear()
    if _saved_budget_methods:
        from .runtime import pool
        for name, fn in _saved_budget_methods.items():
            setattr(pool.MemoryBudget, name, fn)
        _saved_budget_methods.clear()


def maybe_install_from_env() -> None:
    """Package-import hook: activate when the env var is set, exactly like
    the reference loading libcufaultinj.so via CUDA_INJECTION64_PATH."""
    from . import config as _config
    if _config.faultinj_config_path():
        try:
            install()
        except (OSError, ValueError) as e:
            log.warning("faultinj auto-install failed: %s", e)
