"""Per-backend kernel registry: (operator kind, backend, signature) -> impl.

Counterpart of `spark_rapids_tpu/ops/registry.py`, with the same rank and
decline rules:

- every op registers exactly ONE `fallback=True` kernel, the universal
  plain-PyTorch lowering, eligible on every backend for every signature:
  selection never fails, it only declines;
- other kernels register for specific backends (the hand-written CUDA
  kernels register `backends=("cuda",)`) and may carry a `supports`
  predicate over the call-site `Signature`. An unsupported signature
  declines to the next candidate;
- `select()` reads the SPARK_RAPIDS_TORCH_KERNELS override knob
  (config.py, e.g. `hash_join=cuda`). A forced kernel crosses the backend
  gate (on CPU tensors a CUDA kernel's wrapper runs its plain version) but
  still declines a signature it does not support; an unknown op or kernel
  NAME raises.

The backend is the device type of the tensors the operator runs on
("cuda" or "cpu"); the caller passes it.

With a stats store active (plan/stats.py), `select()` also reads observed
timings, as the reference's does: a candidate that has timed slower than
the fallback past the store's hysteresis margin on this exact (op,
backend, signature) is declined with the numbers, and `stats_demoted` is
stamped on the choice; a forced override outranks the demotion. On
"cuda" the fallback is not a route (the plain versions never run on the
card), so the store never demotes a CUDA kernel: the demotion runs on the
CPU backend only. The capped tier's program cache keys on the store's
`kernel_epoch`, so a cached program never serves a pick that a demotion
changed.
"""
from __future__ import annotations

import dataclasses
import importlib
import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple

__all__ = ["Signature", "Kernel", "KernelChoice", "KernelRegistry",
           "REGISTRY"]


@dataclasses.dataclass(frozen=True)
class Signature:
    """What a kernel may condition on: the dtype/validity layout of the
    columns crossing the operator plus op-specific static extras."""

    columns: Tuple[Tuple[str, bool], ...] = ()   # (Kind.value, has_validity)
    extras: Tuple[Tuple[str, object], ...] = ()

    @staticmethod
    def of(cols: Sequence = (), **extras) -> "Signature":
        col_sig = tuple((c.dtype.kind.value, c.validity is not None)
                        for c in cols)
        return Signature(columns=col_sig,
                         extras=tuple(sorted(extras.items())))

    def extra(self, key: str, default=None):
        for k, v in self.extras:
            if k == key:
                return v
        return default

    @property
    def kinds(self) -> Tuple[str, ...]:
        return tuple(k for k, _ in self.columns)


class KernelDeclinedError(RuntimeError):
    """No kernel takes a call on the card, where the plain versions do not
    run."""


@dataclasses.dataclass(frozen=True)
class Kernel:
    op: str
    name: str                      # "cuda", "torch", ...
    fn: Optional[Callable]         # None when the caller owns the lowering
    backends: Tuple[str, ...]      # ("cuda",) / ("*",)
    supports: Optional[Callable]   # Signature -> bool; None = everything
    fallback: bool


@dataclasses.dataclass(frozen=True)
class KernelChoice:
    """One resolved dispatch; `declined` records every better-ranked kernel
    passed over and why."""

    op: str
    name: str
    fn: Optional[Callable]
    fallback: bool
    declined: Tuple[Tuple[str, str], ...] = ()
    stats_demoted: bool = False    # a better-ranked kernel lost on timings

    @property
    def label(self) -> str:
        return f"{self.name}:{self.op}"


# op -> module whose import registers that op's kernels (imported lazily)
_PROVIDERS = {
    "groupby": "spark_rapids_tpu_torch.ops.groupby_cuda",
    "hash_join": "spark_rapids_tpu_torch.ops.join_cuda",
    "row_conversion": "spark_rapids_tpu_torch.ops.row_conversion_cuda",
    "fused_select": "spark_rapids_tpu_torch.ops.select_cuda",
    "topk": "spark_rapids_tpu_torch.ops.topk_cuda",
}


class KernelRegistry:
    def __init__(self):
        self._ops: Dict[str, List[Kernel]] = {}
        self._ov_validated: Optional[Tuple[Tuple[str, str], ...]] = None
        self._lock = threading.RLock()

    def register(self, op: str, name: str, fn: Optional[Callable] = None, *,
                 backends: Sequence[str] = ("*",),
                 supports: Optional[Callable] = None,
                 fallback: bool = False) -> Kernel:
        with self._lock:
            ks = self._ops.setdefault(op, [])
            if any(k.name == name for k in ks):
                raise ValueError(
                    f"kernel {name!r} already registered for {op!r}")
            if fallback:
                if any(k.fallback for k in ks):
                    raise ValueError(f"{op!r} already has a fallback kernel")
                if supports is not None:
                    raise ValueError(
                        f"{op!r}/{name!r}: a fallback kernel must support "
                        "every signature")
            k = Kernel(op=op, name=name, fn=fn, backends=tuple(backends),
                       supports=supports, fallback=fallback)
            ks.append(k)
            return k

    def _ensure(self, op: str) -> None:
        if op in self._ops:
            return
        with self._lock:
            if op in self._ops:
                return
            mod = _PROVIDERS.get(op)
            if mod is None:
                raise ValueError(
                    f"unknown kernel op {op!r} (known: "
                    f"{sorted(set(self._ops) | set(_PROVIDERS))})")
            importlib.import_module(mod)
            if op not in self._ops:
                raise RuntimeError(f"provider {mod} did not register {op!r}")

    def _overrides(self) -> Dict[str, str]:
        from .. import config
        ov = config.kernel_overrides()
        key = tuple(sorted(ov.items()))
        if key == self._ov_validated:
            return ov
        for op, name in key:
            self._ensure(op)
            if not any(k.name == name for k in self._ops[op]):
                raise ValueError(
                    f"SPARK_RAPIDS_TORCH_KERNELS: unknown kernel {name!r} "
                    f"for {op!r} (have {[k.name for k in self._ops[op]]})")
        with self._lock:
            self._ov_validated = key
        return ov

    @staticmethod
    def _stats_verdict(op: str, backend: str, name: str,
                       fallback_name: str, sig: Optional[Signature]):
        """The store's (candidate, fallback) ms per 1,000 rows when the
        candidate timed slower than the fallback past the margin on this
        signature; None when cold, off, on "cuda" (no plain route there)
        or when the candidate holds up."""
        if sig is None or backend == "cuda":
            return None
        from ..plan import stats as _stats
        store = _stats.active_store()
        if store is None:
            return None
        return store.kernel_slower(backend, op, sig, name, fallback_name)

    def select(self, op: str, sig: Optional[Signature],
               backend: str) -> KernelChoice:
        """Resolve `op` for `backend` ("cuda"/"cpu") and `sig`. Never raises
        on signatures; raises only on unknown op/override names. With a
        stats store, a candidate that timed slower than the fallback on
        this signature is demoted (not on "cuda"); a forced override
        outranks the demotion."""
        self._ensure(op)
        ks = self._ops[op]
        fb = next((k for k in ks if k.fallback), None)
        if fb is None:
            raise RuntimeError(f"op {op!r} registered no fallback=True kernel")
        declined: List[Tuple[str, str]] = []

        def ok(k: Kernel) -> bool:
            if k.supports is None:
                return True
            if sig is None:
                declined.append((k.name, "no signature at call site"))
                return False
            if not k.supports(sig):
                declined.append((k.name, "unsupported signature"))
                return False
            return True

        forced = self._overrides().get(op)
        if forced is not None:
            k = next(k for k in ks if k.name == forced)
            if ok(k):
                return KernelChoice(op, k.name, k.fn, k.fallback)
            return KernelChoice(op, fb.name, fb.fn, True, tuple(declined))
        # auto: backend-exact non-fallbacks, then universal non-fallbacks,
        # then the fallback; registration order within a rank
        demoted = False
        for rank in (lambda k: not k.fallback and backend in k.backends,
                     lambda k: not k.fallback and "*" in k.backends):
            for k in ks:
                if rank(k) and ok(k):
                    verdict = self._stats_verdict(op, backend, k.name,
                                                  fb.name, sig)
                    if verdict is not None:
                        declined.append(
                            (k.name,
                             "stats: benched %.4g ms/1k rows vs fallback "
                             "%.4g on this signature" % verdict))
                        demoted = True
                        continue
                    return KernelChoice(op, k.name, k.fn, k.fallback,
                                        tuple(declined),
                                        stats_demoted=demoted)
        return KernelChoice(op, fb.name, fb.fn, True, tuple(declined),
                            stats_demoted=demoted)


REGISTRY = KernelRegistry()
