"""Which session the work on this thread belongs to.

Counterpart of `spark_rapids_tpu/runtime/sessionctx.py`. A degraded CPU
tier replays work on whatever thread hit the breaker, and a dispatcher may
run several sessions on one worker thread, so thread identity does not say
whose work it is:

- `session_scope(sid)` installs a session id for the dynamic extent on the
  current thread (re-entrant; the innermost scope wins);
- `current_session_id()` returns it (None outside any scope);
- `session_key()` is the key the health monitor keeps retry budgets and
  sticky windows under (runtime/health.py): the session id when one is
  scoped, else one derived from the thread.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Iterator, Optional

_ctx = threading.local()


def current_session_id() -> Optional[str]:
    """The innermost session id scoped on this thread, or None."""
    stack = getattr(_ctx, "stack", None)
    return stack[-1] if stack else None


def session_key() -> str:
    """Accounting key for per-session state (retry budgets, sticky
    windows): the scoped session id, falling back to thread identity so
    unscoped execution keeps per-thread isolation."""
    sid = current_session_id()
    return sid if sid is not None else f"thread:{threading.get_ident()}"


@contextlib.contextmanager
def session_scope(session_id: str) -> Iterator[str]:
    """Attribute the dynamic extent to `session_id` on this thread."""
    stack = getattr(_ctx, "stack", None)
    if stack is None:
        stack = _ctx.stack = []
    stack.append(str(session_id))
    try:
        yield session_id
    finally:
        stack.pop()
