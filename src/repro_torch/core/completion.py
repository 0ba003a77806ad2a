"""Pooled completion: shared wait machinery for ``IORequest`` (CQ analogue).

The original runtime gave every :class:`repro_torch.core.syscalls.IORequest` its
own ``threading.Event`` *and* its own claim lock — two lock allocations per
request, paid even by speculative requests nobody ever waits on.  At serving
scale that is the dominant per-record constant (``results/overhead.json``):
an open-loop run at thousands of in-flight sessions allocates tens of
thousands of kernel-backed locks per second just to mostly never touch them.

io_uring does not do this: completions post to one shared completion queue
and waiters park on *it*, not on per-SQE state.  This module is that idea at
the Python level — a fixed array of *stripes* (lock + condition + waiter
count) shared by all requests.  A request is mapped to its stripe by
identity hash; its completion flag is a plain attribute (safe to read
lock-free under the GIL), and only the slow paths — an actual blocking wait,
or the PREPARED -> {SUBMITTED, CANCELLED} claim race — touch the stripe.

Properties the tests (``tests/test_completion.py``) pin down:

* **no lost wakeups** — a waiter that registered on the stripe before the
  completer set the flag is always notified (flag write + notify happen
  under the stripe lock; waiters re-check the flag under the same lock);
* **no double delivery** — the completion callback attached to a request
  (the slot scheduler's accounting hook) fires exactly once across any
  interleaving of ``finish`` and ``cancel``, including the shared backend's
  evict-then-serve-inline re-finish;
* **claim/cancel exclusivity** — at most one of ``claim()`` / ``cancel()``
  wins, exactly as the old per-request lock guaranteed.

False sharing (two hot requests on one stripe) costs a spurious wakeup plus
a predicate re-check, never correctness; with the default 64 stripes and
completions typically consumed promptly, collisions are rare and cheap.

Cross-references: docs/ARCHITECTURE.md ("Open-loop serving & pooled
completion"); *completion pool* is defined in docs/GLOSSARY.md.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List


class _Stripe:
    """One slot of the completion pool: a lock/condition pair plus the
    count of threads currently blocked on it (so completers can skip the
    notify entirely when nobody is waiting — the common speculative case)."""

    __slots__ = ("lock", "cond", "waiters")

    def __init__(self) -> None:
        self.lock = threading.Lock()
        self.cond = threading.Condition(self.lock)
        self.waiters = 0


class CompletionPool:
    """A fixed set of stripes shared by every ``IORequest``.

    ``n_stripes`` must be a power of two; requests map to stripes by
    ``(id(req) >> 6) & (n - 1)`` (the shift discards allocator-alignment
    zeros so consecutive allocations spread across stripes).
    """

    __slots__ = ("_stripes", "_mask")

    def __init__(self, n_stripes: int = 64) -> None:
        if n_stripes & (n_stripes - 1):
            raise ValueError("n_stripes must be a power of two")
        self._stripes: List[_Stripe] = [_Stripe() for _ in range(n_stripes)]
        self._mask = n_stripes - 1

    def stripe(self, obj: object) -> _Stripe:
        return self._stripes[(id(obj) >> 6) & self._mask]

    # -- waiting ------------------------------------------------------------
    def wait(self, req, timeout=None) -> bool:
        """Block until ``req._done`` is true; returns False on timeout.

        The fast path never touches the stripe: a completed request costs
        one attribute read.  The slow path registers as a waiter under the
        stripe lock and re-checks the flag before every sleep, so a
        completion that lands between the lock-free check and the lock
        acquisition is never missed.
        """
        if req._done:
            return True
        s = self.stripe(req)
        with s.lock:
            if req._done:
                return True
            s.waiters += 1
            try:
                if timeout is None:
                    while not req._done:
                        s.cond.wait()
                    return True
                deadline = time.monotonic() + timeout
                while not req._done:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        return False
                    s.cond.wait(remaining)
                return True
            finally:
                s.waiters -= 1

    def snapshot(self) -> Dict[str, int]:
        return {
            "stripes": len(self._stripes),
            "waiters": sum(s.waiters for s in self._stripes),
        }


#: the process-wide pool every IORequest parks on (io_uring has one CQ per
#: ring; we go further — one waiter table per process — because a stripe
#: collision costs a re-check, not a correctness hazard)
_POOL = CompletionPool()


def completion_pool() -> CompletionPool:
    """The process-wide completion pool (exposed for tests/observability)."""
    return _POOL
