"""Deadline batcher: fill [B, cap] batches until full or a latency
deadline expires, then dispatch once.

Batching amortizes one solve over B instances (the batched engine
solves B lanes in one call — ``core.batch``), but a naive "wait for a
full batch" policy would stall a lone request forever. The standard
serving compromise is a *deadline batcher*: the first request into a
class opens that class's batch and starts its deadline clock; the batch
dispatches the moment it is full, or when the deadline expires with
whatever partial fill it has (the dispatcher pads the rest).

Time is injected (callers pass ``now``), never read here — the service
runs against ``time.monotonic`` while tests and the open-loop benchmark
drive a simulated clock deterministically through the same code.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Hashable


@dataclasses.dataclass(frozen=True)
class Flush:
    """One dispatched batch: which class, which requests, and why now."""

    key: Hashable  # class key the queue was keyed on
    items: tuple  # queued requests, submission order
    opened_at: float  # when the first item arrived
    dispatched_at: float  # when the batch left the queue
    reason: str  # "full" | "deadline" | "drain"


@dataclasses.dataclass
class _Queue:
    items: list
    opened_at: float


class DeadlineBatcher:
    """Per-class-key queues with a shared deadline.

    ``add`` returns a full :class:`Flush` immediately when the item tops
    the class off at ``max_batch`` (latency floor: a hot class never waits
    on the clock); ``due`` returns every queue whose deadline has expired;
    ``drain`` flushes everything regardless (shutdown / end of stream).
    """

    def __init__(self, deadline_s: float):
        if not deadline_s >= 0:
            raise ValueError(
                f"deadline_s must be >= 0, got {deadline_s!r}")
        self.deadline_s = float(deadline_s)
        self._queues: dict[Hashable, _Queue] = {}

    def add(self, key: Hashable, item: Any, now: float,
            max_batch: int) -> Flush | None:
        """Queue ``item`` under ``key``; return a Flush iff the batch is
        now full (caller dispatches it)."""
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch!r}")
        q = self._queues.get(key)
        if q is None:
            q = self._queues[key] = _Queue(items=[], opened_at=now)
        q.items.append(item)
        if len(q.items) >= max_batch:
            del self._queues[key]
            return Flush(key=key, items=tuple(q.items), opened_at=q.opened_at,
                         dispatched_at=now, reason="full")
        return None

    def due(self, now: float) -> list[Flush]:
        """Flush every queue whose deadline has expired by ``now``.

        ``dispatched_at`` is the deadline itself, not ``now``: a simulated
        clock may pump late (at the next arrival), and charging the gap to
        the request would invent latency the service never imposed.
        """
        out = []
        for key in list(self._queues):
            q = self._queues[key]
            due_at = q.opened_at + self.deadline_s
            if due_at <= now:
                del self._queues[key]
                out.append(Flush(key=key, items=tuple(q.items),
                                 opened_at=q.opened_at, dispatched_at=due_at,
                                 reason="deadline"))
        return out

    def drain(self, now: float) -> list[Flush]:
        """Flush every queue regardless of deadline (end of stream)."""
        out = []
        for key in list(self._queues):
            q = self._queues.pop(key)
            out.append(Flush(key=key, items=tuple(q.items),
                             opened_at=q.opened_at,
                             dispatched_at=min(q.opened_at + self.deadline_s,
                                               now),
                             reason="drain"))
        return out

    def pending(self) -> int:
        """Total queued (not yet dispatched) items across classes."""
        return sum(len(q.items) for q in self._queues.values())

    def next_deadline(self) -> float | None:
        """Earliest pending deadline, or None when no queue is open —
        what an event loop would sleep until."""
        if not self._queues:
            return None
        return min(q.opened_at for q in self._queues.values()) \
            + self.deadline_s
