"""Discrete-event simulation core: virtual clock + deterministic event queue.

Verbatim copy of ``repro/core/events.py:1`` (``Event``, ``EventQueue``).

The federation engine (``fed/engine.py``) simulates wall-clock behaviour of
heterogeneous clients without real sleeping: every client/tier completion is
an :class:`Event` on a priority queue ordered by virtual time, and the clock
jumps from event to event. This is what lets one process express synchronous
rounds, FedAT-style asynchronous tier aggregation, and client churn (dropout,
arrival, mid-round profile switches) with identical training math.

Determinism contract (tested in ``tests/test_events.py``):
  * events are ordered by ``(time, seq)`` where ``seq`` is the insertion
    order — simultaneous events pop in the order they were pushed, so a run
    is a pure function of the seeds that produced the pushes;
  * cancellation is lazy (the heap entry is tombstoned, skipped on pop), so
    cancelling never perturbs the order of surviving events.
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import Any, Iterator


@dataclass
class Event:
    """One scheduled occurrence at virtual ``time``.

    ``payload`` is engine-defined (cid / tier / planned offset / ...).
    ``seq`` breaks time ties deterministically by insertion order.
    """

    time: float
    kind: str
    payload: dict = field(default_factory=dict)
    seq: int = 0
    cancelled: bool = False

    def cancel(self) -> None:
        self.cancelled = True


class EventQueue:
    """Virtual clock + min-heap of events with deterministic tie-breaking."""

    def __init__(self, start_time: float = 0.0):
        self.now = float(start_time)
        self._heap: list[tuple[float, int, Event]] = []
        self._seq = 0

    # ------------------------------------------------------------------
    def push(self, time: float, kind: str, **payload: Any) -> Event:
        """Schedule ``kind`` at absolute virtual ``time`` (>= now)."""
        if time < self.now:
            raise ValueError(f"cannot schedule into the past: {time} < now={self.now}")
        ev = Event(float(time), kind, payload, seq=self._seq)
        heapq.heappush(self._heap, (ev.time, ev.seq, ev))
        self._seq += 1
        return ev

    def push_in(self, delay: float, kind: str, **payload: Any) -> Event:
        """Schedule ``kind`` ``delay`` virtual seconds from now."""
        return self.push(self.now + float(delay), kind, **payload)

    # ------------------------------------------------------------------
    def pop(self) -> Event | None:
        """Next live event; advances the clock to its time."""
        while self._heap:
            _, _, ev = heapq.heappop(self._heap)
            if ev.cancelled:
                continue
            self.now = ev.time
            return ev
        return None

    def peek_time(self) -> float | None:
        while self._heap and self._heap[0][2].cancelled:
            heapq.heappop(self._heap)
        return self._heap[0][0] if self._heap else None

    def drain_until(self, time: float) -> Iterator[Event]:
        """Pop (and yield) every live event with ``ev.time <= time``, then
        advance the clock to ``time`` even if nothing was due."""
        while True:
            t = self.peek_time()
            if t is None or t > time:
                break
            yield self.pop()
        self.now = max(self.now, float(time))

    def advance_to(self, time: float) -> None:
        """Move the clock forward with no event (e.g. a serial server phase)."""
        if time < self.now:
            raise ValueError(f"clock cannot move backwards: {time} < {self.now}")
        self.now = float(time)

    # ------------------------------------------------------------------
    def __len__(self) -> int:
        return sum(0 if ev.cancelled else 1 for _, _, ev in self._heap)

    def empty(self) -> bool:
        # O(1) amortized (peek_time pops tombstones once each), unlike the
        # O(n) live count in __len__ — drain loops call this per event
        return self.peek_time() is None
