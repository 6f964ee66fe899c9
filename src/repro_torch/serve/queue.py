"""Admission queue for the rollout engine.

Requests wait here until the admission policy (``repro_torch.serve.sched``)
picks them and a KV-cache slot frees up.  The queue itself stays a plain
arrival-ordered sequence — *which* waiting request is admitted next is the
policy's decision (``FIFOPolicy`` always takes the head, so under FIFO no
late request can overtake an earlier one: the fairness property
``tests/test_serve_engine.py`` locks in).  ``pop_at`` exists so
deadline/SLO policies can skip a blocked head for an admissible, more
urgent request further back.

``push`` is a backpressure signal, not an assertion: when ``max_waiting``
is reached it returns ``False`` and the request is NOT enqueued, so trace
drivers and the coexec loop can defer re-submission instead of crashing
mid-flight.
"""
from __future__ import annotations

from collections import deque
from typing import Iterator, Optional

from repro_torch.serve.request import Request


class RequestQueue:
    """Bounded arrival-ordered queue of waiting :class:`Request` objects."""

    def __init__(self, max_waiting: Optional[int] = None):
        self._q: deque[Request] = deque()
        self.max_waiting = max_waiting
        self.rejected = 0                 # pushes refused for backpressure

    def __len__(self) -> int:
        return len(self._q)

    def __bool__(self) -> bool:
        return bool(self._q)

    def __iter__(self) -> Iterator[Request]:
        return iter(self._q)

    def __getitem__(self, i: int) -> Request:
        return self._q[i]

    @property
    def full(self) -> bool:
        return (self.max_waiting is not None
                and len(self._q) >= self.max_waiting)

    def push(self, req: Request) -> bool:
        """Enqueue ``req``; ``False`` = queue full (caller should defer and
        retry once the engine drains — nothing was enqueued)."""
        if self.full:
            self.rejected += 1
            return False
        self._q.append(req)
        return True

    def peek(self) -> Request:
        """Head of the queue without removing it (admission-gate check)."""
        return self._q[0]

    def pop(self) -> Request:
        return self._q.popleft()

    def pop_at(self, i: int) -> Request:
        """Remove and return the request at queue position ``i`` (policy
        head skipping; ``pop_at(0)`` is exactly ``pop``)."""
        if i == 0:
            return self._q.popleft()
        self._q.rotate(-i)
        req = self._q.popleft()
        self._q.rotate(i)
        return req
