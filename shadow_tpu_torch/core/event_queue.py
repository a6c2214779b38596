"""Per-host min-heap event queue.

Host-side analog of the reference's ``EventQueue``
(src/main/core/work/event_queue.rs:11): a binary heap ordered by the total
event order of :mod:`shadow_tpu.core.event`.  Unlike the reference we do not
need a panicking-ord wrapper — Python tuple comparison is total on ints.

The queue also tracks ``next_time`` cheaply for the manager's per-round
min-next-event-time reduction (manager.rs:570-601).

The JAX package's ``core/event_queue.py``, copied into the port unchanged in law
(plain Python and numpy, no JAX).
"""

from __future__ import annotations

import heapq
from typing import Iterator, Optional

from .event import Event
from .time import NEVER


class EventQueue:
    __slots__ = ("_heap",)

    def __init__(self) -> None:
        self._heap: list[Event] = []

    def __len__(self) -> int:
        return len(self._heap)

    def push(self, ev: Event) -> None:
        heapq.heappush(self._heap, ev)

    def peek(self) -> Optional[Event]:
        return self._heap[0] if self._heap else None

    def next_time(self) -> int:
        """Time of the earliest event, or ``NEVER`` when empty."""
        return self._heap[0].time if self._heap else NEVER

    def pop(self) -> Event:
        return heapq.heappop(self._heap)

    def pop_until(self, until: int) -> Iterator[Event]:
        """Pop events with ``time < until`` in total order (the body of
        ``Host::execute`` — host.rs:769-803)."""
        while self._heap and self._heap[0].time < until:
            yield heapq.heappop(self._heap)

    def drain(self) -> Iterator[Event]:
        while self._heap:
            yield heapq.heappop(self._heap)
