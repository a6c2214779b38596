"""Span tracer with Chrome-trace (Perfetto-loadable) JSON export.

The JAX package's ``obs/tracer.py`` on the port.

Spans are *complete* events (``ph: "X"``) on the Chrome trace-event
timeline: wall-clock ``ts``/``dur`` in microseconds relative to tracer
start, one ``tid`` row per emitting thread, simulation context (window
end, row counts) in ``args``.  The exported file loads directly in
Perfetto (https://ui.perfetto.dev) or ``chrome://tracing``.

Recording is bounded: past ``capacity`` events new spans are counted as
dropped instead of growing without limit, so tracing a long run degrades
to truncation, never to an OOM.  Every mutation happens under one lock —
worker threads (host execution, schedulers) may emit concurrently.
"""

from __future__ import annotations

import json
import threading
import time as wall_time
from pathlib import Path
from typing import Optional

DEFAULT_CAPACITY = 500_000


class Tracer:
    def __init__(self, capacity: int = DEFAULT_CAPACITY) -> None:
        self.capacity = capacity
        self.events: list[dict] = []
        self.dropped = 0
        self.enabled = True  # run-control `trace on|off` toggles this
        self._lock = threading.Lock()
        self._tids: dict[str, int] = {}
        self.t0 = wall_time.perf_counter()

    # -- recording ---------------------------------------------------------

    def _tid(self) -> int:
        name = threading.current_thread().name
        tid = self._tids.get(name)
        if tid is None:
            tid = self._tids[name] = len(self._tids) + 1
        return tid

    def complete(
        self,
        name: str,
        cat: str,
        t0_abs: float,
        dur_s: float,
        args: Optional[dict] = None,
    ) -> None:
        """Record one complete span.  ``t0_abs`` is a
        ``wall_time.perf_counter()`` stamp (the same clock as ``self.t0``)."""
        if not self.enabled:
            return
        ev = {
            "name": name,
            "cat": cat,
            "ph": "X",
            "ts": (t0_abs - self.t0) * 1e6,
            "dur": dur_s * 1e6,
            "pid": 1,
        }
        if args:
            ev["args"] = args
        with self._lock:
            ev["tid"] = self._tid()
            if len(self.events) >= self.capacity:
                self.dropped += 1
            else:
                self.events.append(ev)

    def flow(
        self,
        phase: str,
        flow_id: int,
        name: str,
        cat: str,
        t_abs: float,
    ) -> None:
        """Record one flow event (``ph: "s"`` start / ``"f"`` finish),
        binding by enclosure to the slice containing ``t_abs`` on the
        emitting thread's row — the arrows that link a blocking device
        turn back to the syscall-service span that forced it
        (obs/turns.py).  ``t_abs`` is a ``wall_time.perf_counter()``
        stamp, like :meth:`complete`."""
        if not self.enabled:
            return
        ev = {
            "name": name,
            "cat": cat,
            "ph": phase,
            "id": flow_id,
            "ts": (t_abs - self.t0) * 1e6,
            "pid": 1,
        }
        if phase == "f":
            ev["bp"] = "e"  # bind the finish to its enclosing slice
        with self._lock:
            ev["tid"] = self._tid()
            if len(self.events) >= self.capacity:
                self.dropped += 1
            else:
                self.events.append(ev)

    def instant(self, name: str, cat: str, args: Optional[dict] = None) -> None:
        """Record an instant marker (``ph: "i"``) at the current wall time."""
        if not self.enabled:
            return
        ev = {
            "name": name,
            "cat": cat,
            "ph": "i",
            "s": "t",
            "ts": (wall_time.perf_counter() - self.t0) * 1e6,
            "pid": 1,
        }
        if args:
            ev["args"] = args
        with self._lock:
            ev["tid"] = self._tid()
            if len(self.events) >= self.capacity:
                self.dropped += 1
            else:
                self.events.append(ev)

    # -- introspection / export --------------------------------------------

    def span_count(self) -> int:
        with self._lock:
            return len(self.events)

    def export(self, path: str | Path, extra: Optional[dict] = None) -> Path:
        """Write the Chrome-trace JSON document.  Thread-name metadata
        events make the Perfetto rows readable."""
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        with self._lock:
            events = list(self.events)
            tids = dict(self._tids)
            dropped = self.dropped
        meta = [
            {
                "name": "thread_name",
                "ph": "M",
                "pid": 1,
                "tid": tid,
                "args": {"name": name},
            }
            for name, tid in sorted(tids.items(), key=lambda kv: kv[1])
        ]
        doc = {
            "traceEvents": meta + events,
            "displayTimeUnit": "ms",
            "otherData": {"producer": "shadow_tpu_torch.obs", "dropped": dropped},
        }
        if extra:
            doc["otherData"].update(extra)
        path.write_text(json.dumps(doc) + "\n")
        return path
