"""Async buffered logging with simulated-time prefixes.

The JAX package's ``utils/shadow_log.py`` on the port.

The reference's logger crate (src/lib/logger + log-c2rust) buffers log
records and writes them from a dedicated thread so the simulation hot
path never blocks on stderr I/O, and prefixes every line with the
simulated clock.  This is the Python analog:

- emission enqueues the record on a ``QueueHandler`` (no formatting, no
  I/O on the caller's thread — workers and host-execution threads pay an
  append);
- a ``QueueListener`` thread formats and writes;
- a filter injects ``%(simtime)s`` from the registered provider (the
  running engine's clock), so operator lines interleave in simulated
  order context exactly like the reference's output.

``install_async_logging`` is idempotent; ``shutdown`` (also registered
atexit) drains the queue so a crashing run still flushes its tail.
"""

from __future__ import annotations

import atexit
import logging
import logging.handlers
import queue
from typing import Callable, Optional

from ..core import time as stime

# the running engine registers its clock here (sim ns); None = no sim
_sim_time_provider: Optional[Callable[[], int]] = None
_listener: Optional[logging.handlers.QueueListener] = None


def set_sim_time_provider(fn: Optional[Callable[[], int]]) -> None:
    """Register (or clear) the simulated-clock source for log prefixes."""
    global _sim_time_provider
    _sim_time_provider = fn


class _SimTimeFilter(logging.Filter):
    def filter(self, record: logging.LogRecord) -> bool:
        fn = _sim_time_provider
        if fn is not None:
            try:
                record.simtime = stime.fmt(fn())
            except Exception:
                record.simtime = "--"
        else:
            record.simtime = "--"
        return True


def install_async_logging(
    level: int = logging.INFO, stream=None
) -> logging.handlers.QueueListener:
    """Route the root logger through an async queue (idempotent: a second
    call replaces the previous listener, flushing it first)."""
    global _listener
    shutdown()
    q: "queue.SimpleQueue[logging.LogRecord]" = queue.SimpleQueue()
    out = logging.StreamHandler(stream)
    out.setFormatter(
        logging.Formatter(
            "%(asctime)s [%(simtime)s] %(levelname)s [%(name)s] %(message)s"
        )
    )
    qh = logging.handlers.QueueHandler(q)
    qh.addFilter(_SimTimeFilter())
    root = logging.getLogger()
    for h in list(root.handlers):
        root.removeHandler(h)
    root.addHandler(qh)
    root.setLevel(level)
    _listener = logging.handlers.QueueListener(q, out)
    _listener.start()
    return _listener


def shutdown() -> None:
    """Stop the listener, draining every queued record first."""
    global _listener
    if _listener is not None:
        try:
            _listener.stop()
        except Exception:
            pass
        _listener = None


atexit.register(shutdown)
