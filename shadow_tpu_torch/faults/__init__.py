"""Fault schedules on the lane engine: the JAX package's ``faults``
subsystem, trimmed to what a lane run needs.

- :mod:`.schedule` — the declarative, validated ``faults:`` schedule:
  link down/up, per-edge loss and latency changes, partitions, host
  crash/restart and injected backend stalls, each at a simulated time.
- :mod:`.overlay` — the schedule compiled into one ``(latency_ns,
  packet_loss, loss_threshold)`` table snapshot per fault epoch, which
  ``GpuEngine`` and ``SweepEngine`` upload between run segments.

A ``backend_stall`` epoch makes the engine raise
:class:`BackendStallError`; the watchdog and the CPU failover that catch
it in the JAX package wait for the port's host half.
"""

from .schedule import FaultConfigError, FaultEvent, FaultSchedule


class BackendStallError(RuntimeError):
    """A lane run stalled, failed, or was injected to fail."""


__all__ = ["BackendStallError", "FaultConfigError", "FaultEvent",
           "FaultSchedule"]
