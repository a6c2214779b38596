"""Simulation time primitives.

All simulation time is integer nanoseconds since the start of the
simulation; ``NEVER`` (max int64) means "no event pending".  Integer-only
time is what keeps the lane backend bit-identical to the JAX reference
and the scalar CPU oracle (no float rounding anywhere in event ordering).
"""

from __future__ import annotations

NANOS_PER_MICRO = 1_000
NANOS_PER_MILLI = 1_000_000
NANOS_PER_SEC = 1_000_000_000
NANOS_PER_MIN = 60 * NANOS_PER_SEC
NANOS_PER_HOUR = 3600 * NANOS_PER_SEC

#: max int64; "no pending event" sentinel, compares greater than any real time.
NEVER: int = (1 << 63) - 1


def from_secs(s: float | int) -> int:
    """Seconds -> integer ns.  Accepts ints exactly; floats are rounded."""
    if isinstance(s, int):
        return s * NANOS_PER_SEC
    return round(s * NANOS_PER_SEC)
