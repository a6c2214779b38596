"""CoDel active queue management constants (RFC 8289 shaped, all-integer).

The lane kernels run the CoDel law of docs/SEMANTICS.md on these
constants (counterpart of the reference's router CoDel queue,
src/main/network/router/codel_queue.rs:20-34, TARGET=10ms /
INTERVAL=100ms).  The RFC's ``interval / sqrt(drop_count)`` control law is
realized through a precomputed integer table so every backend divides
identically (no device float sqrt in the control path).
"""

from __future__ import annotations

import math

from ..core.time import NANOS_PER_MILLI

TARGET_NS = 10 * NANOS_PER_MILLI
INTERVAL_NS = 100 * NANOS_PER_MILLI

#: CODEL_DIV[k] = round(INTERVAL / sqrt(k)) for k in 0..=1024 (k=0 unused);
#: drop_count beyond 1024 clamps to the last entry.
DIV_TABLE_SIZE = 1025


def _build_div_table() -> list[int]:
    table = [INTERVAL_NS]  # k=0 placeholder
    for k in range(1, DIV_TABLE_SIZE):
        table.append(round(INTERVAL_NS / math.sqrt(k)))
    return table


CODEL_DIV: list[int] = _build_div_table()
