"""CoDel active queue management (RFC 8289 shaped, all-integer).

Scalar reference implementation of the spec in docs/SEMANTICS.md; the lane
backend runs the identical arithmetic vectorized.  Counterpart of the
reference's router CoDel queue (src/main/network/router/codel_queue.rs:20-34,
TARGET=10ms / INTERVAL=100ms).

The RFC's ``interval / sqrt(drop_count)`` control law is realized through a
precomputed integer table so both backends divide identically (no device
float sqrt in the control path).

The JAX package's ``net/codel.py``, copied into the port unchanged in law
(plain Python and numpy, no JAX).
"""

from __future__ import annotations

import dataclasses
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


@dataclasses.dataclass
class CoDel:
    """Per-host inbound AQM state (see SEMANTICS.md for the exact law)."""

    first_above_time: int = 0
    drop_next: int = 0
    drop_count: int = 0
    dropping: bool = False

    def offer(self, t_deliver: int, sojourn_ns: int) -> bool:
        """Process one inbound packet (in arrival order); True = drop it."""
        ok_to_drop = False
        if sojourn_ns < TARGET_NS:
            self.first_above_time = 0
        else:
            if self.first_above_time == 0:
                self.first_above_time = t_deliver + INTERVAL_NS
            elif t_deliver >= self.first_above_time:
                ok_to_drop = True

        if self.dropping:
            if not ok_to_drop:
                self.dropping = False
            elif t_deliver >= self.drop_next:
                self.drop_count += 1
                self.drop_next += CODEL_DIV[min(self.drop_count, DIV_TABLE_SIZE - 1)]
                return True
        elif ok_to_drop and (
            t_deliver - self.drop_next < INTERVAL_NS
            or t_deliver - self.first_above_time >= INTERVAL_NS
        ):
            self.dropping = True
            if self.drop_count > 2 and t_deliver - self.drop_next < INTERVAL_NS:
                self.drop_count = 2
            else:
                self.drop_count = 1
            self.drop_next = t_deliver + CODEL_DIV[self.drop_count]
            return True
        return False
