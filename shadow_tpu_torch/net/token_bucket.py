"""Integer token bucket for bandwidth enforcement.

Scalar reference implementation of the spec in docs/SEMANTICS.md (the lane
backend implements the identical arithmetic as a ``lax.scan``).
Behavioral counterpart of the reference's relay token bucket
(src/main/network/relay/token_bucket.rs:6-40): refill ``rate`` bits every
``interval`` ns up to ``burst``, serialize departures.

The JAX package's ``net/token_bucket.py``, copied into the port unchanged in law
(plain Python and numpy, no JAX).
"""

from __future__ import annotations

import dataclasses

from ..core.time import NANOS_PER_MILLI

#: default refill interval (the reference refills once per ms)
DEFAULT_INTERVAL_NS = NANOS_PER_MILLI

#: per-packet wire framing overhead in bytes (Ethernet-ish), charged on top
#: of the IP packet size
FRAME_OVERHEAD_BYTES = 24


def bucket_params(bits_per_sec: int, interval_ns: int = DEFAULT_INTERVAL_NS) -> tuple[int, int]:
    """(rate_bits_per_interval, burst_bits) for a configured bandwidth.

    Burst is one refill's worth but at least one full-size frame so that a
    single MTU packet can always depart (the reference sizes the bucket
    likewise from the configured bandwidth).
    """
    rate = max(1, (bits_per_sec * interval_ns) // 1_000_000_000)
    burst = max(rate, 12_000 + FRAME_OVERHEAD_BYTES * 8)  # ≥ one 1500B frame
    return rate, burst


@dataclasses.dataclass
class TokenBucket:
    """State: (tokens, next_refill, last_depart).  ``rate == 0`` means
    unlimited."""

    rate: int  # bits added per interval
    burst: int  # max tokens
    interval: int = DEFAULT_INTERVAL_NS
    tokens: int = -1  # set to burst in __post_init__
    next_refill: int = -1
    last_depart: int = 0
    # telemetry: charges that had to wait for a refill (tokens short
    # after the refill step) — the netobs "throttled" cause.  A pure
    # function of the charge sequence, so it is deterministic and the
    # lane kernels' wait mask counts the identical instants.
    throttles: int = 0

    def __post_init__(self) -> None:
        if self.tokens < 0:
            self.tokens = self.burst
        if self.next_refill < 0:
            self.next_refill = self.interval

    def charge(self, t: int, bits: int) -> int:
        """Charge ``bits`` at time ``t`` (non-decreasing across calls);
        returns the departure time.

        FIFO law: the charge clock is ``max(t, last_depart)`` — a packet
        that queued for a future refill moves the whole line behind it,
        so leftover tokens earned *at* that refill cannot let a later
        packet depart before an earlier one (departures are monotone)."""
        if self.rate == 0:
            return t
        t = max(t, self.last_depart)
        if t >= self.next_refill:
            k = (t - self.next_refill) // self.interval + 1
            self.tokens = min(self.burst, self.tokens + k * self.rate)
            self.next_refill += k * self.interval
        if self.tokens >= bits:
            self.tokens -= bits
            self.last_depart = t
            return t
        self.throttles += 1
        need = bits - self.tokens
        w = -(-need // self.rate)  # ceil
        depart = self.next_refill + (w - 1) * self.interval
        self.tokens = max(0, min(self.burst, self.tokens + w * self.rate) - bits)
        self.next_refill += w * self.interval
        self.last_depart = depart
        return depart
