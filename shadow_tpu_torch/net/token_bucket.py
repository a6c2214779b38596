"""Token-bucket parameters for bandwidth enforcement.

The lane kernels run the token-bucket law of docs/SEMANTICS.md (the
reference's relay token bucket, src/main/network/relay/token_bucket.rs:6-40:
refill ``rate`` bits every ``interval`` ns up to ``burst``, serialize
departures) on the parameters computed here.
"""

from __future__ import annotations

from ..core.time import NANOS_PER_MILLI

#: default refill interval (the reference refills once per ms)
DEFAULT_INTERVAL_NS = NANOS_PER_MILLI

#: per-packet wire framing overhead in bytes (Ethernet-ish), charged on top
#: of the IP packet size
FRAME_OVERHEAD_BYTES = 24


def bucket_params(bits_per_sec: int, interval_ns: int = DEFAULT_INTERVAL_NS) -> tuple[int, int]:
    """(rate_bits_per_interval, burst_bits) for a configured bandwidth.

    Burst is one refill's worth but at least one full-size frame so that a
    single MTU packet can always depart.
    """
    rate = max(1, (bits_per_sec * interval_ns) // 1_000_000_000)
    burst = max(rate, 12_000 + FRAME_OVERHEAD_BYTES * 8)  # ≥ one 1500B frame
    return rate, burst
