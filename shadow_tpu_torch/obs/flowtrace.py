"""Flowtrace: per-flow packet-lifecycle events of sampled flows.

The JAX package's ``obs/flowtrace.py``, trimmed to what the lane engine
needs: the event taxonomy, the seeded flow hash and its sampling
threshold, the decoding of the device ring's rows, and the canonical
order both sides of a parity comparison are held in.  The lane kernels
record the events on the device (``LaneParams.flowtrace``) into a bounded
``[FL, FT_COLS]`` int32 ring that never wraps; ``GpuEngine
.flowtrace_snapshot`` decodes it.

An event is eight integers::

    (t_ns, window_end_ns, kind, src, dst, seq, size, aux)

``kind`` is one of the ``FT_*`` codes; ``aux`` carries the drop cause of
an ``FT_DROP`` and the bucket direction of an ``FT_TB_WAIT``.  ``seq`` is
the source's send sequence number, so the stages of one wire packet join
on ``(src, dst, seq)``.  A flow ``(src, dst)`` is traced iff
``flow_hash(src, dst, 0, seed) < thresh`` with ``thresh = floor(sample *
2**32)``; ``sample >= 1`` traces every flow without evaluating the hash.
"""

from __future__ import annotations

import numpy as np

# lifecycle event kinds
FT_SEND = 0         # wire send accepted at the source (at the stimulus time)
FT_TB_WAIT = 1      # token-bucket deferral (at the bucket departure)
FT_QUEUE_ENTER = 2  # committed to the wire (at the arrival time)
FT_DROP = 3         # dropped; aux = cause
FT_RETRANSMIT = 4   # send stage of a retransmitted stream segment
FT_DELIVERY = 5     # delivered at the destination (at the delivery time)

# FT_DROP causes (the netobs taxonomy)
CAUSE_LOSS = 0
CAUSE_CODEL = 1
CAUSE_QUEUE = 2
CAUSE_CROSS_SHED = 3
CAUSE_RETRY_GIVEUP = 4

# FT_TB_WAIT: which bucket deferred
TB_UP = 0
TB_DN = 1

#: columns of a ring row: t_hi, t_lo, window-end hi, lo, kind, src, dst,
#: seq, size, aux — times as the lane kernels' bit-31 (hi, lo) pairs
FT_COLS = 10

_PAIR_BASE = 1 << 31
_MASK32 = 0xFFFFFFFF
# odd multipliers of the mix, then the murmur3 fmix32 finalizer
_M_SRC = 2654435761
_M_DST = 2246822519
_M_FID = 3266489917
_M_SEED = 668265263


def flow_hash(src: int, dst: int, fid: int, seed: int) -> int:
    """The u32 sampling hash of a flow (the lane kernels' ``flow_hash``,
    bit for bit: every step reduces mod 2**32)."""
    h = (src * _M_SRC + dst * _M_DST + fid * _M_FID + seed * _M_SEED) & _MASK32
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & _MASK32
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & _MASK32
    h ^= h >> 16
    return h


def sample_thresh(sample: float) -> tuple[int, bool]:
    """``(thresh_u32, all_pass)`` for a sampling fraction: ``sample >= 1``
    traces every flow, ``sample <= 0`` none."""
    if sample >= 1.0:
        return 0, True
    if sample <= 0.0:
        return 0, False
    return int(sample * float(1 << 32)) & _MASK32, False


def rows_to_events(rows) -> list[tuple]:
    """Ring rows (``[n, FT_COLS]`` int32) as event tuples, in ring order."""
    r = np.asarray(rows, dtype=np.int64).reshape(-1, FT_COLS)
    out = np.empty((r.shape[0], 8), dtype=np.int64)
    out[:, 0] = r[:, 0] * _PAIR_BASE + r[:, 1]
    out[:, 1] = r[:, 2] * _PAIR_BASE + r[:, 3]
    out[:, 2:] = r[:, 4:]
    return list(map(tuple, out.tolist()))


def canonical_events(raw, capacity: int) -> tuple[list[tuple], int]:
    """The export law: sorted by the whole tuple, then cut at
    ``capacity``, the excess counted as lost.  Two streams are compared
    only where neither side lost an event."""
    ev = sorted(tuple(e) for e in raw)
    lost = max(0, len(ev) - capacity)
    return (ev[:capacity] if lost else ev), lost
