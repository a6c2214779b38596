"""Lane TCP ("ltcp"): the constants and flow sizing of the segment-counting
TCP law that the stream models run.

A trimmed copy of the JAX package's ``net/ltcp.py``: the wire flags, flow
states, roles, congestion-control and RTO constants, the transfer sizing
and the scalar integer cube root.  The scalar law itself stays in the JAX
package (its CPU oracle); the port runs the vector law of
``backend/lanes_stream.py`` and kernel A, which read only what is here.

Sequence-unit space of a flow transferring ``segs`` data segments:

    0            SYN            (client) / SYN-ACK (server)
    1..segs      data           (client only; server's unit 1 is its FIN)
    segs+1       FIN            (client)

Control segments cost ``HDR_BYTES`` on the wire; data segment ``i`` costs
``HDR_BYTES + mss`` (the final one ``HDR_BYTES + last_bytes``).
"""

from __future__ import annotations

# -- wire flags -------------------------------------------------------------
F_SYN = 1
F_ACK = 2
F_FIN = 4
F_DATA = 8

# -- states (one enum for both roles) ---------------------------------------
CLOSED = 0  # client: not opened yet; server: LISTEN
SYN_SENT = 1  # client sent SYN
SYN_RCVD = 2  # server sent SYN-ACK
ESTAB = 3
FIN_WAIT = 4  # client sent FIN, waits for its ACK + server FIN
LAST_ACK = 5  # server sent FIN, waits for final ACK
DONE = 6

# -- roles ------------------------------------------------------------------
SENDER = 0  # active opener, streams data
RECEIVER = 1  # passive opener, sinks data

# -- congestion control (integer, fixed-point cwnd) --------------------------
FP = 1024  # cwnd fixed-point: FP units = 1 segment
INIT_CWND_FP = 10 * FP  # RFC 6928 initial window
INIT_SSTHRESH_FP = 1 << 30
MIN_SSTHRESH_FP = 2 * FP
DUP_THRESH = 3

CC_RENO = 0
CC_CUBIC = 1
CC_BY_NAME = {"reno": CC_RENO, "cubic": CC_CUBIC}

# CUBIC (RFC 9438) in int32-safe fixed point: W(t) = C*(t-K)^3 + W_origin,
# C = 0.4 segs/s^3, beta = 0.3; time in q units of 2**20 ns
CUBIC_BETA_MUL = 717  # ~0.70 * 1024: multiplicative decrease on loss
CUBIC_FC_MUL = 870  # ~0.85 * 1024: fast-convergence shrink
CUBIC_C_MUL = 410  # ~0.40 * 1024: the C coefficient
CUBIC_K_MUL = 40960  # K_q = 4 * icbrt32(diff_fp * CUBIC_K_MUL)
CUBIC_D_MAX = 8192  # epoch-age clamp, q units

# constant advertised receive window (segments); every in-flight segment
# is a resident event in the receiver's lane queue
RWND_SEGS = 24
MAX_CWND_FP = 2 * RWND_SEGS * FP
# every stimulus ends with a burst of up to PUMP_BURST window-permitted
# units; at RWND_SEGS the window always exhausts first, so no pump event
# is ever queued (the wide co-pop rule relies on that)
PUMP_BURST = RWND_SEGS

# -- RTO (RFC 6298, ns) ------------------------------------------------------
RTO_INIT = 1_000_000_000  # 1 s
RTO_MIN = 200_000_000  # 200 ms
RTO_MAX = 60_000_000_000  # 60 s

HDR_BYTES = 40  # IP (20) + TCP (20) wire overhead per segment


def segs_for_size(size_bytes: int, mss: int) -> tuple[int, int]:
    """Split a transfer size into (segments, last_segment_bytes)."""
    if size_bytes <= 0:
        return 0, mss
    segs = -(-size_bytes // mss)
    last = size_bytes - (segs - 1) * mss
    return segs, last


def icbrt32(x: int) -> int:
    """floor(cbrt(x)) for 0 <= x < 2**31 by the bitwise method — 11 fixed
    iterations; the vector twin (lanes_stream._icbrt32_vec) and kernel A
    unroll the identical loop."""
    y = 0
    for s in range(30, -1, -3):
        y += y
        b = 3 * y * (y + 1) + 1
        if (x >> s) >= b:
            x -= b << s
            y += 1
    return y
