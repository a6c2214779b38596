"""Lane TCP ("ltcp"): the fixed-size, segment-counting TCP law.

The transport tier that runs **inside the lane program** (SURVEY §7
step 6: "fixed-size per-connection state records so TCP state can later
live in HBM lanes").  This module is the *scalar* form of the law — the
CPU-backend oracle that the vectorized twin in ``backend/lanes.py`` is
diffed against, exactly like ``net/codel.py`` / ``net/token_bucket.py``.

Relation to the reference: the full sans-I/O byte-stream TCP
(``transport/tcp.py``, rebuilding src/lib/tcp + tcp_cong_reno.c) serves
managed processes and byte-accurate workloads on the CPU backend; *this*
tier trades byte granularity for a fixed-size integer state record per
flow so that thousands of connections advance as masked vector arithmetic
on device.  It is still a real TCP: 3-way handshake, cumulative ACKs,
flow control by a fixed receive window, slow start, congestion avoidance,
fast retransmit / NewReno fast recovery (tcp_cong_reno.c's laws in
segment units), RFC 6298 RTO with exponential backoff and Karn's rule,
and FIN teardown.  Simplifications (documented in docs/SEMANTICS.md):
sequence numbers count MSS-sized *segments*, the receiver accepts only
in-order segments (go-back-N; no SACK/reassembly buffer), every data
segment is ACKed immediately (no delayed ACK), and the receive window is
a constant.

All arithmetic is integer; every decision is a pure function of the flow
record — the vector form applies the same updates under masks.

Sequence-unit space of a flow transferring ``segs`` data segments:

    0            SYN            (client) / SYN-ACK (server)
    1..segs      data           (client only; server's unit 1 is its FIN)
    segs+1       FIN            (client)

Wire segments carry ``(flags, seq, ack)``; ACKs are cumulative in the
peer's unit space.  Control segments cost HDR_BYTES on the wire; data
segment ``i`` costs ``HDR_BYTES + mss`` (the final one
``HDR_BYTES + last_bytes``).

The JAX package's ``net/ltcp.py``, copied into the port unchanged in law
(plain Python and numpy, no JAX).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from ..core.time import NEVER

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

# -- congestion control constants (integer, fixed-point cwnd) ---------------
FP = 1024  # cwnd fixed-point: FP units = 1 segment
INIT_CWND_FP = 10 * FP  # RFC 6928 initial window, segment units
INIT_SSTHRESH_FP = 1 << 30
MIN_SSTHRESH_FP = 2 * FP
DUP_THRESH = 3

# -- congestion control algorithms (tcp_cong.c's pluggable interface,
# realized as a per-flow selector so the vector form stays branch-free) -----
CC_RENO = 0
CC_CUBIC = 1
CC_BY_NAME = {"reno": CC_RENO, "cubic": CC_CUBIC}

# CUBIC (RFC 9438 / tcp_cubic.c) as pure int32-safe fixed point.  The
# window law is W(t) = C*(t-K)^3 + W_origin with C = 0.4 segs/s^3 and
# beta = 0.3.  Time is measured in "q units" of 2**20 ns (~1.05 ms) and a
# second is approximated as 2**30 ns (a documented 7.4% stretch: the law
# is DEFINED by this fixed-point algorithm, identically in the scalar and
# vector twins, not by real-valued CUBIC):
CUBIC_BETA_MUL = 717  # ~0.70 * 1024: multiplicative decrease on loss
CUBIC_FC_MUL = 870  # ~0.85 * 1024 = (2-beta)/2: fast-convergence shrink
CUBIC_C_MUL = 410  # ~0.40 * 1024: the C coefficient of the cubic term
# K in q units satisfies K_q^3 = diff_fp * 2**20 / 0.4 = diff_fp * 64*40960,
# so K_q = 4 * icbrt32(diff_fp * 40960); diff_fp <= MAX_CWND_FP keeps the
# argument inside int32 (49152 * 40960 < 2**31)
CUBIC_K_MUL = 40960
CUBIC_D_MAX = 8192  # epoch-age clamp, q units (~8.8 s; window saturates
# far earlier: the cubic term at D_MAX is ~205 segments)
# Constant advertised receive window.  Sized so one full flight (plus
# cross-traffic and timer arms) fits the lane backend's default bounded
# queue capacity with headroom: every in-flight segment is a resident
# event in the receiver's fixed-shape lane queue.  At the simulated
# RTTs this is the per-flow throughput cap (24 * MSS / RTT).
RWND_SEGS = 24
MAX_CWND_FP = 2 * RWND_SEGS * FP  # growth past the window is pointless
# Transmission-opportunity budget: every stimulus ends with an epilogue
# that transmits up to this many window-permitted units (real stacks
# likewise burst the permitted window per ACK).  At RWND_SEGS the window
# always exhausts before the budget, so a same-instant pump event is
# never queued — the lane backend's wide event co-pop relies on that.
PUMP_BURST = RWND_SEGS

# -- RTO constants (RFC 6298, ns) ------------------------------------------
RTO_INIT = 1_000_000_000  # 1 s
RTO_MIN = 200_000_000  # 200 ms (Linux's floor)
RTO_MAX = 60_000_000_000  # 60 s
# Give-up bound (Linux's tcp_retries2 analog): after this many CONSECUTIVE
# timeouts with no forward progress the flow aborts (state -> DONE,
# Emit.aborted) instead of retransmitting forever into a dead link — the
# fault-injection subsystem makes permanently-dark paths a first-class
# scenario.  The backoff counter resets on any new-data ACK.  NOTE: the
# vectorized lane twin (backend/lanes_stream.py) retains unbounded retries;
# the laws diverge only after MAX_RTO_BACKOFFS consecutive timeouts (over
# two minutes of cumulative RTO under the doubling law), far beyond the
# lane backend's supported windows — documented in docs/faults.md.
MAX_RTO_BACKOFFS = 8

HDR_BYTES = 40  # IP (20) + TCP (20) wire overhead per segment


@dataclasses.dataclass
class FlowState:
    """One TCP flow's fixed-size record (every field an integer — the
    vector form stores each as an [N, F] array column)."""

    role: int = SENDER
    state: int = CLOSED
    # transfer shape (static per flow)
    segs: int = 0  # number of data segments (sender side)
    mss: int = 1448
    last_bytes: int = 1448  # payload of the final data segment
    # sequence state (segment units)
    snd_una: int = 0
    snd_nxt: int = 0
    rcv_nxt: int = 0
    # congestion control
    cc: int = CC_RENO  # CC_RENO | CC_CUBIC (static per flow)
    cwnd_fp: int = INIT_CWND_FP
    ssthresh_fp: int = INIT_SSTHRESH_FP
    dup_acks: int = 0
    # CUBIC state (inert under CC_RENO)
    w_max_fp: int = 0  # window size at the last loss event
    cub_origin_fp: int = 0  # the epoch's plateau (W_origin)
    cub_epoch: int = NEVER  # epoch start, ns (NEVER = no epoch yet)
    cub_k_q: int = 0  # K in q units (2**20 ns)
    in_rec: bool = False  # fast recovery (until ack >= recover)
    recover: int = 0  # snd_nxt at loss detection
    max_sent: int = 0  # highest unit ever transmitted + 1 (retransmit marker)
    # RTT estimation (RFC 6298; srtt < 0 = no sample yet)
    srtt: int = -1
    rttvar: int = 0
    rto: int = RTO_INIT
    rtt_seq: int = -1  # unit being timed (-1 = none; Karn's rule)
    rtt_ts: int = 0
    # retransmission timer
    rto_deadline: int = NEVER  # when the pending data times out
    rto_evt: int = NEVER  # time of the queued RTO event (dedup law)
    backoffs: int = 0  # consecutive timeouts since the last new-data ACK
    # stats
    tx_segs: int = 0
    rx_segs: int = 0
    rx_bytes: int = 0
    retransmits: int = 0


@dataclasses.dataclass
class Emit:
    """What one stimulus produces (the scalar form of the lane channels):
    at most one control segment plus a burst of up to PUMP_BURST data
    segments (every handler ends with the transmission-opportunity
    epilogue), plus pump/RTO local-event arms."""

    sends: list = dataclasses.field(default_factory=list)  # (flags, seq, ack, size)
    # parallel to ``sends``: True for retransmitted units (flowtrace's
    # FT_RETRANSMIT send-stage marker; pure ACKs are always False)
    retx: list = dataclasses.field(default_factory=list)
    arm_pump: bool = False  # queue a pump event at the current time
    arm_rto: Optional[int] = None  # queue an RTO event at this time
    completed: bool = False  # flow reached DONE on this stimulus
    aborted: bool = False  # gave up after MAX_RTO_BACKOFFS timeouts

    @property
    def send(self):  # first send (compat accessor for single-send paths)
        return self.sends[0] if self.sends else None


# ---------------------------------------------------------------------------
# law helpers (each maps to a masked vector expression in lanes.py)
# ---------------------------------------------------------------------------


def seg_wire_size(fs: FlowState, unit: int) -> int:
    """Wire size of the segment carrying sequence unit ``unit``."""
    if 1 <= unit <= fs.segs:
        payload = fs.last_bytes if unit == fs.segs else fs.mss
        return HDR_BYTES + payload
    return HDR_BYTES  # SYN / FIN / pure control


def seg_flags(fs: FlowState, unit: int) -> int:
    """Flags of the segment carrying unit ``unit`` (role-dependent)."""
    if unit == 0:
        return F_SYN if fs.role == SENDER else (F_SYN | F_ACK)
    if fs.role == SENDER and 1 <= unit <= fs.segs:
        return F_DATA | F_ACK
    return F_FIN | F_ACK  # sender unit segs+1, receiver unit 1


def icbrt32(x: int) -> int:
    """floor(cbrt(x)) for 0 <= x < 2**31 by the classic bitwise method —
    11 fixed iterations; the vector twin (lanes_stream._icbrt32_vec)
    unrolls the identical loop."""
    y = 0
    for s in range(30, -1, -3):
        y += y
        b = 3 * y * (y + 1) + 1
        if (x >> s) >= b:
            x -= b << s
            y += 1
    return y


def cc_on_loss(fs: FlowState) -> None:
    """Multiplicative decrease at loss detection (fast-retransmit entry
    and RTO): set ssthresh by the flow's algorithm; CUBIC additionally
    records W_max (with fast convergence) and resets its epoch."""
    if fs.cc == CC_CUBIC:
        if fs.cwnd_fp < fs.w_max_fp:  # fast convergence
            fs.w_max_fp = (fs.cwnd_fp * CUBIC_FC_MUL) >> 10
        else:
            fs.w_max_fp = fs.cwnd_fp
        fs.cub_epoch = NEVER
        fs.ssthresh_fp = max(
            (fs.cwnd_fp * CUBIC_BETA_MUL) >> 10, MIN_SSTHRESH_FP
        )
    else:
        fs.ssthresh_fp = max(flight(fs) * FP // 2, MIN_SSTHRESH_FP)


def cc_grow_ca(fs: FlowState, now: int) -> None:
    """Congestion-avoidance growth for one new ACK (cwnd >= ssthresh).
    Reno: +1/cwnd per ACK.  CUBIC: advance toward the cubic target."""
    if fs.cc != CC_CUBIC:
        fs.cwnd_fp += max(1, (FP * FP) // fs.cwnd_fp)
        return
    if fs.cub_epoch == NEVER:  # new epoch starts at the first CA ACK
        fs.cub_epoch = now
        if fs.cwnd_fp < fs.w_max_fp:
            fs.cub_origin_fp = fs.w_max_fp
            fs.cub_k_q = 4 * icbrt32((fs.w_max_fp - fs.cwnd_fp) * CUBIC_K_MUL)
        else:
            fs.cub_origin_fp = fs.cwnd_fp
            fs.cub_k_q = 0
    d_q = min((now - fs.cub_epoch) >> 20, CUBIC_D_MAX)
    offs = d_q - fs.cub_k_q
    neg = offs < 0
    if neg:
        offs = -offs
    if offs > CUBIC_D_MAX:
        offs = CUBIC_D_MAX
    delta_fp = (((((offs * offs) >> 10) * offs) >> 10) * CUBIC_C_MUL) >> 10
    target_fp = (
        fs.cub_origin_fp - delta_fp if neg else fs.cub_origin_fp + delta_fp
    )
    if target_fp > fs.cwnd_fp:
        fs.cwnd_fp += max(1, (target_fp - fs.cwnd_fp) * FP // fs.cwnd_fp)
    else:  # at/above the curve: minimal probing growth (~1%/ACK)
        fs.cwnd_fp += max(1, (FP * FP) // (100 * fs.cwnd_fp))


def cwnd_segs(fs: FlowState) -> int:
    return fs.cwnd_fp // FP


def flight(fs: FlowState) -> int:
    return fs.snd_nxt - fs.snd_una


def can_send_new(fs: FlowState) -> bool:
    """May this flow transmit its next new sequence unit right now?"""
    if fs.role != SENDER or fs.state != ESTAB:
        return False
    if fs.snd_nxt > fs.segs + 1:  # everything (incl. FIN) already sent
        return False
    return flight(fs) < min(cwnd_segs(fs), RWND_SEGS)


def _rtt_sample(fs: FlowState, now: int) -> None:
    """RFC 6298 integer update from the timed unit's ACK."""
    r = now - fs.rtt_ts
    if r < 0:
        r = 0
    if fs.srtt < 0:
        fs.srtt = r
        fs.rttvar = r // 2
    else:
        delta = fs.srtt - r
        if delta < 0:
            delta = -delta
        fs.rttvar = (3 * fs.rttvar + delta) // 4
        fs.srtt = (7 * fs.srtt + r) // 8
    rto = fs.srtt + max(4 * fs.rttvar, 1_000_000)  # 1 ms granularity floor
    fs.rto = min(max(rto, RTO_MIN), RTO_MAX)


def _restart_rto(fs: FlowState, now: int, em: Emit) -> None:
    """(Re)start the retransmission timer for outstanding data.

    Event dedup law: ``rto_evt`` is the time of the single *owning* queued
    RTO event.  A new event is queued only when there is none, or when the
    live deadline moved **earlier** than the owner (an RTT sample shrank
    the RTO) — the superseded event becomes stale and is ignored by the
    ownership check in :func:`on_rto_event`.  An owner that pops before
    the live deadline re-arms itself at the then-current deadline."""
    fs.rto_deadline = now + fs.rto
    if fs.rto_evt == NEVER or fs.rto_deadline < fs.rto_evt:
        fs.rto_evt = fs.rto_deadline
        em.arm_rto = fs.rto_deadline


def _emit_unit(fs: FlowState, unit: int, em: Emit, retransmit: bool) -> None:
    em.sends.append(
        (seg_flags(fs, unit), unit, fs.rcv_nxt, seg_wire_size(fs, unit))
    )
    em.retx.append(retransmit)
    fs.tx_segs += 1
    if retransmit:
        fs.retransmits += 1
        if fs.rtt_seq >= 0 and unit <= fs.rtt_seq:
            fs.rtt_seq = -1  # Karn: never time a retransmitted unit
    elif fs.rtt_seq < 0:
        fs.rtt_seq = unit
    if unit + 1 > fs.max_sent:
        fs.max_sent = unit + 1


def _pull_back(fs: FlowState, now: int, em: Emit) -> None:
    """Go-back-N loss response: rewind ``snd_nxt`` to the hole, retransmit
    it, and let the epilogue pump re-stream everything after it (the
    receiver discarded all out-of-order units anyway)."""
    fs.snd_nxt = fs.snd_una + 1
    if fs.role == SENDER and fs.state == FIN_WAIT:
        fs.state = ESTAB  # the FIN will be re-sent when the stream re-walks
    _emit_unit(fs, fs.snd_una, em, retransmit=True)
    _restart_rto(fs, now, em)


def _pump_units(fs: FlowState, now: int, em: Emit, budget: int) -> None:
    """The transmission-opportunity epilogue: transmit up to ``budget``
    window-permitted units (new data or go-back-N re-stream below
    ``max_sent``), re-arm the pump only if room remains — with
    budget == PUMP_BURST the window always exhausts first, so the re-arm
    never fires (see PUMP_BURST)."""
    sent = 0
    while sent < budget and can_send_new(fs):
        unit = fs.snd_nxt
        fs.snd_nxt += 1
        retransmit = unit < fs.max_sent
        if not retransmit and fs.rtt_seq < 0:
            fs.rtt_ts = now
        _emit_unit(fs, unit, em, retransmit=retransmit)
        if unit == fs.segs + 1:
            fs.state = FIN_WAIT
        _restart_rto(fs, now, em)
        sent += 1
    if can_send_new(fs):
        em.arm_pump = True


# ---------------------------------------------------------------------------
# stimulus handlers
# ---------------------------------------------------------------------------


def open_flow(fs: FlowState, now: int) -> Emit:
    """Active open (client start): send SYN, arm the timer."""
    em = Emit()
    fs.state = SYN_SENT
    fs.snd_nxt = 1
    _emit_unit(fs, 0, em, retransmit=False)
    fs.rtt_ts = now
    _restart_rto(fs, now, em)
    _pump_units(fs, now, em, PUMP_BURST)  # no-op in SYN_SENT (uniform law)
    return em


def on_pump(fs: FlowState, now: int) -> Emit:
    """A transmission-opportunity event: burst up to PUMP_BURST permitted
    units (kept for law completeness — with the epilogue on every
    stimulus, pump events are no longer queued)."""
    em = Emit()
    _pump_units(fs, now, em, PUMP_BURST)
    return em


def on_rto_event(fs: FlowState, now: int) -> Emit:
    """A queued RTO event fired.  Ownership law: only the event at time
    ``rto_evt`` speaks for the timer (others were superseded by an earlier
    re-arm).  Staleness law: if the live deadline moved later, re-arm
    there; if no data is outstanding, lapse.  Processing always moves
    ``rto_evt`` off ``now``, so a coincidentally-reused time cannot
    double-fire.  Ends with the uniform transmission-opportunity epilogue
    (a no-op on the stale/lapse/re-arm paths: those change no send
    state)."""
    em = _on_rto_inner(fs, now)
    _pump_units(fs, now, em, PUMP_BURST)
    return em


def _on_rto_inner(fs: FlowState, now: int) -> Emit:
    em = Emit()
    if now != fs.rto_evt:
        return em  # stale (superseded) event
    fs.rto_evt = NEVER
    if fs.rto_deadline == NEVER or flight(fs) <= 0:
        return em
    if now < fs.rto_deadline:
        fs.rto_evt = fs.rto_deadline
        em.arm_rto = fs.rto_deadline
        return em
    # timeout: give up after MAX_RTO_BACKOFFS consecutive expiries (the
    # path is dead — e.g. a fault-schedule link_down with no reroute);
    # otherwise collapse the window, back off (the exponential growth is
    # hard-capped at RTO_MAX), and go-back-N from the hole
    fs.backoffs += 1
    if fs.backoffs > MAX_RTO_BACKOFFS:
        fs.state = DONE
        fs.rto_deadline = NEVER
        em.aborted = True
        return em
    cc_on_loss(fs)
    fs.cwnd_fp = FP
    fs.dup_acks = 0
    fs.in_rec = False
    fs.rto = min(fs.rto * 2, RTO_MAX)
    _pull_back(fs, now, em)
    return em


def on_segment(
    fs: FlowState, now: int, flags: int, seq: int, ack: int, size: int = HDR_BYTES
) -> Emit:
    """An inbound wire segment for this flow.  ``size`` is the wire size
    (engine delivery size); data payload is ``size - HDR_BYTES`` so neither
    side needs the peer's transfer-shape tables.  Like every stimulus, ends
    with the transmission-opportunity epilogue (burst pump)."""
    em = _on_segment_inner(fs, now, flags, seq, ack, size)
    _pump_units(fs, now, em, PUMP_BURST)
    return em


def _on_segment_inner(
    fs: FlowState, now: int, flags: int, seq: int, ack: int, size: int
) -> Emit:
    em = Emit()
    if fs.state == DONE:
        # dup FIN from a peer that missed our final ACK: re-ACK it
        if fs.role == SENDER and flags & F_FIN:
            em.sends.append((F_ACK, fs.snd_nxt, fs.rcv_nxt, HDR_BYTES))
            em.retx.append(False)
        return em

    # -- passive open -------------------------------------------------------
    if fs.role == RECEIVER and fs.state == CLOSED:
        if not (flags & F_SYN) or flags & F_ACK:
            return em  # not a connection attempt; ignore
        fs.state = SYN_RCVD
        fs.rcv_nxt = 1
        fs.snd_nxt = 1
        _emit_unit(fs, 0, em, retransmit=False)
        fs.rtt_ts = now
        _restart_rto(fs, now, em)
        return em
    if fs.role == RECEIVER and fs.state == SYN_RCVD and flags & F_SYN and not (flags & F_ACK):
        # retransmitted SYN: our SYN-ACK was lost or is in flight; resend
        _emit_unit(fs, 0, em, retransmit=True)
        _restart_rto(fs, now, em)
        return em

    # -- ACK processing (every post-handshake segment carries one) ----------
    if flags & F_ACK:
        if ack > fs.snd_una:
            acked = ack - fs.snd_una
            fs.snd_una = ack
            fs.backoffs = 0  # forward progress: the retry budget refills
            if fs.snd_nxt < fs.snd_una:
                # a delayed ACK (sent before a spurious RTO's go-back-N
                # rewind) may cover units above the rewound snd_nxt; clamp
                # so flight() can't go negative and the pump can't
                # re-stream units the receiver already acknowledged
                fs.snd_nxt = fs.snd_una
            if fs.state == SYN_SENT:
                fs.state = ESTAB
                fs.rcv_nxt = 1  # the SYN-ACK consumed the peer's unit 0
            elif fs.state == SYN_RCVD:
                fs.state = ESTAB
            if fs.in_rec:
                if ack >= fs.recover:  # full ack: leave recovery, deflate
                    fs.cwnd_fp = fs.ssthresh_fp
                    fs.in_rec = False
                    fs.dup_acks = 0
                # partial ack: stay in recovery, the pump is re-streaming
            else:
                fs.dup_acks = 0
                if fs.cwnd_fp < fs.ssthresh_fp:  # slow start (byte counting)
                    fs.cwnd_fp += acked * FP
                else:  # congestion avoidance (per-algorithm growth)
                    cc_grow_ca(fs, now)
                fs.cwnd_fp = min(fs.cwnd_fp, MAX_CWND_FP)
            if fs.rtt_seq >= 0 and ack > fs.rtt_seq:
                _rtt_sample(fs, now)
                fs.rtt_seq = -1
            if flight(fs) > 0:
                _restart_rto(fs, now, em)
            else:
                fs.rto_deadline = NEVER
        elif ack == fs.snd_una and flight(fs) > 0 and not (flags & (F_DATA | F_SYN | F_FIN)):
            # pure duplicate ACK
            if fs.in_rec:
                fs.cwnd_fp += FP  # fast-recovery inflation
            else:
                fs.dup_acks += 1
                if fs.dup_acks == DUP_THRESH:
                    fs.in_rec = True
                    fs.recover = fs.snd_nxt
                    cc_on_loss(fs)
                    fs.cwnd_fp = fs.ssthresh_fp + DUP_THRESH * FP
                    _pull_back(fs, now, em)

    # -- sender-side teardown ----------------------------------------------
    if fs.role == SENDER:
        if flags & F_FIN and fs.snd_una == fs.segs + 2:
            # server's FIN (its unit 1), and everything of ours (incl. our
            # FIN) is acked — by this segment or earlier
            fs.rcv_nxt = 2
            em.sends.append((F_ACK, fs.snd_nxt, fs.rcv_nxt, HDR_BYTES))
            em.retx.append(False)
            fs.state = DONE
            fs.rto_deadline = NEVER
            em.completed = True
        # a window opened by this ACK is streamed by the epilogue pump
        return em

    # -- receiver-side data path -------------------------------------------
    if fs.state in (SYN_RCVD, ESTAB) and flags & F_SYN and flags & F_ACK:
        return em  # stray SYN-ACK (we are the receiver); ignore
    if fs.state == ESTAB or fs.state == SYN_RCVD:
        if flags & F_DATA:
            if seq == fs.rcv_nxt:
                fs.rcv_nxt += 1
                fs.rx_segs += 1
                fs.rx_bytes += size - HDR_BYTES
            # ACK everything (in-order advance or duplicate for OOO)
            em.sends.append((F_ACK, fs.snd_nxt, fs.rcv_nxt, HDR_BYTES))
            em.retx.append(False)
        elif flags & F_FIN:
            if seq == fs.rcv_nxt:
                # client's FIN in order: consume it, answer with our FIN+ACK
                fs.rcv_nxt += 1
                unit = fs.snd_nxt
                fs.snd_nxt += 1
                if fs.rtt_seq < 0:
                    fs.rtt_ts = now
                _emit_unit(fs, unit, em, retransmit=False)
                fs.state = LAST_ACK
                _restart_rto(fs, now, em)
            else:
                em.sends.append((F_ACK, fs.snd_nxt, fs.rcv_nxt, HDR_BYTES))
                em.retx.append(False)
    elif fs.state == LAST_ACK:
        if fs.snd_una >= 2:
            # the final ACK arrived (processed above): teardown complete
            fs.state = DONE
            fs.rto_deadline = NEVER
            em.completed = True
        elif (flags & (F_DATA | F_FIN)) and seq < fs.rcv_nxt:
            # stale retransmission: the peer missed our FIN+ACK (or its
            # cumulative ack); resend it so the flow can't deadlock
            _emit_unit(fs, fs.snd_una, em, retransmit=True)
            _restart_rto(fs, now, em)
    return em


def segs_for_size(size_bytes: int, mss: int) -> tuple[int, int]:
    """Split a transfer size into (segments, last_segment_bytes)."""
    if size_bytes <= 0:
        return 0, mss
    segs = -(-size_bytes // mss)
    last = size_bytes - (segs - 1) * mss
    return segs, last
