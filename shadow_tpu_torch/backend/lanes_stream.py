"""Vectorized lane-TCP: the stream law on ``[2S]`` endpoint rows, in int32.

The PyTorch twin of the JAX package's ``backend/lanes_stream.py``, and the
plain version of the ``__device__`` law in kernels A and F
(``csrc/lanes.cu``); the tiered backend's state, ``TierState``, is at the
end.  One flow per stream-client lane; the flow state of its two endpoints
lives in ``LaneState.stream`` (in ``TierState.flows`` on a tiered run), an
int32 ``[2, S, F]`` tensor: ``[0]`` the S client endpoints, ``[1]`` their
servers, in flow order (ascending client lane).  Viewed flat it is the
``[2S, F]`` endpoint-row matrix the law runs on.

**Representation.**  Every column is int32, as in the reference: sequence
state, congestion control and counters are plain int32, and the six
time-valued fields (srtt, rttvar, rto, rtt_ts, rto_deadline, rto_evt) are
(hi, lo) pairs in the event keys' split encoding.  The arithmetic repeats
the reference's step by step, int32 wraps and floor divisions included, so
the results are its results bit for bit.

**Wire payloads** pack ``flags(4) | seq(26)`` into one int32 queue word
and ``ack`` into a second (engine guard: seq units < 2**26); RTO local
events are marked by size -3 and carry the flow's client lane in the low
payload word.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..net import ltcp
from . import lanes_pairs as lp

i32 = torch.int32

# size-field markers for stream LOCAL events
SZ_PUMP = -2
SZ_RTO = -3

# payload packing: word0 = flags(4) << 26 | seq(26); word1 = ack
PAY_SEQ_BITS = 26
PAY_SEQ_MASK = (1 << PAY_SEQ_BITS) - 1

NEVER32 = lp.NEVER32

_RTO_INIT_P = (ltcp.RTO_INIT >> 31, ltcp.RTO_INIT & lp.MASK31)
_RTO_MIN_P = (ltcp.RTO_MIN >> 31, ltcp.RTO_MIN & lp.MASK31)
_RTO_MAX_P = (ltcp.RTO_MAX >> 31, ltcp.RTO_MAX & lp.MASK31)
_GRAN_P = (0, 1_000_000)  # RFC 6298 1 ms granularity floor


def pack_pay(flags, seq, ack):
    """(flags, seq, ack) -> (word0, word1) int32 pair."""
    flags = torch.as_tensor(flags, dtype=i32)
    seq = torch.as_tensor(seq, dtype=i32)
    return (flags << PAY_SEQ_BITS) | seq, torch.as_tensor(ack, dtype=i32)


def unpack_pay(w0, w1):
    return w0 >> PAY_SEQ_BITS, w0 & PAY_SEQ_MASK, w1


# -- column layout of the per-endpoint [*, F] int32 matrix ------------------
(C_STATE, C_SND_UNA, C_SND_NXT, C_RCV_NXT, C_CWND, C_SSTHRESH, C_DUP_ACKS,
 C_IN_REC, C_RECOVER, C_MAX_SENT, C_RTT_SEQ,
 C_SRTT_HI, C_SRTT_LO, C_RTTVAR_HI, C_RTTVAR_LO, C_RTO_HI, C_RTO_LO,
 C_RTT_TS_HI, C_RTT_TS_LO, C_RTODL_HI, C_RTODL_LO, C_RTOEV_HI, C_RTOEV_LO,
 C_TX_SEGS, C_RETRANS, C_COMPLETED, C_RX_SEGS, C_RX_BYTES,
 C_WMAX, C_ORIGIN, C_EPOCH_HI, C_EPOCH_LO, C_KQ) = range(33)
N_COLS = 33


def init_stream_state(s_flows: int, device="cpu") -> torch.Tensor:
    """Fresh endpoint matrices, ``[2, S, F]``: client rows then server
    rows (the reference's ``StreamState(cl, sv)`` stacked)."""
    m = torch.zeros((2, s_flows, N_COLS), dtype=i32, device=device)
    m[..., C_CWND] = ltcp.INIT_CWND_FP
    m[..., C_SSTHRESH] = ltcp.INIT_SSTHRESH_FP
    m[..., C_SRTT_HI] = -1
    m[..., C_RTO_HI] = _RTO_INIT_P[0]
    m[..., C_RTO_LO] = _RTO_INIT_P[1]
    m[..., C_RTT_SEQ] = -1
    for col in (C_RTODL_HI, C_RTODL_LO, C_RTOEV_HI, C_RTOEV_LO,
                C_EPOCH_HI, C_EPOCH_LO):
        m[..., col] = NEVER32
    return m


class FlowCols(NamedTuple):
    """One endpoint's flow state as [M] int32 columns (+ static shape)."""

    state: torch.Tensor
    snd_una: torch.Tensor
    snd_nxt: torch.Tensor
    rcv_nxt: torch.Tensor
    cwnd_fp: torch.Tensor
    ssthresh_fp: torch.Tensor
    dup_acks: torch.Tensor
    in_rec: torch.Tensor  # bool
    recover: torch.Tensor
    max_sent: torch.Tensor
    rtt_seq: torch.Tensor
    srtt_hi: torch.Tensor  # pair (hi < 0 = no sample yet)
    srtt_lo: torch.Tensor
    rttvar_hi: torch.Tensor
    rttvar_lo: torch.Tensor
    rto_hi: torch.Tensor
    rto_lo: torch.Tensor
    rtt_ts_hi: torch.Tensor
    rtt_ts_lo: torch.Tensor
    rtodl_hi: torch.Tensor  # NEVER32 = unarmed
    rtodl_lo: torch.Tensor
    rtoev_hi: torch.Tensor
    rtoev_lo: torch.Tensor
    tx_segs: torch.Tensor
    retransmits: torch.Tensor
    completed: torch.Tensor  # bool
    rx_segs: torch.Tensor
    rx_bytes: torch.Tensor
    # CUBIC state (inert under CC_RENO)
    w_max_fp: torch.Tensor
    cub_origin_fp: torch.Tensor
    cub_epoch_hi: torch.Tensor  # pair (NEVER32 = no epoch yet)
    cub_epoch_lo: torch.Tensor
    cub_k_q: torch.Tensor
    role: torch.Tensor  # SENDER / RECEIVER
    segs: torch.Tensor  # transfer shape (client flows; 0 for server role)
    mss: torch.Tensor
    last_bytes: torch.Tensor
    cc: torch.Tensor  # ltcp.CC_RENO / CC_CUBIC


_MATRIX_FIELDS = (
    ("state", C_STATE), ("snd_una", C_SND_UNA), ("snd_nxt", C_SND_NXT),
    ("rcv_nxt", C_RCV_NXT), ("cwnd_fp", C_CWND), ("ssthresh_fp", C_SSTHRESH),
    ("dup_acks", C_DUP_ACKS), ("recover", C_RECOVER),
    ("max_sent", C_MAX_SENT), ("rtt_seq", C_RTT_SEQ),
    ("srtt_hi", C_SRTT_HI), ("srtt_lo", C_SRTT_LO),
    ("rttvar_hi", C_RTTVAR_HI), ("rttvar_lo", C_RTTVAR_LO),
    ("rto_hi", C_RTO_HI), ("rto_lo", C_RTO_LO),
    ("rtt_ts_hi", C_RTT_TS_HI), ("rtt_ts_lo", C_RTT_TS_LO),
    ("rtodl_hi", C_RTODL_HI), ("rtodl_lo", C_RTODL_LO),
    ("rtoev_hi", C_RTOEV_HI), ("rtoev_lo", C_RTOEV_LO),
    ("tx_segs", C_TX_SEGS), ("retransmits", C_RETRANS),
    ("rx_segs", C_RX_SEGS), ("rx_bytes", C_RX_BYTES),
    ("w_max_fp", C_WMAX), ("cub_origin_fp", C_ORIGIN),
    ("cub_epoch_hi", C_EPOCH_HI), ("cub_epoch_lo", C_EPOCH_LO),
    ("cub_k_q", C_KQ),
)
_BOOL_FIELDS = (("in_rec", C_IN_REC), ("completed", C_COMPLETED))


class StreamEmit(NamedTuple):
    """What one stimulus emits (all [M], masked by validity): the
    control/slot-0 send and the RTO arm; data bursts ride the epilogue's
    channel (``pump_epilogue_vec``)."""

    send_valid: torch.Tensor
    send_flags: torch.Tensor
    send_seq: torch.Tensor
    send_ack: torch.Tensor
    send_size: torch.Tensor  # wire size
    send_retx: torch.Tensor  # the send is a retransmission
    rto_valid: torch.Tensor  # arm an RTO LOCAL
    rto_thi: torch.Tensor  # pair: RTO event time
    rto_tlo: torch.Tensor
    completed_now: torch.Tensor  # flow reached DONE on this stimulus


# the no-pump-events invariant the wide co-pop rule rests on
assert ltcp.PUMP_BURST >= ltcp.RWND_SEGS


def _w(m, a, b):
    """``where`` that keeps int32 when both branches are int32 or ints."""
    return torch.where(m, torch.as_tensor(a, dtype=i32, device=m.device),
                       torch.as_tensor(b, dtype=i32, device=m.device))


# --------------------------------------------------------------------------
# law helpers
# --------------------------------------------------------------------------


def _seg_wire_size(f: FlowCols, unit):
    is_data = (unit >= 1) & (unit <= f.segs)
    payload = torch.where(unit == f.segs, f.last_bytes, f.mss)
    return torch.where(is_data, ltcp.HDR_BYTES + payload,
                       ltcp.HDR_BYTES).to(i32)


def _seg_flags(f: FlowCols, unit):
    syn = _w(f.role == ltcp.SENDER, ltcp.F_SYN, ltcp.F_SYN | ltcp.F_ACK)
    is_data = (f.role == ltcp.SENDER) & (unit >= 1) & (unit <= f.segs)
    inner = _w(is_data, ltcp.F_DATA | ltcp.F_ACK, ltcp.F_FIN | ltcp.F_ACK)
    return torch.where(unit == 0, syn, inner).to(i32)


def _flight(f: FlowCols):
    return f.snd_nxt - f.snd_una


def _icbrt32_vec(x):
    """Vector twin of ltcp.icbrt32 — the identical 11-iteration bitwise
    floor-cbrt, unrolled.  ``b << s`` may wrap int32 in lanes where the
    take branch is false; those lanes discard the value."""
    x = x.to(i32)
    y = torch.zeros_like(x)
    for s in range(30, -1, -3):
        y = y + y
        b = 3 * y * (y + 1) + 1
        take = (x >> s) >= b
        x = torch.where(take, x - (b << s), x)
        y = torch.where(take, y + 1, y)
    return y


def _cc_on_loss(f: FlowCols, m) -> FlowCols:
    """Multiplicative decrease under mask ``m``: per-algorithm ssthresh;
    CUBIC records W_max (fast convergence) and resets its epoch."""
    cub = m & (f.cc == ltcp.CC_CUBIC)
    ren = m & ~cub
    fl_fp = torch.clamp(_flight(f), max=1 << 15) * ltcp.FP
    new_wmax = torch.where(
        f.cwnd_fp < f.w_max_fp, (f.cwnd_fp * ltcp.CUBIC_FC_MUL) >> 10,
        f.cwnd_fp)
    return f._replace(
        w_max_fp=torch.where(cub, new_wmax, f.w_max_fp),
        cub_epoch_hi=_w(cub, NEVER32, f.cub_epoch_hi),
        cub_epoch_lo=_w(cub, NEVER32, f.cub_epoch_lo),
        ssthresh_fp=torch.where(
            cub,
            torch.clamp((f.cwnd_fp * ltcp.CUBIC_BETA_MUL) >> 10,
                        min=ltcp.MIN_SSTHRESH_FP),
            torch.where(ren, torch.clamp(fl_fp // 2, min=ltcp.MIN_SSTHRESH_FP),
                        f.ssthresh_fp)),
    )


def _cc_grow_ca(f: FlowCols, nh, nl, m) -> FlowCols:
    """Congestion-avoidance growth for one new ACK under mask ``m``; no
    MAX_CWND clamp here — the caller clamps."""
    cub = m & (f.cc == ltcp.CC_CUBIC)
    start = cub & (f.cub_epoch_hi == NEVER32)
    below = f.cwnd_fp < f.w_max_fp
    k_new = torch.where(
        below, 4 * _icbrt32_vec((f.w_max_fp - f.cwnd_fp) * ltcp.CUBIC_K_MUL),
        0).to(i32)
    f = f._replace(
        cub_epoch_hi=torch.where(start, nh, f.cub_epoch_hi),
        cub_epoch_lo=torch.where(start, nl, f.cub_epoch_lo),
        cub_origin_fp=torch.where(
            start, torch.where(below, f.w_max_fp, f.cwnd_fp),
            f.cub_origin_fp),
        cub_k_q=torch.where(start, k_new, f.cub_k_q),
    )
    # d_q = min((now - epoch) >> 20, D_MAX) on pairs: hi*2**11 + (lo >> 20)
    dh, dl = lp.pair_sub_pair(nh, nl, f.cub_epoch_hi, f.cub_epoch_lo)
    d_q = torch.clamp(
        torch.clamp(dh, max=1 << 19) * (1 << 11) + (dl >> 20),
        max=ltcp.CUBIC_D_MAX)
    offs = d_q - f.cub_k_q
    neg = offs < 0
    offs = torch.clamp(torch.abs(offs), max=ltcp.CUBIC_D_MAX)
    delta_fp = (((((offs * offs) >> 10) * offs) >> 10)
                * ltcp.CUBIC_C_MUL) >> 10
    target_fp = torch.where(neg, f.cub_origin_fp - delta_fp,
                            f.cub_origin_fp + delta_fp)
    cwnd_safe = torch.clamp(f.cwnd_fp, min=1)
    cub_grow = torch.where(
        target_fp > f.cwnd_fp,
        torch.clamp((target_fp - f.cwnd_fp) * ltcp.FP // cwnd_safe, min=1),
        torch.clamp((ltcp.FP * ltcp.FP) // (100 * cwnd_safe), min=1))
    ren_grow = torch.clamp((ltcp.FP * ltcp.FP) // cwnd_safe, min=1)
    return f._replace(cwnd_fp=torch.where(
        m, f.cwnd_fp + torch.where(cub, cub_grow, ren_grow), f.cwnd_fp))


def _rtt_sample(f: FlowCols, nh, nl, m) -> FlowCols:
    """RFC 6298 update where mask ``m``, on pairs."""
    nonneg = lp.pair_ge(nh, nl, f.rtt_ts_hi, f.rtt_ts_lo)
    rh, rl = lp.pair_sub_pair(nh, nl, f.rtt_ts_hi, f.rtt_ts_lo)
    rh = _w(nonneg, rh, 0)
    rl = _w(nonneg, rl, 0)
    first = f.srtt_hi < 0
    s7h, s7l = lp.pair_mul_small(f.srtt_hi, f.srtt_lo, 7)
    sh, sl = lp.pair_div_pow2(*lp.pair_add_pair(s7h, s7l, rh, rl), 3)
    srtt1h = torch.where(first, rh, sh)
    srtt1l = torch.where(first, rl, sl)
    dh, dl = lp.pair_abs_diff(f.srtt_hi, f.srtt_lo, rh, rl)
    v3h, v3l = lp.pair_mul_small(f.rttvar_hi, f.rttvar_lo, 3)
    vh, vl = lp.pair_div_pow2(*lp.pair_add_pair(v3h, v3l, dh, dl), 2)
    r2h, r2l = lp.pair_div_pow2(rh, rl, 1)
    var1h = torch.where(first, r2h, vh)
    var1l = torch.where(first, r2l, vl)
    v4h, v4l = lp.pair_mul_small(var1h, var1l, 4)
    v4h, v4l = _pair_max_const(v4h, v4l, _GRAN_P)
    toh, tol = lp.pair_add_pair(srtt1h, srtt1l, v4h, v4l)
    below = _pair_lt_const(toh, tol, _RTO_MIN_P)
    toh = _w(below, _RTO_MIN_P[0], toh)
    tol = _w(below, _RTO_MIN_P[1], tol)
    above = _const_lt_pair(_RTO_MAX_P, toh, tol)
    toh = _w(above, _RTO_MAX_P[0], toh)
    tol = _w(above, _RTO_MAX_P[1], tol)
    return f._replace(
        srtt_hi=torch.where(m, srtt1h, f.srtt_hi),
        srtt_lo=torch.where(m, srtt1l, f.srtt_lo),
        rttvar_hi=torch.where(m, var1h, f.rttvar_hi),
        rttvar_lo=torch.where(m, var1l, f.rttvar_lo),
        rto_hi=torch.where(m, toh, f.rto_hi),
        rto_lo=torch.where(m, tol, f.rto_lo),
    )


def _pair_lt_const(hi, lo, c):
    return (hi < c[0]) | ((hi == c[0]) & (lo < c[1]))


def _const_lt_pair(c, hi, lo):
    return (c[0] < hi) | ((c[0] == hi) & (c[1] < lo))


def _pair_max_const(hi, lo, c):
    a_wins = ~_pair_lt_const(hi, lo, c)
    return _w(a_wins, hi, c[0]), _w(a_wins, lo, c[1])


def _restart_rto(f: FlowCols, nh, nl, m, em: "StreamEmit"):
    """(Re)start the retransmission timer where ``m``, with the dedup law
    (arm a new RTO event only when none is queued or the new deadline is
    earlier); returns (f, em)."""
    dlh, dll = lp.pair_add_pair(nh, nl, f.rto_hi, f.rto_lo)
    arm = m & ((f.rtoev_hi == NEVER32)
               | lp.pair_lt(dlh, dll, f.rtoev_hi, f.rtoev_lo))
    f = f._replace(
        rtodl_hi=torch.where(m, dlh, f.rtodl_hi),
        rtodl_lo=torch.where(m, dll, f.rtodl_lo),
        rtoev_hi=torch.where(arm, dlh, f.rtoev_hi),
        rtoev_lo=torch.where(arm, dll, f.rtoev_lo),
    )
    return f, em._replace(
        rto_valid=em.rto_valid | arm,
        rto_thi=torch.where(arm, dlh, em.rto_thi),
        rto_tlo=torch.where(arm, dll, em.rto_tlo),
    )


def _emit_unit(f: FlowCols, unit, m, retransmit: bool, em: StreamEmit):
    """Send the segment for ``unit`` where ``m`` (at most one send per
    stimulus, so the channel is an overwrite under the mask)."""
    if retransmit:
        rtt_seq = _w(m & (f.rtt_seq >= 0) & (unit <= f.rtt_seq), -1,
                     f.rtt_seq)
    else:
        rtt_seq = torch.where(m & (f.rtt_seq < 0), unit, f.rtt_seq)
    f = f._replace(
        tx_segs=f.tx_segs + m,
        retransmits=f.retransmits + (m & retransmit),
        rtt_seq=rtt_seq,
        max_sent=torch.where(m & (unit + 1 > f.max_sent), unit + 1,
                             f.max_sent),
    )
    em = em._replace(
        send_valid=em.send_valid | m,
        send_flags=torch.where(m, _seg_flags(f, unit), em.send_flags),
        send_seq=torch.where(m, unit, em.send_seq),
        send_ack=torch.where(m, f.rcv_nxt, em.send_ack),
        send_size=torch.where(m, _seg_wire_size(f, unit), em.send_size),
        send_retx=(em.send_retx | m) if retransmit
        else (em.send_retx & ~m),
    )
    return f, em


def _empty_emit(n: int, device) -> StreamEmit:
    zb = torch.zeros(n, dtype=torch.bool, device=device)
    z32 = torch.zeros(n, dtype=i32, device=device)
    return StreamEmit(zb, z32, z32, z32, z32, zb, zb, z32, z32, zb)


def _control(em: StreamEmit, m, seq, ack) -> StreamEmit:
    """A pure-ACK control send (no law bookkeeping) where ``m``."""
    return em._replace(
        send_valid=em.send_valid | m,
        send_flags=_w(m, ltcp.F_ACK, em.send_flags),
        send_seq=torch.where(m, seq, em.send_seq),
        send_ack=torch.where(m, ack, em.send_ack),
        send_size=_w(m, ltcp.HDR_BYTES, em.send_size),
    )


def _pull_back(f: FlowCols, nh, nl, m, em):
    """Go-back-N loss response where ``m`` (the epilogue pump re-streams
    the rest)."""
    f = f._replace(
        snd_nxt=torch.where(m, f.snd_una + 1, f.snd_nxt),
        state=_w(m & (f.role == ltcp.SENDER) & (f.state == ltcp.FIN_WAIT),
                 ltcp.ESTAB, f.state),
    )
    f, em = _emit_unit(f, f.snd_una, m, True, em)
    return _restart_rto(f, nh, nl, m, em)


def pump_epilogue_vec(f: FlowCols, nh, nl, m, em):
    """The transmission-opportunity epilogue: transmit up to PUMP_BURST
    window-permitted units, in closed form (the reference's derivation:
    nothing the gate depends on changes mid-burst).  Returns ``(f, em,
    burst)`` where ``burst`` is ``(valid, flags, units, acks, sizes,
    retx)``, stacked ``[PUMP_BURST, M]`` tensors whose validity is a prefix
    along axis 0."""
    b_max = ltcp.PUMP_BURST
    u0 = f.snd_nxt
    cwnd_segs = f.cwnd_fp // ltcp.FP
    can0 = m & (f.role == ltcp.SENDER) & (f.state == ltcp.ESTAB)
    lim_w = torch.clamp(cwnd_segs, max=ltcp.RWND_SEGS) - (u0 - f.snd_una)
    lim_fin = f.segs + 2 - u0
    b_cnt = torch.where(
        can0, torch.clamp(torch.minimum(lim_w, lim_fin), 0, b_max), 0
    ).to(i32)
    sent_any = b_cnt > 0

    ks = torch.arange(b_max, dtype=i32, device=u0.device)[:, None]
    units = u0[None, :] + ks
    valid = ks < b_cnt[None, :]
    flags = _seg_flags(f, units)
    sizes = _seg_wire_size(f, units)
    acks = f.rcv_nxt[None, :].expand(units.shape)

    n_re = torch.minimum(torch.clamp(f.max_sent - u0, min=0), b_cnt)
    cleared = (n_re > 0) & (f.rtt_seq >= 0) & (u0 <= f.rtt_seq)
    fresh_exists = b_cnt > n_re
    take_ts = fresh_exists & ((f.rtt_seq < 0) | cleared)
    new_rtt_seq = torch.where(take_ts, u0 + n_re, _w(cleared, -1, f.rtt_seq))
    f = f._replace(
        rtt_ts_hi=torch.where(take_ts, nh, f.rtt_ts_hi),
        rtt_ts_lo=torch.where(take_ts, nl, f.rtt_ts_lo),
        rtt_seq=new_rtt_seq.to(i32),
        tx_segs=f.tx_segs + b_cnt,
        retransmits=f.retransmits + n_re,
        max_sent=torch.where(sent_any, torch.maximum(f.max_sent, u0 + b_cnt),
                             f.max_sent),
        snd_nxt=u0 + b_cnt,
        state=_w(sent_any & (u0 + b_cnt == f.segs + 2), ltcp.FIN_WAIT,
                 f.state),
    )
    f, em = _restart_rto(f, nh, nl, m & sent_any, em)
    retx = ks < n_re[None, :]
    return f, em, (valid, flags, units, acks, sizes, retx)


# --------------------------------------------------------------------------
# stimulus handlers, each under an activity mask ``m``
# --------------------------------------------------------------------------


def open_flow_vec(f: FlowCols, nh, nl, m) -> tuple[FlowCols, StreamEmit]:
    em = _empty_emit(f.state.shape[0], f.state.device)
    f = f._replace(state=_w(m, ltcp.SYN_SENT, f.state),
                   snd_nxt=_w(m, 1, f.snd_nxt))
    f, em = _emit_unit(f, torch.zeros_like(f.snd_nxt), m, False, em)
    f = f._replace(rtt_ts_hi=torch.where(m, nh, f.rtt_ts_hi),
                   rtt_ts_lo=torch.where(m, nl, f.rtt_ts_lo))
    return _restart_rto(f, nh, nl, m, em)


def on_rto_vec(f: FlowCols, nh, nl, m) -> tuple[FlowCols, StreamEmit]:
    em = _empty_emit(f.state.shape[0], f.state.device)
    # ownership law: only the event at time rto_evt speaks for the timer
    m = m & (nh == f.rtoev_hi) & (nl == f.rtoev_lo)
    f = f._replace(rtoev_hi=_w(m, NEVER32, f.rtoev_hi),
                   rtoev_lo=_w(m, NEVER32, f.rtoev_lo))
    lapse = (f.rtodl_hi == NEVER32) | (_flight(f) <= 0)
    m = m & ~lapse
    # deadline moved later: re-arm there
    rearm = m & lp.pair_lt(nh, nl, f.rtodl_hi, f.rtodl_lo)
    f = f._replace(rtoev_hi=torch.where(rearm, f.rtodl_hi, f.rtoev_hi),
                   rtoev_lo=torch.where(rearm, f.rtodl_lo, f.rtoev_lo))
    em = em._replace(rto_valid=em.rto_valid | rearm,
                     rto_thi=torch.where(rearm, f.rtodl_hi, em.rto_thi),
                     rto_tlo=torch.where(rearm, f.rtodl_lo, em.rto_tlo))
    fire = m & ~rearm
    r2h, r2l = lp.pair_mul_small(f.rto_hi, f.rto_lo, 2)
    over = _const_lt_pair(_RTO_MAX_P, r2h, r2l)
    r2h = _w(over, _RTO_MAX_P[0], r2h)
    r2l = _w(over, _RTO_MAX_P[1], r2l)
    f = _cc_on_loss(f, fire)
    f = f._replace(
        cwnd_fp=_w(fire, ltcp.FP, f.cwnd_fp),
        dup_acks=_w(fire, 0, f.dup_acks),
        in_rec=f.in_rec & ~fire,
        rto_hi=torch.where(fire, r2h, f.rto_hi),
        rto_lo=torch.where(fire, r2l, f.rto_lo),
    )
    return _pull_back(f, nh, nl, fire, em)


def on_segment_vec(f: FlowCols, nh, nl, m, flags, seq, ack, size
                   ) -> tuple[FlowCols, StreamEmit]:
    """Vector twin of the scalar ``on_segment``: each early return of the
    scalar law is a disjoint mask, and the updates compose under them in
    the same order."""
    n = f.state.shape[0]
    em = _empty_emit(n, f.state.device)
    zero = torch.zeros_like(f.state)
    is_syn = (flags & ltcp.F_SYN) != 0
    is_ack = (flags & ltcp.F_ACK) != 0
    is_fin = (flags & ltcp.F_FIN) != 0
    is_data = (flags & ltcp.F_DATA) != 0

    # ---- DONE: dup FIN from a peer that missed our final ACK -----------
    done0 = m & (f.state == ltcp.DONE)
    em = _control(em, done0 & (f.role == ltcp.SENDER) & is_fin, f.snd_nxt,
                  f.rcv_nxt)
    m = m & ~done0

    # ---- passive open ----------------------------------------------------
    po = m & (f.role == ltcp.RECEIVER) & (f.state == ltcp.CLOSED)
    po_ok = po & is_syn & ~is_ack
    f = f._replace(state=_w(po_ok, ltcp.SYN_RCVD, f.state),
                   rcv_nxt=_w(po_ok, 1, f.rcv_nxt),
                   snd_nxt=_w(po_ok, 1, f.snd_nxt))
    f, em = _emit_unit(f, zero, po_ok, False, em)
    f = f._replace(rtt_ts_hi=torch.where(po_ok, nh, f.rtt_ts_hi),
                   rtt_ts_lo=torch.where(po_ok, nl, f.rtt_ts_lo))
    f, em = _restart_rto(f, nh, nl, po_ok, em)
    m = m & ~po  # both the handled SYN and the ignored non-SYN return

    # retransmitted SYN into SYN_RCVD: resend the SYN-ACK
    rsyn = (m & (f.role == ltcp.RECEIVER) & (f.state == ltcp.SYN_RCVD)
            & is_syn & ~is_ack)
    f, em = _emit_unit(f, zero, rsyn, True, em)
    f, em = _restart_rto(f, nh, nl, rsyn, em)
    m = m & ~rsyn

    # ---- ACK processing ---------------------------------------------------
    new_ack = m & is_ack & (ack > f.snd_una)
    acked = torch.clamp(ack - f.snd_una, max=1 << 15)
    pre_snd_una = f.snd_una
    pre_in_rec = f.in_rec
    was_syn_sent = new_ack & (f.state == ltcp.SYN_SENT)
    was_syn_rcvd = new_ack & (f.state == ltcp.SYN_RCVD)
    f = f._replace(snd_una=torch.where(new_ack, ack, f.snd_una))
    clamp = new_ack & (f.snd_nxt < f.snd_una)
    f = f._replace(snd_nxt=torch.where(clamp, f.snd_una, f.snd_nxt))
    f = f._replace(
        state=_w(was_syn_sent | was_syn_rcvd, ltcp.ESTAB, f.state),
        rcv_nxt=_w(was_syn_sent, 1, f.rcv_nxt),  # the SYN-ACK's unit 0
    )
    # full-ack recovery exit / slow start / congestion avoidance
    full_ack = new_ack & pre_in_rec & (ack >= f.recover)
    f = f._replace(cwnd_fp=torch.where(full_ack, f.ssthresh_fp, f.cwnd_fp),
                   in_rec=f.in_rec & ~full_ack,
                   dup_acks=_w(full_ack, 0, f.dup_acks))
    growth = new_ack & ~pre_in_rec
    ss = growth & (f.cwnd_fp < f.ssthresh_fp)
    ca = growth & ~ss
    f = f._replace(
        dup_acks=_w(growth, 0, f.dup_acks),
        cwnd_fp=torch.where(ss, f.cwnd_fp + acked * ltcp.FP, f.cwnd_fp))
    f = _cc_grow_ca(f, nh, nl, ca)
    f = f._replace(cwnd_fp=torch.where(
        growth, torch.clamp(f.cwnd_fp, max=ltcp.MAX_CWND_FP), f.cwnd_fp))
    rtt_m = new_ack & (f.rtt_seq >= 0) & (ack > f.rtt_seq)
    f = _rtt_sample(f, nh, nl, rtt_m)
    f = f._replace(rtt_seq=_w(rtt_m, -1, f.rtt_seq))
    has_flight = _flight(f) > 0
    f, em = _restart_rto(f, nh, nl, new_ack & has_flight, em)
    no_flight = new_ack & ~has_flight
    f = f._replace(rtodl_hi=_w(no_flight, NEVER32, f.rtodl_hi),
                   rtodl_lo=_w(no_flight, NEVER32, f.rtodl_lo))

    # pure duplicate ACK
    dup = (m & is_ack & (ack == pre_snd_una) & ~new_ack & (_flight(f) > 0)
           & ~(is_data | is_syn | is_fin))
    infl = dup & f.in_rec
    f = f._replace(cwnd_fp=torch.where(infl, f.cwnd_fp + ltcp.FP, f.cwnd_fp))
    count = dup & ~f.in_rec
    f = f._replace(dup_acks=torch.where(count, f.dup_acks + 1, f.dup_acks))
    fr = count & (f.dup_acks == ltcp.DUP_THRESH)
    f = f._replace(in_rec=f.in_rec | fr,
                   recover=torch.where(fr, f.snd_nxt, f.recover))
    f = _cc_on_loss(f, fr)
    f = f._replace(cwnd_fp=torch.where(
        fr, f.ssthresh_fp + ltcp.DUP_THRESH * ltcp.FP, f.cwnd_fp))
    f, em = _pull_back(f, nh, nl, fr, em)

    # ---- sender-side teardown (a window this ACK opened is streamed by
    # the epilogue pump, run once per stimulus by the slot law) -------------
    snd = m & (f.role == ltcp.SENDER)
    fin_done = snd & is_fin & (f.snd_una == f.segs + 2)
    f = f._replace(rcv_nxt=_w(fin_done, 2, f.rcv_nxt))
    em = _control(em, fin_done, f.snd_nxt, f.rcv_nxt)
    em = em._replace(completed_now=em.completed_now | fin_done)
    f = f._replace(state=_w(fin_done, ltcp.DONE, f.state),
                   rtodl_hi=_w(fin_done, NEVER32, f.rtodl_hi),
                   rtodl_lo=_w(fin_done, NEVER32, f.rtodl_lo))
    m = m & ~snd  # the sender path returns here in the scalar law

    # ---- receiver-side data path ------------------------------------------
    stray = (m & ((f.state == ltcp.SYN_RCVD) | (f.state == ltcp.ESTAB))
             & is_syn & is_ack)
    m = m & ~stray
    est = m & ((f.state == ltcp.ESTAB) | (f.state == ltcp.SYN_RCVD))
    data_seg = est & is_data
    in_order = data_seg & (seq == f.rcv_nxt)
    f = f._replace(
        rcv_nxt=torch.where(in_order, f.rcv_nxt + 1, f.rcv_nxt),
        rx_segs=f.rx_segs + in_order,
        rx_bytes=f.rx_bytes + _w(in_order, size - ltcp.HDR_BYTES, 0),
    )
    em = _control(em, data_seg, f.snd_nxt, f.rcv_nxt)  # ACK everything
    fin_seg = est & ~is_data & is_fin
    fin_in_order = fin_seg & (seq == f.rcv_nxt)
    unit = f.snd_nxt
    fresh_ts = fin_in_order & (f.rtt_seq < 0)
    f = f._replace(
        rcv_nxt=torch.where(fin_in_order, f.rcv_nxt + 1, f.rcv_nxt),
        snd_nxt=torch.where(fin_in_order, f.snd_nxt + 1, f.snd_nxt),
        rtt_ts_hi=torch.where(fresh_ts, nh, f.rtt_ts_hi),
        rtt_ts_lo=torch.where(fresh_ts, nl, f.rtt_ts_lo),
    )
    f, em = _emit_unit(f, unit, fin_in_order, False, em)
    f = f._replace(state=_w(fin_in_order, ltcp.LAST_ACK, f.state))
    f, em = _restart_rto(f, nh, nl, fin_in_order, em)
    em = _control(em, fin_seg & ~fin_in_order, f.snd_nxt, f.rcv_nxt)

    # LAST_ACK (an elif in the scalar law: a flow the est branch just moved
    # to LAST_ACK is not re-examined on this stimulus)
    la = m & ~est & (f.state == ltcp.LAST_ACK)
    la_done = la & (f.snd_una >= 2)
    f = f._replace(state=_w(la_done, ltcp.DONE, f.state),
                   rtodl_hi=_w(la_done, NEVER32, f.rtodl_hi),
                   rtodl_lo=_w(la_done, NEVER32, f.rtodl_lo))
    em = em._replace(completed_now=em.completed_now | la_done)
    la_stale = la & ~la_done & (is_data | is_fin) & (seq < f.rcv_nxt)
    f, em = _emit_unit(f, f.snd_una, la_stale, True, em)
    return _restart_rto(f, nh, nl, la_stale, em)


def merge_cols(a: FlowCols, b: FlowCols, m) -> FlowCols:
    return FlowCols(*[fa if fa is fb else torch.where(m, fb, fa)
                      for fa, fb in zip(a, b)])


def merge_emit(a: StreamEmit, b: StreamEmit, m) -> StreamEmit:
    return StreamEmit(*[fa if fa is fb else torch.where(m, fb, fa)
                        for fa, fb in zip(a, b)])


def endpoint_cols(stream: torch.Tensor, flow_segs, flow_mss, flow_last,
                  flow_cc) -> FlowCols:
    """The ``[2S]`` FlowCols view of the flow matrices: rows 0..S-1 the
    client endpoints, S..2S-1 their servers (flow order).  ``flow_*`` are
    the ``[2S]`` static transfer-shape tables (zeros on the server half)."""
    s_flows = stream.shape[1]
    rows = stream.reshape(2 * s_flows, N_COLS)
    vals = {name: rows[:, col] for name, col in _MATRIX_FIELDS}
    for name, col in _BOOL_FIELDS:
        vals[name] = rows[:, col] != 0
    role = torch.full((2 * s_flows,), ltcp.SENDER, dtype=i32,
                      device=stream.device)
    role[s_flows:] = ltcp.RECEIVER
    return FlowCols(**vals, role=role, segs=flow_segs, mss=flow_mss,
                    last_bytes=flow_last, cc=flow_cc)


def endpoint_split(f: FlowCols) -> torch.Tensor:
    """Inverse of endpoint_cols: ``[2S]`` FlowCols -> ``[2, S, F]``."""
    cols = [None] * N_COLS
    for name, col in _MATRIX_FIELDS:
        cols[col] = getattr(f, name)
    for name, col in _BOOL_FIELDS:
        cols[col] = getattr(f, name).to(i32)
    rows = torch.stack(cols, dim=1)
    return rows.reshape(2, rows.shape[0] // 2, N_COLS)


# --------------------------------------------------------------------------
# the TIERED stream backend (one-to-one configs, the reference's
# ``TierState``): stream endpoints own a [2S, C2] event queue and compact
# per-endpoint network state, so the [N] lanes carry no stream work.  Sound
# only in one-to-one mode: each endpoint lane hosts exactly one flow, so its
# buckets, CoDel state and counters are in bijection with endpoint rows.
# --------------------------------------------------------------------------

# rows of the [TV_COUNT, 2S] int32 tier vector matrix: down bucket, CoDel,
# up bucket, sequence counters, stats, and the netobs rows (allocated as in
# the reference; the port has no netobs plane, so they stay zero)
(TV_DN_TOK, TV_DN_NRH, TV_DN_NRL, TV_DN_LDH, TV_DN_LDL,
 TV_CD_FATH, TV_CD_FATL, TV_CD_DNH, TV_CD_DNL, TV_CD_CNT, TV_CD_DROP,
 TV_UP_TOK, TV_UP_NRH, TV_UP_NRL, TV_UP_LDH, TV_UP_LDL,
 TV_SEND_SEQ, TV_LOCAL_SEQ, TV_N_SENDS, TV_N_LOSS, TV_N_DEL, TV_N_CODEL,
 TV_N_QUEUE, TV_NB_TXB, TV_NB_RXB, TV_NB_THR) = range(26)
TV_COUNT = 26

# planes of the [7, 2S, C2] tier queue: the 4-word key, the size and the
# two payload words; each row sorted by the key like the [N] queues
(TQ_THI, TQ_TLO, TQ_AUXH, TQ_AUXL, TQ_SIZE, TQ_PHI, TQ_PLO) = range(7)

# CoDel "first_above" unset sentinel (lanes.CD_UNSET; this module does not
# import lanes)
_CD_UNSET = -(1 << 31) + 1


class TierState(NamedTuple):
    """State of the tiered stream backend (``LaneState.stream`` when
    tiered): ``flows`` the ``[2, S, F]`` endpoint matrices (as untiered),
    ``q`` the ``[7, 2S, C2]`` endpoint event queues (TQ_* planes), ``v``
    the ``[TV_COUNT, 2S]`` buckets, CoDel and counters (TV_* rows)."""

    flows: torch.Tensor
    q: torch.Tensor
    v: torch.Tensor


def init_tier_state(s_flows: int, capacity: int, dn_tokens, up_tokens,
                    interval: int, device="cpu") -> TierState:
    """Fresh tier state: empty queues, buckets full (``dn_tokens``,
    ``up_tokens``: the endpoint lanes' bursts), next refill one interval
    in, CoDel's first_above unset."""
    s2 = 2 * s_flows
    q = torch.zeros((7, s2, capacity), dtype=i32, device=device)
    q[TQ_THI] = NEVER32
    q[TQ_TLO] = NEVER32
    v = torch.zeros((TV_COUNT, s2), dtype=i32, device=device)
    v[TV_DN_TOK] = torch.as_tensor(dn_tokens, dtype=i32, device=device)
    v[TV_UP_TOK] = torch.as_tensor(up_tokens, dtype=i32, device=device)
    v[TV_DN_NRL] = interval
    v[TV_UP_NRL] = interval
    v[TV_CD_FATH] = _CD_UNSET
    return TierState(flows=init_stream_state(s_flows, device), q=q, v=v)
