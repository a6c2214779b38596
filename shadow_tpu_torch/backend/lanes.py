"""Lane backend of the port: state, laws, and the plain versions of the four
lane kernels, plus the two drivers (round by round, and the device loop).

Counterpart of the JAX package's ``backend/lanes.py``, restricted to the
passive lane path: every host runs ``tgen-mesh``, ``tgen-client``,
``tgen-server`` or nothing, graphs are loss-free, and the window is the
static runahead.  One **lane per simulated host**; per-host state lives in
``[N]`` or ``[N, C]`` tensors, and one iteration of the window loop is four
kernels (``kernels.py`` binds their CUDA versions):

- A ``lane_slots``: pop up to K events inside the window, run the passive
  slot law on each (down bucket, CoDel, inline delivery, timer tick, up
  bucket, latency gather, re-arm), emit the self, outbound and record
  blocks;
- B ``exchange_merge``: the cross-lane exchange into an ``[N, Cx]`` block
  and the keyed row merge of ``[old C | self K | cross Cx]``, keeping the
  first C;
- C ``queue_min_window``: the global earliest head, the window law and the
  ``live`` flag;
- D ``append_log``: compaction of the iteration's records into the log.

The layout is the reference's: the event key ``(time, kind, src, seq)`` is
four int32 words ``(t_hi, t_lo, aux_hi, aux_lo)``, times are (hi, lo) int32
pairs, counters are int32 — so the bridge and the parity tests compare
field by field.  The plain versions here repeat the reference's pair
arithmetic (``lanes_pairs.py``); the CUDA kernels join pairs to int64 in
registers, which gives the same integers within the engine's guarded
ranges.

Unlike the reference, the state is updated **in place**: kernels write
their outputs into the state's tensors and a per-run :class:`Workspace`,
so a run allocates nothing per iteration.  Every step of an iteration is
gated on the device-side ``live`` flag written by kernel C, so steps run
after the simulation ended change nothing (the device loop reads the flag
only every few steps).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..core import time as stime
from ..net import codel as codel_mod
from ..net.token_bucket import DEFAULT_INTERVAL_NS, FRAME_OVERHEAD_BYTES
from . import lanes_pairs as _pairs
from .results import DELIVERED, DROP_CODEL, DROP_QUEUE

i32 = torch.int32
i64 = torch.int64

# event kinds (the reference's core.event.EventKind)
PACKET, LOCAL, DELIVERY = 0, 1, 2

NEVER = stime.NEVER

# model ids: the reference's numbering, so model tables compare equal.
# This slice runs M_NONE and the tgen trio, all PASSIVE (delivery only
# counts): deliveries apply inline at packet arrival and every lane may
# co-pop any prefix of its queue
(M_NONE, M_PHOLD, M_TGEN_MESH, M_TGEN_CLIENT, M_TGEN_SERVER, M_PING_CLIENT,
 M_PING_SERVER, M_STREAM_CLIENT, M_STREAM_SERVER) = range(9)

# LOCAL size marker: a non-driving process's start event on a multi-process
# host — anchors the window like any start, drives nothing (the driver's
# start is -1)
SZ_ANCHOR = -5

# ---- event key representation ---------------------------------------------
#   (t_hi, t_lo)     = (time >> 31, time & 0x7FFFFFFF); NEVER -> (NEVER32, NEVER32)
#   (aux_hi, aux_lo) = (kind << 29 | src << 12, seq)
# src < 2**17 lanes (engine-guarded); seq < 2**31 (counters are checked).
AUX_SRC_BITS = 17
AUX_SRC_SHIFT = 12
AUX_KIND_SHIFT = AUX_SRC_SHIFT + AUX_SRC_BITS
MAX_LANES = 1 << AUX_SRC_BITS
_SRC_MASK = (1 << AUX_SRC_BITS) - 1

NEVER32 = _pairs.NEVER32
MASK31 = _pairs.MASK31
MOD_SMALL_LIMIT = _pairs.MOD_SMALL_LIMIT

# CoDel "first_above" unset sentinel: a hi word no real time can reach
CD_UNSET = -(1 << 31) + 1

pair_lt = _pairs.pair_lt
pair_ge = _pairs.pair_ge
pair_add32 = _pairs.pair_add32
pair_sub32 = _pairs.pair_sub32
pair_add_pair = _pairs.pair_add_pair
pair_max = _pairs.pair_max
pair_sel = _pairs.pair_sel
pair_sub_clamp = _pairs.pair_sub_clamp
pair_mod_small = _pairs.pair_mod_small


def pack_aux_hi(kind, src):
    """The (kind, src) high word of the packed key (seq rides aux_lo)."""
    kind = torch.as_tensor(kind, dtype=i32)
    src = torch.as_tensor(src, dtype=i32)
    return (kind << AUX_KIND_SHIFT) | (src << AUX_SRC_SHIFT)


def unpack_aux_hi(aux_hi):
    kind = aux_hi >> AUX_KIND_SHIFT
    src = (aux_hi >> AUX_SRC_SHIFT) & _SRC_MASK
    return kind, src


def t_split(t):
    """Absolute int64 ns -> (hi, lo) int32 pair; NEVER -> (NEVER32, NEVER32).
    Exact for every 0 <= t < 2**62."""
    never = t == NEVER
    hi = torch.where(never, NEVER32, t >> 31).to(i32)
    lo = torch.where(never, NEVER32, t & MASK31).to(i32)
    return hi, lo


def t_join(hi, lo):
    """Inverse of t_split (hi == NEVER32 alone marks NEVER)."""
    t = (hi.to(i64) << 31) | lo.to(i64)
    return torch.where(hi == NEVER32, NEVER, t)


class LaneState(NamedTuple):
    """The simulation state, on one device, updated in place by the
    kernels.  Field names, dtypes and layout are the reference's
    ``LaneState`` restricted to the passive lane path."""

    # event queues [N, C]: int32 key words, kept sorted by the 4-word key;
    # a (NEVER32, NEVER32) time pair marks an empty slot
    q_thi: torch.Tensor
    q_tlo: torch.Tensor
    q_auxh: torch.Tensor  # kind << 29 | src << 12
    q_auxl: torch.Tensor  # seq
    q_size: torch.Tensor
    # per-lane counters [N] int32 (checked for wrap at collect)
    send_seq: torch.Tensor
    local_seq: torch.Tensor
    # token buckets [N]: tokens int32, next_refill / last_depart as pairs
    up_tokens: torch.Tensor
    up_nr_hi: torch.Tensor
    up_nr_lo: torch.Tensor
    up_ld_hi: torch.Tensor
    up_ld_lo: torch.Tensor
    dn_tokens: torch.Tensor
    dn_nr_hi: torch.Tensor
    dn_nr_lo: torch.Tensor
    dn_ld_hi: torch.Tensor
    dn_ld_lo: torch.Tensor
    # CoDel [N]: first_above / drop_next pairs (hi == CD_UNSET: not above)
    cd_fat_hi: torch.Tensor
    cd_fat_lo: torch.Tensor
    cd_dnext_hi: torch.Tensor
    cd_dnext_lo: torch.Tensor
    cd_drop_count: torch.Tensor
    cd_dropping: torch.Tensor  # bool
    # app state [N]
    m_sent: torch.Tensor  # tgen-client messages sent
    m_peer_offset: torch.Tensor  # tgen-mesh round-robin cursor
    # stats [N]
    n_delivered: torch.Tensor
    n_codel: torch.Tensor
    n_queue: torch.Tensor
    recv_bytes: torch.Tensor
    n_sends: torch.Tensor
    # event log [max(L, 1), 6] int64 (time, src, dst, seq, size, outcome)
    log: torch.Tensor
    log_count: torch.Tensor  # int32 scalar
    log_lost: torch.Tensor  # int32 scalar: records dropped on log overflow
    # round bookkeeping (int32 scalars)
    rounds: torch.Tensor
    iters: torch.Tensor
    now_we_hi: torch.Tensor  # current window end, as a pair
    now_we_lo: torch.Tensor


@dataclasses.dataclass(frozen=True)
class LaneParams:
    """Static simulation parameters."""

    n_lanes: int
    capacity: int  # C
    pops_per_iter: int  # K
    log_capacity: int  # L (0 disables logging)
    stop_time: int
    runahead: int
    bucket_interval: int = DEFAULT_INTERVAL_NS
    # cross-lane receive block width per iteration (0 = the queue capacity);
    # a lane receiving more packets in one iteration sheds the excess like
    # queue overflow (counted; strict mode raises)
    cross_capacity: int = 0

    @property
    def cross_cap(self) -> int:
        return min(self.cross_capacity, self.capacity) or self.capacity

    @property
    def merge_width(self) -> int:
        """W = C + K + Cx: the row the merge sorts."""
        return self.capacity + self.pops_per_iter + self.cross_cap

    def __post_init__(self) -> None:
        if self.n_lanes > MAX_LANES:
            raise ValueError(
                f"n_lanes={self.n_lanes} exceeds the packed-key limit {MAX_LANES}"
            )
        if self.cross_capacity < 0:
            raise ValueError(
                f"cross_capacity={self.cross_capacity} must be >= 0"
            )
        if not 1 <= self.pops_per_iter <= self.capacity:
            raise ValueError(
                f"pops_per_iter={self.pops_per_iter} must be in [1, capacity]"
            )


class LaneTables(NamedTuple):
    """Per-lane constants (not mutated by the simulation), all int32."""

    node_of: torch.Tensor  # [N] lane -> graph node index
    lat: torch.Tensor  # [G, G] latency ns (< 2**31 enforced)
    up_rate: torch.Tensor  # [N] bits/interval
    up_burst: torch.Tensor
    up_kfull: torch.Tensor  # [N] intervals that certainly fill the burst
    up_kfi: torch.Tensor  # [N] up_kfull * interval ns
    dn_rate: torch.Tensor
    dn_burst: torch.Tensor
    dn_kfull: torch.Tensor
    dn_kfi: torch.Tensor
    model: torch.Tensor  # [N] model id
    recv_mult: torch.Tensor  # [N] counting apps per lane
    p_size: torch.Tensor  # [N] datagram size
    p_int_hi: torch.Tensor  # [N] timer interval ns, as a pair
    p_int_lo: torch.Tensor
    p_peer: torch.Tensor  # [N] fixed peer (tgen-client)
    p_stride: torch.Tensor  # [N] (tgen-mesh)
    codel_div: torch.Tensor  # [1025]


class Workspace(NamedTuple):
    """Per-run buffers the kernels hand to each other (allocated once)."""

    # [4] int32: live (min head < stop), in_window (min head < window end),
    # and the min head pair (hi, lo) — written by queue_min_window
    ctl: torch.Tensor
    # [5, N, K] int32: the same-lane (timer re-arm) block: thi, tlo, auxh,
    # auxl, size; invalid entries carry the NEVER time pair
    self_blk: torch.Tensor
    # [6, K, N] int32: outbound packets: dst, thi, tlo, auxh, auxl, size;
    # invalid entries have dst = N, the NEVER time pair and zero words
    out_blk: torch.Tensor
    # [R, 6] int64 log records + [R] int32 valid flags, R = N*(K+Cx) + K*N:
    # first the merge tail (DROP_QUEUE, lane-major [N, K+Cx]), then the slot
    # records (slot-major [K, N]) — the reference's append order.
    # [1, 6] / [1] placeholders when logging is off.
    recs: torch.Tensor
    rec_valid: torch.Tensor
    # exchange scratch: per-destination counts, starts and fill cursors [N],
    # and the outbound entries grouped by destination [K*N]
    x_cnt: torch.Tensor
    x_start: torch.Tensor
    x_fill: torch.Tensor
    x_order: torch.Tensor


def make_workspace(p: LaneParams, device) -> Workspace:
    n, k = p.n_lanes, p.pops_per_iter
    n_rec = n * (k + p.cross_cap) + k * n if p.log_capacity else 1

    def z(*shape, dtype=i32):
        return torch.zeros(shape, dtype=dtype, device=device)

    return Workspace(
        ctl=z(4), self_blk=z(5, n, k), out_blk=z(6, k, n),
        recs=z(n_rec, 6, dtype=i64), rec_valid=z(n_rec),
        x_cnt=z(n), x_start=z(n), x_fill=z(n), x_order=z(k * n),
    )


# --------------------------------------------------------------------------
# component laws (identical arithmetic to the reference's bucket_charge_vec /
# codel_offer_arrays, on int32 pairs)
# --------------------------------------------------------------------------


def bucket_charge_vec(
    tokens, nr_hi, nr_lo, ld_hi, ld_lo, rate, burst, k_full, kfi,
    t_hi, t_lo, bits, active, interval
):
    """Masked pair form of the token-bucket charge; returns
    ``(tokens', nr_hi', nr_lo', ld_hi', ld_lo', dep_hi, dep_lo, waited)``.

    Refill by elapsed intervals: exactly within the ``k_full`` horizon
    (``kfi = k_full * interval`` ns, after which the bucket is certainly
    full), saturated and realigned to the interval grid beyond it.  FIFO
    law: the charge clock is ``max(t, last_depart)``, so departures are
    monotone per lane.  ``waited`` marks charges that had to wait for
    tokens."""
    unlimited = rate == 0
    act = active & ~unlimited
    t_hi, t_lo = pair_max(t_hi, t_lo, ld_hi, ld_lo)

    do_refill = act & pair_ge(t_hi, t_lo, nr_hi, nr_lo)
    diff = pair_sub_clamp(t_hi, t_lo, nr_hi, nr_lo, kfi)  # int32, exact < kfi
    full = diff >= kfi
    k = torch.where(do_refill, torch.minimum(diff // interval + 1, k_full), 0)
    tokens = torch.where(
        do_refill, torch.minimum(burst, tokens + k * rate), tokens
    )
    # next_refill': nr + k*interval unsaturated; saturated, the first grid
    # point past t (next_refill is always a multiple of the interval)
    part_hi, part_lo = pair_add32(nr_hi, nr_lo, k * interval)
    tmod = pair_mod_small(t_hi, t_lo, interval)
    g_hi, g_lo = pair_add32(*pair_sub32(t_hi, t_lo, tmod), interval)
    nr_hi = torch.where(do_refill, torch.where(full, g_hi, part_hi), nr_hi)
    nr_lo = torch.where(do_refill, torch.where(full, g_lo, part_lo), nr_lo)

    have = tokens >= bits
    wait_lane = act & ~have
    need = torch.clamp(bits - tokens, min=1)
    w = torch.where(wait_lane, -(-need // torch.clamp(rate, min=1)), 1)
    # the engine guarantees w*interval < 2**31 (minimum-rate guard)
    dep_hi, dep_lo = pair_add32(nr_hi, nr_lo, (w - 1) * interval)
    dep_hi, dep_lo = pair_sel(wait_lane, dep_hi, dep_lo, t_hi, t_lo)
    # beyond the burst horizon the refill saturates before subtracting
    w_r = torch.minimum(w, burst // torch.clamp(rate, min=1) + 1)
    new_tokens = torch.where(
        have,
        tokens - bits,
        torch.clamp(torch.minimum(burst, tokens + w_r * rate) - bits, min=0),
    )
    tokens = torch.where(act, new_tokens, tokens)
    nr2_hi, nr2_lo = pair_add32(nr_hi, nr_lo, w * interval)
    nr_hi = torch.where(wait_lane, nr2_hi, nr_hi)
    nr_lo = torch.where(wait_lane, nr2_lo, nr_lo)
    ld_hi = torch.where(act, dep_hi, ld_hi)
    ld_lo = torch.where(act, dep_lo, ld_lo)
    return tokens, nr_hi, nr_lo, ld_hi, ld_lo, dep_hi, dep_lo, wait_lane


def codel_offer_arrays(
    fat_hi, fat_lo, dn_hi, dn_lo, dcount, dropping,
    td_hi, td_lo, sojourn, active, codel_div,
):
    """Masked pair form of the RFC 8289 CoDel step; returns
    ``(fat_hi', fat_lo', dnext_hi', dnext_lo', dcount', dropping', drop)``.
    ``sojourn`` is an int32 clamped difference — exact for every compare
    in the law."""
    unset = fat_hi == CD_UNSET
    below = sojourn < codel_mod.TARGET_NS
    ent_hi, ent_lo = pair_add32(td_hi, td_lo, codel_mod.INTERVAL_NS)
    fatn_hi = torch.where(below, CD_UNSET, torch.where(unset, ent_hi, fat_hi))
    fatn_lo = torch.where(below, 0, torch.where(unset, ent_lo, fat_lo))
    ok_to_drop = (
        active & ~below & ~unset & pair_ge(td_hi, td_lo, fat_hi, fat_lo)
    )

    # dropping state machine
    drop_in_dropping = (
        active & dropping & ok_to_drop & pair_ge(td_hi, td_lo, dn_hi, dn_lo)
    )
    dcount_d = dcount + drop_in_dropping.to(dcount.dtype)
    div_idx_d = torch.clamp(dcount_d, max=codel_mod.DIV_TABLE_SIZE - 1)
    dnd_hi, dnd_lo = pair_add32(dn_hi, dn_lo, codel_div[div_idx_d.long()])
    dnd_hi = torch.where(drop_in_dropping, dnd_hi, dn_hi)
    dnd_lo = torch.where(drop_in_dropping, dnd_lo, dn_lo)

    # enter conditions: t_del - dnext < INTERVAL  |  t_del - fat_new >= INTERVAL
    dni_hi, dni_lo = pair_add32(dn_hi, dn_lo, codel_mod.INTERVAL_NS)
    fni_hi, fni_lo = pair_add32(fatn_hi, fatn_lo, codel_mod.INTERVAL_NS)
    enter = (
        active
        & ~dropping
        & ok_to_drop
        & (
            pair_lt(td_hi, td_lo, dni_hi, dni_lo)
            | pair_ge(td_hi, td_lo, fni_hi, fni_lo)
        )
    )
    recent = pair_lt(td_hi, td_lo, dni_hi, dni_lo)
    dcount_e = torch.where((dcount > 2) & recent, 2, 1).to(dcount.dtype)
    dne_hi, dne_lo = pair_add32(td_hi, td_lo, codel_div[dcount_e.long()])

    drop = drop_in_dropping | enter
    fat_out_hi = torch.where(active, fatn_hi, fat_hi)
    fat_out_lo = torch.where(active, fatn_lo, fat_lo)
    dropping_out = torch.where(active, (dropping & ok_to_drop) | enter, dropping)
    dcount_out = torch.where(
        enter, dcount_e, torch.where(drop_in_dropping, dcount_d, dcount)
    )
    dn_out_hi = torch.where(enter, dne_hi, dnd_hi)
    dn_out_lo = torch.where(enter, dne_lo, dnd_lo)
    return (fat_out_hi, fat_out_lo, dn_out_hi, dn_out_lo, dcount_out,
            dropping_out, drop)


# --------------------------------------------------------------------------
# plain versions of the four kernels (the CPU path, and the yardstick the
# CUDA kernels are held to on the card)
# --------------------------------------------------------------------------

# LaneState fields kernel A reads and writes per lane
_SLOT_FIELDS = (
    "send_seq", "local_seq",
    "up_tokens", "up_nr_hi", "up_nr_lo", "up_ld_hi", "up_ld_lo",
    "dn_tokens", "dn_nr_hi", "dn_nr_lo", "dn_ld_hi", "dn_ld_lo",
    "cd_fat_hi", "cd_fat_lo", "cd_dnext_hi", "cd_dnext_lo", "cd_drop_count",
    "cd_dropping", "m_sent", "m_peer_offset",
    "n_delivered", "n_codel", "recv_bytes", "n_sends",
)


def _process_slot(p: LaneParams, tb: LaneTables, v: dict, col: dict,
                  we_hi, we_lo, lanes):
    """The passive slot law on one popped column (all lanes, masked by
    kind); ``v`` holds the [N] state vectors and is updated in place.
    Returns the column's arm, outbound and record channels.  Mirrors the
    reference's ``_process_slot`` for the ported models."""
    n = p.n_lanes
    thi, tlo = col["thi"], col["tlo"]
    kind, src, seq, size = col["kind"], col["src"], col["seq"], col["size"]
    active = col["act"]
    model = tb.model
    interval = p.bucket_interval

    # ---- PACKET pops: down bucket + CoDel, delivered inline -------------
    is_pkt = active & (kind == PACKET)
    bits = (size + FRAME_OVERHEAD_BYTES) * 8
    (v["dn_tokens"], v["dn_nr_hi"], v["dn_nr_lo"], v["dn_ld_hi"],
     v["dn_ld_lo"], td_hi, td_lo, _dn_wait) = bucket_charge_vec(
        v["dn_tokens"], v["dn_nr_hi"], v["dn_nr_lo"], v["dn_ld_hi"],
        v["dn_ld_lo"], tb.dn_rate, tb.dn_burst, tb.dn_kfull, tb.dn_kfi,
        thi, tlo, bits, is_pkt, interval,
    )
    sojourn = pair_sub_clamp(td_hi, td_lo, thi, tlo, NEVER32)
    (v["cd_fat_hi"], v["cd_fat_lo"], v["cd_dnext_hi"], v["cd_dnext_lo"],
     v["cd_drop_count"], v["cd_dropping"], codel_drop) = codel_offer_arrays(
        v["cd_fat_hi"], v["cd_fat_lo"], v["cd_dnext_hi"], v["cd_dnext_lo"],
        v["cd_drop_count"], v["cd_dropping"], td_hi, td_lo, sojourn, is_pkt,
        tb.codel_div,
    )
    deliver = is_pkt & ~codel_drop
    v["n_codel"] = v["n_codel"] + (is_pkt & codel_drop)
    v["n_delivered"] = v["n_delivered"] + deliver
    # every ported model is passive: each counting app on the host adds
    # the size (recv_mult apps; 0 on empty hosts)
    v["recv_bytes"] = v["recv_bytes"] + torch.where(
        deliver, size * tb.recv_mult, 0)

    # ---- LOCAL pops: start markers (-1), anchors (-5), timer ticks ------
    is_loc = active & (kind == LOCAL)
    is_start = is_loc & (size == -1)
    is_timer = is_loc & (size >= 0)
    mesh_tick = is_timer & (model == M_TGEN_MESH) & (n > 1)
    client_tick = is_timer & (model == M_TGEN_CLIENT)
    do_send = mesh_tick | client_tick

    mesh_off = v["m_peer_offset"] % max(n - 1, 1)
    mesh_dst = (lanes + 1 + mesh_off) % n
    v["m_peer_offset"] = v["m_peer_offset"] + torch.where(
        mesh_tick, tb.p_stride, 0)
    v["m_sent"] = v["m_sent"] + client_tick
    dst = torch.where(mesh_tick, mesh_dst, tb.p_peer)
    out_size = tb.p_size

    snd_seq = v["send_seq"]
    v["send_seq"] = v["send_seq"] + do_send
    v["n_sends"] = v["n_sends"] + do_send

    out_bits = (out_size + FRAME_OVERHEAD_BYTES) * 8
    (v["up_tokens"], v["up_nr_hi"], v["up_nr_lo"], v["up_ld_hi"],
     v["up_ld_lo"], dep_hi, dep_lo, _up_wait) = bucket_charge_vec(
        v["up_tokens"], v["up_nr_hi"], v["up_nr_lo"], v["up_ld_hi"],
        v["up_ld_lo"], tb.up_rate, tb.up_burst, tb.up_kfull, tb.up_kfi,
        thi, tlo, out_bits, do_send, interval,
    )
    lat = tb.lat[tb.node_of.long(), tb.node_of[dst.long()].long()]
    arr_hi, arr_lo = pair_max(*pair_add32(dep_hi, dep_lo, lat), we_hi, we_lo)

    # ---- timer re-arm ----------------------------------------------------
    has_timer = (model == M_TGEN_MESH) | (model == M_TGEN_CLIENT)
    rearm = (
        (is_start & has_timer) | mesh_tick | client_tick
        | (is_timer & (model == M_TGEN_MESH) & (n == 1))
    )
    ti_hi, ti_lo = pair_add_pair(thi, tlo, tb.p_int_hi, tb.p_int_lo)
    arm_auxl = v["local_seq"]
    v["local_seq"] = v["local_seq"] + rearm

    zero = torch.zeros_like(lanes)
    arm = (
        torch.where(rearm, ti_hi, NEVER32), torch.where(rearm, ti_lo, NEVER32),
        pack_aux_hi(LOCAL, lanes), arm_auxl, zero,
    )
    out = (
        torch.where(do_send, dst, n),
        torch.where(do_send, arr_hi, NEVER32),
        torch.where(do_send, arr_lo, NEVER32),
        torch.where(do_send, pack_aux_hi(PACKET, lanes), 0),
        torch.where(do_send, snd_seq, 0),
        torch.where(do_send, out_size, 0),
    )
    # packet outcome record (zeros where no packet was popped)
    outcome = torch.where(codel_drop, DROP_CODEL, DELIVERED)
    rec = torch.stack([
        t_join(td_hi, td_lo), src.to(i64), lanes.to(i64), seq.to(i64),
        size.to(i64), outcome.to(i64),
    ], dim=1)
    rec = torch.where(is_pkt[:, None], rec, 0)
    return arm, out, rec, is_pkt


def lane_slots_plain(p: LaneParams, tb: LaneTables, s: LaneState,
                     ws: Workspace) -> None:
    """Kernel A, plain: pop up to K events per lane inside the window and
    run the passive slot law on each, in slot order.  Consumed slots
    become NEVER in place; the state vectors are updated in place; the
    self, outbound and record blocks go to ``ws``."""
    if not int(ws.ctl[0]):
        return
    n, k = p.n_lanes, p.pops_per_iter
    lanes = torch.arange(n, dtype=i32, device=s.q_thi.device)
    thi = s.q_thi[:, :k].clone()
    tlo = s.q_tlo[:, :k].clone()
    # every lane is passive: it co-pops any prefix inside the window
    act = pair_lt(thi, tlo, s.now_we_hi, s.now_we_lo)
    s.q_thi[:, :k] = torch.where(act, NEVER32, thi)
    s.q_tlo[:, :k] = torch.where(act, NEVER32, tlo)
    kind, src = unpack_aux_hi(s.q_auxh[:, :k])
    v = {f: getattr(s, f).clone() for f in _SLOT_FIELDS}
    rec_base = n * (k + p.cross_cap)
    # pops are row prefixes: past the longest one no lane is active, the
    # state cannot change, and every emit is empty
    n_live = int(act.sum(dim=1).max()) if n else 0
    for j in range(n_live, k):
        ws.self_blk[:2, :, j] = NEVER32
        ws.self_blk[2, :, j] = pack_aux_hi(LOCAL, lanes)
        ws.self_blk[4, :, j] = 0
        ws.out_blk[:, j] = torch.tensor(
            [n, NEVER32, NEVER32, 0, 0, 0], dtype=i32, device=lanes.device
        )[:, None]
        if p.log_capacity:
            rows = slice(rec_base + j * n, rec_base + (j + 1) * n)
            ws.recs[rows] = 0
            ws.rec_valid[rows] = 0
    for j in range(n_live):
        col = {
            "thi": thi[:, j], "tlo": tlo[:, j], "kind": kind[:, j],
            "src": src[:, j], "seq": s.q_auxl[:, j], "size": s.q_size[:, j],
            "act": act[:, j],
        }
        arm, out, rec, rec_valid = _process_slot(
            p, tb, v, col, s.now_we_hi, s.now_we_lo, lanes)
        for w in range(5):
            ws.self_blk[w, :, j] = arm[w]
        for w in range(6):
            ws.out_blk[w, j] = out[w]
        if p.log_capacity:
            rows = slice(rec_base + j * n, rec_base + (j + 1) * n)
            ws.recs[rows] = rec
            ws.rec_valid[rows] = rec_valid.to(i32)
    for j in range(n_live, k):
        ws.self_blk[3, :, j] = v["local_seq"]
    for f in _SLOT_FIELDS:
        getattr(s, f).copy_(v[f])


def _key_order(thi, tlo, auxh, auxl):
    """Per-row permutation sorting by the 4-word key (signed int32 words,
    lexicographic), ties kept in index order: a stable sort by the aux
    key, then a stable sort by the time key."""
    def fold(hi, lo):  # exact lexicographic order of two int32 words
        return (hi.to(i64) << 32) + (lo.to(i64) + (1 << 31))

    perm = torch.sort(fold(auxh, auxl), dim=1, stable=True).indices
    t_key = torch.gather(fold(thi, tlo), 1, perm)
    return torch.gather(perm, 1, torch.sort(t_key, dim=1, stable=True).indices)


def exchange_merge_plain(p: LaneParams, s: LaneState, ws: Workspace) -> None:
    """Kernel B, plain: the cross-lane exchange and the keyed row merge.

    Outbound entries are grouped by destination in (slot, source lane)
    order; each lane takes the first Cx of its group as its cross block
    and counts the rest as shed (``n_queue``).  Then each row of
    ``[queue C | self K | cross Cx]`` is sorted by the event key, ties in
    index order, and the first C kept; real events past column C are
    queue overflow (``n_queue``, and DROP_QUEUE records when logging)."""
    if not int(ws.ctl[0]):
        return
    n, c, k, cx = p.n_lanes, p.capacity, p.pops_per_iter, p.cross_cap
    dev = s.q_thi.device
    out = ws.out_blk.reshape(6, k * n)
    dst = out[0].long()
    order = torch.sort(dst, stable=True).indices
    cnt = torch.bincount(dst, minlength=n + 1)[:n]
    start = torch.cumsum(cnt, 0) - cnt
    r = torch.arange(cx, device=dev)
    in_seg = r[None, :] < cnt[:, None]
    msel = order[torch.clamp(start[:, None] + r[None, :], max=k * n - 1)]
    cross = [
        torch.where(in_seg, out[w][msel], NEVER32 if w < 3 else 0)
        for w in range(1, 6)
    ]
    lost_pre = torch.clamp(cnt - cx, min=0).to(i32)

    q = (s.q_thi, s.q_tlo, s.q_auxh, s.q_auxl, s.q_size)
    merged = [
        torch.cat([q[w], ws.self_blk[w], cross[w]], dim=1) for w in range(5)
    ]
    perm = _key_order(*merged[:4])
    merged = [torch.gather(m, 1, perm) for m in merged]
    for w in range(5):
        q[w].copy_(merged[w][:, :c])
    tail = [m[:, c:] for m in merged]
    tail_valid = tail[0] != NEVER32
    s.n_queue.add_(tail_valid.sum(dim=1, dtype=i32) + lost_pre)
    if p.log_capacity:
        _kind, t_src = unpack_aux_hi(tail[2])
        rows = torch.arange(n, dtype=i64, device=dev)[:, None].expand_as(t_src)
        rec = torch.stack([
            t_join(tail[0], tail[1]), t_src.to(i64), rows, tail[3].to(i64),
            tail[4].to(i64), torch.full_like(rows, DROP_QUEUE),
        ], dim=2)
        rec = torch.where(tail_valid[:, :, None], rec, 0)
        ws.recs[: n * (k + cx)] = rec.reshape(-1, 6)
        ws.rec_valid[: n * (k + cx)] = tail_valid.reshape(-1).to(i32)
    s.iters.add_(1)


def queue_min_window_plain(p: LaneParams, s: LaneState, ws: Workspace,
                           advance: bool) -> None:
    """Kernel C, plain: the earliest head over all queues, then the window
    law.  With ``advance``, a live step whose head lies at or past the
    window end opens the next window ``[head, min(head + runahead,
    stop))`` and counts a round.  Writes ``ctl = (live, in_window,
    head_hi, head_lo)``."""
    mh, ml = _pairs.pair_min_lanes(s.q_thi[:, 0], s.q_tlo[:, 0])
    stop_hi, stop_lo = p.stop_time >> 31, p.stop_time & MASK31
    live = pair_lt(mh, ml, stop_hi, stop_lo)
    if advance:
        fresh = live & pair_ge(mh, ml, s.now_we_hi, s.now_we_lo)
        c_hi, c_lo = pair_add32(mh, ml, p.runahead)
        stop_t = torch.tensor([stop_hi, stop_lo], dtype=i32, device=mh.device)
        c_hi, c_lo = pair_sel(pair_lt(c_hi, c_lo, stop_hi, stop_lo),
                              c_hi, c_lo, stop_t[0], stop_t[1])
        s.now_we_hi.copy_(torch.where(fresh, c_hi, s.now_we_hi))
        s.now_we_lo.copy_(torch.where(fresh, c_lo, s.now_we_lo))
        s.rounds.add_(fresh.to(i32))
    in_window = live & pair_lt(mh, ml, s.now_we_hi, s.now_we_lo)
    ws.ctl.copy_(torch.stack([live.to(i32), in_window.to(i32), mh, ml]))


def append_log_plain(p: LaneParams, s: LaneState, ws: Workspace) -> None:
    """Kernel D, plain: append the valid records of ``ws.recs`` to the log
    in buffer order, counting records past the log's end as lost."""
    if not int(ws.ctl[0]):
        return
    valid = ws.rec_valid.bool()
    pos = s.log_count.to(i64) + torch.cumsum(valid.to(i64), 0) - 1
    ok = valid & (pos < p.log_capacity)
    s.log[pos[ok]] = ws.recs[ok]
    n_valid = valid.sum(dtype=i32)
    s.log_count.add_(n_valid)
    s.log_lost.add_(n_valid - ok.sum(dtype=i32))


# --------------------------------------------------------------------------
# drivers
# --------------------------------------------------------------------------


def _build_iteration(p: LaneParams, tb: LaneTables, s: LaneState):
    """One iteration of the window loop (kernels A, B and, when logging, D)
    and the step that precedes it (kernel C), bound to this run's state."""
    from . import kernels

    args = kernels.LaneArgs(p, tb, s, make_workspace(p, s.q_thi.device))

    def window(advance: bool) -> None:
        kernels.queue_min_window(args, advance)

    def iteration() -> None:
        kernels.lane_slots(args)
        kernels.exchange_merge(args)
        if p.log_capacity:
            kernels.append_log(args)

    return args.ws, window, iteration


def _build_round(p: LaneParams, tb: LaneTables, s: LaneState):
    """The step driver: ``round_fn() -> done`` advances ``s`` by one
    window (the reference's ``_build_round``): open the window at the
    earliest head, then iterate while a head lies inside it.  A finished
    simulation is left unchanged.  Reads the flags from the device after
    every iteration."""
    ws, window, iteration = _build_iteration(p, tb, s)

    def round_fn() -> bool:
        window(True)
        if not int(ws.ctl[0]):
            return True
        while True:
            iteration()
            window(False)
            if not int(ws.ctl[1]):
                return False

    return round_fn


# device-loop steps between two reads of the live flag
CHECK_EVERY = 32


def _build_full_run(p: LaneParams, tb: LaneTables, s: LaneState):
    """The device loop (the reference's ``_build_full_run``): a flat loop
    of steps — window law, then one iteration — that reads the ``live``
    flag from the device once every ``CHECK_EVERY`` steps.  Steps after
    the end are no-ops (every kernel is gated on the flag), so the
    counters match the step driver's exactly."""
    ws, window, iteration = _build_iteration(p, tb, s)

    def full_run() -> None:
        while True:
            for _ in range(CHECK_EVERY):
                window(True)
                iteration()
            if not int(ws.ctl[0]):
                return

    return full_run
