"""Lane backend of the port: state, laws, and the plain versions of the lane
kernels, plus the two drivers (round by round, and the device loop).

Counterpart of the JAX package's ``backend/lanes.py`` for its untiered
lane path: hosts run ``tgen-mesh``, ``tgen-client``, ``tgen-server``,
``phold``, ``ping``, ``stream-client``, ``stream-server`` or nothing, over
graphs with or without loss, with a static or dynamic runahead.  One
**lane per simulated host**; per-host state lives in ``[N]`` or ``[N, C]``
tensors, stream flows on ``[2S]`` endpoint rows (``lanes_stream.py``), and
one iteration of the window loop is four or five kernels (``kernels.py``
binds their CUDA versions):

- A ``lane_slots``: pop up to K events inside the window under the co-pop
  rule, run the slot law on each (down bucket, CoDel, inline delivery or a
  DELIVERY self-insert; app sends — tgen ticks, phold hops to a threefry
  peer, ping requests and echoes — with the up bucket, the latency gather
  and the threefry loss draw; timer re-arms; the lane-TCP stream arm:
  handshake, congestion control, RTO and the pump burst of a stimulated
  flow, its control send, data burst and RTO arm), emit the self,
  outbound, stream and record blocks;
- B ``exchange_merge``: the cross-lane exchange into an ``[N, Cx]`` block
  and the keyed row merge of ``[old C | self | cross Cx]``, keeping the
  first C (the self block is ``[N, K]`` re-arms when every model is
  passive, else ``[N, 2K]``: DELIVERY inserts, then re-arms).  Star stream
  configs send their stream entries through this exchange too; stream
  events carry two payload words (``q_phi``, ``q_plo``);
- E ``stream_rows_merge`` (one-to-one stream configs only): the split
  exchange — each endpoint row's stream entries come from static
  positions of the stream block and merge into its lane's queue row;
- C ``queue_min_window``: the global earliest head, the window law (static
  or dynamic runahead) and the ``live`` flag;
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

from ..core import rng as rng_mod
from ..core import time as stime
from ..net import codel as codel_mod
from ..net.ltcp import PUMP_BURST
from ..net.token_bucket import DEFAULT_INTERVAL_NS, FRAME_OVERHEAD_BYTES
from . import lanes_pairs as _pairs
from . import lanes_stream as lstr
from .results import DELIVERED, DROP_CODEL, DROP_LOSS, DROP_QUEUE

i32 = torch.int32
i64 = torch.int64

# event kinds (the reference's core.event.EventKind)
PACKET, LOCAL, DELIVERY = 0, 1, 2

NEVER = stime.NEVER

# model ids: the reference's numbering, so model tables compare equal.
# PASSIVE models only count deliveries: those apply inline at packet
# arrival, and their lanes may co-pop any prefix of their queue.  Active
# models (phold, ping) run app logic on a DELIVERY event, so their lanes
# get DELIVERY self-inserts and co-pop only same-instant PACKET prefixes.
(M_NONE, M_PHOLD, M_TGEN_MESH, M_TGEN_CLIENT, M_TGEN_SERVER, M_PING_CLIENT,
 M_PING_SERVER, M_STREAM_CLIENT, M_STREAM_SERVER) = range(9)
PASSIVE_MODELS = frozenset({M_NONE, M_TGEN_MESH, M_TGEN_CLIENT, M_TGEN_SERVER})
STREAM_MODELS = frozenset({M_STREAM_CLIENT, M_STREAM_SERVER})

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
    ``LaneState`` restricted to its untiered lane path.  Where the
    reference holds ``()`` (no stream model present: ``q_phi``, ``q_plo``,
    ``stream``), the port holds an empty ``[0]`` int32 tensor."""

    # event queues [N, C]: int32 key words, kept sorted by the 4-word key;
    # a (NEVER32, NEVER32) time pair marks an empty slot
    q_thi: torch.Tensor
    q_tlo: torch.Tensor
    q_auxh: torch.Tensor  # kind << 29 | src << 12
    q_auxl: torch.Tensor  # seq
    q_size: torch.Tensor
    # stream payload words [N, C] (lanes_stream.pack_pay: flags << 26 | seq,
    # ack), riding every permutation of the key words
    q_phi: torch.Tensor
    q_plo: torch.Tensor
    # per-lane counters [N] int32 (checked for wrap at collect)
    send_seq: torch.Tensor
    local_seq: torch.Tensor
    app_draws: torch.Tensor  # APP_STREAM draws taken (phold peer picks)
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
    m_sent: torch.Tensor  # tgen-client / ping messages sent
    m_peer_offset: torch.Tensor  # tgen-mesh round-robin cursor
    # stats [N]
    n_delivered: torch.Tensor
    n_loss: torch.Tensor
    n_codel: torch.Tensor
    n_queue: torch.Tensor
    recv_bytes: torch.Tensor
    n_sends: torch.Tensor
    n_hops: torch.Tensor  # app-processed deliveries (phold hop count)
    # event log [max(L, 1), 6] int64 (time, src, dst, seq, size, outcome)
    log: torch.Tensor
    log_count: torch.Tensor  # int32 scalar
    log_lost: torch.Tensor  # int32 scalar: records dropped on log overflow
    # stream flows [2, S, F] int32 (lanes_stream): client endpoints, then
    # their servers — the reference's StreamState(cl, sv) stacked
    stream: torch.Tensor
    # round bookkeeping (int32 scalars)
    rounds: torch.Tensor
    iters: torch.Tensor
    now_we_hi: torch.Tensor  # current window end, as a pair
    now_we_lo: torch.Tensor
    # smallest latency sent over so far (NEVER32 = none): dynamic runahead
    min_used_lat: torch.Tensor  # int32 scalar


@dataclasses.dataclass(frozen=True)
class LaneParams:
    """Static simulation parameters."""

    n_lanes: int
    capacity: int  # C
    pops_per_iter: int  # K
    log_capacity: int  # L (0 disables logging)
    stop_time: int
    runahead: int
    seed: int = 1
    bootstrap_end: int = 0  # sends before this time are never lost
    bucket_interval: int = DEFAULT_INTERVAL_NS
    # models present in this simulation: a passive-only simulation has no
    # DELIVERY self-insert channel (the self block is K wide) and its lanes
    # co-pop any prefix
    models_present: tuple = (M_NONE, M_PHOLD, M_TGEN_MESH, M_TGEN_CLIENT,
                             M_TGEN_SERVER, M_PING_CLIENT, M_PING_SERVER)
    # any edge with packet_loss > 0?  Loss-free graphs skip the loss draw
    has_loss: bool = False
    # dynamic runahead (runahead.rs:44-118): the window widens to the
    # smallest latency actually sent over so far, never below the floor
    dynamic_runahead: bool = False
    runahead_floor: int = 1
    # cross-lane receive block width per iteration (0 = the queue capacity);
    # a lane receiving more packets in one iteration sheds the excess like
    # queue overflow (counted; strict mode raises)
    cross_capacity: int = 0
    # every stream server serves exactly one client: stream entries take
    # the split exchange (kernel E) instead of the combined one
    stream_one_to_one: bool = False
    # the stream-client lanes, in flow order (S = their count)
    stream_clients: tuple = ()
    # every possible window ends before RTO_MIN: stream lanes co-pop wider
    # prefixes (see _pop_mask)
    stream_wide_pop: bool = False

    @property
    def cross_cap(self) -> int:
        return min(self.cross_capacity, self.capacity) or self.capacity

    @property
    def stream_present(self) -> bool:
        return bool(set(self.models_present) & STREAM_MODELS)

    @property
    def s_flows(self) -> int:
        return len(self.stream_clients)

    @property
    def split(self) -> bool:
        """Stream entries take the split exchange (kernel E)."""
        return self.stream_present and self.stream_one_to_one

    @property
    def words(self) -> int:
        """Words per queue entry: the key, the size and, when streams run,
        the two payload words."""
        return 7 if self.stream_present else 5

    @property
    def stream_entries(self) -> int:
        """Stream block entries per iteration: control sends and RTO arms
        [K, 2S] each, then the data bursts [K, B, S]."""
        if not self.stream_present:
            return 0
        k, s = self.pops_per_iter, self.s_flows
        return 4 * k * s + k * PUMP_BURST * s

    @property
    def exchange_entries(self) -> int:
        """Entries B's exchange sorts: the K*N outbound packets, then the
        stream block unless the split exchange (E) takes it."""
        k, n = self.pops_per_iter, self.n_lanes
        return k * n + (0 if self.split else self.stream_entries)

    @property
    def stream_row_width(self) -> int:
        """W_s = 2K + K*B: the split exchange's candidates per endpoint row
        (control sends, RTO arms, bursts; client rows pad the bursts)."""
        k = self.pops_per_iter
        return 2 * k + k * PUMP_BURST

    @property
    def all_passive(self) -> bool:
        return set(self.models_present) <= PASSIVE_MODELS

    @property
    def draws(self) -> bool:
        """Does kernel A draw from threefry (loss, or phold peers)?"""
        return self.has_loss or M_PHOLD in self.models_present

    @property
    def self_width(self) -> int:
        """Self block columns: K re-arms, plus K DELIVERY inserts unless
        every model is passive."""
        k = self.pops_per_iter
        return k if self.all_passive else 2 * k

    @property
    def merge_width(self) -> int:
        """W = C + self width + Cx: the row the merge sorts."""
        return self.capacity + self.self_width + self.cross_cap

    @property
    def rec_offsets(self) -> tuple:
        """The record groups of the workspace's record block, in the
        reference's append order: the merge tail [N, self + Cx] from 0,
        then the starts of the split exchange's tail [2S, W_s], the popped
        slots [K, N], the stream control sends' losses [K, 2S] and the
        bursts' losses [K, B, S], and the block's end."""
        n, k, s = self.n_lanes, self.pops_per_iter, self.s_flows
        tail = n * (self.self_width + self.cross_cap)
        split = 2 * s * self.stream_row_width if self.split else 0
        slots = tail + split
        srec = slots + k * n
        brec = srec + (2 * k * s if self.stream_present else 0)
        end = brec + (k * PUMP_BURST * s if self.stream_present else 0)
        return tail, slots, srec, brec, end

    @property
    def n_records(self) -> int:
        return self.rec_offsets[-1]

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
        if self.stream_present != bool(self.stream_clients):
            raise ValueError("stream models need their client lanes (and "
                             "stream_clients needs stream models)")


class LaneTables(NamedTuple):
    """Per-lane constants (not mutated by the simulation), int32 but for
    the int64 loss thresholds."""

    node_of: torch.Tensor  # [N] lane -> graph node index
    lat: torch.Tensor  # [G, G] latency ns (< 2**31 enforced)
    # [G, G] int64 loss thresholds in core.rng.loss_threshold's u64 domain:
    # a send is lost iff its 32-bit draw < thresh (2**32: always).  The
    # reference splits it into thresh_u32 (uint32) and thresh_all (bool);
    # bridge.py joins them
    thresh: torch.Tensor
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
    p_peer: torch.Tensor  # [N] fixed peer (tgen-client, ping client)
    p_count: torch.Tensor  # [N] message budget (ping client)
    p_stride: torch.Tensor  # [N] (tgen-mesh)
    codel_div: torch.Tensor  # [1025]
    # stream flows on [2S] endpoint rows: rows 0..S-1 the clients, S..2S-1
    # their servers (flow order); [2] placeholders when no stream model is
    # present, as in the reference
    flow_lanes: torch.Tensor  # endpoint's own lane
    flow_peers: torch.Tensor  # endpoint's peer lane
    flow_clid: torch.Tensor  # the flow's client lane
    flow_lat: torch.Tensor  # latency lane -> peer
    # int64 loss threshold lane -> peer (the reference's flow_thresh_u32 +
    # flow_thresh_all, joined as for thresh)
    flow_thresh: torch.Tensor
    flow_segs: torch.Tensor  # data segments (zeros on the server half)
    flow_mss: torch.Tensor
    flow_last: torch.Tensor
    flow_cc: torch.Tensor  # ltcp.CC_RENO / CC_CUBIC
    flow_up_rate: torch.Tensor  # the endpoint lane's up bucket
    flow_up_burst: torch.Tensor
    flow_up_kfull: torch.Tensor
    flow_up_kfi: torch.Tensor
    # lane -> its endpoint rows (the port's own, for kernel A's one thread
    # per lane): rows lane_ep_rows[lane_ep_start[l]:lane_ep_start[l + 1]]
    lane_ep_start: torch.Tensor  # [N + 1]
    lane_ep_rows: torch.Tensor  # [max(2S, 2)]


class Workspace(NamedTuple):
    """Per-run buffers the kernels hand to each other (allocated once)."""

    # [4] int32: live (min head < stop), in_window (min head < window end),
    # and the min head pair (hi, lo) — written by queue_min_window
    ctl: torch.Tensor
    # [W, N, S] int32: the same-lane block, S = self_width: DELIVERY
    # inserts in columns [0, K) unless every model is passive, then the
    # timer re-arms; words (LaneParams.words) thi, tlo, auxh, auxl, size,
    # and with streams phi, plo; invalid entries carry the NEVER time pair
    self_blk: torch.Tensor
    # [6, K, N] int32: outbound packets: dst, thi, tlo, auxh, auxl, size;
    # invalid entries have dst = N, the NEVER time pair and zero words
    out_blk: torch.Tensor
    # [8, E] int32 stream entries (LaneParams.stream_entries; [8, 1] without
    # streams): dst, thi, tlo, auxh, auxl, size, phi, plo — control sends
    # at j*2S + e, RTO arms at K*2S + j*2S + e, burst segments at
    # 4*K*S + (j*B + u)*S + f; invalid entries as in out_blk
    sx_blk: torch.Tensor
    # [R, 6] int64 log records + [R] int32 valid flags (LaneParams
    # .rec_offsets): the merge tail (DROP_QUEUE, lane-major [N, S+Cx]), the
    # split exchange's tail, the slot records (slot-major [K, N]), then the
    # stream losses — the reference's append order.  [1, 6] / [1]
    # placeholders when logging is off.
    recs: torch.Tensor
    rec_valid: torch.Tensor
    # exchange scratch: per-destination counts, starts and fill cursors [N],
    # and the exchanged entries grouped by destination: the K*N outbound
    # packets, then (star stream configs) the stream block's entries
    x_cnt: torch.Tensor
    x_start: torch.Tensor
    x_fill: torch.Tensor
    x_order: torch.Tensor


def make_workspace(p: LaneParams, device) -> Workspace:
    n, k = p.n_lanes, p.pops_per_iter
    n_rec = p.n_records if p.log_capacity else 1

    def z(*shape, dtype=i32):
        return torch.zeros(shape, dtype=dtype, device=device)

    return Workspace(
        ctl=z(4), self_blk=z(p.words, n, p.self_width), out_blk=z(6, k, n),
        sx_blk=z(8, max(p.stream_entries, 1)),
        recs=z(n_rec, 6, dtype=i64), rec_valid=z(n_rec),
        x_cnt=z(n), x_start=z(n), x_fill=z(n), x_order=z(p.exchange_entries),
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


def bucket_charge_chained_vec(
    tokens, nr_hi, nr_lo, ld_hi, ld_lo, rate, burst, bits, active, interval,
    t_hi, t_lo
):
    """One charge of an intra-instant chain, for every burst unit after the
    first (the reference's ``bucket_charge_chained_vec``): every unit
    shares the stimulus time, so after unit 1 the charge clock is the last
    departure and the refill cannot fire; the law reduces to the wait
    machinery.  ``t`` still stamps a no-wait departure on unlimited lanes
    (``rate == 0``), whose last departure never advances."""
    unlimited = rate == 0
    act = active & ~unlimited
    have = tokens >= bits
    wait_lane = act & ~have
    need = torch.clamp(bits - tokens, min=1)
    w = torch.where(wait_lane, -(-need // torch.clamp(rate, min=1)), 1)
    te_hi, te_lo = pair_max(t_hi, t_lo, ld_hi, ld_lo)
    dep_hi, dep_lo = pair_add32(nr_hi, nr_lo, (w - 1) * interval)
    dep_hi, dep_lo = pair_sel(wait_lane, dep_hi, dep_lo, te_hi, te_lo)
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
    "send_seq", "local_seq", "app_draws",
    "up_tokens", "up_nr_hi", "up_nr_lo", "up_ld_hi", "up_ld_lo",
    "dn_tokens", "dn_nr_hi", "dn_nr_lo", "dn_ld_hi", "dn_ld_lo",
    "cd_fat_hi", "cd_fat_lo", "cd_dnext_hi", "cd_dnext_lo", "cd_drop_count",
    "cd_dropping", "m_sent", "m_peer_offset",
    "n_delivered", "n_loss", "n_codel", "recv_bytes", "n_sends", "n_hops",
)


def rand_u32_lane(seed: int, stream, counter32):
    """The lane engine's threefry draw (``core.rng.rand_u32`` with counter
    word ``c1 = 0``): bit-identical to it for counters below 2**32.  The
    reference's ``_seed_keys`` reduces to the static seed here (the port
    has no sweep path that traces seeds)."""
    s_lo, s_hi = rng_mod.split_seed(seed)
    return rng_mod.rand_u32_words(s_lo, s_hi, stream, counter32)


def passive_lanes(model):
    """[N] bool: the lane's model is passive (delivery only counts)."""
    out = torch.zeros_like(model, dtype=torch.bool)
    for m in sorted(PASSIVE_MODELS):
        out |= model == m
    return out


def _pop_mask(p: LaneParams, tb: LaneTables, passive, thi, tlo, kind,
              we_hi, we_lo):
    """[N, K] bool: the head columns this iteration pops — the co-pop rule
    (the reference's ``_build_iter.iter_body``).  Passive lanes co-pop any
    prefix inside the window; active lanes may generate same-window events
    (DELIVERY inserts) that the CPU heap pops before later queue entries,
    so they co-pop only a same-instant prefix of PACKETs, or column 0
    alone.  With ``stream_wide_pop`` (every window ends before RTO_MIN, so
    a stream DELIVERY pop inserts nothing into the window), stream lanes
    also take any prefix free of LOCAL events (one-to-one pairing) or a
    PACKET-only or DELIVERY-only prefix (star).  Rows are sorted, so each
    rule gives a row prefix."""
    inside = pair_lt(thi, tlo, we_hi, we_lo)
    if p.all_passive:
        return inside
    same_t = (thi == thi[:, :1]) & (tlo == tlo[:, :1])
    pkt_prefix = torch.cumprod((kind == PACKET).to(i32), dim=1).bool()
    first_col = (torch.arange(thi.shape[1], device=thi.device) == 0)[None, :]
    allowed = passive[:, None] | (same_t & (pkt_prefix | first_col))
    if p.stream_present and p.stream_wide_pop:
        stream_lane = (tb.model == M_STREAM_CLIENT) | (tb.model == M_STREAM_SERVER)
        if p.stream_one_to_one:
            prefix = torch.cumprod((kind != LOCAL).to(i32), dim=1).bool()
        else:
            prefix = pkt_prefix | torch.cumprod(
                (kind == DELIVERY).to(i32), dim=1).bool()
        allowed = allowed | (stream_lane[:, None] & prefix)
    return inside & allowed


def _process_slot(p: LaneParams, tb: LaneTables, v: dict, col: dict,
                  we_hi, we_lo, lanes, lw: dict):
    """The slot law on one popped column (all lanes, masked by kind and
    model); ``v`` holds the [N] state vectors and ``min_used_lat``, and the
    law rebinds its entries to new tensors (it never writes into them).
    ``lw`` holds per-lane constants of the iteration (``passive``, the
    lanes' PACKET and LOCAL key words).  Returns the column's
    DELIVERY-insert, re-arm, outbound and record channels.  Mirrors the
    reference's ``_process_slot`` for the ported models."""
    n = p.n_lanes
    thi, tlo = col["thi"], col["tlo"]
    kind, src, seq, size = col["kind"], col["src"], col["seq"], col["size"]
    active = col["act"]
    model = tb.model
    interval = p.bucket_interval
    passive = lw["passive"]
    false_n = torch.zeros_like(active)
    # the laws below are masked: a law whose mask is empty in this column
    # changes nothing and is skipped (its outputs are then never read)

    # ---- PACKET pops: down bucket + CoDel -------------------------------
    is_pkt = active & (kind == PACKET)
    td_hi, td_lo, codel_drop = thi, tlo, false_n
    if bool(is_pkt.any()):
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
            v["cd_drop_count"], v["cd_dropping"], td_hi, td_lo, sojourn,
            is_pkt, tb.codel_div,
        )
    deliver = is_pkt & ~codel_drop
    v["n_codel"] = v["n_codel"] + (is_pkt & codel_drop)
    v["n_delivered"] = v["n_delivered"] + deliver
    # passive lanes consume the delivery inline: each counting app on the
    # host adds the size (recv_mult apps; 0 on empty hosts).  Active lanes
    # get a DELIVERY self-insert keyed by the packet's (src, seq)
    v["recv_bytes"] = v["recv_bytes"] + torch.where(
        deliver & passive, size * tb.recv_mult, 0)
    ins = None  # a passive-only run has no insert channel
    if not p.all_passive:
        ins_valid = deliver & ~passive
        ins = (
            torch.where(ins_valid, td_hi, NEVER32),
            torch.where(ins_valid, td_lo, NEVER32),
            torch.where(ins_valid, pack_aux_hi(DELIVERY, src), 0),
            torch.where(ins_valid, seq, 0),
            torch.where(ins_valid, size, 0),
        )
        if p.stream_present:  # stream segments keep their payload words
            ins += (torch.where(ins_valid, col["phi"], 0),
                    torch.where(ins_valid, col["plo"], 0))

    # ---- DELIVERY pops: phold sends on, the ping server echoes ----------
    is_del = active & (kind == DELIVERY)
    del_send_phold = is_del & (model == M_PHOLD)
    del_send_echo = is_del & (model == M_PING_SERVER)
    v["n_hops"] = v["n_hops"] + del_send_phold

    # ---- LOCAL pops: start markers (-1), anchors (-5), timers -----------
    # (phold's initial messages are size-0 LOCAL events: timers that send)
    is_loc = active & (kind == LOCAL)
    is_start = is_loc & (size == -1)
    is_timer = is_loc & (size >= 0)
    loc_send_phold = is_timer & (model == M_PHOLD)
    mesh_tick = is_timer & (model == M_TGEN_MESH) & (n > 1)
    client_tick = is_timer & (model == M_TGEN_CLIENT)
    ping_tick = is_timer & (model == M_PING_CLIENT) & (v["m_sent"] < tb.p_count)
    send_phold = del_send_phold | loc_send_phold
    do_send = send_phold | del_send_echo | mesh_tick | client_tick | ping_tick

    # phold peer: an APP_STREAM draw at counter app_draws, consumed only
    # where a phold send happens
    if M_PHOLD in p.models_present and bool(send_phold.any()):
        draw = rand_u32_lane(p.seed, lanes.to(i64) | rng_mod.APP_STREAM,
                             v["app_draws"])
        r = rng_mod.u32_below(draw, max(n - 1, 1))
        phold_dst = lanes if n == 1 else ((lanes + 1 + r) % n).to(i32)
        v["app_draws"] = v["app_draws"] + send_phold
    else:
        phold_dst = lanes
    mesh_off = v["m_peer_offset"] % max(n - 1, 1)
    mesh_dst = (lanes + 1 + mesh_off) % n
    v["m_peer_offset"] = v["m_peer_offset"] + torch.where(
        mesh_tick, tb.p_stride, 0)
    v["m_sent"] = v["m_sent"] + (client_tick | ping_tick)
    dst = torch.where(
        send_phold, phold_dst,
        torch.where(del_send_echo, src,
                    torch.where(mesh_tick, mesh_dst, tb.p_peer)))
    out_size = torch.where(del_send_echo, size, tb.p_size)

    snd_seq = v["send_seq"]
    v["send_seq"] = v["send_seq"] + do_send
    v["n_sends"] = v["n_sends"] + do_send

    any_send = bool(do_send.any())
    dep_hi, dep_lo = thi, tlo
    if any_send:
        out_bits = (out_size + FRAME_OVERHEAD_BYTES) * 8
        (v["up_tokens"], v["up_nr_hi"], v["up_nr_lo"], v["up_ld_hi"],
         v["up_ld_lo"], dep_hi, dep_lo, _up_wait) = bucket_charge_vec(
            v["up_tokens"], v["up_nr_hi"], v["up_nr_lo"], v["up_ld_hi"],
            v["up_ld_lo"], tb.up_rate, tb.up_burst, tb.up_kfull, tb.up_kfi,
            thi, tlo, out_bits, do_send, interval,
        )
    my_node = tb.node_of.long()
    dst_node = tb.node_of[dst.long()].long()
    lat = tb.lat[my_node, dst_node]

    # loss: a LOSS_STREAM draw at counter = the send's sequence number;
    # sends before bootstrap_end are never lost
    if p.has_loss and any_send:
        u = rand_u32_lane(p.seed, lanes.to(i64) | rng_mod.LOSS_STREAM,
                          snd_seq)
        bs_hi, bs_lo = p.bootstrap_end >> 31, p.bootstrap_end & MASK31
        lost = (do_send & pair_ge(thi, tlo, bs_hi, bs_lo)
                & (u < tb.thresh[my_node, dst_node]))
        v["n_loss"] = v["n_loss"] + lost
    else:
        lost = false_n
    if p.dynamic_runahead and any_send:
        # every send counts, lost or not (the CPU law records the path
        # before the loss draw)
        v["min_used_lat"] = torch.minimum(
            v["min_used_lat"], torch.where(do_send, lat, NEVER32).min())
    arr_hi, arr_lo = pair_max(*pair_add32(dep_hi, dep_lo, lat), we_hi, we_lo)
    out_valid = do_send & ~lost

    # ---- timer re-arm ----------------------------------------------------
    has_timer = ((model == M_TGEN_MESH) | (model == M_TGEN_CLIENT)
                 | (model == M_PING_CLIENT))
    rearm = (
        (is_start & has_timer) | mesh_tick | client_tick | ping_tick
        | (is_timer & (model == M_TGEN_MESH) & (n == 1))
    )
    ti_hi, ti_lo = pair_add_pair(thi, tlo, tb.p_int_hi, tb.p_int_lo)
    arm_auxl = v["local_seq"]
    v["local_seq"] = v["local_seq"] + rearm

    zero = torch.zeros_like(lanes)
    arm = (
        torch.where(rearm, ti_hi, NEVER32), torch.where(rearm, ti_lo, NEVER32),
        lw["loc_auxh"], arm_auxl, zero,
    ) + ((zero, zero) if p.stream_present else ())
    out = (
        torch.where(out_valid, dst, n),
        torch.where(out_valid, arr_hi, NEVER32),
        torch.where(out_valid, arr_lo, NEVER32),
        torch.where(out_valid, lw["pkt_auxh"], 0),
        torch.where(out_valid, snd_seq, 0),
        torch.where(out_valid, out_size, 0),
    )
    # one record per slot: the popped packet's outcome, or the send's loss
    # (zeros where neither)
    rec = torch.stack([
        torch.where(is_pkt, t_join(td_hi, td_lo), t_join(thi, tlo)),
        torch.where(is_pkt, src, lanes).to(i64),
        torch.where(is_pkt, lanes, dst).to(i64),
        torch.where(is_pkt, seq, snd_seq).to(i64),
        torch.where(is_pkt, size, out_size).to(i64),
        torch.where(is_pkt, torch.where(codel_drop, DROP_CODEL, DELIVERED),
                    DROP_LOSS).to(i64),
    ], dim=1)
    rec_valid = is_pkt | lost
    rec = torch.where(rec_valid[:, None], rec, 0)
    return ins, arm, out, rec, rec_valid


def _stream_slot(p: LaneParams, tb: LaneTables, v: dict, col: dict,
                 we_hi, we_lo, ws: Workspace, j: int) -> None:
    """The stream arm of the slot law on popped column ``j`` (the
    reference's ``_process_slot`` stream tier and compacted send/arm
    channels): each endpoint row sees its lane's popped event; a start
    marker opens a client flow, an RTO local owned by the row's flow fires
    its timer, a stream segment (non-zero payload; at a server row only
    from its own client) runs ``on_segment``; every stimulus ends with the
    pump burst.  The slot-0 control send and the burst's data segments
    charge the endpoint lane's up bucket in order (the burst after its
    first unit by the chained law), each drawing its loss at counter =
    its send sequence number; RTO arms take the lane's local sequence.
    Writes the stream block's entries of slot ``j`` and the stream loss
    records into ``ws``; lane counters and flow rows change in ``v``.
    Rows with no stimulus change nothing and emit nothing."""
    el = tb.flow_lanes.long()
    s2 = el.shape[0]
    sf = s2 // 2
    ethi, etlo = col["thi"][el], col["tlo"][el]
    ekind, esrc, esize = col["kind"][el], col["src"][el], col["size"][el]
    ephi, eplo = col["phi"][el], col["plo"][el]
    eact = col["act"][el]
    is_cl = torch.arange(s2, device=el.device) < sf
    flags_in, sseq_in, sack_in = lstr.unpack_pay(ephi, eplo)
    e_loc = eact & (ekind == LOCAL)
    stim_open = e_loc & (esize == -1) & is_cl
    # RTO locals carry the flow's client lane: that also picks which flow
    # of a shared server lane owns the timer
    stim_rto = e_loc & (esize == lstr.SZ_RTO) & (eplo == tb.flow_clid)
    # zero payload words mark a foreign datagram (ignored, as the CPU
    # oracle's isinstance check does); server rows answer only their own
    # client's segments
    stim_seg = (eact & (ekind == DELIVERY) & ((ephi | eplo) != 0)
                & (is_cl | (esrc == tb.flow_clid)))
    stim = stim_open | stim_rto | stim_seg
    if not bool(stim.any()):
        return
    f = lstr.endpoint_cols(v["stream"], tb.flow_segs, tb.flow_mss,
                           tb.flow_last, tb.flow_cc)
    sem = lstr._empty_emit(s2, el.device)
    for mask, handler in (
            (stim_open, lambda f_: lstr.open_flow_vec(f_, ethi, etlo,
                                                      stim_open)),
            (stim_rto, lambda f_: lstr.on_rto_vec(f_, ethi, etlo, stim_rto)),
            (stim_seg, lambda f_: lstr.on_segment_vec(
                f_, ethi, etlo, stim_seg, flags_in, sseq_in, sack_in,
                esize))):
        if bool(mask.any()):
            f1, em1 = handler(f)
            f = lstr.merge_cols(f, f1, mask)
            sem = lstr.merge_emit(sem, em1, mask)
    # completion latches (counted once, like the CPU oracle)
    f = f._replace(completed=f.completed | (sem.completed_now & stim))
    f, sem, burst = lstr.pump_epilogue_vec(f, ethi, etlo, stim, sem)
    v["stream"] = lstr.endpoint_split(f)
    st_send = sem.send_valid & stim
    st_rto = sem.rto_valid & stim

    # the endpoint lanes' send bookkeeping, gathered (at most one endpoint
    # of a lane is stimulated per slot, so the write-back is unique)
    g = {f_: v[f_][el] for f_ in ("up_tokens", "up_nr_hi", "up_nr_lo",
                                  "up_ld_hi", "up_ld_lo", "send_seq",
                                  "local_seq", "n_sends", "n_loss")}
    interval = p.bucket_interval
    bs_hi, bs_lo = p.bootstrap_end >> 31, p.bootstrap_end & MASK31
    e_past_bs = pair_ge(ethi, etlo, bs_hi, bs_lo)

    def draw_lost(lanes_, seq, m, thresh):
        if not p.has_loss:
            return torch.zeros_like(m)
        u = rand_u32_lane(p.seed, lanes_.to(i64) | rng_mod.LOSS_STREAM, seq)
        return m & (u < thresh)

    # slot-0 control send
    se_size = sem.send_size
    (g["up_tokens"], g["up_nr_hi"], g["up_nr_lo"], g["up_ld_hi"],
     g["up_ld_lo"], dep_hi, dep_lo, _waited) = bucket_charge_vec(
        g["up_tokens"], g["up_nr_hi"], g["up_nr_lo"], g["up_ld_hi"],
        g["up_ld_lo"], tb.flow_up_rate, tb.flow_up_burst, tb.flow_up_kfull,
        tb.flow_up_kfi, ethi, etlo, (se_size + FRAME_OVERHEAD_BYTES) * 8,
        st_send, interval)
    se_seq = g["send_seq"]
    g["send_seq"] = g["send_seq"] + st_send
    g["n_sends"] = g["n_sends"] + st_send
    se_lost = draw_lost(el, se_seq, st_send & e_past_bs, tb.flow_thresh)
    g["n_loss"] = g["n_loss"] + se_lost
    if p.dynamic_runahead:
        v["min_used_lat"] = torch.minimum(v["min_used_lat"], torch.where(
            st_send, tb.flow_lat, NEVER32).min())
    se_thi, se_tlo = pair_max(*pair_add32(dep_hi, dep_lo, tb.flow_lat),
                              we_hi, we_lo)
    se_valid = st_send & ~se_lost
    se_phi, se_plo = lstr.pack_pay(sem.send_flags, sem.send_seq, sem.send_ack)
    pkt_auxh = pack_aux_hi(PACKET, tb.flow_lanes)
    sx = ws.sx_blk
    k = p.pops_per_iter

    def put(base, valid, dst, thi_, tlo_, auxh, auxl, size, phi, plo):
        cols = torch.nonzero(valid).flatten()
        if cols.numel() == 0:
            return
        words = (dst, thi_, tlo_, auxh, auxl, size, phi, plo)
        for w_, word in enumerate(words):
            word = torch.as_tensor(word, dtype=i32, device=el.device)
            sx[w_, base + cols] = word.expand(valid.shape)[cols]

    put(j * s2, se_valid, tb.flow_peers, se_thi, se_tlo, pkt_auxh, se_seq,
        se_size, se_phi, se_plo)

    # RTO arms: LOCAL self-inserts at the endpoint lane
    put(k * s2 + j * s2, st_rto, tb.flow_lanes, sem.rto_thi, sem.rto_tlo,
        pack_aux_hi(LOCAL, tb.flow_lanes), g["local_seq"], lstr.SZ_RTO, 0,
        tb.flow_clid)
    g["local_seq"] = g["local_seq"] + st_rto

    # the burst, on the client half (the law's role gate empties server
    # rows' bursts): unit 1 takes the full bucket law, later units the
    # chained one
    valid_b, flags_b, units_b, acks_b, sizes_b, _retx = burst
    cl = slice(0, sf)
    tok, nrh, nrl = g["up_tokens"][cl], g["up_nr_hi"][cl], g["up_nr_lo"][cl]
    ldh, ldl = g["up_ld_hi"][cl], g["up_ld_lo"][cl]
    nloss = g["n_loss"][cl]
    cthi, ctlo = ethi[cl], etlo[cl]
    sent = st_send[cl].to(i32)
    sent0 = sent
    lat_c = tb.flow_lat[cl]
    t64 = t_join(ethi, etlo)
    for u in range(PUMP_BURST):
        bm = valid_b[u, cl]
        if not bool(bm.any()):
            break  # the burst is a prefix: no later unit is valid
        bsize = sizes_b[u, cl]
        bbits = (bsize + FRAME_OVERHEAD_BYTES) * 8
        if u == 0:
            tok, nrh, nrl, ldh, ldl, bdh, bdl, _waited = bucket_charge_vec(
                tok, nrh, nrl, ldh, ldl, tb.flow_up_rate[cl],
                tb.flow_up_burst[cl], tb.flow_up_kfull[cl], tb.flow_up_kfi[cl],
                cthi, ctlo, bbits, bm, interval)
        else:
            tok, nrh, nrl, ldh, ldl, bdh, bdl, _waited = bucket_charge_chained_vec(
                tok, nrh, nrl, ldh, ldl, tb.flow_up_rate[cl],
                tb.flow_up_burst[cl], bbits, bm, interval, cthi, ctlo)
        bseq = se_seq[cl] + sent
        blost = draw_lost(el[cl], bseq, bm & e_past_bs[cl], tb.flow_thresh[cl])
        nloss = nloss + blost
        if p.dynamic_runahead:
            v["min_used_lat"] = torch.minimum(v["min_used_lat"], torch.where(
                bm, lat_c, NEVER32).min())
        bthi, btlo = pair_max(*pair_add32(bdh, bdl, lat_c), we_hi, we_lo)
        bphi, bplo = lstr.pack_pay(flags_b[u, cl], units_b[u, cl],
                                   acks_b[u, cl])
        base = 4 * k * sf + (j * PUMP_BURST + u) * sf
        put(base, bm & ~blost, tb.flow_peers[cl], bthi, btlo, pkt_auxh[cl],
            bseq, bsize, bphi, bplo)
        if p.log_capacity:
            r0 = p.rec_offsets[3] + (j * PUMP_BURST + u) * sf
            _put_loss_recs(ws, r0, blost, t64[cl], tb.flow_lanes[cl],
                           tb.flow_peers[cl], bseq, bsize)
        sent = sent + bm
    burst_total = sent - sent0
    g["up_tokens"][cl], g["up_nr_hi"][cl], g["up_nr_lo"][cl] = tok, nrh, nrl
    g["up_ld_hi"][cl], g["up_ld_lo"][cl], g["n_loss"][cl] = ldh, ldl, nloss
    g["send_seq"][cl] += burst_total
    g["n_sends"][cl] += burst_total
    if p.log_capacity:
        _put_loss_recs(ws, p.rec_offsets[2] + j * s2, se_lost, t64,
                       tb.flow_lanes, tb.flow_peers, se_seq, se_size)
    # write-back, at the stimulated rows' lanes
    rows = torch.nonzero(stim).flatten()
    for f_, t in g.items():
        v[f_] = v[f_].clone()
        v[f_][el[rows]] = t[rows]


def _put_loss_recs(ws: Workspace, r0: int, lost, t64, src, dst, seq,
                   size) -> None:
    """DROP_LOSS records of stream sends lost at their send instant."""
    cols = torch.nonzero(lost).flatten()
    if cols.numel() == 0:
        return
    rec = torch.stack([t64[cols], src[cols].to(i64), dst[cols].to(i64),
                       seq[cols].to(i64), size[cols].to(i64),
                       torch.full_like(t64[cols], DROP_LOSS)], dim=1)
    ws.recs[r0 + cols] = rec
    ws.rec_valid[r0 + cols] = 1


def _empty_entries(n: int):
    """The canonical empty entry of the outbound and stream blocks."""
    return (n, NEVER32, NEVER32, 0, 0, 0, 0, 0)


def lane_slots_plain(p: LaneParams, tb: LaneTables, s: LaneState,
                     ws: Workspace) -> None:
    """Kernel A, plain: pop up to K events per lane inside the window under
    the co-pop rule and run the slot law on each, in slot order.  Consumed
    slots become NEVER in place; the state vectors are updated in place;
    the self, outbound, stream and record blocks go to ``ws``."""
    if not int(ws.ctl[0]):
        return
    n, k = p.n_lanes, p.pops_per_iter
    arm0 = 0 if p.all_passive else k  # first re-arm column of the self block
    lanes = torch.arange(n, dtype=i32, device=s.q_thi.device)
    thi = s.q_thi[:, :k].clone()
    tlo = s.q_tlo[:, :k].clone()
    kind, src = unpack_aux_hi(s.q_auxh[:, :k])
    lw = {"passive": passive_lanes(tb.model),
          "loc_auxh": pack_aux_hi(LOCAL, lanes),
          "pkt_auxh": pack_aux_hi(PACKET, lanes)}
    act = _pop_mask(p, tb, lw["passive"], thi, tlo, kind, s.now_we_hi,
                    s.now_we_lo)
    s.q_thi[:, :k] = torch.where(act, NEVER32, thi)
    s.q_tlo[:, :k] = torch.where(act, NEVER32, tlo)
    # the slot law rebinds v's entries to new tensors; the state's own
    # tensors are written once, at the end
    v = {f: getattr(s, f) for f in _SLOT_FIELDS + ("min_used_lat",)}
    _tail, rec_slots, rec_srec, _brec, rec_end = p.rec_offsets
    if p.stream_present:
        v["stream"] = s.stream
        for w, val in enumerate(_empty_entries(n)):
            ws.sx_blk[w] = val
        if p.log_capacity:
            ws.recs[rec_srec:rec_end] = 0
            ws.rec_valid[rec_srec:rec_end] = 0
    # pops are row prefixes: past the longest one no lane is active, the
    # state cannot change, and every emit is empty
    n_live = int(act.sum(dim=1).max()) if n else 0
    for j in range(n_live, k):
        if not p.all_passive:
            ws.self_blk[:2, :, j] = NEVER32
            ws.self_blk[2:, :, j] = 0
        ws.self_blk[:2, :, arm0 + j] = NEVER32
        ws.self_blk[2, :, arm0 + j] = lw["loc_auxh"]
        ws.self_blk[4:, :, arm0 + j] = 0
        ws.out_blk[:, j] = torch.tensor(
            _empty_entries(n)[:6], dtype=i32, device=lanes.device)[:, None]
        if p.log_capacity:
            rows = slice(rec_slots + j * n, rec_slots + (j + 1) * n)
            ws.recs[rows] = 0
            ws.rec_valid[rows] = 0
    for j in range(n_live):
        col = {
            "thi": thi[:, j], "tlo": tlo[:, j], "kind": kind[:, j],
            "src": src[:, j], "seq": s.q_auxl[:, j], "size": s.q_size[:, j],
            "act": act[:, j],
        }
        if p.stream_present:
            col["phi"], col["plo"] = s.q_phi[:, j], s.q_plo[:, j]
        ins, arm, out, rec, rec_valid = _process_slot(
            p, tb, v, col, s.now_we_hi, s.now_we_lo, lanes, lw)
        for w in range(p.words):
            if not p.all_passive:
                ws.self_blk[w, :, j] = ins[w]
            ws.self_blk[w, :, arm0 + j] = arm[w]
        for w in range(6):
            ws.out_blk[w, j] = out[w]
        if p.log_capacity:
            rows = slice(rec_slots + j * n, rec_slots + (j + 1) * n)
            ws.recs[rows] = rec
            ws.rec_valid[rows] = rec_valid.to(i32)
        if p.stream_present:
            _stream_slot(p, tb, v, col, s.now_we_hi, s.now_we_lo, ws, j)
    for j in range(n_live, k):
        ws.self_blk[3, :, arm0 + j] = v["local_seq"]
    for f, t in v.items():
        if t is not getattr(s, f):
            getattr(s, f).copy_(t)


def _key_order(thi, tlo, auxh, auxl):
    """Per-row permutation sorting by the 4-word key (signed int32 words,
    lexicographic), ties kept in index order: a stable sort by the aux
    key, then a stable sort by the time key."""
    def fold(hi, lo):  # exact lexicographic order of two int32 words
        return (hi.to(i64) << 32) + (lo.to(i64) + (1 << 31))

    perm = torch.sort(fold(auxh, auxl), dim=1, stable=True).indices
    t_key = torch.gather(fold(thi, tlo), 1, perm)
    return torch.gather(perm, 1, torch.sort(t_key, dim=1, stable=True).indices)


def _queue_words(p: LaneParams, s: LaneState):
    q = (s.q_thi, s.q_tlo, s.q_auxh, s.q_auxl, s.q_size)
    return q + ((s.q_phi, s.q_plo) if p.stream_present else ())


def _merge_rows(p: LaneParams, q_rows, cand, ws: Workspace, rec_base: int,
                lane_of_row):
    """The keyed row merge: each row of ``[q_rows | cand]`` (lists of
    ``p.words`` word tensors) sorted by the event key, ties in index
    order; the first C are returned as the new queue rows, and the real
    events past column C are counted per row and, when logging, recorded
    as DROP_QUEUE at ``rec_base`` (row-major).  ``lane_of_row`` gives each
    row's lane for the records."""
    c = p.capacity
    merged = [torch.cat([q, x], dim=1) for q, x in zip(q_rows, cand)]
    perm = _key_order(*merged[:4])
    merged = [torch.gather(m, 1, perm) for m in merged]
    tail = [m[:, c:] for m in merged]
    tail_valid = tail[0] != NEVER32
    if p.log_capacity:
        _kind, t_src = unpack_aux_hi(tail[2])
        dst = lane_of_row.to(i64)[:, None].expand_as(t_src)
        rec = torch.stack([
            t_join(tail[0], tail[1]), t_src.to(i64), dst, tail[3].to(i64),
            tail[4].to(i64), torch.full_like(dst, DROP_QUEUE),
        ], dim=2)
        rec = torch.where(tail_valid[:, :, None], rec, 0)
        n_tail = rec.shape[0] * rec.shape[1]
        ws.recs[rec_base: rec_base + n_tail] = rec.reshape(-1, 6)
        ws.rec_valid[rec_base: rec_base + n_tail] = \
            tail_valid.reshape(-1).to(i32)
    return [m[:, :c] for m in merged], tail_valid.sum(dim=1, dtype=i32)


def exchange_merge_plain(p: LaneParams, s: LaneState, ws: Workspace) -> None:
    """Kernel B, plain: the cross-lane exchange and the keyed row merge.

    Exchanged entries — the outbound packets, then in star stream configs
    the stream block's control sends, RTO arms and bursts — are grouped by
    destination in index order; each lane takes the first Cx of its group
    as its cross block and counts the rest as shed (``n_queue``).  Then
    each row of ``[queue C | self S | cross Cx]`` is sorted by the event
    key, ties in index order, and the first C kept; real events past column
    C are queue overflow (``n_queue``, and DROP_QUEUE records when
    logging).  Stream configs carry the payload words through it all."""
    if not int(ws.ctl[0]):
        return
    n, k, cx = p.n_lanes, p.pops_per_iter, p.cross_cap
    dev = s.q_thi.device
    out = ws.out_blk.reshape(6, k * n)
    entries = [out[w] for w in range(6)] + [torch.zeros_like(out[0])] * 2
    if p.stream_present and not p.split:
        entries = [torch.cat([e, ws.sx_blk[w]]) for w, e in enumerate(entries)]
    m = entries[0].shape[0]
    dst = entries[0].long()
    order = torch.sort(dst, stable=True).indices
    cnt = torch.bincount(dst, minlength=n + 1)[:n]
    start = torch.cumsum(cnt, 0) - cnt
    r = torch.arange(cx, device=dev)
    in_seg = r[None, :] < cnt[:, None]
    msel = order[torch.clamp(start[:, None] + r[None, :], max=m - 1)]
    cross = [
        torch.where(in_seg, entries[w][msel], NEVER32 if w < 3 else 0)
        for w in range(1, 1 + p.words)
    ]
    lost_pre = torch.clamp(cnt - cx, min=0).to(i32)

    q = _queue_words(p, s)
    cand = [torch.cat([ws.self_blk[w], cross[w]], dim=1)
            for w in range(p.words)]
    lanes_ = torch.arange(n, device=dev)
    rows, n_tail = _merge_rows(p, q, cand, ws, 0, lanes_)
    for w in range(p.words):
        q[w].copy_(rows[w])
    s.n_queue.add_(n_tail + lost_pre)
    s.iters.add_(1)


def _stream_candidates(p: LaneParams, tb: LaneTables, ws: Workspace):
    """The split exchange's ``[2S, W_s]`` candidate rows, by the static
    layout of the reference's ``_merge_stream_rows``: a client row takes
    its server's control sends [K], its own RTO arms [K] and empty
    padding [K*B]; a server row takes its client's control sends, its own
    RTO arms and its client's bursts [K*B] (slot-major)."""
    k, sf = p.pops_per_iter, p.s_flows
    s2 = 2 * sf
    sx = ws.sx_blk
    se = sx[1:, : k * s2].reshape(7, k, s2)
    sa = sx[1:, k * s2: 2 * k * s2].reshape(7, k, s2)
    bo = sx[1:, 2 * k * s2:].reshape(7, k, PUMP_BURST, sf)
    pad = torch.zeros((7, sf, k * PUMP_BURST), dtype=i32, device=sx.device)
    pad[:2] = NEVER32
    cl = torch.cat([se[:, :, sf:].transpose(1, 2), sa[:, :, :sf].transpose(1, 2),
                    pad], dim=2)
    sv = torch.cat([se[:, :, :sf].transpose(1, 2), sa[:, :, sf:].transpose(1, 2),
                    bo.permute(0, 3, 1, 2).reshape(7, sf, k * PUMP_BURST)],
                   dim=2)
    return list(torch.cat([cl, sv], dim=1))


def stream_rows_merge_plain(p: LaneParams, tb: LaneTables, s: LaneState,
                            ws: Workspace) -> None:
    """Kernel E, plain (one-to-one stream configs): the split exchange.
    Every stream entry's destination row is static, so each endpoint
    row's candidates come from fixed positions of the stream block; its
    lane's queue row (by ``flow_lanes``) is merged with them by the event
    key, the first C kept and scattered back, and real events past column
    C counted into ``n_queue`` and recorded as DROP_QUEUE."""
    if not int(ws.ctl[0]):
        return
    el = tb.flow_lanes.long()
    q = _queue_words(p, s)
    rows, n_tail = _merge_rows(
        p, [w[el] for w in q], _stream_candidates(p, tb, ws), ws,
        p.rec_offsets[0], el)
    for w in range(p.words):
        q[w][el] = rows[w]
    s.n_queue[el] += n_tail


def effective_runahead(p: LaneParams, min_used_lat):
    """The window width (the reference's ``_effective_runahead``): the
    static runahead, or with dynamic runahead the smallest latency sent
    over so far, never below the floor (the static value until a send)."""
    if not p.dynamic_runahead:
        return p.runahead
    return torch.where(
        min_used_lat == NEVER32, p.runahead,
        torch.clamp(min_used_lat, min=max(p.runahead_floor, 1)))


def queue_min_window_plain(p: LaneParams, s: LaneState, ws: Workspace,
                           advance: bool) -> None:
    """Kernel C, plain: the earliest head over all queues, then the window
    law.  With ``advance``, a live step whose head lies at or past the
    window end opens the next window ``[head, min(head + runahead,
    stop))`` and counts a round; the runahead is dynamic where the
    parameters say so.  Writes ``ctl = (live, in_window, head_hi,
    head_lo)``."""
    mh, ml = _pairs.pair_min_lanes(s.q_thi[:, 0], s.q_tlo[:, 0])
    stop_hi, stop_lo = p.stop_time >> 31, p.stop_time & MASK31
    live = pair_lt(mh, ml, stop_hi, stop_lo)
    if advance:
        fresh = live & pair_ge(mh, ml, s.now_we_hi, s.now_we_lo)
        c_hi, c_lo = pair_add32(mh, ml, effective_runahead(p, s.min_used_lat))
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
    """One iteration of the window loop (kernels A, B, E in one-to-one
    stream configs and, when logging, D) and the step that precedes it
    (kernel C), bound to this run's state."""
    from . import kernels

    args = kernels.LaneArgs(p, tb, s, make_workspace(p, s.q_thi.device))

    def window(advance: bool) -> None:
        kernels.queue_min_window(args, advance)

    def iteration() -> None:
        kernels.lane_slots(args)
        kernels.exchange_merge(args)
        if p.split:
            kernels.stream_rows_merge(args)
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
