"""Lane backend of the port: state, laws, and the plain versions of the lane
kernels, plus the two drivers (round by round, and the device loop).

Counterpart of the JAX package's ``backend/lanes.py`` for its lane path
and tiered stream pass: hosts run ``tgen-mesh``, ``tgen-client``,
``tgen-server``, ``phold``, ``ping``, ``stream-client``, ``stream-server``
or nothing, over graphs with or without loss, with a static or dynamic
runahead.  One **lane per simulated host**; per-host state lives in
``[N]`` or ``[N, C]`` tensors, stream flows on ``[2S]`` endpoint rows
(``lanes_stream.py``), and one iteration of the window loop is four to
six kernels (``kernels.py`` binds their CUDA versions):

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
- E ``stream_rows_merge`` (untiered one-to-one stream configs): the
  split exchange — each endpoint row's stream entries come from static
  positions of the stream block and merge into its lane's queue row;
- F ``stream_tier`` and G ``tier_merge`` (tiered one-to-one stream
  configs, the default): the stream endpoints keep their own ``[2S, C2]``
  queues and compact network state (``lanes_stream.TierState``); the
  ``[N]`` lanes run without the stream models, B diverts the cross
  entries of stream lanes to the tier, F pops and runs each endpoint
  row's events (down bucket, CoDel, the lane-TCP law with delivery
  elision, sends, RTO arms, bursts) and G merges its candidates into the
  rows;
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
import functools
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
    # their servers — the reference's StreamState(cl, sv) stacked; on a
    # tiered run a lanes_stream.TierState(flows, q, v), the flows in the
    # same form
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
    # the TIERED stream backend (one-to-one configs): stream endpoints own
    # a [2S, C2] queue block and compact network state (lanes_stream
    # .TierState in ``LaneState.stream``); the [N] lanes run without the
    # stream models (``lane``), and kernels F and G run the tier
    stream_tiered: bool = False
    stream_pops: int = 8  # K_s: tier pop columns per iteration
    stream_capacity: int = 64  # C2: tier queue width

    @property
    def cross_cap(self) -> int:
        return min(self.cross_capacity, self.capacity) or self.capacity

    @functools.cached_property
    def lane(self) -> "LaneParams":
        """The parameters the [N] lanes run under (the reference's
        ``p_lane``): these, or on a tiered run the same without the stream
        models — no stream arm in A, 5-word queue entries, no stream
        exchange."""
        if not self.stream_tiered:
            return self
        return dataclasses.replace(
            self, models_present=tuple(m for m in self.models_present
                                       if m not in STREAM_MODELS),
            stream_tiered=False, stream_clients=())

    @property
    def stream_present(self) -> bool:
        return bool(set(self.models_present) & STREAM_MODELS)

    @property
    def s_flows(self) -> int:
        return len(self.stream_clients)

    @property
    def split(self) -> bool:
        """Stream entries take the split exchange (kernel E)."""
        return (self.stream_present and self.stream_one_to_one
                and not self.stream_tiered)

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
    def tier_width(self) -> int:
        """W_t = 3K_s + K_s*B + Cx: the tier merge's candidates per
        endpoint row (DELIVERY fallbacks, RTO arms, the peer's control
        sends, the client's bursts on server rows, the diverted cross
        entries)."""
        ks = self.stream_pops
        return 3 * ks + ks * PUMP_BURST + self.cross_cap

    @property
    def tier_layout(self) -> tuple:
        """Where the tier block's channels start (``Workspace.tier_blk``):
        DELIVERY fallbacks [K_s, 2S] at 0, RTO arms [K_s, 2S], control
        sends [K_s, 2S] (emitter rows), bursts [K_s, B, S], the diverted
        cross entries [2S, Cx], and the block's end."""
        if not self.stream_tiered:
            return 0, 0, 0, 0, 0
        ks, s = self.stream_pops, self.s_flows
        sa = ks * 2 * s
        se = 2 * sa
        bo = 3 * sa
        cx = bo + ks * PUMP_BURST * s
        return sa, se, bo, cx, cx + 2 * s * self.cross_cap

    @property
    def tier_rec_offsets(self) -> tuple:
        """The tier's record groups (logging): the popped packets'
        outcomes [K_s, 2S], the control sends' losses [K_s, 2S], the
        bursts' losses [K_s, B, S] and the tier merge's tail [2S, W_t],
        after the [N] merge tail; and their end."""
        tail = self.rec_offsets[0]
        if not self.stream_tiered:
            return tail, tail, tail, tail, tail
        ks, s = self.stream_pops, self.s_flows
        srec = tail + ks * 2 * s
        brec = srec + ks * 2 * s
        ttail = brec + ks * PUMP_BURST * s
        return tail, srec, brec, ttail, ttail + 2 * s * self.tier_width

    @property
    def rec_offsets(self) -> tuple:
        """The record groups of the workspace's record block, in the
        reference's append order: the merge tail [N, self + Cx] from 0,
        then the starts of the split exchange's tail [2S, W_s] (or, tiered,
        of the tier's groups, ``tier_rec_offsets``), the popped slots
        [K, N], the stream control sends' losses [K, 2S] and the bursts'
        losses [K, B, S], and the block's end."""
        pl = self.lane
        n, k, s = self.n_lanes, self.pops_per_iter, self.s_flows
        tail = n * (pl.self_width + pl.cross_cap)
        split = 2 * s * self.stream_row_width if self.split else 0
        if self.stream_tiered:
            ks = self.stream_pops
            split = (4 * ks * s + ks * PUMP_BURST * s
                     + 2 * s * self.tier_width)
        slots = tail + split
        srec = slots + k * n
        brec = srec + (2 * k * s if pl.stream_present else 0)
        end = brec + (k * PUMP_BURST * s if pl.stream_present else 0)
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
        if self.stream_tiered and not (
                self.stream_present and self.stream_one_to_one):
            raise ValueError("the tiered stream backend needs one-to-one "
                             "stream pairing")
        if self.stream_tiered and not (
                1 <= self.stream_pops <= self.stream_capacity):
            raise ValueError(
                f"stream_pops={self.stream_pops} must be in [1, "
                f"stream_capacity={self.stream_capacity}]")


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
    # tiered only (empty otherwise, where the reference holds ()): the
    # endpoint lane's down bucket [2S], and which lanes are stream
    # endpoints [N] bool (their cross entries divert into the tier)
    flow_dn_rate: torch.Tensor
    flow_dn_burst: torch.Tensor
    flow_dn_kfull: torch.Tensor
    flow_dn_kfi: torch.Tensor
    lane_stream: torch.Tensor
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
    # [7, T] int32, tiered runs ([7, 1] otherwise): the tier merge's
    # candidates by LaneParams.tier_layout — kernel F's DELIVERY
    # fallbacks, RTO arms, control sends and bursts, and the cross entries
    # that kernel B diverts to stream endpoints; words thi, tlo, auxh,
    # auxl, size, phi, plo, empty entries canonical (the NEVER time pair,
    # zero words)
    tier_blk: torch.Tensor


def make_workspace(p: LaneParams, device) -> Workspace:
    pl = p.lane
    n, k = p.n_lanes, p.pops_per_iter
    n_rec = p.n_records if p.log_capacity else 1

    def z(*shape, dtype=i32):
        return torch.zeros(shape, dtype=dtype, device=device)

    return Workspace(
        ctl=z(4), self_blk=z(pl.words, n, pl.self_width), out_blk=z(6, k, n),
        sx_blk=z(8, max(pl.stream_entries, 1)),
        recs=z(n_rec, 6, dtype=i64), rec_valid=z(n_rec),
        x_cnt=z(n), x_start=z(n), x_fill=z(n), x_order=z(pl.exchange_entries),
        tier_blk=z(7, max(p.tier_layout[-1], 1)),
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


class StreamSends(NamedTuple):
    """One stimulus's control send and RTO arm per endpoint row, as
    ``_stream_stimulus`` hands them to its caller (the burst goes to the
    caller's sink unit by unit)."""
    send: torch.Tensor  # the control send was made
    lost: torch.Tensor  # ... and lost at its draw
    thi: torch.Tensor  # its arrival (after the window end)
    tlo: torch.Tensor
    seq: torch.Tensor  # its send sequence number
    size: torch.Tensor
    phi: torch.Tensor  # its payload words
    plo: torch.Tensor
    arm: torch.Tensor  # an RTO arm was made
    arm_thi: torch.Tensor
    arm_tlo: torch.Tensor
    lseq: torch.Tensor  # the arm's local sequence number


def _stream_stimulus(p: LaneParams, tb: LaneTables, f, stims, sh, sl,
                     phi, plo, size, ctr: dict, we_hi, we_lo, burst_out):
    """The lane-TCP law and the sends of one stimulus on the ``[2S]``
    endpoint rows, shared by A's stream arm (``_stream_slot``) and F's walk
    (``stream_tier_plain``).  ``stims`` = (open, RTO, segment) masks: a
    start marker opens a client flow, an owned RTO local fires its timer, a
    segment runs ``on_segment``, at the stimulus times (``sh``, ``sl``) on
    the event's payload words and size; every stimulus ends with the pump
    burst.  The control send and, on the client half, the burst charge the
    rows' up bucket in order (the burst after its first unit by the chained
    law), each drawing its loss at counter = its send sequence number; an
    RTO arm takes the local sequence.  ``ctr`` holds the rows' ``up``
    bucket (five tensors), ``send_seq``, ``local_seq``, ``n_sends``,
    ``n_loss`` and ``min_lat`` (a scalar), rebound here.  Burst unit ``u``
    goes to ``burst_out(u, valid, lost, thi, tlo, seq, size, phi, plo)``
    over the client half.  Returns the flows and the :class:`StreamSends`."""
    stim_open, stim_rto, stim_seg = stims
    stim = stim_open | stim_rto | stim_seg
    s2 = stim.shape[0]
    sf = s2 // 2
    cl = slice(0, sf)
    flags_in, sseq_in, sack_in = lstr.unpack_pay(phi, plo)
    sem = lstr._empty_emit(s2, stim.device)
    for mask, handler in (
            (stim_open, lambda f_: lstr.open_flow_vec(f_, sh, sl, stim_open)),
            (stim_rto, lambda f_: lstr.on_rto_vec(f_, sh, sl, stim_rto)),
            (stim_seg, lambda f_: lstr.on_segment_vec(
                f_, sh, sl, stim_seg, flags_in, sseq_in, sack_in, size))):
        if bool(mask.any()):
            f1, em1 = handler(f)
            f = lstr.merge_cols(f, f1, mask)
            sem = lstr.merge_emit(sem, em1, mask)
    # completion latches (counted once, like the CPU oracle)
    f = f._replace(completed=f.completed | (sem.completed_now & stim))
    f, sem, burst = lstr.pump_epilogue_vec(f, sh, sl, stim, sem)
    st_send = sem.send_valid & stim
    st_rto = sem.rto_valid & stim
    interval = p.bucket_interval
    past_bs = pair_ge(sh, sl, p.bootstrap_end >> 31, p.bootstrap_end & MASK31)

    def draw_lost(rows, seq, m):
        if not p.has_loss:
            return torch.zeros_like(m)
        u = rand_u32_lane(p.seed, tb.flow_lanes[rows].to(i64)
                          | rng_mod.LOSS_STREAM, seq)
        return m & (u < tb.flow_thresh[rows])

    def lat_min(m, lat):
        if p.dynamic_runahead:
            ctr["min_lat"] = torch.minimum(
                ctr["min_lat"], torch.where(m, lat, NEVER32).min())

    # the control send: up bucket, loss draw, arrival
    *up, dep_hi, dep_lo, _waited = bucket_charge_vec(
        *ctr["up"], tb.flow_up_rate, tb.flow_up_burst, tb.flow_up_kfull,
        tb.flow_up_kfi, sh, sl, (sem.send_size + FRAME_OVERHEAD_BYTES) * 8,
        st_send, interval)
    se_seq = ctr["send_seq"]
    se_lost = draw_lost(slice(None), se_seq, st_send & past_bs)
    lat_min(st_send, tb.flow_lat)
    se_thi, se_tlo = pair_max(*pair_add32(dep_hi, dep_lo, tb.flow_lat),
                              we_hi, we_lo)
    lseq = ctr["local_seq"]
    ctr["local_seq"] = lseq + st_rto

    # the burst, on the client half (the law's role gate empties the server
    # rows' bursts): unit 1 by the full bucket law, the rest by the chained
    # one
    valid_b, flags_b, units_b, acks_b, sizes_b, _retx = burst
    up_c = [t[cl] for t in up]
    nloss = ctr["n_loss"] + se_lost
    nloss_c = nloss[cl]
    sent = st_send[cl].to(i32)
    sent0 = sent
    lat_c = tb.flow_lat[cl]
    for u in range(PUMP_BURST):
        bm = valid_b[u, cl]
        if not bool(bm.any()):
            break  # the burst is a prefix: no later unit is valid
        bsize = sizes_b[u, cl]
        bbits = (bsize + FRAME_OVERHEAD_BYTES) * 8
        if u == 0:
            *up_c, bdh, bdl, _waited = bucket_charge_vec(
                *up_c, tb.flow_up_rate[cl], tb.flow_up_burst[cl],
                tb.flow_up_kfull[cl], tb.flow_up_kfi[cl], sh[cl], sl[cl],
                bbits, bm, interval)
        else:
            *up_c, bdh, bdl, _waited = bucket_charge_chained_vec(
                *up_c, tb.flow_up_rate[cl], tb.flow_up_burst[cl], bbits, bm,
                interval, sh[cl], sl[cl])
        bseq = se_seq[cl] + sent
        blost = draw_lost(cl, bseq, bm & past_bs[cl])
        nloss_c = nloss_c + blost
        lat_min(bm, lat_c)
        bthi, btlo = pair_max(*pair_add32(bdh, bdl, lat_c), we_hi, we_lo)
        burst_out(u, bm & ~blost, blost, bthi, btlo, bseq, bsize,
                  *lstr.pack_pay(flags_b[u, cl], units_b[u, cl],
                                 acks_b[u, cl]))
        sent = sent + bm
    ctr["up"] = [torch.cat([c, t[sf:]]) for c, t in zip(up_c, up)]
    ctr["n_loss"] = torch.cat([nloss_c, nloss[sf:]])
    sends = st_send.to(i32) + torch.cat([sent - sent0, torch.zeros_like(sent)])
    ctr["send_seq"] = ctr["send_seq"] + sends
    ctr["n_sends"] = ctr["n_sends"] + sends
    return f, StreamSends(
        st_send, se_lost, se_thi, se_tlo, se_seq, sem.send_size,
        *lstr.pack_pay(sem.send_flags, sem.send_seq, sem.send_ack),
        st_rto, sem.rto_thi, sem.rto_tlo, lseq)


_UP_FIELDS = ("up_tokens", "up_nr_hi", "up_nr_lo", "up_ld_hi", "up_ld_lo")
_SEND_FIELDS = ("send_seq", "local_seq", "n_sends", "n_loss")


def _stream_slot(p: LaneParams, tb: LaneTables, v: dict, col: dict,
                 we_hi, we_lo, ws: Workspace, j: int) -> None:
    """The stream arm of the slot law on popped column ``j`` (the
    reference's ``_process_slot`` stream tier and compacted send/arm
    channels): each endpoint row sees its lane's popped event and runs
    ``_stream_stimulus`` on the endpoint lane's up bucket and counters (a
    segment stimulates a server row only from its own client).  Writes the
    stream block's entries of slot ``j`` and the stream loss records into
    ``ws``; lane counters and flow rows change in ``v``.  Rows with no
    stimulus change nothing and emit nothing."""
    el = tb.flow_lanes.long()
    s2 = el.shape[0]
    sf = s2 // 2
    ethi, etlo = col["thi"][el], col["tlo"][el]
    ekind, esrc, esize = col["kind"][el], col["src"][el], col["size"][el]
    ephi, eplo = col["phi"][el], col["plo"][el]
    eact = col["act"][el]
    is_cl = torch.arange(s2, device=el.device) < sf
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
    # the endpoint lanes' send bookkeeping, gathered (at most one endpoint
    # of a lane is stimulated per slot, so the write-back is unique)
    ctr = {f_: v[f_][el] for f_ in _SEND_FIELDS}
    ctr["up"] = [v[f_][el] for f_ in _UP_FIELDS]
    ctr["min_lat"] = v["min_used_lat"]
    sx = ws.sx_blk
    k = p.pops_per_iter
    t64 = t_join(ethi, etlo)
    pkt_auxh = pack_aux_hi(PACKET, tb.flow_lanes)
    cl = slice(0, sf)

    def burst_out(u, valid, lost, thi, tlo, seq, size, phi, plo):
        slot = j * PUMP_BURST + u
        _put_entries(sx, 4 * k * sf + slot * sf, valid, tb.flow_peers[cl],
                     thi, tlo, pkt_auxh[cl], seq, size, phi, plo)
        if p.log_capacity:
            _put_recs(ws, p.rec_offsets[3] + slot * sf, lost, t64[cl],
                      tb.flow_lanes[cl], tb.flow_peers[cl], seq, size,
                      DROP_LOSS)

    f, se = _stream_stimulus(p, tb, f, (stim_open, stim_rto, stim_seg),
                             ethi, etlo, ephi, eplo, esize, ctr, we_hi,
                             we_lo, burst_out)
    v["stream"] = lstr.endpoint_split(f)
    v["min_used_lat"] = ctr["min_lat"]
    _put_entries(sx, j * s2, se.send & ~se.lost, tb.flow_peers, se.thi,
                 se.tlo, pkt_auxh, se.seq, se.size, se.phi, se.plo)
    # RTO arms: LOCAL self-inserts at the endpoint lane
    _put_entries(sx, k * s2 + j * s2, se.arm, tb.flow_lanes, se.arm_thi,
                 se.arm_tlo, pack_aux_hi(LOCAL, tb.flow_lanes), se.lseq,
                 lstr.SZ_RTO, 0, tb.flow_clid)
    if p.log_capacity:
        _put_recs(ws, p.rec_offsets[2] + j * s2, se.lost, t64, tb.flow_lanes,
                  tb.flow_peers, se.seq, se.size, DROP_LOSS)
    # write-back, at the stimulated rows' lanes
    rows = torch.nonzero(stim).flatten()
    for f_, t in (*zip(_UP_FIELDS, ctr["up"]),
                  *((f_, ctr[f_]) for f_ in _SEND_FIELDS)):
        v[f_] = v[f_].clone()
        v[f_][el[rows]] = t[rows]


def _put_entries(blk, base: int, valid, *words) -> None:
    """Write the valid entries of one channel (``valid`` and each word a
    tensor over its rows, or a scalar) into a block of entries (the stream
    block, the tier block) at ``base + row``."""
    rows = torch.nonzero(valid).flatten()
    if rows.numel() == 0:
        return
    for w, word in enumerate(words):
        word = torch.as_tensor(word, dtype=i32, device=blk.device)
        blk[w, base + rows] = word.expand(valid.shape)[rows]


def _put_recs(ws: Workspace, r0: int, valid, *cols) -> None:
    """Log records of the valid rows at ``r0 + row``: columns time, src,
    dst, seq, size, outcome (tensors over the rows, or scalars)."""
    rows = torch.nonzero(valid).flatten()
    if rows.numel() == 0:
        return
    rec = torch.stack([torch.as_tensor(c, dtype=i64, device=valid.device)
                       .expand(valid.shape)[rows] for c in cols], dim=1)
    ws.recs[r0 + rows] = rec
    ws.rec_valid[r0 + rows] = 1


def _empty_entries(n: int):
    """The canonical empty entry of the outbound and stream blocks."""
    return (n, NEVER32, NEVER32, 0, 0, 0, 0, 0)


def lane_slots_plain(p: LaneParams, tb: LaneTables, s: LaneState,
                     ws: Workspace) -> None:
    """Kernel A, plain: pop up to K events per lane inside the window under
    the co-pop rule and run the slot law on each, in slot order.  Consumed
    slots become NEVER in place; the state vectors are updated in place;
    the self, outbound, stream and record blocks go to ``ws``.  On a
    tiered run the lanes run without the stream models."""
    if not int(ws.ctl[0]):
        return
    _tail, rec_slots, rec_srec, _brec, rec_end = p.rec_offsets
    p = p.lane
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


def exchange_merge_plain(p: LaneParams, tb: LaneTables, s: LaneState,
                         ws: Workspace) -> None:
    """Kernel B, plain: the cross-lane exchange and the keyed row merge.

    Exchanged entries — the outbound packets, then in star stream configs
    the stream block's control sends, RTO arms and bursts — are grouped by
    destination in index order; each lane takes the first Cx of its group
    as its cross block and counts the rest as shed (``n_queue``).  Then
    each row of ``[queue C | self S | cross Cx]`` is sorted by the event
    key, ties in index order, and the first C kept; real events past column
    C are queue overflow (``n_queue``, and DROP_QUEUE records when
    logging).  Stream configs carry the payload words through it all.

    On a tiered run (the lanes without the stream models) the cross
    entries of stream-endpoint lanes divert into the tier: each endpoint
    row's cross block goes to the tier block's cross channel, and in the
    lane's own merge those entries take the NEVER time (the reference's
    ``_merge_append(divert=True)``)."""
    if not int(ws.ctl[0]):
        return
    tiered = p.stream_tiered
    cx0 = p.tier_layout[3]
    p = p.lane
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
    if tiered:
        el = tb.flow_lanes.long()
        blk = ws.tier_blk[:, cx0:].view(7, el.shape[0], cx)
        for w in range(5):
            blk[w] = cross[w][el]
        blk[5:] = 0
        keep = ~tb.lane_stream[:, None]
        cross[0] = torch.where(keep, cross[0], NEVER32)
        cross[1] = torch.where(keep, cross[1], NEVER32)

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


# --------------------------------------------------------------------------
# the tiered stream pass: kernels F and G, plain
# --------------------------------------------------------------------------


def stream_tier_plain(p: LaneParams, tb: LaneTables, s: LaneState,
                      ws: Workspace) -> None:
    """Kernel F, plain: the tier's pop and slot walk (the reference's
    ``_stream_tier_iter`` up to its merge).  Each endpoint row pops a
    prefix of its first K_s queue columns inside the window — any prefix
    free of LOCAL events under ``stream_wide_pop``, else a same-instant
    prefix of PACKETs, or column 0 alone — and runs each popped event in
    slot order on its compact state: a PACKET takes the down bucket and
    CoDel and, delivered inside the window (wide pop only), applies the
    lane-TCP law at once, else becomes a DELIVERY fallback; a start marker
    opens a client flow, an owned RTO local fires the timer, a segment
    (at a server row only from its own client) runs ``on_segment``; every
    stimulus ends with the pump burst.  The control send and, on client
    rows, the burst charge the up bucket (the burst after its first unit by
    the chained law), each with its loss draw at its send sequence number;
    RTO arms take the row's local sequence.  The candidates go to the tier
    block (``tier_layout``), the records to the tier's record groups; the
    flows, the tier vectors and the popped queue slots change in place."""
    if not int(ws.ctl[0]):
        return
    ts = s.stream
    q, v = ts.q, ts.v
    ks, sf = p.stream_pops, p.s_flows
    s2 = 2 * sf
    dev = q.device
    we_hi, we_lo = s.now_we_hi, s.now_we_lo
    el, peers, clid = tb.flow_lanes, tb.flow_peers, tb.flow_clid
    is_cl = torch.arange(s2, device=dev) < sf
    cl = slice(0, sf)
    sa0, se0, bo0, cx0, _end = p.tier_layout
    blk = ws.tier_blk
    blk[:2, :cx0] = NEVER32
    blk[2:, :cx0] = 0
    trec, tsrec, tbrec, ttail, _rend = p.tier_rec_offsets
    log_on = bool(p.log_capacity)
    if log_on:
        ws.recs[trec:ttail] = 0
        ws.rec_valid[trec:ttail] = 0

    # the pop prefix (rows are sorted, so each rule gives a row prefix)
    cols = [q[w, :, :ks].clone() for w in range(7)]
    thi_b, tlo_b = cols[lstr.TQ_THI], cols[lstr.TQ_TLO]
    kind_b = cols[lstr.TQ_AUXH] >> AUX_KIND_SHIFT
    if p.stream_wide_pop:
        prefix = torch.cumprod((kind_b != LOCAL).to(i32), dim=1).bool()
    else:
        same_t = (thi_b == thi_b[:, :1]) & (tlo_b == tlo_b[:, :1])
        prefix = same_t & torch.cumprod((kind_b == PACKET).to(i32),
                                        dim=1).bool()
    prefix[:, 0] = True
    act_b = prefix & pair_lt(thi_b, tlo_b, we_hi, we_lo)
    q[lstr.TQ_THI, :, :ks] = torch.where(act_b, NEVER32, thi_b)
    q[lstr.TQ_TLO, :, :ks] = torch.where(act_b, NEVER32, tlo_b)

    f = lstr.endpoint_cols(ts.flows, tb.flow_segs, tb.flow_mss,
                           tb.flow_last, tb.flow_cc)
    vr = list(v.clone())  # the TV_* rows, rebound by the laws below
    mul = s.min_used_lat.clone()
    interval = p.bucket_interval
    loc_auxh = pack_aux_hi(LOCAL, el)
    pkt_auxh = pack_aux_hi(PACKET, el)

    n_live = int(act_b.sum(dim=1).max()) if s2 else 0
    for j in range(n_live):
        thi, tlo = thi_b[:, j], tlo_b[:, j]
        auxh, auxl, size = (cols[w][:, j] for w in (2, 3, 4))
        phi, plo = cols[lstr.TQ_PHI][:, j], cols[lstr.TQ_PLO][:, j]
        act = act_b[:, j]
        kind, src = unpack_aux_hi(auxh)

        # PACKET: down bucket and CoDel on the compact rows
        is_pkt = act & (kind == PACKET)
        (vr[lstr.TV_DN_TOK], vr[lstr.TV_DN_NRH], vr[lstr.TV_DN_NRL],
         vr[lstr.TV_DN_LDH], vr[lstr.TV_DN_LDL], td_hi, td_lo,
         _waited) = bucket_charge_vec(
            vr[lstr.TV_DN_TOK], vr[lstr.TV_DN_NRH], vr[lstr.TV_DN_NRL],
            vr[lstr.TV_DN_LDH], vr[lstr.TV_DN_LDL], tb.flow_dn_rate,
            tb.flow_dn_burst, tb.flow_dn_kfull, tb.flow_dn_kfi, thi, tlo,
            (size + FRAME_OVERHEAD_BYTES) * 8, is_pkt, interval)
        sojourn = pair_sub_clamp(td_hi, td_lo, thi, tlo, NEVER32)
        (vr[lstr.TV_CD_FATH], vr[lstr.TV_CD_FATL], vr[lstr.TV_CD_DNH],
         vr[lstr.TV_CD_DNL], vr[lstr.TV_CD_CNT], dropping,
         codel_drop) = codel_offer_arrays(
            vr[lstr.TV_CD_FATH], vr[lstr.TV_CD_FATL], vr[lstr.TV_CD_DNH],
            vr[lstr.TV_CD_DNL], vr[lstr.TV_CD_CNT],
            vr[lstr.TV_CD_DROP].bool(), td_hi, td_lo, sojourn, is_pkt,
            tb.codel_div)
        vr[lstr.TV_CD_DROP] = dropping.to(i32)
        deliver = is_pkt & ~codel_drop
        vr[lstr.TV_N_DEL] = vr[lstr.TV_N_DEL] + deliver
        vr[lstr.TV_N_CODEL] = vr[lstr.TV_N_CODEL] + (is_pkt & codel_drop)
        if log_on:
            _put_recs(ws, trec + j * s2, is_pkt, t_join(td_hi, td_lo), src,
                      el, auxl, size,
                      torch.where(codel_drop, DROP_CODEL, DELIVERED))

        # delivery elision: a delivery inside the window applies the law at
        # once (wide pop only), else a DELIVERY fallback is inserted
        if p.stream_wide_pop:
            del_now = deliver & pair_lt(td_hi, td_lo, we_hi, we_lo)
        else:
            del_now = torch.zeros_like(deliver)
        _put_entries(blk, j * s2, deliver & ~del_now, td_hi, td_lo,
                     pack_aux_hi(DELIVERY, src), auxl, size, phi, plo)

        # the stimuli, at the delivery time either way
        sh = torch.where(del_now, td_hi, thi)
        sl = torch.where(del_now, td_lo, tlo)
        is_loc = act & (kind == LOCAL)
        stim_open = is_loc & (size == -1) & is_cl
        stim_rto = is_loc & (size == lstr.SZ_RTO) & (plo == clid)
        stim_seg = ((del_now | (act & (kind == DELIVERY)))
                    & ((phi | plo) != 0) & (is_cl | (src == clid)))
        stim = stim_open | stim_rto | stim_seg
        if not bool(stim.any()):
            continue
        ctr = {"up": vr[lstr.TV_UP_TOK:lstr.TV_UP_LDL + 1],
               "send_seq": vr[lstr.TV_SEND_SEQ],
               "local_seq": vr[lstr.TV_LOCAL_SEQ],
               "n_sends": vr[lstr.TV_N_SENDS], "n_loss": vr[lstr.TV_N_LOSS],
               "min_lat": mul}
        st64 = t_join(sh, sl)

        def burst_out(u, valid, lost, bthi, btlo, seq, bsize, bphi, bplo):
            slot = j * PUMP_BURST + u
            _put_entries(blk, bo0 + slot * sf, valid, bthi, btlo,
                         pkt_auxh[cl], seq, bsize, bphi, bplo)
            if log_on:
                _put_recs(ws, tbrec + slot * sf, lost, st64[cl], el[cl],
                          peers[cl], seq, bsize, DROP_LOSS)

        f, se = _stream_stimulus(p, tb, f, (stim_open, stim_rto, stim_seg),
                                 sh, sl, phi, plo, size, ctr, we_hi, we_lo,
                                 burst_out)
        vr[lstr.TV_UP_TOK:lstr.TV_UP_LDL + 1] = ctr["up"]
        for r, key in ((lstr.TV_SEND_SEQ, "send_seq"),
                       (lstr.TV_LOCAL_SEQ, "local_seq"),
                       (lstr.TV_N_SENDS, "n_sends"),
                       (lstr.TV_N_LOSS, "n_loss")):
            vr[r] = ctr[key]
        mul = ctr["min_lat"]
        _put_entries(blk, se0 + j * s2, se.send & ~se.lost, se.thi, se.tlo,
                     pkt_auxh, se.seq, se.size, se.phi, se.plo)
        if log_on:
            _put_recs(ws, tsrec + j * s2, se.lost, st64, el, peers, se.seq,
                      se.size, DROP_LOSS)
        # the RTO arm: a LOCAL self-insert at the own row
        _put_entries(blk, sa0 + j * s2, se.arm, se.arm_thi, se.arm_tlo,
                     loc_auxh, se.lseq, lstr.SZ_RTO, 0, clid)
    ts.flows.copy_(lstr.endpoint_split(f))
    v.copy_(torch.stack(vr))
    s.min_used_lat.copy_(mul)


def _tier_candidates(p: LaneParams, ws: Workspace) -> torch.Tensor:
    """The tier merge's ``[7, 2S, W_t]`` candidates per endpoint row, in
    the reference's order: its DELIVERY fallbacks [K_s], its RTO arms
    [K_s], its peer's control sends [K_s], on server rows its client's
    bursts [K_s*B] (slot-major; empty on client rows), and its diverted
    cross entries [Cx]."""
    ks, sf = p.stream_pops, p.s_flows
    s2 = 2 * sf
    sa0, se0, bo0, cx0, end = p.tier_layout
    blk = ws.tier_blk

    def rows(lo, hi):  # [K_s, 2S] channel -> [7, 2S, K_s]
        return blk[:, lo:hi].reshape(7, ks, s2).transpose(1, 2)

    se = rows(se0, bo0)
    bo = blk[:, bo0:cx0].reshape(7, ks * PUMP_BURST, sf).transpose(1, 2)
    pad = torch.zeros_like(bo)
    pad[:2] = NEVER32
    return torch.cat([
        rows(0, sa0), rows(sa0, se0),
        torch.cat([se[:, sf:], se[:, :sf]], dim=1),  # emitter -> receiver
        torch.cat([pad, bo], dim=1),
        blk[:, cx0:end].reshape(7, s2, p.cross_cap),
    ], dim=2)


def tier_merge_plain(p: LaneParams, tb: LaneTables, s: LaneState,
                     ws: Workspace) -> None:
    """Kernel G, plain: the tier merge.  Each endpoint row's queue ``[C2]``
    and its ``W_t`` candidates (``_tier_candidates``) are merged by the
    event key, ties in index order; the first C2 valid entries are kept,
    then empty slots in canonical form (the NEVER time pair, zero words) —
    the popped holes' old words are not carried.  Valid entries past C2
    are queue overflow: counted into ``TV_N_QUEUE`` and, when logging,
    recorded as DROP_QUEUE in the tier's tail group [2S, W_t]."""
    if not int(ws.ctl[0]):
        return
    ts = s.stream
    c2 = p.stream_capacity
    merged = torch.cat([ts.q, _tier_candidates(p, ws)], dim=2)
    valid = merged[0] != NEVER32
    empty = torch.tensor([NEVER32, NEVER32, 0, 0, 0, 0, 0], dtype=i32,
                         device=merged.device)[:, None, None]
    merged = torch.where(valid[None], merged, empty)
    perm = _key_order(*merged[:4])
    merged = torch.gather(merged, 2, perm[None].expand_as(merged))
    tail = merged[:, :, c2:]
    tail_valid = tail[0] != NEVER32
    ts.v[lstr.TV_N_QUEUE] += tail_valid.sum(dim=1, dtype=i32)
    if p.log_capacity:
        _kind, t_src = unpack_aux_hi(tail[2])
        dst = tb.flow_lanes.to(i64)[:, None].expand_as(t_src)
        rec = torch.stack([
            t_join(tail[0], tail[1]), t_src.to(i64), dst, tail[3].to(i64),
            tail[4].to(i64), torch.full_like(dst, DROP_QUEUE),
        ], dim=2)
        rec = torch.where(tail_valid[:, :, None], rec, 0)
        r0, r1 = p.tier_rec_offsets[3:]
        ws.recs[r0:r1] = rec.reshape(-1, 6)
        ws.rec_valid[r0:r1] = tail_valid.reshape(-1).to(i32)
    ts.q.copy_(merged[:, :, :c2])


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
    parameters say so.  On a tiered run the heads of the tier's endpoint
    rows count too.  Writes ``ctl = (live, in_window, head_hi,
    head_lo)``."""
    mh, ml = _pairs.pair_min_lanes(s.q_thi[:, 0], s.q_tlo[:, 0])
    if p.stream_tiered:
        tq = s.stream.q
        th, tl = _pairs.pair_min_lanes(tq[lstr.TQ_THI, :, 0],
                                       tq[lstr.TQ_TLO, :, 0])
        sel = pair_lt(th, tl, mh, ml)
        mh, ml = torch.where(sel, th, mh), torch.where(sel, tl, ml)
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
    """One iteration of the window loop (kernels A, B, then E in
    untiered one-to-one stream configs or F and G on a tiered run, and,
    when logging, D) and the step that precedes it (kernel C), bound to
    this run's state."""
    from . import kernels

    args = kernels.LaneArgs(p, tb, s, make_workspace(p, s.q_thi.device))
    split, tiered, logging = p.split, p.stream_tiered, bool(p.log_capacity)

    def window(advance: bool) -> None:
        kernels.queue_min_window(args, advance)

    def iteration() -> None:
        kernels.lane_slots(args)
        kernels.exchange_merge(args)
        if split:
            kernels.stream_rows_merge(args)
        if tiered:
            kernels.stream_tier(args)
            kernels.tier_merge(args)
        if logging:
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
