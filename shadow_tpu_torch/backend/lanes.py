"""Lane backend of the port: state, laws, and the plain versions of the lane
kernels, plus the drivers (round by round, and the device loop, which is
the batched loop over S scenarios of one shape at S = 1).

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
- D ``append_log``: compaction of the iteration's records into the log
  and, with flowtrace, of its flow records into the ring.

The hybrid backend (``backend/hybrid.py``: managed binaries on the host
CPU, every packet here) marks its hosts' lanes EXTERNAL and adds:

- H ``inject_merge``: the host's staged sends, a block of B PACKET
  arrivals, merged into the lane queues (once per staged block, before a
  turn);
- in A, the external arm: a packet popped at an external lane neither
  delivers inline nor inserts a DELIVERY; its outcome (DELIVERED or a
  CoDel drop) is an egress candidate, which D compacts into the egress
  buffer as a third instance, with the earliest delivery's time;
- C's hybrid mode (``HybridTurn``): the turn's window law, bounded by the
  host side's next event and the earliest egressed delivery, stopping
  after the first window the host takes part in, and the turn's packed
  ``[5]`` readback (``_build_hybrid_run``).

Three observation planes ride these kernels, all static and all free when
off: pcap (a capturing host's sends become PCAP_TX records in the log, at
their departure; ``GpuEngine`` writes the capture files from the log),
netobs (the ``nb_*`` counters: bytes, throttles and sheds per lane, the
tier's ``TV_NB_*`` rows, and a histogram of windows by their popped
packets, which kernel C folds at each window advance) and flowtrace (the
lifecycle events of a seeded sample of the flows: A's sends, arrivals and
stream sends, B's and E's queue sheds, as flow records that D appends to
the ``[FL, 10]`` ring; untiered runs only).

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
only every few steps).  A sweep's S scenarios each keep their own state,
tables, workspace and flag; one launch of each kernel serves them all.
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
from ..obs import flowtrace as ftr
from . import lanes_pairs as _pairs
from . import lanes_stream as lstr
from .results import DELIVERED, DROP_CODEL, DROP_LOSS, DROP_QUEUE, PCAP_TX

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

# netobs: buckets of the per-window packet-arrival histogram (must match
# obs.netobs.HIST_BUCKETS)
NB_HIST_BUCKETS = 24

# flowtrace: A's [N] groups an iteration (sends: the send, the up bucket's
# wait, the loss, the queue entry; arrivals: the down bucket's wait, the
# CoDel drop, the delivery), and the words of a flow record in the
# workspace (t_hi, t_lo, kind, src, dst, seq, size, aux: D adds the window
# stamp as the ring row's columns 2 and 3)
FLOW_SLOT_GROUPS = 7
FLOW_REC_WORDS = 8

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
    # the netobs telemetry block (LaneParams.netobs; empty [0] tensors when
    # off, where the reference holds ()): per-lane int32 counters, the
    # histogram of windows by floor(log2) of their popped PACKETs, and the
    # current window's count
    nb_txb: torch.Tensor  # [N] bytes offered to the up bucket (sends)
    nb_rxb: torch.Tensor  # [N] bytes delivered (after CoDel)
    nb_thr: torch.Tensor  # [N] token-bucket charges that waited (up + down)
    nb_shed: torch.Tensor  # [N] cross-block sheds (a part of n_queue)
    nb_hist: torch.Tensor  # [NB_HIST_BUCKETS]
    nb_win: torch.Tensor  # int32 scalar: PACKETs popped in this window
    # the flowtrace ring (LaneParams.flowtrace; empty [0] tensors when off,
    # where the reference holds ()): lifecycle events of the sampled flows
    # as [FL, flowtrace.FT_COLS] int32 rows in append order.  It never
    # wraps: rows past its end are counted in fl_lost
    fl_buf: torch.Tensor
    fl_count: torch.Tensor  # int32 scalar: rows appended (kept or not)
    fl_lost: torch.Tensor  # int32 scalar: rows lost on overflow
    # the hybrid backend's egress (LaneParams.external_any; empty [0] int32
    # tensors otherwise, where the reference holds ()): the outcomes of the
    # packets that arrived at EXTERNAL lanes (host-executed hosts) this
    # turn, as [E, 6] int64 rows (t_deliver, src, dst, seq, size, DELIVERED
    # or DROP_CODEL) in the reference's order, their count, the rows lost
    # past E, and the earliest DELIVERED time as a pair (the window law's
    # bound on the host side's pending events)
    egress: torch.Tensor
    egress_count: torch.Tensor  # int32 scalar
    egress_lost: torch.Tensor  # int32 scalar
    egress_min_hi: torch.Tensor  # int32 scalar pair
    egress_min_lo: torch.Tensor


class RecGroups(NamedTuple):
    """The start of each record group of the iteration's record block
    (``LaneParams.rec_offsets``); the [N] merge tail starts at 0."""
    split: int  # the split exchange's tail, or the tier's groups
    slots: int  # the popped slots' records [K, N]
    pc: int  # the lanes' PCAP_TX captures [K, N]
    spc: int  # the stream control sends' captures [K, 2S]
    bpc: int  # the stream bursts' captures [K, B, S]
    srec: int  # the stream control sends' losses [K, 2S]
    brec: int  # the stream bursts' losses [K, B, S]
    end: int


class FlowGroups(NamedTuple):
    """The start of each flow-record group of the iteration's flow
    buffer (``LaneParams.flow_offsets``), in the reference's append order;
    B's merge tail starts at 0."""
    split: int  # E's split merge tail [2S, W_s]
    slots: int  # A's seven [N] groups, [K, N] each (FLOW_SLOT_GROUPS)
    ss: int  # A's four stream control-send groups, [K, 2S] each
    bs: int  # A's four stream burst groups, [K, B, S] each
    end: int


class TierRecGroups(NamedTuple):
    """The start of each of the tier's record groups
    (``LaneParams.tier_rec_offsets``)."""
    rec: int  # the popped packets' outcomes [K_s, 2S]
    srec: int  # the control sends' losses [K_s, 2S]
    brec: int  # the bursts' losses [K_s, B, S]
    spc: int  # the control sends' captures [K_s, 2S]
    bpc: int  # the bursts' captures [K_s, B, S]
    tail: int  # the tier merge's DROP_QUEUE tail [2S, W_t]
    end: int


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
    # the observation planes, both static: a lane that captures pcap makes
    # PCAP_TX records at each send's departure (``pcap_any``; stream
    # endpoints' captures ride their own record groups, ``stream_pcap``);
    # ``netobs`` keeps the nb_* counters.  Off, no record group and no
    # counter exists
    pcap_any: bool = False
    stream_pcap: bool = False
    netobs: bool = False
    # the flowtrace plane, static as well: each iteration's lifecycle
    # events of the sampled flows — a flow (src, dst) records iff
    # ``flow_all`` or its hash under ``flow_seed`` is below ``flow_thresh``
    # (u32) — go into the [FL] ring (``flow_capacity`` rows)
    flowtrace: bool = False
    flow_capacity: int = 0
    flow_thresh: int = 0
    flow_all: bool = False
    flow_seed: int = 0
    # the hybrid backend (backend/hybrid.py): some lanes are EXTERNAL — their
    # apps (real managed binaries) run on the host CPU while their network
    # down side (down bucket, CoDel, arrival queue) stays here.  Packets
    # arriving there leave through the egress buffer (E = egress_capacity
    # rows; a turn stops before fewer than ext_per_iter rows, one
    # iteration's worst case, are left); host sends come in as injection
    # blocks of inject_batch rows, each lane taking up to inject_cross (0 =
    # C) of a block
    external_any: bool = False
    egress_capacity: int = 0
    ext_per_iter: int = 0
    inject_batch: int = 0
    inject_cross: int = 0
    # the k-window fused hybrid law (kernel C's fused mode): at most
    # hybrid_k_cap windows a dispatch (0: the one-window law), over a
    # schedule of ext_slots peeked host event times
    hybrid_k_cap: int = 0
    ext_slots: int = 0

    @property
    def cross_cap(self) -> int:
        return min(self.cross_capacity, self.capacity) or self.capacity

    @property
    def inject_cap(self) -> int:
        """Cxi: the injected rows a lane takes from one block."""
        return min(self.inject_cross or self.capacity, self.capacity)

    @property
    def hyb_words(self) -> int:
        """Words of the turn's readback (``Workspace.hyb``): the
        ``HYB_*`` slots; with the fused law also the consumed-window count,
        the k_cap window ends and the dispatch's step count."""
        return (HYB_WE_BASE + self.hybrid_k_cap + 1 if self.hybrid_k_cap
                else HYB_K_DONE)

    @property
    def egress_slots(self) -> int:
        """Egress candidates an iteration: one per popped slot, [K, N]."""
        return self.pops_per_iter * self.n_lanes if self.external_any else 0

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
            stream_tiered=False, stream_clients=(), stream_pcap=False)

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
    def tier_rec_offsets(self) -> "TierRecGroups":
        """Where the tier's record groups start (logging), after the [N]
        merge tail: the popped packets' outcomes [K_s, 2S], the control
        sends' losses [K_s, 2S], the bursts' losses [K_s, B, S], with
        ``stream_pcap`` the control sends' and the bursts' captures, then
        the tier merge's tail [2S, W_t]; and their end."""
        pl = self.lane
        tail = self.n_lanes * (pl.self_width + pl.cross_cap)
        if not self.stream_tiered:
            return TierRecGroups(*(tail,) * 7)
        ks, s = self.stream_pops, self.s_flows
        srec = tail + ks * 2 * s
        brec = srec + ks * 2 * s
        spc = brec + ks * PUMP_BURST * s
        bpc = spc + (ks * 2 * s if self.stream_pcap else 0)
        ttail = bpc + (ks * PUMP_BURST * s if self.stream_pcap else 0)
        return TierRecGroups(tail, srec, brec, spc, bpc, ttail,
                             ttail + 2 * s * self.tier_width)

    @property
    def rec_offsets(self) -> "RecGroups":
        """Where the record groups of the workspace's record block start,
        in the reference's append order: the merge tail [N, self + Cx]
        from 0, then the split exchange's tail [2S, W_s] (or, tiered, the
        tier's groups, ``tier_rec_offsets``), the popped slots [K, N], with
        ``pcap_any`` the lanes' captures [K, N], with streams on the [N]
        lanes and ``stream_pcap`` the control sends' [K, 2S] and the
        bursts' captures [K, B, S], then the stream control sends' losses
        [K, 2S] and the bursts' losses [K, B, S]; and the block's end."""
        pl = self.lane
        n, k, s = self.n_lanes, self.pops_per_iter, self.s_flows
        split = n * (pl.self_width + pl.cross_cap)
        if self.stream_tiered:
            slots = self.tier_rec_offsets.end
        else:
            slots = split + (2 * s * self.stream_row_width if self.split
                             else 0)
        pc = slots + k * n
        spc = pc + (k * n if self.pcap_any else 0)
        stream_pc = pl.stream_present and pl.stream_pcap
        bpc = spc + (2 * k * s if stream_pc else 0)
        srec = bpc + (k * PUMP_BURST * s if stream_pc else 0)
        brec = srec + (2 * k * s if pl.stream_present else 0)
        end = brec + (k * PUMP_BURST * s if pl.stream_present else 0)
        return RecGroups(split, slots, pc, spc, bpc, srec, brec, end)

    @property
    def n_records(self) -> int:
        return self.rec_offsets.end

    @property
    def flow_offsets(self) -> "FlowGroups":
        """Where the flow-record groups of the workspace's flow buffer
        start, in the reference's append order: B's merge tail [N, self +
        Cx] from 0 (its FT_DROP queue sheds), E's split tail [2S, W_s], A's
        [N] groups (``FLOW_SLOT_GROUPS``, [K, N] each), with streams its
        control-send groups [K, 2S] and burst groups [K, B, S] (four each:
        send or retransmit, the up bucket's wait, the loss, the queue
        entry); and the buffer's end."""
        n, k, s = self.n_lanes, self.pops_per_iter, self.s_flows
        split = n * (self.self_width + self.cross_cap)
        slots = split + (2 * s * self.stream_row_width if self.split else 0)
        ss = slots + FLOW_SLOT_GROUPS * k * n
        bs = ss + (4 * 2 * k * s if self.stream_present else 0)
        end = bs + (4 * k * PUMP_BURST * s if self.stream_present else 0)
        return FlowGroups(split, slots, ss, bs, end)

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
        if self.flowtrace and self.stream_tiered:
            # the plane rides the untiered path; engines drop the tier (an
            # equivalent execution) when tracing
            raise ValueError("flowtrace requires stream_tiered=False")
        if self.flowtrace and self.flow_capacity <= 0:
            raise ValueError(
                f"flowtrace requires flow_capacity > 0 (got {self.flow_capacity})"
            )
        if self.external_any and self.stream_tiered:
            # the reference's rule: injections land in [N] rows, which the
            # tier would orphan for stream lanes
            raise ValueError("the hybrid backend requires stream_tiered=False")
        if self.hybrid_k_cap and not (
                self.external_any and self.ext_slots >= 2):
            raise ValueError(
                f"the fused hybrid law needs external lanes and a schedule "
                f"of at least 2 slots (got ext_slots={self.ext_slots})")
        if self.external_any and (
                self.inject_batch < 1
                or self.egress_capacity <= self.ext_per_iter):
            raise ValueError(
                f"the hybrid backend needs inject_batch >= 1 (got "
                f"{self.inject_batch}) and egress_capacity > ext_per_iter "
                f"(got {self.egress_capacity} <= {self.ext_per_iter})")
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
    # pcap: which hosts capture [N] bool, and which endpoint rows ([2S]
    # bool, the placeholders' lanes when no stream model is present)
    lane_pcap: torch.Tensor
    flow_pcap: torch.Tensor
    # the hybrid backend: which lanes are EXTERNAL, [N] bool (empty [0]
    # int32 otherwise, where the reference holds ())
    lane_external: torch.Tensor


class Workspace(NamedTuple):
    """Per-run buffers the kernels hand to each other (allocated once)."""

    # [4] int32: live (min head < stop), in_window (min head < window end),
    # and the min head pair (hi, lo) — written by queue_min_window, which
    # leaves a done run (live 0) alone; armed (live 1) by the host before a
    # run or a fault segment
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
    # split exchange's tail or the tier's groups, the slot records
    # (slot-major [K, N]), the pcap captures, then the stream losses — the
    # reference's append order.  [1, 6] / [1] placeholders when logging is
    # off.
    recs: torch.Tensor
    rec_valid: torch.Tensor
    # exchange scratch: per-destination counts, starts and fill cursors [N],
    # the exchanged entries grouped by destination: the K*N outbound
    # packets, then (star stream configs) the stream block's entries; and
    # the count kernel's finished blocks [1] (its last one scans).  Zero
    # between the kernels' calls: they reset what they use.
    x_cnt: torch.Tensor
    x_start: torch.Tensor
    x_fill: torch.Tensor
    x_order: torch.Tensor
    x_done: torch.Tensor
    # [7, T] int32, tiered runs ([7, 1] otherwise): the tier merge's
    # candidates by LaneParams.tier_layout — kernel F's DELIVERY
    # fallbacks, RTO arms, control sends and bursts, and the cross entries
    # that kernel B diverts to stream endpoints; words thi, tlo, auxh,
    # auxl, size, phi, plo, empty entries canonical (the NEVER time pair,
    # zero words)
    tier_blk: torch.Tensor
    # [R_f, FLOW_REC_WORDS] int32 flow records + [R_f] int32 valid flags
    # (LaneParams.flow_offsets), flowtrace runs ([1, 8] / [1] otherwise):
    # B's FT_DROP queue sheds, E's, then A's groups — the reference's
    # append order, which D keeps.  Every flag is written each iteration,
    # the words of valid records only
    fl_recs: torch.Tensor
    fl_valid: torch.Tensor
    # the merges' rows where one is too wide for a block's shared memory
    # (merge_scratch_words; [0] when every row fits, and on the CPU)
    m_scratch: torch.Tensor
    # the hybrid backend ([1, 6] / [1] / [5] otherwise): kernel A's egress
    # candidates, [K*N, 6] int64 rows (slot-major, the reference's append
    # order) and their flags, which D compacts into the state's egress;
    # and the turn's packed readback, int64 [LaneParams.hyb_words] by the
    # HYB_* indices, which C writes when the turn stops (HYB_DEV_WE < 0
    # until then)
    eg_recs: torch.Tensor
    eg_valid: torch.Tensor
    hyb: torch.Tensor
    # the fused hybrid law ([1] / [3] otherwise): the dispatch's schedule,
    # [ext_slots] int64 host event times (ascending, the horizon in the
    # last slot, NEVER where there is none), and C's fused-mode registers
    # across steps, int32 [3]: the schedule pointer, the windows consumed
    # and the dispatch's live steps (the run flag is ctl[0])
    ext: torch.Tensor
    fz: torch.Tensor


# bytes of static shared memory the merge kernels keep beside a row
SMEM_STATIC_RESERVE = 1024


def merge_in_shared(entries: int, words: int, extra: int, optin: int) -> bool:
    """The merges' size rule, fixed before a run starts: a row of
    ``entries`` entries of ``words`` int32 words, with ``extra`` bytes
    beside it, is merged in one block's shared memory when it fits the
    device's opt-in limit per block (``optin`` bytes, the CUDA attribute
    ``sharedMemPerBlockOptin``) less the static reserve; otherwise in
    global memory, in the workspace's ``m_scratch``."""
    return 4 * words * entries + extra <= optin - SMEM_STATIC_RESERVE


# the widest row B's narrow form merges: one entry a warp lane
MERGE_WARP_ENTRIES = 32


def merge_in_warp(entries: int) -> bool:
    """B's form, fixed before a run starts: a row of at most 32 entries
    (the flagship's and the tiered mesh's 26) is merged by one warp in its
    registers, several lanes a block; a wider one by a block, in shared
    memory or ``m_scratch`` by :func:`merge_in_shared`."""
    return entries <= MERGE_WARP_ENTRIES


# kernel C's head reduction: threads a block (csrc/lanes.cu HEAD_THREADS)
# and the most blocks of its cluster (16: the non-portable cluster size
# Hopper allows)
HEAD_THREADS = 1024
HEAD_CLUSTER_MAX = 16


def heads_blocks(n_heads: int) -> int:
    """Kernel C's cluster, fixed before a run starts: the blocks its head
    reduction spreads over — one head a thread, so ``ceil(n_heads /
    1024)``, at least one and at most 16 (a thread then loads several,
    all before its min).  The flagships' 10,000 heads take 10 blocks; the
    hybrid flagship's 1,151 two; up to 1,024 heads one block, a cluster of
    one.  ``n_heads``: the [N] lanes and, on a tiered run, the tier's 2S
    endpoint rows."""
    return max(1, min(HEAD_CLUSTER_MAX, -(-n_heads // HEAD_THREADS)))


# kernel A's widest group: a warp (csrc/lanes.cu SLOT_GROUP_MAX)
SLOT_GROUP_MAX = 32


def slot_group(k: int) -> int:
    """Kernel A's form, fixed before a run starts: the threads of one
    warp that walk one lane, each taking the columns ``gl``, ``gl + L``, ...
    — two columns a thread from K = 4 on (the smallest power of two >= K /
    2), 2 at K = 2 and 3, 1 at K = 1, at most 32; 128 threads a block, and
    on a run with streams a warp for each stream lane after the groups.
    Measured on the H100 (``scripts/gpu_slot_probe.py``): the flagship's
    and the tiered mesh's K = 2 fastest at 2, the untiered mesh's K = 4 at
    2, PHOLD's K = 8 at 4 (a thread a column, or one a lane, slower on
    each)."""
    return min(SLOT_GROUP_MAX, sort_width(max(k // 2, min(k, 2))))


def tier_row_words(entries: int) -> int:
    """int32 words of G's working memory for a row of ``entries``: the
    valid entries' seven words and their order, and two words a chunk of
    32 (its valid mask and the valid entries before it)."""
    return 8 * entries + 2 * -(-entries // 32)


# kernel D's compaction (csrc/lanes.cu): the blocks of an instance's
# cluster, the flags a thread takes as one mask, and a block's tile (its
# 1,024 threads' masks); a slice past one tile scans its later tiles one at
# a time
LOG_CLUSTER = 16
LOG_BITS = 32
LOG_TILE = 1024 * LOG_BITS


def sort_width(entries: int) -> int:
    """The length of a merge's sort index array: the smallest power of two
    that holds the row's entries (the kernels' bitonic network)."""
    return 1 << max(entries - 1, 0).bit_length()


def split_row_words(capacity: int, width: int) -> int:
    """int32 words of E's working memory for a row of a ``capacity``-wide
    queue and ``width`` candidates: the queue's and the non-canonical
    candidates' seven words and their order, and a canonical-empty mask a
    chunk of 32 candidates (``split_row_words`` in csrc/lanes.cu)."""
    return 8 * (capacity + width) + -(-width // 32)


# kernel H's selection entry: the key's four words, the block row, the size
INJ_SEL_WORDS = 6


def inject_row_words(capacity: int, cross: int, batch: int) -> int:
    """int32 words of H's working memory for a lane of a
    ``capacity``-wide queue taking up to ``cross`` rows of a ``batch``-row
    injection block: the queue's and the group run's seven words and their
    order, the group's mask and base a chunk of 32 block rows, the
    selection's two runs of ``cross`` and its batch of 32
    (``inject_row_words`` in csrc/lanes.cu)."""
    return (8 * (capacity + cross) + 2 * -(-batch // 32)
            + INJ_SEL_WORDS * (2 * cross + 32))


def merge_rows(p: LaneParams) -> dict:
    """The run's merges: name -> (rows, entries a row, words an entry,
    extra bytes a row): B's ``[C | self | Cx]`` rows with their sort's
    index array (its group selection uses it first); E's ``[C | W_s]``
    and H's ``[C | Cxi]`` rows as their warps' working memory
    (:func:`split_row_words`, :func:`inject_row_words`: eight words an
    entry, the rest as extra bytes); G's ``[C2 | W_t]`` rows with their
    order and chunk words (:func:`tier_row_words`).
    B's narrow form (:func:`merge_in_warp`) keeps its row in registers, and
    such a row always passes the shared-memory rule, so it never sizes
    ``m_scratch``."""
    pl = p.lane
    out = {"merge": (p.n_lanes, pl.merge_width, pl.words,
                     4 * sort_width(pl.merge_width))}
    if p.external_any:
        c, cxi = p.capacity, p.inject_cap
        w = c + cxi
        out["inject merge"] = (p.n_lanes, w, 8, 4 * (
            inject_row_words(c, cxi, p.inject_batch) - 8 * w))
    if p.split:
        c, ws = p.capacity, p.stream_row_width
        out["stream merge"] = (2 * p.s_flows, c + ws, 8, 4 * (
            split_row_words(c, ws) - 8 * (c + ws)))
    if p.stream_tiered:
        w = p.stream_capacity + p.tier_width
        out["tier merge"] = (2 * p.s_flows, w, 7,
                             4 * (tier_row_words(w) - 7 * w))
    return out


def merge_scratch_words(p: LaneParams, optin: int) -> int:
    """int32 words of ``m_scratch``: the largest of the merges that do not
    fit shared memory (rows x a row's words); 0 when all fit.  The merges
    run one after another, so they share it."""
    return max([rows * (words * entries + extra // 4)
                for rows, entries, words, extra in merge_rows(p).values()
                if not merge_in_shared(entries, words, extra, optin)],
               default=0)


class WorkspaceBatch(NamedTuple):
    """The workspaces of S scenarios: each field of each workspace is a
    row of one ``[S, ...]`` tensor, so the S live flags are read in one
    copy (``ctl``, ``[S, 4]``) and the S exchange scratches cleared in one
    memset."""

    ctl: torch.Tensor
    rows: list


def make_workspaces(p: LaneParams, device, count: int = 1) -> WorkspaceBatch:
    """``count`` workspaces for runs of these shapes, their ``ctl`` armed
    (``live`` = 1 until kernel C decides); on a card, the device's opt-in
    shared memory sizes the merges' global scratch."""
    pl = p.lane
    n, k = p.n_lanes, p.pops_per_iter
    n_rec = p.n_records if p.log_capacity else 1
    n_fl = p.flow_offsets.end if p.flowtrace else 1
    n_eg = max(p.egress_slots, 1)
    scratch = 0
    if torch.device(device).type == "cuda":
        from . import kernels
        scratch = merge_scratch_words(p, kernels.smem_optin(device))

    def z(*shape, dtype=i32):
        return torch.zeros((count, *shape), dtype=dtype, device=device)

    ctl = z(4)
    ctl[:, 0] = 1
    batch = Workspace(
        ctl=ctl, self_blk=z(pl.words, n, pl.self_width), out_blk=z(6, k, n),
        sx_blk=z(8, max(pl.stream_entries, 1)),
        recs=z(n_rec, 6, dtype=i64), rec_valid=z(n_rec),
        x_cnt=z(n), x_start=z(n), x_fill=z(n),
        x_order=z(pl.exchange_entries), x_done=z(1),
        tier_blk=z(7, max(p.tier_layout[-1], 1)),
        fl_recs=z(n_fl, FLOW_REC_WORDS), fl_valid=z(n_fl),
        m_scratch=z(scratch),
        eg_recs=z(n_eg, 6, dtype=i64), eg_valid=z(n_eg),
        hyb=z(p.hyb_words, dtype=i64), ext=z(max(p.ext_slots, 1), dtype=i64),
        fz=z(3),
    )
    return WorkspaceBatch(ctl, [Workspace(*(t[i] for t in batch))
                                for i in range(count)])


def make_workspace(p: LaneParams, device) -> Workspace:
    """One run's workspace (a batch of one)."""
    return make_workspaces(p, device).rows[0]


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
# ... and with netobs, its counters
_NB_FIELDS = ("nb_txb", "nb_rxb", "nb_thr")


def rand_u32_lane(seed: int, stream, counter32):
    """The lane engine's threefry draw (``core.rng.rand_u32`` with counter
    word ``c1 = 0``): bit-identical to it for counters below 2**32.  The
    reference's ``_seed_keys`` reduces to the static seed here (the port
    has no sweep path that traces seeds)."""
    s_lo, s_hi = rng_mod.split_seed(seed)
    return rng_mod.rand_u32_words(s_lo, s_hi, stream, counter32)


# the flow hash's multipliers (obs.flowtrace.flow_hash)
_FH_SRC, _FH_DST, _FH_SEED = 2654435761, 2246822519, 668265263
_M32 = 0xFFFFFFFF


def _mul32(h, m: int):
    """``(h * m) mod 2**32`` for int64 ``h`` in [0, 2**32), by 16-bit
    halves so that no product leaves int64."""
    return (((((h >> 16) * m) & 0xFFFF) << 16) + (h & 0xFFFF) * m) & _M32


def flow_hash_lane(src, dst, seed: int):
    """The flow hash of ``(src, dst)`` under ``seed`` (the reference's
    ``flow_hash_lane``, ``obs.flowtrace.flow_hash`` with fid 0): its u32
    value in int64, since PyTorch on the CPU has no uint32 ``*``, ``>>`` or
    ``<``."""
    h = (torch.as_tensor(src).to(i64) * _FH_SRC
         + torch.as_tensor(dst).to(i64) * _FH_DST
         + ((seed * _FH_SEED) & _M32)) & _M32
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def _flow_sampled(p: LaneParams, src, dst):
    """Bool, the broadcast shape of ``src`` and ``dst``: the flow records
    its lifecycle events (every flow at sample 1, none at 0 — no hash
    evaluated in either case)."""
    shape = torch.broadcast_shapes(src.shape, dst.shape)
    if p.flow_all or p.flow_thresh == 0:
        return torch.full(shape, p.flow_all, dtype=torch.bool,
                          device=src.device)
    return flow_hash_lane(src, dst, p.flow_seed) < p.flow_thresh


def _put_flows(ws, base: int, valid, *cols) -> None:
    """Flow records of the valid entries at ``base + entry`` (``valid`` and
    each column flat over the group's entries, or scalars): columns t_hi,
    t_lo, kind, src, dst, seq, size, aux.  The group's flags must be 0
    already; only the valid entries are written."""
    valid = valid.reshape(-1)
    rows = torch.nonzero(valid).flatten()
    if rows.numel() == 0:
        return
    rec = torch.stack([torch.as_tensor(c, dtype=i32, device=valid.device)
                       .reshape(-1).expand(valid.shape)[rows] for c in cols],
                      dim=1)
    ws.fl_recs[base + rows] = rec
    ws.fl_valid[base + rows] = 1


def _send_flows(smp, t, dep, lost, arr, ends):
    """A send's four flow groups (the reference's ``iter_body`` group
    build): the send or retransmit at the stimulus time ``t``, the up
    bucket's wait at the departure, the loss at ``t``, the queue entry at
    the arrival; ``smp`` the sent entries of sampled flows, ``t``, ``dep``
    and ``arr`` (hi, lo) pairs, ``ends`` (kind of the first group, src,
    dst, seq, size).  Returns the groups as ``_put_flows`` arguments."""
    kind, *who = ends
    wait = (dep[0] != t[0]) | (dep[1] != t[1])
    return [(smp, *t, kind, *who, 0),
            (smp & wait, *dep, ftr.FT_TB_WAIT, *who, ftr.TB_UP),
            (smp & lost, *t, ftr.FT_DROP, *who, ftr.CAUSE_LOSS),
            (smp & ~lost, *arr, ftr.FT_QUEUE_ENTER, *who, 0)]


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
    model); ``v`` holds the [N] state vectors (the netobs counters too,
    when on) and ``min_used_lat``, and the law rebinds its entries to new
    tensors (it never writes into them).  ``lw`` holds per-lane constants
    of the iteration (``passive``, the lanes' PACKET and LOCAL key words).
    Returns the column's DELIVERY-insert, re-arm, outbound and record
    channels, its pcap channel, valid flags and records (``None`` unless
    a lane captures and the log is on: a PCAP_TX record per capturing
    lane's send, at its departure, before the loss draw), and with
    flowtrace its seven flow groups (``_put_flows`` arguments; ``None``
    when off), and on a hybrid run its egress candidates (flags and rows;
    ``None`` otherwise).  Mirrors the reference's ``_process_slot`` for the ported
    models."""
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
         v["dn_ld_lo"], td_hi, td_lo, dn_wait) = bucket_charge_vec(
            v["dn_tokens"], v["dn_nr_hi"], v["dn_nr_lo"], v["dn_ld_hi"],
            v["dn_ld_lo"], tb.dn_rate, tb.dn_burst, tb.dn_kfull, tb.dn_kfi,
            thi, tlo, bits, is_pkt, interval,
        )
        if p.netobs:
            v["nb_thr"] = v["nb_thr"] + dn_wait
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
    if p.netobs:
        v["nb_rxb"] = v["nb_rxb"] + torch.where(deliver, size, 0)
    # passive lanes consume the delivery inline: each counting app on the
    # host adds the size (recv_mult apps; 0 on empty hosts).  Active lanes
    # get a DELIVERY self-insert keyed by the packet's (src, seq).  EXTERNAL
    # lanes (the hybrid backend) do neither: the packet's outcome, CoDel
    # drops too, leaves through the egress buffer, and the host side queues
    # the delivery (or applies the same passive elision) at t_deliver
    inline = passive
    eg = None
    if p.external_any:
        ext = tb.lane_external
        inline = passive & ~ext
        eg_valid = is_pkt & ext
        eg = eg_valid, _rec_rows(eg_valid, t_join(td_hi, td_lo), src, lanes,
                                 seq, size, torch.where(codel_drop, DROP_CODEL,
                                                        DELIVERED))
    v["recv_bytes"] = v["recv_bytes"] + torch.where(
        deliver & inline, size * tb.recv_mult, 0)
    ins = None  # a passive-only run has no insert channel
    if not p.all_passive:
        ins_valid = deliver & ~passive
        if p.external_any:
            ins_valid = ins_valid & ~tb.lane_external
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
         v["up_ld_lo"], dep_hi, dep_lo, up_wait) = bucket_charge_vec(
            v["up_tokens"], v["up_nr_hi"], v["up_nr_lo"], v["up_ld_hi"],
            v["up_ld_lo"], tb.up_rate, tb.up_burst, tb.up_kfull, tb.up_kfi,
            thi, tlo, out_bits, do_send, interval,
        )
        if p.netobs:
            v["nb_thr"] = v["nb_thr"] + up_wait
            v["nb_txb"] = v["nb_txb"] + torch.where(do_send, out_size, 0)
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
    pc = None
    if p.pcap_any and p.log_capacity:
        pc_valid = do_send & tb.lane_pcap
        pc = pc_valid, _rec_rows(pc_valid, t_join(dep_hi, dep_lo), lanes, dst,
                                 snd_seq, out_size, PCAP_TX)
    ft = None
    if p.flowtrace:
        # sends (lane -> dst), then packet arrivals (src -> lane): the down
        # bucket's wait, the CoDel drop or the delivery, at the departure
        ft = _send_flows(do_send & _flow_sampled(p, lanes, dst), (thi, tlo),
                         (dep_hi, dep_lo), lost, (arr_hi, arr_lo),
                         (ftr.FT_SEND, lanes, dst, snd_seq, out_size))
        ar = is_pkt & _flow_sampled(p, src, lanes)
        ar_wait = (td_hi != thi) | (td_lo != tlo)
        arv = (src, lanes, seq, size)
        ft += [(ar & ar_wait, td_hi, td_lo, ftr.FT_TB_WAIT, *arv, ftr.TB_DN),
               (ar & codel_drop, td_hi, td_lo, ftr.FT_DROP, *arv,
                ftr.CAUSE_CODEL),
               (ar & ~codel_drop, td_hi, td_lo, ftr.FT_DELIVERY, *arv, 0)]
    return ins, arm, out, rec, rec_valid, pc, ft, eg


class StreamSends(NamedTuple):
    """One stimulus's control send and RTO arm per endpoint row, as
    ``_stream_stimulus`` hands them to its caller (the burst goes to the
    caller's sink unit by unit)."""
    send: torch.Tensor  # the control send was made
    retx: torch.Tensor  # ... as a retransmission
    lost: torch.Tensor  # ... and lost at its draw
    thi: torch.Tensor  # its arrival (after the window end)
    tlo: torch.Tensor
    seq: torch.Tensor  # its send sequence number
    size: torch.Tensor
    phi: torch.Tensor  # its payload words
    plo: torch.Tensor
    dep: torch.Tensor  # its departure (int64), where pcap captures it
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
    ``n_loss``, ``min_lat`` (a scalar) and with netobs ``txb`` and ``thr``
    (bytes sent, charges that waited), rebound here.  Burst unit ``u``
    goes to ``burst_out(u, valid, lost, thi, tlo, seq, size, phi, plo,
    dep, retx)`` over the client half (``dep``: its departure, int64;
    ``retx``: the unit is a retransmission).  Returns the flows and the
    :class:`StreamSends`."""
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
    *up, dep_hi, dep_lo, waited = bucket_charge_vec(
        *ctr["up"], tb.flow_up_rate, tb.flow_up_burst, tb.flow_up_kfull,
        tb.flow_up_kfi, sh, sl, (sem.send_size + FRAME_OVERHEAD_BYTES) * 8,
        st_send, interval)
    if p.netobs:
        ctr["thr"] = ctr["thr"] + waited
        ctr["txb"] = ctr["txb"] + torch.where(st_send, sem.send_size, 0)
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
    valid_b, flags_b, units_b, acks_b, sizes_b, retx_b = burst
    up_c = [t[cl] for t in up]
    nloss = ctr["n_loss"] + se_lost
    nloss_c = nloss[cl]
    sent = st_send[cl].to(i32)
    sent0 = sent
    lat_c = tb.flow_lat[cl]
    if p.netobs:
        thr_c, txb_c = ctr["thr"][cl], ctr["txb"][cl]
    for u in range(PUMP_BURST):
        bm = valid_b[u, cl]
        if not bool(bm.any()):
            break  # the burst is a prefix: no later unit is valid
        bsize = sizes_b[u, cl]
        bbits = (bsize + FRAME_OVERHEAD_BYTES) * 8
        if u == 0:
            *up_c, bdh, bdl, bwaited = bucket_charge_vec(
                *up_c, tb.flow_up_rate[cl], tb.flow_up_burst[cl],
                tb.flow_up_kfull[cl], tb.flow_up_kfi[cl], sh[cl], sl[cl],
                bbits, bm, interval)
        else:
            *up_c, bdh, bdl, bwaited = bucket_charge_chained_vec(
                *up_c, tb.flow_up_rate[cl], tb.flow_up_burst[cl], bbits, bm,
                interval, sh[cl], sl[cl])
        if p.netobs:
            thr_c = thr_c + bwaited
            txb_c = txb_c + torch.where(bm, bsize, 0)
        bseq = se_seq[cl] + sent
        blost = draw_lost(cl, bseq, bm & past_bs[cl])
        nloss_c = nloss_c + blost
        lat_min(bm, lat_c)
        bthi, btlo = pair_max(*pair_add32(bdh, bdl, lat_c), we_hi, we_lo)
        burst_out(u, bm & ~blost, blost, bthi, btlo, bseq, bsize,
                  *lstr.pack_pay(flags_b[u, cl], units_b[u, cl],
                                 acks_b[u, cl]), t_join(bdh, bdl),
                  retx_b[u, cl])
        sent = sent + bm
    ctr["up"] = [torch.cat([c, t[sf:]]) for c, t in zip(up_c, up)]
    ctr["n_loss"] = torch.cat([nloss_c, nloss[sf:]])
    if p.netobs:
        ctr["thr"] = torch.cat([thr_c, ctr["thr"][sf:]])
        ctr["txb"] = torch.cat([txb_c, ctr["txb"][sf:]])
    sends = st_send.to(i32) + torch.cat([sent - sent0, torch.zeros_like(sent)])
    ctr["send_seq"] = ctr["send_seq"] + sends
    ctr["n_sends"] = ctr["n_sends"] + sends
    return f, StreamSends(
        st_send, sem.send_retx & st_send, se_lost, se_thi, se_tlo, se_seq,
        sem.send_size,
        *lstr.pack_pay(sem.send_flags, sem.send_seq, sem.send_ack),
        t_join(dep_hi, dep_lo), st_rto, sem.rto_thi, sem.rto_tlo, lseq)


_UP_FIELDS = ("up_tokens", "up_nr_hi", "up_nr_lo", "up_ld_hi", "up_ld_lo")
_SEND_FIELDS = ("send_seq", "local_seq", "n_sends", "n_loss")


def _stream_slot(p: LaneParams, tb: LaneTables, v: dict, col: dict,
                 we_hi, we_lo, ws: Workspace, j: int) -> None:
    """The stream arm of the slot law on popped column ``j`` (the
    reference's ``_process_slot`` stream tier and compacted send/arm
    channels): each endpoint row sees its lane's popped event and runs
    ``_stream_stimulus`` on the endpoint lane's up bucket and counters (a
    segment stimulates a server row only from its own client).  Writes the
    stream block's entries of slot ``j``, the stream loss records, with
    ``stream_pcap`` the capturing rows' PCAP_TX records and with flowtrace
    the sampled rows' flow groups into ``ws``; lane counters (the netobs
    ones too) and flow rows change in ``v``.
    Rows with no stimulus change nothing and emit nothing."""
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
    if p.netobs:
        ctr["txb"], ctr["thr"] = v["nb_txb"][el], v["nb_thr"][el]
    sx = ws.sx_blk
    k = p.pops_per_iter
    t64 = t_join(ethi, etlo)
    pkt_auxh = pack_aux_hi(PACKET, tb.flow_lanes)
    cl = slice(0, sf)
    rg = p.rec_offsets
    log_pc = p.log_capacity and p.stream_pcap
    fg = p.flow_offsets
    if p.flowtrace:
        smp = _flow_sampled(p, tb.flow_lanes, tb.flow_peers)

    def burst_out(u, valid, lost, thi, tlo, seq, size, phi, plo, dep, retx):
        slot = j * PUMP_BURST + u
        if p.flowtrace:  # the burst's groups [K, B, S]: slot-major
            gw = k * PUMP_BURST * sf
            kind = torch.where(retx, ftr.FT_RETRANSMIT, ftr.FT_SEND)
            for g, grp in enumerate(_send_flows(
                    (valid | lost) & smp[cl], (ethi[cl], etlo[cl]),
                    t_split(dep), lost, (thi, tlo),
                    (kind, tb.flow_lanes[cl], tb.flow_peers[cl], seq, size))):
                _put_flows(ws, fg.bs + g * gw + slot * sf, *grp)
        _put_entries(sx, 4 * k * sf + slot * sf, valid, tb.flow_peers[cl],
                     thi, tlo, pkt_auxh[cl], seq, size, phi, plo)
        if p.log_capacity:
            _put_recs(ws, rg.brec + slot * sf, lost, t64[cl],
                      tb.flow_lanes[cl], tb.flow_peers[cl], seq, size,
                      DROP_LOSS)
        if log_pc:  # captured at departure, before the loss draw
            _put_recs(ws, rg.bpc + slot * sf, (valid | lost) & tb.flow_pcap[cl],
                      dep, tb.flow_lanes[cl], tb.flow_peers[cl], seq, size,
                      PCAP_TX)

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
        _put_recs(ws, rg.srec + j * s2, se.lost, t64, tb.flow_lanes,
                  tb.flow_peers, se.seq, se.size, DROP_LOSS)
    if log_pc:
        _put_recs(ws, rg.spc + j * s2, se.send & tb.flow_pcap, se.dep,
                  tb.flow_lanes, tb.flow_peers, se.seq, se.size, PCAP_TX)
    if p.flowtrace:  # the control sends' groups [K, 2S]
        kind = torch.where(se.retx, ftr.FT_RETRANSMIT, ftr.FT_SEND)
        for g, grp in enumerate(_send_flows(
                se.send & smp, (ethi, etlo), t_split(se.dep), se.lost,
                (se.thi, se.tlo),
                (kind, tb.flow_lanes, tb.flow_peers, se.seq, se.size))):
            _put_flows(ws, fg.ss + g * k * s2 + j * s2, *grp)
    # write-back, at the stimulated rows' lanes
    rows = torch.nonzero(stim).flatten()
    nb = (("nb_txb", ctr["txb"]), ("nb_thr", ctr["thr"])) if p.netobs else ()
    for f_, t in (*zip(_UP_FIELDS, ctr["up"]),
                  *((f_, ctr[f_]) for f_ in _SEND_FIELDS), *nb):
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


def _rec_rows(valid, *cols):
    """[R, 6] int64 log records (columns time, src, dst, seq, size,
    outcome: tensors over the R rows, or scalars), zero where not
    valid."""
    rec = torch.stack([torch.as_tensor(c, dtype=i64, device=valid.device)
                       .expand(valid.shape) for c in cols], dim=1)
    return torch.where(valid[:, None], rec, 0)


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
    the self, outbound, stream and record blocks go to ``ws``, with
    flowtrace the flow groups of A's part of the flow buffer, on a hybrid
    run the egress candidates of the external lanes.  With netobs,
    the popped PACKETs join the window's count.  On a tiered run the lanes
    run without the stream models."""
    if not int(ws.ctl[0]):
        return
    rg = p.rec_offsets
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
    if p.netobs:
        s.nb_win.add_((act & (kind == PACKET)).sum(dtype=i32))
    # the slot law rebinds v's entries to new tensors; the state's own
    # tensors are written once, at the end
    v = {f: getattr(s, f) for f in _SLOT_FIELDS + ("min_used_lat",)
         + (_NB_FIELDS if p.netobs else ())}
    if p.stream_present:
        v["stream"] = s.stream
        for w, val in enumerate(_empty_entries(n)):
            ws.sx_blk[w] = val
        if p.log_capacity:
            ws.recs[rg.spc:rg.end] = 0
            ws.rec_valid[rg.spc:rg.end] = 0
    fg = p.flow_offsets
    if p.flowtrace:
        ws.fl_valid[fg.slots:fg.end] = 0
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
        if p.external_any:
            ws.eg_valid[j * n:(j + 1) * n] = 0
            ws.eg_recs[j * n:(j + 1) * n] = 0
        if p.log_capacity:
            for r0 in (rg.slots, rg.pc)[:2 if p.pcap_any else 1]:
                ws.recs[r0 + j * n: r0 + (j + 1) * n] = 0
                ws.rec_valid[r0 + j * n: r0 + (j + 1) * n] = 0
    for j in range(n_live):
        col = {
            "thi": thi[:, j], "tlo": tlo[:, j], "kind": kind[:, j],
            "src": src[:, j], "seq": s.q_auxl[:, j], "size": s.q_size[:, j],
            "act": act[:, j],
        }
        if p.stream_present:
            col["phi"], col["plo"] = s.q_phi[:, j], s.q_plo[:, j]
        ins, arm, out, rec, rec_valid, pc, ft, eg = _process_slot(
            p, tb, v, col, s.now_we_hi, s.now_we_lo, lanes, lw)
        if eg is not None:
            ws.eg_valid[j * n:(j + 1) * n] = eg[0].to(i32)
            ws.eg_recs[j * n:(j + 1) * n] = eg[1]
        for g, grp in enumerate(ft or ()):  # the [N] groups, [K, N] each
            _put_flows(ws, fg.slots + (g * k + j) * n, *grp)
        for w in range(p.words):
            if not p.all_passive:
                ws.self_blk[w, :, j] = ins[w]
            ws.self_blk[w, :, arm0 + j] = arm[w]
        for w in range(6):
            ws.out_blk[w, j] = out[w]
        if p.log_capacity:
            rows = slice(rg.slots + j * n, rg.slots + (j + 1) * n)
            ws.recs[rows] = rec
            ws.rec_valid[rows] = rec_valid.to(i32)
        if pc is not None:
            rows = slice(rg.pc + j * n, rg.pc + (j + 1) * n)
            ws.rec_valid[rows] = pc[0].to(i32)
            ws.recs[rows] = pc[1]
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
                lane_of_row, fl_base: int):
    """The keyed row merge: each row of ``[q_rows | cand]`` (lists of
    ``p.words`` word tensors) sorted by the event key, ties in index
    order; the first C are returned as the new queue rows, and the real
    events past column C are counted per row and, when logging, recorded
    as DROP_QUEUE at ``rec_base`` (row-major); with flowtrace, the PACKETs
    among them of sampled flows become FT_DROP (CAUSE_QUEUE) flow records
    at ``fl_base``, at their pair times.  ``lane_of_row`` gives each row's
    lane for the records."""
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
    if p.flowtrace:
        kind, t_src = unpack_aux_hi(tail[2])
        lane = lane_of_row.to(i32)[:, None].expand_as(t_src)
        shed = tail_valid & (kind == PACKET) & _flow_sampled(p, t_src, lane)
        ws.fl_valid[fl_base: fl_base + shed.numel()] = 0
        _put_flows(ws, fl_base, shed, tail[0], tail[1], ftr.FT_DROP, t_src,
                   lane, tail[3], tail[4], ftr.CAUSE_QUEUE)
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
    logging; with flowtrace, FT_DROP flow records of the sampled flows'
    PACKETs).  Stream configs carry the payload words through it all.
    With netobs, the cross-block sheds are also counted apart
    (``nb_shed``).

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
    rows, n_tail = _merge_rows(p, q, cand, ws, 0, lanes_, 0)
    for w in range(p.words):
        q[w].copy_(rows[w])
    s.n_queue.add_(n_tail + lost_pre)
    if p.netobs:
        s.nb_shed.add_(lost_pre)
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
    C counted into ``n_queue`` and recorded as DROP_QUEUE (with flowtrace,
    the sampled flows' PACKETs as FT_DROP flow records too)."""
    if not int(ws.ctl[0]):
        return
    el = tb.flow_lanes.long()
    q = _queue_words(p, s)
    rows, n_tail = _merge_rows(
        p, [w[el] for w in q], _stream_candidates(p, tb, ws), ws,
        p.rec_offsets[0], el, p.flow_offsets.split)
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
    block (``tier_layout``), the records to the tier's record groups (with
    ``stream_pcap``, the capturing rows' sends as PCAP_TX records at their
    departure); the flows, the tier vectors (the TV_NB_* rows with netobs)
    and the popped queue slots change in place, and with netobs the popped
    PACKETs join the window's count."""
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
    tg = p.tier_rec_offsets
    log_on = bool(p.log_capacity)
    log_pc = log_on and p.stream_pcap
    if log_on:
        ws.recs[tg.rec:tg.tail] = 0
        ws.rec_valid[tg.rec:tg.tail] = 0

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
    if p.netobs:
        s.nb_win.add_((act_b & (kind_b == PACKET)).sum(dtype=i32))
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
         dn_wait) = bucket_charge_vec(
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
        if p.netobs:
            vr[lstr.TV_NB_RXB] = vr[lstr.TV_NB_RXB] + torch.where(
                deliver, size, 0)
            vr[lstr.TV_NB_THR] = vr[lstr.TV_NB_THR] + dn_wait
        if log_on:
            _put_recs(ws, tg.rec + j * s2, is_pkt, t_join(td_hi, td_lo), src,
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
               "min_lat": mul, "txb": vr[lstr.TV_NB_TXB],
               "thr": vr[lstr.TV_NB_THR]}
        st64 = t_join(sh, sl)

        def burst_out(u, valid, lost, bthi, btlo, seq, bsize, bphi, bplo,
                      dep, _retx):
            slot = j * PUMP_BURST + u
            _put_entries(blk, bo0 + slot * sf, valid, bthi, btlo,
                         pkt_auxh[cl], seq, bsize, bphi, bplo)
            if log_on:
                _put_recs(ws, tg.brec + slot * sf, lost, st64[cl], el[cl],
                          peers[cl], seq, bsize, DROP_LOSS)
            if log_pc:  # captured at departure, before the loss draw
                _put_recs(ws, tg.bpc + slot * sf,
                          (valid | lost) & tb.flow_pcap[cl], dep, el[cl],
                          peers[cl], seq, bsize, PCAP_TX)

        f, se = _stream_stimulus(p, tb, f, (stim_open, stim_rto, stim_seg),
                                 sh, sl, phi, plo, size, ctr, we_hi, we_lo,
                                 burst_out)
        vr[lstr.TV_UP_TOK:lstr.TV_UP_LDL + 1] = ctr["up"]
        for r, key in ((lstr.TV_SEND_SEQ, "send_seq"),
                       (lstr.TV_LOCAL_SEQ, "local_seq"),
                       (lstr.TV_N_SENDS, "n_sends"),
                       (lstr.TV_N_LOSS, "n_loss"),
                       (lstr.TV_NB_TXB, "txb"), (lstr.TV_NB_THR, "thr")):
            vr[r] = ctr[key]
        mul = ctr["min_lat"]
        _put_entries(blk, se0 + j * s2, se.send & ~se.lost, se.thi, se.tlo,
                     pkt_auxh, se.seq, se.size, se.phi, se.plo)
        if log_on:
            _put_recs(ws, tg.srec + j * s2, se.lost, st64, el, peers, se.seq,
                      se.size, DROP_LOSS)
        if log_pc:
            _put_recs(ws, tg.spc + j * s2, se.send & tb.flow_pcap, se.dep, el,
                      peers, se.seq, se.size, PCAP_TX)
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
        tg = p.tier_rec_offsets
        r0, r1 = tg.tail, tg.end
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


def ilog2_i32(x):
    """floor(log2(x)) of an int32 tensor x >= 1, branch-free (0 for x <=
    1): the reference's ``ilog2_i32``."""
    r = torch.zeros_like(x)
    for shift in (16, 8, 4, 2, 1):
        ge = x >= (1 << shift)
        x = torch.where(ge, x >> shift, x)
        r = r + torch.where(ge, shift, 0)
    return r


def flush_hist(s: LaneState, enable) -> None:
    """Fold the finished window's packet count into the netobs histogram
    (bucket floor(log2), the last bucket open-ended) and reset it, where
    ``enable`` and the count is positive: packet-free windows are skipped,
    as in the reference's ``_flush_hist``.  In place."""
    do = enable & (s.nb_win > 0)
    bucket = torch.clamp(ilog2_i32(s.nb_win), max=NB_HIST_BUCKETS - 1)
    s.nb_hist.index_add_(0, bucket.long().reshape(1), do.to(i32).reshape(1))
    s.nb_win.copy_(torch.where(do, 0, s.nb_win))


class HybridTurn(NamedTuple):
    """What a hybrid turn's window law takes from the host (kernel C's
    parameters in its hybrid mode): the host side's next event time as a
    pair (NEVER32, NEVER32 when none), its smallest used latency (NEVER32
    when none), and whether this is the turn's first step."""
    ext_hi: int
    ext_lo: int
    ext_used: int
    first: bool


# indices into the turn's packed readback (Workspace.hyb; the reference's
# HYB_* of make_hybrid_fn)
HYB_LANE_MIN = 0
HYB_DEV_WE = 1
HYB_MIN_USED = 2
HYB_EGRESS_COUNT = 3
HYB_EGRESS_LOST = 4
# the fused law's readback (the reference's make_hybrid_fused_fn layout):
# the slots above, the consumed-window count, the consumed window ends at
# HYB_WE_BASE + i; the port adds one slot after the k_cap ends, the
# dispatch's live steps (the driver sizes its next first chunk by it)
HYB_K_DONE = 5
HYB_WE_BASE = 6


def hybrid_window_plain(p: LaneParams, s: LaneState, ws: Workspace,
                        turn: HybridTurn) -> None:
    """Kernel C's hybrid mode, plain (the reference's ``_build_hybrid_run``
    loop: its ``cond`` and the window law of its ``body``).  The turn's
    first step resets the egress count, losses and min (the host consumed
    the last turn's rows), folds the host side's used latency into
    ``min_used_lat`` (dynamic runahead) and arms the turn.  Each step then
    evaluates the reference's stop condition on the state as it stands:
    room in the egress buffer for one more iteration, and either a lane
    head inside the current window or a fresh window the host does not
    take part in in the current one — where ``ext_bound = min(the host's
    next event, the earliest egressed delivery)`` joins the lane heads in
    the global min.  When it holds, the window law opens the next window
    at the global min (a round) as the device loop does; when it fails,
    the turn stops: ``live`` goes to 0, so the rest of the steps leave
    every word alone, and the packed readback is written."""
    if turn.first:
        ws.ctl[0] = 1
        if p.dynamic_runahead:
            s.min_used_lat.clamp_(max=turn.ext_used)
        s.egress_count.zero_()
        s.egress_lost.zero_()
        s.egress_min_hi.fill_(NEVER32)
        s.egress_min_lo.fill_(NEVER32)
        ws.hyb[HYB_DEV_WE] = -1
    if not int(ws.ctl[0]):
        return
    mh, ml = _pairs.pair_min_lanes(s.q_thi[:, 0], s.q_tlo[:, 0])
    eh = torch.tensor(turn.ext_hi, dtype=i32, device=mh.device)
    el = torch.tensor(turn.ext_lo, dtype=i32, device=mh.device)
    lt = pair_lt(eh, el, s.egress_min_hi, s.egress_min_lo)
    bh = torch.where(lt, eh, s.egress_min_hi)
    bl = torch.where(lt, el, s.egress_min_lo)
    stop_hi, stop_lo = p.stop_time >> 31, p.stop_time & MASK31
    in_window = pair_lt(mh, ml, s.now_we_hi, s.now_we_lo)
    host_in = pair_lt(bh, bl, s.now_we_hi, s.now_we_lo)
    nh, nl = pair_sel(pair_lt(mh, ml, bh, bl), mh, ml, bh, bl)
    fresh_ok = ~host_in & pair_lt(nh, nl, stop_hi, stop_lo)
    room = s.egress_count < p.egress_capacity - p.ext_per_iter
    if not bool(room & (in_window | fresh_ok)):
        ws.ctl.copy_(torch.stack([torch.zeros_like(mh), torch.zeros_like(mh),
                                  mh, ml]))
        used = s.min_used_lat if p.dynamic_runahead else torch.tensor(
            NEVER32, dtype=i32)
        ws.hyb.copy_(torch.stack([
            t_join(mh, ml), t_join(s.now_we_hi, s.now_we_lo),
            used.to(i64).to(mh.device), s.egress_count.to(i64),
            s.egress_lost.to(i64)]))
        return
    live = pair_lt(nh, nl, stop_hi, stop_lo)
    fresh = pair_ge(nh, nl, s.now_we_hi, s.now_we_lo) & live
    if p.netobs:
        flush_hist(s, fresh)
    stop_t = torch.tensor([stop_hi, stop_lo], dtype=i32, device=mh.device)
    c_hi, c_lo = pair_sel(live, nh, nl, stop_t[0], stop_t[1])
    c_hi, c_lo = pair_add32(c_hi, c_lo, effective_runahead(p, s.min_used_lat))
    c_hi, c_lo = pair_sel(pair_lt(c_hi, c_lo, stop_hi, stop_lo),
                          c_hi, c_lo, stop_t[0], stop_t[1])
    s.now_we_hi.copy_(torch.where(fresh, c_hi, s.now_we_hi))
    s.now_we_lo.copy_(torch.where(fresh, c_lo, s.now_we_lo))
    s.rounds.add_(fresh.to(i32))
    ws.ctl.copy_(torch.stack([torch.ones_like(mh), in_window.to(i32), mh, ml]))


class FusedTurn(NamedTuple):
    """What a fused hybrid dispatch's window law takes from the host
    beside its schedule (``Workspace.ext``): the host side's smallest used
    latency (NEVER32 when none), the windows it may consume (``k_eff``, at
    most ``LaneParams.hybrid_k_cap``), and whether this is the dispatch's
    first step."""
    ext_used: int
    k_eff: int
    first: bool


def _hyb_stop(p: LaneParams, s: LaneState, ws: Workspace, m: int) -> None:
    """The end of a fused dispatch: ``live`` 0 and the packed readback."""
    ws.ctl[0] = 0
    ws.ctl[1] = 0
    used = int(s.min_used_lat) if p.dynamic_runahead else NEVER32
    ws.hyb[:HYB_WE_BASE] = torch.tensor(
        [m, int(t_join(s.now_we_hi, s.now_we_lo)), used,
         int(s.egress_count), int(s.egress_lost), int(ws.fz[1])],
        dtype=i64)
    ws.hyb[-1] = ws.fz[2]


def egress_refold(p: LaneParams, s: LaneState, thr: int) -> int:
    """The earliest DELIVERED egress time at or past ``thr`` among this
    dispatch's rows (NEVER when none): the rows below it were applied on
    the host with their windows (the reference's ``egress_refold``)."""
    rows = s.egress[:min(int(s.egress_count), p.egress_capacity)]
    live = (rows[:, 5] == DELIVERED) & (rows[:, 0] >= thr)
    return int(rows[live, 0].min()) if bool(live.any()) else NEVER


def hybrid_fused_window_plain(p: LaneParams, s: LaneState, ws: Workspace,
                              turn: FusedTurn) -> None:
    """Kernel C's fused mode, plain (the reference's
    ``_build_hybrid_fused_run``: its two nested loops as one step).  The
    first step resets the egress and the readback, folds ``ext_used`` in
    and arms the dispatch (schedule pointer and window count 0).  Each step
    then evaluates the one-window law's stop condition against the
    schedule slot ``e = ext[min(ptr, slots - 1)]``.  When it holds, the
    window law runs (A, B and D iterate after it).  When it fails, the
    segment ends as the reference's ``seg_body`` ends one: the window the
    host joins below the horizon (the last slot) is consumed — its end
    recorded, the pointer moved past every slot before it, ``egress_min``
    re-armed from the rows at or past it — and, while fewer than ``k_eff``
    windows are consumed, the condition is tried again on the new slot in
    the same step; otherwise the dispatch stops (``live`` 0) and writes the
    ``[6 + k_cap + 1]`` readback.  At most ``k_eff + 1`` passes a step."""
    if turn.first:
        ws.ctl[0] = 1
        if p.dynamic_runahead:
            s.min_used_lat.clamp_(max=turn.ext_used)
        s.egress_count.zero_()
        s.egress_lost.zero_()
        s.egress_min_hi.fill_(NEVER32)
        s.egress_min_lo.fill_(NEVER32)
        ws.hyb.zero_()
        ws.hyb[HYB_DEV_WE] = -1
        ws.fz.zero_()
    if not int(ws.ctl[0]):
        return
    mh, ml = _pairs.pair_min_lanes(s.q_thi[:, 0], s.q_tlo[:, 0])
    m = int(t_join(mh, ml))
    ws.ctl[2] = mh
    ws.ctl[3] = ml
    ws.fz[2] += 1
    ext = ws.ext.tolist()
    slots, horizon = p.ext_slots, ext[p.ext_slots - 1]
    stop = p.stop_time
    while True:
        we = int(t_join(s.now_we_hi, s.now_we_lo))
        e = ext[min(int(ws.fz[0]), slots - 1)]
        bound = min(e, int(t_join(s.egress_min_hi, s.egress_min_lo)))
        in_window = m < we
        host_in = bound < we
        nxt = min(m, bound)
        room = int(s.egress_count) < p.egress_capacity - p.ext_per_iter
        if room and (in_window or (not host_in and nxt < stop)):
            if nxt >= we:  # a fresh window (nxt < stop: the turn is live)
                if p.netobs:
                    flush_hist(s, torch.tensor(True))
                end = min(nxt + int(effective_runahead(p, s.min_used_lat)),
                          stop)
                s.now_we_hi.fill_(end >> 31)
                s.now_we_lo.fill_(end & MASK31)
                s.rounds.add_(1)
            ws.ctl[0] = 1
            ws.ctl[1] = int(in_window)
            return
        if not (host_in and room and not in_window and bound < horizon):
            _hyb_stop(p, s, ws, m)
            return
        kd = int(ws.fz[1])
        ws.hyb[HYB_WE_BASE + min(kd, p.hybrid_k_cap - 1)] = we
        ws.fz[1] = kd + 1
        ws.fz[0] = sum(t < we for t in ext)
        ref = egress_refold(p, s, we)
        s.egress_min_hi.fill_(NEVER32 if ref == NEVER else ref >> 31)
        s.egress_min_lo.fill_(NEVER32 if ref == NEVER else ref & MASK31)
        if kd + 1 >= turn.k_eff:
            _hyb_stop(p, s, ws, m)
            return


def queue_min_window_plain(p: LaneParams, s: LaneState, ws: Workspace,
                           advance: bool) -> None:
    """Kernel C, plain: the earliest head over all queues, then the window
    law.  With ``advance``, a live step whose head lies at or past the
    window end opens the next window ``[head, min(head + runahead,
    stop))`` and counts a round; the runahead is dynamic where the
    parameters say so; with netobs the finished window's packet count goes
    into the histogram first (``flush_hist``).  On a tiered run the heads
    of the tier's endpoint rows count too.  Writes ``ctl = (live,
    in_window, head_hi, head_lo)``; a scenario that is done (``live`` 0)
    is left as it is, until the host arms it again for a new segment."""
    if not int(ws.ctl[0]):
        return
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
        if p.netobs:
            flush_hist(s, fresh)
        c_hi, c_lo = pair_add32(mh, ml, effective_runahead(p, s.min_used_lat))
        stop_t = torch.tensor([stop_hi, stop_lo], dtype=i32, device=mh.device)
        c_hi, c_lo = pair_sel(pair_lt(c_hi, c_lo, stop_hi, stop_lo),
                              c_hi, c_lo, stop_t[0], stop_t[1])
        s.now_we_hi.copy_(torch.where(fresh, c_hi, s.now_we_hi))
        s.now_we_lo.copy_(torch.where(fresh, c_lo, s.now_we_lo))
        s.rounds.add_(fresh.to(i32))
    in_window = live & pair_lt(mh, ml, s.now_we_hi, s.now_we_lo)
    ws.ctl.copy_(torch.stack([live.to(i32), in_window.to(i32), mh, ml]))


def _append_rows(valid, rows, buf, count, lost, capacity: int) -> None:
    """Append ``rows[valid]`` to ``buf`` in order from ``count``, counting
    the rows past ``capacity`` into ``lost``: the ring never wraps."""
    pos = count.to(i64) + torch.cumsum(valid.to(i64), 0) - 1
    ok = valid & (pos < capacity)
    buf[pos[ok]] = rows[ok]
    n_valid = valid.sum(dtype=i32)
    count.add_(n_valid)
    lost.add_(n_valid - ok.sum(dtype=i32))


def append_egress_plain(p: LaneParams, s: LaneState, ws: Workspace) -> None:
    """Kernel D's egress instance, plain (the reference's ``_append_egress``,
    which the slot law calls once per popped column): kernel A's egress
    candidates appended to the egress buffer in buffer order — slot by
    slot, each slot's lanes in order, as the reference's per-column cumsum
    over the lanes — from ``egress_count``, rows past E counted in
    ``egress_lost``; the earliest DELIVERED time among them lowers the
    ``egress_min`` pair (DROP_CODEL rows only release the host's parked
    payload, and do not bound the window law)."""
    valid = ws.eg_valid.bool()
    _append_rows(valid, ws.eg_recs, s.egress, s.egress_count, s.egress_lost,
                 p.egress_capacity)
    live = valid & (ws.eg_recs[:, 5] == DELIVERED)
    if bool(live.any()):
        t = int(ws.eg_recs[live, 0].min())
        if t < t_join(s.egress_min_hi, s.egress_min_lo):
            s.egress_min_hi.fill_(t >> 31)
            s.egress_min_lo.fill_(t & MASK31)


def append_log_plain(p: LaneParams, s: LaneState, ws: Workspace) -> None:
    """Kernel D, plain, in its three instances: when logging, the valid
    records of ``ws.recs`` appended to the log in buffer order (the
    reference's ``_append_log``); with flowtrace, the valid flow records
    of ``ws.fl_recs`` to the flowtrace ring, each stamped with the current
    window's end (the reference's ``_append_flow``); on a hybrid run, the
    egress candidates to the egress buffer (``append_egress_plain``).
    Rows past the end are counted as lost."""
    if not int(ws.ctl[0]):
        return
    if p.external_any:
        append_egress_plain(p, s, ws)
    if p.log_capacity:
        _append_rows(ws.rec_valid.bool(), ws.recs, s.log, s.log_count,
                     s.log_lost, p.log_capacity)
    if p.flowtrace:
        valid = ws.fl_valid.bool()
        recs = ws.fl_recs[valid]
        we = torch.stack([s.now_we_hi, s.now_we_lo]).expand(recs.shape[0], 2)
        rows = torch.cat([recs[:, :2], we, recs[:, 2:]], dim=1)
        _append_rows(torch.ones(rows.shape[0], dtype=torch.bool,
                                device=rows.device),
                     rows, s.fl_buf, s.fl_count, s.fl_lost, p.flow_capacity)


# the rows of an injection block ([INJ_WORDS, B] int32): valid, dst, and
# the entry's words thi, tlo, auxh, auxl, size (the reference's dict of [B]
# arrays, stacked)
INJ_WORDS = 7


def inject_merge_plain(p: LaneParams, tb: LaneTables, s: LaneState,
                       inj: torch.Tensor) -> None:
    """Kernel H, plain: merge one host-staged injection block into the lane
    queues (the reference's ``_inject_merge``).  ``inj`` holds B PACKET
    arrivals that the host side computed (a managed host's up bucket, loss
    draw and latency applied: the CPU engine's source half).  The valid
    rows are ranked by (dst, time, aux, index) and grouped by destination;
    each lane takes the first Cxi of its group (``inject_cap``), counting
    the rest as shed, and merges them into its queue row by the event key
    (the payload words of stream configs are zero on injected entries),
    keeping the first C; real events past C are queue overflow.  Both go
    to ``n_queue`` (strict capacity raises at collect), the sheds also to
    ``nb_shed`` with netobs.  No log record: the reference writes none
    here.  The reference sorts by destination unstably, so which rows of
    an overfull group survive is not defined there; only the counts are
    compared."""
    n, c, cxi = p.n_lanes, p.capacity, p.inject_cap
    valid = inj[0] != 0
    dst = torch.where(valid, inj[1], n).long()
    thi = torch.where(valid, inj[2], NEVER32)
    tlo = torch.where(valid, inj[3], NEVER32)
    words = (thi, tlo, inj[4], inj[5], inj[6])

    def fold(hi, lo):
        return (hi.to(i64) << 32) + (lo.to(i64) + (1 << 31))

    perm = torch.sort(fold(inj[4], inj[5]), stable=True).indices
    perm = perm[torch.sort(fold(thi, tlo)[perm], stable=True).indices]
    perm = perm[torch.sort(dst[perm], stable=True).indices]
    cnt = torch.bincount(dst, minlength=n + 1)[:n]
    start = torch.cumsum(cnt, 0) - cnt
    r = torch.arange(cxi, device=dst.device)
    in_seg = r[None, :] < cnt[:, None]
    idx = perm[torch.clamp(start[:, None] + r[None, :], max=dst.numel() - 1)]
    cross = [torch.where(in_seg, w[idx], NEVER32 if k < 2 else 0)
             for k, w in enumerate(words)]
    if p.words == 7:
        cross += [torch.zeros_like(cross[0])] * 2
    q = _queue_words(p, s)
    merged = [torch.cat([a, b], dim=1) for a, b in zip(q, cross)]
    order = _key_order(*merged[:4])
    merged = [torch.gather(m, 1, order) for m in merged]
    tail = (merged[0][:, c:] != NEVER32).sum(dim=1, dtype=i32)
    for w in range(p.words):
        q[w].copy_(merged[w][:, :c])
    lost_pre = torch.clamp(cnt - cxi, min=0).to(i32)
    s.n_queue.add_(tail + lost_pre)
    if p.netobs:
        s.nb_shed.add_(lost_pre)


# --------------------------------------------------------------------------
# drivers
# --------------------------------------------------------------------------


def _steps(args, p: LaneParams):
    """The two halves of a step over ``args`` (a LaneArgs, or the
    SweepArgs of a sweep whose scenarios share ``p``'s shapes):
    ``window(advance)``, kernel C, and ``iteration()``, kernels A, B, then
    E in untiered one-to-one stream configs or F and G on a tiered run,
    and, when logging, tracing flows or on a hybrid run, D.  On a hybrid
    run ``window`` takes the turn's ``HybridTurn`` (``FusedTurn`` on the fused
    law).  Each is one launch of each
    kernel, whatever the number of scenarios."""
    from . import kernels

    split, tiered = p.split, p.stream_tiered
    logging = bool(p.log_capacity) or p.flowtrace or p.external_any

    def window(advance: bool, turn=None) -> None:
        if turn is None:
            kernels.queue_min_window(args, advance)
        elif isinstance(turn, FusedTurn):
            kernels.hybrid_fused_window(args, turn)
        else:
            kernels.hybrid_window(args, turn)

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

    return window, iteration


def _build_iteration(p: LaneParams, tb: LaneTables, s: LaneState):
    """One iteration of the window loop and the step that precedes it
    (``_steps``), bound to this run's state and a new workspace."""
    from . import kernels

    args = kernels.LaneArgs(p, tb, s, make_workspace(p, s.q_thi.device))
    return (args.ws, *_steps(args, p))


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


# device-loop steps between two reads of the live flags
CHECK_EVERY = 32


def _build_sweep_run(ps, tbs, states):
    """The batched device loop (the reference's ``make_sweep_fn``: the
    vmapped ``_build_full_run``): S runs, scenario i with parameters
    ``ps[i]``, tables ``tbs[i]`` and state ``states[i]``, their shapes
    equal.  ``sweep_run(tables=None, stops=None)`` runs the flat loop of
    ``_build_full_run`` over all S at once — each step one launch of each
    kernel for every scenario — reading the S live flags from the device
    in one copy every ``CHECK_EVERY`` steps, until no scenario is live.
    A finished scenario is a no-op in every kernel (the per-scenario done
    mask), so each one's trajectory is its serial run's, ``iters`` and
    ``rounds`` included.  Given ``tables`` and ``stops`` (a fault
    segment's), scenario i first takes ``tables[i]`` and the stop time
    ``stops[i]`` and every scenario is armed again: kernel C re-decides
    each one's flag under its new stop.  ``sweep_run.steps`` counts the
    steps run."""
    from . import kernels

    batch = make_workspaces(ps[0], states[0].q_thi.device, len(ps))
    args = kernels.SweepArgs([
        kernels.LaneArgs(p, tb, s, ws)
        for p, tb, s, ws in zip(ps, tbs, states, batch.rows)])
    window, iteration = _steps(args, ps[0])
    live = batch.ctl[:, 0]

    def sweep_run(tables=None, stops=None) -> None:
        if stops is not None:
            args.retarget(tables, stops)
            live.fill_(1)
        while True:
            for _ in range(CHECK_EVERY):
                window(True)
                iteration()
            sweep_run.steps += CHECK_EVERY
            if not bool(live.any()):
                return

    sweep_run.steps = 0
    sweep_run.args = args
    return sweep_run


def _build_full_run(p: LaneParams, tb: LaneTables, s: LaneState):
    """The device loop (the reference's ``_build_full_run``): a flat loop
    of steps — window law, then one iteration — that reads the ``live``
    flag from the device once every ``CHECK_EVERY`` steps.  Steps after
    the end are no-ops (every kernel is gated on the flag), so the
    counters match the step driver's exactly.  The batched loop at S = 1
    (``_build_sweep_run``)."""
    return _build_sweep_run([p], [tb], [s])


# the device loop's steps between reads of a hybrid turn's readback: most
# turns take one to three iterations and stop at the next step, so the
# first read comes after four; longer turns (windows the host takes no
# part in, free-run) double the chunk up to CHECK_EVERY.  Steps past the
# turn's end are gated no-ops: no counter depends on this schedule
HYBRID_CHECKS = (4, 8, 16)


def _build_hybrid_run(p: LaneParams, tb: LaneTables, s: LaneState):
    """The device half of the hybrid backend (the reference's
    ``_build_hybrid_run``): ``hybrid_run(ext_t, ext_used, inj=None) ->
    [5] ints`` merges each staged injection block of ``inj`` (``[blocks,
    INJ_WORDS, B]`` int32 on the device; kernel H, one launch a block),
    then runs the device loop under the hybrid window law (kernel C's
    hybrid mode with the host side's next event time ``ext_t`` and its
    smallest used latency ``ext_used``, NEVER32 for none): it free-runs
    the windows the host takes no part in, completes the first one it
    does, and stops (or earlier, when the egress buffer runs low).  It
    returns the turn's packed readback by the ``HYB_*`` indices — one
    device-to-host copy of the ``[5]`` vector per read, the reads spaced
    by ``HYBRID_CHECKS``.  ``hybrid_run.steps`` counts the steps run."""
    from . import kernels

    dev = s.q_thi.device
    args = kernels.LaneArgs(p, tb, s, make_workspace(p, dev))
    window, iteration = _steps(args, p)
    hyb = args.ws.hyb
    out = torch.empty(5, dtype=i64, pin_memory=dev.type == "cuda")

    def hybrid_run(ext_t: int, ext_used: int, inj=None) -> list:
        for blk in (() if inj is None else inj):
            kernels.inject_merge(args, blk)
        eh, el = ((NEVER32, NEVER32) if ext_t >= NEVER
                  else (ext_t >> 31, ext_t & MASK31))
        turn = HybridTurn(eh, el, ext_used, True)
        chunks = iter(HYBRID_CHECKS)
        while True:
            steps = next(chunks, CHECK_EVERY)
            for _ in range(steps):
                window(True, turn)
                turn = turn._replace(first=False)
                iteration()
            hybrid_run.steps += steps
            out.copy_(hyb, non_blocking=True)
            if dev.type == "cuda":
                torch.cuda.current_stream(dev).synchronize()
            if int(out[HYB_DEV_WE]) >= 0:
                return out.tolist()

    hybrid_run.steps = 0
    hybrid_run.args = args
    return hybrid_run


class FusedDispatch(NamedTuple):
    """A fused dispatch in flight (``FusedRun.issue``): the event recorded
    after its readback's copy (None on the CPU), its steps so far, its
    window limit, and the driver's dispatch number, which ``resolve``
    checks (a later issue retires every earlier handle)."""
    event: object
    steps: int
    k_eff: int
    number: int


class FusedRun:
    """The k-window fused device half (the reference's
    ``_build_hybrid_fused_run`` / ``make_hybrid_fused_fn``), split so that
    the host can service rounds while it runs.  ``issue(ext, ext_used,
    inj, k_eff) -> FusedDispatch`` merges each staged injection block of
    ``inj`` (kernel H; None for none), copies the schedule ``ext``
    (``ext_slots`` ascending int event times, the horizon last) to the
    workspace, launches one chunk of steps under kernel C's fused mode and
    an async copy of the readback into pinned memory, records an event and
    returns without waiting.  ``resolve(handle) -> list`` waits for that
    event and, while the dispatch has not stopped, runs further chunks; it
    returns the ``[6 + k_cap]`` readback by the ``HYB_*`` indices.
    ``k_cap`` is fixed here; ``k_eff`` <= ``k_cap`` is per dispatch.  The
    first chunk is one step more than the last dispatch's live steps (4 to
    ``CHECK_EVERY``), later ones double; steps past the stop are gated
    no-ops, so no counter depends on it.  ``steps`` counts the steps
    run."""

    def __init__(self, p: LaneParams, tb: LaneTables, s: LaneState,
                 k_cap: int, ext_slots: int) -> None:
        import dataclasses

        from . import kernels

        self.k_cap, self.ext_slots = k_cap, ext_slots
        p = dataclasses.replace(p, hybrid_k_cap=k_cap, ext_slots=ext_slots)
        self.dev = s.q_thi.device
        self.cuda = self.dev.type == "cuda"
        self.args = kernels.LaneArgs(p, tb, s, make_workspace(p, self.dev))
        self._window, self._iteration = _steps(self.args, p)
        self._inject = kernels.inject_merge
        self.out = torch.empty(p.hyb_words, dtype=i64, pin_memory=self.cuda)
        self.steps = 0
        self._number = 0
        self._first = HYBRID_CHECKS[0]

    def _run(self, turn: FusedTurn, steps: int) -> None:
        for _ in range(steps):
            self._window(True, turn)
            turn = turn._replace(first=False)
            self._iteration()
        self.steps += steps
        self.out.copy_(self.args.ws.hyb, non_blocking=True)

    def issue(self, ext, ext_used: int, inj, k_eff: int) -> FusedDispatch:
        if not 1 <= k_eff <= self.k_cap or len(ext) != self.ext_slots:
            raise ValueError(
                f"fused dispatch: k_eff {k_eff} (k_cap {self.k_cap}), "
                f"{len(ext)} schedule slots ({self.ext_slots})")
        for blk in (() if inj is None else inj):
            self._inject(self.args, blk)
        sched = torch.tensor(ext, dtype=i64)
        self.args.ws.ext.copy_(sched.pin_memory() if self.cuda else sched,
                               non_blocking=True)
        steps = self._first
        self._run(FusedTurn(ext_used, k_eff, True), steps)
        event = None
        if self.cuda:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self.dev))
        self._number += 1
        return FusedDispatch(event, steps, k_eff, self._number)

    def resolve(self, h: FusedDispatch) -> list:
        if h.number != self._number:
            raise RuntimeError("fused dispatch: a later dispatch retired "
                               "this handle")
        if h.event is not None:
            h.event.synchronize()
        chunk = h.steps
        while int(self.out[HYB_DEV_WE]) < 0:
            chunk = min(2 * chunk, CHECK_EVERY)
            self._run(FusedTurn(NEVER32, h.k_eff, False), chunk)
            if self.cuda:
                torch.cuda.current_stream(self.dev).synchronize()
        sc = self.out.tolist()
        self._first = min(max(sc[-1] + 1, HYBRID_CHECKS[0]), CHECK_EVERY)
        return sc[:-1]

    def __call__(self, ext, ext_used: int, inj, k_eff: int) -> list:
        """A blocking dispatch: ``issue`` then ``resolve``."""
        return self.resolve(self.issue(ext, ext_used, inj, k_eff))


# the turn's state: every LaneState field a dispatch writes, less the
# append-only buffers (the log and the flowtrace ring: a rebuild re-appends
# the same rows at the same places from the saved counts) and the egress
# buffer, which a dispatch's first step empties
SNAP_SKIP = ("log", "fl_buf", "egress")


def _snap_fields(s: LaneState) -> list:
    return [f for f in LaneState._fields if f not in SNAP_SKIP]


def snapshot(s: LaneState, into: dict = None) -> dict:
    """Device-to-device copies of the fields a hybrid dispatch writes
    (``SNAP_SKIP`` aside), into ``into`` when given (the buffers of an
    earlier snapshot of this state), else into new tensors; queued on the
    current stream, no host read."""
    fields = _snap_fields(s)
    if into is None:
        into = {f: torch.empty_like(getattr(s, f)) for f in fields}
    torch._foreach_copy_([into[f] for f in fields],
                         [getattr(s, f) for f in fields])
    return into


def restore(s: LaneState, snap: dict) -> None:
    """Put a ``snapshot`` back into ``s`` in place (the counts of the
    append-only buffers with it, so the next rows land where the snapshot
    left them)."""
    fields = _snap_fields(s)
    torch._foreach_copy_([getattr(s, f) for f in fields],
                         [snap[f] for f in fields])


def snapshot_bytes(snap: dict) -> int:
    return sum(t.numel() * t.element_size() for t in snap.values())
