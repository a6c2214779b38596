"""Hybrid backend: managed (real-binary) hosts riding the card's data plane.

The JAX package's ``backend/hybrid.py`` on the port: "keep syscall
emulation on host CPU, offload the per-round packet-scheduling hot path".
Hosts whose processes are real managed binaries run on the host CPU
exactly as in :class:`CpuEngine` (under the LD_PRELOAD shim,
``native/process.py``), while the network data plane — per-lane arrival
queues, latency and loss lookup, token buckets, CoDel, and every
lane-model host — runs on the device (``backend/lanes.py``, the CUDA
kernels of ``csrc/lanes.cu``).  The seam mirrors the reference's
``Worker::send_packet`` offload target (worker.rs:330-404):

- a managed host's **send** runs the source half of the packet lifecycle
  host-side (up bucket, pcap, loss draw — ``CpuEngine``'s own law) and
  stages the PACKET arrival for injection (kernel H, ``inject_merge``),
  its payload bytes parked host-side under ``(src, seq)``;
- the device advances windows over ALL lanes; packets that arrive at
  external lanes leave through the egress buffer at their exact
  ``t_deliver`` (down bucket and CoDel applied on the device: kernel A's
  external arm, compacted by kernel D) and are queued host-side as
  DELIVERY events carrying the parked payload;
- the window law stays global and equal to the scalar oracle's: kernel
  C folds the host side's next event time into every window start,
  free-runs the windows the host takes no part in, and stops after the
  window it does (C's hybrid mode, ``hybrid_fuse_k: 1``) or after up to k
  of them over a peeked schedule of the host's next event times (C's
  fused mode, the default ``hybrid_fuse_k: 8``).

On the fused law the host services the covered windows after the
dispatch and validates them (an arrival frontier: a round that stages a
send landing inside the span, or creates an event inside it, cuts the
span); a misprediction rolls the device back to a snapshot taken before
the dispatch and rebuilds the validated prefix.  While the host services
a turn's rounds, the next dispatch is issued eagerly, on the speculation
that the rounds stage nothing; it is adopted at the next barrier only if
its inputs turn out equal and nothing else ran on the state since, and
otherwise undone from its own snapshot.  The reference gets both from
functional purity; the port's kernels write the state in place, so it
keeps device snapshots (``lanes.snapshot``) and a generation counter.

Two engines drive the seam: :class:`HybridEngine`, which services every
managed host in one process, and :class:`MpHybridEngine`, whose spawned
worker processes each own a partition of the managed hosts and service
their syscalls in parallel while the parent owns the device and the
window law.  :func:`make_hybrid_engine` picks one as the reference's
facade does.  Event logs, counters and rounds are the same at every
worker count and on either law.

With ``perf_log`` set (``experimental.perf_logging``) the engines print a
``[hybrid-agg]`` line of the cumulative ``sync_stats`` after every device
dispatch (``kind=device``) and every host round (``kind=host``), and the
hosts' ``[host-exec-agg]`` lines; a syscall worker buffers its lines
(``BufferedPerfLog``) and the parent prints them in round order.  With
``obs`` set they record the ``device_turn``, ``injection``, ``egress``,
``syscall_service`` and ``worker_pipe`` spans.

Not ported here (ROADMAP item 12, each refused with ``LaneCompatError`` by
``ConfigOptions.validate``): the turn ledger, and fault schedules with the
watchdog and the CPU failover.
"""

from __future__ import annotations

import logging
import os
import time as wall_time
from typing import Optional

import numpy as np
import torch

from ..config.options import ConfigOptions, LaneCompatError
from ..core import time as stime
from ..core.event import Event, EventKind
from ..core.event_queue import EventQueue
from ..engine.supervisor import recv_with_deadline, worker_recv
from ..faults import BackendStallError
from ..models.base import config_has_managed  # noqa: F401  (the entry's test)
from . import lanes
from .cpu_engine import DELIVERED, CpuEngine, Delivery, Host, SimResult

NEVER = stime.NEVER

log = logging.getLogger("shadow_tpu_torch.hybrid")


class _HostSideHybrid(CpuEngine):
    """The host-side half of the hybrid seam, shared by the serial engine
    and the syscall worker processes: external-host bookkeeping, the
    staging send sink and the delivery law.  Construction reuses
    ``CpuEngine.__init__`` wholesale (hosts, apps, pcap, hosts file,
    routing: one source of truth); ``_hybrid_host_init`` then strips the
    lane-covered hosts' host-side state."""

    # -- the fused law's peek and validation (shared with the workers) -----

    def _peek_head_horizon(self, slots: int, hosts=None, floor_t: int = 0):
        """The next ``slots - 1`` DISTINCT event times (>= ``floor_t``)
        across this side's hosts (or ``hosts``: the multiprocess parent
        passes its replica of a worker's partition), and the horizon — the
        first time the list does NOT cover (NEVER when it covers all).  The
        device never free-runs past the horizon: an uncovered host event
        could open a window there.  One definition for the serial peek,
        the workers' peeks and the parent's initial partition peeks."""
        if hosts is None:
            hosts = self._next_hosts
        times = sorted({
            ev.time for h in hosts for ev in h.queue._heap
            if ev.time >= floor_t
        })
        head = tuple(times[: slots - 1])
        horizon = times[slots - 1] if len(times) >= slots else NEVER
        return head, horizon

    def _range_count(self, lo: int, hi: int) -> int:
        """Queued events with ``lo <= t < hi``: a covered round's
        cleanliness probe.  A round pops only events below its window end,
        so a change in this count across the round means it CREATED an
        event inside the still-covered fused span — a window boundary the
        device could not know (the walk cuts the span there)."""
        return sum(
            1 for h in self._next_hosts for ev in h.queue._heap
            if lo <= ev.time < hi
        )

    def _hybrid_host_init(self) -> None:
        from ..native.process import ManagedApp

        ext = np.array(
            [any(isinstance(a, ManagedApp) for a in h.apps) for h in self.hosts],
            dtype=bool,
        )
        if not ext.any():
            raise LaneCompatError(
                "no managed hosts in config; use the lane engine (GpuEngine)"
            )
        self.external_mask = ext
        self.external_hosts: list[Host] = [
            h for h, e in zip(self.hosts, ext) if e
        ]
        for h, e in zip(self.hosts, ext):
            if e:
                h.staged = []  # sends awaiting device injection
            else:
                # lane-covered: the device runs this host; drop its
                # host-side apps, start events and pcap writer (the device
                # log rebuilds lane pcaps at collect)
                h.apps = []
                h.queue = EventQueue()
                h.pcap = None
        # hosts whose queues feed next_event_time() and whose buffers the
        # barrier sweeps: every external host for the serial engine; a
        # worker narrows this to its partition
        self._next_hosts: list[Host] = self.external_hosts
        self._staged_merged: list = []
        self.host_rounds = 0

    # -- host-side packet source half (the law IS CpuEngine's) -------------

    def send_packet(self, src_host, dst, size_bytes, payload=None,
                    loopback=False, retx=False):
        """The shared source half (``CpuEngine._packet_source_half``: up
        bucket, outbound pcap, dynamic-runahead record, Bernoulli loss)
        with a device-injection sink: the surviving packet is STAGED for
        the device instead of pushed into a host queue — the dst half
        (down bucket, CoDel, delivery) runs on the device for every lane,
        external ones included.  Loopback traffic never touches the
        device: the lo interface is host-local by definition."""
        if loopback:
            return self._loopback_send(src_host, size_bytes, payload)
        seq, arr = self._packet_source_half(src_host, dst, size_bytes, payload,
                                            retx=retx)
        if arr is None:
            return seq
        src_host.staged.append(
            (arr, src_host.host_id, seq, size_bytes, dst, payload)
        )
        return seq

    def inbound(self, dst_host, ev):  # pragma: no cover - defensive
        raise AssertionError(
            "hybrid host queues never hold PACKET events (the device owns "
            "the dst half of the lifecycle)"
        )

    # -- barrier (external hosts only; lane hosts have no host state) ------

    def next_event_time(self) -> int:
        return min(
            (h.queue.next_time() for h in self._next_hosts), default=NEVER
        )

    def _barrier_merge(self) -> None:
        staged = self._staged_merged
        for h in self._next_hosts:
            if h.staged:
                staged.extend(h.staged)
                h.staged = []
            if h.log_buf:
                self.event_log.extend(h.log_buf)
                h.log_buf.clear()
            if h.min_used_lat is not None:
                if self._min_used_lat is None or h.min_used_lat < self._min_used_lat:
                    self._min_used_lat = h.min_used_lat
                h.min_used_lat = None

    # -- delivery application ----------------------------------------------

    def _apply_delivery_row(self, t, src, dst, seq, size, payload) -> None:
        """Queue one device-egressed delivery as a host-side DELIVERY
        event at its exact t_deliver (down bucket and CoDel already
        applied on the device; the DELIVERED/DROP_CODEL log records live
        in the device log).  Mirrors the oracle's passive-delivery
        elision: an external host whose apps are all passive consumes the
        delivery inline."""
        h = self.hosts[dst]
        if h.pcap is not None:  # inbound capture at delivery
            h.pcap.capture(
                stime.sim_to_emu(t), self.ips.by_host[src],
                self.ips.by_host[dst], size, payload,
                key=(0, src, dst, seq),
            )
        if payload is None and h.passive_delivery:
            h.now = t
            for app in h.apps:
                h._current_app = app
                app.on_delivery(h, t, src, seq, size, payload=None)
            return
        h.queue.push(
            Event(
                t, EventKind.DELIVERY, src_host=src, seq=seq,
                data=Delivery(src, seq, size, payload),
            )
        )


class _HybridWorker(_HostSideHybrid):
    """A syscall worker's world replica: the host-side hybrid half
    restricted to its partition of the external hosts.  Construction is
    deterministic, so every replica is identical; a managed OS process
    starts only when its host's start task executes, which happens in
    exactly one worker."""

    def __init__(self, cfg: ConfigOptions, owned: list[int]) -> None:
        super().__init__(cfg)
        self._hybrid_host_init()
        owned_set = set(owned)
        self.owned_hosts = [
            h for h in self.external_hosts if h.host_id in owned_set
        ]
        self._next_hosts = self.owned_hosts


def _hybrid_worker_main(cfg: ConfigOptions, owned: list[int],
                        peek_slots: int, conn) -> None:
    """A worker's loop: apply the shipped deliveries, execute the owned
    hosts' window (the syscall service, in parallel with the other
    workers), and send the staged sends back.  On the fused law
    (``peek_slots`` > 0) the reply also carries the cleanliness flag of
    the shipped validation range (did this round create an event inside
    the still-covered span?) and the partition's new peek schedule, so the
    parent can bound the next dispatch without another round trip.  The
    worker never touches the card.  It says "ready" once its replica is
    built.  With perf logging on, its hosts' lines ride each reply to the
    parent's sink."""
    engine = _HybridWorker(cfg, owned)
    if cfg.experimental.perf_logging:
        from ..engine.run_control import BufferedPerfLog

        engine.perf_log = BufferedPerfLog()
    conn.send(("ready",))
    finished = False
    try:
        while True:
            # poll-sliced: a vanished parent ends the read instead of
            # blocking forever, so the finally still reaps the managed
            # processes this worker started
            msg = worker_recv(conn)
            if msg[0] == "round":
                _, window_end, rows, we_final = msg
                engine.window_end = window_end
                for t, src, dst, seq, size, payload in rows:
                    engine._apply_delivery_row(t, src, dst, seq, size, payload)
                probe = we_final > window_end
                pre_range = (engine._range_count(window_end, we_final)
                             if probe else 0)
                for h in engine.owned_hosts:
                    h.execute(window_end)
                engine._barrier_merge()
                clean = (not probe or engine._range_count(
                    window_end, we_final) == pre_range)
                staged = engine._staged_merged
                engine._staged_merged = []
                conn.send((
                    engine.next_event_time(),
                    staged,
                    engine._min_used_lat,
                    engine.perf_log.drain()
                    if engine.perf_log is not None else (),
                    clean,
                    engine._peek_head_horizon(peek_slots)
                    if peek_slots else (),
                ))
            elif msg[0] == "finish":
                engine.finalize()
                finished = True
                counters: dict[str, int] = {}
                for h in engine.owned_hosts:
                    for k, v in h.counters.items():
                        counters[k] = counters.get(k, 0) + v
                conn.send((
                    engine.event_log,
                    counters,
                    {h.host_id: dict(h.counters) for h in engine.owned_hosts},
                    list(getattr(engine, "process_errors", [])),
                ))
                return
            else:  # pragma: no cover - protocol error
                return
    except (EOFError, OSError):
        # the parent closed the pipe (its teardown after an error) or
        # died: exit quietly, the finally reaps
        return
    finally:
        if not finished:
            try:
                engine.finalize()
            except Exception:
                pass
        conn.close()


class HybridEngine(_HostSideHybrid):
    """CpuEngine for the external (managed) hosts; the card's lanes for the
    rest (``device=None``: the card; ``device="cpu"``: the kernels' plain
    versions).  Owns the device state, the window law and the batched
    host<->device boundary: the staged injection blocks in, one packed
    readback and one egress drain out per device turn (``sync_stats``
    counts the transfers as the reference does)."""

    def __init__(
        self, cfg: ConfigOptions, device=None,
        log_capacity: Optional[int] = None,
    ) -> None:
        from .gpu_engine import GpuEngine

        super().__init__(cfg)
        self._hybrid_host_init()
        self.device = GpuEngine(
            cfg, log_capacity=log_capacity, device=device,
            external=self.external_mask, world=self.world,
        )
        # parked payloads for in-flight packets, keyed (src_host, seq):
        # popped when the device egresses the delivery
        self._parked: dict = {}
        self._dev_min_used: Optional[int] = None
        # the staging buffer of the injection blocks, reused across turns
        # (pinned host memory on the card: each turn's blocks go in one
        # H2D copy)
        self._inj_host: Optional[torch.Tensor] = None
        self._inj_dev: Optional[torch.Tensor] = None
        # host<->device sync-cost accounting (the reference's counters)
        self.sync_stats: dict = {
            "device_turns": 0,      # dispatches (windows batched per)
            "device_sync_s": 0.0,   # device-turn wall: launches and waits
            "syscall_service_s": 0.0,  # host-side window execution wall
            "scalar_reads": 0,      # D2H transfers: packed scalar vectors
            "inject_blocks": 0,     # H2D transfers: injection blocks
            "inject_rows": 0,       # staged sends carried by those blocks
            "inject_bytes": 0,      # H2D bytes (7 arrays x B rows)
            "egress_reads": 0,      # D2H transfers: egress buffer slices
            "egress_rows": 0,       # delivery rows carried by those reads
            "egress_bytes": 0,      # D2H bytes (padded [span, 6] int64)
            # the k-window fused law and its eager dispatch:
            "fused_dispatches": 0,  # dispatches covering >= 2 validated windows
            "fused_windows": 0,     # validated windows those covered
            "turns_saved": 0,       # blocking dispatches fusion saved, net
            "fuse_rollbacks": 0,    # prefix-rebuild dispatches (mispredictions)
            "async_dispatch_hits": 0,    # eager dispatches adopted
            "async_dispatch_misses": 0,  # eager dispatches undone
            "dispatch_retries": 0,  # failed fused dispatches re-dispatched
        }
        exp = cfg.experimental
        # the retry law: a failed fused dispatch re-dispatches from the
        # pre-turn snapshot up to this many times
        self._dispatch_retry_max = max(0, int(exp.dispatch_retry_max))
        self._fuse_k = max(1, int(exp.hybrid_fuse_k))
        self._fuse_on = self._fuse_k >= 2
        self._async_on = self._fuse_on and bool(exp.hybrid_async_dispatch)
        # the peeked schedule's width: enough slots that windows with
        # several events do not exhaust it mid-span (last slot: horizon)
        self._ext_slots = max(2 * self._fuse_k, 9)
        self._fuse_we_final = None  # the covered rounds' validation range end
        self._round_clean = True    # set by _service_round / _mp_round
        self._eager = None          # the speculative dispatch in flight
        # 2-bit saturating adoption predictor of the eager dispatch: issue
        # for real at >= 2, else record a PHANTOM speculation (inputs only,
        # no device work) whose would-have-hit outcome keeps training it.
        # It decides only what is overlapped, never a result
        self._eager_pred = 2
        # the live state's generation: one more at every dispatch issued
        # on it and every restore (the reference's object identity: an
        # eager result is adopted only if nothing else ran since)
        self._gen = 0
        # two snapshot buffers: the turn's checkpoint, and the eager
        # dispatch's base taken while the checkpoint is still needed
        self._snaps: list = [None, None]
        self._ckpt = 0  # the buffer holding the current checkpoint
        # the provable external lookahead: the least latency on an edge
        # OUT of a managed host's node; a send staged in a covered window
        # arrives no earlier than its departure plus this
        self._ext_min_lat: Optional[int] = None
        if self._fuse_on:
            from ..net.graph import _UNREACHABLE

            idx = self.node_index
            ext_nodes = sorted({idx[h.host_id] for h in self.external_hosts})
            all_nodes = sorted(set(idx.values()))
            lat = self.graph.latency_ns[np.ix_(ext_nodes, all_nodes)]
            ok = lat != _UNREACHABLE
            if ok.any():
                self._ext_min_lat = int(lat[ok].min())

    # -- dynamic runahead ---------------------------------------------------

    def current_runahead(self) -> int:
        """The global dynamic-runahead law: min over BOTH sides' smallest
        used latency (the device's is read back after every device turn;
        between turns it cannot change).  Host-side: no device read."""
        if not self.dynamic_runahead:
            return self.runahead
        vals = [
            v for v in (self._min_used_lat, self._dev_min_used)
            if v is not None
        ]
        if not vals:
            return self.runahead
        return max(min(vals), self._runahead_floor, 1)

    # -- egress application -------------------------------------------------

    def _apply_egress(self, rows) -> None:
        for t, src, dst, seq, size, outcome in rows:
            payload = self._parked.pop((src, seq), None)
            if outcome != DELIVERED:
                continue  # device-side drop: payload released, no event
            self._route_delivery(t, src, dst, seq, size, payload)

    def _route_delivery(self, t, src, dst, seq, size, payload) -> None:
        self._apply_delivery_row(t, src, dst, seq, size, payload)

    # -- device turn --------------------------------------------------------

    def _inj_blocks(self, staged) -> Optional[torch.Tensor]:
        """Pack the staged sends into injection blocks of B rows (the
        reference's ``_inj_block`` and its oversize-staging loop), in the
        reused host staging buffer, and copy them to the device in one
        transfer; payloads are parked here under (src, seq).  None when
        nothing was staged."""
        if not staged:
            return None
        t_inj = wall_time.perf_counter()
        b = self.device.params.inject_batch
        n_blk = -(-len(staged) // b)
        dev = self.device.device
        if self._inj_host is None or self._inj_host.shape[0] < n_blk:
            self._inj_host = torch.empty(
                (n_blk, lanes.INJ_WORDS, b), dtype=torch.int32,
                pin_memory=dev.type == "cuda")
            self._inj_dev = (torch.empty_like(self._inj_host, device=dev)
                             if dev.type == "cuda" else None)
        cols = np.zeros((lanes.INJ_WORDS, n_blk * b), dtype=np.int64)
        cols[2:4] = lanes.NEVER32
        for i, (arr, src, seq, sz, d, payload) in enumerate(staged):
            if payload is not None:
                self._parked[(src, seq)] = payload
            cols[:, i] = (1, d, arr >> 31, arr & lanes.MASK31,
                          (lanes.PACKET << lanes.AUX_KIND_SHIFT)
                          | (src << lanes.AUX_SRC_SHIFT), seq, sz)
        host = self._inj_host[:n_blk]
        host.copy_(torch.from_numpy(
            cols.astype(np.int32).reshape(lanes.INJ_WORDS, n_blk, b)
            .transpose(1, 0, 2)))
        st = self.sync_stats
        st["inject_blocks"] += n_blk
        st["inject_rows"] += len(staged)
        st["inject_bytes"] += n_blk * b * (1 + 6 * 4)
        blocks = host
        if self._inj_dev is not None:
            blocks = self._inj_dev[:n_blk]
            blocks.copy_(host, non_blocking=True)
        if self.obs is not None:
            self.obs.record("injection", None, t_inj,
                            wall_time.perf_counter() - t_inj,
                            rows=len(staged))
        return blocks

    def _read_egress(self, state, count: int, lost: int) -> list:
        if lost:
            raise RuntimeError(
                "hybrid egress buffer overflowed despite the headroom "
                "guard (device invariant violation)"
            )
        if count == 0:
            return []
        # the reference pads the slice length to a power of two (a compile
        # per size there); the same span keeps the transfer accounting equal
        cap = self.device.params.egress_capacity
        span = 1
        while span < count:
            span <<= 1
        span = min(span, cap)
        st = self.sync_stats
        st["egress_reads"] += 1
        st["egress_rows"] += count
        st["egress_bytes"] += span * 6 * 8
        obs = self.obs
        if obs is None:
            return state.egress[:span].cpu()[:count].tolist()
        with obs.phase("egress", rows=count):
            rows = state.egress[:span].cpu()[:count].tolist()
        obs.metrics.count("egress_rows", count)
        return rows

    def _device_turn(self, state, hybrid_run, next_host_fn):
        """Inject staged sends, run the device turn and apply its egress —
        again while the device paused mid-window to drain a low egress
        buffer.  Per completed turn the boundary costs one H2D copy of the
        injection blocks (none when nothing was staged), the packed
        readback's D2H copy, and one egress slice D2H (none when nothing
        egressed)."""
        st = self.sync_stats
        staged = self._staged_merged
        self._staged_merged = []
        inj = self._inj_blocks(staged)
        ext_used = self._used_enc()
        host_next = next_host_fn()
        while True:
            t0 = wall_time.perf_counter()
            sc = hybrid_run(host_next, ext_used, inj)
            t1 = wall_time.perf_counter()
            st["device_sync_s"] += t1 - t0
            st["device_turns"] += 1
            st["scalar_reads"] += 1
            lane_min = sc[lanes.HYB_LANE_MIN]
            dev_we = sc[lanes.HYB_DEV_WE]
            dev_used = sc[lanes.HYB_MIN_USED]
            self._dev_min_used = (
                None if dev_used >= lanes.NEVER32 else dev_used
            )
            self._record_turn(t0, t1, dev_we)
            self._apply_egress(self._read_egress(
                state, sc[lanes.HYB_EGRESS_COUNT], sc[lanes.HYB_EGRESS_LOST]))
            if self.perf_log is not None:
                self.perf_log.hybrid_agg("device", dev_we, st)
            if lane_min >= dev_we:
                return lane_min, dev_we
            # mid-window pause (egress headroom): drain and resume, with
            # nothing to inject
            inj = None
            host_next = next_host_fn()

    def _record_turn(self, t0: float, t1: float, dev_we: int) -> None:
        """One dispatch's ``device_turn`` span and count (obs on)."""
        obs = self.obs
        if obs is not None:
            obs.record("device_turn", None, t0, t1 - t0, window_end=dev_we)
            obs.metrics.count("device_turns")

    # -- device snapshots (the fused law's rollback and eager dispatch) ------

    def _snapshot(self, state, slot: int) -> int:
        self._snaps[slot] = lanes.snapshot(state, self._snaps[slot])
        return slot

    def _restore(self, state, slot: int) -> None:
        lanes.restore(state, self._snaps[slot])
        self._gen += 1

    # -- k-window fused turns -----------------------------------------------

    def _peek_ext_times(self, floor_t: int = 0) -> list:
        """The fused dispatch's schedule: the next ``_ext_slots - 1``
        distinct host-side event times (>= floor_t), padded with the
        horizon in the trailing slots (ascending, so the device's pointer
        law stays a prefix count)."""
        es = self._ext_slots
        head, horizon = self._peek_head_horizon(es, floor_t=floor_t)
        head = list(head)
        return head + [horizon] * (es - len(head))

    def _drop_eager(self, state) -> None:
        """Discard the speculation in flight: an issued one ran on the
        live state, which goes back to the snapshot taken before it."""
        e = self._eager
        if e is not None:
            if e["h"] is not None:
                self.sync_stats["async_dispatch_misses"] += 1
                self._restore(state, e["snap"])
            self._eager = None
            self._eager_pred = max(self._eager_pred - 1, 0)

    def _fuse_depth(self) -> int:
        """The per-dispatch fusion depth: the provable external-lookahead
        bound (windows the law covers before any speculation: a managed
        send departing in covered window 1 arrives >= L_ext past its
        start, about L_ext/runahead windows later) plus one speculative
        window, floored at 3 and capped by ``hybrid_fuse_k``.  The floor is
        statistical, not provable (the validation law makes any depth
        safe; this only tunes the waste).  Recomputed per dispatch:
        dynamic runahead moves the bound."""
        k = self._fuse_k
        if self._ext_min_lat is not None:
            ra = self.current_runahead()
            k = min(k, max(3, self._ext_min_lat // ra + 1))
        return k

    def _used_enc(self) -> int:
        return (lanes.NEVER32 if self._min_used_lat is None
                else self._min_used_lat)

    def _issue_eager(self, fused, state, lane_min: int, floor_t: int) -> None:
        """The double-buffered async dispatch: while the covered rounds
        are serviced, issue the NEXT fused turn on the speculation that
        they stage nothing and create no event the peek (taken at the
        covered span's end) does not show.  Resolved at the next dispatch
        barrier: adopted only when the real inputs match the speculated
        ones exactly and the state's generation has not moved (the
        provably empty injection that makes the overlap sound); otherwise
        undone from the snapshot taken here."""
        ext = self._peek_ext_times(floor_t)
        host_next = ext[0]
        start = min(host_next, lane_min)  # staged-empty speculation
        if start >= self.stop_time or start == NEVER:
            return
        end = min(start + self.current_runahead(), self.stop_time)
        if lane_min >= end:
            return  # next window would be host-only: nothing to overlap
        used_enc = self._used_enc()
        k_eff = self._fuse_depth()
        if self._eager_pred < 2:
            # cold predictor: the speculation's inputs WITHOUT device work;
            # its would-have-hit outcome trains the predictor
            self._eager = {"gen": self._gen, "ext": ext, "used": used_enc,
                           "k": k_eff, "h": None, "snap": None, "t": 0.0}
            return
        t0 = wall_time.perf_counter()
        snap = self._snapshot(state, 1 - self._ckpt)
        h = fused.issue(ext, used_enc, None, k_eff)
        self._gen += 1
        self._eager = {"gen": self._gen, "ext": ext, "used": used_enc,
                       "k": k_eff, "h": h, "snap": snap,
                       "t": wall_time.perf_counter() - t0}

    def _checkpoint(self, state) -> int:
        """The snapshot of the state a dispatch starts from: the eager
        dispatch's base when one is in flight (adopted, it IS that
        dispatch; undone, the state goes back to it), else a new one."""
        e = self._eager
        if e is not None and e["h"] is not None:
            self._ckpt = e["snap"]
        else:
            self._ckpt = self._snapshot(state, self._ckpt)
        return self._ckpt

    def _dispatch_fused(self, state, ckpt: int, fused, ext, used_enc, inj,
                        n_staged: int, k_eff: int):
        """Dispatch (or adopt the eagerly issued) fused device call and
        wait for its packed readback.  Adoption requires the real inputs
        to equal the speculated ones exactly — same generation of the
        state, same peeked schedule, same dynamic-runahead fold, the same
        depth and an empty injection — then the eager result IS this
        dispatch's result, and the wait covers only what the overlapped
        syscall service did not hide.  An eager dispatch that does not
        match is undone (the state back to ``ckpt``) first."""
        st = self.sync_stats
        e = self._eager
        h = None
        t_issue = 0.0
        if e is not None:
            self._eager = None
            match = (
                e["gen"] == self._gen and e["ext"] == ext
                and e["used"] == used_enc and e["k"] == k_eff
                and n_staged == 0
            )
            self._eager_pred = (min(self._eager_pred + 1, 3) if match
                                else max(self._eager_pred - 1, 0))
            if e["h"] is None:
                pass  # phantom speculation: predictor trained, no result
            elif match:
                st["async_dispatch_hits"] += 1
                h, t_issue = e["h"], e["t"]
            else:
                st["async_dispatch_misses"] += 1
                self._restore(state, ckpt)
        t0 = wall_time.perf_counter()
        if h is None:
            h = fused.issue(ext, used_enc, inj, k_eff)
            self._gen += 1
        sc = fused.resolve(h)
        t1 = wall_time.perf_counter()
        st["device_sync_s"] += t1 - t0 + t_issue
        st["device_turns"] += 1
        st["scalar_reads"] += 1
        self._record_turn(t0, t1, sc[lanes.HYB_DEV_WE])
        return sc

    def _dispatch_retrying(self, state, ckpt: int, fused, ext, used_enc,
                           inj, n_staged: int, k_eff: int):
        """The dispatch retry law: a failed fused dispatch (an error raised
        at its launches or at the wait) restores the pre-turn snapshot and
        re-dispatches from it — the same inputs on the same state, so a
        successful retry equals a first-try success — with exponential
        backoff, up to ``experimental.dispatch_retry_max`` times; then
        :class:`BackendStallError`.  A sticky CUDA error (an illegal
        address, say) fails every retry, so such a run ends in
        ``BackendStallError``; it never goes on on the CPU."""
        attempt = 0
        while True:
            try:
                return self._dispatch_fused(
                    state, ckpt, fused, ext, used_enc, inj, n_staged, k_eff)
            except Exception as e:
                attempt += 1
                # an outstanding speculation rode the failed timeline
                self._eager = None
                if attempt > self._dispatch_retry_max:
                    raise BackendStallError(
                        f"fused device dispatch failed after "
                        f"{attempt - 1} retr"
                        f"{'y' if attempt - 1 == 1 else 'ies'}: "
                        f"{type(e).__name__}: {e}"
                    ) from e
                self.sync_stats["dispatch_retries"] += 1
                backoff = min(0.05 * 2 ** (attempt - 1), 1.0)
                log.warning(
                    "fused dispatch failed (%s: %s); re-dispatching from "
                    "the pre-turn snapshot in %.2fs (attempt %d/%d)",
                    type(e).__name__, e, backoff, attempt,
                    self._dispatch_retry_max,
                )
                wall_time.sleep(backoff)
                self._restore(state, ckpt)

    def _fused_turn(self, state, fused, run_round, on_window, t_start: int):
        """One FUSED device turn: dispatch up to ``k_eff`` consecutive
        windows the host takes part in with one call, then service the
        covered rounds window by window under the arrival-frontier
        validation law:

        - the frontier F starts unbounded; each covered round lowers it to
          its earliest staged-send arrival, and to its own window end when
          the round created an event inside the still-covered span or
          moved the dynamic-runahead fold;
        - window j+1 is accepted only while ``we_{j+1} <= F`` — a staged
          arrival at or past the span's remaining windows cannot change
          their boundaries or contents (it merges at the next dispatch,
          before the window holding it is computed), so the accepted
          prefix equals the one-window law's by construction;
        - on a misprediction the device ROLLS BACK: the pre-turn snapshot
          is restored and one rebuild dispatch with ``k_eff`` = the
          validated prefix reproduces exactly the accepted windows (the
          same inputs on the same state); the staged sends ride the next
          turn.

        Egress rows apply lazily per accepted window, so a rollback never
        applies a delivery twice or pops a parked payload twice.  Returns
        the lane minimum (the device's next event)."""
        st = self.sync_stats
        staged = self._staged_merged
        self._staged_merged = []
        inj = self._inj_blocks(staged)
        n_staged = len(staged)
        prev_we = t_start
        while True:
            k_eff = self._fuse_depth()
            ext = self._peek_ext_times()
            used_enc = self._used_enc()
            ckpt = self._checkpoint(state)
            sc = self._dispatch_retrying(
                state, ckpt, fused, ext, used_enc, inj, n_staged, k_eff)
            lane_min = sc[lanes.HYB_LANE_MIN]
            dev_we = sc[lanes.HYB_DEV_WE]
            dev_used = sc[lanes.HYB_MIN_USED]
            self._dev_min_used = (
                None if dev_used >= lanes.NEVER32 else dev_used
            )
            k_done = sc[lanes.HYB_K_DONE]
            we_list = sc[lanes.HYB_WE_BASE:lanes.HYB_WE_BASE + k_done]
            rows = self._read_egress(state, sc[lanes.HYB_EGRESS_COUNT],
                                     sc[lanes.HYB_EGRESS_LOST])
            retry = lane_min < dev_we  # mid-window egress-headroom pause
            if self._async_on and not retry and we_list:
                self._issue_eager(fused, state, lane_min, we_list[-1])
            # ---- the validated servicing walk --------------------------
            w_valid = 0
            frontier = NEVER
            pend = rows
            for j, we_j in enumerate(we_list):
                if we_j > frontier:
                    break  # a staged arrival lands inside this window
                apply_now = [r for r in pend if r[0] < we_j]
                if apply_now:
                    pend = [r for r in pend if r[0] >= we_j]
                    self._apply_egress(apply_now)
                if self.next_event_time() < we_j:
                    pre_len = len(self._staged_merged)
                    pre_mul = self._min_used_lat
                    self.window_end = we_j
                    self._fuse_we_final = we_list[-1]
                    try:
                        run_round(we_j)
                    finally:
                        self._fuse_we_final = None
                    new = self._staged_merged[pre_len:]
                    if new:
                        a = min(e[0] for e in new)
                        if a < frontier:
                            frontier = a
                    if not self._round_clean or (
                        pre_mul != self._min_used_lat
                    ):
                        # the round created an event inside the covered
                        # span, or moved the dynamic-runahead fold: later
                        # window boundaries are unreproducible
                        frontier = min(frontier, we_j)
                w_valid = j + 1
                if on_window is not None:
                    on_window(prev_we, we_j, self.next_event_time())
                prev_we = we_j
            if w_valid < k_done:
                # misprediction: rebuild the validated prefix from the
                # checkpoint; the original dispatch's unapplied rows are
                # dropped (its invalidated windows made them) and the
                # staged sends ride the next turn.  An eager speculation
                # rode the invalidated timeline: it is discarded without
                # training the predictor (its miss says "rollback", not
                # "the next injection is not empty")
                if self._eager is not None:
                    if self._eager["h"] is not None:
                        st["async_dispatch_misses"] += 1
                    self._eager = None
                st["fuse_rollbacks"] += 1
                if w_valid >= 2:
                    st["fused_dispatches"] += 1
                    st["fused_windows"] += w_valid
                st["turns_saved"] += w_valid - 2
                self._restore(state, ckpt)
                sc_r = self._dispatch_retrying(
                    state, ckpt, fused, ext, used_enc, inj, n_staged,
                    w_valid)
                if sc_r[lanes.HYB_K_DONE] != w_valid:
                    raise AssertionError(
                        "fused prefix rebuild diverged from the original "
                        "dispatch (determinism violation)")
                lane_min = sc_r[lanes.HYB_LANE_MIN]
                dev_used = sc_r[lanes.HYB_MIN_USED]
                self._dev_min_used = (
                    None if dev_used >= lanes.NEVER32 else dev_used
                )
                # the rebuild's egress holds exactly the prefix's rows;
                # those at or past the last validated window's end never
                # passed the walk's filter (queueing delays put their
                # t_deliver into the invalidated span): apply them now
                rows_r = self._read_egress(
                    state, sc_r[lanes.HYB_EGRESS_COUNT],
                    sc_r[lanes.HYB_EGRESS_LOST])
                late = [r for r in rows_r if r[0] >= we_list[w_valid - 1]]
                if late:
                    self._apply_egress(late)
                return lane_min
            # ---- span fully validated ----------------------------------
            if k_done >= 2:
                st["fused_dispatches"] += 1
                st["fused_windows"] += k_done
                st["turns_saved"] += k_done - 1
            if pend:
                # trailing rows: deliveries of the window in progress (a
                # pause) or past the span — host events the next
                # dispatch's peek takes in
                self._apply_egress(pend)
            if self.perf_log is not None:
                self.perf_log.hybrid_agg("device", dev_we, st)
            if not retry:
                return lane_min
            # drain continuation: the device paused mid-window for egress
            # room; the covered rounds may have staged — pack and resume
            staged = self._staged_merged
            self._staged_merged = []
            inj = self._inj_blocks(staged)
            n_staged = len(staged)
            t_start = prev_we

    # -- the window law -------------------------------------------------------

    def _service_round(self, scheduler, until: int) -> None:
        """One host-side syscall-service round and barrier, timed into
        sync_stats.  Inside a fused span (``_fuse_we_final`` past the
        window) the round also runs the cleanliness probe: a changed event
        count in ``[until, we_final)`` means the round created an event
        inside the still-covered span, where the walk cuts it."""
        t0 = wall_time.perf_counter()
        wf = self._fuse_we_final
        probe = wf is not None and wf > until
        pre_range = self._range_count(until, wf) if probe else 0
        scheduler.run_round(until)
        self._barrier_merge()
        self._round_clean = (
            not probe or self._range_count(until, wf) == pre_range
        )
        t1 = wall_time.perf_counter()
        self.sync_stats["syscall_service_s"] += t1 - t0
        if self.obs is not None:
            self.obs.record("syscall_service", None, t0, t1 - t0,
                            window_end=until)
        if self.perf_log is not None:
            self.perf_log.hybrid_agg("host", until, self.sync_stats)

    def run(self, on_window=None) -> SimResult:
        from ..engine.scheduler import HostScheduler

        exp = self.cfg.experimental
        scheduler = HostScheduler(
            self.external_hosts,
            parallelism=self.cfg.general.parallelism,
            policy=exp.scheduler,
            pin_cpus=exp.use_cpu_pinning,
        )
        try:
            return self._run_hybrid(scheduler, on_window)
        finally:
            scheduler.shutdown()

    def _run_hybrid(self, scheduler, on_window) -> SimResult:
        t0 = wall_time.perf_counter()
        try:
            return self._hybrid_loop(scheduler, on_window, t0)
        except BaseException:
            self.finalize()
            raise

    def _window_loop(self, run_round, on_window):
        """The hybrid window law, shared by the serial engine and the
        multiprocess parent (only the round executor differs:
        ``run_round(until)`` is the scheduler's round or the workers'
        pipe round).  On ``hybrid_fuse_k`` 1 a device turn completes every
        window up to and including the first one the host takes part in;
        a window the device is idle through, with nothing staged, is a
        host-only round.  ``hybrid_fuse_k`` >= 2 swaps in the fused law.
        Returns the final device state."""
        if self._fuse_on:
            return self._window_loop_fused(run_round, on_window)
        dev = self.device
        state = dev.initial_state()
        dev._live_state = state
        hybrid_run = dev.make_hybrid_fns(state)
        dev_next = dev.first_event_time()
        while True:
            host_next = self.next_event_time()
            staged_min = min(
                (e[0] for e in self._staged_merged), default=NEVER
            )
            dev_eff = min(dev_next, staged_min)
            start = min(host_next, dev_eff)
            if start >= self.stop_time or start == NEVER:
                return state
            end = min(start + self.current_runahead(), self.stop_time)
            if self._staged_merged or dev_eff < end:
                # device turn: complete every window up to (and including)
                # the first one the host participates in
                dev_next, dev_we = self._device_turn(
                    state, hybrid_run, self.next_event_time
                )
                if self.next_event_time() < dev_we:
                    # the host's part of the device-completed window
                    self.window_end = dev_we
                    run_round(dev_we)
                    if on_window is not None:
                        on_window(start, dev_we, self.next_event_time())
                continue
            # host-only window (device idle beyond it, nothing staged)
            self.window_end = end
            run_round(end)
            self.host_rounds += 1
            if on_window is not None:
                on_window(start, end, self.next_event_time())

    def _window_loop_fused(self, run_round, on_window):
        """The k-window fused window law: the outer loop of
        ``_window_loop`` with device turns handed to ``_fused_turn`` (one
        dispatch covers up to k windows the host takes part in; the
        covered rounds are serviced and validated after it) and the eager
        dispatch resolved at the barriers.  Host-only windows, the
        dynamic-runahead law and the staged-send fold are untouched: the
        fusion changes how the windows are scheduled, not which run."""
        dev = self.device
        state = dev.initial_state()
        dev._live_state = state
        fused = dev.make_hybrid_fns(state, self._fuse_k, self._ext_slots)
        dev_next = dev.first_event_time()
        while True:
            host_next = self.next_event_time()
            staged_min = min(
                (e[0] for e in self._staged_merged), default=NEVER
            )
            dev_eff = min(dev_next, staged_min)
            start = min(host_next, dev_eff)
            if start >= self.stop_time or start == NEVER:
                self._drop_eager(state)
                return state
            end = min(start + self.current_runahead(), self.stop_time)
            if self._staged_merged or dev_eff < end:
                dev_next = self._fused_turn(state, fused, run_round,
                                            on_window, start)
                continue
            # host-only window (device idle beyond it, nothing staged): an
            # outstanding eager dispatch assumed a device window next and
            # cannot match — undo it before the round runs
            self._drop_eager(state)
            self.window_end = end
            run_round(end)
            self.host_rounds += 1
            if on_window is not None:
                on_window(start, end, self.next_event_time())

    def _collect(self, state, wall: float, event_log: list, counters: dict,
                 per_host: list, process_errors: list) -> SimResult:
        dev_result = self.device.collect(state, wall)
        for k, v in dev_result.counters.items():
            counters[k] = counters.get(k, 0) + v
        return SimResult(
            sim_time_ns=self.stop_time,
            wall_seconds=wall,
            rounds=dev_result.rounds + self.host_rounds,
            event_log=dev_result.event_log + event_log,
            counters=counters,
            per_host_counters=per_host,
            process_errors=process_errors,
        )

    def _hybrid_loop(self, scheduler, on_window, t0) -> SimResult:
        state = self._window_loop(
            lambda until: self._service_round(scheduler, until), on_window
        )
        self.finalize()
        self.device._sync()
        wall = wall_time.perf_counter() - t0
        counters: dict[str, int] = {}
        for h in self.hosts:
            for k, v in h.counters.items():
                counters[k] = counters.get(k, 0) + v
        return self._collect(
            state, wall, self.event_log, counters,
            [dict(h.counters) for h in self.hosts],
            list(getattr(self, "process_errors", [])))


class MpHybridEngine(HybridEngine):
    """The hybrid backend with PARALLEL syscall service: N spawned worker
    processes own disjoint partitions of the external (managed) hosts and
    run their syscall plane concurrently (OS processes, no GIL), while the
    parent owns the device and the window law.

    The parent folds the workers' next event times (and the egressed
    deliveries in flight to them), computes every window, ships delivery
    rows to their owners and collects staged sends at each round barrier —
    one pipe message per worker per round each way, so the host<->device
    boundary stays as batched as the serial engine's.  Results are the
    same at every worker count; ``workers`` 1 is the serial engine (no
    pipes).  ``workers`` 0 takes one per core, at most one per managed
    host."""

    def __init__(
        self, cfg: ConfigOptions, workers: int = 0, device=None,
        log_capacity: Optional[int] = None,
    ) -> None:
        for hopt in cfg.hosts:
            if hopt.pcap_enabled:
                raise ValueError(
                    "MpHybridEngine does not support pcap capture (every "
                    "worker replica would open the capture files); use "
                    "the serial hybrid engine"
                )
        super().__init__(cfg, device=device, log_capacity=log_capacity)
        n_ext = len(self.external_hosts)
        self.workers = workers if workers > 0 else (os.cpu_count() or 1)
        self.workers = max(1, min(self.workers, n_ext))
        self._eff_next: Optional[list[int]] = None
        self._pending_rows: Optional[list[list]] = None
        self._owner_of: dict[int, int] = {}
        # deadline-bounded pipe reads: a dead or hung worker surfaces as a
        # WorkerDiedError, not a hang.  No respawn: a worker holds live
        # managed OS processes that cannot be moved
        self._heartbeat_s = float(cfg.experimental.worker_heartbeat_s)
        self._round_no = 0
        self.startup_s = 0.0  # spawn to every worker's replica built

    # -- parent-side bookkeeping -------------------------------------------

    def next_event_time(self) -> int:
        if self._eff_next is not None:
            return min(self._eff_next, default=NEVER)
        return super().next_event_time()

    def _route_delivery(self, t, src, dst, seq, size, payload) -> None:
        """Ship the delivery to the worker owning ``dst`` with the next
        round message; fold its time into that worker's next event time
        unless its replica consumes it inline (a passive delivery makes no
        queue event; the parent's replica knows which hosts are passive)."""
        if self._eff_next is None:
            # workers == 1: the serial loop runs the hosts in-process
            super()._route_delivery(t, src, dst, seq, size, payload)
            return
        w = self._owner_of[dst]
        self._pending_rows[w].append((t, src, dst, seq, size, payload))
        if not (payload is None and self.hosts[dst].passive_delivery):
            if t < self._eff_next[w]:
                self._eff_next[w] = t

    def _mp_round(self, window_end: int) -> None:
        """One parallel syscall-service round: ship (window_end, delivery
        rows, validation range end) to every worker, collect (next event
        time, staged sends, least used latency, cleanliness, peek) — one
        pipe message each way per worker.  The workers run concurrently
        between the two loops; staged sends merge in worker order, which
        the device merge's total key makes order-free anyway.  The
        workers' buffered perf lines print here, in worker order, before
        the round's ``[hybrid-agg]`` line."""
        t0 = wall_time.perf_counter()
        conns, procs = self._mp
        self._round_no += 1
        wf = self._fuse_we_final
        for w, conn in enumerate(conns):
            conn.send((
                "round", window_end, self._pending_rows[w],
                wf if wf is not None else window_end,
            ))
            self._pending_rows[w] = []
        t_ship = wall_time.perf_counter()
        staged = self._staged_merged
        perf_lines: list[str] = []
        clean = True
        for w, conn in enumerate(conns):
            next_t, out, mul, wlines, wclean, wpeek = recv_with_deadline(
                conn, procs[w], self._heartbeat_s, w, self._round_no, "round")
            perf_lines.extend(wlines)
            self._eff_next[w] = next_t
            if mul is not None and (
                self._min_used_lat is None or mul < self._min_used_lat
            ):
                self._min_used_lat = mul
            staged.extend(out)
            clean = clean and wclean
            if wpeek:
                self._worker_peeks[w] = wpeek
        self._round_clean = clean
        t1 = wall_time.perf_counter()
        self.sync_stats["syscall_service_s"] += t1 - t0
        obs = self.obs
        if obs is not None:
            # disjoint attribution: worker_pipe is the ship leg,
            # syscall_service the collect leg (the barrier wait that IS
            # the workers' execution wall); the two tile the round
            obs.record("worker_pipe", "pipe_ship", t0, t_ship - t0)
            obs.record("syscall_service", None, t_ship, t1 - t_ship,
                       window_end=window_end)
            obs.metrics.count("pipe_messages", 2 * len(conns))
        if self.perf_log is not None:
            self.perf_log.emit_many(perf_lines)
            self.perf_log.hybrid_agg("host", window_end, self.sync_stats)

    def _peek_partition(self, owned):
        """A partition's initial (head, horizon) peek from the parent's
        replica: the worker's own ``_peek_head_horizon`` over its hosts
        (the replicas agree by construction)."""
        return self._peek_head_horizon(
            self._ext_slots, [self.hosts[i] for i in owned]
        )

    def _peek_ext_times(self, floor_t: int = 0) -> list:
        """Merge the workers' peek schedules: the distinct times below the
        tightest worker horizon, padded with the merged horizon (past the
        least horizon the parent knows nothing).  Deliveries the parent
        has applied but not yet shipped (``_pending_rows``) are events the
        workers' schedules cannot show yet: their times fold in here, or
        the dispatch could free-run past a host event the serial law
        would have seen."""
        if self._eff_next is None:
            return super()._peek_ext_times(floor_t)
        es = self._ext_slots
        merged: set = set()
        wh = NEVER
        for head, hz in self._worker_peeks:
            for t in head:
                if t >= floor_t:
                    merged.add(t)
            if hz < wh:
                wh = hz
        for rows in self._pending_rows:
            for t, _src, dst, _seq, _size, payload in rows:
                if t >= floor_t and not (
                    payload is None and self.hosts[dst].passive_delivery
                ):
                    merged.add(t)
        times = sorted(t for t in merged if t < wh)
        head = times[: es - 1]
        horizon = times[es - 1] if len(times) >= es else wh
        return head + [horizon] * (es - len(head))

    # -- run ---------------------------------------------------------------

    def run(self, on_window=None) -> SimResult:
        if self.workers == 1:
            # one worker only adds pipes: run in-process, same results
            return super().run(on_window=on_window)
        from .cpu_mp import _partition, spawn_cpu_workers

        ext_ids = [h.host_id for h in self.external_hosts]
        parts = [
            [ext_ids[i] for i in p]
            for p in _partition(len(ext_ids), self.workers)
        ]
        self._owner_of = {
            hid: w for w, part in enumerate(parts) for hid in part
        }
        peek_slots = self._ext_slots if self._fuse_on else 0
        conns, procs = spawn_cpu_workers(
            _hybrid_worker_main,
            [(self.cfg, owned, peek_slots) for owned in parts],
        )
        self._mp = (conns, procs)
        self.worker_pids = [p.pid for p in procs]
        self._pending_rows = [[] for _ in range(self.workers)]
        # initial next event times and peeks from the parent's replica
        # (identical construction: no start-up round trip)
        self._eff_next = [
            min((self.hosts[i].queue.next_time() for i in owned),
                default=NEVER)
            for owned in parts
        ]
        if self._fuse_on:
            self._worker_peeks = [
                self._peek_partition(owned) for owned in parts
            ]
        try:
            # the workers' start-up (imports, replicas) is set-up, as the
            # serial engine's construction is: the run's wall starts after
            t_spawn = wall_time.perf_counter()
            for w, conn in enumerate(conns):
                recv_with_deadline(conn, procs[w], self._heartbeat_s, w, 0,
                                   "start")
            t0 = wall_time.perf_counter()
            self.startup_s = t0 - t_spawn
            return self._mp_loop(on_window, t0)
        finally:
            self._eff_next = None
            for conn in conns:
                conn.close()
            for p in procs:
                p.join(timeout=10)
                if p.is_alive():
                    p.terminate()
                    p.join(timeout=10)

    def _mp_loop(self, on_window, t0) -> SimResult:
        conns, procs = self._mp
        state = self._window_loop(self._mp_round, on_window)
        event_log: list = []
        counters: dict[str, int] = {}
        per_host: list[dict] = [{} for _ in range(len(self.hosts))]
        process_errors: list[str] = []
        for conn in conns:
            conn.send(("finish",))
        for w, conn in enumerate(conns):
            wlog, cnt, per, errs = recv_with_deadline(
                conn, procs[w], self._heartbeat_s, w, self._round_no,
                "finish")
            event_log.extend(wlog)
            for k, v in cnt.items():
                counters[k] = counters.get(k, 0) + v
            for hid, c in per.items():
                per_host[hid] = c
            process_errors.extend(errs)
        self.device._sync()
        wall = wall_time.perf_counter() - t0
        return self._collect(state, wall, event_log, counters, per_host,
                             process_errors)


def make_hybrid_engine(cfg: ConfigOptions, device=None,
                       log_capacity: Optional[int] = None) -> HybridEngine:
    """The hybrid engine the reference's facade picks for ``cfg``
    (``engine/sim.py``): the serial :class:`HybridEngine` at
    ``hybrid_workers`` 1, else :class:`MpHybridEngine` with that many
    workers (0: one per core)."""
    hw = cfg.experimental.hybrid_workers
    if hw != 1:
        return MpHybridEngine(cfg, workers=hw, device=device,
                              log_capacity=log_capacity)
    return HybridEngine(cfg, device=device, log_capacity=log_capacity)
