"""Hybrid backend: managed (real-binary) hosts riding the card's data plane.

The JAX package's ``backend/hybrid.py`` on the port, serial and on the
one-window law: "keep syscall emulation on host CPU, offload the per-round
packet-scheduling hot path".  Hosts whose processes are real managed
binaries run on the host CPU exactly as in :class:`CpuEngine` (under the
LD_PRELOAD shim, ``native/process.py``), while the network data plane —
per-lane arrival queues, latency and loss lookup, token buckets, CoDel,
and every lane-model host — runs on the device (``backend/lanes.py``, the
CUDA kernels of ``csrc/lanes.cu``).  The seam mirrors the reference's
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
  C's hybrid mode folds the host side's next event time into every window
  start, free-runs the windows the host takes no part in, and stops after
  completing the first one it does — one device turn per host sync, not
  one per round.

Per turn the boundary costs one H2D copy of the staged injection blocks
(none when nothing was staged), one D2H copy of the packed ``[5]`` int64
readback (more only on long turns: ``lanes.HYBRID_CHECKS``) and one D2H
copy of the egress slice (none when it is empty); ``sync_stats`` counts
the reference's transfers, so the two compare equal.

Not ported here (ROADMAP item 12, each refused with ``LaneCompatError`` by
``ConfigOptions.validate``): the k-window fused law (``hybrid_fuse_k`` >=
2) with its eager dispatch, the syscall worker processes
(``hybrid_workers`` != 1), the turn ledger, perf logging and the tracer,
and fault schedules with the CPU failover.
"""

from __future__ import annotations

import time as wall_time
from typing import Optional

import numpy as np
import torch

from ..config.options import ConfigOptions, LaneCompatError
from ..core import time as stime
from ..core.event import Event, EventKind
from ..core.event_queue import EventQueue
from ..models.base import config_has_managed  # noqa: F401  (the entry's test)
from . import lanes
from .cpu_engine import DELIVERED, CpuEngine, Delivery, Host, SimResult

NEVER = stime.NEVER


class _HostSideHybrid(CpuEngine):
    """The host-side half of the hybrid seam: external-host bookkeeping,
    the staging send sink and the delivery law.  Construction reuses
    ``CpuEngine.__init__`` wholesale (hosts, apps, pcap, hosts file,
    routing: one source of truth); ``_hybrid_host_init`` then strips the
    lane-covered hosts' host-side state."""

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
        # barrier sweeps: every external host
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
        # host<->device sync-cost accounting (the reference's counters of
        # the one-window law)
        self.sync_stats: dict = {
            "device_turns": 0,      # hybrid_run calls
            "device_sync_s": 0.0,   # blocking device-turn wall time
            "syscall_service_s": 0.0,  # host-side window execution wall
            "scalar_reads": 0,      # D2H transfers: packed scalar vectors
            "inject_blocks": 0,     # H2D transfers: injection blocks
            "inject_rows": 0,       # staged sends carried by those blocks
            "inject_bytes": 0,      # H2D bytes (7 arrays x B rows)
            "egress_reads": 0,      # D2H transfers: egress buffer slices
            "egress_rows": 0,       # delivery rows carried by those reads
            "egress_bytes": 0,      # D2H bytes (padded [span, 6] int64)
        }

    # -- dynamic runahead ---------------------------------------------------

    def current_runahead(self) -> int:
        """The global dynamic-runahead law: min over BOTH sides' smallest
        used latency (the device's is read back after every device turn;
        between turns it cannot change)."""
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
        if self._inj_dev is None:
            return host
        blocks = self._inj_dev[:n_blk]
        blocks.copy_(host, non_blocking=True)
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
        return state.egress[:span].cpu()[:count].tolist()

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
        ext_used = (
            lanes.NEVER32 if self._min_used_lat is None else self._min_used_lat
        )
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
            self._apply_egress(self._read_egress(
                state, sc[lanes.HYB_EGRESS_COUNT], sc[lanes.HYB_EGRESS_LOST]))
            if lane_min >= dev_we:
                return lane_min, dev_we
            # mid-window pause (egress headroom): drain and resume, with
            # nothing to inject
            inj = None
            host_next = next_host_fn()

    # -- the window law -------------------------------------------------------

    def _service_round(self, scheduler, until: int) -> None:
        """One host-side syscall-service round and barrier, timed into
        sync_stats."""
        t0 = wall_time.perf_counter()
        scheduler.run_round(until)
        self._barrier_merge()
        self.sync_stats["syscall_service_s"] += wall_time.perf_counter() - t0

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
        """The hybrid window law on the one-window law (the reference's
        ``_window_loop`` at ``hybrid_fuse_k`` 1): a device turn completes
        every window up to and including the first one the host takes
        part in; a window the device is idle through, with nothing staged,
        is a host-only round.  Returns the final device state."""
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

    def _hybrid_loop(self, scheduler, on_window, t0) -> SimResult:
        state = self._window_loop(
            lambda until: self._service_round(scheduler, until), on_window
        )
        self.finalize()
        self.device._sync()
        wall = wall_time.perf_counter() - t0

        dev_result = self.device.collect(state, wall)
        counters: dict[str, int] = dict(dev_result.counters)
        for h in self.hosts:
            for k, v in h.counters.items():
                counters[k] = counters.get(k, 0) + v
        return SimResult(
            sim_time_ns=self.stop_time,
            wall_seconds=wall,
            rounds=dev_result.rounds + self.host_rounds,
            event_log=dev_result.event_log + self.event_log,
            counters=counters,
            per_host_counters=[dict(h.counters) for h in self.hosts],
            process_errors=list(getattr(self, "process_errors", [])),
        )
