"""CPU engine: the scalar implementation of the simulation, host by host.

The JAX package's ``backend/cpu_engine.py``, copied into the port (plain
Python and numpy, no JAX, no torch op per event): the structural analog of
the reference's Controller/Manager/Host round loop (controller.rs:81-113,
manager.rs:541-770, host.rs:762-830), collapsed into one process — rounds
advance all hosts over a conservative lookahead window, and cross-host
packets land in the destination's event queue for later windows.

It is the port's all-host-side oracle (``chip_smoke.py`` holds the card's
runs against it on a machine without JAX) and the base class of the
hybrid engine's host side (``backend/hybrid.py``), whose managed hosts run
real binaries under the LD_PRELOAD shim (``native/process.py``).  The
observation planes (netobs, flowtrace), fault schedules, checkpoints and
the run-control hooks of the JAX package's copy are not ported here: a
config that asks for them raises :class:`LaneCompatError`.
"""

from __future__ import annotations

import dataclasses
import time as wall_time
from typing import Optional

from ..config.options import ConfigOptions, LaneCompatError
from ..core import rng as rng_mod
from ..core import time as stime
from ..core.event import Event, EventKind, Task
from ..core.event_queue import EventQueue
from ..models import phold as _phold  # noqa: F401  (register built-ins)
from ..models import tcpflow as _tcpflow  # noqa: F401
from ..models import tgen as _tgen  # noqa: F401
from ..models import tgen_tcp as _tgen_tcp  # noqa: F401
from ..models.base import create_model
from ..net.codel import CoDel
from ..net.stack import TcpSegment as _TcpSegment
from ..net.token_bucket import (
    FRAME_OVERHEAD_BYTES,
    TokenBucket,
    bucket_params,
)
from .results import (  # noqa: F401  (the reference's names, re-exported)
    DELIVERED,
    DROP_CODEL,
    DROP_LOSS,
    DROP_QUEUE,
    LogRecord,
    SimResult,
)

OUTCOME_NAMES = {0: "delivered", 1: "loss", 2: "codel", 3: "queue"}

# the loopback interface's fixed one-way delay (the reference gives every
# host a localhost/internet interface pair, namespace.rs:25-60; here lo
# is a latency-only serial law: no token buckets, no CoDel, no loss —
# self-addressed 127/8 traffic from managed stacks rides it)
LOOPBACK_LATENCY_NS = 10_000
LOOPBACK_IP = "127.0.0.1"


@dataclasses.dataclass
class Delivery:
    """Payload of a LOCAL delivery event (step 6 of the lifecycle).

    ``payload`` is opaque engine-side cargo (managed processes ride their
    datagram bytes + ports here); it never affects event ordering or the
    event log, which record sizes only."""

    src: int
    seq: int
    size: int
    payload: object = None


class Host:
    """Per-host state: queue, buckets, CoDel, RNG counters, app models."""

    def __init__(
        self,
        host_id: int,
        hostname: str,
        engine: "CpuEngine",
        bw_up_bps: int,
        bw_down_bps: int,
    ) -> None:
        self.host_id = host_id
        self.hostname = hostname
        self.engine = engine
        self.queue = EventQueue()
        up_rate, up_burst = bucket_params(bw_up_bps)
        dn_rate, dn_burst = bucket_params(bw_down_bps)
        self.up_bucket = TokenBucket(rate=up_rate, burst=up_burst)
        self.down_bucket = TokenBucket(rate=dn_rate, burst=dn_burst)
        self.codel = CoDel()
        self.pcap = None  # PcapWriter when HostOptions.pcap_enabled
        # cross-host packet inbox: worker threads of OTHER hosts append
        # here under the lock; drained into the queue at the round barrier
        # (the push_packet_to_host discipline, worker.rs:603-615)
        import threading

        self.inbox: list = []
        self.inbox_lock = threading.Lock()
        # per-host event-log buffer + min-used-latency, merged at the
        # barrier in host-id order so results are worker-count-invariant
        self.log_buf: list = []
        self.min_used_lat: Optional[int] = None
        self.send_seq = 0  # per-host packet counter (RNG counter + FIFO prio)
        self.local_seq = 0  # per-host local-event counter
        self.app_draws = 0  # APP_STREAM counter
        self.apps: list = []
        self.counters: dict[str, int] = {}
        self.now = 0  # current event time while executing
        self._net = None  # lazy HostNetStack (TCP tier)
        self._passive = None  # lazy: all apps passive_delivery (or no apps)

    # -- HostApi ----------------------------------------------------------

    @property
    def num_hosts(self) -> int:
        return len(self.engine.hosts)

    def send(self, dst: int, size_bytes: int, payload: object = None,
             loopback: bool = False, retx: bool = False) -> int:
        return self.engine.send_packet(self, dst, size_bytes, payload,
                                       loopback=loopback, retx=retx)

    def set_timer(self, t_abs_ns: int) -> None:
        app = self._current_app

        def fire(h: "Host", a=app) -> None:
            h._current_app = a
            a.on_timer(h, h.now)

        # strictly future: a timer armed for "now" (or the past) would pop in
        # the same window at the same instant and can live-lock the round
        self.push_local(max(t_abs_ns, self.now + 1), Task(fire, label="timer"))

    def set_timer_relative(self, delta_ns: int) -> None:
        self.set_timer(self.now + delta_ns)

    def schedule_at(self, t_abs_ns: int, fn) -> None:
        """Exact-time local event (``fn(host)``), the scalar twin of the
        lane backend's arm channels: unlike ``set_timer`` it may land at
        the current instant (pump events pop later in the same window, in
        (time, kind, src, seq) order)."""
        self.push_local(max(t_abs_ns, self.now), Task(fn, label="app"))

    def resolve(self, hostname: str) -> int:
        return self.engine.resolve(hostname)

    def ip_of(self, host_id: int) -> str:
        return self.engine.ips.by_host[host_id]

    @property
    def hosts_file_path(self):
        return self.engine.hosts_file_path

    @property
    def passive_delivery(self) -> bool:
        """True when every app's delivery handling is counters-only (or the
        host has no apps): plain-model deliveries are then applied inline at
        packet arrival and the DELIVERY queue event is elided — identical
        elision on the lane backend keeps the backends bit-compatible."""
        if self._passive is None:
            self._passive = all(
                getattr(a, "passive_delivery", False) for a in self.apps
            )
        return self._passive

    @property
    def net(self):
        """The host's transport stack (TCP sockets over the packet path)."""
        if self._net is None:
            from ..net.stack import HostNetStack

            self._net = HostNetStack(self)
        return self._net

    @property
    def data_directory(self) -> str:
        return self.engine.cfg.general.data_directory

    @property
    def master_seed(self) -> int:
        return self.engine.seed

    def rand_u32(self) -> int:
        v = rng_mod.rand_u32_int(
            self.engine.seed, self.host_id | rng_mod.APP_STREAM,
            self.app_draws,
        )
        self.app_draws += 1
        return v

    def count(self, key: str, n: int = 1) -> None:
        self.counters[key] = self.counters.get(key, 0) + n

    # -- engine side ------------------------------------------------------

    def push_local(self, t: int, task: Task) -> None:
        self.queue.push(
            Event(t, EventKind.LOCAL, src_host=self.host_id, seq=self.local_seq, data=task)
        )
        self.local_seq += 1

    def execute(self, until: int) -> None:
        """Pop and run all events < until (Host::execute, host.rs:762-803)."""
        while True:
            ev = self.queue.peek()
            if ev is None or ev.time >= until:
                return
            ev = self.queue.pop()
            self.now = ev.time
            self._dispatch(ev)

    def _dispatch(self, ev) -> None:
        if ev.kind == EventKind.PACKET:
            self.engine.inbound(self, ev)
        elif ev.kind == EventKind.DELIVERY:
            data = ev.data
            if isinstance(data.payload, _TcpSegment):
                self.net.on_segment(ev.time, data.payload)
            else:
                for app in self.apps:
                    self._current_app = app
                    app.on_delivery(
                        self, ev.time, data.src, data.seq, data.size,
                        payload=data.payload,
                    )
        else:
            ev.data.execute(self)

    _current_app = None


class CpuEngine:
    """Build hosts from a config and run the round loop."""

    def __init__(self, cfg: ConfigOptions) -> None:
        cfg.validate()
        exp = cfg.experimental
        for flag in ("netobs", "flowtrace"):
            if getattr(exp, flag):
                raise LaneCompatError(
                    f"experimental.{flag} on the port's CPU engine (and so on "
                    "its hybrid engine's host side) is not ported yet "
                    "(ROADMAP item 12; use the shadow_tpu package)")
        if cfg.faults.events:
            raise LaneCompatError(
                "fault schedules on the port's CPU engine (and so on a "
                "hybrid run) are not ported yet (ROADMAP item 12; use the "
                "shadow_tpu package)")
        self.cfg = cfg
        self.seed = cfg.general.seed
        self.stop_time = cfg.general.stop_time
        self.bootstrap_end = cfg.general.bootstrap_end_time

        from .setup import build_world

        # kept whole for engines that layer on top (backend/hybrid.py
        # hands it to its GpuEngine so topology/routing build once)
        self.world = build_world(cfg)
        (
            self.graph,
            self.ips,
            self.dns,
            self.routing,
            bw_up_arr,
            bw_dn_arr,
            self.runahead,
        ) = self.world
        self.node_index = self.routing.host_node_index
        # dynamic runahead (runahead.rs:44-118): the window may widen to the
        # smallest latency actually used so far (>= the static minimum);
        # packets record their path latency as they are sent
        self.dynamic_runahead = cfg.experimental.use_dynamic_runahead
        self._min_used_lat: Optional[int] = None
        self._runahead_floor = max(cfg.experimental.runahead or 0, 1)
        self.hosts = [
            Host(hid, hopt.hostname, self, int(bw_up_arr[hid]), int(bw_dn_arr[hid]))
            for hid, hopt in enumerate(cfg.hosts)
        ]

        # app models scheduled at their start times
        from ..native.process import ManagedApp as _ManagedApp

        for hid, hopt in enumerate(cfg.hosts):
            host = self.hosts[hid]
            for p in hopt.processes:
                app = create_model(p.path, list(p.args), dict(p.environment))
                if hasattr(app, "set_congestion"):
                    app.set_congestion(hopt.congestion)
                host.apps.append(app)
                host.push_local(
                    p.start_time, Task(lambda h, a=app: _start_app(h, a), label="start")
                )
                if isinstance(app, _ManagedApp):
                    app.configure_lifecycle(p.expected_final_state, p.shutdown_signal)
                    if p.shutdown_time is not None:
                        host.push_local(
                            p.shutdown_time,
                            Task(
                                lambda h, a=app: a.deliver_shutdown(h),
                                label="shutdown",
                            ),
                        )

        # per-host pcap capture (interface.rs:45-75; host option
        # pcap_enabled, configuration.rs:602-612)
        if any(h.pcap_enabled for h in cfg.hosts):
            from pathlib import Path as _Path

            from ..utils.pcap import PcapWriter

            for hid, hopt in enumerate(cfg.hosts):
                if hopt.pcap_enabled:
                    self.hosts[hid].pcap = PcapWriter(
                        _Path(cfg.general.data_directory)
                        / "hosts" / hopt.hostname / "eth0.pcap",
                        snaplen=hopt.pcap_capture_size,
                    )

        # managed (real-binary) processes resolve simulated names through an
        # /etc/hosts-style file (the reference passes plugins a memfd hosts
        # file, dns.rs:130-190); written once per run, only when needed
        from pathlib import Path

        from ..native.process import ManagedApp

        self.hosts_file_path = None
        if any(isinstance(a, ManagedApp) for h in self.hosts for a in h.apps):
            self.hosts_file_path = self.dns.write_hosts_file(
                Path(cfg.general.data_directory) / "etc-hosts"
            )

        self.event_log: list[LogRecord] = []
        self.window_end = 0
        self.rounds = 0

    # -- DNS (network/dns.rs) ----------------------------------------------

    def resolve(self, hostname: str) -> int:
        return self.dns.resolve(hostname)

    # -- packet path (SEMANTICS.md lifecycle) ------------------------------

    def _packet_source_half(
        self, src_host: Host, dst: int, size_bytes: int, payload: object,
        retx: bool = False,
    ) -> tuple[int, Optional[int]]:
        """The source half of the packet lifecycle (steps 1-4: seq, up
        bucket, outbound pcap, dynamic-runahead record, Bernoulli loss,
        arrival-time bump).  Returns ``(seq, arrival_time)`` — arrival is
        ``None`` when the packet was lost.  Shared verbatim by the CPU
        push sink below and the hybrid backend's device-injection sink
        (backend/hybrid.py), so the law cannot drift between them.
        (``retx``, a retransmitted stream segment, only matters to the
        flowtrace plane, which this engine does not run.)"""
        t = src_host.now
        seq = src_host.send_seq
        src_host.send_seq += 1
        s, d = src_host.host_id, dst

        bits = (size_bytes + FRAME_OVERHEAD_BYTES) * 8
        t_dep = src_host.up_bucket.charge(t, bits)

        if src_host.pcap is not None:  # outbound capture at departure
            src_host.pcap.capture(
                stime.sim_to_emu(t_dep), self.ips.by_host[s],
                self.ips.by_host[d], size_bytes, payload,
                key=(1, s, d, seq),
            )

        # loss (skipped during bootstrap)
        lat_ns, thresh = self.routing.path(s, d)
        if self.dynamic_runahead and (
            src_host.min_used_lat is None or lat_ns < src_host.min_used_lat
        ):
            src_host.min_used_lat = lat_ns
        if t >= self.bootstrap_end and thresh > 0:
            u = rng_mod.rand_u32_int(self.seed, s | rng_mod.LOSS_STREAM, seq)
            if u < thresh:
                src_host.log_buf.append(LogRecord(t, s, d, seq, size_bytes, DROP_LOSS))
                return seq, None

        return seq, max(t_dep + lat_ns, self.window_end)

    def send_packet(
        self, src_host: Host, dst: int, size_bytes: int,
        payload: object = None, loopback: bool = False, retx: bool = False,
    ) -> int:
        if loopback:
            return self._loopback_send(src_host, size_bytes, payload)
        seq, arr = self._packet_source_half(src_host, dst, size_bytes, payload,
                                            retx=retx)
        if arr is None:
            return seq
        ev = Event(
            arr, EventKind.PACKET, src_host=src_host.host_id, seq=seq,
            data=(size_bytes, payload),
        )
        dst_host = self.hosts[dst]
        if dst_host is src_host:
            dst_host.queue.push(ev)  # self-traffic never crosses threads
        else:
            with dst_host.inbox_lock:
                dst_host.inbox.append(ev)
        return seq

    def _loopback_send(self, host: Host, size_bytes: int,
                       payload: object) -> int:
        """The lo interface: self-addressed (127/8) traffic takes a
        dedicated serial lifecycle — fixed LOOPBACK_LATENCY_NS, no token
        buckets, no CoDel, no loss draw (the localhost half of the
        reference's per-host interface pair, namespace.rs:25-60).  The
        delivery never leaves the host, so it works identically under
        the threaded and the hybrid engines."""
        seq = host.send_seq
        host.send_seq += 1
        t_deliver = host.now + LOOPBACK_LATENCY_NS
        host.log_buf.append(
            LogRecord(t_deliver, host.host_id, host.host_id, seq,
                      size_bytes, DELIVERED)
        )
        if host.pcap is not None:
            host.pcap.capture(
                stime.sim_to_emu(t_deliver), LOOPBACK_IP, LOOPBACK_IP,
                size_bytes, payload,
                key=(0, host.host_id, host.host_id, seq),
            )
        host.queue.push(
            Event(
                t_deliver,
                EventKind.DELIVERY,
                src_host=host.host_id,
                seq=seq,
                data=Delivery(host.host_id, seq, size_bytes, payload),
            )
        )
        return seq

    def inbound(self, dst_host: Host, ev: Event) -> None:
        """Steps 5a-5c: down bucket, CoDel, schedule delivery."""
        size_bytes, payload = ev.data
        bits = (size_bytes + FRAME_OVERHEAD_BYTES) * 8
        t_deliver = dst_host.down_bucket.charge(ev.time, bits)
        sojourn = t_deliver - ev.time
        if dst_host.codel.offer(t_deliver, sojourn):
            dst_host.log_buf.append(
                LogRecord(t_deliver, ev.src_host, dst_host.host_id, ev.seq, size_bytes, DROP_CODEL)
            )
            return
        dst_host.log_buf.append(
            LogRecord(t_deliver, ev.src_host, dst_host.host_id, ev.seq, size_bytes, DELIVERED)
        )
        if dst_host.pcap is not None:  # inbound capture at delivery
            dst_host.pcap.capture(
                stime.sim_to_emu(t_deliver), self.ips.by_host[ev.src_host],
                self.ips.by_host[dst_host.host_id], size_bytes, payload,
                key=(0, ev.src_host, dst_host.host_id, ev.seq),
            )
        if payload is None and dst_host.passive_delivery:
            # passive fast path: counters apply now; no DELIVERY event.
            # now anchors at delivery time so even a contract-violating app
            # behaves like the queued path (the pop loop reassigns now per
            # event, so this is safe)
            dst_host.now = t_deliver
            for app in dst_host.apps:
                dst_host._current_app = app
                app.on_delivery(
                    dst_host, t_deliver, ev.src_host, ev.seq, size_bytes,
                    payload=None,
                )
            return
        dst_host.queue.push(
            Event(
                t_deliver,
                EventKind.DELIVERY,
                src_host=ev.src_host,
                seq=ev.seq,
                data=Delivery(ev.src_host, ev.seq, size_bytes, payload),
            )
        )

    # -- round loop (controller.rs:88-113 + manager.rs:541) ----------------

    def next_event_time(self) -> int:
        return min((h.queue.next_time() for h in self.hosts), default=stime.NEVER)

    def _barrier_merge(self) -> None:
        """Round barrier: drain cross-host inboxes into queues, merge
        per-host log buffers and min-used latencies — all in host-id order
        so any worker count produces identical results."""
        for h in self.hosts:
            if h.inbox:
                for ev in h.inbox:
                    h.queue.push(ev)
                h.inbox.clear()
            if h.log_buf:
                self.event_log.extend(h.log_buf)
                h.log_buf.clear()
            if h.min_used_lat is not None:
                if self._min_used_lat is None or h.min_used_lat < self._min_used_lat:
                    self._min_used_lat = h.min_used_lat
                h.min_used_lat = None

    def current_runahead(self) -> int:
        """Window width for the next round.  Static mode: the precomputed
        min possible latency.  Dynamic mode: the min latency of paths used
        so far (never below the configured floor) — wider windows while
        only slow paths carry traffic, exactly the reference's
        use_dynamic_runahead law (runahead.rs:44-57)."""
        if not self.dynamic_runahead or self._min_used_lat is None:
            return self.runahead
        return max(self._min_used_lat, self._runahead_floor, 1)

    def finalize(self) -> None:
        """End-of-simulation teardown: reap managed processes still parked
        past stop_time (the reference kills plugins at teardown too,
        manager.rs end-of-sim), then check every process's final state
        against expected_final_state (worker.rs:475-481)."""
        for h in self.hosts:
            for app in h.apps:
                shutdown = getattr(app, "shutdown", None)
                if shutdown is not None:
                    shutdown()
            if h.pcap is not None:
                h.pcap.close()
        self.process_errors = []
        for h in self.hosts:
            for app in h.apps:
                check = getattr(app, "final_state_matches", None)
                if check is not None:
                    err = check()
                    if err is not None:
                        self.process_errors.append(f"host {h.hostname}: {err}")

    def run(self, on_window=None) -> SimResult:
        """Round loop.  ``on_window(window_start, window_end,
        next_event_time)`` runs after every round."""
        from ..engine.scheduler import HostScheduler
        from ..native.process import ManagedApp

        exp = self.cfg.experimental
        parallelism = self.cfg.general.parallelism
        if parallelism == 0 and exp.scheduler != "thread-per-host":
            # default "all cores" engages only where threads can help:
            # managed OS processes (futex waits release the GIL); pure
            # Python model hosts run serial to skip pool overhead
            has_managed = any(
                isinstance(a, ManagedApp) for h in self.hosts for a in h.apps
            )
            parallelism = 0 if has_managed else 1
        scheduler = HostScheduler(
            self.hosts,
            parallelism=parallelism,
            policy=exp.scheduler,
            pin_cpus=exp.use_cpu_pinning,
        )
        try:
            return self._run_rounds(scheduler, on_window)
        finally:
            scheduler.shutdown()

    def _run_rounds(self, scheduler, on_window) -> SimResult:
        t0 = wall_time.perf_counter()
        try:
            return self._round_loop(scheduler, on_window, t0)
        except BaseException:
            # a failing round must still reap managed OS processes (and
            # their fork children) — no orphans outlive the simulation
            self.finalize()
            raise

    def _round_loop(self, scheduler, on_window, t0) -> SimResult:
        while True:
            start = self.next_event_time()
            if start >= self.stop_time or start == stime.NEVER:
                break
            self.window_end = min(start + self.current_runahead(), self.stop_time)
            scheduler.run_round(self.window_end)
            self._barrier_merge()
            self.rounds += 1
            if on_window is not None:
                on_window(start, self.window_end, self.next_event_time())
        self.finalize()
        wall = wall_time.perf_counter() - t0

        counters: dict[str, int] = {}
        for h in self.hosts:
            for k, v in h.counters.items():
                counters[k] = counters.get(k, 0) + v
        return SimResult(
            sim_time_ns=self.stop_time,
            wall_seconds=wall,
            rounds=self.rounds,
            event_log=self.event_log,
            counters=counters,
            per_host_counters=[dict(h.counters) for h in self.hosts],
            process_errors=list(getattr(self, "process_errors", [])),
        )


def _start_app(host: Host, app) -> None:
    host._current_app = app
    app.on_start(host)
