"""Simulation configuration: the YAML document shape of the JAX package,
trimmed to what the port reads.

    general:      { stop_time, seed, bootstrap_end_time, data_directory,
                    parallelism, heartbeat_interval,
                    model_unblocked_syscall_latency }
    network:      { graph: { type: gml|1_gbit_switch, file|inline }, ... }
    experimental: { runahead, use_dynamic_runahead, network_backend,
                    tpu_lane_queue_capacity, tpu_events_per_round,
                    tpu_cross_capacity, tpu_stream_tiered,
                    tpu_stream_events_per_round, tpu_stream_queue_capacity,
                    netobs, flowtrace, flowtrace_capacity, flowtrace_sample,
                    sweep_size, sweep_spec, mesh_devices,
                    scheduler, use_cpu_pinning, socket_send_buffer,
                    socket_recv_buffer, strace_logging_mode, use_seccomp,
                    use_vdso_patching, perf_logging, obs_turns, obs_trace,
                    hybrid_workers, hybrid_fuse_k, hybrid_async_dispatch,
                    tpu_inject_batch, dispatch_retry_max }
    faults:       { events: [ { at, kind, ... } ], watchdog_timeout,
                    failover }
    hosts:
      <hostname>:
        network_node_id: 0
        congestion: reno | cubic
        pcap_enabled: false
        pcap_capture_size: 65535
        processes: [ { path, args, environment, start_time,
                       shutdown_time, shutdown_signal,
                       expected_final_state } ]

A process whose ``path`` names no built-in model is a managed process: a
real binary that the hybrid engine (``backend/hybrid.py``) runs under the
LD_PRELOAD shim.

Unknown keys raise :class:`ConfigError`.  Settings the JAX package
accepts but the port cannot run yet (device-loop unrolling, the fault
watchdog and the CPU failover, the sweep command line's sweep_size > 1
and sweep_spec, more than one device, the observation of runs, and on a
hybrid run the fused law, worker processes and fault schedules) raise
:class:`LaneCompatError`, which names the JAX package as the way to run
them.  ``network_backend: tpu`` selects the lane backend, as there.

PyYAML is imported only by :meth:`ConfigOptions.from_yaml`; the presets
build their configs through :meth:`ConfigOptions.from_dict`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

from ..core import time as stime
from . import units


# socket buffer defaults, single-sourced for the config, the shim's
# shared-memory block and the managed-process manager
SOCKET_SEND_BUFFER_DEFAULT = 131072
SOCKET_RECV_BUFFER_DEFAULT = 174760


class ConfigError(ValueError):
    pass


class LaneCompatError(ConfigError):
    """A valid config that this slice of the port cannot run."""


@dataclasses.dataclass
class GeneralOptions:
    stop_time: int = 0  # ns; required > 0
    seed: int = 1
    bootstrap_end_time: int = 0  # ns; loss-free warm-up window (worker.rs:335)
    # where per-host output (pcap captures, managed processes' files) is
    # written
    data_directory: str = "shadow.data"
    # syscall-servicing threads of the CPU engines' host scheduler (0 = all
    # cores where managed processes run)
    parallelism: int = 0
    # the JAX package's progress heartbeat; accepted, the port prints none
    heartbeat_interval: Optional[int] = stime.NANOS_PER_SEC
    # managed processes: charge a modelled CPU latency to unblocked syscalls
    model_unblocked_syscall_latency: bool = False


@dataclasses.dataclass
class GraphOptions:
    type: str = "1_gbit_switch"  # "gml" | "1_gbit_switch"
    file_path: Optional[str] = None
    inline: Optional[str] = None


@dataclasses.dataclass
class NetworkOptions:
    graph: GraphOptions = dataclasses.field(default_factory=GraphOptions)
    use_shortest_path: bool = True


# experimental options this slice cannot run: name -> the value it can
_UNPORTED_EXPERIMENTAL = {
    "tpu_round_unroll": 1,
}


@dataclasses.dataclass
class ExperimentalOptions:
    runahead: Optional[int] = stime.NANOS_PER_MILLI  # lower bound, ns
    # the window widens to the smallest latency actually sent over so far,
    # never below the runahead floor (runahead.rs:44-118)
    use_dynamic_runahead: bool = False
    network_backend: str = "cpu"  # "cpu" | "tpu"
    tpu_lane_queue_capacity: int = 64  # per-host in-flight event slots (C)
    tpu_events_per_round: int = 8  # max pops per lane per iteration (K)
    # cross-lane receive block width per iteration (0 = queue capacity);
    # overflow is counted and strict mode raises, like queue overflow
    tpu_cross_capacity: int = 0
    # the TIERED stream backend for one-to-one stream configs (a dedicated
    # [2S]-row tier: kernels F and G); false runs them untiered (kernel E),
    # bit-identical in events
    tpu_stream_tiered: bool = True
    tpu_stream_events_per_round: int = 8  # tier pops per iteration (K_s)
    tpu_stream_queue_capacity: int = 64  # tier queue width (C2)
    # the netobs telemetry plane: per-host byte, throttle and shed counters
    # and the per-window packet-arrival histogram (GpuEngine.netobs_snapshot)
    netobs: bool = False
    # per-flow packet-lifecycle tracing of a seeded sample of the flows
    # (GpuEngine.flowtrace_snapshot): the device ring's rows (it never
    # wraps; overflow is counted) and the fraction of flows traced
    flowtrace: bool = False
    flowtrace_capacity: int = 65536
    flowtrace_sample: float = 1.0
    # the sweep command line's settings (sweep_size > 1: the seed grid
    # general.seed .. general.seed + sweep_size - 1; sweep_spec: a
    # sweep-spec YAML path).  Checked, then refused while that command
    # line is not ported: 0/1 and unset = no sweep
    sweep_size: int = 0
    sweep_spec: Optional[str] = None
    # devices to spread a run over (0 = one); the port runs on one card
    mesh_devices: int = 0
    # the CPU engines' host scheduler (thread-per-core: a pool of workers;
    # thread-per-host: one each) and its CPU pinning
    scheduler: str = "thread-per-core"
    use_cpu_pinning: bool = True
    # managed processes: socket buffer sizes, strace-style logging (off |
    # standard | deterministic) and the interposition backstops (the
    # seccomp trap for raw syscalls, vDSO patching for time reads)
    socket_send_buffer: int = SOCKET_SEND_BUFFER_DEFAULT  # bytes
    socket_recv_buffer: int = SOCKET_RECV_BUFFER_DEFAULT
    strace_logging_mode: str = "off"
    use_seccomp: bool = True
    use_vdso_patching: bool = True
    # the JAX package's observation of runs: per-window perf lines, the
    # device-turn ledger and the span tracer.  Not ported: true raises
    perf_logging: bool = False
    obs_turns: bool = False
    obs_trace: bool = False
    # the hybrid backend (backend/hybrid.py): managed hosts' syscalls on
    # the host CPU, every packet on the card.  The port runs the serial
    # engine (hybrid_workers 1) on the one-window law (hybrid_fuse_k 1,
    # the port's default; the JAX package's is 8, with the same events);
    # other values raise on a hybrid run.  tpu_inject_batch is B, the
    # rows of one injection block
    hybrid_workers: int = 1
    hybrid_fuse_k: int = 1
    hybrid_async_dispatch: bool = True
    tpu_inject_batch: int = 512
    dispatch_retry_max: int = 2


@dataclasses.dataclass
class FaultOptions:
    """The ``faults:`` section: a declarative fault schedule (raw event
    mappings, parsed by :meth:`schedule`) and the JAX package's
    graceful-degradation knobs, which the port refuses (:meth:`validate`
    of :class:`ConfigOptions`)."""

    failover: Optional[bool] = None
    watchdog_timeout: Optional[float] = None  # wall seconds
    events: list = dataclasses.field(default_factory=list)

    def schedule(self):
        """``events`` as a validated FaultSchedule (raises
        ``faults.FaultConfigError`` on malformed entries)."""
        from ..faults.schedule import FaultSchedule

        return FaultSchedule.parse(self.events)


@dataclasses.dataclass
class ProcessOptions:
    path: str = ""
    args: list[str] = dataclasses.field(default_factory=list)
    # managed processes: extra environment, a shutdown signal at
    # shutdown_time, and the state the process must end in
    environment: dict[str, str] = dataclasses.field(default_factory=dict)
    start_time: int = 0  # ns
    shutdown_time: Optional[int] = None
    shutdown_signal: str = "SIGTERM"
    expected_final_state: Any = "exited"  # {"exited": code}|"running"|{"signaled": sig}


@dataclasses.dataclass
class HostOptions:
    hostname: str = ""
    network_node_id: int = 0
    ip_addr: Optional[str] = None
    bandwidth_down: Optional[int] = None  # bits/sec; falls back to graph node
    bandwidth_up: Optional[int] = None
    processes: list[ProcessOptions] = dataclasses.field(default_factory=list)
    # congestion control of the host's stream flows (the data sender's)
    congestion: str = "reno"  # "reno" | "cubic"
    # capture the host's packets to <data_directory>/hosts/<name>/eth0.pcap
    pcap_enabled: bool = False
    pcap_capture_size: int = 65535  # snap length, bytes


@dataclasses.dataclass
class ConfigOptions:
    general: GeneralOptions = dataclasses.field(default_factory=GeneralOptions)
    network: NetworkOptions = dataclasses.field(default_factory=NetworkOptions)
    experimental: ExperimentalOptions = dataclasses.field(
        default_factory=ExperimentalOptions
    )
    faults: FaultOptions = dataclasses.field(default_factory=FaultOptions)
    hosts: list[HostOptions] = dataclasses.field(default_factory=list)

    # -- parsing ----------------------------------------------------------

    @classmethod
    def from_yaml(cls, text: str) -> "ConfigOptions":
        import yaml

        return cls.from_dict(yaml.safe_load(text))

    @classmethod
    def from_dict(cls, doc: dict[str, Any]) -> "ConfigOptions":
        if not isinstance(doc, dict):
            raise ConfigError("config must be a mapping")
        unknown = set(doc) - {
            "general", "network", "experimental", "faults",
            "host_option_defaults", "hosts",
        }
        if unknown:
            raise ConfigError(f"unknown top-level config keys: {sorted(unknown)}")

        gen_doc = dict(doc.get("general", {}))
        if "stop_time" not in gen_doc:
            raise ConfigError("general.stop_time is required")
        general = GeneralOptions(
            stop_time=units.parse_time(gen_doc.pop("stop_time")),
            seed=int(gen_doc.pop("seed", 1)),
            bootstrap_end_time=units.parse_time(gen_doc.pop("bootstrap_end_time", 0)),
            data_directory=str(gen_doc.pop("data_directory", "shadow.data")),
            parallelism=int(gen_doc.pop("parallelism", 0)),
            heartbeat_interval=_opt_time(gen_doc.pop("heartbeat_interval",
                                                     "1s")),
            model_unblocked_syscall_latency=bool(
                gen_doc.pop("model_unblocked_syscall_latency", False)),
        )
        if gen_doc:
            raise ConfigError(f"unknown general options: {sorted(gen_doc)}")

        net_doc = dict(doc.get("network", {}))
        graph_doc = dict(net_doc.pop("graph", {"type": "1_gbit_switch"}))
        gtype = graph_doc.pop("type", "gml")
        graph = GraphOptions(type=gtype)
        if gtype == "gml":
            sources = [k for k in ("file", "inline", "path") if k in graph_doc]
            if len(sources) > 1:
                raise ConfigError(
                    f"gml graph has conflicting sources: {sources}; give one"
                )
            if "file" in graph_doc:
                fd = graph_doc.pop("file")
                graph.file_path = fd["path"] if isinstance(fd, dict) else str(fd)
            elif "inline" in graph_doc:
                graph.inline = str(graph_doc.pop("inline"))
            elif "path" in graph_doc:
                graph.file_path = str(graph_doc.pop("path"))
            else:
                raise ConfigError("gml graph needs 'file' or 'inline'")
        elif gtype != "1_gbit_switch":
            raise ConfigError(f"unknown graph type {gtype!r}")
        if graph_doc:
            raise ConfigError(f"unknown network.graph options: {sorted(graph_doc)}")
        network = NetworkOptions(
            graph=graph,
            use_shortest_path=bool(net_doc.pop("use_shortest_path", True)),
        )
        if net_doc:
            raise ConfigError(f"unknown network options: {sorted(net_doc)}")

        exp_doc = dict(doc.get("experimental", {}))
        for name, runnable in _UNPORTED_EXPERIMENTAL.items():
            if name in exp_doc and exp_doc.pop(name) != runnable:
                raise LaneCompatError(
                    f"experimental.{name} is not ported yet (use the "
                    "shadow_tpu package)"
                )
        experimental = ExperimentalOptions()
        for f in dataclasses.fields(ExperimentalOptions):
            if f.name in exp_doc:
                v = exp_doc.pop(f.name)
                if f.name == "runahead":
                    v = None if v is None else units.parse_time(v)
                elif f.name in ("socket_send_buffer", "socket_recv_buffer"):
                    v = units.parse_bytes(v)
                setattr(experimental, f.name, v)
        if exp_doc:
            raise ConfigError(f"unknown experimental options: {sorted(exp_doc)}")

        f_doc = dict(doc.get("faults", {}) or {})
        failover = f_doc.pop("failover", None)
        wd = f_doc.pop("watchdog_timeout", None)
        faults = FaultOptions(
            failover=None if failover is None else bool(failover),
            watchdog_timeout=None if wd is None else float(wd),
            events=list(f_doc.pop("events", []) or []),
        )
        if f_doc:
            raise ConfigError(f"unknown faults options: {sorted(f_doc)}")

        defaults = dict(doc.get("host_option_defaults", {}))
        hosts: list[HostOptions] = []
        hosts_doc = doc.get("hosts", {})
        if not isinstance(hosts_doc, dict) or not hosts_doc:
            raise ConfigError("config must define at least one host")
        for name, h in sorted(hosts_doc.items()):
            merged = {**defaults, **(h or {})}
            count = int(merged.pop("count", 1))
            if count > 1 and merged.get("ip_addr") is not None:
                raise ConfigError(
                    f"host {name!r}: ip_addr cannot be combined with count > 1 "
                    "(the replicas would collide on the same IP)"
                )
            base = _parse_host(name, merged)
            if count == 1:
                hosts.append(base)
            else:
                for i in range(1, count + 1):
                    hosts.append(dataclasses.replace(
                        base,
                        hostname=f"{name}{i}",
                        processes=[
                            dataclasses.replace(
                                p, args=list(p.args),
                                environment=dict(p.environment))
                            for p in base.processes
                        ],
                    ))
        return cls(
            general=general, network=network, experimental=experimental,
            faults=faults, hosts=hosts,
        )

    # -- overrides --------------------------------------------------------

    _TIME_FIELDS = {"stop_time", "bootstrap_end_time", "runahead",
                    "heartbeat_interval"}

    def apply_overrides(self, overrides: dict[str, Any]) -> None:
        """Apply dotted-key overrides, e.g. ``{'general.seed': 7,
        'experimental.netobs': 'true'}``.  Values are coerced to the
        target field's type (they may arrive as strings)."""
        for key, value in overrides.items():
            section, _, field = key.partition(".")
            target = getattr(self, section, None)
            if target is None or not dataclasses.is_dataclass(target):
                raise ConfigError(f"unknown config option {key!r}")
            if field not in {f.name for f in dataclasses.fields(target)}:
                raise ConfigError(f"unknown config option {key!r}")
            if value is not None:
                current = getattr(target, field)
                if field in self._TIME_FIELDS:
                    value = units.parse_time(value)
                elif isinstance(current, bool):
                    value = (value if isinstance(value, bool)
                             else str(value).lower() in ("1", "true", "yes",
                                                         "on"))
                elif isinstance(current, int):
                    value = int(value)
                elif isinstance(current, float):
                    value = float(value)
            setattr(target, field, value)

    def validate(self) -> None:
        if self.general.stop_time <= 0:
            raise ConfigError("general.stop_time must be > 0")
        if self.experimental.network_backend not in ("cpu", "tpu"):
            raise ConfigError("experimental.network_backend must be cpu|tpu")
        if self.experimental.flowtrace_capacity < 1:
            raise ConfigError("experimental.flowtrace_capacity must be >= 1")
        if not 0.0 <= self.experimental.flowtrace_sample <= 1.0:
            raise ConfigError("experimental.flowtrace_sample must be in [0, 1]")
        if self.experimental.sweep_size < 0:
            raise ConfigError("experimental.sweep_size must be >= 0")
        if (self.experimental.sweep_spec is not None
                and not str(self.experimental.sweep_spec).strip()):
            raise ConfigError(
                "experimental.sweep_spec must be a spec file path (or unset)")
        if (self.experimental.sweep_size > 1
                or self.experimental.sweep_spec is not None):
            raise LaneCompatError(
                "experimental.sweep_size > 1 and experimental.sweep_spec are "
                "read by the sweep command line, which is not ported yet "
                "(ROADMAP item 3); build the variants with "
                "shadow_tpu_torch.sweep.expand_variants and run them with "
                "SweepEngine, or use the shadow_tpu package")
        if self.experimental.mesh_devices < 0:
            raise ConfigError(
                "experimental.mesh_devices must be >= 0 (0 = single-device)")
        if self.experimental.mesh_devices > 1:
            raise LaneCompatError(
                "experimental.mesh_devices > 1: the port runs on one card; "
                "spreading a run or a sweep over devices is not ported yet "
                "(ROADMAP item 14; use the shadow_tpu package)")
        if self.experimental.scheduler not in ("thread-per-core",
                                               "thread-per-host"):
            raise ConfigError(
                "experimental.scheduler must be thread-per-core|thread-per-host")
        if self.experimental.hybrid_fuse_k < 1:
            raise ConfigError("experimental.hybrid_fuse_k must be >= 1")
        if self.experimental.dispatch_retry_max < 0:
            raise ConfigError("experimental.dispatch_retry_max must be >= 0")
        for flag in ("perf_logging", "obs_turns", "obs_trace"):
            if getattr(self.experimental, flag):
                raise LaneCompatError(
                    f"experimental.{flag}: the observation of runs is not "
                    "ported yet (ROADMAP item 12; use the shadow_tpu package)")
        self._validate_faults()
        self._validate_hybrid()
        names = [h.hostname for h in self.hosts]
        if len(set(names)) != len(names):
            raise ConfigError("duplicate hostnames")
        for h in self.hosts:
            if h.congestion not in ("reno", "cubic"):
                raise ConfigError(
                    f"host {h.hostname!r}: congestion must be reno|cubic, "
                    f"got {h.congestion!r}"
                )


    def _validate_faults(self) -> None:
        f = self.faults
        if f.watchdog_timeout is not None and f.watchdog_timeout <= 0:
            raise ConfigError("faults.watchdog_timeout must be > 0 (wall seconds)")
        if f.watchdog_timeout is not None or f.failover:
            # both end in the CPU failover, which needs the host half
            raise LaneCompatError(
                "faults.watchdog_timeout and faults.failover: true are not "
                "ported yet: the CPU failover needs the host half (ROADMAP "
                "item 12; use the shadow_tpu package)")
        if f.events:
            from ..faults.schedule import FaultConfigError

            try:
                sched = f.schedule()
            except FaultConfigError as e:
                raise ConfigError(f"faults.events: {e}")
            for ev in sched.events:
                if ev.at < self.general.bootstrap_end_time:
                    raise ConfigError(
                        f"faults.events: {ev.kind} at {ev.at} ns lies inside "
                        "the loss-free bootstrap window "
                        f"(bootstrap_end_time={self.general.bootstrap_end_time} "
                        "ns); fault drops would be silently exempted"
                    )


    def _validate_hybrid(self) -> None:
        """A config with managed processes (real binaries) runs on the
        hybrid engine, which the port has on its serial, one-window law
        only, without fault schedules."""
        from ..models.base import config_has_managed

        if not config_has_managed(self):
            return
        exp = self.experimental
        if exp.hybrid_fuse_k >= 2:
            raise LaneCompatError(
                f"experimental.hybrid_fuse_k={exp.hybrid_fuse_k}: the port's "
                "hybrid engine runs the one-window law (hybrid_fuse_k: 1, the "
                "same events); the k-window fused law is not ported yet "
                "(ROADMAP item 12; use the shadow_tpu package)")
        if exp.hybrid_workers != 1:
            raise LaneCompatError(
                f"experimental.hybrid_workers={exp.hybrid_workers}: the port "
                "services managed hosts serially (hybrid_workers: 1); the "
                "syscall worker processes are not ported yet (ROADMAP item "
                "12; use the shadow_tpu package)")
        if self.faults.events:
            raise LaneCompatError(
                "faults.events on a hybrid run (backend_stall included): the "
                "port's hybrid engine has no fault schedule and no CPU "
                "failover yet (ROADMAP item 12; use the shadow_tpu package)")


def _opt_time(v: Any) -> Optional[int]:
    return None if v is None else units.parse_time(v)


def _parse_final_state(v: Any, host: str) -> Any:
    """Validate/normalize expected_final_state at parse time: "running",
    {exited: code}, or {signaled: SIG} (signal normalized like
    shutdown_signal) — a typo must fail the config, not the whole run."""
    if v in ("running", "exited"):
        return v
    if isinstance(v, dict) and len(v) == 1:
        if "exited" in v:
            return {"exited": int(v["exited"])}
        if "signaled" in v:
            return {"signaled": _parse_signal(v["signaled"], host)}
        if "running" in v:
            return "running"
    raise ConfigError(
        f"host {host!r}: expected_final_state must be 'running', "
        f"{{exited: CODE}}, or {{signaled: SIG}}; got {v!r}"
    )


def _parse_signal(v: Any, host: str) -> str:
    """Validate a signal name (or number) at parse time — a typo'd
    shutdown_signal must not silently become SIGTERM."""
    import signal as _sig

    if isinstance(v, int):
        try:
            return _sig.Signals(v).name
        except ValueError:
            raise ConfigError(f"host {host!r}: unknown signal number {v}")
    name = str(v).upper()
    if not name.startswith("SIG"):
        name = "SIG" + name
    if not hasattr(_sig, name) or not isinstance(getattr(_sig, name), _sig.Signals):
        raise ConfigError(f"host {host!r}: unknown shutdown_signal {v!r}")
    return name


def _parse_host(name: str, doc: dict[str, Any]) -> HostOptions:
    doc = dict(doc)
    procs = []
    for p in doc.pop("processes", []):
        p = dict(p)
        args = p.pop("args", [])
        if isinstance(args, str):
            args = args.split()
        procs.append(
            ProcessOptions(
                path=str(p.pop("path")),
                args=[str(a) for a in args],
                environment={str(k): str(v)
                             for k, v in p.pop("environment", {}).items()},
                start_time=units.parse_time(p.pop("start_time", 0)),
                shutdown_time=_opt_time(p.pop("shutdown_time", None)),
                shutdown_signal=_parse_signal(
                    p.pop("shutdown_signal", "SIGTERM"), name),
                expected_final_state=_parse_final_state(
                    p.pop("expected_final_state", {"exited": 0}), name),
            )
        )
        if p:
            raise ConfigError(f"unknown process options on host {name!r}: {sorted(p)}")
    bw_down = doc.pop("bandwidth_down", None)
    bw_up = doc.pop("bandwidth_up", None)
    host = HostOptions(
        hostname=name,
        network_node_id=int(doc.pop("network_node_id", 0)),
        ip_addr=doc.pop("ip_addr", None),
        bandwidth_down=units.parse_bandwidth(bw_down) if bw_down is not None else None,
        bandwidth_up=units.parse_bandwidth(bw_up) if bw_up is not None else None,
        processes=procs,
        congestion=str(doc.pop("congestion", "reno")),
        pcap_enabled=bool(doc.pop("pcap_enabled", False)),
        pcap_capture_size=units.parse_bytes(doc.pop("pcap_capture_size", 65535)),
    )
    if doc:
        raise ConfigError(f"unknown host options on {name!r}: {sorted(doc)}")
    return host
