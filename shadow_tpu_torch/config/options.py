"""Simulation configuration: the YAML document shape of the JAX package,
trimmed to what the ported lane path reads.

    general:      { stop_time, seed, bootstrap_end_time }
    network:      { graph: { type: gml|1_gbit_switch, file|inline }, ... }
    experimental: { runahead, use_dynamic_runahead, network_backend,
                    tpu_lane_queue_capacity, tpu_events_per_round,
                    tpu_cross_capacity, tpu_stream_tiered,
                    tpu_stream_events_per_round, tpu_stream_queue_capacity }
    hosts:
      <hostname>:
        network_node_id: 0
        congestion: reno | cubic
        processes: [ { path, args, start_time } ]

Unknown keys raise :class:`ConfigError`.  Settings the JAX package
accepts but the port cannot run yet (fault schedules, pcap capture,
netobs, flowtrace, device-loop unrolling) raise
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


class ConfigError(ValueError):
    pass


class LaneCompatError(ConfigError):
    """A valid config that this slice of the port cannot run."""


@dataclasses.dataclass
class GeneralOptions:
    stop_time: int = 0  # ns; required > 0
    seed: int = 1
    bootstrap_end_time: int = 0  # ns; loss-free warm-up window (worker.rs:335)


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
    "netobs": False,
    "flowtrace": False,
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


@dataclasses.dataclass
class ProcessOptions:
    path: str = ""
    args: list[str] = dataclasses.field(default_factory=list)
    start_time: int = 0  # ns


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


@dataclasses.dataclass
class ConfigOptions:
    general: GeneralOptions = dataclasses.field(default_factory=GeneralOptions)
    network: NetworkOptions = dataclasses.field(default_factory=NetworkOptions)
    experimental: ExperimentalOptions = dataclasses.field(
        default_factory=ExperimentalOptions
    )
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
                setattr(experimental, f.name, v)
        if exp_doc:
            raise ConfigError(f"unknown experimental options: {sorted(exp_doc)}")

        if (doc.get("faults") or {}).get("events"):
            raise LaneCompatError(
                "fault schedules are not ported yet (use the shadow_tpu package)"
            )

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
                            dataclasses.replace(p, args=list(p.args))
                            for p in base.processes
                        ],
                    ))
        return cls(
            general=general, network=network, experimental=experimental,
            hosts=hosts,
        )

    def validate(self) -> None:
        if self.general.stop_time <= 0:
            raise ConfigError("general.stop_time must be > 0")
        if self.experimental.network_backend not in ("cpu", "tpu"):
            raise ConfigError("experimental.network_backend must be cpu|tpu")
        names = [h.hostname for h in self.hosts]
        if len(set(names)) != len(names):
            raise ConfigError("duplicate hostnames")
        for h in self.hosts:
            if h.congestion not in ("reno", "cubic"):
                raise ConfigError(
                    f"host {h.hostname!r}: congestion must be reno|cubic, "
                    f"got {h.congestion!r}"
                )


def _parse_host(name: str, doc: dict[str, Any]) -> HostOptions:
    doc = dict(doc)
    if doc.pop("pcap_enabled", False):
        raise LaneCompatError(
            f"host {name!r}: pcap capture is not ported yet (use the "
            "shadow_tpu package)"
        )
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
                start_time=units.parse_time(p.pop("start_time", 0)),
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
    )
    if doc:
        raise ConfigError(f"unknown host options on {name!r}: {sorted(doc)}")
    return host
