"""Canonical workload presets (BASELINE.md north-star configs), built as
dicts so no YAML parser is needed.  Same documents as the JAX package's
``config/presets.py``."""

from __future__ import annotations

from .options import ConfigOptions


def _single_switch(latency: str) -> str:
    return (
        "graph [\n"
        '  node [ id 0  host_bandwidth_up "1 Gbit"  host_bandwidth_down "1 Gbit" ]\n'
        f'  edge [ source 0  target 0  latency "{latency}" ]\n'
        "]\n"
    )


def flagship_mesh_config(
    n_hosts: int,
    sim_seconds: int = 10,
    latency: str = "10 ms",
    interval: str = "10ms",
    size: int = 1428,
    queue_capacity: int | None = None,
    pops_per_round: int | None = None,
    stream_pairs: int = 0,
    stream_bytes: int = 50_000_000,
    backend: str = "tpu",
    seed: int = 1,
) -> ConfigOptions:
    """The tgen all-to-all mesh over a single switch (BASELINE config #4):
    every host sends a ``size``-byte datagram every ``interval`` to a
    round-robin peer; lookahead window = link ``latency``.
    ``stream_pairs`` > 0 makes it the mixed TCP/UDP mesh: that many
    stream-client -> stream-server lane-TCP flows run beside the mesh,
    each streaming ``stream_bytes``; the mesh's round-robin spray crosses
    the stream lanes, which ignore it as the CPU oracle does."""
    k = stream_pairs
    if 2 * k >= n_hosts:
        raise ValueError("stream_pairs must leave room for mesh hosts")
    hosts = {
        "peer": {
            "count": n_hosts - 2 * k,
            "network_node_id": 0,
            "processes": [{
                "path": "tgen-mesh",
                "args": f"--interval {interval} --size {size}",
                "start_time": "0 s",
            }],
        },
    }
    for i in range(k):
        hosts[f"sc{i:05d}"] = {"network_node_id": 0, "processes": [{
            "path": "stream-client",
            "args": f"--server ss{i:05d} --size {stream_bytes}",
            "start_time": "0 s"}]}
        hosts[f"ss{i:05d}"] = {"network_node_id": 0, "processes": [{
            "path": "stream-server", "start_time": "0 s"}]}
    cfg = ConfigOptions.from_dict({
        "general": {"stop_time": f"{sim_seconds} s", "seed": seed},
        "network": {"graph": {"type": "gml", "inline": _single_switch(latency)}},
        "experimental": {"network_backend": backend},
        "hosts": hosts,
    })
    if queue_capacity is not None:
        cfg.experimental.tpu_lane_queue_capacity = queue_capacity
    if pops_per_round is not None:
        cfg.experimental.tpu_events_per_round = pops_per_round
    return cfg


def transfer_pair_config(
    size_bytes: int = 50_000_000, sim_seconds: int = 60,
    backend: str = "tpu", seed: int = 1,
) -> ConfigOptions:
    """BASELINE config #1: a 2-host client -> server transfer over one
    10 ms link, as a lane-TCP stream flow."""
    graph = (
        "graph [\n  directed 0\n"
        '  node [ id 0 host_bandwidth_up "1 Gbit" host_bandwidth_down "1 Gbit" ]\n'
        '  node [ id 1 host_bandwidth_up "1 Gbit" host_bandwidth_down "1 Gbit" ]\n'
        '  edge [ source 0 target 1 latency "10 ms" ]\n]\n'
    )
    return ConfigOptions.from_dict({
        "general": {"stop_time": f"{sim_seconds} s", "seed": seed},
        "network": {"graph": {"type": "gml", "inline": graph}},
        "experimental": {"network_backend": backend,
                         "tpu_lane_queue_capacity": 128},
        "hosts": {
            "c": {"network_node_id": 0, "processes": [{
                "path": "stream-client",
                "args": f"--server s --size {size_bytes}"}]},
            "s": {"network_node_id": 1,
                  "processes": [{"path": "stream-server"}]},
        },
    })


def udp_star_config(
    n_hosts: int = 100,
    sim_seconds: int = 10,
    interval: str = "10ms",
    size: int = 1428,
    backend: str = "tpu",
    seed: int = 1,
) -> ConfigOptions:
    """BASELINE config #2: a UDP-only tgen star — n-1 clients send fixed
    datagrams to one server host (single switch, no TCP state).  The
    server lane's queue must hold every in-flight client datagram, so
    capacity scales with the fan-in (the clients all fire each interval)."""
    return ConfigOptions.from_dict({
        "general": {"stop_time": f"{sim_seconds} s", "seed": seed},
        "network": {"graph": {"type": "gml", "inline": _single_switch("5 ms")}},
        "experimental": {
            "network_backend": backend,
            "tpu_lane_queue_capacity": max(64, 2 * n_hosts),
        },
        "hosts": {
            "srv": {
                "network_node_id": 0,
                "processes": [{"path": "tgen-server"}],
            },
            "cli": {
                "count": n_hosts - 1,
                "network_node_id": 0,
                "processes": [{
                    "path": "tgen-client",
                    "args": f"--server srv --interval {interval} --size {size}",
                }],
            },
        },
    })


def mixed_flagship_config(
    n_hosts: int, sim_seconds: int = 5, backend: str = "tpu",
    seed: int = 1,
) -> ConfigOptions:
    """The mixed TCP/UDP mesh at the JAX package's north-star tuning: one
    stream pair per 100 hosts streaming 2 MB across the datagram mesh,
    queue capacity 16, 2 pops per iteration, cross capacity 8, and the
    tiered stream backend's 16 pops per iteration.  (The port runs this
    one-to-one config untiered: callers set ``tpu_stream_tiered`` to false
    and give the [N] queues the untiered shape.)"""
    cfg = flagship_mesh_config(
        n_hosts, sim_seconds=sim_seconds, queue_capacity=16,
        pops_per_round=2, stream_pairs=max(n_hosts // 100, 1),
        stream_bytes=2_000_000, backend=backend, seed=seed,
    )
    cfg.experimental.tpu_cross_capacity = 8
    cfg.experimental.tpu_stream_events_per_round = 16
    return cfg


def _two_node_graph(up_down: str, self_latency: str, latency: str,
                    loss: float) -> str:
    return (
        "graph [\n  directed 0\n"
        f'  node [ id 0 host_bandwidth_up "{up_down}" host_bandwidth_down "{up_down}" ]\n'
        f'  node [ id 1 host_bandwidth_up "{up_down}" host_bandwidth_down "{up_down}" ]\n'
        f'  edge [ source 0 target 0 latency "{self_latency}" ]\n'
        f'  edge [ source 0 target 1 latency "{latency}" packet_loss {loss} ]\n'
        f'  edge [ source 1 target 1 latency "{self_latency}" ]\n]\n'
    )


def stream_tcp_example_doc() -> dict:
    """``examples/stream-tcp.yaml`` as a dict: 4 clients stream 1 MiB each
    to one server over a 40 ms link with 2% loss, 60 sim s (the star)."""
    return {
        "general": {"stop_time": "60s", "seed": 1},
        "experimental": {"tpu_lane_queue_capacity": 256},
        "network": {"graph": {"type": "gml", "inline": _two_node_graph(
            "20 Mbit", "1 ms", "40 ms", 0.02)}},
        "hosts": {
            "client": {"count": 4, "network_node_id": 0, "processes": [{
                "path": "stream-client",
                "args": ["--server", "server", "--size", "1MiB"]}]},
            "server": {"network_node_id": 1,
                       "processes": [{"path": "stream-server"}]},
        },
    }


def cubic_vs_reno_example_doc() -> dict:
    """``examples/cubic-vs-reno.yaml`` as a dict: a CUBIC and a NewReno
    sender stream 2 MB each over one 15 ms link with 1% loss, 60 sim s
    (two one-to-one pairs)."""
    def pair(sink: str, cc: str) -> dict:
        sender = {"network_node_id": 0, "processes": [{
            "path": "stream-client", "args": ["--server", sink, "--size", "2MB"]}]}
        if cc == "cubic":
            sender["congestion"] = "cubic"
        return sender

    return {
        "general": {"stop_time": "60s", "seed": 5},
        "network": {"graph": {"type": "gml", "inline": _two_node_graph(
            "20 Mbit", "2 ms", "15 ms", 0.01)}},
        "hosts": {
            "cubic-sender": pair("cubic-sink", "cubic"),
            "cubic-sink": {"network_node_id": 1,
                           "processes": [{"path": "stream-server"}]},
            "reno-sender": pair("reno-sink", "reno"),
            "reno-sink": {"network_node_id": 1,
                          "processes": [{"path": "stream-server"}]},
        },
    }
