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
    backend: str = "tpu",
    seed: int = 1,
) -> ConfigOptions:
    """The tgen all-to-all mesh over a single switch (BASELINE config #4):
    every host sends a ``size``-byte datagram every ``interval`` to a
    round-robin peer; lookahead window = link ``latency``."""
    cfg = ConfigOptions.from_dict({
        "general": {"stop_time": f"{sim_seconds} s", "seed": seed},
        "network": {"graph": {"type": "gml", "inline": _single_switch(latency)}},
        "experimental": {"network_backend": backend},
        "hosts": {
            "peer": {
                "count": n_hosts,
                "network_node_id": 0,
                "processes": [{
                    "path": "tgen-mesh",
                    "args": f"--interval {interval} --size {size}",
                    "start_time": "0 s",
                }],
            },
        },
    })
    if queue_capacity is not None:
        cfg.experimental.tpu_lane_queue_capacity = queue_capacity
    if pops_per_round is not None:
        cfg.experimental.tpu_events_per_round = pops_per_round
    return cfg


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
