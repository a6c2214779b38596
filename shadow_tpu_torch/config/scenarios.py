"""Managed-process scenario factories (real OS binaries under the shim).

The port's copies of the JAX package's ``config/scenarios.py`` factories:
a Tor-shaped relay topology built from the repo's own native apps
(``native/build``, ``make -C native``):

- an origin host running ``tcpecho server`` (epoll echo);
- ``chains`` three-relay chains (guard -> middle -> exit -> origin) of
  ``relay`` processes (poll-based TCP forwarding, the minimal Tor relay
  shape);
- per chain, ``clients_per_chain`` ``tcpecho hclient`` clients that
  resolve their guard by name and pump ``rounds`` echo round-trips of
  ``size`` bytes through the full chain;
- ``peers`` tgen-mesh model hosts keeping background datagram load on
  the same graph.

``backend="tpu"`` selects the hybrid engine (``backend/hybrid.py``): the
managed hosts' syscalls on the host CPU, every packet on the card.
"""

from __future__ import annotations

from pathlib import Path

from .options import ConfigOptions

REPO = Path(__file__).resolve().parents[2]
BUILD = REPO / "native" / "build"


def managed_chain_config(
    data_dir: str | Path,
    chains: int = 8,
    clients_per_chain: int = 2,
    peers: int = 40,
    sim_seconds: int = 30,
    rounds: int = 20,
    size: int = 4096,
    gap_ms: int = 50,
    seed: int = 42,
    parallelism: int = 1,
    backend: str = "cpu",
    hybrid_workers: int = 1,
) -> ConfigOptions:
    """Relay-chain scenario config.  Managed process count =
    ``1 + 3*chains + chains*clients_per_chain``; host count adds
    ``peers`` model hosts.

    ``backend="tpu"`` selects the HYBRID engine (managed hosts' syscall
    plane on the host CPU, every packet on the card's lanes);
    ``hybrid_workers`` picks the syscall-servicing parallelism, which the
    port has serial only (1; other values raise on validation)."""
    n_clients = chains * clients_per_chain
    hosts = [
        f"""
  origin:
    network_node_id: 0
    processes:
      - path: {BUILD / 'tcpecho'}
        args: [server, "8080", "{n_clients}"]
        expected_final_state: {{exited: 0}}
"""
    ]
    for c in range(chains):
        hosts.append(f"""
  exit{c}:
    network_node_id: 1
    processes:
      - path: {BUILD / 'relay'}
        args: ["9000", origin, "8080"]
        start_time: 500ms
        expected_final_state: running
  middle{c}:
    network_node_id: 2
    processes:
      - path: {BUILD / 'relay'}
        args: ["9000", exit{c}, "9000"]
        start_time: 700ms
        expected_final_state: running
  guard{c}:
    network_node_id: 2
    processes:
      - path: {BUILD / 'relay'}
        args: ["9000", middle{c}, "9000"]
        start_time: 900ms
        expected_final_state: running
""")
        for k in range(clients_per_chain):
            hosts.append(f"""
  client{c}x{k}:
    network_node_id: 3
    processes:
      - path: {BUILD / 'tcpecho'}
        args: [hclient, guard{c}, "9000", "{rounds}", "{size}", "{gap_ms}"]
        start_time: {1500 + 400 * k + 97 * c}ms
        expected_final_state: {{exited: 0}}
""")
    if peers:
        hosts.append(f"""
  peer:
    count: {peers}
    network_node_id: 1
    processes:
      - path: tgen-mesh
        args: [--interval, 50ms, --size, "600"]
        start_time: 0 s
""")
    return ConfigOptions.from_yaml(f"""
general:
  stop_time: {sim_seconds}s
  seed: {seed}
  data_directory: {data_dir}
  heartbeat_interval: null
  parallelism: {parallelism}
experimental:
  network_backend: {backend}
  hybrid_workers: {hybrid_workers}
network:
  graph:
    type: gml
    inline: |
      graph [
        directed 0
        node [ id 0 host_bandwidth_up "100 Mbit" host_bandwidth_down "100 Mbit" ]
        node [ id 1 host_bandwidth_up "50 Mbit" host_bandwidth_down "50 Mbit" ]
        node [ id 2 host_bandwidth_up "50 Mbit" host_bandwidth_down "50 Mbit" ]
        node [ id 3 host_bandwidth_up "20 Mbit" host_bandwidth_down "20 Mbit" ]
        edge [ source 0 target 0 latency "1 ms" ]
        edge [ source 1 target 1 latency "2 ms" ]
        edge [ source 2 target 2 latency "3 ms" ]
        edge [ source 3 target 3 latency "2 ms" ]
        edge [ source 0 target 1 latency "8 ms" ]
        edge [ source 1 target 2 latency "15 ms" ]
        edge [ source 2 target 3 latency "10 ms" ]
      ]
hosts:
{''.join(hosts)}
""")


def managed_relay_chains_large(
    data_dir: str | Path,
    chains: int = 25,
    clients_per_chain: int = 3,
    peers: int = 1000,
    sim_seconds: int = 10,
    rounds: int = 8,
    size: int = 2048,
    hybrid_workers: int = 1,
    seed: int = 42,
) -> ConfigOptions:
    """The HYBRID flagship scenario: 100+ managed OS processes (default 151
    = 25 three-relay chains + 75 clients + origin) whose syscall plane
    runs on the host CPU (serially: ``hybrid_workers`` 1, the port's only
    setting), over 1k+ lane hosts (default 1000 tgen peers) whose data
    plane — and every managed packet — rides the card's lanes."""
    return managed_chain_config(
        data_dir,
        chains=chains,
        clients_per_chain=clients_per_chain,
        peers=peers,
        sim_seconds=sim_seconds,
        rounds=rounds,
        size=size,
        seed=seed,
        backend="tpu",
        hybrid_workers=hybrid_workers,
    )
