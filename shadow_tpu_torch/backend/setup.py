"""Engine setup: config -> topology/routing/bandwidths/runahead.

The same law as the JAX package's ``backend/setup.py`` (host ordering, IP
assignment, bandwidth fallback, runahead formula), so the port builds the
identical world from the same config.
"""

from __future__ import annotations

import numpy as np

from ..config.options import ConfigOptions
from ..net.dns import Dns
from ..net.graph import IpAssignment, NetworkGraph, RoutingInfo


def build_graph(cfg: ConfigOptions) -> NetworkGraph:
    g = cfg.network.graph
    if g.type == "1_gbit_switch":
        return NetworkGraph.one_gbit_switch()
    if g.inline is not None:
        return NetworkGraph.from_gml(g.inline, cfg.network.use_shortest_path)
    return NetworkGraph.from_file(g.file_path, cfg.network.use_shortest_path)


def build_world(cfg: ConfigOptions):
    """(graph, ips, dns, routing, bw_up[N], bw_dn[N], runahead)."""
    graph = build_graph(cfg)
    ips = IpAssignment()
    dns = Dns()
    node_map: dict[int, int] = {}
    n = len(cfg.hosts)
    bw_up = np.zeros(n, dtype=np.int64)
    bw_dn = np.zeros(n, dtype=np.int64)
    for hid, hopt in enumerate(cfg.hosts):
        ip = ips.assign(hid, hopt.ip_addr)
        dns.register(hid, hopt.hostname, ip)
        node_map[hid] = hopt.network_node_id
        nb_up, nb_down = graph.node_bandwidth(hopt.network_node_id)
        up = hopt.bandwidth_up if hopt.bandwidth_up is not None else nb_up
        dn = hopt.bandwidth_down if hopt.bandwidth_down is not None else nb_down
        if up is None or dn is None:
            raise ValueError(
                f"host {hopt.hostname!r}: no bandwidth on host or graph node"
            )
        bw_up[hid], bw_dn[hid] = up, dn
    routing = RoutingInfo(graph, node_map)
    floor = cfg.experimental.runahead or 0
    runahead = max(routing.min_used_latency_ns(), floor, 1)
    return graph, ips, dns, routing, bw_up, bw_dn, runahead
