"""Network topology graph, shortest-path routing, and IP assignment.

Behavior parity with the reference's ``src/main/network/graph/mod.rs``:

- GML graphs with ``node [id, host_bandwidth_up/down]`` and ``edge [source,
  target, latency, packet_loss]``; undirected graphs use each edge in both
  directions; a self-loop edge supplies the path properties between two hosts
  attached to the same node (graph/mod.rs:228-286).
- Edge latency must be > 0.
- Path latencies add; shortest paths minimize latency (graph/mod.rs:301-303).
- Routing can be all-pairs shortest paths or direct-edges-only
  (graph/mod.rs:181,228).
- IPs are auto-assigned from 11.0.0.0/8 (graph/mod.rs:348).

Routing resolves to a dense ``latency_ns[G, G]`` table, because every
per-packet latency lookup on the lane backend is a gather into it.  This
slice of the port runs loss-free graphs only: an edge with
``packet_loss > 0`` is refused here, so no loss table exists.
"""

from __future__ import annotations

import dataclasses
import lzma
import math
from pathlib import Path
from typing import Optional

import numpy as np

from ..config import units
from ..config.options import LaneCompatError
from . import gml as gml_mod

#: Built-in one-node graph (config ``type: 1_gbit_switch``), as upstream.
ONE_GBIT_SWITCH_GML = """
graph [
  node [
    id 0
    host_bandwidth_up "1 Gbit"
    host_bandwidth_down "1 Gbit"
  ]
  edge [
    source 0
    target 0
    latency "1 ms"
  ]
]
"""

_UNREACHABLE = -1


class GraphError(ValueError):
    pass


@dataclasses.dataclass
class GraphNode:
    node_id: int
    bandwidth_up_bps: Optional[int]  # bits/sec, None if not set on the node
    bandwidth_down_bps: Optional[int]


@dataclasses.dataclass
class GraphEdge:
    source: int
    target: int
    latency_ns: int
    packet_loss: float


class NetworkGraph:
    """Parsed + validated topology with compiled routing tables."""

    def __init__(
        self,
        nodes: list[GraphNode],
        edges: list[GraphEdge],
        directed: bool,
        use_shortest_path: bool = True,
    ) -> None:
        if not nodes:
            raise GraphError("graph has no nodes")
        self.directed = directed
        self.nodes = nodes
        self.edges = edges
        # graph node ids can be sparse; map to dense indices
        self.node_ids = [n.node_id for n in nodes]
        if len(set(self.node_ids)) != len(self.node_ids):
            raise GraphError("duplicate node ids")
        self.id_to_index = {nid: i for i, nid in enumerate(self.node_ids)}
        for e in edges:
            if isinstance(e.latency_ns, float) and not math.isfinite(e.latency_ns):
                raise GraphError(
                    f"edge {e.source}->{e.target}: latency must be a finite "
                    f"value, got {e.latency_ns!r}"
                )
            if e.latency_ns <= 0:
                raise GraphError(f"edge {e.source}->{e.target}: latency must be > 0")
            if not math.isfinite(e.packet_loss) or not (0.0 <= e.packet_loss <= 1.0):
                raise GraphError(
                    f"edge {e.source}->{e.target}: packet_loss not in [0,1]"
                )
            if e.packet_loss > 0.0:
                raise LaneCompatError(
                    f"edge {e.source}->{e.target}: packet_loss "
                    f"{e.packet_loss} > 0; lossy graphs are not ported yet "
                    "(use the shadow_tpu package)"
                )
            if e.source not in self.id_to_index or e.target not in self.id_to_index:
                raise GraphError(f"edge {e.source}->{e.target}: unknown node id")
        self._compile_routes(use_shortest_path)

    # -- construction -----------------------------------------------------

    @classmethod
    def from_gml(cls, text: str, use_shortest_path: bool = True) -> "NetworkGraph":
        g = gml_mod.parse_gml(text)
        directed = bool(g.get("directed", 0))
        nodes = []
        for n in g["nodes"]:
            if "id" not in n:
                raise GraphError("node without id")
            up = n.get("host_bandwidth_up")
            down = n.get("host_bandwidth_down")
            nodes.append(
                GraphNode(
                    node_id=int(n["id"]),
                    bandwidth_up_bps=units.parse_bandwidth(up) if up is not None else None,
                    bandwidth_down_bps=units.parse_bandwidth(down)
                    if down is not None
                    else None,
                )
            )
        edges = []
        for e in g["edges"]:
            if "source" not in e or "target" not in e:
                raise GraphError("edge without source/target")
            if "latency" not in e:
                raise GraphError("edge 'latency' was not provided")
            if not isinstance(e["latency"], str):
                # the reference requires a unit string here; a bare number is
                # ambiguous (ns? s?) and floats would truncate silently
                raise GraphError(
                    f"edge {e['source']}->{e['target']}: 'latency' must be a "
                    f"unit string like \"10 ms\", got {e['latency']!r}"
                )
            edges.append(
                GraphEdge(
                    source=int(e["source"]),
                    target=int(e["target"]),
                    latency_ns=units.parse_time(e["latency"]),
                    packet_loss=float(e.get("packet_loss", 0.0)),
                )
            )
        return cls(nodes, edges, directed, use_shortest_path)

    @classmethod
    def from_file(cls, path: str | Path, use_shortest_path: bool = True) -> "NetworkGraph":
        p = Path(path)
        raw = p.read_bytes()
        if p.suffix == ".xz" or raw[:6] == b"\xfd7zXZ\x00":
            raw = lzma.decompress(raw)
        return cls.from_gml(raw.decode(), use_shortest_path)

    @classmethod
    def one_gbit_switch(cls) -> "NetworkGraph":
        return cls.from_gml(ONE_GBIT_SWITCH_GML)

    # -- routing ----------------------------------------------------------

    def _compile_routes(self, use_shortest_path: bool) -> None:
        g = len(self.nodes)
        lat = np.full((g, g), _UNREACHABLE, dtype=np.int64)
        # direct edges (off-diagonal) and self-loops (diagonal)
        for e in self.edges:
            s, t = self.id_to_index[e.source], self.id_to_index[e.target]
            pairs = [(s, t)] if (self.directed or s == t) else [(s, t), (t, s)]
            for a, b in pairs:
                if lat[a, b] != _UNREACHABLE:
                    raise GraphError(
                        f"more than one edge connecting node {e.source} to {e.target}"
                    )
                lat[a, b] = e.latency_ns
        if use_shortest_path and g > 1:
            lat = self._all_pairs_shortest(lat)
        self.latency_ns = lat

    @staticmethod
    def _all_pairs_shortest(direct_lat: np.ndarray) -> np.ndarray:
        """All-pairs shortest paths by latency: scipy's C Dijkstra on exact
        integer latencies (float64 is exact below 2**53 ns) with
        predecessor reconstruction, so no float error reaches the table."""
        from scipy.sparse import csr_matrix
        from scipy.sparse.csgraph import dijkstra

        g = direct_lat.shape[0]
        rows, cols, w = [], [], []
        for i in range(g):
            for j in range(g):
                if i != j and direct_lat[i, j] != _UNREACHABLE:
                    rows.append(i)
                    cols.append(j)
                    w.append(float(direct_lat[i, j]))
        mat = csr_matrix((w, (rows, cols)), shape=(g, g))
        dist, pred = dijkstra(mat, directed=True, return_predecessors=True)

        lat = np.full((g, g), _UNREACHABLE, dtype=np.int64)
        order = np.argsort(dist, axis=1, kind="stable")
        for s in range(g):
            # accumulate exact edge latencies in increasing-distance order,
            # so predecessors are always finalized first
            for v in order[s]:
                if v == s or not np.isfinite(dist[s, v]):
                    continue
                p = pred[s, v]
                if p < 0:
                    continue
                base_lat = 0 if p == s else lat[s, p]
                lat[s, v] = base_lat + direct_lat[p, v]
        # keep self-loop (diagonal) direct properties: they model same-node
        # host-to-host paths and are not part of shortest-path routing
        np.fill_diagonal(lat, np.diag(direct_lat))
        return lat

    def node_bandwidth(self, node_id: int) -> tuple[Optional[int], Optional[int]]:
        n = self.nodes[self.id_to_index[node_id]]
        return n.bandwidth_up_bps, n.bandwidth_down_bps


@dataclasses.dataclass
class IpAssignment:
    """Sequential auto-assignment from 11.0.0.0/8, skipping .0/.255 octets
    (mirrors graph/mod.rs:348's auto-IP block choice)."""

    _next: int = (11 << 24) + 1
    by_ip: dict[str, int] = dataclasses.field(default_factory=dict)  # ip -> host_id
    by_host: dict[int, str] = dataclasses.field(default_factory=dict)

    def assign(self, host_id: int, requested_ip: Optional[str] = None) -> str:
        if requested_ip is not None:
            if requested_ip in self.by_ip:
                raise GraphError(f"duplicate IP {requested_ip}")
            self.by_ip[requested_ip] = host_id
            self.by_host[host_id] = requested_ip
            return requested_ip
        while True:
            ip_int = self._next
            self._next += 1
            last = ip_int & 0xFF
            if last in (0, 255):
                continue
            if (ip_int >> 24) != 11:
                raise GraphError("11.0.0.0/8 exhausted")
            ip = ".".join(str((ip_int >> s) & 0xFF) for s in (24, 16, 8, 0))
            if ip in self.by_ip:
                continue
            self.by_ip[ip] = host_id
            self.by_host[host_id] = ip
            return ip


class RoutingInfo:
    """Pairwise path lookup between *hosts* (graph/mod.rs:428-470), backed
    by the dense node table.

    ``host_nodes`` maps host_id -> dense node index; the device table is
    exactly ``latency_ns`` gathered through this map.
    """

    def __init__(self, graph: NetworkGraph, host_to_node_id: dict[int, int]) -> None:
        self.graph = graph
        self.host_to_node_id = dict(host_to_node_id)
        self.host_node_index = {
            h: graph.id_to_index[nid] for h, nid in host_to_node_id.items()
        }
        # validate all pairs are routable up-front (reference computes paths
        # for the used node set during setup and errors early)
        from collections import Counter

        used = sorted(set(self.host_node_index.values()))
        counts = Counter(self.host_node_index.values())
        multi = {n for n, c in counts.items() if c > 1}
        for s in used:
            for t in used:
                if s == t and s not in multi:
                    continue
                if graph.latency_ns[s, t] == _UNREACHABLE:
                    raise GraphError(
                        f"hosts are assigned to nodes without a route "
                        f"({graph.node_ids[s]} -> {graph.node_ids[t]})"
                    )

    def min_used_latency_ns(self) -> int:
        """Min latency over node pairs actually used by hosts — the
        lookahead bound (runahead.rs:60-118)."""
        used = sorted(set(self.host_node_index.values()))
        lat = self.graph.latency_ns[np.ix_(used, used)]
        mask = lat != _UNREACHABLE
        if not mask.any():
            raise GraphError("no routable path between any pair of used nodes")
        return int(lat[mask].min())

    def device_tables(self) -> tuple[np.ndarray, np.ndarray]:
        """(host_node_index[N], latency_ns[G,G]) ready to ship to the
        device."""
        n = max(self.host_node_index) + 1
        idx = np.zeros(n, dtype=np.int32)
        for h, i in self.host_node_index.items():
            idx[h] = i
        return idx, self.graph.latency_ns
