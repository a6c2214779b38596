"""Stream tier: TCP flows under the lane-TCP law (net/ltcp.py).

``stream-client --server H --size B [--mss M]`` opens one ltcp flow to the
server host at start time and streams B bytes as MSS-sized segments through
the full law — handshake, Reno/NewReno congestion control, RTO, teardown —
over the engine's normal packet path (token buckets, loss draw, latency,
CoDel).  ``stream-server`` sinks any number of flows.

This is the CPU-oracle form of the vectorized TCP tier the lane backend
runs on device (backend/lanes.py); determinism tests diff the two event
logs bit-for-bit.  The byte-accurate sans-I/O stack (transport/tcp.py,
models/tgen_tcp.py) remains the managed-process tier; reference analog:
src/test/tgen fixed_size workloads over src/lib/tcp.

Counters: ``stream_tx_segs`` / ``stream_retransmits`` / ``stream_complete``
(client), ``stream_rx_segs`` / ``stream_rx_bytes`` / ``stream_flows_done``
(server).

The JAX package's ``models/tcpflow.py``, copied into the port unchanged in law
(plain Python and numpy, no JAX).
"""

from __future__ import annotations

import dataclasses

from ..config import units
from ..net import ltcp
from .base import HostApi, parse_kv_args, register_model


@dataclasses.dataclass
class StreamSeg:
    """Engine payload of one ltcp wire segment.  ``client``/``conn`` name
    the flow (the client host owns the namespace); contents never enter
    the event log — parity is behavioral, via times/sizes/outcomes."""

    client: int
    conn: int
    flags: int
    seq: int
    ack: int


class _FlowDriver:
    """Shared stimulus plumbing: apply an Emit to the host (send the
    segment, arm pump/RTO events at exact times).  ``client`` is the flow
    namespace (the client host's id) regardless of which end is sending."""

    def _apply(self, api, fs: ltcp.FlowState, em: ltcp.Emit, peer: int,
               client: int, conn: int):
        for (flags, seq, ack, size), rx in zip(em.sends, em.retx):
            api.send(peer, size, payload=StreamSeg(client, conn, flags, seq, ack),
                     retx=rx)
        if em.arm_pump:
            api.schedule_at(api.now, self._pump_cb(fs, peer, client, conn))
        if em.arm_rto is not None:
            api.schedule_at(em.arm_rto, self._rto_cb(fs, peer, client, conn))
        if em.aborted:
            # the ltcp give-up law fired (MAX_RTO_BACKOFFS consecutive
            # timeouts — a dead path); surfaced in sim-stats
            # packet_outcomes as "retry_drop" (engine/sim.py)
            api.count("stream_retry_drops")
            ft = getattr(api, "ft_giveup", None)
            if ft is not None:
                ft(peer)
        return em

    def _pump_cb(self, fs, peer, client, conn):
        def fire(host):
            em = ltcp.on_pump(fs, host.now)
            self._apply(host, fs, em, peer, client, conn)

        return fire

    def _rto_cb(self, fs, peer, client, conn):
        def fire(host):
            em = ltcp.on_rto_event(fs, host.now)
            self._apply(host, fs, em, peer, client, conn)

        return fire


@register_model("stream-client")
class StreamClient(_FlowDriver):
    """One ltcp flow: connect at start, stream ``--size`` bytes, close."""

    def __init__(self, server: str, size: int, mss: int = 1448) -> None:
        self.server = server
        self.size = size
        self.mss = mss
        self.fs = ltcp.FlowState(role=ltcp.SENDER, mss=mss)
        self.fs.segs, self.fs.last_bytes = ltcp.segs_for_size(size, mss)
        self._peer = -1
        self._conn = 0  # per-host process index, set at start
        self._done_counted = False

    @classmethod
    def from_args(cls, args: list[str]) -> "StreamClient":
        kv = parse_kv_args(args, known={"server", "size", "mss"})
        return cls(
            server=kv.pop("server", "server"),
            size=units.parse_bytes(kv.pop("size", "1 MiB")),
            mss=int(kv.pop("mss", 1448)),
        )

    def set_congestion(self, name: str) -> None:
        """Engine hook: the host's ``congestion`` option selects this
        flow's algorithm (CC follows the data sender; the server end's
        receiver role never grows a window)."""
        self.fs.cc = ltcp.CC_BY_NAME[name]

    def on_start(self, api: HostApi) -> None:
        self._peer = api.resolve(self.server)
        # conn id = this process's index on its host: two stream-clients on
        # one host to the same server stay distinct flows at the server
        apps = getattr(api, "apps", None)
        self._conn = apps.index(self) if apps is not None else 0
        em = ltcp.open_flow(self.fs, api.now)
        self._track(api, self._apply(api, self.fs, em, self._peer,
                                     api.host_id, self._conn))

    def on_timer(self, api: HostApi, t: int) -> None:
        pass

    def on_delivery(self, api, t, src, seq, size, payload=None) -> None:
        if not isinstance(payload, StreamSeg) or src != self._peer:
            return
        if payload.client != api.host_id or payload.conn != self._conn:
            return
        em = ltcp.on_segment(
            self.fs, t, payload.flags, payload.seq, payload.ack, size
        )
        self._track(api, self._apply(api, self.fs, em, self._peer,
                                     api.host_id, self._conn))

    def _track(self, api, em: ltcp.Emit) -> None:
        if em.completed and not self._done_counted:
            self._done_counted = True
            api.count("stream_complete")
            api.count("stream_tx_segs", self.fs.tx_segs)
            api.count("stream_retransmits", self.fs.retransmits)


@register_model("stream-server")
class StreamServer(_FlowDriver):
    """Sink any number of ltcp flows (one record per (client, conn))."""

    def __init__(self) -> None:
        self.flows: dict[tuple[int, int], ltcp.FlowState] = {}

    @classmethod
    def from_args(cls, args: list[str]) -> "StreamServer":
        parse_kv_args(args, known=set())
        return cls()

    def on_start(self, api: HostApi) -> None:
        pass

    def on_timer(self, api: HostApi, t: int) -> None:
        pass

    def on_delivery(self, api, t, src, seq, size, payload=None) -> None:
        if not isinstance(payload, StreamSeg) or payload.client != src:
            return  # only client->server segments open/advance server flows
        key = (payload.client, payload.conn)
        fs = self.flows.get(key)
        if fs is None:
            fs = ltcp.FlowState(role=ltcp.RECEIVER)
            self.flows[key] = fs
        pre_rx = fs.rx_bytes
        pre_segs = fs.rx_segs
        em = ltcp.on_segment(fs, t, payload.flags, payload.seq, payload.ack, size)
        self._apply(api, fs, em, src, payload.client, payload.conn)
        if fs.rx_bytes > pre_rx:
            api.count("stream_rx_bytes", fs.rx_bytes - pre_rx)
        if fs.rx_segs > pre_segs:
            api.count("stream_rx_segs", fs.rx_segs - pre_segs)
        if em.completed:
            api.count("stream_flows_done")
