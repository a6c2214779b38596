"""tgen-style traffic generation models.

Behavioral stand-ins for the reference's tgen integration workloads
(src/test/tgen/{fixed_duration,fixed_size}): generators push datagram
streams through the simulated network while sinks count bytes.  These are
the workloads behind the BASELINE configs (100-host star, 1k/10k-host
all-to-all mesh).

``tgen-mesh`` — every host sends a ``--size`` B datagram every
``--interval`` to its peers (round-robin over all other hosts, or
``--peer-stride`` for sparser patterns), and counts whatever it receives:
the all-to-all mesh load.

``tgen-client`` / ``tgen-server`` — fixed-rate client streams to one named
server (star topologies, basic 2-host transfer).

The JAX package's ``models/tgen.py``, copied into the port unchanged in law
(plain Python and numpy, no JAX).
"""

from __future__ import annotations

from ..config import units
from ._validate import positive_interval
from .base import HostApi, parse_kv_args, register_model


@register_model("tgen-mesh")
class TgenMesh:
    # delivery handling is counters-only: the engine may apply it inline at
    # packet arrival and skip the DELIVERY queue event (both backends elide
    # identically, keeping event logs bit-identical)
    passive_delivery = True

    def __init__(self, interval_ns: int, size: int = 1428, stride: int = 1) -> None:
        self.interval = interval_ns
        self.size = size
        self.stride = stride
        self._next_peer_offset = 0

    @classmethod
    def from_args(cls, args: list[str]) -> "TgenMesh":
        kv = parse_kv_args(args, known={"interval", "size", "peer-stride"})
        return cls(
            interval_ns=positive_interval(units.parse_time(kv.pop("interval", "10 ms")), "tgen-mesh"),
            size=int(kv.pop("size", 1428)),
            stride=int(kv.pop("peer-stride", 1)),
        )

    def on_start(self, api: HostApi) -> None:
        api.set_timer_relative(self.interval)

    def on_timer(self, api: HostApi, t: int) -> None:
        if api.num_hosts > 1:
            off = self._next_peer_offset % (api.num_hosts - 1)
            dst = (api.host_id + 1 + off) % api.num_hosts
            self._next_peer_offset += self.stride
            api.send(dst, self.size)
            api.count("tgen_sent_bytes", self.size)
        api.set_timer_relative(self.interval)

    def on_delivery(self, api: HostApi, t: int, src: int, seq: int, size: int, payload=None) -> None:
        api.count("tgen_recv_bytes", size)


@register_model("tgen-client")
class TgenClient:
    """``--server H`` destination host id (or hostname resolved by the
    engine), ``--interval``, ``--size``."""

    passive_delivery = True

    def __init__(self, server: str, interval_ns: int, size: int = 1428) -> None:
        self.server = server
        self.interval = interval_ns
        self.size = size
        self._dst: int | None = None

    @classmethod
    def from_args(cls, args: list[str]) -> "TgenClient":
        kv = parse_kv_args(args, known={"server", "interval", "size"})
        return cls(
            server=kv.pop("server", "server"),
            interval_ns=positive_interval(units.parse_time(kv.pop("interval", "10 ms")), "tgen-client"),
            size=int(kv.pop("size", 1428)),
        )

    def on_start(self, api: HostApi) -> None:
        self._dst = api.resolve(self.server)
        api.set_timer_relative(self.interval)

    def on_timer(self, api: HostApi, t: int) -> None:
        assert self._dst is not None
        api.send(self._dst, self.size)
        api.count("tgen_sent_bytes", self.size)
        api.set_timer_relative(self.interval)

    def on_delivery(self, api: HostApi, t: int, src: int, seq: int, size: int, payload=None) -> None:
        api.count("tgen_recv_bytes", size)


@register_model("tgen-server")
class TgenServer:
    passive_delivery = True

    @classmethod
    def from_args(cls, args: list[str]) -> "TgenServer":
        parse_kv_args(args, known=set())  # accepts no args
        return cls()

    def on_start(self, api: HostApi) -> None:
        pass

    def on_timer(self, api: HostApi, t: int) -> None:
        pass

    def on_delivery(self, api: HostApi, t: int, src: int, seq: int, size: int, payload=None) -> None:
        api.count("tgen_recv_bytes", size)


@register_model("ping")
class Ping:
    """``--peer H --count K --interval I --size B``: send K echo requests;
    a peerless instance is the echo server.  Counters: ping_sent /
    ping_echoed / ping_recv."""

    def __init__(self, peer: str | None, count: int, interval_ns: int, size: int) -> None:
        self.peer = peer
        self.count_target = count
        self.interval = interval_ns
        self.size = size
        self.sent = 0
        self._dst: int | None = None

    @classmethod
    def from_args(cls, args: list[str]) -> "Ping":
        kv = parse_kv_args(args, known={"peer", "count", "interval", "size"})
        return cls(
            peer=kv.pop("peer", None),
            count=int(kv.pop("count", 10)),
            interval_ns=positive_interval(units.parse_time(kv.pop("interval", "1s")), "ping"),
            size=int(kv.pop("size", 84)),
        )

    def on_start(self, api: HostApi) -> None:
        if self.peer is not None:
            self._dst = api.resolve(self.peer)
            api.set_timer_relative(self.interval)

    def on_timer(self, api: HostApi, t: int) -> None:
        assert self._dst is not None
        if self.sent < self.count_target:
            api.send(self._dst, self.size)
            self.sent += 1
            api.count("ping_sent")
            api.set_timer_relative(self.interval)

    def on_delivery(self, api: HostApi, t: int, src: int, seq: int, size: int, payload=None) -> None:
        if self.peer is None:
            # echo server: bounce straight back
            api.send(src, size)
            api.count("ping_echoed")
        else:
            api.count("ping_recv")
