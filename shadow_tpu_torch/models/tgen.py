"""tgen-style traffic generation models (parameters).

``tgen-mesh`` — every host sends a ``--size`` B datagram every
``--interval`` to its peers (round-robin over all other hosts, or
``--peer-stride`` for sparser patterns), and counts whatever it receives:
the all-to-all mesh load.

``tgen-client`` / ``tgen-server`` — fixed-rate client streams to one named
server; the server counts.

All three are passive receivers: delivery only bumps counters, so the lane
engine applies it inline at packet arrival.

``ping`` — ``--peer H`` sends ``--count`` echo requests, one every
``--interval``; a peerless instance is the echo server, which bounces each
request straight back.  Both are active: their deliveries run app logic.
"""

from __future__ import annotations

from ..config import units
from ._validate import positive_interval
from .base import parse_kv_args, register_model


@register_model("tgen-mesh")
class TgenMesh:
    def __init__(self, interval_ns: int, size: int = 1428, stride: int = 1) -> None:
        self.interval = interval_ns
        self.size = size
        self.stride = stride

    @classmethod
    def from_args(cls, args: list[str]) -> "TgenMesh":
        kv = parse_kv_args(args, known={"interval", "size", "peer-stride"})
        return cls(
            interval_ns=positive_interval(units.parse_time(kv.pop("interval", "10 ms")), "tgen-mesh"),
            size=int(kv.pop("size", 1428)),
            stride=int(kv.pop("peer-stride", 1)),
        )


@register_model("tgen-client")
class TgenClient:
    """``--server H`` destination host id (or hostname resolved by the
    engine), ``--interval``, ``--size``."""

    def __init__(self, server: str, interval_ns: int, size: int = 1428) -> None:
        self.server = server
        self.interval = interval_ns
        self.size = size

    @classmethod
    def from_args(cls, args: list[str]) -> "TgenClient":
        kv = parse_kv_args(args, known={"server", "interval", "size"})
        return cls(
            server=kv.pop("server", "server"),
            interval_ns=positive_interval(units.parse_time(kv.pop("interval", "10 ms")), "tgen-client"),
            size=int(kv.pop("size", 1428)),
        )


@register_model("tgen-server")
class TgenServer:
    @classmethod
    def from_args(cls, args: list[str]) -> "TgenServer":
        parse_kv_args(args, known=set())  # accepts no args
        return cls()


@register_model("ping")
class Ping:
    """``--peer H --count K --interval I --size B``: send K echo requests;
    a peerless instance is the echo server."""

    def __init__(self, peer: str | None, count: int, interval_ns: int, size: int) -> None:
        self.peer = peer
        self.count_target = count
        self.interval = interval_ns
        self.size = size

    @classmethod
    def from_args(cls, args: list[str]) -> "Ping":
        kv = parse_kv_args(args, known={"peer", "count", "interval", "size"})
        return cls(
            peer=kv.pop("peer", None),
            count=int(kv.pop("count", 10)),
            interval_ns=positive_interval(units.parse_time(kv.pop("interval", "1s")), "ping"),
            size=int(kv.pop("size", 84)),
        )
