"""Stream models: TCP flows under the lane-TCP law (parameters).

``stream-client --server H --size B [--mss M]`` opens one flow to the
server host at its start time and streams B bytes as MSS-sized segments —
handshake, NewReno or CUBIC congestion control (the host's ``congestion``
option), RTO, FIN teardown — over the engine's packet path.
``stream-server`` sinks any number of flows.

The behaviour is the vector law of ``backend/lanes_stream.py`` (kernel A on
the card); these classes carry each flow's transfer shape.
"""

from __future__ import annotations

import dataclasses

from ..config import units
from ..net import ltcp
from .base import parse_kv_args, register_model


@dataclasses.dataclass
class FlowState:
    """A sender flow's static shape: data segments, the final segment's
    payload, the MSS and the congestion-control algorithm."""

    segs: int = 0
    last_bytes: int = 1448
    mss: int = 1448
    cc: int = ltcp.CC_RENO


@register_model("stream-client")
class StreamClient:
    """One flow: connect at start, stream ``--size`` bytes, close."""

    def __init__(self, server: str, size: int, mss: int = 1448) -> None:
        self.server = server
        self.size = size
        self.mss = mss
        segs, last = ltcp.segs_for_size(size, mss)
        self.fs = FlowState(segs=segs, last_bytes=last, mss=mss)

    @classmethod
    def from_args(cls, args: list[str]) -> "StreamClient":
        kv = parse_kv_args(args, known={"server", "size", "mss"})
        return cls(
            server=kv.pop("server", "server"),
            size=units.parse_bytes(kv.pop("size", "1 MiB")),
            mss=int(kv.pop("mss", 1448)),
        )

    def set_congestion(self, name: str) -> None:
        """The host's ``congestion`` option selects the flow's algorithm
        (it follows the data sender; the server end never grows a
        window)."""
        self.fs.cc = ltcp.CC_BY_NAME[name]


@register_model("stream-server")
class StreamServer:
    """Sink any number of flows (one endpoint per client)."""

    @classmethod
    def from_args(cls, args: list[str]) -> "StreamServer":
        parse_kv_args(args, known=set())
        return cls()
