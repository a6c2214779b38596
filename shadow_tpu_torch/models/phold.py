"""PHOLD — the classic PDES benchmark workload.

Mirrors the role of the reference's phold stress test
(src/test/phold/test_phold.c): a fixed population of messages bounces
between hosts over UDP; every delivery triggers one new send to a uniformly
random peer.  Message count is conserved (absent network loss), which makes
it both a load generator and a correctness check.

Deterministic: peer choices come from the host's APP_STREAM threefry
counters, so replays (and the lane backend) pick identical peers.

The JAX package's ``models/phold.py``, copied into the port unchanged in law
(plain Python and numpy, no JAX).
"""

from __future__ import annotations

from ..core.rng import u32_below
from .base import HostApi, parse_kv_args, register_model


@register_model("phold")
class Phold:
    """``--messages M`` initial messages per host, ``--size B`` datagram
    size in bytes (IP size incl. headers, default 256)."""

    def __init__(self, messages: int = 1, size: int = 256) -> None:
        self.messages = messages
        self.size = size

    @classmethod
    def from_args(cls, args: list[str]) -> "Phold":
        kv = parse_kv_args(args, known={"messages", "size"})
        return cls(
            messages=int(kv.pop("messages", 1)),
            size=int(kv.pop("size", 256)),
        )

    def _pick_peer(self, api: HostApi) -> int:
        """Uniform peer among the *other* hosts (self excluded) — matches
        the lane backend's vectorized formula."""
        if api.num_hosts == 1:
            return api.host_id
        r = int(u32_below(api.rand_u32(), api.num_hosts - 1))
        return (api.host_id + 1 + r) % api.num_hosts

    def on_start(self, api: HostApi) -> None:
        for _ in range(self.messages):
            api.send(self._pick_peer(api), self.size)

    def on_timer(self, api: HostApi, t: int) -> None:  # pragma: no cover
        pass

    def on_delivery(self, api: HostApi, t: int, src: int, seq: int, size: int, payload=None) -> None:
        api.count("phold_hops")
        api.send(self._pick_peer(api), self.size)
