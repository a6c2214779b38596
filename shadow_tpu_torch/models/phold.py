"""PHOLD — the classic PDES benchmark workload (parameters).

A fixed population of messages bounces between hosts over UDP: each host
starts ``--messages`` of them, and every delivery sends one new message to
a uniformly random other host (the reference's ``src/test/phold``).
Message count is conserved absent network loss, so the workload is both a
load generator and a correctness check.

Peer choices come from the host's ``APP_STREAM`` threefry draws
(``core/rng.py``): draw ``d`` picks ``(host + 1 + u32_below(d, N - 1)) % N``
— the lane law in ``backend/lanes.py`` and kernel A.
"""

from __future__ import annotations

from .base import parse_kv_args, register_model


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
