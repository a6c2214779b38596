"""Per-host pcap capture of the simulated interface.

The JAX package's ``utils/pcap.py`` writer for the lane engine's traffic:
every packet a capturing host sends or receives becomes a record of
``hosts/<hostname>/eth0.pcap`` with a synthesized IPv4 header (protocol
253: model traffic has no transport header) and zero filler up to the wire
size the simulation charged.  Link type LINKTYPE_IPV4 (228); timestamps
are emulated wall-clock time (the simulation's 2000-01-01 epoch).

Records are buffered and written at ``close`` sorted by ``(timestamp,
key)``, so the file does not depend on the order of capture; past
``spill_bytes`` the buffer is sorted and spilled to a temporary file, and
``close`` merges the chunks, giving the same bytes as one sort.
"""

from __future__ import annotations

import heapq
import pickle
import socket
import struct
import tempfile
from pathlib import Path

LINKTYPE_IPV4 = 228
PCAP_MAGIC = 0xA1B2C3D4
IPPROTO_EXPERIMENTAL = 253  # model traffic with no real transport header


def _ipv4_header(src_ip: str, dst_ip: str, proto: int, total_len: int) -> bytes:
    return struct.pack(
        ">BBHHHBBH4s4s",
        0x45,  # version 4, IHL 5
        0,
        min(total_len, 0xFFFF),
        0,  # identification
        0,  # flags/fragment
        64,  # TTL
        proto,
        0,  # checksum (not computed)
        socket.inet_aton(src_ip),
        socket.inet_aton(dst_ip),
    )


class PcapWriter:
    """One capture file of raw IPv4 packets with emulated timestamps."""

    def __init__(self, path: str | Path, snaplen: int = 65535) -> None:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        self.snaplen = max(snaplen, 64)
        self._f = open(path, "wb")
        self._f.write(
            struct.pack(
                ">IHHiIII", PCAP_MAGIC, 2, 4, 0, 0, self.snaplen, LINKTYPE_IPV4
            )
        )
        self.records = 0
        self._buf: list = []
        self._buf_bytes = 0
        self._chunks: list = []
        self.spill_bytes = 32 << 20

    def _spill(self) -> None:
        self._buf.sort(key=lambda r: (r[0], r[1]))
        f = tempfile.TemporaryFile()
        for rec in self._buf:
            pickle.dump(rec, f, protocol=pickle.HIGHEST_PROTOCOL)
        self._chunks.append(f)
        self._buf = []
        self._buf_bytes = 0

    @staticmethod
    def _iter_chunk(f):
        f.seek(0)
        unpickler = pickle.Unpickler(f)
        while True:
            try:
                yield unpickler.load()
            except EOFError:
                return

    def close(self) -> None:
        if self._f is None:
            return
        self._buf.sort(key=lambda r: (r[0], r[1]))
        if self._chunks:
            # heapq.merge is stable in stream order and the chunks are in
            # capture order: ties land where one stable sort puts them
            merged = heapq.merge(
                *(self._iter_chunk(f) for f in self._chunks),
                self._buf,
                key=lambda r: (r[0], r[1]),
            )
        else:
            merged = iter(self._buf)
        for emu_ns, _key, body, orig in merged:
            self._record(emu_ns, body, orig)
        for f in self._chunks:
            f.close()
        self._chunks = []
        self._buf = []
        self._f.close()
        self._f = None

    def _record(self, emu_ns: int, packet: bytes, orig_len: int) -> None:
        incl = min(len(packet), self.snaplen)
        self._f.write(
            struct.pack(
                ">IIII",
                emu_ns // 1_000_000_000,
                (emu_ns % 1_000_000_000) // 1000,
                incl,
                max(orig_len, incl),
            )
        )
        self._f.write(packet[:incl])

    def capture(self, emu_ns: int, src_ip: str, dst_ip: str, size_bytes: int,
                key: tuple = ()) -> None:
        """Record one packet of ``size_bytes`` on the wire, written at
        close in ``(emu_ns, key)`` order; ``key = (direction, src, dst,
        seq)`` makes the order total."""
        filler = max(size_bytes - 20, 0)
        body = (_ipv4_header(src_ip, dst_ip, IPPROTO_EXPERIMENTAL, size_bytes)
                + b"\x00" * min(filler, self.snaplen))
        # only the snaplen prefix is ever written
        prefix = body[: self.snaplen]
        self._buf.append((emu_ns, key, prefix, size_bytes))
        self._buf_bytes += len(prefix) + 64
        if self._buf_bytes >= self.spill_bytes:
            self._spill()
        self.records += 1
