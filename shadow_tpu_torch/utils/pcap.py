"""Per-host pcap capture of the simulated interface.

Rebuild of the reference's packet capture (utility/pcap_writer.rs:5,
interface.rs:45-75, host options ``pcap_enabled``/``pcap_capture_size``,
configuration.rs:602-612): every packet the host sends or receives is
written to ``hosts/<hostname>/eth0.pcap`` with synthesized IPv4/TCP/UDP
headers, readable by wireshark/tcpdump.

Link type is LINKTYPE_IPV4 (228): the simulation has no L2, so records
start at the IPv4 header.  Timestamps are emulated wall-clock time (the
simulation's 2000-01-01 epoch), so captures line up with strace logs and
plugin-observed clocks.

The JAX package's ``utils/pcap.py``, copied into the port unchanged in law
(plain Python and numpy, no JAX).
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

IPPROTO_TCP = 6
IPPROTO_UDP = 17
IPPROTO_EXPERIMENTAL = 253  # model traffic with no real transport header


def _ipv4_header(src_ip: str, dst_ip: str, proto: int, total_len: int) -> bytes:
    hdr = struct.pack(
        ">BBHHHBBH4s4s",
        0x45,  # version 4, IHL 5
        0,
        min(total_len, 0xFFFF),
        0,  # identification
        0,  # flags/fragment
        64,  # TTL
        proto,
        0,  # checksum (not computed; wireshark flags but parses)
        socket.inet_aton(src_ip),
        socket.inet_aton(dst_ip),
    )
    return hdr


class PcapWriter:
    """One capture file; records raw IPv4 packets with sim timestamps."""

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
        # records buffer until close() and are written SORTED by
        # (timestamp, key): a capture stamped with a future bucket
        # departure would otherwise land before an earlier-stamped inbound
        # written later, making the file order depend on internal
        # processing order — sorting gives both backends one well-defined
        # byte-identical layout.  Memory stays bounded: once the in-RAM
        # buffer passes ``spill_bytes`` it is sorted and spilled to an
        # unlinked temp file, and close() streams an external merge of
        # all chunks (stable, so the output is byte-identical to the
        # single-buffer sort).  Trade-off kept from the sorted design:
        # the FINAL file is written only at close(), so a crashed run
        # leaves a header-only pcap (the spill chunks die with the
        # process)
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
        if self._f is not None:
            self._buf.sort(key=lambda r: (r[0], r[1]))
            if self._chunks:
                # heapq.merge is stable in stream order, and chunks are
                # listed in capture order: ties land exactly where the
                # single-buffer stable sort would put them
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

    # -- packet synthesis ---------------------------------------------------

    def capture(
        self, emu_ns: int, src_ip: str, dst_ip: str, size_bytes: int,
        payload=None, key: tuple = (),
    ) -> None:
        """Record one simulated packet (written at close, sorted by
        ``(emu_ns, key)``; pass ``key=(direction, src_id, dst_id, seq)``
        for a total deterministic order).  ``payload`` is the engine's
        opaque delivery cargo: a UDP tuple, a TcpSegment, or None (model
        traffic).  ``size_bytes`` is the wire size the simulation
        charged."""
        body = self._synthesize(src_ip, dst_ip, size_bytes, payload)
        # buffer only the snaplen prefix (what _record would write), and
        # spill sorted chunks to disk past the memory budget
        prefix = body[: self.snaplen]
        self._buf.append((emu_ns, key, prefix, size_bytes))
        self._buf_bytes += len(prefix) + 64
        if self._buf_bytes >= self.spill_bytes:
            self._spill()
        self.records += 1

    def _synthesize(self, src_ip, dst_ip, size_bytes, payload) -> bytes:
        from ..net.stack import TcpSegment

        if isinstance(payload, TcpSegment):
            h = payload.hdr
            offset_flags = (5 << 12) | _tcp_flag_bits(h.flags)
            tcp = struct.pack(
                ">HHIIHHHH",
                h.src_port,
                h.dst_port,
                h.seq & 0xFFFFFFFF,
                h.ack & 0xFFFFFFFF,
                offset_flags,
                h.window & 0xFFFF,
                0,
                0,
            )
            total = 20 + len(tcp) + len(payload.data)
            return (
                _ipv4_header(src_ip, dst_ip, IPPROTO_TCP, total)
                + tcp
                + payload.data
            )
        if isinstance(payload, tuple) and len(payload) == 3:
            src_port, dst_port, data = payload
            udp = struct.pack(">HHHH", src_port, dst_port, 8 + len(data), 0)
            total = 20 + len(udp) + len(data)
            return _ipv4_header(src_ip, dst_ip, IPPROTO_UDP, total) + udp + data
        # model traffic: header + zero filler up to the charged wire size
        filler = max(size_bytes - 20, 0)
        return (
            _ipv4_header(src_ip, dst_ip, IPPROTO_EXPERIMENTAL, size_bytes)
            + b"\x00" * min(filler, self.snaplen)
        )


def _tcp_flag_bits(flags) -> int:
    """transport.tcp.TcpFlags -> wire bit positions (FIN=1 SYN=2 RST=4
    PSH=8 ACK=16)."""
    from ..transport.tcp import TcpFlags

    bits = 0
    if flags & TcpFlags.FIN:
        bits |= 0x01
    if flags & TcpFlags.SYN:
        bits |= 0x02
    if flags & TcpFlags.RST:
        bits |= 0x04
    if flags & TcpFlags.ACK:
        bits |= 0x10
    return bits
