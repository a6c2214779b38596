"""tgen-style TCP workloads: fixed-size transfers over the simulated stack.

The TCP analog of the reference's tgen fixed_size integration workload
(src/test/tgen/fixed_size): each client opens one TCP connection to a
server, streams ``--size`` bytes through the full simulated stack
(handshake, Reno congestion control, loss recovery, flow control — all of
transport/tcp.py over the packet path of net/stack.py), then closes; the
server accepts any number of connections and counts received bytes.

Counters: ``tcp_tx_bytes`` / ``tcp_rx_bytes`` (payload), ``tcp_complete``
(client transfers fully sent+closed), ``tcp_accepted`` /
``tcp_conns_closed`` (server side), ``tcp_refused`` (connect errors).
CPU backend (host tier); the lane backend carries the vectorized stream
tier instead.

The JAX package's ``models/tgen_tcp.py``, copied into the port unchanged in law
(plain Python and numpy, no JAX).
"""

from __future__ import annotations

from ..config import units
from ..transport.tcp import PollState
from .base import HostApi, parse_kv_args, register_model

CHUNK = 65536
DEFAULT_PORT = 80


@register_model("tgen-tcp-client")
class TgenTcpClient:
    """``--server H --size B [--port P]``: connect, stream B bytes, close."""

    def __init__(self, server: str, size: int, port: int = DEFAULT_PORT) -> None:
        self.server = server
        self.size = size
        self.port = port
        self._remaining = size
        self._sock = None
        self._done = False
        self._established = False

    @classmethod
    def from_args(cls, args: list[str]) -> "TgenTcpClient":
        kv = parse_kv_args(args, known={"server", "size", "port"})
        return cls(
            server=kv.pop("server", "server"),
            size=units.parse_bytes(kv.pop("size", "1 MiB")),
            port=int(kv.pop("port", DEFAULT_PORT)),
        )

    def on_start(self, api: HostApi) -> None:
        dst = api.resolve(self.server)
        self._sock = api.net.connect(dst, self.port)
        self._sock.on_event = self._event

    def on_timer(self, api: HostApi, t: int) -> None:
        pass

    def on_delivery(self, api, t, src, seq, size, payload=None) -> None:
        pass

    def _event(self, sock, now: int) -> None:
        api = sock.stack.host
        ps = sock.poll()
        if ps & PollState.ERROR:
            if not self._done:
                self._done = True
                # refused = error before the handshake ever completed;
                # aborted = an established connection died mid-transfer
                api.count("tcp_refused" if not self._established else "tcp_aborted")
                sock.close()
            return
        if ps & PollState.WRITABLE:
            # only a completed handshake makes the socket writable; a
            # timer event in SYN_SENT (e.g. a SYN-retransmit) must not
            # mark the flow established or a later failure would count
            # as tcp_aborted instead of tcp_refused
            self._established = True
        while self._remaining > 0 and ps & PollState.WRITABLE:
            n = sock.send(bytes(min(self._remaining, CHUNK)))
            if n == 0:
                break
            self._remaining -= n
            api.count("tcp_tx_bytes", n)
            ps = sock.poll()
        if self._remaining == 0 and not self._done:
            self._done = True
            sock.close()
            api.count("tcp_complete")


@register_model("tgen-tcp-server")
class TgenTcpServer:
    """``[--port P]``: accept connections, count bytes until peer EOF."""

    def __init__(self, port: int = DEFAULT_PORT) -> None:
        self.port = port

    @classmethod
    def from_args(cls, args: list[str]) -> "TgenTcpServer":
        kv = parse_kv_args(args, known={"port"})
        return cls(port=int(kv.pop("port", DEFAULT_PORT)))

    def on_start(self, api: HostApi) -> None:
        lst = api.net.listen(self.port)
        lst.on_accept = self._accept

    def on_timer(self, api: HostApi, t: int) -> None:
        pass

    def on_delivery(self, api, t, src, seq, size, payload=None) -> None:
        pass

    def _accept(self, sock, now: int) -> None:
        sock.stack.host.count("tcp_accepted")
        sock.on_event = self._event
        self._event(sock, now)

    def _event(self, sock, now: int) -> None:
        api = sock.stack.host
        while True:
            data = sock.recv(CHUNK)
            if not data:
                break
            api.count("tcp_rx_bytes", len(data))
        if (
            sock.tcp.at_eof()
            and not sock.tcp.is_closed()
            and not sock.poll() & PollState.SEND_CLOSED  # not already closing
        ):
            sock.close()
            api.count("tcp_conns_closed")
