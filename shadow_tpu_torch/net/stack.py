"""Per-host network stack: TCP sockets over the simulated packet path.

The socket layer between apps and the engine's packet lifecycle — the
rebuild of the reference's NetworkInterface port-association table
(host/network/interface.rs:118-163), InetSocket demultiplex
(descriptor/socket/inet/mod.rs:630), and the TcpSocket wrapper around the
sans-I/O state machine (inet/tcp.rs).  One :class:`HostNetStack` per
simulated host:

- **demux**: inbound TCP segments route by exact 4-tuple to a connection,
  else by destination port to a listener (SYN), else answer RST — the
  same resolution order as the reference's association lookup;
- **sockets**: :class:`SimTcpSocket` wraps a ``transport.tcp.TcpState``
  and surfaces one ``on_event(sock, now)`` callback after every state
  change (app models then read ``poll()``);
- **timers**: each socket's ``next_timeout`` is armed as a host-local
  event; stale fires are filtered by deadline comparison (the reference's
  Timer re-arm discipline, host/timer.rs:13);
- **egress**: every generated segment is charged through the host's
  normal packet path (``host.send``) so TCP rides the same token buckets,
  loss draw, latency lookup, and CoDel as every other packet.

Determinism: connection iteration is sorted, ISS and ephemeral ports come
from the host's seeded streams, and all scheduling flows through the
host's ordered event queue.

The JAX package's ``net/stack.py``, copied into the port unchanged in law
(plain Python and numpy, no JAX).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

from ..core.event import Task
from ..transport.tcp import (
    PollState,
    TcpConfig,
    TcpFlags,
    TcpHeader,
    TcpListener,
    TcpState,
)

IP_HEADER_BYTES = 20
TCP_HEADER_BYTES = 20  # simulated wire overhead per segment
EPHEMERAL_PORT_START = 49152
LOOPBACK_U32 = 0x7F000001  # 127.0.0.1 (the simulated lo interface)


def is_loopback_u32(ip_u32: int) -> bool:
    """Any 127/8 address rides the simulated lo interface (the single
    predicate every tier uses — stack routing, managed connect/sendto)."""
    return (ip_u32 >> 24) == 127


@dataclasses.dataclass
class TcpSegment:
    """Engine-payload wrapper distinguishing TCP segments from datagram
    payloads on the shared packet path."""

    hdr: TcpHeader
    data: bytes

    @property
    def wire_size(self) -> int:
        return IP_HEADER_BYTES + TCP_HEADER_BYTES + len(self.data)


class SimTcpSocket:
    """A connected (or connecting) TCP socket bound to one host."""

    def __init__(self, stack: "HostNetStack", tcp: TcpState) -> None:
        self.stack = stack
        self.tcp = tcp
        self.on_event: Optional[Callable[["SimTcpSocket", int], None]] = None
        self._armed_deadline: Optional[int] = None
        # peer host id, resolved once (connect/accept); every segment of a
        # connection goes to the same host — no per-segment DNS lookups
        self.dst_host: Optional[int] = None

    # -- app API -----------------------------------------------------------

    def send(self, data: bytes) -> int:
        n = self.tcp.send(data)
        self.stack.flush_socket(self)
        return n

    def recv(self, max_len: int) -> bytes:
        out = self.tcp.recv(max_len)
        if out:
            self.stack.flush_socket(self)  # window update may need to go out
        return out

    def peek(self, max_len: int) -> bytes:
        """MSG_PEEK: read without consuming (no window update)."""
        return self.tcp.peek(max_len)

    def close(self) -> None:
        self.tcp.close(self.stack.host.now)
        self.stack.flush_socket(self)

    def poll(self) -> PollState:
        return self.tcp.poll()

    @property
    def key(self) -> tuple[int, int, int, int]:
        return self.tcp.four_tuple()


class SimTcpListener:
    """A listening socket; accepted children become SimTcpSockets."""

    def __init__(self, stack: "HostNetStack", listener: TcpListener, port: int):
        self.stack = stack
        self.listener = listener
        self.port = port
        # called as on_accept(sock, now) for each newly-established child
        self.on_accept: Optional[Callable[[SimTcpSocket, int], None]] = None

    def close(self) -> None:
        self.listener.close()
        self.stack.tcp_listeners.pop(self.port, None)


class HostNetStack:
    """All transport state of one host (TCP tier; UDP rides the managed-
    process port table for now)."""

    def __init__(self, host) -> None:
        self.host = host  # backend Host (cpu_engine.Host duck type)
        self.tcp_conns: dict[tuple[int, int, int, int], SimTcpSocket] = {}
        self.tcp_listeners: dict[int, SimTcpListener] = {}
        self._embryonic: dict[tuple[int, int, int, int], SimTcpSocket] = {}
        self._next_ephemeral = EPHEMERAL_PORT_START

    # -- ports -------------------------------------------------------------

    def _alloc_port(self) -> int:
        used = {k[1] for k in self.tcp_conns} | set(self.tcp_listeners)
        p = self._next_ephemeral
        while p in used:
            p += 1
        self._next_ephemeral = p + 1
        return p

    def _my_ip(self) -> int:
        import socket as pysocket

        ip = self.host.ip_of(self.host.host_id)
        return int.from_bytes(pysocket.inet_aton(ip), "big")

    # -- socket creation ---------------------------------------------------

    def connect(
        self,
        dst_host: int,
        dst_port: int,
        src_port: Optional[int] = None,
        config: Optional[TcpConfig] = None,
        loopback: bool = False,
    ) -> SimTcpSocket:
        """Active open to (dst_host, dst_port); segments start flowing now.
        ``loopback`` addresses the connection 127.0.0.1 -> 127.0.0.1 (both
        ends, like Linux) and rides the lo interface lifecycle."""
        import socket as pysocket

        if loopback:
            dst_ip = LOOPBACK_U32
            local = (LOOPBACK_U32, src_port or self._alloc_port())
        else:
            dst_ip = int.from_bytes(
                pysocket.inet_aton(self.host.ip_of(dst_host)), "big"
            )
            local = (self._my_ip(), src_port or self._alloc_port())
        tcp = TcpState(config or self._default_config())
        iss = self.host.rand_u32()
        tcp.connect(local, (dst_ip, dst_port), iss=iss, now=self.host.now)
        sock = SimTcpSocket(self, tcp)
        sock.dst_host = dst_host
        self.tcp_conns[tcp.four_tuple()] = sock
        self.flush_socket(sock)
        return sock

    def listen(
        self,
        port: int,
        backlog: int = 128,
        config: Optional[TcpConfig] = None,
    ) -> SimTcpListener:
        if port in self.tcp_listeners:
            raise OSError(f"port {port} already listening (EADDRINUSE)")
        tl = TcpListener(
            (self._my_ip(), port), backlog, config or self._default_config()
        )
        lst = SimTcpListener(self, tl, port)
        self.tcp_listeners[port] = lst
        return lst

    def _default_config(self) -> TcpConfig:
        cfg = self.host.engine.cfg
        return TcpConfig(
            send_buffer=cfg.experimental.socket_send_buffer,
            recv_buffer=cfg.experimental.socket_recv_buffer,
            congestion=cfg.hosts[self.host.host_id].congestion,
        )

    # -- inbound demux (interface.rs association lookup order) -------------

    def on_segment(self, now: int, seg: TcpSegment) -> None:
        hdr = seg.hdr
        key = (hdr.dst_ip, hdr.dst_port, hdr.src_ip, hdr.src_port)
        sock = self.tcp_conns.get(key) or self._embryonic.get(key)
        if sock is not None:
            sock.tcp.push_packet(now, hdr, seg.data)
            self._post_activity(sock, now)
            return
        lst = self.tcp_listeners.get(hdr.dst_port)
        if (
            lst is not None
            and hdr.flags & TcpFlags.SYN
            and not hdr.flags & TcpFlags.ACK
        ):
            child = lst.listener.push_syn(now, hdr, iss=self.host.rand_u32())
            if child is None:
                self.host.count("tcp_backlog_drops")
                return
            sock = SimTcpSocket(self, child)
            sock.dst_host = self._host_for_ip(hdr.src_ip)
            self._embryonic[child.four_tuple()] = sock
            self.flush_socket(sock)
            return
        self.host.count("tcp_unmatched_segments")
        self._send_rst_for(hdr, len(seg.data))

    def _send_rst_for(self, hdr: TcpHeader, seg_len: int) -> None:
        """Answer an unmatched non-RST segment with RST (connection refused
        — the behavior tests rely on for fast failure)."""
        if hdr.flags & TcpFlags.RST:
            return
        from ..transport.tcp import seq_add

        if hdr.flags & TcpFlags.ACK:
            rst = TcpHeader(
                src_ip=hdr.dst_ip, src_port=hdr.dst_port,
                dst_ip=hdr.src_ip, dst_port=hdr.src_port,
                seq=hdr.ack, ack=0, flags=TcpFlags.RST, window=0,
            )
        else:
            ack = seq_add(hdr.seq, seg_len + (1 if hdr.flags & TcpFlags.SYN else 0))
            rst = TcpHeader(
                src_ip=hdr.dst_ip, src_port=hdr.dst_port,
                dst_ip=hdr.src_ip, dst_port=hdr.src_port,
                seq=0, ack=ack, flags=TcpFlags.RST | TcpFlags.ACK, window=0,
            )
        self._transmit(rst, b"")

    # -- egress ------------------------------------------------------------

    def _transmit(
        self, hdr: TcpHeader, data: bytes, dst: Optional[int] = None
    ) -> None:
        seg = TcpSegment(hdr, data)
        if dst is None:  # only the unmatched-segment RST path resolves
            dst = self._host_for_ip(hdr.dst_ip)
        if dst is None:
            self.host.count("tcp_no_route_drops")
            return
        self.host.send(dst, seg.wire_size, payload=seg,
                       loopback=is_loopback_u32(hdr.dst_ip))

    def _host_for_ip(self, ip_u32: int) -> Optional[int]:
        if is_loopback_u32(ip_u32):  # the lo interface
            return self.host.host_id
        import socket as pysocket

        ip = pysocket.inet_ntoa(ip_u32.to_bytes(4, "big"))
        return self.host.engine.dns.host_for_ip(ip)

    # -- socket pumping ----------------------------------------------------

    def flush_socket(self, sock: SimTcpSocket) -> None:
        """Drain pending segments, re-arm the timer, reap closed state."""
        tcp = sock.tcp
        now = self.host.now
        while tcp.wants_to_send():
            out = tcp.pop_packet(now)
            if out is None:
                break
            hdr, data = out
            self._transmit(hdr, data, sock.dst_host)
        self._rearm_timer(sock)
        if tcp.is_closed():
            self.tcp_conns.pop(sock.key, None)
            self._embryonic.pop(sock.key, None)
            # an embryonic child that died must leave the backlog too
            lst = self.tcp_listeners.get(tcp.local_port)
            if lst is not None:
                lst.listener.children.pop((tcp.remote_ip, tcp.remote_port), None)

    def _post_activity(self, sock: SimTcpSocket, now: int) -> None:
        """After inbound processing: promote embryonic sockets, pump
        output, deliver the app callback."""
        from ..transport.tcp import State

        tcp = sock.tcp
        key = sock.key
        if key in self._embryonic and tcp.state in (
            State.ESTABLISHED,
            State.CLOSE_WAIT,
        ):
            self._embryonic.pop(key, None)
            self.tcp_conns[key] = sock
            # the child leaves the listener backlog; app gets the accept
            lst = self.tcp_listeners.get(tcp.local_port)
            if lst is not None:
                lst.listener.children.pop((tcp.remote_ip, tcp.remote_port), None)
                if lst.on_accept is not None:
                    lst.on_accept(sock, now)
        self.flush_socket(sock)
        if sock.on_event is not None:
            sock.on_event(sock, now)

    # -- timers ------------------------------------------------------------

    def _rearm_timer(self, sock: SimTcpSocket) -> None:
        deadline = sock.tcp.next_timeout()
        if deadline is None:
            sock._armed_deadline = None
            return
        if sock._armed_deadline is not None and sock._armed_deadline <= deadline:
            return  # an armed event already covers this deadline
        sock._armed_deadline = deadline
        key = sock.key

        def fire(host, stack=self, key=key, deadline=deadline) -> None:
            stack._timer_fired(key, deadline, host.now)

        self.host.push_local(max(deadline, self.host.now + 1), Task(fire, label="tcp-timer"))

    def _timer_fired(self, key, armed_deadline: int, now: int) -> None:
        sock = self.tcp_conns.get(key) or self._embryonic.get(key)
        if sock is None:
            return  # connection gone
        if sock._armed_deadline != armed_deadline:
            return  # stale fire: a newer arm superseded this one
        sock._armed_deadline = None
        sock.tcp.on_timer(now)
        self._post_activity(sock, now)
