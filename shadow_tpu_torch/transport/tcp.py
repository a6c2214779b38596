"""Sans-I/O TCP: the simulated transport state machine.

Rebuild of the reference's TCP capability — the sans-I/O Rust crate
(src/lib/tcp/src/{lib,states,connection,seq,window_scaling,buffer}.rs:
typestate machine Init/Listen/SynSent/SynReceived/Established/FinWait1/
FinWait2/Closing/TimeWait/CloseWait/LastAck/Rst/Closed, push_packet /
pop_packet / send / recv / poll API) plus the Reno congestion control the
reference keeps in its legacy C stack (src/main/host/descriptor/tcp.c,
tcp_cong_reno.c) — re-designed for this framework:

- **sans-I/O and sans-clock**: no timers are registered anywhere; every
  time-dependent entry point takes ``now`` (int ns) explicitly, and
  :meth:`TcpState.next_timeout` exposes the earliest deadline for the host
  event loop to schedule.  (The reference abstracts the clock behind a
  ``Dependencies`` trait, lib.rs:10-47; an explicit integer clock is the
  same idea with a lane-friendly shape.)
- **fixed-size integer state record**: every field of the protocol state
  (sequence space, windows, Reno, RTO) is a plain integer, so the lane
  backend can hold the same machine as an ``[N]``-array column each
  (backend/lanes.py, later milestone); byte buffers live host-side only.
- one segment timed for RTT at a time (Karn's rule: no samples from
  retransmitted data), RFC 6298 integer smoothing, exponential RTO backoff.

Intentional deviations (documented for the parity harness):

- no delayed ACK and no Nagle: every push that consumes data or a control
  flag triggers an immediate ACK; interactive-traffic coalescing is a
  wall-clock heuristic that hurts a discrete-event simulation's
  determinism budget and hides send/recv causality.
- loss recovery is NewReno + SACK (RFC 2018 receiver blocks from the
  reassembly stash, an RFC 6675-style sender scoreboard walking un-SACKed
  holes, ack-paced) — the capability of the reference's C++
  tcp_retransmit_tally.cc range bookkeeping.  SACK option bytes are not
  charged to the simulated wire size (documented simplification).
- no TCP timestamps / PAWS; simulated sequence spaces never wrap within a
  connection's lifetime at simulated bandwidths.

The JAX package's ``transport/tcp.py``, copied into the port unchanged in law
(plain Python and numpy, no JAX).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional

from ..net import ltcp

SEQ_MASK = 0xFFFFFFFF
NANOS_PER_SEC = 1_000_000_000

# -- wrapping 32-bit sequence arithmetic (seq.rs) ---------------------------


def seq_add(a: int, n: int) -> int:
    return (a + n) & SEQ_MASK


def seq_sub(a: int, b: int) -> int:
    """Distance a - b in sequence space (mod 2^32)."""
    return (a - b) & SEQ_MASK


def seq_lt(a: int, b: int) -> bool:
    """a < b in wrapping sequence order."""
    d = (b - a) & SEQ_MASK
    return 0 < d < 0x80000000


def seq_le(a: int, b: int) -> bool:
    return a == b or seq_lt(a, b)


def seq_gt(a: int, b: int) -> bool:
    return seq_lt(b, a)


def seq_ge(a: int, b: int) -> bool:
    return a == b or seq_lt(b, a)


def seq_max(a: int, b: int) -> int:
    return a if seq_ge(a, b) else b


def _merge_ranges(rel: list) -> list:
    """Fold sorted-or-not relative [a, b) ranges into a merged ascending
    list (shared by the receiver's SACK blocks and the sender scoreboard —
    one algorithm, one adjacency rule)."""
    merged: list[list[int]] = []
    for a, b in sorted(rel):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


# -- wire vocabulary --------------------------------------------------------


class TcpFlags(enum.IntFlag):
    FIN = 0x01
    SYN = 0x02
    RST = 0x04
    PSH = 0x08
    ACK = 0x10


@dataclasses.dataclass(frozen=True)
class TcpHeader:
    """One simulated TCP segment header (lib.rs:679 TcpHeader).  Addresses
    are (ip_u32, port) pairs; ``wscale`` is the window-scale option, present
    only on SYN segments (window_scaling.rs)."""

    src_ip: int
    src_port: int
    dst_ip: int
    dst_port: int
    seq: int
    ack: int
    flags: TcpFlags
    window: int  # as transmitted (already scaled down by the sender)
    wscale: Optional[int] = None  # SYN-only option
    sack_ok: bool = False  # SYN-only option: SACK permitted (RFC 2018)
    sack: tuple = ()  # up to 3 (start, end-exclusive) SACK blocks

    HEADER_BYTES = 20  # simulated wire size of the TCP header

    def src(self) -> tuple[int, int]:
        return (self.src_ip, self.src_port)

    def dst(self) -> tuple[int, int]:
        return (self.dst_ip, self.dst_port)


class State(enum.IntEnum):
    """states.rs:23-120 typestate set, as a plain enum: the lane backend
    stores this as an int column, and transitions become table lookups."""

    INIT = 0
    LISTEN = 1
    SYN_SENT = 2
    SYN_RECEIVED = 3
    ESTABLISHED = 4
    FIN_WAIT_1 = 5
    FIN_WAIT_2 = 6
    CLOSING = 7
    TIME_WAIT = 8
    CLOSE_WAIT = 9
    LAST_ACK = 10
    RST = 11
    CLOSED = 12


class PollState(enum.IntFlag):
    """lib.rs:602 PollState bits."""

    READABLE = 0x01
    WRITABLE = 0x02
    READY_TO_ACCEPT = 0x04
    ERROR = 0x08
    CLOSED = 0x10
    CONNECTING = 0x20
    RECV_CLOSED = 0x40
    SEND_CLOSED = 0x80


class TcpError(enum.IntEnum):
    NONE = 0
    RESET = 1
    TIMED_OUT = 2
    REFUSED = 3


@dataclasses.dataclass
class TcpConfig:
    """lib.rs:646 TcpConfig + the Reno/RTO knobs of the legacy C stack."""

    mss: int = 1460
    send_buffer: int = 131072  # reference experimental.socket_send_buffer
    recv_buffer: int = 174760  # reference experimental.socket_recv_buffer
    window_scaling: bool = True
    max_wscale: int = 8
    rto_initial: int = NANOS_PER_SEC  # RFC 6298 initial RTO
    rto_min: int = 200_000_000  # Linux's 200 ms floor
    rto_max: int = 60 * NANOS_PER_SEC
    syn_retries: int = 6
    data_retries: int = 15
    time_wait: int = 60 * NANOS_PER_SEC  # 2*MSL
    init_cwnd_segments: int = 10  # Linux IW10
    sack: bool = True  # RFC 2018/6675 selective acknowledgment
    congestion: str = "reno"  # "reno" | "cubic" (tcp_cong.c's registry)


def _icbrt(x: int) -> int:
    """floor(cbrt(x)) for arbitrary non-negative Python ints (Newton)."""
    if x <= 0:
        return 0
    y = 1 << ((x.bit_length() + 2) // 3)
    while True:
        y2 = (2 * y + x // (y * y)) // 3
        if y2 >= y:
            while y * y * y > x:
                y -= 1
            return y
        y = y2


class CongestionControl:
    """The pluggable congestion-control operations of the reference's
    tcp_cong.c (tcp_cong_reno.c is one registered instance), byte units.
    ``grow_ca`` advances cwnd for one new ACK in congestion avoidance;
    ``on_loss`` sets ssthresh at loss detection (fast-retransmit entry
    and RTO) and updates any algorithm state."""

    name = "?"

    def grow_ca(self, tcp: "TcpState", now: int) -> None:
        raise NotImplementedError

    def on_loss(self, tcp: "TcpState", now: int) -> None:
        raise NotImplementedError


class RenoCC(CongestionControl):
    """NewReno (tcp_cong_reno.c): AIMD, +mss²/cwnd per ACK, halve on loss."""

    name = "reno"

    def grow_ca(self, tcp: "TcpState", now: int) -> None:
        mss = tcp.cfg.mss
        tcp.cwnd += max(mss * mss // max(tcp.cwnd, 1), 1)

    def on_loss(self, tcp: "TcpState", now: int) -> None:
        tcp.ssthresh = max(tcp._outstanding() // 2, 2 * tcp.cfg.mss)


class CubicCC(CongestionControl):
    """CUBIC (RFC 9438) in bytes with the same fixed-point time algebra
    as the lane tier's law (net/ltcp.py, whose CUBIC_* constants this
    class shares): q units of 2**20 ns, a second approximated as 2**30
    ns, C = CUBIC_C_MUL/1024, beta = 0.3.  Scalar-only stack on plain
    Python ints, so — unlike the int32 lane twin — no epoch/offset
    clamps: windows here are bounded by buffers, not by RWND_SEGS, and
    the unclamped cubic must keep advancing for arbitrarily large
    W_max - cwnd gaps and epoch ages."""

    name = "cubic"

    def __init__(self) -> None:
        self.w_max = 0  # bytes
        self.epoch: Optional[int] = None  # ns
        self.origin = 0  # bytes
        self.k_q = 0

    def grow_ca(self, tcp: "TcpState", now: int) -> None:
        mss = tcp.cfg.mss
        if self.epoch is None:
            self.epoch = now
            if tcp.cwnd < self.w_max:
                self.origin = self.w_max
                # K_q^3 = (w_max - cwnd)/mss / 0.4 * 2**30  (exact 2.5x)
                self.k_q = _icbrt(
                    (self.w_max - tcp.cwnd) * 5 * (1 << 30) // (2 * mss)
                )
            else:
                self.origin = tcp.cwnd
                self.k_q = 0
        d_q = (now - self.epoch) >> 20
        offs = d_q - self.k_q
        neg = offs < 0
        if neg:
            offs = -offs
        # delta bytes = C * (offs/1024 s)^3 * mss = offs^3*mss*C_MUL >> 40
        delta = (offs * offs * offs * mss * ltcp.CUBIC_C_MUL) >> 40
        target = self.origin - delta if neg else self.origin + delta
        if target > tcp.cwnd:
            tcp.cwnd += max((target - tcp.cwnd) * mss // tcp.cwnd, 1)
        else:  # at/above the curve: minimal probing growth
            tcp.cwnd += max(mss * mss // (100 * max(tcp.cwnd, 1)), 1)

    def on_loss(self, tcp: "TcpState", now: int) -> None:
        if tcp.cwnd < self.w_max:  # fast convergence
            self.w_max = (tcp.cwnd * ltcp.CUBIC_FC_MUL) >> 10
        else:
            self.w_max = tcp.cwnd
        self.epoch = None
        tcp.ssthresh = max(
            (tcp.cwnd * ltcp.CUBIC_BETA_MUL) >> 10, 2 * tcp.cfg.mss
        )


CC_REGISTRY = {"reno": RenoCC, "cubic": CubicCC}


def make_cc(name: str) -> CongestionControl:
    try:
        return CC_REGISTRY[name]()
    except KeyError:
        raise ValueError(f"unknown congestion-control algorithm {name!r}")


class TcpState:
    """One TCP connection endpoint (lib.rs:244 TcpState).

    Usage: construct, then ``connect`` (active) or arrive via
    :class:`TcpListener` (passive).  Feed inbound segments with
    ``push_packet(now, header, payload)``; drain outbound segments with
    ``pop_packet(now)`` while ``wants_to_send()``; exchange app bytes with
    ``send``/``recv``; drive timeouts by calling ``on_timer(now)`` whenever
    ``next_timeout()`` expires."""

    def __init__(self, config: Optional[TcpConfig] = None) -> None:
        self.cfg = config or TcpConfig()
        self.state = State.INIT
        self.error = TcpError.NONE
        # addressing (set by connect/listener)
        self.local_ip = 0
        self.local_port = 0
        self.remote_ip = 0
        self.remote_port = 0
        # send sequence space (RFC 793): una <= nxt
        self.iss = 0
        self.snd_una = 0
        self.snd_nxt = 0  # next new byte to transmit (rewound on RTO)
        self.snd_max = 0  # highest sequence ever transmitted
        self.snd_wnd = self.cfg.mss  # peer-advertised, scaled up
        self.snd_wl1 = 0
        self.snd_wl2 = 0
        self.snd_wscale = 0  # shift applied to windows the peer advertises
        # receive sequence space
        self.irs = 0
        self.rcv_nxt = 0
        self.rcv_wscale = 0  # shift we advertise (and divide our window by)
        self.rcv_fin_seq: Optional[int] = None  # peer FIN position, if seen
        # congestion state (tcp_cong.c; the algorithm object carries any
        # per-connection extra state, e.g. CUBIC's epoch)
        self.cc = make_cc(self.cfg.congestion)
        self.cwnd = 0
        self.ssthresh = 1 << 30
        self.dup_acks = 0
        self.recover = 0  # NewReno recovery point
        self.in_recovery = False
        # RTO state (RFC 6298, integer ns)
        self.srtt = 0
        self.rttvar = 0
        self.rto = self.cfg.rto_initial
        self.rto_deadline: Optional[int] = None
        self.retries = 0
        self.time_wait_deadline: Optional[int] = None
        # RTT sampling: one timed segment at a time (Karn)
        self.ts_seq: Optional[int] = None
        self.ts_time = 0
        self.ts_retransmitted = False
        # buffers: send bytes snd_una..(snd_una+len(_snd_buf)); recv in-order
        self._snd_buf = bytearray()
        self._rcv_buf = bytearray()
        self._ooo: dict[int, bytes] = {}  # seq -> payload (reassembly)
        # SACK (RFC 2018 receiver blocks + RFC 6675-style sender holes):
        # negotiated on the SYN exchange; the scoreboard holds merged
        # (start, end-exclusive) ranges the peer reported holding, always
        # above snd_una; the cursor walks un-SACKed holes during recovery
        self.sack_enabled = False
        self._sacked: list[tuple[int, int]] = []
        self._rexmit_cursor = 0
        self._last_ooo: Optional[int] = None  # most recent stash (block 1)
        # control-signal latches
        self.syn_pending = False  # need to emit SYN / SYN-ACK
        self.fin_pending = False  # app closed; FIN not yet sent
        self.fin_seq: Optional[int] = None  # our FIN's sequence number
        self.ack_pending = False  # need to emit at least a pure ACK
        self.rexmit_pending = False  # head-of-line retransmit requested
        self.recv_shutdown = False

    # ------------------------------------------------------------------ api

    def connect(
        self,
        local: tuple[int, int],
        remote: tuple[int, int],
        iss: int,
        now: int,
    ) -> None:
        """Active open (lib.rs:285): emit SYN, go SYN_SENT.  ``iss`` comes
        from the host's deterministic RNG stream."""
        if self.state != State.INIT:
            raise ValueError(f"connect in state {self.state.name}")
        self.local_ip, self.local_port = local
        self.remote_ip, self.remote_port = remote
        self._set_iss(iss)
        if self.cfg.window_scaling:
            self.rcv_wscale = self._pick_wscale()
        self.state = State.SYN_SENT
        self.syn_pending = True
        self._arm_rto(now)

    def _set_iss(self, iss: int) -> None:
        self.iss = iss & SEQ_MASK
        self.snd_una = self.iss
        self.snd_nxt = self.iss  # SYN consumes one; accounted at emit
        self.snd_max = self.iss
        self.cwnd = self.cfg.init_cwnd_segments * self.cfg.mss

    def _pick_wscale(self) -> int:
        w = 0
        while (self.cfg.recv_buffer >> w) > 0xFFFF and w < self.cfg.max_wscale:
            w += 1
        return w

    def send(self, data: bytes) -> int:
        """Queue app bytes; returns accepted count (0 = would block)."""
        if self.state in (
            State.INIT,
            State.LISTEN,
            State.RST,
            State.CLOSED,
            State.TIME_WAIT,
        ):
            raise BrokenPipeError("send in non-sending state")
        if self.fin_pending or self.fin_seq is not None:
            raise BrokenPipeError("send after shutdown")
        room = self.cfg.send_buffer - len(self._snd_buf)
        take = min(room, len(data))
        if take > 0:
            self._snd_buf.extend(data[:take])
        return take

    def available(self) -> int:
        """Bytes recv() would return right now (FIONREAD)."""
        return len(self._rcv_buf)

    def peek(self, max_len: int) -> bytes:
        """Read in-order received bytes without consuming them (MSG_PEEK:
        no buffer drain, so no window update either)."""
        return bytes(self._rcv_buf[:max_len])

    def recv(self, max_len: int) -> bytes:
        """Drain in-order received bytes (empty = would block or EOF;
        distinguish via poll())."""
        out = bytes(self._rcv_buf[:max_len])
        del self._rcv_buf[:max_len]
        if out:
            # freeing buffer space opens the advertised window
            self.ack_pending = True
        return out

    def close(self, now: int) -> None:
        """Full close (lib.rs:266): queue FIN after pending data."""
        if self.state in (State.INIT, State.LISTEN):
            self.state = State.CLOSED
            return
        if self.state in (State.RST, State.CLOSED, State.TIME_WAIT):
            return
        if self.fin_pending or self.fin_seq is not None:
            return
        self.fin_pending = True
        self._arm_rto(now)

    def shutdown_recv(self) -> None:
        self.recv_shutdown = True
        self._rcv_buf.clear()

    def abort(self) -> None:
        """RST out (socket closed with data pending, or refused)."""
        self.state = State.RST if self.error != TcpError.NONE else State.CLOSED

    # ------------------------------------------------------------- inbound

    def push_packet(self, now: int, hdr: TcpHeader, payload: bytes = b"") -> None:
        """Process one inbound segment (lib.rs:309)."""
        if self.state in (State.CLOSED, State.RST):
            return
        if hdr.flags & TcpFlags.RST:
            self._on_rst(hdr)
            return
        if self.state == State.SYN_SENT:
            self._push_syn_sent(now, hdr)
            return
        # ---- RFC 793 sequence acceptability ------------------------------
        seg_len = len(payload)
        if not self._seq_acceptable(hdr.seq, seg_len, hdr.flags):
            self.ack_pending = True  # resynchronizing ACK
            return
        if hdr.flags & TcpFlags.SYN and self.state == State.SYN_RECEIVED:
            # duplicate SYN (our SYN-ACK was lost): re-ack
            self.syn_pending = True
            return
        if hdr.flags & TcpFlags.ACK:
            self._process_ack(now, hdr, seg_len)
        if seg_len:
            self._process_data(hdr.seq, payload)
        if hdr.flags & TcpFlags.FIN:
            self._process_fin(now, seq_add(hdr.seq, seg_len))

    def _push_syn_sent(self, now: int, hdr: TcpHeader) -> None:
        if not hdr.flags & TcpFlags.SYN:
            return
        self.irs = hdr.seq
        self.rcv_nxt = seq_add(hdr.seq, 1)
        if hdr.flags & TcpFlags.ACK and hdr.ack == seq_add(self.iss, 1):
            # normal open: SYN-ACK
            self.snd_una = hdr.ack
            self.snd_nxt = hdr.ack
            if hdr.wscale is not None and self.cfg.window_scaling:
                self.snd_wscale = hdr.wscale
            else:
                self.snd_wscale = 0
                self.rcv_wscale = 0  # peer didn't negotiate: both sides off
            self.sack_enabled = self.cfg.sack and hdr.sack_ok
            self.snd_wnd = hdr.window << self.snd_wscale
            self.snd_wl1 = hdr.seq
            self.snd_wl2 = hdr.ack
            self.state = State.ESTABLISHED
            self.ack_pending = True
            self.retries = 0
            # the SYN<->SYN-ACK exchange is an RTT sample (Karn applies)
            if self.ts_seq is not None and not self.ts_retransmitted:
                self._rtt_sample(now - self.ts_time)
            self.ts_seq = None
            self._disarm_rto_if_idle(now)
        else:
            # simultaneous open
            self.state = State.SYN_RECEIVED
            self.syn_pending = True

    def _seq_acceptable(self, seq: int, seg_len: int, flags: TcpFlags) -> bool:
        rcv_wnd = self._recv_window()
        seg_end = seq_add(seq, max(seg_len - 1, 0))
        if seg_len == 0:
            if rcv_wnd == 0:
                return seq == self.rcv_nxt
            return seq_le(self.rcv_nxt, seq) and seq_lt(
                seq, seq_add(self.rcv_nxt, rcv_wnd)
            ) or seq == self.rcv_nxt or seq_lt(seq, self.rcv_nxt)
        if rcv_wnd == 0:
            return False
        in_wnd = lambda s: seq_le(self.rcv_nxt, s) and seq_lt(
            s, seq_add(self.rcv_nxt, rcv_wnd)
        )
        # accept partly-old segments (retransmits overlapping rcv_nxt)
        return in_wnd(seq) or in_wnd(seg_end) or (
            seq_lt(seq, self.rcv_nxt) and seq_ge(seg_end, self.rcv_nxt)
        )

    def _on_rst(self, hdr: TcpHeader) -> None:
        if self.state == State.SYN_SENT:
            if hdr.flags & TcpFlags.ACK and hdr.ack == seq_add(self.iss, 1):
                self.error = TcpError.REFUSED
                self.state = State.RST
            return
        # window check: only in-window RSTs take effect
        if seq_lt(hdr.seq, self.rcv_nxt) or (
            self._recv_window() > 0
            and seq_ge(hdr.seq, seq_add(self.rcv_nxt, self._recv_window()))
        ):
            if hdr.seq != self.rcv_nxt:
                return
        self.error = TcpError.RESET
        self.state = State.RST
        self._snd_buf.clear()
        self._rcv_buf.clear()
        self.rto_deadline = None

    def _process_ack(self, now: int, hdr: TcpHeader, seg_len: int) -> None:
        ack = hdr.ack
        if seq_gt(ack, self.snd_max):
            self.ack_pending = True  # acks data we never sent
            return
        if self.sack_enabled and hdr.sack:
            self._sack_merge(hdr.sack)
        # window update (RFC 793 SND.WL1/WL2 discipline)
        if seq_lt(self.snd_wl1, hdr.seq) or (
            self.snd_wl1 == hdr.seq and seq_le(self.snd_wl2, ack)
        ):
            self.snd_wnd = hdr.window << self.snd_wscale
            self.snd_wl1 = hdr.seq
            self.snd_wl2 = ack

        if seq_gt(ack, self.snd_una):
            newly = seq_sub(ack, self.snd_una)
            self._advance_send_space(now, ack, newly)
        elif (
            ack == self.snd_una
            and self._outstanding() > 0
            and seg_len == 0
            and not hdr.flags & TcpFlags.FIN
            and not hdr.flags & TcpFlags.SYN
        ):
            self._on_dup_ack(now)

        self._maybe_transition_on_ack(now, ack)

    def _advance_send_space(self, now: int, ack: int, newly: int) -> None:
        """Cumulative ACK advanced: trim buffer, sample RTT, grow cwnd."""
        mss = self.cfg.mss
        # RTT sample (Karn: only if the timed segment wasn't retransmitted)
        if (
            self.ts_seq is not None
            and seq_gt(ack, self.ts_seq)
            and not self.ts_retransmitted
        ):
            self._rtt_sample(now - self.ts_time)
        if self.ts_seq is not None and seq_gt(ack, self.ts_seq):
            self.ts_seq = None

        data_acked = newly
        # the SYN consumes a sequence number but no buffer byte
        if seq_le(self.snd_una, self.iss) and seq_gt(ack, self.iss):
            data_acked -= 1
        # so does our FIN
        if self.fin_seq is not None and seq_gt(ack, self.fin_seq):
            data_acked -= 1
        if data_acked > 0:
            del self._snd_buf[:data_acked]
        self.snd_una = ack
        if self._sacked:
            self._sack_trim()
        if seq_gt(ack, self.snd_nxt):
            # a cumulative ACK past an RTO rewind point: everything up to it
            # is delivered, skip re-sending (go-back-N with snd_max memory)
            self.snd_nxt = ack

        if self.in_recovery:
            if seq_ge(ack, self.recover):
                # full recovery: deflate (NewReno)
                self.in_recovery = False
                self.cwnd = self.ssthresh
                self.dup_acks = 0
            else:
                # partial ack: retransmit next hole, stay in recovery
                self._rexmit_cursor = self.snd_una
                self.rexmit_pending = True
                self.cwnd = max(self.cwnd - newly + mss, mss)
        else:
            self.dup_acks = 0
            if self.cwnd < self.ssthresh:
                self.cwnd += min(newly, mss)  # slow start
            else:
                self.cc.grow_ca(self, now)  # per-algorithm CA growth
        self.retries = 0
        if self._outstanding() > 0 or self.fin_pending or self.syn_pending:
            self._arm_rto(now)
        else:
            self.rto_deadline = None
            self.rto = self._computed_rto()

    def _on_dup_ack(self, now: int) -> None:
        mss = self.cfg.mss
        self.dup_acks += 1
        if self.in_recovery:
            self.cwnd += mss  # inflate per extra dup-ack
            if self._holes_remain():
                # SACK: each returning dup-ack clocks out the next hole
                # instead of waiting for a partial ack per hole (the
                # go-back-N stall the scoreboard exists to avoid)
                self.rexmit_pending = True
        elif self.dup_acks == 3:
            # fast retransmit (tcp_cong.c entry: per-algorithm ssthresh)
            self.cc.on_loss(self, now)
            self.recover = self.snd_max
            self.in_recovery = True
            self.cwnd = self.ssthresh + 3 * mss
            self._rexmit_cursor = self.snd_una
            self.rexmit_pending = True

    def _maybe_transition_on_ack(self, now: int, ack: int) -> None:
        fin_acked = self.fin_seq is not None and seq_gt(ack, self.fin_seq)
        if self.state == State.SYN_RECEIVED and seq_gt(ack, self.iss):
            self.state = State.ESTABLISHED
            self.retries = 0
        if self.state == State.FIN_WAIT_1 and fin_acked:
            self.state = State.FIN_WAIT_2
            self.rto_deadline = None
        elif self.state == State.CLOSING and fin_acked:
            self._enter_time_wait(now)
        elif self.state == State.LAST_ACK and fin_acked:
            self.state = State.CLOSED
            self.rto_deadline = None

    def _process_data(self, seq: int, payload: bytes) -> None:
        # clip the old prefix of partly-duplicate segments
        if seq_lt(seq, self.rcv_nxt):
            skip = seq_sub(self.rcv_nxt, seq)
            if skip >= len(payload):
                self.ack_pending = True
                return
            payload = payload[skip:]
            seq = self.rcv_nxt
        if self.recv_shutdown:
            self.ack_pending = True
            return
        room = self._recv_room()
        if seq == self.rcv_nxt:
            take = min(len(payload), room)
            if take:
                self._rcv_buf.extend(payload[:take])
                self.rcv_nxt = seq_add(self.rcv_nxt, take)
                self._drain_ooo()
        elif room > 0 and len(self._ooo) < 256:
            self._ooo.setdefault(seq, payload)
            self._last_ooo = seq
        self.ack_pending = True

    def _drain_ooo(self) -> None:
        # purge stashes made fully obsolete by the in-order advance
        for s in [
            s
            for s, p in self._ooo.items()
            if seq_le(seq_add(s, len(p)), self.rcv_nxt)
        ]:
            del self._ooo[s]
        while True:
            nxt = self._ooo.pop(self.rcv_nxt, None)
            if nxt is None:
                # also handle overlapping stashes
                hit = None
                for s, p in self._ooo.items():
                    if seq_le(s, self.rcv_nxt) and seq_gt(
                        seq_add(s, len(p)), self.rcv_nxt
                    ):
                        hit = s
                        break
                if hit is None:
                    return
                p = self._ooo.pop(hit)
                nxt = p[seq_sub(self.rcv_nxt, hit):]
            take = min(len(nxt), self._recv_room())
            if take <= 0:
                return
            self._rcv_buf.extend(nxt[:take])
            self.rcv_nxt = seq_add(self.rcv_nxt, take)

    def _process_fin(self, now: int, fin_seq: int) -> None:
        if fin_seq != self.rcv_nxt:
            # FIN beyond a hole: remember, ack what we have
            self.rcv_fin_seq = fin_seq
            self.ack_pending = True
            return
        self.rcv_fin_seq = fin_seq
        self.rcv_nxt = seq_add(self.rcv_nxt, 1)
        self.ack_pending = True
        if self.state in (State.ESTABLISHED, State.SYN_RECEIVED):
            self.state = State.CLOSE_WAIT
        elif self.state == State.FIN_WAIT_1:
            # our FIN not yet acked -> simultaneous close
            self.state = State.CLOSING
        elif self.state == State.FIN_WAIT_2:
            self._enter_time_wait(now)

    def _enter_time_wait(self, now: int) -> None:
        self.state = State.TIME_WAIT
        self.rto_deadline = None
        self.time_wait_deadline = now + self.cfg.time_wait

    # ------------------------------------------------------------ outbound

    def wants_to_send(self) -> bool:
        """lib.rs:333 — does pop_packet have a segment to emit?"""
        if self.state in (State.INIT, State.LISTEN, State.CLOSED, State.RST):
            return False
        if self.syn_pending or self.ack_pending or self.rexmit_pending:
            return True
        if self._sendable_data() > 0:
            return True
        if self.fin_pending and len(self._snd_buf) == self._unsent_offset():
            return True
        return False

    def pop_packet(self, now: int) -> Optional[tuple[TcpHeader, bytes]]:
        """Emit the next outbound segment (lib.rs:318), or None."""
        if self.state in (State.INIT, State.LISTEN, State.CLOSED, State.RST):
            return None
        if self.syn_pending:
            return self._emit_syn(now)
        if self.rexmit_pending:
            return self._emit_retransmit(now)
        if self._sendable_data() > 0:
            return self._emit_data(now)
        if self.fin_pending and self._unsent_offset() == len(self._snd_buf):
            return self._emit_fin(now)
        if self.ack_pending:
            self.ack_pending = False
            return (self._header(TcpFlags.ACK, self.snd_nxt), b"")
        return None

    def _header(
        self, flags: TcpFlags, seq: int, wscale: Optional[int] = None
    ) -> TcpHeader:
        sack = ()
        if self.sack_enabled and self._ooo and not flags & TcpFlags.SYN:
            sack = self._sack_blocks()
        return TcpHeader(
            src_ip=self.local_ip,
            src_port=self.local_port,
            dst_ip=self.remote_ip,
            dst_port=self.remote_port,
            seq=seq,
            ack=self.rcv_nxt,
            flags=flags,
            window=self._advertised_window(),
            wscale=wscale,
            sack=sack,
        )

    def _sack_blocks(self) -> tuple:
        """RFC 2018 blocks from the reassembly stash: merged above-window
        ranges, the block containing the most recent arrival first, the
        rest ascending, at most 3 (the option-space limit)."""
        merged = _merge_ranges([
            [seq_sub(q, self.rcv_nxt), seq_sub(q, self.rcv_nxt) + len(p)]
            for q, p in self._ooo.items()
        ])
        blocks = [
            (seq_add(self.rcv_nxt, a), seq_add(self.rcv_nxt, b))
            for a, b in merged
        ]
        if self._last_ooo is not None:
            lr = seq_sub(self._last_ooo, self.rcv_nxt)
            for i, (a, b) in enumerate(merged):
                if a <= lr < b and i != 0:
                    blocks.insert(0, blocks.pop(i))
                    break
        return tuple(blocks[:3])

    def _emit_syn(self, now: int) -> tuple[TcpHeader, bytes]:
        self.syn_pending = False
        self.ack_pending = False
        wscale = self.rcv_wscale if self.cfg.window_scaling else None
        if self.state == State.SYN_SENT:
            flags = TcpFlags.SYN
        else:  # SYN_RECEIVED: SYN-ACK
            flags = TcpFlags.SYN | TcpFlags.ACK
        hdr = self._header(flags, self.iss, wscale=wscale)
        hdr = dataclasses.replace(hdr, sack_ok=self.cfg.sack)
        if self.snd_nxt == self.iss:
            self.snd_nxt = seq_add(self.iss, 1)
        self.snd_max = seq_max(self.snd_max, self.snd_nxt)
        self._arm_rto(now)
        if self.ts_seq is None:
            self.ts_seq = self.iss
            self.ts_time = now
            self.ts_retransmitted = False
        return (hdr, b"")

    def _unsent_offset(self) -> int:
        """Bytes of _snd_buf already sent (between snd_una and snd_nxt),
        excluding SYN/FIN sequence slots."""
        sent = seq_sub(self.snd_nxt, self.snd_una)
        if seq_le(self.snd_una, self.iss) and seq_ge(self.snd_nxt, seq_add(self.iss, 1)):
            sent -= 1  # SYN slot still unacked
        if self.fin_seq is not None and seq_gt(self.snd_nxt, self.fin_seq):
            sent -= 1
        return sent

    def _flight(self) -> int:
        """Window-gating flight: bytes between the cumulative-ack point and
        the *current* transmit cursor."""
        return seq_sub(self.snd_nxt, self.snd_una)

    def _outstanding(self) -> int:
        """Loss-bookkeeping flight: bytes ever sent and not yet acked
        (survives the RTO rewind of snd_nxt)."""
        return seq_sub(self.snd_max, self.snd_una)

    def _send_window(self) -> int:
        return min(self.snd_wnd, self.cwnd)

    def _sendable_data(self) -> int:
        if self.state not in (
            State.ESTABLISHED,
            State.CLOSE_WAIT,
            State.FIN_WAIT_1,  # rewound pre-FIN bytes retransmit from here
            State.CLOSING,
            State.LAST_ACK,
        ):
            return 0
        # every byte in _snd_buf is pre-FIN by construction (send() raises
        # after shutdown), so an RTO rewind may legitimately re-send them
        # even with the FIN outstanding
        unsent = len(self._snd_buf) - self._unsent_offset()
        wnd_room = self._send_window() - self._flight()
        return max(min(unsent, wnd_room), 0)

    def _emit_data(self, now: int) -> tuple[TcpHeader, bytes]:
        off = self._unsent_offset()
        n = min(self._sendable_data(), self.cfg.mss)
        payload = bytes(self._snd_buf[off : off + n])
        seq = self.snd_nxt
        flags = TcpFlags.ACK
        if off + n == len(self._snd_buf):
            flags |= TcpFlags.PSH
        self.snd_nxt = seq_add(self.snd_nxt, n)
        self.snd_max = seq_max(self.snd_max, self.snd_nxt)
        self.ack_pending = False
        if self.ts_seq is None:
            self.ts_seq = seq
            self.ts_time = now
            self.ts_retransmitted = False
        self._arm_rto_if_unarmed(now)
        return (self._header(flags, seq), payload)

    def _emit_fin(self, now: int) -> tuple[TcpHeader, bytes]:
        self.fin_pending = False
        self.fin_seq = self.snd_nxt
        self.snd_nxt = seq_add(self.snd_nxt, 1)
        self.snd_max = seq_max(self.snd_max, self.snd_nxt)
        self.ack_pending = False
        if self.state in (State.ESTABLISHED, State.SYN_RECEIVED):
            self.state = State.FIN_WAIT_1
        elif self.state == State.CLOSE_WAIT:
            self.state = State.LAST_ACK
        self._arm_rto(now)
        return (self._header(TcpFlags.FIN | TcpFlags.ACK, self.fin_seq), b"")

    def _sack_merge(self, blocks) -> None:
        """Fold reported blocks into the scoreboard (merged, above
        snd_una, relative ordering via wrapping distance from snd_una)."""
        base = self.snd_una
        rel = []
        for a, b in list(self._sacked) + [list(x) for x in blocks]:
            ra, rb = seq_sub(a, base), seq_sub(b, base)
            if rb == 0 or rb > 0x7FFFFFFF:
                continue  # entirely below the cumulative ack (or garbage)
            if ra > 0x7FFFFFFF:
                ra = 0  # straddles the ack point: clip to it
            if ra < rb:
                rel.append([ra, rb])
        merged = _merge_ranges(rel)
        self._sacked = [
            (seq_add(base, a), seq_add(base, b)) for a, b in merged
        ]

    def _sack_trim(self) -> None:
        self._sack_merge(())  # re-normalizing against the new snd_una

    def _next_hole(self, cursor: int) -> tuple[int, int]:
        """(hole_start, hole_limit) of the first un-SACKed range at/after
        ``cursor`` (skipping scoreboard ranges); limit caps the hole's
        length at the next SACKed range.  Falls back to (cursor, huge)
        when the scoreboard is empty — plain NewReno head retransmit."""
        base = self.snd_una
        pos = seq_sub(cursor, base)
        if pos > 0x7FFFFFFF:
            pos = 0
        for a, b in ((seq_sub(x, base), seq_sub(y, base))
                     for x, y in self._sacked):
            if pos < a:
                return (seq_add(base, pos), a - pos)
            if pos < b:
                pos = b
        return (seq_add(base, pos), 1 << 30)

    def _holes_remain(self) -> bool:
        """Un-SACKed, un-retransmitted sequence space below snd_max?
        Only meaningful WITH a scoreboard: on a non-SACK connection the
        empty-scoreboard fallback would claim a hole at the cursor and
        every dup-ack would blind-resend the next in-flight segment —
        data the receiver provably already holds."""
        if not self.in_recovery or not self._sacked:
            return False
        hole, _ = self._next_hole(seq_max(self._rexmit_cursor, self.snd_una))
        return seq_lt(hole, self.snd_max)

    def _emit_retransmit(self, now: int) -> tuple[TcpHeader, bytes]:
        """Head-of-line retransmission (fast retransmit / RTO / partial ack)."""
        self.rexmit_pending = False
        self.ack_pending = False
        if self.ts_seq is not None:
            self.ts_retransmitted = True
        # SYN / SYN-ACK retransmit
        if seq_le(self.snd_una, self.iss):
            wscale = self.rcv_wscale if self.cfg.window_scaling else None
            flags = (
                TcpFlags.SYN
                if self.state == State.SYN_SENT
                else TcpFlags.SYN | TcpFlags.ACK
            )
            self.snd_nxt = seq_max(self.snd_nxt, seq_add(self.iss, 1))
            self.snd_max = seq_max(self.snd_max, self.snd_nxt)
            self._arm_rto(now)
            hdr = dataclasses.replace(
                self._header(flags, self.iss, wscale=wscale),
                sack_ok=self.cfg.sack,
            )
            return (hdr, b"")
        # FIN retransmit
        if self.fin_seq is not None and self.snd_una == self.fin_seq:
            self.snd_nxt = seq_max(self.snd_nxt, seq_add(self.fin_seq, 1))
            self.snd_max = seq_max(self.snd_max, self.snd_nxt)
            self._arm_rto(now)
            return (self._header(TcpFlags.FIN | TcpFlags.ACK, self.fin_seq), b"")
        # data retransmit: the lowest un-SACKed hole (RFC 6675 NextSeg;
        # with an empty scoreboard this is the NewReno head at snd_una)
        cur = self.snd_una
        if self.in_recovery:
            cur = seq_max(self._rexmit_cursor, self.snd_una)
        hole, limit = self._next_hole(cur)
        if seq_ge(hole, self.snd_max):
            hole, limit = self._next_hole(self.snd_una)
        if self.fin_seq is not None and hole == self.fin_seq:
            # every data hole is SACKed/acked; the lost segment is the FIN
            self.snd_nxt = seq_max(self.snd_nxt, seq_add(self.fin_seq, 1))
            self.snd_max = seq_max(self.snd_max, self.snd_nxt)
            self._rexmit_cursor = seq_add(self.fin_seq, 1)
            self._arm_rto(now)
            return (self._header(TcpFlags.FIN | TcpFlags.ACK, self.fin_seq), b"")
        off = seq_sub(hole, self.snd_una)
        n = min(self.cfg.mss, limit, len(self._snd_buf) - off)
        if n <= 0:
            # stale cursor (e.g. everything above was just SACKed): head
            hole = self.snd_una
            off = 0
            n = min(self.cfg.mss, len(self._snd_buf))
        payload = bytes(self._snd_buf[off : off + n])
        self._rexmit_cursor = seq_add(hole, n)
        self.snd_nxt = seq_max(self.snd_nxt, seq_add(hole, n))
        self.snd_max = seq_max(self.snd_max, self.snd_nxt)
        self._arm_rto(now)
        return (self._header(TcpFlags.ACK, hole), payload)

    # -------------------------------------------------------------- timers

    def next_timeout(self) -> Optional[int]:
        """Earliest deadline; the host schedules a timer event for it."""
        deadlines = [
            d for d in (self.rto_deadline, self.time_wait_deadline) if d is not None
        ]
        return min(deadlines) if deadlines else None

    def on_timer(self, now: int) -> None:
        """Fire expired deadlines (retransmission timeout / 2MSL)."""
        if (
            self.time_wait_deadline is not None
            and now >= self.time_wait_deadline
        ):
            self.time_wait_deadline = None
            if self.state == State.TIME_WAIT:
                self.state = State.CLOSED
        if self.rto_deadline is not None and now >= self.rto_deadline:
            self.rto_deadline = None
            self._on_rto(now)

    def _on_rto(self, now: int) -> None:
        if (
            self._outstanding() == 0
            and not self.syn_pending
            and not self.fin_pending
        ):
            return
        in_handshake = self.state in (State.SYN_SENT, State.SYN_RECEIVED)
        limit = self.cfg.syn_retries if in_handshake else self.cfg.data_retries
        self.retries += 1
        if self.retries > limit:
            self.error = (
                TcpError.REFUSED if in_handshake else TcpError.TIMED_OUT
            )
            self.state = State.RST
            return
        mss = self.cfg.mss
        # RTO response: collapse to one segment; per-algorithm ssthresh
        self.cc.on_loss(self, now)
        self.cwnd = mss
        self.in_recovery = False
        self.dup_acks = 0
        # go-back-N: rewind transmission to the cumulative-ack point
        # (conservative RFC 2018 stance: drop the scoreboard so the
        # re-walk is a plain linear resend)
        self._sacked = []
        self._rexmit_cursor = self.snd_una
        self.snd_nxt = self.snd_una
        if self.fin_seq is not None and seq_lt(self.snd_una, self.fin_seq):
            # data ahead of the FIN rewound too: re-queue the FIN to be
            # re-emitted after the data (its old slot is now unreachable)
            self.fin_seq = None
            self.fin_pending = True
        self.rexmit_pending = True
        self.rto = min(self.rto * 2, self.cfg.rto_max)  # exponential backoff
        self._arm_rto(now)

    def _rtt_sample(self, r: int) -> None:
        r = max(r, 1)
        if self.srtt == 0:
            self.srtt = r
            self.rttvar = r // 2
        else:
            err = abs(self.srtt - r)
            self.rttvar = (3 * self.rttvar + err) // 4
            self.srtt = (7 * self.srtt + r) // 8
        self.rto = self._computed_rto()

    def _computed_rto(self) -> int:
        if self.srtt == 0:
            return self.cfg.rto_initial
        return max(
            min(self.srtt + max(4 * self.rttvar, 1_000_000), self.cfg.rto_max),
            self.cfg.rto_min,
        )

    def _arm_rto(self, now: int) -> None:
        self.rto_deadline = now + self.rto

    def _arm_rto_if_unarmed(self, now: int) -> None:
        if self.rto_deadline is None:
            self._arm_rto(now)

    def _disarm_rto_if_idle(self, now: int) -> None:
        if self._outstanding() == 0 and not self.fin_pending:
            self.rto_deadline = None

    # ------------------------------------------------------------- windows

    def _recv_room(self) -> int:
        return max(self.cfg.recv_buffer - len(self._rcv_buf), 0)

    def _recv_window(self) -> int:
        # round down to the advertisable granularity so both ends agree
        return (self._recv_room() >> self.rcv_wscale) << self.rcv_wscale

    def _advertised_window(self) -> int:
        return min(self._recv_room() >> self.rcv_wscale, 0xFFFF)

    # --------------------------------------------------------------- state

    def poll(self) -> PollState:
        """lib.rs:328 — readiness bits for poll/epoll integration."""
        ps = PollState(0)
        if self.error != TcpError.NONE:
            ps |= PollState.ERROR
        if self.state in (State.CLOSED, State.RST):
            ps |= PollState.CLOSED
            if self._rcv_buf:
                ps |= PollState.READABLE
            return ps
        if self.state in (State.SYN_SENT, State.SYN_RECEIVED):
            return ps | PollState.CONNECTING
        if self._rcv_buf or self._at_eof():
            ps |= PollState.READABLE
        if (
            self.state in (State.ESTABLISHED, State.CLOSE_WAIT)
            and not self.fin_pending
            and self.fin_seq is None
            and len(self._snd_buf) < self.cfg.send_buffer
        ):
            ps |= PollState.WRITABLE
        if self._at_eof():
            ps |= PollState.RECV_CLOSED
        if self.fin_seq is not None or self.fin_pending:
            ps |= PollState.SEND_CLOSED
        return ps

    def _at_eof(self) -> bool:
        """True when the peer's FIN has been fully consumed: reads past the
        in-order buffer return EOF."""
        return (
            self.rcv_fin_seq is not None
            and self.rcv_nxt == seq_add(self.rcv_fin_seq, 1)
            and not self._ooo
        )

    def at_eof(self) -> bool:
        return self._at_eof() and not self._rcv_buf

    def is_closed(self) -> bool:
        return self.state in (State.CLOSED, State.RST)

    def four_tuple(self) -> tuple[int, int, int, int]:
        return (self.local_ip, self.local_port, self.remote_ip, self.remote_port)


class TcpListener:
    """Passive open (states.rs ListenState): owns the backlog of embryonic
    and accept-ready children.  The demultiplexer (socket layer) routes
    SYNs for the listening port here; everything else goes to the child
    matching the 4-tuple."""

    def __init__(
        self,
        local: tuple[int, int],
        backlog: int = 128,
        config: Optional[TcpConfig] = None,
    ) -> None:
        self.local = local
        self.backlog = max(backlog, 1)
        self.cfg = config or TcpConfig()
        # embryonic + established children by (peer_ip, peer_port)
        self.children: dict[tuple[int, int], TcpState] = {}
        self.closed = False

    def push_syn(self, now: int, hdr: TcpHeader, iss: int) -> Optional[TcpState]:
        """Handle an inbound SYN: create (or re-ack) the embryonic child.
        Returns the child owning the segment, or None if dropped."""
        if self.closed:
            return None
        key = hdr.src()
        child = self.children.get(key)
        if child is not None:
            child.push_packet(now, hdr)
            return child
        if len(self.children) >= self.backlog:
            return None  # SYN dropped; the client's RTO will retry
        child = TcpState(dataclasses.replace(self.cfg))
        # the child's local address is the SYN's destination (a listener
        # on INADDR_ANY accepts on whichever interface the SYN targeted —
        # so loopback connections get a 127.0.0.1 local end, like Linux)
        child.local_ip, child.local_port = hdr.dst_ip, hdr.dst_port
        child.remote_ip, child.remote_port = key
        child._set_iss(iss)
        if child.cfg.window_scaling and hdr.wscale is not None:
            child.rcv_wscale = child._pick_wscale()
            child.snd_wscale = hdr.wscale
        else:
            child.rcv_wscale = 0
            child.snd_wscale = 0
        child.irs = hdr.seq
        child.rcv_nxt = seq_add(hdr.seq, 1)
        child.sack_enabled = child.cfg.sack and hdr.sack_ok
        child.snd_wnd = hdr.window  # unscaled until SYN negotiation done
        child.snd_wl1 = hdr.seq
        child.snd_wl2 = child.iss
        child.state = State.SYN_RECEIVED
        child.syn_pending = True
        child._arm_rto(now)
        self.children[key] = child
        return child

    def accept(self) -> Optional[TcpState]:
        """Pop one ESTABLISHED child (lib.rs:294), connection order by
        (peer_ip, peer_port) for determinism."""
        for key in sorted(self.children):
            child = self.children[key]
            if child.state in (State.ESTABLISHED, State.CLOSE_WAIT):
                del self.children[key]
                return child
        return None

    def has_ready(self) -> bool:
        return any(
            c.state in (State.ESTABLISHED, State.CLOSE_WAIT)
            for c in self.children.values()
        )

    def poll(self) -> PollState:
        return PollState.READY_TO_ACCEPT if self.has_ready() else PollState(0)

    def close(self) -> None:
        self.closed = True
        self.children.clear()
