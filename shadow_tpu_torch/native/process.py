"""Managed real-binary processes: the host side of the native shim.

The manager-side counterpart of the reference's process stack (L6:
process.rs / managed_thread.rs): spawns a real Linux binary with the
LD_PRELOAD shim injected, owns its shared-memory channel, and co-opts it
into the discrete-event simulation — the plugin only runs while the
simulation has handed it the turn, time only advances at event boundaries,
and all of its network I/O flows through the simulated packet path.

Sockets cover UDP datagrams and TCP streams: UDP rides the host-level port
table (the NetworkInterface association analog, interface.rs:118-163), TCP
rides the host's simulated stack (net/stack.py over transport/tcp.py), so a
real binary's connect/accept/send/recv exercise the same handshake,
congestion control, and loss recovery as the built-in models.  Readiness
(poll/select/epoll in the shim, SHIM_OP_POLL here) is evaluated against
simulated transport state; blocking calls park the plugin until a
simulation event completes them — the SyscallReturn::Block + condition
discipline of the reference (handler/mod.rs, syscall/condition.rs).

A ManagedApp is a normal engine app model (on_start/on_timer/on_delivery),
so managed processes and built-in models coexist on the same simulated
network.  CPU backend only: the lane backend rejects them via
LaneCompatError (syscall servicing is inherently host-side; that is the
design split BASELINE.json prescribes).

The JAX package's ``native/process.py``, copied into the port unchanged in law
(plain Python and numpy, no JAX).
"""

from __future__ import annotations

import logging
import os
import signal as _signal
import socket as pysocket
import struct
import subprocess
from pathlib import Path
from typing import Optional

from ..core import time as stime
from ..models.base import HostApi
from ..transport.tcp import PollState
from . import abi

log = logging.getLogger("shadow_tpu.native")

UDP_HEADER_BYTES = 28  # IP (20) + UDP (8): wire size = payload + header
EPHEMERAL_PORT_START = 49152

# CPU model (general.model_unblocked_syscall_latency — the reference's
# host/cpu.rs + preempt.rs discipline): every serviced call charges a fixed
# simulated latency; once the unapplied balance crosses the threshold the
# process is forced to yield that much simulated time before its next call
# is serviced.  Deterministic: counts calls, not wall time.
SYSCALL_LATENCY_NS = 1_000  # 1 us per serviced call
MAX_UNAPPLIED_LATENCY_NS = 100_000  # forced yield every ~100 calls
# busy-loop preemption quantum (the reference's preempt.rs): with the CPU
# model on, the shim's CPU-time itimer forces a yield after this much
# native CPU time and the manager charges it as simulated time — a plugin
# spinning on locally-serviced clock reads can no longer livelock a round
PREEMPT_QUANTUM_NS = 10_000_000  # 10 ms

# errno values the manager hands back over the channel (Linux numbers via
# the stdlib so the table can't drift)
from errno import (  # noqa: E402
    EADDRINUSE, EAGAIN, EALREADY, EBADF, EBUSY, ECHILD, ECONNREFUSED,
    ECONNRESET, EDEADLK, EDESTADDRREQ, EHOSTUNREACH, EINPROGRESS, EINTR,
    EINVAL, EISCONN, ENOENT, ENOSYS, ENOTCONN, ENOTSOCK, EOPNOTSUPP,
    EPERM, EPIPE, ESRCH,
    ETIMEDOUT,
)


def default_shim_path() -> Path:
    return (
        Path(__file__).resolve().parents[2] / "native" / "build" / "libshadow_shim.so"
    )


def require_dynamic_elf(path: str) -> None:
    """Reject static binaries up front: LD_PRELOAD cannot interpose them
    (same policy as the reference, src/test/static-bin)."""
    with open(path, "rb") as f:
        ident = f.read(16)
        if ident[:4] != b"\x7fELF":
            raise ValueError(f"{path!r} is not an ELF binary")
        is64 = ident[4] == 2
        if not is64:
            raise ValueError(f"{path!r}: only 64-bit ELF is supported")
        f.seek(0)
        hdr = f.read(64)
        e_phoff = struct.unpack_from("<Q", hdr, 0x20)[0]
        e_phentsize = struct.unpack_from("<H", hdr, 0x36)[0]
        e_phnum = struct.unpack_from("<H", hdr, 0x38)[0]
        f.seek(e_phoff)
        phdrs = f.read(e_phentsize * e_phnum)
        for i in range(e_phnum):
            p_type = struct.unpack_from("<I", phdrs, i * e_phentsize)[0]
            if p_type == 3:  # PT_INTERP
                return
    raise ValueError(
        f"{path!r} is statically linked; the shim requires dynamic binaries"
    )


EVENTFD_MAX = 0xFFFFFFFFFFFFFFFE  # Linux: counter saturates at 2^64 - 2


# fd kinds that are NOT sockets: socket ops on them answer ENOTSOCK,
# reads/writes take their own kind-specific paths
NONSOCK_KINDS = ("timer", "event", "inotify")


class _VSocket:
    """One virtual fd of a managed process (fd number chosen by the
    shim — a reserved real kernel fd, so it can't collide in the plugin).
    Besides sockets this also models virtual timerfds and eventfds."""

    __slots__ = ("vfd", "kind", "port", "default_dst", "queue", "sim",
                 "listener", "accept_q", "recv_shut", "refs",
                 "count", "t_next", "t_interval", "t_gen", "e_sem",
                 "watches", "next_wd", "queued_bytes")

    def __init__(self, vfd: int, kind: str) -> None:
        self.refs = 1  # fork shares the socket across processes
        self.vfd = vfd
        self.kind = kind  # "udp" | "tcp" | "listen" | "timer" | "event" | "inotify"
        self.port: Optional[int] = None
        self.default_dst: Optional[tuple[int, int]] = None  # (ip_be, port)
        self.queue: list[tuple[int, int, bytes]] = []  # udp: (src_ip_be, src_port, data)
        self.queued_bytes = 0  # udp: recv-buffer occupancy (drop-tail cap)
        self.sim = None  # SimTcpSocket (tcp)
        self.listener = None  # SimTcpListener (listen)
        self.accept_q: list = []  # SimTcpSockets awaiting accept()
        self.recv_shut = False  # SHUT_RD: reads return EOF / accept EINVAL
        # timer: expirations since last read/settime; event: the counter
        self.count = 0
        self.t_next: Optional[int] = None  # next expiry (sim ns)
        self.t_interval = 0  # re-arm period, 0 = one-shot
        self.t_gen = 0  # settime/close generation: cancels stale fires
        self.e_sem = False  # EFD_SEMAPHORE mode
        # inotify: wd -> (path, mask); the fork's minimal-stub semantics
        # (watches succeed, events never fire — handler/inotify.rs)
        self.watches: dict[int, tuple[str, int]] = {}
        self.next_wd = 1


class _Proc:
    """One schedulable plugin entity: an OS process — the root (spawned by
    the manager) or a fork child (registered via the PREFORK / FORKED /
    CHILD_START handshake) — or one THREAD of such a process (registered
    via PRETHREAD / THREAD_CREATED / THREAD_START, the reference's
    one-ManagedThread-per-thread model, managed_thread.rs:355).  Each has
    its own channel and blocked-op slot; threads SHARE their process's fd
    namespace (the same dict object), fork children copy it (sharing the
    refcounted socket objects, exactly like kernel fd inheritance)."""

    __slots__ = ("chan", "os_pid", "popen", "parent", "blocked", "sockets",
                 "dead", "label", "saw_start", "cpu_lat", "kind", "vtid",
                 "os_proc", "detached", "main_exited", "mutexes", "conds",
                 "sems", "thread_retvals", "futexes",
                 "_alarm_deadline", "_alarm_gen", "last_signal")

    def __init__(self, chan, os_pid=None, popen=None, parent=None, label="root",
                 kind="proc", vtid=0, os_proc=None):
        self.saw_start = False
        self.cpu_lat = 0  # unapplied syscall latency (cpu model)
        self.chan = chan
        self.os_pid = os_pid  # child pid (root uses popen.pid)
        self.popen = popen  # root only
        self.parent = parent  # _Proc or None
        self.blocked: Optional[tuple] = None
        self.dead = False
        self.label = label
        self.kind = kind  # "proc" | "thread"
        self.vtid = vtid  # thread only (>0)
        self.os_proc = os_proc if os_proc is not None else self  # owning process
        self.detached = False  # thread only
        self.main_exited = False  # proc only: main thread pthread_exit'd
        if kind == "thread":
            self.sockets = os_proc.sockets  # same object: shared fd table
        else:
            self.sockets: dict[int, _VSocket] = {}
            # sync-primitive tables, keyed by object address in the plugin —
            # the manager-side futex table (host/futex_table.rs analog)
            self.mutexes: dict[int, list] = {}  # addr -> [owner|None, waiters]
            self.conds: dict[int, list] = {}  # addr -> [(thread, mutex_addr)]
            self.sems: dict[int, list] = {}  # addr -> [value, waiters]
            self.thread_retvals: dict[int, int] = {}  # zombie vtid -> retval
            self._alarm_deadline = None  # simulated alarm/itimer expiry
            self._alarm_gen = 0
            self.last_signal = 0  # last managed signal delivered (kill op)
            # raw-futex wait queues: addr -> [(thread, bitset)], FIFO.
            # Keyed per OS process: a futex address names memory in ONE
            # address space (threads share it; fork children's copies are
            # distinct futexes, as with real private futexes)
            self.futexes: dict[int, list] = {}

    @property
    def pid(self) -> int:
        if self.kind == "thread":
            return self.os_proc.pid
        return self.popen.pid if self.popen is not None else self.os_pid

    def alive(self) -> bool:
        if self.dead:
            return False
        if self.kind == "thread":
            return self.os_proc.alive()
        if self.popen is not None:
            return self.popen.poll() is None
        # fork children are the plugin's OS children: they stay zombies
        # until the plugin reaps them, and a zombie answers kill(pid, 0) —
        # read the real state instead
        try:
            with open(f"/proc/{self.os_pid}/stat", "rb") as f:
                fields = f.read().rsplit(b") ", 1)
            return not fields[1].startswith(b"Z")
        except (FileNotFoundError, ProcessLookupError, IndexError):
            return False


class ManagedApp:
    """Drives one real binary as a simulation app (plus any processes it
    forks — each fork child gets its own channel and turn-taking slot)."""

    def __init__(self, argv: list[str], environment: Optional[dict] = None) -> None:
        self.argv = argv
        self.environment = dict(environment or {})
        self.proc: Optional[subprocess.Popen] = None
        # process set: procs[0] is the root; fork children append.  One
        # parked call per PROC (each channel strictly alternates):
        # ("sleep", deadline) | ("recvfrom", vfd, max_len) | ("recv", vfd, n)
        # | ("send", vfd, data) | ("connect", vfd) | ("accept", vfd, child_fd)
        # | ("poll", entries, deadline|None) | ("waitpid", pid)
        self.procs: list[_Proc] = []
        self.zombies: list[tuple[int, int, _Proc]] = []  # (pid, wstatus, parent)
        self._pending_chans: list = []  # channels built at PREFORK
        self._child_idx = 0
        self._vtid_next = 1  # virtual tids, app-wide (thread labels/joins)
        self._pending_thread_chans: dict[int, object] = {}  # vtid -> channel
        self._cur: Optional[_Proc] = None  # proc whose turn is being serviced
        self.finished = False
        self.exit_code: Optional[int] = None
        self._stdout_file = None
        self._stderr_file = None
        self._strace_file = None
        self._strace_mode = "off"
        self._api = None  # host handle, set at on_start (needed for teardown)
        # lifecycle config (ProcessOptions; set via configure_lifecycle)
        self.expected_final_state = {"exited": 0}
        self.shutdown_signal = "SIGTERM"
        # observed final state: ("exited", code) | ("signaled", name) |
        # ("running",) — None until the process ends
        self.final_state: Optional[tuple] = None

    # the op handlers below act on the process whose turn is active; these
    # aliases keep their bodies identical to the single-process form
    @property
    def chan(self):
        return self._cur.chan

    @property
    def sockets(self):
        return self._cur.sockets

    @property
    def _blocked(self):
        return self._cur.blocked

    @_blocked.setter
    def _blocked(self, v) -> None:
        self._cur.blocked = v

    @property
    def root(self) -> Optional[_Proc]:
        return self.procs[0] if self.procs else None

    def configure_lifecycle(self, expected_final_state, shutdown_signal: str) -> None:
        """Apply the config's process lifecycle options (the reference's
        expected_final_state / shutdown_signal, configuration.rs:688-718)."""
        self.expected_final_state = expected_final_state
        self.shutdown_signal = shutdown_signal

    def deliver_shutdown(self, api: HostApi) -> None:
        """Scheduled shutdown_time: send the configured signal to the real
        process.  Default-fatal signals terminate it (the common server
        shape: expected_final_state: {signaled: SIGTERM}).  A plugin that
        CATCHES the signal but then needs sim-serviced I/O cannot make
        progress (signal handlers run outside the simulation's turn-taking;
        see docs/managed-processes.md limitations), so after a short grace
        period it is force-killed and counted as managed_shutdown_forced —
        final state SIGKILL, honestly reported."""
        if self.finished or self.proc is None:
            return
        signum = getattr(_signal, self.shutdown_signal)
        try:
            self.proc.send_signal(signum)
        except ProcessLookupError:
            pass
        if self.root is not None:
            self.root.last_signal = signum
        # complete any parked interruptible call so the plugin leaves its
        # exchange (signals are fully masked while parked): the pending
        # signal is then observed — default action or handler — at the
        # mask restore
        prev = self._cur
        for entity in self.procs:
            if entity.dead or entity.blocked is None:
                continue
            b = entity.blocked
            if b[0] in self._INTERRUPTIBLE:
                entity.blocked = None
                self._cur = entity
                self._reply(api, "nanosleep" if b[0] == "sleep" else b[0],
                            -EINTR)
        self._cur = prev
        self.finished = True
        self._blocked = None
        forced = self._reap(grace_s=2)
        self._release_ports(api)
        self._close_files()
        api.count("managed_shutdown_forced" if forced else "managed_shutdown_signaled")

    def _reap(self, grace_s: float = 10) -> bool:
        """Wait for the process to end (force-kill past the grace period),
        record exit_code and final_state.  True when the kill was forced."""
        forced = False
        try:
            self.exit_code = self.proc.wait(timeout=grace_s)
        except subprocess.TimeoutExpired:
            forced = True
            self.proc.kill()
            self.exit_code = self.proc.wait()
        self._classify_exit()
        return forced

    def _classify_exit(self) -> None:
        if self.exit_code is not None and self.exit_code < 0:
            self.final_state = ("signaled", _signal.Signals(-self.exit_code).name)
        else:
            self.final_state = ("exited", self.exit_code or 0)

    def final_state_matches(self) -> Optional[str]:
        """None if the observed final state matches expected_final_state,
        else a human-readable mismatch description (the reference turns
        these into sim errors and a nonzero exit, worker.rs:475-481)."""
        if self.proc is None and self.final_state is None:
            return None  # never spawned (start_time past stop_time)
        exp = self.expected_final_state
        got = self.final_state or ("running",)
        if exp == "running" or exp == {"running": None}:
            ok = got == ("running",)
        elif isinstance(exp, dict) and "exited" in exp:
            ok = got == ("exited", int(exp["exited"]))
        elif isinstance(exp, dict) and "signaled" in exp:
            want = exp["signaled"]
            want = want if isinstance(want, str) else _signal.Signals(int(want)).name
            ok = got == ("signaled", want)
        elif exp == "exited":  # bare string: any clean exit code
            ok = got[0] == "exited"
        else:
            return f"unrecognized expected_final_state {exp!r}"
        if ok:
            return None
        return f"{Path(self.argv[0]).name}: expected {exp!r}, finished as {got!r}"

    # -- host-level port namespace (shared across sibling processes) -------

    @staticmethod
    def _host_ports(api) -> dict:
        """port -> (app, vfd) for the whole host, so sibling processes see
        each other's binds (EADDRINUSE) and each datagram has one owner."""
        return api.__dict__.setdefault("_udp_ports", {})

    @staticmethod
    def _alloc_port(api) -> int:
        nxt = api.__dict__.setdefault("_udp_next_port", EPHEMERAL_PORT_START)
        ports = ManagedApp._host_ports(api)
        while nxt in ports:
            nxt += 1
        api.__dict__["_udp_next_port"] = nxt + 1
        return nxt

    # -- engine stimuli ----------------------------------------------------

    def on_start(self, api: HostApi) -> None:
        require_dynamic_elf(self.argv[0])
        self._api = api
        host_dir = self._host_dir(api)
        host_dir.mkdir(parents=True, exist_ok=True)
        # unique per process on the host: sibling instances of one binary
        # must not share a channel or a stdout file
        idx = getattr(api, "apps", [self]).index(self)
        stem = f"{Path(self.argv[0]).name}.{idx}" if idx else Path(self.argv[0]).name
        # the manager pid in the channel filename makes collisions with
        # orphaned plugins of a killed previous run impossible (tmp dirs
        # get reused; an orphan still attached to a reused path would
        # corrupt the new run's handshake)
        shm_path = host_dir / f"{stem}.{os.getpid()}.shm"
        self._stem = stem
        self._host_dir_path = host_dir
        cfg = getattr(getattr(api, "engine", None), "cfg", None)
        self._exp = cfg.experimental if cfg is not None else None
        self._cpu_model = bool(
            cfg is not None and cfg.general.model_unblocked_syscall_latency
        )
        chan = abi.ShmChannel(
            str(shm_path),
            seed=self._proc_seed(api),
            sndbuf=self._exp.socket_send_buffer if self._exp else None,
            rcvbuf=self._exp.socket_recv_buffer if self._exp else None,
        )
        chan.set_clock(stime.sim_to_emu(api.now))
        self._strace_mode = self._cfg_strace_mode(api)
        if self._strace_mode != "off":
            self._strace_file = open(host_dir / f"{stem}.strace", "w")

        env = dict(os.environ)
        env.update(self.environment)
        shim = default_shim_path()
        if not shim.exists():
            raise RuntimeError(
                f"native shim not built at {shim}; run `make -C native`"
            )
        prior = env.get("LD_PRELOAD")
        env["LD_PRELOAD"] = f"{shim}:{prior}" if prior else str(shim)
        env["SHADOW_TPU_SHM"] = str(shm_path)
        # simulated-name resolution: the shim's getaddrinfo parses this
        # hosts file locally (the reference's memfd /etc/hosts, dns.rs:130)
        hosts_file = getattr(api, "hosts_file_path", None)
        if hosts_file is not None:
            env["SHADOW_TPU_HOSTS_FILE"] = str(hosts_file)
        env["SHADOW_TPU_HOSTNAME"] = api.hostname
        # interposition backstops (default on; see ExperimentalOptions)
        if self._exp is not None and not self._exp.use_seccomp:
            env["SHADOW_TPU_SECCOMP"] = "0"
        if self._cpu_model:
            env["SHADOW_TPU_PREEMPT_NS"] = str(PREEMPT_QUANTUM_NS)
        if self._exp is not None and not self._exp.use_vdso_patching:
            env["SHADOW_TPU_VDSO"] = "0"
        # separate stderr file (the reference's per-process data-dir
        # layout): shim warnings and app diagnostics must never corrupt
        # the app's stdout stream
        self._stdout_file = open(host_dir / f"{stem}.stdout", "wb")
        self._stderr_file = open(host_dir / f"{stem}.stderr", "wb")
        self.proc = subprocess.Popen(
            self.argv,
            env=env,
            stdout=self._stdout_file,
            stderr=self._stderr_file,
            stdin=subprocess.DEVNULL,
        )
        self.procs.append(_Proc(chan, popen=self.proc, label="root"))
        api.count("managed_procs")
        # first stop: the shim's OP_START from its constructor
        self._service(api, self.procs[0])

    def on_timer(self, api: HostApi, t: int) -> None:
        pass  # deadlines ride schedule_at closures, not the model timer

    def _deadline_fired(self, api, proc: "_Proc", deadline: int) -> None:
        if self.finished or proc.dead or proc.blocked is None:
            return
        self._cur = proc
        kind = proc.blocked[0]
        if kind == "cpulat" and proc.blocked[1] == deadline:
            proc.blocked = None
            self._service(api, proc, pending_req=True)
        elif kind == "sleep" and proc.blocked[1] == deadline:
            proc.blocked = None
            self._reply(api, "nanosleep", 0)
            self._service(api, proc)
        elif kind == "poll" and proc.blocked[2] == deadline:
            entries = proc.blocked[1]
            proc.blocked = None
            self._reply_poll(api, entries)  # whatever is ready now (maybe 0)
            self._service(api, proc)
        elif kind == "mutex" and proc.blocked[3] == deadline:
            m = self._mutex(proc.os_proc, proc.blocked[1])
            if proc in m[1]:
                m[1].remove(proc)
            proc.blocked = None
            self._reply(api, "mutex-lock", -ETIMEDOUT)
            self._service(api, proc)
        elif kind == "cond" and proc.blocked[3] == deadline:
            # POSIX: a timed-out cond wait re-acquires the mutex before
            # returning ETIMEDOUT
            c_addr, m_addr = proc.blocked[1], proc.blocked[2]
            os_p = proc.os_proc
            waiters = os_p.conds.get(c_addr, [])
            if proc in waiters:
                waiters.remove(proc)
            m = self._mutex(os_p, m_addr)
            if m[0] is None and not m[1]:
                m[0] = proc
                proc.blocked = None
                self._reply(api, "cond-wait", -ETIMEDOUT)
                self._service(api, proc)
            else:
                proc.blocked = ("mutex", m_addr, -ETIMEDOUT, None, "cond-wait")
                m[1].append(proc)
        elif kind == "sem" and proc.blocked[2] == deadline:
            s = self._sem(proc.os_proc, proc.blocked[1])
            if proc in s[1]:
                s[1].remove(proc)
            proc.blocked = None
            self._reply(api, "sem-wait", -ETIMEDOUT)
            self._service(api, proc)
        elif kind == "futex" and proc.blocked[2] == deadline:
            addr = proc.blocked[1]
            os_p = proc.os_proc
            q = [e for e in os_p.futexes.get(addr, []) if e[0] is not proc]
            if q:
                os_p.futexes[addr] = q
            else:
                os_p.futexes.pop(addr, None)
            proc.blocked = None
            self._reply(api, "futex-wait", -ETIMEDOUT)
            self._service(api, proc)

    def on_delivery(
        self, api: HostApi, t: int, src: int, seq: int, size: int, payload=None
    ) -> None:
        """A UDP datagram arrived on the host (TCP segments go to the host
        stack directly and surface through socket callbacks instead)."""
        if (
            payload is None
            or not isinstance(payload, tuple)
            or len(payload) not in (3, 4)
        ):
            return
        src_port, dst_port, data = payload[:3]
        via_lo = len(payload) == 4 and payload[3]
        owner = self._host_ports(api).get(dst_port)
        if owner is None:
            # count once per datagram, not once per sibling app
            if getattr(api, "apps", [self])[0] is self:
                api.count("udp_unreachable_drops")
            return
        app, sock = owner
        if app is not self or self.finished:
            return
        # recv-buffer drop-tail (the reference's bounded socket buffers,
        # udp.rs: a full buffer silently drops the datagram)
        from ..config.options import SOCKET_RECV_BUFFER_DEFAULT

        rcvbuf = (self._exp.socket_recv_buffer if self._exp
                  else SOCKET_RECV_BUFFER_DEFAULT)
        if sock.queued_bytes + len(data) > rcvbuf:
            api.count("udp_rcvbuf_drops")
            return
        # a lo datagram's source address is 127.0.0.1, like Linux
        src_ip_be = _ip_to_be("127.0.0.1" if via_lo else api.ip_of(src))
        sock.queue.append((src_ip_be, src_port, data))
        sock.queued_bytes += len(data)
        api.count("udp_rx_bytes", len(data))
        self._socket_activity_obj(api, sock)

    # -- channel servicing -------------------------------------------------


    def _reply(self, api: HostApi, opname: str, ret: int, args=None,
               payload: bytes = b"") -> None:
        """Send a reply (advancing the plugin's clock to sim-now) and write
        the strace line — the single exit point of every serviced call."""
        if self._cpu_model:
            self._cur.cpu_lat += SYSCALL_LATENCY_NS
        self.chan.set_clock(stime.sim_to_emu(api.now))
        self.chan.reply(ret, args=args, payload=payload)
        if self._strace_file is not None:
            label = self._cur.label
            self._trace_line(api, opname if label == "root" else f"[{label}] {opname}", ret)

    def _trace_line(self, api, opname: str, ret: int) -> None:
        err = f" {_errno_name(-ret)}" if ret < 0 else ""
        if self._strace_mode == "deterministic":
            self._strace_file.write(f"{opname} = {ret}{err}\n")
        else:
            self._strace_file.write(
                f"[{stime.fmt(api.now)}] {opname} = {ret}{err}\n"
            )

    def _service(
        self, api: HostApi, proc: Optional[_Proc] = None, pending_req: bool = False
    ) -> None:
        """Run one process until it blocks (sleep/recv/accept/poll/wait...)
        or exits — the analog of ManagedThread::resume's event loop
        (managed_thread.rs:187-325).  Exactly one process holds the turn at
        any moment; fork children get their own loops.  ``pending_req``:
        the next request is already in the channel (cpu-model yields)."""
        proc = proc or self.procs[0]
        pending = pending_req
        while True:
            self._cur = proc  # handlers act on the active process
            if proc.dead or self.finished:
                return
            try:
                if not pending:
                    proc.chan.wait_recv(proc.alive)
                pending = False
            except abi.PluginDied:
                self._entity_died(api, proc)
                return
            if (
                self._cpu_model
                and proc.cpu_lat >= MAX_UNAPPLIED_LATENCY_NS
                # farewell / first-turn messages cannot be delayed: EXIT and
                # THREAD_EXIT never get a reply at all
                and proc.chan.req.op not in (
                    abi.OP_EXIT, abi.OP_START, abi.OP_THREAD_EXIT,
                    abi.OP_THREAD_START, abi.OP_CHILD_START,
                )
            ):
                # apply the accumulated syscall latency: the pending call is
                # serviced only after cpu_lat of simulated time passes
                deadline = api.now + proc.cpu_lat
                proc.cpu_lat = 0
                api.count("cpu_latency_yields")
                self._park(api, ("cpulat", deadline), deadline)
                return
            req = proc.chan.req
            op = req.op
            if op == abi.OP_START:
                if proc.saw_start:
                    # the process exec'd a new image: its shim fd table is
                    # fresh, so the manager-side namespace must reset too
                    for sock in list(proc.sockets.values()):
                        self._drop_socket_ref(api, sock)
                    proc.sockets.clear()
                    # execve resets caught handlers to SIG_DFL while SIG_IGN
                    # survives (POSIX); the shm file persists across exec,
                    # so clear the handler bitmap here
                    proc.chan.shm.handled_signals = 0
                proc.saw_start = True
                self._reply(api, "start", 0)
            elif op == abi.OP_EXIT:
                # exit() may run on any thread's channel: it always means
                # the whole OS process is going down
                os_proc = proc.os_proc
                if proc.kind == "thread":
                    proc.dead = True
                if os_proc.parent is None:
                    self._finish(api, unexpected=False)
                else:
                    code = int(req.args[0]) & 0xFF
                    self._child_exit(api, os_proc, code << 8, unexpected=False)
                return
            elif op == abi.OP_NANOSLEEP:
                ns = req.args[0]
                if ns <= 0:
                    self._reply(api, "nanosleep", 0)
                else:
                    deadline = api.now + ns
                    self._park(api, ("sleep", deadline), deadline)
                    return
            elif op == abi.OP_SOCKET:
                self._op_socket(api, req)
            elif op == abi.OP_BIND:
                self._op_bind(api, req)
            elif op == abi.OP_CONNECT:
                if not self._op_connect(api, req):
                    return  # parked
            elif op == abi.OP_LISTEN:
                self._op_listen(api, req)
            elif op == abi.OP_ACCEPT:
                if not self._op_accept(api, req):
                    return
            elif op == abi.OP_SENDTO:
                if not self._op_sendto(api, req):
                    return
            elif op == abi.OP_RECVFROM:
                if not self._op_recvfrom(api, req):
                    return
            elif op == abi.OP_POLL:
                if not self._op_poll(api, req):
                    return
            elif op == abi.OP_SHUTDOWN:
                self._op_shutdown(api, req)
            elif op == abi.OP_GETSOCKNAME:
                self._op_getsockname(api, req)
            elif op == abi.OP_GETPEERNAME:
                self._op_getpeername(api, req)
            elif op == abi.OP_SOCKERR:
                self._op_sockerr(api, req)
            elif op == abi.OP_FIONREAD:
                self._op_fionread(api, req)
            elif op == abi.OP_PREFORK:
                self._op_prefork(api, req)
            elif op == abi.OP_FORKED:
                self._op_forked(api, req)
            elif op == abi.OP_WAITPID:
                if not self._op_waitpid(api, req):
                    return
            elif op == abi.OP_PRETHREAD:
                self._op_prethread(api, req)
            elif op == abi.OP_THREAD_CREATED:
                self._op_thread_created(api, req)
            elif op == abi.OP_THREAD_EXIT:
                # fire-and-forget: no reply (the OS thread is exiting)
                if self._thread_exit_msg(api, proc, req):
                    continue  # main retired, no threads left: await farewell
                return
            elif op == abi.OP_THREAD_JOIN:
                if not self._op_thread_join(api, req):
                    return
            elif op == abi.OP_MUTEX_LOCK:
                if not self._op_mutex_lock(api, req):
                    return
            elif op == abi.OP_MUTEX_UNLOCK:
                self._op_mutex_unlock(api, req)
            elif op == abi.OP_COND_WAIT:
                self._op_cond_wait(api, req)
                return  # always parks (reply arrives at wake/timeout)
            elif op == abi.OP_COND_WAKE:
                self._op_cond_wake(api, req)
            elif op == abi.OP_SEM_INIT:
                self._op_sem_init(api, req)
            elif op == abi.OP_SEM_WAIT:
                if not self._op_sem_wait(api, req):
                    return
            elif op == abi.OP_SEM_POST:
                self._op_sem_post(api, req)
            elif op == abi.OP_SEM_GET:
                self._op_sem_get(api, req)
            elif op == abi.OP_DUP:
                self._op_dup(api, req)
            elif op == abi.OP_TIMERFD_CREATE:
                self.sockets[int(req.args[0])] = _VSocket(
                    int(req.args[0]), "timer")
                self._reply(api, "timerfd-create", 0)
            elif op == abi.OP_TIMERFD_SETTIME:
                self._op_timerfd_settime(api, req)
            elif op == abi.OP_TIMERFD_GETTIME:
                self._op_timerfd_gettime(api, req)
            elif op == abi.OP_EVENTFD_CREATE:
                ev = _VSocket(int(req.args[0]), "event")
                ev.count = int(req.args[1])
                ev.e_sem = bool(req.args[2])
                self.sockets[int(req.args[0])] = ev
                self._reply(api, "eventfd-create", 0)
            elif op == abi.OP_KILL:
                self._op_kill(api, req)
            elif op == abi.OP_ALARM:
                self._op_alarm(api, req)
            elif op == abi.OP_INOTIFY_CREATE:
                # the fork's minimal inotify stubs (handler/inotify.rs):
                # a virtual fd whose watches succeed but never fire —
                # real inotify would observe the REAL filesystem
                # asynchronously, which is nondeterministic under the sim
                self.sockets[int(req.args[0])] = _VSocket(
                    int(req.args[0]), "inotify")
                api.count("managed_inotify_fds")
                self._reply(api, "inotify-create", 0)
            elif op == abi.OP_INOTIFY_ADD:
                self._op_inotify_add(api, req)
            elif op == abi.OP_INOTIFY_RM:
                self._op_inotify_rm(api, req)
            elif op == abi.OP_PREEMPT:
                # forced yield from the CPU-time itimer: charge the consumed
                # quantum as simulated time, reply when it has passed
                api.count("preempt_yields")
                deadline = api.now + max(int(req.args[0]), 1)
                self._park(api, ("sleep", deadline), deadline)
                return
            elif op == abi.OP_FUTEX_WAIT:
                self._op_futex_wait(api, req)
                return  # always parks (reply arrives at wake/timeout)
            elif op == abi.OP_FUTEX_WAKE:
                self._op_futex_wake(api, req)
            elif op == abi.OP_FUTEX_REQUEUE:
                self._op_futex_requeue(api, req)
            elif op == abi.OP_CLOSE:
                self._op_close(api, req)
            else:
                log.warning("unknown shim op %d from %s", op, self.argv[0])
                self._reply(api, f"op{op}", -ENOSYS)

    def _park(self, api: HostApi, blocked: tuple, deadline: Optional[int]) -> None:
        """Leave the active process waiting on its channel; a simulation
        event (or the deadline) completes the call later."""
        proc = self._cur
        proc.blocked = blocked
        if deadline is not None:
            api.schedule_at(
                max(deadline, api.now + 1),
                lambda h, d=deadline, pr=proc: self._deadline_fired(h, pr, d),
            )

    # -- fork / wait (the reference's clone/fork handling, handler/clone.rs,
    # managed_thread.rs native_clone — done the channel-handshake way) -----

    def _op_prefork(self, api: HostApi, req) -> None:
        """Parent is about to fork: build the child's channel now and hand
        back its path (the child attaches it before doing anything else)."""
        self._child_idx += 1
        path = (
            self._host_dir_path
            / f"{self._stem}.{os.getpid()}.child{self._child_idx}.shm"
        )
        seed = (
            self._proc_seed(api) + self._child_idx * 0x9E3779B97F4A7C15
        ) & ((1 << 64) - 1)
        chan = abi.ShmChannel(
            str(path),
            seed=seed,
            sndbuf=self._exp.socket_send_buffer if self._exp else None,
            rcvbuf=self._exp.socket_recv_buffer if self._exp else None,
        )
        chan.set_clock(stime.sim_to_emu(api.now))
        # fork inherits signal dispositions (POSIX): seed the child's
        # fresh channel with the parent's process-wide bitmaps, else a
        # SIG_IGN/handler installed before fork would read as SIG_DFL and
        # misfire the default-fatal park release
        pshm = self._cur.os_proc.chan.shm
        chan.shm.handled_signals = int(pshm.handled_signals)
        chan.shm.ignored_signals = int(pshm.ignored_signals)
        # the child inherits the FORKING thread's sigmask (per-thread state)
        if self._cur.chan is not None:
            chan.shm.blocked_signals = int(self._cur.chan.shm.blocked_signals)
        self._pending_chans.append(chan)
        self._reply(api, "prefork", 0, payload=str(path).encode())

    def _op_forked(self, api: HostApi, req) -> None:
        """Parent returned from fork: register the child process, inherit
        the fd table (shared refcounted sockets), and schedule its first
        turn at the current instant."""
        # children belong to the OS PROCESS, even when a thread forked
        parent = self._cur.os_proc
        child_pid = int(req.args[0])
        chan = self._pending_chans.pop(0)
        child = _Proc(chan, os_pid=child_pid, parent=parent,
                      label=f"child{self._child_idx}")
        for vfd, sock in parent.sockets.items():
            sock.refs += 1
            child.sockets[vfd] = sock
        self.procs.append(child)
        api.count("managed_forks")
        api.schedule_at(api.now, lambda h, c=child: self._start_child(h, c))
        self._reply(api, "forked", 0)

    def _start_child(self, api, child: _Proc) -> None:
        """The child's first turn: consume its CHILD_START and let it run."""
        if child.dead or self.finished:
            return
        self._cur = child
        try:
            child.chan.wait_recv(child.alive)
        except abi.PluginDied:
            self._child_exit(api, child, 9, unexpected=True)
            return
        self._reply(api, "child-start", 0)
        self._service(api, child)

    def _op_waitpid(self, api: HostApi, req) -> bool:
        pid = int(req.args[0])
        nohang = bool(req.args[1])
        # children belong to the OS process; any of its threads may wait
        proc = self._cur.os_proc
        z = self._match_zombie(proc, pid)
        if z is not None:
            self.zombies.remove(z)
            self._reply(api, "waitpid", z[0], args=[0, z[1]])
            return True
        if pid > 0:
            known = any(
                p.kind == "proc" and p.parent is proc and not p.dead
                and p.pid == pid
                for p in self.procs
            )
        else:
            known = any(
                p.kind == "proc" and p.parent is proc and not p.dead
                for p in self.procs
            ) or any(zp is proc for _pid, _st, zp in self.zombies)
        if not known:
            self._reply(api, "waitpid", -ECHILD)
            return True
        if nohang:
            self._reply(api, "waitpid", 0)
            return True
        self._park(api, ("waitpid", pid), None)
        return False

    def _match_zombie(self, parent: _Proc, pid: int):
        for z in self.zombies:
            zpid, _st, zparent = z
            if zparent is parent and (pid == -1 or pid == zpid):
                return z
        return None

    def _child_exit(self, api, proc: _Proc, wstatus: int, unexpected: bool) -> None:
        """A fork child ended: record the zombie, release its fd table,
        and complete a parked waitpid in the parent (if any)."""
        proc.dead = True
        proc.blocked = None
        self._reap_entity_threads(proc)
        for sock in list(proc.sockets.values()):
            self._drop_socket_ref(api, sock)
        proc.sockets.clear()
        proc.chan.close()
        self.zombies.append((proc.pid, wstatus, proc.parent))
        api.count("managed_child_exit_unexpected" if unexpected
                  else "managed_child_exit_clean")
        parent = proc.parent
        if parent is None or parent.dead:
            return
        # any thread of the parent process may hold the parked waitpid
        for waiter in self.procs:
            if (not waiter.dead and waiter.os_proc is parent
                    and waiter.blocked is not None
                    and waiter.blocked[0] == "waitpid"):
                want = waiter.blocked[1]
                z = self._match_zombie(parent, want)
                if z is not None:
                    self.zombies.remove(z)
                    waiter.blocked = None
                    self._cur = waiter
                    self._reply(api, "waitpid", z[0], args=[0, z[1]])
                    self._service(api, waiter)
                return

    def _reap_entity_threads(self, os_p: "_Proc") -> None:
        """Mark every thread of a dead OS process dead and drop channels."""
        for p in self.procs:
            if p.kind == "thread" and p.os_proc is os_p and not p.dead:
                p.dead = True
                p.blocked = None
                if p.chan is not None:
                    p.chan.close()
                    p.chan = None

    def _drop_socket_ref(self, api, sock: _VSocket) -> None:
        sock.refs -= 1
        if sock.refs <= 0:
            self._teardown_vsocket(api, sock)

    # -- threads (the reference's one-ManagedThread-per-thread model,
    # managed_thread.rs:355; sync primitives are the manager-side futex
    # table, host/futex_table.rs) ------------------------------------------

    def _live_threads(self, os_p: "_Proc", exclude=None) -> list:
        return [
            p for p in self.procs
            if p.kind == "thread" and p.os_proc is os_p and not p.dead
            and p is not exclude
        ]

    def _op_prethread(self, api: HostApi, req) -> None:
        """A thread is about to be created: build its channel now and hand
        back the path + virtual tid (the thread analog of PREFORK)."""
        vtid = self._vtid_next
        self._vtid_next += 1
        path = (
            self._host_dir_path / f"{self._stem}.{os.getpid()}.t{vtid}.shm"
        )
        seed = (
            self._proc_seed(api) ^ (vtid * 0xD1B54A32D192ED03)
        ) & ((1 << 64) - 1)
        chan = abi.ShmChannel(
            str(path),
            seed=seed,
            sndbuf=self._exp.socket_send_buffer if self._exp else None,
            rcvbuf=self._exp.socket_recv_buffer if self._exp else None,
        )
        chan.set_clock(stime.sim_to_emu(api.now))
        # a new thread inherits its creator's sigmask (per-thread state)
        if self._cur.chan is not None:
            chan.shm.blocked_signals = int(self._cur.chan.shm.blocked_signals)
        self._pending_thread_chans[vtid] = chan
        self._reply(api, "prethread", 0, args=[0, vtid],
                    payload=str(path).encode())

    def _op_thread_created(self, api: HostApi, req) -> None:
        """Creator returned from pthread_create: register the thread and
        schedule its first turn (args[1]=1 cancels a failed create)."""
        vtid = int(req.args[0])
        failed = bool(req.args[1])
        chan = self._pending_thread_chans.pop(vtid, None)
        if failed or chan is None:
            if chan is not None:
                chan.close()
            self._reply(api, "thread-created", 0)
            return
        os_p = self._cur.os_proc
        t = _Proc(chan, os_pid=os_p.pid, parent=self._cur, label=f"t{vtid}",
                  kind="thread", vtid=vtid, os_proc=os_p)
        self.procs.append(t)
        api.count("managed_threads")
        api.schedule_at(api.now, lambda h, th=t: self._start_thread(h, th))
        self._reply(api, "thread-created", 0)

    def _start_thread(self, api, t: "_Proc") -> None:
        """The thread's first turn: consume its THREAD_START and run it."""
        if t.dead or self.finished:
            return
        self._cur = t
        try:
            t.chan.wait_recv(t.alive)
        except abi.PluginDied:
            self._entity_died(api, t)
            return
        self._reply(api, "thread-start", 0)
        self._service(api, t)

    def _entity_died(self, api, proc: "_Proc") -> None:
        """The OS process behind an entity died without a farewell.  If the
        simulation itself delivered a signal (kill op), report THAT as the
        termination signal; SIGKILL otherwise."""
        os_p = proc.os_proc
        sig = os_p.last_signal or 9
        if os_p.parent is None:
            self._finish(api, unexpected=True)
        else:
            self._child_exit(api, os_p, sig, unexpected=True)

    def _thread_exit_msg(self, api: HostApi, proc: "_Proc", req) -> bool:
        """A THREAD_EXIT farewell arrived on ``proc``'s channel (no reply:
        the OS thread is on its way out).  True = the whole OS process is
        about to exit naturally and its farewell will arrive on this SAME
        channel, so the caller should keep waiting on it."""
        vtid = int(req.args[0])
        retval = int(req.args[1])
        os_p = proc.os_proc
        if vtid == 0:
            # the MAIN thread retired via pthread_exit: the process lives
            # while other threads run; its channel goes quiet
            os_p.main_exited = True
            os_p.blocked = None
            self._thread_release_locks(api, os_p)  # abandon held mutexes
            api.count("managed_thread_main_retired")
            return not self._live_threads(os_p)
        self._thread_release_locks(api, proc)
        proc.blocked = None
        api.count("managed_thread_exits")
        if os_p.main_exited and not self._live_threads(os_p, exclude=proc):
            # last thread out after main retired: glibc exit(0) is
            # imminent — keep the channel serviceable for the farewell
            if not proc.detached:
                os_p.thread_retvals[proc.vtid] = retval
            return True
        proc.dead = True
        if not proc.detached:
            os_p.thread_retvals[proc.vtid] = retval
            self._wake_joiner(api, os_p, proc.vtid)
        if proc.chan is not None:
            proc.chan.close()
            proc.chan = None
        return False

    def _resume_granted(self, api, proc: "_Proc", opname: str, ret: int,
                        args=None) -> None:
        """Complete a parked call whose state is already settled (ownership
        granted, retval popped).  The reply + resume are DEFERRED to an
        engine event at the current instant so the currently-active thread
        parks first — preserving strict turn-taking: at most one plugin
        entity runs natively at any moment (the shim ABI invariant the
        determinism guarantee rests on)."""

        def fire(h, p=proc):
            if p.dead or self.finished:
                return
            self._cur = p
            self._reply(h, opname, ret, args=args)
            self._service(h, p)

        api.schedule_at(api.now, fire)

    def _wake_joiner(self, api, os_p: "_Proc", vtid: int) -> None:
        for p in self.procs:
            if (not p.dead and p.os_proc is os_p and p.blocked is not None
                    and p.blocked[0] == "join" and p.blocked[1] == vtid):
                rv = os_p.thread_retvals.pop(vtid, 0)
                p.blocked = None
                self._resume_granted(api, p, "thread-join", 0, args=[0, rv])
                return

    def _op_thread_join(self, api: HostApi, req) -> bool:
        vtid = int(req.args[0])
        detach = bool(req.args[1])
        os_p = self._cur.os_proc
        if not detach and vtid == self._cur.vtid:
            # join(self) would park forever; glibc returns EDEADLK
            self._reply(api, "thread-join", -EDEADLK)
            return True
        if detach:
            if vtid in os_p.thread_retvals:
                os_p.thread_retvals.pop(vtid)
            else:
                for p in self._live_threads(os_p):
                    if p.vtid == vtid:
                        p.detached = True
            self._reply(api, "thread-detach", 0)
            return True
        if vtid in os_p.thread_retvals:
            rv = os_p.thread_retvals.pop(vtid)
            self._reply(api, "thread-join", 0, args=[0, rv])
            return True
        if any(p.vtid == vtid for p in self._live_threads(os_p)):
            self._park(api, ("join", vtid), None)
            return False
        self._reply(api, "thread-join", -ESRCH)
        return True

    def _thread_release_locks(self, api, proc: "_Proc") -> None:
        """An exiting thread abandons its mutexes: hand them to the next
        waiter so the simulation cannot deadlock on a dead owner."""
        os_p = proc.os_proc
        for addr, m in list(os_p.mutexes.items()):
            if m[0] is proc:
                m[0] = None
                self._mutex_grant_next(api, os_p, addr)

    # -- virtualized sync primitives (address-keyed, per OS process) -------

    @staticmethod
    def _mutex(os_p: "_Proc", addr: int) -> list:
        return os_p.mutexes.setdefault(addr, [None, []])

    @staticmethod
    def _sem(os_p: "_Proc", addr: int) -> list:
        return os_p.sems.setdefault(addr, [0, []])

    def _op_mutex_lock(self, api: HostApi, req) -> bool:
        addr = int(req.args[0])
        try_ = bool(req.args[1])
        timeout = int(req.args[2])
        cur = self._cur
        m = self._mutex(cur.os_proc, addr)
        if m[0] is None:
            m[0] = cur
            self._reply(api, "mutex-lock", 0)
            return True
        if try_:
            # POSIX: trylock reports EBUSY for ANY held mutex, self-held too
            self._reply(api, "mutex-lock", -EBUSY)
            return True
        if m[0] is cur:
            # non-recursive: the honest error beats hanging the simulation
            self._reply(api, "mutex-lock", -EDEADLK)
            return True
        deadline = None if timeout < 0 else api.now + timeout
        m[1].append(cur)
        self._park(api, ("mutex", addr, 0, deadline, "mutex-lock"), deadline)
        return False

    def _mutex_grant_next(self, api, os_p: "_Proc", addr: int) -> None:
        """Hand a free mutex to its first waiter (FIFO — deterministic)
        and resume that thread (deferred: see _resume_granted)."""
        m = os_p.mutexes.get(addr)
        if m is None or m[0] is not None:
            return
        while m[1]:
            nxt = m[1].pop(0)
            if nxt.dead or nxt.blocked is None or nxt.blocked[0] != "mutex":
                continue
            # grant_ret is 0, or -ETIMEDOUT for a timed-out cond wait
            # re-acquiring its mutex; the opname keeps strace honest about
            # which PLUGIN call is being completed
            _kind, _addr, grant_ret, _dl, opname = nxt.blocked
            m[0] = nxt
            nxt.blocked = None
            self._resume_granted(api, nxt, opname, grant_ret)
            return

    def _op_mutex_unlock(self, api: HostApi, req) -> None:
        addr = int(req.args[0])
        cur = self._cur
        os_p = cur.os_proc
        m = os_p.mutexes.get(addr)
        self._reply(api, "mutex-unlock", 0)  # unlocker resumes first
        if m is not None and m[0] is cur:
            m[0] = None
            self._mutex_grant_next(api, os_p, addr)

    def _op_cond_wait(self, api: HostApi, req) -> None:
        """Atomically: park on the condvar, then release the mutex (waking
        its next waiter).  Always parks; the reply arrives at wake or
        timeout.  POSIX re-acquire-before-return is honored by routing the
        wake through the mutex wait queue."""
        c_addr = int(req.args[0])
        m_addr = int(req.args[1])
        timeout = int(req.args[2])
        cur = self._cur
        os_p = cur.os_proc
        deadline = None if timeout < 0 else api.now + timeout
        os_p.conds.setdefault(c_addr, []).append(cur)
        self._park(api, ("cond", c_addr, m_addr, deadline), deadline)
        m = os_p.mutexes.get(m_addr)
        if m is not None and m[0] is cur:
            m[0] = None
            self._mutex_grant_next(api, os_p, m_addr)

    def _op_cond_wake(self, api: HostApi, req) -> None:
        c_addr = int(req.args[0])
        wake_all = bool(req.args[1])
        os_p = self._cur.os_proc
        waiters = os_p.conds.get(c_addr, [])
        take = list(waiters) if wake_all else waiters[:1]
        del waiters[: len(take)]
        self._reply(api, "cond-wake", 0)  # signaler resumes first
        for w in take:
            if w.dead or w.blocked is None or w.blocked[0] != "cond":
                continue
            m_addr = w.blocked[2]
            m = self._mutex(os_p, m_addr)
            if m[0] is None and not m[1]:
                m[0] = w
                w.blocked = None
                self._resume_granted(api, w, "cond-wait", 0)
            else:
                # mutex busy (usually held by the signaler): queue for it
                w.blocked = ("mutex", m_addr, 0, None, "cond-wait")
                m[1].append(w)

    def _op_sem_init(self, api: HostApi, req) -> None:
        addr = int(req.args[0])
        value = int(req.args[1])
        self._cur.os_proc.sems[addr] = [value, []]
        self._reply(api, "sem-init", 0)

    def _op_sem_wait(self, api: HostApi, req) -> bool:
        addr = int(req.args[0])
        try_ = bool(req.args[1])
        timeout = int(req.args[2])
        cur = self._cur
        s = self._sem(cur.os_proc, addr)
        if s[0] > 0:
            s[0] -= 1
            self._reply(api, "sem-wait", 0)
            return True
        if try_:
            self._reply(api, "sem-wait", -EAGAIN)
            return True
        deadline = None if timeout < 0 else api.now + timeout
        s[1].append(cur)
        self._park(api, ("sem", addr, deadline), deadline)
        return False

    def _op_sem_post(self, api: HostApi, req) -> None:
        addr = int(req.args[0])
        os_p = self._cur.os_proc
        s = self._sem(os_p, addr)
        woken = None
        while s[1]:
            w = s[1].pop(0)
            if not w.dead and w.blocked is not None and w.blocked[0] == "sem":
                woken = w
                break
        if woken is None:
            s[0] += 1
        self._reply(api, "sem-post", 0, args=[0, s[0]])
        if woken is not None:
            woken.blocked = None
            self._resume_granted(api, woken, "sem-wait", 0)

    def _op_sem_get(self, api: HostApi, req) -> None:
        s = self._sem(self._cur.os_proc, int(req.args[0]))
        self._reply(api, "sem-get", 0, args=[0, s[0]])

    # -- simulated signals (the reference's handler/signal.rs surface) ----

    # parked kinds a delivered signal may interrupt with -EINTR (POSIX
    # interruptible calls; sync primitives deliberately excluded —
    # pthread_cond_wait and friends are not EINTR surfaces)
    _INTERRUPTIBLE = ("sleep", "poll", "recvfrom", "recv", "accept",
                      "connect", "waitpid", "futex")

    def _op_kill(self, api: HostApi, req) -> None:
        """kill() between simulated processes: the REAL signal is sent to
        the target, whose exchange mask defers handlers to its next call
        boundary — and if the target is parked in an interruptible call
        AND has a handler installed (the shim-maintained handled_signals
        bitmap), the parked call completes with -EINTR so the handler is
        never starved by a long park.  Pid 0 fans out to the whole app
        (its own process group); pids outside this app get -ESRCH: a
        plugin can never signal the real OS through the simulation."""
        target_pid = int(req.args[0])
        sig = int(req.args[1])
        if not (0 <= sig < 65):
            self._reply(api, "kill", -EINVAL)
            return
        if sig in (_signal.SIGSTOP, _signal.SIGTSTP, _signal.SIGTTIN,
                   _signal.SIGTTOU):
            # a truly stopped plugin would never answer its channel and
            # wedge the simulation: refuse (job control is not simulated)
            self._reply(api, "kill", -EPERM)
            return
        if target_pid == 0:
            targets = [pr for pr in self.procs
                       if pr.kind == "proc" and not pr.dead]
        else:
            targets = [pr for pr in self.procs
                       if pr.kind == "proc" and not pr.dead
                       and pr.pid == target_pid]
        if not targets:
            self._reply(api, "kill", -ESRCH)
            return
        sender = self._cur
        if sig:
            for t in targets:
                try:
                    os.kill(t.pid, sig)
                except ProcessLookupError:
                    continue
                t.last_signal = sig
                api.count("managed_signals_sent")
                self._interrupt_parked(api, t, sig)
        self._cur = sender
        self._reply(api, "kill", 0)

    # signals whose default action is NOT termination (stop signals are
    # refused upstream; SIGCONT's default is continue): a no-handler
    # delivery of one of these leaves the park alone
    _DEFAULT_NONFATAL = frozenset(
        {int(_signal.SIGCHLD), int(_signal.SIGURG), int(_signal.SIGWINCH),
         int(_signal.SIGCONT)}
    )

    def _interrupt_parked(self, api, target: "_Proc", sig: int) -> None:
        """Complete a parked interruptible call with -EINTR when the target
        installed a handler for ``sig`` — or release ANY park when ``sig``
        has no handler and its default action is terminate: the exchange
        mask blocks every maskable signal for the duration of a park, so a
        pending default-fatal signal (SIGTERM/SIGALRM/... with no handler)
        would otherwise never take effect until the park naturally
        completed.  POSIX kills the sleeper now; releasing the park lets
        the process leave its exchange and the pending signal's default
        action fire at the mask restore (signal.rs default-action
        dispositions; deliver_shutdown uses the same shape).  An explicitly
        SIG_IGNed signal (the shim-maintained ignored_signals bitmap)
        neither interrupts nor kills — the park stays."""
        shm = target.chan.shm if target.chan else None
        handled = int(shm.handled_signals) if shm is not None else 0
        has_handler = (handled >> (sig - 1)) & 1
        fatal = False
        if not has_handler:
            ignored = int(shm.ignored_signals) if shm is not None else 0
            if (ignored >> (sig - 1)) & 1 or sig in self._DEFAULT_NONFATAL:
                return
            fatal = True
        for entity in self.procs:
            if entity.dead or entity.os_proc is not target.os_proc:
                continue
            b = entity.blocked
            if b is None:
                continue
            if entity.chan is not None and (
                int(entity.chan.shm.blocked_signals) >> (sig - 1)
            ) & 1:
                # THIS thread's own sigprocmask blocks it: POSIX keeps the
                # signal pending without interrupting its calls — it takes
                # effect when the thread unblocks.  Sigmasks are per
                # thread, so other entities of the process are still
                # released (the dedicated-signal-thread pattern)
                continue
            if b[0] not in self._INTERRUPTIBLE:
                # handled signals EINTR only the POSIX-interruptible set;
                # impending death releases every park except the imminent
                # cpulat charge (a timed park with a near deadline whose
                # pending request is serviced at expiry either way)
                if not fatal or b[0] == "cpulat":
                    continue
            entity.blocked = None
            if b[0] == "sleep":
                remaining = max(int(b[1]) - api.now, 0)
                self._resume_granted(api, entity, "nanosleep", -EINTR,
                                     args=[0, remaining])
            elif b[0] == "futex":
                addr = b[1]
                os_p = entity.os_proc
                q = [e for e in os_p.futexes.get(addr, [])
                     if e[0] is not entity]
                if q:
                    os_p.futexes[addr] = q
                else:
                    os_p.futexes.pop(addr, None)
                self._resume_granted(api, entity, "futex-wait", -EINTR)
            elif b[0] == "mutex":
                # wait queues skip entries whose `blocked` was cleared, so
                # no explicit dequeue is needed (grant/wake loops check)
                self._resume_granted(api, entity, b[4], -EINTR)
            elif b[0] == "cond":
                self._resume_granted(api, entity, "cond-wait", -EINTR)
            elif b[0] == "sem":
                self._resume_granted(api, entity, "sem-wait", -EINTR)
            elif b[0] == "join":
                self._resume_granted(api, entity, "thread-join", -EINTR)
            else:
                self._resume_granted(api, entity, b[0], -EINTR)

    def _op_inotify_add(self, api: HostApi, req) -> None:
        """inotify_add_watch on the stub fd: the watch is tracked and a
        descriptor handed back, but no event will ever fire (the fork's
        minimal-stub law — apps that register watches keep working, apps
        that REQUIRE events see an eternally-quiet fd)."""
        vfd = int(req.args[0])
        sock = self.sockets.get(vfd)
        if sock is None or sock.kind != "inotify":
            self._reply(api, "inotify-add", -EBADF)
            return
        path = self.chan.req_payload().decode("utf-8", "surrogateescape")
        mask = int(req.args[1])
        # kernel contract: a watch on a nonexistent path answers ENOENT
        # (the reference fork's stub always said wd=1; apps that probe
        # for missing paths see the real errno here).  Absolute paths
        # only: relative ones resolve against the CHILD's cwd, which the
        # shim does not virtualize — keep the permissive stub for those
        if path.startswith("/") and not os.path.lexists(path):
            self._reply(api, "inotify-add", -ENOENT)
            return
        wd = sock.next_wd
        sock.next_wd += 1
        sock.watches[wd] = (path, mask)
        api.count("managed_inotify_watches")
        self._reply(api, "inotify-add", wd)

    def _op_inotify_rm(self, api: HostApi, req) -> None:
        vfd, wd = int(req.args[0]), int(req.args[1])
        sock = self.sockets.get(vfd)
        if sock is None or sock.kind != "inotify":
            self._reply(api, "inotify-rm", -EBADF)
            return
        if sock.watches.pop(wd, None) is None:
            self._reply(api, "inotify-rm", -EINVAL)
            return
        self._reply(api, "inotify-rm", 0)

    def _op_alarm(self, api: HostApi, req) -> None:
        """alarm()/setitimer(ITIMER_REAL) on the SIMULATED clock: SIGALRM
        is delivered at the simulated deadline (and re-armed for interval
        timers)."""
        ns = int(req.args[0])
        interval = int(req.args[1])
        proc = self._cur.os_proc
        old = proc._alarm_deadline
        remaining = max(old - api.now, 0) if old is not None else 0
        proc._alarm_gen += 1
        gen = proc._alarm_gen
        if ns <= 0:
            proc._alarm_deadline = None
        else:
            deadline = api.now + ns
            proc._alarm_deadline = deadline
            api.schedule_at(
                deadline,
                lambda h, p=proc, g=gen, iv=interval: self._alarm_fired(
                    h, p, g, iv
                ),
            )
        self._reply(api, "alarm", 0, args=[0, remaining])

    def _alarm_fired(self, api, proc: "_Proc", gen: int, interval: int) -> None:
        if proc.dead or self.finished or proc._alarm_gen != gen:
            return  # re-armed or canceled since
        proc._alarm_deadline = None
        try:
            os.kill(proc.pid, _signal.SIGALRM)
        except ProcessLookupError:
            return
        proc.last_signal = int(_signal.SIGALRM)
        api.count("managed_alarms_fired")
        self._interrupt_parked(api, proc, int(_signal.SIGALRM))
        if interval > 0:
            proc._alarm_gen += 1
            gen2 = proc._alarm_gen
            deadline = api.now + interval
            proc._alarm_deadline = deadline
            api.schedule_at(
                deadline,
                lambda h, p=proc, g=gen2, iv=interval: self._alarm_fired(
                    h, p, g, iv
                ),
            )

    # -- raw futex (the reference's futex table + FUTEX_* handler,
    # host/futex_table.rs, handler/futex.rs).  The shim already verified
    # *addr == expected under the turn-taking guarantee, so WAIT always
    # parks here; wakes are FIFO for determinism. ------------------------

    def _op_futex_wait(self, api: HostApi, req) -> None:
        addr = int(req.args[0])
        timeout = int(req.args[1])
        bitset = int(req.args[2]) & 0xFFFFFFFF
        cur = self._cur
        deadline = None if timeout < 0 else api.now + timeout
        cur.os_proc.futexes.setdefault(addr, []).append((cur, bitset))
        self._park(api, ("futex", addr, deadline), deadline)

    def _futex_take(self, os_p: "_Proc", addr: int, maxn: int,
                    bitset: int) -> list:
        """Dequeue up to maxn live waiters whose bitset intersects."""
        q = os_p.futexes.get(addr, [])
        taken, kept = [], []
        for entry in q:
            w, wbs = entry
            stale = (w.dead or w.blocked is None or w.blocked[0] != "futex"
                     or w.blocked[1] != addr)
            if stale:
                continue  # drop: timed out or died while queued
            if len(taken) < maxn and (wbs & bitset):
                taken.append(w)
            else:
                kept.append(entry)
        if kept:
            os_p.futexes[addr] = kept
        else:
            os_p.futexes.pop(addr, None)
        return taken

    def _op_futex_wake(self, api: HostApi, req) -> None:
        addr = int(req.args[0])
        maxn = max(0, int(req.args[1]))
        bitset = int(req.args[2]) & 0xFFFFFFFF
        os_p = self._cur.os_proc
        taken = self._futex_take(os_p, addr, maxn, bitset)
        self._reply(api, "futex-wake", len(taken))  # waker resumes first
        for w in taken:
            w.blocked = None
            self._resume_granted(api, w, "futex-wait", 0)

    def _op_futex_requeue(self, api: HostApi, req) -> None:
        addr = int(req.args[0])
        maxwake = max(0, int(req.args[1]))
        addr2 = int(req.args[2])
        maxreq = max(0, int(req.args[3]))
        os_p = self._cur.os_proc
        taken = self._futex_take(os_p, addr, maxwake, 0xFFFFFFFF)
        moved = 0
        if maxreq > 0:
            q2 = os_p.futexes.setdefault(addr2, [])
            for entry in list(os_p.futexes.get(addr, [])):
                if moved >= maxreq:
                    break
                w, wbs = entry
                os_p.futexes[addr].remove(entry)
                # keep the original deadline: its fired closure follows the
                # blocked tuple's addr, which now names the target queue
                w.blocked = ("futex", addr2, w.blocked[2])
                q2.append((w, wbs))
                moved += 1
            if not os_p.futexes.get(addr):
                os_p.futexes.pop(addr, None)
        # ret = woken; args[1] = requeued (the shim applies Linux's
        # REQUEUE-vs-CMP_REQUEUE return-value difference)
        self._reply(api, "futex-requeue", len(taken), args=[0, moved])
        for w in taken:
            w.blocked = None
            self._resume_granted(api, w, "futex-wait", 0)

    # -- socket ops --------------------------------------------------------

    SOCK_STREAM = 1
    SOCK_DGRAM = 2

    def _op_socket(self, api: HostApi, req) -> None:
        base_type, vfd = int(req.args[1]), int(req.args[2])
        kind = "tcp" if base_type == self.SOCK_STREAM else "udp"
        self.sockets[vfd] = _VSocket(vfd, kind)
        self._reply(api, f"socket[{kind}]", 0)

    def _op_bind(self, api: HostApi, req) -> None:
        vfd, port = req.args[0], int(req.args[1])
        sock = self.sockets.get(vfd)
        if sock is None:
            self._reply(api, "bind", -EBADF)
            return
        if sock.kind in NONSOCK_KINDS:
            self._reply(api, "bind", -ENOTSOCK)
            return
        if sock.kind == "udp":
            ports = self._host_ports(api)
            if port == 0:
                port = self._alloc_port(api)
            elif port in ports:
                self._reply(api, "bind", -EADDRINUSE)
                return
            sock.port = port
            ports[port] = (self, sock)
        else:
            if port in api.net.tcp_listeners:
                self._reply(api, "bind", -EADDRINUSE)
                return
            sock.port = port or None
        self._reply(api, "bind", 0)

    def _op_listen(self, api: HostApi, req) -> None:
        vfd, backlog = req.args[0], int(req.args[1])
        sock = self.sockets.get(vfd)
        if sock is None or sock.kind in ("udp",) + NONSOCK_KINDS:
            self._reply(api, "listen",
                        -EBADF if sock is None else
                        -EINVAL if sock.kind == "udp" else -ENOTSOCK)
            return
        if sock.kind == "listen":
            self._reply(api, "listen", 0)  # already listening
            return
        port = sock.port or api.net._alloc_port()
        try:
            lst = api.net.listen(port, backlog=max(backlog, 1))
        except OSError:
            self._reply(api, "listen", -EADDRINUSE)
            return
        sock.kind = "listen"
        sock.port = port
        sock.listener = lst
        lst.on_accept = lambda child, now, vs=sock: self._tcp_accept(api, vs, child)
        self._reply(api, "listen", 0)

    def _op_connect(self, api: HostApi, req) -> bool:
        vfd = req.args[0]
        sock = self.sockets.get(vfd)
        if sock is None:
            self._reply(api, "connect", -EBADF)
            return True
        if sock.kind in NONSOCK_KINDS:
            self._reply(api, "connect", -ENOTSOCK)
            return True
        ip_be = int(req.args[1]) & 0xFFFFFFFF
        port = int(req.args[2])
        nonblock = bool(req.args[3])
        if sock.kind == "udp":
            sock.default_dst = (ip_be, port)
            self._reply(api, "connect", 0)
            return True
        if sock.sim is not None:  # repeated connect on the same socket
            ps = sock.sim.poll()
            if ps & PollState.ERROR:
                ret = -(_tcp_errno(sock.sim.tcp) or ECONNREFUSED)
            elif ps & PollState.WRITABLE:
                ret = -EISCONN
            else:
                ret = -EALREADY
            self._reply(api, "connect", ret)
            return True
        from ..net.stack import is_loopback_u32

        ip_u32 = _shim_ip_to_u32be(ip_be)
        lo = is_loopback_u32(ip_u32)
        dst = api.net._host_for_ip(ip_u32)
        if dst is None:
            self._reply(api, "connect", -EHOSTUNREACH)
            return True
        sock.sim = api.net.connect(dst, port, src_port=sock.port,
                                   loopback=lo)
        sock.sim.on_event = lambda s, now, vs=sock: self._tcp_event_obj(api, vs)
        api.count("managed_tcp_connects")
        if nonblock:
            self._reply(api, "connect", -EINPROGRESS)
            return True
        self._park(api, ("connect", vfd), None)
        return False

    def _op_accept(self, api: HostApi, req) -> bool:
        vfd = req.args[0]
        nonblock = bool(req.args[1])
        child_fd = int(req.args[2])
        sock = self.sockets.get(vfd)
        if sock is None or sock.kind != "listen":
            self._reply(api, "accept", -EBADF if sock is None else -EINVAL)
            return True
        if sock.recv_shut:
            self._reply(api, "accept", -EINVAL)  # shut-down listener
            return True
        if sock.accept_q:
            self._complete_accept(api, vfd, child_fd)
            return True
        if nonblock:
            self._reply(api, "accept", -EAGAIN)
            return True
        self._park(api, ("accept", vfd, child_fd), None)
        return False

    def _complete_accept(self, api: HostApi, vfd: int, child_fd: int) -> None:
        sock = self.sockets[vfd]
        child_sim = sock.accept_q.pop(0)
        child = _VSocket(child_fd, "tcp")
        child.sim = child_sim
        child.port = child_sim.tcp.local_port
        self.sockets[child_fd] = child
        child_sim.on_event = lambda s, now, vs=child: self._tcp_event_obj(api, vs)
        peer_ip = _u32be_to_shim_ip(child_sim.tcp.remote_ip)
        api.count("managed_tcp_accepts")
        self._reply(api, "accept", child_fd,
                    args=[0, peer_ip, child_sim.tcp.remote_port])

    def _op_sendto(self, api: HostApi, req) -> bool:
        vfd = req.args[0]
        sock = self.sockets.get(vfd)
        if sock is None:
            self._reply(api, "sendto", -EBADF)
            return True
        if int(req.args[4]) == abi.VM_ARENA:
            # zero-syscall arena mode: the shim staged the payload in the
            # channel's shared arena (turn-serialized).  The counter
            # records bytes STAGED through the arena (like the vmcopy
            # counter records bytes staged via process_vm): a nonblocking
            # retry may stage more than the buffer accepts
            data = self.chan.read_arena(int(req.args[5]))
            api.count("managed_arena_bytes", len(data))
        elif req.args[4]:
            # direct-memory mode (MemoryCopier, memory_copier.rs): the
            # shim passed (addr, len) instead of riding the 64 KiB frame.
            # Clamp the staging copy: the send buffer can't queue more
            # than ~its capacity anyway, and the shim's outer loop
            # re-issues for the rest — an 8 MiB nonblocking write must
            # not copy 8 MiB per EAGAIN retry
            try:
                data = abi.vm_read(
                    self._cur.pid, int(req.args[4]),
                    min(int(req.args[5]), 256 * 1024),
                )
                api.count("managed_vmcopy_bytes", len(data))
            except OSError as e:
                if e.errno in (EPERM, ENOSYS):
                    # kernel forbids cross-process reads (ptrace scope):
                    # tell the shim to fall back to frame chunking
                    self._reply(api, "sendto", -EOPNOTSUPP)
                else:
                    # a real fault in the APP's buffer (EFAULT etc.):
                    # surface it like the kernel would — retrying via the
                    # frame would memcpy the same bad pointer and SIGSEGV
                    self._reply(api, "sendto", -(e.errno or EINVAL))
                return True
        else:
            data = self.chan.req_payload()
        if sock.kind == "event":
            return self._event_write(api, sock, data, bool(req.args[3]), vfd)
        if sock.kind in ("timer", "inotify"):
            self._reply(api, "write", -EINVAL)  # read-only fd kinds
            return True
        if sock.kind == "udp":
            self._udp_send(api, sock, req, data)
            return True
        if sock.kind == "listen" or sock.sim is None:
            self._reply(api, "sendto", -ENOTCONN)
            return True
        nonblock = bool(req.args[3])
        return self._stream_send(api, vfd, data, nonblock)

    def _stream_send(self, api: HostApi, vfd: int, data: bytes,
                     nonblock: bool) -> bool:
        sock = self.sockets[vfd]
        if not data:  # POSIX: zero-length stream send returns 0 immediately
            self._reply(api, "send", 0)
            return True
        ps = sock.sim.poll()
        if ps & PollState.ERROR:
            self._reply(api, "send", -(_tcp_errno(sock.sim.tcp) or ECONNRESET))
            return True
        if ps & PollState.SEND_CLOSED:
            self._reply(api, "send", -EPIPE)
            return True
        n = sock.sim.send(data)
        if n:
            api.count("managed_tcp_tx_bytes", n)
        if n == len(data):
            self._reply(api, "send", n)
            return True
        if nonblock:
            # nonblocking: partial is a valid return; nothing queued = EAGAIN
            self._reply(api, "send", n if n > 0 else -EAGAIN)
            return True
        # blocking send returns only once the whole chunk is queued
        self._park(api, ("send", vfd, data[n:], len(data)), None)
        return False

    def _udp_send(self, api: HostApi, sock: _VSocket, req, data: bytes) -> None:
        ip_be = int(req.args[1]) & 0xFFFFFFFF
        port = int(req.args[2])
        if ip_be == 0 and port == 0:
            if sock.default_dst is None:
                self._reply(api, "sendto", -EDESTADDRREQ)
                return
            ip_be, port = sock.default_dst
        from ..net.dns import DnsError

        from ..net.stack import is_loopback_u32

        ipstr = _be_to_ip(ip_be)
        lo = is_loopback_u32(_shim_ip_to_u32be(ip_be))
        if lo:
            dst = api.host_id
        else:
            try:
                dst = api.resolve(ipstr)
            except DnsError:
                dst = None
        if sock.port is None:  # auto-bind an ephemeral source port
            sock.port = self._alloc_port(api)
            self._host_ports(api)[sock.port] = (self, sock)
        if dst is None:
            # a datagram to an address outside the simulated internet (a
            # real resolver's nameserver, a hardcoded external IP...)
            # vanishes, exactly like an unrouted packet on a real network;
            # sendto itself succeeds
            api.count("udp_external_drops")
            self._reply(api, "sendto", len(data))
            return
        payload = (sock.port, port, data, True) if lo else (sock.port, port, data)
        api.send(dst, len(data) + UDP_HEADER_BYTES, payload=payload,
                 loopback=lo)
        api.count("udp_tx_bytes", len(data))
        self._reply(api, "sendto", len(data))

    def _op_recvfrom(self, api: HostApi, req) -> bool:
        vfd = req.args[0]
        # direct-memory mode (MemoryCopier write side): the shim passed a
        # destination address in args[4] — the reply carries no payload,
        # the bytes land in plugin memory via process_vm_writev.  Frame
        # mode otherwise: the channel carries at most SHIM_PAYLOAD_MAX
        # bytes per reply (the caller loops).
        vm_dst = int(req.args[4])
        if vm_dst == abi.VM_ARENA:
            max_len = min(int(req.args[1]), abi.SHIM_ARENA_CHUNK)
        elif vm_dst:
            max_len = min(int(req.args[1]), 256 * 1024)
        else:
            max_len = min(int(req.args[1]), abi.SHIM_PAYLOAD_MAX)
        nonblock = bool(req.args[2])
        peek = bool(req.args[3])
        sock = self.sockets.get(vfd)
        if sock is None:
            self._reply(api, "recvfrom", -EBADF)
            return True
        if vm_dst and (peek or sock.kind != "tcp" or sock.sim is None):
            # the shim only uses direct mode for consuming stream reads;
            # anything else here is a protocol error — refuse loudly so
            # it falls back rather than corrupting plugin memory
            if sock.kind == "listen" or (sock.kind == "tcp"
                                         and sock.sim is None):
                self._reply(api, "recvfrom", -ENOTCONN)
            else:
                self._reply(api, "recvfrom", -EOPNOTSUPP)
            return True
        if sock.kind in ("timer", "event"):
            return self._counter_read(api, sock, max_len, nonblock, vfd)
        if sock.kind == "inotify":
            # stub law: no event ever arrives — nonblocking reads say so,
            # blocking reads park for the rest of the simulation
            if nonblock:
                self._reply(api, "recvfrom", -EAGAIN)
                return True
            self._park(api, ("recvfrom", vfd, max_len, peek), None)
            return False
        if sock.kind == "udp":
            if sock.queue:
                self._reply_udp_recv(api, vfd, max_len, peek)
                return True
            if sock.recv_shut:
                self._reply(api, "recvfrom", 0)  # SHUT_RD: EOF
                return True
            if nonblock:
                self._reply(api, "recvfrom", -EAGAIN)
                return True
            self._park(api, ("recvfrom", vfd, max_len, peek), None)
            return False
        if sock.kind == "listen" or sock.sim is None:
            self._reply(api, "recvfrom", -ENOTCONN)
            return True
        return self._stream_recv(api, vfd, max_len, nonblock, peek, vm_dst)

    def _reply_stream_data(self, api: HostApi, sock, data: bytes,
                           peek: bool, vm_dst: int) -> None:
        """Deliver stream bytes: the zero-syscall arena, direct vm_write
        into plugin memory (MemoryCopier write side — data must have been
        PEEKed, it is consumed only once the write lands), or the frame
        payload."""
        if vm_dst == abi.VM_ARENA:
            self.chan.write_arena(data)
            api.count("managed_arena_bytes", len(data))
            sock.sim.recv(len(data))  # consume exactly what landed
        elif vm_dst:
            try:
                abi.vm_write(self._cur.pid, vm_dst, data)
                api.count("managed_vmcopy_bytes", len(data))
            except OSError as e:
                if e.errno in (EPERM, ENOSYS):
                    # kernel forbids cross-process writes (ptrace scope):
                    # the shim falls back to frame chunking; nothing was
                    # consumed, so no bytes are lost
                    self._reply(api, "recvfrom", -EOPNOTSUPP)
                else:
                    # a real fault in the APP's buffer: surface it like
                    # the kernel would, without consuming
                    self._reply(api, "recv", -(e.errno or EINVAL))
                return
            sock.sim.recv(len(data))  # consume exactly what landed
        if not peek:
            api.count("managed_tcp_rx_bytes", len(data))
        peer_ip = _u32be_to_shim_ip(sock.sim.tcp.remote_ip)
        self._reply(api, "recv", len(data),
                    args=[0, peer_ip, sock.sim.tcp.remote_port],
                    payload=b"" if vm_dst else data)

    def _stream_recv(self, api: HostApi, vfd: int, max_len: int,
                     nonblock: bool, peek: bool = False,
                     vm_dst: int = 0) -> bool:
        sock = self.sockets[vfd]
        if max_len <= 0:  # POSIX: zero-length stream recv returns 0
            self._reply(api, "recv", 0)
            return True
        data = (sock.sim.peek(max_len) if (peek or vm_dst)
                else sock.sim.recv(max_len))
        if data:
            self._reply_stream_data(api, sock, data, peek, vm_dst)
            return True
        ps = sock.sim.poll()
        if ps & PollState.ERROR:
            self._reply(api, "recv", -(_tcp_errno(sock.sim.tcp) or ECONNRESET))
            return True
        if sock.sim.tcp.at_eof() or ps & PollState.RECV_CLOSED:
            self._reply(api, "recv", 0)  # orderly EOF
            return True
        if nonblock:
            self._reply(api, "recv", -EAGAIN)
            return True
        self._park(api, ("recv", vfd, max_len, peek, vm_dst), None)
        return False

    def _reply_udp_recv(self, api: HostApi, vfd: int, max_len: int,
                        peek: bool = False) -> None:
        sock = self.sockets[vfd]
        queue = sock.queue
        src_ip_be, src_port, data = queue[0] if peek else queue.pop(0)
        if not peek:  # the whole datagram leaves the buffer even if the
            sock.queued_bytes -= len(data)  # caller's read truncates it
            if sock.queued_bytes < 0:
                sock.queued_bytes = 0
        # UDP truncation semantics: excess bytes of the datagram are
        # discarded, the caller sees the truncated length, and recvmsg
        # callers learn about it via MSG_TRUNC (reply args[3])
        truncated = len(data) > max(max_len, 0)
        data = data[: max(max_len, 0)]
        self._reply(api, "recvfrom", len(data),
                    args=[0, src_ip_be, src_port, 1 if truncated else 0],
                    payload=data)

    def _op_shutdown(self, api: HostApi, req) -> None:
        vfd, how = req.args[0], int(req.args[1])
        sock = self.sockets.get(vfd)
        if sock is None:
            self._reply(api, "shutdown", -EBADF)
            return
        if sock.kind in NONSOCK_KINDS:
            self._reply(api, "shutdown", -ENOTSOCK)
            return
        if sock.kind == "udp":
            if sock.default_dst is None:
                self._reply(api, "shutdown", -ENOTCONN)
                return
            if how in (0, 2):
                sock.recv_shut = True  # further reads drain then EOF
            self._reply(api, "shutdown", 0)
            self._wake_after_shutdown(api, vfd)
            return
        if sock.kind == "listen":
            sock.recv_shut = True  # a parked/future accept fails (EINVAL)
            self._reply(api, "shutdown", 0)
            self._wake_after_shutdown(api, vfd)
            return
        if sock.sim is None:
            self._reply(api, "shutdown", -ENOTCONN)
            return
        if how in (0, 2):  # SHUT_RD / SHUT_RDWR: further reads return EOF
            sock.sim.tcp.shutdown_recv()
        if how in (1, 2):  # SHUT_WR / SHUT_RDWR: send our FIN
            sock.sim.close()
        self._reply(api, "shutdown", 0)

    def _wake_after_shutdown(self, api: HostApi, vfd: int) -> None:
        """shutdown() from a sibling's service turn can unblock a call the
        plugin parked earlier (single-threaded plugins can't be parked when
        they call shutdown themselves, but the wake is harmless)."""
        self._socket_activity(api, vfd)

    def _op_getsockname(self, api: HostApi, req) -> None:
        sock = self.sockets.get(req.args[0])
        if sock is None:
            self._reply(api, "getsockname", -EBADF)
            return
        if sock.kind in NONSOCK_KINDS:
            self._reply(api, "getsockname", -ENOTSOCK)
            return
        ip_be = _ip_to_be(api.ip_of(api.host_id))
        port = sock.port or 0
        if sock.kind == "tcp" and sock.sim is not None:
            port = sock.sim.tcp.local_port
        self._reply(api, "getsockname", 0, args=[0, ip_be, port])

    def _op_getpeername(self, api: HostApi, req) -> None:
        sock = self.sockets.get(req.args[0])
        if sock is None:
            self._reply(api, "getpeername", -EBADF)
            return
        if sock.kind in NONSOCK_KINDS:
            self._reply(api, "getpeername", -ENOTSOCK)
            return
        if sock.kind == "tcp" and sock.sim is not None:
            self._reply(api, "getpeername", 0,
                        args=[0, _u32be_to_shim_ip(sock.sim.tcp.remote_ip),
                              sock.sim.tcp.remote_port])
        elif sock.kind == "udp" and sock.default_dst is not None:
            self._reply(api, "getpeername", 0,
                        args=[0, sock.default_dst[0], sock.default_dst[1]])
        else:
            self._reply(api, "getpeername", -ENOTCONN)

    def _op_sockerr(self, api: HostApi, req) -> None:
        sock = self.sockets.get(req.args[0])
        if sock is None:
            self._reply(api, "sockerr", -EBADF)
            return
        if sock.kind in NONSOCK_KINDS:
            self._reply(api, "sockerr", -ENOTSOCK)
            return
        err = 0
        if sock.kind == "tcp" and sock.sim is not None:
            err = _tcp_errno(sock.sim.tcp)
        self._reply(api, "sockerr", 0, args=[0, err])

    def _op_fionread(self, api: HostApi, req) -> None:
        sock = self.sockets.get(req.args[0])
        if sock is None:
            self._reply(api, "fionread", -EBADF)
            return
        if sock.kind == "udp":
            n = len(sock.queue[0][2]) if sock.queue else 0
        elif sock.kind == "tcp" and sock.sim is not None:
            n = sock.sim.tcp.available()
        elif sock.kind in ("timer", "event"):
            self._reply(api, "fionread", -EINVAL)  # Linux rejects FIONREAD here
            return
        # inotify falls through: FIONREAD is valid there and reports the
        # pending event bytes — always 0 under the stub law
        else:
            n = 0
        self._reply(api, "fionread", 0, args=[0, n])

    def _op_dup(self, api: HostApi, req) -> None:
        """dup/dup2/dup3 of a simulated socket: the new fd number aliases
        the same socket object, refcounted exactly like fork inheritance
        (close() drops one reference)."""
        old, new = int(req.args[0]), int(req.args[1])
        sock = self.sockets.get(old)
        if sock is None:
            self._reply(api, "dup", -EBADF)
            return
        sock.refs += 1
        self.sockets[new] = sock
        self._reply(api, "dup", 0)

    # -- timerfd / eventfd (simulated-clock virtual fds) -------------------

    def _op_timerfd_settime(self, api: HostApi, req) -> None:
        sock = self.sockets.get(int(req.args[0]))
        if sock is None or sock.kind != "timer":
            self._reply(api, "timerfd-settime", -EINVAL)
            return
        initial = int(req.args[1])  # relative ns; 0 = disarm
        interval = int(req.args[2])
        overdue_abs = bool(req.args[3]) and initial <= 0
        old_rem = max(sock.t_next - api.now, 0) if sock.t_next else 0
        old_int = sock.t_interval
        sock.t_gen += 1
        sock.count = 0  # Linux: settime resets the expiration counter
        if overdue_abs:
            # TFD_TIMER_ABSTIME with a past it_value: the missed
            # expirations are readable at once, and later ticks stay on
            # the ABSOLUTE grid (it_value + k*interval), as on Linux
            if interval > 0:
                late = -initial
                sock.count = late // interval + 1
                sock.t_interval = interval
                sock.t_next = api.now + interval - (late % interval)
                gen = sock.t_gen
                api.schedule_at(
                    sock.t_next,
                    lambda h, s=sock, g=gen: self._timer_fire(h, s, g))
            else:
                sock.count = 1  # overdue one-shot: already expired
                sock.t_next = None
                sock.t_interval = 0
        elif initial > 0:
            sock.t_next = api.now + initial
            sock.t_interval = max(interval, 0)
            gen = sock.t_gen
            api.schedule_at(sock.t_next,
                            lambda h, s=sock, g=gen: self._timer_fire(h, s, g))
        else:
            sock.t_next = None
            sock.t_interval = 0
        self._reply(api, "timerfd-settime", 0, args=[0, old_rem, old_int])
        if sock.count > 0:
            self._socket_activity_obj(api, sock)  # readers see it at once

    def _timer_fire(self, api, sock: _VSocket, gen: int) -> None:
        """A timerfd expiry event (engine-scheduled on the simulated
        clock); stale fires are cancelled by the generation counter."""
        if self.finished or sock.t_gen != gen or sock.refs <= 0:
            return
        sock.count += 1
        if sock.t_interval > 0:
            sock.t_next = api.now + sock.t_interval
            api.schedule_at(sock.t_next,
                            lambda h, s=sock, g=gen: self._timer_fire(h, s, g))
        else:
            sock.t_next = None
        self._socket_activity_obj(api, sock)

    def _op_timerfd_gettime(self, api: HostApi, req) -> None:
        sock = self.sockets.get(int(req.args[0]))
        if sock is None or sock.kind != "timer":
            self._reply(api, "timerfd-gettime", -EINVAL)
            return
        rem = max(sock.t_next - api.now, 0) if sock.t_next else 0
        self._reply(api, "timerfd-gettime", 0, args=[0, rem, sock.t_interval])

    def _counter_read(self, api: HostApi, sock: _VSocket, max_len: int,
                      nonblock: bool, vfd: int) -> bool:
        """read() on a timerfd/eventfd: an 8-byte counter value."""
        if max_len < 8:
            self._reply(api, "read", -EINVAL)
            return True
        if sock.count > 0:
            self._reply_counter(api, sock)
            return True
        if nonblock:
            self._reply(api, "read", -EAGAIN)
            return True
        self._park(api, ("recvfrom", vfd, max_len, False), None)
        return False

    def _reply_counter(self, api: HostApi, sock: _VSocket) -> None:
        if sock.kind == "event" and sock.e_sem:
            value = 1
            sock.count -= 1
        else:
            value = sock.count
            sock.count = 0
        self._reply(api, "read", 8, payload=value.to_bytes(8, "little"))
        if sock.kind == "event":
            # room opened up: wake a writer parked on overflow
            self._socket_activity_obj(api, sock)

    def _event_apply_write(self, api: HostApi, sock: _VSocket,
                           value: int) -> None:
        """Commit an eventfd write (room already checked): add, reply,
        wake parked readers — shared by the direct and parked paths."""
        sock.count += value
        self._reply(api, "write", 8)
        if value:
            self._socket_activity_obj(api, sock)

    def _event_write(self, api: HostApi, sock: _VSocket, data: bytes,
                     nonblock: bool, vfd: int) -> bool:
        if len(data) != 8:
            self._reply(api, "write", -EINVAL)
            return True
        value = int.from_bytes(data, "little")
        if value == 0xFFFFFFFFFFFFFFFF:
            self._reply(api, "write", -EINVAL)
            return True
        if sock.count + value > EVENTFD_MAX:
            if nonblock:
                self._reply(api, "write", -EAGAIN)
                return True
            self._park(api, ("send", vfd, data, 8), None)
            return False
        self._event_apply_write(api, sock, value)
        return True

    def _op_close(self, api: HostApi, req) -> None:
        vfd = req.args[0]
        sock = self.sockets.pop(vfd, None)
        if sock is None:
            self._reply(api, "close", -EBADF)
            return
        self._drop_socket_ref(api, sock)
        self._reply(api, "close", 0)

    def _teardown_vsocket(self, api, sock: _VSocket) -> None:
        if sock.kind in NONSOCK_KINDS:
            sock.t_gen += 1  # cancels any scheduled fire
            return
        if sock.kind == "udp":
            if sock.port is not None:
                self._host_ports(api).pop(sock.port, None)
                sock.port = None
        elif sock.kind == "tcp":
            if sock.sim is not None:
                sock.sim.on_event = None
                if not sock.sim.tcp.is_closed():
                    sock.sim.close()
        elif sock.kind == "listen":
            if sock.listener is not None:
                sock.listener.on_accept = None
                sock.listener.close()
            for child in sock.accept_q:  # unaccepted children are reset
                child.close()
            sock.accept_q.clear()

    # -- readiness (SHIM_OP_POLL) ------------------------------------------

    def _op_poll(self, api: HostApi, req) -> bool:
        n = int(req.args[0])
        timeout_ns = int(req.args[1])
        raw = self.chan.req_payload()
        entries = [
            struct.unpack_from("<iI", raw, i * 8) for i in range(min(n, len(raw) // 8))
        ]
        if any(self._readiness(api, fd, ev) for fd, ev in entries) or timeout_ns == 0:
            self._reply_poll(api, entries)
            return True
        deadline = None if timeout_ns < 0 else api.now + timeout_ns
        self._park(api, ("poll", entries, deadline), deadline)
        return False

    def _readiness(self, api: HostApi, vfd: int, events: int) -> int:
        """revents for one fd: current simulated readiness masked by the
        request (plus the always-reported error bits)."""
        sock = self.sockets.get(vfd)
        if sock is None:
            return abi.POLLNVAL
        ready = 0
        if sock.kind == "timer":
            if sock.count > 0:
                ready |= abi.POLLIN
        elif sock.kind == "event":
            if sock.count > 0:
                ready |= abi.POLLIN
            if sock.count < EVENTFD_MAX:
                ready |= abi.POLLOUT
        elif sock.kind == "udp":
            if sock.queue or sock.recv_shut:
                ready |= abi.POLLIN
            ready |= abi.POLLOUT
        elif sock.kind == "listen":
            if sock.accept_q:
                ready |= abi.POLLIN
        elif sock.kind == "tcp" and sock.sim is None:
            ready |= abi.POLLOUT | abi.POLLHUP  # unconnected stream socket
        elif sock.sim is not None:
            ps = sock.sim.poll()
            if ps & PollState.READABLE or sock.sim.tcp.at_eof():
                ready |= abi.POLLIN
            if ps & PollState.WRITABLE:
                ready |= abi.POLLOUT
            if ps & PollState.ERROR:
                ready |= abi.POLLERR | abi.POLLIN | abi.POLLOUT
            if ps & PollState.RECV_CLOSED and ps & PollState.SEND_CLOSED:
                ready |= abi.POLLHUP
        return ready & (events | abi.POLLERR | abi.POLLHUP | abi.POLLNVAL)

    def _reply_poll(self, api: HostApi, entries) -> None:
        revents = [self._readiness(api, fd, ev) for fd, ev in entries]
        payload = b"".join(struct.pack("<I", r) for r in revents)
        nready = sum(1 for r in revents if r)
        self._reply(api, "poll", nready, payload=payload)

    # -- simulation-event wakeups ------------------------------------------

    def _tcp_event_obj(self, api: HostApi, sock: _VSocket) -> None:
        """State change on a connected TCP socket (data, window, FIN, RST)."""
        if self.finished:
            return
        self._socket_activity_obj(api, sock)

    def _tcp_accept(self, api: HostApi, sock: _VSocket, child_sim) -> None:
        """A new established child landed on a listener."""
        if self.finished or sock.refs <= 0:
            child_sim.close()
            return
        sock.accept_q.append(child_sim)
        self._socket_activity_obj(api, sock)

    def _socket_activity(self, api: HostApi, vfd: int) -> None:
        """Complete a parked call in the ACTIVE process's namespace (ops
        servicing their own fd).  Events arriving from the engine use
        :meth:`_socket_activity_obj`, which resolves by socket identity —
        vfd numbers may collide across processes."""
        sock = self._cur.sockets.get(vfd) if self._cur else None
        if sock is not None:
            self._socket_activity_obj(api, sock)

    def _socket_activity_obj(self, api: HostApi, sock: _VSocket) -> None:
        if self.finished:
            return
        for proc in list(self.procs):
            if proc.dead or proc.blocked is None:
                continue
            b = proc.blocked
            # resolve the PARKED CALL's own fd: dup aliases mean several
            # fd numbers can map to this socket, and only the one the call
            # named may complete it
            if b[0] in ("recvfrom", "recv", "send", "connect", "accept"):
                if proc.sockets.get(b[1]) is sock:
                    self._cur = proc
                    self._proc_socket_activity(api, proc, b[1])
            elif b[0] == "poll":
                if any(proc.sockets.get(fd) is sock for fd, _ev in b[1]):
                    self._cur = proc
                    self._proc_socket_activity(api, proc, -1)

    def _proc_socket_activity(self, api: HostApi, proc: "_Proc", vfd: int) -> None:
        b = proc.blocked
        if b is None:
            return
        kind = b[0]
        if kind == "recvfrom" and b[1] == vfd:
            sock = self.sockets.get(vfd)
            if sock is None:
                return
            if sock.kind in NONSOCK_KINDS:
                if sock.count > 0:
                    self._blocked = None
                    self._reply_counter(api, sock)
                    self._service(api, proc)
                return
            if sock.queue:
                self._blocked = None
                self._reply_udp_recv(api, vfd, b[2], b[3])
                self._service(api, proc)
            elif sock.recv_shut:
                self._blocked = None
                self._reply(api, "recvfrom", 0)
                self._service(api, proc)
        elif kind == "recv" and b[1] == vfd:
            sock = self.sockets.get(vfd)
            if sock is None or sock.sim is None:
                return
            peek = b[3]
            vm_dst = b[4] if len(b) > 4 else 0
            data = (sock.sim.peek(max(b[2], 0)) if (peek or vm_dst)
                    else sock.sim.recv(max(b[2], 0)))
            ps = sock.sim.poll()
            if data:
                self._blocked = None
                self._reply_stream_data(api, sock, data, peek, vm_dst)
                self._service(api, proc)
            elif ps & PollState.ERROR:
                self._blocked = None
                self._reply(api, "recv", -(_tcp_errno(sock.sim.tcp) or ECONNRESET))
                self._service(api, proc)
            elif sock.sim.tcp.at_eof() or ps & PollState.RECV_CLOSED:
                self._blocked = None
                self._reply(api, "recv", 0)
                self._service(api, proc)
        elif kind == "send" and b[1] == vfd:
            sock = self.sockets.get(vfd)
            if sock is None:
                return
            if sock.kind == "event":
                value = int.from_bytes(b[2], "little")
                if sock.count + value <= EVENTFD_MAX:
                    self._blocked = None
                    self._event_apply_write(api, sock, value)
                    self._service(api, proc)
                return
            if sock.sim is None:
                return
            ps = sock.sim.poll()
            if ps & PollState.ERROR:
                self._blocked = None
                self._reply(api, "send", -(_tcp_errno(sock.sim.tcp) or ECONNRESET))
                self._service(api, proc)
                return
            if ps & PollState.SEND_CLOSED:
                self._blocked = None
                self._reply(api, "send", -EPIPE)
                self._service(api, proc)
                return
            n = sock.sim.send(b[2])
            if n:
                api.count("managed_tcp_tx_bytes", n)
            rest = b[2][n:]
            if not rest:  # whole chunk queued: report the full length
                self._blocked = None
                self._reply(api, "send", b[3])
                self._service(api, proc)
            elif n:
                self._blocked = ("send", vfd, rest, b[3])
        elif kind == "connect" and b[1] == vfd:
            sock = self.sockets.get(vfd)
            if sock is None or sock.sim is None:
                return
            ps = sock.sim.poll()
            if ps & PollState.ERROR:
                self._blocked = None
                self._reply(api, "connect", -(_tcp_errno(sock.sim.tcp) or ECONNREFUSED))
                self._service(api, proc)
            elif ps & PollState.WRITABLE:
                self._blocked = None
                self._reply(api, "connect", 0)
                self._service(api, proc)
        elif kind == "accept" and b[1] == vfd:
            sock = self.sockets.get(vfd)
            if sock is None:
                return
            if sock.recv_shut:
                self._blocked = None
                self._reply(api, "accept", -EINVAL)
                self._service(api, proc)
            elif sock.accept_q:
                child_fd = b[2]
                self._blocked = None
                self._complete_accept(api, vfd, child_fd)
                self._service(api, proc)
        elif kind == "poll":
            entries = b[1]
            if any(self._readiness(api, fd, ev) for fd, ev in entries):
                self._blocked = None
                self._reply_poll(api, entries)
                self._service(api, proc)

    # -- lifecycle ---------------------------------------------------------

    def _finish(self, api: HostApi, unexpected: bool) -> None:
        self.finished = True
        self._kill_children()
        self._release_ports(api)
        if self.proc is not None:
            self._reap()
        self._close_files()
        api.count("managed_exit_unexpected" if unexpected else "managed_exit_clean")
        if unexpected:
            log.warning("%s died without exit handshake", self.argv[0])

    def shutdown(self) -> None:
        """End-of-simulation teardown: a plugin still parked (blocked in
        recv/accept/poll past stop_time — the typical long-lived server
        shape) is killed and reaped so no orphan OS process outlives the
        run.  The engine calls this for every app when the simulation
        ends."""
        if self.finished or self.proc is None:
            return
        self.finished = True
        self._kill_children()
        if self.proc.poll() is not None:
            # died unobserved (no exit handshake): classify the real exit
            self.exit_code = self.proc.wait()
            self._classify_exit()
        else:
            self.final_state = ("running",)  # alive at stop_time (reap now)
            self.proc.kill()
            self.exit_code = self.proc.wait()
        if self._api is not None:
            self._release_ports(self._api)
            self._api.count("managed_killed_at_stop")
        self._close_files()

    def _release_ports(self, api) -> None:
        ports = self._host_ports(api)
        for port, (app, _sock) in list(ports.items()):
            if app is self:
                del ports[port]
        for proc in self.procs:
            if proc.kind == "thread":
                continue  # shares its process's fd table (same object)
            for sock in list(proc.sockets.values()):
                if sock.kind in ("tcp", "listen"):
                    self._teardown_vsocket(api, sock)
            proc.sockets.clear()

    def _kill_children(self) -> None:
        """Fork children are the PLUGIN's OS children; at teardown they are
        killed directly (their zombies reparent to init when the root
        exits).  Threads die with their OS process — just drop their
        channels."""
        for proc in self.procs[1:]:
            if proc.dead:
                continue
            proc.dead = True
            proc.blocked = None
            if proc.kind == "proc":
                try:
                    os.kill(proc.os_pid, _signal.SIGKILL)
                except (ProcessLookupError, PermissionError):
                    pass
            if proc.chan is not None:
                proc.chan.close()
                proc.chan = None

    def _close_files(self) -> None:
        if self._stdout_file:
            self._stdout_file.close()
            self._stdout_file = None
        if self._stderr_file:
            self._stderr_file.close()
            self._stderr_file = None
        if self._strace_file:
            self._strace_file.close()
            self._strace_file = None
        for chan in self._pending_chans:
            chan.close()
        self._pending_chans.clear()
        for chan in self._pending_thread_chans.values():
            chan.close()
        self._pending_thread_chans.clear()
        if self.procs and self.procs[0].chan is not None:
            self.procs[0].chan.close()
            self.procs[0].chan = None

    def _host_dir(self, api: HostApi) -> Path:
        return Path(api.data_directory) / "hosts" / api.hostname

    def _proc_seed(self, api: HostApi) -> int:
        from ..core.rng import host_seed

        return host_seed(api.master_seed, api.host_id)

    @staticmethod
    def _cfg_strace_mode(api) -> str:
        engine = getattr(api, "engine", None)
        if engine is None:
            return "off"
        return engine.cfg.experimental.strace_logging_mode


def _errno_name(err: int) -> str:
    import errno as _errno

    return _errno.errorcode.get(err, f"E{err}")


def _tcp_errno(tcp) -> int:
    """Pending socket error as an errno (SO_ERROR / failure replies)."""
    from ..transport.tcp import TcpError

    return {
        TcpError.NONE: 0,
        TcpError.RESET: ECONNRESET,
        TcpError.TIMED_OUT: ETIMEDOUT,
        TcpError.REFUSED: ECONNREFUSED,
    }[tcp.error]


def _ip_to_be(ip: str) -> int:
    return int.from_bytes(pysocket.inet_aton(ip), "little")


def _be_to_ip(ip_be: int) -> str:
    return pysocket.inet_ntoa(ip_be.to_bytes(4, "little"))


def _u32be_to_shim_ip(ip_u32: int) -> int:
    """stack-side big-endian u32 -> the shim's raw-s_addr integer."""
    return int.from_bytes(ip_u32.to_bytes(4, "big"), "little")


def _shim_ip_to_u32be(ip_be: int) -> int:
    return int.from_bytes(ip_be.to_bytes(4, "little"), "big")
