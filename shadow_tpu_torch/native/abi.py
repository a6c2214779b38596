"""ctypes mirror of native/include/shadow_shim_abi.h + futex helpers.

The byte layout must match the C struct exactly; both sides check the magic
and total size at attach time, so drift fails loudly instead of corrupting.

The JAX package's ``native/abi.py``, copied into the port unchanged in law
(plain Python and numpy, no JAX).
"""

from __future__ import annotations

import ctypes
import ctypes.util
import mmap
import time as wall_time  # native-process hang timeout; not simulated time

SHIM_ABI_MAGIC = 0x53485457534D4833
SHIM_PAYLOAD_MAX = 65536
SHIM_ARENA_SIZE = 1 << 20  # zero-syscall staging arena (see the header)
SHIM_ARENA_CHUNK = 256 << 10  # per-turn staging clamp (must match the shim)
VM_ARENA = 1  # args[4] sentinel: payload rides the channel arena

# ops
OP_START = 1
OP_EXIT = 2
OP_NANOSLEEP = 3
OP_SOCKET = 4
OP_BIND = 5
OP_SENDTO = 6
OP_RECVFROM = 7
OP_CLOSE = 8
OP_CONNECT = 9
OP_GETSOCKNAME = 10
OP_LISTEN = 11
OP_ACCEPT = 12
OP_SHUTDOWN = 13
OP_GETPEERNAME = 14
OP_SOCKERR = 15
OP_POLL = 16
OP_FIONREAD = 17
OP_PREFORK = 18
OP_FORKED = 19
OP_CHILD_START = 20
OP_WAITPID = 21
OP_PRETHREAD = 22
OP_THREAD_CREATED = 23
OP_THREAD_START = 24
OP_THREAD_EXIT = 25
OP_THREAD_JOIN = 26
OP_MUTEX_LOCK = 27
OP_MUTEX_UNLOCK = 28
OP_COND_WAIT = 29
OP_COND_WAKE = 30
OP_SEM_INIT = 31
OP_SEM_WAIT = 32
OP_SEM_POST = 33
OP_SEM_GET = 34
OP_DUP = 35
OP_TIMERFD_CREATE = 36
OP_TIMERFD_SETTIME = 37
OP_TIMERFD_GETTIME = 38
OP_EVENTFD_CREATE = 39
OP_FUTEX_WAIT = 40
OP_FUTEX_WAKE = 41
OP_FUTEX_REQUEUE = 42
OP_PREEMPT = 43
OP_KILL = 44
OP_ALARM = 45
OP_INOTIFY_CREATE = 46
OP_INOTIFY_ADD = 47
OP_INOTIFY_RM = 48

OP_NAMES = {
    1: "start", 2: "exit", 3: "nanosleep", 4: "socket", 5: "bind",
    6: "sendto", 7: "recvfrom", 8: "close", 9: "connect", 10: "getsockname",
    11: "listen", 12: "accept", 13: "shutdown", 14: "getpeername",
    15: "sockerr", 16: "poll", 17: "fionread", 18: "prefork", 19: "forked",
    20: "child-start", 21: "waitpid", 22: "prethread", 23: "thread-created",
    24: "thread-start", 25: "thread-exit", 26: "thread-join",
    27: "mutex-lock", 28: "mutex-unlock", 29: "cond-wait", 30: "cond-wake",
    31: "sem-init", 32: "sem-wait", 33: "sem-post", 34: "sem-get",
    35: "dup", 36: "timerfd-create", 37: "timerfd-settime",
    38: "timerfd-gettime", 39: "eventfd-create", 40: "futex-wait",
    41: "futex-wake", 42: "futex-requeue", 43: "preempt", 44: "kill", 45: "alarm",
    46: "inotify-create", 47: "inotify-add", 48: "inotify-rm",
}

# poll bits (mirror Linux poll.h, shared with shim_pollfd)
POLLIN = 0x0001
POLLOUT = 0x0004
POLLERR = 0x0008
POLLHUP = 0x0010
POLLNVAL = 0x0020


class ShimMsg(ctypes.Structure):
    _fields_ = [
        ("turn", ctypes.c_uint32),
        ("op", ctypes.c_uint32),
        ("args", ctypes.c_int64 * 6),
        ("ret", ctypes.c_int64),
        ("payload_len", ctypes.c_uint32),
        ("_pad", ctypes.c_uint32),
        ("payload", ctypes.c_uint8 * SHIM_PAYLOAD_MAX),
    ]


class ShimShmem(ctypes.Structure):
    _fields_ = [
        ("magic", ctypes.c_uint64),
        ("abi_size", ctypes.c_uint64),
        ("sim_clock_ns", ctypes.c_uint64),
        ("rng_seed", ctypes.c_uint64),
        ("rng_counter", ctypes.c_uint64),
        ("sock_sndbuf", ctypes.c_uint64),
        ("sock_rcvbuf", ctypes.c_uint64),
        ("handled_signals", ctypes.c_uint64),
        ("ignored_signals", ctypes.c_uint64),
        ("blocked_signals", ctypes.c_uint64),
        ("to_shadow", ShimMsg),
        ("to_shim", ShimMsg),
        ("arena", ctypes.c_uint8 * SHIM_ARENA_SIZE),
    ]


# -- futex (x86-64 syscall 202) ----------------------------------------------

_libc = ctypes.CDLL(None, use_errno=True)
_SYS_futex = 202
FUTEX_WAIT = 0
FUTEX_WAKE = 1


class _Timespec(ctypes.Structure):
    _fields_ = [("tv_sec", ctypes.c_long), ("tv_nsec", ctypes.c_long)]


def futex_wait(addr: int, expected: int, timeout_s: float) -> None:
    """Sleep while *addr == expected (or until timeout/wakeup)."""
    ts = _Timespec(int(timeout_s), int((timeout_s % 1.0) * 1e9))
    _libc.syscall(
        _SYS_futex,
        ctypes.c_void_p(addr),
        FUTEX_WAIT,
        ctypes.c_uint32(expected),
        ctypes.byref(ts),
        None,
        0,
    )


def futex_wake(addr: int) -> None:
    _libc.syscall(_SYS_futex, ctypes.c_void_p(addr), FUTEX_WAKE, 1, None, None, 0)


class ShmChannel:
    """Manager-side view of one plugin's shared-memory block.  The backing
    file must outlive the process (each execve re-opens it); ``close``
    unlinks it so reused data directories cannot accumulate channel files
    from prior runs."""

    def __init__(self, path: str, seed: int, sndbuf: int | None = None,
                 rcvbuf: int | None = None) -> None:
        from ..config.options import (
            SOCKET_RECV_BUFFER_DEFAULT,
            SOCKET_SEND_BUFFER_DEFAULT,
        )

        sndbuf = SOCKET_SEND_BUFFER_DEFAULT if sndbuf is None else sndbuf
        rcvbuf = SOCKET_RECV_BUFFER_DEFAULT if rcvbuf is None else rcvbuf
        size = ctypes.sizeof(ShimShmem)
        with open(path, "wb") as f:
            f.truncate(size)
        self._f = open(path, "r+b")
        self.mm = mmap.mmap(self._f.fileno(), size)
        self.shm = ShimShmem.from_buffer(self.mm)
        self.shm.magic = SHIM_ABI_MAGIC
        self.shm.abi_size = size
        self.shm.rng_seed = seed & ((1 << 64) - 1)
        self.shm.rng_counter = 0
        self.shm.sock_sndbuf = sndbuf
        self.shm.sock_rcvbuf = rcvbuf

    def close(self) -> None:
        # ctypes views derived from from_buffer pin the mmap's export flag
        # until collected: drop ours and close; only if a view is still
        # alive (a reference cycle), collect and try once more, and tolerate
        # stragglers (the region is tiny and unmapped at interpreter exit
        # regardless).  A full collection costs a tenth of a second in a
        # process holding torch, so it is not taken on every close
        import gc
        import os

        del self.shm
        try:
            self.mm.close()
        except BufferError:
            gc.collect()
            try:
                self.mm.close()
            except BufferError:
                pass
        try:
            os.unlink(self._f.name)
        except OSError:
            pass
        self._f.close()

    # -- protocol ----------------------------------------------------------

    def read_arena(self, n: int) -> bytes:
        """Copy ``n`` bytes out of the zero-syscall staging arena (the
        channel turn serializes access; the shim wrote before sending)."""
        n = max(0, min(n, SHIM_ARENA_SIZE))
        return ctypes.string_at(ctypes.addressof(self.shm.arena), n)

    def write_arena(self, data: bytes) -> int:
        n = min(len(data), SHIM_ARENA_SIZE)
        ctypes.memmove(self.shm.arena, data, n)
        return n

    def set_clock(self, emu_ns: int) -> None:
        self.shm.sim_clock_ns = emu_ns

    def try_recv(self) -> bool:
        """True if a plugin->manager message is ready (and claims it)."""
        msg = self.shm.to_shadow
        if msg.turn == 0:
            return False
        msg.turn = 0
        return True

    def wait_recv(self, alive, timeout_s: float = 30.0) -> None:
        """Block until the plugin posts a message.  ``alive()`` is polled so
        a dead plugin raises instead of deadlocking (the ChildPidWatcher's
        job in the reference, utility/childpid_watcher.rs)."""
        msg = self.shm.to_shadow
        addr = ctypes.addressof(msg)  # 'turn' is the first field
        deadline = wall_time.monotonic() + timeout_s
        while True:
            if msg.turn != 0:
                msg.turn = 0
                return
            if not alive():
                # re-check the channel before declaring death: the plugin
                # may have PUBLISHED its farewell and exited between the
                # turn check above and the liveness probe — taking the
                # died path then would classify the exit differently than
                # a run where the farewell won the race (a wall-clock
                # dependence that broke run-twice determinism under load)
                if msg.turn != 0:
                    msg.turn = 0
                    return
                raise PluginDied("plugin exited without a farewell message")
            if wall_time.monotonic() > deadline:
                raise TimeoutError("plugin unresponsive (blocked outside the shim?)")
            futex_wait(addr, 0, 0.05)

    def reply(self, ret: int = 0, args=None, payload: bytes = b"") -> None:
        msg = self.shm.to_shim
        msg.ret = ret
        for i in range(6):
            msg.args[i] = args[i] if args and i < len(args) else 0
        n = min(len(payload), SHIM_PAYLOAD_MAX)
        if n:
            ctypes.memmove(msg.payload, payload, n)
        msg.payload_len = n
        msg.turn = 1
        futex_wake(ctypes.addressof(msg))

    # -- request accessors -------------------------------------------------

    @property
    def req(self) -> ShimMsg:
        return self.shm.to_shadow

    def req_payload(self) -> bytes:
        msg = self.shm.to_shadow
        return bytes(msg.payload[: msg.payload_len])


class PluginDied(RuntimeError):
    pass


# -- cross-process memory copy (the reference's MemoryCopier,
# memory_manager/memory_copier.rs: process_vm_readv/writev) -------------------

_SYS_process_vm_readv = 310
_SYS_process_vm_writev = 311


class _IOVec(ctypes.Structure):
    _fields_ = [("iov_base", ctypes.c_void_p), ("iov_len", ctypes.c_size_t)]


def vm_read(pid: int, addr: int, n: int) -> bytes:
    """Read ``n`` bytes of another process's memory in ONE kernel call —
    large managed-process buffers (a 1 MiB write()) move without riding
    the 64 KiB shared-memory frame one chunk per exchange."""
    buf = ctypes.create_string_buffer(n)
    local = _IOVec(ctypes.cast(buf, ctypes.c_void_p), n)
    remote = _IOVec(ctypes.c_void_p(addr), n)
    # every scalar explicitly 64-bit: ctypes passes bare Python ints as
    # 32-bit varargs, leaving garbage in the upper register halves the
    # kernel reads as iovcnt/flags (intermittent EINVAL)
    r = _libc.syscall(
        ctypes.c_long(_SYS_process_vm_readv), ctypes.c_long(pid),
        ctypes.byref(local), ctypes.c_ulong(1),
        ctypes.byref(remote), ctypes.c_ulong(1), ctypes.c_ulong(0),
    )
    if r < 0:
        raise OSError(ctypes.get_errno(), "process_vm_readv failed")
    return buf.raw[:r]


def vm_write(pid: int, addr: int, data: bytes) -> int:
    """Write ``data`` into another process's memory in ONE kernel call —
    the MemoryCopier's write side (memory_copier.rs): a multi-MB recv()
    lands in the plugin's buffer without riding the 64 KiB frame one
    chunk per exchange.  Returns the byte count written (the kernel only
    partial-writes across iovecs; with one iovec it is all or error)."""
    buf = ctypes.create_string_buffer(data, len(data))
    local = _IOVec(ctypes.cast(buf, ctypes.c_void_p), len(data))
    remote = _IOVec(ctypes.c_void_p(addr), len(data))
    r = _libc.syscall(
        ctypes.c_long(_SYS_process_vm_writev), ctypes.c_long(pid),
        ctypes.byref(local), ctypes.c_ulong(1),
        ctypes.byref(remote), ctypes.c_ulong(1), ctypes.c_ulong(0),
    )
    if r < 0:
        raise OSError(ctypes.get_errno(), "process_vm_writev failed")
    return int(r)

