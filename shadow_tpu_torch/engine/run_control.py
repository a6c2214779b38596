"""Interactive run-control and perf telemetry (the fork's EDT features).

The JAX package's ``engine/run_control.py`` on the port: the simulation
soft-pauses only at window boundaries (never mid-host, never
mid-syscall-IPC), a stdin console drives pause/continue/step/restart, and
window/host-execution telemetry prints aggregate ``[window-agg]`` /
``[host-exec-agg]`` / ``[hybrid-agg]`` lines for parallelism studies.

Command grammar (identical to the reference fork):

- ``p``        pause at the next window boundary
- ``c``        continue (resume)
- ``cN``       continue for N seconds of *simulated* time, then pause
- ``n``        run exactly one more window, then pause (gdb-like next)
- ``s``        show next-window hosts/PIDs (when paused)
- ``s:<pid>``  print a gdb attach command for a managed process
- ``info``     same as ``s``
- ``r``        restart from t=0 (in-process, deterministic)
- ``rN``       restart and run to N simulated seconds, then pause

Observability extensions:

- ``stats``          print a live metrics snapshot (phase walls,
  counters, gauges — plus the netobs network totals and the flowtrace
  summary when those planes are on) at the current window boundary
- ``netstats [host]``  print the simulated-network telemetry snapshot
  (obs/netobs.py); with a hostname, that host's counter row too
- ``flows [host]``   print the per-flow packet-lifecycle snapshot
  (obs/flowtrace.py); with a hostname, only that host's flow pairs
- ``trace``          tracer status; ``trace on|off`` toggles recording;
  ``trace dump [path]`` exports the Chrome trace collected so far

Verbs whose sinks belong to later ROADMAP items answer with a line that
names the item: ``turns`` (the device-turn ledger), ``fault ...`` (the
console's fault injection) and ``failover`` (item 12), ``checkpoint``
and ``resume <path>`` (item 11).

A step (``n``) or run-until (``cN``) pause that lands on a *terminal*
boundary — the event queues are drained, no further window will come —
prints a terminal status and lets the run complete instead of blocking
on a window that never arrives.  An explicit ``p`` pause still blocks
there: it is the last chance to inspect state or restart.

Restart is delivered as a :class:`RestartRequest` raised out of the round
loop and caught by the simulation facade, which rebuilds the engine from
the same config (determinism makes the re-run bit-identical).
"""

from __future__ import annotations

import queue
import sys
import threading
import time as wall_time
from typing import Callable, Optional, TextIO

from ..core import time as stime

NANOS_PER_SEC = stime.NANOS_PER_SEC


class RestartRequest(Exception):
    """Unwound out of the round loop to trigger an in-process restart."""

    def __init__(self, run_until_ns: Optional[int] = None) -> None:
        self.run_until_ns = run_until_ns
        if run_until_ns is None:
            super().__init__("restart requested")
        else:
            super().__init__(f"restart requested: run until {run_until_ns} ns")


# one entry per host that has events in the next window:
# (hostname, next_event_time_ns, [native pids of managed processes])
WindowInfo = list[tuple[str, int, list[int]]]


class RunControl:
    """Window-boundary soft-pause state machine.

    Commands arrive on an internal queue — from the interactive stdin
    reader thread (:meth:`start_stdin_thread`) or scripted via
    :meth:`feed` (tests, programmatic drivers)."""

    def __init__(
        self,
        out: TextIO = sys.stderr,
        poll_interval: float = 0.2,
        max_wait: Optional[float] = None,
    ) -> None:
        self._cmds: "queue.Queue[str]" = queue.Queue()
        self._out = out
        self._poll = poll_interval
        self._max_wait = max_wait  # tests: raise instead of blocking forever
        self.pause_requested = False
        self.step_windows_remaining = 0
        self.run_until_abs_ns: Optional[int] = None
        self.pauses = 0  # telemetry: how many soft-pauses happened
        self._stdin_started = False
        # set by the engine before each boundary so s/info can answer
        self._describe: Optional[Callable[[], WindowInfo]] = None
        # obs seam (engine/sim.py wires the run's Recorder): the
        # stats/trace console verbs answer from it at window boundaries
        self._obs = None
        # netobs seam: `netstats [host]` answers from the engine's live
        # network-telemetry counters (obs/netobs.py)
        self._netobs_sink: Optional[Callable[[Optional[str]], list[str]]] = None
        # flowtrace seam: `flows [host]` answers from the engine's live
        # packet-lifecycle event stream (obs/flowtrace.py)
        self._flows_sink: Optional[Callable[[Optional[str]], list[str]]] = None

    # -- command input -----------------------------------------------------

    def feed(self, *commands: str) -> None:
        """Queue commands programmatically (the scripted stdin)."""
        for c in commands:
            self._cmds.put(c)

    def set_obs(self, obs) -> None:
        """Register the run's obs Recorder (shadow_tpu/obs/) so the
        ``stats`` / ``trace`` verbs can answer from live state."""
        self._obs = obs

    def set_netobs_sink(
        self, sink: Callable[[Optional[str]], list[str]]
    ) -> None:
        """Register the engine's network-telemetry snapshot callback:
        ``sink(host_or_None)`` returns the ``netstats`` answer lines."""
        self._netobs_sink = sink

    def set_flows_sink(
        self, sink: Callable[[Optional[str]], list[str]]
    ) -> None:
        """Register the engine's flow-trace snapshot callback:
        ``sink(host_or_None)`` returns the ``flows`` answer lines."""
        self._flows_sink = sink

    def start_stdin_thread(self) -> None:
        """Read commands from stdin on a daemon thread (interactive use)."""
        if self._stdin_started:
            return
        self._stdin_started = True

        def pump() -> None:
            for line in sys.stdin:
                self._cmds.put(line.strip())

        threading.Thread(target=pump, name="run-control-stdin", daemon=True).start()

    # -- boundary hook (called by the engine after every window) -----------

    def at_window_boundary(
        self,
        window_start: int,
        window_end: int,
        next_event_time: int,
        describe: Optional[Callable[[], WindowInfo]] = None,
        terminal: bool = False,
    ) -> None:
        """Apply pending requests; soft-pause (block) if asked.  Raises
        :class:`RestartRequest` when a restart command arrives.

        ``terminal=True`` marks a boundary after which no further window
        can come (event queues drained, or nothing before stop_time): a
        step/run-until pause landing here reports terminal status and
        returns instead of blocking the console loop forever — only an
        explicit ``p`` still pauses (to allow inspection or restart)."""
        self._describe = describe
        # pending step/run-until pauses take effect before new commands read
        should_pause = explicit = self.pause_requested
        if self.step_windows_remaining > 0:
            self.step_windows_remaining -= 1
            should_pause = should_pause or self.step_windows_remaining == 0
        if self.run_until_abs_ns is not None and window_end >= self.run_until_abs_ns:
            self.run_until_abs_ns = None
            should_pause = True
        if not should_pause and self.run_until_abs_ns is None:
            # read typed-ahead commands — at most one *state-changing*
            # command per boundary, and none at all while a run-until pause
            # is scheduled, so a queued resume command survives for the
            # pause it is meant to end (scripted drivers)
            while True:
                try:
                    cmd = self._cmds.get_nowait()
                except queue.Empty:
                    break
                self._apply(cmd)
                if self.pause_requested:
                    should_pause = explicit = True
                    break
                if self.step_windows_remaining > 0:
                    self.step_windows_remaining -= 1
                    if self.step_windows_remaining == 0:
                        should_pause = True
                        break
                if self._pending_run_for is not None:
                    break

        self.pause_requested = False
        if not should_pause:
            return
        if terminal and not explicit:
            # a step/run-until pause on a drained queue has no next window
            # to pause before; blocking would hang the console loop
            self.step_windows_remaining = 0
            self.run_until_abs_ns = None
            self._pending_run_for = None
            self._print(
                "[run-control] terminal: event queues drained at sim-time "
                f"{stime.fmt(window_end)}; no further windows — run completes"
            )
            return

        self.pauses += 1
        self._print(
            f"[run-control] paused at window boundary: sim-time "
            f"{stime.fmt(window_end)} (next event {stime.fmt(next_event_time)}); "
            "commands: c / cN / n / s / s:<pid> / r / rN / stats / "
            "netstats [host] / flows [host] / turns / trace ... / "
            "fault ... / failover / checkpoint / resume <ckpt>"
        )
        self._print_info()
        # soft-wait: block until a resuming command arrives
        waited = 0.0
        while True:
            try:
                cmd = self._cmds.get(timeout=self._poll)
            except queue.Empty:
                waited += self._poll
                if self._max_wait is not None and waited >= self._max_wait:
                    raise RuntimeError(
                        "run-control pause exceeded max_wait with no command"
                    )
                continue
            if self._apply(cmd, paused=True):
                return

    # -- command semantics -------------------------------------------------

    def _apply(self, cmd: str, paused: bool = False) -> bool:
        """Apply one command; returns True iff it resumes a paused run."""
        cmd = cmd.strip()
        if not cmd:
            return False
        if cmd == "p":
            self.pause_requested = True
            return False
        if cmd == "c":
            return True  # resume; when running, a bare c is a no-op
        if cmd.startswith("c") and cmd[1:].strip().isdigit():
            # run-for is relative to *now*; the engine translates it into an
            # absolute pause time via consume_run_for at the resume point
            self.run_until_abs_ns = None
            self._pending_run_for = int(cmd[1:].strip()) * NANOS_PER_SEC
            self.pause_requested = False
            return True
        if cmd == "n":
            self.step_windows_remaining = 1
            return True
        if cmd in ("s", "info"):
            if paused:
                self._print_info()
            else:
                self._print("[run-control] info is available while paused (p first)")
            return False
        if cmd.startswith("s:"):
            pid = cmd[2:].strip()
            self._print(
                f"[run-control] attach with: gdb -p {pid}  "
                "(process is parked at a window boundary)"
            )
            return False
        if cmd == "r":
            raise RestartRequest(None)
        if cmd.startswith("r") and cmd[1:].strip().isdigit():
            raise RestartRequest(int(cmd[1:].strip()) * NANOS_PER_SEC)
        if cmd == "failover":
            self._print(
                "[run-control] failover is not ported yet: the CPU failover "
                "needs the host half (ROADMAP item 12)"
            )
            return False
        if cmd == "checkpoint" or cmd == "resume" or cmd.startswith("resume "):
            self._print(
                f"[run-control] {cmd.split()[0]} is not ported yet "
                "(checkpoint/resume: ROADMAP item 11)"
            )
            return False
        if cmd == "stats":
            self._cmd_stats()
            return False
        if cmd == "netstats" or cmd.startswith("netstats "):
            self._cmd_netstats(cmd.split()[1:])
            return False
        if cmd == "flows" or cmd.startswith("flows "):
            self._cmd_flows(cmd.split()[1:])
            return False
        if cmd == "turns":
            self._cmd_turns()
            return False
        if cmd == "trace" or cmd.startswith("trace "):
            self._cmd_trace(cmd.split()[1:])
            return False
        if cmd == "fault" or cmd.startswith("fault "):
            self._print(
                "[run-control] fault injection from the console is not "
                "ported yet (ROADMAP item 12)"
            )
            return False
        self._print(f"[run-control] unknown command {cmd!r}")
        return False

    # -- obs verbs (docs/observability.md) ---------------------------------

    def _cmd_stats(self) -> None:
        """``stats``: print a live metrics snapshot — phase walls,
        counters, gauges — at the current window boundary.  When the
        netobs plane is on, the network totals (sent/delivered/bytes,
        drop causes, burst-window histogram) fold into the same answer,
        so one verb gives phase walls + network totals without a
        separate ``netstats`` call."""
        if self._obs is None:
            self._print(
                "[run-control] obs is not enabled (set "
                "experimental.obs_metrics / obs_trace)"
            )
            return
        self._print("[run-control] stats:")
        for line in self._obs.metrics.snapshot_lines():
            self._print(f"[run-control]   {line}")
        if self._netobs_sink is not None:
            # the net_* totals, live (finalize-time counters only land
            # in the registry at run end)
            for line in self._netobs_sink(None):
                self._print(f"[run-control]   {line}")
        if self._flows_sink is not None:
            # one-line flow-trace summary (full detail via `flows`)
            lines = self._flows_sink(None)
            if lines:
                self._print(f"[run-control]   {lines[0]}")

    def _cmd_turns(self) -> None:
        """``turns``: the device-turn ledger snapshot; the ledger
        (``experimental.obs_turns``) is not ported yet."""
        self._print(
            "[run-control] the turn ledger (experimental.obs_turns) is not "
            "ported yet (ROADMAP item 12)"
        )

    def _cmd_netstats(self, tokens: list[str]) -> None:
        """``netstats [host]``: the simulated-network telemetry snapshot
        (obs/netobs.py) — totals, drop causes, window histogram, and one
        host's counter row when a hostname is given."""
        if self._netobs_sink is None:
            self._print(
                "[run-control] netobs is not enabled on this backend "
                "(set experimental.netobs)"
            )
            return
        host = tokens[0] if tokens else None
        self._print("[run-control] netstats:")
        for line in self._netobs_sink(host):
            self._print(f"[run-control]   {line}")

    def _cmd_flows(self, tokens: list[str]) -> None:
        """``flows [host]``: the per-flow packet-lifecycle snapshot
        (obs/flowtrace.py) — event totals, per-kind counts, ranked flow
        pairs; with a hostname, only the pairs touching that host."""
        if self._flows_sink is None:
            self._print(
                "[run-control] flowtrace is not enabled on this backend "
                "(set experimental.flowtrace)"
            )
            return
        host = tokens[0] if tokens else None
        self._print("[run-control] flows:")
        for line in self._flows_sink(host):
            self._print(f"[run-control]   {line}")

    def _cmd_trace(self, tokens: list[str]) -> None:
        """``trace`` status / ``trace on|off`` toggle / ``trace dump``:
        live control of the span tracer."""
        obs = self._obs
        tracer = getattr(obs, "tracer", None)
        if tracer is None:
            self._print(
                "[run-control] tracing is not enabled (set "
                "experimental.obs_trace)"
            )
            return
        if not tokens:
            state = "recording" if tracer.enabled else "paused"
            self._print(
                f"[run-control] trace: {state}, "
                f"{tracer.span_count()} span(s) recorded, "
                f"{tracer.dropped} dropped"
            )
            return
        verb = tokens[0]
        if verb in ("on", "off"):
            tracer.enabled = verb == "on"
            self._print(f"[run-control] trace recording {verb}")
            return
        if verb == "dump":
            if len(tokens) > 1:
                path = tokens[1]
            elif obs.out_dir is not None:
                path = str(obs.out_dir / f"trace_{obs.run_id}.json")
            else:
                path = f"trace_{obs.run_id}.json"
            self._print(f"[run-control] trace written: {tracer.export(path)}")
            return
        self._print(f"[run-control] unknown trace subcommand {verb!r}")

    _pending_run_for: Optional[int] = None

    def consume_run_for(self, now_ns: int) -> None:
        """Translate a pending relative ``cN`` into an absolute pause time
        (called by the engine right after a resume)."""
        if self._pending_run_for is not None:
            self.run_until_abs_ns = now_ns + self._pending_run_for
            self._pending_run_for = None

    def arm_after_restart(self, run_until_ns: Optional[int]) -> None:
        """Configure the fresh run after a restart: run to the target time
        then pause (rN), or run freely (r)."""
        self.pause_requested = False
        self.step_windows_remaining = 0
        self._pending_run_for = None
        self.run_until_abs_ns = run_until_ns

    # -- output ------------------------------------------------------------

    def _print(self, line: str) -> None:
        print(line, file=self._out, flush=True)

    def _print_info(self) -> None:
        if self._describe is None:
            return
        info = self._describe()
        if not info:
            self._print("[run-control] no hosts with events in the next window")
            return
        self._print(
            f"[run-control] {len(info)} host(s) with events in the next window:"
        )
        for hostname, t, pids in info:
            pid_s = f" pids={','.join(map(str, pids))}" if pids else ""
            self._print(f"[run-control]   {hostname}: next event {stime.fmt(t)}{pid_s}")


class PerfLog:
    """``[window-agg]`` / ``[host-exec-agg]`` / ``[hybrid-agg]`` telemetry
    (reference fork manager.rs:636-656, host.rs:807-830).  Line formats
    match the fork (and the JAX package) so existing analysis tooling
    parses both.

    Every emission goes through ONE locked :meth:`emit`, so concurrent
    emitters (host-execution worker threads, the round loop) can never
    interleave partial lines.  Worker *processes* route their lines to
    the parent's sink through :class:`BufferedPerfLog` + the round pipes
    (``MpHybridEngine``), so a multiprocess run emits one coherent
    stream."""

    HOST_EXEC_LOG_EVERY = 1000  # host.rs:43

    def __init__(self, out: Optional[TextIO] = None) -> None:
        self._out = out  # None = whatever sys.stderr is at emit time
        self.host_exec_calls = 0
        self.host_exec_total_ns = 0
        self._lock = threading.Lock()  # host_exec is called by worker threads

    @property
    def _sink(self) -> TextIO:
        return self._out if self._out is not None else sys.stderr

    def emit(self, line: str) -> None:
        """The one locked emit path: whole lines only, never interleaved."""
        with self._lock:
            print(line, file=self._sink, flush=True)

    def emit_many(self, lines: list[str]) -> None:
        """Emit forwarded lines (a worker process's buffered telemetry)
        as one locked batch, preserving their order."""
        if not lines:
            return
        with self._lock:
            sink = self._sink
            for line in lines:
                print(line, file=sink, flush=True)

    @staticmethod
    def format_window_agg(
        active_hosts: int,
        window_start: int,
        window_end: int,
        next_event_time: int,
    ) -> str:
        return (
            f"[window-agg] active_hosts_in_window={active_hosts} "
            f"window_start_ns={window_start} window_end_ns={window_end} "
            f"next_event_ns={next_event_time}"
        )

    @staticmethod
    def format_host_exec_agg(
        calls: int, total_ns: int, last_ns: int, hostname: str, window_end: int
    ) -> str:
        return (
            f"[host-exec-agg] calls={calls} "
            f"total_ns={total_ns} last_ns={last_ns} "
            f"host={hostname} window_end_abs_ns={window_end}"
        )

    @staticmethod
    def format_hybrid_agg(kind: str, window_end: int, sync_stats: dict) -> str:
        s = sync_stats
        return (
            f"[hybrid-agg] kind={kind} window_end_ns={window_end} "
            f"device_turns={s['device_turns']} "
            f"device_sync_ns={int(s['device_sync_s'] * 1e9)} "
            f"syscall_service_ns={int(s['syscall_service_s'] * 1e9)} "
            f"scalar_reads={s['scalar_reads']} "
            f"inject_blocks={s['inject_blocks']} "
            f"inject_rows={s['inject_rows']} "
            f"inject_bytes={s['inject_bytes']} "
            f"egress_reads={s['egress_reads']} "
            f"egress_rows={s['egress_rows']} "
            f"egress_bytes={s['egress_bytes']}"
        )

    def window_agg(
        self,
        active_hosts: int,
        window_start: int,
        window_end: int,
        next_event_time: int,
    ) -> None:
        self.emit(
            self.format_window_agg(
                active_hosts, window_start, window_end, next_event_time
            )
        )

    def host_exec(self, hostname: str, elapsed_ns: int, window_end: int) -> None:
        with self._lock:
            self.host_exec_calls += 1
            self.host_exec_total_ns += elapsed_ns
            calls = self.host_exec_calls
            total = self.host_exec_total_ns
        if calls % self.HOST_EXEC_LOG_EVERY == 0:
            self.emit(
                self.format_host_exec_agg(
                    calls, total, elapsed_ns, hostname, window_end
                )
            )

    def hybrid_agg(self, kind: str, window_end: int, sync_stats: dict) -> None:
        """``[hybrid-agg]`` telemetry (hybrid backend): one line per host round (kind=host) /
        device turn (kind=device) carrying the CUMULATIVE host<->device
        sync-cost counters, so the per-window deltas — transfer counts,
        bytes, blocking device-sync and syscall-service wall time — are
        reproducible from a flag instead of ad-hoc prints."""
        self.emit(self.format_hybrid_agg(kind, window_end, sync_stats))

    def timer(self) -> float:
        return wall_time.perf_counter_ns()


class BufferedPerfLog(PerfLog):
    """The worker-process side of perf-line forwarding: :meth:`emit`
    buffers instead of printing, and the worker's round reply carries
    :meth:`drain`'s batch to the parent, which prints it through its own
    locked :meth:`PerfLog.emit_many` — one coherent stream per run, in
    deterministic (round, worker-id) order."""

    def __init__(self) -> None:
        super().__init__(out=None)
        self._buffer: list[str] = []

    def emit(self, line: str) -> None:
        with self._lock:
            self._buffer.append(line)

    def drain(self) -> list[str]:
        with self._lock:
            out = self._buffer
            self._buffer = []
        return out
