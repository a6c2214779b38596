"""Simulation facade: config -> backend -> results on disk.

The JAX package's ``engine/sim.py`` on the port: the user-facing runner
(the reference's shadow.rs:33-480 ``run_shadow``, controller.rs,
manager.rs) that picks the backend, runs the round loop, emits heartbeat
progress and writes the data directory (``sim-stats.json``, the counter
dump of manager.rs:844-846, ``hosts/<name>/counters.json``, and on
request the canonical event log for determinism diffs).

It owns the fork's additions too: the in-process restart
(``RestartRequest`` unwound from the round loop and re-run from a fresh
engine, the analog of shadow.rs:233-241), the run-control console and
perf logging of :mod:`shadow_tpu_torch.engine.run_control`, the obs
Recorder with its ``METRICS_``/``NETOBS_``/``FLOWS_*.json`` reports, and
the graceful SIGINT/SIGTERM stop at a window boundary.

``network_backend: tpu`` runs the lane engine on the card
(:class:`~shadow_tpu_torch.backend.gpu_engine.GpuEngine`, ``device=None``)
or on the CPU (``device="cpu"``: the kernels' plain versions): its device
loop, or its step driver when run-control or perf logging asks for a
boundary after every window.  Configs with managed binaries go to the
hybrid engine (``make_hybrid_engine``), without run-control.  ``cpu``
runs the port's scalar ``CpuEngine``.  The checkpoint hook, the CPU
failover and the device mesh of the reference's facade are ROADMAP items
11, 12 and 14; the config refuses their keys, so no path reaches them.
"""

from __future__ import annotations

import json
import logging
import sys
import time as wall_time  # heartbeat timing only; sim time is core.time
from pathlib import Path
from typing import Optional

from ..backend.cpu_engine import OUTCOME_NAMES, CpuEngine
from ..backend.results import SimResult
from ..config.options import ConfigOptions
from ..core import time as stime
from .checkpoint import GracefulShutdown
from .run_control import PerfLog, RestartRequest, RunControl

log = logging.getLogger("shadow_tpu_torch")


class Simulation:
    """Owns one simulation run end to end (the reference's Controller +
    Manager collapsed: config in, data directory out).  ``device``: where
    the lane and hybrid engines run (None: the card)."""

    def __init__(
        self, cfg: ConfigOptions, run_control: Optional[RunControl] = None,
        device=None,
    ) -> None:
        cfg.validate()
        self.cfg = cfg
        self.device = device
        self.data_dir = Path(cfg.general.data_directory)
        self.run_control = run_control
        if run_control is None and cfg.experimental.run_control:
            self.run_control = RunControl()
            if sys.stdin is not None and not sys.stdin.closed:
                # works for interactive terminals and piped command scripts
                # alike; a stdin already drained for the config just EOFs
                self.run_control.start_stdin_thread()
        self.restarts = 0
        self.engine = None  # the backend engine of the most recent run()
        self.obs = None  # the run's obs Recorder (shadow_tpu_torch/obs/)
        self._shutdown_signum: Optional[int] = None
        self._signals_armed = False

    # -- running -----------------------------------------------------------

    def run(self, write_data: bool = True) -> SimResult:
        t0 = wall_time.perf_counter()
        # the async logger's sim-time prefix reads the live engine's window
        # clock (an attribute the round loops maintain anyway); cleared in
        # the finally so a later Simulation cannot inherit a stale clock
        from ..utils import shadow_log

        shadow_log.set_sim_time_provider(
            lambda: getattr(self.engine, "window_end", 0) or 0
        )
        self.obs = self._make_obs()
        if self.obs is not None and self.run_control is not None:
            # the stats/trace console verbs answer from the live recorder
            self.run_control.set_obs(self.obs)
        prev_handlers = self._install_signals()
        try:
            return self._run_logged(write_data, t0)
        finally:
            self._restore_signals(prev_handlers)
            shadow_log.set_sim_time_provider(None)
            if self.obs is not None and self.obs.finalized is None:
                # failed/aborted run: still flush the partial artifacts —
                # a crash is exactly when the phase breakdown matters
                self.obs.finalize()

    # -- graceful shutdown -------------------------------------------------

    def _install_signals(self):
        """Arm SIGINT/SIGTERM for a graceful stop: the first signal asks
        the round loop to stop at the next window boundary (artifact
        flush, worker reap); a second signal restores the default
        disposition and re-raises itself — an immediate exit.  Main
        thread only; returns the previous handlers for
        ``_restore_signals``."""
        import signal
        import threading

        if threading.current_thread() is not threading.main_thread():
            return None

        def handler(signum, frame):
            if self._shutdown_signum is not None:
                signal.signal(signum, signal.SIG_DFL)
                import os

                os.kill(os.getpid(), signum)
                return
            self._shutdown_signum = signum
            log.warning(
                "received %s: stopping at the next window boundary "
                "(artifact flush; signal again to force immediate exit)",
                signal.Signals(signum).name,
            )

        prev = {}
        for sig in (signal.SIGINT, signal.SIGTERM):
            try:
                prev[sig] = signal.signal(sig, handler)
            except (ValueError, OSError):  # pragma: no cover - exotic env
                pass
        self._signals_armed = bool(prev)
        return prev

    def _restore_signals(self, prev) -> None:
        if not prev:
            return
        import signal

        self._signals_armed = False
        for sig, old in prev.items():
            try:
                signal.signal(sig, old)
            except (ValueError, OSError):  # pragma: no cover
                pass

    def _make_obs(self):
        """Build the run's obs Recorder from ``experimental.obs_*`` (None =
        everything off = no engine overhead).  netobs and flowtrace imply
        one: their NETOBS_/FLOWS_*.json reports ride its run id and output
        directory."""
        exp = self.cfg.experimental
        if not (exp.obs_metrics or exp.obs_trace or exp.obs_jsonl
                or exp.netobs or exp.flowtrace):
            return None
        from ..obs import Recorder

        out_dir = Path(exp.obs_dir) if exp.obs_dir else self.data_dir
        run_id = f"{exp.network_backend}-seed{self.cfg.general.seed}"
        return Recorder(
            run_id=run_id,
            out_dir=out_dir,
            trace=exp.obs_trace,
            jsonl=exp.obs_jsonl,
            jax_annotations=exp.obs_jax_annotations,
        )

    def _run_logged(self, write_data: bool, t0: float) -> SimResult:
        cfg = self.cfg
        backend = cfg.experimental.network_backend
        log.info(
            "starting simulation: %d hosts, stop_time=%s, backend=%s, seed=%d",
            len(cfg.hosts),
            stime.fmt(cfg.general.stop_time),
            backend,
            cfg.general.seed,
        )
        # in-process restart loop: a RestartRequest aborts the round loop,
        # the engine is torn down, and a fresh deterministic run begins
        while True:
            try:
                if backend == "tpu":
                    result = self._run_tpu()
                else:
                    result = self._run_cpu()
                break
            except RestartRequest as rr:
                self.restarts += 1
                log.info(
                    "restarting simulation (restart #%d, run_until=%s)",
                    self.restarts,
                    "-" if rr.run_until_ns is None else stime.fmt(rr.run_until_ns),
                )
                if self.run_control is not None:
                    self.run_control.arm_after_restart(rr.run_until_ns)
        total = wall_time.perf_counter() - t0
        for err in result.process_errors:
            log.error("process final-state mismatch: %s", err)
        log.info(
            "simulation done: %s simulated in %.2fs wall (%.2fx real time), "
            "%d rounds, %d log records",
            stime.fmt(result.sim_time_ns),
            result.wall_seconds,
            result.sim_seconds_per_wall_second,
            result.rounds,
            len(result.event_log),
        )
        if self.obs is not None:
            extra = {
                "backend": backend,
                "seed": cfg.general.seed,
                "num_hosts": len(cfg.hosts),
                "sim_time_ns": result.sim_time_ns,
                "wall_seconds": result.wall_seconds,
                "total_wall_seconds": total,
                "rounds": result.rounds,
                "restarts": self.restarts,
                "failovers": 0,
                "restart_work_saved": 0,
                "sim_counters": dict(sorted(result.counters.items())),
            }
            sync = getattr(self.engine, "sync_stats", None)
            if sync is not None:
                extra["hybrid_sync"] = dict(sync)
            self._write_netobs(extra)
            self._write_flows(extra)
            fin = self.obs.finalize(extra=extra)
            for k in ("metrics_path", "trace_path"):
                if k in fin:
                    log.info("obs artifact: %s", fin[k])
        if write_data:
            self._write_data(result, total)
        return result

    def _write_netobs(self, extra: dict) -> None:
        """Write the NETOBS_<run_id>.json report through the Recorder's
        lifecycle and fold its totals into the metrics registry, so the
        ``stats`` verb and the METRICS report carry the network counters
        too."""
        cfg = self.cfg
        snap_fn = getattr(self.engine, "netobs_snapshot", None)
        if not cfg.experimental.netobs or snap_fn is None:
            return
        snap = snap_fn()
        if snap is None:
            return
        from ..obs import netobs as nom

        names = [h.hostname for h in cfg.hosts]
        report = nom.build_report(
            self.obs.run_id,
            cfg.experimental.network_backend,
            cfg.general.seed,
            names,
            snap["arrays"],
            snap["window_hist"],
            log_lost=snap.get("log_lost", 0),
        )
        if self.obs.out_dir is not None:
            path = nom.write_report(
                self.obs.out_dir / f"NETOBS_{self.obs.run_id}.json", report
            )
            log.info("obs artifact: %s", path)
        m = self.obs.metrics
        for k, v in report["totals"].items():
            if v:
                m.count(f"net_{k}", v)
        extra["netobs"] = {
            "drops_by_cause": report["drops_by_cause"],
            "drop_total": report["drop_total"],
            "windows": report["window_hist"]["windows"],
        }

    def _write_flows(self, extra: dict) -> None:
        """Write the FLOWS_<run_id>.json report through the Recorder's
        lifecycle (canonical event stream, per-flow breakdowns, burst
        attribution), the Chrome-trace flow arrows when tracing, and the
        ``flow_events`` / ``flow_events_lost`` counters."""
        cfg = self.cfg
        snap_fn = getattr(self.engine, "flowtrace_snapshot", None)
        if not cfg.experimental.flowtrace or snap_fn is None:
            return
        snap = snap_fn()
        if snap is None:
            return
        from ..obs import flowtrace as ftr

        cap = cfg.experimental.flowtrace_capacity
        events, trunc = ftr.canonical_events(snap["raw"], cap)
        lost = trunc + snap.get("ring_lost", 0)
        thresh, all_pass = ftr.sample_thresh(
            cfg.experimental.flowtrace_sample
        )
        names = [h.hostname for h in cfg.hosts]
        report = ftr.build_report(
            self.obs.run_id,
            cfg.experimental.network_backend,
            cfg.general.seed,
            names,
            events,
            lost,
            thresh,
            all_pass,
            cap,
        )
        if self.obs.out_dir is not None:
            path = ftr.write_report(
                self.obs.out_dir / f"FLOWS_{self.obs.run_id}.json", report
            )
            log.info("obs artifact: %s", path)
        m = self.obs.metrics
        m.count("flow_events", len(events))
        m.count("flow_events_lost", lost)
        if self.obs.tracer is not None:
            ftr.render_flows(self.obs.tracer, events, names)
        extra["flows"] = {
            "num_events": report["num_events"],
            "num_flows": report["num_flows"],
            "events_lost": report["events_lost"],
        }

    def _make_on_window(self, describe_source, runahead, t0: float):
        """Compose the per-round callback: heartbeat lines, run-control
        boundary processing and the graceful-shutdown check.
        ``describe_source(until)`` names the hosts with events before
        ``until`` (for the pause console).  ``runahead`` is an int or a
        live callable (dynamic runahead widens it).  None when nothing
        consumes it, which keeps the round loop free of the hook."""
        heartbeat = self.cfg.general.heartbeat_interval
        rc = self.run_control
        if not heartbeat and rc is None and not self._signals_armed:
            return None
        state = {"next_beat": heartbeat or 0, "rounds": 0}
        stop_time = self.cfg.general.stop_time

        def on_window(window_start: int, window_end: int, next_ev: int) -> None:
            state["rounds"] += 1
            if heartbeat:
                while window_end >= state["next_beat"]:
                    log.info(
                        "heartbeat: sim-time %s, %d rounds, %.1fs wall",
                        stime.fmt(state["next_beat"]),
                        state["rounds"],
                        wall_time.perf_counter() - t0,
                    )
                    state["next_beat"] += heartbeat
            if rc is not None:
                # next_ev == NEVER means no next window: describe nothing
                # rather than listing every idle host
                ra = runahead() if callable(runahead) else runahead
                until = next_ev + ra if next_ev < stime.NEVER else 0
                rc.at_window_boundary(
                    window_start,
                    window_end,
                    next_ev,
                    describe=(
                        (lambda: describe_source(until)) if describe_source else None
                    ),
                    # drained queue / nothing before stop: a step or
                    # run-until pause here would block on a window that
                    # will never come — report terminal status instead
                    terminal=next_ev >= stop_time,
                )
                rc.consume_run_for(window_end)
            if self._shutdown_signum is not None:
                raise GracefulShutdown(self._shutdown_signum)

        return on_window

    def _run_cpu(self) -> SimResult:
        engine = self.engine = CpuEngine(self.cfg)
        if self.cfg.experimental.perf_logging:
            engine.perf_log = PerfLog()
        engine.obs = self.obs
        t0 = wall_time.perf_counter()
        on_window = self._make_on_window(
            engine.describe_next_window, engine.current_runahead, t0
        )
        return engine.run(on_window=on_window)

    def _run_tpu(self) -> SimResult:
        from ..backend.gpu_engine import GpuEngine
        from ..backend.hybrid import make_hybrid_engine
        from ..models.base import config_has_managed

        exp = self.cfg.experimental
        if config_has_managed(self.cfg):
            # the hybrid backend: managed hosts' syscall plane on the host
            # CPU, every packet on the device.  Run-control needs the
            # per-window pause seam, which the device free-run elides — it
            # is disabled here (the cpu backend takes the console).  Perf
            # logging is supported: [hybrid-agg] sync-cost lines
            if self.run_control is not None:
                log.warning(
                    "run-control is not supported on the hybrid tpu "
                    "backend; running without it"
                )
                self.run_control = None
            engine = self.engine = make_hybrid_engine(
                self.cfg, device=self.device
            )
            if exp.perf_logging:
                engine.perf_log = PerfLog()
            engine.obs = self.obs
            t0 = wall_time.perf_counter()
            on_window = self._make_on_window(
                engine.describe_next_window, engine.current_runahead, t0
            )
            return engine.run(on_window=on_window)

        engine = self.engine = GpuEngine(self.cfg, device=self.device)
        engine.obs = self.obs
        # run-control and perf logging need a boundary after every window:
        # the step driver (one round per window, pausable); otherwise the
        # device loop
        if self.run_control is None and not exp.perf_logging:
            return engine.run(mode="device")
        t0 = wall_time.perf_counter()
        on_window = self._make_on_window(None, engine.current_runahead, t0)
        if self.run_control is not None:
            if exp.netobs:
                # `netstats` reads the live device counters at a pause
                self.run_control.set_netobs_sink(engine.netobs_lines)
            if exp.flowtrace:
                # `flows` drains the live device event ring the same way
                self.run_control.set_flows_sink(engine.flowtrace_lines)
        if exp.perf_logging:
            engine.perf_log = PerfLog()
        return engine.run(mode="step", on_window=on_window)

    # -- output ------------------------------------------------------------

    def _write_data(self, result: SimResult, total_wall: float) -> None:
        self.data_dir.mkdir(parents=True, exist_ok=True)
        stats = {
            "sim_time_ns": result.sim_time_ns,
            "wall_seconds": result.wall_seconds,
            "total_wall_seconds": total_wall,
            "sim_seconds_per_wall_second": result.sim_seconds_per_wall_second,
            "rounds": result.rounds,
            "restarts": self.restarts,
            "failovers": 0,
            "restart_work_saved": 0,
            "backend": self.cfg.experimental.network_backend,
            "num_hosts": len(self.cfg.hosts),
            "seed": self.cfg.general.seed,
            "counters": dict(sorted(result.counters.items())),
            "packet_outcomes": self._outcome_counts(result),
        }
        (self.data_dir / "sim-stats.json").write_text(
            json.dumps(stats, indent=2) + "\n"
        )
        hosts_dir = self.data_dir / "hosts"
        hosts_dir.mkdir(exist_ok=True)
        if result.per_host_counters:
            for hopt, counters in zip(self.cfg.hosts, result.per_host_counters):
                d = hosts_dir / hopt.hostname
                d.mkdir(exist_ok=True)
                (d / "counters.json").write_text(
                    json.dumps(dict(sorted(counters.items())), indent=2) + "\n"
                )

    def _outcome_counts(self, result: SimResult) -> dict[str, int]:
        out: dict[str, int] = {}
        for r in result.event_log:
            name = OUTCOME_NAMES.get(r.outcome, str(r.outcome))
            out[name] = out.get(name, 0) + 1
        # flows the lTCP sender abandoned after MAX_RTO_BACKOFFS consecutive
        # timeouts: not a wire event, but an outcome operators need next to
        # the drop counts when links stay dark
        retry_drops = result.counters.get("stream_retry_drops", 0)
        if retry_drops:
            out["retry_drop"] = out.get("retry_drop", 0) + retry_drops
        return out

    def write_event_log(self, result: SimResult, path: Optional[Path] = None) -> Path:
        """Canonical sorted event log — the determinism-diff artifact
        (src/test/determinism/ compares exactly this across runs)."""
        path = path or (self.data_dir / "event-log.tsv")
        path.parent.mkdir(parents=True, exist_ok=True)
        with open(path, "w") as f:
            f.write("time\tsrc\tdst\tseq\tsize\toutcome\n")
            for row in result.log_tuples():
                f.write("\t".join(str(x) for x in row) + "\n")
        return path
