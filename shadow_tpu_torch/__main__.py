"""CLI entry point: ``python -m shadow_tpu_torch [options] <config.yaml|->``.

The JAX package's command line on the port, with its flags and exit
codes: a YAML config file (or ``-`` for stdin) with CLI flags merged on
top, ``--show-config`` to print the merged result and exit.  Exit codes:
0 done, 1 the simulation failed (a process ended in the wrong state, a
determinism check found a difference, or there is no card), 2 a config
error (a setting the port does not run yet included), 75 stopped by
SIGINT/SIGTERM at a window boundary.

One flag is the port's own: ``--device {cuda,cpu}`` (default ``cuda``),
where the lane and hybrid engines run.  Without a card the command exits
with the error of :func:`shadow_tpu_torch.default_device` unless given
``--device cpu``, where the kernels' plain PyTorch versions run; nothing
falls back to the CPU by itself.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import sys

import shadow_tpu_torch


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="shadow_tpu_torch",
        description="discrete-event network simulator on one NVIDIA GPU "
        "(the PyTorch/CUDA port of shadow_tpu)",
    )
    p.add_argument("config", help="YAML simulation config, or '-' for stdin")
    p.add_argument("--version", action="version",
                   version=shadow_tpu_torch.__version__)
    p.add_argument(
        "--show-config", action="store_true", help="print merged config and exit"
    )
    p.add_argument(
        "--device", choices=("cuda", "cpu"), default="cuda",
        help="where the lane and hybrid engines run (default: the card; "
        "cpu runs the kernels' plain PyTorch versions)",
    )
    # common flags with dedicated spellings (the reference's CliOptions)
    flag_map = {
        "--seed": "general.seed",
        "--stop-time": "general.stop_time",
        "--bootstrap-end-time": "general.bootstrap_end_time",
        "--parallelism": "general.parallelism",
        "--data-directory": "general.data_directory",
        "--log-level": "general.log_level",
        "--heartbeat-interval": "general.heartbeat_interval",
        "--network-backend": "experimental.network_backend",
        "--runahead": "experimental.runahead",
        "--tpu-mesh-shape": "experimental.tpu_mesh_shape",
        "--resume": "experimental.resume_from",
        "--checkpoint-every-windows": "experimental.checkpoint_every_windows",
        "--checkpoint-dir": "experimental.checkpoint_dir",
    }
    for flag, key in flag_map.items():
        p.add_argument(flag, dest=key, default=None, metavar="V")
    p.add_argument(
        "--progress", action="store_true", help="log heartbeat progress lines"
    )
    p.add_argument(
        "--run-control",
        action="store_true",
        help="interactive pause/step/restart console on stdin "
        "(p / c / cN / n / s / s:<pid> / r / rN at window boundaries)",
    )
    p.add_argument(
        "--perf-logging",
        action="store_true",
        help="print [window-agg]/[host-exec-agg]/[hybrid-agg] telemetry",
    )
    p.add_argument(
        "--obs-metrics",
        action="store_true",
        help="record per-phase wall metrics and write a METRICS_*.json "
        "run report",
    )
    p.add_argument(
        "--obs-trace",
        action="store_true",
        help="record phase spans and export a Chrome-trace/Perfetto JSON "
        "(implies --obs-metrics)",
    )
    p.add_argument(
        "--netobs",
        action="store_true",
        help="record per-host network telemetry and write a NETOBS_*.json "
        "run report",
    )
    p.add_argument(
        "--flowtrace",
        action="store_true",
        help="record per-flow packet-lifecycle events and write a "
        "FLOWS_*.json run report with burst attribution",
    )
    p.add_argument(
        "--obs-turns",
        action="store_true",
        help="the device-turn ledger (not ported yet: a config error)",
    )
    p.add_argument(
        "--set",
        dest="overrides",
        action="append",
        default=[],
        metavar="SECTION.FIELD=VALUE",
        help="generic dotted-key config override (repeatable)",
    )
    p.add_argument(
        "--event-log",
        action="store_true",
        help="write the canonical sorted event log (determinism-diff artifact)",
    )
    p.add_argument(
        "--determinism-check",
        action="store_true",
        help="run the simulation twice and fail unless both runs produce "
        "bit-identical event orderings and counters",
    )
    return p


def parse_overrides(ns: argparse.Namespace) -> dict[str, object]:
    overrides: dict[str, object] = {}
    for key, val in vars(ns).items():
        if "." in key and val is not None:
            overrides[key] = val
    for item in ns.overrides:
        key, sep, val = item.partition("=")
        if not sep:
            raise SystemExit(f"--set expects SECTION.FIELD=VALUE, got {item!r}")
        overrides[key] = val
    return overrides


def main(argv: list[str] | None = None) -> int:
    from shadow_tpu_torch.config.options import ConfigError, ConfigOptions
    from shadow_tpu_torch.engine.sim import Simulation

    ns = build_parser().parse_args(argv)
    try:
        if ns.config == "-":
            cfg = ConfigOptions.from_yaml(sys.stdin.read())
        else:
            cfg = ConfigOptions.from_yaml_file(ns.config)
        overrides = parse_overrides(ns)
        for flag in ("run_control", "perf_logging", "obs_metrics",
                     "obs_trace", "netobs", "flowtrace", "obs_turns"):
            if getattr(ns, flag):
                overrides[f"experimental.{flag}"] = True
        if ns.progress:
            overrides["general.progress"] = True
        cfg.apply_overrides(overrides)
        cfg.validate()
    except (ConfigError, OSError, KeyError) as e:
        print(f"config error: {e}", file=sys.stderr)
        return 2

    # async buffered logging (the reference's logger crate: records are
    # queued by the emitting thread, formatted+written by a listener
    # thread, each line prefixed with the simulated clock)
    from shadow_tpu_torch.utils.shadow_log import install_async_logging

    install_async_logging(
        level=getattr(logging, cfg.general.log_level.upper(), logging.INFO),
        stream=sys.stderr,
    )
    if ns.show_config:
        print(json.dumps(dataclasses.asdict(cfg), indent=2, default=str))
        return 0
    try:
        device = shadow_tpu_torch.default_device(ns.device)
    except RuntimeError as e:
        print(f"device error: {e}", file=sys.stderr)
        return 1

    if ns.determinism_check:
        from shadow_tpu_torch.engine.determinism import determinism_check

        try:
            report = determinism_check(cfg, device=device)
        except Exception as e:
            print(f"simulation failed: {e}", file=sys.stderr)
            return 1
        print(report.describe(), file=sys.stderr)
        return 0 if report.identical else 1

    from shadow_tpu_torch.engine.checkpoint import GracefulShutdown

    sim = Simulation(cfg, device=device)
    try:
        result = sim.run()
    except GracefulShutdown as g:
        # SIGINT/SIGTERM: the run stopped cleanly at a window boundary
        # (artifacts flushed, workers reaped); exit 75 (EX_TEMPFAIL)
        print(f"graceful shutdown (signal {g.signum})", file=sys.stderr)
        return GracefulShutdown.EXIT_CODE
    except Exception as e:  # surface backend errors with a nonzero exit
        print(f"simulation failed: {e}", file=sys.stderr)
        return 1
    if ns.event_log:
        path = sim.write_event_log(result)
        print(f"event log: {path}", file=sys.stderr)
    if result.process_errors:
        for err in result.process_errors:
            print(f"process error: {err}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
