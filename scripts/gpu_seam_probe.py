"""The price of the step driver's per-window seam on one card.

    env PYTHONPATH=. python3 scripts/gpu_seam_probe.py [--sim-seconds 2]

On the flagship (``flagship_mesh_config(10000)`` at the bench tuning, C=16,
K=2, Cx=8, no log; the kernels built first), warmed by one run of each
mode: the loop's sim-s/wall-s in device mode, in plain step mode, and in
step mode with each consumer of the seam — an ``on_window`` that does
nothing; perf logging into a file and into ``/dev/null``; the obs Recorder
(metrics); the facade (``Simulation`` with perf logging and a run-control
console fed no command); and perf logging over the reference's form of
the seam (``seam_readback``) — ``--reps`` times in turns.  Then the host's
cost of one flushed line into ``/dev/null`` and into a file, back to back.
Then, twice, over the rounds of one run of plain step mode and of each of
``SPLITS``, the host's wall per round split into the parts of the shipped
``GpuEngine._drive_steps``: the round itself, the seam
(``GpuEngine._seam_probe``, its one read included), the consumer (the
``[window-agg]`` line's ``PerfLog.window_agg``, or the ``on_window``
call) and the rest of the loop; ``SPLITS`` also holds perf logging
unflushed and ``on_window`` hooks that make one system call or spin, to
tell what of a flushed line slows a round.  Prints every number with
the card's name and power limit.  Needs a card: there is no CPU fallback.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import os
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

import chip_smoke as cs
from shadow_tpu_torch.backend import kernels, lanes
from shadow_tpu_torch.backend import lanes_stream as lstr
from shadow_tpu_torch.backend.gpu_engine import GpuEngine
from shadow_tpu_torch.engine.run_control import PerfLog, RunControl
from shadow_tpu_torch.engine.sim import Simulation
from shadow_tpu_torch.obs import Recorder


def seam_readback(eng: GpuEngine, s: lanes.LaneState,
                  p: lanes.LaneParams) -> tuple[int, int, int]:
    """The reference's form of the seam (``tpu_engine.py`` ``_drive_steps``
    reads the head columns and counts on the host): the head columns and
    three scalars gathered into one int32 tensor on the card, read back
    once, the earliest head and the active count taken in numpy.  Returns
    what ``GpuEngine._seam_probe`` returns."""
    hi, lo = [s.q_thi[:, 0]], [s.q_tlo[:, 0]]
    if p.stream_tiered:
        q = s.stream.q
        hi.append(q[lstr.TQ_THI, :, 0])
        lo.append(q[lstr.TQ_TLO, :, 0])
    v = torch.cat(hi + lo + [s.now_we_hi.view(1), s.now_we_lo.view(1),
                             s.min_used_lat.view(1)]).cpu().numpy()
    m = (len(v) - 3) // 2
    heads = (v[:m].astype(np.int64) << 31) | v[m:2 * m]
    we_hi, we_lo, mul = (int(x) for x in v[2 * m:])
    first = int(heads.min())
    ra = p.runahead
    if p.dynamic_runahead and mul != lanes.NEVER32:
        ra = max(mul, max(p.runahead_floor, 1))
    we_pred = min(min(first, p.stop_time) + ra, p.stop_time)
    active = int(np.count_nonzero(heads < we_pred))
    return (we_hi << 31) | we_lo, eng._host_time(first), active


def engine(sim_s: int, seam: str = "shipped") -> GpuEngine:
    eng = GpuEngine(cs.flagship(sim_seconds=sim_s), log_capacity=0)
    if seam == "readback":
        eng._seam_probe = lambda s, p: seam_readback(eng, s, p)
    return eng


class _Unflushed(PerfLog):
    """Perf lines written without the per-line flush (one write a full
    buffer)."""

    def emit(self, line: str) -> None:
        with self._lock:
            print(line, file=self._sink)


def _spin(us: float) -> None:
    end = time.perf_counter() + us * 1e-6
    while time.perf_counter() < end:
        pass


def consumer(eng: GpuEngine, name: str, data: Path) -> dict:
    """Attach the named consumer of the seam to ``eng``; returns the
    ``run`` keywords.  Besides the real consumers, ``on_window`` hooks
    that make one system call (a one-byte ``os.write`` into ``/dev/null``,
    an ``os.getppid``) or spin 80 µs of Python: what of a flushed line
    slows a round."""
    if name.startswith("on_window"):
        if "os.write" in name:
            fd = os.open(os.devnull, os.O_WRONLY)
            return {"on_window": lambda *w: os.write(fd, b"\n")}
        if "getppid" in name:
            return {"on_window": lambda *w: os.getppid()}
        if "spin" in name:
            return {"on_window": lambda *w: _spin(80)}
        return {"on_window": lambda *w: None}
    if name.startswith("perf logging"):
        sink = os.devnull if "/dev/null" in name else data / "lines.log"
        cls = _Unflushed if "unflushed" in name else PerfLog
        eng.perf_log = cls(out=open(sink, "w"))
    elif name == "obs":
        eng.obs = Recorder(run_id="probe")
    return {}


MODES = ("device", "step", "on_window", "perf logging",
         "perf logging, /dev/null", "obs", "facade",
         "perf logging, readback seam")


def run_mode(name: str, sim_s: int, data: Path) -> float:
    if name == "facade":
        cfg = cs.flagship(sim_seconds=sim_s)
        cfg.experimental.perf_logging = True
        cfg.experimental.tpu_log_capacity = 0
        cfg.general.data_directory = str(data / "facade")
        rc = RunControl(out=io.StringIO())
        # the facade's perf lines go to stderr: into a file here
        with open(data / "facade-lines.log", "w") as sink, \
                contextlib.redirect_stderr(sink):
            res = Simulation(cfg, run_control=rc).run(write_data=False)
        return res.sim_seconds_per_wall_second
    eng = engine(sim_s, "readback" if "readback" in name else "shipped")
    kw = consumer(eng, name, data)
    mode = "device" if name == "device" else "step"
    return eng.run(mode=mode, **kw).sim_seconds_per_wall_second


SPLITS = ("on_window", "on_window, readback seam", "on_window, os.write",
          "on_window, getppid", "on_window, spin 80 us", "perf logging",
          "perf logging, unflushed", "perf logging, readback seam")


def split_rounds(name: str, sim_s: int, data: Path) -> dict:
    """Median wall µs per round of each part of the shipped step driver
    with the named consumer: the round (``round_fn``), the seam
    (``_seam_probe`` with its read), the consumer, the rest of the loop
    and the whole round (one round's start to the next's).  Also the
    ``[window-agg]`` lines when perf logging is on."""
    eng = engine(sim_s, "readback" if "readback" in name else "shipped")
    stamps: dict = {"round": [], "seam": [], "consumer": []}
    clock = time.perf_counter

    def timed(key, fn):
        def call(*a, **k):
            t0 = clock()
            out = fn(*a, **k)
            stamps[key].append((t0, clock()))
            return out
        return call

    eng._seam_probe = timed("seam", eng._seam_probe)
    kw = consumer(eng, name, data)
    out = io.StringIO()
    if eng.perf_log is not None:
        # the consumer's own sink (a file or /dev/null), and a copy of the
        # lines for the comparison of the two seams
        pl = eng.perf_log
        pl.window_agg = timed("consumer", pl.window_agg)
        emit = pl.emit
        pl.emit = lambda line: (out.write(line + "\n"), emit(line))
    elif "on_window" in kw:
        kw["on_window"] = timed("consumer", kw["on_window"])
    build = lanes._build_round
    lanes._build_round = lambda *a: timed("round", build(*a))
    try:
        eng.run(mode="step", **kw)
    finally:
        lanes._build_round = build
    rounds = stamps["round"]
    parts: dict = {k: [] for k in ("round", "seam", "consumer", "rest",
                                   "whole")}
    # the seam's first call comes before the first round: round i's seam
    # is call i + 1; the last round finds the run done and has none
    seams = stamps["seam"][1:]
    cons = stamps["consumer"]
    for i in range(len(rounds) - 1):
        r0, r1 = rounds[i]
        parts["round"].append(r1 - r0)
        parts["whole"].append(rounds[i + 1][0] - r0)
        s0, s1 = seams[i]
        parts["seam"].append(s1 - s0)
        end = s1
        if cons:
            c0, c1 = cons[i]
            parts["consumer"].append(c1 - c0)
            end = c1
        parts["rest"].append((rounds[i + 1][0] - end) + (s0 - r1))
    med = {k: sorted(v)[len(v) // 2] * 1e6 for k, v in parts.items() if v}
    return {"us": med, "lines": out.getvalue()}


def split_plain(sim_s: int) -> float:
    """Median wall µs of a round of plain step mode (no consumer: no
    seam)."""
    eng = engine(sim_s)
    times = []
    build = lanes._build_round

    def wrap(*a):
        fn = build(*a)

        def call():
            t0 = time.perf_counter()
            done = fn()
            times.append(time.perf_counter() - t0)
            return done
        return call

    lanes._build_round = wrap
    try:
        eng.run(mode="step")
    finally:
        lanes._build_round = build
    return sorted(times)[len(times) // 2] * 1e6


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sim-seconds", type=int, default=2)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("gpu_seam_probe: no CUDA device")
    kernels.build()
    smi = cs.smi_line()
    data = Path(tempfile.mkdtemp(prefix="seam_"))
    for m in MODES:  # warm-up: first launches, lazy module loads
        run_mode(m, 1, data)
    rates = {m: [] for m in MODES}
    for _ in range(args.reps):
        for m in MODES:
            rates[m].append(run_mode(m, args.sim_seconds, data))
    for m, r in rates.items():
        print(f"flagship 10k {args.sim_seconds} s, {m}: sim-s/wall-s "
              + ", ".join(f"{x:.3f}" for x in r) + f" ({smi})", flush=True)
    line = PerfLog.format_window_agg(10000, 0, 10_000_000, 10_000_000)
    for sink in (os.devnull, data / "lines.log"):
        with open(sink, "w") as f:
            t0 = time.perf_counter()
            for _ in range(2000):
                print(line, file=f, flush=True)
            us = (time.perf_counter() - t0) / 2000 * 1e6
        print(f"one flushed [window-agg] line into {sink}: {us:.1f} us "
              f"({smi})", flush=True)
    for rep in range(2):
        print(f"median wall us per round, plain step (turn {rep}): round "
              f"{split_plain(args.sim_seconds):.1f} ({smi})", flush=True)
        lines = {}
        for name in SPLITS:
            got = split_rounds(name, args.sim_seconds, data)
            lines[name] = got["lines"]
            print(f"median wall us per round, {name} (turn {rep}): "
                  + ", ".join(f"{k} {v:.1f}" for k, v in got["us"].items())
                  + f" ({smi})", flush=True)
        if (lines["perf logging"] != lines["perf logging, readback seam"]
                or not lines["perf logging"]):
            raise SystemExit("gpu_seam_probe: the two seams' [window-agg] "
                             "lines differ")
    print("the shipped seam's and the readback seam's [window-agg] lines "
          "are equal", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
