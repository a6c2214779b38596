"""What kernels C and D's cluster form costs around them, on the card.

C (``queue_min_window``) and D (``append_log``) of
``shadow_tpu_torch/csrc/lanes.cu`` launch as thread-block clusters through
``cudaLaunchKernelEx``.  This script measures, with the probes in
``scripts/gpu_cluster_probe.cu`` (not part of the port):

1. ``launch``: the host's time to enqueue one launch and the device's time
   to run it back to back, for an empty kernel with a LaneBufs-sized
   parameter, launched with ``<<<>>>``, with ``cudaLaunchKernelEx``, and
   with ``cudaLaunchKernelEx`` and a cluster dimension, at C's and D's
   grid shapes; the launches wait behind a spin kernel, so neither side
   waits for the other.
2. ``wrappers``: the same two times for one call of the wrappers of A, B,
   C and D (``kernels.lane_slots``, ``exchange_merge``,
   ``queue_min_window``, ``append_log``) at the flagship's shapes with a
   log, in this tree and in another checkout (``--parent``), alternating.
3. ``lookback``: D's instance as a single-pass scan with decoupled
   look-back (the probe) beside D's cluster form on the same inputs, each
   held word for word against ``lanes.append_log_plain``, device time per
   launch from the profiler: the hybrid flagship's egress instance alone
   (one valid row, and a third valid), the flagship's log and the 48,000
   host flagship's log (a fifth valid).
4. ``e2e`` and ``hybrid``: sim-s/wall-s of the host-bound main paths of
   ``chip_smoke.py`` (the flagship 10 s, the lossy flagship 10 s,
   cubic-vs-reno, and the flagship 1 s with a log) and of the hybrid
   flagship on its fused law, each tree in a process of its own, in the
   order parent / this / this / parent (/ parent / this).

Every part runs in a child process, so that this one holds no CUDA
context while the hybrid flagship checks the card's compute apps.  Run
from the repo root on a machine with an H100, another commit unpacked in
a directory that ``.gitignore`` lists::

    mkdir -p build/parent && git archive <commit> | tar -x -C build/parent
    env PYTHONPATH=. python3 scripts/gpu_cluster_probe.py --parent build/parent

Each part prints its lines; a JSON summary is the last line.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
THIS = HERE.parent
E2E_PATHS = ("flagship 10 s", "lossy flagship 10 s",
             "cubic-vs-reno.yaml, 60 s", "flagship 1 s, logging")


def probe_lib():
    """The probes built (once a source) with the port's ``nvcc`` flags."""
    import ctypes
    import hashlib

    from shadow_tpu_torch.backend import kernels

    src = HERE / "gpu_cluster_probe.cu"
    out = (THIS / "build" / "cluster_probe" /
           f"probe-{hashlib.sha256(src.read_bytes()).hexdigest()[:12]}.so")
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        proc = subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-o",
                               str(out), str(src)], capture_output=True,
                              text=True)
        print("\n".join(line for line in (proc.stdout + proc.stderr)
                        .splitlines() if "registers" in line or "spill" in
                        line or "error" in line), flush=True)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed: {proc.stderr[-3000:]}")
    lib = ctypes.CDLL(str(out))
    vp, i32, i64, u32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                         ctypes.c_uint32)
    lib.probe_launch.argtypes = [i32, i32, i32, i32, i32,
                                 ctypes.POINTER(ctypes.c_double),
                                 ctypes.POINTER(ctypes.c_double)]
    lib.lookback_tiles.argtypes = [i64]
    lib.lookback_tiles.restype = i64
    lib.lookback_rows.argtypes = [vp, i64, vp, vp, vp, vp, i64, vp, vp, u32,
                                  vp, vp, vp]
    return lib


# ---- parts, each in a child process -----------------------------------------


def part_launch(_tree) -> dict:
    import ctypes

    lib = probe_lib()
    forms = {  # label: (form, blocks, cluster, dynamic shared memory)
        "<<<1>>>": (0, 1, 1, 0),
        "Ex, 1 block": (1, 1, 1, 0),
        "<<<10>>>": (0, 10, 1, 0),
        "Ex, cluster of 10 (C at 10k lanes)": (2, 10, 10, 0),
        "<<<16>>>, 128 KB": (0, 16, 1, 1 << 17),
        "Ex, cluster of 16, 128 KB (D's instance)": (2, 16, 16, 1 << 17),
    }
    out = {k: {"host_ns": [], "device_ns": []} for k in forms}
    for rnd in range(4):
        order = list(forms) if rnd % 2 == 0 else list(forms)[::-1]
        for label in order:
            host, dev = ctypes.c_double(), ctypes.c_double()
            form, blocks, cluster, smem = forms[label]
            err = lib.probe_launch(form, 400, blocks, cluster, smem,
                                   ctypes.byref(host), ctypes.byref(dev))
            if err:
                raise RuntimeError(f"{label}: CUDA error {err}")
            out[label]["host_ns"].append(host.value)
            out[label]["device_ns"].append(dev.value)
    for label, v in out.items():
        print(f"launch {label}: host {fmt(v['host_ns'])} ns, device "
              f"{fmt(v['device_ns'])} ns per launch", flush=True)
    return out


def part_wrappers(_tree) -> dict:
    import tempfile

    import torch

    import chip_smoke as cs
    from shadow_tpu_torch.backend import kernels, lanes
    from shadow_tpu_torch.backend.gpu_engine import GpuEngine

    cs.DATA = tempfile.mkdtemp(prefix="cluster_probe_")
    eng = GpuEngine(cs.flagship(sim_seconds=1), log_capacity=1_200_000)
    p = eng.params
    args = kernels.LaneArgs(p, eng.tables, eng.initial_state(),
                            lanes.make_workspace(p, "cuda"))
    calls = {"lane_slots": lambda: kernels.lane_slots(args),
             "exchange_merge": lambda: kernels.exchange_merge(args),
             "queue_min_window": lambda: kernels.queue_min_window(args, True),
             "append_log": lambda: kernels.append_log(args)}
    reps = 300
    out = {k: {"host_us": [], "device_us": []} for k in calls}
    for fn in calls.values():
        for _ in range(20):
            fn()
    torch.cuda.synchronize()
    for rnd in range(4):
        for name in (calls if rnd % 2 == 0 else list(calls)[::-1]):
            torch.cuda._sleep(reps * 60_000)  # the launches wait behind it
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            t0 = time.perf_counter()
            for _ in range(reps):
                calls[name]()
            host = (time.perf_counter() - t0) / reps * 1e6
            b.record()
            b.synchronize()
            out[name]["host_us"].append(host)
            out[name]["device_us"].append(a.elapsed_time(b) * 1e3 / reps)
    for name, v in out.items():
        print(f"wrapper {name}: host {fmt(v['host_us'])} us, device "
              f"{fmt(v['device_us'])} us per call", flush=True)
    return out


def part_lookback(_tree) -> dict:
    import tempfile

    import numpy as np
    import torch

    import chip_smoke as cs
    from shadow_tpu_torch.backend import kernels, lanes
    from shadow_tpu_torch.backend.gpu_engine import GpuEngine

    cs.DATA = tempfile.mkdtemp(prefix="cluster_probe_")
    lib = probe_lib()
    rng = np.random.default_rng(cs.SEED + 12)
    gen = [0]
    hcfg = cs.hybrid_cfg("probe")
    cases = {  # label: (engine, instance, density)
        "hybrid egress, one valid row":
            (lambda: GpuEngine(hcfg, log_capacity=0,
                               external=cs.external_mask(hcfg)), "egress",
             None),
        "hybrid egress, a third valid":
            (lambda: GpuEngine(hcfg, log_capacity=0,
                               external=cs.external_mask(hcfg)), "egress",
             1 / 3),
        "flagship log, a fifth valid":
            (lambda: GpuEngine(cs.flagship(sim_seconds=1),
                               log_capacity=1_200_000), "log", 0.2),
        "48,000-host log, a fifth valid":
            (lambda: GpuEngine(cs.flagship(sim_seconds=1, n_hosts=48_000),
                               log_capacity=1_200_000), "log", 0.2),
    }
    out = {}
    for label, (make, inst, density) in cases.items():
        eng = make()
        p = eng.params
        s = eng.initial_state()
        ws = lanes.make_workspace(p, "cuda")
        if inst == "egress":
            flags, recs = ws.eg_valid, ws.eg_recs
            dst, cnt, lost = s.egress, s.egress_count, s.egress_lost
            cap, hi, lo = p.egress_capacity, s.egress_min_hi, s.egress_min_lo
        else:
            flags, recs = ws.rec_valid, ws.recs
            dst, cnt, lost, cap = s.log, s.log_count, s.log_lost, \
                p.log_capacity
            hi = lo = None
        n = flags.numel()
        v = (np.arange(n) == n // 2 + 7) if density is None else \
            rng.random(n) < density
        flags.copy_(torch.as_tensor(v.astype(np.int32)))
        rows = rng.integers(0, 1 << 40, tuple(recs.shape))
        rows[:, 5] = rng.choice([lanes.DELIVERED, lanes.DROP_CODEL], n)
        recs.copy_(torch.as_tensor(rows))
        cnt.fill_(17)
        outs = [t for t in (dst, cnt, lost, hi, lo) if t is not None]
        snap = [t.clone() for t in outs]

        def restore():
            for t, v0 in zip(outs, snap):
                t.copy_(v0)

        tiles = int(lib.lookback_tiles(n))
        status = torch.zeros(tiles, dtype=torch.int64, device="cuda")
        mins = torch.empty(tiles, dtype=torch.int64, device="cuda")
        stream = torch.cuda.current_stream().cuda_stream
        ptr = (lambda t: None if t is None else t.data_ptr())

        def lookback():
            gen[0] += 1
            err = lib.lookback_rows(flags.data_ptr(), n, recs.data_ptr(),
                                    dst.data_ptr(), cnt.data_ptr(),
                                    lost.data_ptr(), cap, status.data_ptr(),
                                    mins.data_ptr(), gen[0], ptr(hi),
                                    ptr(lo), stream)
            if err:
                raise RuntimeError(f"lookback_rows: CUDA error {err}")

        args = kernels.LaneArgs(p, eng.tables, s, ws)
        forms = {"cluster": (lambda: kernels.append_log(args),
                             "append_log_kernel"),
                 "lookback": (lookback, "lookback_kernel")}
        restore()
        lanes.append_log_plain(p, s, ws)
        want = [t.clone() for t in outs]
        equal = {}
        for form, (fn, _key) in forms.items():
            restore()
            fn()
            torch.cuda.synchronize()
            equal[form] = all(torch.equal(a, b) for a, b in zip(outs, want))
        times = {f: [] for f in forms}
        for form in ("cluster", "lookback", "lookback", "cluster"):
            times[form].append(device_us(*forms[form], restore))
        out[label] = {"flags": n, "valid": int(v.sum()), "tiles": tiles,
                      "equal": equal, "device_us": times}
        print(f"lookback {label}: {n} flags, {int(v.sum())} valid, "
              f"{tiles} look-back tiles; equal to the plain version "
              f"{equal}; device us per launch, cluster "
              f"{fmt(times['cluster'])}, look-back "
              f"{fmt(times['lookback'])}", flush=True)
        if not all(equal.values()):
            raise AssertionError(f"{label}: a form differs from the plain "
                                 f"version: {equal}")
    return out


def part_e2e(_tree) -> dict:
    import tempfile

    import chip_smoke as cs
    from shadow_tpu_torch.backend.gpu_engine import GpuEngine

    cs.DATA = tempfile.mkdtemp(prefix="cluster_probe_")
    GpuEngine(cs.flagship(sim_seconds=1), log_capacity=0).run(mode="device")
    out = {}
    for _ in range(3):
        for name in E2E_PATHS:
            cfg_fn, log_cap, _check, _sim = cs.MAIN_PATHS[name]
            res = GpuEngine(cfg_fn(), log_capacity=log_cap).run(mode="device")
            out.setdefault(name, []).append(res.sim_seconds_per_wall_second)
    for name, rates in out.items():
        print(f"e2e {name}: {fmt(rates)} sim-s/wall-s", flush=True)
    return out


def part_hybrid(_tree) -> dict:
    import tempfile

    import chip_smoke as cs

    cs.DATA = tempfile.mkdtemp(prefix="cluster_probe_")
    cs.native_build()
    run = cs.hybrid_flagship("fused")
    out = {"rate": run["rate"], "sync": run["sync"],
           "startup_s": run["startup_s"]}
    print(f"hybrid fused: {run['rate']:.4f} sim-s/wall-s, "
          f"device_sync_s {run['sync']['device_sync_s']:.3f}, "
          f"syscall_service_s {run['sync']['syscall_service_s']:.3f}",
          flush=True)
    return out


PARTS = {"launch": part_launch, "wrappers": part_wrappers,
         "lookback": part_lookback, "e2e": part_e2e, "hybrid": part_hybrid}


def device_us(fn, key: str, restore, n: int = 50):
    """Device time per launch of ``fn``'s kernels named ``key``, from the
    profiler over ``n`` launches, each on restored outputs (the restores'
    copies are other kernels); None when the profiler records none."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(5):
        restore()
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            restore()
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(ev, "device_time_total", None)
             or getattr(ev, "cuda_time_total", 0.0)
             for ev in prof.key_averages() if key in ev.key)
    return us / n if us else None


def fmt(xs) -> str:
    return " / ".join("none" if x is None else f"{x:.3f}" for x in xs)


# ---- the parent process ------------------------------------------------------


def child(part: str, tree: Path) -> dict:
    """Run ``part`` in a new process importing from ``tree``."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, str(Path(__file__).resolve()), "--part", part,
         "--tree", str(tree)], capture_output=True, text=True, timeout=1800)
    lines = proc.stdout.splitlines()
    for line in lines:
        if not line.startswith("RESULT "):
            print(f"[{part} {tree.name}] {line}", flush=True)
    if proc.returncode:
        print(proc.stderr[-6000:], flush=True)
        raise RuntimeError(f"{part} in {tree} failed ({proc.returncode})")
    result = json.loads(next(ln for ln in lines
                             if ln.startswith("RESULT "))[7:])
    print(f"[{part} {tree.name}] {time.perf_counter() - t0:.1f} s",
          flush=True)
    return result


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", type=Path, help="another checkout")
    ap.add_argument("--part", choices=PARTS)
    ap.add_argument("--tree", type=Path, default=THIS)
    ap.add_argument("--only", nargs="*", choices=PARTS,
                    help="the parts to run (all by default)")
    a = ap.parse_args()
    if a.part:  # a child: import the port and chip_smoke from the tree
        sys.path.insert(0, str(a.tree.resolve()))
        import torch
        if not torch.cuda.is_available():
            print("gpu_cluster_probe: no CUDA device", file=sys.stderr)
            return 1
        print("RESULT " + json.dumps(PARTS[a.part](a.tree)))
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"nvidia-smi: {smi}", flush=True)
    this = THIS
    parent = a.parent.resolve() if a.parent else None
    pairs = [this] if parent is None else None
    summary = {"device": smi}
    only = a.only or list(PARTS)
    for part in ("launch", "lookback"):
        if part in only:
            summary[part] = child(part, this)
    for part, order in (("wrappers", "TPPT"), ("e2e", "PTTPPT"),
                        ("hybrid", "PTTP")):
        if part not in only:
            continue
        trees = pairs or [this if c == "T" else parent for c in order]
        summary[part] = [{"tree": "this" if t == this else "parent",
                          **child(part, t)} for t in trees]
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
