"""Kernels A and G in their forms, on one card, on mid-run states of the
main paths' cells: this tree's kernels, A at each group width (its
threads a lane, ``LaneBufs.slot_group``), beside the parent tree's
kernels, built from ``--parent``'s ``csrc/lanes.cu`` (its ``LaneBufs`` a
prefix of this one's).

    env PYTHONPATH=. python3 scripts/gpu_slot_probe.py --parent build/parent

Each variant's device time per launch is the profiler's over 30 launches
on one restored snapshot (the restores' copies are left out by kernel
name), every variant's output words checked equal to this tree's default
form's.  Prints one line per cell and variant with the card's name and
power limit.  Needs a card and ``nvcc``.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

import chip_smoke as cs
from shadow_tpu_torch.backend import kernels, lanes

REPS = 30


def parent_lib(tree: Path) -> ctypes.CDLL:
    out = Path("build/slot_probe/liblanes-parent.so")
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", str(out),
                    str(tree / "shadow_tpu_torch/csrc/lanes.cu")],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(out.resolve()))
    for name in ("lane_slots", "tier_merge"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def launcher(lib, name: str, args, **fields):
    """One launch of ``name`` from ``lib`` over ``args`` (S = 1), with
    ``fields`` of its LaneBufs changed (this tree's library only)."""
    bufs = kernels.LaneBufs.from_buffer_copy(args.bufs)
    for f, v in fields.items():
        setattr(bufs, f, v)
    host = (kernels.LaneBufs * 1)(bufs)
    dev = torch.frombuffer(bytearray(host), dtype=torch.uint8).cuda()

    def call():
        err = getattr(lib, name)(ctypes.addressof(host), dev.data_ptr(), 1,
                                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{name}: CUDA error {err}")
    return call


def device_us(fn, restore, kernel: str) -> float:
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(REPS):
            restore()
            fn()
        torch.cuda.synchronize()
    us = [getattr(ev, "device_time_total", 0.0) for ev in prof.key_averages()
          if kernel in ev.key]
    return sum(us) / REPS


def rows_of_g(name: str, p, s, ws) -> None:
    """G's rows on this state: valid entries (queue, candidates) and the
    candidates' ascending runs in index order, a row's largest and the
    mean; the slowest row sets the kernel's time."""
    merged = torch.cat([s.stream.q, lanes._tier_candidates(p, ws)],
                       dim=2).cpu()
    c2 = p.stream_capacity
    valid = merged[0] != lanes.NEVER32
    n_q = valid[:, :c2].sum(dim=1)
    n_c = valid[:, c2:].sum(dim=1)
    runs = []
    for r in range(merged.shape[1]):
        cols = merged[:4, r, c2:][:, valid[r, c2:]].T.tolist()
        runs.append(1 + sum(b < a for a, b in zip(cols, cols[1:]))
                    if cols else 0)
    cs.log(f"G {name} rows: valid queue entries mean "
           f"{float(n_q.float().mean()):.1f} max {int(n_q.max())}; "
           f"candidates mean {float(n_c.float().mean()):.1f} max "
           f"{int(n_c.max())}; the candidates' ascending runs mean "
           f"{sum(runs) / len(runs):.2f} max {max(runs)}")


def cell(name: str, cfg, warm: int, log_cap: int, parent, smi: str) -> None:
    eng = cs.GpuEngine(cfg, log_capacity=log_cap)
    p, tb = eng.params, eng.tables
    s = eng.initial_state()
    ws, window, iteration = lanes._build_iteration(p, tb, s)
    for _ in range(warm):
        window(True)
        iteration()
    window(True)
    torch.cuda.synchronize()
    args = kernels.LaneArgs(p, tb, s, ws)
    snap = (cs.clone(s), cs.clone(ws))

    def restore():
        cs.copy_into(s, snap[0])
        cs.copy_into(ws, snap[1])

    lib = kernels._lib()
    k = p.pops_per_iter
    variants = {"this (slot_group %d)" % args.bufs.slot_group:
                launcher(lib, "lane_slots", args)}
    for width in (1, 2, 4, 8, 32):
        if width != args.bufs.slot_group and width <= max(2, 4 * k):
            variants[f"this, slot_group {width}"] = launcher(
                lib, "lane_slots", args, slot_group=width)
    variants["parent"] = launcher(parent, "lane_slots", args)
    want = None
    for label, fn in variants.items():
        restore()
        fn()
        torch.cuda.synchronize()
        got = cs.state_fields(s, ws)
        if want is None:
            want = got
        else:
            cs.assert_equal(f"{name} A {label}", got, want)
        cs.log(f"A {name} (K = {k}) {label}: "
               f"{device_us(fn, restore, 'lane_slots'):.3f} us ({smi})")
    if not p.stream_tiered:
        return
    # G on the state A, B and F leave
    restore()
    kernels.lane_slots(args)
    kernels.exchange_merge(args)
    kernels.stream_tier(args)
    torch.cuda.synchronize()
    mid = (cs.clone(s), cs.clone(ws))

    def restore_mid():
        cs.copy_into(s, mid[0])
        cs.copy_into(ws, mid[1])

    rows_of_g(name, p, s, ws)
    variants = {"this": launcher(lib, "tier_merge", args)}
    variants["parent"] = launcher(parent, "tier_merge", args)
    want = None
    for label, fn in variants.items():
        restore_mid()
        fn()
        torch.cuda.synchronize()
        got = cs.state_fields(s, ws)
        if want is None:
            want = got
        else:
            cs.assert_equal(f"{name} G {label}", got, want)
        cs.log(f"G {name} {label}: "
               f"{device_us(fn, restore_mid, 'tier_merge'):.3f} us ({smi})")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True, type=Path)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("gpu_slot_probe: no CUDA device", file=sys.stderr)
        return 1
    smi = cs.smi_line()
    kernels.build()
    parent = parent_lib(args.parent.resolve())
    cells = {  # the main paths' time_all settings
        "flagship": (cs.flagship(sim_seconds=2), 20, 0),
        "tiered mesh": (cs.mixed_tiered(2), 20, 0),
        "tiered mesh, logging": (cs.mixed_tiered(2), 20, 2_000_000),
        "untiered mesh": (cs.mixed_mesh(2), 40, 0),
        "phold": (cs.phold(stop_time="1s"), 200, 0),
    }
    for name, (cfg, warm, log_cap) in cells.items():
        cell(name, cfg, warm, log_cap, parent, smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
