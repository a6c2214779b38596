"""Kernels E and H on one card, on mid-run states: this tree's kernels
beside the parent tree's, built from ``--parent``'s ``csrc/lanes.cu``
(its ``LaneBufs`` the same as this one's).

    env PYTHONPATH=. python3 scripts/gpu_row_probe.py --parent build/parent

E runs on the untiered mixed mesh's state after A and B of a step (40
steps in; again with every flow traced), H on the hybrid flagship's state
after its 2 sim s cut (the card's fused run, 2 workers; ``chip_smoke.py``'s
``time_hybrid`` state) with a block of 64 rows to the external lanes, and
one of 400.  Each variant's device time per launch is the profiler's over
30 launches on one restored snapshot, split into its device kernels; every
variant's output words are checked equal to this tree's default form's.
Prints one line per cell and variant with the card's name and power limit,
and the rows' shapes (valid queue entries, the candidates that are not
canonical empties, the groups).  Needs a card, ``nvcc`` and ``make``.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

import chip_smoke as cs
from shadow_tpu_torch.backend import kernels, lanes

REPS = 30
E_PARTS = ("stream_rows_kernel",)
# the parent's H may be B's counting sort before its merge
H_PARTS = ("inj_count_kernel", "inj_place_kernel", "inject_merge_kernel")


def parent_lib(tree: Path) -> ctypes.CDLL:
    out = Path("build/row_probe/liblanes-parent.so")
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", str(out),
                    str(tree / "shadow_tpu_torch/csrc/lanes.cu")],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(out.resolve()))
    vp = ctypes.c_void_p
    lib.stream_rows_merge.argtypes = [vp, vp, ctypes.c_int, vp]
    lib.inject_merge.argtypes = [vp, vp, ctypes.c_int, vp, vp]
    for fn in (lib.stream_rows_merge, lib.inject_merge):
        fn.restype = ctypes.c_int
    return lib


def launcher(lib, name: str, args, extra=()):
    """One launch of ``name`` from ``lib`` over ``args`` (S = 1), with
    ``extra`` pointers before the stream."""
    host = (kernels.LaneBufs * 1)(kernels.LaneBufs.from_buffer_copy(args.bufs))
    dev = torch.frombuffer(bytearray(host), dtype=torch.uint8).cuda()

    def call():
        err = getattr(lib, name)(ctypes.addressof(host), dev.data_ptr(), 1,
                                 *extra,
                                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{name}: CUDA error {err}")
    return call


def device_us(fn, restore, parts) -> dict:
    """The profiler's device time a launch of each of ``parts`` (the
    restores' copies left out by name)."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(REPS):
            restore()
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        part = cs.kernel_name(ev.key)
        if part in parts:
            out[part] = out.get(part, 0.0) + getattr(
                ev, "device_time_total", 0.0) / REPS
    return out


def compare(cell: str, kernel: str, variants: dict, restore, read, parts,
            smi: str) -> None:
    """Each variant on the restored state: its words equal to the first's,
    then its time."""
    want = None
    for label, fn in variants.items():
        restore()
        fn()
        torch.cuda.synchronize()
        got = read()
        if want is None:
            want = got
        else:
            cs.assert_equal(f"{cell} {kernel} {label}", got, want)
        us = device_us(fn, restore, parts)
        split = ", ".join(f"{k} {v:.3f}" for k, v in us.items())
        cs.log(f"{kernel} {cell} {label}: {sum(us.values()):.3f} us "
               f"({split}) ({smi})")


def e_rows(cell: str, p, tb, s, ws) -> None:
    """E's rows on this state: valid queue entries, candidates that are
    not canonical empties, whether the queue rows are sorted."""
    el = tb.flow_lanes.long()
    q = torch.stack([w[el] for w in lanes._queue_words(p, s)]).cpu()
    cand = torch.stack(lanes._stream_candidates(p, tb, ws)).cpu()
    n_q = (q[0] != lanes.NEVER32).sum(dim=1)
    canon = ((cand[0] == lanes.NEVER32) & (cand[1] == lanes.NEVER32)
             & (cand[2] == 0) & (cand[3] == 0))
    rest = (~canon).sum(dim=1)
    perm = lanes._key_order(*q[:4])
    in_order = bool((perm == torch.arange(perm.shape[1])).all())
    cs.log(f"E {cell} rows: {q.shape[1]} of [C {p.capacity} | W_s "
           f"{p.stream_row_width}]; valid queue entries mean "
           f"{float(n_q.float().mean()):.1f} max {int(n_q.max())}; "
           f"non-canonical candidates mean {float(rest.float().mean()):.2f} "
           f"max {int(rest.max())}; queue rows in order: {in_order}")


def e_cell(cell: str, cfg, parent, smi: str) -> None:
    eng = cs.GpuEngine(cfg, log_capacity=0)
    p, tb = eng.params, eng.tables
    s = eng.initial_state()
    ws, window, iteration = lanes._build_iteration(p, tb, s)
    for _ in range(40):
        window(True)
        iteration()
    window(True)
    args = kernels.LaneArgs(p, tb, s, ws)
    kernels.lane_slots(args)
    kernels.exchange_merge(args)
    torch.cuda.synchronize()
    mid = (cs.clone(s), cs.clone(ws))

    def restore():
        cs.copy_into(s, mid[0])
        cs.copy_into(ws, mid[1])

    e_rows(cell, p, tb, s, ws)
    variants = {
        "this": launcher(kernels._lib(), "stream_rows_merge", args),
        "parent": launcher(parent, "stream_rows_merge", args),
    }
    compare(cell, "E", variants, restore, lambda: cs.state_fields(s, ws),
            E_PARTS, smi)


def h_cell(parent, smi: str) -> None:
    cs.native_build()
    eng = cs.hybrid_engine("probe", cs.HYB_CUT_S, "cuda", 2, cs.FUSE_K)
    eng.run()
    dev = eng.device
    state = dev._live_state
    p, tb = dev.params, dev.tables
    ws = lanes.make_workspace(p, cs.DEV)
    args = kernels.LaneArgs(p, tb, state, ws)
    kernels.hybrid_window(args, lanes.HybridTurn(
        lanes.NEVER32, lanes.NEVER32, lanes.NEVER32, True))
    torch.cuda.synchronize()
    rng = np.random.default_rng(cs.SEED + 9)
    ext = np.nonzero(eng.external_mask)[0]
    we = int(lanes.t_join(state.now_we_hi, state.now_we_lo))
    snap = (cs.clone(state), cs.clone(ws))

    def restore():
        cs.copy_into(state, snap[0])
        cs.copy_into(ws, snap[1])

    q = state.q_thi != lanes.NEVER32
    cs.log(f"H rows: {p.n_lanes} lanes of C {p.capacity}, Cxi "
           f"{p.inject_cap}, B {p.inject_batch}; valid queue entries mean "
           f"{float(q.sum(1).float().mean()):.2f} max {int(q.sum(1).max())}")
    lib = kernels._lib()
    for rows in (64, 400):
        blk = cs.hybrid_block(p, rng, rows, ext, we - 1_000_000)
        groups = torch.bincount(blk[1][blk[0] != 0].long(),
                                minlength=p.n_lanes)
        cs.log(f"H block of {rows} rows: {int((groups > 0).sum())} lanes "
               f"with a group, the largest {int(groups.max())}")
        extra = (blk.data_ptr(),)
        variants = {
            "this": launcher(lib, "inject_merge", args, extra),
            "parent": launcher(parent, "inject_merge", args, extra),
        }
        compare(f"hybrid flagship, {rows} rows", "H", variants, restore,
                lambda: cs.state_fields(state, ws), H_PARTS, smi)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True, type=Path)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("gpu_row_probe: no CUDA device", file=sys.stderr)
        return 1
    cs.DATA = tempfile.mkdtemp(prefix="row_probe_")
    smi = cs.smi_line()
    kernels.build()
    parent = parent_lib(args.parent.resolve())
    e_cell("untiered mesh", cs.mixed_mesh(2), parent, smi)
    e_cell("untiered mesh, every flow traced",
           cs.with_flowtrace(cs.mixed_mesh(2), cap=cs.FLOW_RING), parent, smi)
    h_cell(parent, smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
