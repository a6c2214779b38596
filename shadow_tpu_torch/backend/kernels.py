"""The lane engine's CUDA kernels: build, binding and wrappers.

``csrc/lanes.cu`` holds four kernels for Hopper (``sm_90a``) behind a plain C
interface.  At first use on the card it is compiled with ``nvcc`` into
``build/shadow_tpu_torch/`` at the root of the checkout, keyed by a hash of
the source, and loaded with ``ctypes``.  Nothing is built or loaded when
this module is imported.

Each wrapper takes a :class:`LaneArgs` — the run's state, tables and
workspace, checked once (device, dtype, shape, contiguity) when it is
built, since the kernels update that state in place and the pointers never
change during a run.  On CPU tensors a wrapper runs its kernel's plain
version from ``lanes.py``; on CUDA tensors it launches the kernel on
PyTorch's current stream and raises if the launch fails.  There is no
fallback from one to the other.  Each wrapper counts its launches in its
``launches`` attribute (plain runs count nothing).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from . import lanes

_SRC = Path(__file__).resolve().parents[1] / "csrc" / "lanes.cu"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "shadow_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# the merge kernel keeps its row in static-limit shared memory
MERGE_SMEM_LIMIT = 48 * 1024

# LaneBufs (csrc/lanes.cu): every pointer field, in this order, then the sizes
_PTR_FIELDS = (
    lanes.LaneState._fields + lanes.LaneTables._fields
    + lanes.Workspace._fields
)
_INT_FIELDS = ("n", "c", "k", "cx", "g", "log_cap", "stop", "runahead",
               "interval")


class LaneBufs(ctypes.Structure):
    _fields_ = (
        [(f, ctypes.c_void_p) for f in _PTR_FIELDS]
        + [(f, ctypes.c_int64) for f in _INT_FIELDS]
    )


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda = Path("/usr/local/cuda/bin/nvcc")
    if cuda.exists():
        return str(cuda)
    raise RuntimeError("nvcc not found: the lane kernels build only where the "
                       "CUDA toolkit is installed")


def library_path() -> Path:
    digest = hashlib.sha256(
        _SRC.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return _BUILD_DIR / f"liblanes-{digest}.so"


def build() -> Path:
    """Compile ``csrc/lanes.cu`` unless the library for this source is
    already built; returns its path.  The compiler's report (registers,
    shared memory, spills) is kept beside it as ``<name>.log``."""
    out = library_path()
    if out.exists():
        return out
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_SRC)],
        capture_output=True, text=True,
    )
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{proc.stderr[-4000:]}"
        )
    os.replace(tmp, out)
    return out


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    vp = ctypes.c_void_p
    for name in ("lane_slots", "exchange_merge", "append_log"):
        fn = getattr(lib, name)
        fn.argtypes = [vp, vp]
        fn.restype = ctypes.c_int
    lib.queue_min_window.argtypes = [vp, ctypes.c_int, vp]
    lib.queue_min_window.restype = ctypes.c_int
    lib.lanes_error_string.argtypes = [ctypes.c_int]
    lib.lanes_error_string.restype = ctypes.c_char_p
    return lib


def _check(name: str, t: torch.Tensor, device, dtype, shape) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


class LaneArgs:
    """One run's state, tables and workspace, checked for the kernels,
    with their device pointers packed into the ``LaneBufs`` block."""

    def __init__(self, p: lanes.LaneParams, tb: lanes.LaneTables,
                 s: lanes.LaneState, ws: lanes.Workspace) -> None:
        self.p, self.tb, self.s, self.ws = p, tb, s, ws
        dev = s.q_thi.device
        n, c, k, cx = p.n_lanes, p.capacity, p.pops_per_iter, p.cross_cap
        g = int(tb.lat.shape[0])
        i32, i64 = torch.int32, torch.int64
        n_rec = n * (k + cx) + k * n if p.log_capacity else 1
        shapes = {
            **{f: (n, c) for f in ("q_thi", "q_tlo", "q_auxh", "q_auxl",
                                   "q_size")},
            **{f: (n,) for f in lanes._SLOT_FIELDS + ("n_queue",)},
            **{f: () for f in ("log_count", "log_lost", "rounds", "iters",
                               "now_we_hi", "now_we_lo")},
            "log": (max(p.log_capacity, 1), 6),
            **{f: (n,) for f in lanes.LaneTables._fields},
            "lat": (g, g), "codel_div": (1025,),
            "ctl": (4,), "self_blk": (5, n, k), "out_blk": (6, k, n),
            "recs": (n_rec, 6), "rec_valid": (n_rec,),
            "x_cnt": (n,), "x_start": (n,), "x_fill": (n,),
            "x_order": (k * n,),
        }
        dtypes = {"cd_dropping": torch.bool, "log": i64, "recs": i64}
        tensors = {**s._asdict(), **tb._asdict(), **ws._asdict()}
        for f in _PTR_FIELDS:
            _check(f, tensors[f], dev, dtypes.get(f, i32), shapes[f])
        self.on_cuda = dev.type == "cuda"
        if self.on_cuda:
            smem = 4 * (5 * p.merge_width + cx)
            if smem > MERGE_SMEM_LIMIT:
                raise ValueError(
                    f"merge row of {p.merge_width} entries needs {smem} B of "
                    f"shared memory (limit {MERGE_SMEM_LIMIT}); lower the "
                    "queue or cross capacity"
                )
            _lib()  # build and load before the run starts
        self.bufs = LaneBufs(
            **{f: tensors[f].data_ptr() for f in _PTR_FIELDS},
            n=n, c=c, k=k, cx=cx, g=g, log_cap=p.log_capacity,
            stop=p.stop_time, runahead=p.runahead,
            interval=p.bucket_interval,
        )


def _launch(name: str, args: LaneArgs, *extra) -> None:
    lib = _lib()
    stream = torch.cuda.current_stream(args.s.q_thi.device).cuda_stream
    err = getattr(lib, name)(ctypes.byref(args.bufs), *extra, stream)
    if err != 0:
        raise RuntimeError(
            f"{name}: CUDA error {err}: "
            f"{lib.lanes_error_string(err).decode()}"
        )


def lane_slots(args: LaneArgs) -> None:
    """Kernel A: pop, passive slot law, emit blocks.

    Replaces ``shadow_tpu/backend/lanes.py:2900`` ``_build_iter.iter_body``
    (pop) and the passive arm of ``lanes.py:884`` ``_process_slot`` with
    ``bucket_charge_vec`` (``:477``) and ``codel_offer_arrays`` (``:596``).
    Bound on the card by bytes: each lane reads its K head slots, ~30 state
    words and its table row, and writes them back with the emit blocks —
    no reuse, so one thread per lane keeps the whole K-slot walk in
    registers and touches each word once."""
    if not args.on_cuda:
        return lanes.lane_slots_plain(args.p, args.tb, args.s, args.ws)
    _launch("lane_slots", args)
    lane_slots.launches += 1


def exchange_merge(args: LaneArgs) -> None:
    """Kernel B: cross-lane exchange and keyed row merge.

    Replaces ``shadow_tpu/backend/lanes.py:1581`` ``_merge_append`` (with
    ``_window_gather``, ``:1539``) and ``:763`` ``_sort_queues``.  Bound by
    bytes: the ``[N, C]`` queue words are read and written once, plus the
    K*N outbound entries.  The TPU's sort-by-destination and barrel-shift
    gather become a counting sort (atomic counts, one-block scan, atomic
    placement), and the row sort a rank merge of the whole ``[C | K | Cx]``
    row in one block's shared memory, so the row is read from device memory
    once.  The chain of dependent launches and the one-block scan keep it
    well above its bound (PERF.md)."""
    if not args.on_cuda:
        return lanes.exchange_merge_plain(args.p, args.s, args.ws)
    _launch("exchange_merge", args)
    exchange_merge.launches += 1


def queue_min_window(args: LaneArgs, advance: bool) -> None:
    """Kernel C: earliest head, window law, ``live`` flag.

    Replaces ``shadow_tpu/backend/lanes.py:2260`` ``_queue_min`` with
    ``lanes_pairs.py:28`` ``pair_min_lanes`` and the window law of
    ``_build_round`` /
    ``_build_full_run`` (``lanes.py:3346-3356``, ``:3505-3526``).  Its bytes
    (N head pairs, 80 KB at 10k lanes) bound it at tens of nanoseconds, so
    launch and one block's latency set its time.  One block reduces and
    applies the window law, so the flag stays on the device and the host
    reads it only when it chooses to."""
    if not args.on_cuda:
        return lanes.queue_min_window_plain(args.p, args.s, args.ws, advance)
    _launch("queue_min_window", args, int(bool(advance)))
    queue_min_window.launches += 1


def append_log(args: LaneArgs) -> None:
    """Kernel D: compaction of the iteration's records into the log.

    Replaces ``shadow_tpu/backend/lanes.py:2056`` ``_append_log``.  Bound
    by bytes: the valid flags of every record slot are read once and only
    the valid rows are copied.  One block scans tile by tile, which keeps
    the reference's row order with no second pass but runs on one SM — far
    above its bound, and only on logging runs (PERF.md)."""
    if not args.on_cuda:
        return lanes.append_log_plain(args.p, args.s, args.ws)
    _launch("append_log", args)
    append_log.launches += 1


WRAPPERS = (lane_slots, exchange_merge, queue_min_window, append_log)


def reset_launches() -> None:
    for fn in WRAPPERS:
        fn.launches = 0


reset_launches()
