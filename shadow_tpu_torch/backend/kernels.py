"""The lane engine's CUDA kernels: build, binding and wrappers.

``csrc/lanes.cu`` holds the seven lane kernels for Hopper (``sm_90a``) and the
threefry launcher behind a plain C interface.  At first use on the card it is compiled with ``nvcc`` into
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

The threefry draws run as a device function inside kernel A; the
``rand_u32`` wrapper launches the same function on its own, so that it can
be held against the plain version and timed.
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

from ..core import rng as rng_mod
from . import lanes

_SRC = Path(__file__).resolve().parents[1] / "csrc" / "lanes.cu"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "shadow_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# the merge kernel keeps its row in static-limit shared memory
MERGE_SMEM_LIMIT = 48 * 1024

# LaneBufs (csrc/lanes.cu): every pointer field, in this order, then the
# sizes.  ``stream`` points at the flows ([2, S, F]); on a tiered run
# ``tier_q`` and ``tier_v`` at the TierState's queues and vectors.
_PTR_FIELDS = (
    lanes.LaneState._fields + lanes.LaneTables._fields
    + lanes.Workspace._fields + ("tier_q", "tier_v")
)
_INT_FIELDS = ("n", "c", "k", "cx", "sw", "g", "log_cap", "stop", "runahead",
               "interval", "seed_lo", "seed_hi", "bootstrap_end", "has_loss",
               "all_passive", "dyn_runahead", "runahead_floor", "words",
               "s_flows", "wide_pop", "one_to_one", "n_x", "rec_slots",
               "rec_srec", "rec_brec", "n_rec", "tier_s", "ks", "c2",
               "tier_wide", "tier_n", "rec_tier")


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
    for name in ("lane_slots", "exchange_merge", "stream_rows_merge",
                 "stream_tier", "tier_merge", "append_log"):
        fn = getattr(lib, name)
        fn.argtypes = [vp, vp]
        fn.restype = ctypes.c_int
    lib.queue_min_window.argtypes = [vp, ctypes.c_int, vp]
    lib.queue_min_window.restype = ctypes.c_int
    u32 = ctypes.c_uint32
    lib.rand_u32.argtypes = [u32, u32, vp, vp, vp, ctypes.c_int64, vp]
    lib.rand_u32.restype = ctypes.c_int
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
    with their device pointers packed into the ``LaneBufs`` block.  The
    [N] lanes' sizes are those of ``p.lane`` (on a tiered run, the lanes
    without the stream models); the tier's are ``tier_s`` (S, 0 when not
    tiered), ``ks``, ``c2``, ``tier_n`` (the tier block's width) and
    ``rec_tier`` (where its record groups start)."""

    def __init__(self, p: lanes.LaneParams, tb: lanes.LaneTables,
                 s: lanes.LaneState, ws: lanes.Workspace) -> None:
        self.p, self.tb, self.s, self.ws = p, tb, s, ws
        pl = p.lane
        dev = s.q_thi.device
        n, c, k, cx = p.n_lanes, p.capacity, p.pops_per_iter, p.cross_cap
        g = int(tb.lat.shape[0])
        i32, i64 = torch.int32, torch.int64
        n_rec = p.n_records if p.log_capacity else 1
        sp, sf = p.stream_present, p.s_flows
        tiered = p.stream_tiered
        n_ep = 2 * sf if sp else 2
        tier_n = p.tier_layout[-1]
        shapes = {
            **{f: (n, c) for f in ("q_thi", "q_tlo", "q_auxh", "q_auxl",
                                   "q_size")},
            **{f: (n, c) if pl.stream_present else (0,)
               for f in ("q_phi", "q_plo")},
            "stream": (2, sf, lanes.lstr.N_COLS) if sp else (0,),
            "tier_q": (7, 2 * sf, p.stream_capacity) if tiered else (0,),
            "tier_v": (lanes.lstr.TV_COUNT, 2 * sf) if tiered else (0,),
            **{f: (n,) for f in lanes._SLOT_FIELDS + ("n_queue",)},
            **{f: () for f in ("log_count", "log_lost", "rounds", "iters",
                               "now_we_hi", "now_we_lo", "min_used_lat")},
            "log": (max(p.log_capacity, 1), 6),
            **{f: (n,) for f in lanes.LaneTables._fields},
            **{f: (n_ep,) for f in lanes.LaneTables._fields
               if f.startswith("flow_")},
            **{f: (2 * sf,) if tiered else (0,)
               for f in ("flow_dn_rate", "flow_dn_burst", "flow_dn_kfull",
                         "flow_dn_kfi")},
            "lane_stream": (n,) if tiered else (0,),
            "lane_ep_start": (n + 1,), "lane_ep_rows": (n_ep,),
            "lat": (g, g), "thresh": (g, g), "codel_div": (1025,),
            "ctl": (4,), "self_blk": (pl.words, n, pl.self_width),
            "out_blk": (6, k, n), "sx_blk": (8, max(pl.stream_entries, 1)),
            "recs": (n_rec, 6), "rec_valid": (n_rec,),
            "x_cnt": (n,), "x_start": (n,), "x_fill": (n,),
            "x_order": (pl.exchange_entries,),
            "tier_blk": (7, max(tier_n, 1)),
        }
        dtypes = {"cd_dropping": torch.bool, "log": i64, "recs": i64,
                  "thresh": i64, "flow_thresh": i64,
                  "lane_stream": torch.bool}
        tensors = {**s._asdict(), **tb._asdict(), **ws._asdict()}
        if tiered:
            tensors["stream"] = s.stream.flows
            tensors["tier_q"], tensors["tier_v"] = s.stream.q, s.stream.v
        else:
            # a tiered run's fields, unused: empty
            tensors["tier_q"] = tensors["tier_v"] = torch.zeros(
                0, dtype=i32, device=dev)
        for f in _PTR_FIELDS:
            _check(f, tensors[f], dev, dtypes.get(f, i32), shapes[f])
        self.on_cuda = dev.type == "cuda"
        if self.on_cuda:
            # the merges keep their rows in shared memory: entries, words
            # an entry, extra bytes
            rows = {"merge": (pl.merge_width, pl.words, 4 * cx)}
            if p.split:
                rows["stream merge"] = (c + p.stream_row_width, 7, 0)
            if tiered:
                rows["tier merge"] = (p.stream_capacity + p.tier_width, 7, 0)
            for what, (width, words, extra) in rows.items():
                smem = 4 * words * width + extra
                if smem > MERGE_SMEM_LIMIT:
                    raise ValueError(
                        f"{what} row of {width} entries needs {smem} B of "
                        f"shared memory (limit {MERGE_SMEM_LIMIT}); lower "
                        "the queue or cross capacity"
                    )
            _lib()  # build and load before the run starts
        seed_lo, seed_hi = rng_mod.split_seed(p.seed)
        _tail, rec_slots, rec_srec, rec_brec, rec_end = p.rec_offsets
        self.bufs = LaneBufs(
            **{f: tensors[f].data_ptr() for f in _PTR_FIELDS},
            n=n, c=c, k=k, cx=cx, sw=pl.self_width, g=g,
            log_cap=p.log_capacity, stop=p.stop_time, runahead=p.runahead,
            interval=p.bucket_interval, seed_lo=seed_lo, seed_hi=seed_hi,
            bootstrap_end=p.bootstrap_end, has_loss=int(p.has_loss),
            all_passive=int(pl.all_passive),
            dyn_runahead=int(p.dynamic_runahead),
            runahead_floor=max(p.runahead_floor, 1), words=pl.words,
            s_flows=pl.s_flows,
            wide_pop=int(pl.stream_present and p.stream_wide_pop),
            one_to_one=int(p.stream_one_to_one), n_x=pl.exchange_entries,
            rec_slots=rec_slots, rec_srec=rec_srec, rec_brec=rec_brec,
            n_rec=rec_end, tier_s=sf if tiered else 0, ks=p.stream_pops,
            c2=p.stream_capacity, tier_wide=int(p.stream_wide_pop),
            tier_n=tier_n, rec_tier=p.tier_rec_offsets[0],
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
    """Kernel A: pop under the co-pop rule, the slot law, emit blocks.

    Replaces ``shadow_tpu/backend/lanes.py:2900`` ``_build_iter.iter_body``
    (pop, with the stream co-pop rule) and ``lanes.py:884`` ``_process_slot``
    — the passive arm with ``bucket_charge_vec`` (``:477``) and
    ``codel_offer_arrays`` (``:596``), the active arms (DELIVERY inserts,
    phold, ping, the loss draw over ``core/rng.py:46`` ``threefry2x32``,
    ``min_used_lat``) and the stream arm (``:1013-1085``, ``:1197-1400``,
    ``bucket_charge_chained_vec`` ``:549``) with the lane-TCP law of
    ``backend/lanes_stream.py`` (``open_flow_vec`` ``:549``, ``on_rto_vec``
    ``:566``, ``on_segment_vec`` ``:604``, ``pump_epilogue_vec`` ``:462``
    and their helpers) as ``__device__`` functions.  Bound on the card by
    bytes: each lane reads its K head slots, ~35 state words and its table
    row, and writes them back with the emit blocks — no reuse, so one
    thread per lane keeps the whole K-slot walk in registers and touches
    each word once.  The thread also owns its lane's flow endpoint rows (a
    lane -> rows table): at most one is stimulated per slot, so that row's
    33 words live in registers for the slot and no atomics are needed; the
    stream block's entries go to fixed positions.  The threefry draw (about
    80 integer operations) is computed in registers where it is needed,
    never stored.  One kernel serves passive, active and stream runs: a
    passive-only variant saved nothing measurable end to end (PERF.md)."""
    if not args.on_cuda:
        return lanes.lane_slots_plain(args.p, args.tb, args.s, args.ws)
    _launch("lane_slots", args)
    lane_slots.launches += 1


def exchange_merge(args: LaneArgs) -> None:
    """Kernel B: cross-lane exchange and keyed row merge.

    Replaces ``shadow_tpu/backend/lanes.py:1581`` ``_merge_append`` (with
    ``_window_gather``, ``:1539``, and the star's stream entries,
    ``:1658-1735``) and ``:763`` ``_sort_queues``.  Bound by bytes: the
    ``[N, C]`` queue words are read and written once, plus the K*N
    outbound entries and, in star stream configs, the stream block.  The
    TPU's sort-by-destination and barrel-shift gather become a counting
    sort (atomic counts, one-block scan, atomic placement), and the row
    sort a rank merge of the whole ``[C | K or 2K | Cx]`` row in one
    block's shared memory (5 words an entry, 7 with the stream payload), so
    the row is read from device memory once.  The chain of dependent
    launches and the one-block scan keep it well above its bound
    (PERF.md).  On a tiered run the merge block of a stream-endpoint lane
    also copies its cross entries to the tier block, where kernel G reads
    them, and gives them the NEVER time in the lane's own merge (the
    divert, ``lanes.py:1818-1835``)."""
    if not args.on_cuda:
        return lanes.exchange_merge_plain(args.p, args.tb, args.s, args.ws)
    _launch("exchange_merge", args)
    exchange_merge.launches += 1


def stream_rows_merge(args: LaneArgs) -> None:
    """Kernel E: the split stream exchange of one-to-one stream configs.

    Replaces ``shadow_tpu/backend/lanes.py:1924`` ``_merge_stream_rows``.
    One block per endpoint row builds its ``[C + W_s]`` row — its lane's
    queue row and the ``W_s = 2K + K*B`` stream entries that the static
    layout sends it — and merges it with B's keyed-merge device function,
    so the row is read from device memory once and written once.  Bound by
    bytes: 2S queue rows and the stream block."""
    if not args.on_cuda:
        return lanes.stream_rows_merge_plain(args.p, args.tb, args.s, args.ws)
    _launch("stream_rows_merge", args)
    stream_rows_merge.launches += 1


def stream_tier(args: LaneArgs) -> None:
    """Kernel F: the tier's pop and slot walk.

    Replaces ``shadow_tpu/backend/lanes.py:2300`` ``_stream_tier_iter`` up
    to its merge (``:2328-2680``), on the state of
    ``shadow_tpu/backend/lanes_stream.py:907`` ``TierState``.  One thread
    per endpoint row owns the row's flow, its tier vector column and its
    queue head, and walks its K_s popped columns in order in registers:
    the pop-prefix rule, the down bucket and CoDel, the delivery-elision
    gate, the lane-TCP law of kernel A (``__device__``), the control send
    with its loss draw, the RTO arm and, on client rows, the burst chain.
    It writes every candidate entry of its row (empty ones canonical) and,
    when logging, every record slot of its row.  It never touches the
    peer row: the merge, which reads the peer's control sends, is G.
    Bound by bytes (the popped columns, the flow rows, the tier vectors and
    the candidate block written once), but its time is the longest row's
    serial walk: 2S threads of up to K_s law steps and K_s*B burst units
    each (PERF.md)."""
    if not args.on_cuda:
        return lanes.stream_tier_plain(args.p, args.tb, args.s, args.ws)
    _launch("stream_tier", args)
    stream_tier.launches += 1


def tier_merge(args: LaneArgs) -> None:
    """Kernel G: the tier merge.

    Replaces ``shadow_tpu/backend/lanes.py:2682-2786`` (the merge and the
    overflow records of ``_stream_tier_iter``).  One block per endpoint
    row gathers its ``C2 + W_t`` entries (queue, DELIVERY fallbacks, RTO
    arms, the peer's control sends, the client's bursts, the diverted
    cross entries), compacts the valid ones into shared memory with a
    block prefix sum in index order, ranks only those by (key, index), and
    writes the first C2 with canonical empties after them; the rest are
    counted into ``TV_N_QUEUE`` and recorded as DROP_QUEUE.  Most of a
    row's candidates are empty (a client row's burst block always), so
    ranking only the valid ones keeps the compares far below a rank of the
    whole row.  Bound by bytes: the queue rows and the candidate block
    read once, the rows written once."""
    if not args.on_cuda:
        return lanes.tier_merge_plain(args.p, args.tb, args.s, args.ws)
    _launch("tier_merge", args)
    tier_merge.launches += 1


def queue_min_window(args: LaneArgs, advance: bool) -> None:
    """Kernel C: earliest head, window law, ``live`` flag.

    Replaces ``shadow_tpu/backend/lanes.py:2260`` ``_queue_min`` with
    ``lanes_pairs.py:28`` ``pair_min_lanes`` and the window law of
    ``_build_round`` /
    ``_build_full_run`` (``lanes.py:3346-3356``, ``:3505-3526``).  Its bytes
    (N head pairs, 80 KB at 10k lanes) bound it at tens of nanoseconds, so
    launch and one block's latency set its time.  One block reduces and
    applies the window law, so the flag stays on the device and the host
    reads it only when it chooses to.  On a tiered run the heads of the
    tier's endpoint rows count too (``lanes.py:2264-2270``)."""
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


def rand_u32(seed: int, stream: torch.Tensor,
             counter: torch.Tensor) -> torch.Tensor:
    """Threefry-2x32 draws under the master ``seed``: ``stream`` and
    ``counter`` are ``[M]`` int32 tensors of 32-bit words (bit patterns, as
    the lane state holds them), and the result ``[M]`` int32 holds the bits
    of each draw's first output word (the lane engine's draw, counter word
    ``c1 = 0``).

    Replaces ``shadow_tpu/core/rng.py:46`` ``threefry2x32`` with
    ``backend/lanes.py:672`` ``rand_u32_lane`` and ``:695``
    ``_seed_keys``, as the device function kernel A calls; this launcher
    runs it alone, one thread per draw, so it can be held against the plain
    version bit for bit.  Bound by operations: 80 32-bit integer
    operations per draw against 12 bytes moved (two words in, one out)."""
    if (stream.dim() != 1 or stream.shape != counter.shape
            or stream.dtype != torch.int32 or counter.dtype != torch.int32
            or stream.device != counter.device):
        raise ValueError(
            f"rand_u32: expected two [M] int32 tensors on one device, got "
            f"{tuple(stream.shape)} {stream.dtype} {stream.device} and "
            f"{tuple(counter.shape)} {counter.dtype} {counter.device}")
    seed_lo, seed_hi = rng_mod.split_seed(seed)
    if stream.device.type != "cuda":
        return rng_mod.as_i32(
            rng_mod.rand_u32_words(seed_lo, seed_hi, stream, counter))
    stream, counter = stream.contiguous(), counter.contiguous()
    out = torch.empty_like(stream)
    lib = _lib()
    cuda_stream = torch.cuda.current_stream(stream.device).cuda_stream
    err = lib.rand_u32(seed_lo, seed_hi, stream.data_ptr(),
                       counter.data_ptr(), out.data_ptr(), stream.numel(),
                       cuda_stream)
    if err != 0:
        raise RuntimeError(f"rand_u32: CUDA error {err}: "
                           f"{lib.lanes_error_string(err).decode()}")
    rand_u32.launches += 1
    return out


WRAPPERS = (lane_slots, exchange_merge, stream_rows_merge, stream_tier,
            tier_merge, queue_min_window, append_log, rand_u32)


def reset_launches() -> None:
    for fn in WRAPPERS:
        fn.launches = 0


reset_launches()
