"""The lane engine's CUDA kernels: build, binding and wrappers.

``csrc/lanes.cu`` holds the eight lane kernels for Hopper (``sm_90a``) —
A to G and the hybrid backend's H, with C's hybrid and fused modes beside
its plain one — the threefry launcher and the shared-memory query behind
a plain C interface.  At first use on the card it is compiled with
``nvcc`` into ``build/shadow_tpu_torch/`` at the root of the checkout,
keyed by a hash of the source, and loaded with ``ctypes``.  Nothing is
built or loaded when this module is imported.

Each wrapper takes a :class:`LaneArgs` — one run's state, tables and
workspace, checked once (device, dtype, shape, contiguity) when it is
built, since the kernels update that state in place and the pointers never
change during a run — or a :class:`SweepArgs`, the S scenarios of a sweep.
Either way it makes ONE launch of each of its kernels, with a scenario
coordinate in the grid: a serial run is a sweep of one.  On CPU tensors a
wrapper runs its kernel's plain version from ``lanes.py``, scenario by
scenario (each plain version skips a scenario that is not live); on CUDA
tensors it launches the kernel on PyTorch's current stream and raises if
the launch fails.  There is no fallback from one to the other.  Each
wrapper counts its launches in its ``launches`` attribute (plain runs
count nothing).

The threefry draws run as a device function inside kernel A; the
``rand_u32`` wrapper launches the same function on its own, so that it can
be held against the plain version and timed.
"""

from __future__ import annotations

import ctypes
import dataclasses
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
               "tier_wide", "tier_n", "rec_tier", "netobs", "pcap",
               "stream_pcap", "tier_pcap", "rec_pc", "rec_spc", "rec_bpc",
               "rec_tspc", "rec_tbpc", "rec_ttail", "flowtrace", "ft_cap",
               "ft_thresh", "ft_all", "ft_seed", "fl_split", "fl_slots",
               "fl_ss", "fl_bs", "n_fl", "merge_global", "split_global",
               "tier_global", "ext_any", "eg_cap", "room_floor", "n_eg",
               "inj_b", "cxi", "inject_global", "k_cap", "ext_slots",
               "merge_warp", "c_blocks", "slot_group")


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
    vp, c_int = ctypes.c_void_p, ctypes.c_int
    # (host array, device array, scenarios[, advance], stream)
    for name in ("lane_slots", "exchange_merge", "stream_rows_merge",
                 "stream_tier", "tier_merge", "append_log"):
        fn = getattr(lib, name)
        fn.argtypes = [vp, vp, c_int, vp]
        fn.restype = ctypes.c_int
    lib.queue_min_window.argtypes = [vp, vp, c_int, c_int, vp]
    lib.queue_min_window.restype = ctypes.c_int
    # (host array, device array, scenarios, first, ext_hi, ext_lo,
    # ext_used, stream)
    lib.hybrid_window.argtypes = [vp, vp, c_int, c_int, c_int, c_int, c_int,
                                  vp]
    lib.hybrid_window.restype = ctypes.c_int
    # (host array, device array, scenarios, first, k_eff, ext_used, stream)
    lib.hybrid_fused_window.argtypes = [vp, vp, c_int, c_int, c_int, c_int,
                                        vp]
    lib.hybrid_fused_window.restype = ctypes.c_int
    # (host array, device array, scenarios, injection block, stream)
    lib.inject_merge.argtypes = [vp, vp, c_int, vp, vp]
    lib.inject_merge.restype = ctypes.c_int
    lib.smem_optin.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    lib.smem_optin.restype = ctypes.c_int
    u32 = ctypes.c_uint32
    lib.rand_u32.argtypes = [u32, u32, vp, vp, vp, ctypes.c_int64, vp]
    lib.rand_u32.restype = ctypes.c_int
    lib.lanes_error_string.argtypes = [ctypes.c_int]
    lib.lanes_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _smem_optin(index: int) -> int:
    lib = _lib()
    out = ctypes.c_int(0)
    err = lib.smem_optin(index, ctypes.byref(out))
    if err != 0:
        raise RuntimeError(f"smem_optin: CUDA error {err}: "
                           f"{lib.lanes_error_string(err).decode()}")
    return out.value


def smem_optin(device) -> int:
    """The card's ``sharedMemPerBlockOptin`` (bytes): the most dynamic
    shared memory a block may opt in to (227 KB on an H100), read once."""
    dev = torch.device(device)
    return _smem_optin(dev.index if dev.index is not None
                       else torch.cuda.current_device())


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
    ``rec_tier`` (where its record groups start).  The observation planes
    are flags: ``netobs`` (the ``nb_*`` counters), ``pcap`` (the lanes'
    PCAP_TX records), ``stream_pcap`` and ``tier_pcap`` (the stream
    endpoints' captures, on the [N] lanes or on the tier), beside their
    record groups' starts; ``flowtrace`` (the flow records, at the flow
    groups' starts ``fl_*``, and the ring), with the sampling law's
    ``ft_thresh``, ``ft_all`` and ``ft_seed`` (mod 2**32, all the hash
    reads of it).  The hybrid backend's sizes: ``ext_any``, the egress
    buffer's ``eg_cap`` rows and the ``room_floor`` a turn stops at, A's
    ``n_eg`` egress candidates, the injection block's ``inj_b`` rows and
    the ``cxi`` a lane takes from one.  On the card each merge takes the path
    ``lanes.merge_in_shared`` gives its rows at the device's opt-in limit:
    ``*_global`` marks the merges that run in ``m_scratch``; ``merge_warp``
    B's narrow form (``lanes.merge_in_warp``); ``c_blocks`` the blocks of
    kernel C's cluster (``lanes.heads_blocks``); ``slot_group`` kernel A's
    threads a lane (``lanes.slot_group``)."""

    def __init__(self, p: lanes.LaneParams, tb: lanes.LaneTables,
                 s: lanes.LaneState, ws: lanes.Workspace) -> None:
        self.p, self.tb, self.s, self.ws = p, tb, s, ws
        pl = p.lane
        dev = self.device = s.q_thi.device
        n, c, k, cx = p.n_lanes, p.capacity, p.pops_per_iter, p.cross_cap
        g = int(tb.lat.shape[0])
        i32, i64 = torch.int32, torch.int64
        n_rec = p.n_records if p.log_capacity else 1
        n_fl = p.flow_offsets.end if p.flowtrace else 1
        sp, sf = p.stream_present, p.s_flows
        tiered = p.stream_tiered
        n_ep = 2 * sf if sp else 2
        tier_n = p.tier_layout[-1]
        nb = p.netobs
        ext = p.external_any
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
            **{f: (n,) if nb else (0,)
               for f in ("nb_txb", "nb_rxb", "nb_thr", "nb_shed")},
            "nb_hist": (lanes.NB_HIST_BUCKETS,) if nb else (0,),
            "nb_win": () if nb else (0,),
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
            "tier_blk": (7, max(tier_n, 1)),
            "fl_buf": (p.flow_capacity, lanes.ftr.FT_COLS) if p.flowtrace
            else (0,),
            **{f: () if p.flowtrace else (0,)
               for f in ("fl_count", "fl_lost")},
            "fl_recs": (n_fl, lanes.FLOW_REC_WORDS), "fl_valid": (n_fl,),
            "x_order": (pl.exchange_entries,),
            "x_done": (1,),
            # the hybrid backend's egress (empty [0] int32 off it)
            "egress": (p.egress_capacity, 6) if ext else (0,),
            **{f: () if ext else (0,)
               for f in ("egress_count", "egress_lost", "egress_min_hi",
                         "egress_min_lo")},
            "lane_external": (n,) if ext else (0,),
            "eg_recs": (max(p.egress_slots, 1), 6),
            "eg_valid": (max(p.egress_slots, 1),), "hyb": (p.hyb_words,),
            "ext": (max(p.ext_slots, 1),), "fz": (3,),
        }
        dtypes = {"cd_dropping": torch.bool, "log": i64, "recs": i64,
                  "thresh": i64, "flow_thresh": i64,
                  "lane_stream": torch.bool, "lane_pcap": torch.bool,
                  "flow_pcap": torch.bool, "eg_recs": i64, "hyb": i64,
                  "ext": i64}
        if ext:
            dtypes.update(egress=i64, lane_external=torch.bool)
        tensors = {**s._asdict(), **tb._asdict(), **ws._asdict()}
        if tiered:
            tensors["stream"] = s.stream.flows
            tensors["tier_q"], tensors["tier_v"] = s.stream.q, s.stream.v
        else:
            # a tiered run's fields, unused: empty
            tensors["tier_q"] = tensors["tier_v"] = torch.zeros(
                0, dtype=i32, device=dev)
        self.on_cuda = dev.type == "cuda"
        # each merge's path: shared memory, or rows in m_scratch (the size
        # rule, decided here once for the run)
        in_global = {}
        shapes["m_scratch"] = (0,)
        if self.on_cuda:
            optin = smem_optin(dev)  # builds and loads the library
            in_global = {what: not lanes.merge_in_shared(e, w, x, optin)
                         for what, (_r, e, w, x)
                         in lanes.merge_rows(p).items()}
            shapes["m_scratch"] = (lanes.merge_scratch_words(p, optin),)
        for f in _PTR_FIELDS:
            _check(f, tensors[f], dev, dtypes.get(f, i32), shapes[f])
        if self.on_cuda:
            # kernel D copies a log or egress row as three 16-byte pieces, a
            # ring row as five 8-byte ones
            for f, align in (("recs", 16), ("log", 16), ("eg_recs", 16),
                             ("egress", 16), ("fl_recs", 8), ("fl_buf", 8)):
                if tensors[f].data_ptr() % align:
                    raise ValueError(f"{f}: not {align}-byte aligned")
        seed_lo, seed_hi = rng_mod.split_seed(p.seed)
        rg, tg, fg = p.rec_offsets, p.tier_rec_offsets, p.flow_offsets
        logging = bool(p.log_capacity)
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
            rec_slots=rg.slots, rec_srec=rg.srec, rec_brec=rg.brec,
            n_rec=rg.end, tier_s=sf if tiered else 0, ks=p.stream_pops,
            c2=p.stream_capacity, tier_wide=int(p.stream_wide_pop),
            tier_n=tier_n, rec_tier=tg.rec, netobs=int(nb),
            pcap=int(logging and p.pcap_any),
            stream_pcap=int(logging and pl.stream_present and pl.stream_pcap),
            tier_pcap=int(logging and tiered and p.stream_pcap),
            rec_pc=rg.pc, rec_spc=rg.spc, rec_bpc=rg.bpc, rec_tspc=tg.spc,
            rec_tbpc=tg.bpc, rec_ttail=tg.tail, flowtrace=int(p.flowtrace),
            ft_cap=p.flow_capacity, ft_thresh=p.flow_thresh,
            ft_all=int(p.flow_all), ft_seed=p.flow_seed & 0xFFFFFFFF,
            fl_split=fg.split, fl_slots=fg.slots, fl_ss=fg.ss, fl_bs=fg.bs,
            n_fl=fg.end if p.flowtrace else 0,
            merge_global=int(in_global.get("merge", False)),
            split_global=int(in_global.get("stream merge", False)),
            tier_global=int(in_global.get("tier merge", False)),
            ext_any=int(ext), eg_cap=p.egress_capacity,
            room_floor=p.egress_capacity - p.ext_per_iter,
            n_eg=p.egress_slots, inj_b=p.inject_batch, cxi=p.inject_cap,
            inject_global=int(in_global.get("inject merge", False)),
            k_cap=p.hybrid_k_cap, ext_slots=p.ext_slots,
            merge_warp=int(lanes.merge_in_warp(pl.merge_width)),
            c_blocks=lanes.heads_blocks(n + (2 * sf if tiered else 0)),
            slot_group=lanes.slot_group(k),
        )

    @functools.cached_property
    def batch(self) -> "SweepArgs":
        """This run as a sweep of one scenario: what the wrappers launch."""
        return SweepArgs([self])


# the LaneBufs sizes a launch takes its shape from (scenario 0's); equal
# across the scenarios of a sweep by congruence, checked here
_LAUNCH_FIELDS = ("n", "c", "k", "cx", "sw", "words", "n_x", "s_flows",
                  "tier_s", "ks", "c2", "flowtrace", "merge_global",
                  "split_global", "tier_global", "ext_any", "n_eg", "inj_b",
                  "cxi", "inject_global", "merge_warp", "c_blocks",
                  "slot_group")


class SweepArgs:
    """The S scenarios of one batched launch: S :class:`LaneArgs`, each
    over its own state, tables and workspace, whose ``LaneBufs`` blocks go
    to the card as one ``[S]`` array (``host``, and ``dev`` in device
    memory; at S = 1 the launcher passes ``host[0]`` as the kernels'
    parameter instead).  Their launch shapes must be equal, and their exchange
    scratch (``x_cnt``, ``x_fill``) rows of one ``[S, N]`` block each
    (``lanes.make_workspaces``), zero between calls: B's merges zero each
    lane's words once they have read them (H does not touch them).
    :meth:`retarget` swaps tables and stop times between run segments and
    uploads the array again; the tables it replaces stay referenced here
    until the batch is dropped, so no queued launch reads freed memory."""

    def __init__(self, members) -> None:
        self.members = list(members)
        if not self.members:
            raise ValueError("a sweep needs at least one scenario")
        first = self.members[0]
        self.on_cuda, self.device = first.on_cuda, first.device
        n = first.p.n_lanes
        for i, m in enumerate(self.members[1:], start=1):
            if m.device != self.device:
                raise ValueError(f"scenario {i}: on {m.device}, scenario 0 "
                                 f"on {self.device}")
            shape = [(f, getattr(m.bufs, f), getattr(first.bufs, f))
                     for f in _LAUNCH_FIELDS]
            shape.append(("logging", m.bufs.log_cap > 0,
                          first.bufs.log_cap > 0))
            for f, a, b in shape:
                if a != b:
                    raise ValueError(f"scenario {i}: launch shape {f}={a}, "
                                     f"scenario 0 has {b}")
            for f in ("x_cnt", "x_fill"):
                at = getattr(first.ws, f).data_ptr() + 4 * n * i
                if getattr(m.ws, f).data_ptr() != at:
                    raise ValueError(f"scenario {i}: {f} is not row {i} of "
                                     "the batch's [S, N] block")
        self._retired: list = []
        self._pack()

    @property
    def size(self) -> int:
        return len(self.members)

    def _pack(self) -> None:
        self.host = (LaneBufs * self.size)(*(m.bufs for m in self.members))
        self.dev = None
        if self.on_cuda:  # H2D on the current stream, ordered after
            # every launch already queued
            self.dev = torch.frombuffer(bytearray(self.host),
                                        dtype=torch.uint8).to(self.device)

    def retarget(self, tables, stops) -> None:
        """Give scenario i the tables ``tables[i]`` and the stop time
        ``stops[i]`` (a fault segment's), and upload the array again."""
        self._retired.append(self.members)
        self.members = [
            LaneArgs(dataclasses.replace(m.p, stop_time=int(stop)), tb,
                     m.s, m.ws)
            for m, tb, stop in zip(self.members, tables, stops)]
        self._pack()


def _launch(name: str, args, plain, *extra) -> bool:
    """One launch of ``name`` over every scenario of ``args`` (a LaneArgs
    or a SweepArgs); on the CPU, ``plain(member)`` scenario by scenario.
    Returns whether the kernel was launched."""
    batch = args if isinstance(args, SweepArgs) else args.batch
    if not batch.on_cuda:
        for m in batch.members:
            plain(m)
        return False
    lib = _lib()
    stream = torch.cuda.current_stream(batch.device).cuda_stream
    err = getattr(lib, name)(ctypes.addressof(batch.host),
                             batch.dev.data_ptr(), batch.size, *extra, stream)
    if err != 0:
        raise RuntimeError(
            f"{name}: CUDA error {err}: "
            f"{lib.lanes_error_string(err).decode()}"
        )
    return True


def lane_slots(args) -> None:
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
    row, and writes them back with the emit blocks.  Its time was the
    serial chain of dependent loads and draws one thread ran K times over,
    so the walk decides first, then walks: a lane takes a group of
    ``lanes.slot_group(K)`` threads of one warp (about K / 2, each taking
    every L-th column), 128 threads a block (the lanes spread over every
    SM).  Each thread loads the lane's state and its columns at once,
    decides from the group's ballots whether each column acts, whether it
    sends, to whom and at which send and re-arm sequence numbers
    (exclusive prefix counts), and issues the gathers (``node_of``,
    ``lat``, ``thresh``) and the threefry draws of every column together;
    only the two buckets and CoDel chain from column to column, walked by
    the group in lockstep on shuffled values before each thread writes its
    columns' emits.  A lane that owns flow
    endpoint rows (untiered streams) takes a warp of its own, in blocks
    after the groups' (one warp per endpoint row, the walk on a lane's
    first row: no table beyond ``lane_ep_start``/``lane_ep_rows``): the
    warp walks every column in lockstep with the stream arm, whose loss
    draws are made a warp lane each beforehand and whose burst unit u —
    its entry or the canonical empty, its loss record, capture row and
    flow flags — warp lane u writes.  The stream arm is compiled only into
    the instance for runs with streams.  With flowtrace
    (``lanes.py:1470-1501`` and the group build of ``iter_body``,
    ``:3195-3318``) each column's thread also writes the flags of its seven
    [N] flow groups and the records of the sampled flows (``flow_hash``,
    ``:2086``, in registers): stores to fixed slots."""
    if _launch("lane_slots", args,
               lambda m: lanes.lane_slots_plain(m.p, m.tb, m.s, m.ws)):
        lane_slots.launches += 1


def exchange_merge(args) -> None:
    """Kernel B: cross-lane exchange and keyed row merge.

    Replaces ``shadow_tpu/backend/lanes.py:1581`` ``_merge_append`` (with
    ``_window_gather``, ``:1539``, and the star's stream entries,
    ``:1658-1735``) and ``:763`` ``_sort_queues``.  Bound by bytes: the
    ``[N, C]`` queue words are read and written once, plus the K*N
    outbound entries and, in star stream configs, the stream block.  The
    TPU's sort-by-destination and barrel-shift gather become a counting
    sort: atomic counts, whose kernel's last block to finish (a ticket)
    scans them, its thread sums and warp sums by shuffles (two barriers a
    tile of 12,288 lanes), then atomic placement.  The merge then sorts
    each lane's group by index and keeps the first Cx (the plain
    version's stable order), and sorts the whole ``[C | K or 2K | Cx]``
    row by (key, index) with a bitonic network (5 words an entry, 7 with
    the stream payload), so the row is read from device memory once.  Its form is fixed before the run
    (``lanes.merge_in_warp``): a row of at most 32 entries (the flagship's
    and the tiered mesh's 26) is merged by one warp in its registers,
    eight lanes a block, with no shared memory and no barrier; a wider one
    by a block over an index array in shared memory, its runs of 32
    sorted in registers and merged pairwise by binary search.  Each merge zeroes its lane's counts for the next call, so
    B issues three kernels and no memset.  On a tiered run the merge of a
    stream-endpoint lane also copies its cross entries to the tier block,
    where kernel G reads them, and gives them the NEVER time in the lane's
    own merge (the divert, ``lanes.py:1818-1835``).  With flowtrace each
    tail slot gets a flow flag, and the PACKETs of sampled flows shed there
    an FT_DROP (CAUSE_QUEUE) record (``:1873-1891``).  A wide row past the
    device's opt-in shared memory sorts in the workspace's
    ``m_scratch``."""
    if _launch("exchange_merge", args,
               lambda m: lanes.exchange_merge_plain(m.p, m.tb, m.s, m.ws)):
        exchange_merge.launches += 1


def stream_rows_merge(args) -> None:
    """Kernel E: the split stream exchange of one-to-one stream configs.

    Replaces ``shadow_tpu/backend/lanes.py:1924`` ``_merge_stream_rows``.
    A warp per endpoint row merges its lane's queue row (one sorted run,
    checked; else runs of 32) with the ``W_s = 2K + K*B`` stream entries
    that the static layout sends it: the canonical empties among them are
    counted, not sorted, the rest sorted in runs of 32, and each entry
    ranked by binary searches of the other runs, so the row is read from
    device memory once and only its moved entries written back; with
    flowtrace the FT_DROP records of its tail (``:2024-2036``).  Bound by
    bytes: 2S queue rows and the stream block."""
    if _launch("stream_rows_merge", args,
               lambda m: lanes.stream_rows_merge_plain(m.p, m.tb, m.s, m.ws)):
        stream_rows_merge.launches += 1


def stream_tier(args) -> None:
    """Kernel F: the tier's pop and slot walk.

    Replaces ``shadow_tpu/backend/lanes.py:2300`` ``_stream_tier_iter`` up
    to its merge (``:2328-2680``), on the state of
    ``shadow_tpu/backend/lanes_stream.py:907`` ``TierState``, in two
    launches.  A fill writes the canonical empty entry to every candidate
    slot and, when logging, every tier record slot the walk may write, with
    the whole card, coalesced.  Then one warp per endpoint row (one thread
    where a launch walks more than 264 rows over its scenarios, two warps
    an SM: a sweep's) owns the row's flow, its tier vector column and its queue
    head, a warp's lanes in lockstep on the same values (lane j loads
    column j; shuffles broadcast each), and walks the popped prefix of its
    K_s columns in order: the
    pop-prefix rule, the down bucket and CoDel, the delivery-elision gate,
    the lane-TCP law of kernel A (``__device__``), the control send with
    its loss draw, the RTO arm and, on client rows, the burst chain.  The
    walk stops where the popped prefix ends (an unpopped column changes no
    state and writes only empties); in a warp the 32 loss draws of a
    stimulus run one a lane before the law and lane u writes burst unit u.
    Only valid entries and records are written.  It never touches the peer row: the
    merge, which reads the peer's control sends, is G.  Bound by bytes (the
    popped columns, the flow rows, the tier vectors and the candidate block
    written once); its time is the fill's stores and the longest row's
    serial law (PERF.md)."""
    if _launch("stream_tier", args,
               lambda m: lanes.stream_tier_plain(m.p, m.tb, m.s, m.ws)):
        stream_tier.launches += 1


def tier_merge(args) -> None:
    """Kernel G: the tier merge.

    Replaces ``shadow_tpu/backend/lanes.py:2682-2786`` (the merge and the
    overflow records of ``_stream_tier_iter``).  A warp per endpoint row
    (a block each): it flags its row's ``C2 + W_t`` entries valid 32 at a
    time by ballots (every time word loaded before the ballots), gathers
    only the valid ones in index order, and ranks each by (key, index) as
    a merge of sorted runs — the queue's valid entries, one run in key
    order already (checked), and the candidates in runs of 32 sorted in
    registers — its place in its run plus a binary search of every other
    run.  The first C2 go to the row with canonical empties after them;
    the rest are counted into ``TV_N_QUEUE`` and recorded as DROP_QUEUE.
    No barrier and no all-pairs rank.  Bound by bytes: the queue rows and
    the candidate block read once, the rows written once; a row past the
    opt-in shared memory works in ``m_scratch``."""
    if _launch("tier_merge", args,
               lambda m: lanes.tier_merge_plain(m.p, m.tb, m.s, m.ws)):
        tier_merge.launches += 1


def queue_min_window(args, advance: bool) -> None:
    """Kernel C: earliest head, window law, ``live`` flag.

    Replaces ``shadow_tpu/backend/lanes.py:2260`` ``_queue_min`` with
    ``lanes_pairs.py:28`` ``pair_min_lanes`` and the window law of
    ``_build_round`` /
    ``_build_full_run`` (``lanes.py:3346-3356``, ``:3505-3526``).  Its bytes
    (N head pairs, 80 KB at 10k lanes) bound it at tens of nanoseconds; but
    each head is two strided int32 words, two 32-byte L2 sectors, so one
    SM's share of that traffic set the time of the one-block kernel it
    replaces.  One thread-block cluster per scenario (``c_blocks`` blocks
    from ``lanes.heads_blocks``, launched with ``cudaLaunchKernelEx``)
    spreads the heads over as many SMs, each thread issuing all its loads
    before its min; the blocks' minima meet in rank 0 through distributed
    shared memory between two ``cluster.sync()``, and rank 0 applies the
    window law under that scenario's stop, so the flags stay on the device
    and the host reads them only when it chooses to.  No global scratch
    word, atomic or memset: nothing waits to be cleared for the next call,
    and nothing reads back to the host.  On a tiered run the heads of the
    tier's endpoint rows count too (``lanes.py:2264-2270``)."""
    if _launch("queue_min_window", args,
               lambda m: lanes.queue_min_window_plain(m.p, m.s, m.ws, advance),
               int(bool(advance))):
        queue_min_window.launches += 1


def hybrid_window(args, turn: "lanes.HybridTurn") -> None:
    """Kernel C in its hybrid mode: one step of a hybrid turn's window law.

    Replaces ``shadow_tpu/backend/lanes.py:3647-3754``
    ``_build_hybrid_run``: its ``cond``, evaluated before each iteration,
    the window law of its ``body`` with the host side's bound in the
    global min, the egress reset and the ``ext_used`` fold at the turn's
    start, and the packed ``[5]`` readback.  The same cluster as
    ``queue_min_window`` (the head reduction is shared; rank 0's thread 0
    runs the law); the host side's
    next event time and used latency arrive as kernel parameters, so
    forming them reads nothing from the device.  A step whose stop
    condition fails clears ``live`` and writes the readback; the gated
    steps after it change nothing.  Bound by bytes: the N head pairs, as
    C."""
    if _launch("hybrid_window", args,
               lambda m: lanes.hybrid_window_plain(m.p, m.s, m.ws, turn),
               int(turn.first), turn.ext_hi, turn.ext_lo, turn.ext_used):
        hybrid_window.launches += 1


def hybrid_fused_window(args, turn: "lanes.FusedTurn") -> None:
    """Kernel C in its fused mode: one step of a k-window fused dispatch.

    Replaces ``shadow_tpu/backend/lanes.py:3781-3964``
    ``_build_hybrid_fused_run`` (with ``egress_refold``, ``:3823``, and
    ``seg_body``, ``:3905``): the one-window law's condition against the
    schedule slot the dispatch has reached, the window law of its body,
    and at a segment's end the consume test against the horizon, the
    recorded window end, the pointer over the schedule and ``egress_min``
    re-armed, until ``k_eff`` windows are consumed or the host's schedule
    runs out; then the ``[6 + k_cap]`` readback.  The cluster of C's other
    modes reduces the heads; rank 0's block alone goes on: the refold (a
    block min over the egress rows' times and outcomes) uses its every
    thread, the segment logic its thread 0; at most ``k_eff + 1`` passes a
    step.  The schedule is in the
    workspace (``ext``, one async copy a dispatch), the pointer, the count
    and the steps in ``fz``; the host's used latency and ``k_eff`` are
    kernel parameters.  Bound by bytes: the N head pairs, the schedule, and
    on a consume the egress rows' times and outcomes."""
    if _launch("hybrid_fused_window", args,
               lambda m: lanes.hybrid_fused_window_plain(m.p, m.s, m.ws, turn),
               int(turn.first), turn.k_eff, turn.ext_used):
        hybrid_fused_window.launches += 1


def inject_merge(args, blk: torch.Tensor) -> None:
    """Kernel H: merge one injection block into the lane queues.

    Replaces ``shadow_tpu/backend/lanes.py:3583`` ``_inject_merge`` (its
    sort of the ``[B]`` block by destination, the per-lane segments of
    fan-in Cxi = C, the keyed 4-word merge of ``[C + Cxi]`` rows with the
    stream payload words riding along, the tail and the sheds into
    ``n_queue`` and ``nb_shed``).  ``blk`` is ``[INJ_WORDS, B]`` int32 on
    the state's device.  One launch: a warp per lane over all N lanes
    finds its group by ballots over the block's valid and destination
    words, sorts it by (time, aux, index) in registers (a group past 32
    in batches that keep the Cxi smallest), and merges that run and the
    canonical empties after it with the queue row by binary searches (no
    overflow records: the reference writes none here); a lane with no
    group writes only when its row holds entries keyed above the
    canonical empty.  Bound by bytes: the block read once, the rows of
    the lanes it lands on read and written once.  Not gated on ``live``:
    it runs before the turn's first step arms it."""
    lanes_p = args.p if isinstance(args, LaneArgs) else args.members[0].p
    _check("injection block", blk, args.device, torch.int32,
           (lanes.INJ_WORDS, lanes_p.inject_batch))
    if _launch("inject_merge", args,
               lambda m: lanes.inject_merge_plain(m.p, m.tb, m.s, blk),
               blk.data_ptr()):
        inject_merge.launches += 1


def append_log(args) -> None:
    """Kernel D: compaction of the iteration's records into the log, of its
    flow records into the flowtrace ring and, on a hybrid run, of kernel
    A's egress candidates into the egress buffer.

    Replaces ``shadow_tpu/backend/lanes.py:2056`` ``_append_log`` and
    ``:2117`` ``_append_flow`` (with ``:2160`` ``_flow_group`` and
    ``:2177`` ``_concat_flow_groups``): one template on the row, in one
    launch — the ``[L, 6]`` int64 log and the ``[FL, 10]`` int32 ring,
    whose rows take the window's end as they go in.  The egress instance
    (``lanes.py:2219`` ``_append_egress``, called from ``_process_slot`` at
    ``:944-959``) is the third: A's ``[K*N]`` candidates in slot-major
    order, the reference's append order, into the ``[E, 6]`` int64 buffer,
    and the min of their DELIVERED times into ``egress_min``.  Bound by
    bytes: the valid flags of every slot are read once and only the valid
    rows are copied.  Each instance of each scenario is one thread-block
    cluster of ``lanes.LOG_CLUSTER`` (16) blocks (``cudaLaunchKernelEx``):
    a block owns one contiguous slice of the flags, a thread 32 of them as
    a mask (int4 loads, all in flight), and the block scans the masks'
    counts and stages its valid indices in shared memory (a slice past
    ``lanes.LOG_TILE`` flags only counts its later tiles here).  Once
    every block of the cluster has started (the wait of a barrier each
    arrived at as it began), each block writes its count (and egress
    minimum) into every block's shared memory (distributed shared memory);
    after one ``cluster.sync()`` each block forms its offset from its own
    copy, so no block reads another's memory after it, and copies its rows
    in order from the count, its threads on consecutive 16-byte (log) or
    8-byte (ring) pieces of consecutive rows, then scans, stages and
    copies its later tiles one at a time; rank 0 writes the count, the
    losses past the capacity and the egress minimum once.  No global
    ticket, fence, memset or workspace word: nothing is left for the next
    call to clear, and nothing reads back to the host."""
    if _launch("append_log", args,
               lambda m: lanes.append_log_plain(m.p, m.s, m.ws)):
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
            tier_merge, queue_min_window, hybrid_window, hybrid_fused_window,
            append_log, inject_merge, rand_u32)


def reset_launches() -> None:
    for fn in WRAPPERS:
        fn.launches = 0


reset_launches()
