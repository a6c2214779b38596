"""Drive the PyTorch/CUDA port on one NVIDIA card and hold it to account.

    python3 chip_smoke.py

Phases, in order (any failure exits nonzero and prints no result line):

1. the card's name and power limit (``nvidia-smi``);
2. build the lane kernels from ``shadow_tpu_torch/csrc`` (``nvcc``);
3. each kernel against its plain PyTorch version on the card, at the
   flagship shapes (N=10,000 hosts, C=16, K=2, Cx=8), on seeded valid
   states with NEVER holes, overflow past C and past Cx, CoDel drops and
   bucket waits — exact equality;
4. the threefry launcher ``rand_u32`` against the plain draw over a grid of
   seeds, streams and counters — exact;
5. kernels A, B and C against their plain versions on seeded ACTIVE states
   at the PHOLD shapes (N=10,000, C=64, K=8, Cx=64): phold and ping lanes
   beside passive ones, loss thresholds 0, mid-range and 2**32, times on
   both sides of the bootstrap end, ``min_used_lat`` set and unset, heads
   mixing PACKET, DELIVERY and LOCAL at one instant — exact;
6. per-kernel times (CUDA events; the profiler over live steps) on
   mid-run states of the full-width main paths at their own log
   capacities, beside the plain version's time, the bound and the
   device's busy share of the loop; the ``rand_u32`` launcher alone;
7. parity: step and device mode, on the card and on the CPU, on a 256-host
   tgen mesh with logging, a CoDel bottleneck, a non-strict overflow, and
   small phold, lossy tgen, ping and dynamic-runahead configurations —
   equal event logs, counters and final states, word for word;
8. full-width parity: PHOLD at 10,000 hosts for 25 sim ms, the lossy
   flagship for 1 sim s and the mixed mesh, untiered and tiered, for 100
   sim ms, card against the CPU plain path — equal logs and final states;
9. the main paths, launch counts reset just before each and read just
   after: the mixed TCP/UDP mesh (``mixed_flagship_config(10000)``:
   9,800 tgen-mesh hosts and 100 one-to-one stream pairs of 2 MB, strict)
   on the tiered stream pass at the preset's tuning (C=16, K=2, Cx=8,
   K_s=16, C2=64), 5 sim s; the same with netobs on, 5 sim s (the
   snapshot held to the run's counters, the mesh's 1428 bytes a send, no
   drop cause, one histogram count per window with a packet); the same
   with netobs and pcap on the 200 stream endpoints and the first 100
   mesh hosts, logging, 1 sim s (each capturing host's file holds exactly
   its PCAP_TX and DELIVERED rows, no other host has a file; the writer
   timed); the mesh untiered at C=48, K=4, 5 sim s;
   ``examples/cubic-vs-reno.yaml`` (tiered), 60 sim s;
   ``flagship_mesh_config(10000)`` with the bench tuning (C=16,
   K=2, Cx=8, strict), 1 sim s with logging and 10 sim s without; the
   untiered mesh with every flow traced (``experimental.flowtrace``, an
   8,388,608-row ring), 1 sim s: the ring kept every event, its SEND and
   RETRANSMIT rows are the run's sends, its DELIVERY rows the deliveries,
   no DROP, the decode timed;
   PHOLD at 10,000 hosts (``examples/phold.yaml`` with ``count: 10000``,
   default capacities), 10 sim s; the flagship with 1% loss on its edge,
   10 sim s — all in device mode; counters held to the flows' byte
   counts, the mesh's closed form, PHOLD's message conservation and the
   loss count's 5-sigma band; every kernel of each path launched.

Between 5 and 6, kernels A, B and E against their plain versions on
seeded stream states (flows in every state, owned and stale RTOs,
segments and foreign datagrams, losses on both sides of the bootstrap end,
throttled bursts; the star's stream entries in B's exchange; E's rows
overflowing), then kernels F and G, B's divert, C's tier minimum and D's
tier record groups on seeded tier states at the tiered mixed mesh's
shapes (both pop rules, with and without a log), then A, B, C, D, F and G
with the pcap and netobs planes on (the tiered mixed mesh's shapes, A
also at the PHOLD shapes and on the untiered stream lanes: throttled
buckets on both sides, CoDel drops, cross sheds, window flushes of 0 and
past 2**23 packets, capturing lanes and rows beside others); between 7 and
8,
card/CPU parity on five untiered stream configs (the pair, the lossy
pair, the star, ``examples/cubic-vs-reno.yaml`` and a small mixed mesh)
and six tiered ones (the pair, lossy, CUBIC, the small mixed mesh, a
250 ms link, dynamic runahead), tiered = untiered, and
``examples/stream-tcp.yaml`` for 60 sim s, its first 0.75 sim s card
against CPU; between 8 and 9, the planes card against CPU (step and
device mode) on ``tests/test_torch_obs.py``'s six configurations (the
drop-heavy mesh at its own C = Cx = 2048: merge rows in opted-in shared
memory) and on the 10k tiered mixed mesh for 100 sim ms with netobs and
300 capturing hosts — equal logs, states, netobs snapshots and capture
files; then flowtrace card against CPU (step and device mode) on
``tests/test_torch_flowtrace.py``'s configurations and the 40-host mixed
mesh at C = Cx = 4096 (B's rows in global memory), and on the 10k
untiered mixed mesh for 100 sim ms — equal logs, states, rings and
snapshots; then the stream pair with its queues past the opt-in limit
(untiered at C = 8,400: B's and E's rows in global memory; tiered at C2 =
8,400: G's), card = CPU.  Between the plane checks and 6, kernels A, B, D and E with
flowtrace on at samples 1, 0.5 and 0 (waits, losses, CoDel drops, stream
retransmits, B's and E's queue sheds, a ring that overflows mid-iteration,
D's two instances in one launch), then every kernel (A-G and D, with the
log's and the ring's instances, netobs and pcap) over S = 3 scenarios of
different seeds, tables and states in one batched launch against the
plain loop, then again with one scenario done (its words unchanged); the
stream groups again at S = 9, where the blocks no longer fit the kernel
parameter and the kernels read them from the device array.
Phase 6 also times the tiered mixed mesh with netobs, with a log, and
with netobs, pcap and a log, and the untiered one with flowtrace on, and
beside kernels C and D one PyTorch call each on the same inputs (the
profiler's device time; ``library_ms``): ``torch.amin`` over column 0 of
the queue times, boolean-mask selection of the records (and of the
egress rows, with the min of their DELIVERED times).  Just before 6,
kernels B and F on their edge cases (``check_merge_cases``), then D and C
on theirs (``check_compact_cases``): D's flags only in the last cluster
block's slice or on slice boundaries, all, none, the capacity inside a
slice, the start past it, the log, the ring and the egress in one launch
with the egress minimum in block 5, S = 1, 3, 8 and 9; C's min head in
the last block or a tier row, every head NEVER, ties, heads at the stop
time, with and without advance, dynamic runahead and the netobs flush,
S = 1, 3, 8 and 9, its hybrid mode's first and later steps and its fused
mode's refold passes — exact; then A and G on theirs
(``check_slot_cases``): A at 1, 31, 32, 33, 63, 64 and 65 lanes (around
its groups' warp and block boundaries) at K = 2, 3, 8 and 40 (a warp's
columns twice over), at 10,000 and 48,000 lanes, every column popped,
none and ties, the send, draw, local and mesh-offset counters wrapping
past the int32 top mid-row, passive, active and stream lanes side by
side (a star lane of 40 rows), the external arm, S = 1, 3, 8 and 9; G on
empty rows, exactly C2 valid, C2 + 1, every candidate valid, keys tied
between the queue and the candidates, an unsorted queue, the wide row in
``m_scratch``, S = 1, 3, 8 and 9 — exact; then E and H on theirs
(``check_row_cases``): E's unsorted queue rows, non-canonical empties on
both sides (canonical keys with payload words among them), keys tied
across the queue and the candidates, overflow with a log and flowtrace,
all-empty rows, one and four rows a block, C = 8,400 in ``m_scratch``,
S = 1, 3 and 9; H's groups of 0, 1, 31, 32, 33, Cxi, Cxi + 1 and 400
rows, ties broken by the row index, empty groups over rows that must
shift (consumed entries) and rows that must not, unsorted rows, S = 1, 3
and 9 — exact.
Between the wide rows and 9: fault schedules card = CPU (step and device)
on six twins of ``tests/test_torch_faults.py``'s configurations and on
the lossy flagship at 10,000 hosts for 1 sim s with a latency epoch (10 to
15 ms at 300 ms) and a loss epoch (0.01 to 0.05 at 600 ms), each epoch's
losses in its 5-sigma band; fleet sweeps, every scenario of a batched
card run equal to its serial card run (counters, rounds, every LaneState
field, logs and rings): the fleet cell (``flagship_mesh_config(10000)``,
C=16, K=2, Cx=8, 5 sim s, seeds 1-4 x {no fault, 1% loss from 2 s}: the
loss-free scenarios at the mesh's closed form, the lossy ones in their
5-sigma bands), the JAX package's bench sweep (8 seeds x 1,000 hosts),
4 seeds x the tiered mixed mesh for 1 sim s and 2 x the traced untiered
mesh for 100 sim ms; then the fleet cell's kernels per batched launch at
S = 8 and S = 1, its batched step, and the launches per batched step at
S = 1, 3 and 8 (equal), and the kernels of the tiered and of the traced
untiered mixed mesh eight times over against once.

The hybrid backend (managed binaries on the host CPU under the LD_PRELOAD
shim, their packets on the card; ``make -C native`` first builds the shim
and the apps): after the sweep kernels, kernel H, A's external arm with
D's egress instance and C's hybrid mode against their plain versions at
the hybrid flagship's shapes (``managed_relay_chains_large``: 151 managed
processes, 1,000 tgen-mesh peers, 1,151 lanes; mesh-only and with phold
lanes beside the external ones; blocks spread and all to one lane past
Cxi; the host's next event before, inside, past the window and absent,
the egress buffer empty and at its floor) — exact; then C's fused mode
(the k-window law) against its plain version at the same shapes, single
steps (the window law, a consumed window with the guard refolded over
egress rows on both sides of its end, the k_eff, horizon and egress-room
stops, first and later steps) and whole dispatches on the card against
the plain versions on a CPU copy — exact; after the fault phase, the
flagship at full width for 2 sim s at the reference's defaults (the
fused law, eager dispatch, 2 syscall worker processes) on the card, the
same with ``device="cpu"``, the port's CPU oracle and the one-window law
on the card — equal logs, counters, rounds, process errors and transfer
counts — then ``tests/test_hybrid_fusion.py``'s congested config on the
card (rollbacks), the CPU and the one-window law, then H, A, C's hybrid
and fused modes and D timed on the card run's state at the cut; after
the main paths, the flagship itself: 25 three-relay chains, 75 tcpecho
clients and the origin beside the 1,000 peers, 10 sim s, device mode,
strict, at the defaults (a worker process per core: none of them may
hold a CUDA context) and on the one-window law with as many workers — 76
clean exits,
4,216 rounds, no egress row lost, no process error, the two runs equal,
each with its sim-s/wall-s,
the device turns' and the syscall service's seconds, the fused law's
counters and the kernels' launches.

Last, the command line (``python -m shadow_tpu_torch``, each run in a
child process that runs the package's ``__main__`` as ``-m`` does and
reports its wrappers' launch counts, every kernel of its path launched):
(a) the tiered mixed mesh (``mixed_flagship_config(10000)`` as a config
file), 1 sim s, device mode, ``--netobs --event-log``: its
``sim-stats.json`` counters and rounds, ``event-log.tsv`` rows and
``NETOBS_*.json`` totals equal an in-process ``GpuEngine.run("device")``
of the same config; (b) ``flagship_mesh_config(10000)``, 1 sim s,
``--perf-logging --run-control`` with stdin ``n``, ``n``, ``stats``,
``c``: two pauses, one ``[window-agg]`` line a round, the closed form;
(c) the same two flags on the 100-host flagship, card and ``--device
cpu``, side by side: the ``[window-agg]`` lines equal byte for byte;
(d) PHOLD 10k, 1 sim s, ``--determinism-check`` (a 9,000,000-row log):
exit 0.  After (a), in process and with nothing beside it, the flagship
(10 sim s) in device mode, in step mode and in step mode with perf
logging, three times in turns: the price of the per-window seam; its
sim-s/wall-s and (a)'s beside the in-process runs are printed before the
``kernels`` line.  (b) and (c)'s two commands run side by side, then
(e)'s two; none of them times anything.  (d) starts once the kernels are
built and runs beside the kernel checks; the run waits for it before 6.

The CPU runs of the parity checks (7, 8, the stream, plane, flowtrace and
fault checks, and the hybrid parity's oracle and ``device="cpu"`` runs)
need nothing of the card: they start at the top in worker processes (the
card hidden from them) beside the build and the kernel checks, and are
all done before 6, so no measurement shares the host with them.

The last lines are the ``kernels`` JSON line, the ``nvidia-smi`` line and
the result line.  Imports nothing of JAX.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

import numpy as np
import torch

from shadow_tpu_torch.backend import kernels, lanes  # noqa: E402
from shadow_tpu_torch.backend import lanes_stream as lstr  # noqa: E402
from shadow_tpu_torch.backend.cpu_engine import CpuEngine  # noqa: E402
from shadow_tpu_torch.backend.gpu_engine import GpuEngine  # noqa: E402
from shadow_tpu_torch.backend.hybrid import (  # noqa: E402
    HybridEngine, MpHybridEngine, make_hybrid_engine)
from shadow_tpu_torch.config import presets, scenarios  # noqa: E402
from shadow_tpu_torch.config.options import ConfigOptions  # noqa: E402
from shadow_tpu_torch.config.presets import flagship_mesh_config  # noqa: E402
from shadow_tpu_torch.core import rng as rng_mod  # noqa: E402
from shadow_tpu_torch.engine.run_control import PerfLog  # noqa: E402
from shadow_tpu_torch.models.base import builtin_models  # noqa: E402
from shadow_tpu_torch.net import ltcp  # noqa: E402
from shadow_tpu_torch.net.token_bucket import bucket_params  # noqa: E402
from shadow_tpu_torch.obs import flowtrace as ftr  # noqa: E402
from shadow_tpu_torch.sweep import (SweepEngine, SweepSpec,  # noqa: E402
                                    expand_variants)

DEV = torch.device("cuda")
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
# 32-bit integer operations per second: the data sheet's 67 TFLOP/s of
# float32 is 132 SMs x 128 lanes x 2 (FMA) x 1.98 GHz; each SM has 64 INT32
# lanes, so 132 x 64 x 1.98e9
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# 32-bit operations of one threefry-2x32 draw (csrc/lanes.cu lane_draw):
# key word and parity (3), counter adds (2), 20 rounds of add, rotate, xor
# (60), 5 key injections of three adds (15)
THREEFRY_OPS = 3 + 2 + 20 * 3 + 5 * 3
N_FLAG, C_FLAG, K_FLAG, CX_FLAG = 10_000, 16, 2, 8
# PHOLD at the package's default capacities (C=64, K=8, Cx = C)
C_PHOLD, K_PHOLD = 64, 8
# the mixed TCP/UDP mesh, untiered, at the reference's pre-tier queue shape
C_MIX, K_MIX = 48, 4
# the flowtrace main path's ring: 8,388,608 rows (320 MiB), for the 3-5M
# events of the untiered mixed mesh's first sim second (about 1.03M sends,
# three to five events each)
FLOW_RING = 1 << 23
SEED = 20261017
FAILED: list[str] = []


def log(msg: str) -> None:
    print(msg, flush=True)


def phase(name):
    def wrap(fn):
        def run(*a, **kw):
            log(f"== {name}")
            t0 = time.perf_counter()
            try:
                out = fn(*a, **kw)
            except Exception:  # report, then fail the run at the end
                traceback.print_exc()
                sys.stdout.flush()
                FAILED.append(name)
                return None
            log(f"== {name}: ok ({time.perf_counter() - t0:.2f} s)")
            return out
        return run
    return wrap


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def flagship(sim_seconds=10, packet_loss=0.0, n_hosts=N_FLAG):
    cfg = flagship_mesh_config(n_hosts, sim_seconds=sim_seconds,
                               queue_capacity=C_FLAG, pops_per_round=K_FLAG)
    cfg.experimental.tpu_cross_capacity = CX_FLAG
    if packet_loss:
        g = cfg.network.graph
        g.inline = g.inline.replace(
            'latency "10 ms"', f'latency "10 ms"  packet_loss {packet_loss}')
    return cfg


def phold_doc(n_hosts=None, stop_time="10s", seed=1) -> dict:
    """``examples/phold.yaml``: one 1 Gbit node with a 5 ms self-edge,
    ``phold --messages 4`` (256-byte datagrams), with ``count: n_hosts``
    (default: the full width, 10,000)."""
    n_hosts = N_FLAG if n_hosts is None else n_hosts
    return {
        "general": {"stop_time": stop_time, "seed": seed},
        "network": _switch("1 Gbit", "1 Gbit", "5 ms"),
        "hosts": {"p": {"count": n_hosts, "network_node_id": 0, "processes": [
            {"path": "phold", "args": ["--messages", "4"]}]}},
    }


def phold(**kw):
    return ConfigOptions.from_dict(phold_doc(**kw))


def clone(nt):
    """A copy of a state or workspace (a TierState inside included)."""
    return type(nt)(*[clone(t) if isinstance(t, tuple) else t.clone()
                      for t in nt])


def copy_into(dst, src) -> None:
    for d, s_ in zip(dst, src):
        if isinstance(d, tuple):
            copy_into(d, s_)
        else:
            d.copy_(s_)


def fields(nt) -> dict:
    """The tensors of a state or workspace by name; a TierState's as
    ``stream.flows``, ``stream.q``, ``stream.v``."""
    out = {}
    for f, t in nt._asdict().items():
        if isinstance(t, tuple):
            out.update({f"{f}.{g}": u for g, u in t._asdict().items()})
        else:
            out[f] = t
    return out


def assert_equal(tag: str, a: dict, b: dict) -> int:
    """Raise unless every field is equal; returns the largest absolute
    difference seen (0)."""
    err = 0
    for f in a:
        d = (a[f].to(torch.int64) - b[f].to(torch.int64)).abs()
        err = max(err, int(d.max()) if d.numel() else 0)
        if not torch.equal(a[f], b[f]):
            bad = (a[f] != b[f]).nonzero()
            raise AssertionError(
                f"{tag}: field {f} differs at {bad.shape[0]} positions, "
                f"first {bad[:3].tolist()}"
            )
    return err


MAX_ERR = {}  # kernel name -> largest |kernel - plain| over its checks


def check(name: str, tag: str, kern: dict, plain: dict) -> None:
    MAX_ERR[name] = max(MAX_ERR.get(name, 0),
                        assert_equal(f"{name} {tag}", kern, plain))


# ---- the CPU references, run ahead -----------------------------------------

# The parity phases hold each card run against the CPU plain path on the
# same config.  The CPU runs need nothing of the card, so they start at the
# top of the run in worker processes (spawned, the card hidden from them,
# one intra-op thread each) and go on beside the kernel build and the
# kernel checks.  The pool is drained and stopped before the first timing
# phase, so no measurement shares the host with it; each parity phase takes
# its references when it gets there (``cpu_ref``).
CPU_POOL = None
CPU_REFS: dict = {}  # (runner name, *args) -> future
CPU_WORKERS = max(1, (os.cpu_count() or 2) - 2)  # a core each for the
# process that runs the card and for the compiler


class _Wire:
    """A tensor on its way out of a worker, as a numpy array: pickled by
    value, so no shared-memory handle outlives the worker."""

    def __init__(self, t: torch.Tensor):
        self.a = t.numpy()


def _pack(x, out: bool = True):
    if out and isinstance(x, torch.Tensor):
        return _Wire(x)
    if not out and isinstance(x, _Wire):
        return torch.from_numpy(x.a)
    if isinstance(x, dict):
        return {k: _pack(v, out) for k, v in x.items()}
    if type(x) in (tuple, list):
        return type(x)(_pack(v, out) for v in x)
    return x


def _cpu_worker_init(data: str) -> None:
    global DATA
    DATA = data
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    torch.set_num_threads(1)


def _cpu_job(fn, args: tuple):
    t0 = time.perf_counter()
    out = fn(*args)
    return _pack(out), time.perf_counter() - t0


def start_cpu_refs(jobs: list) -> None:
    """Start the workers and submit ``jobs``: (runner, *args) each."""
    global CPU_POOL
    import concurrent.futures
    import multiprocessing

    CPU_POOL = concurrent.futures.ProcessPoolExecutor(
        max_workers=CPU_WORKERS,
        mp_context=multiprocessing.get_context("spawn"),
        initializer=_cpu_worker_init, initargs=(DATA,))
    submit_cpu_refs(jobs)


def submit_cpu_refs(jobs: list) -> None:
    for fn, *args in jobs:
        CPU_REFS[(fn.__name__, *args)] = CPU_POOL.submit(_cpu_job, fn,
                                                         tuple(args))


def drain_cpu_refs() -> None:
    """Wait for the CPU runs and stop the workers; their results stay."""
    import concurrent.futures

    if CPU_POOL is None:
        return
    t0 = time.perf_counter()
    concurrent.futures.wait(CPU_REFS.values())
    stop_cpu_refs()
    busy = sum(f.result()[1] for f in CPU_REFS.values()
               if f.exception() is None)
    log(f"CPU references: {len(CPU_REFS)} runs, {busy:.1f} s in "
        f"{CPU_WORKERS} worker processes, waited "
        f"{time.perf_counter() - t0:.1f} s for the last")


def stop_cpu_refs() -> None:
    if CPU_POOL is not None:
        CPU_POOL.shutdown(wait=True, cancel_futures=True)


def cpu_ref(fn, *args):
    """``fn(*args)``, a CPU reference run ahead in the pool, and its
    seconds there."""
    out, secs = CPU_REFS.pop((fn.__name__, *args)).result()
    return _pack(out, out=False), secs


# ---- seeded valid states at the flagship shapes ----------------------------

INTERVAL = 1_000_000  # bucket refill interval (ns)
T0 = 5_000_000_000  # 5 s: times with a nonzero high word


def random_tables(eng: GpuEngine, rng) -> lanes.LaneTables:
    """Flagship tables with mixed models and some slow links, so the
    bucket waits and CoDel drops are exercised."""
    n = eng.params.n_lanes
    model = rng.choice(
        [lanes.M_TGEN_MESH, lanes.M_TGEN_CLIENT, lanes.M_TGEN_SERVER,
         lanes.M_NONE], size=n, p=[0.7, 0.1, 0.1, 0.1])
    bw = rng.choice([2_000_000, 50_000_000, 1_000_000_000], size=(2, n))
    par = np.array([[bucket_params(int(b)) for b in row] for row in bw])
    rate, burst = par[..., 0], par[..., 1]
    kfull = burst // rate + 1
    interval = rng.choice([7_000_000, 10_000_000], size=n)

    def t32(a):
        return torch.as_tensor(np.asarray(a, dtype=np.int32), device=DEV)

    return eng.tables._replace(
        model=t32(model), recv_mult=t32(rng.integers(0, 3, n)),
        p_size=t32(rng.integers(28, 1500, n)),
        p_peer=t32(rng.integers(0, n, n)), p_stride=t32(rng.integers(1, 4, n)),
        p_int_hi=t32(interval >> 31), p_int_lo=t32(interval & lanes.MASK31),
        up_rate=t32(rate[0]), up_burst=t32(burst[0]), up_kfull=t32(kfull[0]),
        up_kfi=t32(kfull[0] * INTERVAL),
        dn_rate=t32(rate[1]), dn_burst=t32(burst[1]), dn_kfull=t32(kfull[1]),
        dn_kfi=t32(kfull[1] * INTERVAL),
    )


def pairs(t):
    return t >> 31, t & lanes.MASK31


def sorted_rows(times, auxh, auxl, size):
    """Sort each row by the 4-word key (times int64, NEVER for holes)."""
    order = np.lexsort((auxl, auxh, times), axis=1)
    times, auxh, auxl, size = (np.take_along_axis(a, order, axis=1)
                               for a in (times, auxh, auxl, size))
    never = times == lanes.NEVER
    thi = np.where(never, lanes.NEVER32, times >> 31)
    tlo = np.where(never, lanes.NEVER32, times & lanes.MASK31)
    return thi, tlo, auxh, auxl, size


def random_state(eng: GpuEngine, tb: lanes.LaneTables, rng) -> lanes.LaneState:
    p = eng.params
    n, c = p.n_lanes, p.capacity
    s = eng.initial_state()
    lane = np.arange(n)[:, None]
    fill = rng.integers(0, c + 1, n)
    col = np.arange(c)[None, :]
    live = col < fill[:, None]
    is_pkt = rng.random((n, c)) < 0.6
    times = np.where(live, T0 + rng.integers(0, 40_000_000, (n, c)), lanes.NEVER)
    src = np.where(is_pkt, rng.integers(0, n, (n, c)), lane)
    kind = np.where(is_pkt, lanes.PACKET, lanes.LOCAL)
    auxh = ((kind << lanes.AUX_KIND_SHIFT) | (src << lanes.AUX_SRC_SHIFT))
    auxl = col + rng.integers(0, 1 << 20, (n, 1)) * c  # distinct per row
    size = np.where(is_pkt, rng.integers(28, 1500, (n, c)),
                    rng.choice([-1, -5, 0, 0, 0], (n, c)))
    rows = sorted_rows(times, auxh.astype(np.int32), auxl.astype(np.int32),
                       size.astype(np.int32))

    def t32(a):
        return torch.as_tensor(np.asarray(a, dtype=np.int32), device=DEV)

    burst_up = tb.up_burst.cpu().numpy()
    burst_dn = tb.dn_burst.cpu().numpy()
    grid = T0 // INTERVAL

    def bucket(burst):
        tokens = rng.integers(0, burst + 1)
        nr = INTERVAL * (grid + rng.choice([-200, -30, -3, 0, 5, 30], n))
        ld = T0 + rng.choice([0, 0, 2_000_000, 30_000_000], n)
        return tokens, nr, ld

    up_tok, up_nr, up_ld = bucket(burst_up)
    dn_tok, dn_nr, dn_ld = bucket(burst_dn)
    unset = rng.random(n) < 0.4
    fat = T0 + rng.integers(-200_000_000, 50_000_000, n)
    dnext = T0 + rng.integers(-200_000_000, 200_000_000, n)
    we = T0 + 10_000_000
    fields = {
        "q_thi": rows[0], "q_tlo": rows[1], "q_auxh": rows[2],
        "q_auxl": rows[3], "q_size": rows[4],
        "send_seq": rng.integers(0, 1 << 20, n),
        "local_seq": rng.integers(0, 1 << 20, n),
        "up_tokens": up_tok, "up_nr_hi": pairs(up_nr)[0],
        "up_nr_lo": pairs(up_nr)[1], "up_ld_hi": pairs(up_ld)[0],
        "up_ld_lo": pairs(up_ld)[1],
        "dn_tokens": dn_tok, "dn_nr_hi": pairs(dn_nr)[0],
        "dn_nr_lo": pairs(dn_nr)[1], "dn_ld_hi": pairs(dn_ld)[0],
        "dn_ld_lo": pairs(dn_ld)[1],
        "cd_fat_hi": np.where(unset, lanes.CD_UNSET, pairs(fat)[0]),
        "cd_fat_lo": np.where(unset, 0, pairs(fat)[1]),
        "cd_dnext_hi": pairs(dnext)[0], "cd_dnext_lo": pairs(dnext)[1],
        "cd_drop_count": rng.integers(0, 1100, n),
        "m_sent": rng.integers(0, 1000, n),
        "m_peer_offset": rng.integers(0, 1 << 30, n),
        "n_delivered": rng.integers(0, 1000, n),
        "n_codel": rng.integers(0, 1000, n),
        "n_queue": np.zeros(n), "recv_bytes": rng.integers(0, 1 << 20, n),
        "n_sends": rng.integers(0, 1000, n),
    }
    out = {f: t32(v) for f, v in fields.items()}
    out["cd_dropping"] = torch.as_tensor(rng.random(n) < 0.5, device=DEV)
    return s._replace(**out, now_we_hi=t32(we >> 31).reshape(()),
                      now_we_lo=t32(we & lanes.MASK31).reshape(()))


def random_exchange(p: lanes.LaneParams, ws: lanes.Workspace, rng) -> None:
    """Outbound and self blocks for kernel B: skewed destinations (hot
    lanes receive more than Cx), distinct keys, some empty entries."""
    n, k = p.n_lanes, p.pops_per_iter
    m = np.arange(k * n)
    valid = rng.random(k * n) < 0.7
    hot = rng.random(k * n) < 0.05
    dst = np.where(hot, rng.integers(0, 10, k * n), rng.integers(0, n, k * n))
    arr = T0 + 10_000_000 + rng.integers(0, 30_000_000, k * n)
    out = np.stack([
        np.where(valid, dst, n),
        np.where(valid, arr >> 31, lanes.NEVER32),
        np.where(valid, arr & lanes.MASK31, lanes.NEVER32),
        np.where(valid, (m % n) << lanes.AUX_SRC_SHIFT, 0),
        np.where(valid, m // n + (1 << 24), 0),
        np.where(valid, rng.integers(28, 1500, k * n), 0),
    ]).reshape(6, k, n)
    ws.out_blk.copy_(torch.as_tensor(out.astype(np.int32), device=DEV))
    sw = p.self_width
    arm = rng.random((n, sw)) < 0.5
    t_arm = T0 + rng.integers(10_000_000, 50_000_000, (n, sw))
    lane = np.arange(n)[:, None]
    # active runs: DELIVERY inserts in the first K columns, keyed by a
    # popped packet's (src, seq)
    ins = (np.arange(sw) < k)[None, :] & (not p.all_passive)
    kind = np.where(ins, lanes.DELIVERY, lanes.LOCAL)
    src = np.where(ins, rng.integers(0, n, (n, sw)), lane)
    self_blk = np.stack([
        np.where(arm, t_arm >> 31, lanes.NEVER32),
        np.where(arm, t_arm & lanes.MASK31, lanes.NEVER32),
        (kind << lanes.AUX_KIND_SHIFT) | (src << lanes.AUX_SRC_SHIFT),
        rng.integers(0, 1 << 20, (n, sw)),
        np.where(ins, rng.integers(28, 1500, (n, sw)), 0),
    ])
    ws.self_blk[:5].copy_(torch.as_tensor(self_blk.astype(np.int32), device=DEV))


def run_pair(p, tb, s0, ws0, call, plain):
    """Apply the kernel and the plain version to copies of the same inputs;
    returns both (state, workspace) dicts."""
    out = []
    for use_kernel in (True, False):
        s, ws = clone(s0), clone(ws0)
        args = kernels.LaneArgs(p, tb, s, ws)
        if use_kernel:
            call(args)
        else:
            plain(p, tb, s, ws)
        torch.cuda.synchronize()
        out.append(state_fields(s, ws))
    return out


def state_fields(s, ws) -> dict:
    """A state's and its workspace's tensors by name, as the checks compare
    them: the exchange scratch (x_*) and the merges' global rows
    (m_scratch) are the kernels' own working memory, left out."""
    return {**fields(s), **{f: t for f, t in ws._asdict().items()
                            if not f.startswith("x_") and f != "m_scratch"}}


@phase("kernels vs plain at the flagship shapes (tolerance: exact, integer)")
def check_kernels():
    rng = np.random.default_rng(SEED)
    for log_cap in (0, 60_000):
        eng = GpuEngine(flagship(), log_capacity=log_cap)
        p = eng.params
        for rep in range(3):
            tb = random_tables(eng, rng)
            s0 = random_state(eng, tb, rng)
            ws0 = lanes.make_workspace(p, DEV)
            ws0.ctl[0] = 1
            tag = f"L={log_cap} rep={rep}"
            kern, plain = run_pair(
                p, tb, s0, ws0, kernels.lane_slots,
                lambda p_, tb_, s, ws: lanes.lane_slots_plain(p_, tb_, s, ws))
            check("lane_slots", tag, kern, plain)
            popped = int((s0.q_thi[:, :K_FLAG] != plain["q_thi"][:, :K_FLAG]).sum())
            waits = int((plain["dn_ld_hi"] != s0.dn_ld_hi).sum()
                        + (plain["dn_ld_lo"] != s0.dn_ld_lo).sum())
            drops = int((plain["n_codel"] - s0.n_codel).sum())
            log(f"lane_slots {tag}: equal; popped {popped}, codel drops "
                f"{drops}, dn departures moved {waits}")

            random_exchange(p, ws0, rng)
            kern, plain = run_pair(
                p, tb, s0, ws0, kernels.exchange_merge,
                lambda p_, tb_, s, ws:
                    lanes.exchange_merge_plain(p_, tb_, s, ws))
            check("exchange_merge", tag, kern, plain)
            cnt = torch.bincount(ws0.out_blk[0].reshape(-1).long(),
                                 minlength=p.n_lanes + 1)[:p.n_lanes]
            over_cx = int((cnt > p.cross_cap).sum())
            shed = int(plain["n_queue"].sum())
            log(f"exchange_merge {tag}: equal; lanes over Cx {over_cx}, "
                f"events shed {shed}")
            if over_cx == 0 or shed == 0:
                raise AssertionError("exchange inputs missed the overflow cases")

            for advance in (False, True):
                for we_shift in (-10_000_000, 0, 10**10):
                    s1 = clone(s0)
                    we = T0 + we_shift
                    s1.now_we_hi.fill_(we >> 31)
                    s1.now_we_lo.fill_(we & lanes.MASK31)
                    kern, plain = run_pair(
                        p, tb, s1, ws0,
                        lambda a, adv=advance: kernels.queue_min_window(a, adv),
                        lambda p_, tb_, s, ws, adv=advance:
                            lanes.queue_min_window_plain(p_, s, ws, adv))
                    check("queue_min_window", f"{tag} adv={advance}",
                          kern, plain)
            # a finished run: every head at NEVER
            s1 = clone(s0)
            s1.q_thi.fill_(lanes.NEVER32)
            s1.q_tlo.fill_(lanes.NEVER32)
            kern, plain = run_pair(
                p, tb, s1, ws0, lambda a: kernels.queue_min_window(a, True),
                lambda p_, tb_, s, ws: lanes.queue_min_window_plain(p_, s, ws, True))
            check("queue_min_window", f"{tag} drained", kern, plain)
            if int(plain["ctl"][0]) != 0:
                raise AssertionError("drained queues still live")

            if log_cap:
                n_rec = ws0.rec_valid.numel()
                ws0.rec_valid.copy_(torch.as_tensor(
                    (rng.random(n_rec) < 0.3).astype(np.int32), device=DEV))
                ws0.recs.copy_(torch.as_tensor(
                    rng.integers(0, 1 << 40, (n_rec, 6)), device=DEV))
                for start in (0, log_cap - 5_000):
                    s1 = clone(s0)
                    s1.log_count.fill_(start)
                    kern, plain = run_pair(
                        p, tb, s1, ws0, kernels.append_log,
                        lambda p_, tb_, s, ws: lanes.append_log_plain(p_, s, ws))
                    check("append_log", f"{tag} start={start}", kern, plain)
                    log(f"append_log {tag} start={start}: equal; kept "
                        f"{int(plain['log_count']) - start}, lost "
                        f"{int(plain['log_lost'])}")


@phase("rand_u32 vs plain over seeds x streams x counters (tolerance: exact)")
def check_rand_u32():
    lane = torch.arange(N_FLAG, dtype=torch.int64)
    for seed in (0, 1, (1 << 32) + 7, (1 << 64) - 1):
        for stream in (rng_mod.LOSS_STREAM, rng_mod.APP_STREAM):
            for counter in (0, 1, (1 << 31) - 1, (1 << 32) - 1):
                words = rng_mod.as_i32(lane | stream)
                count = rng_mod.as_i32(torch.full_like(lane, counter))
                got = kernels.rand_u32(seed, words.to(DEV), count.to(DEV))
                # CPU tensors: the plain draw
                want = kernels.rand_u32(seed, words, count)
                check("rand_u32", f"seed={seed} stream={stream} c={counter}",
                      {"draw": got.cpu()}, {"draw": want})
    log("rand_u32: equal on 32 grids of 10,000 draws")


def active_params(eng: GpuEngine, dyn: bool) -> lanes.LaneParams:
    """The engine's shapes with every ported model, loss, a bootstrap end
    inside the states' times, and dynamic runahead on or off."""
    return dataclasses.replace(
        eng.params, models_present=tuple(range(7)), has_loss=True,
        bootstrap_end=T0 + 5_000_000, dynamic_runahead=dyn,
        runahead_floor=1_500_000, seed=(1 << 64) - 3)


def active_tables(eng: GpuEngine, rng) -> lanes.LaneTables:
    """Mixed phold, ping, tgen and empty lanes over three graph nodes whose
    loss thresholds are 0, mid-range and 2**32."""
    n = eng.params.n_lanes
    tb = random_tables(eng, rng)
    g = 3
    model = rng.choice(
        [lanes.M_PHOLD, lanes.M_PING_CLIENT, lanes.M_PING_SERVER,
         lanes.M_TGEN_MESH, lanes.M_TGEN_CLIENT, lanes.M_TGEN_SERVER,
         lanes.M_NONE], size=n, p=[0.4, 0.15, 0.15, 0.1, 0.1, 0.05, 0.05])
    thresh = np.array([[0, 1 << 31, 1 << 32],
                       [1 << 32, 42_949_672, 0],
                       [3_000_000_000, 0, 1 << 32]], dtype=np.int64)

    def t32(a):
        return torch.as_tensor(np.asarray(a, dtype=np.int32), device=DEV)

    return tb._replace(
        model=t32(model), node_of=t32(rng.integers(0, g, n)),
        lat=t32(rng.integers(1_000_000, 20_000_000, (g, g))),
        thresh=torch.as_tensor(thresh, device=DEV),
        p_count=t32(rng.integers(0, 1000, n)),
    )


def active_state(eng: GpuEngine, tb, rng) -> lanes.LaneState:
    """A seeded state whose heads tie: times on a coarse 1 ms grid, kinds
    PACKET, DELIVERY and LOCAL mixed, so same-instant prefixes of every
    shape occur; counters near the int32 top for the draws."""
    p = eng.params
    n, c = p.n_lanes, p.capacity
    s = random_state(eng, tb, rng)
    lane = np.arange(n)[:, None]
    fill = rng.integers(0, c + 1, n)
    col = np.arange(c)[None, :]
    live = col < fill[:, None]
    # each row starts somewhere in the window, on both sides of the
    # bootstrap end, and most of its events share one of three instants
    start = rng.integers(0, 10, (n, 1))
    times = np.where(live, T0 + (start + rng.integers(0, 3, (n, c)))
                     * 1_000_000, lanes.NEVER)
    kind = rng.choice([lanes.PACKET, lanes.DELIVERY, lanes.LOCAL], (n, c),
                      p=[0.5, 0.3, 0.2])
    src = np.where(kind == lanes.LOCAL, lane, rng.integers(0, n, (n, c)))
    auxh = (kind << lanes.AUX_KIND_SHIFT) | (src << lanes.AUX_SRC_SHIFT)
    auxl = col + rng.integers(0, 1 << 20, (n, 1)) * c
    size = np.where(kind == lanes.LOCAL, rng.choice([-1, -5, 0, 0], (n, c)),
                    rng.integers(28, 1500, (n, c)))
    rows = sorted_rows(times, auxh.astype(np.int32), auxl.astype(np.int32),
                       size.astype(np.int32))

    def t32(a):
        return torch.as_tensor(np.asarray(a, dtype=np.int32), device=DEV)

    top = (1 << 31) - 1 - p.pops_per_iter
    return s._replace(
        q_thi=t32(rows[0]), q_tlo=t32(rows[1]), q_auxh=t32(rows[2]),
        q_auxl=t32(rows[3]), q_size=t32(rows[4]),
        send_seq=t32(rng.choice([0, 1 << 20, top], n)),
        app_draws=t32(rng.choice([0, 77, top], n)),
        n_loss=t32(rng.integers(0, 1000, n)),
        n_hops=t32(rng.integers(0, 1000, n)),
    )


@phase("kernels A, B, C vs plain on seeded active states, PHOLD shapes "
       "(tolerance: exact, integer)")
def check_active_kernels():
    rng = np.random.default_rng(SEED + 1)
    eng = GpuEngine(phold(stop_time="1s"), log_capacity=0)
    for log_cap in (0, 1_000_000):
        for rep_ in range(2):
            dyn = rep_ == 1
            p = dataclasses.replace(active_params(eng, dyn),
                                    log_capacity=log_cap)
            tb = active_tables(eng, rng)
            s0 = active_state(eng, tb, rng)
            if log_cap:
                s0 = s0._replace(log=torch.zeros((log_cap, 6), dtype=torch.int64,
                                                 device=DEV))
            for used in (lanes.NEVER32, 1_200_000, 7_000_000):
                s0.min_used_lat.fill_(used)
                ws0 = lanes.make_workspace(p, DEV)
                ws0.ctl[0] = 1
                tag = f"L={log_cap} dyn={dyn} used={used}"
                kern, plain = run_pair(
                    p, tb, s0, ws0, kernels.lane_slots,
                    lambda p_, tb_, s, ws: lanes.lane_slots_plain(p_, tb_, s, ws))
                check("lane_slots", tag, kern, plain)
                d = {f: int((plain[f] - s0._asdict()[f]).sum())
                     for f in ("n_sends", "n_loss", "n_hops", "app_draws",
                               "n_delivered")}
                ins = int((plain["self_blk"][0, :, :p.pops_per_iter]
                           != lanes.NEVER32).sum())
                popped = int((s0.q_thi[:, :p.pops_per_iter]
                              != plain["q_thi"][:, :p.pops_per_iter]).sum())
                log(f"lane_slots active {tag}: equal; popped {popped}, "
                    f"DELIVERY inserts {ins}, {d}, min_used_lat "
                    f"{int(plain['min_used_lat'])}")
                if not (d["n_loss"] and d["n_hops"] and d["app_draws"] and ins):
                    raise AssertionError("active inputs missed a case")

            random_exchange(p, ws0, rng)
            kern, plain = run_pair(
                p, tb, s0, ws0, kernels.exchange_merge,
                lambda p_, tb_, s, ws:
                    lanes.exchange_merge_plain(p_, tb_, s, ws))
            check("exchange_merge", f"active L={log_cap} rep={rep_}",
                  kern, plain)
            log(f"exchange_merge active L={log_cap}: equal on [C {p.capacity} "
                f"| self {p.self_width} | cross {p.cross_cap}] rows; shed "
                f"{int(plain['n_queue'].sum())}")

            for used in (lanes.NEVER32, 900_000, 3_000_000):
                for advance in (False, True):
                    s1 = clone(s0)
                    s1.min_used_lat.fill_(used)
                    we = T0 - 10_000_000
                    s1.now_we_hi.fill_(we >> 31)
                    s1.now_we_lo.fill_(we & lanes.MASK31)
                    kern, plain = run_pair(
                        p, tb, s1, ws0,
                        lambda a, adv=advance: kernels.queue_min_window(a, adv),
                        lambda p_, tb_, s, ws, adv=advance:
                            lanes.queue_min_window_plain(p_, s, ws, adv))
                    check("queue_min_window",
                          f"active dyn={dyn} used={used} adv={advance}",
                          kern, plain)
            log(f"queue_min_window active dyn={dyn}: equal")


# ---- seeded stream states ----------------------------------------------------


def mixed_mesh(sim_seconds=5):
    """``mixed_flagship_config(10000)`` (BASELINE config #4 with streams: 9,800
    tgen-mesh hosts, 100 one-to-one stream pairs of 2,000,000 bytes, one
    1 Gbit switch, 10 ms latency, Cx=8), untiered, at the reference's
    pre-tier queue shape C=48, K=4."""
    cfg = presets.mixed_flagship_config(N_FLAG, sim_seconds=sim_seconds)
    cfg.experimental.tpu_stream_tiered = False
    cfg.experimental.tpu_lane_queue_capacity = C_MIX
    cfg.experimental.tpu_events_per_round = K_MIX
    return cfg


def stream_flows(rng, s: int) -> np.ndarray:
    """[2, S, F] flow matrices covering every state, recovery, RTO
    back-off, both algorithms and windows near MAX_CWND_FP."""
    m = 2 * s
    f = np.zeros((m, lstr.N_COLS), dtype=np.int64)
    f[:, lstr.C_STATE] = rng.integers(0, 7, m)
    una = rng.integers(0, 40, m)
    f[:, lstr.C_SND_UNA] = una
    f[:, lstr.C_SND_NXT] = una + rng.integers(0, 30, m)
    f[:, lstr.C_RCV_NXT] = rng.integers(0, 40, m)
    f[:, lstr.C_CWND] = rng.choice(
        [ltcp.FP, 3 * ltcp.FP + 17, 10 * ltcp.FP, ltcp.MAX_CWND_FP - 5,
         ltcp.MAX_CWND_FP], m)
    in_rec = rng.integers(0, 2, m)
    f[:, lstr.C_IN_REC] = in_rec
    f[:, lstr.C_SSTHRESH] = np.where(
        in_rec, rng.choice([2 * ltcp.FP, 8 * ltcp.FP], m),
        rng.choice([2 * ltcp.FP, 8 * ltcp.FP, ltcp.INIT_SSTHRESH_FP], m))
    f[:, lstr.C_DUP_ACKS] = rng.integers(0, 4, m)
    f[:, lstr.C_RECOVER] = una + rng.integers(0, 30, m)
    f[:, lstr.C_MAX_SENT] = f[:, lstr.C_SND_NXT] + rng.integers(0, 5, m)
    f[:, lstr.C_RTT_SEQ] = rng.choice([-1, 0, 5, 20, 45], m)
    none = rng.random(m) < 0.3
    srtt = rng.integers(1_000_000, 400_000_000, m)
    f[:, lstr.C_SRTT_HI] = np.where(none, -1, srtt >> 31)
    f[:, lstr.C_SRTT_LO] = np.where(none, 0, srtt & lanes.MASK31)
    f[:, lstr.C_RTTVAR_HI], f[:, lstr.C_RTTVAR_LO] = pairs(
        rng.integers(0, 200_000_000, m))
    f[:, lstr.C_RTO_HI], f[:, lstr.C_RTO_LO] = pairs(rng.choice(
        [ltcp.RTO_MIN, ltcp.RTO_INIT, 3_200_000_000, ltcp.RTO_MAX], m))
    f[:, lstr.C_RTT_TS_HI], f[:, lstr.C_RTT_TS_LO] = pairs(
        T0 - rng.integers(0, 900_000_000, m))
    for hi, lo in ((lstr.C_RTODL_HI, lstr.C_RTODL_LO),
                   (lstr.C_RTOEV_HI, lstr.C_RTOEV_LO)):
        t = T0 + rng.integers(-200_000_000, 900_000_000, m)
        never = rng.random(m) < 0.3
        f[:, hi] = np.where(never, lanes.NEVER32, t >> 31)
        f[:, lo] = np.where(never, lanes.NEVER32, t & lanes.MASK31)
    f[:, lstr.C_TX_SEGS] = rng.integers(0, 1000, m)
    f[:, lstr.C_RETRANS] = rng.integers(0, 100, m)
    f[:, lstr.C_COMPLETED] = rng.integers(0, 2, m)
    f[:, lstr.C_RX_SEGS] = rng.integers(0, 1000, m)
    f[:, lstr.C_RX_BYTES] = rng.integers(0, 1 << 24, m)
    f[:, lstr.C_WMAX] = rng.choice([0, 12 * ltcp.FP, ltcp.MAX_CWND_FP], m)
    f[:, lstr.C_ORIGIN] = rng.choice([0, 20 * ltcp.FP], m)
    none = rng.random(m) < 0.4
    ep = T0 - rng.integers(0, 12_000_000_000, m)
    f[:, lstr.C_EPOCH_HI] = np.where(none, lanes.NEVER32, ep >> 31)
    f[:, lstr.C_EPOCH_LO] = np.where(none, lanes.NEVER32, ep & lanes.MASK31)
    f[:, lstr.C_KQ] = rng.integers(0, 3000, m)
    return f.reshape(2, s, lstr.N_COLS)


def t32(a):
    return torch.as_tensor(np.asarray(a, dtype=np.int32), device=DEV)


def stream_case(eng: GpuEngine, rng):
    """Params, tables and a state for kernel A on stream lanes beside mesh
    lanes: flows in every state, queue heads that open flows, fire owned
    and stale RTOs and carry segments (foreign zero-payload datagrams
    too), loss thresholds 0, 2**31 and 2**32 per endpoint on both sides of
    the bootstrap end, and 2 Mbit up buckets that throttle the bursts."""
    p = dataclasses.replace(eng.params, has_loss=True,
                            bootstrap_end=T0 + 1_500_000, seed=(1 << 64) - 5)
    n, c, k, sf = p.n_lanes, p.capacity, p.pops_per_iter, p.s_flows
    tb = eng.tables
    el = tb.flow_lanes.cpu().numpy()
    clid = tb.flow_clid.cpu().numpy()
    peers = tb.flow_peers.cpu().numpy()
    rate, burst = bucket_params(2_000_000)
    up = {f: getattr(tb, f).cpu().numpy().copy()
          for f in ("up_rate", "up_burst", "up_kfull", "up_kfi")}
    up["up_rate"][el], up["up_burst"][el] = rate, burst
    up["up_kfull"][el] = burst // rate + 1
    up["up_kfi"][el] = (burst // rate + 1) * INTERVAL
    tb = tb._replace(
        **{f: t32(v) for f, v in up.items()},
        **{"flow_" + f: t32(v[el]) for f, v in up.items()},
        flow_thresh=torch.as_tensor(
            rng.choice([0, 1 << 31, 1 << 32], 2 * sf), device=DEV))
    s = random_state(eng, tb, rng)
    # stream lanes' rows: events at T0 + {0..3} ms for the lane's endpoints
    q = {f: getattr(s, f).cpu().numpy().copy()
         for f in ("q_thi", "q_tlo", "q_auxh", "q_auxl", "q_size", "q_phi",
                   "q_plo")}
    flows = stream_flows(rng, sf).reshape(2 * sf, lstr.N_COLS)
    rows_of = {}
    for r, lane in enumerate(el):
        rows_of.setdefault(int(lane), []).append(r)
    for lane, rows in rows_of.items():
        # a few events on two instants per row, the rows' instants on both
        # sides of the bootstrap end
        fill = int(rng.integers(1, 2 * k + 1))
        times = np.full(c, lanes.NEVER, dtype=np.int64)
        auxh = np.zeros(c, np.int64)
        size = np.zeros(c, np.int64)
        phi = np.zeros(c, np.int64)
        plo = np.zeros(c, np.int64)
        times[:fill] = T0 + (int(rng.integers(0, 4)) + rng.integers(
            0, 2, fill)) * 1_000_000
        for x in range(fill):
            r = rows[int(rng.integers(0, len(rows)))]
            what = rng.choice(["start", "rto", "seg", "seg", "foreign", "pkt"])
            if what == "start":
                auxh[x], size[x] = lanes.LOCAL << 29 | lane << 12, -1
            elif what == "rto":
                auxh[x], size[x], plo[x] = (lanes.LOCAL << 29 | lane << 12,
                                            lstr.SZ_RTO, clid[r])
                if rng.random() < 0.5:  # the flow owns this event
                    flows[r, lstr.C_RTOEV_HI], flows[r, lstr.C_RTOEV_LO] = \
                        pairs(times[x])
            else:
                kind = lanes.PACKET if what == "pkt" else lanes.DELIVERY
                src = int(rng.integers(0, n)) if what == "foreign" else int(
                    peers[r])
                auxh[x] = kind << 29 | src << 12
                size[x] = rng.choice([ltcp.HDR_BYTES, ltcp.HDR_BYTES + 1448])
                if what != "foreign":
                    flags = rng.choice([ltcp.F_SYN, ltcp.F_SYN | ltcp.F_ACK,
                                        ltcp.F_ACK, ltcp.F_DATA | ltcp.F_ACK,
                                        ltcp.F_FIN | ltcp.F_ACK])
                    phi[x] = flags << 26 | int(rng.integers(0, 50))
                    plo[x] = flows[r, lstr.C_SND_UNA] + rng.integers(-1, 12)
        auxl = np.arange(c) + int(rng.integers(0, 1 << 20)) * c
        order = np.lexsort((auxl, auxh, times))
        never = times[order] == lanes.NEVER
        q["q_thi"][lane] = np.where(never, lanes.NEVER32, times[order] >> 31)
        q["q_tlo"][lane] = np.where(never, lanes.NEVER32,
                                    times[order] & lanes.MASK31)
        for f, v in (("q_auxh", auxh), ("q_auxl", auxl), ("q_size", size),
                     ("q_phi", phi), ("q_plo", plo)):
            q[f][lane] = v[order]
    s = s._replace(**{f: t32(v) for f, v in q.items()},
                   stream=t32(flows.reshape(2, sf, lstr.N_COLS)))
    return p, tb, s


def star_doc(servers: int = 50, fan_in: int = 4) -> dict:
    """Stars at examples/stream-tcp.yaml's settings (40 ms, 2% loss, 1 MiB
    flows), ``servers`` of them with ``fan_in`` clients each, C=64: the
    star layout at a width where one seeded state reaches every case."""
    doc = presets.stream_tcp_example_doc()
    doc["experimental"] = {"tpu_lane_queue_capacity": 64}
    doc["hosts"] = {}
    for i in range(servers):
        doc["hosts"][f"s{i:03d}"] = {"network_node_id": 1, "processes": [
            {"path": "stream-server"}]}
        for j in range(fan_in):
            doc["hosts"][f"c{i:03d}x{j}"] = {"network_node_id": 0, "processes": [{
                "path": "stream-client",
                "args": ["--server", f"s{i:03d}", "--size", "1MiB"]}]}
    return doc


def sx_counts(p, sx: torch.Tensor) -> dict:
    """Valid control sends, RTO arms and burst segments in a stream block."""
    k, sf = p.pops_per_iter, p.s_flows
    valid = (sx[1] != lanes.NEVER32).cpu()
    return {"sends": int(valid[:2 * k * sf].sum()),
            "rto_arms": int(valid[2 * k * sf:4 * k * sf].sum()),
            "burst_segments": int(valid[4 * k * sf:].sum())}


def random_stream_block(p, ws, rng, n_lanes_hot: int) -> None:
    """A stream block of distinct keys: about half the entries valid, most
    addressed to the first ``n_lanes_hot`` lanes (overflow past Cx)."""
    m = ws.sx_blk.shape[1]
    valid = rng.random(m) < 0.5
    dst = np.where(rng.random(m) < 0.8, rng.integers(0, n_lanes_hot, m),
                   rng.integers(0, p.n_lanes, m))
    arr = T0 + 10_000_000 + rng.integers(0, 30_000_000, m)
    src = rng.integers(0, p.n_lanes, m)
    kind = rng.choice([lanes.PACKET, lanes.LOCAL], m)
    blk = np.stack([
        np.where(valid, dst, p.n_lanes),
        np.where(valid, arr >> 31, lanes.NEVER32),
        np.where(valid, arr & lanes.MASK31, lanes.NEVER32),
        np.where(valid, kind << 29 | src << 12, 0),
        np.where(valid, np.arange(m) + (1 << 25), 0),
        np.where(valid, rng.integers(40, 1500, m), 0),
        np.where(valid, rng.integers(0, 1 << 30, m), 0),
        np.where(valid, rng.integers(0, 1 << 20, m), 0),
    ])
    ws.sx_blk.copy_(t32(blk))


@phase("kernels A, B, E vs plain on seeded stream states (tolerance: exact, "
       "integer)")
def check_stream_kernels():
    rng = np.random.default_rng(SEED + 2)
    # A on the mixed mesh's lanes (one-to-one, wide pop) and on the star of
    # examples/stream-tcp.yaml; logging off and on
    engines = {"mixed": GpuEngine(mixed_mesh(1), log_capacity=0),
               "star": GpuEngine(ConfigOptions.from_dict(star_doc()),
                                 log_capacity=0)}
    for name, eng in engines.items():
        for log_cap in (0, 1_000_000):
            for rep in range(2):
                p, tb, s0 = stream_case(eng, rng)
                p = dataclasses.replace(p, log_capacity=log_cap)
                if log_cap:
                    s0 = s0._replace(log=torch.zeros((log_cap, 6),
                                                     dtype=torch.int64,
                                                     device=DEV))
                ws0 = lanes.make_workspace(p, DEV)
                ws0.ctl[0] = 1
                tag = f"{name} L={log_cap} rep={rep}"
                kern, plain = run_pair(
                    p, tb, s0, ws0, kernels.lane_slots,
                    lambda p_, tb_, s, ws: lanes.lane_slots_plain(p_, tb_, s, ws))
                check("lane_slots", f"stream {tag}", kern, plain)
                moved = int((plain["stream"] != s0.stream).any(dim=2).sum())
                got = sx_counts(p, plain["sx_blk"])
                lost = int((plain["n_loss"] - s0.n_loss).sum())
                throttled = int(((plain["up_ld_hi"] != s0.up_ld_hi)
                                 | (plain["up_ld_lo"] != s0.up_ld_lo)).sum())
                log(f"lane_slots stream {tag}: equal; flow rows changed "
                    f"{moved}, {got}, losses {lost}, up departures moved "
                    f"{throttled}")
                if not (moved and got["sends"] and got["rto_arms"]
                        and got["burst_segments"] and lost):
                    raise AssertionError("stream inputs missed a case")
    # B with the star's stream entries in the exchange, payload words on
    star = engines["star"]
    for log_cap in (0, 100_000):
        p = dataclasses.replace(star.params, log_capacity=log_cap)
        tb = star.tables
        s0 = random_state(star, tb, rng)
        live = s0.q_thi != lanes.NEVER32
        s0 = s0._replace(
            q_phi=torch.where(live, t32(rng.integers(0, 1 << 30, live.shape)), 0),
            q_plo=torch.where(live, t32(rng.integers(0, 1 << 20, live.shape)), 0))
        if log_cap:
            s0 = s0._replace(log=torch.zeros((log_cap, 6), dtype=torch.int64,
                                             device=DEV))
        ws0 = lanes.make_workspace(p, DEV)
        ws0.ctl[0] = 1
        random_exchange(p, ws0, rng)
        ws0.self_blk[5:] = t32(rng.integers(0, 1 << 30, ws0.self_blk[5:].shape))
        random_stream_block(p, ws0, rng, 3)
        kern, plain = run_pair(
            p, tb, s0, ws0, kernels.exchange_merge,
            lambda p_, tb_, s, ws:
                lanes.exchange_merge_plain(p_, tb_, s, ws))
        check("exchange_merge", f"star L={log_cap}", kern, plain)
        shed = int(plain["n_queue"].sum())
        log(f"exchange_merge star L={log_cap}: equal on [C {p.capacity} | self "
            f"{p.self_width} | cross {p.cross_cap}] rows of {p.words} words, "
            f"{ws0.sx_blk.shape[1]} stream entries; shed {shed}")
        if not shed:
            raise AssertionError("star exchange missed the overflow case")
    # E on the mixed mesh: stream lanes' rows nearly full, half the stream
    # block valid, so rows overflow past C
    mixed = engines["mixed"]
    for log_cap in (0, 100_000):
        p = dataclasses.replace(mixed.params, log_capacity=log_cap)
        tb = mixed.tables
        s0 = random_state(mixed, tb, rng)
        if log_cap:
            s0 = s0._replace(log=torch.zeros((log_cap, 6), dtype=torch.int64,
                                             device=DEV))
        ws0 = lanes.make_workspace(p, DEV)
        ws0.ctl[0] = 1
        random_stream_block(p, ws0, rng, p.n_lanes)
        kern, plain = run_pair(
            p, tb, s0, ws0, kernels.stream_rows_merge,
            lambda p_, tb_, s, ws: lanes.stream_rows_merge_plain(p_, tb_, s, ws))
        check("stream_rows_merge", f"L={log_cap}", kern, plain)
        el = tb.flow_lanes.long()
        shed = int(plain["n_queue"][el].sum() - s0.n_queue[el].sum())
        log(f"stream_rows_merge L={log_cap}: equal on {2 * p.s_flows} rows of "
            f"[C {p.capacity} | W_s {p.stream_row_width}] x {p.words} words; "
            f"overflow {shed}")
        if not shed:
            raise AssertionError("stream rows missed the overflow case")


# ---- seeded tier states ----------------------------------------------------


def mixed_tiered(sim_seconds=5):
    """``mixed_flagship_config(10000)`` exactly as the preset defines it (the
    JAX package's north-star tuning): 9,800 tgen-mesh hosts and 100
    one-to-one stream pairs of 2,000,000 bytes, tiered, C=16, K=2, Cx=8,
    K_s=16, C2=64."""
    return presets.mixed_flagship_config(N_FLAG, sim_seconds=sim_seconds)


def tier_case(eng: GpuEngine, rng, wide: bool, log_cap: int):
    """Params, tables and a state for kernels F and G at the tiered mixed
    mesh's shape (2S = 200 endpoint rows, C2 = 64, K_s = 16) beside random
    [N] lanes: flows in every state; rows mixing stream segments (PACKET
    and DELIVERY), foreign datagrams and LOCALs (client opens, owned and
    stale RTOs) at instants on both sides of the window end (T0 + 3 ms) and
    of the bootstrap end (T0 + 1.5 ms), some rows full (overflow past C2);
    20 Mbit down buckets whose last departures make packets wait past the
    window end and past CoDel's target, CoDel states that drop, 2 Mbit up
    buckets that throttle the bursts, loss thresholds 0, 2**31 and 2**32
    per endpoint; ``stream_wide_pop`` as given."""
    p = dataclasses.replace(eng.params, has_loss=True,
                            bootstrap_end=T0 + 1_500_000, seed=(1 << 64) - 7,
                            stream_wide_pop=wide, log_capacity=log_cap)
    sf, c2, n = p.s_flows, p.stream_capacity, p.n_lanes
    s2 = 2 * sf
    el = eng.tables.flow_lanes.cpu().numpy()
    clid = eng.tables.flow_clid.cpu().numpy()
    peers = eng.tables.flow_peers.cpu().numpy()

    def bucket(bw):
        rate, burst = bucket_params(bw)
        kf = burst // rate + 1
        return [t32(np.full(s2, x)) for x in (rate, burst, kf, kf * INTERVAL)]

    up, dn = bucket(2_000_000), bucket(20_000_000)
    tb = eng.tables._replace(
        flow_up_rate=up[0], flow_up_burst=up[1], flow_up_kfull=up[2],
        flow_up_kfi=up[3], flow_dn_rate=dn[0], flow_dn_burst=dn[1],
        flow_dn_kfull=dn[2], flow_dn_kfi=dn[3],
        flow_thresh=torch.as_tensor(rng.choice([0, 1 << 31, 1 << 32], s2),
                                    device=DEV))
    s = random_state(eng, tb, rng)
    if log_cap:
        s = s._replace(log=torch.zeros((log_cap, 6), dtype=torch.int64,
                                       device=DEV))
    flows = stream_flows(rng, sf).reshape(s2, lstr.N_COLS)
    times = np.full((s2, c2), lanes.NEVER, dtype=np.int64)
    words = np.zeros((5, s2, c2), dtype=np.int64)  # auxh, auxl, size, phi, plo
    fill = rng.choice([0, 1, 3, p.stream_pops, 24, c2 - 2, c2], s2)
    for r in range(s2):
        m = int(fill[r])
        lane = int(el[r])
        times[r, :m] = (T0 + int(rng.integers(0, 4)) * 1_000_000
                        + rng.integers(0, 5, m) * 500_000)
        words[1, r, :m] = np.arange(m) + int(rng.integers(0, 1 << 20)) * c2
        for x in range(m):
            what = rng.choice(["start", "rto", "seg", "seg", "seg", "foreign"])
            if what == "start":
                words[0, r, x] = lanes.LOCAL << 29 | lane << 12
                words[2, r, x] = -1
            elif what == "rto":
                words[0, r, x] = lanes.LOCAL << 29 | lane << 12
                words[2, r, x] = lstr.SZ_RTO
                words[4, r, x] = clid[r] if rng.random() < 0.8 else clid[r] + 1
                if rng.random() < 0.5:  # the flow owns this event
                    flows[r, lstr.C_RTOEV_HI], flows[r, lstr.C_RTOEV_LO] = \
                        pairs(times[r, x])
            elif what == "seg":
                kind = lanes.PACKET if rng.random() < 0.6 else lanes.DELIVERY
                words[0, r, x] = kind << 29 | int(peers[r]) << 12
                words[2, r, x] = rng.choice([ltcp.HDR_BYTES,
                                             ltcp.HDR_BYTES + 1448])
                flags = rng.choice([ltcp.F_SYN, ltcp.F_SYN | ltcp.F_ACK,
                                    ltcp.F_ACK, ltcp.F_DATA | ltcp.F_ACK,
                                    ltcp.F_FIN | ltcp.F_ACK])
                words[3, r, x] = flags << 26 | int(rng.integers(0, 50))
                words[4, r, x] = (flows[r, lstr.C_SND_UNA]
                                  + rng.integers(-1, 12))
            else:  # a datagram of the mesh: no payload
                src = int(rng.integers(0, n))
                words[0, r, x] = lanes.PACKET << 29 | src << 12
                words[2, r, x] = rng.integers(28, 1500)
    order = np.lexsort((words[1], words[0], times), axis=1)
    times = np.take_along_axis(times, order, axis=1)
    words = np.stack([np.take_along_axis(w, order, axis=1) for w in words])
    never = times == lanes.NEVER
    q = np.concatenate([
        np.stack([np.where(never, lanes.NEVER32, times >> 31),
                  np.where(never, lanes.NEVER32, times & lanes.MASK31)]),
        words])
    v = np.zeros((lstr.TV_COUNT, s2), dtype=np.int64)
    grid = T0 // INTERVAL
    for row, burst in ((lstr.TV_DN_TOK, int(dn[1][0])),
                       (lstr.TV_UP_TOK, int(up[1][0]))):
        v[row] = rng.integers(0, burst + 1, s2)
        v[row + 1], v[row + 2] = pairs(
            INTERVAL * (grid + rng.choice([-200, -3, 0, 5], s2)))
        v[row + 3], v[row + 4] = pairs(
            T0 + rng.choice([0, 0, 1_000_000, 30_000_000], s2))
    unset = rng.random(s2) < 0.3
    fat = T0 + rng.integers(-200_000_000, 0, s2)
    v[lstr.TV_CD_FATH] = np.where(unset, lanes.CD_UNSET, fat >> 31)
    v[lstr.TV_CD_FATL] = np.where(unset, 0, fat & lanes.MASK31)
    v[lstr.TV_CD_DNH], v[lstr.TV_CD_DNL] = pairs(
        T0 + rng.integers(-200_000_000, 50_000_000, s2))
    v[lstr.TV_CD_CNT] = rng.integers(0, 1100, s2)
    v[lstr.TV_CD_DROP] = rng.integers(0, 2, s2)
    v[lstr.TV_SEND_SEQ] = rng.integers(0, 1 << 20, s2)
    v[lstr.TV_LOCAL_SEQ] = rng.integers(0, 1 << 20, s2)
    for row in (lstr.TV_N_SENDS, lstr.TV_N_LOSS, lstr.TV_N_DEL,
                lstr.TV_N_CODEL):
        v[row] = rng.integers(0, 1000, s2)
    we = T0 + 3_000_000
    tier = lstr.TierState(flows=t32(flows.reshape(2, sf, lstr.N_COLS)),
                          q=t32(q), v=t32(v))
    return p, tb, s._replace(
        stream=tier, now_we_hi=t32(we >> 31).reshape(()),
        now_we_lo=t32(we & lanes.MASK31).reshape(()),
        min_used_lat=t32(rng.choice([lanes.NEVER32, 5_000_000])).reshape(()))


def tier_cross_block(p, ws, rng) -> int:
    """Diverted mesh datagrams in the tier block's cross channel: up to Cx
    per endpoint row, arriving after the window; returns how many."""
    cx0, end = p.tier_layout[3:]
    s2, cx = 2 * p.s_flows, p.cross_cap
    valid = np.arange(cx)[None, :] < rng.integers(0, cx + 1, (s2, 1))
    arr = T0 + 10_000_000 + rng.integers(0, 30_000_000, (s2, cx))
    src = rng.integers(0, p.n_lanes, (s2, cx))
    blk = np.stack([
        np.where(valid, arr >> 31, lanes.NEVER32),
        np.where(valid, arr & lanes.MASK31, lanes.NEVER32),
        np.where(valid, lanes.PACKET << 29 | src << 12, 0),
        np.where(valid, np.arange(s2 * cx).reshape(s2, cx) + (1 << 25), 0),
        np.where(valid, rng.integers(28, 1500, (s2, cx)), 0),
        np.zeros((s2, cx)), np.zeros((s2, cx)),
    ]).reshape(7, s2 * cx)
    ws.tier_blk[:, cx0:end] = t32(blk)
    return int(valid.sum())


def tier_counts(p, s0, plain) -> dict:
    """What kernel F did, from its plain version's outputs."""
    v0, v1 = s0.stream.v, plain["stream.v"]
    blk = plain["tier_blk"][0] != lanes.NEVER32
    sa0, se0, bo0, cx0, _end = p.tier_layout
    out = {name: int((v1[row] - v0[row]).sum()) for name, row in (
        ("delivered", lstr.TV_N_DEL), ("codel_drops", lstr.TV_N_CODEL),
        ("losses", lstr.TV_N_LOSS), ("sends", lstr.TV_N_SENDS))}
    out.update(fallbacks=int(blk[:sa0].sum()),
               rto_arms=int(blk[sa0:se0].sum()),
               control_sends=int(blk[se0:bo0].sum()),
               burst_segments=int(blk[bo0:cx0].sum()))
    out["elided"] = out["delivered"] - out["fallbacks"]
    moved = ((v1[lstr.TV_UP_LDH] != v0[lstr.TV_UP_LDH])
             | (v1[lstr.TV_UP_LDL] != v0[lstr.TV_UP_LDL]))
    out["throttled"] = int(moved.sum())
    out["popped"] = int((plain["stream.q"][0, :, :p.stream_pops]
                         != s0.stream.q[0, :, :p.stream_pops]).sum())
    return out


@phase("kernels F, G and the tiered B, C, D vs plain on seeded tier states, "
       "the tiered mixed mesh's shapes (tolerance: exact, integer)")
def check_tier_kernels():
    rng = np.random.default_rng(SEED + 3)
    eng = GpuEngine(mixed_tiered(1), log_capacity=0)
    for wide in (True, False):
        seen = dict.fromkeys(("delivered", "codel_drops", "losses", "sends",
                              "fallbacks", "rto_arms", "control_sends",
                              "burst_segments", "throttled", "elided"), 0)
        for log_cap in (0, 200_000):
            for rep in range(2):
                p, tb, s0 = tier_case(eng, rng, wide, log_cap)
                ws0 = lanes.make_workspace(p, DEV)
                ws0.ctl[0] = 1
                tag = f"wide={wide} L={log_cap} rep={rep}"
                kern, plain = run_pair(p, tb, s0, ws0, kernels.stream_tier,
                                       lanes.stream_tier_plain)
                check("stream_tier", tag, kern, plain)
                got = tier_counts(p, s0, plain)
                log(f"stream_tier {tag}: equal on {2 * p.s_flows} rows x K_s "
                    f"{p.stream_pops}; {got}")
                for k in seen:
                    seen[k] += got[k]

                # G on the state F left, with diverted cross entries
                s1, ws1 = clone(s0), clone(ws0)
                lanes.stream_tier_plain(p, tb, s1, ws1)
                n_cross = tier_cross_block(p, ws1, rng)
                kern, plain = run_pair(p, tb, s1, ws1, kernels.tier_merge,
                                       lanes.tier_merge_plain)
                check("tier_merge", tag, kern, plain)
                over = int((plain["stream.v"][lstr.TV_N_QUEUE]
                            - s1.stream.v[lstr.TV_N_QUEUE]).sum())
                log(f"tier_merge {tag}: equal on {2 * p.s_flows} rows of "
                    f"[C2 {p.stream_capacity} | W_t {p.tier_width}] x 7 "
                    f"words; cross entries {n_cross}, overflow {over}")
                if not (over and n_cross):
                    raise AssertionError("tier merge missed a case")
            # D on a tiered logging iteration's records, every group filled
            if log_cap:
                s1, ws1 = clone(s0), clone(ws0)
                for fn in (lanes.lane_slots_plain, lanes.exchange_merge_plain,
                           lanes.stream_tier_plain, lanes.tier_merge_plain):
                    fn(p, tb, s1, ws1)
                for start in (0, log_cap - 5):
                    s1.log_count.fill_(start)
                    kern, plain = run_pair(
                        p, tb, s1, ws1, kernels.append_log,
                        lambda p_, tb_, s, ws:
                            lanes.append_log_plain(p_, s, ws))
                    check("append_log", f"tiered {tag} start={start}", kern,
                          plain)
                tg = p.tier_rec_offsets
                groups = [int(ws1.rec_valid[a:b].sum()) for a, b in (
                    (0, tg.rec), (tg.rec, tg.tail), (tg.tail, tg.end),
                    (tg.end, p.n_records))]
                log(f"append_log tiered {tag}: equal; valid records by group "
                    f"([N] tail, tier slots, tier tail, [N] slots) {groups}")
                if not all(groups[1:]):
                    raise AssertionError("tier record groups missed a case")
        # every case, and elision exactly under the wide pop rule
        if not all(v > 0 for k, v in seen.items() if k != "elided") or (
                (seen["elided"] > 0) != wide):
            raise AssertionError(f"tier inputs missed a case: {seen}")
    # B's divert and C's tier minimum on tiered states
    for log_cap in (0, 100_000):
        p, tb, s0 = tier_case(eng, rng, True, log_cap)
        ws0 = lanes.make_workspace(p, DEV)
        ws0.ctl[0] = 1
        random_exchange(p.lane, ws0, rng)
        kern, plain = run_pair(
            p, tb, s0, ws0, kernels.exchange_merge,
            lambda p_, tb_, s, ws:
                lanes.exchange_merge_plain(p_, tb_, s, ws))
        check("exchange_merge", f"tiered L={log_cap}", kern, plain)
        cx0, end = p.tier_layout[3:]
        diverted = int((plain["tier_blk"][0, cx0:end] != lanes.NEVER32).sum())
        log(f"exchange_merge tiered L={log_cap}: equal; {diverted} cross "
            "entries diverted to the tier")
        if not diverted:
            raise AssertionError("the divert missed a case")
        for tier_first in (False, True):
            s1 = clone(s0)
            if tier_first:  # one tier row's head below every lane's
                t = T0 - 5_000_000
                s1.stream.q[0, 7, 0] = t >> 31
                s1.stream.q[1, 7, 0] = t & lanes.MASK31
            for advance in (False, True):
                kern, plain = run_pair(
                    p, tb, s1, ws0,
                    lambda a, adv=advance: kernels.queue_min_window(a, adv),
                    lambda p_, tb_, s, ws, adv=advance:
                        lanes.queue_min_window_plain(p_, s, ws, adv))
                check("queue_min_window", f"tiered tier_first={tier_first} "
                      f"adv={advance}", kern, plain)
                head = (int(plain["ctl"][2]) << 31) | int(plain["ctl"][3])
                if tier_first and head != T0 - 5_000_000:
                    raise AssertionError("the tier head was not the minimum")
        log("queue_min_window tiered: equal, the tier's heads included")



# ---- the observation planes: pcap and netobs ---------------------------------

# where the planes' runs write their capture files (a temporary directory,
# removed at the end)
# the runs' data directories (set by main: a spawned worker process of the
# multiprocess hybrid engine imports this module again, and must create and
# touch nothing — the card least of all)
DATA = None
HIST_TOP = 1 << 23  # a window count in the histogram's last bucket


def planes(cfg, tag: str, mesh_hosts: int = 100):
    """``cfg`` with netobs on and pcap on every stream endpoint and the first
    ``mesh_hosts`` tgen-mesh hosts, writing under ``DATA/tag``.  The files
    keep each packet's first 128 bytes (``pcap_capture_size``, as
    ``tcpdump -s 128`` would): the full-width 1 s run writes several
    hundred thousand records."""
    cfg.experimental.netobs = True
    cfg.general.data_directory = f"{DATA}/{tag}"
    for h in cfg.hosts:
        path = h.processes[0].path if h.processes else ""
        h.pcap_enabled = path.startswith("stream-") or (
            path == "tgen-mesh" and mesh_hosts > 0)
        h.pcap_capture_size = 128
        mesh_hosts -= path == "tgen-mesh"
    return cfg


def pcap_files(data) -> dict:
    return {p.parent.name: p.read_bytes()
            for p in sorted(Path(data).glob("hosts/*/eth0.pcap"))}


def pcap_records(blob: bytes) -> int:
    """Records of a capture file (24-byte header, 16-byte record headers)."""
    off, count = 24, 0
    while off < len(blob):
        off += 16 + int.from_bytes(blob[off + 8:off + 12], "big")
        count += 1
    return count


def seed_planes(p, tb, s, rng):
    """Tables and state with the planes seeded: about half the lanes and
    endpoint rows capture; the nb_* counters, the histogram and the tier's
    TV_NB_* rows hold random counts."""
    n, el = p.n_lanes, tb.flow_lanes.long().cpu()
    lane_pcap = torch.as_tensor(rng.random(n) < 0.5)
    tb = tb._replace(lane_pcap=lane_pcap.to(DEV),
                     flow_pcap=lane_pcap[el].to(DEV))
    nb = {f: t32(rng.integers(0, 1 << 24, n))
          for f in ("nb_txb", "nb_rxb", "nb_thr", "nb_shed")}
    s = s._replace(**nb, nb_hist=t32(rng.integers(0, 100, 24)),
                   nb_win=t32(rng.integers(0, 1 << 16)).reshape(()))
    if p.stream_tiered:
        s.stream.v[lstr.TV_NB_TXB:] = t32(rng.integers(
            0, 1 << 24, (3, 2 * p.s_flows)))
    return tb, s


def with_log(s, log_cap: int):
    """``s`` with an empty log of ``log_cap`` rows (one when logging is
    off), where the engine that made it keeps another."""
    return s._replace(log=torch.zeros((max(log_cap, 1), 6), dtype=torch.int64,
                                      device=DEV))


def throttling(eng, tb, rng):
    """``tb`` with random_tables' [N] buckets (2 Mbit to 1 Gbit, waits on
    both sides)."""
    r = random_tables(eng, rng)
    return tb._replace(**{f: getattr(r, f) for f in (
        "up_rate", "up_burst", "up_kfull", "up_kfi", "dn_rate", "dn_burst",
        "dn_kfull", "dn_kfi")})


def pcap_rows(p, ws, lo: int, hi: int, capture) -> tuple:
    """(valid PCAP_TX rows in record slots [lo, hi), those from lanes that
    do not capture)."""
    valid = ws["rec_valid"][lo:hi].bool()
    rows = ws["recs"][lo:hi][valid]
    if rows.numel() and not bool((rows[:, 5] == 4).all()):
        raise AssertionError("a pcap record slot holds another outcome")
    return int(valid.sum()), int((~capture[rows[:, 1].long().cpu()]).sum())


@phase("kernels A, B, C, D, F vs plain with the pcap and netobs planes on "
       "(tolerance: exact, integer)")
def check_plane_kernels():
    rng = np.random.default_rng(SEED + 4)
    seen = dict.fromkeys(("nb_thr_lanes", "codel", "nb_rxb", "nb_txb", "nb_shed",
                          "pc_rows", "pc_not_capturing_senders",
                          "tier_thr", "tier_rxb", "tier_txb", "tier_pc_rows",
                          "stream_pc_rows", "phold_pc_rows", "win_popped"), 0)
    # the tiered mixed mesh's shapes: A on its [N] lanes, B with sheds, F,
    # G, C's window flush, D on every record group
    eng = GpuEngine(planes(mixed_tiered(1), "check"), log_capacity=200_000)
    for wide in (True, False):
        for log_cap in (0, 200_000):
            p, tb, s0 = tier_case(eng, rng, wide, log_cap)
            tb = throttling(eng, tb, rng)
            tb, s0 = seed_planes(p, tb, with_log(s0, log_cap), rng)
            ws0 = lanes.make_workspace(p, DEV)
            ws0.ctl[0] = 1
            tag = f"planes wide={wide} L={log_cap}"
            kern, plain = run_pair(p, tb, s0, ws0, kernels.lane_slots,
                                   lanes.lane_slots_plain)
            check("lane_slots", tag, kern, plain)
            seen["nb_thr_lanes"] += int((plain["nb_thr"] != s0.nb_thr).sum())
            seen["codel"] += int((plain["n_codel"] - s0.n_codel).sum())
            seen["nb_rxb"] += int((plain["nb_rxb"] - s0.nb_rxb).sum())
            seen["nb_txb"] += int((plain["nb_txb"] - s0.nb_txb).sum())
            seen["win_popped"] += int(plain["nb_win"] - s0.nb_win)
            if log_cap:
                rg = p.rec_offsets
                rows, foreign = pcap_rows(p, plain, rg.pc, rg.spc,
                                          tb.lane_pcap.cpu())
                if foreign:
                    raise AssertionError("a lane that does not capture did")
                sent = (plain["out_blk"][0] != p.n_lanes).reshape(-1)
                cap = tb.lane_pcap.repeat(p.pops_per_iter)
                seen["pc_rows"] += rows
                seen["pc_not_capturing_senders"] += int((sent & ~cap).sum())

            s1, ws1 = clone(s0), clone(ws0)
            lanes.lane_slots_plain(p, tb, s1, ws1)
            random_exchange(p.lane, ws1, rng)
            kern, plain = run_pair(p, tb, s1, ws1, kernels.exchange_merge,
                                   lanes.exchange_merge_plain)
            check("exchange_merge", tag, kern, plain)
            seen["nb_shed"] += int((plain["nb_shed"] - s1.nb_shed).sum())

            lanes.exchange_merge_plain(p, tb, s1, ws1)
            kern, plain = run_pair(p, tb, s1, ws1, kernels.stream_tier,
                                   lanes.stream_tier_plain)
            check("stream_tier", tag, kern, plain)
            v0, v1 = s1.stream.v, plain["stream.v"]
            seen["tier_thr"] += int((v1[lstr.TV_NB_THR] - v0[lstr.TV_NB_THR]).sum())
            seen["tier_rxb"] += int((v1[lstr.TV_NB_RXB] - v0[lstr.TV_NB_RXB]).sum())
            seen["tier_txb"] += int((v1[lstr.TV_NB_TXB] - v0[lstr.TV_NB_TXB]).sum())
            seen["win_popped"] += int(plain["nb_win"] - s1.nb_win)
            if log_cap:
                tg = p.tier_rec_offsets
                rows, foreign = pcap_rows(p, plain, tg.spc, tg.tail,
                                          tb.lane_pcap.cpu())
                if foreign:
                    raise AssertionError("a tier row that does not capture did")
                seen["tier_pc_rows"] += rows

            lanes.stream_tier_plain(p, tb, s1, ws1)
            kern, plain = run_pair(p, tb, s1, ws1, kernels.tier_merge,
                                   lanes.tier_merge_plain)
            check("tier_merge", tag, kern, plain)
            if log_cap:
                lanes.tier_merge_plain(p, tb, s1, ws1)
                for start in (0, log_cap - 7):
                    s1.log_count.fill_(start)
                    kern, plain = run_pair(
                        p, tb, s1, ws1, kernels.append_log,
                        lambda p_, tb_, s, ws: lanes.append_log_plain(p_, s, ws))
                    check("append_log", f"{tag} start={start}", kern, plain)
            log(f"{tag}: A, B, F, G{', D' if log_cap else ''} equal; {seen}")

            # C: a window advance folds the count, 0 and past 2**23 included
            # (a stop past the states' times, so the run is live)
            pc = dataclasses.replace(p, stop_time=2 * T0)
            for count in (0, 1, 12_345, HIST_TOP + 5, (1 << 30) + 1):
                for advance in (False, True):
                    s2 = clone(s0)
                    s2.nb_win.fill_(count)
                    we = T0 - 10_000_000  # every head lies past the window
                    s2.now_we_hi.fill_(we >> 31)
                    s2.now_we_lo.fill_(we & lanes.MASK31)
                    kern, plain = run_pair(
                        pc, tb, s2, ws0,
                        lambda a, adv=advance: kernels.queue_min_window(a, adv),
                        lambda p_, tb_, s, ws, adv=advance:
                            lanes.queue_min_window_plain(p_, s, ws, adv))
                    check("queue_min_window", f"{tag} count={count} "
                          f"adv={advance}", kern, plain)
                    moved = (plain["nb_hist"] - s2.nb_hist).nonzero().flatten()
                    want = ([] if not (advance and count) else
                            [min(count.bit_length() - 1, 23)])
                    if moved.tolist() != want or (
                            int(plain["nb_win"]) != (0 if want else count)):
                        raise AssertionError(
                            f"window flush of {count}: buckets {moved.tolist()}")
    # A at the PHOLD shapes: active lanes beside passive ones, the loss draw
    eng_p = GpuEngine(every_other(phold_doc(stop_time="1s")),
                      log_capacity=1_000_000)
    for log_cap in (0, 1_000_000):
        for dyn in (False, True):
            p = dataclasses.replace(active_params(eng_p, dyn), log_capacity=log_cap)
            tb = active_tables(eng_p, rng)
            s0 = active_state(eng_p, tb, rng)
            tb, s0 = seed_planes(p, tb, with_log(s0, log_cap), rng)
            ws0 = lanes.make_workspace(p, DEV)
            ws0.ctl[0] = 1
            kern, plain = run_pair(p, tb, s0, ws0, kernels.lane_slots,
                                   lanes.lane_slots_plain)
            check("lane_slots", f"planes phold L={log_cap} dyn={dyn}", kern, plain)
            if log_cap:
                rg = p.rec_offsets
                rows, foreign = pcap_rows(p, plain, rg.pc, rg.spc,
                                          tb.lane_pcap.cpu())
                if foreign:
                    raise AssertionError("a phold lane that does not capture did")
                seen["phold_pc_rows"] += rows
    # A's stream arm on the untiered mixed mesh's lanes
    eng_u = GpuEngine(planes(mixed_mesh(1), "check-untiered"),
                      log_capacity=1_000_000)
    for log_cap in (0, 1_000_000):
        p, tb, s0 = stream_case(eng_u, rng)
        p = dataclasses.replace(p, log_capacity=log_cap)
        tb, s0 = seed_planes(p, tb, with_log(s0, log_cap), rng)
        ws0 = lanes.make_workspace(p, DEV)
        ws0.ctl[0] = 1
        kern, plain = run_pair(p, tb, s0, ws0, kernels.lane_slots,
                               lanes.lane_slots_plain)
        check("lane_slots", f"planes stream L={log_cap}", kern, plain)
        if log_cap:
            rg = p.rec_offsets
            rows, foreign = pcap_rows(p, plain, rg.spc, rg.srec,
                                      tb.lane_pcap.cpu())
            if foreign:
                raise AssertionError("an endpoint that does not capture did")
            seen["stream_pc_rows"] += rows
    log(f"planes: every kernel equal; {seen}")
    if not all(seen.values()):
        raise AssertionError(f"the planes' inputs missed a case: {seen}")



# ---- flowtrace: A's, B's and E's flow records, D's ring -------------------------

FLOW_SAMPLES = (1.0, 0.5, 0.0)


def traced(p: lanes.LaneParams, sample: float, cap: int = 1 << 16):
    """``p`` with flowtrace on at ``sample`` (the engines' sampling law,
    seeded) and a ring of ``cap`` rows."""
    thresh, every = ftr.sample_thresh(sample)
    return dataclasses.replace(p, flowtrace=True, flow_capacity=cap,
                               flow_thresh=thresh, flow_all=every,
                               flow_seed=SEED)


def with_ring(s, cap: int):
    """``s`` with an empty flowtrace ring of ``cap`` rows."""
    return s._replace(
        fl_buf=torch.zeros((cap, ftr.FT_COLS), dtype=torch.int32, device=DEV),
        fl_count=t32(0).reshape(()), fl_lost=t32(0).reshape(()))


def flow_seen(p, ws: dict) -> dict:
    """The valid flow records of a workspace by group and kind: B's and E's
    queue sheds, A's sends, waits, losses, CoDel drops, deliveries and
    retransmits."""
    fg = p.flow_offsets
    valid = ws["fl_valid"].bool()
    recs = ws["fl_recs"]
    kind, aux = recs[:, 2], recs[:, 7]
    a = valid.clone()
    a[:fg.slots] = False

    def n(m):
        return int(m.sum())

    return {"b_sheds": n(valid[:fg.split]), "e_sheds": n(valid[fg.split:fg.slots]),
            "sends": n(a & (kind == ftr.FT_SEND)),
            "retransmits": n(a & (kind == ftr.FT_RETRANSMIT)),
            "up_waits": n(a & (kind == ftr.FT_TB_WAIT) & (aux == ftr.TB_UP)),
            "dn_waits": n(a & (kind == ftr.FT_TB_WAIT) & (aux == ftr.TB_DN)),
            "losses": n(a & (kind == ftr.FT_DROP) & (aux == ftr.CAUSE_LOSS)),
            "codel": n(a & (kind == ftr.FT_DROP) & (aux == ftr.CAUSE_CODEL)),
            "deliveries": n(a & (kind == ftr.FT_DELIVERY)),
            "queue_enters": n(a & (kind == ftr.FT_QUEUE_ENTER))}


@phase("kernels A, B, D, E vs plain with flowtrace on, samples 1, 0.5 and 0 "
       "(tolerance: exact, integer)")
def check_flow_kernels():
    rng = np.random.default_rng(SEED + 5)
    seen = {}
    eng_f = GpuEngine(flagship(), log_capacity=0)
    eng_a = GpuEngine(phold(stop_time="1s"), log_capacity=0)
    eng_s = GpuEngine(mixed_mesh(1), log_capacity=0)

    def note(tag: str, p, plain: dict, s0=None) -> None:
        got = flow_seen(p, plain)
        if s0 is not None:  # the sends A made, traced or not
            got["made"] = int((plain["n_sends"] - s0.n_sends).sum())
        for k, v in got.items():
            seen[(k, sample)] = seen.get((k, sample), 0) + v
        log(f"flows {tag}: equal; {got}")

    for sample in FLOW_SAMPLES:
        # A at the flagship shapes (bucket waits on both sides, CoDel
        # drops), then B on exchange blocks past C and past Cx
        p = traced(eng_f.params, sample)
        tb = random_tables(eng_f, rng)
        s0 = with_ring(random_state(eng_f, tb, rng), p.flow_capacity)
        ws0 = lanes.make_workspace(p, DEV)
        ws0.ctl[0] = 1
        kern, plain = run_pair(p, tb, s0, ws0, kernels.lane_slots,
                               lanes.lane_slots_plain)
        check("lane_slots", f"flows flagship sample={sample}", kern, plain)
        note(f"A flagship sample={sample}", p, plain, s0)
        random_exchange(p, ws0, rng)
        kern, plain = run_pair(p, tb, s0, ws0, kernels.exchange_merge,
                               lanes.exchange_merge_plain)
        check("exchange_merge", f"flows sample={sample}", kern, plain)
        note(f"B flagship sample={sample}", p, plain)
        # A on active lanes: phold and ping sends, losses at the draw
        pa = traced(active_params(eng_a, False), sample)
        tba = active_tables(eng_a, rng)
        sa = with_ring(active_state(eng_a, tba, rng), pa.flow_capacity)
        wsa = lanes.make_workspace(pa, DEV)
        wsa.ctl[0] = 1
        kern, plain = run_pair(pa, tba, sa, wsa, kernels.lane_slots,
                               lanes.lane_slots_plain)
        check("lane_slots", f"flows active sample={sample}", kern, plain)
        note(f"A active sample={sample}", pa, plain, sa)
        # A's stream arm (retransmits: pull-backs and re-streamed bursts),
        # then E on nearly full stream rows
        ps, tbs, ss = stream_case(eng_s, rng)
        ps = traced(ps, sample)
        ss = with_ring(ss, ps.flow_capacity)
        wss = lanes.make_workspace(ps, DEV)
        wss.ctl[0] = 1
        kern, plain = run_pair(ps, tbs, ss, wss, kernels.lane_slots,
                               lanes.lane_slots_plain)
        check("lane_slots", f"flows stream sample={sample}", kern, plain)
        note(f"A stream sample={sample}", ps, plain, ss)
        se = with_ring(random_state(eng_s, tbs, rng), ps.flow_capacity)
        random_stream_block(ps, wss, rng, ps.n_lanes)
        kern, plain = run_pair(ps, tbs, se, wss, kernels.stream_rows_merge,
                               lanes.stream_rows_merge_plain)
        check("stream_rows_merge", f"flows sample={sample}", kern, plain)
        note(f"E sample={sample}", ps, plain)
    # D: the ring alone, and beside the log in one launch; filling from 0,
    # and overflowing in the middle of the iteration's rows
    lost = 0
    for log_cap in (0, 100_000):
        p = dataclasses.replace(traced(eng_s.params, 1.0, cap=400_000),
                                log_capacity=log_cap)
        ws0 = lanes.make_workspace(p, DEV)
        ws0.ctl[0] = 1
        n_fl = ws0.fl_valid.numel()
        ws0.fl_valid.copy_(t32(rng.random(n_fl) < 0.3))
        ws0.fl_recs.copy_(t32(rng.integers(-(1 << 31), 1 << 31, (n_fl, 8))))
        if log_cap:
            n_rec = ws0.rec_valid.numel()
            ws0.rec_valid.copy_(t32(rng.random(n_rec) < 0.3))
            ws0.recs.copy_(torch.as_tensor(
                rng.integers(0, 1 << 40, (n_rec, 6)), device=DEV))
        s0 = with_log(with_ring(random_state(eng_s, eng_s.tables, rng),
                                p.flow_capacity), log_cap)
        for start in (0, p.flow_capacity - 50_000):
            s1 = clone(s0)
            s1.fl_count.fill_(start)
            s1.log_count.fill_(start % max(log_cap, 1))
            kern, plain = run_pair(
                p, eng_s.tables, s1, ws0, kernels.append_log,
                lambda p_, tb_, s, ws: lanes.append_log_plain(p_, s, ws))
            check("append_log", f"ring L={log_cap} start={start}", kern, plain)
            lost += int(plain["fl_lost"])
            log(f"append_log ring L={log_cap} start={start}: equal; kept "
                f"{min(int(plain['fl_count']), p.flow_capacity) - start}, "
                f"lost {int(plain['fl_lost'])} of {n_fl} slots")
    want = ("b_sheds", "e_sheds", "sends", "retransmits", "up_waits",
            "dn_waits", "losses", "codel", "deliveries", "queue_enters")
    log(f"flows: every kernel equal; seen {seen}, ring lost {lost}")
    missed = [k for k in want if not seen[(k, 1.0)]]
    if missed or not lost:
        raise AssertionError(f"the flow inputs missed {missed or 'overflow'}")
    if any(seen[(k, 0.0)] for k in want):
        raise AssertionError("sample 0 recorded events")

    def traced_sends(x):
        return seen[("sends", x)] + seen[("retransmits", x)]

    # every send made is traced at sample 1, some at 0.5
    if traced_sends(1.0) != seen[("made", 1.0)]:
        raise AssertionError("sample 1 missed sends")
    if not 0 < traced_sends(0.5) < seen[("made", 0.5)]:
        raise AssertionError("sample 0.5 did not trace a strict subset")


def every_other(doc: dict, capture=None) -> ConfigOptions:
    """The config with netobs on and pcap at the hosts named in
    ``capture``, or at every other host."""
    cfg = ConfigOptions.from_dict(doc)
    cfg.experimental.netobs = True
    for i, h in enumerate(cfg.hosts):
        h.pcap_enabled = (h.hostname in capture if capture else i % 2 == 0)
    return cfg


# tests/test_torch_obs.py's configurations (test_telemetry.py's and
# test_pcap.py's), with both planes on: name -> config builder
PLANE_PARITY = {
    # the drop-heavy mesh at its own C = Cx = 2048: B's rows of 4,104
    # entries (90 KB) merge in opted-in shared memory
    "drop_heavy": lambda: every_other(drop_heavy_doc()),
    "lossy_stream": lambda: every_other({
        **_stream_pair_doc(loss=0.02, tiered=True, latency="10 ms",
                           size="400000"),
        "general": {"stop_time": "6s", "seed": 5, "bootstrap_end_time": "100ms"},
    }, ("c", "s")),
    "phold": lambda: every_other({
        "general": {"stop_time": "500ms", "seed": 3},
        "hosts": {"n": {"count": 8, "processes": [
            {"path": "phold", "args": "--messages 3 --size 600"}]}}}),
    "mixed_tiered": lambda: half_second(planes(
        presets.mixed_flagship_config(40, 1), "mixed40", mesh_hosts=3)),
    "pcap_tgen": lambda: every_other({
        "general": {"stop_time": "300ms", "seed": 6},
        "network": _switch("50 Mbit", "50 Mbit", "4 ms"),
        "hosts": {
            "capt": {"network_node_id": 0, "processes": [{
                "path": "tgen-client",
                "args": "--server sink --interval 9ms --size 600"}]},
            "other": {"network_node_id": 0, "processes": [{
                "path": "tgen-mesh", "args": "--interval 11ms --size 300"}]},
            "sink": {"network_node_id": 0, "processes": [{"path": "tgen-server"}]},
        }}, ("capt", "sink")),
    "pcap_stream": lambda: every_other({
        "general": {"stop_time": "4s", "seed": 9},
        "experimental": {"tpu_lane_queue_capacity": 48},
        "network": _switch("40 Mbit", "40 Mbit", "6 ms"),
        "hosts": {
            "capc": {"network_node_id": 0, "processes": [{
                "path": "stream-client", "args": "--server caps --size 200000"}]},
            "caps": {"network_node_id": 0, "processes": [
                {"path": "stream-server"}]},
            "other": {"network_node_id": 0, "processes": [{
                "path": "tgen-mesh", "args": "--interval 9ms --size 400"}]},
        }}, ("capc", "caps")),
}


def half_second(cfg):
    cfg.general.stop_time = 500_000_000
    return cfg


def plane_run(cfg_fn, dev: str, mode: str, tag: str, log_cap=None):
    """One run with the planes on, writing under its own directory: the
    result, the final state, the snapshot and the capture files."""
    cfg = cfg_fn()
    cfg.general.data_directory = f"{DATA}/{tag}-{dev}-{mode}"
    eng = GpuEngine(cfg, device=dev, log_capacity=log_cap)
    res, st = run_engine(eng, mode)
    return res, st, eng.netobs_snapshot(), pcap_files(cfg.general.data_directory)


def assert_planes_equal(tag: str, a, b) -> None:
    """Two plane runs equal: logs, counters, final states, the snapshot's
    arrays and histogram, the capture files byte for byte."""
    (res_a, st_a, snap_a, files_a), (res_b, st_b, snap_b, files_b) = a, b
    if res_a.log_tuples() != res_b.log_tuples():
        raise AssertionError(f"{tag}: event log differs")
    if res_a.counters != res_b.counters or res_a.rounds != res_b.rounds:
        raise AssertionError(f"{tag}: counters differ")
    assert_equal(f"{tag} final state", st_a, st_b)
    for k, v in snap_a["arrays"].items():
        if not np.array_equal(v, snap_b["arrays"][k]):
            raise AssertionError(f"{tag}: netobs {k} differs")
    if not np.array_equal(snap_a["window_hist"], snap_b["window_hist"]):
        raise AssertionError(f"{tag}: window histogram differs")
    if files_a != files_b:
        raise AssertionError(f"{tag}: capture files differ "
                             f"({sorted(files_a)} against {sorted(files_b)})")


@phase("the planes: card (step and device) against the CPU on six configs "
       "and the 10k tiered mixed mesh for 100 sim ms")
def plane_parity():
    for name, cfg_fn in PLANE_PARITY.items():
        ref, secs = cpu_ref(plane_cpu, name)
        res, _st, snap, files = ref
        tot = {k: int(v.sum()) for k, v in snap["arrays"].items()}
        if not (files and tot["sent"] and snap["window_hist"].sum()):
            raise AssertionError(f"{name}: the planes saw nothing")
        t0 = time.perf_counter()
        for mode in ("step", "device"):
            assert_planes_equal(f"{name} cuda/{mode}",
                                plane_run(cfg_fn, "cuda", mode, name), ref)
        log(f"{name}: card = CPU; {len(res.event_log)} records, {len(files)} "
            f"capture files, netobs totals {tot}, windows "
            f"{int(snap['window_hist'].sum())} (card "
            f"{time.perf_counter() - t0:.1f} s, CPU {secs:.1f} s)")

    runs = {}
    for dev in ("cuda", "cpu"):
        if dev == "cpu":
            runs[dev], secs = cpu_ref(plane_mixed_run, dev)
        else:
            t0 = time.perf_counter()
            runs[dev] = plane_mixed_run(dev)
            secs = time.perf_counter() - t0
        log(f"mixed mesh tiered 100 ms, planes on, {dev}: "
            f"{len(runs[dev][0].event_log)} records, {len(runs[dev][3])} "
            f"capture files ({secs:.1f} s)")
    assert_planes_equal("mixed mesh tiered 100 ms, planes on", runs["cuda"],
                        runs["cpu"])
    if len(runs["cpu"][3]) != 300:
        raise AssertionError("want 300 capture files")


def plane_cpu(name: str):
    return plane_run(PLANE_PARITY[name], "cpu", "device", name)


def plane_mixed_run(dev: str):
    """The 10k tiered mixed mesh, 100 sim ms, netobs and 300 capturing
    hosts, on ``dev``."""
    def cfg_fn():
        cfg = planes(mixed_tiered(1), "mixed10k-100ms")
        cfg.general.stop_time = 100_000_000
        return cfg
    return plane_run(cfg_fn, dev, "device", "mixed10k", log_cap=400_000)


# tests/test_torch_flowtrace.py's configurations (test_flowtrace.py's, the
# mixed mesh at 200 of its 1,000 sim ms) and the same mesh at C = Cx = 4096,
# flowtrace on: name -> (config builder, the CPU's driver mode)
def drop_heavy_doc(seed: int = 11, stop: str = "1500ms") -> dict:
    """test_flowtrace.py's drop-heavy mesh: six tgen clients into one
    server over a 2 Mbit up / 1 Mbit down node with 5% loss, C = Cx =
    2048."""
    return {
        "general": {"stop_time": stop, "seed": seed},
        "experimental": {"tpu_lane_queue_capacity": 2048},
        "network": _switch("2 Mbit", "1 Mbit", "10 ms", 0.05),
        "hosts": {
            "srv": {"network_node_id": 0, "processes": [{"path": "tgen-server"}]},
            "cli": {"count": 6, "network_node_id": 0, "processes": [{
                "path": "tgen-client",
                "args": "--server srv --interval 5ms --size 1400"}]},
        }}


def with_flowtrace(cfg, sample: float = 1.0, cap: int = 65536):
    cfg.experimental.flowtrace = True
    cfg.experimental.flowtrace_sample = sample
    cfg.experimental.flowtrace_capacity = cap
    return cfg


def mixed40(cross: int):
    """The 40-host mixed mesh at C = 4096 (the tier dropped), 100 sim ms:
    ``cross`` 8 (the preset's: B's and E's rows opt in to 115 KB of shared
    memory) or 0 (Cx = C: B's rows of 8,196 entries, 246 KB, merge in
    global memory)."""
    cfg = presets.mixed_flagship_config(40, 1)
    cfg.general.stop_time = 100_000_000
    cfg.experimental.tpu_lane_queue_capacity = 4096
    cfg.experimental.tpu_cross_capacity = cross
    return with_flowtrace(cfg)


FLOW_PARITY = {
    "drop_heavy": (lambda: with_flowtrace(
        ConfigOptions.from_dict(drop_heavy_doc())), "device"),
    "drop_heavy_step": (lambda: with_flowtrace(ConfigOptions.from_dict(
        drop_heavy_doc(seed=12, stop="600ms"))), "step"),
    "sampled": (lambda: with_flowtrace(
        ConfigOptions.from_dict(drop_heavy_doc()), sample=0.5), "device"),
    "lossy_stream": (lambda: with_flowtrace(ConfigOptions.from_dict({
        **_stream_pair_doc(loss=0.02, tiered=True, latency="10 ms",
                           size="400000"),
        "general": {"stop_time": "6s", "seed": 5,
                    "bootstrap_end_time": "100ms"}})), "device"),
    "mixed_fallback": (lambda: mixed40(8), "device"),
    "mixed_wide": (lambda: mixed40(0), "device"),
    "phold_32": (lambda: with_flowtrace(ConfigOptions.from_dict({
        "general": {"stop_time": "200ms", "seed": 3},
        "hosts": {"n": {"count": 8, "processes": [
            {"path": "phold", "args": "--messages 3 --size 600"}]}}}),
        cap=32), "device"),
}


def flow_run(cfg_fn, dev: str, mode: str, log_cap=None):
    """One traced run: the result, the final state and the snapshot."""
    eng = GpuEngine(cfg_fn(), device=dev, log_capacity=log_cap)
    res, st = run_engine(eng, mode)
    return res, st, eng.flowtrace_snapshot(), eng.params


def merge_paths(p) -> dict:
    """Each merge's path on this card: shared memory or global."""
    optin = kernels.smem_optin(DEV)
    return {what: ("shared" if lanes.merge_in_shared(e, w, x, optin)
                   else "global") + f" ({4 * w * e + x} B)"
            for what, (_r, e, w, x) in lanes.merge_rows(p).items()}


def assert_flows_equal(tag: str, a, b) -> None:
    """Two traced runs equal: logs, counters, final states (the ring
    included), the snapshots' events and losses."""
    (res_a, st_a, snap_a, _pa), (res_b, st_b, snap_b, _pb) = a, b
    if res_a.log_tuples() != res_b.log_tuples():
        raise AssertionError(f"{tag}: event log differs")
    if res_a.counters != res_b.counters or res_a.rounds != res_b.rounds:
        raise AssertionError(f"{tag}: counters differ")
    assert_equal(f"{tag} final state", st_a, st_b)
    if snap_a != snap_b:
        raise AssertionError(f"{tag}: flowtrace snapshots differ")


@phase("flowtrace: card (step and device) against the CPU on seven configs, "
       "the wide rows' opt-in and global merges among them, and the 10k "
       "untiered mixed mesh for 100 sim ms")
def flow_parity():
    for name, (cfg_fn, _cpu_mode) in FLOW_PARITY.items():
        ref, secs = cpu_ref(flow_cpu, name)
        res, _st, snap, p = ref
        if not snap["raw"]:
            raise AssertionError(f"{name}: no flow events")
        t0 = time.perf_counter()
        for mode in ("step", "device"):
            assert_flows_equal(f"{name} cuda/{mode}",
                               flow_run(cfg_fn, "cuda", mode), ref)
        kinds = np.bincount([e[2] for e in snap["raw"]], minlength=6)
        log(f"{name}: card = CPU; {len(res.event_log)} records, "
            f"{len(snap['raw'])} flow events by kind {kinds.tolist()}, ring "
            f"lost {snap['ring_lost']}; merges {merge_paths(p)} (card "
            f"{time.perf_counter() - t0:.1f} s, CPU {secs:.1f} s)")
    wide = GpuEngine(FLOW_PARITY["mixed_wide"][0](), device="cpu").params
    if not merge_paths(wide)["merge"].startswith("global"):
        raise AssertionError("the wide rows did not take the global path")

    runs = {}
    for dev in ("cuda", "cpu"):
        if dev == "cpu":
            runs[dev], secs = cpu_ref(flow_mixed_run, dev)
        else:
            t0 = time.perf_counter()
            runs[dev] = flow_mixed_run(dev)
            secs = time.perf_counter() - t0
        log(f"mixed mesh untiered 100 ms, flowtrace, {dev}: "
            f"{len(runs[dev][2]['raw'])} flow events ({secs:.1f} s)")
    assert_flows_equal("mixed mesh untiered 100 ms, flowtrace", runs["cuda"],
                       runs["cpu"])


def flow_cpu(name: str):
    cfg_fn, cpu_mode = FLOW_PARITY[name]
    return flow_run(cfg_fn, "cpu", cpu_mode)


def flow_mixed_run(dev: str):
    """The 10k untiered mixed mesh, 100 sim ms, every flow traced, on
    ``dev``."""
    def cfg_fn():
        cfg = with_flowtrace(mixed_mesh(1), cap=1 << 20)
        cfg.general.stop_time = 100_000_000
        return cfg
    return flow_run(cfg_fn, dev, "device", log_cap=0)


def wide_pair(tiered: bool):
    """The stream pair with queues past the opt-in limit: untiered at C =
    8,400 (B's rows of 16,816 entries and E's of 8,504, 7 words each, in
    global memory), or tiered with C2 = 8,400 (G's rows of 8,840)."""
    doc = _stream_pair_doc(tiered=tiered)
    doc["experimental"]["tpu_stream_queue_capacity" if tiered
                        else "tpu_lane_queue_capacity"] = 8400
    return ConfigOptions.from_dict(doc)


@phase("wide rows: card = CPU where every merge's rows pass the opt-in limit")
def wide_rows():
    for tiered, want in ((False, ("merge", "stream merge")),
                         (True, ("tier merge",))):
        runs = {dev: run_engine(GpuEngine(wide_pair(tiered), device=dev),
                                "device") for dev in ("cuda", "cpu")}
        p = GpuEngine(wide_pair(tiered), device="cpu").params
        paths = merge_paths(p)
        (res_g, st_g), (res_c, st_c) = runs["cuda"], runs["cpu"]
        log(f"wide pair tiered={tiered}: merges {paths}; {res_c.counters}")
        if any(not paths[m].startswith("global") for m in want):
            raise AssertionError(f"wide pair: {want} not all global")
        if res_c.counters.get("stream_complete") != 1:
            raise AssertionError("wide pair: the flow did not complete")
        if (res_g.log_tuples() != res_c.log_tuples()
                or res_g.counters != res_c.counters):
            raise AssertionError(f"wide pair tiered={tiered}: card and CPU "
                                 "differ")
        assert_equal(f"wide pair tiered={tiered} final state", st_g, st_c)


# ---- the scenario axis: every kernel over S scenarios in one launch ----------

SWEEP_S = 3
# past PARAM_SCENARIOS (csrc/lanes.cu) the kernels read the scenarios'
# blocks from the device array
SWEEP_S_ARRAY = 9


def run_batch(cases, call, plain, done=None):
    """``cases``: S scenarios ``(p, tb, s0, ws0)`` of one shape.  One
    batched launch of ``call`` over copies of their inputs — the
    workspaces rows of one batch, scenario ``done`` (if any) marked done —
    and the plain version scenario by scenario on other copies; returns
    the kernel's, the plain version's and the inputs' field dicts."""
    batch = lanes.make_workspaces(cases[0][0], DEV, len(cases))
    states = []
    for (_p, _tb, s0, ws0), ws in zip(cases, batch.rows):
        copy_into(ws, ws0)
        states.append(clone(s0))
    if done is not None:
        batch.rows[done].ctl[0] = 0
    call(kernels.SweepArgs([
        kernels.LaneArgs(p, tb, s, ws)
        for (p, tb, _s, _w), s, ws in zip(cases, states, batch.rows)]))
    torch.cuda.synchronize()
    kern = [state_fields(s, ws) for s, ws in zip(states, batch.rows)]
    want, inputs = [], []
    for i, (p, tb, s0, ws0) in enumerate(cases):
        s, ws = clone(s0), clone(ws0)
        if i == done:
            ws.ctl[0] = 0
        inputs.append(state_fields(clone(s), clone(ws)))
        plain(p, tb, s, ws)
        torch.cuda.synchronize()
        want.append(state_fields(s, ws))
    return kern, want, inputs


def check_batch(name: str, tag: str, cases, call, plain) -> None:
    """The batched launch against the plain loop, word for word; then
    with scenario 1 done: its words unchanged, the others as the loop."""
    kern, want, inputs = run_batch(cases, call, plain)
    for i in range(len(cases)):
        check(name, f"sweep {tag} scenario {i}", kern[i], want[i])
    moved = [sum(int((want[i][f] != inputs[i][f]).sum()) for f in want[i])
             for i in range(len(cases))]
    differ = any(not torch.equal(want[0][f], want[1][f]) for f in want[0])
    if not all(moved) or not differ:
        raise AssertionError(f"{name} {tag}: the scenarios' outputs are "
                             f"equal or did not move ({moved})")
    kern, want, inputs = run_batch(cases, call, plain, done=1)
    assert_equal(f"{name} sweep {tag}: done scenario 1 unchanged", kern[1],
                 inputs[1])
    for i in range(len(cases)):
        if i != 1:
            check(name, f"sweep {tag} beside a done scenario {i}", kern[i],
                  want[i])
    log(f"{name} sweep {tag}: S = {len(cases)} in one launch equal to the "
        f"plain loop; words moved by scenario {moved}; with scenario 1 done "
        "it is unchanged and the others equal")


def with_rec_inputs(p, ws, rng) -> None:
    """Random valid flags and rows for D's instances (the log, and with
    flowtrace the ring)."""
    if p.log_capacity:
        n_rec = ws.rec_valid.numel()
        ws.rec_valid.copy_(t32(rng.random(n_rec) < 0.3))
        ws.recs.copy_(torch.as_tensor(rng.integers(0, 1 << 40, (n_rec, 6)),
                                      device=DEV))
    if p.flowtrace:
        n_fl = ws.fl_valid.numel()
        ws.fl_valid.copy_(t32(rng.random(n_fl) < 0.3))
        ws.fl_recs.copy_(t32(rng.integers(-(1 << 31), 1 << 31, (n_fl, 8))))


def window_passed(cases):
    """``cases`` with each window's end 10 ms before the earliest head:
    kernel C opens the next window (a round, the netobs flush)."""
    out = []
    for p, tb, s0, ws0 in cases:
        s1 = clone(s0)
        we = T0 - 10_000_000
        s1.now_we_hi.fill_(we >> 31)
        s1.now_we_lo.fill_(we & lanes.MASK31)
        out.append((p, tb, s1, ws0))
    return out


def c_call(advance: bool):
    return (lambda a: kernels.queue_min_window(a, advance),
            lambda p_, tb_, s, ws: lanes.queue_min_window_plain(p_, s, ws,
                                                                advance))


def d_plain(p_, tb_, s, ws):
    lanes.append_log_plain(p_, s, ws)


@phase("the scenario axis: kernels A-G and D over S = 3 scenarios in one "
       "launch vs the plain loop, one scenario done, and the stream groups "
       "at S = 9 (tolerance: exact)")
def check_sweep_kernels():
    rng = np.random.default_rng(SEED + 7)
    a_ = (kernels.lane_slots, lanes.lane_slots_plain)
    b_ = (kernels.exchange_merge, lanes.exchange_merge_plain)

    # the flagship shapes, passive, with a log: A, B, C, D's log instance
    eng = GpuEngine(flagship(), log_capacity=60_000)
    cases = []
    for i in range(SWEEP_S):
        p = dataclasses.replace(eng.params, seed=SEED + i)
        tb = random_tables(eng, rng)
        s0 = random_state(eng, tb, rng)
        ws0 = lanes.make_workspace(p, DEV)
        random_exchange(p, ws0, rng)
        with_rec_inputs(p, ws0, rng)
        cases.append((p, tb, s0, ws0))
    for name, (call, plain) in (("lane_slots", a_), ("exchange_merge", b_),
                                ("queue_min_window", c_call(True)),
                                ("append_log", (kernels.append_log, d_plain))):
        check_batch(name, "flagship", cases, call, plain)
    check_batch("queue_min_window", "flagship adv=False", cases,
                *c_call(False))
    check_batch("queue_min_window", "flagship, window passed",
                window_passed(cases), *c_call(True))

    # the PHOLD shapes, active: phold and ping lanes, loss draws under each
    # scenario's own seed, dynamic runahead
    eng_a = GpuEngine(phold(stop_time="1s"), log_capacity=0)
    cases = []
    for i in range(SWEEP_S):
        p = dataclasses.replace(active_params(eng_a, True),
                                seed=(1 << 64) - 3 - 11 * i)
        tb = active_tables(eng_a, rng)
        s0 = active_state(eng_a, tb, rng)
        ws0 = lanes.make_workspace(p, DEV)
        random_exchange(p, ws0, rng)
        cases.append((p, tb, s0, ws0))
    for name, (call, plain) in (("lane_slots", a_), ("exchange_merge", b_),
                                ("queue_min_window", c_call(True))):
        check_batch(name, "phold", cases, call, plain)

    # the untiered mixed mesh with every flow traced and a log: A's stream
    # arm, B, E, D's two instances in one launch, C
    eng_s = GpuEngine(mixed_mesh(1), log_capacity=0)
    cases = []
    for i in range(SWEEP_S_ARRAY):
        p, tb, s0 = stream_case(eng_s, rng)
        p = dataclasses.replace(traced(p, 1.0, cap=400_000),
                                log_capacity=100_000, seed=SEED + 10 + i)
        s0 = with_log(with_ring(s0, p.flow_capacity), p.log_capacity)
        ws0 = lanes.make_workspace(p, DEV)
        random_exchange(p, ws0, rng)
        random_stream_block(p, ws0, rng, p.n_lanes)
        with_rec_inputs(p, ws0, rng)
        cases.append((p, tb, s0, ws0))
    for name, (call, plain) in (
            ("lane_slots", a_), ("exchange_merge", b_),
            ("stream_rows_merge", (kernels.stream_rows_merge,
                                   lanes.stream_rows_merge_plain)),
            ("append_log", (kernels.append_log, d_plain)),
            ("queue_min_window", c_call(True))):
        check_batch(name, "untiered stream, flowtrace, log",
                    cases[:SWEEP_S], call, plain)
        check_batch(name, "untiered stream, flowtrace, log", cases, call,
                    plain)

    # the tiered mixed mesh with netobs, pcap and a log: A, B (the divert),
    # F, G (on F's outputs), C (the tier's heads), D
    eng_t = GpuEngine(planes(mixed_tiered(1), "sweep_check"),
                      log_capacity=200_000)
    cases, g_cases = [], []
    for i in range(SWEEP_S_ARRAY):
        p, tb, s0 = tier_case(eng_t, rng, True, 200_000)
        p = dataclasses.replace(p, seed=(1 << 64) - 7 - 13 * i)
        tb = throttling(eng_t, tb, rng)
        tb, s0 = seed_planes(p, tb, with_log(s0, 200_000), rng)
        ws0 = lanes.make_workspace(p, DEV)
        random_exchange(p.lane, ws0, rng)
        with_rec_inputs(p, ws0, rng)
        cases.append((p, tb, s0, ws0))
        s1, ws1 = clone(s0), clone(ws0)
        lanes.stream_tier_plain(p, tb, s1, ws1)
        tier_cross_block(p, ws1, rng)
        g_cases.append((p, tb, s1, ws1))
    for name, (call, plain) in (
            ("lane_slots", a_), ("exchange_merge", b_),
            ("stream_tier", (kernels.stream_tier, lanes.stream_tier_plain)),
            ("queue_min_window", c_call(True)),
            ("append_log", (kernels.append_log, d_plain))):
        for group in (cases[:SWEEP_S], cases):
            check_batch(name, "tiered, netobs + pcap, log", group, call,
                        plain)
    for group in (g_cases[:SWEEP_S], g_cases):
        check_batch("tier_merge", "tiered, netobs + pcap, log", group,
                    kernels.tier_merge, lanes.tier_merge_plain)
    check_batch("queue_min_window", "tiered, netobs, window passed",
                window_passed(cases[:SWEEP_S]), *c_call(True))


# ---- kernels B and F on their edge cases -------------------------------------


def never_prefix(p, s, rng):
    """``s`` with popped prefixes as kernel A leaves them: each row's first
    f columns get the NEVER time and keep their old aux words (in about a
    third of the rows one aux pair for the whole prefix, so the tie falls
    to the index), and one row in eight is NEVER throughout."""
    n, c = p.n_lanes, p.capacity
    f = rng.integers(0, c + 1, n)
    f[rng.random(n) < 0.125] = c
    pre = np.arange(c)[None, :] < f[:, None]
    tie = (rng.random(n) < 0.3)[:, None] & pre
    words = {w: getattr(s, w).cpu().numpy() for w in
             ("q_thi", "q_tlo", "q_auxh", "q_auxl")}
    out = {w: np.where(pre, lanes.NEVER32, words[w])
           for w in ("q_thi", "q_tlo")}
    for w in ("q_auxh", "q_auxl"):
        out[w] = np.where(tie, words[w][:, :1], words[w])
    return s._replace(**{w: t32(v) for w, v in out.items()})


def hot_exchange(p, ws, rng, hot) -> None:
    """random_exchange's blocks with every valid outbound entry addressed
    to one of the lanes ``hot``: groups many times Cx, which the atomic
    placement leaves in arbitrary order."""
    random_exchange(p, ws, rng)
    valid = ws.out_blk[0] != p.n_lanes
    ws.out_blk[0] = torch.where(
        valid, t32(rng.choice(hot, tuple(valid.shape))), ws.out_blk[0])


def b_case(tag: str, p, tb, s0, ws0) -> None:
    """B on one case against the plain version."""
    kern, plain = run_pair(p, tb, s0, ws0, kernels.exchange_merge,
                           lanes.exchange_merge_plain)
    check("exchange_merge", tag, kern, plain)
    cnt = torch.bincount(ws0.out_blk[0].reshape(-1).long(),
                         minlength=p.n_lanes + 1)[:p.n_lanes]
    log(f"exchange_merge {tag}: equal on [C {p.capacity} | self "
        f"{p.lane.self_width} | Cx {p.cross_cap}] x {p.lane.words} words "
        f"({'narrow' if lanes.merge_in_warp(p.lane.merge_width) else 'wide'}"
        f", {merge_paths(p)['merge']}); largest group {int(cnt.max())}, "
        f"shed {int(plain['n_queue'].sum() - s0.n_queue.sum())}")


def scratch_zero(tag: str, ws) -> None:
    """The exchange scratch B and H leave for their next call: zero."""
    torch.cuda.synchronize()
    if any(int(t.abs().sum()) for t in (ws.x_cnt, ws.x_fill, ws.x_done)):
        raise AssertionError(f"{tag}: the exchange scratch is not zero")


def tier_prefixes(p, s, rng) -> np.ndarray:
    """``s``'s tier rows with their popped prefix set: each row's first e
    columns (e from 1, K_s / 2 and K_s + 1, the last past every column)
    PACKETs of one instant inside the window (their other words kept),
    column e a LOCAL at a later instant, so both pop rules stop there.
    Returns e a row."""
    s2, ks = 2 * p.s_flows, p.stream_pops
    q = s.stream.q.cpu().numpy()
    ends = rng.choice([1, ks // 2, ks + 1], s2)
    t_in, t_late = T0 + 1_000_000, T0 + 2_000_000
    src_bits = (1 << lanes.AUX_KIND_SHIFT) - 1
    for r in range(s2):
        e = min(int(ends[r]), ks)
        q[2, r, :e] &= src_bits  # kind PACKET
        q[0, r, :e], q[1, r, :e] = pairs(t_in)
        if ends[r] <= ks:
            q[2, r, e] = lanes.LOCAL << lanes.AUX_KIND_SHIFT | (q[2, r, e]
                                                            & src_bits)
            q[0, r, e], q[1, r, e] = pairs(t_late)
    s.stream.q.copy_(t32(q))
    return ends


@phase("kernels B and F on their edge cases vs plain: B's groups many "
       "times Cx, NEVER prefixes with old aux words, all-NEVER rows, the "
       "divert, W = 7 rows, PHOLD's 144-wide rows, rows in m_scratch, S = 1, "
       "3 and 9, its scratch zero after B, H and B again; F's popped "
       "prefixes ending at column 0, mid-row and past K_s under both pop "
       "rules, with a log, pcap and netobs, S = 1 and 8 (tolerance: exact, "
       "integer)")
def check_merge_cases():
    rng = np.random.default_rng(SEED + 10)
    # B, narrow rows: the flagship's 26 entries, W = 5, with and without a
    # log; groups in a few lanes, NEVER prefixes
    eng = GpuEngine(flagship(), log_capacity=60_000)
    flag_cases = []
    for log_cap in (0, 60_000):
        p = dataclasses.replace(eng.params, log_capacity=log_cap)
        for hot in ([3, 17], list(range(40))):
            tb = random_tables(eng, rng)
            s0 = with_log(never_prefix(p, random_state(eng, tb, rng), rng),
                          log_cap)
            ws0 = lanes.make_workspace(p, DEV)
            hot_exchange(p, ws0, rng, hot)
            b_case(f"flagship L={log_cap} hot={len(hot)}", p, tb, s0, ws0)
            flag_cases.append((p, tb, s0, ws0))
    # ... every entry empty: all-NEVER rows and no exchange
    p, tb, s0, ws0 = flag_cases[0]
    s1 = s0._replace(q_thi=torch.full_like(s0.q_thi, lanes.NEVER32),
                     q_tlo=torch.full_like(s0.q_tlo, lanes.NEVER32))
    ws1 = clone(ws0)
    ws1.out_blk[0] = p.n_lanes
    ws1.out_blk[1:3] = lanes.NEVER32
    ws1.self_blk[:2] = lanes.NEVER32
    b_case("flagship all NEVER", p, tb, s1, ws1)
    # ... over S = 3 and S = 9 scenarios in one launch
    for size in (SWEEP_S, SWEEP_S_ARRAY):
        cases = []
        for i in range(size):
            p_i = dataclasses.replace(flag_cases[2][0], seed=SEED + i)
            tb = random_tables(eng, rng)
            s0 = with_log(never_prefix(p_i, random_state(eng, tb, rng), rng),
                          p_i.log_capacity)
            ws0 = lanes.make_workspace(p_i, DEV)
            hot_exchange(p_i, ws0, rng, rng.integers(0, p_i.n_lanes, 1 + i))
            cases.append((p_i, tb, s0, ws0))
        check_batch("exchange_merge", f"edge cases S={size}", cases,
                    kernels.exchange_merge, lanes.exchange_merge_plain)
    # the divert: the tiered mesh's stream lanes receive groups past Cx
    eng_t = GpuEngine(mixed_tiered(1), log_capacity=0)
    stream_lanes = np.nonzero(eng_t.tables.lane_stream.cpu().numpy())[0]
    for log_cap in (0, 100_000):
        p, tb, s0 = tier_case(eng_t, rng, True, log_cap)
        s0 = never_prefix(p.lane, s0, rng)
        ws0 = lanes.make_workspace(p, DEV)
        hot_exchange(p.lane, ws0, rng,
                     np.concatenate([stream_lanes[:5], [0, 1]]))
        b_case(f"tiered divert L={log_cap}", p, tb, s0, ws0)
    # W = 7, narrow: the untiered mixed mesh's 28-entry rows, payload words
    # in the queue rows
    mixed = GpuEngine(mixed_mesh(1), log_capacity=0)
    p, tb = mixed.params, mixed.tables
    s0 = random_state(mixed, tb, rng)
    live = s0.q_thi != lanes.NEVER32
    s0 = never_prefix(p, s0._replace(
        q_phi=torch.where(live, t32(rng.integers(0, 1 << 30, live.shape)), 0),
        q_plo=torch.where(live, t32(rng.integers(0, 1 << 20, live.shape)), 0)),
        rng)
    ws0 = lanes.make_workspace(p, DEV)
    hot_exchange(p, ws0, rng, [4, 9, 300])
    ws0.self_blk[5:] = t32(rng.integers(0, 1 << 30, ws0.self_blk[5:].shape))
    b_case("mixed mesh untiered W=7", p, tb, s0, ws0)
    # W = 7, wide: the star's stream entries with payload words
    star = GpuEngine(ConfigOptions.from_dict(star_doc()), log_capacity=0)
    for log_cap in (0, 100_000):
        p = dataclasses.replace(star.params, log_capacity=log_cap)
        tb = star.tables
        s0 = random_state(star, tb, rng)
        live = s0.q_thi != lanes.NEVER32
        s0 = never_prefix(p, s0._replace(
            q_phi=torch.where(live, t32(rng.integers(0, 1 << 30, live.shape)), 0),
            q_plo=torch.where(live, t32(rng.integers(0, 1 << 20, live.shape)),
                              0)), rng)
        s0 = with_log(s0, log_cap)
        ws0 = lanes.make_workspace(p, DEV)
        hot_exchange(p, ws0, rng, [0, 1, 2])
        ws0.self_blk[5:] = t32(rng.integers(0, 1 << 30, ws0.self_blk[5:].shape))
        random_stream_block(p, ws0, rng, 2)
        b_case(f"star W=7 L={log_cap}", p, tb, s0, ws0)
    # PHOLD's 144-wide rows (C 64 + 2K 16 + Cx 64), wide form
    eng_p = GpuEngine(phold(stop_time="1s"), log_capacity=0)
    for log_cap in (0, 1_000_000):
        p = dataclasses.replace(active_params(eng_p, False),
                                log_capacity=log_cap)
        tb = active_tables(eng_p, rng)
        s0 = with_log(never_prefix(p, active_state(eng_p, tb, rng), rng),
                      log_cap)
        ws0 = lanes.make_workspace(p, DEV)
        hot_exchange(p, ws0, rng, list(range(0, 400, 7)))
        b_case(f"phold L={log_cap}", p, tb, s0, ws0)
    # rows in m_scratch: the 40-host mixed mesh at C = Cx = 4096
    eng_w = GpuEngine(mixed40(0), log_capacity=100_000)
    p = eng_w.params
    if not merge_paths(p)["merge"].startswith("global"):
        raise AssertionError("the C = Cx = 4096 rows are not global")
    tb = eng_w.tables
    s0 = with_log(never_prefix(p, random_state(eng_w, tb, rng), rng),
                  p.log_capacity)
    ws0 = lanes.make_workspace(p, DEV)
    hot_exchange(p, ws0, rng, [0, 5])
    b_case("mixed 40 C=Cx=4096", p, tb, s0, ws0)

    # the scratch: B, H, B on one workspace (the hybrid flagship's shapes),
    # zero after each, the state as the plain versions' in turn
    cfg = hybrid_cfg("scratch")
    ext = external_mask(cfg)
    heng = GpuEngine(cfg, log_capacity=60_000, external=ext)
    p, tb = heng.params, heng.tables
    s0 = random_state(heng, tb, rng)
    ws0 = lanes.make_workspace(p, DEV)
    hot_exchange(p, ws0, rng, np.nonzero(ext)[0][:4])
    blk = hybrid_block(p, rng, 400, np.nonzero(ext)[0][:2], T0)
    s_k, ws_k, s_p, ws_p = clone(s0), clone(ws0), clone(s0), clone(ws0)
    args = kernels.LaneArgs(p, tb, s_k, ws_k)
    steps = (("B", kernels.exchange_merge, lanes.exchange_merge_plain),
             ("H", lambda a: kernels.inject_merge(a, blk),
              lambda p_, tb_, s, ws: lanes.inject_merge_plain(p_, tb_, s, blk)),
             ("B again", kernels.exchange_merge, lanes.exchange_merge_plain))
    for name, call, plain in steps:
        call(args)
        plain(p, tb, s_p, ws_p)
        scratch_zero(f"after {name}", ws_k)
        check("exchange_merge" if name.startswith("B") else "inject_merge",
              f"scratch sequence, after {name}", state_fields(s_k, ws_k),
              state_fields(s_p, ws_p))
    log("exchange scratch: zero after B, H and B again on one workspace; "
        "the state equal to the plain sequence's after each")

    # F: popped prefixes of 1, K_s / 2 and all K_s columns, both pop rules,
    # with and without a log
    for wide in (True, False):
        for log_cap in (0, 200_000):
            p, tb, s0 = tier_case(eng_t, rng, wide, log_cap)
            ends = tier_prefixes(p, s0, rng)
            ws0 = lanes.make_workspace(p, DEV)
            tag = f"prefixes wide={wide} L={log_cap}"
            kern, plain = run_pair(p, tb, s0, ws0, kernels.stream_tier,
                                   lanes.stream_tier_plain)
            check("stream_tier", tag, kern, plain)
            popped = (plain["stream.q"][0, :, :p.stream_pops]
                      != s0.stream.q[0, :, :p.stream_pops]).sum(1).cpu()
            want = np.minimum(ends, p.stream_pops)
            log(f"stream_tier {tag}: equal; rows popping 1, K_s/2, K_s "
                f"columns: {[int((popped == k).sum()) for k in sorted(set(want))]}"
                f"; {tier_counts(p, s0, plain)}")
            if not np.array_equal(popped.numpy(), want):
                raise AssertionError(f"{tag}: the prefixes did not pop as set")
    # ... with pcap and netobs (and a log)
    eng_pl = GpuEngine(planes(mixed_tiered(1), "edge"), log_capacity=200_000)
    for wide in (True, False):
        p, tb, s0 = tier_case(eng_pl, rng, wide, 200_000)
        tb = throttling(eng_pl, tb, rng)
        tb, s0 = seed_planes(p, tb, with_log(s0, 200_000), rng)
        tier_prefixes(p, s0, rng)
        ws0 = lanes.make_workspace(p, DEV)
        kern, plain = run_pair(p, tb, s0, ws0, kernels.stream_tier,
                               lanes.stream_tier_plain)
        check("stream_tier", f"prefixes planes wide={wide}", kern, plain)
        log(f"stream_tier prefixes planes wide={wide}: equal with pcap, "
            f"netobs and a log; {tier_counts(p, s0, plain)}")
    # ... over S = 8 scenarios in one launch, a thread a row (a warp a row
    # above)
    cases = []
    for i in range(8):
        p, tb, s0 = tier_case(eng_t, rng, i % 2 == 0, 0)
        tier_prefixes(p, s0, rng)
        cases.append((dataclasses.replace(p, seed=SEED + i), tb, s0,
                      lanes.make_workspace(p, DEV)))
    check_batch("stream_tier", "prefixes S=8", cases, kernels.stream_tier,
                lanes.stream_tier_plain)


# ---- kernels D and C on their edge cases ----------------------------------

D_CLUSTER = lanes.LOG_CLUSTER  # D's blocks an instance


def d_slices(n: int) -> list:
    """D's slices of ``n`` flags over its cluster: whole runs of 32 flags
    a block (csrc/lanes.cu append_rows), the last ones short or empty."""
    per = -(-n // (D_CLUSTER * 32)) * 32
    return [(min(n, r * per), min(n, r * per + per))
            for r in range(D_CLUSTER)]


def d_flags(case: str, n: int, rng) -> np.ndarray:
    """[n] valid flags: only in the last block's slice, only on the
    slices' boundaries (each slice's first and last flag), all, none, or
    random (about a third)."""
    v = np.zeros(n, bool)
    sl = [s for s in d_slices(n) if s[1] > s[0]]
    if case == "last_slice":
        lo, hi = sl[-1]
        v[lo:hi] = rng.random(hi - lo) < 0.5
        v[hi - 1] = True
    elif case == "boundaries":
        for lo, hi in sl:
            v[lo] = v[hi - 1] = True
    elif case == "all":
        v[:] = True
    elif case == "random":
        v = rng.random(n) < 0.3
    return v


def d_case(p, s, ws, case: str, where: str, rng):
    """Params, state and workspace for D with ``case``'s flags in the log's
    and the ring's (and the egress's) flag arrays, the log's and the ring's
    count starting with room to spare ("room"), with the capacity inside
    the valid rows of block 7's slice ("mid"), inside that slice's second
    tile where it has one ("late"; else as "mid"), or past it ("past"); the
    egress's (its buffer E rows, past every flag) with room, its rows'
    times past T0 + 10."""
    caps = {}
    starts = {}
    arrays = [("log", ws.rec_valid, ws.recs)]
    if p.flowtrace:
        arrays.append(("ring", ws.fl_valid, ws.fl_recs))
    if p.external_any:
        arrays.append(("egress", ws.eg_valid, ws.eg_recs))
    for inst, flags, recs in arrays:
        v = d_flags(case, flags.numel(), rng)
        flags.copy_(t32(v))
        if recs.dtype == torch.int64:
            rows = rng.integers(0, 1 << 40, tuple(recs.shape))
            rows[:, 0] += T0 + 10
            rows[:, 5] = rng.choice([lanes.DELIVERED, lanes.DROP_CODEL],
                                    recs.shape[0])
            recs.copy_(torch.as_tensor(rows, device=DEV))
        else:
            recs.copy_(t32(rng.integers(-(1 << 31), 1 << 31,
                                        tuple(recs.shape))))
        start, total = int(rng.integers(0, 1000)), int(v.sum())
        if inst == "egress":
            cap = p.egress_capacity
        elif where == "room":
            cap = start + total + 5
        elif where == "past":
            cap, start = start + 7, start + 10
        else:
            lo, hi = d_slices(v.size)[7]
            if where == "late" and hi - lo > lanes.LOG_TILE:
                cap = start + int(v[:(lo + lanes.LOG_TILE + hi) // 2].sum())
            else:
                cap = start + int(v[:lo].sum()) + max(
                    1, int(v[lo:hi].sum()) // 2)
        caps[inst], starts[inst] = cap, start
    p = dataclasses.replace(p, log_capacity=caps["log"],
                            **({"flow_capacity": caps["ring"]}
                               if "ring" in caps else {}))
    s = s._replace(
        log=torch.zeros((caps["log"], 6), dtype=torch.int64, device=DEV),
        log_count=t32(starts["log"]).reshape(()))
    if "ring" in caps:
        s = with_ring(s, caps["ring"])
        s.fl_count.fill_(starts["ring"])
    if "egress" in caps:
        s = s._replace(egress=torch.zeros_like(s.egress),
                       egress_count=t32(starts["egress"]).reshape(()))
    return p, s, ws


def heads_case(p, s, case: str, rng):
    """``s`` with the queue heads of ``case`` (column 0 of every [N] row
    and of every tier row, the rest NEVER): the min in the last lane (the
    cluster's last block) or in the last tier row, every head NEVER, tied
    minima in blocks 0, N/2 and the last (and a tier row; one more head
    ties on the high word with a larger low word), or every head at the
    stop time.  Returns the state and the min head (NEVER when none)."""
    n, c = p.n_lanes, p.capacity
    s2 = 2 * p.s_flows if p.stream_tiered else 0
    head = T0 + 1 + rng.integers(0, 50_000_000, n + s2)
    never = rng.random(n + s2) < 0.3
    want = T0
    if case == "last_lane":
        head[n - 1], never[n - 1] = T0, False
    elif case == "tier_row":
        head[n + s2 - 1], never[n + s2 - 1] = T0, False
    elif case == "all_never":
        never[:] = True
        want = lanes.NEVER
    elif case == "ties":
        for i in (1, n // 2, n - 1) + ((n + 1,) if s2 else ()):
            head[i], never[i] = T0, False
        head[3], never[3] = T0 + 1, False
    elif case == "at_stop":
        head[:], never[:] = p.stop_time, False
        never[::3] = True
        want = p.stop_time
    hi = np.where(never, lanes.NEVER32, head >> 31)
    lo = np.where(never, lanes.NEVER32, head & lanes.MASK31)
    q_hi = np.full((n, c), lanes.NEVER32)
    q_lo = np.full((n, c), lanes.NEVER32)
    q_hi[:, 0], q_lo[:, 0] = hi[:n], lo[:n]
    s = s._replace(q_thi=t32(q_hi), q_tlo=t32(q_lo))
    if s2:
        q = s.stream.q.clone()
        q[0:2] = lanes.NEVER32
        q[0, :, 0], q[1, :, 0] = t32(hi[n:]), t32(lo[n:])
        s = s._replace(stream=s.stream._replace(q=q))
    return s, want


def set_window(s, we: int):
    s = clone(s)
    s.now_we_hi.fill_(we >> 31)
    s.now_we_lo.fill_(we & lanes.MASK31)
    return s


def pair_time(hi, lo) -> int:
    """The time of an int32 (hi, lo) pair; NEVER for a NEVER32 high word."""
    hi, lo = int(hi), int(lo)
    return lanes.NEVER if hi == lanes.NEVER32 else hi << 31 | lo


HEAD_CASES = ("last_lane", "tier_row", "all_never", "ties", "at_stop")


@phase("kernels D and C on their edge cases vs plain: D's flags only in the "
       "last block's slice or on slice boundaries, all, none, the capacity "
       "inside a slice, the start past it, slices of two tiles (48,000 "
       "hosts), the log, ring and egress in one "
       "launch with the egress minimum in block 5, S = 1, 3, 8, 9; C's min "
       "head in the last block or a tier row, all NEVER, ties, at the stop "
       "time, advance on and off, dynamic runahead, the netobs flush, its "
       "hybrid mode's first and later steps and its fused mode's refold "
       "passes, S = 1, 3, 8, 9 (tolerance: exact, integer)")
def check_compact_cases():
    rng = np.random.default_rng(SEED + 11)
    # D at the flagship's log (120,000 flags, 16 slices of 7,520) with the
    # ring turned on beside it
    eng = GpuEngine(flagship(), log_capacity=60_000)
    p0 = traced(eng.params, 1.0, 1)
    s_base = with_ring(eng.initial_state(), 1)
    cases = []
    for case, where in (("last_slice", "room"), ("boundaries", "room"),
                        ("all", "room"), ("none", "room"),
                        ("random", "mid"), ("random", "past")):
        ws0 = lanes.make_workspace(p0, DEV)
        p, s0, ws0 = d_case(p0, clone(s_base), ws0, case, where, rng)
        kern, plain = run_pair(p, eng.tables, s0, ws0, kernels.append_log,
                               d_plain)
        check("append_log", f"compact {case} {where}", kern, plain)
        log(f"append_log compact {case} {where}: equal; log {int(s0.log_count)}"
            f" -> {int(plain['log_count'])} (lost "
            f"{int(plain['log_lost'])}, cap {p.log_capacity}), ring "
            f"{int(s0.fl_count)} -> {int(plain['fl_count'])} (lost "
            f"{int(plain['fl_lost'])}, cap {p.flow_capacity}) of "
            f"{ws0.rec_valid.numel()} and {ws0.fl_valid.numel()} flags")
        cases.append((p, eng.tables, s0, ws0))
    # ... and past one tile a slice: the flagship mesh at 48,000 hosts
    # (576,000 log flags, 16 slices of 36,000, each a tile of LOG_TILE =
    # 32,768 flags and a second one), its later tiles counted before the
    # cluster's barrier and scanned, staged and copied after it; the
    # capacity inside a second tile, and a start past the capacity
    big = GpuEngine(flagship(sim_seconds=1, n_hosts=48_000),
                    log_capacity=60_000)
    pb = traced(big.params, 1.0, 1)
    n_big = pb.rec_offsets.end
    if min(hi - lo for lo, hi in d_slices(n_big)) <= lanes.LOG_TILE:
        raise AssertionError(f"{n_big} log flags: a slice of one tile")
    sb = with_ring(big.initial_state(), 1)
    for case, where in (("all", "room"), ("random", "room"),
                        ("random", "late"), ("random", "past")):
        ws0 = lanes.make_workspace(pb, DEV)
        p, s0, ws0 = d_case(pb, clone(sb), ws0, case, where, rng)
        kern, plain = run_pair(p, big.tables, s0, ws0, kernels.append_log,
                               d_plain)
        check("append_log", f"compact two tiles {case} {where}", kern, plain)
        log(f"append_log two tiles a slice, {case} {where}: equal; log "
            f"{int(s0.log_count)} -> {int(plain['log_count'])} (lost "
            f"{int(plain['log_lost'])}, cap {p.log_capacity}), ring "
            f"{int(s0.fl_count)} -> {int(plain['fl_count'])} (lost "
            f"{int(plain['fl_lost'])}, cap {p.flow_capacity}) of {n_big} "
            f"and {ws0.fl_valid.numel()} flags")
    del big, sb
    # ... over S = 3, 8 and 9 scenarios in one launch, each its own case
    for size in (3, 8, 9):
        batch = [cases[i % len(cases)] for i in range(size)]
        kern, want, _ = run_batch(batch, kernels.append_log, d_plain)
        for i in range(size):
            check("append_log", f"compact S={size} scenario {i}", kern[i],
                  want[i])
        log(f"append_log compact: S = {size} in one launch equal to the "
            "plain loop")
    # the log, the ring and the egress in one launch (the hybrid flagship's
    # shapes): the earliest DELIVERED egress time in block 5's slice, an
    # earlier CoDel drop and an earlier invalid row in block 0's
    cfg = hybrid_cfg("compact")
    heng = GpuEngine(cfg, log_capacity=60_000, external=external_mask(cfg))
    ph = traced(heng.params, 1.0, 1)
    sh = with_ring(random_state(heng, heng.tables, rng), 1)
    for case in ("random", "boundaries"):
        ws0 = lanes.make_workspace(ph, DEV)
        p, s0, ws0 = d_case(ph, clone(sh), ws0, case, "room", rng)
        n_eg = ws0.eg_valid.numel()
        (lo0, _), (lo5, hi5) = d_slices(n_eg)[0], d_slices(n_eg)[5]
        ws0.eg_valid[lo0:lo0 + 2] = t32([1, 0])
        ws0.eg_valid[lo5] = 1
        ws0.eg_recs[lo0, 0], ws0.eg_recs[lo0, 5] = T0, lanes.DROP_CODEL
        ws0.eg_recs[lo0 + 1, 0], ws0.eg_recs[lo0 + 1, 5] = T0, lanes.DELIVERED
        ws0.eg_recs[lo5, 0], ws0.eg_recs[lo5, 5] = T0 + 5, lanes.DELIVERED
        for t in (s0.egress_min_hi, s0.egress_min_lo):
            t.fill_(lanes.NEVER32)
        kern, plain = run_pair(p, heng.tables, s0, ws0, kernels.append_log,
                               d_plain)
        check("append_log:egress", f"compact three instances {case}", kern,
              plain)
        got = pair_time(plain["egress_min_hi"], plain["egress_min_lo"])
        if got != T0 + 5:
            raise AssertionError(f"the egress minimum {got} is not block "
                                 f"5's {T0 + 5}")
        log(f"append_log three instances {case}: equal; log "
            f"{int(plain['log_count'])}, ring {int(plain['fl_count'])}, "
            f"egress {int(plain['egress_count'])} rows, minimum from block 5")

    # C: the flagship (10 blocks), PHOLD (C = 64), the tiered mesh with
    # netobs (its tier rows), the hybrid flagship (2 blocks)
    adv, no_adv = c_call(True), c_call(False)
    seen = {"live": 0, "done": 0, "fresh": 0}
    c_cases = []
    engines = (("flagship", eng, False),
               ("phold", GpuEngine(phold(stop_time="10s"), log_capacity=0),
                False),
               ("tiered netobs", GpuEngine(netobs_only(mixed_tiered(10)),
                                           log_capacity=0), True))
    for label, e, tiered in engines:
        for dyn in (False, True):
            p = dataclasses.replace(e.params, dynamic_runahead=dyn)
            base = e.initial_state()
            if p.netobs:
                base.nb_win.fill_(37)
            base.min_used_lat.fill_(700_000 if dyn else lanes.NEVER32)
            for case in HEAD_CASES:
                if case == "tier_row" and not tiered:
                    continue
                s1, want = heads_case(p, base, case, rng)
                ws0 = lanes.make_workspace(p, DEV)
                for we, (call, plain_fn), tag in (
                        (T0 - 1_000, adv, "advance, fresh"),
                        (T0, adv, "advance, at the head"),
                        (T0 + 5_000_000, adv, "advance, inside"),
                        (T0 - 1_000, no_adv, "no advance")):
                    s2 = set_window(s1, we)
                    kern, plain = run_pair(p, e.tables, s2, ws0, call,
                                           plain_fn)
                    check("queue_min_window", f"compact {label} dyn={dyn} "
                          f"{case} {tag}", kern, plain)
                    head = pair_time(plain["ctl"][2], plain["ctl"][3])
                    if head != want:
                        raise AssertionError(f"{label} {case}: min head "
                                             f"{head}, not {want}")
                    seen["live" if int(plain["ctl"][0]) else "done"] += 1
                    seen["fresh"] += int(plain["rounds"]) > int(s2.rounds)
                c_cases.append((p, e.tables, set_window(s1, T0 - 1_000), ws0))
    log(f"queue_min_window compact: equal on every case {seen}")
    if min(seen.values()) == 0:
        raise AssertionError(f"queue_min_window: a path was missed {seen}")
    # ... over S = 3, 8 and 9 scenarios in one launch (the flagship's cases)
    flag_cases = [c for c in c_cases if c[0].n_lanes == N_FLAG
                  and not c[0].stream_tiered and c[0].capacity == C_FLAG]
    for size in (3, 8, 9):
        batch = [flag_cases[i % len(flag_cases)] for i in range(size)]
        kern, want, _ = run_batch(batch, adv[0], adv[1])
        for i in range(size):
            check("queue_min_window", f"compact S={size} scenario {i}",
                  kern[i], want[i])
        log(f"queue_min_window compact: S = {size} in one launch equal to "
            "the plain loop")

    # C's hybrid mode on the hybrid flagship's heads: the turn's first step
    # and a later one, the host's next event absent or inside the window
    p = dataclasses.replace(heng.params, dynamic_runahead=True)
    sh = random_state(heng, heng.tables, rng)
    stops = 0
    for case in HEAD_CASES:
        if case == "tier_row":
            continue
        s1, want = heads_case(p, sh, case, rng)
        ws0 = lanes.make_workspace(p, DEV)
        for first in (True, False):
            for ext_t in (lanes.NEVER, T0 + 500):
                eh, el = ((lanes.NEVER32, lanes.NEVER32)
                          if ext_t >= lanes.NEVER
                          else (ext_t >> 31, ext_t & lanes.MASK31))
                turn = lanes.HybridTurn(eh, el, 900_000, first)
                kern, plain = run_pair(
                    p, heng.tables, set_window(s1, T0 + 2_000), ws0,
                    lambda a, t_=turn: kernels.hybrid_window(a, t_),
                    lambda p_, tb_, s, ws, t_=turn:
                        lanes.hybrid_window_plain(p_, s, ws, t_))
                check("hybrid_window", f"compact {case} first={first} "
                      f"ext={ext_t}", kern, plain)
                head = pair_time(plain["ctl"][2], plain["ctl"][3])
                if head != want:
                    raise AssertionError(f"hybrid {case}: min head {head}, "
                                         f"not {want}")
                stops += int(plain["ctl"][0]) == 0
    log(f"hybrid_window compact: equal; {stops} of 16 steps stopped")
    # C's fused mode: the window ends below the heads and the host takes
    # part in it, so each step consumes windows and refolds the guard over
    # 900 egress rows, up to k_eff
    pf = dataclasses.replace(heng.params, dynamic_runahead=True,
                             hybrid_k_cap=FUSE_K, ext_slots=FUSE_SLOTS)
    sf = clone(sh)
    sf.egress.copy_(egress_rows(pf, rng, 900, T0))
    sf.egress_count.fill_(900)
    refolds = 0
    for case in ("last_lane", "ties", "all_never"):
        s1, _want = heads_case(pf, sf, case, rng)
        for first in (True, False):
            we = T0 - 1_000_000
            ws0 = lanes.make_workspace(pf, DEV)
            ws0.ext.copy_(torch.tensor(fused_schedule(
                [we - 500_000] + list(we + np.arange(1, 14) * 900_000)),
                dtype=torch.int64))
            turn = lanes.FusedTurn(900_000, FUSE_K, first)
            s2 = set_window(s1, we)
            s2.egress_min_hi.fill_(lanes.NEVER32)
            s2.egress_min_lo.fill_(lanes.NEVER32)
            kern, plain = run_pair(
                pf, heng.tables, s2, ws0,
                lambda a, t_=turn: kernels.hybrid_fused_window(a, t_),
                lambda p_, tb_, s, ws, t_=turn:
                    lanes.hybrid_fused_window_plain(p_, s, ws, t_))
            check("hybrid_fused_window", f"compact {case} first={first}",
                  kern, plain)
            refolds += int(plain["fz"][1])
    log(f"hybrid_fused_window compact: equal; {refolds} windows consumed "
        "(a refold pass each)")
    if refolds == 0:
        raise AssertionError("hybrid_fused_window: no refold pass ran")


# ---- kernels A and G: edge cases -------------------------------------------

TOP31 = (1 << 31) - 1


def slot_state(eng: GpuEngine, tb, rng, case: str, pkt_lanes=None):
    """A seeded state for kernel A's edge cases, over active_tables' mixed
    models: ``all`` — every lane's first K columns pop (passive lanes K
    timer ticks inside the window, active lanes a same-instant PACKET
    prefix, both sides of the bootstrap end); ``none`` — every head at or
    past the window end (T0 + 10 ms); ``mixed`` — active_state's ties.
    ``pkt_lanes`` (a mask) take PACKETs as the active lanes do.  The send,
    draw, local and mesh-offset counters sit at the int32 top, so the
    walks' prefixes wrap mid-row."""
    p = eng.params
    n, c, k = p.n_lanes, p.capacity, p.pops_per_iter
    s = active_state(eng, tb, rng)
    if case != "mixed":
        lane = np.arange(n)[:, None]
        col = np.arange(c)[None, :]
        model = tb.model.cpu().numpy()[:, None]
        passive = np.isin(model, sorted(lanes.PASSIVE_MODELS))
        if pkt_lanes is not None:
            passive = passive & ~pkt_lanes[:, None]
        if case == "all":
            start = T0 + rng.integers(0, 9, (n, 1)) * 1_000_000
            times = np.where(col < k, start + np.where(passive, col * 1000, 0),
                             T0 + 20_000_000 + col)
        else:
            times = T0 + 10_000_000 + rng.integers(0, 3, (n, c)) * 1_000_000
        kind = np.where(passive & (col < k), lanes.LOCAL, lanes.PACKET)
        src = np.where(kind == lanes.LOCAL, lane, rng.integers(0, n, (n, c)))
        auxh = (kind << lanes.AUX_KIND_SHIFT) | (src << lanes.AUX_SRC_SHIFT)
        auxl = col + rng.integers(0, 1 << 20, (n, 1)) * c
        size = np.where(kind == lanes.LOCAL, 0, rng.integers(28, 1500, (n, c)))
        rows = sorted_rows(times, auxh.astype(np.int32), auxl.astype(np.int32),
                           size.astype(np.int32))
        s = s._replace(q_thi=t32(rows[0]), q_tlo=t32(rows[1]),
                       q_auxh=t32(rows[2]), q_auxl=t32(rows[3]),
                       q_size=t32(rows[4]))
    near = TOP31 - rng.integers(0, k + 1, n)
    return s._replace(
        send_seq=t32(np.where(rng.random(n) < 0.5, near,
                              rng.integers(0, 99, n))),
        app_draws=t32(np.where(rng.random(n) < 0.5, near, 7)),
        local_seq=t32(np.where(rng.random(n) < 0.5, near, 3)),
        m_peer_offset=t32(np.where(rng.random(n) < 0.5, near, 11)),
        m_sent=t32(rng.integers(0, 1000, n)))


def slot_engine(doc_fn, n: int, k: int):
    """An engine of ``n`` hosts with K = ``k``, its config ``doc_fn(n)``."""
    cfg = doc_fn(n)
    cfg.experimental.tpu_events_per_round = k
    cfg.experimental.tpu_lane_queue_capacity = max(
        cfg.experimental.tpu_lane_queue_capacity, k + 8)
    return GpuEngine(cfg, log_capacity=0)


def slot_case(eng, rng, case: str, log_cap: int, dyn: bool):
    p = dataclasses.replace(active_params(eng, dyn), log_capacity=log_cap)
    tb = active_tables(eng, rng)
    s0 = slot_state(eng, tb, rng, case)
    if log_cap:
        s0 = s0._replace(log=torch.zeros((log_cap, 6), dtype=torch.int64,
                                         device=DEV))
    ws0 = lanes.make_workspace(p, DEV)
    ws0.ctl[0] = 1
    return p, tb, s0, ws0


def a_plain(p_, tb_, s, ws):
    lanes.lane_slots_plain(p_, tb_, s, ws)


def a_counts(p, s0, plain) -> dict:
    k = p.pops_per_iter
    return {"popped": int((s0.q_thi[:, :k] != plain["q_thi"][:, :k]).sum()),
            **{f: int((plain[f].long() - s0._asdict()[f].long()).sum())
               for f in ("n_sends", "n_loss", "n_hops", "n_delivered")}}


def stream_side_by_side(eng, rng, log_cap: int):
    """stream_case's state with the lanes that own no endpoint row turned
    into phold, ping, tgen and empty lanes over one graph node, counters at
    the int32 top: passive, active and stream lanes side by side."""
    p, tb, s0 = stream_case(eng, rng)
    n = p.n_lanes
    stream = np.zeros(n, bool)
    stream[tb.flow_lanes.cpu().numpy()] = True
    model = np.where(stream, tb.model.cpu().numpy(), rng.choice(
        [lanes.M_PHOLD, lanes.M_PING_CLIENT, lanes.M_PING_SERVER,
         lanes.M_TGEN_MESH, lanes.M_NONE], n))
    p = dataclasses.replace(p, models_present=tuple(range(9)),
                            log_capacity=log_cap)
    tb = tb._replace(model=t32(model), p_count=t32(rng.integers(0, 9, n)))
    near = TOP31 - rng.integers(0, p.pops_per_iter + 1, n)
    s0 = s0._replace(send_seq=t32(np.where(stream, s0.send_seq.cpu().numpy(),
                                           near)),
                     app_draws=t32(near))
    if log_cap:
        s0 = s0._replace(log=torch.zeros((log_cap, 6), dtype=torch.int64,
                                         device=DEV))
    ws0 = lanes.make_workspace(p, DEV)
    ws0.ctl[0] = 1
    return p, tb, s0, ws0


G_CASES = ("empty", "exact", "over1", "all", "ties", "unsorted", "random")


def g_inputs(p, s, ws, rng, cases=G_CASES) -> dict:
    """Kernel G's inputs, one case a row (in turn): the queue rows of
    ``s.stream.q`` and the candidate block of ``ws.tier_blk``.  ``empty``:
    no valid entry; ``exact``: C2 valid in all; ``over1``: C2 + 1;
    ``all``: every candidate valid and the queue full; ``ties``:
    candidates with the keys of queue entries; ``unsorted``: the queue's
    valid entries out of key order (no F leaves that: G's fallback);
    ``random``: some of each.  Invalid entries keep stale words.  Returns
    the valid entries by case."""
    sf, c2, ks, cx = p.s_flows, p.stream_capacity, p.stream_pops, p.cross_cap
    s2, wt, nb = 2 * sf, p.tier_width, ks * lanes.PUMP_BURST
    sa0, se0, bo0, cx0, _end = p.tier_layout
    q = rng.integers(-(1 << 31), 1 << 31, (7, s2, c2))
    q[:2] = lanes.NEVER32
    cand = rng.integers(-(1 << 31), 1 << 31, (7, s2, wt))
    cand[:2] = lanes.NEVER32
    seen = {}

    def keys(m: int):
        t = T0 + rng.integers(0, 40, m) * 250_000
        kind = rng.choice([lanes.PACKET, lanes.DELIVERY, lanes.LOCAL], m)
        auxh = kind << 29 | rng.integers(0, p.n_lanes, m) << 12
        return np.stack([t >> 31, t & lanes.MASK31, auxh,
                         rng.integers(-(1 << 31), 1 << 31, m),
                         rng.integers(28, 1500, m),
                         rng.integers(-(1 << 31), 1 << 31, m),
                         rng.integers(-(1 << 31), 1 << 31, m)])

    for r in range(s2):
        case = cases[r % len(cases)]
        slots = np.arange(wt)
        if r < sf:  # a client row's bursts are empty
            slots = slots[(slots < 3 * ks) | (slots >= 3 * ks + nb)]
        n_q = {"empty": 0, "exact": c2 // 2, "over1": c2 // 2, "all": c2,
               "ties": c2 // 2, "unsorted": c2 // 2}.get(
            case, int(rng.integers(0, c2 + 1)))
        n_c = {"empty": 0, "exact": c2 - n_q, "over1": c2 - n_q + 1,
               "all": len(slots), "ties": min(24, len(slots)),
               "unsorted": 20}.get(case, int(rng.integers(0, 40)))
        qk = keys(n_q)
        order = np.lexsort((qk[3].astype(np.int32), qk[2].astype(np.int32),
                            (qk[0] << 31) | qk[1]))
        qk = qk[:, order]
        if case == "unsorted" and n_q > 1:
            qk = qk[:, ::-1]
        q[:, r, :n_q] = qk
        ck = keys(n_c)
        if case == "ties" and n_q:
            pick = rng.integers(0, n_q, n_c)
            ck[:4] = qk[:4, pick]
        cand[:, r, rng.choice(slots, n_c, replace=False)] = ck
        seen[case] = seen.get(case, 0) + n_q + n_c
    # the candidate block, as _tier_candidates reads it
    blk = ws.tier_blk.cpu().numpy().copy()
    rows = np.arange(s2)
    peer = np.where(rows < sf, rows + sf, rows - sf)
    for x in range(ks):
        blk[:, x * s2 + rows] = cand[:, :, x]
        blk[:, sa0 + x * s2 + rows] = cand[:, :, ks + x]
        blk[:, se0 + x * s2 + peer] = cand[:, :, 2 * ks + x]
    for x in range(nb):
        blk[:, bo0 + x * sf + rows[sf:] - sf] = cand[:, sf:, 3 * ks + x]
    for x in range(cx):
        blk[:, cx0 + rows * cx + x] = cand[:, :, 3 * ks + nb + x]
    ws.tier_blk.copy_(t32(blk))
    s.stream.q.copy_(t32(q))
    return seen


def g_plain(p_, tb_, s, ws):
    lanes.tier_merge_plain(p_, tb_, s, ws)


@phase("kernels A and G on their edge cases vs plain: A at 1, 31, 32, 33, 63, "
       "64, 65, 10,000 and 48,000 lanes, K = 2, 3, 8 and 40 (two rounds of a "
       "warp), every column popped and none, counters at the int32 wrap, "
       "passive, active and stream lanes side by side (a star lane of 40 "
       "rows), the external arm, S = 1, 3, 8, 9; G on empty rows, exactly "
       "C2, C2 + 1, every candidate valid, ties between the queue and the "
       "candidates, an unsorted queue, the wide row in m_scratch, S = 1, 3, "
       "8, 9 (tolerance: exact, integer)")
def check_slot_cases():
    rng = np.random.default_rng(SEED + 12)
    # A: lane counts around the groups' warp and block boundaries
    for n in (1, 31, 32, 33, 63, 64, 65):
        for label, fn, k in (("flagship", lambda m: flagship(1, n_hosts=m), 2),
                             ("phold", lambda m: phold(n_hosts=m), 8),
                             ("phold", lambda m: phold(n_hosts=m), 3),
                             ("phold", lambda m: phold(n_hosts=m), 40)):
            eng = slot_engine(fn, n, k)
            for case in ("all", "none", "mixed"):
                for log_cap in (0, 4_000):
                    p, tb, s0, ws0 = slot_case(eng, rng, case, log_cap,
                                               dyn=log_cap > 0)
                    tag = f"{label} N={n} K={k} {case} L={log_cap}"
                    kern, plain = run_pair(p, tb, s0, ws0, kernels.lane_slots,
                                           a_plain)
                    check("lane_slots", tag, kern, plain)
                    got = a_counts(p, s0, plain)
                    if case == "none" and got["popped"]:
                        raise AssertionError(f"{tag}: popped {got}")
                    if case == "all" and got["popped"] != n * k:
                        raise AssertionError(f"{tag}: popped {got}")
        log(f"lane_slots N={n}: equal at K = 2, 3, 8, 40, every column "
            "popped, none, and ties")
    # the full widths, every column popped, and S = 1, 3, 8, 9 in one launch
    for n in (N_FLAG, 48_000):
        eng = slot_engine(lambda m: flagship(1, n_hosts=m), n, K_FLAG)
        for case in ("all", "none", "mixed"):
            p, tb, s0, ws0 = slot_case(eng, rng, case, 100_000, dyn=True)
            kern, plain = run_pair(p, tb, s0, ws0, kernels.lane_slots, a_plain)
            check("lane_slots", f"N={n} {case}", kern, plain)
            log(f"lane_slots N={n} {case}: equal; {a_counts(p, s0, plain)}")
    eng = slot_engine(lambda m: flagship(1, n_hosts=m), 1000, K_FLAG)
    for size in (1, 3, 8, 9):
        cases = [slot_case(eng, rng, ("all", "mixed", "none")[i % 3], 0,
                           dyn=False) for i in range(size)]
        kern, want, _inputs = run_batch(cases, kernels.lane_slots, a_plain,
                                        done=1 if size > 1 else None)
        for i in range(size):
            check("lane_slots", f"sweep S={size} scenario {i}", kern[i],
                  want[i])
        log(f"lane_slots S={size}: one launch equal to the plain loop"
            + (" (scenario 1 done)" if size > 1 else ""))
    # passive, active and stream lanes side by side; a star lane of 40 rows
    for name, doc in (("mixed", None),
                      ("star", star_doc(servers=2, fan_in=40))):
        seng = (GpuEngine(mixed_mesh(1), log_capacity=0) if doc is None
                else GpuEngine(ConfigOptions.from_dict(doc), log_capacity=0))
        for log_cap in (0, 1_000_000):
            p, tb, s0, ws0 = stream_side_by_side(seng, rng, log_cap)
            kern, plain = run_pair(p, tb, s0, ws0, kernels.lane_slots, a_plain)
            check("lane_slots", f"side by side {name} L={log_cap}", kern,
                  plain)
            got = sx_counts(p, plain["sx_blk"])
            log(f"lane_slots side by side {name} L={log_cap}: equal; "
                f"{a_counts(p, s0, plain)}, stream block {got}")
            if not (got["sends"] or got["rto_arms"]):
                raise AssertionError(f"{name}: no stream emit")
    # the external arm, every column popped and none
    cfg = hybrid_cfg("slots")
    ext = external_mask(cfg)
    heng = GpuEngine(cfg, log_capacity=60_000, external=ext)
    for case in ("all", "none"):
        p = heng.params
        tb = heng.tables
        s0 = slot_state(heng, tb, rng, case, pkt_lanes=ext)
        ws0 = lanes.make_workspace(p, DEV)
        ws0.ctl[0] = 1
        kern, plain = run_pair(p, tb, s0, ws0, kernels.lane_slots, a_plain)
        check("lane_slots:external", f"slot case {case}", kern, plain)
        n_eg = int(plain["eg_valid"].sum())
        log(f"lane_slots external {case}: equal; {n_eg} egress rows")
        if (n_eg > 0) != (case == "all"):
            raise AssertionError(f"external {case}: {n_eg} egress rows")

    # G: a case a row at the tiered mixed mesh's shapes, S = 1, 3, 8, 9
    geng = GpuEngine(mixed_tiered(1), log_capacity=0)

    def g_case(log_cap: int):
        p, tb, s0 = tier_case(geng, rng, True, log_cap)
        ws0 = lanes.make_workspace(p, DEV)
        ws0.ctl[0] = 1
        seen = g_inputs(p, s0, ws0, rng)
        return (p, tb, s0, ws0), seen

    for log_cap in (0, 200_000):
        (p, tb, s0, ws0), seen = g_case(log_cap)
        kern, plain = run_pair(p, tb, s0, ws0, kernels.tier_merge, g_plain)
        check("tier_merge", f"slot cases L={log_cap}", kern, plain)
        over = (plain["stream.v"][lstr.TV_N_QUEUE]
                - s0.stream.v[lstr.TV_N_QUEUE]).tolist()
        log(f"tier_merge cases L={log_cap}: equal on {2 * p.s_flows} rows; "
            f"valid entries by case {seen}; overflow by row (first 7) "
            f"{over[:7]}")
        if over[2] != 1 or over[1] != 0 or over[3] == 0:
            raise AssertionError(f"tier merge cases: overflow {over[:7]}")
    for size in (3, 8, 9):
        cases = [g_case(100_000)[0] for _ in range(size)]
        kern, want, _inputs = run_batch(cases, kernels.tier_merge, g_plain,
                                        done=1)
        for i in range(size):
            check("tier_merge", f"sweep S={size} scenario {i}", kern[i],
                  want[i])
        log(f"tier_merge S={size}: one launch equal to the plain loop "
            "(scenario 1 done)")
    # the wide row: C2 = 8,400, its rows in m_scratch
    weng = GpuEngine(wide_pair(True), log_capacity=0)
    p = dataclasses.replace(weng.params, log_capacity=100_000)
    paths = merge_paths(p)
    if not paths["tier merge"].startswith("global"):
        raise AssertionError(f"the wide tier row is not global: {paths}")
    for cases in (("all",), ("random",), ("unsorted",)):
        s0 = weng.initial_state()._replace(
            log=torch.zeros((100_000, 6), dtype=torch.int64, device=DEV))
        ws0 = lanes.make_workspace(p, DEV)
        ws0.ctl[0] = 1
        seen = g_inputs(p, s0, ws0, rng, cases)
        kern, plain = run_pair(p, weng.tables, s0, ws0, kernels.tier_merge,
                               g_plain)
        check("tier_merge", f"wide {cases[0]}", kern, plain)
        log(f"tier_merge wide {cases[0]}: equal in m_scratch "
            f"({paths['tier merge']}); valid {seen}")


# ---- kernels E and H on their edge cases -----------------------------------

ROW_CASES = ("unsorted", "noncanonical", "ties", "overflow", "empty",
             "random")


def split_source(p, r: int, x: int) -> int:
    """The stream block entry candidate x of endpoint row r takes, or -1
    (a client row's padding): csrc/lanes.cu split_source."""
    k, sf = p.pops_per_iter, p.s_flows
    s2 = 2 * sf
    if x < k:
        return x * s2 + (r + sf if r < sf else r - sf)
    if x < 2 * k:
        return k * s2 + (x - k) * s2 + r
    return -1 if r < sf else 4 * k * sf + (x - 2 * k) * sf + (r - sf)


def row_entries(rng, m: int) -> np.ndarray:
    """``m`` valid entries [7, m] at a few instants: PACKETs, DELIVERYs and
    LOCALs, aux words that tie now and then, payload words."""
    t = T0 + rng.integers(0, 6, m) * 250_000
    kind = rng.choice([lanes.PACKET, lanes.DELIVERY, lanes.LOCAL], m)
    return np.stack([t >> 31, t & lanes.MASK31,
                     kind << 29 | rng.integers(0, 12, m) << 12,
                     rng.integers(-3, 3, m), rng.integers(28, 1500, m),
                     rng.integers(0, 1 << 30, m), rng.integers(0, 1 << 20, m)])


def key_sorted(e: np.ndarray) -> np.ndarray:
    """Entries [W, m] in (key, index) order."""
    order = np.lexsort((e[3].astype(np.int32), e[2].astype(np.int32),
                        (e[0].astype(np.int64) << 31) | e[1]))
    return e[:, order]


EMPTY7 = np.array([lanes.NEVER32, lanes.NEVER32, 0, 0, 0, 0, 0])[:, None]


def stale(rng, m: int) -> np.ndarray:
    """``m`` consumed entries as A leaves them: the NEVER time, their aux,
    size and payload words kept (keyed above the canonical empty)."""
    e = row_entries(rng, m)
    e[:2] = lanes.NEVER32
    e[2] = (lanes.PACKET << 29) | rng.integers(1, 12, m) << 12
    return key_sorted(e)


def e_inputs(p, tb, s, ws, case: str, rng) -> None:
    """E's inputs by ``case`` (as tests/test_torch_row_merge.py's): each
    endpoint lane's queue row and the stream block entries the static
    layout gives its row."""
    c, w_s, s2 = p.capacity, p.stream_row_width, 2 * p.s_flows
    el = tb.flow_lanes.tolist()
    sx = np.empty(tuple(ws.sx_blk.shape), np.int64)
    sx[0] = p.n_lanes
    sx[1:] = EMPTY7
    q = [w.cpu().numpy().astype(np.int64) for w in lanes._queue_words(p, s)]
    for r in range(s2):
        n_q = {"empty": 0, "overflow": c - 3, "unsorted": c // 2}.get(
            case, int(rng.integers(0, c + 1)))
        row = np.repeat(EMPTY7, c, axis=1)
        qe = key_sorted(row_entries(rng, n_q))
        if case == "unsorted":
            qe = qe[:, ::-1]
        row[:, :n_q] = qe
        if case == "noncanonical":
            row[:, n_q:] = stale(rng, c - n_q)
        for w in range(7):
            q[w][el[r]] = row[w]
        slots = [x for x in range(w_s) if split_source(p, r, x) >= 0]
        n_c = min({"empty": 0, "overflow": len(slots), "ties": 12}.get(
            case, int(rng.integers(0, len(slots) + 1))), len(slots))
        ce = row_entries(rng, n_c)
        if case == "ties" and n_q:
            ce[:4] = qe[:4, rng.integers(0, n_q, n_c)]
        if case == "noncanonical":
            # NEVER entries with their words, and canonical keys with size
            # and payload words
            ce[:2, : n_c // 3] = lanes.NEVER32
            ce[:4, n_c // 3: 2 * n_c // 3] = EMPTY7[:4]
        for x, e in zip(rng.choice(slots, n_c, replace=False), ce.T):
            idx = split_source(p, r, x)
            sx[0, idx] = el[r]
            sx[1:, idx] = e
    ws.sx_blk.copy_(t32(sx))
    for w, plane in zip(q, lanes._queue_words(p, s)):
        plane.copy_(t32(w))


def e_case(eng, rng, case: str, log_cap: int, sample: float = 0.0):
    """E's params (with a log and, at ``sample`` > 0, flowtrace), tables,
    state and workspace for ``case``."""
    p = dataclasses.replace(eng.params, log_capacity=log_cap)
    if sample:
        p = traced(p, sample)
    s0 = with_log(eng.initial_state(), log_cap)
    if sample:
        s0 = with_ring(s0, p.flow_capacity)
    ws0 = lanes.make_workspace(p, DEV)
    ws0.ctl[0] = 1
    e_inputs(p, eng.tables, s0, ws0, case, rng)
    return p, eng.tables, s0, ws0


def e_plain(p_, tb_, s, ws):
    lanes.stream_rows_merge_plain(p_, tb_, s, ws)


def h_groups_block(p, rng, sizes: dict, t0: int, ties: bool) -> torch.Tensor:
    """An injection block on the card whose lane ``i`` takes ``sizes[i]``
    rows at shuffled positions, the rest invalid, at a few instants; with
    ``ties`` the aux words tie too (the row index decides)."""
    b = p.inject_batch
    total = sum(sizes.values())
    valid = np.zeros(b, bool)
    dst = np.zeros(b, np.int64)
    at = rng.permutation(b)[:total]
    valid[at] = True
    dst[at] = np.repeat(list(sizes), list(sizes.values()))
    t = t0 + rng.integers(0, 3, b) * 1_000_000
    src = rng.integers(0, 4 if ties else p.n_lanes, b)
    blk = np.stack([
        valid, dst, np.where(valid, t >> 31, lanes.NEVER32),
        np.where(valid, t & lanes.MASK31, lanes.NEVER32),
        (lanes.PACKET << lanes.AUX_KIND_SHIFT) | (src << lanes.AUX_SRC_SHIFT),
        rng.integers(0, 4, b) if ties else (1 << 22) + np.arange(b),
        rng.integers(60, 1500, b)])
    return t32(blk)


def h_state(eng, tb, rng, stale_lanes, unsorted_lanes):
    """A hybrid state whose queue rows of ``stale_lanes`` end in consumed
    entries and whose rows of ``unsorted_lanes`` are reversed."""
    s = random_state(eng, tb, rng)
    c = eng.params.capacity
    q = [w.cpu().numpy().astype(np.int64)
         for w in (s.q_thi, s.q_tlo, s.q_auxh, s.q_auxl, s.q_size)]
    for i in stale_lanes:
        free = int((q[0][i] == lanes.NEVER32).sum())
        m = max(free // 2, 1)
        e = stale(rng, m)
        for w in range(5):
            q[w][i, c - m:] = e[w]
    for i in unsorted_lanes:
        for w in q:
            w[i] = w[i][::-1]
    return s._replace(**{f: t32(w) for f, w in zip(
        ("q_thi", "q_tlo", "q_auxh", "q_auxl", "q_size"), q)})


@phase("kernels E and H on their edge cases vs plain: E's unsorted queue "
       "rows (the fallback), non-canonical empties on both sides, keys "
       "equal across them, overflow with a log and flowtrace, all-empty "
       "rows, C = 8,400 in m_scratch, S = 1, 3 and 9; H's groups of 0, "
       "1, 31, 32, 33, Cxi, Cxi + 1 and 400 rows, ties broken by the row index, empty groups over rows that must "
       "shift and rows that must not, unsorted rows, S = 1, 3 and 9 "
       "(tolerance: exact, integer)")
def check_row_cases():
    rng = np.random.default_rng(SEED + 13)
    eng = GpuEngine(mixed_mesh(1), log_capacity=0)
    for case in ROW_CASES:
        for log_cap, sample in ((0, 0.0), (200_000, 0.0), (200_000, 1.0)):
            p, tb, s0, ws0 = e_case(eng, rng, case, log_cap, sample)
            tag = f"{case} L={log_cap} flowtrace={sample}"
            kern, plain = run_pair(p, tb, s0, ws0, kernels.stream_rows_merge,
                                   e_plain)
            check("stream_rows_merge", tag, kern, plain)
            el = tb.flow_lanes.long()
            over = int((plain["n_queue"][el] - s0.n_queue[el]).sum())
            if log_cap and sample:
                log(f"stream_rows_merge {tag}: equal; overflow {over}, "
                    f"flow sheds {int(plain['fl_valid'].sum())}")
            if case == "overflow" and not over:
                raise AssertionError(f"E {tag}: no overflow")
    moving = [c for c in ROW_CASES if c != "empty"]  # check_batch's rule
    for size in (3, 9):
        cases = [e_case(eng, rng, moving[i % len(moving)], 100_000)
                 for i in range(size)]
        check_batch("stream_rows_merge", f"row cases S={size}", cases,
                    kernels.stream_rows_merge, e_plain)
    # the wide rows: C = 8,400, E's rows in m_scratch
    weng = GpuEngine(wide_pair(False), log_capacity=0)
    paths = merge_paths(weng.params)
    if not paths["stream merge"].startswith("global"):
        raise AssertionError(f"the wide stream rows are not global: {paths}")
    for case in ("random", "unsorted", "overflow", "noncanonical"):
        p, tb, s0, ws0 = e_case(weng, rng, case, 100_000)
        kern, plain = run_pair(p, tb, s0, ws0, kernels.stream_rows_merge,
                               e_plain)
        check("stream_rows_merge", f"wide {case}", kern, plain)
    log(f"stream_rows_merge: equal on every row case, S = 3 and 9, and "
        f"C = 8,400 ({paths['stream merge']})")

    # H at the hybrid flagship's shapes (C = Cxi = 64)
    cfg = hybrid_cfg("rows")
    ext = np.nonzero(external_mask(cfg))[0]
    heng = GpuEngine(cfg, log_capacity=0, external=external_mask(cfg))
    p, tb = heng.params, heng.tables
    cxi = p.inject_cap
    sizes = [1, 31, 32, 33, cxi, cxi + 1]
    group_lanes = ext[1:1 + len(sizes)]
    blocks = {"groups": dict(zip(group_lanes.tolist(), sizes)),
              "400 to one lane": {int(ext[0]): 400}}
    stale_lanes = [int(ext[0]), int(group_lanes[2]), int(ext[-1]),
                   int(ext[-2])]
    unsorted_lanes = [int(group_lanes[4]), int(ext[-3])]
    for name, grp in blocks.items():
        for ties in (False, True):
            s0 = h_state(heng, tb, rng, stale_lanes, unsorted_lanes)
            ws0 = lanes.make_workspace(p, DEV)
            blk = h_groups_block(p, rng, grp, T0, ties)
            tag = f"{name} ties={ties}"
            kern, plain = run_pair(
                p, tb, s0, ws0, lambda a, b_=blk: kernels.inject_merge(a, b_),
                lambda p_, tb_, s, ws, b_=blk:
                    lanes.inject_merge_plain(p_, tb_, s, b_))
            check("inject_merge", tag, kern, plain)
            moved = ((plain["q_thi"] != s0.q_thi)
                     | (plain["q_auxh"] != s0.q_auxh)).any(dim=1)
            for i in stale_lanes + unsorted_lanes:
                if i not in grp and not bool(moved[i]):
                    raise AssertionError(f"H {tag}: lane {i} did not move")
    log(f"inject_merge: equal on groups {sizes} and 400, with and without "
        "ties, stale and unsorted rows")
    for size in (3, 9):
        blk = h_groups_block(p, rng, blocks["groups"], T0, True)
        cases = []
        for _ in range(size):
            s0 = h_state(heng, tb, rng, stale_lanes, unsorted_lanes)
            cases.append((p, tb, s0, lanes.make_workspace(p, DEV)))
        kern, want, _inputs = run_batch(
            cases, lambda a, b_=blk: kernels.inject_merge(a, b_),
            lambda p_, tb_, s, ws, b_=blk:
                lanes.inject_merge_plain(p_, tb_, s, b_))
        for i in range(size):
            check("inject_merge", f"sweep S={size} scenario {i}", kern[i],
                  want[i])
        log(f"inject_merge S={size}: one launch equal to the plain loop")


# ---- timing ----------------------------------------------------------------


def _event_ms(fn, restore, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` launches, each on the
    restored snapshot (restores are outside the timed spans)."""
    total = 0.0
    for _ in range(reps):
        restore()
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        fn()
        b.record()
        b.synchronize()
        total += a.elapsed_time(b)
    return total / reps


def library_ms(fn, reps: int = 20) -> tuple:
    """Device time of one PyTorch call ``fn`` (a yardstick the port never
    calls) and where it came from: the profiler's device activity
    (kernels, memsets, copies) over ``reps`` calls, per call (profiled
    again, up to three times, while the profiler records no device time,
    as ``profile_steps`` does), "profiler"; else CUDA events around the
    calls, which count the gaps between its kernels too, "events"."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()  # warm up
    torch.cuda.synchronize()
    for _attempt in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = sum(ev.time_range.elapsed_us() for ev in prof.events()
                 if ev.device_type == DeviceType.CUDA)
        if us:
            return us / 1e3 / reps, "profiler"
        log(f"library_ms: no device time in {len(prof.events())} events")
    # the profiler recorded none: CUDA events around the calls instead
    # (device time and the gaps between its kernels)
    ms = _event_ms(fn, lambda: None, reps)
    log(f"library_ms: {ms:.5f} ms from CUDA events, not the profiler")
    return ms, "events"


def head_amin(s):
    """C's reduction as one PyTorch call: ``torch.amin`` over column 0 of
    an int64 [N, C] copy of the queue times (NEVER where empty), a strided
    view that reads the same sectors as C's heads; the window law is not in
    it (nor the tier's heads)."""
    t = torch.where(s.q_thi == lanes.NEVER32, lanes.NEVER,
                    (s.q_thi.to(torch.int64) << 31) | s.q_tlo.to(torch.int64))
    return lambda: torch.amin(t[:, 0])


def selections(p, ws):
    """D's compaction as PyTorch calls: boolean-mask selection (rows kept
    in index order) of the log's records and the ring's flow records
    (without the ring's window stamp), and on a hybrid run of the egress
    candidates, with ``torch.amin`` over their DELIVERED times; the masks
    are made before the timing."""
    calls = []
    if p.log_capacity:
        recs, mask = ws.recs, ws.rec_valid.bool()
        calls.append(lambda: recs[mask])
    if p.flowtrace:
        fl, fmask = ws.fl_recs, ws.fl_valid.bool()
        calls.append(lambda: fl[fmask])
    if p.external_any:
        eg, emask = ws.eg_recs, ws.eg_valid.bool()

        def egress():
            sel = eg[emask]
            return torch.amin(torch.where(sel[:, 5] == lanes.DELIVERED,
                                          sel[:, 0], lanes.NEVER))
        calls.append(egress)
    return lambda: [c() for c in calls]


def kernel_bytes(p: lanes.LaneParams, tb, ws, cnt: dict) -> dict:
    """Bytes each kernel must move at these inputs (``ws`` after one A, one
    B and, in untiered one-to-one stream configs, one E, or on a tiered run
    one F and one G): every input read once, every output written once.  An
    entry (a queue slot, a self, outbound, stream or tier block entry) is
    read or written whole only when valid: an empty one needs its time word
    alone.  A logging run writes every record slot's valid flag but only
    the valid rows (48 bytes each): B the merge tail's, E the split tail's,
    A those of its popped slots, its PCAP_TX captures and stream sends, F
    its tier records' (its captures included), G the tier tail's.  With
    netobs, each ``nb_*`` word a kernel touches is read and written once.
    ``cnt``: this iteration's counts — ``head`` (valid entries of the [N]
    head columns A reads), ``popped`` (those A popped), ``self``,
    ``out``, ``sx`` (valid entries of A's self, outbound and stream
    blocks), ``b_in``/``b_out`` (valid [N] queue entries before and after
    B), ``e_in``/``e_out`` (valid entries of the endpoint lanes' rows
    before and after E), and on a tiered run ``tier_popped`` (the events F
    popped), ``cross`` (the valid entries of B's diverted block), ``cand``
    (F's valid candidates), ``merged`` (the valid entries G merged: queue
    and candidates) and ``kept`` (the valid entries of G's rows)."""
    pl = p.lane
    n, c, k, cx = p.n_lanes, p.capacity, p.pops_per_iter, p.cross_cap
    sw, words = pl.self_width, pl.words
    g = int(tb.lat.shape[0])
    rg = p.rec_offsets
    n_rec = ws.rec_valid.numel() if p.log_capacity else 0
    tail_rows = int(ws.rec_valid[:rg.split].sum()) if n_rec else 0
    split_rows = int(ws.rec_valid[rg.split:rg.slots].sum()) if n_rec else 0
    a_rows = int(ws.rec_valid[rg.slots:].sum()) if n_rec else 0

    def entries(valid: int, total: int, width: int) -> int:
        return valid * width * 4 + (total - valid) * 4

    state_vec = (len(lanes._SLOT_FIELDS) - 1) * 4 + 1  # [N] words (+ the bool)
    tables = 17 * 4  # [N] table words read per lane
    a_in = (entries(cnt["head"], n * k, words) + n * (state_vec + tables)
            + g * g * (4 + 8) + 1025 * 4 + 4 * 4)
    a_out = (cnt["popped"] * 2 * 4 + n * state_vec
             + entries(cnt["self"], n * sw, words)
             + entries(cnt["out"], n * k, 6) + 4)
    n_ent = pl.stream_entries
    if pl.stream_present:
        # the flow rows read and written, the [2S] flow tables (14 int32, the
        # int64 threshold), the lane -> row table, the stream block written
        s2 = 2 * p.s_flows
        a_in += s2 * lstr.N_COLS * 4 + s2 * (14 * 4 + 8) + (n + 1 + s2) * 4
        a_out += s2 * lstr.N_COLS * 4 + entries(cnt["sx"], n_ent, 8)
    if p.log_capacity:
        a_out += (rg.end - rg.slots) * 4 + a_rows * 6 * 8
    if p.pcap_any and p.log_capacity:
        a_in += n + (2 * p.s_flows if pl.stream_pcap else 0)  # bool tables
    if p.netobs:
        a_in += n * 3 * 4 + 4  # nb_txb, nb_rxb, nb_thr; nb_win
        a_out += n * 3 * 4 + 4
    x_ent = k * n + (0 if p.split else n_ent)
    b_in = (entries(cnt["b_in"], n * c, words)
            + entries(cnt["self"], n * sw, words) + x_ent * 4 + n * 4)
    # the selected cross entries (stream entries carry two more words): the
    # first Cx of each lane's group of exchanged entries
    dst = ws.out_blk[0].reshape(-1)
    if pl.stream_present and not p.split:
        dst = torch.cat([dst, ws.sx_blk[0]])
    group = torch.bincount(dst.long(), minlength=n + 1)[:n]
    b_in += int(group.clamp(max=cx).sum()) * words * 4
    b_out = entries(cnt["b_out"], n * c, words) + n * 4
    if p.log_capacity:
        b_out += rg.split * 4 + tail_rows * 6 * 8
    if p.netobs:  # nb_shed
        b_in += n * 4
        b_out += n * 4
    f_io = g_io = 0
    if p.stream_tiered:
        s2, ks, c2 = 2 * p.s_flows, p.stream_pops, p.stream_capacity
        sa0, _se0, _bo0, cx0, t_end = p.tier_layout
        # B: the lane -> row table and the diverted cross block written
        b_in += n + n * 4
        b_out += (t_end - cx0) * 4 + cnt["cross"] * 6 * 4
        # F: its K_s columns (7 words) read and the popped time words
        # written, the flow rows and the 22 tier vector rows (25 with
        # netobs) read and written, its [2S] tables (16 int32, the int64
        # threshold, with pcap the bool), the candidate channels written;
        # records: every slot's flag, the valid rows
        rows = 22 + (3 if p.netobs else 0)
        f_io = (s2 * ks * 7 * 4 + cnt["tier_popped"] * 2 * 4
                + 2 * s2 * (lstr.N_COLS + rows) * 4 + s2 * (16 * 4 + 8)
                + 1025 * 4 + cx0 * 4 + cnt["cand"] * 6 * 4)
        if p.netobs:
            f_io += 2 * 4  # nb_win
        tg = p.tier_rec_offsets
        if p.log_capacity:
            f_io += ((tg.tail - tg.rec) * 4
                     + int(ws.rec_valid[tg.rec:tg.tail].sum()) * 6 * 8)
            if p.stream_pcap:
                f_io += s2
        # G: the time word of every entry it can hold (a client row has no
        # burst block), the other six of each valid one; the rows written
        # the same way; the overflow counter; records: every tail flag, the
        # valid rows
        g_in = s2 * (c2 + p.tier_width) - p.s_flows * ks * lanes.PUMP_BURST
        g_io = (g_in * 4 + cnt["merged"] * 6 * 4 + s2 * c2 * 4
                + cnt["kept"] * 6 * 4 + s2 * 8 + s2 * 4)
        if p.log_capacity:
            g_io += ((tg.end - tg.tail) * 4
                     + int(ws.rec_valid[tg.tail:tg.end].sum()) * 6 * 8)
    valid = int(ws.rec_valid.sum()) if n_rec else 0
    d_in = n_rec * 4 + valid * 6 * 8
    d_out = (valid * 6 * 8 + 8) if n_rec else 0
    e_io = 0
    if p.split:
        s2 = 2 * p.s_flows
        # the endpoint lanes' rows read and written; of the stream block,
        # the entries the static layout gives a row (control sends and RTO
        # arms [K] each, a server row's client bursts [K*B]), every valid
        # one of which lies there; the lane and counter words
        e_read = s2 * 2 * k + p.s_flows * k * lanes.PUMP_BURST
        e_io = (entries(cnt["e_in"], s2 * c, words)
                + entries(cnt["e_out"], s2 * c, words)
                + entries(cnt["sx"], e_read, 7) + 2 * s2 * 4 + s2 * 4)
        if p.log_capacity:
            e_io += (rg.slots - rg.split) * 4 + split_rows * 6 * 8
    if p.flowtrace:
        # every flow slot's flag written, the 32-byte records of the valid
        # ones: B's sheds, E's, A's groups; D reads the flags and the valid
        # records and writes each as a 40-byte ring row
        fg = p.flow_offsets
        fv = ws.fl_valid.bool()

        def flows(lo: int, hi: int) -> int:
            return (hi - lo) * 4 + int(fv[lo:hi].sum()) * 32

        b_out += flows(0, fg.split)
        e_io += flows(fg.split, fg.slots)
        a_out += flows(fg.slots, fg.end)
        n_flow = int(fv.sum())
        d_in += fg.end * 4 + n_flow * 32 + 4 * 4  # count, lost, window
        d_out += n_flow * ftr.FT_COLS * 4 + 8
    c_io = n * 8 + 4 * 4 + 6 * 4 + 4
    if p.stream_tiered:
        c_io += 2 * p.s_flows * 8  # the tier rows' heads
    if p.netobs:
        c_io += 2 * 2 * 4  # nb_win and one histogram word
    return {
        "lane_slots": a_in + a_out, "exchange_merge": b_in + b_out,
        "stream_rows_merge": e_io, "stream_tier": f_io, "tier_merge": g_io,
        "queue_min_window": c_io, "append_log": d_in + d_out,
        "valid_records": valid,
    }


# device kernels of each wrapper, by the names CUPTI gives them with the
# namespace, template arguments and parameters taken off (kernel_name)
KERNEL_PARTS = {
    "lane_slots": ("lane_slots_kernel",),
    "tier_merge": ("tier_merge_kernel",),
    "stream_tier": ("tier_fill_kernel", "stream_tier_kernel"),
    "exchange_merge": ("x_count_kernel", "x_place_kernel", "merge_kernel",
                       "merge_warp_kernel"),
    "stream_rows_merge": ("stream_rows_kernel",),
    "queue_min_window": ("queue_min_kernel",),
    "append_log": ("append_log_kernel",),
}


WRAPPER_OF = {part: name for name, parts in KERNEL_PARTS.items()
              for part in parts}
assert len(WRAPPER_OF) == sum(map(len, KERNEL_PARTS.values()))


def kernel_name(key: str) -> str:
    """The bare name of a profiler event: "merge_kernel" for "void
    (anonymous namespace)::merge_kernel<7, ParamBufs>(ParamBufs)", "Memset" for
    "Memset (Device)", the key itself for a runtime call."""
    m = re.search(r"(\w+)(?:<[^()]*>)?\(", key)
    return m.group(1) if m else key.split(" ")[0]


def path_kernels(p: lanes.LaneParams) -> list:
    """The wrappers a run with these parameters launches every step."""
    out = ["lane_slots", "exchange_merge", "queue_min_window"]
    if p.split:
        out.append("stream_rows_merge")
    if p.stream_tiered:
        out += ["stream_tier", "tier_merge"]
    if p.log_capacity or p.flowtrace:
        out.append("append_log")
    return out


# cell label -> wrapper -> its device kernels' us per step (profile_steps)
SPLITS: dict = {}


def profile_steps(window, iteration, steps: int, p: lanes.LaneParams,
                  label: str = "") -> dict:
    """Device time per step of each wrapper's kernels, from the profiler's
    CUDA activity over ``steps`` live steps of the device loop (profiled
    again, up to three times, while a kernel's time is missing); {} when
    the profiler records no device time.  Each wrapper's split into its
    device kernels is kept in ``SPLITS[label]``."""
    from torch.profiler import ProfilerActivity, profile

    for _attempt in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(steps):
                window(True)
                iteration()
            torch.cuda.synchronize()
        totals = {name: 0.0 for name in path_kernels(p)}
        parts = {name: {} for name in totals}
        for ev in prof.key_averages():
            us = getattr(ev, "device_time_total", None)
            if us is None:
                us = getattr(ev, "cuda_time_total", 0.0)
            part = kernel_name(ev.key)
            name = WRAPPER_OF.get(part)
            if name in totals:
                totals[name] += us
                parts[name][part] = parts[name].get(part, 0.0) + us / steps
                log(f"  device {us / steps:9.3f} us/step in {ev.count:5d} "
                    f"launches: {ev.key[:70]}")
        if all(totals.values()):
            if label:  # the wrappers of more than one device kernel
                SPLITS[label] = {name: split for name, split in parts.items()
                                 if len(KERNEL_PARTS[name]) > 1}
            return {name: us / 1e3 / steps for name, us in totals.items()}
        log(f"profiler device times incomplete: {totals}")
    return {}


def loop_step_ms(window, iteration, ws_, chunks: int) -> float:
    """Time per step of the device loop as ``_build_full_run`` drives it
    (steps in chunks of ``CHECK_EVERY``, one read of the live flag after
    each), between CUDA events: device work and the gaps between it."""
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(chunks):
        for _ in range(lanes.CHECK_EVERY):
            window(True)
            iteration()
        if not int(ws_.ctl[0]):
            raise AssertionError("the timed steps ran past the run's end")
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / (chunks * lanes.CHECK_EVERY)


def time_kernels(label: str, cfg, log_cap: int, warm: int) -> dict:
    """Per-kernel times on a mid-run state of ``cfg`` at the main path's
    log capacity ``log_cap``: the profiler's device time per step over 40
    live steps of the loop, and CUDA events around single launches on a
    restored snapshot, beside the plain version's time and the bound.
    The device's busy share is the profiled kernel time per step over the
    loop's time per step, taken on the 64 live steps just before."""
    eng = GpuEngine(cfg, log_capacity=log_cap)
    p, tb = eng.params, eng.tables
    s = eng.initial_state()
    ws_, window, iteration = lanes._build_iteration(p, tb, s)
    for _ in range(warm):  # into the steady state
        window(True)
        iteration()
    step_ms = loop_step_ms(window, iteration, ws_, 2)
    prof_ms = profile_steps(window, iteration, 40, p, label)
    window(True)  # the next window, as the loop would open it
    torch.cuda.synchronize()
    snap_s, snap_ws = clone(s), clone(ws_)
    args = kernels.LaneArgs(p, tb, s, ws_)

    def restore(snap=(snap_s, snap_ws)):
        copy_into(s, snap[0])
        copy_into(ws_, snap[1])

    # inputs of B, E, F, G and D are A's outputs (and B's): stage them once,
    # counting the valid entries each kernel moves (kernel_bytes)
    never = lanes.NEVER32
    k = p.pops_per_iter
    cnt = {"head": int((s.q_thi[:, :k] != never).sum())}
    kernels.lane_slots(args)
    cnt["popped"] = int(((snap_s.q_thi[:, :k] != never)
                         & (s.q_thi[:, :k] == never)).sum())
    cnt["self"] = int((ws_.self_blk[0] != never).sum())
    cnt["out"] = int((ws_.out_blk[1] != never).sum())
    cnt["sx"] = (int((ws_.sx_blk[1] != never).sum())
                 if p.lane.stream_present else 0)
    cnt["b_in"] = int((s.q_thi != never).sum())
    kernels.exchange_merge(args)
    cnt["b_out"] = int((s.q_thi != never).sum())
    if p.split:
        el = tb.flow_lanes.long()
        cnt["e_in"] = int((s.q_thi[el] != never).sum())
        kernels.stream_rows_merge(args)
        cnt["e_out"] = int((s.q_thi[el] != never).sum())
    if p.stream_tiered:
        cx0 = p.tier_layout[3]
        cnt["cross"] = int((ws_.tier_blk[0, cx0:] != never).sum())
        before = s.stream.q[0, :, :p.stream_pops].clone()
        kernels.stream_tier(args)
        cnt["tier_popped"] = int((before != s.stream.q[0, :, :p.stream_pops])
                                 .sum())
        cnt["cand"] = int((ws_.tier_blk[0, :cx0] != never).sum())
        cnt["merged"] = (int((s.stream.q[0] != never).sum())
                         + cnt["cand"] + cnt["cross"])
        kernels.tier_merge(args)
        cnt["kept"] = int((s.stream.q[0] != never).sum())
    log(f"{label}: valid entries in the timed iteration: {cnt}")
    torch.cuda.synchronize()
    snap_mid = (clone(s), clone(ws_))
    nbytes = kernel_bytes(p, tb, ws_, cnt)

    reps = 50
    plan = {
        "lane_slots": (restore, lambda: kernels.lane_slots(args),
                       lambda: lanes.lane_slots_plain(p, tb, s, ws_)),
        "exchange_merge": (
            lambda: (restore(), kernels.lane_slots(args)),
            lambda: kernels.exchange_merge(args),
            lambda: lanes.exchange_merge_plain(p, tb, s, ws_)),
        "queue_min_window": (
            restore, lambda: kernels.queue_min_window(args, True),
            lambda: lanes.queue_min_window_plain(p, s, ws_, True)),
    }
    if p.split:
        plan["stream_rows_merge"] = (
            lambda: (restore(), kernels.lane_slots(args),
                     kernels.exchange_merge(args)),
            lambda: kernels.stream_rows_merge(args),
            lambda: lanes.stream_rows_merge_plain(p, tb, s, ws_))
    if p.stream_tiered:
        plan["stream_tier"] = (
            lambda: (restore(), kernels.lane_slots(args),
                     kernels.exchange_merge(args)),
            lambda: kernels.stream_tier(args),
            lambda: lanes.stream_tier_plain(p, tb, s, ws_))
        plan["tier_merge"] = (
            lambda: (restore(), kernels.lane_slots(args),
                     kernels.exchange_merge(args), kernels.stream_tier(args)),
            lambda: kernels.tier_merge(args),
            lambda: lanes.tier_merge_plain(p, tb, s, ws_))
    if log_cap or p.flowtrace:
        plan["append_log"] = (lambda: restore(snap_mid),
                              lambda: kernels.append_log(args),
                              lambda: lanes.append_log_plain(p, s, ws_))
    # one PyTorch call each for C's reduction and D's compaction, on the
    # same inputs (their device time from the profiler)
    restore(snap_mid)
    library = {"queue_min_window": library_ms(head_amin(snap_s))}
    if log_cap or p.flowtrace:
        library["append_log"] = library_ms(selections(p, ws_))
    times = {}
    for name, (rst, kern, plain) in plan.items():
        _event_ms(kern, rst, 5)  # warm up
        kernel_ms, plain_ms = [], []
        for order in ("plain", "kernel", "kernel", "plain"):
            if order == "kernel":
                kernel_ms.append(_event_ms(kern, rst, reps))
            else:
                plain_ms.append(_event_ms(plain, rst, 5))
        bound = nbytes[name] / HBM_BYTES_PER_S * 1e3
        event_ms = float(np.mean(kernel_ms))
        times[name] = {
            # the profiler's device time on the running loop where it has
            # one; else the per-launch CUDA-event time
            "ms": prof_ms.get(name, event_ms), "event_ms": event_ms,
            "plain_ms": float(np.mean(plain_ms)), "bound_ms": bound,
            "bound_by": "bytes", "bytes": nbytes[name],
            "library_ms": library.get(name, (None, None))[0],
            "library_by": library.get(name, (None, None))[1],
        }
        lib, lib_by = library.get(name, (None, None))
        log(f"{label} {name}: device {prof_ms.get(name, float('nan')):.5f} "
            f"ms/launch (profiler, 40 live steps), {event_ms:.5f} ms (events "
            f"around one launch, mean of {2 * reps}), plain "
            f"{times[name]['plain_ms']:.4f} ms, bound {bound:.6f} ms "
            f"({nbytes[name]} B / 3.35 TB/s)"
            + (f", library {lib:.5f} ms ({lib_by})" if lib else ""))
    busy = sum(prof_ms.values()) / step_ms if prof_ms else float("nan")
    times["loop"] = {"step_ms": step_ms, "busy": busy}
    log(f"{label}: loop {step_ms * 1e3:.3f} us/step (64 live steps), "
        f"profiled kernels {sum(prof_ms.values()) * 1e3:.3f} us/step, device "
        f"busy {busy:.4f}; valid records in the timed iteration: "
        f"{nbytes['valid_records']}; nvidia-smi: {smi_line()}")
    return times


@phase("per-kernel times at the full-width main paths' settings")
def time_all() -> dict:
    # each at its main path's log capacity (2 sim s, so the warm-up, the
    # loop timing and the profile stay inside live steps); the flagship
    # twice: without a log as its 10 s path runs, and with one for D
    out = {
        "flagship": time_kernels("flagship", flagship(sim_seconds=2), 0, 20),
        "flagship_log": time_kernels("flagship, logging",
                                     flagship(sim_seconds=2), 2_000_000, 20),
        "phold": time_kernels("phold", phold(stop_time="1s"), 0, 200),
        "lossy": time_kernels("lossy", flagship(sim_seconds=2,
                                                packet_loss=0.01), 0, 20),
        # the untiered mixed mesh (kernel E): 40 steps in, the flows are in
        # slow start
        "mixed": time_kernels("mixed mesh, untiered", mixed_mesh(2), 0, 40),
        # ... with flowtrace on, every flow traced (this slice's main path's
        # shapes), on the same states
        "mixed_flowtrace": time_kernels(
            "mixed mesh, untiered, flowtrace",
            with_flowtrace(mixed_mesh(2), cap=FLOW_RING), 0, 40),
        # the tiered mixed mesh (kernels F and G): 20 steps in (the tier
        # pops up to 16 events a row per step), the flows are in slow start
        "mixed_tiered": time_kernels("mixed mesh, tiered", mixed_tiered(2), 0,
                                     20),
        # ... with the planes: netobs alone, then a log without and with
        # netobs and pcap (pcap rides the log), on the same states
        "mixed_tiered_netobs": time_kernels(
            "mixed mesh, tiered, netobs", netobs_only(mixed_tiered(2)), 0, 20),
        "mixed_tiered_log": time_kernels(
            "mixed mesh, tiered, logging", mixed_tiered(2), 2_000_000, 20),
        "mixed_tiered_pcap": time_kernels(
            "mixed mesh, tiered, netobs + pcap, logging",
            planes(mixed_tiered(2), "timing"), 2_000_000, 20),
    }
    # rand_u32 alone: one draw per lane and slot of a PHOLD iteration
    m = N_FLAG * K_PHOLD
    idx = torch.arange(m, dtype=torch.int64, device=DEV)
    stream = rng_mod.as_i32((idx % N_FLAG) | rng_mod.APP_STREAM)
    counter = rng_mod.as_i32(idx // N_FLAG)
    kernels.reset_launches()

    def nothing():
        return None

    def launch():
        kernels.rand_u32(1, stream, counter)

    _event_ms(launch, nothing, 5)  # warm up
    kernel_ms, plain_ms = [], []
    for order in ("plain", "kernel", "kernel", "plain"):
        if order == "kernel":
            kernel_ms.append(_event_ms(launch, nothing, 50))
        else:
            plain_ms.append(_event_ms(
                lambda: lanes.rand_u32_lane(1, stream, counter), nothing, 5))
    # the events above also time the wrapper's host work between them; the
    # profiler reads the kernel's own device time
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(50):
            launch()
        torch.cuda.synchronize()
    launches = kernels.rand_u32.launches
    dev_us = [getattr(ev, "device_time_total", None)
              or getattr(ev, "cuda_time_total", 0.0)
              for ev in prof.key_averages()
              if kernel_name(ev.key) == "rand_u32_kernel"]
    event_ms = float(np.mean(kernel_ms))
    kernel_dev_ms = sum(dev_us) / 1e3 / 50 if sum(dev_us) else event_ms
    ops_ms = m * THREEFRY_OPS / INT32_OPS_PER_S * 1e3
    bytes_ms = m * 3 * 4 / HBM_BYTES_PER_S * 1e3  # two words in, one out
    out["rand_u32"] = {
        "ms": kernel_dev_ms, "event_ms": event_ms,
        "plain_ms": float(np.mean(plain_ms)),
        "bound_ms": max(ops_ms, bytes_ms),
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "ops_ms": ops_ms, "bytes_ms": bytes_ms, "draws": m,
        "launches": launches,
    }
    log(f"rand_u32: device {kernel_dev_ms:.5f} ms/launch for {m} draws "
        f"(profiler, 50 launches), {event_ms:.5f} ms (events around one "
        f"launch, mean of 100), plain {out['rand_u32']['plain_ms']:.4f}"
        f" ms; bound: operations {ops_ms:.6f} ms ({m} x {THREEFRY_OPS} int32 "
        f"ops / {INT32_OPS_PER_S:.4g} per s), bytes {bytes_ms:.6f} ms "
        f"({m * 12} B / 3.35 TB/s); {launches} launches; nvidia-smi: "
        f"{smi_line()}")
    return out


# ---- the hybrid backend: managed binaries on the host CPU, packets here -----

ROOT = Path(__file__).resolve().parent
# managed_relay_chains_large: 25 three-relay chains, 75 tcpecho clients and
# the origin (151 managed processes) beside 1,000 tgen-mesh peers, 10 sim s
HYB_CHAINS, HYB_SIM_S = 25, 10
# the card = CPU cut (fewer sim seconds first): the full width, 2 sim s —
# the relays carry the first clients' traffic, and every client is still
# running at the cut (equal process errors on every run)
HYB_CUT_S = 2
# the device log: the flagship's 10 sim s make about 230,000 records
HYB_LOG = 1_000_000


# The Makefile's flags, with two defaults of newer distribution compilers
# turned off that the shim was not written for: _FORTIFY_SOURCE, whose
# __*_chk wrappers call into libc directly and so bypass the shim's
# interposed read/recv/poll (the managed apps then talk past the
# simulation), and a false-positive -Warray-bounds on the shim's
# close_range loop (an index the loop keeps at or above 0), which -Werror
# makes fatal; every other warning still fails the build.
NATIVE_CFLAGS = ("-O2 -g -Wall -Wextra -Werror -Wno-error=array-bounds "
                 "-U_FORTIFY_SOURCE -D_FORTIFY_SOURCE=0")


@phase("native build: make -C native (the LD_PRELOAD shim, tcpecho, relay, "
       "pingpong)")
def native_build():
    # the shim and the apps the hybrid flagship runs
    proc = subprocess.run(
        ["make", "-C", str(ROOT / "native"), f"CFLAGS={NATIVE_CFLAGS}",
         "build/libshadow_shim.so", "build/tcpecho", "build/relay",
         "build/pingpong"],
        capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"make -C native failed:\n{proc.stderr[-3000:]}")
    for name in ("libshadow_shim.so", "tcpecho", "relay", "pingpong"):
        if not (ROOT / "native" / "build" / name).exists():
            raise RuntimeError(f"native/build/{name} missing after make")
    log(f"native build: {proc.stdout.strip()[-600:]}")


def hybrid_cfg(tag: str, sim_seconds: float = HYB_SIM_S,
               chains: int = HYB_CHAINS) -> ConfigOptions:
    cfg = scenarios.managed_relay_chains_large(
        Path(DATA) / tag, chains=chains, sim_seconds=int(np.ceil(sim_seconds)))
    cfg.general.stop_time = int(sim_seconds * 1e9)
    return cfg


def external_mask(cfg) -> np.ndarray:
    """The hosts that run managed processes (the hybrid engine's rule)."""
    models = builtin_models()
    return np.array([any(p.path not in models for p in h.processes)
                     for h in cfg.hosts])


def hybrid_block(p, rng, rows: int, dst, t0: int) -> torch.Tensor:
    """An injection block on the card: ``rows`` valid PACKET arrivals to
    lanes drawn from ``dst`` at times from ``t0``, the rest invalid."""
    b = p.inject_batch
    valid = np.zeros(b, bool)
    valid[rng.permutation(b)[:rows]] = True
    d = rng.choice(dst, size=b)
    t = t0 + rng.integers(0, 20_000_000, b)
    src = rng.integers(0, p.n_lanes, b)
    blk = np.stack([
        valid, d, np.where(valid, t >> 31, lanes.NEVER32),
        np.where(valid, t & lanes.MASK31, lanes.NEVER32),
        (lanes.PACKET << lanes.AUX_KIND_SHIFT) | (src << lanes.AUX_SRC_SHIFT),
        (1 << 22) + np.arange(b), rng.integers(60, 1500, b)])
    return torch.as_tensor(blk.astype(np.int32), device=DEV)


@phase("hybrid kernels vs plain at the hybrid flagship's shapes: H, A's "
       "external arm with D's egress instance, C's hybrid mode (tolerance: "
       "exact, integer)")
def check_hybrid_kernels():
    rng = np.random.default_rng(SEED + 8)
    cfg = hybrid_cfg("kernels")
    ext = external_mask(cfg)
    ext_lanes = np.nonzero(ext)[0]
    for variant in ("flagship", "active"):
        eng = GpuEngine(cfg, log_capacity=60_000, external=ext)
        p, tb = eng.params, eng.tables
        n = p.n_lanes
        if variant == "active":
            # phold lanes beside the external ones: A's insert channel, which
            # an external lane must not take
            model = np.where(ext, lanes.M_NONE, rng.choice(
                [lanes.M_TGEN_MESH, lanes.M_PHOLD], n))
            p = dataclasses.replace(p, models_present=tuple(sorted(
                {lanes.M_NONE, lanes.M_TGEN_MESH, lanes.M_PHOLD})))
            tb = tb._replace(model=t32(model))
        for rep_ in range(2):
            tag = f"{variant} rep={rep_}"
            s0 = random_state(eng, tb, rng)
            ws0 = lanes.make_workspace(p, DEV)
            ws0.ctl[0] = 1
            kern, plain = run_pair(
                p, tb, s0, ws0, kernels.lane_slots,
                lambda p_, tb_, s, ws: lanes.lane_slots_plain(p_, tb_, s, ws))
            check("lane_slots:external", tag, kern, plain)
            eg = plain["eg_valid"].bool()
            n_eg = int(eg.sum())
            drops = int((plain["eg_recs"][eg, 5] == 2).sum())
            if n_eg == 0 or drops == 0:
                raise AssertionError(f"{tag}: no egress rows ({n_eg}) or no "
                                     f"CoDel drop among them ({drops})")
            # D's egress instance over A's candidates, into an empty buffer
            # and into one 100 rows from its end (rows lost past E)
            ws1 = clone(ws0)
            ws1.eg_recs.copy_(plain["eg_recs"])
            ws1.eg_valid.copy_(plain["eg_valid"])
            for start in (0, p.egress_capacity - 100):
                s1 = clone(s0)
                s1.egress_count.fill_(start)
                m = T0 + int(rng.integers(0, 30_000_000))
                s1.egress_min_hi.fill_(m >> 31)
                s1.egress_min_lo.fill_(m & lanes.MASK31)
                kern, plain_d = run_pair(
                    p, tb, s1, ws1, kernels.append_log,
                    lambda p_, tb_, s, ws: lanes.append_log_plain(p_, s, ws))
                check("append_log:egress", f"{tag} start={start}", kern,
                      plain_d)
                log(f"append_log:egress {tag} start={start}: equal; "
                    f"{n_eg} rows ({drops} CoDel drops), lost "
                    f"{int(plain_d['egress_lost'])}")
            # H: blocks spread over the external lanes, and one block all to
            # one lane (past Cxi = C: the sheds)
            for case, rows, dst in (("spread", 200, ext_lanes),
                                    ("one lane", 400, ext_lanes[:1])):
                blk = hybrid_block(p, rng, rows, dst, T0)
                kern, plain_h = run_pair(
                    p, tb, s0, ws0, lambda a, b_=blk: kernels.inject_merge(a, b_),
                    lambda p_, tb_, s, ws, b_=blk:
                        lanes.inject_merge_plain(p_, tb_, s, b_))
                check("inject_merge", f"{tag} {case}", kern, plain_h)
                log(f"inject_merge {tag} {case}: equal; n_queue "
                    f"{int(plain_h['n_queue'].sum())}")
            # C's hybrid mode: the turn's first step and a later one, the
            # host's next event before the window's end, inside the next one,
            # past it and absent, the egress buffer empty and at its floor,
            # static and dynamic runahead
            we = T0 + 10_000_000
            stops = 0
            for dyn in (False, True):
                p2 = dataclasses.replace(p, dynamic_runahead=dyn)
                for first in (True, False):
                    for ext_t in (we - 5_000_000, we + 500_000,
                                  we + 80_000_000, lanes.NEVER):
                        for eg_count in (0, p.egress_capacity - p.ext_per_iter):
                            s1 = clone(s0)
                            s1.egress_count.fill_(eg_count)
                            s1.min_used_lat.fill_(int(rng.choice(
                                [lanes.NEVER32, 700_000])))
                            eh, el = ((lanes.NEVER32, lanes.NEVER32)
                                      if ext_t >= lanes.NEVER
                                      else (ext_t >> 31, ext_t & lanes.MASK31))
                            turn = lanes.HybridTurn(eh, el, 900_000, first)
                            kern, plain_c = run_pair(
                                p2, tb, s1, ws0,
                                lambda a, t_=turn: kernels.hybrid_window(a, t_),
                                lambda p_, tb_, s, ws, t_=turn:
                                    lanes.hybrid_window_plain(p_, s, ws, t_))
                            check("hybrid_window",
                                  f"{tag} dyn={dyn} first={first} "
                                  f"ext={ext_t} eg={eg_count}", kern, plain_c)
                            stops += int(plain_c["ctl"][0]) == 0
            log(f"hybrid_window {tag}: equal in 32 cases, {stops} stopped")
            if stops == 0 or stops == 32:
                raise AssertionError("hybrid_window: the cases missed a stop "
                                     "or a step")


# the fused law at the defaults: k = 8 windows a dispatch at most, over a
# schedule of max(2k, 9) = 16 peeked host event times
FUSE_K = 8
FUSE_SLOTS = max(2 * FUSE_K, 9)


def fused_schedule(times, horizon=lanes.NEVER) -> list:
    head = sorted(set(int(t) for t in times))[:FUSE_SLOTS - 1]
    return head + [horizon] * (FUSE_SLOTS - len(head))


def egress_rows(p, rng, count: int, t0: int) -> torch.Tensor:
    """``count`` egress rows (DELIVERED and CoDel drops) at times around
    ``t0``, in an [E, 6] buffer."""
    e = np.zeros((p.egress_capacity, 6), dtype=np.int64)
    e[:count, 0] = t0 + rng.integers(-6_000_000, 30_000_000, count)
    e[:count, 1] = rng.integers(0, p.n_lanes, count)
    e[:count, 2] = rng.integers(0, p.n_lanes, count)
    e[:count, 3] = rng.integers(0, 1 << 20, count)
    e[:count, 4] = rng.integers(60, 1500, count)
    e[:count, 5] = rng.choice([0, 0, 0, 2], count)
    return torch.as_tensor(e, device=DEV)


@phase("C's fused mode vs plain at the hybrid flagship's shapes: single steps "
       "(window law, consume and refold, k_eff, horizon and egress-room "
       "stops, first and later steps) and whole dispatches card = CPU "
       "(tolerance: exact, integer)")
def check_fused_kernels():
    rng = np.random.default_rng(SEED + 10)
    cfg = hybrid_cfg("fused-kernels")
    ext = external_mask(cfg)
    eng = GpuEngine(cfg, log_capacity=60_000, external=ext)
    tb = eng.tables
    counts = {"step": 0, "consume": 0, "stop": 0, "refold": 0}
    for dyn in (False, True):
        p = dataclasses.replace(eng.params, dynamic_runahead=dyn,
                                hybrid_k_cap=FUSE_K, ext_slots=FUSE_SLOTS)
        s0 = random_state(eng, tb, rng)
        # the lane heads from T0: a window ending before them leaves the
        # host's events to decide (we_lo), one past them iterates (we_hi)
        we_lo, we_hi = T0 - 1_000_000, T0 + 10_000_000
        s0.egress.copy_(egress_rows(p, rng, 900, T0))
        for first in (True, False):
            for k_eff in (1, 2, FUSE_K):
                for case in ("step", "consume", "horizon", "room"):
                    we = we_hi if case == "step" else we_lo
                    s1 = clone(s0)
                    s1.now_we_hi.fill_(we >> 31)
                    s1.now_we_lo.fill_(we & lanes.MASK31)
                    s1.egress_count.fill_(
                        p.egress_capacity - p.ext_per_iter if case == "room"
                        else 900)
                    s1.min_used_lat.fill_(int(rng.choice(
                        [lanes.NEVER32, 700_000])))
                    s1.egress_min_hi.fill_(lanes.NEVER32)
                    s1.egress_min_lo.fill_(lanes.NEVER32)
                    ws0 = lanes.make_workspace(p, DEV)
                    ws0.ctl[0] = 1
                    if case == "horizon":  # the host's first time IS it
                        sched = fused_schedule([], horizon=we - 500_000)
                    else:  # the host takes part in the current window
                        sched = fused_schedule(
                            [we - 500_000]
                            + list(we + rng.integers(0, 20_000_000, 12)))
                    ws0.ext.copy_(torch.tensor(sched, dtype=torch.int64))
                    kd = int(rng.integers(0, k_eff))
                    ws0.fz.copy_(torch.tensor([0, kd, 3], dtype=torch.int32))
                    turn = lanes.FusedTurn(900_000, k_eff, first)
                    kern, plain = run_pair(
                        p, tb, s1, ws0,
                        lambda a, t_=turn: kernels.hybrid_fused_window(a, t_),
                        lambda p_, tb_, s, ws, t_=turn:
                            lanes.hybrid_fused_window_plain(p_, s, ws, t_))
                    check("hybrid_fused_window",
                          f"dyn={dyn} first={first} k_eff={k_eff} {case}",
                          kern, plain)
                    live = int(plain["ctl"][0])
                    k_done = int(plain["fz"][1]) - (0 if first else kd)
                    counts["step"] += live
                    counts["stop"] += 1 - live
                    counts["consume"] += k_done > 0
                    counts["refold"] += k_done > 0 and int(
                        plain["egress_min_hi"]) != lanes.NEVER32
    log(f"hybrid_fused_window: equal in 48 single steps: {counts}")
    if min(counts.values()) == 0:
        raise AssertionError(f"hybrid_fused_window: the cases missed a path "
                             f"({counts})")
    # whole dispatches on the card (H, A, B, D and C's fused mode) against
    # the plain versions on a CPU copy, from one seeded state: the CPU
    # tests' schedules (consumed windows at k_eff 1, 2 and 8, the horizon
    # inside the span, the egressed deliveries alone, the egress room)
    p = eng.params
    s0 = random_state(eng, tb, rng)
    we = T0 + 10_000_000
    blk = hybrid_block(p, rng, 200, np.nonzero(ext)[0], we)
    cases = {
        "consume": fused_schedule(we + np.arange(-1, 12) * 1_300_000),
        "horizon": fused_schedule([we - 300_000, we + 700_000],
                                  horizon=we + 2_500_000),
        "egress": fused_schedule([]),
    }
    tb_cpu = lanes.LaneTables(*[t.cpu() for t in tb])
    for case, k_eff in (("consume", 1), ("consume", 2), ("consume", FUSE_K),
                        ("horizon", FUSE_K), ("egress", FUSE_K),
                        ("room", FUSE_K)):
        pc = p if case != "room" else dataclasses.replace(
            p, egress_capacity=p.ext_per_iter + 40)
        s_card = clone(s0)
        if case == "room":
            s_card = s_card._replace(egress=torch.zeros(
                (pc.egress_capacity, 6), dtype=torch.int64, device=DEV))
        s_cpu = lanes.LaneState(*[t.to("cpu", copy=True) for t in s_card])
        sched = cases["consume" if case == "room" else case]
        outs = []
        for s_, tb_, inj in ((s_card, tb, blk[None]),
                             (s_cpu, tb_cpu, blk[None].cpu())):
            run = lanes.FusedRun(pc, tb_, s_, FUSE_K, FUSE_SLOTS)
            outs.append((run(sched, 900_000, inj, k_eff),
                         run(sched, lanes.NEVER32, None, k_eff)))
        if outs[0] != outs[1]:
            raise AssertionError(f"fused dispatch {case} k_eff={k_eff}: "
                                 f"readbacks {outs[0]} != {outs[1]}")
        check("hybrid_fused_window", f"dispatch {case} k_eff={k_eff}",
              fields(s_card), {f: t.to(DEV) for f, t in fields(s_cpu).items()})
        log(f"fused dispatch {case} k_eff={k_eff}: card = CPU; readbacks "
            f"{[o[:lanes.HYB_WE_BASE] for o in outs[0]]}")


def sync_counts(eng) -> dict:
    return {k: v for k, v in eng.sync_stats.items() if not k.endswith("_s")}


def hybrid_engine(tag: str, sim_s: float, dev: str, workers: int,
                  fuse_k: int) -> HybridEngine:
    """The hybrid flagship at full width for ``sim_s`` sim s, on the engine
    the reference's facade picks (``make_hybrid_engine``)."""
    cfg = hybrid_cfg(tag, sim_s)
    cfg.experimental.hybrid_workers = workers
    cfg.experimental.hybrid_fuse_k = fuse_k
    return make_hybrid_engine(cfg, device=dev, log_capacity=HYB_LOG)


def mod_iters(r) -> dict:
    # lane_iters counts device iterations: a fused dispatch runs no-op
    # iterations in windows the one-window law never visits
    return {k: v for k, v in r.counters.items() if k != "lane_iters"}


# name, device, worker processes, k
HYB_PARITY_RUNS = (("card", "cuda", 2, FUSE_K), ("cpu", "cpu", 2, FUSE_K),
                   ("card one-window", "cuda", 1, 1))


def hybrid_oracle_run():
    return CpuEngine(hybrid_cfg("oracle", HYB_CUT_S)).run()


def hybrid_parity_run(name: str, dev: str, workers: int, fuse_k: int):
    """One of the parity's engine runs: the result, the engine's name, its
    workers and its transfer counts (``sync_counts``), and the engine when
    it ran here."""
    eng = hybrid_engine(f"parity-{name.replace(' ', '-')}", HYB_CUT_S,
                        dev, workers, fuse_k)
    res = eng.run()
    about = (type(eng).__name__, getattr(eng, "workers", 1), sync_counts(eng))
    return res, about, eng if dev == "cuda" else None


@phase("hybrid parity: the hybrid flagship at full width for 2 sim s at the "
       "defaults (the fused law, k = 8, eager dispatch, 2 worker "
       "processes) on the card = device='cpu' = the port's CPU oracle = the "
       "one-window law on the card")
def hybrid_parity():
    runs = {}
    runs["cpu oracle"], secs = cpu_ref(hybrid_oracle_run)
    log(f"hybrid parity: CPU oracle {secs:.1f} s")
    engs, counts = {}, {}
    for name, dev, workers, fuse_k in HYB_PARITY_RUNS:
        if dev == "cpu":
            (runs[name], about, engs[name]), secs = cpu_ref(
                hybrid_parity_run, name, dev, workers, fuse_k)
        else:
            t0 = time.perf_counter()
            runs[name], about, engs[name] = hybrid_parity_run(
                name, dev, workers, fuse_k)
            secs = time.perf_counter() - t0
        counts[name] = about[2]
        log(f"hybrid parity: {name} ({about[0]}, {about[1]} workers, k = "
            f"{fuse_k}) {secs:.1f} s, {about[2]}")
    want = runs["cpu oracle"]
    for name, r in runs.items():
        # the workers report their partitions' errors in worker order
        if sorted(r.process_errors) != sorted(want.process_errors):
            raise AssertionError(f"{name}: process errors {r.process_errors} "
                                 f"!= the oracle's {want.process_errors}")
    logs = [r.log_tuples() for r in runs.values()]
    if any(lg != logs[0] for lg in logs[1:]):
        raise AssertionError("hybrid parity: the event logs differ")
    if runs["card"].counters != runs["cpu"].counters:
        raise AssertionError(f"hybrid parity: counters {runs['card'].counters}"
                             f" != {runs['cpu'].counters}")
    if mod_iters(runs["card"]) != mod_iters(runs["card one-window"]):
        raise AssertionError("hybrid parity: the fused law's counters differ "
                             "from the one-window law's")
    # the oracle counts per app (tgen_sent_bytes too), the lanes per lane:
    # the managed hosts' counters and the mesh's received bytes compare
    for k, v in want.counters.items():
        if ((k.startswith(("managed_", "udp_")) or k == "tgen_recv_bytes")
                and runs["card"].counters.get(k) != v):
            raise AssertionError(f"hybrid parity: {k} {runs['card'].counters.get(k)}"
                                 f" != the oracle's {v}")
    if len({r.rounds for r in runs.values()}) != 1:
        raise AssertionError("hybrid parity: rounds differ")
    if counts["card"] != counts["cpu"]:
        raise AssertionError("hybrid parity: the transfer counts differ")
    st = engs["card"].sync_stats
    if st["fused_dispatches"] == 0:
        raise AssertionError("hybrid parity: no fused dispatch")
    # one device snapshot (the checkpoint a fused dispatch starts from)
    snap = engs["card"]._snaps[engs["card"]._ckpt]
    log(f"hybrid parity: a device snapshot holds {lanes.snapshot_bytes(snap)}"
        f" bytes in {len(snap)} fields (the [1151, 64] queues "
        f"{5 * lanes.snapshot_bytes({'q': snap['q_thi']})} of them)")
    log(f"hybrid parity (cut: full width, {HYB_CUT_S} of {HYB_SIM_S} sim s): "
        f"equal logs ({len(logs[0])} records), counters, rounds "
        f"({want.rounds}) and transfer counts; device turns "
        f"{st['device_turns']} fused against "
        f"{engs['card one-window'].sync_stats['device_turns']} one-window; "
        f"clean exits {want.counters.get('managed_exit_clean')}, processes "
        f"still running at the cut {len(want.process_errors)}")
    return engs["card"]


def congested_yaml(d: Path, fuse_k: int) -> str:
    """tests/test_hybrid_fusion.py's congested config without the turn
    ledger: bulk tcpecho into a 10 Mbit node queues deliveries in the down
    buckets past the windows that made them, while a pingpong pair's
    cadence stages sends inside fused spans (rollbacks)."""
    build = ROOT / "native" / "build"
    bulk = "".join(f"""
  bcli{i}:
    network_node_id: 0
    processes:
      - path: {build / 'tcpecho'}
        args: [hclient, bsrv{i}, "{7000 + i}", "6", "8192", "0"]
        start_time: {100 + 40 * i}ms
  bsrv{i}:
    network_node_id: 1
    processes:
      - path: {build / 'tcpecho'}
        args: [server, "{7000 + i}", "1"]
""" for i in range(3))
    return f"""
general: {{stop_time: 2s, seed: 7, data_directory: {d}, heartbeat_interval: null}}
network:
  graph:
    type: gml
    inline: |
      graph [
        directed 0
        node [ id 0 host_bandwidth_up "1 Gbit" host_bandwidth_down "1 Gbit" ]
        node [ id 1 host_bandwidth_up "10 Mbit" host_bandwidth_down "10 Mbit" ]
        edge [ source 0 target 0 latency "100 us" ]
        edge [ source 1 target 1 latency "100 us" ]
        edge [ source 0 target 1 latency "300 us" ]
      ]
experimental: {{network_backend: tpu, hybrid_fuse_k: {fuse_k}}}
hosts:
  acli:
    network_node_id: 0
    processes:
      - path: {build / 'pingpong'}
        args: [client, 11.0.0.2, "9000", "4", "100"]
  asrv:
    network_node_id: 0
    processes:
      - path: {build / 'pingpong'}
        args: [server, "9000", "4"]
{bulk}
"""


@phase("hybrid rollbacks: the congested config, the fused law on the card = "
       "device='cpu' = the one-window law on the card, with rollbacks on "
       "the card")
def hybrid_congested():
    runs, engs = {}, {}
    for name, dev, fuse_k in (("card", "cuda", FUSE_K), ("cpu", "cpu", FUSE_K),
                              ("card one-window", "cuda", 1)):
        cfg = ConfigOptions.from_yaml(congested_yaml(
            Path(DATA) / f"congested-{name.replace(' ', '-')}", fuse_k))
        engs[name] = HybridEngine(cfg, device=dev)
        runs[name] = engs[name].run()
        if runs[name].process_errors:
            raise AssertionError(f"congested {name}: process errors "
                                 f"{runs[name].process_errors}")
    logs = [r.log_tuples() for r in runs.values()]
    if any(lg != logs[0] for lg in logs[1:]):
        raise AssertionError("congested: the event logs differ")
    if len({r.rounds for r in runs.values()}) != 1:
        raise AssertionError("congested: rounds differ")
    if (runs["card"].counters != runs["cpu"].counters
            or mod_iters(runs["card"]) != mod_iters(runs["card one-window"])):
        raise AssertionError("congested: counters differ")
    if sync_counts(engs["card"]) != sync_counts(engs["cpu"]):
        raise AssertionError("congested: the transfer counts differ")
    st = engs["card"].sync_stats
    if st["fuse_rollbacks"] < 1:
        raise AssertionError("congested: the card never rolled back")
    log(f"congested: equal logs ({len(logs[0])} records), rounds "
        f"{runs['card'].rounds}, counters and transfer counts; card "
        f"{sync_counts(engs['card'])}")


def hybrid_bytes(p, s, ws, blk, eg_count: int) -> dict:
    """Bytes the hybrid path's new work must move at these inputs: H reads
    the block and the rows of the lanes it lands on and writes those rows
    back (with their queue counters); C's hybrid mode reads the N head
    pairs and a few scalars, and writes the window and the readback; D's
    egress instance reads A's [K*N] flags and the valid rows and writes
    those rows (and the count and min)."""
    words = p.words
    touched = int(torch.unique(blk[1][blk[0] != 0]).numel())
    n_eg = int(ws.eg_valid.sum())
    return {
        "inject_merge": (lanes.INJ_WORDS * 4 * p.inject_batch
                         + 2 * touched * (p.capacity * words * 4 + 4)),
        "hybrid_window": p.n_lanes * 8 + 12 * 4 + 5 * 8,
        "append_log:egress": p.egress_slots * 4 + 2 * n_eg * 48 + 4 * 4,
        # C's fused mode on a consume: the heads, the schedule, each egress
        # row's time and outcome once (the refold), the scalars and the
        # readback
        "hybrid_fused_window": (p.n_lanes * 8 + FUSE_SLOTS * 8
                                + eg_count * 16 + 16 * 4
                                + (lanes.HYB_WE_BASE + FUSE_K + 1) * 8),
    }


# device kernels of the hybrid path's wrappers (kernel_name's bare names),
# each wrapper profiled alone
HYBRID_PARTS = {
    "inject_merge": ("inject_merge_kernel",),
    "lane_slots:external": ("lane_slots_kernel",),
    "hybrid_window": ("hybrid_window_kernel",),
    "hybrid_fused_window": ("hybrid_fused_kernel",),
    "append_log:egress": ("append_log_kernel",),
}


@phase("hybrid kernel times on the parity run's card state (the profiler's "
       "device time per launch; plain version; bound)")
def time_hybrid(eng) -> dict:
    """H, A (with its external arm), C's hybrid mode and D (with its egress
    instance) on the card state the parity run left at its cut (the
    flagship at full width after 2 sim s: the relays carry the first
    clients' traffic), its next window opened: each launched 20 times on a
    restored snapshot under the profiler (device time per launch), beside
    the plain version's time (CUDA events) and the bound.  D's time is the
    launch with all its instances (the log's and the egress).  C's fused
    mode is timed on a step that consumes the window and refolds the guard
    over the last dispatch's egress rows."""
    from torch.profiler import ProfilerActivity, profile

    dev = eng.device
    state = dev._live_state
    # the last dispatch's egress rows (below the room floor, so a fused
    # step may consume)
    eg_count = min(int(state.egress_count),
                   dev.params.egress_capacity - dev.params.ext_per_iter - 1)
    p = dataclasses.replace(dev.params, stop_time=HYB_SIM_S * 10**9)
    tb = dev.tables
    ws = lanes.make_workspace(p, DEV)
    args = kernels.LaneArgs(p, tb, state, ws)
    kernels.hybrid_window(args, lanes.HybridTurn(lanes.NEVER32, lanes.NEVER32,
                                                 lanes.NEVER32, True))
    torch.cuda.synchronize()
    if not int(ws.ctl[0]):
        raise AssertionError("time_hybrid: no window to time")
    rng = np.random.default_rng(SEED + 9)
    ext_lanes = np.nonzero(eng.external_mask)[0]
    we = int(lanes.t_join(state.now_we_hi, state.now_we_lo))
    blk = hybrid_block(p, rng, 64, ext_lanes, we - 1_000_000)
    snap = (clone(state), clone(ws))

    def restore(sn=snap):
        copy_into(state, sn[0])
        copy_into(ws, sn[1])

    k = p.pops_per_iter
    kernels.lane_slots(args)
    torch.cuda.synchronize()
    head = snap[0].q_thi[:, :k] != lanes.NEVER32
    cnt = {"head": int(head.sum()),
           "popped": int((head & (state.q_thi[:, :k] == lanes.NEVER32)).sum()),
           "self": int((ws.self_blk[0] != lanes.NEVER32).sum()),
           "out": int((ws.out_blk[1] != lanes.NEVER32).sum()), "sx": 0,
           "b_in": int((state.q_thi != lanes.NEVER32).sum())}
    mid = (clone(state), clone(ws))
    kernels.exchange_merge(args)
    cnt["b_out"] = int((state.q_thi != lanes.NEVER32).sum())
    nbytes = kernel_bytes(p, tb, ws, cnt)
    hbytes = hybrid_bytes(p, state, ws, blk, eg_count)
    # A's bytes with its external arm: every egress flag, the valid rows
    nbytes["lane_slots"] += p.egress_slots * 4 + int(ws.eg_valid.sum()) * 48
    log(f"hybrid timing state: window end {we} ns, valid entries {cnt}, "
        f"egress rows {int(mid[1].eg_valid.sum())}, valid records "
        f"{nbytes['valid_records']}")
    turn = lanes.HybridTurn(lanes.NEVER32, lanes.NEVER32, lanes.NEVER32, False)
    plan = {
        "inject_merge": (restore, lambda: kernels.inject_merge(args, blk),
                         lambda: lanes.inject_merge_plain(p, tb, state, blk),
                         hbytes["inject_merge"]),
        "lane_slots:external": (
            restore, lambda: kernels.lane_slots(args),
            lambda: lanes.lane_slots_plain(p, tb, state, ws),
            nbytes["lane_slots"]),
        "hybrid_window": (
            restore, lambda: kernels.hybrid_window(args, turn),
            lambda: lanes.hybrid_window_plain(p, state, ws, turn),
            hbytes["hybrid_window"]),
        "append_log:egress": (
            lambda: (copy_into(state, mid[0]), copy_into(ws, mid[1])),
            lambda: kernels.append_log(args),
            lambda: lanes.append_log_plain(p, state, ws),
            hbytes["append_log:egress"] + nbytes["append_log"]),
    }
    # C's fused mode on the cut's state, its egress rows those of the last
    # dispatch: a later step with the window ending at the lane heads and a
    # host event inside it, so the window is consumed, the guard refolded
    # over the rows and the next window opened (the costliest path)
    pf = dataclasses.replace(p, hybrid_k_cap=FUSE_K, ext_slots=FUSE_SLOTS)
    wsf = lanes.make_workspace(pf, DEV)
    argsf = kernels.LaneArgs(pf, tb, state, wsf)
    head = int(lanes.t_join(snap[1].ctl[2], snap[1].ctl[3]))
    wsf.ctl[0] = 1
    wsf.ext.copy_(torch.tensor(fused_schedule([head - 1]), dtype=torch.int64))
    wsf.fz.copy_(torch.tensor([0, 0, 1], dtype=torch.int32))
    snapf = clone(wsf)
    fturn = lanes.FusedTurn(lanes.NEVER32, FUSE_K, False)

    def restore_f():
        restore()
        copy_into(wsf, snapf)
        state.now_we_hi.fill_(head >> 31)
        state.now_we_lo.fill_(head & lanes.MASK31)
        state.egress_count.fill_(eg_count)

    restore_f()
    kernels.hybrid_fused_window(argsf, fturn)
    if int(wsf.fz[1]) != 1 or not int(wsf.ctl[0]):
        raise AssertionError("time_hybrid: the fused step did not consume "
                             f"and go on (fz {wsf.fz.tolist()})")
    plan["hybrid_fused_window"] = (
        restore_f, lambda: kernels.hybrid_fused_window(argsf, fturn),
        lambda: lanes.hybrid_fused_window_plain(pf, state, wsf, fturn),
        hbytes["hybrid_fused_window"])
    # one PyTorch call for C's reduction and D's compaction (made on the
    # restored inputs)
    library = {"hybrid_window": lambda: head_amin(state),
               "hybrid_fused_window": lambda: head_amin(state),
               "append_log:egress": lambda: selections(p, ws)}
    out = {}
    for name, (rst, kern, plain, nb) in plan.items():
        lib = lib_by = None
        if name in library:
            rst()
            lib, lib_by = library_ms(library[name]())
        _event_ms(kern, rst, 5)  # warm up
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                rst()
                kern()
            torch.cuda.synchronize()
        parts = {}  # the wrapper's device kernels, us a launch
        for ev in prof.key_averages():
            part = kernel_name(ev.key)
            if part in HYBRID_PARTS[name]:
                parts[part] = parts.get(part, 0.0) + (
                    getattr(ev, "device_time_total", None)
                    or getattr(ev, "cuda_time_total", 0.0)) / 20
        dev_us = sum(parts.values())
        SPLITS.setdefault("hybrid", {})[name] = parts
        event_ms = _event_ms(kern, rst, 50)
        plain_ms = float(np.mean([_event_ms(plain, rst, 5) for _ in range(2)]))
        out[name] = {"ms": dev_us / 1e3 if dev_us else event_ms,
                     "event_ms": event_ms, "plain_ms": plain_ms,
                     "bound_ms": nb / HBM_BYTES_PER_S * 1e3,
                     "bound_by": "bytes", "bytes": nb, "library_ms": lib,
                     "library_by": lib_by}
        log(f"hybrid {name}: device {out[name]['ms']:.5f} ms/launch "
            + ("(profiler, 20 launches)" if dev_us else
               "(the profiler recorded none: events)")
            + f", {event_ms:.5f} ms (events around one "
            f"launch, mean of 50), plain {plain_ms:.4f} ms, bound "
            f"{out[name]['bound_ms']:.6f} ms ({nb} B / 3.35 TB/s)"
            + (f", library {lib:.5f} ms ({lib_by})" if lib else "")
            + f"; nvidia-smi: {smi_line()}")
    restore()
    return out


# the flagship's rounds in 10 sim s (the port's CPU oracle's count)
HYB_ROUNDS = 4216


def compute_apps() -> list:
    """The processes holding a context on the card, as ``nvidia-smi``
    lists them: (pid, used memory)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid,used_memory",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return [tuple(x.strip() for x in line.split(","))
            for line in out.strip().splitlines() if line.strip()]


# the flagship's runs: the reference's defaults (the fused law, k = 8,
# eager dispatch, one worker process per core, at most one per managed
# host) and the one-window law on as many workers (the serial engine's
# one-window law runs in the hybrid parity and on the congested config)
HYB_LAWS = {"fused": (0, FUSE_K), "one-window": (0, 1)}


def hybrid_flagship(law: str) -> dict:
    """The flagship at full width for 10 sim s on one of ``HYB_LAWS``.
    Launch counts reset just before the run and read just after.  With
    worker processes, once they run managed processes, the card's compute
    apps are read: the workers must hold no context."""
    workers_cfg, fuse_k = HYB_LAWS[law]
    fused = fuse_k >= 2
    t0 = time.perf_counter()
    eng = hybrid_engine(f"main-{law}", HYB_SIM_S, "cuda", workers_cfg, fuse_k)
    setup = time.perf_counter() - t0
    seen = {}
    mp_run = isinstance(eng, MpHybridEngine)

    def on_window(start, _end, _next):
        if mp_run and not seen and start >= 10**9:
            seen["apps"] = compute_apps()
            seen["env"] = {pid: Path(f"/proc/{pid}/environ").read_bytes()
                           for pid in eng.worker_pids}

    kernels.reset_launches()
    t0 = time.perf_counter()
    res = eng.run(on_window=on_window)
    total = time.perf_counter() - t0
    counts = launch_counts()
    st = eng.sync_stats
    workers = getattr(eng, "workers", 1)
    startup = getattr(eng, "startup_s", 0.0)
    log(f"hybrid flagship, {law} law ({type(eng).__name__}, {workers} "
        f"workers): {res.counters}, rounds {res.rounds}, "
        f"{res.sim_seconds_per_wall_second:.4f} sim-s/wall-s (loop "
        f"{res.wall_seconds:.3f} s, with the workers' start-up {startup:.3f} "
        f"s and collect {total:.3f} s; engine set-up "
        f"{setup:.3f} s); device_sync_s {st['device_sync_s']:.3f}, "
        f"syscall_service_s {st['syscall_service_s']:.3f}; "
        f"{sync_counts(eng)}; launches {counts}; nvidia-smi: {smi_line()}")
    if res.process_errors:
        raise AssertionError(f"process errors: {res.process_errors}")
    clean = res.counters.get("managed_exit_clean", 0)
    want = 3 * HYB_CHAINS + 1  # the 75 clients and the origin exit 0
    if clean != want:
        raise AssertionError(f"{clean} clean exits, expected {want}")
    if res.rounds != HYB_ROUNDS:
        raise AssertionError(f"{res.rounds} rounds, expected {HYB_ROUNDS}")
    for k in ("managed_tcp_tx_bytes", "managed_tcp_rx_bytes",
              "tgen_recv_bytes"):
        if res.counters.get(k, 0) <= 0:
            raise AssertionError(f"no {k} in {res.counters}")
    window = "hybrid_fused_window" if fused else "hybrid_window"
    other = "hybrid_window" if fused else "hybrid_fused_window"
    for k in ("inject_merge", "lane_slots", "exchange_merge", window,
              "append_log"):
        if counts[k] <= 0:
            raise AssertionError(f"hybrid flagship {law}: {k} was not "
                                 "launched")
    if counts["queue_min_window"] or counts[other]:
        raise AssertionError(f"hybrid flagship {law}: ran C's other modes")
    if mp_run:
        if workers != min(os.cpu_count() or 1, 151) or workers < 2:
            raise AssertionError(f"{workers} workers on "
                                 f"{os.cpu_count()} cores")
        if "apps" not in seen:
            raise AssertionError("the compute apps were never read")
        pids = {int(a[0]) for a in seen["apps"]}
        if pids & set(eng.worker_pids) or len(seen["apps"]) > 1:
            raise AssertionError(f"worker processes hold a CUDA context: "
                                 f"{seen['apps']}, workers {eng.worker_pids}")
        for pid, env in seen["env"].items():
            if b"CUDA_VISIBLE_DEVICES=\x00" not in env:
                raise AssertionError(f"worker {pid} sees the card")
        log(f"compute apps while {workers} workers ran: {seen['apps']} "
            f"(this process {os.getpid()}; workers {eng.worker_pids}, each "
            "with CUDA_VISIBLE_DEVICES empty)")
    return {"counts": counts, "result": res, "sync": dict(st),
            "rate": res.sim_seconds_per_wall_second, "total_s": total,
            "setup_s": setup, "startup_s": startup, "workers": workers,
            "apps": seen.get("apps")}


@phase("hybrid main path: managed_relay_chains_large at full width, 10 sim s, "
       "strict capacity, at the reference's defaults (the fused law, k = 8, "
       "eager dispatch, a worker process per core) and on the one-window "
       "law, a worker process per core")
def hybrid_main() -> dict:
    out = {law: hybrid_flagship(law) for law in HYB_LAWS}
    a = out["fused"]["result"]
    for law in HYB_LAWS:
        b = out[law]["result"]
        if a.log_tuples() != b.log_tuples() or mod_iters(a) != mod_iters(b):
            raise AssertionError(f"hybrid flagship: the {law} run's logs or "
                                 "counters differ from the defaults'")
    log(f"hybrid flagship: the two laws equal ({len(a.event_log)} records);"
        f" device turns {out['fused']['sync']['device_turns']} fused against "
        f"{out['one-window']['sync']['device_turns']} one-window")
    return out


# ---- parity and the main path ----------------------------------------------

def _switch(up: str, down: str, latency: str, loss: float = 0.0) -> dict:
    edge_loss = f" packet_loss {loss}" if loss else ""
    return {"graph": {"type": "gml", "inline": (
        f'graph [ directed 0 node [ id 0 host_bandwidth_up "{up}" '
        f'host_bandwidth_down "{down}" ] edge [ source 0 target 0 '
        f'latency "{latency}"{edge_loss} ] ]')}}


# the parity configs: name -> (config, strict capacity, what must happen)
PARITY = {
    # a 256-host tgen mesh with logging: multi-warp merge rows (W = 136)
    "mesh256": ({
        "general": {"stop_time": "200ms", "seed": 11},
        "network": _switch("50 Mbit", "50 Mbit", "3 ms"),
        "hosts": {"m": {"count": 256, "network_node_id": 0, "processes": [
            {"path": "tgen-mesh", "args": "--interval 7ms --size 400"}]}},
    }, True, "records"),
    # a saturated 2 Mbit downlink: bucket waits and CoDel drops on the path,
    # 2056-entry merge rows
    "bottleneck": ({
        "general": {"stop_time": "400ms", "seed": 9},
        "experimental": {"tpu_lane_queue_capacity": 1024},
        "network": _switch("20 Mbit", "2 Mbit", "1 ms"),
        "hosts": {
            "blast": {"network_node_id": 0, "processes": [{
                "path": "tgen-client",
                "args": "--server sink --interval 1ms --size 1200"}]},
            "sink": {"network_node_id": 0},
        },
    }, True, "lane_drop_codel"),
    # 40 synchronized senders into one sink past C and Cx (non-strict):
    # cross-block sheds and queue overflow on the path
    "overflow": ({
        "general": {"stop_time": "100ms", "seed": 2},
        "experimental": {"tpu_lane_queue_capacity": 9,
                         "tpu_cross_capacity": 4},
        "network": _switch("1 Gbit", "1 Gbit", "1 ms"),
        "hosts": {
            "c": {"count": 40, "network_node_id": 0, "processes": [{
                "path": "tgen-client",
                "args": "--server sink --interval 5ms --size 300"}]},
            "sink": {"network_node_id": 0},
        },
    }, False, "lane_drop_queue"),
    # 64 phold hosts: DELIVERY self-inserts, the co-pop rule, APP draws
    "phold64": (phold_doc(n_hosts=64, stop_time="200ms", seed=7), True,
                "phold_hops"),
    # a lossy 32-host mesh whose first 100 ms are the loss-free bootstrap
    "lossy_bootstrap": ({
        "general": {"stop_time": "300ms", "seed": 3,
                    "bootstrap_end_time": "100ms"},
        "network": _switch("10 Mbit", "10 Mbit", "1 ms", 0.2),
        "hosts": {"m": {"count": 32, "network_node_id": 0, "processes": [
            {"path": "tgen-mesh", "args": "--interval 5ms --size 600"}]}},
    }, True, "lane_drop_loss"),
    # ping client and echo server
    "ping": ({
        "general": {"stop_time": "2s", "seed": 5},
        "network": {"graph": {"type": "1_gbit_switch"}},
        "hosts": {
            "cli": {"network_node_id": 0, "processes": [{
                "path": "ping", "args": "--peer srv --count 4 --interval 250ms"}]},
            "srv": {"network_node_id": 0, "processes": [{"path": "ping"}]},
        },
    }, True, "lane_sends"),
    # dynamic runahead: wide windows until the first 2 ms send narrows them
    "dynamic_runahead": ({
        "general": {"stop_time": "2s", "seed": 13},
        "network": {"graph": {"type": "gml", "inline": (
            'graph [ directed 0 '
            'node [ id 0 host_bandwidth_up "100 Mbit" host_bandwidth_down "100 Mbit" ] '
            'node [ id 1 host_bandwidth_up "100 Mbit" host_bandwidth_down "100 Mbit" ] '
            'edge [ source 0 target 0 latency "2 ms" ] '
            'edge [ source 0 target 1 latency "40 ms" ] '
            'edge [ source 1 target 1 latency "2 ms" ] ]')}},
        "experimental": {"use_dynamic_runahead": True},
        "hosts": {
            "a": {"network_node_id": 0, "processes": [{
                "path": "tgen-client",
                "args": "--server b --interval 30ms --size 600"}]},
            "b": {"network_node_id": 1, "processes": [{"path": "tgen-server"}]},
            "c": {"network_node_id": 1, "processes": [{
                "path": "ping", "args": "--peer d --count 5 --interval 100ms"}]},
            "d": {"network_node_id": 1, "processes": [{"path": "ping"}]},
        },
    }, True, "lane_delivered"),
}


def run_engine(eng: GpuEngine, mode: str):
    """Drive ``eng`` to the end in ``mode``; returns the result and the final
    state (on the CPU)."""
    state = eng.initial_state()
    p, tb = eng.params, eng.tables
    if mode == "device":
        lanes._build_full_run(p, tb, state)()
    else:
        round_fn = lanes._build_round(p, tb, state)
        while not round_fn():
            pass
    res = eng.collect(state, 0.0)
    return res, {f: t.cpu() for f, t in fields(state).items()}


def parity_run(name: str, dev: str, mode: str):
    doc, strict, _must = PARITY[name]
    return run_engine(GpuEngine(ConfigOptions.from_dict(doc), device=dev,
                                strict_capacity=strict), mode)


@phase("parity: card and CPU, step and device, seven configs")
def parity():
    for name, (_doc, _strict, must) in PARITY.items():
        runs = {}
        for dev in ("cuda", "cpu"):
            for mode in ("step", "device"):
                res, st = (cpu_ref(parity_run, name, dev, mode)[0]
                           if dev == "cpu" else parity_run(name, dev, mode))
                runs[(dev, mode)] = (res, st)
                log(f"{name} {dev}/{mode}: {len(res.event_log)} records, "
                    f"{res.counters}, rounds {res.rounds}")
        ref_res, ref_st = runs[("cpu", "step")]
        if must == "records":
            if len(ref_res.event_log) < 1000:
                raise AssertionError(f"{name}: logged too little")
        elif ref_res.counters.get(must, 0) == 0:
            raise AssertionError(f"{name}: no {must}")
        for key, (res, st) in runs.items():
            if res.log_tuples() != ref_res.log_tuples():
                raise AssertionError(f"{name} {key}: event log differs")
            if res.counters != ref_res.counters:
                raise AssertionError(f"{name} {key}: counters differ")
            # every word, empty slots included: both sides merge by
            # (key, index), so the states are identical, not just equivalent
            assert_equal(f"{name} {key} final state", st, ref_st)


def _stream_pair_doc(loss: float = 0.0, cubic: bool = False,
                     tiered: bool = False, latency: str = "15 ms",
                     size: str = "200kB", dynamic: bool = False) -> dict:
    """``tests/test_lane_parity.py``'s STREAM_PAIR: 200 kB over one 15 ms
    link between two 20 Mbit nodes, 30 sim s; untiered unless ``tiered``
    (the variants of ``tests/test_torch_tier.py`` by the other arguments)."""
    edge_loss = f" packet_loss {loss}" if loss else ""
    client = {"network_node_id": 0, "processes": [{
        "path": "stream-client", "args": ["--server", "s", "--size", size]}]}
    if cubic:
        client["congestion"] = "cubic"
    return {
        "general": {"stop_time": "30s", "seed": 5},
        "experimental": {"tpu_lane_queue_capacity": 128,
                         "tpu_stream_tiered": tiered,
                         "use_dynamic_runahead": dynamic},
        "network": {"graph": {"type": "gml", "inline": (
            'graph [ directed 0 '
            'node [ id 0 host_bandwidth_up "20 Mbit" host_bandwidth_down "20 Mbit" ] '
            'node [ id 1 host_bandwidth_up "20 Mbit" host_bandwidth_down "20 Mbit" ] '
            f'edge [ source 0 target 1 latency "{latency}"{edge_loss} ] ]')}},
        "hosts": {"c": client, "s": {"network_node_id": 1, "processes": [
            {"path": "stream-server"}]}},
    }


def _cubic_vs_reno():
    doc = presets.cubic_vs_reno_example_doc()
    doc["experimental"] = {"tpu_stream_tiered": False}
    return ConfigOptions.from_dict(doc)


def _mixed_small(tiered: bool = False):
    cfg = flagship_mesh_config(12, sim_seconds=2, stream_pairs=2,
                               stream_bytes=200_000, queue_capacity=96,
                               pops_per_round=4)
    cfg.experimental.tpu_stream_tiered = tiered
    return cfg


def _pair(**kw):
    return lambda: ConfigOptions.from_dict(_stream_pair_doc(**kw))


# the stream parity configs: name -> (config, CPU modes, what must happen).
# The long ones run on the CPU in device mode only: the CPU tests hold the
# plain path's step mode equal to its device mode.
STREAM_PARITY = {
    "stream_pair": (lambda: ConfigOptions.from_dict(_stream_pair_doc()),
                    ("step", "device"), "stream_complete"),
    "stream_pair_lossy": (
        lambda: ConfigOptions.from_dict(_stream_pair_doc(loss=0.03)),
        ("step", "device"), "stream_retransmits"),
    # tests/test_lane_parity.py's STREAM_STAR: 6 clients x 80 kB into one
    # server, 1% loss, C=512 (merge rows of W = 1040): the combined exchange
    "stream_star": (lambda: ConfigOptions.from_dict({
        "general": {"stop_time": "60s", "seed": 9},
        "experimental": {"tpu_lane_queue_capacity": 512},
        "network": _switch("50 Mbit", "50 Mbit", "5 ms", 0.01),
        "hosts": {
            "c": {"count": 6, "network_node_id": 0, "processes": [{
                "path": "stream-client",
                "args": ["--server", "srv", "--size", "80kB"]}]},
            "srv": {"network_node_id": 0, "processes": [
                {"path": "stream-server"}]},
        }}), ("device",), "stream_retransmits"),
    # examples/cubic-vs-reno.yaml, untiered: the CUBIC growth law
    "cubic_vs_reno": (_cubic_vs_reno, ("device",), "stream_retransmits"),
    # a 12-host mesh whose spray crosses two stream pairs
    "mixed_small": (_mixed_small, ("step", "device"), "stream_rx_bytes"),
    # tests/test_torch_tier.py's configs on the tiered stream pass: the
    # pair, lossy, CUBIC, the small mixed mesh, a 250 ms link (no wide pop:
    # same-instant pops, no delivery elision) and dynamic runahead
    "tier_pair": (_pair(tiered=True), ("step", "device"), "stream_complete"),
    "tier_pair_lossy": (_pair(tiered=True, loss=0.03), ("device",),
                        "stream_retransmits"),
    "tier_cubic_pair": (_pair(tiered=True, cubic=True), ("device",),
                        "stream_complete"),
    "tier_mixed_small": (lambda: _mixed_small(tiered=True), ("device",),
                         "stream_rx_bytes"),
    "tier_slow_pair": (_pair(tiered=True, latency="250 ms", size="60kB"),
                       ("step",), "stream_complete"),
    "tier_dyn_pair": (_pair(tiered=True, dynamic=True), ("device",),
                      "stream_complete"),
}
# the same simulation on the two stream paths: equal logs and counters (the
# iteration count aside)
TIERED_TWINS = (("stream_pair", "tier_pair"),
                ("stream_pair_lossy", "tier_pair_lossy"),
                ("mixed_small", "tier_mixed_small"))


def stream_cpu(name: str, mode: str):
    return run_engine(GpuEngine(STREAM_PARITY[name][0](), device="cpu"), mode)


@phase("stream parity: card (step and device) and CPU, five untiered and "
       "six tiered configs; tiered = untiered")
def stream_parity():
    refs = {}
    for name, (cfg_fn, cpu_modes, must) in STREAM_PARITY.items():
        runs = {}
        for dev, modes in (("cpu", cpu_modes), ("cuda", ("step", "device"))):
            for mode in modes:
                if dev == "cpu":
                    (res, st), secs = cpu_ref(stream_cpu, name, mode)
                else:
                    t0 = time.perf_counter()
                    res, st = run_engine(GpuEngine(cfg_fn(), device=dev), mode)
                    secs = time.perf_counter() - t0
                runs[(dev, mode)] = (res, st)
                log(f"{name} {dev}/{mode}: {len(res.event_log)} records, "
                    f"{res.counters}, rounds {res.rounds} ({secs:.1f} s)")
        ref_res, ref_st = runs[("cpu", cpu_modes[0])]
        refs[name] = ref_res
        if ref_res.counters.get(must, 0) == 0:
            raise AssertionError(f"{name}: no {must}")
        if ref_res.counters.get("stream_rx_bytes", 0) == 0:
            raise AssertionError(f"{name}: no stream bytes")
        for key, (res, st) in runs.items():
            if res.log_tuples() != ref_res.log_tuples():
                raise AssertionError(f"{name} {key}: event log differs")
            if res.counters != ref_res.counters or res.rounds != ref_res.rounds:
                raise AssertionError(f"{name} {key}: counters differ")
            assert_equal(f"{name} {key} final state", st, ref_st)
    for untiered, tiered in TIERED_TWINS:
        a, b = refs[untiered], refs[tiered]
        ca = {k: v for k, v in a.counters.items() if k != "lane_iters"}
        cb = {k: v for k, v in b.counters.items() if k != "lane_iters"}
        if (a.log_tuples() != b.log_tuples() or ca != cb
                or a.rounds != b.rounds):
            raise AssertionError(f"{tiered}: the tiered run differs from "
                                 "the untiered one")
        log(f"{tiered} = {untiered}: {len(a.event_log)} records, iterations "
            f"{b.counters['lane_iters']} tiered, {a.counters['lane_iters']} "
            "untiered")


def tcp_prefix_run(dev: str):
    """``examples/stream-tcp.yaml``'s first 0.75 sim s on ``dev``."""
    doc = presets.stream_tcp_example_doc()
    doc["general"]["stop_time"] = "750ms"
    return run_engine(GpuEngine(ConfigOptions.from_dict(doc), device=dev),
                      "device")


@phase("examples/stream-tcp.yaml: 60 sim s on the card; a prefix card = CPU")
def stream_tcp_example():
    """4 clients x 1 MiB into one server over a 40 ms link with 2% loss:
    every flow completes with retransmissions; over the first 0.75 sim s,
    which hold retransmissions already, card and CPU are equal word for
    word."""
    res, _st = run_engine(GpuEngine(ConfigOptions.from_dict(
        presets.stream_tcp_example_doc())), "device")
    c = res.counters
    log(f"stream-tcp.yaml 60 s on the card: {c}, rounds {res.rounds}")
    if (c.get("stream_complete") != 4 or c.get("stream_flows_done") != 4
            or c.get("stream_rx_bytes") != 4 * 1_048_576
            or not c.get("stream_retransmits")):
        raise AssertionError(f"stream-tcp.yaml counters {c}")
    runs = {}
    for dev in ("cuda", "cpu"):
        if dev == "cpu":
            runs[dev], secs = cpu_ref(tcp_prefix_run, dev)
        else:
            t0 = time.perf_counter()
            runs[dev] = tcp_prefix_run(dev)
            secs = time.perf_counter() - t0
        log(f"stream-tcp.yaml 0.75 s {dev}: {runs[dev][0].counters} "
            f"({secs:.1f} s)")
    (res_g, st_g), (res_c, st_c) = runs["cuda"], runs["cpu"]
    retx = int(st_c["stream"][0, :, lstr.C_RETRANS].sum())
    if not retx:
        raise AssertionError("the prefix holds no retransmission")
    if res_g.log_tuples() != res_c.log_tuples() or res_g.counters != res_c.counters:
        raise AssertionError("stream-tcp.yaml prefix: card and CPU differ")
    assert_equal("stream-tcp.yaml prefix final state", st_g, st_c)
    log(f"stream-tcp.yaml prefix: equal, {retx} retransmissions, "
        f"{len(res_c.event_log)} records")


def expected_mesh(n: int, sim_s: int) -> dict:
    """The flagship mesh's closed form (10 ms timers, 10 ms links, no
    drops): ticks at 10, 20, ... ms before the stop send; a packet sent at
    t arrives at t + 10 ms."""
    ticks = sim_s * 100 - 1
    return {"lane_sends": n * ticks, "lane_delivered": n * (ticks - 1),
            "tgen_recv_bytes": n * (ticks - 1) * 1428,
            "lane_iters": sim_s * 100}


def mixed_100ms(make):
    def cfg_fn():
        cfg = make(1)
        cfg.general.stop_time = 100_000_000
        return cfg
    return cfg_fn


# name -> (config function, log capacity)
FULL_WIDTH = {
    "phold 25 ms": (lambda: phold(stop_time="25ms"), 1_000_000),
    "lossy flagship 1 s": (lambda: flagship(sim_seconds=1, packet_loss=0.01),
                           1_200_000),
    "mixed mesh 100 ms": (mixed_100ms(mixed_mesh), 400_000),
    "mixed mesh tiered 100 ms": (mixed_100ms(mixed_tiered), 400_000),
}


def full_width_run(name: str, dev: str):
    cfg_fn, log_cap = FULL_WIDTH[name]
    return run_engine(GpuEngine(cfg_fn(), log_capacity=log_cap, device=dev),
                      "device")


@phase("full width: card against the CPU plain path")
def full_width_parity():
    """PHOLD at 10,000 hosts for 25 sim ms, the lossy flagship for 1 sim s
    and the mixed mesh, untiered and tiered, for 100 sim ms (the handshakes
    and the first bursts), device mode with logging: equal event logs,
    counters and final states."""
    for name in FULL_WIDTH:
        runs = {}
        for dev in ("cuda", "cpu"):
            if dev == "cpu":
                (res, st), secs = cpu_ref(full_width_run, name, dev)
            else:
                t0 = time.perf_counter()
                res, st = full_width_run(name, dev)
                secs = time.perf_counter() - t0
            runs[dev] = (res, st)
            log(f"{name} {dev}: {len(res.event_log)} records, {res.counters}, "
                f"rounds {res.rounds} ({secs:.1f} s)")
        (res_g, st_g), (res_c, st_c) = runs["cuda"], runs["cpu"]
        if len(res_c.event_log) < 10_000:
            raise AssertionError(f"{name}: logged too little")
        if res_g.log_tuples() != res_c.log_tuples():
            raise AssertionError(f"{name}: event log differs")
        if res_g.counters != res_c.counters or res_g.rounds != res_c.rounds:
            raise AssertionError(f"{name}: counters differ")
        assert_equal(f"{name} final state", st_g, st_c)
        if name.startswith("mixed") and not res_c.counters.get("stream_rx_segs"):
            raise AssertionError("mixed mesh 100 ms: no stream data yet")


def check_flagship(res, sim_s: int, log_cap: int, _eng=None) -> None:
    exp = expected_mesh(N_FLAG, sim_s)
    got = {k: res.counters.get(k, 0) for k in exp}
    if got != exp:
        raise AssertionError(f"counters {got} != closed form {exp}")
    if log_cap:
        if len(res.event_log) != exp["lane_delivered"]:
            raise AssertionError("log rows != deliveries")
        times = np.array([r.time for r in res.event_log])
        if not (np.all(times >= 10_000_000) and np.all(times < 10**9)):
            raise AssertionError("log times outside the run")


def check_phold(res, _sim_s: int, _log_cap: int, _eng=None) -> None:
    """Message conservation: each of the 40,000 messages is sent once at
    the start and once per hop; nothing is lost or dropped."""
    c = res.counters
    sends, hops = c.get("lane_sends", 0), c.get("phold_hops", 0)
    delivered = c.get("lane_delivered", 0)
    drops = {k: c.get(k, 0) for k in
             ("lane_drop_loss", "lane_drop_codel", "lane_drop_queue")}
    log(f"phold: sends - hops = {sends - hops}, delivered {delivered}, "
        f"drops {drops}")
    if sends - hops != 4 * N_FLAG:
        raise AssertionError(f"sends - hops = {sends - hops} != {4 * N_FLAG}")
    if not sends >= delivered >= hops > 0:
        raise AssertionError("want sends >= delivered >= hops > 0")


def check_lossy(res, _sim_s: int, _log_cap: int, _eng=None) -> None:
    """Every tick sends; 1% of the sends are lost, within 5 sigma (98,327
    to 101,473 of 9,990,000); what is neither delivered nor lost was sent
    in the last tick."""
    c = res.counters
    sends, lost = c.get("lane_sends", 0), c.get("lane_drop_loss", 0)
    unsettled = sends - c.get("lane_delivered", 0) - lost
    p_loss = rng_mod.loss_threshold(0.01) / 2**32
    mean = sends * p_loss
    sigma = (sends * p_loss * (1 - p_loss)) ** 0.5
    lo, hi = int(np.floor(mean - 5 * sigma)), int(np.ceil(mean + 5 * sigma))
    log(f"lossy: sends {sends}, lost {lost} ({lost / max(sends, 1):.6f}; "
        f"5-sigma band {lo}..{hi}), sent but not yet delivered {unsettled}")
    if sends != N_FLAG * 999:
        raise AssertionError(f"sends {sends} != {N_FLAG * 999}")
    if not lo <= lost <= hi:
        raise AssertionError(f"loss count {lost} outside the 5-sigma band")
    if not 0 <= unsettled <= N_FLAG:
        raise AssertionError(f"{unsettled} sends neither delivered nor lost")


# the JAX package's iteration counts for the mixed mesh's 500 windows
# (docs/tpu-backend.md): a property of the event order and the capacities,
# not of the chip — an expectation, not a check
MIXED_ITERS = {True: 623, False: 2231}


def check_mixed(res, _sim_s: int, _log_cap: int, tiered: bool) -> None:
    """Every one of the 100 flows completes at both ends with its 2,000,000
    bytes; nothing is dropped (strict capacity raised nothing)."""
    c = res.counters
    log(f"mixed mesh ({'tiered' if tiered else 'untiered'}): "
        f"{c.get('lane_iters')} iterations (the reference's: "
        f"{MIXED_ITERS[tiered]}), {res.rounds} windows; streams "
        f"{({k: v for k, v in c.items() if 'stream' in k})}")
    want = {"stream_complete": 100, "stream_flows_done": 100,
            "stream_rx_bytes": 200_000_000}
    got = {k: c.get(k, 0) for k in want}
    if got != want:
        raise AssertionError(f"stream counters {got} != {want}")
    drops = {k: c.get(k, 0) for k in
             ("lane_drop_loss", "lane_drop_codel", "lane_drop_queue")}
    if any(drops.values()):
        raise AssertionError(f"drops {drops}")


def check_cubic_vs_reno(res, _sim_s: int, _log_cap: int, _eng=None) -> None:
    """Both flows (CUBIC and NewReno) complete with their 2,000,000 bytes
    across the 1% loss, with retransmissions; no queue drop."""
    c = res.counters
    log(f"cubic-vs-reno.yaml: {c}, {res.rounds} windows")
    want = {"stream_complete": 2, "stream_flows_done": 2,
            "stream_rx_bytes": 4_000_000}
    if {k: c.get(k, 0) for k in want} != want:
        raise AssertionError(f"stream counters {c}")
    if not (c.get("stream_retransmits") and c.get("lane_drop_loss")):
        raise AssertionError("no loss recovery ran")
    if c.get("lane_drop_queue"):
        raise AssertionError("queue drops")


# the main paths: name -> (config, log capacity, check, sim seconds)
def netobs_only(cfg):
    cfg.experimental.netobs = True
    return cfg


def planes_log_capacity() -> int:
    """The 1 s planes run's log, sized from its counts: every mesh delivery
    of the closed form, a PCAP_TX row per send of the 100 capturing mesh
    hosts, and per stream pair at most 4 rows per segment each way (a
    capture at the sender, a delivery at the receiver; the data segments,
    SYN and FIN, and as many ACKs)."""
    mesh = N_FLAG - 200
    segs = -(-2_000_000 // 1448)  # the stream-client's default MSS
    return (expected_mesh(mesh, 1)["lane_delivered"] + 100 * 99
            + 100 * 4 * (segs + 3))


def check_netobs(res, sim_s: int, log_cap: int, eng) -> None:
    """The netobs run: the flows' closed form as without it; the snapshot's
    packets equal the run's counters, the mesh's bytes 1428 a send, every
    drop cause 0 (the mesh is loss-free), and the histogram counts each
    window with a packet once: every window but the first, which holds
    only the start events (the first packets, the SYNs sent at 0, arrive
    at 10 ms, the first window's end)."""
    check_mixed(res, sim_s, log_cap, True)
    snap = eng.netobs_snapshot()
    a, c = snap["arrays"], res.counters
    tot = {k: int(v.sum()) for k, v in a.items()}
    mesh = (eng.tables.model == lanes.M_TGEN_MESH).cpu().numpy()
    hist = snap["window_hist"]
    log(f"netobs: totals {tot}; window histogram {hist.tolist()} "
        f"({int(hist.sum())} windows of {res.rounds})")
    if tot["sent"] != c["lane_sends"] or tot["delivered"] != c["lane_delivered"]:
        raise AssertionError("netobs packets differ from the run's counters")
    if int(a["tx_bytes"][mesh].sum()) != 1428 * int(a["sent"][mesh].sum()):
        raise AssertionError("the mesh's tx_bytes are not 1428 a send")
    drops = {k: tot[k] for k in ("drop_loss", "drop_codel", "drop_queue",
                                 "drop_cross_shed", "retry_giveup")}
    if any(drops.values()):
        raise AssertionError(f"drops on a loss-free mesh: {drops}")
    if int(hist.sum()) != res.rounds - 1 or res.rounds > 500:
        raise AssertionError("the window histogram does not count the windows")


def check_pcap(res, _sim_s: int, log_cap: int, eng) -> None:
    """The planes run with pcap: each capturing host's file holds exactly
    its PCAP_TX rows (one per send: the mesh is loss-free) and its
    DELIVERED rows, and no other host has a file or a PCAP_TX row."""
    s = eng._live_state
    rows = s.log[: int(s.log_count)].cpu().numpy()
    n = eng.params.n_lanes
    tx = np.bincount(rows[rows[:, 5] == 4, 1], minlength=n)
    rx = np.bincount(rows[rows[:, 5] == 0, 2], minlength=n)
    files = pcap_files(eng.cfg.general.data_directory)
    capture = np.array([h.pcap_enabled for h in eng.cfg.hosts])
    sent = eng.netobs_snapshot()["arrays"]["sent"]
    log(f"pcap: {len(rows)} log rows of {log_cap}, {int(tx.sum())} PCAP_TX, "
        f"{len(files)} capture files of {sum(len(b) for b in files.values())} "
        f"bytes, written in {eng.pcap_write_s:.3f} s")
    if set(files) != {h.hostname for h in eng.cfg.hosts if h.pcap_enabled}:
        raise AssertionError("capture files are not the capturing hosts'")
    if int(tx[~capture].sum()) or not np.array_equal(tx[capture],
                                                     sent[capture]):
        raise AssertionError("PCAP_TX rows are not the capturing hosts' sends")
    for hid, h in enumerate(eng.cfg.hosts):
        if h.pcap_enabled and pcap_records(files[h.hostname]) != tx[hid] + rx[hid]:
            raise AssertionError(f"{h.hostname}: capture file records differ "
                                 "from its log rows")


FLOW_MAIN = "mixed mesh 10k, untiered, flowtrace, 1 s"


def check_flowtrace(res, _sim_s: int, _log_cap: int, eng) -> None:
    """The traced run: the ring kept every event; its FT_SEND and
    FT_RETRANSMIT rows are the run's sends, its FT_DELIVERY rows its
    deliveries, and it holds no FT_DROP (the mesh is loss-free, strict
    capacity raised nothing, and the netobs run counts no drop cause)."""
    s = eng._live_state
    kept, lost = int(s.fl_count), int(s.fl_lost)
    kinds = torch.bincount(s.fl_buf[:min(kept, FLOW_RING), 4].long(),
                           minlength=6).tolist()
    c = res.counters
    names = ("send", "tb_wait", "queue_enter", "drop", "retransmit",
             "delivery")
    log(f"flowtrace: {kept} events of a {FLOW_RING}-row ring, lost {lost}; "
        f"by kind {dict(zip(names, kinds))}; decoded in "
        f"{eng.flow_decode_s:.3f} s; sends {c.get('lane_sends')}, delivered "
        f"{c.get('lane_delivered')}")
    if lost or len(eng.flowtrace_snapshot()["raw"]) != kept:
        raise AssertionError("the ring lost events")
    if kinds[ftr.FT_SEND] + kinds[ftr.FT_RETRANSMIT] != c["lane_sends"]:
        raise AssertionError("FT_SEND + FT_RETRANSMIT rows != the run's sends")
    if kinds[ftr.FT_DELIVERY] != c["lane_delivered"]:
        raise AssertionError("FT_DELIVERY rows != the run's deliveries")
    drops = {k: c.get(k, 0) for k in
             ("lane_drop_loss", "lane_drop_codel", "lane_drop_queue")}
    if kinds[ftr.FT_DROP] or any(drops.values()):
        raise AssertionError(f"drops on a loss-free mesh: {kinds}, {drops}")


MAIN_PATHS = {
    # the mixed TCP/UDP mesh at 10,000 hosts, tiered at the preset's own
    # tuning
    "mixed mesh 10k, tiered, 5 s": (
        lambda: mixed_tiered(5), 0,
        lambda r, s_, l_, _e: check_mixed(r, s_, l_, True), 5),
    # this slice's: the same with netobs on, and with netobs and pcap (the
    # 200 stream endpoints and 100 mesh hosts) and a log, 1 s
    "mixed mesh 10k, tiered, netobs, 5 s": (
        lambda: netobs_only(mixed_tiered(5)), 0, check_netobs, 5),
    "mixed mesh 10k, tiered, netobs + pcap, logging, 1 s": (
        lambda: planes(mixed_tiered(1), "main"), planes_log_capacity(),
        check_pcap, 1),
    # this slice's: the mesh untiered with every flow traced, 1 s
    FLOW_MAIN: (
        lambda: with_flowtrace(mixed_mesh(1), cap=FLOW_RING), 0,
        check_flowtrace, 1),
    # the same mesh untiered (kernel E), at the pre-tier queue shape
    "mixed mesh 10k, untiered, 5 s": (
        lambda: mixed_mesh(5), 0,
        lambda r, s_, l_, _e: check_mixed(r, s_, l_, False), 5),
    # examples/cubic-vs-reno.yaml as it stands: tiered, CUBIC in the tier
    "cubic-vs-reno.yaml, 60 s": (
        lambda: ConfigOptions.from_dict(presets.cubic_vs_reno_example_doc()),
        0, check_cubic_vs_reno, 60),
    "flagship 1 s, logging": (lambda: flagship(sim_seconds=1), 1_200_000,
                              check_flagship, 1),
    "flagship 10 s": (lambda: flagship(sim_seconds=10), 0, check_flagship, 10),
    "phold 10 s": (lambda: phold(stop_time="10s"), 0, check_phold, 10),
    "lossy flagship 10 s": (lambda: flagship(sim_seconds=10, packet_loss=0.01),
                            0, check_lossy, 10),
}


# ---- fault schedules and fleet sweeps ---------------------------------------

def _graph(nodes: int, bw: str, edges) -> dict:
    """An undirected GML graph: ``nodes`` nodes of ``bw`` both ways and
    ``edges`` (source, target, latency[, loss])."""
    text = "graph [ directed 0 " + " ".join(
        f'node [ id {i} host_bandwidth_up "{bw}" host_bandwidth_down "{bw}" ]'
        for i in range(nodes))
    for e in edges:
        loss = f" packet_loss {e[3]}" if len(e) > 3 else ""
        text += f' edge [ source {e[0]} target {e[1]} latency "{e[2]}"{loss} ]'
    return {"graph": {"type": "gml", "inline": text + " ]"}}


def _client(server: str, interval: str) -> dict:
    return {"path": "tgen-client",
            "args": f"--server {server} --interval {interval} --size 600"}


_PAIR_2N = _graph(2, "100 Mbit", [(0, 0, "2 ms"), (0, 1, "5 ms"),
                                  (1, 1, "2 ms")])
_PAIR_HOSTS = {"a": {"network_node_id": 0, "processes": [_client("b", "50ms")]},
               "b": {"network_node_id": 1,
                     "processes": [{"path": "tgen-server"}]}}

# the fault twins of tests/test_torch_faults.py: config, what must happen
FAULT_PARITY = {
    "tgen_faulted": ({
        "general": {"stop_time": "300ms", "seed": 3},
        "network": _graph(2, "10 Mbit", [(0, 1, "10 ms", 0.2)]),
        "faults": {"events": [
            {"at": "50ms", "kind": "latency", "source": 0, "target": 1,
             "latency": "25 ms"},
            {"at": "100ms", "kind": "link_down", "source": 0, "target": 1},
            {"at": "200ms", "kind": "link_up", "source": 0, "target": 1}]},
        "hosts": {"tx": {"network_node_id": 0,
                         "processes": [_client("rx", "5ms")]},
                  "rx": {"network_node_id": 1,
                         "processes": [{"path": "tgen-server"}]}},
    }, "lane_drop_loss"),
    "partition_heal": ({
        "general": {"stop_time": "3s", "seed": 13}, "network": _PAIR_2N,
        "faults": {"events": [
            {"at": "1s", "kind": "partition", "groups": [[0], [1]]},
            {"at": "2s", "kind": "heal"}]},
        "hosts": _PAIR_HOSTS,
    }, "lane_drop_loss"),
    "crash_restart": ({
        "general": {"stop_time": "3s", "seed": 13}, "network": _PAIR_2N,
        "faults": {"events": [
            {"at": "1s", "kind": "host_crash", "host": "a"},
            {"at": "1400ms", "kind": "latency", "source": 0, "target": 1,
             "latency": "15 ms"},
            {"at": "2s", "kind": "host_restart", "host": "a"}]},
        "hosts": _PAIR_HOSTS,
    }, "lane_drop_loss"),
    "every_kind": ({
        "general": {"stop_time": "1s", "seed": 3},
        "network": _graph(3, "10 Mbit", [
            (0, 0, "1 ms"), (1, 1, "1 ms"), (2, 2, "1 ms"),
            (0, 1, "5 ms", 0.01), (1, 2, "4 ms"), (0, 2, "7 ms")]),
        "faults": {"events": [
            {"at": "100ms", "kind": "link_down", "source": 0, "target": 1},
            {"at": "100ms", "kind": "loss", "source": 1, "target": 2,
             "loss": 0.1},
            {"at": "200ms", "kind": "latency", "source": 0, "target": 2,
             "latency": "30 ms"},
            {"at": "300ms", "kind": "partition", "groups": [[0], [1, 2]]},
            {"at": "400ms", "kind": "heal"},
            {"at": "500ms", "kind": "host_crash", "host": "c"},
            {"at": "600ms", "kind": "host_restart", "host": "c"},
            {"at": "600ms", "kind": "link_up", "source": 0, "target": 1}]},
        "hosts": {"a": {"network_node_id": 0,
                        "processes": [_client("c", "20ms")]},
                  "b": {"network_node_id": 1,
                        "processes": [{"path": "tgen-server"}]},
                  "c": {"network_node_id": 2,
                        "processes": [{"path": "tgen-server"}]}},
    }, "lane_drop_loss"),
}
for _tiered in (True, False):
    FAULT_PARITY[f"loss_ramp tiered={_tiered}"] = ({
        "general": {"stop_time": "2s", "seed": 5},
        "network": _graph(2, "50 Mbit", [(0, 1, "10 ms")]),
        "experimental": {"tpu_stream_tiered": _tiered},
        "faults": {"events": [
            {"at": "20ms", "kind": "loss", "source": 0, "target": 1,
             "loss": 0.25},
            {"at": "60ms", "kind": "loss", "source": 0, "target": 1,
             "loss": 0.0}]},
        "hosts": {"c1": {"network_node_id": 0, "processes": [{
            "path": "stream-client", "args": "--server s1 --size 300kB"}]},
                  "s1": {"network_node_id": 1,
                         "processes": [{"path": "stream-server"}]}},
    }, "stream_retransmits")


def faulted_run(cfg, dev: str, mode: str, log_cap=None):
    """A faulted run through ``GpuEngine.run``; the result and the final
    state (on the CPU)."""
    eng = GpuEngine(cfg, device=dev, log_capacity=log_cap)
    res = eng.run(mode=mode)
    return res, {f: t.cpu() for f, t in fields(eng._live_state).items()}


def faulted_flagship():
    """The lossy flagship (10,000 hosts, 1% loss), 1 sim s, with its
    latency raised from 10 to 15 ms at 300 ms and its loss from 0.01 to
    0.05 at 600 ms."""
    cfg = flagship(sim_seconds=1, packet_loss=0.01)
    cfg.faults.events = [
        {"at": "300 ms", "kind": "latency", "source": 0, "target": 0,
         "latency": "15 ms"},
        {"at": "600 ms", "kind": "loss", "source": 0, "target": 0,
         "loss": 0.05}]
    return cfg


def loss_band(sends: int, p: float) -> tuple:
    q = rng_mod.loss_threshold(p) / 2**32
    mean, sigma = sends * q, (sends * q * (1 - q)) ** 0.5
    return int(np.floor(mean - 5 * sigma)), int(np.ceil(mean + 5 * sigma))


def fault_cpu(name: str, mode: str):
    return faulted_run(ConfigOptions.from_dict(FAULT_PARITY[name][0]), "cpu",
                       mode)


def faulted_flagship_run(dev: str):
    return faulted_run(faulted_flagship(), dev, "device", 1_200_000)


def cpu_jobs() -> list:
    """The parity phases' CPU runs, in the order the phases take them:
    (runner, *args)."""
    jobs = [(parity_run, name, "cpu", mode) for name in PARITY
            for mode in ("step", "device")]
    jobs += [(stream_cpu, name, mode)
             for name, (_f, modes, _m) in STREAM_PARITY.items()
             for mode in modes]
    jobs.append((tcp_prefix_run, "cpu"))
    jobs += [(full_width_run, name, "cpu") for name in FULL_WIDTH]
    jobs += [(plane_cpu, name) for name in PLANE_PARITY]
    jobs.append((plane_mixed_run, "cpu"))
    jobs += [(flow_cpu, name) for name in FLOW_PARITY]
    jobs.append((flow_mixed_run, "cpu"))
    jobs += [(fault_cpu, name, mode) for name in FAULT_PARITY
             for mode in ("step", "device")]
    jobs.append((faulted_flagship_run, "cpu"))
    return jobs


@phase("faults: card = CPU, step and device, six fault twins and the lossy "
       "flagship at 10k hosts with a latency and a loss epoch")
def fault_parity():
    for name, (doc, must) in FAULT_PARITY.items():
        runs = {(dev, mode): (cpu_ref(fault_cpu, name, mode)[0]
                              if dev == "cpu" else
                              faulted_run(ConfigOptions.from_dict(doc), dev,
                                          mode))
                for dev in ("cuda", "cpu") for mode in ("step", "device")}
        ref_res, ref_st = runs[("cpu", "step")]
        if not ref_res.counters.get(must, 0):
            raise AssertionError(f"{name}: no {must}")
        for key, (res, st) in runs.items():
            if (res.log_tuples() != ref_res.log_tuples()
                    or res.counters != ref_res.counters
                    or res.rounds != ref_res.rounds):
                raise AssertionError(f"{name} {key}: differs from cpu/step")
            assert_equal(f"{name} {key} final state", st, ref_st)
        log(f"faults {name}: card = CPU, step = device; "
            f"{len(ref_res.event_log)} records, {ref_res.counters}")
    runs = {}
    for dev in ("cuda", "cpu"):
        if dev == "cpu":
            runs[dev], secs = cpu_ref(faulted_flagship_run, dev)
        else:
            t0 = time.perf_counter()
            runs[dev] = faulted_flagship_run(dev)
            secs = time.perf_counter() - t0
        log(f"faulted lossy flagship {dev}: {runs[dev][0].counters}, rounds "
            f"{runs[dev][0].rounds} ({secs:.1f} s)")
    (res_g, st_g), (res_c, st_c) = runs["cuda"], runs["cpu"]
    if (res_g.log_tuples() != res_c.log_tuples()
            or res_g.counters != res_c.counters or res_g.rounds != res_c.rounds):
        raise AssertionError("faulted lossy flagship: card and CPU differ")
    assert_equal("faulted lossy flagship final state", st_g, st_c)
    rows = np.array([r.as_tuple() for r in res_g.event_log], dtype=np.int64)
    lost = rows[rows[:, 5] == 1][:, 0]
    got = (int((lost < 600_000_000).sum()), int((lost >= 600_000_000).sum()))
    bands = (loss_band(N_FLAG * 59, 0.01), loss_band(N_FLAG * 40, 0.05))
    arrivals = rows[rows[:, 5] == 0][:, 0]
    gap = int(((arrivals > 300_000_000) & (arrivals < 315_000_000)).sum())
    log(f"faulted lossy flagship: card = CPU, {len(rows)} records; losses "
        f"before / after 600 ms {got} (5-sigma bands {bands}); deliveries in "
        f"(300, 315) ms: {gap}, at 315 ms: "
        f"{int((arrivals == 315_000_000).sum())}")
    if not all(lo <= g <= hi for g, (lo, hi) in zip(got, bands)):
        raise AssertionError("faulted lossy flagship: a loss count outside "
                             "its 5-sigma band")
    if gap or not (arrivals == 315_000_000).any():
        raise AssertionError("faulted lossy flagship: the 15 ms epoch did "
                             "not take")


def fleet_cfg(n=None, sim_s: int = 5):
    """``flagship_mesh_config(n)`` (default: the full width, 10,000) at the
    bench tuning (C=16, K=2, Cx=8)."""
    cfg = flagship_mesh_config(N_FLAG if n is None else n,
                               sim_seconds=sim_s, queue_capacity=C_FLAG,
                               pops_per_round=K_FLAG)
    cfg.experimental.tpu_cross_capacity = CX_FLAG
    return cfg


FLEET_LOSS = {"at": "2 s", "kind": "loss", "source": 0, "target": 0,
              "loss": 0.01}
# the fleet cell's batch, kept for its timing phase
FLEET: dict = {}


def sweep_batch(label: str, base, spec, log_cap: int = 0) -> dict:
    """One batched card run of ``spec`` over ``base``, launch counts reset
    just before it and read just after; then each variant's serial card
    run, held to it: the counters, rounds, every LaneState field, the
    event log and, with flowtrace, the ring's events."""
    variants = expand_variants(base, spec)
    sweep = SweepEngine(variants, log_capacity=log_cap)
    kernels.reset_launches()
    t0 = time.perf_counter()
    results = sweep.run()
    total = time.perf_counter() - t0
    counts = launch_counts()
    for k in path_kernels(sweep.engines[0].params):
        if counts[k] <= 0:
            raise AssertionError(f"{label}: {k} was not launched")
    serial_walls = []
    for v, res in zip(variants, results):
        eng = GpuEngine(v.cfg, log_capacity=log_cap)
        ser = eng.run(mode="device")
        serial_walls.append(ser.wall_seconds)
        if (ser.log_tuples() != res.log_tuples()
                or ser.counters != res.counters or ser.rounds != res.rounds):
            raise AssertionError(f"{label} {v.label}: batched != serial")
        assert_equal(f"{label} {v.label} final state",
                     {f: t.cpu() for f, t in
                      fields(sweep.states[v.index]).items()},
                     {f: t.cpu() for f, t in fields(eng._live_state).items()})
        if eng.params.flowtrace and (
                eng.flowtrace_snapshot()
                != sweep.engines[v.index].flowtrace_snapshot()):
            raise AssertionError(f"{label} {v.label}: rings differ")
    wall = results[0].wall_seconds
    out = {"size": len(variants), "batch_wall_s": wall,
           "serial_wall_s": float(sum(serial_walls)),
           "scenarios_per_hour": len(variants) * 3600.0 / wall,
           "launches": counts, "per_step": sweep.launches,
           "sweep": sweep, "results": results}
    log(f"sweep {label}: S = {len(variants)} equal to their serial card runs; "
        f"batch loop {wall:.3f} s (with set-up and collect {total:.3f} s), "
        f"serial loops {out['serial_wall_s']:.3f} s in all, "
        f"{out['scenarios_per_hour']:.1f} scenarios/hour; launches {counts}, "
        f"per batched step {sweep.launches}; nvidia-smi: {smi_line()}")
    return out


@phase("sweeps: every scenario of a batched card run equals its serial card "
       "run (the fleet cell at 10k hosts, the bench's shape, the main path)")
def sweep_parity() -> dict:
    out = {}
    # the fleet cell: seeds 1-4 x {no fault, 1% loss from 2 s}, 5 sim s
    fleet = sweep_batch("fleet 8 x 10k, 5 s", fleet_cfg(),
                        SweepSpec(name="fleet", seeds=[1, 2, 3, 4],
                                  faults=[[], [FLEET_LOSS]]))
    exp = expected_mesh(N_FLAG, 5)
    sends_after = N_FLAG * 300  # the ticks at 2.00 .. 4.99 s
    lo, hi = loss_band(sends_after, 0.01)
    for v, res in zip(fleet["sweep"].variants, fleet["results"]):
        lost = res.counters.get("lane_drop_loss", 0)
        if v.fault_axis == 0:
            got = {k: res.counters.get(k, 0) for k in exp}
            if got != exp or lost:
                raise AssertionError(f"fleet {v.label}: {got} != {exp}")
        elif not lo <= lost <= hi:
            raise AssertionError(f"fleet {v.label}: loss count {lost} "
                                 f"outside its 5-sigma band {lo}..{hi}")
        log(f"fleet {v.label}: {res.counters}")
    out["fleet"] = fleet
    FLEET["sweep"] = fleet["sweep"]
    # the JAX package's bench sweep: 8 seeds x 1,000 hosts, 5 sim s
    bench = sweep_batch("bench shape 8 x 1k, 5 s", fleet_cfg(1000),
                        SweepSpec.seed_grid(1, 8))
    for res in bench["results"]:
        got = {k: res.counters.get(k, 0) for k in expected_mesh(1000, 5)}
        if got != expected_mesh(1000, 5):
            raise AssertionError(f"bench shape: {got}")
    out["bench"] = bench
    # the port's main path: 4 seeds x the tiered mixed mesh, 1 sim s
    out["mixed"] = sweep_batch("mixed mesh tiered 4 x 10k, 1 s",
                               mixed_tiered(1), SweepSpec.seed_grid(1, 4))
    if not all(r.counters.get("stream_rx_segs")
               for r in out["mixed"]["results"]):
        raise AssertionError("mixed mesh sweep: no stream data")
    # ... untiered with every flow traced, 100 sim ms (one flow seed: the
    # fault axis varies the scenarios)
    traced_cfg = with_flowtrace(mixed_mesh(1), cap=1 << 20)
    traced_cfg.general.stop_time = 100_000_000
    out["traced"] = sweep_batch(
        "mixed mesh untiered, flowtrace, 2 x 10k, 100 ms", traced_cfg,
        SweepSpec(faults=[[], [{"at": "50 ms", "kind": "loss", "source": 0,
                                "target": 0, "loss": 0.01}]]))
    for name in ("fleet", "bench", "mixed", "traced"):  # keep numbers only
        for k in ("sweep", "results"):
            out[name].pop(k)
    return out


def batch_steps(engines):
    """Fresh states of ``engines`` and the batched step over them."""
    states = [e.initial_state() for e in engines]
    run = lanes._build_sweep_run([e.params for e in engines],
                                 [e.tables for e in engines], states)
    window, iteration = lanes._steps(run.args, engines[0].params)
    return run.args.members[0].ws, window, iteration


def sweep_cells() -> dict:
    """The batched cells timed at S = 8 against S = 1: name -> (the eight
    engines, warm-up steps, the ``time_all`` cell that holds the same
    configuration's single-scenario bytes).  The fleet cell's own engines
    (its lossy scenarios beside the loss-free ones); the tiered mixed mesh
    (A, B, C, F, G) and the untiered one with every flow traced (A, B, C,
    E, D's ring) eight times over, as ``time_all`` times them alone."""
    return {
        "fleet": (FLEET["sweep"].engines, 100, "flagship"),
        "mixed_tiered": ([GpuEngine(mixed_tiered(2), log_capacity=0)
                          for _ in range(8)], 20, "mixed_tiered"),
        "mixed_flowtrace": (
            [GpuEngine(with_flowtrace(mixed_mesh(2), cap=1 << 20),
                       log_capacity=0) for _ in range(8)], 40,
            "mixed_flowtrace"),
    }


@phase("sweep timing: kernels per batched launch at S = 8 and S = 1 (the "
       "fleet cell, the mixed mesh tiered and traced); launches per batched "
       "step at S = 1, 3 and 8")
def time_sweep(times) -> dict:
    from torch.profiler import ProfilerActivity, profile

    engines = FLEET["sweep"].engines
    p = engines[0].params
    kernels_ = path_kernels(p)
    per_step = {}
    for size in (1, 3, 8):
        ws_, window, iteration = batch_steps(engines[:size])
        for _ in range(5):
            window(True)
            iteration()
        torch.cuda.synchronize()
        for _attempt in range(3):  # a window may record no step at all
            kernels.reset_launches()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(20):
                    window(True)
                    iteration()
                torch.cuda.synchronize()
            # the device launches (kernels and the exchange's memsets) by
            # name, per launch of C, which runs once a step: the profiler
            # may drop whole steps at the edges of its window
            device = {}
            for ev in prof.key_averages():
                part = kernel_name(ev.key)
                if part in WRAPPER_OF:
                    device[part] = device.get(part, 0) + ev.count
            steps = device.get("queue_min_kernel", 0)
            if steps:
                break
            log(f"S = {size}: the profiler recorded no step; profiling "
                "20 more")
        else:
            raise AssertionError("the profiler recorded no step")
        per_step[size] = {
            "wrappers": {k: getattr(kernels, k).launches / 20
                         for k in kernels_},
            "device": {part: round(n / steps) for part, n in device.items()},
            "steps_profiled": steps}
        log(f"launches per batched step at S = {size}: {per_step[size]}")
    if len({json.dumps({k: v for k, v in x.items() if k != "steps_profiled"},
                       sort_keys=True) for x in per_step.values()}) != 1:
        raise AssertionError(f"launches per step grew with S: {per_step}")
    smi = smi_line()
    out = {"per_step": per_step, "cells": {}}
    for cell, (engines, warm, single) in sweep_cells().items():
        p = engines[0].params
        prof_ms, step_ms = {1: [], 8: []}, {1: [], 8: []}
        for size in (1, 8, 8, 1):
            ws_, window, iteration = batch_steps(engines[:size])
            for _ in range(warm):  # into the steady state
                window(True)
                iteration()
            step_ms[size].append(loop_step_ms(window, iteration, ws_, 2))
            prof = profile_steps(window, iteration, 40, p,
                                 f"sweep {cell}, S = {size}")
            if not prof:
                raise AssertionError("the profiler recorded no device time")
            prof_ms[size].append(prof)
        res = {"step_ms": {n: float(np.mean(v)) for n, v in step_ms.items()},
               "kernels": {}}
        for k in path_kernels(p):
            one = times[single][k]["bytes"]
            row = res["kernels"][k] = {
                f"s{n}_ms": float(np.mean([pm[k] for pm in prof_ms[n]]))
                for n in (1, 8)}
            row["bound_s1_ms"] = one / HBM_BYTES_PER_S * 1e3
            row["bound_s8_ms"] = 8 * row["bound_s1_ms"]
            log(f"sweep {cell} {k}: device {row['s8_ms'] * 1e3:.3f} us per "
                f"batched launch at S = 8, {row['s1_ms'] * 1e3:.3f} at S = 1 "
                f"(profiler, 40 live steps, 2 runs each); bound "
                f"{row['bound_s8_ms'] * 1e3:.3f} / "
                f"{row['bound_s1_ms'] * 1e3:.3f} us (8 x / 1 x {one} B / "
                f"3.35 TB/s) ({smi})")
        log(f"sweep {cell} step: {res['step_ms'][8] * 1e3:.3f} us at S = 8, "
            f"{res['step_ms'][1] * 1e3:.3f} us at S = 1 (CUDA events, 64 "
            f"live steps, 2 runs each) ({smi})")
        out["cells"][cell] = res
    return out


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in kernels.WRAPPERS}


@phase("main paths at full width, device mode")
def main_path():
    totals = {}
    rates = {}
    per_path = {}
    drawing = 0  # launches of A on paths whose A runs the threefry draw
    for name, (cfg_fn, log_cap, check_fn, sim_s) in MAIN_PATHS.items():
        eng = GpuEngine(cfg_fn(), log_capacity=log_cap)
        if eng.params.pcap_any:  # the capture files' writer, timed
            def timed(*a, write=eng._write_pcaps, eng=eng):
                t0 = time.perf_counter()
                write(*a)
                eng.pcap_write_s = time.perf_counter() - t0
            eng._write_pcaps = timed
        if eng.params.flowtrace:  # the ring's readback and decode, timed
            def decode(*a, collect=eng._flowtrace_collect, eng=eng):
                t0 = time.perf_counter()
                out = collect(*a)
                eng.flow_decode_s = time.perf_counter() - t0
                return out
            eng._flowtrace_collect = decode
        kernels.reset_launches()
        t0 = time.perf_counter()
        res = eng.run(mode="device")
        total = time.perf_counter() - t0
        counts = launch_counts()
        per_path[name] = counts
        log(f"{name}: {res.counters}, rounds {res.rounds}, "
            f"{res.sim_seconds_per_wall_second:.3f} sim-s/wall-s (loop "
            f"{res.wall_seconds:.3f} s, with set-up and collect {total:.3f} "
            f"s); launches {counts}; nvidia-smi: {smi_line()}")
        rates[name] = res.sim_seconds_per_wall_second
        check_fn(res, sim_s, log_cap, eng)
        for k in path_kernels(eng.params):
            if counts[k] <= 0:
                raise AssertionError(f"{name}: {k} was not launched")
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v
        if eng.params.draws:
            drawing += counts["lane_slots"]
    log(f"launches over the main paths: {totals}; of A, {drawing} on paths "
        f"that draw")
    return totals, rates, drawing, per_path


# ---- the command line on the card ----------------------------------------

# ``python -m shadow_tpu_torch`` in a child process: the child runs the
# package's __main__ through runpy (what ``-m`` does) and, when the command
# returns, writes its wrappers' launch counts (zero at its start) to the
# file CLI_LAUNCHES names
CLI_CHILD = """\
import json, os, runpy, sys
from shadow_tpu_torch.backend import kernels
kernels.reset_launches()
code = 0
try:
    runpy.run_module("shadow_tpu_torch", run_name="__main__", alter_sys=True)
except SystemExit as e:
    code = e.code if isinstance(e.code, int) else 1
finally:
    with open(os.environ["CLI_LAUNCHES"], "w") as f:
        json.dump({fn.__name__: fn.launches for fn in kernels.WRAPPERS}, f)
sys.exit(code)
"""
# the rows of PHOLD 10k's event log in 1 sim s: each of its 40,000
# messages hops 199 times (796 deliveries a host, measured at 200 hosts)
PHOLD_1S_LOG = 9_000_000
CLI_PROCS: list = []  # every child started; the phase kills what is left
PHOLD_CLI: dict = {}  # (d): its config document and its started child


def start_phold_cli() -> None:
    """(d), PHOLD 10k for 1 sim s run twice by ``--determinism-check``: its
    two 7,960,000-row logs are built and compared on the host for one to
    two minutes, so it starts once the kernels are built and runs beside
    the kernel checks, which time nothing; the run waits for it before the
    first timing phase, and the command-line phase reads it."""
    doc = phold_doc(stop_time="1s")
    doc["general"]["data_directory"] = str(Path(DATA) / "cli-phold")
    doc["experimental"] = {"network_backend": "tpu",
                           "tpu_log_capacity": PHOLD_1S_LOG}
    PHOLD_CLI["doc"] = doc
    PHOLD_CLI["run"] = cli_start("phold", [config_file("phold", doc),
                                           "--determinism-check"])


def cli_start(tag: str, args: list, stdin: str = "") -> tuple:
    """Start the command line with ``args`` in a child process, its output
    into files (children that run side by side never wait on a pipe);
    ``cli_wait`` finishes it."""
    base = Path(DATA) / f"cli-{tag}"
    with open(f"{base}.out", "w") as out, open(f"{base}.err", "w") as err:
        child = subprocess.Popen(
            [sys.executable, "-c", CLI_CHILD, *args], stdin=subprocess.PIPE,
            stdout=out, stderr=err, text=True, cwd=ROOT,
            env={**os.environ, "CLI_LAUNCHES": f"{base}.json"})
    CLI_PROCS.append(child)
    try:
        child.stdin.write(stdin)
        child.stdin.close()
    except BrokenPipeError:  # the child ended first: cli_wait reports it
        pass
    return tag, child, base, time.perf_counter()


def cli_wait(started: tuple) -> tuple:
    """The finished process, its launch counts and its wall seconds."""
    tag, child, base, t0 = started
    child.wait(timeout=900)
    wall = time.perf_counter() - t0
    proc = subprocess.CompletedProcess(
        child.args, child.returncode, Path(f"{base}.out").read_text(),
        Path(f"{base}.err").read_text())
    for line in proc.stderr.splitlines()[-6:]:
        log(f"  cli {tag} stderr: {line}")
    if proc.returncode != 0:
        raise AssertionError(f"cli {tag}: exit {proc.returncode}")
    return proc, json.loads(Path(f"{base}.json").read_text()), wall


def cli(tag: str, args: list, stdin: str = "") -> tuple:
    return cli_wait(cli_start(tag, args, stdin))


def config_file(tag: str, doc: dict) -> str:
    """``doc`` as a config file, in YAML's JSON (flow) form."""
    path = Path(DATA) / f"{tag}.yaml"
    path.write_text(json.dumps(doc, indent=1) + "\n")
    return str(path)


def mesh_doc(n: int, sim_s: int, mixed: bool = False,
             log_cap: int | None = None) -> dict:
    """``flagship_mesh_config(n)`` (``mixed``: ``mixed_flagship_config(n)``)
    as the YAML document the preset builds, held equal to the preset's
    config; ``log_cap``: ``experimental.tpu_log_capacity``."""
    k = n // 100 if mixed else 0
    want = (presets.mixed_flagship_config(n, sim_seconds=sim_s) if mixed
            else flagship_mesh_config(n, sim_seconds=sim_s))
    exp = {"network_backend": "tpu"}
    if mixed:
        exp.update(tpu_lane_queue_capacity=16, tpu_events_per_round=2,
                   tpu_cross_capacity=8, tpu_stream_events_per_round=16)
    if log_cap is not None:
        exp["tpu_log_capacity"] = log_cap
        want.experimental.tpu_log_capacity = log_cap
    hosts = {"peer": {"count": n - 2 * k, "network_node_id": 0, "processes": [{
        "path": "tgen-mesh", "args": "--interval 10ms --size 1428",
        "start_time": "0 s"}]}}
    for i in range(k):
        hosts[f"sc{i:05d}"] = {"network_node_id": 0, "processes": [{
            "path": "stream-client",
            "args": f"--server ss{i:05d} --size 2000000",
            "start_time": "0 s"}]}
        hosts[f"ss{i:05d}"] = {"network_node_id": 0, "processes": [{
            "path": "stream-server", "start_time": "0 s"}]}
    doc = {"general": {"stop_time": f"{sim_s} s", "seed": 1},
           "network": {"graph": {"type": "gml",
                                 "inline": want.network.graph.inline}},
           "experimental": exp, "hosts": hosts}
    if ConfigOptions.from_dict(doc) != want:
        raise AssertionError(f"mesh_doc({n}, mixed={mixed}) != the preset")
    return doc


def window_aggs(text: str) -> list:
    return [ln for ln in text.splitlines() if ln.startswith("[window-agg]")]


def hybrid_agg_ints(text: str) -> list:
    """The ``[hybrid-agg]`` lines' fields but the two wall-time ones."""
    return [[f for f in ln.split()[1:]
             if not f.startswith(("device_sync_ns=", "syscall_service_ns="))]
            for ln in text.splitlines() if ln.startswith("[hybrid-agg]")]


def stats_of(doc: dict) -> dict:
    return json.loads((Path(doc["general"]["data_directory"])
                       / "sim-stats.json").read_text())


def cli_kernels(tag: str, counts: dict, p: lanes.LaneParams) -> None:
    for k in path_kernels(p):
        if counts.get(k, 0) <= 0:
            raise AssertionError(f"cli {tag}: {k} was not launched")


def flagship_seam_rates(reps: int = 3) -> dict:
    """The flagship (bench tuning, 10 sim s, no log) in device mode, in
    step mode, and in step mode with perf logging (its lines into a file):
    sim-s/wall-s of the loop, the three in turns, ``reps`` times."""
    modes = {"device": ("device", False), "step": ("step", False),
             "step + perf logging": ("step", True)}
    engines = {m: GpuEngine(flagship(sim_seconds=10), log_capacity=0)
               for m in modes}
    rates = {m: [] for m in modes}
    for _ in range(reps):
        for m, (mode, perf) in modes.items():
            eng = engines[m]
            sink = None
            if perf:
                sink = open(Path(DATA) / "perf-lines.log", "w")
                eng.perf_log = PerfLog(out=sink)
            res = eng.run(mode=mode)
            if sink is not None:
                sink.close()
                lines = (Path(DATA) / "perf-lines.log").read_text()
                if len(window_aggs(lines)) != res.rounds:
                    raise AssertionError("a [window-agg] line per round")
            check_flagship(res, 10, 0)
            rates[m].append(res.sim_seconds_per_wall_second)
    return rates


@phase("the command line on the card: python -m shadow_tpu_torch on the "
       "tiered mixed mesh 10k (device mode, netobs, event log) = the "
       "in-process run; the flagship 10k with perf logging and a scripted "
       "run-control console; the 100-host flagship's [window-agg] lines "
       "card = CPU; PHOLD 10k --determinism-check; the congested managed "
       "config's [hybrid-agg] lines card = CPU")
def cli_phase() -> dict:
    from shadow_tpu_torch.obs import netobs as nom

    out = {"launches": {}, "rates": {}}
    torch.cuda.empty_cache()  # the earlier phases' cached blocks: the
    # command's own process allocates beside this one

    def tally(counts: dict) -> None:
        for k, v in counts.items():
            out["launches"][k] = out["launches"].get(k, 0) + v

    # (a) the tiered main path, device mode, netobs and the event log
    doc = mesh_doc(N_FLAG, 1, mixed=True, log_cap=planes_log_capacity())
    doc["general"]["data_directory"] = str(Path(DATA) / "cli-mixed")
    proc, counts, wall = cli("mixed", [config_file("mixed", doc), "--netobs",
                                       "--event-log"])
    tally(counts)
    stats = stats_of(doc)
    cfg = ConfigOptions.from_dict(doc)
    cfg.experimental.netobs = True
    eng = GpuEngine(cfg)
    cli_kernels("mixed", counts, eng.params)
    res = eng.run(mode="device")
    if stats["counters"] != dict(sorted(res.counters.items())):
        raise AssertionError(f"sim-stats counters {stats['counters']} != "
                             f"in-process {res.counters}")
    if stats["rounds"] != res.rounds:
        raise AssertionError("rounds differ")
    data = Path(doc["general"]["data_directory"])
    with open(data / "event-log.tsv") as f:
        next(f)
        rows = [tuple(map(int, ln.split("\t"))) for ln in f]
    if rows != res.log_tuples():
        raise AssertionError("event-log.tsv != the in-process event log")
    netobs_doc = json.loads((data / "NETOBS_tpu-seed1.json").read_text())
    want = nom.totals(eng.netobs_snapshot()["arrays"])
    if netobs_doc["totals"] != want:
        raise AssertionError(f"NETOBS totals {netobs_doc['totals']} != {want}")
    rates = [res.sim_seconds_per_wall_second]
    for _ in range(2):
        rates.append(eng.run(mode="device").sim_seconds_per_wall_second)
    out["rates"]["mixed mesh 10k tiered 1 s, device mode: the command line"] = [
        stats["sim_seconds_per_wall_second"]]
    out["rates"]["mixed mesh 10k tiered 1 s, device mode: in process"] = rates
    log(f"cli mixed: {len(rows)} log rows, counters {stats['counters']}, "
        f"NETOBS totals equal, command {wall:.1f} s, launches {counts}")

    # the price of the per-window seam, in process, while nothing else runs
    out["rates"].update({f"flagship 10k 10 s, {m}": r
                         for m, r in flagship_seam_rates().items()})

    # (b) the flagship in the step driver, perf logging and a scripted
    # console: two pauses, a [window-agg] line a round, the closed form;
    # (c)'s two commands start beside it (none of the three times anything)
    doc = mesh_doc(N_FLAG, 1, log_cap=0)
    doc["general"]["data_directory"] = str(Path(DATA) / "cli-flagship")
    flagship_run = cli_start(
        "flagship", [config_file("flagship", doc), "--perf-logging",
                     "--run-control"], stdin="n\nn\nstats\nc\n")
    doc100 = mesh_doc(100, 1)
    started = {}
    for dev in ("cuda", "cpu"):
        doc100["general"]["data_directory"] = str(Path(DATA)
                                                  / f"cli-100-{dev}")
        started[dev] = cli_start(
            f"100-{dev}", [config_file(f"flagship100-{dev}", doc100),
                           "--perf-logging", "--run-control", "--device", dev])
    proc, counts, wall = cli_wait(flagship_run)
    tally(counts)
    stats = stats_of(doc)
    pauses = proc.stderr.count("[run-control] paused at window boundary")
    aggs = window_aggs(proc.stderr)
    exp = expected_mesh(N_FLAG, 1)
    got = {k: stats["counters"].get(k, 0) for k in exp}
    if pauses != 2 or len(aggs) != stats["rounds"] or got != exp:
        raise AssertionError(f"cli flagship: {pauses} pauses, {len(aggs)} "
                             f"[window-agg] lines for {stats['rounds']} "
                             f"rounds, counters {got} != {exp}")
    cli_kernels("flagship", counts,
                GpuEngine(ConfigOptions.from_dict(doc)).params)
    log(f"cli flagship: 2 pauses, {len(aggs)} [window-agg] lines = rounds, "
        f"closed form, command {wall:.1f} s, launches {counts}")

    # (c) the 100-host flagship: the card's lines = the CPU's, byte for byte
    lines = {}
    for dev in ("cuda", "cpu"):
        proc, counts, wall = cli_wait(started[dev])
        if dev == "cuda":
            tally(counts)
            cli_kernels("100-cuda", counts,
                        GpuEngine(ConfigOptions.from_dict(doc100)).params)
        lines[dev] = window_aggs(proc.stderr)
    if lines["cuda"] != lines["cpu"] or not lines["cuda"]:
        raise AssertionError("100-host flagship: [window-agg] card != CPU")
    log(f"cli flagship 100: {len(lines['cuda'])} [window-agg] lines, card = "
        "CPU byte for byte")

    # (e) a managed config on the hybrid path: the congested config at the
    # reference's defaults (the fused law, a syscall worker per core) with
    # perf logging; the card's [hybrid-agg] lines = --device cpu's but
    # their wall-time fields, and the hybrid kernels launched
    aggs, started = {}, {}
    for dev in ("cuda", "cpu"):
        cfg_path = Path(DATA) / f"congested-cli-{dev}.yaml"
        cfg_path.write_text(congested_yaml(Path(DATA) / f"cli-congested-{dev}",
                                           FUSE_K))
        started[dev] = cli_start(f"congested-{dev}", [
            str(cfg_path), "--perf-logging", "--device", dev])
    for dev in ("cuda", "cpu"):
        proc, counts, wall = cli_wait(started[dev])
        aggs[dev] = hybrid_agg_ints(proc.stderr)
        if dev == "cuda":
            tally(counts)
            for k in ("lane_slots", "hybrid_fused_window", "append_log",
                      "inject_merge"):
                if counts.get(k, 0) <= 0:
                    raise AssertionError(f"cli congested: {k} was not "
                                         "launched")
            log(f"cli congested: command {wall:.1f} s, launches {counts}")
    if aggs["cuda"] != aggs["cpu"] or not aggs["cuda"]:
        raise AssertionError("cli congested: [hybrid-agg] card != CPU")
    log(f"cli congested: {len(aggs['cuda'])} [hybrid-agg] lines, card = CPU "
        "but the wall-time fields")

    # (d), started after the build (``start_phold_cli``)
    proc, counts, _wall = cli_wait(PHOLD_CLI["run"])
    tally(counts)
    if "determinism check PASSED" not in proc.stderr:
        raise AssertionError("PHOLD 10k: no PASSED line")
    cli_kernels("phold", counts,
                GpuEngine(ConfigOptions.from_dict(PHOLD_CLI["doc"])).params)
    log(f"cli phold: determinism check PASSED, command "
        f"{PHOLD_CLI['wall']:.1f} s or less, launches {counts}")
    for name, r in out["rates"].items():
        log(f"cli rates, {name}: {r}")
    return out


def main() -> int:
    global DATA
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    DATA = tempfile.mkdtemp(prefix="chip_smoke_")
    log(f"device: {torch.cuda.get_device_name(0)}, count "
        f"{torch.cuda.device_count()}, torch {torch.__version__}, cuda "
        f"{torch.version.cuda}")
    log(f"nvidia-smi: {smi_line()}")
    start_cpu_refs(cpu_jobs())
    t0 = time.perf_counter()
    try:
        lib = kernels.build()
    except Exception:
        traceback.print_exc()
        return 1
    log(f"kernel build: {time.perf_counter() - t0:.2f} s -> {lib.name}")
    # the compiler's report per kernel: function name, then its registers
    ptxas = [line.strip() for line in
             lib.with_suffix(".log").read_text().splitlines()
             if "Compiling entry" in line or "registers" in line
             or "spill" in line or "error" in line]
    for line in ptxas:
        log(f"  ptxas: {line}")

    native_build()
    # the hybrid parity's CPU runs need the native build; the command
    # line's (d) needs the kernels
    submit_cpu_refs([(hybrid_oracle_run,)]
                    + [(hybrid_parity_run, *run) for run in HYB_PARITY_RUNS
                       if run[1] == "cpu"])
    start_phold_cli()
    check_kernels()
    check_rand_u32()
    check_active_kernels()
    check_stream_kernels()
    check_tier_kernels()
    check_plane_kernels()
    check_flow_kernels()
    check_sweep_kernels()
    check_hybrid_kernels()
    check_fused_kernels()
    check_merge_cases()
    check_compact_cases()
    check_slot_cases()
    check_row_cases()
    drain_cpu_refs()
    PHOLD_CLI["run"][1].wait(timeout=900)
    PHOLD_CLI["wall"] = time.perf_counter() - PHOLD_CLI["run"][3]
    log(f"command line (d) done, {PHOLD_CLI['wall']:.1f} s after its start")
    times = time_all()
    parity()
    stream_parity()
    stream_tcp_example()
    full_width_parity()
    plane_parity()
    flow_parity()
    wide_rows()
    fault_parity()
    hyb_eng = hybrid_parity()
    hybrid_congested()
    hyb_times = time_hybrid(hyb_eng) if hyb_eng is not None else None
    sweeps = sweep_parity()
    sweep_times = time_sweep(times) if sweeps else None
    main_out = main_path()
    hyb = hybrid_main()
    cli_out = cli_phase()
    if FAILED:
        log(f"FAILED phases: {FAILED}")
        return 1
    launches, rates, drawing, per_path = main_out
    # the sweeps' launches and the hybrid flagship's count to the main paths'
    for batch in sweeps.values():
        for k, v in batch["launches"].items():
            launches[k] = launches.get(k, 0) + v
    for run in hyb.values():
        for k, v in run["counts"].items():
            launches[k] = launches.get(k, 0) + v
    # and the command line's runs on the card
    for k, v in cli_out["launches"].items():
        launches[k] = launches.get(k, 0) + v
    smi = smi_line()
    for line in ptxas:  # again here: the start of a long output is cut
        log(f"ptxas: {line}")
    for name, rate in rates.items():
        log(f"sim-s/wall-s, {name}: {rate:.3f} ({smi})")
    for name, runs in cli_out["rates"].items():
        log(f"sim-s/wall-s, {name}: "
            + ", ".join(f"{r:.3f}" for r in runs) + f" ({smi})")
    for cfg_name in ("mixed_tiered", "mixed_tiered_netobs", "mixed_tiered_log",
                     "mixed_tiered_pcap", "mixed", "mixed_flowtrace",
                     "flagship", "flagship_log", "phold", "lossy"):
        for name, t in times[cfg_name].items():
            if name == "loop":
                log(f"device busy, {cfg_name}: {t['busy']:.4f} of "
                    f"{t['step_ms'] * 1e3:.3f} us/step ({smi})")
                continue
            lib = t.get("library_ms")
            log(f"device us/launch, {cfg_name} {name}: {t['ms'] * 1e3:.3f} "
                f"(bound {t['bound_ms'] * 1e3:.3f}, plain "
                f"{t['plain_ms'] * 1e3:.1f}"
                + (f", library {lib * 1e3:.3f} ({t['library_by']})" if lib
                   else "") + f") ({smi})")
    for label, parts in SPLITS.items():
        for name, split in parts.items():
            log(f"split, {label} {name}: " + ", ".join(
                f"{part} {us:.3f}" for part, us in split.items())
                + f" us/step ({smi})")
    for name, batch in sweeps.items():
        log(f"sweep {name}: S = {batch['size']}, batch loop "
            f"{batch['batch_wall_s']:.4f} s, {batch['size']} serial loops "
            f"{batch['serial_wall_s']:.4f} s, scenarios/hour "
            f"{batch['scenarios_per_hour']:.1f} ({smi})")
    for cell, res in sweep_times["cells"].items():
        for name, t in res["kernels"].items():
            log(f"device us/batched launch, {cell} {name}: S = 8 "
                f"{t['s8_ms'] * 1e3:.3f} (bound {t['bound_s8_ms'] * 1e3:.3f}),"
                f" S = 1 {t['s1_ms'] * 1e3:.3f} (bound "
                f"{t['bound_s1_ms'] * 1e3:.3f}) ({smi})")
        log(f"batched step, {cell}: S = 8 {res['step_ms'][8] * 1e3:.3f} us, "
            f"S = 1 {res['step_ms'][1] * 1e3:.3f} us ({smi})")
    log(f"launches per batched step (fleet): {sweep_times['per_step']}")
    for law, run in hyb.items():
        st, res = run["sync"], run["result"]
        log(f"hybrid flagship, {law} law ({HYB_CHAINS} chains, 1,000 peers, "
            f"{HYB_SIM_S} sim s, {run['workers']} workers, start-up "
            f"{run['startup_s']:.3f} s): "
            f"{run['rate']:.4f} sim-s/wall-s (loop {res.wall_seconds:.3f} s: "
            f"device_sync_s {st['device_sync_s']:.3f}, syscall_service_s "
            f"{st['syscall_service_s']:.3f}); device_turns "
            f"{st['device_turns']} (PR 8: 3,936), fused_dispatches "
            f"{st['fused_dispatches']}, fused_windows {st['fused_windows']}, "
            f"turns_saved {st['turns_saved']}, fuse_rollbacks "
            f"{st['fuse_rollbacks']}, async hits / misses "
            f"{st['async_dispatch_hits']} / {st['async_dispatch_misses']}, "
            f"inject_blocks {st['inject_blocks']}, egress_reads "
            f"{st['egress_reads']}; rounds {res.rounds}, clean exits "
            f"{res.counters.get('managed_exit_clean')}, managed TCP bytes "
            f"{res.counters.get('managed_tcp_tx_bytes')} / "
            f"{res.counters.get('managed_tcp_rx_bytes')}, tgen_recv_bytes "
            f"{res.counters.get('tgen_recv_bytes')} ({smi})")
    for name, t in hyb_times.items():
        wrapper = name.split(":")[0]
        law = "one-window" if wrapper == "hybrid_window" else "fused"
        lib = t.get("library_ms")
        log(f"device us/launch, hybrid {name}: {t['ms'] * 1e3:.3f} (bound "
            f"{t['bound_ms'] * 1e3:.3f}, plain {t['plain_ms'] * 1e3:.1f}"
            + (f", library {lib * 1e3:.3f} ({t['library_by']})" if lib
               else "") + "); "
            f"launches on the {law} flagship {hyb[law]['counts'][wrapper]} "
            f"({smi})")
    log(f"device us/launch, rand_u32 ({times['rand_u32']['draws']} draws): "
        f"{times['rand_u32']['ms'] * 1e3:.3f} (bound "
        f"{times['rand_u32']['bound_ms'] * 1e3:.3f}, "
        f"{times['rand_u32']['bound_by']}) ({smi})")
    # A, B, C, F and G at this slice's main path, the tiered mixed mesh; E
    # at the untiered mixed mesh; D where a main path logs (the flagship,
    # 1 s); the other paths' times are on the lines above
    source = {"lane_slots": "mixed_tiered", "exchange_merge": "mixed_tiered",
              "stream_rows_merge": "mixed", "stream_tier": "mixed_tiered",
              "tier_merge": "mixed_tiered", "queue_min_window": "mixed_tiered",
              "append_log": "flagship_log"}
    replaces = {
        "lane_slots": "shadow_tpu/backend/lanes.py:2900",
        "exchange_merge": "shadow_tpu/backend/lanes.py:1581",
        "stream_rows_merge": "shadow_tpu/backend/lanes.py:1924",
        "stream_tier": "shadow_tpu/backend/lanes.py:2300",
        "tier_merge": "shadow_tpu/backend/lanes.py:2682",
        "queue_min_window": "shadow_tpu/backend/lanes.py:2260",
        "append_log": "shadow_tpu/backend/lanes.py:2056",
        "rand_u32": "shadow_tpu/core/rng.py:46",
    }
    rows = []
    for name, rep_ in replaces.items():
        t = times[source[name]][name] if name in source else times[name]
        row = {
            "name": name, "route": "cuda",
            "source": "shadow_tpu_torch/csrc/lanes.cu", "replaces": rep_,
            "launches": launches[name], "max_abs_err": MAX_ERR[name],
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t.get("library_ms"),
            "library_by": t.get("library_by"),
        }
        if name == "lane_slots":
            # the threefry draw and the lane-TCP law run fused in A
            row["fused"] = "rand_u32"
            row["launches_that_draw"] = drawing
            row["stream_law"] = "shadow_tpu/backend/lanes_stream.py:604"
        if name == "stream_tier":
            # the tier's state, and the same lane-TCP law (device functions
            # shared with A)
            row["state"] = "shadow_tpu/backend/lanes_stream.py:907"
        # the same kernel with the observation planes on and off, on the
        # tiered mixed mesh's states in one call: without a log (netobs
        # alone), and with one (off, then netobs and pcap)
        row["planes"] = {
            plane: {"ms": times[key][name]["ms"],
                    "bound_ms": times[key][name]["bound_ms"]}
            for plane, key in (("off", "mixed_tiered"),
                               ("netobs", "mixed_tiered_netobs"),
                               ("log", "mixed_tiered_log"),
                               ("log_netobs_pcap", "mixed_tiered_pcap"))
            if name in times[key]}
        # flowtrace, on the untiered mixed mesh's states in one call: off,
        # then every flow traced (D runs there for the ring alone), with
        # the launches of the traced main path
        for plane, key in (("untiered", "mixed"),
                           ("flowtrace", "mixed_flowtrace")):
            if name in times[key]:
                row["planes"][plane] = {
                    "ms": times[key][name]["ms"],
                    "bound_ms": times[key][name]["bound_ms"]}
        if "flowtrace" in row["planes"]:
            row["planes"]["flowtrace"]["launches"] = per_path[FLOW_MAIN][name]
        # the batched cells (8 x 10k hosts): device time per batched launch
        # over 8 scenarios and over 1, beside 8 and 1 times the bound
        row["sweep"] = {cell: res["kernels"][name]
                        for cell, res in sweep_times["cells"].items()
                        if name in res["kernels"]}
        if name == "rand_u32":
            # the launcher runs on no main path: its own launches in the
            # phase that timed it
            row["launches"] = t["launches"]
            row["launches_from"] = "timing phase"
        rows.append(row)
    # the hybrid path's kernel H, C's hybrid mode, and the new instances of
    # A (its external arm) and D (its egress instance), timed on the hybrid
    # flagship's state, with their launches on its main path
    hyb_replaces = {
        "inject_merge": "shadow_tpu/backend/lanes.py:3583",
        "hybrid_window": "shadow_tpu/backend/lanes.py:3647",
        "hybrid_fused_window": "shadow_tpu/backend/lanes.py:3781",
        "lane_slots:external": "shadow_tpu/backend/lanes.py:944",
        "append_log:egress": "shadow_tpu/backend/lanes.py:2219",
    }
    for name, rep_ in hyb_replaces.items():
        t = hyb_times[name]
        law = "one-window" if name == "hybrid_window" else "fused"
        rows.append({
            "name": name, "route": "cuda",
            "source": "shadow_tpu_torch/csrc/lanes.cu", "replaces": rep_,
            "launches": hyb[law]["counts"][name.split(":")[0]],
            "launches_from": f"the hybrid flagship, {law} law",
            "max_abs_err": MAX_ERR[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t.get("library_ms"),
            "library_by": t.get("library_by"),
        })
    print(json.dumps({"kernels": rows}))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        code = main()
    finally:
        stop_cpu_refs()
        for child in CLI_PROCS:  # a child a failed phase left running
            if child.poll() is None:
                child.kill()
                child.wait()
        if DATA is not None:
            shutil.rmtree(DATA, ignore_errors=True)
    sys.exit(code)
