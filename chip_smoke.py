"""Drive the PyTorch/CUDA port on one NVIDIA card and hold it to account.

    python3 chip_smoke.py

Phases, in order (any failure exits nonzero and prints no result line):

1. the card's name and power limit (``nvidia-smi``);
2. build the lane kernels from ``shadow_tpu_torch/csrc`` (``nvcc``);
3. each kernel against its plain PyTorch version on the card, at the
   flagship shapes (N=10,000 hosts, C=16, K=2, Cx=8), on seeded valid
   states with NEVER holes, overflow past C and past Cx, CoDel drops and
   bucket waits — exact equality;
4. per-kernel times (CUDA events) on a mid-run flagship state, beside the
   plain version's time and the byte bound at 3.35 TB/s;
5. parity: step and device mode, on the card and on the CPU, on a 256-host
   tgen mesh with logging, a CoDel bottleneck and a non-strict overflow —
   equal event logs, counters and final states, word for word;
6. the main path, launch counts reset just before and read just after:
   ``flagship_mesh_config(10000)`` with the bench tuning (C=16, K=2,
   Cx=8, strict), 1 sim s with logging and 10 sim s without, device mode;
   counters held to the mesh's closed form; every kernel launched.

The last lines are the ``kernels`` JSON line, the ``nvidia-smi`` line and
the result line.  Imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
import traceback

import numpy as np
import torch

if not torch.cuda.is_available():
    print("chip_smoke: no CUDA device", file=sys.stderr)
    sys.exit(1)

from shadow_tpu_torch.backend import kernels, lanes  # noqa: E402
from shadow_tpu_torch.backend.gpu_engine import GpuEngine  # noqa: E402
from shadow_tpu_torch.config.options import ConfigOptions  # noqa: E402
from shadow_tpu_torch.config.presets import flagship_mesh_config  # noqa: E402
from shadow_tpu_torch.net.token_bucket import bucket_params  # noqa: E402

DEV = torch.device("cuda")
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
N_FLAG, C_FLAG, K_FLAG, CX_FLAG = 10_000, 16, 2, 8
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


def flagship(sim_seconds=10):
    cfg = flagship_mesh_config(N_FLAG, sim_seconds=sim_seconds,
                               queue_capacity=C_FLAG, pops_per_round=K_FLAG)
    cfg.experimental.tpu_cross_capacity = CX_FLAG
    return cfg


def clone(nt):
    return type(nt)(*[t.clone() for t in nt])


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
    arm = rng.random((n, k)) < 0.5
    t_arm = T0 + rng.integers(10_000_000, 50_000_000, (n, k))
    lane = np.arange(n)[:, None]
    self_blk = np.stack([
        np.where(arm, t_arm >> 31, lanes.NEVER32),
        np.where(arm, t_arm & lanes.MASK31, lanes.NEVER32),
        np.broadcast_to((lanes.LOCAL << lanes.AUX_KIND_SHIFT)
                        | (lane << lanes.AUX_SRC_SHIFT), (n, k)),
        rng.integers(0, 1 << 20, (n, k)),
        np.zeros((n, k)),
    ])
    ws.self_blk.copy_(torch.as_tensor(self_blk.astype(np.int32), device=DEV))


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
        # the exchange scratch (x_*) is the kernel's own working memory
        out.append({**s._asdict(), **{f: t for f, t in ws._asdict().items()
                                      if not f.startswith("x_")}})
    return out


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
                lambda p_, tb_, s, ws: lanes.exchange_merge_plain(p_, s, ws))
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


def kernel_bytes(p: lanes.LaneParams, s, ws, n_valid_recs: int) -> dict:
    """Bytes each kernel must move at these inputs: every input read once,
    every output written once."""
    n, c, k, cx = p.n_lanes, p.capacity, p.pops_per_iter, p.cross_cap
    g = 1
    n_rec = ws.rec_valid.numel() if p.log_capacity else 0
    state_vec = 23 * 4 + 1  # lane_slots' [N] state words (+ the bool)
    tables = 16 * 4  # [N] table words read per lane
    a_in = n * (k * 5 * 4 + state_vec + tables) + g * g * 4 + 1025 * 4
    a_out = n * (k * 2 * 4 + state_vec) + (5 + 6) * n * k * 4
    if p.log_capacity:
        a_out += k * n * (6 * 8 + 4)
    b_in = n * c * 5 * 4 + 5 * n * k * 4 + k * n * 4 + n * 4
    b_in += int(ws.x_cnt.clamp(max=cx).sum()) * 5 * 4  # selected cross entries
    b_out = n * c * 5 * 4 + n * 4
    if p.log_capacity:
        b_out += n * (k + cx) * (6 * 8 + 4)
    c_io = n * 8 + 4 * 4 + 6 * 4
    d_in = n_rec * 4 + n_valid_recs * 6 * 8
    d_out = n_valid_recs * 6 * 8 + 8
    return {
        "lane_slots": a_in + a_out, "exchange_merge": b_in + b_out,
        "queue_min_window": c_io, "append_log": d_in + d_out,
    }


# device kernels of each wrapper, as CUPTI names them (substring match);
# the exchange's two scratch memsets count to it as well
KERNEL_PARTS = {
    "lane_slots": ("lane_slots_kernel",),
    "exchange_merge": ("x_count_kernel", "x_scan_kernel", "x_place_kernel",
                       "merge_kernel", "Memset"),
    "queue_min_window": ("queue_min_kernel",),
    "append_log": ("append_log_kernel",),
}


def profile_steps(window, iteration, steps: int) -> dict:
    """Device time per step of each wrapper's kernels, from the profiler's
    CUDA activity over ``steps`` live steps of the device loop; {} when the
    profiler records no device time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            window(True)
            iteration()
        torch.cuda.synchronize()
    totals = {name: 0.0 for name in KERNEL_PARTS}
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", None)
        if us is None:
            us = getattr(ev, "cuda_time_total", 0.0)
        for name, parts in KERNEL_PARTS.items():
            if any(part in ev.key for part in parts):
                totals[name] += us
                log(f"  device {us / steps:9.3f} us/step in {ev.count:5d} "
                    f"launches: {ev.key[:70]}")
    if not all(totals.values()):
        log(f"profiler device times incomplete: {totals}")
        return {}
    return {name: us / 1e3 / steps for name, us in totals.items()}


@phase("per-kernel times on a mid-run flagship state")
def time_kernels():
    eng = GpuEngine(flagship(sim_seconds=1), log_capacity=1_200_000)
    p, tb = eng.params, eng.tables
    s = eng.initial_state()
    ws_, window, iteration = lanes._build_iteration(p, tb, s)
    for _ in range(20):  # into the steady mesh: 0.2 sim s
        window(True)
        iteration()
    prof_ms = profile_steps(window, iteration, 40)  # 40 live steps
    window(True)  # the next window, as the loop would open it
    torch.cuda.synchronize()
    snap_s, snap_ws = clone(s), clone(ws_)
    args = kernels.LaneArgs(p, tb, s, ws_)

    def restore(snap=(snap_s, snap_ws)):
        for dst, src in zip(s, snap[0]):
            dst.copy_(src)
        for dst, src in zip(ws_, snap[1]):
            dst.copy_(src)

    # inputs of B and D are A's outputs (and B's tail): stage them once
    kernels.lane_slots(args)
    kernels.exchange_merge(args)
    torch.cuda.synchronize()
    snap_mid = (clone(s), clone(ws_))
    n_valid = int(ws_.rec_valid.sum())
    nbytes = kernel_bytes(p, s, ws_, n_valid)

    reps = 50
    plan = {
        "lane_slots": (restore, lambda: kernels.lane_slots(args),
                       lambda: lanes.lane_slots_plain(p, tb, s, ws_)),
        "exchange_merge": (
            lambda: (restore(), kernels.lane_slots(args)),
            lambda: kernels.exchange_merge(args),
            lambda: lanes.exchange_merge_plain(p, s, ws_)),
        "queue_min_window": (
            restore, lambda: kernels.queue_min_window(args, True),
            lambda: lanes.queue_min_window_plain(p, s, ws_, True)),
        "append_log": (lambda: restore(snap_mid),
                       lambda: kernels.append_log(args),
                       lambda: lanes.append_log_plain(p, s, ws_)),
    }
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
            "bytes": nbytes[name],
        }
        log(f"{name}: device {prof_ms.get(name, float('nan')):.5f} ms/launch "
            f"(profiler, 40 live steps), {event_ms:.5f} ms (events around "
            f"one launch, mean of {2 * reps}), plain {times[name]['plain_ms']:.4f}"
            f" ms, bound {bound:.6f} ms ({nbytes[name]} B / 3.35 TB/s)")
    log(f"valid records in the timed append: {n_valid}")
    return times


# ---- parity and the main path ----------------------------------------------

def _switch(up: str, down: str, latency: str) -> dict:
    return {"graph": {"type": "gml", "inline": (
        f'graph [ directed 0 node [ id 0 host_bandwidth_up "{up}" '
        f'host_bandwidth_down "{down}" ] edge [ source 0 target 0 '
        f'latency "{latency}" ] ]')}}


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
}


@phase("parity: card and CPU, step and device, three configs")
def parity():
    for name, (doc, strict, must) in PARITY.items():
        runs = {}
        for dev in ("cuda", "cpu"):
            for mode in ("step", "device"):
                eng = GpuEngine(ConfigOptions.from_dict(doc), device=dev,
                                strict_capacity=strict)
                state = eng.initial_state()
                p, tb = eng.params, eng.tables
                if mode == "device":
                    lanes._build_full_run(p, tb, state)()
                else:
                    round_fn = lanes._build_round(p, tb, state)
                    while not round_fn():
                        pass
                res = eng.collect(state, 0.0)
                runs[(dev, mode)] = (res, {f: t.cpu() for f, t in
                                           state._asdict().items()})
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


def expected_mesh(n: int, sim_s: int) -> dict:
    """The flagship mesh's closed form (10 ms timers, 10 ms links, no
    drops): ticks at 10, 20, ... ms before the stop send; a packet sent at
    t arrives at t + 10 ms."""
    ticks = sim_s * 100 - 1
    return {"lane_sends": n * ticks, "lane_delivered": n * (ticks - 1),
            "tgen_recv_bytes": n * (ticks - 1) * 1428,
            "lane_iters": sim_s * 100}


@phase("main path: flagship_mesh_config(10000), device mode")
def main_path():
    kernels.reset_launches()
    out = {}
    for sim_s, log_cap in ((1, 1_200_000), (10, 0)):
        eng = GpuEngine(flagship(sim_seconds=sim_s), log_capacity=log_cap)
        t0 = time.perf_counter()
        res = eng.run(mode="device")
        total = time.perf_counter() - t0
        exp = expected_mesh(N_FLAG, sim_s)
        got = {k: res.counters.get(k, 0) for k in exp}
        log(f"{sim_s} sim s, log capacity {log_cap}: {res.counters}, rounds "
            f"{res.rounds}, {res.sim_seconds_per_wall_second:.3f} sim-s/wall-s "
            f"(loop {res.wall_seconds:.3f} s, with set-up and collect "
            f"{total:.3f} s)")
        log(f"launches so far: "
            f"{ {fn.__name__: fn.launches for fn in kernels.WRAPPERS} }")
        if got != exp:
            raise AssertionError(f"counters {got} != closed form {exp}")
        if log_cap:
            if len(res.event_log) != exp["lane_delivered"]:
                raise AssertionError("log rows != deliveries")
            times = np.array([r.time for r in res.event_log])
            if not (np.all(times >= 10_000_000) and np.all(times < 10**9)):
                raise AssertionError("log times outside the run")
        out[sim_s] = res
    launches = {fn.__name__: fn.launches for fn in kernels.WRAPPERS}
    log(f"launches: {launches}")
    for name, cnt in launches.items():
        if cnt <= 0:
            raise AssertionError(f"{name} was not launched on the main path")
    return launches, out[10]


def main() -> int:
    log(f"device: {torch.cuda.get_device_name(0)}, count "
        f"{torch.cuda.device_count()}, torch {torch.__version__}, cuda "
        f"{torch.version.cuda}")
    log(f"nvidia-smi: {smi_line()}")
    t0 = time.perf_counter()
    try:
        lib = kernels.build()
    except Exception:
        traceback.print_exc()
        return 1
    log(f"kernel build: {time.perf_counter() - t0:.2f} s -> {lib.name}")
    for line in lib.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            log(f"  ptxas: {line.strip()}")

    check_kernels()
    times = time_kernels()
    parity()
    main_out = main_path()
    if FAILED:
        log(f"FAILED phases: {FAILED}")
        return 1
    launches, _res = main_out
    replaces = {
        "lane_slots": "shadow_tpu/backend/lanes.py:2900",
        "exchange_merge": "shadow_tpu/backend/lanes.py:1581",
        "queue_min_window": "shadow_tpu/backend/lanes.py:2260",
        "append_log": "shadow_tpu/backend/lanes.py:2056",
    }
    rows = []
    for name, rep in replaces.items():
        t = times[name]
        rows.append({
            "name": name, "route": "cuda",
            "source": "shadow_tpu_torch/csrc/lanes.cu", "replaces": rep,
            "launches": launches[name], "max_abs_err": MAX_ERR[name],
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": "bytes", "library_ms": None,
        })
    print(json.dumps({"kernels": rows}))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
