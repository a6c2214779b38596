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
8. full-width parity: PHOLD at 10,000 hosts for 50 sim ms, the lossy
   flagship for 1 sim s and the mixed mesh, untiered and tiered, for 100
   sim ms, card against the CPU plain path — equal logs and final states;
9. the main paths, launch counts reset just before each and read just
   after: the mixed TCP/UDP mesh (``mixed_flagship_config(10000)``:
   9,800 tgen-mesh hosts and 100 one-to-one stream pairs of 2 MB, strict)
   on the tiered stream pass at the preset's tuning (C=16, K=2, Cx=8,
   K_s=16, C2=64), then untiered at C=48, K=4, 5 sim s each;
   ``examples/cubic-vs-reno.yaml`` (tiered), 60 sim s;
   ``flagship_mesh_config(10000)`` with the bench tuning (C=16,
   K=2, Cx=8, strict), 1 sim s with logging and 10 sim s without;
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
shapes (both pop rules, with and without a log); between 7 and 8,
card/CPU parity on five untiered stream configs (the pair, the lossy
pair, the star, ``examples/cubic-vs-reno.yaml`` and a small mixed mesh)
and six tiered ones (the pair, lossy, CUBIC, the small mixed mesh, a
250 ms link, dynamic runahead), tiered = untiered, and
``examples/stream-tcp.yaml`` for 60 sim s, its first 1.5 sim s card
against CPU.

The last lines are the ``kernels`` JSON line, the ``nvidia-smi`` line and
the result line.  Imports nothing of JAX.
"""

from __future__ import annotations

import dataclasses
import json
import re
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
from shadow_tpu_torch.backend import lanes_stream as lstr  # noqa: E402
from shadow_tpu_torch.backend.gpu_engine import GpuEngine  # noqa: E402
from shadow_tpu_torch.config import presets  # noqa: E402
from shadow_tpu_torch.config.options import ConfigOptions  # noqa: E402
from shadow_tpu_torch.config.presets import flagship_mesh_config  # noqa: E402
from shadow_tpu_torch.core import rng as rng_mod  # noqa: E402
from shadow_tpu_torch.net import ltcp  # noqa: E402
from shadow_tpu_torch.net.token_bucket import bucket_params  # noqa: E402

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


def flagship(sim_seconds=10, packet_loss=0.0):
    cfg = flagship_mesh_config(N_FLAG, sim_seconds=sim_seconds,
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
        # the exchange scratch (x_*) is the kernel's own working memory
        out.append({**fields(s), **{f: t for f, t in ws._asdict().items()
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
                trec, _s, _b, ttail, tend = p.tier_rec_offsets
                groups = [int(ws1.rec_valid[a:b].sum()) for a, b in (
                    (0, trec), (trec, ttail), (ttail, tend),
                    (tend, p.n_records))]
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


def kernel_bytes(p: lanes.LaneParams, tb, ws, tier: dict) -> dict:
    """Bytes each kernel must move at these inputs (``ws`` after one A, one
    B and, in untiered one-to-one stream configs, one E, or on a tiered run
    one F and one G): every input read once, every output written once.  A
    logging run writes every record slot's valid flag but only the valid
    rows: B the merge tail's, E the split tail's, A those of its popped
    slots and stream sends, F its tier records', G the tier tail's.  A
    tier entry (7 words) is read or written whole only when valid: an
    empty one needs its time word alone.  ``tier``: the counts of this
    iteration's tier entries — ``popped`` (the events F popped),
    ``cross`` (the valid entries of B's diverted block), ``cand`` (F's
    valid candidates), ``merged`` (the valid entries G merged: queue and
    candidates) and ``kept`` (the valid entries of G's rows)."""
    pl = p.lane
    n, c, k, cx = p.n_lanes, p.capacity, p.pops_per_iter, p.cross_cap
    sw, words = pl.self_width, pl.words
    g = int(tb.lat.shape[0])
    tail, slots, _srec, _brec, end = p.rec_offsets
    n_rec = ws.rec_valid.numel() if p.log_capacity else 0
    tail_rows = int(ws.rec_valid[:tail].sum()) if n_rec else 0
    split_rows = int(ws.rec_valid[tail:slots].sum()) if n_rec else 0
    a_rows = int(ws.rec_valid[slots:].sum()) if n_rec else 0
    state_vec = (len(lanes._SLOT_FIELDS) - 1) * 4 + 1  # [N] words (+ the bool)
    tables = 17 * 4  # [N] table words read per lane
    a_in = (n * (k * words * 4 + state_vec + tables) + g * g * (4 + 8)
            + 1025 * 4 + 4 * 4)
    a_out = n * (k * 2 * 4 + state_vec) + (words * sw + 6 * k) * n * 4 + 4
    n_ent = pl.stream_entries
    if pl.stream_present:
        # the flow rows read and written, the [2S] flow tables (14 int32, the
        # int64 threshold), the lane -> row table, the stream block written
        s2 = 2 * p.s_flows
        a_in += s2 * lstr.N_COLS * 4 + s2 * (14 * 4 + 8) + (n + 1 + s2) * 4
        a_out += s2 * lstr.N_COLS * 4 + n_ent * 8 * 4
    if p.log_capacity:
        a_out += (end - slots) * 4 + a_rows * 6 * 8
    x_ent = k * n + (0 if p.split else n_ent)
    b_in = n * c * words * 4 + words * n * sw * 4 + x_ent * 4 + n * 4
    # the selected cross entries (stream entries carry two more words)
    b_in += int(ws.x_cnt.clamp(max=cx).sum()) * words * 4
    b_out = n * c * words * 4 + n * 4
    if p.log_capacity:
        b_out += tail * 4 + tail_rows * 6 * 8
    f_io = g_io = 0
    if p.stream_tiered:
        s2, ks, c2 = 2 * p.s_flows, p.stream_pops, p.stream_capacity
        sa0, _se0, _bo0, cx0, t_end = p.tier_layout
        # B: the lane -> row table and the diverted cross block written
        b_in += n + n * 4
        b_out += (t_end - cx0) * 4 + tier["cross"] * 6 * 4
        # F: its K_s columns (7 words) read and the popped time words
        # written, the flow rows and the 22 tier vector rows read and
        # written, its [2S] tables (16 int32, the int64 threshold), the
        # candidate channels written; records: every slot's flag, the valid
        # rows
        f_io = (s2 * ks * 7 * 4 + tier["popped"] * 2 * 4
                + 2 * s2 * (lstr.N_COLS + 22) * 4 + s2 * (16 * 4 + 8)
                + 1025 * 4 + cx0 * 4 + tier["cand"] * 6 * 4)
        trec, _s, _b, ttail, tend = p.tier_rec_offsets
        if p.log_capacity:
            f_io += ((ttail - trec) * 4
                     + int(ws.rec_valid[trec:ttail].sum()) * 6 * 8)
        # G: the time word of every entry it can hold (a client row has no
        # burst block), the other six of each valid one; the rows written
        # the same way; the overflow counter; records: every tail flag, the
        # valid rows
        g_in = s2 * (c2 + p.tier_width) - p.s_flows * ks * lanes.PUMP_BURST
        g_io = (g_in * 4 + tier["merged"] * 6 * 4 + s2 * c2 * 4
                + tier["kept"] * 6 * 4 + s2 * 8 + s2 * 4)
        if p.log_capacity:
            g_io += ((tend - ttail) * 4
                     + int(ws.rec_valid[ttail:tend].sum()) * 6 * 8)
    e_io = 0
    if p.split:
        s2 = 2 * p.s_flows
        e_io = (2 * s2 * c * words * 4 + n_ent * 7 * 4 + 2 * s2 * 4
                + s2 * 4)
        if p.log_capacity:
            e_io += (slots - tail) * 4 + split_rows * 6 * 8
    c_io = n * 8 + 4 * 4 + 6 * 4 + 4
    if p.stream_tiered:
        c_io += 2 * p.s_flows * 8  # the tier rows' heads
    valid = int(ws.rec_valid.sum()) if n_rec else 0
    d_in = n_rec * 4 + valid * 6 * 8
    d_out = valid * 6 * 8 + 8
    return {
        "lane_slots": a_in + a_out, "exchange_merge": b_in + b_out,
        "stream_rows_merge": e_io, "stream_tier": f_io, "tier_merge": g_io,
        "queue_min_window": c_io, "append_log": d_in + d_out,
        "valid_records": valid,
    }


# device kernels of each wrapper, by the names CUPTI gives them with the
# namespace, template arguments and parameters taken off (kernel_name); the
# exchange's two scratch memsets ("Memset (Device)") count to B as well
KERNEL_PARTS = {
    "lane_slots": ("lane_slots_kernel",),
    "tier_merge": ("tier_merge_kernel",),
    "stream_tier": ("stream_tier_kernel",),
    "exchange_merge": ("x_count_kernel", "x_scan_kernel", "x_place_kernel",
                       "merge_kernel", "Memset"),
    "stream_rows_merge": ("stream_rows_kernel",),
    "queue_min_window": ("queue_min_kernel",),
    "append_log": ("append_log_kernel",),
}


WRAPPER_OF = {part: name for name, parts in KERNEL_PARTS.items()
              for part in parts}
assert len(WRAPPER_OF) == sum(map(len, KERNEL_PARTS.values()))


def kernel_name(key: str) -> str:
    """The bare name of a profiler event: "merge_kernel" for "void
    (anonymous namespace)::merge_kernel<7>(LaneBufs)", "Memset" for
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
    if p.log_capacity:
        out.append("append_log")
    return out


def profile_steps(window, iteration, steps: int, p: lanes.LaneParams) -> dict:
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
    totals = {name: 0.0 for name in path_kernels(p)}
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", None)
        if us is None:
            us = getattr(ev, "cuda_time_total", 0.0)
        name = WRAPPER_OF.get(kernel_name(ev.key))
        if name in totals:
            totals[name] += us
            log(f"  device {us / steps:9.3f} us/step in {ev.count:5d} "
                f"launches: {ev.key[:70]}")
    if not all(totals.values()):
        log(f"profiler device times incomplete: {totals}")
        return {}
    return {name: us / 1e3 / steps for name, us in totals.items()}


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
    prof_ms = profile_steps(window, iteration, 40, p)
    window(True)  # the next window, as the loop would open it
    torch.cuda.synchronize()
    snap_s, snap_ws = clone(s), clone(ws_)
    args = kernels.LaneArgs(p, tb, s, ws_)

    def restore(snap=(snap_s, snap_ws)):
        copy_into(s, snap[0])
        copy_into(ws_, snap[1])

    # inputs of B, E, F, G and D are A's outputs (and B's): stage them once
    kernels.lane_slots(args)
    kernels.exchange_merge(args)
    if p.split:
        kernels.stream_rows_merge(args)
    tier = {}
    if p.stream_tiered:
        cx0 = p.tier_layout[3]
        tier["cross"] = int((ws_.tier_blk[0, cx0:] != lanes.NEVER32).sum())
        before = s.stream.q[0, :, :p.stream_pops].clone()
        kernels.stream_tier(args)
        tier["popped"] = int((before != s.stream.q[0, :, :p.stream_pops])
                             .sum())
        tier["cand"] = int((ws_.tier_blk[0, :cx0] != lanes.NEVER32).sum())
        tier["merged"] = (int((s.stream.q[0] != lanes.NEVER32).sum())
                          + tier["cand"] + tier["cross"])
        kernels.tier_merge(args)
        tier["kept"] = int((s.stream.q[0] != lanes.NEVER32).sum())
        log(f"{label}: tier entries in the timed iteration: {tier}")
    torch.cuda.synchronize()
    snap_mid = (clone(s), clone(ws_))
    nbytes = kernel_bytes(p, tb, ws_, tier)

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
    if log_cap:
        plan["append_log"] = (lambda: restore(snap_mid),
                              lambda: kernels.append_log(args),
                              lambda: lanes.append_log_plain(p, s, ws_))
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
        }
        log(f"{label} {name}: device {prof_ms.get(name, float('nan')):.5f} "
            f"ms/launch (profiler, 40 live steps), {event_ms:.5f} ms (events "
            f"around one launch, mean of {2 * reps}), plain "
            f"{times[name]['plain_ms']:.4f} ms, bound {bound:.6f} ms "
            f"({nbytes[name]} B / 3.35 TB/s)")
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
        # this slice's main path, the tiered mixed mesh (kernels F and G):
        # 20 steps in (the tier pops up to 16 events a row per step), the
        # flows are in slow start
        "mixed_tiered": time_kernels("mixed mesh, tiered", mixed_tiered(2), 0,
                                     20),
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


@phase("parity: card and CPU, step and device, seven configs")
def parity():
    for name, (doc, strict, must) in PARITY.items():
        runs = {}
        for dev in ("cuda", "cpu"):
            for mode in ("step", "device"):
                eng = GpuEngine(ConfigOptions.from_dict(doc), device=dev,
                                strict_capacity=strict)
                res, st = run_engine(eng, mode)
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


@phase("stream parity: card (step and device) and CPU, five untiered and "
       "six tiered configs; tiered = untiered")
def stream_parity():
    refs = {}
    for name, (cfg_fn, cpu_modes, must) in STREAM_PARITY.items():
        runs = {}
        for dev, modes in (("cpu", cpu_modes), ("cuda", ("step", "device"))):
            for mode in modes:
                t0 = time.perf_counter()
                res, st = run_engine(GpuEngine(cfg_fn(), device=dev), mode)
                runs[(dev, mode)] = (res, st)
                log(f"{name} {dev}/{mode}: {len(res.event_log)} records, "
                    f"{res.counters}, rounds {res.rounds} "
                    f"({time.perf_counter() - t0:.1f} s)")
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


@phase("examples/stream-tcp.yaml: 60 sim s on the card; a prefix card = CPU")
def stream_tcp_example():
    """4 clients x 1 MiB into one server over a 40 ms link with 2% loss:
    every flow completes with retransmissions; over the first 1.5 sim s,
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
        doc = presets.stream_tcp_example_doc()
        doc["general"]["stop_time"] = "1500ms"
        t0 = time.perf_counter()
        runs[dev] = run_engine(GpuEngine(ConfigOptions.from_dict(doc),
                                         device=dev), "device")
        log(f"stream-tcp.yaml 1.5 s {dev}: {runs[dev][0].counters} "
            f"({time.perf_counter() - t0:.1f} s)")
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


@phase("full width: card against the CPU plain path")
def full_width_parity():
    """PHOLD at 10,000 hosts for 50 sim ms, the lossy flagship for 1 sim s
    and the mixed mesh, untiered and tiered, for 100 sim ms (the handshakes
    and the first bursts), device mode with logging: equal event logs,
    counters and final states."""
    def mixed_100ms(make):
        def cfg_fn():
            cfg = make(1)
            cfg.general.stop_time = 100_000_000
            return cfg
        return cfg_fn

    for name, cfg_fn, log_cap in (
            ("phold 50 ms", lambda: phold(stop_time="50ms"), 1_000_000),
            ("lossy flagship 1 s",
             lambda: flagship(sim_seconds=1, packet_loss=0.01), 1_200_000),
            ("mixed mesh 100 ms", mixed_100ms(mixed_mesh), 400_000),
            ("mixed mesh tiered 100 ms", mixed_100ms(mixed_tiered), 400_000)):
        runs = {}
        for dev in ("cuda", "cpu"):
            t0 = time.perf_counter()
            res, st = run_engine(GpuEngine(cfg_fn(), log_capacity=log_cap,
                                           device=dev), "device")
            runs[dev] = (res, st)
            log(f"{name} {dev}: {len(res.event_log)} records, {res.counters}, "
                f"rounds {res.rounds} ({time.perf_counter() - t0:.1f} s)")
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


def check_flagship(res, sim_s: int, log_cap: int) -> None:
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


def check_phold(res, _sim_s: int, _log_cap: int) -> None:
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


def check_lossy(res, _sim_s: int, _log_cap: int) -> None:
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


def check_cubic_vs_reno(res, _sim_s: int, _log_cap: int) -> None:
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
MAIN_PATHS = {
    # this slice's: the mixed TCP/UDP mesh at 10,000 hosts, tiered at the
    # preset's own tuning
    "mixed mesh 10k, tiered, 5 s": (
        lambda: mixed_tiered(5), 0,
        lambda r, s_, l_: check_mixed(r, s_, l_, True), 5),
    # the same mesh untiered (kernel E), at the pre-tier queue shape
    "mixed mesh 10k, untiered, 5 s": (
        lambda: mixed_mesh(5), 0,
        lambda r, s_, l_: check_mixed(r, s_, l_, False), 5),
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


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in kernels.WRAPPERS}


@phase("main paths at full width, device mode")
def main_path():
    totals = {}
    rates = {}
    drawing = 0  # launches of A on paths whose A runs the threefry draw
    for name, (cfg_fn, log_cap, check_fn, sim_s) in MAIN_PATHS.items():
        eng = GpuEngine(cfg_fn(), log_capacity=log_cap)
        kernels.reset_launches()
        t0 = time.perf_counter()
        res = eng.run(mode="device")
        total = time.perf_counter() - t0
        counts = launch_counts()
        log(f"{name}: {res.counters}, rounds {res.rounds}, "
            f"{res.sim_seconds_per_wall_second:.3f} sim-s/wall-s (loop "
            f"{res.wall_seconds:.3f} s, with set-up and collect {total:.3f} "
            f"s); launches {counts}; nvidia-smi: {smi_line()}")
        rates[name] = res.sim_seconds_per_wall_second
        check_fn(res, sim_s, log_cap)
        for k in path_kernels(eng.params):
            if counts[k] <= 0:
                raise AssertionError(f"{name}: {k} was not launched")
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v
        if eng.params.draws:
            drawing += counts["lane_slots"]
    log(f"launches over the main paths: {totals}; of A, {drawing} on paths "
        f"that draw")
    return totals, rates, drawing


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
    # the compiler's report per kernel: function name, then its registers
    ptxas = [line.strip() for line in
             lib.with_suffix(".log").read_text().splitlines()
             if "Compiling entry" in line or "registers" in line
             or "spill" in line or "error" in line]
    for line in ptxas:
        log(f"  ptxas: {line}")

    check_kernels()
    check_rand_u32()
    check_active_kernels()
    check_stream_kernels()
    check_tier_kernels()
    times = time_all()
    parity()
    stream_parity()
    stream_tcp_example()
    full_width_parity()
    main_out = main_path()
    if FAILED:
        log(f"FAILED phases: {FAILED}")
        return 1
    launches, rates, drawing = main_out
    smi = smi_line()
    for line in ptxas:  # again here: the start of a long output is cut
        log(f"ptxas: {line}")
    for name, rate in rates.items():
        log(f"sim-s/wall-s, {name}: {rate:.3f} ({smi})")
    for cfg_name in ("mixed_tiered", "mixed", "flagship", "flagship_log",
                     "phold", "lossy"):
        for name, t in times[cfg_name].items():
            if name == "loop":
                log(f"device busy, {cfg_name}: {t['busy']:.4f} of "
                    f"{t['step_ms'] * 1e3:.3f} us/step ({smi})")
                continue
            log(f"device us/launch, {cfg_name} {name}: {t['ms'] * 1e3:.3f} "
                f"(bound {t['bound_ms'] * 1e3:.3f}, plain "
                f"{t['plain_ms'] * 1e3:.1f}) ({smi})")
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
            "bound_by": t["bound_by"], "library_ms": None,
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
        if name == "rand_u32":
            # the launcher runs on no main path: its own launches in the
            # phase that timed it
            row["launches"] = t["launches"]
            row["launches_from"] = "timing phase"
        rows.append(row)
    print(json.dumps({"kernels": rows}))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
