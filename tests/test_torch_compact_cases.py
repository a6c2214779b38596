"""Kernel D's and kernel C's edge cases, plain, against the JAX reference.

On the card ``chip_smoke.py`` (``check_compact_cases``) holds the cluster
forms of D (``append_log``) and C (``queue_min_window`` and its hybrid and
fused modes) to their plain versions on these kinds of cases; here, at
small widths, the plain versions are held to the reference, exactly, every
word:

- D's three instances in one call (``append_log_plain``: the log, the
  flowtrace ring, the hybrid egress) against ``_append_log``,
  ``_append_flow`` and ``_append_egress``: valid flags only in the last
  cluster block's slice or only on slice boundaries, all valid, none, a
  run that crosses the capacity inside a slice, a start past the capacity,
  an egress minimum in a block other than rank 0;
- a blocked emulation of the new D in plain torch (per-slice counts,
  exclusive offsets, the per-slice capacity cut, the losses, per-slice
  egress minima) against ``_append_rows``, for 1, 8 and 16 slices, tiles
  of one or many runs, and lengths that do not divide;
- ``queue_min_window_plain`` against ``_queue_min`` and the window law of
  ``_build_full_run`` (``lanes.py:3505-3526``) and ``_build_round``'s
  window test: the min head in the last lane or in a tier row, every head
  NEVER, tied heads, a head equal to the stop time; advance on and off,
  the window opened or not, dynamic runahead, the netobs flush;
- C's hybrid mode (a turn's first and later steps) and its fused mode
  (dispatches whose refold passes re-arm the guard) on such heads, against
  the reference's ``make_hybrid_fn`` and ``make_hybrid_fused_fn``;
- C's size rule (``lanes.heads_blocks``: the blocks of its cluster), and
  the cluster sizes in ``lanes`` against the kernels' constants.
"""

import collections
import functools
import pathlib
import re
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shadow_tpu.backend import lanes as ref_lanes
from shadow_tpu.backend.tpu_engine import TpuEngine
from shadow_tpu.config import presets as ref_presets
from shadow_tpu_torch.backend import bridge, kernels, lanes
from shadow_tpu_torch.backend import lanes_stream as ls
from shadow_tpu_torch.backend.gpu_engine import GpuEngine
from shadow_tpu_torch.config import presets as port_presets
from test_torch_hybrid import (_assert_states, _block, _engines, _lift,
                               _random_queues, _ref_turn)
from test_torch_hybrid_fused import SCHEDULES, SLOTS, K_CAP, WE0
from test_torch_hybrid_fused import _pairs as _ext_pairs
from test_torch_hybrid_fused import _ref_fused
from test_torch_tier import _mixed, _ref_numpy

NEVER32 = lanes.NEVER32
MASK31 = lanes.MASK31
BITS = lanes.LOG_BITS  # flags a thread of D takes
D_BLOCKS = lanes.LOG_CLUSTER  # D's cluster


# ---- D -------------------------------------------------------------------


def _slices(n: int, blocks: int) -> list:
    """D's slices of ``n`` flags over a cluster of ``blocks``: whole runs
    of 32 flags, the last ones short or empty."""
    per = -(-n // (blocks * BITS)) * BITS
    return [(min(n, r * per), min(n, r * per + per)) for r in range(blocks)]


def _flags(case: str, n: int, rng) -> np.ndarray:
    v = np.zeros(n, bool)
    sl = _slices(n, D_BLOCKS)
    if case == "last_slice":
        lo, hi = [s for s in sl if s[1] > s[0]][-1]
        v[lo:hi] = rng.random(hi - lo) < 0.5
        v[hi - 1] = True
    elif case == "boundaries":
        for lo, hi in sl:
            if hi > lo:
                v[lo] = v[hi - 1] = True
    elif case == "all":
        v[:] = True
    elif case != "none":
        v = rng.random(n) < 0.3
    return v


# case -> (flag pattern, where the count starts relative to the capacity):
# "mid" puts the capacity inside slice 7's valid rows
D_CASES = {
    "last_slice": ("last_slice", "room"),
    "boundaries": ("boundaries", "room"),
    "all": ("all", "room"),
    "none": ("none", "room"),
    "cap_inside_slice": ("random", "mid"),
    "start_past_cap": ("random", "past"),
}
N_LOG, N_FL, N_EG = 1000, 517, 333  # D's three flag arrays


def _start_cap(where: str, valid: np.ndarray, rng) -> tuple:
    """(start count, capacity) for one instance."""
    start = int(rng.integers(0, 40))
    total = int(valid.sum())
    if where == "room":
        return start, start + total + int(rng.integers(0, 5))
    if where == "past":
        cap = start + 7
        return cap + 3, cap
    lo, hi = _slices(valid.size, D_BLOCKS)[7]
    before = int(valid[:lo].sum()) + max(1, int(valid[lo:hi].sum()) // 2)
    return start, start + before


def _ref_state(**fields):
    return collections.namedtuple("RefState", list(fields))(**fields)


def _d_inputs(case: str, seed: int):
    """Seeded inputs for the three instances: flags, rows, starts,
    capacities, and the egress rows' outcomes (the earliest DELIVERED time
    in slice 5 of the egress flags, earlier DROP_CODEL and invalid rows as
    decoys in slice 0)."""
    rng = np.random.default_rng(seed)
    pattern, where = D_CASES[case]
    out = {}
    for inst, n in (("log", N_LOG), ("fl", N_FL), ("eg", N_EG)):
        valid = _flags(pattern, n, rng)
        start, cap = _start_cap(where, valid, rng)
        out[inst] = dict(valid=valid, start=start, cap=cap)
    t = 3_000_000_000 + rng.integers(0, 1 << 40, (N_LOG,))
    out["log"]["rows"] = np.stack(
        [t, *(rng.integers(0, 1 << 20, (4, N_LOG))),
         rng.integers(0, 5, N_LOG)], axis=1).astype(np.int64)
    out["fl"]["rows"] = rng.integers(0, 1 << 30, (N_FL, 8)).astype(np.int32)
    eg = out["eg"]
    t = 5_000_000_000 + rng.integers(0, 1 << 36, N_EG)
    delivered = rng.random(N_EG) < 0.6
    lo5, hi5 = _slices(N_EG, D_BLOCKS)[5]
    lo0, hi0 = _slices(N_EG, D_BLOCKS)[0]
    if eg["valid"][lo5:hi5].any():
        first = lo5 + int(np.argmax(eg["valid"][lo5:hi5]))
        t[first], delivered[first] = 4_000_000_000, True
        t[lo0], delivered[lo0] = 3_500_000_000, False  # a dropped decoy
        if not eg["valid"][lo0 + 1]:
            t[lo0 + 1], delivered[lo0 + 1] = 3_000_000_000, True  # invalid
    eg["rows"] = np.stack(
        [t, *(rng.integers(0, 1 << 17, (4, N_EG))),
         np.where(delivered, lanes.DELIVERED, lanes.DROP_CODEL)],
        axis=1).astype(np.int64)
    return out


@pytest.mark.parametrize("case", list(D_CASES))
def test_append_log_matches_reference(case):
    """D's three instances in one plain call against the reference's three
    appends: buffers (every row, untouched ones included), counts, losses
    and the egress minimum."""
    d = _d_inputs(case, 41 + list(D_CASES).index(case))
    lg, fl, eg = d["log"], d["fl"], d["eg"]
    we_hi, we_lo = 3, 123_456
    eg_min = (NEVER32, NEVER32) if case != "none" else (2, 5)
    # the reference
    r = lg["rows"]
    s = _ref_state(log=jnp.full((lg["cap"], 6), -7, jnp.int64),
                   log_count=jnp.int32(lg["start"]), log_lost=jnp.int32(2))
    s = ref_lanes._append_log(
        types.SimpleNamespace(log_capacity=lg["cap"]), s,
        {"valid": jnp.asarray(lg["valid"]), "time": jnp.asarray(r[:, 0]),
         **{k: jnp.asarray(r[:, i]) for i, k in enumerate(
             ("src", "dst", "seq", "size", "outcome"), start=1)}})
    f = fl["rows"]
    sf = _ref_state(fl_buf=jnp.full((fl["cap"], 10), -7, jnp.int32),
                    fl_count=jnp.int32(fl["start"]), fl_lost=jnp.int32(0),
                    now_we_hi=jnp.int32(we_hi), now_we_lo=jnp.int32(we_lo))
    sf = ref_lanes._append_flow(
        types.SimpleNamespace(flowtrace=True, flow_capacity=fl["cap"]), sf,
        {"valid": jnp.asarray(fl["valid"]),
         **{k: jnp.asarray(f[:, i]) for i, k in enumerate(
             ("t_hi", "t_lo", "kind", "src", "dst", "seq", "size", "aux"))}})
    e = eg["rows"]
    se = _ref_state(egress=jnp.full((eg["cap"], 6), -7, jnp.int64),
                    egress_count=jnp.int32(eg["start"]),
                    egress_lost=jnp.int32(1),
                    egress_min_hi=jnp.int32(eg_min[0]),
                    egress_min_lo=jnp.int32(eg_min[1]))
    se = ref_lanes._append_egress(
        types.SimpleNamespace(egress_capacity=eg["cap"]), se,
        jnp.asarray(eg["valid"]), jnp.asarray(e[:, 5] == lanes.DELIVERED),
        jnp.asarray((e[:, 0] >> 31).astype(np.int32)),
        jnp.asarray((e[:, 0] & MASK31).astype(np.int32)),
        *(jnp.asarray(e[:, i].astype(np.int32)) for i in (1, 2, 3, 4)))
    # the port: one call, all three instances
    i32 = torch.int32
    p = types.SimpleNamespace(external_any=True, log_capacity=lg["cap"],
                              flowtrace=True, flow_capacity=fl["cap"],
                              egress_capacity=eg["cap"])
    st = types.SimpleNamespace(
        log=torch.full((lg["cap"], 6), -7, dtype=torch.int64),
        log_count=torch.tensor(lg["start"], dtype=i32),
        log_lost=torch.tensor(2, dtype=i32),
        fl_buf=torch.full((fl["cap"], 10), -7, dtype=i32),
        fl_count=torch.tensor(fl["start"], dtype=i32),
        fl_lost=torch.tensor(0, dtype=i32),
        now_we_hi=torch.tensor(we_hi, dtype=i32),
        now_we_lo=torch.tensor(we_lo, dtype=i32),
        egress=torch.full((eg["cap"], 6), -7, dtype=torch.int64),
        egress_count=torch.tensor(eg["start"], dtype=i32),
        egress_lost=torch.tensor(1, dtype=i32),
        egress_min_hi=torch.tensor(eg_min[0], dtype=i32),
        egress_min_lo=torch.tensor(eg_min[1], dtype=i32))
    ws = types.SimpleNamespace(
        ctl=torch.tensor([1, 0, 0, 0], dtype=i32),
        rec_valid=torch.from_numpy(lg["valid"].astype(np.int32)),
        recs=torch.from_numpy(r),
        fl_valid=torch.from_numpy(fl["valid"].astype(np.int32)),
        fl_recs=torch.from_numpy(f),
        eg_valid=torch.from_numpy(eg["valid"].astype(np.int32)),
        eg_recs=torch.from_numpy(e))
    lanes.append_log_plain(p, st, ws)
    for ref_s, names in ((s, ("log", "log_count", "log_lost")),
                         (sf, ("fl_buf", "fl_count", "fl_lost")),
                         (se, ("egress", "egress_count", "egress_lost",
                               "egress_min_hi", "egress_min_lo"))):
        for name in names:
            np.testing.assert_array_equal(getattr(st, name).numpy(),
                                          np.asarray(getattr(ref_s, name)),
                                          err_msg=f"{case}: {name}")
    if case == "last_slice" or case == "boundaries":
        assert int(st.log_count) > lg["start"]
    if case == "cap_inside_slice":
        assert int(st.log_lost) > 2 and int(st.fl_lost) > 0
    if case in ("last_slice", "cap_inside_slice"):
        # the egress minimum came from slice 5, past the decoys of slice 0
        lo5, hi5 = _slices(N_EG, D_BLOCKS)[5]
        if eg["valid"][lo5:hi5].any():
            assert lanes.t_join(st.egress_min_hi, st.egress_min_lo) == (
                4_000_000_000)


def _blocked_append(valid, rows, buf, count, lost, cap: int, blocks: int,
                    tile: int, times=None):
    """The new D's arithmetic in plain torch: each of ``blocks`` slices
    (whole runs of 32 flags) counts its valid flags; the exclusive prefix
    of the counts is each slice's offset from ``count``; each slice copies
    its valid rows in order, tile by tile (``tile`` flags each), to
    ``count + offset + j``, not past ``cap``; the total goes to ``count``
    and the rows past the capacity to ``lost``.  With ``times`` (the
    egress), the minimum of each slice's valid times, then of the slices'
    minima.  Returns that minimum (None without ``times``)."""
    n = valid.numel()
    sl = _slices(n, blocks)
    counts = [int(valid[lo:hi].sum()) for lo, hi in sl]
    offsets = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(int)
    start = int(count)
    for (lo, hi), off in zip(sl, offsets):
        pos = start + int(off)
        for t0 in range(lo, hi, tile):
            idx = torch.nonzero(valid[t0:min(hi, t0 + tile)]).flatten() + t0
            at = pos + torch.arange(idx.numel())
            keep = at < cap
            buf[at[keep]] = rows[idx[keep]]
            pos += idx.numel()
    total = sum(counts)
    kept = min(total, max(0, cap - start))
    count.fill_(start + total)
    lost.add_(total - kept)
    if times is None:
        return None
    minima = [int(times[lo:hi][valid[lo:hi]].min()) if counts[i] else
              lanes.NEVER for i, (lo, hi) in enumerate(sl)]
    return min(minima)


@pytest.mark.parametrize("blocks", [1, 8, 16])
@pytest.mark.parametrize("n", [1, 31, 33, 1000, 16 * 32 * 3 + 5])
def test_blocked_emulation_matches_append_rows(blocks, n):
    """The emulation of the cluster's offset arithmetic against
    ``_append_rows``, for one tile a slice (the kernel's 32,768 flags) and
    tiles of two runs, from room to spare, a capacity inside the run and a
    start past the capacity; the per-slice egress minima against the min
    over all valid rows."""
    rng = np.random.default_rng(1000 * blocks + n)
    for density in (0.0, 0.35, 1.0):
        valid = torch.from_numpy(rng.random(n) < density)
        rows = torch.from_numpy(rng.integers(0, 1 << 40, (n, 6)))
        total = int(valid.sum())
        for start, cap in ((3, 3 + total + 2), (5, 5 + total // 2),
                           (9, 4)):
            for tile in (lanes.LOG_TILE, 2 * BITS):
                want = (torch.full((max(cap, 1), 6), -1), torch.tensor(start),
                        torch.tensor(1))
                got = tuple(t.clone() for t in want)
                lanes._append_rows(valid, rows, want[0], want[1], want[2],
                                   cap)
                tmin = _blocked_append(valid, rows, got[0], got[1], got[2],
                                       cap, blocks, tile, times=rows[:, 0])
                for a, b, name in zip(got, want, ("buf", "count", "lost")):
                    assert torch.equal(a, b), (blocks, n, density, start,
                                               cap, tile, name)
                assert tmin == (int(rows[valid, 0].min()) if total
                                else lanes.NEVER)


# ---- C: the head reduction and the window law ---------------------------


@functools.lru_cache(maxsize=None)
def _tier_engines(planes: bool):
    """The 12-host mixed mesh with two tiered stream pairs (heads in the
    [N] lanes and in the tier's four endpoint rows), with netobs and
    dynamic runahead when ``planes``: the reference's and the port's."""
    cfgs = []
    for pkg in (ref_presets, port_presets):
        cfg = _mixed(pkg)
        cfg.experimental.netobs = planes
        cfg.experimental.use_dynamic_runahead = planes
        cfgs.append(cfg)
    ref = TpuEngine(cfgs[0], log_capacity=0)
    port = GpuEngine(cfgs[1], log_capacity=0, device="cpu")
    assert port.params.stream_tiered and ref.params.stream_tiered
    return ref, port


HEAD_CASES = ("last_lane", "tier_row", "all_never", "ties", "at_stop")
T_HEAD = 600_000_000  # the crafted min head (ns)


def _heads(case: str, p, rng):
    """Queue words [N, C] (time pair) and tier heads [2S] for ``case``:
    rows of one head at column 0 (later heads elsewhere), NEVER after it."""
    n, c, s2 = p.n_lanes, p.capacity, 2 * p.s_flows
    head = T_HEAD + 1 + rng.integers(0, 50_000_000, n + s2)
    never = np.zeros(n + s2, bool)
    never[rng.random(n + s2) < 0.3] = True
    if case == "last_lane":
        head[n - 1], never[n - 1] = T_HEAD, False
    elif case == "tier_row":
        head[n + s2 - 1], never[n + s2 - 1] = T_HEAD, False
    elif case == "all_never":
        never[:] = True
    elif case == "ties":
        # equal minima in two lanes and a tier row, and one whose high word
        # ties with a larger low word
        for i in (1, n - 2, n + 1):
            head[i], never[i] = T_HEAD, False
        head[3], never[3] = T_HEAD + 1, False
    elif case == "at_stop":
        head[:], never[:] = p.stop_time, False
        never[::3] = True
    hi = np.where(never, NEVER32, head >> 31).astype(np.int32)
    lo = np.where(never, NEVER32, head & MASK31).astype(np.int32)
    q_hi = np.full((n, c), NEVER32, np.int32)
    q_lo = np.full((n, c), NEVER32, np.int32)
    q_hi[:, 0], q_lo[:, 0] = hi[:n], lo[:n]
    return q_hi, q_lo, hi[n:], lo[n:]


def _ref_window(rp, st, advance: bool):
    """The reference's window law on one step: ``_build_full_run``'s step
    (``lanes.py:3505-3526``) with ``advance``, then ``_build_round``'s
    window test; returns the state and (live, in_window, head pair)."""
    r = ref_lanes
    stop_hi, stop_lo = rp.stop_time >> 31, rp.stop_time & MASK31
    mn_hi, mn_lo = r._queue_min(rp, st)
    live = r.pair_lt(mn_hi, mn_lo, stop_hi, stop_lo)
    if advance:
        fresh = r.pair_ge(mn_hi, mn_lo, st.now_we_hi, st.now_we_lo) & live
        if rp.netobs:
            st = r._flush_hist(rp, st, fresh)
        c_hi, c_lo = r.pair_sel(live, mn_hi, mn_lo, stop_hi, stop_lo)
        c_hi, c_lo = r.pair_add32(c_hi, c_lo, r._effective_runahead(rp, st))
        c_hi, c_lo = r.pair_sel(r.pair_lt(c_hi, c_lo, stop_hi, stop_lo),
                                c_hi, c_lo, stop_hi, stop_lo)
        st = st._replace(
            now_we_hi=jnp.where(fresh, c_hi, st.now_we_hi),
            now_we_lo=jnp.where(fresh, c_lo, st.now_we_lo),
            rounds=st.rounds + fresh.astype(st.rounds.dtype))
    in_window = live & r.pair_lt(mn_hi, mn_lo, st.now_we_hi, st.now_we_lo)
    return st, [int(live), int(in_window), int(mn_hi), int(mn_lo)]


# (advance, the window's end against the crafted head)
WINDOWS = {"advance_fresh": (True, T_HEAD - 1_000),
           "advance_inside": (True, T_HEAD + 5_000_000),
           "advance_at_head": (True, T_HEAD),
           "no_advance": (False, T_HEAD - 1_000)}


@pytest.mark.parametrize("planes", [False, True])
@pytest.mark.parametrize("window", list(WINDOWS))
@pytest.mark.parametrize("case", HEAD_CASES)
def test_queue_min_window_matches_reference(case, window, planes):
    """C, plain, on crafted heads against ``_queue_min`` and the window
    law: the ``ctl`` words, the window, the rounds and, with netobs and
    dynamic runahead, the histogram and the window count."""
    ref, port = _tier_engines(planes)
    rp, p = ref.params, port.params
    rng = np.random.default_rng(HEAD_CASES.index(case) * 10 + planes)
    advance, we = WINDOWS[window]
    q_hi, q_lo, t_hi, t_lo = _heads(case, p, rng)
    s_ref = ref.initial_state()
    d = _ref_numpy(s_ref)
    flows, q, v = d["stream"]
    q = q.copy()
    q[ls.TQ_THI] = NEVER32
    q[ls.TQ_TLO] = NEVER32
    q[ls.TQ_THI, :, 0], q[ls.TQ_TLO, :, 0] = t_hi, t_lo
    d.update(q_thi=q_hi, q_tlo=q_lo, stream=(flows, q, v),
             now_we_hi=np.array(we >> 31, np.int32),
             now_we_lo=np.array(we & MASK31, np.int32),
             rounds=np.array(7, np.int32))
    crafted = ["q_thi", "q_tlo", "now_we_hi", "now_we_lo", "rounds"]
    if planes:
        d.update(min_used_lat=np.array(3_000_000, np.int32),
                 nb_win=np.array(37, np.int32),
                 nb_hist=np.arange(lanes.NB_HIST_BUCKETS, dtype=np.int32))
        crafted += ["min_used_lat", "nb_win", "nb_hist"]
    s_ref = s_ref._replace(**{f: jnp.asarray(d[f]) for f in crafted},
                           stream=s_ref.stream._replace(q=jnp.asarray(q)))
    s_port = bridge.state_from_numpy(d)
    ws = lanes.make_workspace(p, "cpu")
    lanes.queue_min_window_plain(p, s_port, ws, advance)
    s_ref, ctl = _ref_window(rp, s_ref, advance)
    assert ws.ctl.tolist() == ctl
    for f in crafted:
        np.testing.assert_array_equal(getattr(s_port, f).numpy(),
                                      np.asarray(getattr(s_ref, f)),
                                      err_msg=f)
    want_live = case not in ("all_never", "at_stop")
    assert ctl[0] == int(want_live)
    if want_live:
        assert (ctl[2] << 31 | ctl[3]) == T_HEAD


def test_heads_blocks_size_rule():
    """C's cluster: one head a thread of 1,024, at least one block, at most
    16; fixed in ``LaneArgs`` from the [N] lanes and the tier's 2S rows."""
    rule = lanes.heads_blocks
    assert [rule(h) for h in (1, 1024, 1025, 1151, 2048, 2049, 10_000,
                              10_200, 16_384, 16_385, 1 << 20)] == [
        1, 1, 2, 2, 2, 3, 10, 10, 16, 16, 16]
    _, port = _tier_engines(False)
    p = port.params
    args = kernels.LaneArgs(p, port.tables, port.initial_state(),
                            lanes.make_workspace(p, "cpu"))
    assert args.bufs.c_blocks == rule(p.n_lanes + 2 * p.s_flows)
    assert args.bufs.c_blocks == 1  # 12 hosts: a cluster of one


@pytest.mark.parametrize("name, value", [
    ("LOG_CLUSTER", lanes.LOG_CLUSTER), ("LOG_BITS", lanes.LOG_BITS),
    ("LOG_THREADS", lanes.LOG_TILE // lanes.LOG_BITS),
    ("HEAD_THREADS", lanes.HEAD_THREADS),
    ("HEAD_CLUSTER_MAX", lanes.HEAD_CLUSTER_MAX)])
def test_cluster_sizes_are_the_kernels(name, value):
    """The sizes that C's size rule and D's checks (here and in
    ``chip_smoke.py``) take from ``lanes`` are the kernels' own constants
    in ``csrc/lanes.cu``."""
    src = (pathlib.Path(lanes.__file__).parents[1] / "csrc" /
           "lanes.cu").read_text()
    m = re.search(rf"constexpr int {name} = (\d+);", src)
    assert m and int(m.group(1)) == value


# ---- C's hybrid and fused modes on crafted heads --------------------------


def _craft(words, case: str, stop: int):
    """The hybrid configs' random queues with the heads of ``case``: the
    min in the last lane, tied minima in three lanes, every lane empty, or
    every head at the stop time (the rows keep their order)."""
    words = np.stack(words)
    n = words.shape[1]
    hi, lo = words[0], words[1]
    t = np.where(hi == NEVER32, lanes.NEVER,
                 (hi.astype(np.int64) << 31) | lo)
    live = t[:, 0] < lanes.NEVER
    t_min = int(t[live, 0].min())
    if case == "all_never":
        words[0:2] = NEVER32
        return words
    if case == "at_stop":
        t = np.where(t < lanes.NEVER, np.maximum(t, stop), t)
    else:
        lanes_at = [n - 1] if case == "last_lane" else [0, n // 2, n - 1]
        for i in lanes_at:
            if not live[i]:  # a LOCAL tick of the lane's own
                words[2, i, 0] = ((lanes.LOCAL << lanes.AUX_KIND_SHIFT)
                                  | (i << lanes.AUX_SRC_SHIFT))
                words[3, i, 0], words[4, i, 0] = 900_000 + i, 0
            t[i, 0] = t_min - 1
    words[0] = np.where(t >= lanes.NEVER, NEVER32, t >> 31).astype(np.int32)
    words[1] = np.where(t >= lanes.NEVER, NEVER32,
                        t & MASK31).astype(np.int32)
    return words


def _empty_block(p):
    b = p.inject_batch
    return {k: jnp.asarray(v) for k, v in dict(
        valid=np.zeros(b, bool), dst=np.zeros(b, np.int32),
        thi=np.full(b, NEVER32, np.int32), tlo=np.full(b, NEVER32, np.int32),
        auxh=np.zeros(b, np.int32), auxl=np.zeros(b, np.int32),
        size=np.zeros(b, np.int32)).items()}


@pytest.mark.parametrize("case", ["last_lane", "ties", "all_never",
                                  "at_stop"])
def test_hybrid_mode_on_crafted_heads(case, tmp_path):
    """Two device turns (C's hybrid mode: the first step's resets and the
    later steps' stop law) against ``make_hybrid_fn``: the readbacks and
    every LaneState field."""
    ref, port = _engines(tmp_path, extra=", use_dynamic_runahead: true")
    p, rp = port.params, ref.params
    rng = np.random.default_rng(61)
    words = _craft(_random_queues(port, rng, 6_000_000, p.capacity // 2),
                   case, p.stop_time)
    s_ref, s_port = _lift(ref, port, words, 1_000_000)
    run = lanes._build_hybrid_run(p, port.tables, s_port)
    inj_ref, inj_port = _block(p, rng, 30)
    if case in ("all_never", "at_stop"):  # the crafted heads stay the heads
        inj_ref, inj_port = _empty_block(p), None
    for ext_t, used, inj_r, inj_p in ((1_400_000, 900_000, inj_ref,
                                       inj_port if inj_port is None
                                       else inj_port[None]),
                                      (lanes.NEVER, NEVER32,
                                       _empty_block(p), None)):
        eh, el = ((NEVER32, NEVER32) if ext_t >= lanes.NEVER
                  else (ext_t >> 31, ext_t & MASK31))
        s_ref, sc = _ref_turn(rp, ref.tables)(s_ref, eh, el, used, inj_r)
        got = run(ext_t, used, inj_p)
        assert got == np.asarray(sc).tolist(), (case, got)
        _assert_states(s_ref, s_port)
    if case == "all_never":
        assert got[lanes.HYB_LANE_MIN] >= lanes.NEVER
    if case == "at_stop":
        assert got[lanes.HYB_LANE_MIN] == p.stop_time


@pytest.mark.parametrize("case", ["last_lane", "ties"])
def test_fused_mode_on_crafted_heads(case, tmp_path):
    """Two k = 8 fused dispatches over the consuming schedule (each
    consumed window's refold pass re-arms the guard) against
    ``make_hybrid_fused_fn``: the readbacks and every LaneState field."""
    ref, port = _engines(tmp_path, extra=", use_dynamic_runahead: true",
                         down="2 Mbit")
    p, rp = port.params, ref.params
    rng = np.random.default_rng(67)
    words = _craft(_random_queues(port, rng, 12_000_000, p.capacity // 2),
                   case, p.stop_time)
    s_ref, s_port = _lift(ref, port, words, WE0)
    fused = lanes.FusedRun(p, port.tables, s_port, K_CAP, SLOTS)
    ext = SCHEDULES["consume"]
    inj_ref, inj_port = _block(p, rng, 30)
    done = 0
    for inj_r, inj_p, used in ((inj_ref, inj_port[None], 900_000),
                               (_empty_block(p), None, NEVER32)):
        ehi, elo = _ext_pairs(ext)
        s_ref, sc = _ref_fused(rp, ref.tables)(s_ref, ehi, elo, used, inj_r,
                                               np.int32(8))
        got = fused(ext, used, inj_p, 8)
        assert got == np.asarray(sc).tolist(), (case, got)
        _assert_states(s_ref, s_port)
        done += got[lanes.HYB_K_DONE]
    assert done >= 2  # windows consumed: the refold ran
