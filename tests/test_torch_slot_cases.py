"""Kernel A's and kernel G's forms, emulated in plain torch, against their
plain versions.

On the card ``chip_smoke.py`` (``check_slot_cases``) holds the kernels to
``lanes.lane_slots_plain`` and ``lanes.tier_merge_plain`` word for word;
here, at small widths, the arithmetic their new forms rest on is held to
those plain versions, exactly:

- A decides every popped column before it walks: whether the column acts
  (the co-pop prefixes), whether it sends, to whom and at which send and
  re-arm sequence numbers, app draw and mesh offset — exclusive prefix
  counts over the lane's columns, which the kernel takes from a group's
  ballots.  ``_decide`` computes them so and is checked against what
  ``lane_slots_plain``'s serial walk leaves (the pops, the outbound
  block's destinations and sequence numbers, which also carry the loss
  draws, the re-arms' local sequence numbers, the counters), on every
  call of A in passive, active (phold, ping, lossy) and stream runs, and
  on seeded states whose counters wrap past the int32 top mid-row;
- G ranks a row's valid entries as a merge of sorted runs — the queue's
  run (when in key order) and the candidates in runs of 32 — each entry's
  rank its place in its own run plus a binary search of every other run.
  ``_merge_runs`` does so and must give exactly ``tier_merge_plain``'s
  rows, tail records and ``TV_N_QUEUE``: no valid entry, exactly C2, C2 +
  1, every candidate valid, equal keys between the queue and the
  candidates, and an unsorted queue (the kernel's fallback);
- the sorted-run invariant G's fast path uses: after every F step of the
  tiered configs of ``tests/test_torch_tier.py`` (and of a faulted and a
  swept tiered run), each tier queue row's valid entries are one run in
  key order;
- A's size rule (``lanes.slot_group``) and its constant against
  ``csrc/lanes.cu``; G's working memory (``tier_row_words``).
"""

import bisect
import dataclasses
import functools
import pathlib
import re

import numpy as np
import pytest
import torch

from shadow_tpu_torch.backend import kernels, lanes
from shadow_tpu_torch.backend import lanes_stream as ls
from shadow_tpu_torch.backend.gpu_engine import GpuEngine
from shadow_tpu_torch.config import presets as port_presets
from shadow_tpu_torch.config.options import ConfigOptions
from shadow_tpu_torch.core import rng as rng_mod
from shadow_tpu_torch.sweep import SweepEngine, SweepSpec, expand_variants
from test_torch_faults import LOSS_RAMP
from test_torch_tier import CONFIGS as TIER_CONFIGS

NEVER32 = lanes.NEVER32
MASK31 = lanes.MASK31
T0 = 5_000_000_000
i32, i64 = torch.int32, torch.int64


def _wrap32(x):
    """int64 values as the int32 they wrap to."""
    x = x & 0xFFFFFFFF
    return torch.where(x >= 1 << 31, x - (1 << 32), x)


def _excl(mask):
    """[N, K] exclusive prefix counts of a bool mask along the columns."""
    c = torch.cumsum(mask.to(i64), dim=1)
    return c - mask.to(i64)


# ---- A: the decide phase ---------------------------------------------------


def _decide(p, tb, s) -> dict:
    """Kernel A's decide phase, [N, K] a field, from the state before the
    walk: every column's pop, send, destination, sequence numbers and loss
    as prefix counts over the row (the kernel's ballots)."""
    pl = p.lane
    n, k = pl.n_lanes, pl.pops_per_iter
    lane = torch.arange(n, dtype=i64)[:, None]
    col = torch.arange(k)[None, :]
    thi, tlo = s.q_thi[:, :k], s.q_tlo[:, :k]
    kind, src = lanes.unpack_aux_hi(s.q_auxh[:, :k])
    size = s.q_size[:, :k].to(i64)
    t = lanes.t_join(thi, tlo)
    we = int(lanes.t_join(s.now_we_hi, s.now_we_lo))
    model = tb.model[:, None]
    passive = lanes.passive_lanes(tb.model)[:, None]
    ruled = ~passive & (not pl.all_passive)
    not_pkt = torch.cumsum((kind != lanes.PACKET).to(i64), 1) > 0
    local = torch.cumsum((kind == lanes.LOCAL).to(i64), 1) > 0
    not_del = torch.cumsum((kind != lanes.DELIVERY).to(i64), 1) > 0
    same_t = (thi == thi[:, :1]) & (tlo == tlo[:, :1])
    allowed = (col == 0) | (same_t & ~not_pkt)
    stream_lane = ((model == lanes.M_STREAM_CLIENT)
                   | (model == lanes.M_STREAM_SERVER))
    if pl.stream_present and pl.stream_wide_pop:
        prefix = ~local if pl.stream_one_to_one else (~not_pkt | ~not_del)
        allowed = allowed | (stream_lane & prefix)
    act = (~ruled | allowed) & (t < we)
    is_del = act & (kind == lanes.DELIVERY)
    is_loc = act & (kind == lanes.LOCAL)
    is_start, is_timer = is_loc & (size == -1), is_loc & (size >= 0)
    mesh, client = model == lanes.M_TGEN_MESH, model == lanes.M_TGEN_CLIENT
    phold, ping_cl = model == lanes.M_PHOLD, model == lanes.M_PING_CLIENT
    del_phold = is_del & phold
    echo = is_del & (model == lanes.M_PING_SERVER)
    mesh_tick = is_timer & mesh & (n > 1)
    client_tick = is_timer & client
    # a ping tick while the count is under the budget: the first
    # p_count - m_sent timers of the row
    ping_tick = is_timer & ping_cl & (
        s.m_sent[:, None].to(i64) + _excl(is_timer) < tb.p_count[:, None])
    send_phold = del_phold | (is_timer & phold)
    do_send = send_phold | echo | mesh_tick | client_tick | ping_tick
    rearm = ((is_start & (mesh | client | ping_cl)) | mesh_tick | client_tick
             | ping_tick | (is_timer & mesh & (n == 1)))
    snd_seq = _wrap32(s.send_seq[:, None].to(i64) + _excl(do_send))
    arm_seq = _wrap32(s.local_seq[:, None].to(i64) + _excl(rearm))
    draws = _wrap32(s.app_draws[:, None].to(i64) + _excl(send_phold))
    off = _wrap32(s.m_peer_offset[:, None].to(i64)
                  + tb.p_stride[:, None].to(i64) * _excl(mesh_tick))
    nm1 = max(n - 1, 1)
    mesh_dst = (lane + 1 + torch.remainder(off, nm1)) % n
    u = lanes.rand_u32_lane(pl.seed, (lane | rng_mod.APP_STREAM).expand(n, k),
                            draws.to(i32))
    phold_dst = lane.expand(n, k) if n == 1 else (
        lane + 1 + rng_mod.u32_below(u, nm1)) % n
    dst = torch.where(send_phold, phold_dst, torch.where(
        echo, src.to(i64), torch.where(mesh_tick, mesh_dst,
                                       tb.p_peer[:, None].to(i64))))
    lost = torch.zeros_like(do_send)
    if pl.has_loss:
        node = tb.node_of.long()
        thresh = tb.thresh[node[:, None].expand(n, k), node[dst]]
        draw = lanes.rand_u32_lane(
            pl.seed, (lane | rng_mod.LOSS_STREAM).expand(n, k),
            snd_seq.to(i32))
        lost = do_send & (t >= pl.bootstrap_end) & (draw < thresh)
    return {"act": act, "do_send": do_send, "rearm": rearm, "dst": dst,
            "snd_seq": snd_seq, "arm_seq": arm_seq, "lost": lost,
            "send_phold": send_phold, "mesh_tick": mesh_tick,
            "tick": client_tick | ping_tick, "del_phold": del_phold}


def _check_decide(p, tb, s0: dict, s, ws, d: dict) -> None:
    """What ``lane_slots_plain`` left (state ``s``, workspace ``ws``, from
    the fields ``s0`` before it) against the decided columns ``d``.  Lanes
    that own endpoint rows also count their stream arm's sends and RTO arms
    into send_seq and local_seq: their sequence numbers are the walk's."""
    pl = p.lane
    n, k = pl.n_lanes, pl.pops_per_iter
    arm0 = 0 if pl.all_passive else k
    own = torch.ones(n, dtype=torch.bool)
    if pl.stream_present:
        start = tb.lane_ep_start
        own = start[1:] == start[:-1]
    popped = (s0["q_thi"][:, :k] != NEVER32) & (s.q_thi[:, :k] == NEVER32)
    assert torch.equal(popped, d["act"])
    out = d["do_send"] & ~d["lost"]
    assert torch.equal(ws.out_blk[0].T.long(),
                       torch.where(out, d["dst"], n))
    sends = out & own[:, None]
    assert torch.equal(ws.out_blk[4].T.long()[sends], d["snd_seq"][sends])
    assert torch.equal(ws.self_blk[0, :, arm0:arm0 + k] != NEVER32, d["rearm"])
    assert torch.equal(ws.self_blk[3, :, arm0:arm0 + k].long()[own],
                       d["arm_seq"][own])

    def total(f, mask):
        return _wrap32(s0[f].to(i64) + mask.sum(dim=1))

    assert torch.equal(s.app_draws.long(), total("app_draws", d["send_phold"]))
    assert torch.equal(s.m_sent.long(), total("m_sent", d["tick"]))
    assert torch.equal(s.n_hops.long(), total("n_hops", d["del_phold"]))
    assert torch.equal(s.m_peer_offset.long(), _wrap32(
        s0["m_peer_offset"].to(i64)
        + tb.p_stride.to(i64) * d["mesh_tick"].sum(dim=1)))
    for f, mask in (("send_seq", d["do_send"]), ("n_sends", d["do_send"]),
                    ("local_seq", d["rearm"]), ("n_loss", d["lost"])):
        assert torch.equal(s.__getattribute__(f).long()[own],
                           total(f, mask)[own]), f


def _spy_runs(monkeypatch, cfg, mode="step") -> int:
    """Run ``cfg`` on the CPU with every call of A held to ``_decide``;
    returns the calls that popped something."""
    calls = []
    plain = lanes.lane_slots_plain

    def spy(p, tb, s, ws):
        if not int(ws.ctl[0]):
            return plain(p, tb, s, ws)
        s0 = {f: getattr(s, f).clone() for f in (
            "q_thi", "app_draws", "m_sent", "n_hops", "m_peer_offset",
            "send_seq", "n_sends", "local_seq", "n_loss")}
        d = _decide(p, tb, s)
        plain(p, tb, s, ws)
        _check_decide(p, tb, s0, s, ws, d)
        calls.append(int(d["act"].sum()))

    monkeypatch.setattr(lanes, "lane_slots_plain", spy)
    GpuEngine(cfg, device="cpu").run(mode=mode)
    return sum(1 for c in calls if c)


def _switch_doc(models: dict, stop: str = "300ms", loss: float = 0.0) -> dict:
    edge = {"latency": "5 ms", "packet_loss": loss}
    return {
        "general": {"stop_time": stop, "seed": 7},
        "network": {"graph": {"type": "gml", "inline": (
            "graph [ directed 0 node [ id 0 host_bandwidth_up \"10 Mbit\" "
            "host_bandwidth_down \"10 Mbit\" ] edge [ source 0 target 0 "
            f"latency \"{edge['latency']}\" packet_loss {loss} ] ]")}},
        "experimental": {"tpu_events_per_round": 4,
                         "tpu_lane_queue_capacity": 32},
        "hosts": models,
    }


def _cut(cfg, stop: int):
    cfg.general.stop_time = stop
    return cfg


RUNS = {
    "mesh": lambda: port_presets.flagship_mesh_config(
        24, sim_seconds=1, queue_capacity=16, pops_per_round=4),
    "phold": lambda: ConfigOptions.from_dict(_switch_doc({"p": {
        "count": 16, "network_node_id": 0, "processes": [
            {"path": "phold", "args": ["--messages", "3"]}]}}, stop="150ms")),
    "ping_lossy": lambda: ConfigOptions.from_dict(_switch_doc({
        "srv": {"network_node_id": 0, "processes": [{"path": "ping"}]},
        "cli": {"count": 6, "network_node_id": 0, "processes": [{
            "path": "ping", "args": ["--peer", "srv", "--count", "20",
                                     "--interval", "10ms"]}]}}, loss=0.2)),
    "mixed_untiered": lambda: _cut(TIER_CONFIGS["mixed_mesh"](
        port_presets, tiered=False), 500_000_000),
}


@pytest.mark.parametrize("name", list(RUNS))
def test_decide_matches_the_serial_walk_in_runs(name, monkeypatch):
    """Every call of A in a passive mesh, a phold run, a lossy ping run and
    the untiered mixed mesh (stream lanes beside the mesh): the decided
    columns equal what the serial walk left."""
    assert _spy_runs(monkeypatch, RUNS[name]()) > 5


def _seeded(eng, seed: int, top: bool):
    """An active state on the engine's shapes: mixed models over three
    graph nodes (loss thresholds 0, 2**31, 2**32), heads on a coarse grid
    so same-instant prefixes of every kind occur, both sides of the
    bootstrap end; ``top``: counters a few steps below the int32 top."""
    rng = np.random.default_rng(seed)
    p = eng.params
    n, c = p.n_lanes, p.capacity
    p = dataclasses.replace(p, models_present=tuple(range(7)), has_loss=True,
                            bootstrap_end=T0 + 3_000_000, seed=(1 << 64) - 3)
    model = rng.choice([lanes.M_PHOLD, lanes.M_PING_CLIENT,
                        lanes.M_PING_SERVER, lanes.M_TGEN_MESH,
                        lanes.M_TGEN_CLIENT, lanes.M_NONE], n)
    g = 3
    thresh = np.array([[0, 1 << 31, 1 << 32], [1 << 32, 0, 1 << 31],
                       [1 << 31, 1 << 32, 0]], dtype=np.int64)
    tb = eng.tables._replace(
        model=torch.as_tensor(model, dtype=i32),
        node_of=torch.as_tensor(rng.integers(0, g, n), dtype=i32),
        lat=torch.as_tensor(rng.integers(1_000_000, 9_000_000, (g, g)),
                            dtype=i32),
        thresh=torch.as_tensor(thresh),
        p_peer=torch.as_tensor(rng.integers(0, n, n), dtype=i32),
        p_stride=torch.as_tensor(rng.integers(1, 4, n), dtype=i32),
        p_count=torch.as_tensor(rng.integers(0, 6, n), dtype=i32))
    s = eng.initial_state()
    col = np.arange(c)[None, :]
    fill = rng.integers(0, c + 1, (n, 1))
    times = np.where(col < fill, T0 + rng.integers(0, 4, (n, c)) * 1_000_000,
                     lanes.NEVER)
    kind = rng.choice([lanes.PACKET, lanes.DELIVERY, lanes.LOCAL], (n, c))
    lane = np.arange(n)[:, None]
    src = np.where(kind == lanes.LOCAL, lane, rng.integers(0, n, (n, c)))
    auxh = (kind << lanes.AUX_KIND_SHIFT) | (src << lanes.AUX_SRC_SHIFT)
    auxl = col + rng.integers(0, 1 << 20, (n, 1)) * c
    size = np.where(kind == lanes.LOCAL, rng.choice([-1, 0, 0], (n, c)),
                    rng.integers(28, 1500, (n, c)))
    order = np.lexsort((auxl, auxh, times), axis=1)
    times, auxh, auxl, size = (np.take_along_axis(a, order, axis=1)
                               for a in (times, auxh, auxl, size))
    never = times == lanes.NEVER
    we = T0 + 3_500_000
    near = (1 << 31) - 1 - rng.integers(0, p.pops_per_iter + 1, n)

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=i32)

    pick = (lambda a: t(np.where(rng.random(n) < 0.5, near, a))) if top else t
    s = s._replace(
        q_thi=t(np.where(never, NEVER32, times >> 31)),
        q_tlo=t(np.where(never, NEVER32, times & MASK31)),
        q_auxh=t(auxh), q_auxl=t(auxl), q_size=t(size),
        send_seq=pick(rng.integers(0, 99, n)),
        app_draws=pick(rng.integers(0, 99, n)),
        local_seq=pick(rng.integers(0, 99, n)),
        m_peer_offset=pick(rng.integers(0, 99, n)),
        m_sent=t(rng.integers(0, 6, n)),
        now_we_hi=t(we >> 31).reshape(()),
        now_we_lo=t(we & MASK31).reshape(()))
    return p, tb, s


@pytest.mark.parametrize("k", [1, 3, 8, 40])
@pytest.mark.parametrize("top", [False, True])
def test_decide_on_seeded_states(k, top):
    """Seeded active states at K = 1, 3, 8 and 40 (past a warp's 32
    columns), the counters below the int32 top or wrapping past it
    mid-row: the decided columns equal the serial walk's."""
    cfg = ConfigOptions.from_dict(_switch_doc({"p": {
        "count": 40, "network_node_id": 0, "processes": [
            {"path": "phold", "args": ["--messages", "3"]}]}}))
    cfg.experimental.tpu_events_per_round = k
    cfg.experimental.tpu_lane_queue_capacity = 48
    eng = GpuEngine(cfg, device="cpu")
    for seed in range(3):
        p, tb, s = _seeded(eng, 100 * k + seed, top)
        ws = lanes.make_workspace(p, "cpu")
        s0 = {f: getattr(s, f).clone() for f in (
            "q_thi", "app_draws", "m_sent", "n_hops", "m_peer_offset",
            "send_seq", "n_sends", "local_seq", "n_loss")}
        d = _decide(p, tb, s)
        lanes.lane_slots_plain(p, tb, s, ws)
        _check_decide(p, tb, s0, s, ws, d)
        assert int(d["act"].sum()) and int(d["do_send"].sum())


# ---- G: a merge of sorted runs ----------------------------------------------


def _key(e, pos: int) -> tuple:
    """An entry's (key, index) as a tuple of signed words."""
    return (int(e[0]), int(e[1]), int(e[2]), int(e[3]), pos)


def _merge_runs(p, s, ws, lane_of) -> dict:
    """Kernel G's merge, row by row: the valid entries of [queue C2 |
    W_t candidates] in index order; the queue's run whole when its keys are
    in order (else in runs of 32, as the candidates are), each run sorted;
    an entry's rank is its place in its run plus, for each other run, the
    count of its entries below the entry (a binary search).  ``lane_of``:
    each row's lane.  Returns the new queue rows [7, 2S, C2], the tail's
    records and flags and the overflow per row."""
    c2 = p.stream_capacity
    merged = torch.cat([s.stream.q, lanes._tier_candidates(p, ws)], dim=2)
    words, s2, total = merged.shape
    wt = total - c2
    rows = torch.zeros((words, s2, c2), dtype=i32)
    rows[:2] = NEVER32
    recs = torch.zeros((s2, wt, 6), dtype=i64)
    flags = torch.zeros((s2, wt), dtype=i32)
    over = torch.zeros(s2, dtype=i32)
    for r in range(s2):
        row = merged[:, r]
        valid = [x for x in range(total) if int(row[0, x]) != NEVER32]
        ent = [row[:, x] for x in valid]
        keys = [_key(e, pos) for pos, e in enumerate(ent)]
        n_q = sum(1 for x in valid if x < c2)
        q_sorted = all(keys[a + 1] > keys[a] for a in range(n_q - 1))
        first = n_q if q_sorted else 0
        runs = ([(0, first)] if first else []) + [
            (a, min(a + 32, len(ent))) for a in range(first, len(ent), 32)]
        sorted_runs = [sorted(keys[a:b]) for a, b in runs]
        for ri, (a, b) in enumerate(runs):
            for place, kv in enumerate(sorted_runs[ri]):
                rank = place + sum(bisect.bisect_left(other, kv)
                                   for oi, other in enumerate(sorted_runs)
                                   if oi != ri)
                e = ent[kv[4]]
                if rank < c2:
                    rows[:, r, rank] = e
                else:
                    src = (int(e[2]) >> lanes.AUX_SRC_SHIFT) & ((1 << 17) - 1)
                    recs[r, rank - c2] = torch.tensor([
                        (int(e[0]) << 31) | int(e[1]), src,
                        int(lane_of[r]), int(e[3]), int(e[4]),
                        lanes.DROP_QUEUE])
                    flags[r, rank - c2] = 1
        over[r] = max(len(ent) - c2, 0)
    return {"rows": rows, "recs": recs, "flags": flags, "over": over}


G_CASES = ("empty", "exact", "over1", "all", "ties", "unsorted", "random")


def _g_inputs(p, s, ws, case: str, seed: int) -> None:
    """G's inputs for every row by ``case`` (as ``chip_smoke.py``'s
    ``g_inputs``): the queue rows and the candidate block; invalid entries
    keep stale words."""
    rng = np.random.default_rng(seed)
    sf, c2, ks, cx = p.s_flows, p.stream_capacity, p.stream_pops, p.cross_cap
    s2, wt, nb = 2 * sf, p.tier_width, ks * lanes.PUMP_BURST
    sa0, se0, bo0, cx0, _end = p.tier_layout
    q = rng.integers(-(1 << 31), 1 << 31, (7, s2, c2))
    q[:2] = NEVER32
    cand = rng.integers(-(1 << 31), 1 << 31, (7, s2, wt))
    cand[:2] = NEVER32

    def keys(m: int):
        t = T0 + rng.integers(0, 6, m) * 250_000
        kind = rng.choice([lanes.PACKET, lanes.DELIVERY, lanes.LOCAL], m)
        auxh = kind << 29 | rng.integers(0, 4, m) << 12
        return np.stack([t >> 31, t & MASK31, auxh, rng.integers(-3, 3, m),
                         rng.integers(28, 1500, m),
                         rng.integers(-(1 << 31), 1 << 31, m),
                         rng.integers(-(1 << 31), 1 << 31, m)])

    for r in range(s2):
        slots = np.arange(wt)
        if r < sf:  # a client row's bursts are empty
            slots = slots[(slots < 3 * ks) | (slots >= 3 * ks + nb)]
        n_q = {"empty": 0, "exact": c2 // 2, "over1": c2 // 2, "all": c2,
               "ties": c2 // 2, "unsorted": c2 // 2}.get(
            case, int(rng.integers(0, c2 + 1)))
        n_c = {"empty": 0, "exact": c2 - n_q, "over1": c2 - n_q + 1,
               "all": len(slots), "ties": min(12, len(slots)),
               "unsorted": 12}.get(case, int(rng.integers(0, 2 * c2)))
        n_c = min(n_c, len(slots))
        qk = keys(n_q)
        order = np.lexsort((qk[3].astype(np.int32), qk[2].astype(np.int32),
                            (qk[0] << 31) | qk[1]))
        qk = qk[:, order]
        if case == "unsorted" and n_q > 1:
            qk = qk[:, ::-1]
        q[:, r, :n_q] = qk
        ck = keys(n_c)
        if case == "ties" and n_q:
            ck[:4] = qk[:4, rng.integers(0, n_q, n_c)]
        cand[:, r, rng.choice(slots, n_c, replace=False)] = ck
    blk = ws.tier_blk.numpy().copy()
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
    ws.tier_blk.copy_(torch.as_tensor(blk, dtype=i32))
    s.stream.q.copy_(torch.as_tensor(q, dtype=i32))


@functools.lru_cache(maxsize=None)
def _tier_engine():
    """The tiered mixed mesh of ``tests/test_torch_tier.py`` at C2 = 24 and
    K_s = 4 (4 endpoint rows of 24 + 112 entries), logging."""
    cfg = TIER_CONFIGS["mixed_mesh"](port_presets)
    cfg.experimental.tpu_stream_queue_capacity = 24
    cfg.experimental.tpu_stream_events_per_round = 4
    return GpuEngine(cfg, device="cpu", log_capacity=10_000)


@pytest.mark.parametrize("case", G_CASES)
def test_merge_of_sorted_runs_matches_tier_merge_plain(case):
    eng = _tier_engine()
    p = eng.params
    s = eng.initial_state()
    ws = lanes.make_workspace(p, "cpu")
    _g_inputs(p, s, ws, case, seed=G_CASES.index(case))
    want = _merge_runs(p, s, ws, eng.tables.flow_lanes)
    v0 = s.stream.v[ls.TV_N_QUEUE].clone()
    lanes.tier_merge_plain(p, eng.tables, s, ws)
    assert torch.equal(s.stream.q, want["rows"])
    tg = p.tier_rec_offsets
    assert torch.equal(ws.recs[tg.tail:tg.end].reshape(want["recs"].shape),
                       want["recs"])
    assert torch.equal(ws.rec_valid[tg.tail:tg.end].reshape(
        want["flags"].shape), want["flags"])
    assert torch.equal(s.stream.v[ls.TV_N_QUEUE] - v0, want["over"])
    c2 = p.stream_capacity
    expect = {"empty": 0, "exact": 0, "over1": 1}
    if case in expect:
        assert want["over"].tolist() == [expect[case]] * 2 * p.s_flows
    if case == "all":
        assert int(want["over"].min()) > 0 and c2 == 24


# ---- the sorted-run invariant -----------------------------------------------


def _sorted_runs_after_f(monkeypatch) -> list:
    """Check, after every call of F's plain version, that each tier queue
    row's valid entries are in key order; returns the rows' valid counts."""
    seen = []
    plain = lanes.stream_tier_plain

    def spy(p, tb, s, ws):
        plain(p, tb, s, ws)
        q = s.stream.q
        valid = q[0] != NEVER32
        # each row's valid entries in index order, then its adjacent pairs
        order = torch.argsort((~valid).to(torch.int8), dim=1, stable=True)
        key = torch.stack([torch.gather(q[w], 1, order) for w in range(4)],
                          dim=2)
        a, b = key[:, :-1], key[:, 1:]
        after = torch.zeros(a.shape[:2], dtype=torch.bool)
        for w in range(3, -1, -1):  # a > b, lexicographic on signed words
            after = (a[..., w] > b[..., w]) | (
                (a[..., w] == b[..., w]) & after)
        count = valid.sum(dim=1)[:, None]
        pairs = torch.arange(a.shape[1])[None, :] + 1 < count
        assert not bool((after & pairs).any())
        seen.append(int(valid.sum(dim=1).max()))

    monkeypatch.setattr(lanes, "stream_tier_plain", spy)
    return seen


@pytest.mark.parametrize("name", list(TIER_CONFIGS))
def test_tier_rows_stay_one_sorted_run(name, monkeypatch):
    """After every F step of each tiered config (step mode), each tier
    queue row's valid entries form one run in key order."""
    seen = _sorted_runs_after_f(monkeypatch)
    cfg = TIER_CONFIGS[name](port_presets)
    cfg.general.stop_time = min(cfg.general.stop_time, 1_000_000_000)
    GpuEngine(cfg, device="cpu").run(mode="step")
    assert seen and max(seen) > 1


def test_tier_rows_stay_sorted_faulted_and_swept(monkeypatch):
    """The same on a faulted tiered pair (``test_torch_faults``'s loss
    ramp, device mode) and on a batched sweep of two tiered lossy pairs."""
    seen = _sorted_runs_after_f(monkeypatch)
    cfg = ConfigOptions.from_yaml(LOSS_RAMP)
    cfg.general.stop_time = 200_000_000  # the ramp ends at 60 ms
    GpuEngine(cfg, device="cpu").run(mode="device")
    cfg = TIER_CONFIGS["lossy_pair"](port_presets)
    cfg.general.stop_time = 300_000_000
    SweepEngine(expand_variants(cfg, SweepSpec(seeds=[1, 2])),
                device="cpu").run()
    assert seen and max(seen) > 1


# ---- the size rules ---------------------------------------------------------


def test_slot_group_size_rule():
    """A's form: two columns a thread from K = 4 on, 2 threads at K = 2
    and 3, one at K = 1, at most a warp; fixed in ``LaneArgs``."""
    rule = lanes.slot_group
    assert [rule(k) for k in (1, 2, 3, 4, 5, 8, 9, 16, 40, 64, 100)] == [
        1, 2, 2, 2, 2, 4, 4, 8, 32, 32, 32]
    eng = _tier_engine()
    p = eng.params
    args = kernels.LaneArgs(p, eng.tables, eng.initial_state(),
                            lanes.make_workspace(p, "cpu"))
    assert args.bufs.slot_group == rule(p.pops_per_iter)


def test_tier_row_words():
    """G's working memory a row: the valid entries' seven words and their
    order, two words a chunk of 32; ``merge_rows`` sizes the shared-memory
    rule and ``m_scratch`` by it."""
    assert lanes.tier_row_words(504) == 8 * 504 + 2 * 16
    assert lanes.tier_row_words(8_840) == 8 * 8_840 + 2 * 277
    _rows, entries, words, extra = lanes.merge_rows(
        _tier_engine().params)["tier merge"]
    assert words == 7
    assert 4 * words * entries + extra == 4 * lanes.tier_row_words(entries)


def test_slot_group_max_is_the_kernels():
    """The widest group A's rule gives is the kernel's own constant in
    ``csrc/lanes.cu``."""
    src = (pathlib.Path(lanes.__file__).parents[1] / "csrc" /
           "lanes.cu").read_text()
    m = re.search(r"constexpr int SLOT_GROUP_MAX = (\d+);", src)
    assert m and int(m.group(1)) == lanes.SLOT_GROUP_MAX
