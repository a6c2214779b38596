"""Kernel E's and kernel H's forms, emulated in plain torch and Python,
against their plain versions and the reference.

On the card ``chip_smoke.py`` (``check_row_cases``) holds the kernels to
``lanes.stream_rows_merge_plain`` and ``lanes.inject_merge_plain`` word
for word; here, at small widths, the arithmetic their forms rest on is
held to those plain versions, exactly:

- E merges a row [queue C | W_s candidates] as runs: the queue row, one
  run when its keys are in order (else runs of 32), the candidates whose
  key words are the canonical empty's, counted and placed in index order
  from a closed form, and the rest compacted after the queue, one run when
  in order, else runs of 32.  An entry's rank is its place in its own run
  plus, for every other run, the count of that run's entries below it.
  ``_merge_of_runs`` does so on every E call of ``tests/test_torch_stream
  .py``'s untiered configs and on seeded edge rows (an unsorted queue,
  non-canonical empties on both sides, keys equal across them, overflow
  with a log and flowtrace, all-empty rows);
- H takes a lane's group in index order (or in the counting sort's
  arbitrary order: the same result), keeps its Cxi smallest by (time,
  aux, index) in batches of 32, and merges that run and the canonical
  empties after it with the queue row the same way; a lane with no group
  moves only the queue entries keyed above the canonical empty.  Held to
  ``inject_merge_plain`` and the reference's ``_inject_merge`` (by counts
  where the reference's unstable sort leaves the survivors undefined) on
  groups of 0, 1, 31, 32, 33, Cxi, Cxi + 1 and 400 rows;
- the premise of both fast paths: the queue rows entering E (every
  iteration of the untiered stream runs, step and device mode, a faulted
  and a swept run) and entering H (before every injection of hybrid runs,
  on the one-window and the fused law, after a fused rollback's restore
  too) are in (key, index) order;
- the size rules in ``lanes.merge_rows`` against the kernels' working
  memory (``split_row_words``, ``inject_row_words`` in ``csrc/lanes.cu``).
"""

import bisect
import functools
import pathlib
import re

import jax
import numpy as np
import pytest
import torch

from shadow_tpu.backend import lanes as ref_lanes
from shadow_tpu_torch.backend import lanes
from shadow_tpu_torch.backend.gpu_engine import GpuEngine
from shadow_tpu_torch.backend.hybrid import HybridEngine
from shadow_tpu_torch.config import presets as port_presets
from shadow_tpu_torch.config.options import ConfigOptions
from shadow_tpu_torch.sweep import SweepEngine, SweepSpec, expand_variants
from test_torch_faults import LOSS_RAMP
from test_torch_hybrid import (_assert_states, _block, _engines, _lift,
                               _random_queues, native_build)  # noqa: F401
from test_torch_hybrid_fused import CONFIGS as FUSED_CONFIGS
from test_torch_stream import CONFIGS as STREAM_CONFIGS

NEVER32 = lanes.NEVER32
MASK31 = lanes.MASK31
K0 = (NEVER32, NEVER32, 0, 0)
ABOVE_ALL = float("inf")  # an index past every entry's
T0 = 5_000_000_000
i32, i64 = torch.int32, torch.int64


# ---- the merge of runs ------------------------------------------------------


def _in_order(keys) -> bool:
    return all(a < b for a, b in zip(keys, keys[1:]))


def _split_runs(keys, one: bool) -> list:
    """A part's runs: the whole part when ``one``, else runs of 32 in
    index order; each sorted."""
    if not keys:
        return []
    if one:
        return [list(keys)]
    return [sorted(keys[a:a + 32]) for a in range(0, len(keys), 32)]


def _merge_of_runs(ent: list, n0: int, rest_one, n_canon: int) -> dict:
    """The kernels' merge of a row: ``ent`` the stored entries (the queue
    [0, n0), then the rest), each a list of words, an entry's index its
    position; ``n_canon`` canonical empties counted beside them.  The
    queue is one run when in order, the rest when ``rest_one`` (None: when
    in order).  Returns each stored entry's rank, the canonical empties'
    base and whether each part was one run."""
    keys = [tuple(e[:4]) + (x,) for x, e in enumerate(ent)]
    q_one = _in_order(keys[:n0])
    if rest_one is None:
        rest_one = _in_order(keys[n0:])
    runs = _split_runs(keys[:n0], q_one) + _split_runs(keys[n0:], rest_one)
    probe = K0 + (ABOVE_ALL,)
    base = sum(bisect.bisect_left(run, probe) for run in runs)
    rank = [0] * len(ent)
    for ri, run in enumerate(runs):
        for place, kv in enumerate(run):
            rank[kv[4]] = (place + (n_canon if kv[:4] > K0 else 0) + sum(
                bisect.bisect_left(other, kv)
                for oi, other in enumerate(runs) if oi != ri))
    return {"rank": rank, "base": base, "q_one": q_one, "rest_one": rest_one}


def _place(ent: list, m: dict, canon: list, width: int) -> list:
    """The merged row of ``width`` entries: each stored entry at its rank,
    the j-th canonical empty at base + j; every rank taken once."""
    out = [None] * width
    for e, r in zip(ent, m["rank"]):
        assert out[r] is None
        out[r] = e
    for j, e in enumerate(canon):
        assert out[m["base"] + j] is None
        out[m["base"] + j] = e
    assert all(e is not None for e in out)
    return out


def _moved(qrow: list, m: dict) -> int:
    """Queue positions the kernel writes: those whose entry is not the
    queue entry that was there."""
    c = len(qrow)
    stay = sum(1 for x in range(c) if m["rank"][x] == x)
    return c - stay


# ---- E ------------------------------------------------------------------------


def _split_source(p, r: int, x: int) -> int:
    """The stream block entry that candidate x of endpoint row r takes, or
    -1 (a client row's padding): csrc/lanes.cu ``split_source``."""
    k, sf = p.pops_per_iter, p.s_flows
    s2 = 2 * sf
    client = r < sf
    if x < k:
        return x * s2 + (r + sf if client else r - sf)
    if x < 2 * k:
        return k * s2 + (x - k) * s2 + r
    return -1 if client else 4 * k * sf + (x - 2 * k) * sf + (r - sf)


def _e_emulate(p, tb, s, ws) -> dict:
    """Kernel E's form on one call's inputs: the new queue rows of the
    endpoint lanes, the split tail's records, flags and flow records, the
    overflow a row, and what the fast path saw."""
    c, ws_ = p.capacity, p.stream_row_width
    s2 = 2 * p.s_flows
    el = tb.flow_lanes.long()
    q = torch.stack([w[el] for w in lanes._queue_words(p, s)]).tolist()
    cand = torch.stack(lanes._stream_candidates(p, tb, ws)).tolist()
    rows = torch.empty((7, s2, c), dtype=i32)
    tail = torch.empty((7, s2, ws_), dtype=i32)
    seen = {"q_unsorted": 0, "rest_unsorted": 0, "canon": 0, "rest": 0,
            "moved": 0}
    for r in range(s2):
        qrow = [[q[w][r][x] for w in range(7)] for x in range(c)]
        crow = [[cand[w][r][x] for w in range(7)] for x in range(ws_)]
        # the kernel's layout of the candidates
        for x in range(ws_):
            assert (_split_source(p, r, x) < 0) == (
                r < p.s_flows and x >= 2 * p.pops_per_iter)
        canon = [e for e in crow if tuple(e[:4]) == K0]
        rest = [e for e in crow if tuple(e[:4]) != K0]
        m = _merge_of_runs(qrow + rest, c, None, len(canon))
        out = _place(qrow + rest, m, canon, c + ws_)
        rows[:, r] = torch.tensor(out[:c], dtype=i32).T
        tail[:, r] = torch.tensor(out[c:], dtype=i32).T
        seen["q_unsorted"] += not m["q_one"]
        seen["rest_unsorted"] += not m["rest_one"]
        seen["canon"] += len(canon)
        seen["rest"] += len(rest)
        seen["moved"] += _moved(qrow, m)
    valid = tail[0] != NEVER32
    src = (tail[2] >> lanes.AUX_SRC_SHIFT) & ((1 << lanes.AUX_SRC_BITS) - 1)
    dst = el[:, None].expand(s2, ws_)
    rec = torch.stack([lanes.t_join(tail[0], tail[1]), src.long(), dst,
                       tail[3].long(), tail[4].long(),
                       torch.full_like(dst, lanes.DROP_QUEUE)], dim=2)
    rec = torch.where(valid[:, :, None], rec, 0)
    kind = tail[2] >> lanes.AUX_KIND_SHIFT
    shed = valid & (kind == lanes.PACKET) & lanes._flow_sampled(
        p, src, dst.to(i32))
    return {"rows": rows, "recs": rec.reshape(-1, 6),
            "flags": valid.reshape(-1).to(i32), "shed": shed.reshape(-1),
            "flow": (tail[0], tail[1], src, dst.to(i32), tail[3], tail[4]),
            "over": valid.sum(dim=1, dtype=i32), "seen": seen}


def _q_sorted(p, s, lanes_=None) -> bool:
    """Every queue row (of ``lanes_``) in (key, index) order: each row
    equal to its stable sort by the key."""
    q = lanes._queue_words(p, s)[:4]
    if lanes_ is not None:
        q = [w[lanes_] for w in q]
    perm = lanes._key_order(*q)
    return bool((perm == torch.arange(perm.shape[1])[None, :]).all())


def _check_e_call(p, tb, s, ws) -> dict:
    """E's form against the plain version on one call (both from the same
    inputs); returns what the fast path saw."""
    want = _e_emulate(p, tb, s, ws)
    el = tb.flow_lanes.long()
    nq0 = s.n_queue[el].clone()
    lanes.stream_rows_merge_plain(p, tb, s, ws)
    for w, plane in enumerate(lanes._queue_words(p, s)):
        assert torch.equal(plane[el], want["rows"][w]), w
    assert torch.equal(s.n_queue[el] - nq0, want["over"])
    n = 2 * p.s_flows * p.stream_row_width
    rg = p.rec_offsets
    # the kernel's tail group: rec_slots - 2S W_s + r W_s
    assert rg.split == rg.slots - n
    if p.log_capacity:
        assert torch.equal(ws.recs[rg.split:rg.slots], want["recs"])
        assert torch.equal(ws.rec_valid[rg.split:rg.slots], want["flags"])
    if p.flowtrace:
        fg = p.flow_offsets
        assert fg.split + n == fg.slots
        got = ws.fl_valid[fg.split:fg.slots].bool()
        assert torch.equal(got, want["shed"])
        rows = ws.fl_recs[fg.split:fg.slots][got]
        th, tl, src, dst, seq, size = (t.reshape(-1)[want["shed"]]
                                       for t in want["flow"])
        assert torch.equal(rows[:, 0], th) and torch.equal(rows[:, 1], tl)
        assert bool((rows[:, 2] == lanes.ftr.FT_DROP).all())
        for col, t in ((3, src), (4, dst), (5, seq), (6, size)):
            assert torch.equal(rows[:, col], t.to(i32))
        assert bool((rows[:, 7] == lanes.ftr.CAUSE_QUEUE).all())
    return want["seen"]


def _spy_e(monkeypatch, emulate: bool = True) -> list:
    """Hold every live call of E's plain version to the premise (its
    endpoint lanes' queue rows sorted) and, with ``emulate``, to E's
    form; returns what each call saw."""
    calls = []
    plain = lanes.stream_rows_merge_plain

    def spy(p, tb, s, ws):
        if not int(ws.ctl[0]):
            return plain(p, tb, s, ws)
        assert _q_sorted(p, s, tb.flow_lanes.long())
        if not emulate:
            calls.append(None)
            return plain(p, tb, s, ws)
        monkeypatch.setattr(lanes, "stream_rows_merge_plain", plain)
        try:
            calls.append(_check_e_call(p, tb, s, ws))
        finally:
            monkeypatch.setattr(lanes, "stream_rows_merge_plain", spy)

    monkeypatch.setattr(lanes, "stream_rows_merge_plain", spy)
    return calls


E_RUNS = [("pair", "step"), ("pair", "device"), ("lossy_pair", "step"),
          ("cubic_pair", "device"), ("mixed_mesh", "device")]


@pytest.mark.parametrize("name,mode", E_RUNS,
                         ids=[f"{n}-{m}" for n, m in E_RUNS])
def test_e_form_on_every_call_of_the_untiered_stream_runs(name, mode,
                                                          monkeypatch):
    """Every E call of an untiered config of ``test_torch_stream.py``: the
    form equals the plain version, its queue rows entering sorted."""
    cfg = STREAM_CONFIGS[name](port_presets)
    cfg.general.stop_time = min(cfg.general.stop_time, 150_000_000)
    calls = _spy_e(monkeypatch)
    GpuEngine(cfg, device="cpu", log_capacity=50_000).run(mode=mode)
    assert len(calls) > 20
    assert not any(c["q_unsorted"] for c in calls)
    assert sum(c["rest"] for c in calls) > 0


def test_e_premise_faulted_and_swept(monkeypatch):
    """The queue rows entering E are sorted on a faulted untiered run
    (``test_torch_faults``'s loss ramp) and on a batched sweep of two
    untiered lossy pairs."""
    calls = _spy_e(monkeypatch, emulate=False)
    cfg = ConfigOptions.from_yaml(LOSS_RAMP)
    cfg.experimental.tpu_stream_tiered = False
    cfg.general.stop_time = 200_000_000  # the ramp ends at 60 ms
    GpuEngine(cfg, device="cpu").run(mode="device")
    faulted = len(calls)
    cfg = STREAM_CONFIGS["lossy_pair"](port_presets)
    cfg.general.stop_time = 300_000_000
    SweepEngine(expand_variants(cfg, SweepSpec(seeds=[1, 2])),
                device="cpu").run()
    assert faulted > 20 and len(calls) > faulted


@functools.lru_cache(maxsize=None)
def _e_engine():
    """The untiered mixed mesh of ``test_torch_stream.py`` (12 hosts, two
    pairs, C = 96, K = 4: rows of 96 + 104 entries), logging, every flow
    traced."""
    cfg = STREAM_CONFIGS["mixed_mesh"](port_presets)
    cfg.experimental.flowtrace = True
    cfg.experimental.flowtrace_sample = 1.0
    eng = GpuEngine(cfg, device="cpu", log_capacity=10_000)
    assert eng.params.split and eng.params.flowtrace
    return eng


E_CASES = ("unsorted", "noncanonical", "ties", "overflow", "empty", "random")


def _entries(rng, m: int, t0: int = T0) -> np.ndarray:
    """``m`` valid entries [7, m]: PACKETs, DELIVERYs and LOCALs at a few
    instants, aux words that tie now and then."""
    t = t0 + rng.integers(0, 6, m) * 250_000
    kind = rng.choice([lanes.PACKET, lanes.DELIVERY, lanes.LOCAL], m)
    return np.stack([t >> 31, t & MASK31,
                     kind << 29 | rng.integers(0, 12, m) << 12,
                     rng.integers(-3, 3, m), rng.integers(28, 1500, m),
                     rng.integers(0, 1 << 30, m), rng.integers(0, 1 << 20, m)])


def _sorted_entries(e: np.ndarray) -> np.ndarray:
    order = np.lexsort((e[3].astype(np.int32), e[2].astype(np.int32),
                        (e[0] << 31) | e[1]))
    return e[:, order]


def _e_inputs(p, tb, s, ws, case: str, seed: int) -> None:
    """E's inputs by ``case``: each endpoint lane's queue row and the
    stream block entries the static layout gives its row."""
    rng = np.random.default_rng(seed)
    c, ws_, s2 = p.capacity, p.stream_row_width, 2 * p.s_flows
    el = tb.flow_lanes.tolist()
    empty = np.array([NEVER32, NEVER32, 0, 0, 0, 0, 0])[:, None]
    sx = ws.sx_blk.numpy().copy()
    sx[0] = p.n_lanes
    sx[1:] = empty
    q = [w.numpy().copy() for w in lanes._queue_words(p, s)]
    for r in range(s2):
        n_q = {"empty": 0, "overflow": c - 3, "unsorted": c // 2}.get(
            case, int(rng.integers(0, c + 1)))
        row = np.repeat(empty, c, axis=1)
        qe = _sorted_entries(_entries(rng, n_q))
        if case == "unsorted":
            qe = qe[:, ::-1]
        row[:, :n_q] = qe
        if case == "noncanonical":
            # consumed entries: the NEVER time, their aux words kept, at
            # the row's end (where B's sort leaves them)
            stale = _entries(rng, c - n_q)
            stale[:2] = NEVER32
            stale[2] = np.abs(stale[2])
            row[:, n_q:] = _sorted_entries(stale)
        for w in range(7):
            q[w][el[r]] = row[w]
        slots = [x for x in range(ws_) if _split_source(p, r, x) >= 0]
        n_c = {"empty": 0, "overflow": len(slots), "ties": 12}.get(
            case, int(rng.integers(0, len(slots) + 1)))
        n_c = min(n_c, len(slots))
        ce = _entries(rng, n_c)
        if case == "ties" and n_q:
            ce[:4] = qe[:4, rng.integers(0, n_q, n_c)]
        if case == "noncanonical":
            # NEVER entries with stale words, and canonical keys with
            # stale size and payload words
            ce[:2, : n_c // 3] = NEVER32
            ce[:4, n_c // 3: 2 * n_c // 3] = empty[:4]
        for x, e in zip(rng.choice(slots, n_c, replace=False), ce.T):
            idx = _split_source(p, r, x)
            sx[0, idx] = el[r]
            sx[1:, idx] = e
    ws.sx_blk.copy_(torch.as_tensor(sx, dtype=i32))
    for w, plane in zip(q, lanes._queue_words(p, s)):
        plane.copy_(torch.as_tensor(w, dtype=i32))


@pytest.mark.parametrize("case", E_CASES)
def test_e_form_on_seeded_edge_rows(case):
    eng = _e_engine()
    p, tb = eng.params, eng.tables
    s = eng.initial_state()
    ws = lanes.make_workspace(p, "cpu")
    _e_inputs(p, tb, s, ws, case, seed=E_CASES.index(case))
    ws.recs.fill_(7)  # stale words the merge must overwrite
    ws.rec_valid.fill_(1)
    ws.fl_valid.fill_(1)
    seen = _check_e_call(p, tb, s, ws)
    over = int(s.n_queue.sum())
    if case == "unsorted":
        assert seen["q_unsorted"] == 2 * p.s_flows
    if case == "empty":
        assert seen["rest"] == 0 and seen["moved"] == 0 and over == 0
    if case == "overflow":
        assert over > 0 and int(ws.fl_valid.sum()) > 0
    if case == "noncanonical":
        assert seen["moved"] > 0 and seen["canon"] > 0


# ---- H ------------------------------------------------------------------------


def _group(inj: torch.Tensor, lane: int, order=None) -> list:
    """A lane's group of the block: its rows in index order (the ballots),
    or permuted by ``order`` (the counting sort's placement)."""
    rows = torch.nonzero((inj[0] != 0) & (inj[1] == lane)).flatten().tolist()
    if order is not None:
        rows = list(order.permutation(rows)) if rows else rows
    return rows


def _keep_smallest(keyed: list, cxi: int) -> list:
    """The kernel's selection: batches of 32, each sorted and merged by
    counts into the Cxi smallest so far."""
    kept = []
    for b0 in range(0, len(keyed), 32):
        batch = sorted(keyed[b0:b0 + 32])
        out = [None] * (len(kept) + len(batch))
        for j, kv in enumerate(kept):
            out[j + bisect.bisect_left(batch, kv)] = kv
        for j, kv in enumerate(batch):
            out[j + bisect.bisect_left(kept, kv)] = kv
        kept = out[:cxi]
    return kept


def _h_emulate(p, s, inj: torch.Tensor, order=None) -> dict:
    """Kernel H's form on one block: the new queue words [W, N, C], the
    n_queue and nb_shed additions, and what the fast path saw."""
    n, c, cxi, words = p.n_lanes, p.capacity, p.inject_cap, p.words
    q = torch.stack(lanes._queue_words(p, s)).tolist()
    blk = inj.tolist()
    out = torch.stack(lanes._queue_words(p, s)).clone()
    add = torch.zeros(n, dtype=i32)
    shed = torch.zeros(n, dtype=i32)
    seen = {"q_unsorted": 0, "idle": 0, "shifted": 0, "moved": 0}
    empty = [NEVER32, NEVER32, 0, 0, 0, 0, 0]
    for i in range(n):
        qrow = [[q[w][i][x] for w in range(words)] + [0] * (7 - words)
                for x in range(c)]
        members = _group(inj, i, order)
        keyed = [tuple(blk[w][m] for w in range(2, 6)) + (m,)
                 for m in members]
        kept = _keep_smallest(keyed, cxi)
        assert kept == sorted(keyed)[:cxi]
        if not members and not any(tuple(e[:4]) > K0 for e in qrow) and (
                _in_order([tuple(e[:4]) + (x,) for x, e in enumerate(qrow)])):
            seen["idle"] += 1  # the warp writes nothing
            continue
        grp = [list(kv[:4]) + [blk[6][kv[4]], 0, 0] for kv in kept]
        n_e = cxi - len(grp)
        m = _merge_of_runs(qrow + grp, c, True, n_e)
        assert _in_order([tuple(g[:4]) + (c + j,)
                          for j, g in enumerate(grp)])
        row = _place(qrow + grp, m, [empty] * n_e, c + cxi)
        out[:, i] = torch.tensor(row[:c], dtype=i32).T[:words]
        add[i] = sum(1 for e in row[c:] if e[0] != NEVER32) + (
            len(members) - len(kept))
        shed[i] = len(members) - len(kept)
        seen["q_unsorted"] += not m["q_one"]
        seen["shifted"] += not members
        seen["moved"] += _moved(qrow, m)
    return {"q": out, "add": add, "shed": shed, "seen": seen}


def _check_h_call(p, s, inj, rng) -> dict:
    """H's form (the ballots' order and a counting sort's) against the
    plain version on one block; returns what the fast path saw."""
    want = _h_emulate(p, s, inj)
    again = _h_emulate(p, s, inj, order=rng)
    assert torch.equal(want["q"], again["q"])
    assert torch.equal(want["add"], again["add"])
    nq0 = s.n_queue.clone()
    nb0 = s.nb_shed.clone() if p.netobs else None
    lanes.inject_merge_plain(p, None, s, inj)
    assert torch.equal(torch.stack(lanes._queue_words(p, s)), want["q"])
    assert torch.equal(s.n_queue - nq0, want["add"])
    if p.netobs:
        assert torch.equal(s.nb_shed - nb0, want["shed"])
    return want["seen"]


def _stale_tail(port, words, rng, lanes_: list) -> list:
    """``words`` with the rows of ``lanes_`` ending in consumed entries:
    the NEVER time and their aux words kept (keyed above the canonical
    empty, where B's sort leaves them)."""
    words = [np.array(w, copy=True) for w in words]
    for i in lanes_:
        free = np.nonzero(words[0][i] == NEVER32)[0]
        free = free[: max(len(free) // 2, 1)][::-1]
        for x in free:
            words[2][i, x] = (lanes.PACKET << 29) | int(rng.integers(1, 9)) << 12
            words[3][i, x] = int(rng.integers(0, 1 << 20))
            words[4][i, x] = int(rng.integers(28, 1500))
        # keep the row sorted: the stale entries after the canonical ones
        order = np.lexsort((words[3][i], words[2][i],
                            (words[0][i].astype(np.int64) << 31)
                            | words[1][i]))
        for w in words:
            w[i] = w[i][order]
    return words


GROUPS = (0, 1, 31, 32, 33, "cxi", "cxi+1", 400)


def _groups_block(p, rng, sizes: dict, t0: int, ties: bool = False):
    """A block whose lane ``i`` gets ``sizes[i]`` rows (in shuffled block
    positions), the rest invalid, at a few instants; with ``ties`` their
    aux words tie too, so the row index decides.  As the reference's dict
    and the port's [INJ_WORDS, B] tensor."""
    b = p.inject_batch
    total = sum(sizes.values())
    assert total <= b
    dst = np.full(b, 0, np.int32)
    valid = np.zeros(b, bool)
    at = rng.permutation(b)[:total]
    valid[at] = True
    dst[at] = np.repeat(list(sizes), list(sizes.values()))
    inj_ref, inj_port = _block(p, rng, 0, t0=t0)
    t = t0 + rng.integers(0, 3, b) * 1_000_000
    auxl = rng.integers(0, 4, b) if ties else 50_000 + np.arange(b)
    inj_port[0] = torch.as_tensor(valid.astype(np.int32))
    inj_port[1] = torch.as_tensor(dst)
    inj_port[2] = torch.as_tensor(np.where(valid, t >> 31, NEVER32), dtype=i32)
    inj_port[3] = torch.as_tensor(np.where(valid, t & MASK31, NEVER32),
                                  dtype=i32)
    inj_port[5] = torch.as_tensor(auxl, dtype=i32)
    inj_ref = {"valid": valid, "dst": dst, "thi": inj_port[2].numpy(),
               "tlo": inj_port[3].numpy(), "auxh": inj_port[4].numpy(),
               "auxl": inj_port[5].numpy(), "size": inj_port[6].numpy()}
    return ({k: jax.numpy.asarray(v) for k, v in inj_ref.items()}, inj_port)


@pytest.mark.parametrize("capacity", [48, 16])
def test_h_form_against_plain_and_reference(capacity, tmp_path):
    """Groups of 0, 1, 31, 32, 33, Cxi, Cxi + 1 and 400 rows (two blocks:
    the 400 alone), over queue rows with and without entries keyed above
    the canonical empty; the form equals ``inject_merge_plain``, which
    equals the reference where the survivors are defined, and by counts
    where they are not."""
    ref, port = _engines(tmp_path, capacity=capacity,
                         extra=", netobs: true")
    p = port.params
    cxi = p.inject_cap
    assert cxi == capacity and p.inject_batch >= 400
    rng = np.random.default_rng(capacity)
    words = _random_queues(port, rng, 4_000_000, capacity // 2)
    n = p.n_lanes
    sizes = [{"cxi": cxi, "cxi+1": cxi + 1}.get(g, g) for g in GROUPS]
    # lanes 1..6 take the first block's groups, lane 7 the second's 400;
    # stale tails in lane 0 (never a group), 3 and 7 (a group in one block)
    assert n >= 8
    words = _stale_tail(port, words, rng, [0, 3, 7])
    seen = {}
    for blk_sizes in ({i: g for i, g in enumerate(sizes[:-1]) if g},
                      {7: sizes[-1]}):
        s_ref, s_port = _lift(ref, port, words, 1_000_000)
        inj_ref, inj_port = _groups_block(p, rng, blk_sizes, 2_000_000)
        got = _check_h_call(p, s_port, inj_port, rng)
        seen = {k: seen.get(k, 0) + v for k, v in got.items()}
        # the same groups with every key tied but the index: the form alone
        _check_h_call(p, _lift(ref, port, words, 1_000_000)[1],
                      _groups_block(p, rng, blk_sizes, 2_000_000, True)[1],
                      rng)
        s_ref = jax.jit(lambda s, i: ref_lanes._inject_merge(
            ref.params, ref.tables, s, i))(s_ref, inj_ref)
        over = [i for i, g in blk_sizes.items() if g > cxi]
        if not over:
            _assert_states(s_ref, s_port)
            continue
        _assert_states(s_ref, s_port, skip=("q_thi", "q_tlo", "q_auxh",
                                            "q_auxl", "q_size"))
        keep = np.ones(n, bool)
        keep[over] = False
        for f in ("q_thi", "q_tlo", "q_auxh", "q_auxl", "q_size"):
            np.testing.assert_array_equal(
                getattr(s_port, f).numpy()[keep],
                np.asarray(getattr(s_ref, f))[keep], err_msg=f)
        np.testing.assert_array_equal(
            (s_port.q_thi.numpy() != NEVER32).sum(1),
            (np.asarray(s_ref.q_thi) != NEVER32).sum(1))
    # lane 0 shifts without a group, 3 and 7 in one block each; the lanes
    # with neither stay as they are
    assert seen["shifted"] >= 3 and seen["idle"] > 0
    assert seen["q_unsorted"] == 0


def test_h_unsorted_queue_fallback(tmp_path):
    """A queue row out of order (the fallback's runs of 32) still merges
    as the plain version does."""
    _ref, port = _engines(tmp_path, capacity=48)
    p = port.params
    rng = np.random.default_rng(3)
    words = _random_queues(port, rng, 4_000_000, 40)
    s = _lift(_ref, port, words, 1_000_000)[1]
    for f in ("q_thi", "q_tlo", "q_auxh", "q_auxl", "q_size"):
        getattr(s, f).copy_(getattr(s, f).flip(1))
    _inj_ref, inj = _groups_block(p, rng, {0: 20, 1: 40, 2: 1}, 2_000_000)
    seen = _check_h_call(p, s, inj, rng)
    assert seen["q_unsorted"] > 0


def _spy_h(monkeypatch) -> list:
    """Hold every call of H's plain version to the premise (every queue
    row sorted) and to H's form; returns what each call saw."""
    calls = []
    plain = lanes.inject_merge_plain
    rng = np.random.default_rng(0)

    def spy(p, tb, s, inj):
        assert _q_sorted(p, s)
        monkeypatch.setattr(lanes, "inject_merge_plain", plain)
        try:
            calls.append(_check_h_call(p, s, inj, rng))
        finally:
            monkeypatch.setattr(lanes, "inject_merge_plain", spy)

    monkeypatch.setattr(lanes, "inject_merge_plain", spy)
    return calls


@pytest.mark.parametrize("name,fuse_k,cut_ms", [("mixed", 1, 500),
                                                ("congested", 8, 150)],
                         ids=["mixed-1", "congested-8"])
def test_h_premise_and_form_in_hybrid_runs(name, fuse_k, cut_ms, tmp_path,
                                           monkeypatch):
    """Every injection of a hybrid run on the CPU (the one-window law, and
    the fused law with rollbacks): the queue rows entering H sorted, the
    form equal to the plain version.  The congested run is cut at 150 ms
    (89 injections, 44 rollbacks), before its processes end."""
    cfg = ConfigOptions.from_yaml(FUSED_CONFIGS[name](tmp_path, fuse_k))
    cfg.general.stop_time = min(cfg.general.stop_time, cut_ms * 1_000_000)
    if name == "congested":
        for host in cfg.hosts:
            for proc in host.processes:
                proc.expected_final_state = "running"
    calls = _spy_h(monkeypatch)
    eng = HybridEngine(cfg, device="cpu")
    res = eng.run()
    assert not res.process_errors
    assert len(calls) > 5
    if fuse_k > 1:
        assert eng.sync_stats["fuse_rollbacks"] > 0


# ---- the size rules ---------------------------------------------------------


def _cu_source() -> str:
    return (pathlib.Path(lanes.__file__).parents[1] / "csrc" /
            "lanes.cu").read_text()


def test_split_and_inject_row_words():
    """E's and H's working memory a row, as ``merge_rows`` sizes the
    shared-memory rule and ``m_scratch`` by them; the kernels' own
    formulas in ``csrc/lanes.cu`` are the same."""
    assert lanes.split_row_words(48, 104) == 8 * 152 + 4
    assert lanes.split_row_words(8400, 104) == 8 * 8504 + 4
    assert lanes.inject_row_words(64, 64, 512) == (8 * 128 + 2 * 16
                                                   + 6 * (128 + 32))
    src = _cu_source()
    assert re.search(r"return 8 \* \(c \+ w_s\) \+ \(w_s \+ 31\) / 32;", src)
    assert re.search(r"return 8 \* \(c \+ cxi\) \+ 2 \* \(\(nb \+ 31\) / 32\)"
                     r" \+ SEL_WORDS \* \(2 \* cxi \+ 32\);", src)
    m = re.search(r"constexpr int SEL_WORDS = (\d+);", src)
    assert m and int(m.group(1)) == lanes.INJ_SEL_WORDS
    p = _e_engine().params
    _rows, entries, words, extra = lanes.merge_rows(p)["stream merge"]
    assert 4 * words * entries + extra == 4 * lanes.split_row_words(
        p.capacity, p.stream_row_width)


def test_merge_rows_paths(tmp_path):
    """The size rule's paths at an H100's opt-in limit: the mixed mesh's
    E rows and the hybrid configs' H rows in shared memory, the wide
    pair's E rows (C = 8,400) in ``m_scratch``, sized by their words."""
    optin = 232_448
    p = _e_engine().params
    assert lanes.merge_in_shared(*lanes.merge_rows(p)["stream merge"][1:],
                                 optin)
    _ref, port = _engines(tmp_path, capacity=64)
    hp = port.params
    rows, entries, words, extra = lanes.merge_rows(hp)["inject merge"]
    assert rows == hp.n_lanes and lanes.merge_in_shared(entries, words,
                                                        extra, optin)
    assert 4 * words * entries + extra == 4 * lanes.inject_row_words(
        hp.capacity, hp.inject_cap, hp.inject_batch)
    cfg = STREAM_CONFIGS["pair"](port_presets)
    cfg.experimental.tpu_lane_queue_capacity = 8400
    wide = GpuEngine(cfg, device="cpu").params
    r, e, w, x = lanes.merge_rows(wide)["stream merge"]
    assert not lanes.merge_in_shared(e, w, x, optin)
    assert lanes.merge_scratch_words(wide, optin) >= r * (
        lanes.split_row_words(wide.capacity, wide.stream_row_width))
    # the mixed mesh's E blocks keep all SPLIT_ROWS rows in shared memory
    m = re.search(r"constexpr int SPLIT_ROWS = (\d+);", _cu_source())
    assert m and int(m.group(1)) * 4 * lanes.split_row_words(
        p.capacity, p.stream_row_width) <= optin
