"""Kernel B's and kernel F's edge cases, plain, against the JAX reference.

On the card ``chip_smoke.py`` (``check_merge_cases``) holds each kernel to
its plain version on these kinds of cases; here, at small widths, the
plain versions are held to the reference.  B's ``exchange_merge_plain``
against ``shadow_tpu.backend.lanes._merge_append``: queue rows whose popped
prefix has the NEVER time and keeps its old aux words (as kernel A leaves
them; in some rows one aux pair for the whole prefix), all-NEVER rows,
destination groups past Cx, DELIVERY inserts beside the re-arms, logging,
and on a tiered run the divert of the stream lanes' cross entries.  F's
``stream_tier_plain`` with G's ``tier_merge_plain`` and D's
``append_log_plain`` against the reference's ``_stream_tier_iter`` (its
pop, slot walk, merge and log appends) on popped prefixes that end at
column 0, mid-row and past all K_s columns, under the wide and the narrow
pop rule.  Also B's size rule (its narrow or wide form) and the sort
width.  Exact equality wherever the reference defines the words: an
empty slot compares by its time words (the reference's row sorts are
unstable), and of a destination group past Cx the reference keeps
whichever Cx its unstable destination sort leaves, so those lanes compare
by counts.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shadow_tpu.backend import lanes as ref_lanes
from shadow_tpu.backend.tpu_engine import TpuEngine
from shadow_tpu.config import presets as ref_presets
from shadow_tpu_torch.backend import bridge, lanes
from shadow_tpu_torch.backend import lanes_stream as ls
from shadow_tpu_torch.backend.gpu_engine import GpuEngine
from shadow_tpu_torch.config import presets as port_presets
from shadow_tpu_torch.net import ltcp
from test_torch_tier import CONFIGS as TIER_CONFIGS
from test_torch_tier import _never_rule, _ref_numpy

NEVER32 = lanes.NEVER32
T0 = 3_000_000_000  # times with a nonzero high word


# ---- B -----------------------------------------------------------------


def _mesh(pkg, cross: int, tiered: bool = False):
    """A 40-host tgen mesh at C = 16, K = 2 and Cx = ``cross`` (the
    flagship's 26-entry rows at 8), or with two tiered stream pairs."""
    cfg = pkg.flagship_mesh_config(
        40, sim_seconds=1, queue_capacity=16, pops_per_round=2,
        stream_pairs=2 if tiered else 0, stream_bytes=100_000)
    cfg.experimental.tpu_cross_capacity = cross
    cfg.experimental.tpu_stream_tiered = tiered
    return cfg


def _holes(d: dict) -> dict:
    """The [N] queues with their empty slots (NEVER time pair) reduced to
    their time words: the reference's row sort leaves the others
    unspecified (``test_torch_tier._never_rule``, the [N] half)."""
    d = dict(d)
    hole = d["q_thi"] == NEVER32
    for f in ("q_auxh", "q_auxl", "q_size"):
        d[f] = np.where(hole, 0, d[f])
    return d


def _engines(cross: int, tiered: bool, log_cap: int, active: bool):
    ref = TpuEngine(_mesh(ref_presets, cross, tiered), log_capacity=log_cap)
    port = GpuEngine(_mesh(port_presets, cross, tiered), log_capacity=log_cap,
                     device="cpu")
    rp, p = ref.params, port.params
    if active:  # DELIVERY inserts in the self block: its 2K columns
        rp = dataclasses.replace(rp, models_present=tuple(sorted(
            set(rp.models_present) | {ref_lanes.M_PHOLD})))
        p = dataclasses.replace(p, models_present=tuple(sorted(
            set(p.models_present) | {lanes.M_PHOLD})))
    return ref, port, rp, p


def _queues(p, rng):
    """Sorted queue rows of distinct keys, at least half full, then popped
    prefixes: each row's first f columns (f under 4 in half the rows) take
    the NEVER time and keep their aux words, a
    third of them one aux pair (and size) for the whole prefix, one row in
    eight NEVER throughout; [5, N, C] int32."""
    n, c = p.n_lanes, p.capacity
    fill = rng.integers(c // 2, c + 1, n)
    live = np.arange(c)[None, :] < fill[:, None]
    t = np.where(live, T0 + rng.integers(0, 30_000_000, (n, c)), 1 << 62)
    src = rng.integers(0, n, (n, c))
    auxh = (lanes.PACKET << lanes.AUX_KIND_SHIFT) | (src << lanes.AUX_SRC_SHIFT)
    auxl = np.arange(c)[None, :] + 1000 * np.arange(n)[:, None]
    size = rng.integers(28, 1500, (n, c))
    order = np.argsort(t, axis=1, kind="stable")
    t, auxh, auxl, size = (np.take_along_axis(a, order, axis=1)
                           for a in (t, auxh, auxl, size))
    never = t == 1 << 62
    words = np.stack([np.where(never, NEVER32, t >> 31),
                      np.where(never, NEVER32, t & lanes.MASK31),
                      auxh, auxl, size]).astype(np.int32)
    f = np.where(rng.random(n) < 0.5, rng.integers(0, 4, n),
                 rng.integers(0, c + 1, n))
    f[rng.random(n) < 0.125] = c
    pre = np.arange(c)[None, :] < f[:, None]
    words[:2] = np.where(pre, NEVER32, words[:2])
    tie = (rng.random(n) < 0.3)[:, None] & pre
    words[2:] = np.where(tie, words[2:, :, :1], words[2:])
    return words


def _blocks(p, rng, hot):
    """Outbound [6, K, N] and self [5, N, S] blocks: about 70% of the
    outbound entries valid, half of those to the lanes ``hot`` (groups
    past Cx), the rest spread; half the self entries valid."""
    n, k, sw = p.n_lanes, p.pops_per_iter, p.lane.self_width
    m = k * n
    valid = rng.random(m) < 0.7
    dst = np.where(rng.random(m) < 0.5, rng.choice(hot, m),
                   rng.integers(0, n, m))
    t = T0 + 10_000_000 + rng.integers(0, 30_000_000, m)
    out = np.stack([
        np.where(valid, dst, n), np.where(valid, t >> 31, NEVER32),
        np.where(valid, t & lanes.MASK31, NEVER32),
        np.where(valid, (np.arange(m) % n) << lanes.AUX_SRC_SHIFT, 0),
        np.where(valid, np.arange(m) + (1 << 24), 0),
        np.where(valid, rng.integers(28, 1500, m), 0)]).reshape(6, k, n)
    arm = rng.random((n, sw)) < 0.5
    ta = T0 + rng.integers(5_000_000, 50_000_000, (n, sw))
    ins = (np.arange(sw) < k)[None, :] & (sw == 2 * k)
    kind = np.where(ins, lanes.DELIVERY, lanes.LOCAL)
    src = np.where(ins, rng.integers(0, n, (n, sw)), np.arange(n)[:, None])
    self_ = np.stack([
        np.where(arm, ta >> 31, NEVER32), np.where(arm, ta & lanes.MASK31,
                                                   NEVER32),
        (kind << lanes.AUX_KIND_SHIFT) | (src << lanes.AUX_SRC_SHIFT),
        rng.integers(0, 1 << 20, (n, sw)),
        np.where(ins, rng.integers(28, 1500, (n, sw)), 0)])
    return out.astype(np.int32), self_.astype(np.int32)


def _emits(p, out, self_):
    """The reference's slot emits for these blocks: the same-lane
    channels [ins K | arm K] (arm alone when every model is passive) and
    the outbound channel, every other channel empty."""
    k, n = p.pops_per_iter, p.n_lanes
    f = {name: () for name in ref_lanes._SlotEmit._fields}
    zeros = jnp.zeros((k, n), jnp.int32)
    chans = {"arm": self_[:, :, -k:]}
    if self_.shape[2] == 2 * k:
        chans["ins"] = self_[:, :, :k]
    for ch, blk in chans.items():
        f[f"{ch}_valid"] = jnp.asarray(blk[0].T != NEVER32)
        for w, name in enumerate(("thi", "tlo", "auxh", "auxl", "size")):
            f[f"{ch}_{name}"] = jnp.asarray(np.ascontiguousarray(blk[w].T))
    f["arm_plo"] = zeros
    if "ins" in chans:
        f["ins_phi"] = f["ins_plo"] = zeros
    f["out_valid"] = jnp.asarray(out[0] != n)
    for w, name in enumerate(("dst", "thi", "tlo", "auxh", "auxl", "size")):
        f[f"out_{name}"] = jnp.asarray(out[w])
    f["out_phi"] = f["out_plo"] = zeros
    return ref_lanes._SlotEmit(**f)


B_CASES = [
    # (Cx, tiered, log capacity, active, hot lanes)
    (8, False, 0, False, [3, 17]),
    (8, False, 4096, True, [3, 17, 30]),
    (4, False, 4096, False, list(range(40))),
    (16, False, 4096, True, [5]),
    (8, True, 4096, False, None),  # hot: the stream lanes
]


@pytest.mark.parametrize("cx,tiered,log_cap,active,hot", B_CASES)
def test_exchange_merge_edge_cases_match_reference(cx, tiered, log_cap,
                                                   active, hot):
    ref, port, rp, p = _engines(cx, tiered, log_cap, active)
    if tiered:
        rp = dataclasses.replace(
            rp, models_present=tuple(m for m in rp.models_present
                                     if m not in ref_lanes.STREAM_MODELS),
            stream_tiered=False, stream_clients=(), stream_pcap=False)
        hot = np.nonzero(port.tables.lane_stream.numpy())[0]
    rng = np.random.default_rng(cx * 100 + log_cap % 7 + active)
    pl = p.lane
    words = _queues(pl, rng)
    out, self_ = _blocks(p, rng, hot)
    s_ref = ref.initial_state()
    s_ref = s_ref._replace(**{f: jnp.asarray(words[w]) for w, f in enumerate(
        ("q_thi", "q_tlo", "q_auxh", "q_auxl", "q_size"))})
    s_port = bridge.state_from_numpy(_ref_numpy(s_ref))
    ws = lanes.make_workspace(p, "cpu")
    ws.out_blk.copy_(torch.as_tensor(out))
    ws.self_blk[:5] = torch.as_tensor(self_)

    got = ref_lanes._merge_append(rp, ref.tables, s_ref,
                                  _emits(pl, out, self_), divert=tiered)
    s_ref, over = got[0], got[1]
    lanes.exchange_merge_plain(p, port.tables, s_port, ws)

    n, c, k = pl.n_lanes, pl.capacity, pl.pops_per_iter
    cnt = np.bincount(out[0].reshape(-1), minlength=n + 1)[:n]
    kept = cnt <= pl.cross_cap  # lanes whose group the reference defines
    assert (~kept).any() and kept.any()
    want = _holes(_ref_numpy(s_ref))
    have = _holes(bridge.state_to_numpy(s_port))
    for f in ("q_thi", "q_tlo", "q_auxh", "q_auxl", "q_size"):
        np.testing.assert_array_equal(have[f][kept], want[f][kept], err_msg=f)
    np.testing.assert_array_equal((have["q_thi"] != NEVER32).sum(1),
                                  (want["q_thi"] != NEVER32).sum(1))
    np.testing.assert_array_equal(have["n_queue"], want["n_queue"])
    assert int(have["n_queue"].sum()) > 0
    if log_cap:  # the merge tail's DROP_QUEUE records, lane-major
        tail = pl.self_width + pl.cross_cap
        lane_of = np.repeat(np.arange(n), tail)
        rec_valid = ws.rec_valid[:n * tail].numpy().astype(bool)
        ref_valid = np.asarray(over["valid"])
        sel = kept[lane_of]
        np.testing.assert_array_equal(rec_valid[sel], ref_valid[sel])
        rows = ws.recs[:n * tail].numpy()
        for j, key in enumerate(("time", "src", "dst", "seq", "size",
                                 "outcome")):
            np.testing.assert_array_equal(
                rows[sel & rec_valid, j], np.asarray(over[key])[sel & rec_valid],
                err_msg=key)
        assert (sel & rec_valid).any()
    if tiered:
        # the divert, for the endpoint rows whose group is defined, as a
        # set: the reference hands on its unstable sort's order, the port
        # index order (G merges the block by key either way)
        tier_cross = got[2]
        cx0 = p.tier_layout[3]
        el = port.tables.flow_lanes.numpy()
        blk = ws.tier_blk[:, cx0:].numpy().reshape(7, len(el), pl.cross_cap)
        want_blk = np.stack([np.asarray(tier_cross[key]) for key in (
            "thi", "tlo", "auxh", "auxl", "size")])
        rows = np.nonzero(kept[el])[0]
        for r in rows:
            a, b = blk[:5, r], want_blk[:, r]
            np.testing.assert_array_equal(a[:, np.lexsort(a[::-1])],
                                          b[:, np.lexsort(b[::-1])])
        assert len(rows) and (blk[0] != NEVER32).any()
        assert not blk[5:].any()


def test_exchange_merge_all_never_rows_match_reference():
    """Every queue entry NEVER (with aux words), no exchange, no self
    entry: the rows stay NEVER, nothing is shed."""
    ref, port, rp, p = _engines(8, False, 0, False)
    rng = np.random.default_rng(5)
    words = _queues(p, rng)
    words[:2] = NEVER32
    out, self_ = _blocks(p, rng, [0])
    out[0], out[1:3] = p.n_lanes, NEVER32
    self_[:2] = NEVER32
    s_ref = ref.initial_state()._replace(**{
        f: jnp.asarray(words[w]) for w, f in enumerate(
            ("q_thi", "q_tlo", "q_auxh", "q_auxl", "q_size"))})
    s_port = bridge.state_from_numpy(_ref_numpy(s_ref))
    ws = lanes.make_workspace(p, "cpu")
    ws.out_blk.copy_(torch.as_tensor(out))
    ws.self_blk[:5] = torch.as_tensor(self_)
    s_ref, _over = ref_lanes._merge_append(rp, ref.tables, s_ref,
                                           _emits(p, out, self_))
    lanes.exchange_merge_plain(p, port.tables, s_port, ws)
    want = _holes(_ref_numpy(s_ref))
    have = _holes(bridge.state_to_numpy(s_port))
    for f in ("q_thi", "q_tlo", "q_auxh", "q_auxl", "q_size", "n_queue"):
        np.testing.assert_array_equal(have[f], want[f], err_msg=f)
    assert (have["q_thi"] == NEVER32).all() and not have["n_queue"].any()


@pytest.mark.parametrize("entries,narrow,width", [
    (1, True, 1), (26, True, 32), (28, True, 32), (32, True, 32),
    (33, False, 64), (144, False, 256), (8_196, False, 16_384),
])
def test_merge_form_and_sort_width(entries, narrow, width):
    """B's form: a warp for rows of at most 32 entries (the flagship's and
    the tiered mesh's 26, the untiered mesh's 28), a block past that
    (PHOLD's 144, the C = Cx = 4096 rows); the sort's power-of-two index
    array beside a block-form row."""
    assert lanes.merge_in_warp(entries) is narrow
    assert lanes.sort_width(entries) == width


def test_merge_rows_carry_the_sort_index_array():
    """Each block-form merge's row has its sort index array beside it (B's
    Cx selected indices share it), so the size rule and m_scratch count
    it: the 40-host mesh's B rows at C = 16, Cx = 8."""
    p = GpuEngine(_mesh(port_presets, 8), device="cpu").params
    rows, entries, words, extra = lanes.merge_rows(p)["merge"]
    assert (rows, entries, words) == (40, 26, 5)
    assert extra == 4 * 32
    assert lanes.merge_in_warp(entries)


# ---- F -----------------------------------------------------------------


def _tier_rows(q, ks: int, peers, shift: int):
    """Popped prefixes in the tier rows ``q`` [7, 2S, C2] (numpy, in
    place): row r's first e columns (e = 1, K_s / 2 or K_s + 1 by (r +
    ``shift``) mod 3, the last past every column) SYN segments from the row's peer at one
    instant inside the window, column e a LOCAL at a later instant, so
    both pop rules stop there.  Returns e a row."""
    s2 = q.shape[1]
    ends = np.array([1, ks // 2, ks + 1])[(np.arange(s2) + shift) % 3]
    for r in range(s2):
        e = min(int(ends[r]), ks)
        q[ls.TQ_THI, r, :e] = 0
        q[ls.TQ_TLO, r, :e] = T0_TIER
        q[ls.TQ_AUXH, r, :e] = (lanes.PACKET << lanes.AUX_KIND_SHIFT
                                | int(peers[r]) << lanes.AUX_SRC_SHIFT)
        q[ls.TQ_AUXL, r, :e] = 100 * r + np.arange(e)
        q[ls.TQ_SIZE, r, :e] = ltcp.HDR_BYTES
        q[ls.TQ_PHI, r, :e] = ltcp.F_SYN << 26 | np.arange(e)
        q[ls.TQ_PLO, r, :e] = 0
        if ends[r] <= ks:
            q[ls.TQ_AUXH, r, e] = (lanes.LOCAL << lanes.AUX_KIND_SHIFT
                                   | int(peers[r]) << lanes.AUX_SRC_SHIFT)
            q[ls.TQ_THI, r, e] = 0
            q[ls.TQ_TLO, r, e] = T0_TIER + 1_000
    return ends


T0_TIER = 5_000  # ns: the prefixes' instant, inside the window
WE_TIER = 10_000_000  # the window's end


# a pair's two rows take two of the three prefix ends a shift, so two
# shifts cover them; the mesh's four rows cover them at once
TIER_CASES = [("pair", 0), ("pair", 1), ("slow_pair", 0), ("slow_pair", 1),
              ("mixed_mesh", 0)]


@pytest.mark.parametrize("name,shift", TIER_CASES)
def test_stream_tier_prefixes_match_reference(name, shift):
    """F (with G and D) against ``_stream_tier_iter`` from the initial
    state with its tier rows' prefixes set: rows popping column 0 alone,
    K_s / 2 columns and all K_s (by row and ``shift``), under the wide pop
    rule (the pairs at 15 ms, the mesh) and the narrow one (the 250 ms
    pair); the tier state, the log and the counters after, and the columns
    each row popped."""
    ref = TpuEngine(TIER_CONFIGS[name](ref_presets), log_capacity=4096)
    port = GpuEngine(TIER_CONFIGS[name](port_presets), log_capacity=4096,
                     device="cpu")
    p, ks = port.params, port.params.stream_pops
    assert p.stream_wide_pop is (name != "slow_pair")
    s_ref = ref.initial_state()
    ts = s_ref.stream
    q = np.asarray(ts.q).copy()
    ends = _tier_rows(q, ks, port.tables.flow_peers.numpy(), shift)
    we_hi, we_lo = jnp.int32(0), jnp.int32(WE_TIER)
    s_ref = s_ref._replace(stream=ts._replace(q=jnp.asarray(q)),
                           now_we_hi=we_hi, now_we_lo=we_lo)
    s_port = bridge.state_from_numpy(_ref_numpy(s_ref))

    s2, cx = 2 * p.s_flows, p.cross_cap
    tier_cross = {"valid": jnp.zeros((s2, cx), bool),
                  "thi": jnp.full((s2, cx), NEVER32, jnp.int32),
                  "tlo": jnp.full((s2, cx), NEVER32, jnp.int32),
                  **{w: jnp.zeros((s2, cx), jnp.int32)
                     for w in ("auxh", "auxl", "size")}}
    s_ref = ref_lanes._stream_tier_iter(ref.params, ref.tables, s_ref,
                                        we_hi, we_lo, tier_cross)
    ws = lanes.make_workspace(p, "cpu")
    cx0 = p.tier_layout[3]
    ws.tier_blk[:2, cx0:] = NEVER32
    before = s_port.stream.q[ls.TQ_THI, :, :ks].clone()
    lanes.stream_tier_plain(p, port.tables, s_port, ws)
    popped = (before != s_port.stream.q[ls.TQ_THI, :, :ks]).sum(1).numpy()
    np.testing.assert_array_equal(popped, np.minimum(ends, ks))
    lanes.tier_merge_plain(p, port.tables, s_port, ws)
    lanes.append_log_plain(p, s_port, ws)

    want = _never_rule(_ref_numpy(s_ref))
    have = _never_rule(bridge.state_to_numpy(s_port))
    for a, b, what in zip(have["stream"], want["stream"], ("flows", "q", "v")):
        np.testing.assert_array_equal(a, b, err_msg=what)
    for f in ("log", "log_count", "log_lost"):
        np.testing.assert_array_equal(have[f], want[f], err_msg=f)
    assert int(have["log_count"]) > 0
