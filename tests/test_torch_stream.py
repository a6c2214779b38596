"""The port's lane-TCP stream path against the JAX reference and the CPU
oracle: the vector law, round by round, and whole runs.

The law: seeded flow matrices in every state go through the port's
``lanes_stream`` handlers and the reference's; every column and every emit
must be equal.  Rounds: the reference's ``make_round_fn`` against the
port's ``_build_round`` from one lifted state, field by field.  Runs: event
logs and counters equal ``TpuEngine``'s and ``CpuEngine``'s on the stream
configurations of the reference's tests.  Integer simulation: every
comparison is exact equality.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_cubic
import test_lane_parity as lp_cfg
from shadow_tpu.backend import lanes as ref_lanes
from shadow_tpu.backend import lanes_stream as ref_ls
from shadow_tpu.backend.cpu_engine import CpuEngine
from shadow_tpu.backend.tpu_engine import TpuEngine
from shadow_tpu.config import presets as ref_presets
from shadow_tpu.config.options import ConfigOptions as RefConfig
from shadow_tpu.net import ltcp as ref_ltcp
from shadow_tpu_torch.backend import bridge, lanes
from shadow_tpu_torch.backend import lanes_stream as ls
from shadow_tpu_torch.backend.gpu_engine import GpuEngine
from shadow_tpu_torch.config import presets as port_presets
from shadow_tpu_torch.config.options import ConfigOptions, LaneCompatError
from shadow_tpu_torch.net import ltcp

NEVER32 = lanes.NEVER32
MASK31 = lanes.MASK31
NOW = 5_123_456_789  # a time with a nonzero high word


def _pair(v):
    return v >> 31, v & MASK31


def _random_flows(rng, s: int) -> np.ndarray:
    """[2, S, F] flow matrices covering every state, recovery, RTO
    back-off, both algorithms and windows near MAX_CWND_FP."""
    m = 2 * s
    f = np.zeros((m, ls.N_COLS), dtype=np.int64)
    f[:, ls.C_STATE] = rng.integers(0, 7, m)
    una = rng.integers(0, 40, m)
    f[:, ls.C_SND_UNA] = una
    f[:, ls.C_SND_NXT] = una + rng.integers(0, 30, m)
    f[:, ls.C_RCV_NXT] = rng.integers(0, 40, m)
    f[:, ls.C_CWND] = rng.choice(
        [ltcp.FP, 3 * ltcp.FP + 17, 10 * ltcp.FP, ltcp.MAX_CWND_FP - 5,
         ltcp.MAX_CWND_FP], m)
    # a flow in recovery has taken a loss: its ssthresh is a window
    in_rec = rng.integers(0, 2, m)
    f[:, ls.C_IN_REC] = in_rec
    f[:, ls.C_SSTHRESH] = np.where(
        in_rec, rng.choice([2 * ltcp.FP, 8 * ltcp.FP], m),
        rng.choice([2 * ltcp.FP, 8 * ltcp.FP, ltcp.INIT_SSTHRESH_FP], m))
    f[:, ls.C_DUP_ACKS] = rng.integers(0, 4, m)
    f[:, ls.C_RECOVER] = una + rng.integers(0, 30, m)
    f[:, ls.C_MAX_SENT] = f[:, ls.C_SND_NXT] + rng.integers(0, 5, m)
    f[:, ls.C_RTT_SEQ] = rng.choice([-1, 0, 5, 20, 45], m)
    no_srtt = rng.random(m) < 0.3
    srtt = rng.integers(1_000_000, 400_000_000, m)
    f[:, ls.C_SRTT_HI] = np.where(no_srtt, -1, srtt >> 31)
    f[:, ls.C_SRTT_LO] = np.where(no_srtt, 0, srtt & MASK31)
    var = rng.integers(0, 200_000_000, m)
    f[:, ls.C_RTTVAR_HI], f[:, ls.C_RTTVAR_LO] = _pair(var)
    rto = rng.choice([ltcp.RTO_MIN, ltcp.RTO_INIT, 3_200_000_000,
                      ltcp.RTO_MAX - 1, ltcp.RTO_MAX], m)
    f[:, ls.C_RTO_HI], f[:, ls.C_RTO_LO] = _pair(rto)
    ts = NOW - rng.integers(0, 900_000_000, m)
    f[:, ls.C_RTT_TS_HI], f[:, ls.C_RTT_TS_LO] = _pair(ts)
    for hi, lo, p_never in ((ls.C_RTODL_HI, ls.C_RTODL_LO, 0.3),
                            (ls.C_RTOEV_HI, ls.C_RTOEV_LO, 0.3)):
        t = NOW + rng.integers(-200_000_000, 900_000_000, m)
        never = rng.random(m) < p_never
        f[:, hi] = np.where(never, NEVER32, t >> 31)
        f[:, lo] = np.where(never, NEVER32, t & MASK31)
    # half the RTO events owned: their time is NOW
    own = rng.random(m) < 0.5
    f[:, ls.C_RTOEV_HI] = np.where(own, NOW >> 31, f[:, ls.C_RTOEV_HI])
    f[:, ls.C_RTOEV_LO] = np.where(own, NOW & MASK31, f[:, ls.C_RTOEV_LO])
    f[:, ls.C_TX_SEGS] = rng.integers(0, 1000, m)
    f[:, ls.C_RETRANS] = rng.integers(0, 100, m)
    f[:, ls.C_COMPLETED] = rng.integers(0, 2, m)
    f[:, ls.C_RX_SEGS] = rng.integers(0, 1000, m)
    f[:, ls.C_RX_BYTES] = rng.integers(0, 1 << 24, m)
    f[:, ls.C_WMAX] = rng.choice([0, 12 * ltcp.FP, ltcp.MAX_CWND_FP], m)
    f[:, ls.C_ORIGIN] = rng.choice([0, 20 * ltcp.FP], m)
    no_epoch = rng.random(m) < 0.4
    ep = NOW - rng.integers(0, 12_000_000_000, m)
    f[:, ls.C_EPOCH_HI] = np.where(no_epoch, NEVER32, ep >> 31)
    f[:, ls.C_EPOCH_LO] = np.where(no_epoch, NEVER32, ep & MASK31)
    f[:, ls.C_KQ] = rng.integers(0, 3000, m)
    return f.astype(np.int32).reshape(2, s, ls.N_COLS)


def _shapes(rng, s: int):
    segs = np.concatenate([rng.integers(1, 60, s), np.zeros(s, int)])
    mss = np.concatenate([np.full(s, 1448), np.zeros(s, int)])
    last = np.concatenate([rng.integers(1, 1449, s), np.zeros(s, int)])
    cc = np.concatenate([rng.integers(0, 2, s), np.zeros(s, int)])
    return [a.astype(np.int32) for a in (segs, mss, last, cc)]


def _both(rng, s: int):
    """The same flows and shapes as the port's FlowCols and the
    reference's."""
    flows = _random_flows(rng, s)
    shapes = _shapes(rng, s)
    port = ls.endpoint_cols(torch.from_numpy(flows),
                            *[torch.from_numpy(a) for a in shapes])
    ref = ref_ls.endpoint_cols(
        ref_ls.StreamState(cl=jnp.asarray(flows[0]), sv=jnp.asarray(flows[1])),
        *[jnp.asarray(a) for a in shapes])
    return port, ref


def _assert_same(tag, port_nt, ref_nt):
    for name, a, b in zip(port_nt._fields, port_nt, ref_nt):
        np.testing.assert_array_equal(
            np.asarray(a), np.asarray(b), err_msg=f"{tag}: {name}")


def _now(m):
    hi, lo = _pair(NOW)
    return (torch.full((m,), hi, dtype=torch.int32),
            torch.full((m,), lo, dtype=torch.int32),
            jnp.full(m, hi, dtype=jnp.int32), jnp.full(m, lo, dtype=jnp.int32))


S_LAW = 96


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_law_handlers_match_reference(seed):
    """open_flow, on_rto and on_segment (every wire-flag combination the
    law reads), each followed by the pump epilogue, as the slot law runs
    them: every FlowCols column, every emit and every burst word equal."""
    rng = np.random.default_rng(seed)
    m = 2 * S_LAW
    port, ref = _both(rng, S_LAW)
    nh, nl, jnh, jnl = _now(m)
    mask = rng.random(m) < 0.8
    pm, jm = torch.from_numpy(mask), jnp.asarray(mask)
    flags = rng.choice(
        [ltcp.F_SYN, ltcp.F_SYN | ltcp.F_ACK, ltcp.F_ACK,
         ltcp.F_DATA | ltcp.F_ACK, ltcp.F_FIN | ltcp.F_ACK, 0], m)
    seq = rng.integers(0, 50, m)
    ack = np.asarray(port.snd_una) + rng.integers(-2, 12, m)
    size = rng.choice([ltcp.HDR_BYTES, ltcp.HDR_BYTES + 1448], m)
    seg_args = [a.astype(np.int32) for a in (flags, seq, ack, size)]
    cases = {
        "open": (ls.open_flow_vec(port, nh, nl, pm),
                 ref_ls.open_flow_vec(ref, jnh, jnl, jm)),
        "rto": (ls.on_rto_vec(port, nh, nl, pm),
                ref_ls.on_rto_vec(ref, jnh, jnl, jm)),
        "segment": (
            ls.on_segment_vec(port, nh, nl, pm,
                              *[torch.from_numpy(a) for a in seg_args]),
            ref_ls.on_segment_vec(ref, jnh, jnl, jm,
                                  *[jnp.asarray(a) for a in seg_args])),
    }
    for name, ((pf, pe), (rf, re)) in cases.items():
        _assert_same(f"{name} flow", pf, rf)
        _assert_same(f"{name} emit", pe, re)
        pf, pe, pb = ls.pump_epilogue_vec(pf, nh, nl, pm, pe)
        rf, re, rb = ref_ls.pump_epilogue_vec(rf, jnh, jnl, jm, re)
        _assert_same(f"{name}+pump flow", pf, rf)
        _assert_same(f"{name}+pump emit", pe, re)
        for w, (a, b) in enumerate(zip(pb, rb)):
            np.testing.assert_array_equal(
                np.asarray(a), np.asarray(b), err_msg=f"{name} burst {w}")
    # the seeds really reach the law's branches
    _pf, pe = cases["segment"][0]
    assert int(pe.send_valid.sum()) >= 5 and int(pe.rto_valid.sum()) >= 5
    assert int(cases["rto"][0][1].send_valid.sum()) > 0  # RTOs fired


@pytest.mark.parametrize("seed", [3, 4])
def test_cc_laws_match_reference(seed):
    """The loss response and congestion-avoidance growth, Reno and CUBIC,
    with epochs set and unset, and windows near MAX_CWND_FP."""
    rng = np.random.default_rng(seed)
    m = 2 * S_LAW
    port, ref = _both(rng, S_LAW)
    nh, nl, jnh, jnl = _now(m)
    mask = rng.random(m) < 0.7
    pm, jm = torch.from_numpy(mask), jnp.asarray(mask)
    _assert_same("cc_on_loss", ls._cc_on_loss(port, pm),
                 ref_ls._cc_on_loss(ref, jm))
    _assert_same("cc_grow_ca", ls._cc_grow_ca(port, nh, nl, pm),
                 ref_ls._cc_grow_ca(ref, jnh, jnl, jm))
    _assert_same("rtt_sample", ls._rtt_sample(port, nh, nl, pm),
                 ref_ls._rtt_sample(ref, jnh, jnl, jm))


def test_icbrt32_vector_twin_matches_scalar():
    """The twin of tests/test_cubic.py's test: the port's vector floor-cbrt
    against the reference's scalar one, and the port's scalar copy."""
    xs = np.array([0, 1, 7, 8, 26, 27, 1000, 123456789, 10**9, 2**31 - 1,
                   2**30], dtype=np.int32)
    got = ls._icbrt32_vec(torch.from_numpy(xs)).numpy()
    want = np.array([ref_ltcp.icbrt32(int(x)) for x in xs], dtype=np.int32)
    assert (got == want).all()
    assert [ltcp.icbrt32(int(x)) for x in xs] == want.tolist()


def test_port_constants_match_reference():
    names = [n for n in dir(ltcp) if n.isupper()]
    assert len(names) > 30
    for n in names:
        assert getattr(ltcp, n) == getattr(ref_ltcp, n), n
    assert ltcp.segs_for_size(200_000, 1448) == ref_ltcp.segs_for_size(
        200_000, 1448)


def test_vector_law_keeps_ack_rto_arm_through_opened_pump():
    """The twin of tests/test_lane_parity.py's regression test: an ACK that
    shrinks the RTO (arming a new owner event) and opens the send window
    must keep the arm through the epilogue pump — against the reference's
    scalar law on the identical flow."""
    segs = torch.tensor([50, 0], dtype=torch.int32)
    mss = torch.tensor([1448, 0], dtype=torch.int32)
    flows = ls.init_stream_state(1)
    cl = flows[0, 0]
    for col, val in (
        (ls.C_STATE, ltcp.ESTAB), (ls.C_SND_UNA, 5), (ls.C_SND_NXT, 10),
        (ls.C_RCV_NXT, 1), (ls.C_MAX_SENT, 10), (ls.C_CWND, 20 * ltcp.FP),
        (ls.C_SRTT_HI, -1), (ls.C_SRTT_LO, 0), (ls.C_RTTVAR_HI, 0),
        (ls.C_RTTVAR_LO, 0), (ls.C_RTO_HI, _pair(900_000_000)[0]),
        (ls.C_RTO_LO, _pair(900_000_000)[1]), (ls.C_RTT_SEQ, 5),
        (ls.C_RTT_TS_HI, _pair(970_000_000)[0]),
        (ls.C_RTT_TS_LO, _pair(970_000_000)[1]),
        (ls.C_RTODL_HI, _pair(1_900_000_000)[0]),
        (ls.C_RTODL_LO, _pair(1_900_000_000)[1]),
        (ls.C_RTOEV_HI, _pair(1_900_000_000)[0]),
        (ls.C_RTOEV_LO, _pair(1_900_000_000)[1]),
    ):
        cl[col] = val
    f = ls.endpoint_cols(flows, segs, mss, mss.clone(),
                         torch.zeros(2, dtype=torch.int32))
    now = 1_000_000_000
    nh = torch.full((2,), _pair(now)[0], dtype=torch.int32)
    nl = torch.full((2,), _pair(now)[1], dtype=torch.int32)
    fs = ref_ltcp.FlowState(
        role=ref_ltcp.SENDER, segs=50, mss=1448, last_bytes=1448,
        state=ref_ltcp.ESTAB, snd_una=5, snd_nxt=10, rcv_nxt=1, max_sent=10,
        cwnd_fp=20 * ref_ltcp.FP, srtt=-1, rttvar=0, rto=900_000_000,
        rtt_seq=5, rtt_ts=970_000_000, rto_deadline=1_900_000_000,
        rto_evt=1_900_000_000)
    em_ref = ref_ltcp.on_segment(fs, now, ref_ltcp.F_ACK, 0, 6)
    m = torch.tensor([True, False])
    full = functools.partial(torch.full, (2,), dtype=torch.int32)
    f2, em = ls.on_segment_vec(f, nh, nl, m, full(ltcp.F_ACK), full(0),
                               full(6), full(ltcp.HDR_BYTES))
    f2, em, burst = ls.pump_epilogue_vec(f2, nh, nl, m, em)
    assert em_ref.arm_rto is not None  # the scenario arms a shrunk owner
    assert bool(em.rto_valid[0])
    assert (int(em.rto_thi[0]) << 31) | int(em.rto_tlo[0]) == em_ref.arm_rto
    assert (int(f2.rtoev_hi[0]) << 31) | int(f2.rtoev_lo[0]) == fs.rto_evt
    # the epilogue pumped the same units the scalar law emitted
    assert int(burst[0][:, 0].sum()) == len(em_ref.sends)
    assert burst[2][:, 0][burst[0][:, 0]].tolist() == [
        sd[1] for sd in em_ref.sends]


# ---- whole configurations ----------------------------------------------------

def _untiered(yaml: str) -> str:
    return yaml.replace("experimental: {",
                        "experimental: {tpu_stream_tiered: false, ")


STREAM_PAIR = _untiered(lp_cfg.STREAM_PAIR)
STREAM_STAR = lp_cfg.STREAM_STAR
LOSSY_PAIR = STREAM_PAIR.replace('latency "15 ms"',
                                 'latency "15 ms" packet_loss 0.03')
CUBIC_PAIR = _untiered(test_cubic.CUBIC_PAIR)
# test_mixed_mesh_stream_parity's shape: a 12-host UDP mesh whose spray
# crosses two stream pairs
MIXED_ARGS = dict(sim_seconds=2, stream_pairs=2, stream_bytes=200_000,
                  queue_capacity=96, pops_per_round=4)


def _mixed(pkg):
    cfg = pkg.flagship_mesh_config(12, **MIXED_ARGS)
    cfg.experimental.tpu_stream_tiered = False
    return cfg


CONFIGS = {
    "pair": lambda pkg: (RefConfig if pkg is ref_presets
                         else ConfigOptions).from_yaml(STREAM_PAIR),
    "lossy_pair": lambda pkg: (RefConfig if pkg is ref_presets
                               else ConfigOptions).from_yaml(LOSSY_PAIR),
    "star": lambda pkg: (RefConfig if pkg is ref_presets
                         else ConfigOptions).from_yaml(STREAM_STAR),
    "cubic_pair": lambda pkg: (RefConfig if pkg is ref_presets
                               else ConfigOptions).from_yaml(CUBIC_PAIR),
    "mixed_mesh": _mixed,
}


@functools.lru_cache(maxsize=None)
def _oracle(name: str):
    cfg = CONFIGS[name](ref_presets)
    cfg.experimental.network_backend = "cpu"
    return CpuEngine(cfg).run()


CASES = [("pair", "step"), ("pair", "device"), ("lossy_pair", "step"),
         ("star", "step"), ("cubic_pair", "device"), ("mixed_mesh", "device")]


@pytest.mark.parametrize("name,mode", CASES, ids=[f"{n}-{m}" for n, m in CASES])
def test_logs_and_counters_match_reference_and_oracle(name, mode):
    cpu = _oracle(name)
    ref = TpuEngine(CONFIGS[name](ref_presets)).run(mode=mode)
    port = GpuEngine(CONFIGS[name](port_presets), device="cpu").run(mode=mode)
    assert port.log_tuples() == ref.log_tuples() == cpu.log_tuples()
    assert port.counters == ref.counters
    assert port.rounds == ref.rounds
    for k in ("stream_complete", "stream_rx_bytes", "stream_rx_segs",
              "stream_tx_segs", "stream_flows_done", "stream_retransmits"):
        assert port.counters.get(k) == cpu.counters.get(k), k
    assert port.counters["stream_rx_bytes"] > 0
    if name in ("pair", "lossy_pair", "cubic_pair"):
        assert port.counters["stream_complete"] == 1
    if name in ("lossy_pair", "star"):
        assert port.counters["stream_retransmits"] > 0  # recovery ran
        assert any(r.outcome == 1 for r in port.event_log)  # DROP_LOSS rows
    if name == "star":
        assert port.counters["stream_complete"] == 6


def _never_rule(d: dict) -> dict:
    """Empty slots (NEVER time pair) compare by their time words only: the
    reference's row sort is unstable and its masked gathers leave the
    other words of empty slots unspecified (test_torch_round_parity.py's
    rule, with the payload words)."""
    d = dict(d)
    hole = d["q_thi"] == NEVER32
    for f in ("q_auxh", "q_auxl", "q_size", "q_phi", "q_plo"):
        d[f] = np.where(hole, 0, d[f])
    return d


@pytest.mark.parametrize("name,rounds", [("star", 24), ("pair", 40)])
def test_rounds_match_reference_field_by_field(name, rounds):
    """Step the reference's ``make_round_fn`` and the port's
    ``_build_round`` one window at a time from the same lifted state and
    compare every ``LaneState`` field, the flows and the payload words
    included, after each live round — at least 20 of them.  (Once the run
    is done, the reference writes a meaningless window end; the rounds
    stop there.)"""
    yaml = {"star": STREAM_STAR, "pair": STREAM_PAIR}[name]
    ref = TpuEngine(RefConfig.from_yaml(yaml), log_capacity=4096)
    port = GpuEngine(ConfigOptions.from_yaml(yaml), log_capacity=4096,
                     device="cpu")
    assert port.params.split == (name == "pair")
    s_ref = ref.initial_state()
    s_port = bridge.state_from_numpy(
        {f: np.asarray(getattr(s_ref, f)) for f in lanes.LaneState._fields})
    round_ref = ref_lanes.make_round_fn(ref.params, ref.tables)
    round_port = lanes._build_round(port.params, port.tables, s_port)
    live = 0
    for r in range(rounds):
        s_ref, done_ref = round_ref(s_ref)
        done = round_port()
        assert bool(done_ref) == done
        if done:
            break
        live += 1
        want = _never_rule(
            {f: np.asarray(getattr(s_ref, f)) for f in lanes.LaneState._fields})
        got = _never_rule(bridge.state_to_numpy(s_port))
        for f in lanes.LaneState._fields:
            np.testing.assert_array_equal(got[f], want[f],
                                          err_msg=f"round {r}: {f}")
    assert live >= 20
    assert int(s_port.stream[1, :, ls.C_RX_SEGS].sum()) > 0  # data flowed


@pytest.mark.parametrize("edit", [
    ("--size, 200kB", "--size, 67108864, --mss, 1"),
    ("--size, 200kB", f"--size, {1 << 31}, --mss, 60000"),
    ("experimental: {", "experimental: {flowtrace: true, "),
    ("experimental: {", "experimental: {netobs: true, "),
    ("c: {network_node_id: 0,", "c: {network_node_id: 0, pcap_enabled: true,"),
], ids=["segments_past_26_bits", "size_2_31", "flowtrace", "netobs", "pcap"])
def test_unported_stream_configs_raise(edit):
    """What the port refuses with streams: flows beyond the lane law's
    26-bit sequence space or its int32 byte counter, and the observation
    planes it has not ported."""
    yaml = STREAM_PAIR.replace(*edit)
    assert yaml != STREAM_PAIR
    with pytest.raises(LaneCompatError):
        GpuEngine(ConfigOptions.from_yaml(yaml), device="cpu")


@pytest.mark.parametrize("edit", [
    ("tpu_stream_tiered: false, ", ""),
], ids=["tiered_one_to_one"])
def test_ported_stream_configs_run(edit):
    """What an earlier slice refused and a later one runs: the pair on the
    reference's tiered stream backend, its default (tests/test_torch_tier.py
    holds it to the reference)."""
    yaml = STREAM_PAIR.replace(*edit)
    assert yaml != STREAM_PAIR
    eng = GpuEngine(ConfigOptions.from_yaml(yaml), device="cpu")
    assert eng.params.stream_tiered
    res = eng.run(mode="device")
    assert res.counters["stream_complete"] == 1
    assert res.counters["stream_rx_bytes"] == 200_000


def test_stream_server_without_a_client_raises():
    yaml = STREAM_PAIR.replace(
        "c: {network_node_id: 0, processes: [{path: stream-client, args: "
        "[--server, s, --size, 200kB]}]}", "c: {network_node_id: 0}")
    assert yaml != STREAM_PAIR
    with pytest.raises(LaneCompatError, match="without any stream-client"):
        GpuEngine(ConfigOptions.from_yaml(yaml), device="cpu")


@pytest.mark.parametrize("name,builder", [
    ("stream-tcp.yaml", port_presets.stream_tcp_example_doc),
    ("cubic-vs-reno.yaml", port_presets.cubic_vs_reno_example_doc),
])
def test_example_docs_match_the_yaml(name, builder):
    """chip_smoke.py builds the two stream examples from dicts (the card's
    machine has no YAML parser): they must be the example files."""
    from pathlib import Path

    text = (Path(__file__).resolve().parents[1] / "examples" / name).read_text()
    doc = builder()
    a = GpuEngine(ConfigOptions.from_yaml(text), device="cpu")
    b = GpuEngine(ConfigOptions.from_dict(doc), device="cpu")
    assert a.params == b.params
    for f in lanes.LaneTables._fields:
        assert torch.equal(getattr(a.tables, f), getattr(b.tables, f)), f
    assert [h.hostname for h in a.cfg.hosts] == [h.hostname for h in b.cfg.hosts]
    assert [h.processes for h in a.cfg.hosts] == [h.processes for h in b.cfg.hosts]
    assert [h.congestion for h in a.cfg.hosts] == [h.congestion for h in b.cfg.hosts]
