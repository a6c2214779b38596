"""The port's tiered stream pass against the JAX reference and the CPU oracle.

One-to-one stream configs run, by default, on the tiered stream backend:
the endpoints' own ``[2S, C2]`` queues and compact state
(``lanes_stream.TierState``), kernels F (pop and slot walk) and G (merge),
and B's divert of the mesh's cross entries into the tier.  Tables and the
initial state, field by field; rounds against the reference's
``make_round_fn`` from one lifted state, every ``LaneState`` field and
every ``TierState`` array after each live round (so the plain F and G are
held to the reference's ``_stream_tier_iter`` halves); whole runs, logs and
counters against ``TpuEngine`` and ``CpuEngine``; strict capacity on tier
overflow; and the port's tiered path against its own untiered one.
Integer simulation: every comparison is exact equality.
"""

import functools

import numpy as np
import pytest

import test_cubic
import test_lane_parity as lp_cfg
from shadow_tpu.backend import lanes as ref_lanes
from shadow_tpu.backend.cpu_engine import CpuEngine
from shadow_tpu.backend.tpu_engine import TpuEngine
from shadow_tpu.config import presets as ref_presets
from shadow_tpu.config.options import ConfigOptions as RefConfig
from shadow_tpu_torch.backend import bridge, lanes
from shadow_tpu_torch.backend import lanes_stream as ls
from shadow_tpu_torch.backend.gpu_engine import GpuEngine
from shadow_tpu_torch.config import presets as port_presets
from shadow_tpu_torch.config.options import ConfigOptions
from test_torch_engine_tables import _ref_tables

NEVER32 = lanes.NEVER32

STREAM_PAIR = lp_cfg.STREAM_PAIR
LOSSY_PAIR = STREAM_PAIR.replace('latency "15 ms"',
                                 'latency "15 ms" packet_loss 0.03')
# a 250 ms link: windows may reach RTO_MIN, so stream_wide_pop is off and
# the tier pops same-instant PACKET prefixes, with no delivery elision
SLOW_PAIR = STREAM_PAIR.replace('latency "15 ms"', 'latency "250 ms"').replace(
    "--size, 200kB", "--size, 60kB")
DYN_PAIR = STREAM_PAIR.replace(
    "experimental: {", "experimental: {use_dynamic_runahead: true, ")
# C2 = 8: a burst of up to 24 segments overflows the server's tier row
OVERFLOW_PAIR = STREAM_PAIR.replace(
    "experimental: {", "experimental: {tpu_stream_queue_capacity: 8, "
    "tpu_stream_events_per_round: 4, ")
# test_mixed_mesh_stream_parity's shape: a 12-host UDP mesh whose spray
# crosses two stream pairs
MIXED_ARGS = dict(sim_seconds=2, stream_pairs=2, stream_bytes=200_000,
                  queue_capacity=96, pops_per_round=4)


def _yaml(text):
    def make(pkg, tiered=True):
        cfg = (RefConfig if pkg is ref_presets else ConfigOptions).from_yaml(
            text)
        cfg.experimental.tpu_stream_tiered = tiered
        return cfg
    return make


def _mixed(pkg, tiered=True):
    cfg = pkg.flagship_mesh_config(12, **MIXED_ARGS)
    cfg.experimental.tpu_stream_tiered = tiered
    return cfg


CONFIGS = {
    "pair": _yaml(STREAM_PAIR),
    "lossy_pair": _yaml(LOSSY_PAIR),
    "cubic_pair": _yaml(test_cubic.CUBIC_PAIR),
    "mixed_mesh": _mixed,
    "slow_pair": _yaml(SLOW_PAIR),
    "dyn_pair": _yaml(DYN_PAIR),
}


@functools.lru_cache(maxsize=None)
def _oracle(name: str):
    cfg = CONFIGS[name](ref_presets)
    cfg.experimental.network_backend = "cpu"
    return CpuEngine(cfg).run()


@functools.lru_cache(maxsize=None)
def _reference(name: str):
    """The reference's run of a config, once per config, in device mode
    (its own parity tests hold both of its modes to the CPU oracle); the
    port's step and device runs are each held to it."""
    return TpuEngine(CONFIGS[name](ref_presets)).run(mode="device")


@functools.lru_cache(maxsize=None)
def _port_run(name: str, mode: str, tiered: bool):
    """The port's run of a config on the CPU, and its engine."""
    eng = GpuEngine(CONFIGS[name](port_presets, tiered=tiered), device="cpu")
    return eng, eng.run(mode=mode)


def _ref_numpy(s) -> dict:
    """The reference's state as numpy: its ``()`` placeholders as the
    port's empty int32 arrays, its TierState as ``(flows, q, v)``."""
    out = {}
    for f in lanes.LaneState._fields:
        v = getattr(s, f)
        if f == "stream" and hasattr(v, "q"):
            out[f] = (np.asarray(v.flows), np.asarray(v.q), np.asarray(v.v))
        elif isinstance(v, tuple) and not v:
            out[f] = np.zeros(0, np.int32)
        else:
            out[f] = np.asarray(v)
    return out


def _never_rule(d: dict) -> dict:
    """Empty slots (NEVER time pair) compare by their time words only, in
    the [N] queues and the tier's: the reference's row sorts are unstable
    and leave the other words of empty slots unspecified, and the port's
    tier merge writes them canonical."""
    d = dict(d)
    hole = d["q_thi"] == NEVER32
    for f in ("q_auxh", "q_auxl", "q_size"):
        d[f] = np.where(hole, 0, d[f])
    flows, q, v = d["stream"]
    q = q.copy()
    q[ls.TQ_AUXH:] = np.where(q[ls.TQ_THI] == NEVER32, 0, q[ls.TQ_AUXH:])
    d["stream"] = (flows, q, v)
    return d


def _assert_states_equal(got: dict, want: dict, tag: str) -> None:
    for f in lanes.LaneState._fields:
        if f == "stream":
            for name, a, b in zip(ls.TierState._fields, got[f], want[f]):
                np.testing.assert_array_equal(a, b, err_msg=f"{tag}: {name}")
                assert a.dtype == b.dtype, f"{tag}: {name}"
        else:
            np.testing.assert_array_equal(got[f], want[f],
                                          err_msg=f"{tag}: {f}")
            assert got[f].dtype == want[f].dtype, f"{tag}: {f}"


@pytest.mark.parametrize("name", ["pair", "mixed_mesh"])
def test_tables_and_initial_state_match_reference(name):
    ref = TpuEngine(CONFIGS[name](ref_presets), log_capacity=256)
    port = GpuEngine(CONFIGS[name](port_presets), log_capacity=256,
                     device="cpu")
    assert port.params.stream_tiered and ref.params.stream_tiered
    for f in ("stream_tiered", "stream_pops", "stream_capacity",
              "stream_wide_pop", "stream_clients", "cross_cap"):
        assert getattr(port.params, f) == getattr(ref.params, f), f
    ref_tb = _ref_tables(ref.tables, port.params.s_flows)
    for f in lanes.LaneTables._fields:
        got = getattr(port.tables, f).numpy()
        np.testing.assert_array_equal(got, ref_tb[f], err_msg=f)
        assert got.dtype == ref_tb[f].dtype, f
    assert int(port.tables.lane_stream.sum()) == 2 * port.params.s_flows
    _assert_states_equal(bridge.state_to_numpy(port.initial_state()),
                         _ref_numpy(ref.initial_state()), "initial")
    # the endpoints' start markers sit in the tier, not in their lanes
    tq = port.initial_state().stream.q
    assert int((tq[ls.TQ_THI, :, 0] != NEVER32).sum()) == 2 * port.params.s_flows


@pytest.mark.parametrize("name,rounds", [("pair", 100), ("mixed_mesh", 24)])
def test_rounds_match_reference_field_by_field(name, rounds):
    """Step the reference's ``make_round_fn`` and the port's
    ``_build_round`` one window at a time from the same lifted state and
    compare every field, the tier's queues, vectors and flows and the log
    included, after each live round: the pair through all of them, the
    mixed mesh for 24.  (Once the run is done, the reference writes a
    meaningless window end; the rounds stop there.)"""
    ref = TpuEngine(CONFIGS[name](ref_presets), log_capacity=4096)
    port = GpuEngine(CONFIGS[name](port_presets), log_capacity=4096,
                     device="cpu")
    s_ref = ref.initial_state()
    s_port = bridge.state_from_numpy(_ref_numpy(s_ref))
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
        _assert_states_equal(_never_rule(bridge.state_to_numpy(s_port)),
                             _never_rule(_ref_numpy(s_ref)), f"round {r}")
    assert live >= 20
    assert int(s_port.stream.flows[1, :, ls.C_RX_SEGS].sum()) > 0  # data flowed
    assert int(s_port.log_count) > 0


CASES = [("pair", "step"), ("pair", "device"), ("lossy_pair", "device"),
         ("cubic_pair", "device"), ("mixed_mesh", "device"),
         ("slow_pair", "step"), ("dyn_pair", "device")]


@pytest.mark.parametrize("name,mode", CASES, ids=[f"{n}-{m}" for n, m in CASES])
def test_logs_and_counters_match_reference_and_oracle(name, mode):
    cpu = _oracle(name)
    ref = _reference(name)
    eng, port = _port_run(name, mode, True)
    assert eng.params.stream_tiered
    assert eng.params.stream_wide_pop == (name != "slow_pair")
    assert port.log_tuples() == ref.log_tuples() == cpu.log_tuples()
    assert port.counters == ref.counters
    assert port.rounds == ref.rounds
    for k in ("stream_complete", "stream_rx_bytes", "stream_rx_segs",
              "stream_tx_segs", "stream_flows_done", "stream_retransmits"):
        assert port.counters.get(k) == cpu.counters.get(k), k
    assert port.counters["stream_complete"] == (2 if name == "mixed_mesh"
                                                else 1)
    if name == "lossy_pair":
        assert port.counters["stream_retransmits"] > 0  # recovery ran
        assert any(r.outcome == 1 for r in port.event_log)  # DROP_LOSS rows
    if name == "dyn_pair":
        assert eng.current_runahead() == 15_000_000  # the link was used


def test_tier_overflow_raises_where_the_reference_counts():
    """C2 = 8 and bursts of up to 24 segments: the server's tier row
    overflows.  Strict capacity raises; without it the port counts and
    logs what the reference does."""
    with pytest.raises(RuntimeError, match="lane-queue overflow"):
        GpuEngine(ConfigOptions.from_yaml(OVERFLOW_PAIR),
                  device="cpu").run(mode="device")
    ref = TpuEngine(RefConfig.from_yaml(OVERFLOW_PAIR),
                    strict_capacity=False).run(mode="device")
    port = GpuEngine(ConfigOptions.from_yaml(OVERFLOW_PAIR), device="cpu",
                     strict_capacity=False).run(mode="device")
    assert port.counters["lane_drop_queue"] > 0
    assert port.counters == ref.counters
    assert port.log_tuples() == ref.log_tuples()
    assert any(r.outcome == 3 for r in port.event_log)  # DROP_QUEUE rows


@pytest.mark.parametrize("name", ["pair", "lossy_pair", "mixed_mesh"])
def test_tiered_equals_untiered_on_the_port(name):
    """The two stream paths are one simulation: equal event logs and
    counters (the iteration count aside: the tier pops more per
    iteration), as the reference claims for its own two."""
    runs = {}
    for tiered in (True, False):
        eng, runs[tiered] = _port_run(name, "device", tiered)
        assert eng.params.stream_tiered == tiered
        assert eng.params.split == (not tiered)
    a, b = runs[True], runs[False]
    assert a.log_tuples() == b.log_tuples()
    assert len(a.event_log) > 200
    assert ({k: v for k, v in a.counters.items() if k != "lane_iters"}
            == {k: v for k, v in b.counters.items() if k != "lane_iters"})
    assert a.rounds == b.rounds
