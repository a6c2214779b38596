"""The port's active and lossy lane path against the JAX reference and the
CPU oracle: PHOLD, ping, lossy links, the bootstrap window and dynamic
runahead.

Round by round, every ``LaneState`` field equals the reference's; end to
end, event logs and counters equal ``TpuEngine``'s and ``CpuEngine``'s on
the configurations of ``test_lane_parity.py``.  Integer simulation: every
comparison is exact equality.
"""

import functools

import numpy as np
import pytest

import test_lane_parity as lp_cfg
from shadow_tpu.backend import lanes as ref_lanes
from shadow_tpu.backend.cpu_engine import CpuEngine
from shadow_tpu.backend.tpu_engine import TpuEngine
from shadow_tpu.config.options import ConfigOptions as RefConfig
from shadow_tpu_torch.backend import bridge, lanes
from shadow_tpu_torch.backend.gpu_engine import GpuEngine
from shadow_tpu_torch.config.options import ConfigOptions, LaneCompatError

NEVER32 = lanes.NEVER32

BOOTSTRAP = lp_cfg.TGEN_PAIR.replace(
    "general: {stop_time: 300ms, seed: 3}",
    "general: {stop_time: 300ms, seed: 3, bootstrap_end_time: 150ms}",
)

# the configuration of test_lane_parity.py's test_dynamic_runahead_parity
# (defined inside that test): wide windows while only the 40 ms path
# carries traffic, narrowed by the first 2 ms send
DYNAMIC_RUNAHEAD = """
general: {stop_time: 2s, seed: 13}
network:
  graph:
    type: gml
    inline: |
      graph [
        directed 0
        node [ id 0 host_bandwidth_up "100 Mbit" host_bandwidth_down "100 Mbit" ]
        node [ id 1 host_bandwidth_up "100 Mbit" host_bandwidth_down "100 Mbit" ]
        edge [ source 0 target 0 latency "2 ms" ]
        edge [ source 0 target 1 latency "40 ms" ]
        edge [ source 1 target 1 latency "2 ms" ]
      ]
experimental: {use_dynamic_runahead: true}
hosts:
  a: {network_node_id: 0, processes: [{path: tgen-client, args: "--server b --interval 30ms --size 600"}]}
  b: {network_node_id: 1, processes: [{path: tgen-server}]}
  c: {network_node_id: 1, processes: [{path: ping, args: "--peer d --count 5 --interval 100ms"}]}
  d: {network_node_id: 1, processes: [{path: ping}]}
"""


def _never_rule(d: dict) -> dict:
    """Empty slots (NEVER time pair) compare by their time words only: the
    reference's row sort is unstable and its masked gathers leave the
    other words of empty slots unspecified."""
    d = dict(d)
    hole = d["q_thi"] == NEVER32
    for f in ("q_auxh", "q_auxl", "q_size"):
        d[f] = np.where(hole, 0, d[f])
    return d


@pytest.mark.parametrize("yaml,rounds", [
    (lp_cfg.PHOLD_SMALL, 24), (lp_cfg.TGEN_PAIR, 24),
], ids=["phold_small", "tgen_pair_lossy"])
def test_rounds_match_reference_field_by_field(yaml, rounds):
    """Step the reference's ``make_round_fn`` and the port's
    ``_build_round`` one window at a time from the same lifted state and
    compare every ``LaneState`` field after each round."""
    ref = TpuEngine(RefConfig.from_yaml(yaml), log_capacity=4096)
    port = GpuEngine(ConfigOptions.from_yaml(yaml), log_capacity=4096,
                     device="cpu")
    s_ref = ref.initial_state()
    s_port = bridge.state_from_numpy(
        {f: np.asarray(getattr(s_ref, f)) for f in lanes.LaneState._fields})
    round_ref = ref_lanes.make_round_fn(ref.params, ref.tables)
    round_port = lanes._build_round(port.params, port.tables, s_port)
    for r in range(rounds):
        s_ref, done_ref = round_ref(s_ref)
        assert bool(done_ref) == round_port()
        want = _never_rule(
            {f: np.asarray(getattr(s_ref, f)) for f in lanes.LaneState._fields})
        got = _never_rule(bridge.state_to_numpy(s_port))
        for f in lanes.LaneState._fields:
            np.testing.assert_array_equal(got[f], want[f],
                                          err_msg=f"round {r}: {f}")
    assert int(s_port.rounds) == rounds
    assert int(s_port.log_count) > 10  # traffic really flowed


@functools.lru_cache(maxsize=None)
def _oracle(yaml: str):
    return CpuEngine(RefConfig.from_yaml(yaml)).run()


CONFIGS = {
    "phold_small": (lp_cfg.PHOLD_SMALL, "phold_hops"),
    "tgen_pair_lossy": (lp_cfg.TGEN_PAIR, "lane_drop_loss"),
    "bootstrap": (BOOTSTRAP, "lane_drop_loss"),
    "ping": (lp_cfg.PING, "lane_sends"),
    "far_timer": (lp_cfg.FAR_TIMER, "lane_sends"),
    "dynamic_runahead": (DYNAMIC_RUNAHEAD, "lane_delivered"),
}
CASES = [("phold_small", "step"), ("phold_small", "device"),
         ("tgen_pair_lossy", "step"), ("bootstrap", "step"),
         ("ping", "step"), ("far_timer", "device"),
         ("dynamic_runahead", "device")]


@pytest.mark.parametrize("name,mode", CASES,
                         ids=[f"{n}-{m}" for n, m in CASES])
def test_logs_and_counters_match_reference_and_oracle(name, mode):
    yaml, must = CONFIGS[name]
    cpu = _oracle(yaml)
    ref = TpuEngine(RefConfig.from_yaml(yaml)).run(mode=mode)
    port = GpuEngine(ConfigOptions.from_yaml(yaml), device="cpu").run(mode=mode)
    assert port.log_tuples() == ref.log_tuples() == cpu.log_tuples()
    assert port.counters == ref.counters
    assert port.rounds == ref.rounds
    assert port.counters.get(must, 0) > 0
    if name == "phold_small":
        # the hop counter, against the oracle's app counter too
        assert port.counters["phold_hops"] == cpu.counters["phold_hops"]
    if name == "tgen_pair_lossy":
        assert any(r.outcome == 1 for r in port.event_log)  # DROP_LOSS rows
        assert port.counters["tgen_recv_bytes"] == cpu.counters["tgen_recv_bytes"]


def test_bootstrap_window_is_loss_free():
    lossy = GpuEngine(ConfigOptions.from_yaml(lp_cfg.TGEN_PAIR),
                      device="cpu").run(mode="step")
    boot = GpuEngine(ConfigOptions.from_yaml(BOOTSTRAP), device="cpu").run(
        mode="step")
    first = [r for r in boot.event_log if r.outcome == 1]
    assert first and min(r.time for r in first) >= 150_000_000
    assert 0 < boot.counters["lane_drop_loss"] < lossy.counters["lane_drop_loss"]


def test_dynamic_runahead_narrows_the_window():
    eng = GpuEngine(ConfigOptions.from_yaml(DYNAMIC_RUNAHEAD), device="cpu")
    assert eng.current_runahead() == eng.params.runahead  # before any send
    static = GpuEngine(ConfigOptions.from_yaml(
        DYNAMIC_RUNAHEAD.replace("use_dynamic_runahead: true",
                                 "use_dynamic_runahead: false")),
        device="cpu").run(mode="device")
    res = eng.run(mode="device")
    assert eng.current_runahead() == 2_000_000  # the 2 ms path was used
    # other windows: other rounds, and other arrival clamps
    assert res.rounds != static.rounds
    assert res.log_tuples() != static.log_tuples()


@pytest.mark.parametrize("edit", [
    ("c: {network_node_id: 1, processes: [{path: phold, args: [--messages, \"2\"]}]}",
     "c: {network_node_id: 1, processes: [{path: phold}, {path: phold}]}"),
    ("c: {network_node_id: 1,", "c: {network_node_id: 1, pcap_enabled: true,"),
    ("general: {stop_time: 500ms, seed: 7}",
     "general: {stop_time: 500ms, seed: 7}\nexperimental: {netobs: true}"),
    ("path: phold, args: [--messages, \"2\"]", "path: stream-server"),
], ids=["multi_process_phold", "pcap", "netobs", "stream_model"])
def test_unported_active_configs_raise(edit):
    """What the port refuses on the active path.  pcap and netobs are
    ported now: pcap is refused only without the device log it rides, and
    netobs not at all."""
    yaml = lp_cfg.PHOLD_SMALL.replace(*edit)
    assert yaml != lp_cfg.PHOLD_SMALL
    if "pcap_enabled" in edit[1]:
        assert GpuEngine(ConfigOptions.from_yaml(yaml), device="cpu")
        with pytest.raises(LaneCompatError, match="pcap"):
            GpuEngine(ConfigOptions.from_yaml(yaml), log_capacity=0,
                      device="cpu")
        return
    if "netobs" in edit[1]:
        assert GpuEngine(ConfigOptions.from_yaml(yaml), device="cpu").params.netobs
        return
    with pytest.raises(LaneCompatError) as err:
        GpuEngine(ConfigOptions.from_yaml(yaml), device="cpu")
    if edit[1].endswith("{path: phold}]}"):
        # the reference's wording (test_lane_parity.py test_lane_compat_gate)
        assert "tgen mesh/client/server" in str(err.value)
        with pytest.raises(Exception, match="tgen mesh/client/server"):
            TpuEngine(RefConfig.from_yaml(yaml))
