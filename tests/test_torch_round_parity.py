"""The port's window loop against the JAX reference and the CPU oracle.

Integer simulation: every comparison is exact equality.
"""

import numpy as np
import pytest

import test_lane_parity as lp_cfg
from shadow_tpu.backend import lanes as ref_lanes
from shadow_tpu.backend.cpu_engine import CpuEngine
from shadow_tpu.backend.tpu_engine import TpuEngine
from shadow_tpu.config import presets as ref_presets
from shadow_tpu.config.options import ConfigOptions as RefConfig
from shadow_tpu_torch.backend import bridge, lanes
from shadow_tpu_torch.backend.gpu_engine import GpuEngine
from shadow_tpu_torch.config import presets as port_presets
from shadow_tpu_torch.config.options import ConfigOptions

NEVER32 = lanes.NEVER32


def _never_rule(d: dict) -> dict:
    """Empty slots (NEVER time pair) compare by their time words only."""
    d = dict(d)
    hole = d["q_thi"] == NEVER32
    for f in ("q_auxh", "q_auxl", "q_size"):
        d[f] = np.where(hole, 0, d[f])
    return d


def test_rounds_match_reference_field_by_field():
    """Step the reference and the port one window at a time from the same
    lifted state on __graft_entry__.py's shape (64 hosts, C=32, K=4) and
    compare every LaneState field after each round.

    Slots whose time pair is NEVER compare by their time words only: the
    reference's row sort is unstable and its masked gathers leave the other
    words of empty slots unspecified, so those words carry no meaning."""
    cfg_args = dict(sim_seconds=1, queue_capacity=32, pops_per_round=4)
    ref = TpuEngine(ref_presets.flagship_mesh_config(64, **cfg_args),
                    log_capacity=4096)
    port = GpuEngine(port_presets.flagship_mesh_config(64, **cfg_args),
                     log_capacity=4096, device="cpu")
    s_ref = ref.initial_state()
    s_port = bridge.state_from_numpy(
        {f: np.asarray(getattr(s_ref, f)) for f in lanes.LaneState._fields})
    round_ref = ref_lanes.make_round_fn(ref.params, ref.tables)
    round_port = lanes._build_round(port.params, port.tables, s_port)
    for r in range(20):
        s_ref, done_ref = round_ref(s_ref)
        done_port = round_port()
        assert bool(done_ref) == done_port
        want = _never_rule(
            {f: np.asarray(getattr(s_ref, f)) for f in lanes.LaneState._fields})
        got = _never_rule(bridge.state_to_numpy(s_port))
        for f in lanes.LaneState._fields:
            np.testing.assert_array_equal(got[f], want[f],
                                          err_msg=f"round {r}: {f}")
    assert int(s_port.log_count) > 1000  # the mesh really ran
    assert int(s_port.rounds) == 20


CONFIGS = {
    "mesh": lp_cfg.MESH,
    "mesh_narrow_cross": lp_cfg.MESH_NARROW_CROSS,
    "capacity_23": lp_cfg.MESH.replace(
        "general: {stop_time: 200ms, seed: 11}",
        "general: {stop_time: 200ms, seed: 11}\n"
        "experimental: {tpu_lane_queue_capacity: 23}"),
    "bottleneck": lp_cfg.BOTTLENECK,
    "sink_drain": lp_cfg.SINK_DRAIN,
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_logs_and_counters_match_reference_and_oracle(name):
    yaml = CONFIGS[name]
    cpu = CpuEngine(RefConfig.from_yaml(yaml)).run()
    ref = TpuEngine(RefConfig.from_yaml(yaml)).run(mode="step")
    port = GpuEngine(ConfigOptions.from_yaml(yaml), device="cpu").run(mode="step")
    assert len(cpu.event_log) > 50
    assert port.log_tuples() == ref.log_tuples() == cpu.log_tuples()
    assert port.counters == ref.counters
    assert port.counters.get("tgen_recv_bytes") == cpu.counters.get("tgen_recv_bytes")
    assert port.rounds == ref.rounds
    if name == "bottleneck":
        assert port.counters["lane_drop_codel"] > 0  # CoDel really dropped


@pytest.mark.parametrize("name", ["mesh_narrow_cross", "sink_drain"])
def test_device_mode_equals_step_mode(name):
    """The device loop reads the live flag only every few steps; the
    trailing steps must be no-ops, so lane_iters and rounds match the step
    driver's (which the test above holds to the reference's)."""
    yaml = CONFIGS[name]
    step = GpuEngine(ConfigOptions.from_yaml(yaml), device="cpu").run(mode="step")
    dev = GpuEngine(ConfigOptions.from_yaml(yaml), device="cpu").run(mode="device")
    assert dev.log_tuples() == step.log_tuples()
    assert dev.counters == step.counters
    assert dev.rounds == step.rounds


def test_overflow_raises_loudly():
    """40 synchronized senders blast one sink: the sink lane receives a
    burst larger than its queue in one window and must raise, not
    diverge (the reference's test_overflow_raises_loudly config)."""
    yaml = """
general: {stop_time: 100ms, seed: 2}
experimental: {tpu_lane_queue_capacity: 9}
network:
  graph:
    type: gml
    inline: |
      graph [
        directed 0
        node [ id 0 host_bandwidth_up "1 Gbit" host_bandwidth_down "1 Gbit" ]
        edge [ source 0 target 0 latency "1 ms" ]
      ]
hosts:
  c: {count: 40, network_node_id: 0, processes: [{path: tgen-client, args: [--server, sink, --interval, 5ms, --size, "300"]}]}
  sink: {network_node_id: 0}
"""
    with pytest.raises(RuntimeError, match="lane-queue overflow"):
        GpuEngine(ConfigOptions.from_yaml(yaml), device="cpu").run(mode="step")
    # non-strict runs report the shed events instead
    res = GpuEngine(ConfigOptions.from_yaml(yaml), strict_capacity=False,
                    device="cpu").run(mode="step")
    assert res.counters["lane_drop_queue"] > 0
