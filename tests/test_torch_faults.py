"""Fault schedules on the port against the JAX reference and the CPU oracle.

A faulted run is segmented at the fault epochs, each segment an ordinary
run against that epoch's latency and loss tables, so no window straddles
a fault.  On the configurations of ``test_lane_parity.py`` and
``test_faults.py``, the port's event log and counters equal
``TpuEngine``'s and ``CpuEngine``'s; the overlay's snapshots and segment
plans equal the reference's array for array.  Integer simulation: every
comparison is exact equality.
"""

import functools

import numpy as np
import pytest

import test_faults as fl_cfg
import test_lane_parity as lp_cfg
from shadow_tpu.backend.cpu_engine import CpuEngine
from shadow_tpu.backend.tpu_engine import TpuEngine
from shadow_tpu.config.options import ConfigOptions as RefConfig
from shadow_tpu.faults.overlay import build_overlay as ref_build_overlay
from shadow_tpu_torch.backend.gpu_engine import GpuEngine
from shadow_tpu_torch.config.options import ConfigOptions, LaneCompatError
from shadow_tpu_torch.faults import BackendStallError

# test_faults.py's partition/heal config, without the reference's
# heartbeat knob (the port has no heartbeat)
PARTITION_HEAL = fl_cfg.BASE.replace(", heartbeat_interval: null", "")

CRASH_RESTART = PARTITION_HEAL.replace(
    """    - {at: 1s, kind: partition, groups: [[0], [1]]}
    - {at: 2s, kind: heal}""",
    """    - {at: 1s, kind: host_crash, host: a}
    - {at: 1400ms, kind: latency, source: 0, target: 1, latency: "15 ms"}
    - {at: 2s, kind: host_restart, host: a}""")

# test_faults.py's test_mid_flow_loss_ramp_stream_parity (defined inside
# that test): a lane-TCP flow through a loss ramp that forces
# retransmissions mid-transfer
LOSS_RAMP = """
general: {stop_time: 2s, seed: 5}
network:
  graph:
    type: gml
    inline: |
      graph [
        directed 0
        node [ id 0 host_bandwidth_up "50 Mbit" host_bandwidth_down "50 Mbit" ]
        node [ id 1 host_bandwidth_up "50 Mbit" host_bandwidth_down "50 Mbit" ]
        edge [ source 0 target 1 latency "10 ms" ]
      ]
faults:
  events:
    - {at: 20ms, kind: loss, source: 0, target: 1, loss: 0.25}
    - {at: 60ms, kind: loss, source: 0, target: 1, loss: 0.0}
hosts:
  c1: {network_node_id: 0, processes: [{path: stream-client, args: [--server, s1, --size, "300 kB"]}]}
  s1: {network_node_id: 1, processes: [{path: stream-server}]}
"""

# every event kind over a three-node triangle (a link_down reroutes): hosts
# a, b, c on their own nodes
EVERY_KIND = """
general: {stop_time: 1s, seed: 3}
network:
  graph:
    type: gml
    inline: |
      graph [
        directed 0
        node [ id 0 host_bandwidth_up "10 Mbit" host_bandwidth_down "10 Mbit" ]
        node [ id 1 host_bandwidth_up "10 Mbit" host_bandwidth_down "10 Mbit" ]
        node [ id 2 host_bandwidth_up "10 Mbit" host_bandwidth_down "10 Mbit" ]
        edge [ source 0 target 0 latency "1 ms" ]
        edge [ source 1 target 1 latency "1 ms" ]
        edge [ source 2 target 2 latency "1 ms" ]
        edge [ source 0 target 1 latency "5 ms" packet_loss 0.01 ]
        edge [ source 1 target 2 latency "4 ms" ]
        edge [ source 0 target 2 latency "7 ms" ]
      ]
faults:
  events:
    - {at: 100ms, kind: link_down, source: 0, target: 1}
    - {at: 100ms, kind: loss, source: 1, target: 2, loss: 0.1}
    - {at: 200ms, kind: latency, source: 0, target: 2, latency: "30 ms"}
    - {at: 300ms, kind: partition, groups: [[0], [1, 2]]}
    - {at: 400ms, kind: heal}
    - {at: 500ms, kind: host_crash, host: c}
    - {at: 600ms, kind: host_restart, host: c}
    - {at: 600ms, kind: link_up, source: 0, target: 1}
    - {at: 700ms, kind: backend_stall}
hosts:
  a: {network_node_id: 0, processes: [{path: tgen-client, args: [--server, c, --interval, 20ms, --size, "600"]}]}
  b: {network_node_id: 1, processes: [{path: tgen-server}]}
  c: {network_node_id: 2, processes: [{path: tgen-server}]}
"""


@functools.lru_cache(maxsize=None)
def _reference(yaml: str):
    """The reference's faulted device-mode run and the oracle's, once per
    worker, for the port's step and device runs alike: the reference's
    step mode gives the same log, counters and rounds on these configs,
    and compiling it too would double the XLA time these tests spend."""
    tpu = TpuEngine(RefConfig.from_yaml(yaml)).run(mode="device")
    cpu = CpuEngine(RefConfig.from_yaml(yaml)).run()
    return tpu, cpu


def _port(yaml: str, mode: str, **experimental):
    cfg = ConfigOptions.from_yaml(yaml)
    for k, v in experimental.items():
        setattr(cfg.experimental, k, v)
    return GpuEngine(cfg, device="cpu").run(mode=mode)


def _assert_parity(yaml: str, mode: str, **experimental):
    """The port's log and counters against the reference's run of
    ``yaml`` and the oracle's.  With ``tpu_stream_tiered`` changed, the
    port takes the other stream path than the reference: the same events
    in other iterations and windows."""
    tpu, cpu = _reference(yaml)
    port = _port(yaml, mode, **experimental)
    assert port.log_tuples() == tpu.log_tuples() == cpu.log_tuples()
    if experimental.get("tpu_stream_tiered", True):
        assert port.counters == tpu.counters
        assert port.rounds == tpu.rounds
    else:
        assert ({**port.counters, "lane_iters": 0}
                == {**tpu.counters, "lane_iters": 0})
    return port, cpu


@pytest.mark.parametrize("mode", ["step", "device"])
def test_fault_schedule_parity(mode):
    """``test_lane_parity.py``'s twin: a latency shift, a dark window and
    a restore re-upload the tables mid-run; logs equal, step and device."""
    port, cpu = _assert_parity(lp_cfg.TGEN_FAULTED, mode)
    assert len(port.event_log) > 20
    assert any(r.outcome == 1 for r in port.event_log)  # the dark window
    assert port.counters["tgen_recv_bytes"] == cpu.counters["tgen_recv_bytes"]


@pytest.mark.parametrize("mode", ["step", "device"])
def test_partition_heal_parity(mode):
    port, cpu = _assert_parity(PARTITION_HEAL, mode)
    assert port.counters["lane_drop_loss"] > 0  # the partition bit
    assert port.counters["tgen_recv_bytes"] == cpu.counters["tgen_recv_bytes"]


def test_crash_restart_parity():
    port, _cpu = _assert_parity(CRASH_RESTART, "device")
    assert port.counters["lane_drop_loss"] > 0


def test_mid_flow_loss_ramp_stream_parity():
    """The ramp re-gathers the flows' latency and loss tables (on the tier
    too): retransmissions, logs equal to the reference's on both stream
    paths of the port, the tiered (the reference's own) and the untiered
    one."""
    for tiered in (True, False):
        port, cpu = _assert_parity(LOSS_RAMP, "device",
                                   tpu_stream_tiered=tiered)
        assert cpu.counters["stream_retransmits"] > 0  # the ramp bit
        assert port.counters["stream_retransmits"] == cpu.counters[
            "stream_retransmits"]


def _overlays(yaml: str):
    ref_cfg = RefConfig.from_yaml(yaml)
    ref_eng = CpuEngine(ref_cfg)
    ref = ref_build_overlay(ref_cfg, ref_eng.graph, ref_eng.routing)
    port = GpuEngine(ConfigOptions.from_yaml(yaml), device="cpu")
    return ref, port._fault_overlay, port


def test_overlay_snapshots_match_reference():
    """Every event kind: the cumulative snapshots, epoch for epoch."""
    ref, port, _eng = _overlays(EVERY_KIND)
    assert port.epoch_times() == ref.epoch_times() == [
        t * 100_000_000 for t in range(1, 8)]
    for a, b in zip(port._snapshots, ref._snapshots, strict=True):
        assert a.at == b.at and a.stall == b.stall
        for f in ("latency_ns", "packet_loss", "loss_threshold"):
            x, y = getattr(a, f), getattr(b, f)
            assert x.dtype == y.dtype and np.array_equal(x, y), (a.at, f)
    assert [s.stall for s in port._snapshots] == [False] * 6 + [True]
    # the reroute, the partition and the crash changed the tables
    lat = [s.latency_ns[0, 1] for s in port._snapshots]
    assert lat[0] == 11_000_000 and lat[-1] == 5_000_000
    assert port._snapshots[2].loss_threshold[0, 1] == 1 << 32
    assert port._snapshots[4].loss_threshold[2, 0] == 1 << 32
    assert port.max_latency_ns() == ref.max_latency_ns()
    assert port.any_loss() == ref.any_loss()


@pytest.mark.parametrize("pad_to", [0, 9, 12])
def test_segment_plan_matches_reference(pad_to):
    ref, port, eng = _overlays(EVERY_KIND)
    stop = eng.params.stop_time

    def rows(plan):
        return [(a, b, None if s is None else s.at) for a, b, s in plan]

    want = rows(ref.segment_plan(stop, pad_to=pad_to))
    assert rows(port.segment_plan(stop, pad_to=pad_to)) == want
    assert rows(eng.segment_plan(pad_to=pad_to)) == want
    assert len(want) == max(pad_to, 8)


def test_padded_plan_matches_unpadded():
    """Trailing zero-length rows change nothing (``test_sweep.py``'s
    padded-plan twin, on the port's serial faulted path)."""
    cfg = lp_cfg.TGEN_FAULTED
    ref = _port(cfg, "device")
    for mode in ("device", "step"):
        eng = GpuEngine(ConfigOptions.from_yaml(cfg), device="cpu")
        state = eng.initial_state()
        eng._run_faulted(mode, state, eng.segment_plan(pad_to=7))
        padded = eng.collect(state, 0.0)
        assert padded.log_tuples() == ref.log_tuples()
        assert padded.counters == ref.counters and padded.rounds == ref.rounds


def test_backend_stall_raises():
    eng = GpuEngine(ConfigOptions.from_yaml(EVERY_KIND), device="cpu")
    assert eng.params.has_loss
    for mode in ("device", "step"):
        with pytest.raises(BackendStallError, match="700000000 ns"):
            eng.run(mode=mode)


@pytest.mark.parametrize("knob", ["watchdog_timeout: 5.0", "failover: true"])
def test_failover_knobs_are_refused(knob):
    yaml = PARTITION_HEAL.replace("faults:\n", f"faults:\n  {knob}\n")
    assert yaml != PARTITION_HEAL
    with pytest.raises(LaneCompatError, match="item 12"):
        GpuEngine(ConfigOptions.from_yaml(yaml), device="cpu")
    # failover: false only makes stalls fatal, which they are
    off = PARTITION_HEAL.replace("faults:\n", "faults:\n  failover: false\n")
    assert GpuEngine(ConfigOptions.from_yaml(off), device="cpu")


def test_fault_epochs_fold_into_the_static_parameters():
    """A loss-free graph whose schedule brings loss draws from the start;
    a latency raise widens the epoch bound that the wide stream pop
    checks."""
    yaml = lp_cfg.TGEN_FAULTED.replace(" packet_loss 0.2", "")
    eng = GpuEngine(ConfigOptions.from_yaml(yaml), device="cpu")
    assert eng.params.has_loss  # the link_down epoch drops everything
    assert eng._fault_overlay.max_latency_ns() == 25_000_000
    ramp = GpuEngine(ConfigOptions.from_yaml(LOSS_RAMP), device="cpu")
    assert ramp.params.has_loss and ramp.params.stream_wide_pop
    tb = ramp.segment_tables(ramp.segment_plan()[1][2])
    assert tb.flow_thresh.tolist() == [1 << 30] * 2  # loss 0.25 both ways
    assert tb.flow_lat.tolist() == ramp.tables.flow_lat.tolist()
