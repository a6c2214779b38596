"""The port's tables and initial state against the JAX reference's.

``GpuEngine(cfg, device="cpu")`` and ``TpuEngine`` build from the same
config; every field the port carries must be equal, through the numpy
bridge.  Integer data: the tolerance is exact equality.

The loss thresholds are kept in another layout: the reference's
``thresh_u32`` (uint32) and ``thresh_all`` (bool) pairs, per node pair and
per stream endpoint, are compared, through ``bridge.thresh_from_split``,
with the port's int64 ``thresh`` and ``flow_thresh`` — and the node-pair
table with ``loss_threshold`` of the graph's edge losses.  The port's
lane -> endpoint-row table has no reference counterpart and is compared
with ``bridge.lane_endpoints`` of the reference's ``flow_lanes``; the
reference's ``()`` stream fields (no stream model present) are the port's
empty int32 tensors.
"""

import numpy as np
import pytest
import torch

import test_lane_parity as lp_cfg
from shadow_tpu.backend.tpu_engine import TpuEngine
from shadow_tpu.config import presets as ref_presets
from shadow_tpu.config.options import ConfigOptions as RefConfig
from shadow_tpu_torch.backend import bridge
from shadow_tpu_torch.backend.gpu_engine import GpuEngine
from shadow_tpu_torch.backend.lanes import LaneState, LaneTables
from shadow_tpu_torch.config import presets as port_presets
from shadow_tpu_torch.config.options import ConfigOptions
from shadow_tpu_torch.core.rng import loss_threshold


def _graft(pkg):
    # the compile-check shape of __graft_entry__.py's entry()
    return pkg.flagship_mesh_config(64, sim_seconds=1, queue_capacity=32,
                                    pops_per_round=4)


def _star(pkg):
    return pkg.udp_star_config(16)


def _yaml(text):
    def make(pkg):
        return (RefConfig if pkg is ref_presets else ConfigOptions).from_yaml(text)
    return make


# phold, lossy tgen with a bootstrap window, ping, and dynamic runahead
# over a lossy two-node graph with a ping pair
_ACTIVE = {
    "phold": lp_cfg.PHOLD_SMALL,
    "tgen_lossy_bootstrap": lp_cfg.TGEN_PAIR.replace(
        "general: {stop_time: 300ms, seed: 3}",
        "general: {stop_time: 300ms, seed: 3, bootstrap_end_time: 150ms}"),
    "ping": lp_cfg.PING,
    "dynamic_runahead_lossy": """
general: {stop_time: 1s, seed: 18446744073709551615}
network:
  graph:
    type: gml
    inline: |
      graph [
        directed 0
        node [ id 0 host_bandwidth_up "100 Mbit" host_bandwidth_down "100 Mbit" ]
        node [ id 1 host_bandwidth_up "100 Mbit" host_bandwidth_down "100 Mbit" ]
        edge [ source 0 target 0 latency "2 ms" packet_loss 1.0 ]
        edge [ source 0 target 1 latency "40 ms" packet_loss 0.01 ]
        edge [ source 1 target 1 latency "2 ms" ]
      ]
experimental: {use_dynamic_runahead: true, runahead: 3ms}
hosts:
  a: {network_node_id: 0, processes: [{path: ping, args: "--peer b --count 3000000000 --interval 30ms"}]}
  b: {network_node_id: 1, processes: [{path: ping}]}
  c: {network_node_id: 0, processes: [{path: phold, args: [--messages, "0"]}]}
""",
    # streams: the star (combined exchange, a lossy edge: thresholds per
    # endpoint) and the one-to-one pair on the untiered path, with CUBIC
    "stream_star": lp_cfg.STREAM_STAR,
    "stream_pair_untiered_cubic": lp_cfg.STREAM_PAIR.replace(
        "experimental: {", "experimental: {tpu_stream_tiered: false, ").replace(
        "c: {network_node_id: 0,", "c: {network_node_id: 0, congestion: cubic,"),
}


def _numpy(nt, fields):
    return {f: np.asarray(getattr(nt, f)) for f in fields}


_PORT_ONLY = ("thresh", "flow_thresh", "lane_ep_start", "lane_ep_rows")


def _ref_tables(tb, s_flows):
    # the tiered backend's tables are () off the tier: the port's empty
    # tensors of the field's own dtype
    d = {f: (np.zeros(0, bool if f == "lane_stream" else np.int32)
             if isinstance(getattr(tb, f), tuple) and not getattr(tb, f)
             else np.asarray(getattr(tb, f)))
         for f in LaneTables._fields if f not in _PORT_ONLY}
    d["thresh"] = bridge.thresh_from_split(tb.thresh_u32, tb.thresh_all)
    d["flow_thresh"] = bridge.thresh_from_split(tb.flow_thresh_u32,
                                                tb.flow_thresh_all)
    d["lane_ep_start"], d["lane_ep_rows"] = bridge.lane_endpoints(
        tb.flow_lanes, len(d["node_of"]), s_flows)
    return d


def _ref_state(s):
    """The reference's state as numpy, its () stream placeholders as the
    port's empty int32 arrays."""
    return {f: (np.zeros(0, np.int32) if isinstance(getattr(s, f), tuple)
                and not getattr(s, f) else np.asarray(getattr(s, f)))
            for f in LaneState._fields}


@pytest.mark.parametrize(
    "make", [_graft, _star] + [_yaml(t) for t in _ACTIVE.values()],
    ids=["graft", "udp_star16"] + list(_ACTIVE))
def test_tables_and_initial_state_match_reference(make):
    ref = TpuEngine(make(ref_presets), log_capacity=256)
    port = GpuEngine(make(port_presets), log_capacity=256, device="cpu")
    ref_tb = _ref_tables(ref.tables, port.params.s_flows)
    port_tb = _numpy(port.tables, LaneTables._fields)
    for f in LaneTables._fields:
        np.testing.assert_array_equal(port_tb[f], ref_tb[f], err_msg=f)
        assert port_tb[f].dtype == ref_tb[f].dtype, f
    ref_s = _ref_state(ref.initial_state())
    port_s = bridge.state_to_numpy(port.initial_state())
    for f in LaneState._fields:
        np.testing.assert_array_equal(port_s[f], ref_s[f], err_msg=f)
        assert port_s[f].dtype == ref_s[f].dtype, f
    for f in ("n_lanes", "capacity", "pops_per_iter", "log_capacity",
              "stop_time", "runahead", "bucket_interval", "cross_capacity",
              "seed", "bootstrap_end", "models_present", "all_passive",
              "has_loss", "dynamic_runahead", "runahead_floor",
              "stream_present", "stream_one_to_one", "stream_clients",
              "stream_wide_pop"):
        assert getattr(port.params, f) == getattr(ref.params, f), f
    assert port.params.merge_width == port.params.capacity + (
        1 if ref.params.all_passive else 2) * ref.params.pops_per_iter + (
        ref.params.cross_cap)
    # the reference's split thresholds lift into the port's int64 table
    lifted = bridge.tables_from_numpy(_numpy(ref.tables, ref.tables._fields),
                                      s_flows=port.params.s_flows)
    for f in LaneTables._fields:
        assert torch.equal(getattr(lifted, f), getattr(port.tables, f)), f
    # and that table is loss_threshold of each node pair's path loss
    loss = port.routing.graph.packet_loss
    want = np.vectorize(loss_threshold, otypes=[np.int64])(loss)
    np.testing.assert_array_equal(port_tb["thresh"], want)


def test_active_tables_carry_the_models():
    """The phold, ping and loss columns really carry the config."""
    phold = GpuEngine(ConfigOptions.from_yaml(lp_cfg.PHOLD_SMALL), device="cpu")
    assert phold.tables.model.tolist() == [1, 1, 1]
    assert phold.initial_state().local_seq.tolist() == [3, 3, 2]
    assert not phold.params.all_passive and phold.params.draws
    dyn = GpuEngine(ConfigOptions.from_yaml(_ACTIVE["dynamic_runahead_lossy"]),
                    device="cpu")
    assert dyn.tables.p_count.tolist() == [(1 << 31) - 1, 0, 0]
    assert dyn.tables.thresh.tolist() == [[1 << 32, 42949672], [42949672, 0]]
    assert dyn.params.runahead_floor == 3_000_000


def test_state_bridge_round_trips():
    eng = GpuEngine(_graft(port_presets), log_capacity=16, device="cpu")
    s = eng.initial_state()
    back = bridge.state_from_numpy(bridge.state_to_numpy(s))
    for f in LaneState._fields:
        a, b = getattr(s, f), getattr(back, f)
        assert a.dtype == b.dtype and torch.equal(a, b), f


def test_bridge_refuses_a_wrong_dtype():
    d = bridge.state_to_numpy(
        GpuEngine(_star(port_presets), device="cpu").initial_state())
    d["q_thi"] = d["q_thi"].astype(np.int64)
    with pytest.raises(TypeError, match="q_thi"):
        bridge.state_from_numpy(d)


_MESH = """
general: {stop_time: 100ms}
network:
  graph:
    type: gml
    inline: |
      graph [ node [ id 0 host_bandwidth_up "1 Gbit" host_bandwidth_down "1 Gbit" ]
              edge [ source 0 target 0 latency "1 ms" ] ]
hosts:
  m: {count: 4, processes: [{path: tgen-mesh}]}
"""


@pytest.mark.parametrize("edit", [
    ("hosts:", "faults: {watchdog_timeout: 5.0, events: [{at: 50ms, kind: link_down, source: 0, target: 0}]}\nhosts:"),
    ("hosts:", "experimental: {netobs: true}\nhosts:"),
    ("hosts:", "experimental: {flowtrace: true}\nhosts:"),
    ("hosts:", "experimental: {tpu_round_unroll: 2}\nhosts:"),
    ("m: {count: 4,", "m: {count: 4, pcap_enabled: true,"),
    ("{path: tgen-mesh}", "{path: phold}, {path: phold}"),
    ("path: tgen-mesh", "path: tgen-tcp-server"),
], ids=["faults", "netobs", "flowtrace", "unroll", "pcap",
        "multi_process_phold", "tgen_tcp_server"])
def test_unported_configs_raise(edit):
    """What the port refuses.  pcap, netobs and flowtrace are ported now:
    pcap is refused only without the device log it rides, netobs and
    flowtrace not at all.  Fault schedules are ported too; what stays
    refused there is the watchdog and the CPU failover."""
    from shadow_tpu_torch.config.options import ConfigOptions, LaneCompatError

    assert GpuEngine(ConfigOptions.from_yaml(_MESH), device="cpu")
    yaml = _MESH.replace(*edit)
    if "pcap_enabled" in edit[1]:
        cfg = ConfigOptions.from_yaml(yaml)
        assert GpuEngine(cfg, device="cpu").params.pcap_any
        with pytest.raises(LaneCompatError, match="pcap"):
            GpuEngine(cfg, log_capacity=0, device="cpu")
        return
    if "netobs" in edit[1]:
        assert GpuEngine(ConfigOptions.from_yaml(yaml), device="cpu").params.netobs
        return
    if "flowtrace" in edit[1]:
        assert GpuEngine(ConfigOptions.from_yaml(yaml),
                         device="cpu").params.flowtrace
        return
    with pytest.raises(LaneCompatError):
        GpuEngine(ConfigOptions.from_yaml(yaml), device="cpu")


@pytest.mark.parametrize("edit", [
    ("hosts:", "experimental: {use_dynamic_runahead: true}\nhosts:"),
    ("path: tgen-mesh", "path: phold"),
    ('latency "1 ms"', 'latency "1 ms" packet_loss 0.01'),
    # two of the four hosts become an untiered one-to-one stream pair
    ("hosts:\n  m: {count: 4,",
     "experimental: {tpu_stream_tiered: false}\nhosts:\n"
     "  c: {processes: [{path: stream-client, args: [--server, s]}]}\n"
     "  s: {processes: [{path: stream-server}]}\n  m: {count: 2,"),
    # the same pair on the tiered stream backend (the default)
    ("hosts:\n  m: {count: 4,",
     "hosts:\n"
     "  c: {processes: [{path: stream-client, args: [--server, s]}]}\n"
     "  s: {processes: [{path: stream-server}]}\n  m: {count: 2,"),
    ("hosts:", "faults: {events: [{at: 50ms, kind: link_down, source: 0, target: 0}]}\nhosts:"),
], ids=["dynamic_runahead", "phold", "lossy_edge", "stream_pair_untiered",
        "stream_pair_tiered", "faults"])
def test_ported_configs_build(edit):
    """What the earlier slices refused and this one runs."""
    from shadow_tpu_torch.config.options import ConfigOptions

    yaml = _MESH.replace(*edit)
    assert yaml != _MESH
    eng = GpuEngine(ConfigOptions.from_yaml(yaml), device="cpu")
    assert eng.params.n_lanes == 4
