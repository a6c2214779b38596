"""The port's tables and initial state against the JAX reference's.

``GpuEngine(cfg, device="cpu")`` and ``TpuEngine`` build from the same
config; every field the port carries must be equal, through the numpy
bridge.  Integer data: the tolerance is exact equality.
"""

import numpy as np
import pytest
import torch

from shadow_tpu.backend.tpu_engine import TpuEngine
from shadow_tpu.config import presets as ref_presets
from shadow_tpu_torch.backend import bridge
from shadow_tpu_torch.backend.gpu_engine import GpuEngine
from shadow_tpu_torch.backend.lanes import LaneState, LaneTables
from shadow_tpu_torch.config import presets as port_presets


def _graft(pkg):
    # the compile-check shape of __graft_entry__.py's entry()
    return pkg.flagship_mesh_config(64, sim_seconds=1, queue_capacity=32,
                                    pops_per_round=4)


def _star(pkg):
    return pkg.udp_star_config(16)


def _numpy(nt, fields):
    return {f: np.asarray(getattr(nt, f)) for f in fields}


@pytest.mark.parametrize("make", [_graft, _star], ids=["graft", "udp_star16"])
def test_tables_and_initial_state_match_reference(make):
    ref = TpuEngine(make(ref_presets), log_capacity=256)
    port = GpuEngine(make(port_presets), log_capacity=256, device="cpu")
    ref_tb = _numpy(ref.tables, LaneTables._fields)
    port_tb = _numpy(port.tables, LaneTables._fields)
    for f in LaneTables._fields:
        np.testing.assert_array_equal(port_tb[f], ref_tb[f], err_msg=f)
        assert port_tb[f].dtype == ref_tb[f].dtype, f
    ref_s = _numpy(ref.initial_state(), LaneState._fields)
    port_s = bridge.state_to_numpy(port.initial_state())
    for f in LaneState._fields:
        np.testing.assert_array_equal(port_s[f], ref_s[f], err_msg=f)
        assert port_s[f].dtype == ref_s[f].dtype, f
    for f in ("n_lanes", "capacity", "pops_per_iter", "log_capacity",
              "stop_time", "runahead", "bucket_interval", "cross_capacity"):
        assert getattr(port.params, f) == getattr(ref.params, f), f
    # the reference's dicts lift into the port's types unchanged
    lifted = bridge.tables_from_numpy(ref_tb)
    for f in LaneTables._fields:
        assert torch.equal(getattr(lifted, f), getattr(port.tables, f)), f


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
    ("hosts:", "faults: {events: [{at: 50ms, kind: link_down, source: 0, target: 0}]}\nhosts:"),
    ("hosts:", "experimental: {netobs: true}\nhosts:"),
    ("hosts:", "experimental: {flowtrace: true}\nhosts:"),
    ("hosts:", "experimental: {use_dynamic_runahead: true}\nhosts:"),
    ("hosts:", "experimental: {tpu_round_unroll: 2}\nhosts:"),
    ("m: {count: 4,", "m: {count: 4, pcap_enabled: true,"),
    ("path: tgen-mesh", "path: phold"),
    ('latency "1 ms"', 'latency "1 ms" packet_loss 0.01'),
], ids=["faults", "netobs", "flowtrace", "dynamic_runahead", "unroll",
        "pcap", "phold", "lossy_edge"])
def test_unported_configs_raise(edit):
    from shadow_tpu_torch.config.options import ConfigOptions, LaneCompatError

    assert GpuEngine(ConfigOptions.from_yaml(_MESH), device="cpu")
    with pytest.raises(LaneCompatError):
        GpuEngine(ConfigOptions.from_yaml(_MESH.replace(*edit)), device="cpu")
