"""The port's observation planes against the JAX reference and the CPU
oracle: pcap capture (a capturing host's sends become PCAP_TX records in
the device log, and the capture files are written from the log) and the
netobs telemetry plane (the ``nb_*`` counters, the tier's ``TV_NB_*`` rows
and the histogram of windows by their popped packets).

The configurations are ``test_telemetry.py``'s drop-heavy mesh, lossy
stream pair (with pcap) and PHOLD ring, its 40-host tiered mixed mesh, and
``test_pcap.py``'s two lane-backend capture configurations, each with both
planes on (pcap at every other host where the configuration has none),
each run once per engine.  Snapshots equal the reference's and the
oracle's counter for counter, capture files byte for byte, the port's step
mode its device mode; rounds equal the reference's ``make_round_fn`` field
by field, the log and the ``nb_*`` fields included.  Integer simulation:
every comparison is exact equality.
"""

import numpy as np
import pytest
import yaml as pyyaml

import test_telemetry as tel
from shadow_tpu.backend import lanes as ref_lanes
from shadow_tpu.backend.cpu_engine import CpuEngine
from shadow_tpu.backend.tpu_engine import TpuEngine
from shadow_tpu.config import presets as ref_presets
from shadow_tpu.config.options import ConfigOptions as RefConfig
from shadow_tpu_torch.backend import bridge, lanes
from shadow_tpu_torch.backend import lanes_stream as ls
from shadow_tpu_torch.backend.gpu_engine import GpuEngine
from shadow_tpu_torch.config import presets as port_presets
from shadow_tpu_torch.config.options import ConfigOptions, LaneCompatError
from shadow_tpu_torch.obs import netobs as nom
from test_torch_tier import _ref_numpy

NEVER32 = lanes.NEVER32

# test_pcap.py's lane-backend configurations (defined inside its tests),
# with netobs on; {data} is the run's data directory
PCAP_TGEN = """
general: {stop_time: 300ms, seed: 6, data_directory: {data}}
network:
  graph:
    type: gml
    inline: |
      graph [
        directed 0
        node [ id 0 host_bandwidth_up "50 Mbit" host_bandwidth_down "50 Mbit" ]
        edge [ source 0 target 0 latency "4 ms" ]
      ]
experimental: {network_backend: tpu, netobs: true}
hosts:
  capt:
    network_node_id: 0
    pcap_enabled: true
    processes: [{path: tgen-client, args: [--server, sink, --interval, 9ms, --size, "600"]}]
  sink:
    network_node_id: 0
    pcap_enabled: true
    processes: [{path: tgen-server}]
  other:
    network_node_id: 0
    processes: [{path: tgen-mesh, args: [--interval, 11ms, --size, "300"]}]
"""
PCAP_STREAM = """
general: {stop_time: 4s, seed: 9, data_directory: {data}}
network:
  graph:
    type: gml
    inline: |
      graph [
        node [ id 0  host_bandwidth_up "40 Mbit"  host_bandwidth_down "40 Mbit" ]
        edge [ source 0  target 0  latency "6 ms" ]
      ]
experimental: {network_backend: tpu, netobs: true, tpu_lane_queue_capacity: 48}
hosts:
  capc:
    network_node_id: 0
    pcap_enabled: true
    processes: [{path: stream-client, args: [--server, caps, --size, "200000"]}]
  caps:
    network_node_id: 0
    pcap_enabled: true
    processes: [{path: stream-server}]
  other:
    network_node_id: 0
    processes: [{path: tgen-mesh, args: [--interval, 9ms, --size, "400"]}]
"""


def _telemetry_yaml(make, **kw) -> str:
    """The YAML text that one of test_telemetry.py's builders parses."""
    real = tel.ConfigOptions
    tel.ConfigOptions = type("Text", (), {"from_yaml": staticmethod(str)})
    try:
        return make(data_dir="{data}", backend="tpu", **kw)
    finally:
        tel.ConfigOptions = real


def _yaml(text: str, capture_every_other: bool = False):
    """A builder ``make(pkg, data)`` of the configuration for either
    package; ``capture_every_other`` turns pcap on at every other host."""
    def make(pkg, data: str):
        text_d = text.replace("{data}", data)
        if pkg is ref_presets:
            cfg = RefConfig.from_yaml(text_d)
        else:
            doc = pyyaml.safe_load(text_d)
            doc["general"].pop("heartbeat_interval", None)  # the facade's
            cfg = ConfigOptions.from_dict(doc)
        if capture_every_other:
            for i, h in enumerate(cfg.hosts):
                h.pcap_enabled = i % 2 == 0
        return cfg
    return make


def _mixed(pkg, data: str):
    """The 40-host tiered mixed mesh, netobs on, capturing on its stream
    pair and its first three mesh hosts; 300 sim ms of its 1 s, which
    keeps the file's time on one core near 90 s (the pair's handshake and
    first bursts run inside them)."""
    cfg = pkg.mixed_flagship_config(40, sim_seconds=1)
    cfg.general.stop_time = 300_000_000
    cfg.general.data_directory = data
    cfg.experimental.netobs = True
    for i, h in enumerate(cfg.hosts):
        h.pcap_enabled = i < 3 or h.processes[0].path.startswith("stream-")
    return cfg


CONFIGS = {
    "drop_heavy": _yaml(_telemetry_yaml(tel._drop_heavy_cfg), True),
    "lossy_stream": _yaml(_telemetry_yaml(tel._lossy_stream_cfg, pcap=True)),
    # 200 sim ms of the ring's 1 s: the port's plain path takes ~7,000
    # iterations a second there
    "phold": _yaml(_telemetry_yaml(tel._phold_cfg).replace(
        "stop_time: 1s", "stop_time: 200ms"), True),
    "mixed_tiered": _mixed,
    "pcap_tgen": _yaml(PCAP_TGEN),
    "pcap_stream": _yaml(PCAP_STREAM),
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``runs(name, who)``: one run of a configuration, made once — by the
    oracle (``cpu``), the reference (``ref``, device mode) or the port on
    the CPU (``port``, ``port_step``) — as ``(engine, result, data
    directory)``."""
    cache = {}

    def get(name: str, who: str):
        if (name, who) not in cache:
            data = tmp_path_factory.mktemp(f"{name}-{who}")
            if who == "cpu":
                cfg = CONFIGS[name](ref_presets, str(data))
                cfg.experimental.network_backend = "cpu"
                eng = CpuEngine(cfg)
                res = eng.run()
            elif who == "ref":
                eng = TpuEngine(CONFIGS[name](ref_presets, str(data)))
                res = eng.run(mode="device")
            else:
                eng = GpuEngine(CONFIGS[name](port_presets, str(data)),
                                device="cpu")
                res = eng.run(mode="step" if who == "port_step" else "device")
            cache[name, who] = (eng, res, data)
        return cache[name, who]

    return get


def _assert_snapshots_equal(got: dict, want: dict, tag: str) -> None:
    for k in nom.COUNTERS:
        np.testing.assert_array_equal(got["arrays"][k], want["arrays"][k],
                                      err_msg=f"{tag}: {k}")
    np.testing.assert_array_equal(got["window_hist"], want["window_hist"],
                                  err_msg=f"{tag}: window_hist")


def _pcaps(data) -> dict:
    return {p.parent.name: p.read_bytes()
            for p in sorted(data.glob("hosts/*/eth0.pcap"))}


def _check_planes(name, runs, port, ref) -> None:
    """Logs, counters, the netobs snapshot and every capture file of the
    port's run equal the reference's and the oracle's; a host that does
    not capture gets no file.  ``port`` and ``ref``: (engine, result,
    data directory)."""
    ce, cpu, cpu_dir = runs(name, "cpu")
    (pe, pres, port_dir), (te, rres, ref_dir) = port, ref
    assert pe.params.netobs and pe.params.pcap_any
    assert pres.log_tuples() == rres.log_tuples() == cpu.log_tuples()
    assert pres.counters == rres.counters
    snap = pe.netobs_snapshot()
    _assert_snapshots_equal(snap, te.netobs_snapshot(), f"{name} ref")
    _assert_snapshots_equal(snap, ce.netobs_snapshot(), f"{name} cpu")
    assert snap["window_hist"].sum() > 0
    tot = nom.totals(snap["arrays"])
    assert tot["sent"] > 0 and tot["tx_bytes"] > 0
    if name == "drop_heavy":  # every drop cause the oracle makes, throttles
        assert tot["drop_loss"] > 0 and tot["drop_codel"] > 0
        assert tot["throttled"] > 0
    if name == "lossy_stream":
        assert tot["retransmits"] > 0
    files = _pcaps(port_dir)
    assert files == _pcaps(ref_dir) == _pcaps(cpu_dir)
    capturing = {h.hostname for h in pe.cfg.hosts if h.pcap_enabled}
    assert set(files) == capturing
    assert all(len(b) > 100 for b in files.values())
    # no PCAP_TX row leaks into the event log
    assert all(r.outcome != 4 for r in pres.event_log)


# the other two configurations are held end to end by the round test,
# which steps the reference to the end
@pytest.mark.parametrize("name", ["drop_heavy", "mixed_tiered", "pcap_stream",
                                  "pcap_tgen"])
def test_planes_match_reference_and_oracle(runs, name):
    _check_planes(name, runs, runs(name, "port"), runs(name, "ref"))


@pytest.mark.parametrize("name", ["pcap_tgen", "mixed_tiered"])
def test_step_mode_equals_device_mode(runs, name):
    """The step driver flushes the histogram at each round's window, the
    device loop at each window advance: the same windows, the same
    snapshot and files."""
    pe, dev, dev_dir = runs(name, "port")
    se, step, step_dir = runs(name, "port_step")
    assert step.log_tuples() == dev.log_tuples()
    assert step.counters == dev.counters
    _assert_snapshots_equal(se.netobs_snapshot(), pe.netobs_snapshot(), name)
    assert _pcaps(step_dir) == _pcaps(dev_dir)


def test_untiered_stream_capture_matches_oracle(runs, tmp_path):
    """The lossy stream pair on the untiered path: captures ride kernel A's
    stream arm instead of the tier; files and snapshot equal the
    oracle's."""
    ce, _cpu, cpu_dir = runs("lossy_stream", "cpu")
    cfg = CONFIGS["lossy_stream"](port_presets, str(tmp_path))
    cfg.experimental.tpu_stream_tiered = False
    eng = GpuEngine(cfg, device="cpu")
    assert eng.params.split and eng.params.stream_pcap
    eng.run(mode="device")
    assert _pcaps(tmp_path) == _pcaps(cpu_dir)
    _assert_snapshots_equal(eng.netobs_snapshot(), ce.netobs_snapshot(),
                            "untiered")


def _never_rule(d: dict) -> dict:
    """Empty slots (NEVER time pair) compare by their time words only (the
    reference's row sorts leave their other words unspecified)."""
    d = dict(d)
    hole = d["q_thi"] == NEVER32
    for f in ("q_auxh", "q_auxl", "q_size"):
        d[f] = np.where(hole, 0, d[f])
    if isinstance(d["stream"], tuple):
        flows, q, v = d["stream"]
        q = q.copy()
        q[ls.TQ_AUXH:] = np.where(q[ls.TQ_THI] == NEVER32, 0, q[ls.TQ_AUXH:])
        d["stream"] = (flows, q, v)
    return d


@pytest.mark.parametrize("name", ["phold", "lossy_stream"])
def test_rounds_match_reference_field_by_field(runs, tmp_path_factory, name):
    """From one lifted state, a window at a time to the end, on an active
    configuration and a tiered one: every ``LaneState`` field, the
    ``nb_*`` block, the tier's ``TV_NB_*`` rows and the log (PCAP_TX rows
    in the reference's order) included, after each live round; then both
    runs are collected and held to each other and to the oracle as whole
    runs are (logs, counters, snapshots, files)."""
    ref_dir = tmp_path_factory.mktemp(f"{name}-ref-rounds")
    port_dir = tmp_path_factory.mktemp(f"{name}-port-rounds")
    ref = TpuEngine(CONFIGS[name](ref_presets, str(ref_dir)),
                    log_capacity=16384)
    port = GpuEngine(CONFIGS[name](port_presets, str(port_dir)),
                     log_capacity=16384, device="cpu")
    s_ref = ref.initial_state()
    s_port = bridge.state_from_numpy(_ref_numpy(s_ref))
    round_ref = ref_lanes.make_round_fn(ref.params, ref.tables)
    round_port = lanes._build_round(port.params, port.tables, s_port)
    live = 0
    while True:
        s_next, done_ref = round_ref(s_ref)
        done = round_port()
        assert bool(done_ref) == done
        if done:  # a finished run is left as it was
            break
        s_ref, live = s_next, live + 1
        got = _never_rule(bridge.state_to_numpy(s_port))
        want = _never_rule(_ref_numpy(s_ref))
        for f in lanes.LaneState._fields:
            if f == "stream" and isinstance(got[f], tuple):
                for a, b, tag in zip(got[f], want[f], ls.TierState._fields):
                    np.testing.assert_array_equal(a, b, err_msg=f"r{live}: {tag}")
            else:
                np.testing.assert_array_equal(got[f], want[f],
                                              err_msg=f"round {live}: {f}")
    assert live >= 40
    log = s_port.log[: int(s_port.log_count)]
    assert int((log[:, 5] == 4).sum()) > 0  # PCAP_TX rows were compared
    assert int(s_port.nb_hist.sum()) > 0
    _check_planes(name, runs, (port, port.collect(s_port, 0.0), port_dir),
                  (ref, ref.collect(s_ref, 0.0), ref_dir))


def test_pcap_without_a_log_raises(tmp_path):
    cfg = CONFIGS["pcap_tgen"](port_presets, str(tmp_path))
    with pytest.raises(LaneCompatError, match="pcap"):
        GpuEngine(cfg, log_capacity=0, device="cpu")


def test_netobs_off_gives_no_snapshot(tmp_path):
    cfg = CONFIGS["pcap_tgen"](port_presets, str(tmp_path))
    cfg.experimental.netobs = False
    eng = GpuEngine(cfg, device="cpu")
    assert eng.netobs_snapshot() is None
    eng.run(mode="device")
    assert eng.netobs_snapshot() is None
    assert eng.initial_state().nb_txb.numel() == 0


def test_log_overflow_raises_with_pcap(tmp_path):
    """PCAP_TX rows share the device log: a log too small for them and the
    events raises at collect, as any log overflow does."""
    cfg = CONFIGS["pcap_tgen"](port_presets, str(tmp_path))
    eng = GpuEngine(cfg, log_capacity=64, device="cpu")
    with pytest.raises(RuntimeError, match="log overflowed"):
        eng.run(mode="device")
    # the capture files are written only from a complete log
    assert not list(tmp_path.glob("hosts/*/eth0.pcap"))
