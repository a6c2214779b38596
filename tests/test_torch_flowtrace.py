"""The port's flowtrace plane against the JAX reference and the CPU oracle.

A config with ``experimental.flowtrace`` records the lifecycle events of a
seeded sample of its flows — send or retransmit, token-bucket wait, queue
entry, drop with its cause, delivery — into the device's ``[FL, 10]``
ring, which never wraps.  Twins of ``tests/test_flowtrace.py``: the
drop-heavy mesh (device and step driver, full and sampled), the lossy
stream pair (retransmits; a traced run drops the tier) and the 40-host
mixed mesh at C = 4096 — the port's ring equal to the reference's row for
row, and its events, in canonical order, to the oracle's.  Then the hash
against Python and the reference's ``flow_hash_lane``, the sampling
thresholds, the ring's overflow law, rounds against the reference's
``make_round_fn`` field by field (``fl_buf``, ``fl_count``, ``fl_lost``
included; one of them non-strict, so the merge sheds FT_DROP rows), the
refusals, and the merges' shared-or-global size rule.  Integer
simulation: every comparison is exact equality.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import yaml as pyyaml

import test_flowtrace as ref_ft_tests
from shadow_tpu.backend import lanes as ref_lanes
from shadow_tpu.backend.cpu_engine import CpuEngine
from shadow_tpu.backend.tpu_engine import TpuEngine
from shadow_tpu.config import presets as ref_presets
from shadow_tpu.config.options import ConfigOptions as RefConfig
from shadow_tpu.obs import flowtrace as ref_ftr
from shadow_tpu_torch.backend import bridge, lanes
from shadow_tpu_torch.backend.gpu_engine import GpuEngine
from shadow_tpu_torch.config import presets as port_presets
from shadow_tpu_torch.config.options import ConfigError, ConfigOptions
from shadow_tpu_torch.obs import flowtrace as ftr
from test_torch_tier import _ref_numpy


def _flowtrace_yaml(make, **kw) -> str:
    """The YAML text one of test_flowtrace.py's builders parses."""
    real = ref_ft_tests.ConfigOptions
    ref_ft_tests.ConfigOptions = type("Text", (), {"from_yaml": staticmethod(str)})
    try:
        return make(data_dir="{data}", backend="tpu", **kw)
    finally:
        ref_ft_tests.ConfigOptions = real


def _yaml(text: str):
    """A builder ``make(pkg)`` of the configuration for either package."""
    def make(pkg):
        if pkg is ref_presets:
            return RefConfig.from_yaml(text)
        doc = pyyaml.safe_load(text)
        doc["general"].pop("heartbeat_interval", None)  # the facade's
        return ConfigOptions.from_dict(doc)
    return make


def _mixed_fallback(pkg):
    """test_mixed_mesh_parity_tier_fallback's mesh (a traced run drops the
    tier; C = 4096, the preset's Cx = 8), 200 sim ms of its 1 s: the
    stream pair's handshake and first bursts run inside them, and the
    file's time on one core stays near 150 s."""
    cfg = pkg.mixed_flagship_config(40, sim_seconds=1)
    cfg.general.stop_time = 200_000_000
    cfg.experimental.flowtrace = True
    cfg.experimental.tpu_lane_queue_capacity = 4096
    return cfg


# the phold ring at 200 sim ms of its 1 s (the port's plain path takes
# about 7,000 iterations a second there), a 32-row ring
PHOLD_32 = _flowtrace_yaml(ref_ft_tests._phold_cfg, capacity=32).replace(
    "stop_time: 1s", "stop_time: 200ms")
# eight senders into one sink, 1 ms apart over 10 ms links: the sink's
# in-flight arrivals pass C = 9 in the second iteration, so its merges shed
# past C (never past Cx: eight arrivals an iteration, Cx = C)
OVERFLOW = """
general: {stop_time: 120ms, seed: 2}
network:
  graph:
    type: gml
    inline: |
      graph [ directed 0 node [ id 0 host_bandwidth_up "1 Gbit" host_bandwidth_down "1 Gbit" ]
              edge [ source 0 target 0 latency "10 ms" ] ]
experimental: {network_backend: tpu, flowtrace: true, tpu_lane_queue_capacity: 9,
               tpu_events_per_round: 2}
hosts:
  c: {count: 8, network_node_id: 0, processes: [{path: tgen-client, args: [--server, sink, --interval, 1ms, --size, "300"]}]}
  sink: {network_node_id: 0}
"""

CONFIGS = {
    "drop_heavy": _yaml(_flowtrace_yaml(ref_ft_tests._drop_heavy_cfg)),
    "drop_heavy_step": _yaml(_flowtrace_yaml(ref_ft_tests._drop_heavy_cfg,
                                             seed=12, stop="600ms")),
    "sampled": _yaml(_flowtrace_yaml(ref_ft_tests._drop_heavy_cfg,
                                     sample=0.5)),
    "lossy_stream": _yaml(_flowtrace_yaml(ref_ft_tests._lossy_stream_cfg)),
    "mixed_fallback": _mixed_fallback,
    "phold_32": _yaml(PHOLD_32),
}
MODE = {"drop_heavy_step": "step"}


@pytest.fixture(scope="module")
def runs():
    """``runs(name, who)``: one run of a configuration, made once — by the
    oracle (``cpu``), the reference (``ref``) or the port on the CPU
    (``port``) — as ``(engine, result)``."""
    cache = {}

    def get(name: str, who: str):
        if (name, who) not in cache:
            mode = MODE.get(name, "device")
            if who == "cpu":
                cfg = CONFIGS[name](ref_presets)
                cfg.experimental.network_backend = "cpu"
                eng = CpuEngine(cfg)
                res = eng.run()
            elif who == "ref":
                eng = TpuEngine(CONFIGS[name](ref_presets))
                res = eng.run(mode=mode)
            else:
                eng = GpuEngine(CONFIGS[name](port_presets), device="cpu")
                res = eng.run(mode=mode)
            cache[name, who] = (eng, res)
        return cache[name, who]

    return get


def _never_rule(d: dict) -> dict:
    """Empty slots (NEVER time pair) compare by their time words only: the
    reference's row sort leaves their other words, the payload words too
    where a run has them, unspecified."""
    d = dict(d)
    hole = d["q_thi"] == lanes.NEVER32
    for f in ("q_auxh", "q_auxl", "q_size", "q_phi", "q_plo"):
        if d[f].shape == hole.shape:
            d[f] = np.where(hole, 0, d[f])
    return d


def _canon(snap, capacity=1 << 20):
    ev, lost = ftr.canonical_events(snap["raw"], capacity)
    return ev, lost + snap["ring_lost"]


@pytest.mark.parametrize("name", ["drop_heavy", "drop_heavy_step", "sampled",
                                  "lossy_stream", "mixed_fallback"])
def test_events_match_reference_and_oracle(runs, name):
    """The port's ring equals the reference's row for row (the same append
    order), its canonical events the oracle's, at zero loss; logs and
    counters too."""
    (pe, pres), (te, tres) = runs(name, "port"), runs(name, "ref")
    ce, cres = runs(name, "cpu")
    assert pe.params.flowtrace and not pe.params.stream_tiered
    assert pres.log_tuples() == tres.log_tuples() == cres.log_tuples()
    assert pres.counters == tres.counters
    snap = pe.flowtrace_snapshot()
    assert snap["raw"] == te.flowtrace_snapshot()["raw"]
    ev, lost = _canon(snap)
    want, lost_c = _canon(ce.flowtrace_snapshot())
    assert lost == lost_c == 0
    assert ev == want and ev
    kinds = {e[2] for e in ev}
    if name == "drop_heavy":  # the whole lifecycle, both drop causes
        assert {ftr.FT_SEND, ftr.FT_TB_WAIT, ftr.FT_QUEUE_ENTER, ftr.FT_DROP,
                ftr.FT_DELIVERY} <= kinds
        assert {ftr.CAUSE_LOSS, ftr.CAUSE_CODEL} <= {
            e[7] for e in ev if e[2] == ftr.FT_DROP}
    if name == "lossy_stream":  # retransmits join the wire packets' fates
        retx = [e for e in ev if e[2] == ftr.FT_RETRANSMIT]
        fates = {(e[3], e[4], e[5]) for e in ev
                 if e[2] in (ftr.FT_DELIVERY, ftr.FT_DROP)}
        assert retx and any((e[3], e[4], e[5]) in fates for e in retx)
    if name == "sampled":  # a strict subset: the full stream's pairs
        full, _ = _canon(runs("drop_heavy", "port")[0].flowtrace_snapshot())
        pairs = {(e[3], e[4]) for e in ev}
        assert 0 < len(ev) < len(full)
        assert ev == [e for e in full if (e[3], e[4]) in pairs]


def test_traced_run_drops_the_tier(runs):
    pe, _res = runs("mixed_fallback", "port")
    assert pe.params.split and pe.params.capacity == 4096
    assert TpuEngine(CONFIGS["mixed_fallback"](ref_presets)).params \
        .stream_tiered is False
    cfg = CONFIGS["mixed_fallback"](port_presets)
    cfg.experimental.flowtrace = False
    assert GpuEngine(cfg, device="cpu").params.stream_tiered


@pytest.mark.parametrize("seed", [0, 1, 11, 12345])
def test_hash_matches_python_and_reference(seed):
    n = 24
    src = np.repeat(np.arange(n, dtype=np.int32), n)
    dst = np.tile(np.arange(n, dtype=np.int32), n)
    py = np.array([ftr.flow_hash(int(s), int(d), 0, seed)
                   for s, d in zip(src, dst)], dtype=np.int64)
    assert py.tolist() == [ref_ftr.flow_hash(int(s), int(d), 0, seed)
                           for s, d in zip(src, dst)]
    port = lanes.flow_hash_lane(src, dst, seed).numpy()
    ref = np.asarray(ref_lanes.flow_hash_lane(
        jnp.asarray(src), jnp.asarray(dst), jnp.int32(seed))).astype(np.int64)
    np.testing.assert_array_equal(port, py)
    np.testing.assert_array_equal(port, ref)


def test_sample_thresh_edges():
    for sample in (1.0, 0.0, 0.5, 1e-9, 0.999999):
        assert ftr.sample_thresh(sample) == ref_ftr.sample_thresh(sample)
    assert ftr.sample_thresh(1.0) == (0, True)
    assert ftr.sample_thresh(0.0) == (0, False)
    thresh, every = ftr.sample_thresh(0.5)
    assert not every and 0 < thresh < (1 << 32)


def test_ring_never_wraps_and_conserves(runs):
    """A 32-row ring: the first 32 rows of the append order are kept, as
    the reference keeps them, the rest counted; kept + lost is the
    oracle's whole stream."""
    (pe, _p), (te, _t), (ce, _c) = (runs("phold_32", w)
                                    for w in ("port", "ref", "cpu"))
    snap, ref = pe.flowtrace_snapshot(), te.flowtrace_snapshot()
    assert len(snap["raw"]) == 32 and snap["ring_lost"] > 0
    assert snap == ref
    total = len(ce.flowtrace_snapshot()["raw"])
    assert len(snap["raw"]) + snap["ring_lost"] == total


def test_flowtrace_off_gives_no_snapshot():
    cfg = CONFIGS["drop_heavy_step"](port_presets)
    cfg.experimental.flowtrace = False
    cfg.general.stop_time = 50_000_000
    eng = GpuEngine(cfg, device="cpu")
    assert eng.initial_state().fl_buf.numel() == 0
    eng.run(mode="device")
    assert eng.flowtrace_snapshot() is None


@pytest.mark.parametrize("name,strict", [("drop_heavy", True),
                                         ("lossy_stream", True),
                                         ("overflow", False)])
def test_rounds_match_reference_field_by_field(name, strict):
    """From one lifted state, a window at a time to the end: every
    ``LaneState`` field, the ring and its counts included, after each live
    round.  The overflow mesh runs non-strict: its merges shed, and the
    FT_DROP (CAUSE_QUEUE) rows are compared in the ring."""
    make = _yaml(OVERFLOW) if name == "overflow" else CONFIGS[name]
    ref_cfg, port_cfg = make(ref_presets), make(port_presets)
    if name == "drop_heavy":  # 400 of its 1500 sim ms
        ref_cfg.general.stop_time = port_cfg.general.stop_time = 400_000_000
    ref = TpuEngine(ref_cfg, log_capacity=8192)
    port = GpuEngine(port_cfg, log_capacity=8192, strict_capacity=strict,
                     device="cpu")
    s_ref = ref.initial_state()
    s_port = bridge.state_from_numpy(_ref_numpy(s_ref))
    round_ref = ref_lanes.make_round_fn(ref.params, ref.tables)
    round_port = lanes._build_round(port.params, port.tables, s_port)
    live = 0
    while True:
        s_next, done_ref = round_ref(s_ref)
        done = round_port()
        assert bool(done_ref) == done
        if done:
            break
        s_ref, live = s_next, live + 1
        got = _never_rule(bridge.state_to_numpy(s_port))
        want = _never_rule(_ref_numpy(s_ref))
        for f in lanes.LaneState._fields:
            np.testing.assert_array_equal(got[f], want[f],
                                          err_msg=f"round {live}: {f}")
    assert live >= 10
    rows = s_port.fl_buf[: int(s_port.fl_count)]
    assert int(s_port.fl_lost) == 0 and rows.shape[0] > 0
    sheds = int(((rows[:, 4] == ftr.FT_DROP)
                 & (rows[:, 9] == ftr.CAUSE_QUEUE)).sum())
    assert (sheds > 0) == (name == "overflow")


def test_refusals():
    p = GpuEngine(CONFIGS["lossy_stream"](port_presets), device="cpu").params
    with pytest.raises(ValueError, match="stream_tiered"):
        lanes.LaneParams(**{**p.__dict__, "stream_tiered": True})
    with pytest.raises(ValueError, match="flow_capacity"):
        lanes.LaneParams(**{**p.__dict__, "flow_capacity": 0})
    for key, bad in (("flowtrace_capacity", 0), ("flowtrace_sample", 1.5),
                     ("flowtrace_sample", -0.1)):
        cfg = CONFIGS["drop_heavy"](port_presets)
        setattr(cfg.experimental, key, bad)
        with pytest.raises(ConfigError, match=key):
            cfg.validate()


H100_OPTIN = 232_448  # 227 KB, an H100's sharedMemPerBlockOptin


@pytest.mark.parametrize("entries,words,extra,shared", [
    (1_700, 7, 0, True),  # 47,600 B: under the default 48 KiB
    (1_760, 7, 0, True),  # 49,280 B: past 48 KiB, opted in
    (4_104, 5, 4 * 2_048, True),  # the drop-heavy B row, C = Cx = 2048
    (4_108, 7, 4 * 8, True),  # the mixed mesh's B row at C = 4096, Cx = 8
    (57_856, 1, 0, True),  # 231,424 B: the opt-in limit less the reserve
    (57_857, 1, 0, False),  # four bytes past it
    (8_196, 7, 4 * 4_096, False),  # the B row at C = Cx = 4096: global
])
def test_merge_path_choice(entries, words, extra, shared):
    assert lanes.merge_in_shared(entries, words, extra, H100_OPTIN) is shared


def test_merge_scratch_sized_by_the_rule():
    """The 40-host mixed mesh at C = Cx = 4096: its B rows go global, its E
    rows stay in shared memory, so the scratch holds B's rows alone."""
    cfg = CONFIGS["mixed_fallback"](port_presets)
    cfg.experimental.tpu_cross_capacity = 0
    p = GpuEngine(cfg, device="cpu").params
    rows = lanes.merge_rows(p)
    n, e, w, x = rows["merge"]
    assert not lanes.merge_in_shared(e, w, x, H100_OPTIN)
    assert lanes.merge_in_shared(*rows["stream merge"][1:], H100_OPTIN)
    assert lanes.merge_scratch_words(p, H100_OPTIN) == n * (w * e + x // 4)
    assert lanes.merge_scratch_words(p, 1 << 30) == 0
