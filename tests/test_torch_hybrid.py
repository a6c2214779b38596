"""The port's hybrid backend against the JAX reference and the CPU oracle.

Managed hosts run real binaries (``native/build``, built by ``make -C
native`` as the reference's hybrid tests do) on the host CPU; their
packets ride the lanes.  Everything compares by exact equality: the plain
versions of kernel H, A's external arm with D's egress instance and C's
hybrid mode against the reference's functions field by field, and the
port's ``HybridEngine(device="cpu")`` and ``CpuEngine`` against the
reference's ``HybridEngine`` on the one-window law and its ``CpuEngine``.
"""

import os
import subprocess
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shadow_tpu.backend import lanes as ref_lanes
from shadow_tpu.backend.cpu_engine import CpuEngine as RefCpu
from shadow_tpu.backend.hybrid import HybridEngine as RefHybrid
from shadow_tpu.backend.tpu_engine import TpuEngine
from shadow_tpu.config import scenarios as ref_scenarios
from shadow_tpu.config.options import ConfigOptions as RefConfig
from shadow_tpu.core import rng as ref_rng
from shadow_tpu_torch.backend import bridge, lanes
from shadow_tpu_torch.backend.cpu_engine import CpuEngine
from shadow_tpu_torch.backend.gpu_engine import GpuEngine, _event_rows
from shadow_tpu_torch.backend.hybrid import (HybridEngine, MpHybridEngine,
                                             make_hybrid_engine)
from shadow_tpu_torch.config import scenarios
from shadow_tpu_torch.config.options import ConfigOptions, LaneCompatError
from shadow_tpu_torch.core import rng

REPO = Path(__file__).resolve().parents[1]
BUILD = REPO / "native" / "build"
NEVER32 = lanes.NEVER32


@pytest.fixture(scope="module", autouse=True)
def native_build():
    subprocess.run(["make", "-C", str(REPO / "native")], check=True,
                   capture_output=True)


# -- the four configs (the reference's hybrid tests', at hybrid_fuse_k 1) ----

def _mixed(d: Path) -> str:
    """tests/test_hybrid.py's _mixed_config: a managed pingpong pair and six
    tgen-mesh hosts on one switch."""
    mesh = "".join(f"""
  zm{i:03d}:
    network_node_id: 0
    processes:
      - path: tgen-mesh
        args: --interval 50ms --size 600
        start_time: 0 s
""" for i in range(6))
    return f"""
general: {{stop_time: 2s, seed: 21, data_directory: {d}, heartbeat_interval: null}}
network: {{graph: {{type: 1_gbit_switch}}}}
experimental: {{network_backend: tpu, hybrid_fuse_k: 1}}
hosts:
  cli:
    network_node_id: 0
    processes:
      - path: {BUILD / 'pingpong'}
        args: [client, 11.0.0.2, "9000", "5", "100"]
  srv:
    network_node_id: 0
    processes:
      - path: {BUILD / 'pingpong'}
        args: [server, "9000", "5"]
{mesh}
"""


def _tcpecho(d: Path) -> str:
    """tests/test_hybrid.py's managed TCP config: tcpecho across the seam."""
    return f"""
general: {{stop_time: 3s, seed: 7, data_directory: {d}, heartbeat_interval: null}}
network: {{graph: {{type: 1_gbit_switch}}}}
experimental: {{network_backend: tpu, hybrid_fuse_k: 1}}
hosts:
  ecli:
    network_node_id: 0
    processes:
      - path: {BUILD / 'tcpecho'}
        args: [client, 11.0.0.2, "7000", "3", "600", "5"]
        start_time: 100ms
  esrv:
    network_node_id: 0
    processes:
      - path: {BUILD / 'tcpecho'}
        args: [server, "7000", "1"]
  filler:
    network_node_id: 0
    processes:
      - path: tgen-mesh
        args: --interval 100ms --size 400
        start_time: 0 s
  filler2:
    network_node_id: 0
    processes:
      - path: tgen-mesh
        args: --interval 100ms --size 400
        start_time: 0 s
"""


def _congested(d: Path) -> str:
    """tests/test_hybrid_fusion.py's _congested_cfg at fuse_k 1, obs_turns
    off: bulk echo into a 10 Mbit node queues deliveries in the down
    buckets while a pingpong pair keeps the windows short."""
    bulk = "".join(f"""
  bcli{i}:
    network_node_id: 0
    processes:
      - path: {BUILD / 'tcpecho'}
        args: [hclient, bsrv{i}, "{7000 + i}", "6", "8192", "0"]
        start_time: {100 + 40 * i}ms
  bsrv{i}:
    network_node_id: 1
    processes:
      - path: {BUILD / 'tcpecho'}
        args: [server, "{7000 + i}", "1"]
""" for i in range(3))
    return f"""
general: {{stop_time: 2s, seed: 7, data_directory: {d}, heartbeat_interval: null}}
network:
  graph:
    type: gml
    inline: |
      graph [
        directed 0
        node [ id 0 host_bandwidth_up "1 Gbit" host_bandwidth_down "1 Gbit" ]
        node [ id 1 host_bandwidth_up "10 Mbit" host_bandwidth_down "10 Mbit" ]
        edge [ source 0 target 0 latency "100 us" ]
        edge [ source 1 target 1 latency "100 us" ]
        edge [ source 0 target 1 latency "300 us" ]
      ]
experimental: {{network_backend: tpu, hybrid_fuse_k: 1}}
hosts:
  acli:
    network_node_id: 0
    processes:
      - path: {BUILD / 'pingpong'}
        args: [client, 11.0.0.2, "9000", "4", "100"]
  asrv:
    network_node_id: 0
    processes:
      - path: {BUILD / 'pingpong'}
        args: [server, "9000", "4"]
{bulk}
"""


def _chain(d: Path):
    """managed_chain_config(chains=2, peers=40), cut to fit the suite: one
    client per chain, one round of 1 KiB, 2 sim s (both clients and the
    origin exit cleanly by then)."""
    kw = dict(chains=2, peers=40, sim_seconds=2, rounds=1, size=1024,
              clients_per_chain=1, backend="tpu")
    port = scenarios.managed_chain_config(d / "p", **kw)
    ref = ref_scenarios.managed_chain_config(d / "r", **kw)
    for c in (port, ref):
        c.experimental.hybrid_fuse_k = 1
    return port, ref


SLICE = {"mixed": _mixed, "tcpecho": _tcpecho, "congested": _congested,
         "chain": _chain}

SYNC_KEYS = ("device_turns", "scalar_reads", "inject_blocks", "inject_rows",
             "inject_bytes", "egress_reads", "egress_rows", "egress_bytes")


@pytest.fixture(scope="module", params=sorted(SLICE))
def runs(request, tmp_path_factory):
    """One config's four runs: the reference's CpuEngine and HybridEngine
    (one-window law), the port's CpuEngine and HybridEngine on the CPU."""
    d = tmp_path_factory.mktemp(request.param)
    make = SLICE[request.param]
    if request.param == "chain":
        cfgs = {k: make(d / k) for k in "ab"}
    else:
        cfgs = {k: (ConfigOptions.from_yaml(make(d / f"p{k}")),
                    RefConfig.from_yaml(make(d / f"r{k}"))) for k in "ab"}
    ref_cpu = RefCpu(cfgs["a"][1]).run()
    ref_eng = RefHybrid(cfgs["b"][1])
    ref_hyb = ref_eng.run()
    port_cpu = CpuEngine(cfgs["a"][0]).run()
    port_eng = HybridEngine(cfgs["b"][0], device="cpu")
    port_hyb = port_eng.run()
    return request.param, ref_cpu, ref_hyb, ref_eng, port_cpu, port_hyb, port_eng


def test_hybrid_equals_reference_and_oracle(runs):
    name, ref_cpu, ref_hyb, ref_eng, port_cpu, port_hyb, port_eng = runs
    assert len(ref_cpu.event_log) > 50
    for r in (ref_cpu, ref_hyb, port_cpu, port_hyb):
        assert not r.process_errors, r.process_errors
    assert port_hyb.log_tuples() == ref_hyb.log_tuples() == ref_cpu.log_tuples()
    assert port_hyb.counters == ref_hyb.counters
    assert port_hyb.rounds == ref_hyb.rounds == ref_cpu.rounds
    assert port_hyb.counters["managed_exit_clean"] == ref_cpu.counters[
        "managed_exit_clean"] > 0
    for k in SYNC_KEYS:
        assert port_eng.sync_stats[k] == ref_eng.sync_stats[k], k
    assert port_eng.sync_stats["device_turns"] > 10
    assert port_eng.sync_stats["egress_rows"] > 10
    # the port's own oracle is the reference's
    assert port_cpu.log_tuples() == ref_cpu.log_tuples()
    assert port_cpu.counters == ref_cpu.counters
    assert port_cpu.rounds == ref_cpu.rounds
    assert port_cpu.per_host_counters == ref_cpu.per_host_counters


# -- the plain versions against the reference's functions ---------------------

def _plain_cfg(tmp: Path, extra: str = "", streams: bool = False,
               capacity: int = 32, down: str = "20 Mbit") -> str:
    """Two external (managed) hosts beside tgen-mesh and phold lanes (and,
    with ``streams``, an untiered stream pair: payload columns); lossy, so
    the loss draw runs too."""
    pair = """
  sc: {network_node_id: 0, processes: [{path: stream-client, args: [--server, ss, --size, "20000"]}]}
  ss: {network_node_id: 0, processes: [{path: stream-server}]}""" if streams else ""
    return f"""
general: {{stop_time: 1s, seed: 5, data_directory: {tmp}}}
network:
  graph:
    type: gml
    inline: |
      graph [
        directed 0
        node [ id 0 host_bandwidth_up "100 Mbit" host_bandwidth_down "{down}" ]
        edge [ source 0 target 0 latency "1 ms" packet_loss 0.05 ]
      ]
experimental: {{tpu_lane_queue_capacity: {capacity}, tpu_stream_tiered: false{extra}}}
hosts:
  a: {{network_node_id: 0, processes: [{{path: {BUILD / 'pingpong'}, args: [server, "9000", "1"]}}]}}
  b: {{network_node_id: 0, processes: [{{path: {BUILD / 'pingpong'}, args: [server, "9001", "1"]}}]}}
  m: {{count: 4, network_node_id: 0, processes: [{{path: tgen-mesh, args: --interval 2ms --size 300}}]}}
  p: {{count: 2, network_node_id: 0, processes: [{{path: phold, args: [--messages, "2"]}}]}}{pair}
"""


def _engines(tmp: Path, **kw):
    port_cfg = ConfigOptions.from_yaml(_plain_cfg(tmp, **kw))
    ref_cfg = RefConfig.from_yaml(_plain_cfg(tmp, **kw))
    ext = np.array([h.hostname in ("a", "b") for h in port_cfg.hosts])
    ref = TpuEngine(ref_cfg, log_capacity=4096, external=ext)
    port = GpuEngine(port_cfg, log_capacity=4096, device="cpu", external=ext)
    assert port.params.external_any and ref.params.external_any
    for f in ("egress_capacity", "ext_per_iter", "inject_batch",
              "inject_cross", "stream_tiered"):
        assert getattr(port.params, f) == getattr(ref.params, f), f
    np.testing.assert_array_equal(port.tables.lane_external.numpy(),
                                  np.asarray(ref.tables.lane_external))
    return ref, port


def _random_queues(port, rng_, t_max: int, fill: int):
    """Queue rows of PACKET arrivals (from random lanes, unique seqs) and
    LOCAL timer ticks at random times below ``t_max``, sorted by the key."""
    p = port.params
    n = p.n_lanes
    cnt = rng_.integers(0, fill, size=n)
    rows = np.repeat(np.arange(n), cnt)
    m = rows.size
    kind = np.where(rng_.random(m) < 0.7, lanes.PACKET, lanes.LOCAL)
    src = np.where(kind == lanes.PACKET, rng_.integers(0, n, size=m), rows)
    seq = 1000 + np.arange(m)
    t = rng_.integers(0, t_max, size=m).astype(np.int64)
    size = np.where(kind == lanes.PACKET, rng_.integers(100, 1400, size=m), 0)
    return _event_rows(rows, n, p.capacity, t, kind, src, seq, size)


def _lift(ref, port, words, we: int):
    """The reference's initial state with the queues ``words`` and the
    window end ``we``, and the same state in the port."""
    s = ref.initial_state()
    s = s._replace(
        **{f: jnp.asarray(w) for f, w in zip(
            ("q_thi", "q_tlo", "q_auxh", "q_auxl", "q_size"), words)},
        now_we_hi=jnp.int32(we >> 31), now_we_lo=jnp.int32(we & lanes.MASK31))
    d = {f: np.asarray(getattr(s, f)) if not (
        isinstance(getattr(s, f), tuple) and not getattr(s, f))
        else np.zeros(0, np.int32) for f in lanes.LaneState._fields}
    if port.params.stream_present:
        d["stream"] = np.asarray(s.stream)
    return s, bridge.state_from_numpy(d)


def _never_rule(d: dict) -> dict:
    """Empty slots (NEVER time pair) compare by their time words only (the
    reference's row sort is unstable)."""
    d = dict(d)
    hole = d["q_thi"] == NEVER32
    for f in ("q_auxh", "q_auxl", "q_size", "q_phi", "q_plo"):
        if d[f].shape == hole.shape:
            d[f] = np.where(hole, 0, d[f])
    return d


def _assert_states(s_ref, s_port, skip=()):
    want = _never_rule({f: (np.zeros(0, np.int32) if isinstance(
        getattr(s_ref, f), tuple) and not getattr(s_ref, f)
        else np.asarray(getattr(s_ref, f))) for f in lanes.LaneState._fields})
    got = _never_rule(bridge.state_to_numpy(s_port))
    for f in lanes.LaneState._fields:
        if f not in skip:
            np.testing.assert_array_equal(got[f], want[f], err_msg=f)


def _block(p, rng_, rows: int, dst=None, t0: int = 2_000_000):
    """An injection block: ``rows`` valid PACKET arrivals (to ``dst`` when
    given), the rest invalid; as the reference's dict and the port's
    [INJ_WORDS, B] tensor."""
    b = p.inject_batch
    valid = np.zeros(b, bool)
    valid[rng_.permutation(b)[:rows]] = True
    d = (rng_.integers(0, p.n_lanes, size=b) if dst is None
         else np.full(b, dst)).astype(np.int32)
    t = t0 + rng_.integers(0, 3_000_000, size=b)
    src = rng_.integers(0, p.n_lanes, size=b)
    inj = {
        "valid": valid, "dst": d,
        "thi": np.where(valid, t >> 31, NEVER32).astype(np.int32),
        "tlo": np.where(valid, t & lanes.MASK31, NEVER32).astype(np.int32),
        "auxh": ((lanes.PACKET << lanes.AUX_KIND_SHIFT)
                 | (src << lanes.AUX_SRC_SHIFT)).astype(np.int32),
        "auxl": (50_000 + np.arange(b)).astype(np.int32),
        "size": rng_.integers(100, 1400, size=b).astype(np.int32),
    }
    port_blk = torch.from_numpy(np.stack(
        [inj["valid"].astype(np.int32)] + [inj[k] for k in (
            "dst", "thi", "tlo", "auxh", "auxl", "size")]))
    return {k: jnp.asarray(v) for k, v in inj.items()}, port_blk


@pytest.mark.parametrize("case", ["plain", "streams", "past_cxi", "netobs"])
def test_inject_merge_matches_reference(case, tmp_path):
    kw = {"streams": dict(streams=True), "past_cxi": dict(capacity=16),
          "netobs": dict(extra=", netobs: true", capacity=16)}.get(case, {})
    ref, port = _engines(tmp_path, **kw)
    p = port.params
    rng_ = np.random.default_rng(17)
    words = _random_queues(port, rng_, 4_000_000, p.capacity // 2)
    s_ref, s_port = _lift(ref, port, words, 1_000_000)
    over = case in ("past_cxi", "netobs")
    # 60 rows over 8 lanes stay within Cxi = C; 300 rows to lane 2 do not
    inj_ref, inj_port = _block(p, rng_, 300 if over else 60,
                               dst=2 if over else None)
    s_ref = jax.jit(lambda s, i: ref_lanes._inject_merge(
        ref.params, ref.tables, s, i))(s_ref, inj_ref)
    lanes.inject_merge_plain(p, port.tables, s_port, inj_port)
    if not over:
        _assert_states(s_ref, s_port)
        return
    # lane 2 took 300 rows with Cxi = C = 16: which ones survive is not
    # defined by the reference (an unstable sort); every count is
    _assert_states(s_ref, s_port, skip=("q_thi", "q_tlo", "q_auxh", "q_auxl",
                                        "q_size"))
    assert int(s_port.n_queue[2]) == 300 - 16 + int(
        (words[0][2] != NEVER32).sum())
    np.testing.assert_array_equal(
        (s_port.q_thi.numpy() != NEVER32).sum(1),
        (np.asarray(s_ref.q_thi) != NEVER32).sum(1))
    if case == "netobs":
        assert int(s_port.nb_shed[2]) == 300 - 16


def test_external_arm_and_egress_match_reference(tmp_path):
    """Iterations (A, B, D) against the reference's on a state whose
    external lanes pop packets, CoDel drops among them (2 Mbit down buckets
    back up past the target from empty buckets refilling at 20 ms, and every
    lane's CoDel has been above it for an interval), phold lanes taking DELIVERY inserts beside them."""
    ref, port = _engines(tmp_path, down="2 Mbit")
    p = port.params
    rng_ = np.random.default_rng(3)
    words = _random_queues(port, rng_, 3_000_000, p.capacity // 2)
    we = 2_500_000
    s_ref, s_port = _lift(ref, port, words, we)
    s_ref = s_ref._replace(cd_fat_hi=jnp.zeros_like(s_ref.cd_fat_hi),
                           cd_fat_lo=jnp.ones_like(s_ref.cd_fat_lo),
                           dn_tokens=jnp.zeros_like(s_ref.dn_tokens),
                           dn_nr_lo=jnp.full_like(s_ref.dn_nr_lo, 20_000_000))
    s_port.cd_fat_hi.zero_()
    s_port.cd_fat_lo.fill_(1)
    s_port.dn_tokens.zero_()
    s_port.dn_nr_lo.fill_(20_000_000)
    iter_ref = jax.jit(ref_lanes._build_iter(ref.params, ref.tables,
                                             pure_dataflow=True))
    ws = lanes.make_workspace(p, "cpu")
    for _ in range(3):
        s_ref = iter_ref(s_ref)
        lanes.lane_slots_plain(p, port.tables, s_port, ws)
        lanes.exchange_merge_plain(p, port.tables, s_port, ws)
        lanes.append_log_plain(p, s_port, ws)
        _assert_states(s_ref, s_port)
    assert int(s_port.egress_count) > 5
    assert (s_port.egress[:int(s_port.egress_count), 5] == 2).any()  # CoDel
    assert int(s_port.egress_min_hi) != NEVER32


_REF_TURNS: dict = {}


def _ref_turn(rp, tables):
    """The reference's jitted turn, compiled once per parameters (the
    cases share the config, so their tables are equal)."""
    if rp not in _REF_TURNS:
        _REF_TURNS[rp] = ref_lanes.make_hybrid_fn(rp, tables)
    return _REF_TURNS[rp]


@pytest.mark.parametrize("case", ["before", "inside", "past", "never",
                                  "egress_floor"])
def test_hybrid_run_matches_reference(case, tmp_path):
    """One device turn: ``_build_hybrid_run`` against ``make_hybrid_fn``
    with an injection block, the host's next event before the current
    window's end, inside it, past it (free-run) or absent, and with the
    egress buffer one iteration from its floor (the turn pauses
    mid-window)."""
    ref, port = _engines(tmp_path, extra=", use_dynamic_runahead: true")
    p, rp = port.params, ref.params
    if case == "egress_floor":
        import dataclasses
        p = dataclasses.replace(p, egress_capacity=p.ext_per_iter + 1)
        rp = dataclasses.replace(rp, egress_capacity=rp.ext_per_iter + 1)
    rng_ = np.random.default_rng(11)
    words = _random_queues(port, rng_, 6_000_000, p.capacity // 2)
    we = 1_000_000
    s_ref, s_port = _lift(ref, port, words, we)
    if case == "egress_floor":
        s_ref = s_ref._replace(egress=jnp.zeros((p.egress_capacity, 6),
                                                jnp.int64))
        s_port = s_port._replace(egress=torch.zeros((p.egress_capacity, 6),
                                                    dtype=torch.int64))
    ext_t = {"before": we - 500_000, "inside": we + 300_000,
             "past": we + 40_000_000, "never": lanes.NEVER,
             "egress_floor": lanes.NEVER}[case]
    used = 900_000 if case == "inside" else NEVER32
    inj_ref, inj_port = _block(p, rng_, 40)
    eh, el = ((NEVER32, NEVER32) if ext_t >= lanes.NEVER
              else (ext_t >> 31, ext_t & lanes.MASK31))
    s_ref, sc = _ref_turn(rp, ref.tables)(s_ref, eh, el, used, inj_ref)
    run = lanes._build_hybrid_run(p, port.tables, s_port)
    got = run(ext_t, used, inj_port[None])
    assert got == np.asarray(jax.device_get(sc)).tolist()
    _assert_states(s_ref, s_port)
    count = got[lanes.HYB_EGRESS_COUNT]
    np.testing.assert_array_equal(s_port.egress[:count].numpy(),
                                  np.asarray(s_ref.egress)[:count])
    if case == "egress_floor":
        assert got[lanes.HYB_LANE_MIN] < got[lanes.HYB_DEV_WE]  # paused
    else:
        assert got[lanes.HYB_LANE_MIN] >= got[lanes.HYB_DEV_WE]
    # a second turn from there, with nothing to inject, stays equal
    s_ref, sc = _ref_turn(rp, ref.tables)(
        s_ref, NEVER32, NEVER32, NEVER32, {k: jnp.asarray(v) for k, v in dict(
            valid=np.zeros(p.inject_batch, bool),
            dst=np.zeros(p.inject_batch, np.int32),
            thi=np.full(p.inject_batch, NEVER32, np.int32),
            tlo=np.full(p.inject_batch, NEVER32, np.int32),
            auxh=np.zeros(p.inject_batch, np.int32),
            auxl=np.zeros(p.inject_batch, np.int32),
            size=np.zeros(p.inject_batch, np.int32)).items()})
    assert run(lanes.NEVER, NEVER32) == np.asarray(
        jax.device_get(sc)).tolist()
    _assert_states(s_ref, s_port)


# -- the host-side draws --------------------------------------------------------

def test_scalar_threefry_matches_torch_and_reference():
    g = np.random.default_rng(5)
    for _ in range(200):
        seed = int(g.integers(0, 1 << 63))
        stream = int(g.integers(0, 1 << 17)) | int(g.choice(
            [rng.LOSS_STREAM, rng.APP_STREAM]))
        counter = int(g.integers(0, 1 << 40))
        want = int(ref_rng.rand_u32(seed, stream, counter))
        assert rng.rand_u32_int(seed, stream, counter) == want
        assert int(rng.rand_u32(seed, stream, counter)) == want
        assert rng.u32_below(want, 1000) == int(ref_rng.u32_below(want, 1000))
    assert rng.host_seed(42, 7) == ref_rng.host_seed(42, 7)


# -- refusals -------------------------------------------------------------------

@pytest.mark.parametrize("edit", [
    "hybrid_fuse_k: 2", "hybrid_workers: 2", "hybrid_workers: 0",
    "obs_turns: true", "perf_logging: true", "obs_trace: true",
])
def test_refused_hybrid_options(edit, tmp_path):
    """The turn ledger stays refused on a hybrid run; perf logging and the
    tracer validate (the facade sets the engine's ``perf_log`` and
    ``obs``); the fused law and the worker processes validate, and
    ``make_hybrid_engine`` picks the reference facade's engine for them (0
    workers: one per core, at most one per managed host)."""
    yaml = _mixed(tmp_path).replace("hybrid_fuse_k: 1", edit)
    cfg = ConfigOptions.from_yaml(yaml)
    if edit in ("perf_logging: true", "obs_trace: true"):
        cfg.validate()
        eng = make_hybrid_engine(cfg, device="cpu")
        assert eng.perf_log is None and eng.obs is None
        return
    if edit.startswith("hybrid_"):
        cfg.validate()
        eng = make_hybrid_engine(cfg, device="cpu")
        workers = {"hybrid_workers: 2": 2,
                   "hybrid_workers: 0": min(os.cpu_count() or 1, 2)}
        if edit in workers:
            assert isinstance(eng, MpHybridEngine)
            assert eng.workers == workers[edit] and eng._fuse_k == 8
        else:
            assert type(eng) is HybridEngine and eng._fuse_k == 2
            assert eng._fuse_on and eng._ext_slots == 9
        return
    with pytest.raises(LaneCompatError, match="item 12"):
        cfg.validate()


@pytest.mark.parametrize("kind", ["link_down", "backend_stall"])
def test_refused_faults_on_a_hybrid_run(kind, tmp_path):
    event = ("{at: 500ms, kind: backend_stall}" if kind == "backend_stall"
             else "{at: 500ms, kind: link_down, source: 0, target: 0}")
    yaml = _mixed(tmp_path).replace("hosts:", f"faults: {{events: [{event}]}}\nhosts:")
    with pytest.raises(LaneCompatError, match="item 12"):
        HybridEngine(ConfigOptions.from_yaml(yaml), device="cpu")


def test_lane_engine_refuses_managed_hosts(tmp_path):
    with pytest.raises(LaneCompatError, match="hybrid"):
        GpuEngine(ConfigOptions.from_yaml(_mixed(tmp_path)), device="cpu")
