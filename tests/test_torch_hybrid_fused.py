"""The port's k-window fused hybrid law against the JAX reference.

Kernel C's fused mode, plain (``lanes.hybrid_fused_window_plain`` under
``lanes.FusedRun``), against the reference's ``make_hybrid_fused_fn`` on
one state, field by field and readback word for word; the port's fused
``HybridEngine`` (``device="cpu"``, k = 8, eager dispatch on) against the
reference's fused ``HybridEngine``, both packages' ``CpuEngine`` and the
port's one-window run on ``tests/test_hybrid_fusion.py``'s two configs
(without the turn ledger, which the port does not run); the retry law;
``restore(snapshot(s))``.  Every comparison is exact.
"""

import dataclasses
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
from shadow_tpu.config.options import ConfigOptions as RefConfig
from shadow_tpu_torch.backend import bridge, lanes
from shadow_tpu_torch.backend.cpu_engine import CpuEngine
from shadow_tpu_torch.backend.hybrid import HybridEngine
from shadow_tpu_torch.config.options import ConfigOptions
from shadow_tpu_torch.faults import BackendStallError
from test_torch_hybrid import (_assert_states, _block, _engines, _lift,
                               _random_queues)

REPO = Path(__file__).resolve().parents[1]
BUILD = REPO / "native" / "build"
NEVER32 = lanes.NEVER32
NEVER = lanes.NEVER


@pytest.fixture(scope="module", autouse=True)
def native_build():
    subprocess.run(["make", "-C", str(REPO / "native")], check=True,
                   capture_output=True)


# -- C's fused mode, plain, against make_hybrid_fused_fn ----------------------

K_CAP = 8
SLOTS = max(2 * K_CAP, 9)
_REF_FUSED: dict = {}


def _ref_fused(rp, tables):
    """The reference's jitted fused call, compiled once per parameters."""
    if rp not in _REF_FUSED:
        _REF_FUSED[rp] = ref_lanes.make_hybrid_fused_fn(rp, tables, K_CAP,
                                                        SLOTS)
    return _REF_FUSED[rp]


def _schedule(times, horizon=NEVER) -> list:
    """``SLOTS`` ascending times: ``times``, then the horizon padding."""
    head = sorted(set(times))[:SLOTS - 1]
    return head + [horizon] * (SLOTS - len(head))


def _pairs(ext):
    t = np.asarray(ext, dtype=np.int64)
    inf = t >= NEVER
    return (jnp.asarray(np.where(inf, NEVER32, t >> 31).astype(np.int32)),
            jnp.asarray(np.where(inf, NEVER32, t & lanes.MASK31)
                        .astype(np.int32)))


WE0 = 1_000_000  # the lifted state's window end
# the host's schedule, per case (times in ns; windows are 1 ms wide): events
# in most windows (consumed one after another), the horizon inside the span
# (the dispatch stops at it), and none at all (the windows the egressed
# deliveries alone bound are consumed)
SCHEDULES = {
    "consume": _schedule([WE0 - 400_000, WE0 + 300_000, WE0 + 1_500_000,
                          WE0 + 2_100_000, WE0 + 3_700_000,
                          WE0 + 4_200_000, WE0 + 6_900_000,
                          WE0 + 8_000_000, WE0 + 9_500_000]),
    "horizon": _schedule([WE0 - 400_000, WE0 + 300_000],
                         horizon=WE0 + 1_600_000),
    "egress": _schedule([]),
}


@pytest.mark.parametrize("case,k_eff", [
    ("consume", 1), ("consume", 2), ("consume", 8), ("horizon", 8),
    ("egress", 8), ("room", 8)])
def test_fused_window_matches_reference(case, k_eff, tmp_path):
    """One fused dispatch and the next, from a lifted state whose external
    lanes pop packets behind 2 Mbit down buckets (deliveries land past the
    windows they were made in) with CoDel drops among them: the readback
    and every LaneState field equal to the reference's, the egress rows
    row for row.  ``room`` shrinks the egress buffer to a few iterations
    (the dispatch stops there); at ``k_eff`` 1 the dispatch also equals
    C's hybrid mode (the one-window law)."""
    ref, port = _engines(tmp_path, extra=", use_dynamic_runahead: true",
                         down="2 Mbit")
    p, rp = port.params, ref.params
    if case == "room":
        p = dataclasses.replace(p, egress_capacity=p.ext_per_iter + 3)
        rp = dataclasses.replace(rp, egress_capacity=rp.ext_per_iter + 3)
    rng_ = np.random.default_rng(23)
    words = _random_queues(port, rng_, 12_000_000, p.capacity // 2)
    s_ref, s_port = _lift(ref, port, words, WE0)
    # empty down buckets, CoDel above its target for an interval, and lane
    # 0's (external) refill 20 ms out: its packets wait past the target
    s_ref = s_ref._replace(cd_fat_hi=jnp.zeros_like(s_ref.cd_fat_hi),
                           cd_fat_lo=jnp.ones_like(s_ref.cd_fat_lo),
                           dn_tokens=jnp.zeros_like(s_ref.dn_tokens),
                           dn_nr_lo=s_ref.dn_nr_lo.at[0].set(20_000_000),
                           egress=jnp.zeros((p.egress_capacity, 6),
                                            jnp.int64))
    s_port = s_port._replace(egress=torch.zeros((p.egress_capacity, 6),
                                                dtype=torch.int64))
    s_port.cd_fat_hi.zero_()
    s_port.cd_fat_lo.fill_(1)
    s_port.dn_tokens.zero_()
    s_port.dn_nr_lo[0] = 20_000_000
    s_one = bridge.state_from_numpy(bridge.state_to_numpy(s_port))
    s_one = s_one._replace(egress=s_port.egress.clone())
    ext = SCHEDULES["consume" if case == "room" else case]
    inj_ref, inj_port = _block(p, rng_, 40)
    fused = lanes.FusedRun(p, port.tables, s_port, K_CAP, SLOTS)
    empty = {k: jnp.asarray(v) for k, v in dict(
        valid=np.zeros(p.inject_batch, bool),
        dst=np.zeros(p.inject_batch, np.int32),
        thi=np.full(p.inject_batch, NEVER32, np.int32),
        tlo=np.full(p.inject_batch, NEVER32, np.int32),
        auxh=np.zeros(p.inject_batch, np.int32),
        auxl=np.zeros(p.inject_batch, np.int32),
        size=np.zeros(p.inject_batch, np.int32)).items()}
    seen = []
    for turn, (inj_r, inj_p, used) in enumerate(
            ((inj_ref, inj_port[None], 900_000), (empty, None, NEVER32))):
        ehi, elo = _pairs(ext)
        s_ref, sc = _ref_fused(rp, ref.tables)(s_ref, ehi, elo, used, inj_r,
                                               np.int32(k_eff))
        got = fused(ext, used, inj_p, k_eff)
        want = np.asarray(jax.device_get(sc)).tolist()
        assert got == want, (turn, got, want)
        _assert_states(s_ref, s_port)
        count = got[lanes.HYB_EGRESS_COUNT]
        np.testing.assert_array_equal(s_port.egress[:count].numpy(),
                                      np.asarray(s_ref.egress)[:count])
        seen.append((got, s_port.egress[:count].clone()))
        if turn == 0 and k_eff == 1:
            # the one-window law on the same inputs gives the same turn
            # (the host's next event is the schedule's first slot); only
            # egress_min may differ, which the fused law re-arms at a
            # consumed window's end and every dispatch's first step resets
            one = lanes._build_hybrid_run(p, port.tables, s_one)
            assert one(ext[0], used, inj_port[None]) == got[:5]
            for f in lanes.LaneState._fields:
                if f not in ("egress_min_hi", "egress_min_lo"):
                    assert torch.equal(getattr(s_one, f),
                                       getattr(s_port, f)), f
    got, egress = seen[0]
    k_done = got[lanes.HYB_K_DONE]
    if case == "consume":
        assert k_done == k_eff  # stopped at k_eff
        if k_eff == 8:
            # the refolds met DELIVERED rows on both sides of a consumed
            # window's end, and CoDel drops
            t_ok = egress[egress[:, 5] == 0, 0]
            assert (egress[:, 5] == 2).any()
            assert any(bool((t_ok < we).any() and (t_ok >= we).any())
                       for we in got[lanes.HYB_WE_BASE:][:k_done])
    elif case == "horizon":
        assert 0 < k_done < k_eff
    elif case == "egress":
        assert k_done == k_eff
    else:  # room: the egress floor stopped it mid-window
        assert got[lanes.HYB_LANE_MIN] < got[lanes.HYB_DEV_WE]


# -- device snapshots ---------------------------------------------------------

def test_snapshot_restore_field_for_field(tmp_path):
    """``restore(snapshot(s))`` after a dispatch that moved every field
    gives back ``s`` field for field (the log, the ring and the egress
    buffer aside: their counts come back, the rows beyond them are free)."""
    _ref, port = _engines(tmp_path, down="2 Mbit")
    p = port.params
    rng_ = np.random.default_rng(5)
    words = _random_queues(port, rng_, 8_000_000, p.capacity // 2)
    _s_ref, s = _lift(_ref, port, words, WE0)
    s = s._replace(egress=torch.zeros((p.egress_capacity, 6),
                                      dtype=torch.int64))
    before = {f: getattr(s, f).clone() for f in lanes.LaneState._fields}
    snap = lanes.snapshot(s)
    assert set(snap) == set(lanes.LaneState._fields) - set(lanes.SNAP_SKIP)
    fused = lanes.FusedRun(p, port.tables, s, K_CAP, SLOTS)
    _inj_ref, inj = _block(p, rng_, 40)
    fused(SCHEDULES["consume"], 900_000, inj[None], 8)
    moved = [f for f in snap if not torch.equal(getattr(s, f), before[f])]
    assert {"q_thi", "rounds", "now_we_lo", "egress_count"} <= set(moved)
    lanes.restore(s, snap)
    for f in snap:
        assert torch.equal(getattr(s, f), before[f]), f
    assert lanes.snapshot_bytes(snap) == sum(
        before[f].numel() * before[f].element_size() for f in snap)


# -- the fused engine against the reference and the oracles -------------------

def _fusion_yaml(d: Path, fuse_k: int = 8) -> str:
    """tests/test_hybrid_fusion.py's _cfg without obs_turns: a managed
    pingpong pair and a tcpecho pair over four tgen-mesh lanes (pingpong's
    request/response cadence stages sends that land one window out:
    rollbacks and eager misses beside clean fused spans)."""
    mesh = "".join(f"""
  zm{i:03d}:
    network_node_id: 0
    processes:
      - path: tgen-mesh
        args: --interval 50ms --size 600
        start_time: 0 s
""" for i in range(4))
    return f"""
general: {{stop_time: 2s, seed: 21, data_directory: {d}, heartbeat_interval: null}}
network: {{graph: {{type: 1_gbit_switch}}}}
experimental: {{network_backend: tpu, hybrid_fuse_k: {fuse_k},
                hybrid_async_dispatch: true}}
hosts:
  cli:
    network_node_id: 0
    processes:
      - path: {BUILD / 'pingpong'}
        args: [client, 11.0.0.4, "9000", "4", "100"]
  srv:
    network_node_id: 0
    processes:
      - path: {BUILD / 'pingpong'}
        args: [server, "9000", "4"]
  ecli:
    network_node_id: 0
    processes:
      - path: {BUILD / 'tcpecho'}
        args: [hclient, esrv, "7000", "2", "400", "5"]
        start_time: 200ms
  esrv:
    network_node_id: 0
    processes:
      - path: {BUILD / 'tcpecho'}
        args: [server, "7000", "1"]
{mesh}
"""


def _congested_yaml(d: Path, fuse_k: int = 8) -> str:
    """tests/test_hybrid_fusion.py's _congested_cfg without obs_turns:
    bulk echo into a 10 Mbit node queues deliveries in the down buckets
    (their t_deliver past the window that made them) while a pingpong
    pair keeps forcing rollbacks."""
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
experimental: {{network_backend: tpu, hybrid_fuse_k: {fuse_k}}}
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


CONFIGS = {"mixed": _fusion_yaml, "congested": _congested_yaml}
INT_STATS = ("device_turns", "scalar_reads", "inject_blocks", "inject_rows",
             "inject_bytes", "egress_reads", "egress_rows", "egress_bytes",
             "fused_dispatches", "fused_windows", "turns_saved",
             "fuse_rollbacks", "async_dispatch_hits", "async_dispatch_misses",
             "dispatch_retries")
ORACLE_KEYS = ("udp_tx_bytes", "udp_rx_bytes", "managed_exit_clean",
               "managed_tcp_rx_bytes", "tgen_recv_bytes")


def _mod_iters(r) -> dict:
    # lane_iters counts device iterations: a fused dispatch runs no-op
    # iterations in windows the one-window law never visits
    return {k: v for k, v in r.counters.items() if k != "lane_iters"}


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def fused_runs(request, tmp_path_factory):
    """One config's runs: the reference's fused HybridEngine and CpuEngine,
    the port's fused HybridEngine (CPU), its one-window run and its
    CpuEngine."""
    name = request.param
    d = tmp_path_factory.mktemp(name)
    make = CONFIGS[name]
    ref_eng = RefHybrid(RefConfig.from_yaml(make(d / "rf")))
    out = {"name": name, "ref_eng": ref_eng, "ref": ref_eng.run(),
           "ref_cpu": RefCpu(RefConfig.from_yaml(make(d / "rc"))).run()}
    port_eng = HybridEngine(ConfigOptions.from_yaml(make(d / "pf")),
                            device="cpu")
    out.update(port_eng=port_eng, port=port_eng.run())
    one = HybridEngine(ConfigOptions.from_yaml(make(d / "p1", fuse_k=1)),
                       device="cpu")
    out.update(one_eng=one, one=one.run())
    out["port_cpu"] = CpuEngine(ConfigOptions.from_yaml(make(d / "pc"))).run()
    return out


def test_fused_engine_equals_reference_and_oracles(fused_runs):
    """The port's fused engine against the reference's fused engine (logs,
    rounds, every counter, per-host counters and the integer
    ``sync_stats``), its one-window run (a scheduling change: all but
    ``lane_iters``) and both packages' CPU oracles; the congested config
    rolls back, the mixed one adopts and undoes eager dispatches."""
    r = fused_runs
    port, ref = r["port"], r["ref"]
    for res in (port, ref, r["one"], r["ref_cpu"], r["port_cpu"]):
        assert not res.process_errors, res.process_errors
    assert len(ref.event_log) > 100
    # the reference's fused engine: everything, lane_iters included
    assert port.log_tuples() == ref.log_tuples()
    assert port.rounds == ref.rounds
    assert port.counters == ref.counters
    assert port.per_host_counters == ref.per_host_counters
    # the port's one-window law: a scheduling change only
    assert port.log_tuples() == r["one"].log_tuples()
    assert port.rounds == r["one"].rounds
    assert _mod_iters(port) == _mod_iters(r["one"])
    assert port.per_host_counters == r["one"].per_host_counters
    # both packages' CPU oracles
    for oracle in (r["ref_cpu"], r["port_cpu"]):
        assert port.log_tuples() == oracle.log_tuples()
        assert port.rounds == oracle.rounds
        for k in ORACLE_KEYS:
            assert port.counters.get(k) == oracle.counters.get(k), k
    assert port.counters["managed_exit_clean"] > 0
    # the transfers and the fused law's counters
    ps, rs = r["port_eng"].sync_stats, r["ref_eng"].sync_stats
    for k in INT_STATS:
        assert ps[k] == rs[k], (k, ps[k], rs[k])
    assert ps["fused_dispatches"] > 0 and ps["fuse_rollbacks"] > 0
    assert r["one_eng"].sync_stats["fused_dispatches"] == 0
    if r["name"] == "mixed":
        # fewer turns than the one-window law; the eager dispatch was
        # adopted and undone, both (the congested config's rollbacks cost
        # more turns than its spans save)
        assert ps["turns_saved"] > 0
        assert ps["device_turns"] < r["one_eng"].sync_stats["device_turns"]
        assert ps["async_dispatch_hits"] > 0
        assert ps["async_dispatch_misses"] > 0


# -- the retry law ------------------------------------------------------------

def test_dispatch_retry_law(tmp_path, monkeypatch):
    """A dispatch whose wait raises once (after its launches moved the
    state) is retried from the pre-turn snapshot: the run is unchanged and
    ``dispatch_retries`` is 1.  One that keeps raising ends in
    ``BackendStallError`` after ``dispatch_retry_max`` retries."""
    base_eng = HybridEngine(
        ConfigOptions.from_yaml(_fusion_yaml(tmp_path / "base")), device="cpu")
    base = base_eng.run()
    assert base_eng.sync_stats["dispatch_retries"] == 0
    real = lanes.FusedRun.resolve
    calls = {"n": 0}

    def once(self, h):
        calls["n"] += 1
        if calls["n"] == 5:
            raise RuntimeError("injected dispatch failure")
        return real(self, h)

    monkeypatch.setattr(lanes.FusedRun, "resolve", once)
    eng = HybridEngine(ConfigOptions.from_yaml(_fusion_yaml(tmp_path / "a")),
                       device="cpu")
    res = eng.run()
    assert eng.sync_stats["dispatch_retries"] == 1
    assert res.log_tuples() == base.log_tuples()
    assert res.rounds == base.rounds
    assert res.counters == base.counters

    def always(self, h):
        raise RuntimeError("injected sticky failure")

    monkeypatch.setattr(lanes.FusedRun, "resolve", always)
    eng = HybridEngine(ConfigOptions.from_yaml(_fusion_yaml(tmp_path / "b")),
                       device="cpu")
    with pytest.raises(BackendStallError, match="after 2 retries"):
        eng.run()
    assert eng.sync_stats["dispatch_retries"] == 2
