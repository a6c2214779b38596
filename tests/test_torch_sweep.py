"""Fleet sweeps on the port against its own serial runs and the JAX
reference's.

The sweep's law: S scenarios of one shape run together — each kernel
launched once per step for all of them, a finished scenario a no-op in
every kernel — and each scenario equals its serial run bit for bit.  The
batched runs here are held to the port's serial ``GpuEngine`` runs and to
the reference's serial ``TpuEngine`` runs (the reference's vmapped sweep
equals those by its own tests, and compiles slowly on the CPU): rounds,
counters, log tuples, netobs snapshots.  The variant compiler's
rejections and the report are the reference's, on the 8-host mesh of
``test_sweep.py``.  Integer simulation: every comparison is exact.
"""

import copy
import dataclasses
import functools
import types

import numpy as np
import pytest
import torch

import test_sweep as sw_cfg
from shadow_tpu.backend.tpu_engine import TpuEngine
from shadow_tpu.config.presets import flagship_mesh_config as ref_mesh_config
from shadow_tpu.sweep.report import build_report as ref_build_report
from shadow_tpu.sweep.report import write_report as ref_write_report
from shadow_tpu_torch.backend import kernels, lanes
from shadow_tpu_torch.backend.gpu_engine import GpuEngine
from shadow_tpu_torch.config.options import (ConfigError, ConfigOptions,
                                             LaneCompatError)
from shadow_tpu_torch.config.presets import flagship_mesh_config
from shadow_tpu_torch.sweep import (SweepCongruenceError, SweepEngine,
                                    SweepSpec, build_report, expand_variants,
                                    write_report)
from shadow_tpu_torch.sweep.report import _cross_stats
from shadow_tpu_torch.sweep.variants import check_congruence

LOSS_EVENT = sw_cfg.LOSS_EVENT


def _mesh(seed: int = 42, n: int = 8) -> ConfigOptions:
    return flagship_mesh_config(n, sim_seconds=1, backend="tpu", seed=seed)


@functools.lru_cache(maxsize=None)
def _reference(seed: int, faults: tuple, netobs: bool):
    """The reference's serial device-mode run of the mesh variant (and its
    netobs snapshot), once per worker; ``faults``: the events as tuples of
    their items."""
    cfg = ref_mesh_config(8, sim_seconds=1, backend="tpu", seed=seed)
    cfg.experimental.netobs = netobs
    cfg.faults.events = [dict(e) for e in faults]
    eng = TpuEngine(cfg)
    return eng.run(mode="device"), eng._netobs_data


def _assert_results_equal(batched, serial, label):
    assert int(batched.rounds) == int(serial.rounds), label
    assert batched.counters == serial.counters, label
    assert batched.log_tuples() == serial.log_tuples(), f"{label}: log"


def _assert_netobs_equal(got, want, label):
    assert list(got["window_hist"]) == list(want["window_hist"]), label
    for k in sorted(want["arrays"]):
        assert np.array_equal(np.asarray(got["arrays"][k]),
                              np.asarray(want["arrays"][k])), f"{label}: {k}"


def _key(v):
    return (v.seed, tuple(tuple(sorted(e.items()))
                          for e in v.cfg.faults.events))


# -- batched vs serial bit-identity ---------------------------------------


@pytest.mark.parametrize("size", [1, 2, 4])
def test_seed_grid_matches_serial(size):
    """S in {1, 2, 4} seed grids: every scenario of the batched run equals
    its serial device-mode run on the port and on the reference."""
    variants = expand_variants(_mesh(), SweepSpec.seed_grid(42, size))
    results = SweepEngine(variants, device="cpu").run()
    for v, r in zip(variants, results, strict=True):
        serial = GpuEngine(v.cfg, device="cpu").run(mode="device")
        _assert_results_equal(r, serial, f"{v.label} port")
        ref, _nb = _reference(v.seed, (), False)
        _assert_results_equal(r, ref, f"{v.label} reference")


def test_fault_grid_matches_serial_with_netobs():
    """seed x fault grid with the netobs plane on: counters, window
    histograms and every netobs array equal the serial faulted runs'."""
    base = _mesh()
    base.experimental.netobs = True
    spec = SweepSpec(seeds=[42, 43], faults=[[], [LOSS_EVENT]])
    variants = expand_variants(base, spec)
    sweep = SweepEngine(variants, device="cpu")
    results = sweep.run()
    for v, r in zip(variants, results, strict=True):
        eng = GpuEngine(v.cfg, device="cpu")
        _assert_results_equal(r, eng.run(mode="device"), f"{v.label} port")
        got = sweep.engines[v.index].netobs_snapshot()
        _assert_netobs_equal(got, eng.netobs_snapshot(), f"{v.label} port")
        seed, faults = _key(v)
        ref, ref_nb = _reference(seed, faults, True)
        _assert_results_equal(r, ref, f"{v.label} reference")
        _assert_netobs_equal(got, ref_nb, f"{v.label} reference")
    # the lossy axis diverges the fleet
    drops = [int(r.counters.get("lane_drop_loss", 0)) for r in results]
    assert any(d > 0 for d in drops) and any(d == 0 for d in drops)


def test_loss_free_scenario_in_a_lossy_batch():
    """The has_loss OR: a loss-free scenario runs the batch's loss draw
    under its all-pass thresholds and still equals its serial run, which
    draws nothing."""
    variants = expand_variants(_mesh(seed=7),
                               SweepSpec(faults=[[], [LOSS_EVENT]]))
    sweep = SweepEngine(variants, device="cpu")
    assert all(e.params.has_loss for e in sweep.engines)
    results = sweep.run()
    serial = GpuEngine(variants[0].cfg, device="cpu")
    assert not serial.params.has_loss
    _assert_results_equal(results[0], serial.run(mode="device"), "loss-free")
    assert "lane_drop_loss" not in results[0].counters
    assert results[1].counters["lane_drop_loss"] > 0


def test_scenarios_ending_at_different_times():
    """The done mask: a scenario that ends while the others run on is
    left as it was, word for word (``iters`` and ``rounds`` included);
    the driver's S live flags read as one."""
    stops = (300_000_000, 1_000_000_000, 650_000_000)
    engines = [GpuEngine(_mesh(seed=s), device="cpu") for s in (1, 2, 3)]
    ps = [dataclasses.replace(eng.params, stop_time=t)
          for eng, t in zip(engines, stops)]
    states = [eng.initial_state() for eng in engines]
    run = lanes._build_sweep_run(ps, [e.tables for e in engines], states)
    run()
    assert run.steps >= 100 and run.steps % lanes.CHECK_EVERY == 0
    for eng, p, s in zip(engines, ps, states):
        serial = eng.initial_state()
        lanes._build_full_run(p, eng.tables, serial)()
        for f in lanes.LaneState._fields:
            assert torch.equal(getattr(s, f), getattr(serial, f)), (p, f)
    assert [int(s.iters) for s in states] == [30, 100, 65]


def test_each_kernel_runs_once_per_step_whatever_s(monkeypatch):
    """The batched step calls each kernel wrapper once for all S: the
    calls per step are the same at S = 1 and S = 3."""
    calls = {}
    for name in ("queue_min_window", "lane_slots", "exchange_merge",
                 "append_log"):
        fn = getattr(kernels, name)

        def spy(*a, _fn=fn, _name=name):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*a)
        monkeypatch.setattr(kernels, name, spy)
    per_step = []
    for size in (1, 3):
        calls.clear()
        engines = [GpuEngine(_mesh(seed=s), log_capacity=4096, device="cpu")
                   for s in range(size)]
        run = lanes._build_sweep_run([e.params for e in engines],
                                     [e.tables for e in engines],
                                     [e.initial_state() for e in engines])
        run()
        per_step.append({k: v / run.steps for k, v in calls.items()})
    assert per_step[0] == per_step[1] == {
        "queue_min_window": 1.0, "lane_slots": 1.0, "exchange_merge": 1.0,
        "append_log": 1.0}


def test_serial_arm_matches_batched():
    """The sweep's serial arm: the port's GpuEngine, one variant at a time,
    equals the batched run."""
    variants = expand_variants(_mesh(), SweepSpec.seed_grid(42, 2))
    serial = [GpuEngine(v.cfg, device="cpu").run() for v in variants]
    batched = SweepEngine(variants, device="cpu")
    for v, a, b in zip(variants, serial, batched.run(), strict=True):
        _assert_results_equal(a, b, v.label)
    assert batched.launches["lane_slots"] == 0  # plain versions on the CPU


def test_no_card_means_an_error(monkeypatch):
    variants = expand_variants(_mesh(), SweepSpec.seed_grid(42, 2))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SweepEngine(variants)


# -- congruence rejection -------------------------------------------------


def test_latency_override_rejected():
    spec = SweepSpec(overrides=[{}, {"experimental.runahead": "20 ms"}])
    variants = expand_variants(_mesh(), spec)
    with pytest.raises(SweepCongruenceError, match="fault axis"):
        SweepEngine(variants, device="cpu")


def test_backend_stall_rejected():
    spec = SweepSpec(faults=[[{"at": "200 ms", "kind": "backend_stall"}]])
    with pytest.raises(SweepCongruenceError, match="backend_stall"):
        expand_variants(_mesh(), spec)


def test_flowtrace_seed_grid_rejected():
    base = _mesh()
    base.experimental.flowtrace = True
    variants = expand_variants(base, SweepSpec.seed_grid(42, 2))
    with pytest.raises(SweepCongruenceError, match="flowtrace"):
        SweepEngine(variants, device="cpu")


def test_differing_topology_rejected():
    with pytest.raises(SweepCongruenceError, match="not shape-congruent"):
        check_congruence([GpuEngine(_mesh(n=8), device="cpu"),
                          GpuEngine(_mesh(n=12), device="cpu")])


def test_unknown_spec_keys_rejected():
    with pytest.raises(SweepCongruenceError, match="unknown"):
        SweepSpec.from_dict({"seeds": [1], "bogus": 3})
    spec = SweepSpec.from_yaml("name: grid\nseeds: [3, 4]\nfaults: [[], []]\n")
    assert spec.size == 4 and spec.seeds == [3, 4]


def test_more_than_one_device_refused():
    base = _mesh()
    base.experimental.mesh_devices = 4
    with pytest.raises(LaneCompatError, match="item 14"):
        expand_variants(base, SweepSpec.seed_grid(42, 2))
    with pytest.raises(LaneCompatError, match="item 14"):
        GpuEngine(base, device="cpu")


def test_sweep_options_and_overrides():
    """sweep_size and sweep_spec parse and are checked, then refused until
    the sweep command line that reads them is ported."""
    cfg = ConfigOptions.from_dict({
        "general": {"stop_time": "1 s"},
        "experimental": {"sweep_size": 4, "sweep_spec": "grid.yaml"},
        "hosts": {"h": {"processes": [{"path": "tgen-mesh"}]}},
    })
    assert (cfg.experimental.sweep_size, cfg.experimental.sweep_spec) == (
        4, "grid.yaml")
    for size, spec in ((4, None), (1, "grid.yaml"), (4, "grid.yaml")):
        cfg.experimental.sweep_size, cfg.experimental.sweep_spec = size, spec
        with pytest.raises(LaneCompatError, match="item 12"):
            cfg.validate()
    cfg.experimental.sweep_size, cfg.experimental.sweep_spec = 1, None
    cfg.validate()
    cfg.apply_overrides({"general.seed": "9", "experimental.runahead": "2 ms",
                         "experimental.netobs": "true"})
    assert cfg.general.seed == 9 and cfg.experimental.runahead == 2_000_000
    assert cfg.experimental.netobs is True
    for bad in ({"general.nope": 1}, {"hosts.x": 1}):
        with pytest.raises(ConfigError, match="unknown config option"):
            cfg.apply_overrides(bad)
    cfg.experimental.sweep_size = -1
    with pytest.raises(ConfigError, match="sweep_size"):
        cfg.validate()


# -- padded fault epochs ---------------------------------------------------


def test_segment_plan_padding_shape():
    cfg = _mesh()
    cfg.faults.events = [dict(LOSS_EVENT)]
    eng = GpuEngine(cfg, device="cpu")
    stop = cfg.general.stop_time
    plan = eng.segment_plan(pad_to=5)
    assert len(plan) == 5
    # real segments tile [0, stop); pad rows are zero-length at stop
    assert plan[0][0] == 0 and plan[-1] == (stop, stop, plan[1][2])
    for seg_start, seg_end, _ in plan[2:]:
        assert seg_start == seg_end == stop
    bare = GpuEngine(_mesh(), device="cpu").segment_plan(pad_to=3)
    assert bare == [(0, stop, None)] + [(stop, stop, None)] * 2


# -- report aggregation ---------------------------------------------------


def test_report_matches_reference_bytes(tmp_path):
    spec = SweepSpec(name="rpt", seeds=[42, 43], faults=[[], [LOSS_EVENT]])
    base = _mesh()
    base.experimental.netobs = True
    sweep = SweepEngine(expand_variants(base, spec), device="cpu")
    results = sweep.run()
    rep = build_report(sweep, results, name="rpt")
    assert rep["size"] == 4 and len(rep["scenarios"]) == 4
    cross = rep["cross"]["lane_drop_loss"]
    assert cross["max"] > cross["min"]  # the loss axis diverges
    assert set(cross) == {"p50", "p90", "p99", "min", "max", "outliers"}
    for row in rep["scenarios"]:
        assert row["drops"]["loss"] == row["counters"].get("lane_drop_loss", 0)
        assert row["netobs"]["tx_bytes"] > 0
    p1 = write_report(rep, tmp_path / "a")
    p2 = write_report(build_report(sweep, results, name="rpt"), tmp_path / "b")
    assert p1.name == "SWEEP_rpt-S4.json"
    assert p1.read_bytes() == p2.read_bytes()
    # the reference's aggregator over the same results (its sweep engine
    # names the batched lane backend "tpu"): the same bytes
    ref_sweep = types.SimpleNamespace(variants=sweep.variants,
                                      engines=sweep.engines, size=sweep.size,
                                      backend="tpu")
    p3 = ref_write_report(ref_build_report(ref_sweep, copy.deepcopy(results),
                                           name="rpt"), tmp_path / "c")
    assert p3.read_bytes() == p1.read_bytes()


def test_outlier_flags():
    st = _cross_stats([100, 100, 100, 250])
    assert st["outliers"] == [3]
    assert _cross_stats([5, 5, 5, 5])["outliers"] == []
