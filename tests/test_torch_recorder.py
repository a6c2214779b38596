"""The port's observation of runs: twins of the Recorder, metrics, tracer
and PerfLog cases of ``tests/test_obs.py``, and the reports against the
JAX reference's.

1. Golden perf-log line formats, and the one locked ``emit`` path
   (worker-process lines forwarded to the parent's sink).
2. Tracer and metrics: the Chrome-trace export, the METRICS schema, the
   span-sum = ``phase_wall_s`` cross-check, the JSONL stream.
3. obs on = obs off, on the cpu and the lane backend.
4. Against the reference's ``Simulation`` on one lane config with every
   report on (step driver): the METRICS keys, counters, histograms and
   span counts; ``NETOBS_*.json`` and ``FLOWS_*.json`` but their
   wall-time fields.  On one hybrid config (the native apps of
   ``tests/test_torch_hybrid.py``): the integer fields of the
   ``[hybrid-agg]`` lines equal the reference's, and the multiprocess
   engine's forwarded stream equals the serial engine's.
5. The run-control ``stats`` / ``trace`` verbs and the CLI's obs flags.
"""

import io
import json
import threading
from pathlib import Path

import pytest

import test_lane_parity as lp_cfg
from shadow_tpu.backend.hybrid import HybridEngine as RefHybrid
from shadow_tpu.config.options import ConfigOptions as RefConfig
from shadow_tpu.engine.run_control import PerfLog as RefPerfLog
from shadow_tpu.engine.sim import Simulation as RefSimulation
from shadow_tpu_torch.backend.cpu_engine import CpuEngine
from shadow_tpu_torch.backend.gpu_engine import GpuEngine
from shadow_tpu_torch.backend.hybrid import HybridEngine, MpHybridEngine
from shadow_tpu_torch.config.options import ConfigOptions
from shadow_tpu_torch.engine.run_control import (
    BufferedPerfLog,
    PerfLog,
    RunControl,
)
from shadow_tpu_torch.engine.sim import Simulation
from shadow_tpu_torch.obs import MetricsRegistry, Recorder, Tracer
from test_torch_hybrid import _mixed, native_build  # noqa: F401  (fixture)

SYNC_STATS = {
    "device_turns": 3,
    "device_sync_s": 0.25,
    "syscall_service_s": 0.125,
    "scalar_reads": 3,
    "inject_blocks": 1,
    "inject_rows": 7,
    "inject_bytes": 12800,
    "egress_reads": 2,
    "egress_rows": 9,
    "egress_bytes": 96,
}


# -- 1. golden perf-log formats and the locked emit path -----------------------


class TestPerfLogGoldenFormats:
    def test_window_agg_format(self):
        out = io.StringIO()
        PerfLog(out=out).window_agg(3, 1000, 2000, 1500)
        assert out.getvalue() == (
            "[window-agg] active_hosts_in_window=3 "
            "window_start_ns=1000 window_end_ns=2000 next_event_ns=1500\n"
        )

    def test_host_exec_agg_format(self):
        out = io.StringIO()
        pl = PerfLog(out=out)
        pl.HOST_EXEC_LOG_EVERY = 2  # instance override: emit on call 2
        pl.host_exec("alpha", 10, 500)
        assert out.getvalue() == ""  # below the every-N threshold
        pl.host_exec("beta", 30, 700)
        assert out.getvalue() == (
            "[host-exec-agg] calls=2 total_ns=40 last_ns=30 "
            "host=beta window_end_abs_ns=700\n"
        )

    def test_hybrid_agg_format(self):
        out = io.StringIO()
        PerfLog(out=out).hybrid_agg("device", 102000000, SYNC_STATS)
        assert out.getvalue() == (
            "[hybrid-agg] kind=device window_end_ns=102000000 "
            "device_turns=3 device_sync_ns=250000000 "
            "syscall_service_ns=125000000 scalar_reads=3 "
            "inject_blocks=1 inject_rows=7 inject_bytes=12800 "
            "egress_reads=2 egress_rows=9 egress_bytes=96\n"
        )

    def test_formats_equal_the_reference(self):
        args = (3, 1000, 2000, 1500)
        assert PerfLog.format_window_agg(*args) == \
            RefPerfLog.format_window_agg(*args)
        assert PerfLog.format_hybrid_agg("host", 7, SYNC_STATS) == \
            RefPerfLog.format_hybrid_agg("host", 7, SYNC_STATS)
        assert PerfLog.format_host_exec_agg(1, 2, 3, "h", 4) == \
            RefPerfLog.format_host_exec_agg(1, 2, 3, "h", 4)

    def test_emit_is_atomic_under_threads(self):
        out = io.StringIO()
        pl = PerfLog(out=out)

        def hammer(tag):
            for i in range(200):
                pl.window_agg(tag, i, i + 1, i + 2)

        threads = [threading.Thread(target=hammer, args=(t,))
                   for t in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        lines = out.getvalue().splitlines()
        assert len(lines) == 800
        for line in lines:
            assert line.startswith("[window-agg] active_hosts_in_window=")
            assert line.count("window_start_ns=") == 1

    def test_buffered_perf_log_forwards_through_emit_many(self):
        wpl = BufferedPerfLog()
        wpl.window_agg(1, 0, 100, 50)
        wpl.hybrid_agg("host", 100, SYNC_STATS)
        lines = wpl.drain()
        assert len(lines) == 2 and wpl.drain() == []
        out = io.StringIO()
        PerfLog(out=out).emit_many(lines)
        got = out.getvalue().splitlines()
        assert got[0] == PerfLog.format_window_agg(1, 0, 100, 50)
        assert got[1] == PerfLog.format_hybrid_agg("host", 100, SYNC_STATS)


# -- 2. tracer / metrics / recorder units ---------------------------------------


class TestTracer:
    def test_export_shape(self, tmp_path):
        tr = Tracer()
        tr.complete("w", "window_compute", tr.t0, 0.002, {"we": 5})
        tr.instant("mark", "mark")
        doc = json.loads(tr.export(tmp_path / "t.json").read_text())
        assert doc["displayTimeUnit"] == "ms"
        spans = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
        assert len(spans) == 1
        ev = spans[0]
        assert ev["name"] == "w" and ev["cat"] == "window_compute"
        assert ev["pid"] == 1 and isinstance(ev["tid"], int)
        assert ev["dur"] == pytest.approx(2000.0)
        assert ev["args"] == {"we": 5}
        assert any(e.get("ph") == "M" for e in doc["traceEvents"])

    def test_capacity_bound(self):
        tr = Tracer(capacity=3)
        for i in range(5):
            tr.complete(f"s{i}", "c", tr.t0, 0.001)
        assert tr.span_count() == 3 and tr.dropped == 2

    def test_disable_toggle(self):
        tr = Tracer()
        tr.enabled = False
        tr.complete("s", "c", tr.t0, 0.001)
        assert tr.span_count() == 0


class TestMetricsRegistry:
    def test_counters_gauges_histograms(self):
        m = MetricsRegistry(run_id="t")
        m.count("windows")
        m.count("windows", 2)
        m.gauge("workers", 4)
        for v in (1, 2, 3, 4, 100):
            m.observe("active", v)
        rep = m.report()
        assert rep["counters"] == {"windows": 3}
        assert rep["gauges"] == {"workers": 4}
        h = rep["histograms"]["active"]
        assert h["count"] == 5 and h["min"] == 1 and h["max"] == 100
        assert h["mean"] == pytest.approx(22.0)
        assert h["p50"] == 3

    def test_phase_walls_and_report_schema(self):
        m = MetricsRegistry(run_id="t")
        m.phase_add("device_turn", 0.5)
        m.phase_add("device_turn", 0.25)
        m.phase_add("egress", 0.125)
        rep = m.report(extra={"backend": "tpu"})
        assert rep["phase_wall_s"] == {"device_turn": 0.75, "egress": 0.125}
        assert rep["phases"]["device_turn"]["spans"] == 2
        assert rep["phase_wall_total_s"] == pytest.approx(0.875)
        assert rep["backend"] == "tpu"
        assert rep["schema"] == 1

    def test_timer_observes(self):
        m = MetricsRegistry(run_id="t")
        with m.timer("block"):
            pass
        assert m.report()["histograms"]["block"]["count"] == 1

    def test_jsonl_stream(self, tmp_path):
        m = MetricsRegistry(run_id="t", jsonl_path=tmp_path / "m.jsonl")
        m.stream({"ev": "mark", "name": "x"})
        m.close()
        lines = (tmp_path / "m.jsonl").read_text().splitlines()
        assert [json.loads(ln)["ev"] for ln in lines] == ["mark"]


class TestRecorder:
    def test_phase_span_feeds_metrics_and_trace(self, tmp_path):
        rec = Recorder(run_id="t", out_dir=tmp_path, trace=True)
        with rec.phase("window_compute", window_end=7):
            pass
        rec.record("egress", None, rec.tracer.t0, 0.5, rows=3)
        fin = rec.finalize(extra={"backend": "cpu"})
        rep = json.loads(Path(fin["metrics_path"]).read_text())
        assert set(rep["phase_wall_s"]) == {"window_compute", "egress"}
        assert rep["phase_wall_s"]["egress"] == pytest.approx(0.5)
        doc = json.loads(Path(fin["trace_path"]).read_text())
        spans = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
        summed = {}
        for e in spans:
            summed[e["cat"]] = summed.get(e["cat"], 0.0) + e["dur"] / 1e6
        for phase, wall in rep["phase_wall_s"].items():
            assert summed[phase] == pytest.approx(wall, abs=1e-9)
        assert rec.finalize() is fin  # idempotent

    def test_annotations_ride_torch_profiler(self):
        import torch.profiler

        rec = Recorder(run_id="t", jax_annotations=True)
        assert rec._annotate is torch.profiler.record_function
        with rec.phase("device_turn", name="device_round"):
            pass
        assert rec.metrics.phase_report()["device_turn"]["spans"] == 1

    def test_engines_default_obs_none(self, tmp_path):
        cfg = _ping_cfg(tmp_path, obs="")
        assert CpuEngine(cfg).obs is None and CpuEngine(cfg).perf_log is None
        eng = GpuEngine(_ping_cfg(tmp_path, obs="", backend="tpu"),
                        device="cpu")
        assert eng.obs is None and eng.perf_log is None
        sim = Simulation(cfg)
        assert sim.obs is None  # set per run(); obs_* all default off


# -- 3. obs on = obs off ---------------------------------------------------------

OBS_ALL = ("obs_metrics: true, obs_trace: true, obs_jsonl: true, "
           "perf_logging: true")


def _ping_cfg(data_dir, obs: str = OBS_ALL, backend: str = "cpu"):
    extra = f", {obs}" if obs else ""
    return ConfigOptions.from_yaml(f"""
general: {{stop_time: 1s, seed: 7, data_directory: {data_dir},
           heartbeat_interval: null}}
experimental: {{network_backend: {backend}{extra}}}
hosts:
  a: {{processes: [{{path: ping, args: --peer b --count 5 --interval 100ms}}]}}
  b: {{processes: [{{path: ping}}]}}
  c: {{processes: [{{path: ping, args: --peer d --count 5 --interval 100ms}}]}}
  d: {{processes: [{{path: ping}}]}}
""")


class TestObsDeterminism:
    def test_cpu_run_twice_byte_identical(self, tmp_path, capsys):
        results = []
        for tag in ("r1", "r2"):
            sim = Simulation(_ping_cfg(tmp_path / tag))
            results.append(sim.run(write_data=False))
        r1, r2 = results
        assert r1.log_tuples() == r2.log_tuples()
        assert r1.counters == r2.counters

    @pytest.mark.parametrize("backend", ["cpu", "tpu"])
    def test_obs_on_equals_obs_off(self, tmp_path, backend, capsys):
        on = Simulation(_ping_cfg(tmp_path / "on", backend=backend),
                        device="cpu").run(write_data=False)
        off = Simulation(_ping_cfg(tmp_path / "off", obs="", backend=backend),
                         device="cpu").run(write_data=False)
        assert on.log_tuples() == off.log_tuples()
        assert on.counters == off.counters
        assert on.rounds == off.rounds
        assert (tmp_path / "on" / f"METRICS_{backend}-seed7.json").exists()
        assert (tmp_path / "on" / f"trace_{backend}-seed7.json").exists()
        assert (tmp_path / "on" / f"metrics_{backend}-seed7.jsonl").exists()

    def test_device_mode_records_one_free_run_span(self, tmp_path):
        cfg = _ping_cfg(tmp_path, obs="obs_metrics: true", backend="tpu")
        sim = Simulation(cfg, device="cpu")
        sim.run(write_data=False)
        rep = sim.obs.finalized["report"]
        assert rep["phases"] == {
            "device_turn": {"spans": 1,
                            "wall_s": rep["phase_wall_s"]["device_turn"]}}
        assert rep["counters"] == {}


# -- 4. the reports against the reference's --------------------------------------

# a lossy tgen pair with every report on, in the step driver (perf logging)
REPORTS_YAML = lp_cfg.TGEN_PAIR.replace(
    "general: {", "general: {data_directory: DATADIR, heartbeat_interval: null, "
).replace("hosts:", """experimental: {network_backend: tpu, obs_metrics: true,
  obs_trace: true, perf_logging: true, netobs: true, flowtrace: true}
hosts:""")


def _reports(d: Path) -> dict:
    out = {}
    for p in sorted(d.glob("*_tpu-seed3.json")):
        out[p.name.split("_")[0]] = json.loads(p.read_text())
    return out


def test_reports_equal_the_reference(tmp_path, capsys):
    ref_dir, port_dir = tmp_path / "ref", tmp_path / "port"
    RefSimulation(RefConfig.from_yaml(
        REPORTS_YAML.replace("DATADIR", str(ref_dir)))).run()
    ref_err = capsys.readouterr().err
    result = Simulation(ConfigOptions.from_yaml(
        REPORTS_YAML.replace("DATADIR", str(port_dir))), device="cpu").run()
    port_err = capsys.readouterr().err
    want, got = _reports(ref_dir), _reports(port_dir)
    assert set(got) == set(want) == {"METRICS", "NETOBS", "FLOWS", "trace"}
    assert got["NETOBS"] == want["NETOBS"]
    assert got["FLOWS"] == want["FLOWS"]
    assert got["FLOWS"]["num_events"] > 50
    m_got, m_want = got["METRICS"], want["METRICS"]
    assert set(m_got) == set(m_want)
    for key in ("counters", "histograms", "sim_counters", "netobs", "flows",
                "rounds", "restarts", "backend", "seed", "num_hosts"):
        assert m_got[key] == m_want[key], key
    assert {k: v["spans"] for k, v in m_got["phases"].items()} == \
        {k: v["spans"] for k, v in m_want["phases"].items()}
    assert m_got["counters"]["device_turns"] == result.rounds + 1
    assert m_got["counters"]["windows"] == result.rounds
    spans = [e for e in got["trace"]["traceEvents"] if e.get("ph") == "X"]
    assert len(spans) == result.rounds + 1
    # the perf lines on stderr, line for line
    assert [ln for ln in port_err.splitlines() if ln.startswith("[window-agg]")] \
        == [ln for ln in ref_err.splitlines() if ln.startswith("[window-agg]")]


def _agg_ints(text: str) -> list:
    """The ``[hybrid-agg]`` lines' fields but the two wall-time ones."""
    out = []
    for ln in text.splitlines():
        if ln.startswith("[hybrid-agg]"):
            out.append([f for f in ln.split()[1:]
                        if not f.startswith(("device_sync_ns=",
                                             "syscall_service_ns="))])
    return out


def test_hybrid_agg_lines_equal_the_reference(tmp_path):
    yaml = _mixed(tmp_path / "d")
    ref = RefHybrid(RefConfig.from_yaml(yaml))
    want = io.StringIO()
    ref.perf_log = RefPerfLog(out=want)
    ref_result = ref.run()
    eng = HybridEngine(ConfigOptions.from_yaml(yaml), device="cpu")
    got = io.StringIO()
    eng.perf_log = PerfLog(out=got)
    eng.obs = Recorder(run_id="h", trace=True)
    result = eng.run()
    assert result.log_tuples() == ref_result.log_tuples()
    lines = _agg_ints(got.getvalue())
    assert lines == _agg_ints(want.getvalue())
    kinds = {ln[0] for ln in lines}
    assert kinds == {"kind=device", "kind=host"}
    phases = eng.obs.metrics.phase_report()
    assert {"device_turn", "syscall_service", "egress"} <= set(phases)
    assert phases["device_turn"]["spans"] == eng.sync_stats["device_turns"]
    # the trace's span sums equal the METRICS phase walls
    summed: dict = {}
    for e in eng.obs.tracer.events:
        summed[e["cat"]] = summed.get(e["cat"], 0.0) + e["dur"] / 1e6
    for phase, wall in eng.obs.metrics.phase_wall_s().items():
        assert summed[phase] == pytest.approx(wall, abs=1e-6), phase


def test_mp_hybrid_forwards_worker_lines(tmp_path):
    """Worker processes buffer their perf lines and the parent prints them
    in round order: the 2-worker stream equals the serial engine's."""
    yaml = _mixed(tmp_path / "d").replace(
        "hybrid_fuse_k: 1}", "hybrid_fuse_k: 1, perf_logging: true}")
    streams = []
    for workers in (1, 2):
        cfg = ConfigOptions.from_yaml(yaml)
        eng = (MpHybridEngine(cfg, workers=workers, device="cpu")
               if workers > 1 else HybridEngine(cfg, device="cpu"))
        out = io.StringIO()
        eng.perf_log = PerfLog(out=out)
        result = eng.run()
        streams.append((_agg_ints(out.getvalue()), result.log_tuples()))
    assert streams[0] == streams[1]
    assert len(streams[0][0]) > 10


# -- 5. run-control stats / trace verbs, CLI flags --------------------------------


class TestRunControlObsVerbs:
    def test_stats_without_obs_reports_disabled(self):
        out = io.StringIO()
        rc = RunControl(out=out)
        rc._apply("stats")
        assert "obs is not enabled" in out.getvalue()

    def test_stats_prints_snapshot(self):
        out = io.StringIO()
        rc = RunControl(out=out)
        rec = Recorder(run_id="t")
        rec.metrics.count("windows", 3)
        rec.metrics.phase_add("window_compute", 0.5)
        rc.set_obs(rec)
        rc._apply("stats")
        text = out.getvalue()
        assert "windows=3" in text and "window_compute" in text

    def test_trace_status_toggle_and_dump(self, tmp_path):
        out = io.StringIO()
        rc = RunControl(out=out)
        rec = Recorder(run_id="t", out_dir=tmp_path, trace=True)
        with rec.phase("window_compute"):
            pass
        rc.set_obs(rec)
        rc._apply("trace")
        assert "1 span(s) recorded" in out.getvalue()
        rc._apply("trace off")
        assert not rec.tracer.enabled
        rc._apply("trace on")
        assert rec.tracer.enabled
        path = tmp_path / "dump.json"
        rc._apply(f"trace dump {path}")
        assert "trace written" in out.getvalue()
        assert json.loads(path.read_text())["traceEvents"]

    def test_trace_without_tracer_reports_disabled(self):
        out = io.StringIO()
        rc = RunControl(out=out)
        rc.set_obs(Recorder(run_id="t"))  # metrics only
        rc._apply("trace")
        assert "tracing is not enabled" in out.getvalue()

    @pytest.mark.parametrize("backend", ["cpu", "tpu"])
    def test_stats_verb_live_at_pause(self, tmp_path, backend, capsys):
        out = io.StringIO()
        rc = RunControl(out=out, poll_interval=0.01, max_wait=10)
        rc.feed("p", "stats", "c")
        sim = Simulation(_ping_cfg(tmp_path / "d", backend=backend),
                         run_control=rc, device="cpu")
        sim.run(write_data=False)
        assert "[run-control] stats:" in out.getvalue()
        assert "phase walls:" in out.getvalue()

    def test_netstats_and_flows_answer_from_the_live_device(self, tmp_path,
                                                            capsys):
        out = io.StringIO()
        rc = RunControl(out=out, poll_interval=0.01, max_wait=10)
        rc.feed("n", "netstats", "flows a", "c")
        cfg = _ping_cfg(tmp_path / "d", obs="netobs: true, flowtrace: true",
                        backend="tpu")
        Simulation(cfg, run_control=rc, device="cpu").run(write_data=False)
        text = out.getvalue()
        assert "[run-control] netstats:" in text
        assert "[run-control] flows:" in text
        assert "flows: sampled_pairs=" in text


class TestCliFlags:
    def test_obs_flags_map_to_overrides(self):
        from shadow_tpu_torch.__main__ import build_parser, parse_overrides

        ns = build_parser().parse_args(
            ["cfg.yaml", "--obs-metrics", "--obs-trace"])
        assert ns.obs_metrics and ns.obs_trace and ns.device == "cuda"
        overrides = parse_overrides(ns)
        assert "experimental.obs_metrics" not in overrides  # added by main
