"""The port's run-control console and perf logging: the twins of
``tests/test_run_control.py``, and the step driver's ``[window-agg]``
lines against the JAX reference's.

Commands are scripted through ``RunControl.feed`` — the queue the
interactive stdin thread feeds — so the tests drive the production path
minus the terminal.  Every facade case runs on the port's cpu backend
(its ``CpuEngine``) and on its lane backend, whose step driver
(``GpuEngine._drive_steps``) gives the console a boundary after every
window; restarts and pauses must leave the results equal to an
uninterrupted run.  The ``[window-agg]`` lines of the port's step driver
equal the reference ``TpuEngine`` step driver's line for line on a plain,
a tiered-stream and a faulted configuration.
"""

import io

import pytest

import test_lane_parity as lp_cfg
from shadow_tpu.backend.tpu_engine import TpuEngine
from shadow_tpu.config.options import ConfigOptions as RefConfig
from shadow_tpu.engine.run_control import PerfLog as RefPerfLog
from shadow_tpu_torch.backend.gpu_engine import GpuEngine
from shadow_tpu_torch.config.options import ConfigOptions
from shadow_tpu_torch.engine.run_control import (
    PerfLog,
    RestartRequest,
    RunControl,
)
from shadow_tpu_torch.engine.sim import Simulation

BASE_YAML = """
general:
  stop_time: 3s
  heartbeat_interval: null
experimental:
  runahead: 100 ms
hosts:
  a:
    processes: [{path: ping, args: --peer b --count 5 --interval 200ms}]
  b:
    processes: [{path: ping}]
"""

BACKENDS = ["cpu", "tpu"]


def make_cfg(backend="cpu", **overrides):
    cfg = ConfigOptions.from_yaml(BASE_YAML)
    cfg.experimental.network_backend = backend
    cfg.apply_overrides(overrides)
    return cfg


def run_with_commands(cfg, *commands, out=None):
    rc = RunControl(out=out or io.StringIO(), poll_interval=0.01, max_wait=10)
    rc.feed(*commands)
    sim = Simulation(cfg, run_control=rc, device="cpu")
    result = sim.run(write_data=False)
    return rc, sim, result


def baseline(backend):
    return Simulation(make_cfg(backend), device="cpu").run(write_data=False)


class TestCommandParsing:
    def test_pause_request(self):
        rc = RunControl(out=io.StringIO())
        assert rc._apply("p") is False
        assert rc.pause_requested

    def test_continue_resumes(self):
        rc = RunControl(out=io.StringIO())
        assert rc._apply("c", paused=True) is True

    def test_run_for_seconds(self):
        rc = RunControl(out=io.StringIO())
        assert rc._apply("c2") is True
        rc.consume_run_for(500)
        assert rc.run_until_abs_ns == 500 + 2 * 10**9

    def test_step_one_window(self):
        rc = RunControl(out=io.StringIO())
        assert rc._apply("n") is True
        assert rc.step_windows_remaining == 1

    def test_restart(self):
        rc = RunControl(out=io.StringIO())
        with pytest.raises(RestartRequest) as ei:
            rc._apply("r")
        assert ei.value.run_until_ns is None

    def test_restart_to_time(self):
        rc = RunControl(out=io.StringIO())
        with pytest.raises(RestartRequest) as ei:
            rc._apply("r2")
        assert ei.value.run_until_ns == 2 * 10**9

    def test_unknown_command_reports(self):
        out = io.StringIO()
        rc = RunControl(out=out)
        rc._apply("bogus")
        assert "unknown command" in out.getvalue()

    def test_attach_hint(self):
        out = io.StringIO()
        rc = RunControl(out=out)
        rc._apply("s:1234")
        assert "gdb -p 1234" in out.getvalue()

    @pytest.mark.parametrize("cmd,item", [
        ("turns", "item 12"), ("checkpoint", "item 11"),
        ("resume /tmp/ckpt", "item 11"), ("fault link_down 0 1", "item 12"),
        ("failover", "item 12"),
    ])
    def test_later_item_verbs_name_their_item(self, cmd, item):
        out = io.StringIO()
        rc = RunControl(out=out)
        assert rc._apply(cmd, paused=True) is False
        assert item in out.getvalue() and "not ported yet" in out.getvalue()


class TestSoftPause:
    @pytest.mark.parametrize("backend", BACKENDS)
    def test_pause_then_continue_completes(self, backend):
        # p pauses at the first boundary; c resumes; the run completes
        rc, sim, result = run_with_commands(make_cfg(backend), "p", "c")
        assert rc.pauses == 1
        assert result.log_tuples() == baseline(backend).log_tuples()
        if backend == "cpu":
            assert result.counters.get("ping_recv", 0) == 5

    @pytest.mark.parametrize("backend", BACKENDS)
    def test_step_pauses_each_window(self, backend):
        # the first n is consumed while running (a pause after the next
        # window); each later n is issued from a pause
        rc, sim, result = run_with_commands(make_cfg(backend), "n", "n", "n",
                                            "c")
        assert rc.pauses == 3
        assert result.log_tuples() == baseline(backend).log_tuples()

    @pytest.mark.parametrize("backend", BACKENDS)
    def test_run_for_simulated_time(self, backend):
        # c1: run one simulated second then pause; then c to finish
        out = io.StringIO()
        rc, sim, result = run_with_commands(make_cfg(backend), "c1", "c",
                                            out=out)
        assert rc.pauses == 1
        assert "paused at window boundary: sim-time 1." in out.getvalue()
        assert result.log_tuples() == baseline(backend).log_tuples()

    @pytest.mark.parametrize("backend", BACKENDS)
    def test_step_past_drained_queue_terminates(self, backend):
        # more steps queued than windows exist: the step pause landing on
        # the terminal boundary reports and lets the run complete
        out = io.StringIO()
        rc, sim, result = run_with_commands(make_cfg(backend), *["n"] * 200,
                                            out=out)
        assert "terminal: event queues drained" in out.getvalue()
        assert rc.step_windows_remaining == 0
        assert result.log_tuples() == baseline(backend).log_tuples()

    @pytest.mark.parametrize("backend", BACKENDS)
    def test_run_until_past_stop_terminates(self, backend):
        # c9 asks to pause at 9 s but the run stops at 3 s: the pending
        # run-until must not leave the console blocked
        rc, sim, result = run_with_commands(make_cfg(backend), "c9")
        assert rc.pauses == 0
        assert result.log_tuples() == baseline(backend).log_tuples()

    def test_info_prints_hosts(self):
        out = io.StringIO()
        run_with_commands(make_cfg(), "p", "s", "c", out=out)
        text = out.getvalue()
        assert "host(s) with events in the next window" in text
        assert "a:" in text or "b:" in text


class TestRestart:
    @pytest.mark.parametrize("backend", BACKENDS)
    def test_restart_reruns_deterministically(self, backend):
        # restart at the first boundary, then run through: the result
        # equals an undisturbed run (determinism = replay)
        rc, sim, result = run_with_commands(make_cfg(backend), "r")
        assert sim.restarts == 1
        base = baseline(backend)
        assert result.log_tuples() == base.log_tuples()
        assert result.counters == base.counters
        assert result.rounds == base.rounds

    @pytest.mark.parametrize("backend", BACKENDS)
    def test_restart_to_time_pauses_then_resumes(self, backend):
        rc, sim, result = run_with_commands(make_cfg(backend), "r1", "c")
        assert sim.restarts == 1
        assert rc.pauses == 1  # paused once at ~1 s after the restart
        assert result.log_tuples() == baseline(backend).log_tuples()


class TestPerfLogging:
    def test_window_agg_lines_cpu(self, capsys):
        cfg = make_cfg(**{"experimental.perf_logging": True})
        Simulation(cfg).run(write_data=False)
        err = capsys.readouterr().err
        assert "[window-agg] active_hosts_in_window=" in err
        assert "window_start_ns=" in err

    def test_window_agg_lines_tpu_step(self, capsys):
        cfg = make_cfg("tpu", **{"experimental.perf_logging": True})
        result = Simulation(cfg, device="cpu").run(write_data=False)
        lines = [ln for ln in capsys.readouterr().err.splitlines()
                 if ln.startswith("[window-agg] active_hosts_in_window=")]
        assert len(lines) == result.rounds

    def test_host_exec_agg_threshold(self):
        out = io.StringIO()
        pl = PerfLog(out=out)
        for _ in range(PerfLog.HOST_EXEC_LOG_EVERY):
            pl.host_exec("h", 100, 10**9)
        text = out.getvalue()
        assert "[host-exec-agg] calls=1000" in text
        assert "host=h" in text

    @pytest.mark.parametrize("backend", BACKENDS)
    def test_parity_with_perf_logging_off(self, backend, capsys):
        base = baseline(backend)
        cfg = make_cfg(backend, **{"experimental.perf_logging": True})
        withperf = Simulation(cfg, device="cpu").run(write_data=False)
        assert base.log_tuples() == withperf.log_tuples()
        assert base.counters == withperf.counters


# -- [window-agg] lines against the reference's step driver ---------------------

WINDOW_AGG_CONFIGS = {
    "plain": lp_cfg.MESH,
    "tiered_stream": lp_cfg.STREAM_PAIR.replace("stop_time: 30s",
                                                "stop_time: 1s"),
    "faulted": lp_cfg.TGEN_FAULTED,
}


@pytest.mark.parametrize("name", sorted(WINDOW_AGG_CONFIGS))
def test_window_agg_lines_equal_the_reference_step_driver(name):
    yaml = WINDOW_AGG_CONFIGS[name]
    ref = TpuEngine(RefConfig.from_yaml(yaml))
    want = io.StringIO()
    ref.perf_log = RefPerfLog(out=want)
    ref_result = ref.run(mode="step")
    port = GpuEngine(ConfigOptions.from_yaml(yaml), device="cpu")
    got = io.StringIO()
    port.perf_log = PerfLog(out=got)
    windows = []
    result = port.run(mode="step",
                      on_window=lambda *w: windows.append(w))
    if name == "tiered_stream":
        assert port.params.stream_tiered
    if name == "faulted":
        assert port._fault_overlay is not None
    lines = got.getvalue().splitlines()
    assert lines == want.getvalue().splitlines()
    assert len(lines) == result.rounds == ref_result.rounds
    assert result.log_tuples() == ref_result.log_tuples()
    # on_window sees the same boundaries the lines print
    assert [PerfLog.format_window_agg(int(ln.split()[1].split("=")[1]),
                                      *w[:2], min(w[2], port.params.stop_time))
            for ln, w in zip(lines, windows)] == lines
