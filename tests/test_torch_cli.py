"""The port's command line against the JAX package's ``Simulation``.

``python -m shadow_tpu_torch --device cpu`` runs a config end to end: the
data directory it writes (``sim-stats.json`` but its wall-clock fields,
``hosts/*/counters.json``, ``event-log.tsv``) equals byte for byte what
the reference's facade writes for the same config — a tgen mesh and a
tiered stream pair on the lane backend, and a ping pair on the cpu
backend (the one that writes per-host counters).  Then the twins of the
lane cases of ``tests/test_cli.py``: stdin and overrides, the config
errors (exit 2, the settings of ROADMAP items 11, 12 and 14 among them),
the run-twice diff, the facade on both backends, and no card without
``--device cpu``.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

import test_lane_parity as lp_cfg
from shadow_tpu.config.options import ConfigOptions as RefConfig
from shadow_tpu.engine.sim import Simulation as RefSimulation
from shadow_tpu_torch.__main__ import main
from shadow_tpu_torch.config.options import ConfigOptions
from shadow_tpu_torch.engine.sim import Simulation

REPO = Path(__file__).resolve().parents[1]

PING_YAML = """
general: {stop_time: 2s, seed: 5, data_directory: DATADIR}
network: {graph: {type: 1_gbit_switch}}
hosts:
  cli: {network_node_id: 0, processes: [{path: ping, args: [--peer, srv, --count, "4", --interval, 250ms]}]}
  srv: {network_node_id: 0, processes: [{path: ping}]}
"""

# the lane configs of tests/test_lane_parity.py, on the lane backend: a
# tgen mesh, and a stream pair (one-to-one: the tiered pass) cut to 1 s
CONFIGS = {
    "tgen_mesh": lp_cfg.MESH.replace(
        "general: {", "general: {data_directory: DATADIR, ").replace(
        "hosts:", "experimental: {network_backend: tpu}\nhosts:"),
    "tiered_stream": lp_cfg.STREAM_PAIR.replace(
        "stop_time: 30s", "stop_time: 1s, data_directory: DATADIR").replace(
        "experimental: {", "experimental: {network_backend: tpu, "),
    "ping_cpu": PING_YAML,
}

WALL_FIELDS = ("wall_seconds", "total_wall_seconds",
               "sim_seconds_per_wall_second")


def _run_cli(args, **kw):
    return subprocess.run(
        [sys.executable, "-m", "shadow_tpu_torch", *args],
        cwd=REPO, capture_output=True, text=True, timeout=300, **kw)


def _data_files(d: Path) -> dict:
    stats = json.loads((d / "sim-stats.json").read_text())
    for k in WALL_FIELDS:
        stats.pop(k)
    hosts = {p.relative_to(d).as_posix(): p.read_bytes()
             for p in sorted((d / "hosts").glob("*/counters.json"))}
    return {"stats": stats, "hosts": hosts,
            "event_log": (d / "event-log.tsv").read_bytes()}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_cli_writes_what_the_reference_writes(name, tmp_path):
    yaml = CONFIGS[name]
    ref_dir, port_dir = tmp_path / "ref", tmp_path / "port"
    sim = RefSimulation(RefConfig.from_yaml(yaml.replace("DATADIR",
                                                         str(ref_dir))))
    sim.write_event_log(sim.run())
    cfg_path = tmp_path / "sim.yaml"
    cfg_path.write_text(yaml.replace("DATADIR", str(port_dir)))
    proc = _run_cli([str(cfg_path), "--event-log", "--device", "cpu"])
    assert proc.returncode == 0, proc.stderr
    assert f"event log: {port_dir / 'event-log.tsv'}" in proc.stderr
    want, got = _data_files(ref_dir), _data_files(port_dir)
    assert got == want
    assert got["event_log"].count(b"\n") > 8
    assert bool(got["hosts"]) == (name == "ping_cpu")


def test_cli_stdin_and_overrides(tmp_path):
    proc = _run_cli(
        ["-", "--seed", "9", "--data-directory", str(tmp_path / "d2"),
         "--set", "general.stop_time=1s", "--set",
         "experimental.network_backend=tpu", "--perf-logging",
         "--show-config"],
        input=PING_YAML.replace("DATADIR", str(tmp_path / "ignored")),
    )
    assert proc.returncode == 0, proc.stderr
    doc = json.loads(proc.stdout)
    assert doc["general"]["seed"] == 9
    assert doc["general"]["data_directory"] == str(tmp_path / "d2")
    assert doc["general"]["stop_time"] == 10**9
    assert doc["experimental"]["network_backend"] == "tpu"
    assert doc["experimental"]["perf_logging"] is True


def test_cli_config_error_exit_code(tmp_path, capsys):
    bad = tmp_path / "bad.yaml"
    bad.write_text("general: {stop_time: 1s}\nnope: {}\n")
    assert main([str(bad)]) == 2
    assert "config error" in capsys.readouterr().err
    assert main([str(tmp_path / "missing.yaml")]) == 2


@pytest.mark.parametrize("flags,item", [
    (["--resume", "ckpt.bin"], "item 11"),
    (["--checkpoint-every-windows", "5"], "item 11"),
    (["--checkpoint-dir", "ckpts"], "item 11"),
    (["--tpu-mesh-shape", "2"], "item 14"),
    (["--set", "experimental.mesh_devices=2"], "item 14"),
    (["--obs-turns"], "item 12"),
])
def test_cli_refuses_later_items_with_exit_code_2(flags, item, tmp_path,
                                                  capsys):
    cfg = tmp_path / "sim.yaml"
    cfg.write_text(PING_YAML.replace("DATADIR", str(tmp_path / "d")))
    assert main([str(cfg), *flags, "--device", "cpu"]) == 2
    err = capsys.readouterr().err
    assert "config error" in err and item in err
    assert not (tmp_path / "d").exists()


def test_cli_without_a_card_exits_nonzero(tmp_path):
    """No ``--device cpu`` and no card: the error of ``default_device``,
    and no run on the CPU instead."""
    cfg = tmp_path / "sim.yaml"
    cfg.write_text(PING_YAML.replace("DATADIR", str(tmp_path / "d")))
    proc = _run_cli([str(cfg)], env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode == 1
    assert "no CUDA device available" in proc.stderr
    assert not (tmp_path / "d").exists()


@pytest.mark.parametrize("backend", ["cpu", "tpu"])
def test_run_twice_bit_identical(tmp_path, backend):
    """determinism1: same config, two full runs, identical event logs."""
    yaml = PING_YAML.replace("DATADIR", str(tmp_path / "d"))
    logs = []
    for _ in range(2):
        cfg = ConfigOptions.from_yaml(yaml)
        cfg.experimental.network_backend = backend
        sim = Simulation(cfg, device="cpu")
        logs.append(sim.run(write_data=False).log_tuples())
    assert logs[0] == logs[1]
    assert len(logs[0]) == 8


@pytest.mark.parametrize("backend", ["cpu", "tpu"])
def test_simulation_facade_backends(tmp_path, backend):
    yaml = PING_YAML.replace("DATADIR", str(tmp_path / backend))
    cfg = ConfigOptions.from_yaml(yaml)
    cfg.experimental.network_backend = backend
    result = Simulation(cfg, device="cpu").run()
    stats = json.loads((tmp_path / backend / "sim-stats.json").read_text())
    assert stats["backend"] == backend
    assert stats["packet_outcomes"]["delivered"] == 8
    assert result.rounds > 0


def test_config_file_reader(tmp_path):
    """from_yaml_file reads a config file: block YAML and YAML's JSON (flow)
    form, as chip_smoke.py writes its configs, give the same options."""
    doc = {"general": {"stop_time": "2s", "seed": 5},
           "hosts": {"cli": {"processes": [{"path": "ping", "args": [
               "--peer", "srv", "--count", "4"]}]},
                     "srv": {"processes": [{"path": "ping"}]}}}
    want = ConfigOptions.from_dict(doc)
    flow = tmp_path / "flow.yaml"
    flow.write_text(json.dumps(doc, indent=1))
    assert ConfigOptions.from_yaml_file(flow) == want
    block = tmp_path / "block.yaml"
    block.write_text(PING_YAML.replace("DATADIR", str(tmp_path / "d")))
    assert (ConfigOptions.from_yaml_file(block)
            == ConfigOptions.from_yaml(block.read_text()))


def test_cli_sigterm_stops_at_a_window_boundary(tmp_path):
    """The first SIGTERM stops the run at the next window boundary: exit
    75, no data written."""
    import signal

    cfg = tmp_path / "sim.yaml"
    cfg.write_text(PING_YAML.replace("DATADIR", str(tmp_path / "d")).replace(
        "stop_time: 2s", "stop_time: 600s").replace(
        '"4", --interval, 250ms', '"1000000", --interval, 1ms'))
    proc = subprocess.Popen(
        [sys.executable, "-m", "shadow_tpu_torch", str(cfg), "--device",
         "cpu"], cwd=REPO, stderr=subprocess.PIPE, text=True)
    try:
        for line in proc.stderr:
            if "heartbeat:" in line:
                break
        proc.send_signal(signal.SIGTERM)
        err = proc.stderr.read()
        assert proc.wait(timeout=120) == 75
    finally:
        if proc.poll() is None:
            proc.kill()
    assert "graceful shutdown (signal 15)" in err
    assert not (tmp_path / "d" / "sim-stats.json").exists()
