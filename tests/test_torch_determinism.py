"""Run-twice determinism and the async logger on the port: the twins of
the lane cases of ``tests/test_determinism.py`` and of
``tests/test_shadow_log.py``.

``determinism_check`` runs a config twice in fresh engines (the lane
engine's device loop with ``device="cpu"``, the cpu backend's
``CpuEngine``, the hybrid engine for managed binaries) and compares the
canonical event logs and the counters; the CLI's ``--determinism-check``
exits 0 only when they are equal.  The async logger queues records on the
emitting thread, writes them from a listener thread with the simulated
clock as a prefix, and drains on shutdown.
"""

import io
import logging
import logging.handlers
import subprocess
import sys
import threading
from pathlib import Path

import pytest

import test_determinism as det_cfg
from shadow_tpu.backend.cpu_engine import CpuEngine as RefCpuEngine
from shadow_tpu.config.options import ConfigOptions as RefConfig
from shadow_tpu_torch.backend.cpu_engine import CpuEngine
from shadow_tpu_torch.backend.gpu_engine import GpuEngine
from shadow_tpu_torch.config.options import ConfigOptions
from shadow_tpu_torch.engine.determinism import (
    compare_results,
    determinism_check,
)
from shadow_tpu_torch.utils import shadow_log

REPO = Path(__file__).resolve().parents[1]
PHOLD = det_cfg.PHOLD
PHOLD_FAULTED = det_cfg.PHOLD_FAULTED


def _tpu(yaml: str) -> ConfigOptions:
    cfg = ConfigOptions.from_yaml(yaml)
    cfg.experimental.network_backend = "tpu"
    return cfg


def test_phold_cpu_run_twice_identical():
    report = determinism_check(ConfigOptions.from_yaml(PHOLD))
    assert report.identical, report.describe()
    assert report.records > 50
    assert "PASSED" in report.describe()


def test_phold_tpu_run_twice_identical():
    report = determinism_check(_tpu(PHOLD), device="cpu")
    assert report.identical, report.describe()
    # the same records the reference logs (its CPU oracle, whose log its
    # lane engine's equals: tests/test_lane_parity.py)
    ref = RefCpuEngine(RefConfig.from_yaml(PHOLD)).run()
    assert report.records == len(ref.event_log) > 50


def test_phold_faulted_tpu_run_twice_identical():
    report = determinism_check(_tpu(PHOLD_FAULTED), device="cpu")
    assert report.identical, report.describe()
    assert report.records > 20


@pytest.mark.parametrize("backend", ["cpu", "tpu"])
def test_seed_changes_the_run(backend):
    cfg1, cfg2 = ConfigOptions.from_yaml(PHOLD), ConfigOptions.from_yaml(PHOLD)
    cfg2.general.seed = 14
    if backend == "cpu":
        r1, r2 = CpuEngine(cfg1).run(), CpuEngine(cfg2).run()
    else:
        r1 = GpuEngine(cfg1, device="cpu").run()
        r2 = GpuEngine(cfg2, device="cpu").run()
    report = compare_results(r1, r2)
    assert not report.identical
    assert "FAILED" in report.describe()
    assert report.first_diff_index is not None


def test_parallelism_does_not_change_the_run():
    # the reference's determinism1 runs with --parallelism 2; ordering must
    # not depend on the worker count
    cfg1, cfg2 = ConfigOptions.from_yaml(PHOLD), ConfigOptions.from_yaml(PHOLD)
    cfg2.general.parallelism = 2
    report = compare_results(CpuEngine(cfg1).run(), CpuEngine(cfg2).run())
    assert report.identical, report.describe()


def test_step_and_device_mode_compare_identical():
    step = GpuEngine(_tpu(PHOLD), device="cpu").run(mode="step")
    dev = GpuEngine(_tpu(PHOLD), device="cpu").run(mode="device")
    report = compare_results(step, dev)
    assert report.identical, report.describe()


def test_cli_determinism_check(tmp_path):
    cfg_path = tmp_path / "phold.yaml"
    cfg_path.write_text(PHOLD.replace("general: {",
                                      "general: {data_directory: "
                                      f"{tmp_path / 'data'}, "))
    proc = subprocess.run(
        [sys.executable, "-m", "shadow_tpu_torch", str(cfg_path),
         "--determinism-check", "--network-backend", "tpu",
         "--device", "cpu"],
        capture_output=True, text=True, cwd=REPO, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert "determinism check PASSED" in proc.stderr


def test_managed_native_run_twice_identical(tmp_path):
    subprocess.run(["make", "-C", str(REPO / "native")], check=True,
                   capture_output=True)
    build = REPO / "native" / "build"
    cfg = ConfigOptions.from_yaml(f"""
general: {{stop_time: 2s, seed: 21, data_directory: {tmp_path / 'data'}, heartbeat_interval: null}}
network: {{graph: {{type: 1_gbit_switch}}}}
experimental: {{network_backend: tpu, hybrid_fuse_k: 1}}
hosts:
  cli:
    network_node_id: 0
    processes:
      - path: {build / 'pingpong'}
        args: [client, 11.0.0.2, "9000", "4", "100"]
  srv:
    network_node_id: 0
    processes:
      - path: {build / 'pingpong'}
        args: [server, "9000", "4"]
""")
    report = determinism_check(cfg, device="cpu")
    assert report.identical, report.describe()
    assert report.records > 0


# -- the async logger (tests/test_shadow_log.py) -------------------------------


def _fresh(buf):
    return shadow_log.install_async_logging(logging.INFO, stream=buf)


def test_async_emission_and_flush():
    buf = io.StringIO()
    _fresh(buf)
    try:
        log = logging.getLogger("shadow_tpu_torch.test")
        # emission does no I/O on the caller: the root handler is a
        # QueueHandler, not a StreamHandler
        root = logging.getLogger()
        assert len(root.handlers) == 1
        assert isinstance(root.handlers[0], logging.handlers.QueueHandler)
        for i in range(100):
            log.info("line %d", i)
    finally:
        shadow_log.shutdown()  # drains
    out = buf.getvalue()
    assert out.count("line ") == 100
    assert "line 99" in out


def test_sim_time_prefix():
    buf = io.StringIO()
    _fresh(buf)
    try:
        shadow_log.set_sim_time_provider(lambda: 1_500_000_000)
        logging.getLogger("shadow_tpu_torch.test").info("stamped")
    finally:
        shadow_log.shutdown()
        shadow_log.set_sim_time_provider(None)
    assert "[1.500000000s]" in buf.getvalue()


def test_multithreaded_emission_complete():
    buf = io.StringIO()
    _fresh(buf)
    try:
        log = logging.getLogger("shadow_tpu_torch.test")

        def worker(k):
            for i in range(50):
                log.info("w%d-%d", k, i)

        ts = [threading.Thread(target=worker, args=(k,)) for k in range(4)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
    finally:
        shadow_log.shutdown()
    assert buf.getvalue().count("w") >= 200


def test_install_is_idempotent():
    b1, b2 = io.StringIO(), io.StringIO()
    _fresh(b1)
    logging.getLogger("shadow_tpu_torch.test").info("first")
    _fresh(b2)  # replaces, flushing the first listener
    try:
        logging.getLogger("shadow_tpu_torch.test").info("second")
    finally:
        shadow_log.shutdown()
    assert "first" in b1.getvalue()
    assert "second" in b2.getvalue()
    assert len(logging.getLogger().handlers) <= 1
