"""The port's multiprocess hybrid engine against the CPU oracles.

Twins of ``tests/test_hybrid_mp.py``: the managed hosts' syscall plane
runs in spawned worker processes (``MpHybridEngine``, ``device="cpu"``:
the kernels' plain versions in the parent) while their packets ride the
lanes, and the event log, counters and rounds equal the all-host-side CPU
oracle of both packages.  The workers never touch a GPU
(``CUDA_VISIBLE_DEVICES`` is empty in them).  Only the 2-worker case runs
in the tier-1 selection; the rest of the {1, 2, 4} matrix spawns five
more processes and is marked ``slow``, as the reference's is.
"""

import subprocess
from pathlib import Path

import pytest

from shadow_tpu.backend.cpu_engine import CpuEngine as RefCpu
from shadow_tpu.config.options import ConfigOptions as RefConfig
from shadow_tpu_torch.backend.cpu_engine import CpuEngine
from shadow_tpu_torch.backend.hybrid import (HybridEngine, MpHybridEngine,
                                             make_hybrid_engine)
from shadow_tpu_torch.config.options import ConfigOptions

REPO = Path(__file__).resolve().parents[1]
BUILD = REPO / "native" / "build"


@pytest.fixture(scope="module", autouse=True)
def native_build():
    subprocess.run(["make", "-C", str(REPO / "native")], check=True,
                   capture_output=True)


def _mixed_yaml(d: Path, backend: str, workers: int = 1) -> str:
    """tests/test_hybrid_mp.py's _mixed_config: a managed pingpong pair and
    a managed tcpecho pair (four managed hosts: every worker count in {1,
    2, 4} gets a partition) over four tgen-mesh lanes, at the defaults
    (the fused law, eager dispatch on)."""
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
experimental: {{network_backend: {backend}, hybrid_workers: {workers}}}
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


COUNTER_KEYS = ("udp_tx_bytes", "udp_rx_bytes", "managed_exit_clean",
                "managed_tcp_rx_bytes", "tgen_recv_bytes")


@pytest.fixture(scope="module")
def oracles(tmp_path_factory):
    d = tmp_path_factory.mktemp("hybrid_mp_oracle")
    port = CpuEngine(ConfigOptions.from_yaml(_mixed_yaml(d / "p", "cpu"))).run()
    ref = RefCpu(RefConfig.from_yaml(_mixed_yaml(d / "r", "cpu"))).run()
    for r in (port, ref):
        assert not r.process_errors, r.process_errors
    assert port.log_tuples() == ref.log_tuples()
    return port, ref


def _run(d: Path, workers: int):
    eng = make_hybrid_engine(
        ConfigOptions.from_yaml(_mixed_yaml(d, "tpu", workers)), device="cpu")
    return eng.run(), eng


def _assert_matches(r, oracle):
    assert r.log_tuples() == oracle.log_tuples()
    assert not r.process_errors, r.process_errors
    for key in COUNTER_KEYS:
        assert r.counters.get(key) == oracle.counters.get(key), key
    assert r.rounds == oracle.rounds


def test_hybrid_mp_parity_with_cpu_oracle(tmp_path, oracles):
    """The 2-worker engine equals both packages' CPU oracles, and its
    transfer counts show the batched boundary (one packed readback per
    device turn, coalesced injection blocks)."""
    r, eng = _run(tmp_path / "w2", 2)
    assert isinstance(eng, MpHybridEngine)
    assert eng.workers == 2 and len(eng.worker_pids) == 2
    for oracle in oracles:
        _assert_matches(r, oracle)
    s = eng.sync_stats
    assert s["device_turns"] > 0
    assert s["scalar_reads"] == s["device_turns"]
    assert s["inject_rows"] > 0 and s["egress_rows"] > 0
    assert s["device_sync_s"] > 0 and s["syscall_service_s"] > 0
    assert s["inject_blocks"] <= s["device_turns"]
    assert s["fused_dispatches"] > 0


@pytest.mark.slow
@pytest.mark.parametrize("workers", [1, 4])
def test_hybrid_mp_worker_matrix(tmp_path, oracles, workers):
    """The rest of the {1, 2, 4} matrix: workers 1 is the serial engine in
    process, 4 spawns four workers; both equal the oracles."""
    r, eng = _run(tmp_path / f"w{workers}", workers)
    if workers == 1:
        assert type(eng) is HybridEngine
    else:
        assert isinstance(eng, MpHybridEngine) and eng.workers == workers
    for oracle in oracles:
        _assert_matches(r, oracle)
