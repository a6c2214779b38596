"""The port stands alone: no JAX, no shadow_tpu, no silent CPU fallback."""

import ast
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import shadow_tpu_torch
from shadow_tpu_torch.backend import kernels, lanes
from shadow_tpu_torch.backend.gpu_engine import GpuEngine
from shadow_tpu_torch.config.presets import flagship_mesh_config

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "shadow_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: p.name)
def test_no_jax_or_reference_import(path):
    for mod in _imports(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "shadow_tpu"), f"{path}: {mod}"


def test_import_leaves_jax_unloaded():
    code = (
        "import sys\n"
        "import shadow_tpu_torch.backend.gpu_engine, shadow_tpu_torch.backend.kernels\n"
        "import shadow_tpu_torch.backend.bridge, shadow_tpu_torch.config.presets\n"
        "import shadow_tpu_torch.faults.overlay, shadow_tpu_torch.sweep\n"
        "import shadow_tpu_torch.backend.hybrid, shadow_tpu_torch.config.scenarios\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'shadow_tpu', 'yaml')]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120)


def test_no_card_means_an_error(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GpuEngine(flagship_mesh_config(4, sim_seconds=1))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        shadow_tpu_torch.default_device("cuda")
    assert shadow_tpu_torch.default_device("cpu").type == "cpu"


def test_cpu_tensors_take_the_plain_path_and_count_no_launch():
    eng = GpuEngine(flagship_mesh_config(8, sim_seconds=1), log_capacity=64,
                    device="cpu")
    p, tb = eng.params, eng.tables
    s_w, s_p = eng.initial_state(), eng.initial_state()
    ws_w, ws_p = lanes.make_workspace(p, "cpu"), lanes.make_workspace(p, "cpu")
    args = kernels.LaneArgs(p, tb, s_w, ws_w)
    assert not args.on_cuda
    kernels.reset_launches()
    for _ in range(3):
        kernels.queue_min_window(args, True)
        kernels.lane_slots(args)
        kernels.exchange_merge(args)
        kernels.append_log(args)
        lanes.queue_min_window_plain(p, s_p, ws_p, True)
        lanes.lane_slots_plain(p, tb, s_p, ws_p)
        lanes.exchange_merge_plain(p, tb, s_p, ws_p)
        lanes.append_log_plain(p, s_p, ws_p)
    assert all(fn.launches == 0 for fn in kernels.WRAPPERS)
    for f in lanes.LaneState._fields:
        assert torch.equal(getattr(s_w, f), getattr(s_p, f)), f
    assert int(s_w.iters) == 3


def test_kernel_argument_block_matches_the_cuda_struct():
    """ctypes builds the [S] array of LaneBufs blocks that the kernels
    index by scenario: its fields must be the CUDA struct's, in the same
    order, and its element size the struct's (every field a pointer or an
    int64, eight bytes, so neither side pads).  Up to PARAM_SCENARIOS of
    them go in one kernel parameter, which Hopper caps at 32,764 bytes."""
    import ctypes

    src = (ROOT / "shadow_tpu_torch" / "csrc" / "lanes.cu").read_text()
    body = re.search(r"struct LaneBufs \{(.*?)\};", src, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    names = re.findall(r"\*?\s*(\w+)\s*[,;]", body)
    assert names == [f for f, _t in kernels.LaneBufs._fields_]
    for decl in filter(str.strip, body.split(";")):
        ctype, _, rest = decl.strip().partition(" ")
        for name in rest.split(","):
            assert name.strip().startswith("*") or ctype == "int64_t", decl
    size = ctypes.sizeof(kernels.LaneBufs)
    assert size == 8 * len(names)
    assert ctypes.sizeof(kernels.LaneBufs * 3) == 3 * size
    few = int(re.search(r"constexpr int PARAM_SCENARIOS = (\d+);",
                        src).group(1))
    assert few >= 2 and few * size <= 32_764


def test_wrappers_check_their_tensors():
    eng = GpuEngine(flagship_mesh_config(8, sim_seconds=1), device="cpu")
    p = eng.params
    s = eng.initial_state()
    with pytest.raises(ValueError, match="q_size"):
        kernels.LaneArgs(p, eng.tables, s._replace(q_size=s.q_size.T),
                         lanes.make_workspace(p, "cpu"))
    with pytest.raises(ValueError, match="send_seq"):
        kernels.LaneArgs(p, eng.tables, s._replace(send_seq=s.send_seq.long()),
                         lanes.make_workspace(p, "cpu"))
