"""Boundaries of the torch port: it stands alone, and runs on the card
unless asked for the CPU.

  * no file of the port (nor chip_smoke.py) imports jax, flax or the JAX
    package, and importing the port leaves jax out of sys.modules
  * entry points without an explicit device raise when there is no card
  * kernel wrappers given a tensor they must run on the card launch the
    kernel or raise; they never fall back to the plain version
"""

import ast
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import embodied_object_detection_tpu_torch as port
from embodied_object_detection_tpu_torch.kernels import build
from embodied_object_detection_tpu_torch.models import detector
from embodied_object_detection_tpu_torch.ops import memory_ops, segment_sum

REPO = Path(__file__).resolve().parents[1]
PORT_DIR = Path(port.__file__).parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "embodied_object_detection_tpu")


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _port_sources():
    return sorted(PORT_DIR.rglob("*.py")) + [REPO / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_port_file_imports_nothing_of_jax(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path} imports {bad}"
    text = path.read_text()
    for needle in ("import jax", "from jax", "flax"):
        assert needle not in text, f"{path} mentions {needle!r}"


def test_import_leaves_jax_unloaded():
    """Every port module imports without JAX, and without h5py, PIL or
    cv2, which the data layer and the demos import where they read h5,
    JPEG or video files or draw (the card's machine has no h5py),
    and without triton or nvcc: no module imports triton or builds a
    kernel when it is imported (the Deformable-DETR family's too)."""
    modules = [m.name for m in pkgutil.walk_packages(
        [str(PORT_DIR)], prefix="embodied_object_detection_tpu_torch.")]
    serving = {f"embodied_object_detection_tpu_torch.{m}" for m in (
        "geometry", "geometry.projector", "data.catalog", "demo.visualizer",
        "demo.predictor", "demo.demo", "demo.predict_api",
        "demo.robot_demo", "serve", "serve.server", "serve.export")}
    assert serving <= set(modules), serving - set(modules)
    detr = {f"embodied_object_detection_tpu_torch.{m}" for m in (
        "ops.deform_conv", "ops.ms_deform_attn", "models.deformable_detr")}
    assert detr <= set(modules), detr - set(modules)
    code = ("import importlib, sys\n"
            f"for m in {modules!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}]\n"
            "assert not bad, bad\n"
            "lazy = [m for m in sys.modules if m.split('.')[0] in "
            "('h5py', 'PIL', 'cv2')]\n"
            "assert not lazy, lazy\n"
            "assert 'triton' not in sys.modules\n"
            "from embodied_object_detection_tpu_torch.kernels import build\n"
            "assert build.load.cache_info().currsize == 0\n"
            "print(len(sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert len(modules) >= 25


def test_build_detector_without_device_raises_without_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        detector.build_detector(port.config.DetectorConfig())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        detector.resolve_device("cuda")
    assert detector.resolve_device("cpu").type == "cpu"


def _forbid_plain(monkeypatch, module, name):
    def plain(*args, **kwargs):
        raise AssertionError(f"{name} fell back to its plain version")
    monkeypatch.setattr(module, name, plain)


def test_segment_sum_wrapper_raises_instead_of_falling_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(build, "on_card", lambda t: True)
    _forbid_plain(monkeypatch, segment_sum, "segment_sum_plain")
    before = segment_sum.segment_sum.launches
    w = torch.ones((8, 3))
    idx = torch.zeros((8,), dtype=torch.int32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        segment_sum.segment_sum(w, idx, 4)
    assert segment_sum.segment_sum.launches == before


def test_memory_read_wrapper_raises_instead_of_falling_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(build, "on_card", lambda t: True)
    _forbid_plain(monkeypatch, memory_ops, "memory_read_plain")
    before = memory_ops.memory_read.launches
    feats = torch.ones((16, 8))
    obs = torch.ones((16,))
    proj = torch.zeros((8, 8), dtype=torch.int32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        memory_ops.memory_read(feats, obs, proj)
    assert memory_ops.memory_read.launches == before


@pytest.mark.parametrize("bad", ["w_dtype", "idx_dtype", "idx_shape"])
def test_segment_sum_wrapper_checks_inputs_before_launch(monkeypatch, bad):
    monkeypatch.setattr(build, "on_card", lambda t: True)
    w = torch.ones((8, 3), dtype=torch.float64 if bad == "w_dtype"
                   else torch.float32)
    idx = torch.zeros((7 if bad == "idx_shape" else 8,),
                      dtype=torch.int64 if bad == "idx_dtype"
                      else torch.int32)
    with pytest.raises(ValueError, match="segment_sum"):
        segment_sum.segment_sum(w, idx, 4)


def test_cpu_tensors_take_the_plain_versions():
    assert build.on_card(torch.zeros(1)) is False
    w = torch.ones((4, 2))
    idx = torch.tensor([0, 1, 1, -1], dtype=torch.int32)
    before = segment_sum.segment_sum.launches
    out = segment_sum.segment_sum(w, idx, 2)
    assert out.tolist() == [[1.0, 1.0], [2.0, 2.0]]
    assert segment_sum.segment_sum.launches == before


def test_kernel_sources_and_flags():
    for name in build.ENTRY_POINTS:
        src = (build.CSRC / f"{build.source(name)}.cu").read_text()
        assert f'extern "C" int {build.ENTRY_POINTS[name][0]}(' in src
        assert "torch/extension.h" not in src
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    assert build.library_path("segment_sum").parent == build.BUILD_DIR
    # one library a source: the ROIAlign backward is a second symbol of
    # the forward's
    assert build.library_path("roi_align_backward") == \
        build.library_path("roi_align")
    assert sorted(p.stem for p in build.CSRC.glob("*.cu")) == sorted(
        set(map(build.source, build.ENTRY_POINTS)))
