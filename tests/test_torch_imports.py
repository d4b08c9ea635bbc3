"""The PyTorch port stands alone: importing it, or chip_smoke.py, pulls in no
JAX and nothing of soft_contrastive_learning_tpu, and no scikit-learn or
OpenCV (not dependencies of the port: a GPU host need not have them); its
kernels build only from its own CUDA sources."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

from soft_contrastive_learning_torch.ops.kernels import _build

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "soft_contrastive_learning_torch"
FORBIDDEN = ("jax", "flax", "optax", "soft_contrastive_learning_tpu")
# not dependencies of the port: importing it must not load them (cv2
# is imported inside the few functions that decode or resize an image)
NOT_DEPENDENCIES = ("sklearn", "cv2")


def _port_sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_importing_the_port_pulls_in_no_jax():
    modules = [
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
        for p in sorted(PORT.rglob("*.py"))
    ]
    code = (
        "import importlib, sys\n"
        f"for m in {modules + ['chip_smoke']!r}:\n"
        "    importlib.import_module(m)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN + NOT_DEPENDENCIES!r})\n"
        "print(len(sys.modules)); assert not bad, bad\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_source_imports_jax_or_the_jax_package(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, f"{path}: imports {name}"


def test_every_kernel_source_exports_its_c_entry_points():
    names = _build.kernel_names()
    assert names == ["netvlad", "topk", "wms"]
    text = {n: (_build.SRC_DIR / f"{n}.cu").read_text() for n in names}
    assert 'extern "C"' in text["netvlad"] and "int scl_netvlad_aggregate(" in text["netvlad"]
    assert "int scl_topk_l2(" in text["topk"] and "scl_topk_chunk_rows" in text["topk"]
    assert "int scl_wms_loss(" in text["wms"] and "atomicAdd" not in text["wms"]
    assert all("scl_cuda_error_string" in t for t in text.values())


def test_build_targets_hopper_and_stays_in_the_checkout():
    flags = " ".join(_build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags and "-O3" in flags and "-shared" in flags
    assert _build.BUILD_DIR == PORT / "_build"
    assert "soft_contrastive_learning_torch/_build/" in (ROOT / ".gitignore").read_text()
    path = _build.library_path("topk")
    assert path.parent == _build.BUILD_DIR and path.name.startswith("topk-")


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "library_path", lambda name: tmp_path / f"{name}.so")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()
