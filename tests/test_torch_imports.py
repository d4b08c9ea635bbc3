"""The PyTorch port stands alone: importing it (the probe scripts, the
checkpoint manager and the evaluation pipeline included), or chip_smoke.py,
pulls in no JAX, flax, optax or orbax and nothing of
soft_contrastive_learning_tpu, and no scikit-learn, OpenCV, PIL or
matplotlib (not dependencies of the port: a GPU host need not have them;
images are read and written by the port's own PNG codec); its kernels build
only from its own CUDA sources."""

import ast
import re
import subprocess
import sys
from pathlib import Path

import pytest

from soft_contrastive_learning_torch.ops.kernels import _build

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "soft_contrastive_learning_torch"
FORBIDDEN = ("jax", "flax", "optax", "orbax", "soft_contrastive_learning_tpu")
# not dependencies of the port: importing it must not load them (cv2 is
# imported inside the functions that resize or draw on an image, matplotlib
# inside the ones that plot)
NOT_DEPENDENCIES = ("sklearn", "cv2", "PIL", "matplotlib")


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


EVAL_SLICE = ("utils/io.py", "utils/experiments.py", "data/pipeline.py", "data/corpus.py",
              "evaluation/inference.py", "pca/whiten.py", "evaluation/topn.py",
              "evaluation/roc.py", "train/trainer.py", "cli.py",
              # the streaming PCAs and the heads
              "pca/incremental.py", "pca/async_updater.py", "losses/incremental.py",
              "models/heads.py", "train/mining_manager.py",
              # the int8-PTQ serving path: its HTTP upload decodes without OpenCV
              "models/quant.py", "ops/kernels/int8_conv.py", "flagship.py", "benchmark.py",
              "serving.py",
              # the training run's machinery: the train-loop benchmark, the decoded
              # cache, the TensorBoard export and the job launcher
              "bench_train.py", "data/decoded_cache.py", "core/tb_export.py",
              "core/logging.py", "launch/jobs.py", "launch/__init__.py",
              # multi-device data parallelism: the mesh, the ranks' launcher, the dryrun
              "parallel/mesh.py", "launch/multihost.py", "dryrun.py",
              # the prep pipeline, the parity harness, the packed stem
              "utils/cv.py", "utils/plot.py", "utils/sampling.py", "data/robotcar/stages.py",
              "data/robotcar/downsize.py", "data/robotcar/prep.py",
              "data/robotcar/analysis.py", "evaluation/parity.py", "ops/packed_stem.py")


@pytest.mark.parametrize("module", EVAL_SLICE)
def test_the_file_pipeline_imports_no_image_or_plot_library(module):
    """Each module of the files -> training and infer -> topn -> roc path,
    imported alone in a fresh interpreter, loads none of the libraries the
    card's machine lacks."""
    name = "soft_contrastive_learning_torch." + module.removesuffix(".py").replace("/", ".")
    code = (f"import importlib, sys\nimportlib.import_module({name!r})\n"
            f"bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN + NOT_DEPENDENCIES!r})\nassert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr


def test_prep_and_resize_run_where_opencv_sklearn_and_matplotlib_are_missing():
    """With sklearn, cv2 and matplotlib made unimportable, the prep
    pipeline, the parity harness and the packed stem import, and the image
    ops, the 1-D searches and the 2-means run."""
    code = (
        "import sys\n"
        "for m in ('sklearn', 'cv2', 'matplotlib'):\n"
        "    sys.modules[m] = None\n"
        "import numpy as np, torch\n"
        "from soft_contrastive_learning_torch import cli\n"
        "from soft_contrastive_learning_torch.data.robotcar import analysis, downsize, prep\n"
        "from soft_contrastive_learning_torch.evaluation import parity\n"
        "from soft_contrastive_learning_torch.ops import packed_stem\n"
        "from soft_contrastive_learning_torch.utils.cv import normalize_geometry\n"
        "raw = torch.randint(0, 256, (2, 12, 16), dtype=torch.uint8)\n"
        "small = downsize.downsize_batch(raw, 8)\n"
        "assert small.shape == (2, 6, 8, 3), small.shape\n"
        "img = np.zeros((90, 120, 3), np.uint8)\n"
        "assert normalize_geometry(img, 180, 240, keep_aspect=True).shape == (180, 240, 3)\n"
        "assert prep._two_means_1d(np.array([0., 1., 50., 51.]))[0].tolist() == [0, 0, 1, 1]\n"
        "assert prep._nearest_1d(np.arange(5.), np.array([2.2]), 2)[1].tolist() == [[2, 3]]\n"
        "assert prep._radius_neighbors(np.zeros((3, 2)), np.zeros((1, 2)), 1.0)[0].tolist() "
        "== [0, 1, 2]\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr


def test_every_kernel_source_exports_its_c_entry_points():
    names = _build.kernel_names()
    assert names == ["int8_conv", "jpeg", "netvlad", "probe_gemm", "topk", "winograd", "wms"]
    text = {n: (_build.SRC_DIR / f"{n}.cu").read_text() for n in names}
    assert 'extern "C"' in text["netvlad"] and "int scl_netvlad_aggregate(" in text["netvlad"]
    assert "int scl_topk_l2(" in text["topk"] and "int scl_topk_num_lists(" in text["topk"]
    # K2's products are its own: tf32 wgmma with A from registers, fed by TMA
    # (the query tiles multicast across the cluster), hi/lo split by bit masks
    assert "wgmma_m64n64k8_tf32_rs" in text["topk"] and "tma_load_2d" in text["topk"]
    assert "tma_load_3d_multicast" in text["topk"] and "0xffffe000u" in text["topk"]
    # K3 is one kernel; its only atomics count the grid barrier's and the
    # last block's arrivals (no float atomics: the same bits every run)
    assert "int scl_wms_loss(" in text["wms"] and text["wms"].count("__global__") == 1
    assert re.findall(r"atomic\w+\(([a-z_]+)", text["wms"]) == ["bar"] * 4
    assert "int scl_winograd_conv(" in text["winograd"] and "atomicAdd" not in text["winograd"]
    assert "int scl_winograd_weight_transform(" in text["winograd"]
    # K4's 16 products are its own: wgmma in the kernel body, fed by TMA (U
    # multicast across the cluster), and its input transform rounds in bf16
    # at every add
    assert "wgmma_m64n32k16" in text["winograd"] and "__hsub2" in text["winograd"]
    assert "tma_load_4d" in text["winograd"] and "tma_load_3d_multicast" in text["winograd"]
    sm90 = (_build.SRC_DIR / "sm90.cuh").read_text()
    assert "wgmma.mma_async" in sm90 and "cp.async.bulk.tensor" in sm90 and "mbarrier" in sm90
    assert not any(lib in text["winograd"] for lib in ("cublas", "cudnn", "cutlass"))
    # the Winograd stages are instantiations of K4's own kernel, not a second one
    assert "int scl_winograd_stage(" in text["winograd"]
    assert text["winograd"].count("__global__") == 2  # the weight transform and K4
    assert "if constexpr (STAGE" in text["winograd"]
    # the probes' product is the kernels' own: bf16 and int8 on wgmma fed by
    # TMA, int8 after the kernel's own transpose of B
    gemm = text["probe_gemm"]
    assert "int scl_probe_gemm(" in gemm and "wgmma_m64n256k32_s8" in gemm
    assert "transpose_kernel" in gemm and "mma_sync" not in gemm and "cp.async" not in gemm
    assert "wgmma_m64n256k16" in gemm and "tma_load_3d" in gemm and "setmaxnreg" in gemm
    assert "signed char" in gemm and "__nv_bfloat16" in gemm
    assert not any(lib in t.lower() for t in (gemm, sm90) for lib in ("cublas", "cudnn", "cutlass",
                                                                       "torch"))
    assert all("scl_cuda_error_string" in t for t in text.values())
    # Q1's int8 conv is its own: a persistent implicit GEMM on integer wgmma,
    # the input gathered tap by tap as 4-D TMA boxes (no im2col), the output
    # stored by TMA; Q1_stem (the same kernel with the stem's producer) and
    # Q1_pool beside it
    q1 = text["int8_conv"]
    assert "int scl_int8_conv(" in q1 and "int scl_int8_pool(" in q1
    assert "int scl_int8_stem(" in q1 and "int scl_int8_stem_config(" in q1
    assert "wgmma_m64n256k32_s8" in q1 and "tma_load_4d" in q1 and "setmaxnreg" in q1
    assert "tma_store_4d" in q1 and "gridDim.x" in q1
    assert "rintf" in q1 and "__fmul_rn" in q1 and "__fadd_rn" in q1 and "__fsub_rn" in q1
    assert "roundf" not in q1
    assert q1.count("__global__") == 2 and "mma_sync" not in q1
    assert not any(lib in q1.lower() for lib in ("cublas", "cudnn", "cutlass", "torch"))
    # J1 is its own: one fused kernel over a batch (two instantiations, with
    # and without the block smoothing), and the entropy decoder beside it is
    # host C++ of the same library; no nvJPEG
    j1 = text["jpeg"]
    assert "int scl_jpeg_pixels(" in j1 and "int scl_jpeg_entropy(" in j1
    assert "int scl_jpeg_info(" in j1 and j1.count("__global__") == 1
    assert set(re.findall(r"#include <([\w./]+)>", j1)) <= {
        "stdint.h", "stdio.h", "string.h", "algorithm", "string", "cuda_runtime.h"}


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
