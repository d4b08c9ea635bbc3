"""The port's parity harness (``evaluation/parity.py``, ``cli parity``)
against the JAX package's on the same synthetic TF1-named export and
images (the JAX test's fixtures): descriptors within 1e-5 (two fp32 conv
stacks summing in other orders), the same report, the golden pass and
fail paths, and the CLI's exit codes."""

import os

import numpy as np
import pytest
import torch

from soft_contrastive_learning_torch.cli import main as cli_main
from soft_contrastive_learning_torch.core.config import ModelConfig
from soft_contrastive_learning_torch.evaluation.parity import compare_descriptors, run_parity
from soft_contrastive_learning_torch.utils.io import save_img
from soft_contrastive_learning_tpu.core.config import ModelConfig as JaxModelConfig
from soft_contrastive_learning_tpu.evaluation.parity import run_parity as jax_run_parity

torch.set_num_threads(1)  # tier-1 runs several workers on one host

SCOPE = "vgg16_netvlad_pca"
COMMON = dict(vlad_cores=4, reduction="none", image_height=32, image_width=48,
              compute_dtype="float32")


def _fake_tf1_npz(path, rng, vlad_cores):
    """A TF1-style variable export with the reference's names (the JAX
    test's ``_fake_tf1_npz``)."""
    tf_vars = {f"{SCOPE}/average_rgb:0": rng.random(3).astype(np.float32) * 100}
    cin_of = {1: 3, 2: 64, 3: 128, 4: 256, 5: 512}
    for blk, n, cout in ((1, 2, 64), (2, 2, 128), (3, 3, 256), (4, 3, 512), (5, 3, 512)):
        for i in range(1, n + 1):
            c_in = cin_of[blk] if i == 1 else cout
            tf_vars[f"{SCOPE}/conv{blk}_{i}/kernel:0"] = (
                rng.standard_normal((3, 3, c_in, cout)).astype(np.float32) * 0.05)
            tf_vars[f"{SCOPE}/conv{blk}_{i}/bias:0"] = (
                rng.standard_normal(cout).astype(np.float32) * 0.1)
    tf_vars[f"{SCOPE}/assignment/kernel:0"] = rng.standard_normal(
        (1, 1, 512, vlad_cores)).astype(np.float32)
    tf_vars[f"{SCOPE}/cluster_centers:0"] = rng.standard_normal(
        (1, 1, 1, 512, vlad_cores)).astype(np.float32)
    tf_vars["Variable:0"] = np.asarray(123)  # the global step: skipped
    np.savez(path, **tf_vars)


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("parity")
    rng = np.random.default_rng(0)
    ckpt = str(tmp / "ref_ckpt.npz")
    _fake_tf1_npz(ckpt, rng, COMMON["vlad_cores"])
    imgs = tmp / "images"
    imgs.mkdir()
    # one image at the model's size, two that the extractor resizes
    for i, shape in enumerate([(32, 48, 3), (40, 60, 3), (50, 50, 3)]):
        save_img((rng.random(shape) * 255).astype(np.uint8), str(imgs / f"img_{i:02d}.png"))
    jax_out = str(tmp / "jax.npz")
    jax_rep = jax_run_parity(ckpt, str(imgs), out=jax_out,
                             cfg=JaxModelConfig(use_pallas=False, **COMMON))
    return ckpt, str(imgs), tmp, jax_out, jax_rep


def test_parity_matches_jax(artifacts):
    ckpt, imgs, tmp, jax_out, jax_rep = artifacts
    out = str(tmp / "ours.npz")
    rep = run_parity(ckpt, imgs, out=out, cfg=ModelConfig(use_kernels=False, **COMMON),
                     device="cpu")
    with np.load(out, allow_pickle=True) as a, np.load(jax_out, allow_pickle=True) as b:
        np.testing.assert_allclose(a["descriptors"], b["descriptors"], rtol=0, atol=1e-5)
        assert list(a["files"]) == list(b["files"])
    for key in ("n_images", "descriptor_dim", "converted_vars", "warm_started_scopes"):
        assert getattr(rep, key) == getattr(jax_rep, key), key
    assert rep.converted_vars == 13 * 2 + 3 and rep.descriptor_dim == 4 * 512


def test_parity_against_jax_golden_and_perturbed(artifacts):
    """JAX's descriptors as the golden pass at 1e-3; a golden with one row
    moved by 0.01 fails."""
    ckpt, imgs, tmp, jax_out, _ = artifacts
    cfg = ModelConfig(use_kernels=False, **COMMON)
    rep = run_parity(ckpt, imgs, golden=jax_out, cfg=cfg, device="cpu")
    assert rep.passed and rep.max_abs_diff <= 1e-5 and rep.min_cosine > 1 - 1e-9
    with np.load(jax_out, allow_pickle=True) as z:
        desc = z["descriptors"].copy()
    desc[1] += 0.01
    bad = str(tmp / "bad.npz")
    np.savez(bad, descriptors=desc)
    assert run_parity(ckpt, imgs, golden=bad, cfg=cfg, device="cpu").passed is False


def test_parity_cli_exit_codes(artifacts, capsys):
    """``cli parity`` with the architecture read from the export (NetVLAD-4
    at the default 180x240): its own output as the golden gives 0, a
    perturbed golden 1, as JAX's CLI."""
    ckpt, imgs, tmp, _, _ = artifacts
    out = str(tmp / "cli.npz")
    base = ["parity", "--checkpoint", ckpt, "--images", imgs, "--device", "cpu"]
    assert cli_main(base + ["--out", out]) == 0
    assert cli_main(base + ["--golden", out]) == 0
    assert '"passed": true' in capsys.readouterr().out
    with np.load(out, allow_pickle=True) as z:
        desc = z["descriptors"] + 0.01
    np.savez(str(tmp / "cli_bad.npz"), descriptors=desc)
    assert cli_main(base + ["--golden", str(tmp / "cli_bad.npz")]) == 1


def test_compare_descriptors_shape_guard():
    with pytest.raises(ValueError, match="shape mismatch"):
        compare_descriptors(np.zeros((2, 4)), np.zeros((3, 4)))


def test_parity_list_file_and_empty_dir(artifacts, tmp_path):
    ckpt, imgs, _, jax_out, _ = artifacts
    listing = tmp_path / "list.txt"
    listing.write_text("\n".join(os.path.join(imgs, f) for f in sorted(os.listdir(imgs))))
    rep = run_parity(ckpt, str(listing), golden=jax_out,
                     cfg=ModelConfig(use_kernels=False, **COMMON), device="cpu")
    assert rep.passed and rep.n_images == 3
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError):
        run_parity(ckpt, str(tmp_path / "empty"), device="cpu")


def test_parity_over_a_jpeg_directory_matches_jax(artifacts, tmp_path):
    """A directory of ``.jpg`` and ``.jpeg`` files (4:2:0, progressive, one
    of another size that the extractor resizes): the port decodes them to
    OpenCV's pixels, and its descriptors equal JAX's within 1e-5."""
    import cv2

    ckpt, _, _, _, _ = artifacts
    rng = np.random.default_rng(4)
    imgs = tmp_path / "jpegs"
    imgs.mkdir()
    for i, (shape, ext, flags) in enumerate([((32, 48, 3), ".jpg", []),
                                             ((40, 60, 3), ".jpeg",
                                              [cv2.IMWRITE_JPEG_PROGRESSIVE, 1]),
                                             ((45, 50, 3), ".jpg", [])]):
        img = (rng.random(shape) * 255).astype(np.uint8)
        cv2.imwrite(str(imgs / f"img_{i:02d}{ext}"), img, flags)
    jax_out = str(tmp_path / "jax.npz")
    jax_run_parity(ckpt, str(imgs), out=jax_out, cfg=JaxModelConfig(use_pallas=False, **COMMON))
    out = str(tmp_path / "ours.npz")
    rep = run_parity(ckpt, str(imgs), out=out, cfg=ModelConfig(use_kernels=False, **COMMON),
                     device="cpu")
    assert rep.n_images == 3
    with np.load(out, allow_pickle=True) as a, np.load(jax_out, allow_pickle=True) as b:
        np.testing.assert_allclose(a["descriptors"], b["descriptors"], rtol=0, atol=1e-5)
        assert list(a["files"]) == list(b["files"])
