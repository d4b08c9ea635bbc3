"""The plain reference and the port's CPU path agree at a tiny size."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmarks.reference import model as ref
from benchmarks.reference.search import exact_topk
from benchmarks.reference.train import wms_loss
from benchmarks.weights import make_params
from soft_contrastive_learning_torch.core.config import ModelConfig

CFG = ModelConfig(vlad_cores=4, image_height=32, image_width=40, compute_dtype="float32")


def images(n=4, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).integers(0, 256, (n, 32, 40, 3))
                            .astype(np.uint8))


def test_fp32_forward():
    from soft_contrastive_learning_torch.models.model import EmbeddingNet

    params = make_params(1, "cpu", clusters=4)
    net = EmbeddingNet(CFG)
    net.load_state_dict(params)
    with torch.no_grad():
        prog = net(images())[1]
        mine = ref.descriptor_fp32(params, images())
    assert float((prog - mine).abs().max()) < 2e-5


def test_int8_forward_and_scales():
    from soft_contrastive_learning_torch.models.quant import QuantizedEmbedder, calibrate_scales

    params = make_params(2, "cpu", clusters=4)
    calib = images(4, seed=3)
    prog_scales = calibrate_scales(params, calib)
    scales = ref.calibrate(params, calib)
    assert np.allclose([prog_scales[k] for k in sorted(prog_scales,
                        key=lambda k: (int(k[5]), k))], scales, rtol=1e-6)
    prog = QuantizedEmbedder(CFG, params, scales=prog_scales, device="cpu").full(images())
    mine = ref.descriptor_int(params, scales, images(), compute=torch.float32)
    assert float((prog.double() - mine).abs().max()) < 1e-5
    coarse = ref.descriptor_int(params, ref.calibrate(params, calib, 7), images(), levels=7,
                                compute=torch.float32)
    assert float((coarse - mine).norm(dim=1).max()) > 1e-2  # int4 is another answer


def test_wms_loss_and_gradient():
    from soft_contrastive_learning_torch.losses.ms import wms_loss as prog_wms

    rng = np.random.default_rng(4)
    emb = torch.from_numpy(rng.normal(size=(10, 16))).requires_grad_(True)
    xy = rng.uniform(0, 40, size=(10, 2))
    geo = torch.from_numpy(np.sqrt(((xy[:, None] - xy[None]) ** 2).sum(-1)))
    a = prog_wms(geo, emb, d_alpha=0.8, d_beta=15.0)
    (ga,) = torch.autograd.grad(a, emb)
    b = wms_loss(geo, emb, 0.8, 15.0)
    (gb,) = torch.autograd.grad(b, emb)
    assert float(a.detach()) == pytest.approx(float(b.detach()), rel=1e-12)
    assert torch.allclose(ga, gb, rtol=1e-10, atol=1e-14)


def test_exact_topk():
    from soft_contrastive_learning_torch.ops.topk import topk_l2

    g = torch.Generator().manual_seed(0)
    index = torch.randn(1000, 64, generator=g)
    q = torch.randn(3, 64, generator=g)
    d, i = topk_l2(q, index, 7)
    ref_d, ref_i = exact_topk(q, index, 7, block=128)
    assert (i.numpy() == ref_i).all()
    assert np.abs(d.numpy() - ref_d).max() < 1e-4
