#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (soft_contrastive_learning_torch) on one
NVIDIA GPU. Run from the repository root:

    python3 chip_smoke.py

It needs one CUDA card and nvcc (CUDA_HOME or /usr/local/cuda); it imports
nothing of JAX or of soft_contrastive_learning_tpu. Phases, each fatal on
failure:

1. build every kernel under soft_contrastive_learning_torch/ops/kernels/csrc
   with nvcc, one process per source, all at once;
2. print the card's name and power limit (nvidia-smi);
3. K1 (NetVLAD aggregation) against its plain version at B=64, N=165,
   D=512, K=64, with fp32 and with bf16 logits;
4. K2 (streaming top-k) against its plain version at Q=64, R=66,048,
   D=32,768, k=5 and k=128, on an index with duplicated rows, and with
   R < k. Inputs are multiples of 1/8 in [-1, 1], so every dot product is
   exact in fp32 and ids and distances must agree exactly, ties included;
5. K3 (fused wms loss) against its plain version at B=50, D=32,768 (the
   flagship), B=100, D=32,768 and B=1,024, D=512 (where the TPU kernel did
   not compile), mining on and off, on inputs where mining moves the loss:
   |dloss| <= 1e-5 max(1, |loss|), and WmsLossFn's gradient equal to plain
   autograd's within 1e-6;
6. K1's backward: VladAggregateFn's gradients against plain autograd at
   B=50, N=165, D=512, K=64 with bf16 logits, within 1e-6;
7. serve the committed trained VGG16 + NetVLAD-64 at 180x240 through
   DescriptorService (batch 64): embed 512 index images, pad the index with
   seeded random unit vectors to 66,048 x 32,768 fp32 so that search takes
   the streamed K2 path, search 64 queries of which 16 are index images
   (each must come back at rank 0), and check that both kernels were
   launched on that path; then hold the served descriptors against an fp32
   plain-PyTorch model and the served search against K2's plain version;
8. train: one toy-city epoch (120 poses, 180x240) of the flagship through
   Trainer.train() from the trained weights: 2 tuples of 1+12+12 (B=50),
   Adam at 5e-6, hard mining 6+6, fused wms (K3), mining every 20 steps
   over a cache of 100, after the city is rendered into the card's image
   pool (set-up, timed apart). 60 steps, 6 refreshes; K1 and K3 must launch on
   it, every loss be finite and the weights move. Then, on the epoch's first
   batch from the same weights, one step with the kernels and one without
   must give the same loss (1e-5 relative at fp32, 1e-4 at bf16), and the
   step is timed with K1 and K3, with K1 only, and with no kernel;
9. print the serve, train and kernel JSON lines, then the result line.

Times come from CUDA events after a warm-up, in ms per call; bounds use the
H100 SXM peaks (67 TFLOP/s fp32 without tensor cores, 3.35 TB/s).
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import tempfile
import time

SEED = 0
FP32_FLOPS = 67e12  # H100 SXM, fp32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    t_ops, t_bytes = flops / FP32_FLOPS, nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes")


def time_ms(torch, fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def eighths(torch, gen, shape, out=None, rows_per_chunk=2048):
    """Seeded tensor of multiples of 1/8 in [-1, 1] on the card, made in
    row chunks to bound the temporary int64s."""
    out = torch.empty(shape, dtype=torch.float32, device="cuda") if out is None else out
    for s in range(0, shape[0], rows_per_chunk):
        e = min(s + rows_per_chunk, shape[0])
        m = torch.randint(-8, 9, (e - s, shape[1]), generator=gen, device="cuda")
        out[s:e] = m.float() / 8.0
    return out


def phase_k1(torch, report):
    from soft_contrastive_learning_torch.ops.kernels.netvlad import (
        netvlad_aggregate_cuda, vlad_aggregate)

    b, n, d, k = 64, 165, 512, 64
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    x = torch.randn((b, n, d), generator=gen, device="cuda")
    x = x / x.norm(dim=-1, keepdim=True)
    logits32 = 3.0 * torch.randn((b, n, k), generator=gen, device="cuda")
    centers = torch.randn((d, k), generator=gen, device="cuda") / d ** 0.5
    err = 0.0
    for logits in (logits32, logits32.bfloat16()):
        got = netvlad_aggregate_cuda(x, logits, centers)
        want = vlad_aggregate(x, logits, centers)
        torch.cuda.synchronize()
        e = (got - want).abs().max().item()
        print(f"K1 logits={logits.dtype}: max-abs err {e:.3g} vs plain")
        if not (e <= 1e-6 and torch.isfinite(got).all()):
            fail(f"K1 disagrees with its plain version ({logits.dtype}): max-abs {e}")
        err = max(err, e)
    logits = logits32.bfloat16()  # the main path's logits dtype
    ms = time_ms(torch, lambda: netvlad_aggregate_cuda(x, logits, centers), 50)
    plain_ms = time_ms(torch, lambda: vlad_aggregate(x, logits, centers), 50)
    nbytes = 4 * b * n * d + 2 * b * n * k + 4 * d * k + 4 * b * d * k
    bound_ms, bound_by = bound(2 * b * n * k * d, nbytes)
    print(f"K1 B={b} N={n} D={d} K={k} bf16 logits: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"bound {bound_ms:.4f} ms ({bound_by})")
    report["K1"] = dict(
        name="netvlad_aggregate", route="cuda",
        source="soft_contrastive_learning_torch/ops/kernels/csrc/netvlad.cu",
        replaces="soft_contrastive_learning_tpu/ops/pallas/netvlad_kernel.py:26",
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
        library_ms=None)


def phase_k2(torch, report):
    from soft_contrastive_learning_torch.ops.kernels.topk import (
        topk_l2_cuda, topk_l2_stream_plain)

    def compare(label, q, r, k):
        got_d, got_i = topk_l2_cuda(q, r, k)
        want_d, want_i = topk_l2_stream_plain(q, r, k)
        torch.cuda.synchronize()
        if got_i.shape != (q.shape[0], k) or not torch.equal(got_i, want_i):
            bad = (got_i != want_i).sum().item()
            fail(f"K2 {label}: {bad} ids differ from the plain version")
        finite = torch.isfinite(want_d)
        if not torch.equal(finite, torch.isfinite(got_d)):
            fail(f"K2 {label}: inf padding differs")
        e = (got_d[finite] - want_d[finite]).abs().max().item() if finite.any() else 0.0
        if e > 1e-6 * max(1.0, want_d[finite].abs().max().item()):
            fail(f"K2 {label}: distances differ by {e}")
        print(f"K2 {label}: ids identical, max-abs dist err {e:.3g}")
        return got_i, e

    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    nq, n_refs, d = 64, 66048, 32768
    q = eighths(torch, gen, (nq, d))
    r = eighths(torch, gen, (n_refs, d))
    err = 0.0
    for k in (5, 128):
        err = max(err, compare(f"Q={nq} R={n_refs} D={d} k={k}", q, r, k)[1])

    # duplicated rows (ragged R): the lower id comes first
    base = eighths(torch, gen, (4000, 512))
    dup = torch.cat([base, base])
    idx, e = compare("duplicated rows R=8000 D=512 k=128", base[:nq] + 0.125, dup, 128)
    err = max(err, e)
    for row in range(nq):
        pos = (idx[row] == row + 4000).nonzero()
        lo = (idx[row] == row).nonzero()
        if len(pos) and (not len(lo) or lo.item() > pos.item()):
            fail(f"K2 tie-break: row {row + 4000} ranked above its duplicate {row}")
    # fewer refs than k: (inf, -1) padding
    err = max(err, compare("R=100 < k=128 D=512", q[:, :512].contiguous(), base[:100], 128)[1])

    k = 5
    ms = time_ms(torch, lambda: topk_l2_cuda(q, r, k), 5)
    plain_ms = time_ms(torch, lambda: topk_l2_stream_plain(q, r, k), 5)
    ms128 = time_ms(torch, lambda: topk_l2_cuda(q, r, 128), 5)
    flops = 2 * nq * n_refs * d + 2 * n_refs * d
    bound_ms, bound_by = bound(flops, 4 * (n_refs * d + nq * d) + 12 * nq * k)
    print(f"K2 Q={nq} R={n_refs} D={d}: kernel k=5 {ms:.3f} ms, k=128 {ms128:.3f} ms, "
          f"plain k=5 {plain_ms:.3f} ms, bound {bound_ms:.3f} ms ({bound_by})")
    report["K2"] = dict(
        name="topk_l2", route="cuda",
        source="soft_contrastive_learning_torch/ops/kernels/csrc/topk.cu",
        replaces="soft_contrastive_learning_tpu/ops/pallas/topk_kernel.py:41",
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
        library_ms=None)
    del q, r
    torch.cuda.empty_cache()


def blocky_images(rng, n: int):
    """Seeded 180x240 uint8 images of 15x15-pixel random blocks."""
    return rng.integers(0, 256, (n, 12, 16, 3), dtype="uint8").repeat(15, 1).repeat(15, 2)


def phase_serve(torch, np, report):
    from soft_contrastive_learning_torch.core.config import ModelConfig
    from soft_contrastive_learning_torch.models.model import EmbeddingNet
    from soft_contrastive_learning_torch.models.weights import load_trained_params
    from soft_contrastive_learning_torch.ops.kernels.netvlad import netvlad_aggregate_cuda
    from soft_contrastive_learning_torch.ops.kernels.topk import (
        topk_l2_cuda, topk_l2_stream_plain)
    from soft_contrastive_learning_torch.serving import STREAM_MIN_ROWS, DescriptorService

    cfg = ModelConfig()  # flagship: VGG16 + NetVLAD-64, 180x240, bf16 convs, K1 on
    params = load_trained_params(cfg=cfg)
    rng = np.random.default_rng(SEED)
    index_imgs = blocky_images(rng, 512)
    query_imgs = np.concatenate([index_imgs[::32], blocky_images(rng, 48)])  # 16 known
    n_rows, dim, k = 66048, cfg.descriptor_dim, 5
    assert n_rows > STREAM_MIN_ROWS

    netvlad_aggregate_cuda.launches = 0
    topk_l2_cuda.launches = 0
    t0 = time.perf_counter()
    embedder = DescriptorService(cfg, params, batch_size=64)
    descs = embedder.embed(index_imgs)
    index = torch.empty((n_rows, dim), dtype=torch.float32, device="cuda")
    index[: len(descs)] = torch.from_numpy(descs).cuda()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    for s in range(len(descs), n_rows, 4096):
        e = min(s + 4096, n_rows)
        v = torch.randn((e - s, dim), generator=gen, device="cuda")
        index[s:e] = v / v.norm(dim=1, keepdim=True)
    service = DescriptorService(cfg, params, batch_size=64, index=index)
    dists, ids = service.search(query_imgs, k=k)
    torch.cuda.synchronize()
    launches = {"K1": netvlad_aggregate_cuda.launches, "K2": topk_l2_cuda.launches}
    print(f"serve: embedded {len(descs)} + searched {len(query_imgs)} images over "
          f"{n_rows} x {dim} in {time.perf_counter() - t0:.1f} s; launches {launches}")
    for name, count in launches.items():
        if count <= 0:
            fail(f"{name} was not launched on the serving path")
        report[name]["launches_by_path"] = {"serve": count}

    if descs.shape != (512, dim) or not np.isfinite(descs).all():
        fail(f"descriptors: shape {descs.shape} or non-finite values")
    norms = np.linalg.norm(descs, axis=1)
    if np.abs(norms - 1).max() > 1e-3:
        fail(f"descriptors not unit-norm: {norms.min()}..{norms.max()}")
    known = np.arange(0, 512, 32)
    if not (ids[:16, 0] == known).all():
        fail(f"index images not retrieved at rank 0: {ids[:16, 0]} vs {known}")
    print(f"serve: 16/16 index images at rank 0, self-distance max {dists[:16, 0].max():.3g}, "
          f"nearest other {dists[:16, 1].min():.3f}")

    # the served search against K2's plain version on the same inputs
    # Scores differ in the last bits (other summation order), so compare
    # squared distances, and allow id swaps only between neighbours whose
    # squared distances are within 1e-5 (rank k+1 included).
    q = torch.from_numpy(service.embed(query_imgs)).cuda()
    got_d, got_i = topk_l2_cuda(q, index, k)
    want_d, want_i = topk_l2_stream_plain(q, index, k + 1)
    got_sq, want_sq = (got_d ** 2).cpu().numpy(), (want_d ** 2).cpu().numpy()
    e = np.abs(got_sq - want_sq[:, :k]).max()
    differ = (got_i != want_i[:, :k]).cpu().numpy()
    steps = np.abs(np.diff(want_sq, axis=1))  # (Q, k): gap to the next rank
    gaps = np.minimum(np.concatenate([np.full((len(steps), 1), np.inf), steps[:, :-1]], 1),
                      steps)
    if e > 1e-5 or (differ & (gaps > 1e-5)).any():
        fail(f"served K2 vs plain: sq-dist err {e}, {differ.sum()} ids differ outside near-ties")
    print(f"serve: K2 vs plain on the served queries: max sq-dist err {e:.3g}, "
          f"{differ.sum()} of {differ.size} ids differ (near-ties within 1e-5 only)")

    # served bf16 descriptors against an fp32 plain-PyTorch model (no kernels)
    ref_cfg = ModelConfig(compute_dtype="float32", use_kernels=False)
    ref_model = EmbeddingNet(ref_cfg)
    ref_model.load_state_dict(params)
    ref_model = ref_model.cuda().eval()
    k1_cfg = ModelConfig(compute_dtype="float32")
    k1_model = EmbeddingNet(k1_cfg)
    k1_model.load_state_dict(params)
    k1_model = k1_model.cuda().eval()
    x = torch.from_numpy(index_imgs[:8]).cuda()
    with torch.inference_mode():
        ref = ref_model(x)[1]
        via_k1 = k1_model(x)[1]
    served = torch.from_numpy(descs[:8]).cuda()
    cos_bf16 = (served * ref).sum(1).min().item()
    cos_k1 = (via_k1 * ref).sum(1).min().item()
    print(f"serve: cosine to the fp32 plain model: served bf16 {cos_bf16:.6f}, "
          f"fp32 with K1 {cos_k1:.8f}")
    if cos_bf16 < 0.99 or cos_k1 < 0.99999:
        fail(f"descriptors disagree with the fp32 plain model ({cos_bf16}, {cos_k1})")

    # embed throughput at batch 64: end to end through the service, and the
    # model alone on the card
    batch = torch.from_numpy(index_imgs[:64]).cuda()
    embed_ms = time_ms(torch, lambda: service.extractor._embed(batch), 20)
    t0 = time.perf_counter()
    service.embed(index_imgs)
    e2e_s = time.perf_counter() - t0
    report["serve"] = dict(embed_img_s=512 / e2e_s, model_img_s=64e3 / embed_ms,
                           model_ms_per_batch64=embed_ms)
    print(f"serve: embed {512 / e2e_s:.1f} img/s end to end (service.embed, 512 images), "
          f"model alone {64e3 / embed_ms:.1f} img/s ({embed_ms:.3f} ms per batch of 64)")


def wms_inputs(torch, np, b, d, seed, device="cuda"):
    """Seeded places on a 60 m line (geo = their distances, in [0, 60] m) and
    unit rows whose similarity falls with distance: random Fourier features
    of the place (10 m length scale), one of 8 shared look-alike vectors (far
    pairs that look alike, the hard negatives) and noise. Similarities
    spread over [0, 1], so MS mining drops about a quarter of the positives
    and most negatives. Made with numpy, so the inputs are the same bits on
    any machine."""
    rng = np.random.default_rng(seed)
    place = rng.uniform(0.0, 60.0, (b, 1))
    emb = np.cos(place * rng.standard_normal((1, d)) / 10.0 + rng.uniform(0, 2 * np.pi, (1, d)))
    emb += 0.5 * rng.standard_normal((8, d))[rng.integers(0, 8, b)]
    emb += 0.3 * rng.standard_normal((b, d))
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    return (torch.from_numpy(np.abs(place - place.T).astype(np.float32)).to(device),
            torch.from_numpy(emb.astype(np.float32)).to(device))


def phase_k3(torch, np, report):
    from soft_contrastive_learning_torch.losses.ms import wms_loss
    from soft_contrastive_learning_torch.ops.kernels.wms import wms_loss_cuda, wms_loss_fused

    # beta = 50 is the MS default that training uses; there the negatives
    # that mining drops weigh ~1e-11 in the loss, so beta = 2 is run too, at
    # which dropping them moves the loss
    err = 0.0
    for b, d, beta in ((50, 32768, 50.0), (100, 32768, 50.0), (1024, 512, 50.0),
                       (50, 32768, 2.0)):
        geo, emb = wms_inputs(torch, np, b, d, SEED + b)
        losses = {}
        for mining in (True, False):
            kw = dict(beta=beta, ms_mining=mining)
            got = wms_loss_cuda(geo, emb, 0.8, 15.0, **kw)
            want = wms_loss(geo, emb, 0.8, 15.0, **kw)
            e1, e2 = emb.clone().requires_grad_(), emb.clone().requires_grad_()
            (g1,) = torch.autograd.grad(wms_loss_fused(geo, e1, 0.8, 15.0, **kw), e1)
            (g2,) = torch.autograd.grad(wms_loss(geo, e2, 0.8, 15.0, **kw), e2)
            torch.cuda.synchronize()
            e = abs(got.item() - want.item())
            ge = (g1 - g2).abs().max().item()
            print(f"K3 B={b} D={d} beta={beta:g} mining={mining}: loss {got.item():.7f} vs "
                  f"plain {want.item():.7f} (|d| {e:.3g}), grad max-abs {ge:.3g}")
            if not (e <= 1e-5 * max(1.0, abs(want.item())) and ge <= 1e-6):
                fail(f"K3 disagrees with its plain version at B={b} D={d} beta={beta} "
                     f"mining={mining}: loss {e}, grad {ge}")
            err = max(err, e)
            losses[mining] = want.item()
        # mining must move the loss by 100x the tolerance, so that a kernel
        # that got it wrong or ignored it could not pass
        if abs(losses[True] - losses[False]) < 1e-3 * max(1.0, abs(losses[True])):
            fail(f"K3 inputs at B={b} beta={beta}: mining does not move the loss {losses}")
    b, d = 50, 32768
    geo, emb = wms_inputs(torch, np, b, d, SEED + b)
    ms = time_ms(torch, lambda: wms_loss_cuda(geo, emb, 0.8, 15.0), 200)
    plain_ms = time_ms(torch, lambda: wms_loss(geo, emb, 0.8, 15.0), 200)
    # the Gram is symmetric: B (B + 1) / 2 dot products of D; emb and geo
    # read once, one float written
    bound_ms, bound_by = bound(b * (b + 1) * d, 4 * (b * d + b * b) + 4)
    print(f"K3 B={b} D={d}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"bound {bound_ms:.4f} ms ({bound_by})")
    report["K3"] = dict(
        name="wms_loss", route="cuda",
        source="soft_contrastive_learning_torch/ops/kernels/csrc/wms.cu",
        replaces="soft_contrastive_learning_tpu/ops/pallas/wms_kernel.py:27",
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
        library_ms=None)


def phase_k1_backward(torch, report):
    from soft_contrastive_learning_torch.ops.kernels.netvlad import (
        VladAggregateFn, vlad_aggregate)

    b, n, d, k = 50, 165, 512, 64
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    x = torch.randn((b, n, d), generator=gen, device="cuda")
    x = x / x.norm(dim=-1, keepdim=True)
    logits = (3.0 * torch.randn((b, n, k), generator=gen, device="cuda")).bfloat16()
    centers = torch.randn((d, k), generator=gen, device="cuda") / d ** 0.5
    g = torch.randn((b, d * k), generator=gen, device="cuda")

    def grads(fn):
        ins = [t.clone().requires_grad_() for t in (x, logits, centers)]
        return torch.autograd.grad(fn(*ins), ins, g)

    got, want = grads(VladAggregateFn.apply), grads(vlad_aggregate)
    torch.cuda.synchronize()
    errs = [(a.float() - w.float()).abs().max().item() for a, w in zip(got, want)]
    print(f"K1 backward B={b} N={n} D={d} K={k} bf16 logits: grad max-abs "
          f"x {errs[0]:.3g}, logits {errs[1]:.3g}, centers {errs[2]:.3g} vs plain autograd")
    if got[1].dtype != torch.bfloat16 or max(errs) > 1e-6:
        fail(f"VladAggregateFn gradients disagree with plain autograd: {errs}")
    fwd_bwd_ms = time_ms(torch, lambda: grads(VladAggregateFn.apply), 20)
    plain_ms = time_ms(torch, lambda: grads(vlad_aggregate), 20)
    print(f"K1 forward+backward B={b}: through VladAggregateFn {fwd_bwd_ms:.4f} ms, "
          f"plain autograd {plain_ms:.4f} ms")
    report["K1_backward"] = dict(max_abs_err=max(errs), fwd_bwd_ms=fwd_bwd_ms,
                                 plain_fwd_bwd_ms=plain_ms)


def phase_train(torch, np, report):
    from soft_contrastive_learning_torch.core.config import LossConfig, ModelConfig, TrainConfig
    from soft_contrastive_learning_torch.data.pipeline import ToyCitySource
    from soft_contrastive_learning_torch.losses.registry import build_loss
    from soft_contrastive_learning_torch.models.model import EmbeddingNet
    from soft_contrastive_learning_torch.models.weights import load_trained_params
    from soft_contrastive_learning_torch.ops.kernels.netvlad import netvlad_aggregate_cuda
    from soft_contrastive_learning_torch.ops.kernels.topk import topk_l2_cuda
    from soft_contrastive_learning_torch.ops.kernels.wms import wms_loss_cuda
    from soft_contrastive_learning_torch.train.step import build_train_step, init_train_state
    from soft_contrastive_learning_torch.train.trainer import Trainer

    cfg = TrainConfig(loss=LossConfig(fused_wms=True), mining_step=20, mining_cache_size=100,
                      max_epoch=1)  # flagship model, B = 2 x (1+12+12), Adam at 5e-6
    params = load_trained_params(cfg=cfg.model)
    source = ToyCitySource(num_points=120, radius=150.0, img_h=180, img_w=240)
    b = cfg.images_per_batch

    with tempfile.TemporaryDirectory() as out_dir:
        tr = Trainer(cfg, source, out_dir=out_dir, device="cuda", params=params)
        # time each step on the device, and keep the epoch's first batch
        step, events, first = tr.train_step_pooled, [], {}

        def timed_step(state, batch, pool):
            if not first:
                first.update({k: v.clone() if torch.is_tensor(v) else v
                              for k, v in batch.items()})
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = step(state, batch, pool)
            end.record()
            events.append((start, end))
            return out

        tr.train_step_pooled = timed_step
        t0 = time.perf_counter()  # set-up: render the city into the card's image pool
        tr._ensure_image_pool(source.epoch_meta(cfg.local_ref_set, 0))
        pool_s = time.perf_counter() - t0
        netvlad_aggregate_cuda.launches = topk_l2_cuda.launches = wms_loss_cuda.launches = 0
        t0 = time.perf_counter()
        tr.train()
        torch.cuda.synchronize()
        epoch_s = time.perf_counter() - t0
        launches = {"K1": netvlad_aggregate_cuda.launches, "K2": topk_l2_cuda.launches,
                    "K3": wms_loss_cuda.launches}
        losses = [r["value"] for r in tr.writer.read_all() if r["tag"] == "loss"]
        tr.close()
    step_ms = [s.elapsed_time(e) for s, e in events]
    print(f"train: {tr.global_step} steps, {tr.mining.refresh_count} mining refreshes in "
          f"{epoch_s:.2f} s after {pool_s:.2f} s of pool set-up; launches {launches}; "
          f"first/last loss {losses[0]:.6f}/{losses[-1]:.6f}")
    if tr.global_step != 60 or tr.mining.refresh_count != 6 or len(losses) != 60:
        fail(f"train: {tr.global_step} steps, {tr.mining.refresh_count} refreshes, "
             f"{len(losses)} losses; expected 60, 6, 60")
    # one K3 launch per step; K1 per step and per embedded chunk of 50 (3 a refresh)
    if launches["K3"] != 60 or launches["K1"] != 60 + 6 * 3:
        fail(f"train: kernels not launched on the training path as expected: {launches}")
    if not np.isfinite(losses).all():
        fail(f"train: non-finite losses {losses}")
    unmoved = [k for k, v in tr.state.model.state_dict().items()
               if torch.equal(v.cpu(), params[k])]
    if unmoved:
        fail(f"train: parameters did not move: {unmoved[:5]}")
    for name, count in launches.items():
        report[name].setdefault("launches_by_path", {})["train"] = count

    # the first batch from the trained weights: kernels on and off, fp32 and bf16
    batch, pool = first, tr._image_pool.array
    rel = {}
    for dtype in ("float32", "bfloat16"):
        got = []
        for kernels in (True, False):
            c = TrainConfig(model=ModelConfig(compute_dtype=dtype, use_kernels=kernels),
                            loss=LossConfig(fused_wms=kernels))
            model = EmbeddingNet(c.model)
            model.load_state_dict(params)
            state = init_train_state(c, model.cuda())
            one = build_train_step(c, build_loss(c.loss, c.tuples, c.tuples_per_batch),
                                   image_pool=True)
            got.append(one(state, dict(batch), pool)[1]["loss"].item())
        rel[dtype] = abs(got[0] - got[1]) / abs(got[1])
        print(f"train parity {dtype}: first-batch loss with kernels {got[0]:.8f}, "
              f"without {got[1]:.8f} (rel {rel[dtype]:.3g})")
    if rel["float32"] > 1e-5 or rel["bfloat16"] > 1e-4:
        fail(f"train: kernel and plain steps disagree on the first batch: {rel}")

    # step time with K1 and K3, with K1 only (the plain wms), and with no
    # kernel (the plain model too), in turns (a, b, c, c, b, a)
    variants = {"K1+K3": (True, True), "K1": (True, False), "none": (False, False)}
    runs = {}
    for name, (kernels, fused) in variants.items():
        c = TrainConfig(model=ModelConfig(use_kernels=kernels), loss=LossConfig(fused_wms=fused))
        model = EmbeddingNet(c.model)
        model.load_state_dict(params)
        runs[name] = (init_train_state(c, model.cuda()),
                      build_train_step(c, build_loss(c.loss, c.tuples, c.tuples_per_batch),
                                       image_pool=True))
    turns = {name: [] for name in variants}
    for name in (*variants, *reversed(variants)):
        state, one = runs[name]
        turns[name].append(time_ms(torch, lambda: one(state, dict(batch), pool), 10))
    step_ms_by = {name: statistics.mean(t) for name, t in turns.items()}
    med = statistics.median(step_ms[1:])
    print(f"train: median {med:.3f} ms per step after the first ({1e3 * b / med:.1f} img/s at "
          f"B={b}); epoch end to end {60 * b / epoch_s:.1f} img/s; step with K1 and K3 "
          f"{step_ms_by['K1+K3']:.3f} ms, with K1 and the plain wms {step_ms_by['K1']:.3f} ms, "
          f"with no kernel {step_ms_by['none']:.3f} ms")
    report["train"] = dict(steps=tr.global_step, refreshes=tr.mining.refresh_count,
                           images_per_step=b, median_step_ms=med, img_s=1e3 * b / med,
                           first_step_ms=step_ms[0], pool_setup_s=pool_s, epoch_s=epoch_s,
                           epoch_img_s=60 * b / epoch_s, step_ms_by_kernels=step_ms_by,
                           parity_rel=rel,
                           first_loss=losses[0], last_loss=losses[-1])


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: no CUDA card")
    try:
        import numpy as np

        from soft_contrastive_learning_torch.ops.kernels import _build
    except ImportError as e:
        fail(f"the port is not importable from here ({e}); run from the repository root")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    seconds = _build.build()
    print(f"build: {_build.kernel_names()} in {seconds:.1f} s (0 = already built)")
    for name in _build.kernel_names():
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {name}: {line.strip()}")

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    print(smi.stdout.strip())
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")

    report: dict = {}
    phase_k1(torch, report)
    phase_k2(torch, report)
    phase_k3(torch, np, report)
    phase_k1_backward(torch, report)
    phase_serve(torch, np, report)
    phase_train(torch, np, report)

    # launches: the count on the newest path that runs the kernel (train for
    # K1 and K3, serve for K2); launches_by_path: each path's own count
    for kid in ("K1", "K2", "K3"):
        by_path = report[kid]["launches_by_path"]
        report[kid]["launches"] = by_path["train"] or by_path.get("serve", 0)
    keys = ("name", "route", "source", "replaces", "launches", "launches_by_path",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"serve": report["serve"]}))
    print(json.dumps({"train": report["train"], "K1_backward": report["K1_backward"]}))
    print(json.dumps({"kernels": [{key: report[kid][key] for key in keys}
                                  for kid in ("K1", "K2", "K3")]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
