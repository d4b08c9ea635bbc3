#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (soft_contrastive_learning_torch) on one
NVIDIA GPU. Run from the repository root:

    python3 chip_smoke.py

It needs one CUDA card and nvcc (CUDA_HOME or /usr/local/cuda); it imports
nothing of JAX or of soft_contrastive_learning_tpu. Phases, each fatal on
failure:

1. build every kernel under soft_contrastive_learning_torch/ops/kernels/csrc
   with nvcc, one process per source, all at once; print each kernel
   function's registers, spills and static shared memory (ptxas), the
   probe tiles' and K4's dynamic shared memory and K4's cluster size, K1's
   shared memory per block (forward and backward) and cluster size, and
   (where cuobjdump is present) the wgmma (HGMMA) and TMA-load (UTMALDG)
   instructions in each library, which probe_gemm and winograd must hold
   (and netvlad the TMA loads); wms must hold one kernel function (K3 is one
   launch);
2. print the card's name and power limit (nvidia-smi);
3. K1 (NetVLAD aggregation, one cluster of 4 blocks per image) against its
   plain version at B=64 and B=50, N=165, D=512, K=64, with fp32 and with
   bf16 logits, within 1e-6; timed at both batches, the device's time apart
   from the host's;
4. K2 (streaming top-k) against its plain version at Q=64, R=66,048,
   D=32,768, k=5 and k=128, on an index with duplicated rows, and with
   R < k. Inputs are multiples of 1/8 in [-1, 1], so every dot product is
   exact in fp32 and ids and distances must agree exactly, ties included;
5. K3 (fused wms loss) against its plain version at B=50, D=32,768 (the
   flagship), B=100, D=32,768 and B=1,024, D=512 (where the TPU kernel did
   not compile), mining on and off, on inputs where mining moves the loss:
   |dloss| <= 1e-5 max(1, |loss|), the same bits twice, and WmsLossFn's
   gradient equal to plain autograd's within 1e-6; a call's time on the
   host apart from the card's, and forward + backward against plain
   autograd;
6. K1's backward: the backward kernel against the closed form it
   implements (vlad_aggregate_backward) and VladAggregateFn's gradients
   against plain autograd at B=50, N=165, D=512, K=64 with bf16 and fp32
   logits: within 1e-6 of each gradient's largest entry (at least 1), the
   bf16 logits gradient within one bf16 step (two fp32 summation orders may
   round to neighbouring bf16 values) or, where the bf16 grid is finer, that
   1e-6; the same bits twice; forward + backward timed against plain
   autograd in turns;
7. K4 (fused Winograd F(2x2,3x3) conv) against its plain version at every
   Winograd layer shape of the flagship (conv2_2 to conv5_3 at 180x240) at
   the serving batch, B=64, and the training batch, B=50, where conv3 and
   conv4 end in a ragged block of tiles, and at B=2 odd shapes (11x15, 9x9,
   F=64), ReLU on and off: fp32 output within 1e-4 of the largest output;
   bf16 output within one bf16 step on >= 99.9% of the elements and two
   everywhere (where the bf16 grid is finer than the fp32 gate, that
   gate); the same bits twice; and within
   0.02 relative of the fp32 cuDNN conv (TF32 off). Timed at both batches
   beside cuDNN's bf16 conv (+ ReLU) on the same shapes;
8. K4's backward: WinogradConvFn's gradients against autograd of the direct
   bf16 conv at B=50 (conv4_2 with the fused ReLU, conv2_2 without), within
   0.05 of each gradient's largest entry (the cotangent comes from the
   Winograd forward), and forward + backward timed against plain autograd;
9. the probes' product kernels (probe_gemm: bf16 on wgmma fed by TMA, int8
   on mma.sync) against their plain version:
   bit-equal on operands whose sums are exact (multiples of 1/8; int8) at
   every problem the probe scripts launch (the resident and blocked shapes
   of perf/mxu_probe.py, (8192, 4096) @ (4096, 8192), the eight of
   perf/matmul_probe.py batched, unrolled and single, where 240 and 360 rows
   end in a ragged tile), with the chosen and with every dividing tile
   shape, for bf16 -> fp32, bf16 -> bf16 and int8 -> int32; within a stated
   tolerance on normals; then its times per tile shape beside torch.matmul /
   torch._int_mm and the bound, and at the eight shapes of matmul_probe.py;
10. K4 cut short at each stage (dma, transform, matmul, full) against
   winograd_stage_plain at conv2_2 and conv4_2 (B=64), conv4_2 at B=50 (a
   ragged block) and conv2_2 at B=256; the full stage bit-equal to K4's
   wrapper; then the four stage times at the six layer shapes at B=64;
11. the five probe scripts (soft_contrastive_learning_torch/perf) through
   their main(), at their own problems: each must launch its kernel once
   per row and call, warm-up included, and no other;
12. serve the committed trained VGG16 + NetVLAD-64 at 180x240 through
   DescriptorService (batch 64): embed 512 index images, pad the index with
   seeded random unit vectors to 66,048 x 32,768 fp32 so that search takes
   the streamed K2 path, search 64 queries of which 16 are index images
   (each must come back at rank 0), and check that both kernels were
   launched on that path; then hold the served descriptors against an fp32
   plain-PyTorch model and the served search against K2's plain version;
13. serve the same 512 images with ModelConfig(winograd=True): 10 K4 and one
   K1 launch per batch, descriptors at cosine >= 0.999 to the standard
   configuration's and >= 0.99 to the fp32 plain model's, and the model's
   time per batch beside the standard configuration's, in turns;
14. train: one toy-city epoch (120 poses, 180x240) of the flagship through
   Trainer.train() from the trained weights: 2 tuples of 1+12+12 (B=50),
   Adam at 5e-6, hard mining 6+6, fused wms (K3), mining every 20 steps
   over a cache of 100, the eval hooks once (before the first step: the
   held-out city's loss over 4 anchors, localization of 4 queries against
   12 reference poses in both cities), after the city is rendered into the
   card's image pool (set-up, timed apart). 60 steps, 6 refreshes; K1 and K3
   must launch on it as often as the path calls them, every loss and eval
   scalar be finite and the weights move. Then, on the epoch's first batch
   from the same weights, one step with the kernels and one without must
   give the same loss (1e-5 relative at fp32, 1e-4 at bf16), and the step
   is timed with K1 and K3, with K1 only, and with no kernel. The epoch
   leaves a part checkpoint at step 30; a second Trainer, a fresh object
   with only that file, resumes from it and finishes the epoch, and the
   epoch is run whole a second time for the run-to-run floor: the resumed
   run must draw the same batches and end within 10x the floor (at least
   1e-6) of the uninterrupted run's last loss and parameters;
15. train the same epoch with ModelConfig(winograd=True): 840 K4 launches
   (10 per forward: steps, mining embeds, evals), the same checks, the
   standard epoch's first batch within 1e-2 relative of the standard
   configuration's loss, and the step timed against it in turns;
16. print the serve, train, probe and kernel JSON lines, then the result
   line.

Times come from CUDA events after a warm-up, in ms per call; bounds use the
H100 SXM peaks (67 TFLOP/s fp32 without tensor cores, 989 TFLOP/s bf16 and
1,979 TOP/s int8 on them, 3.35 TB/s).
"""

from __future__ import annotations

import json
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace

SEED = 0


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def eighths(torch, gen, shape, out=None, rows_per_chunk=2048):
    """Seeded tensor of multiples of 1/8 in [-1, 1] on the card, made in
    row chunks to bound the temporary int64s."""
    out = torch.empty(shape, dtype=torch.float32, device="cuda") if out is None else out
    for s in range(0, shape[0], rows_per_chunk):
        e = min(s + rows_per_chunk, shape[0])
        m = torch.randint(-8, 9, (e - s, shape[1]), generator=gen, device="cuda")
        out[s:e] = m.float() / 8.0
    return out


def phase_build(torch, report):
    """Build every kernel library (one nvcc per source, all at once), then
    print per kernel function what ptxas said (registers, spills, static
    shared memory), the dynamic shared memory and cluster of the rebuilt
    kernels, and, where cuobjdump is present, how many HGMMA (wgmma) and
    UTMALDG (TMA load) instructions each library's SASS holds: probe_gemm
    and winograd must hold both."""
    import shutil

    from soft_contrastive_learning_torch.ops import winograd as plain_winograd
    from soft_contrastive_learning_torch.ops.kernels import _build, netvlad, probe_gemm, winograd

    seconds = _build.build()
    print(f"build: {_build.kernel_names()} in {seconds:.1f} s (0 = already built)")
    cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")
    cuobjdump = str(cuobjdump) if cuobjdump.exists() else shutil.which("cuobjdump")
    cxxfilt = shutil.which("c++filt")
    out = {}
    for name in _build.kernel_names():
        funcs = _build.ptxas_summary(name)
        if cxxfilt and funcs:
            names = subprocess.run([cxxfilt], input="\n".join(f["function"] for f in funcs),
                                   capture_output=True, text=True, timeout=60).stdout.split("\n")
            for f, demangled in zip(funcs, names):
                name_only = demangled.replace("(anonymous namespace)::", "").split("(", 1)[0]
                f["function"] = name_only.removeprefix("void ").strip()
        for f in funcs:
            print(f"ptxas {name}: {f['function']}: {f['registers']} registers, spills "
                  f"{f['spill_stores']}/{f['spill_loads']} bytes stored/loaded, static smem "
                  f"{f['smem']} bytes")
        sass = None
        if cuobjdump:
            text = subprocess.run([cuobjdump, "-sass", str(_build.library_path(name))],
                                  capture_output=True, text=True, timeout=120).stdout
            sass = {op: text.count(op) for op in ("HGMMA", "UTMALDG", "HMMA", "IMMA")}
            print(f"sass {name}: {sass}")
            if name in ("probe_gemm", "winograd") and not (sass["HGMMA"] and sass["UTMALDG"]):
                fail(f"{name}: the built library holds no wgmma or no TMA load ({sass})")
            if name == "netvlad" and not sass["UTMALDG"]:
                fail(f"netvlad: the built library holds no TMA load ({sass})")
        if name == "wms" and len(funcs) != 1:
            fail(f"wms: {len(funcs)} kernel functions, expected one (K3 is one launch): "
                 f"{[f['function'] for f in funcs]}")
        out[name] = dict(kernels=funcs, sass=sass)
    if not cuobjdump:
        print("sass: cuobjdump not found; the instruction check is skipped")
    lib = probe_gemm._lib()
    tiles = []
    for dtype, route in probe_gemm.ROUTES.items():
        int8 = int(dtype == torch.int8)
        for i, tile in enumerate(probe_gemm.CONFIGS[dtype]):
            smem, stages = (lib.scl_probe_gemm_config(int8, i, w) for w in (3, 4))
            tiles.append(dict(dtype=str(dtype), route=route, tile=tile, smem=smem, stages=stages))
            print(f"probe_gemm {dtype} {route} tile {tile}: {stages} stages, {smem} bytes of "
                  "dynamic shared memory")
    k1 = netvlad._lib()
    k1_smem = {which: k1.scl_netvlad_smem_bytes(165, 64, int(which == "backward"))
               for which in ("forward", "backward")}
    k1_active = {which: k1.scl_netvlad_active_clusters(165, 64, int(which == "backward"))
                 for which in ("forward", "backward")}
    print(f"K1: clusters of {k1.scl_netvlad_cluster_blocks()} blocks per image along D, "
          f"{k1_smem['forward']} / {k1_smem['backward']} bytes of dynamic shared memory a block, "
          f"{k1_active['forward']} / {k1_active['backward']} clusters resident at once "
          "(forward / backward, N=165, K=64)")
    k4_smem = winograd._lib().scl_winograd_smem_bytes()
    print(f"K4: clusters of {plain_winograd.CLUSTER} blocks sharing U by TMA multicast, "
          f"{k4_smem} bytes of dynamic shared memory a block; tile rectangles (rows x cols) "
          "at 180x240: " + ", ".join(
              f"{n} {plain_winograd.block_rows(h, w)}x{32 // plain_winograd.block_rows(h, w)}"
              for n, (h, w) in (("conv2", (90, 120)), ("conv3", (45, 60)), ("conv4", (22, 30)),
                                ("conv5", (11, 15)))))
    report["build"] = dict(seconds=seconds, libraries=out, probe_gemm_tiles=tiles,
                           k1=dict(cluster=k1.scl_netvlad_cluster_blocks(), smem=k1_smem,
                                   resident_clusters=k1_active),
                           k4=dict(cluster=plain_winograd.CLUSTER, smem=k4_smem))


def vlad_inputs(torch, b, seed, logit_dtype=None):
    """Seeded NetVLAD inputs at the flagship's widths (N=165, D=512, K=64) on
    the card: unit-norm features, logits 3 N(0, 1) (bf16 unless said), and
    centers N(0, 1/D)."""
    n, d, k = 165, 512, 64
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((b, n, d), generator=gen, device="cuda")
    x = x / x.norm(dim=-1, keepdim=True)
    logits = (3.0 * torch.randn((b, n, k), generator=gen, device="cuda"))
    logits = logits.to(logit_dtype or torch.bfloat16)
    centers = torch.randn((d, k), generator=gen, device="cuda") / d ** 0.5
    return x, logits, centers


def phase_k1(torch, report):
    from soft_contrastive_learning_torch.perf import common
    from soft_contrastive_learning_torch.ops.kernels.netvlad import (
        netvlad_aggregate_cuda, vlad_aggregate)

    n, d, k = 165, 512, 64
    err, by_batch = 0.0, {}
    for b in (64, 50):  # serving and training batch: 256 and 200 blocks
        x, logits32, centers = vlad_inputs(torch, b, SEED + b, torch.float32)
        for logits in (logits32, logits32.bfloat16()):
            got = netvlad_aggregate_cuda(x, logits, centers)
            want = vlad_aggregate(x, logits, centers)
            torch.cuda.synchronize()
            e = (got - want).abs().max().item()
            print(f"K1 B={b} logits={logits.dtype}: max-abs err {e:.3g} vs plain")
            if not (e <= 1e-6 and torch.isfinite(got).all()):
                fail(f"K1 disagrees with its plain version (B={b}, {logits.dtype}): max-abs {e}")
            err = max(err, e)
        logits = logits32.bfloat16()  # the main path's logits dtype
        ms = common.time_ms(lambda: netvlad_aggregate_cuda(x, logits, centers), 50)
        host_ms, device_ms = common.host_and_device_ms(
            lambda: netvlad_aggregate_cuda(x, logits, centers), 50)
        plain_ms = common.time_ms(lambda: vlad_aggregate(x, logits, centers), 50)
        nbytes = 4 * b * n * d + 2 * b * n * k + 4 * d * k + 4 * b * d * k
        bound_ms, bound_by = common.bound_ms(2 * b * n * k * d, nbytes)
        print(f"K1 B={b} N={n} D={d} K={k} bf16 logits: kernel {ms:.4f} ms a call (device "
              f"{device_ms:.4f}, host {host_ms:.4f}), plain {plain_ms:.4f} ms, bound "
              f"{bound_ms:.4f} ms ({bound_by})")
        by_batch[f"B{b}"] = dict(ms=ms, device_ms=device_ms, host_ms=host_ms, plain_ms=plain_ms,
                                 bound_ms=bound_ms, bound_by=bound_by)
    report["K1"] = dict(
        name="netvlad_aggregate", route="cuda",
        source="soft_contrastive_learning_torch/ops/kernels/csrc/netvlad.cu",
        replaces="soft_contrastive_learning_tpu/ops/pallas/netvlad_kernel.py:26",
        max_abs_err=err, library_ms=None, by_batch=by_batch,
        **{key: by_batch["B64"][key] for key in ("ms", "plain_ms", "bound_ms", "bound_by")})


def phase_k2(torch, report):
    from soft_contrastive_learning_torch.perf import common
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
    ms = common.time_ms(lambda: topk_l2_cuda(q, r, k), 5)
    plain_ms = common.time_ms(lambda: topk_l2_stream_plain(q, r, k), 5)
    ms128 = common.time_ms(lambda: topk_l2_cuda(q, r, 128), 5)
    flops = 2 * nq * n_refs * d + 2 * n_refs * d
    bound_ms, bound_by = common.bound_ms(flops, 4 * (n_refs * d + nq * d) + 12 * nq * k)
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


KERNEL_IDS = ("K1", "K1_bwd", "K2", "K3", "K4", "P_gemm", "P6_stages")


class LaunchCounts:
    """The kernel wrappers' launch counters around one path: set to 0 on
    entry, read by ``read()`` into ``report[kernel]['launches_by_path']``."""

    def __init__(self, report, path):
        from soft_contrastive_learning_torch.ops.kernels.netvlad import (
            netvlad_aggregate_cuda, netvlad_backward_cuda)
        from soft_contrastive_learning_torch.ops.kernels.probe_gemm import probe_gemm
        from soft_contrastive_learning_torch.ops.kernels.topk import topk_l2_cuda
        from soft_contrastive_learning_torch.ops.kernels.winograd import (
            winograd_conv_cuda, winograd_stage)
        from soft_contrastive_learning_torch.ops.kernels.wms import wms_loss_cuda

        self.report, self.path = report, path
        self.wrappers = dict(zip(KERNEL_IDS, (
            netvlad_aggregate_cuda, netvlad_backward_cuda, topk_l2_cuda, wms_loss_cuda,
            winograd_conv_cuda, probe_gemm, winograd_stage)))
        for fn in self.wrappers.values():
            fn.launches = 0

    def read(self, expect):
        """The counts since entry; fails unless they are ``expect`` (0 for a
        kernel it does not name)."""
        counts = {kid: fn.launches for kid, fn in self.wrappers.items()}
        if any(count != expect.get(kid, 0) for kid, count in counts.items()):
            fail(f"{self.path}: kernel launches {counts}, expected {expect}")
        for kid, count in counts.items():
            self.report[kid].setdefault("launches_by_path", {})[self.path] = count
        return counts


def blocky_images(rng, n: int):
    """Seeded 180x240 uint8 images of 15x15-pixel random blocks."""
    return rng.integers(0, 256, (n, 12, 16, 3), dtype="uint8").repeat(15, 1).repeat(15, 2)


def phase_serve(torch, np, report, shared):
    from soft_contrastive_learning_torch.perf import common
    from soft_contrastive_learning_torch.core.config import ModelConfig
    from soft_contrastive_learning_torch.models.model import EmbeddingNet
    from soft_contrastive_learning_torch.models.weights import load_trained_params
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

    counts = LaunchCounts(report, "serve")
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
    # 8 batches of index images and one of queries through K1, one streamed search
    launches = counts.read({"K1": 9, "K2": 1, "K3": 0, "K4": 0})
    print(f"serve: embedded {len(descs)} + searched {len(query_imgs)} images over "
          f"{n_rows} x {dim} in {time.perf_counter() - t0:.1f} s; launches {launches}")

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
    shared.update(params=params, index_imgs=index_imgs, descs=descs, fp32_ref=ref.cpu().numpy(),
                  service=service)
    cos_bf16 = (served * ref).sum(1).min().item()
    cos_k1 = (via_k1 * ref).sum(1).min().item()
    print(f"serve: cosine to the fp32 plain model: served bf16 {cos_bf16:.6f}, "
          f"fp32 with K1 {cos_k1:.8f}")
    if cos_bf16 < 0.99 or cos_k1 < 0.99999:
        fail(f"descriptors disagree with the fp32 plain model ({cos_bf16}, {cos_k1})")

    # embed throughput at batch 64: end to end through the service, and the
    # model alone on the card
    batch = torch.from_numpy(index_imgs[:64]).cuda()
    embed_ms = common.time_ms(lambda: service.extractor._embed(batch), 20)
    t0 = time.perf_counter()
    service.embed(index_imgs)
    e2e_s = time.perf_counter() - t0
    report["serve"] = dict(embed_img_s=512 / e2e_s, model_img_s=64e3 / embed_ms,
                           model_ms_per_batch64=embed_ms)
    print(f"serve: embed {512 / e2e_s:.1f} img/s end to end (service.embed, 512 images), "
          f"model alone {64e3 / embed_ms:.1f} img/s ({embed_ms:.3f} ms per batch of 64)")


def phase_serve_winograd(torch, np, report, shared):
    """The flagship with ``winograd=True`` through DescriptorService.embed
    on the standard phase's 512 images: K4 on 10 of the 13 convs."""
    from soft_contrastive_learning_torch.perf import common
    from soft_contrastive_learning_torch.core.config import ModelConfig
    from soft_contrastive_learning_torch.serving import DescriptorService

    cfg = ModelConfig(winograd=True)
    imgs, standard = shared["index_imgs"], shared["service"]
    counts = LaunchCounts(report, "serve_winograd")
    service = DescriptorService(cfg, shared["params"], batch_size=64)
    t0 = time.perf_counter()
    descs = service.embed(imgs)
    e2e_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    batches = len(imgs) // 64
    launches = counts.read({"K1": batches, "K2": 0, "K3": 0, "K4": 10 * batches})
    if descs.shape != shared["descs"].shape or not np.isfinite(descs).all():
        fail(f"serve_winograd: descriptors of shape {descs.shape} or non-finite")
    cos_std = (descs * shared["descs"]).sum(1).min()
    cos_fp32 = (descs[:8] * shared["fp32_ref"]).sum(1).min()
    print(f"serve_winograd: {len(imgs)} images, launches {launches}; cosine to the standard bf16 "
          f"model {cos_std:.6f}, to the fp32 plain model {cos_fp32:.6f}")
    if cos_std < 0.999 or cos_fp32 < 0.99:
        fail(f"serve_winograd: descriptors part from the standard configuration's "
             f"({cos_std}, {cos_fp32})")
    # model alone at batch 64, the two configurations in turns
    batch = torch.from_numpy(imgs[:64]).cuda()
    turns = {"winograd": [], "standard": []}
    runs = {"winograd": service, "standard": standard}
    for name in ("winograd", "standard", "standard", "winograd"):
        turns[name].append(common.time_ms(lambda: runs[name].extractor._embed(batch), 10))
    ms = {name: statistics.mean(t) for name, t in turns.items()}
    report["serve_winograd"] = dict(
        embed_img_s=len(imgs) / e2e_s, model_img_s=64e3 / ms["winograd"],
        model_ms_per_batch64=ms["winograd"], standard_model_ms_per_batch64=ms["standard"],
        standard_model_img_s=64e3 / ms["standard"], cos_to_standard=float(cos_std),
        cos_to_fp32=float(cos_fp32))
    print(f"serve_winograd: embed {len(imgs) / e2e_s:.1f} img/s end to end; model alone "
          f"{64e3 / ms['winograd']:.1f} img/s ({ms['winograd']:.3f} ms per batch of 64) against "
          f"the standard configuration's {64e3 / ms['standard']:.1f} img/s "
          f"({ms['standard']:.3f} ms) in the same turns")
    del shared["service"]


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
    from soft_contrastive_learning_torch.perf import common
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
        # no atomics: the same bits twice
        if not torch.equal(wms_loss_cuda(geo, emb, 0.8, 15.0, beta=beta),
                           wms_loss_cuda(geo, emb, 0.8, 15.0, beta=beta)):
            fail(f"K3 B={b} D={d}: two runs give different bits")
    b, d = 50, 32768
    geo, emb = wms_inputs(torch, np, b, d, SEED + b)
    ms = common.time_ms(lambda: wms_loss_cuda(geo, emb, 0.8, 15.0), 200)
    host_ms, device_ms = common.host_and_device_ms(lambda: wms_loss_cuda(geo, emb, 0.8, 15.0),
                                                   200)
    plain_ms = common.time_ms(lambda: wms_loss(geo, emb, 0.8, 15.0), 200)

    def fwd_bwd(fn):
        e = emb.clone().requires_grad_()
        return torch.autograd.grad(fn(geo, e, 0.8, 15.0), e)

    turns = {"fused": [], "plain": []}
    for name in ("fused", "plain", "plain", "fused"):
        fn = wms_loss_fused if name == "fused" else wms_loss
        turns[name].append(common.time_ms(lambda: fwd_bwd(fn), 50))
    fwd_bwd_ms = {name: statistics.mean(t) for name, t in turns.items()}
    # the Gram is symmetric: B (B + 1) / 2 dot products of D; emb and geo
    # read once, one float written
    bound_ms, bound_by = common.bound_ms(b * (b + 1) * d, 4 * (b * d + b * b) + 4)
    print(f"K3 B={b} D={d}: kernel {ms:.4f} ms a call back to back (device {device_ms:.4f} ms, "
          f"host {host_ms:.4f} ms), plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
          f"({bound_by}); forward + backward through WmsLossFn {fwd_bwd_ms['fused']:.4f} ms, "
          f"plain autograd {fwd_bwd_ms['plain']:.4f} ms")
    report["K3"] = dict(
        name="wms_loss", route="cuda",
        source="soft_contrastive_learning_torch/ops/kernels/csrc/wms.cu",
        replaces="soft_contrastive_learning_tpu/ops/pallas/wms_kernel.py:27",
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
        library_ms=None, device_ms=device_ms, host_ms=host_ms,
        fwd_bwd_ms=fwd_bwd_ms["fused"], plain_fwd_bwd_ms=fwd_bwd_ms["plain"])


def phase_k1_backward(torch, report):
    """K1's backward kernel against the closed form it implements and
    against plain autograd; VladAggregateFn (both kernels) timed against
    plain autograd in turns."""
    from soft_contrastive_learning_torch.perf import common
    from soft_contrastive_learning_torch.ops.kernels.netvlad import (
        VladAggregateFn, netvlad_backward_cuda, vlad_aggregate, vlad_aggregate_backward)

    b, n, d, k = 50, 165, 512, 64
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    g = torch.randn((b, d * k), generator=gen, device="cuda")

    def grads(fn, x, logits, centers):
        ins = [t.clone().requires_grad_() for t in (x, logits, centers)]
        return torch.autograd.grad(fn(*ins), ins, g)

    worst = 0.0
    for logit_dtype in (torch.bfloat16, torch.float32):
        x, logits, centers = vlad_inputs(torch, b, SEED + 3, logit_dtype)
        ins = [t.clone().requires_grad_() for t in (x, logits, centers)]
        out = VladAggregateFn.apply(*ins)
        scales = out.grad_fn.saved_tensors[4]
        kernel = netvlad_backward_cuda(x, logits, centers, out.detach(), scales, g)
        again = netvlad_backward_cuda(x, logits, centers, out.detach(), scales, g)
        closed = vlad_aggregate_backward(x, logits, centers, g)
        via_fn = grads(VladAggregateFn.apply, x, logits, centers)
        autograd = grads(vlad_aggregate, x, logits, centers)
        torch.cuda.synchronize()
        if not all(torch.equal(p, q) for p, q in zip(kernel, again)):
            fail(f"K1 backward ({logit_dtype}): two runs give different bits")
        if not all(torch.equal(p, q) for p, q in zip(kernel, via_fn)):
            fail(f"K1 backward ({logit_dtype}): VladAggregateFn differs from its kernel")
        if [t.dtype for t in kernel] != [torch.float32, logit_dtype, torch.float32]:
            fail(f"K1 backward: gradient dtypes {[t.dtype for t in kernel]}")
        line = []
        for label, ref in (("closed form", closed), ("plain autograd", autograd)):
            rel = [(a.float() - r.float()).abs().max().item()
                   / max(1.0, r.float().abs().max().item()) for a, r in zip(kernel, ref)]
            bf16 = logit_dtype == torch.bfloat16
            floor = 1e-6 * max(1.0, ref[1].float().abs().max().item())
            steps = bf16_steps(torch, kernel[1], ref[1], floor) if bf16 else 0.0
            fp32_gates = [rel[0], rel[2]] + ([] if bf16 else [rel[1]])
            if max(fp32_gates) > 1e-6 or steps > 1.0 or not all(
                    torch.isfinite(t).all() for t in kernel):
                fail(f"K1 backward ({logit_dtype}) vs {label}: x {rel[0]:.3g}, logits "
                     f"{rel[1]:.3g} ({steps:.2f} bf16 steps), centers {rel[2]:.3g}")
            line.append(f"vs {label}: x {rel[0]:.3g}, logits {rel[1]:.3g}"
                        + (f" ({steps:.2f} bf16 steps)" if bf16 else "")
                        + f", centers {rel[2]:.3g}")
            worst = max(worst, *fp32_gates)
        print(f"K1 backward B={b} N={n} D={d} K={k} logits={logit_dtype}: max-abs over "
              f"max(1, max|ref|) " + "; ".join(line) + "; same bits twice")

    x, logits, centers = vlad_inputs(torch, b, SEED + 3)
    ins = [t.clone().requires_grad_() for t in (x, logits, centers)]
    out = VladAggregateFn.apply(*ins)
    scales = out.grad_fn.saved_tensors[4]
    y = out.detach()
    ms = common.time_ms(lambda: netvlad_backward_cuda(x, logits, centers, y, scales, g), 50)
    host_ms, device_ms = common.host_and_device_ms(
        lambda: netvlad_backward_cuda(x, logits, centers, y, scales, g), 50)
    plain_ms = common.time_ms(lambda: vlad_aggregate_backward(x, logits, centers, g), 20)
    turns = {"fn": [], "plain": []}
    for name in ("fn", "plain", "plain", "fn"):
        fn = VladAggregateFn.apply if name == "fn" else vlad_aggregate
        turns[name].append(common.time_ms(lambda: grads(fn, x, logits, centers), 20))
    fwd_bwd_ms = {name: statistics.mean(t) for name, t in turns.items()}
    # two products of the forward's size (dx = a dV^T, da = x dV); x, logits,
    # centers, y, dy and the scales read once, dx, ds and dC written once
    nbytes = (2 * 4 * b * n * d + 2 * 2 * b * n * k + 2 * 4 * d * k + 2 * 4 * b * d * k
              + 4 * b * (k + 1))
    bound_ms, bound_by = common.bound_ms(4 * b * n * k * d, nbytes)
    print(f"K1 backward kernel B={b}: {ms:.4f} ms a call (device {device_ms:.4f}, host "
          f"{host_ms:.4f}), closed form in PyTorch {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
          f"({bound_by}); forward + backward through VladAggregateFn {fwd_bwd_ms['fn']:.4f} ms, "
          f"plain autograd {fwd_bwd_ms['plain']:.4f} ms (in turns)")
    if fwd_bwd_ms["fn"] >= fwd_bwd_ms["plain"]:
        print("K1 forward + backward: NOT faster than plain autograd in these turns")
    from torch.profiler import ProfilerActivity, profile

    grads(VladAggregateFn.apply, x, logits, centers)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            grads(VladAggregateFn.apply, x, logits, centers)
        torch.cuda.synchronize()
    print("K1 forward + backward through VladAggregateFn, 5 calls profiled:")
    print(prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=12,
                                    max_name_column_width=50))
    report["K1_bwd"] = dict(
        name="netvlad_aggregate_backward", route="cuda",
        source="soft_contrastive_learning_torch/ops/kernels/csrc/netvlad.cu",
        replaces="soft_contrastive_learning_tpu/ops/pallas/netvlad_kernel.py:110",
        max_abs_err=worst, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
        library_ms=None, device_ms=device_ms, host_ms=host_ms)
    report["K1_backward"] = dict(max_rel_err=worst, fwd_bwd_ms=fwd_bwd_ms["fn"],
                                 plain_fwd_bwd_ms=fwd_bwd_ms["plain"])


# The flagship's Winograd layers at 180x240: (layers, H, W, C, F, fused ReLU
# of the first of them); conv3_3, conv4_3 and conv5_3 have the shapes of
# conv3_2, conv4_2 and conv5_1 without the ReLU.
K4_LAYERS = (
    (("conv2_2",), 90, 120, 128, 128, False),
    (("conv3_1",), 45, 60, 128, 256, True),
    (("conv3_2", "conv3_3"), 45, 60, 256, 256, True),
    (("conv4_1",), 22, 30, 256, 512, True),
    (("conv4_2", "conv4_3"), 22, 30, 512, 512, True),
    (("conv5_1", "conv5_2", "conv5_3"), 11, 15, 512, 512, True),
)
K4_ODD = ((2, 11, 15, 256, 128), (2, 9, 9, 128, 64), (2, 45, 60, 128, 64))


def k4_inputs(torch, b, h, w, c, f, seed):
    """Seeded NHWC bf16 activations, an OIHW fp32 weight at lecun scale and
    an fp32 bias, on the card."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((b, h, w, c), generator=gen, device="cuda").bfloat16()
    weight = torch.randn((f, c, 3, 3), generator=gen, device="cuda") / (9 * c) ** 0.5
    bias = 0.1 * torch.randn((f,), generator=gen, device="cuda")
    return x, weight, bias


def bf16_steps(torch, got, want, floor):
    """The largest |got - want| in units of max(the bf16 step at |want|
    (2^-8 relative), ``floor``): at most 1 when every entry is within one
    bf16 step, or within the fp32 gate ``floor`` where the bf16 grid is
    finer than that."""
    w = want.float()
    _, e = torch.frexp(w.abs().clamp_min(1e-30))
    unit = torch.clamp(torch.ldexp(torch.ones_like(w), e - 8), min=floor)
    return ((got.float() - w).abs() / unit).max().item()


def bf16_steps_ok(torch, got, want, floor):
    """The share of elements within one bf16 step of ``want``, and whether
    all are within two.
    Where the bf16 grid is finer than ``floor`` (the fp32 gate: the two
    versions' fp32 sums differ by that much before the cast) the floor is
    the tolerance."""
    g, w = got.float(), want.float()
    _, e = torch.frexp(w.abs().clamp_min(1e-30))
    step = torch.ldexp(torch.ones_like(w), e - 8)  # bf16 spacing at |want|
    diff = (g - w).abs()
    one = (diff <= torch.maximum(step, floor)).sum().item() / diff.numel()
    two = (diff <= torch.maximum(2 * step, floor)).all().item()
    return one, two


def phase_k4(torch, report):
    import torch.nn.functional as F

    from soft_contrastive_learning_torch.perf import common
    from soft_contrastive_learning_torch.ops.kernels.winograd import (
        weight_transform_cuda, winograd_conv_cuda)
    from soft_contrastive_learning_torch.ops.winograd import weight_transform, winograd_conv_plain

    def check(label, x, weight, bias):
        """K4 against its plain version (ReLU on and off, fp32 and bf16
        output), twice for the same bits, and against fp32 cuDNN (TF32 off);
        its weight transform against the plain one, bit for bit."""
        if not torch.equal(weight_transform_cuda(weight), weight_transform(weight).bfloat16()):
            fail(f"K4 {label}: the transformed filter differs from the plain version's")
        worst = 0.0
        for relu in (False, True):
            want = winograd_conv_plain(x, weight, bias, relu=relu, out_dtype=torch.float32)
            got = winograd_conv_cuda(x, weight, bias, relu=relu, out_dtype=torch.float32)
            again = winograd_conv_cuda(x, weight, bias, relu=relu, out_dtype=torch.float32)
            torch.cuda.synchronize()
            scale = want.abs().max().item()
            e = (got - want).abs().max().item()
            if got.shape != want.shape or not torch.isfinite(got).all() or e > 1e-4 * scale:
                fail(f"K4 {label} relu={relu} fp32: max-abs {e} vs plain (scale {scale})")
            if not torch.equal(got, again):
                fail(f"K4 {label} relu={relu}: two runs differ")
            direct = F.conv2d(x.float().permute(0, 3, 1, 2), weight, bias, padding=1)
            direct = (F.relu(direct) if relu else direct).permute(0, 2, 3, 1)
            rel = (got - direct).abs().max().item() / direct.abs().max().item()
            if rel >= 0.02:
                fail(f"K4 {label} relu={relu}: {rel} relative to the fp32 direct conv")
            want16 = winograd_conv_plain(x, weight, bias, relu=relu)
            got16 = winograd_conv_cuda(x, weight, bias, relu=relu)
            floor = torch.tensor(1e-4 * scale, device="cuda")
            one, two = bf16_steps_ok(torch, got16, want16, floor)
            if got16.dtype != torch.bfloat16 or one < 0.999 or not two:
                fail(f"K4 {label} relu={relu} bf16: {one:.6f} within one step, all within "
                     f"two: {two}")
            print(f"K4 {label} relu={relu}: fp32 max-abs {e:.3g} (scale {scale:.3g}), vs fp32 "
                  f"cuDNN rel {rel:.3g}; bf16 within one step {one:.6f}, all within two; "
                  "same bits twice")
            worst = max(worst, e)
        return worst

    err = 0.0
    for seed, (b, h, w, c, f) in enumerate(K4_ODD):
        err = max(err, check(f"B={b} {h}x{w} {c}->{f}", *k4_inputs(torch, b, h, w, c, f, seed)))

    per_shape = []
    for seed, (names, h, w, c, f, relu) in enumerate(K4_LAYERS):
        row = dict(layers=list(names), h=h, w=w, c=c, f=f)
        for b in (64, 50):  # serving and training batch
            x, weight, bias = k4_inputs(torch, b, h, w, c, f, 100 + seed)
            # at B = 50 conv3 (34,500 tiles) and conv4 (8,250) end in a ragged block
            err = max(err, check(f"B={b} {names[0]} {h}x{w} {c}->{f}", x, weight, bias))
            x_nchw, w16, b16 = x.permute(0, 3, 1, 2), weight.bfloat16(), bias.bfloat16()

            def library():
                y = F.conv2d(x_nchw, w16, b16, padding=1)
                return F.relu(y) if relu else y

            ms = common.time_ms(lambda: winograd_conv_cuda(x, weight, bias, relu=relu), 20)
            library_ms = common.time_ms(library, 20)
            plain_ms = common.time_ms(lambda: winograd_conv_plain(x, weight, bias, relu=relu), 3)
            # the wrapper's first launch, inside ms: U = bf16(G w G^T)
            transform_ms = common.time_ms(lambda: weight_transform_cuda(weight), 20)
            tiles = b * -(-h // 2) * -(-w // 2)
            bound_ms, bound_by = common.bound_ms(
                2 * 16 * tiles * c * f, 2 * (b * h * w * c + b * h * w * f) + 2 * 16 * c * f,
                common.BF16_FLOPS)
            row[f"B{b}"] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                                bound_ms=bound_ms, bound_by=bound_by, transform_ms=transform_ms)
            print(f"K4 B={b} {'/'.join(names)} {h}x{w} {c}->{f}: kernel {ms:.4f} ms (of which "
                  f"the weight transform {transform_ms:.4f}), cuDNN {library_ms:.4f} ms, plain "
                  f"{plain_ms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by})")
            del x, weight, bias, x_nchw
            torch.cuda.empty_cache()
        per_shape.append(row)

    def forward_sum(b, key):  # over the 10 launches of one forward
        return sum(len(r["layers"]) * r[f"B{b}"][key] for r in per_shape)

    ops_ms = sum(len(r["layers"]) * r["B64"]["bound_ms"] for r in per_shape
                 if r["B64"]["bound_by"] == "operations")
    for b in (64, 50):
        print(f"K4 forward of 10 launches at B={b}: kernel {forward_sum(b, 'ms'):.3f} ms (weight "
              f"transforms {forward_sum(b, 'transform_ms'):.3f}), cuDNN "
              f"{forward_sum(b, 'library_ms'):.3f} ms, plain {forward_sum(b, 'plain_ms'):.2f} ms, "
              f"bound {forward_sum(b, 'bound_ms'):.3f} ms")
    report["K4"] = dict(
        name="winograd_conv", route="cuda",
        source="soft_contrastive_learning_torch/ops/kernels/csrc/winograd.cu",
        replaces="soft_contrastive_learning_tpu/ops/pallas/winograd_kernel.py:46",
        max_abs_err=err, ms=forward_sum(64, "ms"), plain_ms=forward_sum(64, "plain_ms"),
        bound_ms=forward_sum(64, "bound_ms"),
        bound_by="operations" if 2 * ops_ms >= forward_sum(64, "bound_ms") else "bytes",
        library_ms=forward_sum(64, "library_ms"), per_shape=per_shape,
        forward_B50=dict(ms=forward_sum(50, "ms"), plain_ms=forward_sum(50, "plain_ms"),
                         bound_ms=forward_sum(50, "bound_ms"),
                         library_ms=forward_sum(50, "library_ms")))


def phase_k4_backward(torch, report):
    from soft_contrastive_learning_torch.perf import common
    from soft_contrastive_learning_torch.ops.kernels.winograd import WinogradConvFn, direct_conv

    out = {}
    for name, h, w, c, f, relu in (("conv4_2", 22, 30, 512, 512, True),
                                   ("conv2_2", 90, 120, 128, 128, False)):
        b = 50
        x, weight, bias = k4_inputs(torch, b, h, w, c, f, 200 + h)

        def grads(fn):
            ins = [t.clone().requires_grad_() for t in (x, weight, bias)]
            return torch.autograd.grad((fn(*ins, relu).float() ** 2).sum(), ins)

        got, want = grads(WinogradConvFn.apply), grads(direct_conv)
        torch.cuda.synchronize()
        rels = [(a.float() - r.float()).abs().max().item() / max(r.float().abs().max().item(), 1e-3)
                for a, r in zip(got, want)]
        print(f"K4 backward B={b} {name} relu={relu}: grad rel max-abs x {rels[0]:.3g}, "
              f"weight {rels[1]:.3g}, bias {rels[2]:.3g} vs autograd of the direct bf16 conv")
        # the cotangent 2y comes from the Winograd forward, a little off the
        # direct conv's: 0.05 of each gradient's largest entry
        if [g.dtype for g in got] != [torch.bfloat16, torch.float32, torch.float32] \
                or max(rels) >= 0.05:
            fail(f"WinogradConvFn gradients disagree with the direct conv's at {name}: {rels}")
        fn_ms = common.time_ms(lambda: grads(WinogradConvFn.apply), 10)
        plain_ms = common.time_ms(lambda: grads(direct_conv), 10)
        print(f"K4 forward+backward B={b} {name}: through WinogradConvFn {fn_ms:.4f} ms, plain "
              f"autograd of the cuDNN conv {plain_ms:.4f} ms")
        out[name] = dict(max_rel_err=max(rels), fwd_bwd_ms=fn_ms, plain_fwd_bwd_ms=plain_ms)
    report["K4_backward"] = out


def phase_probe_gemm(torch, report):
    """The probes' product kernel against ``probe_gemm_plain``, then its
    times beside ``torch.matmul`` / ``torch._int_mm`` and the bound.

    Exact gate, at every problem the probe scripts launch (the resident
    shapes and the blocked problem of perf/mxu_probe.py, the large problem of
    perf/mxu_probe2.py and mxu_probe4.py, the eight of perf/matmul_probe.py,
    batched, unrolled and single; 240 and 360 rows end in a ragged tile),
    with the tile shape the wrapper chooses and with every tile shape that
    divides the problem, for bf16 -> fp32, bf16 -> bf16 and int8 -> int32:
    operands that are multiples of 1/8 in [-1, 1] (bf16) or any int8 values
    make every product and every partial sum exact, so kernel and plain
    version must agree to the last bit whatever the order of the K loop.
    Tolerance gate on seeded normals: fp32 results within 1e-3 sqrt(K)
    max|a| max|b| (two fp32 summation orders), bf16 results within one bf16
    step of the plain version's (or, where the bf16 grid is finer than that,
    within twice the measured difference of the two fp32 results, of which
    they are the roundings)."""
    from soft_contrastive_learning_torch.ops.kernels.probe_gemm import (
        CONFIGS, probe_gemm, probe_gemm_plain)
    from soft_contrastive_learning_torch.perf import common, matmul_probe, mxu_probe, mxu_probe2

    gen = torch.Generator(device="cuda").manual_seed(SEED + 10)

    def exact_operands(shape_a, shape_b, dtype):
        if dtype == torch.int8:
            return common.operands(shape_a, shape_b, dtype, torch.device("cuda"), SEED + 11)
        return tuple((torch.randint(-8, 9, sh, generator=gen, device="cuda").float() / 8)
                     .bfloat16() for sh in (shape_a, shape_b))

    def shapes(z, m, k, n):
        return ((m, k), (k, n)) if z == 1 else ((z, m, k), (z, k, n))

    m, k, n = mxu_probe2.M, mxu_probe2.K, mxu_probe2.N
    # (batch, M, K, N, one launch per batch entry), each once
    problems = list(dict.fromkeys(
        [(1, rm, rk, rn, False) for rm, rk, rn, _ in mxu_probe.RESIDENT]
        + [(1, *mxu_probe.BLOCKED, False), (1, m, k, n, False)]
        + [(pz, pm, pk, pn, mode == "unrolled") for mode, pz, pm, pk, pn in matmul_probe.SHAPES]))
    checks = 0
    for z, pm, pk, pn, unrolled in problems:
        for in_dtype, out_dtypes in ((torch.bfloat16, (torch.float32, torch.bfloat16)),
                                     (torch.int8, (torch.int32,))):
            tiles = CONFIGS[in_dtype]
            configs = [None] + [c for c in range(len(tiles))
                                if pn % tiles[c][1] == 0 and pk % tiles[c][2] == 0]
            a, b = exact_operands(*shapes(z, pm, pk, pn), in_dtype)
            for out_dtype in out_dtypes:
                want = probe_gemm_plain(a, b, out_dtype)
                for config in configs:
                    if unrolled:
                        got = torch.stack([probe_gemm(a[i], b[i], out_dtype, config)
                                           for i in range(z)])
                    else:
                        got = probe_gemm(a, b, out_dtype, config)
                    torch.cuda.synchronize()
                    if got.dtype != out_dtype or not torch.equal(got, want):
                        fail(f"probe_gemm {in_dtype}->{out_dtype} config {config} batch {z}"
                             f"{' unrolled' if unrolled else ''} ({pm},{pk})@({pk},{pn}): "
                             f"{(got != want).sum().item()} elements differ from the plain "
                             "version")
                    checks += 1
                del want, got
            del a, b
    print(f"P_gemm exact inputs: {checks} comparisons bit-equal to the plain version at the "
          f"{len(problems)} problems of the probe scripts (chosen and every dividing tile shape; "
          "bf16->fp32, bf16->bf16 on wgmma, int8->int32 on mma.sync; ragged rows, batch 16 and "
          "unrolled included)")

    err = 0.0
    for z, pm, pk, pn in [(1, m, k, n)] + [s[1:] for s in matmul_probe.SHAPES
                                           if s[0] == "batched"]:
        a, b = common.operands(*shapes(z, pm, pk, pn), torch.bfloat16, torch.device("cuda"),
                               SEED + 12)
        tol = 1e-3 * pk ** 0.5 * a.float().abs().max().item() * b.float().abs().max().item()
        want = probe_gemm_plain(a, b, torch.float32)
        got = probe_gemm(a, b, torch.float32)
        e = (got - want).abs().max().item()
        if not (e <= tol and torch.isfinite(got).all()):
            fail(f"probe_gemm bf16->fp32 on normals, batch {z} ({pm},{pk})@({pk},{pn}): "
                 f"max-abs {e} > {tol}")
        one, two = bf16_steps_ok(torch, probe_gemm(a, b, torch.bfloat16),
                                 probe_gemm_plain(a, b, torch.bfloat16),
                                 torch.tensor(2 * e, device="cuda"))
        if one < 1.0:
            fail(f"probe_gemm bf16->bf16 on normals, batch {z} ({pm},{pk})@({pk},{pn}): only "
                 f"{one:.6f} of the elements within one bf16 step")
        print(f"P_gemm normals batch {z} ({pm},{pk})@({pk},{pn}): fp32 max-abs {e:.3g} (gate "
              f"{tol:.3g}); bf16 all within one step")
        err = max(err, e)
        del a, b, want, got

    # times: the large problem per tile shape in bf16 and int8, each beside
    # its control, then the eight Winograd product shapes
    args = SimpleNamespace(device=torch.device("cuda"), reps=5, seed=SEED)
    rows = {}
    for in_dtype, out_dtype, key in ((torch.bfloat16, torch.bfloat16, "bf16"),
                                     (torch.int8, torch.int32, "int8")):
        a, b = common.operands((m, k), (k, n), in_dtype, args.device, SEED)
        control_ms = common.control_gemm_ms(a, b, args.reps)
        rows[key] = [common.gemm_row(args, f"P_gemm {key} ({m},{k})@({k},{n})", a, b, out_dtype,
                                     config, control_ms)
                     for config in range(len(CONFIGS[in_dtype]))]
        if key == "bf16":
            plain_ms = common.time_ms(lambda: probe_gemm_plain(a, b, out_dtype), 2)
        del a, b
    args.reps = 50
    rows["products"] = []
    for mode, z, pm, pk, pn in matmul_probe.SHAPES:
        a, b = common.operands(*shapes(1 if mode == "single" else z, pm, pk, pn), torch.bfloat16,
                               args.device, SEED)
        rows["products"].append(common.gemm_row(
            args, f"P_gemm {mode}{z if z > 1 else ''} ({pm},{pk})@({pk},{pn})", a, b,
            torch.float32, None, common.control_gemm_ms(a, b, args.reps),
            unrolled=mode == "unrolled"))
    best = min(rows["bf16"], key=lambda r: r["ms"])
    print(f"P_gemm ({m},{k})@({k},{n}) bf16: best tile {best['label']} {best['ms']:.4f} ms = "
          f"{best['rate']:.1f} TFLOP/s, torch.matmul {best['control_ms']:.4f} ms, plain (fp32 "
          f"matmul + cast) {plain_ms:.3f} ms, bound {best['bound_ms']:.4f} ms")
    report["P_gemm"] = dict(
        name="probe_gemm", route="cuda",
        source="soft_contrastive_learning_torch/ops/kernels/csrc/probe_gemm.cu",
        replaces="perf/mxu_probe.py:58 perf/mxu_probe.py:90 perf/mxu_probe2.py:60 "
                 "perf/mxu_probe3.py:37 perf/mxu_probe4.py:42 perf/matmul_probe.py:66",
        max_abs_err=err, ms=best["ms"], plain_ms=plain_ms, bound_ms=best["bound_ms"],
        bound_by=best["bound_by"], library_ms=best["control_ms"], rows=rows)
    torch.cuda.empty_cache()


def phase_winograd_ablate(torch, report):
    """K4 cut short at each stage against ``winograd_stage_plain``: conv2_2
    and conv4_2 at B=64, conv4_2 at B=50 (8,250 tiles: a ragged last block)
    and the ablation's own problem, conv2_2 at B=256. The checksums of
    ``dma`` and ``transform`` are integer sums and must be equal; ``matmul``
    within 1e-4 of the largest entry on normals (two fp32 summation orders)
    and bit-equal on inputs whose sums are exact; ``full`` through the stage
    entry bit-equal to ``winograd_conv_cuda`` and within K4's gate of the
    plain version. Then the four stage times at the six layer shapes of the
    flagship at B=64."""
    from soft_contrastive_learning_torch.ops.kernels.winograd import (
        winograd_conv_cuda, winograd_stage)
    from soft_contrastive_learning_torch.ops.winograd import STAGES, winograd_stage_plain
    from soft_contrastive_learning_torch.perf import common, winograd_ablate

    layers = winograd_ablate.FLAGSHIP_LAYERS
    err = 0.0
    for seed, (name, b) in enumerate((("conv2_2", 64), ("conv4_2", 64), ("conv4_2", 50),
                                      ("conv2_2", 256))):
        h, w, c, f = layers[name]
        x, weight, bias = k4_inputs(torch, b, h, w, c, f, 300 + seed)
        for stage in (0, 1):
            got = winograd_stage(stage, x, weight)
            want = winograd_stage_plain(stage, x, weight)
            torch.cuda.synchronize()
            if got.shape != want.shape or not torch.equal(got, want):
                fail(f"P6 {STAGES[stage]} B={b} {name}: {(got != want).sum().item()} of "
                     f"{want.numel()} block checksums differ from the plain version")
        got, want = winograd_stage(2, x, weight), winograd_stage_plain(2, x, weight)
        scale = want.abs().max().item()
        e = (got - want).abs().max().item()
        if got.shape != want.shape or not e <= 1e-4 * scale:
            fail(f"P6 matmul B={b} {name}: max-abs {e} vs plain (scale {scale})")
        # exact sums: activations in eighths, weights in halves (U in eighths)
        gen = torch.Generator(device="cuda").manual_seed(400 + seed)
        xe = (torch.randint(-8, 9, x.shape, generator=gen, device="cuda").float() / 8).bfloat16()
        we = torch.randint(-2, 3, weight.shape, generator=gen, device="cuda").float() / 2
        if not torch.equal(winograd_stage(2, xe, we), winograd_stage_plain(2, xe, we)):
            fail(f"P6 matmul B={b} {name}: differs from the plain version on exact inputs")
        del xe, we
        full = winograd_stage(3, x, weight, bias, relu=True, out_dtype=torch.float32)
        if not torch.equal(full, winograd_conv_cuda(x, weight, bias, relu=True,
                                                    out_dtype=torch.float32)):
            fail(f"P6 full B={b} {name}: the stage entry differs from winograd_conv_cuda")
        worst = 0.0
        for s0 in range(0, b, 64):  # the plain version in batches of 64: it holds 16 fp32 V
            want = winograd_stage_plain(3, x[s0 : s0 + 64], weight, bias, relu=True,
                                        out_dtype=torch.float32)
            ef = (full[s0 : s0 + 64] - want).abs().max().item()
            if not ef <= 1e-4 * want.abs().max().item():
                fail(f"P6 full B={b} {name}: max-abs {ef} vs plain")
            worst = max(worst, ef)
            del want
        print(f"P6 B={b} {name}: dma and transform checksums equal; matmul max-abs {e:.3g} "
              f"(scale {scale:.3g}) and bit-equal on exact inputs; full bit-equal to K4's "
              f"wrapper, max-abs {worst:.3g} vs plain")
        err = max(err, e, worst)
        del x, weight, bias, got, full
        torch.cuda.empty_cache()

    args = SimpleNamespace(device=torch.device("cuda"), reps=20, seed=SEED)
    per_layer = {}
    for name, (h, w, c, f) in layers.items():
        print(f"P6 stage times B=64 {name} {h}x{w} {c}->{f}")
        per_layer[name] = winograd_ablate.run(args, 64, h, w, c, f)
    # the ablation's own problem for the kernels line
    h, w, c, f = layers["conv2_2"]
    print(f"P6 stage times B=256 conv2_2 {h}x{w} {c}->{f}")
    own = winograd_ablate.run(args, 256, h, w, c, f)
    x, weight, bias = k4_inputs(torch, 256, h, w, c, f, 300)

    def plain():  # in batches of 64, as it was held above
        for s0 in range(0, 256, 64):
            winograd_stage_plain(3, x[s0 : s0 + 64], weight, bias, relu=True)

    plain_ms = common.time_ms(plain, 1)
    report["P6_stages"] = dict(
        name="winograd_stages", route="cuda",
        source="soft_contrastive_learning_torch/ops/kernels/csrc/winograd.cu",
        replaces="perf/winograd_ablate.py:109",
        max_abs_err=err, ms=own[3]["ms"], plain_ms=plain_ms, bound_ms=own[3]["bound_ms"],
        bound_by=own[3]["bound_by"], library_ms=own[3]["control_ms"],
        stages_B256_conv2_2=own, stages_B64=per_layer)
    del x, weight, bias
    torch.cuda.empty_cache()


def phase_probes(torch, report):
    """The probe scripts as a user runs them, at their own problems: each
    must launch its kernel once per timed call and once to warm up, for
    every row it prints."""
    from soft_contrastive_learning_torch.ops.kernels.probe_gemm import CONFIGS
    from soft_contrastive_learning_torch.perf import (
        matmul_probe, mxu_probe, mxu_probe2, mxu_probe4, winograd_ablate)

    # (script, --reps, rows by kernel); the full stage is K4 itself, and an
    # unrolled row is a launch per batch entry
    product_rows = sum(z if mode == "unrolled" else 1 for mode, z, *_ in matmul_probe.SHAPES)
    bf16, int8 = len(CONFIGS[torch.bfloat16]), len(CONFIGS[torch.int8])
    scripts = ((mxu_probe, 10, {"P_gemm": len(mxu_probe.RESIDENT) + bf16}),
               (mxu_probe2, 3, {"P_gemm": bf16}),
               (mxu_probe4, 3, {"P_gemm": int8 + bf16}),
               (matmul_probe, 20, {"P_gemm": product_rows}),
               (winograd_ablate, 10, {"P6_stages": 3, "K4": 1}))
    counts = LaunchCounts(report, "probes")
    t0 = time.perf_counter()
    total = dict.fromkeys(KERNEL_IDS, 0)
    for module, reps, rows in scripts:
        name = module.__name__.rsplit(".", 1)[1]
        before = {kid: fn.launches for kid, fn in counts.wrappers.items()}
        print(f"probes: {name} --reps {reps}")
        if module.main(["--reps", str(reps)]) != 0:
            fail(f"probes: {name} did not return 0")
        torch.cuda.synchronize()
        launched = {kid: fn.launches - before[kid] for kid, fn in counts.wrappers.items()}
        expect = {kid: rows.get(kid, 0) * (reps + 1) for kid in KERNEL_IDS}
        if launched != expect:
            fail(f"probes: {name} launched {launched}, expected {expect}")
        for kid, count in expect.items():
            total[kid] += count
    launches = counts.read(total)
    print(f"probes: five scripts in {time.perf_counter() - t0:.1f} s; launches {launches}")
    torch.cuda.empty_cache()


def toy_city():
    """The CLI's toy city at the flagship's size (120 poses on a 150 m loop,
    180x240) with rendered images kept, so that the two training phases
    and their evals render each pose once."""
    from soft_contrastive_learning_torch.data.pipeline import ToyCitySource

    class KeptToyCity(ToyCitySource):
        def __init__(self, **kw):
            super().__init__(**kw)
            self._kept = {}

        def load_image(self, key):
            if key not in self._kept:
                self._kept[key] = super().load_image(key)
            return self._kept[key]

    return KeptToyCity(num_points=120, radius=150.0, img_h=180, img_w=240)


def train_epoch(torch, np, report, path, cfg, params, source, expect, out_dir=None,
                resume=None):
    """One epoch through Trainer.train() from ``params``, every step timed
    on the device; fails unless the kernels launched ``expect`` times on it.
    ``out_dir``: a run directory that outlives the call (default: a
    temporary one); ``resume``: the checkpoint role to take up from it first.
    Returns the trainer (``tr.drawn``: the image indices of every sample
    drawn), per-step losses and ms, the epoch's
    wall seconds and how many of them the eval hooks took (they render the
    held-out city's images on the host) and the checkpoint writes took, the
    pool set-up seconds, each
    kernel's launches on this path, the eval scalars and the first batch."""
    from soft_contrastive_learning_torch.train.trainer import Trainer

    with tempfile.TemporaryDirectory() as tmp_dir:
        tr = Trainer(cfg, source, out_dir=out_dir or tmp_dir, device="cuda", params=params)
        if resume is not None and not tr.resume_latest(resume):
            fail(f"{path}: no '{resume}' checkpoint to resume from in {out_dir}")
        step, events, first = tr.train_step_pooled, [], {}
        sample, tr.drawn = tr._sample, []

        def recording_sample(*args):
            out = sample(*args)
            tr.drawn.append(None if out is None else tuple(out.indices.reshape(-1).tolist()))
            return out

        tr._sample = recording_sample

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
        run_eval, eval_s = tr._run_eval, [0.0]
        # the checkpoint writes (a part one at anchors 0 and RESUME_ANCHOR, the
        # rolling one inside the eval, one at the epoch's end), timed apart
        save, save_s = tr.ckpts.save, [0.0]

        def timed_save(*args, **kwargs):
            torch.cuda.synchronize()
            t = time.perf_counter()
            save(*args, **kwargs)
            save_s[0] += time.perf_counter() - t

        tr.ckpts.save = timed_save

        def timed_eval(*args):
            torch.cuda.synchronize()
            t, saved = time.perf_counter(), save_s[0]
            run_eval(*args)
            torch.cuda.synchronize()
            eval_s[0] += time.perf_counter() - t - (save_s[0] - saved)

        tr._run_eval = timed_eval  # the rolling save inside it counts as a save
        t0 = time.perf_counter()  # set-up: render the city into the card's image pool
        tr._ensure_image_pool(source.epoch_meta(cfg.local_ref_set, 0))
        pool_s = time.perf_counter() - t0
        counts = LaunchCounts(report, path)
        t0 = time.perf_counter()
        tr.train()
        torch.cuda.synchronize()
        epoch_s = time.perf_counter() - t0
        launches = counts.read(expect)
        losses = [r["value"] for r in tr.writers["local"].read_all() if r["tag"] == "loss"]
        evals = {f"{role}/{r['tag']}@{r['step']}": r["value"] for role in ("other", "local")
                 for r in tr.writers[role].read_all()
                 if r["tag"] not in ("learning_rate",) and (role, r["tag"]) != ("local", "loss")}
        tr.close()
    step_ms = [s.elapsed_time(e) for s, e in events]
    return tr, losses, step_ms, (epoch_s, eval_s[0], save_s[0]), pool_s, launches, evals, first


def check_epoch(torch, np, label, tr, params, losses, evals):
    """60 steps, 6 refreshes, finite losses, moved weights, and the eval
    hooks' scalars finite."""
    if tr.global_step != 60 or tr.mining.refresh_count != 6 or len(losses) != 60:
        fail(f"{label}: {tr.global_step} steps, {tr.mining.refresh_count} refreshes, "
             f"{len(losses)} losses; expected 60, 6, 60")
    if not np.isfinite(losses).all():
        fail(f"{label}: non-finite losses {losses}")
    unmoved = [k for k, v in tr.state.model.state_dict().items()
               if torch.equal(v.cpu(), params[k])]
    if unmoved:
        fail(f"{label}: parameters did not move: {unmoved[:5]}")
    held_out = [v for k, v in evals.items() if k.startswith("other/loss@")]
    if len(held_out) != 1 or len(evals) != 13 or not np.isfinite(list(evals.values())).all():
        fail(f"{label}: eval hooks wrote {evals}; expected one held-out loss and 6 "
             "localization scalars for each region, all finite")
    print(f"{label}: eval hooks at step 0: held-out loss {held_out[0]:.6f}; " + ", ".join(
        f"{k} {v:.2f}" for k, v in sorted(evals.items()) if "Top1" in k))


def check_resume(torch, np, report, cfg, params, source, run_dir, tr, losses):
    """Stop and take up again: the run in ``run_dir / 'a'`` (trainer ``tr``)
    left a part checkpoint at step 30 of 60. A second trainer, a fresh
    object with nothing but that checkpoint, resumes from it on the card and
    finishes the epoch; the uninterrupted epoch is also run a second time
    from the start. cuDNN's backward sums with atomics, so two runs of one
    epoch differ: that second run measures the floor (largest difference of
    a loss of steps 31-60, and of a parameter at the end). The resumed run
    must take the same steps, every loss finite, on the same batches (up
    to the next refresh in any case: its cache is rebuilt from the very
    weights; to the epoch's end where the second uninterrupted run drew the
    first one's batches too), and its final loss and parameters lie within
    10x that floor of the uninterrupted run's (1e-6 where the floor is
    smaller: the runs may also coincide)."""
    half = RESUME_ANCHOR // cfg.tuples_per_batch
    part = Path("checkpoints") / "part" / str(half)
    if not (run_dir / "a" / part / "state.pt").exists():
        fail(f"train: no part checkpoint at step {half}: {sorted((run_dir / 'a').rglob('*.pt'))}")
    (run_dir / "b" / part).parent.mkdir(parents=True)
    shutil.move(str(run_dir / "a" / part), str(run_dir / "b" / part))
    shutil.rmtree(run_dir / "a")
    final = {k: v.detach().clone() for k, v in tr.state.model.state_dict().items()}

    def against_first(label, other, other_losses):
        tail = np.asarray(losses[half:])
        if len(other_losses) != len(tail) or not np.isfinite(other_losses).all():
            fail(f"{label}: {len(other_losses)} losses after step {half}, finite: "
                 f"{np.isfinite(other_losses).all()}; expected {len(tail)}")
        state = other.state.model.state_dict()
        drawn = other.drawn[-len(tail):]
        segment = cfg.mining_step // cfg.tuples_per_batch  # steps to the next refresh
        return dict(loss=float(np.abs(np.asarray(other_losses) - tail).max()),
                    last_loss=float(abs(other_losses[-1] - tail[-1])),
                    param=max((state[k] - final[k]).abs().max().item() for k in final),
                    same_batches=drawn == tr.drawn[half:],
                    same_first_segment=drawn[:segment] == tr.drawn[half : half + segment])

    again, again_losses, *_ = train_epoch(
        torch, np, report, "train_again", cfg, params, source,
        {"K1": EPOCH_FORWARDS, "K1_bwd": 60, "K3": 60 + 2}, out_dir=str(run_dir / "again"))
    shutil.rmtree(run_dir / "again")
    floor = against_first("train_again", again, again_losses[half:])
    # the second half: 30 steps, 3 refreshes of 3 embeds, no eval
    t0 = time.perf_counter()
    resumed, resumed_losses, *_ = train_epoch(
        torch, np, report, "train_resumed", cfg, None, source,
        {"K1": 30 + 3 * 3, "K1_bwd": 30, "K3": 30}, out_dir=str(run_dir / "b"),
        resume="part")
    seconds = time.perf_counter() - t0
    got = against_first("train_resumed", resumed, resumed_losses)
    if resumed.global_step != tr.global_step or resumed.state.step != tr.global_step \
            or resumed.mining.refresh_count != 3 or len(resumed.drawn) != 60 - half:
        fail(f"train_resumed: {resumed.global_step} steps, {resumed.mining.refresh_count} "
             f"refreshes, {len(resumed.drawn)} samples; expected {tr.global_step}, 3, {60 - half}")
    gate = {key: max(10 * floor[key], 1e-6) for key in ("last_loss", "param")}
    print(f"train_resumed: from part@{half} to step {resumed.global_step} in {seconds:.2f} s; "
          f"against the uninterrupted epoch: losses of steps {half + 1}-60 max-abs "
          f"{got['loss']:.3g}, last loss {got['last_loss']:.3g}, parameters {got['param']:.3g}, "
          f"same batches: {got['same_batches']}; floor from a second uninterrupted epoch: "
          f"losses {floor['loss']:.3g}, last loss {floor['last_loss']:.3g}, parameters "
          f"{floor['param']:.3g}, same batches: {floor['same_batches']}; gates {gate}")
    if not got["same_first_segment"] or (floor["same_batches"] and not got["same_batches"]):
        fail("train_resumed: the resumed run drew other batches than the uninterrupted one")
    if got["last_loss"] > gate["last_loss"] or got["param"] > gate["param"]:
        fail(f"train_resumed: {got} outside 10x the floor {floor}")
    return dict(resumed_from_step=half, seconds=seconds, vs_uninterrupted=got, floor=floor)


def train_config(winograd=False):
    """The flagship's training configuration (B = 2 x (1+12+12), Adam at
    5e-6, fused wms) at the toy city's cadence: mining every 20 anchors over
    a cache of 100; the eval hooks once, before the first step, over 4
    queries and every 10th reference pose."""
    from soft_contrastive_learning_torch.core.config import LossConfig, ModelConfig, TrainConfig

    return TrainConfig(model=ModelConfig(winograd=winograd), loss=LossConfig(fused_wms=True),
                       mining_step=20, mining_cache_size=100, max_epoch=1, eval_step=1000,
                       save_step=RESUME_ANCHOR, num_eval_queries=4, eval_ref_r=10)


# A part checkpoint is written at anchor 0 and at this one: half way through
# the epoch (step 30 of 60), where the mining cache is refreshed, so that a
# resumed run rebuilds the cache from the very weights the first run embedded
# it with (with hard mining on, a cache rebuilt from later weights may order
# its neighbours otherwise: the trainer's stated scope of exactness).
RESUME_ANCHOR = 60

# kernel launches of one epoch: 60 steps; 6 refreshes embedding 120 images in 3
# chunks of 50; one eval: 2 held-out loss batches, and 4 embeds (12 refs and 4
# queries pad to one chunk each, for the two regions)
EPOCH_FORWARDS = 60 + 6 * 3 + 2 + 4


def phase_train(torch, np, report, shared):
    from soft_contrastive_learning_torch.perf import common
    from soft_contrastive_learning_torch.core.config import LossConfig, ModelConfig, TrainConfig
    from soft_contrastive_learning_torch.losses.registry import build_loss
    from soft_contrastive_learning_torch.models.model import EmbeddingNet
    from soft_contrastive_learning_torch.models.weights import load_trained_params
    from soft_contrastive_learning_torch.train.step import build_train_step, init_train_state

    cfg = train_config()
    params = load_trained_params(cfg=cfg.model)
    source = toy_city()
    b = cfg.images_per_batch
    run_root = tempfile.TemporaryDirectory()
    run_dir = Path(run_root.name)
    # K1 in every forward, its backward per step, K3 per step and per
    # held-out loss batch
    tr, losses, step_ms, (epoch_s, eval_s, save_s), pool_s, launches, evals, first = train_epoch(
        torch, np, report, "train", cfg, params, source,
        {"K1": EPOCH_FORWARDS, "K1_bwd": 60, "K2": 0, "K3": 60 + 2, "K4": 0},
        out_dir=str(run_dir / "a"))
    print(f"train: {tr.global_step} steps, {tr.mining.refresh_count} mining refreshes in "
          f"{epoch_s:.2f} s, of which the eval hooks {eval_s:.2f} s and the checkpoint writes "
          f"{save_s:.2f} s, after {pool_s:.2f} s of "
          f"pool set-up; launches {launches}; first/last loss {losses[0]:.6f}/{losses[-1]:.6f}")
    check_epoch(torch, np, "train", tr, params, losses, evals)
    resume = check_resume(torch, np, report, cfg, params, source, run_dir, tr, losses)
    run_root.cleanup()

    # the first batch from the trained weights: kernels on and off, fp32 and bf16
    batch, pool = first, tr._image_pool.array
    rel, bf16_loss = {}, None
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
        bf16_loss = got[0]
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
        turns[name].append(common.time_ms(lambda: one(state, dict(batch), pool), 10))
    step_ms_by = {name: statistics.mean(t) for name, t in turns.items()}
    med = statistics.median(step_ms[1:])
    print(f"train: median {med:.3f} ms per step after the first ({1e3 * b / med:.1f} img/s at "
          f"B={b}); epoch end to end, eval hooks and checkpoint writes apart, "
          f"{60 * b / (epoch_s - eval_s - save_s):.1f} img/s; "
          "step with K1 and K3 "
          f"{step_ms_by['K1+K3']:.3f} ms, with K1 and the plain wms {step_ms_by['K1']:.3f} ms, "
          f"with no kernel {step_ms_by['none']:.3f} ms")
    report["train"] = dict(steps=tr.global_step, refreshes=tr.mining.refresh_count,
                           images_per_step=b, median_step_ms=med, img_s=1e3 * b / med,
                           first_step_ms=step_ms[0], pool_setup_s=pool_s, epoch_s=epoch_s,
                           eval_s=eval_s, save_s=save_s,
                           epoch_img_s=60 * b / (epoch_s - eval_s - save_s),
                           step_ms_by_kernels=step_ms_by,
                           parity_rel=rel, first_loss=losses[0], last_loss=losses[-1],
                           evals=evals, resume=resume)
    shared.update(train_params=params, source=source, first_batch=batch, pool=pool,
                  first_batch_bf16_loss=bf16_loss)


def phase_train_winograd(torch, np, report, shared):
    """The same epoch with ``winograd=True``: K4 forward and WinogradConvFn's
    backward on 10 of the 13 convs, in the steps, the mining embeds and the
    eval hooks."""
    from soft_contrastive_learning_torch.perf import common
    from soft_contrastive_learning_torch.losses.registry import build_loss
    from soft_contrastive_learning_torch.models.model import EmbeddingNet
    from soft_contrastive_learning_torch.train.step import build_train_step, init_train_state

    cfg = train_config(winograd=True)
    params, b = shared["train_params"], cfg.images_per_batch
    tr, losses, step_ms, (epoch_s, eval_s, save_s), pool_s, launches, evals, _ = train_epoch(
        torch, np, report, "train_winograd", cfg, params, shared["source"],
        {"K1": EPOCH_FORWARDS, "K1_bwd": 60, "K2": 0, "K3": 60 + 2, "K4": 10 * EPOCH_FORWARDS})
    print(f"train_winograd: {tr.global_step} steps, {tr.mining.refresh_count} mining refreshes "
          f"in {epoch_s:.2f} s, of which the eval hooks {eval_s:.2f} s and the checkpoint writes "
          f"{save_s:.2f} s, after {pool_s:.2f} s of "
          f"pool set-up; launches {launches}; first/last loss {losses[0]:.6f}/{losses[-1]:.6f}")
    check_epoch(torch, np, "train_winograd", tr, params, losses, evals)

    # the standard epoch's first batch from the trained weights, in turns
    batch, pool = shared["first_batch"], shared["pool"]
    runs = {}
    for name, c in (("winograd", cfg), ("standard", train_config())):
        model = EmbeddingNet(c.model)
        model.load_state_dict(params)
        runs[name] = (init_train_state(c, model.cuda()),
                      build_train_step(c, build_loss(c.loss, c.tuples, c.tuples_per_batch),
                                       image_pool=True))
    state, one = runs["winograd"]
    loss = one(state, dict(batch), pool)[1]["loss"].item()
    rel = abs(loss - shared["first_batch_bf16_loss"]) / abs(shared["first_batch_bf16_loss"])
    print(f"train_winograd parity: first-batch loss {loss:.8f}, the standard configuration's "
          f"{shared['first_batch_bf16_loss']:.8f} (rel {rel:.3g})")
    if not rel <= 1e-2:
        fail(f"train_winograd: first-batch loss {rel} relative off the standard configuration's")
    turns = {name: [] for name in runs}
    for name in ("winograd", "standard", "standard", "winograd"):
        state, one = runs[name]
        turns[name].append(common.time_ms(lambda: one(state, dict(batch), pool), 10))
    step_ms_by = {name: statistics.mean(t) for name, t in turns.items()}
    med = statistics.median(step_ms[1:])
    print(f"train_winograd: median {med:.3f} ms per step after the first "
          f"({1e3 * b / med:.1f} img/s at B={b}); epoch end to end, eval hooks and checkpoint "
          f"writes apart, {60 * b / (epoch_s - eval_s - save_s):.1f} img/s; step on one batch "
          f"{step_ms_by['winograd']:.3f} ms against the standard configuration's "
          f"{step_ms_by['standard']:.3f} ms in the same turns")
    report["train_winograd"] = dict(
        steps=tr.global_step, refreshes=tr.mining.refresh_count, images_per_step=b,
        median_step_ms=med, img_s=1e3 * b / med, epoch_s=epoch_s, eval_s=eval_s, save_s=save_s,
        epoch_img_s=60 * b / (epoch_s - eval_s - save_s), step_ms_by_config=step_ms_by,
        first_batch_rel_to_standard=rel, first_loss=losses[0], last_loss=losses[-1], evals=evals)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: no CUDA card")
    try:
        import numpy as np

        import soft_contrastive_learning_torch.ops.kernels._build  # noqa: F401
    except ImportError as e:
        fail(f"the port is not importable from here ({e}); run from the repository root")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    report: dict = {}
    phase_build(torch, report)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    print(smi.stdout.strip())
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")

    phase_k1(torch, report)
    phase_k2(torch, report)
    phase_k3(torch, np, report)
    phase_k1_backward(torch, report)
    phase_k4(torch, report)
    phase_k4_backward(torch, report)
    phase_probe_gemm(torch, report)
    phase_winograd_ablate(torch, report)
    phase_probes(torch, report)
    shared: dict = {}  # what a later phase takes from an earlier one
    phase_serve(torch, np, report, shared)
    phase_serve_winograd(torch, np, report, shared)
    phase_train(torch, np, report, shared)
    phase_train_winograd(torch, np, report, shared)

    # launches: the count on the newest path that runs the kernel (the
    # Winograd training epoch for K1, K1's backward, K3 and K4, serve for K2);
    # launches_by_path: each path's own count, set to 0 just before it
    paths = ("train_winograd", "train", "serve_winograd", "serve", "probes")
    for kid in KERNEL_IDS:
        by_path = report[kid]["launches_by_path"]
        report[kid]["launches"] = next((by_path[p] for p in paths if by_path.get(p)), 0)
        if report[kid]["launches"] <= 0:
            fail(f"{kid} was launched on no path")
    keys = ("name", "route", "source", "replaces", "launches", "launches_by_path",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"serve": report["serve"], "serve_winograd": report["serve_winograd"]}))
    print(json.dumps({"train": report["train"], "train_winograd": report["train_winograd"],
                      "K1_backward": report["K1_backward"],
                      "K4_backward": report["K4_backward"]}))
    print(json.dumps({"K1_by_batch": report["K1"]["by_batch"],
                      "K1_bwd_call": {key: report["K1_bwd"][key] for key in ("device_ms", "host_ms")},
                      "K3_call": {key: report["K3"][key] for key in (
                          "device_ms", "host_ms", "fwd_bwd_ms", "plain_fwd_bwd_ms")}}))
    print(json.dumps({"K4_per_shape": report["K4"]["per_shape"],
                      "K4_forward_B50": report["K4"]["forward_B50"]}))
    print(json.dumps({"build": report["build"]}))
    print(json.dumps({"P_gemm_rows": report["P_gemm"]["rows"],
                      "P6_stages_B256_conv2_2": report["P6_stages"]["stages_B256_conv2_2"],
                      "P6_stages_B64": report["P6_stages"]["stages_B64"]}))
    print(json.dumps({"kernels": [{key: report[kid][key] for key in keys}
                                  for kid in KERNEL_IDS]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
