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
   shared memory per block (forward and backward) and cluster size, K2's
   ring stages and shared memory, and (where cuobjdump is present) the wgmma
   (HGMMA for floating point, IGMMA for integers), TMA-load (UTMALDG) and
   mma.sync (HMMA, IMMA) instructions in each library: probe_gemm, winograd
   and topk must hold HGMMA and UTMALDG, probe_gemm and int8_conv IGMMA and
   no IMMA (int8 on wgmma; int8_conv fed by TMA loads and draining its
   output by TMA stores, UTMASTG), netvlad the TMA loads; Q1's tile shapes
   per layer (ring stages, shared memory, resident weights) and Q1_stem's;
   wms must hold one kernel function (K3 is one launch), and no topk kernel
   may spill;
2. print the card's name and power limit (nvidia-smi);
3. K1 (NetVLAD aggregation, one cluster of 4 blocks per image) against its
   plain version at B=64 and B=50, N=165, D=512, K=64, with fp32 and with
   bf16 logits, within 1e-6; timed at both batches, the device's time apart
   from the host's;
4. K2 (streaming top-k: 3xTF32 on wgmma fed by TMA, persistent blocks with
   running lists, a merge) against its plain version at Q=64, R=66,048,
   D=32,768, k=5 and k=128, on an index with duplicated rows, and with
   R < k. Inputs are multiples of 1/8 in [-1, 1], so every dot product is
   exact in fp32 and under the split (no bits below tf32's), and ids must be
   identical and distances within 1e-6, ties included; then timed at k=1, 5
   and 128 (Q=64) and at Q=256, k=5, beside the plain version and the bound
   (bytes; the earlier fp32-FMA bound printed once beside it);
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
9. the probes' product kernels (probe_gemm: bf16 and int8 on wgmma fed by
   TMA, int8 after a transpose kernel) against their plain version:
   bit-equal on operands whose sums are exact (multiples of 1/8; int8) at
   every problem the probe scripts launch (the resident and blocked shapes
   of perf/mxu_probe.py, (8192, 4096) @ (4096, 8192), the eight of
   perf/matmul_probe.py batched, unrolled and single, where 240 and 360 rows
   end in a ragged tile), with the chosen and with every dividing tile
   shape, for bf16 -> fp32, bf16 -> bf16 and int8 -> int32; within a stated
   tolerance on normals; then its times per tile shape beside torch.matmul /
   torch._int_mm and the bound, the int8 transpose timed apart, and at the
   eight shapes of matmul_probe.py;
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
   plain-PyTorch model and the served search against the exact (fp64)
   search, squared distances within 1e-5 (the plain version's own fp32 error
   is printed beside), and time /search (embed of the queries and one K2
   launch);
13. serve_int8: the shipped int8-PTQ path (models/quant.py, flagship.py)
   at the flagship's width from the trained npz: Q1_stem (conv1_1 with the
   input's requant and 3x3 gather) against its plain version on the raw
   images, uint8 and fp32, and Q1 (the persistent int8 implicit-GEMM conv)
   and Q1_pool against theirs layer by layer at B=8, both fed the same int8
   input: every int8 map equal, conv5_3's fp32 output within 1 ulp, the
   pools equal; flagship.int8_gate (cosine > 0.999 to the
   bf16 float path on calibration_images(n=8)); int8 at B=64 and 1,536 and
   bf16 at 64 and 512 in turns, the model alone (CUDA events) and end to
   end (DescriptorService.embed, uint8 in, numpy out) with the card's busy
   share; Q1's per-layer times at B=64 (beside its bound, the plain
   version, im2col + torch._int_mm and cuDNN's bf16 conv + bias + ReLU) and
   at 1,536, Q1_stem's beside its own bound (3 input bytes a pixel, 64 out)
   and plain version, Q1_pool's beside the plain pool and the library's amax
   over a 2x2 view (F.max_pool2d takes no int8 on CUDA); the int8 forward's
   steps timed one by one at 64 and 1,536 (Q1_stem, Q1 + Q1_pool, the L2
   norm and cast, K1); then `cli quant` from
   32 PNGs written here (its scales equal to calibrate_scales'), `cli serve
   --quant_scales` on 127.0.0.1, port 0, in a thread, over a 66,048-row
   index (an fp16 pickle: 512 int8 descriptors and seeded unit rows, so
   that /search streams through K2): /healthz, /embed (PNG bytes),
   /embed_batch and /search equal to the in-process calls, exact Q1,
   Q1_stem, Q1_pool, K1 and K2 counts; then `cli bench --iters 3` (its JSON
   line);
14. serve the same 512 images with ModelConfig(winograd=True): 10 K4 and one
   K1 launch per batch, descriptors at cosine >= 0.999 to the standard
   configuration's and >= 0.99 to the fp32 plain model's, and the model's
   time per batch beside the standard configuration's, in turns;
15. train: one toy-city epoch (120 poses, 180x240) of the flagship through
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
16. train the same epoch with ModelConfig(winograd=True): 840 K4 launches
   (10 per forward: steps, mining embeds, evals), the same checks, the
   standard epoch's first batch within 1e-2 relative of the standard
   configuration's loss, and the step timed against it in turns;
17. train_files: the same toy city written as the prep pipeline's tree
   (shuffled/, anchors/, clusters/, PNGs) with the port's writer, and `cli
   train` from it on the host feed (no device image pool: decoded on 8
   threads, built ahead by the Prefetcher) for 20 steps (the anchor list cut
   to 40) from the trained weights with fused wms: steps, refreshes, exact
   K1/K1_bwd/K3 counts, finite losses; the first batch's pixels byte for
   byte the toy-city source's and its loss the pooled step's on the same
   sample (1e-5 relative at fp32, 1e-4 at bf16); a fresh Trainer resumed
   from the part checkpoint of step 10 on the host feed within 10x the
   run-to-run floor (at least 1e-6) of the uninterrupted run, on its
   batches; decode img/s (as written, and every row Paeth) and the host-fed
   step beside the pooled one;
18. losses: the 29 losses that need no streaming-PCA state (all of
   LOSS_NAMES but incremental_*) at B = 50 on the trained flagship's
   descriptors of a batch from a dense toy city (1,200 poses 0.79 m apart,
   so that the 12 positives are mostly distinct), once for (1,12,12) and
   once for the quadruplets' (1,12,11,1), with the sampler's fp32 payload:
   value within 1e-5 max(1, |v|) and gradient with respect to the
   embeddings within 5e-4 of its largest entry (or of 1e-9 where that is
   smaller) of the same function in float64 on the card, finite, the same
   bits twice; forward + backward ms on the device and the host, and
   whether a call waits for the card (sync debug mode); the four
   incremental losses on the (1,12,12) batch against loss PCAs initialized
   as the trainer does from 600 of the city's descriptors (the mm variants
   at loss_dim 512, the det variants at the largest loss_dim at which their
   fp32 products are finite and move; the det value's error taken of the
   products it is the difference of), to the same gates, with the sums of
   the logs of their top 512 values; cuSOLVER's
   eigensolve on 900 seeded wrd-like Grams in fp32 (failures, error) and in
   float64 (the port's solve: must converge on all);
19. train_zoo: `cli train --toy_city` from the trained weights on the
   pooled path with no --loss (so wrd) for 20 steps, then 10 steps each of
   pairwise_distance_neg_eigenvalue (PN: two forwards, two backwards, two
   Adam updates a step) and quadruplet: steps, refreshes, exact K1 and
   K1_bwd counts (no K3), finite losses (loss_pos and loss_neg for PN),
   moved weights, Adam's count 2 per PN step; each step's CUDA-event median
   beside the median interval between step calls; then each loss's step
   and the flagship's wms step (K3) on one batch in turns, on the device
   and on the host behind queued work;
20. heads: each reduction at the flagship's width (pca, 1fc, 2fc, 3fc, spp,
   and vlad_cores=0's flattened map) from the trained backbone and a seeded
   head, B = 50: widths, finite, cosine >= 0.99 to the fp32 plain path on
   the card (pca projected by a StreamingPCA fitted on 600 images; its
   whitened bf16 output >= 0.95, and a control, the served descriptor's
   error doubled, below that), K1 once per forward where NetVLAD runs; then a 1fc DescriptorService embeds 512
   index images to 512-D, pads them to 66,048 rows and searches 64 queries
   (K2 at D = 512): 16 index images at rank 0, squared distances within
   1e-5 of |q|^2 of an fp64 search;
21. train_heads: `cli train` at the flagship's width from the trained
   weights: --reduction pca --loss incremental_residual_mm (6 steps) and
   --reduction none with it (the 32,768-wide loss PCA, 4 steps), both from
   a prep tree of a 1,200-pose city with mining windows of 600 images (more
   rows than the PCAs' 512 components), and --reduction 2fc --loss wms
   --fused_wms True (10 steps on the toy city, from an npz holding the
   trained backbone and a seeded head): steps, refreshes,
   exact K1/K1_bwd/K3 counts, finite losses, moved weights, the PCAs' row
   counts; the pca run again (the floor) and resumed by a fresh Trainer
   from its drained part checkpoint of step 3: parameters and both PCAs
   within 10x the floor (at least 1e-6), counts equal; each run's device
   step time beside the interval between step calls and each refresh's
   PCA fits, the host's PCA update at each width and the (2, 525, 525)
   float64 eigensolve;
22. infer: the rehearsal corpus's geometry with 750 refs (its 300 queries
   and 4,400 PCA images) rendered to PNG on 8 processes, then `cli infer`
   for the three sets (fp32) and the queries as fp16: K1 once per batch of
   32, dumps of the right shape, finite, unit-norm, cosine >= 0.99 to the
   fp32 plain model on 64 images, the fp16 dump within 1e-3; img/s end to
   end, the card's busy share (CUDA events around every embed) and decode
   img/s;
23. topn: `cli topn` over the dumps (D up to 1,024, L in {0, 0.3, 1, 5} m,
   N = 25): 20 settings in the JAX pickle layout, >= 90% of the queries'
   top-1 within 25 m at l0.0_dim256, the curves by
   correctly_localized_curve (`cli roc` draws them where matplotlib is);
24. topn_250k: the whitened ref dump (fit at D = 4,096) padded with seeded
   rows of its per-column normal to 250,000 rows, `top_n_single` at
   spacing 0 for the 300 queries at D = 256 and 4,096 (K2: two launches
   each): on 64 queries squared distances within 1e-5 of |q|^2 from an fp64
   search on the card (the whitened rows' |q|^2 is tens of times the
   top-1's squared distance, which the fp32 formula cancels; the error
   relative to the top-1 is printed beside the plain version's), ids
   differing only at near-ties within that; the repaired D = 66 at 200,001
   rows of eighths equal to the plain version; K2 timed at both widths
   beside the dense topk_l2, the plain version and the bounds;
25. write the whole report with the card's name and power limit to
   chiprun_out/chip_smoke_report.json under the working directory, print
   the new paths', serve, train, probe and kernel JSON lines, then the
   result line.

Times come from CUDA events after a warm-up, in ms per call; bounds use the
H100 SXM peaks (67 TFLOP/s fp32 without tensor cores, 495 TFLOP/s tf32, 989
TFLOP/s bf16 and 1,979 TOP/s int8 on them, 3.35 TB/s).
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


# Q1's layers of the flagship (conv1_2 .. conv5_3): (C, F, fp32 out)
Q1_LAYERS = {"conv1_2": (64, 64, False), "conv2_1": (64, 128, False),
             "conv2_2": (128, 128, False), "conv3_1": (128, 256, False),
             "conv3_x": (256, 256, False), "conv4_1": (256, 512, False),
             "conv4_x": (512, 512, False), "conv5_3": (512, 512, True)}


def phase_build(torch, report):
    """Build every kernel library (one nvcc per source, all at once), then
    print per kernel function what ptxas said (registers, spills, static
    shared memory), the dynamic shared memory and cluster of the rebuilt
    kernels, and, where cuobjdump is present, how many HGMMA and IGMMA
    (wgmma, floating point and integer), UTMALDG (TMA load) and HMMA / IMMA
    (mma.sync) and UTMASTG (TMA store) instructions each library's SASS
    holds: probe_gemm, winograd and topk must hold HGMMA and UTMALDG,
    probe_gemm IGMMA and no IMMA, int8_conv IGMMA, UTMALDG and UTMASTG and no
    IMMA. No topk kernel may spill."""
    import shutil

    from soft_contrastive_learning_torch.ops import winograd as plain_winograd
    from soft_contrastive_learning_torch.ops.kernels import (
        _build, int8_conv, netvlad, probe_gemm, topk, winograd)

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
            sass = {op: text.count(op)
                    for op in ("HGMMA", "IGMMA", "UTMALDG", "UTMASTG", "HMMA", "IMMA")}
            print(f"sass {name}: {sass}")
            if name in ("probe_gemm", "winograd", "topk") and not (sass["HGMMA"]
                                                                   and sass["UTMALDG"]):
                fail(f"{name}: the built library holds no wgmma or no TMA load ({sass})")
            if name == "probe_gemm" and (sass["IMMA"] or not sass["IGMMA"]):
                fail(f"probe_gemm: int8 is not on integer wgmma alone ({sass})")
            if name == "netvlad" and not sass["UTMALDG"]:
                fail(f"netvlad: the built library holds no TMA load ({sass})")
            if name == "int8_conv" and (sass["IMMA"] or not (
                    sass["IGMMA"] and sass["UTMALDG"] and sass["UTMASTG"])):
                fail(f"int8_conv: Q1 is not on integer wgmma fed by TMA loads, stored by TMA, "
                     f"alone ({sass})")
        if name == "topk" and any(f["spill_stores"] or f["spill_loads"] for f in funcs):
            fail(f"topk: a kernel spills registers: {funcs}")
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
    q1 = int8_conv._lib()
    q1_tiles = {}
    for layer, (c, f, f32) in Q1_LAYERS.items():
        th, tw, bn, bk, cons = int8_conv.tile_shape(c, f, f32)
        stages, smem, _, per_sm, resident = (
            q1.scl_int8_conv_config(what, th, bn, bk, int(f32), cons, c) for what in range(5))
        q1_tiles[layer] = dict(tile=(th, tw, bn, bk), consumers=cons, stages=stages, smem=smem,
                               blocks_per_sm=per_sm, resident_weights=bool(resident))
    stem_stages, stem_smem, stem_th, stem_tw, stem_f, stem_cons = (
        q1.scl_int8_stem_config(what) for what in range(6))
    q1_tiles["conv1_1 (Q1_stem)"] = dict(tile=(stem_th, stem_tw, stem_f, 32), consumers=stem_cons,
                                         stages=stem_stages, smem=stem_smem,
                                         blocks_per_sm=3 - stem_cons, resident_weights=True)
    print("Q1 per layer (TH x TW pixels by BN channels, BK a step; consumer warpgroups, blocks "
          "an SM, ring stages, dynamic shared memory, resident weights): " + "; ".join(
              f"{layer} {'x'.join(map(str, t['tile'][:2]))} by {t['tile'][2]}, BK {t['tile'][3]}: "
              f"{t['consumers']}, {t['blocks_per_sm']}, "
              f"{t['stages']}, {t['smem']}, {t['resident_weights']}"
              for layer, t in q1_tiles.items()))
    k2 = topk._lib()
    k2_ring = {k: (k2.scl_topk_stages(k), k2.scl_topk_smem_bytes(k)) for k in (5, 128)}
    print("K2: clusters of 2 blocks sharing the query loads by TMA multicast, "
          + ", ".join(f"k={k}: {st} ring stages, {sm} bytes of dynamic shared memory a block"
                      for k, (st, sm) in k2_ring.items()))
    report["build"] = dict(seconds=seconds, libraries=out, probe_gemm_tiles=tiles,
                           k2={f"k{k}": dict(stages=st, smem=sm)
                               for k, (st, sm) in k2_ring.items()},
                           k1=dict(cluster=k1.scl_netvlad_cluster_blocks(), smem=k1_smem,
                                   resident_clusters=k1_active),
                           k4=dict(cluster=plain_winograd.CLUSTER, smem=k4_smem),
                           q1=q1_tiles)


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

    # a second chunk's worth of queries: four query tiles over the same refs
    q256 = eighths(torch, gen, (256, d))
    err = max(err, compare(f"Q=256 R={n_refs} D={d} k=5", q256, r, 5)[1])

    by_k = {kk: common.time_ms(lambda: topk_l2_cuda(q, r, kk), 5) for kk in (1, 5, 128)}
    plain_ms = common.time_ms(lambda: topk_l2_stream_plain(q, r, 5), 5)
    ms256 = common.time_ms(lambda: topk_l2_cuda(q256, r, 5), 5)

    def bounds(nq_, k_):
        """(bound, by) for 3xTF32 on the tensor cores, and the earlier
        kernel's fp32-FMA bound on the same bytes."""
        nbytes = 4 * (n_refs * d + nq_ * d) + 12 * nq_ * k_
        return (common.bound_ms(6 * nq_ * n_refs * d, nbytes, common.TF32_FLOPS),
                common.bound_ms(2 * nq_ * n_refs * d + 2 * n_refs * d, nbytes))

    (bound_ms, bound_by), (old_ms, old_by) = bounds(nq, 5)
    (b256, b256_by), _ = bounds(256, 5)
    print(f"K2 Q={nq} R={n_refs} D={d}: kernel k=1 {by_k[1]:.3f} ms, k=5 {by_k[5]:.3f} ms, "
          f"k=128 {by_k[128]:.3f} ms; plain k=5 {plain_ms:.3f} ms; bound {bound_ms:.3f} ms "
          f"({bound_by}; 3xTF32 on the tensor cores; the earlier fp32-FMA kernel's bound: "
          f"{old_ms:.3f} ms, {old_by})")
    print(f"K2 Q=256 R={n_refs} D={d} k=5: kernel {ms256:.3f} ms, bound {b256:.3f} ms "
          f"({b256_by})")
    report["K2"] = dict(
        name="topk_l2", route="cuda",
        source="soft_contrastive_learning_torch/ops/kernels/csrc/topk.cu",
        replaces="soft_contrastive_learning_tpu/ops/pallas/topk_kernel.py:41",
        max_abs_err=err, ms=by_k[5], plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
        library_ms=None, ms_by_k=by_k, fp32_fma_bound_ms=old_ms,
        q256=dict(ms=ms256, bound_ms=b256, bound_by=b256_by))
    del q, q256, r
    torch.cuda.empty_cache()


KERNEL_IDS = ("K1", "K1_bwd", "K2", "K3", "K4", "P_gemm", "P6_stages", "Q1", "Q1_pool",
              "Q1_stem")


class LaunchCounts:
    """The kernel wrappers' launch counters around one path: set to 0 on
    entry, read by ``read()`` into ``report[kernel]['launches_by_path']``."""

    def __init__(self, report, path):
        from soft_contrastive_learning_torch.ops.kernels.int8_conv import (
            int8_conv, int8_pool, int8_stem)
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
            winograd_conv_cuda, probe_gemm, winograd_stage, int8_conv, int8_pool, int8_stem)))
        for fn in self.wrappers.values():
            fn.launches = 0

    def read(self, expect):
        """The counts since entry; fails unless they are ``expect`` (0 for a
        kernel it does not name)."""
        counts = {kid: fn.launches for kid, fn in self.wrappers.items()}
        if any(count != expect.get(kid, 0) for kid, count in counts.items()):
            fail(f"{self.path}: kernel launches {counts}, expected {expect}")
        for kid, count in counts.items():
            self.report.setdefault(kid, {}).setdefault("launches_by_path", {})[self.path] = count
        return counts


def blocky_images(rng, n: int):
    """Seeded 180x240 uint8 images of 15x15-pixel random blocks."""
    return rng.integers(0, 256, (n, 12, 16, 3), dtype="uint8").repeat(15, 1).repeat(15, 2)


def exact_search(torch, q, refs, k, rows=16384):
    """The exact ranking: fp64 squared distances of ``q`` to every ref on
    the card, ``rows`` refs at a time. Returns the k + 1 nearest (squared
    distances, ids) and each rank's gap to its nearer neighbouring rank,
    the margin within which two ids may swap."""
    q64 = q.double()
    q_sq = (q64 * q64).sum(1, keepdim=True)
    exact = torch.empty((len(q), len(refs)), dtype=torch.float64, device="cuda")
    for s in range(0, len(refs), rows):
        r64 = refs[s : s + rows].double()
        exact[:, s : s + rows] = q_sq - 2.0 * (q64 @ r64.T) + (r64 * r64).sum(1)[None, :]
    want_sq, want_i = torch.sort(exact, dim=1, stable=True)
    want_sq, want_i = want_sq[:, : k + 1], want_i[:, : k + 1]
    del exact
    steps = (want_sq[:, 1:] - want_sq[:, :-1]).abs()  # (Q, k): gap to the next rank
    inf = torch.full((len(q), 1), float("inf"), dtype=torch.float64, device="cuda")
    gaps = torch.minimum(torch.cat([inf, steps[:, :-1]], 1), steps)
    return want_sq, want_i, gaps


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

    # the served search against the exact squared distances on the same
    # inputs: fp64 over every ref. The plain version's fp32 sums over D =
    # 32,768 are themselves up to ~1.4e-5 off in squared distance on these
    # queries, more than the gate, so the gate's reference is the exact
    # ranking (the plain version's distance from it and from the kernel is
    # printed beside). Ids may differ from it only between neighbours whose
    # exact squared distances are within 1e-5 (rank k+1 included).
    q = torch.from_numpy(service.embed(query_imgs)).cuda()
    got_d, got_i = topk_l2_cuda(q, index, k)
    plain_d, _ = topk_l2_stream_plain(q, index, k)
    want_sq, want_i, gaps = exact_search(torch, q, index, k, rows=4096)
    got_sq, plain_sq = got_d.double() ** 2, plain_d.double() ** 2
    e = (got_sq - want_sq[:, :k]).abs().max().item()
    differ = got_i != want_i[:, :k]
    if e > 1e-5 or (differ & (gaps > 1e-5)).any():
        fail(f"served K2 vs exact: sq-dist err {e}, {int(differ.sum())} ids differ outside "
             "near-ties")
    plain_e = (plain_sq - want_sq[:, :k]).abs().max().item()
    print(f"serve: K2 vs the exact (fp64) search on the served queries: max sq-dist err {e:.3g}, "
          f"{int(differ.sum())} of {differ.numel()} ids differ (near-ties within 1e-5 only); the "
          f"plain version's max sq-dist err to the exact search {plain_e:.3g}, to K2 "
          f"{(plain_sq - got_sq).abs().max().item():.3g}")

    # /search latency: the 64 queries' embed and one K2 launch, host clock
    # from the images to the results (numpy), after the search above
    runs = []
    for _ in range(3):
        t0 = time.perf_counter()
        service.search(query_imgs, k=k)
        runs.append(1e3 * (time.perf_counter() - t0))
    search = dict(ms=statistics.median(runs), runs=runs,
                  k2_ms=common.time_ms(lambda: topk_l2_cuda(q, index, k), 3))
    print(f"serve: /search of {len(query_imgs)} images, k={k}: {search['ms']:.3f} ms (median "
          f"of 3: {', '.join(f'{t:.3f}' for t in runs)}); its K2 launch {search['k2_ms']:.3f} ms")

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
                           model_ms_per_batch64=embed_ms, search=search)
    print(f"serve: embed {512 / e2e_s:.1f} img/s end to end (service.embed, 512 images), "
          f"model alone {64e3 / embed_ms:.1f} img/s ({embed_ms:.3f} ms per batch of 64)")


def im2col_int_mm(torch, x, w_kn):
    """The nearest library route to one Q1 layer: the im2col of int8 x
    (B, H, W, C) by 9 shifted slices, then ``torch._int_mm`` by the (K, F)
    weights, int32 out."""
    b, h, w, c = x.shape
    p = torch.nn.functional.pad(x, (0, 0, 1, 1, 1, 1))
    cols = torch.cat([p[:, r:r + h, s:s + w] for r in range(3) for s in range(3)],
                     dim=3).reshape(-1, 9 * c)
    return torch._int_mm(cols, w_kn)


def stem_args(stack):
    """Q1_stem's arguments after the images, from a QuantizedConvStack."""
    stem = stack.layers[0]
    return (stack.average_rgb, stack.inv_in, stem["weight"], stem["mult"], stem["bias"],
            stem["inv_next"], stem["relu"])


def q1_times(torch, stack, params, images, reps, yardsticks):
    """Q1_stem's row on ``images`` (uint8 on the card: ms, bound, with
    ``yardsticks`` the plain version's ms), then per later layer of the int8
    stack Q1's ms, its bound, and with ``yardsticks`` the plain version's ms
    (float64 conv), im2col + ``torch._int_mm`` and cuDNN's bf16 conv + bias
    + ReLU on the same shape; per pool Q1_pool's ms, bound and (yardsticks)
    plain ms and the library's (``amax`` over the 2x2 windows of a view)."""
    import torch.nn.functional as F

    from soft_contrastive_learning_torch.models.quant import CONV_NAMES
    from soft_contrastive_learning_torch.models.vgg16 import VGG_BLOCKS
    from soft_contrastive_learning_torch.ops.kernels.int8_conv import (
        int8_conv, int8_conv_plain, int8_pool, int8_pool_plain, int8_stem, int8_stem_plain)
    from soft_contrastive_learning_torch.perf import common

    b, h, w, _ = images.shape
    sargs = stem_args(stack)
    f = sargs[2].shape[0]
    # the stem reads 3 bytes a pixel and writes F: bound by its bytes
    bound, by = common.bound_ms(2.0 * b * h * w * 27 * f, b * h * w * (3 + f) + 32 * f,
                                common.INT8_OPS)
    stem_row = dict(layer=CONV_NAMES[0], b=b, h=h, w=w, c=3, f=f,
                    ms=common.time_ms(lambda: int8_stem(images, *sargs), reps),
                    bound_ms=bound, bound_by=by)
    if yardsticks:
        stem_row["plain_ms"] = common.time_ms(lambda: int8_stem_plain(images, *sargs), reps)
    x = int8_stem(images, *sargs)
    convs, pools = [], []
    names = [n for specs in VGG_BLOCKS for n, _, _ in specs]
    for i, layer in enumerate(stack.layers[1:], start=1):
        args = (layer["weight"], layer["mult"], layer["bias"], layer["inv_next"], layer["relu"],
                layer["out_f32"])
        _, h, w, c = x.shape
        f = layer["weight"].shape[0]
        out_bytes = 4 if layer["out_f32"] else 1
        bound, by = common.bound_ms(2.0 * b * h * w * 9 * c * f,
                                    b * h * w * (c + f * out_bytes) + 9 * c * f, common.INT8_OPS)
        row = dict(layer=CONV_NAMES[i], b=b, h=h, w=w, c=c, f=f,
                   ms=common.time_ms(lambda: int8_conv(x, *args), reps),
                   bound_ms=bound, bound_by=by)
        if yardsticks:
            row["plain_ms"] = common.time_ms(lambda: int8_conv_plain(x, *args), 1)
            w_kn = layer["weight"].reshape(f, -1).t().contiguous()
            row["library_ms"] = common.time_ms(lambda: im2col_int_mm(torch, x, w_kn), reps)
            conv = params[f"vgg16.{CONV_NAMES[i].replace('/', '.')}.weight"]
            wb = conv.cuda().bfloat16()
            bb = params[f"vgg16.{CONV_NAMES[i].replace('/', '.')}.bias"].cuda().bfloat16()
            xb = x.permute(0, 3, 1, 2).bfloat16()
            row["cudnn_bf16_ms"] = common.time_ms(
                lambda: F.relu(F.conv2d(xb, wb, bb, padding=1)), reps)
            del w_kn, wb, xb
        convs.append(row)
        y = int8_conv(x, *args)
        if layer["pool"]:
            _, h, w, c = y.shape
            bound, by = common.bound_ms(0.0, b * h * w * c + b * (h // 2) * (w // 2) * c)
            prow = dict(after=names[i], b=b, h=h, w=w, c=c,
                        ms=common.time_ms(lambda: int8_pool(y), reps), bound_ms=bound,
                        bound_by=by)
            if yardsticks:
                prow["plain_ms"] = common.time_ms(lambda: int8_pool_plain(y), reps)
                # the library's one call for it (F.max_pool2d refuses int8 on
                # CUDA): amax over the 2x2 windows of a view of the map
                prow["library_ms"] = common.time_ms(
                    lambda: y[:, : h // 2 * 2, : w // 2 * 2].view(
                        b, h // 2, 2, w // 2, 2, c).amax((2, 4)), reps)
            pools.append(prow)
            x = int8_pool(y)
        else:
            x = y
        del y
    return stem_row, convs, pools


def int8_forward_parts(torch, embedder, images, reps):
    """ms of the int8 forward of ``images`` (uint8 on the card) and of each
    of its steps on its own: Q1_stem (the input's requant, its 3x3 gather
    and conv1_1), Q1 and Q1_pool (the stack less the stem), the channel
    L2-norm with the cast to the compute dtype, and NetVLAD (K1)."""
    from soft_contrastive_learning_torch.core.config import torch_dtype
    from soft_contrastive_learning_torch.models.vgg16 import l2_normalize
    from soft_contrastive_learning_torch.ops.kernels.int8_conv import int8_stem
    from soft_contrastive_learning_torch.perf import common

    stack, dtype = embedder.stack, torch_dtype(embedder.cfg.compute_dtype)
    sargs = stem_args(stack)
    with torch.inference_mode():  # as the forward runs
        fmap = stack(images)
        feat = l2_normalize(fmap, dim=-1).to(dtype).float()
        parts = dict(forward_ms=common.time_ms(lambda: embedder(images), reps),
                     stem_ms=common.time_ms(lambda: int8_stem(images, *sargs), reps),
                     stack_ms=common.time_ms(lambda: stack(images), reps),
                     l2norm_cast_ms=common.time_ms(
                         lambda: l2_normalize(fmap, dim=-1).to(dtype).float(), reps),
                     netvlad_ms=common.time_ms(lambda: embedder.model.netvlad(feat), reps))
    parts["stack_kernels_ms"] = parts["stack_ms"] - parts["stem_ms"]
    return parts


def phase_serve_int8(torch, np, report, shared):
    """The shipped int8-PTQ serving path (models/quant.py, flagship.py) at
    the flagship's width from the trained npz: Q1 and Q1_pool against their
    plain versions layer by layer, the int8 gate, the rates beside bf16,
    `cli quant`, then `cli serve --quant_scales` answering HTTP requests
    (K2 on /search), then `cli bench`."""
    import base64
    import contextlib
    import io
    import threading
    import urllib.request

    from soft_contrastive_learning_torch import cli, flagship
    from soft_contrastive_learning_torch.models.quant import (
        QuantizedConvStack, QuantizedEmbedder, calibrate_scales, load_scales)
    from soft_contrastive_learning_torch.models.weights import TRAINED_PARAMS_PATH
    from soft_contrastive_learning_torch.ops.kernels.int8_conv import (
        int8_conv, int8_conv_plain, int8_pool, int8_pool_plain, int8_stem, int8_stem_plain)
    from soft_contrastive_learning_torch.perf import common
    from soft_contrastive_learning_torch.serving import DescriptorService
    from soft_contrastive_learning_torch.utils.io import save_img, save_pickle

    t_phase = time.perf_counter()
    cfg = flagship.flagship_model_config()
    params = shared["params"]
    calib = flagship.calibration_images(cfg, 8)
    scales = calibrate_scales(params, calib, "cuda")
    stack = QuantizedConvStack(params, scales, "cuda")

    # 1. Q1_stem against its plain version on the raw images, fp32 and uint8;
    # Q1 and Q1_pool against theirs, layer by layer, B = 8, both fed the same
    # int8 input: the int8 maps equal, conv5_3's fp32 within 1 ulp (the same
    # fp32 multiply and add), the pools equal
    sargs = stem_args(stack)
    calib_f32 = torch.from_numpy(calib).cuda()
    stem_err = pool_err = 0
    for images in (calib_f32, torch.from_numpy(np.rint(calib).astype(np.uint8)).cuda()):
        got, want = int8_stem(images, *sargs), int8_stem_plain(images, *sargs)
        torch.cuda.synchronize()
        stem_err = max(stem_err, int((got.int() - want.int()).abs().max()))
        if not torch.equal(got, want):
            fail(f"Q1_stem on {images.dtype} images: {int((got != want).sum())} int8 values "
                 "differ from the plain version's")
    x = int8_stem(calib_f32, *sargs)
    q1_err = 0.0
    for i, layer in enumerate(stack.layers[1:], start=1):
        args = (layer["weight"], layer["mult"], layer["bias"], layer["inv_next"], layer["relu"],
                layer["out_f32"])
        got, want = int8_conv(x, *args), int8_conv_plain(x, *args)
        torch.cuda.synchronize()
        if layer["out_f32"]:
            ulps = (got.view(torch.int32).long() - want.view(torch.int32).long()).abs().max().item()
            q1_err = (got - want).abs().max().item()
            if ulps > 1 or not torch.isfinite(got).all():
                fail(f"Q1 conv5_3: its fp32 output {ulps} ulp from the plain version's")
        elif not torch.equal(got, want):
            fail(f"Q1 layer {i}: {int((got != want).sum())} int8 values differ from the plain "
                 "version's")
        if layer["pool"]:
            x, want = int8_pool(got), int8_pool_plain(got)
            torch.cuda.synchronize()
            pool_err = max(pool_err, int((x.int() - want.int()).abs().max()))
            if not torch.equal(x, want):
                fail(f"Q1_pool after layer {i}: {int((x != want).sum())} values differ")
        else:
            x = got
    fmap = x
    print(f"serve_int8: at B=8, the trained stack: Q1_stem equal to its plain version from fp32 "
          f"and uint8 pixels; Q1 on the 12 later layers: every int8 map equal, conv5_3 fp32 "
          f"max-abs {q1_err:.3g} (within 1 ulp); Q1_pool equal after each of the 4 blocks")
    if not torch.equal(fmap, stack(calib)):
        fail("serve_int8: the stack's conv5_3 map differs from the layer-by-layer run")

    # 2. the gate: the int8 descriptor against the bf16 float path on the card
    _, _, cos = flagship.int8_gate(cfg, params, calib, device="cuda")
    print(f"serve_int8: int8_gate on calibration_images(n=8): cosine {cos:.6f} to the bf16 float "
          f"path (threshold {flagship.INT8_COSINE_THRESHOLD})")

    # 3. the rates: model alone (CUDA events) and end to end (DescriptorService.embed,
    # uint8 in, numpy out), int8 and bf16 in turns, and the card's busy share
    rng = np.random.default_rng(SEED + 11)
    imgs = blocky_images(rng, flagship.SERVING_BATCH)
    x_card = torch.from_numpy(imgs).cuda()
    int8_embed = QuantizedEmbedder(cfg, params, scales=scales, device="cuda")
    bf16_embed = flagship.float_forward(cfg, params, "cuda")
    fns = {"int8": lambda b: int8_embed(x_card[:b]), "bf16": lambda b: bf16_embed(x_card[:b])}
    batches = {("int8", "small"): 64, ("bf16", "small"): 64,
               ("int8", "big"): flagship.SERVING_BATCH,
               ("bf16", "big"): flagship.BF16_CONFIRM_BATCH}
    model_ms = {key: [] for key in batches}
    for size, reps in (("small", 10), ("big", 3)):
        for prec in ("int8", "bf16", "bf16", "int8"):
            b = batches[(prec, size)]
            model_ms[(prec, size)].append(common.time_ms(lambda: fns[prec](b), reps))
    rates = {}
    for (prec, size), runs in model_ms.items():
        b = batches[(prec, size)]
        ms = statistics.mean(runs)
        rates[f"{prec}_B{b}"] = dict(batch=b, model_ms=ms, model_runs=runs,
                                     model_img_s=b * 1e3 / ms)
    for size in ("small", "big"):
        services = {}
        for prec in ("int8", "bf16"):
            b = batches[(prec, size)]
            services[prec] = DescriptorService(
                cfg, params, batch_size=b, quant_scales=scales if prec == "int8" else None)
        for prec in ("int8", "bf16", "bf16", "int8"):
            b = batches[(prec, size)]
            n = 8 * b if size == "small" else b
            row = rates[f"{prec}_B{b}"]
            services[prec].embed(imgs[:b])  # warm
            t0 = time.perf_counter()
            out = services[prec].embed(imgs[:n])
            wall = time.perf_counter() - t0
            if out.shape != (n, cfg.descriptor_dim) or not np.isfinite(out).all():
                fail(f"serve_int8: {prec} embed of {n} images gave {out.shape} or non-finite")
            row.setdefault("e2e_runs", []).append(n / wall)
            row["e2e_images"] = n
            row["busy_share"] = row["model_ms"] * (n // b) / (1e3 * wall)
        del services
    for key, row in rates.items():
        row["e2e_img_s"] = statistics.mean(row["e2e_runs"])
        print(f"serve_int8: {key}: model alone {row['model_img_s']:.1f} img/s "
              f"({row['model_ms']:.3f} ms a batch), end to end {row['e2e_img_s']:.1f} img/s "
              f"(DescriptorService.embed of {row['e2e_images']} images), card busy "
              f"{100 * row['busy_share']:.1f}%")
    parts = {b: int8_forward_parts(torch, int8_embed, x_card[:b], reps)
             for b, reps in ((64, 10), (flagship.SERVING_BATCH, 3))}
    for b, part in parts.items():
        print(f"serve_int8: the int8 forward at B={b}, {part['forward_ms']:.3f} ms: Q1_stem (the "
              f"input's requant, gather and conv1_1) {part['stem_ms']:.4f}, Q1 + Q1_pool "
              f"{part['stack_kernels_ms']:.3f}, L2 norm + cast {part['l2norm_cast_ms']:.4f}, "
              f"NetVLAD (K1) {part['netvlad_ms']:.4f}")
    del x_card, int8_embed, bf16_embed
    torch.cuda.empty_cache()

    # Q1's rows: per layer at B = 64 (with the plain version, im2col +
    # torch._int_mm and cuDNN's bf16 conv + bias + ReLU) and at SERVING_BATCH
    stem64, conv64, pool64 = q1_times(torch, stack, params, torch.from_numpy(imgs[:64]).cuda(),
                                      10, True)
    stem_big, conv_big, pool_big = q1_times(torch, stack, params, torch.from_numpy(imgs).cuda(),
                                            3, False)
    torch.cuda.empty_cache()
    print(f"Q1_stem {stem64['h']}x{stem64['w']} C=3 F={stem64['f']} from uint8 pixels: B=64 "
          f"{stem64['ms']:.4f} ms (bound {stem64['bound_ms']:.4f}, {stem64['bound_by']}; plain "
          f"{stem64['plain_ms']:.3f}), B={stem_big['b']} {stem_big['ms']:.3f} ms (bound "
          f"{stem_big['bound_ms']:.3f})")
    for row, big in zip(conv64, conv_big):
        print(f"Q1 {row['layer']} {row['h']}x{row['w']} C={row['c']} F={row['f']}: B=64 "
              f"{row['ms']:.4f} ms (bound {row['bound_ms']:.4f}, {row['bound_by']}; plain "
              f"{row['plain_ms']:.3f}; im2col + _int_mm {row['library_ms']:.4f}; cuDNN bf16 "
              f"{row['cudnn_bf16_ms']:.4f}), B={big['b']} {big['ms']:.3f} ms (bound "
              f"{big['bound_ms']:.3f})")
    for row, big in zip(pool64, pool_big):
        print(f"Q1_pool after {row['after']} {row['h']}x{row['w']}x{row['c']}: B=64 "
              f"{row['ms']:.4f} ms (bound {row['bound_ms']:.4f}, plain {row['plain_ms']:.4f}, "
              f"amax of a 2x2 view {row['library_ms']:.4f}), B={big['b']} {big['ms']:.3f} ms")

    def total(rows, key):
        vals = [r[key] for r in rows]
        return None if any(v is None for v in vals) else sum(vals)

    report.setdefault("Q1", {}).update(
        name="int8_conv", route="cuda",
        source="soft_contrastive_learning_torch/ops/kernels/csrc/int8_conv.cu",
        replaces="soft_contrastive_learning_tpu/models/quant.py:224",
        max_abs_err=q1_err, ms=total(conv64, "ms"), plain_ms=total(conv64, "plain_ms"),
        bound_ms=total(conv64, "bound_ms"), bound_by="operations",
        library_ms=total(conv64, "library_ms"), cudnn_bf16_ms=total(conv64, "cudnn_bf16_ms"),
        ms_big=total(conv_big, "ms"), bound_ms_big=total(conv_big, "bound_ms"),
        per_layer=conv64, per_layer_big=conv_big)
    report.setdefault("Q1_stem", {}).update(
        name="int8_stem", route="cuda",
        source="soft_contrastive_learning_torch/ops/kernels/csrc/int8_conv.cu",
        replaces="soft_contrastive_learning_tpu/models/quant.py:207",
        max_abs_err=stem_err, ms=stem64["ms"], plain_ms=stem64["plain_ms"],
        bound_ms=stem64["bound_ms"], bound_by=stem64["bound_by"], library_ms=None,
        ms_big=stem_big["ms"], bound_ms_big=stem_big["bound_ms"], row=stem64, row_big=stem_big)
    report.setdefault("Q1_pool", {}).update(
        name="int8_pool", route="cuda",
        source="soft_contrastive_learning_torch/ops/kernels/csrc/int8_conv.cu",
        replaces="soft_contrastive_learning_tpu/models/quant.py:239",
        max_abs_err=pool_err, ms=total(pool64, "ms"), plain_ms=total(pool64, "plain_ms"),
        bound_ms=total(pool64, "bound_ms"), bound_by="bytes",
        library_ms=total(pool64, "library_ms"), ms_big=total(pool_big, "ms"),
        per_pool=pool64, per_pool_big=pool_big)
    print(f"Q1: a forward's 12 launches at B=64 {report['Q1']['ms']:.3f} ms (bound "
          f"{report['Q1']['bound_ms']:.3f}, operations; plain {report['Q1']['plain_ms']:.1f}; "
          f"im2col + _int_mm {report['Q1']['library_ms']:.3f}; cuDNN bf16 conv + bias + ReLU "
          f"{report['Q1']['cudnn_bf16_ms']:.3f}), at B={flagship.SERVING_BATCH} "
          f"{report['Q1']['ms_big']:.3f} ms (bound {report['Q1']['bound_ms_big']:.3f})")

    # 4. `cli quant` from PNGs written here, then `cli serve --quant_scales` on
    # 127.0.0.1, port 0, over a 66,048-row index (so /search streams through K2)
    work = Path(tempfile.mkdtemp(prefix="serve_int8_"))
    png_dir = work / "pngs"
    png_dir.mkdir()
    index_imgs = shared["index_imgs"]
    for i in range(32):
        save_img(index_imgs[i], str(png_dir / f"{i:03d}.png"))
    scales_path = work / "scales.json"
    t0 = time.perf_counter()
    if cli.main(["quant", "--image_dir", str(png_dir), "--checkpoint", str(TRAINED_PARAMS_PATH),
                 "--out", str(scales_path), "--num_images", "32"]) != 0:
        fail("serve_int8: cli quant failed")
    quant_s = time.perf_counter() - t0
    written = load_scales(str(scales_path))
    want = calibrate_scales(params, index_imgs[:32].astype(np.float32), "cuda")
    if set(written) != set(want) or any(abs(written[k] - want[k]) > 1e-6 * want[k]
                                        for k in want):
        fail(f"serve_int8: cli quant's scales {written} differ from calibrate_scales' {want}")

    n_rows, dim = 66048, cfg.descriptor_dim
    t0 = time.perf_counter()
    writer = DescriptorService(cfg, params, batch_size=64, quant_scales=written)
    rows = np.empty((n_rows, dim), np.float16)
    rows[:512] = writer.embed(index_imgs)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 12)
    for s in range(512, n_rows, 4096):
        e = min(s + 4096, n_rows)
        v = torch.randn((e - s, dim), generator=gen, device="cuda")
        rows[s:e] = (v / v.norm(dim=1, keepdim=True)).half().cpu().numpy()
    del writer
    index_path = work / "index.pickle"
    save_pickle(rows, str(index_path))
    del rows
    index_s = time.perf_counter() - t0

    counts = LaunchCounts(report, "serve_int8")
    t0 = time.perf_counter()
    args = cli.build_parser().parse_args([
        "serve", "--quant_scales", str(scales_path), "--index", str(index_path), "--host",
        "127.0.0.1", "--port", "0", "--batch_size", "64"])
    server = cli.build_server(args)
    service = server.service
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    start_s = time.perf_counter() - t0

    def post(path, body, ctype="application/json"):
        req = urllib.request.Request(url + path, data=body, headers={"Content-Type": ctype})
        with urllib.request.urlopen(req, timeout=300) as resp:
            return json.loads(resp.read())

    try:
        with urllib.request.urlopen(url + "/healthz", timeout=60) as resp:
            health = json.loads(resp.read())
        if health != {"status": "ok", "backend": "cuda", "dim": dim}:
            fail(f"serve_int8: /healthz answered {health}")
        pngs = [(png_dir / f"{i:03d}.png").read_bytes() for i in range(8)]
        t0 = time.perf_counter()
        one = np.asarray(post("/embed", pngs[0], "image/png")["descriptor"], np.float32)
        embed_ms = 1e3 * (time.perf_counter() - t0)
        local = service.embed(index_imgs[:1])[0]
        err_embed = float(np.abs(one - local).max())
        batch_body = json.dumps({"images_b64": [base64.b64encode(p).decode()
                                                for p in pngs[:4]]}).encode()
        many = np.asarray(post("/embed_batch", batch_body)["descriptors"], np.float32)
        err_batch = float(np.abs(many - service.embed(index_imgs[:4])).max())
        query_imgs = np.concatenate([index_imgs[:4], blocky_images(rng, 4)])
        query_pngs = pngs[:4]
        for i, im in enumerate(query_imgs[4:]):
            save_img(im, str(work / f"q{i}.png"))
            query_pngs.append((work / f"q{i}.png").read_bytes())
        search_body = json.dumps({"images_b64": [base64.b64encode(p).decode()
                                                 for p in query_pngs], "k": 5}).encode()
        t0 = time.perf_counter()
        found = post("/search", search_body)
        search_ms = 1e3 * (time.perf_counter() - t0)
        local_d, local_i = service.search(query_imgs, k=5)
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
    torch.cuda.synchronize()
    # 6 batches of 64 or fewer (3 requests, 3 in-process calls): 1 Q1_stem,
    # 12 Q1, 4 Q1_pool and 1 K1 launches each; 2 searches over 66,048 rows: K2
    launches = counts.read({"K1": 6, "K2": 2, "Q1": 72, "Q1_stem": 6, "Q1_pool": 24})
    if err_embed > 1e-6 or err_batch > 1e-6:
        fail(f"serve_int8: HTTP descriptors differ from the in-process embed ({err_embed}, "
             f"{err_batch})")
    http_i = np.asarray(found["indices"])
    if not np.array_equal(http_i, local_i) or not (http_i[:4, 0] == np.arange(4)).all():
        fail(f"serve_int8: /search ids {http_i[:, 0]} differ from the in-process search "
             f"{local_i[:, 0]} or miss the index images")
    print(f"serve_int8: cli quant of 32 PNGs {quant_s:.1f} s (scales equal to calibrate_scales'); "
          f"index of {n_rows} x {dim} (fp16 pickle) written in {index_s:.1f} s; cli serve "
          f"--quant_scales up in {start_s:.1f} s; /healthz ok, /embed {embed_ms:.1f} ms (max-abs "
          f"{err_embed:.3g} to the in-process embed), /embed_batch of 4 ({err_batch:.3g}), "
          f"/search of 8, k=5, {search_ms:.1f} ms: ids equal to the in-process search, the 4 "
          f"index images at rank 0; launches {launches}")
    shutil.rmtree(work, ignore_errors=True)

    # 5. `cli bench`, few iterations
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(["bench", "--iters", "3"])
    line = out.getvalue().strip().splitlines()[-1]
    bench = json.loads(line)
    if rc != 0 or bench["detail"].get("skipped") or len(bench["detail"]["configs"]) != 2 \
            or not bench["value"]:
        fail(f"serve_int8: cli bench: {line}")
    print(f"serve_int8: cli bench --iters 3: {line}")
    report["serve_int8"] = dict(
        gate_cosine=cos, rates=rates, forward_parts=parts, quant_s=quant_s, index_s=index_s, server_start_s=start_s,
        embed_request_ms=embed_ms, search_request_ms=search_ms, bench=bench,
        seconds=time.perf_counter() - t_phase)
    print(f"serve_int8: phase {report['serve_int8']['seconds']:.1f} s")


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
        CONFIGS, probe_gemm, probe_gemm_plain, transpose_s8)
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
          "bf16->fp32, bf16->bf16 and int8->int32 on wgmma; ragged rows, batch 16 and "
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
        else:  # the int8 call's first kernel, B's transpose, alone
            if not torch.equal(transpose_s8(b)[0], b.t()):
                fail("transpose_s8 is not the transpose of B")
            t_ms = common.time_ms(lambda: transpose_s8(b), args.reps)
            rows["int8_transpose"] = dict(ms=t_ms, bound_ms=2 * k * n / common.HBM_BYTES_PER_S
                                          * 1e3, bound_by="bytes")
            print(f"P_gemm int8 transpose of B ({k},{n}) -> ({n},{k}): {t_ms:.4f} ms, inside "
                  f"every int8 call above (bound {rows['int8_transpose']['bound_ms']:.4f} ms, "
                  "bytes)")
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
    best8 = min(rows["int8"], key=lambda r: r["ms"])
    print(f"P_gemm ({m},{k})@({k},{n}) int8: best tile {best8['label']} {best8['ms']:.4f} ms = "
          f"{best8['rate']:.1f} TOP/s (transpose included), torch._int_mm "
          f"{best8['control_ms']:.4f} ms, bound {best8['bound_ms']:.4f} ms")
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


def toy_city(num_points=120):
    """The CLI's toy city at the flagship's size (120 poses on a 150 m loop,
    180x240; or ``num_points`` poses) with rendered images kept, so that the
    phases that share it and their evals render each pose once."""
    from soft_contrastive_learning_torch.data.pipeline import ToyCitySource

    class KeptToyCity(ToyCitySource):
        def __init__(self, **kw):
            super().__init__(**kw)
            self._kept = {}

        def load_image(self, key):
            if key not in self._kept:
                self._kept[key] = super().load_image(key)
            return self._kept[key]

    return KeptToyCity(num_points=num_points, radius=150.0, img_h=180, img_w=240)


def instrument(torch, tr, pooled=True):
    """Wrap a trainer's step (``train_step_pooled``, or the host-fed
    ``train_step``), sampler, eval hooks and checkpoint writes: every step
    timed on the device (``tr.step_events``) and its call on the host clock
    (``tr.step_calls``), the first batch kept (``tr.first_batch``), the
    image indices of every sample drawn (``tr.drawn``), and the seconds of
    the eval hooks and the checkpoint writes (``tr.timing``)."""
    attr = "train_step_pooled" if pooled else "train_step"
    step, sample = getattr(tr, attr), tr._sample
    tr.drawn, tr.step_events, tr.step_calls, tr.first_batch = [], [], [], {}
    tr.timing = {"eval_s": 0.0, "save_s": 0.0}

    def recording_sample(*args):
        out = sample(*args)
        tr.drawn.append(None if out is None else tuple(out.indices.reshape(-1).tolist()))
        return out

    def timed_step(state, batch, *pool):
        if not tr.first_batch:
            tr.first_batch.update({k: v.clone() if torch.is_tensor(v) else v
                                   for k, v in batch.items()})
        tr.step_calls.append(time.perf_counter())
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = step(state, batch, *pool)
        end.record()
        tr.step_events.append((start, end))
        return out

    tr._sample = recording_sample
    setattr(tr, attr, timed_step)
    run_eval, save = tr._run_eval, tr.ckpts.save

    def timed_save(*args, **kwargs):
        torch.cuda.synchronize()
        t = time.perf_counter()
        save(*args, **kwargs)
        tr.timing["save_s"] += time.perf_counter() - t

    def timed_eval(*args):  # the rolling save inside it counts as a save
        torch.cuda.synchronize()
        t, saved = time.perf_counter(), tr.timing["save_s"]
        run_eval(*args)
        torch.cuda.synchronize()
        tr.timing["eval_s"] += time.perf_counter() - t - (tr.timing["save_s"] - saved)

    tr.ckpts.save = timed_save
    tr._run_eval = timed_eval
    return tr


def train_epoch(torch, np, report, path, cfg, params, source, expect, out_dir=None,
                resume=None):
    """One epoch through Trainer.train() from ``params``, every step timed
    on the device; fails unless the kernels launched ``expect`` times on it.
    ``out_dir``: a run directory that outlives the call (default: a
    temporary one); ``resume``: the checkpoint role to take up from it first.
    Returns the trainer (``instrument``: ``tr.drawn``, the image indices of
    every sample drawn), per-step losses and ms, the epoch's
    wall seconds and how many of them the eval hooks took (they render the
    held-out city's images on the host) and the checkpoint writes took, the
    pool set-up seconds, each
    kernel's launches on this path, the eval scalars and the first batch."""
    from soft_contrastive_learning_torch.train.trainer import Trainer

    with tempfile.TemporaryDirectory() as tmp_dir:
        tr = Trainer(cfg, source, out_dir=out_dir or tmp_dir, device="cuda", params=params)
        if resume is not None and not tr.resume_latest(resume):
            fail(f"{path}: no '{resume}' checkpoint to resume from in {out_dir}")
        instrument(torch, tr, pooled=cfg.device_image_pool)
        t0 = time.perf_counter()  # set-up: render the city into the card's image pool
        tr._ensure_image_pool(source.epoch_meta(cfg.local_ref_set, 0))
        pool_s = time.perf_counter() - t0
        counts = LaunchCounts(report, path)
        t0 = time.perf_counter()
        tr.train()
        torch.cuda.synchronize()
        epoch_s = time.perf_counter() - t0
        launches = counts.read(expect)
        losses = run_losses(tr)
        evals = {f"{role}/{r['tag']}@{r['step']}": r["value"] for role in ("other", "local")
                 for r in tr.writers[role].read_all()
                 if r["tag"] not in ("learning_rate",) and (role, r["tag"]) != ("local", "loss")}
        tr.close()
    step_ms = [s.elapsed_time(e) for s, e in tr.step_events]
    return (tr, losses, step_ms, (epoch_s, tr.timing["eval_s"], tr.timing["save_s"]), pool_s,
            launches, evals, tr.first_batch)


def run_losses(tr):
    """The training losses a run wrote to metrics_local.jsonl, in order."""
    return [r["value"] for r in tr.writers["local"].read_all() if r["tag"] == "loss"]


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


# ---------------------------------------------------------------- file-fed training
FILE_SETS = ("train_ref", "train_query", "test_ref", "test_query")
FILES_ANCHORS = 40  # the file-fed epoch is cut to its first 40 anchors: 20 steps
FILES_RESUME_STEP = 10  # a part checkpoint at anchor 20, a refresh boundary
# kernel launches of the 20-step epoch: 2 refreshes of 3 embeds of 50, the
# eval hooks at step 0 (2 held-out loss batches, 4 embeds)
FILES_FORWARDS = 20 + 2 * 3 + 2 + 4


def cli_train(torch, report, path, args, expect, pooled=True, checkpoints=True):
    """``cli.main(args)``, one training run, its trainer instrumented
    (``instrument``, on the pooled or the host-fed step) and kept; fails
    unless the kernels launched ``expect`` times on it. ``checkpoints=False``
    writes none (the trainer still drains its PCA updater where it would).
    Returns (trainer, return code, seconds, launches)."""
    from soft_contrastive_learning_torch import cli
    from soft_contrastive_learning_torch.train import trainer as trainer_mod

    made = []

    class Recording(trainer_mod.Trainer):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.ckpts.enabled = checkpoints
            made.append(instrument(torch, self, pooled=pooled))

    counts = LaunchCounts(report, path)
    real = trainer_mod.Trainer
    trainer_mod.Trainer = Recording
    try:
        t0 = time.perf_counter()
        rc = cli.main(args)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    finally:
        trainer_mod.Trainer = real
    launches = counts.read(expect)
    (tr,) = made
    return tr, rc, seconds, launches


def files_train_args(roots, out_root, out_folder):
    """``cli train`` from the prep tree ``roots``: the flagship from the
    trained weights with fused wms, the host feed (no device image pool),
    and the toy epochs' cadence (mining every 20 anchors over a cache of
    100, the eval hooks once, before the first step), a part checkpoint
    every 20 anchors."""
    from soft_contrastive_learning_torch.models.weights import TRAINED_PARAMS_PATH

    return ["train", "--img_root", roots["img_root"], "--shuffled_root", roots["shuffled_root"],
            "--anchor_root", roots["anchor_root"], "--loc_ref_root", roots["loc_ref_root"],
            "--loss", "wms", "--fused_wms", "True", "--device_image_pool", "False",
            "--checkpoint", str(TRAINED_PARAMS_PATH), "--max_epoch", "1",
            "--mining_step", "20", "--mining_cache_size", "100", "--eval_step", "1000",
            "--save_step", "20", "--num_eval_queries", "4", "--eval_ref_r", "10",
            "--out_root", out_root, "--out_folder", out_folder]


def decode_rate(np, paths, workers):
    """Images per second decoding ``paths`` with the port's PNG decoder on
    ``workers`` threads."""
    from concurrent.futures import ThreadPoolExecutor

    from soft_contrastive_learning_torch.utils.io import load_img

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=workers) as ex:
        n = sum(1 for _ in ex.map(load_img, paths))
    return n / (time.perf_counter() - t0)


def paeth_copies(np, paths, out_dir):
    """The same images written with the Paeth filter on every row (the
    filter that does not vectorize along a row)."""
    from soft_contrastive_learning_torch.utils.io import FILTER_PAETH, load_img, save_img

    out_dir.mkdir(parents=True, exist_ok=True)
    out = []
    for i, p in enumerate(paths):
        out.append(str(out_dir / f"{i:05d}.png"))
        save_img(load_img(p), out[-1], filters=FILTER_PAETH)
    return out


def phase_train_files(torch, np, report, shared):
    """The toy city of the training phases written as the prep pipeline's
    tree with the port's PNG writer, and ``cli train`` from it on the host
    feed: 20 steps (the anchor list cut to 40) from the trained weights,
    decoded on the trainer's 8 threads and built ahead by its Prefetcher.
    Gates: steps, refreshes, exact K1/K1_bwd/K3 counts, finite losses; the
    first batch's pixels byte for byte the toy-city source's; its loss the
    pooled toy-city step's on the same sample (1e-5 relative at fp32, 1e-4
    at bf16); a fresh Trainer resumed from the part checkpoint of step 10 on
    the host feed within 10x the run-to-run floor (at least 1e-6) of the
    uninterrupted run, on the same batches."""
    from soft_contrastive_learning_torch import cli
    from soft_contrastive_learning_torch.core.config import LossConfig, ModelConfig, TrainConfig
    from soft_contrastive_learning_torch.data.corpus import write_prep_tree
    from soft_contrastive_learning_torch.data.pipeline import (
        FilesystemSource, load_images_standard)
    from soft_contrastive_learning_torch.losses.registry import build_loss
    from soft_contrastive_learning_torch.models.model import EmbeddingNet
    from soft_contrastive_learning_torch.train.step import build_train_step, init_train_state

    source, params = shared["source"], shared["train_params"]
    work = tempfile.TemporaryDirectory()
    root = Path(work.name)
    t0 = time.perf_counter()
    roots = write_prep_tree(source, str(root / "prep"), FILE_SETS, anchor_r=1, cluster_r=10,
                            max_anchors=FILES_ANCHORS)
    write_s = time.perf_counter() - t0
    pngs = sorted(str(p) for p in Path(roots["img_root"]).rglob("*.png"))
    decode = {"sub_8_threads": decode_rate(np, pngs, 8), "sub_1_thread": decode_rate(np, pngs, 1)}
    paeth = paeth_copies(np, pngs[:64], root / "paeth")
    decode.update(paeth_8_threads=decode_rate(np, paeth, 8),
                  paeth_1_thread=decode_rate(np, paeth, 1))
    print(f"train_files: wrote {len(pngs)} PNGs of the toy city as a prep tree in {write_s:.2f} s; "
          f"decode {decode['sub_8_threads']:.1f} img/s on 8 threads, "
          f"{decode['sub_1_thread']:.1f} on one (as written: Sub filter); every row Paeth: "
          f"{decode['paeth_8_threads']:.1f} / "
          f"{decode['paeth_1_thread']:.1f} img/s")

    args = files_train_args(roots, str(root / "runs"), "a")
    cfg = cli.config_from_args(cli.build_parser().parse_args(args))
    tr, rc, epoch_s, launches = cli_train(
        torch, report, "train_files", args, {"K1": FILES_FORWARDS, "K1_bwd": 20, "K3": 20 + 2},
        pooled=False)
    losses = run_losses(tr)
    if rc != 0 or tr.global_step != 20 or tr.mining.refresh_count != 2 or len(losses) != 20:
        fail(f"train_files: rc {rc}, {tr.global_step} steps, {tr.mining.refresh_count} refreshes, "
             f"{len(losses)} losses; expected 0, 20, 2, 20")
    if not np.isfinite(losses).all():
        fail(f"train_files: non-finite losses {losses}")

    # the first batch: the files' pixels against the toy-city source's
    meta = source.epoch_meta(cfg.local_ref_set, 0)
    keys = [(meta["date"][i], meta["folder"][i], meta["t"][i]) for i in tr.drawn[0]]
    want = load_images_standard(source, keys, cfg)
    got = tr.first_batch["images"].cpu().numpy()
    if got.shape != want.shape or not np.array_equal(got, want):
        fail(f"train_files: the first batch's pixels differ from the toy city's "
             f"({got.shape} vs {want.shape}, {int((got != want).sum())} bytes)")
    # its loss: the host-fed step against the pooled step on the toy city's
    # images of the same sample, from the trained weights
    batch = {k: v for k, v in tr.first_batch.items() if k != "images"}
    pool = torch.from_numpy(want).cuda()
    pooled = dict(batch, image_idx=torch.arange(len(want), device="cuda"))
    rel = {}
    for dtype in ("float32", "bfloat16"):
        c = TrainConfig(model=ModelConfig(compute_dtype=dtype), loss=LossConfig(fused_wms=True))
        loss_fn = build_loss(c.loss, c.tuples, c.tuples_per_batch)
        got_loss = []
        for image_pool in (False, True):
            model = EmbeddingNet(c.model)
            model.load_state_dict(params)
            step = build_train_step(c, loss_fn, image_pool=image_pool)
            state = init_train_state(c, model.cuda())
            out = step(state, pooled, pool) if image_pool else step(state, dict(tr.first_batch))
            got_loss.append(out[1]["loss"].item())
        rel[dtype] = abs(got_loss[0] - got_loss[1]) / abs(got_loss[1])
        print(f"train_files parity {dtype}: first-batch loss host-fed from the files "
              f"{got_loss[0]:.8f}, pooled from the toy city {got_loss[1]:.8f} "
              f"(rel {rel[dtype]:.3g})")
    rel["run_first_loss"] = abs(losses[0] - got_loss[1]) / abs(got_loss[1])
    if rel["float32"] > 1e-5 or rel["bfloat16"] > 1e-4 or rel["run_first_loss"] > 1e-4:
        fail(f"train_files: the file-fed first batch's loss departs from the pooled path's: {rel}")

    # stop and resume on the host feed: a second uninterrupted run (the
    # floor), then a fresh Trainer from the part checkpoint of step 10
    files = FilesystemSource(**roots)
    again, again_losses, *_ = train_epoch(
        torch, np, report, "train_files_again", cfg, params, files,
        {"K1": FILES_FORWARDS, "K1_bwd": 20, "K3": 22}, out_dir=str(root / "runs" / "again"))
    part = Path("checkpoints") / "part" / str(FILES_RESUME_STEP)
    run_a = root / "runs" / "a"
    if not (run_a / part / "state.pt").exists():
        fail(f"train_files: no part checkpoint at step {FILES_RESUME_STEP}: "
             f"{sorted(str(p) for p in run_a.rglob('*.pt'))}")
    (root / "runs" / "b" / part).parent.mkdir(parents=True)
    shutil.copytree(run_a / part, root / "runs" / "b" / part)
    resumed, resumed_losses, *_ = train_epoch(
        torch, np, report, "train_files_resumed", cfg, None, files,
        {"K1": 10 + 3, "K1_bwd": 10, "K3": 10}, out_dir=str(root / "runs" / "b"), resume="part")
    final = tr.state.model.state_dict()
    half = FILES_RESUME_STEP

    def against_first(other, other_losses):
        state = other.state.model.state_dict()
        tail = np.asarray(losses[half:])
        if len(other_losses) != len(tail) or not np.isfinite(other_losses).all():
            fail(f"train_files: {len(other_losses)} losses after step {half}; expected {len(tail)}")
        return dict(last_loss=float(abs(other_losses[-1] - tail[-1])),
                    param=max((state[k] - final[k]).abs().max().item() for k in final),
                    same_batches=other.drawn[-len(tail):] == tr.drawn[half:])

    floor = against_first(again, again_losses[half:])
    got_resume = against_first(resumed, resumed_losses)
    gate = {key: max(10 * floor[key], 1e-6) for key in ("last_loss", "param")}
    print(f"train_files_resumed: from part@{half} to step {resumed.global_step} on the host feed; "
          f"against the uninterrupted run: {got_resume}; floor from a second run: {floor}; "
          f"gates {gate}")
    if resumed.global_step != 20 or not got_resume["same_batches"] \
            or got_resume["last_loss"] > gate["last_loss"] or got_resume["param"] > gate["param"]:
        fail(f"train_files_resumed: {resumed.global_step} steps, {got_resume} against the floor "
             f"{floor}")

    step_ms = [s.elapsed_time(e) for s, e in tr.step_events]
    med = statistics.median(step_ms[1:])
    # the host-fed step on the host clock: the median interval between two
    # step calls (the intervals across the refresh at step 10 are the outliers)
    wall_ms = 1e3 * statistics.median(t1 - t0 for t0, t1 in zip(tr.step_calls, tr.step_calls[1:]))
    b = cfg.images_per_batch
    run_s = epoch_s - tr.timing["eval_s"] - tr.timing["save_s"]
    pooled_report = report["train"]
    print(f"train_files: {tr.global_step} steps, {tr.mining.refresh_count} refreshes in "
          f"{epoch_s:.2f} s (cli.main, set-up included), of which the eval hooks "
          f"{tr.timing['eval_s']:.2f} s and the checkpoint writes {tr.timing['save_s']:.2f} s; "
          f"launches {launches}; host-fed step {wall_ms:.3f} ms between step calls "
          f"({1e3 * b / wall_ms:.1f} img/s), {med:.3f} ms between its CUDA events (median "
          f"after the first); the pooled epoch's step {pooled_report['median_step_ms']:.3f} ms "
          f"on the device, {pooled_report['epoch_img_s']:.1f} img/s end to end")
    report["train_files"] = dict(
        steps=tr.global_step, refreshes=tr.mining.refresh_count, images=len(pngs),
        write_s=write_s, decode_img_s=decode, epoch_s=epoch_s, eval_s=tr.timing["eval_s"],
        save_s=tr.timing["save_s"], median_step_ms=med, step_wall_ms=wall_ms,
        step_wall_img_s=1e3 * b / wall_ms, first_step_ms=step_ms[0],
        epoch_img_s=20 * b / run_s, pooled_median_step_ms=pooled_report["median_step_ms"],
        pooled_epoch_img_s=pooled_report["epoch_img_s"], parity_rel=rel,
        first_loss=losses[0], last_loss=losses[-1],
        resume=dict(resumed_from_step=half, vs_uninterrupted=got_resume, floor=floor))
    work.cleanup()


# ---------------------------------------------------------------- the loss zoo
# Gates of the losses phase: each loss in fp32 on the card against the same
# function in float64 on the card, value within LOSS_VALUE_TOL * max(1, |v|),
# gradient with respect to the embeddings within LOSS_GRAD_TOL of its largest
# entry, or of LOSS_GRAD_FLOOR where that is smaller (prodwrd's gradient is
# ~1e-16: its negative spectrum's feature weights, sigmoid(-50 (1 - sim)),
# leave products that only fp32 noise moves). Set from the first reading on
# the card (H100): values at most 4.2e-7 off, gradients 3.8e-5 (wrd).
LOSS_VALUE_TOL = 1e-5
LOSS_GRAD_TOL = 5e-4
LOSS_GRAD_FLOOR = 1e-9
# (loss, steps, --train_ref_r): the toy city's 120 poses lie 7.85 m apart, so
# r = 24 takes every 3rd (40 anchors, 20 steps) and r = 47 every 6th (10 steps)
ZOO_RUNS = (("wrd", 20, 24), ("pairwise_distance_neg_eigenvalue", 10, 47), ("quadruplet", 10, 47))
# a toy-city epoch's K1 forwards besides the steps': a refresh per 20 anchors
# (3 embeds of 50), the eval hooks at step 0 (2 held-out loss batches, 4 embeds)
ZOO_REFRESH_EMBEDS, ZOO_EVAL_FORWARDS = 3, 2 + 4


def zoo_batch(torch, np, shared, shape):
    """One batch of 2 tuples of ``shape`` from the dense toy city (seeded
    anchors, no hard mining), embedded by the flagship from the trained
    weights (bf16 convs, K1): (anchors, indices, fp32 embeddings (50,
    32,768) on the card)."""
    from soft_contrastive_learning_torch.core.config import LossConfig, TrainConfig
    from soft_contrastive_learning_torch.data.pipeline import load_images_standard
    from soft_contrastive_learning_torch.models.model import EmbeddingNet
    from soft_contrastive_learning_torch.train.step import build_embed_step
    from soft_contrastive_learning_torch.utils.meta import image_keys

    source, cfg = shared["dense_city"], TrainConfig()
    meta = source.epoch_meta(cfg.local_ref_set, 0)
    anchors = source.anchor_indices(cfg.local_ref_set, 1, 0)[:2]
    indices = zoo_sample(np, shared, LossConfig(name="wms"), shape, anchors).indices
    model = EmbeddingNet(cfg.model)
    model.load_state_dict(shared["train_params"])
    images = load_images_standard(source, image_keys(meta, indices.reshape(-1)), cfg)
    out, _ = build_embed_step(model.cuda())(torch.from_numpy(images).cuda())
    return anchors, indices, out.float().clone()


def zoo_sample(np, shared, loss_cfg, shape, anchors):
    """The port's sampler on the dense toy city from the seed, without hard
    mining: the same tuples for every loss of a shape, with that loss's
    payload."""
    from soft_contrastive_learning_torch.core.config import TupleConfig
    from soft_contrastive_learning_torch.sampling.tuples import TupleSampler
    from soft_contrastive_learning_torch.utils.meta import get_xy, get_yaw

    meta = shared["dense_city"].epoch_meta("train_ref", 0)
    sampler = TupleSampler(TupleConfig(), loss_cfg, shape, get_xy(meta), get_yaw(meta),
                           rng=np.random.default_rng(SEED))
    return sampler.sample(anchors)


def wrd_like_gram(torch, np, rng, m):
    """A pair of (m, m) Grams with wrd's structure, jittered as the port's
    (``ops/spectral.py``): 12 members drawn with replacement from 1-12 unit
    directions (scaled 0.05-0.5), the other m - 12 random unit rows weighted
    by the geometric sigmoid of a distance in 0-150 m, rows shuffled."""
    from soft_contrastive_learning_torch.ops import spectral

    x = np.zeros((2, m, 512))
    for t in range(2):
        k = rng.integers(1, 13)
        base = rng.standard_normal((k, 512))
        base /= np.linalg.norm(base, axis=1, keepdims=True)
        far = rng.standard_normal((m - 12, 512))
        far /= np.linalg.norm(far, axis=1, keepdims=True)
        x[t, :12] = base[rng.integers(0, k, 12)] * rng.uniform(0.05, 0.5)
        x[t, 12:] = far / (1.0 + np.exp(0.8 * (rng.uniform(0, 150, m - 12) - 15)))[:, None]
        x[t] = x[t][rng.permutation(m)]
    return spectral._jittered_gram(torch.from_numpy(x).float().cuda())


def phase_losses(torch, np, report, shared):
    """The 29 losses that need no streaming-PCA state, each at the
    flagship's B = 50 (2 tuples of 1+12+12, quadruplets 1+12+11+1) on
    descriptors of a dense toy city's images from the trained weights, with
    the sampler's fp32 payload for its distance type, and the four
    incremental losses against loss PCAs initialized as the trainer does
    (``incremental_losses``): value and gradient
    with respect to the embeddings in fp32 on the card against the same
    function in float64 on the card (LOSS_VALUE_TOL, LOSS_GRAD_TOL above),
    finite, the same bits twice; forward + backward timed on the device and
    on the host, and whether it waits for the card (PyTorch's sync debug
    mode: the eigensolves). Then the eigensolve: cuSOLVER's failures and
    error in fp32 and in float64 on 900 seeded wrd-like Grams (float64 must
    converge on all), each solve's time, and wrd's Gram through the port
    against a float64 Gram."""
    from soft_contrastive_learning_torch.core.config import (
        INCREMENTAL_LOSSES, LossConfig, TrainConfig, TupleConfig)
    from soft_contrastive_learning_torch.losses.registry import LOSS_NAMES, build_loss, split_batch
    from soft_contrastive_learning_torch.ops import spectral
    from soft_contrastive_learning_torch.perf import common

    # 1,200 poses 0.79 m apart on the 150 m loop, as dense as a drive's
    # frames: ~38 candidate positives within 15 m, where the 120-pose city
    # has 2-4 and its 12 positives repeat, which leaves the residual
    # matrices rank-deficient and the singular values' gradients undefined
    shared["dense_city"] = toy_city(num_points=1200)
    batches = {}
    rows, worst = {}, {"value": 0.0, "grad": 0.0}
    for name in (n for n in LOSS_NAMES if n not in INCREMENTAL_LOSSES):
        loss_cfg = LossConfig(name=name)
        shape = TrainConfig(loss=loss_cfg).tuple_shape
        if shape not in batches:
            batches[shape] = zoo_batch(torch, np, shared, shape)
            distinct = [len(set(r[1:13].tolist())) for r in batches[shape][1]]
            print(f"losses: batch {shape}: distinct positives per tuple {distinct}")
        anchors, indices, emb = batches[shape]
        sample = zoo_sample(np, shared, loss_cfg, shape, anchors)
        if not np.array_equal(sample.indices, indices):
            fail(f"losses: {name}'s sampler drew other tuples than the embedded batch")
        # the sampler's fp32 payload, on the card up front (a copy from host
        # memory waits), the same in both runs: wms's soft masks, computed
        # from it, underflow where fp32 does
        payload = {k: torch.from_numpy(v).cuda() for k, v in sample.payload.items()}
        fn = build_loss(loss_cfg, TupleConfig(), 2)

        def run(dtype, fn=fn, shape=shape, emb=emb, payload=payload):
            e = emb.to(dtype, copy=True).requires_grad_()
            total = fn(split_batch(e, 2, shape), payload).total
            (grad,) = torch.autograd.grad(total, e)
            return total.detach(), grad

        v32, g32 = run(torch.float32)
        v32b, g32b = run(torch.float32)
        v64, g64 = run(torch.float64)
        if not (torch.isfinite(v32) and torch.isfinite(g32).all()):
            fail(f"losses: {name} is not finite in fp32")
        if not (torch.equal(v32, v32b) and torch.equal(g32, g32b)):
            fail(f"losses: {name} gave other bits on a second call")
        value_err = abs(v32.item() - v64.item()) / max(1.0, abs(v64.item()))
        g_scale = g64.abs().max().item()
        grad_err = (g32.double() - g64).abs().max().item() / max(g_scale, LOSS_GRAD_FLOOR)
        host_ms, device_ms = common.host_and_device_ms(lambda: run(torch.float32), 10)
        torch.cuda.set_sync_debug_mode("error")  # does the call wait for the card?
        try:
            run(torch.float32)
            syncs = False
        except RuntimeError as e:
            if "synchronizing" not in str(e):
                raise
            syncs = True
        finally:
            torch.cuda.set_sync_debug_mode(0)
        rows[name] = dict(value=v32.item(), value_f64=v64.item(), value_err=value_err,
                          grad_max=g_scale, grad_err=grad_err, fwd_bwd_ms=device_ms,
                          host_ms=host_ms, host_waits=syncs)
        worst = {"value": max(worst["value"], value_err), "grad": max(worst["grad"], grad_err)}
        print(f"losses: {name:40s} value {v32.item():+.6e} (f64 {v64.item():+.6e}, err "
              f"{value_err:.2e}), grad max {g_scale:.3e} err {grad_err:.2e}; fwd+bwd "
              f"{device_ms:.3f} ms on the device, {host_ms:.3f} ms on the host behind ~50 ms of "
              f"queued work over 10 calls{' (waits for the card)' if syncs else ''}")
        if value_err > LOSS_VALUE_TOL or grad_err > LOSS_GRAD_TOL:
            fail(f"losses: {name} fp32 departs from float64: value {value_err:.3g} "
                 f"(gate {LOSS_VALUE_TOL}), gradient {grad_err:.3g} (gate {LOSS_GRAD_TOL})")

    inc_worst = incremental_losses(torch, np, shared, batches[(1, 12, 12)], rows)
    worst = {key: max(worst[key], inc_worst[key]) for key in worst}

    # the eigensolve: wrd's positive-weighted residuals of the batch, the
    # port's path (fp32 Gram, float64 solve) against a float64 Gram
    anchors, indices, emb = batches[(1, 12, 12)]
    w = zoo_sample(np, shared, LossConfig(name="wrd"), (1, 12, 12), anchors).payload["pos_weights"]
    grouped = emb.reshape(2, 25, -1)
    res = (grouped[:, 1:] - grouped[:, :1]) * torch.from_numpy(w).cuda()
    eig32, eig64 = spectral.gram_eigvals(res), spectral.gram_eigvals(res.double())
    eig_err = ((eig32.double() - eig64).abs().max() / eig64.abs().max()).item()
    s32, s64 = spectral.top_svdvals(res, 10), spectral.top_svdvals(res.double(), 10)
    sv_err = ((s32.double() - s64).abs() / s64).max().item()
    # cuSOLVER on 900 seeded wrd-like Grams (13, 24 and 25 wide, pairs): 12
    # members drawn with replacement from 1-12 directions, the others
    # weighted by the geometric sigmoid of a distance in 0-150 m; in fp32
    # and in float64, against the host's float64 LAPACK
    rng = np.random.default_rng(SEED)
    grams = [wrd_like_gram(torch, np, rng, m) for m in (13, 24, 25) for _ in range(300)]
    solver = {}
    for label, dtype in (("fp32", torch.float32), ("float64", torch.float64)):
        fails, err = 0, 0.0
        for g in grams:
            ref = np.linalg.eigvalsh(g.double().cpu().numpy())
            try:
                got = torch.linalg.eigvalsh(g.to(dtype)).double().cpu().numpy()
            except torch.linalg.LinAlgError:
                fails += 1
                continue
            err = max(err, float(np.abs(got - ref).max() / np.abs(ref).max()))
        gram = res @ res.transpose(1, 2)
        device_ms = common.time_ms(lambda: torch.linalg.eigvalsh(gram.to(dtype)), 50)
        torch.cuda.synchronize()
        torch.cuda._sleep(20_000_000)  # ~10 ms of queued work
        t0 = time.perf_counter()
        torch.linalg.eigvalsh(gram.to(dtype))
        host_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        solver[label] = dict(failures=fails, grams=len(grams), max_err=err, device_ms=device_ms,
                             host_ms_behind_10ms=host_ms)
        print(f"losses: cuSOLVER eigvalsh in {label}: {fails} of {len(grams)} wrd-like Grams "
              f"failed to converge, the others within {err:.2e} of the largest eigenvalue; "
              f"the batch's (2, 24, 24) {device_ms:.4f} ms on the device, a call "
              f"{host_ms:.3f} ms on the host behind ~10 ms of queued work")
    if solver["float64"]["failures"]:
        fail(f"losses: the float64 eigensolve failed on {solver['float64']['failures']} Grams")
    print(f"losses: wrd's (2, 24, 24) Gram through the port (fp32 Gram, float64 solve) against "
          f"a float64 Gram: {eig_err:.2e} of the largest eigenvalue, the top 10 singular values "
          f"within {sv_err:.2e} relative")
    print(f"losses: worst fp32-vs-float64 value {worst['value']:.3e}, gradient {worst['grad']:.3e} "
          f"(gates {LOSS_VALUE_TOL}, {LOSS_GRAD_TOL})")
    report["losses"] = dict(per_loss=rows, worst=worst,
                            gates=dict(value=LOSS_VALUE_TOL, grad=LOSS_GRAD_TOL),
                            gram_eig_err=eig_err, top10_sv_rel_err=sv_err, cusolver=solver)
    del batches


def phase_train_zoo(torch, np, report, shared):
    """``cli train --toy_city`` from the trained weights on the pooled path
    with no ``--loss`` (so ``wrd``) for 20 steps, then 10 steps each of
    ``pairwise_distance_neg_eigenvalue`` (a PN loss: two forwards, two
    backwards and two Adam updates a step) and ``quadruplet`` (tuples of
    1+12+11+1). Gates: steps, exact K1 / K1_bwd counts (no K3), finite
    losses (and loss_pos, loss_neg for PN), moved weights, Adam's count 2
    per PN step. Then each loss's step on its run's first batch timed in
    turns beside the flagship's wms step (K3), and the host's view: the
    median interval between step calls beside the CUDA-event step, and a
    call's host time behind queued work (a step that synchronizes waits)."""
    from soft_contrastive_learning_torch.losses.registry import build_loss
    from soft_contrastive_learning_torch.models.model import EmbeddingNet
    from soft_contrastive_learning_torch.models.weights import TRAINED_PARAMS_PATH
    from soft_contrastive_learning_torch.perf import common
    from soft_contrastive_learning_torch.train.step import build_train_step, init_train_state

    params = shared["train_params"]
    work = tempfile.TemporaryDirectory()
    runs, out = {}, {}
    for name, steps, ref_r in ZOO_RUNS:
        args = ["train", "--toy_city", "--checkpoint", str(TRAINED_PARAMS_PATH),
                "--max_epoch", "1", "--train_ref_r", str(ref_r), "--mining_step", "20",
                "--mining_cache_size", "100", "--eval_step", "1000", "--save_step", "1000",
                "--num_eval_queries", "4", "--eval_ref_r", "10", "--out_root", work.name,
                "--out_folder", name]
        if name != "wrd":  # wrd: the CLI's default
            args += ["--loss", name]
        pn = "eigenvalue" in name
        path = f"train_zoo_{name if not pn else 'pn'}"
        per_step = 2 if pn else 1
        refreshes = steps * 2 // 20
        tr, rc, epoch_s, launches = cli_train(
            torch, report, path, args, {"K1": per_step * steps + ZOO_REFRESH_EMBEDS * refreshes
                                        + ZOO_EVAL_FORWARDS, "K1_bwd": per_step * steps})
        records = tr.writers["local"].read_all()
        tags = {"loss", "loss_pos", "loss_neg"} if pn else {"loss"}
        losses = {t: [r["value"] for r in records if r["tag"] == t] for t in tags}
        if rc != 0 or tr.cfg.loss.name != name or tr.global_step != steps \
                or tr.mining.refresh_count != refreshes \
                or any(len(v) != steps for v in losses.values()):
            fail(f"{path}: rc {rc}, loss {tr.cfg.loss.name}, {tr.global_step} steps, "
                 f"{tr.mining.refresh_count} refreshes, {[len(v) for v in losses.values()]} "
                 f"losses; expected 0, {name}, {steps}, {refreshes}, {steps}")
        if not all(np.isfinite(v).all() for v in losses.values()):
            fail(f"{path}: non-finite losses {losses}")
        unmoved = [k for k, v in tr.state.model.state_dict().items()
                   if torch.equal(v.cpu(), params[k])]
        adam = {int(s["step"]) for s in tr.state.optimizer.state.values()}
        if unmoved or adam != {per_step * steps}:
            fail(f"{path}: unmoved parameters {unmoved[:5]}, Adam counts {adam}; expected "
                 f"{per_step * steps}")
        step_ms = [s.elapsed_time(e) for s, e in tr.step_events]
        med = statistics.median(step_ms[1:])
        wall_ms = 1e3 * statistics.median(t1 - t0 for t0, t1 in zip(tr.step_calls,
                                                                    tr.step_calls[1:]))
        print(f"{path}: {tr.global_step} steps, {tr.mining.refresh_count} refreshes in "
              f"{epoch_s:.2f} s (cli.main, set-up included); launches {launches}; Adam count "
              f"{per_step * steps}; first/last loss {losses['loss'][0]:.6f}/"
              f"{losses['loss'][-1]:.6f}; median step {med:.3f} ms on the device (CUDA events), "
              f"{wall_ms:.3f} ms between step calls")
        runs[name] = (tr.cfg, tr.first_batch, tr._image_pool.array)
        out[name] = dict(steps=steps, refreshes=refreshes, launches=launches, epoch_s=epoch_s,
                         median_step_ms=med, step_wall_ms=wall_ms, adam_count=per_step * steps,
                         first_loss=losses["loss"][0], last_loss=losses["loss"][-1])
        if pn:
            out[name].update(first_loss_pos=losses["loss_pos"][0],
                             first_loss_neg=losses["loss_neg"][0])

    # each loss's step on its run's first batch, and the flagship's wms step
    # (K3) on the standard epoch's, from the trained weights, in turns
    runs["wms"] = (train_config(), shared["first_batch"], shared["pool"])
    steps_by = {}
    for name, (cfg, batch, pool) in runs.items():
        model = EmbeddingNet(cfg.model)
        model.load_state_dict(params)
        steps_by[name] = (init_train_state(cfg, model.cuda()),
                          build_train_step(cfg, build_loss(cfg.loss, cfg.tuples,
                                                           cfg.tuples_per_batch),
                                           image_pool=True), batch, pool)
    order = ("wms", *(n for n, _, _ in ZOO_RUNS))
    turns = {name: [] for name in order}
    host = {name: [] for name in order}
    for name in (*order, *reversed(order)):
        state, one, batch, pool = steps_by[name]
        turns[name].append(common.time_ms(lambda: one(state, dict(batch), pool), 10))
        host[name].append(common.host_and_device_ms(lambda: one(state, dict(batch), pool), 10)[0])
    step_ms_by = {name: statistics.mean(t) for name, t in turns.items()}
    host_ms_by = {name: statistics.mean(t) for name, t in host.items()}
    print("train_zoo: step on one batch in turns (device ms; host ms per call behind ~50 ms "
          "of queued work over 10 calls): " + "; ".join(
              f"{n} {step_ms_by[n]:.3f} (host {host_ms_by[n]:.3f})" for n in order))
    report["train_zoo"] = dict(runs=out, step_ms_in_turns=step_ms_by,
                               host_ms_behind_hold=host_ms_by)
    work.cleanup()


# ---------------------------------------------------------------- the heads and the streaming PCAs
# the reductions held to their plain path at B = 50: (reduction, vlad_cores);
# vlad_cores=0 is the flattened conv5_3 map
HEADS = (("pca", 64), ("1fc", 64), ("2fc", 64), ("3fc", 64), ("spp", 64), ("none", 0))
# the images the heads phase fits its StreamingPCA on: more than out_dim + 1,
# so that every one of its 512 components is fitted (fewer leave components
# whose variance is the 1e-12 clamp, and whitening divides by it)
HEADS_PCA_IMAGES = 600
HEADS_COSINE = 0.99  # the serve phase's gate: bf16 with kernels against the fp32 plain model
# the served (bf16) 'pca' output's gate, set from the readings: the served
# projection read 0.969 (the projection computed in bf16 0.9698: the
# descriptor's bf16 error sets it, not the projection's), and the control,
# the served descriptor's error against the fp32 plain one doubled, must
# fall below it
HEADS_PCA_COSINE = 0.95
# the cli runs of train_heads: (label, --reduction, --loss, steps, --train_ref_r,
# --mining_step, --mining_cache_size, extra flags). The two streaming-PCA
# runs read a prep tree of the dense city (1,200 poses 0.79 m apart; the
# held-out sets are the 120-pose city's): r = 79 takes every 101st pose (12
# anchors, 6 steps), r = 118 every 150th (4 steps). Each of their refreshes
# embeds a window of HEADS_PCA_WINDOW images, more than the 513 rows that
# fit all 512 components of the PCA and of the loss PCA (a window of fewer
# leaves components at the 1e-12 variance clamp, which whitening divides
# by). The 'pca' run refreshes every 3 steps: the first initializes the PCA
# from the window, the second folds the window in, a batch at a time
# (update_multi: 12 host SVDs); each segment's third step waits for its
# first step's update (lag 2). The 'none' run: one segment of 4 steps. The
# '2fc' run reads the CLI's 120-pose toy city: r = 47 every 6th pose (10
# steps).
HEADS_PCA_WINDOW = 600
HEADS_TREE_RUNS = ("pca", "none")
HEAD_RUNS = (
    ("pca", "pca", "incremental_residual_mm", 6, 79, 6, HEADS_PCA_WINDOW - 6, ()),
    ("none", "none", "incremental_residual_mm", 4, 118, 8, HEADS_PCA_WINDOW - 8,
     ("--save_step", "1000")),
    ("2fc", "2fc", "wms", 10, 47, 20, 100, ("--fused_wms", "True", "--save_step", "1000")),
)
HEADS_RESUME_STEP = 3  # the pca run's part checkpoint at anchor 6: a refresh, drained
# incremental losses: the window a loss PCA is initialized from (more images
# than loss_dim + 1, as above) and the loss_dims tried for the det variants,
# the largest at which their fp32 products are finite and move is taken
INCREMENTAL_WINDOW = 600
DET_LOSS_DIMS = (512, 128, 32, 8)


def head_params(cfg, trained):
    """``cfg``'s parameters: the trained VGG16 (and NetVLAD, where the head
    keeps it) under a head drawn fresh from the seed."""
    from soft_contrastive_learning_torch.checkpoints.manager import warm_start_params
    from soft_contrastive_learning_torch.models.model import init_params

    params, _ = warm_start_params(init_params(cfg, SEED), trained)
    return params


def row_cosine(torch, a, b):
    return ((a * b).sum(1) / (a.norm(dim=1) * b.norm(dim=1))).min().item()


def phase_heads(torch, np, report, shared):
    """Each reduction at the flagship's width (180x240, K1 where NetVLAD
    runs) on a batch of 50 seeded images, from the trained backbone with a
    head drawn from the seed, under the serve phase's two gates: the served
    configuration (bf16 convs, kernels on) at cosine >= HEADS_COSINE to the
    fp32 plain path (use_kernels=False), and fp32 with the kernels at
    cosine >= 0.99999 to it; output and full_out of the widths the config
    gives, finite. 'pca' is projected by a StreamingPCA fitted on
    HEADS_PCA_IMAGES images' descriptors: its bf16 whitened output is held
    to HEADS_PCA_COSINE instead (whitening brings the descriptors'
    low-variance tail, where the bf16 convs' error sits, to unit variance),
    and a control, the served descriptor with its error against the fp32
    plain one doubled, must fall below that gate. K1 once per forward where NetVLAD runs, else never. Then a DescriptorService with '1fc' embeds 512 index
    and 64 query images to 512-D (16 queries are index images and must come
    back at rank 0), pads the index with seeded rows of its per-column
    normal to 66,048, and searches it (K2 at D = 512), held to an fp64
    search within 1e-5 of |q|^2."""
    import dataclasses

    from soft_contrastive_learning_torch.core.config import ModelConfig
    from soft_contrastive_learning_torch.models.heads import apply_pca_projection
    from soft_contrastive_learning_torch.models.model import EmbeddingNet
    from soft_contrastive_learning_torch.ops.kernels.topk import (
        topk_l2_cuda, topk_l2_stream_plain)
    from soft_contrastive_learning_torch.pca.incremental import StreamingPCA
    from soft_contrastive_learning_torch.perf import common
    from soft_contrastive_learning_torch.serving import STREAM_MIN_ROWS, DescriptorService

    trained = shared["train_params"]
    rng = np.random.default_rng(SEED + 3)
    imgs = blocky_images(rng, HEADS_PCA_IMAGES)
    x = torch.from_numpy(imgs[:50]).cuda()
    rows = {}
    for reduction, vlad in HEADS:
        name = reduction if vlad else "flatten"
        cfg = ModelConfig(reduction=reduction, vlad_cores=vlad)
        params = head_params(cfg, trained)
        fp32 = dataclasses.replace(cfg, compute_dtype="float32")
        models = {}
        for label, c in (("served", cfg), ("fp32", fp32),
                         ("plain", dataclasses.replace(fp32, use_kernels=False))):
            m = EmbeddingNet(c)
            m.load_state_dict(params)
            models[label] = m.cuda().eval()
        counts = LaunchCounts(report, f"heads_{name}")
        with torch.inference_mode():
            got = {"served": models["served"](x)}
        torch.cuda.synchronize()
        netvlad = models["served"].netvlad is not None
        launches = counts.read({"K1": int(netvlad)})
        with torch.inference_mode():
            got.update((label, models[label](x)) for label in ("fp32", "plain"))
            if reduction == "pca":  # fit on the served descriptors, project all three
                feats = torch.cat([models["served"](torch.from_numpy(imgs[s : s + 50]).cuda())[1]
                                   for s in range(0, len(imgs), 50)])
                pca = StreamingPCA(cfg.out_dim)
                t0 = time.perf_counter()
                pca.init(feats.cpu().numpy())
                fit_s = time.perf_counter() - t0
                state = [torch.from_numpy(a).cuda() for a in (pca.v, pca.m, pca.var)]
                got = {label: (apply_pca_projection(full, *state), full)
                       for label, (_, full) in got.items()}
            ms = common.time_ms(lambda: models["served"](x), 10)
        out, full = got["served"]
        want = ((50, cfg.output_dim), (50, cfg.descriptor_dim))
        if any((tuple(o.shape), tuple(f.shape)) != want
               or not (torch.isfinite(o).all() and torch.isfinite(f).all())
               for o, f in got.values()):
            fail(f"heads {name}: output {tuple(out.shape)}, full_out {tuple(full.shape)}; "
                 f"expected {want}, finite")
        ref_out, ref_full = got["plain"]
        cos = {f"{label}_{part}": row_cosine(torch, t.float(), ref)
               for label in ("served", "fp32")
               for part, t, ref in (("output", got[label][0], ref_out),
                                    ("full_out", got[label][1], ref_full))}
        gates = {"served_full_out": HEADS_COSINE, "fp32_output": 0.99999,
                 "fp32_full_out": 0.99999,
                 "served_output": HEADS_PCA_COSINE if reduction == "pca" else HEADS_COSINE}
        rows[name] = dict(output_dim=cfg.output_dim, descriptor_dim=cfg.descriptor_dim,
                          launches=launches, cosine_to_fp32_plain=cos, gates=gates,
                          forward_ms_b50=ms)
        extra = ""
        if reduction == "pca":
            # controls: the served descriptor projected in bf16, and with its
            # error against the fp32 plain descriptor doubled
            full = got["served"][1]
            controls = {
                "bf16_projection": apply_pca_projection(
                    full.bfloat16(), *(t.bfloat16() for t in state[:2]), state[2]),
                "error_doubled": apply_pca_projection(2 * full - ref_full, *state)}
            controls = {k: row_cosine(torch, v.float(), ref_out) for k, v in controls.items()}
            rows[name].update(pca_fit_s=fit_s, controls=controls)
            extra = (f"; the PCA fit on {len(feats)} descriptors {fit_s:.2f} s on the host; "
                     f"controls (served_output): " + ", ".join(
                         f"{k} {v:.6f}" for k, v in controls.items()))
            if controls["error_doubled"] >= HEADS_PCA_COSINE:
                fail(f"heads pca: the doubled error's cosine {controls['error_doubled']} "
                     f"passes the gate {HEADS_PCA_COSINE}: the gate does not see it")
        print(f"heads {name}: output {cfg.output_dim}-D, full_out {cfg.descriptor_dim}-D; cosine "
              f"to the fp32 plain path: " + ", ".join(f"{k} {v:.6f}" for k, v in cos.items())
              + f"; K1 launches {launches['K1']}; forward {ms:.3f} ms at B=50{extra}")
        if any(cos[k] < g for k, g in gates.items()):
            fail(f"heads {name}: cosine to the fp32 plain path {cos} under the gates {gates}")
        del models, got

    # /search over a 1fc index: 512-D rows, K2 at that width
    cfg = ModelConfig(reduction="1fc")
    params = head_params(cfg, trained)
    index_imgs, query_imgs = imgs[:512], np.concatenate([imgs[:512:32], imgs[512:560]])
    n_rows, k = 66048, 5
    assert n_rows > STREAM_MIN_ROWS
    counts = LaunchCounts(report, "heads_search")
    embedder = DescriptorService(cfg, params, batch_size=64)
    descs = torch.from_numpy(embedder.embed(index_imgs)).cuda()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    pad = torch.randn((n_rows - len(descs), cfg.out_dim), generator=gen, device="cuda")
    index = torch.cat([descs, descs.mean(0) + pad * descs.std(0)])
    service = DescriptorService(cfg, params, batch_size=64, index=index)
    dists, ids = service.search(query_imgs, k=k)
    torch.cuda.synchronize()
    launches = counts.read({"K1": 8 + 1, "K2": 1})
    if service.embed_dim != cfg.out_dim or not (ids[:16, 0] == np.arange(0, 512, 32)).all():
        fail(f"heads_search: embed_dim {service.embed_dim}, rank-0 ids {ids[:16, 0]}")
    q = torch.from_numpy(service.embed(query_imgs)).cuda()
    got_d, got_i = topk_l2_cuda(q, index, k)
    want_sq, want_i, gaps = exact_search(torch, q, index, k)
    q_sq = (q.double() ** 2).sum(1, keepdim=True)
    err = ((got_d.double() ** 2 - want_sq[:, :k]).abs() / q_sq).max().item()
    differ = got_i != want_i[:, :k]
    if err > 1e-5 or (differ & (gaps > 1e-5 * q_sq)).any():
        fail(f"heads_search: K2 vs the exact search: sq-dist err {err} of |q|^2, "
             f"{int(differ.sum())} ids differ outside near-ties")
    k2_ms = common.time_ms(lambda: topk_l2_cuda(q, index, k), 3)
    plain_ms = common.time_ms(lambda: topk_l2_stream_plain(q, index, k), 3)
    # phase_k2's bound: 3xTF32 products against each input read once
    nq, dim = q.shape
    bound, bound_by = common.bound_ms(6 * nq * n_rows * dim,
                                      4 * (n_rows * dim + nq * dim) + 12 * nq * k,
                                      common.TF32_FLOPS)
    print(f"heads_search: 1fc service, 512-D, {n_rows} rows; 16/16 index images at rank 0; "
          f"launches {launches}; K2 vs the exact search {err:.3g} of |q|^2, {int(differ.sum())} "
          f"ids differ at near-ties; K2 {k2_ms:.4f} ms (bound {bound:.4f}, {bound_by}), the "
          f"plain version {plain_ms:.4f} ms")
    report["heads"] = dict(per_head=rows, search=dict(rows=n_rows, dim=dim, k=k,
                                                      sq_err_of_q2=err, k2_ms=k2_ms,
                                                      bound_ms=bound, bound_by=bound_by,
                                                      plain_ms=plain_ms))


def heads_npz(np, cfg, trained, path):
    """The trained flagship's arrays and a head drawn from the seed, in the
    flax layout of ``models/weights.py`` (a dense kernel (in, out)), float16
    as the committed artifact: what ``train --checkpoint`` takes for a head."""
    from soft_contrastive_learning_torch.models.weights import TRAINED_PARAMS_PATH

    with np.load(TRAINED_PARAMS_PATH) as data:
        flat = {k: data[k] for k in data.files}
    for name, t in head_params(cfg, trained).items():
        if name.startswith("fc_head."):
            _, layer, kind = name.split(".")
            arr = t.numpy().T if kind == "weight" else t.numpy()
            flat[f"fc_head/{layer}/{'kernel' if kind == 'weight' else 'bias'}"] = arr
    np.savez(path, **{k: v.astype(np.float16) for k, v in flat.items()})
    return path


def pca_gap(np, a, b):
    """How far apart two streaming PCAs are: the largest difference of the
    singular values, the means and the variances, each over its largest
    entry, and of a component up to its sign; and whether the counts agree."""
    sa, sb = a.state_dict(), b.state_dict()
    rel = {k: float(np.abs(sa[k] - sb[k]).max() / max(np.abs(sb[k]).max(), 1e-30))
           for k in ("s", "m", "var")}
    cos = np.abs((sa["v"].astype(np.float64) * sb["v"]).sum(1))
    live = np.linalg.norm(sb["v"], axis=1) > 0
    rel["v"] = float((1 - cos[live]).max()) if live.any() else 0.0
    return rel, (sa["seen"], sa["true_seen"]) == (sb["seen"], sb["true_seen"])


def phase_train_heads(torch, np, report, shared):
    """``cli train`` at the flagship's width from the trained weights,
    pooled, as train_zoo's runs (eval hooks at step 0): HEAD_RUNS, 'pca'
    with incremental_residual_mm (the streaming PCA of the 32,768-D
    descriptor, 512 components, and the loss PCA of its 512-D projection)
    and 'none' with incremental_residual_mm (the 32,768-wide loss PCA),
    both from a prep tree of the dense city with mining windows of
    HEADS_PCA_WINDOW images, and '2fc' with the fused wms (K3 at D = 512)
    on the toy city from an npz that holds the trained backbone and a
    seeded head. Gates: steps, refreshes, exact K1, K1_bwd and K3 counts,
    finite losses, moved weights, the PCAs' update counts. The 'pca' run is
    also run a second time (the floor) and taken up again by a fresh
    Trainer from its part checkpoint of step HEADS_RESUME_STEP (a refresh,
    where the updater was drained): the parameters and both PCAs within 10x
    the floor (at least 1e-6) of the uninterrupted run's, their counts
    equal. Then, per run, the device time of a step (CUDA events) beside the
    interval between step calls and each refresh's PCA fits (init,
    update_multi) on the host clock; the host's PCA update at each width,
    and the (2, 525, 525) eigensolve."""
    from soft_contrastive_learning_torch.core.config import ModelConfig
    from soft_contrastive_learning_torch.data.corpus import write_prep_tree
    from soft_contrastive_learning_torch.data.pipeline import FilesystemSource
    from soft_contrastive_learning_torch.models.weights import TRAINED_PARAMS_PATH
    from soft_contrastive_learning_torch.ops import spectral
    from soft_contrastive_learning_torch.pca.incremental import StreamingPCA
    from soft_contrastive_learning_torch.perf import common
    from soft_contrastive_learning_torch.utils.io import save_csv

    trained = shared["train_params"]
    dense, toy = shared["dense_city"], shared["source"]
    work = tempfile.TemporaryDirectory()
    root = Path(work.name)
    # the dense city's training sets and the toy city's held-out ones, and
    # the anchors of every tree run's r
    t0 = time.perf_counter()
    prep = str(root / "prep")
    ref_rs = [run[4] for run in HEAD_RUNS if run[0] in HEADS_TREE_RUNS]
    tree = write_prep_tree(dense, prep, ("train_ref", "train_query"), anchor_r=ref_rs[0],
                           cluster_r=10)
    write_prep_tree(toy, prep, ("test_ref", "test_query"), anchor_r=ref_rs[0], cluster_r=10)
    for r in ref_rs:
        save_csv({"idx": [int(i) for i in dense.anchor_indices("train_ref", r, 0)]},
                 str(Path(tree["anchor_root"]) / f"train_ref_{r}_000.csv"))
    tree_s = time.perf_counter() - t0
    tree_args = [f"--{k}={v}" for k, v in tree.items()]
    # the eval hooks' forwards at step 0: the held-out loss's 2 batches, and
    # each localization's references (every 10th pose) and its 4 queries
    tree_eval_forwards = 2 + sum(-(-len(src.cluster_meta(s, 10)["t"]) // 50) + 1
                                 for src, s in ((toy, "test_ref"), (dense, "train_ref")))
    print(f"train_heads: wrote the dense city's prep tree in {tree_s:.2f} s")

    # every fit of a refresh, timed on the host clock
    fits, real_fits = [], {name: getattr(StreamingPCA, name) for name in ("init", "update_multi")}

    def timed_fit(name):
        def fit(self, x, *args):
            t0 = time.perf_counter()
            result = real_fits[name](self, x, *args)
            fits.append(dict(fit=name, rows=len(x), width=int(x.shape[1]),
                             components=self.out_dim, ms=1e3 * (time.perf_counter() - t0)))
            return result
        return fit

    out, trainers = {}, {}
    for label, reduction, loss, steps, ref_r, mining_step, cache, extra in HEAD_RUNS:
        checkpoint = TRAINED_PARAMS_PATH
        if reduction.endswith("fc"):
            checkpoint = heads_npz(np, ModelConfig(reduction=reduction), trained,
                                   root / f"{label}.npz")
        refreshes = -(-steps * 2 // mining_step)
        window = -(-(cache + mining_step) // 50)  # the embeds of a refresh
        fused = "--fused_wms" in extra
        on_tree = label in HEADS_TREE_RUNS
        source_args = tree_args if on_tree else ["--toy_city"]
        eval_forwards = tree_eval_forwards if on_tree else ZOO_EVAL_FORWARDS
        for run in ("a", "again") if label == "pca" else ("a",):
            path = f"train_heads_{label}" + ("" if run == "a" else "_again")
            args = ["train", *source_args, "--checkpoint", str(checkpoint), "--max_epoch", "1",
                    "--reduction", reduction, "--loss", loss, "--train_ref_r", str(ref_r),
                    "--mining_step", str(mining_step), "--mining_cache_size", str(cache),
                    "--eval_step", "1000", "--save_step", str(2 * HEADS_RESUME_STEP),  # part@0, @3
                    "--num_eval_queries", "4", "--eval_ref_r", "10", "--out_root",
                    str(root), "--out_folder", f"{label}_{run}", *extra]
            expect = {"K1": steps + window * refreshes + eval_forwards, "K1_bwd": steps}
            if fused:
                expect["K3"] = steps + 2  # and the held-out loss's two batches
            fits.clear()
            for name in real_fits:
                setattr(StreamingPCA, name, timed_fit(name))
            try:
                # a 2fc checkpoint at this width holds 1.8 GB (fc1 is 4,096 x 32,768)
                tr, rc, seconds, launches = cli_train(torch, report, path, args, expect,
                                                      checkpoints=label != "2fc")
            finally:
                for name, fn in real_fits.items():
                    setattr(StreamingPCA, name, fn)
            losses = run_losses(tr)
            if rc != 0 or tr.global_step != steps or tr.mining.refresh_count != refreshes \
                    or len(losses) != steps or not np.isfinite(losses).all():
                fail(f"{path}: rc {rc}, {tr.global_step} steps, {tr.mining.refresh_count} "
                     f"refreshes, losses {losses}; expected 0, {steps}, {refreshes}, finite")
            unmoved = [k for k, v in tr.state.model.state_dict().items()
                       if k in trained and torch.equal(v.cpu(), trained[k])]
            if unmoved:
                fail(f"{path}: parameters did not move: {unmoved[:5]}")
            # the PCAs' rows: the pca initialized from the first refresh's
            # window, then a batch a step and the later refreshes' windows; the
            # loss pca from 513 residuals, then the 48 residuals of each step
            n_window = cache + mining_step
            for pca, want in ((tr.pca, n_window * refreshes + 50 * steps),
                              (tr.loss_pca, 513 + 48 * steps)):
                if pca is not None and pca.true_seen != want:
                    fail(f"{path}: a streaming PCA saw {pca.true_seen} rows, expected {want}")
            # the spread of the kept variances that whitening divides by: the
            # forgetting factor (0.4) shrinks an old direction's variance
            # 0.16x a step, and the clamp is 1e-12
            spread = {name: dict(min_over_max=float(pca.var.min() / pca.var.max()),
                                 at_clamp=int((pca.var <= 1e-12).sum()))
                      for name, pca in (("pca", tr.pca), ("loss_pca", tr.loss_pca))
                      if pca is not None}
            step_ms = [s.elapsed_time(e) for s, e in tr.step_events]
            calls = [1e3 * (t1 - t0) for t0, t1 in zip(tr.step_calls, tr.step_calls[1:])]
            trainers[path] = tr
            out[path] = dict(steps=steps, refreshes=refreshes, window=cache + mining_step,
                             launches=launches, seconds=seconds, losses=list(losses),
                             step_ms=step_ms, step_interval_ms=calls,
                             median_step_ms=statistics.median(step_ms),
                             median_interval_ms=statistics.median(calls),
                             refresh_fits=list(fits), variance_spread=spread)
            print(f"{path}: {steps} steps, {refreshes} refreshes of {cache + mining_step} images "
                  f"in {seconds:.2f} s (cli.main, set-up included); launches {launches}; losses "
                  f"{[round(float(v), 4) for v in losses]}; a step "
                  f"{statistics.median(step_ms):.3f} ms on the device (median), "
                  f"{statistics.median(calls):.1f} ms between step calls (median of "
                  f"{[round(c) for c in calls]}); the refreshes' fits on the host: "
                  + ("; ".join(f"{f['fit']} {f['rows']} x {f['width']} -> {f['components']} "
                               f"{f['ms']:.0f} ms" for f in fits) or "none")
                  + "".join(f"; {name}'s variances at the end: smallest/largest "
                            f"{v['min_over_max']:.3g}, {v['at_clamp']} at the clamp"
                            for name, v in spread.items()))

    # stop and take up again: a fresh Trainer with only the part checkpoint
    first, again = trainers["train_heads_pca"], trainers["train_heads_pca_again"]
    part = Path("checkpoints") / "part" / str(HEADS_RESUME_STEP)
    resumed_dir = root / "pca_resumed"
    shutil.copytree(root / "pca_a" / part, resumed_dir / part)
    steps = HEAD_RUNS[0][3]
    rest = steps - HEADS_RESUME_STEP
    cfg = first.cfg
    window = -(-HEADS_PCA_WINDOW // 50)  # the resumed segment's refresh, no update
    resumed, resumed_losses, *_ = train_epoch(
        torch, np, report, "train_heads_pca_resumed", cfg, None,
        FilesystemSource(cfg.img_root, cfg.shuffled_root, cfg.anchor_root, cfg.loc_ref_root),
        {"K1": rest + window, "K1_bwd": rest}, out_dir=str(resumed_dir), resume="part")

    def gap(other):
        a, b = other.state.model.state_dict(), first.state.model.state_dict()
        pcas = {name: pca_gap(np, getattr(other, name), getattr(first, name))
                for name in ("pca", "loss_pca")}
        return dict(param=max((a[k] - b[k]).abs().max().item() for k in b),
                    pcas={n: g for n, (g, _) in pcas.items()},
                    counts=all(same for _, same in pcas.values()))

    floor, got = gap(again), gap(resumed)
    gates = {"param": max(10 * floor["param"], 1e-6)}
    for n in ("pca", "loss_pca"):
        for key, value in floor["pcas"][n].items():
            gates[f"{n}.{key}"] = max(10 * value, 1e-6)
    got_flat = {"param": got["param"], **{f"{n}.{k}": v for n, g in got["pcas"].items()
                                          for k, v in g.items()}}
    print(f"train_heads_pca_resumed: from part@{HEADS_RESUME_STEP} to step "
          f"{resumed.global_step}; against the uninterrupted run {got_flat}, counts equal: "
          f"{got['counts']}; floor from a second uninterrupted run {floor}; gates {gates}")
    if resumed.global_step != steps or not got["counts"] or len(resumed_losses) != rest or any(
            got_flat[k] > gates[k] for k in gates):
        fail(f"train_heads_pca_resumed: {got_flat} outside 10x the floor {gates}, counts "
             f"{got['counts']}, {resumed.global_step} steps")

    # the host's update at each width, and the loss's eigensolve on the card
    rng = np.random.default_rng(SEED)
    updates = {}
    for label, pca, rows in (("pca 32768-D, 50 rows", first.pca, 50),
                             ("loss_pca 512-D, 48 rows", first.loss_pca, 48),
                             ("loss_pca 32768-D, 48 rows", trainers["train_heads_none"].loss_pca,
                              48)):
        copy = StreamingPCA.from_state_dict(pca.state_dict())
        x = rng.standard_normal((rows, copy.v.shape[1])).astype(np.float32) * 0.01
        times = []
        for _ in range(2):
            t0 = time.perf_counter()
            copy.update(x)
            times.append(1e3 * (time.perf_counter() - t0))
        updates[label] = dict(stack_rows=copy.out_dim + rows + 1, ms=times)
        print(f"train_heads: host update of the {label} PCA (a {copy.out_dim + rows + 1} x "
              f"{copy.v.shape[1]} float64 SVD): {', '.join(f'{t:.1f}' for t in times)} ms")
    # an incremental loss's stack at the defaults, its float64 Gram and the solve
    stack = torch.randn((2, 525, 32768), generator=torch.Generator(device="cuda")
                        .manual_seed(SEED), device="cuda").double()
    gram_ms = common.time_ms(lambda: spectral._jittered_gram(stack), 5)
    gram = spectral._jittered_gram(stack)
    eig_ms = common.time_ms(lambda: torch.linalg.eigvalsh(gram), 5)
    torch.cuda.synchronize()
    torch.cuda._sleep(20_000_000)  # ~10 ms of queued work
    t0 = time.perf_counter()
    torch.linalg.eigvalsh(gram)
    eig_host_ms = 1e3 * (time.perf_counter() - t0)
    torch.cuda.synchronize()
    print(f"train_heads: an incremental loss's (2, 525, 32768) stack: its float64 Gram "
          f"{gram_ms:.3f} ms, the (2, 525, 525) float64 eigensolve {eig_ms:.3f} ms on the "
          f"device, a solve {eig_host_ms:.3f} ms on the host behind ~10 ms of queued work")
    report["train_heads"] = dict(runs=out, tree_s=tree_s,
                                 resume=dict(got=got_flat, floor=floor, gates=gates),
                                 host_pca_update=updates,
                                 eigensolve_2x525=dict(gram_ms=gram_ms, device_ms=eig_ms,
                                                       host_ms=eig_host_ms))
    work.cleanup()


def incremental_window(torch, np, shared, n):
    """The trained flagship's descriptors of the first ``n`` images of the
    dense city's epoch 0 (a mining window as the trainer embeds one): (n,
    32,768) fp32 on the card."""
    from concurrent.futures import ThreadPoolExecutor

    from soft_contrastive_learning_torch.core.config import TrainConfig
    from soft_contrastive_learning_torch.data.pipeline import load_images_standard
    from soft_contrastive_learning_torch.models.model import EmbeddingNet
    from soft_contrastive_learning_torch.train.step import build_embed_step
    from soft_contrastive_learning_torch.utils.meta import image_keys

    source, cfg = shared["dense_city"], TrainConfig()
    meta = source.epoch_meta(cfg.local_ref_set, 0)
    model = EmbeddingNet(cfg.model)
    model.load_state_dict(shared["train_params"])
    embed = build_embed_step(model.cuda())
    feats = []
    with ThreadPoolExecutor(8) as pool:
        for s in range(0, n, 50):
            keys = image_keys(meta, np.arange(s, min(s + 50, n)))
            images = load_images_standard(source, keys, cfg, pool)
            feats.append(embed(torch.from_numpy(images).cuda())[0].float())
    return torch.cat(feats)


def incremental_losses(torch, np, shared, batch, rows):
    """The four incremental losses on the (1, 12, 12) batch against loss
    PCAs initialized as the trainer does from a window of
    INCREMENTAL_WINDOW descriptors of the dense city: from 513 residuals of
    random pairs (rand_pairs) for the residual pair, from the window's
    descriptors for the others, 512 components each. The mm variants at
    loss_dim 512; the det variants at the largest of DET_LOSS_DIMS whose
    fp32 loss is finite with a gradient (the fit truncated to it), and the
    sum of the logs of their top-512 values (float64) is printed: the fp32
    product is inf past ~88 and 0 below ~-103. Value within LOSS_VALUE_TOL
    of max(1, |v|) (for det, of the products it is the difference of) and
    gradient within LOSS_GRAD_TOL of its largest entry of float64 on the
    card; the same bits twice. Returns the worst errors."""
    from soft_contrastive_learning_torch.core.config import (
        INCREMENTAL_LOSSES, LossConfig, TupleConfig)
    from soft_contrastive_learning_torch.losses import incremental as inc
    from soft_contrastive_learning_torch.losses.registry import build_loss, split_batch
    from soft_contrastive_learning_torch.pca.incremental import skl_init
    from soft_contrastive_learning_torch.perf import common
    from soft_contrastive_learning_torch.train.mining_manager import rand_pairs

    _, _, emb = batch
    feats = incremental_window(torch, np, shared, INCREMENTAL_WINDOW).cpu().numpy()
    pairs = rand_pairs(np.random.default_rng(SEED), len(feats), 512 + 1)
    t0 = time.perf_counter()
    fits = {"residual": skl_init(np.stack([feats[i] - feats[j] for i, j in pairs]), 512),
            "members": skl_init(feats, 512)}
    fit_s = time.perf_counter() - t0

    def state(fit, dims, dtype):
        s, v, m, seen = fit[0][:dims], fit[1][:dims], fit[2], fit[3]
        return inc.PCAState(*(torch.as_tensor(np.asarray(a)).to("cuda", dtype)
                              for a in (s, v, m, np.float32(seen))))

    grouped = emb.reshape(2, 25, -1)
    worst = {"value": 0.0, "grad": 0.0}
    for name in INCREMENTAL_LOSSES:
        fit = fits["residual" if "residual" in name else "members"]
        anchor, pos, neg = grouped[:, :1], grouped[:, 1:13], grouped[:, 13:]
        pos, neg = ((pos - anchor, neg - anchor) if "residual" in name else
                    (torch.cat([anchor, pos], 1), torch.cat([anchor, neg], 1)))
        st64 = state(fit, 512, torch.float64)
        logs = [torch.log(inc.incremental_s(x.double(), st64)[:, :512]).sum(1).tolist()
                for x in (pos, neg)]
        for dims in (DET_LOSS_DIMS if "det" in name else (512,)):
            fn = build_loss(LossConfig(name=name, loss_dim=dims), TupleConfig(), 2)
            states = {dt: state(fit, dims, dt) for dt in (torch.float32, torch.float64)}

            def run(dtype, fn=fn, states=states):
                e = emb.to(dtype, copy=True).requires_grad_()
                total = fn(split_batch(e, 2, (1, 12, 12)), {}, states[dtype]).total
                (grad,) = torch.autograd.grad(total, e)
                return total.detach(), grad

            v32, g32 = run(torch.float32)
            if torch.isfinite(v32) and torch.isfinite(g32).all() and g32.abs().max() > 0:
                break
        else:
            fail(f"losses: {name} has no finite fp32 loss with a gradient at {DET_LOSS_DIMS}")
        v32b, g32b = run(torch.float32)
        v64, g64 = run(torch.float64)
        if not (torch.equal(v32, v32b) and torch.equal(g32, g32b)):
            fail(f"losses: {name} gave other bits on a second call")
        scale = max(1.0, abs(v64.item()))
        if "det" in name:  # the products the loss is the difference of
            prods = [inc.stable_prod(inc.incremental_s(x.double(), states[torch.float64])[:, :dims])
                     for x in (pos, neg)]
            scale = max(scale, (prods[0].abs() + prods[1].abs()).mean().item())
        value_err = abs(v32.item() - v64.item()) / scale
        g_scale = g64.abs().max().item()
        grad_err = (g32.double() - g64).abs().max().item() / max(g_scale, LOSS_GRAD_FLOOR)
        host_ms, device_ms = common.host_and_device_ms(lambda: run(torch.float32), 5)
        rows[name] = dict(loss_dim=dims, value=v32.item(), value_f64=v64.item(),
                          value_err=value_err, grad_max=g_scale, grad_err=grad_err,
                          fwd_bwd_ms=device_ms, host_ms=host_ms, sum_log_top512=logs)
        worst = {"value": max(worst["value"], value_err), "grad": max(worst["grad"], grad_err)}
        print(f"losses: {name:40s} loss_dim {dims}: value {v32.item():+.6e} (f64 "
              f"{v64.item():+.6e}, err {value_err:.2e}), grad max {g_scale:.3e} err "
              f"{grad_err:.2e}; fwd+bwd {device_ms:.3f} ms on the device, {host_ms:.3f} ms on "
              f"the host; sum of log of the top 512 values (pos, neg stacks, per tuple) "
              f"{[[round(v, 1) for v in side] for side in logs]}")
        if value_err > LOSS_VALUE_TOL or grad_err > LOSS_GRAD_TOL:
            fail(f"losses: {name} fp32 departs from float64: value {value_err:.3g} "
                 f"(gate {LOSS_VALUE_TOL}), gradient {grad_err:.3g} (gate {LOSS_GRAD_TOL})")
    print(f"losses: the loss PCAs' two fits (513 x 32,768 residuals, {INCREMENTAL_WINDOW} x "
          f"32,768 descriptors) took {fit_s:.2f} s on the host")
    return worst


# ---------------------------------------------------------------- the paper's pipeline
# the rehearsal corpus's geometry cut in refs (3,000 -> 750); PCA and query
# sets at the rehearsal's 4,400 and 300, so that whitening reaches D = 4,096
# and the 250k-row search has the rehearsal's queries
REHEARSAL_CUT = dict(n_ref=750, n_query=300, n_pca=4400)
TOPN_DIMS = (64, 128, 256, 512, 1024)
TOPN_WITHIN_25M = 90.0  # % of the toy queries whose top-1 is within 25 m at l0.0_dim256


def phase_infer(torch, np, report, shared):
    """The rehearsal's three sets (cut: 750 refs) rendered with the port's
    PNG writer on 8 processes (set-up, timed apart), then ``cli infer`` for
    each, float32, and the queries once more as float16: the committed
    trained flagship at batch 32. Gates: K1 once per batch; dumps of shape
    (N, 32,768), finite and unit-norm; on 64 ref images, cosine >= 0.99 to
    the fp32 plain model; the float16 dump within 1e-3 of the float32 one."""
    from concurrent.futures import ThreadPoolExecutor

    from soft_contrastive_learning_torch import cli
    from soft_contrastive_learning_torch.core.config import ModelConfig
    from soft_contrastive_learning_torch.data.corpus import rehearsal_sets, write_image_set
    from soft_contrastive_learning_torch.evaluation import inference
    from soft_contrastive_learning_torch.models.model import EmbeddingNet
    from soft_contrastive_learning_torch.utils.io import load_img, load_pickle

    work = shared["corpus"] = tempfile.TemporaryDirectory()
    root = Path(work.name)
    img_root, csv_root, lv = root / "imgs", root / "lists", root / "lv"
    sets = rehearsal_sets(**REHEARSAL_CUT)
    t0 = time.perf_counter()
    rel = {name: write_image_set(city, name, str(img_root), str(csv_root), workers=8)
           for name, city in sets.items()}
    render_s = time.perf_counter() - t0
    n_images = sum(len(c) for c in sets.values())
    sizes = ", ".join(f"{k} {len(v)}" for k, v in sets.items())
    print(f"infer: rendered {n_images} images ({sizes}) as PNG on 8 processes in {render_s:.1f} s "
          f"({n_images / render_s:.1f} img/s)")

    events = []  # CUDA events around every embed: the card's busy time
    real_build = inference.build_embed_step

    def timed_build(model):
        embed = real_build(model)

        def timed(x):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = embed(x)
            end.record()
            events.append((start, end))
            return out

        return timed

    runs = [(name, "wms", "float32") for name in ("toy_pca", "toy_ref", "toy_query")]
    runs.append(("toy_query", "wms16", "float16"))
    counts = LaunchCounts(report, "infer")
    walls = {}
    inference.build_embed_step = timed_build
    try:
        for name, out_name, dtype in runs:
            t0 = time.perf_counter()
            rc = cli.main(["infer", "--set", name, "--csv_root", str(csv_root), "--img_root",
                           str(img_root), "--out_root", str(lv), "--out_name", out_name,
                           "--dump_dtype", dtype])
            torch.cuda.synchronize()
            walls[f"{name}_{out_name}"] = time.perf_counter() - t0
            if rc != 0:
                fail(f"infer {name} ({dtype}): rc {rc}")
    finally:
        inference.build_embed_step = real_build
    batches = sum(-(-len(sets[name]) // 32) for name, _, _ in runs)
    launches = counts.read({"K1": batches})
    busy_s = sum(s.elapsed_time(e) for s, e in events) / 1e3
    wall_s = sum(walls.values())

    dumps = {}
    for name, out_name, dtype in runs:
        d = load_pickle(str(lv / f"{name}_{out_name}.pickle"))
        n = len(sets[name])
        if d.shape != (n, 32768) or d.dtype != np.dtype(dtype) or not np.isfinite(d).all():
            fail(f"infer {name}: dump {d.shape} {d.dtype}, finite {np.isfinite(d).all()}")
        norms = np.linalg.norm(d.astype(np.float64), axis=1)
        if np.abs(norms - 1).max() > 1e-3:
            fail(f"infer {name}: norms {norms.min()}..{norms.max()}")
        dumps[f"{name}_{out_name}"] = d
    f16_err = float(np.abs(dumps["toy_query_wms16"].astype(np.float32)
                           - dumps["toy_query_wms"]).max())
    ref_cfg = ModelConfig(compute_dtype="float32", use_kernels=False)
    model = EmbeddingNet(ref_cfg)
    model.load_state_dict(shared["train_params"])
    model = model.cuda().eval()
    imgs = np.stack([load_img(str(img_root / p)) for p in rel["toy_ref"][:64]])
    with torch.inference_mode():
        want = model(torch.from_numpy(imgs).cuda())[1].cpu().numpy()
    cos = float((want * dumps["toy_ref_wms"][:64]).sum(1).min())
    print(f"infer: launches {launches}; cosine to the fp32 plain model on 64 ref images {cos:.6f}; "
          f"float16 dump within {f16_err:.3g} of the float32 one")
    if cos < 0.99 or f16_err > 1e-3:
        fail(f"infer: descriptors part from the fp32 plain model ({cos}) or the float16 dump "
             f"from the float32 one ({f16_err})")

    pngs = [str(img_root / p) for p in rel["toy_ref"][:256]]
    decode = {"sub_8_threads": decode_rate(np, pngs, 8)}
    paeth = paeth_copies(np, pngs[:64], root / "paeth")
    decode["paeth_8_threads"] = decode_rate(np, paeth, 8)
    rates = {k: len(sets[k.rsplit("_", 1)[0]]) / v for k, v in walls.items()}
    print("infer: end to end (cli.main, the model's set-up included) "
          + ", ".join(f"{k} {v:.1f} img/s" for k, v in rates.items())
          + f"; the card busy {100 * busy_s / wall_s:.1f}% of the {wall_s:.1f} s "
          f"({busy_s:.2f} s of embeds by CUDA events); decode alone "
          f"{decode['sub_8_threads']:.1f} img/s on 8 threads as written (Sub), "
          f"{decode['paeth_8_threads']:.1f} with every row Paeth")
    report["infer"] = dict(images=n_images, render_s=render_s, walls=walls, img_s=rates,
                           busy_share=busy_s / wall_s, busy_s=busy_s, cos_to_fp32=cos,
                           f16_err=f16_err, decode_img_s=decode)
    shared.update(lv=lv, csv_root=csv_root, sets=sets)


def phase_topn(torch, np, report, shared):
    """``cli topn`` over the dumps (whitening fitted on toy_pca; D up to
    1,024, spacings 0, 0.3, 1 and 5 m, N = 25): 20 settings, all on the
    dense path (750 refs). Gates: every setting written with the pickle's
    six fields and their types; toy queries' top-1 within 25 m for >= 90% at
    l0.0_dim256. ``cli roc`` draws the figure where matplotlib is installed;
    the curves are computed with ``correctly_localized_curve`` either way."""
    import importlib.util

    from soft_contrastive_learning_torch import cli
    from soft_contrastive_learning_torch.evaluation.roc import correctly_localized_curve
    from soft_contrastive_learning_torch.utils.io import load_pickle

    lv, csv_root = shared["lv"], shared["csv_root"]
    top_n = Path(shared["corpus"].name) / "top_n"
    counts = LaunchCounts(report, "topn")
    t0 = time.perf_counter()
    rc = cli.main(["topn", "--pca_lv_pickle", str(lv / "toy_pca_wms.pickle"),
                   "--ref_lv_pickle", str(lv / "toy_ref_wms.pickle"),
                   "--query_lv_pickle", str(lv / "toy_query_wms.pickle"),
                   "--ref_csv", str(csv_root / "toy_ref.csv"),
                   "--query_csv", str(csv_root / "toy_query.csv"), "--out_root", str(top_n),
                   "--dims", ",".join(map(str, TOPN_DIMS))])
    torch.cuda.synchronize()
    topn_s = time.perf_counter() - t0
    launches = counts.read({})
    settings = sorted(p.parent.name for p in top_n.glob("*/toy_query_wms.pickle"))
    if rc != 0 or len(settings) != 4 * len(TOPN_DIMS):
        fail(f"topn: rc {rc}, {len(settings)} settings written: {settings}")
    curves = {}
    for setting in settings:
        got = load_pickle(str(top_n / setting / "toy_query_wms.pickle"))
        types = [type(x).__name__ for x in got]
        if types != ["list", "list", "ndarray", "list", "ndarray", "list"] \
                or got[2].shape != (300, 25) or got[2].dtype != np.float32:
            fail(f"topn {setting}: pickle fields {types}, top_f {np.shape(got[2])}")
        top1 = np.asarray(got[1])[:, 0]
        x, y = correctly_localized_curve(top1)  # % within each of 50 thresholds, 0-25 m
        curves[setting] = dict(within_5m=float((top1 < 5).mean() * 100),
                               within_10m=float((top1 < 10).mean() * 100),
                               within_25m=float((top1 < 25).mean() * 100),
                               curve_mean=float(y.mean()))
    share = curves["l0.0_dim256"]["within_25m"]
    print(f"topn: {len(settings)} settings in {topn_s:.2f} s (cli.main: one fit at D = "
          f"{max(TOPN_DIMS)}, the transforms, 20 dense searches); launches {launches}; top-1 "
          "within 5 / 10 / 25 m: " + "; ".join(
              f"{k} {v['within_5m']:.1f}/{v['within_10m']:.1f}/{v['within_25m']:.1f}"
              for k, v in curves.items()))
    if share < TOPN_WITHIN_25M:
        fail(f"topn: {share}% of the toy queries within 25 m at l0.0_dim256, below "
             f"{TOPN_WITHIN_25M}%")
    figure = None
    if importlib.util.find_spec("matplotlib") is not None:
        t0 = time.perf_counter()
        if cli.main(["roc", "--top_n_root", str(top_n), "--out_root",
                     str(top_n.parent / "figs"), "--queries", "toy_query"]) != 0:
            fail("roc: no figure")
        figure = time.perf_counter() - t0
        print(f"roc: figure in {figure:.2f} s")
    else:
        print("roc: matplotlib is not installed here, so no figure; the curves above are "
              "correctly_localized_curve's")
    report["topn"] = dict(settings=len(settings), seconds=topn_s, curves=curves,
                          roc_figure_s=figure)


TOPN_ROWS = 250_000  # the Pittsburgh query condition's database size


def phase_topn_250k(torch, np, report, shared):
    """``top_n_single`` at spacing 0 over 250,000 refs, where evaluation/
    topn.py takes K2: the whitened ref dump (fit on toy_pca at D = 4,096)
    padded with seeded rows drawn from its per-column normal, far from every
    query on the map; the 300 whitened queries; D = 256 and 4,096 (column
    slices of the one transform). Gates: two K2 launches a width (256 + 44
    queries); on 64 queries, squared distances within 1e-5 of the query's
    |q|^2 from an fp64 search on the card (the error relative to the top-1
    printed beside the plain fp32 version's), ids differing only at
    near-ties within that; and the repair: D = 66 over 200,001 rows of
    eighths, the plain version's ids and distances. Then K2 timed at both
    widths beside the dense topk_l2, the plain version and its bounds."""
    from soft_contrastive_learning_torch.evaluation.topn import _TILED_THRESHOLD, top_n_single
    from soft_contrastive_learning_torch.ops.kernels.topk import topk_l2_stream_plain
    from soft_contrastive_learning_torch.ops.topk import topk_l2, topk_l2_streamed
    from soft_contrastive_learning_torch.pca.whiten import fit_pca
    from soft_contrastive_learning_torch.perf import common
    from soft_contrastive_learning_torch.utils.io import load_csv, load_pickle
    from soft_contrastive_learning_torch.utils.meta import get_xy

    lv, csv_root = shared["lv"], shared["csv_root"]
    n, d_max, k = TOPN_ROWS, 4096, 25
    assert n > _TILED_THRESHOLD
    t0 = time.perf_counter()
    whitener = fit_pca(load_pickle(str(lv / "toy_pca_wms.pickle")), d_max, device="cuda")
    ref_w = whitener.transform(load_pickle(str(lv / "toy_ref_wms.pickle")))
    query_w = whitener.transform(load_pickle(str(lv / "toy_query_wms.pickle")))
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    refs = torch.empty((n, d_max), dtype=torch.float32, device="cuda")
    refs[: len(ref_w)] = ref_w
    mu, sd = ref_w.mean(0), ref_w.std(0)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    for s in range(len(ref_w), n, 16384):
        e = min(s + 16384, n)
        refs[s:e] = mu + sd * torch.randn((e - s, d_max), generator=gen, device="cuda")
    rng = np.random.default_rng(SEED + 3)
    ref_xy = np.concatenate([get_xy(load_csv(str(csv_root / "toy_ref.csv"))),
                             rng.uniform(1e5, 2e5, (n - len(ref_w), 2))])
    query_xy = get_xy(load_csv(str(csv_root / "toy_query.csv")))
    xy_d = np.linalg.norm(query_xy[:, None, :] - ref_xy[None, :, :], axis=-1)
    geo = (xy_d, np.argmin(xy_d, axis=1))
    ref_idx = list(range(n))

    counts = LaunchCounts(report, "topn_250k")
    results, walls = {}, {}
    for d in (256, d_max):
        t0 = time.perf_counter()
        results[d] = top_n_single(refs[:, :d], query_w[:, :d], ref_xy, query_xy, 0.0, n=k,
                                  ref_idx=ref_idx, geo=geo)
        walls[d] = time.perf_counter() - t0
    gen66 = torch.Generator(device="cuda").manual_seed(SEED + 4)
    q66 = eighths(torch, gen66, (64, 66))
    r66 = eighths(torch, gen66, (_TILED_THRESHOLD + 1, 66))
    got66 = topk_l2_streamed(q66, r66, k)
    torch.cuda.synchronize()
    launches = counts.read({"K2": 2 + 2 + 1})
    want66 = topk_l2_stream_plain(q66, r66, k)
    err66 = (got66[0] - want66[0]).abs().max().item()
    if not torch.equal(got66[1], want66[1]) or err66 > 1e-6 * want66[0].max().item():
        fail(f"topn_250k: the padded D = 66 search departs from the plain version "
             f"({int((got66[1] != want66[1]).sum())} ids, dist err {err66})")
    del q66, r66

    # against an fp64 search on the card. The whitened rows of another city
    # than the fit's have |q|^2 tens of times their top-1 squared distance,
    # and the fp32 formula |q|^2 - (2 q.r - |r|^2) cancels that much: the
    # gate's scale is the query's |q|^2 (on the served unit vectors, 1), and
    # the error relative to the top-1 is printed beside the plain version's
    by_d = {}
    for d, res in results.items():
        got_i = torch.tensor(res[0][:64], device="cuda")
        got_sq = torch.from_numpy(res[2][:64]).cuda().double() ** 2
        q = query_w[:64, :d].contiguous()
        plain_sq = topk_l2_stream_plain(q, refs[:, :d], k)[0].double() ** 2
        want_sq, want_i, gaps = exact_search(torch, q, refs[:, :d], k)
        q_sq = (q.double() ** 2).sum(1, keepdim=True)
        tol = 1e-5 * q_sq
        err = {}
        for label, sq in (("k2", got_sq), ("plain", plain_sq)):
            diff = (sq - want_sq[:, :k]).abs()
            err[f"{label}_of_q_sq"] = (diff / q_sq).max().item()
            err[f"{label}_of_top1"] = (diff / want_sq[:, :1]).max().item()
        differ = got_i != want_i[:, :k]
        if err["k2_of_q_sq"] > 1e-5 or (differ & (gaps > tol)).any():
            fail(f"topn_250k D={d}: sq-dist err {err}, {int(differ.sum())} ids differ, "
                 f"{int((differ & (gaps > tol)).sum())} outside near-ties")
        top1 = np.asarray(res[1])[:, 0]
        by_d[d] = dict(wall_s=walls[d], sq_err=err, ids_differ=int(differ.sum()),
                       q_sq_over_top1=float((q_sq / want_sq[:, :1]).median()),
                       within_25m=float((top1 < 25).mean() * 100),
                       real_refs_at_rank0=float((np.asarray(res[0])[:, 0] < len(ref_w)).mean()))

    for d in (256, d_max):
        r_c = refs[:, :d].contiguous()
        q_c = query_w[:, :d].contiguous()
        ms = common.time_ms(lambda: topk_l2_streamed(q_c, r_c, k), 5)
        dense_ms = common.time_ms(lambda: topk_l2(q_c, r_c, k), 3)
        plain_ms = common.time_ms(lambda: topk_l2_stream_plain(q_c, r_c, k), 3)
        nbytes = 4 * (n * d + len(q_c) * d) + 12 * len(q_c) * k
        bound, bound_by = common.bound_ms(6 * len(q_c) * n * d, nbytes, common.TF32_FLOPS)
        by_d[d].update(ms=ms, dense_ms=dense_ms, plain_ms=plain_ms, bound_ms=bound,
                       bound_by=bound_by, bytes_bound_ms=1e3 * nbytes / common.HBM_BYTES_PER_S)
        del r_c
    for d, row in by_d.items():
        e = row["sq_err"]
        print(f"topn_250k D={d}: top_n_single {row['wall_s']:.3f} s; vs fp64 on 64 queries: max "
              f"sq-dist err {e['k2_of_q_sq']:.3g} of |q|^2, {e['k2_of_top1']:.3g} of the top-1 "
              f"(|q|^2 {row['q_sq_over_top1']:.1f}x the top-1; the plain fp32 version "
              f"{e['plain_of_q_sq']:.3g} / {e['plain_of_top1']:.3g}), {row['ids_differ']} ids "
              f"differ (near-ties); top-1 a real ref for {100 * row['real_refs_at_rank0']:.1f}%, "
              f"within 25 m {row['within_25m']:.1f}%; K2 (Q=300: 2 launches) {row['ms']:.3f} ms, "
              f"dense topk_l2 {row['dense_ms']:.3f} ms, plain {row['plain_ms']:.3f} ms, bound "
              f"{row['bound_ms']:.3f} ms ({row['bound_by']}; bytes alone "
              f"{row['bytes_bound_ms']:.3f})")
    print(f"topn_250k: whitening fit (4,400 x 32,768, host eigh) and transforms {fit_s:.2f} s; "
          f"launches {launches}; padded D = 66 over {_TILED_THRESHOLD + 1} rows: ids identical, "
          f"max dist err {err66:.3g}")
    report["K2"]["topn_250k"] = {f"D{d}": {key: row[key] for key in (
        "ms", "dense_ms", "plain_ms", "bound_ms", "bound_by", "bytes_bound_ms")}
        for d, row in by_d.items()}
    report["topn_250k"] = dict(rows=n, queries=len(query_w), fit_s=fit_s, d66_err=err66,
                               by_d={f"D{d}": row for d, row in by_d.items()})
    del refs
    shared.pop("corpus").cleanup()
    torch.cuda.empty_cache()


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
    phase_serve_int8(torch, np, report, shared)
    phase_serve_winograd(torch, np, report, shared)
    phase_train(torch, np, report, shared)
    phase_train_winograd(torch, np, report, shared)
    phase_train_files(torch, np, report, shared)
    phase_losses(torch, np, report, shared)
    phase_train_zoo(torch, np, report, shared)
    phase_heads(torch, np, report, shared)
    phase_train_heads(torch, np, report, shared)
    phase_infer(torch, np, report, shared)
    phase_topn(torch, np, report, shared)
    phase_topn_250k(torch, np, report, shared)

    # launches: the count on the newest path that runs the kernel (the PCA
    # run with the incremental loss for K1 and its backward, the 2fc run for
    # K3, the 1fc /search for K2, the Winograd training epoch for K4);
    # launches_by_path: each path's own count, set to 0 just before it
    paths = ("train_heads_pca", "train_heads_2fc", "heads_search", "train_zoo_wrd", "topn_250k",
             "infer", "train_files", "train_winograd", "train", "serve_winograd", "serve_int8",
             "serve", "probes")
    for kid in KERNEL_IDS:
        by_path = report[kid]["launches_by_path"]
        report[kid]["launches"] = next((by_path[p] for p in paths if by_path.get(p)), 0)
        if report[kid]["launches"] <= 0:
            fail(f"{kid} was launched on no path")
    keys = ("name", "route", "source", "replaces", "launches", "launches_by_path",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    # the whole report, which the lines below print only in part, beside the
    # card's name and power limit
    out = Path("chiprun_out")
    out.mkdir(exist_ok=True)
    def plain(x):  # JSON keys are strings
        if isinstance(x, dict):
            return {str(k): plain(v) for k, v in x.items()}
        return [plain(v) for v in x] if isinstance(x, (list, tuple)) else x

    (out / "chip_smoke_report.json").write_text(
        json.dumps({"card": smi.stdout.strip(), "report": plain(report)}, default=str))
    print(json.dumps({"heads": report["heads"], "train_heads": report["train_heads"]}))
    print(json.dumps({"losses": report["losses"], "train_zoo": report["train_zoo"]}))
    print(json.dumps({"train_files": report["train_files"], "infer": report["infer"],
                      "topn": report["topn"], "topn_250k": report["topn_250k"]}))
    print(json.dumps({"serve": report["serve"], "serve_winograd": report["serve_winograd"]}))
    print(json.dumps({"serve_int8": report["serve_int8"],
                      "Q1_stem": {key: report["Q1_stem"][key] for key in ("row", "row_big")},
                      "Q1_per_layer": report["Q1"]["per_layer"],
                      "Q1_per_layer_big": report["Q1"]["per_layer_big"],
                      "Q1_pool_per_pool": report["Q1_pool"]["per_pool"]}))
    print(json.dumps({"train": report["train"], "train_winograd": report["train_winograd"],
                      "K1_backward": report["K1_backward"],
                      "K4_backward": report["K4_backward"]}))
    print(json.dumps({"K2_times": {key: report["K2"][key] for key in (
                          "ms_by_k", "fp32_fma_bound_ms", "q256", "topn_250k")},
                      "K2_search": report["serve"]["search"]}))
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
