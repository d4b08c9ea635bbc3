"""The port's probe kernels' plain versions against the JAX probes' own
Pallas kernels, on the CPU.

The scripts under ``perf/`` are loaded by path, untouched; their
``pallas_call`` runs in interpret mode for the test's duration, and where a
script makes its own operands and only prints a rate, the patched
``pallas_call`` hands the operands and the result to the test, so that both
sides see the same bits. Tolerances: exact for int8 and for operands that are
multiples of 1/8 (every product and partial sum is exact in fp32, whatever
the order); fp32 results on normals within 1e-5 of the largest entry (two
summation orders); bf16 results within one bf16 step.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from soft_contrastive_learning_torch.ops import winograd
from soft_contrastive_learning_torch.ops.kernels import winograd as k4
from soft_contrastive_learning_torch.ops.kernels.probe_gemm import (
    CONFIGS,
    ROUTES,
    choose_config,
    plan_launch,
    probe_gemm,
    probe_gemm_plain,
)
from soft_contrastive_learning_torch.ops.kernels.winograd import winograd_stage
from soft_contrastive_learning_torch.perf import (
    common,
    matmul_probe,
    mxu_probe,
    mxu_probe2,
    mxu_probe4,
    winograd_ablate,
)

torch.set_num_threads(1)  # tier-1 runs several workers on one host

ROOT = Path(__file__).resolve().parents[1]
M, K, N = 256, 256, 128


def _load(name):
    spec = importlib.util.spec_from_file_location(f"jax_probe_{name}", ROOT / "perf" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture
def interpreted(monkeypatch):
    """``pallas_call`` in interpret mode; returns the list that collects
    (operands, result) of every call made through it."""
    calls = []
    real = pl.pallas_call

    def patched(kernel, *args, **kwargs):
        fn = real(kernel, *args, interpret=True, **kwargs)

        def run(*operands):
            out = fn(*operands)
            calls.append((operands, out))
            return out

        return run

    monkeypatch.setattr(pl, "pallas_call", patched)
    return calls


def _torch(x, dtype=None):
    """A JAX or numpy array as a torch tensor with the same values (bf16
    goes through fp32, which holds it exactly)."""
    x = np.asarray(jnp.asarray(x).astype(jnp.float32) if x.dtype == jnp.bfloat16 else x)
    t = torch.from_numpy(np.array(x))
    return t.to(dtype) if dtype is not None else t


def _operands(kind, shape_a, shape_b, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "int8":
        return tuple(rng.integers(-127, 127, s).astype(np.int8) for s in (shape_a, shape_b))
    if kind == "eighths":
        return tuple((rng.integers(-8, 9, s) / 8).astype(np.float32) for s in (shape_a, shape_b))
    return tuple(rng.standard_normal(s).astype(np.float32) for s in (shape_a, shape_b))


def _hold(got, want, kind):
    """``got`` (JAX) against ``want`` (the plain version), by the module's
    tolerances."""
    got = _torch(got).float() if want.dtype != torch.int32 else _torch(got)
    assert got.shape == want.shape
    if kind in ("int8", "eighths"):
        assert torch.equal(got, want.float() if want.dtype != torch.int32 else want)
    elif want.dtype == torch.bfloat16:
        w = want.float()
        step = torch.ldexp(torch.ones_like(w), torch.frexp(w.abs().clamp_min(1e-30))[1] - 8)
        assert ((got - w).abs() <= step).all()
    else:
        assert (got - want).abs().max() <= 1e-5 * want.abs().max()


@pytest.mark.parametrize("kind", ["normals", "eighths"])
@pytest.mark.parametrize("name,blocks", [("mxu_probe2", (128, 128, 128)),
                                         ("mxu_probe3", (128, 64, 256))])
def test_blocked_matmul_probes_match_the_plain_version(monkeypatch, interpreted, name, blocks,
                                                       kind):
    """P2 and P3: the K-innermost blocked product, bf16 in and out."""
    module = _load(name)
    for key, value in zip("MKN", (M, K, N)):
        monkeypatch.setattr(module, key, value)
    a, b = _operands(kind, (M, K), (K, N))
    got = module.pallas_matmul(*blocks)(jnp.asarray(a, jnp.bfloat16), jnp.asarray(b, jnp.bfloat16))
    want = probe_gemm_plain(torch.from_numpy(a).bfloat16(), torch.from_numpy(b).bfloat16(),
                            torch.bfloat16)
    assert got.dtype == jnp.bfloat16
    _hold(got, want, kind)


def test_int8_probe_matches_the_plain_version_exactly(monkeypatch, interpreted):
    """P4: int8 operands, int32 sums."""
    module = _load("mxu_probe4")
    for key, value in zip("MKN", (M, K, N)):
        monkeypatch.setattr(module, key, value)
    a, b = _operands("int8", (M, K), (K, N))
    got = module.pallas_matmul(128, 128, 128, jnp.int8, jnp.int32, jnp.int32)(
        jnp.asarray(a), jnp.asarray(b))
    want = probe_gemm_plain(torch.from_numpy(a), torch.from_numpy(b))
    assert want.dtype == torch.int32 and got.dtype == jnp.int32
    _hold(got, want, "int8")


@pytest.mark.parametrize("out_bf16", [False, True])
def test_resident_dot_matches_the_plain_version(monkeypatch, interpreted, out_bf16):
    """P1a: the script makes its operands (normals) and prints a rate; the
    kernel's operands and result come from the patched ``pallas_call``."""
    module = _load("mxu_probe")
    monkeypatch.setattr(module, "timeit", lambda fn, args, reps=3: (fn(*args), 1.0)[1])
    with jax.disable_jit():
        module.resident_dot(128, 256, 128, iters=2, out_bf16=out_bf16)
    (a, b), got = interpreted[-1]
    out_dtype = torch.bfloat16 if out_bf16 else torch.float32
    want = probe_gemm_plain(_torch(a, torch.bfloat16), _torch(b, torch.bfloat16), out_dtype)
    _hold(got, want, "normals")


def test_blocked_grid_matches_the_plain_version(monkeypatch, interpreted):
    """P1b: a grid of output tiles with the whole K per tile, fp32 out."""
    module = _load("mxu_probe")
    monkeypatch.setattr(module, "timeit", lambda fn, args, reps=3: (fn(*args), 1.0)[1])
    with jax.disable_jit():
        module.blocked_grid(256, 128, 256, 128, 128, (pltpu.PARALLEL, pltpu.PARALLEL),
                            "parallel,parallel", inner_iters=1)
    (a, b), got = interpreted[-1]
    want = probe_gemm_plain(_torch(a, torch.bfloat16), _torch(b, torch.bfloat16), torch.float32)
    _hold(got, want, "normals")


@pytest.mark.parametrize("mode,z,m", [("batched", 4, 40), ("unrolled", 4, 48), ("single", 1, 72)])
def test_winograd_product_probe_matches_the_plain_version(monkeypatch, interpreted, mode, z, m):
    """P5: the independent (P, C) @ (C, F) products, fp32 out; P ragged
    against every tile shape of the port."""

    def once(name, make_fn, flops, iters=30):
        make_fn()(*module.make_args[name](), jnp.float32(0.0))

    module = _load("matmul_probe")
    monkeypatch.setattr(module, "bench_kernel", once)
    module.probe("case", z, m, 64, 128, mode)
    (a, b), got = interpreted[-1]
    a, b = _torch(a, torch.bfloat16), _torch(b, torch.bfloat16)
    if mode == "single":
        a, b = a[:1], b[:1]
    _hold(got, probe_gemm_plain(a, b, torch.float32), "normals")
    # the port's wrapper takes the plain version on the CPU, launch count untouched
    before = probe_gemm.launches
    assert torch.equal(probe_gemm(a, b, torch.float32), probe_gemm_plain(a, b, torch.float32))
    assert probe_gemm.launches == before


def test_probe_gemm_refuses_what_it_does_not_take():
    a = torch.zeros((8, 64), dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="dtypes differ"):
        probe_gemm(a, torch.zeros((64, 64), dtype=torch.int8))
    with pytest.raises(TypeError, match="int8 -> int32"):
        probe_gemm(a.to(torch.int8), torch.zeros((64, 64), dtype=torch.int8), torch.float32)
    with pytest.raises(ValueError, match="expected a"):
        probe_gemm(a, torch.zeros((32, 64), dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="no tile shape"):
        choose_config(128, 96, 64)
    # the largest tile that still fills the card; else the most blocks
    assert CONFIGS[torch.bfloat16][choose_config(8192, 8192, 4096)] == (128, 256, 64)
    assert CONFIGS[torch.bfloat16][choose_config(240, 128, 128, z=16)] == (128, 64, 64)


def test_choose_config_takes_wgmma_tiles_for_bf16_and_mma_sync_tiles_for_int8():
    """bf16 chooses among the bf16 wgmma tiles (128 rows, K steps of 64 bf16
    = one 128-byte swizzle row), int8 among the int8 wgmma tiles (K steps of
    128 int8 = one 128-byte swizzle row, or 64 with the 64-byte swizzle);
    both lists are what the library is checked against when it loads. (The
    name predates int8 on wgmma: int8 took mma.sync.)"""
    assert ROUTES == {torch.bfloat16: "wgmma", torch.int8: "wgmma"}
    assert CONFIGS[torch.bfloat16] == ((128, 256, 64), (128, 128, 64), (128, 64, 64))
    assert CONFIGS[torch.int8] == ((128, 256, 128), (128, 256, 64), (128, 128, 128), (128, 64, 64))
    for m, n, k, z in ((8192, 8192, 4096, 1), (4096, 4096, 2048, 1), (512, 512, 512, 1),
                       (1024, 128, 128, 16), (360, 256, 256, 16), (16384, 128, 128, 1)):
        assert CONFIGS[torch.bfloat16][choose_config(m, n, k, z)][2] == 64
        assert choose_config(m, n, k, z, torch.int8) in range(len(CONFIGS[torch.int8]))
    assert CONFIGS[torch.int8][choose_config(8192, 8192, 4096, dtype=torch.int8)] == \
        (128, 256, 128)
    # K = 192: only the BK 64 int8 tiles divide it; N = 320 only the narrowest
    assert CONFIGS[torch.int8][choose_config(1000, 320, 192, 3, torch.int8)] == (128, 64, 64)
    assert CONFIGS[torch.int8][choose_config(8192, 8192, 192, dtype=torch.int8)] == (128, 256, 64)
    # K = 96: no tile of either type divides it
    for dtype in (torch.bfloat16, torch.int8):
        with pytest.raises(ValueError, match="no tile shape"):
            choose_config(512, 256, 96, dtype=dtype)


@pytest.mark.parametrize("shape_a,shape_b,dtype,config,ptrs,match", [
    ((512, 256), (256, 256), torch.bfloat16, None, (8, 0), "16-byte-aligned"),
    ((512, 256), (256, 256), torch.bfloat16, None, (0, 2), "16-byte-aligned"),
    ((512, 96), (96, 256), torch.bfloat16, 1, (0, 0), "K % 64"),
    ((512, 256), (256, 320), torch.bfloat16, 1, (0, 0), "N % 128"),
    ((512, 256), (256, 256), torch.bfloat16, 3, (0, 0), "outside 0..2"),
    ((0, 256), (256, 256), torch.bfloat16, None, (0, 0), "non-empty"),
    ((70000, 64, 64), (70000, 64, 64), torch.bfloat16, None, (0, 0), "grid out of range"),
    ((512, 48), (48, 64), torch.int8, None, (0, 0), "no tile shape"),
    ((512, 256), (256, 256), torch.int8, None, (8, 0), "16-byte-aligned"),
    ((512, 256), (256, 256), torch.int8, None, (0, 4), "16-byte-aligned"),
])
def test_probe_gemm_refuses_before_any_build(shape_a, shape_b, dtype, config, ptrs, match):
    """What TMA and the tiles cannot take is refused from shapes and
    addresses alone, before a library is built or a tensor is on a card."""
    with pytest.raises(ValueError, match=match):
        plan_launch(shape_a, shape_b, dtype, config, *ptrs)


def test_probe_gemm_plans_what_it_takes():
    # both types load by TMA: 16-byte-aligned operands (misaligned ones are
    # refused above)
    assert plan_launch((16, 240, 128), (16, 128, 128), torch.bfloat16) == 2
    assert plan_launch((512, 256), (256, 256), torch.int8, None, 16, 0) in range(4)


# ---------------------------------------------------------------- P6

def _ablate_full(module, xp, u, b, h, w, c, f, trows, ipc):
    """The ``full`` stage of ``perf/winograd_ablate.py::make_kernel`` as its
    ``run`` builds it, on the given padded input."""
    th, tw = -(-h // 2), -(-w // 2)
    th_p = -(-th // trows) * trows
    rgroups = th_p // trows
    tile_c = 128 if c % 128 == 0 else c
    p = ipc * trows * tw
    wp8 = xp.shape[2]
    fn = pl.pallas_call(
        module.make_kernel("full", ipc, trows, tw, rgroups, tile_c),
        grid=((b // ipc) * rgroups, c // tile_c),
        in_specs=[
            pl.BlockSpec((16, tile_c, f), lambda i, j: (0, j, 0), memory_space=pltpu.VMEM),
            pl.BlockSpec(memory_space=pl.ANY),
        ],
        out_specs=pl.BlockSpec((ipc, 2 * trows, 2 * tw, f),
                               lambda i, j: (i // rgroups, i % rgroups, 0, 0),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((b, 2 * th_p, 2 * tw, f), jnp.bfloat16),
        scratch_shapes=[
            pltpu.VMEM((ipc, 2 * trows + 2, wp8, tile_c), jnp.bfloat16),
            pltpu.VMEM((16, p, f), jnp.float32),
            pltpu.SemaphoreType.DMA(()),
        ],
        interpret=True,
    )
    return fn(u, xp)


def test_ablation_full_stage_matches_the_plain_full_stage():
    """P6 ``full``: the ablation kernel on a zero-padded input against
    ``winograd_stage_plain(3, ...)`` at B=2, 8x8, 128 -> 128, within 1e-4 of
    the largest output (the gate K4 is held to). The ablation kernel
    transforms its input in fp32 and rounds V once where K4 rounds at every
    add, so the operands are multiples of 1/8 and 1/2, on which both are
    exact (and the two bf16 results then equal)."""
    module = _load("winograd_ablate")
    b, h, w, c, f, trows, ipc = 2, 8, 8, 128, 128, 2, 1
    rng = np.random.default_rng(0)
    x = (rng.integers(-8, 9, (b, h, w, c)) / 8).astype(np.float32)
    weight = (rng.integers(-2, 3, (f, c, 3, 3)) / 2).astype(np.float32)
    xt, wt = torch.from_numpy(x).bfloat16(), torch.from_numpy(weight)
    u = winograd.weight_transform(wt)
    assert torch.equal(u, u.bfloat16().float())  # U is exact in bf16
    th, tw = h // 2, w // 2
    xp = np.zeros((b, 2 * th + 2, -(-(2 * tw + 2) // 8) * 8, c), np.float32)
    xp[:, 1 : h + 1, 1 : w + 1] = x
    got = _ablate_full(module, jnp.asarray(xp, jnp.bfloat16), jnp.asarray(u.numpy(), jnp.bfloat16),
                       b, h, w, c, f, trows, ipc)
    want = winograd.winograd_stage_plain(3, xt, wt, torch.zeros(f), out_dtype=torch.bfloat16)
    got = _torch(got).float()
    assert got.shape == want.shape
    assert (got - want.float()).abs().max() <= 1e-4 * want.float().abs().max()
    assert torch.equal(got, want.float())


def _tiny():
    """One 2x2 image of ones over 32 channels (a single tile) and 64 filters
    whose only tap is k[0][0] = (f % 4) / 2, in channels 0 and 1."""
    x = torch.ones((1, 2, 2, 32), dtype=torch.bfloat16)
    weight = torch.zeros((64, 32, 3, 3))
    weight[:, :2, 0, 0] = (torch.arange(64) % 4)[:, None] / 2
    return x, weight


# one 1.0 (0x3F80), four 0.5 (0x3F00), four 0.25 (0x3E80): U[p] over the 16
# positions when k[0][0] = 1 alone, U[4a + b] = g[a] g[b], g = (1, .5, .5, 0)
U_BITS = 0x3F80 + 4 * 0x3F00 + 4 * 0x3E80


def test_stage_dma_by_hand():
    """The checksum counts a fixed sample of what TMA brings in. Of the
    input box of a block (4 x 8 tiles here: 10 x 18 pixels from (-1, -1) of
    the block's first tile), the pixels (k 180) // 32, k = 0..31, over every
    channel; of U, per chunk of 32 channels, the words of 512 threads:
    position t % 16, channel t / 16, two features, i.e. 64 values of each
    position. A 15x16 image of ones (0x3F80) is two blocks, tile rows 0-3
    and 4-7: one cluster of 2."""
    x = torch.ones((1, 15, 16, 32), dtype=torch.bfloat16)
    inside = []
    for row0 in (-1, 7):  # the boxes' first pixel rows
        count = 0
        for k in range(32):
            q = k * 180 // 32
            r, c = row0 + q // 18, -1 + q % 18
            count += 0 <= r < 15 and 0 <= c < 16
        inside.append(count)
    assert 0 < inside[1] < inside[0]  # the second box runs past the image's last row
    zero_w = torch.zeros((64, 32, 3, 3))
    got = winograd.winograd_stage_plain("dma", x, zero_w)
    assert got.tolist() == [[inside[0] * 32 * 0x3F80], [inside[1] * 32 * 0x3F80]]
    ones = torch.zeros((64, 32, 3, 3))
    ones[:, :, 0, 0] = 1.0
    got = winograd.winograd_stage_plain(0, torch.zeros_like(x), ones)
    assert got.tolist() == [[64 * U_BITS]] * 2
    x, weight = _tiny()
    assert torch.equal(winograd_stage("dma", x, weight), winograd.winograd_stage_plain(0, x, weight))


def test_stage_transform_by_hand():
    """B^T d B of the patch [[0,0,0,0],[0,1,1,0],[0,1,1,0],[0,0,0,0]] is
    [[1,-2,0,-1],[-2,4,0,2],[0,0,0,0],[-1,2,0,1]] per channel. The block's
    4 x 8 rectangle also transforms tiles past the 1 x 1 tile grid, and
    three of them reach the image: tile (0, 1) sees column 1 as its first
    column ([-1, 2, 0, 1] down column 0 of V), tile (1, 0) row 1 (the same
    along row 0), tile (1, 1) pixel (1, 1) (a single 1). A second, all-zero
    block rounds the grid up to a cluster of 2."""
    x, weight = _tiny()
    bits = {1: 0x3F80, -1: 0xBF80, 2: 0x4000, -2: 0xC000, 4: 0x4080, 0: 0}
    tiles = ([1, -2, 0, -1, -2, 4, 0, 2, 0, 0, 0, 0, -1, 2, 0, 1], [-1, 2, 0, 1], [-1, 2, 0, 1],
             [1])
    got = winograd.winograd_stage_plain("transform", x, torch.zeros_like(weight))
    assert got.tolist() == [[32 * sum(bits[e] for v in tiles for e in v)], [0]]


def test_stage_matmul_by_hand():
    """M[0] = V[0] . U[0]: V[0] = 1 in every channel and U[0][c][f] =
    k[0][0] = (f % 4) / 2 in channels 0 and 1, so M[0][f] = f % 4."""
    x, weight = _tiny()
    got = winograd.winograd_stage_plain("matmul", x, weight)
    assert got.shape == (1, 64) and got.dtype == torch.float32
    assert got[0].tolist() == [float(f % 4) for f in range(64)]


def test_stages_block_layout_and_full_stage():
    """Ragged tiles and two feature blocks: 3 images of 5 x 5 tiles make two
    4 x 8 rectangles each, 6 blocks (3 clusters of 2); the boxes are the
    input with its zero halo; M[0] is (tiles, F), and ``full`` is the plain
    conv. 3 images of 3 x 4 tiles are 3 blocks, rounded up to 4: the last
    is all zero and counts U's sample alone."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((3, 9, 10, 32)).astype(np.float32)).bfloat16()
    weight = torch.from_numpy(rng.standard_normal((128, 32, 3, 3)).astype(np.float32))
    bias = torch.from_numpy(rng.standard_normal(128).astype(np.float32))
    tiles = 3 * 5 * 5
    assert winograd.block_rows(9, 10) == 4 and winograd.block_grid(3, 9, 10, 4) == (2, 1, 6)
    boxes = winograd.block_boxes(x, 4)
    assert boxes.shape == (6, 10, 18, 32) and boxes.dtype == torch.bfloat16
    for n in range(3):
        assert torch.equal(boxes[2 * n, 1:10, 1:11], x[n])  # rows -1..8, cols -1..16
        assert torch.equal(boxes[2 * n + 1, 0:2, 1:11], x[n, 7:9])  # rows 7..16
        assert boxes[2 * n, 0].abs().sum() == 0  # the halo above the image's first row
        assert boxes[2 * n + 1, 2:].abs().sum() == 0 and boxes[2 * n, :, 11:].abs().sum() == 0
    for stage in (0, 1):
        got = winograd_stage(stage, x, weight)
        assert got.shape == (6, 2) and got.dtype == torch.int64
        assert (got >= 0).all() and (got < 2 ** 32).all()
    small = x[:, :5, :7].contiguous()
    assert winograd.block_grid(3, 5, 7, 4) == (1, 1, 4)
    assert winograd.block_boxes(small, 4)[3].abs().sum() == 0
    for stage in (0, 1):
        got = winograd_stage(stage, small, weight)
        u_alone = winograd_stage(stage, torch.zeros_like(small), weight)
        assert got.shape == (4, 2) and torch.equal(got[3], u_alone[0])
        assert not torch.equal(got[0], got[3])
    assert winograd_stage(2, x, weight).shape == (tiles, 128)
    full = winograd_stage("full", x, weight, bias, relu=True)
    assert torch.equal(full, winograd.winograd_conv_plain(x, weight, bias, relu=True))
    with pytest.raises(ValueError, match="unknown stage"):
        winograd_stage("output", x, weight)
    with pytest.raises(ValueError, match="needs a bias"):
        winograd_stage(3, x, weight)
    with pytest.raises(ValueError, match="C % 32"):
        winograd.winograd_stage_plain(0, x[..., :8], weight[:, :8])


def test_block_rectangles_of_the_flagship_layers():
    """2 x 16 tiles where the tile grid is 60 wide (conv2), 4 x 8 at 30, 15
    and 8 (conv3-5): the fewest padded tiles, then the smaller box."""
    assert [winograd.block_rows(h, w) for h, w in ((90, 120), (45, 60), (22, 30), (11, 15))] == \
        [2, 4, 4, 4]
    # (tile blocks per column, per row, all rounded to clusters of 2) at B = 64
    assert winograd.block_grid(64, 90, 120, 2) == (23, 4, 5888)
    assert winograd.block_grid(64, 11, 15, 4) == (2, 1, 128)


@pytest.mark.parametrize("x_shape,w_shape,ptr,match", [
    ((2, 8, 8, 24), (64, 24, 3, 3), 0, "C % 32"),
    ((2, 8, 8, 128), (48, 128, 3, 3), 0, "F % 64"),
    ((2, 8, 8, 128), (64, 128, 3, 3), 8, "16-byte-aligned"),
    ((2, 8, 8, 128), (64, 64, 3, 3), 0, "shape mismatch"),
    ((70000, 45, 60, 128), (64, 128, 3, 3), 0, "65,535 clusters"),
])
def test_k4_refuses_before_any_build(x_shape, w_shape, ptr, match):
    with pytest.raises(ValueError, match=match):
        k4.check_launch("K4", x_shape, w_shape, ptr)


# ---------------------------------------------------------------- scripts

@pytest.mark.parametrize("probe", [mxu_probe, mxu_probe2, mxu_probe4, matmul_probe,
                                    winograd_ablate], ids=lambda m: m.__name__.rsplit(".", 1)[1])
def test_probe_script_runs_on_the_cpu_and_prints_no_rate(probe, capsys):
    assert probe.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "no time or rate is printed" in out and "ok, (" in out
    assert "TFLOP/s" not in out and "TOP/s" not in out and " ms" not in out


def test_probe_script_defaults_to_the_card_and_raises_without_one():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        mxu_probe2.main([])


def test_bounds_of_the_probes_own_problems():
    """2 M K N over the tensor-core rate against the operands read once and
    the result written once: 0.556 ms (bf16) and 0.278 ms (int8) for the
    large problem, operation-bound; the C = 128 Winograd products are
    byte-bound."""
    ms, by = common.gemm_bound_ms(1, 8192, 4096, 8192, torch.bfloat16, torch.bfloat16)
    assert by == "operations" and ms == pytest.approx(0.5559, abs=1e-4)
    ms, by = common.gemm_bound_ms(1, 8192, 4096, 8192, torch.int8, torch.int32)
    assert by == "operations" and ms == pytest.approx(0.2778, abs=1e-4)
    assert common.gemm_bound_ms(16, 1024, 128, 128, torch.bfloat16, torch.float32)[1] == "bytes"
