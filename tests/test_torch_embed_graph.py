"""The extractor's CUDA graph of the int8 embed (``evaluation/inference.py::
EmbedGraph``) against the eager embed, and the paths that stay eager.

On a card (skipped without one; the module imports no JAX, so it runs on
the card's machine too):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_embed_graph.py

the graph path gives the eager ``QuantizedEmbedder.embed``'s descriptors bit
for bit at 1, 4, 16 and 17 rows, over successive calls with other images
(a stale staging buffer would show), with and without ``packed_stem``, and
``/search``'s answers through ``DescriptorService``; each replay counts the
captured launches on the kernel wrappers and one ``embed.graph_replays``.
On the CPU: the float path, a mesh and CPU tensors stay eager, count no
replay and give the eager embed's output."""

import threading

import numpy as np
import pytest
import torch

from soft_contrastive_learning_torch import serving
from soft_contrastive_learning_torch.core.config import ModelConfig
from soft_contrastive_learning_torch.data.pipeline import pad_to_multiple
from soft_contrastive_learning_torch.evaluation.inference import DescriptorExtractor
from soft_contrastive_learning_torch.models.model import EmbeddingNet, init_params
from soft_contrastive_learning_torch.models.quant import QuantizedEmbedder, calibrate_scales
from soft_contrastive_learning_torch.models.weights import load_trained_params
from soft_contrastive_learning_torch.ops.kernels import _build
from soft_contrastive_learning_torch.ops.kernels.int8_conv import int8_conv, int8_pool, int8_stem
from soft_contrastive_learning_torch.ops.kernels.netvlad import netvlad_aggregate_cuda
from soft_contrastive_learning_torch.parallel.mesh import make_mesh
from soft_contrastive_learning_torch.train.step import build_embed_step

BATCH = 16


def _images(seed, n, h, w):
    return list(np.random.default_rng(seed).integers(0, 256, (n, h, w, 3), dtype=np.uint8))


def _eager(embed, images, batch, device="cpu"):
    """The eager path's rows: the images padded to the batch by repeats of
    the first, embedded a batch at a time on ``device``; the raw descriptor."""
    arr = pad_to_multiple(np.stack(images), batch)
    out = [embed(torch.from_numpy(arr[s : s + batch]).to(device))[1].cpu().numpy()
           for s in range(0, len(arr), batch)]
    return np.concatenate(out)[: len(images)]


# ---------------------------------------------------------------- CPU


@pytest.mark.parametrize("path", ["float", "int8_mesh", "int8_cpu"])
def test_eager_paths_count_no_replay(path):
    """Without a card, with a mesh or on the float path the extractor keeps
    no graph, counts 0 replays a batch and no capture, and returns the eager
    embed's rows."""
    torch.set_num_threads(1)
    cfg = ModelConfig(vlad_cores=4, image_height=32, image_width=40, compute_dtype="float32")
    params = init_params(cfg, seed=0)
    images = _images(1, 5, 32, 40)
    scales = None if path == "float" else calibrate_scales(params, np.stack(images[:4]), "cpu")
    mesh = make_mesh(devices=["cpu"]) if path == "int8_mesh" else None
    ex = DescriptorExtractor(cfg, params, batch_size=4, device="cpu", quant_scales=scales,
                             mesh=mesh)
    assert ex._graphs is None
    got = ex.extract_images(images)
    if scales is None:
        model = EmbeddingNet(cfg)
        model.load_state_dict(params)
        want = _eager(build_embed_step(model), images, 4)
    else:
        want = _eager(QuantizedEmbedder(cfg, params, scales=scales, device="cpu").embed,
                      images, 4)
    np.testing.assert_array_equal(got, want)
    counts = ex.timer.counts()
    assert counts["embed.graph_replays"] == 0 and "embed.graph_captures" not in counts
    assert (counts["embed.images"], counts["embed.padded"]) == (5, 3)
    ex.close()


def test_recorded_launches_take_the_launch_off_the_wrapper():
    """Inside ``recorded_launches`` this thread's launches go to the dict;
    another thread's still count on the wrapper; a replay adds the dict's."""

    def wrapper():
        pass

    wrapper.launches = 0
    with _build.recorded_launches() as rec:
        for _ in range(3):
            _build.count_launch(wrapper)
        other = threading.Thread(target=_build.count_launch, args=(wrapper,))
        other.start()
        other.join(timeout=30)
        assert not other.is_alive()
    assert rec == {wrapper: 3} and wrapper.launches == 1
    _build.count_launch(wrapper, rec[wrapper])
    assert wrapper.launches == 4


# ---------------------------------------------------------------- card


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.fixture(scope="module", params=[False, True], ids=["direct_stem", "packed_stem"])
def flagship(card, request):
    """The trained flagship's extractor, int8 at 180x240, batch 16."""
    cfg = ModelConfig(packed_stem=request.param)
    params = load_trained_params(cfg=cfg)
    scales = calibrate_scales(params, np.stack(_images(0, 8, 180, 240)), card)
    ex = DescriptorExtractor(cfg, params, batch_size=BATCH, device=card, quant_scales=scales)
    yield ex
    ex.close()


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 4, 16, 17])
def test_graph_equals_eager(flagship, n):
    ex = flagship
    (graph,) = ex._graphs.values()  # captured when the extractor was built
    if not ex.cfg.packed_stem:
        assert graph.launches == {int8_stem: 1, int8_conv: 12, int8_pool: 4,
                                  netvlad_aggregate_cuda: 1}
    wrappers = (int8_stem, int8_conv, int8_pool, netvlad_aggregate_cuda)
    batches = -(-n // BATCH)
    for seed in (n, n + 100):  # a second call with other images: no stale rows
        images = _images(seed, n, 180, 240)
        before = [w.launches for w in wrappers]
        replays = ex.timer.counts().get("embed.graph_replays", 0)
        got = ex.extract_images(images)
        assert [w.launches - b for w, b in zip(wrappers, before)] == \
            [graph.launches.get(w, 0) * batches for w in wrappers]
        assert ex.timer.counts()["embed.graph_replays"] == replays + batches
        want = _eager(ex._embed, images, BATCH, ex.device)
        assert got.shape == (n, ex.cfg.descriptor_dim) and got.dtype == np.float32
        assert np.array_equal(got, want)
    assert ex.timer.counts()["embed.graph_captures"] == 1


@pytest.mark.cuda
def test_search_answers_equal_eager(card):
    """``DescriptorService.search`` on the graph path answers as the eager
    embed's descriptors searched the same way."""
    cfg = ModelConfig()
    params = load_trained_params(cfg=cfg)
    images = _images(7, 6, 180, 240)
    scales = calibrate_scales(params, np.stack(images), card)
    gen = torch.Generator(device=card).manual_seed(7)
    index = torch.randn((4096, cfg.descriptor_dim), generator=gen, device=card)
    index = index / index.norm(dim=1, keepdim=True)
    service = serving.DescriptorService(cfg, params, batch_size=BATCH, index=index,
                                        device=card, quant_scales=scales)
    service.index[:6] = torch.from_numpy(service.embed(images)).to(card)
    d, i = service.search(images[:4], k=5)
    q = torch.from_numpy(_eager(service.extractor._embed, images[:4], BATCH, card)).to(card)
    want_d, want_i = serving.topk_l2(q, service.index, 5)
    assert np.array_equal(i, want_i.cpu().numpy()) and np.array_equal(d, want_d.cpu().numpy())
    assert i[:, 0].tolist() == [0, 1, 2, 3]
    assert service.extractor.timer.counts()["embed.graph_replays"] == 2
    service.extractor.close()
