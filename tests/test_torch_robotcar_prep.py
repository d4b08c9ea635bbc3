"""The port's RobotCar prep pipeline (``data/robotcar/``, ``cli prep``)
against the JAX package's and OpenCV's.

The raw tree is the JAX test's geometry (``tests/test_robotcar_prep.py``:
two dates driving 360 m along a line, INS at 3x the frame rate, four fold
masks) at 64x96 Bayer frames, plus an undistortion LUT whose sources
leave the frame and an undecodable frame, run through both packages'
stages; every CSV must be equal as text, every PNG pixel for pixel, every
pickle value for value.

The fixture's query date sits 0.3 m beside the reference on integer
metres, so a query point lies exactly as far from the reference points
before and after it: sklearn orders such ties by its tree's layout, the
port by index (``prep.py``'s docstring), and stage 014 draws an anchor from
a radius query's unsorted list, which sklearn returns in tree order and the
port by index. JAX's stages run here with ``_OrderedKDTree``, sklearn's tree
with the port's order. A second tree, whose query date is offset by 0.37
m (no ties), runs JAX's stages with sklearn's own tree; 014 is left out
there.
"""

import math
import os
import pickle
import tarfile

import cv2
import numpy as np
import pytest
import torch
from sklearn.cluster import KMeans
from sklearn.neighbors import KDTree

import soft_contrastive_learning_tpu.data.robotcar.prep as jax_prep
from soft_contrastive_learning_torch.cli import main as cli_main
from soft_contrastive_learning_torch.data.robotcar import prep
from soft_contrastive_learning_torch.data.robotcar.analysis import plot_statistics, scale_factor
from soft_contrastive_learning_torch.data.robotcar.downsize import (
    LUT_NAME,
    UndistortLUT,
    decode_raw_image,
    demosaic_gbrg,
    downsize_images,
)
from soft_contrastive_learning_torch.data.robotcar.stages import PrepContext, run_all
from soft_contrastive_learning_torch.utils.io import load_img
from soft_contrastive_learning_torch.utils.sampling import greedy
from soft_contrastive_learning_tpu.data.robotcar import analysis as jax_analysis
from soft_contrastive_learning_tpu.data.robotcar import downsize as jax_downsize
from soft_contrastive_learning_tpu.data.robotcar.stages import PrepContext as JaxPrepContext
from soft_contrastive_learning_tpu.data.robotcar.stages import run_all as jax_run_all
from soft_contrastive_learning_tpu.utils.sampling import greedy as jax_greedy

# CLI prep's PrepContext keeps JAX's RobotCar dates: the tree uses them
DATE_REF = "2014-12-02-15-30-08"  # the train and test folds' reference date
DATE_VAL = "2014-05-14-13-50-20"  # the val fold's
DATE_QUERY = "2015-08-14-14-54-57"  # a held-out query date
FRAME_H, FRAME_W = 64, 96
GRID_E, GRID_N = prep.GRID_ORIGIN_E, prep.GRID_ORIGIN_N


def _write_raw_date(root, date, xs, y, t0, seed, bad_frame=None):
    """INS csv + stereo.timestamps + one tar of gray Bayer PNG frames, as
    the JAX test writes them (cv2.imwrite); ``bad_frame``: that frame's
    bytes are not a PNG."""
    n = len(xs)
    ts = [t0 + 100000 * i for i in range(n)]
    os.makedirs(os.path.join(root, "raw", date, "gps"), exist_ok=True)
    with open(os.path.join(root, "raw", date, "stereo.timestamps"), "w") as f:
        f.write("\n".join(f"{t} 1" for t in ts))
    rows = ["timestamp,northing,easting,yaw,ins_status"]
    for i in range(n * 3):
        frac = i / 3.0
        x = np.interp(frac, np.arange(n), xs)
        rows.append(f"{t0 + int(100000 * frac)},{GRID_N - y},{GRID_E + x},{math.pi / 2},"
                    "INS_SOLUTION_GOOD")
    with open(os.path.join(root, "raw", date, "gps", "ins.csv"), "w") as f:
        f.write("\n".join(rows))
    os.makedirs(os.path.join(root, "tars"), exist_ok=True)
    tmp = os.path.join(root, "tmp_frames")
    os.makedirs(tmp, exist_ok=True)
    rng = np.random.default_rng(seed)
    with tarfile.open(os.path.join(root, "tars", f"{date}_stereo_centre_01.tar"), "w") as tar:
        for i, t in enumerate(ts):
            p = os.path.join(tmp, f"{t}.png")
            if i == bad_frame:
                with open(p, "wb") as f:
                    f.write(b"not a png")
            else:
                # blocky content (exposures spread) with per-pixel noise
                base = rng.integers(40, 200, (FRAME_H // 8, FRAME_W // 8)).repeat(8, 0).repeat(8, 1)
                raw = np.clip(base + rng.integers(-20, 21, (FRAME_H, FRAME_W)), 0, 255)
                cv2.imwrite(p, raw.astype(np.uint8))
            tar.add(p, arcname=f"{date}/stereo/centre/{t}.png")


def _write_masks(root):
    """The folds' grid masks, painted in the BLUE channel (cv2's channel 0,
    the port codec's channel 2), with red painted where no fold is: a read
    of the wrong channel changes every split."""
    masks = {}
    for name, (x0, x1) in (("full", (0, 360)), ("train", (0, 150)), ("test", (160, 310)),
                           ("val", (320, 360))):
        grid = np.zeros((40, 380, 3), np.uint8)  # BGR
        grid[:, x0:x1, 0] = 255
        grid[:, :, 2] = np.where(grid[:, :, 0] > 0, 0, 255)
        masks[name] = os.path.join(root, "masks", f"{name}.png")
        os.makedirs(os.path.dirname(masks[name]), exist_ok=True)
        cv2.imwrite(masks[name], grid)
    return masks


def _write_lut(root, h, w):
    """A barrel-like undistortion LUT (u row, then v row, float64) whose
    corners map outside the frame."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    cx, cy = (w - 1) / 2, (h - 1) / 2
    r2 = ((xx - cx) ** 2 + (yy - cy) ** 2) / (cx**2 + cy**2)
    k = 1 + 0.12 * r2
    u, v = cx + (xx - cx) * k, cy + (yy - cy) * k
    d = os.path.join(root, "models")
    os.makedirs(d, exist_ok=True)
    np.stack([u.ravel(), v.ravel()]).tofile(os.path.join(d, LUT_NAME))
    return d


def _raw_tree(root, query_offset):
    _write_raw_date(root, DATE_REF, np.arange(360, dtype=float), 10.0, 10**15, seed=7,
                    bad_frame=17)
    _write_raw_date(root, DATE_QUERY, np.arange(5, 355, dtype=float) + query_offset, 10.3,
                    2 * 10**15, seed=8)
    return _write_masks(root), _write_lut(root, FRAME_H, FRAME_W)


def _ctx(cls, root, out, masks, models):
    return cls(
        root=os.path.join(out, "data"), raw_img_root=os.path.join(root, "raw"),
        ins_root=os.path.join(root, "raw"), tar_root=os.path.join(root, "tars"),
        img_root=os.path.join(out, "downsized"), camera_models=models, grid_masks=masks,
        max_epochs=2, ref_dates={"train": DATE_REF, "test": DATE_REF, "val": DATE_REF},
        query_dates=(DATE_QUERY,), bad_dates=(), cluster_r=5)


class _OrderedKDTree:
    """sklearn's KDTree with the port's order: nearest first and the lower
    index first among equal distances; an unsorted radius query in
    ascending index."""

    def __init__(self, data):
        self.tree = KDTree(data)

    def query(self, x, k=1, return_distance=True):
        d, i = self.tree.query(x, k)
        o = np.lexsort((i, d), axis=-1)
        d, i = np.take_along_axis(d, o, 1), np.take_along_axis(i, o, 1)
        return (d, i) if return_distance else i

    def query_radius(self, x, r, return_distance=False, sort_results=False):
        ind, dist = self.tree.query_radius(x, r, return_distance=True)
        orders = [np.lexsort((i, d)) if sort_results else np.argsort(i)
                  for i, d in zip(ind, dist)]
        ind = np.array([i[o] for i, o in zip(ind, orders)] + [None], dtype=object)[:-1]
        dist = np.array([d[o] for d, o in zip(dist, orders)] + [None], dtype=object)[:-1]
        return (ind, dist) if return_distance else ind


def _run_jax(ctx, ordered):
    with pytest.MonkeyPatch.context() as mp:
        if ordered:
            mp.setattr(jax_prep, "KDTree", _OrderedKDTree)
        for date in (DATE_REF, DATE_QUERY):
            jax_downsize.downsize_images(ctx, date)
            jax_prep.interpolate_image_xy(ctx, date)
            jax_prep.assign_splits(ctx, date)
        jax_run_all(jax_prep.metadata_stages(ctx), ctx, log=lambda s: None)


def _run_port(ctx):
    for date in (DATE_REF, DATE_QUERY):
        downsize_images(ctx, date, device="cpu")
        prep.interpolate_image_xy(ctx, date)
        prep.assign_splits(ctx, date)
    run_all(prep.metadata_stages(ctx), ctx, log=lambda s: None)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """{"ties": (jax_out, port_out), "no_ties": (...)}: the two packages'
    trees from one raw tree each."""
    out = {}
    for name, offset, ordered in (("ties", 0.0, True), ("no_ties", 0.37, False)):
        root = str(tmp_path_factory.mktemp(f"robotcar_{name}"))
        masks, models = _raw_tree(root, offset)
        jax_out, port_out = os.path.join(root, "jax"), os.path.join(root, "port")
        _run_jax(_ctx(JaxPrepContext, root, jax_out, masks, models), ordered)
        _run_port(_ctx(PrepContext, root, port_out, masks, models))
        out[name] = (root, jax_out, port_out)
    return out


def _files(top):
    return sorted(os.path.relpath(os.path.join(d, f), top)
                  for d, _, fs in os.walk(top) for f in fs)


def _assert_same_dir(a, b):
    files = _files(a)
    assert files and files == _files(b)
    for rel in files:
        pa, pb = os.path.join(a, rel), os.path.join(b, rel)
        if rel.endswith(".png"):
            np.testing.assert_array_equal(load_img(pb), cv2.imread(pa)[:, :, ::-1], err_msg=rel)
        elif rel.endswith(".pickle"):
            with open(pa, "rb") as fa, open(pb, "rb") as fb:
                xa, da, ka = pickle.load(fa)
                xb, db, kb = pickle.load(fb)
            np.testing.assert_array_equal(xa, xb)
            assert da == db and list(ka) == list(kb), rel
        else:
            with open(pa) as fa, open(pb) as fb:
                assert fa.read() == fb.read(), rel


STAGE_DIRS = ("img_info_240", "xy", "splits", "merged", "parametrized", "merged_parametrized",
              "clean_merged_parametrized", "localization_references", "shuffled", "clusters",
              "anchors")


@pytest.mark.parametrize("stage_dir", STAGE_DIRS)
def test_prep_stage_matches_jax(trees, stage_dir):
    """Each stage's output directory equals JAX's (its tree ordered as the
    port's, module docstring)."""
    _, jax_out, port_out = trees["ties"]
    _assert_same_dir(os.path.join(jax_out, "data", stage_dir),
                     os.path.join(port_out, "data", stage_dir))


@pytest.mark.parametrize("stage_dir", STAGE_DIRS[:-1])
def test_prep_stage_matches_jax_without_ties(trees, stage_dir):
    """Where no distances tie, JAX's stages with sklearn's own tree give
    the port's tree (014, which draws from tree order, left out)."""
    _, jax_out, port_out = trees["no_ties"]
    _assert_same_dir(os.path.join(jax_out, "data", stage_dir),
                     os.path.join(port_out, "data", stage_dir))


def test_downsized_images_match_jax(trees):
    """Stage 001's PNGs pixel for pixel, the undecodable frame dropped
    from the CSV and written by neither package."""
    _, jax_out, port_out = trees["ties"]
    _assert_same_dir(os.path.join(jax_out, "downsized"), os.path.join(port_out, "downsized"))
    info = os.path.join(port_out, "data", "img_info_240", f"{DATE_REF}.csv")
    with open(info) as f:
        assert len(f.read().splitlines()) == 1 + 360 - 1


@pytest.mark.parametrize("shape", [(3, 3), (16, 24), (15, 23), (10, 37), (64, 96), (960, 1280)])
def test_demosaic_matches_cv2(shape):
    rng = np.random.default_rng(sum(shape))
    raw = rng.integers(0, 256, shape, dtype=np.uint8)
    np.testing.assert_array_equal(demosaic_gbrg(torch.from_numpy(raw)).numpy(),
                                  cv2.cvtColor(raw, cv2.COLOR_BayerGR2RGB))
    batch = rng.integers(0, 256, (3,) + shape, dtype=np.uint8)
    got = demosaic_gbrg(torch.from_numpy(batch)).numpy()
    for i in range(3):
        np.testing.assert_array_equal(got[i], cv2.cvtColor(batch[i], cv2.COLOR_BayerGR2RGB))


def test_demosaic_refuses_small_frames():
    with pytest.raises(ValueError, match="3 rows"):
        demosaic_gbrg(torch.zeros((2, 8), dtype=torch.uint8))


@pytest.mark.parametrize("denominator", [2, 3, 10, 32, 64, 1024, 0])
def test_remap_matches_cv2(tmp_path, denominator):
    """Source coordinates on a grid of 1/denominator (0: random floats),
    from 3 pixels before the frame to 3 past it: ties of the float lerp,
    and neighbours outside the frame (OpenCV's zero border)."""
    rng = np.random.default_rng(denominator)
    h, w = 41, 57
    img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    if denominator:
        u = rng.integers(-3 * denominator, (w + 3) * denominator, (h, w)) / denominator
        v = rng.integers(-3 * denominator, (h + 3) * denominator, (h, w)) / denominator
    else:
        u, v = rng.random((h, w)) * (w + 6) - 3, rng.random((h, w)) * (h + 6) - 3
    path = str(tmp_path / "lut.bin")
    np.stack([u.ravel(), v.ravel()]).astype(np.float64).tofile(path)
    lut = UndistortLUT(path, (h, w), "cpu")
    want = cv2.remap(img, u.astype(np.float32), v.astype(np.float32), cv2.INTER_LINEAR)
    np.testing.assert_array_equal(lut(torch.from_numpy(img)).numpy(), want)
    np.testing.assert_array_equal(lut(torch.from_numpy(np.stack([img, img])))[1].numpy(), want)


def test_decode_raw_image_matches_jax():
    rng = np.random.default_rng(3)
    raw = rng.integers(0, 256, (16, 24), dtype=np.uint8)
    ok, buf = cv2.imencode(".png", raw)
    np.testing.assert_array_equal(decode_raw_image(buf.tobytes(), device="cpu"),
                                  jax_downsize.decode_raw_image(buf.tobytes()))
    with pytest.raises(ValueError):
        decode_raw_image(b"\x89PNG\r\n\x1a\n broken", device="cpu")


@pytest.mark.parametrize("seed", range(6))
def test_two_means_matches_sklearn(seed):
    """The exact 1-D 2-means gives sklearn's KMeans(2) partition (labels up
    to their order) and centres, on two clumps, on spread values and on
    values with repeats."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(5, 200))
    if seed % 3 == 0:
        x = np.concatenate([rng.normal(0, 3, n), rng.normal(80, 5, n // 2)])
    elif seed % 3 == 1:
        x = rng.random(n) * 100
    else:
        x = rng.integers(0, 7, n).astype(float) * 12.5
    km = KMeans(n_clusters=2, random_state=0, n_init=10).fit(x.reshape(-1, 1))
    labels, centres = prep._two_means_1d(x)
    same = np.array_equal(labels, km.labels_)
    assert same or np.array_equal(labels, 1 - km.labels_)
    np.testing.assert_allclose(np.sort(centres), np.sort(km.cluster_centers_[:, 0]), rtol=1e-12)


@pytest.mark.parametrize("k", [1, 2, 3])
def test_nearest_1d_matches_sklearn(k):
    rng = np.random.default_rng(k)
    data = rng.permutation(10**6)[:500].astype(float)  # distinct: no ties
    q = rng.random(300) * 1.1e6 - 5e4
    d, i = prep._nearest_1d(data, q, k)
    want_d, want_i = KDTree(data[:, None]).query(q[:, None], k)
    np.testing.assert_array_equal(i, want_i)
    np.testing.assert_array_equal(d, want_d)


def test_radius_neighbors_match_sklearn():
    rng = np.random.default_rng(5)
    data, q = rng.random((400, 2)) * 100, rng.random((50, 2)) * 100
    tree = KDTree(data)
    want_i, want_d = tree.query_radius(q, r=12.0, return_distance=True, sort_results=True)
    got_i, got_d = prep._radius_neighbors(data, q, 12.0, sort_results=True)
    for a, b, c, d in zip(got_i, want_i, got_d, want_d):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(c, d)
    for a, b in zip(prep._radius_neighbors(data, q, 3.0), tree.query_radius(q, r=3.0)):
        np.testing.assert_array_equal(a, np.sort(b))


def test_statistics_and_scale_factor_match_jax(trees, tmp_path):
    """Stage 009 on the merged tree and stage 010's scale factor."""
    root, jax_out, port_out = trees["ties"]
    tags = tmp_path / "tags" / DATE_REF
    tags.mkdir(parents=True)
    (tags / "tags.csv").write_text("sun\nclouds")
    for cls, fn, out in ((JaxPrepContext, jax_analysis.plot_statistics, jax_out),
                         (PrepContext, plot_statistics, port_out)):
        fn(cls(root=os.path.join(out, "data")), tag_root=str(tmp_path / "tags"))
    _assert_same_dir(os.path.join(jax_out, "data", "statistics"),
                     os.path.join(port_out, "data", "statistics"))
    rng = np.random.default_rng(2)
    feats, xy = rng.standard_normal((10, 4)).astype(np.float32), rng.random((10, 2)) * 10
    positives = [[j for j in range(10) if j != i][:3] for i in range(10)]
    assert scale_factor(feats, xy, positives, str(tmp_path / "p")) == \
        jax_analysis.scale_factor(feats, xy, positives, str(tmp_path / "j"))


def test_greedy_matches_jax():
    xy = np.random.default_rng(1).random((300, 2)) * 50
    assert greedy(xy, 4.0, np.random.default_rng(9)) == jax_greedy(xy, 4.0,
                                                                   np.random.default_rng(9))


def test_cli_prep(trees, tmp_path):
    """``cli prep`` with array tasks (one date each), then the merging run:
    the tree of the function-level run (which set the val fold's
    reference to the train date; the CLI keeps JAX's RobotCar dates, so
    its val fold is empty)."""
    root, _, port_out = trees["ties"]
    out = tmp_path / "cli"
    args = ["prep", "--root", str(out / "data"), "--raw_img_root", os.path.join(root, "raw"),
            "--ins_root", os.path.join(root, "raw"), "--tar_root", os.path.join(root, "tars"),
            "--img_root", str(out / "downsized"), "--camera_models", os.path.join(root, "models"),
            "--mask_root", os.path.join(root, "masks"), "--max_epochs", "2", "--device", "cpu"]
    for task in (1, 2):
        assert cli_main(args + ["--task_id", str(task)]) == 0
    assert sorted(os.listdir(out / "data" / "xy")) == [f"{DATE_REF}.csv", f"{DATE_QUERY}.csv"]
    assert not (out / "data" / "merged").exists() or not os.listdir(out / "data" / "merged")
    assert cli_main(args) == 0
    for stage_dir in ("img_info_240", "xy", "splits"):
        _assert_same_dir(os.path.join(port_out, "data", stage_dir),
                         str(out / "data" / stage_dir))
    for fold in ("train", "test"):
        for name in (f"clusters/{fold}_ref_5.csv", f"anchors/{fold}_ref_1_001.csv"):
            with open(os.path.join(port_out, "data", name)) as a, open(out / "data" / name) as b:
                assert a.read() == b.read(), name


class _FirstAnchors:
    """A source whose epochs stop after their first ``n`` anchors."""

    def __init__(self, source, n):
        self._source, self._n = source, n

    def __getattr__(self, name):
        return getattr(self._source, name)

    def anchor_indices(self, *args):
        return self._source.anchor_indices(*args)[: self._n]


def test_train_from_prep_tree(trees):
    """The prep -> train seam: the port's FilesystemSource reads the tree
    the port's stages wrote, and its Trainer runs 4 steps from it (the eval
    hooks stubbed)."""
    import tempfile

    from soft_contrastive_learning_torch.core.config import (
        LossConfig, ModelConfig, TrainConfig, TupleConfig)
    from soft_contrastive_learning_torch.data.pipeline import FilesystemSource
    from soft_contrastive_learning_torch.train.trainer import Trainer

    _, _, port_out = trees["ties"]
    data = os.path.join(port_out, "data")
    source = FilesystemSource(img_root=os.path.join(port_out, "downsized"),
                              shuffled_root=os.path.join(data, "shuffled"),
                              anchor_root=os.path.join(data, "anchors"),
                              loc_ref_root=os.path.join(data, "clusters"))
    meta = source.epoch_meta("train_ref", 0)
    img = source.load_image((meta["date"][0], meta["folder"][0], meta["t"][0]))
    assert img.shape == (160, 240, 3) and img.dtype == np.uint8
    cfg = TrainConfig(
        model=ModelConfig(vlad_cores=4, image_height=48, image_width=64,
                          compute_dtype="float32"),
        tuples=TupleConfig(positives_per_tuple=2, negatives_per_tuple=2,
                           hard_positives_per_tuple=0, hard_negatives_per_tuple=0),
        loss=LossConfig(name="wms"), tuples_per_batch=1, max_epoch=1, mining_step=2,
        mining_cache_size=4, eval_step=1000, save_step=1000, num_eval_queries=2,
        train_ref_r=1, seed=0)
    with tempfile.TemporaryDirectory() as out_dir:
        trainer = Trainer(cfg, _FirstAnchors(source, 4), out_dir=out_dir, device="cpu")
        trainer._run_eval = lambda *a, **k: None
        trainer.train()
        assert trainer.global_step == 4
        losses = [r["value"] for r in trainer.writers["local"].read_all() if r["tag"] == "loss"]
        assert losses and np.isfinite(losses).all()
        trainer.close()
