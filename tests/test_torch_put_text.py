"""The eval plots' labels (``utils/cv.py::put_text``) without OpenCV, against
``cv2.putText`` and the committed digests.

``put_text`` draws from the glyph table under
``soft_contrastive_learning_torch/assets/hershey/`` (written by
``scripts/make_hershey_glyphs.py``). Tolerance: none, every byte equal.
"""

import hashlib
import json
import os
import sys
from types import SimpleNamespace

import numpy as np
import pytest

from soft_contrastive_learning_torch.utils.cv import put_text

DIGESTS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "soft_contrastive_learning_torch", "assets", "hershey", "digests.json")
CANVASES = ((180, 240), (240, 180), (960, 1280))


def _labels():
    """The hooks' strings: "Query", and "Retrieved"/"Optimal" beside 120
    seeded distances, 0.0 and values of 4 to 6 digits among them."""
    rng = np.random.default_rng(2024)
    dists = [0.0, 0.05, 0.15, 999.95, 1000.0, 4321.07, 55555.55, 123456.7]
    dists += list(rng.exponential(30.0, 80)) + list(rng.uniform(0, 10_000, 32))
    out = ["Query"]
    for d in dists:
        out += [f"Retrieved {d:.1f}", f"Optimal {d:.1f}"]
    return out


@pytest.mark.parametrize("shape", CANVASES)
def test_put_text_equals_cv2_puttext(shape):
    """Every label, on a seeded uint8 canvas of each size, bit for bit."""
    cv2 = pytest.importorskip("cv2")
    labels = _labels()
    assert len(labels) >= 200
    for i, text in enumerate(labels):
        canvas = np.random.default_rng(i).integers(0, 256, (*shape, 3), dtype=np.uint8)
        want = cv2.putText(canvas.copy(), text, (10, 35), cv2.FONT_HERSHEY_SIMPLEX, 1,
                           (0, 255, 0), 2)
        got = put_text(text, canvas)
        assert got is canvas  # in place, as cv2.putText
        assert np.array_equal(got, want), text


def test_put_text_matches_the_committed_digests_without_cv2(monkeypatch):
    """With OpenCV made unimportable, as on the card's machine: every
    digest of ``digests.json`` (``cv2.putText`` on the machine that wrote
    the table) is put_text's."""
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError):
        import cv2  # noqa: F401
    with open(DIGESTS) as f:
        table = json.load(f)
    assert len(table["labels"]) >= 100
    for entry in table["labels"]:
        canvas = np.random.default_rng(entry["seed"]).integers(0, 256, entry["shape"],
                                                               dtype=np.uint8)
        got = put_text(entry["text"], canvas, color=tuple(table["color"]))
        assert hashlib.sha256(got.tobytes()).hexdigest() == entry["sha256"], entry["text"]


def test_put_text_refuses_what_the_table_does_not_hold():
    img = np.zeros((40, 80, 3), np.uint8)
    with pytest.raises(ValueError, match="scale 1"):
        put_text("Query", img, scale=2)
    with pytest.raises(ValueError, match="printable ASCII"):
        put_text("Optimal 3.0°", img)
    assert not img.any()


def test_the_eval_hook_triptychs_equal_jax_s(tmp_path, monkeypatch):
    """The port's ``EvalHooks.save_triptychs`` without OpenCV writes the
    triptychs JAX's eval hook writes with it, pixel for pixel, on the same
    images, picks and distances (one of 4+ digits)."""
    cv2 = pytest.importorskip("cv2")
    from soft_contrastive_learning_tpu.train.eval_hooks import EvalHooks as JaxEvalHooks
    from soft_contrastive_learning_torch.data.pipeline import ToyCitySource
    from soft_contrastive_learning_torch.train.eval_hooks import EvalHooks
    from soft_contrastive_learning_torch.utils.io import load_img

    source = ToyCitySource(num_points=24, radius=30.0, img_h=180, img_w=240, seed=3)
    query_meta = source.epoch_meta("train_query", 0)
    ref_meta = source.epoch_meta("train_ref", 0)
    n = 4
    q_idx = np.arange(n)
    latent = np.array([[3], [0], [7], [11]])
    opt = np.array([[1], [2], [5], [9]])
    query_xy = np.array([[0.0, 0.0], [10.0, 2.0], [2500.0, 40.0], [-3.0, 7.5]])
    ref_xy = np.random.default_rng(0).uniform(-50, 50, (24, 2))
    args = ("local", 0, 12, query_meta, q_idx, ref_meta, latent, opt, query_xy, ref_xy)
    dirs = {}
    for name, hooks in (("jax", JaxEvalHooks), ("port", EvalHooks)):
        out_dir = tmp_path / name
        t = SimpleNamespace(out_dir=str(out_dir), eval_rng=np.random.default_rng(5),
                            source=source, log=print)
        if name == "port":
            monkeypatch.setitem(sys.modules, "cv2", None)
        hooks(t).save_triptychs(*args)
        dirs[name] = out_dir / "local_00_12_examples"
    names = sorted(os.listdir(dirs["jax"]))
    assert len(names) == n and sorted(os.listdir(dirs["port"])) == names
    monkeypatch.delitem(sys.modules, "cv2")
    for name in names:
        want = cv2.imread(str(dirs["jax"] / name))[..., ::-1]
        got = load_img(str(dirs["port"] / name), "cpu")
        assert want.shape == (180, 720, 3)
        assert np.array_equal(got, want), name
