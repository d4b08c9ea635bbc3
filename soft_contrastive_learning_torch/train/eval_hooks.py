"""In-training evaluation: held-out loss, localization, triptych plots. The
counterpart of ``soft_contrastive_learning_tpu/train/eval_hooks.py``.

``EvalHooks`` reads a narrow surface of its host trainer at call time:
``cfg``, ``source``, ``eval_rng``, ``extract_features`` (whitened by the
streaming PCA with ``reduction='pca'``), ``eval_loss_step``,
``_sampler_for``, ``_to_device``, ``_augment_batch`` (the streaming PCAs'
states, drained before the evals), ``_pool`` (the decode threads),
``writers``, ``log``, ``save_plots``, ``out_dir``. Both hooks take ``eval_ordinal``, the count of eval firings
(``abs_step // eval_step``), to pick their rolling window of queries.

Retrieval is the dense ``ops/topk.py::topk_l2`` on the device (the eval
sets are far below the row count at which the streamed kernel takes over);
only the (Q, k) neighbour ids cross to the host. On a mesh every rank runs
both hooks: ``extract_features`` and ``eval_loss_step`` embed each rank's
share and gather it, the held-out loss is the global batch's, and only the
primary's writers write.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np
import torch

from soft_contrastive_learning_torch.data.pipeline import assemble_batch
from soft_contrastive_learning_torch.evaluation.metrics import (
    localization_summary,
    save_curve_plot,
)
from soft_contrastive_learning_torch.ops.topk import topk_l2
from soft_contrastive_learning_torch.utils.meta import get_xy, image_keys


class EvalHooks:
    def __init__(self, trainer):
        self.t = trainer

    def loss_other(self, epoch: int, global_step: int, eval_ordinal: int) -> None:
        """The training loss on the held-out region: ``num_eval_queries``
        anchors (rounded down to whole batches) from window ``eval_ordinal``
        of the epoch's shuffled set, sampled without hard mining, mean of
        the batches that gave a valid tuple."""
        t = self.t
        cfg = t.cfg
        meta = t.source.epoch_meta(cfg.other_ref_set, epoch)
        sampler = t._sampler_for(meta, rng=t.eval_rng)
        n = len(meta["t"])
        per_eval = (cfg.num_eval_queries // cfg.tuples_per_batch) * cfg.tuples_per_batch
        idx = np.arange(eval_ordinal * per_eval, (eval_ordinal + 1) * per_eval) % n
        outs = []
        for chunk in idx.reshape(-1, cfg.tuples_per_batch):
            sample = sampler.sample(chunk, use_hard=False)
            if sample is None:
                continue
            batch = assemble_batch(cfg, t.source, meta, sample.indices, sample.payload, epoch,
                                   t._pool)
            outs.append(t.eval_loss_step(t._augment_batch(t._to_device(batch))))
        if not outs:
            t.log("Evaluated but got no valid losses.")
            return
        # one device-to-host transfer per key, after every chunk is launched
        mean = {k: float(np.mean(torch.stack([o[k] for o in outs]).tolist())) for k in outs[0]}
        t.writers["other"].scalars(mean, global_step)
        t.log(f"Other region loss: {mean}")

    def localization(self, epoch: int, global_step: int, ref_set: str, query_set: str,
                     mode: str, eval_ordinal: int) -> Dict[str, float]:
        """Localization of ``num_eval_queries`` queries (window
        ``eval_ordinal`` of the epoch's shuffled query set) against every
        ``eval_ref_r``-th reference pose, by top-k in descriptor space on
        the device; the scalars go to the ``mode`` writer."""
        t = self.t
        cfg = t.cfg
        ref_meta = t.source.cluster_meta(ref_set, cfg.eval_ref_r)
        n_ref = len(ref_meta["t"])
        ref_xy = get_xy(ref_meta)
        query_meta = t.source.epoch_meta(query_set, epoch)
        q_idx = np.arange(eval_ordinal * cfg.num_eval_queries,
                          (eval_ordinal + 1) * cfg.num_eval_queries) % len(query_meta["t"])
        query_xy = get_xy(query_meta)[q_idx]

        ref_features = t.extract_features(ref_meta, np.arange(n_ref))
        query_features = t.extract_features(query_meta, q_idx)
        _, latent_idx = topk_l2(query_features, ref_features, min(5, n_ref))
        latent_idx = latent_idx.cpu().numpy()
        # the geographically nearest ref on the host in float64: raw UTM
        # coordinates (~1e6 m) leave fp32 no precision for q^2 - 2qr + r^2
        geo_d = np.linalg.norm(query_xy[:, None, :] - ref_xy[None, :, :], axis=-1)
        opt_idx = np.argmin(geo_d, axis=1)[:, None]
        opt_dists = geo_d[np.arange(len(query_xy)), opt_idx[:, 0]]

        scalars, curves = localization_summary(query_xy, ref_xy, latent_idx, opt_dists)
        t.writers[mode].scalars(scalars, global_step)
        t.log(f"[{mode}] localization @{global_step}: {scalars}")
        if t.save_plots:
            for rad, bundle in curves.items():
                save_curve_plot(
                    bundle, rad, f"{mode} epoch {epoch}",
                    os.path.join(t.out_dir, f"{mode}_{epoch:02d}_{global_step}_{rad}.pdf"))
            self.save_triptychs(mode, epoch, global_step, query_meta, q_idx, ref_meta,
                                latent_idx, opt_idx, query_xy, ref_xy)
        return scalars

    def save_triptychs(self, mode, epoch, global_step, query_meta, q_idx, ref_meta,
                       latent_idx, opt_idx, query_xy, ref_xy, num_examples: int = 10) -> None:
        """Query / retrieved / optimal image triptychs as PNGs (needs
        OpenCV; taken only with ``save_plots``)."""
        from soft_contrastive_learning_torch.utils.cv import merge_images, put_text
        from soft_contrastive_learning_torch.utils.io import save_img

        t = self.t
        out_dir = os.path.join(t.out_dir, f"{mode}_{epoch:02d}_{global_step}_examples")
        os.makedirs(out_dir, exist_ok=True)
        picks = t.eval_rng.choice(len(q_idx), size=min(num_examples, len(q_idx)), replace=False)
        for i in picks:
            ri, oi = int(latent_idx[i, 0]), int(opt_idx[i, 0])
            (q_key,) = image_keys(query_meta, [int(q_idx[i])])
            r_key, o_key = image_keys(ref_meta, [ri, oi])
            try:
                q_img = put_text("Query", t.source.load_image(q_key).copy())
                d_r = float(np.linalg.norm(query_xy[i] - ref_xy[ri]))
                r_img = put_text(f"Retrieved {d_r:.1f}", t.source.load_image(r_key).copy())
                d_o = float(np.linalg.norm(query_xy[i] - ref_xy[oi]))
                o_img = put_text(f"Optimal {d_o:.1f}", t.source.load_image(o_key).copy())
                merged = merge_images(merge_images(q_img, r_img), o_img)
                save_img(merged, os.path.join(out_dir, f"{q_key[2]}.png"))
            except (KeyError, OSError) as e:  # missing image file: skip the example
                t.log(f"triptych skipped: {e}")
