"""Command line of the port: ``serve`` and ``train``.

    python -m soft_contrastive_learning_torch.cli serve \
        --checkpoint soft_contrastive_learning_tpu/assets/flagship_trained.npz \
        --index features.pickle
    python -m soft_contrastive_learning_torch.cli train --toy_city --loss wms

Flags follow ``scl-tpu`` (``soft_contrastive_learning_tpu/cli.py``) with the
same names and defaults, limited to what the port runs so far, plus
``--device`` (default ``cuda``). ``--checkpoint`` takes, as the JAX CLI's
infer/serve loader does, a training-run directory of the port (its newest
checkpoint, with the run's own ModelConfig overriding the flags), a
flagship-layout npz, or a TF1 export as npz (its VGG16 and NetVLAD scopes
warm-started onto a fresh init); a file that matches no variable is
refused. For ``serve`` it defaults to the committed trained artifact; for
``train`` it is the warm start (default: a fresh init from ``--seed``). ``train --resume`` with the same
``--out_folder`` takes a stopped run up again from its newest rolling
checkpoint; a fresh run without ``--out_folder`` gets a unique suffix.
``train`` runs on the synthetic toy city (``--toy_city``); the filesystem
source comes with a later slice, and ``--loss`` keeps its default
``wrd``, which raises until the loss-zoo slice, so pass ``--loss wms``. The
Winograd configuration has no flag, as in ``scl-tpu``: pass
``ModelConfig(winograd=True)`` to ``DescriptorService`` or ``Trainer``.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Optional, Sequence

import numpy as np


def _bool_flag(s: str) -> bool:
    v = s.strip().lower()
    if v in ("true", "1", "yes"):
        return True
    if v in ("false", "0", "no"):
        return False
    raise argparse.ArgumentTypeError(f"expected a boolean, got {s!r}")


def _load_model_params(cfg, checkpoint: str, default_artifact: bool, seed: int = 0):
    """Resolve ``--checkpoint`` in the order of the JAX CLI's infer/serve
    loader (``soft_contrastive_learning_tpu/cli.py::_load_model_params``),
    for ``train`` and ``serve`` alike:

    1. a training-run DIRECTORY loads the run's own ModelConfig and newest
       checkpointed parameters (the train -> serve seam);
    2. an npz whose keys and shapes match the flag-built architecture is a
       flagship-layout artifact, loaded as it is;
    3. any other npz is a TF1 export: converted (``models/convert_tf1.py``)
       and its ``vgg16`` and ``netvlad`` scopes warm-started onto a fresh
       init drawn from ``seed`` (the heads stay fresh);
    4. a file that matches zero variables is refused.

    Empty: the committed artifact (``default_artifact``) or None, a fresh
    init. Returns ``(model_config, state_dict | None)``."""
    from soft_contrastive_learning_torch.models.weights import load_trained_params

    if checkpoint and os.path.isdir(checkpoint):
        from soft_contrastive_learning_torch.checkpoints.manager import load_run_params

        run_cfg, params = load_run_params(checkpoint)
        print(f"loaded trained params from run dir {checkpoint} "
              f"(run ModelConfig overrides flags)")
        return run_cfg, params
    if not checkpoint:
        return cfg, load_trained_params(None, cfg) if default_artifact else None
    if not checkpoint.endswith(".npz"):
        raise SystemExit(f"--checkpoint {checkpoint!r}: expected a .npz (a flagship artifact or "
                         "a TF1 export) or a training-run directory")
    try:
        params = load_trained_params(checkpoint, cfg)
    except ValueError:
        params = None
    if params is not None:
        print(f"loaded flagship artifact {checkpoint}")
        return cfg, params
    from soft_contrastive_learning_torch.checkpoints.manager import (
        WARM_START_SCOPES, warm_start_params)
    from soft_contrastive_learning_torch.models.convert_tf1 import convert_checkpoint, flatten
    from soft_contrastive_learning_torch.models.model import init_params
    from soft_contrastive_learning_torch.models.weights import params_from_flax

    donor, _ = convert_checkpoint(checkpoint)
    donor = {k: v for k, v in flatten(donor).items() if k.split("/")[0] in WARM_START_SCOPES}
    params, copied = warm_start_params(init_params(cfg, seed),
                                       params_from_flax(donor, cfg, partial=True))
    if not copied:
        raise SystemExit(
            f"--checkpoint {checkpoint!r} matched ZERO variables — "
            "neither a flagship params artifact for this architecture "
            "nor a TF1 export with recognizable names; refusing to run "
            "on silently-random params")
    print(f"warm-started {copied} from {checkpoint}")
    return cfg, params


def cmd_serve(args) -> int:
    from soft_contrastive_learning_torch.core.config import ModelConfig
    from soft_contrastive_learning_torch.serving import DescriptorService, serve
    from soft_contrastive_learning_torch.utils.io import load_pickle

    cfg = ModelConfig(vlad_cores=args.vlad_cores, reduction=args.reduction,
                      out_dim=args.out_dim)
    cfg, params = _load_model_params(cfg, args.checkpoint, default_artifact=True)
    index = np.asarray(load_pickle(args.index)) if args.index else None
    service = DescriptorService(cfg, params, batch_size=args.batch_size, index=index,
                                device=args.device)
    server = serve(service, host=args.host, port=args.port)
    print(f"serving on http://{args.host}:{server.server_address[1]}")
    try:
        server.serve_forever()
    finally:
        server.server_close()
    return 0


def config_from_args(args):
    from soft_contrastive_learning_torch.core.config import (
        LossConfig, ModelConfig, TrainConfig, TupleConfig)

    model = ModelConfig(vlad_cores=args.vlad_cores, reduction=args.reduction,
                        image_height=args.image_height, image_width=args.image_width,
                        compute_dtype=args.compute_dtype, use_kernels=args.use_pallas)
    tuples = TupleConfig(
        positives_per_tuple=args.positives_per_tuple,
        negatives_per_tuple=args.negatives_per_tuple,
        hard_positives_per_tuple=args.hard_positives_per_tuple,
        hard_negatives_per_tuple=args.hard_negatives_per_tuple,
        mutually_exclusive_negs=args.mutually_exclusive_negs,
        max_pos_radius=args.max_pos_radius, min_neg_radius=args.min_neg_radius)
    loss = LossConfig(name=args.loss, alpha=args.alpha, beta=args.beta,
                      wfunction=args.wfunction, sumfunction=args.sumfunction)
    return TrainConfig(
        model=model, tuples=tuples, loss=loss, checkpoint=args.checkpoint,
        tuples_per_batch=args.tuples_per_batch, max_epoch=args.max_epoch,
        base_lr=args.base_lr, minimal_lr=args.minimal_lr,
        lr_down_factor=args.lr_down_factor, lr_down_frequency=args.lr_down_frequency,
        momentum=args.momentum, optimizer=args.optimizer,
        mining_step=args.mining_step, mining_cache_size=args.mining_cache_size,
        eval_step=args.eval_step, save_step=args.save_step,
        num_eval_queries=args.num_eval_queries, eval_ref_r=args.eval_ref_r,
        train_ref_r=args.train_ref_r, local_ref_set=args.local_ref_set,
        local_query_set=args.local_query_set, other_ref_set=args.other_ref_set,
        other_query_set=args.other_query_set, seed=args.seed,
        device_image_pool=args.device_image_pool,
        device_pool_max_bytes=args.device_pool_max_bytes, max_to_keep=args.max_to_keep)


def cmd_train(args) -> int:
    import dataclasses

    from soft_contrastive_learning_torch.core.config import unique_out_dir
    from soft_contrastive_learning_torch.data.pipeline import ToyCitySource
    from soft_contrastive_learning_torch.train.trainer import Trainer

    cfg = config_from_args(args)
    if not args.toy_city:
        raise NotImplementedError(
            "training from the prep pipeline's files (FilesystemSource) comes with a "
            "later slice of the port; pass --toy_city")
    model_cfg, params = _load_model_params(cfg.model, args.checkpoint, default_artifact=False,
                                           seed=cfg.seed)
    cfg = dataclasses.replace(cfg, model=model_cfg)
    out_folder = args.out_folder or cfg.encode_name()
    out_dir = os.path.join(args.out_root, out_folder)
    if not args.out_folder and not args.resume:
        # fresh runs get a unique suffix; --resume must reuse the existing dir
        out_dir = unique_out_dir(args.out_root, out_folder)
    source = ToyCitySource(num_points=120, radius=150.0,
                           img_h=cfg.model.image_height, img_w=cfg.model.image_width)
    trainer = Trainer(cfg, source, out_dir=out_dir, device=args.device, params=params,
                      save_plots=args.save_plots)
    try:
        if args.resume and not trainer.resume_latest():
            trainer.log("--resume requested but no checkpoint found; starting fresh")
        trainer.train()
    finally:
        trainer.close()
    return 0


def _add_train_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--checkpoint", default="",
                   help="training-run directory, flagship-layout params npz or TF1 export "
                        "npz to start from (default: fresh init)")
    p.add_argument("--resume", action="store_true",
                   help="continue from the newest rolling checkpoint in the output directory "
                        "(pass the same --out_folder)")
    p.add_argument("--max_to_keep", type=int, default=1,
                   help="rolling checkpoints kept (epoch and part checkpoints keep all)")
    p.add_argument("--out_root", default="runs")
    p.add_argument("--out_folder", default="")
    p.add_argument("--toy_city", action="store_true", help="train on the synthetic toy city")
    p.add_argument("--positives_per_tuple", type=int, default=12)
    p.add_argument("--negatives_per_tuple", type=int, default=12)
    p.add_argument("--hard_positives_per_tuple", type=int, default=6)
    p.add_argument("--hard_negatives_per_tuple", type=int, default=6)
    p.add_argument("--mutually_exclusive_negs", type=_bool_flag, default=True)
    p.add_argument("--loss", default="wrd")
    p.add_argument("--alpha", type=float, default=0.8)
    p.add_argument("--beta", type=float, default=15.0)
    p.add_argument("--wfunction", default="exp", choices=["exp", "lin", "tanh"])
    p.add_argument("--sumfunction", default="ms", choices=["ms", "plain"])
    p.add_argument("--max_pos_radius", type=float, default=15.0)
    p.add_argument("--min_neg_radius", type=float, default=15.0)
    p.add_argument("--tuples_per_batch", type=int, default=2)
    p.add_argument("--max_epoch", type=int, default=5)
    p.add_argument("--base_lr", type=float, default=5e-6)
    p.add_argument("--minimal_lr", type=float, default=5e-12)
    p.add_argument("--lr_down_factor", type=float, default=0.5)
    p.add_argument("--lr_down_frequency", type=float, default=1.0)
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--optimizer", default="adam", choices=["adam", "momentum"])
    p.add_argument("--reduction", default="none",
                   choices=["none", "1fc", "2fc", "3fc", "pca", "spp"])
    p.add_argument("--vlad_cores", type=int, default=64)
    p.add_argument("--mining_step", type=int, default=250)
    p.add_argument("--mining_cache_size", type=int, default=1000)
    p.add_argument("--eval_step", type=int, default=100)
    p.add_argument("--save_step", type=int, default=500)
    p.add_argument("--num_eval_queries", type=int, default=50)
    p.add_argument("--eval_ref_r", type=int, default=5)
    p.add_argument("--train_ref_r", type=int, default=1)
    p.add_argument("--local_ref_set", default="train_ref")
    p.add_argument("--local_query_set", default="train_query")
    p.add_argument("--other_ref_set", default="test_ref")
    p.add_argument("--other_query_set", default="test_query")
    p.add_argument("--image_height", type=int, default=180)
    p.add_argument("--image_width", type=int, default=240)
    p.add_argument("--compute_dtype", default="bfloat16")
    p.add_argument("--use_pallas", type=_bool_flag, default=True,
                   help="the hand-written kernels' path (K1 here), as the JAX flag "
                        "selects its Pallas kernels")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--save_plots", action="store_true",
                   help="the evals also write curve PDFs and triptych PNGs")
    p.add_argument("--device_image_pool", type=_bool_flag, default=True)
    p.add_argument("--device_pool_max_bytes", type=int, default=4_000_000_000)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="soft_contrastive_learning_torch.cli")
    sub = parser.add_subparsers(dest="command", required=True)
    p = sub.add_parser("serve", help="HTTP descriptor-embedding service")
    p.add_argument("--checkpoint", default="",
                   help="training-run directory, flagship-layout params npz or TF1 export npz "
                        "(default: the committed trained artifact)")
    p.add_argument("--index", default="", help="feature pickle to serve /search from")
    p.add_argument("--vlad_cores", type=int, default=64)
    p.add_argument("--reduction", default="none")
    p.add_argument("--out_dim", type=int, default=512)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8377)
    p.add_argument("--device", default="cuda", help="torch device; 'cpu' only when asked")
    p.set_defaults(func=cmd_serve)

    p = sub.add_parser("train", help="train the embedding network")
    _add_train_flags(p)
    p.add_argument("--device", default="cuda", help="torch device; 'cpu' only when asked")
    p.set_defaults(func=cmd_train)
    return parser


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
