"""Command line of the port: ``serve``, ``train``, ``infer``, ``topn``,
``roc``, ``quant``, ``bench``, ``cache``, ``metrics``, ``prep`` and
``parity``.

    python -m soft_contrastive_learning_torch.cli serve \
        --checkpoint soft_contrastive_learning_tpu/assets/flagship_trained.npz \
        --index features.pickle
    python -m soft_contrastive_learning_torch.cli quant --image_dir images \
        --checkpoint soft_contrastive_learning_tpu/assets/flagship_trained.npz --out scales.json
    python -m soft_contrastive_learning_torch.cli serve --quant_scales scales.json
    python -m soft_contrastive_learning_torch.cli bench
    python -m soft_contrastive_learning_torch.cli train \
        --img_root <prep>/downsized --shuffled_root <prep>/data/shuffled \
        --anchor_root <prep>/data/anchors --loc_ref_root <prep>/data/clusters
    python -m soft_contrastive_learning_torch.cli infer --set toy_ref \
        --csv_root lists --img_root imgs --out_root lv
    python -m soft_contrastive_learning_torch.cli topn --pca_lv_pickle lv/toy_pca_model.pickle \
        --ref_lv_pickle lv/toy_ref_model.pickle --query_lv_pickle lv/toy_query_model.pickle \
        --ref_csv lists/toy_ref.csv --query_csv lists/toy_query.csv
    python -m soft_contrastive_learning_torch.cli roc --top_n_root top_n --queries toy_query
    python -m soft_contrastive_learning_torch.cli bench --train [--async_mining] [--no_cache]
    python -m soft_contrastive_learning_torch.cli cache --cache_dir dc --toy_city
    python -m soft_contrastive_learning_torch.cli metrics --run_dir runs/<run> --tb-export
    python -m soft_contrastive_learning_torch.cli prep --root <prep>/data \
        --raw_img_root <raw> --ins_root <raw> --tar_root <tars> \
        --img_root <prep>/downsized --mask_root <masks>
    python -m soft_contrastive_learning_torch.cli parity --checkpoint tf1_export.npz \
        --images imgs --golden golden.npz

Flags follow ``scl-tpu`` (``soft_contrastive_learning_tpu/cli.py``) with the
same names and defaults, limited to what the port runs so far, plus
``--device`` (default ``cuda``; the CPU only when asked). ``--checkpoint``
takes, as the JAX CLI's infer/serve loader does, a training-run directory
of the port (its newest checkpoint, with the run's own ModelConfig
overriding the flags), a flagship-layout npz, or a TF1 export as npz (its
VGG16 and NetVLAD scopes warm-started onto a fresh init); a file that
matches no variable is refused. For ``serve`` and ``infer`` it defaults to
the committed trained artifact (JAX: a fresh random init); for ``train`` it
is the warm start (default: a fresh init from ``--seed``). ``train
--resume`` with the same ``--out_folder`` takes a stopped run up again from
its newest rolling checkpoint; a fresh run without ``--out_folder`` gets a
unique suffix. ``train`` reads the prep pipeline's tree (``--img_root
--shuffled_root --anchor_root --loc_ref_root``), or the synthetic toy city
with ``--toy_city``; ``--loss`` takes JAX's 33 names, its default ``wrd``
included (``losses/registry.py::LOSS_NAMES``), and ``--reduction`` its six
(``none``, ``1fc``/``2fc``/``3fc`` to ``--out_dim``, ``pca``, ``spp`` over
``--L`` levels), with ``--vlad_cores 0`` for the flattened map; ``--f`` is
the streaming PCAs' forgetting factor. ``serve`` and ``infer`` take
``--reduction --out_dim --vlad_cores``: ``/embed`` and the dump return the
FC or SPP output, and the raw descriptor for ``none`` and ``pca``, as
JAX's. A flagship npz loads only where its keys match the architecture
(a head's weights included): a head is trained from a run directory or an
npz that holds it. The Winograd
configuration has no flag, as in ``scl-tpu``: pass
``ModelConfig(winograd=True)`` to ``DescriptorService`` or ``Trainer``.
``train --fused_wms True`` sets ``LossConfig.fused_wms``, which ``scl-tpu``
sets in code only; ``bench --iters`` sets the timed forwards per
configuration (these two and ``--device`` are the port's only flags beyond
``scl-tpu``'s). ``quant`` calibrates the int8-PTQ activation scales
(``models/quant.py``) from the PNG and JPEG images of ``--image_dir`` (a
JPEG decoded on ``--device``; a ``.bmp`` is refused with the reason) and
writes JAX's JSON; ``serve --quant_scales`` serves through the int8 stack (Q1 on the
card: a build or launch failure fails the command, nothing falls back).
``bench`` is the embed benchmark (``benchmark.py``); ``bench --train`` the
train-loop benchmark (``bench_train.py``) with ``--tuples_per_batch
--num_points --no_cache --async_mining --steps_per_dispatch``; those flags
without ``--train`` are refused with the reason. ``train
--steps_per_dispatch K`` groups K train steps into one dispatch
(``train/step.py::build_train_step_scan``), as JAX's flag fuses them.
``train --async_mining True`` refreshes the mining cache on a worker
thread; ``train --decoded_cache_root`` reads the images from the cache that
``cache`` writes (``data/decoded_cache.py``); ``train --task_id -1`` renders
and submits an array job of a frozen copy of this file
(``launch/jobs.py``, ``--queue``). ``train --num_data_shards N`` trains on
N data-parallel ranks (``parallel/mesh.py``): under a launcher that set
``WORLD_SIZE`` (``torchrun --nproc_per_node N -m
soft_contrastive_learning_torch.cli train ...``) N must match it (0: the
launcher's); without one, N > 1 starts N local ranks itself, one per
visible card on NCCL (more ranks than cards is refused), or N gloo ranks
with ``--device cpu``. ``metrics`` prints a run's JSONL scalars
(``--plot``: a PDF per tag, matplotlib; ``--tb-export``: TensorBoard event
files, ``core/tb_export.py``). ``roc`` draws its figure with matplotlib,
which a host may lack; the curves themselves are
``evaluation/roc.py::correctly_localized_curve``. ``prep`` runs the
RobotCar ETL pipeline (``data/robotcar/``): per date the downsize on
``--device`` (demosaic, undistort, resize, OpenCV's pixels), the INS
interpolation and, with ``--mask_root``, the splits; then stages 004-014
(``--task_id N > 0``: the N-th date only, an array job's task; a final run
without it merges), and stage 009's statistics with ``--statistics``.
``parity`` embeds images with a converted TF1 export in fp32 and compares
them with a golden ``.npz`` (exit code 1 past ``--tolerance``) or writes
them (``--out``).
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
       and its ``vgg16`` and ``netvlad`` scopes, those the architecture has,
       warm-started onto a fresh init drawn from ``seed`` (the heads stay
       fresh);
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
    from soft_contrastive_learning_torch.models.weights import flax_param_shapes, params_from_flax

    donor, _ = convert_checkpoint(checkpoint)
    # the scopes the architecture has: with 'spp' or vlad_cores=0 no NetVLAD
    scopes = {k.split("/")[0] for k in flax_param_shapes(cfg)} & set(WARM_START_SCOPES)
    donor = {k: v for k, v in flatten(donor).items() if k.split("/")[0] in scopes}
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


def build_server(args):
    """The ``serve`` command's service and HTTP server, built and not
    started; the service is the server's ``service`` attribute."""
    from soft_contrastive_learning_torch.core.config import ModelConfig
    from soft_contrastive_learning_torch.serving import DescriptorService, serve
    from soft_contrastive_learning_torch.utils.io import load_pickle

    cfg = ModelConfig(vlad_cores=args.vlad_cores, reduction=args.reduction,
                      out_dim=args.out_dim)
    cfg, params = _load_model_params(cfg, args.checkpoint, default_artifact=True)
    index = np.asarray(load_pickle(args.index)) if args.index else None
    quant_scales = None
    if args.quant_scales:
        from soft_contrastive_learning_torch.models.quant import load_scales

        quant_scales = load_scales(args.quant_scales)
    service = DescriptorService(cfg, params, batch_size=args.batch_size, index=index,
                                device=args.device, quant_scales=quant_scales)
    server = serve(service, host=args.host, port=args.port)
    server.service = service
    return server


def cmd_serve(args) -> int:
    server = build_server(args)
    print(f"serving on http://{args.host}:{server.server_address[1]}")
    try:
        server.serve_forever()
    finally:
        server.server_close()
    return 0


def cmd_quant(args) -> int:
    """Calibrate the int8-PTQ activation scales (``models/quant.py``) from
    sample images and write them as JSON for ``serve --quant_scales``."""
    from soft_contrastive_learning_torch.core.config import ModelConfig, resolve_device
    from soft_contrastive_learning_torch.models.model import init_params
    from soft_contrastive_learning_torch.models.quant import calibrate_scales, save_scales
    from soft_contrastive_learning_torch.utils.cv import normalize_geometry
    from soft_contrastive_learning_torch.utils.io import IMAGE_EXTENSIONS, load_img

    cfg = ModelConfig(vlad_cores=args.vlad_cores, reduction=args.reduction,
                      out_dim=args.out_dim)
    if args.checkpoint:
        cfg, params = _load_model_params(cfg, args.checkpoint, default_artifact=False)
    elif not args.allow_random:
        # scales calibrated on random weights are wrong for any real model
        print("error: --checkpoint (npz or run dir) required; scales calibrated on randomly "
              "initialized weights would silently mis-quantize a real model. Pass "
              "--allow_random to override for smoke tests.")
        return 1
    else:
        params = init_params(cfg, 0)
    names = sorted(n for n in os.listdir(args.image_dir)
                   if os.path.splitext(n)[1].lower() in IMAGE_EXTENSIONS)[: args.num_images]
    if not names:
        print(f"no images in {args.image_dir}")
        return 1
    device = resolve_device(args.device)
    imgs = np.stack([
        normalize_geometry(load_img(os.path.join(args.image_dir, n), device), cfg.image_height,
                           cfg.image_width, keep_aspect=cfg.vlad_cores > 0)
        for n in names]).astype(np.float32)
    scales = calibrate_scales(params, imgs, device)
    save_scales(scales, args.out)
    print(f"calibrated {len(scales)} conv scales from {len(imgs)} images -> {args.out}")
    return 0


# flags of the train-loop benchmark (bench_train.py) with their defaults
BENCH_TRAIN_FLAGS = {"tuples_per_batch": 2, "num_points": 600, "no_cache": False,
                     "steps_per_dispatch": 1, "async_mining": False}


def cmd_bench(args) -> int:
    if args.train:
        import json

        from soft_contrastive_learning_torch import bench_train

        print(json.dumps(bench_train.run(
            tuples_per_batch=args.tuples_per_batch, num_points=args.num_points,
            use_cache=not args.no_cache, steps_per_dispatch=args.steps_per_dispatch,
            async_mining=args.async_mining, device=args.device)))
        return 0
    asked = [f"--{k}" for k, default in BENCH_TRAIN_FLAGS.items() if getattr(args, k) != default]
    if asked:
        raise SystemExit(f"bench {' '.join(asked)}: a flag of the train-loop benchmark; "
                         "pass --train with it")
    from soft_contrastive_learning_torch import benchmark

    benchmark.main(["--iters", str(args.iters), "--device", args.device])
    return 0


def cmd_cache(args) -> int:
    """Write the decoded-uint8 image cache (``data/decoded_cache.py``), a
    prep stage that moves the image decode off the training loop."""
    from soft_contrastive_learning_torch.data.decoded_cache import cache_training_sets
    from soft_contrastive_learning_torch.data.pipeline import FilesystemSource, ToyCitySource

    if args.toy_city:
        source = ToyCitySource(img_h=args.image_height, img_w=args.image_width)
    else:
        # JAX's cache has no --device: a JPEG tree is decoded on the card (a
        # PNG one on the host, anywhere)
        source = FilesystemSource(args.img_root, args.shuffled_root, args.anchor_root,
                                  args.loc_ref_root, device="cuda")
    cluster_sets = []
    for spec in (args.cluster_sets or "").split(","):
        if spec:
            name, r = spec.rsplit(":", 1)
            cluster_sets.append((name, int(r)))
    cache_training_sets(source, [s for s in args.sets.split(",") if s], args.image_height,
                        args.image_width, keep_aspect=args.vlad_cores > 0,
                        cache_dir=args.cache_dir, cluster_sets=cluster_sets,
                        num_workers=args.num_workers)
    return 0


def cmd_metrics(args) -> int:
    """Summarize a run's JSONL metrics as JAX's ``metrics`` prints them;
    ``--plot`` draws a PDF per tag (matplotlib), ``--tb-export`` writes
    TensorBoard event files (``core/tb_export.py``)."""
    import json

    summary = {}
    for role in ("local", "other"):
        path = os.path.join(args.run_dir, f"metrics_{role}.jsonl")
        if not os.path.exists(path):
            continue
        series = {}
        with open(path) as f:
            for line in f:
                if not line.strip():
                    continue  # a blank or truncated last line
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue
                series.setdefault(rec["tag"], []).append((rec["step"], rec["value"]))
        summary[role] = series
        for tag, pts in sorted(series.items()):
            vals = [v for _, v in pts]
            print(f"[{role}] {tag}: n={len(vals)} last={vals[-1]:.6g} "
                  f"min={min(vals):.6g} max={max(vals):.6g}")
        if args.plot:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt

            for tag, pts in series.items():
                plt.clf()
                xs, ys = zip(*sorted(pts))
                plt.plot(xs, ys)
                plt.xlabel("step")
                plt.ylabel(tag)
                plt.title(f"{role}/{tag}")
                safe = tag.replace("/", "_").replace("%", "pct").replace("<", "lt")
                plt.savefig(os.path.join(args.run_dir, f"metric_{role}_{safe}.pdf"))
    if args.tb_export:
        from soft_contrastive_learning_torch.core.tb_export import export_run

        counts = export_run(args.run_dir)
        for role, n in counts.items():
            print(f"[tb] wrote {n} scalars -> {args.run_dir}/tb/{role}")
        if not counts:
            print("no metrics found to export")
    if not summary:
        print("no metrics found")
        return 1
    return 0


def cmd_infer(args) -> int:
    from soft_contrastive_learning_torch.core.config import ModelConfig
    from soft_contrastive_learning_torch.evaluation.inference import run_inference

    cfg = ModelConfig(vlad_cores=args.vlad_cores, reduction=args.reduction,
                      out_dim=args.out_dim)
    cfg, params = _load_model_params(cfg, args.checkpoint, default_artifact=True)
    out = run_inference(cfg, params, args.set, args.csv_root, args.img_root, args.out_root,
                        args.out_name, batch_size=args.images_per_pass, device=args.device,
                        dump_dtype=args.dump_dtype)
    print(out)
    return 0


def cmd_topn(args) -> int:
    from soft_contrastive_learning_torch.evaluation.topn import get_top_n
    from soft_contrastive_learning_torch.utils.io import load_csv, load_pickle
    from soft_contrastive_learning_torch.utils.meta import get_xy

    name = "".join(os.path.basename(args.query_lv_pickle).split(".")[:-1])
    kwargs = {}
    if args.dims:
        kwargs["dims"] = tuple(int(d) for d in args.dims.split(","))
    if args.spacings:
        kwargs["spacings"] = tuple(float(s) for s in args.spacings.split(","))
    paths = get_top_n(
        np.asarray(load_pickle(args.pca_lv_pickle)),
        np.asarray(load_pickle(args.ref_lv_pickle)),
        np.asarray(load_pickle(args.query_lv_pickle)),
        get_xy(load_csv(args.ref_csv)),
        get_xy(load_csv(args.query_csv)),
        args.out_root, name, n=args.N, device=args.device, **kwargs,
    )
    print("\n".join(sorted(paths.values())))
    return 0


def cmd_roc(args) -> int:
    from soft_contrastive_learning_torch.evaluation.roc import compile_roc

    kwargs = {}
    if args.queries:
        kwargs["queries"] = tuple((name, name, 0) for name in args.queries.split(","))
    out = compile_roc(args.top_n_root, args.out_root, setting=f"l{args.l}_dim{args.d}",
                      **kwargs)
    print(out or "no top-n pickles found")
    return 0 if out else 1


def cmd_prep(args) -> int:
    from soft_contrastive_learning_torch.data.robotcar import prep
    from soft_contrastive_learning_torch.data.robotcar.analysis import plot_statistics
    from soft_contrastive_learning_torch.data.robotcar.downsize import downsize_images
    from soft_contrastive_learning_torch.data.robotcar.stages import PrepContext, run_all

    ctx = PrepContext(
        root=args.root, raw_img_root=args.raw_img_root, ins_root=args.ins_root,
        tar_root=args.tar_root, img_root=args.img_root,
        camera_models=args.camera_models, max_epochs=args.max_epochs,
        grid_masks={
            name: os.path.join(args.mask_root, f"{name}.png")
            for name in ("full", "train", "test", "val")
        } if args.mask_root else {},
    )
    dates = sorted(os.listdir(ctx.ins_root)) if ctx.ins_root else []
    if args.task_id > 0:
        # array-job sharding: one date per task (the reference's per-date
        # array contract, prepare_data/001:22-25)
        dates = dates[args.task_id - 1 : args.task_id]
    for date in dates:
        downsize_images(ctx, date, device=args.device)
        prep.interpolate_image_xy(ctx, date)
        if ctx.grid_masks:
            prep.assign_splits(ctx, date)
    if args.task_id > 0:
        return 0  # array tasks only do per-date work; a final run merges
    run_all(prep.metadata_stages(ctx), ctx)
    if args.statistics:
        plot_statistics(ctx, tag_root=args.tag_root)
    return 0


def cmd_parity(args) -> int:
    """Descriptor parity against a converted reference TF1 checkpoint."""
    import json

    from soft_contrastive_learning_torch.evaluation.parity import run_parity

    report = run_parity(checkpoint=args.checkpoint, images=args.images, golden=args.golden,
                        out=args.out, tolerance=args.tolerance, device=args.device)
    print(json.dumps(report.to_dict(), indent=1))
    return 1 if report.passed is False else 0


def config_from_args(args):
    from soft_contrastive_learning_torch.core.config import (
        LossConfig, ModelConfig, TrainConfig, TupleConfig)

    model = ModelConfig(vlad_cores=args.vlad_cores, reduction=args.reduction,
                        out_dim=args.out_dim, spp_levels=args.L,
                        image_height=args.image_height, image_width=args.image_width,
                        compute_dtype=args.compute_dtype, use_kernels=args.use_pallas)
    tuples = TupleConfig(
        positives_per_tuple=args.positives_per_tuple,
        negatives_per_tuple=args.negatives_per_tuple,
        hard_positives_per_tuple=args.hard_positives_per_tuple,
        hard_negatives_per_tuple=args.hard_negatives_per_tuple,
        mutually_exclusive_negs=args.mutually_exclusive_negs,
        max_pos_radius=args.max_pos_radius, min_neg_radius=args.min_neg_radius)
    loss = LossConfig(name=args.loss, margin_1=args.margin_1, margin_2=args.margin_2,
                      lam=args.lam, alpha=args.alpha, beta=args.beta,
                      wfunction=args.wfunction, sumfunction=args.sumfunction,
                      ms_mining=args.msmining, loss_dim=args.loss_dim,
                      d_max_squared=args.max_pos_radius**2, fused_wms=args.fused_wms)
    return TrainConfig(
        model=model, tuples=tuples, loss=loss, checkpoint=args.checkpoint,
        img_root=args.img_root, shuffled_root=args.shuffled_root,
        loc_ref_root=args.loc_ref_root, anchor_root=args.anchor_root,
        tuples_per_batch=args.tuples_per_batch, max_epoch=args.max_epoch,
        base_lr=args.base_lr, minimal_lr=args.minimal_lr,
        lr_down_factor=args.lr_down_factor, lr_down_frequency=args.lr_down_frequency,
        momentum=args.momentum, optimizer=args.optimizer, forgetting_factor=args.f,
        mining_step=args.mining_step, mining_cache_size=args.mining_cache_size,
        eval_step=args.eval_step, save_step=args.save_step,
        num_eval_queries=args.num_eval_queries, eval_ref_r=args.eval_ref_r,
        train_ref_r=args.train_ref_r, local_ref_set=args.local_ref_set,
        local_query_set=args.local_query_set, other_ref_set=args.other_ref_set,
        other_query_set=args.other_query_set, seed=args.seed,
        device_image_pool=args.device_image_pool,
        device_pool_max_bytes=args.device_pool_max_bytes, max_to_keep=args.max_to_keep,
        steps_per_dispatch=args.steps_per_dispatch, async_mining=args.async_mining,
        num_data_shards=args.num_data_shards)


def _submit_train_job(args, out_dir: str, out_folder: str) -> None:
    """``train --task_id -1``: freeze this file in ``out_dir`` and submit
    ``python cli.py train <the same flags>`` as an array job of one
    (``launch/jobs.py``), as JAX's CLI submits its own. A flag that takes no
    value is rendered bare when it was given; a boolean that takes a value
    is rendered with it."""
    from soft_contrastive_learning_torch.launch.jobs import run_one_job

    probe = argparse.ArgumentParser()
    _add_train_flags(probe)
    bare_flags = {a.dest: (a.option_strings[-1].lstrip("-"), a.const) for a in probe._actions
                  if a.nargs == 0 and isinstance(a.const, bool) and a.option_strings}
    params = []
    for k, v in vars(args).items():
        if k in ("task_id", "func", "command") or v is None or (isinstance(v, str) and v == ""):
            continue
        if isinstance(v, bool):
            if k in bare_flags:
                flag, const = bare_flags[k]
                if v == const:
                    params.append((flag, True))
            else:
                params.append((k, str(v)))
            continue
        params.append((k, v))
    if not any(k == "out_folder" for k, _ in params):
        # run_one_job makes out_dir first: without the name pinned the job's
        # unique_out_dir would move to a _000 suffix
        params.append(("out_folder", out_folder))
    run_one_job(os.path.abspath(__file__), params, positional_args=("train",), queue=args.queue,
                out_dir=out_dir, memory=50, name=f"train_{args.loss}", overwrite=True,
                array=True, num_jobs=1)


def _train_out_dir(args, cfg) -> tuple:
    """(out_dir, out_folder) of a ``train`` run: a fresh run without
    ``--out_folder`` gets a unique suffix; ``--resume`` reuses the dir."""
    from soft_contrastive_learning_torch.core.config import unique_out_dir

    out_folder = args.out_folder or cfg.encode_name()
    if not args.out_folder and not args.resume and args.task_id != -1:
        return unique_out_dir(args.out_root, out_folder), out_folder
    return os.path.join(args.out_root, out_folder), out_folder


def _run_training(args, out_dir: str, mesh=None) -> int:
    """Build the source and the trainer (on ``mesh`` when given) and train."""
    import dataclasses

    from soft_contrastive_learning_torch.data.pipeline import FilesystemSource, ToyCitySource
    from soft_contrastive_learning_torch.train.trainer import Trainer

    cfg = config_from_args(args)
    model_cfg, params = _load_model_params(cfg.model, args.checkpoint, default_artifact=False,
                                           seed=cfg.seed)
    cfg = dataclasses.replace(cfg, model=model_cfg)
    if args.toy_city:
        source = ToyCitySource(num_points=120, radius=150.0,
                               img_h=cfg.model.image_height, img_w=cfg.model.image_width)
    else:
        source = FilesystemSource(cfg.img_root, cfg.shuffled_root, cfg.anchor_root,
                                  cfg.loc_ref_root,
                                  device=mesh.device if mesh is not None else args.device)
    if args.decoded_cache_root:
        from soft_contrastive_learning_torch.data.decoded_cache import CachedDecodedSource

        source = CachedDecodedSource(source, args.decoded_cache_root)
    trainer = Trainer(cfg, source, out_dir=out_dir, device=args.device, params=params,
                      save_plots=args.save_plots, mesh=mesh)
    try:
        if args.resume and not trainer.resume_latest():
            trainer.log("--resume requested but no checkpoint found; starting fresh")
        trainer.train()
    finally:
        trainer.close()
    return 0


def train_rank(mesh, args, out_dir: str) -> int:
    """One local rank of ``train --num_data_shards N`` (``run_ranks``'s
    target)."""
    return _run_training(args, out_dir, mesh)


def cmd_train(args) -> int:
    import torch

    from soft_contrastive_learning_torch.core.config import resolve_device

    cfg = config_from_args(args)  # refuses a batch that does not divide over the ranks
    n = args.num_data_shards
    launched = int(os.environ.get("WORLD_SIZE") or 1)
    if launched > 1:  # one rank of torchrun's N: join them
        import torch.distributed as dist

        from soft_contrastive_learning_torch.launch.multihost import initialize_multihost
        from soft_contrastive_learning_torch.parallel.mesh import make_mesh

        if n not in (0, launched):
            raise SystemExit(f"--num_data_shards {n} but the launcher started {launched} ranks")
        initialize_multihost(device=args.device)
        mesh = make_mesh(num_data=launched)
        # rank 0 names a fresh run's directory, so that every rank writes to the same one
        box = [_train_out_dir(args, cfg)[0] if mesh.rank == 0 else None]
        dist.broadcast_object_list(box, src=0)
        try:
            return _run_training(args, box[0], mesh)
        finally:
            dist.destroy_process_group()
    out_dir, out_folder = _train_out_dir(args, cfg)
    if args.task_id == -1:
        _submit_train_job(args, out_dir, out_folder)
        return 0
    if n <= 1:
        return _run_training(args, out_dir)
    device = resolve_device(args.device)
    if device.type == "cuda" and n > torch.cuda.device_count():
        raise SystemExit(f"--num_data_shards {n} needs a card per rank, and "
                         f"{torch.cuda.device_count()} are visible (start the ranks with a "
                         "launcher on a node that has them, or train on fewer)")
    from soft_contrastive_learning_torch.launch.multihost import run_ranks

    run_ranks(train_rank, n, (args, out_dir), device=device.type, timeout_s=None)
    return 0


def _add_train_flags(p: argparse.ArgumentParser) -> None:
    # the prep pipeline's tree (data/pipeline.py::FilesystemSource)
    p.add_argument("--img_root", default="")
    p.add_argument("--shuffled_root", default="")
    p.add_argument("--loc_ref_root", default="")
    p.add_argument("--anchor_root", default="")
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
    p.add_argument("--margin_1", type=float, default=0.1)
    p.add_argument("--margin_2", type=float, default=0.2)
    p.add_argument("--lam", type=float, default=0.5)
    p.add_argument("--alpha", type=float, default=0.8)
    p.add_argument("--beta", type=float, default=15.0)
    p.add_argument("--wfunction", default="exp", choices=["exp", "lin", "tanh"])
    p.add_argument("--sumfunction", default="ms", choices=["ms", "plain"])
    p.add_argument("--msmining", type=_bool_flag, default=False)
    p.add_argument("--fused_wms", type=_bool_flag, default=False,
                   help="the wms loss's forward through its fused kernel (K3 on CUDA); "
                        "LossConfig.fused_wms, which scl-tpu sets in code only")
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
    p.add_argument("--out_dim", type=int, default=512)
    p.add_argument("--loss_dim", type=int, default=512)
    p.add_argument("--reduction", default="none",
                   choices=["none", "1fc", "2fc", "3fc", "pca", "spp"])
    p.add_argument("--vlad_cores", type=int, default=64)
    p.add_argument("--L", type=int, default=3, help="spatial-pyramid levels of 'spp'")
    p.add_argument("--f", type=float, default=0.4,
                   help="the streaming PCAs' forgetting factor")
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
    p.add_argument("--steps_per_dispatch", type=int, default=1,
                   help="group K consecutive train steps into one dispatch: their batches "
                        "cross to the card in one transfer set (exact: K grouped steps are K "
                        "single steps)")
    p.add_argument("--task_id", type=int, default=0,
                   help="-1: render and submit an array job of this command (launch/jobs.py)")
    p.add_argument("--queue", default="48h")
    p.add_argument("--decoded_cache_root", default="",
                   help="dir of a decoded-uint8 image cache written by the cache command "
                        "(batch assembly becomes copies)")
    p.add_argument("--num_data_shards", type=int, default=0,
                   help="data-parallel ranks (0: the launcher's WORLD_SIZE, else one process)")
    p.add_argument("--async_mining", type=_bool_flag, default=False,
                   help="refresh the mining cache on a worker thread, training on the previous "
                        "window until the new one lands")


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
    p.add_argument("--quant_scales", default="",
                   help="JSON of int8 PTQ activation scales (the quant command's output): "
                        "serve with the int8 conv stack")
    p.add_argument("--device", default="cuda", help="torch device; 'cpu' only when asked")
    p.set_defaults(func=cmd_serve)

    p = sub.add_parser("quant", help="calibrate int8 PTQ activation scales")
    p.add_argument("--checkpoint", default="",
                   help="training-run directory, flagship-layout params npz or TF1 export npz")
    p.add_argument("--image_dir", required=True)
    p.add_argument("--num_images", type=int, default=32)
    p.add_argument("--out", required=True, help="output scales JSON")
    p.add_argument("--allow_random", action="store_true",
                   help="permit calibration without a checkpoint (smoke only)")
    p.add_argument("--vlad_cores", type=int, default=64)
    p.add_argument("--reduction", default="none")
    p.add_argument("--out_dim", type=int, default=512)
    p.add_argument("--device", default="cuda", help="torch device; 'cpu' only when asked")
    p.set_defaults(func=cmd_quant)

    p = sub.add_parser("bench", help="embedding-throughput benchmark")
    p.add_argument("--train", action="store_true",
                   help="the train-loop benchmark (bench_train.py) instead of the embed one")
    p.add_argument("--tuples_per_batch", type=int, default=BENCH_TRAIN_FLAGS["tuples_per_batch"])
    p.add_argument("--num_points", type=int, default=BENCH_TRAIN_FLAGS["num_points"])
    p.add_argument("--no_cache", action="store_true",
                   help="decode the images instead of reading the decoded-uint8 cache")
    p.add_argument("--steps_per_dispatch", type=int,
                   default=BENCH_TRAIN_FLAGS["steps_per_dispatch"],
                   help="train steps grouped into one dispatch (train/step.py::"
                        "build_train_step_scan)")
    p.add_argument("--async_mining", action="store_true",
                   help="refresh the mining cache on a worker thread")
    p.add_argument("--iters", type=int, default=0,
                   help="timed forwards per configuration (default: 120 int8, 30 bf16)")
    p.add_argument("--device", default="cuda", help="torch device; 'cpu' only when asked")
    p.set_defaults(func=cmd_bench)

    p = sub.add_parser("train", help="train the embedding network")
    _add_train_flags(p)
    p.add_argument("--device", default="cuda", help="torch device; 'cpu' only when asked")
    p.set_defaults(func=cmd_train)

    p = sub.add_parser("infer", help="batch descriptor extraction")
    p.add_argument("--set", required=True)
    p.add_argument("--csv_root", required=True)
    p.add_argument("--img_root", required=True)
    p.add_argument("--checkpoint", default="",
                   help="training-run directory, flagship-layout params npz or TF1 export npz "
                        "(default: the committed trained artifact)")
    p.add_argument("--out_name", default="model")
    p.add_argument("--out_root", default="lv")
    p.add_argument("--out_dim", type=int, default=512)
    p.add_argument("--reduction", default="none")
    p.add_argument("--vlad_cores", type=int, default=64)
    p.add_argument("--images_per_pass", type=int, default=32)
    p.add_argument("--dump_dtype", default="float32", choices=("float32", "float16"),
                   help="storage dtype of the feature dump; float16 halves it")
    p.add_argument("--device", default="cuda", help="torch device; 'cpu' only when asked")
    p.set_defaults(func=cmd_infer)

    p = sub.add_parser("topn", help="top-N retrieval sweep")
    p.add_argument("--pca_lv_pickle", required=True)
    p.add_argument("--ref_lv_pickle", required=True)
    p.add_argument("--query_lv_pickle", required=True)
    p.add_argument("--ref_csv", required=True)
    p.add_argument("--query_csv", required=True)
    p.add_argument("--out_root", default="top_n")
    p.add_argument("--N", type=int, default=25)
    p.add_argument("--dims", default="",
                   help="comma list, e.g. 64,256 (default: the full sweep, 64 to 4096)")
    p.add_argument("--spacings", default="", help="comma list, e.g. 0.0,1.0")
    p.add_argument("--device", default="cuda", help="torch device; 'cpu' only when asked")
    p.set_defaults(func=cmd_topn)

    p = sub.add_parser("roc", help="compile ROC figures")
    p.add_argument("--top_n_root", required=True)
    p.add_argument("--out_root", default="figs")
    p.add_argument("--l", default="0.0")
    p.add_argument("--d", type=int, default=256)
    p.add_argument("--queries", default="",
                   help="comma-separated query-set names to plot instead of the paper's five "
                        "conditions (evaluation/roc.py DEFAULT_QUERIES), e.g. 'toy_query'")
    p.set_defaults(func=cmd_roc)

    p = sub.add_parser("metrics", help="summarize/plot a run's JSONL metrics")
    p.add_argument("--run_dir", required=True)
    p.add_argument("--plot", action="store_true")
    p.add_argument("--tb-export", dest="tb_export", action="store_true",
                   help="write TensorBoard event files (run_dir/tb/{role}) from the JSONL metrics")
    p.set_defaults(func=cmd_metrics)

    p = sub.add_parser("cache", help="write the decoded-uint8 image cache (prep stage)")
    p.add_argument("--cache_dir", required=True)
    p.add_argument("--sets", default="train_ref,test_ref", help="comma list of set names to cache")
    p.add_argument("--cluster_sets", default="",
                   help="comma list of cluster eval sets as name:r, e.g. train_ref:5,test_ref:5")
    p.add_argument("--img_root", default="")
    p.add_argument("--shuffled_root", default="")
    p.add_argument("--anchor_root", default="")
    p.add_argument("--loc_ref_root", default="")
    p.add_argument("--toy_city", action="store_true")
    p.add_argument("--image_height", type=int, default=180)
    p.add_argument("--image_width", type=int, default=240)
    p.add_argument("--vlad_cores", type=int, default=64)
    p.add_argument("--num_workers", type=int, default=8)
    p.set_defaults(func=cmd_cache)

    p = sub.add_parser("prep", help="run the RobotCar ETL pipeline")
    p.add_argument("--root", required=True)
    p.add_argument("--raw_img_root", default="")
    p.add_argument("--ins_root", default="")
    p.add_argument("--tar_root", default="")
    p.add_argument("--img_root", default="")
    p.add_argument("--camera_models", default="")
    p.add_argument("--mask_root", default="")
    p.add_argument("--max_epochs", type=int, default=5)
    p.add_argument("--task_id", type=int, default=0,
                   help=">0: process only the task_id-th date (array jobs)")
    p.add_argument("--statistics", action="store_true",
                   help="also run stage 009 dataset statistics")
    p.add_argument("--tag_root", default="")
    p.add_argument("--device", default="cuda", help="torch device; 'cpu' only when asked")
    p.set_defaults(func=cmd_prep)

    p = sub.add_parser("parity", help="descriptor parity vs a converted reference TF1 checkpoint")
    p.add_argument("--checkpoint", required=True,
                   help="TF1 checkpoint export (.npz of {tf_name: array})")
    p.add_argument("--images", required=True,
                   help="image directory or newline-separated list file")
    p.add_argument("--golden", default=None,
                   help=".npz with reference 'descriptors' for the same images")
    p.add_argument("--out", default=None,
                   help="write our descriptors (.npz) for offline comparison")
    p.add_argument("--tolerance", type=float, default=1e-3,
                   help="max-abs descriptor tolerance for pass/fail")
    p.add_argument("--device", default="cuda", help="torch device; 'cpu' only when asked")
    p.set_defaults(func=cmd_parity)
    return parser


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
