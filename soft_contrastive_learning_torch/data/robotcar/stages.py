"""Typed, idempotent stage framework for the RobotCar ETL pipeline. Own copy
of ``soft_contrastive_learning_tpu/data/robotcar/stages.py``.

The reference implements its data prep as 14 numbered scripts coordinated only
by filesystem contracts and skip-if-output-exists checks (SURVEY.md §3.5 DAG,
§5 failure handling). This framework makes that structure explicit: each
Stage declares its outputs, ``run_all`` executes stages in order and skips
complete ones, and a crashed run is simply re-executed (same recovery model
as the reference's resubmitted SGE array jobs).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Sequence


@dataclass
class PrepContext:
    """Filesystem roots shared by all stages (the reference's per-script
    --*_root flags, unified)."""

    root: str  # base output dir; stage dirs are created under it
    raw_img_root: str = ""  # raw camera tars / extracted raw images
    ins_root: str = ""  # per-date INS/GPS csvs
    tar_root: str = ""  # raw image tar archives
    img_root: str = ""  # downsized image output
    camera_models: str = ""  # robotcar-sdk camera model dir (optional)
    max_side: int = 240
    max_epochs: int = 5
    folds: Sequence[str] = ("train", "val", "test")
    ref_dates: Dict[str, str] = field(
        default_factory=lambda: {
            # reference prepare_data/005_parametrize_path.py:186-188
            "train": "2014-12-02-15-30-08",
            "test": "2014-12-02-15-30-08",
            "val": "2014-05-14-13-50-20",
        }
    )
    query_dates: Sequence[str] = (
        # reference prepare_data/007_set_aside_queries.py:36-42
        "2015-08-14-14-54-57",  # roadworks, overcast
        "2014-11-18-13-20-12",  # sun, clouds
        "2014-12-17-18-18-43",  # night, rain
        "2015-02-03-08-45-10",  # snow
        "2014-06-26-09-24-58",  # overcast, alternate-route
    )
    bad_dates: Sequence[str] = (
        # reference prepare_data/004_merge_and_clean.py:11-21
        "2014-06-25-16-45-34", "2014-08-11-10-49-42", "2014-08-11-10-59-18",
        "2014-11-14-16-34-33", "2015-05-26-13-59-22", "2015-05-29-09-36-29",
        "2015-08-04-09-12-27", "2015-08-27-10-06-57", "2015-08-27-16-07-13",
    )
    grid_masks: Dict[str, str] = field(default_factory=dict)  # fold -> mask png
    make_plots: bool = False
    train_ref_r: int = 1
    eval_ref_r: int = 5
    cluster_r: int = 5

    def dir(self, name: str) -> str:
        path = os.path.join(self.root, name)
        os.makedirs(path, exist_ok=True)
        return path


@dataclass
class Stage:
    name: str
    run: Callable[[PrepContext], None]
    outputs: Callable[[PrepContext], List[str]]

    def is_complete(self, ctx: PrepContext) -> bool:
        outs = self.outputs(ctx)
        return bool(outs) and all(os.path.exists(p) for p in outs)


def run_all(
    stages: Sequence[Stage], ctx: PrepContext, force: bool = False,
    log: Callable[[str], None] = print,
) -> List[str]:
    """Run stages in order, skipping complete ones. Returns names executed."""
    executed = []
    for stage in stages:
        if not force and stage.is_complete(ctx):
            log(f"[prep] {stage.name}: complete, skipping")
            continue
        log(f"[prep] {stage.name}: running")
        stage.run(ctx)
        executed.append(stage.name)
    return executed
