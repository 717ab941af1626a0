"""WorkflowParams: the fields training and evaluation read, from
``predictionio_tpu/workflow/workflow_params.py`` (reference
core/.../workflow/WorkflowParams.scala:27-42)."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class WorkflowParams:
    # training's debug switches (Engine.train): skip the data checks, stop
    # after the data source, stop after the preparator
    skip_sanity_check: bool = False
    stop_after_read: bool = False
    stop_after_prepare: bool = False
    # concurrent workers over the grid's variants (the reference's `.par`
    # over param sets, MetricEvaluator.scala:221-230); <= 1 runs serially
    eval_parallelism: int = 4
    # variants differing only in an algorithm's GRID_AXES train together
    # (BaseAlgorithm.train_grid): "auto" on a CUDA device, not on the CPU
    # (as the reference's "auto" skips its CPU backend); "always" and
    # "never" force it either way
    grid_train: str = "auto"
    # a multi-variant evaluation runs through FastEvalEngine (stage
    # memoization and the grid path); its caches hold every variant's
    # models and served results for the sweep
    fast_eval: bool = True

    def __post_init__(self):
        if self.grid_train not in ("auto", "always", "never"):
            raise ValueError(
                f"grid_train must be auto/always/never, got {self.grid_train!r}"
            )
