"""run_evaluation: the counterpart of ``CoreWorkflow.run_evaluation`` in
``predictionio_tpu/workflow/core_workflow.py`` (reference
core/.../workflow/CoreWorkflow.scala:96-152 and
EvaluationWorkflow.scala:31-42): the grid's engine evaluation, then the
evaluator.

The port has no metadata store yet (ROADMAP.md queue 1 item 3), so no
EvaluationInstance record is written: the result is returned, and the
evaluator writes its best variant's engine.json where it has an
``output_path``.
"""

from __future__ import annotations

import logging
from typing import Optional, Sequence

from predictionio_tpu_torch.controller.engine import Engine, EngineParams
from predictionio_tpu_torch.controller.evaluation import Evaluation
from predictionio_tpu_torch.workflow.context import WorkflowContext
from predictionio_tpu_torch.workflow.workflow_params import WorkflowParams

logger = logging.getLogger(__name__)


def _eval_engine(evaluation, engine_params_list, workflow_params):
    """The engine a grid evaluation runs through: a multi-variant grid
    upgrades a plain Engine to FastEvalEngine (stage results memoized
    across shared params prefixes, regularizer variants trained together
    by ``train_grid``); ``fast_eval=False`` keeps the plain engine."""
    engine = evaluation.engine
    if (
        workflow_params.fast_eval
        and type(engine) is Engine
        and len(engine_params_list) > 1
    ):
        from predictionio_tpu_torch.controller.fast_eval import FastEvalEngine

        engine = FastEvalEngine(
            engine.data_source_class_map,
            engine.preparator_class_map,
            engine.algorithm_class_map,
            engine.serving_class_map,
        )
    return engine


def run_evaluation(
    evaluation: Evaluation,
    engine_params_list: Sequence[EngineParams],
    ctx: Optional[WorkflowContext] = None,
    workflow_params: Optional[WorkflowParams] = None,
):
    """Evaluate a params grid and return the evaluator's result. The
    context's device runs the training and serving (a default context
    means CUDA, and raises without a card)."""
    workflow_params = workflow_params or WorkflowParams()
    engine_params_list = list(engine_params_list)  # may be a generator
    ctx = ctx or WorkflowContext()
    engine = _eval_engine(evaluation, engine_params_list, workflow_params)
    engine_eval_data_set = engine.batch_eval(ctx, engine_params_list, workflow_params)
    result = evaluation.evaluator.evaluate_base(
        ctx, evaluation, engine_eval_data_set, workflow_params
    )
    logger.info("run_evaluation: %s", result.to_one_liner())
    return result
