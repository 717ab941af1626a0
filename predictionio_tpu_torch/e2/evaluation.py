"""k-fold cross-validation splitting: the port's copy of
``predictionio_tpu/e2/evaluation.py``.

Capability parity with the reference CommonHelperFunctions.splitData
(e2/src/main/scala/io/prediction/e2/evaluation/CrossValidation.scala:21-64):
point index modulo evalK selects the held-out fold; every other point
trains. Fold membership is positional (zipWithIndex in the reference),
so splits are deterministic for a given dataset order.
"""

from __future__ import annotations

from typing import Callable, List, Sequence, Tuple, TypeVar

D = TypeVar("D")
TD = TypeVar("TD")
EI = TypeVar("EI")
Q = TypeVar("Q")
A = TypeVar("A")


def split_data(
    eval_k: int,
    dataset: Sequence[D],
    evaluator_info: EI,
    training_data_creator: Callable[[List[D]], TD],
    query_creator: Callable[[D], Q],
    actual_creator: Callable[[D], A],
) -> List[Tuple[TD, EI, List[Tuple[Q, A]]]]:
    """``eval_k`` folds of (training data, ``evaluator_info``, [(query,
    actual)]): fold f holds out the points at positions i with
    ``i % eval_k == f``."""
    if eval_k < 1:
        raise ValueError("eval_k must be >= 1")
    out = []
    for fold in range(eval_k):
        training = [d for i, d in enumerate(dataset) if i % eval_k != fold]
        testing = [d for i, d in enumerate(dataset) if i % eval_k == fold]
        out.append(
            (
                training_data_creator(training),
                evaluator_info,
                [(query_creator(d), actual_creator(d)) for d in testing],
            )
        )
    return out
