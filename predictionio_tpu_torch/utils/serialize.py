"""Model files for the port: ``save_model``/``load_model``.

An ALS model is saved as one ``.npz``: the factor matrices, the user and
item ids in row order, and the algorithm params as JSON. Loading never
unpickles (``allow_pickle=False``): a pickled JAX-package model would
import ``predictionio_tpu`` classes, so models cross from the JAX package
as arrays (``models.recommendation.engine.als_model_from_numpy``).
"""

from __future__ import annotations

import json
import os
from typing import Union

import numpy as np

from predictionio_tpu_torch.controller.params import (
    params_from_json,
    params_to_json,
)
from predictionio_tpu_torch.models.recommendation.engine import (
    ALSAlgorithmParams,
    ALSModel,
    als_model_from_numpy,
)

PathLike = Union[str, os.PathLike]


def save_model(path: PathLike, model: ALSModel) -> None:
    """Write ``model`` to ``path`` (an ``.npz``)."""
    user_ids = _ids_in_row_order(model.user_index)
    item_ids = _ids_in_row_order(model.item_index)
    params = None if model.params is None else params_to_json(model.params)
    with open(path, "wb") as f:
        np.savez(
            f,
            user_factors=np.asarray(model.arrays.user_factors, np.float32),
            item_factors=np.asarray(model.arrays.item_factors, np.float32),
            user_ids=np.asarray(user_ids, dtype=str),
            item_ids=np.asarray(item_ids, dtype=str),
            params_json=np.asarray(json.dumps(params)),
        )


def _ids_in_row_order(index) -> list:
    ids = [None] * len(index)
    for key, row in index.items():
        if not 0 <= row < len(ids) or ids[row] is not None:
            raise ValueError(f"index rows are not 0..{len(ids) - 1}")
        ids[row] = key
    return ids


def load_model(path: PathLike) -> ALSModel:
    """Read a model written by ``save_model``."""
    with np.load(path, allow_pickle=False) as z:
        params = json.loads(str(z["params_json"]))
        return als_model_from_numpy(
            z["user_factors"],
            z["item_factors"],
            z["user_ids"].tolist(),
            z["item_ids"].tolist(),
            params=(
                None if params is None
                else params_from_json(params, ALSAlgorithmParams)
            ),
        )
