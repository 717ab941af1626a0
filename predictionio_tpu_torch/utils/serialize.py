"""Model files for the port: ``save_model``/``load_model``.

A model is saved as one ``.npz`` whose ``engine`` field names its engine:

- ``"recommendation"`` (the default when the field is absent, as in the
  files of the first slices): an ALS model's factor matrices, the user and
  item ids in row order, and the algorithm params as JSON;
- ``"similarproduct"``: the item factors, the item ids in row order, each
  item's categories (JSON, in row order) and the params as JSON;
- ``"dimsum"``: a DIMSUM model's item-item similarities, the item ids in
  row order, each item's categories and the params as JSON;
- ``"classification"``, with ``algorithm`` ``"naive"`` (``pi``, ``theta``
  and the class ``labels`` of a naive Bayes model) or
  ``"logisticregression"`` (``weights``, ``bias`` and ``labels``); these
  models carry no params;
- ``"regression"``: an OLS model of ``models/experimental/regression.py``,
  its coefficient vector (a 1-D float array is saved as one), no params;
- ``"simrank"``: a SimRank model of
  ``models/experimental/friend_recommendation.py``, its [n, n] float32
  ``scores``, no params.

Loading never unpickles (``allow_pickle=False``): a pickled JAX-package
model would import ``predictionio_tpu`` classes, so models cross from the
JAX package as arrays (``als_model_from_numpy``, ``sp_model_from_numpy``,
``dimsum_model_from_numpy``, ``nb_model_from_numpy``,
``lr_model_from_numpy``, ``simrank_model_from_numpy``; an OLS model is its
coefficient array already).
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
from predictionio_tpu_torch.models.classification import engine as clf
from predictionio_tpu_torch.models.experimental import friend_recommendation as fr
from predictionio_tpu_torch.models.recommendation import engine as rec
from predictionio_tpu_torch.models.similarproduct import engine as sp

PathLike = Union[str, os.PathLike]
Model = Union[
    rec.ALSModel, sp.SPModel, sp.DIMSUMModel, clf.NaiveBayesModelArrays,
    clf.LogisticRegressionModel, fr.SimRankModel, np.ndarray,
]


def save_model(path: PathLike, model: Model) -> None:
    """Write ``model`` to ``path`` (an ``.npz``)."""
    if isinstance(model, np.ndarray):
        if model.ndim != 1 or model.dtype.kind != "f":
            raise ValueError(
                f"an OLS model is a 1-D float coefficient array, got {model.dtype} "
                f"{model.shape}"
            )
        with open(path, "wb") as f:
            np.savez(f, engine=np.asarray("regression"),
                     coefficients=np.asarray(model, np.float32))
        return
    if isinstance(model, (clf.NaiveBayesModelArrays, clf.LogisticRegressionModel)):
        _save_classification(path, model)
        return
    if isinstance(model, fr.SimRankModel):
        with open(path, "wb") as f:
            np.savez(f, engine=np.asarray("simrank"),
                     scores=np.asarray(model.scores, np.float32))
        return
    params = None if model.params is None else params_to_json(model.params)
    item_ids = _ids_in_row_order(model.item_index)
    if isinstance(model, (sp.SPModel, sp.DIMSUMModel)):
        categories = [
            list(model.items.get(r, sp.Item()).categories)
            for r in range(len(item_ids))
        ]
        arrays = {"item_categories_json": np.asarray(json.dumps(categories))}
        if isinstance(model, sp.SPModel):
            arrays.update(
                engine=np.asarray("similarproduct"),
                item_factors=np.asarray(model.item_factors, np.float32),
            )
        else:
            arrays.update(
                engine=np.asarray("dimsum"),
                similarities=np.asarray(model.similarities, np.float32),
            )
    else:
        arrays = {
            "engine": np.asarray("recommendation"),
            "user_factors": np.asarray(model.arrays.user_factors, np.float32),
            "item_factors": np.asarray(model.arrays.item_factors, np.float32),
            "user_ids": np.asarray(_ids_in_row_order(model.user_index), dtype=str),
        }
    with open(path, "wb") as f:
        np.savez(
            f,
            item_ids=np.asarray(item_ids, dtype=str),
            params_json=np.asarray(json.dumps(params)),
            **arrays,
        )


def _save_classification(path: PathLike, model) -> None:
    labels = np.asarray(model.labels)
    if labels.dtype.kind not in "biuf":
        raise ValueError(f"class labels must be numbers, got dtype {labels.dtype}")
    if isinstance(model, clf.NaiveBayesModelArrays):
        arrays = {"algorithm": np.asarray("naive"),
                  "pi": np.asarray(model.pi, np.float32),
                  "theta": np.asarray(model.theta, np.float32)}
    else:
        arrays = {"algorithm": np.asarray("logisticregression"),
                  "weights": np.asarray(model.weights, np.float32),
                  "bias": np.asarray(model.bias, np.float32)}
    with open(path, "wb") as f:
        np.savez(f, engine=np.asarray("classification"), labels=labels, **arrays)


def _ids_in_row_order(index) -> list:
    ids = [None] * len(index)
    for key, row in index.items():
        if not 0 <= row < len(ids) or ids[row] is not None:
            raise ValueError(f"index rows are not 0..{len(ids) - 1}")
        ids[row] = key
    return ids


def load_model(path: PathLike) -> Model:
    """Read a model written by ``save_model``."""
    with np.load(path, allow_pickle=False) as z:
        engine = str(z["engine"]) if "engine" in z.files else "recommendation"
        if engine == "regression":
            return np.asarray(z["coefficients"], np.float32)
        if engine == "simrank":
            return fr.simrank_model_from_numpy(z["scores"])
        if engine == "classification":
            algorithm = str(z["algorithm"])
            if algorithm == "naive":
                # the deploy binds the device (NaiveBayesAlgorithm.prepare_serving)
                return clf.NaiveBayesModelArrays(
                    pi=z["pi"], theta=z["theta"], labels=z["labels"])
            if algorithm == "logisticregression":
                return clf.lr_model_from_numpy(z["weights"], z["bias"], z["labels"])
            raise ValueError(f"{path}: unknown classification algorithm {algorithm!r}")
        params = json.loads(str(z["params_json"]))
        if engine == "similarproduct":
            return sp.sp_model_from_numpy(
                z["item_factors"],
                z["item_ids"].tolist(),
                json.loads(str(z["item_categories_json"])),
                params=(
                    None if params is None
                    else params_from_json(params, sp.ALSAlgorithmParams)
                ),
            )
        if engine == "dimsum":
            return sp.dimsum_model_from_numpy(
                z["similarities"],
                z["item_ids"].tolist(),
                json.loads(str(z["item_categories_json"])),
                params=(
                    None if params is None
                    else params_from_json(params, sp.DIMSUMAlgorithmParams)
                ),
            )
        if engine != "recommendation":
            raise ValueError(f"{path}: unknown engine {engine!r}")
        return rec.als_model_from_numpy(
            z["user_factors"],
            z["item_factors"],
            z["user_ids"].tolist(),
            z["item_ids"].tolist(),
            params=(
                None if params is None
                else params_from_json(params, rec.ALSAlgorithmParams)
            ),
        )
