"""Command line for the port: ``pio``-style ``deploy`` of a saved model
(the counterpart of ``predictionio_tpu/tools/cli.py cmd_deploy``).

    python -m predictionio_tpu_torch.tools.cli deploy --model model.npz \\
        [--ip localhost] [--port 8000] [--device cuda|cuda:N|cpu] \\
        [--serving-devices 0,1,...] \\
        [--max-batch 128] [--batch-window-ms 2.0] [--pipeline-depth 1] \\
        [--transport async|threaded]

It loads the model (``utils/serialize.py``), picks its engine from the
file (recommendation, similar product, DIMSUM similar product served by
``models/experimental/similarproduct_dimsum.py dimsum_engine``,
classification with the file's one algorithm, the OLS model of
``models/experimental/regression.py regression_engine``, or the SimRank
model of ``models/experimental/friend_recommendation.py simrank_engine``,
answering ``{"item1": a, "item2": b}`` with the score), prepares it on
the device (CUDA unless ``--device cpu``), warms the serving kernels and
serves ``POST /queries.json`` until ``GET /stop``. The served ``modelVersion`` is
the model file's name without its extension.

Where it serves: over the mesh of the CUDA indices ``--serving-devices``
names (an index may repeat: logical shards of one card); else on the one
device ``--device`` names with an index (``cuda:N``) or ``cpu``; else, for
the default ``--device cuda``, over every visible CUDA device, as the
reference serves over its default mesh (one card: the single-device
path). The recommendation and Similar Product templates serve over a mesh
(K3s; the row-sharded retriever and its merge, K9s/K10s/K9m; K14s); the
other engines serve on the mesh's first device.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Optional, Sequence, Union

import numpy as np

import torch

from predictionio_tpu_torch.api.engine_server import (
    DeployedEngine,
    EngineServer,
    ServerConfig,
    _mesh_from_device_spec,
    create_server,
)
from predictionio_tpu_torch.controller.engine import EngineParams
from predictionio_tpu_torch.controller.params import EmptyParams
from predictionio_tpu_torch.device import DeviceLike, resolve_device
from predictionio_tpu_torch.models.classification import engine as clf
from predictionio_tpu_torch.models.experimental import friend_recommendation as fr
from predictionio_tpu_torch.models.experimental.regression import regression_engine
from predictionio_tpu_torch.models.experimental.similarproduct_dimsum import dimsum_engine
from predictionio_tpu_torch.models.recommendation import engine as rec
from predictionio_tpu_torch.models.similarproduct import engine as sp
from predictionio_tpu_torch.parallel.mesh import Mesh, default_mesh
from predictionio_tpu_torch.utils.serialize import load_model


def serving_target(
    config: ServerConfig, device: DeviceLike = None, mesh: Optional[Mesh] = None
) -> Union[torch.device, Mesh]:
    """Where a deployment serves (see the module doc): ``mesh``, else the
    mesh ``config.serving_devices`` names, else ``device`` when it names
    one device, else every visible CUDA device (``default_mesh``)."""
    if mesh is not None:
        return mesh
    if config.serving_devices:
        return _mesh_from_device_spec(config.serving_devices)
    if device is not None and str(device) != "cuda":
        return resolve_device(device)
    return default_mesh()


def deploy_model_file(
    model_path: str, config: ServerConfig, device: DeviceLike = None,
    mesh: Optional[Mesh] = None,
) -> EngineServer:
    """Load, prepare and warm the model at ``model_path`` where
    ``serving_target`` says (``mesh`` for a library caller, the config's
    ``serving_devices``, or ``device``) and bind a server for it (not yet
    serving)."""
    target = serving_target(config, device, mesh)
    model = load_model(model_path)
    data_source = ""  # the engine's only data source, where it has one
    if isinstance(model, fr.SimRankModel):
        name, engine, default = "simrank", fr.simrank_engine(), fr.SimRankParams
        data_source = "default"
    elif isinstance(model, np.ndarray):
        name, engine, default = "ols", regression_engine(), EmptyParams
    elif isinstance(model, clf.NaiveBayesModelArrays):
        name, engine, default = "naive", clf.classification_engine(), clf.NaiveBayesAlgorithmParams
    elif isinstance(model, clf.LogisticRegressionModel):
        name, engine, default = (
            "logisticregression", clf.classification_engine(),
            clf.LogisticRegressionAlgorithmParams,
        )
    elif isinstance(model, sp.DIMSUMModel):
        name, engine, default = "dimsum", dimsum_engine(), sp.DIMSUMAlgorithmParams
    elif isinstance(model, sp.SPModel):
        name, engine, default = "als", sp.similarproduct_engine(), sp.ALSAlgorithmParams
    else:
        name, engine, default = "als", rec.recommendation_engine(), rec.ALSAlgorithmParams
    params = getattr(model, "params", None)
    params = params if params is not None else default()
    engine_params = EngineParams(
        data_source_params=(data_source, EmptyParams()),
        algorithm_params_list=((name, params),),
    )
    models = engine.prepare_deploy(target, engine_params, [model])
    version = os.path.splitext(os.path.basename(model_path))[0]
    deployed = DeployedEngine(engine, engine_params, models, version=version)
    return create_server(deployed, config)


def cmd_deploy(args) -> int:
    config = ServerConfig(
        ip=args.ip,
        port=args.port,
        batch_window_ms=args.batch_window_ms,
        max_batch=args.max_batch,
        pipeline_depth=args.pipeline_depth,
        transport=args.transport,
        serving_devices=args.serving_devices,
    )
    server = deploy_model_file(args.model, config, device=args.device)
    print(f"Engine server serving on {args.ip}:{server.port}", flush=True)
    server.serve_forever()
    server.wait_stopped(timeout=30.0)
    return 0


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="predictionio_tpu_torch.tools.cli",
        description="Serve PredictionIO engines with PyTorch on a GPU.",
    )
    sub = parser.add_subparsers(dest="command", required=True)
    deploy = sub.add_parser("deploy", help="start the engine query server")
    deploy.add_argument("--model", required=True, help="model file (.npz)")
    deploy.add_argument("--ip", default="localhost")
    deploy.add_argument("--port", type=int, default=8000)
    deploy.add_argument(
        "--device", default="cuda",
        help="'cuda' (default: every visible CUDA device; fails when none is "
        "present), 'cuda:N' or 'cpu'",
    )
    deploy.add_argument(
        "--serving-devices", default=None,
        help="comma-separated CUDA device indices to shard serving over "
        "(e.g. '0,1'; an index may repeat); overrides --device",
    )
    deploy.add_argument(
        "--batch-window-ms", type=float, default=2.0,
        help="micro-batching window for concurrent queries",
    )
    deploy.add_argument(
        "--max-batch", type=int, default=128,
        help="max queries per device batch",
    )
    deploy.add_argument(
        "--pipeline-depth", type=int, default=1,
        help="batches in flight at once (1 = strictly serial serving)",
    )
    deploy.add_argument(
        "--transport", choices=("async", "threaded"), default="async",
        help="REST frontend: 'async' event loop or 'threaded' "
        "thread-per-connection",
    )
    deploy.set_defaults(func=cmd_deploy)
    return parser


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
