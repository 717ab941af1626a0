"""predictionio_tpu_torch: the PyTorch/CUDA port of predictionio_tpu.

The JAX package ``predictionio_tpu`` stays the reference; this package is
its counterpart for one NVIDIA Hopper GPU, slice by slice, and keeps the
reference's module names so each counterpart is easy to find. It imports
``torch``, numpy and the standard library only: never ``jax`` and never a
module of ``predictionio_tpu`` (what it needs from there it copies).

Slice 1 is recommendation serving: ``tools.cli deploy`` → engine server →
micro-batching executor → ``ALSAlgorithm.batch_predict`` →
``ALSModel.recommend_many`` → ``ServingFactors`` → the hand-written top-N
kernel ``ops.topn`` (``csrc/topn.cu``).

Slice 2 is recommendation training: ``ALSAlgorithm.train`` →
``ops.als.train_als`` (host packing in numpy) → a loop of two hand-written
kernels per half-step, ``ops.normal_eq`` (``csrc/normal_eq.cu``) and
``ops.spd_solve`` (``csrc/spd_solve.cu``) → ``ALSModel`` → ``save_model``;
``ops.als.rmse`` runs ``ops.predict_pairs`` (``csrc/predict_pairs.cu``).
"""
