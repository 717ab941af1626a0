"""Experimental engine examples (the reference's examples/experimental),
the counterpart of ``predictionio_tpu/models/experimental``.

Port map, what is ported so far (reference project -> module here):

- scala-local-helloworld, java-local-helloworld, java-parallel-helloworld
  -> helloworld.py (a ``SimpleEngine``; host code)
- scala-local-regression, scala-parallel-regression, java-local-regression
  -> regression.py (OLS through the least-squares kernels, K22; served by
  ``tools.cli deploy`` from a model file of engine ``"regression"``)
- scala-parallel-similarproduct-dimsum -> similarproduct_dimsum.py (K19)
- scala-stock -> stock.py (indicators, regression + momentum strategies,
  walk-forward backtesting; the per-ticker regressions in one batched
  least-squares launch, K21; a synthetic panel stands in for
  YahooDataSource)
- scala-local-friend-recommendation + scala-parallel-friend-recommendation
  -> friend_recommendation.py (keyword similarity and random, host code;
  SimRank through K20a and K20b, ``ops/simrank.py``, over P's CSR; served
  by ``tools.cli deploy`` from a model file of engine ``"simrank"``)
- scala-parallel-recommendation-custom-datasource -> custom_datasource.py
  (a ``user::item::rate`` file DataSource on the recommendation template)
- scala-local-movielens-filtering -> movielens_filtering.py (``TempFilter``,
  which re-reads its blacklist file on every query)
- scala-refactor-test -> refactor_test.py (the vanilla DASE plumbing
  engine + the low-level ``VanillaEvaluator``; host code)
- scala-parallel-similarproduct-localmodel -> similarproduct_localmodel.py
  (trained on the card by the Similar Product ALS, then host dictionaries
  and numpy cosines)
- scala-recommendations -> standalone_recommendations.py (the file
  DataSource, ``PMatrixFactorizationModel`` persisting itself as an ``.npz``,
  bare ``[user, item]`` queries, ``run_standalone`` through ``Engine.train``)

Still to port: those that read the event store wait for ROADMAP.md queue 1
item 3 (mongo_datasource.py, movielens_evaluation.py,
recommendation_entitymap.py, trim_app.py), recommendation_cat.py for item 5.
"""
