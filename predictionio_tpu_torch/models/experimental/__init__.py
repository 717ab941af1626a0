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

Still to port (ROADMAP.md queue 1 item 9): friend_recommendation.py
(SimRank, K20), custom_datasource.py, movielens_filtering.py,
refactor_test.py, similarproduct_localmodel.py and
standalone_recommendations.py; those that read the event store wait for
item 3 (mongo_datasource.py, movielens_evaluation.py,
recommendation_entitymap.py, trim_app.py), recommendation_cat.py for item 5.
"""
