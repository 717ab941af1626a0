"""e2 — the reusable engine library of the port (the counterpart of
``predictionio_tpu/e2``, reference e2/src/main/scala/io/prediction/e2/):
k-fold ``split_data`` and ``PropertiesToBinary`` (host code);
``CategoricalNaiveBayes`` with its model (K17a counts, K17b scores and
argmax on the device: ``ops/categorical_nb.py``); ``MarkovChain`` with its
model (K16, one step on the device: ``ops/markov.py``). The models carry
the device they predict on; ``categorical_nb_model_from_numpy`` and
``markov_model_from_numpy`` carry trained models' arrays across.
"""

from predictionio_tpu_torch.e2.evaluation import split_data  # noqa: F401
from predictionio_tpu_torch.e2.markov_chain import (  # noqa: F401
    MarkovChain,
    MarkovChainModel,
    markov_model_from_numpy,
)
from predictionio_tpu_torch.e2.naive_bayes import (  # noqa: F401
    CategoricalNaiveBayes,
    CategoricalNaiveBayesModel,
    LabeledPoint,
    categorical_nb_model_from_numpy,
)
from predictionio_tpu_torch.e2.properties import PropertiesToBinary  # noqa: F401
