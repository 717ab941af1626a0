"""e2 — the reusable evaluation and feature helpers of the port (the
counterpart of ``predictionio_tpu/e2``, reference e2/src/main/scala/io/
prediction/e2/): k-fold ``split_data`` and ``PropertiesToBinary``, both host
code.

The package's two device programs, ``CategoricalNaiveBayes`` (K17) and
``MarkovChain`` (K16), are not ported yet: they come with ROADMAP.md queue 1
item 9.
"""

from predictionio_tpu_torch.e2.evaluation import split_data  # noqa: F401
from predictionio_tpu_torch.e2.properties import PropertiesToBinary  # noqa: F401
