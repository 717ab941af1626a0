from predictionio_tpu_torch.models.classification.engine import (  # noqa: F401
    ClassificationEngineFactory,
    classification_engine,
)
