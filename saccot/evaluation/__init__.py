from saccot.evaluation.metrics import (  # noqa: F401
    registration_error,
    is_registered,
    model_rmse,
    ate,
    registration_recall,
)
