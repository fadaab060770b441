from walnuts_tpu_torch.models.targets import (
    funnel,
    logistic_regression,
    logistic_regression_data,
)

__all__ = ["funnel", "logistic_regression", "logistic_regression_data"]
