from walnuts_tpu_torch.models.targets import (
    funnel,
    ill_conditioned_normal,
    logistic_regression,
    logistic_regression_data,
    std_normal,
)

__all__ = [
    "funnel",
    "ill_conditioned_normal",
    "logistic_regression",
    "logistic_regression_data",
    "std_normal",
]
