from walnuts_tpu_torch.models.targets import (
    ar1_normal,
    condition_gaussian,
    eight_schools,
    funnel,
    ill_conditioned_normal,
    logistic_regression,
    logistic_regression_data,
    std_normal,
    stochastic_volatility,
    stochastic_volatility_data,
)

__all__ = [
    "ar1_normal",
    "condition_gaussian",
    "eight_schools",
    "funnel",
    "ill_conditioned_normal",
    "logistic_regression",
    "logistic_regression_data",
    "std_normal",
    "stochastic_volatility",
    "stochastic_volatility_data",
]
