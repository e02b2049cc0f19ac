from pymgrid_tpu_torch.forecast.forecaster import (
    Forecaster,
    GaussianNoiseForecaster,
    NoForecaster,
    OracleForecaster,
    UserDefinedForecaster,
    get_forecaster,
    vectorize_scalar_forecaster,
)

__all__ = [
    "vectorize_scalar_forecaster",
    "Forecaster",
    "GaussianNoiseForecaster",
    "NoForecaster",
    "OracleForecaster",
    "UserDefinedForecaster",
    "get_forecaster",
]
