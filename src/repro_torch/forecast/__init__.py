"""Predictive repartitioning: arrival forecasting + model-predictive control.

The port's own copy of ``repro.forecast``:

* :mod:`repro_torch.forecast.forecaster` — a diurnal Fourier day-model fitted
  by least squares on a registered scenario's arrival stream
  (:func:`fit_scenario_forecaster`), corrected online by an EWMA bias tracker;
* :mod:`repro_torch.forecast.policy` — :class:`ForecastPolicy`, the MPC
  repartitioning controller registered as ``"forecast"`` in
  :data:`repro_torch.sweep.cells.POLICIES`, the controller the DQN is raced
  against.

All of it is float64 host code; the fleet factory is not copied.
"""

from repro_torch.forecast.forecaster import (
    ArrivalForecaster,
    EWMABiasTracker,
    FourierDayModel,
    fit_fourier_day_model,
    fit_scenario_forecaster,
)
from repro_torch.forecast.policy import (
    EFFECTIVE_THROUGHPUT,
    ForecastPolicy,
    expected_throughput,
)

__all__ = [
    "ArrivalForecaster",
    "EWMABiasTracker",
    "FourierDayModel",
    "fit_fourier_day_model",
    "fit_scenario_forecaster",
    "EFFECTIVE_THROUGHPUT",
    "ForecastPolicy",
    "expected_throughput",
]
