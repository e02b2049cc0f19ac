"""Nonmodular <-> modular conversion (reference: ``src/pymgrid/convert/``).

``to_modular`` wraps each legacy architecture component in the corresponding
module (time-series modules get an oracle forecaster with
``horizon = nonmodular.horizon - 1``); ``to_nonmodular`` requires exactly one
module of each type and rebuilds the legacy parameter record.
"""
from pymgrid_tpu_torch.convert.get_module import get_module
from pymgrid_tpu_torch.convert.to_nonmodular_ops import (
    add_params_from_module,
    check_viability,
    finalize_params,
    get_empty_params,
)

__all__ = ["to_modular", "to_nonmodular"]


def to_modular(nonmodular, raise_errors=False):
    from pymgrid_tpu_torch.microgrid import Microgrid

    component_names = ["load", "unbalanced_energy"]
    component_names += [c for c, present in nonmodular.architecture.items() if present]

    named_modules = [
        (name, get_module(name, nonmodular, raise_errors)) for name in component_names
    ]
    return Microgrid(named_modules, add_unbalanced_module=False)


def to_nonmodular(modular):
    from pymgrid_tpu_torch.nonmodular import NonModularMicrogrid

    check_viability(modular)
    leading_modules = [ml[0] for _, ml in modular.modules.iterdict()]

    record = get_empty_params()
    for module in leading_modules:
        add_params_from_module(module, record)
    finalize_params(record)

    legacy_horizon = modular.get_forecast_horizon() + 1
    return NonModularMicrogrid(parameters=record, horizon=legacy_horizon)
