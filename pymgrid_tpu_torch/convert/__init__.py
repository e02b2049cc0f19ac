from pymgrid_tpu_torch.convert.convert import to_modular, to_nonmodular
from pymgrid_tpu_torch.convert.get_module import get_module
from pymgrid_tpu_torch.convert.to_nonmodular_ops import (
    add_params_from_module,
    check_viability,
    finalize_params,
    get_empty_params,
)

__all__ = [
    "to_modular",
    "to_nonmodular",
    "get_module",
    "check_viability",
    "get_empty_params",
    "finalize_params",
    "add_params_from_module",
]
