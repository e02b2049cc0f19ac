"""Utilities of the port: the host layer's logger, spaces and YAML
serialization, and state checkpoints (:mod:`pymgrid_tpu_torch.utils.checkpoint`)."""
from pymgrid_tpu_torch.utils.logger import ModularLogger
from pymgrid_tpu_torch.utils.serialize import add_pymgrid_yaml_representers
from pymgrid_tpu_torch.utils.space import Box, ModuleSpace, MicrogridSpace

__all__ = [
    "ModularLogger",
    "Box",
    "ModuleSpace",
    "MicrogridSpace",
    "add_pymgrid_yaml_representers",
]
