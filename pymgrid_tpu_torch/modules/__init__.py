from pymgrid_tpu_torch.modules.base import BaseMicrogridModule, BaseTimeSeriesMicrogridModule
from pymgrid_tpu_torch.modules.battery import BatteryModule
from pymgrid_tpu_torch.modules.genset import GensetModule
from pymgrid_tpu_torch.modules.grid import GridModule
from pymgrid_tpu_torch.modules.load import LoadModule
from pymgrid_tpu_torch.modules.renewable import RenewableModule
from pymgrid_tpu_torch.modules.unbalanced import UnbalancedEnergyModule
from pymgrid_tpu_torch.modules.container import Container, ModuleContainer, ModuleList, get_subcontainers

__all__ = [
    "BaseMicrogridModule",
    "BaseTimeSeriesMicrogridModule",
    "BatteryModule",
    "GensetModule",
    "GridModule",
    "LoadModule",
    "RenewableModule",
    "UnbalancedEnergyModule",
    "Container",
    "ModuleContainer",
    "ModuleList",
    "get_subcontainers",
]
