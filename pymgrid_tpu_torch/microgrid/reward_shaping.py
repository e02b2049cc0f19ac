"""Reward shapers.

YAML-tagged callables ``(step_info, cost_info) -> float`` that replace the
summed module reward (reference: ``src/pymgrid/microgrid/reward_shaping/``).
"""
import numpy as np
import yaml

from pymgrid_tpu_torch.utils.serialize import PymgridDumper, PymgridLoader

__all__ = ["BaseRewardShaper", "PVCurtailmentShaper", "BatteryDischargeShaper"]


class BaseRewardShaper(yaml.YAMLObject):
    yaml_dumper = PymgridDumper
    yaml_loader = PymgridLoader

    def __getstate__(self):
        # Python 3.11+ object.__getstate__ returns None for empty instances,
        # which PyYAML's represent_yaml_object cannot handle
        return dict(self.__dict__)

    @staticmethod
    def sum_module_val(info, module_name, module_attr):
        # missing module or missing field both count as zero
        try:
            return sum(entry[module_attr] for entry in info[module_name])
        except KeyError:
            return 0.0

    def __call__(self, step_info, cost_info):
        raise NotImplementedError

    def __repr__(self):
        return f"{self.__class__.__name__}()"


class BatteryDischargeShaper(BaseRewardShaper):
    """Shaped reward = (battery discharge - loss load) / load, in [-1, 1]."""

    yaml_tag = "!BatteryDischargeShaper"

    def __call__(self, step_info, cost_info):
        discharge = self.sum_module_val(step_info, "battery", "provided_energy")
        shortfall = self.sum_module_val(step_info, "unbalanced_energy", "provided_energy")
        demand = self.sum_module_val(step_info, "load", "absorbed_energy")
        try:
            fraction = (discharge - shortfall) / demand
        except ZeroDivisionError:
            return 0.0
        assert (
            -1 <= fraction <= 1
            or np.isclose(fraction, 1)
            or np.isclose(fraction, 0)
        )
        return fraction


class PVCurtailmentShaper(BaseRewardShaper):
    """Shaped reward = negative total PV curtailment (module named ``pv``)."""

    yaml_tag = "!PVCurtailmentShaper"

    def __call__(self, step_info, cost_info):
        return -1.0 * self.sum_module_val(step_info, "pv", "curtailment")
