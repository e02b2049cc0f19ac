"""Episode trajectory functions.

YAML-serializable callables ``(initial_step, final_step) -> (initial, final)``
invoked on every reset (reference: ``src/pymgrid/microgrid/trajectory/``).
"""
import inspect

import numpy as np
import yaml

from pymgrid_tpu_torch.utils.serialize import PymgridDumper, PymgridLoader

__all__ = [
    "BaseTrajectory",
    "DeterministicTrajectory",
    "StochasticTrajectory",
    "FixedLengthStochasticTrajectory",
]


class BaseTrajectory(yaml.YAMLObject):
    yaml_dumper = PymgridDumper
    yaml_loader = PymgridLoader

    def __getstate__(self):
        # Python 3.11+ object.__getstate__ returns None for empty instances,
        # which PyYAML's represent_yaml_object cannot handle
        return dict(self.__dict__)

    def __call__(self, initial_step, final_step):
        raise NotImplementedError

    def __repr__(self):
        ctor_params = inspect.signature(self.__init__).parameters
        rendered = ", ".join(f"{p}={getattr(self, p)}" for p in ctor_params)
        return f"{self.__class__.__name__}({rendered})"

    def __eq__(self, other):
        if type(self) != type(other):
            return NotImplemented
        return repr(self) == repr(other)


class FixedLengthStochasticTrajectory(BaseTrajectory):
    """Random start, fixed episode length."""

    yaml_tag = "!FixedLengthStochasticTrajectory"

    def __init__(self, trajectory_length):
        self.trajectory_length = trajectory_length

    def __call__(self, initial_step, final_step):
        span = final_step - initial_step
        if span < self.trajectory_length:
            raise ValueError(
                f"Cannot create a trajectory of length {self.trajectory_length}"
                f"between initial_step ({initial_step}) and final_step ({final_step})"
            )
        start = np.random.randint(initial_step, final_step - self.trajectory_length)
        return start, start + self.trajectory_length


class DeterministicTrajectory(BaseTrajectory):
    yaml_tag = "!DeterministicTrajectory"

    def __init__(self, initial_step, final_step):
        self.initial_step = initial_step
        self.final_step = final_step

    def __call__(self, initial_step, final_step):
        return self.initial_step, self.final_step


class StochasticTrajectory(BaseTrajectory):
    """Uniform random sub-episode of the available range."""

    yaml_tag = "!StochasticTrajectory"

    def __call__(self, initial_step, final_step):
        start = np.random.randint(initial_step, final_step - 2)
        stop = np.random.randint(start, final_step)
        return start, stop
