from pymgrid_tpu_torch.envs.base import BaseMicrogridEnv
from pymgrid_tpu_torch.envs.discrete import DiscreteMicrogridEnv
from pymgrid_tpu_torch.envs.continuous import ContinuousMicrogridEnv

__all__ = ["BaseMicrogridEnv", "DiscreteMicrogridEnv", "ContinuousMicrogridEnv"]
