DEFAULT_HORIZON = 23

from pymgrid_tpu_torch.microgrid.microgrid import Microgrid
from pymgrid_tpu_torch.microgrid.step import MicrogridStep
from pymgrid_tpu_torch.microgrid import trajectory, reward_shaping

__all__ = ["Microgrid", "MicrogridStep", "DEFAULT_HORIZON", "trajectory", "reward_shaping"]
