"""Legacy gym-style environments over the nonmodular microgrid.

Mirror of ``src/pymgrid/_deprecated/Environments/`` (which is broken as
shipped — it imports the nonexistent ``pymgrid.Environments`` package).
Superseded by :mod:`pymgrid_tpu_torch.envs`; kept for drop-in compatibility with
pre-1.0 pymgrid RL code.
"""
from pymgrid_tpu_torch.legacy_envs.environment import DEFAULT_CONFIG, Environment
from pymgrid_tpu_torch.legacy_envs.cspla import MicroGridEnv as CsplaMicroGridEnv
from pymgrid_tpu_torch.legacy_envs.csda import MicroGridEnv as CsdaMicroGridEnv
from pymgrid_tpu_torch.legacy_envs.csca_old import MicroGridEnv as CscaOldMicroGridEnv
from pymgrid_tpu_torch.legacy_envs.csca import (
    ContinuousMicrogridEnv,
    ContinuousMicrogridSampleEnv,
    MicrogridEnv,
    SafeExpMicrogridEnv,
    SafeExpMicrogridSampleEnv,
)
from pymgrid_tpu_torch.legacy_envs.preprocessing import (
    normalize_environment_states,
    sample_reset,
)

__all__ = [
    "DEFAULT_CONFIG",
    "Environment",
    "CsplaMicroGridEnv",
    "CsdaMicroGridEnv",
    "CscaOldMicroGridEnv",
    "MicrogridEnv",
    "ContinuousMicrogridEnv",
    "ContinuousMicrogridSampleEnv",
    "SafeExpMicrogridEnv",
    "SafeExpMicrogridSampleEnv",
    "normalize_environment_states",
    "sample_reset",
]
