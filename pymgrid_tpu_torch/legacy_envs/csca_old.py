"""Old continuous-state continuous-action legacy env.

Mirror of ``src/pymgrid/_deprecated/Environments/pymgrid_csca_old.py``: the
csda tuple action space, but mapped through the *continuous* action mapper
(on/off switches + normalized powers).
"""
from pymgrid_tpu_torch.legacy_envs.csda import MicroGridEnv as _CsdaEnv

__all__ = ["MicroGridEnv"]


class MicroGridEnv(_CsdaEnv):
    """Same action space as csda; continuous mapping
    (reference pymgrid_csca_old.py:38-40)."""

    def get_action(self, action):
        return self.get_action_continuous(action)
