"""Builds the configuration ``pymgrid25-s0-discrete-env`` on the device:
``BatchedDiscreteEnv`` over the port's ``DiscreteMicrogridEnv`` of pymgrid25
scenario 0, ``replicas`` of it (a traffic parameter), in float32, with
auto-reset and the env's own observation layout."""


def build(config, traffic, device):
    from pymgrid_tpu_torch.envs import DiscreteMicrogridEnv
    from pymgrid_tpu_torch.parallel import BatchedDiscreteEnv

    (scenario,) = config["scenarios"]
    return BatchedDiscreteEnv(DiscreteMicrogridEnv.from_scenario(scenario), traffic["replicas"],
                              config["dtype"], device, auto_reset=config["auto_reset"],
                              obs_layout=config["obs_layout"])
