"""Builds the configuration ``pymgrid25-rbc-suite`` on the device: the 25
pymgrid25 microgrids loaded by the port from the scenario files, normalised
onto one superset layout and stacked by ``SuiteRunner``, ``replicas`` per
config (a traffic parameter), in float32, drawing starts and restarts as
JAX's int32 draw."""


def build(config, traffic, device):
    import torch

    from pymgrid_tpu_torch import Microgrid
    from pymgrid_tpu_torch.parallel import SuiteRunner

    microgrids = [Microgrid.from_scenario(n) for n in config["scenarios"]]
    return SuiteRunner(microgrids, batch_per_config=traffic["replicas"], dtype=config["dtype"],
                       device=device, start_dtype=getattr(torch, config["start_dtype"]))
