"""Builds the configuration ``pymgrid25-mpc-suite`` on the device: the
pymgrid25 microgrids loaded by the port from the scenario files and planned
by ``SuiteMPC``, every scenario's receding-horizon MPC as one batched
program, at the configuration's solver settings and dtype."""


def build(config, traffic, device):
    from pymgrid_tpu_torch import Microgrid
    from pymgrid_tpu_torch.algos import SuiteMPC

    microgrids = [Microgrid.from_scenario(n) for n in config["scenarios"]]
    mpc = SuiteMPC(microgrids, config["iters"], dtype=config["dtype"], device=device,
                   solver_kind=config["solver_kind"], newton_refine=config["newton_refine"],
                   matmul_precision=config["matmul_precision"], enum_bits=config["enum_bits"],
                   enum_chunk=config["enum_chunk"], enum_iters=config["enum_iters"],
                   repair_balance=config["repair_balance"])
    if mpc.horizon != config["horizon"]:
        raise ValueError(f"the scenarios plan {mpc.horizon} hours ahead, the configuration "
                         f"states {config['horizon']}")
    return mpc
