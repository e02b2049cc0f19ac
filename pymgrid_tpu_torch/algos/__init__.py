from pymgrid_tpu_torch.algos.mpc_batched import BatchedMPC, ProblemTemplate
from pymgrid_tpu_torch.algos.mpc_suite import SuiteMPC
from pymgrid_tpu_torch.algos.rbc import RuleBasedControl
from pymgrid_tpu_torch.algos.saa_batched import BatchedSAA

__all__ = ["RuleBasedControl", "ProblemTemplate", "BatchedMPC", "SuiteMPC", "BatchedSAA"]
