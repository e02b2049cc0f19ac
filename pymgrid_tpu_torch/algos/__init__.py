from pymgrid_tpu_torch.algos.control import ControlOutput, HorizonOutput
from pymgrid_tpu_torch.algos.mpc import ModelPredictiveControl
from pymgrid_tpu_torch.algos.mpc_batched import BatchedMPC, ProblemTemplate
from pymgrid_tpu_torch.algos.mpc_suite import SuiteMPC
from pymgrid_tpu_torch.algos.priority_list import PriorityListAlgo, PriorityListElement
from pymgrid_tpu_torch.algos.rbc import RuleBasedControl
from pymgrid_tpu_torch.algos.saa_batched import BatchedSAA

__all__ = [
    "PriorityListAlgo",
    "PriorityListElement",
    "RuleBasedControl",
    "ModelPredictiveControl",
    "ControlOutput",
    "HorizonOutput",
    "ProblemTemplate",
    "BatchedMPC",
    "SuiteMPC",
    "BatchedSAA",
]
