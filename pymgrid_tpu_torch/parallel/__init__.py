from pymgrid_tpu_torch.parallel.batch import BatchedMicrogrid
from pymgrid_tpu_torch.parallel.batched_env import BatchedContinuousEnv, BatchedDiscreteEnv
from pymgrid_tpu_torch.parallel.suite import SuiteRunner, build_suite

__all__ = [
    "BatchedMicrogrid",
    "BatchedDiscreteEnv",
    "BatchedContinuousEnv",
    "SuiteRunner",
    "build_suite",
]
