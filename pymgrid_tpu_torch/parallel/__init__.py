from pymgrid_tpu_torch.parallel import distributed
from pymgrid_tpu_torch.parallel.batch import BatchedMicrogrid, make_batch_mesh
from pymgrid_tpu_torch.parallel.batched_env import BatchedContinuousEnv, BatchedDiscreteEnv
from pymgrid_tpu_torch.parallel.distributed import BatchMesh
from pymgrid_tpu_torch.parallel.suite import SuiteRunner, build_suite

__all__ = [
    "BatchedMicrogrid",
    "BatchedDiscreteEnv",
    "BatchedContinuousEnv",
    "BatchMesh",
    "SuiteRunner",
    "build_suite",
    "distributed",
    "make_batch_mesh",
]
