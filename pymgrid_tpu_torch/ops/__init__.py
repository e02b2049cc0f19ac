"""Hand-written CUDA kernels of the port (sources in ``csrc/``)."""
from pymgrid_tpu_torch.ops.rbc_rollout import make_rbc_rollout, plain_rbc_rollout

__all__ = ["make_rbc_rollout", "plain_rbc_rollout"]
