"""Tests that need a CUDA card: the port's CUDA kernels against their plain
PyTorch versions.  They skip without a card; on a machine with one, run
``python -m pytest tests/test_torch_cuda.py -m cuda``.  This file imports
nothing of JAX or the JAX package, so it runs where only the port is
installed."""
import numpy as np
import pytest
import torch

from pymgrid_tpu_torch import Microgrid
from pymgrid_tpu_torch.core.spec import extract_spec
from pymgrid_tpu_torch.ops import make_rbc_rollout

pytestmark = pytest.mark.cuda

torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("scenario", [0, 1])
def test_rbc_rollout_kernel_matches_plain(cuda, scenario):
    n_steps, B = 500, 3000  # B not a multiple of the block: the ragged tail
    spec, params, _ = extract_spec(Microgrid.from_scenario(scenario), dtype=np.float32)
    pb = params["battery"]
    init = torch.linspace(float(pb["min_capacity"][0]), float(pb["max_capacity"][0]),
                          B, dtype=torch.float32, device=cuda)
    rollout = make_rbc_rollout(spec, params, n_steps, cuda)
    got = rollout(init)
    torch.cuda.synchronize()
    assert rollout.launches == 1
    want = rollout.plain(init)
    assert rollout.launches == 1
    # the kernel is built with --fmad=false and IEEE division in the plain
    # version's op order: bitwise
    assert torch.equal(got, want)


def test_rbc_rollout_unknown_variant_raises(cuda):
    spec, params, _ = extract_spec(Microgrid.from_scenario(0), dtype=np.float32)
    rollout = make_rbc_rollout(spec, params, 10, cuda)
    rollout.variant = 8   # no variant of the launcher's switch
    with pytest.raises(RuntimeError, match="unknown variant"):
        rollout(torch.zeros(4, device=cuda))
    assert rollout.launches == 0
