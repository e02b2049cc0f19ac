"""The port's entry points (``pymgrid_tpu_torch/entry.py``) on the
CPU: ``entry()`` against the JAX ``__graft_entry__.entry()``, and the
data-parallel dryrun over a one-process gloo group."""
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import torch.distributed as torch_dist

from pymgrid_tpu_torch.entry import dryrun_multichip, entry

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import __graft_entry__ as jax_entry  # noqa: E402

torch.set_num_threads(1)


def test_entry_steps_like_jax():
    """One step of the flagship config from reset with the zero action:
    observation and reward equal the JAX entry's bitwise (float32)."""
    fn, args = entry(device="cpu")
    state, out = fn(*args)
    assert int(state["step"]) == 1 and out.obs.shape[:2] == (1, 1)
    jfn, jargs = jax_entry.entry()
    _, jout = jax.jit(jfn)(*jargs)
    np.testing.assert_array_equal(out.reward.numpy().reshape(()), np.asarray(jout.reward))
    np.testing.assert_array_equal(out.obs.numpy().reshape(-1), np.asarray(jout.obs))


def test_dryrun_multichip_over_gloo():
    result = dryrun_multichip(1, device="cpu")
    assert not torch_dist.is_initialized()      # its own group is gone again
    assert result["devices"] == 1 and result["batch"] == 8
    for key in ("loss", "mean_return", "fused_rollout_mean_reward", "suite_mean"):
        assert np.isfinite(result[key]), key
    assert dryrun_multichip(1, device="cpu") == result     # seeded: repeatable


def test_dryrun_needs_one_process_per_device():
    with pytest.raises(ValueError, match="one process drives one device"):
        dryrun_multichip(2, device="cpu")
