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


def _recorded(monkeypatch, runner_cls, calls):
    """Record ``(runner, keys, output)`` of every suite rollout a
    ``runner_cls`` runs."""
    rollout_fn = runner_cls.rollout_fn

    def recorded(self, *args, **kwargs):
        fn = rollout_fn(self, *args, **kwargs)

        def run(params, keys):
            calls.append((self, keys, fn(params, keys)))
            return calls[-1][2]

        return run

    monkeypatch.setattr(runner_cls, "rollout_fn", recorded)


def test_dryrun_suite_draws_the_jax_dryruns_starts(monkeypatch):
    """The dryrun's meshed suite (scenario 0, 4 replicas x 16 steps, the
    block-prefetch path) starts where ``__graft_entry__.dryrun_multichip``'s
    suite starts without ``jax_enable_x64`` (JAX's int32 draw), bitwise, and
    its mean equals the JAX suite's at rtol 1e-5 (float32)."""
    from pymgrid_tpu.parallel.suite import SuiteRunner as JaxSuiteRunner
    from pymgrid_tpu_torch.parallel import SuiteRunner

    jax_calls, calls = [], []
    _recorded(monkeypatch, JaxSuiteRunner, jax_calls)
    _recorded(monkeypatch, SuiteRunner, calls)
    with jax.enable_x64(False):
        jax_entry.dryrun_multichip(1)
        (jrunner, jkeys, jacc), = jax_calls
        max_start = min(m.ts_length for m in jrunner.spec.log_order if m.ts_length) - 1
        want = np.array([[int(jax.random.randint(jax.random.fold_in(k, 0x51A7), (), 0,
                                                 max_start)) for k in jkeys[0]]])
        assert np.asarray(jrunner.params["initial_step"]).tolist() == [0]
    result = dryrun_multichip(1, device="cpu")
    (runner, keys, acc), = calls
    assert runner.start_dtype == torch.int32 and acc.shape == (1, 4)
    np.testing.assert_array_equal(runner.draw_initial_steps(keys).numpy(), want)
    np.testing.assert_allclose(result["suite_mean"], float(np.asarray(jacc).mean()), rtol=1e-5)
    np.testing.assert_allclose(acc.numpy(), np.asarray(jacc), rtol=1e-5)


def test_dryrun_needs_one_process_per_device():
    with pytest.raises(ValueError, match="one process drives one device"):
        dryrun_multichip(2, device="cpu")
