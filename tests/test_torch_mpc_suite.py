"""The port's ``SuiteMPC`` against the JAX package's ``SuiteMPC`` and the
port's own ``BatchedMPC`` (CPU, float64), at the bars the JAX package holds
its two batched paths to (``tests/test_mpc_suite.py``): per-step rewards
within atol 5e-4 scaled by the largest reward, total cost within rtol 1e-4.
"""
import warnings

import jax  # noqa: F401  (conftest pins CPU and float64)
import numpy as np
import pytest
import torch

import pymgrid_tpu
import pymgrid_tpu_torch
from pymgrid_tpu.algos.mpc_suite import SuiteMPC as JaxSuiteMPC
from pymgrid_tpu_torch.algos import BatchedMPC, SuiteMPC
from test_torch_mpc import assert_closed_loop_close

torch.set_num_threads(1)
warnings.filterwarnings("ignore")

SCENARIOS = [0, 4, 1]   # grid only, grid only, genset + weak grid


def _mgs(scenarios=SCENARIOS):
    """The scenarios from the port's host layer."""
    return [pymgrid_tpu_torch.Microgrid.from_scenario(n) for n in scenarios]


def _jmgs(scenarios=SCENARIOS):
    """The scenarios from the JAX package's host layer."""
    return [pymgrid_tpu.Microgrid.from_scenario(n) for n in scenarios]


@pytest.fixture(scope="module")
def suite_runs():
    T = 20
    kw = dict(enum_bits=2, enum_chunk=4)
    want, _ = JaxSuiteMPC(_jmgs(), dtype=np.float64, **kw).run_scanned(T, chunk=T)
    suite = SuiteMPC(_mgs(), dtype="float64", device="cpu", **kw)
    got, states = suite.run_scanned(T, chunk=7)
    solo = np.stack([
        BatchedMPC(mg, batch_size=1, dtype="float64", device="cpu", host_fallback=False,
                   **kw).run_scanned(T, chunk=T)[0][:, 0]
        for mg in _mgs()
    ], axis=1)
    return want, got, states, solo, suite


def test_suite_mpc_matches_jax_suite(suite_runs):
    want, got, states, _, suite = suite_runs
    assert got.shape == (20, 3)
    assert suite.include_genset and suite.template.costs_static.shape[0] == 3
    assert_closed_loop_close(got, want, "SuiteMPC vs JAX SuiteMPC")
    assert states["step"].tolist() == [20, 20, 20]


def test_suite_mpc_matches_port_batched_mpc(suite_runs):
    _, got, _, solo, _ = suite_runs
    assert_closed_loop_close(got, solo, "SuiteMPC vs BatchedMPC")


def test_suite_step_api_matches_run(suite_runs):
    *_, suite = suite_runs
    got = suite_runs[1]
    states = suite.reset()
    for k in range(3):
        states, out = suite.step(states)
        np.testing.assert_array_equal(out.reward.numpy(), got[k])
    assert out.obs is None and out.reward.shape == (3,)


@pytest.mark.parametrize("solver_kind, scenarios", [("box", [0, 4, 1]), ("ipm", [0, 4])])
def test_tie_break_and_slack_solver_match_jax(solver_kind, scenarios):
    """``tie_break_eps > 0`` (the storage-face tilt) with the box solver on
    a genset group, and the slack-form solver on a genset-free group (no
    neutral genset slot, no enumeration)."""
    T = 8
    kw = dict(enum_bits=2, enum_chunk=4, tie_break_eps=1e-3, solver_kind=solver_kind)
    want, _ = JaxSuiteMPC(_jmgs(scenarios), dtype=np.float64, **kw).run_scanned(T, chunk=T)
    suite = SuiteMPC(_mgs(scenarios), dtype="float64", device="cpu", **kw)
    got, _ = suite.run_scanned(T)
    assert suite.include_genset == (1 in scenarios)
    assert_closed_loop_close(got, want, f"tie-break, {solver_kind}")


def test_suite_mpc_rejects_mismatched_lengths():
    a, b = _mgs([0, 4])
    b.final_step = int(b.final_step) - 7
    with pytest.raises(ValueError, match="disagree"):
        SuiteMPC([a, b], dtype="float64", device="cpu", enum_bits=0)
