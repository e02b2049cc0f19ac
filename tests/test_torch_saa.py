"""The port's ``BatchedSAA`` against the JAX package's (CPU, float64).

Both packages get the same ``samples=``: the same sorted-percentile pick on
every step, sample costs within rel 1e-5 (the same LPs, each stopped after
30 IPM iterations short of full convergence on noisy samples; measured up
to 2.2e-6 apart), rewards at the JAX package's closed-loop bars (per-step atol
5e-4 scaled by the largest reward, total rtol 1e-4).
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pymgrid_tpu
import pymgrid_tpu_torch
from pymgrid_tpu.algos.saa_jax import BatchedSAA as JaxBatchedSAA
from pymgrid_tpu_torch.algos import BatchedMPC, BatchedSAA
from pymgrid_tpu_torch.utils.data_generator import return_underlying_data
from test_torch_mpc import assert_closed_loop_close

torch.set_num_threads(1)
warnings.filterwarnings("ignore")


def _mg(n):
    """Scenario ``n`` from the port's host layer."""
    return pymgrid_tpu_torch.Microgrid.from_scenario(n)


def _jmg(n):
    """Scenario ``n`` from the JAX package's host layer."""
    return pymgrid_tpu.Microgrid.from_scenario(n)


def _samples(scenario, n_samples):
    """Host samples (preset 85) from a seeded numpy global state, drawn by
    the port's host generators (the legacy generators draw from
    ``np.random``); both packages then get the same samples."""
    state = np.random.get_state()
    np.random.seed(1234)
    try:
        return BatchedSAA._generate_samples(_mg(scenario), n_samples, None, None, 85)
    finally:
        np.random.set_state(state)


def _steps(saa, state, n):
    """``n`` steps of a JAX or port SAA from ``state``; returns rewards,
    sample costs and picks."""
    rewards, costs, picks = [], [], []
    for _ in range(n):
        state, out, c, chosen = saa.step(state)
        rewards.append(float(out.reward))
        costs.append(np.asarray(c, np.float64))
        picks.append(int(chosen))
    return np.array(rewards), np.stack(costs), np.array(picks)


@pytest.mark.parametrize("scenario, kw", [(0, {}), (1, {"enum_bits": 3})],
                         ids=["scenario0", "scenario1-genset"])
def test_saa_matches_jax_with_the_same_samples(scenario, kw):
    n_samples, steps = (5, 10) if scenario == 0 else (3, 3)
    samples = _samples(scenario, n_samples)
    jsaa = JaxBatchedSAA(_jmg(scenario), n_samples=n_samples, samples=samples, **kw)
    tsaa = BatchedSAA(_mg(scenario), n_samples=n_samples, samples=samples,
                      dtype="float64", device="cpu", **kw)
    r_j, c_j, p_j = _steps(jsaa, jsaa.reset(), steps)
    r_t, c_t, p_t = _steps(tsaa, tsaa.reset(), steps)
    np.testing.assert_array_equal(p_t, p_j)
    np.testing.assert_allclose(c_t, c_j, rtol=1e-5)
    assert_closed_loop_close(r_t[:, None], r_j[:, None], f"SAA scenario {scenario}")
    # the pick sits at floor(N * 0.5) of the sorted costs
    k = int(np.floor(n_samples * 0.5))
    assert all(c[p] == np.sort(c)[k] for c, p in zip(c_t, p_t))


def test_saa_window_clamps_at_the_series_end():
    """Near the end of the series the sample windows shift back so the
    horizon fits (``lax.dynamic_slice``), and row 0 of the shifted window
    still takes the realized data: the port's costs and pick at such steps
    equal the JAX package's."""
    samples = _samples(0, 4)
    jsaa = JaxBatchedSAA(_jmg(0), n_samples=4, samples=samples)
    tsaa = BatchedSAA(_mg(0), n_samples=4, samples=samples, dtype="float64", device="cpu")
    t_end = tsaa.sample_length - 10
    jstate = {**jsaa.reset(), "step": jnp.int32(t_end)}
    tstate = {**tsaa.reset(), "step": torch.tensor(t_end, dtype=torch.int32)}
    r_j, c_j, p_j = _steps(jsaa, jstate, 4)
    r_t, c_t, p_t = _steps(tsaa, tstate, 4)
    np.testing.assert_array_equal(p_t, p_j)
    np.testing.assert_allclose(c_t, c_j, rtol=1e-5)
    assert_closed_loop_close(r_t[:, None], r_j[:, None], "SAA at the series end")


def test_degenerate_saa_equals_batched_mpc():
    """Every sample equal to the real data: SAA solves MPC's LP
    (``tests/test_lp_mpc.py::test_batched_saa_degenerate_equals_mpc``)."""
    real = return_underlying_data(_mg(0).to_nonmodular())
    saa = BatchedSAA(_mg(0), n_samples=3, optimal_percentile=1.0,
                     samples=[real.copy() for _ in range(3)], dtype="float64", device="cpu")
    r_saa, state = saa.run(n_steps=10)
    r_mpc, _ = BatchedMPC(_mg(0), batch_size=1, dtype="float64", device="cpu").run(10)
    np.testing.assert_allclose(r_saa, r_mpc[:, 0], rtol=1e-5, atol=1e-8)
    assert r_saa.dtype == np.float64 and int(state["step"]) == 10
    r_scan, _ = saa.run_scanned(n_steps=10, chunk=3)
    np.testing.assert_array_equal(r_scan, r_saa)


def test_saa_rejects_bad_percentile():
    with pytest.raises(ValueError):
        BatchedSAA(_mg(0), optimal_percentile=1.5, dtype="float64", device="cpu")
