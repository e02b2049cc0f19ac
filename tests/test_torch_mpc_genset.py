"""The port's ``BatchedMPC`` on scenario 1 (genset MILP, weak grid) against
the JAX package's and the host HiGHS MILP MPC (CPU, float64).

One 24-step run each, at the default ``enum_bits=5`` with the host fallback
on: the case ``tests/test_lp_mpc.py::test_batched_mpc_genset_milp_matches_host``
holds the JAX class to (total cost within rel 1e-4 of HiGHS), and the
float64 case ``chip_smoke.py`` repeats on the card, where the fallback count
must equal this run's (0).
"""
import warnings

import jax  # noqa: F401  (conftest pins CPU and float64)
import numpy as np
import pytest
import torch

import pymgrid_tpu
import pymgrid_tpu_torch
from pymgrid_tpu.algos import ModelPredictiveControl
from pymgrid_tpu.algos import mpc_jax
from pymgrid_tpu_torch.algos import BatchedMPC
from test_torch_mpc import assert_closed_loop_close

torch.set_num_threads(1)
warnings.filterwarnings("ignore")

STEPS = 24
FALLBACK_COUNT = 0   # the port's CPU run of this case; chip_smoke.py checks it


@pytest.fixture(scope="module")
def genset_runs():
    mg = lambda: pymgrid_tpu.Microgrid.from_scenario(1)
    tb = BatchedMPC(pymgrid_tpu_torch.Microgrid.from_scenario(1), batch_size=1,
                    dtype="float64", device="cpu")
    got, states = tb.run(STEPS)
    jb = mpc_jax.BatchedMPC(mg(), batch_size=1, dtype=np.float64)
    want, _ = jb.run(STEPS)
    log = ModelPredictiveControl(mg()).run(max_steps=STEPS)
    host_cost = -log[("balance", 0, "reward")].sum()
    return got, states, tb.fallback_count, want, jb.fallback_count, host_cost


def test_genset_mpc_matches_jax(genset_runs):
    got, _, fallbacks, want, jax_fallbacks, _ = genset_runs
    assert_closed_loop_close(got, want, "scenario 1 vs JAX BatchedMPC")
    assert fallbacks == jax_fallbacks


def test_genset_mpc_matches_host_milp(genset_runs):
    got, states, fallbacks, _, _, host_cost = genset_runs
    assert abs(-got[:, 0].sum() - host_cost) / abs(host_cost) < 1e-4
    assert fallbacks == FALLBACK_COUNT
    assert states["genset"]["current_status"].shape == (1, 1)
