"""The port's policies and time loops against the JAX package (CPU, float64).

Reward streams are compared bitwise: both engines round every op once and
sum balances in numpy's order.  ``run_compiled`` is held against the recorded
reference RBC streams (``tests/fixtures/golden_rbc.npz``).
"""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pymgrid_tpu
from pymgrid_tpu.algos import RuleBasedControl as HostRuleBasedControl
from pymgrid_tpu.core import rollout as jro
from pymgrid_tpu.core.engine import make_reset_fn as jax_reset_fn
from pymgrid_tpu.core.spec import extract_spec
from pymgrid_tpu.core.tables import ensure_tables as jax_ensure_tables
from pymgrid_tpu_torch.algos import RuleBasedControl
from pymgrid_tpu_torch.core import rollout as tro
from pymgrid_tpu_torch.core.engine import make_reset_fn
from pymgrid_tpu_torch.core.params import params_to_torch, with_config_axis
from pymgrid_tpu_torch.core.tables import ensure_tables

torch.set_num_threads(1)

FIXTURE = Path(__file__).parent / "fixtures" / "golden_rbc.npz"


def _setup(scenario, tables):
    mg = pymgrid_tpu.Microgrid.from_scenario(scenario)
    spec, params, _ = extract_spec(mg)
    jparams = jax.tree.map(jnp.asarray, params)
    tparams = params_to_torch(params, "cpu", "float64")
    if tables:
        jparams = jax_ensure_tables(spec, jparams)
        tparams = ensure_tables(spec, tparams)
    return mg, spec, jparams, with_config_axis(tparams)


# (scenario, policy, step tables attached, auto_reset): scenario 1 has a
# genset and a weak grid; the late start makes auto_reset wrap the episode
@pytest.mark.parametrize("scenario,policy,tables", [
    (1, "marginal_cost", True),
    (1, "priority", False),
    (0, "marginal_cost", False),
])
def test_rollout_fn_rewards_bitwise(scenario, policy, tables):
    n_steps, start = 60, 8730
    mg, spec, jparams, tparams = _setup(scenario, tables)
    if policy == "priority":
        plist = HostRuleBasedControl(mg).priority_list
        jpol, tpol = jro.make_priority_policy(spec, plist), tro.make_priority_policy(spec, plist)
    else:
        jpol, tpol = jro.make_marginal_cost_policy(spec), tro.make_marginal_cost_policy(spec)

    jstate = jax.jit(jax_reset_fn(spec))(jparams, jax.random.PRNGKey(0), start)
    jfn = jro.make_rollout_fn(spec, jpol, n_steps, auto_reset=True, collect=False)
    _, (jrewards, jdones) = jfn(jparams, jstate)

    state = make_reset_fn(spec)(tparams, torch.tensor([[start]]))
    fn = tro.make_rollout_fn(spec, tpol, n_steps, auto_reset=True, collect=False)
    _, (rewards, dones) = fn(tparams, state)
    assert rewards.shape == (n_steps, 1, 1)
    assert bool(dones.any()), "the episode should end inside the window"
    np.testing.assert_array_equal(rewards[:, 0, 0].numpy(), np.asarray(jrewards))
    np.testing.assert_array_equal(dones[:, 0, 0].numpy(), np.asarray(jdones))


def test_lockstep_sweep_matches_jax():
    """A 64-replica init-charge sweep of scenario 1 (genset, weak grid)."""
    B, n_steps = 64, 120
    _, spec, jparams, tparams = _setup(1, tables=True)
    pb = jparams["battery"]
    init = np.linspace(float(pb["min_capacity"][0]), float(pb["max_capacity"][0]), B)

    keys = jax.random.split(jax.random.PRNGKey(0), B)
    jstates = jax.jit(jax.vmap(jax_reset_fn(spec), in_axes=(None, 0)))(jparams, keys)
    jstates = {**jstates, "battery_charge": jnp.asarray(init)[:, None]}
    jsweep = jro.make_lockstep_sweep_fn(spec, jro.make_marginal_cost_policy(spec), n_steps)
    _, want = jsweep(jparams, jro.lockstep_states(spec, jparams, jstates))

    starts = tparams["initial_step"].view(1, 1).expand(1, B)
    states = make_reset_fn(spec)(tparams, starts)
    states["battery_charge"] = torch.as_tensor(init).view(1, B, 1)
    sweep = tro.make_lockstep_sweep_fn(spec, tro.make_marginal_cost_policy(spec), n_steps)
    final, acc = sweep(tparams, tro.lockstep_states(spec, tparams, states))
    assert acc.shape == (1, B)
    assert final["step"].shape == (1, 1) and int(final["step"]) == n_steps
    assert len(np.unique(acc.numpy())) > B // 2  # distinct replicas
    np.testing.assert_array_equal(acc[0].numpy(), np.asarray(want))


def _golden(scenario):
    with np.load(FIXTURE) as golden:
        return golden[f"scenario_{scenario}_reward"]


@pytest.mark.parametrize("scenario", range(25))
def test_run_compiled_golden_prefix(scenario):
    n_steps = 200
    log = RuleBasedControl(pymgrid_tpu.Microgrid.from_scenario(scenario)).run_compiled(
        max_steps=n_steps, device="cpu"
    )
    ours = log[("balance", 0, "reward")].values.astype(np.float64)
    assert log.index[0] == 0 and len(log) == n_steps
    np.testing.assert_array_equal(ours, _golden(scenario)[:n_steps])


@pytest.mark.slow
@pytest.mark.parametrize("scenario", range(25))
def test_run_compiled_golden_full_year(scenario):
    log = RuleBasedControl(pymgrid_tpu.Microgrid.from_scenario(scenario)).run_compiled(
        device="cpu"
    )
    ours = log[("balance", 0, "reward")].values.astype(np.float64)
    golden = _golden(scenario)
    assert ours.shape == golden.shape
    np.testing.assert_array_equal(ours, golden)
