"""The port's policies and time loops against the JAX package (CPU, float64);
each package builds its inputs with its own host layer.

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
from pymgrid_tpu.algos import RuleBasedControl as JaxRuleBasedControl
from pymgrid_tpu.core import rollout as jro
from pymgrid_tpu.core.engine import make_reset_fn as jax_reset_fn
from pymgrid_tpu.core.spec import extract_spec as jax_extract_spec
from pymgrid_tpu.core.tables import ensure_tables as jax_ensure_tables
from pymgrid_tpu_torch import Microgrid
from pymgrid_tpu_torch.algos import RuleBasedControl
from pymgrid_tpu_torch.core import prng
from pymgrid_tpu_torch.core import rollout as tro
from pymgrid_tpu_torch.core.spec import extract_spec
from pymgrid_tpu_torch.core.engine import make_reset_fn
from pymgrid_tpu_torch.core.params import params_to_torch, with_config_axis
from pymgrid_tpu_torch.core.tables import ensure_tables

torch.set_num_threads(1)

FIXTURE = Path(__file__).parent / "fixtures" / "golden_rbc.npz"


def _setup(scenario, tables):
    """The scenario's spec and params in both packages, each from its own
    host layer: ``(spec, jspec, jparams, tparams)``."""
    spec, params, _ = extract_spec(Microgrid.from_scenario(scenario))
    jspec, jparams, _ = jax_extract_spec(pymgrid_tpu.Microgrid.from_scenario(scenario))
    jparams = jax.tree.map(jnp.asarray, jparams)
    tparams = params_to_torch(params, "cpu", "float64")
    if tables:
        jparams = jax_ensure_tables(jspec, jparams)
        tparams = ensure_tables(spec, tparams)
    return spec, jspec, jparams, with_config_axis(tparams)


# (scenario, policy, step tables attached, auto_reset): scenario 1 has a
# genset and a weak grid; the late start makes auto_reset wrap the episode
@pytest.mark.parametrize("scenario,policy,tables", [
    (1, "marginal_cost", True),
    (1, "priority", False),
    (0, "marginal_cost", False),
])
def test_rollout_fn_rewards_bitwise(scenario, policy, tables):
    n_steps, start = 60, 8730
    spec, jspec, jparams, tparams = _setup(scenario, tables)
    if policy == "priority":
        jplist = JaxRuleBasedControl(pymgrid_tpu.Microgrid.from_scenario(scenario)).priority_list
        plist = RuleBasedControl(Microgrid.from_scenario(scenario)).priority_list
        jpol, tpol = jro.make_priority_policy(jspec, jplist), tro.make_priority_policy(spec, plist)
    else:
        jpol, tpol = jro.make_marginal_cost_policy(jspec), tro.make_marginal_cost_policy(spec)

    jstate = jax.jit(jax_reset_fn(jspec))(jparams, jax.random.PRNGKey(0), start)
    jfn = jro.make_rollout_fn(jspec, jpol, n_steps, auto_reset=True, collect=False)
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
    spec, jspec, jparams, tparams = _setup(1, tables=True)
    pb = jparams["battery"]
    init = np.linspace(float(pb["min_capacity"][0]), float(pb["max_capacity"][0]), B)

    keys = jax.random.split(jax.random.PRNGKey(0), B)
    jstates = jax.jit(jax.vmap(jax_reset_fn(jspec), in_axes=(None, 0)))(jparams, keys)
    jstates = {**jstates, "battery_charge": jnp.asarray(init)[:, None]}
    jsweep = jro.make_lockstep_sweep_fn(jspec, jro.make_marginal_cost_policy(jspec), n_steps)
    _, want = jsweep(jparams, jro.lockstep_states(jspec, jparams, jstates))

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
    log = RuleBasedControl(Microgrid.from_scenario(scenario)).run_compiled(
        max_steps=n_steps, device="cpu"
    )
    ours = log[("balance", 0, "reward")].values.astype(np.float64)
    assert log.index[0] == 0 and len(log) == n_steps
    np.testing.assert_array_equal(ours, _golden(scenario)[:n_steps])


@pytest.mark.slow
@pytest.mark.parametrize("scenario", range(25))
def test_run_compiled_golden_full_year(scenario):
    log = RuleBasedControl(Microgrid.from_scenario(scenario)).run_compiled(
        device="cpu"
    )
    ours = log[("balance", 0, "reward")].values.astype(np.float64)
    golden = _golden(scenario)
    assert ours.shape == golden.shape
    np.testing.assert_array_equal(ours, golden)


def _random_states(spec, params, rng, B):
    """B engine states (numpy) at random steps, charges and genset machines."""
    pb, pg = params["battery"], params["genset"]
    charge = pb["min_capacity"] + (pb["max_capacity"] - pb["min_capacity"]) * rng.rand(
        B, spec.n_battery)
    status = rng.randint(0, 2, size=(B, spec.n_genset)).astype(np.int32)
    return {
        "step": rng.randint(0, 8700, size=B).astype(np.int32),
        "battery_charge": charge,
        "genset": {
            "current_status": status,
            "goal_status": rng.randint(0, 2, size=(B, spec.n_genset)).astype(np.int32),
            "steps_until_up": rng.randint(0, 2, size=(B, spec.n_genset)).astype(np.int32),
            "steps_until_down": rng.randint(0, 2, size=(B, spec.n_genset)).astype(np.int32),
        },
    }


@pytest.mark.parametrize("tables", [False, True])
def test_table_policy_matches_jax_every_action(tables):
    """Scenario 1 (battery, genset, grid): every action index, each on its
    own random state, against the JAX table policy, bitwise."""
    from pymgrid_tpu.envs import DiscreteMicrogridEnv as JaxDiscreteMicrogridEnv
    from pymgrid_tpu_torch.envs import DiscreteMicrogridEnv

    lists = [list(pl) for pl in DiscreteMicrogridEnv.from_scenario(1).actions_list]
    jlists = [list(pl) for pl in JaxDiscreteMicrogridEnv.from_scenario(1).actions_list]
    spec, jspec, jparams, tparams = _setup(1, tables)
    assert spec.n_genset == 1 and len(lists) > 4
    _, params, _ = extract_spec(Microgrid.from_scenario(1))
    rng = np.random.RandomState(12)
    reps = 3
    idx = np.tile(np.arange(len(lists)), reps).astype(np.int32)
    states = _random_states(spec, params, rng, len(idx))

    jpolicy = jro.make_table_policy(jspec, jlists)
    want = jax.jit(jax.vmap(jpolicy, in_axes=(None, 0, 0)))(
        jparams, {**jax.tree.map(jnp.asarray, states), "rng": jnp.zeros((len(idx), 2), jnp.uint32)},
        jnp.asarray(idx))
    policy = tro.make_table_policy(spec, lists, "cpu")
    tstates = jax.tree.map(lambda x: torch.as_tensor(x).unsqueeze(0), states)
    got = policy(tparams, tstates, torch.as_tensor(idx).view(1, -1))
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape[1:] == want[k].shape
        np.testing.assert_array_equal(got[k][0].numpy(), np.asarray(want[k]), err_msg=k)
    assert len(np.unique(np.asarray(want["grid"]))) > len(lists)   # states differ


def _keys(seed, C, B):
    return prng.split(prng.key(seed), C * B).view(C, B, 2)


def test_random_policy_shape_range_and_seed():
    spec, _, _, tparams = _setup(1, tables=False)
    reset = make_reset_fn(spec)
    starts = torch.zeros((2, 5), dtype=torch.int32)
    draw = lambda seed: tro.make_random_policy(spec)(tparams, reset(tparams, starts,  # noqa: E731
                                                                    _keys(seed, 2, 5)))
    a, b, c = draw(3), draw(3), draw(4)
    sizes = {"battery": (spec.n_battery,), "genset": (spec.n_genset, 2), "grid": (spec.n_grid,)}
    for k, tail in sizes.items():
        assert a[k].shape == (2, 5) + tail and a[k].dtype == torch.float64
        assert bool(((a[k] >= 0) & (a[k] < 1)).all())
        assert torch.equal(a[k], b[k]) and not torch.equal(a[k], c[k])
    assert len(torch.unique(a["battery"])) == 10      # replicas draw apart
    with pytest.raises(ValueError, match="keys"):
        tro.make_random_policy(spec)(tparams, reset(tparams, starts))


def _random_draws(spec, tparams, keys, n_steps):
    """The random policy's actions along a rollout from ``keys``: the step's
    keys are ``split(rng)[0]`` of the last step's."""
    policy, draws = tro.make_random_policy(spec), []
    for _ in range(n_steps):
        draws.append(policy(tparams, {"rng": keys}))
        keys = prng.split(keys)[..., 0, :]
    return {k: torch.stack([d[k] for d in draws]) for k in draws[0]}


def test_rollout_actions_and_normalized_rollout_match_jax():
    """``rollout_actions`` (normalized actions) against the JAX one, bitwise;
    ``rollout_policy`` with the random policy equals ``rollout_actions`` fed
    the same draws."""
    n_steps, B = 25, 3
    spec, jspec, jparams, tparams = _setup(1, tables=True)
    state = make_reset_fn(spec)(tparams, torch.full((1, B), 100, dtype=torch.int32),
                                _keys(0, 1, B))
    actions = _random_draws(spec, tparams, state["rng"], n_steps)

    final, outs = tro.rollout_actions(spec, tparams, state, actions, normalized=True)
    keys = jax.random.split(jax.random.PRNGKey(0), B)
    jstate = jax.vmap(jax_reset_fn(jspec), in_axes=(None, 0, None))(jparams, keys, 100)
    jfinal, jouts = jax.vmap(
        lambda s, a: jro.rollout_actions(jspec, jparams, s, a, normalized=True),
        in_axes=(0, 1), out_axes=(0, 1),
    )(jstate, jax.tree.map(lambda x: jnp.asarray(x[:, 0].numpy()), actions))
    for field in ("obs", "reward", "shaped_reward", "done", "log_row"):
        np.testing.assert_array_equal(getattr(outs, field)[:, 0].numpy(),
                                      np.asarray(getattr(jouts, field)), err_msg=field)
    np.testing.assert_array_equal(final["battery_charge"][0].numpy(),
                                  np.asarray(jfinal["battery_charge"]))

    replay = tro.make_random_policy(spec)
    _, same = tro.rollout_policy(spec, tparams, state, replay, n_steps, normalized=True)
    for field in ("obs", "reward", "log_row"):
        assert torch.equal(getattr(same, field), getattr(outs, field)), field
    _, (rewards, _) = tro.rollout_policy(spec, tparams, state, tro.make_random_policy(spec),
                                         n_steps, normalized=True, collect=False)
    assert torch.equal(rewards, outs.reward)


def test_random_policy_rollout_matches_jax():
    """The random policy's actions on the reset state, and a 50-step float64
    ``normalized=True`` rollout on scenario 0 with it, against the JAX policy
    and ``make_rollout_fn`` from the same keys: bitwise (the uniforms are
    built from threefry bits in both)."""
    n_steps, B = 50, 3
    spec, jspec, jparams, tparams = _setup(0, tables=True)
    state = make_reset_fn(spec)(tparams, tparams["initial_step"].view(1, 1).expand(1, B),
                                _keys(5, 1, B))
    jkeys = jax.random.split(jax.random.PRNGKey(5), B)
    jstate = jax.vmap(jax_reset_fn(jspec), in_axes=(None, 0))(jparams, jkeys)

    got = tro.make_random_policy(spec)(tparams, state)
    want = jax.vmap(jro.make_random_policy(jspec), in_axes=(None, 0))(jparams, jstate)
    for k in want:
        np.testing.assert_array_equal(got[k][0].numpy(), np.asarray(want[k]), err_msg=k)

    final, outs = tro.rollout_policy(spec, tparams, state, tro.make_random_policy(spec),
                                     n_steps, normalized=True)
    jfn = jro.make_rollout_fn(jspec, jro.make_random_policy(jspec), n_steps, normalized=True)
    jfinal, jouts = jax.vmap(jfn, in_axes=(None, 0), out_axes=(0, 1))(jparams, jstate)
    for field in ("obs", "reward", "done", "log_row"):
        np.testing.assert_array_equal(getattr(outs, field)[:, 0].numpy(),
                                      np.asarray(getattr(jouts, field)), err_msg=field)
    np.testing.assert_array_equal(final["rng"][0].numpy(),
                                  np.asarray(jfinal["rng"]).astype(np.int64))
    assert len(np.unique(outs.reward.numpy())) > n_steps  # replicas and steps differ


def test_select_state_keeps_a_shared_step():
    """A ``(C, 1)`` step leaf takes replica 0's condition and stays shared;
    per-replica leaves select per replica from a shared fresh state."""
    done = torch.tensor([[True, True, True], [False, False, False]])
    current = {"step": torch.tensor([[20], [7]], dtype=torch.int32),
               "battery_charge": torch.arange(6.0).view(2, 3, 1)}
    fresh = {"step": torch.tensor([[0], [0]], dtype=torch.int32),
             "battery_charge": torch.full((2, 1, 1), -1.0)}
    out = tro.select_state(done, fresh, current)
    assert out["step"].shape == (2, 1) and out["step"].tolist() == [[0], [7]]
    assert out["battery_charge"].shape == (2, 3, 1)
    assert out["battery_charge"][..., 0].tolist() == [[-1.0, -1.0, -1.0], [3.0, 4.0, 5.0]]
