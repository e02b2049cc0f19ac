"""The port's training programs (``pymgrid_tpu_torch.examples``) against the
JAX examples and a JAX loss built here from ``pymgrid_tpu``'s engine (CPU,
float32, as the examples train).

Weights cross as numpy: the A2C pytree through ``theta_from_jax``, the ES
flat vector as it is.  Tolerances, float32: MLP outputs rtol 1e-6; the A2C
loss, gradient and the parameters after one Adam step rtol 1e-5 (the two
sides sum in other orders; a parameter or gradient entry near 0 is held to
an absolute 1e-5 of the Adam step, or 1e-7); evaluation returns rtol 1e-6
(equal rewards per step, summed in another order); ES returns rtol 1e-5;
ES's rank-shaped gradient and its Adam step from the same returns bitwise.
"""
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax import lax

from pymgrid_tpu.core.engine import make_reset_fn as jax_reset_fn
from pymgrid_tpu.core.engine import make_step_fn as jax_step_fn
from pymgrid_tpu.core.rollout import make_table_policy as jax_table_policy
from pymgrid_tpu.core.spec import extract_spec as jax_extract_spec
from pymgrid_tpu.core.tables import ensure_tables as jax_ensure_tables
from pymgrid_tpu.envs import DiscreteMicrogridEnv as JaxDiscreteMicrogridEnv
from pymgrid_tpu_torch.examples.train_es import _xla_row_sum, build_es
from pymgrid_tpu_torch.examples.train_rl import (
    build_training,
    reward_to_go,
    theta_from_jax,
    theta_to_numpy,
)
from pymgrid_tpu_torch.utils.optax_adam import Adam

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from examples.train_es import build_es as jax_build_es  # noqa: E402
from examples.train_rl import build_training as jax_build_training  # noqa: E402

torch.set_num_threads(1)

GAMMA, ENTROPY, LR = 0.99, 0.01, 3e-4


def _jax_mlp(layers, x):
    for layer in layers[:-1]:
        x = jax.nn.tanh(x @ layer["w"] + layer["b"])
    return x @ layers[-1]["w"] + layers[-1]["b"]


def _random_theta(obs_dim, n_actions, seed=0):
    """An A2C pytree in the JAX layout (``w`` is ``(in, out)``), float32."""
    rng = np.random.RandomState(seed)

    def layers(sizes):
        return [{"w": (rng.randn(m, n) * np.sqrt(2.0 / m)).astype(np.float32),
                 "b": (0.1 * rng.randn(n)).astype(np.float32)}
                for m, n in zip(sizes[:-1], sizes[1:])]

    return {"policy": layers([obs_dim, 64, 64, n_actions]),
            "value": layers([obs_dim, 64, 64, 1])}


def _assert_tree_close(ours, want, rtol, atol=0.0):
    for head in ("policy", "value"):
        for i, (a, b) in enumerate(zip(ours[head], want[head], strict=True)):
            for k in ("w", "b"):
                np.testing.assert_allclose(a[k], np.asarray(b[k]), rtol=rtol, atol=atol,
                                           err_msg=f"{head}[{i}].{k}")


def test_theta_from_jax_mlp_outputs():
    """The carried MLPs compute the JAX MLPs: in float32 at rtol 1e-6 of
    the outputs' scale (the matmuls sum in other orders), and in float64,
    which shows the layout exactly, at rtol 1e-12."""
    theta = _random_theta(obs_dim=17, n_actions=5)
    module = theta_from_jax(theta, device="cpu")
    x = np.random.RandomState(1).randn(32, 17).astype(np.float32)
    for head in ("policy", "value"):
        want = np.asarray(_jax_mlp(jax.tree.map(jnp.asarray, theta[head]), jnp.asarray(x)))
        got = getattr(module, head)(torch.as_tensor(x)).detach().numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(want).max(),
                                   err_msg=head)
        want64 = _jax_mlp(jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), theta[head]),
                          jnp.asarray(x, jnp.float64))
        got64 = getattr(module.double(), head)(torch.as_tensor(x, dtype=torch.float64))
        np.testing.assert_allclose(got64.detach().numpy(), np.asarray(want64), rtol=1e-12,
                                   err_msg=head)
        module.float()
    _assert_tree_close(theta_to_numpy(module), theta, rtol=0)


def _jax_a2c(scenario, batch):
    """The JAX example's ``init_envs`` and ``loss_fn`` with the actions fed
    instead of drawn, built from ``pymgrid_tpu``'s engine."""
    env = JaxDiscreteMicrogridEnv.from_scenario(scenario)
    spec, params, _ = jax_extract_spec(env, dtype=np.float32)
    params = jax.tree.map(jnp.asarray, jax_ensure_tables(spec, params))
    table_policy = jax_table_policy(spec, [list(pl) for pl in env.actions_list])
    step_fn = jax_step_fn(spec, normalized=False)
    reset_fn = jax_reset_fn(spec)

    def env_step(params, state, action_idx):
        new_state, out = step_fn(params, state, table_policy(params, state, action_idx))
        fresh = reset_fn(params, new_state["rng"])
        return jax.tree.map(lambda f, n: jnp.where(out.done, f, n), fresh, new_state), out

    def init_envs():
        keys = jax.random.split(jax.random.PRNGKey(0), batch)
        states = jax.vmap(reset_fn, in_axes=(None, 0))(params, keys)
        zero = {"battery": jnp.zeros(spec.n_battery, jnp.float32),
                "genset": jnp.zeros((spec.n_genset, 2), jnp.float32),
                "grid": jnp.zeros(spec.n_grid, jnp.float32)}
        states, outs = jax.vmap(lambda s: step_fn(params, s, zero))(states)
        states = dict(states)
        states["step"] = states["step"][0]
        states["forecast"] = jax.tree.map(lambda x: x[0], states["forecast"])
        return states, outs.obs

    env_axes = {"step": None, "battery_charge": 0, "genset": 0, "rng": 0, "forecast": None}
    batched_step = jax.vmap(env_step, in_axes=(None, env_axes, 0), out_axes=(env_axes, 0))

    def loss_fn(theta, states, obses, actions):
        def body(carry, a):
            states, obses = carry
            x = obses.astype(jnp.float32)
            logp_all = jax.nn.log_softmax(_jax_mlp(theta["policy"], x))
            logp = (jax.nn.one_hot(a, logp_all.shape[-1]) * logp_all).sum(axis=-1)
            entropy = -(jnp.exp(logp_all) * logp_all).sum(axis=-1)
            values = _jax_mlp(theta["value"], x)[:, 0]
            states, outs = batched_step(params, states, a)
            return (states, outs.obs), (logp, values, outs.reward * 1e-4, outs.done, entropy)

        _, (logps, values, rewards, dones, entropies) = lax.scan(
            body, (states, obses), actions)

        def disc(carry, x):
            r, d = x
            carry = r + GAMMA * carry * (1.0 - d.astype(jnp.float32))
            return carry, carry

        _, returns = lax.scan(disc, jnp.zeros(rewards.shape[1], jnp.float32),
                              (rewards, dones), reverse=True)
        adv = lax.stop_gradient(returns) - values
        loss = (-(logps * lax.stop_gradient(adv)).mean() + 0.5 * (adv ** 2).mean()
                - ENTROPY * entropies.mean())
        return loss, returns.mean()

    return env, init_envs, jax.jit(jax.value_and_grad(loss_fn, has_aux=True))


@pytest.mark.parametrize("scenario", [0, 1])
def test_a2c_loss_grad_and_adam_match_jax(scenario):
    """One A2C iteration with the same fed actions on both sides: the start
    observations bitwise, the loss, mean return and gradient at rtol 1e-5,
    and the parameters after one Adam step against ``optax.adam``."""
    batch, T = 16, 8
    env, jax_init, jax_value_and_grad = _jax_a2c(scenario, batch)
    run = build_training(scenario=scenario, batch=batch, rollout_len=T, lr=LR, gamma=GAMMA,
                         entropy_coef=ENTROPY, device="cpu")
    assert (run.obs_dim, run.n_actions) == (run.spec.obs_dim, env.action_space.n)
    theta = _random_theta(run.obs_dim, run.n_actions, seed=scenario)
    actions = np.random.RandomState(2).randint(run.n_actions, size=(T, batch))

    jstates, jobs = jax_init()
    states, obs = run.init_envs()
    np.testing.assert_array_equal(obs.numpy(), np.asarray(jobs))
    (jloss, jret), jgrads = jax_value_and_grad(jax.tree.map(jnp.asarray, theta), jstates,
                                              jobs, jnp.asarray(actions))

    module = theta_from_jax(theta, device="cpu")
    loss, (_, _, mean_ret) = run.loss(module, states, obs, actions=actions)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(mean_ret.item(), float(jret), rtol=1e-5)
    grads = {head: [{"w": l.weight.grad.numpy().T, "b": l.bias.grad.numpy()}
                    for l in module.linears(head)] for head in ("policy", "value")}
    _assert_tree_close(grads, jgrads, rtol=1e-5, atol=1e-7)

    optimizer = optax.adam(LR)
    updates, _ = optimizer.update(jgrads, optimizer.init(jax.tree.map(jnp.asarray, theta)))
    jtheta = optax.apply_updates(jax.tree.map(jnp.asarray, theta), updates)
    module = theta_from_jax(theta, device="cpu")
    adam = Adam(module.parameters(), lr=LR)
    *_, step_loss, step_ret = run.train_step(module, adam, *run.init_envs(), actions=actions)
    assert step_loss.item() == loss.item() and step_ret.item() == mean_ret.item()
    _assert_tree_close(theta_to_numpy(module), jtheta, rtol=1e-5, atol=1e-5 * LR)


def test_reward_to_go_matches_jax_scan():
    rng = np.random.RandomState(3)
    rewards = rng.randn(20, 6).astype(np.float32)
    dones = rng.rand(20, 6) < 0.2

    def disc(carry, x):
        r, d = x
        carry = r + GAMMA * carry * (1.0 - d.astype(jnp.float32))
        return carry, carry

    _, want = lax.scan(disc, jnp.zeros(6, jnp.float32), (rewards, dones), reverse=True)
    got = reward_to_go(torch.as_tensor(rewards), torch.as_tensor(dones), GAMMA)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_a2c_eval_matches_jax_example():
    """A theta trained 2 iterations by the JAX example, carried across: the
    greedy policy's and the RBC's 200-step returns equal the example's."""
    jrun = jax_build_training(scenario=0, batch=64, rollout_len=16)
    jtheta, _, _ = jrun(iters=2, log_every=100)
    run = build_training(scenario=0, batch=64, rollout_len=16, device="cpu")
    theta = theta_from_jax(jax.tree.map(np.asarray, jtheta), device="cpu")
    np.testing.assert_allclose(run.eval_greedy(theta, n_steps=200),
                               jrun.eval_greedy(jtheta, n_steps=200), rtol=1e-6)
    np.testing.assert_allclose(run.rbc_baseline(n_steps=200), jrun.rbc_baseline(n_steps=200),
                               rtol=1e-6)


def test_a2c_history_independent_of_log_every():
    run = build_training(scenario=0, batch=16, rollout_len=8, device="cpu")
    theta, opt_state, history = run(iters=4, log_every=100)
    assert len(history) == 4 and all(np.isfinite(h) for h in history)
    _, _, history_chunked = run(iters=4, log_every=3)
    assert history_chunked == history
    # continuation blocks resume the Adam moments
    theta2, _, _ = run(iters=2, seed=5, theta=theta, opt_state=opt_state)
    assert torch.isfinite(theta2.policy[0].weight).all()
    assert opt_state.state[theta2.policy[0].weight]["step"] == 6


@pytest.mark.parametrize("n", [6, 32, 33, 100, 256, 1025])
def test_es_row_sum_is_xla_order(n):
    """``_xla_row_sum`` sums the rows as XLA's CPU backend sums a jitted
    ``x.sum(axis=0)``, bit for bit: in order up to 32 rows, in evenly padded
    blocks of 32 beyond."""
    rng = np.random.default_rng(n)
    x = (rng.standard_normal((n, 257)) * 10.0 ** rng.uniform(-3, 3, (n, 1))).astype(np.float32)
    with jax.enable_x64(False):
        want = np.asarray(jax.jit(lambda a: a.sum(axis=0))(jnp.asarray(x)))
    np.testing.assert_array_equal(_xla_row_sum(torch.from_numpy(x)).numpy(), want)


@pytest.mark.parametrize("continuous", [False, True], ids=["discrete", "continuous"])
def test_es_matches_jax_example(continuous):
    """``eval_theta`` and ``rbc_baseline`` over 300 steps, the population's
    returns, and the rank-shaped Adam update from the same ``eps`` and
    returns, against the JAX example: the gradient and the updated
    parameters bit for bit."""
    kw = dict(scenario=0, pop=8, n_steps=300, continuous=continuous)
    jrun, run = jax_build_es(**kw), build_es(**kw, device="cpu")
    assert run.dim == jrun.dim
    rng = np.random.RandomState(4)
    theta = (0.3 * rng.randn(run.dim)).astype(np.float32)
    np.testing.assert_allclose(run.eval_theta(theta), jrun.eval_theta(jnp.asarray(theta)),
                               rtol=1e-5)
    np.testing.assert_allclose(run.rbc_baseline(), jrun.rbc_baseline(), rtol=1e-6)

    eps = rng.randn(run.pop // 2, run.dim).astype(np.float32)
    eps = np.concatenate([eps, -eps])
    thetas = theta[None] + run.sigma * eps
    returns = run.episode_returns(torch.as_tensor(thetas)).numpy()
    want = np.array([jrun.eval_theta(jnp.asarray(t)) for t in thetas])
    np.testing.assert_allclose(returns, want, rtol=1e-5)

    # the update, the JAX example's expressions on the same eps and returns,
    # jitted as the example jits them; the gradient and optax.adam each
    # compiled on their own (in one program XLA folds the gradient's
    # 1 / sigma into adam's 1 - b1)
    @jax.jit
    def grad_fn(returns, eps):
        ranks = jnp.argsort(jnp.argsort(returns)).astype(jnp.float32)
        return -((ranks / (run.pop - 1) - 0.5)[:, None] * eps).mean(axis=0) / run.sigma

    optimizer = optax.adam(0.02)
    with jax.enable_x64(False):
        grad = grad_fn(jnp.asarray(returns), jnp.asarray(eps))
        updates, _ = jax.jit(optimizer.update)(grad, optimizer.init(jnp.asarray(theta)))
        want_theta = np.asarray(jax.jit(optax.apply_updates)(jnp.asarray(theta), updates))
    t = torch.tensor(theta, requires_grad=True)
    run.update(t, Adam([t], lr=0.02), torch.as_tensor(eps), torch.as_tensor(returns))
    np.testing.assert_array_equal(t.grad.numpy(), np.asarray(grad))
    np.testing.assert_array_equal(t.detach().numpy(), want_theta)


def test_es_run_and_ties():
    """A 2-generation run is finite and the rank shaping breaks ties by
    position (stable sorts): a population of equal returns shapes to the
    evenly spaced ranks."""
    run = build_es(scenario=0, pop=6, n_steps=20, device="cpu")
    theta, history = run(gens=2)
    assert theta.shape == (run.dim,) and len(history) == 2 and np.isfinite(history).all()
    t = torch.zeros(run.dim, requires_grad=True)
    eps = torch.eye(6, run.dim)
    run.update(t, torch.optim.SGD([t], lr=1.0), eps, torch.zeros(6))
    shaped = torch.arange(6.0) / 5 - 0.5
    np.testing.assert_allclose(t.detach()[:6].numpy(), (shaped / 6 / run.sigma).numpy(),
                               rtol=1e-6)
