"""The batched envs' step loops shared by the CPU tests and the card tests
of the recorded ``step()``; imports nothing of JAX.

Each case is an env on 25-row series, so a loop of 120 steps auto-resets
every replica several times, and a way to start and act on it."""
import numpy as np
import torch

import pymgrid_tpu_torch.modules as M
from helpers.factories import build_microgrid, module_params
from pymgrid_tpu_torch.envs import ContinuousMicrogridEnv, DiscreteMicrogridEnv
from pymgrid_tpu_torch.parallel import BatchedContinuousEnv, BatchedDiscreteEnv

STEP_CASES = ["discrete", "discrete-lean", "shared-step", "continuous", "gaussian"]


def make_env(case, batch, device, dtype="float32"):
    """``case``'s env: the discrete env (its step with and without logs, and
    from a ``shared_step`` rollout's states, whose step has shape ``(1,)``),
    the continuous env, and a discrete env with threefry-gaussian forecasts
    (states carry ``rng`` and ``forecast``)."""
    gaussian = dict(forecaster=0.5, forecast_horizon=4) if case == "gaussian" else {}
    mods, _ = build_microgrid(M, module_params(seed=13, timesteps=25, **gaussian))
    if case == "continuous":
        return BatchedContinuousEnv(ContinuousMicrogridEnv(mods), batch, dtype, device=device)
    return BatchedDiscreteEnv(DiscreteMicrogridEnv(mods), batch, dtype, device=device)


def actions_of(env, rng, n_steps):
    """``n_steps`` actions for every replica, on the env's device."""
    if isinstance(env, BatchedContinuousEnv):
        acts = rng.rand(n_steps, env.batch_size, env.action_dim)
        return torch.as_tensor(acts, dtype=env.dtype, device=env.device)
    acts = rng.randint(env.n_actions, size=(n_steps, env.batch_size))
    return torch.as_tensor(acts, device=env.device)


def step_loop(env, case, n_steps, seed):
    """``n_steps`` ``step()`` calls from ``reset(seed)`` (after a 3-step
    ``shared_step`` rollout for that case): every call's returned
    ``(states, out)``, kept as returned."""
    actions = actions_of(env, np.random.RandomState(seed), n_steps + 3)
    states = env.reset(seed=seed)
    if case == "shared-step":
        states, _ = env.rollout(states, actions[:3], shared_step=True)
        assert states["step"].shape == (1,)
    keep_logs = case != "discrete-lean"
    kept = []
    for a in actions[3:]:
        states, out = env.step(states, a, keep_logs=keep_logs)
        kept.append((states, out))
    return kept


def leaves(tree):
    """The tensors of nested dicts and tuples, dict keys in sorted order;
    ``None`` has none."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, tuple):
        return [x for v in tree for x in leaves(v)]
    return [] if tree is None else [tree]


def assert_same_steps(got, want, every_replica_done=True):
    """Two step loops' returns equal step by step: the same leaves, each of
    one dtype, shape and bits; and (unless told otherwise) every replica was
    done at least twice."""
    for t, (a, b) in enumerate(zip(got, want, strict=True)):
        assert sorted(a[0]) == sorted(b[0])
        assert [f is None for f in a[1]] == [f is None for f in b[1]]
        for x, y in zip(leaves(a), leaves(b), strict=True):
            assert (x.dtype, x.shape) == (y.dtype, y.shape), f"step {t}"
            assert torch.equal(x, y), f"step {t}"
    if every_replica_done:
        done = torch.stack([out.done for _, out in want])
        assert (done.sum(dim=0) >= 2).all()
