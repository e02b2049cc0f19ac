"""The port's training programs draw JAX's threefry draws: ``prng.gumbel`` and
``prng.categorical`` against ``jax.random``, and seeded A2C and ES runs
against the JAX examples (CPU, float32).

The JAX examples run without ``jax_enable_x64`` (their ``main`` never turns
it on), so they are held here inside ``jax.enable_x64(False)``.

Tolerances: the integer draws (keys, categorical samples), float32 gumbels,
``init_theta``, ``theta0`` and ES's noise exactly (the port's ``log`` and
``log1p`` are XLA's); float64 gumbels within 2 ulps of ``max(1, |g|)``
(float64 ``log`` is ``torch.log`` against libm's).  Both sides take
``optax.adam``'s steps bit for bit (``pymgrid_tpu_torch.utils.optax_adam``).
A2C's history at rtol 1e-6 (measured 2.0e-7: the gradients sum in other
orders).  ES's gradient is the JAX program's bit for bit given the same
returns, and its history at rtol 1e-6 (measured 0); its parameters after
two generations within 1e-6 of the learning rate (measured 7.5e-9, 3.7e-7
of it, an ulp of the largest entries): compiled as one program, XLA folds
the gradient's ``1 / sigma`` into Adam's ``1 - b1`` (``x * 2`` in place of
``(x * 20) * 0.1``), which the port's first moment rounds in two steps.
The logits and returns also come from sums in other orders,
so a sample or a rank can flip on a near-tie: each test first asserts that
the margin of every draw it makes (the gap between the two best ``logits +
gumbel``, the smallest gap between distinct returns) is wider than the
tolerance: a failure of the margin is a tie, a failure after it a fault.
"""
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pymgrid_tpu_torch.core import prng
from pymgrid_tpu_torch.examples import train_rl
from pymgrid_tpu_torch.examples.train_es import build_es
from pymgrid_tpu_torch.examples.train_rl import build_training, theta_to_numpy

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from examples.train_es import build_es as jax_build_es  # noqa: E402
from examples.train_rl import build_training as jax_build_training  # noqa: E402

torch.set_num_threads(1)

MARGIN = 1e-5   # a draw's margin must exceed this for the draw to be compared


def _keys(seed, n):
    """``split(PRNGKey(seed), n)`` from JAX and as the port's int64 keys."""
    keys = jax.random.split(jax.random.PRNGKey(seed), n)
    return keys, torch.as_tensor(np.asarray(keys).astype(np.int64))


def _top2_gap(scores):
    """The gap between the best and the second best entry of each row."""
    top = np.sort(np.asarray(scores), axis=-1)
    return top[..., -1] - top[..., -2]


@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["float32", "float64"])
def test_gumbel_matches_jax(dtype):
    """``prng.gumbel`` equals ``jax.random.gumbel`` (mode ``"low"``) over
    300 keys x 7 draws: its uniforms bitwise, float32 gumbels bitwise,
    float64 ones within 2 ulps of ``max(1, |g|)`` (the two float64 ``log``
    evaluations differ in the last bit)."""
    jkeys, keys = _keys(7, 300)
    with jax.enable_x64(dtype == np.float64):
        want = np.asarray(jax.vmap(lambda k: jax.random.gumbel(k, (7,), dtype))(jkeys))
        tiny = np.finfo(dtype).tiny
        want_u = np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (7,), dtype, tiny))(jkeys))
    tdt = torch.float32 if dtype == np.float32 else torch.float64
    u = prng.uniform(keys, (7,), tdt, tiny, np.array(1.0, dtype)).numpy()
    np.testing.assert_array_equal(u, want_u)
    got = prng.gumbel(keys, (7,), tdt).numpy()
    assert got.dtype == dtype and got.shape == (300, 7)
    if dtype == np.float32:
        np.testing.assert_array_equal(got, want)
    eps = np.finfo(dtype).eps
    assert np.all(np.abs(got - want) <= 2 * eps * np.maximum(1.0, np.abs(want)))


def test_categorical_matches_vmapped_jax():
    """``prng.categorical`` over 300 keys and rows of 5 float32 logits
    equals ``jax.vmap(jax.random.categorical)`` exactly, every row's
    margin wider than the gumbels' gap to JAX's."""
    jkeys, keys = _keys(11, 300)
    logits = (2.0 * np.random.RandomState(0).randn(300, 5)).astype(np.float32)
    with jax.enable_x64(False):
        want = np.asarray(jax.vmap(jax.random.categorical)(jkeys, jnp.asarray(logits)))
        scores = jax.vmap(lambda k, l: jax.random.gumbel(k, (5,), jnp.float32) + l)(
            jkeys, jnp.asarray(logits))
    assert _top2_gap(scores).min() > MARGIN
    got = prng.categorical(keys, torch.as_tensor(logits))
    assert got.shape == (300,)
    np.testing.assert_array_equal(got.numpy(), want)
    # a batch axis before the replicas, as the engine's (C, B) keys
    got2 = prng.categorical(keys.view(3, 100, 2), torch.as_tensor(logits).view(3, 100, 5))
    np.testing.assert_array_equal(got2.numpy().reshape(-1), want)


def _a2c_margins(monkeypatch):
    """Record the margin of every categorical draw the port's A2C makes."""
    gaps = []
    categorical = prng.categorical

    def recorded(keys, logits):
        gaps.append(_top2_gap(prng.gumbel(keys, logits.shape[-1:], logits.dtype) + logits))
        return categorical(keys, logits)

    monkeypatch.setattr(train_rl.prng, "categorical", recorded)
    return gaps


def test_a2c_seeded_run_is_the_jax_run(monkeypatch):
    """Scenario 0, batch 16, rollout 8, seed 0: ``init_theta`` equals the
    JAX ``init_theta(PRNGKey(0))`` (the JAX ``run(iters=0)``) bitwise,
    and ``run(iters=2)``'s history the JAX example's at rtol 1e-6, every
    sampled action's margin wider than ``MARGIN``."""
    kw = dict(scenario=0, batch=16, rollout_len=8)
    with jax.enable_x64(False):
        jrun = jax_build_training(**kw)
        jtheta, _, _ = jrun(iters=0)
        _, _, jhistory = jrun(iters=2, log_every=1)
    run = build_training(**kw, device="cpu")
    theta = theta_to_numpy(run.init_theta(seed=0))
    for head in ("policy", "value"):
        for got, want in zip(theta[head], jtheta[head], strict=True):
            np.testing.assert_array_equal(got["w"], np.asarray(want["w"]))
            np.testing.assert_array_equal(got["b"], np.asarray(want["b"]))

    gaps = _a2c_margins(monkeypatch)
    _, _, history = run(iters=2)
    assert len(gaps) == 2 * 8 and all(g.shape == (16,) for g in gaps)
    assert min(g.min() for g in gaps) > MARGIN
    np.testing.assert_allclose(history, jhistory, rtol=1e-6)


def test_a2c_rollout_keys_are_the_jax_runs():
    """The carried rollout keys: rows of ``split(fold_in(key, 2), batch)``,
    a rank's rows of the global batch, folded with the iteration index."""
    run = build_training(scenario=0, batch=8, rollout_len=2, device="cpu")
    want = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(3), 2), 8)
    np.testing.assert_array_equal(run.rollout_keys(3).numpy(), np.asarray(want))
    folded = jax.vmap(lambda k: jax.random.fold_in(k, np.int32(1)))(want)
    np.testing.assert_array_equal(prng.fold_in(run.rollout_keys(3), 1).numpy(),
                                  np.asarray(folded))


def test_a2c_env_keys_are_the_jax_runs(monkeypatch):
    """Where the spec draws gaussian forecasts, each replica resets with its
    row of ``split(fold_in(key, 1), batch)`` and the start step splits it,
    as the JAX ``init_envs``; a rank of a 2-rank mesh holds its rows.  (No
    packaged scenario draws them, so the test says the spec does.)"""
    from pymgrid_tpu_torch.parallel import BatchMesh

    monkeypatch.setattr(train_rl, "needs_keys", lambda spec: True)
    env_keys = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(3), 1), 8)
    want = np.asarray(jax.vmap(lambda k: jax.random.split(k)[0])(env_keys))
    run = build_training(scenario=0, batch=8, rollout_len=2, device="cpu")
    np.testing.assert_array_equal(run.init_envs(seed=3)[0]["rng"].numpy(), want)
    rank1 = build_training(scenario=0, batch=8, rollout_len=2,
                           mesh=BatchMesh(2, 1, torch.device("cpu")))
    np.testing.assert_array_equal(rank1.init_envs(seed=3)[0]["rng"].numpy(), want[4:])
    monkeypatch.undo()
    assert "rng" not in run.init_envs(seed=3)[0]


def _es_margins(run):
    """Record every generation's returns of the port's ES ``run``."""
    returns = []
    generation = run.generation
    run.generation = lambda *args: returns.append(generation(*args)) or returns[-1]
    return returns


@pytest.mark.parametrize("continuous", [False, True], ids=["discrete", "continuous"])
def test_es_seeded_run_is_the_jax_run(continuous):
    """Population 8, 100 steps, seed 0: ``theta0`` (the JAX ``run(gens=0)``)
    and the first generation's noise bitwise, and a 2-generation run's
    history at rtol 1e-6 and parameters within 1e-6 of the learning rate
    (module docstring).  Ranks: equal returns tie on both
    sides (the same actions give the same sums) and stable sorts break them
    by position; every gap between distinct returns exceeds ``MARGIN`` of
    their scale."""
    kw = dict(scenario=0, pop=8, n_steps=100, continuous=continuous)
    with jax.enable_x64(False):
        jrun = jax_build_es(**kw)
        jtheta0, _ = jrun(gens=0)
        jtheta, jhistory = jrun(gens=2, log_every=100)
        jeps = jax.random.normal(jax.random.fold_in(jax.random.PRNGKey(0), 1000),
                                 (4, jrun.dim), jnp.float32)
    run = build_es(**kw, device="cpu")
    np.testing.assert_array_equal(run.initial_theta(0).numpy(), np.asarray(jtheta0))
    eps = run.noise(prng.fold_in(prng.key(0), 1000)).numpy()
    assert eps.shape == (8, run.dim)
    np.testing.assert_array_equal(eps[:4], np.asarray(jeps))
    np.testing.assert_array_equal(eps[4:], -eps[:4])

    returns = _es_margins(run)
    theta, history = run(gens=2, log_every=100)
    assert len(returns) == 2
    for r in returns:
        r = np.sort(r.numpy().astype(np.float64))
        gaps = np.diff(r)
        assert np.all(gaps[gaps > 0] > MARGIN * np.abs(r).max())
    np.testing.assert_allclose(history, jhistory, rtol=1e-6)
    np.testing.assert_allclose(theta.numpy(), np.asarray(jtheta), rtol=0, atol=1e-6 * run.lr)
