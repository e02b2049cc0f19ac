"""The port's suite rollout against the JAX SuiteRunner (CPU, float64).

Both packages draw identical starts from the same seed: the JAX runner draws
them from its keys inside its rollout, the test recomputes them from the same
keys (as ``tests/test_suite.py::test_randomized_initial_step_matches_shifted_host``
does), and the port's ``draw_initial_steps(make_keys(seed))`` must equal them
bitwise.  Collect-mode restarts draw from the replicas' split keys in both
packages, so their reward and done streams are compared bitwise.  Each
package builds its microgrids with
its own host layer.  The throughput-mode checksum
``acc + reward + obs.sum(-1)`` contains a reduction whose order differs
between the frameworks, so it is compared at rtol 1e-12; reward streams are
compared bitwise.
"""
import dataclasses
import warnings
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import pymgrid_tpu
import pymgrid_tpu_torch
from pymgrid_tpu.core.rollout import make_marginal_cost_policy as jax_mc_policy
from pymgrid_tpu.parallel.suite import SuiteRunner as JaxSuiteRunner
from pymgrid_tpu_torch.core import prng
from pymgrid_tpu_torch.core import rollout as tro
from pymgrid_tpu_torch.core.engine import make_reset_fn
from pymgrid_tpu_torch.core.rollout import make_marginal_cost_policy
from pymgrid_tpu_torch.parallel.suite import SuiteRunner

torch.set_num_threads(1)

FIXTURE = Path(__file__).parent / "fixtures" / "golden_rbc.npz"


def _jax_starts(runner, keys):
    ts_lengths = [m.ts_length for m in runner.spec.log_order if m.ts_length]
    max_start = min(ts_lengths) - 1
    i0 = np.asarray(runner.params["initial_step"]).reshape(-1)
    return np.array([
        [int(jax.random.randint(jax.random.fold_in(keys[c, b], 0x51A7), (),
                                int(i0[c]), max_start))
         for b in range(keys.shape[1])]
        for c in range(keys.shape[0])
    ], dtype=np.int32)


def _compare_throughput_mode(make_mgs, B, n_steps, seed):
    """``make_mgs(pkg)``: the configs, built by ``pkg``'s host layer."""
    jrunner = JaxSuiteRunner(make_mgs(pymgrid_tpu), batch_per_config=B, dtype=np.float64)
    fn = jrunner.rollout_fn(
        jax_mc_policy(jrunner.spec), n_steps, auto_reset=True, collect=False,
        randomize_initial_step=True, block_prefetch=False,
    )
    keys = jrunner.make_keys(seed=seed)
    want = np.asarray(fn(jrunner.params, keys))
    starts = _jax_starts(jrunner, keys)

    runner = SuiteRunner(make_mgs(pymgrid_tpu_torch), batch_per_config=B, dtype="float64",
                         device="cpu")
    assert runner.max_start == min(
        m.ts_length for m in runner.spec.log_order if m.ts_length) - 1
    ours_starts = runner.draw_initial_steps(runner.make_keys(seed))
    np.testing.assert_array_equal(ours_starts.numpy(), starts)
    ours = runner.rollout_fn(
        make_marginal_cost_policy(runner.spec), n_steps, auto_reset=True,
        collect=False, randomize_initial_step=True,
    )(runner.params, ours_starts)
    assert ours.shape == want.shape
    # rtol 1e-12: the per-step obs.sum(-1) is a reduction whose order is
    # framework-specific; everything else is bitwise
    np.testing.assert_allclose(ours.numpy(), want, rtol=1e-12)
    return starts


def test_suite_randomized_starts_match_jax():
    scenarios = (0, 1, 4, 22)
    starts = _compare_throughput_mode(
        lambda pkg: [pkg.Microgrid.from_scenario(n) for n in scenarios],
        B=3, n_steps=24, seed=3,
    )
    assert len(np.unique(starts)) > 1


def _short_series_mgs(pkg=pymgrid_tpu_torch, T=40, n_configs=1):
    M = pkg.modules
    rng = np.random.RandomState(0)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return [pkg.Microgrid([
            M.BatteryModule(min_capacity=10, max_capacity=100, max_charge=50,
                            max_discharge=50, efficiency=0.9,
                            battery_cost_cycle=0.02, init_soc=0.5),
            ("pv", M.RenewableModule(time_series=50 * rng.rand(T))),
            M.LoadModule(time_series=60 * rng.rand(T)),
            M.GridModule(max_import=100, max_export=100,
                         time_series=rng.rand(T, 3)),
        ]) for _ in range(n_configs)]


def test_suite_sequential_wrap_matches_jax():
    """A 40-step series: every replica auto-resets repeatedly through the
    sequential wrap of the throughput mode."""
    _compare_throughput_mode(_short_series_mgs, B=6, n_steps=160, seed=5)


@pytest.fixture(scope="module")
def runner_pairs():
    """(JAX runner, port runner) on the 25 pymgrid25 configs (8758 possible
    starts) and on a 40-step series, built once for the seeds below."""
    return [
        (JaxSuiteRunner(make_mgs(pymgrid_tpu), batch_per_config=B, dtype=np.float64),
         SuiteRunner(make_mgs(pymgrid_tpu_torch), batch_per_config=B, dtype="float64",
                     device="cpu"))
        for make_mgs, B in (
            (lambda pkg: [pkg.Microgrid.from_scenario(n) for n in range(25)], 3),
            (_short_series_mgs, 50),
        )
    ]


@pytest.mark.parametrize("seed", [0, 1, 7, 2**31 - 1])
def test_draw_initial_steps_match_jax(seed, runner_pairs):
    """``draw_initial_steps(make_keys(seed))``: the JAX runner's starts,
    recomputed from its keys with ``jax.random``, bitwise."""
    for jrunner, runner in runner_pairs:
        keys = runner.make_keys(seed)
        np.testing.assert_array_equal(keys.numpy(),
                                      np.asarray(jrunner.make_keys(seed)).astype(np.int64))
        starts = runner.draw_initial_steps(keys)
        assert starts.dtype == torch.int32
        np.testing.assert_array_equal(starts.numpy(),
                                      _jax_starts(jrunner, jrunner.make_keys(seed)))


def test_suite_randomized_collect_resets():
    """collect=True with randomized auto-resets: each finished replica
    restarts at the start drawn from its split key (the step's new ``rng``,
    ``split(rng)[0]``), and every episode's reward stream equals a plain
    rollout from that start."""
    B, n_steps = 3, 100
    runner = SuiteRunner(_short_series_mgs(), batch_per_config=B,
                         dtype="float64", device="cpu")
    policy = make_marginal_cost_policy(runner.spec)
    keys = runner.make_keys(7)
    starts = runner.draw_initial_steps(keys)
    fn = runner.rollout_fn(policy, n_steps, auto_reset=True, collect=True,
                           randomize_initial_step=True)
    _, outs = fn(runner.params, starts, keys)
    rewards, dones = outs.reward[0].numpy(), outs.done[0].numpy()

    # replay the draws: the starts, then one draw per step from the split keys
    draws, rng = [starts[0].numpy()], keys
    for _ in range(n_steps):
        rng = prng.split(rng)[..., 0, :]
        draws.append(runner.draw_initial_steps(rng)[0].numpy())
    episodes = []  # (replica, first step, length, start)
    for b in range(B):
        first, start = 0, int(draws[0][b])
        for k in np.flatnonzero(dones[b]):
            episodes.append((b, first, k + 1 - first, start))
            first, start = k + 1, int(draws[k + 1][b])
        if first < n_steps:
            episodes.append((b, first, n_steps - first, start))
    assert len(episodes) > 2 * B  # every replica restarted more than once
    assert len({e[3] for e in episodes}) > B

    plain = tro.make_rollout_fn(runner.spec, policy, max(e[2] for e in episodes),
                                collect=False)
    ep_starts = torch.tensor([[e[3] for e in episodes]], dtype=torch.int32)
    _, (want, _) = plain(runner.params, make_reset_fn(runner.spec)(runner.params, ep_starts))
    for i, (b, first, length, start) in enumerate(episodes):
        np.testing.assert_array_equal(rewards[b, first:first + length],
                                      want[:length, 0, i].numpy(),
                                      err_msg=f"replica {b} from step {first}")


def test_suite_drawing_rollout_needs_the_keys():
    """A collect rollout with randomized restarts draws from the keys of
    its starts: without them it raises instead of drawing from another
    seed's chain; a throughput rollout needs none."""
    runner = SuiteRunner(_short_series_mgs(), batch_per_config=2, dtype="float64",
                         device="cpu")
    policy = make_marginal_cost_policy(runner.spec)
    starts = runner.draw_initial_steps(runner.make_keys(5))
    fn = runner.rollout_fn(policy, 3, auto_reset=True, collect=True,
                           randomize_initial_step=True)
    with pytest.raises(ValueError, match="make_keys"):
        fn(runner.params, starts)
    acc = runner.rollout_fn(policy, 3, auto_reset=True, collect=False,
                            randomize_initial_step=True)(runner.params, starts)
    assert acc.shape == (1, 2) and torch.isfinite(acc).all()


def test_suite_randomized_collect_matches_jax():
    """A float64 collect rollout with randomized restarts, 2 configs x 4
    replicas of a 60-row series over 150 steps (every replica restarts at
    least twice), against the JAX ``SuiteRunner``: the starts, the dones and
    the reward streams bitwise, the observations and the checksum at rtol
    1e-12 (a reduction whose order is framework-specific)."""
    B, n_steps, seed = 4, 150, 11
    make_mgs = lambda pkg: _short_series_mgs(pkg, T=60, n_configs=2)  # noqa: E731
    jrunner = JaxSuiteRunner(make_mgs(pymgrid_tpu), batch_per_config=B, dtype=np.float64)
    jfn = jrunner.rollout_fn(jax_mc_policy(jrunner.spec), n_steps, auto_reset=True,
                             collect=True, randomize_initial_step=True)
    jkeys = jrunner.make_keys(seed=seed)
    jacc, jouts = jfn(jrunner.params, jkeys)

    runner = SuiteRunner(make_mgs(pymgrid_tpu_torch), batch_per_config=B, dtype="float64",
                         device="cpu")
    keys = runner.make_keys(seed)
    starts = runner.draw_initial_steps(keys)
    np.testing.assert_array_equal(starts.numpy(), _jax_starts(jrunner, jkeys))
    acc, outs = runner.rollout_fn(make_marginal_cost_policy(runner.spec), n_steps,
                                  auto_reset=True, collect=True,
                                  randomize_initial_step=True)(runner.params, starts, keys)
    dones = outs.done.numpy()
    assert (dones.sum(axis=-1) >= 2).all()  # every replica restarted inside the horizon
    np.testing.assert_array_equal(dones, np.asarray(jouts.done))
    np.testing.assert_array_equal(outs.reward.numpy(), np.asarray(jouts.reward))
    np.testing.assert_allclose(outs.obs.numpy(), np.asarray(jouts.obs), rtol=1e-12)
    np.testing.assert_allclose(acc.numpy(), np.asarray(jacc), rtol=1e-12)


def test_suite_collect_matches_golden_all_scenarios():
    """``collect=True`` reward streams of all 25 configs in one batch equal
    the reference RBC streams bitwise (the golden fixture, which the JAX
    package's run_compiled reproduces: tests/test_golden_year.py)."""
    n_steps = 40
    runner = SuiteRunner(
        [pymgrid_tpu_torch.Microgrid.from_scenario(n) for n in range(25)],
        batch_per_config=1, dtype="float64", device="cpu",
    )
    fn = runner.rollout_fn(make_marginal_cost_policy(runner.spec), n_steps,
                           auto_reset=False, collect=True)
    acc, outs = fn(runner.params, runner.fixed_initial_steps())
    assert outs.reward.shape == (25, 1, n_steps)
    assert outs.obs.shape == (25, 1, n_steps, runner.spec.obs_dim)
    assert outs.log_row.shape == (25, 1, n_steps, runner.spec.n_log_fields)
    assert torch.isfinite(acc).all()
    with np.load(FIXTURE) as golden:
        for n in range(25):
            np.testing.assert_array_equal(
                outs.reward[n, 0].numpy(),
                golden[f"scenario_{n}_reward"][:n_steps],
                err_msg=f"scenario {n}",
            )


@pytest.mark.parametrize("include_genset", [False, True])
def test_build_suite_include_genset_matches_jax(include_genset):
    """``build_suite(..., include_genset=)`` against the JAX ``build_suite``
    on scenario 0 (no genset): the same spec, and every JAX params leaf
    bitwise in the port's (which also carries its step tables)."""
    from pymgrid_tpu.parallel.suite import build_suite as jax_build_suite
    from pymgrid_tpu_torch.parallel.suite import build_suite

    jspec, jparams = jax_build_suite([pymgrid_tpu.Microgrid.from_scenario(0)],
                                     dtype=np.float64, include_genset=include_genset)
    spec, params = build_suite([pymgrid_tpu_torch.Microgrid.from_scenario(0)], "float64",
                               "cpu", include_genset=include_genset)
    assert dataclasses.astuple(spec) == dataclasses.astuple(jspec)
    assert spec.n_genset == (1 if include_genset else 0)

    def compare(want, got, path):
        if isinstance(want, dict):
            for k in want:
                compare(want[k], got[k], path + (k,))
            return
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=str(path))

    compare(jparams, params, ())
