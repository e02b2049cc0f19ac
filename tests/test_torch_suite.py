"""The port's suite rollout against the JAX SuiteRunner (CPU, float64).

Both packages take the same call, ``fn(params, make_keys(seed))``, and draw
identical starts from the keys inside the rollout: the test recomputes the
JAX runner's starts from its keys (as
``tests/test_suite.py::test_randomized_initial_step_matches_shifted_host``
does), and the port's ``draw_initial_steps(make_keys(seed))`` must equal them
bitwise.  Collect-mode restarts draw from the replicas' split keys in both
packages, so their reward and done streams are compared bitwise.  Each
package builds its microgrids with its own host layer.  The throughput-mode
checksum ``acc + reward + obs.sum(-1)`` contains a reduction whose order
differs between the frameworks, so it is compared with JAX at rtol 1e-12;
reward streams are compared bitwise, and the port's block-prefetch rollout
is held bitwise against its own per-step rollout.
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
from pymgrid_tpu_torch.core.engine import make_reset_fn, needs_keys
from pymgrid_tpu_torch.core.rollout import make_marginal_cost_policy
from pymgrid_tpu_torch.parallel import suite as suite_module
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


@pytest.fixture
def block_gathers(monkeypatch):
    """Counts the block-prefetch rollout's row-window gathers: one per block
    of ``BLOCK`` steps, none on the per-step path."""
    calls = []
    gather = suite_module.gather_block

    def counted(table, steps):
        calls.append(tuple(steps.shape))
        return gather(table, steps)

    monkeypatch.setattr(suite_module, "gather_block", counted)
    return calls


def _compare_throughput_mode(make_mgs, B, n_steps, seed, jax_block_prefetch=False,
                             gathers=None):
    """``make_mgs(pkg)``: the configs, built by ``pkg``'s host layer.  The
    port's default rollout (blocked where eligible) against the JAX runner's
    with ``jax_block_prefetch``, and bitwise against the port's per-step
    rollout; ``gathers``, the :func:`block_gathers` record, must grow by one
    per block when the port's rollout runs blocked.  Returns ``(starts,
    whether the port ran blocked)``."""
    jrunner = JaxSuiteRunner(make_mgs(pymgrid_tpu), batch_per_config=B, dtype=np.float64)
    fn = jrunner.rollout_fn(
        jax_mc_policy(jrunner.spec), n_steps, auto_reset=True, collect=False,
        randomize_initial_step=True, block_prefetch=jax_block_prefetch,
    )
    keys = jrunner.make_keys(seed=seed)
    want = np.asarray(fn(jrunner.params, keys))
    starts = _jax_starts(jrunner, keys)

    runner = SuiteRunner(make_mgs(pymgrid_tpu_torch), batch_per_config=B, dtype="float64",
                         device="cpu")
    assert runner.max_start == min(
        m.ts_length for m in runner.spec.log_order if m.ts_length) - 1
    keys = runner.make_keys(seed)
    np.testing.assert_array_equal(runner.draw_initial_steps(keys).numpy(), starts)
    n_gathers = len(gathers) if gathers is not None else 0
    policy = make_marginal_cost_policy(runner.spec)
    kw = dict(auto_reset=True, collect=False, randomize_initial_step=True)
    ours = runner.rollout_fn(policy, n_steps, **kw)(runner.params, keys)
    blocked = gathers is not None and len(gathers) > n_gathers
    if blocked:
        assert len(gathers) - n_gathers == n_steps // suite_module.BLOCK
    per_step = runner.rollout_fn(policy, n_steps, block_prefetch=False, **kw)(runner.params,
                                                                               keys)
    assert torch.equal(ours, per_step)
    assert ours.shape == want.shape
    # rtol 1e-12: the per-step obs.sum(-1) is a reduction whose order is
    # framework-specific; everything else is bitwise
    np.testing.assert_allclose(ours.numpy(), want, rtol=1e-12)
    return starts, blocked


def test_suite_randomized_starts_match_jax():
    scenarios = (0, 1, 4, 22)
    starts, _ = _compare_throughput_mode(
        lambda pkg: [pkg.Microgrid.from_scenario(n) for n in scenarios],
        B=3, n_steps=24, seed=3,
    )
    assert len(np.unique(starts)) > 1


def _short_series_mgs(pkg=pymgrid_tpu_torch, T=40, n_configs=1, ts_kwargs=None,
                      forecaster=None):
    """``n_configs`` microgrids on a ``T``-row series; ``ts_kwargs`` go to
    each time-series module (e.g. ``final_step``, ``forecast_horizon``), or
    per config when a list."""
    M = pkg.modules
    rng = np.random.RandomState(0)
    per_config = ts_kwargs if isinstance(ts_kwargs, list) else [ts_kwargs or {}] * n_configs
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return [pkg.Microgrid([
            M.BatteryModule(min_capacity=10, max_capacity=100, max_charge=50,
                            max_discharge=50, efficiency=0.9,
                            battery_cost_cycle=0.02, init_soc=0.5),
            ("pv", M.RenewableModule(time_series=50 * rng.rand(T), **kw)),
            M.LoadModule(time_series=60 * rng.rand(T), **kw),
            M.GridModule(max_import=100, max_export=100,
                         time_series=rng.rand(T, 3), **kw),
        ]) for kw in per_config]


def _ending_at_max_start(horizon, forecaster="oracle"):
    """Episodes that end at ``max_start - 1`` (``final_step = T - 1``), the
    block-prefetch rollout's condition, with forecast windows of ``horizon``
    rows (the step table holds ``T - 1 + horizon`` rows and more)."""
    return dict(final_step=39, forecaster=forecaster, forecast_horizon=horizon)


def test_suite_sequential_wrap_matches_jax(block_gathers):
    """A 40-step series: every replica auto-resets repeatedly through the
    sequential wrap of the throughput mode.  Its episodes end at ``T - 1 =
    max_start``, past ``max_start - 1``, so the port runs its per-step
    rollout."""
    _, blocked = _compare_throughput_mode(_short_series_mgs, B=6, n_steps=160, seed=5,
                                          gathers=block_gathers)
    assert not blocked


def test_block_prefetch_across_the_wrap_matches_jax(block_gathers):
    """An eligible 40-step series (``final_step = T - 1``, horizons of 8, so
    the table holds the 8 rows past ``max_start``), 6 replicas x 160 steps:
    every replica wraps inside blocks and reads the patched rows.  The port
    runs blocked (20 block gathers), bitwise equal to its per-step rollout,
    and agrees with the JAX ``block_prefetch=True`` rollout at rtol 1e-12
    (the checksum's framework-specific reduction)."""
    make_mgs = lambda pkg: _short_series_mgs(pkg, ts_kwargs=_ending_at_max_start(8))  # noqa: E731
    runner = SuiteRunner(make_mgs(pymgrid_tpu_torch), batch_per_config=6, dtype="float64",
                         device="cpu")
    assert runner.params["step_table"].shape[1] >= runner.max_start + suite_module.BLOCK
    starts, blocked = _compare_throughput_mode(make_mgs, B=6, n_steps=160, seed=5,
                                               jax_block_prefetch=True, gathers=block_gathers)
    assert blocked
    # the first wrap falls inside a block (not on its boundary) for most replicas
    assert ((runner.max_start - starts) % suite_module.BLOCK != 0).sum() >= 3


@pytest.mark.parametrize("case", ["short_horizon", "mixed_final_steps"])
def test_block_prefetch_falls_back_where_jax_blocks_wrongly(case, block_gathers):
    """Two series on which the JAX runner's eligibility test passes but its
    blocked rollout reads the wrong rows: horizons of 2, so the table holds
    fewer than ``max_start + 8`` rows and the window gathers clamp; and two
    configs of which only one ends its episodes at ``max_start - 1`` (the
    JAX test takes the minimum over all configs).  The port runs its
    per-step rollout (no block gather) and equals the JAX
    ``block_prefetch=False`` rollout; the JAX blocked result is not the
    reference."""
    if case == "short_horizon":
        make_mgs = lambda pkg: _short_series_mgs(pkg, ts_kwargs=_ending_at_max_start(2))  # noqa: E731
    else:
        make_mgs = lambda pkg: _short_series_mgs(  # noqa: E731
            pkg, n_configs=2,
            ts_kwargs=[_ending_at_max_start(8), dict(forecaster="oracle", forecast_horizon=8)])
    _, blocked = _compare_throughput_mode(make_mgs, B=6, n_steps=160, seed=5,
                                          gathers=block_gathers)
    assert not blocked and not block_gathers


@pytest.mark.parametrize("forecaster", ["oracle", "gaussian"])
def test_block_prefetch_equals_per_step(forecaster, block_gathers):
    """The default (blocked) throughput rollout against ``block_prefetch=
    False``, bitwise in float64: pymgrid25 scenarios 0 and 1, 4 replicas x
    48 steps (6 block gathers), and an eligible short series with
    threefry-gaussian forecasts, whose keys ride through both paths."""
    if forecaster == "oracle":
        mgs = [pymgrid_tpu_torch.Microgrid.from_scenario(n) for n in (0, 1)]
    else:
        mgs = _short_series_mgs(ts_kwargs=_ending_at_max_start(8, forecaster=0.1))
    runner = SuiteRunner(mgs, batch_per_config=4, dtype="float64", device="cpu")
    assert needs_keys(runner.spec) == (forecaster == "gaussian")
    policy = make_marginal_cost_policy(runner.spec)
    kw = dict(auto_reset=True, collect=False, randomize_initial_step=True)
    keys = runner.make_keys(11)
    blocked = runner.rollout_fn(policy, 48, **kw)(runner.params, keys)
    assert len(block_gathers) == 48 // suite_module.BLOCK
    per_step = runner.rollout_fn(policy, 48, block_prefetch=False, **kw)(runner.params, keys)
    assert len(block_gathers) == 48 // suite_module.BLOCK
    assert torch.isfinite(blocked).all() and torch.equal(blocked, per_step)
    other = runner.rollout_fn(policy, 48, **kw)(runner.params, runner.make_keys(12))
    assert not torch.equal(other, blocked)


@pytest.mark.parametrize("mode", [
    dict(collect=True, randomize_initial_step=True),
    dict(randomize_initial_step=False),
    dict(auto_reset=False, randomize_initial_step=True),
])
def test_block_prefetch_needs_the_sequential_wrap(mode):
    """``block_prefetch=True`` outside the sequential-wrap throughput mode
    raises, as the JAX runner does."""
    runner = SuiteRunner(_short_series_mgs(), batch_per_config=2, dtype="float64",
                         device="cpu")
    with pytest.raises(ValueError, match="block_prefetch requires"):
        runner.rollout_fn(make_marginal_cost_policy(runner.spec), 8, block_prefetch=True,
                          **mode)


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


@pytest.fixture(scope="module")
def int32_runners(runner_pairs):
    """A port runner with ``start_dtype=torch.int32`` beside each JAX runner
    of :func:`runner_pairs`."""
    return [(jrunner, SuiteRunner(make_mgs(pymgrid_tpu_torch), batch_per_config=B,
                                  dtype="float64", device="cpu", start_dtype=torch.int32))
            for (jrunner, _), (make_mgs, B) in zip(runner_pairs, (
                (lambda pkg: [pkg.Microgrid.from_scenario(n) for n in range(25)], 3),
                (_short_series_mgs, 50)))]


@pytest.mark.parametrize("seed", [0, 1, 7, 2**31 - 1])
def test_int32_starts_match_jax_without_x64(seed, int32_runners):
    """``start_dtype=torch.int32``: the JAX runner's starts without
    ``jax_enable_x64`` (JAX's default int is then int32), bitwise, and not
    the x64 ones."""
    for jrunner, runner in int32_runners:
        starts = runner.draw_initial_steps(runner.make_keys(seed))
        assert starts.dtype == torch.int32
        with jax.enable_x64(False):
            want = _jax_starts(jrunner, jrunner.make_keys(seed))
        np.testing.assert_array_equal(starts.numpy(), want)
        assert not np.array_equal(want, _jax_starts(jrunner, jrunner.make_keys(seed)))


@pytest.mark.parametrize("start_dtype, want", [
    (torch.int32, [8422, 6244, 3381, 576, 2808, 1489, 5688, 5674]),
    (torch.int64, [4700, 2917, 7526, 6473, 1818, 2334, 3092, 8176]),
])
def test_start_width_draws(start_dtype, want):
    """Scenario 0 (starts in [0, 8759)), 8 replicas from ``make_keys(0)``:
    JAX's draws without and with ``jax_enable_x64``, as ``jax.random`` gives
    them."""
    runner = SuiteRunner([pymgrid_tpu_torch.Microgrid.from_scenario(0)], batch_per_config=8,
                         dtype="float32", device="cpu", start_dtype=start_dtype)
    assert runner.max_start == 8759
    assert runner.draw_initial_steps(runner.make_keys(0)).tolist() == [want]


def test_start_dtype_is_an_integer_width():
    with pytest.raises(ValueError, match="start_dtype"):
        SuiteRunner(_short_series_mgs(), batch_per_config=2, dtype="float32", device="cpu",
                    start_dtype=torch.float32)


def test_int32_collect_restarts_match_jax_without_x64():
    """A float32 collect rollout with randomized restarts and
    ``start_dtype=torch.int32``, 2 configs x 4 replicas of a 60-row series
    over 150 steps, against the JAX ``SuiteRunner`` without x64: the starts
    and the dones bitwise (every restart drawn as JAX draws it), rewards and
    observations at rtol 1e-5 (float32); the int64 draw restarts
    elsewhere."""
    B, n_steps, seed = 4, 150, 11
    make_mgs = lambda pkg: _short_series_mgs(pkg, T=60, n_configs=2)  # noqa: E731
    with jax.enable_x64(False):
        jrunner = JaxSuiteRunner(make_mgs(pymgrid_tpu), batch_per_config=B, dtype=np.float32)
        jfn = jrunner.rollout_fn(jax_mc_policy(jrunner.spec), n_steps, auto_reset=True,
                                 collect=True, randomize_initial_step=True)
        jkeys = jrunner.make_keys(seed=seed)
        jacc, jouts = jfn(jrunner.params, jkeys)
        want_starts = _jax_starts(jrunner, jkeys)

    def run(start_dtype):
        runner = SuiteRunner(make_mgs(pymgrid_tpu_torch), batch_per_config=B,
                             dtype="float32", device="cpu", start_dtype=start_dtype)
        keys = runner.make_keys(seed)
        fn = runner.rollout_fn(make_marginal_cost_policy(runner.spec), n_steps,
                               auto_reset=True, collect=True, randomize_initial_step=True)
        return runner.draw_initial_steps(keys), fn(runner.params, keys)

    starts, (acc, outs) = run(torch.int32)
    np.testing.assert_array_equal(starts.numpy(), want_starts)
    dones = outs.done.numpy()
    assert (dones.sum(axis=-1) >= 2).all()  # every replica restarted inside the horizon
    np.testing.assert_array_equal(dones, np.asarray(jouts.done))
    np.testing.assert_allclose(outs.reward.numpy(), np.asarray(jouts.reward), rtol=1e-5)
    np.testing.assert_allclose(outs.obs.numpy(), np.asarray(jouts.obs), rtol=1e-5)
    np.testing.assert_allclose(acc.numpy(), np.asarray(jacc), rtol=1e-5)
    _, (_, outs64) = run(torch.int64)
    assert not np.array_equal(outs64.done.numpy(), dones)


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
    _, outs = fn(runner.params, keys)
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
    """The rollout takes ``(params, keys)`` and draws its starts from the
    keys: the old call with a ``(C, B)`` start tensor, and keys of any other
    shape, raise a ``ValueError`` that names ``make_keys``.  Keys ride in the
    state only where the rollout draws: a keyless throughput rollout's
    policy sees no ``rng``, a collect rollout with randomized restarts'
    does."""
    runner = SuiteRunner(_short_series_mgs(), batch_per_config=2, dtype="float64",
                         device="cpu")
    policy = make_marginal_cost_policy(runner.spec)
    keys = runner.make_keys(5)
    seen = []

    def watching(params, state):
        seen.append("rng" in state)
        return policy(params, state)

    for collect in (True, False):
        fn = runner.rollout_fn(watching, 3, auto_reset=True, collect=collect,
                               randomize_initial_step=True)
        for wrong in (runner.draw_initial_steps(keys), keys[:, :1], keys[..., 0]):
            with pytest.raises(ValueError, match="make_keys"):
                fn(runner.params, wrong)
        out = fn(runner.params, keys)
        acc = out[0] if collect else out
        assert acc.shape == (1, 2) and torch.isfinite(acc).all()
    assert seen == [True] * 3 + [False] * 3
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
                                  randomize_initial_step=True)(runner.params, keys)
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
    acc, outs = fn(runner.params, runner.make_keys(0))   # every start at initial_step
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
