"""Tests that need a CUDA card: the port's CUDA kernels against their plain
PyTorch versions, the suite's rollout and the batched envs' ``step()``
replaying a recorded CUDA graph against their eager loops, and the
all-scenario MPC's replayed solves against its eager ones.  They skip without a card; on a machine with one,
run ``python -m pytest tests/test_torch_cuda.py -m cuda``.  This file
imports nothing of JAX or the JAX package, so it runs where only the port
is installed."""
import warnings

import numpy as np
import pytest
import torch

import pymgrid_tpu_torch
from helpers.env_steps import STEP_CASES, actions_of, assert_same_steps, make_env, step_loop
from helpers.rollout_checks import assert_same_rollout
from pymgrid_tpu_torch import Microgrid
from pymgrid_tpu_torch.algos import SuiteMPC
from pymgrid_tpu_torch.core.params import tree_map
from pymgrid_tpu_torch.core.rollout import make_marginal_cost_policy
from pymgrid_tpu_torch.core.spec import extract_spec
from pymgrid_tpu_torch.ops import make_rbc_rollout
from pymgrid_tpu_torch.parallel import SuiteRunner
from pymgrid_tpu_torch.utils import cuda_graph
from pymgrid_tpu_torch.utils.profiling import span_totals, trace

pytestmark = pytest.mark.cuda

torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("scenario", [0, 1])
def test_rbc_rollout_kernel_matches_plain(cuda, scenario):
    n_steps, B = 500, 3000  # B not a multiple of the block: the ragged tail
    spec, params, _ = extract_spec(Microgrid.from_scenario(scenario), dtype=np.float32)
    pb = params["battery"]
    init = torch.linspace(float(pb["min_capacity"][0]), float(pb["max_capacity"][0]),
                          B, dtype=torch.float32, device=cuda)
    rollout = make_rbc_rollout(spec, params, n_steps, cuda)
    got = rollout(init)
    torch.cuda.synchronize()
    assert rollout.launches == 1
    want = rollout.plain(init)
    assert rollout.launches == 1
    # the kernel is built with --fmad=false and IEEE division in the plain
    # version's op order: bitwise
    assert torch.equal(got, want)


def test_rbc_rollout_unknown_variant_raises(cuda):
    spec, params, _ = extract_spec(Microgrid.from_scenario(0), dtype=np.float32)
    rollout = make_rbc_rollout(spec, params, 10, cuda)
    rollout.variant = 8   # no variant of the launcher's switch
    with pytest.raises(RuntimeError, match="unknown variant"):
        rollout(torch.zeros(4, device=cuda))
    assert rollout.launches == 0


def _short_series_suite(T=40, n_configs=3):
    """``n_configs`` microgrids on ``T``-row series, the second with a
    genset: episodes of at most ``T`` steps, so a 100-step rollout restarts
    every replica."""
    M = pymgrid_tpu_torch.modules
    rng = np.random.RandomState(0)
    mgs = []
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for c in range(n_configs):
            modules = [
                M.BatteryModule(min_capacity=10, max_capacity=100, max_charge=50,
                                max_discharge=50, efficiency=0.9,
                                battery_cost_cycle=0.02, init_soc=0.5),
                ("pv", M.RenewableModule(time_series=50 * rng.rand(T))),
                M.LoadModule(time_series=60 * rng.rand(T)),
                M.GridModule(max_import=40, max_export=100, time_series=rng.rand(T, 3)),
            ]
            if c == 1:
                modules.append(M.GensetModule(running_min_production=5,
                                              running_max_production=40, genset_cost=0.3))
            mgs.append(Microgrid(modules))
    return mgs


def _eager(monkeypatch, make):
    """``make()`` built to run eagerly on the card: its twin replays."""
    with monkeypatch.context() as patch:
        patch.setattr(cuda_graph, "available", lambda device: False)
        return make()


def _runners(cuda, monkeypatch, mgs, batch, start_dtype):
    """The same suite twice on the card: one replaying its recorded step,
    one held to the eager loop."""
    make = lambda: SuiteRunner(mgs, batch_per_config=batch, dtype="float32",  # noqa: E731
                               device=cuda, start_dtype=start_dtype)
    graphed, eager = make(), _eager(monkeypatch, make)
    assert graphed._graph_steps and not eager._graph_steps
    return graphed, eager


@pytest.mark.parametrize("mode", [
    dict(collect=True, randomize_initial_step=True, start_dtype=torch.int32),
    dict(collect=True, randomize_initial_step=True, start_dtype=torch.int64),
    dict(collect=False, randomize_initial_step=True, block_prefetch=False),
    dict(collect=True, randomize_initial_step=False),
    dict(collect=False, randomize_initial_step=False),
], ids=["collect-int32", "collect-int64", "throughput", "fixed-collect", "fixed-throughput"])
def test_graphed_suite_rollout_matches_eager(cuda, monkeypatch, mode):
    """Three configs of 40-row series x 16 replicas over 100 steps, every
    replica restarting: the rollout that replays one recorded step equals
    the eager loop bit for bit, in two rollouts in a row on other keys (the
    second loads its states into the recorded step's inputs)."""
    mode = dict(mode)
    start_dtype = mode.pop("start_dtype", torch.int64)
    graphed, eager = _runners(cuda, monkeypatch, _short_series_suite(), 16, start_dtype)
    policy = make_marginal_cost_policy(graphed.spec)
    fn = graphed.rollout_fn(policy, 100, auto_reset=True, **mode)
    want_fn = eager.rollout_fn(policy, 100, auto_reset=True, **mode)
    for seed in (3, 2**31 + 7):
        got = fn(graphed.params, graphed.make_keys(seed))
        want = want_fn(eager.params, eager.make_keys(seed))
        assert_same_rollout(got, want)
        if mode["collect"]:
            assert (want[1].done.sum(dim=-1) >= 2).all()   # every replica restarted
    assert len(graphed._graphs) == 1 and not eager._graphs


def test_graph_is_shared_across_lengths_and_recorded_again_for_other_params(cuda, monkeypatch,
                                                                            tmp_path):
    """The pymgrid25 suite's collect rollout, int32 restarts, 64 replicas a
    config, under the profiler: an 8-step and a 100-step rollout share one
    recording; a copy of the params (leaves elsewhere) records again, and
    both still equal the eager loop bitwise; each replay counts what the
    recorded step counted, and the recording's warm-up step nothing."""
    mgs = [Microgrid.from_scenario(n) for n in range(25)]
    graphed, eager = _runners(cuda, monkeypatch, mgs, 64, torch.int32)
    policy = make_marginal_cost_policy(graphed.spec)
    kw = dict(auto_reset=True, collect=True, randomize_initial_step=True)
    keys = graphed.make_keys(11)
    with trace(str(tmp_path / "a"), cuda):
        graphed.rollout_fn(policy, 8, **kw)(graphed.params, keys)
        got = graphed.rollout_fn(policy, 100, **kw)(graphed.params, keys)
    counters = span_totals()["counters"]
    assert counters["pymgrid.suite.graph_captures"] == 1
    assert counters["pymgrid.suite.graph_replays"] == 108
    assert counters["pymgrid.engine.fresh_states"] == 108 * 25 * 64
    assert_same_rollout(got, eager.rollout_fn(policy, 100, **kw)(eager.params, keys))

    params = tree_map(torch.clone, graphed.params)
    with trace(str(tmp_path / "b"), cuda):
        got = graphed.rollout_fn(policy, 100, **kw)(params, keys)
    assert span_totals()["counters"]["pymgrid.suite.graph_captures"] == 1
    assert_same_rollout(got, eager.rollout_fn(policy, 100, **kw)(eager.params, keys))


def _envs(cuda, monkeypatch, case, batch=64):
    """``case``'s env twice on the card: one replaying its recorded step,
    one held to the eager step."""
    graphed = make_env(case, batch, cuda)
    eager = _eager(monkeypatch, lambda: make_env(case, batch, cuda))
    assert graphed._graph_steps and not eager._graph_steps
    return graphed, eager


@pytest.mark.parametrize("case", STEP_CASES)
def test_replayed_env_step_matches_eager(cuda, monkeypatch, case):
    """120 ``step()`` calls of 64 replicas on 25-row series, every replica
    auto-resetting: the env replaying its recorded step returns the eager
    step's states and outputs bit for bit, at every step of the loop, each
    step's still as returned after the later steps (no buffer of the
    recording is handed out).  The discrete env with and without logs and
    from a shared step of shape ``(1,)``, the continuous env, and threefry
    gaussian forecasts (``rng`` and ``forecast`` in the states)."""
    graphed, eager = _envs(cuda, monkeypatch, case)
    for seed in (5, 2**31 + 9):
        assert_same_steps(step_loop(graphed, case, 120, seed),
                          step_loop(eager, case, 120, seed))
    assert len(graphed._graphs) == 1 and not eager._graphs


def test_env_step_records_once_per_signature(cuda, monkeypatch, tmp_path):
    """Under the profiler: 20 steps with logs and 10 without record once
    each, and every replayed step counts one ``graph_replays`` and its fresh
    states; a copy of the params records again; both equal the eager step.
    Actions that require grad run the eager step."""
    graphed, eager = _envs(cuda, monkeypatch, "discrete")
    with trace(str(tmp_path / "a"), cuda):
        got = step_loop(graphed, "discrete", 20, seed=7)
        got_lean = step_loop(graphed, "discrete-lean", 10, seed=8)
    counters = span_totals()["counters"]
    assert counters["pymgrid.env.graph_captures"] == 2
    assert counters["pymgrid.env.graph_replays"] == 30
    assert counters["pymgrid.engine.fresh_states"] == 30 * 64
    assert_same_steps(got, step_loop(eager, "discrete", 20, seed=7), every_replica_done=False)
    assert_same_steps(got_lean, step_loop(eager, "discrete-lean", 10, seed=8),
                      every_replica_done=False)

    graphed.params = tree_map(torch.clone, graphed.params)
    with trace(str(tmp_path / "b"), cuda):
        got = step_loop(graphed, "discrete", 20, seed=7)
    assert span_totals()["counters"]["pymgrid.env.graph_captures"] == 1
    assert len(graphed._graphs) == 1
    assert_same_steps(got, step_loop(eager, "discrete", 20, seed=7), every_replica_done=False)

    continuous, _ = _envs(cuda, monkeypatch, "continuous")
    states = continuous.reset()
    actions = actions_of(continuous, np.random.RandomState(4), 1)[0].requires_grad_()
    _, out = continuous.step(states, actions)
    assert out.reward.requires_grad and not continuous._graphs
    _, replayed = continuous.step(states, actions.detach())
    assert len(continuous._graphs) == 1
    assert torch.equal(replayed.reward, out.reward.detach())


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, tuple):
        return [x for v in tree for x in _leaves(v)]
    return [] if tree is None else [tree]


def test_replayed_suite_mpc_matches_eager(cuda, monkeypatch):
    """The 25 pymgrid25 scenarios at the benchmark cell's settings (float32
    box IPM, 60 iterations, 3-bit enumeration), 6 closed-loop hours from
    start hours drawn from a seed: the planner replaying its three recorded
    solves (relaxation, pattern chunk, final re-solve) plans and steps bit
    for bit as the eager one."""
    records = []
    capture = cuda_graph.Recording._capture
    monkeypatch.setattr(cuda_graph.Recording, "_capture",
                        lambda self: records.append(len(self.inputs[0])) or capture(self))
    mgs = [Microgrid.from_scenario(n) for n in range(25)]
    kw = dict(dtype="float32", device=cuda, solver_kind="box", newton_refine=2,
              matmul_precision="float32", enum_bits=3, enum_chunk=16)
    graphed = SuiteMPC(mgs, 60, **kw)
    eager = _eager(monkeypatch, lambda: SuiteMPC(mgs, 60, **kw))
    starts = np.random.default_rng(2**31 + 5).integers(0, graphed.n_steps_year - 48, size=25)
    got, want = graphed.reset(7, starts=starts), eager.reset(7, starts=starts)
    for _ in range(6):
        plans = graphed.plan(got), eager.plan(want)
        (got, got_out), (want, want_out) = graphed.act(got, plans[0]), eager.act(want, plans[1])
        a, b = _leaves((plans[0], got, got_out)), _leaves((plans[1], want, want_out))
        assert len(a) == len(b) > 0 and all(map(torch.equal, a, b))
    assert sorted(records) == [25, 25, 200]
