"""Tests that need a CUDA card: the port's CUDA kernels against their plain
PyTorch versions, and the suite's rollout replaying a recorded CUDA graph
against its eager loop.  They skip without a card; on a machine with one,
run ``python -m pytest tests/test_torch_cuda.py -m cuda``.  This file
imports nothing of JAX or the JAX package, so it runs where only the port
is installed."""
import warnings

import numpy as np
import pytest
import torch

import pymgrid_tpu_torch
from helpers.rollout_checks import assert_same_rollout
from pymgrid_tpu_torch import Microgrid
from pymgrid_tpu_torch.core.params import tree_map
from pymgrid_tpu_torch.core.rollout import make_marginal_cost_policy
from pymgrid_tpu_torch.core.spec import extract_spec
from pymgrid_tpu_torch.ops import make_rbc_rollout
from pymgrid_tpu_torch.parallel import SuiteRunner
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


def _runners(cuda, mgs, batch, start_dtype):
    """The same suite twice on the card: one replaying its recorded step,
    one held to the eager loop."""
    graphed, eager = (SuiteRunner(mgs, batch_per_config=batch, dtype="float32", device=cuda,
                                  start_dtype=start_dtype) for _ in range(2))
    assert graphed._graph_steps
    eager._graph_steps = False
    return graphed, eager


@pytest.mark.parametrize("mode", [
    dict(collect=True, randomize_initial_step=True, start_dtype=torch.int32),
    dict(collect=True, randomize_initial_step=True, start_dtype=torch.int64),
    dict(collect=False, randomize_initial_step=True, block_prefetch=False),
    dict(collect=True, randomize_initial_step=False),
    dict(collect=False, randomize_initial_step=False),
], ids=["collect-int32", "collect-int64", "throughput", "fixed-collect", "fixed-throughput"])
def test_graphed_suite_rollout_matches_eager(cuda, mode):
    """Three configs of 40-row series x 16 replicas over 100 steps, every
    replica restarting: the rollout that replays one recorded step equals
    the eager loop bit for bit, in two rollouts in a row on other keys (the
    second loads its states into the recorded step's inputs)."""
    mode = dict(mode)
    start_dtype = mode.pop("start_dtype", torch.int64)
    graphed, eager = _runners(cuda, _short_series_suite(), 16, start_dtype)
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


def test_graph_is_shared_across_lengths_and_recorded_again_for_other_params(cuda, tmp_path):
    """The pymgrid25 suite's collect rollout, int32 restarts, 64 replicas a
    config, under the profiler: an 8-step and a 100-step rollout share one
    recording; a copy of the params (leaves elsewhere) records again, and
    both still equal the eager loop bitwise; each replay counts what the
    recorded step counted."""
    mgs = [Microgrid.from_scenario(n) for n in range(25)]
    graphed, eager = _runners(cuda, mgs, 64, torch.int32)
    policy = make_marginal_cost_policy(graphed.spec)
    kw = dict(auto_reset=True, collect=True, randomize_initial_step=True)
    keys = graphed.make_keys(11)
    with trace(str(tmp_path / "a"), cuda):
        graphed.rollout_fn(policy, 8, **kw)(graphed.params, keys)
        got = graphed.rollout_fn(policy, 100, **kw)(graphed.params, keys)
    counters = span_totals()["counters"]
    assert counters["pymgrid.suite.graph_captures"] == 1
    assert counters["pymgrid.suite.graph_replays"] == 108
    # and the one eager step run before the recording
    assert counters["pymgrid.engine.fresh_states"] == 109 * 25 * 64
    assert_same_rollout(got, eager.rollout_fn(policy, 100, **kw)(eager.params, keys))

    params = tree_map(torch.clone, graphed.params)
    with trace(str(tmp_path / "b"), cuda):
        got = graphed.rollout_fn(policy, 100, **kw)(params, keys)
    assert span_totals()["counters"]["pymgrid.suite.graph_captures"] == 1
    assert_same_rollout(got, eager.rollout_fn(policy, 100, **kw)(eager.params, keys))
