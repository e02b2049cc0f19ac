"""The port's spans and counters (``utils/profiling.span``, ``count``,
``span_totals``) on the CPU: off and empty with no profiler running; under
``trace`` the batched env's step loop and the suite's collect rollout record
each layer's span as often as the code runs it and the counters their
shape-derived counts, the self times add up to the root's total to the
nanosecond, the Chrome trace names the spans, and every output is bitwise
the one computed with no profiler running."""
import json
import os

import pytest
import torch

from pymgrid_tpu_torch import Microgrid
from pymgrid_tpu_torch.core.rollout import make_marginal_cost_policy
from pymgrid_tpu_torch.envs import DiscreteMicrogridEnv
from pymgrid_tpu_torch.parallel import BatchedDiscreteEnv, SuiteRunner
from pymgrid_tpu_torch.utils import profiling
from pymgrid_tpu_torch.utils.profiling import count, span, span_totals, trace

torch.set_num_threads(1)

B, N_STEPS = 8, 3            # env replicas, env steps
C_SCENARIOS, B_SUITE, T = (0, 1), 4, 6
ENGINE = ("pymgrid.engine.policy", "pymgrid.engine.step", "pymgrid.engine.obs",
          "pymgrid.engine.log_row", "pymgrid.engine.auto_reset")


@pytest.fixture(scope="module")
def env():
    return BatchedDiscreteEnv(DiscreteMicrogridEnv.from_scenario(0), B, "float32", "cpu",
                              auto_reset=True, obs_layout="env")


@pytest.fixture(scope="module")
def runner():
    return SuiteRunner([Microgrid.from_scenario(n) for n in C_SCENARIOS],
                       batch_per_config=B_SUITE, dtype="float32", device="cpu",
                       start_dtype=torch.int32)


def _empty_capture(tmp_path):
    with trace(str(tmp_path / "empty"), device="cpu"):
        pass


def _step_loop(env, actions):
    states = env.reset()
    outs = []
    for a in actions:
        states, out = env.step(states, a)
        outs.append((states, out))
    return outs


def _assert_self_times_add_up(totals, root):
    spans = totals["spans"]
    assert sum(s["self_ns"] for s in spans.values()) == spans[root]["total_ns"]
    assert all(0 < s["self_ns"] <= s["total_ns"] for s in spans.values())


def _assert_bitwise(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_bitwise(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_bitwise(x, y)
    elif a is None:
        assert b is None
    else:
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_no_profiler_records_nothing(env, tmp_path, monkeypatch):
    """With no capture running a span is the shared no-op, opens no
    ``record_function`` range, and the tallies stay empty."""
    _empty_capture(tmp_path)
    assert span_totals() == {"spans": {}, "counters": {}}

    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert span("pymgrid.a") is span("pymgrid.b")
    with span("pymgrid.a"):
        count("pymgrid.n", 3)
    _step_loop(env, torch.zeros((2, B), dtype=torch.int64))
    assert span_totals() == {"spans": {}, "counters": {}}


def test_nested_spans_and_counters(tmp_path):
    """Self time is the total less the children's totals; ``trace`` starts
    from empty tallies."""
    with trace(str(tmp_path / "a"), device="cpu"):
        with span("pymgrid.outer"):
            for _ in range(3):
                with span("pymgrid.inner"):
                    with span("pymgrid.leaf"):
                        count("pymgrid.n", 2)
            count("pymgrid.n", 5)
    totals = span_totals()
    spans = totals["spans"]
    assert {k: v["calls"] for k, v in spans.items()} == {
        "pymgrid.outer": 1, "pymgrid.inner": 3, "pymgrid.leaf": 3}
    assert spans["pymgrid.inner"]["self_ns"] == (spans["pymgrid.inner"]["total_ns"]
                                                 - spans["pymgrid.leaf"]["total_ns"])
    assert spans["pymgrid.outer"]["self_ns"] == (spans["pymgrid.outer"]["total_ns"]
                                                 - spans["pymgrid.inner"]["total_ns"])
    _assert_self_times_add_up(totals, "pymgrid.outer")
    assert totals["counters"] == {"pymgrid.n": 11}
    _empty_capture(tmp_path)
    assert span_totals() == {"spans": {}, "counters": {}}


def test_span_closes_on_an_exception(tmp_path):
    with trace(str(tmp_path), device="cpu"):
        with pytest.raises(ValueError):
            with span("pymgrid.outer"):
                with span("pymgrid.inner"):
                    raise ValueError("inside")
        with span("pymgrid.after"):
            pass
    spans = span_totals()["spans"]
    assert spans["pymgrid.after"]["self_ns"] == spans["pymgrid.after"]["total_ns"]
    assert spans["pymgrid.outer"]["calls"] == spans["pymgrid.inner"]["calls"] == 1
    assert profiling._open == []


def test_env_step_loop_spans(env, tmp_path):
    actions = torch.randint(0, env.n_actions, (N_STEPS, B),
                            generator=torch.Generator().manual_seed(7))
    plain = _step_loop(env, actions)
    with trace(str(tmp_path), device="cpu"):
        traced = _step_loop(env, actions)
    totals = span_totals()
    calls = {k: v["calls"] for k, v in totals["spans"].items()}
    assert calls == {"pymgrid.env.step": N_STEPS, **{name: N_STEPS for name in ENGINE}}
    assert totals["counters"] == {"pymgrid.engine.fresh_states": N_STEPS * B}
    _assert_self_times_add_up(totals, "pymgrid.env.step")
    assert plain[-1][1].log_row is not None
    _assert_bitwise(plain, traced)

    with open(os.path.join(tmp_path, "trace.json")) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"pymgrid.env.step", *ENGINE} <= names


def test_collect_rollout_spans(runner, tmp_path):
    """The collect rollout with drawn restarts: the starts' draw is a
    ``fold_in`` and a ``randint`` (a ``split`` and two ``bits``), 4 threefry
    calls hashing 5 words a replica; every step splits the state's key (2
    words a replica) and draws a restart (5 more), 5 calls."""
    fn = runner.rollout_fn(make_marginal_cost_policy(runner.spec), T, auto_reset=True,
                           collect=True, randomize_initial_step=True)
    keys = runner.make_keys(11)
    plain = fn(runner.params, keys)
    with trace(str(tmp_path), device="cpu"):
        traced = fn(runner.params, keys)
    replicas = len(C_SCENARIOS) * B_SUITE
    totals = span_totals()
    calls = {k: v["calls"] for k, v in totals["spans"].items()}
    assert calls == {"pymgrid.suite.rollout": 1, "pymgrid.suite.restart_draw": T,
                     "pymgrid.prng.threefry": 4 + 5 * T, **{name: T for name in ENGINE}}
    assert totals["counters"] == {"pymgrid.prng.threefry_words": replicas * (5 + 7 * T),
                                  "pymgrid.engine.fresh_states": replicas * T}
    _assert_self_times_add_up(totals, "pymgrid.suite.rollout")
    _assert_bitwise(plain, traced)

    with open(os.path.join(tmp_path, "trace.json")) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"pymgrid.suite.rollout", "pymgrid.suite.restart_draw",
            "pymgrid.prng.threefry", *ENGINE} <= names


def test_recorded_counts_stay_out_of_the_tallies(tmp_path):
    """Inside ``recorded_counts`` a count goes to the block's dict, with or
    without a profiler, and not to ``span_totals``; the innermost block
    takes it."""
    with profiling.recorded_counts() as outside:
        count("pymgrid.n", 2)
    with trace(str(tmp_path), device="cpu"):
        count("pymgrid.n", 1)
        with profiling.recorded_counts() as outer:
            count("pymgrid.n", 3)
            with profiling.recorded_counts() as inner:
                count("pymgrid.m", 4)
    assert (outside, outer, inner) == ({"pymgrid.n": 2}, {"pymgrid.n": 3}, {"pymgrid.m": 4})
    assert span_totals()["counters"] == {"pymgrid.n": 1}
    assert profiling._recording == []


def test_suite_steps_run_eagerly_on_the_cpu_and_with_callables(runner, tmp_path):
    """The suite replays a recorded step on a CUDA device only, and never
    for a spec with a per-replica callable: on the CPU the rollout runs its
    eager loop, and no ``pymgrid.suite.graph_*`` span or counter fires."""
    from pymgrid_tpu_torch.modules import GensetModule
    from pymgrid_tpu_torch.utils.cuda_graph import graphable

    cuda = torch.device("cuda")
    assert not runner._graph_steps and graphable(cuda, runner.spec)
    fn = runner.rollout_fn(make_marginal_cost_policy(runner.spec), T, auto_reset=True,
                           collect=True, randomize_initial_step=True)
    with trace(str(tmp_path), device="cpu"):
        fn(runner.params, runner.make_keys(3))
    totals = span_totals()
    assert totals["spans"]["pymgrid.engine.step"]["calls"] == T
    assert not [n for n in (*totals["spans"], *totals["counters"])
                if n.startswith("pymgrid.suite.graph")]

    microgrid = Microgrid.from_scenario(1)
    genset = next(m for m in microgrid.modules.iterlist() if isinstance(m, GensetModule))
    genset.genset_cost = lambda energy: 0.4 * energy + 0.01 * energy ** 2
    with_callable = SuiteRunner([microgrid], batch_per_config=2, dtype="float32",
                                device="cpu")
    assert any(ref.custom_fn is not None for ref in with_callable.spec.log_order)
    assert not graphable(cuda, with_callable.spec)
    assert not graphable(torch.device("cpu"), runner.spec)
