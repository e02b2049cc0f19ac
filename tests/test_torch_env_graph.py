"""The batched envs' recorded ``step()`` on the CPU.

On a CUDA device ``_BatchedEnv.step`` records one step as a CUDA graph and
replays it (a ``utils/cuda_graph.Recording`` per signature).  Here a CPU
env runs its eager step and records nothing; built to take the replay path
with the eager stand-in of ``helpers/graph_standin.py``, whose replay writes
the step's states and outputs into the recorded ones in place as a graph's
does, the replay path (its input copies, returned copies, one recording per
signature and replayed counts) runs on the CPU and equals the eager step
bitwise.  ``tests/test_torch_cuda.py`` holds the real graph against the
eager step on the card."""
import numpy as np
import pytest
import torch

from helpers.env_steps import STEP_CASES, actions_of, assert_same_steps, make_env, step_loop
from helpers.factories import build_microgrid, module_params
from helpers.graph_standin import replaying  # noqa: F401  (a fixture)
import pymgrid_tpu_torch.modules as M
from pymgrid_tpu_torch.core.params import tree_map
from pymgrid_tpu_torch.envs import DiscreteMicrogridEnv
from pymgrid_tpu_torch.parallel import BatchedDiscreteEnv
from pymgrid_tpu_torch.utils.cuda_graph import graphable
from pymgrid_tpu_torch.utils.profiling import span_totals, trace

torch.set_num_threads(1)

N_STEPS = 120


@pytest.fixture
def replayed_on_the_cpu(replaying):
    """``case``'s env twice on the CPU: one built to take the replay path,
    its recording the eager stand-in, and one that runs the eager step."""
    def make(case, batch=4):
        with replaying():
            graphed = make_env(case, batch, "cpu")
        assert graphed._graph_steps
        return graphed, make_env(case, batch, "cpu")

    return make


def _counters(path, fn):
    with trace(str(path), device="cpu"):
        fn()
    return span_totals()["counters"]


@pytest.mark.parametrize("case", ["discrete", "continuous"])
def test_cpu_step_records_nothing(case, tmp_path):
    """On the CPU ``step()`` is the eager step: nothing is recorded and no
    ``pymgrid.env.graph_*`` counter fires, while the step's own counter
    does."""
    env = make_env(case, 4, "cpu")
    assert not env._graph_steps
    counters = _counters(tmp_path, lambda: step_loop(env, case, 30, seed=1))
    assert not env._graphs
    assert counters["pymgrid.engine.fresh_states"] == 30 * 4
    assert not [name for name in counters if name.startswith("pymgrid.env.graph")]


@pytest.mark.parametrize("callable_cost", [False, True])
def test_graph_predicate_refuses_a_custom_fn(callable_cost):
    """The predicate ``step()`` takes the replay path on: a CUDA device and
    no module with a per-replica callable (here a genset cost function), which
    the recording could not hold.  A pure check: no card needed."""
    params = module_params(seed=13, timesteps=25)
    if callable_cost:
        params["genset"]["genset_cost"] = lambda production: 0.4 * production
    mods, _ = build_microgrid(M, params)
    env = BatchedDiscreteEnv(DiscreteMicrogridEnv(mods), 2, "float32", device="cpu")
    assert graphable(torch.device("cuda"), env.spec) is not callable_cost
    assert not graphable(torch.device("cpu"), env.spec)
    assert not env._graph_steps


@pytest.mark.parametrize("case", STEP_CASES)
def test_replayed_steps_equal_the_eager_step(case, replayed_on_the_cpu, tmp_path):
    """120 steps of 4 replicas, every replica auto-resetting: the replay
    path returns the eager step's states and outputs bitwise, at every step
    of the loop, each step's still as it was returned after the later steps
    (no tensor of the recording is handed out).  Under the profiler the
    replayed steps count what the eager steps count, and one
    ``graph_replays`` a call; the first call records once."""
    graphed, eager = replayed_on_the_cpu(case)
    assert_same_steps(step_loop(graphed, case, N_STEPS, seed=5),
                      step_loop(eager, case, N_STEPS, seed=5))
    assert len(graphed._graphs) == 1 and not eager._graphs
    graphed._graphs.clear()
    counters = _counters(tmp_path / "eager", lambda: step_loop(eager, case, 10, seed=6))
    assert _counters(tmp_path / "graphed", lambda: step_loop(graphed, case, 10, seed=6)) == {
        **counters, "pymgrid.env.graph_replays": 10, "pymgrid.env.graph_captures": 1}


def test_one_recording_per_signature(replayed_on_the_cpu, tmp_path):
    """``keep_logs`` on and off, and a shared step, record once each and
    then replay; a copy of the params (leaves at other addresses) records
    again and frees the recordings of the old params; the outputs stay the
    eager step's."""
    graphed, eager = replayed_on_the_cpu("discrete")
    actions = actions_of(graphed, np.random.RandomState(3), 4)
    states = graphed.reset()
    shared = graphed.rollout(states, actions[:2], shared_step=True)[0]

    def captures(env, calls):
        got = []
        counters = _counters(tmp_path, lambda: got.extend(
            env.step(s, a, keep_logs=k) for s, a, k in calls))
        return counters.get("pymgrid.env.graph_captures", 0), got

    calls = [(states, actions[0], True), (states, actions[1], False),
             (shared, actions[2], True), (states, actions[3], True),
             (shared, actions[0], True), (states, actions[1], False)]
    n, got = captures(graphed, calls)
    assert n == 3 and len(graphed._graphs) == 3
    assert_same_steps(got, [eager.step(s, a, keep_logs=k) for s, a, k in calls],
                      every_replica_done=False)
    graphed.params = tree_map(torch.clone, graphed.params)
    n, got = captures(graphed, calls[:2])
    assert n == 2 and len(graphed._graphs) == 2
    assert_same_steps(got, [eager.step(s, a, keep_logs=k) for s, a, k in calls[:2]],
                      every_replica_done=False)


def test_input_requiring_grad_runs_eagerly(replayed_on_the_cpu):
    """Continuous actions that require grad take the eager step, whose
    outputs carry the graph of the actions; the same actions without grad
    replay."""
    graphed, _ = replayed_on_the_cpu("continuous")
    states = graphed.reset()
    actions = actions_of(graphed, np.random.RandomState(4), 1)[0].requires_grad_()
    _, out = graphed.step(states, actions)
    assert out.reward.requires_grad and not graphed._graphs
    _, replayed = graphed.step(states, actions.detach())
    assert len(graphed._graphs) == 1 and not replayed.reward.requires_grad
    assert torch.equal(replayed.reward, out.reward.detach())
