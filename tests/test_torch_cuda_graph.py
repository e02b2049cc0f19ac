"""The port's one CUDA-graph recorder (``utils/cuda_graph.py``) and its one
auto-reset (``core/rollout.auto_reset``), on the CPU.

A :class:`~pymgrid_tpu_torch.utils.cuda_graph.Recording` runs here through
the eager stand-in of ``helpers/graph_standin.py``, which runs the work as
the card's capture does (a warm-up, then the recording) and replays it in
place; ``tests/test_torch_cuda.py`` holds the real graphs against the eager
paths on the card.  The layering checks read the package's sources."""
import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from helpers.graph_standin import replaying  # noqa: F401  (a fixture)
from pymgrid_tpu_torch import Microgrid
from pymgrid_tpu_torch.core.engine import make_reset_fn
from pymgrid_tpu_torch.core.rollout import make_marginal_cost_policy, make_rollout_fn
from pymgrid_tpu_torch.parallel.suite import build_suite
from pymgrid_tpu_torch.utils import cuda_graph
from pymgrid_tpu_torch.utils.profiling import count, span_totals, trace

torch.set_num_threads(1)

PACKAGE = Path(__file__).resolve().parent.parent / "pymgrid_tpu_torch"


@pytest.mark.parametrize("kind", ["numbers", "arrays"])
def test_host_values_are_filled_on_the_device(kind):
    """Inside a capture, ``torch.as_tensor`` of a Python number or a 0-d
    numpy array bound for a device (a copy from the host, which a capture
    refuses) becomes a fill there, with the dtype ``as_tensor`` infers or is
    given; tensors, host tensors and other calls pass as they are."""
    with cuda_graph.HostValuesOnDevice():
        if kind == "numbers":
            made = [torch.as_tensor(0.0, device="meta"), torch.as_tensor(3, device="meta"),
                    torch.as_tensor(True, device="meta"),
                    torch.as_tensor(0.5, dtype=torch.float64, device="meta")]
            want = [torch.float32, torch.int64, torch.bool, torch.float64]
            host = torch.as_tensor(2.5, device="cpu")
        else:
            made = [torch.as_tensor(np.asarray(0.5, np.float32), device="meta"),
                    torch.as_tensor(np.asarray(2**40), device="meta"),
                    torch.as_tensor(np.asarray(1.5), dtype=torch.float32, device="meta"),
                    torch.as_tensor(np.asarray(0.5), device="meta")]
            want = [torch.float32, torch.int64, torch.float32, torch.float64]
            host = torch.as_tensor(np.asarray(2.5), device="cpu")
        same = torch.as_tensor(host, device="cpu")
    assert [(x.device.type, x.dtype, x.dim()) for x in made] == [
        ("meta", dtype, 0) for dtype in want]
    assert host.device.type == "cpu" and host.item() == 2.5 and same is host


def _counting(x, state):
    """A step that counts 3 and advances ``state`` in place."""
    count("pymgrid.test.n", 3)
    state["a"].add_(x)
    return {"sum": state["a"] + x, "none": None}, (state["a"] * 2,)


def test_warm_up_adds_no_counts_and_each_replay_adds_the_captures(replaying, tmp_path):
    """Under the profiler a recording's warm-up and capture add nothing to
    the tallies: it keeps what the recorded work counted, and each replay
    adds that, once."""
    x, state = torch.ones(4), {"a": torch.zeros(4)}
    with trace(str(tmp_path), device="cpu"):
        recording = cuda_graph.Recording(_counting, (x, state))
        built = dict(span_totals()["counters"])
        recording.replay()
        recording.replay()
    assert built == {}
    assert recording.counts == {"pymgrid.test.n": 3}
    assert span_totals()["counters"] == {"pymgrid.test.n": 6}


def test_load_then_replay_leaves_the_outputs_in_the_recordings_tensors(replaying):
    """The recording reads contiguous clones of its inputs, never the
    caller's; ``load`` copies nested inputs into them, and ``replay`` writes
    the results into the same output tensors, ``None`` fields kept."""
    x, state = torch.ones(6)[::2], {"a": torch.zeros(3)}
    recording = cuda_graph.Recording(_counting, (x, state))
    rx, rstate = recording.inputs
    assert rx.is_contiguous() and rx is not x and rstate["a"] is not state["a"]
    outputs = recording.outputs
    held = [outputs[0]["sum"], outputs[1][0]]
    recording.load(torch.full((3,), 2.0), {"a": torch.full((3,), 5.0)})
    recording.replay()
    assert recording.outputs is outputs and outputs[0]["none"] is None
    assert held[0] is outputs[0]["sum"] and held[1] is outputs[1][0]
    assert torch.equal(rstate["a"], torch.full((3,), 7.0))
    assert torch.equal(held[0], torch.full((3,), 9.0))
    assert torch.equal(held[1], torch.full((3,), 14.0))
    assert torch.equal(state["a"], torch.zeros(3))


def test_the_device_decides_and_the_stand_in_patches_it(replaying):
    """``available`` is true on a CUDA device only (no card needed to ask);
    inside ``replaying()`` the CPU says yes too, and not after it."""
    assert cuda_graph.available(torch.device("cuda"))
    assert not cuda_graph.available(torch.device("cpu"))
    with replaying():
        assert cuda_graph.available(torch.device("cpu"))
    assert not cuda_graph.available(torch.device("cpu"))


def test_traced_make_rollout_fn_counts_its_fresh_states(tmp_path):
    """``make_rollout_fn`` with ``auto_reset`` goes through the one
    auto-reset: under the profiler its span fires once a step and the
    counter counts ``T * C * B`` fresh states; the outputs are the ones
    computed with no profiler running."""
    T, B = 5, 3
    spec, params = build_suite([Microgrid.from_scenario(n) for n in (0, 1)], "float32", "cpu")
    C = params["initial_step"].shape[0]
    starts = params["initial_step"].to(torch.int32).unsqueeze(1).expand(C, B)
    states = make_reset_fn(spec)(params, starts, None)
    fn = make_rollout_fn(spec, make_marginal_cost_policy(spec), T, auto_reset=True)
    want = fn(params, states)
    with trace(str(tmp_path), device="cpu"):
        got = fn(params, states)
    totals = span_totals()
    assert totals["counters"]["pymgrid.engine.fresh_states"] == T * C * B
    assert totals["spans"]["pymgrid.engine.auto_reset"]["calls"] == T
    for a, b in zip(got[1], want[1]):
        assert torch.equal(a, b)


def _sources():
    return sorted(PACKAGE.rglob("*.py"))


def test_no_module_imports_a_private_name_of_the_suite():
    """The suite runner's private names stay its own: no module of the port
    imports an underscore name from ``parallel/suite.py`` or reads one off
    the module."""
    found = []
    for path in _sources():
        tree = ast.parse(path.read_text(), str(path))
        aliases = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom) and node.module:
                for alias in node.names:
                    if node.module == "pymgrid_tpu_torch.parallel.suite":
                        if alias.name.startswith("_"):
                            found.append((path.name, alias.name))
                    elif node.module == "pymgrid_tpu_torch.parallel" and alias.name == "suite":
                        aliases.add(alias.asname or alias.name)
        for node in ast.walk(tree):
            if (isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name)
                    and node.value.id in aliases and node.attr.startswith("_")):
                found.append((path.name, node.attr))
    assert found == []


@pytest.mark.parametrize("needle, home", [
    ("torch.cuda.graph", "utils/cuda_graph.py"),
    ("CUDAGraph", "utils/cuda_graph.py"),
    ("wait_stream", "utils/cuda_graph.py"),
    ("select_state(out.done", "core/rollout.py"),
])
def test_each_mechanism_is_written_once(needle, home):
    """The recording recipe lives in ``utils/cuda_graph.py`` and the
    auto-reset's select in ``core/rollout.py``, nowhere else in the port."""
    where = {path.relative_to(PACKAGE).as_posix() for path in _sources()
             if needle in path.read_text()}
    assert where == {home}
