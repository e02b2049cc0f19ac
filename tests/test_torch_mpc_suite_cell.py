"""The port's ``SuiteMPC`` as the benchmark's planner cell runs it (CPU).

``reset(starts=...)`` puts each scenario at a given hour, ``plan`` returns
the controls a step executes and ``act`` runs the engine on them; ``step``
is ``act(plan(states))``.  The executed controls are held to the plain
reference of ``port_bench/reference/pymgrid25-mpc-suite.py`` (loaded by its
path; it imports nothing of the port): re-stepped there in float64 they give
the port's rewards, charges and energies, and the exact MILP optimum of
pymgrid's horizon problem with the first hour fixed to them is the free
optimum's.  Under a profiler capture one step fires the planner's spans,
whose self times add up to the step's, and counts its LPs and iterations.
The card's path, each solve shape recorded once and replayed, runs here
with an eager stand-in for the graph, held bitwise against the eager solves.
"""
import importlib.util
import json
import os
import warnings

import numpy as np
import pytest
import torch

from pymgrid_tpu_torch import Microgrid
from pymgrid_tpu_torch.algos import SuiteMPC
from pymgrid_tpu_torch.core import lp
from pymgrid_tpu_torch.utils.profiling import span_totals, trace

torch.set_num_threads(1)
warnings.filterwarnings("ignore")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENARIOS = [0, 4, 1]        # grid only, grid only, genset with a weak grid
HOURS = 6
# the cell's solver settings (port_bench/configs/pymgrid25-mpc-suite.json)
CELL = dict(solver_kind="box", newton_refine=2, matmul_precision="float32", enum_bits=3,
            enum_chunk=16)
SPANS = ("pymgrid.mpc.step", "pymgrid.mpc.assemble", "pymgrid.mpc.enumerate",
         "pymgrid.lp.ipm", "pymgrid.mpc.act", "pymgrid.engine.step")


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, path))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def reference():
    ref = _load("port_bench/reference/pymgrid25-mpc-suite.py", "reference_mpc_suite")
    config = {"data_dir": "pymgrid_tpu/data/scenario/pymgrid25", "scenarios": SCENARIOS}
    return ref, ref.load(config)


@pytest.fixture(scope="module")
def microgrids():
    return [Microgrid.from_scenario(n) for n in SCENARIOS]


def _suite(microgrids, dtype):
    return SuiteMPC(microgrids, 60, dtype=dtype, device="cpu", **CELL)


def _starts(mpc, seed):
    """Starts drawn from ``seed`` from which ``HOURS`` hours and the last
    one's horizon stay inside the series."""
    last = mpc.n_steps_year - (HOURS + mpc.horizon - 1)
    return np.random.default_rng(seed).integers(0, last + 1, size=mpc.n_scenarios)


def _closed_loop(mpc, starts):
    """``HOURS`` hours of plan then act: per hour ``(S, 10)`` float64 rows of
    the step and charge it started from, the executed battery, grid, genset
    production and on/off, and the reward, energies and charge after."""
    states = mpc.reset(0, starts=starts)
    rows = []
    for _ in range(HOURS):
        actions = mpc.plan(states)
        new, out = mpc.act(states, actions)
        genset = actions["genset"][:, 0]
        rows.append(torch.stack([states["step"].double(), states["battery_charge"][:, 0],
                                 actions["battery"][:, 0], actions["grid"][:, 0],
                                 genset[:, 1], genset[:, 0], out.reward, out.provided,
                                 out.absorbed, new["battery_charge"][:, 0]], 1).double())
        states = new
    return torch.stack(rows)


@pytest.fixture(scope="module")
def runs(microgrids):
    """The closed loop in float64 and float32 from the same seeded starts."""
    out = {}
    for dtype in ("float64", "float32"):
        mpc = _suite(microgrids, dtype)
        starts = _starts(mpc, 19)
        out[dtype] = (starts, _closed_loop(mpc, starts))
    return out


def test_restep_of_the_executed_controls_matches_the_reference(runs, reference):
    """The reference's float64 step of the port's executed controls gives
    every reward, energy and charge of the float64 port to 1e-9 relative:
    the engine and the reference compute the same step in the same
    precision, so only the order of a few float64 operations differs."""
    ref, configs = reference
    starts, kept = runs["float64"]
    (found,) = ref.restep(configs, [(starts, kept[..., 2:6].numpy())])
    assert (kept[:, :, 0] == torch.as_tensor(starts) + torch.arange(HOURS)[:, None]).all()
    for i, field in ((6, "reward"), (7, "provided"), (8, "absorbed"), (9, "charge")):
        want = found[field]
        torch.testing.assert_close(kept[..., i], want, rtol=1e-9, atol=1e-9 * want.abs().max())


# float64: the IPM's 60 iterations meet the exact optimum to about 1e-7 of
# the scale; the 3-bit enumeration can only miss where more than 3 hours of
# the relaxation are fractional, which these hours do not show.  float32:
# the cell's limit (port_bench/limits/mpc-suite-day.json).
DECISION_TOL = {"float64": 1e-6, "float32": None}


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_executed_decisions_are_the_exact_optimum(runs, reference, dtype):
    """Every hour's executed first-hour controls, fixed in pymgrid's horizon
    MILP (HiGHS), leave its optimum where it is, to the tolerance."""
    ref, configs = reference
    tol = DECISION_TOL[dtype]
    if tol is None:
        with open(os.path.join(ROOT, "port_bench/limits/mpc-suite-day.json")) as f:
            tol = json.load(f)["limits"]["decision_gap"]
    _, kept = runs[dtype]
    gaps = [ref.decision_gap(configs, s, int(row[0]), float(row[1]), row[2:6].numpy(), 24)
            for hour in kept for s, row in enumerate(hour)]
    assert max(gaps) < tol, gaps


def test_decision_gap_sees_a_wrong_decision(runs, reference):
    """The same check reads a decision off by a tenth of the battery's
    power: the judge is not blind."""
    ref, configs = reference
    _, kept = runs["float64"]
    row = kept[0, 0].clone()
    row[2] += 0.1 * float(configs.params[0]["battery"]["max_discharge"])
    assert ref.decision_gap(configs, 0, int(row[0]), float(row[1]), row[2:6].numpy(), 24) > 1e-4


def _assert_equal(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_equal(a[k], b[k])
    elif isinstance(a, tuple):
        for x, y in zip(a, b):
            _assert_equal(x, y)
    elif a is None:
        assert b is None
    else:
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_reset_starts_and_the_plan_act_split(microgrids):
    mpc = _suite(microgrids, "float32")
    default = mpc.reset(3)
    # no starts: every scenario's initial step, as the engine's reset gives it
    initial = mpc.params["initial_step"].to(torch.int32).unsqueeze(1)
    engine = {k: v for k, v in mpc._reset_fn(mpc.params, initial, None).items()}
    _assert_equal(default, {k: v if k == "forecast" else
                            ({n: x[:, 0] for n, x in v.items()} if isinstance(v, dict)
                             else v[:, 0]) for k, v in engine.items()})
    _assert_equal(mpc.reset(3, starts=initial[:, 0]), default)
    at = mpc.reset(3, starts=[5, 4000, 8700])
    assert at["step"].tolist() == [5, 4000, 8700]
    _assert_equal(at["battery_charge"], default["battery_charge"])
    with pytest.raises(ValueError, match="one step per scenario"):
        mpc.reset(3, starts=[5, 6])
    # step() is act(plan()), bit for bit
    _assert_equal(mpc.step(at), mpc.act(at, mpc.plan(at)))


def test_step_fires_the_planner_spans_and_counts(microgrids, tmp_path):
    """One step() under a CPU capture: every planner span fires, the self
    times split the root's total to the nanosecond, and the counters read
    the cell's LPs (relaxation, 2**3 patterns, final re-solve: S * 10) and
    iterations (35 + 35 + 60)."""
    mpc = _suite(microgrids, "float32")
    states = mpc.reset(0, starts=[100, 200, 300])
    want = mpc.step(states)
    with trace(str(tmp_path), device="cpu"):
        got = mpc.step(states)
    _assert_equal(got, want)
    totals = span_totals()
    spans = totals["spans"]
    assert set(spans) == set(SPANS)
    assert spans["pymgrid.mpc.step"]["calls"] == 1 and spans["pymgrid.lp.ipm"]["calls"] == 3
    assert sum(s["self_ns"] for s in spans.values()) == spans["pymgrid.mpc.step"]["total_ns"]
    assert all(0 < s["self_ns"] <= s["total_ns"] for s in spans.values())
    assert totals["counters"] == {"pymgrid.lp.problems": 10 * len(SCENARIOS),
                                  "pymgrid.lp.iterations": 130}


class _EagerGraph:
    """A recorded solve's stand-in on the CPU: a replay solves again on the
    recording's inputs and writes the recording's outputs."""

    def __init__(self, solve, inputs, outputs):
        self.solve, self.inputs, self.outputs = solve, inputs, outputs

    def replay(self):
        x, info = self.solve(*self.inputs)
        self.outputs[0].copy_(x)
        for k, v in info.items():
            self.outputs[1][k].copy_(v)


def test_replayed_solves_match_the_eager_planner(microgrids, monkeypatch, tmp_path):
    """The planner's solves through recordings, as on the card: one per
    solve shape (relaxation, the 8-pattern chunk, the final re-solve) made
    in the first hour and replayed in the next ones; plans, states and
    outputs equal the eager planner's bit for bit; a solution held from one
    hour survives the next hour's replays; spans and counters unchanged."""
    eager = _suite(microgrids, "float32")
    records = []

    def record(self, inputs):
        records.append(len(inputs[0]))
        outputs = self._solve(*inputs)
        return _EagerGraph(self._solve, inputs, outputs), inputs, outputs

    monkeypatch.setattr(lp._RecordedSolves, "_record", record)
    monkeypatch.setattr(lp, "_recorded", lambda cuda_graph, device: cuda_graph)
    graphed = _suite(microgrids, "float32")
    S = len(SCENARIOS)
    starts = _starts(graphed, 5)
    got, want = graphed.reset(0, starts=starts), eager.reset(0, starts=starts)
    for hour in range(3):
        plans = graphed.plan(got), eager.plan(want)
        (got, got_out), (want, want_out) = graphed.act(got, plans[0]), eager.act(want, plans[1])
        _assert_equal((plans[0], got, got_out), (plans[1], want, want_out))
    assert sorted(records) == [S, S, 8 * S]
    with trace(str(tmp_path), device="cpu"):
        graphed.step(got)
    totals = span_totals()
    assert set(totals["spans"]) == set(SPANS) and sorted(records) == [S, S, 8 * S]
    assert totals["counters"] == {"pymgrid.lp.problems": 10 * S, "pymgrid.lp.iterations": 130}
    # what a call returned is its own: the next replay leaves it as it was
    solves = lp._RecordedSolves(lambda c, b, h: (c + b, {"objective": (c * h).sum(1)}),
                                torch.device("cpu"))
    first = solves(*torch.ones(3, 2, 4))
    kept = (first[0].clone(), first[1]["objective"].clone())
    solves(*torch.zeros(3, 2, 4))
    assert torch.equal(first[0], kept[0]) and torch.equal(first[1]["objective"], kept[1])
    assert sorted(records) == [2, S, S, 8 * S]
