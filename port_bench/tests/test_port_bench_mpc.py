"""The planner cell ``mpc-suite-day`` at a tiny size on the CPU (3
scenarios, 3-hour episodes) through the harness's whole run: it passes the
comparison with the plain reference and reports exactly its metrics; its
control (the reference in bfloat16) and a broken program fail it; its
traced part fires the planner's spans and counts its LPs and iterations;
a program without the plan/act split fails at once."""
import json

import pytest
import torch

from port_bench import control, harness
from port_bench.tests.tiny import SEED

CELL = "mpc-suite-day"
TINY = {"scenarios": [0, 1, 2], "episode_hours": 3, "warmup_hours": 1, "trace_hours": 2,
        "sample_hours": 6}
PLANNER = ("mpc_self_ms_per_step", "assemble_ms_per_step", "enumerate_ms_per_step",
           "ipm_ms_per_step", "engine_self_ms_per_step.mpc")


def _run(capsys, trace=0, seconds=1.0, seed=SEED):
    from port_bench import run

    code = run.main(["--workload", CELL, "--seed", str(seed), "--seconds", str(seconds),
                     "--trace", str(trace)], device="cpu", overrides=TINY)
    lines = capsys.readouterr().out.strip().splitlines()
    return code, (json.loads(lines[-1]) if lines else None)


@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_and_is_correct(capsys, trace):
    code, result = _run(capsys, trace)
    assert code == 0 and result["correct"] is True
    assert result["attempted"] >= 2 and result["failed"] == 0
    assert set(result["checks"]) == {"reward_gap", "charge_gap", "energy_gap", "decision_gap"}
    found = harness.resolve(CELL)
    if trace:
        # a CPU capture has no device events: the device metrics stay silent
        assert set(result["metrics"]) == {m["name"] for m in found["per_layer"]
                                          if m["source"] != "device_trace"}
    else:
        assert set(result["metrics"]) == {"suite_steps_per_s", "setup_s"}
        assert all(m["value"] > 0 for m in result["metrics"].values())


def test_traced_part_reads_the_planner(capsys, tmp_path):
    """The self times of the planner's spans split the root's time per hour,
    and the counters read the cell's LPs (relaxation, 2**3 patterns, the
    final re-solve, for each of 3 scenarios) and iterations (35 + 35 + 60)."""
    from pymgrid_tpu_torch.utils.profiling import span_totals, trace

    with trace(str(tmp_path), device="cpu"):
        pass
    code, result = _run(capsys, trace=1)
    assert code == 0 and result["correct"] is True
    metrics = {k: v["value"] for k, v in result["metrics"].items()}
    assert metrics["lp_problems_per_step"] == 30
    assert metrics["ipm_iterations_per_step"] == 130
    assert all(metrics[name] > 0 for name in PLANNER)
    spans = span_totals()["spans"]
    hours = TINY["trace_hours"]
    assert spans["pymgrid.mpc.step"]["calls"] == hours
    root_ms = spans["pymgrid.mpc.step"]["total_ns"] / 1e6 / hours
    act_ms = spans["pymgrid.mpc.act"]["self_ns"] / 1e6 / hours    # a span no metric reads
    assert sum(metrics[name] for name in PLANNER) + act_ms == pytest.approx(root_ms, rel=1e-9)
    assert metrics["enqueue_ms_per_step.mpc"] > 0


def test_readers_stay_silent_on_a_program_without_spans(capsys, monkeypatch):
    from pymgrid_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "span_totals")
    code, result = _run(capsys, trace=1)
    assert code == 0 and result["correct"] is True
    assert set(result["metrics"]) == {"enqueue_ms_per_step.mpc", "build_s"}


def test_control_fails_the_limits(capsys):
    """The reference in bfloat16 in the program's place reads above a limit;
    the program reads within every one."""
    assert control.main(["--workload", CELL, "--seeds", f"{SEED},{SEED + 1}",
                         "--seconds", "0.5"], device="cpu", overrides=TINY) == 0
    limits = harness.load_json(harness.BENCH_DIR, "limits", f"{CELL}.json")["limits"]
    for line in capsys.readouterr().out.strip().splitlines():
        found = json.loads(line)
        assert all(found["program"][k] <= limits[k] for k in limits)
        assert any(found["control"][k] > limits[k] for k in limits)


def _broken(kind):
    """``make_step_fn`` of the engine with one fault planted in its step."""
    from pymgrid_tpu_torch.core import engine

    real = engine.make_step_fn

    def make(*args, **kwargs):
        step = real(*args, **kwargs)

        def broken(params, state, action):
            new, out = step(params, state, action)
            if kind == "state_unchanged":
                return state, out
            if kind == "half_batch":
                # the second half of the scenarios left out of the step: they
                # keep their state, and their outputs are never written (zeros)
                half = (state["step"].shape[0] + 1) // 2

                def leave(x, old):
                    if isinstance(x, dict):
                        return {k: leave(v, old[k]) for k, v in x.items()}
                    return torch.cat([x[:half], old[half:]])

                new = {k: leave(v, state[k]) if k in state else v for k, v in new.items()}
                zeroed = lambda x: torch.cat([x[:half], torch.zeros_like(x[half:])])  # noqa: E731
                return new, out._replace(reward=zeroed(out.reward),
                                         provided=zeroed(out.provided),
                                         absorbed=zeroed(out.absorbed))
            return new, out._replace(reward=out.reward * 1.01)   # every reward 1% off
        return broken

    return make


def _short_final_solve(monkeypatch):
    """The planner's final re-solve at 2 interior-point iterations."""
    from pymgrid_tpu_torch.algos import mpc_suite

    real = mpc_suite.make_batched_box_ipm_solver

    def make(*args, iters, **kwargs):
        return real(*args, iters=2 if iters == 60 else iters, **kwargs)

    monkeypatch.setattr(mpc_suite, "make_batched_box_ipm_solver", make)


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch", "answer_altered",
                                   "short_final_solve"])
def test_broken_program_is_not_correct(capsys, monkeypatch, fault):
    from pymgrid_tpu_torch.algos import mpc_suite

    if fault == "short_final_solve":
        _short_final_solve(monkeypatch)
    else:
        monkeypatch.setattr(mpc_suite, "make_step_fn", _broken(fault))
    code, result = _run(capsys)
    assert code == 0 and result["correct"] is False


def test_program_without_the_split_fails_at_once(capsys, monkeypatch):
    """A planner without ``plan``/``act`` (an older port) fails in
    set-up, before the build."""
    from port_bench import run
    from pymgrid_tpu_torch.algos import SuiteMPC

    monkeypatch.delattr(SuiteMPC, "plan")
    with pytest.raises(RuntimeError, match="plan/act"):
        run.main(["--workload", CELL, "--seed", "1", "--seconds", "1"], device="cpu",
                 overrides=TINY)


@pytest.mark.cuda
def test_cell_on_the_card(capsys, cuda_device):
    """The cell at its tiny size through the run's look for a card; the
    counters read the same on the card."""
    from port_bench import run

    code = run.main(["--workload", CELL, "--seed", str(SEED), "--seconds", "2",
                     "--trace", "1"], overrides=TINY)
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert code == 0 and result["correct"] is True
    assert result["device"]["platform"] == "gpu" and result["device"]["busy_s"] > 0
    metrics = result["metrics"]
    assert metrics["lp_problems_per_step"]["value"] == 30
    assert metrics["ipm_iterations_per_step"]["value"] == 130
    assert metrics["kernels_per_step.mpc"]["value"] > 0
