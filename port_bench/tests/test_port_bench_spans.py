"""The readers of the program's own spans and counters: each tiny cell's
traced run on the CPU reports every one of its span metrics, the self times
add up to the root span's time per step, the counters read their
shape-derived counts; against a program without ``span_totals`` (an older
port) the run still passes and the readers stay silent."""
import pytest

from port_bench import harness
from port_bench.tests.tiny import TINY, run_cell

SELF_TIMES = {
    "discrete-env-step": ("pymgrid.env.step", [
        "env_self_ms_per_step", "engine_self_ms_per_step.rl", "obs_ms_per_step.rl",
        "log_row_ms_per_step.rl", "policy_ms_per_step.rl", "reset_ms_per_step.rl"]),
    "suite-rbc-collect": ("pymgrid.suite.rollout", [
        "runner_self_ms_per_step", "engine_self_ms_per_step.suite", "obs_ms_per_step.suite",
        "log_row_ms_per_step.suite", "policy_ms_per_step.suite", "reset_ms_per_step.suite",
        "draw_ms_per_step"]),
}


def _counts(cell):
    """The counters and calls per step that the tiny cell's shapes give:
    every step builds a fresh state for every replica; a collect step
    splits each replica's key (2 words) and draws its restart (a
    ``fold_in`` and a ``randint``: 4 hashes, 5 words), and the rollout's
    starts are one more such draw before the first step."""
    tiny = TINY[cell]
    if cell == "discrete-env-step":
        return {"fresh_states_per_step.rl": tiny["replicas"]}
    replicas = 25 * tiny["replicas"]
    steps = tiny["trace_steps"]
    return {"fresh_states_per_step.suite": replicas,
            "threefry_calls_per_step": (4 + 5 * steps) / steps,
            "threefry_words_per_step": replicas * (5 + 7 * steps) / steps}


def _span_metrics(cell):
    return [m for m in harness.resolve(cell)["per_layer"]
            if m["source"] in ("program_span", "program_counter")]


@pytest.mark.parametrize("cell", list(SELF_TIMES))
def test_traced_run_reports_the_span_metrics(capsys, tmp_path, cell):
    from pymgrid_tpu_torch.utils.profiling import span_totals, trace

    # a run's traced part is its process's only capture; the tests run many
    # in one process, so an empty capture clears what the earlier ones left
    with trace(str(tmp_path), device="cpu"):
        pass
    code, result = run_cell(capsys, cell, trace=1)
    assert code == 0 and result["correct"] is True
    metrics = {k: v["value"] for k, v in result["metrics"].items()}
    wanted = _span_metrics(cell)
    assert {m["name"] for m in wanted} <= set(metrics)
    root, parts = SELF_TIMES[cell]
    assert set(parts) | set(_counts(cell)) == {m["name"] for m in wanted}
    assert all(metrics[name] > 0 for name in parts)
    for name, value in _counts(cell).items():
        assert metrics[name] == pytest.approx(value, rel=1e-12)
    # the self times split the root span's time per step, leaving nothing over
    steps = TINY[cell]["trace_steps"]
    root_ms = span_totals()["spans"][root]["total_ns"] / 1e6 / steps
    assert sum(metrics[name] for name in parts) == pytest.approx(root_ms, rel=1e-9)


@pytest.mark.parametrize("cell", list(SELF_TIMES))
def test_readers_stay_silent_on_a_program_without_spans(capsys, monkeypatch, cell):
    from pymgrid_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "span_totals")
    code, result = run_cell(capsys, cell, trace=1)
    assert code == 0 and result["correct"] is True
    assert not {m["name"] for m in _span_metrics(cell)} & set(result["metrics"])
    assert any(name.startswith("enqueue_ms_per_step") for name in result["metrics"])


def test_readers_without_a_traced_part():
    run = harness.Run()
    for cell in SELF_TIMES:
        for metric in _span_metrics(cell):
            assert harness.load_module("metrics", metric["name"]).read(run) is None
