"""Each cell's traffic runs at a tiny size on the CPU through the harness's
whole run and passes the comparison with the plain reference; its control
(the reference in bfloat16) and a broken program fail it."""
import json

import pytest
import torch

from port_bench import control, harness
from port_bench.tests.tiny import SEED, TINY, run_cell

CELLS = list(TINY)


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_and_is_correct(capsys, cell, trace):
    code, result = run_cell(capsys, cell, trace)
    assert code == 0 and result["correct"] is True
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert list(result)[-1] == "checks"
    found = harness.resolve(cell)
    wanted = found["per_layer" if trace else "end_to_end"]
    if trace:
        # a CPU capture has no device events: the device metrics stay silent
        assert set(result["metrics"]) == {m["name"] for m in wanted
                                          if m["source"] != "device_trace"}
        assert {"busy_s", "window_s"} <= set(result["device"]) and "breakdown" in result
    else:
        assert set(result["metrics"]) == {m["name"] for m in wanted}
        assert all(m["value"] > 0 for m in result["metrics"].values())


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_the_limits(capsys, cell):
    """The reference in bfloat16 in the program's place reads above a limit
    of the cell; the program reads within every one."""
    assert control.main(["--workload", cell, "--seeds", f"{SEED},{SEED + 1}",
                         "--seconds", "0.3"], device="cpu", overrides=TINY[cell]) == 0
    limits = harness.load_json(harness.BENCH_DIR, "limits", f"{cell}.json")["limits"]
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
                return {k: v for k, v in state.items() if k != "table_row"}, out
            if kind == "half_batch":
                # the second half of the replicas left out of the step: it
                # keeps its state, and its outputs are never written (zeros)
                def half(x, old=None):
                    if x is None or x.dim() < 2 or x.shape[1] == 1:
                        return x
                    b = x.shape[1]
                    rest = (torch.zeros_like(x[:, (b + 1) // 2:]) if old is None
                            else old[:, (b + 1) // 2:])
                    return torch.cat([x[:, :(b + 1) // 2], rest], dim=1)

                def leave(x, old):
                    if isinstance(x, dict):
                        return {k: leave(v, old[k]) for k, v in x.items()}
                    return half(x, old)

                new = {k: leave(v, state[k]) if k in state else v for k, v in new.items()}
                return new, out._replace(reward=half(out.reward), obs=half(out.obs))
            return new, out._replace(reward=out.reward * 1.01)   # every reward 1% off
        return broken

    return make


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch", "answer_altered"])
@pytest.mark.parametrize("cell", CELLS)
def test_broken_program_is_not_correct(capsys, monkeypatch, cell, fault):
    from pymgrid_tpu_torch.parallel import batched_env, suite

    monkeypatch.setattr(suite, "make_step_fn", _broken(fault))
    monkeypatch.setattr(batched_env, "make_step_fn", _broken(fault))
    code, result = run_cell(capsys, cell)
    assert code == 0 and result["correct"] is False


@pytest.mark.parametrize("fault", [None, "state_unchanged", "half_batch", "answer_altered"])
def test_suite_driver_without_collect(capsys, monkeypatch, fault):
    """The suite driver's throughput rollouts (``collect`` false: starts wrap
    sequentially, only checksums come back) pass the reference's comparison
    of the checksums, and fail it with a fault planted."""
    from pymgrid_tpu_torch.parallel import suite

    if fault:
        monkeypatch.setattr(suite, "make_step_fn", _broken(fault))
    code, result = run_cell(capsys, "suite-rbc-collect", collect=False, steps=16,
                            warmup_steps=8, trace_steps=8)
    assert code == 0 and set(result["checks"]) == {"checksum_gap"}
    assert result["correct"] is (fault is None)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(capsys, cuda_device, cell):
    """Each cell at its tiny size through the run's look for a card."""
    from port_bench import run

    code = run.main(["--workload", cell, "--seed", str(SEED), "--seconds", "1",
                     "--trace", "1"], overrides=TINY[cell])
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert code == 0 and result["correct"] is True
    assert result["device"]["platform"] == "gpu" and result["device"]["busy_s"] > 0
    assert {m for m in result["metrics"] if "." in m}, "the device metrics read the trace"
