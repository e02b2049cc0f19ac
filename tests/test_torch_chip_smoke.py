"""chip_smoke.py's phases run on the CPU at tiny sizes, so that a typo cannot
cost a run on the card; its ``main`` still refuses to run without CUDA."""
import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

torch.set_num_threads(1)


def test_engine_sweep_phase_cpu():
    out = chip_smoke.phase_engine_sweep("cpu", batch=64, n_steps=40)
    assert out["max_rel_vs_kernel"] <= 1e-4
    assert out["kernel_launches"] == 0  # the plain version ran


def test_golden_phase_cpu():
    out = chip_smoke.phase_golden("cpu", scenario=1, max_steps=30)
    assert out["steps"] == 30


def test_suite_phase_cpu():
    out = chip_smoke.phase_suite("cpu", n_configs=3, replicas=6, n_steps=12,
                                 ref_replicas=2)
    assert out["max_rel_vs_cpu_f64"] <= 1e-4


def test_kernel_sweep_phase_cpu():
    out = chip_smoke.phase_kernel_sweep("cpu", batch=32, n_steps=20)
    assert out["acc"].shape == (32,)
    assert out["rollout"].launches == 0


@pytest.mark.parametrize("phase", ["phase_discrete_env", "phase_continuous_env"])
def test_env_phase_cpu(phase):
    """The env phases at 8 replicas x 12 steps: their rollout-vs-loop,
    host-env and float64 checks run and pass on the CPU."""
    out = getattr(chip_smoke, phase)("cpu", batch=8, n_steps=12)
    assert out["max_rel_vs_host"] <= 1e-4
    assert out["step_loop_per_s"] > 0 and out["lean_rollout_per_s"] > 0


def test_main_refuses_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        chip_smoke.main()
    assert exc.value.code not in (0, None)
