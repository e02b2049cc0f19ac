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


def test_suite_phase_cpu(tmp_path):
    """3 configs x 6 replicas x 16 steps (two blocks): the block-prefetch
    path runs and equals the per-step path, and the profiled rollouts (a
    CPU capture records no device events)."""
    out = chip_smoke.phase_suite("cpu", n_configs=3, replicas=6, n_steps=16,
                                 ref_replicas=2, trace_dir=tmp_path, profile_steps=(8, 16))
    assert out["max_rel_vs_cpu_f64"] <= 1e-4
    assert out["seconds_per_step_path"] > 0 and out["seconds_again"] > 0
    assert out["events_per_step_blocked"] == 0 and out["events_per_step_per_step"] == 0


def test_kernel_sweep_phase_cpu():
    out = chip_smoke.phase_kernel_sweep("cpu", batch=32, n_steps=20)
    assert out["acc"].shape == (32,)
    assert out["rollout"].launches == 0


def test_kernel_vs_plain_phase_cpu():
    """The kernel phase's checks and its variant table at tiny sizes (on the
    CPU the wrapper takes the plain version on both sides)."""
    sweep = chip_smoke.phase_kernel_sweep("cpu", batch=16, n_steps=12)
    out = chip_smoke.phase_kernel_vs_plain(sweep, "cpu", genset_batch=8, genset_steps=30)
    assert len(out["variants"]) == 25 and out["variants"][0] == 6
    assert out["genset_variant"] == 0 and out["max_abs_err"] == 0.0
    assert out["bound_ms"] > 0


@pytest.mark.parametrize("phase", ["phase_discrete_env", "phase_continuous_env"])
def test_env_phase_cpu(phase):
    """The env phases at 8 replicas x 12 steps: their rollout-vs-loop,
    host-env and float64 checks run and pass on the CPU."""
    out = getattr(chip_smoke, phase)("cpu", batch=8, n_steps=12)
    assert out["max_rel_vs_host"] <= 1e-4
    assert out["step_loop_per_s"] > 0 and out["lean_rollout_per_s"] > 0


def test_gaussian_env_phase_cpu(tmp_path):
    """64 replicas x 8 steps: the loop-vs-rollout, seed, float64 and noise
    checks (the noise held to 0.1 at ~4e3 entries) and the profiled steps
    (a CPU capture records no device events)."""
    out = chip_smoke.phase_gaussian_env("cpu", batch=64, n_steps=8, noise_tol=0.1,
                                        trace_dir=tmp_path / "trace")
    assert out["max_abs_f64_vs_cpu"] == 0.0 and out["noise_count"] > 1000
    assert out["events_per_step"] == 0 and out["idle_share"] == 1.0
    assert out["step_loop_per_s"] > 0


def test_callable_env_phase_cpu():
    out = chip_smoke.phase_callable_env("cpu", batch=64, n_steps=8)
    assert out["step_loop_per_s"] > 0 and out["shared_rollout_per_s"] > 0


def test_suite_mpc_phase_cpu():
    """Scenarios 0-4 x 3 steps: float32 chip mode against float64."""
    out = chip_smoke.phase_suite_mpc("cpu", n_scenarios=5, n_steps=3)
    assert out["cost32"].shape == (5,) and out["held_max_rel_gap"] < 0.02
    assert out["ms_per_hour32"] > 0


def test_box_ipm_phase_cpu():
    """The box IPM's phase on the LPs of the float32 planner's 2 hours over
    scenarios 0-2: on the CPU both sides run the op path (no kernel solve is
    counted), HiGHS's limits hold, and no time is taken."""
    sm = chip_smoke.phase_suite_mpc("cpu", n_scenarios=3, n_steps=2, held=(0, 1))
    assert sm["kernel_solves"] == 0 and sm["box_solves"] == 6
    out = chip_smoke.phase_box_ipm("cpu", sm["box_solvers"])
    assert list(out) == ["relaxation", "chunk", "final"]
    assert [r["problems"] for r in out.values()] == [3, 24, 3]
    assert all(r["ms"] is None and r["bound_ms"] > 0 for r in out.values())


def test_batched_mpc_phase_cpu():
    """4 float32 replicas and the float64 host-fallback run, 2 steps."""
    out = chip_smoke.phase_batched_mpc("cpu", batch=4, n_steps=3, n_steps32=2)
    assert out["rel_host"] < 1e-4 and out["fallback_count"] == 0
    assert out["n_steps"] == 3 and out["n_steps32"] == 2 and out["rel32"] < 0.02


def test_saa_phase_cpu():
    out = chip_smoke.phase_saa("cpu", n_steps=3, n_samples=4)
    assert out["degenerate_max_rel"] < 1e-5 and len(out["picks"]) == 3


def test_a2c_phase_cpu(tmp_path):
    """16 replicas x 8 steps, 2 iterations, and the profiled iteration (a
    CPU capture records no device events); the sampled iteration's draws
    are recorded, one per replica and step."""
    out = chip_smoke.phase_a2c("cpu", batch=16, rollout_len=8, iters=2,
                               trace_dir=tmp_path / "trace")
    assert out["loss_rel_vs_cpu"] == 0.0 and out["params_max_abs_vs_cpu"] == 0.0
    assert out["sampled_flips"] == 0 and out["sampled_rel_vs_cpu"] == 0.0
    assert out["sampled_draws"] == 16 * 8 and out["sampled_min_margin"] > 0
    assert len(out["history"]) == 2 and out["steps_per_s"] > 0
    assert out["device_events"] == 0 and out["idle_share"] == 1.0


def test_adam_phase_cpu(tmp_path):
    """The Adam phase: the CPU against itself, every step equal; no timing
    off the card, and a CPU capture records no device events."""
    out = chip_smoke.phase_adam("cpu", n_steps=3, trace_dir=tmp_path / "trace")
    assert out["n_steps"] == 3 and out["n_params"] > out["a2c_params"] > 0 and "ms" not in out
    assert out["events"] == 0 and out["busy_ms"] == 0.0


def test_es_phase_cpu():
    out = chip_smoke.phase_es("cpu", pop=6, hidden=4, n_steps=15)
    assert out["max_rel_vs_cpu"] == 0.0 and len(out["history"]) == 2
    assert out["ms_per_gen"] > 0
    assert out["draws_max_abs_vs_cpu"] == 0.0
    assert out["rbc"] < 0


def test_dryrun_phase_cpu():
    out = chip_smoke.phase_dryrun("cpu")
    assert out["devices"] == 1 and out["seconds"] > 0 and out["rel_vs_cpu"] == 0.0


def test_draws_phase_cpu():
    """The draws phase at 64 keys: the CPU against itself, every draw equal;
    no timing off the card."""
    out = chip_smoke.phase_draws("cpu", n_keys=64)
    assert out["normal_elements"] == 64 * 23 * 4 and out["normal64_differ"] == 0
    assert 0 < out["normal64_off_rational"] < out["normal_elements"] and "ms" not in out
    assert out["normal64_log1p_differ"] == 0


def test_random_policy_phase_cpu():
    out = chip_smoke.phase_random_policy("cpu", batch=64)
    assert out["n_actions"] == 64 * 2 and out["seconds"] > 0


def test_suite_collect_phase_cpu(tmp_path):
    """2 configs x 8 replicas x 4 steps, and the profiled rollouts (a CPU
    capture records no device events)."""
    out = chip_smoke.phase_suite_collect("cpu", n_configs=2, replicas=8, n_steps=4,
                                         trace_dir=tmp_path, profile_steps=(1, 2),
                                         min_restarts=0)
    assert out["steps_per_s"] > 0
    assert out["events_per_step_keyed"] == 0 and out["events_per_step_fixed"] == 0


def test_tables_phases_cpu(tmp_path):
    rbc = chip_smoke.phase_tables_rbc("cpu", tmp_path, n_steps=30)
    assert rbc["cost"] > 0 and (tmp_path / "RESULTS.md").exists()
    mpc = chip_smoke.phase_tables_mpc_suite("cpu", tmp_path, n_steps=2)
    assert len(mpc["costs"]) == 2 and mpc["ms_per_hour"] > 0


def test_structure_phase_cpu():
    """At a cut depth the study on the device is held against the CPU twin
    (here both run on the CPU)."""
    out = chip_smoke.phase_structure("cpu", n_steps=30)
    assert out["max_rel"] == 0.0 and len(out["lines"]) == 13


def test_speed_tools_phase_cpu(tmp_path, monkeypatch):
    """The speed phase at tiny sizes: the sweep over 2 configs x (2, 4)
    replicas, ``--scaling`` at world size 1 in a worker subprocess over
    gloo (its checksums equal to the unmeshed runner's), both parsed back
    from the report, and ``profile_env``."""
    from pymgrid_tpu_torch.tools import run_benchmarks

    monkeypatch.setattr(run_benchmarks, "SCALING_WORLD_SIZES", (1,))
    monkeypatch.setattr(run_benchmarks, "CHIP_CONFIGS", 2)
    monkeypatch.setattr(run_benchmarks, "CHIP_REPLICAS", (2, 4))
    out = chip_smoke.phase_speed_tools("cpu", tmp_path, scaling_configs=2,
                                       scaling_replicas=2, scaling_steps=8,
                                       profile_batch=4, profile_steps=8)
    assert [r["total_envs"] for r in out["chip_rows"]] == [4, 8]
    assert [r["devices"] for r in out["rank_rows"]] == [1]
    assert [p[0] for p in out["profile"]] == [
        "fused rollout keep_obs=True", "fused rollout keep_obs=False",
        "suite rollout (obs checksummed)"]
    assert all(rate > 0 for _, _, rate in out["profile"])
    assert sorted(p.name for p in tmp_path.iterdir()) == ["RESULTS_SCALING.md"]


def test_bench_phase_cpu(tmp_path, monkeypatch):
    """The bench phase at ``tests/test_bench_smoke.py``'s tiny knobs: the
    twin's line parsed back with every rate above 0, an outside
    ``PYMGRID_BENCH_*`` value neither read nor lost, no kernel launched on
    the CPU, and the int32 collect step's device events (0 on the CPU)."""
    import importlib.util
    import json
    import os

    spec = importlib.util.spec_from_file_location(
        "bench_smoke_knobs", Path(__file__).parent / "test_bench_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    monkeypatch.setenv("PYMGRID_BENCH_SKIP_EXTRAS", "1")
    out = chip_smoke.phase_bench("cpu", knobs=smoke.TINY, trace_dir=tmp_path,
                                 collect_configs=2, collect_replicas=4)
    assert os.environ["PYMGRID_BENCH_SKIP_EXTRAS"] == "1"
    assert not set(smoke.TINY) & set(os.environ)
    result = json.loads(out["line"])
    assert result == out["result"] and result["total_envs"] == 8
    assert result["kernel_steps_per_sec"] > 0 and result["collect_steps_per_sec"] > 0
    assert out["kernel_launches"] == 0 and out["collect_events_per_step_int32"] == 0


def test_main_refuses_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        chip_smoke.main()
    assert exc.value.code not in (0, None)
