"""The port's speed tools against the JAX originals (CPU, float32).

* ``pymgrid_tpu_torch.tools.run_benchmarks.suite_throughput`` against the
  JAX tool's ``_suite_throughput`` (3 configs x 4 replicas x 16 steps) as
  its ``--scaling`` modes run it, without ``jax_enable_x64``: the same
  rollout arguments, JAX's int32 starts bitwise, the ``(C, B)`` checksums
  within rtol 1e-5, the port's block-prefetch path run;
* ``--scaling``: a 2-rank gloo job of ``--scaling-worker`` whose gathered
  checksums equal the single-process run bitwise and whose rank 0 prints the
  JAX worker's JSON keys; ``run_scaling`` at world sizes ``(1, 2)`` writing
  only into ``--out``; the job runner killing a hung or failed rank;
* the scaling report's table rows identical to the JAX writer's, with no
  TPU in the port's text;
* ``pymgrid_tpu_torch.tools.profile_env`` against ``tools/profile_env.py``:
  the three labels in order, the rollouts within rtol 1e-5;
* both entry points default to the card and raise without it.

The JAX programs are loaded from their files, as ``tests/test_torch_tools.py``
loads them.  Every subprocess has a timeout.
"""
import argparse
import importlib.util
import json
import os
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from pymgrid_tpu_torch.parallel import BatchMesh, SuiteRunner
from pymgrid_tpu_torch.parallel import suite as suite_module
from pymgrid_tpu_torch.tools import profile_env, run_benchmarks

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
_JAX_ROW_KEYS = {"devices", "env_steps_per_sec"}   # tools/run_benchmarks.py:218


def _load(relpath, name):
    spec = importlib.util.spec_from_file_location(name, REPO / relpath)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _record_rollouts(monkeypatch, runner_cls, calls):
    """Wrap ``runner_cls.rollout_fn`` so each call appends ``(runner, n_steps,
    kwargs, outputs)``, ``outputs`` the list of what its function returned."""
    original = runner_cls.rollout_fn

    def rollout_fn(self, policy, n_steps, **kw):
        fn, outputs = original(self, policy, n_steps, **kw), []
        calls.append((self, n_steps, kw, outputs))

        def recorded(*args):
            outputs.append(fn(*args))
            return outputs[-1]

        return recorded

    monkeypatch.setattr(runner_cls, "rollout_fn", rollout_fn)


def _jax_starts(runner, keys):
    """The starts JAX's runner draws from ``keys`` in JAX's current mode
    (its default int: int32 without x64)."""
    import jax

    max_start = min(m.ts_length for m in runner.spec.log_order if m.ts_length) - 1
    i0 = np.asarray(runner.params["initial_step"]).reshape(-1)
    return np.array([[int(jax.random.randint(jax.random.fold_in(keys[c, b], 0x51A7), (),
                                             int(i0[c]), max_start))
                      for b in range(keys.shape[1])] for c in range(keys.shape[0])],
                    dtype=np.int32)


def test_suite_throughput_matches_the_jax_tool(monkeypatch):
    """The JAX tool's ``--scaling``, ``--scaling-chip`` and
    ``--scaling-worker`` modes return before it sets ``jax_enable_x64``, so
    its suite draws int32 starts: the JAX side runs with x64 off."""
    import jax

    from pymgrid_tpu.parallel.suite import SuiteRunner as JaxSuiteRunner

    jax_tool = _load("tools/run_benchmarks.py", "run_benchmarks_jax_speed")
    jax_calls, calls, gathers = [], [], []
    _record_rollouts(monkeypatch, JaxSuiteRunner, jax_calls)
    _record_rollouts(monkeypatch, SuiteRunner, calls)
    gather = suite_module.gather_block
    monkeypatch.setattr(suite_module, "gather_block",
                        lambda table, steps: gathers.append(1) or gather(table, steps))

    C, B, T = 3, 4, 16
    with jax.enable_x64(False):
        assert jax_tool._suite_throughput(C, B, T, repeats=1) > 0
    sps, out = run_benchmarks.suite_throughput(C, B, T, device="cpu", repeats=2)
    assert sps > 0 and out.shape == (C, B) and out.dtype == torch.float32

    (jrunner, jsteps, jkw, jouts), = jax_calls
    (runner, steps, kw, outs), = calls
    assert (steps, kw) == (jsteps, jkw) == (T, {"auto_reset": True, "collect": False,
                                               "randomize_initial_step": True})
    assert len(outs) == 3 and len(jouts) == 2       # warm run + repeats
    assert len(gathers) == 3 * T // suite_module.BLOCK  # the block-prefetch path ran
    assert torch.equal(out, outs[-1])
    keys = runner.make_keys(0)
    with jax.enable_x64(False):
        want = _jax_starts(jrunner, jrunner.make_keys(seed=0))
    assert runner.start_dtype == torch.int32
    np.testing.assert_array_equal(runner.draw_initial_steps(keys).numpy(), want)
    np.testing.assert_allclose(out.numpy(), np.asarray(jouts[-1]), rtol=1e-5)


def _args(tmp_path, *flags):
    return run_benchmarks.parse_args(["--device", "cpu", "--out", str(tmp_path), *flags])


def test_two_rank_gloo_worker_equals_one_process(tmp_path):
    args = _args(tmp_path, "--scaling-configs", "4", "--scaling-replicas", "2",
                 "--scaling-steps", "16")
    row = run_benchmarks._scaling_job(2, args)
    assert set(row) - {"checksums"} == _JAX_ROW_KEYS and row["devices"] == 2
    assert row["env_steps_per_sec"] > 0
    _, want = run_benchmarks.suite_throughput(4, 2, 16, device="cpu", repeats=1)
    np.testing.assert_array_equal(row["checksums"], want.numpy())
    assert not any(tmp_path.iterdir())             # the job's files went with it


def test_scaling_refuses_configs_that_do_not_divide():
    """3 configs over 2 ranks: ``BatchMesh.local_size``'s ``ValueError``, no
    padding (raised before the rank's first collective)."""
    mesh = BatchMesh(2, 0, torch.device("cpu"))
    with pytest.raises(ValueError, match="does not divide over 2 processes"):
        run_benchmarks.suite_throughput(3, 2, 8, device="cpu", mesh=mesh)


@pytest.mark.parametrize("script, why", [
    ("print('rendezvous stuck', file=sys.stderr, flush=True); time.sleep(600)",
     "did not finish within 3 s"),
    ("print('rank failed', file=sys.stderr, flush=True); sys.exit(3)",
     "exited with code 3"),
])
def test_run_ranks_kills_the_job(script, why):
    """A rank that hangs or fails ends the job: every rank still running is
    killed and the error carries the rank's stderr."""
    hung = [sys.executable, "-c", "import sys, time; " + script]
    sleeper = [sys.executable, "-c", "import time; time.sleep(600)"]
    with pytest.raises(RuntimeError, match=re.escape(why)) as err:
        run_benchmarks._run_ranks([(hung, None), (sleeper, None)], timeout=3)
    assert str(err.value).startswith("process 0 of 2 ")
    assert ("stuck" if "finish" in why else "rank failed") in str(err.value)


def test_run_scaling_writes_only_into_its_out(tmp_path, monkeypatch):
    monkeypatch.setattr(run_benchmarks, "SCALING_WORLD_SIZES", (1, 2))
    before = {p: p.read_bytes() for p in REPO.glob("RESULTS*")}
    rank_rows, chip_rows, report = run_benchmarks.main(
        ["--scaling", "--device", "cpu", "--out", str(tmp_path), "--scaling-configs", "4",
         "--scaling-replicas", "2", "--scaling-steps", "8"])
    assert [r["devices"] for r in rank_rows] == [1, 2] and chip_rows == []
    np.testing.assert_array_equal(rank_rows[0]["checksums"], rank_rows[1]["checksums"])
    assert {p: p.read_bytes() for p in REPO.glob("RESULTS*")} == before
    assert sorted(p.name for p in tmp_path.iterdir()) == ["RESULTS_SCALING.md"]
    text = report.read_text()
    for row in rank_rows:
        assert f"| {row['devices']} | {row['env_steps_per_sec']:,.0f} |" in text
    assert "gloo" in text and "TPU" not in text


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_scaling_report_rows_match_the_jax_writer(tmp_path, monkeypatch, device):
    """The same rows through both writers give the same table rows; the
    port names the host's cores or the card and its power limit, never a
    TPU, and keeps the section a run did not measure from its own report."""
    jax_tool = _load("tools/run_benchmarks.py", "run_benchmarks_jax_report")
    card = "NVIDIA H100 80GB HBM3, 700.00 W"
    if device == "cuda":
        monkeypatch.setattr(run_benchmarks, "resolve_device", lambda d: torch.device("cuda", 0))
        monkeypatch.setattr(run_benchmarks, "_card_label", lambda d: card)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    args = argparse.Namespace(scaling_configs=8, scaling_replicas=256, scaling_steps=200,
                              device=device)
    rank_rows = [{"devices": 1, "env_steps_per_sec": 1_234_567.8},
                 {"devices": 2, "env_steps_per_sec": 2_345_678.9}]
    chip_rows = [{"replicas": r, "total_envs": 25 * r, "env_steps_per_sec": 1e6 * r / 256}
                 for r in run_benchmarks.CHIP_REPLICAS]
    jax_tool._write_scaling_report(tmp_path / "jax.md", rank_rows, chip_rows, args)
    ours = tmp_path / "port.md"
    run_benchmarks.write_scaling_report(ours, [], chip_rows, args)
    run_benchmarks.write_scaling_report(ours, rank_rows, [], args)   # keeps the sweep

    def rows(text):
        return [ln for ln in text.splitlines() if ln.startswith("|")]

    got = ours.read_text()
    prose = " ".join(got.split())
    assert rows(got) == rows((tmp_path / "jax.md").read_text())
    assert len(rows(got)) == 4 + 2 + len(chip_rows)
    assert "| 204,800 | 32,000,000 |" in got and "| 2 | 2,345,679 | 1.90x |" in got
    assert "TPU" not in got and "v5e" not in got
    if device == "cuda":
        assert prose.count(card) == 2 and "World sizes 1, 2 of 1, 2, 4, 8 ran" in prose
        assert "this host has 1." in prose
    else:
        assert f"the {os.cpu_count()} physical cores of this host" in prose
        assert f"the CPU ({os.cpu_count()} cores)" in prose


def test_profile_env_matches_the_jax_tool(monkeypatch, capsys):
    jax_tool = _load("tools/profile_env.py", "profile_env_jax")
    jax_outs = []

    def recorded(fn, *args, repeats=3):
        jax_outs.append(fn(*args))
        return 1.0

    monkeypatch.setattr(jax_tool, "timeit", recorded)
    monkeypatch.setattr(sys, "argv", ["profile_env.py", "--batch", "8", "--steps", "16"])
    jax_tool.main()
    want = capsys.readouterr().out.splitlines()
    results = profile_env.main(["--device", "cpu", "--batch", "8", "--steps", "16"])
    got = capsys.readouterr().out.splitlines()

    labels = ["fused rollout keep_obs=True", "fused rollout keep_obs=False",
              "suite rollout (obs checksummed)"]
    assert [ln.split(": ")[0] for ln in got] == [ln.split(": ")[0] for ln in want] == labels
    assert all(re.fullmatch(r".*: \d+\.\d\dM env-steps/s  \(\d+\.\d{3}s\)", ln) for ln in got)
    assert [r[0] for r in results] == labels
    for (_, _, (_, outs)), (_, jouts), keep_obs in zip(results, jax_outs, (True, False)):
        np.testing.assert_allclose(outs.reward.numpy(), np.asarray(jouts.reward), rtol=1e-5)
        assert (outs.obs is None) == (jouts.obs is None) == (not keep_obs)
        if keep_obs:
            assert outs.obs.shape == (16, 8, np.asarray(jouts.obs).shape[-1])
            np.testing.assert_allclose(outs.obs.numpy(), np.asarray(jouts.obs), rtol=1e-5)
    suite = results[2][2]
    assert suite.shape == (1, 8)
    np.testing.assert_allclose(suite.numpy(), np.asarray(jax_outs[2]), rtol=1e-5)


def test_speed_tools_default_to_the_card(tmp_path):
    assert run_benchmarks.parse_args([]).device == "cuda"
    assert profile_env.parse_args([]).device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        run_benchmarks.main(["--scaling", "--scaling-chip", "--out", str(tmp_path)])
    with pytest.raises(RuntimeError, match="CUDA"):
        profile_env.main(["--batch", "8", "--steps", "8"])
    assert not any(tmp_path.iterdir())


def test_scaling_worker_line_is_the_jax_workers(tmp_path, monkeypatch, capsys):
    """In-process at world size 1 over gloo: rank 0's one stdout line has
    the JAX worker's keys, and its checksums file is the gathered output."""
    from pymgrid_tpu_torch.parallel.distributed import free_port

    for k, v in {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(free_port()),
                 "RANK": "0", "WORLD_SIZE": "1"}.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(torch, "set_num_threads", lambda n: None)
    sps, checksums = run_benchmarks.main(
        ["--scaling-worker", "1", "--device", "cpu", "--out", str(tmp_path),
         "--scaling-configs", "2", "--scaling-replicas", "2", "--scaling-steps", "8"])
    line, = capsys.readouterr().out.splitlines()
    assert json.loads(line) == {"devices": 1, "env_steps_per_sec": sps}
    np.testing.assert_array_equal(np.load(tmp_path / "scaling-1.npy"), checksums)
    assert not torch.distributed.is_initialized()
