"""The import guard compares top-level names whole; the reference loads
nothing of the program; a run without the card fails and prints nothing."""
import os
import subprocess
import sys

import torch

from port_bench import harness, run


def test_guard_compares_whole_top_level_names():
    assert harness.forbidden_modules({"pymgrid_tpu_torch": 1, "pymgrid_tpu_torch.core": 1,
                                      "jaxtyping": 1, "optaxx": 1}) == []
    assert harness.forbidden_modules({"pymgrid_tpu.core.engine": 1, "jax": 1, "jax.numpy": 1,
                                      "jaxlib": 1, "flax.linen": 1, "optax": 1,
                                      "orbax.checkpoint": 1}) == [
        "flax.linen", "jax", "jax.numpy", "jaxlib", "optax", "orbax.checkpoint",
        "pymgrid_tpu.core.engine"]


def test_harness_and_reference_load_nothing_of_the_program_or_jax():
    """In a fresh process whose imports of the program and of JAX fail, the
    harness loads, and both references run two steps."""
    code = """
import sys
for name in ("pymgrid_tpu_torch", "pymgrid_tpu", "jax", "optax", "orbax", "flax"):
    sys.modules[name] = None
import numpy as np
from port_bench import harness
for config in ("pymgrid25-rbc-suite", "pymgrid25-s0-discrete-env"):
    cfg = harness.load_json(harness.BENCH_DIR, "configs", config + ".json")
    ref = harness.load_module("reference", config)
    consts = ref.load(cfg)
    if config.endswith("suite"):
        out = ref.rollout(consts, np.arange(25), np.ones((25, 2), np.uint64), 2, True)
    else:
        out = ref.steps(consts, np.zeros((1, 3), np.int64), 2)
    assert np.isfinite(out["reward"].numpy()).all()
print(sorted(m for m, mod in sys.modules.items()
             if mod is not None and m.split(".")[0].startswith("pymgrid")))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_no_card_fails_without_a_result(capsys, monkeypatch):
    argv = ["--workload", "suite-rbc-collect", "--seed", "1", "--seconds", "1"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(argv) != 0
    assert capsys.readouterr().out == ""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    assert run.main(argv) != 0
    assert capsys.readouterr().out == ""


def test_checkout_without_the_program_fails(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's files: the
    run exits non-zero and prints no result."""
    subprocess.run(["cp", "-r", os.path.join(harness.ROOT, "port_bench"),
                    os.path.join(harness.ROOT, "BENCHMARK.json"), str(tmp_path)], check=True)
    out = subprocess.run([sys.executable, "-m", "port_bench.run", "--workload",
                          "discrete-env-step", "--seed", "1", "--seconds", "1"],
                         cwd=tmp_path, capture_output=True, text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": str(tmp_path)})
    assert out.returncode != 0
    assert not [line for line in out.stdout.splitlines() if line.startswith("{")]
