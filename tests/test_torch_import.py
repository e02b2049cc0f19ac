"""The port imports and steps with JAX unavailable, and never imports it."""
import os
import re
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
PACKAGE = REPO / "pymgrid_tpu_torch"

torch.set_num_threads(1)

_SCRIPT = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None  # any `import jax` now raises ImportError
import torch
import pymgrid_tpu_torch
names = [m.name for m in pkgutil.walk_packages(pymgrid_tpu_torch.__path__,
                                                "pymgrid_tpu_torch.")]
for name in names:
    importlib.import_module(name)

for name in ("pymgrid_tpu_torch.parallel.batch", "pymgrid_tpu_torch.parallel.batched_env",
             "pymgrid_tpu_torch.utils.checkpoint"):
    assert name in names, name

import pymgrid_tpu
from pymgrid_tpu.envs import DiscreteMicrogridEnv
from pymgrid_tpu_torch.parallel import BatchedDiscreteEnv
from pymgrid_tpu_torch.core.compiled import CompiledMicrogrid
mg = CompiledMicrogrid(pymgrid_tpu.Microgrid.from_scenario(0), dtype="float64",
                       device="cpu")
state, out = mg.step(mg.reset(), mg.zero_action())
assert out.obs.shape == (1, 1, mg.spec.obs_dim)
assert torch.isfinite(out.reward).all() and int(state["step"]) == 1
env = BatchedDiscreteEnv(DiscreteMicrogridEnv.from_scenario(1), batch_size=3,
                         dtype="float32", device="cpu")
_, outs = env.rollout(env.reset(), [[0, 1, 2]] * 4, shared_step=True)
assert outs.obs.shape == (4, 3, env.obs_dim) and torch.isfinite(outs.reward).all()
print("OK", len(names))
"""


def test_port_imports_and_steps_without_jax():
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    proc = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("OK")
    assert int(proc.stdout.split()[1]) >= 16  # every module was walked


def test_no_file_of_the_port_imports_jax():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|optax|orbax)\b", re.M)
    files = sorted(PACKAGE.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    offenders = [str(f) for f in files if pattern.search(f.read_text())]
    assert offenders == []
