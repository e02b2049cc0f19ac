"""The port imports and steps with JAX and the JAX package unavailable, and
never imports either."""
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
sys.modules["jax"] = None          # any `import jax` now raises ImportError,
sys.modules["pymgrid_tpu"] = None  # and so does any import of the JAX package
import torch
import pymgrid_tpu_torch
names = [m.name for m in pkgutil.walk_packages(pymgrid_tpu_torch.__path__,
                                                "pymgrid_tpu_torch.")]
for name in names:
    importlib.import_module(name)

for name in ("pymgrid_tpu_torch.parallel.batch", "pymgrid_tpu_torch.parallel.batched_env",
             "pymgrid_tpu_torch.utils.checkpoint", "pymgrid_tpu_torch.core.lp",
             "pymgrid_tpu_torch.algos.mpc_batched", "pymgrid_tpu_torch.algos.mpc_suite",
             "pymgrid_tpu_torch.algos.saa_batched", "pymgrid_tpu_torch.examples.train_rl",
             "pymgrid_tpu_torch.examples.train_es", "pymgrid_tpu_torch.parallel.distributed",
             "pymgrid_tpu_torch.utils.profiling", "pymgrid_tpu_torch.entry",
             "pymgrid_tpu_torch.core.prng", "pymgrid_tpu_torch.algos.saa",
             "pymgrid_tpu_torch.algos.nonmodular_rbc", "pymgrid_tpu_torch.generator",
             "pymgrid_tpu_torch.legacy_envs", "pymgrid_tpu_torch.legacy_envs.csca",
             "pymgrid_tpu_torch.legacy_envs.csca_old", "pymgrid_tpu_torch.legacy_envs.csda",
             "pymgrid_tpu_torch.legacy_envs.cspla", "pymgrid_tpu_torch.legacy_envs.environment",
             "pymgrid_tpu_torch.legacy_envs.preprocessing", "pymgrid_tpu_torch.envs.gym_adapter",
             "pymgrid_tpu_torch.utils.ray", "pymgrid_tpu_torch.version",
             "pymgrid_tpu_torch.examples.scenario0_structure", "pymgrid_tpu_torch.tools",
             "pymgrid_tpu_torch.tools.run_benchmarks",
             "pymgrid_tpu_torch.tools.run_legacy_benchmarks",
             "pymgrid_tpu_torch.tools.saa_report", "pymgrid_tpu_torch.tools.profile_env",
             "pymgrid_tpu_torch.tools.bench"):
    assert name in names, name

from pymgrid_tpu_torch import Microgrid
from pymgrid_tpu_torch.envs import DiscreteMicrogridEnv
from pymgrid_tpu_torch.parallel import BatchedDiscreteEnv
from pymgrid_tpu_torch.core.compiled import CompiledMicrogrid
for n in (0, 1):
    scenario = Microgrid.from_scenario(n)
    assert type(scenario).__module__ == "pymgrid_tpu_torch.microgrid.microgrid"
    assert len(scenario) == 8760
mg = CompiledMicrogrid(Microgrid.from_scenario(0), dtype="float64", device="cpu")
state, out = mg.step(mg.reset(), mg.zero_action())
assert out.obs.shape == (1, 1, mg.spec.obs_dim)
assert torch.isfinite(out.reward).all() and int(state["step"]) == 1
noisy = Microgrid.from_scenario(0)
noisy.set_forecaster(0.1, forecast_horizon=23)
mg = CompiledMicrogrid(noisy, dtype="float64", device="cpu", seed=3)
state, out = mg.step(mg.reset(), mg.zero_action())
assert state["rng"].shape == (1, 1, 2) and torch.isfinite(out.obs).all()
import pymgrid_tpu_torch as port
gen = port.MicrogridGenerator(nb_microgrid=1, random_seed=0).generate_microgrid(modular=False)
assert isinstance(gen.microgrids[0], port.NonModularMicrogrid) and port.__version__
env = BatchedDiscreteEnv(DiscreteMicrogridEnv.from_scenario(1), batch_size=3,
                         dtype="float32", device="cpu")
_, outs = env.rollout(env.reset(), [[0, 1, 2]] * 4, shared_step=True)
assert outs.obs.shape == (4, 3, env.obs_dim) and torch.isfinite(outs.reward).all()
from pymgrid_tpu_torch.algos import BatchedMPC
mpc = BatchedMPC(Microgrid.from_scenario(0), batch_size=2, iters=3,
                 dtype="float64", device="cpu", host_fallback=False)
rewards, _ = mpc.run_scanned(2)
assert rewards.shape == (2, 2)
assert not [m for m in sys.modules if m.split(".")[0] in ("jax", "pymgrid_tpu")
            and sys.modules[m] is not None]
print("OK", len(names))
"""


def test_port_imports_and_steps_without_jax():
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    proc = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("OK")
    assert int(proc.stdout.split()[1]) >= 75  # every module was walked, the host layer too


def test_no_file_of_the_port_imports_jax():
    """No line of the port or of chip_smoke.py, at any indentation, imports
    jax, optax, orbax, the JAX package or the repository's ``tools`` and
    ``examples`` programs."""
    pattern = re.compile(r"^\s*(import|from)\s+((jax|optax|orbax|tools|examples)\b"
                         r"|pymgrid_tpu(\.|\s|$))", re.M)
    assert pattern.search("    from tools.saa_report import write_report")
    assert pattern.search("import examples.train_rl")
    assert not pattern.search("from pymgrid_tpu_torch.tools import run_benchmarks")
    assert pattern.search("    from pymgrid_tpu.core import physics")
    assert pattern.search("import pymgrid_tpu")
    assert not pattern.search("from pymgrid_tpu_torch.core import physics")
    files = sorted(PACKAGE.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    offenders = [str(f) for f in files if pattern.search(f.read_text())]
    assert offenders == []
