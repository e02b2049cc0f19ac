"""Data asset resolution.

Benchmark data (the ``pymgrid25`` scenario suite and the load/PV/CO2
profiles) is read where the repository keeps it, in ``pymgrid_tpu/data``
beside this package, found by a path relative to this file (reading those
files runs no code of that package), unless ``$PYMGRID_TPU_DATA_DIR``
names another directory.
"""
import os
from pathlib import Path

PROJECT_PATH = Path(__file__).parent

_REPO_DATA = PROJECT_PATH.parent / "pymgrid_tpu" / "data"


def data_dir():
    env = os.environ.get("PYMGRID_TPU_DATA_DIR")
    if env:
        return Path(env)
    if _REPO_DATA.exists():
        return _REPO_DATA
    raise FileNotFoundError(
        f"No pymgrid data directory found at {_REPO_DATA}. Set PYMGRID_TPU_DATA_DIR."
    )


def scenario_yaml_path(n):
    d = data_dir() / "scenario" / "pymgrid25" / f"microgrid_{n}" / f"microgrid_{n}.yaml"
    if d.exists():
        return d
    raise FileNotFoundError(f"Scenario {n} not found under {d}.")
