"""The port's profiling helpers (``utils/profiling.py``) on the CPU; the
patterns of ``tests/test_aux.py``, with ``checked_step`` held against the
JAX ``checkify`` step on the same inputs."""
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
from torch.autograd import DeviceType

import pymgrid_tpu.modules as JM
import pymgrid_tpu_torch.modules as M
from helpers.factories import build_microgrid, module_params
from pymgrid_tpu import Microgrid as JaxMicrogrid
from pymgrid_tpu.core.compiled import CompiledMicrogrid as JaxCompiledMicrogrid
from pymgrid_tpu.utils.profiling import checked_step as jax_checked_step
from pymgrid_tpu_torch import Microgrid
from pymgrid_tpu_torch.algos import RuleBasedControl
from pymgrid_tpu_torch.core.compiled import CompiledMicrogrid
from pymgrid_tpu_torch.core.rollout import make_priority_policy, rollout_policy
from pymgrid_tpu_torch.utils.profiling import (
    Throughput,
    check_balance,
    checked_step,
    device_summary,
    trace,
)

torch.set_num_threads(1)


def test_throughput_meter():
    t = Throughput(10, 100, device="cpu")
    assert repr(t) == "Throughput(pending)"
    with t:
        torch.arange(16.0).sum()
    assert t.steps_per_sec > 0 and "env-steps/s" in repr(t)


def test_check_balance_on_rollout():
    rbc = RuleBasedControl(Microgrid(build_microgrid(M, module_params(seed=3))[0]))
    compiled = CompiledMicrogrid(rbc.microgrid, dtype="float64", device="cpu")
    policy = make_priority_policy(compiled.spec, rbc.priority_list)
    _, outputs = rollout_policy(compiled.spec, compiled.params, compiled.reset(), policy, 50)
    assert check_balance(outputs)
    broken = outputs._replace(provided=outputs.provided + 1.0)
    with pytest.raises(RuntimeError, match="unable to balance"):
        check_balance(broken)


def _checked_pair(nan_in_load):
    """The port's and the JAX ``checked_step`` outcome on the same
    factory microgrid, zero action, one step from reset; optionally with a
    NaN put into the load series at the first step."""
    params = module_params(seed=5)
    ours = CompiledMicrogrid(Microgrid(build_microgrid(M, params)[0]), dtype="float64",
                             device="cpu")
    theirs = JaxCompiledMicrogrid(JaxMicrogrid(build_microgrid(JM, params)[0]),
                                  dtype=np.float64)
    state, jstate = ours.reset(), theirs.reset()
    t0 = int(state["step"])
    if nan_in_load:
        ours.params["load"]["ts"] = ours.params["load"]["ts"].clone()
        ours.params["load"]["ts"][0, 0, t0, 0] = float("nan")
        theirs.params["load"]["ts"] = np.array(theirs.params["load"]["ts"])
        theirs.params["load"]["ts"][0, t0, 0] = np.nan
    err, (_, out) = checked_step(ours.spec)(ours.params, state, ours.zero_action())
    zero = {"battery": np.zeros(theirs.spec.n_battery),
            "genset": np.zeros((theirs.spec.n_genset, 2)), "grid": np.zeros(theirs.spec.n_grid)}
    jerr, (_, jout) = jax.jit(jax_checked_step(theirs.spec))(theirs.params, jstate, zero)
    return (err, out), (jerr, jout)


@pytest.mark.parametrize("nan_in_load", [False, True], ids=["valid", "nan_load"])
def test_checked_step_agrees_with_jax(nan_in_load):
    (err, out), (jerr, jout) = _checked_pair(nan_in_load)
    assert (err.get() is None) == (jerr.get() is None) == (not nan_in_load)
    np.testing.assert_array_equal(out.reward.numpy().reshape(()), np.asarray(jout.reward))
    if nan_in_load:
        with pytest.raises(ValueError, match="non-finite reward|energy balance"):
            err.throw()
        with pytest.raises(Exception, match="non-finite reward|energy balance"):
            jerr.throw()
    else:
        err.throw()
        jerr.throw()


def test_profiler_trace(tmp_path):
    with trace(str(tmp_path / "trace"), device="cpu") as prof:
        torch.arange(16.0).sum()
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0
    assert device_summary(prof) == {"kernels": 0, "busy_ms": 0.0}


def test_profiler_trace_default_directory(tmp_path, monkeypatch):
    """Without ``log_dir`` the trace goes to ``pymgrid_tpu_torch_trace`` in
    the system's temporary directory (the JAX function defaults to a
    fixed ``pymgrid_tpu_trace`` directory)."""
    import tempfile

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    with trace(device="cpu"):
        torch.arange(16.0).sum()
    assert (tmp_path / "pymgrid_tpu_torch_trace" / "trace.json").stat().st_size > 0


def test_device_summary_unions_device_intervals():
    """Busy time is the union of the device events' intervals (us): two
    overlapping kernels and a separate copy; host events and a user
    annotation's span on the device (an optimizer step's) do not count."""
    def event(device_type, start, end, annotation=False):
        return SimpleNamespace(device_type=device_type, is_user_annotation=annotation,
                               time_range=SimpleNamespace(start=start, end=end))

    events = [event(DeviceType.CUDA, 0, 10), event(DeviceType.CUDA, 5, 12),
              event(DeviceType.CPU, 0, 100), event(DeviceType.CUDA, 20, 30),
              event(DeviceType.CUDA, 21, 25), event(DeviceType.CUDA, 0, 100, annotation=True)]
    prof = SimpleNamespace(events=lambda: events)
    assert device_summary(prof) == {"kernels": 4, "busy_ms": 0.022}
