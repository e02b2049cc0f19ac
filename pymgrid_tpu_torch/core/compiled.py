"""High-level handle on the engine for a single config.

Port of :class:`pymgrid_tpu.core.compiled.CompiledMicrogrid`.  States, actions
and step outputs carry a leading ``(1, 1)`` (config, replica) axis, the
engine's batch layout at ``C = B = 1``.
"""
import dataclasses

import numpy as np
import torch

from pymgrid_tpu_torch._device import numpy_dtype, resolve_device, torch_dtype
from pymgrid_tpu_torch.core import prng
from pymgrid_tpu_torch.core.engine import (
    _forecasts_at,
    check_supported,
    make_reset_fn,
    make_step_fn,
    needs_keys,
)
from pymgrid_tpu_torch.core.params import params_to_torch, with_config_axis
from pymgrid_tpu_torch.core.spec import extract_spec

__all__ = ["CompiledMicrogrid"]


class CompiledMicrogrid:
    def __init__(self, microgrid, dtype, device="cuda", numpy_rng_noise=False, seed=0):
        """``numpy_rng_noise``: replay the host's global-numpy-RNG gaussian
        forecast stream (snapshotted now) from a bank, so seeded
        gaussian-forecast trajectories equal the host bitwise.  Otherwise
        gaussian forecasts draw from the threefry key of ``seed`` (the
        default of :meth:`reset`), the JAX engine's draws for that seed."""
        self.device = resolve_device(device)
        self.dtype = torch_dtype(dtype)
        spec, params, self._state0 = extract_spec(microgrid, dtype=numpy_dtype(dtype))
        if numpy_rng_noise:
            from pymgrid_tpu_torch.core.noise_bank import precompute_numpy_noise

            banks = precompute_numpy_noise(microgrid, spec, numpy_dtype(dtype))
            if banks:
                spec = dataclasses.replace(spec, numpy_noise=True)
                for kind, bank in banks.items():
                    params[kind]["np_noise"] = bank
        check_supported(spec)
        self.spec = spec
        self.params = with_config_axis(params_to_torch(params, self.device, self.dtype))
        self._reset_fn = make_reset_fn(spec)
        self._step_fns = {
            False: make_step_fn(spec, normalized=False),
            True: make_step_fn(spec, normalized=True),
        }
        self._seed = seed

    # ------------------------------------------------------------------ api
    def reset(self, seed=None):
        """The state at the config's initial step; ``seed`` (default: the
        constructor's) keys the gaussian forecasts, as
        ``jax.random.PRNGKey(seed)`` keys them in the JAX engine."""
        key = prng.key(self._seed if seed is None else seed, self.device).view(1, 1, 2)
        return self._reset_fn(self.params, self.params["initial_step"].view(1, 1), key)

    def initial_state(self, seed=None):
        """State matching the host microgrid's current (extraction-time)
        module state rather than a fresh reset."""
        state = self.reset(seed)

        def lift(x, dtype):
            return torch.as_tensor(np.asarray(x), device=self.device).to(dtype).view(1, 1, -1)

        state["step"] = lift(self._state0["step"], torch.int32).view(1, 1)
        state["battery_charge"] = lift(self._state0["battery_charge"], self.dtype)
        state["genset"] = {
            k: lift(v, torch.int32) for k, v in self._state0["genset"].items()
        }
        if needs_keys(self.spec):
            state["forecast"] = _forecasts_at(self.spec, self.params, state["step"],
                                              state["rng"])
        return state

    def step(self, state, action, normalized=False):
        return self._step_fns[normalized](self.params, state, action)

    def save_state(self, path, state):
        """Checkpoint an engine state to the file ``path``."""
        from pymgrid_tpu_torch.utils.checkpoint import save_state

        save_state(path, state)

    def restore_state(self, path):
        """Restore a checkpoint onto this engine's device and dtypes;
        continuing from it reproduces the uninterrupted trajectory
        bitwise."""
        from pymgrid_tpu_torch.utils.checkpoint import restore_state

        return restore_state(path, template=self.reset(seed=0))

    # -------------------------------------------------------- action mapping
    def action_to_arrays(self, action_dict):
        """Host-style action dict -> engine action tensors ``(1, 1, ...)``."""
        out = {k: v.clone() for k, v in self.zero_action().items()}
        for ref in self.spec.controllable:
            entry = np.asarray(action_dict[ref.name][ref.num], dtype=np.float64)
            value = torch.as_tensor(entry, device=self.device).to(self.dtype)
            if ref.kind == "genset":
                out["genset"][0, 0, ref.slot] = value.reshape(2)
            else:
                out[ref.kind][0, 0, ref.slot] = value.reshape(())
        return out

    def zero_action(self):
        sizes = self.spec.action_sizes()
        zeros = lambda *shape: torch.zeros((1, 1) + shape, dtype=self.dtype,
                                           device=self.device)
        return {
            "battery": zeros(sizes["battery"]),
            "genset": zeros(sizes["genset"], 2),
            "grid": zeros(sizes["grid"]),
        }

    # ------------------------------------------------------------ log mapping
    def log_frame(self, log_rows, initial_step=None):
        """Stacked engine log rows ``(T, ..., n_log_fields)`` -> the host
        ``get_log`` DataFrame."""
        import pandas as pd

        if isinstance(log_rows, torch.Tensor):
            log_rows = log_rows.detach().cpu().numpy()
        log_rows = np.asarray(log_rows).reshape(-1, self.spec.n_log_fields)
        start = self.spec_initial_step if initial_step is None else initial_step
        return pd.DataFrame(
            log_rows,
            columns=pd.MultiIndex.from_tuples(
                self.spec.log_columns,
                names=["module_name", "module_number", "field"],
            ),
            index=pd.RangeIndex(start=start, stop=start + log_rows.shape[0]),
        )

    @property
    def spec_initial_step(self):
        return int(self.params["initial_step"][0])
