"""Precomputed numpy-RNG noise banks for bitwise gaussian-forecast parity.

The host's :class:`~pymgrid_tpu_torch.forecast.GaussianNoiseForecaster` draws from
the *global numpy RNG* (reference ``forecast/forecaster.py:220-275``), so a
seeded host trajectory's forecast noise is a deterministic stream.  The
engine does not call numpy per step; instead, this module replays the host's
exact draw order once at compile time — reset draws first (container
``iterdict`` order), then per step the run-phase order (fixed ->
controllable -> flex) — into a device-resident bank ``(T, h, f)`` per module.
Engine rollouts then consume ``bank[t]`` and reproduce seeded host gaussian
trajectories bit for bit (SURVEY §7's numpy-RNG seam, engine side).

``precompute_numpy_noise`` snapshots (or is given) the numpy RNG state, so
build the compiled microgrid at the same RNG point the host run starts from.
"""
import numpy as np

from pymgrid_tpu_torch.forecast.forecaster import GaussianNoiseForecaster

__all__ = ["precompute_numpy_noise"]

_TS_KINDS = {"load": "load", "renewable": "renewable", "grid": "grid"}


def _kind_of(module):
    from pymgrid_tpu_torch.modules import GridModule, LoadModule, RenewableModule

    if isinstance(module, LoadModule):
        return "load"
    if isinstance(module, RenewableModule):
        return "renewable"
    if isinstance(module, GridModule):
        return "grid"
    return None


def _gaussian_ts_modules(container_walk):
    out = []
    for module in container_walk:
        kind = _kind_of(module)
        if kind is not None and isinstance(module.forecaster, GaussianNoiseForecaster):
            out.append((kind, module))
    return out


def _draw_one(rng, module, step):
    """One forecast draw for ``module`` at current step ``step`` with the
    host's exact RNG consumption; returns (n_avail, f) or None (no draw)."""
    T = len(module)
    h = module.forecast_horizon
    f = len(module.state_components)
    if step >= T or h == 0:
        return None  # host takes the full_pad path: no draw
    n_avail = min(max(T - 1 - step, 0), h)
    std = module.forecaster.noise_std
    if np.ndim(std) == 0:
        scale = std
    else:
        scale = np.asarray(std)[:n_avail, :]
    return rng.normal(scale=scale, size=(n_avail, f))


def precompute_numpy_noise(microgrid, spec, dtype, rng_state=None):
    """Noise banks ``{kind: (n_slots, T_bank, max_h, f)}`` replaying the
    host's global-RNG draw order from ``rng_state`` (default: the current
    global numpy RNG state)."""
    rng = np.random.RandomState()
    rng.set_state(rng_state if rng_state is not None else np.random.get_state())

    # draw orders (see host Microgrid.reset / Microgrid.run)
    reset_mods = _gaussian_ts_modules(microgrid.modules.iterlist())
    run_mods = _gaussian_ts_modules(
        list(microgrid.fixed.iterlist())
        + list(microgrid.controllable.iterlist())
        + list(microgrid.flex.iterlist())
    )
    if not reset_mods:
        return {}

    # slot lookup: position among gaussian modules of the same kind, in
    # engine log order (mirrors engine._gaussian_refs)
    gauss_refs = {
        kind: [m for m in spec.log_order if m.kind == kind and m.forecaster == "gaussian"]
        for kind in _TS_KINDS
    }

    def slot_index(kind, module):
        name, num = module.name
        for i, ref in enumerate(gauss_refs[kind]):
            if (ref.name, ref.num) == (name, num):
                return i
        raise KeyError(f"gaussian module {module.name} not in spec")

    banks = {}
    for kind, refs in gauss_refs.items():
        if not refs:
            continue
        max_h = max(r.forecast_horizon for r in refs)
        f = refs[0].n_features
        T_bank = max(r.ts_length for r in refs) + spec.horizon_pad
        banks[kind] = np.zeros((len(refs), T_bank, max_h, f), dtype=dtype)

    def record(module_list, step):
        for kind, module in module_list:
            drawn = _draw_one(rng, module, step)
            if drawn is None:
                continue
            i = slot_index(kind, module)
            banks[kind][i, step, : drawn.shape[0], :] = drawn

    t0 = int(microgrid.initial_step)
    t_max = max(len(m) for _, m in reset_mods)

    record(reset_mods, t0)                # Microgrid.reset draws
    for step in range(t0 + 1, t_max):     # one run step -> draws at step
        record(run_mods, step)

    return banks
