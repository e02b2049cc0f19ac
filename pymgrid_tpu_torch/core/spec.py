"""Struct-of-arrays description of a microgrid for the compiled engine.

``extract_spec`` walks a host :class:`~pymgrid_tpu_torch.microgrid.Microgrid` in its
canonical container order (fixed -> controllable -> flex, each
sources -> sinks -> source_and_sinks; see
``modules/container.py``) and produces:

* a hashable :class:`MicrogridSpec` of static structure — module kinds,
  per-phase step order, forecaster types, log/observation layout; and
* a ``params`` pytree of arrays — module constants, normalization constants,
  and HBM-resident time series pre-padded with the forecaster's midpoint fill
  rows so oracle forecasts and off-end observations are single
  ``dynamic_slice`` ops.

The engine (:mod:`pymgrid_tpu_torch.core.engine`) unrolls the step order in
Python, so one step serves any number of batched replicas of the config.
"""
import dataclasses
from typing import Optional, Tuple

import numpy as np

from pymgrid_tpu_torch.modules import (
    BatteryModule,
    GensetModule,
    GridModule,
    LoadModule,
    RenewableModule,
    UnbalancedEnergyModule,
)

__all__ = ["ModuleRef", "MicrogridSpec", "extract_spec"]

_KINDS = ("load", "renewable", "battery", "genset", "grid", "balancing")

_FORECASTER_KINDS = ("none", "oracle", "gaussian", "user", "user_bank")


@dataclasses.dataclass(frozen=True)
class ModuleRef:
    """Static reference to one module slot within a spec."""

    kind: str            # one of _KINDS
    slot: int            # index within per-kind arrays
    name: str            # container name, e.g. 'pv'
    num: int             # index among same-named modules
    log_fields: Tuple[str, ...]
    forecaster: str = "none"       # ts modules: none | oracle | gaussian | user
    forecast_horizon: int = 0
    n_features: int = 1
    obs_dim: int = 0
    ts_length: int = 0             # real (unpadded) series length, ts kinds only
    # User-supplied callable traced into the engine: a genset fuel-cost
    # function (reference genset_module.py:183-186) or a battery transition
    # model (reference battery_module.py:149-189).  Must be JAX-traceable;
    # non-traceable callables fail at compile time with guidance to use the
    # host path.
    custom_fn: Optional[object] = None


@dataclasses.dataclass(frozen=True)
class MicrogridSpec:
    fixed: Tuple[ModuleRef, ...]
    controllable: Tuple[ModuleRef, ...]
    flex: Tuple[ModuleRef, ...]
    log_order: Tuple[ModuleRef, ...]   # container iterdict order (get_log order)
    n_load: int
    n_renewable: int
    n_battery: int
    n_genset: int
    n_grid: int
    n_balancing: int
    horizon_pad: int                   # ts padding rows
    shaper: Optional[str] = None       # None | 'pv_curtailment' | 'battery_discharge'
    dtype: str = "float32"
    # gaussian forecasts read a precomputed numpy-RNG noise bank from params
    # (bitwise host parity) instead of drawing fresh noise per episode
    numpy_noise: bool = False

    @property
    def modules(self):
        return self.fixed + self.controllable + self.flex

    @property
    def obs_dim(self):
        return sum(m.obs_dim for m in self.log_order)

    @property
    def log_columns(self):
        """Columns of the engine log row: module fields in container order
        followed by the balance-logger fields (reference ``get_log``)."""
        cols = [
            (m.name, m.num, field) for m in self.log_order for field in m.log_fields
        ]
        cols += [
            ("balance", 0, f)
            for f in (
                "reward",
                "shaped_reward",
                "overall_provided_to_microgrid",
                "overall_absorbed_from_microgrid",
                "controllable_provided_to_microgrid",
                "controllable_absorbed_from_microgrid",
                "fixed_provided_to_microgrid",
                "fixed_absorbed_from_microgrid",
            )
        ]
        return cols

    @property
    def n_log_fields(self):
        return len(self.log_columns)

    def obs_segments(self):
        """Engine obs layout: [(name, num, offset, width)] in container order."""
        segments, offset = [], 0
        for ref in self.log_order:
            segments.append((ref.name, ref.num, offset, ref.obs_dim))
            offset += ref.obs_dim
        return segments

    def env_obs_permutation(self):
        """Indices mapping the engine obs vector to the env's flattened obs
        (gym Dict spaces sort module names alphabetically)."""
        segments = self.obs_segments()
        order = sorted(range(len(segments)), key=lambda i: (segments[i][0], segments[i][1]))
        perm = []
        for i in order:
            _, _, off, width = segments[i]
            perm.extend(range(off, off + width))
        return np.asarray(perm, dtype=np.int32)

    def action_sizes(self):
        """Flat action layout: battery (n_b,), genset (n_g, 2), grid (n_gr,)."""
        return {
            "battery": self.n_battery,
            "genset": self.n_genset,
            "grid": self.n_grid,
        }


def _ts_module_meta(module):
    fc = module.forecaster.__class__.__name__
    if fc == "NoForecaster":
        kind = "none"
    elif fc == "OracleForecaster":
        kind = "oracle"
    elif fc == "GaussianNoiseForecaster":
        kind = "gaussian"
    elif fc == "UserDefinedForecaster":
        kind = "user"
    else:
        raise NotImplementedError(
            f"Engine does not support forecaster {fc}; use the host Microgrid."
        )
    return kind, module.forecast_horizon, len(module.state_components)


def _ts_meta_with_fn(module):
    """Module meta with the forecaster kind refined by the engine probe:
    a STOCHASTIC user callable becomes ``user_bank`` (pre-sampled
    realization bank, built in ``_ts_params``)."""
    kind, h, f = _ts_module_meta(module)
    if kind == "user" and _engine_forecast_fn(module) is None:
        kind = "user_bank"
    return kind, h, f


def _engine_forecast_fn(module):
    """Engine-traceable wrapper for a :class:`UserDefinedForecaster` callable
    (reference ``forecast/forecaster.py:283-373``), or ``None``.

    The engine evaluates the callable on the device on the full (fill-padded)
    forecast window, then reverts off-end rows to the midpoint fill and clips
    — matching the host's truncate/pad/clip sequence for row-wise callables.
    Nondeterministic callables (e.g. drawing from ``np.random``) would have
    their randomness silently frozen at trace time, so they are rejected here
    with guidance to use the host path or a :class:`GaussianNoiseForecaster`.
    """
    forecaster = module.forecaster
    if type(forecaster).__name__ != "UserDefinedForecaster":
        return None
    if getattr(forecaster, "_engine_stochastic", None) is True:
        return None  # already probed (bank path)

    ts = np.asarray(module.time_series, dtype=np.float64)
    h = max(int(module.forecast_horizon), 1)
    window = ts[1 : 1 + min(h, len(ts) - 1)]
    probe = lambda: np.asarray(forecaster._forecaster(ts[0], window, len(window)))
    if not np.array_equal(probe(), probe()):
        # STOCHASTIC user callable (e.g. np.random noise): its randomness
        # would be silently frozen at trace time, so it cannot be traced —
        # instead the engine pre-samples one full realization per step
        # into an HBM bank at spec extraction (``_ts_params``; the
        # noise-bank mechanism generalized, core/noise_bank.py).  Every
        # engine episode replays that realization; host episodes draw
        # fresh — distributionally equivalent, not bitwise (documented in
        # docs/parity.md).
        forecaster._engine_stochastic = True
        return None
    forecaster._engine_stochastic = False

    if forecaster.is_vectorized_forecaster:
        fn = forecaster._user_forecaster

        def traced(val_c, window, n, jnp):
            return jnp.asarray(fn(val_c, window, n)).reshape(window.shape)

        return traced

    scalar_fn = forecaster._user_forecaster

    def traced(val_c, window, n, jnp):
        # the host's vectorize wrapper (forecast/forecaster.py
        # vectorize_scalar_forecaster) as a trace-time unroll
        rows = [
            jnp.asarray(scalar_fn(val_c, window[i], i)).reshape(-1)
            for i in range(n)
        ]
        return jnp.stack(rows).reshape(window.shape)

    return traced


def _ts_log_fields(module, extra_fields):
    keys = module._state_dict_keys
    return tuple(extra_fields) + tuple(keys["current"]) + tuple(keys["forecast"])


def _padded_ts(module, horizon_pad):
    """Time series padded with midpoint fill rows (off-end obs + forecast)."""
    ts = np.asarray(module.time_series, dtype=np.float64)
    n_feat = ts.shape[1]
    space = module.observation_space
    fill_full = ((space.unnormalized.high + space.unnormalized.low) / 2).reshape(-1)
    # obs vector is (1 + horizon) copies of per-feature bounds; first n_feat
    # entries give the per-feature midpoints.
    fill = fill_full[:n_feat]
    pad = np.broadcast_to(fill, (horizon_pad, n_feat))
    return np.concatenate([ts, pad], axis=0)


def _obs_norm_constants(module):
    low = np.asarray(module.min_obs, dtype=np.float64)
    high = np.asarray(module.max_obs, dtype=np.float64)
    spread = high - low
    spread[spread == 0] = 1.0
    return low, spread


def extract_spec(microgrid, dtype=np.float64):
    """Extract (spec, params, initial_state_arrays) from a host microgrid."""
    dtype = np.dtype(dtype)

    slots = {k: [] for k in _KINDS}          # kind -> list of host modules
    refs_by_phase = {"fixed": [], "controllable": [], "flex": []}
    log_order = []

    horizon_pad = 2
    for module in microgrid.modules.iterlist():
        if isinstance(module, (LoadModule, RenewableModule, GridModule)):
            horizon_pad = max(horizon_pad, module.forecast_horizon + 2)

    def make_ref(module, name, num):
        if isinstance(module, LoadModule):
            fkind, h, f = _ts_meta_with_fn(module)
            return ModuleRef(
                "load", len(slots["load"]), name, num,
                _ts_log_fields(module, ("reward", "load_met")),
                fkind, h, f, obs_dim=f * (1 + h), ts_length=len(module),
                custom_fn=_engine_forecast_fn(module),
            )
        if isinstance(module, RenewableModule):
            fkind, h, f = _ts_meta_with_fn(module)
            return ModuleRef(
                "renewable", len(slots["renewable"]), name, num,
                _ts_log_fields(module, ("reward", "curtailment", module.provided_energy_name)),
                fkind, h, f, obs_dim=f * (1 + h), ts_length=len(module),
                custom_fn=_engine_forecast_fn(module),
            )
        if isinstance(module, GridModule):
            fkind, h, f = _ts_meta_with_fn(module)
            return ModuleRef(
                "grid", len(slots["grid"]), name, num,
                _ts_log_fields(module, ("reward", "co2_production", "grid_import", "grid_export")),
                fkind, h, f, obs_dim=f * (1 + h), ts_length=len(module),
                custom_fn=_engine_forecast_fn(module),
            )
        if isinstance(module, BatteryModule):
            return ModuleRef(
                "battery", len(slots["battery"]), name, num,
                ("reward", module.provided_energy_name, module.absorbed_energy_name,
                 "soc", "current_charge"),
                obs_dim=2,
                custom_fn=module.battery_transition_model,
            )
        if isinstance(module, GensetModule):
            return ModuleRef(
                "genset", len(slots["genset"]), name, num,
                ("reward", "co2_production", module.provided_energy_name,
                 "current_status", "goal_status", "steps_until_up", "steps_until_down"),
                obs_dim=4,
                custom_fn=module.genset_cost if callable(module.genset_cost) else None,
            )
        if isinstance(module, UnbalancedEnergyModule):
            return ModuleRef(
                "balancing", len(slots["balancing"]), name, num,
                ("reward", module.provided_energy_name, module.absorbed_energy_name),
                obs_dim=0,
            )
        raise NotImplementedError(
            f"Engine does not support module type {type(module).__name__}; "
            f"use the host Microgrid."
        )

    # walk container order once; phase membership from module_type[1]
    for name, modules in microgrid.modules.iterdict():
        for num, module in enumerate(modules):
            ref = make_ref(module, name, num)
            slots[ref.kind].append(module)
            log_order.append(ref)
            refs_by_phase[module.module_type[1]].append(ref)

    spec = MicrogridSpec(
        fixed=tuple(refs_by_phase["fixed"]),
        controllable=tuple(refs_by_phase["controllable"]),
        flex=tuple(refs_by_phase["flex"]),
        log_order=tuple(log_order),
        n_load=len(slots["load"]),
        n_renewable=len(slots["renewable"]),
        n_battery=len(slots["battery"]),
        n_genset=len(slots["genset"]),
        n_grid=len(slots["grid"]),
        n_balancing=len(slots["balancing"]),
        horizon_pad=horizon_pad,
        shaper=_shaper_kind(microgrid.reward_shaping_func),
        dtype=dtype.name,
    )

    params = _extract_params(microgrid, slots, spec, dtype)
    state = _initial_state_arrays(microgrid, slots, dtype)
    return spec, params, state


def _shaper_kind(func):
    if func is None:
        return None
    name = type(func).__name__
    if name == "PVCurtailmentShaper":
        return "pv_curtailment"
    if name == "BatteryDischargeShaper":
        return "battery_discharge"
    raise NotImplementedError(
        f"Engine supports built-in reward shapers only, got {name}."
    )


def _stack(mods, attr, dtype):
    return np.array([getattr(m, attr) for m in mods], dtype=dtype)


def _ts_params(mods, spec, dtype):
    if not mods:
        return {
            "ts": np.zeros((0, 1, 1), dtype=dtype),
            "final_step": np.zeros((0,), dtype=np.int64),
            "obs_low": np.zeros((0, 1), dtype=dtype),
            "obs_high": np.zeros((0, 1), dtype=dtype),
            "obs_spread": np.zeros((0, 1), dtype=dtype),
            "noise_std": np.zeros((0, 1, 1), dtype=dtype),
        }
    lengths = [len(m) for m in mods]
    max_len = max(lengths)
    padded = []
    for m in mods:
        arr = _padded_ts(m, spec.horizon_pad + (max_len - len(m)))
        padded.append(arr)
    ts = np.stack(padded).astype(dtype)
    lows, highs, spreads = [], [], []
    for m in mods:
        low, spread = _obs_norm_constants(m)
        n_feat = len(m.state_components)
        high = np.asarray(m.max_obs, dtype=np.float64)
        lows.append(low[:n_feat])
        highs.append(high[:n_feat])
        spreads.append(spread[:n_feat])
    noise = []
    for m in mods:
        h = max(m.forecast_horizon, 1)
        n_feat = len(m.state_components)
        std = getattr(m.forecaster, "noise_std", 0.0)
        noise.append(np.broadcast_to(np.asarray(std, dtype=np.float64), (h, n_feat)))
    max_h = max(n.shape[0] for n in noise)
    noise = np.stack(
        [np.pad(n, ((0, max_h - n.shape[0]), (0, 0))) for n in noise]
    )
    out = {
        "ts": ts,
        "final_step": _stack(mods, "final_step", np.int64),
        "obs_low": np.stack(lows).astype(dtype),
        "obs_high": np.stack(highs).astype(dtype),
        "obs_spread": np.stack(spreads).astype(dtype),
        "noise_std": noise.astype(dtype),
    }
    # STOCHASTIC user forecasters: pre-sample one full realization per step
    # into an HBM bank (the numpy-RNG noise-bank mechanism generalized to
    # arbitrary callables).  One host call per step, in ascending-t order,
    # drawing from the callable's own RNG state at extraction time; the
    # engine replays bank[t] with the same off-end revert + clip as the
    # traced deterministic path.
    banks = []
    has_bank = False
    for mi, m in enumerate(mods):
        h = max(m.forecast_horizon, 1)
        n_feat = len(m.state_components)
        fc = m.forecaster
        if not getattr(fc, "_engine_stochastic", False):
            banks.append(np.zeros((max_len, max_h, n_feat)))
            continue
        has_bank = True
        arr = padded[mi]  # fill-padded rows, same windows the engine sees
        bank = np.zeros((max_len, max_h, n_feat))
        for t in range(max_len):
            window = arr[t + 1 : t + 1 + h]
            raw = np.asarray(
                fc._forecaster(arr[t], window, h), dtype=np.float64
            ).reshape(h, n_feat)
            bank[t, :h] = raw
        banks.append(bank)
    if has_bank:
        out["user_bank"] = np.stack(banks).astype(dtype)
    return out


def _extract_params(microgrid, slots, spec, dtype):
    params = {
        "load": _ts_params(slots["load"], spec, dtype),
        "renewable": _ts_params(slots["renewable"], spec, dtype),
        "grid": _ts_params(slots["grid"], spec, dtype),
    }

    def act_norm(mods, pos):
        """Action-space (low, spread) at energy position, from host spaces."""
        if not mods:
            z = np.zeros((0,), dtype=dtype)
            return z, np.ones((0,), dtype=dtype)
        low = np.array([m._action_space.low[pos] for m in mods], dtype=dtype)
        spread = np.array([m._action_space.spread[pos] for m in mods], dtype=dtype)
        return low, spread

    def obs_norm(mods, dim):
        if not mods:
            return np.zeros((0, dim), dtype=dtype), np.ones((0, dim), dtype=dtype)
        low = np.stack([m._observation_space.low for m in mods]).astype(dtype)
        spread = np.stack([m._observation_space.spread for m in mods]).astype(dtype)
        return low, spread

    grids = slots["grid"]
    g_act_low, g_act_spread = act_norm(grids, 0)
    params["grid"].update(
        {
            "max_import": _stack(grids, "max_import", dtype),
            "max_export": _stack(grids, "max_export", dtype),
            "cost_per_unit_co2": _stack(grids, "cost_per_unit_co2", dtype),
            "act_low": g_act_low,
            "act_spread": g_act_spread,
        }
    )

    batteries = slots["battery"]
    params["battery"] = {
        "min_capacity": _stack(batteries, "min_capacity", dtype),
        "max_capacity": _stack(batteries, "max_capacity", dtype),
        "max_charge": _stack(batteries, "max_charge", dtype),
        "max_discharge": _stack(batteries, "max_discharge", dtype),
        "efficiency": _stack(batteries, "efficiency", dtype),
        "battery_cost_cycle": _stack(batteries, "battery_cost_cycle", dtype),
        "init_charge": np.array(
            [m.init_charge if m.init_charge is not None else m.init_soc * m.max_capacity
             for m in batteries],
            dtype=dtype,
        ),
        "min_soc": _stack(batteries, "min_soc", dtype),
    }
    b_act_low, b_act_spread = act_norm(batteries, 0)
    b_obs_low, b_obs_spread = obs_norm(batteries, 2)
    params["battery"].update(
        {
            "act_low": b_act_low,
            "act_spread": b_act_spread,
            "obs_low": b_obs_low,
            "obs_spread": b_obs_spread,
        }
    )

    gensets = slots["genset"]
    params["genset"] = {
        "running_min_production": _stack(gensets, "running_min_production", dtype),
        "running_max_production": _stack(gensets, "running_max_production", dtype),
        # Callable costs are traced into the engine via ModuleRef.custom_fn;
        # the scalar slot then only feeds the runtime marginal-cost policy
        # ordering, where fuel-at-unit-production keeps the reference's
        # get_cost(1.0) ordering (genset_module.py:226-227).
        "genset_cost": np.array(
            [m.genset_cost(1.0) if callable(m.genset_cost) else m.genset_cost
             for m in gensets],
            dtype=dtype,
        ),
        "co2_per_unit": _stack(gensets, "co2_per_unit", dtype),
        "cost_per_unit_co2": _stack(gensets, "cost_per_unit_co2", dtype),
        "start_up_time": _stack(gensets, "start_up_time", np.int64),
        "wind_down_time": _stack(gensets, "wind_down_time", np.int64),
        "allow_abortion": _stack(gensets, "allow_abortion", bool),
        "init_status": np.array([int(m.init_start_up) for m in gensets], dtype=np.int64),
    }
    gen_act_low, gen_act_spread = act_norm(gensets, 1)
    gen_obs_low, gen_obs_spread = obs_norm(gensets, 4)
    params["genset"].update(
        {
            "act_low": gen_act_low,
            "act_spread": gen_act_spread,
            "obs_low": gen_obs_low,
            "obs_spread": gen_obs_spread,
        }
    )

    balancing = slots["balancing"]
    params["balancing"] = {
        "loss_load_cost": _stack(balancing, "loss_load_cost", dtype),
        "overgeneration_cost": _stack(balancing, "overgeneration_cost", dtype),
    }

    params["initial_step"] = np.int64(microgrid.initial_step)
    params["final_step"] = np.int64(
        microgrid.final_step if np.isfinite(microgrid.final_step) else np.iinfo(np.int64).max
    )
    return params


def _initial_state_arrays(microgrid, slots, dtype):
    gensets = slots["genset"]
    genset_state = {
        "current_status": np.array([m._current_status for m in gensets], dtype=np.int64),
        "goal_status": np.array([m._goal_status for m in gensets], dtype=np.int64),
        "steps_until_up": np.array([m._steps_until_up for m in gensets], dtype=np.int64),
        "steps_until_down": np.array([m._steps_until_down for m in gensets], dtype=np.int64),
    }
    return {
        "step": np.int64(microgrid.modules.get_attrs("current_step", unique=True).item()),
        "battery_charge": np.array(
            [m.current_charge for m in slots["battery"]], dtype=dtype
        ),
        "genset": genset_state,
    }
