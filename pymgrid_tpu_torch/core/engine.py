"""The microgrid engine on torch tensors.

Port of :mod:`pymgrid_tpu.core.engine`.  ``make_step_fn(spec)`` builds

    step(params, state, action) -> (new_state, StepOutput)

reproducing the host :meth:`Microgrid.run` three-phase dispatch with the same
module order, the same balance summation trees
(:func:`~pymgrid_tpu_torch.core.numpy_sum.numpy_sum_compat`) and the same
clipping and cost semantics (:mod:`pymgrid_tpu_torch.core.physics`, run
through the torch namespace :mod:`pymgrid_tpu_torch.core.xp`).

Batching is written out: ``params`` leaves carry a leading config axis
``(C, ...)``, state and action leaves ``(C, B, ...)`` (configs x replicas), and
per-config constants broadcast as ``(C, 1)``.  ``state["step"]`` may also be
``(C, 1)``: every replica of a config then shares the simulated time (the
lockstep sweep), and time-dependent rows are read once per config.  One step
function thus serves the single-config rollouts, the lockstep sweep and the
suite.

Eager PyTorch removes no dead code, so the step builds the observation and the
log row only when asked (``with_obs`` / ``with_log``); rewards-only loops skip
both.  Out-of-range step indices clamp, as ``lax.dynamic_slice`` does.

A state reset with per-replica threefry keys
(:mod:`pymgrid_tpu_torch.core.prng`) carries them as ``rng`` ``(C, B, 2)``,
and each step splits them as the JAX engine does (the new ``rng`` is
``split(rng)[0]``), so key-drawn randomness (the random policy, the suite's
randomized restarts) follows the JAX engine's keys.  Gaussian forecasters
without the numpy noise bank draw from them the same noise as the JAX
engine's ``jax.random``: such a spec needs keys (:func:`needs_keys`), and its
state also carries the realized windows in ``forecast``, redrawn at
``t + 1``.  A keyless reset keeps the keyless layout.  User callables
(forecasters, battery transition models, genset costs) run per replica under ``torch.func.vmap`` over the flattened
``(C*B)`` axis, so they see the per-replica values and shapes they see in
the JAX engine.
"""
import math
from typing import Any, NamedTuple

import torch
from torch.overrides import TorchFunctionMode

from pymgrid_tpu_torch.core import physics, prng
from pymgrid_tpu_torch.core.numpy_sum import numpy_sum_compat
from pymgrid_tpu_torch.core.tables import (
    logfc_table_layout,
    obs_table_layout,
    row_table_layout,
    tabulable,
)
from pymgrid_tpu_torch._device import torch_dtype
from pymgrid_tpu_torch.core import xp

__all__ = [
    "StepOutput",
    "make_step_fn",
    "make_reset_fn",
    "ts_obs_part",
    "gather_rows",
    "slot_param",
    "check_supported",
    "needs_keys",
    "reset_keys",
    "realized_forecast",
]


class StepOutput(NamedTuple):
    obs: Any           # (C, B, obs_dim) normalized observation, or None
    reward: Any        # (C, B) summed module reward
    shaped_reward: Any # (C, B) (== reward unless spec.shaper)
    done: Any          # (C, B) bool
    log_row: Any       # (C, B, n_log_fields) per-step log record, or None
    provided: Any      # (C, B) overall provided energy
    absorbed: Any      # (C, B) overall absorbed energy


def check_supported(spec):
    """Raise for module kinds outside the engine's three phases."""
    for ref in spec.fixed:
        if ref.kind != "load":
            raise NotImplementedError(f"fixed-phase kind {ref.kind} unsupported")
    for ref in spec.controllable:
        if ref.kind not in ("battery", "genset", "grid"):
            raise NotImplementedError(f"controllable-phase kind {ref.kind} unsupported")
    for ref in spec.flex:
        if ref.kind not in ("renewable", "balancing"):
            raise NotImplementedError(f"flex-phase kind {ref.kind} unsupported")


def needs_keys(spec):
    """Whether the spec draws gaussian forecasts from threefry keys (no
    numpy noise bank): its states then carry ``rng`` and ``forecast``."""
    return not spec.numpy_noise and any(
        ref.forecaster == "gaussian" for ref in spec.log_order
    )


def reset_keys(spec, seed, device, shape=None):
    """The keys a reset of ``spec`` takes from ``seed``: ``key(seed)`` as
    ``(1, 1, 2)``, or with ``shape = (C, B)`` ``split(key(seed), C*B)`` as
    ``(C, B, 2)``; ``None`` for a spec that draws no threefry gaussians, so
    its state stays keyless."""
    if not needs_keys(spec):
        return None
    key = prng.key(seed, device)
    if shape is None:
        return key.view(1, 1, 2)
    C, B = shape
    return prng.split(key, C * B).view(C, B, 2)


class _NumpyBoolArithmetic(TorchFunctionMode):
    """``1 - mask`` as numpy and jax.numpy compute it: torch refuses to
    subtract a bool tensor, so a user callable written for numpy (e.g.
    ``x * (1 - (x >= 0))``) sees the mask as an integer there."""

    _SUB = {torch.Tensor.__sub__, torch.Tensor.__rsub__, torch.sub,
            torch.Tensor.sub, torch.rsub}

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func in self._SUB:
            args = tuple(a.long() if isinstance(a, torch.Tensor)
                         and a.dtype == torch.bool else a for a in args)
        return func(*args, **(kwargs or {}))


def _per_replica(ref, fn, batch, dtype, *args):
    """``fn(*args)`` once per replica: every tensor leaf of ``args`` (nested
    dicts allowed) broadcasts to ``batch + its trailing shape`` and the batch
    flattens into the one axis ``torch.func.vmap`` maps over.  The result
    comes back as ``batch + per-replica shape`` in ``dtype``.  A callable
    that branches on a value (or fails otherwise) raises
    ``NotImplementedError`` with the JAX engine's guidance."""
    n = math.prod(batch)

    def flat(x):
        if isinstance(x, dict):
            return {k: flat(v) for k, v in x.items()}
        x = x.expand(batch + x.shape[len(batch):])
        return x.reshape((n,) + x.shape[len(batch):])

    def call(*xs):
        out = fn(*xs)
        if isinstance(out, torch.Tensor):
            return out.to(dtype)
        return torch.as_tensor(out, dtype=dtype, device=xs[0].device)

    try:
        with _NumpyBoolArithmetic():
            out = torch.func.vmap(call)(*[flat(a) for a in args])
    except Exception as exc:
        raise NotImplementedError(
            f"The custom callable on module ({ref.name}, {ref.num}) cannot run "
            f"per replica in the engine; use the host Microgrid.run path, or "
            f"rewrite the callable with torch/numpy-compatible ops (no Python "
            f"branching on values). Original error: {exc!r}"
        ) from exc
    return out.reshape(batch + out.shape[1:])


def _custom_battery_transition(ref, p, i, eff, charge, max_prod, max_cons,
                               prov, absd, dtype):
    """A user ``battery_transition_model`` for both flow directions, called
    with keyword arguments only, as the host module calls it: the external
    energy change is negative for a discharge and positive for a charge, the
    return value is the internal energy change."""
    params = {k: slot_param(p[k], i) for k in
              ("min_capacity", "max_capacity", "max_charge", "max_discharge",
               "battery_cost_cycle")}
    batch = charge.shape
    values = dict(params, efficiency=eff, max_production=max_prod,
                  max_consumption=max_cons, charge=charge)

    def transition(external, v):
        return ref.custom_fn(
            external_energy_change=external,
            min_capacity=v["min_capacity"], max_capacity=v["max_capacity"],
            max_charge=v["max_charge"], max_discharge=v["max_discharge"],
            efficiency=v["efficiency"], battery_cost_cycle=v["battery_cost_cycle"],
            max_production=v["max_production"], max_consumption=v["max_consumption"],
            state_dict={"soc": v["charge"] / v["max_capacity"],
                        "current_charge": v["charge"]},
        )

    internal_src = _per_replica(ref, transition, batch, dtype, -1.0 * prov, values)
    internal_snk = _per_replica(ref, transition, batch, dtype, absd, values)
    return internal_src, internal_snk


def slot_param(x, i):
    """Slot ``i`` of a ``(C, n, ...)`` param as ``(C, 1, ...)``."""
    return x[:, i].unsqueeze(1)


def _config_index(table, ndim):
    return torch.arange(table.shape[0], device=table.device).view(
        (-1,) + (1,) * (ndim - 1)
    )


def gather_rows(table, t):
    """``table (C, T, ...)`` at per-config-and-replica steps ``t (C, B)`` ->
    ``(C, B, ...)``; ``t`` clamps into ``[0, T - 1]`` like
    ``lax.dynamic_index_in_dim``."""
    idx = t.long().clamp(0, table.shape[1] - 1)
    return table[_config_index(table, idx.dim()), idx]


def _gather_window(table, start, h):
    """``h`` consecutive rows of ``table (C, T, ...)`` from ``start (C, B)``
    -> ``(C, B, h, ...)``; the start clamps so the window fits, as
    ``lax.dynamic_slice`` clamps."""
    start = start.long().clamp(0, table.shape[1] - h)
    idx = start.unsqueeze(-1) + torch.arange(h, device=table.device)
    return table[_config_index(table, idx.dim()), idx]


def _gaussian_refs(spec, kind):
    return [m for m in spec.log_order if m.kind == kind and m.forecaster == "gaussian"]


def _off_end_mask(ref, t, h):
    """``(C, B, h, 1)`` mask of forecast rows that lie inside the data."""
    n_real = (ref.ts_length - 1 - t.long()).clamp(0, h)
    return (torch.arange(h, device=t.device) < n_real.unsqueeze(-1)).unsqueeze(-1)


def _obs_bounds(params, ref):
    p = params[ref.kind]
    return (slot_param(p["obs_low"], ref.slot).unsqueeze(2),
            slot_param(p["obs_high"], ref.slot).unsqueeze(2))


def _oracle_window(params, ref, t):
    """Deterministic forecast window at ``t``: ``(C, B, h, f)``."""
    ts_slot = params[ref.kind]["ts"][:, ref.slot]
    return _gather_window(ts_slot, t + 1, ref.forecast_horizon)


def _numpy_noise_window(spec, params, ref, t):
    """Gaussian forecast from the precomputed numpy-RNG noise bank."""
    h = ref.forecast_horizon
    gslot = [m.slot for m in _gaussian_refs(spec, ref.kind)].index(ref.slot)
    window = _oracle_window(params, ref, t)
    noise = gather_rows(params[ref.kind]["np_noise"][:, gslot], t)[..., :h, :]
    window = window + noise * _off_end_mask(ref, t, h)
    low, high = _obs_bounds(params, ref)
    return torch.clamp(window, low, high)


def _user_window(params, ref, t):
    """A deterministic user forecaster's window: the callable runs per
    replica on the fill-padded window (``custom_fn(val_c, window, h, xp)``
    with ``val_c (f,)`` and ``window (h, f)``); rows past the data end
    revert to the fill and the result clips to the observation bounds, the
    host's truncate/pad/clip sequence for row-wise callables."""
    h = ref.forecast_horizon
    window = _oracle_window(params, ref, t)
    val_c = _ts_row(params, ref.kind, ref.slot, t)
    raw = _per_replica(
        ref, lambda v, w: ref.custom_fn(v, w, h, xp), t.shape, window.dtype,
        val_c, window,
    ).reshape(window.shape)
    out = torch.where(_off_end_mask(ref, t, h), raw, window)
    low, high = _obs_bounds(params, ref)
    return torch.clamp(out, low, high)


def _forecasts_at(spec, params, t, key):
    """The realized threefry-gaussian windows at step ``t``:
    ``{kind: (C, B, n_gauss, max_h, f)}`` for ``key (C, B, 2)``.  Each
    gaussian module, kind by kind in the order load, renewable, grid, takes
    ``key, sub = split(key)`` and ``normal(sub, (h, f))`` as the JAX engine's
    ``_forecasts_at`` does."""
    out = {}
    for kind in ("load", "renewable", "grid"):
        refs = _gaussian_refs(spec, kind)
        if not refs:
            continue
        max_h = max(ref.forecast_horizon for ref in refs)
        rows = []
        for ref in refs:
            h, f = ref.forecast_horizon, ref.n_features
            window = _oracle_window(params, ref, t)
            pair = prng.split(key)
            key, sub = pair[..., 0, :], pair[..., 1, :]
            std = params[kind]["noise_std"][:, ref.slot, :h].unsqueeze(1)
            noise = prng.normal(sub, (h, f), window.dtype) * std
            window = window + noise * _off_end_mask(ref, t, h)
            low, high = _obs_bounds(params, ref)
            window = torch.clamp(window, low, high)
            if h < max_h:
                window = torch.cat(
                    [window, window.new_zeros(window.shape[:-2] + (max_h - h, f))], dim=-2
                )
            rows.append(window)
        out[kind] = torch.stack(rows, dim=2)
    return out


def _user_bank_window(params, ref, t):
    """Stochastic user forecast replayed from the realization bank."""
    h = ref.forecast_horizon
    window = _oracle_window(params, ref, t)
    raw = gather_rows(params[ref.kind]["user_bank"][:, ref.slot], t)[..., :h, :]
    out = torch.where(_off_end_mask(ref, t, h), raw, window)
    low, high = _obs_bounds(params, ref)
    return torch.clamp(out, low, high)


def realized_forecast(spec, params, ref, t, state=None):
    """Forecast window of ``ref`` valid at step ``t``, ``(C, B, h, f)``, or
    ``None`` without a horizon.  Threefry-gaussian windows ride in
    ``state["forecast"]`` (the value logged at ``t`` is the one observed at
    the end of step ``t - 1``); every other forecaster is a pure function of
    ``t``."""
    if ref.forecast_horizon == 0:
        return None
    if ref.forecaster == "gaussian":
        if spec.numpy_noise:
            return _numpy_noise_window(spec, params, ref, t)
        gslot = [m.slot for m in _gaussian_refs(spec, ref.kind)].index(ref.slot)
        return state["forecast"][ref.kind][:, :, gslot, : ref.forecast_horizon]
    if ref.forecaster == "user":
        return _user_window(params, ref, t)
    if ref.forecaster == "user_bank":
        return _user_bank_window(params, ref, t)
    return _oracle_window(params, ref, t)


def _ts_row(params, kind, slot, t):
    return gather_rows(params[kind]["ts"][:, slot], t)


def ts_obs_part(spec, params, t, ref, state=None):
    """Normalized observation segment of one ts module at step ``t``:
    current row + forecast window, ``(C, B, obs_dim)`` (``state`` carries
    threefry-gaussian windows).  Also the row generator of
    :func:`pymgrid_tpu_torch.core.tables.build_tables`, so table lookups
    equal this expression by construction."""
    row = _ts_row(params, ref.kind, ref.slot, t)
    low = slot_param(params[ref.kind]["obs_low"], ref.slot)
    spread = slot_param(params[ref.kind]["obs_spread"], ref.slot)
    vals = [(row - low) / spread]
    if ref.forecast_horizon > 0:
        fc = realized_forecast(spec, params, ref, t, state)
        vals.append(
            ((fc - low.unsqueeze(2)) / spread.unsqueeze(2)).flatten(-2)
        )
        # a shared (C, 1) step's row beside per-replica gaussian windows
        lead = torch.broadcast_shapes(vals[0].shape[:-1], vals[1].shape[:-1])
        vals = [v.expand(lead + v.shape[-1:]) for v in vals]
    return torch.cat(vals, dim=-1)


def make_reset_fn(spec):
    """Build ``reset(params, initial_step, key=None) -> state``.

    ``initial_step`` is a ``(C, B)`` integer tensor of episode starts (the
    caller's randomized starts, or ``params["initial_step"]`` broadcast);
    it also fixes the replica count ``B``.  State leaves are ``(C, B, ...)``;
    step and genset counters are int32.  ``key`` is the replicas' threefry
    keys ``(C, B, 2)``: given, the state carries them as ``rng`` (the step
    splits them); a spec that :func:`needs_keys` requires them and draws its
    windows from them into ``forecast``.  Shared ``(C, 1)`` starts (the
    lockstep layout) take per-replica keys too: then ``rng`` and
    ``forecast`` are per replica and the other leaves shared.
    """
    keyed = needs_keys(spec)

    def reset(params, initial_step, key=None):
        t0 = initial_step.to(torch.int32)
        C, B = t0.shape
        pg = params["genset"]
        init_status = pg["init_status"].to(torch.int32)
        on = init_status == 1
        zero = torch.zeros_like(init_status)

        def per_replica(x):
            return x.unsqueeze(1).expand(C, B, x.shape[-1]).contiguous()

        state = {
            "step": t0,
            "battery_charge": per_replica(params["battery"]["init_charge"]),
            "genset": {
                "current_status": per_replica(init_status),
                "goal_status": per_replica(init_status),
                "steps_until_up": per_replica(
                    torch.where(on, zero, pg["start_up_time"].to(torch.int32))
                ),
                "steps_until_down": per_replica(
                    torch.where(on, pg["wind_down_time"].to(torch.int32), zero)
                ),
            },
            "forecast": {},
        }
        if key is None:
            if keyed:
                raise ValueError(f"this spec draws gaussian forecasts: reset needs "
                                 f"keys of shape {(C, B, 2)}, got None")
            return state
        if (key.dim() != 3 or key.shape[0] != C or key.shape[2] != 2
                or B not in (1, key.shape[1])):
            raise ValueError(f"reset needs keys of shape {(C, B, 2)}, got {tuple(key.shape)}")
        state["rng"] = key
        if keyed:
            state["forecast"] = _forecasts_at(spec, params, t0, key)
        return state

    return reset


def make_step_fn(spec, normalized=False, with_obs=True, with_log=True,
                 obs_layout="log"):
    """Build the engine step for ``spec`` (see the module docstring).

    ``normalized``: incoming actions are in [0, 1] and are denormalized
    (genset goal entries never are).  ``with_obs`` / ``with_log``: build the
    outgoing observation / log row; ``StepOutput.obs`` / ``.log_row`` are
    ``None`` otherwise.  ``obs_layout``: ``"log"`` concatenates observation
    segments in container (log) order; ``"env"`` in the gym env's flattened
    order (Dict spaces sort module names), so batched envs need no
    permutation gather.
    """
    check_supported(spec)
    dtype = torch_dtype(spec.dtype)
    keyed = needs_keys(spec)
    if obs_layout == "log":
        obs_order = spec.log_order
    elif obs_layout == "env":
        obs_order = tuple(sorted(spec.log_order, key=lambda ref: (ref.name, ref.num)))
    else:
        raise ValueError(f"obs_layout must be 'log' or 'env', got {obs_layout!r}")
    row_layout, row_width = row_table_layout(spec)
    logfc_layout, _ = logfc_table_layout(spec)

    def ts_done(params, kind, slot, t):
        return t >= slot_param(params[kind]["final_step"], slot) - 1

    def step(params, state, action):
        t = state["step"]
        batch = torch.broadcast_shapes(t.shape, state["battery_charge"].shape[:-1])
        zero = torch.zeros((), dtype=dtype, device=t.device)
        provided, absorbed, rewards, dones = [], [], [], []
        log_vals = {}
        shaper_terms = []   # (name, field, value) the reward shapers sum

        table_row = None
        if "step_table" in params:
            table_row = gather_rows(params["step_table"], t)
        logfc_row = None
        if with_log and "logfc_table" in params:
            logfc_row = gather_rows(params["logfc_table"], t)

        def cur_row(kind, slot):
            if table_row is not None:
                off, width = row_layout[(kind, slot)]
                return table_row[..., off : off + width]
            return _ts_row(params, kind, slot, t)

        def log_forecast(lv, ref):
            if ref.forecast_horizon == 0:
                return
            if logfc_row is not None and (ref.name, ref.num) in logfc_layout:
                off, width = logfc_layout[(ref.name, ref.num)]
                window = logfc_row[..., off : off + width].unflatten(
                    -1, (ref.forecast_horizon, ref.n_features)
                )
            else:
                window = realized_forecast(spec, params, ref, t, state)
            current = [f for f in ref.log_fields if f.endswith("_current")]
            components = [f[: -len("_current")] for f in current]
            for j in range(ref.forecast_horizon):
                for c_idx, comp in enumerate(components):
                    lv[f"{comp}_forecast_{j}"] = window[..., j, c_idx]

        # --------------------------------------------------- phase 1: fixed
        for ref in spec.fixed:
            row = cur_row("load", ref.slot)
            load_met = -row[..., 0]
            absorbed.append(load_met)
            rewards.append(zero)
            dones.append(ts_done(params, "load", ref.slot, t))
            shaper_terms.append((ref.name, "load_met", load_met))
            if with_log:
                lv = {"reward": zero, "load_met": load_met,
                      "load_current": row[..., 0]}
                log_forecast(lv, ref)
                log_vals[(ref.name, ref.num)] = lv

        fixed_provided = numpy_sum_compat(provided)
        fixed_absorbed = numpy_sum_compat(absorbed)

        # -------------------------------------------- phase 2: controllable
        charges = list(state["battery_charge"].unbind(-1))
        gs = state["genset"]
        new_gs = {k: list(v.unbind(-1)) for k, v in gs.items()}

        for ref in spec.controllable:
            if ref.kind == "battery":
                i = ref.slot
                p = params["battery"]
                a = action["battery"][..., i]
                if normalized:
                    a = slot_param(p["act_low"], i) + slot_param(p["act_spread"], i) * a
                charge = charges[i]
                eff = slot_param(p["efficiency"], i)
                min_cap = slot_param(p["min_capacity"], i)
                max_cap = slot_param(p["max_capacity"], i)
                max_prod = physics.battery_max_production(
                    charge, min_cap, slot_param(p["max_discharge"], i), eff, xp=xp
                )
                max_cons = physics.battery_max_consumption(
                    charge, max_cap, slot_param(p["max_charge"], i), eff, xp=xp
                )
                is_sink = a < 0
                prov = physics.clip_source(a, zero, max_prod, xp=xp)
                absd = physics.clip_sink(-a, max_cons, xp=xp)
                if ref.custom_fn is not None:
                    internal_src, internal_snk = _custom_battery_transition(
                        ref, p, i, eff, charge, max_prod, max_cons, prov, absd, dtype
                    )
                else:
                    internal_src = -prov / eff
                    internal_snk = absd * eff
                prov = torch.where(is_sink, zero, prov)
                absd = torch.where(is_sink, absd, zero)
                internal = torch.where(is_sink, internal_snk, internal_src)
                charge_new = charge + internal
                charge_new = torch.where(charge_new < min_cap, min_cap, charge_new)
                reward = -1.0 * (internal.abs() * slot_param(p["battery_cost_cycle"], i))
                charges[i] = charge_new
                provided.append(prov)
                absorbed.append(absd)
                rewards.append(reward)
                shaper_terms.append((ref.name, ref.log_fields[1], prov))
                if with_log:
                    log_vals[(ref.name, ref.num)] = {
                        "reward": reward,
                        ref.log_fields[1]: prov,
                        ref.log_fields[2]: absd,
                        "soc": charge / max_cap,
                        "current_charge": charge,
                    }
            elif ref.kind == "genset":
                j = ref.slot
                p = params["genset"]
                goal_raw = action["genset"][..., j, 0]
                energy = action["genset"][..., j, 1]
                if normalized:
                    energy = slot_param(p["act_low"], j) + slot_param(p["act_spread"], j) * energy
                g = physics.round_half_even(goal_raw, xp=xp).to(torch.int32)
                cur, goal_st, up, down = physics.genset_update_status(
                    gs["current_status"][..., j],
                    gs["goal_status"][..., j],
                    gs["steps_until_up"][..., j],
                    gs["steps_until_down"][..., j],
                    g,
                    slot_param(p["start_up_time"], j).to(torch.int32),
                    slot_param(p["wind_down_time"], j).to(torch.int32),
                    slot_param(p["allow_abortion"], j),
                    xp=xp,
                )
                new_gs["current_status"][j] = cur
                new_gs["goal_status"][j] = goal_st
                new_gs["steps_until_up"][j] = up
                new_gs["steps_until_down"][j] = down
                statusf = cur.to(dtype)
                prov = physics.clip_source(
                    energy,
                    statusf * slot_param(p["running_min_production"], j),
                    statusf * slot_param(p["running_max_production"], j),
                    xp=xp,
                )
                co2 = slot_param(p["co2_per_unit"], j) * prov
                if ref.custom_fn is not None:
                    fuel = _per_replica(ref, ref.custom_fn, prov.shape, dtype, prov)
                else:
                    fuel = slot_param(p["genset_cost"], j) * prov
                reward = -1.0 * (fuel + slot_param(p["cost_per_unit_co2"], j) * co2)
                provided.append(prov)
                rewards.append(reward)
                if with_log:
                    log_vals[(ref.name, ref.num)] = {
                        "reward": reward,
                        "co2_production": co2,
                        ref.log_fields[2]: prov,
                        "current_status": cur.to(dtype),
                        "goal_status": goal_st.to(dtype),
                        "steps_until_up": up.to(dtype),
                        "steps_until_down": down.to(dtype),
                    }
            else:  # grid
                k = ref.slot
                p = params["grid"]
                a = action["grid"][..., k]
                if normalized:
                    a = slot_param(p["act_low"], k) + slot_param(p["act_spread"], k) * a
                row = cur_row("grid", k)        # (import, export, co2, status)
                status = row[..., 3]
                is_sink = a < 0
                prov = physics.clip_source(
                    a, zero, slot_param(p["max_import"], k) * status, xp=xp
                )
                absd = physics.clip_sink(-a, slot_param(p["max_export"], k) * status, xp=xp)
                prov = torch.where(is_sink, zero, prov)
                absd = torch.where(is_sink, absd, zero)
                co2 = torch.where(is_sink, zero, prov * row[..., 2])
                reward_imp = (-1 * row[..., 0]) * prov + (
                    -1.0 * slot_param(p["cost_per_unit_co2"], k)
                ) * co2
                reward_exp = row[..., 1] * absd
                reward = torch.where(is_sink, reward_exp, reward_imp)
                provided.append(prov)
                absorbed.append(absd)
                rewards.append(reward)
                dones.append(ts_done(params, "grid", k, t))
                if with_log:
                    lv = {
                        "reward": reward,
                        "co2_production": co2,
                        "grid_import": prov,
                        "grid_export": absd,
                        "import_price_current": row[..., 0],
                        "export_price_current": row[..., 1],
                        "co2_per_kwh_current": row[..., 2],
                        "grid_status_current": row[..., 3],
                    }
                    log_forecast(lv, ref)
                    log_vals[(ref.name, ref.num)] = lv

        provided_2 = numpy_sum_compat(provided)
        absorbed_2 = numpy_sum_compat(absorbed)
        difference = provided_2 - absorbed_2
        is_excess = difference > 0

        # ---------------------------------------------------- phase 3: flex
        excess = difference
        needed = -difference
        for ref in spec.flex:
            if ref.kind == "renewable":
                r = ref.slot
                cur = cur_row("renewable", r)[..., 0]
                src = torch.where(cur < needed, cur, needed)
                prov = torch.where(is_excess, zero, src)
                curtail = cur - prov
                needed = needed - src
                provided.append(prov)
                rewards.append(zero)
                dones.append(ts_done(params, "renewable", r, t))
                shaper_terms.append((ref.name, "curtailment", curtail))
                if with_log:
                    lv = {
                        "reward": zero,
                        "curtailment": curtail,
                        ref.log_fields[2]: prov,
                        "renewable_current": cur,
                    }
                    log_forecast(lv, ref)
                    log_vals[(ref.name, ref.num)] = lv
            else:  # balancing
                b = ref.slot
                p = params["balancing"]
                absd = torch.where(is_excess, excess, zero)
                prov = torch.where(is_excess, zero, needed)
                reward = torch.where(
                    is_excess,
                    -1.0 * (slot_param(p["overgeneration_cost"], b) * absd),
                    -1.0 * (slot_param(p["loss_load_cost"], b) * prov),
                )
                excess = excess + (-absd)
                needed = needed - prov
                provided.append(prov)
                absorbed.append(absd)
                rewards.append(reward)
                shaper_terms.append((ref.name, ref.log_fields[1], prov))
                if with_log:
                    log_vals[(ref.name, ref.num)] = {
                        "reward": reward,
                        ref.log_fields[1]: prov,
                        ref.log_fields[2]: absd,
                    }

        provided_f = numpy_sum_compat(provided)
        absorbed_f = numpy_sum_compat(absorbed)

        reward_total = zero
        for r in rewards:
            reward_total = reward_total + r
        done = torch.zeros(batch, dtype=torch.bool, device=t.device)
        for d in dones:
            done = done | d
        shaped = _shaped_reward(spec, reward_total, shaper_terms, zero)

        # ------------------------------------------------------ advance time
        new_t = t + 1
        new_state = {
            "step": new_t,
            "battery_charge": _stack_slots(charges, state["battery_charge"]),
            "genset": {k: _stack_slots(v, gs[k]) for k, v in new_gs.items()},
            "forecast": {},
        }
        if "rng" in state:
            pair = prng.split(state["rng"])
            new_state["rng"] = pair[..., 0, :]
            if keyed:
                new_state["forecast"] = _forecasts_at(spec, params, new_t, pair[..., 1, :])

        obs = None
        if with_obs:
            obs = _build_obs(
                spec, params, new_state, batch, dtype, obs_order,
                obs_row=None if table_row is None else table_row[..., row_width:],
            )
        log_row = None
        if with_log:
            log_row = _build_log_row(
                spec, log_vals, batch, dtype, t.device,
                [reward_total, shaped, provided_f, absorbed_f,
                 provided_2 - fixed_provided, absorbed_2 - fixed_absorbed,
                 fixed_provided, fixed_absorbed],
            )

        expand = lambda x: torch.as_tensor(x, dtype=dtype, device=t.device).expand(batch)
        return new_state, StepOutput(
            obs=obs,
            reward=expand(reward_total),
            shaped_reward=expand(shaped),
            done=done,
            log_row=log_row,
            provided=expand(provided_f),
            absorbed=expand(absorbed_f),
        )

    return step


def _stack_slots(slots, like):
    if not slots:
        return like
    return torch.stack(slots, dim=-1)


def _shaped_reward(spec, reward_total, terms, zero):
    """The built-in reward shapers on the step's ``(name, field, value)``
    terms, summed in the JAX engine's order (``pymgrid_tpu/core/engine.py``
    ``_shaped_reward``).  The load divisor stays a tensor."""
    def total(name, field):
        out = zero
        for n, f, value in terms:
            if n == name and f == field:
                out = out + value
        return out

    if spec.shaper is None:
        return reward_total
    if spec.shaper == "pv_curtailment":
        return -1.0 * total("pv", "curtailment")
    battery = total("battery", "discharge_amount")
    load = total("load", "load_met")
    loss = total("unbalanced_energy", "loss_load")
    no_load = load == 0
    return torch.where(no_load, zero,
                       (battery - loss) / torch.where(no_load, 1.0, load))


def _build_obs(spec, params, state, batch, dtype, order, obs_row=None):
    """Normalized observation at ``state['step']``, ``(C, B, obs_dim)``, with
    segments in ``order``.

    ``obs_row``, when the step gathered a table row, carries the tabulated ts
    segments (keyed by module, so any order reads them); otherwise every
    segment is computed from the series."""
    layout = obs_table_layout(spec)[0] if obs_row is not None else {}
    t = state["step"]
    parts = []
    for ref in order:
        if ref.kind in ("load", "renewable", "grid"):
            if obs_row is not None and tabulable(spec, ref):
                off, width = layout[(ref.name, ref.num)]
                parts.append(obs_row[..., off : off + width])
            else:
                parts.append(ts_obs_part(spec, params, t, ref, state))
        elif ref.kind == "battery":
            p = params["battery"]
            charge = state["battery_charge"][..., ref.slot]
            vec = torch.stack([charge / slot_param(p["max_capacity"], ref.slot), charge], -1)
            parts.append(
                (vec - slot_param(p["obs_low"], ref.slot)) / slot_param(p["obs_spread"], ref.slot)
            )
        elif ref.kind == "genset":
            p = params["genset"]
            gs = state["genset"]
            vec = torch.stack(
                [gs[k][..., ref.slot] for k in
                 ("current_status", "goal_status", "steps_until_up", "steps_until_down")],
                -1,
            ).to(dtype)
            parts.append(
                (vec - slot_param(p["obs_low"], ref.slot)) / slot_param(p["obs_spread"], ref.slot)
            )
        # balancing: empty state
    if not parts:
        return torch.zeros(batch + (0,), dtype=dtype, device=t.device)
    return torch.cat([x.expand(batch + x.shape[-1:]) for x in parts], dim=-1)


def _build_log_row(spec, log_vals, batch, dtype, device, balance):
    vals = []
    for ref in spec.log_order:
        lv = log_vals[(ref.name, ref.num)]
        for field in ref.log_fields:
            vals.append(lv[field])
    vals += balance
    return torch.stack(
        [torch.as_tensor(v, device=device).to(dtype).expand(batch) for v in vals],
        dim=-1,
    )
