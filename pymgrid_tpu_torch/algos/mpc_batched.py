"""Batched model predictive control on torch tensors.

Port of :mod:`pymgrid_tpu.algos.mpc_jax` (the JAX module's name says what
it runs on; this package never imports JAX).  Receding-horizon MPC whose
horizon LPs are solved on the device for a whole batch of replicas at once
(:mod:`pymgrid_tpu_torch.core.lp`), the first-step controls driving the
port's engine:

    state -> (c, b, h) from the series windows -> batched interior-point
    solve (plus the genset MILP pattern enumeration) -> first-block controls
    -> balance repair -> engine step -> state'

The LP is the host MPC's modular formulation: the block matrices, the
static costs and the HiGHS fallback come from the host
:class:`pymgrid_tpu_torch.algos.mpc.ModelPredictiveControl` as they are.

Layouts.  The engine's tensors are ``(C, B, ...)``, configs x replicas.  The
LP tensors (``c``, ``b``, ``h``, solutions ``x``, patterns ``u``) put the
config axis LAST among the batch axes, ``(..., B, C, n)``: a template's
per-config constants are ``(C, n)`` and broadcast over any leading axes
(pattern chunks, samples), and flattening ``(k, C)`` gives the solvers'
heterogeneous ``(k, S)`` problem layout.  A template built from one
microgrid has ``C = 1``; :meth:`ProblemTemplate.stack` joins several
(:class:`~pymgrid_tpu_torch.algos.mpc_suite.SuiteMPC`).  The assembly,
the patterns, the action extraction and the balance repair are elementwise
and equal the JAX package bitwise in float64.
"""
import copy
import time

import numpy as np
import torch

from pymgrid_tpu_torch._device import numpy_dtype, resolve_device, torch_dtype
from pymgrid_tpu_torch.algos.mpc import ModelPredictiveControl
from pymgrid_tpu_torch.core.spec import extract_spec
from pymgrid_tpu_torch.core import prng
from pymgrid_tpu_torch.core.engine import _gather_window, make_reset_fn, make_step_fn
from pymgrid_tpu_torch.core.lp import make_batched_box_ipm_solver, make_batched_ipm_solver
from pymgrid_tpu_torch.core.params import (
    params_to_torch,
    with_config_axis,
    without_config_axis,
)
from pymgrid_tpu_torch.parallel.batch import drop_config_axis

__all__ = ["BatchedMPC", "ProblemTemplate"]


def _clip(x, lo, hi):
    """``jnp.clip``: ``minimum(maximum(x, lo), hi)``."""
    return torch.minimum(torch.maximum(x, lo), hi)


def _with_slot(leaf, index, value):
    """A copy of ``leaf`` with ``leaf[..., *index] = value``."""
    out = leaf.clone()
    out[(Ellipsis,) + index] = value
    return out


def run_chunked(step, states, n_steps, chunk, progress=None):
    """``n_steps`` calls of ``step(states) -> (states, reward)``.  Rewards stay
    on the device and are copied to the host once per ``chunk`` steps (once
    at the end with ``chunk=None``); ``progress``, if given, gets one line per
    copy.  Returns the ``(n_steps, ...)`` numpy rewards and the final states."""
    seg = n_steps if chunk is None else min(chunk, n_steps)
    segments, pending = [], []
    t0 = time.perf_counter()
    for k in range(n_steps):
        states, reward = step(states)
        pending.append(reward)
        if len(pending) == seg or k == n_steps - 1:
            segments.append(torch.stack(pending).cpu().numpy())
            pending = []
            if progress is not None:
                progress(f"steps {k + 1}/{n_steps} "
                         f"(segment {time.perf_counter() - t0:.1f}s)")
                t0 = time.perf_counter()
    return np.concatenate(segments, axis=0), states


def series_window(params, kind, slot, t, h):
    """``h`` rows of a one-feature series from the ``(C, B)`` steps ``t``,
    as ``(B, C, h)``; the start clamps as ``lax.dynamic_slice`` clamps."""
    return _gather_window(params[kind]["ts"][:, slot], t, h)[..., 0].transpose(0, 1)


class ProblemTemplate:
    """Static LP structure of one microgrid and the assembly of ``(c, b, h)``
    from horizon vectors, on ``device`` in ``dtype``.

    Wraps the host MPC's block matrices.  Genset configs get H extra
    semi-continuity rows (``-p_t <= -p_min*u_t``) whose right-hand sides
    :meth:`apply_genset_pattern` fills per status pattern.  ``params`` (the
    engine's, config axis first) is an argument of every method, so one
    template serves any params of its structure.
    """

    def __init__(self, microgrid, iters=30, *, dtype, device="cuda", relax_genset=False,
                 matmul_precision="float32", build_solver=True, newton_refine=None,
                 solver_kind="ipm"):
        from scipy import sparse

        self.device, self.dtype = resolve_device(device), torch_dtype(dtype)
        self.host_mpc = ModelPredictiveControl(microgrid)
        self.relax_genset = relax_genset
        self.spec, params, _ = extract_spec(microgrid, dtype=numpy_dtype(dtype))
        self.params = with_config_axis(params_to_torch(params, self.device, self.dtype))

        host = self.host_mpc
        self.horizon = host.horizon
        self.idx = host._idx
        self.block = host._block
        self.rows_per_step = host._rows_per_step
        self.has_genset = host.has_genset
        self._set_constants(np.asarray(host._costs, np.float64)[None],
                            [float(host.p_genset_min)], [float(host.p_genset_max)])

        K_eq = np.asarray(host._A_eq.todense())
        K_in = np.asarray(host._C_ub.todense())
        if self.has_genset:
            # H extra semi-continuity rows: -p_genset_t <= -p_min * u_t
            H, nb = self.horizon, self.block
            min_rows = sparse.lil_matrix((H, K_in.shape[1]))
            for j in range(H):
                min_rows[j, j * nb] = -1.0
            K_in = np.concatenate([K_in, np.asarray(min_rows.todense())], axis=0)
        self.n_in_rows = K_in.shape[0]
        self.matmul_precision = matmul_precision
        self.K_eq_np = K_eq
        self.K_in_np = K_in
        self.x_scale_np = self._variable_scales(microgrid)
        self.newton_refine = newton_refine
        if solver_kind not in ("ipm", "box"):
            raise ValueError(f"solver_kind must be 'ipm' or 'box', got {solver_kind!r}")
        factory = make_batched_box_ipm_solver if solver_kind == "box" else make_batched_ipm_solver
        self.solver = (
            factory(K_eq, K_in, iters=iters, dtype=numpy_dtype(dtype),
                    x_scale=self.x_scale_np, newton_refine=newton_refine,
                    matmul_precision=matmul_precision, device=self.device)
            if build_solver else None
        )

        self.load_ref = next(m for m in self.spec.fixed if m.kind == "load")
        self.pv_ref = next(m for m in self.spec.flex if m.kind == "renewable")
        self.grid_refs = [m for m in self.spec.controllable if m.kind == "grid"]
        self.genset_refs = [m for m in self.spec.controllable if m.kind == "genset"]
        self.battery_ref = next(m for m in self.spec.controllable if m.kind == "battery")

    def _set_constants(self, costs, p_min, p_max):
        """Per-config constants, ``costs (C, n0)``, ``p_min``/``p_max (C,)``
        (float64 numpy), as tensors; derived thresholds are computed in
        float64 first, as the JAX package computes them in Python."""
        p_min = np.asarray(p_min, np.float64)
        p_max = np.asarray(p_max, np.float64)
        self._constants_np = (costs, p_min, p_max)

        def as_t(a):
            return torch.as_tensor(np.asarray(a, np.float64), device=self.device).to(self.dtype)

        tol = 1e-7 * np.maximum(p_min, 1.0)
        self.costs_static = as_t(costs)
        self.p_genset_min = as_t(p_min)
        self.p_genset_max = as_t(p_max)
        self._neg_p_genset_min = as_t(-p_min)
        self._on_threshold = as_t(0.5 * p_min)
        self._frac_lo = as_t(tol)
        self._frac_hi = as_t(p_min - tol)

    @staticmethod
    def stack(templates):
        """One template over several microgrids of one LP structure (the
        superset-normalized scenarios of a suite): their constants stack
        along the config axis in order, and ``K_eq_np``, ``K_in_np`` and
        ``x_scale_np`` become ``(S, ...)`` stacks for a heterogeneous
        solver.  It has no params, host MPC or solver of its own."""
        first = templates[0]
        out = copy.copy(first)
        out.host_mpc = out.params = out.solver = None
        out._set_constants(*(np.concatenate([t._constants_np[i] for t in templates])
                             for i in range(3)))
        out.K_eq_np = np.stack([t.K_eq_np for t in templates])
        out.K_in_np = np.stack([t.K_in_np for t in templates])
        out.x_scale_np = np.stack([t.x_scale_np for t in templates])
        return out

    def _variable_scales(self, microgrid):
        """Typical magnitude of each LP variable (per-step block tiled over
        the horizon) for the IPM's column equilibration: power flows scale
        with their caps, SOC with 1."""
        names = self.host_mpc.microgrid_module_names
        battery = microgrid.modules[names["battery"]].item()
        pv_peak = float(np.abs(microgrid.modules[names["renewable"]].item().time_series).max())
        load_peak = float(np.abs(microgrid.modules[names["load"]].item().time_series).max())
        if "grid" in names:
            grid = microgrid.modules[names["grid"]].item()
            import_cap, export_cap = grid.max_import, grid.max_export
        else:
            import_cap = export_cap = 0.0
        block = [float(self._constants_np[2][0])] if self.has_genset else []
        block += [import_cap, export_cap, battery.max_charge, battery.max_discharge,
                  pv_peak, load_peak, 1.0]
        return np.tile(np.maximum(np.asarray(block, dtype=np.float64), 1.0), self.horizon)

    # ------------------------------------------------------------- assembly
    def grid_windows(self, params, t):
        """Grid series over ``[t, t+H)`` for the ``(C, B)`` steps ``t``:
        prices, co2 and status ``(B, C, H)``; caps and co2 cost ``(C,)``."""
        H = self.horizon
        if self.grid_refs:
            g = self.grid_refs[0].slot
            pg = params["grid"]
            win = _gather_window(pg["ts"][:, g], t, H).transpose(0, 1)   # (B, C, H, 4)
            return dict(
                price_imp=win[..., 0], price_exp=win[..., 1], grid_co2=win[..., 2],
                grid_status_real=win[..., 3], p_max_imp=pg["max_import"][:, g],
                p_max_exp=pg["max_export"][:, g], cost_co2=pg["cost_per_unit_co2"][:, g],
            )
        kw = dict(dtype=self.dtype, device=t.device)
        zeros = torch.zeros(t.shape[::-1] + (H,), **kw)
        zero = torch.zeros(t.shape[0], **kw)
        return dict(price_imp=zeros, price_exp=zeros, grid_co2=zeros,
                    grid_status_real=torch.ones(t.shape[::-1] + (H,), **kw),
                    p_max_imp=zero, p_max_exp=zero, cost_co2=zero)

    def soc_0(self, params, state):
        """State of charge of the ``(C, B, ...)`` engine state, ``(B, C)``."""
        i = self.battery_ref.slot
        return (state["battery_charge"][..., i]
                / params["battery"]["max_capacity"][:, i, None]).T

    def assemble(self, params, load_vec, pv_vec, grid, grid_status, soc_0):
        """LP data from horizon vectors, in the relaxed genset form (cap rows
        at ``p_max``, minimum rows at 0).

        ``load_vec``, ``pv_vec`` and ``grid_status`` are ``(..., C, H)`` (or
        broadcast to it), ``soc_0`` is ``(..., C)`` and ``grid`` is the dict
        of :meth:`grid_windows`; returns ``c (..., C, n0)``, ``b (..., C,
        2H)`` and ``h (..., C, n_in_rows)``."""
        H, idx, nb, rps = self.horizon, self.idx, self.block, self.rows_per_step
        pb = params["battery"]
        i = self.battery_ref.slot
        batch = torch.broadcast_shapes(
            load_vec.shape[:-1], pv_vec.shape[:-1], grid_status.shape[:-1],
            grid["price_imp"].shape[:-1], soc_0.shape,
        )

        b = load_vec.new_zeros(batch + (2 * H,))
        b[..., :H] = load_vec - pv_vec
        b[..., H] = soc_0

        n_cfg = pb["min_soc"].shape[0]
        ones = torch.ones(n_cfg, dtype=self.dtype, device=load_vec.device)
        zeros = torch.zeros_like(ones)
        per_step = [self.p_genset_max.expand(n_cfg)] if self.has_genset else []
        per_step += [ones, -pb["min_soc"][:, i], pb["max_charge"][:, i],
                     pb["max_discharge"][:, i], zeros, zeros, zeros, zeros]
        h = torch.stack(per_step, dim=-1).repeat(1, H)            # (C, rps*H)
        h = h.expand(batch + h.shape[-1:]).clone()
        off = rps - 4
        h[..., off::rps] = grid["p_max_imp"][:, None] * grid_status
        h[..., off + 1::rps] = grid["p_max_exp"][:, None] * grid_status
        h[..., off + 2::rps] = pv_vec
        h[..., off + 3::rps] = load_vec
        if self.has_genset:
            # relaxed semi-continuity rows: -p <= 0
            h = torch.cat([h, h.new_zeros(batch + (H,))], dim=-1)

        costs = self.costs_static
        c = costs.expand(batch + costs.shape[-1:]).clone()
        c[..., idx["imp"]::nb] = (costs[:, idx["imp"]::nb] + grid["price_imp"]
                                  + grid["grid_co2"] * grid["cost_co2"][:, None])
        c[..., idx["exp"]::nb] = costs[:, idx["exp"]::nb] + grid["price_exp"]
        return c, b, h

    def apply_genset_pattern(self, h, u):
        """Pin the genset status patterns ``u (..., C, H)`` into ``h (...,
        C, n_in_rows)`` (broadcast together): production caps become
        ``p_max*u``, minimum rows ``-p_min*u``."""
        n_in = self.rows_per_step * self.horizon
        shape = torch.broadcast_shapes(h.shape[:-1], u.shape[:-1])
        u = u.to(h.dtype)
        out = h.expand(shape + h.shape[-1:]).clone()
        out[..., 0:n_in:self.rows_per_step] = self.p_genset_max[:, None] * u
        out[..., n_in:] = self._neg_p_genset_min[:, None] * u
        return out

    def genset_production(self, x):
        """Per-step genset production ``(..., H)`` from solutions ``(...,
        n0)``."""
        return x[..., 0::self.block]

    def make_candidate_patterns(self, enum_bits):
        """Build ``p_relax (..., C, H) -> (2**k, ..., C, H)`` status patterns
        around the rounded relaxation.

        The base pattern rounds each step to the nearer branch of the
        semi-continuity gap (off below p_min/2, on above); the k most
        ambiguous steps (largest distance-to-endpoint score) are enumerated.
        Ties in the score (every non-fractional step scores -1) go to the
        lower step, as ``lax.top_k`` orders them: a stable descending sort.
        """
        H, dtype = self.horizon, self.dtype
        k_bits = min(enum_bits, H)
        n_combos = 2 ** k_bits
        combos = torch.as_tensor(
            [[(e >> j) & 1 for j in range(k_bits)] for e in range(n_combos)],
            dtype=dtype, device=self.device,
        )

        def candidate_patterns(p_relax):
            on_base = (p_relax > self._on_threshold[:, None]).to(dtype)
            fractional = (p_relax > self._frac_lo[:, None]) & (p_relax < self._frac_hi[:, None])
            score = torch.where(
                fractional, torch.minimum(p_relax, self.p_genset_min[:, None] - p_relax), -1.0
            )
            chosen = torch.sort(score, dim=-1, descending=True, stable=True).indices[..., :k_bits]
            lead = (n_combos,) + chosen.shape
            src = combos.view((n_combos,) + (1,) * (chosen.dim() - 1) + (k_bits,))
            u_all = on_base.expand((n_combos,) + on_base.shape).clone()
            return u_all.scatter_(-1, chosen.expand(lead), src.expand(lead))

        return candidate_patterns

    def make_genset_refiner(self, enum_bits=5, enum_chunk=8, solver=None):
        """Build ``refine(c, b, h) -> (x, u, objective, residual)`` over
        problems ``(..., C, n)``: solve the LP relaxation, enumerate the
        ``2^k`` status patterns over the ``k`` most fractional steps
        ``enum_chunk`` patterns per batched solve, and keep each problem's
        cheapest integral solution (a running best, first minimum wins).
        ``solver`` defaults to the template's."""
        H, dtype = self.horizon, self.dtype
        k_bits = min(enum_bits, H)
        n_combos = 2 ** k_bits
        chunk = max(1, min(enum_chunk, n_combos))
        if n_combos % chunk:
            chunk = 1 << (chunk.bit_length() - 1)  # powers of 2 always divide
        candidate_patterns = self.make_candidate_patterns(enum_bits)
        solve = self.solver if solver is None else solver

        def flat(a):
            return a.reshape(-1, a.shape[-1])

        def refine(c, b, h):
            lead = c.shape[:-1]
            x_rel, _ = solve(flat(c), flat(b), flat(h))
            u_all = candidate_patterns(self.genset_production(x_rel.view(lead + (-1,))))
            c_rep = flat(c.expand((chunk,) + c.shape))
            b_rep = flat(b.expand((chunk,) + b.shape))

            kw = dict(dtype=dtype, device=c.device)
            best_x = torch.zeros(lead + (x_rel.shape[-1],), **kw)
            best_u = torch.zeros(lead + (H,), **kw)
            best_obj = torch.full(lead, float("inf"), **kw)
            best_res = torch.full(lead, float("inf"), **kw)
            for start in range(0, n_combos, chunk):
                u_chunk = u_all[start:start + chunk]                     # (chunk, ..., H)
                x, info = solve(c_rep, b_rep, flat(self.apply_genset_pattern(h, u_chunk)))
                x = x.view((chunk,) + lead + x.shape[-1:])
                obj = info["objective"].view((chunk,) + lead)
                res = info["residual"].view((chunk,) + lead)
                pick = obj.argmin(dim=0, keepdim=True)                   # (1, ...)

                def take(a):
                    index = pick.view(pick.shape + (1,) * (a.dim() - pick.dim()))
                    return a.gather(0, index.expand((1,) + a.shape[1:]))[0]

                better = take(obj) < best_obj
                best_x = torch.where(better[..., None], take(x), best_x)
                best_u = torch.where(better[..., None], take(u_chunk), best_u)
                best_res = torch.where(better, take(res), best_res)
                best_obj = torch.where(better, take(obj), best_obj)
            return best_x, best_u, best_obj, best_res

        return refine

    def rebalance_first_step(self, params, state, action, load0, pv0, grid_status0):
        """Project the executed first-step controls onto the engine's balance
        manifold, as the JAX template does: the planned production-minus-
        consumption difference is clamped into ``[-pv0, 0]`` by correcting
        grid, then genset, then battery, each within its true bounds.

        ``state`` and ``action`` are the engine's ``(C, B, ...)``; ``load0``,
        ``pv0`` and ``grid_status0`` are ``(C, B)`` (or broadcast to it)."""
        zero = torch.zeros((), dtype=self.dtype, device=load0.device)
        i = self.battery_ref.slot
        bat = action["battery"][..., i]
        if self.has_genset:
            g = self.genset_refs[0].slot
            genset_p = action["genset"][..., g, 1]
            genset_u = action["genset"][..., g, 0]
        else:
            genset_p = genset_u = zero
        grid_diff = action["grid"][..., self.grid_refs[0].slot] if self.grid_refs else zero

        diff2 = bat + genset_p + grid_diff - load0
        delta = _clip(diff2, -pv0, zero) - diff2   # signed production fix
        action = dict(action)

        if self.grid_refs:
            k = self.grid_refs[0].slot
            pg = params["grid"]
            new_grid = _clip(grid_diff + delta,
                             -pg["max_export"][:, k, None] * grid_status0,
                             pg["max_import"][:, k, None] * grid_status0)
            delta = delta - (new_grid - grid_diff)
            action["grid"] = _with_slot(action["grid"], (k,), new_grid)

        if self.has_genset:
            new_p = _clip(genset_p + delta,
                          genset_u * self.p_genset_min[:, None],
                          genset_u * self.p_genset_max[:, None])
            delta = delta - (new_p - genset_p)
            action["genset"] = _with_slot(action["genset"], (g, 1), new_p)

        pb = params["battery"]
        charge = state["battery_charge"][..., i]
        eff = pb["efficiency"][:, i, None]
        max_prod = torch.minimum(pb["max_discharge"][:, i, None],
                                 charge - pb["min_capacity"][:, i, None]) * eff
        max_cons = torch.minimum(pb["max_charge"][:, i, None],
                                 pb["max_capacity"][:, i, None] - charge) / eff
        new_bat = _clip(bat + delta, -max_cons, torch.maximum(max_prod, zero))
        action["battery"] = _with_slot(action["battery"], (i,), new_bat)
        return action

    def host_solve(self, c, b, h):
        """HiGHS fallback for one problem (exact LP / genset MILP with the
        same matrices); returns ``(x, u_or_None)`` or ``(None, None)``."""
        host = self.host_mpc
        n_in = self.rows_per_step * self.horizon
        host._c = np.asarray(c, dtype=np.float64)
        host._b_eq = np.asarray(b, dtype=np.float64)
        host._b_ub = np.asarray(h, dtype=np.float64)[:n_in]
        return host._solve()

    def extract_action(self, x, genset_u=None):
        """First-block controls of solutions ``x (B, C, n0)`` (and status
        patterns ``genset_u (B, C, H)``) -> the engine's action dict with
        ``(C, B, ...)`` leaves."""
        spec, idx = self.spec, self.idx
        xc = x.transpose(0, 1)
        lead = xc.shape[:2]
        battery = xc.new_zeros(lead + (spec.n_battery,))
        battery[..., self.battery_ref.slot] = xc[..., idx["discharge"]] - xc[..., idx["charge"]]
        genset = xc.new_zeros(lead + (spec.n_genset, 2))
        grid = xc.new_zeros(lead + (spec.n_grid,))
        if self.grid_refs:
            grid[..., self.grid_refs[0].slot] = xc[..., idx["imp"]] - xc[..., idx["exp"]]
        if self.has_genset:
            g = self.genset_refs[0].slot
            if genset_u is None:
                genset[..., g, 0] = (xc[..., 0] > 0).to(self.dtype)
            else:
                genset[..., g, 0] = genset_u[..., 0].T.to(self.dtype)
            genset[..., g, 1] = xc[..., 0]
        return {"battery": battery, "genset": genset, "grid": grid}


class BatchedMPC:
    """Receding-horizon MPC batched over ``batch_size`` replicas of one
    microgrid, planner on ``device`` in ``dtype``.

    ``enum_bits`` bounds the per-step genset MILP enumeration (the ``2^k``
    status patterns over the ``k`` most fractional relaxation steps, solved
    ``enum_chunk`` at a time); ``enum_bits=0`` or ``relax_genset=True``
    rounds the relaxation instead.  ``host_fallback``: a replica whose
    device solve reports a primal residual above ``residual_tol`` is
    re-solved exactly with host HiGHS before acting (``fallback_count``
    counts them).  ``repair_balance``: project the executed first-step
    controls onto the engine's balance manifold.

    States are dicts of ``(B, ...)`` leaves and step outputs ``(B,)``, as in
    the JAX class; the engine's config axis is added and removed inside.
    """

    def __init__(self, microgrid, batch_size=1, iters=30, *, dtype, device="cuda",
                 relax_genset=False, enum_bits=5, enum_chunk=8, host_fallback=True,
                 residual_tol=None, repair_balance=True, outage_aware_repair=False,
                 matmul_precision="float32", newton_refine=None):
        self.batch_size = batch_size
        self.template = tpl = ProblemTemplate(
            microgrid, iters=iters, dtype=dtype, device=device, relax_genset=relax_genset,
            matmul_precision=matmul_precision, newton_refine=newton_refine,
        )
        self.device, self.dtype = tpl.device, tpl.dtype
        self.spec = tpl.spec
        self.params = tpl.params
        self.horizon = tpl.horizon
        self._solver = tpl.solver
        self.enum_bits = 0 if relax_genset else enum_bits
        self.enum_chunk = enum_chunk
        self.repair_balance = repair_balance
        self.outage_aware_repair = outage_aware_repair
        self.host_fallback = host_fallback
        if residual_tol is None:
            residual_tol = 1e-5 if self.dtype == torch.float64 else 1e-2
        self.residual_tol = residual_tol
        self.fallback_count = 0

        self._engine_step = make_step_fn(self.spec, normalized=False, with_obs=False,
                                         with_log=False)
        self._reset_fn = make_reset_fn(self.spec)
        self._refine = (
            tpl.make_genset_refiner(enum_bits=self.enum_bits, enum_chunk=enum_chunk)
            if tpl.has_genset and self.enum_bits > 0 else None
        )

    # ------------------------------------------------------------- planning
    def _plan(self, states):
        """Actions for the ``(1, B)`` engine states: ``(actions, info, (c, b,
        h))`` with ``info`` and the LP data flattened to ``(B, ...)``."""
        tpl, params, H = self.template, self.params, self.horizon
        t = states["step"]
        load_vec = -series_window(params, "load", tpl.load_ref.slot, t, H)
        pv_vec = series_window(params, "renewable", tpl.pv_ref.slot, t, H)
        grid = tpl.grid_windows(params, t)
        # the modular path plans with an always-up grid (reference mpc.py:914)
        grid_status = torch.ones(H, dtype=self.dtype, device=self.device)
        c, b, h = tpl.assemble(params, load_vec, pv_vec, grid, grid_status,
                               tpl.soc_0(params, states))
        if self._refine is not None:
            x, u, obj, res = self._refine(c, b, h)
            actions = tpl.extract_action(x, u)
            info = {"objective": obj.flatten(), "residual": res.flatten()}
        else:
            x, info = self._solver(c.flatten(0, 1), b.flatten(0, 1), h.flatten(0, 1))
            actions = tpl.extract_action(x.view(c.shape))
        if self.repair_balance:
            # step-0 grid status: the planner's always-up assumption, or the
            # realized one with ``outage_aware_repair``
            status0 = (grid["grid_status_real"][..., 0].T if self.outage_aware_repair
                       else grid_status[0])
            actions = tpl.rebalance_first_step(params, states, actions, load_vec[..., 0].T,
                                               pv_vec[..., 0].T, status0)
        return actions, info, (c.flatten(0, 1), b.flatten(0, 1), h.flatten(0, 1))

    def _repair_with_host(self, actions, info, cbh):
        """Re-solve non-converged replicas exactly on the host (HiGHS)."""
        residual = info["residual"].cpu().numpy()
        bad = np.flatnonzero(residual > self.residual_tol)
        if bad.size == 0:
            return actions
        tpl = self.template
        c, b, h = (a.cpu().numpy() for a in cbh)
        actions = {k: v.clone() for k, v in actions.items()}

        def as_t(a):
            return torch.as_tensor(a, device=self.device).to(self.dtype).view(1, 1, -1)

        for i in bad:
            x, u = tpl.host_solve(c[i], b[i], h[i])
            if x is None:
                continue  # keep the device iterate
            self.fallback_count += 1
            repaired = tpl.extract_action(as_t(x), None if u is None else as_t(u))
            for k, v in actions.items():
                v[:, i] = repaired[k][:, 0]
        return actions

    def _step(self, states):
        actions, info, cbh = self._plan(states)
        if self.host_fallback:
            actions = self._repair_with_host(actions, info, cbh)
        new_states, out = self._engine_step(self.params, states, actions)
        return new_states, out, info

    def _reset(self, seed):
        starts = self.params["initial_step"].to(torch.int32).view(1, 1)
        keys = prng.split(prng.key(seed, self.device), self.batch_size).unsqueeze(0)
        return self._reset_fn(self.params, starts.expand(1, self.batch_size), keys)

    # ------------------------------------------------------------------ api
    def reset(self, seed=0):
        """``(B, ...)`` states at the config's initial step; ``seed`` keys
        threefry-gaussian forecasts (``split(key(seed), B)``, as the JAX
        class keys them) and draws nothing for other forecasters."""
        return without_config_axis(self._reset(seed))

    def step(self, states):
        """Plan + act for every replica; returns ``(states, StepOutput,
        lp_info)``.  The step builds no observation or log row."""
        new_states, out, info = self._step(with_config_axis(states))
        return without_config_axis(new_states), drop_config_axis(out), info

    def run(self, n_steps, seed=0, collect_rewards=True):
        """Receding-horizon MPC for all replicas; returns the rewards
        ``(n_steps, B)`` as numpy (or ``None``) and the final states."""
        states = self._reset(seed)
        rewards = []
        for _ in range(n_steps):
            states, out, _ = self._step(states)
            if collect_rewards:
                rewards.append(out.reward[0])
        stacked = torch.stack(rewards).cpu().numpy() if collect_rewards else None
        return stacked, without_config_axis(states)

    def run_scanned(self, n_steps, seed=0, chunk=None):
        """The plan-and-act loop without host fallback: rewards stay on the
        device and are copied to the host once per ``chunk`` steps (once at
        the end without one).  Returns ``(n_steps, B)`` rewards and the
        states after exactly ``n_steps`` steps."""
        def step(states):
            states, out = self._engine_step(self.params, states, self._plan(states)[0])
            return states, out.reward[0]

        rewards, states = run_chunked(step, self._reset(seed), n_steps, chunk)
        return rewards, without_config_axis(states)
