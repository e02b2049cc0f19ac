"""Precomputed step-index tables.

Port of :mod:`pymgrid_tpu.core.tables`, with the same layouts (the numpy
layout functions are copied here) and the same two tables:

* ``step_table`` ``(T, R + D)``: raw current rows at ``t`` of every ts module,
  then the normalized observation segments at ``t + 1`` (the step consumes
  observations at ``new_t``, so one row gather at ``t`` serves the policy's
  rows and the outgoing observation; the last obs row repeats, matching the
  dynamic path's index clamping);
* ``logfc_table`` ``(T, L)``: the unnormalized realized forecast windows that
  log rows record.

Each row is produced by the engine's own expressions
(:func:`pymgrid_tpu_torch.core.engine.ts_obs_part`), evaluated with the step
index ``arange(T)`` in the replica position, so lookups equal the dynamic path
bit for bit; a deterministic user forecaster's rows come from the same
per-replica ``vmap`` call as its dynamic windows.  Threefry-gaussian windows
ride in the state and are not tabulated.
"""
import torch

from pymgrid_tpu_torch._device import torch_dtype
from pymgrid_tpu_torch.core.params import tree_map, with_config_axis

__all__ = [
    "tabulable",
    "row_table_layout",
    "obs_table_layout",
    "logfc_table_layout",
    "build_tables",
    "ensure_tables",
]


def tabulable(spec, ref):
    """Whether ``ref``'s observation segment is a pure function of t."""
    if ref.kind not in ("load", "renewable", "grid"):
        return False
    return ref.forecaster != "gaussian" or spec.numpy_noise


def row_table_layout(spec):
    """Static column layout of ``row_table``: {(kind, slot): (offset, width)}."""
    layout, offset = {}, 0
    for kind, n, width in (
        ("load", spec.n_load, 1),
        ("renewable", spec.n_renewable, 1),
        ("grid", spec.n_grid, 4),
    ):
        for slot in range(n):
            layout[(kind, slot)] = (offset, width)
            offset += width
    return layout, offset


def obs_table_layout(spec):
    """Static column layout of ``obs_table``:
    {(name, num): (offset, width)} over tabulable ts refs in log order."""
    layout, offset = {}, 0
    for ref in spec.log_order:
        if tabulable(spec, ref):
            layout[(ref.name, ref.num)] = (offset, ref.obs_dim)
            offset += ref.obs_dim
    return layout, offset


def logfc_table_layout(spec):
    """Static column layout of the raw log-forecast segment:
    {(name, num): (offset, width=h*f)} over tabulable ts refs with a
    forecast horizon.  These are the UNNORMALIZED realized forecast windows
    logged per step (``{comp}_forecast_j`` fields) — without tabulation the
    per-replica window gathers scalarize into while-loops on TPU whenever
    log rows are materialized (measured 30x on collect rollouts)."""
    layout, offset = {}, 0
    for ref in spec.log_order:
        if tabulable(spec, ref) and ref.forecast_horizon > 0:
            width = ref.forecast_horizon * ref.n_features
            layout[(ref.name, ref.num)] = (offset, width)
            offset += width
    return layout, offset


def _table_length(params):
    lengths = [
        params[k]["ts"].shape[-2]
        for k in ("load", "renewable", "grid")
        if params[k]["ts"].shape[-3]
    ]
    return max(lengths) if lengths else 0


def _cat(parts, C, T, dtype, device):
    if not parts:
        return torch.zeros((C, T, 0), dtype=dtype, device=device)
    return torch.cat(parts, dim=-1)


def build_tables(spec, params, config_axis=False):
    """``{"step_table", "logfc_table"}`` for ``params`` (torch leaves).

    With ``config_axis=True`` every params leaf carries a leading config axis
    and the tables come back as ``(C, T, W)``; otherwise ``(T, W)``.
    """
    from pymgrid_tpu_torch.core import engine as eng

    dtype = torch_dtype(spec.dtype)
    cparams = params if config_axis else with_config_axis(params)
    device = cparams["battery"]["init_charge"].device
    C = cparams["battery"]["init_charge"].shape[0]
    T = _table_length(cparams)
    _, row_width = row_table_layout(spec)
    _, obs_width = obs_table_layout(spec)
    _, logfc_width = logfc_table_layout(spec)

    if T == 0:
        tables = {
            "step_table": torch.zeros((C, 1, row_width + obs_width), dtype=dtype,
                                      device=device),
            "logfc_table": torch.zeros((C, 1, logfc_width), dtype=dtype,
                                       device=device),
        }
    else:
        t = torch.arange(T, dtype=torch.int32, device=device).expand(C, T)
        rows, obs, logfc = [], [], []
        for kind, n in (("load", spec.n_load), ("renewable", spec.n_renewable),
                        ("grid", spec.n_grid)):
            for slot in range(n):
                rows.append(eng.gather_rows(cparams[kind]["ts"][:, slot], t))
        for ref in spec.log_order:
            if not tabulable(spec, ref):
                continue
            obs.append(eng.ts_obs_part(spec, cparams, t, ref))
            if ref.forecast_horizon > 0:
                window = eng.realized_forecast(spec, cparams, ref, t)
                logfc.append(window.flatten(-2))
        obs = _cat(obs, C, T, dtype, device)
        shifted = torch.cat([obs[:, 1:], obs[:, -1:]], dim=1)
        tables = {
            "step_table": torch.cat(
                [_cat(rows, C, T, dtype, device), shifted], dim=-1
            ).contiguous(),
            "logfc_table": _cat(logfc, C, T, dtype, device).contiguous(),
        }
    if not config_axis:
        tables = tree_map(lambda x: x[0], tables)
    return tables


def ensure_tables(spec, params, config_axis=False):
    """Return ``params`` with step-index tables attached (idempotent)."""
    if "step_table" in params:
        return params
    out = dict(params)
    out.update(build_tables(spec, params, config_axis=config_axis))
    return out
