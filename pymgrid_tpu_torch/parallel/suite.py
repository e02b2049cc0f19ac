"""Heterogeneous config batching: the whole pymgrid25 suite in one batch.

Port of :mod:`pymgrid_tpu.parallel.suite`.  Every scenario is normalized onto
the superset structure by :func:`normalize_to_superset` (numpy, copied from
the JAX package: neutral modules for absent kinds contribute exactly +/-0.0),
so all configs share one :class:`~pymgrid_tpu_torch.core.spec.MicrogridSpec`;
params stack along a leading config axis and the engine steps ``(C, B)`` = configs x replicas at once.

``rollout_fn``'s function takes the keys ``(C, B, 2)`` that
:meth:`SuiteRunner.make_keys` gives (``split(key(seed), C*B)``, as the JAX
runner's ``make_keys``) and draws the starts from them, as the JAX runner
does: with randomized starts each replica's
``randint(fold_in(key, 0x51A7), (), initial_step, max_start)``
(:meth:`SuiteRunner.draw_initial_steps`), else every config's
``initial_step``.  JAX draws with its default ``int``: int64 under
``jax_enable_x64`` (the JAX package's tests and float64 tools) and int32
without it (``bench.py``, ``run_benchmarks --scaling``, the multichip
dryrun); the runner's ``start_dtype`` names which of the two it draws.
Rollouts that draw (threefry-gaussian forecasts,
collect-mode randomized restarts) carry the keys as the state's ``rng``,
which every step splits as the JAX engine does, and a restart draws from the
replica's own split key.  Collected outputs come back as ``(C, B, T, ...)``.

The throughput mode with randomized starts runs, by default, the JAX
runner's block-prefetch rollout: its auto-reset wraps sequentially, so a
replica's step advances by one each step and the step-table rows of
``BLOCK`` steps are one window per replica, gathered once per block
(:func:`gather_block`) instead of one row per step in the policy and
another in the engine.  A replica that wraps inside a block reads the
window's rows past ``max_start``, which the rollout's copy of the table
holds as the rows from ``initial_step`` on, so every step reads the row
the per-step path reads, bitwise.
"""
import numpy as np
import torch

from pymgrid_tpu_torch._device import numpy_dtype, torch_dtype
from pymgrid_tpu_torch.core import prng
from pymgrid_tpu_torch.core.spec import extract_spec
from pymgrid_tpu_torch.core.engine import (
    StepOutput,
    make_reset_fn,
    make_step_fn,
    needs_keys,
)
from pymgrid_tpu_torch.core.params import params_to_torch, stack_configs, tree_map
from pymgrid_tpu_torch.core.rollout import select_state
from pymgrid_tpu_torch.core.tables import ensure_tables
from pymgrid_tpu_torch.parallel.distributed import local_layout

__all__ = ["normalize_to_superset", "build_suite", "SuiteRunner"]

BLOCK = 8  # steps per row prefetch in the block-prefetch rollout (the JAX runner's BLK)

_CANONICAL_ORDER = ("load", "renewable", "balancing", "battery", "genset", "grid")


def _neutral_grid(T, horizon, forecaster, initial_step=0, final_step=-1):
    from pymgrid_tpu_torch.modules import GridModule

    ts = np.zeros((T, 4))
    ts[:, 3] = 1.0  # always up; zero prices/co2; zero import/export capacity
    return GridModule(
        max_import=0.0,
        max_export=0.0,
        time_series=ts,
        forecaster=forecaster,
        forecast_horizon=horizon,
        initial_step=initial_step,
        final_step=final_step,
    )


def _neutral_genset(initial_step=0):
    from pymgrid_tpu_torch.modules import GensetModule

    return GensetModule(
        running_min_production=0.0,
        running_max_production=0.0,
        genset_cost=0.0,
        initial_step=initial_step,
    )


def normalize_to_superset(microgrid, horizon=None, include_genset=True):
    """Rebuild ``microgrid`` with modules in canonical order, inserting
    neutral modules for absent kinds.  Returns a new host Microgrid.

    ``include_genset=False`` skips the neutral-genset insertion — used when
    a whole suite group is genset-free, so the shared LP/engine structure
    carries no dead genset slot (and MPC needs no MILP enumeration)."""
    import warnings

    from pymgrid_tpu_torch.microgrid import Microgrid
    from pymgrid_tpu_torch.modules import (
        BatteryModule,
        GensetModule,
        GridModule,
        LoadModule,
        RenewableModule,
        UnbalancedEnergyModule,
    )

    kind_of = {
        LoadModule: "load",
        RenewableModule: "renewable",
        UnbalancedEnergyModule: "balancing",
        BatteryModule: "battery",
        GensetModule: "genset",
        GridModule: "grid",
    }

    by_kind = {}
    T, h = None, horizon
    initial_step, final_step = 0, -1
    for name, modules in microgrid.modules.iterdict():
        for module in modules:
            kind = kind_of[type(module)]
            if kind in by_kind:
                raise ValueError(
                    f"Suite batching supports one module per kind; duplicate {kind}."
                )
            by_kind[kind] = (name, module)
            if hasattr(module, "time_series"):
                T = len(module)
                initial_step = module.initial_step
                final_step = module.final_step
                if h is None:
                    h = module.forecast_horizon

    forecaster = "oracle" if h else None
    ordered = []
    for kind in _CANONICAL_ORDER:
        if kind in by_kind:
            ordered.append(by_kind[kind])
        elif kind == "grid":
            ordered.append(
                ("grid", _neutral_grid(T, h or 0, forecaster, initial_step, final_step))
            )
        elif kind == "genset":
            if not include_genset:
                continue
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                ordered.append(("genset", _neutral_genset(initial_step)))
        else:
            raise ValueError(f"Microgrid missing required module kind {kind}.")

    return Microgrid(ordered, add_unbalanced_module=False)



def build_suite(microgrids, dtype, device="cuda", include_genset=True):
    """One shared spec and config-stacked torch params (tables attached).
    ``include_genset=False`` inserts no neutral genset, for a genset-free
    group (as the JAX ``build_suite``)."""
    specs, params_list = [], []
    for mg in microgrids:
        normalized = normalize_to_superset(mg, include_genset=include_genset)
        spec, params, _ = extract_spec(normalized, dtype=numpy_dtype(dtype))
        specs.append(spec)
        params_list.append(params)

    first = specs[0]
    for i, spec in enumerate(specs[1:], 1):
        if spec != first:
            raise ValueError(
                f"Config {i} does not normalize onto the shared spec "
                f"(module structure differs)."
            )
    stacked = params_to_torch(stack_configs(params_list), device, dtype)
    return first, ensure_tables(first, stacked, config_axis=True)


def gather_block(table, steps):
    """The step-table rows of ``BLOCK`` consecutive steps from each replica's
    step: ``table (C, T, W)``, ``steps (C, B)`` -> ``(BLOCK, C, B, W)``; the
    start clamps so the window fits, as ``lax.dynamic_slice`` clamps.  Time
    leads, so each step's rows are one contiguous ``(C, B, W)`` slab: a
    strided view into the whole block would have the step's elementwise ops
    index past 2**31 bytes at bench size, which splits each into two
    launches."""
    start = steps.long().clamp(0, table.shape[1] - BLOCK)
    idx = start + torch.arange(BLOCK, device=table.device).view(BLOCK, 1, 1)
    return table[torch.arange(table.shape[0], device=table.device).view(-1, 1), idx]


def _patched_table(table, initial_step, max_start):
    """A copy of ``table (C, T, W)`` whose rows ``[max_start, max_start +
    BLOCK)`` hold each config's rows ``[initial_step, initial_step +
    BLOCK)``: the rows a replica that wrapped inside a block reads."""
    configs = torch.arange(table.shape[0], device=table.device).unsqueeze(1)
    rows = initial_step.long().unsqueeze(1) + torch.arange(BLOCK, device=table.device)
    out = table.clone()
    out[:, max_start:max_start + BLOCK] = table[configs, rows]
    return out


class SuiteRunner:
    """Run ``batch_per_config`` replicas of each config in lockstep.

    With ``mesh=`` (a :class:`~pymgrid_tpu_torch.parallel.distributed.BatchMesh`)
    the configs shard over the job's ranks, as the JAX runner shards them
    over its mesh: this rank holds its share of the configs' params on the
    mesh's device, ``rollout_fn``'s function takes every config's keys and
    returns this rank's ``(C / world, B)`` rows, which
    :func:`~pymgrid_tpu_torch.parallel.distributed.fetch` assembles.

    ``start_dtype`` is the integer width of the randomized start and restart
    draws: ``torch.int64`` (default) draws JAX's starts under
    ``jax_enable_x64``, ``torch.int32`` JAX's starts without x64; the twin
    of a JAX program takes the width that program runs in."""

    def __init__(self, microgrids, batch_per_config, dtype, device="cuda", mesh=None,
                 start_dtype=torch.int64):
        if start_dtype not in (torch.int32, torch.int64):
            raise ValueError(f"start_dtype is torch.int32 or torch.int64, got {start_dtype}")
        self.start_dtype = start_dtype
        self.n_configs = len(microgrids)
        self.mesh = mesh
        self.device, _, self._configs = local_layout(mesh, self.n_configs, device)
        self.dtype = torch_dtype(dtype)
        self.spec, params = build_suite(microgrids, self.dtype, self.device)
        self._initial_step = params["initial_step"]    # every config's
        self.params = tree_map(lambda x: x[self._configs], params)
        self.batch_per_config = batch_per_config
        ts_lengths = [m.ts_length for m in self.spec.log_order if m.ts_length]
        # replicas start in [initial_step, max_start)
        self.max_start = (min(ts_lengths) if ts_lengths else 1) - 1
        # the block-prefetch rollout reads the per-step path's rows when every
        # config's episodes end at max_start - 1 (so a replica's step passes
        # max_start only by wrapping to initial_step), the table holds the
        # BLOCK rows past max_start that the wrapped replicas read, and an
        # episode lasts BLOCK steps or more (a replica wraps at most once per
        # block); decided on every config, so all ranks of a mesh agree
        episode_end = torch.cat([params[k]["final_step"].reshape(self.n_configs, -1)
                                 for k in ("load", "renewable", "grid")], dim=1)
        self._blockable = bool(
            params["step_table"].shape[1] >= self.max_start + BLOCK
            and episode_end.shape[1] > 0
            and (episode_end.amin(dim=1) == self.max_start).all()
            and (self.max_start - self._initial_step >= BLOCK).all()
        )

    def _draw(self, initial_step, keys):
        """``randint(fold_in(key, 0x51A7), (), initial_step, max_start)`` per
        key of ``keys (C, B, 2)``, ``initial_step (C,)``: int32 ``(C, B)``.
        The draw is JAX's default-``int`` one in the width ``start_dtype``
        names: ``torch.int64`` is JAX's draw under ``jax_enable_x64`` (two
        64-bit draws per value), ``torch.int32`` its draw without x64 (two
        32-bit draws); the two give different starts."""
        low = initial_step.to(torch.int64).unsqueeze(1)
        starts = prng.randint(prng.fold_in(keys, 0x51A7), (), low, self.max_start,
                              self.start_dtype)
        return starts.to(torch.int32)

    def draw_initial_steps(self, keys):
        """``(C, B)`` int32 randomized starts drawn from every config's keys
        ``(C, B, 2)`` (:meth:`make_keys`), uniform in ``[initial_step,
        max_start)`` per config, as the JAX runner draws them in the width
        ``start_dtype`` names; on the runner's device.  ``C`` is every
        config, also with a mesh: each rank draws the same starts, whatever
        the world size.  ``rollout_fn``'s randomized rollouts start here."""
        return self._draw(self._initial_step, keys.to(self.device))

    def make_keys(self, seed=0):
        """``(C, B, 2)`` threefry keys, ``split(key(seed), C*B)`` as the JAX
        runner's ``make_keys``: every config's, also with a mesh."""
        keys = prng.split(prng.key(seed, self.device),
                          self.n_configs * self.batch_per_config)
        return keys.view(self.n_configs, self.batch_per_config, 2)

    def _local_keys(self, keys):
        """This rank's rows of every config's keys, on the runner's device;
        ``ValueError`` for any other shape."""
        want = (self.n_configs, self.batch_per_config, 2)
        if not torch.is_tensor(keys) or tuple(keys.shape) != want:
            shape = tuple(keys.shape) if hasattr(keys, "shape") else type(keys).__name__
            raise ValueError(f"the suite rollout takes (params, keys) with keys of shape "
                             f"{want} from make_keys(seed), got {shape}")
        return keys[self._configs].to(self.device)

    def rollout_fn(self, policy, n_steps, auto_reset=True, collect=False,
                   randomize_initial_step=False, block_prefetch=None):
        """``(params, keys) -> outputs``, ``keys`` every config's
        ``(C, B, 2)`` keys from :meth:`make_keys`, as the JAX runner's.

        The rollout starts each replica at the start drawn from its key
        (:meth:`draw_initial_steps`) with ``randomize_initial_step``, at its
        config's ``initial_step`` otherwise.  The keys also key the rollouts
        that draw: threefry-gaussian forecasts and the collect mode's
        randomized restarts carry them as the state's ``rng``; other
        rollouts carry no keys.

        With ``collect=False`` (throughput mode) returns the ``(C, B)``
        reward + obs checksum per env; with ``collect=True`` returns
        ``(checksum, StepOutput)`` with every field ``(C, B, T, ...)``.

        ``randomize_initial_step`` sets the auto-reset target: without
        ``collect`` a finished replica continues at the sequential wrap
        ``i0 + (t + 1 - i0) mod (max_start - i0)`` (the JAX runner's
        throughput mode); with ``collect`` it restarts where the JAX runner
        restarts it, at a start drawn from its split key ``new_state["rng"]``
        (drawn every step, kept where ``done``).  Otherwise it restarts at
        ``params["initial_step"]``.

        ``block_prefetch``: gather the step-table rows once per ``BLOCK``
        steps (see the module docstring).  ``None`` turns it on for the
        sequential-wrap throughput mode (``randomize_initial_step``,
        ``auto_reset``, not ``collect``), ``False`` keeps the per-step
        gathers, and ``True`` in another mode raises ``ValueError``.  Where
        the blocked rollout would not read the per-step path's rows (``n_steps``
        not a multiple of ``BLOCK``, an episode that does not end at
        ``max_start - 1``, fewer than ``max_start + BLOCK`` table rows, or an
        episode shorter than ``BLOCK`` steps) it runs the per-step path; both
        give the same outputs, bitwise.
        """
        spec = self.spec
        step_fn = make_step_fn(spec, with_obs=True, with_log=collect)
        reset_fn = make_reset_fn(spec)
        seq_mode = randomize_initial_step and auto_reset and not collect
        redraw = randomize_initial_step and auto_reset and collect
        keyed = needs_keys(spec) or redraw
        max_start = self.max_start
        if block_prefetch is None:
            block_prefetch = seq_mode
        if block_prefetch and not seq_mode:
            raise ValueError("block_prefetch requires randomize_initial_step, "
                             "auto_reset and collect=False")
        blocked = bool(block_prefetch) and n_steps % BLOCK == 0 and self._blockable

        def reset_target(params, new_state):
            i0 = params["initial_step"].to(torch.int32).unsqueeze(1)
            if seq_mode:
                return i0 + torch.remainder(new_state["step"] - i0, max_start - i0)
            if redraw:
                return self._draw(params["initial_step"], new_state["rng"])
            return i0.expand(new_state["step"].shape)

        def advance(params, states):
            action = policy(params, states)
            new_states, out = step_fn(params, states, action)
            if auto_reset:
                fresh = reset_fn(params, reset_target(params, new_states),
                                 new_states.get("rng"))
                new_states = select_state(out.done, fresh, new_states)
            return new_states, out

        def suite_rollout(params, keys):
            keys = self._local_keys(keys)
            if randomize_initial_step:
                starts = self._draw(params["initial_step"], keys)
            else:
                starts = params["initial_step"].to(torch.int32).unsqueeze(1).expand(
                    keys.shape[:2])
            states = reset_fn(params, starts, keys if keyed else None)
            acc = torch.zeros(starts.shape, dtype=self.dtype, device=starts.device)
            if blocked:
                table = _patched_table(params["step_table"], params["initial_step"],
                                       max_start)
                for _ in range(n_steps // BLOCK):
                    rows = gather_block(table, states["step"])
                    for row in rows:
                        # the row rides in this step's state only: the new
                        # state never carries it
                        states, out = advance(params, {**states, "table_row": row})
                        acc = acc + out.reward + out.obs.sum(dim=-1)
                return acc
            outs = []
            for _ in range(n_steps):
                states, out = advance(params, states)
                acc = acc + out.reward + out.obs.sum(dim=-1)
                if collect:
                    outs.append(out)
            if collect:
                return acc, StepOutput(*[torch.stack(f, dim=2) for f in zip(*outs)])
            return acc

        return suite_rollout
