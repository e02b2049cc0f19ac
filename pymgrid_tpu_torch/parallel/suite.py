"""Heterogeneous config batching: the whole pymgrid25 suite in one batch.

Port of :mod:`pymgrid_tpu.parallel.suite`.  Every scenario is normalized onto
the superset structure by :func:`normalize_to_superset` (numpy, copied from
the JAX package: neutral modules for absent kinds contribute exactly +/-0.0),
so all configs share one :class:`~pymgrid_tpu_torch.core.spec.MicrogridSpec`;
params stack along a leading config axis and the engine steps ``(C, B)`` = configs x replicas at once.

Episode starts are an explicit ``(C, B)`` input: the JAX runner draws them
from its replicas' ``jax.random`` keys, the port takes them from the caller
(:meth:`SuiteRunner.draw_initial_steps` draws them from a seeded
``torch.Generator``, so they differ from the JAX runner's for the same
seed).  Threefry-gaussian forecasts do draw from per-replica keys,
``split(key(seed), C*B)`` as the JAX runner's ``make_keys`` gives them
(:meth:`SuiteRunner.make_keys`), and auto-resets re-key from each replica's
own ``rng``.  Only the per-step path is ported; the JAX
runner's block-prefetch mode is a TPU gather optimisation left for later
(ROADMAP.md A15).  Collected outputs come back as ``(C, B, T, ...)``.
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


class SuiteRunner:
    """Run ``batch_per_config`` replicas of each config in lockstep.

    With ``mesh=`` (a :class:`~pymgrid_tpu_torch.parallel.distributed.BatchMesh`)
    the configs shard over the job's ranks, as the JAX runner shards them
    over its mesh: this rank holds its share of the configs' params on the
    mesh's device, ``rollout_fn``'s function takes the global ``(C, B)``
    starts and returns this rank's ``(C / world, B)`` rows, which
    :func:`~pymgrid_tpu_torch.parallel.distributed.fetch` assembles."""

    def __init__(self, microgrids, batch_per_config, dtype, device="cuda", mesh=None):
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

    def draw_initial_steps(self, generator):
        """``(C, B)`` int32 starts, uniform in ``[initial_step, max_start)``
        per config, drawn on the CPU from ``generator`` and moved to the
        runner's device (so every device gets the same starts).  ``C`` is
        every config, also with a mesh."""
        lows = self._initial_step.cpu().tolist()
        draws = [
            torch.randint(int(lo), self.max_start, (self.batch_per_config,),
                          generator=generator, dtype=torch.int64)
            for lo in lows
        ]
        return torch.stack(draws).to(torch.int32).to(self.device)

    def make_keys(self, seed=0):
        """``(C, B, 2)`` threefry keys, ``split(key(seed), C*B)`` as the JAX
        runner's ``make_keys``: every config's, also with a mesh."""
        keys = prng.split(prng.key(seed, self.device),
                          self.n_configs * self.batch_per_config)
        return keys.view(self.n_configs, self.batch_per_config, 2)

    def fixed_initial_steps(self):
        """``(C, B)`` starts at every config's ``initial_step``."""
        return (self._initial_step.to(torch.int32).unsqueeze(1)
                .expand(self.n_configs, self.batch_per_config).contiguous())

    def rollout_fn(self, policy, n_steps, auto_reset=True, collect=False,
                   randomize_initial_step=False):
        """``(params, initial_steps, generator=None, keys=None) -> outputs``.

        ``keys`` (every config's, :meth:`make_keys`) key threefry-gaussian
        forecasts; a spec that draws them defaults to ``make_keys(0)``.

        With ``collect=False`` (throughput mode) returns the ``(C, B)``
        reward + obs checksum per env; with ``collect=True`` returns
        ``(checksum, StepOutput)`` with every field ``(C, B, T, ...)``.

        ``randomize_initial_step`` sets the auto-reset target: without
        ``collect`` a finished replica continues at the sequential wrap
        ``i0 + (t + 1 - i0) mod (max_start - i0)`` (the JAX runner's
        throughput mode); with ``collect`` it restarts at a fresh uniform
        start drawn from ``generator``.  Otherwise it restarts at
        ``params["initial_step"]``.
        """
        spec = self.spec
        step_fn = make_step_fn(spec, with_obs=True, with_log=collect)
        reset_fn = make_reset_fn(spec)
        seq_mode = randomize_initial_step and auto_reset and not collect
        max_start = self.max_start

        def reset_target(params, new_state, generator):
            i0 = params["initial_step"].to(torch.int32).unsqueeze(1)
            if seq_mode:
                return i0 + torch.remainder(new_state["step"] - i0, max_start - i0)
            if randomize_initial_step:
                if generator is None:
                    raise ValueError("randomized auto-resets with collect=True "
                                     "need a torch.Generator")
                return self.draw_initial_steps(generator)[self._configs]
            return i0.expand(new_state["step"].shape)

        keyed = needs_keys(spec)

        def suite_rollout(params, initial_steps, generator=None, keys=None):
            if tuple(initial_steps.shape) != (self.n_configs, self.batch_per_config):
                raise ValueError(
                    f"initial_steps must be (n_configs, batch_per_config) = "
                    f"{(self.n_configs, self.batch_per_config)}, got "
                    f"{tuple(initial_steps.shape)}"
                )
            initial_steps = initial_steps[self._configs]
            if keyed:
                keys = (self.make_keys(0) if keys is None else keys)[self._configs]
                keys = keys.to(initial_steps.device)
            states = reset_fn(params, initial_steps, keys)
            acc = torch.zeros(initial_steps.shape, dtype=self.dtype,
                              device=initial_steps.device)
            outs = []
            for _ in range(n_steps):
                action = policy(params, states)
                new_states, out = step_fn(params, states, action)
                if auto_reset:
                    fresh = reset_fn(params, reset_target(params, new_states, generator),
                                     new_states.get("rng"))
                    new_states = select_state(out.done, fresh, new_states)
                states = new_states
                acc = acc + out.reward + out.obs.sum(dim=-1)
                if collect:
                    outs.append(out)
            if collect:
                return acc, StepOutput(*[torch.stack(f, dim=2) for f in zip(*outs)])
            return acc

        return suite_rollout
