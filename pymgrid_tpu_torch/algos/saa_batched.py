"""Sample-average-approximation stochastic MPC, every sample LP batched.

Port of :mod:`pymgrid_tpu.algos.saa_jax` (reference ``algos/saa/saa.py``):
at every step N sampled futures each define one horizon LP, all N solve in
one batched interior-point call on the device (plus the genset pattern
enumeration), the plan at the ``optimal_percentile`` of horizon cost is
picked (the sorted index ``floor(N * percentile)``, stable in ties as
``jnp.argsort``), and its first-step control drives the engine on the real
data.

The samples come from the host
:class:`~pymgrid_tpu_torch.utils.data_generator.SampleGenerator` at construction
(or ``samples=``) and then live on the device as ``(N, T)`` series.  As in
the JAX class, row 0 of each sample window is replaced by the realized data
(saa.py:128), the window start clamps so the whole horizon fits (as
``lax.dynamic_slice`` clamps), and the sampled grid status scales the
import/export bounds.
"""
import numpy as np
import torch

from pymgrid_tpu_torch.algos.mpc_batched import ProblemTemplate, run_chunked
from pymgrid_tpu_torch.core import prng
from pymgrid_tpu_torch.core.engine import _gather_window, gather_rows, make_reset_fn, make_step_fn
from pymgrid_tpu_torch.core.params import without_config_axis, with_config_axis

__all__ = ["BatchedSAA"]


class BatchedSAA:
    """Stochastic MPC on ``device`` in ``dtype`` with all sample LPs batched.

    ``n_samples`` futures per step, the plan at ``optimal_percentile`` of
    horizon cost executed.  ``forecast_args`` / ``sampling_args`` /
    ``preset_to_use`` go to the host :class:`SampleGenerator`; ``samples``
    (a list of frames or dicts with ``pv``, ``load`` and ``grid`` series)
    replaces the sampling.  Genset configs solve each sample's horizon MILP
    by relaxation + pattern enumeration (``enum_bits``).

    The state is a dict of unbatched leaves, as in the JAX class; the
    engine's ``(1, 1)`` axes are added and removed inside.
    """

    def __init__(self, microgrid, n_samples=10, optimal_percentile=0.5, iters=30, *,
                 dtype, device="cuda", relax_genset=False, forecast_args=None,
                 sampling_args=None, samples=None, preset_to_use=None, enum_bits=5,
                 enum_chunk=8, matmul_precision="float32", newton_refine=None,
                 solver_kind="ipm"):
        if not 0.0 <= optimal_percentile <= 1.0:
            raise ValueError("percentile must be in [0,1]")
        self.n_samples = n_samples
        self.optimal_percentile = optimal_percentile
        self.enum_bits = 0 if relax_genset else enum_bits
        self.enum_chunk = enum_chunk
        self.template = tpl = ProblemTemplate(
            microgrid, iters=iters, dtype=dtype, device=device, relax_genset=relax_genset,
            matmul_precision=matmul_precision, newton_refine=newton_refine,
            solver_kind=solver_kind,
        )
        self.device, self.dtype = tpl.device, tpl.dtype
        self.spec = tpl.spec
        self.params = tpl.params
        self.horizon = tpl.horizon

        if samples is None:
            samples = self._generate_samples(microgrid, n_samples, forecast_args,
                                             sampling_args, preset_to_use)
        np_dtype = np.float64 if self.dtype == torch.float64 else np.float32

        def series(key):
            rows = np.stack([np.asarray(s[key], dtype=np_dtype).reshape(-1) for s in samples])
            return torch.as_tensor(rows, device=self.device)

        # (N, T) sampled pv / load / grid-status series on the device
        self.sample_pv = series("pv")
        self.sample_load = series("load")
        self.sample_grid = series("grid")
        self.sample_length = int(self.sample_pv.shape[1])
        # reference saa.py:96-99: sorted-cost index floor(N * percentile)
        self._pick = min(int(np.floor(n_samples * optimal_percentile)), n_samples - 1)

        self._engine_step = make_step_fn(self.spec, normalized=False, with_obs=False,
                                         with_log=False)
        self._reset_fn = make_reset_fn(self.spec)
        self._refine = (
            tpl.make_genset_refiner(enum_bits=self.enum_bits, enum_chunk=enum_chunk)
            if tpl.has_genset and self.enum_bits > 0 else None
        )

    @staticmethod
    def _generate_samples(microgrid, n_samples, forecast_args, sampling_args,
                          preset_to_use):
        """Host-side sampling via the legacy generators (construction time)."""
        from pymgrid_tpu_torch.utils.data_generator import SampleGenerator

        forecast_args = dict(forecast_args or {})
        if preset_to_use is not None:
            forecast_args["preset_to_use"] = preset_to_use
        gen = SampleGenerator(microgrid.to_nonmodular(), **forecast_args)
        return gen.sample_from_forecasts(n_samples=n_samples, **(sampling_args or {}))

    # ------------------------------------------------------------- planning
    def _sample_windows(self, table, t, first):
        """``(N, 1, H)`` windows of the ``(N, T)`` sample series at the
        ``(1, 1)`` step ``t`` (start clamped so the window fits), row 0
        replaced by ``first``."""
        n = table.shape[0]
        win = _gather_window(table, t.expand(n, 1), self.horizon).clone()
        win[..., 0] = first
        return win

    def _step(self, state):
        """One sample-plan-act step of the ``(1, 1)`` engine state; returns
        ``(state', out, costs (N,), chosen (1,))``."""
        tpl, params = self.template, self.params
        t = state["step"]
        real_load = -gather_rows(params["load"]["ts"][:, tpl.load_ref.slot], t)[..., 0]
        real_pv = gather_rows(params["renewable"]["ts"][:, tpl.pv_ref.slot], t)[..., 0]
        grid = tpl.grid_windows(params, t)
        load_vec = self._sample_windows(self.sample_load, t, real_load)
        pv_vec = self._sample_windows(self.sample_pv, t, real_pv)
        status = self._sample_windows(self.sample_grid, t, grid["grid_status_real"][..., 0])
        c, b, h = tpl.assemble(params, load_vec, pv_vec, grid, status,
                               tpl.soc_0(params, state))                   # (N, 1, ...)
        if self._refine is not None:
            # every sample's horizon MILP: relaxation + pattern enumeration
            x, u, costs, _ = self._refine(c, b, h)
            costs = costs[:, 0]
        else:
            x, _ = tpl.solver(c[:, 0], b[:, 0], h[:, 0])
            costs = (c[:, 0] * x).sum(dim=1)                              # horizon objectives
            x, u = x[:, None], None
        chosen = torch.argsort(costs, stable=True)[self._pick].view(1)
        action = tpl.extract_action(
            x.index_select(0, chosen), None if u is None else u.index_select(0, chosen))
        new_state, out = self._engine_step(params, state, action)
        return new_state, out, costs, chosen

    def _reset(self, seed):
        starts = self.params["initial_step"].to(torch.int32).view(1, 1)
        return self._reset_fn(self.params, starts, prng.key(seed, starts.device).view(1, 1, 2))

    def _n_steps(self, n_steps):
        max_steps = self.sample_length - self.horizon
        return max_steps if n_steps is None else min(n_steps, max_steps)

    # ------------------------------------------------------------------ api
    def reset(self, seed=0):
        """The state at the config's initial step, unbatched leaves; ``seed``
        keys threefry-gaussian forecasts (``key(seed)``, as the JAX class
        keys them) and draws nothing for other forecasters."""
        return _unbatch(self._reset(seed))

    def step(self, state):
        """Sample-plan-act once; returns ``(state', StepOutput, sample_costs
        (N,), chosen_index ())``."""
        new_state, out, costs, chosen = self._step(_batch(state))
        out = type(out)(*[None if f is None else f[0, 0] for f in out])
        return _unbatch(new_state), out, costs, chosen[0]

    def run(self, n_steps=None, seed=0, verbose=False):
        """Receding-horizon stochastic MPC on the real trajectory; returns
        float64 numpy rewards and the final state (total cost is
        ``-rewards.sum()``).  Rewards are copied to the host once, at the
        end (``verbose`` prints, and so waits for the device, every ~5%)."""
        n_steps = self._n_steps(n_steps)
        state = self._reset(seed)
        rewards = []
        for k in range(n_steps):
            state, out, _, chosen = self._step(state)
            rewards.append(out.reward[0, 0])
            if verbose and k % max(1, n_steps // 20) == 0:
                print(f"SAA step {k}/{n_steps} reward {float(out.reward[0, 0]):.2f} "
                      f"(chose sample {int(chosen[0])})")
        return torch.stack(rewards).cpu().numpy().astype(np.float64), _unbatch(state)

    def run_scanned(self, n_steps=None, seed=0, chunk=500):
        """The same loop with rewards copied to the host once per ``chunk``
        steps; returns float64 numpy rewards and the final state."""
        def step(state):
            state, out, _, _ = self._step(state)
            return state, out.reward[0, 0]

        rewards, state = run_chunked(step, self._reset(seed), self._n_steps(n_steps), chunk)
        return rewards.astype(np.float64), _unbatch(state)


def _batch(state):
    """Unbatched state leaves -> the engine's ``(1, 1, ...)``."""
    return with_config_axis(with_config_axis(state))


def _unbatch(state):
    return without_config_axis(without_config_axis(state))
