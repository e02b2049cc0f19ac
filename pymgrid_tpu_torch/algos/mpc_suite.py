"""All-scenario MPC: every scenario's receding-horizon controller in one
batched program per simulated hour.

Port of :mod:`pymgrid_tpu.algos.mpc_suite`.  Every scenario is normalized
onto the superset module structure
(:func:`~pymgrid_tpu_torch.parallel.suite.normalize_to_superset`), so all horizon LPs share one block structure and
differ only in matrix values and right-hand sides: one heterogeneous
interior-point solve (:mod:`pymgrid_tpu_torch.core.lp`) covers all S
scenarios, and the genset MILP enumeration solves each pattern chunk for all
scenarios at once.

Where the JAX ``plan`` loops over scenarios and patterns in Python (free
under ``jit``), this one works on ``(S, ...)`` stacks: the per-scenario
templates are joined by :meth:`ProblemTemplate.stack`, so assembly,
enumeration, action extraction and the balance repair are each one batched
call over all scenarios.  The controller per scenario is
:class:`~pymgrid_tpu_torch.algos.mpc_batched.BatchedMPC`'s.

A step is :meth:`SuiteMPC.plan` (the controls every scenario executes) then
:meth:`SuiteMPC.act` (the engine step on them).  Under a profiler capture
the step is the span ``pymgrid.mpc.step``, with ``pymgrid.mpc.assemble``
(the series windows and the LP data), ``pymgrid.mpc.enumerate`` (the genset
pattern enumeration), ``pymgrid.lp.ipm`` (every interior-point solve),
``pymgrid.mpc.act`` (the first-step controls and their balance repair) and
``pymgrid.engine.step`` inside it.

On a CUDA device in float32 each box interior-point solve runs all its
iterations in one launch of the hand-written kernel ``csrc/box_ipm.cu``
(one thread block a problem; :mod:`pymgrid_tpu_torch.core.lp`), and each
solve shape is recorded once as a CUDA graph of that launch and the ops
around it and replayed (``cuda_graph``), bitwise as the eager solves: an
hour launches three graphs for its 130 iterations.  The slack form
(``solver_kind="ipm"``) and float64 run their iterations op by op inside
the graphs.
"""
import numpy as np
import torch

from pymgrid_tpu_torch._device import numpy_dtype
from pymgrid_tpu_torch.algos.mpc_batched import ProblemTemplate, run_chunked, series_window
from pymgrid_tpu_torch.core.engine import make_reset_fn, make_step_fn, reset_keys
from pymgrid_tpu_torch.core.lp import make_batched_box_ipm_solver, make_batched_ipm_solver
from pymgrid_tpu_torch.core.params import tree_map
from pymgrid_tpu_torch.modules import GensetModule
from pymgrid_tpu_torch.parallel.suite import build_suite, normalize_to_superset
from pymgrid_tpu_torch.utils.profiling import span

__all__ = ["SuiteMPC"]


def _lift(states):
    """``(S, ...)`` states -> the engine's ``(S, 1, ...)``."""
    return tree_map(lambda x: x.unsqueeze(1), states)


def _drop(tree):
    return tree_map(lambda x: x[:, 0], tree)


class SuiteMPC:
    """One-program receding-horizon MPC over heterogeneous scenarios, on
    ``device`` in ``dtype``.

    ``enum_bits`` / ``enum_chunk`` control the genset MILP pattern
    enumeration as in ``BatchedMPC``; a neutral genset's enumeration is a
    no-op (its productions clamp to zero capacity).  ``enum_iters`` /
    ``enum_refine``: fidelity of the enumeration solves (default ``max(35,
    iters // 2)`` iterations, no refinement); the winning pattern is
    re-solved at full ``iters`` / ``newton_refine`` before acting.
    ``solver_kind="box"`` (default) uses the ``me x me`` box IPM, ``"ipm"``
    the slack form with ``solve_mode``.  ``tie_break_eps`` (default 0, an
    ablation) adds ``-eps * (1 - j/H)`` to each step's battery discharge
    cost, tilting the storage LP's flat optimal face toward early discharge.

    States are dicts of ``(S, ...)`` leaves, step outputs ``(S,)``.
    """

    def __init__(self, microgrids, iters=30, *, dtype, device="cuda", enum_bits=3,
                 enum_chunk=8, matmul_precision="float32", repair_balance=True,
                 newton_refine=None, solve_mode="triangular", enum_iters=None,
                 enum_refine=0, solver_kind="box", tie_break_eps=None):
        self.n_scenarios = len(microgrids)
        # a genset-free group needs no neutral-genset slot and no enumeration
        self.include_genset = any(
            any(isinstance(m, GensetModule) for m in mg.modules.iterlist())
            for mg in microgrids
        )
        templates = [
            ProblemTemplate(normalize_to_superset(mg, include_genset=self.include_genset),
                            iters=iters, dtype=dtype, device=device,
                            matmul_precision=matmul_precision, build_solver=False)
            for mg in microgrids
        ]
        t0 = templates[0]
        shape = lambda t: (t.horizon, t.block, t.rows_per_step, t.has_genset, t.n_in_rows)
        for i, t in enumerate(templates[1:], 1):
            if shape(t) != shape(t0):
                raise ValueError(f"scenario {i} does not share the suite LP structure")
        self.template = tpl = ProblemTemplate.stack(templates)
        self.device, self.dtype = tpl.device, tpl.dtype
        self.horizon = tpl.horizon
        self.enum_bits = enum_bits
        self.enum_chunk = enum_chunk
        self.repair_balance = repair_balance
        self.tie_break_eps = float(tie_break_eps or 0.0)
        self._tie_bias = None
        if self.tie_break_eps:
            H = self.horizon
            bias = np.zeros((self.n_scenarios, tpl.K_eq_np.shape[-1]), np.float64)
            for j in range(H):
                bias[:, tpl.idx["discharge"] + j * tpl.block] = -(
                    self.tie_break_eps * (1.0 - j / H))
            self._tie_bias = torch.as_tensor(bias, device=self.device).to(self.dtype)

        if solver_kind not in ("box", "ipm"):
            raise ValueError(f"solver_kind must be 'box' or 'ipm', got {solver_kind!r}")
        # on a CUDA device each solve shape (relaxation, pattern chunk, final
        # re-solve) is recorded once and replayed: the host launches one graph
        # a solve (the box IPM's iterations one kernel inside it, in float32)
        kw = dict(dtype=numpy_dtype(dtype), x_scale=tpl.x_scale_np,
                  matmul_precision=matmul_precision, device=self.device, cuda_graph=True)
        if solver_kind == "ipm":
            kw["solve_mode"] = solve_mode
        factory = make_batched_box_ipm_solver if solver_kind == "box" else make_batched_ipm_solver
        self.solver = factory(tpl.K_eq_np, tpl.K_in_np, iters=iters,
                              newton_refine=newton_refine, **kw)
        if enum_iters is None:
            enum_iters = max(35, iters // 2)
        self.enum_solver = factory(tpl.K_eq_np, tpl.K_in_np, iters=enum_iters,
                                   newton_refine=enum_refine, **kw)

        # one engine over the padded suite structure
        self.spec, self.params = build_suite(microgrids, dtype, self.device,
                                             include_genset=self.include_genset)
        steps = {int(mg.final_step) - int(mg.initial_step) for mg in microgrids}
        if len(steps) != 1:
            raise ValueError(f"scenarios disagree on episode length: {sorted(steps)}")
        self.n_steps_year = steps.pop()

        self._engine_step = make_step_fn(self.spec, normalized=False, with_obs=False,
                                         with_log=False)
        self._reset_fn = make_reset_fn(self.spec)
        self._refine = (
            tpl.make_genset_refiner(enum_bits, enum_chunk, solver=self.enum_solver)
            if tpl.has_genset and enum_bits > 0 else None
        )

    # ------------------------------------------------------------- planning
    def _plan(self, states):
        """Actions for the ``(S, 1)`` engine states, all scenarios at once."""
        tpl, params, H = self.template, self.params, self.horizon
        with span("pymgrid.mpc.assemble"):
            t = states["step"]
            load_vec = -series_window(params, "load", tpl.load_ref.slot, t, H)   # (1, S, H)
            pv_vec = series_window(params, "renewable", tpl.pv_ref.slot, t, H)
            grid = tpl.grid_windows(params, t)
            # the modular path plans with an always-up grid (reference mpc.py:914)
            grid_status = torch.ones(H, dtype=self.dtype, device=self.device)
            c, b, h = tpl.assemble(params, load_vec, pv_vec, grid, grid_status,
                                   tpl.soc_0(params, states))
            if self._tie_bias is not None:
                c = c + self._tie_bias
        u = None
        if self._refine is not None:
            # rank the patterns on the cheap enumeration solver, then re-solve
            # each scenario's winner at full fidelity
            _, u, _, _ = self._refine(c, b, h)
            x, _ = self.solver(c[0], b[0], tpl.apply_genset_pattern(h, u)[0])
        else:
            x, _ = self.solver(c[0], b[0], h[0])
        with span("pymgrid.mpc.act"):
            actions = tpl.extract_action(x[None], u)
            if self.repair_balance:
                actions = tpl.rebalance_first_step(params, states, actions,
                                                   load_vec[..., 0].T, pv_vec[..., 0].T,
                                                   grid_status[0])
        return actions

    def _step(self, states):
        with span("pymgrid.mpc.step"):
            return self._engine_step(self.params, states, self._plan(states))

    def _reset(self, seed, starts=None):
        if starts is None:
            starts = self.params["initial_step"].to(torch.int32)
        else:
            starts = torch.as_tensor(starts, device=self.device).to(torch.int32)
            if starts.shape != (self.n_scenarios,):
                raise ValueError(f"starts must be ({self.n_scenarios},), one step per "
                                 f"scenario, got {tuple(starts.shape)}")
        starts = starts.unsqueeze(1)
        keys = reset_keys(self.spec, seed, starts.device, (starts.shape[0], 1))
        return self._reset_fn(self.params, starts, keys)

    # ------------------------------------------------------------------ api
    def reset(self, seed=0, starts=None):
        """``(S, ...)`` states at each scenario's initial step, or at the
        steps ``starts`` (one per scenario) with the battery at its initial
        charge; ``seed`` keys threefry-gaussian forecasts (``split(key(seed),
        S)``, as the JAX class keys them) and draws nothing for other
        forecasters."""
        return _drop(self._reset(seed, starts))

    def plan(self, states):
        """The controls every scenario executes from the ``(S, ...)``
        states: the engine's action dict with ``(S, ...)`` leaves."""
        return _drop(self._plan(_lift(states)))

    def act(self, states, actions):
        """The engine step of every scenario on ``actions``; returns
        ``(states, StepOutput)`` with ``(S,)`` fields (no observation or log
        row)."""
        new_states, out = self._engine_step(self.params, _lift(states), _lift(actions))
        return _drop(new_states), type(out)(*[None if f is None else f[:, 0] for f in out])

    def step(self, states):
        """Plan + act for every scenario: ``act(states, plan(states))``."""
        with span("pymgrid.mpc.step"):
            return self.act(states, self.plan(states))

    def run_scanned(self, n_steps=None, seed=0, chunk=500, progress=None):
        """The suite's receding-horizon run: rewards ``(T, S)`` as numpy
        (the year by default) and the final states.  Rewards stay on the
        device and are copied to the host once per ``chunk`` steps;
        ``progress``, if given, gets one line per copied chunk."""
        def step(states):
            states, out = self._step(states)
            return states, out.reward[:, 0]

        n_steps = self.n_steps_year if n_steps is None else n_steps
        rewards, states = run_chunked(step, self._reset(seed), n_steps, chunk, progress)
        return rewards, _drop(states)
