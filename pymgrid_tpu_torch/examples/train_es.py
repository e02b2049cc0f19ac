#!/usr/bin/env python
"""Evolution-strategies training on the port's engine: optimize the
full-year return directly.

Port of the repository's ``examples/train_es.py`` (OpenAI-style ES:
antithetic perturbations, centered-rank shaping, and ``optax.adam``'s
steps bit for bit through :class:`~pymgrid_tpu_torch.utils.optax_adam.Adam`).
One generation evaluates the whole population as **one** engine batch (``C = 1``,
``B = pop``) whose members share the simulated time (one ``(1, 1)`` step), so
every time row is read once per step for all of them; each member's MLP is a
batched product over ``(pop, ...)`` weights.

``continuous=False``: the policy picks among the discrete env's priority
orderings (argmax over the MLP's logits).  ``continuous=True``: the MLP drives
the battery dispatch directly (tanh output scaled to the state's true
charge/discharge room) and the grid follows the residual, in the JAX
example's operation order.

The parameter vector has the JAX example's flat layout (per layer ``w``
row-major as ``(in, out)``, then ``b``), so a JAX ``theta_flat`` carries
across as it is: no converter is needed.  The draws are JAX's threefry
draws (:mod:`pymgrid_tpu_torch.core.prng`), keyed as the JAX example keys
them: ``theta0 = 0.01 * normal(fold_in(key, 0))`` and generation ``g``'s
noise ``normal(fold_in(key, 1000 + g))``, so a seeded run is the JAX
example's run, generation by generation.

Run: python -m pymgrid_tpu_torch.examples.train_es [--scenario 0] [--pop 256] [--gens 150]
(``--device cpu`` on a machine without a card).
"""
import argparse
import time

import numpy as np
import torch

from pymgrid_tpu_torch._device import numpy_dtype, resolve_device, torch_dtype
from pymgrid_tpu_torch.core import prng
from pymgrid_tpu_torch.core.engine import gather_rows, make_step_fn, slot_param
from pymgrid_tpu_torch.core.lp import _matmul_precision
from pymgrid_tpu_torch.core.params import params_to_torch, with_config_axis
from pymgrid_tpu_torch.core.rollout import (
    make_lockstep_sweep_fn,
    make_marginal_cost_policy,
    make_table_policy,
)
from pymgrid_tpu_torch.core.spec import extract_spec
from pymgrid_tpu_torch.core.tables import ensure_tables
from pymgrid_tpu_torch.envs import ContinuousMicrogridEnv, DiscreteMicrogridEnv
from pymgrid_tpu_torch.examples.train_rl import start_states
from pymgrid_tpu_torch.utils.optax_adam import Adam

__all__ = ["build_es"]


def _reciprocal(c):
    """``1 / c`` in float32, as XLA folds a division by the constant ``c``
    into a product (a Python float, exact in float32)."""
    return float(np.float32(1.0) / np.float32(c))


_XLA_WINDOW = 32     # rows per block of XLA's CPU tree-reduction rewrite


def _xla_row_sum(x):
    """``x.sum(0)`` in the order of XLA's CPU backend: up to 32 rows one
    after another from zero; more rows are padded with zeros, evenly at both
    ends, to a multiple of 32, each block of 32 rows is summed so, and the
    block sums are summed the same way (XLA's tree-reduction rewrite into a
    ``reduce-window``)."""
    n = x.shape[0]
    if n > _XLA_WINDOW:
        pad = -n % _XLA_WINDOW
        zeros = lambda k: x.new_zeros((k,) + x.shape[1:])
        x = torch.cat([zeros(pad // 2), x, zeros(pad - pad // 2)])
        x = x.view(-1, _XLA_WINDOW, *x.shape[1:]).transpose(0, 1)
        return _xla_row_sum(_xla_row_sum(x))
    total = x.new_zeros(x.shape[1:])
    for row in x:
        total = total + row
    return total


class ES:
    """The trainer :func:`build_es` returns: call it to train."""

    def __init__(self, scenario, pop, sigma, lr, hidden, n_steps, dtype, continuous, device):
        self.device, self.dtype = resolve_device(device), torch_dtype(dtype)
        self.pop, self.sigma, self.lr, self.n_steps = pop, sigma, lr, n_steps
        self.continuous = continuous
        env = (ContinuousMicrogridEnv if continuous else DiscreteMicrogridEnv).from_scenario(scenario)
        spec, params, _ = extract_spec(env, dtype=numpy_dtype(dtype))
        if continuous and (spec.n_battery != 1 or spec.n_grid != 1 or spec.n_genset != 0):
            raise NotImplementedError(
                "continuous ES mode targets the battery+grid family (scenario "
                "0-family arbitrage demonstration)")
        self.spec = spec
        self.params = ensure_tables(
            spec, with_config_axis(params_to_torch(params, self.device, self.dtype)),
            config_axis=True)
        n_out = 1 if continuous else env.action_space.n
        if not continuous:
            self._table_policy = make_table_policy(
                spec, [list(pl) for pl in env.actions_list], self.device)
        self._step_fn = make_step_fn(spec, with_log=False)
        sizes = [spec.obs_dim, hidden, n_out]
        self._shapes = []
        for m, n in zip(sizes[:-1], sizes[1:]):
            self._shapes += [(m, n), (n,)]
        self.dim = sum(int(np.prod(s)) for s in self._shapes)

    # -------------------------------------------------------------- policy
    def _unflatten(self, thetas):
        """``(P, dim)`` flat vectors -> per-layer ``(P, in, out)`` and
        ``(P, out)`` tensors."""
        layers, off = [], 0
        for s in self._shapes:
            k = int(np.prod(s))
            layers.append(thetas[:, off:off + k].reshape((thetas.shape[0],) + s))
            off += k
        return layers

    @staticmethod
    def _mlp(layers, x):
        """Every member's MLP on its own row of ``x`` (``(P, obs)``)."""
        for i in range(0, len(layers) - 2, 2):
            x = torch.tanh(torch.bmm(x.unsqueeze(1), layers[i])[:, 0] + layers[i + 1])
        return torch.bmm(x.unsqueeze(1), layers[-2])[:, 0] + layers[-1]

    def _action(self, layers, state, obs):
        out = self._mlp(layers, obs[0].float())                 # (P, n_out)
        if not self.continuous:
            return self._table_policy(self.params, state, torch.argmax(out, dim=-1)[None])
        # battery dispatch scaled to the state's true room; grid follows
        p = self.params
        pb = p["battery"]
        charge = state["battery_charge"][..., 0]
        eff = slot_param(pb["efficiency"], 0)
        max_dis = torch.minimum(slot_param(pb["max_discharge"], 0),
                                charge - slot_param(pb["min_capacity"], 0)) * eff
        max_chg = torch.minimum(slot_param(pb["max_charge"], 0),
                                slot_param(pb["max_capacity"], 0) - charge) / eff
        u = torch.tanh(out[:, 0]).to(self.dtype)[None]
        bat = torch.where(u >= 0, u * max_dis, u * max_chg)
        t = state["step"]
        load = -gather_rows(p["load"]["ts"][:, 0], t)[..., 0]
        pv = gather_rows(p["renewable"]["ts"][:, 0], t)[..., 0]
        resid = torch.clamp_min(load - pv, 0.0)
        need = resid - torch.clamp_min(bat, 0.0) + torch.clamp_min(-bat, 0.0)
        status = gather_rows(p["grid"]["ts"][:, 0], t)[..., 3]
        grid = torch.minimum(torch.clamp_min(need, 0.0),
                             slot_param(p["grid"]["max_import"], 0) * status)
        return {"battery": bat[..., None],
                "genset": torch.zeros(bat.shape + (0, 2), dtype=self.dtype, device=self.device),
                "grid": grid[..., None]}

    # ---------------------------------------------------------- evaluation
    @torch.no_grad()
    def episode_returns(self, thetas):
        """Greedy ``n_steps`` return (raw rewards, no resets) of every row
        of ``thetas`` (``(P, dim)``), all members in one engine batch from
        the start the RBC baseline uses; returns ``(P,)``."""
        thetas = torch.as_tensor(thetas, device=self.device)
        states, obs = start_states(self.spec, self.params, self._step_fn, thetas.shape[0])
        layers = self._unflatten(thetas.float())
        acc = torch.zeros(states["battery_charge"].shape[:2], dtype=self.dtype,
                          device=self.device)
        with _matmul_precision("float32", self.device):
            for _ in range(self.n_steps):
                states, out = self._step_fn(self.params, states,
                                            self._action(layers, states, obs))
                acc = acc + out.reward
                obs = out.obs
        return acc[0]

    def eval_theta(self, theta_flat, seed=123):
        """Greedy return of one flat parameter vector.  ``seed`` is kept for
        the JAX signature: the start does not depend on it."""
        return float(self.episode_returns(torch.as_tensor(theta_flat).reshape(1, -1))[0])

    @torch.no_grad()
    def rbc_baseline(self, seed=123):
        """Marginal-cost RBC return on the same slice and start."""
        states, _ = start_states(self.spec, self.params, self._step_fn, 1)
        sweep = make_lockstep_sweep_fn(self.spec, make_marginal_cost_policy(self.spec),
                                       self.n_steps)
        return float(sweep(self.params, states)[1][0, 0])

    # ------------------------------------------------------------- training
    def update(self, theta, optimizer, eps, returns):
        """The centered-rank ES update of ``theta`` (a leaf tensor that
        ``optimizer`` holds) from the population's ``eps`` (``(pop, dim)``)
        and ``returns`` (``(pop,)``), as XLA compiles the JAX example's
        ``-(shaped[:, None] * eps).mean(axis=0) / sigma``: each division by
        a constant (``pop - 1``, ``pop``, ``sigma``) a product with its
        float32 reciprocal, the rows summed in XLA's order
        (:func:`_xla_row_sum`), so the gradient is the JAX program's bit
        for bit.  Ranks use stable sorts, as ``jnp.argsort``."""
        ranks = torch.argsort(torch.argsort(returns, stable=True), stable=True).float()
        shaped = ranks * _reciprocal(self.pop - 1) - 0.5
        mean = _xla_row_sum(shaped[:, None] * eps) * _reciprocal(self.pop)
        theta.grad = -mean * _reciprocal(self.sigma)
        optimizer.step()

    def initial_theta(self, seed):
        """The JAX ``run``'s start, ``0.01 * normal(fold_in(key(seed), 0),
        (dim,))`` in float32."""
        key = prng.fold_in(prng.key(seed, self.device), 0)
        return 0.01 * prng.normal(key, (self.dim,), torch.float32)

    def noise(self, key):
        """A generation's antithetic noise from its key (the JAX
        ``es_generation``'s): ``eps = normal(key, (pop // 2, dim))`` in
        float32, then ``[eps, -eps]``; ``(pop, dim)``."""
        eps = prng.normal(key, (self.pop // 2, self.dim), torch.float32)
        return torch.cat([eps, -eps])

    def generation(self, theta, optimizer, key):
        """One generation: antithetic noise from the generation's ``key``,
        the population's returns, the update; returns the returns."""
        eps = self.noise(key)
        with torch.no_grad():
            returns = self.episode_returns(theta.detach()[None] + self.sigma * eps)
        self.update(theta, optimizer, eps, returns)
        return returns

    def __call__(self, gens=150, seed=0, log_every=10, eval_seed=123):
        """Train ``gens`` generations from :meth:`initial_theta`, generation
        ``g`` keyed by ``fold_in(key(seed), 1000 + g)``; returns ``(theta,
        history)``, history the best return of each generation."""
        theta = self.initial_theta(seed).requires_grad_()
        optimizer = Adam([theta], lr=self.lr)
        key = prng.key(seed, self.device)
        history = []
        for g in range(gens):
            returns = self.generation(theta, optimizer, prng.fold_in(key, 1000 + g))
            r_max, r_mean = torch.stack([returns.max(), returns.mean()]).tolist()
            history.append(r_max)
            if g % log_every == 0:
                print(f"gen {g}: best-of-pop {r_max:,.2f} mean {r_mean:,.2f}", flush=True)
        return theta.detach(), history


def build_es(scenario=0, pop=256, sigma=0.05, lr=0.02, hidden=32, n_steps=8758,
             dtype="float32", continuous=False, device="cuda"):
    """The ES trainer: ``run = build_es(...)``, then ``theta, history =
    run(gens)``; ``run.eval_theta``, ``run.rbc_baseline``, ``run.pop``,
    ``run.dim`` and ``run.n_steps`` as in the JAX example."""
    return ES(scenario, pop, sigma, lr, hidden, n_steps, dtype, continuous, device)


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--scenario", type=int, default=0)
    parser.add_argument("--pop", type=int, default=256)
    parser.add_argument("--gens", type=int, default=150)
    parser.add_argument("--sigma", type=float, default=0.05)
    parser.add_argument("--lr", type=float, default=0.02)
    parser.add_argument("--hidden", type=int, default=32)
    parser.add_argument("--steps", type=int, default=8758)
    parser.add_argument("--continuous", action="store_true",
                        help="MLP battery dispatch + grid follower (continuous env) "
                             "instead of discrete priority-ordering selection")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args()

    run = build_es(scenario=args.scenario, pop=args.pop, sigma=args.sigma, lr=args.lr,
                   hidden=args.hidden, n_steps=args.steps, continuous=args.continuous,
                   device=args.device)
    rbc = run.rbc_baseline()
    print(f"RBC return over {args.steps} steps: {rbc:,.2f}", flush=True)
    t0 = time.perf_counter()
    theta, history = run(gens=args.gens)
    dt = time.perf_counter() - t0
    pol = run.eval_theta(theta)
    steps = args.pop * args.steps * args.gens
    print(f"ES: {args.gens} gens x pop {args.pop} = {steps:,} env steps in {dt:.1f}s "
          f"({steps / dt:.6g} env-steps/s)")
    if rbc < 0:
        print(f"final greedy policy return {pol:,.2f} vs RBC {rbc:,.2f} "
              f"({'BEATS' if pol > rbc else 'below'}, {(1 - pol / rbc) * 100:+.2f}% cost)")


if __name__ == "__main__":
    main()
