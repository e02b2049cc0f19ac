#!/usr/bin/env python
"""End-to-end RL training on the port's engine.

Port of the repository's ``examples/train_rl.py``: actor-critic (A2C-style)
training of an MLP policy on the discrete priority-list environment.

* B env replicas step in lockstep through a
  :class:`~pymgrid_tpu_torch.parallel.BatchedDiscreteEnv` that shares one
  simulated time (the JAX example's unbatched ``step``); each step is the
  policy forward, a categorical draw, the table-driven priority-list dispatch,
  the engine step and the auto-reset.  Observations are in the engine's
  container order (``obs_layout="log"``, the JAX example's
  ``make_step_fn(spec, normalized=False)``), so weights carry across
  (:func:`theta_from_jax`).
* Only the MLP forwards carry gradients: the env step runs under
  ``torch.no_grad()``, as ``lax.stop_gradient`` cuts it in the JAX loss.
* :class:`~pymgrid_tpu_torch.utils.optax_adam.Adam`: ``optax.adam(lr)``'s
  steps bit for bit, given the same gradients.
* Data parallel over a :class:`~pymgrid_tpu_torch.parallel.distributed.BatchMesh`:
  each rank steps its rows of the global batch; after ``backward`` one
  ``all_reduce`` of the flattened gradient (with the loss and mean return)
  divided by the world size, XLA's psum-mean in the JAX example.  No DDP: its
  reducer assumes one forward per backward, and this loss calls the MLPs
  ``2 * rollout_len`` times.
* JAX's threefry draws (:mod:`pymgrid_tpu_torch.core.prng`), keyed as the
  JAX example keys them: ``init_theta`` from ``key(seed)``, each global
  replica's rollout keys from row ``i`` of ``split(fold_in(key, 2), batch)``
  (its env keys, where the spec draws gaussian forecasts, from
  ``split(fold_in(key, 1), batch)``), folded with the iteration index and
  split at every step for ``categorical``.  A rank takes its rows, so a
  seeded run is the JAX example's run at any world size.
* Every matmul runs in full float32 (TF32 off on CUDA).

Run: python -m pymgrid_tpu_torch.examples.train_rl [--scenario 1] [--batch 1024] [--iters 40]
(``--device cpu`` on a machine without a card; ``--mesh`` under ``torchrun``).
"""
import argparse
import time

import numpy as np
import torch
from torch import nn

from pymgrid_tpu_torch._device import resolve_device
from pymgrid_tpu_torch.core import prng
from pymgrid_tpu_torch.core.engine import make_reset_fn, make_step_fn, needs_keys
from pymgrid_tpu_torch.core.lp import _matmul_precision
from pymgrid_tpu_torch.core.params import without_config_axis
from pymgrid_tpu_torch.core.rollout import make_marginal_cost_policy, make_rollout_fn
from pymgrid_tpu_torch.envs import DiscreteMicrogridEnv
from pymgrid_tpu_torch.parallel.batched_env import BatchedDiscreteEnv
from pymgrid_tpu_torch.parallel.distributed import all_reduce_mean, local_layout
from pymgrid_tpu_torch.utils.optax_adam import Adam

__all__ = ["build_training", "ActorCritic", "theta_from_jax", "theta_to_numpy",
           "reward_to_go", "start_states", "zero_action"]

REWARD_SCALE = 1e-4   # costs are O(1e4): keeps the gradient scale sane
HIDDEN = (64, 64)


def zero_action(spec, batch, dtype, device):
    """The engine's all-zero action for a ``(C, B)`` ``batch``."""
    zeros = lambda *tail: torch.zeros(batch + tail, dtype=dtype, device=device)
    return {"battery": zeros(spec.n_battery), "genset": zeros(spec.n_genset, 2),
            "grid": zeros(spec.n_grid)}


def start_states(spec, params, step_fn, batch, keys=None):
    """The JAX examples' start: ``batch`` replicas reset at the config's
    initial step (given ``keys`` ``(1, B, 2)``, keyed by them), then one
    zero-action engine step (no auto-reset), all sharing one ``(1, 1)``
    step.  Returns ``(states, obs)`` with the config axis, ``(1, B, ...)``."""
    starts = params["initial_step"].to(torch.int32).view(1, 1)
    states = make_reset_fn(spec)(params, starts.expand(1, batch), keys)
    states["step"] = states["step"][:, :1]
    device = states["battery_charge"].device
    action = zero_action(spec, (1, batch), states["battery_charge"].dtype, device)
    states, out = step_fn(params, states, action)
    return states, out.obs


def reward_to_go(rewards, dones, gamma):
    """Discounted returns of ``(T, B)`` rewards with no bootstrap past a
    ``done``: the JAX example's reverse scan, in its operation order."""
    returns = torch.empty_like(rewards, dtype=torch.float32)
    carry = torch.zeros(rewards.shape[1:], dtype=torch.float32, device=rewards.device)
    for t in reversed(range(rewards.shape[0])):
        carry = rewards[t] + gamma * carry * (1.0 - dones[t].to(torch.float32))
        returns[t] = carry
    return returns


def _mlp(sizes):
    """``[Linear, Tanh, ..., Linear]`` over ``sizes``: the JAX ``mlp``."""
    layers = []
    for i, (m, n) in enumerate(zip(sizes[:-1], sizes[1:])):
        if i:
            layers.append(nn.Tanh())
        layers.append(nn.Linear(m, n))
    return nn.Sequential(*layers)


class ActorCritic(nn.Module):
    """Policy ``[obs, 64, 64, n_actions]`` and value ``[obs, 64, 64, 1]``
    MLPs with tanh, the JAX example's ``theta``."""

    def __init__(self, obs_dim, n_actions, hidden=HIDDEN):
        super().__init__()
        self.policy = _mlp([obs_dim, *hidden, n_actions])
        self.value = _mlp([obs_dim, *hidden, 1])

    def linears(self, head):
        return [m for m in getattr(self, head) if isinstance(m, nn.Linear)]


def _set_layers(theta, layers_by_head):
    """Copy ``{"w", "b"}`` layers (tensors on any device, or numpy or JAX
    arrays) into ``theta``'s ``nn.Linear`` layers."""
    def as_tensor(x):
        return x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))

    with torch.no_grad():
        for head, layers in layers_by_head.items():
            for linear, layer in zip(theta.linears(head), layers, strict=True):
                # JAX w is (in, out); nn.Linear.weight is (out, in)
                linear.weight.copy_(as_tensor(layer["w"]).T)
                linear.bias.copy_(as_tensor(layer["b"]))
    return theta


def theta_from_jax(theta, device="cuda"):
    """The JAX example's A2C pytree (``{"policy": [{"w", "b"}, ...],
    "value": [...]}``, numpy or JAX leaves) as an :class:`ActorCritic` on
    ``device``; every ``w`` is transposed into ``nn.Linear.weight``."""
    w0 = np.asarray(theta["policy"][0]["w"])
    hidden = tuple(np.asarray(layer["w"]).shape[1] for layer in theta["policy"][:-1])
    n_actions = np.asarray(theta["policy"][-1]["w"]).shape[1]
    module = ActorCritic(w0.shape[0], n_actions, hidden)
    return _set_layers(module, theta).to(resolve_device(device))


def theta_to_numpy(theta):
    """An :class:`ActorCritic` as the JAX example's pytree of numpy leaves."""
    return {head: [{"w": linear.weight.detach().cpu().numpy().T.copy(),
                    "b": linear.bias.detach().cpu().numpy().copy()}
                   for linear in theta.linears(head)]
            for head in ("policy", "value")}


class A2C:
    """The trainer :func:`build_training` returns: call it to train;
    ``eval_greedy`` and ``rbc_baseline`` evaluate on one shared slice."""

    def __init__(self, scenario, batch, rollout_len, lr, gamma, dtype, mesh,
                 entropy_coef, device):
        self.batch, self.rollout_len, self.lr = batch, rollout_len, lr
        self.gamma, self.entropy_coef, self.mesh = gamma, entropy_coef, mesh
        self.device, self.local_batch, self._rows = local_layout(mesh, batch, device)
        env = DiscreteMicrogridEnv.from_scenario(scenario)
        # this rank's replicas: the trainer shards the batch itself
        self.venv = BatchedDiscreteEnv(env, self.local_batch, dtype, self.device,
                                       obs_layout="log")
        self.spec = self.venv.spec
        self.n_actions, self.obs_dim = self.venv.n_actions, self.venv.obs_dim
        self._eval_env = BatchedDiscreteEnv(env, 1, dtype, self.device,
                                            auto_reset=False, obs_layout="log")
        self._start_step = make_step_fn(self.spec, with_log=False)

    # ---------------------------------------------------------------- model
    def init_theta(self, seed=0):
        """Fresh weights, the JAX ``init_theta(PRNGKey(seed))``: ``kp, kv =
        split(key)``, one key of ``split(k, n_layers)`` per layer, ``w``
        normal times ``sqrt(2 / fan_in)``, zero biases."""
        head_keys = prng.split(prng.key(seed, self.device))
        layers = {}
        for head_key, (head, n_out) in zip(head_keys, (("policy", self.n_actions),
                                                       ("value", 1))):
            sizes = [self.obs_dim, *HIDDEN, n_out]
            layer_keys = prng.split(head_key, len(sizes) - 1)
            layers[head] = [{"w": prng.normal(k, (m, n), torch.float32) * np.sqrt(2.0 / m),
                             "b": torch.zeros(n)}
                            for k, m, n in zip(layer_keys, sizes[:-1], sizes[1:])]
        return _set_layers(ActorCritic(self.obs_dim, self.n_actions).to(self.device), layers)

    # -------------------------------------------------------------- rollout
    def _row_keys(self, seed, data):
        """This rank's rows of ``split(fold_in(key(seed), data), batch)``:
        ``(B, 2)``."""
        return prng.split(prng.fold_in(prng.key(seed, self.device), data), self.batch)[self._rows]

    def rollout_keys(self, seed):
        """This rank's rows of the JAX example's rollout keys for a run with
        ``seed``, ``split(fold_in(key(seed), 2), batch)``: ``(B, 2)``."""
        return self._row_keys(seed, 2)

    def init_envs(self, seed=0):
        """This rank's replicas after the start step: ``(states, obs)``,
        ``(B, ...)`` states with one shared ``(1,)`` step.  A spec that draws
        gaussian forecasts is keyed by its rows of ``split(fold_in(key(seed),
        1), batch)``, as the JAX example; elsewhere the keys reach no output
        and the states carry none."""
        keys = self._row_keys(seed, 1)[None] if needs_keys(self.spec) else None
        states, obs = start_states(self.spec, self.venv.params, self._start_step,
                                   self.local_batch, keys)
        return without_config_axis(states), obs[0]

    def loss(self, theta, states, obs, actions=None, keys=None):
        """One A2C rollout of ``rollout_len`` steps and its loss over this
        rank's rows (the JAX ``loss_fn``).  ``actions``: ``(T, B)`` global
        actions to feed (this rank takes its columns); without them actions
        are drawn from this rank's ``keys`` ``(B, 2)``, split at every step
        into the carried keys and ``categorical``'s.  Returns ``(loss,
        (states, obs, mean_return))``."""
        if actions is not None:
            actions = torch.as_tensor(actions, device=self.device)[:, self._rows].long()
        logps, values, rewards, dones, entropies = [], [], [], [], []
        for t in range(self.rollout_len):
            x = obs.float()
            logits = theta.policy(x)
            if actions is None:
                pair = prng.split(keys)
                keys = pair[:, 0]
                action = prng.categorical(pair[:, 1], logits.detach())
            else:
                action = actions[t]
            logp_all = torch.log_softmax(logits, dim=-1)
            onehot = nn.functional.one_hot(action, self.n_actions).to(logp_all.dtype)
            logps.append((onehot * logp_all).sum(dim=-1))
            # categorical entropy: pressure away from the RBC-like optimum
            entropies.append(-(torch.exp(logp_all) * logp_all).sum(dim=-1))
            values.append(theta.value(x)[:, 0])
            with torch.no_grad():
                states, out = self.venv.step(states, action, keep_logs=False)
            rewards.append(out.reward * REWARD_SCALE)
            dones.append(out.done)
            obs = out.obs

        returns = reward_to_go(torch.stack(rewards), torch.stack(dones), self.gamma)
        adv = returns - torch.stack(values)
        policy_loss = -(torch.stack(logps) * adv.detach()).mean()
        value_loss = (adv ** 2).mean()
        loss = (policy_loss + 0.5 * value_loss
                - self.entropy_coef * torch.stack(entropies).mean())
        return loss, (states, obs, returns.mean())

    def train_step(self, theta, optimizer, states, obs, actions=None, keys=None):
        """One iteration: rollout and loss, ``backward``, the data-parallel
        gradient mean, the Adam step.  Returns ``(states, obs, loss,
        mean_return)``, the last two as the job's means (0-d tensors)."""
        with _matmul_precision("float32", self.device):
            optimizer.zero_grad()
            loss, (states, obs, mean_ret) = self.loss(theta, states, obs, actions, keys)
            loss.backward()
            params = [p for p in theta.parameters()]
            flat = torch.cat([p.grad.reshape(-1) for p in params]
                             + [loss.detach().view(1), mean_ret.view(1)])
            if self.mesh is not None:
                all_reduce_mean(flat)
                offset = 0
                for p in params:
                    p.grad.copy_(flat[offset:offset + p.numel()].view_as(p))
                    offset += p.numel()
            optimizer.step()
        return states, obs, flat[-2], flat[-1]

    def __call__(self, iters=40, seed=0, log_every=10, theta=None, opt_state=None):
        """Train ``iters`` iterations; returns ``(theta, opt_state,
        history)``, ``opt_state`` the :class:`Adam` over ``theta``,
        so that a continuation block resumes the Adam moments.  Every call
        keys its draws and resets its envs from ``seed``, as the JAX
        ``run``; iteration ``it`` folds ``it`` into the carried rollout
        keys.  The device is read (and a line printed) once per
        ``log_every`` iterations; the history does not depend on it."""
        if theta is None:
            theta = self.init_theta(seed)
        if opt_state is None:
            opt_state = Adam(theta.parameters(), lr=self.lr)
        keys = self.rollout_keys(seed)
        states, obs = self.init_envs(seed)
        history, pending = [], []
        for it in range(iters):
            keys = prng.fold_in(keys, it)
            states, obs, loss, mean_ret = self.train_step(theta, opt_state, states, obs,
                                                          keys=keys)
            pending.append(torch.stack([loss, mean_ret]))
            if len(pending) == log_every or it == iters - 1:
                values = torch.stack(pending).cpu().numpy()
                history.extend(float(r) for r in values[:, 1])
                print(f"iter {it + 1 - len(pending)}..{it}: loss={values[-1, 0]:.4f} "
                      f"mean_return={values[-1, 1]:.4f}", flush=True)
                pending = []
        return theta, opt_state, history

    # ------------------------------------------------------------ evaluation
    def _eval_start(self):
        return start_states(self.spec, self._eval_env.params, self._start_step, 1)

    @torch.no_grad()
    def eval_greedy(self, theta, n_steps=1000, seed=123):
        """Full-slice return of the greedy learned policy (raw rewards, no
        auto-reset), from the same start as :meth:`rbc_baseline`.  ``seed``
        is kept for the JAX signature: the start does not depend on it."""
        states, obs = self._eval_start()
        state, obs = without_config_axis(states), obs[0]
        rewards = []
        with _matmul_precision("float32", self.device):
            for _ in range(n_steps):
                action = torch.argmax(theta.policy(obs.float()), dim=-1)
                state, out = self._eval_env.step(state, action, keep_logs=False)
                rewards.append(out.reward)
                obs = out.obs
        return float(torch.cat(rewards).sum())

    @torch.no_grad()
    def rbc_baseline(self, n_steps=1000, seed=123):
        """Marginal-cost RBC return on the identical eval slice."""
        states, _ = self._eval_start()
        fn = make_rollout_fn(self.spec, make_marginal_cost_policy(self.spec), n_steps,
                             auto_reset=False, collect=False)
        _, (rewards, _) = fn(self._eval_env.params, states)
        return float(rewards.sum())


def build_training(scenario=1, batch=1024, rollout_len=64, lr=3e-4, gamma=0.99,
                   dtype="float32", mesh=None, entropy_coef=0.01, device="cuda"):
    """The A2C trainer for ``scenario``: ``run = build_training(...)``, then
    ``theta, opt_state, history = run(iters)``, ``run.eval_greedy(theta)``
    and ``run.rbc_baseline()``.  With ``mesh`` the batch is global and each
    rank trains on its rows on the mesh's device."""
    return A2C(scenario, batch, rollout_len, lr, gamma, dtype, mesh, entropy_coef, device)


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--scenario", type=int, default=1)
    parser.add_argument("--batch", type=int, default=1024)
    parser.add_argument("--rollout-len", type=int, default=64)
    parser.add_argument("--iters", type=int, default=40)
    parser.add_argument("--mesh", action="store_true",
                        help="data parallel over the torchrun job (one process per card)")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--eval-steps", type=int, default=1000,
                        help="greedy-policy vs RBC evaluation slice length")
    parser.add_argument("--until-beats-rbc", action="store_true",
                        help="keep training in --iters blocks until the greedy "
                             "policy's eval return exceeds RBC on the same slice "
                             "(or --max-blocks)")
    parser.add_argument("--max-blocks", type=int, default=20)
    parser.add_argument("--entropy-coef", type=float, default=0.01)
    parser.add_argument("--log-every", type=int, default=10,
                        help="iterations per progress line (one device read)")
    args = parser.parse_args()

    mesh = None
    if args.mesh:
        from pymgrid_tpu_torch.parallel import distributed, make_batch_mesh

        distributed.initialize(device=args.device)
        mesh = make_batch_mesh(device=args.device)

    run = build_training(scenario=args.scenario, batch=args.batch,
                         rollout_len=args.rollout_len, mesh=mesh,
                         entropy_coef=args.entropy_coef, device=args.device)
    rbc_ret = run.rbc_baseline(n_steps=args.eval_steps)
    print(f"RBC return over {args.eval_steps} eval steps: {rbc_ret:,.2f}", flush=True)

    train_s = 0.0
    if args.until_beats_rbc:
        theta = opt_state = None
        history, iters_done = [], 0
        for block in range(args.max_blocks):
            t0 = time.perf_counter()
            theta, opt_state, hist = run(iters=args.iters, seed=block, theta=theta,
                                         opt_state=opt_state, log_every=args.log_every)
            train_s += time.perf_counter() - t0
            history += hist
            iters_done += args.iters
            pol_ret = run.eval_greedy(theta, n_steps=args.eval_steps)
            print(f"after {iters_done} iters ({train_s:.1f}s training): greedy policy "
                  f"return {pol_ret:,.2f} vs RBC {rbc_ret:,.2f} "
                  f"({'BEATS' if pol_ret > rbc_ret else 'below'})", flush=True)
            if pol_ret > rbc_ret:
                break
    else:
        t0 = time.perf_counter()
        theta, _, history = run(iters=args.iters, log_every=args.log_every)
        train_s = time.perf_counter() - t0
        iters_done = args.iters
        pol_ret = run.eval_greedy(theta, n_steps=args.eval_steps)
        print(f"greedy policy return over {args.eval_steps} eval steps: "
              f"{pol_ret:,.2f} vs RBC {rbc_ret:,.2f}", flush=True)
    steps = args.batch * args.rollout_len * iters_done
    print(f"trained {iters_done} iters ({steps:,} env steps) in {train_s:.1f}s "
          f"({steps / train_s:.6g} env-steps/s, training only); "
          f"return {history[0]:.3f} -> {history[-1]:.3f}", flush=True)


if __name__ == "__main__":
    main()
