"""Entry points of the port (the twin of the repository's
``__graft_entry__.py``).

``entry()``             -> ``(step_fn, (params, state, action))``: the engine
                           step on the flagship config (pymgrid25 scenario 0)
                           and its arguments.
``dryrun_multichip(n)`` -> one data-parallel REINFORCE training step over the
                           job it runs in (``8 * n`` replicas of scenario 1, 16
                           steps; each rank its rows, the gradient mean by one
                           ``all_reduce``), then a meshed ``BatchedDiscreteEnv``
                           rollout with its ``shared_step=True`` twin held
                           bitwise against it, then a meshed ``SuiteRunner``
                           block-prefetch rollout from JAX's int32 starts
                           (the JAX dryrun runs without x64).

One process drives one device: ``n`` is the job's world size.  Outside a job
(no process group), ``dryrun_multichip(1)`` starts a one-process group of its
own over ``localhost`` (NCCL on a card, gloo on the CPU), so its collectives
run, and ends it afterwards.

Run: ``python -m pymgrid_tpu_torch.entry`` (one card), or
``torchrun --nproc-per-node N -m pymgrid_tpu_torch.entry``.
"""
import numpy as np
import torch
import torch.distributed as torch_dist

from pymgrid_tpu_torch import Microgrid
from pymgrid_tpu_torch.core.compiled import CompiledMicrogrid
from pymgrid_tpu_torch.core.engine import make_reset_fn, make_step_fn
from pymgrid_tpu_torch.core.params import params_to_torch, with_config_axis
from pymgrid_tpu_torch.core.rollout import make_marginal_cost_policy
from pymgrid_tpu_torch.core.spec import extract_spec
from pymgrid_tpu_torch.envs import DiscreteMicrogridEnv
from pymgrid_tpu_torch.parallel import BatchedDiscreteEnv, SuiteRunner, make_batch_mesh
from pymgrid_tpu_torch.parallel import distributed as dist

__all__ = ["entry", "dryrun_multichip"]


def entry(device="cuda"):
    """The flagship config's engine step (float32, normalized actions) and
    example arguments: a reset state and the zero action."""
    compiled = CompiledMicrogrid(Microgrid.from_scenario(0), dtype="float32", device=device)
    step_fn = make_step_fn(compiled.spec, normalized=True)
    return step_fn, (compiled.params, compiled.reset(), compiled.zero_action())


def _reinforce_step(mesh, batch, n_steps, sigma=0.1, lr=1e-4):
    """The JAX ``train_step``: Gaussian-exploration REINFORCE with a linear
    sigmoid policy on scenario 1 (every module kind), this rank's rows of
    ``batch`` replicas; returns the job's loss and mean return."""
    spec, params, _ = extract_spec(Microgrid.from_scenario(1), dtype=np.float32)
    params = with_config_axis(params_to_torch(params, mesh.device, "float32"))
    step_fn = make_step_fn(spec, normalized=True, with_log=False)
    local = mesh.local_size(batch)
    n_act = spec.n_battery + 2 * spec.n_genset + spec.n_grid
    w = torch.zeros((spec.obs_dim, n_act), device=mesh.device, requires_grad=True)
    b = torch.zeros(n_act, device=mesh.device, requires_grad=True)
    generator = torch.Generator(device=mesh.device).manual_seed(mesh.rank)

    states = make_reset_fn(spec)(
        params, params["initial_step"].to(torch.int32).view(1, 1).expand(1, local))
    obs = torch.zeros((local, spec.obs_dim), device=mesh.device)
    logps, rewards = [], []
    for _ in range(n_steps):
        mean = torch.sigmoid(obs @ w + b)
        eps = torch.randn((local, n_act), generator=generator, device=mesh.device)
        a = torch.clamp(mean.detach() + sigma * eps, 0.0, 1.0)
        logps.append(-((a - mean) ** 2).sum(dim=-1) / (2 * sigma ** 2))
        nb, ng = spec.n_battery, spec.n_genset
        action = {"battery": a[None, :, :nb],
                  "genset": a[None, :, nb:nb + 2 * ng].reshape(1, local, ng, 2),
                  "grid": a[None, :, nb + 2 * ng:]}
        with torch.no_grad():
            states, out = step_fn(params, states, action)
        rewards.append(out.reward[0])
        obs = out.obs[0]
    ret = torch.stack(rewards).sum(dim=0)
    loss = -(torch.stack(logps).sum(dim=0) * ret).mean()
    loss.backward()
    flat = dist.all_reduce_mean(torch.cat([w.grad.reshape(-1), b.grad,
                                           loss.detach().view(1), ret.mean().view(1)]))
    with torch.no_grad():
        w -= lr * flat[:w.numel()].view_as(w)
        b -= lr * flat[w.numel():w.numel() + n_act]
    return float(flat[-2]), float(flat[-1])


def dryrun_multichip(n_devices, device="cuda"):
    """One data-parallel training step, the meshed env rollouts and the
    meshed suite rollout over the job (see the module docstring); returns
    what it printed as a dict."""
    own_group = False
    if not torch_dist.is_initialized() and n_devices == 1:
        own_group = dist.initialize(f"127.0.0.1:{dist.free_port()}", 1, 0, device=device)
    try:
        mesh = make_batch_mesh(n_devices, device)
        batch, n_steps = 8 * n_devices, 16
        loss, mean_ret = _reinforce_step(mesh, batch, n_steps)
        if not np.isfinite(loss):
            raise RuntimeError("training step produced a non-finite loss")

        # the env rollout RL users train on, meshed, and its shared-step twin
        batched = BatchedDiscreteEnv(DiscreteMicrogridEnv.from_scenario(1), batch,
                                     "float32", mesh=mesh)
        seq = np.random.RandomState(0).randint(batched.n_actions, size=(n_steps, batch))
        _, outs = batched.rollout(batched.reset(), seq)
        rewards = dist.fetch(outs.reward, axis=1)
        if not (np.isfinite(rewards).all()
                and dist.fetch(outs.obs, axis=1).shape == (n_steps, batch, batched.obs_dim)):
            raise RuntimeError("meshed env rollout: non-finite or misshapen outputs")
        _, shared = batched.rollout(batched.reset(), seq, shared_step=True)
        if not np.array_equal(dist.fetch(shared.reward, axis=1), rewards):
            raise RuntimeError("meshed env rollout: shared_step=True differs from the "
                               "per-replica-step rollout")

        # the suite rollout (blocked: 16 steps are two blocks) with configs
        # sharded over the job; JAX's int32 starts, as the JAX dryrun runs
        # without jax_enable_x64
        runner = SuiteRunner([Microgrid.from_scenario(s) for s in range(n_devices)],
                             batch_per_config=4, dtype="float32", mesh=mesh,
                             start_dtype=torch.int32)
        fn = runner.rollout_fn(make_marginal_cost_policy(runner.spec), n_steps,
                               auto_reset=True, collect=False, randomize_initial_step=True)
        acc = dist.fetch(fn(runner.params, runner.make_keys(0)))
        if not np.isfinite(acc).all():
            raise RuntimeError("meshed suite rollout: non-finite output")
    finally:
        if own_group:
            torch_dist.destroy_process_group()
    result = {"devices": n_devices, "batch": batch, "loss": loss, "mean_return": mean_ret,
              "fused_rollout_mean_reward": float(rewards.mean()),
              "suite_mean": float(acc.mean())}
    print(f"dryrun_multichip: {n_devices} devices ({torch.device(device).type}), "
          f"batch={batch}, loss={loss:.4f}, mean_return={mean_ret:.4f}, "
          f"fused_rollout_mean_reward={result['fused_rollout_mean_reward']:.4f}, "
          f"suite_mean={result['suite_mean']:.4f}", flush=True)
    return result


if __name__ == "__main__":
    dist.initialize()
    fn, args = entry()
    _, out = fn(*args)
    print("entry step ok; reward:", float(out.reward))
    dryrun_multichip(dist.process_count())
    if torch_dist.is_initialized():
        torch_dist.destroy_process_group()
