#!/usr/bin/env python
"""Micro-profile the batched RL env path against the suite rollout.

Port of the repository's ``tools/profile_env.py``: times
``BatchedDiscreteEnv.rollout`` (with and without obs) and a suite-style
rollout (``SuiteRunner``, the marginal-cost policy, obs checksummed, fixed
starts) on the same scenario, all float32, printing env-steps/s for each
variant, best of 3 after one untimed run.  The JAX tool's ``--tpu`` becomes
``--device``: the card by default, ``--device cpu`` on request.

Usage: python -m pymgrid_tpu_torch.tools.profile_env [--batch 2048] [--steps 100]
       [--scenario 0] [--device cuda]
"""
import argparse
import time

import numpy as np

from pymgrid_tpu_torch._device import resolve_device

__all__ = ["main", "parse_args", "profile", "timeit"]


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=2048)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--scenario", type=int, default=0)
    return ap.parse_args(argv)


def timeit(fn, device, repeats=3):
    """Best-of-``repeats`` seconds of ``fn()``, each run from a device
    synchronize to the next, after one untimed run; returns ``(seconds,
    the last run's output)``."""
    from pymgrid_tpu_torch.utils.profiling import _sync

    out = fn()
    best = float("inf")
    for _ in range(repeats):
        _sync(device)
        t0 = time.perf_counter()
        out = fn()
        _sync(device)
        best = min(best, time.perf_counter() - t0)
    return best, out


def profile(batch=2048, steps=100, scenario=0, device="cuda"):
    """The three timed rollouts of ``batch`` replicas x ``steps`` steps of
    ``scenario``: ``[(label, seconds, output), ...]``, the outputs those of
    the last runs (a ``(final_states, outs)`` pair for each env rollout, the
    ``(1, B)`` checksums for the suite)."""
    import torch

    from pymgrid_tpu_torch import Microgrid
    from pymgrid_tpu_torch.core.rollout import make_marginal_cost_policy
    from pymgrid_tpu_torch.envs import DiscreteMicrogridEnv
    from pymgrid_tpu_torch.parallel import BatchedDiscreteEnv, SuiteRunner

    device = resolve_device(device)
    B, T = batch, steps
    env = DiscreteMicrogridEnv.from_scenario(scenario)
    batched = BatchedDiscreteEnv(env, batch_size=B, dtype="float32", device=device)
    rng = np.random.RandomState(0)
    action_seq = torch.as_tensor(rng.randint(batched.n_actions, size=(T, B)),
                                 dtype=torch.int32, device=device)
    states = batched.reset(seed=0)

    results = []
    for keep_obs in (True, False):
        wall, out = timeit(lambda: batched.rollout(states, action_seq, keep_obs=keep_obs),
                           device)
        results.append((f"fused rollout keep_obs={keep_obs}", wall, out))

    # suite-style rollout on the same scenario (marginal-cost policy, obs
    # checksummed, not materialized)
    runner = SuiteRunner([Microgrid.from_scenario(scenario)], batch_per_config=B,
                         dtype="float32", device=device)
    fn = runner.rollout_fn(make_marginal_cost_policy(runner.spec), T, auto_reset=True,
                           collect=False)
    keys = runner.make_keys(seed=0)
    wall, out = timeit(lambda: fn(runner.params, keys), device)
    results.append(("suite rollout (obs checksummed)", wall, out))
    return results


def main(argv=None):
    """Print the JAX tool's three lines; returns :func:`profile`'s list."""
    args = parse_args(argv)
    results = profile(args.batch, args.steps, args.scenario, args.device)
    for label, wall, _ in results:
        print(f"{label}: {args.batch * args.steps / wall / 1e6:.2f}M env-steps/s  "
              f"({wall:.3f}s)", flush=True)
    return results


if __name__ == "__main__":
    main()
