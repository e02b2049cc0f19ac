"""Checkpoint/resume of the port's engine states (CPU, float64).

The invariant of tests/test_checkpoint.py, without the sharded case: save at
step k, restore, continue, and the trajectory is bitwise-identical to an
uninterrupted run.
"""
import numpy as np
import pytest
import torch

import pymgrid_tpu_torch.modules as M
from helpers.factories import build_microgrid, module_params
from pymgrid_tpu_torch import Microgrid
from pymgrid_tpu_torch.core.compiled import CompiledMicrogrid
from pymgrid_tpu_torch.envs import ContinuousMicrogridEnv, DiscreteMicrogridEnv
from pymgrid_tpu_torch.parallel import BatchedContinuousEnv, BatchedDiscreteEnv
from pymgrid_tpu_torch.utils.checkpoint import restore_state, save_state

torch.set_num_threads(1)


def _modules(seed=0):
    mods, _ = build_microgrid(M, module_params(seed=seed),
                              ("genset", "battery", "pv", "load", "grid"))
    return mods


def _leaves(state):
    if isinstance(state, dict):
        return [leaf for k in sorted(state) for leaf in _leaves(state[k])]
    return [state]


def _assert_same_state(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.device == y.device
        np.testing.assert_array_equal(x.numpy(), y.numpy())


def test_compiled_state_resume(tmp_path):
    """Save mid-episode, restore, continue: a bitwise-equal trajectory."""
    mg = Microgrid(_modules())
    compiled = CompiledMicrogrid(mg, dtype="float64", device="cpu")
    np.random.seed(0)
    actions = [compiled.action_to_arrays(mg.sample_action()) for _ in range(30)]

    ref_state, ref_rewards = compiled.reset(), []
    for a in actions:
        ref_state, out = compiled.step(ref_state, a)
        ref_rewards.append(float(out.reward))

    s = compiled.reset()
    for a in actions[:12]:
        s, _ = compiled.step(s, a)
    compiled.save_state(tmp_path / "ckpt.pt", s)
    restored = compiled.restore_state(tmp_path / "ckpt.pt")
    _assert_same_state(restored, s)
    rewards = []
    for a in actions[12:]:
        restored, out = compiled.step(restored, a)
        rewards.append(float(out.reward))
    assert rewards == ref_rewards[12:]
    _assert_same_state(restored, ref_state)


def test_restore_without_template(tmp_path):
    compiled = CompiledMicrogrid(Microgrid(_modules(seed=1)), dtype="float64",
                                 device="cpu")
    state = compiled.reset()
    save_state(tmp_path / "sub" / "c2.pt", state)   # the directory is made
    _assert_same_state(restore_state(tmp_path / "sub" / "c2.pt"), state)


def test_save_without_force_refuses_to_overwrite(tmp_path):
    """``save_state(..., force=False)`` on an existing checkpoint raises the
    JAX function's ``ValueError`` (orbax: "Destination ... already exists")
    and leaves the file as it was; ``force=True``, the default, overwrites."""
    from pymgrid_tpu.utils.checkpoint import save_state as jax_save_state

    compiled = CompiledMicrogrid(Microgrid(_modules(seed=1)), dtype="float64",
                                 device="cpu")
    first = compiled.reset()
    second = {**first, "step": first["step"] + 1}
    path = tmp_path / "c.pt"
    save_state(path, first)
    jax_save_state(tmp_path / "jax", {"x": np.zeros(2)})
    with pytest.raises(ValueError, match="already exists") as jax_err:
        jax_save_state(tmp_path / "jax", {"x": np.ones(2)}, force=False)
    with pytest.raises(type(jax_err.value), match="already exists"):
        save_state(path, second, force=False)
    _assert_same_state(restore_state(path), first)
    save_state(path, second, force=True)
    _assert_same_state(restore_state(path), second)
    save_state(tmp_path / "new.pt", second, force=False)   # nothing to overwrite
    _assert_same_state(restore_state(tmp_path / "new.pt"), second)


def test_restore_onto_template_dtypes_and_structure(tmp_path):
    """The template sets each leaf's dtype and device; a checkpoint whose
    nesting differs from the template's is refused."""
    compiled = CompiledMicrogrid(Microgrid(_modules(seed=1)), dtype="float64",
                                 device="cpu")
    state = compiled.reset()
    wide = {**state, "step": state["step"].to(torch.int64),
            "battery_charge": state["battery_charge"].to(torch.float32)}
    save_state(tmp_path / "wide.pt", wide)
    back = compiled.restore_state(tmp_path / "wide.pt")
    assert back["step"].dtype == torch.int32
    assert back["battery_charge"].dtype == torch.float64
    _assert_same_state(back, state)

    save_state(tmp_path / "short.pt", {k: v for k, v in state.items() if k != "genset"})
    with pytest.raises(ValueError, match="keys"):
        compiled.restore_state(tmp_path / "short.pt")


def _discrete_env():
    env = BatchedDiscreteEnv(DiscreteMicrogridEnv.from_microgrid(Microgrid(_modules(2))),
                             batch_size=16, dtype="float64", device="cpu")
    rng = np.random.RandomState(0)
    return env, [rng.randint(0, env.n_actions, size=16) for _ in range(10)]


def _continuous_env():
    env = BatchedContinuousEnv(
        ContinuousMicrogridEnv.from_microgrid(Microgrid(_modules(3))),
        batch_size=8, dtype="float64", device="cpu")
    rng = np.random.RandomState(1)
    return env, [env.sample_actions(rng) for _ in range(10)]


@pytest.mark.parametrize("make_env", [_discrete_env, _continuous_env],
                         ids=["discrete", "continuous"])
def test_batched_env_resume(tmp_path, make_env):
    env, actions = make_env()
    ref, ref_rewards = env.reset(seed=5), []
    for a in actions:
        ref, out = env.step(ref, a)
        ref_rewards.append(out.reward.numpy())

    s = env.reset(seed=5)
    for a in actions[:4]:
        s, _ = env.step(s, a)
    env.save_states(tmp_path / "batch.pt", s)
    restored = env.restore_states(tmp_path / "batch.pt")
    _assert_same_state(restored, s)
    for a, want in zip(actions[4:], ref_rewards[4:]):
        restored, out = env.step(restored, a)
        np.testing.assert_array_equal(out.reward.numpy(), want)
    _assert_same_state(restored, ref)


def test_meshed_ranks_restore_their_own_rows(tmp_path):
    """Two ``BatchMesh`` ranks of one job, in one process: each saves its
    rows of the global batch to the same checkpoint path and restores them.
    Each rank gets its own rows back (scenario 1, 8 replicas, 30 random
    steps, float64), and a restore at another world size is refused."""
    from pymgrid_tpu_torch.parallel import BatchMesh

    cpu = torch.device("cpu")
    envs = [BatchedContinuousEnv(ContinuousMicrogridEnv.from_scenario(1), 8, "float64",
                                 mesh=BatchMesh(2, rank, cpu)) for rank in range(2)]
    rng = np.random.RandomState(0)
    seq = [envs[0].sample_actions(rng) for _ in range(30)]
    states = []
    for env in envs:
        s = env.reset()
        for a in seq:
            s, _ = env.step(s, a)
        states.append(s)
    assert not torch.equal(states[0]["battery_charge"], states[1]["battery_charge"])
    for env, s in zip(envs, states):
        env.save_states(tmp_path / "job", s)
    for env, s in zip(envs, states):
        _assert_same_state(env.restore_states(tmp_path / "job"), s)

    wider = BatchedContinuousEnv(ContinuousMicrogridEnv.from_scenario(1), 8, "float64",
                                 mesh=BatchMesh(4, 0, cpu))
    with pytest.raises(ValueError, match="world size"):
        wider.restore_states(tmp_path / "job")
