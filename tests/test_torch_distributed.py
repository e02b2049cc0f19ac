"""The port's data-parallel layer (``parallel/distributed.py`` and the
``mesh=`` of the batched classes) on the CPU.

The single-process paths of ``tests/test_distributed.py``; the row split of
every meshed class, held bitwise against the unsharded class by running each
rank's share of a 2-rank mesh in this process; and a REAL 2-process gloo job:
this file relaunches itself as the worker (``python
tests/test_torch_distributed.py RANK PORT``), in the pattern of
``tests/test_multiprocess.py``.
"""
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from pymgrid_tpu_torch import Microgrid  # noqa: E402
from pymgrid_tpu_torch.core import prng  # noqa: E402
from pymgrid_tpu_torch.core.rollout import make_marginal_cost_policy  # noqa: E402
from pymgrid_tpu_torch.envs import ContinuousMicrogridEnv, DiscreteMicrogridEnv  # noqa: E402
from pymgrid_tpu_torch.examples.train_rl import build_training  # noqa: E402
from pymgrid_tpu_torch.parallel import (  # noqa: E402
    BatchedContinuousEnv,
    BatchedDiscreteEnv,
    BatchedMicrogrid,
    BatchMesh,
    SuiteRunner,
    make_batch_mesh,
)
from pymgrid_tpu_torch.parallel import distributed as dist  # noqa: E402
from pymgrid_tpu_torch.parallel import suite  # noqa: E402
from pymgrid_tpu_torch.utils.optax_adam import Adam  # noqa: E402

torch.set_num_threads(1)
CPU = torch.device("cpu")


def test_initialize_noop_single_process():
    assert dist.initialize(device="cpu") is False
    assert dist.process_count() == 1
    assert dist.global_batch_mesh("cpu") == BatchMesh(1, 0, CPU)
    assert make_batch_mesh(device="cpu") == make_batch_mesh(1, "cpu") == BatchMesh(1, 0, CPU)
    with pytest.raises(ValueError, match="one process drives one device"):
        make_batch_mesh(2, "cpu")


def test_local_batch_size():
    assert dist.local_batch_size(64) == 64
    mesh = BatchMesh(2, 1, CPU)
    assert mesh.local_size(64) == 32 and mesh.local_rows(64) == slice(32, 64)
    with pytest.raises(ValueError, match="does not divide"):
        mesh.local_size(63)


def test_feed_and_fetch_roundtrip_single_process():
    mesh = make_batch_mesh(device="cpu")
    local = {"a": np.arange(16.0).reshape(16, 1), "b": np.ones((16, 3)),
             "done": np.arange(16) % 3 == 0}
    placed = dist.from_process_local(mesh, local)
    assert all(isinstance(v, torch.Tensor) and v.device == CPU for v in placed.values())
    fetched = dist.fetch(placed)
    for k in local:
        np.testing.assert_array_equal(fetched[k], local[k])
    assert dist.fetch((placed["a"], None), axis=1)[1] is None
    flat = torch.arange(4.0)
    assert dist.all_reduce_mean(flat) is flat and flat.tolist() == [0, 1, 2, 3]


def _ranks(world=2):
    return [BatchMesh(world, r, CPU) for r in range(world)]


def test_meshed_envs_split_rows_bitwise():
    """Each rank of a 2-rank mesh steps its rows of the global batch: the
    ranks' outputs, joined, equal the unsharded env bitwise (step and
    rollout, discrete and continuous)."""
    rng = np.random.RandomState(0)
    for host_cls, cls in ((DiscreteMicrogridEnv, BatchedDiscreteEnv),
                          (ContinuousMicrogridEnv, BatchedContinuousEnv)):
        full = cls(host_cls.from_scenario(1), 6, "float64", device="cpu")
        shards = [cls(host_cls.from_scenario(1), 6, "float64", mesh=m) for m in _ranks()]
        assert [s.local_batch_size for s in shards] == [3, 3]
        if cls is BatchedDiscreteEnv:
            seq = rng.randint(full.n_actions, size=(7, 6))
        else:
            seq = rng.rand(7, 6, full.action_dim)
        _, want = full.rollout(full.reset(), seq)
        parts = [s.rollout(s.reset(), seq) for s in shards]
        for field in ("reward", "done", "obs"):
            got = torch.cat([getattr(out, field) for _, out in parts], dim=1)
            assert torch.equal(got, getattr(want, field)), (cls.__name__, field)
        _, want = full.step(full.reset(), seq[0])
        got = torch.cat([s.step(s.reset(), seq[0])[1].log_row for s in shards])
        assert torch.equal(got, want.log_row), cls.__name__


def test_meshed_batched_microgrid_and_suite_split_rows_bitwise(monkeypatch):
    mg = lambda: Microgrid.from_scenario(0)  # noqa: E731
    full = BatchedMicrogrid(mg(), 4, "float64", device="cpu")
    shards = [BatchedMicrogrid(mg(), 4, "float64", mesh=m) for m in _ranks()]
    policy = make_marginal_cost_policy(full.spec)
    _, (want, _) = full.rollout(policy, 10)
    got = torch.cat([s.rollout(policy, 10)[1][0] for s in shards])
    assert got.shape == (4, 10) and torch.equal(got, want)
    f64 = dict(dtype=torch.float64)
    action = {"battery": torch.linspace(-50, 50, 4, **f64).view(4, 1),
              "genset": torch.zeros(4, 0, 2, **f64),
              "grid": torch.linspace(0, 80, 4, **f64).view(4, 1)}
    want = full.step(full.reset(), action)[1].reward
    got = torch.cat([s.step(s.reset(), action)[1].reward for s in shards])
    assert torch.equal(got, want)

    mgs = lambda: [Microgrid.from_scenario(n) for n in (0, 1, 2, 3)]  # noqa: E731
    full = SuiteRunner(mgs(), 3, "float64", device="cpu")
    shards = [SuiteRunner(mgs(), 3, "float64", mesh=m) for m in _ranks()]
    keys = full.make_keys(0)
    starts = full.draw_initial_steps(keys)
    assert all(torch.equal(s.draw_initial_steps(s.make_keys(0)), starts) for s in shards)
    for collect in (False, True):
        kw = dict(auto_reset=True, collect=collect, randomize_initial_step=True)
        policy = make_marginal_cost_policy(full.spec)
        want = full.rollout_fn(policy, 16, **kw)(full.params, keys)
        gathers = []
        monkeypatch.setattr(suite, "gather_block",
                            lambda *a, _gather=suite.gather_block: gathers.append(1) or _gather(*a))
        got = [s.rollout_fn(policy, 16, **kw)(s.params, s.make_keys(0)) for s in shards]
        monkeypatch.undo()
        # the throughput mode's blocked rollout ran on each rank: 2 blocks of 8
        assert len(gathers) == (0 if collect else 2 * len(shards))
        if collect:
            assert torch.equal(torch.cat([g[1].reward for g in got]), want[1].reward)
            got, want = [g[0] for g in got], want[0]
        assert torch.equal(torch.cat(got), want)


def test_initialize_passes_keyword_arguments_on(monkeypatch):
    """``initialize(..., **kwargs)`` hands its keyword arguments to
    ``init_process_group`` (as the JAX function hands them to
    ``jax.distributed.initialize``); a given ``timeout`` replaces the
    300 s default."""
    import datetime

    calls = []
    monkeypatch.setattr(dist.torch_dist, "is_initialized", lambda: False)
    monkeypatch.setattr(dist.torch_dist, "init_process_group",
                        lambda *args, **kw: calls.append((args, kw)))
    timeout = datetime.timedelta(seconds=42)
    assert dist.initialize("127.0.0.1:1234", 2, 1, device="cpu", timeout=timeout,
                           group_name="g")
    assert dist.initialize("127.0.0.1:1234", 2, 0, device="cpu")
    (args, kw), (_, default) = calls
    assert args == ("gloo",) and kw == dict(init_method="tcp://127.0.0.1:1234", world_size=2,
                                            rank=1, timeout=timeout, group_name="g")
    assert default["timeout"] == datetime.timedelta(seconds=300)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.timeout(300)
def test_two_process_gloo(tmp_path):
    """Two ranks over gloo: the feed/fetch round trip and an all_reduce, a
    meshed ``BatchedDiscreteEnv`` rollout bitwise against one process, a
    checkpoint of the meshed env that gives each rank its own rows back, and
    a 2-rank A2C step, with fed actions and with actions sampled from JAX's
    keys, against the 1-rank full-batch step at rtol 1e-6 (see
    ``_worker``)."""
    port = _free_port()
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, __file__, str(rank), str(port),
                               str(tmp_path / "ckpt")], cwd=REPO,
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
             for rank in range(2)]
    outputs = []
    try:
        for p in procs:
            outputs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, out) in enumerate(zip(procs, outputs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{out}"
        assert f"rank {rank} OK" in out, out


def _worker(rank, port, ckpt_dir):
    assert dist.initialize(f"127.0.0.1:{port}", 2, rank, device="cpu")
    try:
        mesh = dist.global_batch_mesh("cpu")
        assert mesh == BatchMesh(2, rank, CPU) and dist.process_count() == 2
        assert dist.local_batch_size(4) == 2 and dist.initialize(device="cpu") is False

        local = np.arange(4.0).reshape(2, 2) + 10.0 * rank
        placed = dist.from_process_local(mesh, {"x": local, "odd": local % 2 == 1})
        fetched = dist.fetch(placed)
        both = np.concatenate([np.arange(4.0).reshape(2, 2), np.arange(4.0).reshape(2, 2) + 10])
        np.testing.assert_array_equal(fetched["x"], both)
        np.testing.assert_array_equal(fetched["odd"], both % 2 == 1)
        np.testing.assert_array_equal(dist.fetch(placed["x"].T.contiguous(), axis=1), both.T)
        total = dist.all_reduce_mean(placed["x"].sum().view(1)) * 2
        assert total.item() == both.sum()

        # a meshed env rollout equals a single-process one bitwise
        B, T = 8, 12
        host = DiscreteMicrogridEnv.from_scenario(0)
        seq = np.random.RandomState(0).randint(host.action_space.n, size=(T, B))
        meshed = BatchedDiscreteEnv(host, B, "float32", mesh=mesh)
        _, outs = meshed.rollout(meshed.reset(), seq)
        plain = BatchedDiscreteEnv(host, B, "float32", device="cpu")
        _, want = plain.rollout(plain.reset(), seq)
        for field in ("reward", "done", "obs"):
            np.testing.assert_array_equal(dist.fetch(getattr(outs, field), axis=1),
                                          getattr(want, field).numpy(), err_msg=field)

        # both ranks checkpoint to one path; each restores its own rows
        states = meshed.reset()
        for t in range(T):
            states, _ = meshed.step(states, seq[t])
        meshed.save_states(ckpt_dir, states)
        torch.distributed.barrier()
        back = meshed.restore_states(ckpt_dir)
        for leaf, want_leaf in ((back["battery_charge"], states["battery_charge"]),
                                (back["step"], states["step"])):
            assert leaf.dtype == want_leaf.dtype and torch.equal(leaf, want_leaf)
        np.testing.assert_array_equal(dist.fetch(back["battery_charge"]),
                                      dist.fetch(states["battery_charge"]))

        # a 2-rank A2C step equals the 1-rank full-batch step, with fed
        # actions and with actions sampled from each replica's own keys
        kw = dict(scenario=0, batch=B, rollout_len=6, device="cpu")
        run2, run1 = build_training(mesh=mesh, **kw), build_training(**kw)
        actions = np.random.RandomState(1).randint(run1.n_actions, size=(6, B))
        for feed in ({"actions": actions}, {"seed": 1}):
            results = []
            for run in (run2, run1):
                theta = run.init_theta(seed=0)
                adam = Adam(theta.parameters(), lr=run.lr)
                if "seed" in feed:
                    step_kw = {"keys": prng.fold_in(run.rollout_keys(feed["seed"]), 0)}
                else:
                    step_kw = feed
                *_, loss, mean_ret = run.train_step(theta, adam, *run.init_envs(), **step_kw)
                results.append((loss.item(), mean_ret.item(),
                                torch.cat([p.detach().reshape(-1) for p in theta.parameters()])))
            (loss2, ret2, p2), (loss1, ret1, p1) = results
            np.testing.assert_allclose([loss2, ret2], [loss1, ret1], rtol=1e-6, err_msg=str(feed))
            # an entry near 0 (a bias after one step) is held to 1e-6 of the step
            np.testing.assert_allclose(p2.numpy(), p1.numpy(), rtol=1e-6, atol=1e-6 * run1.lr,
                                       err_msg=str(feed))
        print(f"rank {rank} OK", flush=True)
    finally:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
