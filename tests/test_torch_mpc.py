"""The port's ``ProblemTemplate`` and ``BatchedMPC`` against the JAX
package's (CPU, float64).

The assembly (``assemble``, ``apply_genset_pattern``, the candidate
patterns, ``extract_action``, ``rebalance_first_step``) is elementwise and
is compared bitwise.  Solves are compared at tolerances: the refiner's
pattern exactly and its objective at rel 1e-8; closed loops at the bars the
JAX package holds its two batched paths to (``tests/test_mpc_suite.py``):
per-step rewards within atol 5e-4 scaled by the largest reward, total cost
within rtol 1e-4.  Scenario 1's closed loop is in
``tests/test_torch_mpc_genset.py``.
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

import pymgrid_tpu
import pymgrid_tpu_torch
from pymgrid_tpu.algos import ModelPredictiveControl
from pymgrid_tpu.algos import mpc_jax
from pymgrid_tpu.core.engine import make_reset_fn as jax_reset_fn
from pymgrid_tpu_torch.algos import BatchedMPC, ProblemTemplate
from pymgrid_tpu_torch.algos.mpc_batched import series_window
from pymgrid_tpu_torch.core.engine import make_reset_fn
from pymgrid_tpu_torch.core.params import state_to_torch

torch.set_num_threads(1)
warnings.filterwarnings("ignore")

T_CASES = (0, 1000, 5000, 8755)   # the last window is clamped at the series end
CHARGE_FRACTIONS = (0.1, 0.5, 0.9, 0.35)


def _mg(n):
    """Scenario ``n`` from the port's host layer."""
    return pymgrid_tpu_torch.Microgrid.from_scenario(n)


def _jmg(n):
    """Scenario ``n`` from the JAX package's host layer."""
    return pymgrid_tpu.Microgrid.from_scenario(n)


def assert_closed_loop_close(got, want, what):
    """The JAX package's bars between its batched paths."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    scale = max(1.0, np.abs(want).max())
    np.testing.assert_allclose(got / scale, want / scale, atol=5e-4, err_msg=what)
    np.testing.assert_allclose(-got.sum(axis=0), -want.sum(axis=0), rtol=1e-4, err_msg=what)


def _host_cost(n, steps):
    log = ModelPredictiveControl(_jmg(n)).run(max_steps=steps)
    return -log[("balance", 0, "reward")].sum()


# ------------------------------------------------------------ the template
def _templates(n):
    """The JAX and port templates of scenario ``n``, and the same states in
    both: steps ``T_CASES``, charges at ``CHARGE_FRACTIONS`` of capacity."""
    jt = mpc_jax.ProblemTemplate(_jmg(n), dtype=np.float64)
    tt = ProblemTemplate(_mg(n), dtype="float64", device="cpu")
    cap = float(np.asarray(jt.params["battery"]["max_capacity"])[jt.battery_ref.slot])
    charges = [f * cap for f in CHARGE_FRACTIONS]
    base = jax.jit(jax_reset_fn(jt.spec))(jt.params, jax.random.PRNGKey(0))
    jstates = []
    for t, q in zip(T_CASES, charges):
        bc = np.asarray(base["battery_charge"]).copy()
        bc[jt.battery_ref.slot] = q
        jstates.append({**base, "step": jnp.int32(t), "battery_charge": jnp.asarray(bc)})
    B = len(T_CASES)
    tstates = make_reset_fn(tt.spec)(tt.params, torch.zeros(1, B, dtype=torch.int32))
    tstates["step"] = torch.tensor([T_CASES], dtype=torch.int32)
    tstates["battery_charge"] = torch.stack(
        [torch.as_tensor(np.array(s["battery_charge"])) for s in jstates])[None]
    return n, jt, tt, jstates, tstates


@pytest.fixture(scope="module", params=[0, 1, 2], ids=lambda n: f"scenario{n}")
def templates(request):
    """Scenario 0 (grid), 1 (genset and grid), 2 (genset, no grid)."""
    return _templates(request.param)


@pytest.fixture(scope="module", params=[1, 2], ids=lambda n: f"scenario{n}")
def genset_templates(request):
    return _templates(request.param)


def _jax_problem(tpl, state):
    """``BatchedMPC``'s per-replica build_problem (mpc_jax.py)."""
    H = tpl.horizon
    t = state["step"]
    zero = jnp.zeros((), t.dtype)
    load = -lax.dynamic_slice(tpl.params["load"]["ts"][tpl.load_ref.slot], (t, zero), (H, 1))[:, 0]
    pv = lax.dynamic_slice(tpl.params["renewable"]["ts"][tpl.pv_ref.slot], (t, zero), (H, 1))[:, 0]
    grid = tpl.grid_windows(tpl.params, t)
    cbh = tpl.assemble(tpl.params, load, pv, grid, jnp.ones(H, np.float64),
                       tpl.soc_0(tpl.params, state))
    return cbh, (load[0], pv[0], grid["grid_status_real"][0])


def _port_problem(tpl, states):
    H, params, t = tpl.horizon, tpl.params, states["step"]
    load = -series_window(params, "load", tpl.load_ref.slot, t, H)
    pv = series_window(params, "renewable", tpl.pv_ref.slot, t, H)
    grid = tpl.grid_windows(params, t)
    cbh = tpl.assemble(params, load, pv, grid, torch.ones(H, dtype=torch.float64),
                       tpl.soc_0(params, states))
    return cbh, (load[..., 0].T, pv[..., 0].T, grid["grid_status_real"][..., 0].T)


def _stack_np(items):
    return np.stack([np.asarray(a) for a in items])


def test_assemble_bitwise(templates):
    _, jt, tt, jstates, tstates = templates
    want = [_jax_problem(jt, s)[0] for s in jstates]
    got, _ = _port_problem(tt, tstates)
    for i, name in enumerate("cbh"):
        assert got[i].shape[:2] == (len(T_CASES), 1), name
        np.testing.assert_array_equal(got[i][:, 0].numpy(), _stack_np(w[i] for w in want),
                                      err_msg=name)


def _tie_heavy_relaxations(tpl, H, rng):
    """Genset productions with ties: all-integral rows (every score -1),
    repeated fractional values, values at the thresholds."""
    p_min = float(tpl.host_mpc.p_genset_min)
    p_max = float(tpl.host_mpc.p_genset_max)
    rows = [np.zeros(H), np.full(H, p_max)]
    r = rng.uniform(0, p_max, H)
    r[::3] = 0.25 * p_min
    r[1::5] = 0.75 * p_min
    rows.append(r)
    r = np.where(rng.rand(H) < 0.5, 0.0, p_max)
    r[[2, 7, 11]] = 0.5 * p_min
    rows.append(r)
    rows.append(rng.uniform(0, p_min, H))
    return np.stack(rows)


@pytest.mark.parametrize("enum_bits", [2, 5])
def test_candidate_patterns_and_apply_bitwise(genset_templates, enum_bits):
    n, jt, tt, jstates, tstates = genset_templates
    H = jt.horizon
    p_relax = _tie_heavy_relaxations(jt, H, np.random.RandomState(enum_bits))
    want = np.asarray(jax.vmap(jt.make_candidate_patterns(enum_bits))(p_relax))  # (R, E, H)
    got = tt.make_candidate_patterns(enum_bits)(torch.as_tensor(p_relax)[:, None])  # (E, R, 1, H)
    np.testing.assert_array_equal(got[:, :, 0].permute(1, 0, 2).numpy(), want)

    (_, _, h_port), _ = _port_problem(tt, tstates)
    u = want[:, : 2 ** min(enum_bits, H)][: len(T_CASES)]                        # (B, E, H)
    got_h = tt.apply_genset_pattern(h_port[None], torch.as_tensor(u).permute(1, 0, 2)[:, :, None])
    want_h = np.asarray(jax.vmap(jax.vmap(jt.apply_genset_pattern, (None, 0)), (0, 0))(
        _stack_np(_jax_problem(jt, s)[0][2] for s in jstates), u))
    np.testing.assert_array_equal(got_h[:, :, 0].permute(1, 0, 2).numpy(), want_h)


def test_extract_action_and_rebalance_bitwise(templates):
    """Random first blocks (perturbed so the balance repair clips grid,
    genset and battery) through both packages' extraction and repair."""
    n, jt, tt, jstates, tstates = templates
    rng = np.random.RandomState(n)
    n0 = jt.K_eq_np.shape[1]
    B = len(T_CASES)
    x = np.abs(rng.randn(B, n0)) * jt.x_scale_np * rng.choice([0.0, 0.3, 3.0], (B, n0))
    u = (rng.rand(B, jt.horizon) < 0.5).astype(np.float64)

    want_a = [jt.extract_action(jnp.asarray(x[i]), jnp.asarray(u[i]) if jt.has_genset else None)
              for i in range(B)]
    got_a = tt.extract_action(torch.as_tensor(x)[:, None],
                              torch.as_tensor(u)[:, None] if tt.has_genset else None)
    for k in ("battery", "genset", "grid"):
        np.testing.assert_array_equal(got_a[k][0].numpy(), _stack_np(a[k] for a in want_a),
                                      err_msg=k)

    _, (load0, pv0, status0) = _port_problem(tt, tstates)
    repaired = tt.rebalance_first_step(tt.params, tstates, got_a, load0, pv0, status0)
    for i, s in enumerate(jstates):
        _, step0 = _jax_problem(jt, s)
        want = jt.rebalance_first_step(jt.params, s, want_a[i], *step0)
        for k in ("battery", "genset", "grid"):
            np.testing.assert_array_equal(repaired[k][0, i].numpy(), np.asarray(want[k]),
                                          err_msg=f"{k}, state {i}")


def test_genset_refiner_matches_jax_and_is_chunk_invariant(genset_templates):
    """Genset horizon MILPs at several states: the port's refiner picks
    JAX's pattern, objective within rel 1e-8; chunked (4 patterns per solve)
    and one-shot (16) enumeration agree."""
    n, jt, tt, jstates, tstates = genset_templates
    probs = [_jax_problem(jt, s)[0] for s in jstates]
    c, b, h = (_stack_np(p[i] for p in probs) for i in range(3))
    _, want_u, want_obj, _ = jt.make_genset_refiner(enum_bits=4, enum_chunk=16)(c, b, h)
    (tc, tb, th), _ = _port_problem(tt, tstates)
    x1, u1, obj1, res1 = tt.make_genset_refiner(enum_bits=4, enum_chunk=16)(tc, tb, th)
    x2, u2, obj2, res2 = tt.make_genset_refiner(enum_bits=4, enum_chunk=4)(tc, tb, th)
    np.testing.assert_array_equal(u1[:, 0].numpy(), np.asarray(want_u))
    np.testing.assert_allclose(obj1[:, 0].numpy(), np.asarray(want_obj), rtol=1e-8)
    np.testing.assert_array_equal(u1.numpy(), u2.numpy())
    np.testing.assert_allclose(obj1.numpy(), obj2.numpy(), rtol=1e-10)
    np.testing.assert_allclose(x1.numpy(), x2.numpy(), rtol=1e-8, atol=1e-10)
    assert torch.isfinite(res1).all() and float(res1.max()) < 1e-5


# ---------------------------------------------------------- the closed loop
@pytest.fixture(scope="module")
def scenario0_runs():
    steps = 24
    jb = mpc_jax.BatchedMPC(_jmg(0), batch_size=1, dtype=np.float64)
    want, _ = jb.run(steps)
    tb = BatchedMPC(_mg(0), batch_size=3, dtype="float64", device="cpu")
    got, states = tb.run(steps)
    return want, got, states, tb, _host_cost(0, steps)


def test_batched_mpc_scenario0_matches_jax_and_host(scenario0_runs):
    want, got, states, tb, host_cost = scenario0_runs
    assert got.shape == (24, 3) and got.dtype == np.float64
    assert_closed_loop_close(got[:, :1], want, "scenario 0 vs JAX BatchedMPC")
    assert abs(-got[:, 0].sum() - host_cost) / abs(host_cost) < 1e-4
    # replicas are deterministic copies
    np.testing.assert_array_equal(got[:, 0], got[:, 1])
    np.testing.assert_array_equal(got[:, 0], got[:, 2])
    assert tb.fallback_count == 0
    assert states["step"].tolist() == [24, 24, 24]
    assert states["battery_charge"].shape == (3, 1)


def test_run_scanned_matches_run_bitwise():
    tb = BatchedMPC(_mg(0), batch_size=2, dtype="float64", device="cpu", host_fallback=False)
    r_loop, s_loop = tb.run(10)
    r_scan, s_scan = tb.run_scanned(10)
    r_chunked, s_chunked = tb.run_scanned(10, chunk=4)
    np.testing.assert_array_equal(r_scan, r_loop)
    np.testing.assert_array_equal(r_chunked, r_loop)
    for s in (s_scan, s_chunked):
        assert torch.equal(s["battery_charge"], s_loop["battery_charge"])
        assert torch.equal(s["step"], s_loop["step"])


def test_host_fallback_on_starved_iterates():
    """Two IPM iterations leave residuals above tolerance: every replica
    falls back to host HiGHS on every step.  HiGHS gets the same LP data
    as in the JAX package (bitwise assembly), so the trajectory equals the
    JAX starved run's; against the converged run it holds the JAX test's
    bars (``test_batched_mpc_host_fallback_on_bad_iterates``)."""
    good, _ = BatchedMPC(_mg(0), batch_size=1, dtype="float64", device="cpu").run(5)
    starved = BatchedMPC(_mg(0), batch_size=1, iters=2, dtype="float64", device="cpu",
                         residual_tol=1e-5)
    r_starved, _ = starved.run(5)
    assert starved.fallback_count == 5
    jax_starved = mpc_jax.BatchedMPC(_jmg(0), batch_size=1, dtype=np.float64, iters=2,
                                     residual_tol=1e-5)
    r_jax, _ = jax_starved.run(5)
    assert jax_starved.fallback_count == starved.fallback_count
    np.testing.assert_array_equal(r_starved, r_jax)
    np.testing.assert_allclose(r_starved[:, 0], good[:, 0], rtol=1e-3)
    assert abs(r_starved.sum() - good.sum()) / abs(good.sum()) < 1e-4


def test_jax_state_continues_in_the_port():
    """A JAX ``BatchedMPC`` state after 5 steps, carried over with
    ``state_to_torch``, continues in the port to JAX's own rewards."""
    jb = mpc_jax.BatchedMPC(_jmg(0), batch_size=2, dtype=np.float64, host_fallback=False)
    states = jb.reset()
    for _ in range(5):
        states, _, _ = jb.step(states)
    handed = state_to_torch(jax.tree.map(np.asarray, states), "cpu", "float64")
    want, got = [], []
    tb = BatchedMPC(_mg(0), batch_size=2, dtype="float64", device="cpu", host_fallback=False)
    for _ in range(5):
        states, out, _ = jb.step(states)
        want.append(np.asarray(out.reward))
        handed, out, info = tb.step(handed)
        got.append(out.reward.numpy())
        assert info["residual"].shape == (2,)
    assert_closed_loop_close(np.stack(got), np.stack(want), "handed-over state")
    assert handed["step"].tolist() == [10, 10]


def test_constructors_need_dtype_and_device():
    """``dtype`` has no default; ``device`` defaults to the card and raises
    where there is none, with no fallback to the CPU."""
    with pytest.raises(TypeError):
        BatchedMPC(_mg(0), batch_size=1)
    if torch.cuda.is_available():
        assert ProblemTemplate(_mg(0), dtype="float64").device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ProblemTemplate(_mg(0), dtype="float64")
