"""The port's batched LP solvers against the JAX solvers and HiGHS (CPU,
float64).

Bars: the port's objective within rel 1e-7 of the JAX solver's on the same
problems (the same algorithm, reductions and LAPACK in another order), and
the JAX tests' bars against HiGHS (``tests/test_lp_mpc.py``): rel 1e-5 for
the interior-point solvers, 1e-3 for PDHG.
"""
import jax  # noqa: F401  (conftest pins CPU and float64)
import numpy as np
import pytest
import torch
from scipy.optimize import linprog

from pymgrid_tpu.core import lp as jlp
from pymgrid_tpu_torch import Microgrid
from pymgrid_tpu_torch.algos import ModelPredictiveControl
from pymgrid_tpu_torch.core import lp as tlp

torch.set_num_threads(1)


def _random_lps(B=6, n=30, me=8, mi=20, seed=0):
    rng = np.random.RandomState(seed)
    K_eq = rng.randn(me, n)
    K_in = rng.randn(mi, n)
    x_feas = np.abs(rng.randn(B, n))
    b = x_feas @ K_eq.T
    h = x_feas @ K_in.T + np.abs(rng.randn(B, mi))
    c = np.abs(rng.randn(B, n))
    return K_eq, K_in, c, b, h


def _highs(c, K_eq, b, K_in, h):
    res = linprog(c, A_ub=K_in, b_ub=h, A_eq=K_eq, b_eq=b, bounds=(0, None),
                  method="highs")
    assert res.success
    return res.fun


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b) / np.maximum(1.0, np.abs(b))


def _objective(info):
    return info["objective"].numpy()


@pytest.fixture(scope="module")
def mpc_problem():
    """Scenario 0's first horizon LP, as the port's host MPC builds it."""
    host = ModelPredictiveControl(Microgrid.from_scenario(0))
    host.microgrid.reset()
    host._set_parameters(*host._get_modular_state_values())
    K_eq = np.asarray(host._A_eq.todense())
    K_in = np.asarray(host._C_ub.todense())
    cbh = (host._c[None], host._b_eq[None], host._b_ub[None])
    return K_eq, K_in, cbh, _highs(host._c, K_eq, host._b_eq, K_in, host._b_ub)


@pytest.mark.parametrize("solve_mode", ["triangular", "inverse"])
def test_ipm_matches_jax_and_highs_random(solve_mode):
    K_eq, K_in, c, b, h = _random_lps()
    _, want = jlp.make_batched_ipm_solver(K_eq, K_in, iters=30, dtype=np.float64,
                                          solve_mode=solve_mode)(c, b, h)
    x, info = tlp.make_batched_ipm_solver(K_eq, K_in, iters=30, dtype=np.float64,
                                          solve_mode=solve_mode, device="cpu")(c, b, h)
    assert x.shape == (6, 30) and x.dtype == torch.float64
    assert set(info) == {"residual", "objective", "gap", "rejected"}
    assert _rel(_objective(info), want["objective"]).max() <= 1e-7
    highs = [_highs(c[i], K_eq, b[i], K_in, h[i]) for i in range(len(c))]
    assert _rel(_objective(info), highs).max() < 1e-5
    assert int(info["rejected"].sum()) == 0


@pytest.mark.parametrize("solver", ["ipm", "box"])
def test_heterogeneous_stack_matches_jax_and_highs(solver):
    """Two matrices of one structure stacked ``(S=2, ...)``: problem
    ``i*S + s`` uses matrix ``s``.  The box solver gets random single-variable
    rows (upper bounds on every variable, lower bounds on some)."""
    rng = np.random.RandomState(7)
    S, k, n, me = 2, 3, 12, 4
    K_eq = rng.randn(S, me, n)
    if solver == "box":
        rows = [np.eye(n), -np.eye(n)[:5]]
        K_in = np.stack([np.concatenate(rows) * rng.uniform(0.5, 2.0, (n + 5, 1))
                         for _ in range(S)])
    else:
        K_in = rng.randn(S, 9, n)
    mi = K_in.shape[1]
    x_feas = np.abs(rng.randn(k, S, n)) + 0.1
    b = np.einsum("smn,ksn->ksm", K_eq, x_feas).reshape(k * S, me)
    h = (np.einsum("smn,ksn->ksm", K_in, x_feas) + np.abs(rng.randn(k, S, mi))).reshape(k * S, mi)
    c = rng.randn(k * S, n) if solver == "box" else np.abs(rng.randn(k * S, n))
    x_scale = rng.uniform(0.5, 3.0, (S, n))
    factory = {"ipm": "make_batched_ipm_solver", "box": "make_batched_box_ipm_solver"}[solver]
    kw = dict(iters=35, dtype=np.float64, x_scale=x_scale)
    _, want = getattr(jlp, factory)(K_eq, K_in, **kw)(c, b, h)
    _, info = getattr(tlp, factory)(K_eq, K_in, device="cpu", **kw)(c, b, h)
    assert _rel(_objective(info), want["objective"]).max() <= 1e-7
    highs = [_highs(c[i], K_eq[i % S], b[i], K_in[i % S], h[i]) for i in range(k * S)]
    assert _rel(_objective(info), highs).max() < 1e-5
    with pytest.raises(ValueError, match="multiple"):
        getattr(tlp, factory)(K_eq, K_in, device="cpu", **kw)(c[:5], b[:5], h[:5])


def test_pdhg_matches_jax_and_highs_random():
    K_eq, K_in, c, b, h = _random_lps(seed=3)
    kw = dict(iters=20000, restart_every=20000, dtype=np.float64)
    _, want = jlp.make_batched_lp_solver(K_eq, K_in, **kw)(c, b, h)
    x, info = tlp.make_batched_lp_solver(K_eq, K_in, device="cpu", **kw)(c, b, h)
    assert set(info) == {"residual", "objective"}
    assert _rel(_objective(info), want["objective"]).max() <= 1e-7
    highs = [_highs(c[i], K_eq, b[i], K_in, h[i]) for i in range(len(c))]
    assert _rel(_objective(info), highs).max() < 1e-3


@pytest.mark.parametrize("solver", ["ipm", "box", "pdhg"])
def test_mpc_problem_matches_jax(mpc_problem, solver):
    """Scenario 0's first horizon problem through all three solvers; the
    interior-point solvers also against HiGHS at rel 1e-4, the bar of
    ``tests/test_lp_mpc.py::test_ipm_on_mpc_problem`` (PDHG's default budget
    is first-order accurate only, so it is held to the JAX PDHG)."""
    K_eq, K_in, cbh, highs = mpc_problem
    if solver == "pdhg":
        kw = dict(dtype=np.float64)
        jf, tf = jlp.make_batched_lp_solver, tlp.make_batched_lp_solver
    else:
        kw = dict(iters=35, dtype=np.float64)
        jf, tf = {"ipm": (jlp.make_batched_ipm_solver, tlp.make_batched_ipm_solver),
                  "box": (jlp.make_batched_box_ipm_solver,
                          tlp.make_batched_box_ipm_solver)}[solver]
    _, want = jf(K_eq, K_in, **kw)(*cbh)
    _, info = tf(K_eq, K_in, device="cpu", **kw)(*cbh)
    assert _rel(_objective(info), want["objective"]).max() <= 1e-7
    if solver != "pdhg":
        assert _rel(_objective(info), [highs]).max() < 1e-4


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_box_ipm_pins_degenerate_variables(dtype):
    """``tests/test_lp_mpc.py::test_box_ipm_pins_degenerate_variables``'
    case: a collapsed box (x0 <= 0) pins x0 exactly at 0 and x1 carries the
    equality; the port matches the JAX solver."""
    K_eq = np.array([[1.0, 1.0]])
    K_in = np.array([[1.0, 0.0], [0.0, 1.0]])
    c = np.array([[1.0, 2.0], [1.0, 2.0]], dtype)
    b = np.array([[10.0], [10.0]], dtype)
    h = np.array([[20.0, 20.0], [0.0, 20.0]], dtype)
    kw = dict(iters=40, dtype=dtype, newton_refine=1)
    xj, want = jlp.make_batched_box_ipm_solver(K_eq, K_in, **kw)(c, b, h)
    x, info = tlp.make_batched_box_ipm_solver(K_eq, K_in, device="cpu", **kw)(c, b, h)
    assert x.dtype == torch.from_numpy(np.zeros(1, dtype)).dtype
    x = x.double().numpy()
    np.testing.assert_allclose(x[0], [10.0, 0.0], atol=1e-3)
    assert x[1, 0] == 0.0
    np.testing.assert_allclose(x[1, 1], 10.0, atol=1e-3)
    assert float(info["residual"][1]) < 1e-3
    np.testing.assert_allclose(_objective(info), [10.0, 20.0], rtol=1e-3)
    tol = 1e-7 if dtype == np.float64 else 1e-5
    np.testing.assert_allclose(x, np.asarray(xj, np.float64), rtol=tol, atol=tol)


def test_box_ipm_all_pinned_is_guarded():
    """Every variable pinned: ``mu`` is 0.  The JAX solver's centering ratio
    is NaN there (its steps are all rejected); the port's guard makes it 0,
    so no iterate is non-finite, and both return the pinned point."""
    K_eq = np.array([[1.0, 1.0]])
    K_in = np.array([[1.0, 0.0], [0.0, 1.0], [-1.0, 0.0], [0.0, -1.0]])
    c = np.array([[1.0, 2.0], [3.0, -1.0]])
    b = np.array([[5.0], [0.0]])
    h = np.array([[2.0, 3.0, -2.0, -3.0], [0.0, 0.0, 0.0, 0.0]])   # x = (2, 3), x = (0, 0)
    xj, want = jlp.make_batched_box_ipm_solver(K_eq, K_in, iters=10, dtype=np.float64)(c, b, h)
    x, info = tlp.make_batched_box_ipm_solver(K_eq, K_in, iters=10, dtype=np.float64,
                                              device="cpu")(c, b, h)
    np.testing.assert_array_equal(x.numpy(), np.asarray(xj))
    np.testing.assert_array_equal(x.numpy(), [[2.0, 3.0], [0.0, 0.0]])
    np.testing.assert_array_equal(_objective(info), np.asarray(want["objective"]))
    assert info["rejected"].tolist() == [0, 0]
    assert torch.isfinite(info["gap"]).all()


@pytest.mark.parametrize("solver", ["ipm", "box"])
def test_cholesky_failure_keeps_last_finite_iterate(monkeypatch, solver):
    """A factorization that fails (``info != 0``) from iteration 12 on for
    problem 0 only: its steps are rejected without raising, so problem 0
    keeps the best iterate of the first 12 iterations (the JAX solver run
    for 12 iterations), while the other problems run on unaffected."""
    K_eq, K_in, c, b, h = _random_lps(B=3)
    if solver == "box":
        K_in = np.eye(30)
        h = np.full((3, 30), 5.0)
        c = c - 0.5
    factory = {"ipm": "make_batched_ipm_solver", "box": "make_batched_box_ipm_solver"}[solver]
    kw = dict(dtype=np.float64)
    _, full = getattr(tlp, factory)(K_eq, K_in, iters=30, device="cpu", **kw)(c, b, h)
    _, short = getattr(jlp, factory)(K_eq, K_in, iters=12, **kw)(c, b, h)

    real = torch.linalg.cholesky_ex
    calls = {"n": 0}

    def failing(M):
        L, info = real(M)
        calls["n"] += 1
        if calls["n"] > 12:
            info = info.clone()
            info.view(-1)[0] = 1
        return L, info

    monkeypatch.setattr(torch.linalg, "cholesky_ex", failing)
    x, info = getattr(tlp, factory)(K_eq, K_in, iters=30, device="cpu", **kw)(c, b, h)
    assert calls["n"] == 30
    assert torch.isfinite(x).all()
    assert info["rejected"].tolist() == [18, 0, 0]
    assert _rel(_objective(info)[0], np.asarray(short["objective"])[0]) <= 1e-7
    np.testing.assert_array_equal(_objective(info)[1:], _objective(full)[1:])


def test_matmul_precision_variants():
    """The argument is accepted, changes nothing on the CPU, and is
    checked."""
    K_eq, K_in, c, b, h = _random_lps()
    base = tlp.make_batched_ipm_solver(K_eq, K_in, iters=30, device="cpu")(c, b, h)[1]
    for prec in ("tensorfloat32", "bfloat16"):
        _, info = tlp.make_batched_ipm_solver(K_eq, K_in, iters=30, device="cpu",
                                              matmul_precision=prec)(c, b, h)
        np.testing.assert_array_equal(_objective(info), _objective(base))
    with pytest.raises(ValueError, match="matmul_precision"):
        tlp.make_batched_ipm_solver(K_eq, K_in, iters=2, device="cpu",
                                    matmul_precision="highest")(c, b, h)


def test_solvers_need_an_explicit_device():
    """The solvers run on the card unless given ``device="cpu"``: with no
    device given and no card, they raise instead of falling back to the CPU."""
    K_eq, K_in, *_ = _random_lps()
    for factory in (tlp.make_batched_ipm_solver, tlp.make_batched_box_ipm_solver,
                    tlp.make_batched_lp_solver):
        if torch.cuda.is_available():
            factory(K_eq, np.eye(30))
        else:
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                factory(K_eq, np.eye(30))


@pytest.mark.parametrize("device, dtype, me, n0, runs", [
    ("cuda", torch.float32, 48, 192, True),      # the MPC cell's solve shapes
    ("cuda", torch.float32, 1, 2, True),
    ("cpu", torch.float32, 48, 192, False),
    ("cuda", torch.float64, 48, 192, False),
    ("cuda", torch.float32, 128, 400, False),    # the block's layout past 227 KB
    ("cuda", torch.float32, 170, 1, False),      # M and its factor alone past 227 KB
])
def test_box_kernel_dispatch_by_shape(device, dtype, me, n0, runs):
    """The box IPM takes the hand-written kernel by what it observes: a CUDA
    device, float32, and a problem whose shared-memory layout fits one block;
    the op-by-op loop otherwise.  Decided from shapes alone, with no card."""
    from pymgrid_tpu_torch.ops import box_ipm

    assert tlp._box_kernel_runs(torch.device(device), dtype, me, n0) is runs
    if device == "cuda" and dtype == torch.float32:
        assert box_ipm.fits(me, n0) is runs
        assert (box_ipm.smem_bytes(me, n0) <= box_ipm.SMEM_LIMIT) is runs


def test_box_kernel_layout_of_the_cell():
    """The cell's 48 x 192 problem takes 113,728 bytes of shared memory a
    block (A with rows padded to 193, A' with rows padded to 52, M and its
    factor padded to 49, 21 vectors of 192 and 8 of 48), so two blocks fit
    an SM's 227 KB: the pattern chunk's 200 problems run at once."""
    from pymgrid_tpu_torch.ops import box_ipm

    floats = 48 * 193 + 192 * 52 + 2 * 48 * 49 + 21 * 192 + 8 * 48 + 64
    assert box_ipm.smem_bytes(48, 192) == 4 * floats == 113_728
    assert 2 * box_ipm.smem_bytes(48, 192) <= box_ipm.SMEM_LIMIT


def test_box_kernel_counter_silent_on_the_cpu(tmp_path):
    """``pymgrid.lp.kernel_solves`` counts solves the kernel ran: none on the
    CPU, where the box IPM's problems and iterations are still counted."""
    from pymgrid_tpu_torch.utils.profiling import span_totals, trace

    K_eq, _, c, b, _ = _random_lps(B=3)
    solve = tlp.make_batched_box_ipm_solver(K_eq, np.eye(30), iters=5, dtype=np.float32,
                                            device="cpu")
    with trace(str(tmp_path), device="cpu"):
        solve(c, b, np.full((3, 30), 5.0))
    assert span_totals()["counters"] == {"pymgrid.lp.problems": 3,
                                         "pymgrid.lp.iterations": 5}
