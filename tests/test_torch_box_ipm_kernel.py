"""The box IPM's hand-written CUDA kernel (``csrc/box_ipm.cu``) against the
op-by-op solve it replaces, on the card.

The LPs are the ones ``SuiteMPC`` solves in the benchmark's planner cell: the
25 pymgrid25 scenarios at the cell's settings, the relaxation (25 problems,
35 iterations), the pattern chunk (200, 35) and the final re-solve (25, 60
iterations, 2 refinements) of seeded hours.  Their exact optima come from
HiGHS; the kernel is held to the op path with limits set from the op path's
own distance to them.  Then the edge cases (a pinned box, every variable
pinned, a factorization that fails), determinism and the counter.  They skip
without a card; on a machine with one, run ``python -m pytest
tests/test_torch_box_ipm_kernel.py -m cuda``.  This file imports nothing of
JAX or the JAX package."""
import warnings

import numpy as np
import pytest
import torch
from scipy.optimize import linprog

from pymgrid_tpu_torch import Microgrid
from pymgrid_tpu_torch.algos import SuiteMPC
from pymgrid_tpu_torch.algos import mpc_suite
from pymgrid_tpu_torch.core import lp
from pymgrid_tpu_torch.utils.profiling import span_totals, trace

pytestmark = pytest.mark.cuda

torch.set_num_threads(1)
warnings.filterwarnings("ignore")

CELL = dict(dtype="float32", solver_kind="box", newton_refine=2, matmul_precision="float32",
            enum_bits=3, enum_chunk=16, enum_iters=35)
SHAPES = ("relaxation", "chunk", "final")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _op_path(monkeypatch, make):
    """``make()`` built with the op-by-op loop: its twin runs the kernel."""
    with monkeypatch.context() as patch:
        patch.setattr(lp, "_box_kernel_runs", lambda *args: False)
        return make()


@pytest.fixture(scope="module")
def cell_solves():
    """The planner cell's solver arguments and the ``(c, b, h)`` of each of
    its three solve shapes over 2 hours from seeded start hours."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    made = []
    factory = mpc_suite.make_batched_box_ipm_solver

    def recording(K_eq, K_in, **kw):
        solve = factory(K_eq, K_in, **kw)
        entry = {"args": (K_eq, K_in), "kw": kw, "calls": []}
        made.append(entry)

        def run(c, b, h):
            entry["calls"].append(tuple(v.clone() for v in (c, b, h)))
            return solve(c, b, h)
        return run

    mp = pytest.MonkeyPatch()
    mp.setattr(mpc_suite, "make_batched_box_ipm_solver", recording)
    try:
        mpc = SuiteMPC([Microgrid.from_scenario(n) for n in range(25)], 60,
                       device=torch.device("cuda"), **CELL)
        starts = np.random.default_rng(2**31 + 11).integers(0, mpc.n_steps_year - 48, size=25)
        state = mpc.reset(3, starts=starts)
        for _ in range(2):
            state, _ = mpc.act(state, mpc.plan(state))
    finally:
        mp.undo()
    final, enum = made          # SuiteMPC builds the full solver, then the enumeration's
    relax = [v for i, v in enumerate(enum["calls"]) if i % 2 == 0]
    chunk = [v for i, v in enumerate(enum["calls"]) if i % 2 == 1]
    cat = lambda calls: tuple(torch.cat(parts) for parts in zip(*calls))  # noqa: E731
    return {"relaxation": (enum, cat(relax)), "chunk": (enum, cat(chunk)),
            "final": (final, cat(final["calls"]))}


def _highs(K_eq, K_in, c, b, h):
    """Each LP's exact optimum ``(objective, x)`` by HiGHS, in float64."""
    S = K_eq.shape[0]
    objs, xs = [], []
    for p in range(c.shape[0]):
        res = linprog(c[p], A_ub=K_in[p % S], b_ub=h[p], A_eq=K_eq[p % S], b_eq=b[p],
                      bounds=(0, None), method="highs")
        assert res.success, res.message
        objs.append(res.fun)
        xs.append(res.x)
    return np.array(objs), np.array(xs)


@pytest.mark.parametrize("shape", SHAPES)
def test_kernel_matches_op_path_on_the_cell_solves(cuda, monkeypatch, cell_solves, shape):
    """Objectives, residuals and rejected steps of the kernel against the
    op-by-op solve on the same LPs.  Each limit is set from the op path's own
    results: its objectives' distance to HiGHS's exact optimum on these LPs
    (two solvers each within ``e`` of the optimum lie within ``2 e`` of each
    other, so the kernel's objectives, relative to ``1 + |J*|``, lie within
    twice the op path's largest distance of the op path's, and within twice
    that distance of the optimum), and twice the op path's largest residual
    (HiGHS's are 0), its most rejected steps in one LP and its rejected
    steps in all (a rejected step is a float32 factorization of a nearly
    singular M, which near convergence comes and goes with rounding).  ``x``
    is not compared: these LPs are degenerate, their optimal ``x`` is not
    unique, and two solvers at the same objective may stand anywhere on the
    optimal face.  Nor is the complementarity gap at the best iterate: on
    both paths it ends at float32's rounding (1e-8 to 1e-6 here), where two
    solvers that round differently are not ordered."""
    entry, (c, b, h) = cell_solves[shape]
    K_eq, K_in = entry["args"]
    kernel = lp.make_batched_box_ipm_solver(K_eq, K_in, **entry["kw"])
    ops = _op_path(monkeypatch, lambda: lp.make_batched_box_ipm_solver(K_eq, K_in, **entry["kw"]))
    x_k, info_k = kernel(c, b, h)
    x_o, info_o = ops(c, b, h)
    torch.cuda.synchronize()
    stack = np.asarray(K_eq, np.float64)
    stack = stack if stack.ndim == 3 else stack[None]
    in_stack = np.asarray(K_in, np.float64)
    in_stack = in_stack if in_stack.ndim == 3 else in_stack[None]
    j_star, _ = _highs(stack, in_stack, *(v.double().cpu().numpy() for v in (c, b, h)))

    obj_k, obj_o = (i["objective"].double().cpu().numpy() for i in (info_k, info_o))
    scale = 1.0 + np.abs(j_star)
    op_obj_gap = np.abs(obj_o - j_star) / scale
    print(f"{shape}: {len(c)} LPs, op |J - J*| max {op_obj_gap.max():.3g}, kernel "
          f"{(np.abs(obj_k - j_star) / scale).max():.3g}, kernel-op "
          f"{(np.abs(obj_k - obj_o) / scale).max():.3g}")
    assert (np.abs(obj_k - obj_o) / scale).max() <= 2 * op_obj_gap.max()
    assert (np.abs(obj_k - j_star) / scale).max() <= 2 * op_obj_gap.max()

    r_k, r_o = info_k["residual"].max().item(), info_o["residual"].max().item()
    g_k, g_o = info_k["gap"].max().item(), info_o["gap"].max().item()
    rej_k, rej_o = info_k["rejected"].cpu(), info_o["rejected"].cpu()
    print(f"  residual max op {r_o:.3g} kernel {r_k:.3g}; gap max op {g_o:.3g} kernel "
          f"{g_k:.3g}; rejected steps op {int(rej_o.sum())} in {int((rej_o > 0).sum())} LPs "
          f"(at most {int(rej_o.max())} in one), kernel {int(rej_k.sum())} in "
          f"{int((rej_k > 0).sum())} (at most {int(rej_k.max())})")
    assert torch.isfinite(x_k).all() and torch.isfinite(info_k["gap"]).all()
    assert r_k <= 2 * r_o
    assert int(rej_k.max()) <= 2 * int(rej_o.max())
    assert int(rej_k.sum()) <= 2 * int(rej_o.sum())


@pytest.mark.parametrize("refine", [0, 2])
def test_kernel_pins_degenerate_variables(cuda, monkeypatch, refine):
    """``tests/test_torch_lp.py``'s pinned box on the card: a collapsed box
    (x0 <= 0) pins x0 exactly at 0 and x1 carries the equality."""
    K_eq = np.array([[1.0, 1.0]])
    K_in = np.array([[1.0, 0.0], [0.0, 1.0]])
    c = np.array([[1.0, 2.0], [1.0, 2.0]], np.float32)
    b = np.array([[10.0], [10.0]], np.float32)
    h = np.array([[20.0, 20.0], [0.0, 20.0]], np.float32)
    kw = dict(iters=40, dtype=np.float32, newton_refine=refine, device=cuda)
    x, info = lp.make_batched_box_ipm_solver(K_eq, K_in, **kw)(c, b, h)
    xo, _ = _op_path(monkeypatch, lambda: lp.make_batched_box_ipm_solver(K_eq, K_in, **kw))(
        c, b, h)
    x, xo = x.double().cpu().numpy(), xo.double().cpu().numpy()
    np.testing.assert_allclose(x[0], [10.0, 0.0], atol=1e-3)
    assert x[1, 0] == 0.0
    np.testing.assert_allclose(x[1, 1], 10.0, atol=1e-3)
    assert float(info["residual"][1]) < 1e-3
    np.testing.assert_allclose(info["objective"].cpu().numpy(), [10.0, 20.0], rtol=1e-3)
    np.testing.assert_allclose(x, xo, rtol=1e-5, atol=1e-5)


def test_kernel_all_pinned_is_guarded(cuda, monkeypatch):
    """Every variable pinned: ``mu`` is 0 and the centering ratio is guarded
    to 0, so no step is rejected and both paths return the pinned point."""
    K_eq = np.array([[1.0, 1.0]])
    K_in = np.array([[1.0, 0.0], [0.0, 1.0], [-1.0, 0.0], [0.0, -1.0]])
    c = np.array([[1.0, 2.0], [3.0, -1.0]], np.float32)
    b = np.array([[5.0], [0.0]], np.float32)
    h = np.array([[2.0, 3.0, -2.0, -3.0], [0.0, 0.0, 0.0, 0.0]], np.float32)
    kw = dict(iters=10, dtype=np.float32, device=cuda)
    x, info = lp.make_batched_box_ipm_solver(K_eq, K_in, **kw)(c, b, h)
    xo, info_o = _op_path(monkeypatch, lambda: lp.make_batched_box_ipm_solver(K_eq, K_in, **kw))(
        c, b, h)
    assert x.cpu().tolist() == [[2.0, 3.0], [0.0, 0.0]]
    assert torch.equal(x, xo)
    assert torch.equal(info["objective"], info_o["objective"])
    assert info["rejected"].tolist() == [0, 0]
    assert torch.isfinite(info["gap"]).all()


def test_kernel_failed_factorization_keeps_the_last_finite_iterate(cuda, monkeypatch):
    """Problem 0's two equality rows are the same row, so from the start its
    M is [[1/4, 1/4], [1/4, 1/4]] exactly (the regularization rounds away)
    and the second pivot is 0: every step is rejected, in the kernel as in
    the op path, and both return the start.  Problem 1, on a regular matrix,
    solves."""
    K_eq = np.array([[[1.0, 0.0], [1.0, 0.0]], [[1.0, 0.0], [0.0, 1.0]]])
    K_in = np.array([np.eye(2), np.eye(2)])
    c = np.array([[0.5, 0.25], [0.5, 0.25]], np.float32)
    b = np.array([[1.0, 1.0], [1.0, 1.5]], np.float32)
    h = np.full((2, 2), 2.0, np.float32)
    kw = dict(iters=20, dtype=np.float32, newton_refine=1, device=cuda)
    x, info = lp.make_batched_box_ipm_solver(K_eq, K_in, **kw)(c, b, h)
    xo, info_o = _op_path(monkeypatch, lambda: lp.make_batched_box_ipm_solver(K_eq, K_in, **kw))(
        c, b, h)
    assert info["rejected"][0] == info_o["rejected"][0] == 20
    assert x[0].tolist() == xo[0].tolist() == [1.0, 1.0]
    np.testing.assert_allclose(x[1].cpu().numpy(), [1.0, 1.5], atol=1e-4)
    assert torch.isfinite(info["gap"]).all()


def test_kernel_is_deterministic_and_replays_bitwise(cuda, cell_solves):
    """Two launches on the same inputs give the same bits, and the solve
    replayed from a CUDA graph gives the eager launch's."""
    entry, (c, b, h) = cell_solves["final"]
    K_eq, K_in = entry["args"]
    kw = dict(entry["kw"], cuda_graph=False)
    eager = lp.make_batched_box_ipm_solver(K_eq, K_in, **kw)
    replayed = lp.make_batched_box_ipm_solver(K_eq, K_in, **dict(kw, cuda_graph=True))
    runs = [eager(c, b, h), eager(c, b, h), replayed(c, b, h), replayed(c, b, h)]
    torch.cuda.synchronize()
    for x, info in runs[1:]:
        assert torch.equal(x, runs[0][0])
        assert all(torch.equal(info[k], runs[0][1][k]) for k in info)


def test_kernel_solves_counted_three_an_hour(cuda, tmp_path):
    """An hour of the planner cell runs its three solves in the kernel:
    ``pymgrid.lp.kernel_solves`` reads 3 beside 250 problems and 130
    iterations."""
    mpc = SuiteMPC([Microgrid.from_scenario(n) for n in range(25)], 60, device=cuda, **CELL)
    state = mpc.reset(0)
    state, _ = mpc.step(state)          # records the three solve shapes
    with trace(str(tmp_path), device=cuda):
        mpc.step(state)
    counters = span_totals()["counters"]
    assert counters["pymgrid.lp.kernel_solves"] == 3
    assert counters["pymgrid.lp.problems"] == 250
    assert counters["pymgrid.lp.iterations"] == 130
