"""Batched linear programming on torch tensors: the planners' LP solvers.

Port of :mod:`pymgrid_tpu.core.lp`.  Every solver handles batches of LPs that
share one constraint structure,

    min c'x   s.t.   K_eq x = b,   K_in x <= h,   x >= 0,

with per-problem ``(c, b, h)``; each factory returns ``solve(c, b, h) ->
(x, info)`` on tensors, with the JAX solvers' ``info`` keys plus
``"rejected"`` on the interior-point solvers (per problem, the iterations
whose step came out non-finite and was thrown away).

The host preparation (Ruiz scaling, column and row equilibration, the box
row maps, the PDHG power iteration with ``RandomState(0)``) is the JAX
module's numpy, copied (:func:`ruiz_scale`) or rewritten here.  ``lax.scan``
over iterations becomes a Python loop of eager ops; nothing inside a solve waits for the device:

* ``torch.linalg.cholesky_ex`` does not check its result; where a
  factorization fails (``info`` not 0) every solve with that factor returns
  NaN, as it does with the NaN factor ``jnp.linalg.cholesky`` returns, so
  the iteration's finite-step guard rejects that step and the problem keeps
  its last finite iterate.  (The NaN goes onto the solves' vectors, not the
  factor: one small add per solve instead of a pass over every matrix.)
* ``matmul_precision`` keeps the JAX argument: ``"float32"`` runs float32
  solves with TF32 off on CUDA whatever the global setting, and
  ``"tensorfloat32"`` / ``"bfloat16"`` allow TF32, the H100's nearest match
  to the TPU's fewer-pass matmuls.  It changes nothing on the CPU or in
  float64.
* The interior-point centering ratio is guarded: ``sigma = (mu_aff / mu)**3``
  is 0 where ``mu`` is 0 (every variable pinned), where the JAX solver
  produces NaN (ROADMAP.md C3).
* Under a profiler capture every interior-point solve is the span
  ``pymgrid.lp.ipm`` and adds its problems to the counter
  ``pymgrid.lp.problems`` and its iterations to ``pymgrid.lp.iterations``.
* ``cuda_graph=True`` on a CUDA device records each input shape's solve
  once and replays it (:func:`_replayed`): one launch for the ~290 kernels
  of every iteration, the same kernels on the same inputs.

Reductions and LAPACK run in another order than XLA's, so the solvers agree
with the JAX package to a tolerance, not bitwise.
"""
import contextlib

import numpy as np
import torch

from pymgrid_tpu_torch._device import resolve_device, torch_dtype
from pymgrid_tpu_torch.utils import cuda_graph as graphs
from pymgrid_tpu_torch.utils.profiling import count, span

__all__ = [
    "ruiz_scale",
    "make_batched_lp_solver",
    "make_batched_ipm_solver",
    "make_batched_box_ipm_solver",
]


def ruiz_scale(K, iters=10):
    """Ruiz equilibration: diagonal row/col scalings D_r K D_c with rows and
    columns brought toward unit infinity-norm."""
    K = np.asarray(K, dtype=np.float64)
    m, n = K.shape
    d_r = np.ones(m)
    d_c = np.ones(n)
    M = K.copy()
    for _ in range(iters):
        row_norm = np.sqrt(np.maximum(np.abs(M).max(axis=1), 1e-12))
        col_norm = np.sqrt(np.maximum(np.abs(M).max(axis=0), 1e-12))
        d_r /= row_norm
        d_c /= col_norm
        M = K * d_r[:, None] * d_c[None, :]
    return M, d_r, d_c


_PRECISIONS = ("float32", "tensorfloat32", "bfloat16")


@contextlib.contextmanager
def _matmul_precision(precision, device):
    """TF32 off (``"float32"``) or allowed for CUDA matmuls inside a solve;
    the global flag is restored afterwards."""
    if precision not in _PRECISIONS:
        raise ValueError(f"matmul_precision must be one of {_PRECISIONS}, got {precision!r}")
    if device.type != "cuda":
        yield
        return
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = precision != "float32"
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def _as(v, dtype, device):
    return torch.as_tensor(v, dtype=dtype, device=device)


def _cholesky(M):
    """Batched lower Cholesky factor ``L (..., m, m)`` and ``failed (..., 1)``:
    0 where the factorization succeeded, NaN where it failed, to be added to
    every solve with ``L`` (no host synchronization, nothing raises)."""
    L, info = torch.linalg.cholesky_ex(M)
    failed = torch.where(info != 0, float("nan"), 0.0).to(M.dtype).unsqueeze(-1)
    return L, failed


def _tri_solve(L, failed, rhs):
    """``(L L')^-1 rhs`` by two triangular solves; ``rhs`` is ``(..., m)``."""
    w = torch.linalg.solve_triangular(L, rhs.unsqueeze(-1), upper=False)
    return torch.linalg.solve_triangular(L.mT, w, upper=True).squeeze(-1) + failed


def _max_step(ratio):
    """``min(1, 0.995 * min ratio)`` over the last axis, kept."""
    return torch.clamp(0.995 * ratio.amin(dim=2, keepdim=True), max=1.0)


def _replayed(solve):
    """``solve(c, b, h)`` replayed from a ``Recording`` per input shape
    and dtype, made at the shape's first call and kept for the solver's life
    (a planner solves a few shapes).  A call returns copies of the outputs,
    which a later replay cannot overwrite."""
    recordings = {}   # ((shape, dtype) of c, b, h) -> its Recording

    def run(c, b, h):
        key = tuple((tuple(v.shape), v.dtype) for v in (c, b, h))
        recording = recordings.get(key)
        if recording is None:
            recording = recordings[key] = graphs.Recording(solve, (c, b, h))
        recording.load(c, b, h)
        recording.replay()
        x, info = recording.outputs
        return x.clone(), {k: v.clone() for k, v in info.items()}

    return run


def _stack_inputs(K_eq, K_in, x_scale):
    """The JAX solvers' 2-D -> ``(S, ...)`` stack promotion."""
    K_eq = np.asarray(K_eq, dtype=np.float64)
    K_in = np.asarray(K_in, dtype=np.float64)
    if K_eq.ndim == 2:
        K_eq = K_eq[None]
        K_in = K_in[None]
        if x_scale is not None:
            x_scale = np.asarray(x_scale, dtype=np.float64)[None]
    return K_eq, K_in, x_scale


def _split_batch(c, S):
    B = c.shape[0]
    if B % S:
        raise ValueError(f"batch {B} must be a multiple of the matrix stack size {S}")
    return B, B // S


def make_batched_ipm_solver(K_eq, K_in, iters=35, dtype=np.float64, x_scale=None,
                            newton_refine=None, matmul_precision="float32",
                            solve_mode="triangular", *, device="cuda", cuda_graph=False):
    """Batched Mehrotra predictor-corrector IPM in slack form,
    ``A [x; s] = [b; h]`` with ``A = [[K_eq, 0], [K_in, I]]``: the port of
    :func:`pymgrid_tpu.core.lp.make_batched_ipm_solver`, same arguments plus
    ``device`` and ``cuda_graph``.

    3-D ``K_eq (S, me, n0)`` / ``K_in (S, mi, n0)`` stack S problems of one
    structure with different matrix values; ``solve`` then takes ``B = k*S``
    problems in ``(k, S)`` blocks (problem ``i*S + s`` uses matrix ``s``).
    ``solve_mode="inverse"`` forms ``M^-1`` once per iteration and turns
    every Newton solve into a matvec; ``"triangular"`` solves with the
    factor each time."""
    if solve_mode not in ("triangular", "inverse"):
        raise ValueError(f"solve_mode must be 'triangular' or 'inverse', got {solve_mode!r}")
    if newton_refine is None:
        newton_refine = 0 if np.dtype(dtype) == np.float64 else 1
    device, dt = resolve_device(device), torch_dtype(dtype)

    K_eq, K_in, x_scale = _stack_inputs(K_eq, K_in, x_scale)
    S, me, n0 = K_eq.shape
    mi = K_in.shape[1]
    m = me + mi
    n = n0 + mi  # with slacks

    # column scaling by the variables' magnitudes; slacks take their row's
    if x_scale is None:
        col_scale = np.ones((S, n))
    else:
        x_scale = np.maximum(np.asarray(x_scale, dtype=np.float64), 1e-8)
        if x_scale.shape != (S, n0):
            raise ValueError(f"x_scale must be {(S, n0)}, got {x_scale.shape}")
        s_scale = np.maximum(np.einsum("smn,sn->sm", np.abs(K_in), x_scale), 1e-8)
        col_scale = np.concatenate([x_scale, s_scale], axis=1)

    A_np = np.zeros((S, m, n))
    A_np[:, :me, :n0] = K_eq
    A_np[:, me:, :n0] = K_in
    A_np[:, me:, n0:] = np.eye(mi)[None]
    A_np = A_np * col_scale[:, None, :]
    row_scale = 1.0 / np.maximum(np.abs(A_np).max(axis=2), 1e-8)
    A_np = A_np * row_scale[:, :, None]

    A = _as(A_np, dt, device)                        # (S, m, n)
    row_scale_t = _as(row_scale, dt, device)         # (S, m)
    col_scale_t = _as(col_scale, dt, device)         # (S, n)
    eye = torch.eye(m, dtype=dt, device=device)

    def mm_AT(v):
        """(k, S, n) -> (k, S, m): A_s v"""
        return torch.einsum("ksn,smn->ksm", v, A)

    def mm_A(y):
        """(k, S, m) -> (k, S, n): A_s' y"""
        return torch.einsum("ksm,smn->ksn", y, A)

    def solve(c, b, h):
        with span("pymgrid.lp.ipm"):
            count("pymgrid.lp.problems", len(c))
            count("pymgrid.lp.iterations", iters)
            c, b, h = (_as(v, dt, device) for v in (c, b, h))
            with _matmul_precision(matmul_precision, device):
                return run(c, b, h)

    def _solve(c, b, h):
        B, k = _split_batch(c, S)
        cc = torch.cat([c.reshape(k, S, n0), c.new_zeros(k, S, mi)], dim=2) * col_scale_t
        bb = torch.cat([b.reshape(k, S, me), h.reshape(k, S, mi)], dim=2) * row_scale_t

        # per-problem objective normalization (argmin-invariant)
        c_mag = torch.clamp(cc.abs().amax(dim=2, keepdim=True), min=1.0)
        cc = cc / c_mag

        scale = 1.0 + torch.maximum(bb.abs().amax(dim=2), cc.abs().amax(dim=2))[:, :, None]
        x = scale.expand(k, S, n)
        z = scale.expand(k, S, n)
        y = c.new_zeros(k, S, m)
        reg = 1e-11 * scale                  # (k, S, 1): added to M's diagonal

        def merit(x, y, z):
            r_b = mm_AT(x) - bb
            r_c = mm_A(y) + z - cc
            mu = (x * z).sum(dim=2, keepdim=True) / n
            return (mu + r_b.abs().amax(dim=2, keepdim=True)
                    + r_c.abs().amax(dim=2, keepdim=True))

        best = (x, y, z, torch.full((k, S, 1), float("inf"), dtype=dt, device=device))
        rejected = torch.zeros((k, S, 1), dtype=torch.int32, device=device)
        for _ in range(iters):
            r_b = mm_AT(x) - bb
            r_c = mm_A(y) + z - cc
            mu = (x * z).sum(dim=2, keepdim=True) / n

            d = torch.clamp(x / z, 1e-10, 1e10)
            M = torch.einsum("ksmn,sln->ksml", d[:, :, None, :] * A, A)
            M.diagonal(dim1=-2, dim2=-1).add_(reg)
            L, failed = _cholesky(M)
            if solve_mode == "inverse":
                # M^-1 once per iteration; every Newton solve is then a matvec
                lw = torch.linalg.solve_triangular(L, eye.expand(M.shape), upper=False)
                Minv = torch.linalg.solve_triangular(L.mT, lw, upper=True)
                chol_solve = lambda rhs: torch.einsum("ksml,ksl->ksm", Minv, rhs) + failed
            else:
                chol_solve = lambda rhs: _tri_solve(L, failed, rhs)

            def newton(r_xz):
                rhs = -r_b + mm_AT((r_xz - x * r_c) / z)
                dy = chol_solve(rhs)
                for _ in range(newton_refine):
                    dy = dy + chol_solve(rhs - torch.einsum("ksml,ksl->ksm", M, dy))
                dz = -r_c - mm_A(dy)
                dx = -(r_xz + x * dz) / z
                return dx, dy, dz

            def step_len(v, dv):
                return _max_step(torch.where(dv < 0, -v / dv, float("inf")))

            # predictor
            dx_a, dy_a, dz_a = newton(x * z)
            a_p = step_len(x, dx_a)
            a_d = step_len(z, dz_a)
            mu_aff = ((x + a_p * dx_a) * (z + a_d * dz_a)).sum(dim=2, keepdim=True) / n
            sigma = torch.where(mu > 0, (mu_aff / mu) ** 3, 0.0)

            # corrector (same factorization)
            dx, dy, dz = newton(x * z + dx_a * dz_a - sigma * mu)
            a_p = step_len(x, dx)
            a_d = step_len(z, dz)

            # keep iterating unless non-finite; return the best iterate by merit
            x_c, y_c, z_c = x + a_p * dx, y + a_d * dy, z + a_d * dz
            finite = (torch.isfinite(x_c).all(dim=2, keepdim=True)
                      & torch.isfinite(y_c).all(dim=2, keepdim=True)
                      & torch.isfinite(z_c).all(dim=2, keepdim=True))
            rejected = rejected + (~finite).to(torch.int32)
            x = torch.where(finite, x_c, x)
            y = torch.where(finite, y_c, y)
            z = torch.where(finite, z_c, z)

            m_new = merit(x, y, z)
            improved = m_new < best[3]
            best = tuple(torch.where(improved, new, old)
                         for new, old in zip((x, y, z, m_new), best))
        x, _, z, _ = best

        r = (mm_AT(x) - bb).abs().amax(dim=2).reshape(B)
        x_out = (x[:, :, :n0] * col_scale_t[:, :n0]).reshape(B, n0)
        obj = (c * x_out).sum(dim=1)
        gap = (x * z).sum(dim=2).reshape(B) / n
        return x_out, {"residual": r, "objective": obj, "gap": gap,
                       "rejected": rejected.reshape(B)}

    run = _replayed(_solve) if cuda_graph and graphs.available(device) else _solve
    return solve


def make_batched_lp_solver(K_eq, K_in, iters=8000, restart_every=200,
                           dtype=np.float32, *, device="cuda"):
    """Batched PDHG with Ruiz scaling, per-problem primal weights and
    ergodic-average restarts every ``restart_every`` iterations: the port of
    :func:`pymgrid_tpu.core.lp.make_batched_lp_solver`, same arguments plus
    ``device``.  ``K_eq (me, n)`` and ``K_in (mi, n)`` are shared; ``c (B,
    n)``, ``b (B, me)``, ``h (B, mi)`` are batched.  Matmuls run in full
    float32 (TF32 off), as the JAX solver pins them."""
    device, dt = resolve_device(device), torch_dtype(dtype)
    K_eq = np.asarray(K_eq, dtype=np.float64)
    K_in = np.asarray(K_in, dtype=np.float64)
    me, n = K_eq.shape

    K_scaled, d_r, d_c = ruiz_scale(np.concatenate([K_eq, K_in], axis=0))

    # spectral norm of the scaled matrix by power iteration (host, once)
    v = np.random.RandomState(0).randn(n)
    for _ in range(50):
        v = K_scaled.T @ (K_scaled @ v)
        v /= np.linalg.norm(v)
    sigma_max = float(np.sqrt(np.linalg.norm(K_scaled.T @ (K_scaled @ v))))
    eta = 0.9 / sigma_max  # tau*sigma*||K||^2 < 1 with tau=eta*w, sigma=eta/w

    K = _as(K_scaled, dt, device)
    KT = _as(K_scaled.T, dt, device)
    d_r_t = _as(d_r, dt, device)
    d_c_t = _as(d_c, dt, device)
    n_restarts = max(iters // restart_every, 1)

    def solve(c, b, h):
        c, b, h = (_as(v, dt, device) for v in (c, b, h))
        with _matmul_precision("float32", device):
            return _solve(c, b, h)

    def _solve(c, b, h):
        c_s = c * d_c_t
        q = torch.cat([b, h], dim=1) * d_r_t
        # primal weight per problem (PDLP init: ||q|| / ||c||)
        w = torch.sqrt((torch.linalg.vector_norm(q, dim=1) + 1e-12)
                       / (torch.linalg.vector_norm(c_s, dim=1) + 1e-12))[:, None]
        tau = eta * w
        sigma = eta / w

        x = c.new_zeros(c.shape[0], n)
        y = c.new_zeros(c.shape[0], q.shape[1])
        for _ in range(n_restarts):
            x_sum = torch.zeros_like(x)
            y_sum = torch.zeros_like(y)
            for _ in range(restart_every):
                x_new = torch.clamp(x - tau * (c_s + y @ K), min=0.0)
                y_new = y + sigma * ((2.0 * x_new - x) @ KT - q)
                y = torch.cat([y_new[:, :me], torch.clamp(y_new[:, me:], min=0.0)], dim=1)
                x = x_new
                x_sum = x_sum + x
                y_sum = y_sum + y
            # restart from the epoch's ergodic average
            x, y = x_sum / restart_every, y_sum / restart_every

        r = x @ KT - q
        res = torch.maximum(r[:, :me].abs().amax(dim=1),
                            torch.clamp(r[:, me:], min=0.0).amax(dim=1))
        x_out = x * d_c_t
        return x_out, {"residual": res, "objective": (c * x_out).sum(dim=1)}

    return solve


def make_batched_box_ipm_solver(K_eq, K_in, iters=35, dtype=np.float64,
                                x_scale=None, newton_refine=None,
                                matmul_precision="float32", *, device="cuda",
                                cuda_graph=False):
    """Batched Mehrotra IPM on the box structure of the MPC LP: the port of
    :func:`pymgrid_tpu.core.lp.make_batched_box_ipm_solver`, same arguments
    plus ``device`` and ``cuda_graph``.

    Every inequality row touches exactly one variable, so the LP is
    ``min c'x  s.t.  K_eq x = b,  lo(h) <= x <= hi(h)`` and the normal
    equations are ``me x me``.  ``h`` maps to per-variable bounds through the
    static row -> variable map with one ``scatter_reduce`` (``amin`` for upper
    and ``amax`` for lower bounds) over all ``(k, S)`` problems.  Degenerate
    boxes are pinned at ``lo`` and masked out of the barrier, and the result
    is clipped to the exact bounds, as in the JAX solver."""
    if newton_refine is None:
        newton_refine = 0 if np.dtype(dtype) == np.float64 else 1
    device, dt = resolve_device(device), torch_dtype(dtype)

    K_eq, K_in, x_scale = _stack_inputs(K_eq, K_in, x_scale)
    S, me, n0 = K_eq.shape
    mi = K_in.shape[1]

    # ---- static row -> (variable, signed coefficient) maps per stack entry
    if not np.all((np.abs(K_in) > 0).sum(axis=2) == 1):
        raise ValueError(
            "box IPM requires every inequality row to touch exactly one "
            "variable; use make_batched_ipm_solver for general rows"
        )
    var_of_row = np.abs(K_in).argmax(axis=2)                              # (S, mi)
    coef_of_row = np.take_along_axis(K_in, var_of_row[:, :, None], axis=2)[:, :, 0]

    if x_scale is None:
        col_scale = np.ones((S, n0))
    else:
        col_scale = np.maximum(np.asarray(x_scale, dtype=np.float64), 1e-8)
        if col_scale.shape != (S, n0):
            raise ValueError(f"x_scale must be {(S, n0)}, got {col_scale.shape}")
    A_np = K_eq * col_scale[:, None, :]
    row_scale = 1.0 / np.maximum(np.abs(A_np).max(axis=2), 1e-8)
    A_np = A_np * row_scale[:, :, None]

    A = _as(A_np, dt, device)                                  # (S, me, n0)
    row_scale_t = _as(row_scale, dt, device)
    col_scale_t = _as(col_scale, dt, device)
    var_of_row_t = torch.as_tensor(var_of_row, device=device)  # (S, mi) int64
    # row bound in SCALED variable units: coef*x <= h_i bounds x above
    # (coef > 0) or below (coef < 0), with x = col_scale * x'
    coef_scaled = _as(coef_of_row * np.take_along_axis(col_scale, var_of_row, axis=1),
                      dt, device)
    plus_mask = torch.as_tensor(coef_of_row > 0, device=device)
    big = _as(1e12, dt, device)
    zero = _as(0.0, dt, device)
    n = n0

    def bounds_from_h(h):
        """h (k, S, mi) -> (lo, hi) (k, S, n0) in scaled variable units."""
        bound = h / coef_scaled
        rows = var_of_row_t.expand(h.shape)
        hi = torch.full(h.shape[:2] + (n,), 1e12, dtype=dt, device=device).scatter_reduce(
            2, rows, torch.where(plus_mask, bound, big), reduce="amin", include_self=True)
        lo = h.new_zeros(h.shape[:2] + (n,)).scatter_reduce(
            2, rows, torch.where(plus_mask, zero, bound), reduce="amax", include_self=True)
        return lo, hi

    def mm_AT(v):
        """(k, S, n) -> (k, S, me): A_s v"""
        return torch.einsum("ksn,smn->ksm", v, A)

    def mm_A(y):
        """(k, S, me) -> (k, S, n): A_s' y"""
        return torch.einsum("ksm,smn->ksn", y, A)

    def solve(c, b, h):
        with span("pymgrid.lp.ipm"):
            count("pymgrid.lp.problems", len(c))
            count("pymgrid.lp.iterations", iters)
            c, b, h = (_as(v, dt, device) for v in (c, b, h))
            with _matmul_precision(matmul_precision, device):
                return run(c, b, h)

    def _solve(c, b, h):
        B, k = _split_batch(c, S)
        cc = c.reshape(k, S, n0) * col_scale_t
        bb = b.reshape(k, S, me) * row_scale_t
        lo, hi = bounds_from_h(h.reshape(k, S, mi))
        # degenerate boxes (genset-off production, outage grid flows) are
        # PINNED at lo and masked out of the barrier (see the JAX solver)
        pinned = (hi - lo) <= 1e-5 * (1.0 + hi.abs())
        free = 1.0 - pinned.to(dt)
        width = torch.maximum(hi - lo, 1e-6 * (1.0 + hi.abs()))
        hi_w = lo + width

        cn = cc / torch.clamp(cc.abs().amax(dim=2, keepdim=True), min=1.0)

        # strictly interior start; pinned variables get inert constants
        s0 = torch.clamp(0.5 * width, min=1e-2)
        s = torch.where(pinned, 1.0, s0)
        t = torch.where(pinned, 1.0, torch.clamp(hi_w - (lo + s0), min=1e-2))
        scale = 1.0 + torch.maximum(bb.abs().amax(dim=2), cn.abs().amax(dim=2))[:, :, None]
        z = scale.expand(k, S, n)
        w = scale.expand(k, S, n)
        y = c.new_zeros(k, S, me)
        reg = 1e-11 * scale                  # (k, S, 1): added to M's diagonal
        two_n = torch.clamp(2.0 * free.sum(dim=2, keepdim=True), min=1.0)

        def x_of(sv):
            return lo + torch.where(pinned, 0.0, sv)

        def mean_compl(sv, tv, zv, wv):
            return ((free * sv * zv).sum(dim=2, keepdim=True)
                    + (free * tv * wv).sum(dim=2, keepdim=True)) / two_n

        def merit(sv, tv, zv, wv, yv):
            r_b = mm_AT(x_of(sv)) - bb
            r_c = free * (mm_A(yv) + zv - wv - cn)
            return (mean_compl(sv, tv, zv, wv) + r_b.abs().amax(dim=2, keepdim=True)
                    + r_c.abs().amax(dim=2, keepdim=True))

        best = (s, t, z, w, y, torch.full((k, S, 1), float("inf"), dtype=dt, device=device))
        rejected = torch.zeros((k, S, 1), dtype=torch.int32, device=device)
        for _ in range(iters):
            r_b = mm_AT(x_of(s)) - bb
            r_c = mm_A(y) + z - w - cn
            mu = mean_compl(s, t, z, w)

            d = free / torch.clamp(z / s + w / t, 1e-10, 1e10)
            M = torch.einsum("ksmn,sln->ksml", d[:, :, None, :] * A, A)
            M.diagonal(dim1=-2, dim2=-1).add_(reg)
            L, failed = _cholesky(M)

            def newton(rs, rt):
                """(dx, dy, dz, dw) for complementarity targets rs (s z) and
                rt (t w)."""
                g = r_c + rs / s - rt / t
                rhs = -r_b - mm_AT(d * g)
                dy = _tri_solve(L, failed, rhs)
                for _ in range(newton_refine):
                    dy = dy + _tri_solve(L, failed, rhs - torch.einsum("ksml,ksl->ksm", M, dy))
                dx = d * (mm_A(dy) + g)
                return dx, dy, free * (rs - z * dx) / s, free * (rt + w * dx) / t

            def steps(dx, dz, dw):
                inf = float("inf")
                a_p = _max_step(torch.minimum(torch.where(dx < 0, -s / dx, inf),
                                              torch.where(dx > 0, t / dx, inf)))
                a_d = _max_step(torch.minimum(torch.where(dz < 0, -z / dz, inf),
                                              torch.where(dw < 0, -w / dw, inf)))
                return a_p, a_d

            # predictor (affine)
            dx_a, dy_a, dz_a, dw_a = newton(-s * z, -t * w)
            a_p, a_d = steps(dx_a, dz_a, dw_a)
            mu_aff = mean_compl(s + a_p * dx_a, t - a_p * dx_a,
                                z + a_d * dz_a, w + a_d * dw_a)
            sigma = torch.where(mu > 0, (mu_aff / mu) ** 3, 0.0)

            # corrector
            dx, dy, dz, dw = newton(sigma * mu - s * z - dx_a * dz_a,
                                    sigma * mu - t * w + dx_a * dw_a)
            a_p, a_d = steps(dx, dz, dw)

            new = (s + a_p * dx, t - a_p * dx, z + a_d * dz, w + a_d * dw, y + a_d * dy)
            finite = torch.isfinite(new[0]).all(dim=2, keepdim=True)
            for v in new[1:]:
                finite = finite & torch.isfinite(v).all(dim=2, keepdim=True)
            rejected = rejected + (~finite).to(torch.int32)
            s, t, z, w, y = (torch.where(finite, nv, ov)
                             for nv, ov in zip(new, (s, t, z, w, y)))

            m_new = merit(s, t, z, w, y)
            improved = m_new < best[5]
            best = tuple(torch.where(improved, nv, ov)
                         for nv, ov in zip((s, t, z, w, y, m_new), best))
        s, t, z, w, _, _ = best

        x = torch.minimum(torch.maximum(x_of(s), lo), hi)  # exact (incl. degenerate) bounds
        r = (mm_AT(x) - bb).abs().amax(dim=2).reshape(B)
        x_out = (x * col_scale_t).reshape(B, n0)
        obj = (c * x_out).sum(dim=1)
        gap = mean_compl(s, t, z, w).reshape(B)
        return x_out, {"residual": r, "objective": obj, "gap": gap,
                       "rejected": rejected.reshape(B)}

    run = _replayed(_solve) if cuda_graph and graphs.available(device) else _solve
    return solve
