"""Whole batched box-IPM solves in one launch: the binding of the hand-written
CUDA kernel ``csrc/box_ipm.cu``.

:class:`BoxIpmKernel` runs every iteration of
:func:`~pymgrid_tpu_torch.core.lp.make_batched_box_ipm_solver`'s Mehrotra
loop for ``B`` problems as one launch of ``B`` thread blocks, each holding
its problem in shared memory (the source's note says how).  It replaces no
TPU kernel: the JAX package leaves the box IPM to XLA.  The solver takes it
where :func:`fits` holds for its shapes, on a CUDA device in float32
(``core/lp._box_kernel_runs``); its plain PyTorch version is that solver's
op-by-op loop, which runs everywhere else (the CPU, float64, oversized
stacks) and is the reference the card tests hold the kernel to.

The solver's host and PyTorch work stays around the launch: the bounds from
``h``, the scalings, the pinned mask and the strictly interior start go in;
the best iterate's ``s, t, z, w`` and the rejected-step counts come out.
"""
import ctypes

import torch

__all__ = ["SMEM_LIMIT", "smem_bytes", "fits", "flops", "bound_ms", "BoxIpmKernel"]

THREADS = 256
WARPS = THREADS // 32
SMEM_LIMIT = 232_448           # bytes of shared memory a block may use on sm_90
_N_VECTORS, _M_VECTORS = 21, 8
_ERRORS = {-1: "shared-memory layout differs from the kernel's", -2: "unsupported shape"}


def _up4(x):
    return (x + 3) & ~3


def smem_bytes(me, n):
    """Bytes of one block's shared memory for an ``me x n`` equality matrix:
    ``A`` (rows padded to an odd stride), ``A'`` (rows padded to an odd
    number of 16-byte words), ``M`` and its factor (``me x me``, odd
    stride), 21 vectors of length ``n``, 8 of length ``me`` and the
    reductions' scratch (``make_layout`` in ``csrc/box_ipm.cu``)."""
    lda, ldm = n | 1, me | 1
    ldt = 4 * ((_up4(me) // 4) | 1)
    floats = (_up4(me * lda) + n * ldt + 2 * _up4(me * ldm) + _N_VECTORS * _up4(n)
              + _M_VECTORS * _up4(me) + 2 * WARPS * 4)
    return 4 * floats


def fits(me, n):
    """Whether one block holds an ``me x n`` problem: its layout within
    :data:`SMEM_LIMIT`."""
    return me > 0 and n > 0 and smem_bytes(me, n) <= SMEM_LIMIT


def flops(me, n, refine):
    """Float32 operations of one problem-iteration at ``me x n``: M's lower
    triangle (``me (me + 1) / 2 x n`` multiply-adds), five matvecs with ``A``
    or ``A'``, the Cholesky (``me^3 / 3``), ``2 (1 + refine)`` pairs of
    triangular solves (predictor and corrector, each with its refinements)
    and ``2 refine`` products with ``M`` (the refinements' residuals).  The
    vectors' elementwise work is left out."""
    return (me * (me + 1) * n + 5 * 2 * me * n + me ** 3 // 3
            + 2 * (1 + refine) * 2 * me * me + 2 * refine * 2 * me * me)


def bound_ms(problems, stack, me, n, iters, refine):
    """The least time an H100 could take for one solve of ``problems``
    problems on a stack of ``stack`` matrices: the larger of its operations
    (:func:`flops`) at the float32 peak of 67 TFLOP/s and its bytes (the
    stack, each problem's inputs and its best iterate) at 3.35 TB/s.  Bound
    by operations at the planner's shapes; the kernel's time is the
    iterations' dependency chain, far above it."""
    nbytes = 4 * (stack * me * n + problems * (me + 9 * n + 4))
    ops = problems * iters * flops(me, n, refine)
    return max(nbytes / 3.35e12, ops / 67e12) * 1e3


_POINTERS = ("A", "bb", "cn", "lo", "free", "s", "t", "scalars", "best", "rejected")


class _Args(ctypes.Structure):
    """Mirror of ``struct BoxIpmArgs`` in ``csrc/box_ipm.cu``."""

    _fields_ = ([(name, ctypes.c_void_p) for name in _POINTERS]
                + [("problems", ctypes.c_longlong)]
                + [(name, ctypes.c_int) for name in
                   ("stack", "me", "n", "iters", "refine", "smem_bytes")])


def _bind(lib):
    lib.box_ipm_prepare.argtypes = []
    lib.box_ipm_prepare.restype = ctypes.c_int
    lib.box_ipm_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.box_ipm_smem_bytes.restype = ctypes.c_int
    launch = lib.box_ipm_launch
    launch.argtypes = [ctypes.POINTER(_Args), ctypes.c_void_p]
    launch.restype = ctypes.c_int
    return lib


def _raise_on(rc, what):
    if rc != 0:
        raise RuntimeError(f"box_ipm {what} failed: {_ERRORS.get(rc, f'CUDA error {rc}')}")


class BoxIpmKernel:
    """``kernel(bb, cn, lo, free, s, t, scalars) -> (best (B, 4, n), rejected
    (B,) int32)`` for the row-scaled equality stack ``A (S, me, n)``, float32
    on a CUDA device: ``iters`` iterations with ``newton_refine`` refinement
    solves, problem ``i*S + s`` on matrix ``s``.  Inputs are ``(B, me)`` or
    ``(B, n)`` and ``scalars (B, 3)`` (the dual start, the regularization
    and twice the free count).  Building it builds and loads the library
    (once a process) outside any capture.  Both calls into the library run
    with the stack's device current and leave the current device as it was."""

    def __init__(self, A, iters, newton_refine):
        if A.device.type != "cuda" or A.dtype != torch.float32 or A.dim() != 3:
            raise ValueError(f"the kernel takes a 3-D float32 CUDA stack, got "
                             f"{tuple(A.shape)} {A.dtype} on {A.device}")
        S, me, n = A.shape
        if not fits(me, n):
            raise ValueError(f"a {me} x {n} problem does not fit one block")
        from pymgrid_tpu_torch.ops._build import load_library

        self.A = A.contiguous()
        self.device = A.device
        self.iters, self.refine = int(iters), int(newton_refine)
        self.smem = smem_bytes(me, n)
        self._lib = _bind(load_library("box_ipm"))
        if self._lib.box_ipm_smem_bytes(me, n) != self.smem:
            _raise_on(-1, "layout")
        with torch.cuda.device(self.device):
            _raise_on(self._lib.box_ipm_prepare(), "prepare")

    def __call__(self, bb, cn, lo, free, s, t, scalars):
        S, me, n = self.A.shape
        B = bb.shape[0]
        want = {"bb": (B, me), "cn": (B, n), "lo": (B, n), "free": (B, n), "s": (B, n),
                "t": (B, n), "scalars": (B, 3)}
        args = dict(bb=bb, cn=cn, lo=lo, free=free, s=s, t=t, scalars=scalars)
        for name, v in args.items():
            if (tuple(v.shape) != want[name] or v.dtype != torch.float32
                    or v.device != self.device or not v.is_contiguous()):
                raise ValueError(f"{name} must be a contiguous float32 {want[name]} on "
                                 f"{self.device}, got {tuple(v.shape)} {v.dtype} on {v.device}")
        if B % S:
            raise ValueError(f"batch {B} must be a multiple of the matrix stack size {S}")
        best = torch.empty((B, 4, n), dtype=torch.float32, device=self.device)
        rejected = torch.empty((B,), dtype=torch.int32, device=self.device)
        ptrs = dict(args, A=self.A, best=best, rejected=rejected)
        c_args = _Args(**{k: ptrs[k].data_ptr() for k in _POINTERS}, problems=B, stack=S,
                       me=me, n=n, iters=self.iters, refine=self.refine,
                       smem_bytes=self.smem)
        with torch.cuda.device(self.device):
            stream = torch.cuda.current_stream(self.device).cuda_stream
            _raise_on(self._lib.box_ipm_launch(ctypes.byref(c_args), stream), "launch")
        return best, rejected
