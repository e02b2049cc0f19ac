#!/usr/bin/env python
"""Count where this host's CPU torch and numpy differ from the C library
that XLA's CPU backend calls.

XLA's CPU ``sqrt`` is the IEEE root, and its float64 ``log`` and float32
``power`` are calls into the C library (``math.sqrt``, ``math.log`` and
``powf`` here), so these counts say how far a tensor op on this host lies
from JAX's bits:

* ``torch.sqrt`` and the port's ``prng._sqrt_f64`` against the IEEE root;
* ``torch.log`` against the C library's ``log``, and both against a
  200-bit ``mpmath`` value: their misroundings (neither is correctly
  rounded, so a correctly rounded ``log`` would not be JAX's bits either);
* optax's float32 bias correction ``1 - b ** count`` through numpy's
  ``power`` against the C library's ``powf``
  (:func:`pymgrid_tpu_torch.utils.optax_adam.bias_correction`).

The float64 inputs are log-uniform on ``[e**-20, e**5]``, the range of
``erfinv``'s ``w`` and of the draws' logs.  Runs on the CPU; the counts are
this host's.

Usage: python -m pymgrid_tpu_torch.tools.libm_parity [--n 400000]
       [--n-exact 100000] [--counts 200000] [--seed 0]
Prints one JSON line.
"""
import argparse
import json
import math

import numpy as np
import torch

__all__ = ["count", "float64_inputs", "main"]


def float64_inputs(n, seed=0):
    """``n`` float64 values log-uniform on ``[e**-20, e**5]``."""
    return np.exp(np.random.default_rng(seed).uniform(-20.0, 5.0, n))


def count(n=400_000, n_exact=100_000, counts=200_000, seed=0):
    """The counts of the module docstring, as a dict."""
    import mpmath

    from pymgrid_tpu_torch.core.prng import _sqrt_f64
    from pymgrid_tpu_torch.utils.optax_adam import bias_correction

    x = float64_inputs(n, seed)
    tx = torch.from_numpy(x)
    ieee_sqrt = np.array([math.sqrt(v) for v in x])
    libm_log = np.array([math.log(v) for v in x])
    torch_log = torch.log(tx).numpy()
    with mpmath.workprec(200):             # float() rounds an mpf to the nearest double
        exact_log = np.array([float(mpmath.log(mpmath.mpf(v))) for v in x[:n_exact]])
    out = {
        "n": n, "n_exact": n_exact, "counts": counts,
        "torch_sqrt_vs_ieee": int((torch.sqrt(tx).numpy() != ieee_sqrt).sum()),
        "sqrt_f64_vs_ieee": int((_sqrt_f64(tx).numpy() != ieee_sqrt).sum()),
        "torch_log_vs_libm": int((torch_log != libm_log).sum()),
        "libm_log_misrounded": int((libm_log[:n_exact] != exact_log).sum()),
        "torch_log_misrounded": int((torch_log[:n_exact] != exact_log).sum()),
    }
    steps = np.arange(1, counts + 1)
    for b in (0.9, 0.999):
        libm = np.array([bias_correction(b, int(c)) for c in steps], np.float32)
        numpy_power = np.float32(1) - np.power(np.float32(b), steps.astype(np.float32))
        out[f"bias_correction_{b}_numpy_vs_libm"] = int((numpy_power != libm).sum())
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=400_000)
    ap.add_argument("--n-exact", type=int, default=100_000)
    ap.add_argument("--counts", type=int, default=200_000)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    print(json.dumps(count(args.n, args.n_exact, args.counts, args.seed)), flush=True)


if __name__ == "__main__":
    main()
