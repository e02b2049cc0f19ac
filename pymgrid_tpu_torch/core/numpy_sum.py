"""Bitwise-compatible emulation of ``np.sum`` over a static-length list.

The reference computes energy balances with ``np.sum`` over Python lists of
float64 scalars (``microgrid/utils/step.py:33-36``).  numpy uses pairwise
summation, whose result differs from a plain left fold in the last ulp for
lists of length >= 8.  The engine reproduces trajectories bit-for-bit, so it
re-creates numpy's exact reduction tree over the (statically known) list of
traced scalars:

* n < 8:           sequential left fold
* 8 <= n <= 128:   eight accumulators, unrolled by 8, sequential remainder
* n > 128:         recursive halving on a multiple-of-8 split

Appending zero-valued entries to a fold is exact (x + 0.0 == x), which is why
masked "absent" contributions can be folded with value 0 when fewer than 8
real entries are present.
"""

__all__ = ["numpy_sum_compat"]


def numpy_sum_compat(values):
    """Sum a list of (traced or concrete) scalars exactly as np.sum would."""
    n = len(values)
    if n == 0:
        return 0.0
    if n < 8:
        res = values[0]
        for v in values[1:]:
            res = res + v
        return res
    if n <= 128:
        r = list(values[:8])
        i = 8
        while i < n - (n % 8):
            for j in range(8):
                r[j] = r[j] + values[i + j]
            i += 8
        res = ((r[0] + r[1]) + (r[2] + r[3])) + ((r[4] + r[5]) + (r[6] + r[7]))
        while i < n:
            res = res + values[i]
            i += 1
        return res
    n2 = (n // 2) - ((n // 2) % 8)
    return numpy_sum_compat(values[:n2]) + numpy_sum_compat(values[n2:])
