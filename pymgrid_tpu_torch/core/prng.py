"""Threefry-2x32 random numbers that equal ``jax.random``'s.

The part of ``jax.random`` the engine and the training programs use
(``PRNGKey``, ``split``, ``fold_in``, the raw ``bits``, ``uniform``,
``randint``, ``normal``, ``gumbel`` and ``categorical``) in plain tensor ops,
so the port draws the same gaussian forecast noise, random-policy actions,
randomized suite starts, initial weights, exploration noise and sampled
actions as the JAX package for the same seed, on any device.

A key is an int64 tensor ``(..., 2)`` holding two uint32 words, as
``jax.random.PRNGKey`` returns them (the raw, non-typed key).  Every function
maps over the key's leading axes: a ``(C, B, 2)`` key tensor gives each
replica its own stream with no loop and no host sync.  The layout is JAX's
partitionable one (``jax_threefry_partitionable=True``, the default since JAX
0.5): the counter of element ``i`` of a flattened shape is the 64-bit ``i``,
split into its high and low words.

Threefry needs only 32-bit add, rotate and xor.  Here the words live in int64
and are masked to 32 bits after every add and left shift; right shifts only
see non-negative values, so the arithmetic ``>>`` of int64 is the logical
one; ``randint``'s uint32 products and sums are masked the same way, so
they wrap as JAX's do.  ``normal`` builds uniforms in ``[nextafter(-1, 0),
1)`` from the top mantissa bits as JAX does and maps them through the erfinv
polynomials XLA uses (M. Giles, "Approximating the erfinv function", GPU
Computing Gems Jade, 2011).  ``erfinv``'s ``log1p`` and ``gumbel``'s ``log``
are XLA's own CPU expansions (Cephes' ``log1p`` rational and ``logf``
polynomial), one tensor op per IEEE operation in XLA's order, with XLA's
CPU flush of subnormals to zero at their inputs.  Keys, bits, uniforms,
integers and the float32 normals, gumbels and categorical draws are bitwise
equal to ``jax.random`` on the CPU (XLA compiled without FMA contraction, as
``--xla_cpu_max_isa=AVX`` compiles it), and the same bits on a CUDA device,
where every op rounds once.  Float64 erfinv takes the correctly rounded
root, as XLA does (``_sqrt_f64``).  Float64 normals are bitwise where
``log1p`` takes its rational (``u**2 < sqrt(2) - 1``); elsewhere ``log1p``
is ``torch.log(1 + x)``, which can differ in the last bit from the libm
``log`` XLA uses, and only there do the normals differ
(tests/test_torch_prng.py bounds the gap).
"""
import math

import numpy as np
import torch

from pymgrid_tpu_torch.utils.profiling import count, span

__all__ = ["key", "split", "fold_in", "bits", "uniform", "randint", "normal", "gumbel",
           "categorical", "erfinv", "threefry2x32"]

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r):
    return ((x << r) & _MASK) | (x >> (32 - r))


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash (20 rounds) of the counter words ``(x1, x2)``
    under the key words ``(k1, k2)``; all int64 tensors of uint32 values
    that broadcast together.  Returns the two output words."""
    with span("pymgrid.prng.threefry"):
        ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
        x1 = (x1 + ks[0]) & _MASK
        x2 = (x2 + ks[1]) & _MASK
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x1 = (x1 + x2) & _MASK
                x2 = _rotl(x2, r) ^ x1
            x1 = (x1 + ks[(i + 1) % 3]) & _MASK
            x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & _MASK
        count("pymgrid.prng.threefry_words", x1.numel())
        return x1, x2


def key(seed, device="cpu"):
    """``jax.random.PRNGKey(seed)`` (64-bit seeds, as under ``jax_enable_x64``;
    the same key for any seed in ``[0, 2**31)`` either way): ``(2,)`` int64."""
    seed = int(seed)
    return torch.tensor([(seed >> 32) & _MASK, seed & _MASK], dtype=torch.int64,
                        device=device)


def _counters(shape, device):
    """JAX's ``iota_2x32_shape``: the row-major flat index of every element
    of ``shape`` as (high word, low word)."""
    n = math.prod(shape)
    flat = torch.arange(n, dtype=torch.int64, device=device).view(shape)
    return flat >> 32, flat & _MASK


def _hash(key, shape):
    """Threefry of the counters of ``shape`` under every key of
    ``key (..., 2)``: two words of shape ``key.shape[:-1] + shape``."""
    shape = tuple(shape)
    hi, lo = _counters(shape, key.device)
    lead = key.shape[:-1] + (1,) * len(shape)
    return threefry2x32(key[..., 0].reshape(lead), key[..., 1].reshape(lead), hi, lo)


def split(key, num=2):
    """``jax.random.split``: ``(..., 2)`` keys -> ``(..., num, 2)``."""
    b1, b2 = _hash(key, (num,))
    return torch.stack([b1, b2], dim=-1)


def fold_in(key, data):
    """``jax.random.fold_in``: the hash of the counter words ``(0, data)``
    under each key of ``key (..., 2)`` (``threefry_seed`` of a 32-bit
    ``data``), as the new key ``(..., 2)``.  ``data`` is taken mod 2**32,
    as JAX's conversion to uint32 takes it."""
    x1, x2 = threefry2x32(key[..., 0], key[..., 1], 0, int(data) & _MASK)
    return torch.stack([x1, x2], dim=-1)


def bits(key, shape, width=32):
    """``jax.random.bits`` of ``width`` 32 (uint32 values in int64) or 64
    (the uint64 bit pattern as int64, two's complement) for every key of
    ``key (..., 2)``: ``key.shape[:-1] + shape``."""
    b1, b2 = _hash(key, shape)
    if width == 32:
        return b1 ^ b2
    if width == 64:
        hi = torch.where(b1 >= 2**31, b1 - 2**32, b1)   # signed high word
        return (hi * 2**32) | b2
    raise ValueError(f"width must be 32 or 64, got {width}")


def uniform(key, shape, dtype, minval=0.0, maxval=1.0):
    """``jax.random.uniform`` in float32 or float64: the top mantissa bits
    under the exponent of 1.0, minus 1, scaled into ``[minval, maxval)``."""
    b1, b2 = _hash(key, shape)
    if dtype == torch.float32:
        mant = ((b1 ^ b2) >> 9) | 0x3F800000
        floats = mant.to(torch.int32).view(torch.float32)
    elif dtype == torch.float64:
        # the top 52 bits of (b1 << 32) | b2, under the exponent of 1.0
        mant = 0x3FF0000000000000 | (b1 << 20) | (b2 >> 12)
        floats = mant.view(torch.float64)
    else:
        raise ValueError(f"uniform draws float32 or float64, got {dtype}")
    lo = torch.as_tensor(np.asarray(minval, dtype=_np(dtype)), device=key.device)
    hi = torch.as_tensor(np.asarray(maxval, dtype=_np(dtype)), device=key.device)
    floats = floats - torch.ones((), dtype=dtype, device=key.device)
    return torch.maximum(lo, floats * (hi - lo) + lo)


def _mulmod(a, b, m):
    """``(a * b) % m`` exactly for int64 tensors ``0 <= a, b < m < 2**32``
    (``b`` in 16-bit halves, so no product reaches 2**63)."""
    return (torch.remainder(a * (b >> 16), m) * 65536 + a * (b & 0xFFFF)) % m


def randint(key, shape, minval, maxval, dtype=torch.int32):
    """``jax.random.randint``: ``key.shape[:-1] + shape`` integers in
    ``[minval, maxval)`` (``minval`` where ``maxval <= minval``), the bounds
    numbers or int tensors in the int32 range that broadcast against that
    shape.

    ``dtype`` is JAX's: ``torch.int32``, or ``torch.int64``, which is what
    JAX's default ``int`` means under ``jax_enable_x64``.  Each value takes
    two draws of the dtype's width, folded by JAX's modular span.  In int32
    every uint32 product and sum wraps mod 2**32 as JAX's does (masked after
    each ``*`` and ``+``; the products stay below 2**62 in int64).  In int64
    the uint64 arithmetic cannot wrap for these spans (below 2**32), and is
    computed exactly from 32-bit words."""
    shape = tuple(shape)
    as_bound = lambda v: torch.as_tensor(v, dtype=torch.int64, device=key.device)  # noqa: E731
    lo, hi = as_bound(minval), as_bound(maxval)
    span = torch.broadcast_to(torch.where(hi <= lo, torch.ones_like(hi), hi - lo),
                              key.shape[:-1] + shape)
    pair = split(key)
    width = {torch.int32: 32, torch.int64: 64}[dtype]
    higher = bits(pair[..., 0, :], shape, width)
    lower = bits(pair[..., 1, :], shape, width)
    if width == 64:
        high_word = (2**32) % span

        def rem(x):  # a uint64 bit pattern (int64) mod span
            words = ((x >> 32) & _MASK) % span, (x & _MASK) % span
            return (_mulmod(words[0], high_word, span) + words[1]) % span

        multiplier = _mulmod(high_word, high_word, span)
        return lo + (_mulmod(rem(higher), multiplier, span) + rem(lower)) % span
    multiplier = ((2**16 % span) ** 2 & _MASK) % span   # 0 for a span above 2**16
    offset = (((higher % span) * multiplier & _MASK) + lower % span & _MASK) % span
    value = (lo + offset) & _MASK                        # int32 addition wraps
    return torch.where(value > torch.iinfo(torch.int32).max, value - 2**32,
                       value).to(torch.int32)


def normal(key, shape, dtype):
    """``jax.random.normal``: ``sqrt(2) * erfinv(u)`` with ``u`` uniform in
    ``[nextafter(-1, 0), 1)``; shape ``key.shape[:-1] + shape``."""
    npd = _np(dtype)
    lo = np.nextafter(np.array(-1.0, npd), np.array(0.0, npd))
    u = uniform(key, shape, dtype, lo, np.array(1.0, npd))
    sqrt2 = torch.as_tensor(np.array(np.sqrt(2), npd), device=key.device)
    return sqrt2 * erfinv(u)


def gumbel(key, shape, dtype):
    """``jax.random.gumbel`` (its default ``mode="low"``):
    ``-log(-log(u))`` with ``u`` uniform in ``[tiny, 1)``; shape
    ``key.shape[:-1] + shape``.  In float32 both logs are XLA's
    (``_xla_log_f32``), so the draw is JAX's bit for bit; float64 uses
    ``torch.log``, which can differ in the last bit from the libm ``log``
    XLA calls, so float64 gumbels can differ from JAX's."""
    npd = _np(dtype)
    u = uniform(key, shape, dtype, np.finfo(npd).tiny, np.array(1.0, npd))
    log = _xla_log_f32 if dtype == torch.float32 else torch.log
    return -log(-log(u))


def categorical(key, logits):
    """``jax.vmap(jax.random.categorical)`` over the keys ``(..., 2)`` and
    their rows of ``logits (..., n)``: the Gumbel-max draw
    ``argmax(gumbel + logits)``, the first index on a tie; int64
    ``(...)``."""
    return torch.argmax(gumbel(key, logits.shape[-1:], logits.dtype) + logits, dim=-1)


def _np(dtype):
    return np.float32 if dtype == torch.float32 else np.float64


# Giles' polynomial coefficients, highest degree first, as XLA evaluates them.
_F32 = (
    (5.0, 2.5, 3.0),
    (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
     0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941),
    (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
     0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682),
)
_F64_LT_6_25 = (
    -3.6444120640178196996e-21, -1.685059138182016589e-19,
    1.2858480715256400167e-18, 1.115787767802518096e-17,
    -1.333171662854620906e-16, 2.0972767875968561637e-17,
    6.6376381343583238325e-15, -4.0545662729752068639e-14,
    -8.1519341976054721522e-14, 2.6335093153082322977e-12,
    -1.2975133253453532498e-11, -5.4154120542946279317e-11,
    1.051212273321532285e-09, -4.1126339803469836976e-09,
    -2.9070369957882005086e-08, 4.2347877827932403518e-07,
    -1.3654692000834678645e-06, -1.3882523362786468719e-05,
    0.0001867342080340571352, -0.00074070253416626697512,
    -0.0060336708714301490533, 0.24015818242558961693,
    1.6536545626831027356,
)
_F64_LT_16 = (
    2.2137376921775787049e-09, 9.0756561938885390979e-08,
    -2.7517406297064545428e-07, 1.8239629214389227755e-08,
    1.5027403968909827627e-06, -4.013867526981545969e-06,
    2.9234449089955446044e-06, 1.2475304481671778723e-05,
    -4.7318229009055733981e-05, 6.8284851459573175448e-05,
    2.4031110387097893999e-05, -0.0003550375203628474796,
    0.00095328937973738049703, -0.0016882755560235047313,
    0.0024914420961078508066, -0.0037512085075692412107,
    0.005370914553590063617, 1.0052589676941592334,
    3.0838856104922207635,
)
_F64_GE_16 = (
    -2.7109920616438573243e-11, -2.5556418169965252055e-10,
    1.5076572693500548083e-09, -3.7894654401267369937e-09,
    7.6157012080783393804e-09, -1.4960026627149240478e-08,
    2.9147953450901080826e-08, -6.7711997758452339498e-08,
    2.2900482228026654717e-07, -9.9298272942317002539e-07,
    4.5260625972231537039e-06, -1.9681778105531670567e-05,
    7.5995277030017761139e-05, -0.00021503011930044477347,
    -0.00013871931833623122026, 1.0103004648645343977,
    4.8499064014085844221,
)


def _horner(coeffs, w):
    """Evaluate a polynomial per element, where ``coeffs`` holds, degree by
    degree, one tensor (or number) per branch already selected."""
    p = coeffs[0]
    for c in coeffs[1:]:
        p = c + p * w
    return p


# XLA's CPU ``log`` in float32 (``jnp.log``; XLA's replacement of
# ``llvm.log.f32``): Cephes' ``logf`` minimax polynomial in ``m - 1``, highest
# degree first, and ln(2) in two parts (0.693359375 + -2.12194440e-4).
_LOG_F32 = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
            1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
            3.3333331174e-1)
_LN2_HI, _LN2_LO = 0.693359375, -2.12194440e-4
_SQRT_HALF_F32 = 0.70710677
# XLA's CPU ``log1p`` (the ``xla.log1p`` intrinsic, float32 and float64):
# Cephes' ``log1p`` rational for ``|x| < sqrt(2) - 1``, numerator and
# denominator highest degree first (float32 takes them rounded to float32).
_LOG1P_P = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
            6.5787325942061044846969e0, 2.9911919328553073277375e1,
            6.0949667980987787057556e1, 5.7112963590585538103336e1,
            2.0039553499201281259648e1)
_LOG1P_Q = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
            2.2176239823732856465394e2, 3.0909872225312059774938e2,
            2.1642788614495947685003e2, 6.0118660497603843919306e1)
_LOG1P_SMALL = 0.41421356237309504880


def _f32(v):
    """``v`` rounded to float32, as a Python float (exact in float64)."""
    return float(np.float32(v))


def _flush_subnormal(x):
    """XLA's CPU runtime computes with subnormals read as zero: ``x`` with
    every subnormal replaced by the zero of its sign."""
    tiny = float(np.finfo(_np(x.dtype)).tiny)
    return torch.where(x.abs() < tiny, x * 0.0, x)


def _xla_log_f32(x):
    """XLA's float32 ``log`` on the CPU, bit for bit: ``x`` split as
    ``2**e * m`` with ``m`` in ``[sqrt(1/2), sqrt(2))`` through its int32
    bits, Cephes' polynomial in ``m - 1`` in XLA's pairing order (three
    degree-2 Horner chains joined through ``(m - 1)**3``), the exponent added
    in two parts; NaN below 0, ``-inf`` at 0, ``inf`` at ``inf``.  Every step
    is its own tensor op, so each rounds once, on any device."""
    x = _flush_subnormal(x)
    tiny = _f32(np.finfo(np.float32).tiny)
    bits = torch.where(x > tiny, x, tiny).view(torch.int32)
    m = ((bits & 0x7FFFFF) | 0x3F000000).view(torch.float32)   # in [0.5, 1)
    e = ((bits >> 23) - 127).to(torch.float32) + 1.0
    below = m < _f32(_SQRT_HALF_F32)
    e = e - below.to(torch.float32)
    m = (m - 1.0) + torch.where(below, m, 0.0)
    m2 = m * m
    m3 = m2 * m
    c = [_f32(v) for v in _LOG_F32]
    a, b, d = (m * c[i] + c[i + 1] for i in (0, 3, 6))
    a, b, d = a * m + c[2], b * m + c[5], d * m + c[8]
    poly = ((a * m3 + b) * m3 + d) * m3
    y = (m - m2 * 0.5) + (poly + e * _f32(_LN2_LO))
    y = (y + e * _f32(_LN2_HI)).view(torch.int32)
    nan, inf, ninf = -1, 0x7F800000, -0x800000          # 0xFFFFFFFF, +-inf bits
    y = torch.where(x > 0, y, nan)                      # below 0 and NaN
    y = torch.where(x == np.inf, inf, y)
    return torch.where(x == 0, ninf, y).view(torch.float32)


def _xla_log1p(x):
    """XLA's ``log1p`` on the CPU for float32 and float64: Cephes' rational
    where ``|x| < sqrt(2) - 1``, with both Horner chains started as
    ``0 * x + c0`` as XLA writes them, and ``log(1 + x)`` elsewhere.
    Float32 is bitwise (``_xla_log_f32``); float64 is bitwise in the
    rational, while its ``log(1 + x)`` is ``torch.log``, which can differ
    from the libm ``log`` XLA calls in the last bit."""
    f = _f32 if x.dtype == torch.float32 else float
    x = _flush_subnormal(x)
    x2 = x * x
    zero = x * 0.0
    p, q = zero + f(_LOG1P_P[0]), zero + f(_LOG1P_Q[0])
    for cp, cq in zip(_LOG1P_P[1:], _LOG1P_Q[1:]):
        p, q = p * x + f(cp), q * x + f(cq)
    small = x + (x2 * -0.5 + (x * x2) * (p / q))
    one_plus = x + 1.0
    large = _xla_log_f32(one_plus) if x.dtype == torch.float32 else torch.log(one_plus)
    return torch.where(x.abs() < f(_LOG1P_SMALL), small, large)


def _sqrt_f32(x):
    """The correctly rounded float32 square root, as XLA's ``sqrt`` is, on
    any device (``torch.sqrt`` on the CPU goes through a vector library that
    is off by an ulp at some inputs): the float64 root rounded to float32,
    moved one ulp where the exact float64 square of the midpoint to a
    neighbour says the root lies beyond it."""
    s = torch.sqrt(x.double()).float()
    xd, sd = x.double(), s.double()
    for toward, beyond in ((np.inf, torch.gt), (0.0, torch.lt)):
        n = torch.nextafter(s, torch.full_like(s, toward))
        mid = (sd + n.double()) * 0.5                  # exact: 25 bits
        s = torch.where(beyond(xd, mid * mid), n, s)   # mid * mid exact: 50 bits
    return s


# Veltkamp's splitter for float64: ``(2**27 + 1) * v`` splits ``v`` into two
# halves of 26 bits each whose products are exact.
_VELTKAMP = 134217729.0


def _two_product(a, b):
    """``a * b`` as ``p + q`` with ``p = fl(a * b)`` and ``q`` its exact
    rounding error (Dekker's product over Veltkamp's split, no FMA); exact
    for float64 operands whose products neither overflow nor underflow."""
    def halves(v):
        c = v * _VELTKAMP
        hi = c - (c - v)
        return hi, v - hi

    p = a * b
    (ah, al), (bh, bl) = halves(a), halves(b)
    return p, (((ah * bh - p) + ah * bl) + al * bh) + al * bl


def _sqrt_f64(x):
    """The correctly rounded float64 square root, as XLA's ``sqrt`` is, on
    any device (the CPU torch's ``sqrt`` is off by an ulp at some inputs;
    on the card it is IEEE's already and this changes nothing).  ``x`` is
    scaled by an even power of two into ``[2**-500, 2**500]``, where the
    products below are exact; the root ``r`` is moved one ulp up where ``x
    > r * next(r)`` and down where ``x <= prev(r) * r``, both compared
    exactly through ``_two_product`` (``x - p`` is exact as ``p`` is near
    ``x``).  For neighbours ``a < b``, ``a * b`` is their midpoint's square
    less ``(b - a)**2 / 4``, which lies below the granularity of ``x - a *
    b``: comparing ``x`` with ``a * b`` tells on which side of the midpoint
    the root lies.  Zeros, negatives, ``inf`` and NaN are ``torch.sqrt``'s;
    a subnormal is a real input, not zero."""
    big, small = x > 2.0**500, x < 2.0**-500
    xs = torch.where(big, x * 2.0**-600, torch.where(small, x * 2.0**600, x))
    r = torch.sqrt(xs)
    up, down = torch.nextafter(r, torch.full_like(r, np.inf)), torch.nextafter(r, r * 0.0)
    p, q = _two_product(r, up)
    r = torch.where(xs - p > q, up, r)
    p, q = _two_product(down, r)
    r = torch.where(xs - p <= q, down, r)
    r = torch.where(big, r * 2.0**300, torch.where(small, r * 2.0**-300, r))
    return torch.where((x > 0) & (x < np.inf), r, torch.sqrt(x))


def erfinv(x):
    """XLA's ``erf_inv`` for float32 and float64 tensors."""
    dt = x.dtype
    const = lambda v: torch.as_tensor(np.asarray(v, dtype=_np(dt)), device=x.device)
    w = -_xla_log1p(-x * x)
    if dt == torch.float32:
        (split_at, shift_lo, shift_hi), lo, hi = _F32
        small = w < const(split_at)
        w = torch.where(small, w - const(shift_lo), _sqrt_f32(w) - const(shift_hi))
        coeffs = [torch.where(small, const(a), const(b)) for a, b in zip(lo, hi)]
    else:
        lt_6 = w < const(6.25)
        lt_16 = w < const(16.0)
        sq = _sqrt_f64(w)
        w = torch.where(lt_6, w - const(3.125),
                        torch.where(lt_16, sq - const(3.25), sq - const(5.0)))
        n = len(_F64_LT_6_25)
        pad = lambda cs: (0.0,) * (n - len(cs)) + tuple(cs)
        coeffs = [
            torch.where(lt_6, const(a), torch.where(lt_16, const(b), const(c)))
            for a, b, c in zip(_F64_LT_6_25, pad(_F64_LT_16), pad(_F64_GE_16))
        ]
    result = _horner(coeffs, w) * x
    edge = x.abs() == const(1.0)
    return torch.where(edge, x * const(np.inf), result)
