"""The port's threefry (``pymgrid_tpu_torch/core/prng.py``) against
``jax.random`` on the CPU.

Keys, splits, raw bits, uniforms and integers are bitwise.  ``erfinv``'s
``log1p`` and ``gumbel``'s ``log`` are XLA's own CPU expansions, so float32
``log``, ``log1p``, ``erfinv``, normals, gumbels and categorical draws are
bitwise too (XLA compiled without FMA contraction, as tests/conftest.py sets
``--xla_cpu_max_isa=AVX``; its runtime reads subnormals as zero, and so does
the port's expansion).  Float64 ``erfinv`` takes the correctly rounded root
(``prng._sqrt_f64``), as XLA does.  Float64 normals are bitwise where
``log1p`` takes Cephes' rational (``u**2 < sqrt(2) - 1``).  Elsewhere
``log1p`` is ``torch.log(1 + x)`` against the libm ``log`` XLA calls: both
are faithfully rounded, so they differ by at most an ulp, every float64 draw
that differs from JAX's is one where the two ``log1p`` differ, and
``test_erfinv_float64_ulp_envelope`` shows that such a 1-ulp change moves
float64 ``erfinv`` by at most ``F64_ERFINV_ULPS`` and ``sqrt(2) * erfinv``
by at most ``F64_ULPS``.  Both layouts assume JAX's partitionable threefry,
the installed default.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pymgrid_tpu_torch.core import prng
from pymgrid_tpu_torch.tools import libm_parity

torch.set_num_threads(1)

SEEDS = [0, 1, 42, 2**31 - 1, 123456789]
# float64 erfinv and normals off Cephes' rational, in ulps (module docstring)
F64_ERFINV_ULPS = 4
F64_ULPS = 5
LOG1P_SMALL = np.sqrt(2) - 1


def _ulps(got, want):
    """Elementwise distance in ulps between two float arrays of one dtype."""
    ints = np.int32 if got.dtype == np.float32 else np.int64
    return np.abs(got.view(ints).astype(np.int64) - want.view(ints).astype(np.int64))


def _assert_f64_normals(got, want, u, ulps=F64_ULPS):
    """Float64 draws of ``u`` (``erfinv(u)`` or ``sqrt(2)`` times it):
    bitwise where ``log1p`` takes its rational; each draw that differs is
    one where the port's ``log1p(-u * u)`` differs from ``jnp.log1p``, so
    it lies off the rational, and it is within ``ulps``.  Returns the count
    of differing draws."""
    small = u * u < LOG1P_SMALL
    np.testing.assert_array_equal(got[small], want[small])
    differ = got != want
    arg = -torch.from_numpy(u) * torch.from_numpy(u)
    log1p_differs = prng._xla_log1p(arg).numpy() != np.asarray(jnp.log1p(jnp.asarray(arg.numpy())))
    assert not (differ & ~log1p_differs).any()
    assert _ulps(got[differ], want[differ]).max(initial=0) <= ulps
    return int(differ.sum())


def test_partitionable_threefry_is_the_layout():
    assert jax.config.jax_threefry_partitionable


def _jkey(seed):
    return jax.random.PRNGKey(seed)


@pytest.mark.parametrize("seed", SEEDS)
def test_key_and_split_bitwise(seed):
    key = prng.key(seed)
    np.testing.assert_array_equal(key.numpy(), np.asarray(_jkey(seed)).astype(np.int64))
    for n in (1, 2, 1024):
        want = np.asarray(jax.random.split(_jkey(seed), n)).astype(np.int64)
        np.testing.assert_array_equal(prng.split(key, n).numpy(), want, err_msg=str(n))
    # a split of split keys maps over the leading axes, as vmap(split) does
    keys = prng.split(key, 5)
    want = np.asarray(jax.vmap(jax.random.split)(jax.random.split(_jkey(seed), 5)))
    np.testing.assert_array_equal(prng.split(keys).numpy(), want.astype(np.int64))


@pytest.mark.parametrize("shape", [(7,), (23, 1), (23, 4), (5, 3, 2)])
def test_bits_bitwise(shape):
    for seed in SEEDS:
        key = prng.key(seed)
        want32 = np.asarray(jax.random.bits(_jkey(seed), shape, jnp.uint32))
        np.testing.assert_array_equal(prng.bits(key, shape, 32).numpy(),
                                      want32.astype(np.int64))
        want64 = np.asarray(jax.random.bits(_jkey(seed), shape, jnp.uint64))
        np.testing.assert_array_equal(prng.bits(key, shape, 64).numpy(),
                                      want64.view(np.int64))


@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["float32", "float64"])
def test_uniform_bitwise_and_normal_close(dtype):
    """Uniforms bitwise over 100,000 split keys; normals bitwise in float32,
    and in float64 bitwise where ``log1p`` takes its rational, within
    ``F64_ULPS`` elsewhere."""
    tdt = torch.float32 if dtype == np.float32 else torch.float64
    keys = prng.split(prng.key(0), 100_000)
    jkeys = jax.random.split(_jkey(0), 100_000)
    lo = np.nextafter(dtype(-1), dtype(0))
    u = prng.uniform(keys, (1,), tdt, lo, dtype(1)).numpy()
    want = np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (1,), dtype, lo, dtype(1)))(jkeys))
    np.testing.assert_array_equal(u, want)
    got = prng.normal(keys, (1,), tdt).numpy()
    want = np.asarray(jax.vmap(lambda k: jax.random.normal(k, (1,), dtype))(jkeys))
    assert got.dtype == want.dtype
    if dtype == np.float32:
        np.testing.assert_array_equal(got, want)
    else:
        assert _assert_f64_normals(got, want, u) <= (u * u >= LOG1P_SMALL).sum()


def _window_uniforms(key, shape, dtype):
    tdt = torch.float32 if dtype == np.float32 else torch.float64
    return prng.uniform(key, shape, tdt, np.nextafter(dtype(-1), dtype(0)), dtype(1)).numpy()


@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["float32", "float64"])
def test_normal_window_layout(dtype):
    """A ``(h, f)`` draw follows JAX's row-major counters, per key: bitwise in
    float32; float64 as in ``test_uniform_bitwise_and_normal_close``."""
    tdt = torch.float32 if dtype == np.float32 else torch.float64

    def check(got, want, key, shape):
        if dtype == np.float32:
            np.testing.assert_array_equal(got, want)
        else:
            _assert_f64_normals(got, want, _window_uniforms(key, shape, dtype))

    for seed in SEEDS:
        for shape in ((23, 1), (23, 4), (4, 4)):
            got = prng.normal(prng.key(seed), shape, tdt).numpy()
            want = np.asarray(jax.random.normal(_jkey(seed), shape, dtype))
            check(got, want, prng.key(seed), shape)
    keys = prng.split(prng.key(3), 6).view(2, 3, 2)
    got = prng.normal(keys, (23, 4), tdt).numpy()
    jkeys = jax.random.split(_jkey(3), 6)
    want = np.asarray(jax.vmap(lambda k: jax.random.normal(k, (23, 4), dtype))(jkeys))
    check(got.reshape(6, 23, 4), want, keys.view(6, 2), (23, 4))


def _f32_grid():
    """A dense float32 grid for ``log`` and ``log1p``: every 4096th bit
    pattern (both signs, subnormals, infinities and NaNs included), 2**20
    points on ``[-1, 8]``, and the edge values: the zeros, -1, the
    infinities, NaN, the smallest normal, a subnormal, ``+-(sqrt(2) - 1)``
    and their neighbours, ``sqrt(1/2)``."""
    patterns = (np.arange(2**20, dtype=np.uint64) * 2**12 + 1234).astype(np.uint32)
    edge = [0.0, -0.0, -1.0, np.inf, -np.inf, np.nan, np.finfo(np.float32).tiny,
            1e-40, -1e-40, 0.70710677]
    for s in (1, -1):
        at = np.float32(s * LOG1P_SMALL)
        edge += [at, np.nextafter(at, np.float32(0)), np.nextafter(at, np.float32(s * 2))]
    return np.concatenate([patterns.view(np.float32),
                           np.linspace(-1, 8, 2**20, dtype=np.float32),
                           np.asarray(edge, np.float32)])


def test_xla_log_and_log1p_float32_bitwise():
    """``_xla_log_f32`` and float32 ``_xla_log1p`` give ``jnp.log`` and
    ``jnp.log1p`` bit for bit, NaN payloads included, on the dense grid."""
    x = _f32_grid()
    for ours, theirs in ((prng._xla_log_f32, jnp.log), (prng._xla_log1p, jnp.log1p)):
        got = ours(torch.from_numpy(x)).numpy()
        want = np.asarray(theirs(jnp.asarray(x)))
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_xla_log1p_float64():
    """Float64 ``_xla_log1p`` against ``jnp.log1p``: bitwise in Cephes'
    rational (``|x| < sqrt(2) - 1``); elsewhere within 1 ulp, because there
    it is ``torch.log(1 + x)`` against the libm ``log`` that XLA calls, and
    two faithfully rounded logs differ by at most an ulp."""
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.standard_normal(2**19) * 0.3, np.linspace(-1, 8, 2**19),
                        [0.0, -0.0, -1.0, np.inf, np.nan, 5e-320, -5e-320,
                         LOG1P_SMALL, -LOG1P_SMALL, np.nextafter(LOG1P_SMALL, 0)]])
    got = prng._xla_log1p(torch.from_numpy(x)).numpy()
    want = np.asarray(jnp.log1p(jnp.asarray(x)))
    small = np.abs(x) < LOG1P_SMALL
    np.testing.assert_array_equal(got[small], want[small])
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    finite = ~small & np.isfinite(want)
    assert _ulps(got[finite], want[finite]).max() <= 1
    np.testing.assert_array_equal(got[~finite & ~small], want[~finite & ~small])


def test_erfinv_matches_xla_polynomials():
    """``erfinv`` against ``jax.lax.erf_inv`` on 19,999 points of (-1, 1):
    float32 bitwise; float64 bitwise where ``log1p`` takes its rational,
    within ``F64_ULPS`` elsewhere; +-1 give +-inf."""
    for dtype in (np.float32, np.float64):
        x = np.linspace(-1, 1, 20001).astype(dtype)[1:-1]
        got = prng.erfinv(torch.from_numpy(x)).numpy()
        want = np.asarray(jax.lax.erf_inv(jnp.asarray(x)))
        if dtype == np.float32:
            np.testing.assert_array_equal(got, want)
        else:
            _assert_f64_normals(got, want, x, F64_ERFINV_ULPS)
        edge = torch.tensor([-1.0, 1.0], dtype=torch.from_numpy(x).dtype)
        assert torch.equal(prng.erfinv(edge), torch.erfinv(edge))


def test_erfinv_float64_ulp_envelope(monkeypatch):
    """Where float64 ``erfinv`` leaves Cephes' rational, its ``log1p`` may
    differ from XLA's by an ulp (module docstring; its root is IEEE's).
    Such a change moves ``erfinv`` by at most ``F64_ERFINV_ULPS`` and
    ``sqrt(2) * erfinv`` by at most ``F64_ULPS`` on a dense grid of that
    range, the branch points at ``w = 6.25`` and ``16`` included: the bound
    is the polynomials', not a host's."""
    x = np.concatenate([np.linspace(0.64, 1, 2**19, endpoint=False),
                        1 - np.geomspace(1e-16, 1e-3, 2**17)])
    x = np.concatenate([x, -x])
    log1p = prng._xla_log1p
    base = prng.erfinv(torch.from_numpy(x)).numpy()
    for toward in (np.inf, -np.inf):
        monkeypatch.setattr(prng, "_xla_log1p",
                            lambda t: torch.nextafter(log1p(t), torch.full_like(t, toward)))
        got = prng.erfinv(torch.from_numpy(x)).numpy()
        monkeypatch.undo()
        assert _ulps(got, base).max() <= F64_ERFINV_ULPS
        assert _ulps(np.sqrt(2) * got, np.sqrt(2) * base).max() <= F64_ULPS


def _sqrt_f64_inputs():
    """400,000 float64 inputs log-uniform on ``[e**-20, e**5]`` (erfinv's
    ``w`` lies there), 400,000 bit patterns over every positive finite
    float64, subnormals included, and the edge values."""
    rng = np.random.default_rng(0)
    tiny = np.finfo(np.float64).tiny
    edge = [0.0, -0.0, np.inf, -np.inf, np.nan, -1.0, 5e-324, tiny, tiny / 2,
            np.finfo(np.float64).max, 1.0, np.nextafter(1.0, 0), np.nextafter(1.0, 2), 2.0,
            4.0, np.nextafter(4.0, 0), 6.25, 16.0, 2.0**500, np.nextafter(2.0**500, 0),
            np.nextafter(2.0**500, np.inf), 2.0**-500, np.nextafter(2.0**-500, 0), 1e-310]
    patterns = rng.integers(1, 0x7FF0000000000000, 400_000, dtype=np.int64).view(np.float64)
    return np.concatenate([np.exp(rng.uniform(-20, 5, 400_000)), patterns, edge])


@pytest.mark.parametrize("off", [None, np.inf, -np.inf], ids=["torch", "ulp_up", "ulp_down"])
def test_sqrt_f64_is_ieee(monkeypatch, off):
    """``_sqrt_f64`` equals ``math.sqrt`` (the IEEE root, as XLA's) at every
    input, zeros' signs, infinities and NaNs included, starting from
    ``torch.sqrt`` or from the IEEE root moved an ulp either way (a root it
    starts from may be an ulp off, as the CPU torch's is at some inputs)."""
    x = _sqrt_f64_inputs()
    want = np.array([math.sqrt(v) if not v < 0 else np.nan for v in x])
    if off is not None:
        def sqrt(t):
            with np.errstate(invalid="ignore"):
                ieee = torch.from_numpy(np.sqrt(t.numpy()))
            finite = (t > 0) & (t < np.inf)
            return torch.where(finite, torch.nextafter(ieee, torch.full_like(t, off)), ieee)

        monkeypatch.setattr(torch, "sqrt", sqrt)
    got = prng._sqrt_f64(torch.from_numpy(x)).numpy()
    monkeypatch.undo()
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    np.testing.assert_array_equal(got[~nan].view(np.int64), want[~nan].view(np.int64))


@pytest.mark.parametrize("logits", ["normal", "equal"])
def test_gumbel_and_categorical_bitwise(logits):
    """Float32 ``gumbel`` and ``categorical`` over 4096 split keys give
    ``jax.random.gumbel`` and ``jax.vmap(jax.random.categorical)`` bit for
    bit, for normal logits and for equal ones, where the gumbels alone
    decide."""
    keys, jkeys = prng.split(prng.key(17), 4096), jax.random.split(_jkey(17), 4096)
    got = prng.gumbel(keys, (6,), torch.float32).numpy()
    want = np.asarray(jax.vmap(lambda k: jax.random.gumbel(k, (6,), jnp.float32))(jkeys))
    np.testing.assert_array_equal(got, want)
    rows = np.random.default_rng(3).standard_normal((4096, 6)).astype(np.float32)
    if logits == "equal":
        rows = np.full_like(rows, 0.25)
    got = prng.categorical(keys, torch.from_numpy(rows)).numpy()
    want = np.asarray(jax.vmap(jax.random.categorical)(jkeys, jnp.asarray(rows)))
    np.testing.assert_array_equal(got, want)


FOLD_DATA = [0, 1, 7, 0x51A7, 2**31 - 1, 2**31, 2**32 - 1]


@pytest.mark.parametrize("data", FOLD_DATA)
def test_fold_in_bitwise(data):
    """``fold_in`` over a single key, 64 split keys and a ``(2, 3)`` batch of
    keys, for ``data`` up to 2**32 - 1."""
    np.testing.assert_array_equal(
        prng.fold_in(prng.key(42), data).numpy(),
        np.asarray(jax.random.fold_in(_jkey(42), np.uint32(data))).astype(np.int64))
    keys, jkeys = prng.split(prng.key(5), 64), jax.random.split(_jkey(5), 64)
    want = jax.vmap(lambda k: jax.random.fold_in(k, np.uint32(data)))(jkeys)
    np.testing.assert_array_equal(prng.fold_in(keys, data).numpy(),
                                  np.asarray(want).astype(np.int64))
    np.testing.assert_array_equal(prng.fold_in(keys[:6].view(2, 3, 2), data).numpy(),
                                  np.asarray(want[:6]).reshape(2, 3, 2).astype(np.int64))


# spans of 1, 2, 8, 8759 (a year of starts) and above 2**16, where int32's
# uint32 multiplier wraps to 0; the full int32 range; maxval <= minval
SPANS = [(0, 1), (0, 2), (0, 8), (0, 8759), (3, 65539), (0, 65537), (5, 200_000),
         (-100, 2**31 - 1), (-2**31, 2**31 - 1), (10, 10), (10, 3)]


@pytest.mark.parametrize("dtype", ["int32", "int64"])
@pytest.mark.parametrize("minval,maxval", SPANS)
def test_randint_bitwise(minval, maxval, dtype):
    """``randint`` in int32 and in int64 (JAX's default ``int`` under
    ``jax_enable_x64``) over 256 keys, shapes ``()`` and ``(3,)``."""
    keys, jkeys = prng.split(prng.key(9), 256), jax.random.split(_jkey(9), 256)
    for shape in ((), (3,)):
        got = prng.randint(keys, shape, minval, maxval, getattr(torch, dtype)).numpy()
        want = np.asarray(jax.vmap(
            lambda k: jax.random.randint(k, shape, minval, maxval, getattr(jnp, dtype)))(jkeys))
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want, err_msg=str(shape))
    if maxval <= minval:
        assert (got == minval).all()


@pytest.mark.parametrize("dtype", ["int32", "int64"])
def test_randint_per_element_bounds(dtype):
    """Bounds that vary per key, as the suite's per-config ``initial_step``
    does, broadcast from ``(C, 1)`` over ``(C, B)`` keys."""
    keys, jkeys = prng.split(prng.key(3), 300), jax.random.split(_jkey(3), 300)
    lo = np.arange(300) * 37 - 50
    hi = lo + np.arange(300) * 1000
    jdt = getattr(jnp, dtype)
    got = prng.randint(keys, (), torch.as_tensor(lo), torch.as_tensor(hi),
                       getattr(torch, dtype)).numpy()
    want = jax.vmap(lambda k, a, b: jax.random.randint(k, (), a, b, jdt))(
        jkeys, jnp.asarray(lo, jdt), jnp.asarray(hi, jdt))
    np.testing.assert_array_equal(got, np.asarray(want))
    rows = prng.randint(keys.view(30, 10, 2), (), torch.as_tensor(lo[::10]).view(30, 1), 9000,
                        getattr(torch, dtype))
    want = jax.vmap(lambda k, a: jax.random.randint(k, (), a, 9000, jdt))(
        jkeys, jnp.asarray(np.repeat(lo[::10], 10), jdt))
    np.testing.assert_array_equal(rows.numpy().reshape(-1), np.asarray(want))


def test_libm_parity_tool():
    """``tools/libm_parity.py`` at a small size: the port's float64 root is
    the IEEE root at every input, and JAX's float64 ``log`` is the C
    library's (what the tool's ``log`` counts stand for)."""
    out = libm_parity.count(n=20_000, n_exact=2_000, counts=2_000)
    assert out["sqrt_f64_vs_ieee"] == 0 and out["n"] == 20_000
    assert all(isinstance(v, int) and v >= 0 for v in out.values())
    x = libm_parity.float64_inputs(20_000)
    np.testing.assert_array_equal(np.asarray(jnp.log(jnp.asarray(x))),
                                  np.array([math.log(v) for v in x]))
