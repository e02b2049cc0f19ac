"""The port's threefry (``pymgrid_tpu_torch/core/prng.py``) against
``jax.random`` on the CPU.

Keys, splits and raw bits are bitwise.  Normals go through XLA's erfinv
polynomials, ported as tensor ops; they differ from JAX only where ``log1p``
rounds differently (measured over 100,000 draws: float32 within 4.8e-7,
99.0% bitwise; float64 within 3.4e-15, 95.4% bitwise).  Both layouts assume
JAX's partitionable threefry, the installed default.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pymgrid_tpu_torch.core import prng

torch.set_num_threads(1)

SEEDS = [0, 1, 42, 2**31 - 1, 123456789]


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


@pytest.mark.parametrize("dtype,atol", [(np.float32, 1e-6), (np.float64, 1e-14)])
def test_uniform_bitwise_and_normal_close(dtype, atol):
    tdt = torch.float32 if dtype == np.float32 else torch.float64
    keys = prng.split(prng.key(0), 100_000)
    jkeys = jax.random.split(_jkey(0), 100_000)
    lo = np.nextafter(dtype(-1), dtype(0))
    got = prng.uniform(keys, (1,), tdt, lo, dtype(1)).numpy()
    want = np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (1,), dtype, lo, dtype(1)))(jkeys))
    np.testing.assert_array_equal(got, want)
    got = prng.normal(keys, (1,), tdt).numpy()
    want = np.asarray(jax.vmap(lambda k: jax.random.normal(k, (1,), dtype))(jkeys))
    assert got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)
    assert np.mean(got == want) > 0.9


@pytest.mark.parametrize("dtype,atol", [(np.float32, 1e-6), (np.float64, 1e-14)])
def test_normal_window_layout(dtype, atol):
    """A ``(h, f)`` draw follows JAX's row-major counters, per key."""
    tdt = torch.float32 if dtype == np.float32 else torch.float64
    for seed in SEEDS:
        for shape in ((23, 1), (23, 4), (4, 4)):
            got = prng.normal(prng.key(seed), shape, tdt).numpy()
            want = np.asarray(jax.random.normal(_jkey(seed), shape, dtype))
            np.testing.assert_allclose(got, want, rtol=0, atol=atol)
    keys = prng.split(prng.key(3), 6).view(2, 3, 2)
    got = prng.normal(keys, (23, 4), tdt).numpy()
    jkeys = jax.random.split(_jkey(3), 6)
    want = np.asarray(jax.vmap(lambda k: jax.random.normal(k, (23, 4), dtype))(jkeys))
    np.testing.assert_allclose(got.reshape(6, 23, 4), want, rtol=0, atol=atol)


def test_erfinv_matches_xla_polynomials():
    for dtype, atol in ((np.float32, 3e-7), (np.float64, 3e-15)):
        x = np.linspace(-1, 1, 20001).astype(dtype)[1:-1]
        got = prng.erfinv(torch.from_numpy(x)).numpy()
        want = np.asarray(jax.lax.erf_inv(jnp.asarray(x)))
        np.testing.assert_allclose(got, want, rtol=0, atol=atol)
        edge = torch.tensor([-1.0, 1.0], dtype=torch.from_numpy(x).dtype)
        assert torch.equal(prng.erfinv(edge), torch.erfinv(edge))


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
