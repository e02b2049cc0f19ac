"""The port's ``optax.adam`` (``pymgrid_tpu_torch/utils/optax_adam.py``)
against optax on the CPU.

The JAX training programs call ``optax.adam`` inside ``jax.jit`` and without
``jax_enable_x64``, so optax runs here jitted inside ``jax.enable_x64(False)``
(XLA compiles ``(mu / bc1) / (sqrt(nu / bc2) + eps)`` as ``mu / (bc1 *
(...))``; optax dispatched op by op rounds ``mu / bc1`` on its own and
differs in the last bit at some entries).  Parameters and first moments are
bitwise; second moments too wherever they are at least ``2**-100``: XLA's
runtime flushes subnormal intermediates to zero, which changes the last bits
of a moment below ``2**-126 * 2**24`` and nothing that reaches a parameter.
"""
import io

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pymgrid_tpu_torch.utils.optax_adam import Adam, bias_correction

torch.set_num_threads(1)

SHAPES = [(64, 48), (48,), (2000,), (7,)]
UNCHANGED = 3            # this parameter's gradient is zero at every step
NU_EXACT_FROM = 2.0**-100


def _gradient_stream(seed, n_steps, dtype=np.float32):
    """Per step one gradient per parameter: normals scaled by ``10**k``,
    ``k`` uniform in ``[-30, 3]`` per entry, a tenth of the entries zero,
    and the parameter ``UNCHANGED`` all zeros."""
    rng = np.random.default_rng(seed)
    stream = []
    for _ in range(n_steps):
        grads = []
        for i, shape in enumerate(SHAPES):
            g = rng.standard_normal(shape) * 10.0 ** rng.uniform(-30, 3, shape)
            g[rng.random(shape) < 0.1] = 0.0
            grads.append(np.zeros(shape) if i == UNCHANGED else g)
        stream.append([g.astype(dtype) for g in grads])
    return [rng.standard_normal(s).astype(dtype) for s in SHAPES], stream


def _optax_run(params, stream, lr, x64=False):
    """optax.adam jitted, as the JAX programs call it: the parameters after
    every step, and the final state."""
    with jax.enable_x64(x64):
        opt = optax.adam(lr)

        @jax.jit
        def step(p, state, g):
            updates, state = opt.update(g, state)
            return optax.apply_updates(p, updates), state

        p = [jnp.asarray(x) for x in params]
        state = opt.init(p)
        history = []
        for grads in stream:
            p, state = step(p, state, [jnp.asarray(g) for g in grads])
            history.append([np.asarray(x) for x in p])
        return history, state[0]


def _port_params(params):
    return [torch.nn.Parameter(torch.from_numpy(x.copy())) for x in params]


def _port_steps(opt, tparams, stream):
    history = []
    for grads in stream:
        for p, g in zip(tparams, grads):
            p.grad = torch.from_numpy(g)
        opt.step()
        history.append([p.detach().numpy().copy() for p in tparams])
    return history


@pytest.mark.parametrize("seed,lr", [(0, 0.02), (1, 3e-4), (2, 1.0)])
def test_adam_steps_are_optax_bitwise(seed, lr):
    """12 steps of float32 gradients from 1e-30 to 1e3 with zeros: every
    step's parameters equal optax's; the one with zero gradients stays put;
    the moments as the module docstring says."""
    params, stream = _gradient_stream(seed, 12)
    want, jstate = _optax_run(params, stream, lr)
    tparams = _port_params(params)
    opt = Adam(tparams, lr)
    got = _port_steps(opt, tparams, stream)
    for step, (g_step, w_step) in enumerate(zip(got, want)):
        for i, (g, w) in enumerate(zip(g_step, w_step)):
            np.testing.assert_array_equal(g, w, err_msg=f"step {step}, parameter {i}")
    np.testing.assert_array_equal(got[-1][UNCHANGED], params[UNCHANGED])
    assert int(jstate.count) == 12
    for p, mu, nu in zip(tparams, jstate.mu, jstate.nu):
        state = opt.state[p]
        assert state["step"] == 12
        np.testing.assert_array_equal(state["mu"].numpy(), np.asarray(mu))
        exact = np.asarray(nu) >= NU_EXACT_FROM
        np.testing.assert_array_equal(state["nu"].numpy()[exact], np.asarray(nu)[exact])


def test_adam_float64_matches_optax_under_x64():
    """Float64 parameters: the steps equal optax's under ``jax_enable_x64``
    (bias corrections in float64, the correctly rounded float64 root)."""
    params, stream = _gradient_stream(5, 12, np.float64)
    want, _ = _optax_run(params, stream, 0.02, x64=True)
    tparams = _port_params(params)
    got = _port_steps(Adam(tparams, 0.02), tparams, stream)
    for g_step, w_step in zip(got, want):
        for g, w in zip(g_step, w_step):
            assert g.dtype == np.float64
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("decay", [0.9, 0.999])
def test_bias_corrections_are_jax(decay):
    """``1 - decay ** count`` for counts 1..200,000, jitted as optax
    computes it: float32 without x64 (XLA calls the C library's ``powf``
    and flushes subnormal powers), float64 with it."""
    counts = np.arange(1, 200_001, dtype=np.int32)
    for x64, dtype in ((False, torch.float32), (True, torch.float64)):
        with jax.enable_x64(x64):
            want = np.asarray(jax.jit(lambda c: 1 - decay ** c)(jnp.asarray(counts)))
        got = np.array([bias_correction(decay, int(c), dtype) for c in counts], want.dtype)
        np.testing.assert_array_equal(got, want, err_msg=str(dtype))


def test_state_dict_resume_is_the_unbroken_run():
    """6 steps, ``state_dict`` through ``torch.save``, a fresh optimizer on
    fresh parameters that ``load_state_dict``, 6 more steps: the run
    unbroken, bit for bit."""
    params, stream = _gradient_stream(3, 12)
    tparams = _port_params(params)
    unbroken = _port_steps(Adam(tparams, 0.02), tparams, stream)

    tparams = _port_params(params)
    first = Adam(tparams, 0.02)
    _port_steps(first, tparams, stream[:6])
    buffer = io.BytesIO()
    torch.save(first.state_dict(), buffer)
    buffer.seek(0)
    resumed_params = _port_params([p.detach().numpy() for p in tparams])
    resumed = Adam(resumed_params, 0.02)
    resumed.load_state_dict(torch.load(buffer, weights_only=True))
    assert resumed.state[resumed_params[0]]["step"] == 6
    got = _port_steps(resumed, resumed_params, stream[6:])
    for g_step, w_step in zip(got, unbroken[6:]):
        for g, w in zip(g_step, w_step):
            np.testing.assert_array_equal(g, w)


def test_count_saturates_at_int32_max():
    """optax's ``safe_increment``: the count stops at ``2**31 - 1``, where
    both bias corrections are 1."""
    p = torch.nn.Parameter(torch.ones(3))
    opt = Adam([p], 0.1)
    p.grad = torch.ones(3)
    opt.step()
    opt.state[p]["step"] = 2**31 - 2
    for _ in range(2):
        opt.step()
        assert opt.state[p]["step"] == 2**31 - 1
    assert bias_correction(0.9, 2**31 - 1) == bias_correction(0.999, 2**31 - 1) == 1.0


def test_adam_refuses_other_dtypes():
    with pytest.raises(TypeError):
        bias_correction(0.9, 1, torch.float16)
