"""The fused-horizon RBC rollout's plain version against the Pallas kernel and
the JAX engine on the CPU (the CUDA kernel itself: tests/test_torch_cuda.py).

Tolerances are those of tests/test_pallas_rollout.py: float32 accumulation
against the Pallas kernel (rtol 1e-5, 2e-5 with the genset machine) and
against the JAX engine's float32 dispatch, whose rounding order differs
(rtol 3e-5).  Each package gets its spec from its own host layer.
"""
from pathlib import Path

import numpy as np
import pytest
import torch

import pymgrid_tpu
from pymgrid_tpu.core.rollout import make_marginal_cost_policy as jax_mc_policy
from pymgrid_tpu.core.spec import extract_spec as jax_extract_spec
from pymgrid_tpu.ops.pallas_rollout import make_pallas_rbc_rollout
from pymgrid_tpu.parallel.suite import SuiteRunner as JaxSuiteRunner
from pymgrid_tpu_torch import Microgrid
from pymgrid_tpu_torch.core.spec import extract_spec
from pymgrid_tpu_torch.ops import make_rbc_rollout
from pymgrid_tpu_torch.ops.rbc_rollout import VARIANTS, supported_spec, variant_code

torch.set_num_threads(1)


def _sweep(params, B):
    """Init-charge sweep over [min_capacity, max_capacity] (numpy, f32)."""
    pb = params["battery"]
    return np.linspace(float(pb["min_capacity"][0]), float(pb["max_capacity"][0]),
                       B, dtype=np.float32)


@pytest.mark.parametrize("scenario,rtol", [(0, 1e-5), (1, 2e-5)])
def test_plain_matches_pallas_interpret(scenario, rtol):
    n_steps, B = 150, 1024
    spec, params, _ = extract_spec(Microgrid.from_scenario(scenario), dtype=np.float32)
    jspec, jparams, _ = jax_extract_spec(pymgrid_tpu.Microgrid.from_scenario(scenario),
                                         dtype=np.float32)
    init = _sweep(params, B)
    want = np.asarray(make_pallas_rbc_rollout(jspec, jparams, n_steps, interpret=True)(init))

    rollout = make_rbc_rollout(spec, params, n_steps, "cpu")
    ours = rollout(torch.as_tensor(init))
    assert ours.shape == (B,) and ours.dtype == torch.float32
    assert rollout.launches == 0  # a CPU tensor takes the plain version
    assert len(np.unique(want)) > B // 2
    np.testing.assert_allclose(ours.numpy(), want, rtol=rtol)


def test_plain_matches_jax_engine_all_25_scenarios():
    """Replicas at each config's own initial charge against the JAX engine's
    marginal-cost rollout of all 25 scenarios in one suite batch (neutral
    padding is exact, tests/test_suite.py)."""
    n_steps, B = 64, 8
    runner = JaxSuiteRunner([pymgrid_tpu.Microgrid.from_scenario(n) for n in range(25)],
                            batch_per_config=1, dtype=np.float32)
    fn = runner.rollout_fn(jax_mc_policy(runner.spec), n_steps, auto_reset=False,
                           collect=True)
    _, outs = fn(runner.params, runner.make_keys(seed=0))
    engine_totals = np.asarray(outs.reward)[:, 0].sum(axis=-1)

    for n in range(25):
        spec, params, _ = extract_spec(Microgrid.from_scenario(n), dtype=np.float32)
        assert supported_spec(spec), f"scenario {n}"
        init = torch.full((B,), float(params["battery"]["init_charge"][0]))
        acc = make_rbc_rollout(spec, params, n_steps, "cpu")(init).numpy()
        assert np.unique(acc).size == 1
        np.testing.assert_allclose(acc[0], engine_totals[n], rtol=3e-5,
                                   err_msg=f"scenario {n}")


def test_wrapper_rejects_bad_input():
    spec, params, _ = extract_spec(Microgrid.from_scenario(0), dtype=np.float32)
    rollout = make_rbc_rollout(spec, params, 10, "cpu")
    with pytest.raises(ValueError):
        rollout(torch.zeros(8, dtype=torch.float64))
    with pytest.raises(ValueError):
        rollout(torch.zeros(4, 2))
    with pytest.raises(ValueError):
        rollout(torch.zeros(16)[::2])
    with pytest.raises(ValueError):
        make_rbc_rollout(spec, params, 10_000, "cpu")


@pytest.mark.parametrize("scenario", range(25))
def test_every_scenario_has_a_compiled_variant(scenario):
    """Each scenario's deploy order maps to a variant code of the wrapper's
    table, the one the C launcher's switch compiles for that order; an order
    no variant holds raises."""
    spec, params, _ = extract_spec(Microgrid.from_scenario(scenario), dtype=np.float32)
    rollout = make_rbc_rollout(spec, params, 8, "cpu")
    assert 0 <= rollout.variant < len(VARIANTS)
    assert VARIANTS[rollout.variant] == tuple(rollout.order)
    assert ("genset" in rollout.order) == (spec.n_genset == 1)
    src = (Path(__file__).resolve().parents[1] / "pymgrid_tpu_torch" / "csrc"
           / "rbc_rollout.cu").read_text()
    kinds = {"battery": "kBattery", "grid": "kGrid", "genset": "kGenset"}
    tail = ["kNone"] if len(rollout.order) == 2 else []
    args = ", ".join([kinds[k] for k in rollout.order] + tail
                     + ["true" if spec.n_genset else "false"])
    assert f"case {rollout.variant}: launch<{args}>" in src


def test_unknown_variant_raises():
    with pytest.raises(ValueError, match="no kernel variant"):
        variant_code(["grid", "genset"])


def test_entry_point_defaults_to_the_card():
    """No device given: the rollout asks for CUDA and, without a card,
    raises instead of falling back to the CPU."""
    spec, params, _ = extract_spec(Microgrid.from_scenario(0), dtype=np.float32)
    if torch.cuda.is_available():
        assert make_rbc_rollout(spec, params, 8).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make_rbc_rollout(spec, params, 8)
