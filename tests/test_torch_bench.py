"""The port's ``bench.py`` twin (``pymgrid_tpu_torch.tools.bench``) against
``bench.py`` as that program runs: on the CPU without ``jax_enable_x64``.

One subprocess (``JAX_PLATFORMS=cpu``, x64 off) loads ``bench.py`` by path
and saves, at 2 configs x 4 replicas, the suite's checksums at 10 steps (the
per-step path) and 16 (the block-prefetch path), the starts its runner draws
(JAX's int32 draw), the collect rollout's ``StepOutput`` at 4 x 5 steps, and
the kernel sweep's inputs and Pallas (interpret mode) outputs.  The twin's
starts equal those exactly; its checksums and outputs match at rtol 1e-5 in
float32 (the largest deviations seen: 2.9e-7 relative on the collect
checksum and 2.5e-7 on the suite's, whose observation sums run in another
order; 7.8e-8 on rewards and log rows; observations and dones equal).  Its ``main()`` at
``tests/test_bench_smoke.py``'s tiny knobs prints one JSON line with
``bench.py``'s keys, ``pallas_steps_per_sec`` renamed ``kernel_steps_per_sec``.
"""
import ast
import importlib.util
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from pymgrid_tpu_torch.ops import make_rbc_rollout
from pymgrid_tpu_torch.parallel import SuiteRunner
from pymgrid_tpu_torch.parallel import suite as suite_module
from pymgrid_tpu_torch.tools import bench

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
C, B, STEPS = 2, 4, (10, 16)
COLLECT_STEPS, SWEEP_BATCH, SWEEP_STEPS = 5, 1024, 5   # Pallas takes multiples of 1024
RENAMED = {"pallas_steps_per_sec": "kernel_steps_per_sec"}


def _tiny_knobs():
    spec = importlib.util.spec_from_file_location("bench_smoke_knobs",
                                                  REPO / "tests" / "test_bench_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.TINY


_JAX_SCRIPT = r"""
import importlib.util, sys
import numpy as np
import jax
import jax.numpy as jnp

jax.config.update("jax_platforms", "cpu")
assert not jax.config.jax_enable_x64 and jnp.asarray(1).dtype == jnp.int32

repo, out_path, C, B, steps, collect_steps, sweep_batch, sweep_steps = sys.argv[1:]
C, B, collect_steps, sweep_batch, sweep_steps = map(int, (C, B, collect_steps, sweep_batch,
                                                          sweep_steps))
sys.path.insert(0, repo)
spec = importlib.util.spec_from_file_location("bench_x64_off", repo + "/bench.py")
bench = importlib.util.module_from_spec(spec)
spec.loader.exec_module(bench)

from pymgrid_tpu.ops import pallas_rollout
from pymgrid_tpu.parallel.suite import SuiteRunner

calls, rollout_fn = [], SuiteRunner.rollout_fn


def recorded_rollout_fn(self, *args, **kwargs):
    fn = rollout_fn(self, *args, **kwargs)

    def run(params, keys):
        calls.append((self, keys, fn(params, keys)))
        return calls[-1][2]

    return run


SuiteRunner.rollout_fn = recorded_rollout_fn
saved = {}
for n_steps in map(int, steps.split(",")):
    fn, params, keys = bench.build_suite_rollout(C, B, n_steps)
    saved[f"checksums_{n_steps}"] = np.asarray(fn(params, keys))

# the starts the runner draws (its do_reset), with JAX's default int
runner, keys, _ = calls[-1]
max_start = min(m.ts_length for m in runner.spec.log_order if m.ts_length) - 1
i0 = jnp.asarray(runner.params["initial_step"], jnp.int32)
draw = lambda key, low: jax.random.randint(jax.random.fold_in(key, 0x51A7), (), low,
                                           jnp.int32(max_start))
saved["starts"] = np.asarray(jax.vmap(jax.vmap(draw, (0, None)))(keys, i0))

bench.bench_collect_rollout(replicas=B, n_steps=collect_steps, n_configs=C)
acc, outs = calls[-1][2]
saved["collect_acc"] = np.asarray(acc)
for field in outs._fields:
    saved[f"collect_{field}"] = np.asarray(getattr(outs, field))

make = pallas_rollout.make_pallas_rbc_rollout


def recorded_make(*args, **kwargs):
    kernel = make(*args, **kwargs)

    def run(init):
        out = kernel(init)
        saved["sweep_init"], saved["sweep_pallas"] = np.asarray(init), np.asarray(out)
        return out

    return run


pallas_rollout.make_pallas_rbc_rollout = recorded_make
bench.bench_pallas_rollout(batch_size=sweep_batch, n_steps=sweep_steps)
np.savez(out_path, **saved)
print("x64 off:", saved["starts"].dtype)
"""


@pytest.fixture(scope="module")
def jax_bench(tmp_path_factory):
    """What ``bench.py`` computes without x64, from one subprocess."""
    out = tmp_path_factory.mktemp("jax_bench") / "bench.npz"
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "JAX_ENABLE_X64": "0"}
    proc = subprocess.run(
        [sys.executable, "-c", _JAX_SCRIPT, str(REPO), str(out), str(C), str(B),
         ",".join(map(str, STEPS)), str(COLLECT_STEPS), str(SWEEP_BATCH), str(SWEEP_STEPS)],
        env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "x64 off: int32" in proc.stdout
    with np.load(out) as saved:
        return dict(saved)


@pytest.fixture
def port_rollouts(monkeypatch):
    """Every port suite rollout made while the test runs: ``(runner,
    outputs)``, the outputs what its function returned."""
    calls, rollout_fn = [], SuiteRunner.rollout_fn

    def recorded(self, *args, **kwargs):
        fn, outputs = rollout_fn(self, *args, **kwargs), []
        calls.append((self, outputs))
        return lambda *a: outputs.append(fn(*a)) or outputs[-1]

    monkeypatch.setattr(SuiteRunner, "rollout_fn", recorded)
    return calls


def runner_mgs():
    from pymgrid_tpu_torch import Microgrid

    return [Microgrid.from_scenario(n) for n in range(C)]


@pytest.mark.parametrize("n_steps", STEPS)
def test_suite_matches_bench_py_without_x64(n_steps, jax_bench, port_rollouts, monkeypatch):
    """``build_suite_rollout``: the starts equal ``bench.py``'s x64-off
    starts exactly (and differ from JAX's x64 draw), the checksums match at
    rtol 1e-5, and 16 steps run the block-prefetch path."""
    gathers, gather = [], suite_module.gather_block
    monkeypatch.setattr(suite_module, "gather_block",
                        lambda table, steps: gathers.append(1) or gather(table, steps))
    fn, params, keys = bench.build_suite_rollout(C, B, n_steps, "float32", "cpu")
    out = fn(params, keys)
    (runner, _), = port_rollouts
    assert runner.start_dtype == torch.int32 and out.dtype == torch.float32
    starts = runner.draw_initial_steps(keys).numpy()
    np.testing.assert_array_equal(starts, jax_bench["starts"])
    x64 = SuiteRunner(runner_mgs(), B, "float32", "cpu").draw_initial_steps(keys).numpy()
    assert not np.array_equal(starts, x64)
    np.testing.assert_allclose(out.numpy(), jax_bench[f"checksums_{n_steps}"], rtol=1e-5)
    assert len(gathers) == (n_steps // suite_module.BLOCK if n_steps % 8 == 0 else 0)


def test_collect_rollout_matches_bench_py_without_x64(jax_bench, port_rollouts):
    """``bench_collect_rollout`` at 2 x 4 x 5 steps: the randomized-restart
    collect rollout's ``StepOutput`` equals ``bench.py``'s (dones exactly,
    every other field at rtol 1e-5), and the rate is positive."""
    assert bench.bench_collect_rollout(B, COLLECT_STEPS, C, device="cpu") > 0
    (runner, outputs), = port_rollouts
    assert runner.start_dtype == torch.int32 and len(outputs) == 2   # untimed + timed
    acc, outs = outputs[-1]
    assert outs.reward.shape == (C, B, COLLECT_STEPS)
    np.testing.assert_allclose(acc.numpy(), jax_bench["collect_acc"], rtol=1e-5)
    for field in outs._fields:
        got, want = getattr(outs, field).numpy(), jax_bench[f"collect_{field}"]
        assert got.shape == want.shape, field
        if field == "done":
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-5, err_msg=field)


def test_kernel_sweep_inputs_equal_bench_py(jax_bench):
    """The kernel sweep's init charges equal ``bench.py``'s bitwise, and the
    port's RBC rollout on them (its plain version on the CPU) matches the
    Pallas kernel in interpret mode at rtol 1e-5."""
    spec, params, init = bench.kernel_sweep_inputs(SWEEP_BATCH, "cpu")
    assert init.dtype == torch.float32
    np.testing.assert_array_equal(init.numpy(), jax_bench["sweep_init"])
    got = make_rbc_rollout(spec, params, SWEEP_STEPS, "cpu")(init)
    np.testing.assert_allclose(got.numpy(), jax_bench["sweep_pallas"], rtol=1e-5)
    kernel_rate, engine_rate = bench.bench_kernel_rollout(SWEEP_BATCH, SWEEP_STEPS, "cpu")
    assert kernel_rate > 0 and engine_rate > 0


def _jax_line_keys():
    """Every key ``bench.py``'s ``main()`` puts in its line, read from its
    source: the ``result = {...}`` literal and each ``result["..."] =``."""
    tree = ast.parse((REPO / "bench.py").read_text())
    main = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")
    keys = set()
    for node in ast.walk(main):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict):
            keys |= {k.value for k in node.value.keys}
        elif isinstance(node, ast.Subscript) and isinstance(node.ctx, ast.Store):
            keys.add(node.slice.value)
    return keys


def test_main_prints_the_jax_line(monkeypatch, capsys):
    """At ``tests/test_bench_smoke.py``'s tiny knobs on the CPU: one JSON
    line on stdout with every key of ``bench.py``'s line (the one rename),
    every rate above 0, the markers on stderr."""
    for key, value in _tiny_knobs().items():
        monkeypatch.setenv(key, value)
    monkeypatch.delenv("PYMGRID_BENCH_SKIP_EXTRAS", raising=False)
    result = bench.main(["--device", "cpu"])
    captured = capsys.readouterr()
    line, = captured.out.splitlines()
    assert json.loads(line) == result
    want = {RENAMED.get(k, k) for k in _jax_line_keys()}
    assert len(want) == 19 and set(result) == want
    assert result["backend"] == "cpu" and result["n_chips_visible"] == torch.cuda.device_count()
    assert (result["n_configs"], result["total_envs"], result["n_steps"]) == (2, 8, 10)
    rates = [k for k in result if k == "value" or k.endswith("_per_sec")]
    assert len(rates) == 7 and all(result[k] > 0 for k in rates)
    assert "TPU" not in line and "relay" not in line and "50M" not in line
    assert "[bench " in captured.err and "repeat 0:" in captured.err


def test_main_skip_extras_prints_the_suite_alone(monkeypatch, capsys):
    for key, value in _tiny_knobs().items():
        monkeypatch.setenv(key, value)
    monkeypatch.setenv("PYMGRID_BENCH_SKIP_EXTRAS", "1")
    result = bench.main(["--device", "cpu"])
    assert json.loads(capsys.readouterr().out) == result
    assert not [k for k in result if k.endswith("_per_sec")] and result["value"] > 0


def test_twin_reads_every_knob_of_bench_py():
    knob = re.compile(r'"(PYMGRID_BENCH_\w+)"')
    want = set(knob.findall((REPO / "bench.py").read_text()))
    got = set(knob.findall(Path(bench.__file__).read_text()))
    assert len(want) == 13 and got == want


def test_twin_defaults_to_the_card(capsys):
    assert bench.parse_args([]).device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        bench.main([])
    assert capsys.readouterr().out == ""
