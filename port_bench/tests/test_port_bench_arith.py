"""The harness's arithmetic on synthetic inputs with known answers: the
trace reading (the copied ``device_summary`` union), the percentile, the
rates and per-step readings, and the reference's threefry against the
port's."""
import numpy as np
import pytest
import torch

from port_bench import harness


def _run(calls, env_steps=0, window_s=None, trace=None, spans=None):
    run = harness.Run()
    run.calls, run.env_steps, run.window_s = calls, env_steps, window_s
    run.trace, run.spans = trace, spans or {}
    return run


def _metric(name, run):
    return harness.load_module("metrics", name).read(run)


def test_summarize_trace_unions_device_intervals():
    events = [("device", "k1", 0.0, 10.0), ("device", "k2", 5.0, 15.0),
              ("device", "k1", 30.0, 40.0), ("annotation", "step", 0.0, 100.0),
              ("host", "outer", 0.0, 100.0), ("host", "sync", 15.0, 30.0),
              ("host", "launch", 41.0, 60.0)]
    found = harness.summarize_trace(events, (0.0, 100.0))
    assert found["events"] == 3                       # the annotation is not work
    assert found["busy_s"] == pytest.approx(25e-6)    # [0, 15] and [30, 40]
    assert found["window_s"] == pytest.approx(100e-6)
    assert found["device_ops"] == [["k1", pytest.approx(20e-6)], ["k2", pytest.approx(10e-6)]]
    # gaps [15, 30] under sync, [40, 100] under launch (mid 70 past it: outer)
    assert harness.short_kernel_name(
        "void at::native::elementwise_kernel<128, 2, at::native::gpu_kernel_impl_nocast<"
        "at::native::CUDAFunctor_add<float> >(at::TensorIteratorBase&, at::native::"
        "CUDAFunctor_add<float> const&)::{lambda(int)#1}>(int, at::native::CUDAFunctor_add"
        "<float>)") == ("elementwise_kernel<128, 2, gpu_kernel_impl_nocast<CUDAFunctor_add"
                        "<float> >::lambda>")
    assert dict(found["idle_gaps"]) == {"sync": pytest.approx(15e-6),
                                        "outer": pytest.approx(60e-6)}


def test_p95_is_the_nearest_rank():
    assert harness.p95(list(range(1, 101))) == 95
    assert harness.p95(list(range(1, 21))) == 19
    assert harness.p95([7.0]) == 7.0
    assert harness.p95([3, 1, 2]) == 3


def test_rates_and_per_step_readings():
    calls = [(0.004, 0.010, 1)] * 19 + [(0.005, 0.030, 1)]
    rl = _run(calls, env_steps=20 * 65536, window_s=0.25)
    assert _metric("rl_steps_per_s", rl) == pytest.approx(20 * 65536 / 0.25)
    assert _metric("rl_step_ms_p95", rl) == pytest.approx(10.0)
    assert _metric("enqueue_ms_per_step.rl", rl) == pytest.approx(1e3 * 0.081 / 20)
    suite = _run([(5.0, 6.0, 1000)] * 3, env_steps=3 * 1000 * 512000, window_s=18.0,
                 trace={"events": 64 * 466, "busy_s": 0.17, "window_s": 0.4, "steps": 64},
                 spans={"build": 9.5})
    assert _metric("suite_steps_per_s", suite) == pytest.approx(3 * 512e6 / 18)
    assert _metric("enqueue_ms_per_step.suite", suite) == pytest.approx(5.0)
    assert _metric("kernels_per_step.suite", suite) == pytest.approx(466)
    assert _metric("busy_ms_per_step.suite", suite) == pytest.approx(0.17e3 / 64)
    assert _metric("device_idle.suite", suite) == pytest.approx(57.5)
    assert _metric("build_s", suite) == 9.5
    # a rollout of many steps has no one-step tail
    assert _metric("rl_step_ms_p95", _run([(0.1, 0.3, 100)], 1, 1.0)) is None


def test_a_split_metric_shares_its_reader():
    """``<name>.<cells>`` reads ``metrics/<name>.py`` unless it has a file of
    its own; a name with no file at all is refused."""
    assert (harness.load_module("metrics", "device_idle.rl").__file__
            == harness.load_module("metrics", "device_idle.suite").__file__)
    assert harness.load_module("metrics", "device_idle.rl").__file__.endswith("device_idle.py")
    with pytest.raises(FileNotFoundError):
        harness.load_module("metrics", "no_such_metric.rl")


def test_device_readers_stay_silent_without_device_events():
    run = _run([(1.0, 1.0, 8)], trace={"events": 0, "busy_s": 0.0, "window_s": 1.0, "steps": 8})
    for name in ("kernels_per_step.suite", "device_idle.suite", "busy_ms_per_step.suite"):
        assert _metric(name, run) is None
    assert _metric("kernels_per_step.rl", _run([(1.0, 1.0, 1)])) is None


def test_stalls_and_host_watch():
    assert harness.stalls([0.01] * 10 + [0.06, 0.2]) == (2, pytest.approx(0.26))
    assert harness.stalls([0.01] * 10) == (0, 0)
    with harness.HostWatch() as watch:
        import gc

        gc.collect()
    assert "involuntary switches" in watch.summary()
    assert watch.gc[2][0] >= 1


def test_reference_threefry_is_the_ports():
    from pymgrid_tpu_torch.core import prng
    from port_bench.reference import threefry

    rng = np.random.default_rng(0)
    keys = rng.integers(0, 2**32, (500, 2), dtype=np.uint64)
    tkeys = torch.as_tensor(keys.astype(np.int64))
    assert np.array_equal(threefry.split(keys), prng.split(tkeys).numpy())
    assert np.array_equal(threefry.fold_in(keys, 0x51A7), prng.fold_in(tkeys, 0x51A7).numpy())
    low = rng.integers(0, 100, 500)
    mine = threefry.randint32(keys, low, 8759)
    theirs = prng.randint(tkeys, (), torch.as_tensor(low), 8759, torch.int32)
    assert np.array_equal(mine, theirs.numpy())
