"""Run one cell of the benchmark once.

    python3 -m port_bench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The run finds the cell in ``BENCHMARK.json``,
its configuration under ``port_bench/configs/``, its traffic under
``port_bench/traffic/`` (which names its driver under
``port_bench/drivers/``), its limits under ``port_bench/limits/`` and each
metric's reader under ``port_bench/metrics/``.  It takes the card or fails,
builds and warms up the configuration (the set-up), runs the cell's loop for
``--seconds``, and with ``--trace 1`` profiles a bounded part after the
window.  Then it works the sampled outputs of the window out again with the
configuration's plain reference on the CPU, prints each number compared
beside its limit on standard error, and prints one JSON line: the cell's
end-to-end metrics with ``--trace 0``, its per-layer metrics with
``--trace 1``.
"""
import time

PROCESS_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

from port_bench import harness  # noqa: E402


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def _fail(message, code=2):
    print(f"port_bench: {message}", file=sys.stderr, flush=True)
    return code


def _device_info(torch, device, chips, run):
    """The card, and the program's peak of device memory from the end of
    set-up: the allocator's peak less the harness's own sample buffers."""
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": 0}
    peak = torch.cuda.max_memory_allocated(device) - run.harness_bytes
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": chips,
            "memory_peak_bytes": int(peak)}


def _trace(torch, driver, system, device):
    """Profile the driver's traced part; returns the trace's reading."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        steps = driver.traced(system)
    events = harness.profiler_events(prof)
    # the traced part on the profiler's clock: from its first event to its last
    window = (min(s for _, _, s, _ in events), max(e for _, _, _, e in events))
    reading = harness.summarize_trace(events, window)
    reading["steps"] = steps
    return reading


def main(argv=None, device=None, overrides=None):
    """Run the cell; returns the exit code.  For the benchmark's own tests:
    ``device`` (the CPU) skips the look for a card, ``overrides`` replace
    traffic parameters (a tiny size)."""
    args = parse_args(argv)
    for key, path in harness.cache_dirs().items():
        os.environ[key] = path
    try:
        cell = harness.resolve(args.workload)
    except (KeyError, FileNotFoundError) as exc:
        return _fail(str(exc))
    traffic = dict(cell["traffic"], **(overrides or {}))
    config = cell["config"]
    chips = cell["cell"]["chips"]

    import torch

    if device is None:
        if not torch.cuda.is_available():
            return _fail("no CUDA device: the benchmark runs on the card only")
        if torch.cuda.device_count() < chips:
            return _fail(f"the cell needs {chips} cards, {torch.cuda.device_count()} visible")
        device = torch.device("cuda", 0)
    device = torch.device(device)

    driver = harness.load_module("drivers", traffic["driver"])
    limits = harness.load_json(harness.BENCH_DIR, "limits", f"{args.workload}.json")
    run = harness.Run()
    system = driver.setup(config, traffic, device, run)
    driver.prepare(system, args.seed)
    driver.warm_up(system)
    cpus = harness.steady_host(torch)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    run.setup_s = time.perf_counter() - PROCESS_START

    with harness.HostWatch() as watch:
        driver.window(system, args.seconds, run)
    harness.release_host(cpus)
    device_info = _device_info(torch, device, chips, run)
    if args.trace:
        run.trace = _trace(torch, driver, system, device)
        device_info["busy_s"] = run.trace["busy_s"]
        device_info["window_s"] = run.trace["window_s"]
    latencies = sorted(c[1] for c in run.calls)
    n_slow, slow_s = harness.stalls(latencies)
    print(f"port_bench: {run.attempted} calls, {run.env_steps} replica-steps in "
          f"{run.window_s:.4f} s; set-up {run.setup_s:.4f} s; call seconds min "
          f"{latencies[0]:.6f} median {latencies[len(latencies) // 2]:.6f} max "
          f"{latencies[-1]:.6f}; first {run.calls[0][1]:.6f}; {n_slow} calls over 5x the "
          f"median ({slow_s:.3f} s)", file=sys.stderr, flush=True)
    print(f"port_bench host in the window: {watch.summary()}", file=sys.stderr, flush=True)

    for key in driver.PROGRAM:
        del system[key]
    if device.type == "cuda":
        torch.cuda.empty_cache()
    readings = driver.check(system)["program"]
    del system

    found = harness.forbidden_modules()
    if found:
        return _fail(f"the run loaded modules it may not: {', '.join(found)}", code=3)

    checks = {name: {"value": value, "limit": limits["limits"][name]}
              for name, value in readings.items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    metrics = {}
    for entry in cell["per_layer" if args.trace else "end_to_end"]:
        value = harness.load_module("metrics", entry["name"]).read(run)
        if value is not None:
            metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
    result = {"correct": correct, "attempted": run.attempted, "failed": 0,
              "metrics": metrics, "device": device_info}
    if args.trace:
        result["breakdown"] = {"device_ops": run.trace["device_ops"],
                               "idle_gaps": run.trace["idle_gaps"]}
    result["checks"] = checks
    for name, c in checks.items():
        print(f"port_bench check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
