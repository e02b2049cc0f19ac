"""What every cell of the benchmark shares: finding its files by name, the
record of one run, the reading of a profiler trace, and the import guard.

Nothing here imports the program under test.
"""
import contextlib
import gc
import importlib.util
import json
import math
import os
import re
import resource
import sys
import time

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)

# top-level module names a run may not load: the JAX package and its stack
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "pymgrid_tpu")


def load_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_module(folder, name):
    """The Python file ``port_bench/<folder>/<name>.py`` as a module (names
    may hold ``-`` and ``.``, so it is loaded by its path).  A name with a
    dotted part, such as a metric ``busy_ms_per_step.rl``, falls back to
    the file of the name without its last part, ``busy_ms_per_step.py``:
    one reader serves the metric split by the cells that report it."""
    path = os.path.join(BENCH_DIR, folder, f"{name}.py")
    if not os.path.exists(path) and "." in name:
        path = os.path.join(BENCH_DIR, folder, f"{name.rsplit('.', 1)[0]}.py")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no {folder} file named {name!r}: {path}")
    spec = importlib.util.spec_from_file_location(f"port_bench.{folder}.{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def benchmark():
    return load_json(ROOT, "BENCHMARK.json")


def resolve(workload_name, bench=None):
    """A cell by name: its ``BENCHMARK.json`` entry, its configuration file,
    its traffic file, and the metrics it reports (``"end_to_end"`` and
    ``"per_layer"`` entries that name it or name no cell)."""
    bench = bench or benchmark()
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload_name not in cells:
        raise KeyError(f"no workload {workload_name!r}; BENCHMARK.json has {sorted(cells)}")
    cell = cells[workload_name]
    config_entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    applies = lambda m: workload_name in m.get("workloads", [workload_name])  # noqa: E731
    return {
        "cell": cell,
        "config": load_json(ROOT, config_entry["file"]),
        "traffic": load_json(BENCH_DIR, "traffic", f"{cell['traffic']}.json"),
        "end_to_end": [m for m in bench["end_to_end"] if applies(m)],
        "per_layer": [m for m in bench["per_layer"] if applies(m)],
    }


def cache_dirs():
    """Fixed build and kernel cache directories inside the checkout."""
    base = os.path.join(ROOT, ".bench_cache")
    return {"TORCH_EXTENSIONS_DIR": os.path.join(base, "torch_extensions"),
            "TRITON_CACHE_DIR": os.path.join(base, "triton")}


class Run:
    """What one run records for the metric readers.

    ``calls`` holds ``(enqueue_s, latency_s, steps)`` for every call into
    the program in the window (host clock from the call to its return, and
    to the end of the synchronise after it; ``steps`` the batched steps it
    ran); ``env_steps`` counts replica-steps; ``spans`` the seconds of the
    benchmark's own spans; ``trace`` the reading of the traced part;
    ``harness_bytes`` the device memory the harness itself holds through the
    window (its sample buffers), left out of the program's peak."""

    def __init__(self):
        self.calls = []
        self.harness_bytes = 0
        self.env_steps = 0
        self.window_s = None
        self.setup_s = None
        self.spans = {}
        self.trace = None

    @contextlib.contextmanager
    def span(self, name):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.spans[name] = self.spans.get(name, 0.0) + time.perf_counter() - t0

    @property
    def attempted(self):
        return len(self.calls)


def steady_host(torch):
    """Hold the host side of the window steady, once set-up is done: one
    thread for torch's CPU operations, the main thread kept on one core (the
    last the process may use), and the objects of set-up collected and
    frozen out of the garbage collector's later passes.  Returns the cores
    the main thread may use, for :func:`release_host`; the reference's check
    keeps the one thread."""
    torch.set_num_threads(1)
    cpus = None
    if hasattr(os, "sched_setaffinity"):
        cpus = os.sched_getaffinity(0)
        os.sched_setaffinity(0, {max(cpus)})
    gc.collect()
    gc.freeze()
    return cpus


def release_host(cpus):
    """The main thread on all its cores again, after the window, so that the
    profiler's threads started from it are not held to one core."""
    if cpus:
        os.sched_setaffinity(0, cpus)


class HostWatch:
    """What the host did to the window, for the run's standard error: the
    main thread's involuntary context switches, and the garbage collector's
    passes and seconds by generation."""

    def __init__(self):
        self.gc = {}
        self._t = None

    @staticmethod
    def _preempted():
        thread = getattr(resource, "RUSAGE_THREAD", resource.RUSAGE_SELF)
        return resource.getrusage(thread).ru_nivcsw

    def _on_gc(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            n, s = self.gc.get(info["generation"], (0, 0.0))
            self.gc[info["generation"]] = (n + 1, s + time.perf_counter() - self._t)

    def __enter__(self):
        self.preempted = self._preempted()
        gc.callbacks.append(self._on_gc)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self._on_gc)
        self.preempted = self._preempted() - self.preempted

    def summary(self):
        parts = [f"{self.preempted} involuntary switches"]
        parts += [f"gc gen{g} {n} ({s:.3f} s)" for g, (n, s) in sorted(self.gc.items())]
        return ", ".join(parts)


def stalls(latencies, factor=5):
    """The calls that took over ``factor`` times the median: how many, and
    their seconds."""
    ordered = sorted(latencies)
    slow = [x for x in ordered if x > factor * ordered[len(ordered) // 2]]
    return len(slow), sum(slow)


def sync(device):
    """Wait for the device's queued work (nothing to wait for on the CPU)."""
    if device.type == "cuda":
        import torch

        torch.cuda.synchronize(device)


def p95(values):
    """The nearest-rank 95th percentile: the smallest value with at least
    95% of the values at or below it."""
    ordered = sorted(values)
    return ordered[max(0, math.ceil(0.95 * len(ordered)) - 1)]


def merged_intervals(spans):
    """Sorted, merged ``(start, end)`` intervals of ``spans``."""
    merged = []
    for start, stop in sorted(spans):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], stop)
        else:
            merged.append([start, stop])
    return merged


def short_kernel_name(name):
    """A CUDA kernel's name without its argument lists, lambdas and the
    ``at::native`` namespaces: ``elementwise_kernel<128, 2,
    gpu_kernel_impl_nocast<CUDAFunctor_add<float> >::lambda>``."""
    s = re.sub(r"\{lambda\([^)]*\)#\d+\}", "lambda", name)
    for junk in ("void ", "at::native::", "(anonymous namespace)::", "::operator() const"):
        s = s.replace(junk, "")
    while True:
        shorter = re.sub(r"\([^()]*\)", "", s)
        if shorter == s:
            return s[:160]
        s = shorter


def summarize_trace(events, window, top=10):
    """Read a trace: ``events`` are ``(kind, name, start_us, end_us)`` with
    ``kind`` ``"device"`` (a kernel, copy or fill), ``"annotation"`` (a user
    range shown on the device, not work) or ``"host"``; ``window`` the traced
    part's ``(start_us, end_us)`` on the same clock.

    Returns the device events counted, the union of their intervals in
    seconds (the arithmetic of ``pymgrid_tpu_torch/utils/profiling.py``'s
    ``device_summary``), the window in seconds, the ``top`` device
    operations by total time (by :func:`short_kernel_name`), and the ``top``
    host activities by the idle time of the device under them: every gap
    between device intervals inside the window is charged to the innermost
    host event covering its middle (``"python, outside any op"`` where none
    does: the interpreter between two calls into torch)."""
    device = [(s, e, n) for kind, n, s, e in events if kind == "device"]
    merged = merged_intervals((s, e) for s, e, _ in device)
    busy_us = sum(e - s for s, e in merged)
    by_name = {}
    for s, e, n in device:
        n = short_kernel_name(n)
        by_name[n] = by_name.get(n, 0.0) + (e - s) / 1e6
    device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]

    w0, w1 = window
    edges = [w0] + [x for s, e in merged for x in (s, e)] + [w1]
    gaps = [(max(a, w0), min(b, w1)) for a, b in zip(edges[::2], edges[1::2])]
    gaps = [(a, b) for a, b in gaps if b > a]
    host = sorted((s, e, n) for kind, n, s, e in events if kind == "host")
    idle, stack, i = {}, [], 0
    for a, b in gaps:                      # gaps come in time order
        mid = (a + b) / 2
        while i < len(host) and host[i][0] <= mid:
            while stack and stack[-1][1] < host[i][0]:
                stack.pop()
            stack.append(host[i])
            i += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        label = stack[-1][2] if stack else "python, outside any op"
        idle[label] = idle.get(label, 0.0) + (b - a) / 1e6
    idle_gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:top]
    return {"events": len(device), "busy_s": busy_us / 1e6, "window_s": (w1 - w0) / 1e6,
            "device_ops": [[n, v] for n, v in device_ops],
            "idle_gaps": [[n, v] for n, v in idle_gaps]}


def profiler_events(prof):
    """``(kind, name, start_us, end_us)`` of a finished ``torch.profiler``
    capture."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            kind = "annotation" if getattr(e, "is_user_annotation", False) else "device"
        else:
            kind = "host"
        out.append((kind, e.name, e.time_range.start, e.time_range.end))
    return out


def forbidden_modules(modules=None):
    """Loaded modules whose top-level name is one a run may not load,
    compared whole: ``pymgrid_tpu_torch`` is not ``pymgrid_tpu``."""
    modules = sys.modules if modules is None else modules
    return sorted({name for name in modules if name.split(".")[0] in FORBIDDEN})
