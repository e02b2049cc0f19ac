"""Profiling and runtime-invariant helpers.

Port of :mod:`pymgrid_tpu.utils.profiling`:

* :func:`trace` captures a ``torch.profiler`` trace around a block (a Chrome
  trace under ``log_dir``; CUDA activity too when the device is CUDA), and
  :func:`device_summary` reads from it the kernels launched and the time the
  device was busy,
* :func:`span` and :func:`count` mark the port's own layers inside such a
  capture (a named range on the profiler's timeline, and host tallies that
  :func:`span_totals` returns); with no capture running they do nothing;
  :func:`recorded_counts` keeps what a block counts, for work replayed
  later (a CUDA graph),
* :class:`Throughput` measures env-steps/s around device work,
* :func:`check_balance` asserts the energy-balance invariant
  (``np.isclose(provided, consumed)``, the reference's only runtime check,
  ``microgrid/microgrid.py:321``) over engine rollout outputs,
* :func:`checked_step` wraps an engine step so non-finite rewards and balance
  violations surface as errors, in the JAX ``checkify`` call shape.
"""
import contextlib
import os
import tempfile
import time

import numpy as np
import torch

from pymgrid_tpu_torch._device import resolve_device

__all__ = ["trace", "device_summary", "span", "count", "span_totals", "recorded_counts",
           "Throughput", "check_balance", "checked_step"]


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def trace(log_dir=None, device="cuda"):
    """Profile the block with ``torch.profiler``: host activity, and CUDA
    activity when ``device`` is CUDA (the device is synchronized before the
    capture ends, so queued kernels are in it).  Yields the profiler; on exit
    writes its Chrome trace to ``log_dir/trace.json`` (by default
    ``pymgrid_tpu_torch_trace`` in the system's temporary directory).  The
    port's :func:`span` ranges are in it, and :func:`span_totals` starts
    from empty tallies at its start."""
    from torch.profiler import ProfilerActivity, profile

    if log_dir is None:
        log_dir = os.path.join(tempfile.gettempdir(), "pymgrid_tpu_torch_trace")
    device = resolve_device(device)
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    _tallies.clear()
    _counters.clear()
    with profile(activities=activities) as prof:
        yield prof
        _sync(device)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def device_summary(prof):
    """``{"kernels": n, "busy_ms": t}`` of a finished :func:`trace`: the
    device events it recorded (kernels, copies, fills) and the union of
    their intervals.  A user annotation's span on the device (a
    ``record_function`` range, such as the one every optimizer's ``step``
    opens) is not work and covers the gaps between its kernels: it is left
    out.  Both are 0 for a CPU capture."""
    from torch.autograd import DeviceType

    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False))
    busy, end = 0.0, -np.inf
    for start, stop in spans:
        if stop > end:
            busy += stop - max(start, end)
            end = stop
    return {"kernels": len(spans), "busy_ms": busy / 1e3}


# its ``_is_profiler_enabled``, which every torch profiler sets on start and
# clears on stop: an attribute read, cheaper than a call into the C++ side
_autograd_profiler = torch.autograd.profiler
_tallies = {}    # span name -> [calls, total_ns, self_ns]
_counters = {}   # counter name -> sum
_open = []       # the spans open now, innermost last: [name, start_ns, child_ns]
_recording = []  # the dicts of the recorded_counts blocks open now, innermost last


class _Span:
    """An open :func:`span`: a ``record_function`` range on the profiler's
    timeline, and its host time in :func:`span_totals`."""

    __slots__ = ("name", "_range")

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self._range = torch.profiler.record_function(self.name)
        self._range.__enter__()
        _open.append([self.name, time.perf_counter_ns(), 0])

    def __exit__(self, *exc):
        name, start, child = _open.pop()
        total = time.perf_counter_ns() - start
        if _open:
            _open[-1][2] += total
        tally = _tallies.get(name)
        if tally is None:
            tally = _tallies[name] = [0, 0, 0]
        tally[0] += 1
        tally[1] += total
        tally[2] += total - child
        self._range.__exit__(*exc)
        return False


_OFF = contextlib.nullcontext()   # the span when no profiler runs


def span(name):
    """``with span("pymgrid.<layer>.<part>"):`` marks a part of the port.

    On only while a ``torch.profiler`` capture runs (:func:`trace`, or any
    other): the block is then a ``record_function`` range in the capture,
    on the clock of its device events, and its host time is added to
    :func:`span_totals` under ``name``: calls, total nanoseconds, and self
    nanoseconds (the total less the totals of the spans opened inside it,
    so the self times of every span under a root add up to the root's
    total).  The tallies are the process's and spans nest: open them from
    one thread.  With no capture running the block runs as it is and
    nothing is recorded."""
    return _Span(name) if _autograd_profiler._is_profiler_enabled else _OFF


def count(name, n):
    """Add ``n`` to the counter ``name`` of :func:`span_totals` while a
    ``torch.profiler`` capture runs; nothing otherwise.  Inside
    :func:`recorded_counts` it adds to that block's dict instead."""
    if _recording:
        counts = _recording[-1]
        counts[name] = counts.get(name, 0) + n
    elif _autograd_profiler._is_profiler_enabled:
        _counters[name] = _counters.get(name, 0) + n


@contextlib.contextmanager
def recorded_counts():
    """``with recorded_counts() as counts:`` collects into ``counts`` what
    :func:`count` adds inside the block, profiler or not, and keeps it out
    of :func:`span_totals`: the counts of work recorded once and replayed
    later (a CUDA graph's), for the replays to add."""
    counts = {}
    _recording.append(counts)
    try:
        yield counts
    finally:
        _recording.pop()


def span_totals():
    """What :func:`span` and :func:`count` recorded since the last
    :func:`trace` started (since the process started, if none did):
    ``{"spans": {name: {"calls", "total_ns", "self_ns"}}, "counters":
    {name: n}}``."""
    return {
        "spans": {name: {"calls": c, "total_ns": t, "self_ns": s}
                  for name, (c, t, s) in _tallies.items()},
        "counters": dict(_counters),
    }


class Throughput:
    """Env-steps/s meter: ``with Throughput(n_envs, n_steps, device) as t:``.

    Eager work on a CUDA device is asynchronous: the meter synchronizes the
    device on enter and on exit, so it times the work and not its launch.
    """

    def __init__(self, n_envs, n_steps, device="cuda"):
        self.n_envs = n_envs
        self.n_steps = n_steps
        self.device = resolve_device(device)
        self.elapsed = None

    def __enter__(self):
        _sync(self.device)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        _sync(self.device)
        self.elapsed = time.perf_counter() - self._t0
        return False

    @property
    def steps_per_sec(self):
        return self.n_envs * self.n_steps / self.elapsed

    def __repr__(self):
        if self.elapsed is None:
            return "Throughput(pending)"
        return (
            f"Throughput({self.steps_per_sec:,.0f} env-steps/s over "
            f"{self.n_envs}x{self.n_steps} in {self.elapsed:.3f}s)"
        )


def _numpy(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def check_balance(outputs, rtol=1e-05, atol=1e-08):
    """Assert provided == consumed for every step of a collected rollout."""
    provided = _numpy(outputs.provided)
    absorbed = _numpy(outputs.absorbed)
    bad = ~np.isclose(provided, absorbed, rtol=rtol, atol=atol)
    if bad.any():
        idx = np.argwhere(bad)[:5]
        raise RuntimeError(
            "Microgrid modules unable to balance energy production with "
            f"consumption at indices {idx.tolist()}: "
            f"provided={provided[bad][:5]}, absorbed={absorbed[bad][:5]}"
        )
    return True


class StepError:
    """What :func:`checked_step` found: ``get()`` is the message or
    ``None``, ``throw()`` raises it (as ``checkify``'s error does)."""

    def __init__(self, message=None):
        self.message = message

    def get(self):
        return self.message

    def throw(self):
        if self.message is not None:
            raise ValueError(self.message)


def checked_step(spec, normalized=False, rtol=1e-05, atol=1e-08):
    """An engine step that checks its outputs: returns
    ``(err, (state, output)) = fn(params, state, action)``, the call shape of
    the JAX ``checkify`` step; ``err.throw()`` raises on a non-finite reward
    or where ``provided`` and ``absorbed`` fail ``torch.isclose`` at
    ``rtol``/``atol`` (a NaN fails it too).

    The check costs one device synchronize per call: both verdicts come to
    the host together."""
    from pymgrid_tpu_torch.core.engine import make_step_fn

    step_fn = make_step_fn(spec, normalized=normalized)

    def step(params, state, action):
        new_state, out = step_fn(params, state, action)
        bad_reward = ~torch.isfinite(out.reward)
        bad_balance = ~torch.isclose(out.provided, out.absorbed, rtol=rtol, atol=atol)
        flags = torch.stack([bad_reward.any(), bad_balance.any()]).tolist()
        message = None
        if flags[0]:
            message = f"non-finite reward {out.reward[bad_reward].tolist()}"
        elif flags[1]:
            message = (f"energy balance violated: provided "
                       f"{out.provided[bad_balance].tolist()} != absorbed "
                       f"{out.absorbed[bad_balance].tolist()}")
        return StepError(message), (new_state, out)

    return step
