"""The program's own spans and counters, per batched step of the traced
part, for the metric readers.

The port records its ``pymgrid.*`` spans and counters while a
``torch.profiler`` capture runs; the traced part's capture is the only one
of a run, so ``pymgrid_tpu_torch.utils.profiling.span_totals()`` holds the
traced part alone.  A program without ``span_totals`` (an older port), a
span or counter that never fired, or a run without a traced part reads
``None``; nothing here raises.
"""


def _per_step(run, pick):
    """``pick(span_totals())`` over the traced part's steps; ``None`` where
    there is nothing to read."""
    if run.trace is None or not run.trace.get("steps"):
        return None
    try:
        from pymgrid_tpu_torch.utils import profiling

        value = pick(profiling.span_totals())
    except Exception:   # noqa: BLE001 - no reading rather than a failed run
        return None
    return None if value is None else value / run.trace["steps"]


def self_ms_per_step(run, *names):
    """The self milliseconds of the spans ``names``, summed, per step."""
    def pick(totals):
        found = [totals["spans"][n]["self_ns"] for n in names if n in totals["spans"]]
        return sum(found) / 1e6 if found else None
    return _per_step(run, pick)


def calls_per_step(run, name):
    """How often the span ``name`` ran, per step."""
    return _per_step(run, lambda totals: totals["spans"].get(name, {}).get("calls"))


def counter_per_step(run, name):
    """The counter ``name``, per step."""
    return _per_step(run, lambda totals: totals["counters"].get(name))
