"""busy_ms_per_step.<cells>: the union of device intervals in the traced
part over the batched steps it ran, in milliseconds (profiler trace)."""


def read(run):
    if run.trace is None or not run.trace["events"]:
        return None
    return 1e3 * run.trace["busy_s"] / run.trace["steps"]
