"""device_idle.<cells>: the share of the traced part's wall time in which
no device event ran, in percent: 100 * (1 - union of device intervals /
window) (profiler trace)."""


def read(run):
    if run.trace is None or not run.trace["events"]:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])
