"""kernels_per_step.<cells>: device events (kernels, copies, fills; not
user annotations) in the traced part over the batched steps it ran
(profiler trace)."""


def read(run):
    if run.trace is None or not run.trace["events"]:
        return None
    return run.trace["events"] / run.trace["steps"]
