"""runner_self_ms_per_step: the self time of the port's span
``pymgrid.suite.rollout`` (the suite's rollout call less the engine and draw
spans inside it: keys, the loop, the checksum, stacking the collected
outputs) over the traced part's steps, in milliseconds (program span, under
the profiler)."""
from port_bench.spans import self_ms_per_step


def read(run):
    return self_ms_per_step(run, "pymgrid.suite.rollout")
