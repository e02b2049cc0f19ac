"""log_row_ms_per_step.<cells>: the self time of the port's span
``pymgrid.engine.log_row`` (the step's log row) over the traced part's
steps, in milliseconds (program span, under the profiler)."""
from port_bench.spans import self_ms_per_step


def read(run):
    return self_ms_per_step(run, "pymgrid.engine.log_row")
