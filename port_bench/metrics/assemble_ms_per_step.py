"""assemble_ms_per_step: the self time of the port's span
``pymgrid.mpc.assemble`` (the series windows, the grid windows, the state of
charge and the horizon LPs' data) over the traced part's hours, in
milliseconds (program span, under the profiler)."""
from port_bench.spans import self_ms_per_step


def read(run):
    return self_ms_per_step(run, "pymgrid.mpc.assemble")
