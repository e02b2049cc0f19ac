"""ipm_ms_per_step: the self time of the port's span ``pymgrid.lp.ipm``
(every interior-point solve: the relaxation, the pattern chunks, the final
re-solve) over the traced part's hours, in milliseconds (program span, under
the profiler)."""
from port_bench.spans import self_ms_per_step


def read(run):
    return self_ms_per_step(run, "pymgrid.lp.ipm")
