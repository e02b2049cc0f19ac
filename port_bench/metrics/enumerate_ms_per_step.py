"""enumerate_ms_per_step: the self time of the port's span
``pymgrid.mpc.enumerate`` (the genset's on/off enumeration less its
interior-point solves: the candidate patterns, pinning them, the running
best) over the traced part's hours, in milliseconds (program span, under the
profiler)."""
from port_bench.spans import self_ms_per_step


def read(run):
    return self_ms_per_step(run, "pymgrid.mpc.enumerate")
