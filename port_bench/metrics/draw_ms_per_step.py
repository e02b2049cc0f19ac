"""draw_ms_per_step: the self times of the port's spans
``pymgrid.suite.restart_draw`` and ``pymgrid.prng.threefry`` (the restarts
and starts drawn from keys, and every threefry hash, wherever it runs) over
the traced part's steps, in milliseconds (program span, under the
profiler)."""
from port_bench.spans import self_ms_per_step


def read(run):
    return self_ms_per_step(run, "pymgrid.suite.restart_draw", "pymgrid.prng.threefry")
