"""mpc_self_ms_per_step: the self time of the port's span
``pymgrid.mpc.step`` (the planner's step less the assembly, the
enumeration, the interior-point solves, the action's extraction and repair,
and the engine step inside it: the final solve's pattern pinning and the
glue) over the traced part's hours, in milliseconds (program span, under the
profiler)."""
from port_bench.spans import self_ms_per_step


def read(run):
    return self_ms_per_step(run, "pymgrid.mpc.step")
