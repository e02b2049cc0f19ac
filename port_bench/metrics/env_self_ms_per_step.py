"""env_self_ms_per_step: the self time of the port's span
``pymgrid.env.step`` (the batched env's ``step()`` call less the engine spans
inside it: action checks, lifting and dropping the config axis) over the
traced part's steps, in milliseconds (program span, under the profiler)."""
from port_bench.spans import self_ms_per_step


def read(run):
    return self_ms_per_step(run, "pymgrid.env.step")
