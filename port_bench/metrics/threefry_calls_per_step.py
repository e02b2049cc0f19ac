"""threefry_calls_per_step: calls of the port's span
``pymgrid.prng.threefry`` (each a threefry hash in eager ops) over the traced
part's steps (program span)."""
from port_bench.spans import calls_per_step


def read(run):
    return calls_per_step(run, "pymgrid.prng.threefry")
