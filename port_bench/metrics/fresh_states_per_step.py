"""fresh_states_per_step.<cells>: the port's counter
``pymgrid.engine.fresh_states`` (the replicas for which an auto-reset built
a fresh state, from the states' shapes) over the traced part's steps
(program counter)."""
from port_bench.spans import counter_per_step


def read(run):
    return counter_per_step(run, "pymgrid.engine.fresh_states")
