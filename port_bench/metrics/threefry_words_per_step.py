"""threefry_words_per_step: the port's counter
``pymgrid.prng.threefry_words`` (the elements every threefry hash computed,
from the tensors' shapes) over the traced part's steps (program counter)."""
from port_bench.spans import counter_per_step


def read(run):
    return counter_per_step(run, "pymgrid.prng.threefry_words")
