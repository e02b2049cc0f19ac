"""The CPU stand-in for the port's CUDA graphs (``utils/cuda_graph.py``).

``replaying`` is a fixture: for the whole test every
:class:`~pymgrid_tpu_torch.utils.cuda_graph.Recording` captures eagerly,
and what is built inside ``with replaying():`` takes the replay path, as it
would on a CUDA device (``cuda_graph.available`` says yes there).  What is
built outside the block runs its eager path: the twin to compare with.  A
test module takes the fixture by importing it.

The stand-in does what the real capture does, with no graph: it runs the
work once with its counts dropped (the warm-up), then once more keeping its
counts and outputs (the recording).  A replay runs the work again on the
recording's inputs with its counts dropped and writes every output leaf
into the recorded ones, in place, as a CUDA graph's replay does."""
import contextlib

import pytest

from pymgrid_tpu_torch.utils import cuda_graph, profiling


def output_leaves(tree):
    """The tensors of nested tuples and dicts, in their order; ``None`` has
    none."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in output_leaves(v)]
    if isinstance(tree, tuple):
        return [x for v in tree for x in output_leaves(v)]
    return [] if tree is None else [tree]


def capture_eagerly(self):
    """:meth:`Recording._capture` on the CPU."""
    with profiling.recorded_counts():
        self.fn(*self.inputs)
    with profiling.recorded_counts() as counts:
        outputs = self.fn(*self.inputs)

    def replay():
        with profiling.recorded_counts():
            new = self.fn(*self.inputs)
        for dst, src in zip(output_leaves(outputs), output_leaves(new), strict=True):
            dst.copy_(src)

    return replay, outputs, counts


@pytest.fixture
def replaying(monkeypatch):
    monkeypatch.setattr(cuda_graph.Recording, "_capture", capture_eagerly)

    @contextlib.contextmanager
    def block():
        with monkeypatch.context() as patch:
            patch.setattr(cuda_graph, "available", lambda device: True)
            yield

    return block
