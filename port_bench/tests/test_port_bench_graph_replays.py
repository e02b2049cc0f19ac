"""The reader of the suite's graph replays: the counter per step of the
traced part, and nothing where the counter never fired, where the program
has no ``span_totals`` (an older port) or where the run had no traced
part."""
from port_bench import harness


def _reader():
    return harness.load_module("metrics", "graph_replays_per_step")


def _traced_run(steps):
    run = harness.Run()
    run.trace = {"steps": steps, "events": 0}
    return run


def test_reads_the_replays_per_step(tmp_path):
    from pymgrid_tpu_torch.utils.profiling import count, trace

    with trace(str(tmp_path), device="cpu"):
        for _ in range(25):
            count("pymgrid.suite.graph_replays", 1)
        count("pymgrid.prng.threefry_words", 7)
    assert _reader().read(_traced_run(25)) == 1.0
    assert _reader().read(_traced_run(50)) == 0.5


def test_silent_without_the_counter(tmp_path, monkeypatch):
    from pymgrid_tpu_torch.utils import profiling

    with profiling.trace(str(tmp_path), device="cpu"):
        profiling.count("pymgrid.prng.threefry_words", 7)
    assert _reader().read(_traced_run(10)) is None
    assert _reader().read(harness.Run()) is None
    monkeypatch.delattr(profiling, "span_totals")
    assert _reader().read(_traced_run(10)) is None
