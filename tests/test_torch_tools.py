"""The port's twins of the repository's programs against the originals (CPU).

* ``pymgrid_tpu_torch.examples.scenario0_structure`` against
  ``examples/scenario0_structure.py`` at 200 steps: the tariff lines and every
  other line identical, the float32 returns within rtol 1e-5 (the two
  frameworks may contract float32 ops differently).
* ``pymgrid_tpu_torch.tools.run_benchmarks``: the RBC mode bitwise (float64)
  against the JAX ``RuleBasedControl.run_compiled``; the card-MPC report
  writer's deltas and totals against the JAX tool's writer on the same rows;
  the config-stamped sidecar refusing a mismatched config; every mode, and the
  legacy twin, writing only into its ``--out``.
* ``pymgrid_tpu_torch.tools.run_legacy_benchmarks``: the published xlsx rows
  read back from ``RESULTS_LEGACY.md`` when the xlsx is absent.

The JAX programs are loaded from their files, as ``tests/test_bench_smoke.py``
loads ``bench.py``.
"""
import importlib.util
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import pymgrid_tpu
from pymgrid_tpu.algos import RuleBasedControl as JaxRuleBasedControl
from pymgrid_tpu_torch.examples import scenario0_structure
from pymgrid_tpu_torch.tools import run_benchmarks, run_legacy_benchmarks

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
_COST = re.compile(r"^  (.+): (-?[\d,]+\.\d\d)$")


def _load(relpath, name):
    spec = importlib.util.spec_from_file_location(name, REPO / relpath)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_scenario0_structure_matches_the_jax_script(monkeypatch, capsys):
    n_steps = 200
    script = _load("examples/scenario0_structure.py", "scenario0_structure_jax")
    monkeypatch.setattr(sys, "argv", ["scenario0_structure.py", "--cpu", "--steps",
                                      str(n_steps)])
    script.main()
    want = capsys.readouterr().out.splitlines()
    got, returns = scenario0_structure.run("cpu", n_steps)
    assert len(got) == len(want) == 13
    assert got[:5] == want[:5]                                  # the tariff lines
    assert got[1] == "  price 0.22: residual hours 4015, residual sum 1,443,917"
    n_costs = 0
    for g, w in zip(got, want):
        mg, mw = _COST.match(g), _COST.match(w)
        if mg and mw and mg.group(1) == mw.group(1):
            a, b = (float(m.group(2).replace(",", "")) for m in (mg, mw))
            assert abs(a - b) <= 1e-5 * abs(b), (g, w)
            n_costs += 1
        else:
            assert g == w
    assert n_costs == 5 and len(returns) == 5
    assert got[-1].startswith("handcrafted vs RBC: ")


def test_scenario0_structure_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        scenario0_structure.run(n_steps=1)


def _args(tmp_path, *flags):
    return run_benchmarks.parse_args(["--device", "cpu", "--out", str(tmp_path), *flags])


def test_rbc_mode_bitwise_against_jax_run_compiled(tmp_path):
    n_steps = 200
    rows = run_benchmarks.run_rbc(_args(tmp_path, "--scenarios", "0,1"), n_steps)
    assert [r[0] for r in rows] == [0, 1]
    table = (tmp_path / "RESULTS.md").read_text()
    for n, cost, _, mpc_cost, _ in rows:
        log = JaxRuleBasedControl(pymgrid_tpu.Microgrid.from_scenario(n)).run_compiled(
            max_steps=n_steps)
        want = -log[("balance", 0, "reward")].sum()
        assert cost == want and mpc_cost is None
        assert f"| {n} | {cost:,.2f} |" in table
    assert f"| **total** | **{rows[0][1] + rows[1][1]:,.2f}** |" in table


def test_rbc_mode_defaults_to_the_card(tmp_path):
    args = run_benchmarks.parse_args(["--out", str(tmp_path)])
    assert args.device == "cuda" and not args.mpc_suite
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            run_benchmarks.main(["--out", str(tmp_path), "--scenarios", "0"])


def test_chip_report_writer_matches_the_jax_writer(tmp_path):
    """The same rows through both writers: the deltas against the host table
    (the repository's RESULTS.md), the summary line and the totals agree."""
    jax_tool = _load("tools/run_benchmarks.py", "run_benchmarks_jax_ut")
    rows = [(0, 1_039_882.62, 8759, 112.9), (3, 101_810_000.0, 8759, 170.5),
            (1, 177_300_000.0, 8759, 99.0), (99, 1234.5, 10, 1.0)]
    jax_tool._write_chip_report(rows, enum_bits=5, out=tmp_path / "jax.md")
    ours = run_benchmarks._write_chip_report(rows, 5, out=tmp_path / "port.md")
    want, got = (tmp_path / "jax.md").read_text(), ours.read_text()
    assert "enum_bits=5" in got and "1,033,040.53" in got and "+0.66%" in got

    def numbers(text):
        lines = [ln for ln in text.splitlines()
                 if ln.startswith("|") or ln.startswith("Measured this run")
                 or ln.startswith("Scenarios without")]
        return [re.sub(r"\b(chip|card) MPC\b", "MPC", ln) for ln in lines]

    assert numbers(got) == numbers(want)
    assert got.strip().splitlines()[-1] == "Scenarios without a host anchor in RESULTS.md: [99]."


def test_load_sidecar_refuses_a_mismatched_config(tmp_path):
    sidecar = tmp_path / "RESULTS_CHIP.partial.json"
    config = {"enum_bits": 5, "matmul_precision": "float32"}
    run_benchmarks._save_sidecar(sidecar, config, {"0": [0, 1.0, 24, 1.0]})
    marks = []
    assert run_benchmarks._load_sidecar(sidecar, config, True, marks.append) == {
        "0": [0, 1.0, 24, 1.0]}
    assert marks and run_benchmarks._load_sidecar(sidecar, config, False, print) == {}
    with pytest.raises(SystemExit, match="refused"):
        run_benchmarks._load_sidecar(sidecar, {**config, "enum_bits": 3}, True, print)
    sidecar.write_text('{"rows": {}}')
    with pytest.raises(SystemExit, match="predates"):
        run_benchmarks._load_sidecar(sidecar, config, True, print)


def test_legacy_baselines_fall_back_to_the_published_table(tmp_path):
    baselines, source = run_legacy_benchmarks.read_xlsx_baselines(
        tmp_path / "absent.xlsx")
    assert source == "the xlsx columns of RESULTS_LEGACY.md"
    assert sorted(baselines) == list(range(25))
    assert baselines[0] == {"rbc": 378_640.91, "mpc": 346_870.80}
    assert baselines[24] == {"rbc": 8_067_070.13, "mpc": 6_318_824.15}
    total = "**408,756,799.55**"   # the table's own xlsx RBC total
    assert total in (REPO / "RESULTS_LEGACY.md").read_text()
    assert f"{sum(b['rbc'] for b in baselines.values()):,.2f}" == total.strip("*")


def test_legacy_ref_check_needs_the_reference(tmp_path, monkeypatch):
    """The existence check, the xlsx and the in-process import all read the
    one location of ``tests/helpers/reference.py``, whatever the checkout's."""
    from helpers import reference

    assert run_legacy_benchmarks.reference_helper() is reference
    assert run_legacy_benchmarks.xlsx_path().parent == Path(reference.REFERENCE_SRC).parent
    monkeypatch.setattr(reference, "REFERENCE_SRC", str(tmp_path / "absent" / "src"))
    assert run_legacy_benchmarks.xlsx_path().parent == tmp_path / "absent"
    with pytest.raises(SystemExit, match="checkout"):
        run_legacy_benchmarks.main(["--scenarios", "0", "--ref-check", "0",
                                    "--out", str(tmp_path)], n_steps=3)
    assert not any(tmp_path.iterdir())          # refused before any work


def _snapshot():
    """Every file the twins could touch outside their ``--out``: the
    repository's result tables and sidecars, and the default results
    directory."""
    paths = sorted(REPO.glob("RESULTS*")) + sorted(
        (REPO / "pymgrid_tpu_torch" / "build" / "results").glob("*"))
    return {p: p.read_bytes() for p in paths}


def test_twins_write_only_into_their_out(tmp_path):
    before = _snapshot()
    run_benchmarks.run_rbc(_args(tmp_path, "--scenarios", "0"), 3)
    run_benchmarks.run_mpc_suite(_args(tmp_path, "--mpc-suite", "--scenarios", "0,1",
                                       "--enum-bits", "3"), 2)
    run_benchmarks.run_mpc_chip(_args(tmp_path, "--mpc-chip", "--scenarios", "0"), 2)
    done, _ = run_benchmarks.run_saa(_args(tmp_path, "--saa", "--scenarios", "0",
                                           "--saa-presets", "85", "--saa-samples", "2"), 2)
    assert list(done) == ["0:85"] and np.isfinite(done["0:85"][0])
    run_legacy_benchmarks.main(["--scenarios", "0", "--out", str(tmp_path)], n_steps=3)
    assert _snapshot() == before
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "RESULTS.md", "RESULTS_CHIP.md", "RESULTS_CHIP.partial.json",
        "RESULTS_CHIP.suite.partial.json", "RESULTS_LEGACY.md", "RESULTS_SAA.md",
        "RESULTS_SAA.partial.json"]
    assert "| 0 | " in (tmp_path / "RESULTS_SAA.md").read_text()
