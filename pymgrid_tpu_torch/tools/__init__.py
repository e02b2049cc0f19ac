"""The result-table and speed programs on the port, ports of the repository's
``tools/``: :mod:`.run_benchmarks` (the full-year RBC, host MPC, card MPC and
SAA cost tables, and the suite's scaling table), :mod:`.run_legacy_benchmarks`
(the legacy nonmodular pipeline against the published xlsx),
:mod:`.saa_report` and :mod:`.profile_env` (env and suite rollout rates; it
writes no report).  Run them as
``python -m pymgrid_tpu_torch.tools.run_benchmarks`` and so on; their reports
and sidecars go to ``pymgrid_tpu_torch/build/results/`` unless ``--out``
says otherwise."""
