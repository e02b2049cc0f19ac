"""Programs on the port, ports of the repository's ``examples/``: A2C
(:mod:`.train_rl`), evolution strategies (:mod:`.train_es`) and the
scenario-0 structure study (:mod:`.scenario0_structure`).  Run them as
``python -m pymgrid_tpu_torch.examples.train_rl`` and so on."""
