"""Training programs on the port: A2C (:mod:`.train_rl`) and evolution
strategies (:mod:`.train_es`), ports of the repository's ``examples/``.
Run them as ``python -m pymgrid_tpu_torch.examples.train_rl`` and
``python -m pymgrid_tpu_torch.examples.train_es``."""
