from pymgrid_tpu_torch.algos.rbc import RuleBasedControl

__all__ = ["RuleBasedControl"]
