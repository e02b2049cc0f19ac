from pymgrid_tpu_torch.parallel.suite import SuiteRunner, build_suite

__all__ = ["SuiteRunner", "build_suite"]
