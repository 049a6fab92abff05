"""The ported estimator families. Importing this package registers them
with the common-interface registry; this slice ports GBDT."""
from repro_torch.tabular.gbdt import GBDTEstimator, GBDTModel

__all__ = ["GBDTEstimator", "GBDTModel"]
