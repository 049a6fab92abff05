"""The paper's four evaluated algorithms, ported to PyTorch, and the numpy
second implementation of two of them.

Importing this package registers all six estimators (gbdt, forest, logreg,
mlp, np_logreg, np_mlp) with the common-interface registry, as the JAX
package's ``repro.tabular`` does.
"""
from repro_torch.tabular.gbdt import GBDTEstimator, GBDTModel
from repro_torch.tabular.forest import ForestEstimator, ForestModel
from repro_torch.tabular.logreg import LogRegEstimator, LogRegModel
from repro_torch.tabular.mlp import MLPEstimator, MLPModel
from repro_torch.tabular.numpy_impls import NumpyLogRegEstimator, NumpyMLPEstimator

__all__ = [
    "GBDTEstimator",
    "GBDTModel",
    "ForestEstimator",
    "ForestModel",
    "LogRegEstimator",
    "LogRegModel",
    "MLPEstimator",
    "MLPModel",
    "NumpyLogRegEstimator",
    "NumpyMLPEstimator",
]
