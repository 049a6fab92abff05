"""DEPRECATED builder API — a thin shim over SearchSpec + Session.

The paper's Fig. 1 flow keeps working verbatim:

    searcher = (ModelSearcher(n_executors=8)
                .add_space(gbdt_grid)
                .add_space(mlp_grid)
                .set_scheduler("lpt")
                .set_profiler(SamplingProfiler(0.01)))
    multi_model = searcher.model_search(train)
    scores = multi_model.validate_all(validate, metric="auc")

but each mutator now just accumulates fields for one frozen
:class:`repro_torch.core.spec.SearchSpec`, and ``model_search`` delegates to
:class:`repro_torch.core.session.Session`. New code should build the spec directly
(DESIGN.md §2 has the migration table) — ``Session`` additionally offers
streaming results, early-stop budgets and WAL resume, none of which this
shim exposes.
"""
from __future__ import annotations

import warnings

from repro_torch.core.data_format import DenseMatrix
from repro_torch.core.grid import SearchSpace
from repro_torch.core.results import METRICS, MultiModel
from repro_torch.core.session import SearchStats, Session
from repro_torch.core.spec import SearchSpec
from repro_torch.core.tuner import Tuner

__all__ = ["ModelSearcher", "SearchStats"]


class ModelSearcher:
    """Deprecated: build a :class:`SearchSpec` and run a :class:`Session`."""

    def __init__(self, n_executors: int = 1, seed: int = 0):
        warnings.warn(
            "ModelSearcher is deprecated; construct a SearchSpec and use "
            "Session.run(spec, train, validate) instead (see DESIGN.md §2)",
            DeprecationWarning,
            stacklevel=2,
        )
        self._spaces: list[SearchSpace] = []
        self._n_executors = n_executors
        self._policy = "lpt"
        self._profiler = None
        self._tuner: Tuner | None = None
        self._wal_path: str | None = None
        self._metric = "auc"
        self._seed = seed
        self._pool_kwargs: dict = {}
        self.stats = SearchStats()

    # -- builder API (paper Fig. 1) --------------------------------------
    def add_space(self, space: SearchSpace) -> "ModelSearcher":
        self._spaces.append(space)
        return self

    def set_scheduler(self, policy: str) -> "ModelSearcher":
        self._policy = policy
        return self

    def set_profiler(self, profiler) -> "ModelSearcher":
        self._profiler = profiler
        return self

    def set_tuner(self, tuner: Tuner) -> "ModelSearcher":
        self._tuner = tuner
        return self

    def set_metric(self, metric: str) -> "ModelSearcher":
        if metric not in METRICS:
            raise ValueError(f"unknown metric {metric!r}; known: {sorted(METRICS)}")
        self._metric = metric
        return self

    def set_wal(self, path: str | None) -> "ModelSearcher":
        self._wal_path = path
        return self

    def set_pool_options(self, **kw) -> "ModelSearcher":
        """Fault-injection / speculation knobs forwarded to the executor pool."""
        self._pool_kwargs.update(kw)
        return self

    # -- conversion + the search ------------------------------------------
    def to_spec(self) -> SearchSpec:
        """The accumulated builder state as one frozen SearchSpec."""
        return SearchSpec(
            spaces=tuple(self._spaces),
            n_executors=self._n_executors,
            policy=self._policy,
            tuner=self._tuner,
            profiler=self._profiler,
            metric=self._metric,
            seed=self._seed,
            wal_path=self._wal_path,
            pool_options=dict(self._pool_kwargs),
        )

    def model_search(
        self,
        train: DenseMatrix,
        validate: DenseMatrix | None = None,
    ) -> MultiModel:
        """Run the full search; ``validate`` is required for dynamic tuners."""
        session = Session(self.to_spec())
        multi = session.search(train, validate)
        self.stats = session.stats
        return multi
