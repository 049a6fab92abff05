"""Search-space description — the paper's GridBuilder API (Fig. 1), in Python.

A ``SearchSpace`` is a list of (estimator, param-grid) blocks; ``GridBuilder``
builds the cartesian product for one estimator. ``SearchSpec.spaces`` takes
any number of these, mirroring the paper's
``searcher.addSpace(xgbGrid).addSpace(tfGrid)...`` chain (which the
deprecated ``ModelSearcher.add_space`` still accepts verbatim).
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Mapping, Sequence

from repro_torch.core.interface import TrainTask

__all__ = ["GridBuilder", "SearchSpace", "enumerate_tasks"]


@dataclasses.dataclass(frozen=True)
class SearchSpace:
    """Concrete grid for one estimator: list of fully-specified param dicts."""

    estimator: str
    configs: tuple[Mapping[str, Any], ...]

    def __len__(self) -> int:
        return len(self.configs)


class GridBuilder:
    """Cartesian-product grid over hyperparameter values (paper Fig. 1).

    >>> grid = (GridBuilder("gbdt")
    ...         .add_grid("eta", [0.1, 0.3, 0.9])
    ...         .add_grid("rounds", [30, 60, 90])
    ...         .build())
    >>> len(grid)
    9
    """

    def __init__(self, estimator: str):
        self._estimator = estimator
        self._axes: list[tuple[str, tuple[Any, ...]]] = []

    def add_grid(self, param: str, values: Sequence[Any]) -> "GridBuilder":
        values = tuple(values)
        if not values:
            raise ValueError(f"empty value list for param {param!r}")
        if param in (name for name, _ in self._axes):
            raise ValueError(f"param {param!r} added twice")
        self._axes.append((param, values))
        return self

    def build(self) -> SearchSpace:
        if not self._axes:
            return SearchSpace(self._estimator, ({},))
        names = [n for n, _ in self._axes]
        configs = tuple(
            dict(zip(names, combo))
            for combo in itertools.product(*(v for _, v in self._axes))
        )
        return SearchSpace(self._estimator, configs)


def enumerate_tasks(spaces: Sequence[SearchSpace], start_id: int = 0) -> list[TrainTask]:
    """Flatten spaces into schedulable TrainTasks with stable ids.

    Stability matters: task_id is the WAL key for checkpoint/restart, so the
    enumeration order (space order, then config order) must be deterministic.
    """
    tasks: list[TrainTask] = []
    tid = start_id
    for space in spaces:
        for cfg in space.configs:
            tasks.append(TrainTask(task_id=tid, estimator=space.estimator, params=dict(cfg)))
            tid += 1
    return tasks
