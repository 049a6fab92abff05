"""What a measured window leaves behind: the fits that came back in it."""
from __future__ import annotations

import dataclasses
from typing import Any


@dataclasses.dataclass
class Fit:
    """One fit that came back inside the window."""
    params: dict
    trees: int              # trees fitted (boosting rounds or forest trees)
    arrived: float          # host clock when its result arrived
    train_s: float
    eval_s: float
    ok: bool
    score: float | None
    model: Any
    #: host clock (begin, end) of its training; ``arrived`` less ``eval_s``
    #: where the program reports seconds only (late by the result's hand-over)
    trained: tuple[float, float] = (0.0, 0.0)


@dataclasses.dataclass
class Window:
    t_begin: float
    t_end: float
    fits: list
    n_executors: int = 1
    searches: list = dataclasses.field(default_factory=list)   # SearchStats

    @property
    def t_last(self) -> float:
        """The arrival of the window's last result: the rate's window ends
        there, so no fit is counted in part."""
        return max((f.arrived for f in self.fits), default=self.t_end)

    @property
    def training(self) -> list[tuple[float, float]]:
        """The training spans of the fits that came back scored."""
        return [f.trained for f in self.fits if f.ok]

    @property
    def trees(self) -> int:
        return sum(f.trees for f in self.fits if f.ok)
