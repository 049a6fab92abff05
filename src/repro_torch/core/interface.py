"""Common interfaces that hide ML-implementation differences (paper §III-B).

The Driver only ever talks to ``Estimator`` — implementers plug a new ML
implementation in by subclassing it (or calling :func:`register_estimator` on a
factory) and declaring which uniform-format conversion it wants. The Driver is
never modified (the paper's key extensibility claim).

``Estimator.train`` receives data ALREADY converted to the implementation's
declared ``data_format`` — conversion runs executor-side (see executor.py),
matching the paper's design where the format gap is resolved on the Executors.

The prepared-data plane (DESIGN.md §3.3) splits the old monolithic
``Estimator.run`` into ``prepare(raw, params) -> prepared`` +
``train(prepared, params)``: estimators declare ``data_format`` AND
``format_params(params)`` (converter kwargs derived from hyperparameters,
e.g. gbdt's ``max_bin``), and the executors resolve ``prepare`` through the
process-wide :class:`~repro_torch.core.data_format.PreparedDataCache` via
:func:`run_prepared` / :func:`run_prepared_batched` — so each
(dataset fingerprint, format, converter params, placement) combination
converts ONCE per process and every task after the first trains on the
device-resident prepared result. ``run``/``run_batched`` remain as the
uncached convenience path; a third-party subclass that overrides them keeps
working (the executors detect the override and fall back, bypassing the
cache — see the migration notes in DESIGN.md §3.3).
"""
from __future__ import annotations

import abc
import base64
import dataclasses
import io
import time
from typing import Any, Callable, Hashable, Mapping, Sequence

import numpy as np
import torch

from repro_torch.core.data_format import (
    DenseMatrix,
    convert,
    prepare_key,
    prepared_data_cache,
)

__all__ = [
    "Estimator",
    "TrainedModel",
    "TrainTask",
    "RungTask",
    "ResumeState",
    "TaskResult",
    "register_estimator",
    "unregister_estimator",
    "get_estimator",
    "estimator_names",
    "format_law_key",
    "prepared_cache_key",
    "run_prepared",
    "run_prepared_batched",
    "run_prepared_resumable",
]


def _wire_encode(value):
    """JSON-safe encoding of one ResumeState payload value (ndarray → b64 npy)."""
    if isinstance(value, np.ndarray):
        buf = io.BytesIO()
        np.save(buf, value, allow_pickle=False)
        return {"__nd__": base64.b64encode(buf.getvalue()).decode("ascii")}
    if isinstance(value, (np.integer,)):
        return int(value)
    if isinstance(value, (np.floating,)):
        return float(value)
    return value


def _wire_decode(value):
    if isinstance(value, dict) and "__nd__" in value:
        return np.load(io.BytesIO(base64.b64decode(value["__nd__"])),
                       allow_pickle=False)
    return value


@dataclasses.dataclass
class ResumeState:
    """Opaque-to-the-driver carryover of a partially trained config.

    ``payload`` maps names to numpy arrays / scalars — whatever the family
    needs to continue bit-exactly (trees/margins for gbdt, weight + Adam
    moment stacks + PRNG key for the step families). ``budget`` is the
    ABSOLUTE number of budget units already trained (``Estimator.budget_param``
    units), so a resume call trains only ``budget_target - budget`` more.

    States are tied to the prepared dataset they were trained on (gbdt's
    carried margin has one entry per training row); resuming against a
    different dataset is undefined. :meth:`to_wire`/:meth:`from_wire` give a
    JSON-safe form for the WAL so ``Session.resume`` can restart mid-rung.
    """

    estimator: str
    budget: int
    payload: dict[str, Any]

    def to_wire(self) -> dict[str, Any]:
        return {"estimator": self.estimator, "budget": int(self.budget),
                "payload": {k: _wire_encode(v) for k, v in self.payload.items()}}

    @classmethod
    def from_wire(cls, wire: Mapping[str, Any]) -> "ResumeState":
        return cls(estimator=str(wire["estimator"]), budget=int(wire["budget"]),
                   payload={k: _wire_decode(v)
                            for k, v in dict(wire["payload"]).items()})


@dataclasses.dataclass(frozen=True)
class TrainTask:
    """One unit of schedulable work: (implementation, hyperparameters).

    ``cost`` is filled in by the profiler (seconds, estimated); ``task_id`` is
    stable across restarts so the fault-tolerance WAL can identify work.
    """

    task_id: int
    estimator: str
    params: Mapping[str, Any]
    cost: float | None = None

    def with_cost(self, cost: float) -> "TrainTask":
        return dataclasses.replace(self, cost=float(cost))

    def key(self) -> str:
        items = ",".join(f"{k}={self.params[k]!r}" for k in sorted(self.params))
        return f"{self.estimator}({items})"


@dataclasses.dataclass(frozen=True)
class RungTask(TrainTask):
    """A partial-budget training unit in an adaptive search (DESIGN.md §3.6).

    Subclasses :class:`TrainTask`, so the whole planning surface — profiler,
    CostModel, scheduler, WAL, executor pools — handles it unchanged.
    ``params`` already carry ``budget_param = budget`` (the ABSOLUTE target),
    which keeps ``key()`` distinct per rung and — because budget params are
    never format params — the prepared-data and compile-cache keys identical
    across a config's rungs, so a promoted rung is a warm cache hit.

    ``state`` is the previous rung's :class:`ResumeState` (None at rung 0, or
    when the family cannot resume — executors then train from scratch at the
    absolute budget, which is correct, just not warm). Excluded from equality
    and repr: two rungs are the same unit regardless of carried weights.
    """

    config_id: int = -1
    rung: int = 0
    budget: int = 0
    prev_budget: int = 0
    budget_param: str = ""
    state: "ResumeState | None" = dataclasses.field(
        default=None, compare=False, repr=False)


@dataclasses.dataclass
class TaskResult:
    task: TrainTask
    model: "TrainedModel | None"
    train_seconds: float
    executor_id: int
    error: str | None = None
    #: >1 when this task ran inside a fused batch (core/fusion.py);
    #: ``train_seconds`` is then the AMORTIZED share (batch total / size), so
    #: downstream consumers — the WAL, the CostModel observer — need no
    #: fusion-specific handling
    batch_size: int = 1
    #: uniform→native conversion seconds this task actually paid. Non-zero
    #: only for the task that BUILT a prepared-data cache entry (fused: the
    #: amortized share); cache hits report 0.0. ``train_seconds`` never
    #: includes it — the two costs feed separate CostModel laws.
    convert_seconds: float = 0.0
    #: validation-metric value computed EXECUTOR-SIDE (DESIGN.md §3.4) when
    #: the submit carried an EvalPlan; None when scoring was off (no
    #: validation data / foreign backend) or failed. The Session streams
    #: this straight through, so ranked results need no driver predict.
    score: float | None = None
    #: seconds this task's executor spent scoring it (fused: the amortized
    #: share of the batch's one predict program; includes the one-time eval
    #: data conversion for the task that built the entry). Feeds the
    #: CostModel's per-family eval law — never part of ``train_seconds``.
    eval_seconds: float = 0.0
    #: carryover for the NEXT rung when ``task`` was a :class:`RungTask` and
    #: the family supports warm resume; journalled in the WAL alongside the
    #: completion record so mid-rung restarts stay warm. None otherwise.
    resume_state: "ResumeState | None" = None
    # -- fault plane (DESIGN.md §3.7) ----------------------------------
    #: total attempts this task burned before producing THIS result (1 =
    #: first try; a terminal error result after k retries reports k+1).
    #: ``SearchStats.n_retries`` sums the excess.
    attempts: int = 1
    #: True when the task was quarantined: it was claimed by
    #: ``poison_threshold`` executors that all died, so the pool surfaces
    #: this error result instead of re-queueing it a cascade-killing third
    #: time. ``error`` is set; ``SearchStats.n_quarantined`` counts these.
    quarantined: bool = False
    #: True when the task blew its hard wall-clock deadline on every
    #: allowed attempt; ``train_seconds`` then holds the elapsed time the
    #: last abandoned attempt burned, which the CostModel observes as a
    #: censored runtime so the estimate that missed stops being trusted.
    timed_out: bool = False

    @property
    def ok(self) -> bool:
        return self.error is None


class TrainedModel(abc.ABC):
    """Prediction side of the common interface."""

    @abc.abstractmethod
    def predict_proba(self, x: np.ndarray) -> np.ndarray:
        """Return P(y=1) scores, shape (rows,)."""

    def predict(self, x: np.ndarray) -> np.ndarray:
        return (self.predict_proba(x) >= 0.5).astype(np.float32)

    # ---- fused validation plane (DESIGN.md §3.4) ------------------------
    def predict_proba_device(self, x, *, cache=None) -> np.ndarray:
        """Device-side scoring path: P(y=1) for device-resident features
        (the executors pass the prepared eval entry's ``x``, a tensor). The
        shipped families override this with a batched tensor program on
        ``x``'s device; this fallback keeps third-party models scoreable
        executor-side by moving ``x`` to numpy (``.cpu().numpy()``)."""
        del cache
        if isinstance(x, torch.Tensor):
            x = x.cpu().numpy()
        return np.asarray(self.predict_proba(np.asarray(x)))

    @classmethod
    def predict_proba_batched(cls, models: Sequence["TrainedModel"], x, *,
                              cache=None) -> np.ndarray:
        """Score a stacked model batch; returns (batch, rows) probabilities.

        A fused unit's models share padded shapes by construction
        (``train_batched``), so family overrides vmap the whole stack
        through ONE compiled program; this fallback scores model by model.
        """
        return np.stack([np.asarray(m.predict_proba_device(x, cache=cache))
                         for m in models])


class Estimator(abc.ABC):
    """Training side of the common interface.

    Subclasses declare:
      * ``name`` — registry key, referenced from search spaces,
      * ``data_format`` — which uniform-format converter to apply executor-side,
      * ``format_params(params)`` — converter kwargs derived from the
        hyperparameters (optional; defaults to none),
      * ``train(converted_data, params)`` — returns a TrainedModel.
    """

    #: registry key
    name: str = ""
    #: converter name from repro_torch.core.data_format
    data_format: str = "dense_rows"
    #: converter the executor-side validation plane (§3.4) resolves the EVAL
    #: split through — one PreparedDataCache entry per (fingerprint, format,
    #: placement), shared by every family declaring the same format. The
    #: shipped families' device predictors all route raw device rows, so the
    #: default ``eval_dense`` (features only; labels stay host-side for the
    #: numpy metric) serves all four.
    eval_format: str = "eval_dense"
    #: the hyperparameter that acts as the resumable-budget axis for adaptive
    #: search (gbdt ``"round"``, forest ``"n_estimators"``, logreg/mlp
    #: ``"steps"``). None = the family declares no budget axis; rung tasks
    #: then need an explicit ``budget_param`` from the tuner, and the default
    #: :meth:`train_resumable` retrains from scratch each rung.
    budget_param: str | None = None

    @abc.abstractmethod
    def train(self, data: Any, params: Mapping[str, Any]) -> TrainedModel:
        ...

    def default_params(self) -> dict[str, Any]:
        return {}

    # ---- adaptive search (DESIGN.md §3.6) -------------------------------
    def train_resumable(self, data: Any, params: Mapping[str, Any], *,
                        budget: int, state: "ResumeState | None" = None,
                        ) -> tuple[TrainedModel, "ResumeState | None"]:
        """Train to the ABSOLUTE ``budget`` (in :attr:`budget_param` units),
        warm-starting from ``state`` when given; returns ``(model, state')``
        where ``state'`` resumes the next rung.

        This default keeps third-party estimators working in adaptive
        searches without any new code: it trains from scratch at the
        absolute budget and returns no carryover — correct semantics, no
        warm start. The shipped families override it (trees append
        rounds/trees bit-exactly; step families carry weights + Adam moments
        + PRNG key through the masked-carry scan machinery).
        """
        del state
        p = dict(params)
        if self.budget_param:
            p[self.budget_param] = int(budget)
        return self.train(data, p), None

    # ---- prepared-data plane (DESIGN.md §3.3) ---------------------------
    def format_params(self, params: Mapping[str, Any]) -> dict[str, Any]:
        """Converter kwargs this config needs (e.g. gbdt returns
        ``{"max_bins": params["max_bin"]}``). Together with ``data_format``
        and the data fingerprint this forms the prepared-data cache key, so
        two configs returning equal kwargs SHARE one prepared dataset.

        Contract for fusion: any hyperparameter that changes the result must
        also be captured by :meth:`fuse_signature` — a fused batch converts
        once, so all its members must agree on the format (``fuse_tasks``
        additionally groups on the resolved kwargs as a guard).
        """
        return {}

    def prepare(self, raw: DenseMatrix, params: Mapping[str, Any] | None = None):
        """Uniform → native conversion for one config (UNCACHED — the
        executors route this through the process-wide PreparedDataCache via
        :func:`run_prepared`; call it directly only for one-off conversions)."""
        return convert(raw, self.data_format,
                       **self.format_params(dict(params or {})))

    # ---- task fusion (core/fusion.py, DESIGN.md §3.2) -------------------
    def fuse_signature(self, params: Mapping[str, Any]):
        """Hashable group key for configs that can train as ONE fused batch
        (vmap over hyperparameters), or ``None`` when this estimator (or this
        config) cannot fuse. Configs sharing a signature may still differ in
        structural params — ``train_batched`` pads those to the per-batch max.
        """
        return None

    def fuse_bucket(self, params: Mapping[str, Any]) -> tuple:
        """Coarse structural bucket within a fuse group. Fusion sorts a group
        by bucket VALUE so each batch pads over near-equals — return
        like-typed, totally-orderable tuples (ints, pow-2 rounded UP to match
        the padding) — and the scheduler may split a fused batch at bucket
        boundaries when rebalancing."""
        return ()

    def train_batched(self, data: Any, configs, *, cache=None) -> list[TrainedModel]:
        """Train ``configs`` as one fused device program; one model per config.

        Only meaningful for configs sharing :meth:`fuse_signature`; ``cache``
        is a :class:`repro_torch.core.fusion.CompileCache` (process-wide default
        when None) keying the compiled batched program on the static-shape
        signature, so later batches of the same shape skip compilation.
        """
        raise NotImplementedError(f"{self.name} does not support fused batches")

    # ---- executor-side entry point -------------------------------------
    def run(self, raw: DenseMatrix, params: Mapping[str, Any]) -> tuple[TrainedModel, float]:
        """Convert (uniform → native) then train; returns (model, seconds).

        This is the paper's executor pipeline: the format gap is resolved
        here, immediately prior to training, never in the Driver. ``seconds``
        is TRAINING time only — conversion is accounted separately
        (``TaskResult.convert_seconds``) by the cached executor path,
        :func:`run_prepared`, which the pools use instead of this method
        unless a subclass overrides it.
        """
        converted = self.prepare(raw, params)
        t0 = time.perf_counter()
        model = self.train(converted, dict(params))
        return model, time.perf_counter() - t0

    def run_batched(self, raw: DenseMatrix, params_list, *, cache=None) -> tuple[list[TrainedModel], float]:
        """Fused-batch analogue of :meth:`run`: convert once, train the whole
        config stack as one program; returns (models, total_seconds). Callers
        amortize ``total_seconds`` over the batch for per-task accounting.
        The batch converts ONCE, so members must agree on ``format_params``
        (``fuse_tasks`` guarantees this for executor batches; a direct call
        with mixed formats raises rather than silently training some
        members on another config's data layout)."""
        _batch_format_params(self, params_list)
        converted = self.prepare(raw, params_list[0] if params_list else None)
        t0 = time.perf_counter()
        models = self.train_batched(converted, [dict(p) for p in params_list], cache=cache)
        return models, time.perf_counter() - t0


# --------------------------------------------------------------------------
# Cached executor paths (the prepared-data plane, DESIGN.md §3.3).
# --------------------------------------------------------------------------

def _batch_format_params(est: Estimator, params_list) -> dict[str, Any]:
    """The (validated-uniform) format params of a batch: every member must
    resolve to the same converter kwargs, because the batch converts once."""
    if not params_list:
        return {}
    fps = [est.format_params(dict(p)) for p in params_list]
    for fp in fps[1:]:
        if fp != fps[0]:
            raise ValueError(
                f"{est.name or type(est).__name__}: batched configs must be "
                f"format-uniform (a batch converts once), got format_params "
                f"{fps[0]!r} vs {fp!r}")
    return fps[0]


def format_law_key(est: Estimator, params: Mapping[str, Any]) -> str:
    """Family key of the CostModel's per-format conversion law: the format
    key, discriminated by estimator name when :meth:`Estimator.prepare` is
    overridden — a custom prepare is its own recipe and must not pool its
    timings with (or serve estimates to) other users of the same declared
    format. Mirrors the discriminator of :func:`prepared_cache_key`."""
    from repro_torch.core.data_format import format_key

    key = format_key(est.data_format, est.format_params(dict(params)))
    if type(est).prepare is not Estimator.prepare:
        key += f"@{est.name or type(est).__qualname__}"
    return key


def prepared_cache_key(est: Estimator, raw: DenseMatrix,
                       params: Mapping[str, Any],
                       placement: Hashable = None) -> tuple:
    """The PreparedDataCache key this estimator's config resolves to.

    Standard estimators key purely on (fingerprint, format_key, placement),
    so implementations sharing a format (logreg/mlp on ``dense_rows``) share
    entries. An estimator that OVERRIDES :meth:`Estimator.prepare` gets its
    registry name appended as a discriminator — its prepared payload is its
    own recipe, and must not collide with (or be served to) other users of
    the same declared format.
    """
    key = prepare_key(raw, est.data_format,
                      est.format_params(dict(params)), placement)
    if type(est).prepare is not Estimator.prepare:
        key += (est.name or type(est).__qualname__,)
    return key


def _prepare_for(est: Estimator, raw: DenseMatrix, params: Mapping[str, Any],
                 cache, placement: Hashable) -> tuple[object, float, object, Hashable]:
    """Resolve ``est.prepare`` through the cache; returns
    ``(prepared, convert_seconds, cache, key)`` — builds go through
    :meth:`Estimator.prepare` itself, so ``prepare`` overrides are honored
    on the executor path (keyed per-estimator via
    :func:`prepared_cache_key`). The cache + key come back so callers can
    ``pin`` the entry for the duration of training: under a byte budget
    (DESIGN.md §3.5) the variant a worker is actively training on must not
    be an eviction victim."""
    cache = cache if cache is not None else prepared_data_cache()
    key = prepared_cache_key(est, raw, params, placement)

    def build():
        from repro_torch.core.data_format import ShardedPlacement, shard_payload

        prepared = est.prepare(raw, params)
        if isinstance(placement, ShardedPlacement):
            # row-shard AFTER the full conversion so global statistics
            # (quantile edges, label priors) match the unsharded entry
            prepared = shard_payload(prepared, placement.n_shards)
        return prepared

    prepared, seconds, _ = cache.get(key, build)
    return prepared, seconds, cache, key


def run_prepared(
    est: Estimator,
    raw: DenseMatrix,
    params: Mapping[str, Any],
    *,
    cache=None,
    placement: Hashable = None,
) -> tuple[TrainedModel, float, float]:
    """Cache-resolved ``run``: returns ``(model, train_seconds,
    convert_seconds)``. Conversion goes through the process-wide
    :class:`~repro_torch.core.data_format.PreparedDataCache` (or ``cache``), keyed
    by :func:`prepared_cache_key` — ``convert_seconds`` is non-zero only
    when THIS call built the entry.

    A subclass that overrides :meth:`Estimator.run` (pre-§3.3 third-party
    code) takes its own path, uncached, with conversion unseparable from
    training (reported as 0.0) — see DESIGN.md §3.3 migration notes.
    """
    if type(est).run is not Estimator.run:
        model, secs = est.run(raw, params)
        return model, secs, 0.0
    prepared, convert_seconds, pcache, key = _prepare_for(
        est, raw, params, cache, placement)
    pcache.pin(key)
    try:
        t0 = time.perf_counter()
        model = est.train(prepared, dict(params))
        return model, time.perf_counter() - t0, convert_seconds
    finally:
        pcache.unpin(key)


def run_prepared_resumable(
    est: Estimator,
    raw: DenseMatrix,
    params: Mapping[str, Any],
    *,
    budget: int,
    state: "ResumeState | None" = None,
    cache=None,
    placement: Hashable = None,
) -> tuple[TrainedModel, float, float, "ResumeState | None"]:
    """Cache-resolved :meth:`Estimator.train_resumable`: returns
    ``(model, train_seconds, convert_seconds, new_state)``. The prepared-data
    resolution is IDENTICAL to :func:`run_prepared` — budget params are never
    format params, so every rung of a config is a warm cache hit after the
    first. A subclass that overrides :meth:`Estimator.run` (pre-§3.3 code)
    takes its own uncached path at the absolute budget, with no carryover.
    """
    if type(est).run is not Estimator.run:
        p = dict(params)
        if est.budget_param:
            p[est.budget_param] = int(budget)
        model, secs = est.run(raw, p)
        return model, secs, 0.0, None
    prepared, convert_seconds, pcache, key = _prepare_for(
        est, raw, params, cache, placement)
    pcache.pin(key)
    try:
        t0 = time.perf_counter()
        model, new_state = est.train_resumable(
            prepared, dict(params), budget=int(budget), state=state)
        return model, time.perf_counter() - t0, convert_seconds, new_state
    finally:
        pcache.unpin(key)


def run_prepared_batched(
    est: Estimator,
    raw: DenseMatrix,
    params_list: Sequence[Mapping[str, Any]],
    *,
    cache=None,
    placement: Hashable = None,
    compile_cache=None,
) -> tuple[list[TrainedModel], float, float]:
    """Cache-resolved ``run_batched``: returns ``(models, total_train_seconds,
    convert_seconds)``. One conversion serves the whole batch — and, because
    the cache key is identical, the SEQUENTIAL path of the same format: a
    fused batch and a solo task of one (dataset, format, params) share one
    prepared entry. Falls back to a subclass's own ``run_batched`` override
    exactly like :func:`run_prepared` does for ``run``."""
    if type(est).run_batched is not Estimator.run_batched:
        models, secs = est.run_batched(raw, params_list, cache=compile_cache)
        return models, secs, 0.0
    _batch_format_params(est, params_list)   # mixed formats fail loud
    first = dict(params_list[0]) if params_list else {}
    prepared, convert_seconds, pcache, key = _prepare_for(
        est, raw, first, cache, placement)
    pcache.pin(key)
    try:
        t0 = time.perf_counter()
        models = est.train_batched(prepared, [dict(p) for p in params_list],
                                   cache=compile_cache)
        return models, time.perf_counter() - t0, convert_seconds
    finally:
        pcache.unpin(key)


_REGISTRY: dict[str, Callable[[], Estimator]] = {}


def register_estimator(obj: Callable[[], Estimator] | type[Estimator] | Estimator):
    """Register an Estimator under its ``name``; returns ``obj`` unchanged.

    Accepts three forms (usable as a decorator on the first two):

    * an ``Estimator`` subclass — instantiated fresh on every lookup;
    * a zero-arg factory returning an ``Estimator`` — called on every lookup
      (lets implementations close over config or lazy imports);
    * a ready ``Estimator`` instance — the SAME object is returned by every
      lookup, so it must be stateless across ``train`` calls.

    This plus the subclass body is the entire "glue code" needed to add a new
    ML implementation (paper Fig. 4).
    """
    if isinstance(obj, type):
        if not issubclass(obj, Estimator):
            raise TypeError(f"{obj.__name__} must subclass Estimator")
        probe, factory = obj(), obj
    elif isinstance(obj, Estimator):
        probe, factory = obj, (lambda inst=obj: inst)
    elif callable(obj):
        probe = obj()
        if not isinstance(probe, Estimator):
            raise TypeError(f"factory {obj!r} returned {type(probe).__name__}, "
                            "not an Estimator")
        factory = obj
    else:
        raise TypeError(f"cannot register {type(obj).__name__}: expected an "
                        "Estimator class, factory, or instance")
    if not probe.name:
        raise ValueError(f"{obj} must set a non-empty .name")
    if probe.name in _REGISTRY:
        raise ValueError(f"estimator {probe.name!r} already registered")
    _REGISTRY[probe.name] = factory
    return obj


def unregister_estimator(name: str) -> None:
    """Remove a registered estimator (tests and hot-reload tooling)."""
    _REGISTRY.pop(name, None)


def get_estimator(name: str) -> Estimator:
    try:
        return _REGISTRY[name]()
    except KeyError:
        raise KeyError(
            f"unknown estimator {name!r}; registered: {sorted(_REGISTRY)}"
        ) from None


def estimator_names() -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY))
