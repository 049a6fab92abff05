"""Unified data format and the prepared-data plane (paper §III-B).

The paper's common interface takes data in ONE uniform format — a row-oriented
dense matrix — and each ML implementation converts it into its own preferred
layout *on the executor, immediately prior to training*. This module implements
that format, the per-backend converters, and the PREPARED-DATA PLANE
(DESIGN.md §3.3) that makes conversion a once-per-process cost:

* converters are PARAMETERIZED — ``convert(data, fmt, **params)`` — so one
  registered converter serves a family of native layouts (``quantized_bins``
  at ``max_bins=64`` vs ``256`` are distinct conversions);
* :meth:`DenseMatrix.fingerprint` is a content hash, so equal-content copies
  of a dataset share prepared results;
* :class:`PreparedDataCache` keys the converted (device-resident) payload on
  ``(fingerprint, format, params, placement, device)`` with hit/miss/bytes
  accounting
  mirroring :class:`repro_torch.core.fusion.CompileCache`, and de-duplicates
  concurrent first conversions so a format is prepared EXACTLY once per
  process (per placement) no matter how many executor threads race for it.

Converters registered here are looked up by name from ``Estimator.data_format``
so that adding a new implementation (paper Fig.4's 55-144 LOC claim) never
touches the Driver.
"""
from __future__ import annotations

import dataclasses
import hashlib
import threading
import time
from collections import OrderedDict
from typing import Any, Callable, Hashable, Mapping

import numpy as np
import torch

from repro_torch.core.tenancy import TenantLedger
from repro_torch.device import default_device

__all__ = [
    "DenseMatrix",
    "register_converter",
    "unregister_converter",
    "convert",
    "available_formats",
    "format_key",
    "PreparedDataCache",
    "prepared_data_cache",
    "prepare_key",
    "prepare_cached",
    "payload_nbytes",
    "ShardedPlacement",
    "shard_payload",
    "is_sharded_payload",
    "shard_pspecs",
]


@dataclasses.dataclass(frozen=True)
class DenseMatrix:
    """Row-oriented dense matrix with labels — the paper's uniform format.

    ``x``: (rows, features) float32, C-contiguous (row-major).
    ``y``: (rows,) float32 labels (binary {0,1} for classification) or targets.
    """

    x: np.ndarray
    y: np.ndarray
    feature_names: tuple[str, ...] = ()

    def __post_init__(self):
        x = np.ascontiguousarray(np.asarray(self.x, dtype=np.float32))
        y = np.asarray(self.y, dtype=np.float32).reshape(-1)
        if x.ndim != 2:
            raise ValueError(f"DenseMatrix.x must be 2-D, got shape {x.shape}")
        if x.shape[0] != y.shape[0]:
            raise ValueError(
                f"rows mismatch: x has {x.shape[0]}, y has {y.shape[0]}"
            )
        object.__setattr__(self, "x", x)
        object.__setattr__(self, "y", y)

    def fingerprint(self) -> str:
        """Content hash: equal-content copies hash equal, any change in the
        values, shapes or feature names changes it. Memoized per instance
        (the arrays are frozen with the dataclass), so repeated cache lookups
        cost a dict read, not a re-hash."""
        cached = self.__dict__.get("_fingerprint")
        if cached is not None:
            return cached
        h = hashlib.blake2b(digest_size=16)
        h.update(repr((self.x.shape, str(self.x.dtype), self.y.shape,
                       str(self.y.dtype), self.feature_names)).encode())
        h.update(self.x.tobytes())
        h.update(self.y.tobytes())
        fp = h.hexdigest()
        object.__setattr__(self, "_fingerprint", fp)
        return fp

    @property
    def n_rows(self) -> int:
        return int(self.x.shape[0])

    @property
    def n_features(self) -> int:
        return int(self.x.shape[1])

    def sample(self, rate: float, seed: int = 0) -> "DenseMatrix":
        """Uniform row subsample — used by the profile-based scheduler (§III-C)."""
        if not 0.0 < rate <= 1.0:
            raise ValueError(f"sample rate must be in (0, 1], got {rate}")
        n = max(1, int(round(self.n_rows * rate)))
        idx = np.random.default_rng(seed).choice(self.n_rows, size=n, replace=False)
        return DenseMatrix(self.x[idx], self.y[idx], self.feature_names)

    def split(self, fractions: tuple[float, ...], seed: int = 0):
        """Split into len(fractions) DenseMatrix parts (e.g. 6:2:2)."""
        total = sum(fractions)
        idx = np.random.default_rng(seed).permutation(self.n_rows)
        out, start = [], 0
        for i, f in enumerate(fractions):
            stop = self.n_rows if i == len(fractions) - 1 else start + int(
                self.n_rows * f / total
            )
            part = idx[start:stop]
            out.append(DenseMatrix(self.x[part], self.y[part], self.feature_names))
            start = stop
        return tuple(out)

    def standardize(self, mean=None, std=None):
        """Standardize features; returns (standardized, mean, std)."""
        if mean is None:
            mean = self.x.mean(axis=0)
        if std is None:
            std = self.x.std(axis=0)
        std = np.where(std < 1e-12, 1.0, std)
        return DenseMatrix((self.x - mean) / std, self.y, self.feature_names), mean, std


# --------------------------------------------------------------------------
# Per-implementation converters (executed executor-side, post scheduling).
# --------------------------------------------------------------------------

_CONVERTERS: dict[str, Callable[..., object]] = {}


def register_converter(name: str):
    """Register ``fn`` as the converter for format ``name``.

    Re-registering the SAME function under the same name is an idempotent
    no-op (hot-reload tooling and test modules re-import freely); binding a
    DIFFERENT function to a taken name is still an error — silently
    shadowing a format would change every estimator that declares it.
    """

    def deco(fn):
        existing = _CONVERTERS.get(name)
        if existing is not None and existing is not fn:
            raise ValueError(f"converter {name!r} already registered")
        _CONVERTERS[name] = fn
        return fn

    return deco


def unregister_converter(name: str) -> None:
    """Remove a registered converter (parity with ``unregister_estimator``,
    so tests and hot-reload tooling stop leaking registry state)."""
    _CONVERTERS.pop(name, None)


def convert(data: DenseMatrix, fmt: str, **params):
    """Uniform → native conversion. ``params`` are converter kwargs (e.g.
    ``quantized_bins(max_bins=64)``) — the parameterized half of a prepared-
    data cache key (see :func:`format_key`) — plus an optional ``device``
    for the payload's tensors (default: :func:`default_device`)."""
    try:
        fn = _CONVERTERS[fmt]
    except KeyError:
        raise KeyError(
            f"unknown data format {fmt!r}; known: {sorted(_CONVERTERS)}"
        ) from None
    return fn(data, **params)


def available_formats() -> tuple[str, ...]:
    return tuple(sorted(_CONVERTERS))


def format_key(fmt: str, params: Mapping[str, Any] | None = None) -> str:
    """Canonical string for (converter name, frozen kwargs).

    This is the format half of a :class:`PreparedDataCache` key AND the
    family key of the CostModel's per-format conversion law — sorted items,
    so two dicts with the same content produce one key.
    """
    if not params:
        return fmt
    items = ",".join(f"{k}={params[k]!r}" for k in sorted(params))
    return f"{fmt}({items})"


# --------------------------------------------------------------------------
# Row-sharded placements (DESIGN.md §3.9).
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShardedPlacement:
    """Cache-key token for a row-sharded prepared-data placement.

    A prepared entry under this placement holds the converter's payload
    re-partitioned into ``n_shards`` contiguous row blocks (see
    :func:`shard_payload`); each device in the shard group is resident for
    exactly ONE block, so the entry's byte accounting is per-shard, not
    full-copy. Identity (hash/eq) is ``(n_shards, axis, tag)``:

    * ``axis`` names the shard axis the training/eval sums run over
      (``compat.sharded_call``);
    * ``tag`` separates shard GROUPS that would otherwise collide — a mesh
      pool hosting two 2-shard groups keys each group's residency apart;
    * ``mesh`` (compare=False) optionally carries the live device mesh; it
      never participates in cache identity.
    """

    n_shards: int
    axis: str = "shards"
    tag: Hashable = None
    mesh: Any = dataclasses.field(default=None, compare=False, hash=False,
                                  repr=False)

    def __post_init__(self):
        if self.n_shards < 2:
            raise ValueError(
                f"ShardedPlacement needs n_shards >= 2, got {self.n_shards}")


def is_sharded_payload(prepared) -> bool:
    """True for payloads produced by :func:`shard_payload`."""
    return isinstance(prepared, Mapping) and "_n_shards" in prepared


def _row_blocks(leaf, n_shards: int, rows_per_shard: int, pad: int):
    """``leaf`` (rows, ...) zero-padded by ``pad`` rows and stacked to
    (n_shards, rows_per_shard, ...); a tensor stays on its device."""
    if isinstance(leaf, torch.Tensor):
        if pad:
            leaf = torch.cat([leaf, leaf.new_zeros((pad,) + tuple(leaf.shape[1:]))])
        return leaf.reshape((n_shards, rows_per_shard) + tuple(leaf.shape[1:]))
    arr = np.asarray(leaf)
    if pad:
        arr = np.pad(arr, [(0, pad)] + [(0, 0)] * (arr.ndim - 1))
    return arr.reshape((n_shards, rows_per_shard) + arr.shape[1:])


def shard_payload(prepared, n_shards: int, *, n_rows: int | None = None):
    """Re-partition a converted payload into stacked per-shard row blocks.

    The FULL conversion runs first (so global statistics — quantile edges,
    label means — are identical to the unsharded entry), then every array
    or tensor leaf whose leading dimension equals the row count is split
    into ``n_shards`` contiguous blocks of ``ceil(rows / n_shards)`` rows
    (zero-padded tail) and stacked to ``(n_shards, rows_per_shard, ...)``,
    on the leaf's device. Other leaves (bin edges, scalars) are kept as
    they are. Adds:

    * ``"_shard_valid"``: (n_shards, rows_per_shard) bool — False on pad
      rows, the mask every sharded core applies before reducing;
    * ``"_n_shards"`` / ``"_n_rows"``: ints, the markers the estimators and
      :func:`payload_nbytes` key off.

    Shard ``s`` owns global rows ``[s * rows_per_shard, (s+1) *
    rows_per_shard)``: concatenating the blocks in shard order gives the
    original row order back.
    """
    if not isinstance(prepared, Mapping):
        raise TypeError("shard_payload expects a converted payload mapping, "
                        f"got {type(prepared).__name__}")
    if is_sharded_payload(prepared):
        raise ValueError("payload is already sharded")
    if n_shards < 2:
        return dict(prepared)
    if n_rows is None:
        for probe in ("y", "x", "bins"):
            leaf = prepared.get(probe)
            if leaf is not None and getattr(leaf, "ndim", 0) >= 1:
                n_rows = int(leaf.shape[0])
                break
        else:
            raise ValueError("cannot infer the payload's row count; pass n_rows=")
    rows_per_shard = -(-n_rows // n_shards)
    pad = n_shards * rows_per_shard - n_rows
    out: dict[str, Any] = {}
    device = None
    for key, leaf in prepared.items():
        if getattr(leaf, "ndim", 0) >= 1 and int(leaf.shape[0]) == n_rows:
            out[key] = _row_blocks(leaf, n_shards, rows_per_shard, pad)
            if device is None and isinstance(leaf, torch.Tensor):
                device = leaf.device
        else:
            out[key] = leaf
    valid = torch.arange(n_shards * rows_per_shard, device=device) < n_rows
    out["_shard_valid"] = valid.reshape(n_shards, rows_per_shard)
    out["_n_shards"] = int(n_shards)
    out["_n_rows"] = int(n_rows)
    return out


def shard_pspecs(prepared, axis: str = "shards"):
    """Partition-spec tree for a sharded payload: leaves stacked on the
    shard axis get ``P(axis)``, the others (and the non-array markers)
    ``P()``, so the spec tree stays leaf-aligned with the payload. With
    ``{axis: n_shards}`` axis sizes, ``distributed.sharding.bytes_per_device``
    reports per-shard residency from it."""
    from repro_torch.distributed.sharding import P

    if not is_sharded_payload(prepared):
        raise ValueError("shard_pspecs expects a shard_payload() payload")
    s = int(prepared["_n_shards"])
    return {key: P(axis) if getattr(leaf, "ndim", 0) >= 1 and int(leaf.shape[0]) == s
            else P()
            for key, leaf in prepared.items()}


# --------------------------------------------------------------------------
# Prepared-data cache (DESIGN.md §3.3).
# --------------------------------------------------------------------------

def payload_nbytes(obj) -> int:
    """Best-effort byte size of a converted payload: sum of ``.nbytes`` over
    array and tensor leaves in (possibly nested) dict/tuple/list
    containers.

    Sharded payloads (:func:`shard_payload`) report PER-SHARD residency:
    leaves stacked on the shard axis count one block (``nbytes / n_shards``),
    the others in full — the cache models what one device of the shard
    group holds, not the stack."""
    if isinstance(obj, Mapping):
        s = obj.get("_n_shards")
        if isinstance(s, int) and s > 1:
            total = 0
            for leaf in obj.values():
                b = payload_nbytes(leaf)
                if getattr(leaf, "ndim", 0) >= 1 and int(leaf.shape[0]) == s:
                    b = -(-b // s)
                total += b
            return total
        return sum(payload_nbytes(v) for v in obj.values())
    if isinstance(obj, (tuple, list)):
        return sum(payload_nbytes(v) for v in obj)
    return int(getattr(obj, "nbytes", 0) or 0)


class _PreparedEntry:
    __slots__ = ("ready", "value", "seconds", "nbytes", "error")

    def __init__(self):
        self.ready = threading.Event()
        self.value = None
        self.seconds = 0.0
        self.nbytes = 0
        self.error: BaseException | None = None


class PreparedDataCache:
    """Process-wide cache of prepared (converted, device-resident) datasets.

    Keys are ``(data fingerprint, format_key, placement, device)``; values
    are whatever the converter returned (typically a dict of tensors on the
    device).
    Mirrors :class:`repro_torch.core.fusion.CompileCache` hit/miss accounting and
    adds a bytes gauge, and unlike it DE-DUPLICATES in-flight builds: when N
    executor threads race for a cold format, one converts and the other
    N−1 block on the entry — the conversion runs EXACTLY once per key.

    ``get`` returns ``(value, seconds, built)``: ``seconds`` is the build
    time for the thread that converted and 0.0 for everyone else (waiters'
    blocked time is a startup transient, not a conversion), ``built`` tells
    observers (the CostModel conversion law) which measurement to learn from.

    GOVERNANCE (DESIGN.md §3.5): with ``budget_bytes`` set, the cache holds
    at most that many resident payload bytes — inserts that push past the
    budget evict least-recently-USED entries (``get`` refreshes recency).
    Three classes of entry are never victims: in-flight builds (``ready``
    not set — waiters hold a reference to the entry, evicting it would
    orphan them), pinned entries (``pin``/``unpin`` refcounts — executors
    pin the variant they are training on, see ``interface.run_prepared``),
    and the entry being inserted right now (so a single over-budget variant
    still serves its own build). An evicted key simply becomes cold: the
    next ``get`` is a miss whose owner rebuilds it exactly once, through
    the same in-flight de-dup as the first build.

    Per-tenant accounting: ``hits``/``misses``/``bytes_built`` are also
    recorded against :func:`repro_torch.core.tenancy.current_tenant` in the same
    critical sections, so ``tenant_counters()`` sums EXACTLY to the global
    counters (``bytes_built`` is cumulative — the ``bytes_cached`` gauge
    drops on eviction and is not per-tenant attributable).
    """

    def __init__(self, *, budget_bytes: int | None = None,
                 name: str = "prepared"):
        self.name = name
        self._entries: OrderedDict[Hashable, _PreparedEntry] = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.bytes_built = 0
        self._bytes = 0
        self._budget = budget_bytes
        self._pins: dict[Hashable, int] = {}
        self._ledger = TenantLedger()

    def get(self, key: Hashable, builder: Callable[[], object],
            ) -> tuple[object, float, bool]:
        with self._lock:
            entry = self._entries.get(key)
            owner = entry is None
            if owner:
                entry = self._entries[key] = _PreparedEntry()
                self.misses += 1       # misses = builds attempted
                self._ledger.add("misses")
        if owner:
            t0 = time.perf_counter()
            try:
                entry.value = builder()       # convert outside the lock
            except BaseException as e:
                entry.error = e
                with self._lock:              # failed builds don't poison the key
                    self._entries.pop(key, None)
                entry.ready.set()
                raise
            entry.seconds = time.perf_counter() - t0
            entry.nbytes = payload_nbytes(entry.value)
            with self._lock:
                self._bytes += entry.nbytes
                self.bytes_built += entry.nbytes
                self._ledger.add("bytes", entry.nbytes)
                self._entries.move_to_end(key)
                self._evict_locked(keep=key)
            entry.ready.set()
            return entry.value, entry.seconds, True
        entry.ready.wait()
        if entry.error is not None:
            # the build we waited on failed; retry (we may become the owner).
            # Nothing was counted for THIS caller yet, so the retry's own
            # hit-or-miss is the only accounting it leaves behind.
            return self.get(key, builder)
        with self._lock:
            self.hits += 1             # hits = served from a completed build
            self._ledger.add("hits")
            if self._entries.get(key) is entry:   # may have been evicted
                self._entries.move_to_end(key)
        return entry.value, 0.0, False

    def _evict_locked(self, keep: Hashable = None) -> None:
        """Evict LRU-first until within budget. Caller holds ``self._lock``."""
        if self._budget is None:
            return
        while self._bytes > self._budget:
            victim = next(
                (k for k, e in self._entries.items()
                 if k != keep and e.ready.is_set() and e.error is None
                 and not self._pins.get(k)),
                None)
            if victim is None:
                return                 # everything left is in-flight/pinned/keep
            e = self._entries.pop(victim)
            self._bytes -= e.nbytes
            self.evictions += 1

    def pin(self, key: Hashable) -> None:
        """Protect ``key`` from eviction until a matching :meth:`unpin`.
        Refcounted; pinning a key that is not (yet) resident is allowed."""
        with self._lock:
            self._pins[key] = self._pins.get(key, 0) + 1

    def unpin(self, key: Hashable) -> None:
        with self._lock:
            n = self._pins.get(key, 0) - 1
            if n <= 0:
                self._pins.pop(key, None)
            else:
                self._pins[key] = n
            self._evict_locked()       # eviction deferred by the pin runs now

    def set_budget(self, budget_bytes: int | None) -> None:
        with self._lock:
            self._budget = budget_bytes
            self._evict_locked()

    @property
    def budget_bytes(self) -> int | None:
        with self._lock:
            return self._budget

    def contains(self, key: Hashable) -> bool:
        with self._lock:
            return key in self._entries

    def counters(self) -> tuple[int, int]:
        with self._lock:
            return self.hits, self.misses

    def tenant_counters(self) -> dict[str, dict[str, float]]:
        """Per-tenant ``{"hits", "misses", "bytes"}``; sums exactly to the
        global ``hits``/``misses``/``bytes_built`` (satellite-2 invariant)."""
        with self._lock:
            return self._ledger.snapshot()

    @property
    def n_entries(self) -> int:
        with self._lock:
            return len(self._entries)

    @property
    def bytes_cached(self) -> int:
        with self._lock:
            return self._bytes

    @property
    def hit_rate(self) -> float:
        hits, misses = self.counters()
        total = hits + misses
        return hits / total if total else 0.0

    def sharded_resident_bytes(self) -> int:
        """Per-shard resident bytes across every ready entry keyed by a
        :class:`ShardedPlacement` (entry ``nbytes`` is already per-shard —
        see :func:`payload_nbytes`): what ``SearchStats.shard_residency_bytes``
        reports (DESIGN.md §3.9)."""
        with self._lock:
            return sum(
                e.nbytes for k, e in self._entries.items()
                if e.ready.is_set() and isinstance(k, tuple)
                and any(isinstance(part, ShardedPlacement) for part in k))

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self.hits = 0
            self.misses = 0
            self.evictions = 0
            self.bytes_built = 0
            self._bytes = 0
            self._pins.clear()
            self._ledger.clear()


_GLOBAL_PREPARED = PreparedDataCache()


def prepared_data_cache() -> PreparedDataCache:
    """The process-wide cache shared by every executor pool (and, through
    ``SearchStats.prepared_cache_*``, read by every Session)."""
    return _GLOBAL_PREPARED


def prepare_key(data: DenseMatrix, fmt: str,
                params: Mapping[str, Any] | None = None,
                placement: Hashable = None, device=None) -> tuple:
    """The full cache key for one prepared variant. ``placement`` keys
    residency per executor placement (None = the process default; a mesh
    pool's per-slice token; a :class:`ShardedPlacement` for a row-sharded
    partition whose entry holds per-shard blocks), and the resolved
    ``device`` (see :func:`repro_torch.device.default_device`) is
    part of the key, so CPU and CUDA payloads of one dataset never
    collide."""
    return (data.fingerprint(), format_key(fmt, params), placement,
            str(default_device(device)))


def prepare_cached(data: DenseMatrix, fmt: str,
                   params: Mapping[str, Any] | None = None, *,
                   cache: PreparedDataCache | None = None,
                   placement: Hashable = None,
                   device=None) -> tuple[object, float, bool]:
    """Convert through the prepared-data cache onto ``device`` (default:
    :func:`~repro_torch.device.default_device`); returns
    ``(prepared, convert_seconds, built)`` — see
    :meth:`PreparedDataCache.get`.

    Under a :class:`ShardedPlacement` the builder converts the FULL dataset
    first (global statistics identical to the replicated entry) and then
    row-shards the payload (:func:`shard_payload`) — still exactly-once per
    key through the in-flight de-dup, with per-shard byte accounting."""
    cache = cache if cache is not None else prepared_data_cache()
    dev = default_device(device)
    key = prepare_key(data, fmt, params, placement, dev)

    def build():
        prepared = convert(data, fmt, **dict(params or {}), device=dev)
        if isinstance(placement, ShardedPlacement):
            prepared = shard_payload(prepared, placement.n_shards)
        return prepared

    return cache.get(key, build)


def _on(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(default_device(device))


@register_converter("dense_rows")
def _dense_rows(data: DenseMatrix, device=None):
    """Row batches on device — MLP / LogReg style."""
    return {"x": _on(data.x, device), "y": _on(data.y, device)}


@register_converter("dense_cols")
def _dense_cols(data: DenseMatrix, device=None):
    """Column-oriented (features-major) — linear-scan style implementations."""
    return {"xt": _on(data.x.T, device), "y": _on(data.y, device)}


def _bin_ids(edges: np.ndarray, xt: np.ndarray) -> np.ndarray:
    """(n_rows, n_feat) int32: ``np.searchsorted(edges[:, f], xt[f],
    side="left")`` for every feature f, in one torch call over both in
    their common dtype, as numpy compares them. numpy orders NaN after
    every number and torch's search does not, so edges with a NaN take
    numpy's loop."""
    if np.isnan(edges).any():
        return np.stack([np.searchsorted(edges[:, f], xt[f], side="left")
                         for f in range(xt.shape[0])], axis=1).astype(np.int32)
    dt = np.result_type(edges, xt)
    ids = torch.searchsorted(torch.from_numpy(np.ascontiguousarray(edges.T, dt)),
                             torch.from_numpy(xt.astype(dt)), side="left", out_int32=True)
    return ids.T.contiguous().numpy()


@register_converter("quantized_bins")
def _quantized_bins(data: DenseMatrix, max_bins: int = 256, device=None):
    """Histogram-quantized column bins — GBDT (XGBoost hist / LightGBM) style.

    Per feature: quantile-based bin edges, values mapped to int32 bin ids.
    This is the format conversion the paper describes happening just before
    training on the executor. ``max_bins`` is a CONVERTER PARAMETER
    (``Estimator.format_params``): gbdt prepares at its ``max_bin``
    hyperparameter directly, so each (dataset, max_bins) pair is one
    prepared-data cache entry instead of a per-task re-quantization.
    """
    if max_bins < 2:
        raise ValueError(f"max_bins must be >= 2, got {max_bins}")
    xt = np.ascontiguousarray(data.x.T)        # (n_feat, n_rows): a feature a row
    n_bins = min(max_bins, max(2, xt.shape[1]))
    qs = np.linspace(0.0, 1.0, n_bins + 1)[1:-1]
    # np.quantile(x, qs, axis=0) from sorted columns, which skips its
    # selection per quantile: the order statistics are the same values,
    # bit for bit but for the sign of a zero, so a column holding -0.0
    # takes np.quantile's own selection
    xs = np.sort(xt, axis=1)
    edges = np.quantile(xs, qs, axis=1)                   # (n_bins-1, n_feat)
    neg0 = (np.signbit(xs) & (xs == 0)).any(axis=1)
    if neg0.any():
        edges[:, neg0] = np.quantile(xt[neg0], qs, axis=1)
    del xs
    binned = _bin_ids(edges, xt)
    return {
        "bins": _on(binned, device),
        "edges": _on(edges.T.astype(np.float32), device),  # (n_feat, n_bins-1)
        "y": _on(data.y, device),
        "n_bins": n_bins,
    }


@register_converter("eval_dense")
def _eval_dense(data: DenseMatrix, device=None):
    """Device-resident features for the executor-side validation plane
    (DESIGN.md §3.4) — every shipped family's jitted predictor routes raw
    rows. Labels deliberately stay OUT of the entry: the metric is a cheap
    numpy reduction against host-side ``y``, so device-putting labels per
    placement would only inflate ``bytes_cached``. A separate format (not
    ``dense_rows``) so eval residency is visible in the cache accounting
    and an eval split never masquerades as training data."""
    return {"x": _on(data.x, device)}


@register_converter("sparse_csr")
def _sparse_csr(data: DenseMatrix, device=None):
    """Compressed Sparse Row format for sparse-leaning implementations.

    CSR invariants: row ``r``'s nonzeros are exactly
    ``values[indptr[r]:indptr[r+1]]`` with ascending column indices, and
    ``indptr`` is consistent with that ordering. ``np.nonzero`` documents
    row-major (C-style) index order, which IS the CSR canonical order — the
    dense↔CSR round-trip test pins the invariant.

    The paper notes the common format *should* adapt to data sparsity but its
    framework ships dense-only; we provide the converter the paper lists as
    future work to demonstrate the interface supports it.
    """
    x = data.x
    rows, cols = np.nonzero(x)           # row-major order: CSR-canonical
    values = x[rows, cols]
    counts = np.bincount(rows, minlength=x.shape[0])
    indptr = np.concatenate(
        [np.zeros(1, np.int64), np.cumsum(counts)]).astype(np.int32)
    return {
        "values": _on(values, device),
        "col_idx": _on(cols.astype(np.int32), device),
        "indptr": _on(indptr, device),
        "shape": x.shape,
        "y": _on(data.y, device),
    }
