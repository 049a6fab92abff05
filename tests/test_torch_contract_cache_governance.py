"""The JAX package's ``tests/test_cache_governance.py`` contracts, run against the port.

The same tests with ``repro`` read as ``repro_torch`` and the device
predictors' ``predict_*_jax`` as ``predict_*_device``, on the CPU
(``set_default_device("cpu")``).

The reference file's own description:

    Budgeted shared caches (DESIGN.md §3.5): byte budgets + LRU eviction on
    PreparedDataCache/CompileCache, pin/in-flight protection, exactly-once
    rebuild of evicted entries, and the per-tenant ledger invariant — tenant
    sums equal the global counters EXACTLY, even under thread churn.
"""
import threading

import numpy as np
import pytest

from repro_torch.core.data_format import PreparedDataCache, payload_nbytes
from repro_torch.core.fusion import DEFAULT_PROGRAM_NBYTES, CompileCache
from repro_torch.core.tenancy import TenantLedger, current_tenant, tenant_context

from repro_torch import set_default_device  # noqa: E402

set_default_device("cpu")


def _payload(nbytes: int, fill: int = 0) -> dict:
    return {"x": np.full(nbytes, fill, dtype=np.uint8)}


# ---------------------------------------------------------------------------
# PreparedDataCache: budget + LRU
# ---------------------------------------------------------------------------

def test_prepared_budget_evicts_lru_first():
    c = PreparedDataCache(budget_bytes=250)
    for k in ("a", "b", "c"):
        c.get(k, lambda: _payload(100))
    # 300 > 250: the LRU entry ("a") was evicted, most-recent two remain
    assert not c.contains("a")
    assert c.contains("b") and c.contains("c")
    assert c.evictions == 1
    assert c.bytes_cached == 200
    assert c.bytes_built == 300            # monotone, unaffected by eviction

    # a GET refreshes recency: touch "b", insert "d" -> victim is "c"
    c.get("b", lambda: _payload(100))
    c.get("d", lambda: _payload(100))
    assert c.contains("b") and c.contains("d") and not c.contains("c")


def test_prepared_over_budget_single_entry_still_serves():
    c = PreparedDataCache(budget_bytes=10)
    v, secs, built = c.get("big", lambda: _payload(100))
    assert built and payload_nbytes(v) == 100
    # over budget but nothing else to evict and `keep` protects the insert
    assert c.contains("big")
    # the next insert evicts it
    c.get("big2", lambda: _payload(100))
    assert not c.contains("big") and c.contains("big2")


def test_prepared_pinned_entry_survives_eviction():
    c = PreparedDataCache(budget_bytes=250)
    c.get("a", lambda: _payload(100))
    c.pin("a")
    c.get("b", lambda: _payload(100))
    c.get("c", lambda: _payload(100))      # over budget; LRU is "a" but pinned
    assert c.contains("a") and not c.contains("b")
    c.unpin("a")
    c.get("d", lambda: _payload(100))      # over budget again; "a" now evictable
    assert not c.contains("a")
    assert c.bytes_cached <= 250


def test_prepared_inflight_build_is_not_a_victim():
    c = PreparedDataCache(budget_bytes=150)
    release = threading.Event()
    started = threading.Event()

    def slow():
        started.set()
        release.wait(5)
        return _payload(100)

    t = threading.Thread(target=lambda: c.get("slow", slow))
    t.start()
    started.wait(5)
    # while "slow" is mid-build (not ready), pressure the budget hard:
    # the in-flight entry must never be chosen as a victim
    c.get("x", lambda: _payload(100))
    c.get("y", lambda: _payload(100))
    release.set()
    t.join(5)
    assert c.contains("slow")
    v, secs, built = c.get("slow", lambda: pytest.fail("must be resident"))
    assert not built and payload_nbytes(v) == 100


def test_evicted_entry_rebuilds_exactly_once_bit_identical():
    """Satellite 4: fill past budget, lose a variant, then N threads re-request
    it — the in-flight de-dup applies to the REBUILD too (one builder call),
    and the rebuilt payload is bit-identical to the original."""
    c = PreparedDataCache(budget_bytes=250)
    rng = np.random.default_rng(3)
    blob = rng.integers(0, 255, size=100, dtype=np.uint8)
    builds = []

    def build_k():
        builds.append(1)
        return {"x": blob.copy()}

    original, _, built = c.get("k", build_k)
    assert built and len(builds) == 1
    c.get("f1", lambda: _payload(100))
    c.get("f2", lambda: _payload(100))     # "k" is LRU -> evicted
    assert not c.contains("k")

    results = []
    def re_get():
        v, _, _ = c.get("k", build_k)
        results.append(v)
    threads = [threading.Thread(target=re_get) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(10)
    assert len(builds) == 2                # exactly ONE rebuild for 8 racers
    assert len(results) == 8
    for v in results:
        assert v is results[0]             # all served the same entry
    np.testing.assert_array_equal(results[0]["x"], original["x"])


def test_prepared_set_budget_none_disables_eviction():
    c = PreparedDataCache(budget_bytes=100)
    c.get("a", lambda: _payload(90))
    c.set_budget(None)
    for k in ("b", "c", "d"):
        c.get(k, lambda: _payload(90))
    assert c.n_entries == 4 and c.evictions == 0
    c.set_budget(100)                      # re-arming evicts down immediately
    assert c.bytes_cached <= 100


# ---------------------------------------------------------------------------
# CompileCache: budget with nominal program weights
# ---------------------------------------------------------------------------

def test_compile_cache_budget_and_nominal_weight():
    c = CompileCache(name="t", budget_bytes=3 * DEFAULT_PROGRAM_NBYTES)
    for k in ("p0", "p1", "p2", "p3"):     # 4 programs, budget fits 3
        c.get(k, lambda: (lambda: None))
    assert c.evictions == 1
    assert c.n_entries == 3
    assert not c.contains("p0") and c.contains("p3")
    assert c.bytes_cached == 3 * DEFAULT_PROGRAM_NBYTES
    # explicit nbytes overrides the nominal weight
    c.get("fat", lambda: (lambda: None), nbytes=3 * DEFAULT_PROGRAM_NBYTES)
    assert c.contains("fat") and c.n_entries == 1


def test_compile_cache_hit_refreshes_recency_and_pins_protect():
    c = CompileCache(name="t", budget_bytes=2 * DEFAULT_PROGRAM_NBYTES)
    c.get("a", lambda: (lambda: None))
    c.get("b", lambda: (lambda: None))
    c.get("a", lambda: pytest.fail("hit"))   # refresh "a"
    c.get("c", lambda: (lambda: None))       # victim: "b"
    assert c.contains("a") and not c.contains("b")
    c.pin("a")
    c.get("d", lambda: (lambda: None))       # LRU "a" pinned -> "c" goes
    assert c.contains("a") and not c.contains("c")
    c.unpin("a")


# ---------------------------------------------------------------------------
# Tenant ledger: exact accounting (satellite 2)
# ---------------------------------------------------------------------------

def test_tenant_context_nests_and_restores():
    assert current_tenant() == "-"
    with tenant_context("alice"):
        assert current_tenant() == "alice"
        with tenant_context("bob"):
            assert current_tenant() == "bob"
        assert current_tenant() == "alice"
    assert current_tenant() == "-"


def test_tenant_ledger_counts_and_snapshot_isolation():
    led = TenantLedger()
    led.add("hits", tenant="a")
    led.add("hits", 2, tenant="a")
    led.add("bytes", 100, tenant="b")
    snap = led.snapshot()
    assert snap == {"a": {"hits": 3}, "b": {"bytes": 100}}
    snap["a"]["hits"] = 999                # deep copy: mutating it is harmless
    assert led.total("hits") == 3
    assert led.total("bytes") == 100


def test_prepared_cache_attributes_to_current_tenant():
    c = PreparedDataCache()
    with tenant_context("alice"):
        c.get("k", lambda: _payload(50))   # alice pays the miss + bytes
    with tenant_context("bob"):
        c.get("k", lambda: pytest.fail("resident"))   # bob gets the hit
    c.get("k", lambda: None)               # untenanted hit -> "-" bucket
    snap = c.tenant_counters()
    assert snap["alice"] == {"misses": 1, "bytes": 50}
    assert snap["bob"] == {"hits": 1}
    assert snap["-"] == {"hits": 1}


@pytest.mark.parametrize("cache_kind", ["prepared", "compile"])
def test_tenant_sums_equal_globals_under_thread_churn(cache_kind):
    """8 threads x 4 tenants hammer one cache with overlapping keys; every
    hit/miss lands on some tenant's ledger in the same critical section as
    the global counter, so the sums match EXACTLY — no drift, no sampling."""
    if cache_kind == "prepared":
        cache = PreparedDataCache(budget_bytes=64 * 40)
        def touch(k):
            cache.get(k, lambda: _payload(64))
    else:
        cache = CompileCache(name="t", budget_bytes=40 * DEFAULT_PROGRAM_NBYTES)
        def touch(k):
            cache.get(k, lambda: (lambda: None))

    barrier = threading.Barrier(8)
    def worker(i):
        tenant = f"t{i % 4}"
        barrier.wait()
        with tenant_context(tenant):
            for j in range(200):
                touch(f"key-{(i * 7 + j) % 60}")

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    hits, misses = cache.counters()
    snap = cache.tenant_counters()
    assert set(snap) == {"t0", "t1", "t2", "t3"}
    assert sum(v.get("hits", 0) for v in snap.values()) == hits
    assert sum(v.get("misses", 0) for v in snap.values()) == misses
    assert hits + misses == 8 * 200
    assert sum(v.get("bytes", 0) for v in snap.values()) == cache.bytes_built
    if cache_kind == "prepared":
        assert cache.bytes_cached <= 64 * 40
