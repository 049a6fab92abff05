"""Tenant attribution for shared process-wide caches (DESIGN.md §3.5).

The multi-tenant search service (``repro_torch.serve.search_service``) runs many
concurrent sessions against ONE ``CompileCache``, ONE ``PreparedDataCache``
and ONE predict compile cache. Cache accounting therefore needs to answer
"whose hit was that?" without threading a tenant argument through every
call site (``run_prepared`` → ``_prepare_for`` → ``cache.get`` is three
layers deep and shared with single-tenant code).

The answer is an ambient, thread-local tenant: service workers execute each
unit inside ``tenant_context(tenant)``, and the caches read
:func:`current_tenant` at the exact point they bump a counter. Single-tenant
code never enters a context and lands under the :data:`UNTENANTED` bucket —
its counters are unchanged in aggregate.

:class:`TenantLedger` is deliberately NOT self-locking: every mutation must
happen inside the owning cache's lock, in the same critical section that
updates the cache's global counters. That is what makes the satellite-2
invariant exact rather than eventually-consistent: for every counter,
``sum(per-tenant) == global`` at any observable moment.
"""
from __future__ import annotations

import contextlib
import threading

__all__ = ["UNTENANTED", "current_tenant", "tenant_context", "TenantLedger"]

#: Ledger bucket for work done outside any ``tenant_context``.
UNTENANTED = "-"

_TL = threading.local()


def current_tenant() -> str:
    """The ambient tenant of the calling thread (``UNTENANTED`` outside)."""
    return getattr(_TL, "tenant", UNTENANTED)


@contextlib.contextmanager
def tenant_context(tenant: str | None):
    """Attribute cache traffic on this thread to ``tenant`` while inside."""
    prev = getattr(_TL, "tenant", UNTENANTED)
    _TL.tenant = str(tenant) if tenant is not None else UNTENANTED
    try:
        yield
    finally:
        _TL.tenant = prev


class TenantLedger:
    """Per-tenant counter map. All mutation under the OWNER's lock (see
    module docstring); ``snapshot()`` must likewise be called under it —
    caches expose a locked ``tenant_counters()`` for consumers."""

    __slots__ = ("_by",)

    def __init__(self) -> None:
        self._by: dict[str, dict[str, float]] = {}

    def add(self, field: str, amount: float = 1, tenant: str | None = None) -> None:
        t = tenant if tenant is not None else current_tenant()
        d = self._by.setdefault(t, {})
        d[field] = d.get(field, 0) + amount

    def snapshot(self) -> dict[str, dict[str, float]]:
        return {t: dict(d) for t, d in self._by.items()}

    def total(self, field: str) -> float:
        return sum(d.get(field, 0) for d in self._by.values())

    def clear(self) -> None:
        self._by.clear()
