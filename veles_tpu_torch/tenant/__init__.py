"""Per-tenant request identity and admission economics.

:mod:`veles_tpu_torch.tenant.admission` resolves a tenant id at the router
edge (hash of the bearer token, or an explicit ``X-Veles-Tenant``
from loopback), tags every request with a cardinality-bounded label,
and — when ``root.common.tenant.enabled`` — enforces per-tenant
token-bucket rate limits and a weighted-fair concurrency lane so a
flooding tenant degrades only itself.
"""

from veles_tpu_torch.tenant.admission import TenantAdmission, resolve_tenant

__all__ = ("TenantAdmission", "resolve_tenant")
