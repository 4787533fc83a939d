"""Front-door admission: the ``--tenants`` spec parser, and the typed
rejection (:class:`AdmissionRejected`, from ``serve/faults.py``)."""
from __future__ import annotations

from typing import Optional

from repro_torch.serve.faults import AdmissionRejected
from repro_torch.serve.scheduler import TenantPolicy

__all__ = ["AdmissionRejected", "parse_tenants"]


def parse_tenants(spec: str) -> dict:
    """Parse the ``--tenants`` flag: comma-separated
    ``name:rate:burst:priority`` entries, later fields optional.

    ``rate`` is requests/second for the tenant's token bucket (empty or
    ``inf`` = unlimited), ``burst`` the bucket depth (default 4), and
    ``priority`` the default class (0 = highest; default 0).  Example::

        paid:inf:4:0,free:2.0:4:1,batch:0.5:2:2
    """
    tenants: dict[str, TenantPolicy] = {}
    for entry in filter(None, (e.strip() for e in spec.split(","))):
        parts = entry.split(":")
        if not parts[0]:
            raise ValueError(f"tenant entry missing a name: {entry!r}")
        if len(parts) > 4:
            raise ValueError(
                f"tenant entry {entry!r}: expected name:rate:burst:priority"
            )
        name = parts[0]
        rate: Optional[float] = None
        if len(parts) > 1 and parts[1] and parts[1] != "inf":
            rate = float(parts[1])
        burst = int(parts[2]) if len(parts) > 2 and parts[2] else 4
        priority = int(parts[3]) if len(parts) > 3 and parts[3] else 0
        if name in tenants:
            raise ValueError(f"duplicate tenant {name!r}")
        tenants[name] = TenantPolicy(rate=rate, burst=burst,
                                     priority=priority)
    if not tenants:
        raise ValueError(f"no tenants in spec {spec!r}")
    return tenants
