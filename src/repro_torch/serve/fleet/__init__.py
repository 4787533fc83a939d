"""Replica fleet: supervision, crash failover, token-identical stream
recovery.

- :mod:`repro_torch.serve.fleet.supervisor` — spawn/probe/restart N replica
  FrontDoor processes (heartbeat + tick-stall watchdog, exponential
  backoff, give-up circuit breaker), coordinated fleet drain.
- :mod:`repro_torch.serve.fleet.router` — stdlib asyncio HTTP router:
  prefix-affinity + least-loaded balancing, typed-rejection
  pass-through, and journal-backed in-flight failover that splices a
  token-identical continuation into a live SSE stream when a replica
  dies mid-generation.
- :mod:`repro_torch.serve.fleet.journal` /
  :mod:`repro_torch.serve.fleet.affinity` — the supporting pieces
  (emitted-token journal, rendezvous hashing).
"""
from repro_torch.serve.fleet.affinity import prefix_key, rendezvous_rank
from repro_torch.serve.fleet.journal import JournalEntry, RequestJournal
from repro_torch.serve.fleet.router import FleetRouter
from repro_torch.serve.fleet.supervisor import (
    FleetReport,
    ProcessReplicaFactory,
    ReplicaHandle,
    Supervisor,
    free_port,
    replica_command,
    replica_env,
)

__all__ = [
    "FleetReport",
    "FleetRouter",
    "JournalEntry",
    "ProcessReplicaFactory",
    "ReplicaHandle",
    "RequestJournal",
    "Supervisor",
    "free_port",
    "prefix_key",
    "rendezvous_rank",
    "replica_command",
    "replica_env",
]
