"""The streaming front door: the asyncio HTTP/SSE server that drives the
engine's tick loop, with overload as a tested regime.

- :mod:`server`    — :class:`FrontDoor`: HTTP/1.1 + SSE on asyncio; owns
  the engine thread and the tick task; graceful drain on SIGTERM/SIGINT.
- :mod:`admission` — request validation, the ``--tenants`` spec, and the
  typed :class:`AdmissionRejected` as an HTTP response (429/413 bodies,
  Retry-After).
- :mod:`streaming` — SSE frames and the cursor-diff :class:`TokenStream`
  that fans tick results out to clients.
- :mod:`ladder`    — the load-shedding :class:`DegradationLadder` (halve
  speculative K, then speculation off, then shed the lowest class).
- :mod:`drain`     — :class:`DrainReport` and the KV pool's leak gate.
- :mod:`wire`      — stdlib HTTP/1.1 helpers (request parsing, response
  framing, the client side ``open_http``) shared with the fleet router
  and the supervisor's probes (:mod:`repro_torch.serve.fleet`).
"""
from repro_torch.serve.frontdoor.admission import (
    parse_tenants,
    rejection_response,
)
from repro_torch.serve.frontdoor.drain import DrainReport, leak_gate
from repro_torch.serve.frontdoor.ladder import DegradationLadder, LadderConfig
from repro_torch.serve.frontdoor.server import FrontDoor, run_server
from repro_torch.serve.frontdoor.streaming import TokenStream, sse_event

__all__ = [
    "DegradationLadder",
    "DrainReport",
    "FrontDoor",
    "LadderConfig",
    "TokenStream",
    "leak_gate",
    "parse_tenants",
    "rejection_response",
    "run_server",
    "sse_event",
]
