"""Front-door admission: request validation, the ``--tenants`` spec
parser, and the typed :class:`AdmissionRejected` (``serve/faults.py``) as
an HTTP response.

The status code is the rejection's own (:attr:`AdmissionRejected.
http_status`: 413 for the non-retryable ``over_capacity``, 429 for the
retryable ``queue_full``, ``rate_limited`` and ``shed``) and so is the
body (:meth:`AdmissionRejected.to_dict`), so the CLI's errors and the
HTTP bodies carry the same detail.  Every error text equals the JAX
package's.
"""
from __future__ import annotations

import json
import math
from typing import Optional

import numpy as np

from repro_torch.serve.faults import AdmissionRejected
from repro_torch.serve.scheduler import SamplingParams, TenantPolicy

__all__ = ["AdmissionRejected", "GenerateParams", "parse_generate_body",
           "parse_tenants", "rejection_response"]

MAX_PROMPT_TOKENS = 1 << 20  # a bound on request size, not on capacity


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


class GenerateParams:
    """A validated ``POST /v1/generate`` body."""

    __slots__ = ("prompt", "max_new", "tenant", "priority", "stream",
                 "sampling", "stop_tokens", "deadline_s", "resume_tokens")

    def __init__(self, prompt, max_new, tenant, priority, stream,
                 sampling, stop_tokens, deadline_s, resume_tokens=()):
        self.prompt = prompt
        self.max_new = max_new
        self.tenant = tenant
        self.priority = priority
        self.stream = stream
        self.sampling = sampling
        self.stop_tokens = stop_tokens
        self.deadline_s = deadline_s
        self.resume_tokens = resume_tokens


def _int_list(v, field: str) -> list:
    if (not isinstance(v, list) or
            not all(isinstance(t, int) and not isinstance(t, bool)
                    for t in v)):
        raise ValueError(f"{field!r} must be a list of integer token ids")
    return v


def parse_generate_body(raw: bytes) -> GenerateParams:
    """Parse and validate a generate body, raising ``ValueError`` with a
    message the client can act on.

    Schema: ``{"prompt": [int, ...], "max_new": int, "tenant"?: str,
    "priority"?: int, "stream"?: bool, "temperature"?: float,
    "top_p"?: float, "seed"?: int, "stop_tokens"?: [int, ...],
    "deadline_s"?: float, "resume_tokens"?: [int, ...]}``.

    ``resume_tokens`` is the fleet router's failover field: tokens an
    earlier attempt already emitted.  The engine prefills over prompt +
    resume and the SSE stream goes on at token index
    ``len(resume_tokens)``, never sending the resumed tokens again;
    ``max_new`` stays the whole budget, so a resubmitted body differs from
    the original in this one field.
    """
    try:
        body = json.loads(raw.decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise ValueError(f"body is not valid JSON: {e}") from None
    if not isinstance(body, dict):
        raise ValueError("body must be a JSON object")
    known = {"prompt", "max_new", "tenant", "priority", "stream",
             "temperature", "top_p", "seed", "stop_tokens", "deadline_s",
             "resume_tokens"}
    unknown = set(body) - known
    if unknown:
        raise ValueError(f"unknown fields: {sorted(unknown)}")
    if "prompt" not in body or "max_new" not in body:
        raise ValueError("'prompt' and 'max_new' are required")
    prompt = _int_list(body["prompt"], "prompt")
    if not 0 < len(prompt) <= MAX_PROMPT_TOKENS:
        raise ValueError(
            f"prompt must have 1..{MAX_PROMPT_TOKENS} tokens, "
            f"got {len(prompt)}")
    max_new = body["max_new"]
    if not isinstance(max_new, int) or isinstance(max_new, bool) \
            or max_new < 1:
        raise ValueError("'max_new' must be a positive integer")
    tenant = body.get("tenant", "default")
    if not isinstance(tenant, str) or not tenant:
        raise ValueError("'tenant' must be a non-empty string")
    priority = body.get("priority")
    if priority is not None and (not isinstance(priority, int)
                                 or isinstance(priority, bool)
                                 or priority < 0):
        raise ValueError("'priority' must be an integer >= 0")
    stream = body.get("stream", True)
    if not isinstance(stream, bool):
        raise ValueError("'stream' must be a boolean")
    try:
        sampling = SamplingParams(
            temperature=float(body.get("temperature", 0.0)),
            top_p=float(body.get("top_p", 1.0)),
            seed=int(body.get("seed", 0)),
        )
    except (TypeError, ValueError) as e:
        raise ValueError(f"bad sampling params: {e}") from None
    stop_tokens = tuple(_int_list(body.get("stop_tokens", []),
                                  "stop_tokens"))
    deadline_s = body.get("deadline_s")
    if deadline_s is not None:
        deadline_s = float(deadline_s)
        if deadline_s <= 0:
            raise ValueError("'deadline_s' must be > 0")
    resume_tokens = tuple(_int_list(body.get("resume_tokens", []),
                                    "resume_tokens"))
    if len(resume_tokens) >= max_new:
        raise ValueError(
            f"'resume_tokens' ({len(resume_tokens)}) must leave room "
            f"under 'max_new' ({max_new})")
    return GenerateParams(
        prompt=np.asarray(prompt, np.int32), max_new=max_new,
        tenant=tenant, priority=priority, stream=stream,
        sampling=sampling, stop_tokens=stop_tokens, deadline_s=deadline_s,
        resume_tokens=resume_tokens)


def rejection_response(exc: AdmissionRejected) -> tuple:
    """(status, extra headers, body bytes) of a typed rejection.  A
    retryable one carries ``Retry-After``: the bucket's own hint when it
    has one, else 1 second."""
    headers = []
    if exc.retryable:
        after = exc.retry_after_s if exc.retry_after_s is not None else 1.0
        headers.append(("Retry-After", str(max(1, math.ceil(after)))))
    body = json.dumps(exc.to_dict()).encode()
    return exc.http_status, headers, body
