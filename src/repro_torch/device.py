"""Where the port's tensors live.

Every entry point that places tensors takes a ``device`` that defaults to
``cuda``; the CPU is used only when a caller asks for it (``device="cpu"``,
``--device cpu``), as the tests do.  Asking for ``cuda`` where there is no
card raises — nothing carries on on the CPU.  ``meta`` places no data
(shapes and dtypes only: ``Model.abstract_params``, the counterpart of
``jax.eval_shape``).
"""
from __future__ import annotations

import torch

__all__ = ["DEFAULT_DEVICE", "resolve_device"]

DEFAULT_DEVICE = "cuda"


def resolve_device(device=DEFAULT_DEVICE) -> torch.device:
    """``cuda`` (any index), ``cpu`` or ``meta`` as a :class:`torch.device`;
    raises ``RuntimeError`` if ``cuda`` is asked for and absent."""
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"device must be 'cuda', 'cpu' or 'meta', got "
                         f"{device!r}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r}: torch.cuda.is_available() is False (pass "
            "device='cpu' / --device cpu to run the plain versions on the "
            "CPU)")
    return dev
