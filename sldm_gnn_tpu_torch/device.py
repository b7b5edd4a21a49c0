"""Device selection for the port's entry points.

Entry points take ``device=`` and default to ``"cuda"``. Without a card
they raise: nothing falls back to the CPU unless the caller asks for it
with ``device="cpu"`` (as the CPU tests do)."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(device)!r} (use 'cuda' or 'cpu')")
    return dev
