"""Where the port's entry points put their tensors.

Everything runs on ``cuda`` unless the caller asks for the CPU, either for
the whole process (``set_default_device("cpu")``, as the tests do) or per
call (an explicit ``device=`` argument). Without a card and without that
request, :func:`default_device` raises instead of quietly running the CPU
path: a run that was meant for the card must not pass for one.
"""
from __future__ import annotations

import torch

__all__ = ["default_device", "set_default_device"]

_default: torch.device | None = None


def set_default_device(device) -> None:
    """Make ``device`` (e.g. ``"cpu"``) the process default; None restores
    the CUDA default."""
    global _default
    _default = torch.device(device) if device is not None else None


def default_device(device=None) -> torch.device:
    """``device`` when given, else the process default, else ``cuda``.
    Raises RuntimeError when that is a CUDA device and CUDA is absent."""
    dev = torch.device(device) if device is not None else _default
    if dev is None:
        dev = torch.device("cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' or call "
            "repro_torch.set_default_device('cpu') to run on the CPU")
    return dev
