"""Device resolution for the port's entry points.

Entry points run on ``cuda`` unless the caller asks for the CPU
(``--device cpu`` on the CLI, ``device="cpu"`` in the API).  Asking for
``cuda`` on a machine without a usable CUDA device raises: nothing falls
back to the CPU on its own, so a number taken on the CPU can never be
read as a number from the card.
"""

from __future__ import annotations

import torch

DEVICES = ("cuda", "cpu")


def resolve(device: str | torch.device | None = None) -> torch.device:
    """``None`` → ``cuda``.  ``"cuda"``/``"cuda:N"`` must be available;
    ``"cpu"`` is always accepted."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' requested but torch.cuda.is_available() is "
                "False; pass --device cpu (CLI) or device='cpu' (API) to run "
                "on the CPU")
        if dev.index is not None and dev.index >= torch.cuda.device_count():
            raise RuntimeError(f"device {dev} requested but only "
                               f"{torch.cuda.device_count()} CUDA device(s) exist")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; expected one of {DEVICES}")
    return dev


def synchronize(device: torch.device) -> None:
    """Block until ``device`` has finished its queued work (no-op on the
    CPU, where every op has already run when it returns)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
