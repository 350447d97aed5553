"""Device resolution for the port's entry points.

Entry points run on ``cuda`` unless the caller asks for the CPU
(``--device cpu`` on the CLI, ``device="cpu"`` in the API).  Asking for
``cuda`` on a machine without a usable CUDA device raises: nothing falls
back to the CPU on its own, so a number taken on the CPU can never be
read as a number from the card.
"""

from __future__ import annotations

import numpy as np
import torch

DEVICES = ("cuda", "cpu")
_INDEX_TABLES: dict[torch.device, torch.Tensor] = {}
# index tables a larger one replaced: kept alive, as a captured CUDA graph
# may still read them
_RETIRED: list[torch.Tensor] = []


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


def index_view(dev: torch.device, i: int, n: int) -> torch.Tensor:
    """A (1,) int32 tensor on ``dev`` holding ``i`` (``0 <= i < n``): a
    view into a per-device table of ``0..max(n, 128)-1``, made once.  The
    kernels read their layer or plane index from device memory, so a
    launch at a static index needs no host-to-device copy and a captured
    graph can replay it.  A table that a larger ``n`` replaces stays
    alive: a graph captured before keeps reading its address."""
    ids = _INDEX_TABLES.get(dev)
    if ids is None or ids.numel() < n:
        if ids is not None:
            _RETIRED.append(ids)
        ids = torch.arange(max(n, 128), dtype=torch.int32, device=dev)
        _INDEX_TABLES[dev] = ids
    return ids[i:i + 1]


def upload(a, dtype: torch.dtype, dev: torch.device) -> torch.Tensor:
    """Host array ``a`` as a ``dtype`` tensor on ``dev``.  To a CUDA device
    it goes through pinned memory, non-blocking: a copy from pageable
    memory waits for everything queued on the stream, which would land a
    dispatch still in flight.  The pinned block returns to its cache only
    once the copy has run."""
    if dev.type != "cuda":
        return torch.tensor(np.asarray(a), dtype=dtype)
    t = torch.from_numpy(np.ascontiguousarray(a)).to(dtype)
    return t.pin_memory().to(dev, non_blocking=True)
