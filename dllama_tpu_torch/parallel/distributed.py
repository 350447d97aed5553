"""Multi-process membership — the port of ``dllama_tpu/parallel/distributed.py``.

The reference scales beyond one box by adding TCP worker processes
(`dllama worker --port …`, dllama.cpp:205-219, served by SocketServer,
socket.cpp:355-397); the JAX package keeps the contract as a JAX process
group.  Here the group is ``torch.distributed`` over gloo: every process
runs the *same* program over its own tensor-parallel ranks (``tp /
nproc`` contiguous ones, ``parallel/mesh.py``), gloo carries the host
traffic (the token broadcast, the agreement check, the exchange of CUDA
IPC handles, the hostname check) and, on the CPU, the collectives of the
forward; on the card kernel 4 reads the peers' partials through CUDA IPC
(``ops/q40.py``, ``parallel/comm.py``).

Operational contract (the reference's "start workers first, then root",
socket.cpp:174-178): every process — the root is simply process 0 — runs
the same CLI command with the same model/tokenizer/prompt flags plus its
process coordinates (``--coordinator host:port --nproc N --proc-id K`` or
the DLLAMA_COORDINATOR / DLLAMA_NPROC / DLLAMA_PROC_ID environment
variables).  Process 0's host:port is the rendezvous (a TCP store that
process 0 serves); non-zero processes print nothing (the reference's
workers likewise own no stdout contract — only root prints,
transformer.cpp:213-224).  ``DLLAMA_GROUP_TIMEOUT`` (seconds, default
600) bounds the rendezvous and every collective of the group: a peer that
never joins, or dies, ends the others with an error, not a hang.
"""

from __future__ import annotations

import datetime
import os
import socket
import sys
import time

import torch

#: this process's group once :func:`init_distributed` ran (None before, and
#: in a process that never joined one)
_GROUP: "Group | None" = None


def distributed_env() -> tuple[str | None, int | None, int | None] | None:
    """Read process coordinates from the environment, or ``None`` when no
    DLLAMA_* coordinate is set.  Unset fields stay ``None`` so the
    nproc>1-requires-proc-id validation applies to the env path too."""
    coord = os.environ.get("DLLAMA_COORDINATOR")
    nproc = os.environ.get("DLLAMA_NPROC")
    pid = os.environ.get("DLLAMA_PROC_ID")
    if not coord and nproc is None and pid is None:
        return None
    return (coord or None,
            int(nproc) if nproc is not None else None,
            int(pid) if pid is not None else None)


def group_timeout() -> float:
    """Seconds the rendezvous and each collective may wait for a peer."""
    return float(os.environ.get("DLLAMA_GROUP_TIMEOUT", "600"))


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None, *,
                     max_retries: int | None = None,
                     backoff: float | None = None,
                     max_backoff: float = 30.0) -> int:
    """Join (or create, as process 0) the process group.

    Arguments fall back to the DLLAMA_* environment variables, field by
    field (flags win).  Returns the process id; :func:`current_group` then
    returns the group's handle.

    Connection failures (``ConnectionError``, ``OSError``, ``RuntimeError``:
    torch's store and gloo errors are RuntimeErrors) retry with exponential
    backoff (``backoff``, then ×2 per attempt, capped at ``max_backoff``;
    ``max_retries`` extra attempts, env defaults ``DLLAMA_INIT_RETRIES``/
    ``DLLAMA_INIT_BACKOFF``, 5 and 0.5 s); the fault point
    ``distributed.initialize`` fires before each attempt.  Argument errors
    (ValueError) never retry."""
    global _GROUP
    env = distributed_env()
    if env is not None:
        # flags win per field; env fills the gaps (a scheduler may export
        # per-host DLLAMA_PROC_ID while the flags are identical everywhere)
        ec, en, ep = env
        coordinator = coordinator if coordinator is not None else ec
        num_processes = num_processes if num_processes is not None else en
        process_id = process_id if process_id is not None else ep
    if coordinator is None:
        raise ValueError(
            "multi-process init needs --coordinator host:port (+ --nproc/--proc-id) "
            "or DLLAMA_COORDINATOR/DLLAMA_NPROC/DLLAMA_PROC_ID")
    if (num_processes or 1) > 1 and process_id is None:
        # defaulting to 0 would register every such process as the root
        raise ValueError("--proc-id is required when --nproc > 1")
    nproc = num_processes if num_processes is not None else 1
    pid = process_id if process_id is not None else 0
    if not 0 <= pid < nproc:
        raise ValueError(f"--proc-id {pid} outside 0..{nproc - 1} (--nproc {nproc})")
    if max_retries is None:
        max_retries = int(os.environ.get("DLLAMA_INIT_RETRIES", "5"))
    if backoff is None:
        backoff = float(os.environ.get("DLLAMA_INIT_BACKOFF", "0.5"))
    import torch.distributed as dist

    from ..runtime.faults import FAULTS

    for attempt in range(max_retries + 1):
        try:
            FAULTS.fire("distributed.initialize")
            dist.init_process_group(
                "gloo", init_method=f"tcp://{coordinator}", world_size=nproc, rank=pid,
                timeout=datetime.timedelta(seconds=group_timeout()))
            _GROUP = Group(pid, nproc)
            return pid
        except ValueError:
            raise  # bad coordinates, not a transient connection failure
        except (ConnectionError, OSError, RuntimeError) as e:
            if attempt >= max_retries:
                raise
            delay = min(backoff * (2 ** attempt), max_backoff)
            print(f"⚠️  coordinator {coordinator} not reachable "
                  f"(attempt {attempt + 1}/{max_retries + 1}: {e}); "
                  f"retrying in {delay:.2f}s", file=sys.stderr)
            time.sleep(delay)
    raise AssertionError("unreachable")  # the loop returns or raises


def current_group() -> "Group | None":
    """The group this process joined, or None."""
    return _GROUP


def is_output_process() -> bool:
    """True when this process owns stdout (process 0, or single-process)."""
    return _GROUP is None or _GROUP.index == 0


class Group:
    """This process's place in the group (``index`` of ``count``) and the
    host collectives the tensor-parallel path needs, over gloo on the
    default process group.  Every method is collective: each process calls
    it at the same point of the same program.  CUDA tensors cross through
    host memory.

    ``max_rows`` is the largest forward (rows of a (rows, d) partial) that
    an engine over the group reserved (:meth:`reserve_rows`): kernel 4's
    communication region is sized by it at its first call."""

    def __init__(self, index: int, count: int):
        self.index, self.count = index, count
        self.max_rows = 0
        #: per-purpose state of the cross-process collectives on the card
        #: (``parallel/comm.py``: the IPC regions)
        self.regions: dict = {}

    def reserve_rows(self, rows: int) -> None:
        self.max_rows = max(self.max_rows, int(rows))

    def barrier(self) -> None:
        import torch.distributed as dist
        dist.barrier()

    def broadcast(self, t: torch.Tensor) -> torch.Tensor:
        """Process 0's ``t`` on every process (same shape and dtype
        everywhere), on ``t``'s device."""
        import torch.distributed as dist
        host = t.cpu().contiguous()
        dist.broadcast(host, src=0)
        return host.to(t.device)

    def all_gather(self, t: torch.Tensor) -> list[torch.Tensor]:
        """Every process's ``t`` (same shape and dtype everywhere), in
        process order, on ``t``'s device."""
        import torch.distributed as dist
        host = t.cpu().contiguous()
        outs = [torch.empty_like(host) for _ in range(self.count)]
        dist.all_gather(outs, host)
        return [o.to(t.device) for o in outs]

    def gather(self, t: torch.Tensor) -> list[torch.Tensor] | None:
        """Every process's ``t`` in process order on process 0 (on ``t``'s
        device); None on the others."""
        import torch.distributed as dist
        host = t.cpu().contiguous()
        outs = [torch.empty_like(host) for _ in range(self.count)] if self.index == 0 \
            else None
        dist.gather(host, outs, dst=0)
        return None if outs is None else [o.to(t.device) for o in outs]

    def exchange(self, obj) -> list:
        """Every process's picklable ``obj``, in process order."""
        import torch.distributed as dist
        out = [None] * self.count
        dist.all_gather_object(out, obj)
        return out

    def agree(self, value, what: str) -> None:
        """Raise on every process unless every process holds ``value``."""
        seen = self.exchange(value)
        if any(v != seen[0] for v in seen):
            raise RuntimeError(f"the processes of the group disagree on {what}: "
                               + ", ".join(f"process {i}: {v!r}" for i, v in enumerate(seen)))

    def hosts(self) -> list[str]:
        """Every process's hostname, in process order."""
        return self.exchange(socket.gethostname())
