"""The tensor-parallel mesh — the port of ``dllama_tpu/parallel/mesh.py``
(``make_mesh``, ``parse_workers``), tensor parallelism only.

The reference's cluster is ``--workers host:port ...``, a TCP star of
nodes that each hold a slice of every weight; the JAX package keeps the
contract as ``--workers tpu:N`` over a ``jax.sharding.Mesh``.  Here a mesh
is this process's ranks, one device a rank: the model's forward walks its
ranks itself (``models/transformer.py``).  In one process every rank is
local and the collectives are kernel 4 and plain copies between the
ranks' tensors.  Over a process group (``parallel/distributed.py``,
``--coordinator/--nproc/--proc-id``) each of the ``nproc`` processes holds
``tp / nproc`` contiguous ranks — process k ranks ``k·tp/nproc ..`` — and
the collectives cross processes: gloo on the CPU, CUDA IPC on the card
(``parallel/comm.py``, kernel 4's cross-process body).  Placement of the
local ranks follows the ``--device`` the caller names:

* ``cpu`` — every rank on the CPU (the counterpart of the JAX package's
  virtual CPU devices, what the tests run);
* ``cuda:K`` — every local rank on card K (the whole TP path on one card:
  the slicing, the per-rank kernels and KV, kernel 4's schedule and
  numbers; the processes of a group then share card K);
* ``cuda`` — local rank j of process k on card ``(k·tp/nproc + j) %
  device_count()``: on one host of N cards global rank r on card r, on
  several hosts each host's own cards.  A ``cuda`` group whose processes
  are on different hosts is refused: CUDA IPC does not reach another host.

There is no active-mesh global: the mesh is passed explicitly.  The
sequence-, data- and expert-parallel axes (``--sp``, ``--dp``, ``--ep``)
are not ported.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

from ..ops.q40 import TP_MAX


@dataclass(frozen=True)
class Mesh:
    """``devices[j]`` holds this process's local rank j, global rank
    ``rank0 + j``; ``nproc`` processes hold ``len(devices)`` ranks each and
    this one is process ``proc`` of ``group`` (None in one process)."""

    devices: tuple[torch.device, ...]
    nproc: int = 1
    proc: int = 0
    group: object = field(default=None, compare=False, repr=False)

    @property
    def tp(self) -> int:
        """The global tensor-parallel degree."""
        return len(self.devices) * self.nproc

    @property
    def rank0(self) -> int:
        """This process's first global rank."""
        return self.proc * len(self.devices)

    @property
    def ranks(self) -> range:
        """This process's global ranks."""
        return range(self.rank0, self.rank0 + len(self.devices))

    @property
    def device(self) -> torch.device:
        """Local rank 0's device: where this process's sampling and logits
        live (process 0's holds global rank 0)."""
        return self.devices[0]

    @property
    def multi(self) -> bool:
        """Does the mesh span processes?"""
        return self.nproc > 1


def valid_counts(nproc: int) -> list[int]:
    """The tp degrees a group of ``nproc`` processes can hold: multiples
    of ``nproc`` up to the mesh's limit."""
    return list(range(nproc, TP_MAX + 1, nproc))


def check_split(tp: int, nproc: int) -> None:
    """Refuse a tp that does not split into whole ranks a process."""
    if tp % nproc:
        raise ValueError(f"--workers tpu:{tp} does not split over --nproc {nproc} "
                         f"processes (each holds tp/nproc ranks); valid tp for "
                         f"{nproc} processes: {valid_counts(nproc)}")


def make_mesh(tp: int = 1, device: str | torch.device = "cuda", group=None) -> Mesh:
    """A ``tp``-rank mesh placed as the module docstring says, over
    ``group`` (a ``distributed.Group``) when it has more than one process;
    raises when a plain ``cuda`` mesh needs more cards than there are, when
    tp does not split over the processes, and for a ``cuda`` group across
    hosts."""
    if tp < 1:
        raise ValueError(f"tensor-parallel degree must be >= 1, got {tp}")
    dev = torch.device(device)
    nproc = group.count if group is not None else 1
    if nproc > 1:
        check_split(tp, nproc)
        if dev.type == "cuda":
            hosts = group.hosts()
            if len(set(hosts)) > 1:
                raise ValueError(
                    f"a cuda worker group spans hosts ({', '.join(hosts)}): kernel 4 reads "
                    "its peers' partials through CUDA IPC, which does not reach another "
                    "host, and a network transport is not yet ported; run the group on "
                    "one host, or on the CPU (--device cpu: gloo crosses hosts)")
        local = tp // nproc
        k = group.index
        if dev.type == "cuda" and dev.index is None:
            n = torch.cuda.device_count()
            devs = tuple(torch.device("cuda", (k * local + j) % n) for j in range(local))
        else:
            devs = (dev,) * local
        return Mesh(devs, nproc, k, group)
    if dev.type == "cuda" and dev.index is None:
        have = torch.cuda.device_count()
        if tp > have:
            raise ValueError(f"mesh tp={tp} needs {tp} devices, have {have} (pass "
                             "--device cuda:0 to put every rank on one card)")
        return Mesh(tuple(torch.device("cuda", r) for r in range(tp)))
    return Mesh((dev,) * tp)


def workers_tp(workers: str | None) -> int:
    """The tp degree of a ``--workers`` value: ``tpu:N`` is N, ``None`` or
    ``""`` is 1.  Host:port worker lists (the reference's CPU cluster) are
    refused, as in the JAX package."""
    if not workers:
        return 1
    if workers.startswith("tpu:"):
        try:
            return int(workers.split(":", 1)[1])
        except ValueError:
            raise ValueError(f"--workers {workers!r}: N in 'tpu:N' must be an "
                             "integer") from None
    raise ValueError(f"unsupported --workers value {workers!r}: the mesh replaces "
                     "the reference's TCP star; use 'tpu:N'")


def parse_workers(workers: str | None, device: str | torch.device = "cuda",
                  group=None) -> Mesh:
    """The CLI's ``--workers`` value as a mesh over ``group``: ``tpu:N`` is
    N-way tensor parallelism (the JAX CLI's spelling, so scripts carry
    over); ``None`` or ``""`` is one rank."""
    return make_mesh(workers_tp(workers), device, group)
