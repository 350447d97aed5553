"""The device mesh — the port of ``dllama_tpu/parallel/mesh.py``
(``make_mesh``, ``parse_workers``).

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

There is no active-mesh global: the mesh is passed explicitly.

The mesh has the JAX package's four axes, ``(dp, sp, ep, tp)`` with tp
innermost (``dllama_tpu/parallel/mesh.py`` ``make_mesh``): global rank
``((d·sp + s)·ep + e)·tp + t`` holds data-parallel group d's batch rows,
sequence shard s of the KV cache, expert shard e of a MoE model's expert
stacks and tensor-parallel slice t.  ``--sp``, ``--ep`` and ``--dp`` run
in one process only: a process group with any of them above 1 is refused
(``cli.not_ported``).  Placement by ``--device`` is as above over all
``dp·sp·ep·tp`` ranks.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

from ..ops.q40 import TP_MAX

#: the mesh's axes, outermost first (the JAX package's order)
AXES = ("dp", "sp", "ep", "tp")


@dataclass(frozen=True)
class Mesh:
    """``devices[j]`` holds this process's local rank j, global rank
    ``rank0 + j``; ``nproc`` processes hold ``len(devices)`` ranks each and
    this one is process ``proc`` of ``group`` (None in one process).  The
    ranks form a ``(dp, sp, ep, tp)`` grid, tp innermost; tp is what the
    other three degrees leave of the rank count."""

    devices: tuple[torch.device, ...]
    nproc: int = 1
    proc: int = 0
    group: object = field(default=None, compare=False, repr=False)
    dp: int = 1
    sp: int = 1
    ep: int = 1

    def __post_init__(self):
        if self.size % (self.dp * self.sp * self.ep):
            raise ValueError(f"{self.size} ranks do not form a dp={self.dp} x sp={self.sp} "
                             f"x ep={self.ep} mesh")

    @property
    def size(self) -> int:
        """Every rank of the mesh, over all processes."""
        return len(self.devices) * self.nproc

    @property
    def tp(self) -> int:
        """The global tensor-parallel degree."""
        return self.size // (self.dp * self.sp * self.ep)

    @property
    def shape(self) -> dict[str, int]:
        """Each axis's degree, outermost first (the JAX mesh's ``shape``)."""
        return {"dp": self.dp, "sp": self.sp, "ep": self.ep, "tp": self.tp}

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

    def coords(self, r: int) -> tuple[int, int, int, int]:
        """Global rank ``r``'s ``(d, s, e, t)``."""
        r, t = divmod(r, self.tp)
        r, e = divmod(r, self.ep)
        d, s = divmod(r, self.sp)
        return d, s, e, t

    def rank(self, d: int = 0, s: int = 0, e: int = 0, t: int = 0) -> int:
        """The global rank at ``(d, s, e, t)``."""
        return ((d * self.sp + s) * self.ep + e) * self.tp + t

    def group_ranks(self, axes: tuple[str, ...], r: int) -> list[int]:
        """The ranks that share every coordinate of rank ``r`` but those of
        ``axes``, in rank order: ``("sp",)`` is r's sequence-parallel
        group, ``("ep", "tp")`` the ranks of r's (d, s) cell that hold an
        expert stack's slices."""
        fixed = dict(zip(AXES, self.coords(r)))
        spans = [range(self.shape[a]) if a in axes else (fixed[a],) for a in AXES]
        return [self.rank(d, s, e, t) for d in spans[0] for s in spans[1]
                for e in spans[2] for t in spans[3]]

    def local(self, r: int) -> int:
        """Global rank ``r``'s index into :attr:`devices` (this process's)."""
        return r - self.rank0

    def axes_line(self) -> str:
        """The axes above 1 as the JAX CLI prints them (``dp=2 tp=2``;
        ``tp=1`` for one rank)."""
        axes = {k: v for k, v in self.shape.items() if v > 1} or {"tp": 1}
        return " ".join(f"{k}={v}" for k, v in axes.items())


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


def make_mesh(tp: int = 1, device: str | torch.device = "cuda", group=None, *,
              sp: int = 1, dp: int = 1, ep: int = 1) -> Mesh:
    """A ``dp × sp × ep × tp`` mesh placed as the module docstring says,
    over ``group`` (a ``distributed.Group``) when it has more than one
    process; raises when a plain ``cuda`` mesh needs more cards than there
    are (the JAX package's "needs N devices, have M"), when tp does not
    split over the processes, for a ``cuda`` group across hosts, and for a
    group with sp, dp or ep above 1."""
    for name, v in (("tensor", tp), ("sequence", sp), ("data", dp), ("expert", ep)):
        if v < 1:
            raise ValueError(f"{name}-parallel degree must be >= 1, got {v}")
    dev = torch.device(device)
    n = dp * sp * ep * tp
    nproc = group.count if group is not None else 1
    if nproc > 1:
        if (dp, sp, ep) != (1, 1, 1):
            raise ValueError(f"a mesh with dp={dp} sp={sp} ep={ep} runs in one process; "
                             "over a process group only tp is ported")
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
            count = torch.cuda.device_count()
            devs = tuple(torch.device("cuda", (k * local + j) % count) for j in range(local))
        else:
            devs = (dev,) * local
        return Mesh(devs, nproc, k, group)
    if dev.type == "cuda" and dev.index is None:
        have = torch.cuda.device_count()
        if n > have:
            raise ValueError(f"mesh {dp}x{sp}x{ep}x{tp} needs {n} devices, have {have} "
                             "(pass --device cuda:0 to put every rank on one card)")
        return Mesh(tuple(torch.device("cuda", r) for r in range(n)), dp=dp, sp=sp, ep=ep)
    return Mesh((dev,) * n, dp=dp, sp=sp, ep=ep)


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
                  group=None, *, sp: int = 1, dp: int = 1, ep: int = 1) -> Mesh:
    """The CLI's ``--workers`` value (and ``--sp``/``--dp``/``--ep``) as a
    mesh over ``group``: ``tpu:N`` is N-way tensor parallelism (the JAX
    CLI's spelling, so scripts carry over); ``None`` or ``""`` is tp = 1."""
    return make_mesh(workers_tp(workers), device, group, sp=sp, dp=dp, ep=ep)
