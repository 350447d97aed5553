"""The tensor-parallel mesh — the port of ``dllama_tpu/parallel/mesh.py``
(``make_mesh``, ``parse_workers``), tensor parallelism only.

The reference's cluster is ``--workers host:port ...``, a TCP star of
nodes that each hold a slice of every weight; the JAX package keeps the
contract as ``--workers tpu:N`` over a ``jax.sharding.Mesh``.  Here a mesh
is a list of devices, one per TP rank: the model's forward walks the ranks
itself (``models/transformer.py``), so no collective library is involved.
Placement follows the ``--device`` the caller names:

* ``cpu`` — every rank on the CPU (the counterpart of the JAX package's
  virtual CPU devices, what the tests run);
* ``cuda:K`` — every rank on card K (the whole TP path on one card: the
  slicing, the per-rank kernels and KV, kernel 4's schedule and numbers);
* ``cuda`` — rank r on card r, which needs N cards.

There is no active-mesh global: the mesh is passed explicitly.  The
sequence-, data- and expert-parallel axes (``--sp``, ``--dp``, ``--ep``)
are not ported.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class Mesh:
    """``devices[r]`` holds TP rank ``r``."""

    devices: tuple[torch.device, ...]

    @property
    def tp(self) -> int:
        return len(self.devices)

    @property
    def device(self) -> torch.device:
        """Rank 0's device: where the logits are gathered and sampled."""
        return self.devices[0]


def make_mesh(tp: int = 1, device: str | torch.device = "cuda") -> Mesh:
    """A ``tp``-rank mesh placed as the module docstring says; raises when
    a plain ``cuda`` mesh needs more cards than there are."""
    if tp < 1:
        raise ValueError(f"tensor-parallel degree must be >= 1, got {tp}")
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        have = torch.cuda.device_count()
        if tp > have:
            raise ValueError(f"mesh tp={tp} needs {tp} devices, have {have} (pass "
                             "--device cuda:0 to put every rank on one card)")
        return Mesh(tuple(torch.device("cuda", r) for r in range(tp)))
    return Mesh((dev,) * tp)


def parse_workers(workers: str | None, device: str | torch.device = "cuda") -> Mesh:
    """The CLI's ``--workers`` value as a mesh: ``tpu:N`` is N-way tensor
    parallelism (the JAX CLI's spelling, so scripts carry over); ``None`` or
    ``""`` is one rank.  Host:port worker lists (the reference's CPU
    cluster) are refused, as in the JAX package."""
    if not workers:
        return make_mesh(1, device)
    if workers.startswith("tpu:"):
        try:
            n = int(workers.split(":", 1)[1])
        except ValueError:
            raise ValueError(f"--workers {workers!r}: N in 'tpu:N' must be an "
                             "integer") from None
        return make_mesh(n, device)
    raise ValueError(f"unsupported --workers value {workers!r}: the mesh replaces "
                     "the reference's TCP star; use 'tpu:N'")
