"""The tensor-parallel slice plan — the port of
``dllama_tpu/parallel/sharding.py``.

The reference's slicing math (``commands.cpp:8-105``) as the JAX package
writes it in PartitionSpecs, applied here by hand, one param dict a rank:

* ``"row"`` (RowMatmulSlice: the output dim) — wq, wk, wv, w1, w3, wcls
  and the experts' up/gate: a rank computes its slice of the output from
  the replicated input, with no communication;
* ``"col"`` (ColMatmulSlice: the input dim) — wo, w2 and the experts'
  down: a rank contracts its slice of the input into a full-width f32
  partial sum, and kernel 4 (``ops.q40.tp_allreduce``) sums the partials;
* replicated — the embedding, the norms and the MoE router.

Packed Q40/Q80 weights are sliced at 32-row quantization-block
granularity (the reference's ``splitWeights`` on the quantized bytes,
``commands.cpp:19-36``).  A ``col`` slice is cut at the logical input dim
(Llama-2-7B's w2: 11008 rows, 5504 a rank at tp = 2) and carries no
pack-time padding: the kernels need only whole blocks, so no rank stores
a padded row.  A leaf that does not divide stays replicated, with a ⚠️
line, as in the JAX package; the forward then gathers its input instead
(``models/transformer.py``).  Each rank's KV cache or paged pool holds
``n_kv_heads / tp`` heads; the page table is shared.

Over a process group a process places only its own ranks' slices
(``Mesh.ranks``); ``models/params.py`` ``load_placed`` reads only those
slices' bytes of a packed `.m` file, so each process holds about 1/nproc
of the sliced weights.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..models.config import ModelConfig
from ..ops import q8, q40
from .mesh import Mesh

ROW, COL = "row", "col"


def valid_tp_degrees(cfg: ModelConfig) -> list[int]:
    """Every tensor-parallel degree this model accepts: divisors of both
    head counts and of hidden_dim, capped at nKvHeads (a rank owns whole
    KV heads)."""
    return [d for d in range(1, cfg.n_kv_heads + 1)
            if cfg.n_heads % d == 0 and cfg.n_kv_heads % d == 0
            and cfg.hidden_dim % d == 0]


def check_tp_constraint(cfg: ModelConfig, tp: int) -> None:
    """Reference parity: no more ranks than KV heads
    (``transformer.cpp:88-91``), whole heads and an even hidden dim a rank;
    every rejection names the degrees that would work."""
    valid = valid_tp_degrees(cfg)
    hint = f"valid tp degrees for this model: {valid}"
    if tp > cfg.n_kv_heads:
        raise ValueError(
            f"tensor-parallel degree {tp} exceeds nKvHeads={cfg.n_kv_heads} "
            "(reference: 'This version does not support more nodes than the "
            f"number of KV heads', transformer.cpp:88-91); {hint}")
    if cfg.n_heads % tp or cfg.n_kv_heads % tp:
        raise ValueError(f"head counts ({cfg.n_heads}/{cfg.n_kv_heads}) not "
                         f"divisible by tp={tp}; {hint}")
    if cfg.hidden_dim % tp:
        raise ValueError(f"hidden_dim {cfg.hidden_dim} not divisible by "
                         f"tp={tp}; {hint}")


def param_kinds(cfg: ModelConfig) -> dict[str, str | None]:
    """How each (unfused) parameter is sliced: ``"row"``, ``"col"`` or
    None (replicated) — the JAX package's ``param_specs``."""
    kinds = {"embedding": None, "wq": ROW, "wk": ROW, "wv": ROW, "wo": COL,
             "rms_att": None, "rms_ffn": None, "rms_final": None, "wcls": ROW}
    if cfg.is_moe:
        kinds.update({"router": None, "up": ROW, "gate": ROW, "down": COL})
        if cfg.post_block_norms:
            kinds.update({"rms_moe": None, "rms_ffn2": None})
    else:
        kinds.update({"w1": ROW, "w2": COL, "w3": ROW})
    return kinds


def _cols(w, off: int, size: int):
    """Output columns ``off .. off + size`` of a weight (exact for packed
    planes: a column is a column)."""
    if isinstance(w, (q40.QTensor, q8.Q8Tensor)):
        return type(w)(w.qpacked[..., off:off + size].contiguous(),
                       w.scales[..., off:off + size].contiguous(),
                       (w.logical_nd[0], size))
    return w[..., off:off + size].contiguous()


def _split_d(w, sizes: list[int]) -> list:
    """Cut a weight's output dim into consecutive pieces."""
    offs = [sum(sizes[:i]) for i in range(len(sizes))]
    return [_cols(w, off, size) for off, size in zip(offs, sizes)]


def unfuse(params: dict, cfg: ModelConfig) -> dict:
    """Split fused ``wqkv``/``w13`` back into per-projection weights: the
    fused concat axis mixes the ranks' ranges (the JAX Engine's
    ``_unfuse``)."""
    p = dict(params)
    if "wqkv" in p:
        dh = cfg.head_size
        p["wq"], p["wk"], p["wv"] = _split_d(
            p.pop("wqkv"), [cfg.n_heads * dh, cfg.n_kv_heads * dh, cfg.n_kv_heads * dh])
    if "w13" in p:
        p["w1"], p["w3"] = _split_d(p.pop("w13"), [cfg.hidden_dim, cfg.hidden_dim])
    return p


def divides(v, kind: str | None, tp: int) -> bool:
    """Does ``v`` slice evenly over ``tp`` ranks as ``kind`` says?"""
    if kind is None:
        return True
    if isinstance(v, (q40.QTensor, q8.Q8Tensor)):
        return divides_nd(*v.logical_nd, kind, tp, packed=True)
    return divides_nd(v.shape[-2], v.shape[-1], kind, tp, packed=False)


def divides_nd(n: int, d: int, kind: str | None, tp: int, packed: bool) -> bool:
    """:func:`divides` from a weight's logical ``(n, d)``: a packed ``col``
    slice must hold whole 32-row blocks."""
    if kind is None:
        return True
    if packed:
        return q40.tp_shardable(n, d, kind, tp)
    return (d if kind == ROW else n) % tp == 0


def warn_replicated(key: str, shape, tp: int) -> None:
    """The ⚠️ line of a leaf left replicated (``shape``: its logical one)."""
    print(f"⚠️  sharding: {key} {tuple(shape)} does not divide tp={tp} evenly; "
          "replicating")


def shard(v, kind: str | None, rank: int, tp: int):
    """Rank ``rank``'s slice of ``v`` (``v`` itself when replicated), as
    its own contiguous storage."""
    if kind is None:
        return v
    if isinstance(v, (q40.QTensor, q8.Q8Tensor)):
        n, d = v.logical_nd
        if kind == ROW:
            return _cols(v, rank * (d // tp), d // tp)
        nr = n // tp
        per_row = 2 if isinstance(v, q40.QTensor) else 1  # weights a value byte
        vr, br = nr // per_row, nr // 32
        return type(v)(v.qpacked[..., rank * vr:(rank + 1) * vr, :].contiguous(),
                       v.scales[..., rank * br:(rank + 1) * br, :].contiguous(), (nr, d))
    dim = -1 if kind == ROW else -2
    size = v.shape[dim] // tp
    return v.narrow(dim, rank * size, size).contiguous()


@dataclass
class Placed:
    """Params placed over a mesh: ``ranks[j]`` is local rank j's (global
    rank ``mesh.rank0 + j``) param dict on ``mesh.devices[j]``;
    ``kinds[k]`` is how ``k`` was placed (``"row"``, ``"col"``, or None
    when replicated — by plan or because it did not divide)."""

    mesh: Mesh
    ranks: list[dict]
    kinds: dict[str, str | None]

    @property
    def tp(self) -> int:
        return self.mesh.tp

    def values(self):
        """Rank 0's leaves: every rank holds the same kinds of weight."""
        return self.ranks[0].values()


def place_params(params: dict, cfg: ModelConfig, mesh: Mesh) -> Placed:
    """Slice host (or device) params over ``mesh`` and upload each local
    rank's slices to its device — the reference's weight-distribution
    phase (``transformer.cpp:389-404``).  Fused weights are unfused first,
    a blocked Q40 weight returns to row-major; a leaf that does not divide
    stays replicated with a ⚠️ line."""
    check_tp_constraint(cfg, mesh.tp)
    params = {k: q40.unblock(v) if isinstance(v, q40.BlockedQTensor) else v
              for k, v in unfuse(params, cfg).items()}
    plan = param_kinds(cfg)
    kinds = {}
    for k, v in params.items():
        kind = plan[k]
        if not divides(v, kind, mesh.tp):
            warn_replicated(k, v.shape, mesh.tp)
            kind = None
        kinds[k] = kind
    ranks: list[dict] = [{} for _ in mesh.devices]
    for k, v in params.items():
        uploaded = {}  # a replicated leaf goes to each distinct device once
        for j, (r, dev) in enumerate(zip(mesh.ranks, mesh.devices)):
            if kinds[k] is None:
                if dev not in uploaded:
                    uploaded[dev] = v.to(dev)
                ranks[j][k] = uploaded[dev]
            else:
                ranks[j][k] = shard(v, kinds[k], r, mesh.tp).to(dev)
    return Placed(mesh, ranks, kinds)
