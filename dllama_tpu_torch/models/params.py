"""Parameter dicts: random init (tests), `.m`-file loading, and conversion
from the JAX package's params — the port of ``dllama_tpu/models/params.py``
(Llama, Mixtral, Grok-1; Q40, Q80, F16 and F32 files).

Weights are stored input-dim-first (``x @ w``) and layer-stacked (a
leading ``n_layers`` axis); the model's layer loop indexes the stacks.  A
Q40 or Q80 file keeps its matmuls packed (``ops.q40.QTensor``,
``ops.q8.Q8Tensor``), with q/k/v fused into ``wqkv`` and w1/w3 into
``w13`` (one kernel launch each per layer; unfused for tensor
parallelism); MoE experts stack as
``(L, E, ...)`` planes that the kernels read at a flat index
``layer·E + expert``.  Norms, the embedding and the MoE router load dense.
F32/F16 files load dense.  :func:`load_placed` loads only this process's
tensor-parallel ranks' slices of a file (a process group's member,
``parallel/mesh.py``), reading only those bytes of its packed planes.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import quants
from ..io import mfile
from ..ops import q8, q40
from ..parallel import sharding
from .config import ModelConfig

Params = dict  # str -> torch.Tensor | q40.QTensor | q40.BlockedQTensor | q8.Q8Tensor
CODECS = {quants.Q40: q40, quants.Q80: q8}
BLOCK_BYTES = {q40: quants.Q40_BLOCK_BYTES, q8: quants.Q80_BLOCK_BYTES}
# the `.m` tensor that gives each sliceable leaf's logical (n, d)
FILE_NAMES = {"wq": "layers.0.wq", "wk": "layers.0.wk", "wv": "layers.0.wv",
              "wo": "layers.0.wo", "w1": "layers.0.w1", "w2": "layers.0.w2",
              "w3": "layers.0.w3", "wcls": "wcls", "up": "layers.0.experts.0.up",
              "gate": "layers.0.experts.0.gate", "down": "layers.0.experts.0.down"}


def param_shapes(cfg: ModelConfig) -> dict[str, tuple[int, ...]]:
    L, D, F, V = cfg.n_layers, cfg.dim, cfg.hidden_dim, cfg.vocab_size
    hq = cfg.n_heads * cfg.head_size
    hkv = cfg.n_kv_heads * cfg.head_size
    shapes = {
        "embedding": (V, D),
        "wq": (L, D, hq),
        "wk": (L, D, hkv),
        "wv": (L, D, hkv),
        "wo": (L, hq, D),
        "rms_att": (L, D),
        "rms_ffn": (L, D),
        "rms_final": (D,),
        "wcls": (D, V),
    }
    if cfg.is_moe:
        E = cfg.n_experts
        shapes.update({"router": (L, D, E), "up": (L, E, D, F),
                       "gate": (L, E, D, F), "down": (L, E, F, D)})
        if cfg.post_block_norms:  # Grok-1's extra norms
            shapes.update({"rms_moe": (L, D), "rms_ffn2": (L, D)})
    else:
        shapes.update({"w1": (L, D, F), "w2": (L, F, D), "w3": (L, D, F)})
    return shapes


def init_params(cfg: ModelConfig, seed: int = 0, scale: float = 0.02) -> Params:
    """Deterministic random params, drawn in the JAX package's order from
    the same numpy generator, so both packages start from equal values."""
    rng = np.random.RandomState(seed)
    params: Params = {}
    for name, shape in param_shapes(cfg).items():
        if name.startswith("rms"):
            params[name] = torch.ones(shape, dtype=torch.float32)
        else:
            x = (rng.standard_normal(shape) * scale).astype(np.float32)
            params[name] = torch.from_numpy(x).to(cfg.dtype)
    return params


def quantize_matmuls(params: Params, cfg: ModelConfig, codec=q40) -> Params:
    """Convert the dense matmul weights to packed ``codec`` (``ops.q40`` or
    ``ops.q8``), fused as the loader fuses them (``wqkv``, ``w13``); MoE
    expert stacks quantize per expert along their input axis, the router
    and the embedding stay dense."""
    def f32(k):
        return params[k].to(torch.float32).numpy()

    fused = {"wqkv": ("wq", "wk", "wv")}
    keys = ["wo", "wcls"]
    if cfg.is_moe:
        keys += ["up", "gate", "down"]
    else:
        fused["w13"] = ("w1", "w3")
        keys.append("w2")
    parts = {k for names in fused.values() for k in names}
    out = {k: v for k, v in params.items() if k not in parts}
    for k, names in fused.items():
        out[k] = codec.quantize(np.concatenate([f32(n) for n in names], axis=-1))
    for k in keys:
        out[k] = codec.quantize(f32(k))
    return out


def _stack(mf: mfile.MFile, names: list[str], transpose: bool, dtype) -> torch.Tensor:
    mats = [mf.tensor(n) for n in names]
    if transpose:
        mats = [np.ascontiguousarray(m.T) for m in mats]
    return torch.from_numpy(np.stack(mats)).to(dtype)


def _cut_raw(raw: np.ndarray, d: int, n: int, codec, cut) -> tuple[np.ndarray, int, int]:
    """``cut`` = (kind, rank, tp): rank's slice of one (d, n) packed file
    tensor as ``(bytes, d', n')`` — ``row`` keeps output rows (a view of
    the map), ``col`` each row's run of input blocks (only those bytes are
    read)."""
    kind, rank, tp = cut
    rows = raw.reshape(d, n // 32, BLOCK_BYTES[codec])
    dc, nc = _cut_dims(d, n, cut)
    if kind == sharding.ROW:
        return rows[rank * dc:(rank + 1) * dc].reshape(-1), dc, nc
    nb = nc // 32
    return np.ascontiguousarray(rows[:, rank * nb:(rank + 1) * nb]).reshape(-1), dc, nc


def _cut_dims(d: int, n: int, cut) -> tuple[int, int]:
    """A rank's ``(d, n)`` under ``cut`` (kind, rank, tp)."""
    kind, _, tp = cut
    return (d // tp, n) if kind == sharding.ROW else (d, n // tp)


def _trim(w, cut):
    """A ``col`` slice without the pack-time padding rows: the storage of
    ``sharding.shard`` of the whole weight."""
    if cut is None or cut[0] != sharding.COL:
        return w
    nr, d = w.logical_nd
    per_row = 2 if isinstance(w, q40.QTensor) else 1  # weights a value byte
    return type(w)(w.qpacked[..., :nr // per_row, :].contiguous(),
                   w.scales[..., :nr // 32, :].contiguous(), (nr, d))


def _stack_q(mf: mfile.MFile, names: list[list[str]], codec, cut=None, stacked=True):
    """Layer-stack Q40/Q80 (``codec``) tensors straight from their packed
    file bytes (a byte transpose per tensor, no f32 transit); each inner
    list fuses its tensors' output dims.  ``cut`` (kind, rank, tp) packs
    one rank's slice of each tensor from its bytes alone."""
    def entry(name):
        t = mf.info(name)
        e = (mf.raw(name), int(np.prod(t.shape[:-1])), t.shape[-1])
        return e if cut is None else _cut_raw(*e, codec, cut)

    return _trim(codec.pack_file_groups([[entry(n) for n in group] for group in names],
                                        stacked=stacked), cut)


def _stack_q_experts(mf: mfile.MFile, cfg: ModelConfig, fname: str, codec, cut=None):
    """Layer × expert stacked packed expert weights ``(L, E, ...)``, filled
    tensor by tensor into preallocated host planes: host transit is bounded
    by the packed size, with no f32 copy.  ``cut`` as :func:`_stack_q`."""
    L, E = cfg.n_layers, cfg.n_experts
    t0 = mf.info(f"layers.0.experts.0.{fname}")
    d0, n0 = int(np.prod(t0.shape[:-1])), t0.shape[-1]

    def raw(l, e):
        r = mf.raw(f"layers.{l}.experts.{e}.{fname}")
        return r if cut is None else _cut_raw(r, d0, n0, codec, cut)[0]

    d, n = (d0, n0) if cut is None else _cut_dims(d0, n0, cut)
    np_ = q40.padded_n(n)
    qp = codec.alloc_value_plane((L, E), np_, d)
    sc = np.zeros((L, E, np_ // 32, d), np.float16)
    for l in range(L):
        for e in range(E):
            codec.repack_file_bytes_into(raw(l, e), d, n, qp[l, e], sc[l, e])
    codec.check_finite(sc, f"{fname} expert scale plane")
    return _trim(codec.from_np(qp, sc, (n, d)), cut)


def load_params(mf: mfile.MFile, cfg: ModelConfig | None = None,
                device="cpu", fuse: bool = True,
                keep_quantized: bool = True, shard=None) -> tuple[ModelConfig, Params]:
    """Load a `.m` file into the runtime layout on ``device``.

    Q40 and Q80 files keep their matmuls packed, fused into ``wqkv`` and
    ``w13`` unless ``fuse`` is False (the JAX package's
    ``keep_quantized=True, fuse=...``: tensor parallelism loads unfused,
    since a fused concat axis mixes the ranks' slices); F32/F16 files load
    dense, and so do Q40/Q80 ones with ``keep_quantized=False`` (the CLI's
    ``--dequantize``: every weight dequantized to ``cfg.dtype``, its
    products plain ``x @ w``, as the JAX package leaves them to XLA).

    ``shard`` = (kinds, rank, tp) loads only TP rank ``rank``'s slice of
    every leaf that ``kinds`` (leaf → ``"row"``, ``"col"`` or None, as
    ``parallel.sharding`` plans them) slices, unfused: packed planes from
    only the slice's file bytes, dense ones read whole, then sliced.  Each
    slice equals ``sharding.shard`` of the whole leaf, bit for bit."""
    if cfg is None:
        cfg = ModelConfig.from_spec(mf.spec)
    codec = CODECS.get(mf.spec.weights_ftype) if keep_quantized else None
    L, dt = cfg.n_layers, cfg.dtype
    if shard is not None:
        fuse = False

    def per_layer(key):
        return [f"layers.{i}.{key}" for i in range(L)]

    def cut(key):
        if shard is None or shard[0].get(key) is None:
            return None
        return shard[0][key], shard[1], shard[2]

    p: Params = {"embedding": torch.from_numpy(mf.tensor("token_embedding")).to(dt)}
    if codec is not None:
        if fuse:
            p["wqkv"] = _stack_q(mf, [[f"layers.{i}.{k}" for k in ("wq", "wk", "wv")]
                                      for i in range(L)], codec)
        else:
            for key in ("wq", "wk", "wv"):
                p[key] = _stack_q(mf, [[n] for n in per_layer(key)], codec, cut(key))
        p["wo"] = _stack_q(mf, [[n] for n in per_layer("wo")], codec, cut("wo"))
        p["wcls"] = _stack_q(mf, [["wcls"]], codec, cut("wcls"), stacked=False)
    else:
        for key in ("wq", "wk", "wv", "wo"):
            p[key] = _stack(mf, per_layer(key), True, dt)
        p["wcls"] = torch.from_numpy(np.ascontiguousarray(mf.tensor("wcls").T)).to(dt)
    if cfg.is_moe:
        p["router"] = _stack(mf, per_layer("moe_router"), True, dt)
        for key in ("up", "gate", "down"):
            if codec is not None:
                p[key] = _stack_q_experts(mf, cfg, key, codec, cut(key))
            else:
                p[key] = torch.from_numpy(np.stack([np.stack(
                    [np.ascontiguousarray(mf.tensor(f"layers.{i}.experts.{e}.{key}").T)
                     for e in range(cfg.n_experts)]) for i in range(L)])).to(dt)
        if cfg.post_block_norms:
            p["rms_moe"] = _stack(mf, per_layer("rms_moe"), False, torch.float32)
            p["rms_ffn2"] = _stack(mf, per_layer("rms_ffn2"), False, torch.float32)
    elif codec is not None:
        if fuse:
            p["w13"] = _stack_q(mf, [[f"layers.{i}.w1", f"layers.{i}.w3"]
                                     for i in range(L)], codec)
        else:
            p["w1"] = _stack_q(mf, [[n] for n in per_layer("w1")], codec, cut("w1"))
            p["w3"] = _stack_q(mf, [[n] for n in per_layer("w3")], codec, cut("w3"))
        p["w2"] = _stack_q(mf, [[n] for n in per_layer("w2")], codec, cut("w2"))
    else:
        for key in ("w1", "w2", "w3"):
            p[key] = _stack(mf, per_layer(key), True, dt)
    p["rms_att"] = _stack(mf, per_layer("rms_att"), False, torch.float32)
    p["rms_ffn"] = _stack(mf, per_layer("rms_ffn"), False, torch.float32)
    p["rms_final"] = torch.from_numpy(mf.tensor("rms_final").astype(np.float32))
    if shard is not None and codec is None:  # dense leaves: read whole, then sliced
        p = {k: sharding.shard(v, shard[0].get(k), shard[1], shard[2])
             for k, v in p.items()}
    return cfg, to_device(p, device)


def leaf_kinds(mf: mfile.MFile, cfg: ModelConfig, tp: int,
               keep_quantized: bool = True) -> dict[str, str | None]:
    """How each leaf of ``mf`` is placed over ``tp`` ranks: the plan of
    ``sharding.param_kinds``, a leaf that does not divide replicated with
    :func:`sharding.place_params`'s ⚠️ line."""
    packed = keep_quantized and mf.spec.weights_ftype in CODECS
    kinds = {}
    for key, kind in sharding.param_kinds(cfg).items():
        if kind is not None:
            t = mf.info(FILE_NAMES[key])
            n, d = t.shape[-1], int(np.prod(t.shape[:-1]))
            if not sharding.divides_nd(n, d, kind, tp, packed):
                lead = () if key == "wcls" else (cfg.n_layers,) + (
                    (cfg.n_experts,) if key in ("up", "gate", "down") else ())
                sharding.warn_replicated(key, (*lead, n, d), tp)
                kind = None
        kinds[key] = kind
    return kinds


def load_placed(mf: mfile.MFile, cfg: ModelConfig, mesh,
                keep_quantized: bool = True) -> sharding.Placed:
    """This process's ranks of ``mesh`` (``mesh.ranks``, each on its
    device): :func:`load_params` with ``shard`` once a local rank, a
    replicated leaf shared by the ranks of one device.  The slices equal
    ``sharding.place_params`` of the whole file's params, bit for bit."""
    sharding.check_tp_constraint(cfg, mesh.tp)
    kinds = leaf_kinds(mf, cfg, mesh.tp, keep_quantized)
    ranks, shared = [], {}
    for r, dev in zip(mesh.ranks, mesh.devices):
        _, p = load_params(mf, cfg, keep_quantized=keep_quantized,
                           shard=(kinds, r, mesh.tp))
        placed = {}
        for k, v in p.items():
            if kinds[k] is None:
                placed[k] = shared.setdefault((k, dev), v.to(dev))
            else:
                placed[k] = v.to(dev)
        ranks.append(placed)
    return sharding.Placed(mesh, ranks, kinds)


def to_device(params: Params, device) -> Params:
    return {k: v.to(device) for k, v in params.items()}


def _tensor(a: np.ndarray) -> torch.Tensor:
    """numpy → torch, bfloat16 (an ml_dtypes array) included, by bits."""
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def from_jax_params(arrays: dict, cfg: ModelConfig, device="cpu") -> Params:
    """The port's params from the JAX package's, handed over as numpy: each
    packed weight as its ``(qpacked, scales uint16 f16-bits, logical_nd)``
    triple — uint8 values are Q40, int8 values Q80, with any leading dims
    (``(L, E, ...)`` expert stacks) — a blocked Q40 weight (the JAX
    ``BlockedQTensor``) as ``(qpacked 5-D, scales 5-D uint16, logical_nd,
    tiles, lead_2d)``, every other leaf as an array.  Bits are kept
    exactly, so both packages then run on the same weights."""
    out: Params = {}
    for k, v in arrays.items():
        if isinstance(v, tuple):
            qp, sc_bits, nd, *blocked = v
            sc = _tensor(np.asarray(sc_bits, np.uint16).view(np.float16))
            if blocked:
                tiles, lead_2d = blocked
                out[k] = q40.BlockedQTensor(_tensor(qp), sc, tuple(nd), tuple(tiles),
                                            bool(lead_2d))
                continue
            cls = q8.Q8Tensor if np.asarray(qp).dtype == np.int8 else q40.QTensor
            out[k] = cls(_tensor(qp), sc, tuple(nd))
        else:
            out[k] = _tensor(np.asarray(v))
    return to_device(out, device)
