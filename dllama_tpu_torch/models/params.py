"""Parameter dicts: random init (tests), `.m`-file loading, and conversion
from the JAX package's params — the port of ``dllama_tpu/models/params.py``
for dense Llama.

Weights are stored input-dim-first (``x @ w``) and layer-stacked (a
leading ``n_layers`` axis); the model's layer loop indexes the stacks.  A
Q40 file keeps its matmuls packed (``ops.q40.QTensor``), with q/k/v fused
into ``wqkv`` and w1/w3 into ``w13`` (one kernel launch each per layer);
norms and the embedding load dense.  F32/F16 files load dense.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import quants
from ..io import mfile
from ..ops import q40
from .config import ModelConfig

Params = dict  # str -> torch.Tensor | q40.QTensor


def param_shapes(cfg: ModelConfig) -> dict[str, tuple[int, ...]]:
    if cfg.is_moe:
        raise NotImplementedError("MoE models (Mixtral, Grok-1) are not yet "
                                  "ported to dllama_tpu_torch")
    L, D, F, V = cfg.n_layers, cfg.dim, cfg.hidden_dim, cfg.vocab_size
    hq = cfg.n_heads * cfg.head_size
    hkv = cfg.n_kv_heads * cfg.head_size
    return {
        "embedding": (V, D),
        "wq": (L, D, hq),
        "wk": (L, D, hkv),
        "wv": (L, D, hkv),
        "wo": (L, hq, D),
        "rms_att": (L, D),
        "rms_ffn": (L, D),
        "rms_final": (D,),
        "wcls": (D, V),
        "w1": (L, D, F),
        "w2": (L, F, D),
        "w3": (L, D, F),
    }


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


def quantize_matmuls(params: Params, cfg: ModelConfig) -> Params:
    """Convert the dense matmul weights to packed Q40, fused as the loader
    fuses them (``wqkv``, ``w13``)."""
    def f32(k):
        return params[k].to(torch.float32).numpy()

    out = {k: v for k, v in params.items()
           if k not in ("wq", "wk", "wv", "w1", "w3")}
    out["wqkv"] = q40.quantize(np.concatenate([f32(k) for k in ("wq", "wk", "wv")], axis=-1))
    out["w13"] = q40.quantize(np.concatenate([f32(k) for k in ("w1", "w3")], axis=-1))
    for k in ("wo", "w2", "wcls"):
        out[k] = q40.quantize(f32(k))
    return out


def _stack(mf: mfile.MFile, names: list[str], transpose: bool, dtype) -> torch.Tensor:
    mats = [mf.tensor(n) for n in names]
    if transpose:
        mats = [np.ascontiguousarray(m.T) for m in mats]
    return torch.from_numpy(np.stack(mats)).to(dtype)


def _stack_q(mf: mfile.MFile, names: list[list[str]]) -> q40.QTensor:
    """Layer-stack Q40 tensors straight from their packed file bytes (a byte
    transpose per tensor, no f32 transit); each inner list fuses its
    tensors' output dims."""
    def entry(name):
        t = mf.info(name)
        return (mf.raw(name), int(np.prod(t.shape[:-1])), t.shape[-1])

    return q40.pack_file_groups([[entry(n) for n in group] for group in names])


def load_params(mf: mfile.MFile, cfg: ModelConfig | None = None,
                device="cpu") -> tuple[ModelConfig, Params]:
    """Load a `.m` file into the runtime layout on ``device``.

    Q40 files keep their matmuls packed and fused (the JAX package's
    ``keep_quantized=True, fuse=True``); F32/F16 files load dense.  Q80
    files and MoE models raise ``NotImplementedError``."""
    if cfg is None:
        cfg = ModelConfig.from_spec(mf.spec)
    ftype = mf.spec.weights_ftype
    if ftype == quants.Q80:
        raise NotImplementedError("Q80 weights are not yet ported to "
                                  "dllama_tpu_torch (use a Q40, F16 or F32 file)")
    if cfg.is_moe:
        raise NotImplementedError("MoE models (Mixtral, Grok-1) are not yet "
                                  "ported to dllama_tpu_torch")
    L, dt = cfg.n_layers, cfg.dtype
    per_layer = lambda key: [f"layers.{i}.{key}" for i in range(L)]  # noqa: E731
    p: Params = {"embedding": torch.from_numpy(mf.tensor("token_embedding")).to(dt)}
    if ftype == quants.Q40:
        p["wqkv"] = _stack_q(mf, [[f"layers.{i}.{k}" for k in ("wq", "wk", "wv")]
                                  for i in range(L)])
        p["wo"] = _stack_q(mf, [[n] for n in per_layer("wo")])
        p["w13"] = _stack_q(mf, [[f"layers.{i}.w1", f"layers.{i}.w3"] for i in range(L)])
        p["w2"] = _stack_q(mf, [[n] for n in per_layer("w2")])
        tw = mf.info("wcls")
        p["wcls"] = q40.pack_file_groups(
            [[(mf.raw("wcls"), int(np.prod(tw.shape[:-1])), tw.shape[-1])]],
            stacked=False)
    else:
        for key in ("wq", "wk", "wv", "wo", "w1", "w2", "w3"):
            p[key] = _stack(mf, per_layer(key), True, dt)
        p["wcls"] = torch.from_numpy(np.ascontiguousarray(mf.tensor("wcls").T)).to(dt)
    p["rms_att"] = _stack(mf, per_layer("rms_att"), False, torch.float32)
    p["rms_ffn"] = _stack(mf, per_layer("rms_ffn"), False, torch.float32)
    p["rms_final"] = torch.from_numpy(mf.tensor("rms_final").astype(np.float32))
    return cfg, to_device(p, device)


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
    packed weight as its ``(qpacked u8, scales uint16 f16-bits,
    logical_nd)`` triple, every other leaf as an array.  Bits are kept
    exactly, so both packages then run on the same weights."""
    out: Params = {}
    for k, v in arrays.items():
        if isinstance(v, tuple):
            qp, sc_bits, nd = v
            out[k] = q40.QTensor(_tensor(qp),
                                 _tensor(np.asarray(sc_bits, np.uint16).view(np.float16)),
                                 tuple(nd))
        else:
            out[k] = _tensor(np.asarray(v))
    return to_device(out, device)
