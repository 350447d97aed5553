"""`.m` model-file format: reader + writer.

A copy of ``dllama_tpu/io/mfile.py``, with its checksum-manifest
verification (``io/integrity.py``) and the ``io.read_tensor`` fault point:

* header: magic ``0xA00ABCD``, an i32 ``headerSize`` (total header bytes
  incl. magic+size), then (key, value) i32 pairs, the weights float type
  among them; or a legacy magic ``0xABCD00``/``0xABCD01`` (the reference's
  older converters: the magic is the architecture) and a fixed struct of 9
  i32 (dim, hidden_dim, n_layers, n_heads, n_kv_heads, n_experts,
  n_active_experts, vocab_size, seq_len), which names no weights float
  type: the reader is given it (the CLI's ``--weights-float-type``).
* tensor walk: embedding, then per layer q/k/v/wo, (router + per-expert
  up/gate/down | w1/w2/w3), rms_att, rms_ffn, (grok: rms_moe, rms_ffn2),
  then rms_final and wcls.  Matmul weights are stored row-major
  ``(d_out, n_in)`` in the model's weight float type; norm weights and the
  embedding are F32.

Reading is mmap-backed and lazy: ``MFile.raw(name)`` hands out one
tensor's file bytes without a copy.
"""

from __future__ import annotations

import mmap
import os
import struct
from dataclasses import dataclass

import numpy as np

from .. import quants
from .integrity import ArtifactError, load_manifest_for, verify_bytes

MAGIC_V2 = 0xA00ABCD
LEGACY_MAGICS = (0xABCD00, 0xABCD01)

ARCH_LLAMA = 0xABCD00
ARCH_GROK1 = 0xABCD01
ARCH_MIXTRAL = 0xABCD02
ARCH_NAMES = {ARCH_LLAMA: "llama", ARCH_GROK1: "grok1", ARCH_MIXTRAL: "mixtral"}

ACT_GELU = 0
ACT_SILU = 1

KEY_VERSION = 0
KEY_ARCH_TYPE = 1
KEY_DIM = 2
KEY_HIDDEN_DIM = 3
KEY_N_LAYERS = 4
KEY_N_HEADS = 5
KEY_N_KV_HEADS = 6
KEY_N_EXPERTS = 7
KEY_N_ACTIVE_EXPERTS = 8
KEY_VOCAB_SIZE = 9
KEY_SEQ_LEN = 10
KEY_HIDDEN_ACT = 11
KEY_ROPE_THETA = 12
KEY_WEIGHTS_FLOAT_TYPE = 13

_FIELDS = {KEY_VERSION: "version", KEY_ARCH_TYPE: "arch", KEY_DIM: "dim",
           KEY_HIDDEN_DIM: "hidden_dim", KEY_N_LAYERS: "n_layers",
           KEY_N_HEADS: "n_heads", KEY_N_KV_HEADS: "n_kv_heads",
           KEY_N_EXPERTS: "n_experts",
           KEY_N_ACTIVE_EXPERTS: "n_active_experts",
           KEY_VOCAB_SIZE: "vocab_size", KEY_SEQ_LEN: "seq_len",
           KEY_HIDDEN_ACT: "hidden_act"}


@dataclass
class ModelSpec:
    """Model hyperparameters — the reference's ``TransformerSpec``."""

    arch: int = ARCH_LLAMA
    dim: int = 0
    hidden_dim: int = 0
    n_layers: int = 0
    n_heads: int = 0
    n_kv_heads: int = 0
    n_experts: int = 0
    n_active_experts: int = 0
    vocab_size: int = 0
    seq_len: int = 0
    hidden_act: int = ACT_SILU
    rope_theta: float = 10000.0
    weights_ftype: int = quants.F32
    version: int = 1
    header_size: int = 0

    @property
    def kv_dim(self) -> int:
        return (self.dim * self.n_kv_heads) // self.n_heads

    @property
    def arch_name(self) -> str:
        return ARCH_NAMES.get(self.arch, hex(self.arch))


@dataclass
class TensorInfo:
    name: str
    shape: tuple[int, ...]  # logical row-major shape; matmuls are (d_out, n_in)
    ftype: int
    offset: int  # absolute byte offset in the file
    nbytes: int


def tensor_plan(spec: ModelSpec) -> list[TensorInfo]:
    """The fixed tensor order of a `.m` file; offsets start right after the
    header."""
    w = spec.weights_ftype
    plan: list[TensorInfo] = []
    pos = spec.header_size

    def add(name: str, shape: tuple[int, ...], ftype: int):
        nonlocal pos
        d = int(np.prod(shape[:-1])) if len(shape) > 1 else 1
        nbytes = quants.batch_bytes(ftype, shape[-1], d)
        plan.append(TensorInfo(name, shape, ftype, pos, nbytes))
        pos += nbytes

    add("token_embedding", (spec.vocab_size, spec.dim), quants.F32)
    for i in range(spec.n_layers):
        add(f"layers.{i}.wq", (spec.dim, spec.dim), w)
        add(f"layers.{i}.wk", (spec.kv_dim, spec.dim), w)
        add(f"layers.{i}.wv", (spec.kv_dim, spec.dim), w)
        add(f"layers.{i}.wo", (spec.dim, spec.dim), w)
        if spec.n_experts > 0:
            add(f"layers.{i}.moe_router", (spec.n_experts, spec.dim), w)
            for e in range(spec.n_experts):
                add(f"layers.{i}.experts.{e}.up", (spec.hidden_dim, spec.dim), w)
                add(f"layers.{i}.experts.{e}.gate", (spec.hidden_dim, spec.dim), w)
                add(f"layers.{i}.experts.{e}.down", (spec.dim, spec.hidden_dim), w)
        else:
            add(f"layers.{i}.w1", (spec.hidden_dim, spec.dim), w)
            add(f"layers.{i}.w2", (spec.dim, spec.hidden_dim), w)
            add(f"layers.{i}.w3", (spec.hidden_dim, spec.dim), w)
        add(f"layers.{i}.rms_att", (spec.dim,), quants.F32)
        add(f"layers.{i}.rms_ffn", (spec.dim,), quants.F32)
        if spec.arch == ARCH_GROK1:
            add(f"layers.{i}.rms_moe", (spec.dim,), quants.F32)
            add(f"layers.{i}.rms_ffn2", (spec.dim,), quants.F32)
    add("rms_final", (spec.dim,), quants.F32)
    add("wcls", (spec.vocab_size, spec.dim), w)
    return plan


def _read_exact(f, n: int, path, field: str) -> tuple[bytes, int]:
    off = f.tell()
    data = f.read(n)
    if len(data) != n:
        raise ArtifactError(path, field, "file truncated mid-field",
                            offset=off, expected=f"{n} bytes",
                            got=f"{len(data)} bytes")
    return data, off


_SPEC_BOUNDS = {
    "dim": (1, 1 << 20),
    "hidden_dim": (1, 1 << 24),
    "n_layers": (1, 4096),
    "n_heads": (1, 4096),
    "n_kv_heads": (1, 4096),
    "n_experts": (0, 512),
    "n_active_experts": (0, 512),
    "vocab_size": (1, 1 << 24),
    "seq_len": (1, 1 << 24),
}


def validate_spec(spec: ModelSpec, path) -> ModelSpec:
    """Range-check every header field and the divisibility invariants the
    runtime assumes; raises :class:`ArtifactError` naming the field."""
    for name, (lo, hi) in _SPEC_BOUNDS.items():
        v = getattr(spec, name)
        if not (lo <= v <= hi):
            raise ArtifactError(path, f"header field {name}",
                                "value out of range — corrupt header",
                                expected=f"{lo}..{hi}", got=v)
    if spec.arch not in ARCH_NAMES:
        raise ArtifactError(path, "header field arch", "unknown architecture id",
                            expected=sorted(hex(a) for a in ARCH_NAMES),
                            got=hex(spec.arch))
    if spec.hidden_act not in (ACT_GELU, ACT_SILU):
        raise ArtifactError(path, "header field hidden_act",
                            "unknown activation id", expected="0|1",
                            got=spec.hidden_act)
    if spec.weights_ftype not in quants.FLOAT_TYPE_NAMES:
        raise ArtifactError(path, "header field weights_ftype",
                            "unknown weights float type",
                            expected=sorted(quants.FLOAT_TYPE_NAMES),
                            got=spec.weights_ftype)
    if not spec.rope_theta > 0:
        raise ArtifactError(path, "header field rope_theta", "must be positive",
                            got=spec.rope_theta)
    if spec.n_kv_heads > spec.n_heads:
        raise ArtifactError(path, "header field n_kv_heads",
                            "more KV heads than attention heads",
                            expected=f"<= {spec.n_heads}", got=spec.n_kv_heads)
    if spec.dim % spec.n_heads:
        raise ArtifactError(path, "header field n_heads",
                            "dim not divisible by n_heads",
                            expected=f"divisor of dim={spec.dim}", got=spec.n_heads)
    if spec.n_heads % spec.n_kv_heads:
        raise ArtifactError(path, "header field n_kv_heads",
                            "n_heads not divisible by n_kv_heads (GQA)",
                            expected=f"divisor of n_heads={spec.n_heads}",
                            got=spec.n_kv_heads)
    if spec.n_active_experts > spec.n_experts:
        raise ArtifactError(path, "header field n_active_experts",
                            "more active experts than experts",
                            expected=f"<= {spec.n_experts}",
                            got=spec.n_active_experts)
    return spec


def read_spec(path: str | os.PathLike, weights_ftype: int | None = None) -> ModelSpec:
    """Parse + validate a `.m` header, v2 or legacy-magic.  A header's
    weights float type wins over ``weights_ftype`` (the reference's
    precedence); ``weights_ftype`` covers a file without one (every
    legacy-magic file), and such a file without it is refused."""
    spec = ModelSpec()
    found_wft = False
    file_size = os.path.getsize(path)
    with open(path, "rb") as f:
        raw, _ = _read_exact(f, 4, path, "magic")
        (magic,) = struct.unpack("<i", raw)
        if magic in LEGACY_MAGICS:
            raw, _ = _read_exact(f, 36, path, "legacy header")
            spec.arch = magic
            (spec.dim, spec.hidden_dim, spec.n_layers, spec.n_heads, spec.n_kv_heads,
             spec.n_experts, spec.n_active_experts, spec.vocab_size,
             spec.seq_len) = struct.unpack("<9i", raw)
            spec.header_size = 4 + 36
            return _with_ftype(spec, found_wft, weights_ftype, path)
        if magic != MAGIC_V2:
            raise ArtifactError(path, "magic", "unsupported model file magic",
                                offset=0,
                                expected=[hex(MAGIC_V2)] + [hex(m) for m in LEGACY_MAGICS],
                                got=hex(magic & 0xFFFFFFFF))
        raw, off = _read_exact(f, 4, path, "headerSize")
        (header_size,) = struct.unpack("<i", raw)
        if header_size < 8 or (header_size - 8) % 8:
            raise ArtifactError(
                path, "headerSize",
                "must be 8 + a whole number of (key, value) i32 pairs",
                offset=off, expected="8 + 8k", got=header_size)
        if header_size > file_size:
            raise ArtifactError(path, "headerSize", "header extends past end of file",
                                offset=off, expected=f"<= {file_size}",
                                got=header_size)
        spec.header_size = header_size
        body, body_off = _read_exact(f, header_size - 8, path, "header body")
    kv = struct.unpack(f"<{len(body) // 4}i", body)
    for i, (k, v) in enumerate(zip(kv[::2], kv[1::2])):
        if k in _FIELDS:
            setattr(spec, _FIELDS[k], v)
        elif k == KEY_ROPE_THETA:
            spec.rope_theta = float(v)
        elif k == KEY_WEIGHTS_FLOAT_TYPE:
            spec.weights_ftype = v
            found_wft = True
        else:
            raise ArtifactError(path, "header key", "unsupported .m header key",
                                offset=body_off + 8 * i,
                                expected=f"0..{KEY_WEIGHTS_FLOAT_TYPE}", got=k)
    return _with_ftype(spec, found_wft, weights_ftype, path)


def _with_ftype(spec: ModelSpec, found_wft: bool, weights_ftype: int | None,
                path) -> ModelSpec:
    """``spec`` with the caller's weights float type where the header names
    none (refused without one), validated."""
    if not found_wft:
        if weights_ftype is None:
            raise ArtifactError(
                path, "header field weights_ftype",
                "model file does not specify weights float type; pass weights_ftype "
                "(the CLI's --weights-float-type)")
        spec.weights_ftype = weights_ftype
    return validate_spec(spec, path)


class MFile:
    """mmap-backed lazy `.m` reader with integrity checking.

    When a sidecar checksum manifest (``<path>.sum``, io/integrity.py)
    exists, the header digest is verified at open, always, and each
    tensor's digest on its first read when ``verify=True`` (the CLI's
    ``--verify-weights``).  ``verify=True`` without a manifest is an error:
    silently skipping requested verification would defeat it."""

    def __init__(self, path: str | os.PathLike, verify: bool = False,
                 weights_ftype: int | None = None):
        self.path = os.fspath(path)
        self.spec = read_spec(path, weights_ftype)
        self.verify_weights = verify
        self.manifest = load_manifest_for(self.path)
        self._verified: set[str] = set()
        if verify and self.manifest is None:
            raise ArtifactError(
                self.path, "manifest",
                "weight verification requested but no checksum manifest found at "
                f"{self.path}.sum (write one with python -m "
                "dllama_tpu_torch.io.integrity write)")
        self._f = open(self.path, "rb")
        self._mm = mmap.mmap(self._f.fileno(), 0, access=mmap.ACCESS_READ)
        if self.manifest is not None:
            # before the tensor plan is derived from the header's fields: a
            # flipped header is caught here, not as a shape error later
            if self.manifest["file_size"] != len(self._mm):
                raise ArtifactError(self.path, "file size", "size mismatch vs manifest",
                                    expected=self.manifest["file_size"], got=len(self._mm))
            verify_bytes(self.manifest["header"], self._mm[:self.spec.header_size],
                         self.path, "header")
        try:
            self.plan = tensor_plan(self.spec)
        except ValueError as e:
            raise ArtifactError(
                self.path, "header",
                f"header describes an impossible tensor plan: {e}") from e
        self.by_name = {t.name: t for t in self.plan}
        end = self.plan[-1].offset + self.plan[-1].nbytes
        if len(self._mm) != end:
            raise ArtifactError(
                self.path, "file size",
                f"model file size mismatch: file={len(self._mm)} expected={end}",
                expected=end, got=len(self._mm))

    def close(self):
        try:
            self._mm.close()
        except BufferError:
            # zero-copy views handed out by raw() still reference the map;
            # it closes when the last view is collected
            pass
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def info(self, name: str) -> TensorInfo:
        t = self.by_name.get(name)
        if t is None:
            sample = ", ".join(sorted(self.by_name)[:6])
            raise ArtifactError(
                self.path, f"tensor {name!r}",
                f"unknown tensor name; this {self.spec.arch_name} file has "
                f"{len(self.by_name)} tensors ({sample}, ...)")
        return t

    def raw(self, name: str) -> np.ndarray:
        """One tensor's packed file bytes (a read-only view of the map),
        checksum-verified on first read under ``verify=True``.  The
        ``io.read_tensor`` fault point's ``corrupt`` action flips a byte of
        the returned buffer (runtime/faults.py)."""
        from ..runtime.faults import FAULTS
        t = self.info(name)
        buf = np.frombuffer(self._mm, dtype=np.uint8, count=t.nbytes, offset=t.offset)
        if "corrupt" in FAULTS.fire("io.read_tensor"):
            buf = buf.copy()
            buf[0] ^= 0xFF
        if self.verify_weights and name not in self._verified:
            ent = self.manifest["tensors"].get(name)
            if ent is None:
                raise ArtifactError(self.path, f"tensor {name!r}",
                                    "tensor missing from checksum manifest "
                                    "(stale manifest? regenerate it)")
            if (ent["offset"], ent["nbytes"]) != (t.offset, t.nbytes):
                raise ArtifactError(
                    self.path, f"tensor {name!r}",
                    "manifest byte range disagrees with the file's tensor "
                    "plan (stale manifest? regenerate it)",
                    offset=t.offset, expected=(ent["offset"], ent["nbytes"]),
                    got=(t.offset, t.nbytes))
            verify_bytes(ent, buf, self.path, f"tensor {name!r}")
            self._verified.add(name)
        return buf

    def tensor(self, name: str) -> np.ndarray:
        """Dequantize one tensor to f32 in its logical row-major shape."""
        t = self.info(name)
        n = int(np.prod(t.shape))
        return quants.dequantize_tensor(self.raw(name), t.ftype, n).reshape(t.shape)


def write_header(f, spec: ModelSpec) -> int:
    """Write a v2 `.m` header; returns its byte count."""
    pairs = [
        (KEY_VERSION, spec.version),
        (KEY_ARCH_TYPE, spec.arch),
        (KEY_DIM, spec.dim),
        (KEY_HIDDEN_DIM, spec.hidden_dim),
        (KEY_N_LAYERS, spec.n_layers),
        (KEY_N_HEADS, spec.n_heads),
        (KEY_N_KV_HEADS, spec.n_kv_heads),
        (KEY_N_EXPERTS, spec.n_experts),
        (KEY_N_ACTIVE_EXPERTS, spec.n_active_experts),
        (KEY_VOCAB_SIZE, spec.vocab_size),
        (KEY_SEQ_LEN, spec.seq_len),
        (KEY_HIDDEN_ACT, spec.hidden_act),
        (KEY_ROPE_THETA, int(spec.rope_theta)),
        (KEY_WEIGHTS_FLOAT_TYPE, spec.weights_ftype),
    ]
    data = b"".join(struct.pack("<ii", k, v) for k, v in pairs)
    f.write(struct.pack("<ii", MAGIC_V2, 8 + len(data)))
    f.write(data)
    return 8 + len(data)


class MFileWriter:
    """Streams tensors into a `.m` file in the canonical order."""

    def __init__(self, path: str | os.PathLike, spec: ModelSpec):
        self.spec = spec
        self._i = 0
        self._f = open(path, "wb")
        spec.header_size = write_header(self._f, spec)
        self.plan = tensor_plan(spec)

    def _expect(self, name: str) -> TensorInfo:
        expect = self.plan[self._i]
        if name != expect.name:
            raise ValueError(f"tensor order mismatch: got {name}, want {expect.name}")
        return expect

    def write_tensor(self, name: str, x: np.ndarray) -> None:
        expect = self._expect(name)
        if tuple(x.shape) != tuple(expect.shape):
            raise ValueError(f"{name}: shape {x.shape} != {expect.shape}")
        self._f.write(quants.quantize_tensor(x, expect.ftype))
        self._i += 1

    def write_raw(self, name: str, raw: np.ndarray | bytes) -> None:
        """Write a tensor's already-encoded bytes (size-checked against the
        plan), so large models can be synthesized at packed size."""
        expect = self._expect(name)
        want = quants.batch_bytes(expect.ftype, int(np.prod(expect.shape)))
        raw = np.asarray(raw, np.uint8) if not isinstance(raw, bytes) else raw
        got = raw.nbytes if isinstance(raw, np.ndarray) else len(raw)
        if got != want:
            raise ValueError(f"{name}: raw payload {got} B != expected {want} B")
        self._f.write(raw.tobytes() if isinstance(raw, np.ndarray) else raw)
        self._i += 1

    def close(self):
        if self._i != len(self.plan):
            raise ValueError(f"file incomplete: {self._i}/{len(self.plan)} tensors written")
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, *exc):
        if exc_type is None:
            self.close()
        else:
            self._f.close()
