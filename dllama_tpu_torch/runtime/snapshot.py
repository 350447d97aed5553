"""Engine-state snapshot file (DLSNAP02) and per-request hand-off record
(DLREQ01): versioned, checksummed, validated — a copy of
``dllama_tpu/runtime/snapshot.py`` that writes and reads the same bytes.

File layout (little-endian)::

    8 B   magic   b"DLSNAP02" (a file) or b"DLREQ01\\0" (a hand-off record)
    4 B   u32     meta_len
    4 B   u32     crc32(meta || payload)
    meta_len B    meta JSON
    *     payload concatenated raw array bytes

Meta JSON: ``{"fingerprint", "pos", "chunk_counter", "arrays": [{"name",
"dtype", "shape", "nbytes"}, ...], "extra": {...}}``.  Arrays are stored
in meta order, back to back, in the payload.

Every read is bounds-checked and the crc32 covers meta and payload, so a
truncated or bit-flipped snapshot raises :class:`ArtifactError` at load;
the server's restore path turns that into a logged cold start.  A file
with the superseded ``DLSNAP01`` magic is refused with its own message.

**bfloat16 without ml_dtypes.**  numpy has no bfloat16, and the JAX
package reads one through ``ml_dtypes``, which the port does not use.  A
bf16 array travels here as its raw 2-byte words: :class:`Bf16Words`, a
``np.uint16`` array that the descriptor names ``"bfloat16"`` — the same
name and bytes the JAX package writes — and that a load hands back for
every ``"bfloat16"`` descriptor.  :func:`to_numpy` and :func:`to_torch`
cross the engine boundary (``torch.bfloat16`` on the device).
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import struct
import threading
import time
import warnings
import zlib

import numpy as np
import torch

from ..io.integrity import ArtifactError

_log = logging.getLogger("dllama_tpu_torch.runtime.snapshot")

MAGIC = b"DLSNAP02"
# per-request hand-off record: one in-flight request's KV pages and decode
# state, shipped over HTTP between replicas; its own magic, so neither
# loader accepts the other's payload
REQ_MAGIC = b"DLREQ01\0"
# DLSNAP01 lacked the paged-KV state; refused with a distinct message
_LEGACY_MAGICS = (b"DLSNAP01",)
_HEADER = struct.Struct("<8sII")  # magic, meta_len, crc32(meta || payload)
_MAX_META = 1 << 24
BF16 = "bfloat16"


class SnapshotMismatch(ArtifactError):
    """A structurally valid snapshot that does not fit this engine (config
    fingerprint, array layout, position or sampling stream).  Still an
    ArtifactError: both mean "cold start"."""


class Bf16Words(np.ndarray):
    """bfloat16 values as their raw ``uint16`` words; the format names
    them ``"bfloat16"``."""


def bf16_words(a) -> Bf16Words:
    """``a`` (uint16 words, or any array of 2-byte items) marked bf16."""
    return np.asarray(a).view(np.uint16).view(Bf16Words)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor's values on the host; a bf16 tensor as :class:`Bf16Words`."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        return bf16_words(t.view(torch.int16).cpu().numpy())
    return t.cpu().numpy()


def to_torch(a: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    """A loaded array as a CPU tensor of ``dtype``: bf16 words are viewed as
    ``torch.bfloat16``, anything else is cast."""
    bf16 = isinstance(a, Bf16Words) or (dtype == torch.bfloat16 and a.dtype == np.uint16)
    a = np.ascontiguousarray(a)
    with warnings.catch_warnings():
        # a record's arrays view its read-only bytes; the tensor is only
        # read (copied to the device or cast)
        warnings.simplefilter("ignore", UserWarning)
        if bf16:
            t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
            return t if dtype == torch.bfloat16 else t.to(dtype)
        return torch.from_numpy(a).to(dtype)


def dtype_of(dt: torch.dtype) -> str:
    """A torch dtype's numpy-style name (``bfloat16``, ``float32``,
    ``int8``): what the JAX package writes and hashes."""
    return str(dt).removeprefix("torch.")


def dtype_name(a: np.ndarray) -> str:
    """The descriptor's dtype name of ``a`` (numpy's, or ``bfloat16``)."""
    return BF16 if isinstance(a, Bf16Words) else str(a.dtype)


def _np_dtype(name: str) -> np.dtype:
    if name == BF16:
        return np.dtype(np.uint16)
    return np.dtype(name)


def _encode(magic: bytes, *, fingerprint: str, pos: int, chunk_counter: int,
            arrays: dict, extra: dict | None) -> tuple[bytes, bytes, list]:
    """``(header, meta, blobs)``; each blob a contiguous array's memoryview
    (no copy of the payload)."""
    descs, blobs = [], []
    for name, arr in arrays.items():
        kind = dtype_name(arr)
        arr = np.ascontiguousarray(arr)
        blob = memoryview(arr).cast("B") if arr.size else memoryview(b"")
        descs.append({"name": name, "dtype": kind, "shape": list(arr.shape),
                      "nbytes": blob.nbytes})
        blobs.append(blob)
    meta = json.dumps({
        "fingerprint": fingerprint, "pos": int(pos),
        "chunk_counter": int(chunk_counter), "arrays": descs,
        "extra": extra or {},
    }, sort_keys=True).encode("utf-8")
    crc = zlib.crc32(meta)
    for blob in blobs:
        crc = zlib.crc32(blob, crc)
    return _HEADER.pack(magic, len(meta), crc & 0xFFFFFFFF), meta, blobs


def _decode_body(label: str, body, meta_len: int,
                 crc_want: int) -> tuple[dict, dict[str, np.ndarray]]:
    """Validate and parse ``meta || payload`` (everything after the
    header)."""
    if len(body) < meta_len:
        raise ArtifactError(label, "meta", "file truncated mid-field",
                            offset=_HEADER.size, expected=f"{meta_len} bytes",
                            got=f"{len(body)} bytes")
    crc_got = zlib.crc32(body) & 0xFFFFFFFF
    if crc_got != crc_want:
        raise ArtifactError(label, "checksum",
                            "checksum mismatch — snapshot bytes are corrupt",
                            offset=_HEADER.size, expected=f"crc32={crc_want:#010x}",
                            got=f"crc32={crc_got:#010x}")
    try:
        meta = json.loads(bytes(body[:meta_len]).decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise ArtifactError(label, "meta", f"unreadable snapshot meta: {e}",
                            offset=_HEADER.size) from e
    for key in ("fingerprint", "pos", "chunk_counter", "arrays"):
        if key not in meta:
            raise ArtifactError(label, f"meta.{key}", "missing required snapshot key")
    payload = memoryview(body)[meta_len:]
    arrays: dict[str, np.ndarray] = {}
    off = 0
    for d in meta["arrays"]:
        try:
            name, nbytes, kind = d["name"], int(d["nbytes"]), d["dtype"]
            dt = _np_dtype(kind)
            shape = tuple(int(s) for s in d["shape"])
        except (KeyError, TypeError, ValueError, AttributeError) as e:
            raise ArtifactError(label, "meta.arrays",
                                f"bad array descriptor {d!r}: {e}") from e
        count = int(np.prod(shape, dtype=np.int64))
        want = count * dt.itemsize
        if nbytes != want:
            raise ArtifactError(label, f"array {name!r}",
                                "descriptor nbytes disagrees with dtype×shape",
                                expected=want, got=nbytes)
        if off + nbytes > len(payload):
            raise ArtifactError(label, f"array {name!r}", "payload truncated",
                                offset=_HEADER.size + meta_len + off,
                                expected=f"{nbytes} bytes",
                                got=f"{len(payload) - off} bytes")
        a = np.frombuffer(payload, dtype=dt, count=count, offset=off).reshape(shape)
        arrays[name] = a.view(Bf16Words) if kind == BF16 else a
        off += nbytes
    if off != len(payload):
        raise ArtifactError(label, "payload", "trailing bytes after last array",
                            offset=_HEADER.size + meta_len + off, expected="EOF",
                            got=f"{len(payload) - off} extra bytes")
    return meta, arrays


def save(path: str | os.PathLike, *, fingerprint: str, pos: int,
         chunk_counter: int, arrays: dict, extra: dict | None = None) -> str:
    """Write a snapshot atomically (tmp + rename): a crash mid-write leaves
    the previous snapshot (or none), never a torn file."""
    path = os.fspath(path)
    header, meta, blobs = _encode(MAGIC, fingerprint=fingerprint, pos=pos,
                                  chunk_counter=chunk_counter, arrays=arrays, extra=extra)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(header)
        f.write(meta)
        for blob in blobs:
            f.write(blob)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    _log.debug("snapshot saved: %s, %d bytes, pos %d", path,
               _HEADER.size + len(meta) + sum(b.nbytes for b in blobs), int(pos))
    return path


def load(path: str | os.PathLike) -> tuple[dict, dict[str, np.ndarray]]:
    """Load and fully validate a snapshot; returns ``(meta, arrays)``.
    Raises :class:`ArtifactError` on any corruption (bad magic, truncation,
    crc mismatch, inconsistent descriptors).  The fingerprint is the
    caller's check (:meth:`Engine.restore`)."""
    path = os.fspath(path)
    file_size = os.path.getsize(path)
    with open(path, "rb") as f:
        head = f.read(_HEADER.size)
        if len(head) != _HEADER.size:
            raise ArtifactError(path, "snapshot header", "file truncated mid-field",
                                offset=0, expected=f"{_HEADER.size} bytes",
                                got=f"{len(head)} bytes")
        magic, meta_len, crc_want = _HEADER.unpack(head)
        if magic in _LEGACY_MAGICS:
            raise ArtifactError(path, "magic",
                                "superseded snapshot format — this build writes "
                                "DLSNAP02 (paged-KV state); delete the old snapshot "
                                "and cold-start", offset=0, expected=MAGIC, got=magic)
        if magic != MAGIC:
            raise ArtifactError(path, "magic", "not a dllama snapshot", offset=0,
                                expected=MAGIC, got=magic)
        if not (2 <= meta_len <= min(_MAX_META, file_size)):
            raise ArtifactError(path, "meta_len", "value out of range — corrupt snapshot",
                                offset=8, expected=f"2..{_MAX_META}", got=meta_len)
        body = bytearray(file_size - _HEADER.size)
        n = f.readinto(body)
        del body[n:]
    meta, arrays = _decode_body(path, body, meta_len, crc_want)
    _log.debug("snapshot loaded: %s, %d bytes, pos %d", path, file_size, int(meta["pos"]))
    return meta, arrays


def dumps_request(*, fingerprint: str, pos: int, chunk_counter: int,
                  arrays: dict, extra: dict) -> bytes:
    """A per-request hand-off record (DLREQ01) as bytes: the DLSNAP02
    layout under :data:`REQ_MAGIC`, sent as an HTTP octet stream.
    ``extra`` carries the request's decode state, ``arrays`` its KV page
    slices and sampler state."""
    header, meta, blobs = _encode(REQ_MAGIC, fingerprint=fingerprint, pos=pos,
                                  chunk_counter=chunk_counter, arrays=arrays, extra=extra)
    return b"".join([header, meta, *blobs])


def loads_request(blob, label: str = "<handoff record>"
                  ) -> tuple[dict, dict[str, np.ndarray]]:
    """Parse and fully validate a DLREQ01 record; raises
    :class:`ArtifactError` on any corruption.  The geometry check is the
    importing scheduler's."""
    if len(blob) < _HEADER.size:
        raise ArtifactError(label, "snapshot header", "file truncated mid-field",
                            offset=0, expected=f"{_HEADER.size} bytes",
                            got=f"{len(blob)} bytes")
    magic, meta_len, crc_want = _HEADER.unpack(bytes(blob[:_HEADER.size]))
    if magic != REQ_MAGIC:
        raise ArtifactError(label, "magic", "not a dllama hand-off record", offset=0,
                            expected=REQ_MAGIC, got=magic)
    if not (2 <= meta_len <= min(_MAX_META, len(blob))):
        raise ArtifactError(label, "meta_len", "value out of range — corrupt record",
                            offset=8, expected=f"2..{_MAX_META}", got=meta_len)
    return _decode_body(label, memoryview(blob)[_HEADER.size:], meta_len, crc_want)


def fingerprint(fields: dict) -> str:
    """Stable short digest of an engine-shape description (truncated
    sha256 of the sorted-key JSON)."""
    blob = json.dumps(fields, sort_keys=True).encode("utf-8")
    return hashlib.sha256(blob).hexdigest()[:16]


class RecordStore:
    """TTL-bounded ``rid -> DLREQ01 bytes`` store: a draining replica parks
    its export records here for the router to claim (``--handoff-ttl``).
    Every read-side access sweeps expired entries first and reports each
    through ``on_expire``; ``ttl <= 0`` keeps records until claimed."""

    def __init__(self, ttl: float = 0.0, on_expire=None):
        self.ttl = float(ttl)
        self.on_expire = on_expire
        self._lock = threading.Lock()
        self._items: dict[str, tuple[bytes, float]] = {}

    def _sweep_locked(self) -> None:
        if self.ttl <= 0 or not self._items:
            return
        now = time.monotonic()
        dead = [rid for rid, (_, born) in self._items.items() if now - born > self.ttl]
        for rid in dead:
            del self._items[rid]
        if self.on_expire is not None:
            for rid in dead:
                try:
                    self.on_expire(rid)
                except Exception:  # noqa: BLE001 — expiry is best-effort
                    _log.warning("record expiry callback failed for %s", rid)

    def put(self, rid: str, blob: bytes) -> None:
        with self._lock:
            self._items[rid] = (blob, time.monotonic())

    def update(self, records: dict) -> None:
        now = time.monotonic()
        with self._lock:
            for rid, blob in records.items():
                self._items[rid] = (blob, now)

    def pop(self, rid: str, default=None):
        with self._lock:
            self._sweep_locked()
            item = self._items.pop(rid, None)
        return item[0] if item is not None else default

    def get(self, rid: str, default=None):
        with self._lock:
            self._sweep_locked()
            item = self._items.get(rid)
        return item[0] if item is not None else default

    def discard(self, rid: str) -> None:
        with self._lock:
            self._items.pop(rid, None)

    def sweep(self) -> int:
        """Explicit expiry pass; returns how many records remain."""
        with self._lock:
            self._sweep_locked()
            return len(self._items)

    def __len__(self) -> int:
        with self._lock:
            self._sweep_locked()
            return len(self._items)

    def __bool__(self) -> bool:
        return len(self) > 0
