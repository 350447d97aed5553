"""Artifact integrity: the typed loader error, the integrity counters and
checksum manifests — the port of ``dllama_tpu/io/integrity.py``.

* :class:`ArtifactError` is what a corrupt or mismatched model, tokenizer
  or snapshot raises: the message names the file, the field, and where
  known the byte offset and the expected and found values.
* **Checksum manifests**: a JSON sidecar (``<model>.m.sum``) with a crc32
  per tensor byte range plus a header digest (a ``.t`` tokenizer gets one
  whole-file digest).  The format is the JAX package's, byte for byte: a
  manifest written by either package verifies in the other.  ``MFile``
  verifies the header digest whenever the sidecar exists and each
  tensor's digest lazily on its first read under ``verify=True``
  (``--verify-weights``); ``read_tfile`` verifies the whole file.  crc32
  (zlib) detects corruption on trusted storage; it is not a MAC.
* **Counters**: registry counters (:mod:`..obs.metrics`), so ``/metrics``
  reads the same numbers in both formats.

Write a manifest with ``python -m dllama_tpu_torch.io.integrity write
model.m`` (``verify`` checks every region at once).
"""

from __future__ import annotations

import json
import os
import zlib

MANIFEST_FORMAT = "dllama-manifest"
MANIFEST_VERSION = 1
MANIFEST_SUFFIX = ".sum"


class ArtifactError(ValueError):
    """A model, tokenizer or snapshot artifact failed validation.  The
    message names the file, the field, and where known the byte offset and
    the expected and found values."""

    def __init__(self, path, field: str, message: str, *,
                 offset: int | None = None, expected=None, got=None):
        self.path = str(path) if path is not None else None
        self.field = field
        self.offset = offset
        self.expected = expected
        self.got = got
        loc = f" at byte {offset}" if offset is not None else ""
        detail = ""
        if expected is not None or got is not None:
            detail = f" (expected {expected!r}, got {got!r})"
        where = f"{self.path}: " if self.path else ""
        super().__init__(f"{where}{field}{loc}: {message}{detail}")


# -- verification counters (exported at /metrics) -------------------------
# registered at obs import, so every key is present from boot (a counter
# that appears only after its first failure reads as "metric missing")

_INTEGRITY_KEYS = ("checksum_verified", "checksum_failures",
                   "numeric_faults", "snapshot_restores")


def _counter(name: str):
    from ..obs import metrics
    return metrics.REGISTRY.counter(name)


def bump_counter(name: str, n: int = 1) -> None:
    _counter(name).inc(n)


def counters() -> dict:
    """Snapshot of the process-global verification counters."""
    return {k: _counter(k).value for k in _INTEGRITY_KEYS}


def reset_counters() -> None:
    """Test isolation helper."""
    for k in _INTEGRITY_KEYS:
        _counter(k).reset()


# -- digests ---------------------------------------------------------------

def digest(data) -> int:
    """crc32 of a bytes-like object (numpy arrays accepted)."""
    return zlib.crc32(memoryview(data).cast("B")) & 0xFFFFFFFF


def _file_crc32(path, offset: int = 0, nbytes: int | None = None,
                chunk: int = 1 << 24) -> int:
    crc = 0
    remaining = nbytes
    with open(path, "rb") as f:
        f.seek(offset)
        while True:
            n = chunk if remaining is None else min(chunk, remaining)
            if n == 0:
                break
            buf = f.read(n)
            if not buf:
                break
            crc = zlib.crc32(buf, crc)
            if remaining is not None:
                remaining -= len(buf)
    return crc & 0xFFFFFFFF


# -- manifest build / write / load ----------------------------------------

def manifest_path_for(artifact_path) -> str:
    return os.fspath(artifact_path) + MANIFEST_SUFFIX


def build_manifest(path) -> dict:
    """Build a manifest dict for an artifact.

    ``.m`` model files get a per-tensor manifest (header digest + one
    crc32 per tensor byte-range, in the canonical tensor-plan order);
    any other file (e.g. a ``.t`` tokenizer) gets a whole-file digest
    stored as its ``header`` entry — the lazy-verification granularity
    only matters for the multi-GB weights.  (The JAX package also reads
    legacy ``.m`` magics, whose header omits the weight float type; this
    package reads v2 files only.)
    """
    from . import mfile  # lazy: mfile imports this module for ArtifactError

    path = os.fspath(path)
    size = os.path.getsize(path)
    man = {
        "format": MANIFEST_FORMAT,
        "version": MANIFEST_VERSION,
        "algorithm": "crc32",
        "file": os.path.basename(path),
        "file_size": size,
        "tensors": {},
    }
    with open(path, "rb") as f:
        magic_bytes = f.read(4)
    magic = int.from_bytes(magic_bytes, "little", signed=True) \
        if len(magic_bytes) == 4 else None
    if magic == mfile.MAGIC_V2:
        spec = mfile.read_spec(path)
        man["header"] = {"offset": 0, "nbytes": spec.header_size,
                         "crc32": _file_crc32(path, 0, spec.header_size)}
        for t in mfile.tensor_plan(spec):
            man["tensors"][t.name] = {
                "offset": t.offset, "nbytes": t.nbytes,
                "crc32": _file_crc32(path, t.offset, t.nbytes)}
    else:
        man["header"] = {"offset": 0, "nbytes": size,
                         "crc32": _file_crc32(path, 0, size)}
    return man


def write_manifest(path, manifest_path=None) -> str:
    """Build and write the sidecar manifest for ``path``; returns its path."""
    mp = manifest_path or manifest_path_for(path)
    man = build_manifest(path)
    tmp = mp + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(man, f, indent=1, sort_keys=True)
        f.write("\n")
    os.replace(tmp, mp)
    return mp


def load_manifest(manifest_path) -> dict:
    """Load + validate a manifest file; raises ArtifactError when it is
    itself corrupt (a manifest that cannot be trusted must not silently
    disable verification)."""
    try:
        with open(manifest_path, "r", encoding="utf-8") as f:
            man = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        raise ArtifactError(manifest_path, "manifest",
                            f"unreadable manifest: {e}") from e
    if not isinstance(man, dict) or man.get("format") != MANIFEST_FORMAT:
        raise ArtifactError(manifest_path, "manifest.format",
                            "not a dllama checksum manifest",
                            expected=MANIFEST_FORMAT,
                            got=man.get("format") if isinstance(man, dict) else type(man).__name__)
    if man.get("version") != MANIFEST_VERSION:
        raise ArtifactError(manifest_path, "manifest.version",
                            "unsupported manifest version",
                            expected=MANIFEST_VERSION, got=man.get("version"))
    if man.get("algorithm") != "crc32":
        raise ArtifactError(manifest_path, "manifest.algorithm",
                            "unsupported digest algorithm",
                            expected="crc32", got=man.get("algorithm"))
    for key in ("file_size", "header", "tensors"):
        if key not in man:
            raise ArtifactError(manifest_path, f"manifest.{key}",
                                "missing required manifest key")
    return man


def load_manifest_for(artifact_path) -> dict | None:
    """The artifact's sidecar manifest, or None when none exists."""
    mp = manifest_path_for(artifact_path)
    if not os.path.exists(mp):
        return None
    return load_manifest(mp)


def verify_bytes(entry: dict, data, path, field: str) -> None:
    """Verify a byte region against its manifest entry (crc32 + length).

    Bumps the process-global counters; raises :class:`ArtifactError`
    naming the region's file offset on any mismatch.
    """
    nbytes = memoryview(data).cast("B").nbytes
    if nbytes != entry["nbytes"]:
        bump_counter("checksum_failures")
        raise ArtifactError(path, field, "region size mismatch vs manifest",
                            offset=entry["offset"],
                            expected=entry["nbytes"], got=nbytes)
    got = digest(data)
    if got != entry["crc32"]:
        bump_counter("checksum_failures")
        raise ArtifactError(
            path, field, "checksum mismatch — artifact bytes are corrupt",
            offset=entry["offset"],
            expected=f"crc32={entry['crc32']:#010x}", got=f"crc32={got:#010x}")
    bump_counter("checksum_verified")


def verify_file(path, manifest: dict | None = None) -> int:
    """Fully verify an artifact against its manifest (every region).

    Returns the number of regions verified; raises ArtifactError on the
    first mismatch.  This is the eager path of ``python -m
    dllama_tpu_torch.io.integrity verify``; ``MFile`` verifies the same regions lazily instead.
    """
    man = manifest if manifest is not None else load_manifest(manifest_path_for(path))
    size = os.path.getsize(path)
    if size != man["file_size"]:
        bump_counter("checksum_failures")
        raise ArtifactError(path, "file size", "size mismatch vs manifest",
                            expected=man["file_size"], got=size)
    regions = [("header", man["header"])]
    regions += [(f"tensor {name!r}", ent)
                for name, ent in man["tensors"].items()]
    for field, ent in regions:
        got = _file_crc32(path, ent["offset"], ent["nbytes"])
        if got != ent["crc32"]:
            bump_counter("checksum_failures")
            raise ArtifactError(
                path, field, "checksum mismatch — artifact bytes are corrupt",
                offset=ent["offset"],
                expected=f"crc32={ent['crc32']:#010x}", got=f"crc32={got:#010x}")
        bump_counter("checksum_verified")
    return len(regions)


def main(argv=None) -> int:
    """``write PATH...`` builds each artifact's sidecar manifest;
    ``verify PATH...`` checks every region of each against its own."""
    import argparse
    p = argparse.ArgumentParser(prog="python -m dllama_tpu_torch.io.integrity",
                                description="write or verify checksum manifests")
    p.add_argument("command", choices=("write", "verify"))
    p.add_argument("paths", nargs="+")
    args = p.parse_args(argv)
    for path in args.paths:
        if args.command == "write":
            print(f"wrote {write_manifest(path)}")
        else:
            print(f"{path}: {verify_file(path)} regions verified")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
