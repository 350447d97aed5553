"""`.t` tokenizer-file format: reader + writer.

A copy of ``dllama_tpu/io/tfile.py`` without the checksum-manifest check:

* magic ``0x567124`` (v1) — i32 ``headerSize`` (total incl. magic+size),
  (key, value) i32 pairs; ``CHAT_TEMPLATE``/``CHAT_STOP`` values are byte
  lengths of strings that directly follow the header.
* magic ``0x567123`` (legacy) — fixed header
  ``{vocabSize, maxTokenLength, bosId, eosId, padId}``.
* vocab body: per token, f32 score + i32 length + raw bytes.
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass, field

from .mfile import ArtifactError, _read_exact

MAGIC_V1 = 0x567124
MAGIC_LEGACY = 0x567123

_MAX_VOCAB = 1 << 24
_MAX_TOKEN_BYTES = 1 << 16
_MAX_STR_BYTES = 1 << 20

TOK_VERSION = 0
TOK_VOCAB_SIZE = 1
MAX_TOKEN_LENGTH = 2
BOS_ID = 3
EOS_ID = 4
PAD_ID = 5
CHAT_EOS_ID = 6
CHAT_TEMPLATE = 7
CHAT_STOP = 8


@dataclass
class TokenizerData:
    vocab: list[bytes] = field(default_factory=list)
    scores: list[float] = field(default_factory=list)
    max_token_length: int = 0
    bos_id: int = -1
    eos_id: int = -1
    chat_eos_id: int = -1
    chat_template: str | None = None
    chat_stop: str | None = None

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)


def read_tfile(path: str | os.PathLike) -> TokenizerData:
    """Parse + validate a `.t` tokenizer file: every read is length-checked,
    every declared length is range-checked and trailing bytes are rejected,
    each violation raising :class:`ArtifactError`."""
    path = os.fspath(path)
    file_size = os.path.getsize(path)
    t = TokenizerData()
    with open(path, "rb") as f:
        raw, _ = _read_exact(f, 4, path, "magic")
        (magic,) = struct.unpack("<i", raw)
        if magic == MAGIC_LEGACY:
            raw, _ = _read_exact(f, 8, path, "legacy header")
            vocab_size, t.max_token_length = struct.unpack("<II", raw)
            raw, _ = _read_exact(f, 12, path, "legacy header ids")
            t.bos_id, t.eos_id, _pad = struct.unpack("<iii", raw)
        elif magic == MAGIC_V1:
            raw, off = _read_exact(f, 4, path, "headerSize")
            (header_size,) = struct.unpack("<i", raw)
            if header_size < 8 or (header_size - 8) % 8:
                raise ArtifactError(
                    path, "headerSize",
                    "must be 8 + a whole number of (key, value) i32 pairs",
                    offset=off, expected="8 + 8k", got=header_size)
            if header_size > file_size:
                raise ArtifactError(path, "headerSize",
                                    "header extends past end of file",
                                    offset=off, expected=f"<= {file_size}",
                                    got=header_size)
            body, body_off = _read_exact(f, header_size - 8, path, "header body")
            kv = struct.unpack(f"<{len(body) // 4}i", body)
            version = -1
            vocab_size = 0
            template_len = stop_len = 0
            for i, (k, v) in enumerate(zip(kv[::2], kv[1::2])):
                if k == TOK_VERSION:
                    version = v
                elif k == TOK_VOCAB_SIZE:
                    vocab_size = v
                elif k == MAX_TOKEN_LENGTH:
                    t.max_token_length = v
                elif k == BOS_ID:
                    t.bos_id = v
                elif k == EOS_ID:
                    t.eos_id = v
                elif k == CHAT_EOS_ID:
                    t.chat_eos_id = v
                elif k == CHAT_TEMPLATE:
                    template_len = v
                elif k == CHAT_STOP:
                    stop_len = v
                elif k != PAD_ID:  # the pad id is ignored
                    raise ArtifactError(path, "header key",
                                        "invalid tokenizer header key",
                                        offset=body_off + 8 * i,
                                        expected=f"0..{CHAT_STOP}", got=k)
            if version != 1:
                raise ArtifactError(path, "header field version",
                                    "old tokenizer version, please regenerate",
                                    expected=1, got=version)
            for field_name, v in (("chat_template length", template_len),
                                  ("chat_stop length", stop_len)):
                if not (0 <= v <= _MAX_STR_BYTES):
                    raise ArtifactError(path, f"header field {field_name}",
                                        "value out of range — corrupt header",
                                        expected=f"0..{_MAX_STR_BYTES}", got=v)
            if template_len > 0:
                raw, _ = _read_exact(f, template_len, path, "chat_template")
                t.chat_template = raw.decode("utf-8", errors="replace")
            if stop_len > 0:
                raw, _ = _read_exact(f, stop_len, path, "chat_stop")
                t.chat_stop = raw.decode("utf-8", errors="replace")
        else:
            raise ArtifactError(path, "magic", "invalid tokenizer file magic",
                                offset=0,
                                expected=[hex(MAGIC_V1), hex(MAGIC_LEGACY)],
                                got=hex(magic & 0xFFFFFFFF))

        if not (0 <= vocab_size <= _MAX_VOCAB):
            raise ArtifactError(path, "header field vocab_size",
                                "value out of range — corrupt header",
                                expected=f"0..{_MAX_VOCAB}", got=vocab_size)
        if not (0 <= t.max_token_length <= _MAX_TOKEN_BYTES):
            raise ArtifactError(path, "header field max_token_length",
                                "value out of range — corrupt header",
                                expected=f"0..{_MAX_TOKEN_BYTES}",
                                got=t.max_token_length)
        for i in range(vocab_size):
            raw, off = _read_exact(f, 8, path, f"vocab[{i}] score+length")
            score, length = struct.unpack("<fi", raw)
            if not (0 <= length <= _MAX_TOKEN_BYTES):
                raise ArtifactError(path, f"vocab[{i}] length",
                                    "token length out of range — corrupt vocab",
                                    offset=off + 4,
                                    expected=f"0..{_MAX_TOKEN_BYTES}", got=length)
            piece, _ = _read_exact(f, length, path, f"vocab[{i}] bytes")
            t.scores.append(score)
            t.vocab.append(piece)
        if f.read(1):
            raise ArtifactError(path, "end of file",
                                "trailing bytes after vocab — corrupt or "
                                "mis-sized file", offset=f.tell() - 1,
                                expected="EOF",
                                got=f"{file_size - f.tell() + 1} extra bytes")
    return t


def write_tfile(path: str | os.PathLike, t: TokenizerData) -> None:
    template = t.chat_template.encode("utf-8") if t.chat_template else b""
    stop = t.chat_stop.encode("utf-8") if t.chat_stop else b""
    pairs = [
        (TOK_VERSION, 1),
        (TOK_VOCAB_SIZE, t.vocab_size),
        (MAX_TOKEN_LENGTH, t.max_token_length or max((len(v) for v in t.vocab), default=0)),
        (BOS_ID, t.bos_id),
        (EOS_ID, t.eos_id),
    ]
    if t.chat_eos_id >= 0:
        pairs.append((CHAT_EOS_ID, t.chat_eos_id))
    if template:
        pairs.append((CHAT_TEMPLATE, len(template)))
    if stop:
        pairs.append((CHAT_STOP, len(stop)))
    data = b"".join(struct.pack("<ii", k, v) for k, v in pairs)
    with open(path, "wb") as f:
        f.write(struct.pack("<ii", MAGIC_V1, 8 + len(data)))
        f.write(data)
        f.write(template)
        f.write(stop)
        for score, piece in zip(t.scores, t.vocab):
            f.write(struct.pack("<fi", score, len(piece)))
            f.write(piece)
