"""Sentencepiece-style greedy BPE tokenizer.

A copy of ``dllama_tpu/tokenizer/bpe.py`` with the pure-Python merge only
(the native merge engine is not carried):

* encode: optional BOS, a dummy-prefix space token (when the vocab has one),
  UTF-8 codepoint chunking with byte fallback (``byte + 3``), then repeated
  highest-score pair merges (best score wins, earliest position on ties),
  run in O(n log n) with a lazy heap over a doubly-linked list.
* decode: piece lookup, with ``<0xNN>`` raw-byte pieces mapped back to single
  bytes, and the leading space stripped from the piece that follows BOS.
"""

from __future__ import annotations

import heapq
import re

from ..io.tfile import TokenizerData

_BYTE_PIECE_RE = re.compile(rb"^<0x([0-9A-Fa-f]{2})>$")


class Tokenizer:
    def __init__(self, data: TokenizerData):
        self.data = data
        self.vocab: list[bytes] = data.vocab
        self.scores: list[float] = data.scores
        self.bos_id = data.bos_id
        self.eos_id = data.eos_id
        self.vocab_size = data.vocab_size
        self._index: dict[bytes, int] = {}
        # first occurrence wins, matching a binary search over a vocab
        # sorted with duplicate strings
        for i, piece in enumerate(self.vocab):
            self._index.setdefault(piece, i)

    def lookup(self, piece: bytes) -> int:
        return self._index.get(piece, -1)

    def encode(self, text: str | bytes, add_bos: bool = True, add_eos: bool = False) -> list[int]:
        raw = text.encode("utf-8") if isinstance(text, str) else text
        tokens: list[int] = []
        if add_bos and self.bos_id >= 0:
            tokens.append(self.bos_id)
        if raw:  # dummy prefix (sentencepiece add_dummy_prefix)
            dummy = self.lookup(b" ")
            if dummy != -1:
                tokens.append(dummy)
        i = 0
        n = len(raw)
        while i < n:
            j = i + 1
            # absorb continuation bytes (10xxxxxx), at most 3 (cp length ≤ 4)
            while j < n and (raw[j] & 0xC0) == 0x80 and (j - i) < 4:
                j += 1
            chunk = raw[i:j]
            tid = self.lookup(chunk)
            if tid != -1:
                tokens.append(tid)
            else:
                # byte fallback: vocab ids 3.. are the raw bytes; <unk> (id
                # 0) when the vocab has no byte pieces
                tokens.extend(b + 3 if b + 3 < len(self.vocab) else 0
                              for b in chunk)
            i = j
        tokens = self._merge(tokens)
        if add_eos and self.eos_id >= 0:
            tokens.append(self.eos_id)
        return tokens

    def _merge(self, tokens: list[int]) -> list[int]:
        """Greedy best-pair merges, reference-identical order."""
        n = len(tokens)
        if n < 2:
            return tokens
        ids = list(tokens)
        nxt = list(range(1, n)) + [-1]
        prv = [-1] + list(range(n - 1))
        alive = [True] * n
        index = self._index
        vocab = self.vocab
        scores = self.scores
        heap: list[tuple[float, int, int, int, int, int]] = []

        def push(a: int, b: int):
            if a < 0 or b < 0:
                return
            mid = index.get(vocab[ids[a]] + vocab[ids[b]], -1)
            # the strict > -1e10 keeps parity for sentinel/-inf scores
            if mid != -1 and scores[mid] > -1e10:
                # (-score, left position, expected ids, merged id): list
                # positions never reorder, so the original index gives the
                # earliest-position tie-break
                heapq.heappush(heap, (-scores[mid], a, ids[a], ids[b], b, mid))

        for k in range(n - 1):
            push(k, k + 1)
        while heap:
            _, a, ia, ib, b, mid = heapq.heappop(heap)
            if not (alive[a] and alive[b] and nxt[a] == b
                    and ids[a] == ia and ids[b] == ib):
                continue  # stale candidate
            ids[a] = mid
            alive[b] = False
            nxt[a] = nxt[b]
            if nxt[b] != -1:
                prv[nxt[b]] = a
            push(prv[a], a)
            push(a, nxt[a])
        out = []
        k = 0
        while k != -1:
            out.append(ids[k])
            k = nxt[k]
        return out

    def decode_piece(self, prev_token: int, token: int) -> bytes:
        """One token → bytes."""
        piece = self.vocab[token]
        if prev_token == self.bos_id and piece.startswith(b" "):
            piece = piece[1:]
        m = _BYTE_PIECE_RE.match(piece)
        if m:
            return bytes([int(m.group(1), 16)])
        return piece

    def decode(self, tokens: list[int]) -> str:
        out = bytearray()
        prev = self.bos_id
        for t in tokens:
            if t == self.bos_id:
                prev = t
                continue
            out += self.decode_piece(prev, t)
            prev = t
        return out.decode("utf-8", errors="replace")
