"""Streaming stop-sequence detector — a copy of ``dllama_tpu/tokenizer/eos.py``.

Behavior-compatible with the reference ``EosDetector``
(the reference's src/tokenizer.cpp:475-547): pieces are appended to a buffer;
the detector reports ``EOS`` (hard stop: EOS token id or a full stop-string
match), ``MAYBE_EOS`` (the buffer is a prefix of a stop string — hold the
text back), or ``NOT_EOS``.  ``padding_left``/``padding_right`` tolerate up
to that many junk characters before/after the stop string.  ``get_delta()``
returns the text that is safe to emit (``None`` if nothing).
"""

from __future__ import annotations

MAYBE_EOS = 0
EOS = 1
NOT_EOS = 2


class EosDetector:
    def __init__(self, eos_id: int, stops: list[str], padding_left: int = 0, padding_right: int = 0):
        self.eos_id = eos_id
        self.stops = stops
        self.padding_left = padding_left
        self.padding_right = padding_right
        self.buffer = ""
        self.eos_pos = -1

    def append(self, token_id: int, piece: str) -> int:
        piece_len = len(piece)
        self.buffer += piece
        pos = len(self.buffer)

        if token_id == self.eos_id:
            self.eos_pos = pos - piece_len
            return EOS
        self.eos_pos = -1

        for stop in self.stops:
            stop_size = len(stop)
            # too much accumulated text to still be (padded) stop string
            if pos > stop_size + self.padding_left + self.padding_right:
                continue
            for lo in range(self.padding_left + 1):
                n = pos - lo
                if n == 0 or n > stop_size + self.padding_right:
                    continue
                n = min(n, stop_size)
                if self.buffer[lo: lo + n] == stop[:n]:
                    if n == stop_size:
                        self.eos_pos = lo
                        return EOS
                    return MAYBE_EOS
        return NOT_EOS

    def get_delta(self) -> str | None:
        if self.eos_pos == -1:
            return self.buffer if self.buffer else None
        if self.eos_pos == 0:
            return None
        return self.buffer[: self.eos_pos]

    def clear(self):
        self.buffer = ""
