"""Generation-stream consumption for the API server's mutex path — a
copy of ``dllama_tpu/runtime/stream.py`` with the standard ``logging``
module in place of ``obs.log``.

One state machine: prompt-echo skip, EOS/stop-string detection with
held-back partial matches, end-of-budget flush, KV overshoot rewind.  The
pos-rewind arithmetic interacts with ``Engine.generate_stream``'s own
eos-id rewind and the on-device chunk overshoot.
"""

from __future__ import annotations

import logging
from typing import Callable

from ..tokenizer.eos import EOS, MAYBE_EOS, EosDetector

_log = logging.getLogger("dllama_tpu_torch.runtime.stream")


def drain_generation(engine, tokenizer, detector: EosDetector, stream,
                     n_prompt: int, prompt_end: int,
                     on_delta: Callable[[str], None]) -> tuple[str, int, bool]:
    """Consume ``stream`` (an Engine.generate_stream iterator), calling
    ``on_delta(text)`` as text becomes safe to emit.

    Returns ``(reply, n_completion, ended_by_eos)``.  On return,
    ``engine.pos`` has been rewound past any chunk-overshoot tokens that
    were sampled after a stop string — they were never part of the reply
    and must not condition later turns.
    """
    content: list[str] = []
    prev = tokenizer.bos_id
    n_completion = 0
    ended_by_eos = False
    for i, (token, _) in enumerate(stream):
        if i < n_prompt:  # prompt tokens are echoed first (engine contract)
            prev = token
            continue
        n_completion += 1
        # Per-piece decode, NOT an incremental UTF-8 decoder: the
        # EosDetector's stop arithmetic is character-position-based per
        # piece, and a decoder that carries dangling bytes into the next
        # piece shifts those positions (an eos piece would swallow the
        # carried replacement char; a stop piece's trailing fragment would
        # flush AFTER the truncation point).  The cost is cosmetic: a
        # codepoint split across byte-fallback tokens renders as one
        # U+FFFD per fragment here.  The batched completions stream
        # (server/api.py complete_batch_stream) reassembles those — its
        # stop logic is buffer-based, so the carry is safe there.
        piece = tokenizer.decode_piece(prev, token).decode("utf-8", errors="replace")
        prev = token
        res = detector.append(token, piece)
        if res == MAYBE_EOS:
            continue  # hold back a potential partial stop-string match
        delta = detector.get_delta()
        if delta:
            content.append(delta)
            on_delta(delta)
        detector.clear()
        if res == EOS:
            ended_by_eos = True
            break
    if not ended_by_eos:
        # budget exhausted with a partial stop-string match held back —
        # it was real text, flush it
        delta = detector.get_delta()
        if delta:
            content.append(delta)
            on_delta(delta)
    # One position convention for every stop kind (ADVICE r01): the last
    # consumed token — eos id, stop-string tail, or the final budgeted
    # token — was sampled but never fed to the model, so the cache holds
    # prompt + (n_completion − 1) positions.  The engine's internal eos-id
    # rewind and the natural end-of-stream accounting already land there;
    # this clamp brings the abandoned-mid-chunk (stop-string) case in line.
    engine.pos = min(engine.pos, prompt_end + max(n_completion - 1, 0))
    _log.info("decode: n_prompt=%d n_completion=%d ended_by_eos=%s pos=%d",
              n_prompt, n_completion, ended_by_eos, engine.pos)
    return "".join(content), n_completion, ended_by_eos
