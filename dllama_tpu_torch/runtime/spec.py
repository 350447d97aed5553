"""Per-slot draft proposers for speculative decoding under the slot
scheduler — a copy of ``dllama_tpu/runtime/spec.py``.

Batch-1 prompt lookup (:meth:`Engine.generate_pld`) proposes K tokens,
verifies the window in one T = K + 1 forward and accepts the leading
match, so every emitted token is the model's own greedy token (Leviathan
et al. 2023).  This module is the serving half: a :class:`Proposer` keeps
per-slot draft state for the continuous-batching scheduler
(``runtime/scheduler.py``), which collects proposals after each dispatch
lands and makes the next dispatch a ragged verify step
(:meth:`Engine.slot_verify_async`).

* :class:`PromptLookupProposer` — prompt-lookup decoding: a per-slot
  latest-occurrence n-gram index over prompt and produced tokens, kept
  incrementally at land time.  No model cost; wins on repetitive
  continuations (summaries, code, quoted context).
* :class:`DraftModelProposer` — a second, smaller :class:`Engine` whose
  slot-aligned contiguous KV is kept in sync by replaying accepted
  tokens (``Engine.slot_step``).  Tokens the verifier rejected leave stale
  draft KV above the synced ceiling, masked until real tokens overwrite
  it, so a rejection needs no rollback on either model.

Contract with the scheduler: ``sync`` once a landed dispatch a live decode
slot (idempotent; a ``rid`` change rebuilds from scratch — slot reuse,
hand-off import, un-park), ``propose`` with the slots wanting drafts this
round, ``reset`` at every flush point (retire, cancel, preemption park,
hand-off export).  Wrong or absent drafts merely verify short: the
emitted stream is the model's greedy output either way.

Left out of the copy: the JAX package's ``spec.propose`` fault point and
its reject-storm drill (``runtime/faults.py`` is not ported);
:meth:`Proposer._storm` passes proposals unchanged.
"""

from __future__ import annotations

import numpy as np

# pre-feed width for draft-model catch-up (prompt replay, resumed
# requests): bounded so the drafting dispatch rides a handful of
# power-of-two compile shapes, like the scheduler's prefill chunks
_DRAFT_CHUNK = 32


class Proposer:
    """Per-slot draft state + proposal generation; see module docstring.

    Subclasses keep whatever per-slot state they need in
    ``self._states`` keyed by slot index and implement
    :meth:`_propose_one` / :meth:`propose`.
    """

    #: label for metrics (``sched_spec_accepted_total{proposer=...}``)
    name = "base"

    def __init__(self, vocab: int):
        self.vocab = max(2, int(vocab))
        self._states: dict[int, object] = {}

    # -- scheduler-facing API ------------------------------------------
    def sync(self, slot: int, rid: str, prompt: list[int],
             emitted: list[int]) -> None:
        """Bring slot ``slot``'s state up to date with the request's
        full sequence (prompt + emitted completion).  Called at land
        time with the freshly fanned-out tokens appended; a ``rid``
        change (slot reuse, import, resume) rebuilds from scratch."""
        raise NotImplementedError

    def propose(self, want: dict[int, int]) -> dict[int, list[int]]:
        """Return up to ``want[slot]`` draft tokens per requested slot.
        Slots may be omitted from the result (no candidate continuation
        is a valid answer — the row decodes normally)."""
        raise NotImplementedError

    def reset(self, slot: int) -> None:
        """Drop slot ``slot``'s state (flush point: retire, cancel,
        park, export).  In-flight drafts die here — they are never
        exported and never outlive the request that seeded them."""
        self._states.pop(slot, None)

    def reset_all(self) -> None:
        self._states.clear()

    def _storm(self, want: dict[int, int],
               props: dict[int, list[int]]) -> dict[int, list[int]]:
        """Where the JAX package fires its ``spec.propose`` fault point (the
        reject-storm drill's ``corrupt`` action).  The port has no fault
        points yet (``runtime/faults.py`` is not ported): the proposals
        pass unchanged."""
        return props


class _PLDState:
    __slots__ = ("rid", "seq", "n_prompt", "index", "indexed")

    def __init__(self, rid, seq, n_prompt, ngram):
        self.rid = rid
        self.seq = seq                 # prompt + emitted, grown in place
        self.n_prompt = n_prompt
        self.index: dict[tuple, int] = {}  # ngram -> position AFTER match
        self.indexed = ngram - 1


class PromptLookupProposer(Proposer):
    """Prompt-lookup drafts: the continuation after the latest earlier
    occurrence of the current ``ngram``-suffix in this slot's own
    sequence.  Same index discipline as ``generate_pld_stream`` — only
    positions ``<= len(seq) - 1`` are indexed, so a lookup never matches
    the suffix against itself."""

    name = "pld"

    def __init__(self, *, ngram: int = 2, vocab: int = 1 << 30):
        super().__init__(vocab)
        self.ngram = max(1, int(ngram))

    def sync(self, slot, rid, prompt, emitted):
        st = self._states.get(slot)
        if st is None or st.rid != rid:
            self._states[slot] = _PLDState(rid, list(prompt) + list(emitted),
                                           len(prompt), self.ngram)
            return
        st.seq.extend(emitted[len(st.seq) - st.n_prompt:])

    def _extend_index(self, st: _PLDState) -> None:
        hi = len(st.seq) - 1
        for p in range(max(st.indexed + 1, self.ngram), hi + 1):
            st.index[tuple(st.seq[p - self.ngram:p])] = p
        st.indexed = max(st.indexed, hi)

    def propose(self, want):
        props: dict[int, list[int]] = {}
        for slot, k in want.items():
            st = self._states.get(slot)
            if st is None or len(st.seq) <= self.ngram or k < 1:
                continue
            self._extend_index(st)
            i = st.index.get(tuple(st.seq[-self.ngram:]))
            if i is None:
                continue
            cand = st.seq[i:i + k]
            if cand:
                props[slot] = [int(t) for t in cand]
        return self._storm(want, props)


class _DraftState:
    __slots__ = ("rid", "seq", "n_prompt", "synced", "fed", "drafted")

    def __init__(self, rid, seq, n_prompt):
        self.rid = rid
        self.seq = seq
        self.n_prompt = n_prompt
        self.synced = 0     # seq tokens whose draft KV is valid
        self.fed = 0        # seq tokens the last drafting forward consumed
        self.drafted: list[int] = []  # tokens drafted by that forward


class DraftModelProposer(Proposer):
    """Drafts from a second, smaller engine sharing the target's slot
    geometry (same ``batch``; contiguous KV — the draft pool is tiny).

    Sync-by-replay: each slot tracks ``synced``, the count of sequence
    tokens whose draft KV is valid.  At propose time the unsynced delta
    (accepted tokens the draft has not consumed — after admission, the
    whole prompt) is fed through the draft in one ragged slot dispatch,
    then ``k`` greedy draft steps run on device.  Draft tokens the
    verifier later rejects leave stale draft KV above ``synced`` —
    masked by the causal ceiling exactly like target-side rejection, so
    a miss costs nothing to undo on either model.  Rows whose delta
    cannot fit the draft context stop proposing (and re-ride as inert
    neighbors); everyone else drafts in the same batched dispatch."""

    name = "draft"

    def __init__(self, engine):
        super().__init__(engine.cfg.vocab_size)
        if getattr(engine, "paged", False):
            raise ValueError("draft engine must be contiguous (the draft "
                             "KV pool is slot-aligned, not paged)")
        self.engine = engine

    def sync(self, slot, rid, prompt, emitted):
        st = self._states.get(slot)
        if st is None or st.rid != rid:
            self._states[slot] = _DraftState(
                rid, list(prompt) + list(emitted), len(prompt))
            return
        new = emitted[len(st.seq) - st.n_prompt:]
        st.seq.extend(new)
        if st.drafted:
            # the drafting forward wrote KV for drafted[:-1] (the last
            # draft was sampled but never fed back); credit the leading
            # drafts the verifier actually kept
            m = 0
            while m < len(new) and m < len(st.drafted) \
                    and new[m] == st.drafted[m]:
                m += 1
            st.synced = st.fed + min(m, len(st.drafted) - 1)
            st.drafted = []

    def propose(self, want):
        eng = self.engine
        b, L = eng.batch, eng.seq_len
        rows = []  # (slot, state, delta, k)
        for slot, k in sorted(want.items()):
            st = self._states.get(slot)
            if st is None or k < 1 or slot >= b:
                continue
            delta = st.seq[st.synced:]
            # conservative room check: delta feed (+ bucket padding) and
            # the k draft steps must all fit the draft context
            if not delta \
                    or st.synced + len(delta) + k + _DRAFT_CHUNK > L:
                continue
            rows.append((slot, st, delta, k))
        if not rows:
            return self._storm(want, {})
        k = max(r[3] for r in rows)
        temps = np.zeros((b,), np.float32)
        topps = np.full((b,), 0.9, np.float32)

        def base_rows(t):
            """Ride-along positions for rows not fed this dispatch:
            each live draft row parks at its own ceiling (garbage
            written above ``synced`` is overwritten before it is ever
            attendable — the slot-reuse invariant); a row too close to
            the context edge abandons its draft state instead."""
            pos = np.zeros((b,), np.int32)
            for s, st in list(self._states.items()):
                if s >= b:
                    continue
                if st.synced + t > L:
                    st.synced, st.fed, st.drafted = 0, 0, []
                pos[s] = st.synced
            return pos

        off = {slot: 0 for slot, *_ in rows}
        # pre-feed long deltas (prompt replay / resume catch-up) in
        # fixed-width chunks, always leaving >= 1 token so the drafting
        # dispatch below has a window to sample from
        while max(len(d) - off[s] for s, _, d, _ in rows) > _DRAFT_CHUNK:
            t = _DRAFT_CHUNK
            tokens = np.zeros((b, t), np.int32)
            nv = np.ones((b,), np.int32)
            pos = base_rows(t)
            for slot, st, delta, _ in rows:
                c = min(t, len(delta) - off[slot] - 1)
                if c < 1:
                    # done pre-feeding: park at the frontier, not at
                    # ``synced`` (the JAX package parks it there, and the
                    # ride-along window's garbage then overwrites the
                    # tokens this catch-up already fed)
                    pos[slot] = st.synced + off[slot]
                    continue
                tokens[slot, :c] = delta[off[slot]:off[slot] + c]
                nv[slot] = c
                pos[slot] = st.synced + off[slot]
                off[slot] += c
            eng.slot_step(tokens, pos, nv, temps_np=temps, topps_np=topps,
                          steps=1)
        rem = {s: len(d) - off[s] for s, _, d, _ in rows}
        t = 1 << max(0, max(rem.values()) - 1).bit_length()
        tokens = np.zeros((b, t), np.int32)
        nv = np.ones((b,), np.int32)
        pos = base_rows(t)
        for slot, st, delta, _ in rows:
            tokens[slot, :rem[slot]] = delta[off[slot]:]
            nv[slot] = rem[slot]
            pos[slot] = st.synced + off[slot]
        toks = eng.slot_step(tokens, pos, nv, temps_np=temps,
                             topps_np=topps, steps=k)  # (k, b)
        props: dict[int, list[int]] = {}
        for slot, st, delta, kw in rows:
            drafts = [int(toks[j, slot]) for j in range(k)]
            st.fed = st.synced + len(delta)
            st.drafted = drafts
            props[slot] = drafts[:kw]
        return self._storm(want, props)


def make_proposer(mode: str, engine, draft_engine=None) -> Proposer | None:
    """Build the proposer for ``--spec``: ``off`` → None, ``pld`` →
    prompt lookup over the target's vocab, ``draft`` → draft-model
    speculation (requires ``draft_engine``)."""
    if mode in (None, "", "off"):
        return None
    if mode == "pld":
        return PromptLookupProposer(vocab=engine.cfg.vocab_size)
    if mode == "draft":
        if draft_engine is None:
            raise ValueError("--spec draft needs --draft-model")
        return DraftModelProposer(draft_engine)
    raise ValueError(f"unknown speculation mode {mode!r}")
