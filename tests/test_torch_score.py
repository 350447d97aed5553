"""``Engine.score_batch`` of the port (the teacher-forced forward behind the
API's ``logprobs`` and ``echo``) against the JAX package's on the same
Q40 and Q80 files, B in {1, 3}, ``top_k`` in {0, 5}, and at tp = 2.

Tolerances: ``token_lp`` on the real columns (row r's last len(seq_r) - 1
columns) within ``LP_TOL`` = 1e-3 nats: the f32 logits agree within 1e-4
of max|logits| (tests/test_torch_model.py) and a log-prob subtracts a
logsumexp from one of them.  The top-k log-probs likewise; their ids are
equal at every rank but the last whose margin to its neighbours exceeds
twice the largest log-prob difference (ties may order either way; the
last rank's margin to the next id is not returned).  Refusals raise
the JAX package's exception types.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dllama_tpu import quants
from dllama_tpu.io import mfile as jmfile
from dllama_tpu.models import params as jparams
from dllama_tpu.parallel.mesh import make_mesh as jmake_mesh
from dllama_tpu.runtime.engine import ContextOverflow as JOverflow, Engine as JEngine
from dllama_tpu_torch.io import mfile as tmfile
from dllama_tpu_torch.models import params as tparams
from dllama_tpu_torch.parallel.mesh import make_mesh
from dllama_tpu_torch.runtime.engine import ContextOverflow, Engine
from fixtures import write_tiny_model
from test_torch_tp import KW, _model, _to_jax

LP_TOL = 1e-3
SEQS = [[1, 5, 9, 2, 7, 3, 11, 4, 4, 8], [1, 4], [1, 8, 6, 10, 12]]


@pytest.fixture(scope="module", params=["q40", "q80"])
def file_model(request, tmp_path_factory):
    path = tmp_path_factory.mktemp(request.param) / "tiny.m"
    write_tiny_model(path, vocab_size=128, seq_len=64,
                     ftype=quants.Q40 if request.param == "q40" else quants.Q80)
    jcfg, jp = jparams.load_params(jmfile.MFile(str(path)), keep_quantized=True,
                                   dtype=jnp.float32)
    with tmfile.MFile(str(path)) as mf:
        tcfg, tp = tparams.load_params(mf)
    return jcfg, jp, tcfg, tp


def _check(got, want, seqs, top_k):
    tok_lp, ti, tl = got
    ref_lp, ref_ti, ref_tl = want
    assert tok_lp.shape == ref_lp.shape
    width = tok_lp.shape[1]
    err = 0.0
    for r, s in enumerate(seqs):
        cols = slice(width - len(s), width - 1)  # the real next-token columns
        np.testing.assert_allclose(tok_lp[r, cols], ref_lp[r, cols], rtol=0, atol=LP_TOL)
        assert np.all(np.isfinite(tok_lp[r, cols])) and np.all(tok_lp[r, cols] <= 0)
        if top_k:
            np.testing.assert_allclose(tl[r, cols], ref_tl[r, cols], rtol=0, atol=LP_TOL)
            err = max(err, float(np.abs(tl[r, cols] - ref_tl[r, cols]).max()))
    if not top_k:
        assert ti is None and tl is None and ref_ti is None
        return
    assert ti.dtype == np.int32 and ti.shape == ref_ti.shape == tok_lp.shape + (top_k,)
    decided = 0
    for r, s in enumerate(seqs):
        for c in range(width - len(s), width - 1):
            v = ref_tl[r, c]
            # the last rank's margin to the next id is unknown: never decided
            for i in range(top_k - 1):
                above = i == 0 or v[i - 1] - v[i] > 2 * err
                if above and v[i] - v[i + 1] > 2 * err:
                    assert ti[r, c, i] == ref_ti[r, c, i], (r, c, i)
                    decided += 1
    assert decided > 0


@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("top_k", [0, 5])
def test_score_batch_matches_jax(file_model, b, top_k):
    jcfg, jp, tcfg, tp = file_model
    seqs = SEQS[:b]
    je = JEngine(jcfg, jp, mesh=jmake_mesh(tp=1, devices=jax.devices()[:1]), batch=b)
    te = Engine(tcfg, tp, device="cpu", batch=b)
    want = je.score_batch(seqs, top_k=top_k)
    pos = te.pos
    got = te.score_batch(seqs, top_k=top_k)
    _check(got, want, seqs, top_k)
    assert te.pos == pos  # the engine's own cache and clock are untouched


@pytest.mark.parametrize("codec", ["q40", "q80"])
def test_score_batch_matches_jax_at_tp2(codec):
    """At tp = 2 the scoring forward runs the TP walk and the vocab-sliced
    head gathered on rank 0 (``_head_tp``)."""
    tcfg, jcfg, p = _model(KW, codec)
    seqs = [[3, 14, 15, 92, 6, 5, 35], [3, 9]]
    je = JEngine(jcfg, _to_jax(p), mesh=jmake_mesh(tp=2), batch=2)
    te = Engine(tcfg, p, device="cpu", mesh=make_mesh(2, "cpu"), batch=2)
    _check(te.score_batch(seqs, top_k=5), je.score_batch(seqs, top_k=5), seqs, 5)


def test_refusals_match_jax(file_model):
    """What JAX refuses, the port refuses with the same type: a wrong
    sequence count, fewer than 2 tokens, a sequence past seq_len, and a
    paged engine."""
    jcfg, jp, tcfg, tp = file_model
    mesh = jmake_mesh(tp=1, devices=jax.devices()[:1])
    je = JEngine(jcfg, jp, mesh=mesh, batch=2)
    te = Engine(tcfg, tp, device="cpu", batch=2)
    for seqs, exc, texc, match in (
            ([[1, 2]], ValueError, ValueError, "sequences for batch"),
            ([[1, 2], [3]], ValueError, ValueError, "2 tokens"),
            ([[1, 2], [1] * 65], JOverflow, ContextOverflow, "exceeds seq_len")):
        with pytest.raises(exc, match=match):
            je.score_batch(seqs)
        with pytest.raises(texc, match=match):
            te.score_batch(seqs)
    jpaged = JEngine(jcfg, jp, mesh=mesh, batch=2, kv_pages=40, kv_page_size=4)
    tpaged = Engine(tcfg, tp, device="cpu", batch=2, kv_pages=40, kv_page_size=4)
    for eng in (jpaged, tpaged):
        with pytest.raises(ValueError, match="paged engine is slot-only"):
            eng.score_batch([[1, 2], [3, 4]])


def test_int8_engine_scores_on_a_dense_scratch(file_model):
    """An engine with the contiguous int8 cache scores as the JAX package's
    does: on a scratch cache of the activation dtype."""
    jcfg, jp, tcfg, tp = file_model
    seqs = SEQS[:2]
    je = JEngine(jcfg, jp, mesh=jmake_mesh(tp=1, devices=jax.devices()[:1]), batch=2,
                 kv_dtype="q8")
    te = Engine(tcfg, tp, device="cpu", batch=2, kv_dtype="q8")
    _check(te.score_batch(seqs, top_k=5), je.score_batch(seqs, top_k=5), seqs, 5)
