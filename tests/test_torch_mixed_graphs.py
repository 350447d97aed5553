"""The mixed slot step (t > 1 tokens a row: prefill chunks beside decode
rows) as the port captures it on the card (``runtime.graphs.mixed_step``,
``DecodeGraphs.mixed``), run eagerly on the CPU (``capture=False``): the
same body, the same static buffers, the same key sequence as on the card.

Held against the port's eager ``decode_loop.slot_chunk`` on the same
weights and inputs, over dispatches of several steps, paged (bf16 and
int8 pools) and contiguous slot rows, greedy and sampled: the ids and the
last logits are equal bit for bit (the body runs the eager dispatch's ops
in its order, on the same CPU kernels).  The key sequence is one ``mixed``
key of the dispatch's width, then ``slot`` keys, and the scheduler's
power-of-two widths reach the body.
"""

import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dllama_tpu.models import config as jconfig, params as jparams
from dllama_tpu.ops import q40 as jq40
from dllama_tpu_torch.models import config as tconfig, params as tparams
from dllama_tpu_torch.runtime import graphs
from dllama_tpu_torch.runtime.engine import Engine
from dllama_tpu_torch.runtime.scheduler import SlotScheduler

PAGE = 4
SEQ = 64
B = 3


@pytest.fixture(scope="module")
def tiny():
    """The 2-layer Q40 model of tests/test_torch_graphs.py (f32
    activations, packed weights from the JAX package's quantizer)."""
    kw = dict(dim=64, hidden_dim=96, n_layers=2, n_heads=4, n_kv_heads=2,
              vocab_size=128, seq_len=SEQ)
    jcfg = jconfig.tiny_config(dtype=jnp.float32, **kw)
    tcfg = tconfig.tiny_config(**kw)
    jp = jparams.quantize_matmuls(jparams.init_params(jcfg, seed=3), jcfg)
    arrays = {k: (np.asarray(v.qpacked), np.asarray(v.scales), v.logical_nd)
              if isinstance(v, jq40.QTensor) else np.asarray(v) for k, v in jp.items()}
    return tcfg, tparams.from_jax_params(arrays, tcfg)


def _engine_kw(layout: str) -> dict:
    if layout == "contiguous":
        return dict(batch=B)
    return dict(batch=B, kv_pages=1 + B * (SEQ // PAGE), kv_page_size=PAGE,
                kv_dtype="q8" if layout == "paged_int8" else None)


def _body_engine(cfg, params, **kw) -> Engine:
    """A CPU engine whose slot dispatches run the graph bodies eagerly."""
    eng = Engine(cfg, params, device="cpu", **kw)
    eng.graphs = graphs.DecodeGraphs(eng.device, capture=False)
    return eng


@pytest.fixture
def keys(monkeypatch):
    """The graph key of every step the body runner takes."""
    seen = []
    real = graphs.DecodeGraphs._step
    monkeypatch.setattr(graphs.DecodeGraphs, "_step",
                        lambda self, key, body: (seen.append(key), real(self, key, body)))
    return seen


def _dispatches(eng, table, temps):
    """Three dispatches: a mixed prefill of width 4 (rows at n_valid 4, 2
    and 1), a mixed step of width 8 with 3 steps (row 0 still prefilling,
    the others decoding their own samples), then a pure-decode burst fed on
    the device.  Returns each dispatch's ids and last logits."""
    topps = np.full(B, 0.9, np.float32)
    rng = np.random.RandomState(4)
    out = []
    pos = np.zeros(B, np.int32)
    tokens = rng.randint(3, 128, (B, 4)).astype(np.int32)
    n_valid = np.array([4, 2, 1], np.int32)
    h = eng.slot_step_async(tokens, pos, n_valid, temps_np=temps, topps_np=topps,
                            steps=1, page_tables_np=table)
    out.append((h.wait(), eng.last_logits))
    pos = pos + n_valid
    tokens = rng.randint(3, 128, (B, 8)).astype(np.int32)
    n_valid = np.array([8, 1, 1], np.int32)
    h = eng.slot_step_async(tokens, pos, n_valid, temps_np=temps, topps_np=topps,
                            steps=3, page_tables_np=table)
    out.append((h.wait(), eng.last_logits))
    pos = pos + n_valid + 2
    h = eng.slot_step_async(None, pos, np.ones(B, np.int32), temps_np=temps,
                            topps_np=topps, steps=2, page_tables_np=table,
                            feed_dev=h.last_dev)
    out.append((h.wait(), eng.last_logits))
    return out


@pytest.mark.parametrize("layout", ["contiguous", "paged", "paged_int8"])
def test_mixed_body_matches_eager_slot_chunk(tiny, keys, layout):
    """Ids and last logits of every dispatch equal the eager engine's bit
    for bit, greedy and with sampled rows (the body draws the eager loop's
    coins from the engine's generator); the steps take one ``mixed`` key a
    mixed dispatch, of its width, then ``slot`` keys."""
    tcfg, tp = tiny
    kw = _engine_kw(layout)
    table = None
    if layout != "contiguous":
        maxp = SEQ // PAGE
        # rows own interleaved pages, so a wrong table index reads a neighbor
        table = (1 + np.arange(B * maxp, dtype=np.int32)).reshape(maxp, B).T.copy()
    for temps in (np.zeros(B, np.float32), np.array([0.0, 0.8, 1.1], np.float32)):
        greedy = not temps.any()
        eager, body = Engine(tcfg, tp, device="cpu", **kw), _body_engine(tcfg, tp, **kw)
        for e in (eager, body):
            e._gen.manual_seed(5)
        keys.clear()
        got = _dispatches(body, table, temps)
        assert keys == [graphs.GraphKey("mixed", B, greedy, 4),
                        graphs.GraphKey("mixed", B, greedy, 8)] + \
            [graphs.GraphKey("slot", B, greedy, 0)] * 4
        want = _dispatches(eager, table, temps)
        for (ids_b, log_b), (ids_e, log_e) in zip(got, want):
            np.testing.assert_array_equal(ids_b, ids_e)
            assert torch.equal(log_b, log_e)
        assert body.graphs.eager_steps == 6 and body.slot_decode_forwards == 4
        assert body.forwards == eager.forwards == 6


def test_scheduler_widths_reach_the_mixed_body(tiny, keys):
    """Prompts of 13, 6 and 3 tokens through the slot scheduler (prefill
    chunk 8) on a body engine: every mixed step's width is a power of two
    from 2 up to the chunk, each a ``mixed`` key, and the greedy streams
    equal the eager engine's under the same scheduler."""
    tcfg, tp = tiny
    prompts = [list(range(3, 16)), [7, 3, 11, 4, 6, 1], [2, 4, 6]]
    streams = []
    for make in (lambda: Engine(tcfg, tp, device="cpu", **_engine_kw("paged")),
                 lambda: _body_engine(tcfg, tp, **_engine_kw("paged"))):
        sched = SlotScheduler(make(), prefill_chunk=8, decode_burst=4)
        out = {}
        try:
            # all three wait in the queue, so the first round admits them together
            with sched.exclusive():
                ts = [threading.Thread(target=lambda p=p: out.__setitem__(
                    tuple(p), list(sched.submit(p, 10, temperature=0.0).tokens())))
                    for p in prompts]
                for th in ts:
                    th.start()
                while sched.occupancy()["queued"] < len(prompts):
                    threading.Event().wait(0.002)
            for th in ts:
                th.join(120)
        finally:
            sched.close()
        streams.append(out)
    assert streams[0] == streams[1] and len(streams[1]) == 3
    widths = sorted({k.walk for k in keys if k.path == "mixed"})
    assert widths and set(widths) <= {2, 4, 8} and 8 in widths
    assert all(k.batch == B and k.greedy for k in keys)
    assert {k.path for k in keys} == {"mixed", "slot"}


def test_a_pool_the_kernel_cannot_read_is_refused_at_start_up(tiny):
    """On the card the mixed step reads a paged pool through the prefill
    kernel, so ``Engine.check_prefill_read`` (called when a paged engine is
    built) refuses a pool the kernel has no body for: since the widened
    kernels, this model's head dim 16 and an f16 pool pass, and a head dim
    that is not a multiple of 16 (8: the config's dim halved) is refused
    with the reason (the other cases: ``test_torch_prefill_attention.py``);
    with ``attn_impl="plain"`` (the plain read), a contiguous layout, or on
    the CPU, every pool passes.  The CPU engine is asked as if it were on
    the card (its device set to ``cuda``): nothing is launched."""
    tcfg, tp = tiny
    eng = Engine(tcfg, tp, device="cpu", **_engine_kw("paged"))
    eng.check_prefill_read()
    eng.device = torch.device("cuda")
    eng.check_prefill_read()
    half = Engine(tcfg, tp, device="cpu", **{**_engine_kw("paged"), "kv_dtype": torch.float16})
    half.device = torch.device("cuda")
    half.check_prefill_read()
    eng.cfg = tcfg.with_(dim=tcfg.dim // 2)
    with pytest.raises(ValueError, match="head dim 8: the kernels take multiples of 16"):
        eng.check_prefill_read()
    eng.cfg = tcfg.with_(dim=tcfg.dim // 2, attn_impl="plain")
    eng.check_prefill_read()
    cont = Engine(tcfg, tp, device="cpu", **_engine_kw("contiguous"))
    cont.device = torch.device("cuda")
    cont.check_prefill_read()
