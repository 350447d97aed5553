"""The port's continuous-batching slot step (models.transformer
``forward_slots``, runtime.decode_loop ``slot_chunk`` and
``device_sample_rows``) against the JAX package's, on the same packed
weights (``from_jax_params``) and the same numpy inputs.

Tolerances, relative to max|logits| (those of tests/test_torch_model.py):
* f32 model: the matmuls multiply the same bf16 operands in both packages
  and differ only in f32 summation order — 1e-4.
* bf16 model: a last-bit difference before a bf16 cast becomes a bf16 ulp
  and travels through two layers — 3e-2.
Greedy tokens are compared exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dllama_tpu.models import config as jconfig, params as jparams, transformer as jtr
from dllama_tpu.ops import q40 as jq40
from dllama_tpu.runtime import decode_loop as jdl
from dllama_tpu_torch.models import config as tconfig, params as tparams, transformer as ttr
from dllama_tpu_torch.runtime import decode_loop as tdl
from dllama_tpu_torch.runtime.engine import ContextOverflow, Engine
from dllama_tpu_torch.sampling import sample_with_coin

TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
_JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
PAGE = 4
B = 3


def _configs(dtype):
    kw = dict(dim=64, hidden_dim=96, n_layers=2, n_heads=4, n_kv_heads=2,
              vocab_size=128, seq_len=32)
    return (jconfig.tiny_config(dtype=_JDT[dtype], **kw),
            tconfig.tiny_config(dtype=dtype, **kw))


def _params(dtype):
    jcfg, tcfg = _configs(dtype)
    jp = jparams.quantize_matmuls(jparams.init_params(jcfg, seed=3), jcfg)
    arrays = {k: (np.asarray(v.qpacked), np.asarray(v.scales), v.logical_nd)
              if isinstance(v, jq40.QTensor) else np.asarray(v) for k, v in jp.items()}
    return jcfg, jp, tcfg, tparams.from_jax_params(arrays, tcfg)


@pytest.fixture(scope="module")
def models():
    return {dt: _params(dt) for dt in (torch.float32, torch.bfloat16)}


def _caches(layout, jcfg, tcfg):
    """(jax cache, port cache, page table or None) for one layout."""
    if layout == "contiguous":
        return jtr.init_kv_cache(jcfg, B), ttr.init_kv_cache(tcfg, B), None
    quant = layout == "paged_int8"
    maxp = tcfg.seq_len // PAGE
    # rows own interleaved pages, so a wrong table index reads a neighbor
    table = (1 + np.arange(B * maxp, dtype=np.int32)).reshape(maxp, B).T.copy()
    n_pages = 1 + B * maxp
    return (jtr.init_kv_pool(jcfg, n_pages, PAGE, quant=quant),
            ttr.init_kv_pool(tcfg, n_pages, PAGE, quant=quant), table)


def _close(t, j, tol):
    j = np.asarray(j, np.float32)
    np.testing.assert_allclose(t.to(torch.float32).numpy(), j, rtol=0,
                               atol=tol * np.abs(j).max())


# two mixed steps: row 0 prefills 6 tokens then decodes; row 1 prefills
# 3 + 3 tokens; row 2 is free (position 0, one garbage token)
STEPS = [
    (np.array([[5, 9, 2, 7, 11, 4], [8, 1, 6, 0, 0, 0], [0] * 6], np.int32),
     np.array([0, 0, 0], np.int32), np.array([6, 3, 1], np.int32)),
    (np.array([[17, 0, 0, 0], [3, 12, 10, 0], [0] * 4], np.int32),
     np.array([6, 3, 0], np.int32), np.array([1, 3, 1], np.int32)),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("layout", ["contiguous", "paged", "paged_int8"])
def test_forward_slots_matches_jax(models, layout, dtype):
    jcfg, jp, tcfg, tp = models[dtype]
    jcache, tcache, table = _caches(layout, jcfg, tcfg)
    jtab = None if table is None else jnp.asarray(table)
    ttab = None if table is None else torch.from_numpy(table)
    for tokens, pos, n_valid in STEPS:
        jl, jcache = jtr.forward_slots(jp, jcfg, jnp.asarray(tokens), jcache,
                                       jnp.asarray(pos), jnp.asarray(n_valid), page_table=jtab)
        tl, tcache = ttr.forward_slots(tp, tcfg, torch.from_numpy(tokens), tcache,
                                       torch.from_numpy(pos), torch.from_numpy(n_valid),
                                       page_table=ttab)
        assert tl.dtype == torch.float32 and tl.shape == (B, 128)
        # the free row reads garbage by design: compare the live ones
        _close(tl[:2], np.asarray(jl)[:2], TOL[dtype])


@pytest.mark.parametrize("layout", ["paged", "paged_int8"])
def test_slot_chunk_greedy_token_identical(models, layout):
    """A prefill chunk then 3 more on-device decode steps (steps=4)."""
    jcfg, jp, tcfg, tp = models[torch.float32]
    jcache, tcache, table = _caches(layout, jcfg, tcfg)
    tokens, pos, n_valid = STEPS[0]
    zeros = np.zeros(B, np.float32)
    jt, *_ = jdl.slot_chunk(jp, jcfg, jcache, jnp.asarray(tokens), jnp.asarray(pos),
                            jnp.asarray(n_valid), jnp.zeros((2,), jnp.uint32),
                            jnp.asarray(zeros), jnp.asarray(zeros + 0.9), steps=4,
                            greedy=True, page_table=jnp.asarray(table))
    gen = torch.Generator()
    tt, _, last, logits = tdl.slot_chunk(
        tp, tcfg, tcache, torch.from_numpy(tokens), torch.from_numpy(pos),
        torch.from_numpy(n_valid), gen, torch.from_numpy(zeros),
        torch.from_numpy(zeros + 0.9), steps=4, greedy=True,
        page_table=torch.from_numpy(table))
    assert tt.shape == (4, B) and tt.dtype == torch.int32
    np.testing.assert_array_equal(tt.numpy()[:, :2], np.asarray(jt)[:, :2])
    np.testing.assert_array_equal(last.numpy(), tt.numpy()[-1])
    assert logits.shape == (B, 128)


def test_device_sample_rows_fixed_coin_matches_host_sampler():
    """Mixed rows (greedy, top-p, plain multinomial, top-k): the coin each
    sampled row draws from the generator picks the host sampler's token."""
    rng = np.random.RandomState(9)
    b, v = 6, 50
    logits = (rng.randn(b, v) * 3).astype(np.float32)
    logits[4, 7] = logits[4, 8] = logits[4].max() + 1  # a tie
    temps = np.array([0.0, 0.8, 1.0, 0.7, 1.2, 0.0], np.float32)
    topps = np.array([0.9, 0.9, 1.0, 0.5, 0.95, 0.9], np.float32)
    topks = np.array([0, 0, 0, 5, 3, 0], np.int32)
    gen, twin = torch.Generator(), torch.Generator()
    gen.manual_seed(4)
    twin.manual_seed(4)
    coins = torch.rand((b,), generator=twin).numpy()
    got = tdl.device_sample_rows(torch.from_numpy(logits), gen, torch.from_numpy(temps),
                                 torch.from_numpy(topps), False, torch.from_numpy(topks))
    want = [sample_with_coin(logits[r], float(coins[r]), temperature=float(temps[r]),
                             topp=float(topps[r]), topk=int(topks[r])) for r in range(b)]
    assert got.dtype == torch.int32 and got.tolist() == want
    greedy = tdl.device_sample_rows(torch.from_numpy(logits), gen, torch.from_numpy(temps),
                                    torch.from_numpy(topps), True)
    assert greedy.tolist() == logits.argmax(-1).tolist()


def test_slot_step_feed_dev_matches_host_feed(models):
    """A pure-decode dispatch fed the previous dispatch's on-device last row
    gives what the same tokens fed from the host give; a step past seq_len
    is refused."""
    _, _, tcfg, tp = models[torch.float32]
    maxp = tcfg.seq_len // PAGE
    table = (1 + np.arange(B * maxp, dtype=np.int32)).reshape(B, maxp)
    zeros = np.zeros(B, np.float32)
    tokens, pos, n_valid = STEPS[0]
    outs = []
    for feed in (True, False):
        eng = Engine(tcfg, tp, device="cpu", batch=B, kv_pages=1 + B * maxp,
                     kv_page_size=PAGE)
        kw = dict(temps_np=zeros, topps_np=zeros + 0.9, page_tables_np=table)
        first = eng.slot_step_async(tokens, pos, n_valid, **kw)
        ids = first.wait()
        nxt = (eng.slot_step_async(None, pos + n_valid, np.ones(B, np.int32), steps=3,
                                   feed_dev=first.last_dev, **kw) if feed else
               eng.slot_step_async(ids[-1][:, None], pos + n_valid, np.ones(B, np.int32),
                                   steps=3, **kw))
        outs.append(nxt.wait())
        assert eng.slot_decode_forwards == 3
    np.testing.assert_array_equal(outs[0], outs[1])
    with pytest.raises(ContextOverflow):
        eng.slot_step(tokens, np.full(B, tcfg.seq_len - 2, np.int32), n_valid, **kw)
