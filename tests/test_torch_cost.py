"""The port's roofline cost model (``dllama_tpu_torch/obs/cost.py``)
against the JAX package's (``dllama_tpu/obs/cost.py``):

* ``CostModel`` gives the JAX figures exactly (every FLOP and byte, the
  per-row split, the ledger entries) at Llama-2-7B, Mixtral-8x7B and
  Grok-1 widths, Q40/Q80/dense weights, bf16/int8/f32 KV, paged and
  contiguous, tp 1 and 2;
* ``model_from_engine`` on a port engine builds the model JAX's builds on
  the same file (Q40 and Q80; contiguous, paged, int8 pool, tp = 2);
* the peak table: the H100 entry, an unknown card (no peaks, gauges
  stay unset), the env override and the CPU measurement;
* the scheduler's land-time attribution: a solo request's ledger
  families equal the JAX scheduler's on the same weights, the flight
  record carries its cost block, and the gauges are in (0, 1] under
  known peaks.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest

from dllama_tpu import quants
from dllama_tpu.io import mfile as jmfile
from dllama_tpu.models import params as jparams
from dllama_tpu.obs import cost as jcost, dispatch as jdispatch, metrics as jmetrics
from dllama_tpu.runtime.engine import Engine as JEngine
from dllama_tpu.runtime.scheduler import SlotScheduler as JScheduler
from dllama_tpu_torch.io import mfile as tmfile
from dllama_tpu_torch.models import params as tparams
from dllama_tpu_torch.obs import cost as tcost, dispatch as tdispatch, flight as tflight
from dllama_tpu_torch.obs import metrics as tmetrics
from dllama_tpu_torch.parallel.mesh import make_mesh
from dllama_tpu_torch.runtime.engine import Engine
from dllama_tpu_torch.runtime.scheduler import SlotScheduler
from fixtures import write_tiny_model

WIDTHS = {
    "llama2-7b": dict(dim=4096, hidden_dim=11008, n_layers=32, n_heads=32, n_kv_heads=32,
                      vocab_size=32000),
    "mixtral-8x7b": dict(dim=4096, hidden_dim=14336, n_layers=32, n_heads=32, n_kv_heads=8,
                         vocab_size=32000, n_experts=8, n_active_experts=2),
    "grok-1": dict(dim=6144, hidden_dim=32768, n_layers=64, n_heads=48, n_kv_heads=8,
                   vocab_size=131072, n_experts=8, n_active_experts=2),
}
CODECS = {"q40": ("q40", 2), "q8": ("q8", 2), "dense": ("dense", 2)}
KV = {"bf16": ("kv_bfloat16", 2), "int8": ("kv_int8", 1), "f32": ("kv_float32", 4)}
ROWS = [("prefill", 0, 16), ("decode", 100, 16), ("verify", 37, 5), ("decode", 4090, 1),
        ("prefill", 513, 128)]


@pytest.mark.parametrize("width", list(WIDTHS))
@pytest.mark.parametrize("codec", list(CODECS))
@pytest.mark.parametrize("kv", list(KV))
@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
@pytest.mark.parametrize("tp", [1, 2])
def test_cost_model_equals_jax_exactly(width, codec, kv, paged, tp):
    kw = dict(WIDTHS[width], weight_codec=CODECS[codec][0],
              weight_el_bytes=CODECS[codec][1], kv_codec=KV[kv][0], kv_el_bytes=KV[kv][1],
              tp=tp, paged=paged, page_size=16 if paged else 0, fused=paged)
    mine, ref = tcost.CostModel(**kw), jcost.CostModel(**kw)
    assert mine.params_per_token == ref.params_per_token
    assert mine.weight_read_bytes() == ref.weight_read_bytes()
    for steps in (1, 16):
        for rows in (ROWS, ROWS[:1], [("verify", 4000, 5)] * 8):
            got, want = mine.dispatch_cost(rows, steps=steps), ref.dispatch_cost(rows, steps=steps)
            assert got == want
            assert isinstance(got["flops"], int)


def _file(tmp_path_factory, ftype):
    path = tmp_path_factory.mktemp("cost") / "tiny.m"
    write_tiny_model(path, vocab_size=128, seq_len=64, ftype=ftype)
    return str(path)


@pytest.fixture(scope="module", params=["q40", "q80"])
def file_pair(request, tmp_path_factory):
    path = _file(tmp_path_factory, quants.Q40 if request.param == "q40" else quants.Q80)
    jcfg, jp = jparams.load_params(jmfile.MFile(path), keep_quantized=True,
                                   dtype=jnp.bfloat16)
    with tmfile.MFile(path) as mf:
        tcfg, tp = tparams.load_params(mf)
    with tmfile.MFile(path) as mf:
        tcfg2, tp2 = tparams.load_params(mf, fuse=False)
    return jcfg, jp, tcfg, tp, tcfg2, tp2


@pytest.mark.parametrize("kind", ["contiguous", "paged", "paged-int8", "tp2"])
def test_model_from_engine_equals_jax(file_pair, kind):
    jcfg, jp, tcfg, tp, tcfg2, tp2 = file_pair
    kw = {}
    if kind.startswith("paged"):
        kw = dict(kv_pages=33, kv_page_size=4)
    if kind == "paged-int8":
        kw["kv_dtype"] = "q8"
    if kind == "tp2":
        mine = tcost.model_from_engine(Engine(tcfg2, tp2, device="cpu", batch=2,
                                              mesh=make_mesh(2, "cpu")))
    else:
        mine = tcost.model_from_engine(Engine(tcfg, tp, device="cpu", batch=2, **kw))
    ref = jcost.model_from_engine(JEngine(jcfg, jp, batch=2, **kw))
    assert mine is not None and ref is not None
    want = dict(vars(ref))
    if kind == "tp2":
        # the JAX engine here runs at tp = 1 on the one CPU device; the
        # port's mesh gives tp = 2, the only field that differs
        assert mine.tp == 2
        want["tp"] = 2
    assert vars(mine) == want
    assert mine.weight_codec in ("q40", "q8") and mine.fused is False


def test_peak_table_h100_unknown_card_env_and_cpu(monkeypatch):
    monkeypatch.delenv("DLLAMA_PEAK_FLOPS", raising=False)
    monkeypatch.delenv("DLLAMA_PEAK_BYTES_S", raising=False)
    try:
        tcost.set_backend("NVIDIA H100 80GB HBM3", "cuda", 0)
        p = tcost.peaks()
        assert p == {"flops": 989.4e12, "bytes_per_s": 3.35e12, "source": "table",
                     "device": "NVIDIA H100 80GB HBM3"}
        tcost.TRACKER.reset()
        tcost.TRACKER.note(989.4e9, 3.35e9, 2.0)  # half of each peak over 2 ms
        assert tcost.TRACKER.mfu() == pytest.approx(0.5)
        assert tcost.TRACKER.mbu() == pytest.approx(0.5)
        # no guess for another part: no peaks, the gauges stay unset
        for name in ("NVIDIA H100 PCIe", "NVIDIA H100 NVL", "NVIDIA A100-SXM4-80GB"):
            tcost.set_backend(name, "cuda", 0)
            assert tcost.peaks()["source"] == "none" and tcost.peaks()["flops"] is None
            assert tcost.TRACKER.mfu() is None and tcost.TRACKER.mbu() is None
        monkeypatch.setenv("DLLAMA_PEAK_FLOPS", "1e12")
        monkeypatch.setenv("DLLAMA_PEAK_BYTES_S", "2e11")
        tcost.set_backend("NVIDIA H100 80GB HBM3", "cuda", 0)
        assert tcost.peaks() == {"flops": 1e12, "bytes_per_s": 2e11, "source": "env",
                                 "device": "NVIDIA H100 80GB HBM3"}
        monkeypatch.delenv("DLLAMA_PEAK_FLOPS")
        monkeypatch.delenv("DLLAMA_PEAK_BYTES_S")
        tcost.set_backend(None, "cpu")
        p = tcost.peaks()
        assert p["source"] == "measured" and p["flops"] > 0 and p["bytes_per_s"] > 0
        s = tcost.summary()
        assert s["card"] == {"name": None, "power_limit": None}
        assert set(s) >= {"flops_total", "hbm_bytes_total", "chip_wall_ms", "mfu", "mbu",
                          "peaks", "card", "chip_ms_by_class"}
    finally:
        tcost.set_backend(None, None)
        tcost.reset()


def _family(registry_fam) -> dict:
    return json.loads(json.dumps(registry_fam.json_value()))


def test_scheduler_attribution_equals_jax(file_pair, monkeypatch):
    """One request alone (its dispatches do not depend on timing): the
    port's dispatch_flops/dispatch_bytes families equal the JAX
    scheduler's, its flight record has the cost block, and with known
    peaks the gauges sit in (0, 1]."""
    jcfg, jp, tcfg, tp, *_ = file_pair
    monkeypatch.setenv("DLLAMA_PEAK_FLOPS", "1e15")
    monkeypatch.setenv("DLLAMA_PEAK_BYTES_S", "1e13")
    prompt = [1, 5, 9, 2, 7, 3, 11, 4, 4, 8]
    fams = {}
    for name, eng_cls, sched_cls, disp, metrics, cost in (
            ("port", lambda: Engine(tcfg, tp, device="cpu", batch=2, kv_pages=33,
                                    kv_page_size=4), SlotScheduler, tdispatch, tmetrics,
             tcost),
            ("jax", lambda: JEngine(jcfg, jp, batch=2, kv_pages=33, kv_page_size=4),
             JScheduler, jdispatch, jmetrics, jcost)):
        disp.reset()
        cost.reset()
        sched = sched_cls(eng_cls(), prefill_chunk=4, overlap=False)
        try:
            t = sched.submit(prompt, 12, temperature=0.0)
            toks = list(t.tokens())
        finally:
            sched.close()
        fams[name] = (toks, _family(metrics.DISPATCH_FLOPS), _family(metrics.DISPATCH_BYTES),
                      t.rid, cost.TRACKER.mfu(), cost.TRACKER.mbu())
    (tt, tf, tb, rid, mfu, mbu), (jt, jf, jb, *_) = fams["port"], fams["jax"]
    assert tt == jt
    assert tf == jf and tb == jb
    assert set(k.split(",")[-1] if "," in k else k for k in tf) and tf
    rec = tflight.get(rid)
    assert rec["cost"]["flops"] > 0 and rec["cost"]["chip_ms"] > 0
    assert 0 < mfu <= 1 and 0 < mbu <= 1
    assert tmetrics.MFU.value == pytest.approx(mfu)
    tdispatch.reset()
    tcost.reset()
