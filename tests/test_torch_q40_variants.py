"""The Q40 dequant variants of kernels 1–2 (``DLLAMA_Q40_VARIANT``:
classic | fma | folded | exact) in the port's plain versions against the
JAX package's Pallas kernels in interpret mode, on the same numpy inputs.

Tolerances, relative to max|JAX|:
* ``classic``, ``fma``, ``exact``: ``MATMUL_TOL`` = 1e-5.  Both sides
  multiply the same operands exactly (bf16 by bf16, or bf16 x by an integer
  nibble, then by an f16 scale in f32) and differ only in the order of
  their f32 sums.
* ``folded``: its bias rounds each block sum of x to bf16 before the
  correction dot.  The block sums themselves are f32 sums taken in another
  order on each side, so one may land on the other side of a bf16 rounding
  edge: the two results may differ by one bf16 ulp of a block sum, times 8
  and the block's bf16 scale, in each block.  The test bounds the
  difference by that sum over the blocks (plus ``MATMUL_TOL``), and by
  ``FOLDED_TOL`` = 1e-3 of max whatever the data.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dllama_tpu import quants
from dllama_tpu.models import config as jconfig, params as jparams, transformer as jtr
from dllama_tpu.ops import q40 as jq40
from dllama_tpu_torch.models import config as tconfig, params as tparams
from dllama_tpu_torch.ops import q40 as tq40
from dllama_tpu_torch.parallel.mesh import make_mesh
from dllama_tpu_torch.runtime.engine import Engine

MATMUL_TOL = 1e-5
FOLDED_TOL = 1e-3
VARIANTS = ("classic", "fma", "folded", "exact")


def _weights(seed, lead, n, d):
    rng = np.random.RandomState(seed)
    qvals = rng.randint(-8, 8, size=(*lead, n, d)).astype(np.int8)
    scales = ((rng.rand(*lead, n // 32, d) - 0.5) * 0.04).astype(np.float16)
    return jq40.pack_planes(qvals, scales), tq40.pack_planes(qvals, scales)


def _bf16(a: np.ndarray) -> np.ndarray:
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16).float().numpy()


def _folded_bound(x: np.ndarray, scales: np.ndarray) -> np.ndarray:
    """8 · Σ_b ulp_bf16(bs_b) · |bf16(s_b)| for each output (t, d): the most
    the folded bias can move when every block sum rounds to its other bf16
    neighbour."""
    t, n = x.shape
    xr = _bf16(x).reshape(t, n // 32, 32)
    bs = np.abs(xr[..., :16].sum(-1) + xr[..., 16:].sum(-1))
    ulp = np.where(bs > 0, 2.0 ** (np.floor(np.log2(np.maximum(bs, 1e-30))) - 7), 0.0)
    sb = np.abs(_bf16(scales.astype(np.float32)[:n // 32]))
    return 8.0 * ulp @ sb


def _agree(out: np.ndarray, ref: np.ndarray, variant: str, x=None, scales=None):
    err = np.abs(out - ref)
    top = np.abs(ref).max()
    if variant != "folded":
        assert err.max() <= MATMUL_TOL * top, (variant, err.max() / top)
        return
    assert err.max() <= FOLDED_TOL * top, err.max() / top
    assert (err <= _folded_bound(x, scales) + MATMUL_TOL * top).all()


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("t", [1, 8, 16])
@pytest.mark.parametrize("n,d", [(2048, 256), (1024, 1024 + 384)])
def test_plain_matches_pallas_interpret(variant, t, n, d):
    """Flat (``_pallas_matmul``) and stacked (``_pallas_matmul_stacked`` at
    layers 0 and L-1) on the same packed planes; d = 1408 is ragged against
    the Pallas tile."""
    jq, tq = _weights(11, (), n, d)
    x = np.random.RandomState(12).randn(t, n).astype(np.float32)
    ref = np.asarray(jq40._pallas_matmul(jnp.asarray(x), jq.qpacked, jq.scales,
                                         interpret=True, variant=variant))
    out = tq40.matmul_plain(torch.from_numpy(x), tq, variant=variant).numpy()
    _agree(out, ref, variant, x, tq.scales.numpy())
    jq3, tq3 = _weights(13, (3,), n, d)
    for layer in (0, 2):
        ref = np.asarray(jq40._pallas_matmul_stacked(
            jnp.asarray(x), jq3.qpacked, jq3.scales, jnp.int32(layer), interpret=True,
            variant=variant))
        out = tq40.matmul_plain(torch.from_numpy(x), tq3, layer, variant=variant).numpy()
        _agree(out, ref, variant, x, tq3.scales[layer].numpy())


@pytest.mark.parametrize("variant", VARIANTS)
def test_plain_matches_pallas_interpret_padded_n(variant):
    """n = 1056 (n/32 odd), packed to 2048 rows with zero scales: the JAX
    kernel reads x padded with zeros, the port's plain version the logical
    n only."""
    jq, tq = _weights(14, (), 1056, 96)
    x = np.random.RandomState(15).randn(5, 1056).astype(np.float32)
    xp = np.concatenate([x, np.zeros((5, 2048 - 1056), np.float32)], axis=1)
    ref = np.asarray(jq40._pallas_matmul(jnp.asarray(xp), jq.qpacked, jq.scales,
                                         interpret=True, variant=variant))
    out = tq40.matmul_plain(torch.from_numpy(x), tq, variant=variant).numpy()
    _agree(out, ref, variant, x, tq.scales.numpy())


def test_fma_equals_classic_for_every_nibble_and_finite_scale():
    """``bf16(v·s + (-8·s))`` against ``bf16(f32(v-8)·s)``: every nibble v in
    [0, 15] against each of the 63,488 finite f16 scales (subnormals and
    both zeros included).  Both products are exact in f32 (4 bits by an
    11-bit significand), so the weights are equal; only the sign of a zero
    may differ (v = 8: ``8s + (-8s)`` is +0, ``0·s`` is -0 for s < 0).  This
    is why the kernel serves ``fma`` with ``classic``'s arithmetic."""
    bits = np.arange(1 << 16, dtype=np.uint32).astype(np.uint16)
    scales = bits.view(np.float16)
    scales = scales[np.isfinite(scales)]
    assert scales.size == 63488
    r = np.arange(16, dtype=np.uint8)
    qt = tq40.QTensor(torch.from_numpy(np.repeat((r | r << 4)[:, None], scales.size, 1)),
                      torch.from_numpy(scales[None].copy()), (32, scales.size))
    fma = tq40.variant_weights(qt, "fma").view(torch.int16).numpy().view(np.uint16)
    classic = tq40.variant_weights(qt, "classic").view(torch.int16).numpy().view(np.uint16)
    assert fma.shape == (32, 63488)
    differ = fma != classic
    # a differing pair is +0 against -0, and nothing else
    assert set(np.unique(fma[differ])) <= {0x0000, 0x8000}
    assert set(np.unique(classic[differ])) <= {0x0000, 0x8000}
    # 31,759 of the 16 x 63,488 pairs (mostly v = 8 with s < 0; the rest
    # s = ±0), each nibble twice here (a low and a high nibble a byte)
    assert differ.sum() == 2 * 31759


def test_routing_variant_rows_and_blocked(monkeypatch):
    """As the JAX package routes it: the variant at up to PALLAS_MAX_ROWS
    = 128 rows on a row-major weight, ``classic`` at 129 rows and on a
    blocked plane."""
    monkeypatch.setattr(tq40, "KERNEL_VARIANT", "exact")
    _, tq = _weights(16, (), 256, 64)
    for t, want in ((1, "exact"), (128, "exact"), (129, "classic")):
        x = torch.from_numpy(np.random.RandomState(t).randn(t, 256).astype(np.float32))
        assert tq40.variant_for(t) == want
        out = tq40.matmul(x, tq, out_dtype=torch.float32)
        assert torch.equal(out, tq40.matmul_plain(x, tq, variant=want))
    bq = tq40.to_blocked(tq, 64, 128)
    x = torch.from_numpy(np.random.RandomState(3).randn(4, 256).astype(np.float32))
    assert tq40.variant_for(4, blocked=True) == "classic"
    assert torch.equal(tq40.matmul(x, bq, out_dtype=torch.float32),
                       tq40.matmul_plain(x, tq, variant="classic"))
    monkeypatch.setattr(tq40, "KERNEL_VARIANT", "bogus")
    with pytest.raises(ValueError, match="unknown q40 kernel variant 'bogus' "
                       r"\(expected classic \| fma \| folded \| exact\)"):
        tq40.matmul(x, tq)


def test_counters_keyed_by_variant(monkeypatch):
    """The wrapper's launch counts (the launch itself replaced: no card
    here): a classic key as before, every other variant's key ending in its
    name, the tensor-core body's under ``("mma", ...)`` too; 129 rows count
    under classic."""
    calls = []

    def fake_launch(fn, x2, values, scales, n, layer, value_dtype, per_byte, mma=False,
                    tail=()):
        calls.append((fn, tail))
        return torch.zeros((x2.shape[0], values.shape[-1]))

    monkeypatch.setattr(tq40, "launch", fake_launch)
    monkeypatch.setattr(tq40, "KERNEL_VARIANT", "folded")
    _, tq = _weights(17, (), 64, 32)
    tq40.reset_counters()
    for t in (1, 16, 129):
        tq40.q40_matmul(torch.zeros(t, 64), tq.qpacked, tq.scales, 64)
    tq40.q40_matmul(torch.zeros(2, 64), tq.qpacked, tq.scales, 64, variant="exact")
    tq40.q40_matmul(torch.zeros(2, 64), tq.qpacked, tq.scales, 64, variant="fma")
    c = tq40.counters()
    assert c["launches_by_shape"] == {(64, 32, "folded"): 1, ("mma", 64, 32, "folded"): 1,
                                      ("mma", 64, 32): 1, (64, 32, "exact"): 1,
                                      (64, 32, "fma"): 1}
    assert (c["kernel_launches"], c["mma_launches"]) == (5, 2)
    assert tq40.launches_by_variant() == {"folded": 2, "classic": 1, "exact": 1, "fma": 1}
    assert calls == [("q40_matmul", (2,)), ("q40_matmul_mma", (2,)),
                     ("q40_matmul_mma", (0,)), ("q40_matmul", (3,)), ("q40_matmul", (1,))]
    tq40.reset_counters()


# -- the slice: a tiny Q40 model through the port's engine against JAX ------

def _model():
    kw = dict(dim=64, hidden_dim=96, n_layers=2, n_heads=4, n_kv_heads=2,
              vocab_size=128, seq_len=64)
    jcfg = dataclasses.replace(jconfig.tiny_config(dtype=jnp.float32, **kw),
                               quant_impl="pallas_interpret")
    tcfg = tconfig.tiny_config(**kw)
    jp = jparams.quantize_matmuls(jparams.init_params(jcfg, seed=3), jcfg)
    arrays = {k: (np.asarray(v.qpacked), np.asarray(v.scales), v.logical_nd)
              if isinstance(v, jq40.QTensor) else np.asarray(v) for k, v in jp.items()}
    return jcfg, jp, tcfg, tparams.from_jax_params(arrays, tcfg)


E2E_TOL = {"classic": 1e-4, "fma": 1e-4, "exact": 1e-4, "folded": 1e-3}


@pytest.mark.parametrize("variant", VARIANTS)
def test_engine_matches_jax_forward(variant, monkeypatch):
    """Prefill of 7 tokens and 4 teacher-forced decode steps through the
    port's Engine (every matmul the plain version under the variant)
    against the JAX forward with ``quant_impl="pallas_interpret"`` and its
    ``KERNEL_VARIANT`` set on the imported module (its jitted kernels
    traced anew: ``jax.clear_caches()``).  Logits within E2E_TOL of max
    (1e-4, the f32 model's bar in tests/test_torch_model.py; folded 1e-3,
    the block sums' bf16 round); the greedy token agrees wherever the JAX
    top-2 margin exceeds twice the largest logit difference."""
    jax.clear_caches()
    monkeypatch.setattr(jq40, "KERNEL_VARIANT", variant)
    monkeypatch.setattr(tq40, "KERNEL_VARIANT", variant)
    jcfg, jp, tcfg, tp = _model()
    tokens = np.random.RandomState(4).randint(0, 128, 11)
    eng = Engine(tcfg, tp, device="cpu")
    got = [eng.prefill(tokens[:7].tolist())[0]]
    for tk in tokens[7:]:
        got.append(eng.decode_one(int(tk))[0])
    cache = jtr.init_kv_cache(jcfg, 1)
    ref, cache = jtr.forward_last(jp, jcfg, jnp.asarray(tokens[None, :7]), cache,
                                  jnp.int32(0), jnp.int32(6))
    refs = [np.asarray(ref)]
    for i, tk in enumerate(tokens[7:]):
        ref, cache = jtr.forward_last(jp, jcfg, jnp.asarray([[tk]]), cache,
                                      jnp.int32(7 + i), jnp.int32(0))
        refs.append(np.asarray(ref))
    jax.clear_caches()
    for g, r in zip(got, refs):
        g, r = np.asarray(g, np.float32).reshape(-1), r.reshape(-1)
        gap = np.abs(g - r).max()
        assert gap <= E2E_TOL[variant] * np.abs(r).max(), (variant, gap / np.abs(r).max())
        top2 = np.sort(r)[-2:]
        if top2[1] - top2[0] > 2 * gap:
            assert int(np.argmax(g)) == int(np.argmax(r))


def test_variants_take_effect_in_the_engine(monkeypatch):
    """The variants are not one function: on the same model, ``exact`` and
    ``folded`` logits differ from ``classic``'s (each rounds otherwise),
    ``fma``'s equal them bit for bit."""
    _, _, tcfg, tp = _model()
    tokens = np.random.RandomState(5).randint(0, 128, 9).tolist()
    out = {}
    for v in VARIANTS:
        monkeypatch.setattr(tq40, "KERNEL_VARIANT", v)
        out[v] = Engine(tcfg, tp, device="cpu").prefill(tokens)[0]
    assert np.array_equal(out["fma"], out["classic"])
    assert not np.array_equal(out["exact"], out["classic"])
    assert not np.array_equal(out["folded"], out["classic"])


def test_tp_ranks_take_the_variant(monkeypatch):
    """Under ``--workers tpu:2`` on the CPU each rank's Q40 matmul reaches
    ``q40.matmul`` on its slice and takes the variant; the tp = 2 logits
    agree with tp = 1's under the same variant."""
    monkeypatch.setattr(tq40, "KERNEL_VARIANT", "exact")
    seen = []
    real = tq40.variant_for

    def spy(t, blocked=False):
        v = real(t, blocked)
        seen.append((t, v))
        return v

    monkeypatch.setattr(tq40, "variant_for", spy)
    _, _, tcfg, tp = _model()
    tokens = np.random.RandomState(6).randint(0, 128, 6).tolist()
    one = Engine(tcfg, tp, device="cpu").prefill(tokens)[0]
    seen.clear()
    two = Engine(tcfg, tp, device="cpu", mesh=make_mesh(2, "cpu")).prefill(tokens)[0]
    assert seen and {v for _, v in seen} == {"exact"}
    assert np.abs(two - one).max() <= 1e-4 * np.abs(one).max()


@pytest.mark.parametrize("variant", ("fma", "folded", "exact"))
def test_cli_runs_each_variant(variant, tmp_path):
    """``DLLAMA_Q40_VARIANT=fma|folded|exact`` is no longer refused: the
    port's CLI generates greedy text under it (a child process, as the
    variant is read when ``ops.q40`` is imported), every Q40 matmul the
    plain version on the CPU under that variant."""
    import os
    import subprocess
    import sys

    from fixtures import write_tiny_model, write_tiny_tokenizer
    m, t = tmp_path / "tiny.m", tmp_path / "tiny.t"
    write_tiny_model(m, ftype=quants.Q40)
    write_tiny_tokenizer(t)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, DLLAMA_Q40_VARIANT=variant,
               PYTHONPATH=repo + os.pathsep + os.environ.get("PYTHONPATH", ""))
    r = subprocess.run([sys.executable, "-m", "dllama_tpu_torch", "generate", "--model", str(m),
                        "--tokenizer", str(t), "--prompt", "hello", "--steps", "12",
                        "--temperature", "0", "--device", "cpu"],
                       cwd=repo, env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    last = r.stdout.splitlines()[-1]
    assert last.startswith("💡 q40 launches: kernel=0 plain=") and "not yet ported" not in r.stderr
