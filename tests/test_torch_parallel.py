"""The port's tensor-parallel building blocks (dllama_tpu_torch.parallel,
ops.q40's TP half) against the JAX package's, on the CPU:

* mesh parsing and placement, and the tp constraint's rejections (the
  same messages, naming the valid degrees);
* each rank's slice of every parameter — Q40, Q80 and dense — bit for bit
  against the JAX arrays' ``addressable_shards`` on the virtual CPU mesh
  (the tiny shapes carry no pack-time padding, so both packages slice at
  the same boundary, and replicate the same leaves);
* kernel 4's plain version, ``tp_allreduce_plain``: exactly the numpy sum
  in the TPU ring's order, and against ``jax.lax.psum`` under
  ``shard_map`` — exact at tp = 2 (two f32 adds commute), within 1e-6 of
  max at tp = 4 (the psum adds in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from dllama_tpu.models import config as jconfig
from dllama_tpu.ops import q8 as jq8, q40 as jq40
from dllama_tpu.parallel import mesh as jmesh, sharding as jsharding
from dllama_tpu_torch.models import config as tconfig, params as tparams
from dllama_tpu_torch.ops import q8 as tq8, q40 as tq40
from dllama_tpu_torch.parallel import mesh as tmesh, sharding as tsharding

KW = dict(dim=64, hidden_dim=128, n_layers=2, n_heads=4, n_kv_heads=4,
          vocab_size=96, seq_len=32)


# --- mesh --------------------------------------------------------------------

@pytest.mark.parametrize("workers,tp", [(None, 1), ("", 1), ("tpu:1", 1), ("tpu:2", 2),
                                        ("tpu:4", 4), ("tpu:8", 8)])
def test_parse_workers_cpu(workers, tp):
    mesh = tmesh.parse_workers(workers, "cpu")
    assert mesh.tp == tp
    assert mesh.devices == (torch.device("cpu"),) * tp and mesh.device.type == "cpu"
    if workers:  # the JAX package reads the same spelling as the same degree
        assert jmesh.parse_workers(workers).shape["tp"] == tp


def test_parse_workers_refuses_host_lists():
    for bad in ("10.0.0.1:9998", "tpu:x"):
        with pytest.raises(ValueError, match="tpu:N"):
            tmesh.parse_workers(bad, "cpu")
    with pytest.raises(ValueError, match="tpu:N"):
        jmesh.parse_workers("10.0.0.1:9998")


def test_mesh_placement_on_cards():
    # an indexed card takes every rank; plain cuda takes rank r to card r
    mesh = tmesh.make_mesh(4, "cuda:0")
    assert mesh.devices == (torch.device("cuda", 0),) * 4
    have = torch.cuda.device_count()
    with pytest.raises(ValueError, match=f"needs {have + 1} devices, have {have}"):
        tmesh.make_mesh(have + 1, "cuda")


@pytest.mark.parametrize("kw,tp", [
    (dict(n_kv_heads=2), 4),                  # more ranks than KV heads
    (dict(n_heads=6, n_kv_heads=3, dim=96), 2),  # heads do not divide
    (dict(hidden_dim=90, n_kv_heads=4), 4),   # hidden does not divide
])
def test_tp_constraint_messages_match_jax(kw, tp):
    tcfg = tconfig.tiny_config(**kw)
    jcfg = jconfig.tiny_config(**kw)
    assert tsharding.valid_tp_degrees(tcfg) == jsharding.valid_tp_degrees(jcfg)
    with pytest.raises(ValueError) as te:
        tsharding.check_tp_constraint(tcfg, tp)
    with pytest.raises(ValueError) as je:
        jsharding.check_tp_constraint(jcfg, tp)
    assert str(te.value) == str(je.value)
    assert f"valid tp degrees for this model: {tsharding.valid_tp_degrees(tcfg)}" \
        in str(te.value)


# --- slices ------------------------------------------------------------------

def _to_jax(v):
    """A port leaf as the JAX package's (bits kept)."""
    if isinstance(v, (tq40.QTensor, tq8.Q8Tensor)):
        cls = jq40.QTensor if isinstance(v, tq40.QTensor) else jq8.Q8Tensor
        return cls(jnp.asarray(v.qpacked.numpy()),
                   jnp.asarray(v.scales.numpy().view(np.uint16)), v.logical_nd)
    return jnp.asarray(v.float().numpy())


def _shards(arr, mesh) -> list[np.ndarray]:
    """The JAX array's shard on each tp rank, in rank order."""
    by_dev = {s.device: np.asarray(s.data) for s in arr.addressable_shards}
    return [by_dev[d] for d in mesh.devices.reshape(-1)]


def _leaves(v) -> list[np.ndarray]:
    if isinstance(v, (tq40.QTensor, tq8.Q8Tensor)):
        return [v.qpacked.numpy(), v.scales.numpy().view(np.uint16)]
    return [v.float().numpy()]


@pytest.mark.parametrize("codec", ["q40", "q80", "dense"])
@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("moe", [False, True])
def test_rank_slices_match_jax_shards(codec, tp, moe):
    kw = dict(KW, n_experts=4, n_active_experts=2, arch=0xABCD02) if moe else KW
    tcfg = tconfig.tiny_config(**kw)
    jcfg = jconfig.tiny_config(**kw)
    params = tparams.init_params(tcfg, seed=3)
    if codec != "dense":
        params = tparams.quantize_matmuls(params, tcfg, tq40 if codec == "q40" else tq8)
    params = tsharding.unfuse(params, tcfg)
    placed = tsharding.place_params(params, tcfg, tmesh.make_mesh(tp, "cpu"))
    mesh = jmesh.make_mesh(tp=tp)
    jplaced = jsharding.place_params({k: _to_jax(v) for k, v in params.items()}, jcfg, mesh)
    assert set(placed.ranks[0]) == set(jplaced)
    sliced = 0
    for k, jv in jplaced.items():
        jl = jax.tree.leaves(jv)
        for r in range(tp):
            mine = _leaves(placed.ranks[r][k])
            for a, b in zip(mine, [_shards(leaf, mesh)[r] for leaf in jl]):
                np.testing.assert_array_equal(a, b, err_msg=f"{k} rank {r}")
        sliced += placed.kinds[k] is not None
    # wq wk wv w1 w3 w2 wcls (or up gate down), and wo where it divides
    assert sliced >= 7


def test_q40_col_slice_drops_the_pack_padding():
    """A column slice of a padded plane (Llama-2-7B's w2 stores 11264 rows
    for 11008) is cut at the logical boundary, whole quantization blocks
    a rank, with no padded row, and each rank's product is its half of
    the whole product exactly."""
    rng = np.random.RandomState(0)
    n, d, tp = 1088, 8, 2                      # padded to 2048 rows
    w = tq40.quantize(rng.standard_normal((n, d)).astype(np.float32) * 0.1)
    assert w.qpacked.shape[0] * 2 == tq40.padded_n(n) == 2048
    assert tq40.tp_shardable(n, d, "col", tp) and not tq40.tp_shardable(n, d, "col", 4)
    parts = [tsharding.shard(w, "col", r, tp) for r in range(tp)]
    x = torch.from_numpy(rng.standard_normal((3, n)).astype(np.float32))
    for r, p in enumerate(parts):
        assert p.logical_nd == (n // tp, d) and p.qpacked.shape[0] * 2 == n // tp
        xr = x[:, r * n // tp:(r + 1) * n // tp]
        full = tq40.dequantize(w)[r * n // tp:(r + 1) * n // tp]
        assert torch.equal(tq40.dequantize(p), full)
        want = xr.to(torch.bfloat16).float() @ full.to(torch.bfloat16).float()
        assert torch.equal(tq40.matmul(xr, p), want)


def test_unshardable_leaf_stays_replicated(capsys):
    cfg = tconfig.tiny_config(**KW)
    params = tsharding.unfuse(tparams.quantize_matmuls(tparams.init_params(cfg, 1), cfg),
                              cfg)
    placed = tsharding.place_params(params, cfg, tmesh.make_mesh(4, "cpu"))
    # wo: 64 input rows over 4 ranks is half a quantization block a rank
    assert placed.kinds["wo"] is None and placed.kinds["w2"] == "col"
    assert all(r["wo"] is placed.ranks[0]["wo"] for r in placed.ranks)
    assert "⚠️  sharding: wo" in capsys.readouterr().out


# --- kernel 4's plain version ------------------------------------------------

def _ring_sum_np(parts: list[np.ndarray], r: int) -> np.ndarray:
    tp, h = len(parts), parts[0].shape[-1] // 2
    lo, hi = parts[r][..., :h].copy(), parts[r][..., h:].copy()
    for s in range(1, tp):
        lo = (lo + parts[(r - s) % tp][..., :h]).astype(np.float32)
        hi = (hi + parts[(r + s) % tp][..., h:]).astype(np.float32)
    return np.concatenate([lo, hi], -1)


@pytest.mark.parametrize("tp", [2, 3, 4, 8])
@pytest.mark.parametrize("shape", [(1, 64), (3, 10), (2, 5, 16)])
def test_allreduce_plain_is_the_ring_order(tp, shape):
    rng = np.random.RandomState(tp)
    parts = [(rng.standard_normal(shape) * 10 ** rng.uniform(-3, 3, shape))
             .astype(np.float32) for _ in range(tp)]
    tq40.reset_counters()
    outs = tq40.tp_allreduce([torch.from_numpy(p) for p in parts])
    assert tq40.counters()["allreduce_plain_calls"] == 1
    assert tq40.counters()["allreduce_launches"] == 0
    for r, o in enumerate(outs):
        assert o.dtype == torch.float32 and o.shape == shape
        np.testing.assert_array_equal(o.numpy(), _ring_sum_np(parts, r))
    if tp == 2:  # one f32 add each way: both ranks agree bit for bit
        assert torch.equal(outs[0], outs[1])


@pytest.mark.parametrize("tp", [2, 4])
def test_allreduce_plain_against_jax_psum(tp):
    t, d = 4, 96
    rng = np.random.RandomState(7)
    x = (rng.standard_normal((tp * t, d)) * 10 ** rng.uniform(-2, 2, (tp * t, d))) \
        .astype(np.float32)
    mesh = jmesh.make_mesh(tp=tp)
    psum = jmesh.shard_map(lambda a: jax.lax.psum(a, "tp"), mesh=mesh,
                           in_specs=(P("tp", None),), out_specs=P("tp", None),
                           check_vma=False)
    ref = np.asarray(psum(jnp.asarray(x))).reshape(tp, t, d)
    outs = tq40.tp_allreduce_plain([torch.from_numpy(x[r * t:(r + 1) * t])
                                    for r in range(tp)])
    for r, o in enumerate(outs):
        if tp == 2:
            np.testing.assert_array_equal(o.numpy(), ref[r])
        else:
            np.testing.assert_allclose(o.numpy(), ref[r], rtol=0,
                                       atol=1e-6 * np.abs(ref).max())


def test_allreduce_kernel_refuses_cpu_tensors():
    """On the CPU only the plain version runs; the kernel's wrapper takes
    CUDA tensors or raises (it never computes another way)."""
    parts = [torch.zeros(1, 8), torch.zeros(1, 8)]
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        tq40.tp_allreduce_kernel(parts)
    with pytest.raises(ValueError, match="ranks outside"):
        tq40.tp_allreduce_kernel(parts[:1])
