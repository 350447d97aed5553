"""The host side of the Q40 kernel's tensor-core body (kernels 1–3 at
t >= ``q40.T_MMA`` rows; ``ops/q40.py`` ``route``, ``mma_plan``,
``_copy_width``, the wrappers' ``body`` and counters, ``bind``, and the
build's hash of ``csrc/mma_common.cuh``), on the CPU.  The kernel itself
runs only on the card (``chip_smoke.py`` phases 2 and 13).

Its tile walk is held to the JAX package's Pallas kernels (interpret mode)
through a numpy transcription of what a block stages: 64-row steps of two
quantization blocks, each block's 16 packed rows addressed through the
row-major or blocked layout in copies of the width the wrapper picks, the
nibbles unpacked to logical rows 32b + r and 32b + 16 + r, the splits of
``mma_plan`` added in order.  Tolerance 1e-5 · max|ref|: the same bf16
products summed in f32 in another order.
"""

import ctypes
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dllama_tpu.ops import q40 as jq40
from dllama_tpu_torch.ops import _build, q8 as tq8, q40 as tq40

N_SMS = 132  # an H100 SXM
MATMUL_TOL = 1e-5  # f32 summation order only (see module docstring)
# (n, d) of the five Llama-2-7B sites and Mixtral-8x7B's wqkv, up/gate, down
SITES = [(4096, 12288), (4096, 4096), (4096, 22016), (11008, 4096), (4096, 32000),
         (4096, 6144), (4096, 14336), (14336, 4096)]
# one wave of f32 output tiles (two 64 x 128 or one 128 x 128 tile an SM)
SCRATCH_BOUND = N_SMS * 128 * 128 * 4


@pytest.mark.parametrize("t", [1, 2, 3, 4, 5, 8, 16, 17, 64, 128])
def test_route_by_rows(t):
    assert tq40.route(t) == ("gemv" if t < tq40.T_MMA else "mma")
    assert 1 < tq40.T_MMA <= tq40.MMA_BMS[-1]


@pytest.mark.parametrize("t", [16, 128])
@pytest.mark.parametrize("n,d", SITES)
def test_mma_plan_covers_n_and_bounds_scratch(n, d, t):
    bm, splits, per = tq40.mma_plan(t, n, d, N_SMS)
    assert bm in tq40.MMA_BMS and bm >= t
    steps = -(-n // tq40.MMA_BK)
    assert splits * per >= steps and (splits - 1) * per < steps  # all of n, no empty split
    tiles = -(-t // bm) * -(-d // tq40.MMA_BN)
    assert splits == 1 or splits * tiles <= tq40.MMA_BLOCKS_PER_SM[bm] * N_SMS
    assert (splits * t * d * 4 if splits > 1 else 0) <= SCRATCH_BOUND


@pytest.mark.parametrize("t", [512, 4096])
@pytest.mark.parametrize("n,d", SITES)
def test_mma_plan_at_scoring_widths(n, d, t):
    """A scoring or long prefill forward (B·bucket rows, thousands) takes
    the tallest tile; at 7B widths the output tiles alone fill the wave, so
    the split count falls to 1 and no split scratch is allocated."""
    bm, splits, per = tq40.mma_plan(t, n, d, N_SMS)
    assert bm == tq40.MMA_BMS[-1]
    steps = -(-n // tq40.MMA_BK)
    assert splits * per >= steps and (splits - 1) * per < steps
    assert splits == 1


def test_7b_wo_scratch_against_the_gemv_plan():
    """wo (4096→4096) at t = 128: 8 MB of split scratch, against the decode
    body's 8 splits of 16 quantization blocks, whose sums meet in a
    workspace of 8 splits × 32 tiles × 8 rows × 128 f32 (1 MB), one row
    at decode (128 KB), and a count a tile."""
    bm, splits, _ = tq40.mma_plan(128, 4096, 4096, N_SMS)
    assert (bm, splits) == (128, 4)
    assert splits * 128 * 4096 * 4 == 8 << 20
    g_splits, per = tq40.gemv_plan(4096, 4096, N_SMS)
    assert (g_splits, per) == (8, 16)
    assert tq40.gemv_workspace_bytes(g_splits, 128, 4096) == (1 << 20) + 32 * 4
    assert tq40.gemv_workspace_bytes(g_splits, 1, 4096) == (128 << 10) + 32 * 4


def test_q8_shares_the_plan():
    assert tq8.mma_plan is tq40.mma_plan
    assert (tq8.MMA_BN, tq8.MMA_BK, tq8.MMA_BMS) == (tq40.MMA_BN, tq40.MMA_BK, tq40.MMA_BMS)
    assert tq8.MMA_BLOCKS_PER_SM is tq40.MMA_BLOCKS_PER_SM


def _qt(seed, lead, n, d):
    rng = np.random.RandomState(seed)
    qvals = rng.randint(-8, 8, size=(*lead, n, d)).astype(np.int8)
    scales = (rng.rand(*lead, n // 32, d) * 0.02 + 1e-3).astype(np.float16)
    return qvals, scales


def test_wrappers_refuse_cpu_tensors_by_name_and_count_nothing():
    """At t >= T_MMA both wrappers take the tensor-core body, which launches
    on CUDA tensors or raises; an unknown body raises too."""
    qt = tq40.pack_planes(*_qt(1, (2,), 64, 48))
    bqt = tq40.to_blocked(qt)
    x = torch.ones(tq40.T_MMA, 64)
    tq40.reset_counters()
    with pytest.raises(ValueError, match="q40_matmul_mma: x must be a CUDA tensor"):
        tq40.q40_matmul(x, qt.qpacked, qt.scales, 64, 1)
    with pytest.raises(ValueError, match="q40_matmul_blocked_mma: x must be a CUDA tensor"):
        tq40.q40_blocked_matmul(x, bqt.qpacked, bqt.scales, (64, 48), 1)
    for call in (lambda b: tq40.q40_matmul(x, qt.qpacked, qt.scales, 64, 1, body=b),
                 lambda b: tq40.q40_blocked_matmul(x, bqt.qpacked, bqt.scales, (64, 48), 1,
                                                   body=b)):
        with pytest.raises(ValueError, match="unknown body 'wgmma'"):
            call("wgmma")
    c = tq40.counters()
    assert (c["kernel_launches"], c["blocked_launches"], c["mma_launches"]) == (0, 0, 0)
    assert c["launches_by_shape"] == {}


@pytest.mark.parametrize("t", [1, 16, 128])
def test_cpu_dispatch_counts_plain_only(t):
    qt = tq40.pack_planes(*_qt(2, (), 64, 32))
    tq40.reset_counters()
    out = tq40.matmul(torch.ones(t, 64, dtype=torch.bfloat16), qt)
    assert out.shape == (t, 32)
    c = tq40.counters()
    assert "mma_launches" in c
    assert (c["kernel_launches"], c["mma_launches"], c["plain_calls"]) == (0, 0, 1)
    assert c["launches_by_shape"] == {}


def test_bind_declares_the_tensor_core_entry_points():
    """Pointers and the stream cross ctypes as c_void_p (64-bit); the plan
    and copy widths, then the variant (kernels 1-2) or kernel 3's tile
    shape, as c_int."""
    class Fake:
        class _Fn:
            pass
        q40_matmul = _Fn()
        q40_matmul_blocked = _Fn()
        q40_matmul_mma = _Fn()
        q40_matmul_blocked_mma = _Fn()
        q40_error_string = _Fn()
        tp_allreduce = _Fn()
        tp_enable_peer = _Fn()

    lib = tq40.bind(Fake())
    vp, ci = ctypes.c_void_p, ctypes.c_int
    assert lib.q40_matmul_mma.argtypes == [vp] * 6 + [ci] * 11 + [vp]
    assert lib.q40_matmul_blocked_mma.argtypes == [vp] * 6 + [ci] * 13 + [vp]
    assert lib.q40_matmul_mma.restype is ci and lib.q40_matmul_blocked_mma.restype is ci


def test_library_hash_covers_the_shared_header(monkeypatch, tmp_path):
    """An edit to csrc/mma_common.cuh names another library (a rebuild)."""
    src = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, src)
    monkeypatch.setattr(_build, "CSRC", str(src))
    assert "mma_common.cuh" in _build.HEADERS
    before = _build.library_path()
    assert before == _build.library_path()
    with open(src / "mma_common.cuh", "a") as f:
        f.write("\n// edited\n")
    assert _build.library_path() != before


@pytest.mark.parametrize("tiles,widths", [((512, 2048), (16, 16)), ((256, 384), (16, 16)),
                                          ((32, 100), (4, 8))])
def test_blocked_copy_widths(tiles, widths):
    """Kernel 3's tensor-core body copies value rows of td bytes and scale
    rows of 2·td: the widest cp.async that divides both (so a copy never
    crosses a column tile) and the plane's address."""
    tn, td = tiles
    for base in (0, 256, 1 << 20):
        got = (tq40._copy_width(td, base), tq40._copy_width(2 * td, base))
        assert got == widths
        assert td % got[0] == 0 and (2 * td) % got[1] == 0
    assert tq40._copy_width(td, 4) == 4  # a pointer 4 bytes off a 16-byte line


# ---------------------------------------------------------------------------
# The tile walk, transcribed from csrc/q40_matmul.cu (RowMajor and Blocked's
# cursor, step_rows, vcol, scol; stage_packed, stage_scale; the dequant
# lambda)
# ---------------------------------------------------------------------------

class _RowMajor:
    """The layouts' step addressing: ``cursor(b0)`` at a split's first
    block, ``step_rows`` the offsets of a step's two blocks, moving the
    cursor on to the next step's."""

    def __init__(self, d):
        self.stride = self.cols = d

    def cursor(self, b0):
        return [b0]

    def step_rows(self, cur):
        b, d = cur[0], self.stride
        cur[0] += 2
        return (b * 16 * d, (b + 1) * 16 * d), (b * d, (b + 1) * d)

    def vcol(self, c):
        return c

    scol = vcol


class _Blocked:
    def __init__(self, bn, td, nj):
        self.bn, self.td, self.nj = bn, td, nj
        self.stride, self.cols = td, nj * td

    def cursor(self, b0):
        return list(divmod(b0 * 16, self.bn))

    def _next(self, q, rem):
        return (q + 1, 0) if rem + 16 == self.bn else (q, rem + 16)

    def step_rows(self, cur):
        bn, td, nj = self.bn, self.td, self.nj
        q, rem = cur
        q1, rem1 = self._next(q, rem)
        cur[:] = self._next(q1, rem1)
        return (((q * nj * bn + rem) * td, (q1 * nj * bn + rem1) * td),
                ((q * nj * (bn // 16) + rem // 16) * td, (q1 * nj * (bn // 16) + rem1 // 16) * td))

    def vcol(self, c):
        return (c // self.td) * self.bn * self.td + c % self.td

    def scol(self, c):
        return (c // self.td) * (self.bn // 16) * self.td + c % self.td


def _bf16(a: np.ndarray) -> np.ndarray:
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(torch.bfloat16) \
        .to(torch.float32).numpy()


def _tile_walk(x, qflat, sflat, lay, n, d, w_al, s_al, n_sms):
    """What the tensor-core body computes from one plane's flat bytes:
    the ``mma_plan`` grid's tiles, each step staged through ``lay`` in
    copies of ``w_al``/``s_al`` bytes (0: byte/scale loads), unpacked to
    bf16, products summed in f32, splits added in split order."""
    t = x.shape[0]
    xb = _bf16(x)
    _, splits, per = tq40.mma_plan(t, n, d, n_sms)
    steps, nb = -(-n // 64), n // 32
    parts = np.zeros((splits, t, d), np.float32)
    wn, sn = w_al or 1, (s_al or 2) // 2  # bytes, scales a copy
    for z in range(splits):
        for col0 in range(0, d, 128):
            vc = min(128, lay.cols - col0)
            acc = np.zeros((t, 128), np.float32)
            cur = lay.cursor(z * per * 2)
            for s in range(z * per, min(steps, (z + 1) * per)):
                k0 = s * 64
                n_blk = nb - k0 // 32
                vrow, srow = lay.step_rows(cur)
                tile = np.zeros((32, 128), np.uint8)
                scl = np.zeros((2, 128), np.float16)
                for r in range(32):
                    if r >> 4 >= n_blk:
                        continue
                    for i in range(0, min(128, vc) - wn + 1, wn):
                        off = vrow[r >> 4] + lay.vcol(col0 + i) + (r & 15) * lay.stride
                        tile[r, i:i + wn] = qflat[off:off + wn]
                for r in range(min(2, n_blk)):
                    for i in range(0, min(128, vc) - sn + 1, sn):
                        off = srow[r] + lay.scol(col0 + i)
                        scl[r, i:i + sn] = sflat[off:off + sn]
                w = np.zeros((64, 128), np.float32)
                for r in range(32):
                    lo = 32 * (r >> 4) + (r & 15)
                    s_row = scl[r >> 4].astype(np.float32)
                    w[lo] = ((tile[r] & 15).astype(np.float32) - 8) * s_row
                    w[lo + 16] = ((tile[r] >> 4).astype(np.float32) - 8) * s_row
                xt = np.zeros((t, 64), np.float32)
                xt[:, :min(64, n - k0)] = xb[:, k0:k0 + 64]
                acc += xt @ _bf16(w)
            w_cols = min(128, d - col0)
            parts[z, :, col0:col0 + w_cols] = acc[:, :w_cols]
    out = parts[0].copy()
    for z in range(1, splits):
        out += parts[z]
    return out


@pytest.mark.parametrize("n_sms", [1, N_SMS], ids=["one_split", "one_step_splits"])
@pytest.mark.parametrize("tiles", [None, (32, 100), (64, 128)],
                         ids=["row_major", "blocked_32x100", "blocked_64x128"])
def test_tile_walk_matches_jax_pallas_interpret(tiles, n_sms):
    """n = 1056 (n/32 odd: the last step's second block is zero-filled),
    d = 200 (the second column tile holds 72 live columns), t = 17, plane 1
    of 2: the tile walk in either layout ≡ the JAX stacked (blocked) Pallas
    kernel in interpret mode; the two layouts walk to the same bits."""
    n, d, t, layer = 1056, 200, 17, 1
    qvals, scales = _qt(3, (2,), n, d)
    x = np.random.RandomState(4).randn(t, n).astype(np.float32)
    jqt, tqt = jq40.pack_planes(qvals, scales), tq40.pack_planes(qvals, scales)
    rm = _tile_walk(x, tqt.qpacked[layer].numpy().ravel(), tqt.scales[layer].numpy().ravel(),
                    _RowMajor(d), n, d, tq40._copy_width(d, 0), tq40._copy_width(2 * d, 0),
                    n_sms)
    if tiles is None:
        got, jw = rm, jqt
    else:
        bqt = tq40.to_blocked(tqt, *tiles)
        _, _, nj, bn, td = bqt.qpacked.shape
        got = _tile_walk(x, bqt.qpacked[layer].numpy().ravel(),
                         bqt.scales[layer].numpy().ravel(), _Blocked(bn, td, nj), n, d,
                         tq40._copy_width(td, 0), tq40._copy_width(2 * td, 0), n_sms)
        np.testing.assert_array_equal(got, rm)
        jw = jq40.to_blocked(jqt, *tiles)
    ref = np.asarray(jq40.matmul(jnp.asarray(x), jq40.QLayerView(jw, jnp.int32(layer)),
                                 impl="pallas_interpret"))
    np.testing.assert_allclose(got, ref, rtol=0, atol=MATMUL_TOL * np.abs(ref).max())
