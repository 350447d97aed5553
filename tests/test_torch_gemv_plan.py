"""The host side of the decode body of the Q40 and Q80 kernels (kernels
1–3 and 5–6 below ``T_MMA`` rows; ``csrc/gemv_common.cuh``,
``ops/q40.py`` ``gemv_plan`` and ``_gemv_width``), on the CPU.  The body
itself runs only on the card (``chip_smoke.py`` phases 2, 9 and 13).

Its walk is held to the JAX package's Pallas kernels (interpret mode)
through a numpy transcription of what each lane does: the split and chunk
ranges of ``gemv_plan``, each warp's run of quantization blocks, the row
pieces a lane reads through the row-major or blocked layout, the weights
it builds with the exponent-field trick and an exact FMA, rounded to bf16
in pairs of rows 32b + r and 32b + 16 + r, the m16n8k16 fragments they
fill, and the partials added in warp order, then the splits' sums in
split order.
Tolerance 1e-5 · max|ref|: the same bf16 products summed in f32 in
another order.  The trick itself is checked exhaustively: every finite
f16 scale, every nibble and every int8.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dllama_tpu.ops import q8 as jq8, q40 as jq40
from dllama_tpu_torch.ops import q8 as tq8, q40 as tq40

N_SMS = 132  # an H100 SXM
MATMUL_TOL = 1e-5  # f32 summation order only (see module docstring)
WEIGHTS_A_BYTE = {"q40": 2, "q8": 1}
# (n, d) of the sites the card runs: Llama-2-7B's five, Mixtral-8x7B's wqkv,
# up/gate and down, a rank's 7B slices at tp = 2, and the ragged shape
SHAPES = [(4096, 12288), (4096, 4096), (4096, 22016), (11008, 4096), (4096, 32000),
          (4096, 6144), (4096, 14336), (14336, 4096),
          (4096, 2048), (2048, 4096), (4096, 5504), (5504, 4096), (4096, 16000),
          (4128, 1000)]


def _walk_ranges(n, splits, per, t):
    """The quantization blocks each (split, row group, chunk, warp) of the
    kernel walks, in the kernel's order (csrc/gemv_common.cuh
    gemv_kernel)."""
    nb = n // 32
    for rank in range(splits):
        b_begin = min(nb, rank * per)
        b_end = min(nb, b_begin + per)
        for g0 in range(0, t, tq40.GEMV_ROWS):
            tg = min(tq40.GEMV_ROWS, t - g0)
            chunk = tq40.GEMV_SMEM_BYTES // 4 // (16 * tg)
            for cb in range(b_begin, b_end, chunk):
                ln = min(chunk, b_end - cb)
                wper = -(-ln // tq40.GEMV_WARPS)
                for warp in range(tq40.GEMV_WARPS):
                    k0, k1 = cb + min(ln, warp * wper), cb + min(ln, (warp + 1) * wper)
                    yield rank, g0, warp, range(k0, k1)


@pytest.mark.parametrize("codec", ["q40", "q8"])
@pytest.mark.parametrize("t", [1, 2, 3, 4])
@pytest.mark.parametrize("n,d", SHAPES)
def test_gemv_plan_covers_each_block_once(n, d, t, codec):
    """Every row group of every split walks each quantization block of n
    exactly once, and no split is empty or shorter than GEMV_MIN_SPLIT
    blocks unless n is."""
    splits, per = tq40.gemv_plan(n, d, N_SMS, WEIGHTS_A_BYTE[codec])
    nb = n // 32
    assert splits >= 1 and (splits - 1) * per < nb <= splits * per
    assert splits == 1 or nb - (splits - 1) * per >= 1 and per >= tq40.GEMV_MIN_SPLIT
    for g0 in range(0, t, tq40.GEMV_ROWS):
        seen = [b for _, g, _, blocks in _walk_ranges(n, splits, per, t) if g == g0
                for b in blocks]
        assert sorted(seen) == list(range(nb))


@pytest.mark.parametrize("codec", ["q40", "q8"])
@pytest.mark.parametrize("n,d", SHAPES)
def test_gemv_plan_fills_the_card(n, d, codec):
    """The grid gives the 132 SMs at least 0.7 blocks each where n allows
    the splits, and a split grid stays within one wave of two blocks an
    SM."""
    splits, per = tq40.gemv_plan(n, d, N_SMS, WEIGHTS_A_BYTE[codec])
    blocks = -(-d // tq40.GEMV_COLS[WEIGHTS_A_BYTE[codec]]) * splits
    assert blocks >= 0.7 * N_SMS or per < 2 * tq40.GEMV_MIN_SPLIT
    assert splits == 1 or blocks <= tq40.GEMV_BLOCKS_PER_SM * N_SMS


@pytest.mark.parametrize("t", [1, 2, 3, 4, 8, 17, 128])
@pytest.mark.parametrize("n,d", SHAPES)
def test_gemv_workspace_is_bounded(n, d, t):
    """The workspace where a tile's splits meet holds at most one wave of
    blocks' sums (at t = 1 under 140 KB for Q40, 270 KB for Q80; at 8
    rows and more 1.1 MB) and is none when n is not split; a block's shared
    memory holds a chunk of x pairs (at least one quantization block a
    warp at any t) and then every warp's partials."""
    tg = min(t, tq40.GEMV_ROWS)
    for per_byte in (2, 1):
        splits, _ = tq40.gemv_plan(n, d, N_SMS, per_byte)
        ws = tq40.gemv_workspace_bytes(splits, t, d, per_byte)
        cols = tq40.GEMV_COLS[per_byte]
        wave = tq40.GEMV_BLOCKS_PER_SM * N_SMS * tg * cols * 4
        assert ws <= wave + -(-d // cols) * 4 <= 1.1 * 2**20
        assert t > 1 or ws <= (140 << 10 if per_byte == 2 else 270 << 10)
        assert (ws == 0) == (splits == 1)
    assert tq40.GEMV_SMEM_BYTES // 4 // (16 * tg) >= tq40.GEMV_WARPS
    for cols in tq40.GEMV_COLS.values():
        assert tq40.GEMV_WARPS * tg * cols * 4 <= tq40.GEMV_SMEM_BYTES


@pytest.mark.parametrize("n,d", SHAPES)
def test_gemv_plan_is_a_function_of_the_shape(n, d):
    """The same shape always gives the same plan (a call is repeatable bit
    for bit), Q80 shares the function, and the 7B plans are as documented."""
    for per_byte in (2, 1):
        assert tq40.gemv_plan(n, d, N_SMS, per_byte) == tq40.gemv_plan(n, d, N_SMS, per_byte)
    assert tq8.gemv_plan is tq40.gemv_plan
    assert tq40.gemv_plan(4096, 12288, N_SMS) == (2, 64)
    assert tq40.gemv_plan(4096, 4096, N_SMS) == (8, 16)
    assert tq40.gemv_plan(4096, 32000, N_SMS) == (1, 128)


@pytest.mark.parametrize("row_bytes,vptr,sptr,cols,want", [
    (4096, 0, 0, 16, 16), (4096, 0, 0, 8, 8), (1000, 0, 0, 16, 8), (100, 0, 0, 16, 4),
    (4128, 4, 8, 16, 4), (999, 0, 0, 16, 1), (2048, 0, 8, 16, 4)])
def test_gemv_load_width(row_bytes, vptr, sptr, cols, want):
    """The widest value piece that divides the row stride (d, or td
    blocked: no piece crosses a column tile) and both pointers."""
    w = tq40._gemv_width(row_bytes, vptr, sptr, cols)
    assert w == want
    assert row_bytes % w == 0 and vptr % w == 0 and sptr % min(16, 2 * w) == 0


# ---------------------------------------------------------------------------
# The exponent-field trick: the float 2^(23-p) + v from a field at mantissa
# bit p, then fma(2^(23-p) + v, s, -(2^(23-p) + bias) s) = (v - bias) s
# ---------------------------------------------------------------------------

def _f16_scales() -> np.ndarray:
    s = np.arange(1 << 16, dtype=np.uint32).astype(np.uint16).view(np.float16)
    return s[np.isfinite(s)].astype(np.float64)


def _fma_f32(f, s, c):
    """fma on f32 operands: exact in float64 here (at most 24 + 11 bits a
    product), one rounding to f32."""
    return (f * s + c).astype(np.float32)


@pytest.mark.parametrize("p", [8, 12, 16])
def test_q4_field_fma_is_exact(p):
    """Every nibble at every position the Q4 codec uses, every finite f16
    scale: the constant is an exact f32, and the FMA gives f32((nib - 8)·s)
    exactly, so its bf16 round is the plain version's."""
    s = _f16_scales()
    c = -(2.0 ** (23 - p) + 8) * s
    np.testing.assert_array_equal(c.astype(np.float32).astype(np.float64), c)
    for nib in range(16):
        bits = np.uint32(((nib << p) & (0xF << p)) ^ ((150 - p) << 23))
        f = float(np.array(bits, np.uint32).view(np.float32))
        assert f == 2.0 ** (23 - p) + nib
        got = _fma_f32(f, s, c.astype(np.float32).astype(np.float64))
        np.testing.assert_array_equal(got, ((nib - 8) * s).astype(np.float32))


def test_q8_field_fma_is_exact():
    """Every int8 byte (sign bit flipped into 2^15 + 128 + v), every finite
    f16 scale: the FMA gives f32(v·s) exactly."""
    s = _f16_scales()
    c = -(2.0 ** 15 + 128) * s
    np.testing.assert_array_equal(c.astype(np.float32).astype(np.float64), c)
    for b in range(256):
        v = b - 256 if b >= 128 else b
        bits = np.uint32(((b << 8) & 0xFF00) ^ 0x47008000)
        f = float(np.array(bits, np.uint32).view(np.float32))
        assert f == 2.0 ** 15 + 128 + v
        np.testing.assert_array_equal(_fma_f32(f, s, c), (v * s).astype(np.float32))


# ---------------------------------------------------------------------------
# The walk, transcribed from csrc/gemv_common.cuh (the Q4/Q8 codecs' rows
# and pairs, gemv_load's pieces, gemv_mma's fragments, the reductions)
# ---------------------------------------------------------------------------

def _bf16(a: np.ndarray) -> np.ndarray:
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(torch.bfloat16) \
        .to(torch.float32).numpy()


class _RowMajor:
    def __init__(self, d, rpb):
        self.stride = self.cols = d
        self.rpb = rpb

    def rows(self, b):  # gemv_rows: the block's first stored row, its scale row
        return b * self.rpb * self.stride, b * self.stride

    def vcol(self, c):
        return c

    scol = vcol


class _Blocked:
    def __init__(self, bn, td, nj):
        self.bn, self.td, self.nj = bn, td, nj
        self.stride, self.cols = td, nj * td

    def rows(self, b):  # the cursor's (q, rem) of block b
        q, rem = divmod(b * 16, self.bn)
        return ((q * self.nj * self.bn + rem) * self.td,
                (q * self.nj * (self.bn // 16) + rem // 16) * self.td)

    def vcol(self, c):
        return (c // self.td) * self.bn * self.td + c % self.td

    def scol(self, c):
        return (c // self.td) * (self.bn // 16) * self.td + c % self.td


def _lane_block(qflat, sflat, lay, b, tile0, gid, tig, codec, vw):
    """One lane's share of block b: value bytes (kRows, kCols) and f32
    scales (kCols), zero where a piece is past the stored width."""
    cols = 16 if codec == "q40" else 8
    rows = ([tig + 4 * j for j in range(4)] if codec == "q40"
            else [tig + 4 * (j & 3) + 16 * (j >> 2) for j in range(8)])
    vr, sr = lay.rows(b)
    v = np.zeros((len(rows), cols), np.uint8)
    s = np.zeros(cols, np.float32)
    for p in range(cols // vw):
        c = tile0 + cols * gid + p * vw
        if c + vw > lay.cols:
            continue
        for j, r in enumerate(rows):
            off = vr + r * lay.stride + lay.vcol(c)
            v[j, p * vw:(p + 1) * vw] = qflat[off:off + vw]
        off = sr + lay.scol(c)
        s[p * vw:(p + 1) * vw] = sflat[off:off + vw].astype(np.float32)
    return v, s


def _pairs(v, s, codec):
    """Codec::pair for every pair row j and column c of a lane's block: the
    weights of rows 32b + r (lo) and 32b + 16 + r (hi), f32 → bf16."""
    if codec == "q40":
        lo, hi = (v & 15).astype(np.float32) - 8, (v >> 4).astype(np.float32) - 8
    else:
        q = v.view(np.int8).astype(np.float32)
        lo, hi = q[:4], q[4:]
    return _bf16(lo * s), _bf16(hi * s)


def _decode_walk(x, qflat, sflat, lay, n, d, codec, vw, n_sms):
    """What the decode body computes from one plane's flat bytes."""
    t = x.shape[0]
    xb = _bf16(x)
    cols = 16 if codec == "q40" else 8
    splits, per = tq40.gemv_plan(n, d, n_sms, WEIGHTS_A_BYTE[codec])
    out = np.zeros((t, d), np.float32)
    for tile0 in range(0, d, 8 * cols):
        part = {}
        for rank, g0, warp, blocks in _walk_ranges(n, splits, per, t):
            tg = min(tq40.GEMV_ROWS, t - g0)
            acc = part.setdefault((rank, g0, warp), np.zeros((8 * cols, tg), np.float32))
            for b in blocks:
                # the mma operands of the block, lane by lane: A (16 columns
                # of a tile i, k16 of step k), B (k16, the 8 rows of x)
                a = np.zeros((cols // 2, 2, 16, 16), np.float32)
                bx = np.zeros((2, 16, 8), np.float32)
                for gid in range(8):
                    for tig in range(4):
                        v, s = _lane_block(qflat, sflat, lay, b, tile0, gid, tig, codec, vw)
                        lo, hi = _pairs(v, s, codec)
                        for k in range(2):
                            for h in range(2):  # a0/a1 (pair tig) or a2/a3 (tig + 4)
                                j, kc = 2 * k + h, 2 * tig + 8 * h
                                # columns 2i: mma row gid; 2i + 1: row gid + 8
                                a[:, k, gid, kc], a[:, k, gid, kc + 1] = lo[j, 0::2], hi[j, 0::2]
                                a[:, k, gid + 8, kc] = lo[j, 1::2]
                                a[:, k, gid + 8, kc + 1] = hi[j, 1::2]
                                if gid < tg:  # x pairs of row gid: (32b + r, 32b + 16 + r)
                                    r = tig + 4 * j
                                    bx[k, kc:kc + 2, gid] = xb[g0 + gid, [32 * b + r,
                                                                         32 * b + 16 + r]]
                for i in range(cols // 2):
                    for k in range(2):
                        dm = (a[i, k].astype(np.float64) @ bx[k].astype(np.float64))[:, :tg]
                        # D rows gid -> column cols*gid + 2i, gid + 8 -> + 2i + 1
                        for m in range(16):
                            c = cols * (m % 8) + 2 * i + m // 8
                            acc[c] = (acc[c] + dm[m]).astype(np.float32)
        for g0 in range(0, t, tq40.GEMV_ROWS):
            tg = min(tq40.GEMV_ROWS, t - g0)
            tot = np.zeros((8 * cols, tg), np.float32)
            for rank in range(splits):  # each split's warps, then the splits
                s_rank = np.zeros((8 * cols, tg), np.float32)
                for warp in range(tq40.GEMV_WARPS):
                    s_rank = s_rank + part.get((rank, g0, warp), 0)
                tot = s_rank if splits == 1 else tot + s_rank
            w = min(8 * cols, d - tile0)
            out[g0:g0 + tg, tile0:tile0 + w] = tot[:w].T
    return out


def _qt(seed, lead, n, d):
    rng = np.random.RandomState(seed)
    qvals = rng.randint(-8, 8, size=(*lead, n, d)).astype(np.int8)
    scales = (rng.rand(*lead, n // 32, d) * 0.02 + 1e-3).astype(np.float16)
    return qvals, scales


@pytest.mark.parametrize("t", [1, 3])
@pytest.mark.parametrize("n_sms", [1, N_SMS], ids=["one_split", "two_splits"])
@pytest.mark.parametrize("tiles", [None, (32, 100)], ids=["row_major", "blocked_32x100"])
def test_q4_decode_walk_matches_jax_pallas_interpret(tiles, n_sms, t):
    """n = 1056 (33 quantization blocks: ragged warp and split ranges),
    d = 200 (the second column tile holds 72 live columns), plane 1 of 2:
    the walk in either layout ≡ the JAX stacked (blocked) Pallas kernel in
    interpret mode; the two layouts walk to the same bits."""
    n, d, layer = 1056, 200, 1
    qvals, scales = _qt(3, (2,), n, d)
    x = np.random.RandomState(4).randn(t, n).astype(np.float32)
    jqt, tqt = jq40.pack_planes(qvals, scales), tq40.pack_planes(qvals, scales)
    rm = _decode_walk(x, tqt.qpacked[layer].numpy().ravel(),
                      tqt.scales[layer].numpy().ravel(), _RowMajor(d, 16), n, d, "q40",
                      tq40._gemv_width(d, 0, 0, 16), n_sms)
    if tiles is None:
        got, jw = rm, jqt
    else:
        bqt = tq40.to_blocked(tqt, *tiles)
        _, _, nj, bn, td = bqt.qpacked.shape
        got = _decode_walk(x, bqt.qpacked[layer].numpy().ravel(),
                           bqt.scales[layer].numpy().ravel(), _Blocked(bn, td, nj), n, d,
                           "q40", tq40._gemv_width(td, 0, 0, 16), n_sms)
        np.testing.assert_array_equal(got, rm)
        jw = jq40.to_blocked(jqt, *tiles)
    ref = np.asarray(jq40.matmul(jnp.asarray(x), jq40.QLayerView(jw, jnp.int32(layer)),
                                 impl="pallas_interpret"))
    np.testing.assert_allclose(got, ref, rtol=0, atol=MATMUL_TOL * np.abs(ref).max())


@pytest.mark.parametrize("t", [1, 4])
def test_q8_decode_walk_matches_jax_pallas_interpret(t):
    """Q80 at n = 1056, d = 72 (two 64-column tiles, the second 8 live),
    plane 2 of 3, two splits: the walk ≡ the JAX stacked Pallas kernel."""
    n, d, layer = 1056, 72, 2
    w = (np.random.RandomState(5).randn(3, n, d) * 0.1).astype(np.float32)
    x = np.random.RandomState(6).randn(t, n).astype(np.float32)
    tqt = tq8.quantize(w)
    got = _decode_walk(x, tqt.qpacked[layer].numpy().view(np.uint8).ravel(),
                       tqt.scales[layer].numpy().ravel(), _RowMajor(d, 32), n, d, "q8",
                       tq40._gemv_width(d, 0, 0, 8), N_SMS)
    ref = np.asarray(jq8.matmul(jnp.asarray(x), jq40.QLayerView(jq8.quantize(w),
                                                                jnp.int32(layer)),
                                impl="pallas_interpret"))
    np.testing.assert_allclose(got, ref, rtol=0, atol=MATMUL_TOL * np.abs(ref).max())
