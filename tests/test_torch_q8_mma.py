"""The Q80 kernel's tensor-core body (kernels 5–6 at t >= ``q8.T_MMA``
rows: ``csrc/wgmma_matmul.cuh`` over the Q8 codec, ``ops/q8.py``
``mma_plan``, ``mma_tma``, ``MMA_SMEM``, ``MMA_STAGES``), on the CPU.  The
kernel itself runs only on the card (``chip_smoke.py`` phase 9).

What is transcribed from the source and held here: the block's shared
memory (``WgShape<Q8, BM>``) and where TMA's 128-byte swizzle writes a
step's two 32-row int8 boxes (``vsw``); the A registers a consumer thread
fills (``Wg<Q8>::frags``) against wgmma's A fragment and the epilogue's
columns, and its loads' banks; the weight arithmetic (``q8_field``, one
byte permute and one FFMA), emulated in float32, against the plain
version's ``bf16(f32(v)·f32(s))``; and the tile walk (the producer's TMA
box coordinates, ``tma_rows<32>``, or its copies, ``step_rows<32>``,
``copy_vals``, ``copy_scales``; the transposed product y^T = W^T x^T; the
split sums in order) against the JAX package's stacked Pallas kernel in
interpret mode.  Tolerance of the walk: 1e-5 · max|ref|, the same bf16
products summed in f32 in another order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dllama_tpu.ops import q8 as jq8, q40 as jq40
from dllama_tpu_torch.ops import q8 as tq8, q40 as tq40

N_SMS = 132  # an H100 SXM
MATMUL_TOL = 1e-5  # f32 summation order only (see module docstring)
MAX_SMEM = 232448  # the opt-in shared memory of a block (csrc/mma_common.cuh kMaxSmem)
RPB = 32  # stored int8 rows a quantization block (gemv_common.cuh Q8::kRowsPerBlock)
# (n, d) of every Q80 site the card runs: Llama-2-7B, Mixtral-8x7B, Grok-1's
# experts, a rank's slices of the 7B sites at tp = 2, and the ragged shape
SITES = [(4096, 12288), (4096, 4096), (4096, 22016), (11008, 4096), (4096, 32000),
         (4096, 6144), (4096, 14336), (14336, 4096), (6144, 32768), (32768, 6144),
         (4096, 2048), (2048, 4096), (4096, 5504), (5504, 4096), (4096, 16000), (4128, 1000)]


def _swizzle(lin):
    """The 128-byte swizzle on a shared address: bits 4-6 ^= bits 7-9."""
    return lin ^ (((lin >> 7) & 7) << 4)


def _vsw(r, c):
    """wgmma_matmul.cuh vsw: byte (r, c) of a block's swizzled value tile."""
    return r * 128 + ((((c >> 4) ^ r) & 7) << 4) + (c & 15)


def _offsets(bm):
    """WgShape<Q8, BM>'s carve-up from the 1024-byte-aligned base: x tiles,
    value tiles, scale rows, barriers (no block sums); and the total."""
    stages = tq8.MMA_STAGES[bm]
    x = bm * tq8.MMA_BK * 2
    vals = 2 * RPB * tq8.MMA_BN
    v_off = stages * x
    s_off = v_off + stages * vals
    bar_off = s_off + stages * 4 * tq8.MMA_BN
    return x, vals, v_off, s_off, bar_off, bar_off + 16 * stages + 1024


@pytest.mark.parametrize("bm", tq8.MMA_BMS)
def test_the_block_fits_and_its_tiles_sit_on_1024(bm):
    """Each tile height's 8-stage ring fits the opt-in shared memory (~197
    KB at 128 rows); the x tiles and each quantization block's 32 int8 rows
    (4096 bytes) start on 1024 bytes, where the 128-byte swizzle's pattern
    starts (it acts on absolute address bits 4-9), the scale rows on 128,
    the barriers on 8; MMA_SMEM is the source's layout."""
    x, vals, v_off, s_off, bar_off, smem = _offsets(bm)
    assert smem == tq8.MMA_SMEM[bm] <= MAX_SMEM
    assert (tq8.MMA_BN, tq8.MMA_BK) == (tq40.MMA_BN, tq40.MMA_BK) == (128, 64)
    assert vals == 8192 and x % 1024 == 0 and v_off % 1024 == 0
    for stage in range(tq8.MMA_STAGES[bm]):
        for b in range(2):
            assert (v_off + stage * vals + b * RPB * 128) % 1024 == 0
    assert s_off % 128 == 0 and bar_off % 8 == 0
    # a stage: x tile, 8 KB of values, two scale rows, two barriers
    assert tq8.MMA_SMEM[bm] - 1024 == tq8.MMA_STAGES[bm] * (x + vals + 512 + 16)


def test_the_swizzled_int8_tile_is_tmas():
    """TMA writes byte (r, c) of a 32 x 128 box, 128-byte swizzled, at the
    swizzle of r·128 + c from the box's 1024-aligned start; the consumers
    and the fallback copies address it as vsw(r, c): every byte of a step's
    two boxes reads back where TMA put it, and vsw is a permutation of each
    row's 128 bytes."""
    rng = np.random.RandomState(0)
    step = rng.randint(-128, 128, size=(2 * RPB, 128)).astype(np.int8)
    smem = np.zeros(2 * RPB * 128, np.int8)
    for b in range(2):  # one TMA box a quantization block
        for r in range(RPB):
            for c in range(128):
                smem[b * RPB * 128 + _swizzle(r * 128 + c)] = step[b * RPB + r, c]
    for r in range(2 * RPB):
        b, rb = divmod(r, RPB)
        got = [smem[b * RPB * 128 + _vsw(rb, c)] for c in range(128)]
        assert got == list(step[r])
        assert sorted(_vsw(rb, c) - rb * 128 for c in range(128)) == list(range(128))


def _frag_bytes(wg, w, lane):
    """Wg<Q8>::frags transcribed: for k16 slice kk = 2b + h and register e,
    the (step row, column) of the bytes its two bf16 halves come from.  The
    thread loads the 16-bit piece (c, c+1) of block b's rows r = 16h + 2q,
    r + 1 into word v (bytes: (r, c), (r, c+1), (r+1, c), (r+1, c+1)) and
    of rows r + 8, r + 9 into w; register 0 takes q8_field<0>, <2> of v,
    register 1 <1>, <3> of v, registers 2, 3 the same of w."""
    q, g = lane & 3, lane >> 2
    c = 64 * wg + 16 * w + 2 * g
    regs = {}
    for kk in range(4):
        b, h = divmod(kk, 2)
        r = 16 * h + 2 * q
        vbytes = [(r, c), (r, c + 1), (r + 1, c), (r + 1, c + 1)]
        wbytes = [(r + 8, c), (r + 8, c + 1), (r + 9, c), (r + 9, c + 1)]
        for e, (word, ks) in enumerate(((vbytes, (0, 2)), (vbytes, (1, 3)),
                                        (wbytes, (0, 2)), (wbytes, (1, 3)))):
            regs[(kk, e)] = tuple((RPB * b + word[k][0], word[k][1]) for k in ks)
    return regs


def test_dequant_fragments_are_the_a_operand_wgmma_reads():
    """wgmma's A fragment (m64 x k16, bf16): warp w of a warpgroup holds A
    rows 16w..16w+15; register 0 of lane (g, q) row g at k 2q, 2q+1,
    register 1 row g+8 there, registers 2, 3 the same at k 2q+8, 2q+9.  The
    dequant must put there the weight of step row 16 kk + k and of the
    output column the epilogue writes A row rho to (rho = 16w + g → column
    64 wg + 16w + 2g, rho + 8 → that + 1).  Every weight of a step's 64 x
    128 tile sits in exactly one thread's registers, and a warp's 16-bit
    loads of one row offset (2q, 2q+1, 2q+8 or 2q+9 below 16h) meet no
    bank conflict: the lanes of a word share it, the words fall in
    distinct banks."""
    seen = []
    for wg in range(2):
        for w in range(4):
            for lane in range(32):
                q, g = lane & 3, lane >> 2
                for (kk, e), halves in _frag_bytes(wg, w, lane).items():
                    rho = 16 * w + g + (8 if e in (1, 3) else 0)
                    col = 64 * wg + 16 * w + 2 * g + (rho - 16 * w - g) // 8
                    ks = (2 * q, 2 * q + 1) if e < 2 else (2 * q + 8, 2 * q + 9)
                    assert halves == tuple((16 * kk + k, col) for k in ks)
                    seen.extend(halves)
            for h in range(2):
                for off in (0, 1, 8, 9):
                    banks = {}
                    for lane in range(32):
                        q, g = lane & 3, lane >> 2
                        addr = _vsw(16 * h + 2 * q + off, 64 * wg + 16 * w + 2 * g)
                        banks.setdefault((addr // 4) % 32, set()).add(addr // 4)
                    assert all(len(words) == 1 for words in banks.values())
    assert sorted(seen) == [(k, c) for k in range(tq8.MMA_BK) for c in range(tq8.MMA_BN)]


def _bf16(a) -> np.ndarray:
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(torch.bfloat16) \
        .to(torch.float32).numpy()


def _q8_weight(v: np.ndarray, s: np.ndarray) -> np.ndarray:
    """Wg<Q8>::frags's arithmetic in float32: the byte XORed with 0x80 and
    permuted to mantissa bits 8..15 under 0x47 (the float 2^15 + 128 + v),
    then fma(that, s, -32896 s) (the product exact inside the FMA; in
    float64 here, where both products and the sum are exact, then to
    float32), then rounded to bf16 to nearest even."""
    u = (v.astype(np.int64) & 0xFF) ^ 0x80
    field = ((0x47 << 24) | (u << 8)).astype(np.uint32).view(np.float32)
    s32 = s.astype(np.float32)
    m = np.float32(-32896.0) * s32  # exact in float32: 9 bits times 11
    assert np.array_equal(m.astype(np.float64), -32896.0 * s32.astype(np.float64))
    f = (field.astype(np.float64) * s32.astype(np.float64) + m.astype(np.float64))
    return _bf16(f.astype(np.float32))


def test_the_ffma_trick_is_the_plain_dequant_for_every_code_and_scale():
    """For all 256 int8 codes and a sweep of f16 scales (zero, the smallest
    subnormal, subnormals, 1, the largest finite, both signs, and a random
    spread): the kernel's weight equals bf16(f32(v)·f32(s)), the plain
    version's (q8.dequantize), bit for bit, and the permuted field is
    2^15 + 128 + v."""
    codes = np.arange(-128, 128, dtype=np.int8)
    special = np.array([0.0, 2.0 ** -24, 3 * 2.0 ** -24, 2.0 ** -15, 1.0, 65504.0],
                       np.float16)
    rnd = (np.random.RandomState(1).rand(200) * 8 - 4).astype(np.float32)
    scales = np.concatenate([special, -special, np.exp2(rnd * 4).astype(np.float16),
                             (np.random.RandomState(2).rand(200) * 0.02).astype(np.float16)])
    assert np.isfinite(scales).all()
    u = (codes.astype(np.int64) & 0xFF) ^ 0x80
    field = ((0x47 << 24) | (u << 8)).astype(np.uint32).view(np.float32)
    np.testing.assert_array_equal(field, 32896.0 + codes.astype(np.float32))
    v, s = np.meshgrid(codes, scales, indexing="ij")
    got = _q8_weight(v, s)
    want = _bf16(v.astype(np.float32) * s.astype(np.float32))
    np.testing.assert_array_equal(got, want)
    # and the port's plain version dequantizes a plane of every code (8
    # quantization blocks by 32 columns, each its own scale) to the same bits
    plane = np.repeat(codes[:, None], 32, 1)
    sc = scales[:256].reshape(8, 32)
    qt = tq8.Q8Tensor(torch.from_numpy(plane), torch.from_numpy(sc), (256, 32))
    np.testing.assert_array_equal(tq8.dequantize(qt).to(torch.float32).numpy(),
                                  _q8_weight(plane, np.repeat(sc, 32, 0)))


@pytest.mark.parametrize("case", ["7b_wqkv", "7b_wcls", "tp2_w1", "tp2_wo", "ragged_d1000",
                                  "misaligned_values", "misaligned_scales"])
def test_weights_go_by_tma_where_the_boxes_fit(case):
    """The int8 values and the scales go by TMA boxes where the rows (d
    bytes; scale rows 2d) and both pointers are on 16 bytes: the 7B sites
    and a rank's slices at tp = 2 (d = 5504 and 4096); else by the
    producer's copies (the ragged d = 1000, a pointer off 16 bytes), whose
    widths divide the rows and the pointer."""
    d, vptr, sptr, want = {
        "7b_wqkv": (12288, 0, 1 << 20, True),
        "7b_wcls": (32000, 256, 512, True),
        "tp2_w1": (5504, 0, 1 << 20, True),
        "tp2_wo": (4096, 0, 4096, True),
        "ragged_d1000": (1000, 0, 1 << 20, False),
        "misaligned_values": (4096, 4, 0, False),
        "misaligned_scales": (4096, 0, 8, False),
    }[case]
    assert tq8.mma_tma(d, vptr, sptr) is want
    w, sw = tq40._copy_width(d, vptr), tq40._copy_width(2 * d, sptr)
    assert w == 0 or (d % w == 0 and vptr % w == 0)
    assert sw == 0 or ((2 * d) % sw == 0 and sptr % sw == 0)
    if case == "ragged_d1000":
        assert (w, sw) == (8, 16)


@pytest.mark.parametrize("bm", tq8.MMA_BMS)
def test_x_tile_is_the_b_operand_wgmma_reads(bm):
    """The x tile of each tile height (the 16-row one: wgmma m64n16k16):
    TMA's 128-byte swizzle writes element k of row r of the 64 x BM box at
    r·128 + ((k / 8) ^ (r % 8))·16 + 2 (k % 8) from its stage's start;
    wgmma's K-major B operand of k16 slice kk reads from sw128_desc(x + 32
    kk, -, SBO = 1024), its row (N index) n at (n % 8)·128 + (n / 8)·SBO +
    2 k before the swizzle.  The accumulator the epilogue writes row 8j +
    2q + e from is 4j + e (column c) and 4j + 2 + e (column c + 1): each of
    the BM x 128 outputs once."""
    x = bm * tq8.MMA_BK * 2
    for stage in range(tq8.MMA_STAGES[bm]):
        base = stage * x
        assert base % 1024 == 0
        tma = {(r, k): base + r * 128 + (((k // 8) ^ (r % 8)) << 4) + 2 * (k % 8)
               for r in range(bm) for k in range(tq8.MMA_BK)}
        assert len(set(tma.values())) == bm * tq8.MMA_BK
        for kk in range(tq8.MMA_BK // 16):
            for nrow in range(bm):
                for kl in range(16):
                    lin = base + 32 * kk + (nrow % 8) * 128 + (nrow // 8) * 1024 + 2 * kl
                    assert _swizzle(lin) == tma[(nrow, 16 * kk + kl)]
    out = set()
    for wg in range(2):
        for w in range(4):
            for lane in range(32):
                q, g = lane & 3, lane >> 2
                for j in range(bm // 8):
                    for e in range(2):
                        for dc in range(2):
                            out.add((8 * j + 2 * q + e, 64 * wg + 16 * w + 2 * g + dc))
    assert out == {(r, c) for r in range(bm) for c in range(tq8.MMA_BN)}


def _check_plan(plan, t, n, d):
    """Every step of n once, no split empty, at most MMA_MAX_WAVES waves of
    blocks when split, so the split scratch is at most that many waves of
    f32 output tiles; and the plan is the cost model's best over every
    split count, at Q80's own step times."""
    bm, bn, splits, per = plan
    assert bm == min([b for b in tq8.MMA_BMS if b >= t] or [max(tq8.MMA_BMS)])
    assert bn == tq8.MMA_BN and set(tq8.MMA_STEP_US) == set(tq8.MMA_BMS)
    steps = -(-n // tq8.MMA_BK)
    assert splits * per >= steps and (splits - 1) * per < steps
    tiles = -(-t // bm) * -(-d // bn)
    waves = tq40.MMA_MAX_WAVES
    assert splits == 1 or splits * tiles <= waves * N_SMS
    assert (splits * t * d * 4 if splits > 1 else 0) <= waves * N_SMS * bm * bn * 4

    def cost(s_):
        p_ = -(-steps // s_)
        return (-(-tiles * s_ // N_SMS) * p_ * tq8.MMA_STEP_US[bm]
                + (s_ > 1) * (2 * s_ + 1) * t * d * 4 / tq40.MMA_SCRATCH_RATE)
    legal = [s_ for s_ in range(1, steps + 1) if -(-steps // -(-steps // s_)) == s_
             and (s_ == 1 or s_ * tiles <= waves * N_SMS)]
    assert cost(splits) == min(cost(s_) for s_ in legal)


@pytest.mark.parametrize("t", [5, 16, 17, 128, 512])
@pytest.mark.parametrize("n,d", SITES)
def test_mma_plan_covers_n_and_bounds_scratch(n, d, t):
    """The 7B, Mixtral, Grok-1, tp = 2 and ragged sites at the rows the
    paths launch (5: the narrowest tensor-core call, q8.T_MMA; 16: the 16-row tile's
    widest; 17: the 32-row tile's narrowest; 128: prompt and mixed steps;
    512: a long prefill), on the Q40 body's cost model (q40.plan_wgmma) at
    Q80's tile heights and MMA_STEP_US."""
    plan = tq8.mma_plan(t, n, d, N_SMS)
    _check_plan(plan, t, n, d)
    assert plan == tq40.plan_wgmma(t, n, d, N_SMS, tq8.MMA_STEP_US)


# ---------------------------------------------------------------------------
# The tile walk, transcribed from csrc/wgmma_matmul.cuh (the producer's
# tma_rows<32> and step_rows<32>, copy_vals<N, 32>, copy_scales; the
# consumers' dequant and products; the epilogue; reduce_splits)
# ---------------------------------------------------------------------------

def _box(rows2d, row, col, h, w):
    """A TMA box of h x w at (row, col) of a 2-D map: zeros past its dims."""
    out = np.zeros((h, w), rows2d.dtype)
    r1, c1 = min(row + h, rows2d.shape[0]), min(col + w, rows2d.shape[1])
    if r1 > row and c1 > col:
        out[:r1 - row, :c1 - col] = rows2d[row:r1, col:c1]
    return out


def _stage(qflat, sflat, d, b0, col0, n_blk, tma, w_al, s_al):
    """Step s's int8 tile (64 x 128) and scale rows (2 x 128) as the
    producer stages them, b0 = 2 s its first block: two TMA boxes a block
    at stored rows 32 b and scale row b, or its copies of w_al / s_al bytes
    (0: byte or scale loads) from offsets b·32·d and b·d, stored columns
    past vc and blocks past n zero."""
    tile = np.zeros((2 * RPB, 128), np.int8)
    scl = np.zeros((2, 128), np.float16)
    if tma:
        vrows, srows = qflat.reshape(-1, d), sflat.reshape(-1, d)
        for b in range(2):
            tile[RPB * b:RPB * (b + 1)] = _box(vrows, RPB * (b0 + b), col0, RPB, 128)
            scl[b] = _box(srows, b0 + b, col0, 1, 128)[0]
        return tile, scl
    vrow = (b0 * RPB * d, (b0 + 1) * RPB * d)
    srow = (b0 * d, (b0 + 1) * d)
    vc = min(128, d - col0)
    wn, sn = w_al or 1, (s_al or 2) // 2  # bytes, scales a copy
    for r in range(2 * RPB):
        if r // RPB >= n_blk:
            continue
        for c in range(0, 128, wn):
            if c + wn <= vc:
                off = vrow[r // RPB] + col0 + c + (r % RPB) * d
                tile[r, c:c + wn] = qflat[off:off + wn]
    for r in range(min(2, n_blk)):
        for c in range(0, 128, sn):
            if c + sn <= vc:
                off = srow[r] + col0 + c
                scl[r, c:c + sn] = sflat[off:off + sn]
    return tile, scl


def _tile_walk(x, qflat, sflat, n, d, tma, w_al, s_al, n_sms):
    """What the tensor-core body computes from one plane's flat bytes: the
    ``mma_plan`` grid's tiles, each step staged as the producer stages it,
    dequantized as the consumers do (blocks past n zero), the transposed
    product y^T += W^T x^T summed in f32 a step, splits added in split
    order."""
    t = x.shape[0]
    xb = _bf16(x)
    plan = tq8.mma_plan(t, n, d, n_sms)
    steps, nb = -(-n // 64), n // 32
    parts = np.zeros((plan.splits, t, d), np.float32)
    for z in range(plan.splits):
        for col0 in range(0, d, 128):
            acc_t = np.zeros((128, t), np.float32)  # the accumulators: (column, row of x)
            for s in range(z * plan.steps_per, min(steps, (z + 1) * plan.steps_per)):
                k0 = s * 64
                tile, scl = _stage(qflat, sflat, d, 2 * s, col0, nb - k0 // 32, tma,
                                   w_al, s_al)
                w = np.zeros((64, 128), np.float32)
                for b in range(2):
                    if 2 * s + b < nb:  # a block past n holds no weights
                        w[RPB * b:RPB * (b + 1)] = _q8_weight(
                            tile[RPB * b:RPB * (b + 1)],
                            np.broadcast_to(scl[b], (RPB, 128)))
                xt = np.zeros((t, 64), np.float32)
                xt[:, :min(64, n - k0)] = xb[:, k0:k0 + 64]
                acc_t += w.T @ xt.T
            w_cols = min(128, d - col0)
            parts[z, :, col0:col0 + w_cols] = acc_t[:w_cols].T
    out = parts[0].copy()
    for z in range(1, plan.splits):
        out += parts[z]
    return out


@pytest.mark.parametrize("t", [9, 17], ids=["t9_bm16", "t17_bm32"])
@pytest.mark.parametrize("d", [200, 208], ids=["d200_copies", "d208_tma"])
@pytest.mark.parametrize("n_sms", [1, N_SMS], ids=["one_split", "many_splits"])
def test_tile_walk_matches_jax_pallas_interpret(n_sms, d, t):
    """n = 1056 (n/32 odd: the last step's second block is past n; the
    planes are padded to 2048 rows), d = 200 or 208 (the second column tile
    holds 72 or 80 live columns), t = 9 or 17 (the 16- and the 32-row
    tile, rows past t zero), plane 1 of a (2, 2) expert stack
    by its flat index: the tile walk ≡ the JAX stacked Pallas kernel
    (``_pallas_matmul_stacked``) in interpret mode.  d = 200 (rows off 16
    bytes) goes by the producer's copies (8 / 16 bytes), d = 208 by TMA
    boxes; where TMA can take a plane, its copies give the same bits."""
    n, layer = 1056, 1
    w = (np.random.RandomState(3).randn(2, 2, n, d) * 0.1).astype(np.float32)
    x = np.random.RandomState(4).randn(t, n).astype(np.float32)
    jqt, tqt = jq8.quantize(w), tq8.quantize(w)
    flat_v = tqt.qpacked.reshape(4, -1, d)[layer].numpy().ravel()
    flat_s = tqt.scales.reshape(4, -1, d)[layer].numpy().ravel()
    widths = tq40._copy_width(d, 0), tq40._copy_width(2 * d, 0)
    tma = tq8.mma_tma(d, 0, 0)
    assert tma == (d % 16 == 0)
    got = _tile_walk(x, flat_v, flat_s, n, d, False, *widths, n_sms)
    if tma:
        np.testing.assert_array_equal(
            _tile_walk(x, flat_v, flat_s, n, d, True, *widths, n_sms), got)
    if n_sms == 1:
        assert tq8.mma_plan(t, n, d, n_sms).splits <= 2
    else:
        assert tq8.mma_plan(t, n, d, n_sms).splits > 2
    view = jq40.QLayerView(jqt, jnp.int32(0)).select(jnp.int32(layer), 2)
    ref = np.asarray(jq8.matmul(jnp.asarray(x), view, impl="pallas_interpret"))
    np.testing.assert_allclose(got, ref, rtol=0, atol=MATMUL_TOL * np.abs(ref).max())
    # and the port's plain version, the one the kernel is held to on the card
    plain = tq8.matmul(torch.from_numpy(x), tqt, layer=layer).numpy()
    np.testing.assert_allclose(got, plain, rtol=0, atol=MATMUL_TOL * np.abs(plain).max())
