"""The host side of the Q40 kernel's tensor-core body (kernels 1–3 at
t >= ``q40.T_MMA`` rows; ``ops/q40.py`` ``route``, ``mma_plan``,
``mma_tma``, ``_copy_width``, the wrappers' ``body`` and counters,
``bind``, and the build's hash of the shared headers), on the CPU.  The
kernel itself runs only on the card (``chip_smoke.py`` phases 2, 2v, 9b
and 13).

Its tile walk is held to the JAX package's Pallas kernels (interpret mode)
through a numpy transcription of what a block stages: 64-row steps of two
quantization blocks, each block's 16 packed rows and its scale row read
as the producer reads them (TMA boxes at the coordinates it computes from
the row-major or blocked layout, or its copies of the width the wrapper
picks), blocks past n zero, the nibbles unpacked to logical rows 32b + r
and 32b + 16 + r, the splits of ``mma_plan`` added in order.  Tolerance
1e-5 · max|ref|: the same bf16 products summed in f32 in another order.
The registers the dequant fills are checked against wgmma's A fragment,
and the x tile TMA writes against the addresses the B descriptor reads.
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
# (n, d) of the five Llama-2-7B sites and Mixtral-8x7B's wqkv, up/gate,
# down, and the ragged shape (n/32 odd, d off 16 bytes)
SITES = [(4096, 12288), (4096, 4096), (4096, 22016), (11008, 4096), (4096, 32000),
         (4096, 6144), (4096, 14336), (14336, 4096), (4128, 1000)]
MAX_SMEM = 232448  # the opt-in shared memory of a block (csrc/mma_common.cuh kMaxSmem)


def _check_plan(plan, t, n, d):
    """Every step of n once, no split empty, at most MMA_MAX_WAVES waves of
    blocks when split, so the split scratch is at most that many waves of
    f32 output tiles; and the plan is the cost model's best over every
    split count (waves x steps x a step's time + the scratch's traffic)."""
    bm, bn, splits, per = plan
    assert bm in tq40.MMA_BMS and bn == tq40.MMA_BN
    assert tq40.MMA_SMEM[bm] <= MAX_SMEM
    steps = -(-n // tq40.MMA_BK)
    assert splits * per >= steps and (splits - 1) * per < steps  # all of n, no empty split
    tiles = -(-t // bm) * -(-d // bn)
    waves = tq40.MMA_MAX_WAVES
    assert splits == 1 or splits * tiles <= waves * N_SMS
    assert (splits * t * d * 4 if splits > 1 else 0) <= waves * N_SMS * bm * bn * 4

    def cost(s_):
        p_ = -(-steps // s_)
        return (-(-tiles * s_ // N_SMS) * p_ * tq40.MMA_STEP_US[bm]
                + (s_ > 1) * (2 * s_ + 1) * t * d * 4 / tq40.MMA_SCRATCH_RATE)
    legal = [s_ for s_ in range(1, steps + 1) if -(-steps // -(-steps // s_)) == s_
             and (s_ == 1 or s_ * tiles <= waves * N_SMS)]
    assert cost(splits) == min(cost(s_) for s_ in legal)


@pytest.mark.parametrize("t", [1, 2, 3, 4, 5, 8, 16, 17, 64, 128])
def test_route_by_rows(t):
    assert tq40.route(t) == ("gemv" if t < tq40.T_MMA else "mma")
    assert 1 < tq40.T_MMA <= tq40.MMA_BMS[-1]


@pytest.mark.parametrize("t", [16, 128])
@pytest.mark.parametrize("n,d", SITES)
def test_mma_plan_covers_n_and_bounds_scratch(n, d, t):
    """Up to 32 rows the 32-row tile, to 128 the 128-row tile."""
    plan = tq40.mma_plan(t, n, d, N_SMS)
    _check_plan(plan, t, n, d)
    assert plan.bm == (32 if t <= 32 else 128)


@pytest.mark.parametrize("t", [512, 4096])
@pytest.mark.parametrize("n,d", SITES)
def test_mma_plan_at_scoring_widths(n, d, t):
    """A scoring or long prefill forward (B·bucket rows, thousands) takes
    the 128-row tile; at 7B widths the output tiles alone fill the waves,
    so no split scratch is allocated."""
    plan = tq40.mma_plan(t, n, d, N_SMS)
    _check_plan(plan, t, n, d)
    assert plan.bm == 128
    if d >= 4096:
        assert plan.splits == 1


def test_7b_wo_scratch_against_the_gemv_plan():
    """wo (4096→4096) at t = 128: 8 MB of split scratch, against the decode
    body's 8 splits of 16 quantization blocks, whose sums meet in a
    workspace of 8 splits × 32 tiles × 8 rows × 128 f32 (1 MB), one row
    at decode (128 KB), and a count a tile."""
    bm, _, splits, _ = tq40.mma_plan(128, 4096, 4096, N_SMS)
    assert (bm, splits) == (128, 4)
    assert splits * 128 * 4096 * 4 == 8 << 20
    g_splits, per = tq40.gemv_plan(4096, 4096, N_SMS)
    assert (g_splits, per) == (8, 16)
    assert tq40.gemv_workspace_bytes(g_splits, 128, 4096) == (1 << 20) + 32 * 4
    assert tq40.gemv_workspace_bytes(g_splits, 1, 4096) == (128 << 10) + 32 * 4


def test_q8_shares_the_plan():
    """The Q80 kernel's tensor-core body is the same template
    (csrc/wgmma_matmul.cuh) on its own step, so it takes the same plan
    (q40.plan_wgmma) at its own tile heights and measured step times: the
    128 x 64 step, Q40's tile heights and the 16-row one, 8 ring stages, and
    at every shape the grid the cost model puts first at Q80's
    MMA_STEP_US."""
    assert (tq8.MMA_BN, tq8.MMA_BK) == (tq40.MMA_BN, tq40.MMA_BK)
    assert set(tq40.MMA_BMS) < set(tq8.MMA_BMS) == set(tq8.MMA_STEP_US) == {16, 32, 128}
    assert set(tq40.MMA_STEP_US) == set(tq40.MMA_BMS)
    assert all(tq8.MMA_STAGES[bm] == tq40.MMA_STAGES[bm] for bm in tq40.MMA_BMS)
    for t, n, d in ((128, 4096, 4096), (16, 4096, 12288), (4096, 4096, 32000),
                    (128, 11008, 4096), (17, 4128, 1000)):
        assert tq8.mma_plan(t, n, d, N_SMS) == tq40.plan_wgmma(t, n, d, N_SMS,
                                                                tq8.MMA_STEP_US)
        assert tq40.mma_plan(t, n, d, N_SMS) == tq40.plan_wgmma(t, n, d, N_SMS,
                                                                 tq40.MMA_STEP_US)
    assert tq8.mma_plan(4096, 4096, 32000, N_SMS) == (128, 128, 1, 64)


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
    """Pointers and the stream cross ctypes as c_void_p (64-bit); the plan,
    TMA or not and the copy widths, then the variant (kernels 1-2) or
    kernel 3's tile shape, as c_int; the layout report takes a tile height
    and an int array."""
    class Fake:
        class _Fn:
            pass
        q40_matmul = _Fn()
        q40_matmul_blocked = _Fn()
        q40_matmul_mma = _Fn()
        q40_matmul_blocked_mma = _Fn()
        q40_mma_layout = _Fn()
        q40_error_string = _Fn()
        tp_allreduce = _Fn()
        tp_enable_peer = _Fn()

    lib = tq40.bind(Fake())
    vp, ci = ctypes.c_void_p, ctypes.c_int
    assert lib.q40_matmul_mma.argtypes == [vp] * 6 + [ci] * 12 + [vp]
    assert lib.q40_matmul_blocked_mma.argtypes == [vp] * 6 + [ci] * 14 + [vp]
    assert lib.q40_matmul_mma.restype is ci and lib.q40_matmul_blocked_mma.restype is ci
    assert lib.q40_mma_layout.argtypes == [ci, ctypes.POINTER(ci)]


@pytest.mark.parametrize("header", ["mma_common.cuh", "sm90_common.cuh", "wgmma_matmul.cuh"])
def test_library_hash_covers_the_shared_header(monkeypatch, tmp_path, header):
    """An edit to a shared header (the small shared pieces, the Hopper
    machinery of kernel 8 and the tensor-core body, or the tensor-core body
    both codecs instantiate) names another library (a rebuild)."""
    src = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, src)
    monkeypatch.setattr(_build, "CSRC", str(src))
    assert header in _build.HEADERS
    before = _build.library_path()
    assert before == _build.library_path()
    with open(src / header, "a") as f:
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


@pytest.mark.parametrize("case", ["rowmajor_7b", "rowmajor_ragged", "blocked_7b",
                                  "blocked_32x100", "misaligned_pointer"])
def test_weights_go_by_tma_where_the_boxes_fit(case):
    """The weights go by TMA boxes where their rows and pointers are on 16
    bytes and, blocked, the 128-column tile divides td; else by the
    producer's copies, whose widths divide the rows."""
    row_bytes, vptr, sptr, blocked, want = {
        "rowmajor_7b": (4096, 0, 1 << 20, False, True),
        "rowmajor_ragged": (1000, 0, 1 << 20, False, False),
        "blocked_7b": (2048, 256, 512, True, True),
        "blocked_32x100": (100, 0, 0, True, False),
        "misaligned_pointer": (4096, 4, 0, False, False),
    }[case]
    assert tq40.mma_tma(row_bytes, vptr, sptr, blocked) is want
    if not want:
        w, sw = tq40._copy_width(row_bytes, vptr), tq40._copy_width(2 * row_bytes, sptr)
        assert w == 0 or row_bytes % w == 0
        assert blocked <= (w > 0 and sw > 0)  # a blocked fallback never takes byte loads


# ---------------------------------------------------------------------------
# The operands wgmma reads, transcribed from csrc/q40_matmul.cu (WgShape,
# vsw, the dequant lambda, a_frag, `products`' descriptors, the epilogue)
# and csrc/sm90_common.cuh (sw128_desc): the dequantized weights are the A
# operand in registers, x the K-major B operand in shared memory
# ---------------------------------------------------------------------------

def _swizzle(lin):
    """The 128-byte swizzle on a shared address: bits 4-6 ^= bits 7-9."""
    return lin ^ (((lin >> 7) & 7) << 4)


def _offsets(bm):
    """WgShape's carve-up from the 1024-byte-aligned base: x tiles, packed
    tiles, scale rows, block sums, barriers; and the total."""
    x, stages = bm * tq40.MMA_BK * 2, tq40.MMA_STAGES[bm]
    v_off = stages * x
    s_off = v_off + stages * tq40.MMA_BK // 2 * tq40.MMA_BN
    bs_off = s_off + stages * 4 * tq40.MMA_BN
    bar_off = bs_off + 3 * 2 * bm * 4
    return x, v_off, s_off, bs_off, bar_off, bar_off + 16 * stages + 1024


def _vsw(r, c):
    """q40_matmul.cu vsw: byte (r, c) of a step's swizzled packed tile."""
    return r * 128 + ((((c >> 4) ^ r) & 7) << 4) + (c & 15)


@pytest.mark.parametrize("bm", [32, 128])
def test_the_block_fits_and_its_tiles_sit_where_tma_writes(bm):
    """Each tile height's ring fits the opt-in shared memory; the x tiles
    and each quantization block's 16 packed rows (2048 bytes) start on 1024
    bytes (the 128-byte swizzle acts on absolute address bits), the scale
    rows on 128, the barriers on 8; and the packed tile's swizzle is TMA's:
    byte c of row r at r·128 + ((c / 16) ^ (r % 8))·16 + c % 16."""
    x, v_off, s_off, bs_off, bar_off, smem = _offsets(bm)
    assert smem == tq40.MMA_SMEM[bm] <= MAX_SMEM
    assert x % 1024 == 0 and v_off % 1024 == 0 and (tq40.MMA_BK // 2 * tq40.MMA_BN) % 2048 == 0
    assert s_off % 128 == 0 and bs_off % 8 == 0 and bar_off % 8 == 0
    for r in range(32):
        for c in range(tq40.MMA_BN):
            b, rb = divmod(r, 16)
            assert b * 2048 + _vsw(rb, c) == _swizzle(r * 128 + c)


def _a_fragment(wg, w, lane):
    """What a consumer thread's dequant puts in its A registers: for k16
    slice kk and register e, the (logical row, column) of the tile that
    each of its two bf16 halves holds (a_frag over the bytes it loads)."""
    q, g = lane & 3, lane >> 2
    col = 64 * wg + 16 * w + 2 * g
    regs = {}
    for kk in range(4):
        blk, hi = divmod(kk, 2)
        for e, (rows, dc) in enumerate((((2 * q, 2 * q + 1), 0), ((2 * q, 2 * q + 1), 1),
                                        ((2 * q + 8, 2 * q + 9), 0),
                                        ((2 * q + 8, 2 * q + 9), 1))):
            # packed row pr of block blk: logical row 32 blk + pr (low
            # nibble) or 32 blk + 16 + pr (high)
            regs[(kk, e)] = tuple((32 * blk + 16 * hi + pr, col + dc) for pr in rows)
    return regs


def test_dequant_fragments_are_the_a_operand_wgmma_reads():
    """wgmma's A fragment (m64 x k16, bf16): warp w of a warpgroup holds
    rows 16w..16w+15; register 0 of lane (g, q) row g at k 2q, 2q+1,
    register 1 row g+8 there, registers 2, 3 the same at k 2q+8, 2q+9.  The
    dequant must put there the weight of logical row 16 kk + k and of the
    output column that the epilogue writes A row rho to (rho = 16w + g →
    column 64 wg + 16w + 2g, rho + 8 → that + 1).  Every weight of a step's
    64 x 128 tile sits in exactly one thread's registers, and a warp's four
    16-bit loads of a block (rows 2q, 2q+1, 2q+8, 2q+9, its columns) meet
    no bank conflict."""
    seen = set()
    for wg in range(2):
        for w in range(4):
            for lane in range(32):
                q, g = lane & 3, lane >> 2
                regs = _a_fragment(wg, w, lane)
                for (kk, e), halves in regs.items():
                    rho = 16 * w + g + (8 if e in (1, 3) else 0)
                    col = 64 * wg + 16 * w + 2 * g + (rho - 16 * w - g) // 8
                    ks = (2 * q, 2 * q + 1) if e < 2 else (2 * q + 8, 2 * q + 9)
                    assert halves == tuple((16 * kk + k, col) for k in ks)
                    seen.update(halves)
            for pr_of in (lambda q: 2 * q, lambda q: 2 * q + 1, lambda q: 2 * q + 8,
                          lambda q: 2 * q + 9):
                words = {}
                for lane in range(32):
                    q, g = lane & 3, lane >> 2
                    addr = _vsw(pr_of(q), 64 * wg + 16 * w + 2 * g)
                    words.setdefault((addr // 4) % 32, set()).add(addr // 4)
                assert all(len(v) == 1 for v in words.values())  # one word a bank
    assert seen == {(k, c) for k in range(tq40.MMA_BK) for c in range(tq40.MMA_BN)}


@pytest.mark.parametrize("bm", [32, 128])
def test_x_tile_is_the_b_operand_wgmma_reads(bm):
    """The x tile: TMA's 128-byte swizzle writes element k of row r of the
    64 x BM box at r·128 + ((k / 8) ^ (r % 8))·16 + 2 (k % 8); wgmma's
    K-major B operand of k16 slice kk reads from sw128_desc(x + 32 kk, -,
    SBO = 1024), its row (N index) n at (n % 8)·128 + (n / 8)·SBO + 2 k
    before the swizzle; the block sums read chunk (k / 8) ^ (r % 8) of row
    r.  The accumulator the epilogue writes row 8j + 2q + e from is
    4j + e (column c) and 4j + 2 + e (column c + 1): each of the BM x
    128 outputs once."""
    x, *_ = _offsets(bm)
    for stage in range(tq40.MMA_STAGES[bm]):
        base = stage * x
        tma = {(r, k): base + r * 128 + (((k // 8) ^ (r % 8)) << 4) + 2 * (k % 8)
               for r in range(bm) for k in range(tq40.MMA_BK)}
        assert len(set(tma.values())) == bm * tq40.MMA_BK
        for kk in range(tq40.MMA_BK // 16):
            start = base + 32 * kk
            for nrow in range(bm):
                for kl in range(16):
                    lin = start + (nrow % 8) * 128 + (nrow // 8) * 1024 + 2 * kl
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
    assert out == {(r, c) for r in range(bm) for c in range(tq40.MMA_BN)}


# ---------------------------------------------------------------------------
# The tile walk, transcribed from csrc/q40_matmul.cu (RowMajor and Blocked's
# cursor, step_rows, vcol, scol; the producer's TMA coordinates and its
# copies, copy_vals and copy_scales; the dequant lambda)
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

    def tma_rows(self, cur, ct):
        """q40_matmul.cu tma_rows: the stored rows of the step's two
        blocks' packed rows and scale rows, the cursor moved on."""
        b = cur[0]
        cur[0] += 2
        return (16 * b, 16 * b + 16), (b, b + 1)


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

    def tma_rows(self, cur, ct):
        bn, nj = self.bn, self.nj
        q, rem = cur
        q1, rem1 = self._next(q, rem)
        cur[:] = self._next(q1, rem1)
        return (((q * nj + ct) * bn + rem, (q1 * nj + ct) * bn + rem1),
                ((q * nj + ct) * (bn // 16) + rem // 16, (q1 * nj + ct) * (bn // 16) + rem1 // 16))


def _bf16(a: np.ndarray) -> np.ndarray:
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(torch.bfloat16) \
        .to(torch.float32).numpy()


def _box(rows2d, row, col, h, w):
    """A TMA box of h x w at (row, col) of a 2-D map: zeros past its dims."""
    out = np.zeros((h, w), rows2d.dtype)
    r1, c1 = min(row + h, rows2d.shape[0]), min(col + w, rows2d.shape[1])
    if r1 > row and c1 > col:
        out[:r1 - row, :c1 - col] = rows2d[row:r1, col:c1]
    return out


def _stage(qflat, sflat, lay, cur, col0, n_blk, tma, w_al, s_al):
    """A step's packed tile (32 x 128 bytes) and scale rows (2 x 128) as
    the producer stages them, moving the cursor on: two TMA boxes a
    quantization block at the rows ``tma_rows`` gives and the tile's
    column within its column tile, or its copies of w_al / s_al bytes (0:
    byte or scale loads) with stored columns past vc and blocks past n
    zero."""
    stride = lay.stride
    tile = np.zeros((32, 128), np.uint8)
    scl = np.zeros((2, 128), np.float16)
    if tma:
        vrows, srows = qflat.reshape(-1, stride), sflat.reshape(-1, stride)
        ct = col0 // stride
        vr, sr = lay.tma_rows(cur, ct)
        for b in range(2):
            tile[16 * b:16 * b + 16] = _box(vrows, vr[b], col0 - ct * stride, 16, 128)
            scl[b] = _box(srows, sr[b], col0 - ct * stride, 1, 128)[0]
        return tile, scl
    vrow, srow = lay.step_rows(cur)
    vc = min(128, lay.cols - col0)
    wn, sn = w_al or 1, (s_al or 2) // 2  # bytes, scales a copy
    for r in range(32):
        if r >> 4 >= n_blk:
            continue
        for c in range(0, 128, wn):
            if c + wn <= vc:
                off = vrow[r >> 4] + lay.vcol(col0 + c) + (r & 15) * stride
                tile[r, c:c + wn] = qflat[off:off + wn]
    for r in range(min(2, n_blk)):
        for c in range(0, 128, sn):
            if c + sn <= vc:
                off = srow[r] + lay.scol(col0 + c)
                scl[r, c:c + sn] = sflat[off:off + sn]
    return tile, scl


def _tile_walk(x, qflat, sflat, lay, n, d, tma, w_al, s_al, n_sms):
    """What the tensor-core body computes from one plane's flat bytes:
    the ``mma_plan`` grid's tiles, each step staged as the producer stages
    it, unpacked to bf16 (blocks past n zero), products summed in f32,
    splits added in split order."""
    t = x.shape[0]
    xb = _bf16(x)
    plan = tq40.mma_plan(t, n, d, n_sms)
    steps, nb = -(-n // 64), n // 32
    parts = np.zeros((plan.splits, t, d), np.float32)
    for z in range(plan.splits):
        for col0 in range(0, d, 128):
            acc = np.zeros((t, 128), np.float32)
            cur = lay.cursor(z * plan.steps_per * 2)
            for s in range(z * plan.steps_per, min(steps, (z + 1) * plan.steps_per)):
                k0 = s * 64
                tile, scl = _stage(qflat, sflat, lay, cur, col0, nb - k0 // 32, tma, w_al, s_al)
                w = np.zeros((64, 128), np.float32)
                for r in range(32):
                    if k0 // 32 + (r >> 4) >= nb:
                        continue  # a block past n holds no weights
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
    for z in range(1, plan.splits):
        out += parts[z]
    return out


@pytest.mark.parametrize("d", [200, 208], ids=["d200_copies", "d208_tma"])
@pytest.mark.parametrize("n_sms", [1, N_SMS], ids=["one_split", "one_step_splits"])
@pytest.mark.parametrize("tiles", [None, (32, 100), (64, 128)],
                         ids=["row_major", "blocked_32x100", "blocked_64x128"])
def test_tile_walk_matches_jax_pallas_interpret(tiles, n_sms, d):
    """n = 1056 (n/32 odd: the last step's second block is past n), d = 200
    or 208 (the second column tile holds 72 or 80 live columns), t = 17,
    plane 1 of 2: the tile walk in either layout ≡ the JAX stacked
    (blocked) Pallas kernel in interpret mode; the two layouts walk to the
    same bits.  Row-major d = 200 (rows off 16 bytes) and blocked (32, 100)
    go by the producer's copies, row-major d = 208 and blocked (64, 128)
    by TMA boxes; where TMA can take a plane, its copies give the same
    bits."""
    n, t, layer = 1056, 17, 1
    qvals, scales = _qt(3, (2,), n, d)
    x = np.random.RandomState(4).randn(t, n).astype(np.float32)
    jqt, tqt = jq40.pack_planes(qvals, scales), tq40.pack_planes(qvals, scales)
    qrm, srm = tqt.qpacked[layer].numpy().ravel(), tqt.scales[layer].numpy().ravel()
    widths = tq40._copy_width(d, 0), tq40._copy_width(2 * d, 0)
    rm = _tile_walk(x, qrm, srm, _RowMajor(d), n, d, False, *widths, n_sms)
    assert tq40.mma_tma(d, 0, 0, False) == (d % 16 == 0)
    if d % 16 == 0:
        np.testing.assert_array_equal(
            _tile_walk(x, qrm, srm, _RowMajor(d), n, d, True, *widths, n_sms), rm)
    if tiles is None:
        got, jw = rm, jqt
    else:
        bqt = tq40.to_blocked(tqt, *tiles)
        _, _, nj, bn, td = bqt.qpacked.shape
        tma = tq40.mma_tma(td, 0, 0, True)
        assert tma == (tiles == (64, 128))
        got = _tile_walk(x, bqt.qpacked[layer].numpy().ravel(),
                         bqt.scales[layer].numpy().ravel(), _Blocked(bn, td, nj), n, d, tma,
                         tq40._copy_width(td, 0), tq40._copy_width(2 * td, 0), n_sms)
        np.testing.assert_array_equal(got, rm)
        jw = jq40.to_blocked(jqt, *tiles)
    ref = np.asarray(jq40.matmul(jnp.asarray(x), jq40.QLayerView(jw, jnp.int32(layer)),
                                 impl="pallas_interpret"))
    np.testing.assert_allclose(got, ref, rtol=0, atol=MATMUL_TOL * np.abs(ref).max())
