"""K4 bf16's adjoint pass and K7 bf16 on their pipelined tensor-core walks
(csrc/mega_bwd.cu k_bwd_adjoint_bf16, csrc/fit_ngp.cu bfk::k_ngp_fit_bf16,
csrc/ngp_mma.cuh): the host's mirrors of their shared-memory layouts and
gates, the exactness of the operand forms the kernels rely on, and numpy
models of their walks. The kernels themselves run on the card only
(chip_smoke.py holds them to their plain versions there); their plain
versions are held to the JAX tiers by tests/test_torch_bf16.py and
tests/test_torch_ngp_tiers.py. Every check here is exact: integer layouts,
schedules, and float32 / bf16 identities checked bit for bit or value for
value.
"""

import numpy as np
import pytest

from phys_autodiff_tpu_torch import GridSpec
from phys_autodiff_tpu_torch.kernels import _build
from phys_autodiff_tpu_torch.kernels import fit as kfit
from phys_autodiff_tpu_torch.kernels import mega_bwd as kbwd
from phys_autodiff_tpu_torch.kernels.walk import num_blocks

G = GridSpec(nx=128, ny=96, nz=96)
ZC, TX, TY, NT, NW = 8, 32, 8, 256, 8


def _bf16(x):
    """float32 -> the nearest bf16 (ties to even), as float32."""
    b = np.asarray(x, dtype=np.float32).view(np.uint32).astype(np.uint64)
    b = (b + 0x7FFF + ((b >> 16) & 1)) & 0xFFFF0000
    return b.astype(np.uint32).view(np.float32)


# ---------------------------------------------------------------------------
# Layouts and gates
# ---------------------------------------------------------------------------


def _k4_bf16_parent_bytes(h):
    """The adjoint pass's layout before the redesign: dF and g/(2dt) in bf16
    twice (gyp, gyt), the CD rows [8][HP][3], the dW2T sums, the warps' dCD
    rows."""
    hp = (h + 15) & ~15
    return 8 * 2 * (NT * 8 + 4 * (NT + 16) * 2) + 4 * (8 * hp * 3 + 4 * hp) + 4 * 8 * 8 * 3 * 16


def test_k4_bf16_layout_admits_every_h_it_did_and_keeps_its_top():
    """The new layout ([dF | g/(2dt)] once, two chunks; the CD rows read
    through L1; two lanes' dCD partials a hidden unit) fits every H the
    tier took before, its gate keeps the top 1360, and two blocks share an
    SM at the flagship H = 128 (96,256 B with each thread's db2 sums)."""
    before = [h for h in range(1, 4097) if _k4_bf16_parent_bytes(h) + kbwd.SMEM_STATIC <= kbwd.SMEM_LIMIT]
    assert max(before) == 1360
    assert all(kbwd.mega_fits(G, h, "bf16") for h in before)
    assert all(kbwd.smem_bytes(h, "bf16") + kbwd.SMEM_STATIC <= kbwd.SMEM_LIMIT for h in before)
    assert _build.gate_top(lambda h: kbwd.mega_fits(G, h, "bf16")) == 1360
    assert not kbwd.mega_fits(G, 1361, "bf16") and not kbwd.mega_fits(G, 0, "bf16")
    assert kbwd.smem_bytes(128, "bf16") == 65536 + 16 * 128 + 24576 + 16 * 256 == 96256
    assert 2 * (kbwd.smem_bytes(128, "bf16") + kbwd.SMEM_STATIC + 1024) <= 228 * 1024
    # the f32 tier keeps its layout and its top
    assert kbwd.smem_bytes(128) == 81920 and _build.gate_top(lambda h: kbwd.mega_fits(G, h)) == 1300


@pytest.mark.parametrize("lf,top", [(1, 204), (8, 196), (16, 180), (64, 116), (17, 0), (33, 0), (48, 0)])
def test_k7_bf16_layout_fits_every_shape_the_gate_takes(lf, top):
    """K7 bf16's own layout (a ring of three encoding rows, gy of two rows,
    one or two dz1 rows; csrc/fit_ngp.cu bfk::fit_layout) fits a block at
    every (LF, H) the head core's gate takes, so the gate and its tops stay:
    H <= 204 / 196 / 180 / 116 at LF = 1 / 8 / 16 / 64 (top 0: not
    pinned)."""
    admitted = [h for h in range(1, 257) if kfit.ngp_fit_fits(lf, h)]
    if top:
        assert max(admitted) == top
    assert [h for h in range(1, 257) if kfit.ngp_fit_fits(lf, h, "bf16")] == admitted
    for h in admitted:
        assert kfit.ngp_fit_smem_bytes(lf, h, "bf16") + kfit.SMEM_STATIC <= kfit.SMEM_LIMIT


def test_k7_bf16_flagship_keeps_two_blocks_an_sm_with_two_dz1_rows():
    """LF = 16, H = 64: two dz1 buffers (dEnc of a row beside the next
    row's products, one barrier a row) in 106,624 B, under the two-block
    limit; past it the layout falls back to one buffer."""
    two = kfit._ngp_fit_bf16_layout(16, 64, 2)
    assert kfit.ngp_fit_smem_bytes(16, 64, "bf16") == two == 106624 <= kfit._SMEM_2BLK
    assert kfit.ngp_fit_smem_bytes(16, 64) == 100608  # the f32 kernel's layout is untouched
    assert kfit.ngp_fit_smem_bytes(64, 116, "bf16") == kfit._ngp_fit_bf16_layout(64, 116, 1)


# ---------------------------------------------------------------------------
# The operand forms
# ---------------------------------------------------------------------------


def _magnitudes(rng, n, lo=-40, hi=40):
    return (rng.choice([-1.0, 1.0], n) * rng.uniform(1.0, 2.0, n) * 2.0 ** rng.integers(lo, hi, n))


def test_half_zero_w2_fragments_give_each_leg_alone():
    """da1 for both legs from one [dF | q] row a cell: A = [W2 | 0] and
    [0 | W2] over the 8 values [dF | q] give W2 . dF and W2 . q, the other
    half's four products exact zeros (0 times a finite bf16), so each
    m16n8k8 sums the same four nonzero products as a 4-deep one; the
    products of bf16 values are exact in float32."""
    rng = np.random.default_rng(3)
    for _ in range(200):
        w2 = _bf16(_magnitudes(rng, 4, -20, 20))
        df, q = _bf16(_magnitudes(rng, 4)), _bf16(_magnitudes(rng, 4))
        row = np.concatenate([df, q])
        pt = np.concatenate([w2, np.zeros(4, np.float32)]).astype(np.float32) * row
        pq = np.concatenate([np.zeros(4, np.float32), w2]).astype(np.float32) * row
        assert np.array_equal(pt[:4].astype(np.float64), w2.astype(np.float64) * df.astype(np.float64))
        assert np.array_equal(pq[4:].astype(np.float64), w2.astype(np.float64) * q.astype(np.float64))
        assert not np.any(pt[4:]) and not np.any(pq[:4])


@pytest.mark.parametrize("masks", [(m, t, p) for m in (0, 1) for t in (0, 1) for p in (0, 1)])
def test_mask_arithmetic_equals_the_selects(masks):
    """B1 of the new K4 bf16 walk: with the masks as 0 / 1 floats,
    pq (fp - fm) is dz1_tm1 + dz1_tp1 (the -+ q legs cancel exactly),
    fmaf(pt, ft, that) is dz1_t + (dz1_tm1 + dz1_tp1) rounded once, and
    fmaf(-pq, fm, dc), fmaf(pt, ft, dc), fmaf(pq, fp, dc) are the dCD sums'
    adds: the values of the selects they replace, for every mask pattern."""
    fm, ft, fp = (np.float32(v) for v in masks)
    rng = np.random.default_rng(sum(k << i for i, k in enumerate(masks)))
    pt, pq, dc = (_magnitudes(rng, 4096).astype(np.float32) for _ in range(3))
    dm = np.where(fm > 0, -pq, np.float32(0))
    dt = np.where(ft > 0, pt, np.float32(0))
    dp = np.where(fp > 0, pq, np.float32(0))
    dmp = (pq * (fp - fm)).astype(np.float32)
    assert np.array_equal(dmp, (dm + dp).astype(np.float32))

    def fmaf(a, b, c):  # a b exact in float64 (b is 0 or 1), one rounding
        return (a.astype(np.float64) * np.float64(b) + c.astype(np.float64)).astype(np.float32)

    assert np.array_equal(fmaf(pt, ft, dmp), (dt + (dm + dp)).astype(np.float32))
    assert np.array_equal(fmaf(-pq, fm, dc), (dc + dm).astype(np.float32))
    assert np.array_equal(fmaf(pt, ft, dc), (dc + dt).astype(np.float32))
    assert np.array_equal(fmaf(pq, fp, dc), (dc + dp).astype(np.float32))


def test_relu_on_the_rounded_pair_is_the_rounded_relu():
    """The A fragments of dW2 (K4 bf16) and of layer 2 (K7 bf16) take the
    ReLU on packed bf16 pairs (mlp_mma.cuh relu2): bf16(max(x, 0)) =
    max(bf16(x), 0) in value for every float32 x, as rounding is monotone
    and keeps 0; the mask stays the float32 x > 0."""
    rng = np.random.default_rng(7)
    x = np.concatenate([_magnitudes(rng, 8192, -140, 128), [0.0, -0.0, 1e-45, -1e-45, 3.4e38, -3.4e38]])
    x = x.astype(np.float32)
    assert np.array_equal(_bf16(np.maximum(x, 0)), np.maximum(_bf16(x), 0))


def test_ldmatrix_trans_of_the_cotangent_rows_is_dw2s_operand():
    """One 16-byte row a cell, [gy_0..3 | 0 0 0 0] (K7) or [dF | q] (K4):
    ldmatrix gives lane (g, t) the values 2t, 2t + 1 of cell g (da1's B,
    k = values) and ldmatrix.trans the values g of cells 2t, 2t + 1 (dW2's
    B, k = cells): a model of both maps over 16 cells covers every (cell,
    value) once in each operand."""
    rows = np.arange(16 * 8).reshape(16, 8)  # (cell, value) -> a unique id
    plain, trans = [], []
    for j in range(2):  # the two 8 x 8 matrices: cells 8 j ..
        m = rows[8 * j:8 * j + 8]
        for lane in range(32):
            g, t = lane >> 2, lane & 3
            plain += [m[g, 2 * t], m[g, 2 * t + 1]]
            trans += [m[2 * t, g], m[2 * t + 1, g]]
    assert sorted(plain) == sorted(trans) == list(range(128))


# ---------------------------------------------------------------------------
# The walks
# ---------------------------------------------------------------------------


def _block_rows(nrows, nblk, b):
    return b * nrows // nblk, (b + 1) * nrows // nblk


def _chunks(r0, r1, nz):
    """mlp_head.cuh chunk_at over a block's range: (tile, z0, n)."""
    out, r = [], r0
    while r < r1:
        tile, z0 = divmod(r, nz)
        n = min(ZC, nz - z0, r1 - r)
        out.append((tile, z0, n))
        r += n
    return out


GRIDS = [(128, 96, 96), (24, 13, 5), (40, 9, 1), (33, 9, 150), (7, 3, 11), (36, 300, 40), (33, 17, 2)]


@pytest.mark.parametrize("dims", GRIDS)
def test_k4_bf16_walk_stages_each_row_once_before_its_products(dims):
    """k_bwd_adjoint_bf16's walk: every block stages the cotangents of each
    of its rows once (A), in the interval before the one whose products (B)
    read them, into the buffer B does not read then; A's rows of the next
    chunk fit the tile's 8 rows of cells that carry them (ZC <= TY), and
    every row of the grid belongs to exactly one block's chunk."""
    nx, ny, nz = dims
    g = GridSpec(nx=nx, ny=ny, nz=nz)
    ntiles = -(-nx // TX) * -(-ny // TY)
    nrows, nblk = ntiles * nz, num_blocks(g)
    seen = np.zeros(nrows, np.int64)
    for b in range(nblk):
        r0, r1 = _block_rows(nrows, nblk, b)
        chunks = _chunks(r0, r1, nz)
        staged = {}  # row -> (interval, buffer)
        for zl in range(chunks[0][2] if chunks else 0):
            staged[r0 + zl] = (-1, 0)
        r = r0
        for k, (tile, z0, n) in enumerate(chunks):
            assert n <= ZC <= TY and tile * nz + z0 == r
            for zl in range(n):  # B of chunk k reads buffer k & 1
                assert staged.pop(r + zl) == (k - 1, k & 1)
                seen[r + zl] += 1
            if k + 1 < len(chunks):  # A of chunk k + 1, rows at tile rows yl < its n
                nt, nz0, nn = chunks[k + 1]
                assert nn <= TY
                for zl in range(nn):
                    staged[nt * nz + nz0 + zl] = (k, (k + 1) & 1)
            r += n
        assert not staged
    assert np.all(seen == 1)


def test_k4_bf16_dcd_partials_cover_each_hidden_unit_twice_and_flush_once():
    """The dCD sums of a warp's 16 hidden units: after the shuffle with lane
    t ^ 1, lane (g, t) adds row g + 8 (t & 1) to slot t >> 1, so the 32
    lanes cover the 16 rows x 2 slots once; the flush loop (i over c.n x 3 x
    16 lanes-strided) reads every (row z, slice, hidden unit) once."""
    cover = [(g + 8 * (t & 1), t >> 1) for lane in range(32) for g, t in [(lane >> 2, lane & 3)]]
    assert sorted(cover) == [(h, s) for h in range(16) for s in range(2)]
    for n in range(1, ZC + 1):
        got = sorted((i // 48, (i // 16) % 3, i % 16) for lane in range(32) for i in range(lane, n * 48, 32))
        assert got == [(z, s, h) for z in range(n) for s in range(3) for h in range(16)]


@pytest.mark.parametrize("rows", [1, 2, 3, 4, 17, 18])
def test_k7_bf16_walk_keeps_three_rows_in_flight_without_a_hazard(rows):
    """k_ngp_fit_bf16's walk over a block's rows r0 .. r0 + rows - 1: the
    interval of row r runs dEnc of r - 1, the backward of r, the encoding
    copy of r + 2 and the forward of r + 1, one barrier an interval. In
    every interval no buffer is both written and read (encoding ring of
    3, gy and loss sums of 2, dz1 of 2), every buffer a step reads was
    written in an earlier interval and not overwritten since, and each row
    passes every stage once."""
    ops = {-2: [("w", "enc", 0, 0), ("w", "enc", 1, 1)], -1: [("r", "enc", 0, 0), ("w", "gy", 0, 0)]}
    if rows == 1:
        ops[-2] = ops[-2][:1]
    for i in range(rows):
        o = []
        if i > 0:
            o.append(("r", "dz", (i - 1) & 1, i - 1))
        o += [("r", "enc", i % 3, i), ("r", "gy", i & 1, i), ("w", "dz", i & 1, i)]
        if i + 2 < rows:
            o.append(("w", "enc", (i + 2) % 3, i + 2))
        if i + 1 < rows:
            o += [("r", "enc", (i + 1) % 3, i + 1), ("w", "gy", (i + 1) & 1, i + 1)]
        ops[i] = o
    ops[rows] = [("r", "dz", (rows - 1) & 1, rows - 1)]
    holds, stages = {}, {}
    for step in sorted(ops):
        writes = {(k, b) for a, k, b, _ in ops[step] if a == "w"}
        for a, kind, buf, row in ops[step]:
            if a == "r":
                assert (kind, buf) not in writes
                assert holds[(kind, buf)] == row
            stages[(a, kind, row)] = stages.get((a, kind, row), 0) + 1
        for a, kind, buf, row in ops[step]:
            if a == "w":
                holds[(kind, buf)] = row
    for row in range(rows):
        for kind in ("enc", "gy", "dz"):
            assert stages[("w", kind, row)] == 1
        assert stages[("r", "gy", row)] == 1 and stages[("r", "dz", row)] == 1
        assert stages[("r", "enc", row)] == 2  # its forward and its backward
