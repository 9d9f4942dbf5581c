"""K6 bf16 and K3 bf16 on their Hopper walks (csrc/fit.cu bfit::k_fit_bf16,
csrc/mega.cu k_mega<true, 3>): the host's mirrors of their shared-memory
layouts and gates, numpy models of their walks, and the exactness of the
operand forms the kernels rely on. The kernels themselves run on the card
only (chip_smoke.py holds K6 bf16 to its plain version and K3 bf16's loss to
K2 bf16 -> K1's bits there); their plain versions are held to the JAX tiers
by tests/test_torch_bf16.py. Every check here is exact: integer layouts,
schedules, and float32 / bf16 identities checked bit for bit or value for
value.
"""

import numpy as np
import pytest

from phys_autodiff_tpu_torch import GridSpec
from phys_autodiff_tpu_torch.kernels import _build
from phys_autodiff_tpu_torch.kernels import fit as kfit
from phys_autodiff_tpu_torch.kernels import mega as kmega
from phys_autodiff_tpu_torch.kernels.walk import block_ranges

G = GridSpec(nx=128, ny=96, nz=96)
TX, TY, NT, NW = 32, 8, 256, 8
TWO_BLOCKS = 115712  # bytes a block may take with two blocks an SM (static included)


def _bf16(x):
    """float32 -> the nearest bf16 (ties to even), as float32."""
    b = np.asarray(x, dtype=np.float32).view(np.uint32).astype(np.uint64)
    b = (b + 0x7FFF + ((b >> 16) & 1)) & 0xFFFF0000
    return b.astype(np.uint32).view(np.float32)


# ---------------------------------------------------------------------------
# Layouts and gates
# ---------------------------------------------------------------------------


def _k6_bf16_parent_bytes(h):
    """K6 bf16's layout before the redesign: 16-row chunks, gy in bf16 twice
    (gyp, gyt), the CD rows, W2's fragments, the dW2T sums, the warps' dCD
    rows; and its static rows' sums."""
    hp = (h + 15) & ~15
    return 16 * (NT * 8 + 4 * (NT + 16) * 2) + 4 * (16 * hp + 8 * hp) + 4 * 8 * 16 * 16 + 4 * (2 * 8 * 16 * 2 + 16)


def _k6_bf16_layout(h, zc):
    """csrc/fit.cu bfit::fit_layout, term by term."""
    hp = (h + 15) & ~15
    w2f, dw, cd = 2 * hp * 8, hp * 4 * 4, 2 * zc * hp * 4
    gy, dcd, red = (zc // 2) * NT * 16, NW * zc * 16 * 4, zc * NW * 2 * 2 * 4
    return w2f + dw + cd + gy + dcd + red


def test_k6_bf16_layout_mirrors_the_kernel_and_keeps_its_gate():
    """The host's mirror of K6 bf16's layout equals the kernel's term by
    term at the chunk depth of bfit::fit_zc (24 rows while two blocks fit an
    SM, then 16, 8, 4; one block past that); the gate admits every H the
    tier took before and keeps the top 1600."""
    for h in range(1, 1601):
        zc = kfit.fit_zrows_bf16(h)
        assert kfit.fit_smem_bytes(h, "bf16") == _k6_bf16_layout(h, zc)
        two = [z for z in (24, 16, 8, 4) if _k6_bf16_layout(h, z) + kfit.FIT_SMEM_STATIC_BF16 <= TWO_BLOCKS]
        one = [z for z in (16, 8, 4) if _k6_bf16_layout(h, z) + kfit.FIT_SMEM_STATIC_BF16 <= kfit.SMEM_LIMIT]
        assert zc == (two[0] if two else one[0])
    before = [h for h in range(1, 4097) if _k6_bf16_parent_bytes(h) <= kfit.SMEM_LIMIT]
    assert max(before) == 1600 and all(kfit.fit_fits(h, "bf16") for h in before)
    assert _build.gate_top(lambda h: kfit.fit_fits(h, "bf16")) == 1600
    assert not kfit.fit_fits(1601, "bf16") and not kfit.fit_fits(0, "bf16")
    # the f32 tier keeps its layout and its top
    assert kfit.fit_smem_bytes(128) == 65536 + 4 * 24 * 128 and _build.gate_top(kfit.fit_fits) == 1724


@pytest.mark.parametrize("h,zc", [(1, 24), (128, 24), (224, 24), (225, 16), (448, 16), (449, 8), (976, 8),
                                  (977, 4), (1600, 4)])
def test_k6_bf16_chunk_depths_at_the_edges(h, zc):
    """Where each chunk depth starts and ends (24 covers a block's whole run
    of one tile at 128x96x96: its dAB slot is written once), and two blocks
    an SM at every H the gate takes, H = 128 included (93,184 B)."""
    assert kfit.fit_zrows_bf16(h) == zc
    assert kfit.fit_smem_bytes(h, "bf16") + kfit.FIT_SMEM_STATIC_BF16 <= TWO_BLOCKS
    if h == 128:
        assert kfit.fit_smem_bytes(h, "bf16") == 93184


def test_k3_bf16_layout_and_gate_stay():
    """K3 bf16 keeps its layout (the forward's passes read the chunk's CD
    table as before): the mirror term by term, two blocks an SM at H = 128,
    the top 1904 and every H below it."""
    for h in (1, 16, 17, 128, 1904):
        hp = (h + 15) & ~15
        assert kmega.smem_bytes(h, "bf16") == 4 * (hp * (4 + 4 * 5) + 6 * 4 * 340 + 4 * 4 * 256)
    assert 2 * (kmega.smem_bytes(128, "bf16") + kmega.SMEM_STATIC_BF16 + 1024) <= 228 * 1024
    assert _build.gate_top(lambda h: kmega.mega_fwd_fits(G, h, "bf16")) == 1904
    assert all(kmega.mega_fwd_fits(G, h, "bf16") for h in range(1, 1905))


# ---------------------------------------------------------------------------
# The walks
# ---------------------------------------------------------------------------


def _chunks(r0, r1, nz, zc):
    """mlp_head.cuh chunk_at over a block's range: (tile, z0, n)."""
    out, r = [], r0
    while r < r1:
        tile, z0 = divmod(r, nz)
        n = min(zc, nz - z0, r1 - r)
        out.append((tile, z0, n))
        r += n
    return out


GRIDS = [(128, 96, 96), (24, 13, 5), (40, 9, 1), (33, 9, 150), (7, 3, 11), (36, 300, 40), (33, 17, 2),
         (128, 96, 24)]


def _k6_walk(g, zc):
    """A model of k_fit_bf16's walk for every block: per chunk k, the events
    (action, buffer, slot, rows) in order between the barriers, as the
    kernel issues them."""
    out = []
    for r0, r1 in block_ranges(g):
        chunks = _chunks(r0, r1, g.nz, zc)
        phases = [[("copy", "cd", 0, chunks[0])]]  # the prologue (then a barrier)
        for k, ch in enumerate(chunks):
            a = []
            if k + 1 < len(chunks):
                a.append(("copy", "cd", (k + 1) & 1, chunks[k + 1]))
            a += [("read", "cd", k & 1, ch), ("write", "gy", 0, ch), ("write", "red", 0, ch)]
            phases.append(a)  # A (then a barrier)
            phases.append([("read", "red", 0, ch), ("read", "gy", 0, ch), ("read", "cd", k & 1, ch)])  # B
        out.append((r0, r1, chunks, phases))
    return out


@pytest.mark.parametrize("dims", GRIDS)
@pytest.mark.parametrize("h", [128, 400, 512, 1600])
def test_k6_bf16_walk_stages_each_chunk_once_before_use(dims, h):
    """k_fit_bf16: every chunk's CD rows are copied once (cp.async, waited
    at the barrier that closes the chunk before) into the slot its A and B
    read, and no copy lands in a slot that a phase of the same interval
    reads; gy and the loss sums are written by A and read by B after a
    barrier; the chunks tile each block's range, each at most ZC rows of
    one tile, and every tile row of the grid lies in one block's chunk."""
    g = GridSpec(*dims)
    zc = kfit.fit_zrows_bf16(h)
    ntiles = -(-g.nx // TX) * -(-g.ny // TY)
    seen = np.zeros(ntiles * g.nz, np.int64)
    for r0, r1, chunks, phases in _k6_walk(g, zc):
        r = r0
        for t, z0, n in chunks:
            assert t * g.nz + z0 == r and 1 <= n <= zc and z0 + n <= g.nz
            seen[r:r + n] += 1
            r += n
        assert r == r1
        holds = {}
        for phase in phases:
            copies = {(b, s) for act, b, s, _ in phase if act == "copy"}
            for act, buf, slot, ch in phase:
                if act == "read":
                    assert (buf, slot) not in copies
                    assert holds[(buf, slot)] == ch
            for act, buf, slot, ch in phase:
                if act in ("copy", "write"):
                    holds[(buf, slot)] = ch
    assert np.all(seen == 1)


def _phases_hold(phases):
    """Every read in a phase finds the chunk its buffer was last given, and
    no copy of the same phase lands in a buffer that phase reads."""
    holds = {}
    for phase in phases:
        copies = {(b, s) for act, b, s, _ in phase if act == "copy"}
        for act, buf, slot, ch in phase:
            if act == "read" and ((buf, slot) in copies or holds.get((buf, slot)) != ch):
                return False
        for act, buf, slot, ch in phase:
            if act in ("copy", "write"):
                holds[(buf, slot)] = ch
    return True


def _k3_phases(chunks):
    """k_mega's walk of one block: the first chunk's CD table copied before
    the loop; per chunk, a barrier (the copy waited), the forward reads the
    table, a barrier, the next chunk's table copied while the residuals run,
    a barrier."""
    phases = [[("copy", "cd", 0, chunks[0])]]
    for k, ch in enumerate(chunks):
        phases.append([("read", "cd", 0, ch), ("write", "window", 0, ch)])
        nxt = [("copy", "cd", 0, chunks[k + 1])] if k + 1 < len(chunks) else []
        phases.append(nxt + [("read", "window", 0, ch)])
    return phases


@pytest.mark.parametrize("rows", range(1, 19))
@pytest.mark.parametrize("nz", [1, 2, 5, 7, 96])
def test_walks_stage_each_chunk_before_use_for_any_block_range(rows, nz):
    """A block of 1-18 rows starting anywhere in a tile (its range may cross
    into the next tiles): K6 bf16's chunks (24 rows at H = 128, 4 at H =
    1600) and K3 bf16's (3 rows) each find their CD rows copied before
    their reads and never overwritten while read."""
    for r0 in range(0, 2 * nz, max(1, nz // 3)):
        for zc in (kfit.fit_zrows_bf16(128), kfit.fit_zrows_bf16(1600)):
            chunks = _chunks(r0, r0 + rows, nz, zc)
            assert sum(n for _, _, n in chunks) == rows
            phases = [[("copy", "cd", 0, chunks[0])]]
            for k, ch in enumerate(chunks):
                a = [("copy", "cd", (k + 1) & 1, chunks[k + 1])] if k + 1 < len(chunks) else []
                phases.append(a + [("read", "cd", k & 1, ch), ("write", "gy", 0, ch)])
                phases.append([("read", "gy", 0, ch), ("read", "cd", k & 1, ch)])
            assert _phases_hold(phases)
        chunks = _chunks(r0, r0 + rows, nz, kmega.ZROWS)
        assert all(n <= 3 for _, _, n in chunks) and _phases_hold(_k3_phases(chunks))


@pytest.mark.parametrize("n", range(1, 25))
def test_k6_bf16_row_pairs_and_the_odd_row(n):
    """A chunk of n rows (1-24): B walks ceil(n / 2) row pairs of the gy
    buffer, the forward zeroes the second row of an odd chunk's last pair,
    and every row it reads (its CD row too) lies inside the chunk's ZC rows;
    the tile partials' threads (2 n of 256) and the loss sums ([ZC][8][2][2])
    hold every row."""
    zc = 24
    pairs = (n + 1) // 2
    rows_read = [2 * p + e for p in range(pairs) for e in range(2)]
    assert rows_read[:n] == list(range(n)) and max(rows_read) < zc
    zeroed = [n] if n % 2 else []
    assert sorted(set(rows_read) - set(range(n))) == zeroed
    assert 2 * n <= NT and n * NW * 2 * 2 <= zc * NW * 4


def test_k6_bf16_flagship_writes_each_dab_slot_once():
    """At 128x96x96 with H = 128 (24-row chunks) every block's run of one
    tile is one chunk, so its dAB partial slot is stored once and never read
    back (no read-modify-write)."""
    zc = kfit.fit_zrows_bf16(128)
    assert zc == 24
    for r0, r1 in block_ranges(G):
        chunks = _chunks(r0, r1, G.nz, zc)
        assert len({t for t, _, _ in chunks}) == len(chunks)  # one chunk a tile
        r = r0
        for t, z0, n in chunks:  # each chunk is its (block, tile) slot's first: a store
            assert r == r0 or z0 == 0
            r += n


def test_k3_bf16_passes_cover_each_cell_once():
    """k_mega<true>'s forward: passes 0 and 1 give each warp one 16-cell
    fragment of its tile row (cells 16 m + g, + 8), pass 2 gives warps 0-4
    one 16-cell fragment each of the 80 x/y halo cells (csrc/mega.cu
    halo_at); together every tile cell and every halo cell once, no corner."""
    own = sorted((w, 16 * m + g + 8 * half) for w in range(NW) for m in range(2) for g in range(8)
                 for half in range(2))
    assert own == [(y, x) for y in range(TY) for x in range(TX)]

    def halo_at(j):
        if j < TX:
            return j, -1
        if j < 2 * TX:
            return j - TX, TY
        if j < 2 * TX + TY:
            return -1, j - 2 * TX
        return TX, j - 2 * TX - TY

    halo = sorted(halo_at(16 * w + g + 8 * half) for w in range(5) for g in range(8) for half in range(2))
    ring = [(x, -1) for x in range(TX)] + [(x, TY) for x in range(TX)] + [(-1, y) for y in range(TY)] + \
        [(TX, y) for y in range(TY)]
    assert halo == sorted(ring) and len(set(halo)) == 80


# ---------------------------------------------------------------------------
# The operand forms of the single gy layout
# ---------------------------------------------------------------------------


def _ldsm(rows, trans):
    """ldmatrix (m8n8, b16) of an 8 x 8 matrix whose row i is rows[i]: lane
    (g, t) gets (row g, columns 2t, 2t + 1), or with .trans (rows 2t, 2t + 1,
    column g)."""
    out = np.zeros((32, 2), rows.dtype)
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        out[lane] = rows[g, 2 * t:2 * t + 2] if not trans else rows[2 * t:2 * t + 2, g]
    return out


def _values(rng, shape, lo=-4, hi=4):
    """bf16 values of both signs over 2^lo .. 2^hi: any sum of 16 of their
    products is exact in float64."""
    x = rng.choice([-1.0, 1.0], shape) * rng.uniform(1.0, 2.0, shape) * 2.0 ** rng.integers(lo, hi, shape)
    return _bf16(x.astype(np.float32))


@pytest.mark.parametrize("seed", range(4))
def test_one_gy_row_pair_feeds_da1_and_dw2_of_both_rows(seed):
    """gy of rows 2p, 2p + 1 in one 16-byte bf16 row a cell, [gy(2p) |
    gy(2p + 1)]: m16n8k8 with A = [W2 | 0] (lanes t < 2) or [0 | W2] (lanes
    t >= 2) over ldmatrix's B gives W2 . gy of the even or the odd row, each
    a sum of four exact products; m16n8k16 with ldmatrix.trans's B (k =
    cells) gives, in C columns 0-3, a1 . gy(2p) and in columns 4-7,
    a1 . gy(2p + 1), so the even rows' accumulator of lanes t < 2 and the odd
    rows' of lanes t + 2 hold dW2 of outputs 2t, 2t + 1."""
    rng = np.random.default_rng(seed)
    gy = _values(rng, (2, 16, 4))  # [row of the pair][cell][output]
    w2 = _values(rng, (16, 4))  # [hidden unit][output]
    a1 = [_values(rng, (16, 16)) for _ in range(2)]  # [row]: [hidden unit][cell]
    rows = np.concatenate([gy[0], gy[1]], axis=1)  # [cell][8]
    for e in range(2):  # da1^T [h][cell] of row e, two n8 tiles of cells
        want = w2.astype(np.float64) @ gy[e].T.astype(np.float64)
        a_op = np.zeros((16, 8), np.float32)
        a_op[:, 4 * e:4 * e + 4] = w2
        for n in range(2):
            b = _ldsm(rows[8 * n:8 * n + 8], trans=False)  # lane (g, t): cell g, k 2t, 2t + 1
            bmat = np.zeros((8, 8), np.float32)
            for lane in range(32):
                g, t = lane >> 2, lane & 3
                bmat[2 * t:2 * t + 2, g] = b[lane]
            got = a_op.astype(np.float64) @ bmat.astype(np.float64)
            assert np.array_equal(got, want[:, 8 * n:8 * n + 8])
    # dW2 [h][n] over the 16 cells: B (k = cells, n = the row pair's 8 values) by .trans
    bt = np.zeros((16, 8), np.float32)
    for j in range(2):
        b = _ldsm(rows[8 * j:8 * j + 8], trans=True)
        for lane in range(32):
            g, t = lane >> 2, lane & 3
            bt[8 * j + 2 * t:8 * j + 2 * t + 2, g] = b[lane]
    assert np.array_equal(bt, rows)
    acc = [a1[e].astype(np.float64) @ bt.astype(np.float64) for e in range(2)]
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        if t >= 2:
            continue
        for r in range(2):  # C rows g, g + 8; columns 2t, 2t + 1 and (odd) 2t + 4, 2t + 5
            h = g + 8 * r
            for j in range(2):
                dw2 = acc[0][h, 2 * t + j] + acc[1][h, 2 * t + 4 + j]
                want = a1[0][h].astype(np.float64) @ gy[0][:, 2 * t + j] + \
                    a1[1][h].astype(np.float64) @ gy[1][:, 2 * t + j]
                assert dw2 == want


def test_k6_bf16_db2_lanes_sum_as_the_four_outputs():
    """The forward keeps db2 of outputs 2t, 2t + 1 in lanes t < 2 (two
    registers); spread back to four (t = 0: outputs 0, 1; t = 1: 2, 3; zero
    elsewhere) before the block sum, each output's terms are the ones the
    four-register form added, in the same lanes."""
    rng = np.random.default_rng(5)
    db = rng.standard_normal((NT, 2)).astype(np.float32)
    t = np.arange(NT) & 3
    d4 = np.zeros((NT, 4), np.float32)
    d4[t == 0, 0:2] = db[t == 0]
    d4[t == 1, 2:4] = db[t == 1]
    for o in range(4):
        lanes = t == (o // 2)
        assert np.array_equal(d4[lanes, o], db[lanes, o % 2]) and not np.any(d4[~lanes, o])
