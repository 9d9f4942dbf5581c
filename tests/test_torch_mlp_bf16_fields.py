"""K2's bf16 and bf16x3 forward on Hopper (csrc/mlp_mma.cuh fields_chunk,
run by k_mlp_fields_bf16 and K4 bf16's fields pass): the host's mirror of
its shared-memory layout and gates, a torch model of its paired C-fragment
walk and of its warps' AB rings, and the float32 / bf16 identities its
instructions rest on. The kernels run on the card only (chip_smoke.py holds
them to their plain versions and to recorded digests there); their plain
versions are held to the JAX tiers by tests/test_torch_bf16.py.
"""

import numpy as np
import pytest
import torch

from phys_autodiff_tpu_torch import GridSpec, MLPDims, MLPGridConfig
from phys_autodiff_tpu_torch.kernels import _build
from phys_autodiff_tpu_torch.kernels import mlp as kmlp
from phys_autodiff_tpu_torch.models import mlp
from phys_autodiff_tpu_torch.models.fields import slice_times

TWO_BLOCKS = 115712  # bytes a block may take with two blocks an SM (static included)


def _hp(h):
    return (h + 15) & ~15


# ---------------------------------------------------------------------------
# Layout and gates
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tier", ["bf16", "bf16x3"])
@pytest.mark.parametrize("s", [3, 1])
def test_layout_mirrors_the_kernel(tier, s):
    """W2's B fragments (once, twice for bf16x3), the CD rows [HP][ZF + 1][P]
    and 2 stages of 16 x 20 floats for each of the 8 warps where they keep
    the blocks an SM that the rest alone allows, else none; both occur
    below the gate's top, and nx % 4 != 0 takes none."""
    zf, p = kmlp.ZROWS[s], 4 if s == 3 else 1
    depths = set()
    for h in range(1, kmlp.SMEM_LIMIT // 16):
        fixed = _hp(h) * (16 * (2 if tier == "bf16x3" else 1)) + 4 * _hp(h) * (zf + 1) * p
        assert kmlp.fields_fixed_bytes(h, s, tier) == fixed
        if fixed + 372 > kmlp.SMEM_LIMIT:  # past the gate
            break
        ns = kmlp.ring_stages(fixed, nx=128)
        depths.add(ns)
        ring, static = ns * 8 * 16 * 20 * 4, 8 * 32 + 12 * 8 + 20  # ring descriptors, channel map, chunk
        assert kmlp.smem_bytes(h, s, tier) == fixed + static + ring
        cap = TWO_BLOCKS if fixed + static <= TWO_BLOCKS else kmlp.SMEM_LIMIT  # the ring never costs a block its slot
        assert fixed + static + ring <= cap and (ns == 2 or fixed + static + 2 * 8 * 16 * 20 * 4 > cap)
        assert kmlp.ring_stages(fixed, nx=37) == 0
    assert depths == {2, 0}


def test_flagship_two_blocks_an_sm_and_the_gate_tops():
    """At H = 128 every instantiation streams through 2 stages with two
    blocks an SM; the gates keep their tops (the top H runs without a
    ring), and the f32 kernel keeps its layout."""
    for tier in ("bf16", "bf16x3"):
        for s in (3, 1):
            fixed = kmlp.fields_fixed_bytes(128, s, tier)
            assert kmlp.ring_stages(fixed, nx=128) == 2 and kmlp.smem_bytes(128, s, tier) <= TWO_BLOCKS
    assert kmlp.smem_bytes(128, 3, "bf16") == 128 * 96 + 20480 + 372
    assert _build.gate_top(lambda h: kmlp.mlp_fits(h, "bf16")) == 2416
    assert _build.gate_top(lambda h: kmlp.mlp_fits(h, "bf16x3")) == 2064
    assert kmlp.ring_stages(kmlp.fields_fixed_bytes(2416, 3, "bf16"), nx=128) == 0
    assert kmlp.ring_stages(kmlp.fields_fixed_bytes(2064, 3, "bf16x3"), nx=128) == 0
    assert kmlp.smem_bytes(128) == 8192 and _build.gate_top(kmlp.mlp_fits) == 3632


# ---------------------------------------------------------------------------
# The warps' AB rings
# ---------------------------------------------------------------------------


def _slabs(n_rows, ntile, nkb, zf):
    """The (tile, k-step) of each k-step the forward runs for a chunk of
    n_rows rows: per tile, one pass a group of rows (one group of zf rows,
    or zf / 2, zf / 4, ... while they last), each over the k-steps."""
    out = []
    for m in range(ntile):
        left, r = n_rows, zf if n_rows == zf else zf // 2
        while r >= 1:
            while left >= r:
                out += [(m, kb) for kb in range(nkb)]
                left -= r
            r //= 2
    return out


class _Ring:
    """mlp_mma.cuh AbRing, step for step: start issues ns - 1 slabs; next
    waits for the slab of this k-step (cp.async.wait_group ns - 2: at most
    ns - 2 newer groups pending), then issues into the stage the last k-step
    read. Records which slab each stage holds and each group's slab."""

    def __init__(self, ns, ntile, groups, nkb):
        self.ns, self.nkb, self.ngr, self.total = ns, nkb, groups, ntile * groups * nkb
        self.stage = [None] * ns
        self.groups = []  # slab of each committed group (None: an empty one)
        self.slot = self.iq = self.islot = self.ikb = self.igr = self.im = 0
        for _ in range(ns - 1):
            self.issue()

    def issue(self):
        slab = (self.im, self.ikb) if self.iq < self.total else None
        if slab is not None:
            self.stage[self.islot] = slab
        self.groups.append(slab)
        self.iq += 1
        self.islot = 0 if self.islot + 1 == self.ns else self.islot + 1
        self.ikb += 1
        if self.ikb == self.nkb:
            self.ikb = 0
            self.igr += 1
            if self.igr == self.ngr:
                self.igr, self.im = 0, self.im + 1

    def next(self, q):
        landed = len(self.groups) - (self.ns - 2)  # groups complete after the wait
        assert landed > q  # this k-step's slab (group q) has landed
        slab = self.stage[self.slot]
        self.issue()
        assert self.stage[self.slot] == slab  # nothing overwrote it before the read
        self.slot = 0 if self.slot + 1 == self.ns else self.slot + 1
        return slab


@pytest.mark.parametrize("ns", [2, 3, 4])  # the kernel's FW_NS; the schedule holds at any depth
@pytest.mark.parametrize("h", [1, 16, 40, 128, 129])
@pytest.mark.parametrize("s,n_rows", [(3, 4), (3, 3), (3, 1), (1, 8), (1, 7), (1, 5), (1, 2)])
@pytest.mark.parametrize("ntile", [1, 2])
def test_ring_hands_each_k_step_its_slab(ns, h, s, n_rows, ntile):
    """For any chunk (popc(n) passes a tile), ring depth and H, the stage
    each k-step reads holds the slab of that k-step's tile and hidden units,
    has landed (the wait_group count) and was not overwritten first."""
    nkb, zf = (h + 15) // 16, kmlp.ZROWS[s]
    want = _slabs(n_rows, ntile, nkb, zf)
    assert len(want) == ntile * bin(n_rows).count("1") * nkb
    ring = _Ring(ns, ntile, bin(n_rows).count("1"), nkb)
    got = [ring.next(q) for q in range(len(want))]
    assert got == want
    assert all(slab is None for slab in ring.groups[len(want):])  # past the end: empty groups


def _copies(lane, nx_left, h0, h_count, vec):
    """(plane, cell, loaded) of each float lane `lane` copies into a stage
    (AbRing.issue): planes lane / 4 and 8 + lane / 4, cells 4 (lane % 4) ..
    + 3, each loaded if its hidden unit is below H and its cell inside the
    row (16-byte copies load or zero all four)."""
    out = []
    for e in range(2):
        pl = (lane >> 2) + 8 * e
        x = 4 * (lane & 3)
        for k in range(4):
            on = h0 + pl < h_count and (x < nx_left if vec else x + k < nx_left)
            out.append((pl, x + k, on))
    return out


@pytest.mark.parametrize("nx_left,vec", [(32, True), (8, True), (16, True), (7, False), (9, False), (33, False)])
@pytest.mark.parametrize("h0,h_count", [(0, 128), (112, 128), (32, 40), (0, 1)])
def test_stage_copies_cover_the_slab_and_zero_past_the_grid(nx_left, vec, h0, h_count):
    """The 32 lanes' copies write each of the 16 x 16 floats of a stage
    once; a float is loaded exactly when its hidden unit is below H and its
    cell inside the grid (else zero-filled); the 8-byte reads of a k-step
    (lane 4g + t: units 2t + {0, 1, 8, 9}, cells 2g and 2g + 1) meet no
    bank twice within a half-warp (plane stride 20 floats)."""
    seen = {}
    for lane in range(32):
        for pl, cell, on in _copies(lane, nx_left, h0, h_count, vec):
            assert (pl, cell) not in seen
            seen[(pl, cell)] = on
    assert len(seen) == 256
    for (pl, cell), on in seen.items():
        assert on == (h0 + pl < h_count and cell < nx_left)
    for j in range(4):
        for lanes in (range(16), range(16, 32)):
            banks = [((2 * (ln & 3) + (j & 1) + 8 * (j >> 1)) * kmlp.FW_PS + 2 * (ln >> 2) + k) % 32
                     for ln in lanes for k in (0, 1)]
            assert len(set(banks)) == 32


# ---------------------------------------------------------------------------
# The paired walk against the plain version
# ---------------------------------------------------------------------------


def _bf16(x):
    return x.to(torch.bfloat16).double()


def _mma(acc, a, b):
    """One mma.sync m16n8k16 of the model: the exact products of bf16 A [16,
    16] and B [16, 8] summed in float64 onto C, rounded to float32."""
    return (acc.double() + a @ b).float()


def _walk(ab_row, cd, w2t, tier, pair):
    """The forward of one 16-cell tile row of a chunk in the model: a1 =
    max(AB + CD, 0) in float32, per k-step one product per value (bf16x3:
    hi.hi, lo.hi, hi.lo), value v = zl * S + s into fragment v // 2 with B =
    [W2 | 0] (v even) or [0 | W2] (v odd) when `pair`, else a fragment of
    its own with [W2 | 0]. Returns y [rows, S, 16 cells, 4] and, when
    paired, the largest magnitude any partner's product put in a value's
    columns."""
    nz, hdim, s_n = cd.shape
    hp = _hp(hdim)
    ab_p = torch.zeros(hp, 16)
    ab_p[:hdim] = ab_row
    cd_p = torch.zeros(nz, hp, s_n)
    cd_p[:, :hdim] = cd
    w = torch.zeros(hp, 8)
    w[:hdim, :4] = w2t.T
    w_hi = _bf16(w)
    w_lo = _bf16(w - w_hi.float())
    nv = nz * s_n
    nfrag = (nv + 1) // 2 if pair else nv
    acc = torch.zeros(nfrag, 16, 8)
    cross = 0.0
    for kb in range(hp // 16):
        ks = slice(16 * kb, 16 * kb + 16)
        for v in range(nv):
            zl, s = divmod(v, s_n)
            a1 = torch.clamp_min(ab_p[ks].T + cd_p[zl, ks, s][None, :], 0.0)  # [16 cells, 16 units], float32
            f, shift = (v // 2, 4 * (v % 2)) if pair else (v, 0)
            bh, bl = torch.roll(w_hi[ks], shift, 1), torch.roll(w_lo[ks], shift, 1)
            hi = _bf16(a1)
            prods = [(hi, bh)] if tier == "bf16" else [(hi, bh), (_bf16(a1 - hi.float()), bh), (hi, bl)]
            for a, b in prods:
                before = acc[f].clone()
                acc[f] = _mma(acc[f], a, b)
                if pair:  # the partner's columns: the products are exact zeros
                    other = slice(4 - shift, 8 - shift)
                    cross = max(cross, float((a @ b)[:, other].abs().max()))
                    assert torch.equal(acc[f][:, other], before[:, other])
    y = torch.empty(nz, s_n, 16, 4)
    for v in range(nv):
        zl, s = divmod(v, s_n)
        f, shift = (v // 2, 4 * (v % 2)) if pair else (v, 0)
        y[zl, s] = acc[f][:, shift:shift + 4]
    return y, cross


@pytest.mark.parametrize("tier", ["bf16", "bf16x3"])
@pytest.mark.parametrize("h", [16, 40, 128])
@pytest.mark.parametrize("s_n,rows", [(3, 4), (3, 3), (1, 8), (1, 5)])
def test_paired_walk_is_the_unpaired_chain_and_the_plain_version(tier, h, s_n, rows):
    """Each (cell, row, slice) of the paired walk equals the chain of its
    own k-steps from 0 to the bit (the partner's products add exact zeros),
    and the fields equal kernels/mlp.mlp_tables_plain of the tier within
    float32 rounding, on a grid whose nx is not a multiple of 32 (the tile
    row's cells past nx are zero-filled and not stored)."""
    g = GridSpec(nx=37, ny=3, nz=rows, hx=0.3, hy=0.35, hz=0.4, dt=1e-2)
    cfg = MLPGridConfig(dims=MLPDims(H=h))
    params = mlp.init_params(cfg.dims, seed=h + rows, device="cpu")
    ts = slice_times(0.25, g.dt) if s_n == 3 else np.array([0.25], dtype=np.float32)
    ab, cd, w2t, b2 = kmlp.fold_tables(g, cfg, params, ts)
    sig_p, u_p = kmlp.mlp_tables_plain(ab, cd, w2t, b2, tier)
    plain = torch.cat([sig_p[:, :, :, :, None], u_p.permute(0, 2, 3, 4, 1)], dim=-1)  # [S, nz, ny, nx, 4]
    for gy in range(g.ny):
        for xb in range(0, g.nx, 16):  # the tile row's 16-cell tiles; cells past nx read zeros
            cells = min(16, g.nx - xb)
            ab_row = torch.zeros(h, 16)
            ab_row[:, :cells] = ab[:, gy, xb:xb + cells]
            y, cross = _walk(ab_row, cd, w2t, tier, pair=True)
            y1, _ = _walk(ab_row, cd, w2t, tier, pair=False)
            assert torch.equal(y, y1) and cross == 0.0
            got = (y[:, :, :cells] + b2).permute(1, 0, 2, 3)  # [S, nz, cells, 4]
            want = plain[:, :, gy, xb:xb + cells]
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# The identities of the instructions
# ---------------------------------------------------------------------------


def _edges():
    """float32 edge values: +-0, the bf16 ties (halfway, odd and even
    mantissas), subnormals (float32 and bf16), the largest finite float32
    (past bf16's range: rounds to inf) and random values of every
    magnitude."""
    bits = [0x00000000, 0x80000000, 0x3F808000, 0x3F818000, 0xBF808000, 0x3F807FFF, 0x3F808001,
            0x00000001, 0x80000001, 0x00008000, 0x00018000, 0x007FFFFF, 0x807FFFFF, 0x00800000,
            0x7F7FFFFF, 0xFF7FFFFF, 0x7F7F8000, 0x7F7F7FFF, 0x3F800000, 0xBF800000, 0x80008000]
    rng = np.random.default_rng(0)
    rand = rng.integers(0, 2**32, size=4096, dtype=np.uint64).astype(np.uint32)
    x = np.concatenate([np.array(bits, dtype=np.uint32), rand]).view(np.float32)
    return torch.from_numpy(x[np.isfinite(x)].copy())


def test_relu_then_round_is_round_then_relu():
    """bf16(max(x, 0)) = max(bf16(x), 0) (cvt.rn.relu.bf16x2.f32 rounds and
    clamps in one instruction where the parent took max(x, 0) in float32,
    or a bf16x2 max after the convert), value for value in torch.bfloat16
    over the edge values (a negative x rounds to a value <= 0, which both
    sides make a zero; a zero's sign cannot reach a field: every product
    of it is a zero, and a chain starts at +0)."""
    x = _edges()
    a = torch.clamp_min(x, 0.0).to(torch.bfloat16)
    b = torch.clamp_min(x.to(torch.bfloat16), 0.0)
    assert torch.equal(a.float(), b.float())


def test_split_reads_hi_off_the_packed_bits_and_lo_is_exact():
    """float(bf16(x)) is the high half of bf16(x)'s packed bits shifted up
    (split2's hi << 16 and hi & 0xffff0000), and lo = x - float(bf16(x)) is
    exact in float32 (the float64 difference), over the finite edge values
    whose bf16 is finite; the pair's packing puts the lower element in the
    low half."""
    x = _edges()
    hb = x.to(torch.bfloat16)
    keep = torch.isfinite(hb.float())
    x, hb = x[keep], hb[keep]
    bits = hb.view(torch.int16).to(torch.int32) & 0xFFFF
    from_bits = (bits << 16).view(torch.float32)
    assert torch.equal(from_bits, hb.float())
    lo = x - from_bits
    assert torch.equal(lo.double(), x.double() - from_bits.double())
    # a pair (x0 low, x1 high) packed as one 32-bit register
    x0, x1 = hb[0::2][: len(hb) // 2], hb[1::2][: len(hb) // 2]
    reg = (x0.view(torch.int16).to(torch.int64) & 0xFFFF) | ((x1.view(torch.int16).to(torch.int64) & 0xFFFF) << 16)
    assert torch.equal(((reg << 16) & 0xFFFFFFFF).to(torch.int32).view(torch.float32), x0.float())
    assert torch.equal((reg & 0xFFFF0000).to(torch.int32).view(torch.float32), x1.float())


# ---------------------------------------------------------------------------
# The ptxas report (kernels/sass_count: the one parser of nvcc -Xptxas -v)
# ---------------------------------------------------------------------------

_PTXAS_LOG = """\
ptxas info    : Compiling entry function '_Z17k_mlp_fields_bf16ILi3ELb1ELb1EEvPKfS1_i' for 'sm_90a'
ptxas info    : Function properties for _Z17k_mlp_fields_bf16ILi3ELb1ELb1EEvPKfS1_i
    56 bytes stack frame, 56 bytes spill stores, 88 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 372 bytes smem
ptxas info    : Compiling entry function '_Z12k_bwd_fieldsILb1ELb1EEvPKfi' for 'sm_90a'
ptxas info    : Function properties for _Z12k_bwd_fieldsILb1ELb1EEvPKfi
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 127 registers, used 1 barriers
ptxas info    : Compiling entry function '_Z8k_probeIEvPf' for 'sm_90a'
ptxas info    : Used 8 registers
"""


@pytest.mark.parametrize("patterns, want", [
    (("k_mlp_fields_bf16",), ["k_mlp_fields_bf16<3, 1, 1>: 128 registers, 56 / 88 bytes spill stores / loads"]),
    (("k_bwd_fields", "k_nothing"), ["k_bwd_fields<1, 1>: 127 registers, 0 / 0 bytes spill stores / loads"]),
    (("",), ["k_mlp_fields_bf16<3, 1, 1>: 128 registers, 56 / 88 bytes spill stores / loads",
             "k_bwd_fields<1, 1>: 127 registers, 0 / 0 bytes spill stores / loads",
             "k_probe: 8 registers, 0 / 0 bytes spill stores / loads"]),
])
def test_ptxas_lines_label_each_entry_with_its_registers_and_spills(patterns, want):
    """Each matched entry function, named with its template arguments, with
    the registers and the spills of its own block of the report (none where
    the report gives no spill line)."""
    from phys_autodiff_tpu_torch.kernels import sass_count

    assert sass_count.ptxas_lines(_PTXAS_LOG, patterns) == want
