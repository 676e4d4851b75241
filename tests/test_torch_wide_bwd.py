"""The wide-layer train backward's launch rules and phases (K9's and K6's:
svd_lstm_tpu_torch/ops/cuda_train.py ``wide_bwd``, ops/csrc/lstm_train.cu
``gemm_f32`` and ``wide_bwd_chain``), on the CPU, without a card.

The backward runs four phases: R (``gemm_f32`` NN: z = x·W + h_prev·U + b,
h_prev being h read B rows back), C (``wide_bwd_chain``: the reverse-time dh
chain in one persistent launch, a CTA owning R rows × J units, partial sums
of dh over the unit groups in two parities, one grid barrier a step), X
(``gemm_f32`` NT: dx = dz·Wᵀ) and G (``gemm_f32`` TN: [dW; db; dU], split
over the T·B rows in a fixed order, the splits summed in order).

* The launch rule's Python twin (``chain_plan``, ``chain_smem_bytes``,
  ``gemm_splits``) at the repo's shapes and over a sweep of widths and
  batches on three SM counts: every grid at most one CTA an SM, every
  staged tile within a block's shared memory, any batch in as few launches
  of the chain as its row tiles allow, wider unit groups where n / 16 would
  outnumber the SMs, and a ValueError only past 64 units an SM.
* A float64 numpy emulation of the kernels, index by index: each GEMM tile
  and K chunk with its masks, the ones row and the B-row shift; each chain
  CTA's tiles, the partial sums read in group order from the other parity,
  the dz tile in shared memory with NaN in its padding rows, the CTAs of a
  step in a shuffled order between two barriers; every buffer between NaN
  guards (and the chain's scratch NaN at the start), so a read past a mask
  shows. It is held against ``wide_layer_bwd_plain`` and
  ``lstm_recurrence_train_bwd_plain`` for ragged B, T = 1, d = 16 and 7, n =
  128 and 256, every chain tile the rule takes, both weight homes and a
  chain in two launches.
* Mutations of the emulation (the h_prev shift off by one row, the chain
  reading the partial sums of the step it writes, a lost row mask, a lost K
  mask, a launch over part of the batch stepping through time by its own
  rows) each make it disagree: the checks above see such faults.
* ``wide_bwd`` itself, its meta arrays, offsets, splits and views, on CPU
  tensors with ``_launch`` replaced by the same emulation reading the
  wrapper's pointers.

The kernels themselves run only on the card (tests/test_torch_train_kernels.py,
``cuda`` marker).
"""

import ctypes
import math

import numpy as np
import pytest
import torch

from svd_lstm_tpu_torch.ops import cuda_train as ct
from svd_lstm_tpu_torch.ops.cuda_lstm import _SMEM_LIMIT

SMS = 132  # the H100 SXM's SM count
TOL = dict(rtol=1e-9, atol=1e-9)  # float64 emulation against the float64 plain version


# ---------------------------------------------------------------------------
# the launch rule
# ---------------------------------------------------------------------------

# (B, n): runs C, D and F, the card tests' shapes, B past one row group and
# past one launch, n past 16 and 32 units an SM
# -> (rows, units, staged, unit groups, row groups, row tiles, chunk rows, shared bytes)
PLAN_CASES = [
    ((128, 512), (32, 16, True, 32, 4, 1, 128, 139_264)),    # runs C, D, F
    ((1, 512), (32, 16, True, 32, 1, 1, 32, 139_264)),
    ((17, 512), (32, 16, True, 32, 1, 1, 32, 139_264)),
    ((130, 512), (32, 16, True, 32, 4, 2, 160, 139_264)),
    ((600, 512), (32, 16, True, 32, 4, 5, 608, 139_264)),
    ((256, 256), (32, 16, True, 16, 8, 1, 256, 73_728)),
    ((33, 128), (32, 16, True, 8, 2, 1, 64, 40_960)),
    ((20, 1024), (32, 16, False, 64, 1, 1, 32, 8_192)),      # U from the global copy
    ((1024, 512), (32, 16, True, 32, 4, 8, 1024, 139_264)),  # the most rows one launch takes
    ((2048, 512), (32, 16, True, 32, 4, 8, 1024, 139_264)),  # two launches
    ((2049, 512), (32, 16, True, 32, 4, 6, 704, 139_264)),   # three
    ((4096, 2048), (32, 16, False, 128, 1, 8, 256, 8_192)),  # sixteen, one row group
    ((20, 2176), (16, 32, False, 68, 1, 2, 32, 8_192)),      # 136 groups of 16 > 132 SMs
    ((20, 4352), (8, 64, False, 68, 1, 3, 24, 8_192)),       # 136 groups of 32 > 132 SMs
]


@pytest.mark.parametrize("shape,want", PLAN_CASES)
def test_plan_at_the_repo_shapes(shape, want):
    B, n = shape
    plan = ct.chain_plan(B, n, SMS)
    assert tuple(plan) == want
    assert plan.ctas <= SMS and plan.smem_bytes <= _SMEM_LIMIT
    assert plan.row_groups * plan.row_tiles * plan.rows >= plan.chunk_rows


def _launches(B, plan):
    """Each launch of phase_c: (rows, row groups, row tiles a CTA)."""
    out = []
    for b0 in range(0, B, plan.chunk_rows):
        rows = min(plan.chunk_rows, B - b0)
        tiles = -(-rows // plan.rows)
        groups = min(plan.row_groups, tiles)
        out.append((rows, groups, -(-tiles // groups)))
    return out


@pytest.mark.parametrize("sms", [SMS, 114, 16])
def test_plan_sweep_stays_within_the_card(sms):
    """Every width the wide kernels take (n % 128 == 0) up to 64 units an SM
    and batches up to 4100, on the H100 SXM's 132 SMs, the PCIe card's 114
    and a small card: a plan, never a ValueError, each launch co-resident
    within a block's shared memory and its row tiles, the chunks covering
    the batch with as few launches as the row tiles allow; past 64 units an
    SM, a ValueError."""
    for n in range(128, 64 * sms + 1, 128):
        for B in [1, 2, 31, 32, 33, 127, 128, 129, 500, 1023, 1024, 1025, 2048, 2049, 4100]:
            plan = ct.chain_plan(B, n, sms)
            assert (plan.rows, plan.units) == next(t for t in ct.CHAIN_TILES if n // t[1] <= sms)
            assert plan.ctas <= sms and n % plan.units == 0
            assert plan.smem_bytes == ct.chain_smem_bytes(n, plan.rows, plan.units, plan.staged) <= _SMEM_LIMIT
            assert plan.staged == ((plan.rows, plan.units) == ct.CHAIN_TILES[0]
                                   and ct.chain_smem_bytes(n, 32, 16, True) <= _SMEM_LIMIT)
            launches = _launches(B, plan)
            assert sum(r for r, _, _ in launches) == B
            assert all(1 <= g <= plan.row_groups and t <= ct.CHAIN_MAX_ROW_TILES for _, g, t in launches)
            most = sms // plan.unit_groups * ct.CHAIN_MAX_ROW_TILES  # row tiles one launch holds
            assert len(launches) == -(-(-(-B // plan.rows)) // most)
    with pytest.raises(ValueError, match="co-resident"):
        ct.chain_plan(1, 64 * sms + 128, sms)


@pytest.mark.parametrize("n", [8 * 1024 + 512, 16 * 1024])
def test_plan_raises_where_the_grid_cannot_be_co_resident(n):
    """Past 64 units an SM even the widest unit groups outnumber the SMs."""
    with pytest.raises(ValueError, match="co-resident"):
        ct.chain_plan(128, n, SMS)


@pytest.mark.parametrize("n", [128, 256, 512, 768, 896, 1024, 2048, 2176, 4224, 4352, 8448])
def test_every_tile_fits_a_block(n):
    """Each width's tile: the global copy always fits; U staged at the first
    tile only where its 64 columns of n fit beside the dz tile (n ≤ 876)."""
    plan = ct.chain_plan(128, n, SMS)
    assert plan.staged == (n <= 876)
    assert ct.chain_smem_bytes(n, plan.rows, plan.units, False) <= _SMEM_LIMIT
    assert (ct.chain_smem_bytes(n, 32, 16, True) <= _SMEM_LIMIT) == (n <= 876)


@pytest.mark.parametrize("K,tiles,want", [
    (25_600, 144, 11),  # K9 at runs C and F: [dW; db] 5 x 16 tiles, dU 4 x 16
    (25_600, 64, 4),    # K6 at run D: dU
    (25_600, 80, 13),   # K9's first layer (d = 16): [dW; db] 1 x 16 tiles, dU 4 x 16
    (200, 64, 1),       # too few rows to split
    (600, 100, 2),      # two splits of 300 rows
])
def test_gemm_splits(K, tiles, want):
    S = ct.gemm_splits(K, tiles, SMS)
    assert S == want
    assert 1 <= S <= ct.GEMM_MAX_SPLITS and (S == 1 or K // S >= 256)
    slots = 2 * SMS
    cost = math.ceil(tiles * S / slots) / S
    for other in range(1, min(ct.GEMM_MAX_SPLITS, max(1, K // 256)) + 1):
        assert math.ceil(tiles * other / slots) / other >= cost - 1e-12


# ---------------------------------------------------------------------------
# the emulation
# ---------------------------------------------------------------------------

class Memory:
    """Device memory as one float64 array, every buffer between NaN guards
    of GUARD floats: a read out of a buffer reads NaN. Addresses are float
    indices."""

    GUARD = 1 << 15

    def __init__(self):
        self.a = np.full(self.GUARD, np.nan)

    def put(self, x) -> int:
        base = len(self.a)
        self.a = np.concatenate([self.a, np.ravel(np.asarray(x, np.float64)), np.full(self.GUARD, np.nan)])
        return base

    def alloc(self, size: int) -> int:
        return self.put(np.full(size, np.nan))

    def get(self, base: int, shape):
        return self.a[base : base + int(np.prod(shape))].reshape(shape).copy()

    def read(self, idx, mask):
        return np.where(mask, self.a[np.clip(idx, 0, len(self.a) - 1)], 0.0)

    def write(self, idx, vals, mask):
        idx, vals = np.broadcast_arrays(idx, vals)
        mask = np.broadcast_to(mask, idx.shape)
        self.a[np.clip(idx[mask], 0, len(self.a) - 1)] = vals[mask]


class PointerMemory:
    """The CPU tensors behind the wrapper's pointers (float32), read and
    written in the span of the indices a kernel touches; addresses are float
    indices (pointer / 4)."""

    def _view(self, lo, hi):
        return np.ctypeslib.as_array((ctypes.c_float * (hi - lo)).from_address(4 * lo))

    def read(self, idx, mask):
        idx = np.broadcast_to(idx, np.broadcast_shapes(np.shape(idx), np.shape(mask)))
        mask = np.broadcast_to(mask, idx.shape)
        out = np.zeros(idx.shape)
        if mask.any():
            lo, hi = int(idx[mask].min()), int(idx[mask].max()) + 1
            out[mask] = self._view(lo, hi)[idx[mask] - lo]
        return out

    def write(self, idx, vals, mask):
        idx, vals = np.broadcast_arrays(idx, vals)
        mask = np.broadcast_to(mask, idx.shape)
        if mask.any():
            lo, hi = int(idx[mask].min()), int(idx[mask].max()) + 1
            self._view(lo, hi)[idx[mask] - lo] = vals[mask]


class Seg(dict):
    """One product of a GEMM (csrc GemmSeg): A, B (addresses), lda, ldb,
    a_t, b_t, shift, ones_row, K."""

    def __getattr__(self, k):
        return self[k]


def gemm(mem, segs, M, N, C, ldc, bias=0, addend=0, splits=1, kchunk=0, split_stride=0,
         kmask=True):
    """csrc gemm_f32, tile by tile and K chunk by K chunk, every operand read
    through its kernel's masks (``kmask=False``: a chunk reads all GM_BK of
    its k's, the mutation of a lost K mask)."""
    BM, BN = ct.GEMM_TILE
    BK = ct.GEMM_BK
    for z in range(splits):
        for by in range(-(-M // BM)):
            for bx in range(-(-N // BN)):
                i = by * BM + np.arange(BM)[:, None]   # (BM, 1)
                j = bx * BN + np.arange(BN)[None, :]   # (1, BN)
                acc = np.zeros((BM, BN))
                for g in segs:
                    kb = min(g.K, z * kchunk) if splits > 1 else 0
                    ke = min(g.K, kb + kchunk) if splits > 1 else g.K
                    for k0 in range(kb, ke, BK):
                        kend = ke if kmask else k0 + BK
                        ka = k0 + np.arange(BK)[None, :]   # (1, BK) for A (BM, BK)
                        ia = min(M, g.ones_row) if g.ones_row >= 0 else M
                        r = ka if g.a_t else i
                        ok = (i < ia) & (ka < kend) & (r >= g.shift)
                        idx = g.A + (r - g.shift) * g.lda + (i if g.a_t else ka)
                        a = mem.read(idx, ok)
                        a = np.where(i == g.ones_row, ((i < M) & (ka < kend)).astype(float), a)
                        kb_ = k0 + np.arange(BK)[:, None]  # (BK, 1) for B (BK, BN)
                        ok = (j < N) & (kb_ < kend)
                        idx = g.B + (j * g.ldb + kb_ if g.b_t else kb_ * g.ldb + j)
                        acc += a @ mem.read(idx, ok)
                ok = (i < M) & (j < N)
                if bias:
                    acc = acc + mem.read(bias + j + 0 * i, ok)
                if addend:
                    acc = acc + mem.read(addend + i * ldc + j, ok)
                mem.write(C + z * split_stride + i * ldc + j, acc, ok)


def sum_splits(mem, partial, out, size, splits):
    idx = np.arange(size)
    total = np.zeros(size)
    for s in range(splits):
        total = total + mem.read(partial + s * size + idx, True)
    mem.write(out + idx, total, True)


def _sigm(v):
    return 1.0 / (1.0 + np.exp(-v))


def gate_bwd(z, c_prev, c_t, dh, dc):
    """csrc gate_bwd over arrays: z (4, ...); returns dz (4, ...), dc_prev."""
    i, f, g, o = _sigm(z[0]), _sigm(z[1]), np.tanh(z[2]), _sigm(z[3])
    tc = np.tanh(c_t)
    dct = dc + dh * o * (1.0 - tc * tc)
    dz = np.stack([dct * g * i * (1 - i), dct * c_prev * f * (1 - f), dct * i * (1 - g * g),
                   dh * tc * o * (1 - o)])
    return dz, dct * f


def chain(mem, z, Ut, c, dh_seq, dz, P, T, B, stride, n, rows, units, staged, row_groups,
          order_seed=0, mutation=None):
    """csrc wide_bwd_chain over B rows of a batch of ``stride`` rows (the
    addresses at the chunk's first row): the CTAs of a step in a shuffled
    order (the grid barrier ends the step), each walking its row tiles; the
    staged copy of U or the global one; the dz tile in shared memory NaN
    where no row is. ``mutation``: "parity" reads the partial sums of the
    parity this step writes, "mask" stores the rows past B, "stride" steps
    through time by the chunk's rows instead of the batch's."""
    R, J = rows, units
    K, G, groups = 4 * J, 4 * n, n // J
    tiles = -(-B // R)
    assert 1 <= row_groups <= tiles and n % J == 0 and stride >= B
    if mutation == "stride":
        stride = B
    row_tiles = -(-tiles // row_groups)
    assert row_tiles <= ct.CHAIN_MAX_ROW_TILES
    pstride = groups * B * n
    rng = np.random.default_rng(order_seed)
    ctas = [(ug, rg) for ug in range(groups) for rg in range(row_groups)]
    dc = {cta: np.zeros((row_tiles, R, J)) for cta in ctas}
    r_ = np.arange(R)[:, None]
    u_ = np.arange(J)[None, :]
    kk = np.arange(K)

    def col(j0):  # gate columns of the CTA's local k
        return (kk // J) * n + j0 + kk % J

    us = {}
    for ug in range(groups):
        idx = Ut + col(ug * J)[:, None] * n + np.arange(n)[None, :]
        us[ug] = mem.read(idx, True) if staged else idx  # staged: values; global: addresses
    for t in range(T - 1, -1, -1):
        for ci in rng.permutation(len(ctas)):
            ug, rg = ctas[ci]
            j0 = ug * J
            for tile in range(row_tiles):
                r0 = (rg + tile * row_groups) * R
                row = r0 + r_
                ok = row < B
                m = t * stride + row
                j = j0 + u_
                zv = np.stack([mem.read(z + m * G + g * n + j, ok) for g in range(4)])
                ct_ = mem.read(c + m * n + j, ok)
                cp = mem.read(c + (m - stride) * n + j, ok & (t > 0))
                dh = mem.read(dh_seq + m * n + j, ok)
                if t + 1 < T:
                    par = (t & 1) if mutation == "parity" else ((t + 1) & 1)
                    for u in range(groups):  # in group order
                        dh = dh + mem.read(P + par * pstride + (u * B + row) * n + j, ok)
                g4, dcv = gate_bwd(zv, cp, ct_, dh, dc[(ug, rg)][tile])
                dc[(ug, rg)][tile] = np.where(ok, dcv, 0.0)
                store = np.ones_like(ok) if mutation == "mask" else ok
                dzs = np.full((K, R), np.nan)  # shared memory: no row past B is written
                for g in range(4):
                    mem.write(dz + m * G + g * n + j, g4[g], store)
                    dzs[g * J + u_.ravel()] = np.where(ok, g4[g], np.nan).T
                if t > 0:
                    w = us[ug] if staged else mem.read(us[ug], True)
                    part = dzs.T @ w  # (R, n): R x n sums of K products
                    pidx = P + (t & 1) * pstride + (ug * B + row) * n + np.arange(n)[None, :]
                    mem.write(pidx, part, store)


def emulate(x, W, U, b, h, c, dh_seq, sms=SMS, staged=None, mutation=None, order_seed=0):
    """The four phases of K9's backward (W given) or K6's (W None, x the
    projection xp) on a fresh Memory, as ``wide_bwd`` orders them, on a card
    of ``sms`` SMs (fewer SMs: wider unit groups, more launches of the chain);
    ``staged`` overrides the weight home. Returns (dx, dW, dU, db) or (dxp,
    dU), float64."""
    T, B, din = x.shape
    n = U.shape[0]
    G, M = 4 * n, T * B
    plan = ct.chain_plan(B, n, sms)
    if staged is not None:
        plan = plan._replace(staged=staged)
    mem = Memory()
    xa, Ua, ha, ca, dha = (mem.put(a) for a in (x, U, h, c, dh_seq))
    Uta = mem.put(np.asarray(U).T)
    shift = B - 1 if mutation == "shift" else B
    kmask = mutation != "kmask"
    z = mem.alloc(M * G)
    hseg = Seg(A=ha, B=Ua, lda=n, ldb=G, a_t=0, b_t=0, shift=shift, ones_row=-1, K=n)
    if W is None:
        gemm(mem, [hseg], M, G, z, G, addend=xa, kmask=kmask)
    else:
        Wa, ba = mem.put(W), mem.put(b)
        gemm(mem, [Seg(A=xa, B=Wa, lda=din, ldb=G, a_t=0, b_t=0, shift=0, ones_row=-1, K=din), hseg],
             M, G, z, G, bias=ba, kmask=kmask)
    dz = mem.alloc(M * G)
    P = mem.alloc(2 * plan.unit_groups * min(B, plan.chunk_rows) * n)
    for b0 in range(0, B, plan.chunk_rows):  # phase_c's launches
        rows = min(plan.chunk_rows, B - b0)
        chain(mem, z + b0 * G, Uta, ca + b0 * n, dha + b0 * n, dz + b0 * G, P, T, rows, B, n,
              plan.rows, plan.units, plan.staged, min(plan.row_groups, -(-rows // plan.rows)),
              order_seed, mutation)
    gemms = []
    if W is not None:
        gemms.append((0, din + 1, Seg(A=xa, B=dz, lda=din, ldb=G, a_t=1, b_t=0, shift=0, ones_row=din, K=M)))
    first = 0 if W is None else din + 1
    gemms.append((first, n, Seg(A=ha, B=dz, lda=n, ldb=G, a_t=1, b_t=0, shift=shift, ones_row=-1, K=M)))
    rows_out = first + n
    BM, BN = ct.GEMM_TILE
    S = ct.gemm_splits(M, sum(-(-r // BM) * -(-G // BN) for _, r, _ in gemms), sms)
    out = mem.alloc(rows_out * G)
    partial = mem.alloc(S * rows_out * G) if S > 1 else out
    kchunk = -(-(-(-M // S)) // ct.GEMM_BK) * ct.GEMM_BK
    for r0, r, seg in gemms:
        gemm(mem, [seg], r, G, partial + r0 * G, G, splits=S, kchunk=kchunk, split_stride=rows_out * G,
             kmask=kmask)
    if S > 1:
        sum_splits(mem, partial, out, rows_out * G, S)
    grads = mem.get(out, (rows_out, G))
    dzv = mem.get(dz, (T, B, G))
    if W is None:
        return dzv, grads
    dx = mem.alloc(M * din)
    gemm(mem, [Seg(A=dz, B=Wa, lda=G, ldb=G, a_t=0, b_t=1, shift=0, ones_row=-1, K=G)], M, din, dx, din,
         kmask=kmask)
    return mem.get(dx, (T, B, din)), grads[:din], grads[din + 1 :], grads[din]


def _case(seed, n, d, B, T):
    rng = np.random.default_rng(seed)
    W = rng.normal(scale=d ** -0.5, size=(d, 4 * n))
    U = rng.normal(scale=n ** -0.5, size=(n, 4 * n))
    b = rng.normal(scale=0.1, size=(4 * n,))
    x = rng.normal(size=(T, B, d))
    dh = rng.normal(size=(T, B, n))
    h, c = ct.wide_layer_fwd_plain(*(torch.from_numpy(a) for a in (x, W, U, b)))
    return x, W, U, b, h.numpy(), c.numpy(), dh


def _plain(x, W, U, b, h, c, dh):
    args = [torch.from_numpy(np.asarray(a, np.float64)) for a in (x, W, U, b, h, c, dh)]
    return [g.numpy() for g in ct.wide_layer_bwd_plain(*args)]


def _plain_rec(x, W, U, b, h, c, dh):
    xp = x @ W + b
    args = [torch.from_numpy(np.asarray(a, np.float64)) for a in (xp, U, h, c, dh)]
    return xp, [g.numpy() for g in ct.lstm_recurrence_train_bwd_plain(*args)]


# (n, d, B, T, sms, staged): ragged B (1, 17, 40: masked row tiles; 70 at 2
# row groups: two row tiles a CTA), T = 1 (no partial sums read), d = 16 and
# 7 (K not a multiple of the GEMM's chunk), n = 128 and 256, U staged and
# from the global copy; on a card of fewer SMs the wider unit groups (n =
# 128 on 4 SMs: 16 x 32; n = 256 on 4 SMs and n = 128 on 2: 8 x 64) and more
# launches of the chain (B = 300 on 8 SMs: 8 groups of 16 units, one row
# group, 2 launches)
EMULATION_CASES = [
    (128, 16, 17, 4, SMS, None),
    (128, 7, 1, 3, SMS, False),
    (256, 16, 40, 3, SMS, None),
    (128, 16, 9, 1, SMS, None),
    (128, 16, 70, 2, 17, None),
    (128, 7, 20, 3, 4, None),
    (256, 16, 19, 3, 4, None),
    (128, 16, 19, 3, 2, None),
    (128, 16, 300, 2, 8, None),
    (128, 7, 300, 2, 8, False),
]


@pytest.mark.parametrize("n,d,B,T,sms,staged", EMULATION_CASES)
def test_emulation_matches_the_plain_backward(n, d, B, T, sms, staged):
    case = _case(n + d + B + T, n, d, B, T)
    got = emulate(*case, sms=sms, staged=staged)
    for name, a, r in zip(("dx", "dW", "dU", "db"), got, _plain(*case)):
        np.testing.assert_allclose(a, r, err_msg=name, **TOL)
    x, W, U, b, h, c, dh = case
    xp, want = _plain_rec(*case)
    got = emulate(xp, None, U, None, h, c, dh, sms=sms, staged=staged)
    for name, a, r in zip(("dxp", "dU"), got, want):
        np.testing.assert_allclose(a, r, err_msg=name, **TOL)


def test_emulation_covers_each_tile_and_chunking():
    """The cases above reach every tile the rule takes and a chain in more
    than one launch."""
    plans = [ct.chain_plan(B, n, sms) for n, _, B, _, sms, _ in EMULATION_CASES]
    assert {(p.rows, p.units) for p in plans} == set(ct.CHAIN_TILES)
    assert any(p.row_tiles > 1 for p in plans)
    assert any(p.chunk_rows < B for p, (_, _, B, _, _, _) in zip(plans, EMULATION_CASES))


def test_emulation_splits_the_weight_gradients():
    """T·B = 520 rows: the rule splits phase G in two, summed in order."""
    case = _case(3, 128, 16, 130, 4)
    assert ct.gemm_splits(520, 1 * 4 + 1 * 4, SMS) == 2  # [dW; db] and dU: 1 x 4 tiles each
    for name, a, r in zip(("dx", "dW", "dU", "db"), emulate(*case), _plain(*case)):
        np.testing.assert_allclose(a, r, err_msg=name, **TOL)


def test_chain_result_does_not_depend_on_the_cta_order():
    """The CTAs of a step run in any order between two barriers: two
    shuffles give the same dz bit for bit."""
    case = _case(4, 128, 16, 40, 3)
    a = emulate(*case, order_seed=1)
    b = emulate(*case, order_seed=2)
    for x, y in zip(a, b):
        assert np.array_equal(x, y)


@pytest.mark.parametrize("mutation", ["shift", "parity", "mask", "kmask", "stride"])
def test_a_mutated_schedule_disagrees(mutation):
    """Each fault the emulation models is seen: h_prev one row off, the
    chain reading the partial sums of the step it writes (their parity), a
    row tile storing its rows past B into the next step's, a GEMM chunk
    reading past K (d = 7, K chunks of GEMM_BK), a launch over a chunk of
    the batch stepping through time by its own rows (B = 300 on 8 SMs: two
    launches)."""
    case = _case(5, 128, 7, 300 if mutation == "stride" else 17, 3)
    want = _plain(*case)
    got = emulate(*case, mutation=mutation, sms=8 if mutation == "stride" else SMS)
    assert not all(np.allclose(a, r, **TOL) for a, r in zip(got, want))


# ---------------------------------------------------------------------------
# wide_bwd itself, on CPU tensors, through the emulation
# ---------------------------------------------------------------------------

def _fake_launch(name, device, *args):
    """The C entry points of the backward, emulated on the wrapper's own
    pointers (csrc wide_gemm_launch's meta layout)."""
    mem = PointerMemory()
    if name == "wide_gemm":
        meta = np.ctypeslib.as_array((ctypes.c_int64 * (10 + 9 * ct.GEMM_MAX_SEGS)).from_address(args[0]))
        nseg, M, N, C, ldc, bias, addend, splits, kchunk, split_stride = (int(v) for v in meta[:10])
        segs = []
        for i in range(nseg):
            A, Bp, lda, ldb, a_t, b_t, shift, ones_row, K = (int(v) for v in meta[10 + 9 * i : 19 + 9 * i])
            assert A % 4 == 0 and Bp % 4 == 0 and not (a_t and b_t)
            segs.append(Seg(A=A // 4, B=Bp // 4, lda=lda, ldb=ldb, a_t=a_t, b_t=b_t, shift=shift,
                            ones_row=ones_row, K=K))
        assert ldc == N and (splits == 1 or split_stride >= M * ldc)
        gemm(mem, segs, M, N, C // 4, ldc, bias // 4, addend // 4, splits, kchunk, split_stride)
    elif name == "wide_bwd_chain":
        z, Ut, c, dh, dz, P, T, B, stride, n, rows, units, staged, row_groups = args
        chain(mem, z // 4, Ut // 4, c // 4, dh // 4, dz // 4, P // 4, T, B, stride, n, rows, units,
              staged, row_groups)
    elif name == "sum_splits":
        partial, out, size, splits = args
        sum_splits(mem, partial // 4, out // 4, size, splits)
    else:
        raise AssertionError(f"unexpected launch {name}")
    _fake_launch.names.append(name)


@pytest.mark.parametrize("n,d,B,T,sms", [(128, 16, 17, 3, SMS), (128, 7, 130, 4, SMS),
                                         (256, 16, 5, 1, SMS), (128, 16, 300, 2, 8)])
def test_wide_bwd_through_the_emulated_kernels(n, d, B, T, sms, monkeypatch):
    """wide_bwd's phases, meta arrays, splits, the chain's chunk offsets and
    returned views on CPU tensors, each launch emulated on its pointers:
    float32 results within float32 rounding of the float64 plain backward;
    the launches do not depend on T (B = 300 on 8 SMs: the chain in two)."""
    monkeypatch.setattr(ct, "_launch", _fake_launch)
    monkeypatch.setattr(ct, "sm_count", lambda device: sms)
    case = _case(n + B, n, d, B, T)
    x, W, U, b, h, c, dh = (torch.tensor(a, dtype=torch.float32) for a in case)
    for rec in (False, True):
        _fake_launch.names = []
        if rec:
            xp, want = _plain_rec(*case)
            got = ct.wide_bwd(torch.tensor(xp, dtype=torch.float32), None, U, None, h, c, dh)
            names = ("dxp", "dU")
        else:
            want = _plain(*case)
            got = ct.wide_bwd(x, W, U, b, h, c, dh)
            names = ("dx", "dW", "dU", "db")
        for name, a, r in zip(names, got, want):
            assert a.dtype == torch.float32 and tuple(a.shape) == r.shape
            np.testing.assert_allclose(a.numpy(), r, rtol=0, atol=2e-5 * np.abs(r).max(), err_msg=name)
        split = T * B >= 512
        chains = -(-B // ct.chain_plan(B, n, sms).chunk_rows)
        phases = ["wide_gemm"] + ["wide_bwd_chain"] * chains + (["wide_gemm"] if rec else ["wide_gemm"] * 3)
        assert _fake_launch.names == phases + (["sum_splits"] if split else []), _fake_launch.names
