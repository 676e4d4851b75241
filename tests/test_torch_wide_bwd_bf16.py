"""K9f's and K6f's tensor-core backward (svd_lstm_tpu_torch/ops/cuda_train.py
``wide_bwd_bf16``, ops/csrc/lstm_train.cu ``gemm_bf16``, ``bf16_copy`` and
``wide_bwd_chain``'s BF16 instantiation) on the CPU, without a card.

The backward makes bf16 copies of x, W, U and h (``bf16_copy``: rounded to
nearest even, each row stride padded with zeros to a multiple of 8, W's copy
with as many rows as x's has columns), runs phase R (``gemm_bf16`` NN: z =
x·W + h_prev·U + b, h_prev a TMA box B rows up, zero-filled above row 0),
C (the bf16 dh chain: dz and its rounded copy, the product dz·Uᵀ on the
tensor cores into partial sums laid out [reader group][writer group][row]
[J], read in group order from the other parity), X (``gemm_bf16`` NT: dx =
dz·Wᵀ, W's tile K-major) and G (``gemm_bf16`` TN: dW and dU, their A tiles
M-major, split over the T·B rows in whole 64-row chunks and summed in
order; db the unrounded sum of dz).

* A float64 numpy emulation of those kernels, tile by tile: TMA's boxes with
  their coordinates (the −B shift, negative rows and every ragged edge
  zero-filled), the copies' padded strides, each form's transposes, the split
  order; the chain's CTAs of a step in a shuffled order, each tile's
  product, the partial sums read in group order. Operands are rounded as the
  copies round them. It is held against ``wide_layer_bwd_plain(..., True)``
  and ``lstm_recurrence_train_bwd_plain(..., True)`` in float64 for ragged
  B, T = 1, d = 16 and 7, n = 128 and 256, every chain tile, and a chain in
  two launches.
* Mutations (the shift off by one row, a lost transpose, non-zero padding,
  the chain reading the parity it writes) each make it disagree.
* The launch rule's Python twin: the chain's shared bytes
  (``chain_smem_bytes_bf16``) and weight home, the padded-stride rule
  (``bf16_ld``), the split rule at one CTA an SM.
* ``wide_bwd_bf16`` itself, its copies, meta arrays, offsets, splits and
  views, on CPU tensors with ``_launch`` replaced by the same emulation
  reading and writing the wrapper's own memory.

The kernels themselves run only on the card (tests/test_torch_train_kernels.py,
``cuda`` marker).
"""

import ctypes

import numpy as np
import pytest
import torch

from svd_lstm_tpu_torch.ops import cuda_train as ct
from svd_lstm_tpu_torch.ops.cuda_lstm import _SMEM_LIMIT

SMS = 132  # the H100 SXM's SM count
TOL = dict(rtol=1e-9, atol=1e-9)  # float64 emulation against the float64 plain version
BM = BN = 128  # csrc GB_BM, GB_BN
BK = ct.GEMM_BF16_BK


def rn(a):
    """bf16 rounding (to nearest even), kept in float64: the copies'."""
    return torch.from_numpy(np.asarray(a, np.float64)).to(torch.bfloat16).double().numpy()


# ---------------------------------------------------------------------------
# the launch rule
# ---------------------------------------------------------------------------

# (B, n) -> (rows, units, staged, unit groups, row groups, row tiles, chunk rows, shared bytes)
PLAN_CASES = [
    ((128, 512), (32, 16, True, 32, 4, 1, 128, 78_336)),     # runs C, D, F
    ((17, 512), (32, 16, True, 32, 1, 1, 32, 78_336)),
    ((256, 256), (32, 16, True, 16, 8, 1, 256, 41_472)),
    ((33, 128), (32, 16, True, 8, 2, 1, 64, 23_040)),
    ((20, 1024), (32, 16, True, 64, 1, 1, 32, 152_064)),     # staged in bf16 (global in float32)
    ((20, 2048), (32, 16, False, 128, 1, 1, 32, 4_608)),     # past 1582 units: U from the copy
    ((2048, 512), (32, 16, True, 32, 4, 8, 1024, 78_336)),   # two launches
    ((20, 2176), (16, 32, False, 68, 1, 2, 32, 4_352)),      # 136 groups of 16 > 132 SMs
    ((20, 4352), (8, 64, False, 68, 1, 3, 24, 8_448)),       # 136 groups of 32 > 132 SMs
]


@pytest.mark.parametrize("shape,want", PLAN_CASES)
def test_bf16_plan_at_the_repo_shapes(shape, want):
    B, n = shape
    plan = ct.chain_plan(B, n, SMS, ct.chain_smem_bytes_bf16)
    assert tuple(plan) == want
    assert plan.ctas <= SMS and plan.smem_bytes <= _SMEM_LIMIT


@pytest.mark.parametrize("sms", [SMS, 114, 16])
def test_bf16_plan_sweep_stays_within_the_card(sms):
    """Every wide width to 64 units an SM: the float32 rule's tiles and
    grid, U staged at the first tile wherever its bf16 rows fit beside the
    dz tile (n ≤ 1582), each launch within a block's shared memory."""
    for n in range(128, 64 * sms + 1, 128):
        for B in [1, 33, 128, 1025, 4100]:
            plan = ct.chain_plan(B, n, sms, ct.chain_smem_bytes_bf16)
            f32 = ct.chain_plan(B, n, sms)
            assert plan._replace(staged=f32.staged, smem_bytes=f32.smem_bytes) == f32
            assert plan.staged == ((plan.rows, plan.units) == ct.CHAIN_TILES[0] and n <= 1582)
            assert plan.smem_bytes == ct.chain_smem_bytes_bf16(n, plan.rows, plan.units, plan.staged)
            assert plan.smem_bytes <= _SMEM_LIMIT


def test_bf16_chain_bytes_and_padded_strides():
    """The chain's rows: 4J + 8 bf16 (16 bytes of padding), the dz tile's
    rows rounded to 16; a copy's stride: the next multiple of 8 columns."""
    assert ct.chain_smem_bytes_bf16(512, 32, 16, True) == 2 * 72 * (32 + 512)
    assert ct.chain_smem_bytes_bf16(4352, 8, 64, False) == 2 * 264 * 16
    assert ct.chain_smem_bytes_bf16(1582, 32, 16, True) <= _SMEM_LIMIT
    assert ct.chain_smem_bytes_bf16(1583, 32, 16, True) > _SMEM_LIMIT
    for cols in range(1, 2100):
        ld = ct.bf16_ld(cols)
        assert ld % ct.BF16_ALIGN == 0 and cols <= ld < cols + ct.BF16_ALIGN
    assert [ct.bf16_ld(c) for c in (7, 16, 512, 2048)] == [8, 16, 512, 2048]


@pytest.mark.parametrize("K,tiles,want", [
    (25_600, 128, 1),  # K9f at runs C and F: dW 4 x 16 tiles, dU 4 x 16: one wave already
    (25_600, 64, 2),   # K6f at run D: dU
    (25_600, 80, 13),  # K9f's first layer (d = 16): dW 1 x 16, dU 4 x 16
    (520, 8, 2),       # the emulation's split case
])
def test_gemm_splits_at_one_cta_an_sm(K, tiles, want):
    assert ct.gemm_splits(K, tiles, SMS, ct.GEMM_BF16_PER_SM) == want


# ---------------------------------------------------------------------------
# the emulation
# ---------------------------------------------------------------------------

def copy(a, rows=None, pad=0.0):
    """csrc bf16_copy: a (r, cols) rounded into (rows, bf16_ld(cols)); the
    padding ``pad`` (0, as the kernel writes it; the mutation writes 1)."""
    r, cols = a.shape
    out = np.full((r if rows is None else rows, ct.bf16_ld(cols)), pad)
    out[:r, :cols] = rn(a)
    return out


def box(mat, c0, c1, w, h):
    """TMA's 2-D box of a (rows, ld) copy: rows [c1, c1 + h), columns [c0,
    c0 + w), zero outside the copy (negative coordinates too)."""
    out = np.zeros((h, w))
    r, k = np.arange(c1, c1 + h), np.arange(c0, c0 + w)
    rm, km = (r >= 0) & (r < mat.shape[0]), (k >= 0) & (k < mat.shape[1])
    out[np.ix_(rm, km)] = mat[np.ix_(r[rm], k[km])]
    return out


def gemm(segs, M, N, form, bias=None, addend=None, splits=1, kchunk=0, mutation=None):
    """csrc gemm_bf16, tile by tile and 64-deep chunk by chunk: each
    segment (A, B, K, shift) of copies, the boxes its form loads (A K-major
    128 x 64, or M-major two of 64 x 64; B N-major two of 64 x 64, or
    K-major 128 x 64) and the transposes wgmma applies. Returns (splits, M,
    N): split z's sums over k in [z·kchunk, (z + 1)·kchunk)."""
    at, bt = form == "TN", form == "NT"
    out = np.full((splits, M, N), np.nan)
    for z in range(splits):
        chunks = []
        for A, Bm, K, shift in segs:
            kb = min(K, z * kchunk) if splits > 1 else 0
            ke = min(K, kb + kchunk) if splits > 1 else K
            if mutation == "shift" and shift:
                shift -= 1
            chunks += [(A, Bm, k0, shift) for k0 in range(kb, ke, BK)]
        for i0 in range(0, M, BM):
            for j0 in range(0, N, BN):
                acc = np.zeros((BM, BN))
                for A, Bm, k0, sh in chunks:
                    if at:  # stored rows are k: the boxes read transposed (unless the flag is lost)
                        boxes = [box(A, i0 + 64 * w, k0 - sh, 64, 64) for w in (0, 1)]
                        As = np.vstack(boxes if mutation == "transpose" else [b.T for b in boxes])
                    else:
                        As = box(A, k0, i0 - sh, 64, BM)
                    if bt:
                        Bs = box(Bm, k0, j0, 64, BN).T
                    else:
                        Bs = np.hstack([box(Bm, j0 + 64 * w, k0, 64, 64) for w in (0, 1)])
                    acc += As @ Bs
                rows, cols = slice(i0, min(M, i0 + BM)), slice(j0, min(N, j0 + BN))
                v = acc[: rows.stop - i0, : cols.stop - j0]
                if bias is not None:
                    v = v + bias[cols]
                if addend is not None:
                    v = v + addend[rows, cols]
                out[z, rows, cols] = v
    return out


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


def chain(z, Ub, c, dh_seq, dz, dzb, P, b0, B, plan, row_groups, order_seed=0, mutation=None):
    """One launch of the bf16 chain over rows [b0, b0 + B) of the batch: z
    (T, Btot, 4n), c and dh_seq (T, Btot, n) float64; writes dz (T, Btot,
    4n) and its rounded copy dzb. P (flat, shared by the launches as the
    wrapper's buffer): the partial sums, each parity [reader group][writer
    group][row][J] at this launch's B. The CTAs of a step run in a
    shuffled order; each tile's dz rows past B are NaN in the product's
    operand, so a read past the mask shows. ``mutation="parity"`` reads
    the parity the step writes."""
    T, _, G = z.shape
    n, R, J = G // 4, plan.rows, plan.units
    groups = n // J
    tiles = -(-B // R)
    row_tiles = -(-tiles // row_groups)
    rng = np.random.default_rng(order_seed)
    ctas = [(ug, rg) for ug in range(groups) for rg in range(row_groups)]
    dc = {cta: np.zeros((row_tiles, R, J)) for cta in ctas}
    r_, u_ = np.arange(R)[:, None], np.arange(J)[None, :]
    kk = np.arange(4 * J)
    pstride = groups * B * n  # floats of one parity

    def at(par, reader, writer, rows):  # (len(rows), J) indices into P
        return par * pstride + ((reader * groups + writer) * B + rows[:, None]) * J + np.arange(J)

    for t in range(T - 1, -1, -1):
        for ci in rng.permutation(len(ctas)):
            ug, rg = ctas[ci]
            j0 = ug * J
            cols = (kk // J) * n + j0 + kk % J  # the CTA's gate columns
            for tile in range(row_tiles):
                row = (rg + tile * row_groups) * R + r_  # (R, 1) rows of the chunk
                ok = row < B
                rb = np.minimum(row, B - 1)[:, 0] + b0  # rows of the batch (masked past B)
                j = j0 + u_
                zv = np.stack([z[t, rb][:, g * n + j0 : g * n + j0 + J] for g in range(4)])
                ct_, dh = c[t, rb][:, j0 : j0 + J], dh_seq[t, rb][:, j0 : j0 + J].copy()
                cp = c[t - 1, rb][:, j0 : j0 + J] if t > 0 else np.zeros((R, J))
                if t + 1 < T:
                    par = (t & 1) if mutation == "parity" else ((t + 1) & 1)
                    rows_ = np.minimum(row[:, 0], B - 1)
                    s = np.zeros((R, J))
                    for u in range(groups):  # in group order
                        s = s + P[at(par, ug, u, rows_)]
                    dh = dh + s
                g4, dcv = gate_bwd(zv, cp, ct_, dh, dc[(ug, rg)][tile])
                dc[(ug, rg)][tile] = np.where(ok, dcv, 0.0)
                for g in range(4):
                    sel = rb[ok[:, 0]]
                    dz[t, sel, g * n + j0 : g * n + j0 + J] = g4[g][ok[:, 0]]
                    dzb[t, sel, g * n + j0 : g * n + j0 + J] = rn(g4[g][ok[:, 0]])
                if t > 0:  # P_t[every reader][this group] = rn(dz tile) · U's rows at the gate columns
                    dzt = np.where(ok, rn(np.concatenate(list(g4), axis=1)), np.nan)  # (R, 4J)
                    part = dzt @ Ub[:, cols].T  # (R, n)
                    stored = row[ok[:, 0], 0]
                    for X in range(groups):
                        P[at(t & 1, X, ug, stored)] = part[ok[:, 0], X * J : (X + 1) * J]


def emulate(x, W, U, b, h, c, dh_seq, sms=SMS, mutation=None, order_seed=0):
    """The bf16 backward of K9f (W given) or K6f (W None, x the projection
    xp) in float64 as ``wide_bwd_bf16`` orders it, on a card of ``sms``
    SMs. Returns (dx, dW, dU, db) or (dxp, dU)."""
    T, B, din = x.shape
    n = U.shape[0]
    G, M = 4 * n, T * B
    plan = ct.chain_plan(B, n, sms, ct.chain_smem_bytes_bf16)
    pad = 1.0 if mutation == "padding" else 0.0
    Ub, hb = copy(U, pad=pad), copy(h.reshape(M, n), pad=pad)
    h_prev = (hb, Ub, n, B)
    if W is None:
        z = gemm([h_prev], M, G, "NN", addend=x.reshape(M, G), mutation=mutation)[0]
    else:
        xb = copy(x.reshape(M, din), pad=pad)
        Wb = copy(W, rows=xb.shape[1], pad=pad)
        z = gemm([(xb, Wb, xb.shape[1], 0), h_prev], M, G, "NN", bias=b, mutation=mutation)[0]
    z = z.reshape(T, B, G)
    dz, dzb = np.full((T, B, G), np.nan), np.full((T, B, G), np.nan)
    P = np.full(2 * plan.unit_groups * min(B, plan.chunk_rows) * n, np.nan)
    for b0 in range(0, B, plan.chunk_rows):  # phase_c_bf16's launches
        rows = min(plan.chunk_rows, B - b0)
        chain(z, Ub, c, dh_seq, dz, dzb, P, b0, rows, plan, min(plan.row_groups, -(-rows // plan.rows)),
              order_seed, mutation)
    dzb2 = dzb.reshape(M, G)
    gemms = [] if W is None else [(din, (xb, dzb2, M, 0))]
    gemms.append((n, (hb, dzb2, M, B)))
    S = ct.gemm_splits(M, sum(-(-r // BM) * -(-G // BN) for r, _ in gemms), sms, ct.GEMM_BF16_PER_SM)
    kchunk = -(-(-(-M // S)) // BK) * BK
    grads = []
    for r, seg in gemms:
        partial = gemm([seg], r, G, "TN", splits=S, kchunk=kchunk, mutation=mutation)
        total = np.zeros((r, G))
        for s in range(S):  # sum_splits, in order
            total = total + partial[s]
        grads.append(total)
    if W is None:
        return dz, grads[0]
    dx = gemm([(dzb2, Wb, G, 0)], M, din, "NT", mutation=mutation)[0]
    return dx.reshape(T, B, din), grads[0], grads[1], dz.reshape(M, G).sum(0)


def _case(seed, n, d, B, T):
    rng = np.random.default_rng(seed)
    W = rng.normal(scale=d ** -0.5, size=(d, 4 * n)).astype(np.float32).astype(np.float64)
    U = rng.normal(scale=n ** -0.5, size=(n, 4 * n)).astype(np.float32).astype(np.float64)
    b = rng.normal(scale=0.1, size=(4 * n,)).astype(np.float32).astype(np.float64)
    x = rng.normal(size=(T, B, d)).astype(np.float32).astype(np.float64)
    dh = rng.normal(size=(T, B, n)).astype(np.float32).astype(np.float64)
    h, c = ct.wide_layer_fwd_plain(*(torch.from_numpy(a) for a in (x, W, U, b)), True)
    return x, W, U, b, h.numpy(), c.numpy(), dh


def _plain(x, W, U, b, h, c, dh):
    args = [torch.from_numpy(np.asarray(a, np.float64)) for a in (x, W, U, b, h, c, dh)]
    return [g.numpy() for g in ct.wide_layer_bwd_plain(*args, True)]


def _plain_rec(x, W, U, b, h, c, dh):
    xp = rn(x) @ rn(W) + b
    args = [torch.from_numpy(np.asarray(a, np.float64)) for a in (xp, U, h, c, dh)]
    return xp, [g.numpy() for g in ct.lstm_recurrence_train_bwd_plain(*args, True)]


# (n, d, B, T, sms): ragged B (1, 17, 40, 20), T = 1, d = 16 and 7, n = 128
# and 256; on fewer SMs the wider tiles (n = 128 on 4 SMs: 16 x 32; n = 256 on
# 4 SMs: 8 x 64, U from the copy) and a chain in two launches (B = 300 on 8
# SMs); T·B = 520: phase G in two splits, the second ragged
EMULATION_CASES = [
    (128, 16, 17, 4, SMS), (128, 7, 1, 3, SMS), (256, 16, 40, 3, SMS), (128, 16, 9, 1, SMS),
    (128, 7, 20, 3, 4), (256, 16, 19, 2, 4), (128, 7, 300, 2, 8), (128, 7, 130, 4, SMS),
]


@pytest.mark.parametrize("n,d,B,T,sms", EMULATION_CASES)
def test_emulation_matches_the_plain_bf16_backward(n, d, B, T, sms):
    case = _case(n + d + B + T, n, d, B, T)
    for name, a, r in zip(("dx", "dW", "dU", "db"), emulate(*case, sms=sms), _plain(*case)):
        np.testing.assert_allclose(a, r, err_msg=name, **TOL)
    x, W, U, b, h, c, dh = case
    xp, want = _plain_rec(*case)
    for name, a, r in zip(("dxp", "dU"), emulate(xp, None, U, None, h, c, dh, sms=sms), want):
        np.testing.assert_allclose(a, r, err_msg=name, **TOL)


def test_emulation_covers_each_tile_home_split_and_launch():
    plans = [ct.chain_plan(B, n, sms, ct.chain_smem_bytes_bf16) for n, _, B, _, sms in EMULATION_CASES]
    assert {(p.rows, p.units) for p in plans} == set(ct.CHAIN_TILES)
    assert {p.staged for p in plans} == {True, False}
    assert any(p.chunk_rows < B for p, (_, _, B, _, _) in zip(plans, EMULATION_CASES))
    assert any(ct.gemm_splits(T * B, 8, sms, ct.GEMM_BF16_PER_SM) > 1 for _, _, B, T, sms in EMULATION_CASES)


def test_chain_result_does_not_depend_on_the_cta_order():
    case = _case(4, 128, 16, 40, 3)
    for a, b in zip(emulate(*case, order_seed=1), emulate(*case, order_seed=2)):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("mutation", ["shift", "transpose", "padding", "parity"])
def test_a_mutated_schedule_disagrees(mutation):
    """h_prev's box one row off, phase G's M-major tiles taken K-major (a
    lost transpose flag), the copies' padding non-zero (d = 7: x's eighth
    column meets W's eighth row), the chain reading the parity it writes."""
    case = _case(5, 128, 7, 17, 3)
    got, want = emulate(*case, mutation=mutation), _plain(*case)
    assert not all(np.allclose(a, r, **TOL) for a, r in zip(got, want))


# ---------------------------------------------------------------------------
# wide_bwd_bf16 itself, on CPU tensors, through the emulation
# ---------------------------------------------------------------------------

def _view(ptr: int, count: int, ctype):
    return np.ctypeslib.as_array((ctype * count).from_address(ptr))


def _bf16_read(ptr, rows, ld):
    bits = _view(ptr, rows * ld, ctypes.c_uint16).astype(np.uint32) << 16
    return bits.view(np.float32).astype(np.float64).reshape(rows, ld)


def _bf16_bits(a):
    return torch.from_numpy(np.asarray(a, np.float64)).to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)


def _fake_launch(name, device, *args):
    """The C entry points of the bf16 backward, emulated on the wrapper's own
    memory (csrc gemm_bf16_launch's meta layout)."""
    if name == "bf16_copy":
        src, dst, rows, cols, rows_p, ld = args
        a = _view(src, rows * cols, ctypes.c_float).reshape(rows, cols)
        _view(dst, rows_p * ld, ctypes.c_uint16)[:] = _bf16_bits(copy(a, rows=rows_p)).ravel()
    elif name == "gemm_bf16":
        meta = [int(v) for v in _view(args[0], 11 + 8 * ct.GEMM_MAX_SEGS, ctypes.c_int64)]
        nseg, M, N, C, ldc, bias, addend, splits, kchunk, split_stride, form = meta[:11]
        segs = []
        for i in range(nseg):
            A, ar, ald, Bp, br, bld, shift, K = meta[11 + 8 * i : 19 + 8 * i]
            assert A % 16 == 0 and Bp % 16 == 0 and ald % 8 == 0 and bld % 8 == 0
            segs.append((_bf16_read(A, ar, ald), _bf16_read(Bp, br, bld), K, shift))
        assert ldc == N and (splits == 1 or (kchunk % BK == 0 and split_stride >= M * N))
        out = gemm(segs, M, N, ["NN", "NT", "TN"][form],
                   bias=_view(bias, N, ctypes.c_float) if bias else None,
                   addend=_view(addend, M * N, ctypes.c_float).reshape(M, N) if addend else None,
                   splits=splits, kchunk=kchunk)
        for s in range(splits):
            _view(C + 4 * s * split_stride, M * N, ctypes.c_float)[:] = out[s].ravel()
    elif name == "wide_bwd_chain_bf16":
        z, Ub, c, dh, dz, dzb, P, T, B, stride, n, rows, units, staged, row_groups = args
        G = 4 * n
        span = (T - 1) * stride + B  # rows from the chunk's first to its last
        zv = np.zeros((T, stride, G))
        zv.reshape(-1, G)[:span] = _view(z, span * G, ctypes.c_float).reshape(span, G)
        cv, dhv = np.zeros((T, stride, n)), np.zeros((T, stride, n))
        cv.reshape(-1, n)[:span] = _view(c, span * n, ctypes.c_float).reshape(span, n)
        dhv.reshape(-1, n)[:span] = _view(dh, span * n, ctypes.c_float).reshape(span, n)
        groups = n // units
        plan = ct.ChainPlan(rows, units, bool(staged), groups, row_groups, 0, 0, 0)
        Pv = _view(P, 2 * groups * B * n, ctypes.c_float)
        with np.errstate(invalid="ignore"):  # the buffer starts as torch.empty left it
            P64 = Pv.astype(np.float64)
        dzo, dzbo = np.full((T, stride, G), np.nan), np.full((T, stride, G), np.nan)
        chain(zv, _bf16_read(Ub, n, G), cv, dhv, dzo, dzbo, P64, 0, B, plan, row_groups)
        Pv[:] = P64
        dzf = _view(dz, span * G, ctypes.c_float).reshape(span, G)
        dzbf = _view(dzb, span * G, ctypes.c_uint16).reshape(span, G)
        for t in range(T):
            sel = slice(t * stride, t * stride + B)
            dzf[sel] = dzo[t, :B]
            dzbf[sel] = _bf16_bits(dzbo[t, :B])
    elif name == "sum_splits":
        partial, out, size, splits = args
        parts = _view(partial, splits * size, ctypes.c_float).reshape(splits, size).astype(np.float64)
        total = np.zeros(size)
        for s in range(splits):
            total = total + parts[s]
        _view(out, size, ctypes.c_float)[:] = total
    elif name == "weight_grad":  # db: the sum of dz over its rows
        A, shift, dz, out, partial, M, p, G, splits = args
        assert A is None and p == 1
        _view(out, G, ctypes.c_float)[:] = _view(dz, M * G, ctypes.c_float).reshape(M, G).sum(0)
    else:
        raise AssertionError(f"unexpected launch {name}")
    _fake_launch.names.append(name)


@pytest.mark.parametrize("n,d,B,T,sms", [(128, 7, 17, 3, SMS), (128, 16, 130, 4, SMS),
                                         (128, 16, 300, 2, 8)])
def test_wide_bwd_bf16_through_the_emulated_kernels(n, d, B, T, sms, monkeypatch):
    """wide_bwd_bf16's copies, meta arrays, splits, the chain's chunk
    offsets and the returned views on CPU tensors, each launch emulated on
    its pointers, against the float64 plain bf16 version within the card's
    limit (chip_smoke.py fast_limit: 2 bf16 ulps of the largest value, or
    twice the float32 plain version's distance)."""
    monkeypatch.setattr(ct, "_launch", _fake_launch)
    monkeypatch.setattr(ct, "sm_count", lambda device: sms)
    case = _case(n + B, n, d, B, T)
    x, W, U, b, h, c, dh = (torch.tensor(a, dtype=torch.float32) for a in case)
    for rec in (False, True):
        _fake_launch.names = []
        if rec:
            xp64, want = _plain_rec(*case)
            xp = torch.tensor(xp64, dtype=torch.float32)
            got = ct.wide_bwd(xp, None, U, None, h, c, dh, True)
            want32 = ct.lstm_recurrence_train_bwd_plain(xp, U, h, c, dh, True)
            names = ("dxp", "dU")
        else:
            want = _plain(*case)
            got = ct.wide_bwd(x, W, U, b, h, c, dh, True)
            want32 = ct.wide_layer_bwd_plain(x, W, U, b, h, c, dh, True)
            names = ("dx", "dW", "dU", "db")
        for name, a, r, r32 in zip(names, got, want, want32):
            assert a.dtype == torch.float32 and tuple(a.shape) == r.shape
            ulp = 2.0 ** (np.floor(np.log2(np.abs(r).max())) - 7)
            lim = max(2 * np.abs(r32.double().numpy() - r).max(), 2 * ulp)
            np.testing.assert_allclose(a.numpy(), r, rtol=0, atol=lim, err_msg=name)
        chains = -(-B // ct.chain_plan(B, n, sms, ct.chain_smem_bytes_bf16).chunk_rows)
        copies = ["bf16_copy"] * (2 if rec else 4)
        tiles = -(-n // BM) * -(-4 * n // BN) * (1 if rec else 1 + -(-d // BM))
        split = ["sum_splits"] if ct.gemm_splits(T * B, tiles, sms, ct.GEMM_BF16_PER_SM) > 1 else []
        g = ["gemm_bf16"] + split if rec else ["gemm_bf16"] + ["gemm_bf16"] * 2 + split + ["weight_grad"]
        phases = copies + ["gemm_bf16"] + ["wide_bwd_chain_bf16"] * chains + g
        assert _fake_launch.names == phases, _fake_launch.names
