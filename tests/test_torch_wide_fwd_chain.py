"""The wide-layer train forward's launch rule and kernels (K9's and K6's:
svd_lstm_tpu_torch/ops/cuda_train.py ``wide_fwd``, ops/csrc/lstm_train.cu
``gemm_f32`` and ``wide_fwd_chain``), on the CPU, without a card.

The forward runs two parts: the x-side (``gemm_f32`` NN with the bias: xz =
x·W + b over all T·B rows; K6 takes its xp as xz) and the chain
(``wide_fwd_chain``: one persistent launch a chunk of rows, a CTA owning R
rows × J units with their gate columns of U on chip, h_{t-1} of its row
tiles read back after the grid barrier, c carried, one barrier a step).

* The rule (``fwd_chain_plan``: ``chain_plan``'s grid with the forward's
  shared memory) at the repo's shapes and over a sweep of widths and
  batches: every grid at most one CTA an SM, every tile within a block's
  shared memory, the batch in as few launches as its row tiles allow.
* A float64 numpy emulation of both kernels, index by index, every buffer
  between NaN guards (and h and c NaN until written), the CTAs of a step in
  a shuffled order between two barriers, held against
  ``wide_layer_fwd_plain`` and ``lstm_recurrence_train_fwd_plain`` for
  ragged B, T = 1, d = 16 and 7, n = 128 and 256, every tile the rule
  takes, both weight homes and a chain in two launches; its result does not
  depend on the CTAs' order.
* The mutations "barrier" (a CTA reads the h of the step the others are
  writing), "state" (c not carried) and "mask" (rows past B stored) each
  make it disagree.
* ``wide_fwd`` itself on CPU tensors, with ``_launch`` replaced by the same
  emulation reading the wrapper's pointers.

The kernels themselves run only on the card (tests/test_torch_train_kernels.py,
``cuda`` marker).
"""

import ctypes

import numpy as np
import pytest
import torch

from svd_lstm_tpu_torch.ops import cuda_train as ct
from svd_lstm_tpu_torch.ops.cuda_lstm import _SMEM_LIMIT
from test_torch_wide_bwd import TOL as GUARD_TOL
from test_torch_wide_bwd import Memory, PointerMemory, Seg, gemm

SMS = 132


# ---------------------------------------------------------------------------
# the launch rule
# ---------------------------------------------------------------------------

# (B, n) -> (rows, units, staged, unit groups, row groups, row tiles, chunk rows, shared bytes)
PLAN_CASES = [
    ((128, 512), (32, 16, True, 32, 4, 1, 128, 197_120)),    # runs C, D, F
    ((1, 512), (32, 16, True, 32, 1, 1, 32, 197_120)),
    ((130, 512), (32, 16, True, 32, 4, 2, 160, 197_120)),
    ((256, 256), (32, 16, True, 16, 8, 1, 256, 98_816)),
    ((20, 1024), (32, 16, False, 64, 1, 1, 32, 131_584)),     # U from the global copy
    ((2048, 512), (32, 16, True, 32, 4, 8, 1024, 197_120)),  # two launches
    ((20, 2176), (16, 32, False, 68, 1, 2, 32, 139_520)),
    ((20, 4352), (8, 64, False, 68, 1, 3, 24, 139_392)),
]


@pytest.mark.parametrize("shape,want", PLAN_CASES)
def test_plan_at_the_repo_shapes(shape, want):
    B, n = shape
    plan = ct.fwd_chain_plan(B, n, SMS)
    assert tuple(plan) == want
    assert plan.ctas <= SMS and plan.smem_bytes <= _SMEM_LIMIT
    # the grid and chunks are the backward chain's
    bwd = ct.chain_plan(B, n, SMS)
    assert (plan.rows, plan.units, plan.unit_groups, plan.row_groups, plan.row_tiles,
            plan.chunk_rows) == (bwd.rows, bwd.units, bwd.unit_groups, bwd.row_groups,
                                 bwd.row_tiles, bwd.chunk_rows)


@pytest.mark.parametrize("sms", [SMS, 114, 16])
def test_plan_sweep_stays_within_the_card(sms):
    """Every width the wide kernels take (n % 128 == 0) up to 64 units an
    SM, batches up to 4100: a plan whose tile fits a block's shared memory
    (U staged at the first tile where it fits beside h's rows), or a
    ValueError where the rows of h alone do not fit."""
    for n in range(128, 64 * sms + 1, 128):
        for B in [1, 31, 33, 128, 129, 1024, 1025, 4100]:
            rows = next(t for t in ct.CHAIN_TILES if n // t[1] <= sms)[0]
            if ct.fwd_chain_smem_bytes(n, rows, 0, False) > _SMEM_LIMIT:
                with pytest.raises(ValueError, match="shared memory"):
                    ct.fwd_chain_plan(B, n, sms)
                continue
            plan = ct.fwd_chain_plan(B, n, sms)
            assert plan.ctas <= sms and plan.smem_bytes <= _SMEM_LIMIT
            assert plan.smem_bytes == ct.fwd_chain_smem_bytes(n, plan.rows, plan.units, plan.staged)
            assert plan.staged == ((plan.rows, plan.units) == ct.CHAIN_TILES[0] and
                                   ct.fwd_chain_smem_bytes(n, 32, 16, True) <= _SMEM_LIMIT)
            assert (plan.rows // 4) * plan.units == 128  # csrc FWD_CHAIN_THREADS: 4 rows x 1 unit a thread


# ---------------------------------------------------------------------------
# the emulation
# ---------------------------------------------------------------------------

def _sigm(v):
    return 1.0 / (1.0 + np.exp(-v))


def fwd_chain(mem, xz, Ui, h, c, T, B, stride, n, rows, units, staged, row_groups, order_seed=0,
              mutation=None):
    """csrc wide_fwd_chain over B rows of a batch of ``stride`` rows (the
    addresses at the chunk's first row): the CTAs of a step in a shuffled
    order (the grid barrier ends the step), each walking its row tiles; h
    of the previous step read for the tile's rows (zero past B, as
    cp.async's zero-fill); the staged copy of U or the global one."""
    R, J = rows, units
    G, groups = 4 * n, n // J
    tiles = -(-B // R)
    assert 1 <= row_groups <= tiles and n % J == 0 and stride >= B and (R // 4) * J == 128
    row_tiles = -(-tiles // row_groups)
    assert row_tiles <= ct.CHAIN_MAX_ROW_TILES
    rng = np.random.default_rng(order_seed)
    ctas = [(ug, rg) for ug in range(groups) for rg in range(row_groups)]
    cs = {cta: np.zeros((row_tiles, R, J)) for cta in ctas}
    r_ = np.arange(R)[:, None]
    u_ = np.arange(J)[None, :]
    k_ = np.arange(n)
    us = {}
    for ug in range(groups):  # [k, unit, gate]
        idx = Ui + (k_[:, None, None] * n + ug * J + u_[..., None]) * 4 + np.arange(4)
        us[ug] = mem.read(idx, True) if staged else idx  # staged: values; global: addresses
    for t in range(T):
        for ci in rng.permutation(len(ctas)):
            ug, rg = ctas[ci]
            for tile in range(row_tiles):
                row = (rg + tile * row_groups) * R + r_
                ok = row < B
                m = t * stride + row
                j = ug * J + u_
                acc = np.zeros((4, R, J))
                if t > 0:
                    tp = t if mutation == "barrier" else t - 1
                    hs = mem.read(h + (tp * stride + row) * n + k_[None, :], ok)  # (R, n)
                    w = us[ug] if staged else mem.read(us[ug], True)
                    acc = np.einsum("rk,kjg->grj", hs, w)
                z = np.stack([mem.read(xz + m * G + g * n + j, ok) for g in range(4)]) + acc
                i, f, g_, o = _sigm(z[0]), _sigm(z[1]), np.tanh(z[2]), _sigm(z[3])
                cp = 0.0 if mutation == "state" else cs[(ug, rg)][tile]
                cn = f * cp + i * g_
                hn = o * np.tanh(cn)
                cs[(ug, rg)][tile] = np.where(ok, cn, 0.0)
                store = np.ones_like(ok) if mutation == "mask" else ok
                mem.write(h + m * n + j, hn, store)
                mem.write(c + m * n + j, cn, store)


def emulate(x, W, U, b, sms=SMS, staged=None, mutation=None, order_seed=0):
    """K9's forward (W given: the x-side GEMM, then the chain) or K6's (W
    None, x the projection xp) on a fresh Memory, as ``wide_fwd`` orders
    them; ``staged`` overrides the weight home. Returns h, c, float64."""
    T, B, din = x.shape
    n = U.shape[0]
    G, M = 4 * n, T * B
    plan = ct.fwd_chain_plan(B, n, sms)
    if staged is not None:
        plan = plan._replace(staged=staged)
    mem = Memory()
    xa = mem.put(x)
    Ui = mem.put(ct.pack_gates_interleaved(torch.from_numpy(np.asarray(U))).numpy())
    if W is None:
        xz = xa
    else:
        Wa, ba = mem.put(W), mem.put(b)
        xz = mem.alloc(M * G)
        gemm(mem, [Seg(A=xa, B=Wa, lda=din, ldb=G, a_t=0, b_t=0, shift=0, ones_row=-1, K=din)],
             M, G, xz, G, bias=ba)
    h, c = mem.alloc(M * n), mem.alloc(M * n)
    for b0 in range(0, B, plan.chunk_rows):  # phase_chain_fwd's launches
        rows = min(plan.chunk_rows, B - b0)
        fwd_chain(mem, xz + b0 * G, Ui, h + b0 * n, c + b0 * n, T, rows, B, n, plan.rows, plan.units,
                  plan.staged, min(plan.row_groups, -(-rows // plan.rows)), order_seed, mutation)
    return mem.get(h, (T, B, n)), mem.get(c, (T, B, n))


def _case(seed, n, d, B, T):
    rng = np.random.default_rng(seed)
    W = rng.normal(scale=d ** -0.5, size=(d, 4 * n))
    U = rng.normal(scale=n ** -0.5, size=(n, 4 * n))
    b = rng.normal(scale=0.1, size=(4 * n,))
    x = rng.normal(size=(T, B, d))
    return x, W, U, b


def _plain(x, W, U, b):
    h, c = ct.wide_layer_fwd_plain(*(torch.from_numpy(np.asarray(a, np.float64)) for a in (x, W, U, b)))
    return h.numpy(), c.numpy()


def _plain_rec(x, W, U, b):
    xp = x @ W + b
    h, c = ct.lstm_recurrence_train_fwd_plain(torch.from_numpy(xp), torch.from_numpy(U))
    return xp, (h.numpy(), c.numpy())


# (n, d, B, T, sms, staged): ragged B (1, 17, 40: masked row tiles; 70 at 2
# row groups: two row tiles a CTA), T = 1 (no h read back), d = 16 and 7,
# n = 128 and 256, U staged and from the global copy; on fewer SMs the
# wider unit groups (16 x 32, 8 x 64) and more launches (B = 300 on 8 SMs)
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
]


@pytest.mark.parametrize("n,d,B,T,sms,staged", EMULATION_CASES)
def test_emulation_matches_the_plain_forward(n, d, B, T, sms, staged):
    case = _case(n + d + B + T, n, d, B, T)
    for name, a, r in zip("hc", emulate(*case, sms=sms, staged=staged), _plain(*case)):
        np.testing.assert_allclose(a, r, err_msg=name, **GUARD_TOL)
    x, W, U, b = case
    xp, want = _plain_rec(*case)
    for name, a, r in zip("hc", emulate(xp, None, U, None, sms=sms, staged=staged), want):
        np.testing.assert_allclose(a, r, err_msg=name, **GUARD_TOL)


def test_emulation_covers_each_tile_and_chunking():
    plans = [ct.fwd_chain_plan(B, n, sms) for n, _, B, _, sms, _ in EMULATION_CASES]
    assert {(p.rows, p.units) for p in plans} == set(ct.CHAIN_TILES)
    assert any(p.row_tiles > 1 for p in plans)
    assert any(p.chunk_rows < B for p, (_, _, B, _, _, _) in zip(plans, EMULATION_CASES))
    assert {p.staged for p in plans} | {s for *_, s in EMULATION_CASES if s is not None} == {True, False}


def test_chain_result_does_not_depend_on_the_cta_order():
    case = _case(4, 128, 16, 40, 3)
    for a, b in zip(emulate(*case, order_seed=1), emulate(*case, order_seed=2)):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("mutation", ["barrier", "state", "mask"])
def test_a_mutated_schedule_disagrees(mutation):
    """A CTA reading h of the step the others are writing (NaN where not yet
    written, their values where written), the cell state not carried, a
    row tile storing its rows past B: B = 300 on 8 SMs runs the chain in two
    launches, and the second one's ragged tile stores into the next step's
    rows of the first, which are final already."""
    sms = 8 if mutation == "mask" else SMS
    case = _case(5, 128, 7, 300 if mutation == "mask" else 17, 3)
    want = _plain(*case)
    got = emulate(*case, mutation=mutation, sms=sms)
    assert not all(np.allclose(a, r, **GUARD_TOL) for a, r in zip(got, want))


# ---------------------------------------------------------------------------
# wide_fwd itself, on CPU tensors, through the emulation
# ---------------------------------------------------------------------------

def _fake_launch(name, device, *args):
    """The C entry points of the forward, emulated on the wrapper's own
    pointers (csrc wide_gemm_launch's meta layout)."""
    mem = PointerMemory()
    if name == "wide_gemm":
        meta = np.ctypeslib.as_array((ctypes.c_int64 * (10 + 9 * ct.GEMM_MAX_SEGS)).from_address(args[0]))
        nseg, M, N, C, ldc, bias, addend, splits, kchunk, split_stride = (int(v) for v in meta[:10])
        assert nseg == 1 and splits == 1 and addend == 0 and bias % 4 == 0
        A, Bp, lda, ldb, a_t, b_t, shift, ones_row, K = (int(v) for v in meta[10:19])
        gemm(mem, [Seg(A=A // 4, B=Bp // 4, lda=lda, ldb=ldb, a_t=a_t, b_t=b_t, shift=shift,
                       ones_row=ones_row, K=K)], M, N, C // 4, ldc, bias // 4)
    elif name == "wide_fwd_chain":
        xz, Ui, h, c, T, B, stride, n, rows, units, staged, row_groups, bf16 = args
        assert Ui % 16 == 0 and bf16 == 0  # the emulation is of the float32 kernels
        fwd_chain(mem, xz // 4, Ui // 4, h // 4, c // 4, T, B, stride, n, rows, units, staged,
                  row_groups)
    else:
        raise AssertionError(f"unexpected launch {name}")
    _fake_launch.names.append(name)


@pytest.mark.parametrize("n,d,B,T,sms", [(128, 16, 17, 3, SMS), (128, 7, 130, 4, SMS),
                                         (256, 16, 5, 1, SMS), (128, 16, 300, 2, 8)])
def test_wide_fwd_through_the_emulated_kernels(n, d, B, T, sms, monkeypatch):
    """wide_fwd's x-side GEMM, its packing of U, the chain's chunk offsets
    on CPU tensors, each launch emulated on its pointers: float32 results
    within float32 rounding of the float64 plain forward; one GEMM (K9) and
    one chain launch a chunk, whatever T."""
    monkeypatch.setattr(ct, "_launch", _fake_launch)
    monkeypatch.setattr(ct, "sm_count", lambda device: sms)
    case = _case(n + B, n, d, B, T)
    x, W, U, b = (torch.tensor(a, dtype=torch.float32) for a in case)
    chains = ["wide_fwd_chain"] * -(-B // ct.fwd_chain_plan(B, n, sms).chunk_rows)
    for rec in (False, True):
        _fake_launch.names = []
        if rec:
            xp, want = _plain_rec(*case)
            got = ct.wide_fwd(torch.tensor(xp, dtype=torch.float32), None, U, None)
        else:
            want = _plain(*case)
            got = ct.wide_fwd(x, W, U, b)
        for name, a, r in zip("hc", got, want):
            assert a.dtype == torch.float32 and tuple(a.shape) == r.shape
            np.testing.assert_allclose(a.numpy(), r, rtol=0, atol=2e-5 * max(1.0, np.abs(r).max()),
                                       err_msg=name)
        assert _fake_launch.names == ([] if rec else ["wide_gemm"]) + chains, _fake_launch.names


# ---------------------------------------------------------------------------
# on the card: the forward against its plain version, each tile and home
# ---------------------------------------------------------------------------

@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("n,d,B,T,staged", [
    (128, 16, 17, 12, None),    # a ragged row tile, U staged
    (256, 7, 70, 9, False),     # three row groups, a ragged tile, U from the global copy
    (512, 512, 128, 16, None),  # run C's layer shape
    (512, 16, 1030, 5, None),   # the chain in two launches
])
def test_cuda_wide_fwd_matches_plain(cuda, n, d, B, T, staged, monkeypatch):
    """h and c of K9's and K6's forward within max(1e-4, twice the plain
    float32 version's distance from float64), as chip_smoke.py holds them."""
    if staged is not None:
        rule = ct.fwd_chain_plan
        monkeypatch.setattr(ct, "fwd_chain_plan", lambda *a: rule(*a)._replace(staged=staged))
    case = _case(7 + n + B, n, d, B, T)
    x, W, U, b = (torch.tensor(a, dtype=torch.float32, device=cuda) for a in case)
    for rec in (False, True):
        if rec:
            xp = (torch.matmul(x, W) + b).contiguous()
            got = ct.wide_fwd(xp, None, U, None)
            want = ct.lstm_recurrence_train_fwd_plain(xp, U)
            want64 = ct.lstm_recurrence_train_fwd_plain(xp.double(), U.double())
        else:
            got = ct.wide_fwd(x, W, U, b)
            want = ct.wide_layer_fwd_plain(x, W, U, b)
            want64 = ct.wide_layer_fwd_plain(x.double(), W.double(), U.double(), b.double())
        torch.cuda.synchronize()
        for name, a, r, r64 in zip("hc", got, want, want64):
            drift = float((r.double() - r64).abs().max())
            err = float((a - r).abs().max())
            assert err <= max(1e-4, 2 * drift), (name, rec, err, drift)
