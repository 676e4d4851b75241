"""K5's persistent chain (``batched_chain`` in svd_lstm_tpu_torch/ops/csrc/
lstm_train.cu) without a card: its grid-sizing rule, and a step-wise numpy
emulation of its tile grid.

The emulation runs behind the wrapper's own launches on CPU tensors
(``_on_card`` made to say yes, the card's plan given an SM count and an
occupancy, ``_launch`` replaced): each launch reads its arguments from
memory as the kernel would (xp and h at the chunk's first row, the rows
between two steps, Uᵀ in bf16) and writes h where the kernel writes it. A
launch first poisons its rows of h with NaN (memory no CTA has written
yet). Per step the CTAs (R rows × J units each, all four gates of their
units) run in a shuffled order; each reads only h_{t-1}, which every CTA
published before the barrier, rounds it to bf16, multiplies it by its
staged columns of Uᵀ (units past n zero) in k groups of 16, each group's
sum added to a float32 accumulator in turn, adds xp_t and runs the gate
update with its c; rows past B and units past n are not written. Held
against ``batched_lstm_recurrence_plain`` within K5's limit (2 bf16 ulps of
max |h|, or twice the plain version's distance from float64 state).
Mutations of the emulation (reading h_t before the barrier, a chunk's row
offset dropped, the unit mask) must fail it.
"""

import ctypes

import numpy as np
import pytest
import torch

from svd_lstm_tpu_torch.ops import cuda_batched as cb


def _case(seed, T, B, n):
    rng = np.random.default_rng(seed)
    xp = rng.normal(size=(T, B, 4 * n)).astype(np.float32)
    U = rng.normal(scale=n ** -0.5, size=(n, 4 * n)).astype(np.float32)
    return xp, U


def _view(ptr: int, count: int, dtype) -> np.ndarray:
    size = count * np.dtype(dtype).itemsize
    return np.frombuffer((ctypes.c_uint8 * size).from_address(ptr), dtype=dtype)


def _from_bf16(bits: np.ndarray) -> np.ndarray:
    return (bits.astype(np.uint32) << 16).view(np.float32)


def _to_bf16(v: np.ndarray) -> np.ndarray:
    t = torch.from_numpy(np.ascontiguousarray(v, np.float32)).bfloat16()
    return t.view(torch.int16).numpy().view(np.uint16)


def _sigmoid(z):
    return np.float32(1) / (np.float32(1) + np.exp(-z))


def emulate_chain(xp_ptr, Ut_ptr, h_ptr, T, B, stride, n, rows, units, bf16, *, first_row,
                  rng, mutation=None):
    """One batched_lstm_recurrence_launch: B rows from the chunk pointers,
    all T steps, its CTAs shuffled every step (module docstring).
    ``first_row`` is the chunk's row in the batch (the "chunk" mutation
    drops it, so every chunk reads the first chunk's h)."""
    R, J, G4 = rows, units, 4 * n
    span = (T - 1) * stride + B  # rows from the chunk's first to its last
    if bf16:
        xp = _from_bf16(_view(xp_ptr, span * G4, np.uint16)).reshape(span, G4)
        hbits = _view(h_ptr, span * n, np.uint16).reshape(span, n)
        h_read = lambda r: _from_bf16(hbits[r])
        base_bits = _view(h_ptr - 2 * first_row * n, span * n, np.uint16).reshape(span, n)
        h_read_base = lambda r: _from_bf16(base_bits[r])

        def h_write(r, j, v):
            hbits[r, j] = _to_bf16(v)
    else:
        xp = _view(xp_ptr, span * G4, np.float32).reshape(span, G4)
        hv = _view(h_ptr, span * n, np.float32).reshape(span, n)
        h_read = lambda r: hv[r].copy()
        base = _view(h_ptr - 4 * first_row * n, span * n, np.float32).reshape(span, n)
        h_read_base = lambda r: base[r].copy()

        def h_write(r, j, v):
            hv[r, j] = v
    own = (np.arange(T)[:, None] * stride + np.arange(B)[None, :]).ravel()  # this launch's rows
    h_write(own[:, None], np.arange(n)[None, :], np.full((len(own), n), np.nan, np.float32))
    Ut = _from_bf16(_view(Ut_ptr, G4 * n, np.uint16)).reshape(G4, n).astype(np.float64)
    Kp = -(-n // 16) * 16
    gx, gy = -(-n // J), -(-B // R)
    # each CTA's staged columns: (4, J, Kp), zeros past n (units and k)
    staged, cells = {}, {}
    for ux in range(gx):
        cols = np.zeros((4, J, Kp))
        for u in range(J):
            j = ux * J + u
            if j < n or mutation == "mask":
                for g in range(4):
                    cols[g, u, :n] = Ut[(g * n + j) % G4]
        staged[ux] = cols
    for ux in range(gx):
        for uy in range(gy):
            cells[ux, uy] = np.zeros((R, J), np.float32)  # c in registers
    for t in range(T):
        order = rng.permutation(gx * gy)
        for cta in order:
            ux, uy = divmod(int(cta), gy)
            r = uy * R + np.arange(R)
            j = ux * J + np.arange(J)
            ok_r, ok_j = r < B, j < n
            acc = np.zeros((4, R, J), np.float32)
            if t > 0:
                src = t if mutation == "barrier" else t - 1
                A = np.zeros((R, Kp))
                read = h_read_base if mutation == "chunk" else h_read
                A[ok_r, :n] = _from_bf16(_to_bf16(read(src * stride + r[ok_r])))
                for k0 in range(0, Kp, 16):  # the mma's k groups, in turn
                    acc += np.einsum("rk,guk->gru", A[:, k0 : k0 + 16],
                                     staged[ux][:, :, k0 : k0 + 16]).astype(np.float32)
            z = np.zeros((4, R, J), np.float32)
            rr, jj = np.ix_(r[ok_r], j[ok_j])
            for g in range(4):
                z[g][np.ix_(ok_r, ok_j)] = xp[t * stride + rr, g * n + jj]
            z += acc
            c = cells[ux, uy]
            c[...] = _sigmoid(z[1]) * c + _sigmoid(z[0]) * np.tanh(z[2])
            h = _sigmoid(z[3]) * np.tanh(c)
            keep = np.ix_(ok_r, ok_j if mutation != "mask" else np.ones(J, bool))
            hw = h[keep]
            cols = j if mutation == "mask" else j[ok_j]
            h_write(t * stride + rr[:, :1], np.clip(cols, 0, n - 1)[None, :], hw)
    return 0


def _run_emulated(xp, U, sms, per_sm, monkeypatch, mutation=None, seed=0):
    """batched_lstm_recurrence on CPU tensors with the card's route taken:
    the plan for ``sms`` SMs at ``per_sm(rows, units, staged)`` CTAs an SM, every
    launch emulated. Returns (h, plan, the launches' first rows)."""
    rng = np.random.default_rng(seed)
    T, B, G4 = xp.shape
    n = G4 // 4
    plan = cb.batched_plan(B, n, sms, per_sm)
    firsts = []

    def launch(name, device, xp_ptr, Ut_ptr, h_ptr, c_ptr, hb_ptr, T_, B_, stride, n_, rows, units,
               bf16, staged):
        assert name == "batched_lstm_recurrence" and c_ptr is None and hb_ptr is None  # K5's
        assert staged == 1
        first = (xp_ptr - xp.data_ptr()) // (xp.element_size() * G4)
        firsts.append(first)
        emulate_chain(xp_ptr, Ut_ptr, h_ptr, T_, B_, stride, n_, rows, units, bf16,
                      first_row=first, rng=rng, mutation=mutation)

    monkeypatch.setattr(cb, "_on_card", lambda *t: True)
    monkeypatch.setattr(cb, "card_plan", lambda dev, B_, n_, bf16: plan)
    monkeypatch.setattr(cb, "_launch", launch)
    monkeypatch.setattr(cb.batched_lstm_recurrence, "launches", 0)
    h = cb.batched_lstm_recurrence(xp, U)
    return h, plan, firsts


def _limit(xp, U, want) -> float:
    ref64 = cb.batched_lstm_recurrence_plain(xp.double(), U.double())
    drift = float((want.double() - ref64).abs().max())
    ulp = 2.0 ** (np.floor(np.log2(float(want.float().abs().max()))) - 7)
    return max(2 * ulp, 2 * drift)


def _smem_occupancy(n):
    """CTAs an SM as shared memory allows (228 KB an SM, 1 KB a CTA kept
    back), at most 8: a stand-in for the occupancy API."""
    return lambda rows, units, staged: min(
        8, 233_472 // (cb.batched_smem_bytes(n, rows, units, staged) + 1024))


# T, B, n, SMs, CTAs an SM (None: as shared memory allows), launches
CASES = [
    (6, 40, 40, 132, None, 1),  # units 40..63 of the one unit group masked
    (5, 100, 40, 4, 1, 2),      # 4 CTAs: two row tiles a launch beside 2 unit groups
    (4, 33, 30, 132, None, 1),  # 4x30's width: k past n in the last group of 16
    (4, 70, 136, 5, 1, 3),      # 136 units: 5 unit groups of 32, a row tile a launch
]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("T,B,n,sms,per_sm,launches", CASES)
def test_emulated_chain_matches_plain(T, B, n, sms, per_sm, launches, dtype, monkeypatch):
    xp, U = (torch.tensor(a) for a in _case(1, T, B, n))
    xp = xp.to(dtype)
    want = cb.batched_lstm_recurrence_plain(xp, U)
    occupancy = _smem_occupancy(n) if per_sm is None else (lambda r, u, s: per_sm)
    got, plan, firsts = _run_emulated(xp, U, sms, occupancy, monkeypatch)
    assert firsts == list(range(0, B, plan.chunk_rows)) and len(firsts) == launches
    assert cb.batched_lstm_recurrence.launches == 1
    assert got.dtype == dtype
    assert float((got.float() - want.float()).abs().max()) <= _limit(xp, U, want)


@pytest.mark.parametrize("mutation,case", [
    ("barrier", CASES[0]),  # a CTA reads h_t, which other CTAs are writing
    ("chunk", CASES[1]),    # the second chunk reads the first chunk's rows
    ("mask", CASES[2]),     # units past n take U's columns and are written
])
def test_a_mutated_emulation_fails(mutation, case, monkeypatch):
    T, B, n, sms, per_sm, _ = case
    xp, U = (torch.tensor(a) for a in _case(2, T, B, n))
    xp = xp.bfloat16()
    want = cb.batched_lstm_recurrence_plain(xp, U)
    occupancy = _smem_occupancy(n) if per_sm is None else (lambda r, u, s: per_sm)
    got, _, _ = _run_emulated(xp, U, sms, occupancy, monkeypatch, mutation)
    err = float((got.float() - want.float()).abs().max())
    assert not err <= _limit(xp, U, want)


# ---------------------------------------------------------------------------
# the grid-sizing rule
# ---------------------------------------------------------------------------

def test_grid_rule_at_the_batched_point():
    """B = 256 at n = 512 (3x512) and n = 30 (4x30) on the H100's 132 SMs,
    one CTA an SM at 32 x 32 and n = 512 (166 KB): one launch each."""
    plan = cb.batched_plan(256, 512, 132, lambda r, u, s: 1)
    assert (plan.rows, plan.units, plan.unit_groups) == (32, 32, 16)
    assert plan.chunks(256) == 1 and plan.smem_bytes == 2 * (128 + 32) * 520
    plan = cb.batched_plan(256, 30, 132, lambda r, u, s: 8)
    assert (plan.rows, plan.units, plan.unit_groups, plan.chunks(256)) == (32, 32, 1, 1)


def test_grid_rule_past_one_co_resident_grid():
    """B = 2048 at n = 512: 64 row tiles, 8 a launch beside the 16 unit
    groups, so 8 launches of 256 rows; every launch's grid co-resident."""
    plan = cb.batched_plan(2048, 512, 132, lambda r, u, s: 1)
    assert plan.chunk_rows == 256 and plan.chunks(2048) == 8
    assert plan.unit_groups * plan.chunk_rows // plan.rows <= 132


@pytest.mark.parametrize("B", [1, 31, 256, 257, 1000, 2048, 5000])
@pytest.mark.parametrize("n,per_sm", [(30, 8), (136, 4), (512, 1), (700, 1), (1000, 2), (2048, 4)])
def test_grid_rule_keeps_every_launch_co_resident(B, n, per_sm):
    plan = cb.batched_plan(B, n, 132, lambda r, u, s: per_sm)
    assert plan.smem_bytes <= cb._SMEM_LIMIT
    assert plan.unit_groups == -(-n // plan.units)
    assert plan.unit_groups * -(-min(B, plan.chunk_rows) // plan.rows) <= per_sm * 132
    chunks = plan.chunks(B)
    assert chunks == 1 or plan.chunk_rows * (chunks - 1) < B


def test_grid_rule_takes_a_narrower_tile_or_refuses():
    """Past ~700 units 32 x 32's shared memory does not fit (32 x 16 runs),
    past ~2400 no tile does; unit groups the card cannot hold at once are
    refused too: never another route."""
    assert cb.batched_plan(256, 1024, 132, lambda r, u, s: 1)[:2] == (32, 16)
    assert cb.batched_plan(256, 2048, 132, lambda r, u, s: 2)[:2] == (16, 8)
    with pytest.raises(ValueError, match="fits no tile"):
        cb.batched_plan(256, 4096, 132, lambda r, u, s: 1)
    with pytest.raises(ValueError, match="fits no tile"):
        cb.batched_plan(256, 512, 4, lambda r, u, s: 1)
