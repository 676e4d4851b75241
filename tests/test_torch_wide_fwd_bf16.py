"""K9f's and K6f's tensor-core forward (svd_lstm_tpu_torch/ops/cuda_train.py
``wide_fwd_bf16``; ops/csrc/lstm_train.cu ``bf16_copy``, ``gemm_bf16`` and
``batched_chain``'s c-storing instantiation) on the CPU, without a card.

K9f's forward makes bf16 copies of x and W (``bf16_copy``: rounded to
nearest even, row strides padded with zeros to a multiple of 8, W's copy
with as many rows as x's has columns) and runs the x-side xz = x·W + b as
one ``gemm_bf16`` NN product over all T·B rows, the bias added unrounded.
K6f takes its xp as xz. The chain is K5's ``batched_chain`` with c stored:
one cooperative launch a chunk of rows of ``fwd_plan_bf16`` (K5's rule and
tiles, ``cuda_batched.batched_plan``, and past them the unstaged tile,
which reads Uᵀ from ``cuda_batched.fragment_order``'s copy, not from
shared memory), T steps a launch, a CTA owning R
rows × J units and all four gates of them, h_{t-1} read back through L2
after the grid barrier from slot (t − 1) & 1 of a two-slot bf16 copy of h
(each step stores bf16(h_t) into slot t & 1), the product by ``mma.sync``
over k groups of 16, c carried in registers, h_t and c_t stored float32 and
unrounded.

* A float64 numpy emulation of that schedule: the x-side tile by tile
  (``test_torch_wide_bwd_bf16.gemm``: TMA's boxes, the padded strides); the
  chain CTA by CTA in a shuffled order between barriers, h_{t-1} read from
  its bf16 slot, each k group's products summed into a float32 accumulator
  in turn, c carried and stored, h, c and both slots NaN until written. It
  runs behind the
  wrappers' own launches (``_launch`` replaced, ``_on_card`` true, the
  card's plan given an SM count and an occupancy) and is held against
  ``wide_layer_fwd_plain(..., True)`` and
  ``lstm_recurrence_train_fwd_plain(..., True)`` within ``chip_smoke.py``'s
  ``fast_limit`` (2 bf16 ulps of the plain output's largest value, or twice
  the plain float32 version's distance from the same arithmetic in float64)
  for ragged B, T = 1, d = 16 and 7, n = 128 and 256, every tile the plan
  takes, and a batch in two launches.
* The mutations "barrier" (a CTA reads the slot the step is writing),
  "state" (c not carried), "mask" (rows past B stored) and "rounding" (the
  float32 h read back, not its bf16 copy) each make it disagree.
* The plan at the repo's shapes, and at every width the float32 forward's
  rule serves.
* One case against the JAX package's ``_wide_fwd`` and ``_pallas_fwd_hc``
  in interpret mode, within the wide fast band 2e-2 (relative Frobenius):
  on the CPU JAX's DEFAULT dot is exact float32, so the bf16 forward is
  held to the exact one only as far as the card's fast mode is.

The kernels themselves run only on the card (tests/test_torch_train_kernels.py
and the ``cuda`` tests at the end of this file: each tile, and widths to
4352).
"""

import ctypes

import numpy as np
import pytest
import torch

from svd_lstm_tpu_torch.ops import cuda_batched as cb
from svd_lstm_tpu_torch.ops import cuda_train as ct
from test_torch_wide_bwd_bf16 import _bf16_bits, _bf16_read, _view, copy, gemm, rn

SMS = 132  # the H100 SXM's SM count
FAST_BAND = 2e-2  # rel. Frobenius, the wide fast band (chip_smoke.py FAST_BAND)


def _sigm(z):
    return np.float32(1) / (np.float32(1) + np.exp(-z))


# ---------------------------------------------------------------------------
# the emulation
# ---------------------------------------------------------------------------

def fragment_columns(Utp, n):
    """Ut's columns (4n, K) as the unstaged tiles read them from the
    fragment-ordered copy Utp (4n, K), K a multiple of 32: for the k group g
    of each 32 k, a lane t (lane % 4) loads the 16 bytes at 8t, whose
    values 4g + 2i + l are its register i's half l, the k 8i + 2t + l of
    the group (the mma's B fragment)."""
    K = Utp.shape[1]
    src = np.empty(K, np.int64)
    for k in range(K):
        block, a = divmod(k, 32)
        g, s = divmod(a, 16)
        i, r = divmod(s, 8)
        t, l = divmod(r, 2)
        src[k] = 32 * block + 8 * t + 4 * g + 2 * i + l
    return Utp[:, src]


def emulate_chain(xp_ptr, Ut_ptr, h_ptr, c_ptr, hb_ptr, T, B, stride, n, rows, units, staged, *,
                  rng, mutation=None):
    """One batched_lstm_recurrence_launch with c stored: B rows from the
    chunk pointers, all T steps, the CTAs shuffled every step; h exchanged
    through the two bf16 slots of hb (2, stride, n); Ut staged, or read from
    its fragment-ordered copy."""
    R, J, G = rows, units, 4 * n
    span = (T - 1) * stride + B  # rows from the chunk's first to its last
    xp = _view(xp_ptr, span * G, ctypes.c_float).reshape(span, G)
    h = _view(h_ptr, span * n, ctypes.c_float).reshape(span, n)
    c = _view(c_ptr, span * n, ctypes.c_float).reshape(span, n)
    hb = _view(hb_ptr, (stride + B) * n, ctypes.c_uint16).reshape(stride + B, n)
    own = (np.arange(T)[:, None] * stride + np.arange(B)[None, :]).ravel()  # this launch's rows
    h[own] = np.nan
    c[own] = np.nan
    slots = np.concatenate([np.arange(B), stride + np.arange(B)])
    hb[slots] = _bf16_bits(np.full((2 * B, n), np.nan))
    Kp = cb.batched_kp(n, bool(staged))
    Ut = _bf16_read(Ut_ptr, G, n) if staged else fragment_columns(_bf16_read(Ut_ptr, G, Kp), n)
    gx, gy = -(-n // J), -(-B // R)
    columns = {}  # each CTA's columns of Ut: (gate, unit, k), zeros past n
    for ux in range(gx):
        j = ux * J + np.arange(J)
        cols = np.zeros((4, J, Kp))
        for g in range(4):
            cols[g, j < n, :n] = Ut[g * n + j[j < n], :n]
        columns[ux] = cols
    cells = {(ux, uy): np.zeros((R, J), np.float32) for ux in range(gx) for uy in range(gy)}
    for t in range(T):
        for cta in rng.permutation(gx * gy):
            ux, uy = divmod(int(cta), gy)
            r, j = uy * R + np.arange(R), ux * J + np.arange(J)
            ok_r, ok_j = r < B, j < n
            acc = np.zeros((4, R, J), np.float32)
            if t > 0:
                A = np.zeros((R, Kp))  # rows past B stay zero
                if mutation == "rounding":
                    A[ok_r, :n] = h[(t - 1) * stride + r[ok_r]]
                else:
                    slot = (t if mutation == "barrier" else t - 1) & 1
                    bits = hb[slot * stride + r[ok_r]].astype(np.uint32) << 16
                    A[ok_r, :n] = bits.view(np.float32)
                for k0 in range(0, Kp, 16):  # the mma's k groups, in turn
                    acc += np.einsum("rk,guk->gru", A[:, k0 : k0 + 16],
                                     columns[ux][:, :, k0 : k0 + 16]).astype(np.float32)
            z = np.zeros((4, R, J), np.float32)
            rr, jj = np.ix_(r[ok_r], j[ok_j])
            for g in range(4):
                z[g][np.ix_(ok_r, ok_j)] = xp[t * stride + rr, g * n + jj]
            z += acc
            cp = np.zeros((R, J), np.float32) if mutation == "state" else cells[ux, uy]
            cn = _sigm(z[1]) * cp + _sigm(z[0]) * np.tanh(z[2])
            hn = _sigm(z[3]) * np.tanh(cn)
            cells[ux, uy] = cn
            # "mask": every row of the tile stored, as far as the chunk's memory reaches
            store = (t * stride + r < span) if mutation == "mask" else ok_r
            at = np.ix_(t * stride + r[store], j[ok_j])
            h[at] = hn[np.ix_(store, ok_j)]
            c[at] = cn[np.ix_(store, ok_j)]
            hb[np.ix_((t & 1) * stride + r[ok_r], j[ok_j])] = _bf16_bits(hn[np.ix_(ok_r, ok_j)])


def _launcher(rng, mutation=None):
    """A stand-in for ``cuda_train._launch``: each C entry point of the bf16
    forward emulated on the wrapper's own memory, its name recorded."""
    names = []

    def launch(name, device, *args):
        names.append(name)
        if name == "bf16_copy":
            src, dst, rows, cols, rows_p, ld = args
            a = _view(src, rows * cols, ctypes.c_float).reshape(rows, cols)
            _view(dst, rows_p * ld, ctypes.c_uint16)[:] = _bf16_bits(copy(a, rows=rows_p)).ravel()
        elif name == "gemm_bf16":
            meta = [int(v) for v in _view(args[0], 11 + 8 * ct.GEMM_MAX_SEGS, ctypes.c_int64)]
            nseg, M, N, C, ldc, bias, addend, splits, kchunk, split_stride, form = meta[:11]
            assert (nseg, form, splits, addend, ldc) == (1, 0, 1, 0, N)  # NN, the bias, one split
            A, ar, ald, Bp, br, bld, shift, K = meta[11:19]
            assert A % 16 == 0 and Bp % 16 == 0 and ald % 8 == 0 and bld % 8 == 0 and shift == 0
            out = gemm([(_bf16_read(A, ar, ald), _bf16_read(Bp, br, bld), K, 0)], M, N, "NN",
                       bias=_view(bias, N, ctypes.c_float))
            _view(C, M * N, ctypes.c_float)[:] = out[0].ravel()
        elif name == "batched_lstm_recurrence":
            xp, Ut, h, c, hb, T, B, stride, n, rows, units, bf16, staged = args
            assert None not in (c, hb) and bf16 == 0 and (Ut | h | c | hb) % 16 == 0
            assert (rows, units) in (cb.BATCHED_TILES if staged else cb.UNSTAGED_TILES)
            emulate_chain(xp, Ut, h, c, hb, T, B, stride, n, rows, units, staged, rng=rng,
                          mutation=mutation)
        else:
            raise AssertionError(f"unexpected launch {name}")

    return launch, names


def _smem_occupancy(n):
    """CTAs an SM as shared memory allows (228 KB an SM, 1 KB a CTA kept
    back), at most 8: a stand-in for the occupancy API."""
    return lambda rows, units, staged: min(
        8, 233_472 // (cb.batched_smem_bytes(n, rows, units, staged) + 1024))


def _only(tile):
    """An occupancy at which only ``tile`` (rows, units, staged) runs: the
    plan must take it."""
    return lambda *t: 8 if t == tile else 0


ALL_TILES = [(r, u, True) for r, u in cb.BATCHED_TILES] + \
    [(r, u, False) for r, u in cb.UNSTAGED_TILES]


def run_emulated(x, W, U, b, monkeypatch, sms=SMS, per_sm=None, mutation=None, seed=0):
    """K9f's forward (W given) or K6f's (W None, x the projection xp) through
    the wrappers on CPU float32 tensors, the card's route taken and every
    launch emulated. Returns (h, c, the plan, the launches' names)."""
    T, B, _ = x.shape
    n = U.shape[0]
    per_sm = per_sm or _smem_occupancy(n)
    plans = []

    def card_plan(dev, B_, n_, bf16, cell=False):
        assert not bf16 and cell  # the float32 instantiation that stores c
        plans.append(cb.batched_plan(B_, n_, sms, per_sm, unstaged=True))
        return plans[-1]

    launch, names = _launcher(np.random.default_rng(seed), mutation)
    monkeypatch.setattr(ct, "_on_card", lambda *t: True)
    monkeypatch.setattr(ct, "_launch", launch)
    monkeypatch.setattr(cb, "card_plan", card_plan)
    ct.reset_launch_counts()
    args = [torch.tensor(np.asarray(a), dtype=torch.float32) for a in (x, W, U, b) if a is not None]
    if W is None:
        h, c = ct.lstm_recurrence_train_fwd(*args, True)
        assert ct.LAUNCHES["lstm_recurrence_train_fwd_fast"] == 1
    else:
        h, c = ct.wide_layer_fwd(*args, True)
        assert ct.LAUNCHES["wide_layer_fwd_fast"] == 1
    assert sum(ct.LAUNCHES.values()) == 1
    return h, c, plans[0], names


def _case(seed, n, d, B, T, u_scale=None):
    rng = np.random.default_rng(seed)
    f = lambda shape, s: rng.normal(scale=s, size=shape).astype(np.float32)  # noqa: E731
    return (f((T, B, d), 1.0), f((d, 4 * n), d ** -0.5), f((n, 4 * n), u_scale or n ** -0.5),
            f((4 * n,), 0.1))


def _plain(x, W, U, b):
    """The plain bf16 forward in float32 and in float64 (K9f with W, K6f
    without), from the same float32 inputs."""
    fn = ct.wide_layer_fwd_plain if W is not None else ct.lstm_recurrence_train_fwd_plain
    args = [np.asarray(a) for a in (x, W, U, b) if a is not None]
    f32 = fn(*(torch.tensor(a) for a in args), True)
    f64 = fn(*(torch.tensor(a, dtype=torch.float64) for a in args), True)
    return f32, f64


def fast_limit(plain, plain64) -> float:
    """chip_smoke.py's fast_limit: 2 bf16 ulps of the plain output's largest
    value, or twice its distance from the float64 arithmetic."""
    ulp = 2.0 ** (np.floor(np.log2(float(plain.abs().max()))) - 7)
    return max(2 * ulp, 2 * float((plain.double() - plain64).abs().max()))


def _errors(got, want, want64):
    """Per output (h, c): (max abs error, fast_limit)."""
    return [(float((a.double() - r.double()).abs().max()), fast_limit(r, r64))
            for a, r, r64 in zip(got, want, want64)]


def _xp(x, W, b):
    """K6f's input: the projection of x, float32."""
    return (x.astype(np.float64) @ W + b).astype(np.float32)


# (n, d, B, T, SMs, occupancy (None: as shared memory allows), launches):
# ragged B (1, 17, 40), T = 1 (no h read back), d = 16 and 7, n = 128 and
# 256; each tile forced by an occupancy only it meets, the unstaged ones
# too; B = 100 at 1 CTA an SM on 12 SMs: two launches of 64 rows (3 row
# tiles beside 4 unit groups)
EMULATION_CASES = [
    (128, 16, 17, 4, SMS, None, 1),
    (128, 7, 1, 3, SMS, None, 1),
    (256, 16, 40, 3, SMS, None, 1),
    (128, 16, 9, 1, SMS, None, 1),
    (128, 7, 40, 3, SMS, _only((32, 16, True)), 1),
    (256, 7, 19, 2, SMS, _only((32, 32, True)), 1),
    (128, 16, 20, 2, SMS, _only((16, 8, True)), 1),
    (256, 16, 40, 3, SMS, _only((16, 64, False)), 1),
    (128, 7, 17, 2, SMS, _only((16, 64, False)), 1),
    (128, 16, 100, 2, 12, lambda r, u, s: 1, 2),
]


@pytest.mark.parametrize("n,d,B,T,sms,per_sm,launches", EMULATION_CASES)
def test_emulated_forward_matches_the_plain_bf16_forward(n, d, B, T, sms, per_sm, launches,
                                                         monkeypatch):
    x, W, U, b = _case(n + d + B + T, n, d, B, T)
    for W_, b_, inp in ((W, b, x), (None, None, _xp(x, W, b))):
        h, c, plan, names = run_emulated(inp, W_, U, b_, monkeypatch, sms, per_sm)
        chunks = plan.chunks(B)
        assert chunks == launches
        assert names == ([] if W_ is None else ["bf16_copy", "bf16_copy", "gemm_bf16"]) + \
            ["batched_lstm_recurrence"] * chunks
        want, want64 = _plain(inp, W_, U, b_)
        for name, a, r in zip("hc", (h, c), want):
            assert a.dtype == torch.float32 and a.shape == r.shape and torch.isfinite(a).all(), name
        for name, (err, lim) in zip("hc", _errors((h, c), want, want64)):
            assert err <= lim, (name, W_ is None, err, lim)


def test_the_cases_take_every_tile_and_two_launches():
    plans = [cb.batched_plan(B, n, sms, per_sm or _smem_occupancy(n), unstaged=True)
             for n, _, B, _, sms, per_sm, _ in EMULATION_CASES]
    assert {(p.rows, p.units, p.staged) for p in plans} == set(ALL_TILES)
    assert any(p.chunks(B) > 1 for p, (_, _, B, *_) in zip(plans, EMULATION_CASES))


def test_chain_result_does_not_depend_on_the_cta_order(monkeypatch):
    x, W, U, b = _case(4, 128, 16, 40, 3)
    first = run_emulated(x, W, U, b, monkeypatch, seed=1)[:2]
    second = run_emulated(x, W, U, b, monkeypatch, seed=2)[:2]
    for a, r in zip(first, second):
        assert torch.equal(a, r)


# the cases the mutations run on: "mask" needs a chunk whose ragged tile
# stores into the next step's rows of an earlier chunk (B = 100 in two
# launches of 64 rows); "rounding" needs h·U's rounding error above 2 bf16
# ulps of the output, so U is drawn 8x the fan-in scale
MUTATION_CASES = {
    "barrier": ((128, 16, 17, 3), SMS, None, None),
    "state": ((128, 16, 17, 3), SMS, None, None),
    "mask": ((128, 16, 100, 3), 12, lambda r, u, s: 1, None),
    "rounding": ((256, 16, 32, 6), SMS, None, 8 * 256 ** -0.5),
}


@pytest.mark.parametrize("mutation", sorted(MUTATION_CASES))
def test_a_mutated_schedule_disagrees(mutation, monkeypatch):
    (n, d, B, T), sms, per_sm, u_scale = MUTATION_CASES[mutation]
    x, W, U, b = _case(5, n, d, B, T, u_scale)
    h, c, _, _ = run_emulated(x, W, U, b, monkeypatch, sms, per_sm, mutation)
    want, want64 = _plain(x, W, U, b)
    errors = _errors((h, c), want, want64)
    assert not all(err <= lim for err, lim in errors), errors
    h, c, _, _ = run_emulated(x, W, U, b, monkeypatch, sms, per_sm)  # and unmutated it agrees
    assert all(err <= lim for err, lim in _errors((h, c), want, want64))


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------

# (B, n, CTAs an SM (None: as shared memory allows)) -> (rows, units,
# staged, unit groups, chunk rows, launches); 32 x 32 at n = 512 takes 166
# KB, one CTA an SM; past 1152 no staged tile fits (32 x 16 needs 247 KB at
# 1280, 16 x 8 160 unit groups co-resident at one CTA an SM) and U is read
# from its global copy
PLAN_CASES = [
    ((128, 512, 1), (32, 32, True, 16, 128, 1)),     # runs C, D, F: 64 CTAs
    ((32, 512, 1), (32, 32, True, 16, 32, 1)),       # run A's batch at 512 units
    ((1, 512, 1), (32, 32, True, 16, 32, 1)),
    ((2048, 512, 1), (32, 32, True, 16, 256, 8)),    # 8 row tiles a launch beside 16 unit groups
    ((128, 128, 2), (32, 32, True, 4, 128, 1)),
    ((256, 256, 1), (32, 32, True, 8, 256, 1)),
    ((256, 1024, 1), (32, 16, True, 64, 64, 4)),     # 32 x 32's 330 KB do not fit: 32 x 16
    ((128, 1280, None), (16, 64, False, 20, 128, 1)),  # 41 KB a CTA, 5 an SM
    ((128, 2176, None), (16, 64, False, 34, 128, 1)),  # 70 KB, 3 an SM: 11 row tiles a launch
    ((128, 4352, None), (16, 64, False, 68, 16, 8)),   # 140 KB: a row tile a launch
]


@pytest.mark.parametrize("shape,want", PLAN_CASES)
def test_plan_at_the_repo_shapes(shape, want):
    B, n, per_sm = shape
    occupancy = _smem_occupancy(n) if per_sm is None else (lambda r, u, s: per_sm)
    plan = cb.batched_plan(B, n, SMS, occupancy, unstaged=True)
    got = (plan.rows, plan.units, plan.staged, plan.unit_groups, plan.chunk_rows, plan.chunks(B))
    assert got == want
    assert plan.smem_bytes == cb.batched_smem_bytes(n, plan.rows, plan.units, plan.staged)
    assert plan.smem_bytes <= cb._SMEM_LIMIT
    most = occupancy(plan.rows, plan.units, plan.staged) * SMS
    assert plan.unit_groups * -(-min(B, plan.chunk_rows) // plan.rows) <= most


def test_plan_serves_every_width_the_float32_forward_serves():
    """Every n (a multiple of WIDE_ALIGN, to 64 units an SM) at which the
    float32 forward chain's rule (``fwd_chain_plan``, also the bf16 forward's
    before the tensor cores) finds a plan, the bf16 forward's finds one at
    the occupancy shared memory allows; K5's staged tiles alone stop at
    1152."""
    widths = range(ct.WIDE_ALIGN, 64 * SMS + 1, ct.WIDE_ALIGN)
    served = []
    for n in widths:
        try:
            ct.fwd_chain_plan(128, n, SMS)
        except ValueError:
            continue
        served.append(n)
        plan = cb.batched_plan(128, n, SMS, _smem_occupancy(n), unstaged=True)
        assert plan.staged == (n <= 1152), n
    assert max(served) == 7168 and {1280, 2176, 4352} <= set(served)
    with pytest.raises(ValueError, match="fits no tile"):
        cb.batched_plan(128, 1280, SMS, _smem_occupancy(1280))  # K5's tiles only


# ---------------------------------------------------------------------------
# against the JAX package (interpret mode)
# ---------------------------------------------------------------------------

def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_emulated_forward_against_the_jax_kernels(monkeypatch):
    """K9f fwd and K6f fwd through the emulated wrappers against
    ``_wide_fwd`` (x and W zero-padded to n, as the JAX package takes layer
    0) and ``_pallas_fwd_hc`` in interpret mode, whose DEFAULT dots are
    exact float32 on the CPU."""
    import jax.numpy as jnp
    from svd_lstm_tpu.ops.pallas_train import _pallas_fwd_hc
    from svd_lstm_tpu.ops.pallas_train_wide import _wide_fwd

    n, d, B, T = 128, 16, 12, 5
    x, W, U, b = _case(9, n, d, B, T)
    xj = jnp.asarray(np.pad(x, ((0, 0), (0, 0), (0, n - d))))
    Wj = jnp.asarray(np.pad(W, ((0, n - d), (0, 0))))
    want = _wide_fwd(xj, Wj, jnp.asarray(U), jnp.asarray(b), 8, interpret=True)
    got = run_emulated(x, W, U, b, monkeypatch)[:2]
    xp = _xp(x, W, b)
    want_rec = _pallas_fwd_hc(jnp.asarray(xp), jnp.asarray(U), 8, interpret=True)
    got_rec = run_emulated(xp, None, U, None, monkeypatch)[:2]
    for name, a, r in zip(("h", "c", "h (K6f)", "c (K6f)"), (*got, *got_rec), (*want, *want_rec)):
        err = _rel(a, r)
        assert 0 < err <= FAST_BAND, (name, err)  # bf16 operands: not exact, within the band


# ---------------------------------------------------------------------------
# on the card: each tile against the plain bf16 forward
# ---------------------------------------------------------------------------

@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _card_matches_plain(cuda, n, d, B, T):
    """K9f's and K6f's forward on the card, h and c within fast_limit of
    the plain bf16 version."""
    x, W, U, b = (torch.tensor(a, device=cuda) for a in _case(11 + n + B, n, d, B, T))
    xp = (torch.matmul(x, W) + b).contiguous()
    cases = ((ct.wide_layer_fwd, ct.wide_layer_fwd_plain, (x, W, U, b)),
             (ct.lstm_recurrence_train_fwd, ct.lstm_recurrence_train_fwd_plain, (xp, U)))
    for fn, plain, args in cases:
        want = plain(*args, True)
        want64 = plain(*(a.double() for a in args), True)
        got = fn(*args, True)
        torch.cuda.synchronize()
        for name, (err, lim) in zip("hc", _errors(got, want, want64)):
            assert err <= lim, (fn.__name__, n, name, err, lim)


@pytest.mark.cuda
@pytest.mark.parametrize("tile", ALL_TILES)
@pytest.mark.parametrize("n,d,B,T", [(128, 7, 17, 9), (512, 512, 128, 12), (256, 16, 300, 5)])
def test_cuda_each_tile_matches_the_plain_bf16_forward(cuda, tile, n, d, B, T, monkeypatch):
    """The chain forced to ``tile`` (the card's occupancy of it, K5's
    chunks)."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count

    def occupancy(rows, units, staged):
        if (rows, units, staged) != tile:
            return 0
        return cb._per_sm(cuda.index, n, False, rows, units, True, staged)

    monkeypatch.setattr(ct, "fwd_plan_bf16",
                        lambda dev, B_, n_: cb.batched_plan(B_, n_, sms, occupancy, unstaged=True))
    _card_matches_plain(cuda, n, d, B, T)


@pytest.mark.cuda
@pytest.mark.parametrize("n,d,B,T", [(1024, 128, 20, 3), (1280, 16, 20, 2), (2176, 16, 20, 2),
                                     (4352, 16, 9, 2)])
def test_cuda_wide_widths_match_the_plain_bf16_forward(cuda, n, d, B, T):
    """The plan's own tile at K9f's backward's card widths (1024, 2176) and
    past the staged tiles (1280, 2176, 4352: U from its global copy)."""
    plan = ct.fwd_plan_bf16(cuda, B, n)
    assert plan.staged == (n <= 1152), plan
    _card_matches_plain(cuda, n, d, B, T)
