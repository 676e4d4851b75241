"""K4's wavefront cluster (``reduced_stack_wave`` in svd_lstm_tpu_torch/ops/
csrc/lstm_recurrence.cu) without a card: its plan rule, its packing, and a
step-wise numpy emulation of its schedule.

The emulation runs behind the wrapper's own launch on CPU tensors
(``_on_card`` made to say yes, the plan given, ``_launch`` replaced): it
reads the launcher's arguments from memory as the kernel would (the layers'
meta rows and biases, the packed blocks of every warp and layer 0's x-side
weights, x) and writes h where the kernel writes it, so the wrapper's
packing is checked with the schedule. It poisons ``out`` and the slots of
the exchange with NaN first. Per wave step s, layer i at its step t = s - i
(in its window 0 <= t < T, else holding h and c), in the kernel's order:

1. each warp's partials of hb_i and xb_{i+1} over its 8 units, from the h it
   holds (an FMA chain over u = 0..7);
2. each CTA's partial of the range of V its warps write (its warps' rows
   added in warp order, zeros outside a warp's range), stored in the slot of
   its rank, parity s & 1, in every CTA (the CTAs in a shuffled order; every
   CTA's slots start as NaN, and a warp reads only the slots of the ranks
   that hold the layer below's warps and its own);
3. the cluster barrier; layer 0's warps form x_t·wB_0 (an FMA chain over
   the d inputs);
4. [xb_i | hb_i] = the partials of the ranks holding the layer below's warps
   and this layer's, added in rank order (rounded to bf16 in fast mode);
   lane 8g + u's two column dots over its gate's blocks in four FMA chains
   each (q mod 4, added (0 + 1) + (2 + 3)), + b, the gate update, c carried;
   units past n neither read b nor written; the last layer stores h_t.

Held against ``fused_reduced_stack_plain`` on the last layer's h (the
models' heads are the identity) within K2's limits (exact: 2e-5 + 1e-5
relative; fast: 2 bf16 ulps of the largest h, or twice the plain version's
distance from float64 state: a float32 sum order that flips one bf16
rounding carries on), merged and split, for units (24,
40), (30, 30, 30, 30), (136,) and 3x512 at r = 24, with the rule's plan and
forced ones. The mutations "wave" (layer i + 1 reads layer i's h one wave
step early), "drain" (a layer outside its window updates its state),
"barrier" (a CTA reads the slots before the others have stored this step's
partials) and "mask" (units past n are written) must fail it.
"""

import ctypes

import numpy as np
import pytest
import torch

import svd_lstm_tpu_torch as P
from svd_lstm_tpu_torch.models.lstm import DenseHead
from svd_lstm_tpu_torch.ops import cuda_lstm as ck

ATOL, RTOL = 2e-5, 1e-5
SMEM_LIMIT = 232_448
SMS = 132
D = 8


def _model(units, rank, merged, d=D, seed=3):
    """A fresh stack truncated to ``rank``, with biases drawn from ``seed``
    (a trained stack's are not zero, and a zero bias keeps a layer that
    runs before its window at zero state), its head the identity: the
    wrapper then returns the last layer's h, which the kernel writes."""
    dense = P.init_stacked_lstm(torch.Generator().manual_seed(seed), input_dim=d, units=units,
                                device="cpu")
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for l in dense.layers:
            l.b.copy_(torch.tensor(rng.normal(scale=0.5, size=l.b.shape), dtype=torch.float32))
    model = P.make_reduced_model(P.make_singular_model(dense, merged_kernel=merged), rank=rank)
    model.head = DenseHead(torch.eye(units[-1]), torch.zeros(units[-1]))
    return model


def _x(T, d=D, seed=15):
    return torch.tensor(np.random.default_rng(seed).normal(size=(T, d)), dtype=torch.float32)


def _view(ptr: int, count: int, dtype) -> np.ndarray:
    size = count * np.dtype(dtype).itemsize
    return np.frombuffer((ctypes.c_uint8 * size).from_address(ptr), dtype=dtype)


def _from_bf16(bits: np.ndarray) -> np.ndarray:
    return (bits.astype(np.uint32) << 16).view(np.float32)


def _bf16_round(v: np.ndarray) -> np.ndarray:
    return torch.from_numpy(np.ascontiguousarray(v, np.float32)).bfloat16().float().numpy()


def _fma(a, b, c):
    """fmaf: the product exact (float64), one rounding of the sum."""
    return (np.asarray(a, np.float64) * b + c).astype(np.float32)


def _sigmoid(z):
    return np.float32(1) / (np.float32(1) + np.exp(-z))


class _Layer:
    """One layer's warps, unpacked from P as the kernel reads them."""

    def __init__(self, meta_row, warp0, xoff, geom, blocks):
        self.n = int(meta_row[0])
        split = int(meta_row[1]) == 4
        wr = [int(r) for r in meta_row[2:2 + int(meta_row[1])]]
        ur = [int(r) for r in meta_row[6:6 + int(meta_row[1])]]
        self.Rw, self.Ru = sum(wr), sum(ur)
        self.warp0, self.nw, self.xoff = warp0, -(-self.n // 8), xoff
        gates = np.arange(32) // 8
        if split:
            self.rlw = np.array(wr)[gates]
            self.olw = np.concatenate([[0], np.cumsum(wr)[:-1]])[gates]
            self.rlu = np.array(ur)[gates]
            self.olu = self.Rw + np.concatenate([[0], np.cumsum(ur)[:-1]])[gates]
        else:
            self.rlw, self.olw = np.full(32, wr[0]), np.zeros(32, int)
            self.rlu, self.olu = np.full(32, ur[0]), np.full(32, self.Rw)
        ws = blocks[warp0 : warp0 + self.nw]
        QW, QU, KU, KN = geom.QW, geom.QU, geom.KU, geom.KN
        self.wic = ws[:, : 32 * QW].reshape(self.nw, QW, 32)
        self.uic = ws[:, 32 * QW : 32 * (QW + QU)].reshape(self.nw, QU, 32)
        o = 32 * (QW + QU)
        self.ub = ws[:, o : o + 256 * KU].reshape(self.nw, KU, 8, 32)
        self.wn = ws[:, o + 256 * KU : o + 256 * (KU + KN)].reshape(self.nw, KN, 8, 32)
        self.b = _view(int(meta_row[10]), 4 * self.n, np.float32)
        self.j = 8 * np.arange(self.nw)[:, None] + np.arange(8)[None]  # (nw, 8) units
        self.unit = self.j < self.n
        self.h = np.zeros((self.nw, 8), np.float32)
        self.c = np.zeros((self.nw, 8), np.float32)
        self.hop = np.zeros((self.nw, 8), np.float32)


def emulate_stack(meta_ptr, L, P_ptr, entries, x_ptr, out_ptr, T, d, cluster, warps, home, bf16,
                  *, rng, mutation=None):
    """One reduced_stack_wave_launch, all T + L - 1 wave steps (module
    docstring). The weights' home moves no number, so it is only checked."""
    assert 0 <= home < len(ck.RED_HOMES)
    meta = _view(meta_ptr, 11 * L, np.int64).reshape(L, 11)
    units = [int(m[0]) for m in meta]
    w_ranks = [tuple(int(r) for r in m[2 : 2 + int(m[1])]) for m in meta]
    u_ranks = [tuple(int(r) for r in m[6 : 6 + int(m[1])]) for m in meta]
    geom = ck.stack_geometry(units, w_ranks, u_ranks)
    Wt, S = cluster * warps, geom.S
    assert Wt >= geom.warps and entries == Wt * geom.E + d * 32 * geom.KX
    flat = _from_bf16(_view(P_ptr, entries, np.uint16)) if bf16 else _view(P_ptr, entries, np.float32)
    blocks = flat[: Wt * geom.E].reshape(Wt, geom.E)
    wx = flat[Wt * geom.E :].reshape(d, 32 * geom.KX)
    x = _view(x_ptr, T * d, np.float32).reshape(T, d)
    out = _view(out_ptr, T * units[-1], np.float32).reshape(T, units[-1])
    out[...] = np.nan
    operand = _bf16_round if bf16 else (lambda v: v)

    layers, warp0, xoff = [], 0, 0
    for i in range(L):
        ly = _Layer(meta[i], warp0, xoff, geom, blocks)
        ly.Rn = sum(w_ranks[i + 1]) if i + 1 < L else 0
        layers.append(ly)
        warp0 += ly.nw
        xoff += ly.Rw + ly.Ru
    wpart = np.zeros((Wt, S), np.float32)  # the warps' rows: zeros outside each one's range
    slots = np.full((cluster, 2, cluster, S), np.nan, np.float32)  # [holder][parity][writer]
    rank_of = lambda w: w // warps  # noqa: E731

    def ranks(ly):
        return range(rank_of(ly.warp0), rank_of(ly.warp0 + ly.nw - 1) + 1)

    cta_range = []  # the range of V each CTA's warps write
    for r in range(cluster):
        own = [ly for ly in layers if ly.warp0 < (r + 1) * warps and ly.warp0 + ly.nw > r * warps]
        cta_range.append((min((ly.xoff + ly.Rw for ly in own), default=S),
                          max((ly.xoff + ly.Rw + ly.Ru + ly.Rn for ly in own), default=0)))

    def partials(ly, which=("h", "x")):
        """Step 1 for one layer's warps: their rows of wpart."""
        hu = ly.hop  # (nw, 8): lane u's h, shuffled to every lane
        o = ly.xoff + ly.Rw
        for k in range(geom.KU if "h" in which else 0):
            e = 32 * k + np.arange(32)
            p = np.zeros((ly.nw, 32), np.float32)
            for v in range(8):
                p = _fma(hu[:, v, None], ly.ub[:, k, v], p)
            live = e < ly.Ru
            wpart[ly.warp0 : ly.warp0 + ly.nw, o + e[live]] = p[:, live]
        for k in range(geom.KN if "x" in which else 0):
            e = 32 * k + np.arange(32)
            p = np.zeros((ly.nw, 32), np.float32)
            for v in range(8):
                p = _fma(hu[:, v, None], ly.wn[:, k, v], p)
            live = e < ly.Rn
            wpart[ly.warp0 : ly.warp0 + ly.nw, o + ly.Ru + e[live]] = p[:, live]

    def push(par, r, lo=None, hi=None):
        """Step 2 for CTA r: its warps' rows in warp order over its range (or
        the part of it in [lo, hi)), into the slot of rank r in every CTA."""
        lo = cta_range[r][0] if lo is None else max(lo, cta_range[r][0])
        hi = cta_range[r][1] if hi is None else min(hi, cta_range[r][1])
        if lo >= hi:
            return
        v = np.zeros(hi - lo, np.float32)
        for w in range(r * warps, (r + 1) * warps):
            v = v + wpart[w, lo:hi]
        slots[:, par, r, lo:hi] = v[None]

    def update(s, i, ws=None):
        """Steps 3-5 for layer i's warps ``ws`` (all by default)."""
        ly = layers[i]
        t = s - i
        if not (0 <= t < T) and mutation != "drain":
            return
        par = s & 1
        ws = np.arange(ly.nw) if ws is None else ws
        R = ly.Rw + ly.Ru
        op = np.full((len(ws), R), np.nan, np.float32)
        reader = rank_of(ly.warp0 + ws)  # each warp reads its own CTA's slots
        for rr in np.unique(reader):
            rows = reader == rr
            if i == 0:  # 3. the x-side, from x_t
                acc = np.zeros(32 * geom.KX, np.float32)
                xt = operand(x[min(max(t, 0), T - 1)])
                for k in range(d):
                    acc = _fma(xt[k], wx[k], acc)
                op[rows, : ly.Rw] = operand(acc[: ly.Rw])[None]
            else:  # 4. the layer below's ranks, in rank order
                sm = np.zeros(ly.Rw, np.float32)
                for r in ranks(layers[i - 1]):
                    sm = sm + slots[rr, par, r, ly.xoff : ly.xoff + ly.Rw]
                op[rows, : ly.Rw] = operand(sm)[None]
            sm = np.zeros(ly.Ru, np.float32)
            for r in ranks(ly):
                sm = sm + slots[rr, par, r, ly.xoff + ly.Rw : ly.xoff + R]
            op[rows, ly.Rw :] = operand(sm)[None]

        def dots(rl, ol, cols, Q):
            d4 = np.zeros((4, len(ws), 32), np.float32)
            for q in range(Q):
                live = q < rl
                opq = np.where(live[None], op[:, np.minimum(ol + q, R - 1)], 0)
                d4[q % 4] = np.where(live[None], _fma(opq, cols[ws, q], d4[q % 4]), d4[q % 4])
            return (d4[0] + d4[1]) + (d4[2] + d4[3])

        gates = np.arange(32) // 8
        mask = ly.unit[ws] if mutation != "mask" else np.ones_like(ly.unit[ws])
        jj = np.repeat(ly.j[ws][:, None, :], 4, axis=1).reshape(len(ws), 32)
        col = np.minimum(gates[None] * ly.n + jj, 4 * ly.n - 1)
        bias = np.where(np.tile(mask, 4), ly.b[col], 0).astype(np.float32)
        z = (dots(ly.rlw, ly.olw, ly.wic, geom.QW) + dots(ly.rlu, ly.olu, ly.uic, geom.QU)) + bias
        zi, zf, zg, zo = (z[:, 8 * g : 8 * g + 8] for g in range(4))
        cn = _sigmoid(zf) * ly.c[ws] + _sigmoid(zi) * np.tanh(zg)
        hn = _sigmoid(zo) * np.tanh(cn)
        ly.c[ws] = np.where(mask, cn, ly.c[ws])
        ly.h[ws] = np.where(mask, hn, ly.h[ws])
        ly.hop[ws] = np.where(mask, operand(hn), ly.hop[ws])
        if i == L - 1 and 0 <= t < T:
            jm = ly.j[ws][mask]
            out[t, np.minimum(jm, ly.n - 1)] = hn[mask]  # "mask": a unit past n lands on n - 1

    for s in range(T + L - 1):
        par = s & 1
        for ly in layers:
            partials(ly)
        order = rng.permutation(cluster)
        if mutation == "barrier":  # each CTA reads the slots right after its own store
            for r in order:
                push(par, r)
                for i, ly in enumerate(layers):
                    mine = np.arange(ly.nw)[rank_of(ly.warp0 + np.arange(ly.nw)) == r]
                    if len(mine):
                        update(s, i, mine)
            continue
        for r in order:
            push(par, r)
        for i, ly in enumerate(layers):
            update(s, i)
            if mutation == "wave" and i + 1 < L:  # layer i + 1 reads this step's h_i
                partials(ly, which=("x",))
                lo = ly.xoff + ly.Rw + ly.Ru
                for r in ranks(ly):
                    push(par, r, lo, lo + ly.Rn)
    return 0


def _run_emulated(model, x, fast, monkeypatch, plan=None, mutation=None, seed=0):
    """fused_reduced_stack on CPU tensors with the card's route taken: the
    rule's plan on 132 SMs (or ``plan``), the launch emulated. Returns (y,
    plan, launches)."""
    rng = np.random.default_rng(seed)
    units, w_ranks, u_ranks = ck._stack_ranks(model)
    plan = plan or ck.reduced_stack_plan(units, x.shape[1], w_ranks, u_ranks, fast, SMS)
    launches = []

    def launch(name, device, *a):
        assert name == "reduced_stack_wave"
        launches.append(a)
        emulate_stack(*a, rng=rng, mutation=mutation)

    monkeypatch.setattr(ck, "_on_card", lambda *t: True)
    monkeypatch.setattr(ck, "card_reduced_stack_plan", lambda dev, m, d, fast_: plan)
    monkeypatch.setattr(ck, "_launch", launch)
    monkeypatch.setattr(ck, "LAUNCHES", dict.fromkeys(ck.REPLACES, 0))
    y = ck.fused_reduced_stack(model, x, dot_precision="default" if fast else None)
    return y, plan, launches


def _within(got, model, x, fast) -> bool:
    """K2's limit (exact) or K2f's (fast) against the plain version."""
    import copy

    dp = "default" if fast else None
    want = ck.fused_reduced_stack_plain(model, x, dp)
    if not bool(torch.isfinite(got).all()):
        return False
    if not fast:
        return bool(torch.all((got - want).abs() <= ATOL + RTOL * want.abs()))
    want64 = ck.fused_reduced_stack_plain(copy.deepcopy(model).double(), x.double(), dp)
    drift = float((want.double() - want64).abs().max())
    ulp = 2.0 ** (np.floor(np.log2(float(want.abs().max()))) - 7)
    return float((got - want).abs().max()) <= max(2 * ulp, 2 * drift)


def _forced(model, d, fast, cluster, home):
    """The wavefront forced to ``cluster`` CTAs at ``home``, past the rule."""
    units, w_ranks, u_ranks = ck._stack_ranks(model)
    return _forced_plan(units, d, w_ranks, u_ranks, fast, cluster, home)


CASES = [((24, 40), 6, 10), ((30, 30, 30, 30), 7, 8), ((136,), 20, 6)]


@pytest.mark.parametrize("fast", [False, True], ids=["exact", "fast"])
@pytest.mark.parametrize("merged", [True, False], ids=["merged", "split"])
@pytest.mark.parametrize("units,rank,T", CASES)
def test_emulated_wave_matches_plain(units, rank, T, merged, fast, monkeypatch):
    model = _model(units, rank, merged)
    x = _x(T)
    got, plan, launches = _run_emulated(model, x, fast, monkeypatch)
    assert plan.route == "wave" and len(launches) == 1
    assert ck.LAUNCHES == {**dict.fromkeys(ck.REPLACES, 0),
                           "fused_reduced_stack_fast" if fast else "fused_reduced_stack": 1}
    assert got.shape == (T, units[-1]) and _within(got, model, x, fast)


@pytest.mark.parametrize("cluster,home", [(2, "staged"), (4, "registers"), (8, "staged"),
                                          (16, "registers")])
@pytest.mark.parametrize("merged", [True, False], ids=["merged", "split"])
@pytest.mark.parametrize("units,rank", [((24, 40), 6), ((30, 30, 30, 30), 7), ((136,), 20)])
def test_emulated_forced_clusters_match_plain(units, rank, merged, cluster, home, monkeypatch):
    """Clusters past the rule: layers split across CTAs, CTAs that hold two
    layers' warps, CTAs that hold none (staged where the registers cannot
    hold a split (136,)'s three chunks of h·B)."""
    model = _model(units, rank, merged, seed=4)
    x = _x(6, seed=16)
    if home == "registers" and ck._stack_reg_threads(ck.stack_geometry(*ck._stack_ranks(model))) == 0:
        home = "staged"
    for fast in (False, True):
        plan = _forced(model, D, fast, cluster, home)
        got, _, _ = _run_emulated(model, x, fast, monkeypatch, plan=plan)
        assert _within(got, model, x, fast), (cluster, home, fast)


@pytest.mark.parametrize("fast", [False, True], ids=["exact", "fast"])
def test_emulated_3x512_r24_matches_plain(fast, monkeypatch):
    """The 3x512 stack at r = 24 (d = 16), merged, at short T, with the
    rule's plan (16 CTAs of 12 warps, the weights in registers)."""
    model = _model((512, 512, 512), 24, True, d=16, seed=5)
    x = _x(4, d=16)
    got, plan, _ = _run_emulated(model, x, fast, monkeypatch)
    assert (plan.cluster, plan.warps, plan.home) == (16, 12, "registers")
    assert _within(got, model, x, fast)


@pytest.mark.parametrize("mutation,units,merged,cluster", [
    ("wave", (24, 40), True, 1),     # layer i + 1 reads layer i's h one wave step early
    ("wave", (30, 30, 30, 30), False, 4),
    ("drain", (24, 40), False, 1),   # a layer outside its window updates its state
    ("drain", (30, 30, 30, 30), True, 2),
    ("barrier", (24, 40), True, 4),  # a CTA reads the slots before the others stored this step's
    ("barrier", (30, 30, 30, 30), False, 8),
    ("mask", (30, 30, 30, 30), False, 1),  # units 30, 31 of each layer's last warp are written
    ("mask", (30, 30, 30, 30), True, 4),
])
def test_a_mutated_emulation_fails(mutation, units, merged, cluster, monkeypatch):
    model = _model(units, 6, merged, seed=6)
    x = _x(8, seed=17)
    for fast in (False, True):
        plan = _forced(model, D, fast, cluster, "staged")
        got, _, _ = _run_emulated(model, x, fast, monkeypatch, plan=plan, mutation=mutation)
        assert not _within(got, model, x, fast), (mutation, fast)


# ---------------------------------------------------------------------------
# the plan rule and the packing
# ---------------------------------------------------------------------------

def _launcher_accepts(plan, units, d, w_ranks, u_ranks, fast) -> bool:
    """csrc ``reduced_stack_wave_launch``'s checks, in Python."""
    geom = ck.stack_geometry(units, w_ranks, u_ranks)
    rq = max(geom.QW, geom.QU)
    regs_ok = (rq <= 32 and geom.KU <= ck.STACK_REG_KB and geom.KN <= ck.STACK_REG_KB
               and plan.threads <= (512 if rq <= 16 else 384))
    return (plan.route == "wave" and plan.cluster in ck.RED_CLUSTERS
            and 1 <= plan.warps <= ck.RED_MAX_WARPS and plan.threads == 32 * plan.warps
            and plan.cluster * plan.warps >= geom.warps and plan.home in ck.RED_HOMES
            and (plan.home != "registers" or regs_ok)
            and plan.smem_bytes == ck.reduced_stack_smem_bytes(geom, d, plan.cluster, plan.warps,
                                                               plan.home, fast) <= SMEM_LIMIT)


def _ranks(units, r, split, d):
    """Per layer (w_ranks, u_ranks) as a truncation to rank r gives them."""
    w, u, din = [], [], d
    for n in units:
        w.append((min(r, din),) * 4 if split else (min(r, din),))
        u.append((min(r, n),) * 4 if split else (min(r, n),))
        din = n
    return w, u


# every stack the card tests and chip_smoke.py run, with the plan the rule
# gives: (route, cluster, warps, home), exact and fast
R16 = ("wave", 16, 12, "registers")
CARD_SHAPES = [
    # units, d, rank, split, exact, fast
    ((512, 512, 512), 16, 24, False, R16, R16),
    ((30, 30, 30, 30), 16, 15, True, ("wave", 1, 16, "registers"), ("wave", 1, 16, "registers")),
    ((24, 40), 8, 6, False, ("wave", 1, 8, "registers"), ("wave", 1, 8, "registers")),
    ((24, 40), 8, 6, True, ("wave", 1, 8, "registers"), ("wave", 1, 8, "registers")),
    ((136,), 8, 20, False, ("wave", 2, 9, "registers"), ("wave", 2, 9, "registers")),
    ((136,), 8, 20, True, ("wave", 1, 17, "staged"), ("wave", 1, 17, "staged")),  # h·B: 3 chunks
    ((512,), 8, 24, False, ("wave", 8, 8, "registers"), ("wave", 8, 8, "registers")),
    ((512,), 8, 24, True, ("wave", 4, 16, "staged"), ("wave", 2, 32, "staged")),
    ((30, 30, 30, 30), 8, 7, True, ("wave", 1, 16, "registers"), ("wave", 1, 16, "registers")),
    # split 3x512 r = 24: f32's blocks, slots and rows overflow every cluster's shared memory
    ((512, 512, 512), 16, 24, True, ("layers", 1, 32, "global"), ("wave", 16, 12, "staged")),
]


@pytest.mark.parametrize("fast", [False, True], ids=["exact", "fast"])
@pytest.mark.parametrize("units,d,r,split,exact,fast_plan", CARD_SHAPES)
def test_plan_at_the_card_shapes(units, d, r, split, exact, fast_plan, fast):
    w, u = _ranks(units, r, split, d)
    plan = ck.reduced_stack_plan(units, d, w, u, fast, SMS)
    assert (plan.route, plan.cluster, plan.warps, plan.home) == (fast_plan if fast else exact)
    if plan.route == "wave":
        assert _launcher_accepts(plan, units, d, w, u, fast)
    else:
        ck.check_reduced_stack_plan(plan, units, d, w, u, fast)


@pytest.mark.parametrize("fast", [False, True], ids=["exact", "fast"])
def test_plan_takes_every_stack_or_routes_the_layer_loop(fast):
    """Stacks of 1-4 equal layers of every width to 2048 (step 8) at merged
    and split ranks: a wavefront the launcher accepts, at the first home
    and then the fewest CTAs whose block holds it, or the "layers" route
    where no cluster of 16 does."""
    layers_route = 0
    for r, split in ((7, False), (24, False), (40, False), (15, True), (24, True)):
        for L in (1, 2, 4):
            for n in range(8, 2049, 8):
                units = (n,) * L
                w, u = _ranks(units, r, split, 16)
                plan = ck.reduced_stack_plan(units, 16, w, u, fast, SMS)
                if plan.route == "layers":
                    layers_route += 1
                    for home in ck.RED_HOMES:
                        for cl in ck.RED_CLUSTERS:
                            forced = _forced_plan(units, 16, w, u, fast, cl, home)
                            assert forced is None or not _launcher_accepts(forced, units, 16, w, u, fast)
                    continue
                assert _launcher_accepts(plan, units, 16, w, u, fast), (units, r, split, plan)
                first = ck.RED_HOMES.index(plan.home)
                for home in ck.RED_HOMES[: first + 1]:
                    for cl in ck.RED_CLUSTERS:
                        if home == plan.home and cl >= plan.cluster:
                            break
                        forced = _forced_plan(units, 16, w, u, fast, cl, home)
                        assert forced is None or not _launcher_accepts(forced, units, 16, w, u, fast)
    assert layers_route > 0


def _forced_plan(units, d, w, u, fast, cluster, home):
    """The wavefront forced to ``cluster`` CTAs at ``home`` (None past a
    block's 32 warps)."""
    geom = ck.stack_geometry(units, w, u)
    warps = -(-geom.warps // cluster)
    if warps > ck.RED_MAX_WARPS:
        return None
    return ck.ReducedStackPlan("wave", cluster, warps, home, 32 * warps,
                               ck.reduced_stack_smem_bytes(geom, d, cluster, warps, home, fast))


def test_layers_route_past_16_ctas():
    """2048 units in four layers (1024 warps) fit no cluster of 16 CTAs of
    32 warps: the layer loop, one CTA, named in the plan."""
    units = (2048,) * 4
    w, u = _ranks(units, 24, False, 16)
    plan = ck.reduced_stack_plan(units, 16, w, u, False, SMS)
    assert plan.route == "layers" and plan.cluster == 1 and plan.home == "global"
    assert plan.threads == 1024 and plan.smem_bytes == 4 * (2 * 8192 + 4 * 2048 + 48 + 16)
    # one SM: no cluster past one CTA, so 3x512 takes the layer loop too
    w, u = _ranks((512,) * 3, 24, False, 16)
    assert ck.reduced_stack_plan((512,) * 3, 16, w, u, False, 1).route == "layers"


def test_a_plan_the_kernel_cannot_run_is_refused():
    units = (512, 512, 512)
    w, u = _ranks(units, 24, False, 16)
    ok = ck.reduced_stack_plan(units, 16, w, u, False, SMS)
    ck.check_reduced_stack_plan(ok, units, 16, w, u, False)
    bad = [
        (ok._replace(cluster=8), "8 x 12 warps for the stack's 192"),
        (_forced_plan(units, 16, w, u, False, 8, "registers"), "the registers home at 768 threads"),
        (ok._replace(cluster=3), "3 CTAs of 12 warps"),
        (ok._replace(route="grid"), "route 'grid'"),
        (ok._replace(smem_bytes=ok.smem_bytes + 4), "shared memory"),
    ]
    for plan, why in bad:
        with pytest.raises(ValueError, match=rf"fused_reduced_stack: the wavefront cannot run .*{why}"):
            ck.check_reduced_stack_plan(plan, units, 16, w, u, False)
    with pytest.raises(ValueError, match="layer loop needs"):
        ck.check_reduced_stack_plan(ck.ReducedStackPlan("layers", 1, 32, "global", 1024, 300_000),
                                    units, 16, w, u, False)


@pytest.mark.parametrize("merged", [True, False], ids=["merged", "split"])
def test_pack_is_per_warp_per_gate_and_per_layer(merged):
    """A warp's block: its 32 columns of [I|wC] and of [I|uC] by rows, [q][8g
    + u] (split: its gate's block alone, zero past r_g), its 8 rows of uB
    and of the next layer's wB as [k][u][lane] over the flattened h·B; then
    layer 0's wB, [k][e]; units past n, entries past a rank and warps past
    the stack's are zero."""
    model = _model((13, 20), 3, merged, d=5, seed=7)
    units, w_ranks, u_ranks = ck._stack_ranks(model)
    geom = ck.stack_geometry(units, w_ranks, u_ranks)
    Wt = geom.warps + 1
    flat = ck.pack_reduced_stack(model, Wt, False)
    assert flat.numel() == Wt * geom.E + 5 * 32 * geom.KX
    blocks = flat[: Wt * geom.E].reshape(Wt, geom.E)
    QW, QU, KU = geom.QW, geom.QU, geom.KU
    flat_B = lambda Bs: Bs if isinstance(Bs, torch.Tensor) else torch.cat(list(Bs), 1)  # noqa: E731
    w0 = 0
    for i, l in enumerate(model.layers):
        n = l.units
        wB, wC, uB, uC = ck._sides(l)
        nxt = ck._sides(model.layers[i + 1])[0] if i + 1 < len(model.layers) else None
        for k in range(-(-n // 8)):
            blk = blocks[w0 + k]
            for uu in range(8):
                j = 8 * k + uu
                for g in range(4):
                    for side, (Bs, Cs, Q, o) in enumerate(((wB, wC, QW, 0), (uB, uC, QU, 32 * QW))):
                        if merged:
                            col = ck.fold_IC(Bs, Cs)[:, g * n + j] if j < n else torch.zeros(Bs.shape[1])
                        else:
                            col = ck.fold_IC(Bs[g], Cs[g])[:, j] if j < n else torch.zeros(Bs[g].shape[1])
                        col = torch.nn.functional.pad(col, (0, Q - len(col)))
                        assert torch.equal(blk[o + 8 * g + uu : o + 32 * Q : 32], col), (i, j, g, side)
                o = 32 * (QW + QU)
                for which, (Bs, K, base) in enumerate(((uB, KU, o), (nxt, geom.KN, o + 256 * KU))):
                    row = flat_B(Bs)[j] if Bs is not None and j < n else torch.zeros(0)
                    row = torch.nn.functional.pad(row, (0, 32 * K - len(row)))
                    got = blk[base : base + 256 * K].reshape(K, 8, 32)[:, uu].reshape(-1)
                    assert torch.equal(got, row), (i, j, which)
        w0 += -(-n // 8)
    assert torch.equal(blocks[w0:], torch.zeros_like(blocks[w0:]))
    wx = flat[Wt * geom.E :].reshape(5, 32 * geom.KX)
    B0 = flat_B(ck._sides(model.layers[0])[0])
    assert torch.equal(wx, torch.nn.functional.pad(B0, (0, 32 * geom.KX - B0.shape[1])))
    assert ck.pack_reduced_stack(model, Wt, True).dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# on the card: the kernel against its emulation
# ---------------------------------------------------------------------------

@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("units,merged,cluster,home", [
    ((30, 30, 30, 30), False, 4, "staged"),
    ((24, 40), True, 2, "registers"),
    ((136,), True, 1, "staged"),
])
def test_cuda_kernel_follows_the_emulation(cuda, units, merged, cluster, home, monkeypatch):
    """The kernel at a forced plan against its emulation on the same plan,
    exact mode, T = 16: the same sums in the same order, so they agree to
    the last bits of expf, tanhf and the compiler's contractions (1e-5)."""
    model = _model(units, 6, merged, seed=8)
    x = _x(16, seed=18)
    plan = _forced(model, D, False, cluster, home)
    h = torch.empty((16, units[-1]), dtype=torch.float32, device=cuda)
    on_card = __import__("copy").deepcopy(model).to(cuda)
    ck._launch_reduced_stack(on_card, x.to(cuda), False, plan, h)
    torch.cuda.synchronize()
    emulated, _, _ = _run_emulated(model, x, False, monkeypatch, plan=plan)
    assert float((h.cpu() - emulated).abs().max()) <= 1e-5
