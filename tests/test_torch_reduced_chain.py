"""K2's cluster chain (``reduced_chain`` in svd_lstm_tpu_torch/ops/csrc/
lstm_recurrence.cu) without a card: its plan rule, its packing, and a
step-wise numpy emulation of its cluster.

The emulation runs behind the wrapper's own launch on CPU tensors
(``_on_card`` made to say yes, the card's plan given, ``_launch``
replaced): it reads the launcher's arguments from memory as the kernel
would (xp, the packed blocks of every warp, the block ranks, h0 and c0 or
null) and writes h where the kernel writes it, so the wrapper's packing is
checked with the schedule. It poisons ``out`` and the partial-sum slots
with NaN first. Per step, in the kernel's fixed order:

1. each warp's partial hb over its 8 units (an FMA chain over u = 0..7);
2. each CTA's partial, its warps' partials added in warp order, stored in
   the slot of its rank, parity t & 1 (the CTAs in a shuffled order);
3. the cluster barrier;
4. hb = the CTAs' partials added in rank order (rounded to bf16 in fast
   mode); lane 8g + u's column dot over its block's rank in four FMA chains
   (q mod 4), added as (0 + 1) + (2 + 3); + xp_t, the gate update, c
   carried; units past n neither read xp nor written.

Held against ``reduced_recurrence_plain`` within K2's limit (2e-5 + 1e-5
relative at these sizes, the float32 sum order; tests/test_torch_kernels.py)
and K2f's (2 bf16 ulps of the largest h, or twice the plain version's
distance from float64 state), merged and split, for n in {24, 30, 136,
512}, with the rule's cluster and with forced ones. The mutations "barrier"
(a CTA reads the slots before the others have stored this step's
partials), "state" (h0 and c0 dropped) and "mask" (units past n read xp
and are written) must fail it.
"""

import ctypes

import numpy as np
import pytest
import torch

from svd_lstm_tpu_torch.ops import cuda_lstm as ck

ATOL, RTOL = 2e-5, 1e-5
SMEM_LIMIT = 232_448
SMS = 132


def _case(seed, T, n, split, r):
    """xp, uB, uC, h0, c0; split ranks differ per gate (r + g)."""
    rng = np.random.default_rng(seed)
    f = lambda shape, s=1.0: torch.tensor(rng.normal(scale=s, size=shape), dtype=torch.float32)  # noqa: E731
    xp = f((T, 4 * n))
    if split:
        uB = tuple(f((n, r + g), n ** -0.5) for g in range(4))
        uC = tuple(f((r + g, n - r - g), (r + g) ** -0.5) for g in range(4))
    else:
        uB = f((n, r), n ** -0.5)
        uC = f((r, 4 * n - r), r ** -0.5)
    return xp, uB, uC, f((n,), 0.5), f((n,), 0.5)


def _view(ptr: int, count: int, dtype) -> np.ndarray:
    size = count * np.dtype(dtype).itemsize
    return np.frombuffer((ctypes.c_uint8 * size).from_address(ptr), dtype=dtype)


def _from_bf16(bits: np.ndarray) -> np.ndarray:
    return (bits.astype(np.uint32) << 16).view(np.float32)


def _bf16_round(v: np.ndarray) -> np.ndarray:
    return torch.from_numpy(np.ascontiguousarray(v, np.float32)).bfloat16().float().numpy()


def _fma(a, b, c):
    """fmaf: the product exact (float64), one rounding of the sum."""
    return (a.astype(np.float64) * b + c).astype(np.float32)


def _sigmoid(z):
    return np.float32(1) / (np.float32(1) + np.exp(-z))


def emulate_reduced(xp_ptr, P_ptr, ranks_ptr, blocks, h0_ptr, c0_ptr, out_ptr, c_out_ptr, T, n, cluster,
                    warps, home, bf16, *, rng, mutation=None):
    """One reduced_recurrence_launch, all T steps (module docstring). The
    weights' home moves no number, so it is only checked."""
    assert blocks in (1, 4) and 0 <= home < len(ck.RED_HOMES)
    ranks = [int(r) for r in _view(ranks_ptr, blocks, np.int32)]
    R, off = sum(ranks), np.concatenate([[0], np.cumsum(ranks)[:-1]]).astype(int)
    split = blocks == 4
    Wt, U = cluster * warps, ck.RED_UNITS
    assert Wt * U >= n
    E = ck.reduced_entries(ranks)
    if bf16:
        P = _from_bf16(_view(P_ptr, Wt * E, np.uint16)).reshape(Wt, E)
    else:
        P = _view(P_ptr, Wt * E, np.float32).reshape(Wt, E)
    # each warp's weights: IC[w, c, q] (column c = 8g + u, [q][c] in P), B[w, b, u, q]
    rmax = max(ranks)
    IC = P[:, : 32 * rmax].reshape(Wt, rmax, 32).transpose(0, 2, 1)
    B = np.zeros((Wt, blocks, U, rmax), np.float32)
    for b in range(blocks):
        for u in range(U):
            o = 32 * rmax + U * off[b] + u * ranks[b]
            B[:, b, u, : ranks[b]] = P[:, o : o + ranks[b]]
    xp = _view(xp_ptr, T * 4 * n, np.float32).reshape(T, 4 * n)
    keep = mutation != "state"
    j = np.arange(Wt * U).reshape(Wt, U)  # unit u of warp w
    unit = j < n
    h = np.zeros((Wt, U), np.float32)
    c = np.zeros((Wt, U), np.float32)
    if h0_ptr and keep:
        h[unit] = _view(h0_ptr, n, np.float32)
    if c0_ptr and keep:
        c[unit] = _view(c0_ptr, n, np.float32)
    operand = _bf16_round if bf16 else (lambda v: v)
    hop = operand(h)
    out = _view(out_ptr, T * n, np.float32).reshape(T, n)
    out[...] = np.nan
    slots = np.full((2, cluster, R), np.nan, np.float32)  # every CTA's copy holds the same values
    reads = unit if mutation != "mask" else np.ones_like(unit)

    def push(t, cta):
        ws = slice(cta * warps, (cta + 1) * warps)
        wpart = np.full((warps, R), np.nan, np.float32)
        for b in range(blocks):
            p = np.zeros((warps, ranks[b]), np.float32)
            for u in range(U):
                p = _fma(hop[ws, u, None], B[ws, b, u, : ranks[b]], p)
            wpart[:, off[b] : off[b] + ranks[b]] = p
        s = np.zeros(R, np.float32)
        for w in range(warps):
            s = s + wpart[w]
        slots[t & 1, cta] = s

    def update(t, cta):
        ws = slice(cta * warps, (cta + 1) * warps)
        hb = np.zeros(R, np.float32)
        for r in range(cluster):
            hb = hb + slots[t & 1, r]
        hb = operand(hb)
        col_block = np.arange(32) // 8 if split else np.zeros(32, int)
        d = np.zeros((4, warps, 32), np.float32)  # lane c's four chains, over q mod 4
        for q in range(rmax):
            live = q < np.array(ranks)[col_block]  # the lane's block rank
            hq = np.array([hb[off[b] + q] if q < ranks[b] else 0 for b in col_block], np.float32)
            d[q % 4] = np.where(live, _fma(hq[None], IC[ws][:, :, q], d[q % 4]), d[q % 4])
        acc = (d[0] + d[1]) + (d[2] + d[3])
        jj = j[ws]
        xg = np.zeros((warps, 32), np.float32)
        for g in range(4):
            rd = reads[ws]
            xg[:, 8 * g : 8 * g + 8][rd] = xp[t, np.minimum(g * n + jj[rd], 4 * n - 1)]
        z = acc + xg
        i, f, gg, o = (z[:, 8 * g : 8 * g + 8] for g in range(4))
        cn = _sigmoid(f) * c[ws] + _sigmoid(i) * np.tanh(gg)
        hn = _sigmoid(o) * np.tanh(cn)
        m = unit[ws] if mutation != "mask" else np.ones_like(unit[ws])
        c[ws] = np.where(m, cn, c[ws])
        out[t, np.minimum(jj[m], n - 1)] = hn[m]  # "mask": a unit past n lands on unit n - 1
        hop[ws] = np.where(unit[ws], operand(hn), 0)

    for t in range(T):
        order = rng.permutation(cluster)
        if mutation == "barrier":  # each CTA sums the slots right after its own store
            for cta in order:
                push(t, cta)
                update(t, cta)
        else:
            for cta in order:
                push(t, cta)
            for cta in rng.permutation(cluster):
                update(t, cta)
    if c_out_ptr:
        _view(c_out_ptr, n, np.float32)[:] = c[unit]  # lanes 0..7's c_T, in unit order
    return 0


def _plan(n, ranks, fast, cluster=None, home=None):
    """The rule's plan, or one forced to ``cluster`` CTAs at ``home``."""
    if cluster is None:
        return ck.reduced_plan(n, ranks, fast, SMS)
    warps = -(-(-(-n // cluster)) // ck.RED_UNITS)
    return ck.ReducedPlan(cluster, warps, home, 32 * warps,
                          ck.reduced_smem_bytes(ranks, cluster, warps, home, fast), 0)


def _run_emulated(args, fast, monkeypatch, plan=None, mutation=None, seed=0, return_c=False,
                  packed=None):
    """reduced_recurrence on CPU tensors with the card's route taken: the
    rule's plan on 132 SMs (or ``plan``), the launch emulated; ``packed()``
    (run with the route taken) packs the weights. Returns (h, plan,
    launches)."""
    rng = np.random.default_rng(seed)
    xp, uB = args[:2]
    n = xp.shape[1] // 4
    plan = plan or ck.reduced_plan(n, ck.reduced_ranks(uB), fast, SMS)
    launches = []

    def launch(name, device, *a):
        assert name == "reduced_recurrence"
        launches.append(a)
        emulate_reduced(*a, rng=rng, mutation=mutation)

    monkeypatch.setattr(ck, "_on_card", lambda *t: True)
    monkeypatch.setattr(ck, "card_reduced_plan", lambda dev, n_, ranks, fast_: plan)
    monkeypatch.setattr(ck, "_launch", launch)
    monkeypatch.setattr(ck, "LAUNCHES", dict.fromkeys(ck.REPLACES, 0))
    h = ck.reduced_recurrence(*args, dot_precision="default" if fast else None, return_c=return_c,
                              packed=None if packed is None else packed())
    return h, plan, launches


def _double(a):
    return tuple(_double(v) for v in a) if isinstance(a, tuple) else a.double()


def _within(got, args, fast) -> bool:
    """K2's limit (exact) or K2f's (fast) against the plain version."""
    dp = "default" if fast else None
    want = ck.reduced_recurrence_plain(*args, dot_precision=dp)
    if not fast:
        return bool(torch.all((got - want).abs() <= ATOL + RTOL * want.abs()))
    want64 = ck.reduced_recurrence_plain(*_double(args), dot_precision=dp)
    drift = float((want.double() - want64).abs().max())
    ulp = 2.0 ** (np.floor(np.log2(float(want.abs().max()))) - 7)
    return float((got - want).abs().max()) <= max(2 * ulp, 2 * drift)


@pytest.mark.parametrize("state", [False, True], ids=["zero-state", "h0-c0"])
@pytest.mark.parametrize("fast", [False, True], ids=["exact", "fast"])
@pytest.mark.parametrize("split", [False, True], ids=["merged", "split"])
@pytest.mark.parametrize("n,r,T", [(24, 7, 8), (30, 7, 8), (136, 24, 6), (512, 24, 4)])
def test_emulated_chain_matches_plain(n, r, T, split, fast, state, monkeypatch):
    xp, uB, uC, h0, c0 = _case(1, T, n, split, r)
    args = (xp, uB, uC, h0, c0) if state else (xp, uB, uC)
    got, plan, launches = _run_emulated(args, fast, monkeypatch)
    assert len(launches) == 1 and plan.cluster * plan.warps * ck.RED_UNITS >= n
    assert ck.LAUNCHES == {**dict.fromkeys(ck.REPLACES, 0),
                           "reduced_recurrence_fast" if fast else "reduced_recurrence": 1}
    assert got.shape == (T, n) and _within(got, args, fast)


@pytest.mark.parametrize("split", [False, True], ids=["merged", "split"])
def test_emulated_chain_returns_final_c(split, monkeypatch):
    """With return_c the cluster stores c_T, which the pipeline's stages
    carry into the next chunk: the plain version's final c, within K2's
    limit."""
    args = _case(3, 8, 30, split, 7)
    (h, c), _, _ = _run_emulated(args, False, monkeypatch, return_c=True)
    want_h, want_c = ck.reduced_recurrence_plain(*args, return_c=True)
    assert c.shape == (30,) and h.shape == (8, 30)
    torch.testing.assert_close(h, want_h, atol=ATOL, rtol=RTOL)
    torch.testing.assert_close(c, want_c, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("split", [False, True], ids=["merged", "split"])
def test_emulated_chain_takes_packed_weights(split, monkeypatch):
    """Factors packed once by the caller for the plan (the pipeline's
    chunks, ``pack_reduced_recurrence``) give the launch the weights it
    packs itself; a packing for another mode raises."""
    args = _case(4, 8, 30, split, 7)
    want, _, _ = _run_emulated(args, False, monkeypatch)
    got, _, _ = _run_emulated(args, False, monkeypatch,
                              packed=lambda: ck.pack_reduced_recurrence(*args[1:3]))
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    with pytest.raises(ValueError, match="packed weights"):
        _run_emulated(args, False, monkeypatch,
                      packed=lambda: ck.pack_reduced_recurrence(*args[1:3], dot_precision="default"))


@pytest.mark.parametrize("cluster,home", [(4, "registers"), (8, "staged"), (16, "registers")])
@pytest.mark.parametrize("split", [False, True], ids=["merged", "split"])
@pytest.mark.parametrize("n,r", [(30, 7), (136, 40)])
def test_emulated_forced_clusters_match_plain(n, r, split, cluster, home, monkeypatch):
    """Clusters past the rule: CTAs that own no unit (n = 30 on 8 or 16
    CTAs), and ranks past one lane each (r = 40: two chunks of q)."""
    if home == "registers" and r > ck.RED_REG_RANK:
        home = "staged"
    xp, uB, uC, h0, c0 = _case(3, 5, n, split, r)
    args = (xp, uB, uC, h0, c0)
    for fast in (False, True):
        plan = _plan(n, ck.reduced_ranks(uB), fast, cluster, home)
        got, _, _ = _run_emulated(args, fast, monkeypatch, plan=plan)
        assert _within(got, args, fast)


@pytest.mark.parametrize("mutation,n,split", [
    ("barrier", 136, False),  # a CTA sums the slots before the others stored this step's partials
    ("barrier", 512, True),
    ("state", 24, False),     # h0 and c0 dropped
    ("mask", 30, True),       # units 30, 31 of the last warp read xp and are written
])
def test_a_mutated_emulation_fails(mutation, n, split, monkeypatch):
    xp, uB, uC, h0, c0 = _case(2, 6, n, split, 7)
    args = (xp, uB, uC, h0, c0)
    for fast in (False, True):
        plan = _plan(n, ck.reduced_ranks(uB), fast, 4, "registers") if mutation == "barrier" else None
        got, _, _ = _run_emulated(args, fast, monkeypatch, plan=plan, mutation=mutation)
        assert not _within(got, args, fast)


# ---------------------------------------------------------------------------
# the plan rule and the packing
# ---------------------------------------------------------------------------

def _launcher_accepts(plan, n, ranks, fast) -> bool:
    """csrc ``reduced_recurrence_launch``'s checks, in Python."""
    threads = 32 * plan.warps
    return (plan.cluster in ck.RED_CLUSTERS and 1 <= plan.warps <= ck.RED_MAX_WARPS
            and plan.threads == threads and plan.cluster * plan.warps * ck.RED_UNITS >= n
            and plan.home in ck.RED_HOMES
            and (plan.home != "registers"
                 or (threads <= ck.RED_REG_THREADS and max(ranks) <= ck.RED_REG_RANK))
            and plan.smem_bytes == ck.reduced_smem_bytes(ranks, plan.cluster, plan.warps, plan.home,
                                                         fast) <= SMEM_LIMIT)


@pytest.mark.parametrize("fast", [False, True], ids=["exact", "fast"])
@pytest.mark.parametrize("ranks,want", [
    ((24,), (8, "registers", 8)),          # 3x512 merged r = 24
    ((24, 24, 24, 24), (8, "registers", 8)),  # 3x512 split r = 24
])
def test_plan_at_3x512_r24(ranks, want, fast):
    plan = ck.reduced_plan(512, ranks, fast, SMS)
    assert (plan.cluster, plan.home, plan.warps) == want
    assert _launcher_accepts(plan, 512, ranks, fast)
    per_warp = ck.reduced_entries(ranks) * (2 if fast else 4)
    assert plan.weight_bytes == plan.warps * per_warp
    # the whole layer's weights: B (n, R) and every column's rank of [I|C]
    R = sum(ranks)
    assert plan.cluster * plan.warps * ck.reduced_entries(ranks) == 512 * R + 4 * 512 * (R // len(ranks))


RANK_SETS = [(1,), (7,), (24,), (32,), (33,), (64,), (128,), (24, 24, 24, 24), (7, 8, 9, 10),
             (32, 33, 1, 5), (64, 64, 64, 64)]


@pytest.mark.parametrize("fast", [False, True], ids=["exact", "fast"])
def test_plan_takes_every_width_or_names_it(fast):
    """Every n from 1 to 2048 at each rank set: a cluster the launcher
    accepts (the fewest CTAs of at most RED_WARPS warps whose weights fit,
    else the fewest of at most a block's), or a ValueError naming the
    shape."""
    def fits(cluster, cap):
        warps = -(-(-(-n // cluster)) // ck.RED_UNITS)
        return warps <= cap and ck.reduced_smem_bytes(ranks, cluster, warps, "staged",
                                                      fast) <= SMEM_LIMIT

    refused = 0
    for ranks in RANK_SETS:
        for n in range(max(ranks), 2049):
            try:
                plan = ck.reduced_plan(n, ranks, fast, SMS)
            except ValueError as e:
                assert f"n = {n}" in str(e) and str(tuple(ranks)) in str(e)
                assert not any(fits(cl, ck.RED_MAX_WARPS) for cl in ck.RED_CLUSTERS)
                refused += 1
                continue
            assert _launcher_accepts(plan, n, ranks, fast), (n, ranks, plan)
            cap = ck.RED_WARPS if any(fits(cl, ck.RED_WARPS) for cl in ck.RED_CLUSTERS) \
                else ck.RED_MAX_WARPS
            assert plan.warps <= cap
            assert plan.cluster == min(cl for cl in ck.RED_CLUSTERS if fits(cl, cap)), (n, ranks)
            assert (plan.home == "registers") == (max(ranks) <= ck.RED_REG_RANK
                                                  and plan.threads <= ck.RED_REG_THREADS)
    assert (refused > 0) == (not fast)  # (64,)*4 at n = 2048: f32 fits no cluster of 16, bf16 does


def test_plan_refuses_what_no_cluster_holds():
    with pytest.raises(ValueError, match=r"n = 2048 at ranks \(64, 64, 64, 64\)"):
        ck.reduced_plan(2048, (64,) * 4, False, SMS)
    with pytest.raises(ValueError, match="n = 512"):
        ck.reduced_plan(512, (24,), False, 1)  # one SM: no cluster past one CTA


@pytest.mark.parametrize("split", [False, True], ids=["merged", "split"])
def test_pack_is_per_warp_and_per_gate(split):
    """A warp's block: its 32 columns of [I|C] by rows, [q][8g + u] (gate g
    of unit u; split: [I|C_g] alone, zero past r_g), then B's rows block by
    block, unit by unit, each at its block's rank; units past n are zero."""
    n, r = 13, 3
    _, uB, uC, _, _ = _case(4, 1, n, split, r)
    ranks = ck.reduced_ranks(uB)
    Wt = 2
    P = ck.pack_reduced_chain(uB, uC, n, Wt, False).reshape(Wt, -1)
    E = ck.reduced_entries(ranks)
    R, rmax = sum(ranks), max(ranks)
    assert P.shape == (Wt, E) and E == 32 * rmax + 8 * R
    off = np.concatenate([[0], np.cumsum(ranks)[:-1]])
    for w in range(Wt):
        for u in range(ck.RED_UNITS):
            j = ck.RED_UNITS * w + u
            for g in range(4):
                if split:
                    col = ck.fold_IC(uB[g], uC[g])[:, j] if j < n else torch.zeros(ranks[g])
                else:
                    col = ck.fold_IC(uB, uC)[:, g * n + j] if j < n else torch.zeros(r)
                col = torch.nn.functional.pad(col, (0, rmax - len(col)))
                assert torch.equal(P[w, 8 * g + u : 32 * rmax : 32], col)
            for b in range(len(ranks)):
                Bb = uB[b] if split else uB
                row = Bb[j] if j < n else torch.zeros(ranks[b])
                o = 32 * rmax + 8 * off[b] + u * ranks[b]
                assert torch.equal(P[w, o : o + ranks[b]], row)
    assert ck.pack_reduced_chain(uB, uC, n, Wt, True).dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# on the card: the kernel at every cluster size and home, past the rule
# ---------------------------------------------------------------------------

@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("cluster,home", [(1, "registers"), (2, "staged"), (4, "registers"),
                                          (8, "staged"), (16, "registers"), (16, "staged")])
@pytest.mark.parametrize("split", [False, True], ids=["merged", "split"])
def test_cuda_every_cluster_matches_plain(cuda, cluster, home, split):
    """n = 120 (15 warps: one CTA holds it in registers) at r = 7 (split:
    7..10), T = 32, with h0 and c0: each cluster size and home against the
    plain version, exact and fast; units past n on the larger clusters."""
    n = 120
    args = _case(6, 32, n, split, 7)
    on_card = tuple(tuple(t.to(cuda) for t in a) if isinstance(a, tuple) else a.to(cuda) for a in args)
    for fast in (False, True):
        plan = _plan(n, ck.reduced_ranks(args[1]), fast, cluster, home)
        got = ck._launch_reduced(*on_card, fast, plan)
        torch.cuda.synchronize()
        assert _within(got.cpu(), args, fast), (cluster, home, fast)
