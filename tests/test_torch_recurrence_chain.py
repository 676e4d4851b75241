"""K3's persistent chain (``recurrence_chain`` in svd_lstm_tpu_torch/ops/
csrc/lstm_recurrence.cu) without a card: its plan rule, and a step-wise
numpy emulation of its grid.

The emulation runs behind the wrapper's own launch on CPU tensors
(``_on_card`` made to say yes, the card's plan given an SM count and an
occupancy, ``_launch`` replaced): it reads the launcher's arguments from
memory as the kernel would (xp, the unit-major packed U, h0 and c0 or
null) and writes h where the kernel writes it, so the wrapper's packing is
checked with the schedule. It first poisons ``out`` with NaN (memory no CTA
has written yet). Per step the CTAs (J units each, a warp a unit, all four
gates of their units) run in a shuffled order; each reads only h_{t-1},
which every CTA published to ``out`` before the barrier (h0, or zeros, at
step 0), rounded to bf16 in fast mode; lane l of a unit sums k = l, l + 32,
... < n in turn, one FMA chain a gate (each product exact, one rounding a
step); the 32 lanes' sums are added as the kernel's shuffles add them, a
tree over the lane index with the highest bit first; then xp_t and the gate
update with its c (c0 or zeros); units past n are not written. Held against
``lstm_recurrence_plain`` within K3's limit (2e-5 + 1e-5 relative, the
float32 sum order; tests/test_torch_kernels.py) and K3f's (2 bf16 ulps of
the largest h, or twice the plain version's distance from float64 state).
Mutations of the emulation (reading h_t before the barrier, h0 and c0
dropped, units past n written) must fail it.
"""

import ctypes

import numpy as np
import pytest
import torch

from svd_lstm_tpu_torch.ops import cuda_lstm as ck

ATOL, RTOL = 2e-5, 1e-5
SMEM_LIMIT = 232_448
# registers a thread of each home (rounded up to the allocation unit of 8),
# from the build's report on the H100 (-Xptxas -v)
REGISTERS = {"registers": 112, "staged": 40, "global": 48}


def _case(seed, T, n):
    """xp, U, h0, c0, weights scaled by 1/sqrt(fan-in) as trained ones are."""
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(T, 4 * n)).astype(np.float32),
            rng.normal(scale=n ** -0.5, size=(n, 4 * n)).astype(np.float32),
            rng.normal(scale=0.5, size=(n,)).astype(np.float32),
            rng.normal(scale=0.5, size=(n,)).astype(np.float32))


def _view(ptr: int, count: int, dtype) -> np.ndarray:
    size = count * np.dtype(dtype).itemsize
    return np.frombuffer((ctypes.c_uint8 * size).from_address(ptr), dtype=dtype)


def _from_bf16(bits: np.ndarray) -> np.ndarray:
    return (bits.astype(np.uint32) << 16).view(np.float32)


def _bf16_round(v: np.ndarray) -> np.ndarray:
    return torch.from_numpy(np.ascontiguousarray(v, np.float32)).bfloat16().float().numpy()


def _sigmoid(z):
    return np.float32(1) / (np.float32(1) + np.exp(-z))


def emulate_chain(xp_ptr, P_ptr, h0_ptr, c0_ptr, out_ptr, T, n, units, home, bf16, *, rng,
                  mutation=None):
    """One lstm_recurrence_launch, all T steps, its CTAs shuffled every step
    (module docstring). ``home`` moves no number, so it is only checked."""
    assert 0 <= home < len(ck.WAVE_HOMES) and 1 <= units <= ck.REC_MAX_UNITS
    J, G4 = units, 4 * n
    KB = -(-n // 32)
    xp = _view(xp_ptr, T * G4, np.float32).reshape(T, G4)
    if bf16:
        P = _from_bf16(_view(P_ptr, n * n * 4, np.uint16)).reshape(n, n, 4)  # [j][k][gate]
    else:
        P = _view(P_ptr, n * n * 4, np.float32).reshape(n, n, 4)
    keep = mutation != "state"
    h0 = _view(h0_ptr, n, np.float32).copy() if h0_ptr and keep else np.zeros(n, np.float32)
    c = _view(c0_ptr, n, np.float32).copy() if c0_ptr and keep else np.zeros(n, np.float32)
    out = _view(out_ptr, T * n, np.float32).reshape(T, n)
    out[...] = np.nan
    operand = _bf16_round if bf16 else (lambda v: v)
    ctas = -(-n // J)
    cval = np.zeros(ctas * J, np.float32)  # each unit's c, in its owning lane
    cval[:n] = c
    for t in range(T):
        for cta in rng.permutation(ctas):
            j = cta * J + np.arange(J)
            if mutation != "mask":
                j = j[j < n]  # units past n: no dot, no write
            if t == 0:
                h_prev = h0
            else:
                h_prev = out[t if mutation == "barrier" else t - 1]
            hs = np.zeros(32 * KB, np.float32)
            hs[:n] = operand(h_prev)
            W = np.zeros((len(j), 32 * KB, 4), np.float32)
            W[:, :n] = P[j % n]
            W = W.reshape(len(j), KB, 32, 4)
            acc = np.zeros((len(j), 32, 4), np.float32)
            for kb in range(KB):  # each lane's FMA chains, k = lane + 32·kb
                prod = hs[32 * kb:32 * (kb + 1)].astype(np.float64)[None, :, None] * W[:, kb]
                acc = (acc.astype(np.float64) + prod).astype(np.float32)
            for half in (16, 8, 4, 2, 1):  # the shuffles' tree, highest lane bit first
                acc = acc[:, :half] + acc[:, half:2 * half]
            z = acc[:, 0, :] + np.stack([xp[t, g * n + j % n] for g in range(4)], axis=1)
            cj = _sigmoid(z[:, 1]) * cval[j] + _sigmoid(z[:, 0]) * np.tanh(z[:, 2])
            cval[j] = cj
            h = _sigmoid(z[:, 3]) * np.tanh(cj)
            out[t, np.minimum(j, n - 1)] = h  # "mask": a unit past n lands on unit n - 1
    return 0


def _occupancy(n, fast):
    """CTAs an SM as threads, registers (REGISTERS) and shared memory (228 KB
    an SM, 1 KB a CTA kept back) allow, at most 32: a stand-in for the
    occupancy API."""
    def per_sm(units, home):
        threads = 32 * units
        smem = ck.recurrence_smem_bytes(n, units, home, fast)
        return min(32, 2048 // threads, 233_472 // (smem + 1024),
                   65_536 // (threads * REGISTERS[home]))
    return per_sm


def _run_emulated(args, fast, monkeypatch, sms=132, per_sm=None, mutation=None, seed=0):
    """lstm_recurrence on CPU tensors with the card's route taken: the plan
    for ``sms`` SMs, the launch emulated. Returns (h, plan, launches)."""
    rng = np.random.default_rng(seed)
    xp, U = args[:2]
    n = U.shape[0]
    plan = ck.recurrence_plan(n, fast, sms, per_sm or _occupancy(n, fast))
    launches = []

    def launch(name, device, *a):
        assert name == "lstm_recurrence"
        launches.append(a)
        emulate_chain(*a, rng=rng, mutation=mutation)

    monkeypatch.setattr(ck, "_on_card", lambda *t: True)
    monkeypatch.setattr(ck, "card_recurrence_plan", lambda dev, n_, fast_: plan)
    monkeypatch.setattr(ck, "_launch", launch)
    monkeypatch.setattr(ck, "LAUNCHES", dict.fromkeys(ck.REPLACES, 0))
    h = ck.lstm_recurrence(*args, dot_precision="default" if fast else None)
    return h, plan, launches


def _within(got, args, fast) -> bool:
    """K3's limit (exact) or K3f's (fast) against the plain version."""
    dp = "default" if fast else None
    want = ck.lstm_recurrence_plain(*args, dot_precision=dp)
    if not fast:
        return bool(torch.all((got - want).abs() <= ATOL + RTOL * want.abs()))
    want64 = ck.lstm_recurrence_plain(*(a.double() for a in args), dot_precision=dp)
    drift = float((want.double() - want64).abs().max())
    ulp = 2.0 ** (np.floor(np.log2(float(want.abs().max()))) - 7)
    return float((got - want).abs().max()) <= max(2 * ulp, 2 * drift)


@pytest.mark.parametrize("state", [False, True], ids=["zero-state", "h0-c0"])
@pytest.mark.parametrize("fast", [False, True], ids=["exact", "fast"])
@pytest.mark.parametrize("n,T", [(24, 8), (30, 8), (136, 6), (512, 4)])
def test_emulated_chain_matches_plain(n, T, fast, state, monkeypatch):
    xp, U, h0, c0 = (torch.tensor(a) for a in _case(1, T, n))
    args = (xp, U, h0, c0) if state else (xp, U)
    got, plan, launches = _run_emulated(args, fast, monkeypatch)
    assert len(launches) == 1 and plan.ctas * plan.units >= n
    assert ck.LAUNCHES == {**dict.fromkeys(ck.REPLACES, 0),
                           "lstm_recurrence_fast" if fast else "lstm_recurrence": 1}
    assert got.shape == (T, n) and _within(got, args, fast)


@pytest.mark.parametrize("mutation,n", [
    ("barrier", 136),  # a CTA reads h_t, which other CTAs are writing
    ("state", 24),     # h0 and c0 dropped
    ("mask", 30),      # units 30, 31 of the last CTA take U's columns and are written
])
def test_a_mutated_emulation_fails(mutation, n, monkeypatch):
    args = tuple(torch.tensor(a) for a in _case(2, 6, n))
    for fast in (False, True):
        got, _, _ = _run_emulated(args, fast, monkeypatch, mutation=mutation)
        assert not _within(got, args, fast)


# ---------------------------------------------------------------------------
# the plan rule
# ---------------------------------------------------------------------------

def _launcher_accepts(plan, n, fast, sms, per_sm) -> bool:
    """csrc ``lstm_recurrence_launch``'s checks (``rec_plan_ok`` and the
    co-residency of ``launch_chain``), in Python."""
    threads = 32 * plan.units
    smem = ck.recurrence_smem_bytes(n, plan.units, plan.home, fast)
    return (1 <= plan.units <= ck.REC_MAX_UNITS and plan.threads == threads
            and plan.home in ck.WAVE_HOMES
            and (plan.home != "registers"
                 or (threads <= ck.REC_REG_THREADS and -(-n // 32) <= ck.REC_REG_KB))
            and plan.smem_bytes == smem <= SMEM_LIMIT
            and plan.ctas == -(-n // plan.units) <= per_sm(plan.units, plan.home) * sms)


@pytest.mark.parametrize("fast", [False, True], ids=["exact", "fast"])
def test_plan_at_3x512_is_co_resident_on_the_h100(fast):
    """n = 512 on 132 SMs: 128 CTAs of 4 units, the weights in registers
    (16 entries a lane), every unit in exactly one CTA, 2 KB of shared
    memory (h_{t-1}), at most one CTA an SM needed."""
    per_sm = _occupancy(512, fast)
    plan = ck.recurrence_plan(512, fast, 132, per_sm)
    assert (plan.units, plan.home, plan.ctas, plan.threads) == (4, "registers", 128, 128)
    owners = np.concatenate([c * plan.units + np.arange(plan.units) for c in range(plan.ctas)])
    assert sorted(owners[owners < 512]) == list(range(512))
    assert plan.smem_bytes == 2048 <= SMEM_LIMIT
    assert _launcher_accepts(plan, 512, fast, 132, per_sm)


@pytest.mark.parametrize("fast", [False, True], ids=["exact", "fast"])
def test_plan_takes_every_width_or_names_it(fast):
    """Every n from 1 to 2048: a launch the launcher accepts (registers to
    n = 512, then staged, then the global copy), or a ValueError naming n."""
    homes = set()
    for n in range(1, 2049):
        per_sm = _occupancy(n, fast)
        try:
            plan = ck.recurrence_plan(n, fast, 132, per_sm)
        except ValueError as e:
            assert f"n = {n}" in str(e)
            continue
        assert _launcher_accepts(plan, n, fast, 132, per_sm), (n, plan)
        homes.add(plan.home)
        assert (plan.home == "registers") == (n <= 512)
    assert homes == set(ck.WAVE_HOMES)


def test_plan_refuses_what_no_card_holds():
    """A grid the card cannot hold at once, or an h wider than shared
    memory, is refused with n named: never run another way."""
    with pytest.raises(ValueError, match="n = 512"):
        ck.recurrence_plan(512, False, 4, lambda units, home: 1)
    with pytest.raises(ValueError, match="n = 60000"):
        ck.recurrence_plan(60_000, True, 132, lambda units, home: 32)


def test_pack_is_unit_major():
    U = torch.arange(3 * 12, dtype=torch.float32).reshape(3, 12)
    P = ck.pack_recurrence(U, False)
    for j in range(3):
        for k in range(3):
            assert P[j * 3 + k].tolist() == [U[k, g * 3 + j].item() for g in range(4)]
    assert ck.pack_recurrence(U, True).dtype == torch.bfloat16
