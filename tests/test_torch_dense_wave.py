"""K1's wavefront (``dense_stack_wave`` in svd_lstm_tpu_torch/ops/csrc/
lstm_recurrence.cu) without a card: its route rule, and a step-wise numpy
emulation of its schedule.

The emulation runs behind the wrapper's own launches on CPU tensors
(``_on_card`` made to say yes, ``_launch`` replaced): it reads the
launcher's arguments from memory as the kernel would (the meta rows, the
packed weights P, x, the biases) and writes the last layer's h where the
kernel writes it, so the wrapper's packing and offsets are checked with the
schedule. Per step s, layer i computes t = s - i from the parity (s + 1) & 1
of the state [x | h_0 | ... | h_{L-1}] into the other one; the S lanes of a
unit take k = l, l + S, ... < din + n (NaN past the state vector and past
P, so a lane that reads past its range poisons its sum); their partial sums
are added as a tree over the lane index, the highest bit first; fast mode
rounds x and h to bf16 where they enter the state. Held against
``fused_dense_stack_plain`` (exact: 2e-5, the float32 sum order; fast: K5's
limit, 2 bf16 ulps of the largest output or twice the plain version's
distance from float64 state). Mutations of the emulation (the parity read,
the stop index) must fail it.
"""

import copy
import ctypes

import numpy as np
import pytest
import torch

from svd_lstm_tpu_torch.io.checkpoint import NODE_TYPES, from_numpy_tree
from svd_lstm_tpu_torch.ops import cuda_lstm as ck

T = 24
D = 16


def _normal(rng, shape, scale=1.0):
    return rng.normal(scale=scale, size=shape).astype(np.float32)


def _stack(seed, units, d=D):
    """A dense stack, weights scaled 1/sqrt(fan-in) as trained ones are."""
    rng = np.random.default_rng(seed)
    layers, din = [], d
    for n in units:
        layers.append(NODE_TYPES["LSTMLayerParams"](
            W=_normal(rng, (din, 4 * n), din ** -0.5),
            U=_normal(rng, (n, 4 * n), n ** -0.5),
            b=_normal(rng, (4 * n,), 0.1),
        ))
        din = n
    tree = NODE_TYPES["StackedLSTMParams"](
        layers=tuple(layers),
        head=NODE_TYPES["DenseParams"](w=_normal(rng, (din, 1), 0.3), b=_normal(rng, (1,))),
    )
    return from_numpy_tree(tree, device="cpu")


def _view(ptr: int, count: int, dtype) -> np.ndarray:
    """count values of dtype at address ptr, writable."""
    size = count * np.dtype(dtype).itemsize
    return np.frombuffer((ctypes.c_uint8 * size).from_address(ptr), dtype=dtype)


def _bf16_round(v: np.ndarray) -> np.ndarray:
    return torch.from_numpy(np.ascontiguousarray(v, np.float32)).bfloat16().float().numpy()


def _sigmoid(z):
    return np.float32(1) / (np.float32(1) + np.exp(-z))


def emulate_wave(meta, L, P_ptr, E, x_ptr, out_ptr, T, d, lanes, home, bf16, mutation=None):
    """dense_stack_wave_launch's arguments in, the last layer's h written to
    out_ptr, step by step as the kernel's schedule runs (module docstring)."""
    S = lanes
    rows = _view(meta, 4 * L, np.int64).reshape(L, 4)
    layers = [(int(din), int(n), int(off), _view(int(b), 4 * int(n), np.float32).copy())
              for din, n, off, b in rows]
    if bf16:
        bits = _view(P_ptr, 4 * E, np.uint16).astype(np.uint32) << 16
        P = bits.view(np.float32).reshape(E, 4).astype(np.float64)
    else:
        P = _view(P_ptr, 4 * E, np.float32).reshape(E, 4).astype(np.float64)
    nmax = max(n for _, n, _, _ in layers)
    P = np.vstack([P, np.full((8 * 8 * nmax, 4), np.nan)])  # NaN past P's end
    x = _view(x_ptr, T * d, np.float32).reshape(T, d)
    n_out = layers[-1][1]
    out = _view(out_ptr, T * n_out, np.float32).reshape(T, n_out)
    rnd = _bf16_round if bf16 else (lambda v: np.asarray(v, np.float32))

    V = d + sum(n for _, n, _, _ in layers)
    state = np.zeros((2, V + 8 * nmax), np.float32)
    state[:, V:] = np.nan  # NaN past the state vector's end
    state[1, :d] = rnd(x[0])
    h_off = np.cumsum([d] + [n for _, n, _, _ in layers])[:-1]
    c = [np.zeros(n, np.float32) for _, n, _, _ in layers]
    lane_ids = np.arange(S)
    for s in range(T + L - 1):
        read, write = (s + 1) & 1, s & 1
        if mutation == "parity":
            read = write
        for i, (din, n, w_off, b) in enumerate(layers):
            t = s - i
            if not 0 <= t < T:
                continue
            in_off = h_off[i] - din
            parts = np.zeros((S, n, 4))
            for l in range(S):
                kb = (din + n - l + S - 1) // S + (1 if mutation == "stop" else 0)
                ks = l + S * np.arange(kb)
                w = P[w_off + ks[:, None] * n + np.arange(n)[None, :]]  # (kb, n, 4)
                parts[l] = np.einsum("k,knq->nq", state[read, in_off + ks].astype(np.float64), w)
            parts = parts.astype(np.float32)
            bit = S // 2
            while bit:  # the lanes' tree, the highest bit first
                parts = parts + parts[lane_ids ^ bit]
                bit //= 2
            z = parts[0] + b.reshape(4, n).T  # (n, 4): unit j's four gates
            i_g, f_g, o_g = _sigmoid(z[:, 0]), _sigmoid(z[:, 1]), _sigmoid(z[:, 3])
            c[i] = f_g * c[i] + i_g * np.tanh(z[:, 2])
            h = o_g * np.tanh(c[i])
            state[write, h_off[i] : h_off[i] + n] = rnd(h)
            if i == L - 1:
                out[t] = h
        if s + 1 < T:
            state[write, :d] = rnd(x[s + 1])
    return 0


def _run_emulated(model, x, fast, monkeypatch, mutation=None):
    """fused_dense_stack on CPU tensors with the card's route taken and the
    kernel emulated; returns (output, the C entry point launched)."""
    names = []

    def launch(name, device, *args):
        names.append(name)
        if name == "dense_stack_wave":
            emulate_wave(*args, mutation=mutation)

    monkeypatch.setattr(ck, "_on_card", lambda *t: True)
    monkeypatch.setattr(ck, "_launch", launch)
    monkeypatch.setattr(ck, "LAUNCHES", dict(ck.LAUNCHES))
    out = ck.fused_dense_stack(model, x, dot_precision="default" if fast else None)
    return out, names


def _limit(model, x, want, fast) -> float:
    if not fast:
        return 2e-5
    want64 = ck.fused_dense_stack_plain(copy.deepcopy(model).double(), x.double(), "default")
    drift = float((want.double() - want64).abs().max())
    ulp = 2.0 ** (np.floor(np.log2(float(want.abs().max()))) - 7)
    return max(2 * ulp, 2 * drift)


SHAPES = [(24, 40), (30, 30, 30, 30), (40, 40, 40, 40), (8, 128, 16), (128,)]


@pytest.mark.parametrize("fast", [False, True], ids=["exact", "fast"])
@pytest.mark.parametrize("units", SHAPES, ids=lambda u: "x".join(map(str, u)))
def test_emulated_wavefront_matches_plain(units, fast, monkeypatch):
    model = _stack(1, units)
    x = torch.tensor(_normal(np.random.default_rng(2), (T, D)))
    want = ck.fused_dense_stack_plain(model, x, "default" if fast else None)
    got, names = _run_emulated(model, x, fast, monkeypatch)
    assert names == ["dense_stack_wave"]
    assert float((got - want).abs().max()) <= _limit(model, x, want, fast)


@pytest.mark.parametrize("mutation", ["parity", "stop"])
@pytest.mark.parametrize("units", [(30, 30, 30, 30), (24, 40)], ids=["4x30", "24x40"])
def test_a_mutated_emulation_fails(units, mutation, monkeypatch):
    """Reading the parity being written, or a lane running one k past
    din + n, must show: the emulation is a check of the schedule."""
    model = _stack(3, units)
    x = torch.tensor(_normal(np.random.default_rng(4), (T, D)))
    want = ck.fused_dense_stack_plain(model, x)
    got, _ = _run_emulated(model, x, False, monkeypatch, mutation)
    err = float((got - want).abs().max())
    assert not err <= 1e-3  # NaN (read past a range) or far off


# ---------------------------------------------------------------------------
# the route rule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("units,exact,fast", [
    ((30, 30, 30, 30), ("registers", 4), ("registers", 4)),   # the 4x30 checkpoint
    ((40, 40, 40, 40), ("staged", 4), ("staged", 4)),         # run A's stack
    ((24, 40), ("registers", 8), ("registers", 8)),
    ((128,), ("global", 8), ("staged", 8)),                   # 295 KB exact, 147 KB bf16
    ((8, 128, 16), ("global", 4), ("staged", 4)),
    ((128, 128, 128, 128), ("global", 2), ("global", 2)),     # 1.9 MB
    ((512, 512, 512), ("layers", 1), ("layers", 1)),          # 1536 units: no block holds them
], ids=lambda v: "x".join(map(str, v)) if isinstance(v[0], int) else None)
def test_route_rule_at_the_repo_shapes(units, exact, fast):
    for mode, want in ((False, exact), (True, fast)):
        plan = ck.dense_plan(units, D, mode)
        assert (plan.route, plan.lanes) == want


@pytest.mark.parametrize("fast", [False, True], ids=["exact", "fast"])
def test_route_rule_stays_within_what_the_launcher_checks(fast):
    """Every stack K1 takes (up to 8 layers of at most 128 units, and wider)
    gets a plan that csrc dense_stack_wave_launch accepts, or the layer
    loop; none goes to a plain version."""
    rng = np.random.default_rng(5)
    shapes = [tuple(int(v) for v in rng.integers(1, 129, size=int(rng.integers(1, 9))))
              for _ in range(300)]
    shapes += [(512,), (512, 512, 512), (1, 1), (128,) * 8, (1024,), (1025,)]
    for units in shapes:
        for d in (1, 16, 128, 1100):
            plan = ck.dense_plan(units, d, fast)
            if plan.route == "layers":
                assert ck.wave_threads(units, d, 1) > ck.MAX_THREADS
                continue
            threads = ck.wave_threads(units, d, plan.lanes)
            assert plan.threads == threads and plan.smem_bytes <= ck._SMEM_LIMIT
            assert plan.lanes in ck.WAVE_LANES and threads <= ck.MAX_THREADS
            if plan.route == "registers":
                assert threads <= ck.WAVE_REG_THREADS
                assert ck._wave_kb(units, d, plan.lanes) <= ck.WAVE_REG_KB
            if plan.route == "staged":
                assert plan.smem_bytes == 8 * (d + sum(units)) + ck.wave_entries(units, d) * (
                    8 if fast else 16)


def test_the_layer_loop_takes_3x512(monkeypatch):
    """3x512 (reached through bench/timing.py's "pallas" impl) runs the layer
    loop, not a plain version."""
    model = _stack(6, (512, 512, 512))
    _, names = _run_emulated(model, torch.zeros((2, D)), False, monkeypatch)
    assert names == ["fused_dense_stack"]


def test_pack_wave_interleaves_the_gates():
    model = _stack(7, (8, 12))
    for fast in (False, True):
        P = ck.pack_wave(model.layers, fast).float()
        off = 0
        for l in model.layers:
            din, n = l.W.shape[0], l.units
            WU = torch.cat([l.W, l.U])
            if fast:
                WU = WU.bfloat16().float()
            block = P[off : off + (din + n) * n].reshape(din + n, n, 4)
            for g in range(4):
                assert torch.equal(block[:, :, g], WU[:, g * n : (g + 1) * n])
            off += (din + n) * n
        assert off == P.shape[0] == ck.wave_entries((8, 12), D)
