"""The narrow backward's launch rules and schedule (svd_lstm_tpu_torch/ops/
cuda_train.py, ops/csrc/lstm_train.cu), on the CPU, without a card.

The backward of K7 and K8 (``narrow_bwd_wave``) gives every unit, and every
one of the d units of dx, a group of S lanes, and runs the layers as a
reverse wavefront. The wrapper picks S (``narrow_bwd_lanes``), the block
(``narrow_bwd_threads``) and where the weights live
(``narrow_bwd_staged``), and passes them to the launcher, which only checks
them. These tests hold the rules to their promises:

* the block stays within 1024 threads for every stack K7 admits, and the
  launcher's checks (the state's loads, a group for every dx unit, S = 1
  only from the global copy) hold;
* every stack that K8's route (``compact_fits``, unchanged) admits runs
  within a block's shared memory, most of them with the weights staged;
* the repo's stacks and the edge stacks of the card tests get the lane
  count and weight home the card tests name for them;
* the staged weight layout (row stride n | 1) inverts exactly to Keras.

And a step-wise numpy emulation of the kernel (float64): each group's
roles, each lane's range of every dot, the staged and global weight
layouts with their padding poisoned by NaN, the state vector loaded one
step ahead, the two parities of the state and of dz, the one-step lag
between layers, the lane reduction and the owner lanes, held against
``fused_narrow_train_bwd_plain`` for S = 1, 2, 4, 8, T < L and ragged B. It
is the only check of the schedule that runs without a card.
"""

import numpy as np
import pytest
import torch

from svd_lstm_tpu_torch.ops import cuda_train as ct
from svd_lstm_tpu_torch.ops.cuda_lstm import _SMEM_LIMIT

R = ct.NARROW_ROWS


def _stacks(rng, count, max_layers, max_units):
    """Uniform stacks of every depth and width, then random uneven ones."""
    for L in range(1, max_layers + 1):
        for n in range(1, max_units + 1):
            yield [n] * L
    for _ in range(count):
        yield list(rng.integers(1, max_units + 1, size=rng.integers(1, max_layers + 1)))


def test_lane_rule_keeps_the_block_within_1024_threads():
    rng = np.random.default_rng(0)
    for units in _stacks(rng, 1000, ct.MAX_LAYERS, ct.NARROW_MAX):
        for d in (1, 16, 57, ct.NARROW_MAX):
            lanes = ct.narrow_bwd_lanes(units, d)
            threads = ct.narrow_bwd_threads(units, d, lanes)
            staged = ct.narrow_bwd_staged(units, d)
            assert lanes in (1, 2, 4, 8)
            assert lanes * sum(units) <= threads <= ct.BWD_MAX_THREADS == 1024, (units, d)
            assert threads % 32 == 0
            if lanes > 1:  # every dx unit has a group of its own
                assert lanes * (sum(units) + d) <= threads, (units, d)
            if lanes < 8:  # the next larger S would not give it
                assert 2 * lanes * (sum(units) + d) > 1024, (units, d)
            if lanes == 1:  # more than 512 units and dx units never fit staged
                assert not staged, (units, d)
            # every stack K7 admits runs within the launcher's checks and
            # a block's shared memory
            assert ct.narrow_bwd_fits(units, d, lanes, staged), (units, d, lanes)
            assert ct.narrow_bwd_smem_bytes(units, d, staged) <= _SMEM_LIMIT
            assert ct.narrow_bwd_smem_bytes(units, d, False) <= _SMEM_LIMIT
    # the largest: 8x128, d = 128 at S = 1 from the global copy, 167 936 B
    assert ct.narrow_bwd_lanes([128] * 8, 128) == 1
    assert ct.narrow_bwd_smem_bytes([128] * 8, 128, False) == 167_936
    assert not ct.narrow_bwd_fits([128] * 8, 128, 1, True)


# the stacks of the next test by weight home: staged, the global copy
CONFIG_COUNTS = {True: 19_979, False: 700}


def test_every_compact_stack_gets_a_configuration():
    """K8's route is not moved: over every stack compact_fits admits (uniform
    stacks and 5 000 random ones, d ∈ {1, 3, 16, 40, 100, 128}) the
    backward runs within the limit and the launcher's checks, with the
    weights staged where they fit, else from the global copy."""
    rng = np.random.default_rng(2)
    counts = dict.fromkeys((True, False), 0)
    for units in _stacks(rng, 5000, ct.MAX_LAYERS, ct.COMPACT_MAX_UNITS):
        for d in (1, 3, 16, 40, 100, ct.NARROW_MAX):
            if not ct.compact_fits(units, d):
                continue
            staged = ct.narrow_bwd_staged(units, d)
            assert ct.narrow_bwd_smem_bytes(units, d, staged) <= _SMEM_LIMIT
            assert staged == (ct.narrow_bwd_smem_bytes(units, d, True) <= _SMEM_LIMIT)
            assert ct.narrow_bwd_fits(units, d, ct.narrow_bwd_lanes(units, d), staged)
            counts[staged] += 1
    assert counts == CONFIG_COUNTS


# (units, d, S, threads, staged, K8's route): every lane count and weight
# home the rule reaches, as the card tests name them
RULE_CASES = [
    ((40, 40, 40, 40), 16, 4, 704, True, True),   # run A (K7) and K8's 4x40: 220 288 B
    ((30, 30, 30, 30), 16, 4, 544, True, True),   # run E's 4x30 r = 15 dense view
    ((8, 12, 5), 16, 8, 352, True, True),
    ((17,) * 8, 128, 2, 544, True, True),
    ((128,) * 8, 128, 1, 1024, False, False),     # the largest K7 stack: dx on layer 0's groups
    ((100,) * 4, 16, 2, 832, False, False),
    ((128, 30), 128, 2, 576, False, False),
    ((128,), 128, 4, 1024, False, False),
    ((110,), 18, 8, 1024, False, False),
    ((42, 42, 42, 42), 16, 4, 736, False, True),  # K8's route, the global copy
    ((48, 48), 128, 4, 896, False, True),         # K8's route, the global copy, d = 128
    ((34,) * 6, 16, 4, 896, False, True),         # K8's route, the global copy, 6 layers
    ((32,) * 5, 128, 2, 576, False, True),        # K8's route, the global copy, S = 2
]


@pytest.mark.parametrize("units,d,lanes,threads,staged,compact", RULE_CASES)
def test_rule_at_the_repo_shapes(units, d, lanes, threads, staged, compact):
    assert ct.narrow_bwd_lanes(units, d) == lanes
    assert ct.narrow_bwd_threads(units, d, lanes) == threads
    assert ct.narrow_bwd_staged(units, d) == staged
    assert ct.narrow_bwd_fits(units, d, lanes, staged)
    assert (max(units) <= ct.COMPACT_MAX_UNITS and ct.compact_fits(units, d)) == compact
    if units == (40,) * 4:
        assert ct.narrow_bwd_smem_bytes(units, d, True) == 220_288


def _staged(layers, d):
    """The weights as the kernel stages them: per layer the rows of [W; U]
    at the odd stride n | 1 of float4 entries (four gates), entry (k, j) =
    [W; U][k, g·n + j]; the padding entries hold NaN, so a read of one
    shows. Returns the entries (E, 4), each layer's first entry and
    stride."""
    blocks, bases, strides, off = [], [], [], 0
    for W, U, _ in layers:
        din, n = W.shape[0], U.shape[0]
        ns = n | 1
        P = np.full((din + n, ns, 4), np.nan)
        P[:, :n] = np.concatenate([W.reshape(din, 4, n), U.reshape(n, 4, n)]).transpose(0, 2, 1)
        blocks.append(P.reshape(-1, 4))
        bases.append(off)
        strides.append(ns)
        off += (din + n) * ns
    return np.concatenate(blocks), bases, strides


def _global(layers):
    """The wrappers' copies (``pack_gates``, stride n), one after another
    with a NaN entry between them: a read past a layer's copy shows."""
    blocks, bases, strides, off = [], [], [], 0
    for W, U, _ in layers:
        P = ct.pack_gates(torch.from_numpy(W), torch.from_numpy(U)).numpy().reshape(-1, 4)
        blocks += [P, np.full((1, 4), np.nan)]
        bases.append(off)
        strides.append(U.shape[0])
        off += len(P) + 1
    return np.concatenate(blocks), bases, strides


@pytest.mark.parametrize("din,n", [(16, 40), (40, 40), (128, 30), (3, 1), (7, 6)])
def test_staged_layout_inverts_to_keras(din, n):
    rng = np.random.default_rng(din * 1000 + n)
    W, U = rng.normal(size=(din, 4 * n)), rng.normal(size=(n, 4 * n))
    flat, bases, strides = _staged([(W, U, None)], din)
    ns = strides[0]
    assert ns == n | 1 and ns % 2 == 1 and bases == [0]
    P = flat.reshape(din + n, ns, 4)
    assert np.isnan(P[:, n:]).all() and not np.isnan(P[:, :n]).any()
    assert np.array_equal(P[:din, :n].transpose(0, 2, 1).reshape(din, 4 * n), W)
    assert np.array_equal(P[din:, :n].transpose(0, 2, 1).reshape(n, 4 * n), U)
    # 8 neighbouring units at one m, a row apart, hit distinct banks
    banks = {(4 * (u * ns) + w) % 32 for u in range(8) for w in range(4)}
    assert len(banks) == 32


# ---------------------------------------------------------------------------
# the kernel, step by step
# ---------------------------------------------------------------------------

def _sigm(v):
    return 1.0 / (1.0 + np.exp(-v))


def _gate_bwd(z, c_prev, c_t, dh, dc):
    """csrc gate_bwd: dz (4, ...) and dc_prev."""
    i, f, g, o = _sigm(z[0]), _sigm(z[1]), np.tanh(z[2]), _sigm(z[3])
    tc = np.tanh(c_t)
    dct = dc + dh * o * (1.0 - tc * tc)
    dz = np.stack([dct * g * i * (1 - i), dct * c_prev * f * (1 - f), dct * i * (1 - g * g),
                   dh * tc * o * (1 - o)])
    return dz, dct * f


def _first_row(S, l):
    """csrc fwd_first_row."""
    return 0 if S == 1 else 2 * l if S == 2 else l if S == 4 else (l >> 1) & 3


def _split_half(v, half, bit):
    """csrc split_half over a group's lanes v (S, N, ...): the partner is
    lane l ^ (1 << bit)."""
    out = v.copy()
    for l in range(len(v)):
        upper = (l >> bit) & 1
        partner = l ^ (1 << bit)
        send = v[partner, half : 2 * half] if upper else v[partner, :half]
        keep = v[l, half : 2 * half] if upper else v[l, :half]
        out[l, :half] = keep + send
    return out


def _reduce_lanes(v):
    """csrc reduce_lanes over the lanes' partial sums v (S, N, ...)."""
    S, N = v.shape[:2]
    if S == 2:
        v = _split_half(v, N // 2, 0)
    elif S == 4:
        v = _split_half(_split_half(v, N // 2, 1), N // 4, 0)
    elif S == 8:
        v = _split_half(_split_half(v, N // 2, 2), N // 4, 1)
        v[:, : N // 4] = v[:, : N // 4] + v[[l ^ 1 for l in range(S)], : N // 4]
    return v


def _roles(units, d, S, threads):
    """Each group's roles, as the kernel derives them from its index g."""
    nsum, groups = sum(units), threads // S
    roles = []
    for g in range(groups):
        r = dict(li=-1, j=0, u_off=0, u_up=0, h_off=0)
        u, so = 0, d
        for i, n in enumerate(units):
            if r["li"] >= 0 and i == r["li"] + 1:
                r["u_up"] = u
            if r["li"] < 0 and g < u + n:
                r.update(li=i, j=g - u, u_off=u, h_off=so)
            u += n
            so += n
        kx = g - nsum if g >= nsum else g + groups - nsum
        r["kx"] = kx if kx < d else -1
        roles.append(r)
    # every unit and every dx unit is owned by exactly one group
    assert sorted((r["li"], r["j"]) for r in roles if r["li"] >= 0) == \
        [(i, j) for i, n in enumerate(units) for j in range(n)]
    assert sorted(r["kx"] for r in roles if r["kx"] >= 0) == list(range(d))
    return roles


def _emulate(layers, x, hs, cs, dhl, S, staged):
    """The kernel's schedule and indexing in float64 numpy, every CTA at
    once (the last axis). Returns dx (T, B, d) and every layer's dz."""
    T, B, d = x.shape
    units = [U.shape[0] for _, U, _ in layers]
    L, nsum, V = len(units), sum(units), d + sum(units)
    threads = ct.narrow_bwd_threads(units, d, S)
    assert ct.narrow_bwd_fits(units, d, S, staged)
    nC = -(-B // R)

    def rows(a):  # (T, B, k) -> (T, k, R, nC), the rows >= B zero (the kernel's masks)
        p = np.zeros((a.shape[0], nC * R, a.shape[2]))
        p[:, :B] = a
        return p.reshape(a.shape[0], nC, R, a.shape[2]).transpose(0, 3, 2, 1)

    xr, hr, cr, dr = rows(x), [rows(h) for h in hs], [rows(c) for c in cs], rows(dhl)
    flat, bases, strides = _staged(layers, d) if staged else _global(layers)
    roles = _roles(units, d, S, threads)
    state = np.full((2, V, R, nC), np.nan)  # written before it is read
    dzs = np.zeros((2, R, nsum, 4, nC))
    dx = np.full((T, d, R, nC), np.nan)
    dz_out = [np.full((T, 4, n, R, nC), np.nan) for n in units]

    def at(a, tt):  # a[tt], zero outside [0, T)
        return a[tt] if 0 <= tt < T else np.zeros(a.shape[1:])

    def load_state(s):  # the state vector of step s + 1
        v = np.zeros((V, R, nC))
        v[:d] = at(xr, T + L - 3 - s)
        so = d
        for i, n in enumerate(units):
            v[so : so + n] = at(hr[i], T + L - 4 - s - i)
            so += n
        return v

    def store_state(s, v):
        state[s & 1] = v

    def w(i, row, m):  # entries (row, m) of layer i: (len(m), 4)
        return flat[bases[i] + row * strides[i] + m]

    z = lambda: np.zeros((R, nC))  # noqa: E731
    carry = {g: dict(dc=z(), ct=z(), cp=z(), dht=z()) for g, r in enumerate(roles) if r["li"] >= 0}
    for g, c in carry.items():
        li, j = roles[g]["li"], roles[g]["j"]
        tb = T + L - 2 - li
        c["ct"], c["cp"] = at(cr[li], tb)[j], at(cr[li], tb - 1)[j]
        c["dht"] = at(dr, T - 1)[j] if li == L - 1 else z()
    store_state(-1, load_state(-1))
    steps = T + L
    for s in range(steps):
        P, Q = (s + 1) & 1, s & 1
        nxt = load_state(s) if s + 1 < steps else None
        for g, r in enumerate(roles):
            li, j = r["li"], r["j"]
            if li >= 0:
                c = carry[g]
                n, din = units[li], layers[li][0].shape[0]
                n_up = units[li + 1] if li < L - 1 else 0
                tb = T + L - 2 - li
                c["cn"] = at(cr[li], tb - s - 2)[j]
                c["dhn"] = at(dr, T - 2 - s)[j] if li == L - 1 else z()
                t = tb - s
                if 0 <= t < T:
                    v, u = np.zeros((S, 16, nC)), np.zeros((S, 4, nC))
                    for l in range(S):
                        ks = l + S * np.arange((din + n - l + S - 1) // S)
                        hv = state[P, r["h_off"] - din + ks]           # (K, R, nC)
                        wz = flat[bases[li] + ks * strides[li] + j]    # (K, 4)
                        v[l] = np.einsum("krc,kg->rgc", hv, wz).reshape(16, nC)
                        ms = l + S * np.arange((n - l + S - 1) // S)
                        u[l] = np.einsum("rmgc,mg->rc", dzs[P][:, r["u_off"] + ms], w(li, din + j, ms))
                        lb = ((l - n) % S + S) % S
                        ms = lb + S * np.arange(max(0, (n_up - lb + S - 1) // S))
                        if len(ms):
                            u[l] += np.einsum("rmgc,mg->rc", dzs[P][:, r["u_up"] + ms],
                                              w(li + 1, j, ms))
                    v, u = _reduce_lanes(v), _reduce_lanes(u)
                    b = layers[li][2][[j, n + j, 2 * n + j, 3 * n + j]]
                    for l in range(S):
                        if S == 8 and l & 1:
                            continue
                        for q in range(4 // S if S < 4 else 1):
                            row = _first_row(S, l) + q
                            zz = v[l, q * 4 : q * 4 + 4] + b[:, None]
                            gz, c["dc"][row] = _gate_bwd(zz, c["cp"][row], c["ct"][row],
                                                         u[l, q] + c["dht"][row], c["dc"][row])
                            dz_out[li][t, :, j, row] = gz
                            dzs[Q, row, r["u_off"] + j] = gz
            tx = T + L - 1 - s
            if r["kx"] >= 0 and tx < T:
                n0 = units[0]
                u = np.zeros((S, 4, nC))
                for l in range(S):
                    ms = l + S * np.arange((n0 - l + S - 1) // S)
                    u[l] = np.einsum("rmgc,mg->rc", dzs[P][:, ms], w(0, r["kx"], ms))
                u = _reduce_lanes(u)
                for l in range(S):
                    if S == 8 and l & 1:
                        continue
                    for q in range(4 // S if S < 4 else 1):
                        dx[tx, r["kx"], _first_row(S, l) + q] = u[l, q]
        if nxt is not None:
            store_state(s, nxt)
        for c in carry.values():
            c["ct"], c["cp"], c["dht"] = c["cp"], c["cn"], c["dhn"]

    def back(a):  # (T, k, R, nC) -> (T, B, k)
        return a.transpose(0, 3, 2, 1).reshape(a.shape[0], nC * R, a.shape[1])[:, :B]

    return back(dx), [back(o.reshape(T, 4 * n, R, nC)) for o, n in zip(dz_out, units)]


def _case(units, d, B, T, seed):
    rng = np.random.default_rng(seed)
    layers, din = [], d
    for n in units:
        layers.append((rng.normal(scale=din ** -0.5, size=(din, 4 * n)),
                       rng.normal(scale=n ** -0.5, size=(n, 4 * n)), rng.normal(scale=0.1, size=4 * n)))
        din = n
    x = rng.normal(size=(T, B, d))
    dhl = rng.normal(size=(T, B, units[-1]))
    return layers, x, dhl


@pytest.mark.parametrize("units,d,B,T,S,staged", [
    ((5, 7, 3), 4, 8, 6, 1, False),
    ((5, 7, 3), 4, 6, 6, 2, True),
    ((6, 4, 9), 5, 9, 5, 4, True),
    ((6, 4, 9), 5, 7, 5, 8, True),
    ((6, 4, 9), 5, 7, 5, 8, False),
    ((6, 4, 9), 5, 7, 5, 4, False),
    ((5, 7), 3, 5, 4, 2, False),
    ((4, 6, 5, 3), 6, 5, 2, 4, True),   # T < L
    ((4, 6, 5, 3), 6, 3, 1, 8, True),   # T = 1
    ((9,), 3, 4, 5, 8, True),           # one layer
    ((3,) * 8, 2, 2, 3, 2, True),       # 8 layers, T < L
    ((12, 20), 100, 6, 3, 8, True),     # dx on 4 of layer 0's groups (S = 8, 1024 threads)
    ((30, 40), 100, 5, 3, 8, False),    # dx on 38 of layer 0's groups (S = 8, 1024 threads)
    ((1, 2), 9, 1, 4, 8, False),        # units narrower than S, B = 1
])
def test_emulated_kernel_matches_plain(units, d, B, T, S, staged):
    layers, x, dhl = _case(units, d, B, T, seed=sum(units) + 7 * S + T)
    tl = [tuple(torch.from_numpy(a) for a in l) for l in layers]
    xt, dt = torch.from_numpy(x), torch.from_numpy(dhl)
    hs, cs = ct.fused_narrow_train_fwd_plain(tl, xt)
    dWs, dUs, dbs, dx_p = ct.fused_narrow_train_bwd_plain(tl, xt, hs, cs, dt)
    dx, dzs = _emulate(layers, x, [h.numpy() for h in hs], [c.numpy() for c in cs], dhl, S, staged)
    tol = dict(rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(dx, dx_p.numpy(), **tol)
    inp = x
    for i, dz in enumerate(dzs):
        h = hs[i].numpy()
        h_prev = np.concatenate([np.zeros_like(h[:1]), h[:-1]])
        np.testing.assert_allclose(np.einsum("tbk,tbg->kg", inp, dz), dWs[i].numpy(), **tol)
        np.testing.assert_allclose(np.einsum("tbk,tbg->kg", h_prev, dz), dUs[i].numpy(), **tol)
        np.testing.assert_allclose(dz.sum(axis=(0, 1)), dbs[i].numpy(), **tol)
        inp = h
