"""K7f's and K8f's tensor-core kernels (svd_lstm_tpu_torch/ops/cuda_train.py
``narrow_bf16_fwd``, ``narrow_bf16_bwd``, ``narrow_bf16_plan``; ops/csrc/
narrow_bf16.cu) on the CPU, without a card.

The forward (``narrow_fwd_mma``) gives a CTA NB_ROWS = 2 batch rows and
runs the layers as a wavefront, one barrier a step. A warp owns a pair of
groups of 8 units of a layer (an item) and holds [W; U]ᵀ's four m-tiles of it
as mma.sync A fragments (of each group's first m-tile rows g and g + 8 are
gates i and f of unit g, of its second gates g and o), in registers or read
from a global copy in fragment order; the B
fragments come by ldmatrix from the bf16 state [x | h_0 | ...] (2 rows, the
8 columns of mma's n repeating them, every segment padded to 8). Each lane's
accumulators hold the four gates of unit g of both groups for both rows;
lane q updates one cell, unit g of group q >> 1 of the pair and row q & 1,
from its own registers, its c carry in a register.
The backward runs ``narrow_z`` (z of every layer over all T·B rows, a GEMM,
columns unit-interleaved), the dh chain ``narrow_bwd_mma`` (an item: an
m-tile of 16 units of [U_i | W_{i+1}], or of dx's W_0; z read and dz written
over it as one float4 a cell; the bf16 dz vector by ldmatrix), then
``narrow_wgrad`` ([dW; dU] on the tensor cores and db unrounded over all
T·B rows, split in a fixed order) and the ordered sum of the splits.

* A float64 numpy emulation of those launches, run behind the wrappers' own
  ``_launch`` on their own memory: the launchers' layout and checks, the
  fragments by the kernels' lane maps (and their homes: the global copy
  written into the wrapper's buffer) decoded by mma.sync m16n8k16's own
  layout (PTX ISA), ldmatrix's rows and lanes, the accumulators summed in
  float32 a k-tile at a time, the items of a step in a shuffled order
  between barriers, the shared vectors NaN until the kernel writes them,
  every global store bounds-checked. It is held against
  ``fused_narrow_train_fwd_plain(..., True)`` and
  ``fused_narrow_train_bwd_plain(..., True)`` within ``chip_smoke.py``'s
  ``fast_limit`` (2 bf16 ulps of the plain output's largest value, or twice
  the plain float32 version's distance from the same arithmetic in float64)
  at 4×40 (run A), 4×30, 2×15 with d = 15, 4×20, 8 layers, one layer, ragged
  B, B = 1, T = 1 and T < L, each weight home, K8f's route.
* The mutations "barrier" (an item reads the parity the step writes),
  "rounding" (the state or dz read as float32, not as its bf16 copy),
  "fragment" (a lane map with the k and row halves swapped), "mask" (rows
  past B stored) and "carry" (c, or dc, not carried) each make it fail.
* The plan: the repo's stacks take the registers; every stack the route
  admits gets a plan its launcher accepts, within a block's shared memory.
* One case against the JAX package's ``_fused_fwd`` / ``_fused_bwd`` in
  interpret mode, within the narrow fast band 3e-2 (relative Frobenius): on
  the CPU JAX's DEFAULT dot is exact float32.

The kernels themselves run only on the card
(tests/test_torch_train_kernels.py: ``test_cuda_fused_narrow_fast_matches_plain``).
"""

import ctypes

import numpy as np
import pytest
import torch

from svd_lstm_tpu_torch.ops import cuda_train as ct
from svd_lstm_tpu_torch.ops.cuda_lstm import _SMEM_LIMIT
from test_torch_wide_bwd_bf16 import _bf16_bits, _view, rn
from test_torch_wide_fwd_bf16 import fast_limit

RF = RB = ct.NB_ROWS  # batch rows a CTA (the forward's, the backward chain's)
SMS = 132  # the H100 SXM's SM count
FAST_BAND = 3e-2  # rel. Frobenius, the narrow fast band (chip_smoke.py FAST_BAND)
LANE = np.arange(32)
G_, Q_ = LANE >> 2, LANE & 3  # a lane's group and thread in the group (mma's g, q)


def seg8(v):
    return -(-v // 8) * 8


def row_stride(total):
    return (total + 16 - 8 + 63) // 64 * 64 + 8


def f32(a):
    return np.asarray(a, np.float64).astype(np.float32).astype(np.float64)


# ---------------------------------------------------------------------------
# mma.sync m16n8k16 and ldmatrix as the PTX ISA defines them
# ---------------------------------------------------------------------------

def a_from_regs(regs):
    """A (16, 16) from the lanes' A fragments (32, 4 registers, 2 halves):
    register i of lane (g, q) holds row g + 8·(i % 2), columns 2q + 8·(i //
    2) and the next."""
    A = np.full((16, 16), np.nan)
    for i in range(4):
        for h in range(2):
            A[G_ + 8 * (i % 2), 2 * Q_ + 8 * (i // 2) + h] = regs[:, i, h]
    return A


def b_from_regs(regs):
    """B (16 k, 8 n) from the lanes' B fragments (32, 2, 2): register j of
    lane (g, q) holds k = 2q + 8j and the next, column g."""
    Bm = np.full((16, 8), np.nan)
    for j in range(2):
        for h in range(2):
            Bm[2 * Q_ + 8 * j + h, G_] = regs[:, j, h]
    return Bm


def d_cells(D):
    """The lanes' accumulators (32, 4) of D (16, 8): c0, c1 at row g,
    columns 2q and 2q + 1; c2, c3 at row g + 8."""
    return np.stack([D[G_, 2 * Q_], D[G_, 2 * Q_ + 1], D[G_ + 8, 2 * Q_], D[G_ + 8, 2 * Q_ + 1]], 1)


def ldmatrix_x2(mem, rows, cols):
    """Two 8 x 8 matrices: matrix j's row i is the 8 values at lane 8j + i's
    address (rows[l], cols[l] into the 2-D ``mem``); lane (g, q) receives
    matrix j's row g, columns 2q and 2q + 1, in register j. (32, 2, 2)."""
    M = np.stack([np.stack([mem[rows[8 * j + i], cols[8 * j + i] : cols[8 * j + i] + 8]
                            for i in range(8)]) for j in range(2)])
    return np.stack([M[:, G_, 2 * Q_], M[:, G_, 2 * Q_ + 1]], -1).transpose(1, 0, 2)


def chains(A_kts, B_kts, count):
    """The products summed over k-tiles in ``count`` interleaved chains
    (k-tile kt into chain kt % count), each k-tile's 16 products summed and
    rounded to float32 and added to its chain in float32: the chains' D (16,
    8) each."""
    acc = [np.zeros((16, 8)) for _ in range(count)]
    for kt, (A, Bm) in enumerate(zip(A_kts, B_kts)):
        acc[kt % count] = f32(acc[kt % count] + f32(A @ Bm))
    return acc


def sigm(v):
    return f32(1.0 / (1.0 + np.exp(-v)))


def gate_fwd(zi, zf, zg, zo, c):
    i, f, g, o = sigm(zi), sigm(zf), f32(np.tanh(zg)), sigm(zo)
    cn = f32(f * c + i * g)
    return f32(o * np.tanh(cn)), cn


def gate_bwd(z, c_prev, c_t, dh, dc):
    i, f, g, o = sigm(z[..., 0]), sigm(z[..., 1]), f32(np.tanh(z[..., 2])), sigm(z[..., 3])
    tc = f32(np.tanh(c_t))
    dct = f32(dc + dh * o * (1 - tc * tc))
    dz = np.stack([dct * g * i * (1 - i), dct * c_prev * f * (1 - f), dct * i * (1 - g * g),
                   dh * tc * o * (1 - o)], -1)
    return f32(dz), f32(dct * f)


# ---------------------------------------------------------------------------
# the emulated launchers
# ---------------------------------------------------------------------------

class StoreOutOfBounds(IndexError):
    """A store past the buffer it belongs to."""


def _flat(ptr, count):
    return _view(ptr, count, ctypes.c_float)


def _mat(ptr, rows, cols):
    return _flat(ptr, rows * cols).reshape(rows, cols).astype(np.float64)


def lane_map(kt, mutation):
    """The kernels' A fragment map (fwd_frag, bwd_frag): register i of lane
    (g, q) at row g + 8·(i & 1), k = 16kt + 2q + 8·(i >> 1); "fragment" swaps
    the row and k halves."""
    i = np.arange(4)
    rb, kb = (i >> 1, i & 1) if mutation == "fragment" else (i & 1, i >> 1)
    rho = G_[:, None] + 8 * rb[None, :]
    k = 16 * kt + 2 * Q_[:, None] + 8 * kb[None, :]
    return rho, k


def make_frags(elem, KT, mutation):
    """A fragments (KT, 32, 4, 2) of one m-tile: elem(rho, k) rounded."""
    out = np.empty((KT, 32, 4, 2))
    for kt in range(KT):
        rho, k = lane_map(kt, mutation)
        out[kt, ..., 0], out[kt, ..., 1] = elem(rho, k), elem(rho, k + 1)
    return out


class FragmentHome:
    """Where a launch's fragments live (csrc: home 0, 1): the global copy
    (home 1) is written as bf16 pairs into the wrapper's buffer of
    frags·512 bytes and read back from it; registers hold them as made."""

    def __init__(self, home, frags, packed_ptr):
        self.home, self.store = home, {}
        self.bits = _view(packed_ptr, frags * 256, ctypes.c_uint16).reshape(frags, 32, 4, 2) \
            if home == 1 else None

    def put(self, f, frag):
        if self.home == 1:
            self.bits[f] = _bf16_bits(frag)
        else:
            self.store[f] = frag

    def get(self, f):
        if self.home == 1:
            return (self.bits[f].astype(np.uint32) << 16).view(np.float32).astype(np.float64)
        return self.store[f]


def emulate_fwd(args, rng, mutation=None):
    """csrc narrow_bf16_fwd_launch and narrow_fwd_mma on the wrapper's
    memory."""
    meta_ptr, L, x_ptr, T, B, d, warps, home, packed_ptr = args
    meta = _view(meta_ptr, 7 * L, ctypes.c_int64).reshape(L, 7)
    x = _mat(x_ptr, T * B, d).reshape(T, B, d)
    lys, din, kin, items, frags, ktmax = [], d, 0, 0, 0, 0
    for i in range(L):
        di, n, Wp, Up, bp, hp, cp = (int(v) for v in meta[i])
        assert di == din and 1 <= n <= 128
        ly = dict(din=di, n=n, W=_mat(Wp, di, 4 * n), U=_mat(Up, n, 4 * n), b=_mat(bp, 1, 4 * n)[0],
                  h=_flat(hp, T * B * n), c=_flat(cp, T * B * n),
                  kin=kin, kseg=seg8(di), hoff=kin + seg8(di), KT=-(-(seg8(di) + seg8(n)) // 16),
                  pairs=-(-n // 16), item0=items, frag0=frags)
        ly["h"][:], ly["c"][:] = np.nan, np.nan  # NaN until the kernel writes them
        lys.append(ly)
        items += ly["pairs"]
        frags += ly["pairs"] * 4 * ly["KT"]
        ktmax = max(ktmax, ly["KT"])
        kin, din = ly["hoff"], n
    SV = row_stride(kin + seg8(din))
    threads = 32 * warps
    smem = 2 * RF * SV * 2
    # the launcher's checks: the wrapper's plan must pass them
    assert 1 <= warps and threads <= (384 if home == 0 else 1024) and 4 * threads >= RF * d
    assert smem <= _SMEM_LIMIT and (home != 1 or packed_ptr)
    assert items <= warps and ktmax <= 6 if home == 0 else items <= warps * ct.NBF_IPW

    def elem(ly, ug, m, rho, k):
        n, u, gate = ly["n"], ug * 8 + (rho & 7), 2 * m + (rho >> 3)
        col = np.minimum(gate * n + u, 4 * n - 1)
        v = np.where(k < ly["kseg"], ly["W"][np.minimum(k, ly["din"] - 1), col] * (k < ly["din"]),
                     ly["U"][np.clip(k - ly["kseg"], 0, n - 1), col] * (k - ly["kseg"] < n))
        return rn(v * (u < n))

    fh = FragmentHome(home, frags, packed_ptr)
    for ly in lys:  # fragment order [layer][pair][m-tile mm][k-tile]: group 2·pair + mm // 2, its m-tile mm % 2
        for pr in range(ly["pairs"]):
            for mm in range(4):
                fr = make_frags(lambda rho, k: elem(ly, 2 * pr + mm // 2, mm % 2, rho, k), ly["KT"], mutation)
                for kt in range(ly["KT"]):
                    fh.put(ly["frag0"] + (pr * 4 + mm) * ly["KT"] + kt, fr[kt])
    item_of = []  # (layer, pair) of every item in order
    for li, ly in enumerate(lys):
        item_of += [(li, pr) for pr in range(ly["pairs"])]
    owned = [it for w in range(warps) for it in range(w, items, warps)]
    for cta in rng.permutation(-(-B // RF)):
        row0 = cta * RF
        st = np.full((2, RF, SV), np.nan)
        st[:] = 0.0
        for r in range(RF):
            if row0 + r < B:
                st[1, r, :d] = rn(x[0, row0 + r])
        cc = {it: np.zeros(32) for it in owned}
        for s in range(T + L - 1):
            P, Q = (s + 1) & 1, s & 1
            src = Q if mutation == "barrier" else P
            for it in rng.permutation(owned):
                li, pr = item_of[it]
                ly, t = lys[li], s - li
                if not 0 <= t < T:
                    continue
                n, KT = ly["n"], ly["KT"]
                acc = []
                for mm in range(4):
                    A_kts, B_kts = [], []
                    for kt in range(KT):
                        A_kts.append(a_from_regs(fh.get(ly["frag0"] + (pr * 4 + mm) * KT + kt)))
                        cols = ly["kin"] + ((LANE >> 3) & 1) * 8 + kt * 16
                        B_kts.append(b_from_regs(ldmatrix_x2(st[src], LANE & 1, cols)))
                    even, odd = chains(A_kts, B_kts, 2)  # narrow_fwd_mma's two chains a m-tile
                    acc.append(d_cells(f32(even + odd)))
                # one cell a lane, from its own accumulators (the columns repeat
                # rows 0, 1): group q >> 1 of the pair, row q & 1
                grp, r = Q_ >> 1, Q_ & 1
                u = (2 * pr + grp) * 8 + G_
                ok_u = u < n
                bias = [np.where(ok_u, ly["b"][np.minimum(gt * n + u, 4 * n - 1)], 0.0) for gt in range(4)]
                z = [f32(np.stack([acc[mm][LANE, 2 * (gt % 2) + r] for mm in range(4)])[2 * grp + gt // 2, LANE]
                         + bias[gt]) for gt in range(4)]
                c_prev = np.zeros(32) if mutation == "carry" else cc[it]
                hn, cn = gate_fwd(*z, c_prev)
                cc[it] = cn
                st[Q, r[ok_u], ly["hoff"] + u[ok_u]] = hn[ok_u] if mutation == "rounding" else rn(hn[ok_u])
                store = ok_u & ((row0 + r < B) | (mutation == "mask"))
                mrow = t * B + row0 + r[store]
                ly["h"][mrow * n + u[store]] = hn[store]
                ly["c"][mrow * n + u[store]] = cn[store]
            if s + 1 < T:
                for r in range(RF):
                    st[Q, r, :d] = rn(x[s + 1, row0 + r]) if row0 + r < B else 0.0


def emulate_z(lys, T, B, zdz):
    """narrow_z: each 64 x 64 tile of every layer's z, its rows' [x | h(t-1)]
    and the columns of [W; U] (unit-interleaved) staged rounded, summed in
    float32 a k-tile at a time, the bias added."""
    M = T * B
    for ly in lys:
        din, n = ly["din"], ly["n"]
        G, K = 4 * n, din + n
        KP = -(-K // 16) * 16
        inp = np.concatenate([ly["inp"], np.vstack([np.zeros((B, n)), ly["hm"][: M - B]])], 1)
        cols = np.arange(G)
        src = (cols & 3) * n + (cols >> 2)
        Wc = np.vstack([ly["W"], ly["U"]])[:, src]  # (K, G) unit-interleaved
        for g0 in range(0, G, 64):
            for m0 in range(0, M, 64):
                As = np.zeros((64, KP))
                m_ok = min(64, M - m0)
                As[:m_ok, :K] = rn(inp[m0 : m0 + m_ok])
                Bs = np.zeros((64, KP))
                g_ok = min(64, G - g0)
                Bs[:g_ok, :K] = rn(Wc[:, g0 : g0 + g_ok].T)
                acc = np.zeros((64, 64))
                for kt in range(KP // 16):
                    acc = f32(acc + f32(As[:, 16 * kt : 16 * kt + 16] @ Bs[:, 16 * kt : 16 * kt + 16].T))
                out = f32(acc[:m_ok, :g_ok] + ly["b"][src[g0 : g0 + g_ok]])
                idx = (m0 + np.arange(m_ok))[:, None] * G + (g0 + np.arange(g_ok))[None, :]
                zdz[ly["zoff"] + idx] = out


def emulate_wgrad(lys, T, B, zdz, out, splits):
    """narrow_wgrad: each 64 x 64 tile of every layer's [dW; dU] over each
    split of the rows, 32 rows staged at a time (rounded), the columns back
    in gate-major order; db per column in float32 over the rows of each
    residue mod 4 in order, then the four in order; the splits added in
    order."""
    M = T * B
    chunk = -(-(-(-M // splits)) // 32) * 32
    parts = []
    for sp in range(splits):
        mb, me = sp * chunk, min(M, sp * chunk + chunk)
        part = np.zeros(sum((ly["din"] + ly["n"] + 1) * 4 * ly["n"] for ly in lys))
        for ly in lys:
            din, n = ly["din"], ly["n"]
            G, Pr = 4 * n, din + n
            a = np.concatenate([ly["inp"], np.vstack([np.zeros((B, n)), ly["hm"][: M - B]])], 1)
            dz = zdz[ly["zoff"] : ly["zoff"] + M * G].reshape(M, G)
            gm = (np.arange(G) & 3) * n + (np.arange(G) >> 2)  # gate-major column of each
            acc = np.zeros((Pr, G))
            dbv = np.zeros((4, G))
            for mc in range(mb, me, 32):
                rows = np.arange(mc, min(mc + 32, me))
                acc = f32(acc + f32(rn(a[rows[: 16]]).T @ rn(dz[rows[: 16]])))
                if len(rows) > 16:
                    acc = f32(acc + f32(rn(a[rows[16:]]).T @ rn(dz[rows[16:]])))
                for m in rows:
                    dbv[(m - mc) % 4] = f32(dbv[(m - mc) % 4] + dz[m])
            blk = np.zeros((Pr + 1, G))
            blk[:Pr, gm] = acc
            blk[Pr, gm] = f32(f32(f32(dbv[0] + dbv[1]) + dbv[2]) + dbv[3])
            part[ly["goff"] : ly["goff"] + (Pr + 1) * G] = blk.ravel()
        parts.append(part)
    total = parts[0]
    for p in parts[1:]:
        total = f32(total + p)
    out[:] = total


def emulate_bwd(args, rng, mutation=None):
    """csrc narrow_bf16_bwd_launch (narrow_z, narrow_bwd_mma, narrow_wgrad,
    the ordered sum of the splits) on the wrapper's memory."""
    (meta_ptr, L, x_ptr, dhl_ptr, dx_ptr, grads_ptr, partial_ptr, zdz_ptr, T, B, d, warps, home,
     splits, packed_ptr) = args
    assert splits == 1 or partial_ptr
    meta = _view(meta_ptr, 7 * L, ctypes.c_int64).reshape(L, 7)
    M = T * B
    lys, din, zo, go = [], d, 0, 0
    x = _mat(x_ptr, M, d)
    for i in range(L):
        di, n, Wp, Up, bp, hp, cp = (int(v) for v in meta[i])
        assert di == din and 1 <= n <= 128
        ly = dict(din=di, n=n, W=_mat(Wp, di, 4 * n), U=_mat(Up, n, 4 * n), b=_mat(bp, 1, 4 * n)[0],
                  hm=_mat(hp, M, n), c=_mat(cp, M, n), zoff=zo, goff=go)
        ly["inp"] = x if i == 0 else lys[-1]["hm"]
        lys.append(ly)
        zo += M * 4 * n
        go += (di + n + 1) * 4 * n
        din = n
    zdz = _flat(zdz_ptr, zo)
    zdz[:] = np.nan
    dx = _flat(dx_ptr, M * d)
    dx[:] = np.nan
    dhl = _mat(dhl_ptr, M, lys[-1]["n"])
    emulate_z(lys, T, B, zdz)
    # the chain's entries: the layers' [U_i | W_{i+1}], then dx's W_0
    ents, koff, items, frags, ktmax = [], 0, 0, 0, 0
    for i, ly in enumerate(lys):
        up = lys[i + 1] if i + 1 < L else None
        e = dict(rows=ly["n"], n1=ly["n"], A1=ly["U"], n2=up["n"] if up else 0, A2=up["W"] if up else None,
                 seg1=seg8(4 * ly["n"]), koff=koff, ly=ly)
        e["KT"] = -(-(e["seg1"] + (seg8(4 * e["n2"]) if up else 0)) // 16)
        ents.append(e)
        koff += e["seg1"]
    ents.append(dict(rows=d, n1=lys[0]["n"], A1=lys[0]["W"], n2=0, A2=None, seg1=seg8(4 * lys[0]["n"]),
                     koff=0, ly=None))
    ents[-1]["KT"] = -(-ents[-1]["seg1"] // 16)
    for e in ents:
        e["mts"], e["item0"], e["frag0"] = -(-e["rows"] // 16), items, frags
        items += e["mts"]
        frags += e["mts"] * e["KT"]
        ktmax = max(ktmax, e["KT"])
    SZ = row_stride(koff)
    threads = 32 * warps
    smem = 2 * RB * SZ * 2
    assert 1 <= warps and threads <= (416 if home == 0 else 512) and smem <= _SMEM_LIMIT
    assert home != 1 or packed_ptr
    assert items <= warps and ktmax <= 20 if home == 0 else items <= warps * ct.NBB_IPW

    def elem(e, mt, rho, k):
        u = mt * 16 + rho
        ok = u < e["rows"]
        uu = np.minimum(u, e["rows"] - 1)
        j1 = np.minimum(k >> 2, e["n1"] - 1)
        v1 = e["A1"][uu, (k & 3) * e["n1"] + j1] * ((k >> 2) < e["n1"])
        v = v1
        if e["A2"] is not None:
            kk = np.maximum(k - e["seg1"], 0)
            j2 = np.minimum(kk >> 2, e["n2"] - 1)
            v2 = e["A2"][uu, (kk & 3) * e["n2"] + j2] * ((kk >> 2) < e["n2"])
            v = np.where(k < e["seg1"], v1, v2)
        else:
            v = np.where(k < e["seg1"], v1, 0.0)
        return rn(v * ok)

    fh = FragmentHome(home, frags, packed_ptr)
    for e in ents:
        for mt in range(e["mts"]):
            fr = make_frags(lambda rho, k: elem(e, mt, rho, k), e["KT"], mutation)
            for kt in range(e["KT"]):
                fh.put(e["frag0"] + mt * e["KT"] + kt, fr[kt])
    item_of = [(ei, mt) for ei, e in enumerate(ents) for mt in range(e["mts"])]
    owned = [it for w in range(warps) for it in range(w, items, warps)]
    for cta in rng.permutation(-(-B // RB)):
        row0 = cta * RB
        dzs = np.full((2, RB, SZ), np.nan)
        dzs[:] = 0.0
        carry = {}
        for it in owned:
            ei, mt = item_of[it]
            e = ents[ei]
            ct_ = np.zeros(32)
            if ei < L:
                t = T + L - 2 - ei
                u, row = mt * 16 + G_ + 8 * (Q_ >> 1), row0 + (Q_ & 1)
                ok = (t < T) & (u < e["rows"]) & (row < B)
                ct_[ok] = e["ly"]["c"][t * B + row[ok], u[ok]]
            carry[it] = [ct_, np.zeros(32)]
        for s in range(T + L):
            P, Q = (s + 1) & 1, s & 1
            src = Q if mutation == "barrier" else P
            for it in rng.permutation(owned):
                ei, mt = item_of[it]
                e = ents[ei]
                dxe, top = ei == L, ei == L - 1
                t = T + L - 1 - s if dxe else T + L - 2 - ei - s
                active = 0 <= t < T
                n = e["rows"]
                # one cell a lane: unit g + 8·(q >> 1), row q & 1 (lane q takes
                # accumulator q of its quad's lane q = 0, the shuffle)
                u = mt * 16 + G_ + 8 * (Q_ >> 1)
                r = Q_ & 1
                row = row0 + r
                zq, cp, dhv = np.zeros((32, 4)), np.zeros(32), np.zeros(32)
                if not dxe:
                    ok = (u < n) & (row < B)
                    if 1 <= t <= T:
                        cp[ok] = e["ly"]["c"][(t - 1) * B + row[ok], u[ok]]
                    if active:
                        base = e["ly"]["zoff"] + (t * B + row[ok]) * 4 * n + 4 * u[ok]
                        zq[ok] = zdz[base[:, None] + np.arange(4)]
                        if top:
                            dhv[ok] = dhl[t * B + row[ok], u[ok]]
                if active:
                    A_kts, B_kts = [], []
                    for kt in range(e["KT"]):
                        A_kts.append(a_from_regs(fh.get(e["frag0"] + mt * e["KT"] + kt)))
                        cols = e["koff"] + ((LANE >> 3) & 1) * 8 + kt * 16
                        B_kts.append(b_from_regs(ldmatrix_x2(dzs[src], LANE & 1, cols)))
                    parts_ = chains(A_kts, B_kts, 4)  # BWD_CHAINS chains, added in order
                    p = parts_[0]
                    for part in parts_[1:]:
                        p = f32(p + part)
                    cells = d_cells(p)  # (32, 4): unit g rows 2q, 2q+1; unit g + 8 rows 2q, 2q+1
                    dh = f32(cells[LANE, Q_] + dhv)
                    if dxe:
                        ok = (u < d) & (row < B)
                        dx[(t * B + row[ok]) * d + u[ok]] = dh[ok]
                    else:
                        dc = np.zeros(32) if mutation == "carry" else carry[it][1]
                        gz, dcn = gate_bwd(zq, cp, carry[it][0], dh, dc)
                        carry[it][1] = dcn
                        ok = u < n
                        val = gz[ok] if mutation == "rounding" else rn(gz[ok])
                        dzs[Q, r[ok][:, None], e["koff"] + 4 * u[ok][:, None] + np.arange(4)] = val
                        store = ok & ((row < B) | (mutation == "mask"))
                        base = e["ly"]["zoff"] + (t * B + row[store]) * 4 * n + 4 * u[store]
                        if np.any(base >= e["ly"]["zoff"] + M * 4 * n):
                            raise StoreOutOfBounds(f"dz of layer {ei} past its buffer")
                        zdz[base[:, None] + np.arange(4)] = gz[store]
                if not dxe:
                    carry[it][0] = cp
    out = _flat(grads_ptr, go)
    emulate_wgrad(lys, T, B, zdz, out, splits)


def _launcher(rng, mutation=None):
    names = []

    def launch(name, device, *args):
        names.append(name)
        if name == "narrow_bf16_fwd":
            emulate_fwd(args, rng, mutation)
        elif name == "narrow_bf16_bwd":
            emulate_bwd(args, rng, mutation)
        else:
            raise AssertionError(f"unexpected launch {name}")

    return launch, names


def run_emulated(layers, x, dh, monkeypatch, compact=False, mutation=None, seed=0):
    """K7f's (K8f's with ``compact``) forward and backward through the
    wrappers on CPU float32 tensors, the card's route taken and every
    launch emulated; the backward on the plain bf16 forward's h and c.
    Returns (hs, cs, (dWs, dUs, dbs, dx), the launches' names)."""
    fwd = ct.fused_narrow_train_compact_fwd if compact else ct.fused_narrow_train_fwd
    bwd = ct.fused_narrow_train_compact_bwd if compact else ct.fused_narrow_train_bwd
    launch, names = _launcher(np.random.default_rng(seed), mutation)
    monkeypatch.setattr(ct, "_on_card", lambda *t: True)
    monkeypatch.setattr(ct, "_launch", launch)
    monkeypatch.setattr(ct, "sm_count", lambda device: SMS)
    lt = [tuple(torch.tensor(a) for a in l) for l in layers]
    xt, dht = torch.tensor(x), torch.tensor(dh)
    ct.reset_launch_counts()
    hs, cs = fwd(lt, xt, True)
    hs_p, cs_p = ct.fused_narrow_train_fwd_plain(lt, xt, True)
    grads = bwd(lt, xt, hs_p, cs_p, dht, True)
    key = "fused_narrow_train_compact" if compact else "fused_narrow_train"
    assert ct.LAUNCHES[f"{key}_fwd_fast"] == 1 and ct.LAUNCHES[f"{key}_bwd_fast"] == 1
    assert sum(ct.LAUNCHES.values()) == 2
    return hs, cs, grads, names


def _case(seed, units, d, B, T, scale=1.0):
    rng = np.random.default_rng(seed)
    f = lambda shape, s: rng.normal(scale=s, size=shape).astype(np.float32)  # noqa: E731
    layers, din = [], d
    for n in units:
        layers.append((f((din, 4 * n), scale * din ** -0.5), f((n, 4 * n), scale * n ** -0.5),
                       f((4 * n,), 0.1)))
        din = n
    return layers, f((T, B, d), 1.0), f((T, B, units[-1]), 1.0)


def _plain(layers, x, dh):
    """The plain bf16 forward and backward in float32 and in float64 (the
    backward on the float32 forward's h and c, as the emulation's)."""
    lt = [tuple(torch.tensor(a) for a in l) for l in layers]
    l64 = [tuple(torch.tensor(a, dtype=torch.float64) for a in l) for l in layers]
    xt, dht = torch.tensor(x), torch.tensor(dh)
    hs, cs = ct.fused_narrow_train_fwd_plain(lt, xt, True)
    hs64, cs64 = ct.fused_narrow_train_fwd_plain(l64, xt.double(), True)
    g = ct.fused_narrow_train_bwd_plain(lt, xt, hs, cs, dht, True)
    g64 = ct.fused_narrow_train_bwd_plain(l64, xt.double(), [h.double() for h in hs],
                                          [c.double() for c in cs], dht.double(), True)
    return (hs, cs, g), (hs64, cs64, g64)


def _errors(got, want, want64):
    """Every output's (name, max abs error, fast_limit)."""
    hs, cs, (dWs, dUs, dbs, dx) = got
    phs, pcs, (pdW, pdU, pdb, pdx) = want
    qhs, qcs, (qdW, qdU, qdb, qdx) = want64
    out = []
    for name, a, r, r64 in (("h", hs, phs, qhs), ("c", cs, pcs, qcs), ("dW", dWs, pdW, qdW),
                            ("dU", dUs, pdU, qdU), ("db", dbs, pdb, qdb), ("dx", [dx], [pdx], [qdx])):
        for i, (ai, ri, r64) in enumerate(zip(a, r, r64)):
            err = float((ai.double() - ri.double()).abs().max()) if torch.isfinite(ai).all() else np.inf
            out.append((f"{name}{i}", err, fast_limit(ri, r64)))
    return out


# (units, d, B, T, compact): run A's stack (two CTAs, the second ragged),
# 4x30 and K8f's route, the conv hybrid's 2x15 with d = 15, prune_to_width's
# 4x20 at B = 1 and T < L, T = 1, 8 layers with T < L, the fragments from
# the global copy (2x64; 128 + 30 with d = 128), one layer
EMULATION_CASES = [
    ((40, 40, 40, 40), 16, 5, 3, False),
    ((30, 30, 30, 30), 16, 8, 3, False),
    ((30, 30, 30, 30), 16, 10, 2, True),
    ((15, 15), 15, 11, 4, False),
    ((20, 20, 20, 20), 16, 1, 2, False),
    ((8, 12, 5), 16, 3, 1, False),
    ((3,) * 8, 2, 4, 3, False),
    ((64, 64), 16, 5, 3, False),
    ((128, 30), 128, 2, 2, False),
    ((24,), 16, 7, 3, False),
]


@pytest.mark.parametrize("units,d,B,T,compact", EMULATION_CASES)
def test_emulated_pair_matches_the_plain_bf16_pair(units, d, B, T, compact, monkeypatch):
    layers, x, dh = _case(sum(units) + d + B + T, units, d, B, T)
    hs, cs, grads, names = run_emulated(layers, x, dh, monkeypatch, compact)
    assert names == ["narrow_bf16_fwd", "narrow_bf16_bwd"]
    want, want64 = _plain(layers, x, dh)
    for name, err, lim in _errors((hs, cs, grads), want, want64):
        assert err <= lim, (name, err, lim)


def test_the_cases_take_every_weight_home():
    plans = [ct.narrow_bf16_plan(u, d) for u, d, *_ in EMULATION_CASES]
    assert {p.fwd_home for p in plans} == {p.bwd_home for p in plans} == set(ct.NB_HOMES)


def test_result_does_not_depend_on_the_order_of_items(monkeypatch):
    layers, x, dh = _case(3, (30, 30), 16, 5, 3)
    first = run_emulated(layers, x, dh, monkeypatch, seed=1)
    second = run_emulated(layers, x, dh, monkeypatch, seed=2)
    for a, b in zip([*first[0], *first[1], *first[2][0], *first[2][1], first[2][3]],
                    [*second[0], *second[1], *second[2][0], *second[2][1], second[2][3]]):
        assert torch.equal(a, b)


# the cases the mutations run on: "rounding" needs the products' rounding
# error above 2 bf16 ulps of the outputs, so the weights are drawn 6x the
# fan-in scale; "mask" a ragged last CTA
MUTATION_CASES = {
    "barrier": (((30, 30), 16, 8, 4), 1.0),
    "rounding": (((40, 40), 16, 8, 6), 6.0),
    "fragment": (((30, 30), 16, 8, 3), 1.0),
    "mask": (((30, 30), 16, 5, 3), 1.0),
    "carry": (((30, 30), 16, 8, 4), 1.0),
}


@pytest.mark.parametrize("mutation", sorted(MUTATION_CASES))
def test_a_mutated_schedule_fails(mutation, monkeypatch):
    (units, d, B, T), scale = MUTATION_CASES[mutation]
    layers, x, dh = _case(5, units, d, B, T, scale)
    want, want64 = _plain(layers, x, dh)
    try:
        hs, cs, grads, _ = run_emulated(layers, x, dh, monkeypatch, mutation=mutation)
    except IndexError:  # a store past its buffer (numpy's, or StoreOutOfBounds)
        assert mutation == "mask"
    else:
        errors = _errors((hs, cs, grads), want, want64)
        assert not all(err <= lim for _, err, lim in errors), errors
    hs, cs, grads, _ = run_emulated(layers, x, dh, monkeypatch)  # and unmutated it agrees
    assert all(err <= lim for _, err, lim in _errors((hs, cs, grads), want, want64))


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------

def _stacks(rng, count, max_layers, max_units):
    """Uniform stacks of every depth and width, then random uneven ones."""
    for L in range(1, max_layers + 1):
        for n in range(1, max_units + 1):
            yield [n] * L
    for _ in range(count):
        yield list(rng.integers(1, max_units + 1, size=rng.integers(1, max_layers + 1)))


def launcher_accepts(units, d, plan) -> bool:
    """csrc narrow_bf16_fwd_launch's and narrow_bf16_bwd_launch's checks of a
    plan (change both together)."""
    fl, bl = ct.narrow_bf16_fwd_layout(units, d), ct.narrow_bf16_bwd_layout(units, d)
    fh, bh = ct.NB_HOMES.index(plan.fwd_home), ct.NB_HOMES.index(plan.bwd_home)
    ft, bt = 32 * plan.fwd_warps, 32 * plan.bwd_warps
    fwd = (ft <= (384 if fh == 0 else 1024) and 4 * ft >= RF * d
           and ct.narrow_bf16_fwd_smem_bytes(units, d) <= _SMEM_LIMIT
           and (fl.items <= plan.fwd_warps and fl.ktmax <= 6 if fh == 0
                else fl.items <= plan.fwd_warps * ct.NBF_IPW))
    bwd = (bt <= (416 if bh == 0 else 512)
           and ct.narrow_bf16_bwd_smem_bytes(units, d) <= _SMEM_LIMIT
           and (bl.items <= plan.bwd_warps and bl.ktmax <= 20 if bh == 0
                else bl.items <= plan.bwd_warps * ct.NBB_IPW))
    return fwd and bwd


def test_every_stack_the_route_admits_gets_a_plan_its_launcher_accepts():
    """Every stack K7f takes (at most 8 layers, every width and the input at
    most 128), K8f's among them; the registers wherever every item has a
    warp and few k-tiles, the global copy elsewhere."""
    rng = np.random.default_rng(0)
    homes = set()
    for units in _stacks(rng, 600, ct.MAX_LAYERS, ct.NARROW_MAX):
        for d in (1, 15, 16, 57, ct.NARROW_MAX):
            plan = ct.narrow_bf16_plan(units, d)
            assert launcher_accepts(units, d, plan), (units, d, plan)
            fl, bl = ct.narrow_bf16_fwd_layout(units, d), ct.narrow_bf16_bwd_layout(units, d)
            assert (plan.fwd_home == "registers") == (fl.items <= ct.NBF_REG_WARPS and fl.ktmax <= ct.NBF_REG_KT)
            assert (plan.bwd_home == "registers") == (bl.items <= ct.NBB_REG_WARPS and bl.ktmax <= ct.NBB_REG_KT)
            homes |= {plan.fwd_home, plan.bwd_home}
    assert homes == set(ct.NB_HOMES)


# (units, d) -> (fwd warps, home, bwd warps, home)
PLAN_CASES = [
    (((40,) * 4, 16), (12, "registers", 13, "registers")),   # run A, K8f's 4x40 (E's B = 128)
    (((30,) * 4, 16), (8, "registers", 9, "registers")),     # run E's dense view, 4x30
    (((15, 15), 15), (2, "registers", 3, "registers")),      # the conv hybrid's 2x15
    (((20,) * 4, 16), (8, "registers", 9, "registers")),     # prune_to_width's 4x20
    (((64, 64), 16), (8, "global", 9, "global")),
    (((17,) * 8, 128), (16, "global", 16, "global")),
    (((128, 30), 128), (10, "global", 16, "global")),
    (((128,) * 8, 128), (32, "global", 16, "global")),
]


@pytest.mark.parametrize("stack,want", PLAN_CASES)
def test_plan_at_the_repo_shapes(stack, want):
    assert tuple(ct.narrow_bf16_plan(*stack)) == want


def test_layouts_at_run_a():
    """4x40, d = 16: 12 pairs of groups (5 groups a layer), K of 16 + 40
    then 40 + 40 (5 k-tiles; the state 176 entries), 13 m-tiles of K 160 +
    160 (20 k-tiles; dz 640)."""
    assert ct.narrow_bf16_fwd_layout([40] * 4, 16) == (12, 228, 5, 200)
    assert ct.narrow_bf16_bwd_layout([40] * 4, 16) == (13, 220, 20, 712)
    assert ct.narrow_bf16_fwd_smem_bytes([40] * 4, 16) == 1_600
    assert ct.narrow_bf16_bwd_smem_bytes([40] * 4, 16) == 5_696
    assert ct.narrow_bf16_splits([40] * 4, 16, 200 * 32, SMS) == 50
    assert ct.narrow_bf16_splits([40] * 4, 16, 200 * 128, SMS) == 64
    assert ct.narrow_bf16_splits([40] * 4, 16, 3 * 8, SMS) == 1


# ---------------------------------------------------------------------------
# against the JAX package (interpret mode)
# ---------------------------------------------------------------------------

def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_emulated_pair_against_the_jax_kernels(monkeypatch):
    """K7f through the emulated wrappers against ``_fused_fwd`` and
    ``_fused_bwd`` in interpret mode (their 128-lane padding removed), whose
    DEFAULT dots are exact float32 on the CPU."""
    import jax.numpy as jnp
    from svd_lstm_tpu.models.lstm import LSTMLayerParams
    from svd_lstm_tpu.ops.pallas_train_fused import _fused_bwd, _fused_fwd

    units, d, B, T, lane = (8, 12, 5), 16, 8, 6, 128
    layers, x, dh = _case(9, units, d, B, T)
    jl = tuple(LSTMLayerParams(*(jnp.asarray(a) for a in l)) for l in layers)
    h_all, c_all = _fused_fwd(jl, jnp.asarray(x), interpret=True)
    hs_j = [np.asarray(h_all)[:, :, i * lane : i * lane + n] for i, n in enumerate(units)]
    cs_j = [np.asarray(c_all)[:, :, i * lane : i * lane + n] for i, n in enumerate(units)]
    dh_p = jnp.zeros((T, B, lane), jnp.float32).at[:, :, : units[-1]].set(dh)
    dWs, dUs, dbs, dx = _fused_bwd(jl, jnp.asarray(x), h_all, c_all, dh_p, interpret=True)
    hs, cs, grads, _ = run_emulated(layers, x, dh, monkeypatch)
    pairs = [(f"h{i}", a, r) for i, (a, r) in enumerate(zip(hs, hs_j))]
    pairs += [(f"c{i}", a, r) for i, (a, r) in enumerate(zip(cs, cs_j))]
    for k, (got, want) in enumerate(zip(grads[:3], (dWs, dUs, dbs))):
        pairs += [(f"{'dW dU db'.split()[k]}{i}", a, r) for i, (a, r) in enumerate(zip(got, want))]
    pairs.append(("dx", grads[3], dx))
    for name, a, r in pairs:
        err = _rel(a.numpy(), np.asarray(r))
        assert 0 < err <= FAST_BAND, (name, err)  # bf16 operands: not exact, within the band
