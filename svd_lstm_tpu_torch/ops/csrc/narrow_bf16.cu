// K7f and K8f, the narrow whole-stack train pair with bf16 operands, on the
// H100's tensor cores — replace svd_lstm_tpu/ops/pallas_train_fused.py:
// _fused_fwd / _fused_bwd and svd_lstm_tpu/ops/pallas_train_compact.py:
// _fused_fwd / _fused_bwd at precision=DEFAULT (one bf16 pass a dot). K8f
// runs K7f's kernels (the TPU kernel's compact gate packing is a lane
// layout, not carried over). The float32 pair K7/K8 stays on the CUDA cores
// in lstm_train.cu (narrow_fwd_wave, narrow_bwd_wave, weight_grad).
//
// Numerics (as the plain bf16 versions, ops/cuda_train.py: operand_map):
// each operand is rounded to bf16 (to nearest even) where it enters a
// product: the weights when their fragments are made, the state h and x
// when they are stored into shared memory, dz when it is stored for the dh
// product, and every operand of the z and weight-gradient GEMMs as it is
// staged. The product of two bf16 values is exact in float32 and the
// tensor cores sum in float32, so the sums, c, the bias and the gate math
// are float32, every output is float32 and unrounded, and db is the
// unrounded sum of dz. Only the order of the float32 sums differs from the
// plain versions.
//
// What bounds them, and what the design does about it. At 4x40, d = 16,
// T = 200 the forward is 0.6 GFLOP at B = 32, 3 us at the card's bf16 rate,
// but batch rows are the only independent work: a CTA owns NB_ROWS = 2
// rows and runs T + L - 1 dependent steps, so the bound is one step's time
// times the chain. A step of a CTA is its mma.sync on fragments that do not
// change, then the gate math of its rows x Σn cells (~250 instructions a
// cell with expf, tanhf and IEEE divides), issued by its warps: two rows a
// CTA, not the eight of mma's n, so that math is spread over four times the
// SMs (at 8 rows it took ~60 % of a ~2.2 us forward step, PERF.md §6), each
// lane one cell. So:
//  * forward (narrow_fwd_mma): z_iᵀ (4n x 8) = [W_i; U_i]ᵀ · [h_{i-1} | h_i]ᵀ.
//    The weights are the A operand and stationary: a warp owns two groups of
//    8 units of one layer and holds their four m-tiles (rows g and g + 8 of
//    a group's first are gates i and f of unit g, of its second gates g and
//    o) for every k-tile; the columns repeat the two rows, so each lane's
//    accumulators hold all four gates of both groups' unit g for both rows,
//    and lane q updates group q >> 1's, row q & 1, from its own registers:
//    one cell a lane, its c carry in a register.
//    The state [x | h_0 | ... | h_{L-1}] is bf16 in shared memory, one row a
//    batch row, every segment padded to 8 (an ldmatrix row), read by
//    ldmatrix (the B operand); the layers run as a wavefront, one barrier a
//    step (the float32 kernel's schedule).
//  * backward (narrow_bwd_mma): only the dh carry is recurrent. z needs
//    only the forward's h, so it runs before the chain as one GEMM over all
//    T·B rows of every layer (narrow_z); the chain computes dh_iᵀ (n x 8) =
//    [U_i | W_{i+1}] · [dz_i(t+1); dz_{i+1}(t)]ᵀ with those weights as
//    stationary A fragments (a warp an m-tile of 16 units, and dx = dz_0·W_0ᵀ
//    as m-tiles of its own; a lane updates one cell, handed over by shuffle
//    as in the forward), the gate gradient in the lane's registers with the
//    dc carry, z read as one float4 a cell and dz written over it; then
//    dW, dU and db run over all T·B rows as one GEMM of every layer
//    (narrow_wgrad, split over the rows in a fixed order, sum_splits in
//    order: no atomics, the gradients do not change from run to run). z and
//    dz are kept unit-interleaved (column 4u + gate) in one scratch buffer,
//    so a cell's four gates are one 16-byte load or store.
//  * weight homes (the wrapper's plan, ops/cuda_train.py: narrow_bf16_plan;
//    the launchers check it): registers (one item a warp and few k-tiles:
//    the repo's stacks), or past that a global copy in fragment order (one
//    16-byte load a lane, a k-tile, from L2) made by nb_pack_fwd /
//    nb_pack_bwd in the same call. Fragments staged in shared memory were
//    no faster than the global copy on the card (PERF.md §6).
//
// Every launcher runs on the stream it is given, allocates nothing, and
// returns cudaGetLastError() for the Python wrapper to check.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "lstm_cell.cuh"

#define NB_ROWS 2           // batch rows a CTA (mma m16n8k16's n = 8 holds them four times)
#define NB_MAX_LAYERS 8
#define NB_SMEM_LIMIT 232448
#define NBF_REG_THREADS 384  // forward, weights in registers: 12 warps (164 registers a thread at 4x40)
#define NBF_REG_KT 6        // ... and at most 6 k-tiles a layer
#define NBF_MEM_THREADS 1024
#define NBF_IPW 2           // forward, the global copy: items a warp (8x128's 64 over 32 warps)
#define NBF_XPT 4           // entries of x_t a thread stages
#define NBB_REG_THREADS 416  // backward chain, weights in registers: 13 warps (at most 128 registers)
#define NBB_REG_KT 20
#define NBB_MEM_THREADS 512
#define NBB_IPW 5           // (8x128 and d = 128: 72 items over 16 warps)
#define BWD_CHAINS 4        // the dh product's independent chains of sums
#define NBZ_TILE 64         // narrow_z: a CTA's 64 rows x 64 gate columns
#define NBZ_THREADS 128
#define NBZ_BATCH 8         // ... and the entries a thread stages at a time
#define NBG_TP 128          // narrow_wgrad: a CTA's 128 rows of [W; U] (every row at 4x40: dz read once)
#define NBG_TG 64           // ... x 64 gate columns
#define NBG_KM 32           // ... and the rows of M it stages at a time
#define NBG_THREADS 256     // eight warps of 16 rows

namespace {

// bf16 row stride of a state or dz vector of `total` entries: room for a
// k-tile read past its end (zeros), and 16 bytes past a multiple of 128
// bytes, so the 8 rows one ldmatrix reads fall in distinct banks
// (ops/cuda_train.py: _bf16_row_stride)
inline int row_stride(int total) { return (total + 16 - 8 + 63) / 64 * 64 + 8; }
inline int seg8(int v) { return (v + 7) / 8 * 8; }

// ---------------------------------------------------------------------------
// the forward: narrow_fwd_mma
// ---------------------------------------------------------------------------
struct NbfLayer {
  int din, n;
  const float* W;  // (din, 4n)
  const float* U;  // (n, 4n)
  const float* b;  // (4n)
  float* h;        // (T, B, n)
  float* c;        // (T, B, n)
  int kin;         // state entry where the layer's input [h_{i-1} | h_i] starts
  int kseg;        // its first segment's width: U's rows start at k = kseg
  int hoff;        // state entry of h_i
  int KT;          // k-tiles of 16
  int pairs;       // pairs of unit groups of 8 (items)
  int item0;       // the layer's first item
  long long frag0; // its first fragment (32 uint4s: one a lane) in fragment order
};

struct NbfArgs {
  int L, d, items, SV;  // SV: the state's row stride
  long long frags;
  const uint4* packed;  // fragments in global memory (home 1), else null
  NbfLayer l[NB_MAX_LAYERS];
};

// A(rho, k) of m-tile m of group ug of a layer: rows 0-7 of m-tile 0 are
// gate i of the group's units, rows 8-15 gate f; of m-tile 1 gates g and o.
// Column gate·n + u of [W; U] at k (W's rows, then U's from kseg), rounded.
__device__ __forceinline__ unsigned short fwd_elem(const NbfLayer& ly, int ug, int m, int rho, int k) {
  const int n = ly.n, u = ug * 8 + (rho & 7), gate = 2 * m + (rho >> 3);
  float v = 0.f;
  if (u < n) {
    if (k < ly.kseg) {
      if (k < ly.din) v = __ldg(ly.W + (size_t)k * 4 * n + gate * n + u);
    } else if (k - ly.kseg < n) {
      v = __ldg(ly.U + (size_t)(k - ly.kseg) * 4 * n + gate * n + u);
    }
  }
  return bf16_bits(v);
}

// a lane's A fragment of one (m-tile, k-tile), mma m16n8k16's layout:
// register i holds row g + 8·(i & 1), columns 2q + 8·(i >> 1) and one more
__device__ __forceinline__ uint4 fwd_frag(const NbfLayer& ly, int ug, int m, int kt, int lane) {
  const int g = lane >> 2, k = kt * 16 + 2 * (lane & 3);
  uint32_t r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int rho = g + 8 * (i & 1), kk = k + 8 * (i >> 1);
    r[i] = pack2(fwd_elem(ly, ug, m, rho, kk), fwd_elem(ly, ug, m, rho, kk + 1));
  }
  return make_uint4(r[0], r[1], r[2], r[3]);
}

// fragment f of the stack in fragment order ([layer][pair][m-tile mm][k-tile]:
// m-tile mm of a pair is m-tile mm & 1 of its group 2·pair + (mm >> 1))
__device__ uint4 fwd_frag_at(const NbfArgs& a, long long f, int lane) {
  int li = 0;
  while (li + 1 < a.L && f >= a.l[li + 1].frag0) ++li;
  const NbfLayer& ly = a.l[li];
  const int fl = (int)(f - ly.frag0), KT = ly.KT, mm = fl / KT % 4;
  return fwd_frag(ly, fl / (4 * KT) * 2 + (mm >> 1), mm & 1, fl % KT, lane);
}

__global__ void nb_pack_fwd(const __grid_constant__ NbfArgs a, uint4* out) {
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x; e < a.frags * 32;
       e += (long long)gridDim.x * blockDim.x)
    out[e] = fwd_frag_at(a, e / 32, (int)(e % 32));
}

__device__ __forceinline__ void as_regs(uint32_t (&r)[4], uint4 v) {
  r[0] = v.x, r[1] = v.y, r[2] = v.z, r[3] = v.w;
}

// ldmatrix without a memory clobber (lstm_cell.cuh's ldmatrix_x4 has one):
// these kernels order their shared-memory stores and ldmatrix reads by
// __syncthreads alone (a step reads one parity and writes the other; a
// GEMM stages, syncs, reads, syncs), so nothing loaded from memory before
// an ldmatrix has to be loaded again after it
__device__ __forceinline__ void lds_x2(uint32_t (&r)[2], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void lds_x4(uint32_t (&r)[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// the transposed form: each lane receives a column's two values
__device__ __forceinline__ void lds_x4_trans(uint32_t (&r)[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// One CTA: NB_ROWS batch rows, the whole stack over T + L - 1 wave steps;
// at step s layer i computes t = s - i from parity (s + 1) & 1 of the state
// and writes h_i(t) into parity s & 1; x_{s+1} is loaded at the top of step
// s and stored at its end. An item is a pair of unit groups of a layer
// (four m-tiles), warp w's items w, w + warps, ... (one with kReg; else
// its fragments come from the global copy). The B fragments' columns are
// batch rows 0, 1, 0, 1, ... (ldmatrix row lane & 1), so every lane holds
// both rows of its four gate rows g, g + 8 of each m-tile; lane q updates
// the cell of unit g of the pair's group q >> 1, row q & 1, from its own
// accumulators: no shuffle, one cell a lane.
template <bool kReg>
__global__ void __launch_bounds__(kReg ? NBF_REG_THREADS : NBF_MEM_THREADS)
narrow_fwd_mma(const __grid_constant__ NbfArgs a, const float* __restrict__ x, int T, int B) {
  extern __shared__ uint4 nbf_smem[];
  constexpr int R = NB_ROWS, IPW = kReg ? 1 : NBF_IPW, KTR = kReg ? NBF_REG_KT : 1;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, q = lane & 3;
  const int W = blockDim.x >> 5, row0 = blockIdx.x * R, d = a.d, SV = a.SV;
  const int r = q & 1, G = q >> 1;  // this lane's row and group of the pair
  __nv_bfloat16* st = reinterpret_cast<__nv_bfloat16*>(nbf_smem);  // [2][R][SV]
  // zeros (h_{-1}, and every padding entry for good), x_0 into parity 1
  for (int e = tid; e < 2 * R * SV; e += blockDim.x) {
    const int k = e % SV, rr = e / SV % R;
    const bool x0 = e >= R * SV && k < d && row0 + rr < B;
    st[e] = __float2bfloat16_rn(x0 ? __ldg(x + (size_t)(row0 + rr) * d + k) : 0.f);
  }
  // each item's fields, in registers for the whole launch
  int li_[IPW], kin_[IPW], kt_[IPW], hoff_[IPW], n_[IPW], u_[IPW];
  long long f0_[IPW];
  float cc[IPW], bias[kReg ? 1 : IPW][4];
#pragma unroll
  for (int i = 0; i < IPW; ++i) {
    const int it = warp + i * W;
    li_[i] = -1, kin_[i] = kt_[i] = hoff_[i] = n_[i] = u_[i] = 0, f0_[i] = 0;
    cc[i] = 0.f;
    for (int li = 0; li < a.L && it < a.items; ++li) {
      const NbfLayer& ly = a.l[li];
      if (it >= ly.item0 && it < ly.item0 + ly.pairs) {
        const int pr = it - ly.item0;
        li_[i] = li, kin_[i] = ly.kin, kt_[i] = ly.KT, hoff_[i] = ly.hoff, n_[i] = ly.n;
        u_[i] = (2 * pr + G) * 8 + g, f0_[i] = (ly.frag0 + (long long)pr * 4 * ly.KT) * 32 + lane;
      }
    }
  }
  uint32_t af[4][KTR][4];
  if constexpr (kReg) {
    const int li = li_[0];
    if (li >= 0) {
      const NbfLayer& ly = a.l[li];
      const int pr = (u_[0] / 8 - G) / 2;
#pragma unroll
      for (int mm = 0; mm < 4; ++mm)
#pragma unroll
        for (int kt = 0; kt < KTR; ++kt)
          if (kt < kt_[0]) as_regs(af[mm][kt], fwd_frag(ly, 2 * pr + (mm >> 1), mm & 1, kt, lane));
#pragma unroll
      for (int gt = 0; gt < 4; ++gt) bias[0][gt] = u_[0] < n_[0] ? __ldg(ly.b + gt * n_[0] + u_[0]) : 0.f;
    }
  }
  // x_t's R·d entries: thread tid stages e = tid + j·blockDim, row e / d,
  // input k = e % d (its place in the state and whether the row is in the
  // batch, worked out once)
  int xst[NBF_XPT];
  bool xon[NBF_XPT], xin[NBF_XPT];
#pragma unroll
  for (int j = 0; j < NBF_XPT; ++j) {
    const int e = tid + j * blockDim.x;
    xon[j] = e < R * d;
    xin[j] = xon[j] && row0 + e / d < B;
    xst[j] = xon[j] ? (e / d) * SV + e % d : 0;
  }
  __syncthreads();

  const int steps = T + a.L - 1;
  for (int s = 0; s < steps; ++s) {
    const int P = (s + 1) & 1, Q = s & 1;
    float xn[NBF_XPT];
#pragma unroll
    for (int j = 0; j < NBF_XPT; ++j)
      xn[j] = s + 1 < T && xin[j] ? __ldg(x + ((size_t)(s + 1) * B + row0) * d + tid + j * blockDim.x) : 0.f;
#pragma unroll
    for (int i = 0; i < IPW; ++i) {
      const int li = li_[i], t = s - li;
      if (li < 0 || t < 0 || t >= T) continue;
      const int n = n_[i], u = u_[i], KT = kt_[i];
      float bz[4];
#pragma unroll
      for (int gt = 0; gt < 4; ++gt) {
        if constexpr (kReg) {
          bz[gt] = bias[0][gt];
        } else {
          bz[gt] = u < n ? __ldg(a.l[li].b + gt * n + u) : 0.f;
        }
      }
      // the four m-tiles' sums, each in two chains (even and odd k-tiles)
      float acc[4][2][4] = {};
      const __nv_bfloat16* sp = st + (P * R + (lane & 1)) * SV + kin_[i] + ((lane >> 3) & 1) * 8;
      if constexpr (kReg) {
#pragma unroll
        for (int kt = 0; kt < KTR; ++kt) {
          if (kt < KT) {
            uint32_t b[2];
            lds_x2(b, sp + kt * 16);
#pragma unroll
            for (int mm = 0; mm < 4; ++mm) mma_bf16(acc[mm][kt & 1], af[mm][kt], b[0], b[1]);
          }
        }
      } else {
        const uint4* f0 = a.packed + f0_[i];
        for (int kt = 0; kt < KT; kt += 2) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            if (kt + h < KT) {
              uint32_t b[2], w[4];
              lds_x2(b, sp + (kt + h) * 16);
#pragma unroll
              for (int mm = 0; mm < 4; ++mm) {
                as_regs(w, __ldg(f0 + (mm * KT + kt + h) * 32));
                mma_bf16(acc[mm][h], w, b[0], b[1]);
              }
            }
          }
        }
      }
      // this lane's cell: m-tiles 2G (gates i, f) and 2G + 1 (g, o), row r
      float z4[4];
#pragma unroll
      for (int gt = 0; gt < 4; ++gt) {
        float v = 0.f;
#pragma unroll
        for (int mm = 0; mm < 4; mm += 2)
#pragma unroll
          for (int rr = 0; rr < 2; ++rr)
            if (mm == 2 * G && rr == r) {
              const int m = mm + (gt >> 1), e = 2 * (gt & 1) + rr;
              v = acc[m][0][e] + acc[m][1][e];
            }
        z4[gt] = v + bz[gt];
      }
      float hn, cn;
      gate_fwd(z4[0], z4[1], z4[2], z4[3], cc[i], hn, cn);
      cc[i] = cn;
      if (u < n) {
        st[(Q * R + r) * SV + hoff_[i] + u] = __float2bfloat16_rn(hn);
        if (row0 + r < B) {
          const NbfLayer& ly = a.l[li];
          const size_t m = (size_t)t * B + row0 + r;
          ly.h[m * n + u] = hn;
          ly.c[m * n + u] = cn;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < NBF_XPT; ++j)
      if (s + 1 < T && xon[j]) st[Q * R * SV + xst[j]] = __float2bfloat16_rn(xn[j]);
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// the backward, part 1: narrow_z, z of every layer over all T·B rows
// z_i (M, 4n) = x_i·W_i + h_i(t-1)·U_i + b_i, x_i = x or h_{i-1}, h(t-1) read
// B rows back (zero at t = 0), columns unit-interleaved (4u + gate). A CTA:
// 64 rows of one layer, their [x_i | h_i(t-1)] staged once as bf16 ([row]
// [k]), then each 64 columns of [W_i; U_i] in turn ([column][k]), four
// warps of 16 rows x 8 n-tiles, ldmatrix and mma.sync.
// ---------------------------------------------------------------------------
struct NbzLayer {
  int din, n;
  const float *inp, *h, *W, *U, *b;
  float* z;  // (M, 4n), unit-interleaved
};

struct NbzArgs {
  int L, M, B;
  NbzLayer l[NB_MAX_LAYERS];
};

__host__ __device__ inline int nbz_ld(int din, int n) { return (din + n + 15) / 16 * 16 + 8; }

__global__ void __launch_bounds__(NBZ_THREADS) narrow_z(const __grid_constant__ NbzArgs a) {
  extern __shared__ uint4 nbz_smem[];
  const NbzLayer& ly = a.l[blockIdx.z];
  const int n = ly.n, din = ly.din, G = 4 * n, K = din + n, LD = nbz_ld(din, n), KP = LD - 8;
  const int m0 = blockIdx.x * NBZ_TILE;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5, g = lane >> 2, q = lane & 3;
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(nbz_smem);  // [64][LD]
  __nv_bfloat16* Bs = As + NBZ_TILE * LD;                           // [64][LD]
  const int total = NBZ_TILE * KP;
  // the rows' [x | h(t-1)], staged once for every column tile: NBZ_BATCH
  // entries a thread at a time, every load of a batch issued before its
  // first store
  for (int e0 = tid; e0 < total; e0 += NBZ_THREADS * NBZ_BATCH) {
    float v[NBZ_BATCH];
#pragma unroll
    for (int j = 0; j < NBZ_BATCH; ++j) {
      const int e = e0 + j * NBZ_THREADS, r = e / KP, k = e % KP, m = m0 + r;
      v[j] = 0.f;
      if (e < total && m < a.M) {
        if (k < din) {
          v[j] = __ldg(ly.inp + (size_t)m * din + k);
        } else if (k < K && m >= a.B) {
          v[j] = __ldg(ly.h + (size_t)(m - a.B) * n + k - din);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < NBZ_BATCH; ++j) {
      const int e = e0 + j * NBZ_THREADS;
      if (e < total) As[(e / KP) * LD + e % KP] = __float2bfloat16_rn(v[j]);
    }
  }
  for (int g0 = 0; g0 < G; g0 += NBZ_TILE) {
    __syncthreads();  // As staged; Bs free
    for (int e0 = tid; e0 < total; e0 += NBZ_THREADS * NBZ_BATCH) {  // [W; U] at k, column col
      float v[NBZ_BATCH];
#pragma unroll
      for (int j = 0; j < NBZ_BATCH; ++j) {
        const int e = e0 + j * NBZ_THREADS, k = e / NBZ_TILE, col = g0 + e % NBZ_TILE;
        const int src = (col & 3) * n + (col >> 2);
        v[j] = 0.f;
        if (e < total && col < G && k < K)
          v[j] = k < din ? __ldg(ly.W + (size_t)k * G + src) : __ldg(ly.U + (size_t)(k - din) * G + src);
      }
#pragma unroll
      for (int j = 0; j < NBZ_BATCH; ++j) {
        const int e = e0 + j * NBZ_THREADS;
        if (e < total) Bs[(e % NBZ_TILE) * LD + e / NBZ_TILE] = __float2bfloat16_rn(v[j]);
      }
    }
    __syncthreads();
    float acc[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
    for (int kt = 0; kt < KP / 16; ++kt) {
      uint32_t af[4];
      lds_x4(af, As + (16 * w + (lane & 15)) * LD + kt * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int pr = 0; pr < 4; ++pr) {
        uint32_t r[4];
        lds_x4(r, Bs + ((2 * pr + (lane >> 4)) * 8 + (lane & 7)) * LD + kt * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(acc[2 * pr], af, r[0], r[1]);
        mma_bf16(acc[2 * pr + 1], af, r[2], r[3]);
      }
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int col = g0 + 8 * nt + 2 * q;
      if (col >= G) continue;
      const float b0 = __ldg(ly.b + (col & 3) * n + (col >> 2));
      const float b1 = __ldg(ly.b + ((col + 1) & 3) * n + ((col + 1) >> 2));
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const int m = m0 + 16 * w + g + 8 * h2;
        if (m < a.M)
          *reinterpret_cast<float2*>(ly.z + (size_t)m * G + col) =
              make_float2(acc[nt][2 * h2] + b0, acc[nt][2 * h2 + 1] + b1);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// the backward, part 2: narrow_bwd_mma, the dh chain
// ---------------------------------------------------------------------------
// An entry: a layer's dh product (A = [U_i | W_{i+1}], K = its dz segment
// then the layer above's) or, as entry L, dx's (A = W_0, K = layer 0's
// segment). dz is kept as one bf16 vector a batch row, [dz_0 | ... |
// dz_{L-1}], each segment 4n unit-interleaved (k = 4u + gate) and padded to
// 8; so an entry's K is one contiguous range of it. Items: (entry, m-tile of
// 16 rows).
struct NbbEntry {
  int rows;               // units n_i, or d
  int n1, n2;             // the widths of A1's and A2's gates (n2 0: no A2)
  const float *A1, *A2;   // U_i (n_i, 4n_i) and W_{i+1} (n_i, 4n_{i+1}); W_0 (d, 4n_0)
  int seg1, KT, mts, item0;
  int koff;               // the entry's first k in the dz vector
  long long frag0;
  float* zdz;             // layers: z in, dz out, (T, B, 4n) unit-interleaved
  const float* c;         // layers: the forward's c (T, B, n)
};

struct NbbArgs {
  int L, d, items, SZ;  // SZ: the dz vector's row stride
  long long frags;
  const uint4* packed;
  const float* dhl;  // (T, B, n_{L-1})
  float* dx;         // (T, B, d)
  NbbEntry e[NB_MAX_LAYERS + 1];
};

// A(rho, k) of m-tile mt of an entry: row u = 16mt + rho of A1 at gate
// column (k & 3)·n1 + (k >> 2) for k < seg1, else of A2 at k - seg1; rounded
__device__ __forceinline__ unsigned short bwd_elem(const NbbEntry& en, int mt, int rho, int k) {
  const int u = mt * 16 + rho;
  float v = 0.f;
  if (u < en.rows) {
    if (k < en.seg1) {
      if ((k >> 2) < en.n1) v = __ldg(en.A1 + (size_t)u * 4 * en.n1 + (k & 3) * en.n1 + (k >> 2));
    } else {
      const int kk = k - en.seg1;
      if ((kk >> 2) < en.n2) v = __ldg(en.A2 + (size_t)u * 4 * en.n2 + (kk & 3) * en.n2 + (kk >> 2));
    }
  }
  return bf16_bits(v);
}

__device__ __forceinline__ uint4 bwd_frag(const NbbEntry& en, int mt, int kt, int lane) {
  const int g = lane >> 2, k = kt * 16 + 2 * (lane & 3);
  uint32_t r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int rho = g + 8 * (i & 1), kk = k + 8 * (i >> 1);
    r[i] = pack2(bwd_elem(en, mt, rho, kk), bwd_elem(en, mt, rho, kk + 1));
  }
  return make_uint4(r[0], r[1], r[2], r[3]);
}

// fragment f in fragment order ([entry][m-tile][k-tile])
__device__ uint4 bwd_frag_at(const NbbArgs& a, long long f, int lane) {
  int ei = 0;
  while (ei < a.L && f >= a.e[ei + 1].frag0) ++ei;
  const NbbEntry& en = a.e[ei];
  const int fl = (int)(f - en.frag0);
  return bwd_frag(en, fl / en.KT, fl % en.KT, lane);
}

__global__ void nb_pack_bwd(const __grid_constant__ NbbArgs a, uint4* out) {
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x; e < a.frags * 32;
       e += (long long)gridDim.x * blockDim.x)
    out[e] = bwd_frag_at(a, e / 32, (int)(e % 32));
}

// One CTA: NB_ROWS batch rows, T + L reverse wave steps: at step s layer i
// computes t = T + L - 2 - i - s and dx t = T + L - 1 - s, each from parity
// (s + 1) & 1 of the dz vector (written at step s - 1: the layer's own
// dz(t + 1), the layer above's dz(t)), its dz into parity s & 1. A lane's
// cell (see below); the carries c(t) and dc stay in its registers.
template <bool kReg>
__global__ void __launch_bounds__(kReg ? NBB_REG_THREADS : NBB_MEM_THREADS)
narrow_bwd_mma(const __grid_constant__ NbbArgs a, int T, int B) {
  extern __shared__ uint4 nbb_smem[];
  constexpr int R = NB_ROWS, IPW = kReg ? 1 : NBB_IPW, KTR = kReg ? NBB_REG_KT : 1;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, q = lane & 3;
  const int W = blockDim.x >> 5, row0 = blockIdx.x * R, L = a.L, SZ = a.SZ;
  __nv_bfloat16* dzs = reinterpret_cast<__nv_bfloat16*>(nbb_smem);  // [2][R][SZ]
  for (int e = tid; e < 2 * R * SZ; e += blockDim.x) dzs[e] = __float2bfloat16_rn(0.f);

  // each item's fields, in registers for the whole launch
  int ei_[IPW], kt_[IPW], koff_[IPW], n_[IPW], u0_[IPW];
  long long f0_[IPW];
  // the B fragments' columns are batch rows 0, 1, 0, 1, ... (ldmatrix row
  // lane & 1), so each lane's four accumulators are units g and g + 8, rows
  // 0 and 1: lane q updates one cell, unit u0 (g, + 8 for q >= 2), row q & 1
  float ct[IPW], dc[IPW];
#pragma unroll
  for (int i = 0; i < IPW; ++i) {
    const int it = warp + i * W;
    ei_[i] = -1, kt_[i] = koff_[i] = n_[i] = u0_[i] = 0, f0_[i] = 0;
    for (int ei = 0; ei <= L && it < a.items; ++ei) {
      const NbbEntry& en = a.e[ei];
      if (it >= en.item0 && it < en.item0 + en.mts) {
        const int mt = it - en.item0;
        ei_[i] = ei, kt_[i] = en.KT, koff_[i] = en.koff, n_[i] = en.rows, u0_[i] = mt * 16 + g + (q >> 1) * 8;
        f0_[i] = (en.frag0 + (long long)mt * en.KT) * 32 + lane;
      }
    }
    ct[i] = dc[i] = 0.f;
    const int ei = ei_[i];
    if (ei >= 0 && ei < L) {  // c(t) of the first step, t = T + L - 2 - ei (zero past T - 1)
      const int t = T + L - 2 - ei, u = u0_[i], row = row0 + (q & 1);
      if (t < T && u < n_[i] && row < B) ct[i] = __ldg(a.e[ei].c + ((size_t)t * B + row) * n_[i] + u);
    }
  }
  uint32_t af[KTR][4];
  if constexpr (kReg) {
    if (ei_[0] >= 0) {
      const NbbEntry& en = a.e[ei_[0]];
#pragma unroll
      for (int kt = 0; kt < KTR; ++kt)
        if (kt < kt_[0]) as_regs(af[kt], bwd_frag(en, u0_[0] / 16, kt, lane));
    }
  }
  __syncthreads();

  for (int s = 0; s < T + L; ++s) {
    const int P = (s + 1) & 1, Q = s & 1;
#pragma unroll
    for (int i = 0; i < IPW; ++i) {
      const int ei = ei_[i];
      if (ei < 0) continue;
      const bool dxe = ei == L, top = ei == L - 1;
      const int t = dxe ? T + L - 1 - s : T + L - 2 - ei - s, n = n_[i], KT = kt_[i];
      const bool active = t >= 0 && t < T;
      float* zdz = a.e[ei].zdz;
      // this step's loads, issued before the product: z(t) and dh_last(t)
      // of the active cells, and c(t - 1) (the next step's c(t)) always
      const int u = u0_[i], r = q & 1, row = row0 + r;
      float4 zq = make_float4(0.f, 0.f, 0.f, 0.f);
      float cp = 0.f, dhv = 0.f;
      if (!dxe && u < n && row < B) {
        if (t >= 1 && t - 1 < T) cp = __ldg(a.e[ei].c + ((size_t)(t - 1) * B + row) * n + u);
        if (active) {
          zq = *reinterpret_cast<const float4*>(zdz + ((size_t)t * B + row) * 4 * n + 4 * u);
          if (top) dhv = __ldg(a.dhl + ((size_t)t * B + row) * n + u);
        }
      }
      if (active) {
        // four chains of sums (k-tile kt into chain kt % 4), added in order
        float acc[BWD_CHAINS][4] = {};
        const __nv_bfloat16* sp = dzs + (P * R + (lane & 1)) * SZ + koff_[i] + ((lane >> 3) & 1) * 8;
        if constexpr (kReg) {
#pragma unroll
          for (int kt = 0; kt < KTR; ++kt) {
            if (kt < KT) {
              uint32_t b[2];
              lds_x2(b, sp + kt * 16);
              mma_bf16(acc[kt % BWD_CHAINS], af[kt], b[0], b[1]);
            }
          }
        } else {
          const uint4* f0 = a.packed + f0_[i];
          for (int kt = 0; kt < KT; kt += BWD_CHAINS) {
#pragma unroll
            for (int h = 0; h < BWD_CHAINS; ++h) {
              if (kt + h < KT) {
                uint32_t b[2], w[4];
                lds_x2(b, sp + (kt + h) * 16);
                as_regs(w, __ldg(f0 + (kt + h) * 32));
                mma_bf16(acc[h], w, b[0], b[1]);
              }
            }
          }
        }
        // accumulator e: unit g + 8·(e >> 1), row e & 1 (the B fragments'
        // columns are rows 0, 1, 0, 1, ...); lane q's cell is accumulator q,
        // its chains added in order
        float v = 0.f;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (q != e) continue;
          v = acc[0][e];
#pragma unroll
          for (int h = 1; h < BWD_CHAINS; ++h) v += acc[h][e];
        }
        if (u < n) {  // else a padded unit (a m-tile's rows past n)
          const float dh = v + dhv;
          if (dxe) {
            if (row < B) a.dx[((size_t)t * B + row) * n + u] = dh;
          } else {
            float gz[4];
            dc[i] = gate_bwd(zq.x, zq.y, zq.z, zq.w, cp, ct[i], dh, dc[i], gz);
            *reinterpret_cast<uint2*>(dzs + (Q * R + r) * SZ + koff_[i] + 4 * u) =
                make_uint2(pack2(bf16_bits(gz[0]), bf16_bits(gz[1])), pack2(bf16_bits(gz[2]), bf16_bits(gz[3])));
            if (row < B)
              *reinterpret_cast<float4*>(zdz + ((size_t)t * B + row) * 4 * n + 4 * u) =
                  make_float4(gz[0], gz[1], gz[2], gz[3]);
          }
        }
      }
      if (!dxe) ct[i] = cp;
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// the backward, part 3: narrow_wgrad, every layer's [dW; dU; db] over all
// T·B rows: out (din + n, 4n) = Σ_m [x_i | h_i(t-1)]_mᵀ ⊗ dz_m on the tensor
// cores (operands rounded as staged), and the row db = Σ_m dz_m unrounded in
// float32. A CTA: 128 rows of [W; U] x 64 unit-interleaved columns of one
// layer over one split of M, staged 32 rows of M at a time as bf16 [m][.]
// and read by ldmatrix.trans (A is [x | h]ᵀ, B is dz); the columns go out in
// the layer's gate-major order. db: the CTAs of the first row tile, four
// threads a column, each the rows of one residue mod 4 in order, then the
// four in order.
// ---------------------------------------------------------------------------
struct NbgLayer {
  int din, n;
  const float *inp, *h, *dz;  // dz (M, 4n) unit-interleaved
  long long off;              // the layer's first float of [dW; dU; db] (din + n + 1, 4n)
};

struct NbgArgs {
  int L, M, B, splits, chunk;
  float* out;  // splits > 1: the partial sums, split s at s·split_stride
  long long split_stride;
  NbgLayer l[NB_MAX_LAYERS];
};

__global__ void __launch_bounds__(NBG_THREADS) narrow_wgrad(const __grid_constant__ NbgArgs a) {
  __shared__ __align__(16) __nv_bfloat16 As[NBG_KM][NBG_TP + 8];
  __shared__ __align__(16) __nv_bfloat16 Ds[NBG_KM][NBG_TG + 8];
  __shared__ float dbs[NBG_THREADS];
  const int li = blockIdx.z / a.splits, sp = blockIdx.z % a.splits;
  const NbgLayer& ly = a.l[li];
  const int n = ly.n, din = ly.din, G = 4 * n, Pr = din + n;
  const int g0 = blockIdx.x * NBG_TG, p0 = blockIdx.y * NBG_TP;
  if (g0 >= G || p0 >= Pr) return;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5, g = lane >> 2, q = lane & 3;
  const int mb = sp * a.chunk, me = min(a.M, mb + a.chunk);
  float acc[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
  // a thread's entries of a chunk: of [x | h(t-1)] column tid % 128, rows
  // tid / 128 + 2j; of dz column tid % 64, rows tid / 64 + 4j. The next
  // chunk's loads are in flight while this one's products run
  constexpr int PA = NBG_KM * NBG_TP / NBG_THREADS, PD = NBG_KM * NBG_TG / NBG_THREADS;
  constexpr int SA = NBG_THREADS / NBG_TP, SD = NBG_THREADS / NBG_TG;  // row steps
  const int ca = tid % NBG_TP, ra = tid / NBG_TP, cd = tid % NBG_TG, rd = tid / NBG_TG;
  const int pa = p0 + ca, ga = g0 + cd;
  float va[PA], vd[PD];
  auto load = [&](int mc) {
#pragma unroll
    for (int j = 0; j < PA; ++j) {
      const int m = mc + ra + SA * j;
      va[j] = 0.f;
      if (m < me && pa < Pr) {
        if (pa < din) {
          va[j] = __ldg(ly.inp + (size_t)m * din + pa);
        } else if (m >= a.B) {
          va[j] = __ldg(ly.h + (size_t)(m - a.B) * n + pa - din);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < PD; ++j) {
      const int m = mc + rd + SD * j;
      vd[j] = m < me && ga < G ? __ldg(ly.dz + (size_t)m * G + ga) : 0.f;
    }
  };
  float dbv = 0.f;  // db of column cd over the rows of M ≡ rd (mod SD), in order
  if (mb < me) load(mb);
  for (int mc = mb; mc < me; mc += NBG_KM) {
#pragma unroll
    for (int j = 0; j < PA; ++j) As[ra + SA * j][ca] = __float2bfloat16_rn(va[j]);
#pragma unroll
    for (int j = 0; j < PD; ++j) {
      Ds[rd + SD * j][cd] = __float2bfloat16_rn(vd[j]);
      dbv += vd[j];
    }
    __syncthreads();
    if (mc + NBG_KM < me) load(mc + NBG_KM);
#pragma unroll
    for (int ks = 0; ks < NBG_KM / 16; ++ks) {
      const int j = lane >> 3;
      uint32_t af[4];
      lds_x4_trans(af, &As[16 * ks + (j >> 1) * 8 + (lane & 7)][16 * w + (j & 1) * 8]);
#pragma unroll
      for (int pr = 0; pr < 4; ++pr) {
        uint32_t r[4];
        lds_x4_trans(r, &Ds[16 * ks + (j & 1) * 8 + (lane & 7)][(2 * pr + (j >> 1)) * 8]);
        mma_bf16(acc[2 * pr], af, r[0], r[1]);
        mma_bf16(acc[2 * pr + 1], af, r[2], r[3]);
      }
    }
    __syncthreads();
  }
  float* out = a.out + sp * a.split_stride + ly.off;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e2 = 0; e2 < 2; ++e2) {
      const int gc = g0 + 8 * nt + 2 * q + e2;
      if (gc >= G) continue;
      const int col = (gc & 3) * n + (gc >> 2);
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const int p = p0 + 16 * w + g + 8 * h2;
        if (p < Pr) out[(size_t)p * G + col] = acc[nt][2 * h2 + e2];
      }
    }
  if (p0 == 0) {  // db: the SD residues of each column, added in order
    dbs[tid] = dbv;
    __syncthreads();
    const int gc = g0 + tid;
    if (tid < NBG_TG && gc < G) {
      float v = dbs[tid];
#pragma unroll
      for (int k = 1; k < SD; ++k) v += dbs[tid + k * NBG_TG];
      out[(size_t)Pr * G + (gc & 3) * n + (gc >> 2)] = v;
    }
  }
}

// out[i] = Σ_{s<splits} partial[s][i], in order of s (lstm_train.cu's
// sum_splits, here for narrow_wgrad's partial sums)
__global__ void nb_sum_splits(const float* __restrict__ partial, float* __restrict__ out, long long size,
                              int splits) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < size;
       i += (long long)gridDim.x * blockDim.x) {
    float v = 0.f;
    for (int s = 0; s < splits; ++s) v += partial[(size_t)s * size + i];
    out[i] = v;
  }
}

template <typename K>
cudaError_t nb_prepare_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

inline int grid_of(long long work) {
  const long long b = (work + 255) / 256;
  return (int)(b < 1 ? 1 : b > 2048 ? 2048 : b);
}

}  // namespace

extern "C" {

// K7f and K8f forward. meta: L rows of 7 int64 — din, n, W, U, b, h, c (device
// pointers). warps and home (0: the weights in registers, 1: the global
// copy `packed`, frags·512 bytes, made here by nb_pack_fwd) are the
// wrapper's plan (ops/cuda_train.py: narrow_bf16_plan), checked here.
int narrow_bf16_fwd_launch(const int64_t* meta, int L, const void* x, int T, int B, int d, int warps,
                           int home, void* packed, void* stream) {
  if (L < 1 || L > NB_MAX_LAYERS || T < 1 || B < 1 || d < 1 || d > 128 || x == nullptr || home < 0 ||
      home > 1)
    return (int)cudaErrorInvalidValue;
  NbfArgs a;
  a.L = L, a.d = d;
  int din = d, kin = 0, items = 0, ktmax = 0;
  long long frags = 0;
  for (int i = 0; i < L; ++i) {
    const int64_t* m = meta + (size_t)7 * i;
    NbfLayer& l = a.l[i];
    l.din = (int)m[0], l.n = (int)m[1];
    if (l.din != din || l.n < 1 || l.n > 128) return (int)cudaErrorInvalidValue;
    l.W = reinterpret_cast<const float*>(m[2]);
    l.U = reinterpret_cast<const float*>(m[3]);
    l.b = reinterpret_cast<const float*>(m[4]);
    l.h = reinterpret_cast<float*>(m[5]);
    l.c = reinterpret_cast<float*>(m[6]);
    l.kin = kin, l.kseg = seg8(din), l.hoff = kin + l.kseg;
    l.KT = (l.kseg + seg8(l.n) + 15) / 16;
    l.pairs = (l.n + 15) / 16, l.item0 = items, l.frag0 = frags;
    items += l.pairs;
    frags += (long long)l.pairs * 4 * l.KT;
    ktmax = l.KT > ktmax ? l.KT : ktmax;
    kin = l.hoff, din = l.n;
  }
  a.items = items, a.frags = frags, a.SV = row_stride(kin + seg8(din));
  a.packed = home == 1 ? reinterpret_cast<const uint4*>(packed) : nullptr;
  const int threads = 32 * warps;
  const size_t smem = (size_t)2 * NB_ROWS * a.SV * 2;
  if (warps < 1 || threads > (home == 0 ? NBF_REG_THREADS : NBF_MEM_THREADS) ||
      NBF_XPT * threads < NB_ROWS * d || smem > NB_SMEM_LIMIT || (home == 1 && packed == nullptr) ||
      (home == 0 ? items > warps || ktmax > NBF_REG_KT : items > warps * NBF_IPW))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (home == 1) nb_pack_fwd<<<grid_of(frags * 32), 256, 0, s>>>(a, reinterpret_cast<uint4*>(packed));
  const auto kernel = home == 0 ? narrow_fwd_mma<true> : narrow_fwd_mma<false>;
  cudaError_t err = nb_prepare_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(B + NB_ROWS - 1) / NB_ROWS, threads, smem, s>>>(a, (const float*)x, T, B);
  return (int)cudaGetLastError();
}

// K7f and K8f backward. meta: L rows of 7 int64 — din, n, W, U, b and the
// forward's h, c. zdz: every layer's (T, B, 4n) in order (z, then dz over
// it); grads: every layer's [dW; dU; db] ((din + n + 1) x 4n, gate-major) in
// order; partial: splits x that when splits > 1. warps and home as the
// forward's, for the chain (ops/cuda_train.py: narrow_bf16_plan); splits:
// the weight gradients' split of the T·B rows.
int narrow_bf16_bwd_launch(const int64_t* meta, int L, const void* x, const void* dhl, void* dx,
                           void* grads, void* partial, void* zdz, int T, int B, int d, int warps,
                           int home, int splits, void* packed, void* stream) {
  if (L < 1 || L > NB_MAX_LAYERS || T < 1 || B < 1 || d < 1 || d > 128 || x == nullptr ||
      dhl == nullptr || dx == nullptr || grads == nullptr || zdz == nullptr || home < 0 || home > 1 ||
      splits < 1 || (splits > 1 && partial == nullptr))
    return (int)cudaErrorInvalidValue;
  const int M = T * B;
  int din = d, koff = 0, items = 0, ktmax = 0, gmax = 0, pmax = 0, ldmax = 0;
  long long frags = 0, zo = 0, go = 0;
  NbzArgs za;
  NbbArgs ba;
  NbgArgs ga;
  za.L = ba.L = ga.L = L;
  za.M = ga.M = M;
  za.B = ga.B = B;
  ba.d = d;
  const float* W0 = nullptr;
  for (int i = 0; i < L; ++i) {
    const int64_t* m = meta + (size_t)7 * i;
    const int di = (int)m[0], n = (int)m[1];
    if (di != din || n < 1 || n > 128) return (int)cudaErrorInvalidValue;
    const float* W = reinterpret_cast<const float*>(m[2]);
    const float* U = reinterpret_cast<const float*>(m[3]);
    const float* h = reinterpret_cast<const float*>(m[5]);
    const float* inp = i == 0 ? (const float*)x : reinterpret_cast<const float*>(meta[(size_t)7 * (i - 1) + 5]);
    float* z = (float*)zdz + zo;
    za.l[i] = NbzLayer{di, n, inp, h, W, U, reinterpret_cast<const float*>(m[4]), z};
    ga.l[i] = NbgLayer{di, n, inp, h, z, go};
    NbbEntry& en = ba.e[i];
    en.rows = n, en.n1 = n, en.A1 = U, en.seg1 = seg8(4 * n);
    en.n2 = i + 1 < L ? (int)meta[(size_t)7 * (i + 1) + 1] : 0;
    en.A2 = i + 1 < L ? reinterpret_cast<const float*>(meta[(size_t)7 * (i + 1) + 2]) : nullptr;
    en.KT = (en.seg1 + (en.n2 ? seg8(4 * en.n2) : 0) + 15) / 16;
    en.mts = (n + 15) / 16, en.item0 = items, en.koff = koff, en.frag0 = frags;
    en.zdz = z, en.c = reinterpret_cast<const float*>(m[6]);
    items += en.mts;
    frags += (long long)en.mts * en.KT;
    ktmax = en.KT > ktmax ? en.KT : ktmax;
    if (i == 0) W0 = W;
    koff += en.seg1;
    zo += (long long)M * 4 * n;
    go += (long long)(di + n + 1) * 4 * n;
    gmax = 4 * n > gmax ? 4 * n : gmax;
    pmax = di + n > pmax ? di + n : pmax;
    ldmax = nbz_ld(di, n) > ldmax ? nbz_ld(di, n) : ldmax;
    din = n;
  }
  {  // dx: W_0 against layer 0's dz segment
    NbbEntry& en = ba.e[L];
    const int n0 = ba.e[0].n1;
    en.rows = d, en.n1 = n0, en.A1 = W0, en.n2 = 0, en.A2 = nullptr, en.seg1 = seg8(4 * n0);
    en.KT = (en.seg1 + 15) / 16, en.mts = (d + 15) / 16, en.item0 = items, en.koff = 0;
    en.frag0 = frags, en.zdz = nullptr, en.c = nullptr;
    items += en.mts;
    frags += (long long)en.mts * en.KT;
    ktmax = en.KT > ktmax ? en.KT : ktmax;
  }
  ba.items = items, ba.frags = frags, ba.SZ = row_stride(koff);
  ba.packed = home == 1 ? reinterpret_cast<const uint4*>(packed) : nullptr;
  ba.dhl = (const float*)dhl, ba.dx = (float*)dx;
  const int threads = 32 * warps;
  const size_t smem = (size_t)2 * NB_ROWS * ba.SZ * 2;
  if (warps < 1 || threads > (home == 0 ? NBB_REG_THREADS : NBB_MEM_THREADS) || smem > NB_SMEM_LIMIT ||
      (home == 1 && packed == nullptr) ||
      (home == 0 ? items > warps || ktmax > NBB_REG_KT : items > warps * NBB_IPW))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  const size_t zsmem = (size_t)2 * NBZ_TILE * ldmax * 2;
  err = nb_prepare_smem(narrow_z, zsmem);
  if (err != cudaSuccess) return (int)err;
  narrow_z<<<dim3((M + NBZ_TILE - 1) / NBZ_TILE, 1, L), NBZ_THREADS, zsmem, s>>>(za);
  if (home == 1) nb_pack_bwd<<<grid_of(frags * 32), 256, 0, s>>>(ba, reinterpret_cast<uint4*>(packed));
  const auto kernel = home == 0 ? narrow_bwd_mma<true> : narrow_bwd_mma<false>;
  err = nb_prepare_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(B + NB_ROWS - 1) / NB_ROWS, threads, smem, s>>>(ba, T, B);
  ga.splits = splits;
  ga.chunk = ((M + splits - 1) / splits + NBG_KM - 1) / NBG_KM * NBG_KM;
  ga.out = splits > 1 ? (float*)partial : (float*)grads;
  ga.split_stride = go;
  narrow_wgrad<<<dim3((gmax + NBG_TG - 1) / NBG_TG, (pmax + NBG_TP - 1) / NBG_TP, L * splits), NBG_THREADS, 0,
                 s>>>(ga);
  if (splits > 1) nb_sum_splits<<<grid_of(go), 256, 0, s>>>((const float*)partial, (float*)grads, go, splits);
  return (int)cudaGetLastError();
}

}  // extern "C"
