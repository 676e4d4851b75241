// Batch-1 LSTM recurrence kernels for Hopper (sm_90a), float32 state, in
// exact mode and in fast (bf16-operand) mode.
//
// Four kernels, one per TPU kernel on the batch-1 inference path of
// svd_lstm_tpu/ops/pallas_lstm.py. All four share one shape: a sequential
// recurrence over T steps with a dependent matrix-vector chain per step.
//
// Common design (what bounds them, and what the design does about it):
//  * The time loop is sequential, so the work per step is tiny (a GEMV of a
//    few hundred to a few thousand columns) and the chain of dependent steps
//    is the bound: launch latency, barrier latency and the latency of the
//    weight reads inside one step. Each kernel is one persistent launch per
//    sequence that runs all T steps inside it, which replaces the TPU's
//    sequential grid and its CT-step chunking (no time padding, no
//    per-step launch).
//  * K1 (dense_stack_wave, every stack of at most 1024 units) runs the
//    layers as a one-row wavefront in one CTA: one barrier a step, a group
//    of S lanes a unit splitting its dot, the gate update and c in the
//    owning lane's registers, the weights gate-interleaved in registers, in
//    shared memory or read from a global copy (see its note). A wider stack
//    (3x512) runs fused_dense_stack_kernel, the time-outer, layer-inner
//    loop below.
//  * K3 (recurrence_chain) splits one layer over the SMs: a CTA owns J
//    units, a warp each, with their columns of U on chip, in one
//    cooperative launch with a grid barrier a step (see its note).
//  * K2, K4 and K1's layer loop run in one CTA: h, c and z live in shared
//    memory; every phase of a step ends with a __syncthreads(). Thread k
//    owns gate column k of (., 4n) (strided by blockDim when 4n is wider
//    than the block). Weights are row-major (Keras layout), so a warp reads
//    32 neighbouring columns of one row: the reads coalesce. They are read
//    through __ldg from global memory: a narrow stack stays L1-resident,
//    the wide ones come from L2 every step. Each thread's dot runs four
//    independent accumulators, so the FMA chain does not serialise on its
//    own latency. Splitting K2 and K4 over CTAs as K3 is split is later
//    work (ROADMAP).
//  * The gate update is one __device__ function (the counterpart of
//    models/lstm.py:gate_update), with expf/tanhf in f32. No fast math.
//
// Fast mode (template flag BF16, the TPU's single-pass precision=DEFAULT
// dot): every operand of an in-kernel product is rounded to bf16 by round to
// nearest even (__float2bfloat16_rn, as torch's .to(torch.bfloat16)), the
// products of two bf16 values are exact in float32 and accumulate in float32.
// The weights arrive rounded already, stored as __nv_bfloat16: rounding them
// once on the host is the same arithmetic as rounding them every step, and
// it halves the bytes each step reads. The vector operands are rounded where
// they are written into shared memory (h by the gate update or, in K3, as it
// is read back, x_t when it is staged, h·B and x·B when they are reduced),
// while the h that goes out, c, the bias and xp stay float32 and unrounded.
// In K2 and K4 on a wide layer a thread owns two neighbouring columns of z
// and reads both bf16 weights of a row in one 32-bit load (columns_bf16):
// the column phase issues half the loads of the exact kernels. With BF16 false every rounding is the
// identity at compile time and the column loops are the exact-mode code as
// before.
//
// Every launcher runs on the stream it is given, allocates nothing, and
// returns cudaGetLastError() for the Python wrapper to check.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_LAYERS 8
#define MAX_THREADS 1024

namespace {

// Weight storage and operand rounding of each mode.
template <bool BF16> struct Mode;
template <> struct Mode<false> {
  using W = float;
  static __device__ __forceinline__ float round(float v) { return v; }
};
template <> struct Mode<true> {
  using W = __nv_bfloat16;
  static __device__ __forceinline__ float round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
};

__device__ __forceinline__ float ldw(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ldw(const __nv_bfloat16* p) {
  return __bfloat162float(__ushort_as_bfloat16(__ldg(reinterpret_cast<const unsigned short*>(p))));
}

__device__ __forceinline__ float sigmoid_f32(float v) { return 1.0f / (1.0f + expf(-v)); }

// One cell from its four gate pre-activations: updates c, returns the new h.
__device__ __forceinline__ float gate_cell(float zi, float zf, float zg, float zo, float& c) {
  const float i = sigmoid_f32(zi);
  const float f = sigmoid_f32(zf);
  const float g = tanhf(zg);
  const float o = sigmoid_f32(zo);
  c = f * c + i * g;
  return o * tanhf(c);
}

// z: (4n) pre-activations [i|f|c|o]; updates c (n) in place and h (n) to the
// new h as the next products' operand (rounded in fast mode), and writes the
// unrounded h to out_row (global) when it is given. Callers sync before and
// after.
template <bool BF16>
__device__ __forceinline__ void gate_update(const float* z, float* h, float* c, int n,
                                            float* out_row) {
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    float cj = c[j];
    const float hn = gate_cell(z[j], z[n + j], z[2 * n + j], z[3 * n + j], cj);
    c[j] = cj;
    h[j] = Mode<BF16>::round(hn);
    if (out_row != nullptr) out_row[j] = hn;
  }
}

// acc += sum_j v[j] * M[j * ld + col] for j < len, with four accumulators.
// v lies in shared memory; M is a read-only global matrix.
template <typename WT>
__device__ __forceinline__ float dot_col(const float* v, const WT* __restrict__ M, int ld, int col,
                                         int len, float acc) {
  float a1 = 0.f, a2 = 0.f, a3 = 0.f;
  int j = 0;
  for (; j + 4 <= len; j += 4) {
    acc = fmaf(v[j], ldw(M + (size_t)j * ld + col), acc);
    a1 = fmaf(v[j + 1], ldw(M + (size_t)(j + 1) * ld + col), a1);
    a2 = fmaf(v[j + 2], ldw(M + (size_t)(j + 2) * ld + col), a2);
    a3 = fmaf(v[j + 3], ldw(M + (size_t)(j + 3) * ld + col), a3);
  }
  for (; j < len; ++j) acc = fmaf(v[j], ldw(M + (size_t)j * ld + col), acc);
  return (acc + a1) + (a2 + a3);
}

// Fast mode's counterpart of dot_col for the even column col and col + 1:
// one 32-bit load brings both bf16 weights of a row (exact conversion by
// shifting the bits into the high half of a float), so a thread issues one
// load per row for two columns, half as many as two dot_col calls. Two rows
// an iteration (four FMA chains): on the H100 that ran the single-CTA fast
// recurrence faster than four rows did (PERF.md).
__device__ __forceinline__ float2 dot_col2(const float* v, const __nv_bfloat16* __restrict__ M,
                                           int ld, int col, int len, float2 acc) {
  const unsigned int* P = reinterpret_cast<const unsigned int*>(M + col);
  const size_t ld2 = ld / 2;
  float2 a = make_float2(0.f, 0.f);
  auto fma2 = [](float s, unsigned int w, float2 c) {
    return make_float2(fmaf(s, __uint_as_float(w << 16), c.x),
                       fmaf(s, __uint_as_float(w & 0xffff0000u), c.y));
  };
  int j = 0;
  for (; j + 2 <= len; j += 2) {
    const unsigned int w0 = __ldg(P + j * ld2);
    const unsigned int w1 = __ldg(P + (j + 1) * ld2);
    acc = fma2(v[j], w0, acc);
    a = fma2(v[j + 1], w1, a);
  }
  if (j < len) acc = fma2(v[j], __ldg(P + j * ld2), acc);
  return make_float2(acc.x + a.x, acc.y + a.y);
}

// Fast mode's column phase: z[k] = init[k] + v0 · M0[:, k] (+ v1 · M1[:, k]
// when len1 > 0) for every column k < G. Where the block has at most half
// as many threads as columns, a thread takes neighbouring column pairs
// (dot_col2); on a narrow layer, where pairs would idle half the threads,
// one column each as in exact mode.
__device__ __forceinline__ void columns_bf16(float* z, const float* __restrict__ init, int G,
                                             const float* v0, const __nv_bfloat16* __restrict__ M0,
                                             int len0, const float* v1,
                                             const __nv_bfloat16* __restrict__ M1, int len1) {
  if (G >= 2 * (int)blockDim.x) {
    for (int k = 2 * threadIdx.x; k < G; k += 2 * blockDim.x) {
      float2 acc = dot_col2(v0, M0, G, k, len0, make_float2(__ldg(init + k), __ldg(init + k + 1)));
      if (len1 > 0) acc = dot_col2(v1, M1, G, k, len1, acc);
      z[k] = acc.x;
      z[k + 1] = acc.y;
    }
  } else {
    for (int k = threadIdx.x; k < G; k += blockDim.x) {
      const float acc = dot_col(v0, M0, G, k, len0, __ldg(init + k));
      z[k] = len1 > 0 ? dot_col(v1, M1, G, k, len1, acc) : acc;
    }
  }
}

// v · row for a contiguous row of len values, by one warp: lane-strided
// products, then a shuffle reduction. Every lane returns the sum.
template <typename WT>
__device__ __forceinline__ float dot_row_warp(const float* v, const WT* __restrict__ row, int len,
                                              int lane) {
  float acc = 0.f;
  for (int j = lane; j < len; j += 32) acc = fmaf(v[j], ldw(row + j), acc);
  for (int s = 16; s > 0; s >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, s);
  return acc;
}

template <bool BF16>
__device__ __forceinline__ void load_state(float* h, float* c, const float* h0, const float* c0,
                                           int n) {
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    h[j] = h0 != nullptr ? Mode<BF16>::round(h0[j]) : 0.f;
    c[j] = c0 != nullptr ? c0[j] : 0.f;
  }
}

template <typename WT>
struct StackArgs {
  int L;
  int din[MAX_LAYERS];
  int units[MAX_LAYERS];
  const WT* W[MAX_LAYERS];     // (din, 4n)
  const WT* U[MAX_LAYERS];     // (n, 4n)
  const float* b[MAX_LAYERS];  // (4n)
};

// ---------------------------------------------------------------------------
// K1's layer loop (fused_dense_stack_kernel) — for the stacks that
// dense_stack_wave below cannot take: more than 1024 units (3x512, reached
// only through bench/timing.py's "pallas" impl) or an input wider than its
// block (ops/cuda_lstm.py: dense_plan). Replaces, with it,
// svd_lstm_tpu/ops/pallas_lstm.py: fused_dense_stack_pallas. Per step, per
// layer, z = x_t·W + h·U + b and the gate update, layer i's new h feeding
// layer i+1 within the step. Only the last layer's h goes out; the head
// runs outside.
// Bound: the dependent chain of 2 barriers per layer-step plus a
// (din + n)-long dot per thread, the weights from L1/L2.
// Design: everything stays in one CTA for all T; x_{t+1} is staged into
// shared memory during the last layer's gate phase of step t, so staging
// adds no barrier.
// Shared memory: per layer h and c (2n), one z buffer (max 4n), x_t (d).
// ---------------------------------------------------------------------------
template <bool BF16>
__global__ void __launch_bounds__(MAX_THREADS)
fused_dense_stack_kernel(StackArgs<typename Mode<BF16>::W> a, const float* __restrict__ x,
                         float* __restrict__ out, int T, int d, int zmax) {
  extern __shared__ float smem[];
  float* hs[MAX_LAYERS];
  float* cs[MAX_LAYERS];
  int off = 0;
  for (int i = 0; i < a.L; ++i) {
    hs[i] = smem + off;
    off += a.units[i];
    cs[i] = smem + off;
    off += a.units[i];
  }
  for (int k = threadIdx.x; k < off; k += blockDim.x) smem[k] = 0.f;
  float* z = smem + off;
  float* xs = z + zmax;
  for (int k = threadIdx.x; k < d; k += blockDim.x) xs[k] = Mode<BF16>::round(x[k]);
  __syncthreads();

  const int last = a.L - 1;
  const int n_out = a.units[last];
  for (int t = 0; t < T; ++t) {
    const float* inp = xs;
    for (int i = 0; i < a.L; ++i) {
      const int n = a.units[i];
      const int G = 4 * n;
      // one column a thread in both modes: a narrow stack leaves no thread a
      // second column (the fast variant ran slower with columns_bf16 here)
      for (int k = threadIdx.x; k < G; k += blockDim.x) {
        float acc = dot_col(inp, a.W[i], G, k, a.din[i], __ldg(a.b[i] + k));
        z[k] = dot_col(hs[i], a.U[i], G, k, n, acc);
      }
      __syncthreads();
      gate_update<BF16>(z, hs[i], cs[i], n, i == last ? out + (size_t)t * n_out : nullptr);
      if (i == last && t + 1 < T) {
        // layer 0 read xs before this step's first barrier
        for (int k = threadIdx.x; k < d; k += blockDim.x)
          xs[k] = Mode<BF16>::round(x[(size_t)(t + 1) * d + k]);
      }
      __syncthreads();
      inp = hs[i];
    }
  }
}

// ---------------------------------------------------------------------------
// K1. dense_stack_wave — replaces svd_lstm_tpu/ops/pallas_lstm.py:
// fused_dense_stack_pallas for every stack of at most 1024 units (the
// wrapper's rule, ops/cuda_lstm.py: dense_plan). The whole dense stack for
// batch 1: per layer z = inp·W + h·U + b and the gate update; only the last
// layer's h goes out (T, n_out), the head runs outside.
//
// What bounds it: at one row every step reads every weight once and does
// (din + n)·4n multiply-adds a layer (28 800 at 4x30), so the chain of
// dependent steps is the bound, each step's latency: its loads, its dot, the
// sum across lanes, the gate math (expf, tanhf, IEEE divides) and a barrier.
// What the design does about it:
//  * The layers run as a wavefront: at step s layer i computes t = s - i,
//    from the state that step s - 1 wrote (h of the layer below at t, its
//    own h at t - 1), into the other parity; T + L - 1 steps, one barrier a
//    step (the layer loop has two a layer-step). One parity of the state is
//    the vector [x_t | h_0 | ... | h_{L-1}], one float an entry, so layer
//    i's input [h_{i-1} | h_i] (or [x | h_0]) is one contiguous range.
//    x_{s+1} is loaded at the top of step s and stored into the state at
//    its end. Both parities start at zero (h_{-1} = 0).
//  * A group of S lanes of one warp owns unit j of layer i and splits its
//    din + n terms (lane l takes k = l, l + S, ...) for all four gates; a
//    warp holds 32 / S units, lane-major (lane l of its groups at lanes
//    [l·32/S, (l + 1)·32/S)), so the groups of a warp read one state entry
//    at a time. sum_gates adds the lanes' partial sums by shuffles in a
//    fixed order (a tree over the lane index, the highest bit first) and
//    hands the owning lane (l = 0) all four; it runs the gate update with c
//    in a register for all T steps. z never touches shared memory.
//  * A lane stops at its last k < din + n, so it never reads the next
//    layer's h or weights (zero padding would let a NaN top layer leak
//    downwards, as 0·NaN is NaN).
//  * The weights, gate-interleaved as [k][j][4] (one 16-byte load, 8 in fast
//    mode, gives unit j's four gates at input k; the 32 / S groups of a warp
//    read neighbouring units), come from the wrapper's packed copy P of all
//    layers (ops/cuda_lstm.py: pack_wave), where HOME says:
//      kRegs   — each lane loads its at most WAVE_REG_KB entries into
//                registers once (indexed at compile time), at most
//                WAVE_REG_THREADS threads (4x30 at S = 4: 15 entries, 480
//                threads);
//      kStaged — P is staged into shared memory once (4x40 exact: 189 KB);
//      kGlobal — P is read through __ldg from L1/L2 every step (4x128, and
//                (128,) in exact mode).
//    The wrapper's rule takes the registers where they hold a lane's
//    entries, else shared memory where P fits, else the global copy.
// Fast mode (BF16): P holds bf16 weights; x_t and h are rounded to bf16
// where they are written into the state; c, the bias and the h that goes
// out stay float32.
// Measured on the H100 (PERF.md §6), by taking one part of the step
// out at a time: at 4x30 (registers, S = 4) a step takes ~0.95 us, of which
// the gate math ~0.22, the dot ~0.22 and the shuffles ~0.11; without the
// barrier it takes as long, so each warp's own chain through the step sets
// it. At 4x40 (staged) ~1.75 us, ~0.96 of it the dot's shared-memory loads:
// the registers home ran 1.5x faster than the staged one at 4x30.
// ---------------------------------------------------------------------------
#define WAVE_REG_KB 16        // entries a lane holds in registers (kRegs)
#define WAVE_REG_THREADS 512  // the block of kRegs: 128 registers a thread

enum WaveHome { kRegs = 0, kStaged = 1, kGlobal = 2 };

// One [k][j] entry of P: unit j's four gate weights at input k.
template <bool BF16> struct WaveEntry;
template <> struct WaveEntry<false> {
  using E = float4;
  static __device__ __forceinline__ float4 unpack(float4 e) { return e; }
};
template <> struct WaveEntry<true> {
  using E = uint2;  // four bf16, gate 0 in the low half of x
  static __device__ __forceinline__ float4 unpack(uint2 e) {
    return make_float4(__uint_as_float(e.x << 16), __uint_as_float(e.x & 0xffff0000u),
                       __uint_as_float(e.y << 16), __uint_as_float(e.y & 0xffff0000u));
  }
};

struct WaveLayer {
  int din, n;
  int w_off;       // first entry of the layer's (din + n) x n entries in P
  const float* b;  // (4n)
};

struct WaveArgs {
  int L;
  WaveLayer l[MAX_LAYERS];
};

// One exchange of a reduce-scatter over the lane group: the lane keeps the
// lower or upper half of v[0, 2·HALF) (its bit says which) and adds the
// partner's copy of that half; the kept half moves to v[0, HALF).
template <int HALF>
__device__ __forceinline__ void keep_half(float (&v)[4], bool upper, int offset, unsigned mask) {
#pragma unroll
  for (int q = 0; q < HALF; ++q) {
    const float send = upper ? v[q] : v[q + HALF];
    const float keep = upper ? v[q + HALF] : v[q];
    v[q] = keep + __shfl_xor_sync(mask, send, offset);
  }
}

// Sums the group's four partial gate sums v[0..3] over its S lanes: a
// reduce-scatter (the pair across the highest lane bit first, so every sum
// is the same tree over the lane index, in a fixed order), after which the
// owning lane (l = 0) gathers the other gates; only its v is complete.
template <int S>
__device__ __forceinline__ void sum_gates(float (&v)[4], int l, int lane, unsigned mask) {
  constexpr int G = 32 / S;  // lane l' of a group sits at warp lane l'·G + its group
  const int base = lane % G;
  if constexpr (S == 2) {
    keep_half<2>(v, l & 1, G, mask);  // l = 0: gates 0, 1; l = 1: gates 2, 3
    const float g2 = __shfl_xor_sync(mask, v[0], G), g3 = __shfl_xor_sync(mask, v[1], G);
    v[2] = g2;
    v[3] = g3;
  } else if constexpr (S == 4) {
    keep_half<2>(v, (l >> 1) & 1, 2 * G, mask);
    keep_half<1>(v, l & 1, G, mask);  // lane l: gate l
    const float g1 = __shfl_sync(mask, v[0], base + G);
    const float g2 = __shfl_sync(mask, v[0], base + 2 * G);
    const float g3 = __shfl_sync(mask, v[0], base + 3 * G);
    v[1] = g1;
    v[2] = g2;
    v[3] = g3;
  } else if constexpr (S == 8) {
    keep_half<2>(v, (l >> 2) & 1, 4 * G, mask);
    keep_half<1>(v, (l >> 1) & 1, 2 * G, mask);
    v[0] += __shfl_xor_sync(mask, v[0], G);  // lanes 2q, 2q + 1: gate q
    const float g1 = __shfl_sync(mask, v[0], base + 2 * G);
    const float g2 = __shfl_sync(mask, v[0], base + 4 * G);
    const float g3 = __shfl_sync(mask, v[0], base + 6 * G);
    v[1] = g1;
    v[2] = g2;
    v[3] = g3;
  }
}

template <bool BF16, int S, int HOME>
__global__ void __launch_bounds__(HOME == kRegs ? WAVE_REG_THREADS : MAX_THREADS)
dense_stack_wave(WaveArgs a, const typename WaveEntry<BF16>::E* __restrict__ P,
                 const float* __restrict__ x, float* __restrict__ out, int T, int d, int V,
                 int E) {
  using Ent = typename WaveEntry<BF16>::E;
  extern __shared__ float4 wave_smem[];
  constexpr int G = 32 / S;
  const int tid = threadIdx.x, lane = tid & 31, l = lane / G, g = (tid >> 5) * G + lane % G;

  // this thread's unit: layer li, unit j; its entries from w_off, its h at h_off
  int li = -1, j = 0, w_off = 0, h_off = 0;
  {
    int u = 0, so = d;
    for (int i = 0; i < a.L; ++i) {
      const int n = a.l[i].n;
      if (li < 0 && g < u + n) {
        li = i;
        j = g - u;
        w_off = a.l[i].w_off;
        h_off = so;
      }
      u += n;
      so += n;
    }
  }

  Ent* ws = reinterpret_cast<Ent*>(wave_smem);
  float* state = reinterpret_cast<float*>(wave_smem);  // two parities of V floats
  if constexpr (HOME == kStaged) {
    for (int e = tid; e < E; e += blockDim.x) ws[e] = P[e];
    state = reinterpret_cast<float*>(ws + E);
  }
  // zeros, and x_0 into parity 1 (read at s = 0)
  for (int e = tid; e < 2 * V; e += blockDim.x)
    state[e] = e >= V && e - V < d ? Mode<BF16>::round(x[e - V]) : 0.f;

  const bool unit = li >= 0;
  const int n = unit ? a.l[li].n : 0;
  const int din = unit ? a.l[li].din : 0;
  const int in_off = h_off - din;
  const int KB = unit ? (din + n - l + S - 1) / S : 0;  // this lane's k = l + kb·S < din + n
  const int w_stride = n * S;                            // entries from one of its k to the next
  const Ent* wp = (HOME == kStaged ? ws : P) + w_off + l * n + j;
  float4 wr[HOME == kRegs ? WAVE_REG_KB : 1];
  if constexpr (HOME == kRegs) {
#pragma unroll
    for (int kb = 0; kb < WAVE_REG_KB; ++kb)
      wr[kb] = kb < KB ? WaveEntry<BF16>::unpack(__ldg(wp + kb * w_stride))
                       : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float bias[4] = {0.f, 0.f, 0.f, 0.f};
  if (unit) {
#pragma unroll
    for (int q = 0; q < 4; ++q) bias[q] = __ldg(a.l[li].b + q * n + j);
  }
  unsigned mask = 0;  // the group's lanes
#pragma unroll
  for (int q = 0; q < S; ++q) mask |= 1u << (q * G + lane % G);
  const bool owner = l == 0;
  const bool last = unit && li == a.L - 1;
  const bool stager = tid < d;
  float c = 0.f;
  __syncthreads();

  const int steps = T + a.L - 1;
  for (int s = 0; s < steps; ++s) {
    const int Pr = (s + 1) & 1, Q = s & 1;  // read parity, write parity
    float xn = 0.f;
    if (stager && s + 1 < T) xn = x[(size_t)(s + 1) * d + tid];
    const int t = s - li;
    if (unit && t >= 0 && t < T) {
      float v[4] = {0.f, 0.f, 0.f, 0.f};
      const float* sp = state + Pr * V + in_off + l;
      if constexpr (HOME == kRegs) {
#pragma unroll
        for (int kb = 0; kb < WAVE_REG_KB; ++kb) {
          if (kb < KB) {
            const float hv = sp[kb * S];
            v[0] = fmaf(hv, wr[kb].x, v[0]);
            v[1] = fmaf(hv, wr[kb].y, v[1]);
            v[2] = fmaf(hv, wr[kb].z, v[2]);
            v[3] = fmaf(hv, wr[kb].w, v[3]);
          }
        }
      } else {
#pragma unroll 4
        for (int kb = 0; kb < KB; ++kb) {
          const float hv = sp[kb * S];
          float4 w;
          if constexpr (HOME == kStaged) {
            w = WaveEntry<BF16>::unpack(wp[kb * w_stride]);
          } else {
            w = WaveEntry<BF16>::unpack(__ldg(wp + kb * w_stride));
          }
          v[0] = fmaf(hv, w.x, v[0]);
          v[1] = fmaf(hv, w.y, v[1]);
          v[2] = fmaf(hv, w.z, v[2]);
          v[3] = fmaf(hv, w.w, v[3]);
        }
      }
      sum_gates<S>(v, l, lane, mask);
      if (owner) {
        const float hn =
            gate_cell(v[0] + bias[0], v[1] + bias[1], v[2] + bias[2], v[3] + bias[3], c);
        state[Q * V + h_off + j] = Mode<BF16>::round(hn);
        if (last) out[(size_t)t * n + j] = hn;
      }
    }
    if (stager && s + 1 < T) state[Q * V + tid] = Mode<BF16>::round(xn);
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// K2. reduced_recurrence — replaces svd_lstm_tpu/ops/pallas_lstm.py:
// reduced_recurrence_pallas. Low-rank h-side recurrence, batch 1:
//   hb = h·B (R outputs), z = xp_t + hb·IC, gate update.
// Merged: B (n, r), IC = [I|C] (r, 4n). Split: the wrapper packs
// B = [B_i|B_f|B_g|B_o] (n, sum r_g) and a block-diagonal IC (sum r_g, 4n)
// holding fold_IC(B_g, C_g) in gate g's rows and columns; the zero blocks
// add exact zeros, so one body serves both forms.
// B arrives transposed, Bt (R, n), so that a warp reads one contiguous row.
// In fast mode hb is rounded to bf16 before the second product: on the TPU
// it is the operand of the second single-pass dot.
// Bound: two dependent phases per step; at 3x512 r=24 the operands are
// 48 KB + 192 KB (half that in bf16), read from L1/L2 each step.
// Design: phase 1 gives one warp per output of hb with a shuffle
// reduction over n; phase 2 is one thread per column of z.
// Shared memory: h, c (n each), hb (R), z (4n).
// ---------------------------------------------------------------------------
template <bool BF16>
__global__ void __launch_bounds__(MAX_THREADS)
reduced_recurrence_kernel(const float* __restrict__ xp,
                          const typename Mode<BF16>::W* __restrict__ Bt,
                          const typename Mode<BF16>::W* __restrict__ IC,
                          const float* __restrict__ h0, const float* __restrict__ c0,
                          float* __restrict__ out, int T, int n, int R) {
  extern __shared__ float smem[];
  float* h = smem;
  float* c = h + n;
  float* hb = c + n;
  float* z = hb + R;
  const int G = 4 * n;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  load_state<BF16>(h, c, h0, c0, n);
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    for (int q = warp; q < R; q += nwarps) {  // warp-uniform loop
      const float acc = dot_row_warp(h, Bt + (size_t)q * n, n, lane);
      if (lane == 0) hb[q] = Mode<BF16>::round(acc);
    }
    __syncthreads();
    const float* xpt = xp + (size_t)t * G;
    if constexpr (BF16) {
      columns_bf16(z, xpt, G, hb, IC, R, nullptr, nullptr, 0);
    } else {
      for (int k = threadIdx.x; k < G; k += blockDim.x) z[k] = dot_col(hb, IC, G, k, R, __ldg(xpt + k));
    }
    __syncthreads();
    gate_update<BF16>(z, h, c, n, out + (size_t)t * n);
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// K3. recurrence_chain — replaces svd_lstm_tpu/ops/pallas_lstm.py:
// lstm_recurrence_pallas. Dense h-side recurrence of one layer, batch 1,
// from the hoisted input projection: z_t = xp_t + h_{t-1}·U, the gate
// update; h_t goes out unrounded (T, n).
//
// What bounds it: U is (n, 4n), 4 MB of f32 at n = 512 (2 MB bf16), and
// every unit of h_t needs all of h_{t-1}, so each step is a grid-wide
// dependency of n·4n multiply-adds (2.1 MFLOP at n = 512: 31 ns at 67
// TFLOP/s). The chain of T steps is the bound: per step one exchange of h
// between the SMs, the dot's latency, the gate math. One CTA reading all of
// U from L2 every step (the design before) took 34.0 us a step.
// What the design does about it:
//  * U stays on chip, split over the SMs: a CTA owns J units (one warp a
//    unit) and all four gate columns of them, so the gate update and c stay
//    in the owning lane's registers for all T steps. The wrapper packs U
//    unit-major as P[j][k] = (U[k, j], U[k, n + j], U[k, 2n + j],
//    U[k, 3n + j]) (ops/cuda_lstm.py: pack_recurrence); lane l of unit j's
//    warp takes k = l, l + 32, ... < n, and its entries live where HOME
//    says (the wrapper's rule, ops/cuda_lstm.py: recurrence_plan):
//      kRegs   — loaded once into registers (at most REC_REG_KB entries a
//                lane, n <= 512; REC_REG_THREADS threads at most);
//      kStaged — the CTA's J rows of P staged in shared memory once;
//      kGlobal — read through __ldg from L1/L2 every step (past what fits).
//  * One persistent cooperative launch for all T steps, one grid.sync() a
//    step. The owning lane publishes h_t to out[t] (float32, unrounded);
//    after the barrier every CTA reads all of h_t back through L2
//    (ld.global.cg, never the non-coherent path) into shared memory,
//    rounded to bf16 in fast mode, as the next step's operand. Step 0
//    reads h0 (zeros when absent); c0 seeds the registers. xp_t is loaded
//    before the barrier, as it does not depend on it. The grid, ceil(n / J)
//    CTAs, is checked against the occupancy API and the SM count, and
//    refused when it cannot be co-resident, never run another way.
//  * The dot runs on the CUDA cores in float32 (exact mode keeps TF32 off;
//    one row gains nothing from mma): each lane one FMA chain a gate, the
//    32 lanes' partial sums added by shuffles in a fixed tree over the lane
//    index, the highest bit first (a reduce-scatter that leaves gate g on
//    lanes 8g..8g+7, which add its xp_t and take its activation; lane 0
//    gathers the four and updates c and h). Units past n are masked
//    (their warps only load h and meet the barrier).
// Measured on the H100 (PERF.md §6) at n = 512, T = 6656 (J = 4, 128
// CTAs of 128 threads, the weights in 108 registers a thread): ~2.0 us a
// step, 13.1–13.7 ms a layer against cuDNN's ~76 and 231 before. Taken out
// one at a time: the grid barrier, with the wait for the slowest CTA,
// ~0.96 us; the gate math ~0.28 (on lane 0 alone: over four lanes it ran
// 3–4 % faster); h's load through L2 ~0.25; the dot ~0.07.
// J = 8 ran 2–3 % slower, J = 2 23 %; the staged weights 12 %, the global
// copy 1.7x (exact) to 2.1x (fast). Two other exchanges ran slower and
// were dropped: a 16-CTA cluster for the fast variant (U's bf16 rows
// staged, h pushed into every CTA through distributed shared memory, one
// cluster barrier a step: 1.5x), and h sent with its step's tag in one
// 64-bit word, each CTA waiting only for the values it reads, no grid
// barrier (as fast in exact mode, 8 % slower fast): the step waits on the
// exchange's latency, not on the barrier's bookkeeping.
// ---------------------------------------------------------------------------
#define REC_REG_KB 16         // entries a lane holds in registers (kRegs): n <= 512
#define REC_REG_THREADS 256   // the block of kRegs (J <= 8 units)
#define REC_MAX_UNITS 32      // a warp a unit, at most 1024 threads

// Sums the four partial gate sums v[0..3] of a warp's 32 lanes by a
// reduce-scatter (the pair across the highest lane bit first, so every sum
// is the same tree over the lane index): lanes 8g..8g+7 return gate g's.
__device__ __forceinline__ float sum_warp_gate(float (&v)[4], int lane) {
  keep_half<2>(v, (lane >> 4) & 1, 16, 0xffffffffu);  // bit 4: gates {0, 1} or {2, 3}
  keep_half<1>(v, (lane >> 3) & 1, 8, 0xffffffffu);   // bit 3: one gate of the pair
  v[0] += __shfl_xor_sync(0xffffffffu, v[0], 4);
  v[0] += __shfl_xor_sync(0xffffffffu, v[0], 2);
  v[0] += __shfl_xor_sync(0xffffffffu, v[0], 1);
  return v[0];
}

// floats of h in shared memory: n rounded up to the 32 lanes, zeros past n
__host__ __device__ __forceinline__ int rec_kp(int n) { return (n + 31) / 32 * 32; }

template <bool BF16, int HOME>
__global__ void __launch_bounds__(HOME == kRegs ? REC_REG_THREADS : MAX_THREADS)
recurrence_chain(const float* __restrict__ xp, const typename WaveEntry<BF16>::E* __restrict__ P,
                 const float* __restrict__ h0, const float* __restrict__ c0, float* out, int T,
                 int n) {
  using Ent = typename WaveEntry<BF16>::E;
  extern __shared__ float4 rec_smem[];
  const int J = blockDim.x >> 5;
  const int tid = threadIdx.x, lane = tid & 31;
  const int j = blockIdx.x * J + (tid >> 5);  // this warp's unit
  const int Kp = rec_kp(n);
  const bool unit = j < n;
  const int KL = (n - lane + 31) / 32;  // this lane's k = lane + 32·kb < n
  float* hs = reinterpret_cast<float*>(rec_smem);  // h_{t-1}: Kp floats
  Ent* ws = reinterpret_cast<Ent*>(hs + Kp);        // kStaged: J rows of Kp entries

  const Ent* wp = P + (size_t)(unit ? j : 0) * n + lane;
  if constexpr (HOME == kStaged) {
    for (int e = tid; e < J * Kp; e += blockDim.x) {
      const int r = e / Kp, k = e - r * Kp, jr = blockIdx.x * J + r;
      Ent w{};
      if (jr < n && k < n) w = __ldg(P + (size_t)jr * n + k);
      ws[e] = w;
    }
    wp = ws + (tid >> 5) * Kp + lane;
  }
  float4 wr[HOME == kRegs ? REC_REG_KB : 1];
  if constexpr (HOME == kRegs) {
#pragma unroll
    for (int kb = 0; kb < REC_REG_KB; ++kb)
      wr[kb] = unit && kb < KL ? WaveEntry<BF16>::unpack(__ldg(wp + 32 * kb))
                               : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  for (int k = tid; k < Kp; k += blockDim.x)
    hs[k] = h0 != nullptr && k < n ? Mode<BF16>::round(h0[k]) : 0.f;
  float c = unit && c0 != nullptr ? c0[j] : 0.f;  // the owning lane's (lane 0)
  const bool vec = (n & 3) == 0;
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    float xg = 0.f;  // lane 8g: gate g's xp_t
    if (unit && (lane & 7) == 0) xg = __ldg(xp + (size_t)t * 4 * n + (lane >> 3) * n + j);
    if (t > 0) {
      cooperative_groups::this_grid().sync();  // h_{t-1} complete
      const float* hp = out + (size_t)(t - 1) * n;
      if (vec) {
        for (int k = 4 * tid; k < n; k += 4 * blockDim.x) {
          const float4 v = __ldcg(reinterpret_cast<const float4*>(hp + k));
          hs[k] = Mode<BF16>::round(v.x);
          hs[k + 1] = Mode<BF16>::round(v.y);
          hs[k + 2] = Mode<BF16>::round(v.z);
          hs[k + 3] = Mode<BF16>::round(v.w);
        }
      } else {
        for (int k = tid; k < n; k += blockDim.x) hs[k] = Mode<BF16>::round(__ldcg(hp + k));
      }
      __syncthreads();
    }
    if (!unit) continue;  // warp-uniform
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    const float* sp = hs + lane;
    if constexpr (HOME == kRegs) {
#pragma unroll
      for (int kb = 0; kb < REC_REG_KB; ++kb) {
        if (kb < KL) {
          const float hv = sp[32 * kb];
          v[0] = fmaf(hv, wr[kb].x, v[0]);
          v[1] = fmaf(hv, wr[kb].y, v[1]);
          v[2] = fmaf(hv, wr[kb].z, v[2]);
          v[3] = fmaf(hv, wr[kb].w, v[3]);
        }
      }
    } else {
#pragma unroll 4
      for (int kb = 0; kb < KL; ++kb) {
        const float hv = sp[32 * kb];
        float4 w;
        if constexpr (HOME == kStaged) {
          w = WaveEntry<BF16>::unpack(wp[32 * kb]);
        } else {
          w = WaveEntry<BF16>::unpack(__ldg(wp + 32 * kb));
        }
        v[0] = fmaf(hv, w.x, v[0]);
        v[1] = fmaf(hv, w.y, v[1]);
        v[2] = fmaf(hv, w.z, v[2]);
        v[3] = fmaf(hv, w.w, v[3]);
      }
    }
    // gate_cell's arithmetic, each gate's activation on its own lanes
    const float z = sum_warp_gate(v, lane) + xg;
    const float a = (lane >> 3) == 2 ? tanhf(z) : sigmoid_f32(z);
    const float ai = __shfl_sync(0xffffffffu, a, 0), af = __shfl_sync(0xffffffffu, a, 8);
    const float ag = __shfl_sync(0xffffffffu, a, 16), ao = __shfl_sync(0xffffffffu, a, 24);
    if (lane == 0) {
      c = af * c + ai * ag;
      out[(size_t)t * n + j] = ao * tanhf(c);
    }
  }
}

template <typename WT>
struct ReducedStackArgs {
  int L;
  int din[MAX_LAYERS];
  int units[MAX_LAYERS];
  int rw[MAX_LAYERS];          // packed input-side rank
  int ru[MAX_LAYERS];          // packed recurrent-side rank
  const WT* wBt[MAX_LAYERS];   // (rw, din)
  const WT* wIC[MAX_LAYERS];   // (rw, 4n)
  const WT* uBt[MAX_LAYERS];   // (ru, n)
  const WT* uIC[MAX_LAYERS];   // (ru, 4n)
  const float* b[MAX_LAYERS];  // (4n)
};

// ---------------------------------------------------------------------------
// K4. fused_reduced_stack — replaces svd_lstm_tpu/ops/pallas_lstm.py:
// fused_reduced_stack_pallas. The whole reduced stack for batch 1, factored
// on both sides: per step, per layer,
//   z = (inp·wB)·[I|wC] + (h·uB)·[I|uC] + b
// and the gate update; layer i's new h feeds layer i+1 within the step, the
// head runs outside. Each side is packed as K2 packs its h-side (transposed
// B, and for split layers the block-diagonal [I|C] of the four gates), so
// one body serves merged and split layers.
// Bound: the dependent chain. A layer-step has three barriers against K1's
// two: phase 1 computes xb = inp·wB and hb = h·uB together (one warp per
// output, rw + ru of them), phase 2 the 4n columns of z from both (one
// thread per column), phase 3 the gate update. At 3x512 r=24 the operands
// of a layer-step are about 0.5 MB (f32), read from L2; narrow stacks stay
// in L1.
// Design: as K1, one CTA for all T and all layers; x_{t+1} is staged in the
// last layer's gate phase. In fast mode xb and hb are rounded to bf16
// before their second products, as the TPU's second dots take them.
// Shared memory: per layer h and c (2n), one z buffer (max 4n), one buffer
// for [xb|hb] (max rw + ru), x_t (d).
// ---------------------------------------------------------------------------
template <bool BF16>
__global__ void __launch_bounds__(MAX_THREADS)
fused_reduced_stack_kernel(ReducedStackArgs<typename Mode<BF16>::W> a,
                           const float* __restrict__ x, float* __restrict__ out, int T, int d,
                           int zmax, int rmax) {
  extern __shared__ float smem[];
  float* hs[MAX_LAYERS];
  float* cs[MAX_LAYERS];
  int off = 0;
  for (int i = 0; i < a.L; ++i) {
    hs[i] = smem + off;
    off += a.units[i];
    cs[i] = smem + off;
    off += a.units[i];
  }
  for (int k = threadIdx.x; k < off; k += blockDim.x) smem[k] = 0.f;
  float* z = smem + off;
  float* vb = z + zmax;  // [xb | hb] of the current layer
  float* xs = vb + rmax;
  for (int k = threadIdx.x; k < d; k += blockDim.x) xs[k] = Mode<BF16>::round(x[k]);
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int last = a.L - 1;
  const int n_out = a.units[last];
  for (int t = 0; t < T; ++t) {
    const float* inp = xs;
    for (int i = 0; i < a.L; ++i) {
      const int n = a.units[i];
      const int G = 4 * n;
      const int rw = a.rw[i];
      for (int q = warp; q < rw + a.ru[i]; q += nwarps) {  // warp-uniform loop
        const float acc = q < rw ? dot_row_warp(inp, a.wBt[i] + (size_t)q * a.din[i], a.din[i], lane)
                                 : dot_row_warp(hs[i], a.uBt[i] + (size_t)(q - rw) * n, n, lane);
        if (lane == 0) vb[q] = Mode<BF16>::round(acc);
      }
      __syncthreads();
      if constexpr (BF16) {
        columns_bf16(z, a.b[i], G, vb, a.wIC[i], rw, vb + rw, a.uIC[i], a.ru[i]);
      } else {
        for (int k = threadIdx.x; k < G; k += blockDim.x) {
          const float acc = dot_col(vb, a.wIC[i], G, k, rw, __ldg(a.b[i] + k));
          z[k] = dot_col(vb + rw, a.uIC[i], G, k, a.ru[i], acc);
        }
      }
      __syncthreads();
      gate_update<BF16>(z, hs[i], cs[i], n, i == last ? out + (size_t)t * n_out : nullptr);
      if (i == last && t + 1 < T) {
        // layer 0 read xs before this step's first barrier
        for (int k = threadIdx.x; k < d; k += blockDim.x)
          xs[k] = Mode<BF16>::round(x[(size_t)(t + 1) * d + k]);
      }
      __syncthreads();
      inp = hs[i];
    }
  }
}

int block_threads(int columns) {
  int t = ((columns + 31) / 32) * 32;
  return t > MAX_THREADS ? MAX_THREADS : t;
}

// Above 48 KB a kernel needs its dynamic shared memory raised first.
template <typename K>
cudaError_t prepare_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <bool BF16>
int launch_dense_stack(const int64_t* meta, int L, const void* x, void* out, int T, int d,
                       cudaStream_t stream) {
  using WT = typename Mode<BF16>::W;
  StackArgs<WT> a;
  a.L = L;
  int state = 0, zmax = 0;
  for (int i = 0; i < L; ++i) {
    a.din[i] = (int)meta[5 * i + 0];
    a.units[i] = (int)meta[5 * i + 1];
    a.W[i] = reinterpret_cast<const WT*>(meta[5 * i + 2]);
    a.U[i] = reinterpret_cast<const WT*>(meta[5 * i + 3]);
    a.b[i] = reinterpret_cast<const float*>(meta[5 * i + 4]);
    state += 2 * a.units[i];
    if (4 * a.units[i] > zmax) zmax = 4 * a.units[i];
  }
  const size_t smem = (size_t)(state + zmax + d) * sizeof(float);
  cudaError_t err = prepare_smem(fused_dense_stack_kernel<BF16>, smem);
  if (err != cudaSuccess) return (int)err;
  fused_dense_stack_kernel<BF16><<<1, block_threads(zmax), smem, stream>>>(
      a, (const float*)x, (float*)out, T, d, zmax);
  return (int)cudaGetLastError();
}

// threads of dense_stack_wave's block: S lanes for every unit, and one
// thread for each input entry that x_{s+1} stages (ops/cuda_lstm.py:
// wave_threads)
int wave_threads(int nsum, int d, int S) {
  const int units = (S * nsum + 31) / 32 * 32, stagers = (d + 31) / 32 * 32;
  return units > stagers ? units : stagers;
}

template <bool BF16, int S, int HOME>
int launch_wave(const WaveArgs& a, const void* P, const float* x, float* out, int T, int d, int V,
                int E, int threads, size_t smem, cudaStream_t stream) {
  using Ent = typename WaveEntry<BF16>::E;
  const auto kernel = dense_stack_wave<BF16, S, HOME>;
  cudaError_t err = prepare_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<1, threads, smem, stream>>>(a, (const Ent*)P, x, out, T, d, V, E);
  return (int)cudaGetLastError();
}

// Checks what the wrapper chose (lanes S, the weights' home) against the
// block: S·Σn lanes and the x stagers within the block, a lane's entries
// within WAVE_REG_KB in registers, P within shared memory when staged.
template <bool BF16>
int launch_dense_wave(const WaveArgs& a, const void* P, int E, const float* x, float* out, int T,
                      int d, int S, int home, cudaStream_t s) {
  using Ent = typename WaveEntry<BF16>::E;
  int nsum = 0, kb = 0, entries = 0;
  for (int i = 0; i < a.L; ++i) {
    const WaveLayer& ly = a.l[i];
    if (ly.din < 1 || ly.n < 1 || ly.w_off != entries) return (int)cudaErrorInvalidValue;
    entries += (ly.din + ly.n) * ly.n;
    nsum += ly.n;
    const int k = (ly.din + ly.n + S - 1) / S;
    if (k > kb) kb = k;
  }
  const int threads = wave_threads(nsum, d, S);
  const int V = d + nsum;
  const size_t smem = (home == kStaged ? (size_t)E * sizeof(Ent) : 0) + 2 * (size_t)V * sizeof(float);
  if ((S != 1 && S != 2 && S != 4 && S != 8) || E != entries || threads > MAX_THREADS ||
      (home == kRegs && (threads > WAVE_REG_THREADS || kb > WAVE_REG_KB)) ||
      (home != kRegs && home != kStaged && home != kGlobal) || smem > 232448)
    return (int)cudaErrorInvalidValue;
#define WAVE_CASE(S_, H_)                                                                  \
  if (S == S_ && home == H_)                                                               \
    return launch_wave<BF16, S_, H_>(a, P, x, out, T, d, V, E, threads, smem, s);
  WAVE_CASE(1, kRegs) WAVE_CASE(1, kStaged) WAVE_CASE(1, kGlobal)
  WAVE_CASE(2, kRegs) WAVE_CASE(2, kStaged) WAVE_CASE(2, kGlobal)
  WAVE_CASE(4, kRegs) WAVE_CASE(4, kStaged) WAVE_CASE(4, kGlobal)
  WAVE_CASE(8, kRegs) WAVE_CASE(8, kStaged) WAVE_CASE(8, kGlobal)
#undef WAVE_CASE
  return (int)cudaErrorInvalidValue;
}

template <bool BF16>
int launch_reduced_recurrence(const void* xp, const void* Bt, const void* IC, const void* h0,
                              const void* c0, void* out, int T, int n, int R,
                              cudaStream_t stream) {
  using WT = typename Mode<BF16>::W;
  const size_t smem = (size_t)(2 * n + R + 4 * n) * sizeof(float);
  cudaError_t err = prepare_smem(reduced_recurrence_kernel<BF16>, smem);
  if (err != cudaSuccess) return (int)err;
  reduced_recurrence_kernel<BF16><<<1, block_threads(4 * n), smem, stream>>>(
      (const float*)xp, (const WT*)Bt, (const WT*)IC, (const float*)h0, (const float*)c0,
      (float*)out, T, n, R);
  return (int)cudaGetLastError();
}

// shared memory of recurrence_chain: h (Kp floats) and, staged, the CTA's
// J rows of Kp entries (16 bytes, 8 in fast mode; ops/cuda_lstm.py:
// recurrence_smem_bytes)
size_t rec_smem_bytes(int n, int units, int home, bool bf16) {
  const size_t kp = (size_t)rec_kp(n);
  return kp * sizeof(float) + (home == kStaged ? (size_t)units * kp * (bf16 ? 8 : 16) : 0);
}

template <bool BF16, int HOME>
int rec_occupancy(int n, int units, int* per_sm) {
  const auto kernel = recurrence_chain<BF16, HOME>;
  const size_t smem = rec_smem_bytes(n, units, HOME, BF16);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, 32 * units, smem);
}

// Checks co-residency (every CTA of the grid on the card at once, from the
// occupancy of this kernel and the device's SM count), then the
// cooperative launch.
template <bool BF16, int HOME>
int launch_chain(const float* xp, const void* P_, const float* h0, const float* c0, float* out,
                 int T, int n, int units, cudaStream_t s) {
  using Ent = typename WaveEntry<BF16>::E;
  int per_sm = 0, dev = 0, sms = 0;
  int err = rec_occupancy<BF16, HOME>(n, units, &per_sm);
  if (err != (int)cudaSuccess) return err;
  cudaError_t e;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)e;
  const int ctas = (n + units - 1) / units;
  if (per_sm < 1 || (long long)ctas > (long long)per_sm * sms)
    return (int)cudaErrorCooperativeLaunchTooLarge;
  const Ent* P = (const Ent*)P_;
  void* args[] = {(void*)&xp, (void*)&P, (void*)&h0, (void*)&c0, (void*)&out, (void*)&T, (void*)&n};
  e = cudaLaunchCooperativeKernel((const void*)recurrence_chain<BF16, HOME>, dim3(ctas),
                                  dim3(32 * units), args, rec_smem_bytes(n, units, HOME, BF16), s);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// Checks what the wrapper's plan chose (units J, the weights' home)
// against the kernel: a warp a unit within the block (REC_REG_THREADS for
// the registers home), a lane's entries within REC_REG_KB in registers,
// the shared memory within a block's 227 KB.
int rec_plan_ok(int n, int units, int home, bool bf16) {
  const int threads = 32 * units;
  return n >= 1 && units >= 1 && units <= REC_MAX_UNITS &&
         (home == kRegs || home == kStaged || home == kGlobal) &&
         (home != kRegs || (threads <= REC_REG_THREADS && rec_kp(n) / 32 <= REC_REG_KB)) &&
         rec_smem_bytes(n, units, home, bf16) <= 232448;
}

template <bool BF16>
int launch_reduced_stack(const int64_t* meta, int L, const void* x, void* out, int T, int d,
                         cudaStream_t stream) {
  using WT = typename Mode<BF16>::W;
  ReducedStackArgs<WT> a;
  a.L = L;
  int state = 0, zmax = 0, rmax = 0;
  for (int i = 0; i < L; ++i) {
    const int64_t* m = meta + 9 * i;
    a.din[i] = (int)m[0];
    a.units[i] = (int)m[1];
    a.rw[i] = (int)m[2];
    a.ru[i] = (int)m[3];
    a.wBt[i] = reinterpret_cast<const WT*>(m[4]);
    a.wIC[i] = reinterpret_cast<const WT*>(m[5]);
    a.uBt[i] = reinterpret_cast<const WT*>(m[6]);
    a.uIC[i] = reinterpret_cast<const WT*>(m[7]);
    a.b[i] = reinterpret_cast<const float*>(m[8]);
    state += 2 * a.units[i];
    if (4 * a.units[i] > zmax) zmax = 4 * a.units[i];
    if (a.rw[i] + a.ru[i] > rmax) rmax = a.rw[i] + a.ru[i];
  }
  const size_t smem = (size_t)(state + zmax + rmax + d) * sizeof(float);
  cudaError_t err = prepare_smem(fused_reduced_stack_kernel<BF16>, smem);
  if (err != cudaSuccess) return (int)err;
  // one warp per output of phase 1 where the ranks need more than 4n threads
  const int threads = block_threads(zmax > 32 * rmax ? zmax : 32 * rmax);
  fused_reduced_stack_kernel<BF16><<<1, threads, smem, stream>>>(
      a, (const float*)x, (float*)out, T, d, zmax, rmax);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K1's layer loop (fused_dense_stack_kernel). meta: L rows of 5 int64 —
// din, units, W, U, b (device pointers). bf16 != 0: fast mode, W and U bf16.
int fused_dense_stack_launch(const int64_t* meta, int L, const void* x, void* out, int T, int d,
                             int bf16, void* stream) {
  if (L < 1 || L > MAX_LAYERS) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return bf16 ? launch_dense_stack<true>(meta, L, x, out, T, d, s)
              : launch_dense_stack<false>(meta, L, x, out, T, d, s);
}

// K1 as a wavefront (dense_stack_wave). meta: L rows of 4 int64 — din, n,
// w_off (the layer's first entry in P), b (device pointer); P: E entries,
// float4 (bf16 == 0) or four bf16 (fast mode), the layers' gate-interleaved
// [W; U] one after another (ops/cuda_lstm.py: pack_wave). lanes: S; home:
// 0 registers, 1 staged, 2 the global copy (ops/cuda_lstm.py: dense_plan),
// checked here, not chosen.
int dense_stack_wave_launch(const int64_t* meta, int L, const void* P, int E, const void* x,
                            void* out, int T, int d, int lanes, int home, int bf16,
                            void* stream) {
  if (L < 1 || L > MAX_LAYERS || T < 1 || d < 1 || E < 1 || P == nullptr)
    return (int)cudaErrorInvalidValue;
  if (((uintptr_t)P) & 15) return (int)cudaErrorMisalignedAddress;
  WaveArgs a;
  a.L = L;
  for (int i = 0; i < L; ++i) {
    a.l[i].din = (int)meta[4 * i + 0];
    a.l[i].n = (int)meta[4 * i + 1];
    a.l[i].w_off = (int)meta[4 * i + 2];
    a.l[i].b = reinterpret_cast<const float*>(meta[4 * i + 3]);
  }
  cudaStream_t s = (cudaStream_t)stream;
  return bf16 ? launch_dense_wave<true>(a, P, E, (const float*)x, (float*)out, T, d, lanes, home, s)
              : launch_dense_wave<false>(a, P, E, (const float*)x, (float*)out, T, d, lanes, home, s);
}

// bf16 != 0: fast mode, Bt and IC bf16.
int reduced_recurrence_launch(const void* xp, const void* Bt, const void* IC, const void* h0,
                              const void* c0, void* out, int T, int n, int R, int bf16,
                              void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return bf16 ? launch_reduced_recurrence<true>(xp, Bt, IC, h0, c0, out, T, n, R, s)
              : launch_reduced_recurrence<false>(xp, Bt, IC, h0, c0, out, T, n, R, s);
}

// K3 (recurrence_chain). P: U packed unit-major, n·n entries, float4
// (bf16 == 0) or four bf16 (fast mode) (ops/cuda_lstm.py:
// pack_recurrence); h0, c0: (n) or null. units: J a CTA; home: 0
// registers, 1 staged, 2 the global copy (ops/cuda_lstm.py:
// recurrence_plan), checked here, not chosen.
int lstm_recurrence_launch(const void* xp, const void* P, const void* h0, const void* c0,
                           void* out, int T, int n, int units, int home, int bf16, void* stream) {
  if (T < 1 || P == nullptr || !rec_plan_ok(n, units, home, bf16 != 0))
    return (int)cudaErrorInvalidValue;
  if (((uintptr_t)P) & (bf16 ? 7 : 15)) return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = (cudaStream_t)stream;
  const float *x = (const float*)xp, *h = (const float*)h0, *c = (const float*)c0;
  float* o = (float*)out;
#define CHAIN_CASE(B_, H_) \
  if ((bf16 != 0) == B_ && home == H_) return launch_chain<B_, H_>(x, P, h, c, o, T, n, units, s);
  CHAIN_CASE(false, kRegs) CHAIN_CASE(false, kStaged) CHAIN_CASE(false, kGlobal)
  CHAIN_CASE(true, kRegs) CHAIN_CASE(true, kStaged) CHAIN_CASE(true, kGlobal)
#undef CHAIN_CASE
  return (int)cudaErrorInvalidValue;
}

// K3's CTAs an SM at this width, J and home (the occupancy API), into
// *per_sm.
int lstm_recurrence_per_sm(int n, int units, int home, int bf16, int* per_sm) {
  if (!rec_plan_ok(n, units, home, bf16 != 0)) return (int)cudaErrorInvalidValue;
#define OCC_CASE(B_, H_) \
  if ((bf16 != 0) == B_ && home == H_) return rec_occupancy<B_, H_>(n, units, per_sm);
  OCC_CASE(false, kRegs) OCC_CASE(false, kStaged) OCC_CASE(false, kGlobal)
  OCC_CASE(true, kRegs) OCC_CASE(true, kStaged) OCC_CASE(true, kGlobal)
#undef OCC_CASE
  return (int)cudaErrorInvalidValue;
}

// meta: L rows of 9 int64 — din, units, rw, ru, wBt, wIC, uBt, uIC, b (device
// pointers). bf16 != 0: fast mode, the four factors bf16.
int fused_reduced_stack_launch(const int64_t* meta, int L, const void* x, void* out, int T, int d,
                               int bf16, void* stream) {
  if (L < 1 || L > MAX_LAYERS) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return bf16 ? launch_reduced_stack<true>(meta, L, x, out, T, d, s)
              : launch_reduced_stack<false>(meta, L, x, out, T, d, s);
}

}  // extern "C"
