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
//  * K2 (reduced_chain) splits one reduced layer over a thread-block
//    cluster: a warp owns 8 units with their rows of B and columns of
//    [I|C] on chip, and only the R partial sums of h·B cross CTAs, through
//    distributed shared memory, one cluster barrier a step (see its note).
//  * K4 (reduced_stack_wave) runs the whole reduced stack in one
//    thread-block cluster: the layers as a wavefront, K2's split of the
//    units over the CTAs, only partial sums of h·B crossing CTAs, one
//    cluster barrier a wave step (see its note).
//  * K1's and K4's layer loops (fused_dense_stack_kernel,
//    fused_reduced_stack_kernel: the stacks the wavefronts cannot hold) run
//    in one CTA: h, c and z live in shared memory; every phase of a step
//    ends with a __syncthreads(). Thread k owns gate column k of (., 4n)
//    (strided by blockDim when 4n is wider than the block). Weights are
//    row-major (Keras layout), so a warp reads 32 neighbouring columns of
//    one row: the reads coalesce. They are read through __ldg from global
//    memory: a narrow stack stays L1-resident, the wide ones come from L2
//    every step. Each thread's dot runs four independent accumulators, so
//    the FMA chain does not serialise on its own latency.
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
// In K4's layer loop on a wide layer a thread owns two neighbouring columns
// of z and reads both bf16 weights of a row in one 32-bit load
// (columns_bf16): the column phase issues half the loads of the exact
// kernels. With BF16 false every rounding is the
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
// K2. reduced_chain — replaces svd_lstm_tpu/ops/pallas_lstm.py:
// reduced_recurrence_pallas. Low-rank h-side recurrence of one layer,
// batch 1, from the hoisted input projection:
//   hb = h_{t-1}·B (R outputs), z_t = xp_t + hb·[I|C], the gate update;
// h_t goes out unrounded (T, n), and c_T into c_out where given. Merged:
// one B (n, r) and [I|C] (r, 4n), hb shared by the four gates. Split: per gate B_g (n, r_g) and [I|C_g]
// (r_g, n), gate g's columns reading only its own block of hb (R = Σ r_g).
//
// What bounds it: a step is n·R + R·4n multiply-adds (61 440 at n = 512,
// merged r = 24: 1/17 of K3's), but every unit of h_t needs all of hb, which
// needs all of h_{t-1}: the chain of T dependent steps is the bound. One CTA
// reading its 240 KB of weights from L1/L2 every step (the design before)
// took ~4.4 us a step; K3's grid chain spends ~1 us a step on its exchange
// of h alone.
// What the design does about it:
//  * The reduction is split, not only the columns. A thread-block cluster
//    of CL CTAs (CL in 1..16, one launch for all T steps) splits the units:
//    a warp owns RED_UNITS = 8 units, their rows of B and their 32 gate
//    columns of [I|C], on chip for the whole run, where HOME says (the
//    wrapper's rule, ops/cuda_lstm.py: reduced_plan):
//      kRegs   — in registers (every block rank <= 32: lane c holds its
//                column's 32 entries, lane q row q of the 8 units' B; at
//                most RED_REG_THREADS threads);
//      kStaged — the CTA's blocks staged in shared memory once.
//    The wrapper packs a warp's block as [I|C] by rows q, a lane's column
//    each (zero past the column's block rank), then B block by block, unit
//    by unit, each block at its own rank (ops/cuda_lstm.py:
//    pack_reduced_chain): a split layer's gate reads only [I|C_g], no zero
//    blocks.
//  * Only R partial sums cross CTAs in a step. h never leaves its warp: a
//    step is
//      1. each warp's partial hb over its 8 units (lane q: an FMA chain over
//         u = 0..7 in order), into shared memory; one __syncthreads();
//      2. the CTA's partial, the warps' partials added in warp order, stored
//         into every CTA's shared memory (its own included) through
//         distributed shared memory (cluster.map_shared_rank), in the slot
//         of its rank, in parity t & 1;
//      3. one cluster barrier (barrier.cluster arrive.release +
//         wait.acquire): the only exchange of the step;
//      4. every warp sums the CL partials in rank order (so every CTA holds
//         the same hb; rounded to bf16 in fast mode) into its row of shared
//         memory; lane 8g + u, gate g of unit u, forms its column's dot
//         hb·[I|C][:, c] over its block's rank in four FMA chains (q mod 4,
//         added as (0 + 1) + (2 + 3)), adds xp_t (loaded before the
//         barrier), takes its gate's activation; the four are gathered by
//         shuffles and every lane of unit u updates c (in registers for all
//         T steps) and h; lanes 0..7 store h_t.
//    The parity double buffer lets the one barrier a step serve both the
//    exchange and the reuse of the slots.
//  * Units past n are masked (zero weights, h and c held at 0, nothing
//    stored), so any n runs; a CTA whose warps own no unit still joins the
//    exchange with zero partials.
// Fast mode: h, B, hb and [I|C] are the products' operands, rounded to bf16
// where reduced_recurrence_plain rounds them (B and [I|C] once, by the
// wrapper); sums, state, xp and the h that goes out stay float32.
// ---------------------------------------------------------------------------
#define RED_UNITS 8           // units a warp: its 4 x 8 gate columns, a lane each
#define RED_MAX_WARPS 32      // warps a CTA (1024 threads)
#define RED_REG_THREADS 512   // the block of kRegs
#define RED_MAX_CLUSTER 16

struct RedArgs {
  int n, R;        // units; entries of hb (merged r, split Σ r_g)
  int rmax;        // the largest block rank
  int warps;       // warps a CTA
  int entries;     // entries of one warp's block of P: 32·rmax + 8·R
  int rank[4];     // each block's rank (merged: rank[0] = r)
  int off[4];      // each block's first entry of hb
};

// A warp's block of P: [I|C] as [q][lane] for q < rmax (lane = 8g + u:
// gate g of unit u; zero past the lane's block rank), then B as [block][u][q]
// (each block's rank entries; ops/cuda_lstm.py: pack_reduced_chain).
__host__ __device__ __forceinline__ int red_b_off(const RedArgs& a, int b, int u) {
  return 32 * a.rmax + RED_UNITS * a.off[b] + u * a.rank[b];
}

template <typename WT> __device__ __forceinline__ float ld_plain(const WT* p);
template <> __device__ __forceinline__ float ld_plain<float>(const float* p) { return *p; }
template <> __device__ __forceinline__ float ld_plain<__nv_bfloat16>(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

template <bool BF16, bool SPLIT, int HOME, int CL>
__global__ void __launch_bounds__(HOME == kRegs ? RED_REG_THREADS : MAX_THREADS)
reduced_chain(const RedArgs a, const float* __restrict__ xp,
              const typename Mode<BF16>::W* __restrict__ P, const float* __restrict__ h0,
              const float* __restrict__ c0, float* __restrict__ out, float* __restrict__ c_out,
              int T) {
  using WT = typename Mode<BF16>::W;
  constexpr int NB = SPLIT ? 4 : 1;
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  extern __shared__ float4 red_smem[];
  float* part = reinterpret_cast<float*>(red_smem);  // [2][CL][R]: the CTAs' partial hb
  float* wpart = part + 2 * CL * a.R;                 // [warps][R]: a warp's partial, then its hb
  WT* ws = reinterpret_cast<WT*>(wpart + a.warps * a.R);  // kStaged: the CTA's blocks of P
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5, u = lane & 7, g = lane >> 3;
  const int n = a.n, R = a.R;
  const int j = RED_UNITS * (rank * a.warps + w) + u;  // unit u of this warp
  const bool unit = j < n;
  const WT* pw = P + (size_t)(rank * a.warps + w) * a.entries;
  if constexpr (HOME == kStaged) {
    const WT* src = P + (size_t)rank * a.warps * a.entries;
    for (int e = tid; e < a.warps * a.entries; e += blockDim.x) ws[e] = src[e];
    pw = ws + (size_t)w * a.entries;
  }
  const int bl = SPLIT ? g : 0;  // the block of this lane's column
  const int rl = a.rank[bl];
  float wic[HOME == kRegs ? 32 : 1], wb[HOME == kRegs ? NB * RED_UNITS : 1];
  if constexpr (HOME == kRegs) {  // every rank <= 32 (checked by the launcher)
#pragma unroll
    for (int q = 0; q < 32; ++q) wic[q] = q < a.rmax ? ld_plain(pw + 32 * q + lane) : 0.f;
#pragma unroll
    for (int b = 0; b < NB; ++b)
#pragma unroll
      for (int v = 0; v < RED_UNITS; ++v)
        wb[b * RED_UNITS + v] = lane < a.rank[b] ? ld_plain(pw + red_b_off(a, b, v) + lane) : 0.f;
  }
  float hop = unit && h0 != nullptr ? Mode<BF16>::round(h0[j]) : 0.f;  // h_{t-1}, the operand
  float c = unit && c0 != nullptr ? c0[j] : 0.f;
  float* hbw = wpart + w * R;
  cluster.sync();  // every CTA running (its shared memory a target) and staged

  for (int t = 0; t < T; ++t) {
    const int par = t & 1;
    const float xg = unit ? __ldg(xp + (size_t)t * 4 * n + g * n + j) : 0.f;
    // 1. the warp's partial hb over its 8 units
    float hu[RED_UNITS];
#pragma unroll
    for (int v = 0; v < RED_UNITS; ++v) hu[v] = __shfl_sync(0xffffffffu, hop, v);
    for (int q = lane; q < a.rmax; q += 32) {
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        if (q >= a.rank[b]) continue;
        float p = 0.f;
#pragma unroll
        for (int v = 0; v < RED_UNITS; ++v) {
          float wv;
          if constexpr (HOME == kRegs) {
            wv = wb[b * RED_UNITS + v];
          } else {
            wv = ld_plain(pw + red_b_off(a, b, v) + q);
          }
          p = fmaf(hu[v], wv, p);
        }
        hbw[a.off[b] + q] = p;
      }
    }
    __syncthreads();
    // 2. the CTA's partial, into every CTA's slot for this rank
    for (int i = tid; i < R; i += blockDim.x) {
      float s = 0.f;
      for (int v = 0; v < a.warps; ++v) s += wpart[v * R + i];
      float* slot = part + (par * CL + rank) * R + i;
#pragma unroll
      for (int peer = 0; peer < CL; ++peer) *cluster.map_shared_rank(slot, peer) = s;
    }
    // 3. the exchange
    cluster.sync();
    // 4. hb in rank order, into the warp's row; lane 8g + u: its column's dot
    for (int q = lane; q < R; q += 32) {
      float s = 0.f;
#pragma unroll
      for (int r = 0; r < CL; ++r) s += part[(par * CL + r) * R + q];
      hbw[q] = Mode<BF16>::round(s);
    }
    __syncwarp();
    const float* hq = hbw + a.off[bl];
    float d[4] = {0.f, 0.f, 0.f, 0.f};  // four chains, over q mod 4
    if constexpr (HOME == kRegs) {
#pragma unroll
      for (int q = 0; q < 32; ++q)
        if (q < rl) d[q & 3] = fmaf(hq[q], wic[q], d[q & 3]);
    } else {
      for (int q0 = 0; q0 < rl; q0 += 4) {
#pragma unroll
        for (int m = 0; m < 4; ++m)
          if (q0 + m < rl) d[m] = fmaf(hq[q0 + m], ld_plain(pw + 32 * (q0 + m) + lane), d[m]);
      }
    }
    const float z = ((d[0] + d[1]) + (d[2] + d[3])) + xg;
    const float act = g == 2 ? tanhf(z) : sigmoid_f32(z);
    const float ai = __shfl_sync(0xffffffffu, act, u), af = __shfl_sync(0xffffffffu, act, 8 + u);
    const float ag = __shfl_sync(0xffffffffu, act, 16 + u), ao = __shfl_sync(0xffffffffu, act, 24 + u);
    if (unit) {
      c = af * c + ai * ag;
      const float hn = ao * tanhf(c);
      if (lane < RED_UNITS) out[(size_t)t * n + j] = hn;
      hop = Mode<BF16>::round(hn);
    }
    __syncwarp();  // hbw is this warp's partial again
  }
  if (unit && lane < RED_UNITS && c_out != nullptr) c_out[j] = c;  // c_T, when asked for
}

// ---------------------------------------------------------------------------
// K3. recurrence_chain — replaces svd_lstm_tpu/ops/pallas_lstm.py:
// lstm_recurrence_pallas. Dense h-side recurrence of one layer, batch 1,
// from the hoisted input projection: z_t = xp_t + h_{t-1}·U, the gate
// update; h_t goes out unrounded (T, n), and c_T into c_out where given
// (the pipeline's stages carry it from one chunk of time to the next).
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
                 const float* __restrict__ h0, const float* __restrict__ c0, float* out,
                 float* __restrict__ c_out, int T, int n) {
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
  if (unit && lane == 0 && c_out != nullptr) c_out[j] = c;  // c_T, when asked for
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
// K4's layer loop (fused_reduced_stack_kernel) — for the stacks that
// reduced_stack_wave below cannot hold in a cluster of 16 CTAs (the
// "layers" route of ops/cuda_lstm.py: reduced_stack_plan). Replaces, with
// it, svd_lstm_tpu/ops/pallas_lstm.py: fused_reduced_stack_pallas. The
// whole reduced stack for batch 1, factored on both sides: per step, per
// layer,
//   z = (inp·wB)·[I|wC] + (h·uB)·[I|uC] + b
// and the gate update; layer i's new h feeds layer i+1 within the step, the
// head runs outside. Each side is packed by ops/cuda_lstm.py: _pack_reduced
// (transposed B, and for split layers the block-diagonal [I|C] of the four
// gates), so one body serves merged and split layers.
// Bound: the dependent chain. A layer-step has three barriers against K1's
// two: phase 1 computes xb = inp·wB and hb = h·uB together (one warp per
// output, rw + ru of them), phase 2 the 4n columns of z from both (one
// thread per column), phase 3 the gate update. At 3x512 r=24 the operands
// of a layer-step are about 0.5 MB (f32), read from L2; narrow stacks stay
// in L1 (164.6 ms at 3x512 r = 24 on the H100, PERF.md).
// Design: as K1's loop, one CTA for all T and all layers; x_{t+1} is staged
// in the last layer's gate phase. In fast mode xb and hb are rounded to
// bf16 before their second products, as the TPU's second dots take them.
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

// ---------------------------------------------------------------------------
// K4. reduced_stack_wave — replaces svd_lstm_tpu/ops/pallas_lstm.py:
// fused_reduced_stack_pallas for every stack that one cluster of at most 16
// CTAs holds (the wrapper's rule, ops/cuda_lstm.py: reduced_stack_plan).
// The whole reduced stack for batch 1, both sides factored: per step, per
// layer i,
//   z = (inp·wB)·[I|wC] + (h·uB)·[I|uC] + b
// and the gate update, from zero state; inp is x_t for layer 0 and layer
// i-1's h_t above it. Only the last layer's h goes out (T, n_out); the head
// runs outside.
//
// What bounds it: a layer-step is (din + n)·R + R·4n multiply-adds per side
// (~0.2 MFLOP a wave step at 3x512 r = 24), but every unit of a layer needs
// all of its hb and xb, which need all of the h below and before: the
// chain of dependent steps is the bound. The layer loop above (one CTA,
// three barriers a layer-step, the weights from L2) took ~25 us a step.
// What the design does about it:
//  * The layers run as a wavefront: at wave step s layer i runs its step
//    t = s - i, T + L - 1 wave steps in all. A layer outside its window
//    (t < 0 or t >= T) holds its h and c (zeros before it starts), and
//    still contributes the partials of the h it holds, which the layer
//    above reads at the drain. Every lane is guarded to its own window.
//  * K2's split of the units over one cluster of CL CTAs (CL in 1..16, one
//    launch for all T): the warps are dealt to the layers in order, a warp
//    RED_UNITS = 8 units of one layer, and it keeps on chip for the whole
//    run its 8 rows of uB, its 8 rows of the next layer's wB (its units' h
//    is that layer's input) and its 32 gate columns of [I|uC] and [I|wC]
//    (lane 8g + u: gate g of unit u), where HOME says (the wrapper's rule):
//      kRegs   — in registers (every block rank <= RQ, each side's h·B at
//                most RSW_KB chunks of 32 entries; the block at most 512
//                threads at RQ = 16, 384 at RQ = 32);
//      kStaged — the CTA's blocks staged in shared memory once.
//    A split layer's gate column reads only its own block of xb and hb
//    (ops/cuda_lstm.py: pack_reduced_stack packs no zero blocks). Layer
//    0's x-side x_t·wB_0 is computed in the kernel by every warp of layer
//    0 (d <= 32 rows, x_t a lane an entry, wB_0 staged in shared memory),
//    between the barrier's arrive and its wait.
//  * One exchange a wave step. The exchange vector V holds, layer after
//    layer, [xb_i | hb_i]; layer i's warps write hb_i and xb_{i+1}, one
//    contiguous range. A wave step is
//      1. each warp's partials of hb_i and xb_{i+1} over its 8 units, from
//         the h it holds (lane e: entry e of each, an FMA chain over u =
//         0..7), into its row of shared memory; one __syncthreads();
//      2. the CTA's partial of the range its warps write (the warps' rows
//         added in warp order, exact zeros outside a warp's range), stored
//         through distributed shared memory (cluster.map_shared_rank) into
//         the slot of its rank in every CTA, parity s & 1;
//      3. one cluster barrier (barrier.cluster arrive, which releases, layer
//         0's x-side, wait, which acquires; for a cluster of one CTA, the
//         x-side and then a block barrier);
//      4. every warp in its window adds the partials of [xb_i | hb_i] in
//         rank order, from the ranks that hold the layer below's warps and
//         its own (so every CTA holds the same values; rounded to bf16 in
//         fast mode; no slot is read that was not written) into its row; lane 8g + u forms its column's two
//         dots, over xb_i's block with [I|wC] and over hb_i's with [I|uC],
//         each in four FMA chains (q mod 4, added (0 + 1) + (2 + 3)), adds
//         them and b, takes its gate's activation; the four are gathered by
//         shuffles and every lane of unit u updates c (in registers for all
//         T) and h;
//      5. the last layer's lanes 0..7 store h_t.
//    The parity double buffer lets the one barrier a wave step serve both
//    the exchange and the reuse of the slots.
//  * Units past n are masked (zero weights, h and c held at 0, nothing
//    stored); warps past the last layer's join the exchange with nothing.
// Fast mode: x_t, h, xb, hb and the four factors are the products'
// operands, rounded to bf16 where fused_reduced_stack_plain rounds them
// (the factors once, by the wrapper); sums, state, b and the h that goes
// out stay float32.
// Measured on the H100 (PERF.md §6, scripts/probe_torch_reduced_stack.py,
// T = 6656): 3x512 merged r = 24 (CL = 16 of 12 warps, the weights in 167
// registers a thread) ~2.7 us a wave step, 17.9-18.6 ms against the layer
// loop's ~164; 4x30 split r = 15 (CL = 1, 16 warps) ~2.6 us. Taken out one
// at a time (3x512 / 4x30): the cluster barrier ~0.47 / ~0 us, the column
// dots ~0.35 / ~0, the CTA's sums of its warps' rows ~0.24 / ~0.3, layer
// 0's x-side ~0.12 / ~0.2, the gate math ~0.05 / ~0, the pushes through
// distributed shared memory ~0. Slower, and dropped: pushing a slot only to
// the CTAs that read it (a table), a split barrier for a cluster of one
// CTA, x_t loaded a step ahead, summing only the writers' rows, and one
// cluster a layer handing xb on through global memory (21.8 ms at 3x512).
// ---------------------------------------------------------------------------
#define RSW_KB 2  // chunks of 32 entries of a side's h·B a lane holds in registers (kRegs)

struct RswLayer {
  int n;                  // units
  int warp0;              // the layer's first warp in the cluster
  int Rw, Ru;             // entries of xb_i and hb_i (merged r, split Σ r_g)
  int Rn;                 // entries of xb_{i+1} (0 for the last layer)
  int xoff;               // xb_i's first entry of V; hb_i follows, then xb_{i+1}
  int wrank[4], woff[4];  // gate g's block of xb_i: its rank, its first entry (merged: r, 0)
  int urank[4], uoff[4];  // the same for hb_i
  const float* b;         // (4n)
};

struct RswArgs {
  int L, d;
  int S;       // entries of V: Σ (Rw_i + Ru_i)
  int warps;   // warps a CTA
  int QW, QU;  // rows of a warp's columns of [I|wC] and of [I|uC]: the largest block ranks
  int KU, KN;  // chunks of 32 entries of hb_i and of xb_{i+1}: the most of any layer
  int KX;      // chunks of 32 entries of xb_0
  int E;       // entries of a warp's block of P: 32·(QW + QU) + 256·(KU + KN)
  int RO;      // floats of a warp's operand row: the largest Rw_i + Ru_i
  RswLayer l[MAX_LAYERS];
};

// shared memory of reduced_stack_wave (ops/cuda_lstm.py:
// reduced_stack_smem_bytes): floats first — the slots [2][CL][S], the warps'
// partial rows [W][S], their operand rows [W][RO] — then, in the weights'
// type, layer 0's x-side weights [d][32·KX] and, staged, the CTA's blocks
// of P [W][E]
size_t rsw_smem_bytes(const RswArgs& a, int CL, int home, bool bf16) {
  const size_t wt = bf16 ? 2 : 4;
  return ((size_t)2 * CL * a.S + (size_t)a.warps * (a.S + a.RO)) * sizeof(float) +
         ((size_t)a.d * 32 * a.KX + (home == kStaged ? (size_t)a.warps * a.E : 0)) * wt;
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive;\n" ::: "memory");  // release semantics
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait;\n" ::: "memory");  // acquire semantics
}

template <bool BF16, int HOME, int CL, int RQ>
__global__ void __launch_bounds__(HOME == kRegs ? (RQ <= 16 ? 512 : 384) : MAX_THREADS)
reduced_stack_wave(const RswArgs a, const typename Mode<BF16>::W* __restrict__ P,
                   const float* __restrict__ x, float* __restrict__ out, int T) {
  using WT = typename Mode<BF16>::W;
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = CL == 1 ? 0 : (int)cluster.block_rank();
  const int S = a.S, W = a.warps, d = a.d;
  extern __shared__ float4 rsw_smem[];
  float* part = reinterpret_cast<float*>(rsw_smem);  // [2][CL][S]: the CTAs' partials
  float* wpart = part + 2 * CL * S;                   // [W][S]: a warp's partials
  float* opw = wpart + W * S;                         // [W][RO]: a warp's [xb_i | hb_i]
  WT* wx = reinterpret_cast<WT*>(opw + W * a.RO);     // [d][32·KX]: layer 0's wB, flattened
  WT* ws = wx + d * 32 * a.KX;                        // kStaged: the CTA's blocks of P
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5, u = lane & 7, g = lane >> 3;
  const int gw = rank * W + w;

  // this warp's layer (-1: past the last layer's warps), read once
  int li = -1;
  for (int i = 0; i < a.L; ++i)
    if (gw >= a.l[i].warp0 && gw < a.l[i].warp0 + (a.l[i].n + RED_UNITS - 1) / RED_UNITS) li = i;
  int n = 0, Rw = 0, Ru = 0, Rn = 0, xoff = 0, rlw = 0, olw = 0, rlu = 0, olu = 0, j = 0;
  float bias = 0.f;
  if (li >= 0) {
    const RswLayer& ly = a.l[li];
    n = ly.n;
    Rw = ly.Rw;
    Ru = ly.Ru;
    Rn = ly.Rn;
    xoff = ly.xoff;
    rlw = ly.wrank[g];
    olw = ly.woff[g];
    rlu = ly.urank[g];
    olu = Rw + ly.uoff[g];
    j = RED_UNITS * (gw - ly.warp0) + u;
    if (j < n) bias = __ldg(ly.b + g * n + j);
  }
  const bool unit = li >= 0 && j < n;
  const bool last = li == a.L - 1;
  // the range of V this CTA's warps write; the ranks that write xb_i (the
  // layer below's) and hb_i (this layer's), the only slots this warp reads
  int s_lo = S, s_hi = 0, x_lo = 0, x_hi = -1, h_lo = 0, h_hi = -1;
  for (int i = 0; i < a.L; ++i) {
    const RswLayer& ly = a.l[i];
    const int w0 = ly.warp0, w1 = ly.warp0 + (ly.n + RED_UNITS - 1) / RED_UNITS;
    if (w0 < rank * W + W && w1 > rank * W) {
      s_lo = min(s_lo, ly.xoff + ly.Rw);
      s_hi = max(s_hi, ly.xoff + ly.Rw + ly.Ru + ly.Rn);
    }
    if (i == li - 1) {
      x_lo = w0 / W;
      x_hi = (w1 - 1) / W;
    }
    if (i == li) {
      h_lo = w0 / W;
      h_hi = (w1 - 1) / W;
    }
  }

  // the warps' rows: exact zeros outside each warp's range
  for (int e = tid; e < W * S; e += blockDim.x) wpart[e] = 0.f;
  for (int e = tid; e < d * 32 * a.KX; e += blockDim.x) wx[e] = P[(size_t)CL * W * a.E + e];
  const WT* pw = P + (size_t)gw * a.E;
  if constexpr (HOME == kStaged) {
    const WT* src = P + (size_t)rank * W * a.E;
    for (int e = tid; e < W * a.E; e += blockDim.x) ws[e] = src[e];
    pw = ws + (size_t)w * a.E;
  }
  const int o_uic = 32 * a.QW, o_ub = 32 * (a.QW + a.QU), o_wn = o_ub + 256 * a.KU;
  float wic[HOME == kRegs ? RQ : 1], uic[HOME == kRegs ? RQ : 1];
  float ub[HOME == kRegs ? RSW_KB * RED_UNITS : 1], wn[HOME == kRegs ? RSW_KB * RED_UNITS : 1];
  if constexpr (HOME == kRegs) {  // every rank <= RQ, KU and KN <= RSW_KB (checked by the launcher)
#pragma unroll
    for (int q = 0; q < RQ; ++q) {
      wic[q] = li >= 0 && q < a.QW ? ld_plain(pw + 32 * q + lane) : 0.f;
      uic[q] = li >= 0 && q < a.QU ? ld_plain(pw + o_uic + 32 * q + lane) : 0.f;
    }
#pragma unroll
    for (int k = 0; k < RSW_KB; ++k)
#pragma unroll
      for (int v = 0; v < RED_UNITS; ++v) {
        ub[k * RED_UNITS + v] = li >= 0 && k < a.KU ? ld_plain(pw + o_ub + 256 * k + 32 * v + lane) : 0.f;
        wn[k * RED_UNITS + v] = li >= 0 && k < a.KN ? ld_plain(pw + o_wn + 256 * k + 32 * v + lane) : 0.f;
      }
  }
  float hop = 0.f, c = 0.f;  // unit u's h (the products' operand) and c
  float* wrow = wpart + w * S + xoff + Rw;  // this warp's partials: [hb_i | xb_{i+1}]
  float* op = opw + w * a.RO;               // this warp's [xb_i | hb_i]
  if constexpr (CL == 1) {
    __syncthreads();
  } else {
    cluster.sync();  // every CTA running (its shared memory a target), zeroed and staged
  }

  const int steps = T + a.L - 1;
  for (int s = 0; s < steps; ++s) {
    const int par = s & 1;
    const int t = s - li;
    const bool live = li >= 0 && t >= 0 && t < T;  // warp-uniform
    float xv = 0.f;
    if (li == 0 && live && lane < d) xv = Mode<BF16>::round(__ldg(x + (size_t)t * d + lane));
    // 1. the warp's partials of hb_i and xb_{i+1} from the h it holds
    if (li >= 0) {
      float hu[RED_UNITS];
#pragma unroll
      for (int v = 0; v < RED_UNITS; ++v) hu[v] = __shfl_sync(0xffffffffu, hop, v);
      const int kb = HOME == kRegs ? RSW_KB : (a.KU > a.KN ? a.KU : a.KN);
#pragma unroll
      for (int k = 0; k < kb; ++k) {
        const int e = 32 * k + lane;
        if (e < Ru) {
          float p = 0.f;
#pragma unroll
          for (int v = 0; v < RED_UNITS; ++v) {
            float wv;
            if constexpr (HOME == kRegs) {
              wv = ub[k * RED_UNITS + v];
            } else {
              wv = ld_plain(pw + o_ub + 256 * k + 32 * v + lane);
            }
            p = fmaf(hu[v], wv, p);
          }
          wrow[e] = p;
        }
        if (e < Rn) {
          float p = 0.f;
#pragma unroll
          for (int v = 0; v < RED_UNITS; ++v) {
            float wv;
            if constexpr (HOME == kRegs) {
              wv = wn[k * RED_UNITS + v];
            } else {
              wv = ld_plain(pw + o_wn + 256 * k + 32 * v + lane);
            }
            p = fmaf(hu[v], wv, p);
          }
          wrow[Ru + e] = p;
        }
      }
    }
    __syncthreads();
    // 2. the CTA's partial of its range, into every CTA's slot for this rank
    for (int sl = s_lo + tid; sl < s_hi; sl += blockDim.x) {
      float v = 0.f;
      for (int ww = 0; ww < W; ++ww) v += wpart[ww * S + sl];
      float* slot = part + (par * CL + rank) * S + sl;
      if constexpr (CL == 1) {
        *slot = v;
      } else {
#pragma unroll
        for (int peer = 0; peer < CL; ++peer) *cluster.map_shared_rank(slot, peer) = v;
      }
    }
    // 3. the exchange; layer 0's x-side meanwhile
    if constexpr (CL > 1) cluster_arrive();
    if (li == 0 && live) {
      for (int k = 0; k < a.KX; ++k) {
        const int e = 32 * k + lane;
        float acc = 0.f;  // one FMA chain over the d inputs
        for (int kk = 0; kk < d; ++kk)
          acc = fmaf(__shfl_sync(0xffffffffu, xv, kk), ld_plain(wx + kk * 32 * a.KX + e), acc);
        if (e < Rw) op[e] = Mode<BF16>::round(acc);
      }
    }
    if constexpr (CL > 1) {
      cluster_wait();
    } else {
      __syncthreads();
    }
    if (!live) continue;  // warp-uniform: a warp outside its window holds h and c
    // 4. [xb_i | hb_i] in rank order (layer 0's xb_i is its own), the columns
    for (int e = (li == 0 ? Rw : 0) + lane; e < Rw + Ru; e += 32) {
      const int lo = e < Rw ? x_lo : h_lo, hi = e < Rw ? x_hi : h_hi;
      float sum = 0.f;
#pragma unroll
      for (int r = 0; r < CL; ++r)
        if (r >= lo && r <= hi) sum += part[(par * CL + r) * S + xoff + e];
      op[e] = Mode<BF16>::round(sum);
    }
    __syncwarp();
    const float* xq = op + olw;
    const float* hq = op + olu;
    float dw[4] = {0.f, 0.f, 0.f, 0.f}, du[4] = {0.f, 0.f, 0.f, 0.f};  // over q mod 4
    if constexpr (HOME == kRegs) {
#pragma unroll
      for (int q = 0; q < RQ; ++q) {
        if (q < rlw) dw[q & 3] = fmaf(xq[q], wic[q], dw[q & 3]);
        if (q < rlu) du[q & 3] = fmaf(hq[q], uic[q], du[q & 3]);
      }
    } else {
      for (int q0 = 0; q0 < rlw; q0 += 4) {
#pragma unroll
        for (int m = 0; m < 4; ++m)
          if (q0 + m < rlw) dw[m] = fmaf(xq[q0 + m], ld_plain(pw + 32 * (q0 + m) + lane), dw[m]);
      }
      for (int q0 = 0; q0 < rlu; q0 += 4) {
#pragma unroll
        for (int m = 0; m < 4; ++m)
          if (q0 + m < rlu) du[m] = fmaf(hq[q0 + m], ld_plain(pw + o_uic + 32 * (q0 + m) + lane), du[m]);
      }
    }
    const float z = (((dw[0] + dw[1]) + (dw[2] + dw[3])) + ((du[0] + du[1]) + (du[2] + du[3]))) + bias;
    const float act = g == 2 ? tanhf(z) : sigmoid_f32(z);
    const float ai = __shfl_sync(0xffffffffu, act, u), af = __shfl_sync(0xffffffffu, act, 8 + u);
    const float ag = __shfl_sync(0xffffffffu, act, 16 + u), ao = __shfl_sync(0xffffffffu, act, 24 + u);
    if (unit) {
      c = af * c + ai * ag;
      const float hn = ao * tanhf(c);
      // 5. the last layer's h_t
      if (last && lane < RED_UNITS) out[(size_t)t * n + j] = hn;
      hop = Mode<BF16>::round(hn);
    }
    __syncwarp();  // op is this warp's again
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

// shared memory of reduced_chain: the partials (two parities of CL x R, and
// the CTA's warps' R each) and, staged, the CTA's blocks of P
// (ops/cuda_lstm.py: reduced_smem_bytes)
size_t red_smem_bytes(const RedArgs& a, int CL, int home, bool bf16) {
  return (size_t)(2 * CL + a.warps) * a.R * sizeof(float) +
         (home == kStaged ? (size_t)a.warps * a.entries * (bf16 ? 2 : 4) : 0);
}

// Checks what the wrapper's plan chose (CL, warps a CTA, the weights' home)
// against the kernel and the packing, then launches one cluster of CL CTAs
// if the card can hold it (cudaOccupancyMaxActiveClusters); a cluster the
// card cannot hold is refused, never run another way.
template <bool BF16, bool SPLIT, int HOME, int CL>
int launch_reduced_chain(const RedArgs& a, const float* xp, const void* P_, const float* h0,
                         const float* c0, float* out, float* c_out, int T, cudaStream_t s) {
  using WT = typename Mode<BF16>::W;
  const auto kernel = reduced_chain<BF16, SPLIT, HOME, CL>;
  const size_t smem = red_smem_bytes(a, CL, HOME, BF16);
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  if (CL > 8 && (e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed,
                                          1)) != cudaSuccess)
    return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CL);
  cfg.blockDim = dim3(32 * a.warps);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  if ((e = cudaOccupancyMaxActiveClusters(&clusters, (void*)kernel, &cfg)) != cudaSuccess)
    return (int)e;
  if (clusters < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  const WT* P = (const WT*)P_;
  if ((e = cudaLaunchKernelEx(&cfg, kernel, a, xp, P, h0, c0, out, c_out, T)) != cudaSuccess)
    return (int)e;
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
                 float* c_out, int T, int n, int units, cudaStream_t s) {
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
  void* args[] = {(void*)&xp, (void*)&P,     (void*)&h0, (void*)&c0,
                  (void*)&out, (void*)&c_out, (void*)&T,  (void*)&n};
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

// One cluster of CL CTAs of reduced_stack_wave, if the card can hold it
// (cudaOccupancyMaxActiveClusters); a cluster the card cannot hold is
// refused, never run another way.
template <bool BF16, int HOME, int CL, int RQ>
int launch_stack_wave(const RswArgs& a, const void* P, const float* x, float* out, int T,
                      cudaStream_t s) {
  using WT = typename Mode<BF16>::W;
  const auto kernel = reduced_stack_wave<BF16, HOME, CL, RQ>;
  const size_t smem = rsw_smem_bytes(a, CL, HOME, BF16);
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  if (CL > 8 && (e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed,
                                          1)) != cudaSuccess)
    return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CL);
  cfg.blockDim = dim3(32 * a.warps);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  if ((e = cudaOccupancyMaxActiveClusters(&clusters, (void*)kernel, &cfg)) != cudaSuccess)
    return (int)e;
  if (clusters < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  if ((e = cudaLaunchKernelEx(&cfg, kernel, a, (const WT*)P, x, out, T)) != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The geometry of the stack from the wrapper's meta (ops/cuda_lstm.py:
// stack_geometry computes the same); false where a layer's shape is not
// one the kernel takes.
int imax(int p, int q) { return p > q ? p : q; }

bool rsw_args(const int64_t* meta, int L, int d, int warps, RswArgs& a) {
  a.L = L;
  a.d = d;
  a.warps = warps;
  a.S = a.QW = a.QU = a.KU = a.KN = a.RO = 0;
  int warp0 = 0;
  for (int i = 0; i < L; ++i) {
    const int64_t* m = meta + 11 * i;
    RswLayer& ly = a.l[i];
    ly.n = (int)m[0];
    const int blocks = (int)m[1];
    if (ly.n < 1 || (blocks != 1 && blocks != 4)) return false;
    ly.warp0 = warp0;
    warp0 += (ly.n + RED_UNITS - 1) / RED_UNITS;
    ly.Rw = ly.Ru = 0;
    for (int g = 0; g < 4; ++g) {
      const int gb = blocks == 4 ? g : 0;  // merged: every gate reads the one block
      ly.wrank[g] = (int)m[2 + gb];
      ly.urank[g] = (int)m[6 + gb];
      if (ly.wrank[g] < 1 || ly.urank[g] < 1) return false;
      ly.woff[g] = blocks == 4 ? ly.Rw : 0;
      ly.uoff[g] = blocks == 4 ? ly.Ru : 0;
      if (blocks == 4 || g == 0) {
        ly.Rw += ly.wrank[g];
        ly.Ru += ly.urank[g];
      }
      a.QW = imax(a.QW, ly.wrank[g]);
      a.QU = imax(a.QU, ly.urank[g]);
    }
    ly.b = reinterpret_cast<const float*>(m[10]);
    ly.xoff = a.S;
    a.S += ly.Rw + ly.Ru;
    a.RO = imax(a.RO, ly.Rw + ly.Ru);
    a.KU = imax(a.KU, (ly.Ru + 31) / 32);
    if (i > 0) {
      a.l[i - 1].Rn = ly.Rw;
      a.KN = imax(a.KN, (ly.Rw + 31) / 32);
    }
  }
  a.l[L - 1].Rn = 0;
  a.KX = (a.l[0].Rw + 31) / 32;
  a.E = 32 * (a.QW + a.QU) + 256 * (a.KU + a.KN);
  return true;
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

// K2 (reduced_chain). P: the packed blocks of CL x warps warps, entries
// each, float (bf16 == 0) or bf16 (fast mode) (ops/cuda_lstm.py:
// pack_reduced_chain); h0, c0: (n) or null; c_out: (n), the final c, or
// null. ranks: 1 (merged) or 4 (split)
// block ranks; cluster: CL; warps: warps a CTA; home: 0 registers, 1
// staged (ops/cuda_lstm.py: reduced_plan), checked here, not chosen.
int reduced_recurrence_launch(const void* xp, const void* P, const int* ranks, int blocks,
                              const void* h0, const void* c0, void* out, void* c_out, int T,
                              int n, int cluster, int warps, int home, int bf16, void* stream) {
  if (T < 1 || n < 1 || P == nullptr || (blocks != 1 && blocks != 4) || warps < 1 ||
      warps > RED_MAX_WARPS || cluster < 1 || cluster > RED_MAX_CLUSTER ||
      (long long)cluster * warps * RED_UNITS < n || (home != kRegs && home != kStaged) ||
      (home == kRegs && 32 * warps > RED_REG_THREADS))
    return (int)cudaErrorInvalidValue;
  RedArgs a;
  a.n = n;
  a.warps = warps;
  a.R = 0;
  for (int b = 0; b < 4; ++b) {
    a.rank[b] = b < blocks ? ranks[b] : 0;
    a.off[b] = b < blocks ? a.R : 0;
    if (b < blocks) {
      if (a.rank[b] < 1 || (home == kRegs && a.rank[b] > 32)) return (int)cudaErrorInvalidValue;
      a.R += a.rank[b];
    }
  }
  a.rmax = 0;
  for (int b = 0; b < blocks; ++b) a.rmax = a.rank[b] > a.rmax ? a.rank[b] : a.rmax;
  a.entries = 32 * a.rmax + RED_UNITS * a.R;
  if (red_smem_bytes(a, cluster, home, bf16 != 0) > 232448) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float *x = (const float*)xp, *h = (const float*)h0, *c = (const float*)c0;
  float *o = (float*)out, *co = (float*)c_out;
#define RED_CASE(B_, S_, H_, CL_)                                                              \
  if ((bf16 != 0) == B_ && (blocks == 4) == S_ && home == H_ && cluster == CL_)                \
    return launch_reduced_chain<B_, S_, H_, CL_>(a, x, P, h, c, o, co, T, s);
#define RED_CLUSTERS(B_, S_, H_) \
  RED_CASE(B_, S_, H_, 1) RED_CASE(B_, S_, H_, 2) RED_CASE(B_, S_, H_, 4) RED_CASE(B_, S_, H_, 8) \
  RED_CASE(B_, S_, H_, 16)
  RED_CLUSTERS(false, false, kRegs) RED_CLUSTERS(false, false, kStaged)
  RED_CLUSTERS(false, true, kRegs) RED_CLUSTERS(false, true, kStaged)
  RED_CLUSTERS(true, false, kRegs) RED_CLUSTERS(true, false, kStaged)
  RED_CLUSTERS(true, true, kRegs) RED_CLUSTERS(true, true, kStaged)
#undef RED_CLUSTERS
#undef RED_CASE
  return (int)cudaErrorInvalidValue;
}

// K3 (recurrence_chain). P: U packed unit-major, n·n entries, float4
// (bf16 == 0) or four bf16 (fast mode) (ops/cuda_lstm.py:
// pack_recurrence); h0, c0: (n) or null; c_out: (n), the final c, or null. units: J a CTA; home: 0
// registers, 1 staged, 2 the global copy (ops/cuda_lstm.py:
// recurrence_plan), checked here, not chosen.
int lstm_recurrence_launch(const void* xp, const void* P, const void* h0, const void* c0,
                           void* out, void* c_out, int T, int n, int units, int home, int bf16,
                           void* stream) {
  if (T < 1 || P == nullptr || !rec_plan_ok(n, units, home, bf16 != 0))
    return (int)cudaErrorInvalidValue;
  if (((uintptr_t)P) & (bf16 ? 7 : 15)) return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = (cudaStream_t)stream;
  const float *x = (const float*)xp, *h = (const float*)h0, *c = (const float*)c0;
  float *o = (float*)out, *co = (float*)c_out;
#define CHAIN_CASE(B_, H_)                \
  if ((bf16 != 0) == B_ && home == H_) \
    return launch_chain<B_, H_>(x, P, h, c, o, co, T, n, units, s);
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

// K4 (reduced_stack_wave). meta: L rows of 11 int64 — n, blocks (1 merged,
// 4 split), the input side's block ranks (4; merged: the first), the
// recurrent side's (4), b (device pointer); P: `entries` entries, float
// (bf16 == 0) or bf16 (fast mode), CL x warps warps' blocks and then layer
// 0's x-side weights (ops/cuda_lstm.py: pack_reduced_stack). cluster: CL;
// warps: warps a CTA; home: 0 registers, 1 staged (ops/cuda_lstm.py:
// reduced_stack_plan), checked here, not chosen: the warps hold every
// layer's, the registers hold every rank (at most 16, or 32 on at most 384
// threads) and RSW_KB chunks of each side's h·B, the shared memory fits.
int reduced_stack_wave_launch(const int64_t* meta, int L, const void* P, long long entries,
                              const void* x, void* out, int T, int d, int cluster, int warps,
                              int home, int bf16, void* stream) {
  if (L < 1 || L > MAX_LAYERS || T < 1 || d < 1 || d > 32 || P == nullptr || warps < 1 ||
      warps > RED_MAX_WARPS || (home != kRegs && home != kStaged))
    return (int)cudaErrorInvalidValue;
  RswArgs a;
  if (!rsw_args(meta, L, d, warps, a)) return (int)cudaErrorInvalidValue;
  const RswLayer& top = a.l[L - 1];
  const int rq = a.QW > a.QU ? a.QW : a.QU;
  const int rq_tmpl = rq <= 16 ? 16 : 32;
  if ((long long)cluster * warps < top.warp0 + (top.n + RED_UNITS - 1) / RED_UNITS ||
      entries != (long long)cluster * warps * a.E + (long long)d * 32 * a.KX ||
      (home == kRegs && (rq > 32 || a.KU > RSW_KB || a.KN > RSW_KB ||
                         32 * warps > (rq_tmpl == 16 ? 512 : 384))) ||
      rsw_smem_bytes(a, cluster, home, bf16 != 0) > 232448)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float* xs = (const float*)x;
  float* o = (float*)out;
#define RSW_CASE(B_, H_, CL_, RQ_)                                                       \
  if ((bf16 != 0) == B_ && home == H_ && cluster == CL_ && (H_ != kRegs || rq_tmpl == RQ_)) \
    return launch_stack_wave<B_, H_, CL_, RQ_>(a, P, xs, o, T, s);
#define RSW_CLUSTERS(B_, H_, RQ_) \
  RSW_CASE(B_, H_, 1, RQ_) RSW_CASE(B_, H_, 2, RQ_) RSW_CASE(B_, H_, 4, RQ_) RSW_CASE(B_, H_, 8, RQ_) \
  RSW_CASE(B_, H_, 16, RQ_)
  RSW_CLUSTERS(false, kRegs, 16) RSW_CLUSTERS(false, kRegs, 32) RSW_CLUSTERS(false, kStaged, 32)
  RSW_CLUSTERS(true, kRegs, 16) RSW_CLUSTERS(true, kRegs, 32) RSW_CLUSTERS(true, kStaged, 32)
#undef RSW_CLUSTERS
#undef RSW_CASE
  return (int)cudaErrorInvalidValue;
}

// K4's layer loop (fused_reduced_stack_kernel). meta: L rows of 9 int64 —
// din, units, rw, ru, wBt, wIC, uBt, uIC, b (device pointers). bf16 != 0:
// fast mode, the four factors bf16.
int fused_reduced_stack_launch(const int64_t* meta, int L, const void* x, void* out, int T, int d,
                               int bf16, void* stream) {
  if (L < 1 || L > MAX_LAYERS) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return bf16 ? launch_reduced_stack<true>(meta, L, x, out, T, d, s)
              : launch_reduced_stack<false>(meta, L, x, out, T, d, s);
}

}  // extern "C"
