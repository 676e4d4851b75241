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
//    weight reads inside one step. One persistent CTA per launch runs all T
//    steps inside the kernel, which replaces the TPU's sequential grid and
//    its CT-step chunking (no time padding). One launch per sequence, no
//    per-step launch.
//  * h, c and z live in shared memory; every phase of a step ends with a
//    __syncthreads().
//  * Thread k owns gate column k of (., 4n) (strided by blockDim when 4n is
//    wider than the block). Weights are row-major (Keras layout), so a warp
//    reads 32 neighbouring columns of one row: the reads coalesce.
//  * Weights are read through __ldg from global memory. A narrow stack stays
//    L1-resident; the wide ones come from L2 every step. Staging them in
//    shared memory, splitting over CTAs and wgmma are later work.
//  * Each thread's dot runs four independent accumulators, so the FMA
//    chain does not serialise on its own latency.
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
// they are written into shared memory (h by the gate update, x_t when it is
// staged, h·B and x·B when they are reduced), while the h that goes out, c,
// the bias and xp stay float32 and unrounded. In K2–K4 on a wide layer a
// thread owns two neighbouring columns of z and reads both bf16 weights of a
// row in one 32-bit load (columns_bf16): the column phase issues half the
// loads of the exact kernels. With BF16 false every rounding is the
// identity at compile time and the column loops are the exact-mode code as
// before.
//
// Every launcher runs on the stream it is given, allocates nothing, and
// returns cudaGetLastError() for the Python wrapper to check.

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

// z: (4n) pre-activations [i|f|c|o]; updates c (n) in place and h (n) to the
// new h as the next products' operand (rounded in fast mode), and writes the
// unrounded h to out_row (global) when it is given. Callers sync before and
// after.
template <bool BF16>
__device__ __forceinline__ void gate_update(const float* z, float* h, float* c, int n,
                                            float* out_row) {
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    const float i = sigmoid_f32(z[j]);
    const float f = sigmoid_f32(z[n + j]);
    const float g = tanhf(z[2 * n + j]);
    const float o = sigmoid_f32(z[3 * n + j]);
    const float cn = f * c[j] + i * g;
    const float hn = o * tanhf(cn);
    c[j] = cn;
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
// an iteration (four FMA chains): on the H100 that ran K3's fast variant
// faster than four rows did (PERF.md).
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
// K1. fused_dense_stack — replaces svd_lstm_tpu/ops/pallas_lstm.py:
// fused_dense_stack_pallas. The whole dense stack (every layer n <= 128 on
// the main path) for batch 1: per step, per layer, z = x_t·W + h·U + b and
// the gate update, layer i's new h feeding layer i+1 within the step. Only
// the last layer's h goes out; the head runs outside.
// Bound: the dependent chain of 2 barriers per layer-step plus a
// (din + n)-long dot per thread; the 4x40 weights (~188 KB) stay in L1/L2.
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
// reduction over n; phase 2 is one thread per column of z, as in K3.
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
// K3. lstm_recurrence — replaces svd_lstm_tpu/ops/pallas_lstm.py:
// lstm_recurrence_pallas. Dense h-side recurrence from the hoisted input
// projection: z = xp_t + h·U, gate update.
// Bound: U is (n, 4n); at n = 512 that is 4 MB of f32 (2 MB in bf16, fast
// mode), which one SM reads from L2 every step — this single-CTA form is
// bound by that one SM's load path and slow at that width (half the bytes
// in fast mode took a quarter off its time, not half: PERF.md). A
// multi-CTA split with U resident in shared memory across a cluster is
// later work.
// Design: one thread per column of z (strided), four-accumulator dots.
// Shared memory: h, c (n each), z (4n).
// ---------------------------------------------------------------------------
template <bool BF16>
__global__ void __launch_bounds__(MAX_THREADS)
lstm_recurrence_kernel(const float* __restrict__ xp, const typename Mode<BF16>::W* __restrict__ U,
                       const float* __restrict__ h0, const float* __restrict__ c0,
                       float* __restrict__ out, int T, int n) {
  extern __shared__ float smem[];
  float* h = smem;
  float* c = h + n;
  float* z = c + n;
  const int G = 4 * n;
  load_state<BF16>(h, c, h0, c0, n);
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    const float* xpt = xp + (size_t)t * G;
    if constexpr (BF16) {
      columns_bf16(z, xpt, G, h, U, n, nullptr, nullptr, 0);
    } else {
      for (int k = threadIdx.x; k < G; k += blockDim.x) z[k] = dot_col(h, U, G, k, n, __ldg(xpt + k));
    }
    __syncthreads();
    gate_update<BF16>(z, h, c, n, out + (size_t)t * n);
    __syncthreads();
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

template <bool BF16>
int launch_lstm_recurrence(const void* xp, const void* U, const void* h0, const void* c0,
                           void* out, int T, int n, cudaStream_t stream) {
  using WT = typename Mode<BF16>::W;
  const size_t smem = (size_t)(6 * n) * sizeof(float);
  cudaError_t err = prepare_smem(lstm_recurrence_kernel<BF16>, smem);
  if (err != cudaSuccess) return (int)err;
  lstm_recurrence_kernel<BF16><<<1, block_threads(4 * n), smem, stream>>>(
      (const float*)xp, (const WT*)U, (const float*)h0, (const float*)c0, (float*)out, T, n);
  return (int)cudaGetLastError();
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

// meta: L rows of 5 int64 — din, units, W, U, b (device pointers). bf16 != 0:
// fast mode, W and U bf16.
int fused_dense_stack_launch(const int64_t* meta, int L, const void* x, void* out, int T, int d,
                             int bf16, void* stream) {
  if (L < 1 || L > MAX_LAYERS) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return bf16 ? launch_dense_stack<true>(meta, L, x, out, T, d, s)
              : launch_dense_stack<false>(meta, L, x, out, T, d, s);
}

// bf16 != 0: fast mode, Bt and IC bf16.
int reduced_recurrence_launch(const void* xp, const void* Bt, const void* IC, const void* h0,
                              const void* c0, void* out, int T, int n, int R, int bf16,
                              void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return bf16 ? launch_reduced_recurrence<true>(xp, Bt, IC, h0, c0, out, T, n, R, s)
              : launch_reduced_recurrence<false>(xp, Bt, IC, h0, c0, out, T, n, R, s);
}

// bf16 != 0: fast mode, U bf16.
int lstm_recurrence_launch(const void* xp, const void* U, const void* h0, const void* c0,
                           void* out, int T, int n, int bf16, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return bf16 ? launch_lstm_recurrence<true>(xp, U, h0, c0, out, T, n, s)
              : launch_lstm_recurrence<false>(xp, U, h0, c0, out, T, n, s);
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
