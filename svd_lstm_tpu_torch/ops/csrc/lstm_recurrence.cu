// Batch-1 LSTM recurrence kernels for Hopper (sm_90a), float32, exact mode.
//
// Three kernels, one per TPU kernel on the batch-1 inference path of
// svd_lstm_tpu/ops/pallas_lstm.py. All three share one shape: a sequential
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
//    shared memory, splitting over CTAs, wgmma and bf16 are later work.
//  * Each thread's dot runs four independent accumulators, so the FMA
//    chain does not serialise on its own latency.
//  * The gate update is one __device__ function (the counterpart of
//    models/lstm.py:gate_update), with expf/tanhf in f32. No fast math.
//
// Every launcher runs on the stream it is given, allocates nothing, and
// returns cudaGetLastError() for the Python wrapper to check.

#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_LAYERS 8
#define MAX_THREADS 1024

namespace {

__device__ __forceinline__ float sigmoid_f32(float v) { return 1.0f / (1.0f + expf(-v)); }

// z: (4n) pre-activations [i|f|c|o]; updates h, c (n) in place and writes
// h to out_row (global) when it is given. Callers sync before and after.
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
    h[j] = hn;
    if (out_row != nullptr) out_row[j] = hn;
  }
}

// acc += sum_j v[j] * M[j * ld + col] for j < len, with four accumulators.
// v lies in shared memory; M is a read-only global matrix.
__device__ __forceinline__ float dot_col(const float* v, const float* __restrict__ M, int ld,
                                         int col, int len, float acc) {
  float a1 = 0.f, a2 = 0.f, a3 = 0.f;
  int j = 0;
  for (; j + 4 <= len; j += 4) {
    acc = fmaf(v[j], __ldg(M + (size_t)j * ld + col), acc);
    a1 = fmaf(v[j + 1], __ldg(M + (size_t)(j + 1) * ld + col), a1);
    a2 = fmaf(v[j + 2], __ldg(M + (size_t)(j + 2) * ld + col), a2);
    a3 = fmaf(v[j + 3], __ldg(M + (size_t)(j + 3) * ld + col), a3);
  }
  for (; j < len; ++j) acc = fmaf(v[j], __ldg(M + (size_t)j * ld + col), acc);
  return (acc + a1) + (a2 + a3);
}

__device__ __forceinline__ void load_state(float* h, float* c, const float* h0, const float* c0,
                                           int n) {
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    h[j] = h0 != nullptr ? h0[j] : 0.f;
    c[j] = c0 != nullptr ? c0[j] : 0.f;
  }
}

struct StackArgs {
  int L;
  int din[MAX_LAYERS];
  int units[MAX_LAYERS];
  const float* W[MAX_LAYERS];  // (din, 4n)
  const float* U[MAX_LAYERS];  // (n, 4n)
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
__global__ void __launch_bounds__(MAX_THREADS)
fused_dense_stack_kernel(StackArgs a, const float* __restrict__ x, float* __restrict__ out,
                         int T, int d, int zmax) {
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
  for (int k = threadIdx.x; k < d; k += blockDim.x) xs[k] = x[k];
  __syncthreads();

  const int last = a.L - 1;
  const int n_out = a.units[last];
  for (int t = 0; t < T; ++t) {
    const float* inp = xs;
    for (int i = 0; i < a.L; ++i) {
      const int n = a.units[i];
      const int G = 4 * n;
      for (int k = threadIdx.x; k < G; k += blockDim.x) {
        float acc = dot_col(inp, a.W[i], G, k, a.din[i], __ldg(a.b[i] + k));
        z[k] = dot_col(hs[i], a.U[i], G, k, n, acc);
      }
      __syncthreads();
      gate_update(z, hs[i], cs[i], n, i == last ? out + (size_t)t * n_out : nullptr);
      if (i == last && t + 1 < T) {
        // layer 0 read xs before this step's first barrier
        for (int k = threadIdx.x; k < d; k += blockDim.x) xs[k] = x[(size_t)(t + 1) * d + k];
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
// Bound: two dependent phases per step; at 3x512 r=24 the operands are
// 48 KB + 192 KB, read from L1/L2 each step.
// Design: phase 1 gives one warp per output of hb with a shuffle
// reduction over n; phase 2 is one thread per column of z, as in K3.
// Shared memory: h, c (n each), hb (R), z (4n).
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(MAX_THREADS)
reduced_recurrence_kernel(const float* __restrict__ xp, const float* __restrict__ Bt,
                          const float* __restrict__ IC, const float* __restrict__ h0,
                          const float* __restrict__ c0, float* __restrict__ out, int T, int n,
                          int R) {
  extern __shared__ float smem[];
  float* h = smem;
  float* c = h + n;
  float* hb = c + n;
  float* z = hb + R;
  const int G = 4 * n;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  load_state(h, c, h0, c0, n);
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    for (int q = warp; q < R; q += nwarps) {  // warp-uniform loop
      const float* row = Bt + (size_t)q * n;
      float acc = 0.f;
      for (int j = lane; j < n; j += 32) acc = fmaf(h[j], __ldg(row + j), acc);
      for (int s = 16; s > 0; s >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, s);
      if (lane == 0) hb[q] = acc;
    }
    __syncthreads();
    const float* xpt = xp + (size_t)t * G;
    for (int k = threadIdx.x; k < G; k += blockDim.x) z[k] = dot_col(hb, IC, G, k, R, __ldg(xpt + k));
    __syncthreads();
    gate_update(z, h, c, n, out + (size_t)t * n);
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// K3. lstm_recurrence — replaces svd_lstm_tpu/ops/pallas_lstm.py:
// lstm_recurrence_pallas. Dense h-side recurrence from the hoisted input
// projection: z = xp_t + h·U, gate update.
// Bound: U is (n, 4n); at n = 512 that is 4 MB of f32, which one SM reads
// from L2 every step — this single-CTA form is L2-bandwidth-bound by design
// and slow at that width. A multi-CTA split with U resident in shared
// memory across a cluster is later work.
// Design: one thread per column of z (strided), four-accumulator dots.
// Shared memory: h, c (n each), z (4n).
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(MAX_THREADS)
lstm_recurrence_kernel(const float* __restrict__ xp, const float* __restrict__ U,
                       const float* __restrict__ h0, const float* __restrict__ c0,
                       float* __restrict__ out, int T, int n) {
  extern __shared__ float smem[];
  float* h = smem;
  float* c = h + n;
  float* z = c + n;
  const int G = 4 * n;
  load_state(h, c, h0, c0, n);
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    const float* xpt = xp + (size_t)t * G;
    for (int k = threadIdx.x; k < G; k += blockDim.x) z[k] = dot_col(h, U, G, k, n, __ldg(xpt + k));
    __syncthreads();
    gate_update(z, h, c, n, out + (size_t)t * n);
    __syncthreads();
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

}  // namespace

extern "C" {

// meta: L rows of 5 int64 — din, units, W, U, b (device pointers).
int fused_dense_stack_launch(const int64_t* meta, int L, const void* x, void* out, int T, int d,
                             void* stream) {
  if (L < 1 || L > MAX_LAYERS) return (int)cudaErrorInvalidValue;
  StackArgs a;
  a.L = L;
  int state = 0, zmax = 0;
  for (int i = 0; i < L; ++i) {
    a.din[i] = (int)meta[5 * i + 0];
    a.units[i] = (int)meta[5 * i + 1];
    a.W[i] = reinterpret_cast<const float*>(meta[5 * i + 2]);
    a.U[i] = reinterpret_cast<const float*>(meta[5 * i + 3]);
    a.b[i] = reinterpret_cast<const float*>(meta[5 * i + 4]);
    state += 2 * a.units[i];
    if (4 * a.units[i] > zmax) zmax = 4 * a.units[i];
  }
  const size_t smem = (size_t)(state + zmax + d) * sizeof(float);
  cudaError_t err = prepare_smem(fused_dense_stack_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  fused_dense_stack_kernel<<<1, block_threads(zmax), smem, (cudaStream_t)stream>>>(
      a, (const float*)x, (float*)out, T, d, zmax);
  return (int)cudaGetLastError();
}

int reduced_recurrence_launch(const void* xp, const void* Bt, const void* IC, const void* h0,
                              const void* c0, void* out, int T, int n, int R, void* stream) {
  const size_t smem = (size_t)(2 * n + R + 4 * n) * sizeof(float);
  cudaError_t err = prepare_smem(reduced_recurrence_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  reduced_recurrence_kernel<<<1, block_threads(4 * n), smem, (cudaStream_t)stream>>>(
      (const float*)xp, (const float*)Bt, (const float*)IC, (const float*)h0, (const float*)c0,
      (float*)out, T, n, R);
  return (int)cudaGetLastError();
}

int lstm_recurrence_launch(const void* xp, const void* U, const void* h0, const void* c0,
                           void* out, int T, int n, void* stream) {
  const size_t smem = (size_t)(6 * n) * sizeof(float);
  cudaError_t err = prepare_smem(lstm_recurrence_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  lstm_recurrence_kernel<<<1, block_threads(4 * n), smem, (cudaStream_t)stream>>>(
      (const float*)xp, (const float*)U, (const float*)h0, (const float*)c0, (float*)out, T, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
