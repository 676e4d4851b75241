// LSTM training kernels for Hopper (sm_90a), float32 on the CUDA cores; K9f's
// and K6f's forward and backward (gemm_bf16, batched_chain, the bf16 dh
// chain) and the batched fast-mode recurrence (K5), bf16 on the tensor cores.
// The narrow pair's bf16 variant (K7f, K8f) has kernels of its own on the
// tensor cores (narrow_bf16.cu: narrow_fwd_mma, narrow_z, narrow_bwd_mma,
// narrow_wgrad); the narrow kernels here (narrow_fwd_wave, narrow_bwd_wave,
// weight_grad) are float32 only.
//
// The bf16-operand variants have the arithmetic of the TPU kernels'
// precision=DEFAULT dots: each operand is rounded to bf16
// (__float2bfloat16_rn, round to nearest even) where it enters a product,
// the product of two bf16 values is exact in float32, and the sums, the cell
// state c, the bias, xp and the gate math stay float32; every output (h, c,
// dz, dx, the gradients) is float32 and unrounded, and db sums dz
// unrounded, as the TPU kernels do.
// K9f and K6f (pallas_train_wide.py:_wide_fwd / _wide_bwd,
// pallas_train.py:_pallas_fwd_hc / _pallas_bwd, DEFAULT dots) run on the
// tensor cores instead, with the same roundings: bf16 copies of the
// operands made once a call (bf16_copy), every GEMM over all T·B rows as
// gemm_bf16 (TMA and wgmma: K9f's forward x-side, the backward's phases R,
// X and G), the forward chain as batched_chain's c-storing instantiation
// (K5's kernel: h_t's bf16 copy kept for the next step, the product on
// mma.sync), the
// dh chain's product on mma.sync in wide_bwd_chain's BF16 instantiation;
// the same products, their float32 sums in another order (see the notes
// above gemm_bf16, batched_chain and chain_product_bf16). Bound at 3x512, B
// = 128, T = 200: 0.33 ms of bf16 operations for the backward, 0.11 for the
// forward, against ~2.8 and ~1.8 ms measured (PERF.md §6), most of it the
// chains' steps (~7.4 and ~7.0 us).
//
// Four forward/backward pairs, one per TPU train kernel pair on the
// training path of svd_lstm_tpu/ops/pallas_train.py, one reduction that the
// backward passes share, and one inference kernel:
//
//   K7  narrow_fwd_wave / narrow_bwd_wave — replace
//       svd_lstm_tpu/ops/pallas_train_fused.py: _fused_fwd / _fused_bwd
//       (every layer n <= 128, the input <= 128).
//   K8  the same two kernels, the weights staged in shared memory wherever
//       the stack fits — replace svd_lstm_tpu/ops/pallas_train_compact.py:
//       _fused_fwd / _fused_bwd (see the note above the launchers).
//   K9  gemm_f32 + wide_fwd_chain / gemm_f32 + wide_bwd_chain — replace
//       svd_lstm_tpu/ops/pallas_train_wide.py: _wide_fwd / _wide_bwd (one
//       layer, n % 128 == 0); K9f: bf16_copy + gemm_bf16 + batched_chain /
//       bf16_copy + gemm_bf16 + wide_bwd_chain (BF16) + weight_grad.
//   K6  the same kernels with the x·W part left out (the forward chain on
//       z = xp_t + h_{t-1}·U with no x-side GEMM; the backward's GEMMs
//       without x and W, and dxp = dz) —
//       replace svd_lstm_tpu/ops/pallas_train.py: _pallas_fwd_hc /
//       _pallas_bwd; K6f: batched_chain alone / K9f's backward without x
//       and W.
//   weight_grad (+ sum_splits) — the dW/dU/db accumulation that the TPU
//       backward kernels carried in VMEM scratch (K7, K8; K9 and K6 take
//       gemm_f32's TN form).
//   K5  batched_chain — replaces svd_lstm_tpu/ops/pallas_batched.py:
//       batched_lstm_recurrence_pallas: one persistent cooperative launch
//       on the tensor cores (see its own note below).
//
// What differs from the TPU, and what the design does about it:
//  * The TPU grid walks T in order and carries dW/dU in VMEM across steps.
//    Here blocks run in parallel in no order, so the backward kernels store
//    dz = dL/dz (T, B, 4n) per layer in device memory and weight_grad (K7,
//    K8) or gemm_f32 (K9, K6) reduces it afterwards: dW = Σ_t,b inpᵀ·dz, dU = Σ_t,b h_prevᵀ·dz,
//    db = Σ_t,b dz, in a fixed order (split over M = T·B into at most a few
//    partial sums that sum_splits adds in order). No atomics, so the
//    gradients are deterministic. Storing dz is HBM traffic the TPU kernels
//    avoided: 16 MB per step at 4x40/B=32/T=200, 210 MB per layer at
//    3x512/B=128/T=200. A later PR keeps the sums on chip.
//  * K7, K8: batch rows are independent in the forward and in the
//    backward's carries, so a CTA owns NARROW_ROWS rows and runs the whole
//    recurrence inside the block (one launch per direction); only
//    B / NARROW_ROWS CTAs run (8 at B = 32), so each is a chain of dependent
//    steps and its latency is the bound. Both directions (narrow_fwd_wave,
//    narrow_bwd_wave, see their notes and the ones above the launchers) run
//    the layers as a wavefront, T + L - 1 steps forward and T + L back
//    (with dx as a layer of its own), one barrier a step, a lane group per
//    unit, the gate math and the carries in registers.
//  * K9 and K6 forward: at n = 512 U is 4 MB, against 227 KB of shared
//    memory a block, and every unit's z at step t needs all of h_{t-1}: each
//    step is a grid-wide dependency. Only h·U is recurrent, so x·W + b runs
//    as one GEMM over all T·B rows (K9), and the recurrence is one
//    persistent cooperative launch with its units' columns of U on chip and
//    a grid barrier a step (wide_fwd_chain, the backward chain's layout; see
//    its note). Before, a launch a step (~52 us a step at n = 512, B = 128).
//    K9f and K6f: the same split, the GEMM on gemm_bf16 and the chain on
//    batched_chain with c stored (its tile and grid by batched_plan).
//  * K9 and K6 backward: only the dh carry is recurrent. z needs only x_t
//    and the forward's h_{t-1}, dx only dz, and the weight gradients only
//    dz and the forward's tensors, so they run as GEMMs over all T·B rows,
//    out of the time loop; the dh chain is one persistent cooperative
//    launch with its units' columns of U on chip (see the note above gemm_f32).
//  * The cell gradient is one __device__ function, gate_bwd, that both
//    backward kernels call (the counterpart of models/lstm.py:
//    gate_update_bwd). expf/tanhf as written, no fast math.
//
// Every launcher runs on the stream it is given, allocates nothing, and
// returns cudaGetLastError() for the Python wrapper to check.

#include <cooperative_groups.h>
#include <cuda.h>  // CUtensorMap and its enums (the encoder comes from the runtime)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "lstm_cell.cuh"  // the gate arithmetic and the mma.sync / ldmatrix helpers

#define MAX_LAYERS 8
#define NARROW_ROWS 4
#define WG_TP 64     // rows of a weight-gradient tile
#define WG_TG 64     // columns of a weight-gradient tile
#define WG_KM 32     // M chunk of a weight-gradient tile
#define WG_THREADS 256

namespace {

// Element conversions, by the cuda_bf16.h intrinsics only (round to nearest
// even, as torch's .bfloat16()).
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// ---------------------------------------------------------------------------
// K7 and K8 forward — replace pallas_train_fused.py:_fused_fwd and
// pallas_train_compact.py:_fused_fwd (design: the note above the launchers).
// The whole stack over T steps: per layer z = inp·W + h·U + b and the gate
// update; every layer's h and c go out.
//
// A group of S lanes of one warp owns unit j of layer i for the CTA's
// NARROW_ROWS rows: all four gate pre-activations of the four rows (16
// sums), the din + n terms split over the lanes (lane l takes k = l, l + S,
// ... < din + n), summed across the group by reduce_lanes. A warp holds
// 32 / S units, lane-major: its lanes [l·32/S, (l + 1)·32/S) are lane l of
// each group, so a quarter-warp reads one state entry and 8 neighbouring
// units' weights at one k. The cell state stays in the owning lane's registers for all T
// steps; h goes to the shared state and to the outputs.
//
// The layers run as a wavefront: at step s layer i computes t = s - i, from
// the state that step s - 1 wrote (h of the layer below at t, its own h at
// t - 1), into the other parity of the state; one barrier a step, T + L - 1
// steps. One parity of the state is the vector [x_t | h_0 | ... | h_{L-1}]
// of float4 entries, one float per row ([k][r]), so layer i's input
// [h_{i-1} | h_i] (or [x | h_0]) is one contiguous range and one 16-byte
// broadcast load gives the four rows at input k. A lane stops at its last
// k < din + n, so it never reads the next layer's h (a diverged upper layer
// leaves the lower ones as the plain version does). x_{s+1} is loaded at
// the top of step s and stored into the state at its end.
//
// Weights, gate-interleaved as [k][j][4] (one 16-byte load gives unit j's
// four gates at input k; a quarter-warp reads 128 contiguous bytes, no bank
// conflict): kStaged (K8, and K7 when the stack fits) stages every layer's
// [W; U] rows into shared memory so; without kStaged (K7's stacks that do
// not fit) the kernel reads the wrapper's copy P, so laid out, from L1/L2
// through __ldg.
// ---------------------------------------------------------------------------
#define FWD_MAX_THREADS 1024

struct FwdLayer {
  int din, n;
  const float* W;  // (din, 4n)
  const float* U;  // (n, 4n)
  const float* b;  // (4n)
  const float* P;  // (din + n, n, 4), or null: staged from W and U
  float* h;        // (T, B, n)
  float* c;        // (T, B, n)
};

struct FwdArgs {
  int L;
  FwdLayer l[MAX_LAYERS];
};

// float4 entries of the staged weights
inline int fwd_weight_entries(const FwdArgs& a) {
  int e = 0;
  for (int i = 0; i < a.L; ++i) e += (a.l[i].din + a.l[i].n) * a.l[i].n;
  return e;
}

// entries (four rows each) of one parity of the state vector
inline int fwd_state_entries(const FwdArgs& a, int d) {
  int v = d;
  for (int i = 0; i < a.L; ++i) v += a.l[i].n;
  return v;
}

// One exchange of a reduce-scatter over the lane group: the lane keeps the
// lower or upper half of v[0, 2·HALF) (its bit says which) and adds the
// partner's copy of that half; the kept half moves to v[0, HALF).
template <int HALF, int N>
__device__ __forceinline__ void split_half(float (&v)[N], bool upper, int offset, unsigned mask) {
#pragma unroll
  for (int q = 0; q < HALF; ++q) {
    const float send = upper ? v[q] : v[q + HALF];
    const float keep = upper ? v[q + HALF] : v[q];
    v[q] = keep + __shfl_xor_sync(mask, send, offset);
  }
}

// Sums the group's partial sums v[r·P + g] of the four rows r, P = N / 4
// a row (the forward's four gate pre-activations, or the backward's one dh
// or dx). Each sum is taken by one lane in a fixed order (the last exchange
// of S = 8 is symmetric), so the result does not depend on timing.
// Afterwards v[q·P + g] holds row fwd_first_row<S>(l) + q, q < 4 / S (one
// row for S ≥ 4).
template <int S, int N>
__device__ __forceinline__ void reduce_lanes(float (&v)[N], int l, unsigned mask) {
  constexpr int G = 32 / S;  // lane l' of a group sits at warp lane l'·G + its group
  if constexpr (S == 2) {
    split_half<N / 2>(v, l & 1, G, mask);
  } else if constexpr (S == 4) {
    split_half<N / 2>(v, (l >> 1) & 1, 2 * G, mask);
    split_half<N / 4>(v, l & 1, G, mask);
  } else if constexpr (S == 8) {
    split_half<N / 2>(v, (l >> 2) & 1, 4 * G, mask);
    split_half<N / 4>(v, (l >> 1) & 1, 2 * G, mask);
#pragma unroll
    for (int g = 0; g < N / 4; ++g) v[g] += __shfl_xor_sync(mask, v[g], G);
  }
}

template <int S> __device__ __forceinline__ int fwd_first_row(int l) {
  return S == 1 ? 0 : S == 2 ? 2 * l : S == 4 ? l : (l >> 1) & 3;
}

template <int S, bool kStaged>
__global__ void __launch_bounds__(FWD_MAX_THREADS)
narrow_fwd_wave(FwdArgs a, const float* __restrict__ x, int T, int B, int d, int V) {
  extern __shared__ float4 fwd_smem[];
  constexpr int R = NARROW_ROWS;
  constexpr int RL = S >= 4 ? 1 : 4 / S;  // rows a lane updates
  const int tid = threadIdx.x, row0 = blockIdx.x * R;

  // this thread's unit (layer li, unit j) and lane l: a warp holds 32 / S
  // units, lane l of its groups at lanes [l·32/S, (l + 1)·32/S)
  constexpr int G = 32 / S;
  const int lane = tid & 31, l = lane / G, g = (tid >> 5) * G + lane % G;
  int li = -1, j = 0, w_off = 0, h_off = 0;
  {
    int u = 0, wo = 0, so = d;
    for (int i = 0; i < a.L; ++i) {
      const int n = a.l[i].n;
      if (li < 0 && g < u + n) {
        li = i;
        j = g - u;
        w_off = wo;
        h_off = so;
      }
      u += n;
      wo += (a.l[i].din + n) * n;
      so += n;
    }
  }

  int w_entries = 0;
  if constexpr (kStaged) {
    for (int i = 0; i < a.L; ++i) {
      const FwdLayer& ly = a.l[i];
      const int n = ly.n, din = ly.din;
      for (int e = tid; e < (din + n) * n; e += blockDim.x) {
        const int k = e / n, jj = e % n;
        const float* src = k < din ? ly.W + (size_t)k * 4 * n : ly.U + (size_t)(k - din) * 4 * n;
        fwd_smem[w_entries + e] =
            make_float4(src[jj], src[n + jj], src[2 * n + jj], src[3 * n + jj]);
      }
      w_entries += (din + n) * n;
    }
  }
  float4* state = fwd_smem + w_entries;  // two parities of V entries
  float* statef = reinterpret_cast<float*>(state);
  // zeros, and x_0 into parity 1 (read at s = 0)
  for (int e = tid; e < 2 * V; e += blockDim.x) {
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    const int k = e - V;
    if (k >= 0 && k < d) {
      float r4[R];
#pragma unroll
      for (int r = 0; r < R; ++r) r4[r] = row0 + r < B ? x[(size_t)(row0 + r) * d + k] : 0.f;
      v = make_float4(r4[0], r4[1], r4[2], r4[3]);
    }
    state[e] = v;
  }

  const bool unit = li >= 0;
  const int n = unit ? a.l[li].n : 0;
  const int in_off = unit ? h_off - a.l[li].din : 0;
  // this lane's k = l + kb·S < din + n
  const int KB = unit ? (a.l[li].din + n - l + S - 1) / S : 0;
  const int w_stride = n * S;  // float4 entries from one lane block to the next
  const float4* wp;
  if constexpr (kStaged) {
    wp = fwd_smem + w_off + l * n + j;
  } else {
    wp = unit ? reinterpret_cast<const float4*>(a.l[li].P) + l * n + j : nullptr;
  }
  float bias[4] = {0.f, 0.f, 0.f, 0.f};
  float* hout = nullptr;
  float* cout = nullptr;
  if (unit) {
#pragma unroll
    for (int q = 0; q < 4; ++q) bias[q] = __ldg(a.l[li].b + q * n + j);
    hout = a.l[li].h;
    cout = a.l[li].c;
  }
  float c[RL];
#pragma unroll
  for (int q = 0; q < RL; ++q) c[q] = 0.f;
  unsigned mask = 0;  // the group's lanes
#pragma unroll
  for (int q = 0; q < S; ++q) mask |= 1u << (q * G + lane % G);
  const int r0 = fwd_first_row<S>(l);
  const bool owner = S < 8 || (l & 1) == 0;
  // x staging: thread tid < R·d owns entry k = tid / R, row tid % R
  const int xk = tid / R, xr = tid % R;
  const bool stager = tid < R * d;
  __syncthreads();

  const int steps = T + a.L - 1;
  for (int s = 0; s < steps; ++s) {
    const int P = (s + 1) & 1, Q = s & 1;
    float xn = 0.f;
    if (stager && s + 1 < T && row0 + xr < B)
      xn = x[((size_t)(s + 1) * B + row0 + xr) * d + xk];
    const int t = s - li;
    if (unit && t >= 0 && t < T) {
      float v[16];
#pragma unroll
      for (int q = 0; q < 16; ++q) v[q] = 0.f;
      const float4* sp = state + P * V + in_off + l;
#pragma unroll 2
      for (int kb = 0; kb < KB; ++kb) {
        const float4 hv = sp[kb * S];
        float4 w;
        if constexpr (kStaged) {
          w = wp[kb * w_stride];
        } else {
          w = __ldg(wp + kb * w_stride);
        }
        const float hr[4] = {hv.x, hv.y, hv.z, hv.w};
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          v[r * 4 + 0] = fmaf(hr[r], w.x, v[r * 4 + 0]);
          v[r * 4 + 1] = fmaf(hr[r], w.y, v[r * 4 + 1]);
          v[r * 4 + 2] = fmaf(hr[r], w.z, v[r * 4 + 2]);
          v[r * 4 + 3] = fmaf(hr[r], w.w, v[r * 4 + 3]);
        }
      }
      reduce_lanes<S>(v, l, mask);
      if (owner) {
#pragma unroll
        for (int q = 0; q < RL; ++q) {
          const int r = r0 + q;
          float hn, cn;
          gate_fwd(v[q * 4 + 0] + bias[0], v[q * 4 + 1] + bias[1], v[q * 4 + 2] + bias[2],
                   v[q * 4 + 3] + bias[3], c[q], hn, cn);
          c[q] = cn;
          statef[(Q * V + h_off + j) * R + r] = hn;
          if (row0 + r < B) {
            const size_t o = ((size_t)t * B + row0 + r) * n + j;
            hout[o] = hn;
            cout[o] = cn;
          }
        }
      }
    }
    if (stager && s + 1 < T) statef[(Q * V + xk) * R + xr] = xn;
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// K7 and K8 backward — replace pallas_train_fused.py:_fused_bwd and
// pallas_train_compact.py:_fused_bwd (design: the note above the launchers).
// The whole stack in reverse time: per layer z recomputed from the forward's
// h, dh = dz(t+1)·Uᵀ + dz_above(t)·W_aboveᵀ (+ dh_last on the top layer),
// gate_bwd with the dc carry; every layer's dz goes out for weight_grad, and
// dx_t = dz_0(t)·W_0ᵀ.
//
// As the forward, a group of S lanes of one warp owns unit j of layer i for
// the CTA's NARROW_ROWS rows, lane-major, and splits its dots: the z dot over
// the din + n inputs (lane l takes k = l, l + S, ...), and the dh dot over
// the n own units of dz(t+1) and the n_above units of dz_above(t), as one
// range of n + n_above terms; reduce_lanes sums both, and gate_bwd runs in
// the owning lane's registers, where the dc carry stays for all T steps.
// dx is a layer of d units below layer 0 with groups of its own: dx unit k
// has group Σn + k, and where the block's 1024 threads run out (S = 1 at
// 8x128), group Σn + k - groups, one of layer 0's.
//
// The layers run as a reverse wavefront: at step s layer i computes
// t = T - 1 - s + (L - 1 - i) and the dx layer t = T - 1 - s + L, so every
// layer runs one step behind the layer above, whose dz(t) it reads, and one
// step after its own dz(t + 1): both were written at step s - 1. T + L
// steps. Every layer's dz lives in the two parities of dzs ([row][unit],
// four gates a float4), written at step s into parity s & 1 and read from
// the other, behind one barrier a step. A layer idle at the top of the
// sequence reads zeros, its dz(T).
//
// z's inputs do not depend on the chain: at step s layer i reads
// [h_{i-1}(t) | h_i(t - 1)], and h_{i-1}(t) is layer i - 1's own h(t' - 1) at
// its t' = t + 1. So one state vector [x | h_0 | ... | h_{L-1}] of float4
// entries, four rows each (the forward's), holds at step s x(t_0) and every
// h_i(t_i - 1), and layer i's input is one contiguous range of it. The
// vector of step s + 1 is loaded from the forward's outputs at the top of
// step s into registers and stored into the other parity at its end; so are
// each owner's c(t - 2) and dh_last (top layer).
//
// Weights, gate-interleaved as [k][j][4] (one 16-byte load gives four
// gates): the z dot reads column j (entries (k, j) over k), the dh dot row j
// of U_i and of W_{i+1} (entries (din + j, m), (j, m) over m), dx row k of
// W_0. kStaged stages every layer's [W; U] rows into shared memory at the
// odd row stride n | 1, so 8 units at one m hit distinct banks; without it
// the kernel reads the wrapper's copy P (row stride n) through __ldg.
// ---------------------------------------------------------------------------
#define BWD_MAX_THREADS 1024

struct BwdLayer {
  int din, n;
  const float* W;  // (din, 4n)
  const float* U;  // (n, 4n)
  const float* b;  // (4n)
  const float* P;  // (din + n, n, 4), or null: staged from W and U
  const float* h;  // (T, B, n), the forward's
  const float* c;  // (T, B, n)
  float* dz;       // (T, B, 4n)
};

struct BwdArgs {
  int L;
  BwdLayer l[MAX_LAYERS];
};

// float4 entries of the staged weights: row stride n | 1
inline int bwd_weight_entries(const BwdArgs& a) {
  int e = 0;
  for (int i = 0; i < a.L; ++i) e += (a.l[i].din + a.l[i].n) * (a.l[i].n | 1);
  return e;
}

// floats of the state vector each thread loads a step: enough for its
// R·(d + Σn) floats at the wrapper's S and threads (its twin:
// ops/cuda_train.py: BWD_LOADS; change both together)
template <int S> __host__ __device__ constexpr int bwd_loads() {
  return S == 1 ? 5 : S == 2 ? 2 : 1;
}

template <int S, bool kStaged>
__global__ void __launch_bounds__(BWD_MAX_THREADS)
narrow_bwd_wave(BwdArgs a, const float* __restrict__ x, const float* __restrict__ dhl,
                float* __restrict__ dx, int T, int B, int d, int V, int nsum) {
  extern __shared__ float4 bwd_smem[];
  constexpr int R = NARROW_ROWS;
  constexpr int RL = S >= 4 ? 1 : 4 / S;  // rows a lane updates
  constexpr int PF = bwd_loads<S>();
  constexpr int G = 32 / S;
  const int L = a.L;
  const int tid = threadIdx.x, row0 = blockIdx.x * R;
  const int lane = tid & 31, l = lane / G, g = (tid >> 5) * G + lane % G;
  const int groups = blockDim.x / S;

  // this thread's unit (layer li, unit j), where its layer's and the layer
  // above's units start in dzs, its h in the state and its weights
  int li = -1, j = 0, u_off = 0, u_up = 0, h_off = 0, w_off = 0, w_up = 0, wo = 0;
  {
    int u = 0, so = d;
    for (int i = 0; i < L; ++i) {
      const int n = a.l[i].n;
      if (li >= 0 && i == li + 1) {
        u_up = u;
        w_up = wo;
      }
      if (li < 0 && g < u + n) {
        li = i;
        j = g - u;
        u_off = u;
        h_off = so;
        w_off = wo;
      }
      u += n;
      wo += (a.l[i].din + n) * (n | 1);
      so += n;
    }
  }

  if constexpr (kStaged) {
    int w_entries = 0;
    for (int i = 0; i < L; ++i) {
      const BwdLayer& ly = a.l[i];
      const int n = ly.n, din = ly.din, ns = n | 1;
      for (int e = tid; e < (din + n) * n; e += blockDim.x) {
        const int k = e / n, jj = e % n;
        const float* src = k < din ? ly.W + (size_t)k * 4 * n : ly.U + (size_t)(k - din) * 4 * n;
        bwd_smem[w_entries + k * ns + jj] =
            make_float4(src[jj], src[n + jj], src[2 * n + jj], src[3 * n + jj]);
      }
      w_entries += (din + n) * ns;
    }
  }
  float4* state = bwd_smem + (kStaged ? wo : 0);  // two parities of V entries
  float* statef = reinterpret_cast<float*>(state);
  float4* dzs = state + 2 * V;  // two parities of [row][unit]
  for (int e = tid; e < 2 * R * nsum; e += blockDim.x) dzs[e] = make_float4(0.f, 0.f, 0.f, 0.f);

  const bool unit = li >= 0;
  const bool top = li == L - 1;
  const int n = unit ? a.l[li].n : 0;
  const int din = unit ? a.l[li].din : 0;
  const int n_up = unit && !top ? a.l[li + 1].n : 0;
  const int in_off = h_off - din;
  const int KZ = unit ? (din + n - l + S - 1) / S : 0;  // z dot: k = l + kb·S < din + n
  const int KA = unit ? (n - l + S - 1) / S : 0;        // dh dot, own dz: m = l + kb·S < n
  const int lb = ((l - n) % S + S) % S;                 // ... above: m = lb + kb·S < n_up
  const int KB = (n_up - lb + S - 1) / S;
  // the dx unit kx this group owns, if any
  const int kx = g >= nsum ? g - nsum : g + groups - nsum;
  const bool dx_unit = kx < d;
  const int n0 = a.l[0].n;
  const int KX = dx_unit ? (n0 - l + S - 1) / S : 0;

  // Where this lane's dots start: the z dot at state entry k = l and weight
  // entry (l, j) of layer li, a lane step S entries and S weight rows on;
  // the dh dot at dz unit m = l of its layer with entry (din + j, l), then at
  // m = lb of the layer above with entry (j, lb) of that layer; the dx dot
  // at dz unit m = l of layer 0 with entry (kx, l). Weight entry (k, m) of
  // layer i lies at k·ws_i + m from the layer's first.
  const float4* zw = nullptr;
  const float4* aw = nullptr;
  const float4* bw = nullptr;
  const float4* xw = nullptr;
  const int ws = kStaged ? n | 1 : n;
  const int zs = in_off + l, za = u_off + l, zb = u_up + lb;
  {
    const float4* base = kStaged ? bwd_smem : nullptr;
    if (unit) {
      const float4* wi = kStaged ? base + w_off : reinterpret_cast<const float4*>(a.l[li].P);
      zw = wi + l * ws + j;
      aw = wi + (din + j) * ws + l;
    }
    if (unit && !top) {
      const float4* wu = kStaged ? base + w_up : reinterpret_cast<const float4*>(a.l[li + 1].P);
      bw = wu + j * (kStaged ? n_up | 1 : n_up) + lb;
    }
    if (dx_unit) {
      const float4* w0 = kStaged ? base : reinterpret_cast<const float4*>(a.l[0].P);
      xw = w0 + kx * (kStaged ? n0 | 1 : n0) + l;
    }
  }
  auto wload = [](const float4* p) {
    if constexpr (kStaged) {
      return *p;
    } else {
      return __ldg(p);
    }
  };

  float bias[4] = {0.f, 0.f, 0.f, 0.f};
  if (unit) {
#pragma unroll
    for (int q = 0; q < 4; ++q) bias[q] = __ldg(a.l[li].b + q * n + j);
  }
  unsigned mask = 0;  // the group's lanes
#pragma unroll
  for (int q = 0; q < S; ++q) mask |= 1u << (q * G + lane % G);
  const int r0 = fwd_first_row<S>(l);
  const bool owner = S < 8 || (l & 1) == 0;
  const bool carrier = unit && owner;
  const int nlast = a.l[L - 1].n;
  const int tbase = T + L - 2 - li;  // layer li's t at step s: tbase - s
  const float* c_in = unit ? a.l[li].c : nullptr;
  float* dz_out = unit ? a.l[li].dz : nullptr;

  // the owner's c(tt) and dh_last(tt) of its row q: 0 outside [0, T) and for
  // rows >= B
  auto c_at = [&](int tt, int q) {
    const int row = row0 + r0 + q;
    return (tt >= 0 && tt < T && row < B) ? c_in[((size_t)tt * B + row) * n + j] : 0.f;
  };
  auto dhl_at = [&](int tt, int q) {
    const int row = row0 + r0 + q;
    return (top && tt >= 0 && tt < T && row < B) ? dhl[((size_t)tt * B + row) * nlast + j] : 0.f;
  };
  // the state vector of step s + 1: entry k of row r (element e = r·V + k)
  // is x(T + L - 3 - s) for k < d, else h_i(T + L - 4 - s - i) of its layer
  auto load_state = [&](int s, float (&buf)[PF]) {
#pragma unroll
    for (int q = 0; q < PF; ++q) {
      const int e = tid + q * blockDim.x;
      float v = 0.f;
      const int r = e / V, k = e % V, row = row0 + r;
      if (e < R * V && row < B) {
        if (k < d) {
          const int tt = T + L - 3 - s;
          if (tt >= 0 && tt < T) v = x[((size_t)tt * B + row) * d + k];
        } else {
          int so = d;
          for (int i = 0; i < L; ++i) {
            const int ni = a.l[i].n;
            if (k < so + ni) {
              const int tt = T + L - 4 - s - i;
              if (tt >= 0 && tt < T) v = a.l[i].h[((size_t)tt * B + row) * ni + k - so];
              break;
            }
            so += ni;
          }
        }
      }
      buf[q] = v;
    }
  };
  auto store_state = [&](int s, const float (&buf)[PF]) {
    const int Q = s & 1;
#pragma unroll
    for (int q = 0; q < PF; ++q) {
      const int e = tid + q * blockDim.x;
      if (e < R * V) statef[(Q * V + e % V) * R + e / V] = buf[q];
    }
  };

  float dc[RL], ct[RL], cp[RL], dht[RL];
#pragma unroll
  for (int q = 0; q < RL; ++q) {
    dc[q] = 0.f;
    ct[q] = carrier ? c_at(tbase, q) : 0.f;
    cp[q] = carrier ? c_at(tbase - 1, q) : 0.f;
    dht[q] = carrier ? dhl_at(T - 1, q) : 0.f;
  }
  float hb[PF];
  load_state(-1, hb);
  store_state(-1, hb);  // into parity 1, read at s = 0
  __syncthreads();

  const int steps = T + L;
  for (int s = 0; s < steps; ++s) {
    const int P = (s + 1) & 1, Q = s & 1;
    const bool more = s + 1 < steps;
    if (more) load_state(s, hb);
    float cn[RL], dhn[RL];
#pragma unroll
    for (int q = 0; q < RL; ++q) {
      cn[q] = carrier ? c_at(tbase - s - 2, q) : 0.f;
      dhn[q] = carrier ? dhl_at(T - 2 - s, q) : 0.f;
    }
    const int t = tbase - s;
    if (unit && t >= 0 && t < T) {
      // z = [h_{i-1}(t) | h_i(t - 1)]·[W; U], without the bias, summed over
      // the group first: its 16 sums are not live through the dh dot
      float v[16];
#pragma unroll
      for (int q = 0; q < 16; ++q) v[q] = 0.f;
      const float4* sp = state + P * V + zs;
#pragma unroll 2
      for (int kb = 0; kb < KZ; ++kb) {
        const float4 hv = sp[kb * S];
        const float4 w = wload(zw + kb * S * ws);
        const float hr[4] = {hv.x, hv.y, hv.z, hv.w};
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          v[r * 4 + 0] = fmaf(hr[r], w.x, v[r * 4 + 0]);
          v[r * 4 + 1] = fmaf(hr[r], w.y, v[r * 4 + 1]);
          v[r * 4 + 2] = fmaf(hr[r], w.z, v[r * 4 + 2]);
          v[r * 4 + 3] = fmaf(hr[r], w.w, v[r * 4 + 3]);
        }
      }
      reduce_lanes<S>(v, l, mask);
      // dh = dz_i(t + 1)·U_iᵀ + dz_{i+1}(t)·W_{i+1}ᵀ: row j of each
      float u[4] = {0.f, 0.f, 0.f, 0.f};
      const float4* dp = dzs + P * R * nsum;
#pragma unroll 1
      for (int kb = 0; kb < KA; ++kb) {
        const float4 w = wload(aw + kb * S);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float4 z4 = dp[r * nsum + za + kb * S];
          u[r] = fmaf(z4.x, w.x, u[r]);
          u[r] = fmaf(z4.y, w.y, u[r]);
          u[r] = fmaf(z4.z, w.z, u[r]);
          u[r] = fmaf(z4.w, w.w, u[r]);
        }
      }
#pragma unroll 1
      for (int kb = 0; kb < KB; ++kb) {
        const float4 w = wload(bw + kb * S);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float4 z4 = dp[r * nsum + zb + kb * S];
          u[r] = fmaf(z4.x, w.x, u[r]);
          u[r] = fmaf(z4.y, w.y, u[r]);
          u[r] = fmaf(z4.z, w.z, u[r]);
          u[r] = fmaf(z4.w, w.w, u[r]);
        }
      }
      reduce_lanes<S>(u, l, mask);
      if (owner) {
#pragma unroll
        for (int q = 0; q < RL; ++q) {
          const int r = r0 + q, row = row0 + r;
          float gz[4];
          dc[q] = gate_bwd(v[q * 4 + 0] + bias[0], v[q * 4 + 1] + bias[1], v[q * 4 + 2] + bias[2],
                           v[q * 4 + 3] + bias[3], cp[q], ct[q], u[q] + dht[q], dc[q], gz);
          dzs[(Q * R + r) * nsum + u_off + j] = make_float4(gz[0], gz[1], gz[2], gz[3]);
          if (row < B) {
            float* out = dz_out + ((size_t)t * B + row) * 4 * n + j;
#pragma unroll
            for (int q4 = 0; q4 < 4; ++q4) out[q4 * n] = gz[q4];
          }
        }
      }
    }
    // dx(t) = dz_0(t)·W_0ᵀ, row kx of W_0
    const int tx = T + L - 1 - s;
    if (dx_unit && tx < T) {
      float u[4] = {0.f, 0.f, 0.f, 0.f};
      const float4* dp = dzs + P * R * nsum + l;
#pragma unroll 1
      for (int kb = 0; kb < KX; ++kb) {
        const float4 w = wload(xw + kb * S);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float4 z4 = dp[r * nsum + kb * S];
          u[r] = fmaf(z4.x, w.x, u[r]);
          u[r] = fmaf(z4.y, w.y, u[r]);
          u[r] = fmaf(z4.z, w.z, u[r]);
          u[r] = fmaf(z4.w, w.w, u[r]);
        }
      }
      reduce_lanes<S>(u, l, mask);
      if (owner) {
#pragma unroll
        for (int q = 0; q < RL; ++q) {
          const int row = row0 + r0 + q;
          if (row < B) dx[((size_t)tx * B + row) * d + kx] = u[q];
        }
      }
    }
    if (more) store_state(s, hb);
    __syncthreads();
#pragma unroll
    for (int q = 0; q < RL; ++q) {
      ct[q] = cp[q];
      cp[q] = cn[q];
      dht[q] = dhn[q];
    }
  }
}

// ---------------------------------------------------------------------------
// K9 and K6 backward — replace pallas_train_wide.py:_wide_bwd and
// pallas_train.py:_pallas_bwd. Four phases, a launch each (the weight
// gradients two GEMMs and their ordered sum, K6's one), none a launch per
// step:
//
//   R  z = x·W + h_prev·U + b over all M = T·B rows (K6: z = xp + h_prev·U),
//      gemm_f32 in its NN form; h_prev is h read B rows back, zero for t = 0;
//   C  the dh chain, the only recurrent part: wide_bwd_chain, one persistent
//      cooperative launch, T steps of dh = dh_seq[t] + dz_{t+1}·Uᵀ, gate_bwd
//      and dz_t out, one grid barrier a step;
//   X  dx = dz·Wᵀ (K9), gemm_f32 in its NT form;
//   G  dW, db and dU, gemm_f32 in its TN form, split over M in a fixed order
//      and summed by sum_splits in order: no atomics, so the gradients do
//      not change from run to run.
//
// K9f and K6f (bf16 operands) run the same four phases with gemm_bf16 in
// place of gemm_f32 and the chain's BF16 instantiation, which also writes
// dz's bf16 copy for X and G; their db is weight_grad's unrounded sum.
//
// What bounds it, and what the design does about it: at 3x512, B = 128,
// T = 200 the backward is 322 GFLOP (4.8 ms at 67 TFLOP/s float32 on the
// CUDA cores; exact mode keeps the tensor cores out). Only the dh chain
// depends on the previous step: R, X and G are large GEMMs at full
// occupancy, and the chain keeps its units' columns of U on chip for all T
// steps (PERF.md §6 gives each phase's time against its bound and against
// cuBLAS on the same products).
// ---------------------------------------------------------------------------
// 4 bytes global -> shared, zero-filled where !pred (src is then not read)
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(pred ? 4 : 0));
}

// 16 bytes global -> shared through L2 only: the first `bytes` bytes of src,
// zero-filled past them (0: src is not read)
__device__ __forceinline__ void cp_async16(float* dst, const float* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// ---------------------------------------------------------------------------
// gemm_f32: C (M, N) = Σ_seg A_seg·B_seg (+ bias[j]) (+ addend[i][j]), float32
// on the CUDA cores with fmaf. A CTA owns a BM x BN tile, a thread 8 x 8 of
// it (two 4-row and two 4-column strips, so its shared-memory reads are
// 16-byte and conflict-free); K runs in chunks of GM_BK, each staged by
// cp.async into one of two shared-memory buffers while the other is
// multiplied, one barrier a chunk. The operand forms are template flags
// (kAT: A is read transposed, kBT: B is), giving the NN (phase R), NT (X)
// and TN (G) products without a branch in the loads: an operand whose
// memory runs along the tile's shared-memory rows (A transposed, B as it
// is) comes in 16-byte copies where its row stride and base allow, any
// other one element by element (the transposing store). Every copy is
// masked (rows, columns and K; a partial 16-byte run is zero-filled past
// its end), so no shape needs padding. shift reads stored row r - shift of
// A (h_prev from h); ones_row makes row ones_row of A all ones (db beside
// dW). With gridDim.z > 1 split s sums k in [s·kchunk, (s + 1)·kchunk) into
// C + s·split_stride.
// ---------------------------------------------------------------------------
#define GM_BM 128  // the CTA tile, rows x columns of C
#define GM_BN 128
#define GM_BK 16
#define GM_MAX_SEGS 2

struct GemmSeg {
  const float* A;
  const float* B;
  int lda, ldb;
  int shift;     // A(i, k) reads stored row r - shift (r = i, or k when transposed); zero for r < shift
  int ones_row;  // A(ones_row, k) = 1 for every k in range (-1: none)
  int K;
  int vec_a, vec_b;  // set by the launcher: 16-byte copies allowed (aligned, stride % 4 == 0)
};

struct GemmArgs {
  GemmSeg seg[GM_MAX_SEGS];
  int nseg;
  float* C;
  int ldc, M, N;
  const float* bias;    // (N,) or null
  const float* addend;  // (M, N) at row stride ldc, or null
  int kchunk;
  long long split_stride;
};

// seg[second], field by field: no local-memory copy of the parameters
__device__ __forceinline__ GemmSeg pick_seg(const GemmArgs& a, bool second) {
  const GemmSeg &s0 = a.seg[0], &s1 = a.seg[1];
  GemmSeg g;
  g.A = second ? s1.A : s0.A;
  g.B = second ? s1.B : s0.B;
  g.lda = second ? s1.lda : s0.lda;
  g.ldb = second ? s1.ldb : s0.ldb;
  g.shift = second ? s1.shift : s0.shift;
  g.ones_row = second ? s1.ones_row : s0.ones_row;
  g.K = second ? s1.K : s0.K;
  g.vec_a = second ? s1.vec_a : s0.vec_a;
  g.vec_b = second ? s1.vec_b : s0.vec_b;
  return g;
}

// A(i, k) for the tile of rows [i0, i0 + BM) and chunk [k0, kend): into
// As[k][i]. Transposed A (kAT) runs along i in memory.
template <int BM, int NT, bool kAT>
__device__ __forceinline__ void gemm_load_a(float (*As)[BM + 4], const GemmSeg& g, int M, int i0,
                                            int k0, int kend) {
  const int tid = threadIdx.x;
  // rows of A in memory: those below ones_row (or M)
  const int ia = g.ones_row >= 0 ? min(M, g.ones_row) : M;
  if (kAT && g.vec_a) {
#pragma unroll
    for (int q = 0; q < BM * GM_BK / 4 / NT; ++q) {
      const int e = tid + q * NT;
      const int ii = (e % (BM / 4)) * 4, kk = e / (BM / 4);
      const int i = i0 + ii, k = k0 + kk;
      const bool krow = k < kend && k >= g.shift;
      const int in = krow ? max(0, min(4, ia - i)) : 0;
      if (in > 0) {
        cp_async16(&As[kk][ii], g.A + (size_t)(k - g.shift) * g.lda + i, 4 * in);
      } else {
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (k < kend && g.ones_row >= i && g.ones_row < i + 4 && g.ones_row < M) v.x = 1.f;  // ones_row % 4 == 0
        *reinterpret_cast<float4*>(&As[kk][ii]) = v;
      }
    }
  } else {
#pragma unroll
    for (int q = 0; q < BM * GM_BK / NT; ++q) {
      const int e = tid + q * NT;
      // neighbouring threads on neighbouring addresses of memory
      const int ii = kAT ? e % BM : e / GM_BK, kk = kAT ? e / BM : e % GM_BK;
      const int i = i0 + ii, k = k0 + kk;
      const int r = kAT ? k : i;
      if (i == g.ones_row) {
        As[kk][ii] = i < M && k < kend ? 1.f : 0.f;
        continue;
      }
      const bool ok = i < ia && k < kend && r >= g.shift;
      const float* src = ok ? g.A + (size_t)(r - g.shift) * g.lda + (kAT ? i : k) : g.A;
      cp_async4(&As[kk][ii], src, ok);
    }
  }
}

// B(k, j) for the tile of columns [j0, j0 + BN) and chunk [k0, kend): into
// Bs[k][j]. B as it is (!kBT) runs along j in memory.
template <int BN, int NT, bool kBT>
__device__ __forceinline__ void gemm_load_b(float (*Bs)[BN + 4], const GemmSeg& g, int N, int j0,
                                            int k0, int kend) {
  const int tid = threadIdx.x;
  if (!kBT && g.vec_b) {
#pragma unroll
    for (int q = 0; q < BN * GM_BK / 4 / NT; ++q) {
      const int e = tid + q * NT;
      const int jj = (e % (BN / 4)) * 4, kk = e / (BN / 4);
      const int j = j0 + jj, k = k0 + kk;
      const int in = k < kend ? max(0, min(4, N - j)) : 0;
      cp_async16(&Bs[kk][jj], in > 0 ? g.B + (size_t)k * g.ldb + j : g.B, 4 * in);
    }
  } else {
#pragma unroll
    for (int q = 0; q < BN * GM_BK / NT; ++q) {
      const int e = tid + q * NT;
      const int jj = kBT ? e / GM_BK : e % BN, kk = kBT ? e % GM_BK : e / BN;
      const int j = j0 + jj, k = k0 + kk;
      const bool ok = j < N && k < kend;
      const float* src = ok ? g.B + (kBT ? (size_t)j * g.ldb + k : (size_t)k * g.ldb + j) : g.B;
      cp_async4(&Bs[kk][jj], src, ok);
    }
  }
}

template <int BM, int BN, bool kAT, bool kBT>
__global__ void __launch_bounds__((BM / 8) * (BN / 8), 512 / ((BM / 8) * (BN / 8)))
gemm_f32(const GemmArgs a) {
  constexpr int NT = (BM / 8) * (BN / 8);
  // rows padded by 4 words: a transposing store of GM_BK k's x 4 rows hits 32 banks
  __shared__ __align__(16) float As[2][GM_BK][BM + 4];
  __shared__ __align__(16) float Bs[2][GM_BK][BN + 4];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // a warp holds 4 x 8 threads' tiles (32 rows x 64 columns): its A reads
  // are 4 addresses, its B reads 8 (one shared-memory wavefront each)
  constexpr int WX = BN / 64;  // warps across the tile's columns
  const int ty = (warp / WX) * 4 + lane / 8, tx = (warp % WX) * 8 + lane % 8;
  const int i0 = blockIdx.y * BM, j0 = blockIdx.x * BN;
  const bool split = gridDim.z > 1;
  int kb[GM_MAX_SEGS], ke[GM_MAX_SEGS], nc[GM_MAX_SEGS];
#pragma unroll
  for (int s = 0; s < GM_MAX_SEGS; ++s) {
    const int K = s < a.nseg ? a.seg[s].K : 0;
    kb[s] = split ? min(K, (int)blockIdx.z * a.kchunk) : 0;
    ke[s] = split ? min(K, kb[s] + a.kchunk) : K;
    nc[s] = (ke[s] - kb[s] + GM_BK - 1) / GM_BK;
  }
  auto load = [&](int c, int buf) {
    const bool second = c >= nc[0];
    const GemmSeg g = pick_seg(a, second);
    const int k0 = second ? kb[1] + (c - nc[0]) * GM_BK : kb[0] + c * GM_BK;
    const int kend = second ? ke[1] : ke[0];
    gemm_load_a<BM, NT, kAT>(As[buf], g, a.M, i0, k0, kend);
    gemm_load_b<BN, NT, kBT>(Bs[buf], g, a.N, j0, k0, kend);
    cp_async_commit();
  };
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  const int chunks = nc[0] + nc[1];
  if (chunks > 0) load(0, 0);
  for (int c = 0; c < chunks; ++c) {
    cp_async_wait<0>();  // chunk c has landed (the only copies in flight)
    __syncthreads();     // ... for every thread; and chunk c - 1's buffer is free
    if (c + 1 < chunks) load(c + 1, (c + 1) & 1);  // in flight while chunk c is multiplied
    const int buf = c & 1;
    // the next k's fragments are read while this k's are multiplied
    float4 frag[2][4];
    auto read = [&](int kk, float4* f) {
      f[0] = *reinterpret_cast<const float4*>(&As[buf][kk][ty * 4]);
      f[1] = *reinterpret_cast<const float4*>(&As[buf][kk][BM / 2 + ty * 4]);
      f[2] = *reinterpret_cast<const float4*>(&Bs[buf][kk][tx * 4]);
      f[3] = *reinterpret_cast<const float4*>(&Bs[buf][kk][BN / 2 + tx * 4]);
    };
    read(0, frag[0]);
#pragma unroll
    for (int kk = 0; kk < GM_BK; ++kk) {
      if (kk + 1 < GM_BK) read(kk + 1, frag[(kk + 1) & 1]);
      const float4* f = frag[kk & 1];
      const float av[8] = {f[0].x, f[0].y, f[0].z, f[0].w, f[1].x, f[1].y, f[1].z, f[1].w};
      const float bv[8] = {f[2].x, f[2].y, f[2].z, f[2].w, f[3].x, f[3].y, f[3].z, f[3].w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
  float* C = a.C + (size_t)blockIdx.z * a.split_stride;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = i0 + (i < 4 ? ty * 4 + i : BM / 2 + ty * 4 + i - 4);
    if (row >= a.M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = j0 + (j < 4 ? tx * 4 + j : BN / 2 + tx * 4 + j - 4);
      if (col >= a.N) continue;
      float v = acc[i][j];
      if (a.bias != nullptr) v += __ldg(a.bias + col);
      if (a.addend != nullptr) v += __ldg(a.addend + (size_t)row * a.ldc + col);
      C[(size_t)row * a.ldc + col] = v;
    }
  }
}

// ---------------------------------------------------------------------------
// gemm_bf16: phases R, X and G of K9f's and K6f's backward and K9f's forward
// x-side (the bf16-operand variants of pallas_train_wide.py:_wide_bwd /
// _wide_fwd and pallas_train.py:_pallas_bwd, whose dots are DEFAULT, one
// bf16 pass, on the TPU) on the tensor cores: C (M, N) = Σ_seg A_seg·B_seg
// (+ bias[j]) (+ addend[i][j]) with bf16 operands and float32 sums. The
// product of two bf16 values is exact in float32, so this is the arithmetic
// of the plain bf16 versions (ops/cuda_train.py: operands rounded by the
// copies below) with the float32 sums in another order.
//
// What bounds it: at 3x512, B = 128, T = 200 phases R, X and G are 268 GFLOP,
// 0.27 ms at the card's 989 TFLOP/s bf16 rate, against 4.0 ms at 67 TFLOP/s
// on the CUDA cores (gemm_f32); their bytes (z, dx and the bf16 operands,
// ~0.5 GB) take ~0.15 ms. What the design does about it:
//  * Operands come as bf16 copies, rounded once a call (bf16_copy; the chain
//    writes dz's), each a row-major (rows, ld) matrix whose row stride ld is
//    padded with zeros to a multiple of 8 (16 bytes, TMA's stride rule; W's
//    copy also has as many rows as x's copy has columns, so the K of x·W runs
//    over whole padded rows of both). Every tile is loaded in its memory's
//    own orientation by TMA (a CUtensorMap a operand and segment, 128-byte
//    swizzle, boxes of 64 columns); the transposes are wgmma's: A K-major in
//    the NN (R) and NT (X) forms and M-major in TN (G), B N-major in NN and
//    TN and K-major in NT. Ragged M, N and K edges, and h_prev's rows before
//    t = 0 (the box starts shift rows up: a negative coordinate), are TMA's
//    zero fill.
//  * A CTA owns a 128 x 128 tile of C. One producer warp keeps a ring of
//    GB_STAGES stages of 64-deep K chunks in flight (mbarriers: full with the
//    transaction bytes, empty with a consumer warp's arrival each); two
//    consumer warpgroups each issue wgmma m64n128k16 on 64 rows of the tile,
//    keep one chunk's products in flight and release the stage before it.
//  * The epilogue adds the bias (R, K9) or the addend xp (R, K6) in float32
//    and stores C. With gridDim.z > 1 split s sums k in [s·kchunk, (s + 1)·
//    kchunk) (kchunk a multiple of GB_BK, so no box crosses into the next
//    split) into C + s·split_stride, and sum_splits adds the splits in order
//    (phase G): the gradients do not change from run to run.
// ---------------------------------------------------------------------------
#define GB_BM 128
#define GB_BN 128
#define GB_BK 64          // the K chunk: 64 bf16, one 128-byte swizzled row
#define GB_STAGES 4
#define GB_CONSUMERS 2    // warpgroups, 64 rows of the tile each
#define GB_THREADS (GB_CONSUMERS * 128 + 32)
#define GB_TILE_BYTES (GB_BM * GB_BK * 2)  // one operand's tile of a chunk: 16 KB
#define GB_SMEM (GB_STAGES * 2 * GB_TILE_BYTES + 2 * GB_STAGES * 8 + 1024)

struct GemmBf16Args {
  CUtensorMap a[GM_MAX_SEGS];  // A's copy: boxes of 64 columns x 128 rows (K-major) or 64 (M-major)
  CUtensorMap b[GM_MAX_SEGS];  // B's copy: 64 x 64 (N-major) or 64 x 128 (K-major)
  int nseg;
  int K[GM_MAX_SEGS];
  int shift[GM_MAX_SEGS];      // A's stored row r - shift (r = i, or k when M-major)
  float* C;
  int ldc, M, N;
  const float* bias;           // (N,) or null
  const float* addend;         // (M, N) at row stride ldc, or null
  int kchunk;
  long long split_stride;
};

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// until the phase of parity `parity` of the barrier has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const unsigned a = smem_addr(bar);
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  }
}

// a 64-column box of a 2-D tensor map at (column c0, row c1) into shared
// memory, its bytes counted on the barrier; out-of-range elements are zero
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                         int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma's shared-memory matrix descriptor: 128-byte swizzle, the leading and
// stride byte offsets (for a K-major operand the stride is 8 rows of 128
// bytes; for an M- or N-major one the leading offset steps 64 elements of M
// or N and the stride 8 rows of k)
__device__ __forceinline__ uint64_t wgmma_desc(const void* p, unsigned lbo, unsigned sbo) {
  return (uint64_t)((smem_addr(p) >> 4) & 0x3FFF) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// the accumulators are written by the asynchronous products: no read or
// write of them may move across this point
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 128, float32) += A (64 x 16) · B (16 x 128), bf16, from shared
// memory; TA: A M-major, TB: B N-major (wgmma's transpose immediates)
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n128(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p, 1, 1, %67, %68;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// kAT: A read transposed (A(i, k) = stored[k][i], M-major); kBT: B read
// transposed (B(k, j) = stored[j][k], K-major): NN (R), NT (X), TN (G), as
// gemm_f32's flags
template <bool kAT, bool kBT>
__global__ void __launch_bounds__(GB_THREADS, 1) gemm_bf16(const __grid_constant__ GemmBf16Args p) {
  extern __shared__ uint8_t gemm_bf16_smem[];
  // the ring (stages of A's tile then B's), 1024-byte aligned for the swizzle
  uint8_t* ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(gemm_bf16_smem) + 1023) & ~(uintptr_t)1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + GB_STAGES * 2 * GB_TILE_BYTES);
  uint64_t* empty = full + GB_STAGES;
  const int tid = threadIdx.x, wg = tid / 128;
  const bool split = gridDim.z > 1;
  int kb[GM_MAX_SEGS], nc[GM_MAX_SEGS];
#pragma unroll
  for (int s = 0; s < GM_MAX_SEGS; ++s) {
    const int K = s < p.nseg ? p.K[s] : 0;
    kb[s] = split ? min(K, (int)blockIdx.z * p.kchunk) : 0;
    const int ke = split ? min(K, kb[s] + p.kchunk) : K;
    nc[s] = (ke - kb[s] + GB_BK - 1) / GB_BK;
  }
  const int chunks = nc[0] + nc[1];
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < GB_STAGES; ++s) {
      mbar_init(&full[s], 1);                  // the producer's arrival, with the bytes
      mbar_init(&empty[s], GB_CONSUMERS * 4);  // every consumer warp's
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int i0 = blockIdx.y * GB_BM, j0 = blockIdx.x * GB_BN;
  if (wg == GB_CONSUMERS) {  // the producer warp: one thread issues every load
    if (tid % 32 == 0) {
      for (int c = 0; c < chunks; ++c) {
        const int s = c % GB_STAGES, round = c / GB_STAGES;
        if (round > 0) mbar_wait(&empty[s], (round - 1) & 1);
        const bool second = c >= nc[0];
        const int k0 = second ? kb[1] + (c - nc[0]) * GB_BK : kb[0] + c * GB_BK;
        const int sh = second ? p.shift[1] : p.shift[0];
        const CUtensorMap* ma = second ? &p.a[1] : &p.a[0];
        const CUtensorMap* mb = second ? &p.b[1] : &p.b[0];
        uint8_t* As = ring + s * 2 * GB_TILE_BYTES;
        uint8_t* Bs = As + GB_TILE_BYTES;
        mbar_expect_tx(&full[s], 2 * GB_TILE_BYTES);
        if (kAT) {  // stored rows are k: two boxes of 64 i's
          tma_load(As, ma, &full[s], i0, k0 - sh);
          tma_load(As + GB_TILE_BYTES / 2, ma, &full[s], i0 + 64, k0 - sh);
        } else {
          tma_load(As, ma, &full[s], k0, i0 - sh);
        }
        if (kBT) {
          tma_load(Bs, mb, &full[s], k0, j0);
        } else {  // stored rows are k: two boxes of 64 j's
          tma_load(Bs, mb, &full[s], j0, k0);
          tma_load(Bs + GB_TILE_BYTES / 2, mb, &full[s], j0 + 64, k0);
        }
      }
    }
    return;
  }
  // a consumer warpgroup: rows [64·wg, 64·wg + 64) of the tile
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  fence_acc(acc);
  const int lane = tid % 32;
  for (int c = 0; c < chunks; ++c) {
    const int s = c % GB_STAGES;
    mbar_wait(&full[s], (c / GB_STAGES) & 1);
    const uint8_t* As = ring + s * 2 * GB_TILE_BYTES + wg * (GB_TILE_BYTES / 2);
    const uint8_t* Bs = ring + s * 2 * GB_TILE_BYTES + GB_TILE_BYTES;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < GB_BK / 16; ++kk) {
      // a step of 16 k: 32 bytes along a K-major row, 16 rows of 128 bytes of an M- or N-major tile
      const uint64_t da = kAT ? wgmma_desc(As + kk * 2048, GB_TILE_BYTES / 2, 1024)
                              : wgmma_desc(As + kk * 32, 16, 1024);
      const uint64_t db = kBT ? wgmma_desc(Bs + kk * 32, 16, 1024)
                              : wgmma_desc(Bs + kk * 2048, GB_TILE_BYTES / 2, 1024);
      wgmma_m64n128<kAT ? 1 : 0, kBT ? 0 : 1>(acc, da, db);
    }
    wgmma_commit();
    wgmma_wait<1>();  // chunk c - 1's products are done: its stage is free
    fence_acc(acc);
    if (c > 0 && lane == 0) mbar_arrive(&empty[(c - 1) % GB_STAGES]);
  }
  wgmma_wait<0>();
  fence_acc(acc);
  // d[4q + 2h + e]: row 16·warp + lane / 4 + 8h, column 8q + 2·(lane % 4) + e. The
  // bias and the addend are all loaded before the first store (C could alias
  // them for all the compiler knows: a load after a store would wait for it)
  float* C = p.C + (size_t)blockIdx.z * p.split_stride;
  const int wq = (tid % 128) / 32;
  const int row0 = i0 + wg * 64 + wq * 16 + lane / 4, col0 = j0 + 2 * (lane % 4);
  auto in_range = [&](int i) {
    return row0 + 8 * (i / 2 % 2) < p.M && col0 + 8 * (i / 4) + i % 2 < p.N;
  };
  auto at = [&](int i) { return (size_t)(row0 + 8 * (i / 2 % 2)) * p.ldc + col0 + 8 * (i / 4) + i % 2; };
  if (p.bias != nullptr) {
#pragma unroll
    for (int i = 0; i < 64; ++i)
      if (col0 + 8 * (i / 4) + i % 2 < p.N) acc[i] += __ldg(p.bias + col0 + 8 * (i / 4) + i % 2);
  }
  if (p.addend != nullptr) {
#pragma unroll
    for (int i = 0; i < 64; ++i)
      if (in_range(i)) acc[i] += __ldg(p.addend + at(i));
  }
#pragma unroll
  for (int i = 0; i < 64; ++i)
    if (in_range(i)) C[at(i)] = acc[i];
}

// dst (rows_p, ld) = src (rows, cols) rounded to bf16 (to nearest even, as
// torch's .bfloat16()), zero past rows x cols: the operand copies of gemm_bf16 and the
// bf16 dh chain
__global__ void bf16_copy(const float* __restrict__ src, __nv_bfloat16* __restrict__ dst, int rows,
                          int cols, int rows_p, int ld) {
  const long long total = (long long)rows_p * ld;
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x; e < total;
       e += (long long)gridDim.x * blockDim.x) {
    const int r = (int)(e / ld), k = (int)(e % ld);
    dst[e] = __float2bfloat16_rn(r < rows && k < cols ? __ldg(src + (size_t)r * cols + k) : 0.f);
  }
}

// ---------------------------------------------------------------------------
// wide_bwd_chain: phase C, the reverse-time dh chain of one wide layer in one
// persistent cooperative launch (at most one CTA an SM, all co-resident).
//
// A CTA owns J units (blockIdx.x, of unit_groups = n / J) and walks row
// tiles of R batch rows (blockIdx.y, + gridDim.y, ...: more rows a CTA when
// B > R·gridDim.y, never more CTAs). Its units' 4J gate columns of U
// (rows g·n + j of Ut = Uᵀ) are staged in shared memory once, for all T
// steps (kStaged), else read from Ut in global memory through L1. For t =
// T-1 down to 0, for each row tile:
//   * dh_c = dz_{t+1}·Uᵀ for the CTA's cells, as the sum over unit groups
//     u' = 0, 1, ... in order of the partial sums P_{t+1}[u'] that every CTA
//     stored in the previous step (none at t = T-1). P was stored by other
//     CTAs in this launch, so it is read through L2 (ld.global.cg), never by
//     ld.global.nc;
//   * gate_bwd on z (phase R), c_{t-1}, c_t and dh = dh_seq[t] + dh_c, two
//     cells a thread; the dc carry stays in registers for all T steps; dz_t
//     goes to the dz store (K6: dxp itself) and to shared memory. Rows >= B
//     are neither stored nor carried;
//   * (t > 0) P_t[this group][rows][0:n] = dz_t[rows, its 4J columns] ·
//     U[0:n, its 4J columns]ᵀ: R x n sums of 4J products each, a thread 8
//     rows x 8 units (16-byte shared-memory loads, the rows broadcast), into
//     P's parity t & 1;
// then cooperative_groups' grid.sync().
//
// Batch rows are independent in the chain, so a batch larger than one
// launch holds (CHAIN_MAX_ROW_TILES row tiles a CTA, the registers of the
// dc carry) runs as consecutive launches over chunks of rows: the pointers
// start at the chunk's first row, B is the chunk's rows and stride the
// whole batch's (the rows between two steps). Where n / 16 unit groups
// would outnumber the SMs, the wrapper's rule takes a wider unit group
// (R x J = 16 x 32, 8 x 64: two cells a thread all the same).
//
// So no global load sits inside the product: a CTA reads R·J·unit_groups
// floats of P and stores R·n a step (64 KB each way at n = 512, R = 32, J =
// 16). A first version that read dz_{t+1}'s R x 4n floats (256 KB a CTA)
// from L2 each step and multiplied them by U's rows spent longer on those
// loads than on the product, whatever the number of CTAs: a step's loads
// are bound by the bytes a CTA keeps in flight, not by L2's rate.
//
// What bounds it now (PERF.md §6): the product, R·n·4J FMAs a CTA a step
// (1 M at n = 512: ~4 us at the card's FMA rate), then the step's chain of
// latencies: the grid barrier, storing P before it and reading P after it.
// ---------------------------------------------------------------------------
#define CHAIN_THREADS 256
#define CHAIN_MAX_ROW_TILES 8 // row tiles a CTA may walk each step

// Phase C's product in the BF16 instantiation: the group's partial sums of
// dh, the dz tile (R x 4J, bf16, [RP][KP] in shared memory) times the CTA's
// 4J gate columns of U (bf16, staged as [n][KP] rows of U, or read from U's
// copy (n, 4n)), on the tensor cores: mma.sync m16n8k16 bf16 -> float32, A by
// ldmatrix from the dz tile (its fragments held for the whole step), B by
// ldmatrix from the staged rows or as 32-bit pairs from the copy (two
// neighbouring gate columns of one gate are neighbours in U's row). A warp
// takes n tiles of 8 units four at a time, every m tile of the R rows (a
// tile of 8 rows is padded to 16 with zero rows); rows past R or B are not
// stored. Pt (one parity of P) is laid out [reader group][writer group][row]
// [J]: the sums a group reads are J floats a row, R rows a writer, in a
// run. Laid out [writer][row][n] (the float32 chain's), with their 2 KB and
// 256 KB strides, the same reads and stores took ~14 us a step at n = 512,
// B = 128 (PERF.md §6, PR 16), against ~7.5.
template <int R, int J, bool kStaged>
__device__ __forceinline__ void chain_product_bf16(const __nv_bfloat16* dzt,
                                                   const __nv_bfloat16* ust,
                                                   const __nv_bfloat16* __restrict__ Ub, float* Pt,
                                                   int r0, int B, int n, int j0) {
  constexpr int K = 4 * J, KP = K + 8, KS = K / 16, MT = (R + 15) / 16, NB = 4;
  constexpr int WARPS = CHAIN_THREADS / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane >> 2, q = lane & 3;
  const int G = 4 * n, tiles = n / 8;
  uint32_t af[MT][KS][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
      ldmatrix_x4(af[mt][ks], dzt + (mt * 16 + (lane & 15)) * KP + ks * 16 + (lane >> 4) * 8);
  for (int nb = warp * NB; nb < tiles; nb += WARPS * NB) {
    float acc[MT][NB][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NB; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t bf[NB][2];
      if constexpr (kStaged) {
#pragma unroll
        for (int pr = 0; pr < NB / 2; ++pr) {  // n tiles nb + 2pr and nb + 2pr + 1 (rows past n: read, not stored)
          const int a = min((nb + 2 * pr + (lane >> 4)) * 8 + (lane & 7), n - 1);
          uint32_t r[4];
          ldmatrix_x4(r, ust + (size_t)a * KP + ks * 16 + ((lane >> 3) & 1) * 8);
          bf[2 * pr][0] = r[0], bf[2 * pr][1] = r[1], bf[2 * pr + 1][0] = r[2], bf[2 * pr + 1][1] = r[3];
        }
      } else {
#pragma unroll
        for (int nt = 0; nt < NB; ++nt) {
          const __nv_bfloat16* row = Ub + (size_t)min((nb + nt) * 8 + g, n - 1) * G + j0;
          const int k = ks * 16 + 2 * q;
          bf[nt][0] = __ldg(reinterpret_cast<const unsigned int*>(row + (k / J) * n + k % J));
          bf[nt][1] = __ldg(reinterpret_cast<const unsigned int*>(row + ((k + 8) / J) * n + (k + 8) % J));
        }
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NB; ++nt) mma_bf16(acc[mt][nt], af[mt][ks], bf[nt][0], bf[nt][1]);
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NB; ++nt) {
        if (nb + nt >= tiles) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = mt * 16 + g + 8 * h, row = r0 + r;
          if (r < R && row < B)
            *reinterpret_cast<float2*>(Pt + (((size_t)((nb + nt) * 8 / J) * gridDim.x + blockIdx.x) * B + row) * J +
                                       (nb + nt) * 8 % J + 2 * q) =
                make_float2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
        }
      }
  }
}

template <int R, int J, bool kStaged, bool BF16>
__global__ void __launch_bounds__(CHAIN_THREADS, 1)
wide_bwd_chain(const float* __restrict__ z, const float* __restrict__ Ut,
               const __nv_bfloat16* __restrict__ Ub, const float* __restrict__ c,
               const float* __restrict__ dh_seq, float* dz, __nv_bfloat16* dzb, float* P, int T,
               int B, int stride, int n, int row_tiles) {
  constexpr int K = 4 * J;  // the CTA's gate columns
  constexpr int CELLS = R * J / CHAIN_THREADS;
  static_assert(CELLS >= 1 && R % 8 == 0, "every thread a cell; 8-row thread tiles");
  extern __shared__ float4 chain_smem[];
  float* sm = reinterpret_cast<float*>(chain_smem);
  float* dzs = sm;                     // [K][R]: dz_t of the tile's rows at the CTA's columns
  float* us = sm + K * R;              // [K][n]: Ut's rows of the CTA's columns (kStaged)
  // BF16: the dz tile and the staged columns as bf16 rows of KP (16 bytes of
  // padding: the eight rows an ldmatrix reads fall in distinct banks); a
  // thread of the first QUADS owns 4 neighbouring units of one row
  constexpr int KP = K + 8, RP = (R + 15) / 16 * 16, QUADS = R * J / 4;
  static_assert(!BF16 || (J % 8 == 0 && QUADS <= CHAIN_THREADS), "a quad of units a thread");
  __nv_bfloat16* dzt = reinterpret_cast<__nv_bfloat16*>(chain_smem);  // [RP][KP]
  __nv_bfloat16* ust = dzt + RP * KP;                                  // [n][KP]: U's rows (kStaged)
  const int tid = threadIdx.x;
  const int j0 = blockIdx.x * J;
  const int groups = gridDim.x;
  const int G = 4 * n;
  const size_t pstride = (size_t)groups * B * n;  // floats of one parity of P
  auto col = [&](int k) { return (k / J) * n + j0 + k % J; };  // gate column of local k
  if constexpr (BF16) {
    if (kStaged) {  // row a of U at the CTA's 4J columns: 16-byte runs of 8 units
      for (int e = tid; e < n * (K / 8); e += CHAIN_THREADS) {
        const int a = e / (K / 8), k = e % (K / 8) * 8;
        *reinterpret_cast<uint4*>(ust + (size_t)a * KP + k) =
            __ldg(reinterpret_cast<const uint4*>(Ub + (size_t)a * G + col(k)));
      }
    }
    // rows past R and B stay zero; first read after the gate phase's barrier
    for (int e = tid; e < RP * KP / 8; e += CHAIN_THREADS)
      reinterpret_cast<uint4*>(dzt)[e] = make_uint4(0u, 0u, 0u, 0u);
  } else if (kStaged) {
    for (int e = tid; e < K * (n / 4); e += CHAIN_THREADS) {
      const int k = e / (n / 4), a4 = e % (n / 4);
      *reinterpret_cast<float4*>(us + (size_t)k * n + 4 * a4) =
          __ldg(reinterpret_cast<const float4*>(Ut + (size_t)col(k) * n) + a4);
    }
    // first read after the gate phase's barrier
  }
  float dc[CHAIN_MAX_ROW_TILES][CELLS];
#pragma unroll
  for (int q = 0; q < CHAIN_MAX_ROW_TILES; ++q)
#pragma unroll
    for (int p = 0; p < CELLS; ++p) dc[q][p] = 0.f;
  float4 dcq[CHAIN_MAX_ROW_TILES];  // BF16: the quad's dc carry
#pragma unroll
  for (int q = 0; q < CHAIN_MAX_ROW_TILES; ++q) dcq[q] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int t = T - 1; t >= 0; --t) {
    for (int tile = 0; tile < row_tiles; ++tile) {
      const int r0 = (blockIdx.y + tile * gridDim.y) * R;
      if constexpr (BF16) {
        // the gates of a quad: every load and store 16 bytes (8 for bf16), the
        // partial sums P_{t+1} read a float4 a group
        const int r = tid / (J / 4), u0 = tid % (J / 4) * 4, row = r0 + r, j = j0 + u0;
        if (tid < QUADS && row < B) {
          const size_t m = (size_t)t * stride + row;
          float4 zq[4];
#pragma unroll
          for (int g = 0; g < 4; ++g) zq[g] = __ldg(reinterpret_cast<const float4*>(z + m * G + g * n + j));
          const float4 ctq = __ldg(reinterpret_cast<const float4*>(c + m * n + j));
          const float4 cpq = t > 0 ? __ldg(reinterpret_cast<const float4*>(c + (m - stride) * n + j))
                                   : make_float4(0.f, 0.f, 0.f, 0.f);
          float4 dhq = __ldg(reinterpret_cast<const float4*>(dh_seq + m * n + j));
          if (t + 1 < T) {
            // P_{t+1}: this group's units' partial sums from every group
            const float* Pp =
                P + (size_t)((t + 1) & 1) * pstride + ((size_t)blockIdx.x * groups * B + row) * J + u0;
            float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
            for (int u = 0; u < groups; ++u) {  // in group order
              const float4 v = __ldcg(reinterpret_cast<const float4*>(Pp + (size_t)u * B * J));
              s.x += v.x, s.y += v.y, s.z += v.z, s.w += v.w;
            }
            dhq.x += s.x, dhq.y += s.y, dhq.z += s.z, dhq.w += s.w;
          }
          float4 dcv = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
          for (int q = 0; q < CHAIN_MAX_ROW_TILES; ++q)
            if (q == tile) dcv = dcq[q];
          const float zc[4][4] = {{zq[0].x, zq[0].y, zq[0].z, zq[0].w}, {zq[1].x, zq[1].y, zq[1].z, zq[1].w},
                                  {zq[2].x, zq[2].y, zq[2].z, zq[2].w}, {zq[3].x, zq[3].y, zq[3].z, zq[3].w}};
          const float cpa[4] = {cpq.x, cpq.y, cpq.z, cpq.w}, cta[4] = {ctq.x, ctq.y, ctq.z, ctq.w};
          const float dha[4] = {dhq.x, dhq.y, dhq.z, dhq.w};
          float dca[4] = {dcv.x, dcv.y, dcv.z, dcv.w}, g4[4][4];  // [unit][gate]
#pragma unroll
          for (int e = 0; e < 4; ++e)
            dca[e] = gate_bwd(zc[0][e], zc[1][e], zc[2][e], zc[3][e], cpa[e], cta[e], dha[e], dca[e], g4[e]);
#pragma unroll
          for (int q = 0; q < CHAIN_MAX_ROW_TILES; ++q)
            if (q == tile) dcq[q] = make_float4(dca[0], dca[1], dca[2], dca[3]);
          const size_t at = m * G + j;
#pragma unroll
          for (int g = 0; g < 4; ++g) {
            *reinterpret_cast<float4*>(dz + at + g * n) = make_float4(g4[0][g], g4[1][g], g4[2][g], g4[3][g]);
            // rounded once: the product's operand and phases X and G's copy
            const uint2 v = make_uint2(pack2(bf16_bits(g4[0][g]), bf16_bits(g4[1][g])),
                                       pack2(bf16_bits(g4[2][g]), bf16_bits(g4[3][g])));
            *reinterpret_cast<uint2*>(dzt + r * KP + g * J + u0) = v;
            *reinterpret_cast<uint2*>(dzb + at + g * n) = v;
          }
        }
        __syncthreads();  // dzt complete
        if (t > 0) chain_product_bf16<R, J, kStaged>(dzt, ust, Ub, P + (size_t)(t & 1) * pstride, r0, B, n, j0);
        __syncthreads();  // dzt is rewritten by the next tile
        continue;
      }
      float zv[CELLS][4], cp[CELLS], ct[CELLS], dh[CELLS];
#pragma unroll
      for (int p = 0; p < CELLS; ++p) {
        const int o = tid + p * CHAIN_THREADS, row = r0 + o / J, j = j0 + o % J;
        const bool ok = row < B;
        const size_t m = (size_t)t * stride + row;
#pragma unroll
        for (int g = 0; g < 4; ++g) zv[p][g] = ok ? __ldg(z + m * G + g * n + j) : 0.f;
        ct[p] = ok ? __ldg(c + m * n + j) : 0.f;
        cp[p] = ok && t > 0 ? __ldg(c + (m - stride) * n + j) : 0.f;
        dh[p] = ok ? __ldg(dh_seq + m * n + j) : 0.f;
      }
      if (t + 1 < T) {
        const float* Pp = P + (size_t)((t + 1) & 1) * pstride;  // P_{t+1}
#pragma unroll
        for (int p = 0; p < CELLS; ++p) {
          const int o = tid + p * CHAIN_THREADS, row = r0 + o / J, j = j0 + o % J;
          if (row >= B) continue;
          float dh_c = 0.f;
          for (int u = 0; u < groups; ++u) dh_c += __ldcg(Pp + ((size_t)u * B + row) * n + j);
          dh[p] += dh_c;
        }
      }
#pragma unroll
      for (int p = 0; p < CELLS; ++p) {
        const int o = tid + p * CHAIN_THREADS, r = o / J, u = o % J, row = r0 + r;
        if (row >= B) continue;
        float dcv = 0.f;
#pragma unroll
        for (int q = 0; q < CHAIN_MAX_ROW_TILES; ++q)
          if (q == tile) dcv = dc[q][p];
        float g4[4];
        dcv = gate_bwd(zv[p][0], zv[p][1], zv[p][2], zv[p][3], cp[p], ct[p], dh[p], dcv, g4);
#pragma unroll
        for (int q = 0; q < CHAIN_MAX_ROW_TILES; ++q)
          if (q == tile) dc[q][p] = dcv;
        float* out = dz + ((size_t)t * stride + row) * G + j0 + u;
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          out[g * n] = g4[g];
          dzs[(g * J + u) * R + r] = g4[g];
        }
      }
      __syncthreads();  // dzs complete
      if (t > 0) {
        float* Pt = P + (size_t)(t & 1) * pstride + (size_t)blockIdx.x * B * n;  // P_t[this group]
        for (int q = tid; q < (R / 8) * (n / 8); q += CHAIN_THREADS) {
          const int ty = q / (n / 8), tx = q % (n / 8);
          float acc[8][8];
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
#pragma unroll 4
          for (int k = 0; k < K; ++k) {
            const float4 d0 = *reinterpret_cast<const float4*>(dzs + k * R + ty * 4);
            const float4 d1 = *reinterpret_cast<const float4*>(dzs + k * R + R / 2 + ty * 4);
            float4 w0, w1;
            if (kStaged) {
              w0 = *reinterpret_cast<const float4*>(us + (size_t)k * n + tx * 4);
              w1 = *reinterpret_cast<const float4*>(us + (size_t)k * n + n / 2 + tx * 4);
            } else {
              const float* ur = Ut + (size_t)col(k) * n;
              w0 = __ldg(reinterpret_cast<const float4*>(ur + tx * 4));
              w1 = __ldg(reinterpret_cast<const float4*>(ur + n / 2 + tx * 4));
            }
            const float dv[8] = {d0.x, d0.y, d0.z, d0.w, d1.x, d1.y, d1.z, d1.w};
            const float wv[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
            for (int i = 0; i < 8; ++i)
#pragma unroll
              for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(dv[i], wv[j], acc[i][j]);
          }
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const int row = r0 + (i < 4 ? ty * 4 + i : R / 2 + ty * 4 + i - 4);
            if (row >= B) continue;
            float* pr = Pt + (size_t)row * n;
            *reinterpret_cast<float4*>(pr + tx * 4) =
                make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
            *reinterpret_cast<float4*>(pr + n / 2 + tx * 4) =
                make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
          }
        }
      }
      __syncthreads();  // dzs is rewritten by the next tile
    }
    if (t > 0) cooperative_groups::this_grid().sync();
  }
}


// ---------------------------------------------------------------------------
// K9 and K6 forward — replace pallas_train_wide.py:_wide_fwd and
// pallas_train.py:_pallas_fwd_hc. Two parts, neither a launch a step:
//
//   x-side (K9 only): xz = x·W + b over all M = T·B rows, gemm_f32 in its
//      NN form with the bias (K6 takes its xp as xz);
//   wide_fwd_chain: the recurrence, one persistent cooperative launch for
//      all T steps (a launch for each chunk of the batch's rows, as
//      wide_bwd_chain), z = xz_t + h_{t-1}·U, the gate update, h_t and c_t
//      out, one grid barrier a step.
//
// K9f and K6f (bf16 operands) run the same two parts on the tensor cores:
// the x-side as gemm_bf16 in its NN form with the bias, on bf16_copy's
// copies of x and W, and the chain as batched_chain's kCell instantiation
// (see K5's note below), which stores bf16(h_t) for the next step's product.
//
// A CTA owns J units (blockIdx.x, of n / J groups) and walks row tiles of R
// rows (blockIdx.y, + gridDim.y, ...), the layout of wide_bwd_chain. Its
// units' 4J gate columns of U, gate-interleaved ([k][unit][gate], one
// 16-byte load for a unit's four gates at k; ops/cuda_train.py:
// pack_gates_interleaved), are staged in shared memory once for all T steps
// (kStaged), else read from the global copy through L1. Per step and row
// tile: the tile's R rows of h_{t-1} (written by every CTA before the
// barrier) come through L2 by cp.async.cg into shared memory, never by the
// non-coherent path; a thread owns 4 rows x 1 unit, its four gates' sums
// (16 FMA chains over k, 4 k at a time from 16-byte loads), adds xz_t,
// runs gate_fwd with c_{t-1} carried in registers, and stores h_t and c_t.
// Rows >= B are neither stored nor carried.
//
// What bounds it: the product, R·n·4J FMAs a CTA a step (1 M at n = 512, R
// = 32, J = 16: ~4.7 us on one SM's 128 FMA lanes), then the step's chain
// of latencies (h_{t-1}'s R·n floats from L2, the grid barrier). The x-side
// is a plain GEMM at full occupancy, out of the time loop.
// ---------------------------------------------------------------------------
#define FWD_CHAIN_THREADS 128  // a thread 4 rows x 1 unit: R·J = 512 cells a CTA

template <int R, int J, bool kStaged>
__global__ void __launch_bounds__(FWD_CHAIN_THREADS, 1)
wide_fwd_chain(const float* __restrict__ xz, const float4* __restrict__ Ui, float* h, float* c,
               int T, int B, int stride, int n, int row_tiles) {
  static_assert((R / 4) * J == FWD_CHAIN_THREADS, "a thread 4 rows x 1 unit");
  extern __shared__ float4 fwd_smem[];
  const int ld = n + 4;                                  // hs row stride (16-byte rows)
  float* hs = reinterpret_cast<float*>(fwd_smem);        // [R][ld]: h_{t-1} of the tile's rows
  float4* us = reinterpret_cast<float4*>(hs + R * ld);   // [n][J]: the CTA's units (kStaged)
  const int tid = threadIdx.x, u = tid % J, rq = tid / J;
  const int j0 = blockIdx.x * J, j = j0 + u;
  const int G = 4 * n, n4 = n / 4;
  if (kStaged) {
    for (int e = tid; e < n * J; e += FWD_CHAIN_THREADS)
      us[e] = __ldg(Ui + (size_t)(e / J) * n + j0 + e % J);
    // first read after the first tile's barrier
  }
  float cs[CHAIN_MAX_ROW_TILES][4];
#pragma unroll
  for (int q = 0; q < CHAIN_MAX_ROW_TILES; ++q)
#pragma unroll
    for (int r = 0; r < 4; ++r) cs[q][r] = 0.f;
  for (int t = 0; t < T; ++t) {
    for (int tile = 0; tile < row_tiles; ++tile) {
      const int r0 = (blockIdx.y + tile * gridDim.y) * R;
      if (t > 0) {
        const float* hp = h + (size_t)(t - 1) * stride * n;
        for (int e = tid; e < R * n4; e += FWD_CHAIN_THREADS) {
          const int r = e / n4, k4 = e - r * n4, row = r0 + r;
          cp_async16(hs + r * ld + 4 * k4, row < B ? hp + (size_t)row * n + 4 * k4 : hp,
                     row < B ? 16 : 0);
        }
        cp_async_commit();
        cp_async_wait<0>();
      }
      __syncthreads();  // hs complete (and the staged columns, at the first tile)
      float acc[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int g = 0; g < 4; ++g) acc[r][g] = 0.f;
      if (t > 0) {
        const float* hr = hs + (4 * rq) * ld;
#pragma unroll 2
        for (int k = 0; k < n; k += 4) {
          float4 hv[4], w[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) hv[r] = *reinterpret_cast<const float4*>(hr + r * ld + k);
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            w[kk] = kStaged ? us[(k + kk) * J + u] : __ldg(Ui + (size_t)(k + kk) * n + j);
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float hk[4] = {hv[r].x, hv[r].y, hv[r].z, hv[r].w};
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
              acc[r][0] = fmaf(hk[kk], w[kk].x, acc[r][0]);
              acc[r][1] = fmaf(hk[kk], w[kk].y, acc[r][1]);
              acc[r][2] = fmaf(hk[kk], w[kk].z, acc[r][2]);
              acc[r][3] = fmaf(hk[kk], w[kk].w, acc[r][3]);
            }
          }
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = r0 + 4 * rq + r;
        if (row >= B) continue;
        const size_t m = (size_t)t * stride + row;
        const float* zr = xz + m * G + j;
        float cp = 0.f;
#pragma unroll
        for (int q = 0; q < CHAIN_MAX_ROW_TILES; ++q)
          if (q == tile) cp = cs[q][r];
        float hn, cn;
        gate_fwd(__ldg(zr) + acc[r][0], __ldg(zr + n) + acc[r][1], __ldg(zr + 2 * n) + acc[r][2],
                 __ldg(zr + 3 * n) + acc[r][3], cp, hn, cn);
#pragma unroll
        for (int q = 0; q < CHAIN_MAX_ROW_TILES; ++q)
          if (q == tile) cs[q][r] = cn;
        h[m * n + j] = hn;
        c[m * n + j] = cn;
      }
      __syncthreads();  // hs is rewritten by the next tile
    }
    if (t + 1 < T) cooperative_groups::this_grid().sync();
  }
}

// ---------------------------------------------------------------------------
// K5 — batched_chain, replaces pallas_batched.py:batched_lstm_recurrence_pallas
// for the batched fast mode of predict:
//   z = bf16(h_{t-1}) · bf16(U) + xp_t, accumulated in float32;
//   gate update in float32; h_t written in xp's dtype T.
// h_{t-1} is read back from the output: rounded to bf16 it is the product's
// operand whether T is bf16 (exact already) or float32. U arrives as
// Ut = bf16(U)ᵀ (4n, n), rounded once by the wrapper.
// With kCell (T = float only) it also stores c_t (float32) beside h_t: that
// instantiation is K9f's and K6f's forward chain (replacing
// pallas_train_wide.py:_wide_fwd's and pallas_train.py:_pallas_fwd_hc's
// recurrence under DEFAULT dots; xp is then K9f's x-side from gemm_bf16 or
// K6f's xp, h0 = c0 = 0, and h, c float32 and unrounded, as the plain bf16
// versions keep them). It also stores bf16(h_t), the next step's operand,
// into slot t & 1 of a two-slot buffer hb, and reads h_{t-1} from slot
// (t - 1) & 1 by cp.async: 32 KB a CTA a step through L2 instead of the
// float32 h's 64 KB (~1.5 us of a ~9 us step at B = 128, n = 512, in turns:
// PERF.md §6). A slot is rewritten two steps after it was written,
// after a grid barrier that every CTA passes only once its reads of it are
// done. K5's instantiation (kCell false) compiles as before.
// Past n = 1152 no staged tile fits on the H100 (at 1280 32 x 16's columns
// and h tile take 247 KB, and 16 x 8's 160 unit groups are not co-resident
// at one CTA an SM), so the c-storing chain also has unstaged tiles
// (kStaged false, UNSTAGED_TILES: 16 x 64): only the h tile is in shared
// memory, and each lane loads its B fragments from a fragment-ordered copy
// of Ut (ops/cuda_batched.py: fragment_order, rows zero-padded to a multiple
// of 32) through L1 and L2, one 16-byte load a gate for two k groups of 16,
// since ldmatrix reads only shared memory. At B = 128, T = 200 that ran at
// ~23 us a step at n = 1280 and ~84 at 2176, the float32 chain's route
// ~220 and ~1380 (PERF.md §6).
//
// What bounds it: at 3x512, B = 256, T = 128 a layer is 69 GFLOP (0.07 ms
// at the 989 TFLOP/s bf16 tensor-core peak) and 134 MB of bf16 xp (0.04 ms
// at 3.35 TB/s), but every unit of h_t needs all of h_{t-1}: each step is a
// grid-wide dependency, so the chain of T steps, each a barrier, the h
// tile's load and a product of R x n by n x 4J on one SM, is what costs.
// What the design does about it (the forward counterpart of the dh chain
// of K9's backward, wide_bwd_chain):
//  * One persistent cooperative launch for all T steps (a launch a step
//    before), a grid.sync() between steps. The grid is sized from this
//    kernel's occupancy and the SM count; a batch whose tiles cannot all be
//    co-resident runs as consecutive launches over chunks of rows, each T
//    steps (the pointers start at the chunk's first row, B is the chunk's
//    rows, stride the whole batch's); a shape whose unit groups alone do
//    not fit is refused, never run another way (ops/cuda_batched.py:
//    batched_plan).
//  * A CTA owns R rows x J units and all four gate columns of its units:
//    their 4J columns of Ut are staged into shared memory once, as rows of
//    k ([gate column][k], the mma's "col" operand), in the order unit group
//    of 8, gate, unit; its cells' c stay in registers for all T steps.
//  * Each step, after the barrier, its R rows of h_{t-1} (written by other
//    CTAs) come through L2 (cp.async.cg, or ld.global.cg and a bf16
//    rounding for a float32 h), never the non-coherent path, into an R x
//    Kp tile (k past n zero).
//  * z = h·U on the tensor cores: mma.sync m16n8k16 bf16 -> float32, the
//    operands by ldmatrix; a warp owns a 16-row m tile and a group of 8
//    units, and its four n tiles are the four gates of those units, so a
//    thread ends with all four gates of its four cells (rows g, g + 8,
//    units 2q, 2q + 1 of the tiles) and runs the gate update in registers.
//    Rows of the shared tiles are padded by 16 bytes (Kp + 8 bf16), so the
//    eight rows an ldmatrix reads fall in different banks.
//  * xp_t is loaded before the barrier (it does not depend on it); units
//    past n (their Ut columns staged as zeros) and rows past B are masked.
// The tensor cores sum each 16-wide k group of products in an order of
// their own, then into the float32 accumulator k group by k group: not the
// CUDA cores' fmaf chain, within K5's limit (ops/cuda_batched.py).
// Measured on the H100 (PERF.md §6) at 3x512, B = 256, T = 128 (32 x
// 32 tiles, 128 CTAs, one an SM): ~8.5 us a step, a chain of latencies that
// no one part dominates; taken out one at a time, the product saves ~1.8
// us, the h tile's load ~1.1, the grid barrier ~1.0, xp's loads ~0.9, the
// gate math ~0.3. The 32 x 32 tile ran faster than 32 x 16 (twice the CTAs
// and the h traffic through L2) and 64 x 16; loading xp a step ahead, or
// two units a load, ran slower. The kCell instantiation at B = 128, n = 512
// (K9f's and K6f's forward, scripts/probe_torch_wide_fwd.py --bf16): 32 x 32
// again, 64 CTAs, ~7.0 us a step (1.39 ms at T = 200), against ~7.5 at 32 x
// 16 (128 CTAs) and ~10.1 at 16 x 8.
// ---------------------------------------------------------------------------
// Eight k of one row of h_{t-1} (k, ..., k + 7; those past n are zero) as
// bf16 into the A tile, through L2 (written by other CTAs in this launch).
__device__ __forceinline__ void load_h8(__nv_bfloat16* dst, const __nv_bfloat16* src, int left,
                                        bool vec) {
  if (vec) {
    cp_async16(reinterpret_cast<float*>(dst), reinterpret_cast<const float*>(src), 16);
    return;
  }
  unsigned short q[8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
    q[i] = i < left ? __ldcg(reinterpret_cast<const unsigned short*>(src) + i) : 0;
  *reinterpret_cast<uint4*>(dst) =
      make_uint4(pack2(q[0], q[1]), pack2(q[2], q[3]), pack2(q[4], q[5]), pack2(q[6], q[7]));
}
__device__ __forceinline__ void load_h8(__nv_bfloat16* dst, const float* src, int left, bool vec) {
  float f[8];
  if (vec) {
    const float4 u = __ldcg(reinterpret_cast<const float4*>(src));
    const float4 w = __ldcg(reinterpret_cast<const float4*>(src) + 1);
    f[0] = u.x, f[1] = u.y, f[2] = u.z, f[3] = u.w, f[4] = w.x, f[5] = w.y, f[6] = w.z, f[7] = w.w;
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) f[i] = i < left ? __ldcg(src + i) : 0.f;
  }
  uint32_t p[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) p[i] = pack2(bf16_bits(f[2 * i]), bf16_bits(f[2 * i + 1]));
  *reinterpret_cast<uint4*>(dst) = make_uint4(p[0], p[1], p[2], p[3]);
}

template <int R, int J> struct BatchedTile {
  static constexpr int kWarps = (R / 16) * (J / 8), kThreads = kWarps * 32, kCols = 4 * J;
  static_assert(R % 16 == 0 && J % 8 == 0, "16-row m tiles, 8-unit groups");
  // the product's K: n rounded up to the k group of 16, or to the 32 of one
  // 16-byte load of the fragment-ordered copy when Ut is not staged
  __host__ __device__ static int kp(int n, bool staged) {
    return staged ? (n + 15) / 16 * 16 : (n + 31) / 32 * 32;
  }
  // bf16 row stride of the shared tiles: Kp + 16 bytes
  static int ld(int n, bool staged) { return kp(n, staged) + 8; }
  static size_t smem(int n, bool staged) {
    return (size_t)((staged ? kCols : 0) + R) * ld(n, staged) * sizeof(__nv_bfloat16);
  }
};

template <typename T, int R, int J, bool kCell, bool kStaged>
__global__ void __launch_bounds__(BatchedTile<R, J>::kThreads)
batched_chain(const T* __restrict__ xp, const __nv_bfloat16* __restrict__ Ut, T* h, float* cs,
              __nv_bfloat16* hb, int TT, int B, int stride, int n) {
  using Tile = BatchedTile<R, J>;
  constexpr int MT = R / 16, WARPS = Tile::kWarps, THREADS = Tile::kThreads, COLS = Tile::kCols;
  static_assert(kStaged || kCell, "Ut read from the global copy only by the c-storing chain");
  extern __shared__ uint4 batched_smem[];
  const int Kp = Tile::kp(n, kStaged), ld = Kp + 8, chunks = ld / 8;
  __nv_bfloat16* Bs = reinterpret_cast<__nv_bfloat16*>(batched_smem);  // [COLS][ld] (kStaged)
  __nv_bfloat16* As = Bs + (kStaged ? (size_t)COLS * ld : 0);          // [R][ld]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int j0 = blockIdx.x * J, r0 = blockIdx.y * R;
  const bool vec = n % 8 == 0;

  // the CTA's 4J columns of Ut: row (unit group·4 + gate)·8 + unit
  if constexpr (kStaged) for (int e = tid; e < COLS * chunks; e += THREADS) {
    const int row = e / chunks, k = (e - row * chunks) * 8;
    const int j = j0 + (row >> 5) * 8 + (row & 7), gate = (row >> 3) & 3;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (j < n && k < n) {
      const __nv_bfloat16* src = Ut + ((size_t)gate * n + j) * n + k;
      if (vec) {
        v = __ldg(reinterpret_cast<const uint4*>(src));
      } else {
        unsigned short q[8];
#pragma unroll
        for (int i = 0; i < 8; ++i)
          q[i] = k + i < n ? __ldg(reinterpret_cast<const unsigned short*>(src) + i) : 0;
        v = make_uint4(pack2(q[0], q[1]), pack2(q[2], q[3]), pack2(q[4], q[5]), pack2(q[6], q[7]));
      }
    }
    *reinterpret_cast<uint4*>(Bs + (size_t)row * ld + k) = v;
  }
  for (int e = tid; e < R * chunks; e += THREADS)
    reinterpret_cast<uint4*>(As)[e] = make_uint4(0u, 0u, 0u, 0u);
  // first read after the first grid barrier

  const int mt = warp % MT, ug = warp / MT;  // the warp's m tile and unit group
  const int gid = lane >> 2, tig = lane & 3;
  const __nv_bfloat16* a_ptr = As + (size_t)(mt * 16 + (lane & 15)) * ld + (lane >> 4) * 8;
  const __nv_bfloat16* b_ptr =
      Bs + (size_t)(ug * 32 + (lane >> 4) * 8 + (lane & 7)) * ld + ((lane >> 3) & 1) * 8;
  // unstaged: the lane's B fragments are k pairs of unit j0 + ug·8 + gid, a
  // 16-byte load at 8·tig in each 32 k of the fragment-ordered copy (Kp a row)
  const int ju = j0 + ug * 8 + gid;
  const uint4* b_glob =
      reinterpret_cast<const uint4*>(Ut) + (size_t)(ju < n ? ju : 0) * (Kp / 8) + tig;
  const int G4 = 4 * n;
  float c[4] = {0.f, 0.f, 0.f, 0.f};  // cell q: row g + 8·(q / 2), unit 2·tig + q % 2
  for (int t = 0; t < TT; ++t) {
    float xv[4][4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int row = r0 + mt * 16 + gid + (q >> 1) * 8, j = j0 + ug * 8 + 2 * tig + (q & 1);
      const bool ok = row < B && j < n;
      const T* px = xp + ((size_t)t * stride + row) * G4 + j;
#pragma unroll
      for (int g = 0; g < 4; ++g) xv[q][g] = ok ? to_f32(__ldg(px + g * n)) : 0.f;
    }
    float acc[4][4];  // [gate][cell]
#pragma unroll
    for (int g = 0; g < 4; ++g)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[g][q] = 0.f;
    if (t > 0) {
      cooperative_groups::this_grid().sync();  // h_{t-1} complete
      const T* hp = h + (size_t)(t - 1) * stride * n;
      const __nv_bfloat16* hq = kCell ? hb + (size_t)((t - 1) & 1) * stride * n : nullptr;
      for (int r = warp; r < R; r += WARPS) {
        const int row = r0 + r;
        if (row >= B) break;  // warp-uniform; the rows past B stay zero
        for (int k = lane * 8; k < n; k += 256) {
          if constexpr (kCell)  // h_{t-1}'s bf16 copy: half the float32 h's bytes, by cp.async
            load_h8(As + (size_t)r * ld + k, hq + (size_t)row * n + k, n - k, vec);
          else
            load_h8(As + (size_t)r * ld + k, hp + (size_t)row * n + k, n - k, vec);
        }
      }
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      if constexpr (kStaged) {
#pragma unroll 2
        for (int k0 = 0; k0 < Kp; k0 += 16) {
          uint32_t a[4], b01[4], b23[4];
          ldmatrix_x4(a, a_ptr + k0);
          ldmatrix_x4(b01, b_ptr + k0);
          ldmatrix_x4(b23, b_ptr + 16 * ld + k0);
          mma_bf16(acc[0], a, b01[0], b01[1]);
          mma_bf16(acc[1], a, b01[2], b01[3]);
          mma_bf16(acc[2], a, b23[0], b23[1]);
          mma_bf16(acc[3], a, b23[2], b23[3]);
        }
      } else {
        const size_t gate_rows = (size_t)n * (Kp / 8);  // uint4s from one gate's rows to the next
        for (int k0 = 0; k0 < Kp; k0 += 32) {
          uint4 w[4];
#pragma unroll
          for (int g = 0; g < 4; ++g)
            w[g] = ju < n ? __ldg(b_glob + g * gate_rows + k0 / 8) : make_uint4(0u, 0u, 0u, 0u);
          uint32_t a[4];
          ldmatrix_x4(a, a_ptr + k0);  // the k group k0: .x and .y of each load
#pragma unroll
          for (int g = 0; g < 4; ++g) mma_bf16(acc[g], a, w[g].x, w[g].y);
          ldmatrix_x4(a, a_ptr + k0 + 16);  // and k0 + 16: .z and .w
#pragma unroll
          for (int g = 0; g < 4; ++g) mma_bf16(acc[g], a, w[g].z, w[g].w);
        }
      }
      // the A tile is rewritten only after the next grid barrier
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int row = r0 + mt * 16 + gid + (q >> 1) * 8, j = j0 + ug * 8 + 2 * tig + (q & 1);
      float hn, cn;
      gate_fwd(acc[0][q] + xv[q][0], acc[1][q] + xv[q][1], acc[2][q] + xv[q][2],
               acc[3][q] + xv[q][3], c[q], hn, cn);
      c[q] = cn;
      if (row < B && j < n) {
        const size_t m = ((size_t)t * stride + row) * n + j;
        h[m] = from_f32<T>(hn);
        if constexpr (kCell) {  // K9f's and K6f's forward: c_t beside h_t, and h_t's bf16 copy
          cs[m] = cn;
          hb[(size_t)(t & 1) * stride * n + (size_t)row * n + j] = __float2bfloat16_rn(hn);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Weight gradients, shared by K7, K9 and K6: out (p, G) = Σ_{m<M} a_m ⊗ dz_m,
// where a_m = A[m - shift] (zero for m < shift: h_prev is h shifted by one
// step of B rows) or, when A is null, the constant 1 with p = 1 (db; BF16
// rounds a_m and dz_m, but not the dz of db). Split
// over M into gridDim.z contiguous ranges; each split sums its range in
// order, and sum_splits adds the splits in order. A CTA owns a 64 x 64 tile
// of out; a thread owns 4 x 4 entries (rows ty + 16p, columns tx + 16q).
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(WG_THREADS)
weight_grad(const float* __restrict__ A, int shift, const float* __restrict__ dz,
            float* __restrict__ out, int M, int p, int G, int chunk) {
  __shared__ float sa[WG_KM][WG_TP];
  __shared__ float sd[WG_KM][WG_TG];
  const int g0 = blockIdx.x * WG_TG, a0 = blockIdx.y * WG_TP;
  const int m_begin = blockIdx.z * chunk;
  const int m_end = min(M, m_begin + chunk);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[i][q] = 0.f;
  constexpr int A_PER = WG_KM * WG_TP / WG_THREADS;  // 8
  constexpr int D_PER = WG_KM * WG_TG / WG_THREADS;  // 8
  float va[A_PER], vd[D_PER];  // the next chunk, in flight
  auto load = [&](int m0) {
#pragma unroll
    for (int q = 0; q < A_PER; ++q) {
      const int e = threadIdx.x + q * WG_THREADS;
      const int m = m0 + e / WG_TP, a = a0 + e % WG_TP;
      float v = 0.f;
      if (m < m_end && a < p) {
        if (A == nullptr) {
          v = 1.f;
        } else if (m >= shift) {
          v = A[(size_t)(m - shift) * p + a];
        }
      }
      va[q] = v;
    }
#pragma unroll
    for (int q = 0; q < D_PER; ++q) {
      const int e = threadIdx.x + q * WG_THREADS;
      const int m = m0 + e / WG_TG, g = g0 + e % WG_TG;
      const float v = (m < m_end && g < G) ? dz[(size_t)m * G + g] : 0.f;
      vd[q] = v;
    }
  };
  load(m_begin);
  for (int m0 = m_begin; m0 < m_end; m0 += WG_KM) {
#pragma unroll
    for (int q = 0; q < A_PER; ++q) {
      const int e = threadIdx.x + q * WG_THREADS;
      sa[e / WG_TP][e % WG_TP] = va[q];
    }
#pragma unroll
    for (int q = 0; q < D_PER; ++q) {
      const int e = threadIdx.x + q * WG_THREADS;
      sd[e / WG_TG][e % WG_TG] = vd[q];
    }
    __syncthreads();
    if (m0 + WG_KM < m_end) load(m0 + WG_KM);
#pragma unroll 4
    for (int mm = 0; mm < WG_KM; ++mm) {
      float av[4], dv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = sa[mm][ty + 16 * i];
#pragma unroll
      for (int q = 0; q < 4; ++q) dv[q] = sd[mm][tx + 16 * q];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][q] = fmaf(av[i], dv[q], acc[i][q]);
    }
    __syncthreads();
  }
  float* o = out + (size_t)blockIdx.z * p * G;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int a = a0 + ty + 16 * i;
    if (a >= p) continue;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int g = g0 + tx + 16 * q;
      if (g < G) o[(size_t)a * G + g] = acc[i][q];
    }
  }
}

// out[i] = Σ_{s<splits} partial[s][i], in order of s.
__global__ void sum_splits(const float* __restrict__ partial, float* __restrict__ out, int size,
                           int splits) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < size; i += gridDim.x * blockDim.x) {
    float v = 0.f;
    for (int s = 0; s < splits; ++s) v += partial[(size_t)s * size + i];
    out[i] = v;
  }
}

template <typename K>
cudaError_t prepare_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// meta: L rows of 8 int64 — din, n, W, U, b, h, c, P (0: staged). Fills a,
// returns the sum of the units or -1.
int read_fwd_layers(const int64_t* meta, int L, FwdArgs& a) {
  if (L < 1 || L > MAX_LAYERS) return -1;
  a.L = L;
  int nsum = 0;
  for (int i = 0; i < L; ++i) {
    const int64_t* m = meta + (size_t)8 * i;
    FwdLayer& l = a.l[i];
    l.din = (int)m[0];
    l.n = (int)m[1];
    l.W = reinterpret_cast<const float*>(m[2]);
    l.U = reinterpret_cast<const float*>(m[3]);
    l.b = reinterpret_cast<const float*>(m[4]);
    l.h = reinterpret_cast<float*>(m[5]);
    l.c = reinterpret_cast<float*>(m[6]);
    l.P = reinterpret_cast<const float*>(m[7]);
    if (l.n < 1) return -1;
    nsum += l.n;
  }
  return nsum;
}

// meta: L rows of 9 int64 — din, n, W, U, b, P (0: staged), h, c, dz.
// Fills a, returns the sum of the units or -1.
int read_bwd_layers(const int64_t* meta, int L, BwdArgs& a) {
  if (L < 1 || L > MAX_LAYERS) return -1;
  a.L = L;
  int nsum = 0;
  for (int i = 0; i < L; ++i) {
    const int64_t* m = meta + (size_t)9 * i;
    BwdLayer& l = a.l[i];
    l.din = (int)m[0];
    l.n = (int)m[1];
    l.W = reinterpret_cast<const float*>(m[2]);
    l.U = reinterpret_cast<const float*>(m[3]);
    l.b = reinterpret_cast<const float*>(m[4]);
    l.P = reinterpret_cast<const float*>(m[5]);
    l.h = reinterpret_cast<const float*>(m[6]);
    l.c = reinterpret_cast<const float*>(m[7]);
    l.dz = reinterpret_cast<float*>(m[8]);
    if (l.n < 1) return -1;
    nsum += l.n;
  }
  return nsum;
}

// S lanes a unit, and x_0's R·d stagers (ops/cuda_train.py:
// narrow_fwd_threads)
int fwd_threads(int nsum, int d, int S) {
  const int units = (S * nsum + 31) / 32 * 32, stagers = (NARROW_ROWS * d + 31) / 32 * 32;
  return units > stagers ? units : stagers;
}

template <int S, bool kStaged>
int launch_wave(const FwdArgs& a, const float* x, int T, int B, int d, int threads, size_t smem,
                cudaStream_t stream) {
  cudaError_t err = prepare_smem(narrow_fwd_wave<S, kStaged>, smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (B + NARROW_ROWS - 1) / NARROW_ROWS;
  narrow_fwd_wave<S, kStaged><<<grid, threads, smem, stream>>>(a, x, T, B, d, fwd_state_entries(a, d));
  return (int)cudaGetLastError();
}

// narrow_fwd_wave at S lanes a unit and the weights' home
int switch_wave(int S, bool staged, const FwdArgs& a, const float* x, int T, int B, int d,
                int threads, size_t smem, cudaStream_t s) {
  switch (S * 2 + (staged ? 1 : 0)) {
    case 2: return launch_wave<1, false>(a, x, T, B, d, threads, smem, s);
    case 3: return launch_wave<1, true>(a, x, T, B, d, threads, smem, s);
    case 4: return launch_wave<2, false>(a, x, T, B, d, threads, smem, s);
    case 5: return launch_wave<2, true>(a, x, T, B, d, threads, smem, s);
    case 8: return launch_wave<4, false>(a, x, T, B, d, threads, smem, s);
    case 9: return launch_wave<4, true>(a, x, T, B, d, threads, smem, s);
    case 16: return launch_wave<8, false>(a, x, T, B, d, threads, smem, s);
    default: return launch_wave<8, true>(a, x, T, B, d, threads, smem, s);
  }
}

// ---------------------------------------------------------------------------
// K7 and K8 forward (narrow_fwd_wave): what bounds it on the H100, and what
// the design does about it. At 4x40, d = 16, T = 200 the forward is 2.4
// GFLOP at B = 128 (0.036 ms at 67 TFLOP/s), but batch rows are the only
// independent work: a CTA owns NARROW_ROWS rows (B / 4 CTAs, 8 at run A's
// B = 32, 32 at K8's B = 128) and runs a chain of dependent steps. So the
// bound is the latency of one step times the length of the chain:
//  * the chain: the layers run as a wavefront (T + L - 1 = 203 steps at
//    4x40, not T·L = 800 layer-steps), one __syncthreads a step;
//  * one step: every unit's dot of din + n terms is split over S lanes
//    (S from the wrapper's rule, ops/cuda_train.py: narrow_fwd_lanes; S = 4
//    at 4x40: 640 threads, 20 warps), summed by shuffles,
//    and the gate update runs in the lane's registers, so z never goes
//    through shared memory. Each step of a dot is one 16-byte weight load
//    (four gates), one 16-byte broadcast state load (four rows) and 16 FMAs.
//    At 4x40 a step takes ~2.9 us on the H100, and what sets it is each
//    warp's chain through the step (its K / S dot steps, the shuffles, the
//    gate math with expf, tanhf and IEEE divides, the barrier), not the
//    shared-memory traffic: S = 1, 2, 4 ran 0.87, 0.71, 0.56 ms at 4x40
//    (scripts/probe_torch_narrow_fwd.py), while one lane group owning two
//    units (a state load shared by two weight loads, half the warps) ran
//    ~10 % slower, and a layout giving the state load one address per
//    quarter-warp changed nothing. S = 8 would need 1280 threads; more
//    parallelism per step means splitting a CTA's units over a cluster of
//    CTAs (distributed shared memory).
// Weights: K8 (compact) always stages them into shared memory (the TPU
// kernel's whole-array VMEM blocks, on chip for all T steps; its 2-or-4
// gates-a-lane-block packing answers the TPU's lane tiles and is not carried
// over). K7 stages them when the stack fits (the wrapper passes P null),
// else reads the wrapper's gate-interleaved copy P from L1/L2: at 4x40 that
// ran 0.83 ms against 0.63 staged (the same script).
// K8 replaces svd_lstm_tpu/ops/pallas_train_compact.py: _fused_fwd /
// _fused_bwd, the pair the JAX package runs for narrow stacks (every n <=
// 64, d <= 128) at B >= 128; the wrapper sends a stack that does not fit to
// K7 by a shape rule (ops/cuda_train.py: compact_fits).
// ---------------------------------------------------------------------------
int narrow_fwd_launch(const int64_t* meta, int L, const void* x, int T, int B, int d,
                      int lanes, bool compact, void* stream) {
  FwdArgs a;
  const int nsum = read_fwd_layers(meta, L, a);
  if (nsum < 1 || T < 1 || B < 1 || d < 1) return (int)cudaErrorInvalidValue;
  bool staged = true;
  for (int i = 0; i < L; ++i) staged = staged && a.l[i].P == nullptr;
  if (compact && !staged) return (int)cudaErrorInvalidValue;
  const int S = lanes, threads = fwd_threads(nsum, d, S);
  if ((S != 1 && S != 2 && S != 4 && S != 8) || threads > FWD_MAX_THREADS)
    return (int)cudaErrorInvalidValue;
  // the staged weights, then two parities of the state
  const size_t smem =
      ((staged ? (size_t)fwd_weight_entries(a) : 0) + 2 * (size_t)fwd_state_entries(a, d)) *
      sizeof(float4);
  const float* xs = (const float*)x;
  cudaStream_t s = (cudaStream_t)stream;
  return switch_wave(S, staged, a, xs, T, B, d, threads, smem, s);
}

template <int S, bool kStaged>
int launch_bwd_wave(const BwdArgs& a, const float* x, const float* dhl, float* dx, int T, int B,
                    int d, int V, int nsum, int threads, size_t smem, cudaStream_t stream) {
  // the state vector's R·V floats over the loads each thread makes a step
  if (NARROW_ROWS * V > bwd_loads<S>() * threads) return (int)cudaErrorInvalidValue;
  cudaError_t err = prepare_smem(narrow_bwd_wave<S, kStaged>, smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (B + NARROW_ROWS - 1) / NARROW_ROWS;
  narrow_bwd_wave<S, kStaged><<<grid, threads, smem, stream>>>(a, x, dhl, dx, T, B, d, V, nsum);
  return (int)cudaGetLastError();
}

// narrow_bwd_wave at S lanes a unit and the weights' home (S = 1 only from
// the global copy)
int switch_bwd_wave(int S, bool staged, const BwdArgs& a, const float* x, const float* dh,
                    float* dx, int T, int B, int d, int V, int nsum, int threads, size_t smem,
                    cudaStream_t s) {
  switch (S * 2 + (staged ? 1 : 0)) {
    case 2: return launch_bwd_wave<1, false>(a, x, dh, dx, T, B, d, V, nsum, threads, smem, s);
    case 4: return launch_bwd_wave<2, false>(a, x, dh, dx, T, B, d, V, nsum, threads, smem, s);
    case 5: return launch_bwd_wave<2, true>(a, x, dh, dx, T, B, d, V, nsum, threads, smem, s);
    case 8: return launch_bwd_wave<4, false>(a, x, dh, dx, T, B, d, V, nsum, threads, smem, s);
    case 9: return launch_bwd_wave<4, true>(a, x, dh, dx, T, B, d, V, nsum, threads, smem, s);
    case 16: return launch_bwd_wave<8, false>(a, x, dh, dx, T, B, d, V, nsum, threads, smem, s);
    default: return launch_bwd_wave<8, true>(a, x, dh, dx, T, B, d, V, nsum, threads, smem, s);
  }
}

// ---------------------------------------------------------------------------
// K7 and K8 backward (narrow_bwd_wave): what bounds it on the H100, and what
// the design does about it. As the forward, batch rows are the only
// independent work (B / 4 CTAs), so the bound is one step's latency times
// the chain:
//  * the chain: a reverse wavefront of T + L steps (204 at 4x40, with dx as
//    a layer), one barrier each, against T·L layer-steps of four;
//  * one step: the z dot (din + n terms: a weight load, a state load, 16
//    FMAs each) and the dh dot (n + n_above terms: a weight load, four dz
//    loads, 16 FMAs) split over S lanes, summed by shuffles, the cell
//    gradient in registers; the forward's h, c and dh_last are loaded one
//    step ahead, off the chain. At 4x40, S = 4, B = 32 the kernel takes
//    ~1.3 ms on the H100, ~6.3 us a step (chip_smoke.py --parent: the card's
//    busy time in run A's step), about what its 16-byte shared-memory loads
//    cost at four wavefronts each (~10 000 a CTA a step): the dh dot's four dz loads per 16 FMAs are the largest
//    part. From the global copy S = 1, 2, 4 ran 7.7, 4.6, 2.9 ms, the
//    weights staged at S = 4 half that (scripts/probe_torch_narrow_bwd.py);
//    on the 4x30 view S = 8 with 8 dx units on layer 0's groups ran 1.2x
//    S = 4 with groups of their own. Next: fewer loads per FMA in the dh dot (a lane owning
//    two units' sums, so one dz load serves both).
// Weights: staged into shared memory at the odd row stride n | 1 wherever
// the stack fits, else read from the wrapper's gate-interleaved copy
// (ops/cuda_train.py: narrow_bwd_staged), which fits every stack K7 admits;
// K8's route (compact_fits) is the rule its first backward set, and a few
// of the stacks it admits take the copy. At S = 1 (more than 512 units and
// dx units) the weights never fit, so only the copy is built. No atomics:
// every sum is taken in a fixed order, so the gradients do not change from
// run to run.
//
// lanes: S, threads: the block (ops/cuda_train.py: narrow_bwd_lanes,
// narrow_bwd_threads). Checked here, not chosen: S·Σn units' lanes and a
// group for each of the d dx units within the block.
// ---------------------------------------------------------------------------
int narrow_bwd_launch(const int64_t* meta, int L, const void* x, const void* dhl, void* dx, int T,
                      int B, int d, int lanes, int threads, void* stream) {
  BwdArgs a;
  const int nsum = read_bwd_layers(meta, L, a);
  if (nsum < 1 || T < 1 || B < 1 || d < 1) return (int)cudaErrorInvalidValue;
  bool staged = true;
  for (int i = 0; i < L; ++i) staged = staged && a.l[i].P == nullptr;
  const int S = lanes;
  if ((S != 1 && S != 2 && S != 4 && S != 8) || threads % 32 != 0 || threads > BWD_MAX_THREADS ||
      S * nsum > threads || d > threads / S || (S == 1 && staged)) {
    return (int)cudaErrorInvalidValue;
  }
  const int V = d + nsum;
  // the staged weights, then two parities of the state vector and of dz
  const size_t smem =
      ((staged ? (size_t)bwd_weight_entries(a) : 0) + 2 * (size_t)(V + NARROW_ROWS * nsum)) *
      sizeof(float4);
  const float* xs = (const float*)x;
  const float* dh = (const float*)dhl;
  float* out = (float*)dx;
  cudaStream_t s = (cudaStream_t)stream;
  return switch_bwd_wave(S, staged, a, xs, dh, out, T, B, d, V, nsum, threads, smem, s);
}

template <int BM, int BN, bool kAT, bool kBT>
int launch_gemm(const GemmArgs& a, int splits, cudaStream_t s) {
  const dim3 grid((a.N + BN - 1) / BN, (a.M + BM - 1) / BM, splits);
  gemm_f32<BM, BN, kAT, kBT><<<grid, (BM / 8) * (BN / 8), 0, s>>>(a);
  return (int)cudaGetLastError();
}

// gemm_f32 in the operand form: NN (phase R, K9's x-side), NT (X), TN (G)
int switch_gemm(int form, const GemmArgs& a, int splits, cudaStream_t s) {
  switch (form) {
    case 0: return launch_gemm<GM_BM, GM_BN, false, false>(a, splits, s);
    case 1: return launch_gemm<GM_BM, GM_BN, false, true>(a, splits, s);
    default: return launch_gemm<GM_BM, GM_BN, true, false>(a, splits, s);
  }
}


// Phase C at one (R, J, home): checks the shape, the shared memory and
// co-residency (every CTA of the grid on the card at once, from the
// occupancy of this kernel and the device's SM count), then the cooperative
// launch; a grid that cannot be co-resident is refused, never run another
// way.
template <int R, int J, bool kStaged, bool BF16>
int launch_chain(const float* z, const float* Ut, const __nv_bfloat16* Ub, const float* c,
                 const float* dh, float* dz, __nv_bfloat16* dzb, float* P, int T, int B, int stride,
                 int n, int row_groups, cudaStream_t s) {
  const int tiles = (B + R - 1) / R;
  if (n % J != 0 || n % 8 != 0 || row_groups < 1 || row_groups > tiles || stride < B)
    return (int)cudaErrorInvalidValue;
  int row_tiles = (tiles + row_groups - 1) / row_groups;
  if (row_tiles > CHAIN_MAX_ROW_TILES) return (int)cudaErrorInvalidValue;
  // BF16: the dz tile's and the staged rows of 4J + 8 bf16 (ops/cuda_train.py: chain_smem_bytes_bf16)
  const size_t smem =
      BF16 ? (size_t)2 * (4 * J + 8) * ((R + 15) / 16 * 16 + (kStaged ? n : 0))
           : ((size_t)4 * J * R + (kStaged ? (size_t)4 * J * n : 0)) * sizeof(float);
  const auto kernel = wide_bwd_chain<R, J, kStaged, BF16>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, CHAIN_THREADS, smem)) !=
      cudaSuccess)
    return (int)err;
  const dim3 grid(n / J, row_groups);
  if (per_sm < 1 || (long long)grid.x * grid.y > (long long)per_sm * sms)
    return (int)cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {(void*)&z, (void*)&Ut,     (void*)&Ub, (void*)&c,  (void*)&dh,
                  (void*)&dz, (void*)&dzb,    (void*)&P,  (void*)&T,  (void*)&B,
                  (void*)&stride, (void*)&n, (void*)&row_tiles};
  err = cudaLaunchCooperativeKernel((const void*)kernel, grid, dim3(CHAIN_THREADS), args, smem, s);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// K5's tiles, rows x units a CTA (ops/cuda_batched.py: BATCHED_TILES), Ut
// staged; and the c-storing chain's tiles with Ut read from the global copy
// (UNSTAGED_TILES)
#define BATCHED_TILES(X) X(32, 32) X(32, 16) X(16, 8)
#define UNSTAGED_TILES(X) X(16, 64)

template <typename T, int R, int J, bool kCell, bool kStaged>
int batched_occupancy(int n, int* per_sm) {
  const auto kernel = batched_chain<T, R, J, kCell, kStaged>;
  const size_t smem = BatchedTile<R, J>::smem(n, kStaged);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel,
                                                            BatchedTile<R, J>::kThreads, smem);
}

// Checks co-residency (every CTA of the grid on the card at once, from the
// occupancy of this kernel and the device's SM count), then the
// cooperative launch.
template <typename T, int R, int J, bool kCell, bool kStaged>
int launch_batched(const void* xp_, const void* Ut_, void* h_, void* c_, void* hb_, int TT, int B,
                   int stride, int n, cudaStream_t s) {
  int per_sm = 0, dev = 0, sms = 0;
  int err = batched_occupancy<T, R, J, kCell, kStaged>(n, &per_sm);
  if (err != (int)cudaSuccess) return err;
  cudaError_t e;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)e;
  const dim3 grid((n + J - 1) / J, (B + R - 1) / R);
  if (per_sm < 1 || (long long)grid.x * grid.y > (long long)per_sm * sms)
    return (int)cudaErrorCooperativeLaunchTooLarge;
  const T* xp = (const T*)xp_;
  const __nv_bfloat16* Ut = (const __nv_bfloat16*)Ut_;
  T* h = (T*)h_;
  float* c = (float*)c_;
  __nv_bfloat16* hb = (__nv_bfloat16*)hb_;
  void* args[] = {(void*)&xp, (void*)&Ut, (void*)&h,      (void*)&c, (void*)&hb,
                  (void*)&TT, (void*)&B,  (void*)&stride, (void*)&n};
  e = cudaLaunchCooperativeKernel((const void*)batched_chain<T, R, J, kCell, kStaged>, grid,
                                  dim3(BatchedTile<R, J>::kThreads), args,
                                  BatchedTile<R, J>::smem(n, kStaged), s);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// wide_fwd_chain at one (R, J, home): checks the shape, the shared memory
// and co-residency, then the cooperative launch.
template <int R, int J, bool kStaged>
int launch_fwd_chain(const float* xz, const float4* Ui, float* h, float* c, int T, int B,
                     int stride, int n, int row_groups, cudaStream_t s) {
  const int tiles = (B + R - 1) / R;
  if (n % J != 0 || n % 4 != 0 || row_groups < 1 || row_groups > tiles || stride < B)
    return (int)cudaErrorInvalidValue;
  int row_tiles = (tiles + row_groups - 1) / row_groups;
  if (row_tiles > CHAIN_MAX_ROW_TILES) return (int)cudaErrorInvalidValue;
  const size_t smem = ((size_t)R * (n + 4) + (kStaged ? (size_t)4 * J * n : 0)) * sizeof(float);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  const auto kernel = wide_fwd_chain<R, J, kStaged>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, FWD_CHAIN_THREADS,
                                                           smem)) != cudaSuccess)
    return (int)err;
  const dim3 grid(n / J, row_groups);
  if (per_sm < 1 || (long long)grid.x * grid.y > (long long)per_sm * sms)
    return (int)cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {(void*)&xz, (void*)&Ui, (void*)&h,      (void*)&c, (void*)&T,
                  (void*)&B,  (void*)&stride, (void*)&n, (void*)&row_tiles};
  err = cudaLaunchCooperativeKernel((const void*)kernel, grid, dim3(FWD_CHAIN_THREADS), args, smem, s);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// cuTensorMapEncodeTiled, from the driver through the runtime (the library
// links nothing new)
typedef CUresult (*TensorMapEncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                         const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                         const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                         CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

TensorMapEncodeTiled tensor_map_encoder() {
  static TensorMapEncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = (TensorMapEncodeTiled)p;
  }
  return fn;
}

// A row-major bf16 matrix (rows, ld) as a 2-D tensor map: boxes of 64
// columns (128 bytes, the swizzle's row) by box_rows rows, 128-byte swizzle,
// zero fill outside the matrix (negative coordinates included).
int bf16_tensor_map(CUtensorMap* map, const void* base, long long rows, long long ld, int box_rows) {
  const TensorMapEncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  if (base == nullptr || rows < 1 || ld < 8 || ld % 8 != 0 || ((uintptr_t)base & 15))
    return (int)cudaErrorInvalidValue;
  const cuuint64_t dims[2] = {(cuuint64_t)ld, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims,
                            strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <bool kAT, bool kBT>
int launch_gemm_bf16(const GemmBf16Args& a, int splits, cudaStream_t s) {
  const auto kernel = gemm_bf16<kAT, kBT>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, GB_SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.N + GB_BN - 1) / GB_BN, (a.M + GB_BM - 1) / GB_BM, splits);
  gemm_bf16<kAT, kBT><<<grid, GB_THREADS, GB_SMEM, s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K7. meta: L rows of 8 int64 — din, n, W, U, b, h_out, c_out (device
// pointers), P: the gate-interleaved copy of [W; U] (ops/cuda_train.py:
// pack_gates), or 0 in every row to stage the weights in shared memory.
// lanes: S, 1, 2, 4 or 8 (the wrapper's rule, ops/cuda_train.py:
// narrow_fwd_lanes), checked here against the 1024-thread block.
int fused_narrow_train_fwd_launch(const int64_t* meta, int L, const void* x, int T, int B, int d,
                                  int lanes, void* stream) {
  return narrow_fwd_launch(meta, L, x, T, B, d, lanes, false, stream);
}

// K7. meta: L rows of 9 int64 — din, n, W, U, b, P: the gate-interleaved
// copy of [W; U] (ops/cuda_train.py: pack_gates), or 0 in every row to stage
// the weights in shared memory; h, c: the forward's; dz_out (T, B, 4n) for
// weight_grad. lanes and threads: the wrapper's rule (ops/cuda_train.py:
// narrow_bwd_lanes, narrow_bwd_threads), checked here.
int fused_narrow_train_bwd_launch(const int64_t* meta, int L, const void* x, const void* dhl,
                                  void* dx, int T, int B, int d, int lanes, int threads,
                                  void* stream) {
  return narrow_bwd_launch(meta, L, x, dhl, dx, T, B, d, lanes, threads, stream);
}

// K8, the forward: meta and lanes as K7's, P 0 (the weights are always
// staged).
int fused_narrow_train_compact_fwd_launch(const int64_t* meta, int L, const void* x, int T, int B,
                                          int d, int lanes, void* stream) {
  return narrow_fwd_launch(meta, L, x, T, B, d, lanes, true, stream);
}

// K8, the backward: as K7's (the same kernel).
int fused_narrow_train_compact_bwd_launch(const int64_t* meta, int L, const void* x,
                                          const void* dhl, void* dx, int T, int B, int d,
                                          int lanes, int threads, void* stream) {
  return narrow_bwd_launch(meta, L, x, dhl, dx, T, B, d, lanes, threads, stream);
}

// out (p, G) = Σ_m a_m ⊗ dz_m (see weight_grad); partial holds
// splits·p·G floats when splits > 1 and may be null otherwise.
int weight_grad_launch(const void* A, int shift, const void* dz, void* out, void* partial, int M,
                       int p, int G, int splits, void* stream) {
  if (splits < 1 || (splits > 1 && partial == nullptr)) return (int)cudaErrorInvalidValue;
  const int chunk = ((M + splits - 1) / splits + WG_KM - 1) / WG_KM * WG_KM;
  const dim3 grid((G + WG_TG - 1) / WG_TG, (p + WG_TP - 1) / WG_TP, splits);
  float* dst = splits > 1 ? (float*)partial : (float*)out;
  weight_grad<<<grid, WG_THREADS, 0, (cudaStream_t)stream>>>((const float*)A, shift, (const float*)dz,
                                                             dst, M, p, G, chunk);
  if (splits > 1) {
    const int size = p * G;
    const int blocks = (size + 255) / 256 < 1024 ? (size + 255) / 256 : 1024;
    sum_splits<<<blocks, 256, 0, (cudaStream_t)stream>>>((const float*)partial, (float*)out, size,
                                                         splits);
  }
  return (int)cudaGetLastError();
}

// The forward chain of K9 and K6 (wide_fwd_chain; K9f's and K6f's is
// batched_chain's c-storing instantiation, batched_lstm_recurrence_launch)
// over B rows of a batch of stride rows: xz (T, stride, 4n) the x-side (K9:
// x·W + b from gemm_f32; K6: xp), h and c (T, stride, n) out, each pointer at the
// chunk's first row; Ui: U gate-interleaved, (n, n, 4) (ops/cuda_train.py:
// pack_gates_interleaved). rows x units: the CTA's tile R x J (32x16, U
// staged or from the global copy; 16x32 and 8x64 from the global copy),
// row_groups: gridDim.y (ops/cuda_train.py: fwd_chain_plan). Checked here,
// not chosen; a grid that cannot be co-resident is refused.
int wide_fwd_chain_launch(const void* xz, const void* Ui, void* h, void* c, int T, int B,
                          int stride, int n, int rows, int units, int staged, int row_groups,
                          void* stream) {
  if (T < 1 || B < 1 || n < 1 || xz == nullptr || Ui == nullptr || h == nullptr || c == nullptr)
    return (int)cudaErrorInvalidValue;
  if (((uintptr_t)Ui) & 15) return (int)cudaErrorMisalignedAddress;
  const float* x = (const float*)xz;
  const float4* U4 = (const float4*)Ui;
  float *hf = (float*)h, *cf = (float*)c;
  cudaStream_t s = (cudaStream_t)stream;
#define FWD_CASE(R_, J_, ST_)                                \
  if (rows == R_ && units == J_ && (staged != 0) == ST_)     \
    return launch_fwd_chain<R_, J_, ST_>(x, U4, hf, cf, T, B, stride, n, row_groups, s);
  FWD_CASE(32, 16, true)
  FWD_CASE(32, 16, false)
  FWD_CASE(16, 32, false)
  FWD_CASE(8, 64, false)
#undef FWD_CASE
  return (int)cudaErrorInvalidValue;
}

// gemm_f32 (phases R, X, G of K9's and K6's backward, and the x-side of
// K9's forward), at its 128 x 128 tile. meta: 10 int64 — nseg, M, N, C, ldc, bias, addend, splits, kchunk,
// split_stride — then GM_MAX_SEGS rows of 9: A, B,
// lda, ldb, a_t, b_t, shift, ones_row, K (see GemmSeg; a_t: A read
// transposed, b_t: B read transposed, the same in every segment, not both).
// Pointers are device pointers or 0.
int wide_gemm_launch(const int64_t* meta, void* stream) {
  GemmArgs a;
  a.nseg = (int)meta[0];
  a.M = (int)meta[1];
  a.N = (int)meta[2];
  a.C = reinterpret_cast<float*>(meta[3]);
  a.ldc = (int)meta[4];
  a.bias = reinterpret_cast<const float*>(meta[5]);
  a.addend = reinterpret_cast<const float*>(meta[6]);
  const int splits = (int)meta[7];
  a.kchunk = (int)meta[8];
  a.split_stride = meta[9];
  if (a.nseg < 1 || a.nseg > GM_MAX_SEGS || a.M < 1 || a.N < 1 || a.C == nullptr || splits < 1 ||
      (splits > 1 && (a.kchunk < 1 || a.split_stride < (long long)a.M * a.ldc)) || a.ldc < a.N)
    return (int)cudaErrorInvalidValue;
  int form = -1;
  for (int i = 0; i < GM_MAX_SEGS; ++i) {
    const int64_t* m = meta + 10 + 9 * i;
    GemmSeg& g = a.seg[i];
    g.A = reinterpret_cast<const float*>(m[0]);
    g.B = reinterpret_cast<const float*>(m[1]);
    g.lda = (int)m[2];
    g.ldb = (int)m[3];
    const int a_t = (int)m[4], b_t = (int)m[5];
    g.shift = (int)m[6];
    g.ones_row = (int)m[7];
    g.K = i < a.nseg ? (int)m[8] : 0;
    g.vec_a = g.lda % 4 == 0 && ((uintptr_t)g.A & 15) == 0 && (g.ones_row < 0 || g.ones_row % 4 == 0);
    g.vec_b = g.ldb % 4 == 0 && ((uintptr_t)g.B & 15) == 0;
    if (i >= a.nseg) continue;
    const int f = a_t ? (b_t ? -1 : 2) : (b_t ? 1 : 0);
    if (g.A == nullptr || g.B == nullptr || g.K < 0 || f < 0 || (form >= 0 && f != form))
      return (int)cudaErrorInvalidValue;
    form = f;
  }
  cudaStream_t s = (cudaStream_t)stream;
  return switch_gemm(form, a, splits, s);
}

// out[i] = Σ_{s<splits} partial[s·size + i], in order of s.
int sum_splits_launch(const void* partial, void* out, int size, int splits, void* stream) {
  if (size < 1 || splits < 1) return (int)cudaErrorInvalidValue;
  const int blocks = (size + 255) / 256 < 1024 ? (size + 255) / 256 : 1024;
  sum_splits<<<blocks, 256, 0, (cudaStream_t)stream>>>((const float*)partial, (float*)out, size,
                                                       splits);
  return (int)cudaGetLastError();
}

// Phase C of K9's and K6's backward (wide_bwd_chain) over B rows of a
// batch of stride rows: z (T, stride, 4n) from phase R, the forward's c and
// the cotangent dh_seq (T, stride, n), dz (T, stride, 4n), each pointer at
// the chunk's first row; Ut = Uᵀ (4n, n); P: two parities of the partial
// sums, 2 x (n / units) x B x n floats. rows x units: the CTA's tile R x J
// (32x16, U staged or from the global copy; 16x32 and 8x64 from the global
// copy), row_groups: gridDim.y (ops/cuda_train.py: chain_plan). Checked
// here, not chosen. The float32 chain (K9, K6); K9f's and K6f's is
// wide_bwd_chain_bf16_launch.
int wide_bwd_chain_launch(const void* z, const void* Ut, const void* c, const void* dh, void* dz,
                          void* P, int T, int B, int stride, int n, int rows, int units, int staged,
                          int row_groups, void* stream) {
  if (T < 1 || B < 1 || n < 1 || z == nullptr || Ut == nullptr || c == nullptr || dh == nullptr ||
      dz == nullptr || P == nullptr)
    return (int)cudaErrorInvalidValue;
  if ((((uintptr_t)Ut) | ((uintptr_t)P)) & 15) return (int)cudaErrorMisalignedAddress;
  const float *zf = (const float*)z, *Uf = (const float*)Ut, *cf = (const float*)c,
              *dhf = (const float*)dh;
  float *dzf = (float*)dz, *Pf = (float*)P;
  cudaStream_t s = (cudaStream_t)stream;
#define CHAIN_CASE(R_, J_, ST_)                                                                   \
  if (rows == R_ && units == J_ && (staged != 0) == ST_)                                          \
    return launch_chain<R_, J_, ST_, false>(zf, Uf, nullptr, cf, dhf, dzf, nullptr, Pf, T, B,     \
                                            stride, n, row_groups, s);
  CHAIN_CASE(32, 16, true)
  CHAIN_CASE(32, 16, false)
  CHAIN_CASE(16, 32, false)
  CHAIN_CASE(8, 64, false)
#undef CHAIN_CASE
  return (int)cudaErrorInvalidValue;
}

// Phase C of K9f's and K6f's backward (wide_bwd_chain's BF16 instantiation):
// as wide_bwd_chain_launch, with U's bf16 copy Ub (n, 4n) in place of Uᵀ,
// and dzb (T, stride, 4n), where the chain stores dz rounded to bf16 beside
// dz (the operand of phases X and G); the tile's shared memory is
// chain_smem_bytes_bf16's (ops/cuda_train.py).
int wide_bwd_chain_bf16_launch(const void* z, const void* Ub, const void* c, const void* dh,
                               void* dz, void* dzb, void* P, int T, int B, int stride, int n,
                               int rows, int units, int staged, int row_groups, void* stream) {
  if (T < 1 || B < 1 || n < 1 || z == nullptr || Ub == nullptr || c == nullptr || dh == nullptr ||
      dz == nullptr || dzb == nullptr || P == nullptr)
    return (int)cudaErrorInvalidValue;
  // every load and store of a quad is 16 bytes (8 for dzb)
  if ((((uintptr_t)z) | ((uintptr_t)Ub) | ((uintptr_t)c) | ((uintptr_t)dh) | ((uintptr_t)dz) |
       ((uintptr_t)dzb) | ((uintptr_t)P)) & 15)
    return (int)cudaErrorMisalignedAddress;
  const float *zf = (const float*)z, *cf = (const float*)c, *dhf = (const float*)dh;
  const __nv_bfloat16* Ubf = (const __nv_bfloat16*)Ub;
  float *dzf = (float*)dz, *Pf = (float*)P;
  __nv_bfloat16* dzbf = (__nv_bfloat16*)dzb;
  cudaStream_t s = (cudaStream_t)stream;
#define CHAIN_CASE(R_, J_, ST_)                                                                   \
  if (rows == R_ && units == J_ && (staged != 0) == ST_)                                          \
    return launch_chain<R_, J_, ST_, true>(zf, nullptr, Ubf, cf, dhf, dzf, dzbf, Pf, T, B, stride, \
                                           n, row_groups, s);
  CHAIN_CASE(32, 16, true)
  CHAIN_CASE(32, 16, false)
  CHAIN_CASE(16, 32, false)
  CHAIN_CASE(8, 64, false)
#undef CHAIN_CASE
  return (int)cudaErrorInvalidValue;
}

// gemm_bf16 (phases R, X, G of K9f's and K6f's backward, K9f's forward
// x-side) at its 128 x 128
// tile. meta: 11 int64 — nseg, M, N, C, ldc, bias, addend, splits, kchunk,
// split_stride, form (0 NN, 1 NT, 2 TN: gemm_f32's forms) — then
// GM_MAX_SEGS rows of 8: A, A's rows, A's ld, B, B's rows, B's ld, shift, K:
// each operand a bf16 copy (rows, ld), ld % 8 == 0, 16-byte aligned. The
// tensor maps are encoded here, a call, from the copies' shapes.
int gemm_bf16_launch(const int64_t* meta, void* stream) {
  GemmBf16Args a;
  a.nseg = (int)meta[0];
  a.M = (int)meta[1];
  a.N = (int)meta[2];
  a.C = reinterpret_cast<float*>(meta[3]);
  a.ldc = (int)meta[4];
  a.bias = reinterpret_cast<const float*>(meta[5]);
  a.addend = reinterpret_cast<const float*>(meta[6]);
  const int splits = (int)meta[7];
  a.kchunk = (int)meta[8];
  a.split_stride = meta[9];
  const int form = (int)meta[10];
  if (a.nseg < 1 || a.nseg > GM_MAX_SEGS || a.M < 1 || a.N < 1 || a.C == nullptr || splits < 1 ||
      splits > 65535 || form < 0 || form > 2 || a.ldc < a.N ||
      (splits > 1 && (a.kchunk < 1 || a.kchunk % GB_BK != 0 || a.split_stride < (long long)a.M * a.ldc)))
    return (int)cudaErrorInvalidValue;
  const bool at = form == 2, bt = form == 1;
  for (int i = 0; i < GM_MAX_SEGS; ++i) {
    const int64_t* m = meta + 11 + 8 * i;
    a.shift[i] = (int)m[6];
    a.K[i] = i < a.nseg ? (int)m[7] : 0;
    if (i >= a.nseg) {
      a.a[i] = a.a[0];
      a.b[i] = a.b[0];
      continue;
    }
    int err = a.K[i] < 0 ? (int)cudaErrorInvalidValue : 0;
    // A: K-major boxes of 64 k x 128 rows, or M-major 64 i x 64 k; B: N-major
    // 64 j x 64 k, or K-major 64 k x 128 j
    if (!err) err = bf16_tensor_map(&a.a[i], reinterpret_cast<const void*>(m[0]), m[1], m[2], at ? 64 : 128);
    if (!err) err = bf16_tensor_map(&a.b[i], reinterpret_cast<const void*>(m[3]), m[4], m[5], bt ? 128 : 64);
    if (err) return err;
  }
  cudaStream_t s = (cudaStream_t)stream;
  switch (form) {
    case 0: return launch_gemm_bf16<false, false>(a, splits, s);
    case 1: return launch_gemm_bf16<false, true>(a, splits, s);
    default: return launch_gemm_bf16<true, false>(a, splits, s);
  }
}

// dst (rows_p, ld) bf16 = src (rows, cols) float32 rounded, zero-padded
// (bf16_copy): rows_p >= rows, ld >= cols, ld % 8 == 0.
int bf16_copy_launch(const void* src, void* dst, int rows, int cols, int rows_p, int ld,
                     void* stream) {
  if (src == nullptr || dst == nullptr || rows < 0 || cols < 1 || rows_p < rows || rows_p < 1 ||
      ld < cols || ld % 8 != 0)
    return (int)cudaErrorInvalidValue;
  const long long total = (long long)rows_p * ld;
  const int blocks = (int)((total + 255) / 256 < 4096 ? (total + 255) / 256 : 4096);
  bf16_copy<<<blocks, 256, 0, (cudaStream_t)stream>>>((const float*)src, (__nv_bfloat16*)dst, rows,
                                                       cols, rows_p, ld);
  return (int)cudaGetLastError();
}

// K5 (batched_chain): one cooperative launch over B rows of a batch of
// stride rows (the pointers at the chunk's first row): xp (T, stride, 4n)
// and h (T, stride, n) bf16 when bf16 != 0, else float32; Ut = bf16(U)ᵀ
// (4n, n). c (T, stride, n) float32 and hb (2, stride, n) bf16, both or
// neither: with a float32 xp and h, the cell states stored beside h and a
// two-slot bf16 copy of h that the next step reads (K9f's and K6f's
// forward, ops/cuda_train.py: wide_fwd_bf16; K5 passes null). rows x
// units: the CTA's tile (ops/cuda_batched.py: batched_plan), checked here,
// not chosen; a grid that cannot be co-resident is refused. staged == 0
// (the c-storing chain only, a tile of UNSTAGED_TILES): Ut is the
// fragment-ordered copy (4n, ⌈n / 32⌉·32) of ops/cuda_batched.py:
// fragment_order, read from global memory, not staged.
int batched_lstm_recurrence_launch(const void* xp, const void* Ut, void* h, void* c, void* hb,
                                   int T, int B, int stride, int n, int rows, int units, int bf16,
                                   int staged, void* stream) {
  if (T < 1 || B < 1 || n < 1 || stride < B || xp == nullptr || Ut == nullptr || h == nullptr ||
      (c == nullptr) != (hb == nullptr) || (bf16 && c != nullptr) || (!staged && c == nullptr))
    return (int)cudaErrorInvalidValue;
  if ((((uintptr_t)Ut) | ((uintptr_t)h) | ((uintptr_t)c) | ((uintptr_t)hb)) & 15)
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = (cudaStream_t)stream;
#define BATCHED_CASE(R_, J_)                                                                     \
  if (staged && rows == R_ && units == J_) {                                                     \
    if (bf16)                                                                                    \
      return launch_batched<__nv_bfloat16, R_, J_, false, true>(xp, Ut, h, c, hb, T, B, stride, n, s); \
    if (c) return launch_batched<float, R_, J_, true, true>(xp, Ut, h, c, hb, T, B, stride, n, s);   \
    return launch_batched<float, R_, J_, false, true>(xp, Ut, h, c, hb, T, B, stride, n, s);         \
  }
  BATCHED_TILES(BATCHED_CASE)
#undef BATCHED_CASE
#define UNSTAGED_CASE(R_, J_)        \
  if (!staged && rows == R_ && units == J_) \
    return launch_batched<float, R_, J_, true, false>(xp, Ut, h, c, hb, T, B, stride, n, s);
  UNSTAGED_TILES(UNSTAGED_CASE)
#undef UNSTAGED_CASE
  return (int)cudaErrorInvalidValue;
}

// batched_chain's CTAs an SM at rows x units and width n (the occupancy of
// the instantiation batched_lstm_recurrence_launch takes for bf16, a c
// output or none and Ut staged or not, with its shared memory), into
// *per_sm.
int batched_lstm_per_sm(int n, int rows, int units, int bf16, int cell, int staged, int* per_sm) {
  if (n < 1 || per_sm == nullptr || (bf16 && cell) || (!staged && !cell))
    return (int)cudaErrorInvalidValue;
#define BATCHED_CASE(R_, J_)                                                             \
  if (staged && rows == R_ && units == J_) {                                             \
    if (bf16) return batched_occupancy<__nv_bfloat16, R_, J_, false, true>(n, per_sm);   \
    if (cell) return batched_occupancy<float, R_, J_, true, true>(n, per_sm);            \
    return batched_occupancy<float, R_, J_, false, true>(n, per_sm);                     \
  }
  BATCHED_TILES(BATCHED_CASE)
#undef BATCHED_CASE
#define UNSTAGED_CASE(R_, J_)               \
  if (!staged && rows == R_ && units == J_) \
    return batched_occupancy<float, R_, J_, true, false>(n, per_sm);
  UNSTAGED_TILES(UNSTAGED_CASE)
#undef UNSTAGED_CASE
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
