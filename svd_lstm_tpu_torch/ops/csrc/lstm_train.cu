// LSTM training kernels for Hopper (sm_90a), float32 on the CUDA cores, and
// the batched fast-mode recurrence that shares their tiles.
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
//   K9  wide_fwd_step / wide_bwd_gates + matmul_nt — replace
//       svd_lstm_tpu/ops/pallas_train_wide.py: _wide_fwd / _wide_bwd (one
//       layer, n % 128 == 0).
//   K6  the same step kernels with the x·W part compiled out (kXW = false,
//       chosen by the launchers when W is null: z = xp_t + h_{t-1}·U, and
//       dxp = dz) — replace
//       svd_lstm_tpu/ops/pallas_train.py: _pallas_fwd_hc / _pallas_bwd.
//   weight_grad (+ sum_splits) — the dW/dU/db accumulation that the TPU
//       backward kernels carried in VMEM scratch.
//   K5  batched_step — replaces svd_lstm_tpu/ops/pallas_batched.py:
//       batched_lstm_recurrence_pallas (see its own note below).
//
// What differs from the TPU, and what the design does about it:
//  * The TPU grid walks T in order and carries dW/dU in VMEM across steps.
//    Here blocks run in parallel in no order, so the backward kernels store
//    dz = dL/dz (T, B, 4n) per layer in device memory and weight_grad
//    reduces it afterwards: dW = Σ_t,b inpᵀ·dz, dU = Σ_t,b h_prevᵀ·dz,
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
//  * K9: at n = 512, W and U are 8 MB, against 227 KB of shared memory per
//    block, and every unit's z at step t needs all of h_{t-1}: each step is
//    a grid-wide dependency. So one launch per time step (the host loop
//    runs in the C launcher; a CUDA graph is later work) of a tiled kernel:
//    a CTA owns WIDE_BR rows x WIDE_UJ units and computes the four gate
//    columns of its units, so the gate update stays in registers. Each
//    K chunk of the tiles is read into registers before it is stored to
//    shared memory, and the next chunk's reads are started before this one
//    is multiplied, so the loads overlap (3.6x faster forward than loading
//    straight into shared memory). Bound: ~52 us a step forward at n = 512,
//    B = 128, against 0.5 GFLOP (~10 TFLOP/s): one CTA of 4 warps per SM,
//    and ~3 launches per step in the backward.
//  * The cell gradient is one __device__ function, gate_bwd, that both
//    backward kernels call (the counterpart of models/lstm.py:
//    gate_update_bwd). expf/tanhf as written, no fast math.
//
// Every launcher runs on the stream it is given, allocates nothing, and
// returns cudaGetLastError() for the Python wrapper to check.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_LAYERS 8
#define NARROW_ROWS 4
#define WIDE_BR 16   // batch rows per CTA
#define WIDE_UJ 32   // units per CTA (4 gate columns each)
#define WIDE_KC 32   // reduction chunk
#define WIDE_THREADS 128
#define MM_COLS 64   // output columns per CTA of matmul_nt
#define WG_TP 64     // rows of a weight-gradient tile
#define WG_TG 64     // columns of a weight-gradient tile
#define WG_KM 32     // M chunk of a weight-gradient tile
#define WG_THREADS 256

namespace {

__device__ __forceinline__ float sigm(float v) { return 1.0f / (1.0f + expf(-v)); }

// Element conversions, by the cuda_bf16.h intrinsics only (round to nearest
// even, as torch's .bfloat16()).
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Forward cell of one (row, unit) from its four gate pre-activations.
__device__ __forceinline__ void gate_fwd(float zi, float zf, float zg, float zo, float c_prev,
                                         float& h, float& c) {
  const float i = sigm(zi);
  const float f = sigm(zf);
  const float g = tanhf(zg);
  const float o = sigm(zo);
  c = f * c_prev + i * g;
  h = o * tanhf(c);
}

// Reverse of gate_fwd at one step (models/lstm.py: gate_update_bwd): from
// the recomputed pre-activations and the saved cell states, with dh holding
// every contribution into h_t, writes dz[4] and returns dc_prev.
__device__ __forceinline__ float gate_bwd(float zi, float zf, float zg, float zo, float c_prev,
                                          float c_t, float dh, float dc, float* dz) {
  const float i = sigm(zi);
  const float f = sigm(zf);
  const float g = tanhf(zg);
  const float o = sigm(zo);
  const float tc = tanhf(c_t);
  const float dct = dc + dh * o * (1.0f - tc * tc);
  dz[0] = dct * g * i * (1.0f - i);
  dz[1] = dct * c_prev * f * (1.0f - f);
  dz[2] = dct * i * (1.0f - g * g);
  dz[3] = dh * tc * o * (1.0f - o);
  return dct * f;
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
        fwd_smem[w_entries + e] = make_float4(src[jj], src[n + jj], src[2 * n + jj], src[3 * n + jj]);
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
    if (stager && s + 1 < T && row0 + xr < B) xn = x[((size_t)(s + 1) * B + row0 + xr) * d + xk];
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
// K9, K6 and K5, shared by their step kernels: for the CTA's tile (WIDE_BR
// rows from r0, WIDE_UJ units from j0) and this thread's 4 rows
// (r0 + ty*4 + r) and unit j0 + tx, acc[r][g] += Σ_k in[row][k] · M[k][g*n + j]
// for k < K. in has row stride ld; M is (K, 4n). With kBf16 the operands
// are rounded to bf16 before the float32 multiply-add (K5; the products are
// then exact, as the MXU's single-pass bf16 products are). Every thread of
// the CTA must call it (it synchronises). With kBf16, units j ≥ n read
// zeros, so K5's n need not be a multiple of WIDE_UJ.
// ---------------------------------------------------------------------------
struct WideSmem {
  float in[WIDE_KC][WIDE_BR + 1];   // +1: the transposed store is conflict-free
  float w[WIDE_KC][4][WIDE_UJ];
};

// One K chunk of the CTA's operand tiles, read into registers: every load of
// the chunk is started before any is used, and the next chunk's loads are in
// flight while this one is multiplied (the loop of gates_tile).
constexpr int WIDE_IN_PER = WIDE_KC * WIDE_BR / WIDE_THREADS;     // 4
constexpr int WIDE_W_PER = WIDE_KC * 4 * WIDE_UJ / WIDE_THREADS;  // 32

template <typename TI, typename TM, bool kBf16>
__device__ __forceinline__ void gates_load(const TI* __restrict__ in, int ld, int K,
                                           const TM* __restrict__ M, int n, int B, int r0,
                                           int j0, int k0, float* vin, float* vw) {
#pragma unroll
  for (int q = 0; q < WIDE_IN_PER; ++q) {
    const int e = threadIdx.x + q * WIDE_THREADS;
    const int row = r0 + e / WIDE_KC, k = k0 + e % WIDE_KC;
    float v = 0.f;
    if (row < B && k < K) {
      v = to_f32(in[(size_t)row * ld + k]);
      if (kBf16) v = bf16_round(v);
    }
    vin[q] = v;
  }
#pragma unroll
  for (int q = 0; q < WIDE_W_PER; ++q) {
    const int e = threadIdx.x + q * WIDE_THREADS;
    const int u = e % WIDE_UJ, g = (e / WIDE_UJ) % 4, k = k0 + e / (4 * WIDE_UJ);
    float v = 0.f;
    // only K5 (kBf16) takes n % WIDE_UJ != 0; K9 and K6 skip the unit mask
    if (k < K && (!kBf16 || j0 + u < n)) {
      v = to_f32(__ldg(M + (size_t)k * 4 * n + g * n + j0 + u));
      if (kBf16) v = bf16_round(v);
    }
    vw[q] = v;
  }
}

__device__ __forceinline__ void gates_store(WideSmem& s, const float* vin, const float* vw) {
#pragma unroll
  for (int q = 0; q < WIDE_IN_PER; ++q) {
    const int e = threadIdx.x + q * WIDE_THREADS;
    s.in[e % WIDE_KC][e / WIDE_KC] = vin[q];
  }
#pragma unroll
  for (int q = 0; q < WIDE_W_PER; ++q) {
    const int e = threadIdx.x + q * WIDE_THREADS;
    s.w[e / (4 * WIDE_UJ)][(e / WIDE_UJ) % 4][e % WIDE_UJ] = vw[q];
  }
}

template <typename TI, typename TM, bool kBf16>
__device__ __forceinline__ void gates_tile(const TI* __restrict__ in, int ld, int K,
                                           const TM* __restrict__ M, int n, int B, int r0,
                                           int j0, WideSmem& s, float acc[4][4]) {
  const int tx = threadIdx.x % WIDE_UJ, ty = threadIdx.x / WIDE_UJ;
  float vin[WIDE_IN_PER], vw[WIDE_W_PER];
  gates_load<TI, TM, kBf16>(in, ld, K, M, n, B, r0, j0, 0, vin, vw);
  for (int k0 = 0; k0 < K; k0 += WIDE_KC) {
    gates_store(s, vin, vw);
    __syncthreads();
    if (k0 + WIDE_KC < K)
      gates_load<TI, TM, kBf16>(in, ld, K, M, n, B, r0, j0, k0 + WIDE_KC, vin, vw);
#pragma unroll 8
    for (int kk = 0; kk < WIDE_KC; ++kk) {
      float v[4], w[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) v[r] = s.in[kk][ty * 4 + r];
#pragma unroll
      for (int g = 0; g < 4; ++g) w[g] = s.w[kk][g][tx];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int g = 0; g < 4; ++g) acc[r][g] = fmaf(v[r], w[g], acc[r][g]);
    }
    __syncthreads();
  }
}

// z without the bias for the thread's 4 rows and unit: with kXW (K9) x_t·W +
// h_{t-1}·U; without (K6) x is the hoisted projection xp (T, B, 4n), z =
// xp_t + h_{t-1}·U, and W and b are unused: no x-side tile (of K = 0) runs.
template <bool kXW>
__device__ __forceinline__ void wide_z(const float* __restrict__ x, const float* __restrict__ W,
                                       const float* __restrict__ U, const float* __restrict__ h,
                                       int t, int B, int din, int n, int r0, int j0, WideSmem& s,
                                       float acc[4][4]) {
  const int tx = threadIdx.x % WIDE_UJ, ty = threadIdx.x / WIDE_UJ;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = r0 + ty * 4 + r;
    const float* xr = x + ((size_t)t * B + row) * 4 * n + j0 + tx;
#pragma unroll
    for (int g = 0; g < 4; ++g) acc[r][g] = (!kXW && row < B) ? xr[g * n] : 0.f;
  }
  if (kXW)
    gates_tile<float, float, false>(x + (size_t)t * B * din, din, din, W, n, B, r0, j0, s, acc);
  if (t > 0)
    gates_tile<float, float, false>(h + (size_t)(t - 1) * B * n, n, n, U, n, B, r0, j0, s, acc);
}

// ---------------------------------------------------------------------------
// K9 forward step — replaces pallas_train_wide.py:_wide_fwd at one t:
// z = x_t·W + h_{t-1}·U + b, gate update, h_t and c_t out. Without kXW,
// K6's forward step (pallas_train.py:_pallas_fwd_hc): z = xp_t + h_{t-1}·U.
// ---------------------------------------------------------------------------
template <bool kXW>
__global__ void __launch_bounds__(WIDE_THREADS)
wide_fwd_step(const float* __restrict__ x, const float* __restrict__ W, const float* __restrict__ U,
              const float* __restrict__ b, float* __restrict__ h, float* __restrict__ c, int t,
              int B, int din, int n) {
  __shared__ WideSmem s;
  const int j0 = blockIdx.x * WIDE_UJ, r0 = blockIdx.y * WIDE_BR;
  const int tx = threadIdx.x % WIDE_UJ, ty = threadIdx.x / WIDE_UJ;
  float acc[4][4];
  wide_z<kXW>(x, W, U, h, t, B, din, n, r0, j0, s, acc);
  const int j = j0 + tx;
  float bg[4];
#pragma unroll
  for (int g = 0; g < 4; ++g) bg[g] = kXW ? __ldg(b + g * n + j) : 0.f;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = r0 + ty * 4 + r;
    if (row >= B) continue;
    const float cp = t > 0 ? c[((size_t)(t - 1) * B + row) * n + j] : 0.f;
    float hn, cn;
    gate_fwd(acc[r][0] + bg[0], acc[r][1] + bg[1], acc[r][2] + bg[2], acc[r][3] + bg[3], cp, hn,
             cn);
    const size_t o = ((size_t)t * B + row) * n + j;
    h[o] = hn;
    c[o] = cn;
  }
}

// ---------------------------------------------------------------------------
// K9 backward, gate phase of one reverse step — part of the replacement of
// pallas_train_wide.py:_wide_bwd: recompute z for the tile (remat), then
// gate_bwd with dh = dh_seq[t] + the dh carry, the dc carry updated in place
// (each element has one owner), dz_t out to the dz store. Without kXW, the
// gate phase of K6's backward (pallas_train.py:_pallas_bwd), whose dz store
// is dxp itself.
// ---------------------------------------------------------------------------
template <bool kXW>
__global__ void __launch_bounds__(WIDE_THREADS)
wide_bwd_gates(const float* __restrict__ x, const float* __restrict__ W,
               const float* __restrict__ U, const float* __restrict__ b,
               const float* __restrict__ h, const float* __restrict__ c,
               const float* __restrict__ dh_seq, const float* __restrict__ dhc,
               float* __restrict__ dcc, float* __restrict__ dz, int t, int B, int din, int n) {
  __shared__ WideSmem s;
  const int j0 = blockIdx.x * WIDE_UJ, r0 = blockIdx.y * WIDE_BR;
  const int tx = threadIdx.x % WIDE_UJ, ty = threadIdx.x / WIDE_UJ;
  float acc[4][4];
  wide_z<kXW>(x, W, U, h, t, B, din, n, r0, j0, s, acc);
  const int j = j0 + tx;
  const int G = 4 * n;
  float bg[4];
#pragma unroll
  for (int g = 0; g < 4; ++g) bg[g] = kXW ? __ldg(b + g * n + j) : 0.f;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = r0 + ty * 4 + r;
    if (row >= B) continue;
    const size_t o = ((size_t)t * B + row) * n + j;
    const float cp = t > 0 ? c[o - (size_t)B * n] : 0.f;
    const float dh = dh_seq[o] + dhc[(size_t)row * n + j];
    float g4[4];
    dcc[(size_t)row * n + j] = gate_bwd(acc[r][0] + bg[0], acc[r][1] + bg[1], acc[r][2] + bg[2],
                                        acc[r][3] + bg[3], cp, c[o], dh,
                                        dcc[(size_t)row * n + j], g4);
    float* out = dz + ((size_t)t * B + row) * G;
#pragma unroll
    for (int q = 0; q < 4; ++q) out[q * n + j] = g4[q];
  }
}

// ---------------------------------------------------------------------------
// K9 backward, product phase: C (rows, cols) = A (rows, K) · Mᵀ with M
// (cols, K) row-major — dh carry = dz_t·Uᵀ and dx_t = dz_t·Wᵀ. A CTA owns
// WIDE_BR rows x MM_COLS columns; a thread owns 4 rows x 2 columns.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(WIDE_THREADS)
matmul_nt(const float* __restrict__ A, const float* __restrict__ M, float* __restrict__ C,
          int rows, int cols, int K) {
  __shared__ float sa[WIDE_KC][WIDE_BR + 1];
  __shared__ float sm[WIDE_KC][MM_COLS + 1];
  const int c0 = blockIdx.x * MM_COLS, r0 = blockIdx.y * WIDE_BR;
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  constexpr int A_PER = WIDE_KC * WIDE_BR / WIDE_THREADS;   // 4
  constexpr int M_PER = WIDE_KC * MM_COLS / WIDE_THREADS;   // 16
  float acc[4][2];
#pragma unroll
  for (int r = 0; r < 4; ++r) acc[r][0] = acc[r][1] = 0.f;
  float va[A_PER], vm[M_PER];  // the next chunk, in flight (as in gates_tile)
  auto load = [&](int k0) {
#pragma unroll
    for (int q = 0; q < A_PER; ++q) {
      const int e = threadIdx.x + q * WIDE_THREADS;
      const int row = r0 + e / WIDE_KC, k = k0 + e % WIDE_KC;
      va[q] = (row < rows && k < K) ? A[(size_t)row * K + k] : 0.f;
    }
#pragma unroll
    for (int q = 0; q < M_PER; ++q) {
      const int e = threadIdx.x + q * WIDE_THREADS;
      const int col = c0 + e / WIDE_KC, k = k0 + e % WIDE_KC;
      vm[q] = (col < cols && k < K) ? __ldg(M + (size_t)col * K + k) : 0.f;
    }
  };
  load(0);
  for (int k0 = 0; k0 < K; k0 += WIDE_KC) {
#pragma unroll
    for (int q = 0; q < A_PER; ++q) {
      const int e = threadIdx.x + q * WIDE_THREADS;
      sa[e % WIDE_KC][e / WIDE_KC] = va[q];
    }
#pragma unroll
    for (int q = 0; q < M_PER; ++q) {
      const int e = threadIdx.x + q * WIDE_THREADS;
      sm[e % WIDE_KC][e / WIDE_KC] = vm[q];
    }
    __syncthreads();
    if (k0 + WIDE_KC < K) load(k0 + WIDE_KC);
#pragma unroll 8
    for (int kk = 0; kk < WIDE_KC; ++kk) {
      const float m0 = sm[kk][tx], m1 = sm[kk][tx + 32];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float v = sa[kk][ty * 4 + r];
        acc[r][0] = fmaf(v, m0, acc[r][0]);
        acc[r][1] = fmaf(v, m1, acc[r][1]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = r0 + ty * 4 + r;
    if (row >= rows) continue;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int col = c0 + tx + 32 * q;
      if (col < cols) C[(size_t)row * cols + col] = acc[r][q];
    }
  }
}

// ---------------------------------------------------------------------------
// K5 step — replaces pallas_batched.py:batched_lstm_recurrence_pallas at one
// t, for the batched fast mode of predict:
//   z = bf16(h_{t-1}) · bf16(U) + xp_t, accumulated in float32;
//   gate update in float32; c (B, n) kept in float32, updated in place
//   (each element has one owner); h_t written in xp's dtype T.
// h_{t-1} is read back from the output: rounded to bf16 it is the dot's
// operand whether T is bf16 (exact already) or float32. U is bf16 (the
// wrapper rounds it once).
//
// What bounds it, and what the design does about it: the TPU kernel kept U
// resident in VMEM for the whole sequence. On the H100, U is 2 MB in bf16 at
// n = 512, against 227 KB of shared memory a block, and every unit of h_t
// needs all of h_{t-1}: each step is a grid-wide dependency. So, as K9, one
// launch per step of a tiled kernel — a CTA owns WIDE_BR rows x WIDE_UJ units
// and all four gate columns of them, U's tile comes from L2 each step, the
// gate update stays in registers. At 3x512, B = 256, T = 128 the work is
// 69 GFLOP a layer (0.07 ms at the 989 TFLOP/s bf16 tensor-core peak) and
// 134 MB of bf16 xp (0.04 ms at 3.35 TB/s): operation-bound. This first
// version multiplies on the CUDA cores in float32 (the products of bf16
// operands are exact there too), so it runs far from that bound; mma/wgmma
// tiles are the next step.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(WIDE_THREADS)
batched_step(const T* __restrict__ xp, const __nv_bfloat16* __restrict__ U, T* __restrict__ h,
             float* __restrict__ c, int t, int B, int n) {
  __shared__ WideSmem s;
  const int j0 = blockIdx.x * WIDE_UJ, r0 = blockIdx.y * WIDE_BR;
  const int tx = threadIdx.x % WIDE_UJ, ty = threadIdx.x / WIDE_UJ;
  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int g = 0; g < 4; ++g) acc[r][g] = 0.f;
  if (t > 0)
    gates_tile<T, __nv_bfloat16, true>(h + (size_t)(t - 1) * B * n, n, n, U, n, B, r0, j0, s,
                                       acc);
  const int j = j0 + tx;
  if (j >= n) return;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = r0 + ty * 4 + r;
    if (row >= B) continue;
    const T* zx = xp + ((size_t)t * B + row) * 4 * n + j;
    const size_t o = (size_t)row * n + j;
    const float cp = t > 0 ? c[o] : 0.f;
    float hn, cn;
    gate_fwd(acc[r][0] + to_f32(zx[0]), acc[r][1] + to_f32(zx[n]), acc[r][2] + to_f32(zx[2 * n]),
             acc[r][3] + to_f32(zx[3 * n]), cp, hn, cn);
    c[o] = cn;
    h[(size_t)t * B * n + o] = from_f32<T>(hn);
  }
}

// ---------------------------------------------------------------------------
// Weight gradients, shared by K7, K9 and K6: out (p, G) = Σ_{m<M} a_m ⊗ dz_m,
// where a_m = A[m - shift] (zero for m < shift: h_prev is h shifted by one
// step of B rows) or, when A is null, the constant 1 with p = 1 (db). Split
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
  float va[A_PER], vd[D_PER];  // the next chunk, in flight (as in gates_tile)
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
      vd[q] = (m < m_end && g < G) ? dz[(size_t)m * G + g] : 0.f;
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
  narrow_fwd_wave<S, kStaged><<<grid, threads, smem, stream>>>(a, x, T, B, d,
                                                               fwd_state_entries(a, d));
  return (int)cudaGetLastError();
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
  switch (S * 2 + (staged ? 1 : 0)) {
    case 2: return launch_wave<1, false>(a, xs, T, B, d, threads, smem, s);
    case 3: return launch_wave<1, true>(a, xs, T, B, d, threads, smem, s);
    case 4: return launch_wave<2, false>(a, xs, T, B, d, threads, smem, s);
    case 5: return launch_wave<2, true>(a, xs, T, B, d, threads, smem, s);
    case 8: return launch_wave<4, false>(a, xs, T, B, d, threads, smem, s);
    case 9: return launch_wave<4, true>(a, xs, T, B, d, threads, smem, s);
    case 16: return launch_wave<8, false>(a, xs, T, B, d, threads, smem, s);
    default: return launch_wave<8, true>(a, xs, T, B, d, threads, smem, s);
  }
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
  switch (S * 2 + (staged ? 1 : 0)) {
    case 2: return launch_bwd_wave<1, false>(a, xs, dh, out, T, B, d, V, nsum, threads, smem, s);
    case 4: return launch_bwd_wave<2, false>(a, xs, dh, out, T, B, d, V, nsum, threads, smem, s);
    case 5: return launch_bwd_wave<2, true>(a, xs, dh, out, T, B, d, V, nsum, threads, smem, s);
    case 8: return launch_bwd_wave<4, false>(a, xs, dh, out, T, B, d, V, nsum, threads, smem, s);
    case 9: return launch_bwd_wave<4, true>(a, xs, dh, out, T, B, d, V, nsum, threads, smem, s);
    case 16: return launch_bwd_wave<8, false>(a, xs, dh, out, T, B, d, V, nsum, threads, smem, s);
    default: return launch_bwd_wave<8, true>(a, xs, dh, out, T, B, d, V, nsum, threads, smem, s);
  }
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
  weight_grad<<<grid, WG_THREADS, 0, (cudaStream_t)stream>>>((const float*)A, shift,
                                                             (const float*)dz, dst, M, p, G, chunk);
  if (splits > 1) {
    const int size = p * G;
    const int blocks = (size + 255) / 256 < 1024 ? (size + 255) / 256 : 1024;
    sum_splits<<<blocks, 256, 0, (cudaStream_t)stream>>>((const float*)partial, (float*)out, size,
                                                         splits);
  }
  return (int)cudaGetLastError();
}

// One wide layer forward: T launches of wide_fwd_step in stream order. K6
// calls it with W and b null, xp (T, B, 4n) in x's place and din = 0, which
// selects the step kernels without the x·W part.
int wide_layer_fwd_launch(const void* x, const void* W, const void* U, const void* b, void* h,
                          void* c, int T, int B, int din, int n, void* stream) {
  if (n % WIDE_UJ != 0) return (int)cudaErrorInvalidValue;
  const dim3 grid(n / WIDE_UJ, (B + WIDE_BR - 1) / WIDE_BR);
  const auto step = W != nullptr ? &wide_fwd_step<true> : &wide_fwd_step<false>;
  for (int t = 0; t < T; ++t) {
    step<<<grid, WIDE_THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)x, (const float*)W, (const float*)U, (const float*)b, (float*)h, (float*)c,
        t, B, din, n);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

// One wide layer backward, reverse time: per step the gate phase, then the
// dh carry (skipped at t = 0) and dx_t (skipped when W is null: K6, whose dz
// is dxp). dhc and dcc (B, n) must hold zeros on entry; dz (T, B, 4n)
// receives every step's dz for the weight gradients.
int wide_layer_bwd_launch(const void* x, const void* W, const void* U, const void* b,
                          const void* h, const void* c, const void* dh, void* dx, void* dz,
                          void* dhc, void* dcc, int T, int B, int din, int n, void* stream) {
  if (n % WIDE_UJ != 0) return (int)cudaErrorInvalidValue;
  const int G = 4 * n;
  const dim3 grid_g(n / WIDE_UJ, (B + WIDE_BR - 1) / WIDE_BR);
  const dim3 grid_h((n + MM_COLS - 1) / MM_COLS, (B + WIDE_BR - 1) / WIDE_BR);
  const dim3 grid_x((din + MM_COLS - 1) / MM_COLS, (B + WIDE_BR - 1) / WIDE_BR);
  cudaStream_t s = (cudaStream_t)stream;
  const auto gates = W != nullptr ? &wide_bwd_gates<true> : &wide_bwd_gates<false>;
  for (int t = T - 1; t >= 0; --t) {
    gates<<<grid_g, WIDE_THREADS, 0, s>>>(
        (const float*)x, (const float*)W, (const float*)U, (const float*)b, (const float*)h,
        (const float*)c, (const float*)dh, (const float*)dhc, (float*)dcc, (float*)dz, t, B, din,
        n);
    const float* dzt = (const float*)dz + (size_t)t * B * G;
    if (t > 0)
      matmul_nt<<<grid_h, WIDE_THREADS, 0, s>>>(dzt, (const float*)U, (float*)dhc, B, n, G);
    if (W != nullptr)
      matmul_nt<<<grid_x, WIDE_THREADS, 0, s>>>(dzt, (const float*)W,
                                                (float*)dx + (size_t)t * B * din, B, din, G);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

// K5: T launches of batched_step in stream order. xp (T, B, 4n) and h
// (T, B, n) are bf16 when bf16 != 0, else float32; U (n, 4n) bf16; c (B, n)
// float32 scratch, needing no initial value.
int batched_lstm_recurrence_launch(const void* xp, const void* U, void* h, void* c, int T, int B,
                                   int n, int bf16, void* stream) {
  if (T < 1 || B < 1 || n < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid((n + WIDE_UJ - 1) / WIDE_UJ, (B + WIDE_BR - 1) / WIDE_BR);
  cudaStream_t s = (cudaStream_t)stream;
  const __nv_bfloat16* u = (const __nv_bfloat16*)U;
  for (int t = 0; t < T; ++t) {
    if (bf16)
      batched_step<__nv_bfloat16><<<grid, WIDE_THREADS, 0, s>>>(
          (const __nv_bfloat16*)xp, u, (__nv_bfloat16*)h, (float*)c, t, B, n);
    else
      batched_step<float><<<grid, WIDE_THREADS, 0, s>>>((const float*)xp, u, (float*)h, (float*)c,
                                                        t, B, n);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

}  // extern "C"
