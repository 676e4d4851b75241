// The LSTM cell and the bf16 tensor-core helpers that lstm_train.cu and
// narrow_bf16.cu share: one definition of the gate arithmetic (expf/tanhf
// as written, no fast math) and of the mma.sync / ldmatrix wrappers.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float sigm(float v) { return 1.0f / (1.0f + expf(-v)); }

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

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// bf16 tensor-core helpers (mma.sync m16n8k16): four 8 x 8 matrices of
// 16-bit values from shared memory, each lane of a group of eight giving one
// row's 16-byte address
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

// d += a (16 x 16, row) · b (16 x 8, col), bf16 operands, float32 sums
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two bf16 in one 32-bit word, lo at the lower address
__device__ __forceinline__ uint32_t pack2(unsigned short lo, unsigned short hi) {
  return (uint32_t)lo | ((uint32_t)hi << 16);
}

// float32 -> bf16 bits, to nearest even (as torch's .bfloat16())
__device__ __forceinline__ unsigned short bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

}  // namespace
