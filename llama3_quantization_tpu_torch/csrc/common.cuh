// Shared helpers for the port's hand-written Hopper kernels (sm_90a).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace l3q {

// Round a float to the nearest bf16 and back (round half to even).
__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ void store_out(void* out, size_t i, float v, int out_bf16) {
  if (out_bf16) {
    reinterpret_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16_rn(v);
  } else {
    reinterpret_cast<float*>(out)[i] = v;
  }
}

// D += A * B for one m16n8k16 tile: bf16 operands, fp32 accumulation.
// A: 4 regs (row-major fragment), B: 2 regs (column fragment), D: 4 floats.
__device__ __forceinline__ void mma_bf16_16816(float* d, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

}  // namespace l3q
