// u8-native unpack probes: kernel B10.
//
// Replaces `_u8_kernel` (via `u8_qmm`) of scripts/microbench_unpack.py. x s8
// [8, K]; packed unsigned 4-bit codes [K/2, N] in the group-local layout of
// quant/pack.py (byte row g*64 + i holds k = g*128 + i in its low nibble and
// k = g*128 + 64 + i in its high one); scale and zero f32 [K/128, N]; out f32
// [8, N]:
//   dot2, cat: out = sum_g (f32(dot_g) - f32(xsum_g) * z_g) * s_g over the
//     groups in order, with dot_g and xsum_g exact in s32 (the integers of
//     B3.v3 on u4 codes), one rounding per operation;
//   bf16: out = sum_g bf16(x_g) . ((bf16(c) - bf16(z_g)) * bf16(s_g)), each
//     group's dot accumulated in f32, the groups added in order.
// The three variants keep their meaning as formulations of one stream:
//   dot2: the low and the high nibbles are dotted straight from the packed
//     bytes (per-byte mask and shift, a byte transpose, `__dp4a` against the
//     two halves of the group's x); the warps' s32 partials meet in shared
//     memory;
//   cat: the group's codes are assembled into one s8 [128 k x 64 columns]
//     tile in shared memory, then dotted by `mma.sync` m16n8k32 s8 (the 8 x
//     rows fill half of the 16-row A tile; the other half is zero);
//   bf16: the group is dequantized to bf16 in shared memory, then dotted by
//     `mma.sync` m16n8k16 bf16 with f32 accumulation.
// What bounds it on the H100: the packed bytes plus scale and zero over HBM
// at 3.35 TB/s. A block of 4 warps owns 64 columns and walks the groups; the
// groups' packed tiles [64 rows x 64 columns] stream into a ring of STAGES
// shared-memory buffers with `cp.async`.

#include "common.cuh"

namespace {

using l3q::bf16_round;
using l3q::cp_async16;
using l3q::cp_async_commit;
using l3q::cp_async_wait;
using l3q::mma_bf16_16816;
using l3q::mma_s8_16832;
using l3q::pack_bf16x2;
using l3q::transpose4;

enum Variant { DOT2 = 0, CAT = 1, BF16 = 2 };
constexpr int THREADS = 128, BM = 8, GS = 128, HALF = GS / 2, NC = 64;
constexpr int STAGES = 4;  // groups of packed bytes in flight per block
constexpr int TLD = GS + 16;  // s8 tile row in bytes: conflict-free fragment loads
constexpr int TLDH = GS + 8;  // bf16 tile row in elements: the same

// The lo and hi code words of 4 byte rows (i0 .. i0 + 3) and 4 columns of a
// packed tile: lo[c] = codes k = i0 .. i0 + 3 of column c, hi[c] = k = 64 + i0 ..
__device__ __forceinline__ void unpack4x4(const uint8_t* pk, int i0, int c0, uint32_t* lo,
                                          uint32_t* hi) {
  uint32_t lr[4], hr[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const uint32_t w = *reinterpret_cast<const uint32_t*>(pk + (i0 + r) * NC + c0);
    lr[r] = w & 0x0F0F0F0Fu;
    hr[r] = (w >> 4) & 0x0F0F0F0Fu;
  }
  transpose4(lr, lo);
  transpose4(hr, hi);
}

template <int V>
__global__ void __launch_bounds__(THREADS) u8_kernel(
    const int8_t* __restrict__ x, const uint8_t* __restrict__ w, const float* __restrict__ scale,
    const float* __restrict__ zero, float* __restrict__ out, int K, int N) {
  __shared__ __align__(16) uint8_t pk[STAGES][HALF][NC];
  __shared__ __align__(16) int8_t t8[V == CAT ? NC : 1][TLD];
  __shared__ __align__(16) __nv_bfloat16 tb[V == BF16 ? NC : 1][TLDH];
  __shared__ int red[V == DOT2 ? BM : 1][NC];
  __shared__ int xs[BM];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, gid = lane >> 2, tig = lane & 3;
  const int n0 = blockIdx.x * NC, G = K / GS;

  auto load = [&](int g, int buf) {
    for (int i = tid; i < HALF * NC / 16; i += THREADS) {
      const int r = i / (NC / 16), c = (i - r * (NC / 16)) * 16;
      cp_async16(&pk[buf][r][c], w + (size_t)(g * HALF + r) * N + n0 + c);
    }
  };

  // dot2: outputs tid + 128 i of the block's [8, 64]; cat / bf16: row gid,
  // columns (2 warp + nt) * 8 + 2 tig + e at [2 nt + e]
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  if (V == DOT2)
    for (int e = tid; e < BM * NC; e += THREADS) red[e / NC][e % NC] = 0;
#pragma unroll
  for (int g = 0; g < STAGES - 1; ++g) {
    if (g < G) load(g, g);
    cp_async_commit();
  }
  for (int g = 0; g < G; ++g) {
    const int buf = g % STAGES;
    if (g + STAGES - 1 < G) load(g + STAGES - 1, (g + STAGES - 1) % STAGES);
    cp_async_commit();
    cp_async_wait<STAGES - 1>();  // group g has landed
    if (tid < BM) {
      const int* xr = reinterpret_cast<const int*>(x + (size_t)tid * K + g * GS);
      int v = 0;
      for (int q = 0; q < GS / 4; ++q) v = __dp4a(__ldg(xr + q), 0x01010101, v);
      xs[tid] = v;
    }
    __syncthreads();

    if (V == DOT2) {
      const int cq = tid % (NC / 4), rq = tid / (NC / 4);  // columns 4 cq.., byte rows 8 rq..
      int d[BM][4];
#pragma unroll
      for (int m = 0; m < BM; ++m)
#pragma unroll
        for (int c = 0; c < 4; ++c) d[m][c] = 0;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i0 = rq * 8 + h * 4;
        uint32_t lo[4], hi[4];
        unpack4x4(&pk[buf][0][0], i0, cq * 4, lo, hi);
#pragma unroll
        for (int m = 0; m < BM; ++m) {
          const int8_t* xr = x + (size_t)m * K + g * GS + i0;
          const int xl = __ldg(reinterpret_cast<const int*>(xr));
          const int xh = __ldg(reinterpret_cast<const int*>(xr + HALF));
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            d[m][c] = __dp4a((int)lo[c], xl, d[m][c]);
            d[m][c] = __dp4a((int)hi[c], xh, d[m][c]);
          }
        }
      }
#pragma unroll
      for (int m = 0; m < BM; ++m)
#pragma unroll
        for (int c = 0; c < 4; ++c) atomicAdd(&red[m][cq * 4 + c], d[m][c]);
      __syncthreads();
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int o = tid + THREADS * i, m = o / NC, c = o % NC;
        const size_t gi = (size_t)g * N + n0 + c;
        const float t = __fsub_rn((float)red[m][c], __fmul_rn((float)xs[m], zero[gi]));
        acc[i] = __fadd_rn(acc[i], __fmul_rn(t, scale[gi]));
        red[m][c] = 0;
      }
    } else {
      // assemble the group's tile: 16 row quads x 16 column quads
      for (int it = tid; it < (HALF / 4) * (NC / 4); it += THREADS) {
        const int i0 = (it / (NC / 4)) * 4, c0 = (it % (NC / 4)) * 4;
        uint32_t lo[4], hi[4];
        unpack4x4(&pk[buf][0][0], i0, c0, lo, hi);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int n = c0 + c;
          if (V == CAT) {
            *reinterpret_cast<uint32_t*>(&t8[n][i0]) = lo[c];
            *reinterpret_cast<uint32_t*>(&t8[n][HALF + i0]) = hi[c];
          } else {
            const size_t gi = (size_t)g * N + n0 + n;
            const float zb = bf16_round(zero[gi]), sb = bf16_round(scale[gi]);
#pragma unroll
            for (int b = 0; b < 4; ++b) {
              const float cl = (float)((lo[c] >> (8 * b)) & 0xFF), ch = (float)((hi[c] >> (8 * b)) & 0xFF);
              tb[n][i0 + b] = __float2bfloat16_rn(__fmul_rn(bf16_round(cl - zb), sb));
              tb[n][HALF + i0 + b] = __float2bfloat16_rn(__fmul_rn(bf16_round(ch - zb), sb));
            }
          }
        }
      }
      __syncthreads();
      const int8_t* xr = x + (size_t)gid * K + g * GS;
      if (V == CAT) {
        int d[2][4] = {{0, 0, 0, 0}, {0, 0, 0, 0}};
#pragma unroll
        for (int ks = 0; ks < GS / 32; ++ks) {
          const uint32_t a[4] = {__ldg(reinterpret_cast<const uint32_t*>(xr + ks * 32 + tig * 4)), 0u,
                                 __ldg(reinterpret_cast<const uint32_t*>(xr + ks * 32 + 16 + tig * 4)), 0u};
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
            const int n = (2 * warp + nt) * 8 + gid;
            const uint32_t b[2] = {*reinterpret_cast<const uint32_t*>(&t8[n][ks * 32 + tig * 4]),
                                   *reinterpret_cast<const uint32_t*>(&t8[n][ks * 32 + 16 + tig * 4])};
            mma_s8_16832(d[nt], a, b);
          }
        }
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const size_t gi = (size_t)g * N + n0 + (2 * warp + nt) * 8 + tig * 2 + e;
            const float t = __fsub_rn((float)d[nt][e], __fmul_rn((float)xs[gid], zero[gi]));
            acc[2 * nt + e] = __fadd_rn(acc[2 * nt + e], __fmul_rn(t, scale[gi]));
          }
      } else {
        float d[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
        for (int ks = 0; ks < GS / 16; ++ks) {
          const int8_t* xk = xr + ks * 16 + tig * 2;
          const uint32_t a[4] = {pack_bf16x2((float)xk[0], (float)xk[1]), 0u,
                                 pack_bf16x2((float)xk[8], (float)xk[9]), 0u};
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
            const int n = (2 * warp + nt) * 8 + gid;
            const uint32_t b[2] = {*reinterpret_cast<const uint32_t*>(&tb[n][ks * 16 + tig * 2]),
                                   *reinterpret_cast<const uint32_t*>(&tb[n][ks * 16 + 8 + tig * 2])};
            mma_bf16_16816(d[nt], a, b);
          }
        }
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) acc[2 * nt + e] = __fadd_rn(acc[2 * nt + e], d[nt][e]);
      }
    }
    __syncthreads();  // the buffer, the tile and xs are free for the next group
  }

  if (V == DOT2) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int o = tid + THREADS * i;
      out[(size_t)(o / NC) * N + n0 + o % NC] = acc[i];
    }
  } else {
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        out[(size_t)gid * N + n0 + (2 * warp + nt) * 8 + tig * 2 + e] = acc[2 * nt + e];
  }
}

}  // namespace

// variant: 0 dot2, 1 cat, 2 bf16. x s8 [8, K]; w u8 [K/2, N]; scale, zero
// f32 [K/128, N]; out f32 [8, N]. Needs K % 128 == 0 and N % 64 == 0.
extern "C" int l3q_qmm_u8(int variant, const void* x, const void* w, const void* scale,
                          const void* zero, void* out, int K, int N, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (K % GS || N % NC) return (int)cudaErrorInvalidValue;
  const dim3 grid(N / NC);
  const int8_t* xp = (const int8_t*)x;
  const uint8_t* wp = (const uint8_t*)w;
  const float *sp = (const float*)scale, *zp = (const float*)zero;
  float* op = (float*)out;
  switch (variant) {
    case DOT2: u8_kernel<DOT2><<<grid, THREADS, 0, st>>>(xp, wp, sp, zp, op, K, N); break;
    case CAT: u8_kernel<CAT><<<grid, THREADS, 0, st>>>(xp, wp, sp, zp, op, K, N); break;
    case BF16: u8_kernel<BF16><<<grid, THREADS, 0, st>>>(xp, wp, sp, zp, op, K, N); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
