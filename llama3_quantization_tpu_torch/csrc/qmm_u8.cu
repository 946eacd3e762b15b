// u8-native unpack probes: kernel B10.
//
// Replaces `_u8_kernel` (via `u8_qmm`) of scripts/microbench_unpack.py. x s8
// [8, K]; packed unsigned 4-bit codes [K/2, N] in the group-local layout of
// quant/pack.py (byte row g*64 + i holds k = g*128 + i in its low nibble and
// k = g*128 + 64 + i in its high one); scale and zero f32 [K/128, N]; out f32
// [8, N]:
//   dot2, cat: out = sum_g (f32(dot_g) - f32(xsum_g) * z_g) * s_g over the
//     groups in order, with dot_g and xsum_g exact in s32 (the integers of
//     B3.v3 on u4 codes), one rounding per operation: `a8_plain`'s result
//     bit for bit;
//   bf16: out = sum_g bf16(x_g) . ((bf16(c) - bf16(z_g)) * bf16(s_g)), each
//     group's dot accumulated in f32, the groups added in order.
// The three variants keep their meaning as formulations of one stream, all
// on the tensor cores with the codes as the 16-row operand (16 columns) and
// the 8 x rows as the 8-column one, exactly:
//   dot2: the low and the high nibbles are dotted as two chains straight
//     from the packed bytes (mma.sync m16n8k32 s8: the low nibbles of 32 byte
//     rows against x's k of the group's first half, the high ones against
//     its second half), the chains added in s32 at the group's end;
//   cat: each 16-row chunk's low and high nibbles form one 32-k step of the
//     group's assembled 128-k s8 tile, dotted in one chain;
//   bf16: the codes are dequantized in registers with packed bf16x2
//     arithmetic (c - bf16(z), then * bf16(s), each rounded once, as the
//     plain version rounds), then mma.sync m16n8k16 bf16 with f32
//     accumulation, a fresh sum per group added to the output in order.
// Codes reach the lanes by ldmatrix.trans (four byte rows of one column a
// register); each stage's x is permuted once in shared memory into the MMA's
// k order (dot2, cat: loaded by ldmatrix) or converted to bf16; a second s8
// MMA with an all-ones operand gives the exact x sums of dot2 and cat, so
// nothing sums x serially.
//
// What bounds it on the H100: the packed bytes plus scale and zero over HBM
// at 3.35 TB/s. A block owns 128 columns (eight consumer warps of 16: every
// code row a full 128-byte line) and walks the groups; one producer warp
// keeps a ring of `ring` stages in flight on mbarriers, a stage being one
// group: its packed [64 x 128] codes and its x [8 x 128] as TMA boxes with a
// 128-byte swizzle, its scale and zero as bulk copies. `u8_plan`
// (ops/qmm_u8.py) sets the ring from (K, N). The columns alone give 112
// blocks at N = 14336 and 224 at 28672; K does not split, so each output's
// groups are summed in order by one lane and no partial crosses blocks.

#include "common.cuh"

namespace {

using l3q::as_bf162;
using l3q::as_u32;

enum Variant { DOT2 = 0, CAT = 1, BF16 = 2 };
constexpr int CWARPS = 8, THREADS = (CWARPS + 1) * 32;  // warp CWARPS copies
constexpr int BM = 8, GS = 128, HALF = GS / 2, BN = 128;  // BN: 16 columns a consumer warp
constexpr int CODES = HALF * BN;  // a stage's packed bytes (128-byte swizzle)
constexpr int XB = BM * GS;       // a stage's x [8][128] (128-byte swizzle)
constexpr int SLOT = CODES + XB + 2 * BN * 4;  // codes, x, scale, zero
constexpr int XBLD = l3q::odd_row(2 * GS);     // x row of a stage in the MMA's k order, bytes
                                               // (s8 for dot2 and cat, bf16 for bf16)
constexpr uint32_t ONES = 0x01010101u;

__host__ __device__ constexpr int smem_bytes(int ring) { return ring * SLOT + 2 * BM * XBLD + 2 * ring * 8; }

// Packed 4-bit codes of rows (r, r + 1) of one column, in bytes 0 and 2 of
// `p`, as bf16 (c - z) * s, each operation rounded once.
__device__ __forceinline__ uint32_t dequant2(uint32_t p, __nv_bfloat162 z2, __nv_bfloat162 s2) {
  const __nv_bfloat162 c = __hsub2(as_bf162((p & 0x000F000Fu) | 0x43004300u), as_bf162(0x43004300u));
  return as_u32(__hmul2(__hsub2(c, z2), s2));
}

template <int V>
__global__ void __launch_bounds__(THREADS) u8_kernel(
    const float* __restrict__ scale, const float* __restrict__ zero, float* __restrict__ out, int K,
    int N, int ring, const __grid_constant__ CUtensorMap tmw, const __grid_constant__ CUtensorMap tmx) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, gid = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * BN, G = K / GS, ncol = min(BN, N - n0);  // 64 or 128
  unsigned char* xk = smem + (size_t)ring * SLOT;  // [2][BM][XBLD]: x of the last two stages
  uint64_t* full = reinterpret_cast<uint64_t*>(xk + 2 * BM * XBLD);
  uint64_t* empty = full + ring;
  if (tid == 0) {
    l3q::mbar_init_n(full, ring);
    l3q::mbar_init_n(empty, ring, CWARPS);
  }
  __syncthreads();

  if (warp == CWARPS) {  // the producer
    for (int g = 0; g < G; ++g) {
      const int slot = g % ring;
      unsigned char* W = smem + (size_t)slot * SLOT;
      if (lane == 0) {
        if (g >= ring) l3q::mbar_wait(empty + slot, (g / ring - 1) & 1);
        l3q::mbar_expect_tx(full + slot, CODES + XB + 2 * ncol * 4);  // TMA boxes come whole
      }
      __syncwarp();
      if (lane == 0) {
        l3q::tma_load_2d(W, &tmw, n0, g * HALF, full + slot);
      } else if (lane == 1) {
        l3q::tma_load_2d(W + CODES, &tmx, g * GS, 0, full + slot);
      } else if (lane == 2) {
        l3q::bulk_load(W + CODES + XB, scale + (size_t)g * N + n0, ncol * 4, full + slot);
      } else if (lane == 3) {
        l3q::bulk_load(W + CODES + XB + BN * 4, zero + (size_t)g * N + n0, ncol * 4, full + slot);
      }
    }
    return;
  }

  // consumer warp: columns cb .. cb + 15 (one m16 tile); lane (g, t) holds
  // columns cb + 2g, cb + 2g + 1 and rows 2t, 2t + 1 of the output: element
  // e is column cb + 2g + (e >> 1), row 2t + (e & 1)
  const int cb = warp * 16;
  const int a_off = (lane & 15) * BN + ((warp ^ (lane & 7)) << 4);  // its ldmatrix.trans row
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int g = 0; g < G; ++g) {
    const int slot = g % ring;
    l3q::mbar_wait(full + slot, (g / ring) & 1);
    const unsigned char* Wt = smem + (size_t)slot * SLOT;
    const unsigned char* X = Wt + CODES;
    const float* S = reinterpret_cast<const float*>(X + XB);
    const float* Z = S + BN;
    if (!(L3Q_ABLATE & 1024)) {  // (columns past N: zeros, never stored)
      // w[c][i]: chunk c's (byte rows 16c ..) column cb + 2g + i, rows 2t,
      // 2t + 1, 8 + 2t, 9 + 2t of the chunk
      uint32_t w[4][2];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        uint32_t r[2];
        l3q::ldmatrix_x2_trans(r, Wt + a_off + c * 16 * BN);
        l3q::trans_cols(r[0], r[1], w[c]);
      }
      unsigned char* xb = xk + (g & 1) * BM * XBLD;  // (the barrier below also frees the other)
      if (V != BF16) {
        // x once a stage into the MMA's k order: 16-byte block c of a row
        // becomes word t = x[16c + {2t, 2t+1, 8+2t, 9+2t}], the partners of
        // chunk c's nibbles in the codes' ldmatrix.trans order (block c < 4:
        // the low nibbles, k = 16c + row; c >= 4: the high ones, k + 64)
        if (tid < BM * GS / 16) {
          const int m = tid >> 3, c = tid & 7;
          const uint4 v = *reinterpret_cast<const uint4*>(X + l3q::swz_off(m, 16 * c, GS));
          uint4 o;
          o.x = __byte_perm(v.x, v.z, 0x5410);
          o.y = __byte_perm(v.x, v.z, 0x7632);
          o.z = __byte_perm(v.y, v.w, 0x5410);
          o.w = __byte_perm(v.y, v.w, 0x7632);
          *reinterpret_cast<uint4*>(xb + m * XBLD + 16 * c) = o;
        }
        l3q::bar_sync(1, CWARPS * 32);
        uint32_t bx[4][2], r4[4];  // bx[c][0]: chunk c's low nibbles' x, bx[c][1] its high ones'
        const unsigned char* xl = xb + (lane & 7) * XBLD + 16 * (lane >> 3);
        l3q::ldmatrix_x4(r4, xl);
#pragma unroll
        for (int c = 0; c < 4; ++c) bx[c][0] = r4[c];
        l3q::ldmatrix_x4(r4, xl + HALF);
#pragma unroll
        for (int c = 0; c < 4; ++c) bx[c][1] = r4[c];
        int d[4] = {0, 0, 0, 0}, xs[4] = {0, 0, 0, 0};
        const uint32_t ones[4] = {ONES, ONES, ONES, ONES};
#pragma unroll
        for (int c = 0; c < 4; ++c) l3q::mma_s8_16832(xs, ones, bx[c]);
        auto lo = [](uint32_t v) { return v & 0x0F0F0F0Fu; };
        auto hi = [](uint32_t v) { return (v >> 4) & 0x0F0F0F0Fu; };
        if (V == CAT) {
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const uint32_t a[4] = {lo(w[c][0]), lo(w[c][1]), hi(w[c][0]), hi(w[c][1])};
            l3q::mma_s8_16832(d, a, bx[c]);
          }
        } else {
          int dh[4] = {0, 0, 0, 0};
#pragma unroll
          for (int c = 0; c < 4; c += 2) {
            const uint32_t al[4] = {lo(w[c][0]), lo(w[c][1]), lo(w[c + 1][0]), lo(w[c + 1][1])};
            const uint32_t ah[4] = {hi(w[c][0]), hi(w[c][1]), hi(w[c + 1][0]), hi(w[c + 1][1])};
            const uint32_t bl[2] = {bx[c][0], bx[c + 1][0]}, bh[2] = {bx[c][1], bx[c + 1][1]};
            l3q::mma_s8_16832(d, al, bl);
            l3q::mma_s8_16832(dh, ah, bh);
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) d[e] += dh[e];
        }
        const float2 s2 = *reinterpret_cast<const float2*>(S + cb + 2 * gid);
        const float2 z2 = *reinterpret_cast<const float2*>(Z + cb + 2 * gid);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float sc = (e >> 1) ? s2.y : s2.x, z = (e >> 1) ? z2.y : z2.x;
          const float tg = __fsub_rn((float)d[e], __fmul_rn((float)xs[e & 1], z));
          acc[e] = __fadd_rn(acc[e], __fmul_rn(tg, sc));
        }
      } else {
        // x to bf16 once a stage
        {
          const int m = tid >> 5, k0 = (tid & 31) * 4;
          const uint32_t v = *reinterpret_cast<const uint32_t*>(X + l3q::swz_off(m, k0, GS));
          uint32_t* dst = reinterpret_cast<uint32_t*>(xb + m * XBLD + 2 * k0);
          dst[0] = l3q::pack_bf16x2((float)(int8_t)(v & 0xFF), (float)(int8_t)((v >> 8) & 0xFF));
          dst[1] = l3q::pack_bf16x2((float)(int8_t)((v >> 16) & 0xFF), (float)(int8_t)(v >> 24));
        }
        l3q::bar_sync(1, CWARPS * 32);
        const uint32_t* xr = reinterpret_cast<const uint32_t*>(xb + gid * XBLD);
        __nv_bfloat162 z2[2], s2[2];  // column cb + 2g + i
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          z2[i] = __float2bfloat162_rn(Z[cb + 2 * gid + i]);
          s2[i] = __float2bfloat162_rn(S[cb + 2 * gid + i]);
        }
        float d[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int c = 0; c < 4; ++c)
#pragma unroll
          for (int h = 0; h < 2; ++h) {  // low nibbles: k = 16c + row; high: + 64
            const uint32_t b[2] = {xr[32 * h + 8 * c + t], xr[32 * h + 8 * c + 4 + t]};
            uint32_t a[4];
#pragma unroll
            for (int i = 0; i < 2; ++i) {  // rows 2t, 2t + 1 -> a[i]; 8 + 2t, 9 + 2t -> a[2 + i]
              const uint32_t v = h ? w[c][i] >> 4 : w[c][i];
              a[i] = dequant2(__byte_perm(v, 0, 0x4140), z2[i], s2[i]);
              a[2 + i] = dequant2(__byte_perm(v, 0, 0x4342), z2[i], s2[i]);
            }
            l3q::mma_bf16_16816(d, a, b);
          }
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[e] = __fadd_rn(acc[e], d[e]);
      }
    }
    __syncwarp();
    if (lane == 0) l3q::mbar_arrive(empty + slot);
  }
  if (cb < ncol)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      out[(size_t)(2 * t + (e & 1)) * N + n0 + cb + 2 * gid + (e >> 1)] = acc[e];
}

template <int V>
int launch(const CUtensorMap& tmw, const CUtensorMap& tmx, const float* s, const float* z,
           float* out, int K, int N, int ring, cudaStream_t st) {
  const int smem = smem_bytes(ring);
  int e = (int)cudaFuncSetAttribute(u8_kernel<V>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e) return e;
  u8_kernel<V><<<(N + BN - 1) / BN, THREADS, smem, st>>>(s, z, out, K, N, ring, tmw, tmx);
  return (int)cudaGetLastError();
}

}  // namespace

// variant: 0 dot2, 1 cat, 2 bf16. x s8 [8, K]; w u8 [K/2, N]; scale, zero
// f32 [K/128, N]; out f32 [8, N]; bn: 128 (`u8_plan`); ring: stages in
// flight. Needs K % 128 == 0, N % 64 == 0 (a last block of 64 columns
// reads zeros beyond N and stores nothing there), every pointer 16-byte
// aligned.
extern "C" int l3q_qmm_u8(int variant, const void* x, const void* w, const void* scale,
                          const void* zero, void* out, int K, int N, int bn, int ring,
                          void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (K % GS || bn != BN || N % 64 || ring < 2 || ring > 16) return (int)cudaErrorInvalidValue;
  CUtensorMap tmw, tmx;
  int e = l3q::tensor_map_u8(&tmw, w, K / 2, N, N, HALF, BN, CU_TENSOR_MAP_SWIZZLE_128B);
  if (!e) e = l3q::tensor_map_u8(&tmx, x, BM, K, K, BM, GS, CU_TENSOR_MAP_SWIZZLE_128B);
  if (e) return e;
  const float *sp = (const float*)scale, *zp = (const float*)zero;
  float* op = (float*)out;
  switch (variant) {
    case DOT2: return launch<DOT2>(tmw, tmx, sp, zp, op, K, N, ring, st);
    case CAT: return launch<CAT>(tmw, tmx, sp, zp, op, K, N, ring, st);
    case BF16: return launch<BF16>(tmw, tmx, sp, zp, op, K, N, ring, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
