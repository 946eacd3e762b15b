// Fused dequant-matmul on packed low-bit weights: kernels B1 and B2.
//
// Replaces the TPU kernels in llama3_quantization_tpu/ops/pallas_qmatmul.py:
//   B1 `_qmm_v2_kernel` (scale after the dot, M <= 64: every decode linear)
//   B2 `_qmm_kernel`    (v1, dequant to bf16 before the dot, M > 64: prefill)
//
// Weight layout (quant/pack.py): codes [K, N] with groups of `gs` rows along
// K. Packed 4/2-bit storage is group-local: byte row j of group g holds rows
// g*gs + s*(gs/f) + j in bit field s*bits, so adjacent rows never share a
// byte. Packed 3-bit storage is three bit planes [3, K/8, N]: byte row r of
// plane b holds bit b of rows 8r..8r+7, row 8r+i in bit i (B2 only, as the
// TPU wrapper sends 3-bit weights to v1 at every M). Unpacked storage is one
// int8 or uint8 code per byte. scale and zero are fp32 [G, N].
//
// What bounds them on the H100:
// B1 at M = 1 is a GEMV that must stream K*N/f weight bytes plus 8 bytes of
// scale/zero per group column, so it is bound by HBM bytes (3.35 TB/s). The
// design puts many 16-byte loads in flight: each thread owns 16 adjacent
// columns (one 16-byte load per byte row), each warp a chunk of `rc` byte
// rows inside one group, each block 8 such chunks of one 512-column tile.
// Per chunk it forms dot = sum x*code and xsum = sum x in fp32 and adds
// dot*s - xsum*z*s; the 8 warps are summed in shared memory and the blocks
// along K by a fixed-order second pass, so results do not depend on timing.
// B2 at M = 128 does 2*M FLOPs per weight element: with the weight stream
// hidden it is bound by the tensor cores. The design is a shared-memory
// tiled GEMM (128x64x32 tiles, 8 warps, mma.sync bf16 with fp32
// accumulation) whose k tiles lie inside one group, so scale and zero are
// read once per tile and column; the next tile's activations and packed
// bytes are loaded into registers while the tensor cores work on the
// current one, and a K split fills the card when N is small. The weight
// tile is dequantized with the TPU kernel's bf16 rounding points.
// No TMA, wgmma or warp specialisation yet.

#include "common.cuh"

namespace {

using l3q::bf16_round;
using l3q::store_out;

// ---------------------------------------------------------------- B1 ----
constexpr int GEMV_THREADS = 256;
constexpr int GEMV_WARPS = GEMV_THREADS / 32;
constexpr int GEMV_COLS = 512;  // 32 lanes x 16 columns

template <int F, bool SIGNED>
__device__ __forceinline__ float code_of(uint32_t byte, int s) {
  constexpr int BITS = 8 / F;
  constexpr uint32_t MASK = (1u << BITS) - 1u;
  if (SIGNED) return (float)(int)(int8_t)byte;
  return (float)((byte >> (s * BITS)) & MASK);
}

// B1: y[m, n] = sum_g s[g,n] * (x_g . c_g[:, n]) - (sum_k x_g[k]) * z[g,n]*s[g,n]
// with x rounded to bf16 and the dots and x sums in fp32
// (pallas_qmatmul.py:214-233), taken chunk by chunk of a group.
template <int F, bool SIGNED, int MT>
__global__ void __launch_bounds__(GEMV_THREADS) qmm_gemv_kernel(
    const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ data,
    const float* __restrict__ scale, const float* __restrict__ zero,
    float* __restrict__ part, void* __restrict__ out, int out_bf16,
    int M, int K, int N, int gs, int rc) {
  extern __shared__ float red[];  // [GEMV_WARPS][MT][16][32]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c0 = blockIdx.x * GEMV_COLS + lane * 16;
  const int m0 = blockIdx.z * MT;
  const int sub = gs / F;
  const int rows = K / F;
  const int chunk = blockIdx.y * GEMV_WARPS + warp;
  const int r0 = chunk * rc;
  float acc[MT][16];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < 16; ++c) acc[m][c] = 0.f;

  if (c0 < N && r0 < rows) {
    const __nv_bfloat16* xrow[MT];
#pragma unroll
    for (int m = 0; m < MT; ++m) xrow[m] = x + (size_t)min(m0 + m, M - 1) * K;
    const int g = r0 / sub;
    const int kbase = g * gs + (r0 - g * sub);  // k of (row r0, field 0)
    float dot[MT][16], xs[MT];
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      xs[m] = 0.f;
#pragma unroll
      for (int c = 0; c < 16; ++c) dot[m][c] = 0.f;
    }
    const uint8_t* wp = data + (size_t)r0 * N + c0;
#pragma unroll 4
    for (int j = 0; j < rc; ++j) {
      const uint4 w = __ldg(reinterpret_cast<const uint4*>(wp + (size_t)j * N));
      const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int s = 0; s < F; ++s) {
        const int k = kbase + s * sub + j;
        float xv[MT];
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          xv[m] = __bfloat162float(xrow[m][k]);
          xs[m] += xv[m];
        }
#pragma unroll
        for (int c = 0; c < 16; ++c) {
          const float cf = code_of<F, SIGNED>((words[c >> 2] >> (8 * (c & 3))) & 0xFFu, s);
#pragma unroll
          for (int m = 0; m < MT; ++m) dot[m][c] = fmaf(xv[m], cf, dot[m][c]);
        }
      }
    }
    const float4* sp = reinterpret_cast<const float4*>(scale + (size_t)g * N + c0);
    const float4* zp = reinterpret_cast<const float4*>(zero + (size_t)g * N + c0);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float4 s4 = __ldg(sp + q), z4 = __ldg(zp + q);
      const float sv[4] = {s4.x, s4.y, s4.z, s4.w}, zv[4] = {z4.x, z4.y, z4.z, z4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float zs = zv[i] * sv[i];
#pragma unroll
        for (int m = 0; m < MT; ++m) acc[m][4 * q + i] = dot[m][4 * q + i] * sv[i] - xs[m] * zs;
      }
    }
  }

#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < 16; ++c) red[((warp * MT + m) * 16 + c) * 32 + lane] = acc[m][c];
  __syncthreads();
  for (int e = threadIdx.x; e < MT * GEMV_COLS; e += GEMV_THREADS) {
    const int m = e / GEMV_COLS, cl = e % GEMV_COLS;  // cl = c*32 + lane
    const int row = m0 + m, col = blockIdx.x * GEMV_COLS + (cl & 31) * 16 + (cl >> 5);
    if (row >= M || col >= N) continue;
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < GEMV_WARPS; ++w) v += red[(w * MT + m) * GEMV_COLS + cl];
    if (gridDim.y == 1) {
      store_out(out, (size_t)row * N + col, v, out_bf16);
    } else {
      part[((size_t)blockIdx.y * M + row) * N + col] = v;
    }
  }
}

// Sums the K-split partials [ksplit, M*N] in a fixed order and casts.
__global__ void qmm_splitk_reduce(const float* __restrict__ part, void* __restrict__ out,
                                  int out_bf16, int mn, int ksplit) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= mn) return;
  float v = 0.f;
  for (int y = 0; y < ksplit; ++y) v += part[(size_t)y * mn + i];
  store_out(out, i, v, out_bf16);
}

// ---------------------------------------------------------------- B2 ----
constexpr int BM = 128, BN = 64, BK = 32, LDS = BK + 8;
constexpr int GEMM_THREADS = 256;

// B2: y = bf16(x) @ W with W = bf16((bf16(code) - bf16(zero)) * bf16(scale))
// (pallas_qmatmul.py:84-103), fp32 accumulation. Needs K % 32 == 0 and
// gs % 32 == 0, so that a k tile lies inside one group.
// F: values per byte of the nibble layouts (4, 2, 1), or PLANES3 for the
// 3-bit bit planes, whose codes are assembled from three bytes.
constexpr int PLANES3 = 3;

template <int F, bool SIGNED>
__global__ void __launch_bounds__(GEMM_THREADS) qmm_gemm_kernel(
    const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ data,
    const float* __restrict__ scale, const float* __restrict__ zero,
    float* __restrict__ part, void* __restrict__ out, int out_bf16, int M, int K, int N,
    int gs, int tiles_per_split) {
  constexpr bool PLANES = F == PLANES3;
  constexpr int BITS = PLANES ? 3 : 8 / F;
  constexpr uint32_t MASK = (1u << BITS) - 1u;
  __shared__ __align__(16) __nv_bfloat16 As[BM][LDS];
  __shared__ __align__(16) __nv_bfloat16 Bs[BN][LDS];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const int bm0 = blockIdx.y * BM, bn0 = blockIdx.x * BN;
  const int sub = PLANES ? 0 : gs / F;
  const int kt0 = blockIdx.z * tiles_per_split;
  const int kt1 = min(kt0 + tiles_per_split, K / BK);

  // weight element ownership: column nl, k rows 2*(kp + 4*i) + {0, 1}
  const int nl = tid % BN, kp = tid / BN;
  const int n = bn0 + nl;
  const bool n_ok = n < N;

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;

  uint4 areg[2];
  uint8_t braw[8];
  int bshift[8];
  float zb = 0.f, sb = 0.f;

  auto load_tile = [&](int kt) {
    const int k0 = kt * BK;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * GEMM_THREADS;  // 512 chunks of 8 bf16
      const int row = bm0 + c / 4, col = k0 + (c % 4) * 8;
      areg[i] = row < M ? __ldg(reinterpret_cast<const uint4*>(x + (size_t)row * K + col))
                        : make_uint4(0, 0, 0, 0);
    }
    const int g = k0 / gs;
    if (n_ok) {
      zb = bf16_round(__ldg(zero + (size_t)g * N + n));
      sb = bf16_round(__ldg(scale + (size_t)g * N + n));
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int k = k0 + 2 * (kp + 4 * (e >> 1)) + (e & 1);
      if (PLANES) {  // code bit b = bit (k % 8) of plane b's byte row k / 8
        uint32_t code = 0;
#pragma unroll
        for (int b = 0; b < 3; ++b) {
          const size_t byte_row = (size_t)b * (K / 8) + (k >> 3);
          const uint32_t byte = n_ok ? __ldg(data + byte_row * N + n) : 0u;
          code |= ((byte >> (k & 7)) & 1u) << b;
        }
        braw[e] = (uint8_t)code;
        bshift[e] = 0;
        continue;
      }
      const int r = k - g * gs;
      const int s = F == 1 ? 0 : r / sub;
      const size_t byte_row = F == 1 ? (size_t)k : (size_t)g * sub + (r - s * sub);
      braw[e] = n_ok ? __ldg(data + byte_row * N + n) : (uint8_t)0;
      bshift[e] = s * BITS;
    }
  };

  auto store_tile = [&]() {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * GEMM_THREADS;
      *reinterpret_cast<uint4*>(&As[c / 4][(c % 4) * 8]) = areg[i];
    }
#pragma unroll
    for (int e = 0; e < 8; e += 2) {
      float w[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint32_t b = braw[e + h];
        const float code = SIGNED ? (float)(int)(int8_t)b : (float)((b >> bshift[e + h]) & MASK);
        w[h] = __fmul_rn(bf16_round(__fsub_rn(code, zb)), sb);
      }
      *reinterpret_cast<uint32_t*>(&Bs[nl][2 * (kp + 4 * (e >> 1))]) = l3q::pack_bf16x2(w[0], w[1]);
    }
  };

  if (kt0 < kt1) load_tile(kt0);
  for (int kt = kt0; kt < kt1; ++kt) {
    store_tile();
    __syncthreads();
    if (kt + 1 < kt1) load_tile(kt + 1);
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t a[2][4], b[4][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int r = wm + mi * 16 + gid;
        a[mi][0] = *reinterpret_cast<const uint32_t*>(&As[r][kk + tig * 2]);
        a[mi][1] = *reinterpret_cast<const uint32_t*>(&As[r + 8][kk + tig * 2]);
        a[mi][2] = *reinterpret_cast<const uint32_t*>(&As[r][kk + 8 + tig * 2]);
        a[mi][3] = *reinterpret_cast<const uint32_t*>(&As[r + 8][kk + 8 + tig * 2]);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int nn = wn + ni * 8 + gid;
        b[ni][0] = *reinterpret_cast<const uint32_t*>(&Bs[nn][kk + tig * 2]);
        b[ni][1] = *reinterpret_cast<const uint32_t*>(&Bs[nn][kk + 8 + tig * 2]);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) l3q::mma_bf16_16816(acc[mi][ni], a[mi], b[ni]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = bm0 + wm + mi * 16 + gid + h * 8;
        if (row >= M) continue;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = bn0 + wn + ni * 8 + tig * 2 + e;
          if (col >= N) continue;
          const float v = acc[mi][ni][2 * h + e];
          if (gridDim.z == 1) {
            store_out(out, (size_t)row * N + col, v, out_bf16);
          } else {
            part[((size_t)blockIdx.z * M + row) * N + col] = v;
          }
        }
      }
}

template <int F, bool SIGNED, int MT>
int launch_gemv(const void* x, const void* data, const void* scale, const void* zero,
                void* out, void* part, int M, int K, int N, int gs, int out_bf16, int ksplit,
                int rc, cudaStream_t st) {
  const size_t smem = (size_t)GEMV_WARPS * MT * GEMV_COLS * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      qmm_gemv_kernel<F, SIGNED, MT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((N + GEMV_COLS - 1) / GEMV_COLS, ksplit, (M + MT - 1) / MT);
  qmm_gemv_kernel<F, SIGNED, MT><<<grid, GEMV_THREADS, smem, st>>>(
      (const __nv_bfloat16*)x, (const uint8_t*)data, (const float*)scale,
      (const float*)zero, (float*)part, out, out_bf16, M, K, N, gs, rc);
  return (int)cudaGetLastError();
}

template <int F, bool SIGNED>
int launch_gemv_mt(const void* x, const void* data, const void* scale, const void* zero,
                   void* out, void* part, int M, int K, int N, int gs, int out_bf16,
                   int ksplit, int rc, int mt, cudaStream_t st) {
  if (mt == 1) return launch_gemv<F, SIGNED, 1>(x, data, scale, zero, out, part, M, K, N, gs, out_bf16, ksplit, rc, st);
  if (mt == 2) return launch_gemv<F, SIGNED, 2>(x, data, scale, zero, out, part, M, K, N, gs, out_bf16, ksplit, rc, st);
  return launch_gemv<F, SIGNED, 4>(x, data, scale, zero, out, part, M, K, N, gs, out_bf16, ksplit, rc, st);
}

template <int F, bool SIGNED>
int launch_gemm(const void* x, const void* data, const void* scale, const void* zero,
                void* out, void* part, int M, int K, int N, int gs, int out_bf16, int ksplit,
                cudaStream_t st) {
  const int tiles = K / BK;
  const int per_split = (tiles + ksplit - 1) / ksplit;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, ksplit);
  qmm_gemm_kernel<F, SIGNED><<<grid, GEMM_THREADS, 0, st>>>(
      (const __nv_bfloat16*)x, (const uint8_t*)data, (const float*)scale,
      (const float*)zero, (float*)part, out, out_bf16, M, K, N, gs, per_split);
  return (int)cudaGetLastError();
}

int reduce_splits(const void* part, void* out, int out_bf16, int M, int N, int ksplit,
                  cudaStream_t st) {
  const int mn = M * N;
  qmm_splitk_reduce<<<(mn + 255) / 256, 256, 0, st>>>((const float*)part, out, out_bf16, mn, ksplit);
  return (int)cudaGetLastError();
}

}  // namespace

// f: values per byte (4 = 2-bit, 2 = 4-bit, 1 = one code per byte);
// is_signed: int8 (1) or uint8 (0) codes when f == 1. B1: `rc` byte rows per
// warp chunk (divides gs/f), ksplit = ceil(K/f / (8*rc)) blocks along K,
// mt rows per block (1, 2 or 4). part: fp32 [ksplit, M, N] scratch, unused
// when ksplit == 1. Needs N % 16 == 0.
extern "C" int l3q_qmm_gemv(const void* x, const void* data, const void* scale,
                            const void* zero, void* out, void* part, int M, int K, int N,
                            int gs, int f, int is_signed, int out_bf16, int ksplit, int rc,
                            int mt, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  int err;
  if (f == 4) err = launch_gemv_mt<4, false>(x, data, scale, zero, out, part, M, K, N, gs, out_bf16, ksplit, rc, mt, st);
  else if (f == 2) err = launch_gemv_mt<2, false>(x, data, scale, zero, out, part, M, K, N, gs, out_bf16, ksplit, rc, mt, st);
  else if (is_signed) err = launch_gemv_mt<1, true>(x, data, scale, zero, out, part, M, K, N, gs, out_bf16, ksplit, rc, mt, st);
  else err = launch_gemv_mt<1, false>(x, data, scale, zero, out, part, M, K, N, gs, out_bf16, ksplit, rc, mt, st);
  if (err != 0 || ksplit == 1) return err;
  return reduce_splits(part, out, out_bf16, M, N, ksplit, st);
}

// B2: needs K % 32 == 0 and gs % 32 == 0; ksplit blocks along K. f as for
// B1, or 3 for the 3-bit bit planes [3, K/8, N].
extern "C" int l3q_qmm_gemm(const void* x, const void* data, const void* scale,
                            const void* zero, void* out, void* part, int M, int K, int N,
                            int gs, int f, int is_signed, int out_bf16, int ksplit,
                            void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  int err;
  if (f == PLANES3) err = launch_gemm<PLANES3, false>(x, data, scale, zero, out, part, M, K, N, gs, out_bf16, ksplit, st);
  else if (f == 4) err = launch_gemm<4, false>(x, data, scale, zero, out, part, M, K, N, gs, out_bf16, ksplit, st);
  else if (f == 2) err = launch_gemm<2, false>(x, data, scale, zero, out, part, M, K, N, gs, out_bf16, ksplit, st);
  else if (is_signed) err = launch_gemm<1, true>(x, data, scale, zero, out, part, M, K, N, gs, out_bf16, ksplit, st);
  else err = launch_gemm<1, false>(x, data, scale, zero, out, part, M, K, N, gs, out_bf16, ksplit, st);
  if (err != 0 || ksplit == 1) return err;
  return reduce_splits(part, out, out_bf16, M, N, ksplit, st);
}
