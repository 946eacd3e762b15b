// Block-diagonal int4 dot probes: kernel B9.
//
// Replaces the int4-dot TPU kernels of the weight-stream microbenches:
//   scripts/microbench_w4_v4.py `_v4_kernel` (via `v4_matvec`) and
//     scripts/microbench_w4_variants.py `_bd4_kernel`, the same kernel ("v4");
//   scripts/microbench_w4_tiled.py `_bd4_kernel` (tile-contiguous weight
//     [K/bk, N/bn, bk/2, bn], "tiled");
//   scripts/microbench_w4_variants.py `_dot4_kernel` ("dot4"),
//     `_noscale_kernel` ("noscale") and `_cast8_kernel` ("cast8");
//   scripts/microbench_w4_multidma.py `_kernel` (S weight streams, "multi").
// Each walks K tiles j of bk rows (gt = bk / 128 groups), forms the exact s32
// product P = A_j W_j of an s8 row operand A_j [R, bk] with the int4 weight
// tile W_j [bk, N] (row k of a tile is the low nibble of byte row k / 2 for
// even k and the high nibble for odd k: the TPU's int8 -> int4 bitcast), and
// adds an fp32 epilogue t_j of P to out [1, N]:
//   v4, tiled: A_j block diagonal: row r < gt holds xh on group r's
//     columns, row gt + r holds xl there (x = 16 xh + xl);
//     t_j = sum_{r < gt} f32(16 P[r] + P[gt + r]) * s[j gt + r];
//   dot4: A_j = bd[0:2gt, tile j] (dense, int4 values); t_j as for v4;
//   cast8: A_j = bd[0:gt, tile j] (s8); t_j = sum_{r < gt} f32(P[r]) * s[j gt + r];
//   noscale: A_j as for dot4; t_j = sum_{r < 2gt} f32(P[r]);
//   multi: S streams, stream s with its own weight [K/2S, N] and rows
//     [2gt/S, K/S]: P = sum_s bd_s[:, tile j of s] W_s[tile j of s]; t_j as
//     for noscale;
// out = sum_j t_j, with t_j and out summed in order, one rounding per
// operation, as the plain version (ops/w4_bd.py) sums them.
//
// What bounds it on the H100: the packed weight bytes (and scales) over HBM
// at 3.35 TB/s; the integer work is at most 2 * 2gt multiply-adds per weight
// byte. Hopper has no int4 tensor-core path, so nibbles are sign-extended to
// s8 by per-byte SIMD and dotted with `__dp4a`: each lane owns 4 adjacent
// columns and reads one 32-bit word per byte row; two byte rows give four
// consecutive k of each column after a byte transpose. The v4 form skips the
// zero blocks of A_j: each of its rows dots only its own group. A block of
// 8 warps owns 128 columns and walks the K tiles; inside a tile each warp
// takes bk / 8 consecutive k, the warps' s32 partials meet in shared memory
// (integer atomics: exact in any order), and one thread per column runs the
// epilogue.

#include "common.cuh"

namespace {

enum Form { V4 = 0, DOT4 = 1, CAST8 = 2, NOSCALE = 3, MULTI = 4 };
constexpr int THREADS = 256, WARPS = 8, COLS = 128, GS = 128, MAXR = 32;

struct Args {
  const int8_t* w[4];  // packed int4 weight per stream (tiled: stream 0)
  const int8_t* a[4];  // row operand per stream; v4: a[0] = xh, a[1] = xl
  const float* scale;  // [K / 128, N] (v4, dot4, cast8)
  float* out;          // [1, N]
  int K, N, bk, bn, streams, rows, a_ld, tiled;
};

__device__ __forceinline__ uint32_t sext_nibbles(uint32_t v) {  // one nibble per byte
  return __vsub4(v ^ 0x08080808u, 0x08080808u);
}

// Byte rows w0 (k, k + 1) and w1 (k + 2, k + 3) of 4 columns -> c[i] = the
// s8 codes k .. k + 3 of column i, k in the low byte.
__device__ __forceinline__ void columns4(uint32_t w0, uint32_t w1, uint32_t* c) {
  const uint32_t lo0 = sext_nibbles(w0 & 0x0F0F0F0Fu), hi0 = sext_nibbles((w0 >> 4) & 0x0F0F0F0Fu);
  const uint32_t lo1 = sext_nibbles(w1 & 0x0F0F0F0Fu), hi1 = sext_nibbles((w1 >> 4) & 0x0F0F0F0Fu);
  const uint32_t r[4] = {__byte_perm(lo0, hi0, 0x5140), __byte_perm(lo0, hi0, 0x7362),
                         __byte_perm(lo1, hi1, 0x5140), __byte_perm(lo1, hi1, 0x7362)};
  c[0] = __byte_perm(r[0], r[2], 0x5410);
  c[1] = __byte_perm(r[0], r[2], 0x7632);
  c[2] = __byte_perm(r[1], r[3], 0x5410);
  c[3] = __byte_perm(r[1], r[3], 0x7632);
}

template <int F>
__global__ void __launch_bounds__(THREADS) bd_kernel(Args p) {
  __shared__ int P[MAXR][COLS];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n0 = blockIdx.x * COLS, n = n0 + lane * 4;
  const int gt = p.bk / GS, slice = p.bk / WARPS;
  // a warp's slice of a tile lies inside one stream: its addresses are set
  // once per tile, and the inner loops only step them
  const int ks = p.bk / p.streams, k_begin = warp * slice, s = k_begin / ks;
  const int kk = k_begin - s * ks;  // the slice's first k inside the stream's tile
  const size_t wstride = p.tiled ? p.bn : p.N;
  const int h = p.tiled ? n / p.bn : 0;
  for (int e = threadIdx.x; e < MAXR * COLS; e += THREADS) (&P[0][0])[e] = 0;
  float acc = 0.f;
  __syncthreads();

  for (int j = 0; j < p.K / p.bk; ++j) {
    // byte row k_begin / 2 of tile j at columns n .. n + 3
    const int8_t* w0 =
        p.tiled ? p.w[0] + (((size_t)j * (p.N / p.bn) + h) * (p.bk / 2) + kk / 2) * p.bn + (n - h * p.bn)
                : p.w[s] + ((size_t)j * (ks / 2) + kk / 2) * p.N + n;
    if (F == V4) {
      // each row dots only its own group: the zero blocks of A_j are skipped
      const int8_t* xh0 = p.a[0] + (size_t)j * p.bk + k_begin;
      const int8_t* xl0 = p.a[1] + (size_t)j * p.bk + k_begin;
      const int seg = min(slice, GS);
      for (int k0 = 0; k0 < slice; k0 += seg) {
        int dh[4] = {0, 0, 0, 0}, dl[4] = {0, 0, 0, 0};
#pragma unroll 2
        for (int k = k0; k < k0 + seg; k += 16) {
          uint32_t wv[8];
#pragma unroll
          for (int q = 0; q < 8; ++q)
            wv[q] = __ldg(reinterpret_cast<const uint32_t*>(w0 + (size_t)(k / 2 + q) * wstride));
          const uint4 xh = __ldg(reinterpret_cast<const uint4*>(xh0 + k));
          const uint4 xl = __ldg(reinterpret_cast<const uint4*>(xl0 + k));
          const uint32_t hw[4] = {xh.x, xh.y, xh.z, xh.w}, lw[4] = {xl.x, xl.y, xl.z, xl.w};
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            uint32_t c[4];
            columns4(wv[2 * q], wv[2 * q + 1], c);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              dh[i] = __dp4a((int)c[i], (int)hw[q], dh[i]);
              dl[i] = __dp4a((int)c[i], (int)lw[q], dl[i]);
            }
          }
        }
        const int g = (k_begin + k0) / GS;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          atomicAdd(&P[g][lane * 4 + i], dh[i]);
          atomicAdd(&P[gt + g][lane * 4 + i], dl[i]);
        }
      }
    } else {
      const int8_t* a0 = p.a[s] + (size_t)j * ks + kk;
      int d[MAXR][4];
#pragma unroll
      for (int r = 0; r < MAXR; ++r)
#pragma unroll
        for (int i = 0; i < 4; ++i) d[r][i] = 0;
      for (int k = 0; k < slice; k += 16) {
        uint32_t wv[8], c[4][4];  // c: [4 consecutive k][column]
#pragma unroll
        for (int q = 0; q < 8; ++q)
          wv[q] = __ldg(reinterpret_cast<const uint32_t*>(w0 + (size_t)(k / 2 + q) * wstride));
#pragma unroll
        for (int q = 0; q < 4; ++q) columns4(wv[2 * q], wv[2 * q + 1], c[q]);
#pragma unroll
        for (int r = 0; r < MAXR; ++r) {
          if (r < p.rows) {
            const uint4 a = __ldg(reinterpret_cast<const uint4*>(a0 + (size_t)r * p.a_ld + k));
            const uint32_t aw[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
            for (int q = 0; q < 4; ++q)
#pragma unroll
              for (int i = 0; i < 4; ++i) d[r][i] = __dp4a((int)c[q][i], (int)aw[q], d[r][i]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < MAXR; ++r)
        if (r < p.rows)
#pragma unroll
          for (int i = 0; i < 4; ++i) atomicAdd(&P[r][lane * 4 + i], d[r][i]);
    }
    __syncthreads();

    if (threadIdx.x < COLS) {  // epilogue: one thread per column, rows in order
      const int c = threadIdx.x;
      const float* sc = p.scale + (size_t)j * gt * p.N + n0 + c;
      float t = 0.f;
      if (F == V4 || F == DOT4) {
        for (int r = 0; r < gt; ++r)
          t = __fadd_rn(t, __fmul_rn((float)(16 * P[r][c] + P[gt + r][c]), sc[(size_t)r * p.N]));
      } else if (F == CAST8) {
        for (int r = 0; r < gt; ++r) t = __fadd_rn(t, __fmul_rn((float)P[r][c], sc[(size_t)r * p.N]));
      } else {
        for (int r = 0; r < p.rows; ++r) t = __fadd_rn(t, (float)P[r][c]);
      }
      acc = __fadd_rn(acc, t);
      for (int r = 0; r < MAXR; ++r) P[r][c] = 0;
    }
    __syncthreads();
  }
  if (threadIdx.x < COLS) p.out[n0 + threadIdx.x] = acc;
}

}  // namespace

// form: 0 v4, 1 dot4, 2 cast8, 3 noscale, 4 multi. w0..w3: packed weights
// per stream (row-major [K / 2S, N]; tiled [K/bk, N/bn, bk/2, bn] in w0);
// a0..a3: the row operand per stream (v4: a0 = xh, a1 = xl, each [1, K];
// otherwise `rows` rows of `a_ld` bytes); scale f32 [K / 128, N]; out f32
// [1, N]. Needs N % 128 == 0 (tiled: bn % 128 == 0), bk a power of two in
// [256, 2048] dividing K, rows <= 32, streams in {1, 2, 4}, a_ld % 16 == 0.
extern "C" int l3q_w4_bd(int form, const void* w0, const void* w1, const void* w2,
                         const void* w3, const void* a0, const void* a1, const void* a2,
                         const void* a3, const void* scale, void* out, int K, int N, int bk,
                         int bn, int streams, int rows, int a_ld, int tiled, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (N % COLS || K % bk || bk < 256 || bk > 2048 || (bk & (bk - 1)) || rows > MAXR ||
      (tiled && bn % COLS) || a_ld % 16 || (streams != 1 && streams != 2 && streams != 4))
    return (int)cudaErrorInvalidValue;
  Args p;
  p.w[0] = (const int8_t*)w0; p.w[1] = (const int8_t*)w1;
  p.w[2] = (const int8_t*)w2; p.w[3] = (const int8_t*)w3;
  p.a[0] = (const int8_t*)a0; p.a[1] = (const int8_t*)a1;
  p.a[2] = (const int8_t*)a2; p.a[3] = (const int8_t*)a3;
  p.scale = (const float*)scale;
  p.out = (float*)out;
  p.K = K; p.N = N; p.bk = bk; p.bn = bn; p.streams = streams; p.rows = rows;
  p.a_ld = a_ld; p.tiled = tiled;
  const dim3 grid(N / COLS);
  switch (form) {
    case V4: bd_kernel<V4><<<grid, THREADS, 0, st>>>(p); break;
    case DOT4: bd_kernel<DOT4><<<grid, THREADS, 0, st>>>(p); break;
    case CAST8: bd_kernel<CAST8><<<grid, THREADS, 0, st>>>(p); break;
    case NOSCALE: bd_kernel<NOSCALE><<<grid, THREADS, 0, st>>>(p); break;
    case MULTI: bd_kernel<MULTI><<<grid, THREADS, 0, st>>>(p); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
