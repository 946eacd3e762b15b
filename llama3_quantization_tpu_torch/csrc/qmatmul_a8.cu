// W·A8 integer matmul on low-bit weights: kernel B3.
//
// Replaces the TPU kernel `_qmm_v3_kernel` in
// llama3_quantization_tpu/ops/pallas_qmatmul.py, and serves the two other
// JAX functions that compute the same integers outside any Pallas kernel:
// `s4w_matmul` (ops/s4_matmul.py, the s4 backend) and `a8_matmul`
// (ops/a8_matmul.py, the a8 backend). All three take activations already
// quantized per token to s8 (xq [M, K], scale s_x [M, 1]) and compute
//
//   y[m, n] = s_x[m] * sum_g s[g, n] * (dot[m, g, n] - xsum[m, g] * z[g, n])
//
// with dot = sum_k xq[m, k] * code[k, n] and xsum = sum_k xq[m, k] over the
// k of group g, both exact in s32, and the epilogue in fp32 with one
// rounding per operation, summed over g = 0, 1, ... in order. z is an fp32
// zero point [G, N] (v3, a8), an int8 one (the s4 backend's centered
// `zero8`), or absent.
//
// Code layouts (`code`): S8 = one int8 per byte [K, N] (a8's containers and
// unpacked v3 weights); U4 / U2 = the packed unsigned 4/2-bit codes of
// quant/pack.py [K/f, N]; S4 = the s4 backend's storage, signed 4-bit codes
// (code - 2^(bits-1), two's complement) two per byte in that same
// group-local layout: byte row j of group g holds rows g*gs + j (low
// nibble) and g*gs + gs/2 + j (high nibble). A centered code with
// z8 = z - 2^(bits-1) gives the same integer dot - xsum*z8 as the unsigned
// code with z, so the forms agree exactly. U8 = unpacked unsigned 8-bit
// codes [K, N] (what `quantize_rtn(bits=8, pack=True)` stores): each byte
// enters the s8 dot as c ^ 0x80 = c - 128, and 128 * xsum is added back to
// the s32 dot before the epilogue, so the dot is the exact promoted one of
// JAX's `a8_matmul`.
//
// What bounds it on the H100. At M <= 64 (every decode and serving step)
// it is a GEMV bound by the weight bytes over HBM (3.35 TB/s): the GEMV
// form keeps B1's load pattern (16 adjacent columns per thread, one 16-byte
// load per byte row, a warp per `rc` byte rows inside one group), unpacks
// nibbles with per-byte SIMD, byte-transposes four rows so that four
// consecutive k of one column form one word, and runs `__dp4a` against the
// s8 activation word. Each block sums its warps' s32 partials per group
// segment in shared memory and writes them out; a second pass adds the
// segments of each group (integers: any order is exact), applies the fp32
// epilogue group by group in order and scales by s_x, so the result does
// not depend on timing or on the split. At M > 64 (prefills) it is bound by
// the int8 tensor cores: the tiled form is a shared-memory GEMM of 64x64
// tiles over k tiles of 32 inside one group (4 warps, mma.sync m16n8k32 s8
// with s32 accumulation), with the group epilogue applied in registers at
// each group's last k tile. No TMA, wgmma or pipelining yet.

#include "common.cuh"

namespace {

using l3q::mma_s8_16832;
using l3q::store_out;
using l3q::transpose4;

enum Code { S8 = 0, U4 = 1, S4 = 2, U2 = 3, U8 = 4 };

template <int C>
struct PackOf {
  static constexpr int F = (C == S8 || C == U8) ? 1 : (C == U2 ? 4 : 2);
};

// Field s of four packed bytes, each byte a code in the int8 range.
template <int C>
__device__ __forceinline__ uint32_t field4(uint32_t w, int s) {
  if (C == S8) return w;
  if (C == U8) return w ^ 0x80808080u;  // c - 128 as s8, per byte
  if (C == U2) return (w >> (2 * s)) & 0x03030303u;
  uint32_t v = (w >> (4 * s)) & 0x0F0F0F0Fu;
  if (C == S4) v = __vsub4(v ^ 0x08080808u, 0x08080808u);  // sign-extend each nibble
  return v;
}

// Field s of one byte as an int8 code.
template <int C>
__device__ __forceinline__ uint32_t field1(uint32_t b, int s) {
  return field4<C>(b, s) & 0xFFu;
}

// The group epilogue term (dot - xsum * z) * s, one rounding per operation.
__device__ __forceinline__ float group_term(int dot, int xs, const float* scale,
                                            const void* zero, int zmode, size_t gi) {
  float t = (float)dot;
  if (zmode == 1) {
    t = __fsub_rn(t, __fmul_rn((float)xs, reinterpret_cast<const float*>(zero)[gi]));
  } else if (zmode == 2) {
    t = __fsub_rn(t, __fmul_rn((float)xs, (float)reinterpret_cast<const int8_t*>(zero)[gi]));
  }
  return __fmul_rn(t, scale[gi]);
}

// ------------------------------------------------------------ GEMV form ----
constexpr int GEMV_THREADS = 256;
constexpr int GEMV_WARPS = GEMV_THREADS / 32;
constexpr int GEMV_COLS = 512;  // 32 lanes x 16 columns

// Stage 1: s32 partial dots and activation sums per group segment.
// part [chunks, M, N], xpart [chunks, M]; block y covers byte rows
// [y * 8 * rc, (y + 1) * 8 * rc), cut into segments of `seg` rows (a whole
// group when the group is shorter), chunk = y * (8 * rc / seg) + segment.
template <int C, int MT>
__global__ void __launch_bounds__(GEMV_THREADS) a8_gemv_kernel(
    const int8_t* __restrict__ xq, const uint8_t* __restrict__ data, int* __restrict__ part,
    int* __restrict__ xpart, int M, int K, int N, int gs, int rc, int seg) {
  constexpr int F = PackOf<C>::F;
  extern __shared__ int red[];  // [GEMV_WARPS][MT][GEMV_COLS], then xred [GEMV_WARPS][MT]
  int* xred = red + GEMV_WARPS * MT * GEMV_COLS;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c0 = blockIdx.x * GEMV_COLS + lane * 16;
  const int m0 = blockIdx.z * MT;
  const int rows = K / F, sub = gs / F;
  const int r0 = (blockIdx.y * GEMV_WARPS + warp) * rc;
  int dot[MT][16], xs[MT];
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    xs[m] = 0;
#pragma unroll
    for (int c = 0; c < 16; ++c) dot[m][c] = 0;
  }

  if (r0 < rows) {
    const int g = r0 / sub, j0 = r0 - g * sub;
    const int8_t* xrow[MT];
#pragma unroll
    for (int m = 0; m < MT; ++m) xrow[m] = xq + (size_t)min(m0 + m, M - 1) * K;
    const uint8_t* wp = data + (size_t)r0 * N + c0;
    for (int q = 0; q < rc; q += 4) {
      uint32_t w[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const uint4 v = c0 < N ? __ldg(reinterpret_cast<const uint4*>(wp + (size_t)(q + r) * N))
                               : make_uint4(0, 0, 0, 0);
        w[r][0] = v.x; w[r][1] = v.y; w[r][2] = v.z; w[r][3] = v.w;
      }
#pragma unroll
      for (int s = 0; s < F; ++s) {
        const int k = g * gs + s * sub + j0 + q;
        int xw[MT];
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          xw[m] = __ldg(reinterpret_cast<const int*>(xrow[m] + k));
          xs[m] = __dp4a(xw[m], 0x01010101, xs[m]);
        }
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          const uint32_t rw[4] = {field4<C>(w[0][h], s), field4<C>(w[1][h], s),
                                  field4<C>(w[2][h], s), field4<C>(w[3][h], s)};
          uint32_t cw[4];
          transpose4(rw, cw);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int m = 0; m < MT; ++m) dot[m][4 * h + i] = __dp4a((int)cw[i], xw[m], dot[m][4 * h + i]);
        }
      }
    }
  }
  if (C == U8) {  // back to the promoted dot: sum (c - 128) x + 128 sum x
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int c = 0; c < 16; ++c) dot[m][c] += 128 * xs[m];
  }

#pragma unroll
  for (int m = 0; m < MT; ++m) {
#pragma unroll
    for (int c = 0; c < 16; ++c) red[(warp * MT + m) * GEMV_COLS + c * 32 + lane] = dot[m][c];
    if (lane == 0) xred[warp * MT + m] = xs[m];
  }
  __syncthreads();
  const int nseg = GEMV_WARPS * rc / seg, wps = seg / rc;
  for (int e = threadIdx.x; e < nseg * MT * GEMV_COLS; e += GEMV_THREADS) {
    const int sidx = e / (MT * GEMV_COLS), rem = e - sidx * MT * GEMV_COLS;
    const int m = rem / GEMV_COLS, cl = rem - m * GEMV_COLS;  // cl = c * 32 + lane
    const int row = m0 + m, col = blockIdx.x * GEMV_COLS + (cl & 31) * 16 + (cl >> 5);
    if (row >= M || col >= N) continue;
    int v = 0;
    for (int w = sidx * wps; w < (sidx + 1) * wps; ++w) v += red[(w * MT + m) * GEMV_COLS + cl];
    part[((size_t)(blockIdx.y * nseg + sidx) * M + row) * N + col] = v;
  }
  if (blockIdx.x == 0 && threadIdx.x < nseg * MT) {
    const int sidx = threadIdx.x / MT, m = threadIdx.x - sidx * MT, row = m0 + m;
    if (row < M) {
      int v = 0;
      for (int w = sidx * wps; w < (sidx + 1) * wps; ++w) v += xred[w * MT + m];
      xpart[(blockIdx.y * nseg + sidx) * M + row] = v;
    }
  }
}

// Stage 2: per output element, the segments of each group summed in s32
// (integers: any order is exact), the fp32 group terms added in group
// order, times s_x. Two schedules of that one function, chosen by the
// number of groups G:
//
// G >= EPI_WARPS (grouped weights: 32 or 112 groups of one or two
// segments): one block per (row m, 32 adjacent columns). Groups go in
// passes of EPI_GROUPS: the 8 warps share the pass's (group, segment)
// partials and add them into shared s32 sums, then form the group terms
// side by side, and warp 0 adds them in order; so a pass's loads are in
// flight together, where one thread per output would wait on each group.
//
// G < EPI_WARPS (per-column weights: one group of up to 32 segments): one
// thread per output element, which keeps every warp busy.
constexpr int EPI_THREADS = 256;
constexpr int EPI_WARPS = EPI_THREADS / 32;
constexpr int EPI_GROUPS = 64;

__global__ void __launch_bounds__(EPI_THREADS) a8_epilogue_rows_kernel(
    const int* __restrict__ part, const int* __restrict__ xpart, const float* __restrict__ scale,
    const void* __restrict__ zero, int zmode, const float* __restrict__ sx,
    void* __restrict__ out, int out_bf16, int M, int N, int G, int cpg) {
  const int i = blockIdx.x * EPI_THREADS + threadIdx.x;
  if (i >= M * N) return;
  const int m = i / N, n = i - m * N;
  const size_t mn = (size_t)M * N;
  float v = 0.f;
  for (int g = 0; g < G; ++g) {
    int dot = 0, xs = 0;
#pragma unroll 4
    for (int c = g * cpg; c < (g + 1) * cpg; ++c) {
      dot += part[(size_t)c * mn + i];
      xs += xpart[c * M + m];
    }
    v = __fadd_rn(v, group_term(dot, xs, scale, zero, zmode, (size_t)g * N + n));
  }
  store_out(out, i, __fmul_rn(v, sx[m]), out_bf16);
}

__global__ void __launch_bounds__(EPI_THREADS) a8_epilogue_kernel(
    const int* __restrict__ part, const int* __restrict__ xpart, const float* __restrict__ scale,
    const void* __restrict__ zero, int zmode, const float* __restrict__ sx,
    void* __restrict__ out, int out_bf16, int M, int N, int G, int cpg) {
  __shared__ int sdot[EPI_GROUPS][32];
  __shared__ int sxs[EPI_GROUPS];
  __shared__ float terms[EPI_GROUPS][32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int m = blockIdx.y, n = blockIdx.x * 32 + lane;
  const bool n_ok = n < N;
  const size_t mn = (size_t)M * N, row = (size_t)m * N + n;
  float v = 0.f;
  for (int g0 = 0; g0 < G; g0 += EPI_GROUPS) {
    const int gn = min(EPI_GROUPS, G - g0);
    for (int e = threadIdx.x; e < gn * 32; e += EPI_THREADS) sdot[e >> 5][e & 31] = 0;
    if (threadIdx.x < gn) sxs[threadIdx.x] = 0;
    __syncthreads();
#pragma unroll 4
    for (int u = warp; u < gn * cpg; u += EPI_WARPS) {
      const int j = u / cpg, c = g0 * cpg + u;
      if (n_ok) atomicAdd(&sdot[j][lane], part[(size_t)c * mn + row]);
      if (lane == 0) atomicAdd(&sxs[j], xpart[c * M + m]);
    }
    __syncthreads();
    for (int j = warp; j < gn; j += EPI_WARPS)
      terms[j][lane] = n_ok ? group_term(sdot[j][lane], sxs[j], scale, zero, zmode,
                                         (size_t)(g0 + j) * N + n)
                            : 0.f;
    __syncthreads();
    if (warp == 0)
      for (int j = 0; j < gn; ++j) v = __fadd_rn(v, terms[j][lane]);
    __syncthreads();
  }
  if (warp == 0 && n_ok) store_out(out, row, __fmul_rn(v, sx[m]), out_bf16);
}

// ----------------------------------------------------------- tiled form ----
constexpr int TBM = 64, TBN = 64, TBK = 32, TLDS = 48;  // TLDS in bytes: 12 words, no bank conflicts
constexpr int GEMM_THREADS = 128;

// Needs K % 32 == 0 and gs % 32 == 0, so that a k tile lies inside one group.
template <int C>
__global__ void __launch_bounds__(GEMM_THREADS) a8_gemm_kernel(
    const int8_t* __restrict__ xq, const uint8_t* __restrict__ data,
    const float* __restrict__ scale, const void* __restrict__ zero, int zmode,
    const float* __restrict__ sx, void* __restrict__ out, int out_bf16, int M, int K, int N,
    int gs) {
  constexpr int F = PackOf<C>::F;
  __shared__ __align__(16) int8_t As[TBM][TLDS];
  __shared__ __align__(16) int8_t Bs[TBN][TLDS];
  __shared__ int xsum[TBM];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const int bm0 = blockIdx.y * TBM, bn0 = blockIdx.x * TBN;
  const int sub = gs / F;
  // weight ownership: column nl, k rows kh * 16 .. kh * 16 + 15 of each tile
  const int nl = tid & (TBN - 1), kh = tid / TBN;
  const int n = bn0 + nl;
  const bool n_ok = n < N;

  int dot[2][4][4];
  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        dot[i][j][r] = 0;
        acc[i][j][r] = 0.f;
      }
  if (tid < TBM) xsum[tid] = 0;

  const int tiles = K / TBK, per_group = gs / TBK;
  for (int kt = 0; kt < tiles; ++kt) {
    const int k0 = kt * TBK, g = k0 / gs;
    {  // activations: 64 rows x 32 bytes, 16 bytes per thread
      const int row = tid >> 1, col = (tid & 1) * 16;
      const uint4 a = bm0 + row < M
          ? __ldg(reinterpret_cast<const uint4*>(xq + (size_t)(bm0 + row) * K + k0 + col))
          : make_uint4(0, 0, 0, 0);
      *reinterpret_cast<uint4*>(&As[row][col]) = a;
    }
    uint32_t words[4];
#pragma unroll
    for (int e4 = 0; e4 < 4; ++e4) {
      uint32_t word = 0;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int k = k0 + kh * 16 + e4 * 4 + b;
        const int r = k - g * gs;
        const int s = F == 1 ? 0 : r / sub;
        const size_t byte_row = F == 1 ? (size_t)k : (size_t)g * sub + (r - s * sub);
        const uint32_t byte = n_ok ? __ldg(data + byte_row * N + n) : 0u;
        word |= field1<C>(byte, s) << (8 * b);
      }
      words[e4] = word;
    }
    *reinterpret_cast<uint4*>(&Bs[nl][kh * 16]) = make_uint4(words[0], words[1], words[2], words[3]);
    __syncthreads();
    if (tid < TBM) {
      int v = xsum[tid];
#pragma unroll
      for (int w = 0; w < TBK / 4; ++w) v = __dp4a(*reinterpret_cast<const int*>(&As[tid][4 * w]), 0x01010101, v);
      xsum[tid] = v;
    }
    uint32_t a[2][4], b[4][2];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const int r = wm + mi * 16 + gid;
      a[mi][0] = *reinterpret_cast<const uint32_t*>(&As[r][tig * 4]);
      a[mi][1] = *reinterpret_cast<const uint32_t*>(&As[r + 8][tig * 4]);
      a[mi][2] = *reinterpret_cast<const uint32_t*>(&As[r][16 + tig * 4]);
      a[mi][3] = *reinterpret_cast<const uint32_t*>(&As[r + 8][16 + tig * 4]);
    }
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int nn = wn + ni * 8 + gid;
      b[ni][0] = *reinterpret_cast<const uint32_t*>(&Bs[nn][tig * 4]);
      b[ni][1] = *reinterpret_cast<const uint32_t*>(&Bs[nn][16 + tig * 4]);
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) mma_s8_16832(dot[mi][ni], a[mi], b[ni]);
    __syncthreads();
    if ((kt + 1) % per_group == 0) {
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int xs = xsum[wm + mi * 16 + gid + h * 8];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int col = min(bn0 + wn + ni * 8 + tig * 2 + e, N - 1);
              float& v = acc[mi][ni][2 * h + e];
              const int d = dot[mi][ni][2 * h + e] + (C == U8 ? 128 * xs : 0);
              v = __fadd_rn(v, group_term(d, xs, scale, zero, zmode, (size_t)g * N + col));
              dot[mi][ni][2 * h + e] = 0;
            }
          }
      __syncthreads();
      if (tid < TBM) xsum[tid] = 0;
    }
  }

#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = bm0 + wm + mi * 16 + gid + h * 8;
        if (row >= M) continue;
        const float s = sx[row];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = bn0 + wn + ni * 8 + tig * 2 + e;
          if (col < N) store_out(out, (size_t)row * N + col, __fmul_rn(acc[mi][ni][2 * h + e], s), out_bf16);
        }
      }
}

template <int C, int MT>
int launch_gemv(const void* xq, const void* data, void* part, void* xpart, int M, int K, int N,
                int gs, int rc, int seg, int ysplit, cudaStream_t st) {
  const size_t smem = (size_t)GEMV_WARPS * MT * (GEMV_COLS + 1) * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(a8_gemv_kernel<C, MT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((N + GEMV_COLS - 1) / GEMV_COLS, ysplit, (M + MT - 1) / MT);
  a8_gemv_kernel<C, MT><<<grid, GEMV_THREADS, smem, st>>>(
      (const int8_t*)xq, (const uint8_t*)data, (int*)part, (int*)xpart, M, K, N, gs, rc, seg);
  return (int)cudaGetLastError();
}

template <int C>
int launch_gemv_mt(const void* xq, const void* data, void* part, void* xpart, int M, int K,
                   int N, int gs, int rc, int seg, int ysplit, int mt, cudaStream_t st) {
  if (mt == 1) return launch_gemv<C, 1>(xq, data, part, xpart, M, K, N, gs, rc, seg, ysplit, st);
  if (mt == 2) return launch_gemv<C, 2>(xq, data, part, xpart, M, K, N, gs, rc, seg, ysplit, st);
  return launch_gemv<C, 4>(xq, data, part, xpart, M, K, N, gs, rc, seg, ysplit, st);
}

template <int C>
int launch_gemm(const void* xq, const void* data, const void* scale, const void* zero, int zmode,
                const void* sx, void* out, int out_bf16, int M, int K, int N, int gs,
                cudaStream_t st) {
  dim3 grid((N + TBN - 1) / TBN, (M + TBM - 1) / TBM);
  a8_gemm_kernel<C><<<grid, GEMM_THREADS, 0, st>>>(
      (const int8_t*)xq, (const uint8_t*)data, (const float*)scale, zero, zmode,
      (const float*)sx, out, out_bf16, M, K, N, gs);
  return (int)cudaGetLastError();
}

}  // namespace

// code: 0 = int8 containers, 1 = packed unsigned 4-bit, 2 = signed 4-bit
// (s4 storage), 3 = packed unsigned 2-bit, 4 = unpacked unsigned 8-bit. zmode: 0 = no zero point, 1 =
// fp32 zero [G, N], 2 = int8 zero [G, N]. GEMV form: `rc` byte rows per
// warp (a multiple of 4), segments of `seg` byte rows (seg = min(gs/f,
// 8*rc)), ysplit = ceil(K/f / (8*rc)) blocks along K, mt rows per block (1,
// 2 or 4); part int32 [ysplit * 8*rc/seg, M, N] and xpart int32
// [ysplit * 8*rc/seg, M] scratch. Needs N % 16 == 0, K % 4 == 0 and
// (gs/f) % 4 == 0.
extern "C" int l3q_a8_gemv(const void* xq, const void* data, void* part, void* xpart,
                           const void* scale, const void* zero, int zmode, const void* sx,
                           void* out, int out_bf16, int M, int K, int N, int gs, int code, int rc,
                           int seg, int ysplit, int mt, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  int err;
  if (code == S8) err = launch_gemv_mt<S8>(xq, data, part, xpart, M, K, N, gs, rc, seg, ysplit, mt, st);
  else if (code == U4) err = launch_gemv_mt<U4>(xq, data, part, xpart, M, K, N, gs, rc, seg, ysplit, mt, st);
  else if (code == S4) err = launch_gemv_mt<S4>(xq, data, part, xpart, M, K, N, gs, rc, seg, ysplit, mt, st);
  else if (code == U2) err = launch_gemv_mt<U2>(xq, data, part, xpart, M, K, N, gs, rc, seg, ysplit, mt, st);
  else if (code == U8) err = launch_gemv_mt<U8>(xq, data, part, xpart, M, K, N, gs, rc, seg, ysplit, mt, st);
  else return (int)cudaErrorInvalidValue;
  if (err != 0) return err;
  const int f = (code == S8 || code == U8) ? 1 : (code == U2 ? 4 : 2);
  const int G = K / gs, cpg = (gs / f) / seg;
  if (G < EPI_WARPS) {
    a8_epilogue_rows_kernel<<<(M * N + EPI_THREADS - 1) / EPI_THREADS, EPI_THREADS, 0, st>>>(
        (const int*)part, (const int*)xpart, (const float*)scale, zero, zmode, (const float*)sx,
        out, out_bf16, M, N, G, cpg);
  } else {
    a8_epilogue_kernel<<<dim3((N + 31) / 32, M), EPI_THREADS, 0, st>>>(
        (const int*)part, (const int*)xpart, (const float*)scale, zero, zmode, (const float*)sx,
        out, out_bf16, M, N, G, cpg);
  }
  return (int)cudaGetLastError();
}

// Tiled form: needs K % 32 == 0 and gs % 32 == 0.
extern "C" int l3q_a8_gemm(const void* xq, const void* data, const void* scale, const void* zero,
                           int zmode, const void* sx, void* out, int out_bf16, int M, int K, int N,
                           int gs, int code, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (code == S8) return launch_gemm<S8>(xq, data, scale, zero, zmode, sx, out, out_bf16, M, K, N, gs, st);
  if (code == U4) return launch_gemm<U4>(xq, data, scale, zero, zmode, sx, out, out_bf16, M, K, N, gs, st);
  if (code == S4) return launch_gemm<S4>(xq, data, scale, zero, zmode, sx, out, out_bf16, M, K, N, gs, st);
  if (code == U2) return launch_gemm<U2>(xq, data, scale, zero, zmode, sx, out, out_bf16, M, K, N, gs, st);
  if (code == U8) return launch_gemm<U8>(xq, data, scale, zero, zmode, sx, out, out_bf16, M, K, N, gs, st);
  return (int)cudaErrorInvalidValue;
}
