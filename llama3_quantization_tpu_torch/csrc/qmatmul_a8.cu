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
// not depend on timing or on the split. At M > 64 (prefills) it does
// 2*M*K*N int8 operations on K*N/f code bytes: at M = 128 the int8 tensor
// cores (1,979 TOP/s) and the bytes (3.35 TB/s) bound it alike, and in
// practice what feeds the tensor cores does, and with group scales the
// fp32 group term: 4-5 fp32 operations per output per group, as many as
// the MMA's share of the work at gs = 128. The first tiled form lost to
// byte loads (each packed byte fetched once per bit field) and no overlap.
// This one is warp-specialised: a copy warp keeps a 4-slot ring of TMA
// boxes (the activation tile in wgmma's 128-byte swizzle, the packed code
// rows of a stage, every byte fetched once) and bulk copies (the scales,
// zeros and activation sums of the groups that end in the stage) in
// flight on mbarriers; 7 unpack warps turn each code stage into a
// k-contiguous s8 B tile, every bit field of a 32-bit word at once (four
// codes per op) and 8 byte rows x 4 columns byte-transposed per unit; two
// consumer warpgroups run wgmma m64nNk32 s8 with s32 accumulators in
// registers, taking turns at the tensor cores so that one's fp32 group
// term runs while the other's MMAs do. The activation sums are formed once
// per (row, group) by a small pre-pass, not in every N tile. Tiles are
// 128x128, or 64x64 where 128x128 tiles would leave most of the 132 SMs
// idle (the wrapper picks from M and N alone). No K split: each output's
// groups are summed in order in one block, so the result is the plain
// version's bit for bit and does not depend on M or on timing.

#include <type_traits>

#include "common.cuh"

namespace {

using l3q::bar_arrive;
using l3q::bar_sync;
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
// A stage is `rows` consecutive byte rows of the codes, every bit field of
// each byte taken from one copy: F * rows k values (32, 64 or 128), the
// stage's slots. With L = min(rows, gs / F), one bit field of one group's
// byte rows in the stage is a run of L slots; byte row i, field s sits in
// slot (i / L) * F * L + s * L + i % L. So each group's slots are
// contiguous (a k step of 32 lies in one group) and each run holds L
// consecutive k of x (the activation copies stay contiguous). Slot tiles
// have 128-byte rows: A [BM][KS] s8 activations, B [BN][KS] s8 codes,
// k-contiguous per column, both in wgmma's 128-byte swizzle.
constexpr int KS = 128, RING = 4;
constexpr int MMA_THREADS = 256, PROD_THREADS = 224, HANDOFF = MMA_THREADS + PROD_THREADS;
constexpr int GEMM_THREADS = HANDOFF + 32;  // the last warp copies
constexpr int XS_GROUPS = KS / 32;  // groups that can end inside one stage

// Named barriers (0 is __syncthreads): FULL + s: slot s's B tile is
// unpacked; PROD: the unpack warps' cp.async copies of a stage have landed
// (only where a stage is not one TMA box of x); TURN + w: consumer
// warpgroup w may start its MMAs. mbarriers: `bars` (a slot's copies have
// landed) and `empty` (the consumers are done with a slot).
constexpr int BAR_FULL = 1, BAR_PROD = 1 + RING, BAR_TURN = 2 + RING;

// Byte offset of 16-byte chunk c of row r in a slot tile: chunk c ^ (r % 8),
// the 128-byte swizzle that TMA writes and wgmma reads.
__device__ __forceinline__ int swz(int r, int c) { return r * KS + ((c ^ (r & 7)) << 4); }
// Stage t's first group g and the offset j of its first byte row in g.
struct Stage {
  int g, j;
  __device__ __forceinline__ Stage(int t, int rows, int sub) {
    g = t * rows / sub;
    j = t * rows - g * sub;
  }
};

// D (s32 [64, 128] over the warpgroup) += A * B: both K-major s8 tiles in
// shared memory with the 128-byte swizzle, given by descriptors.
__device__ __forceinline__ void wgmma_s8_n128(int* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// D (s32 [64, 32] over the warpgroup) += A * B: both K-major s8 tiles in
// shared memory with the 128-byte swizzle, given by descriptors.
__device__ __forceinline__ void wgmma_s8_n32(int* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
      : "l"(da), "l"(db), "r"(1));
}

// Pins the order of accumulator accesses against the asynchronous wgmma.
template <int N>
__device__ __forceinline__ void fence_regs(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// grid (M tiles, N tiles): the M tiles of one weight tile run side by side,
// so its codes are read from HBM once. 16 warps: 0-7 two consumer
// warpgroups (a 64 x BN output tile each at BM = 128, 64 x BN/2 at BM =
// 64), 8-14 unpack, 15 copies (see the note at the head of the file).
// setmaxnreg moves registers from warps 8-15 (56) to the consumers (200),
// which hold an s32 dot and an fp32 sum per output.
template <int C, int BM, int BN>
__global__ void __launch_bounds__(GEMM_THREADS, 1) a8_gemm_kernel(
    const int8_t* __restrict__ xq, const uint8_t* __restrict__ data,
    const float* __restrict__ scale, const void* __restrict__ zero, int zmode,
    const float* __restrict__ sx, const int* __restrict__ xsg, int mpad, void* __restrict__ out,
    int out_bf16, int M, int K, int N, int gs, int rows, const __grid_constant__ CUtensorMap tmx,
    const __grid_constant__ CUtensorMap tmw) {
  constexpr int F = PackOf<C>::F;
  constexpr int WGN = BM == 128 ? BN : BN / 2, NACC = WGN / 2;
  constexpr int SZ = XS_GROUPS * 2 * BN;  // floats of scales and zeros per ring slot
  extern __shared__ __align__(1024) unsigned char smem[];
  // per ring slot: A [BM * KS], B [BN * KS], codes [KS / F * BN], scales
  // and fp32 zeros [XS_GROUPS][2][BN], activation sums [XS_GROUPS][BM],
  // int8 zeros [XS_GROUPS][BN]; then the mbarriers
  int8_t* As = reinterpret_cast<int8_t*>(smem);
  int8_t* Bs = As + RING * BM * KS;
  uint8_t* Ws = reinterpret_cast<uint8_t*>(Bs + RING * BN * KS);
  float* szs = reinterpret_cast<float*>(Ws + RING * (KS / F) * BN);
  int* xs_buf = reinterpret_cast<int*>(szs + RING * SZ);
  int8_t* zraw = reinterpret_cast<int8_t*>(xs_buf + RING * XS_GROUPS * BM);
  uint64_t* bars = reinterpret_cast<uint64_t*>(zraw + RING * XS_GROUPS * BN);  // copies landed
  uint64_t* empty = bars + RING;  // the consumer warps are done with the slot

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int bm0 = blockIdx.x * BM, bn0 = blockIdx.y * BN;
  const int sub = gs / F, L = min(rows, sub), FL = F * L, ngs = F * rows / FL;
  const int nt = K / F / rows;
  const bool want_xs = zmode != 0 || C == U8;
  // a stage of 128 consecutive k (f * rows = 128, each group's runs whole)
  // comes by one TMA box of x, else by cp.async runs
  const bool tma_x = F * rows == KS && (F == 1 || rows >= sub);
  // Below 2^22 in magnitude (every group of gs <= 128, u8's added 128 * xsum
  // and an int8 zero's xsum * z included) an s32 dot started at the bit
  // pattern of 1.5 * 2^23 reads as that float plus the dot: one exact fp32
  // subtraction in place of a quarter-rate int-to-float conversion. With an
  // int8 zero, f32(dot) - f32(xsum) * z is then exact and equals
  // f32(dot - xsum * z): one integer multiply-add in place of two roundings.
  const bool magic = gs <= 128, iz = magic && zmode == 2 && C != U8;

  if (tid == 0) {
    for (int i = 0; i < RING; ++i) {
      l3q::mbar_init(bars + i, 1);
      l3q::mbar_init(empty + i, MMA_THREADS / 32);
    }
  }
  __syncthreads();

  if (tid >= MMA_THREADS) asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n" ::: "memory");
  if (tid >= HANDOFF) {  // ------------------------------------ copy warp
    // TMA boxes of x and the codes, bulk copies of the scales and zeros of
    // the groups that end in a stage, RING stages ahead of the consumers
    if (lane == 0) {
      const int ncol = min(BN, N - bn0);  // a multiple of 16
      const int zb = zmode == 1 ? 4 * ncol : zmode == 2 ? ncol : 0;
      for (int t = 0; t < nt; ++t) {
        const int slot = t % RING;
        const Stage st(t, rows, sub);
        int ends = 0;
        for (int gi = 0; gi < ngs; ++gi) ends += (st.j + (gi + 1) * L) % sub == 0;
        if (t >= RING) l3q::mbar_wait(empty + slot, (t / RING - 1) & 1);
        l3q::mbar_expect_tx(bars + slot, (tma_x ? BM * KS : 0) + rows * BN +
                                             ends * (4 * ncol + zb + (want_xs ? 4 * BM : 0)));
        if (tma_x) l3q::tma_load_2d(As + slot * BM * KS, &tmx, t * KS, bm0, bars + slot);
        l3q::tma_load_2d(Ws + slot * (KS / F) * BN, &tmw, bn0, t * rows, bars + slot);
        for (int gi = 0; gi < ngs; ++gi) {
          if ((st.j + (gi + 1) * L) % sub) continue;
          const size_t g0 = (size_t)(st.g + gi) * N + bn0;
          float* sz = szs + slot * SZ + gi * 2 * BN;
          l3q::bulk_load(sz, scale + g0, 4 * ncol, bars + slot);
          if (want_xs)
            l3q::bulk_load(xs_buf + (slot * XS_GROUPS + gi) * BM,
                           xsg + (size_t)(st.g + gi) * mpad + bm0, 4 * BM, bars + slot);
          if (zmode == 1)
            l3q::bulk_load(sz + BN, reinterpret_cast<const float*>(zero) + g0, 4 * ncol, bars + slot);
          else if (zmode == 2)
            l3q::bulk_load(zraw + (slot * XS_GROUPS + gi) * BN,
                           reinterpret_cast<const int8_t*>(zero) + g0, ncol, bars + slot);
        }
      }
    }
    return;
  }

  if (tid >= MMA_THREADS) {  // ----------------------------- unpack warps
    const int ptid = tid - MMA_THREADS;
    // activation copies where a stage is not 128 consecutive k: U bytes
    // inside one run; this thread copies unit `au` (slots au * U ..) of
    // rows ar, ar + PROD_THREADS / upr, ...
    const int U = (L % 16) ? 8 : 16, upr = F * rows / U;
    const int au = ptid % upr, ar = ptid / upr, p = au * U;
    const int arun = p / L, agi = arun / F, aoff = (arun - agi * F) * sub + (p - arun * L);
    auto load_x = [&](int t) {
      const int slot = t % RING;
      if (t >= RING) l3q::mbar_wait(empty + slot, (t / RING - 1) & 1);
      const Stage st(t, rows, sub);
      int8_t* A = As + slot * BM * KS;
      const int k = (st.g + agi) * gs + st.j + aoff;
      for (int r = ar; r < BM; r += PROD_THREADS / upr) {
        const bool ok = bm0 + r < M;
        const int8_t* src = xq + (size_t)(ok ? bm0 + r : 0) * K + k;
        int8_t* dst = A + swz(r, p >> 4) + (p & 15);
        if (U == 16) l3q::cp_async16_zfill(dst, src, ok);
        else l3q::cp_async8_zfill(dst, src, ok);
      }
    };
    // 8 byte rows x 4 columns per unit, neighbouring lanes on neighbouring
    // column quads of the dense code stage. Each lane rotates its quad's
    // columns by (lane / 2) % 4 so that 8 neighbouring lanes store to 8
    // different chunks of the swizzled B tile.
    const int rot = (lane >> 1) & 3;
    const uint32_t rsel = 0x3210u >> (4 * rot) | 0x3210u << (16 - 4 * rot);
    auto unpack = [&](const uint8_t* W, int8_t* B) {
      const int units = rows / 8 * (BN / 4);
      for (int u = ptid; u < units; u += PROD_THREADS) {
        const int i0 = u / (BN / 4) * 8, c0 = (u % (BN / 4)) * 4;
        uint32_t w[8];
#pragma unroll
        for (int t = 0; t < 8; ++t)
          w[t] = __byte_perm(*reinterpret_cast<const uint32_t*>(W + (i0 + t) * BN + c0), 0, rsel);
        const int gi = i0 / L, j = i0 - gi * L;
#pragma unroll
        for (int s = 0; s < F; ++s) {
          const int slot = gi * FL + s * L + j;
          uint32_t v[4], lo[4], hi[4];
#pragma unroll
          for (int t = 0; t < 4; ++t) v[t] = field4<C>(w[t], s);
          transpose4(v, lo);
#pragma unroll
          for (int t = 0; t < 4; ++t) v[t] = field4<C>(w[4 + t], s);
          transpose4(v, hi);
#pragma unroll
          for (int q = 0; q < 4; ++q)  // lo[q] is column c0 + (q + rot) % 4
            *reinterpret_cast<uint2*>(B + swz(c0 + ((q + rot) & 3), slot >> 4) + (slot & 15)) =
                make_uint2(lo[q], hi[q]);
        }
      }
    };
    // the x copies (cp.async form) run DIST stages ahead of the unpack
    constexpr int DIST = RING - 2;
    if (!tma_x) {
#pragma unroll
      for (int t = 0; t < DIST; ++t) {
        if (t < nt) load_x(t);
        l3q::cp_async_commit();
      }
    }
    for (int j = 0; j < nt; ++j) {
      const int slot = j % RING;
      if (!tma_x) l3q::cp_async_wait<DIST - 1>();  // this thread's x copies of stage j
      l3q::mbar_wait(bars + slot, (j / RING) & 1);  // the copy warp's
      if (!tma_x) bar_sync(BAR_PROD, PROD_THREADS);  // everyone's
      if (!(L3Q_ABLATE & 1)) unpack(Ws + slot * (KS / F) * BN, Bs + slot * BN * KS);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // for wgmma's reads
      bar_arrive(BAR_FULL + slot, HANDOFF);
      if (!tma_x) {
        if (j + DIST < nt) load_x(j + DIST);
        l3q::cp_async_commit();
      }
    }
    return;
  }

  // ------------------------------------------------ consumer warpgroups
  asm volatile("setmaxnreg.inc.sync.aligned.u32 200;\n" ::: "memory");
  const int wg = warp >> 2, gid = lane >> 2, tig = lane & 3;
  const int row0 = BM == 128 ? 64 * wg : 0, col0 = BM == 128 ? 0 : wg * WGN;
  const int ra = row0 + 16 * (warp & 3) + gid;  // this thread's rows ra, ra + 8
  const int dinit = magic ? 0x4B400000 : 0;
  int dot[NACC];
  float acc[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) {
    dot[i] = dinit;
    acc[i] = 0.f;
  }
  // acc += (f32(dot) - f32(xsum) * z) * s, one rounding per operation;
  // accumulator 4 j + 2 h + e: row ra + 8 h, column col0 + 8 j + 2 tig + e
  auto epilogue = [&](const int* xs, const float* sz, const int8_t* z8, auto magic_c, auto iz_c) {
    constexpr bool MAGIC = decltype(magic_c)::value, IZ = decltype(iz_c)::value;
    int xi[2] = {0, 0};
    if (want_xs) xi[0] = xs[ra], xi[1] = xs[ra + 8];
    const float xf[2] = {(float)xi[0], (float)xi[1]};
#pragma unroll
    for (int j = 0; j < WGN / 8; ++j) {
      const int c = col0 + 8 * j + 2 * tig;
      const float2 s2 = *reinterpret_cast<const float2*>(sz + c);
      const char2 zc = zmode == 2 ? *reinterpret_cast<const char2*>(z8 + c) : make_char2(0, 0);
      const int2 zi2 = make_int2(zc.x, zc.y);
      const float2 z2 = zmode == 1 ? *reinterpret_cast<const float2*>(sz + BN + c)
                                   : make_float2((float)zi2.x, (float)zi2.y);
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          int& d = dot[4 * j + 2 * h + e];
          float t;
          if constexpr (IZ) {
            t = __fsub_rn(__int_as_float(d - xi[h] * (e ? zi2.y : zi2.x)), 12582912.f);
          } else {
            const int dv = C == U8 ? d + 128 * xi[h] : d;  // back to the promoted dot
            t = MAGIC ? __fsub_rn(__int_as_float(dv), 12582912.f) : __int2float_rn(dv);
            if (zmode != 0) t = __fsub_rn(t, __fmul_rn(xf[h], e ? z2.y : z2.x));
          }
          float& a = acc[4 * j + 2 * h + e];
          a = __fadd_rn(a, __fmul_rn(t, e ? s2.y : s2.x));
          d = dinit;
        }
    }
  };

  if (wg == 1) bar_arrive(BAR_TURN, MMA_THREADS);  // warpgroup 0 goes first
  for (int it = 0; it < nt; ++it) {
    const Stage st(it, rows, sub);
    const int slot = it % RING;
    bar_sync(BAR_FULL + slot, HANDOFF);
    const int8_t* A = As + slot * BM * KS + row0 * KS;
    const int8_t* B = Bs + slot * BN * KS + col0 * KS;
    for (int gi = 0; gi < ngs; ++gi) {  // the groups (or part of one) in the stage
      bar_sync(BAR_TURN + wg, MMA_THREADS);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
      fence_regs(dot);
      if constexpr (!(L3Q_ABLATE & 4))
      for (int ks = gi * FL / 32; ks < (gi + 1) * FL / 32; ++ks) {
        // K-major, 128-byte swizzle: k steps move 32 bytes along the row,
        // 8-row groups lie 1024 bytes apart (the leading offset is unused)
        const uint64_t da = l3q::wgmma_desc(A + 32 * ks, 16, 1024);
        const uint64_t db = l3q::wgmma_desc(B + 32 * ks, 16, 1024);
        if constexpr (WGN == 128) wgmma_s8_n128(dot, da, db);
        else wgmma_s8_n32(dot, da, db);
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      bar_arrive(BAR_TURN + (wg ^ 1), MMA_THREADS);
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      fence_regs(dot);
      if (!(L3Q_ABLATE & 2) && (st.j + (gi + 1) * L) % sub == 0) {
        const int* xs = xs_buf + (slot * XS_GROUPS + gi) * BM;
        const float* sz = szs + slot * SZ + gi * 2 * BN;
        const int8_t* z8 = zraw + (slot * XS_GROUPS + gi) * BN;
        if (iz) epilogue(xs, sz, z8, std::true_type(), std::true_type());
        else if (magic) epilogue(xs, sz, z8, std::true_type(), std::false_type());
        else epilogue(xs, sz, z8, std::false_type(), std::false_type());
      }
    }
    if (lane == 0) l3q::mbar_arrive(empty + slot);
  }
  if (wg == 0) bar_sync(BAR_TURN, MMA_THREADS);  // warpgroup 1's last turn

#pragma unroll
  for (int j = 0; j < WGN / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = bm0 + ra + 8 * h, col = bn0 + col0 + 8 * j + 2 * tig;
      if (row >= M || col >= N) continue;
      const float s = sx[row];
      const float v0 = __fmul_rn(acc[4 * j + 2 * h], s), v1 = __fmul_rn(acc[4 * j + 2 * h + 1], s);
      const size_t o = (size_t)row * N + col;
      if (out_bf16) {
        *reinterpret_cast<__nv_bfloat162*>(reinterpret_cast<__nv_bfloat16*>(out) + o) =
            __floats2bfloat162_rn(v0, v1);
      } else {
        *reinterpret_cast<float2*>(reinterpret_cast<float*>(out) + o) = make_float2(v0, v1);
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

// A 2-D u8 tensor map of rows x cols (row pitch `pitch` bytes), boxes of
// box_rows x box_cols.
int tensor_map_u8(CUtensorMap* map, const void* base, int rows, int cols, int pitch, int box_rows,
                  int box_cols, CUtensorMapSwizzle swizzle) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows}, strides[1] = {(cuuint64_t)pitch};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  return l3q::encode_tensor_map(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, base, dims, strides, box,
                                swizzle);
}

template <int C, int BM, int BN>
int launch_gemm_tile(const void* xq, const void* data, const void* scale, const void* zero,
                     int zmode, const void* sx, const void* xsg, int mpad, void* out, int out_bf16,
                     int M, int K, int N, int gs, int rows, cudaStream_t st) {
  constexpr int F = PackOf<C>::F;
  const size_t smem = (size_t)RING * BM * KS + (size_t)RING * BN * KS + (size_t)RING * (KS / F) * BN +
                      (size_t)RING * XS_GROUPS * 2 * BN * sizeof(float) +
                      (size_t)RING * XS_GROUPS * BM * sizeof(int) + (size_t)RING * XS_GROUPS * BN +
                      2 * RING * sizeof(uint64_t);
  CUtensorMap tmx{}, tmw{};
  // x boxes of BM rows x 128 k (128-byte swizzle, wgmma's layout), only
  // where a stage is 128 consecutive k; code boxes of `rows` byte rows x BN
  // (dense). Rows and columns past the matrix come as zeros.
  int err = 0;
  if (F * rows == KS && (F == 1 || rows >= gs / F))
    err = tensor_map_u8(&tmx, xq, M, K, K, BM, KS, CU_TENSOR_MAP_SWIZZLE_128B);
  if (!err) err = tensor_map_u8(&tmw, data, K / F, N, N, rows, BN, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err) return err;
  err = (int)cudaFuncSetAttribute(a8_gemm_kernel<C, BM, BN>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err) return err;
  dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  a8_gemm_kernel<C, BM, BN><<<grid, GEMM_THREADS, smem, st>>>(
      (const int8_t*)xq, (const uint8_t*)data, (const float*)scale, zero, zmode,
      (const float*)sx, (const int*)xsg, mpad, out, out_bf16, M, K, N, gs, rows, tmx, tmw);
  return (int)cudaGetLastError();
}

// The tiled form's activation sums, s32 [G, mpad] (rows past M read 0):
// what every tile of a row needs, formed once. One warp per (group, row).
__global__ void __launch_bounds__(256) a8_xsum_kernel(const int8_t* __restrict__ xq,
                                                      int* __restrict__ xsg, int M, int K, int gs,
                                                      int mpad) {
  const int w = (blockIdx.x * 256 + threadIdx.x) >> 5, lane = threadIdx.x & 31;
  if (w >= K / gs * mpad) return;
  const int g = w / mpad, m = w - g * mpad;
  int v = 0;
  if (m < M) {
    const int4* p = reinterpret_cast<const int4*>(xq + (size_t)m * K + (size_t)g * gs);
    for (int c = lane; c < gs / 16; c += 32) {
      const int4 x = __ldg(p + c);
      v = __dp4a(x.x, 0x01010101, __dp4a(x.y, 0x01010101, __dp4a(x.z, 0x01010101,
                                                                __dp4a(x.w, 0x01010101, v))));
    }
  }
  v = __reduce_add_sync(0xffffffffu, v);
  if (lane == 0) xsg[w] = v;
}

template <int C>
int launch_gemm(const void* xq, const void* data, const void* scale, const void* zero, int zmode,
                const void* sx, void* xsg, void* out, int out_bf16, int M, int K, int N, int gs,
                int tile, int rows, cudaStream_t st) {
  constexpr int F = PackOf<C>::F;
  const int sub = gs / F;
  const bool runs = rows <= sub ? sub % rows == 0 : rows % sub == 0 && (K / F) % rows == 0;
  const int kv = F * rows;  // k values per stage: 32, 64 or 128
  if (K % gs || gs % 32 || N % 16 || rows % 8 || (kv != 32 && kv != 64 && kv != KS) ||
      (K / F) % rows || !runs)
    return (int)cudaErrorInvalidValue;
  const int mpad = (M + 127) / 128 * 128;
  if (zmode != 0 || C == U8) {
    if (!xsg) return (int)cudaErrorInvalidValue;
    const long threads = 32L * (K / gs) * mpad;
    a8_xsum_kernel<<<(unsigned)((threads + 255) / 256), 256, 0, st>>>(
        (const int8_t*)xq, (int*)xsg, M, K, gs, mpad);
    const int err = (int)cudaGetLastError();
    if (err) return err;
  }
  if (tile == 128)
    return launch_gemm_tile<C, 128, 128>(xq, data, scale, zero, zmode, sx, xsg, mpad, out,
                                         out_bf16, M, K, N, gs, rows, st);
  if (tile == 64)
    return launch_gemm_tile<C, 64, 64>(xq, data, scale, zero, zmode, sx, xsg, mpad, out,
                                       out_bf16, M, K, N, gs, rows, st);
  return (int)cudaErrorInvalidValue;
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

// Tiled form: `tile` 128 (128x128 output tiles) or 64 (64x64); stages of
// `rows` byte rows (f * rows = 32, 64 or 128, rows a multiple of 8,
// dividing gs / f or a multiple of it that divides K / f). xsg: int32
// scratch [K / gs, ceil(M / 128) * 128] for the activation sums, needed
// with a zero point or u8 codes (else null). Needs gs % 32 == 0,
// N % 16 == 0 and 16-byte aligned codes and activations.
extern "C" int l3q_a8_gemm(const void* xq, const void* data, const void* scale, const void* zero,
                           int zmode, const void* sx, void* xsg, void* out, int out_bf16, int M,
                           int K, int N, int gs, int code, int tile, int rows, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
#define L3Q_GEMM(CODE) \
  launch_gemm<CODE>(xq, data, scale, zero, zmode, sx, xsg, out, out_bf16, M, K, N, gs, tile, rows, st)
  if (code == S8) return L3Q_GEMM(S8);
  if (code == U4) return L3Q_GEMM(U4);
  if (code == S4) return L3Q_GEMM(S4);
  if (code == U2) return L3Q_GEMM(U2);
  if (code == U8) return L3Q_GEMM(U8);
#undef L3Q_GEMM
  return (int)cudaErrorInvalidValue;
}
