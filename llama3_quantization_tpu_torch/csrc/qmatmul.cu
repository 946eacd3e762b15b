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
// hidden it is bound by the tensor cores, and in practice by what feeds
// them: the dequantization, which costs ALU work per weight element. The
// design is a warp-specialised 128x128x64 tiled GEMM. Eight producer
// warps keep a 4-stage ring of cp.async 16-byte copies of the x tile and
// the packed weight tile in flight (every packed byte fetched once, each
// row segment one coalesced run) and dequantize each weight tile into a
// bf16 B tile in shared memory (two codes at a time in bf16x2 arithmetic,
// with the TPU kernel's bf16 rounding points); eight MMA warps run ldmatrix
// + mma.sync m16n8k16 on the previous tile meanwhile, with fp32
// accumulation; named barriers hand the tiles over. The dequantization is
// the slower side on an H100 (with its pass removed the MMA warps alone
// finish a W4 gate/up at M = 128 in about 60% of the time), hence twice as
// many producer warps as a plain load warp would need. A K split,
// chosen from (K, N) alone, fills the card when N is small; its partials
// are summed in a fixed order. Not yet: TMA, wgmma.

#include "common.cuh"

namespace {

using l3q::bar_arrive;
using l3q::bar_sync;
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
// y = bf16(x) @ W with W = bf16((bf16(code) - bf16(zero)) * bf16(scale))
// (pallas_qmatmul.py:84-103), fp32 accumulation. A k tile is KT = 64 k rows
// in 8 runs of 8: the tile's byte rows in the packed layout (R = 64/F
// consecutive byte rows, each read once for all F bit fields; run r is field
// r / (R/8) of byte rows 8 * (r % (R/8)) ..), 64 byte rows of one code each,
// or one byte row of each of the three bit planes per run. A run lies inside
// one group, so each of its 8 x columns is contiguous in x and its scale and
// zero are one value per column. Needs K % 64 == 0, gs % (8 * F) == 0 (gs %
// 8 for bit planes) and N % 16 == 0.
// F: values per byte of the nibble layouts (4, 2, 1), or PLANES3 for the
// 3-bit bit planes [3, K/8, N].
constexpr int PLANES3 = 3;
constexpr int BM = 128, BN = 128, KT = 64, STAGES = 4;

template <int F>
__host__ __device__ constexpr int wrows() { return F == PLANES3 ? 24 : KT / F; }

template <int F>
constexpr size_t gemm_smem() {
  return (size_t)STAGES * (BM * KT * 2 + wrows<F>() * BN) + 2 * (size_t)BN * KT * 2;
}

// Run r (0..7) of consecutive k tiles: its first k row and its group. The
// run's first byte row (nibble layouts; for the others its first k row)
// moves by a fixed step per tile and its group by whole groups, so a
// cursor follows both without dividing.
template <int F>
struct RunCursor {
  int pos, g, step, span, field;  // span: rows per group; field: k offset of the bit field
  __device__ __forceinline__ void init(int kt, int r, int gs) {
    if (F == PLANES3 || F == 1) {
      pos = kt * KT + 8 * r, step = KT, span = gs, field = 0;
    } else {
      constexpr int RUNS = KT / F / 8;  // runs per bit field
      span = gs / F;
      pos = kt * (KT / F) + (r % RUNS) * 8, step = KT / F, field = (r / RUNS) * span;
    }
    g = pos / span;
  }
  __device__ __forceinline__ void next() {
    pos += step;
    while (pos >= (g + 1) * span) ++g;
  }
  __device__ __forceinline__ int k0(int gs) const {
    return (F == PLANES3 || F == 1) ? pos : g * gs + field + (pos - g * span);
  }
};

// Element offset of 16-byte chunk kc (8 k) of row n in a [128][64] bf16
// tile. The chunks are XOR-swizzled so that the dequant pass's stores (8
// lanes on rows 4 apart) and ldmatrix's reads (8 consecutive rows) each
// touch eight different bank groups.
__device__ __forceinline__ int swz_b(int n, int kc) { return n * KT + ((kc ^ ((n ^ (n >> 2)) & 7)) << 3); }
__device__ __forceinline__ int swz_a(int m, int kc) { return m * KT + ((kc ^ (m & 7)) << 3); }

__device__ __forceinline__ __nv_bfloat162 as_bf162(uint32_t v) {
  return *reinterpret_cast<__nv_bfloat162*>(&v);
}
__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// Two codes (k rows i and i+1 of one column) as an exact bf16 pair: the
// small codes through the bf16 pattern of 128 + code, less 128.
__device__ __forceinline__ __nv_bfloat162 small_codes(uint32_t lo_hi) {
  return __hsub2(as_bf162(lo_hi | 0x43004300u), as_bf162(0x43004300u));
}

// Named barriers between the two roles of a B2 block (0 is __syncthreads):
// FULL + b: B tile b is dequantized (and its x tile has landed); EMPTY + b:
// the MMA warps are done with B tile b (and its x tile's ring slot); PROD:
// the producer warps' copies of a tile have landed.
constexpr int BAR_FULL = 1, BAR_EMPTY = 3, BAR_PROD = 5;
constexpr int MMA_THREADS = 256, PROD_THREADS = 256;
constexpr int GEMM_THREADS = MMA_THREADS + PROD_THREADS;

// B2: grid (N/BN, M/BM, ksplit), 16 warps in two roles. Warps 8-15 produce:
// a 4-stage cp.async ring of x tiles [BM][KT] and packed weight tiles, and
// per k tile one pass that dequantizes the weight tile into a bf16 B tile
// [BN][KT] (double-buffered). Warps 0-7 consume: ldmatrix + mma.sync on the
// x tile and the B tile, warp tile 64 x 32 (4 x 4 mma tiles m16n8k16). So
// the dequant of tile j + 1 overlaps the MMAs of tile j.
template <int F, bool SIGNED>
__global__ void __launch_bounds__(GEMM_THREADS, 1) qmm_gemm_kernel(
    const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ data,
    const float* __restrict__ scale, const float* __restrict__ zero,
    float* __restrict__ part, void* __restrict__ out, int out_bf16, int M, int K, int N,
    int gs, int tiles_per_split) {
  constexpr bool PLANES = F == PLANES3;
  constexpr int WROWS = wrows<F>();
  constexpr int BITS = PLANES ? 3 : 8 / F;
  constexpr uint32_t MASK2 = ((1u << BITS) - 1u) * 0x10001u;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);    // [STAGES][BM*KT]
  uint8_t* Ws = smem + (size_t)STAGES * BM * KT * 2;               // [STAGES][WROWS*BN]
  __nv_bfloat16* Bs = reinterpret_cast<__nv_bfloat16*>(Ws + (size_t)STAGES * WROWS * BN);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int bm0 = blockIdx.y * BM, bn0 = blockIdx.x * BN;
  const int kt0 = blockIdx.z * tiles_per_split;
  const int nt = min(kt0 + tiles_per_split, K / KT) - kt0;

  if (tid >= MMA_THREADS) {  // ------------------------------ producers
    constexpr int UNITS = 256 / PROD_THREADS, PWARPS = PROD_THREADS / 32;
    const int ptid = tid - MMA_THREADS, pwarp = ptid >> 5;
    // the x tile: chunk kc = ptid % 8 (run kc) of rows ptid / 8 + (PROD_THREADS
    // / 8) i; the weight tile: 16-byte chunks of its byte rows. Tiles load in
    // order, so one cursor follows run kc.
    RunCursor<F> a_run;
    a_run.init(kt0, ptid & 7, gs);
    auto load_stage = [&](int kt, int slot) {
      __nv_bfloat16* A = As + (size_t)slot * BM * KT;
      const int kc = ptid & 7;
      const int k0 = a_run.k0(gs);
      a_run.next();
#pragma unroll
      for (int i = 0; i < BM * KT / 8 / PROD_THREADS; ++i) {
        const int row = (ptid >> 3) + PROD_THREADS / 8 * i;
        const bool ok = bm0 + row < M;
        l3q::cp_async16_zfill(A + swz_a(row, kc), x + (size_t)(ok ? bm0 + row : 0) * K + k0, ok);
      }
      uint8_t* W = Ws + (size_t)slot * WROWS * BN;
      for (int ch = ptid; ch < WROWS * BN / 16; ch += PROD_THREADS) {
        const int rw = ch / (BN / 16), n = bn0 + (ch % (BN / 16)) * 16;
        const size_t grow = PLANES ? (size_t)(rw >> 3) * (K / 8) + kt * 8 + (rw & 7)
                                   : (size_t)kt * WROWS + rw;
        const bool ok = n < N;
        l3q::cp_async16_zfill(W + rw * BN + (n - bn0), data + grow * N + (ok ? n : 0), ok);
      }
    };
    // dequant units: runs pwarp + PWARPS h, columns 4 * lane .. + 3; their
    // scales and zeros come one tile ahead into registers, tiles in order
    const int nl = 4 * lane;
    const bool n_ok = bn0 + nl < N;
    RunCursor<F> d_run[UNITS];
#pragma unroll
    for (int h = 0; h < UNITS; ++h) d_run[h].init(kt0, pwarp + PWARPS * h, gs);
    auto load_sz = [&](float4* s4, float4* z4) {
#pragma unroll
      for (int h = 0; h < UNITS; ++h) {
        const size_t g = d_run[h].g;
        d_run[h].next();
        if (!n_ok) continue;
        s4[h] = __ldg(reinterpret_cast<const float4*>(scale + g * N + bn0 + nl));
        z4[h] = __ldg(reinterpret_cast<const float4*>(zero + g * N + bn0 + nl));
      }
    };
    auto dequant_run = [&](const uint8_t* W, __nv_bfloat16* B, int r, const float4& s4,
                           const float4& z4) {
      uint32_t w[8];
      int shift = 0;
      if (PLANES) {
#pragma unroll
        for (int b = 0; b < 3; ++b) w[b] = *reinterpret_cast<const uint32_t*>(W + (b * 8 + r) * BN);
      } else {
        constexpr int RUNS = KT / F / 8;
        const int row0 = (r % RUNS) * 8;
        shift = (r / RUNS) * BITS;
#pragma unroll
        for (int i = 0; i < 8; ++i) w[i] = *reinterpret_cast<const uint32_t*>(W + (row0 + i) * BN);
      }
      const float sv[4] = {s4.x, s4.y, s4.z, s4.w}, zv[4] = {z4.x, z4.y, z4.z, z4.w};
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const __nv_bfloat162 z2 = __float2bfloat162_rn(zv[c]);
        const __nv_bfloat162 s2 = __float2bfloat162_rn(sv[c]);
        uint32_t o[4];
        uint32_t v = 0;
        if (PLANES)  // bytes [plane 0, plane 1, plane 2] of column c
          v = __byte_perm(__byte_perm(w[0], w[1], c | ((c + 4) << 4)), w[2],
                          0x10 | ((c + 4) << 8) | ((c + 4) << 12));
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          __nv_bfloat162 code2;
          if (PLANES) {  // code bit b of k row 8r + i: bit i of plane b's byte
            uint32_t a = (v >> (2 * q)) & 0x010101u, b = (v >> (2 * q + 1)) & 0x010101u;
            a = (a | (a >> 7) | (a >> 14)) & 7u;
            b = (b | (b >> 7) | (b >> 14)) & 7u;
            code2 = small_codes(a | (b << 16));
          } else if (F == 1) {
            const uint32_t b0 = (w[2 * q] >> (8 * c)) & 0xFFu;
            const uint32_t b1 = (w[2 * q + 1] >> (8 * c)) & 0xFFu;
            const float c0 = SIGNED ? (float)(int)(int8_t)b0 : (float)b0;
            const float c1 = SIGNED ? (float)(int)(int8_t)b1 : (float)b1;
            code2 = __floats2bfloat162_rn(c0, c1);
          } else {  // byte c of rows i, i+1 into the two halves, then field `shift`
            const uint32_t t = __byte_perm(w[2 * q], w[2 * q + 1],
                                           c | (c << 4) | ((c + 4) << 8) | ((c + 4) << 12));
            code2 = small_codes((t >> shift) & MASK2);
          }
          o[q] = as_u32(__hmul2(__hsub2(code2, z2), s2));
        }
        *reinterpret_cast<uint4*>(B + swz_b(nl + c, r)) = make_uint4(o[0], o[1], o[2], o[3]);
      }
    };

#pragma unroll
    for (int st = 0; st < STAGES - 2; ++st) {
      if (st < nt) load_stage(kt0 + st, st);
      l3q::cp_async_commit();
    }
    float4 s4[UNITS], z4[UNITS];
    if (nt > 0) load_sz(s4, z4);
    for (int j = 0; j < nt; ++j) {
      if (j >= 2) bar_sync(BAR_EMPTY + (j & 1), GEMM_THREADS);  // tile j - 2 consumed
      const int nk = j + STAGES - 2;  // into the ring slot of tile j - 2
      if (nk < nt) load_stage(kt0 + nk, nk % STAGES);
      l3q::cp_async_commit();
      l3q::cp_async_wait<STAGES - 2>();  // this thread's copies of tile j
      bar_sync(BAR_PROD, PROD_THREADS);  // everyone's
      float4 s_cur[UNITS], z_cur[UNITS];
#pragma unroll
      for (int h = 0; h < UNITS; ++h) s_cur[h] = s4[h], z_cur[h] = z4[h];
      if (j + 1 < nt) load_sz(s4, z4);
      if (n_ok) {
        const uint8_t* W = Ws + (size_t)(j % STAGES) * WROWS * BN + nl;
        __nv_bfloat16* B = Bs + (size_t)(j & 1) * BN * KT;
#pragma unroll
        for (int h = 0; h < UNITS; ++h) dequant_run(W, B, pwarp + PWARPS * h, s_cur[h], z_cur[h]);
      }
      bar_arrive(BAR_FULL + (j & 1), GEMM_THREADS);
    }
    return;
  }

  // ---------------------------------------------------------- MMA warps
  const int gid = lane >> 2, tig = lane & 3;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  // fragments of k step ks into buffer f: A 4 x m16k16, B 4 x n8k16
  uint32_t a[2][4][4], b[2][4][2];
  auto load_frags = [&](const __nv_bfloat16* A, const __nv_bfloat16* B, int ks, int f) {
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
      const int row = wm + mi * 16 + (lane & 15);
      l3q::ldmatrix_x4(a[f][mi], A + swz_a(row, 2 * ks + (lane >> 4)));
    }
#pragma unroll
    for (int nj = 0; nj < 2; ++nj) {
      const int n = wn + nj * 16 + (lane & 7) + ((lane >> 4) << 3);
      uint32_t r4[4];
      l3q::ldmatrix_x4(r4, B + swz_b(n, 2 * ks + ((lane >> 3) & 1)));
      b[f][2 * nj][0] = r4[0];
      b[f][2 * nj][1] = r4[1];
      b[f][2 * nj + 1][0] = r4[2];
      b[f][2 * nj + 1][1] = r4[3];
    }
  };
  for (int it = 0; it < nt; ++it) {
    bar_sync(BAR_FULL + (it & 1), GEMM_THREADS);
    const __nv_bfloat16* A = As + (size_t)(it % STAGES) * BM * KT;
    const __nv_bfloat16* B = Bs + (size_t)(it & 1) * BN * KT;
    load_frags(A, B, 0, 0);
#pragma unroll
    for (int ks = 0; ks < KT / 16; ++ks) {  // the next step's loads go out before these MMAs
      if (ks + 1 < KT / 16) load_frags(A, B, ks + 1, (ks + 1) & 1);
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) l3q::mma_bf16_16816(acc[mi][ni], a[ks & 1][mi], b[ks & 1][ni]);
    }
    if (it + 2 < nt) bar_arrive(BAR_EMPTY + (it & 1), GEMM_THREADS);
  }

#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = bm0 + wm + mi * 16 + gid + h * 8;
        const int col = bn0 + wn + ni * 8 + tig * 2;
        if (row >= M || col >= N) continue;
        const float v0 = acc[mi][ni][2 * h], v1 = acc[mi][ni][2 * h + 1];
        if (gridDim.z > 1) {
          *reinterpret_cast<float2*>(part + ((size_t)blockIdx.z * M + row) * N + col) =
              make_float2(v0, v1);
        } else if (out_bf16) {
          *reinterpret_cast<__nv_bfloat162*>(reinterpret_cast<__nv_bfloat16*>(out) +
                                             (size_t)row * N + col) = __floats2bfloat162_rn(v0, v1);
        } else {
          *reinterpret_cast<float2*>(reinterpret_cast<float*>(out) + (size_t)row * N + col) =
              make_float2(v0, v1);
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
  if (K % KT || N % 16 || gs % (F == PLANES3 ? 8 : 8 * F)) return (int)cudaErrorInvalidValue;
  const size_t smem = gemm_smem<F>();
  cudaError_t err = cudaFuncSetAttribute(
      qmm_gemm_kernel<F, SIGNED>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles = K / KT;
  const int per_split = (tiles + ksplit - 1) / ksplit;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, ksplit);
  qmm_gemm_kernel<F, SIGNED><<<grid, GEMM_THREADS, smem, st>>>(
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

// B2: needs K % 64 == 0, N % 16 == 0, gs % (8 * f) == 0 (gs % 8 for the
// planes) and 16-byte aligned x, codes, scale and zero; ksplit blocks along
// K. f as for B1, or 3 for the 3-bit bit planes [3, K/8, N].
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
