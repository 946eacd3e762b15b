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
// B1 at M <= 64 is a GEMV bound by the HBM bytes of its weights (K*N/f
// codes plus 8 bytes of scale/zero per group column, at 3.35 TB/s): at
// M = 64 it does 2*64 operations per code, still under the bf16 tensor
// cores' share of that time. So each packed byte is read from HBM once per
// call at every M, and the dot runs on the tensor cores: mma.sync
// m16n8k16 bf16 -> fp32 with the codes as the 16-row operand (16 output
// columns) and the activation rows, padded to 8, 16, 32 or 64, as the
// 8-column operand, so M = 8 fills one n8 tile. Codes become exact bf16
// through bf16(128 + code) - 128 (two per instruction); a second MMA with
// an all-ones A forms the x sums in the same fragment layout. A fresh fp32
// dot per group gets its term dot*s - xsum*(z*s) in registers when the
// group ends. Each block streams its units of byte rows through a ring of
// stages (every packed byte copied once: a TMA box of code rows a round,
// bulk copies of the groups' scales and zeros, cp.async copies of the x
// values the rows meet), its depth and stage size set so that the grid's
// blocks fit the SMs in one wave. A K split, chosen from (K, N, gs, f)
// alone, fills the card when N is small: the split blocks form one
// thread-block cluster and add their sums in rank order through
// distributed shared memory inside the launch. Measured (PERF.md): at
// M = 8 the stream runs ahead of the parent's CUDA-core form and of
// torch.matmul; at M = 1 the tensor-core path (an x-sum MMA beside each
// dot MMA, the code unpack) keeps the SMs busier than the stream needs.
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

#include <algorithm>

#include "common.cuh"

namespace {

using l3q::bar_arrive;
using l3q::bar_sync;
using l3q::as_bf162;
using l3q::as_u32;
using l3q::store_out;

// ---------------------------------------------------------------- B1 ----
// y[m, n] = sum_g s[g,n] * (x_g . c_g[:, n]) - (sum_k x_g[k]) * z[g,n]*s[g,n]
// with x rounded to bf16 and the dots and x sums in fp32
// (pallas_qmatmul.py:214-233), by mma.sync m16n8k16 with the weights as
// the 16-row operand: D[n][m] = sum_k W[k][n] x[m][k].
//
// A unit is L byte rows of one group (L = 16, or 8 where a group's bit field
// has 8 rows), L * f k values, L consecutive k per bit field. Its k16 steps
// take field (16 q + i) / L, row (16 q + i) % L for MMA k index i, so the
// MMA's k pairs (2t, 2t + 1) are two adjacent byte rows of one field, whose
// x values are adjacent in x: ldmatrix.trans hands each lane exactly those
// bytes of its two columns. Grid (ceil(N / bn), ksplit): block (i, q) owns
// columns [i bn, (i + 1) bn) and split q's units; its 8 warps are bn / 16
// column warps (16 columns, one m16 tile: lane group g holds columns 2g and
// 2g + 1) times kw = 128 / bn warp rows along K. A round is kw runs of uw
// units of one group, run r to warp row r, so each warp row walks its runs
// in order, keeps one fp32 dot and x sum per group and adds the group's term
// dot*s - xsum*(z*s) after its last run of that group. The warp rows' sums
// are added in order in shared memory, the splits' (one thread-block
// cluster) in rank order through distributed shared memory. Every order
// follows the plan (bn, ksplit, uw: from K, N, gs, f alone), so a row's
// result does not depend on M or on the other rows. The ring's stages
// (rounds per stage, depth) follow M and the grid; each copies its units'
// byte rows (one swizzled TMA box a round, read by ldmatrix.trans), the x
// values they meet (real rows only: a pad row's outputs are dropped, and
// the MMA keeps the rows apart) and the scales and zeros of its groups.
constexpr int GEMV_THREADS = 256;
constexpr int GEMV_WARPS = GEMV_THREADS / 32;
constexpr uint32_t BF16_ONES = 0x3F803F80u;

// Column c's codes of field f in an ldmatrix.trans word [b(r, c0), b(r, c1),
// b(r + 1, c0), b(r + 1, c1)] as an exact bf16 pair (row r low): packed
// codes through bf16 128 + code less 128, one-byte codes through fp32.
template <int F, bool SIGNED>
__device__ __forceinline__ uint32_t codes2(uint32_t w, int f, int c) {
  if (L3Q_ABLATE & 64) return w;
  if (F == 1) {
    const uint32_t b0 = w >> (8 * c), b1 = w >> (8 * c + 16);
    const float lo = SIGNED ? (float)(int8_t)b0 : (float)(b0 & 0xFFu);
    const float hi = SIGNED ? (float)(int8_t)b1 : (float)(b1 & 0xFFu);
    return l3q::pack_bf16x2(lo, hi);
  } else {
    constexpr int BITS = 8 / F;
    constexpr uint32_t MASK2 = ((1u << BITS) - 1u) * 0x00010001u;
    const uint32_t v = ((w >> (8 * c + f * BITS)) & MASK2) | 0x43004300u;
    return as_u32(__hsub2(as_bf162(v), as_bf162(0x43004300u)));
  }
}

template <int F, bool SIGNED, int L, int MT>
__global__ void __launch_bounds__(GEMV_THREADS) qmm_gemv_kernel(
    const __nv_bfloat16* __restrict__ x, const float* __restrict__ scale,
    const float* __restrict__ zero, void* __restrict__ out, int out_bf16, int M, int K, int N,
    int gs, int bn, int uw, int rounds, int ring, const __grid_constant__ CUtensorMap tmw) {
  constexpr int UK = L * F, KQ = UK / 16, MP = 8 * MT;
  extern __shared__ __align__(1024) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, t = lane & 3;
  const l3q::Div ncd(bn / 16);
  const int nc = ncd.d, kw = GEMV_WARPS / nc;
  const int cw = warp & (nc - 1), kwi = warp >> ncd.sh;
  const l3q::Div ug(gs / F / L), subd(gs / F);  // units, byte rows per group
  const int runs = K / UK / uw, ks = gridDim.y, q = blockIdx.y;
  const int u0 = (int)((long)q * runs / ks) * uw, u1 = (int)((long)(q + 1) * runs / ks) * uw;
  const int ru = kw * uw, us = ru * rounds;  // units per round, per stage
  const int nst = (u1 - u0 + us - 1) / us;
  const int ngs = us / ug.d + 2;  // groups one stage can touch
  const int xsb = l3q::odd_row(us * UK * 2);
  const int wbytes = us * L * bn, xbytes = MP * xsb, sbytes = ngs * bn * 4;
  const int stage_bytes = (wbytes + xbytes + 2 * sbytes + 1023) / 1024 * 1024;
  const int col0 = blockIdx.x * bn, ncol = min(bn, N - col0);
  const int cl = cw * 16 + 2 * gid;  // this lane's first column in the tile
  uint64_t* full = reinterpret_cast<uint64_t*>(
      smem + max(ring * stage_bytes, kw * MP * bn * (int)sizeof(float)));

  // stage s (units u0 + s us ..) into ring slot `slot`: by warp 0 on the
  // slot's mbarrier the units' byte rows of the tile (one TMA box a round,
  // swizzled) and the scales and zeros of the stage's groups (bulk copies);
  // by every thread (cp.async) the x values of the units' k, real rows
  // only, field by field, 8 k of one group per copy
  auto load_stage = [&](int s, int slot) {
    unsigned char* W = smem + (size_t)slot * stage_bytes;
    unsigned char* X = W + wbytes;
    float* S = reinterpret_cast<float*>(X + xbytes);
    float* Z = S + ngs * bn;
    const int ua = u0 + s * us, nu = min(us, u1 - ua), nr = (nu + ru - 1) / ru;
    if (warp == 0) {
      const int gf = ug(ua), ng = ug(ua + nu - 1) - gf + 1;
      if (lane == 0) l3q::mbar_expect_tx(full + slot, nr * ru * L * bn + 2 * ng * ncol * 4);
      __syncwarp();
      if (lane < nr)
        l3q::tma_load_2d(W + lane * ru * L * bn, &tmw, col0, (ua + lane * ru) * L, full + slot);
      for (int i = lane; i < 2 * ng; i += 32) {
        const int gi = i >> 1;
        l3q::bulk_load((i & 1 ? Z : S) + gi * bn,
                       (i & 1 ? zero : scale) + (size_t)(gf + gi) * N + col0, ncol * 4, full + slot);
      }
    }
    const int cr = nu * L / 8;  // copies per (row, field)
    const l3q::Div crd(cr);
    for (int i = tid; i < M * F * cr; i += GEMV_THREADS) {
      const int mf = crd(i), c = i - mf * cr, m = mf / F, f = mf - m * F;
      const int row = ua * L + 8 * c, g = subd(row);
      l3q::cp_async16(X + m * xsb + (f * us * L + 8 * c) * 2,
                      x + (size_t)m * K + g * gs + f * subd.d + row - g * subd.d);
    }
  };

  float acc[MT][4], dot[MT][4], xs[MT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = dot[i][e] = xs[i][e] = 0.f;
  // D fragment e: column cl + e / 2, row 2t + e % 2 (and its x sum)
  auto apply = [&](const float* sp, const float* zp) {
    const float2 sv = *reinterpret_cast<const float2*>(sp);
    const float2 zv = *reinterpret_cast<const float2*>(zp);
    const float zs0 = zv.x * sv.x, zs1 = zv.y * sv.y;
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[i][e] += dot[i][e] * (e < 2 ? sv.x : sv.y) - xs[i][e] * (e < 2 ? zs0 : zs1);
        dot[i][e] = xs[i][e] = 0.f;
      }
  };

  // A unit's fragments: the codes' row pairs (ldmatrix.trans) and x for
  // each k16 pair and row tile; loaded one unit ahead of its MMAs.
  struct Frag {
    uint32_t p[2], b[(KQ + 1) / 2][MT][4];
  };
  auto fetch = [&](const unsigned char* W, const unsigned char* X, int lu, Frag& fr) {
    const unsigned char* wr = W + l3q::swz_off(lu * L + (lane & 15), cw * 16, bn);
    if (L == 16) {
      l3q::ldmatrix_x2_trans(fr.p, wr);
    } else {
      l3q::ldmatrix_x1_trans(fr.p, wr);
      fr.p[1] = fr.p[0];
    }
    // matrix j of k16 steps kp, kp + 1: MMA k 8j.. of the pair, field
    // (16 kp + 8j) / L at row (16 kp + 8j) % L of the unit (field-major x)
    const unsigned char* xr = X + (lane & 7) * xsb + lu * L * 2;
#pragma unroll
    for (int kp = 0; kp < KQ; kp += 2) {
      const int e = 16 * kp + 8 * (lane >> 3);
      const unsigned char* xp = xr + ((e / L) * us * L + e % L) * 2;
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        if (KQ == 1) {
          l3q::ldmatrix_x2(fr.b[kp / 2][i], xp + i * 8 * xsb);
        } else {
          l3q::ldmatrix_x4(fr.b[kp / 2][i], xp + i * 8 * xsb);
        }
      }
    }
  };
  auto mma_unit = [&](const Frag& fr) {
    const uint32_t ones[4] = {BF16_ONES, BF16_ONES, BF16_ONES, BF16_ONES};
#pragma unroll
    for (int kp = 0; kp < KQ; kp += 2) {
      uint32_t a[2][4];
#pragma unroll
      for (int h = 0; h < 2 && kp + h < KQ; ++h) {
        const int kq = kp + h, fa = L == 16 ? kq : 2 * kq, fb = L == 16 ? kq : 2 * kq + 1;
        a[h][0] = codes2<F, SIGNED>(fr.p[0], fa, 0), a[h][1] = codes2<F, SIGNED>(fr.p[0], fa, 1);
        a[h][2] = codes2<F, SIGNED>(fr.p[1], fb, 0), a[h][3] = codes2<F, SIGNED>(fr.p[1], fb, 1);
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int h = 0; h < 2 && kp + h < KQ; ++h) {
          const uint32_t* b = fr.b[kp / 2][i] + 2 * h;
          if (L3Q_ABLATE & 128) {
            dot[i][0] += __uint_as_float((a[h][0] ^ a[h][1] ^ a[h][2] ^ a[h][3] ^ b[0] ^ b[1]) & 0x3FFFFFu);
          } else {
            l3q::mma_bf16_16816(dot[i], a[h], b);
            l3q::mma_bf16_16816(xs[i], ones, b);
          }
        }
    }
  };
  // the units of one run, each unit's fragments fetched while the one
  // before runs its MMAs
  auto run = [&](const unsigned char* W, const unsigned char* X, int lr) {
    if (L3Q_ABLATE & 256) return;
    Frag f0, f1;
    fetch(W, X, lr, f0);
    for (int v = 0; v < uw; v += 2) {
      if (v + 1 < uw) fetch(W, X, lr + v + 1, f1);
      mma_unit(f0);
      if (v + 1 < uw) {
        if (v + 2 < uw) fetch(W, X, lr + v + 2, f0);
        mma_unit(f1);
      }
    }
  };

  auto compute = [&](int s, int slot) {
    const unsigned char* W = smem + (size_t)slot * stage_bytes;
    const unsigned char* X = W + wbytes;
    const float* S = reinterpret_cast<const float*>(X + xbytes);
    const float* Z = S + ngs * bn;
    const int ua = u0 + s * us, nu = min(us, u1 - ua), gf = ug(ua);
    for (int j = 0; j < rounds; ++j) {
      const int lr = j * ru + kwi * uw;  // this warp row's run in round j
      if (lr >= nu) break;
      run(W, X, lr);
      // the group's term after this warp row's last run of it
      const int a = ua + lr, g = ug(a);
      if (a + ru >= u1 || ug(a + ru) != g) apply(S + (g - gf) * bn + cl, Z + (g - gf) * bn + cl);
    }
  };

  if (tid == 0)
    for (int i = 0; i < ring; ++i) l3q::mbar_init(full + i, 1);
  __syncthreads();
  for (int s = 0; s < ring - 1; ++s) {
    if (s < nst) load_stage(s, s);
    l3q::cp_async_commit();
  }
  for (int s = 0; s < nst; ++s) {
    l3q::cp_async_wait_upto<5>(ring - 2);  // this thread's x copies of stage s
    __syncthreads();  // everyone's; and slot (s - 1) % ring is free
    if (s + ring - 1 < nst) load_stage(s + ring - 1, (s + ring - 1) % ring);
    l3q::cp_async_commit();
    l3q::mbar_wait(full + s % ring, (s / ring) & 1);  // its codes, scales and zeros
    compute(s, s % ring);
  }
  l3q::cp_async_wait<0>();
  __syncthreads();

  // the warp rows' sums in order, then the splits' in rank order
  float* red = reinterpret_cast<float*>(smem);  // [kw][MP][bn]
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      red[(kwi * MP + 8 * i + 2 * t + (e & 1)) * bn + cl + (e >> 1)] = acc[i][e];
  __syncthreads();
  for (int i = tid; i < M * bn; i += GEMV_THREADS) {
    float v = red[i];
    for (int w = 1; w < kw; ++w) v += red[w * MP * bn + i];
    const int m = i / bn, col = col0 + i - m * bn;
    if (ks == 1) {
      if (col < N) store_out(out, (size_t)m * N + col, v, out_bf16);
    } else {
      red[i] = v;
    }
  }
  if (ks == 1) return;
  l3q::cluster_sync();
  const int lo = (int)((long)q * M * bn / ks), hi = (int)((long)(q + 1) * M * bn / ks);
  for (int i = lo + tid; i < hi; i += GEMV_THREADS) {
    uint32_t p[8];  // every rank's partial in flight, then added in rank order
#pragma unroll
    for (int r = 0; r < 8; ++r)
      if (r < ks) p[r] = l3q::ld_cluster_u32(red + i, r);
    float v = 0.f;
#pragma unroll
    for (int r = 0; r < 8; ++r)
      if (r < ks) v += __uint_as_float(p[r]);
    const int m = i / bn, col = col0 + i - m * bn;
    if (col < N) store_out(out, (size_t)m * N + col, v, out_bf16);
  }
  l3q::cluster_sync();  // no block leaves while the others read its shared memory
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

// Rounds per stage and ring depth of a B1 launch. The stage size does not
// change the order of any sum (warp rows walk their runs in order), so it
// follows M and the grid (`l3q::pick_stages`): stages of up to 32 KB of
// codes and 32 KB of x.
template <int F, bool SIGNED, int L, int MT>
int launch_gemv(const void* x, const void* data, const void* scale, const void* zero, void* out,
                int M, int K, int N, int gs, int out_bf16, int bn, int ksplit, int uw,
                cudaStream_t st) {
  constexpr int UK = L * F, MP = 8 * MT;
  auto kernel = qmm_gemv_kernel<F, SIGNED, L, MT>;
  const int kw = GEMV_WARPS * 16 / bn, ru = kw * uw, ug = gs / UK;
  const int split_units = K / UK / uw / ksplit * uw;
  auto stage = [&](int R) {  // (bytes of a ring slot, code bytes of a stage)
    const int us = ru * R;
    const size_t b = (size_t)us * L * bn + (size_t)MP * l3q::odd_row(us * UK * 2) +
                     2 * (size_t)(us / ug + 2) * bn * 4;
    return std::make_pair((b + 1023) / 1024 * 1024, (size_t)us * L * bn);
  };
  auto fits = [&](int R) {
    const int us = ru * R;
    return R == 1 || (us <= split_units && (size_t)us * L * bn <= 32768 &&
                      (size_t)MP * l3q::odd_row(us * UK * 2) <= 32768);
  };
  const long blocks = (long)(N + bn - 1) / bn * ksplit;
  const size_t red = (size_t)kw * MP * bn * 4;
  static const int per_sm = l3q::regs_blocks(kernel, GEMV_THREADS);
  l3q::GemvStages sg = l3q::pick_stages(stage, fits, [](int) { return (size_t)64; },
                                        l3q::gemv_budget(per_sm, blocks, ksplit));
  sg.smem = std::max(sg.smem - 64, red) + 64;  // the warp rows' sums reuse the ring
  CUtensorMap tmw{};  // the codes [K / f, N] in boxes of one round's rows x bn
  int e = l3q::tensor_map_u8(&tmw, data, K / F, N, N, ru * L, bn, l3q::row_swizzle(bn));
  if (e) return e;
  e = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sg.smem);
  if (e) return e;
  e = l3q::launch_clustered(kernel, dim3((N + bn - 1) / bn, ksplit), GEMV_THREADS, sg.smem,
                            ksplit, st, (const __nv_bfloat16*)x, (const float*)scale,
                            (const float*)zero, out, out_bf16, M, K, N, gs, bn, uw, sg.rounds,
                            sg.ring, tmw);
  return e ? e : (int)cudaGetLastError();
}

template <int F, bool SIGNED, int L>
int launch_gemv_mt(const void* x, const void* data, const void* scale, const void* zero,
                   void* out, int M, int K, int N, int gs, int out_bf16, int bn, int ksplit,
                   int uw, cudaStream_t st) {
#define L3Q_GEMV(MT) \
  launch_gemv<F, SIGNED, L, MT>(x, data, scale, zero, out, M, K, N, gs, out_bf16, bn, ksplit, uw, st)
  if (M <= 8) return L3Q_GEMV(1);
  if (M <= 16) return L3Q_GEMV(2);
  if (M <= 32) return L3Q_GEMV(4);
  return L3Q_GEMV(8);
#undef L3Q_GEMV
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

// Sums the K-split partials [ksplit, M*N] in a fixed order and casts.
__global__ void qmm_splitk_reduce(const float* __restrict__ part, void* __restrict__ out,
                                  int out_bf16, int mn, int ksplit) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= mn) return;
  float v = 0.f;
  for (int y = 0; y < ksplit; ++y) v += part[(size_t)y * mn + i];
  store_out(out, i, v, out_bf16);
}

int reduce_splits(const void* part, void* out, int out_bf16, int M, int N, int ksplit,
                  cudaStream_t st) {
  const int mn = M * N;
  qmm_splitk_reduce<<<(mn + 255) / 256, 256, 0, st>>>((const float*)part, out, out_bf16, mn, ksplit);
  return (int)cudaGetLastError();
}

}  // namespace

// f: values per byte (4 = 2-bit, 2 = 4-bit, 1 = one code per byte);
// is_signed: int8 (1) or uint8 (0) codes when f == 1. B1 (M <= 64, one
// launch): column tiles of bn = 16, 32, 64 or 128, ksplit <= 8 blocks along
// K in one cluster, units of L = 16 or 8 byte rows inside a group (L * f a
// multiple of 16), runs of uw units inside a group (a round of 128 / bn runs
// at most 256 rows). Needs N % 16 == 0 and 16-byte aligned x, codes, scales
// and zeros.
extern "C" int l3q_qmm_gemv(const void* x, const void* data, const void* scale,
                            const void* zero, void* out, int M, int K, int N, int gs, int f,
                            int is_signed, int out_bf16, int bn, int ksplit, int L, int uw,
                            void* stream) {
  const int kw = (bn == 16 || bn == 32 || bn == 64 || bn == 128) ? GEMV_WARPS * 16 / bn : 0;
  if (M < 1 || M > 64 || N % 16 || !kw || ksplit < 1 || ksplit > 8 || (L != 8 && L != 16) ||
      (f != 1 && f != 2 && f != 4) || gs % f || K % gs || (gs / f) % L || (L * f) % 16 ||
      uw < 1 || (gs / f / L) % uw || K / (L * f) / uw < ksplit || kw * uw * L > 256)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define L3Q_B1(FF, SG, LL) \
  launch_gemv_mt<FF, SG, LL>(x, data, scale, zero, out, M, K, N, gs, out_bf16, bn, ksplit, uw, st)
  if (f == 4) return L == 16 ? L3Q_B1(4, false, 16) : L3Q_B1(4, false, 8);
  if (f == 2) return L == 16 ? L3Q_B1(2, false, 16) : L3Q_B1(2, false, 8);
  if (L != 16) return (int)cudaErrorInvalidValue;
  return is_signed ? L3Q_B1(1, true, 16) : L3Q_B1(1, false, 16);
#undef L3Q_B1
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
