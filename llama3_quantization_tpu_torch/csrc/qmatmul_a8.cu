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
// it is a GEMV bound by the weight bytes over HBM (3.35 TB/s): 2*64 int8
// operations per code at M = 64 stay under the int8 tensor cores' share of
// that time. The GEMV form reads each packed byte from HBM once per call at
// every M (a ring of cp.async stages per block) and runs the dot on the
// tensor cores, mma.sync m16n8k32 s8 with the codes as the 16-row operand
// and the activation rows as the 8-column one (a byte transpose of four
// rows gives four consecutive k of one column per register). The exact s32
// dots and x sums of each group are summed across warps in shared memory
// and the fp32 group terms folded in group order inside the same launch
// (see the GEMV section), so its fp32 output equals the plain version's bit
// for bit and does not depend on timing. At M > 64
// (prefills) it does
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

// ------------------------------------------------------------ GEMV form ----
// One launch at M <= 64: mma.sync m16n8k32 s8 x s8 -> s32 with the codes
// as the 16-row operand (16 output columns; lane group g holds columns 2g
// and 2g + 1) and xq's rows, padded to 8, 16, 32 or 64, as the 8-column
// operand; a second MMA with an all-ones A forms the exact activation sums.
// A unit is L byte rows of one group (L = 32, or 16 / 8 where a group's bit
// field is shorter), L * f k values: its k32 steps take field (32 q + i) / L,
// row (32 q + i) % L for MMA k index i, so the four k of one A register are
// four adjacent byte rows of one field (a byte transpose of four rows) and
// their x values four adjacent bytes of xq.
//
// Grid ceil(N / bn), tiles and runs from `gemv_plan`; K does not split, so
// each block folds every group term of its columns in order. Block: bn / 16
// column warps times kw = 128 / bn warp rows. A
// round is kw runs of uw units, run r to warp row r, each run inside one
// group. Each warp keeps exact s32 dots and x sums in registers: one set
// while its stages stay inside one group, one per round in a stage that
// holds several groups. When a group ends, or such a stage does, the warps
// put their sets in shared memory, tagged with their group, and every
// thread folds its outputs' slots in the runs' order: partials of one
// group add up in s32 (a group that goes on carries its s32 sums to the
// next fold), and each finished group's term (f32(dot) - f32(xsum) * z) * s
// joins the fp32 sum, one rounding per operation, in group order. So the
// fp32 output is `a8_plain`'s bit for bit. The ring's stages copy their
// units' byte rows (one swizzled
// TMA box a round), the xq bytes they meet (real rows only, cp.async) and
// the scales and zeros of their groups (bulk copies).
constexpr int GEMV_THREADS = 256;
constexpr int GEMV_WARPS = GEMV_THREADS / 32;

// Rounds a stage at most (each warp keeps a run's s32 sums per round).
__host__ __device__ constexpr int gemv_rmax(int mt) { return mt == 1 ? 4 : mt == 2 ? 2 : 1; }
// Bytes of the fold's shared memory: the slots, the state, 8-byte aligned.
__host__ __device__ constexpr int gemv_fold_bytes(int nslot, int mp, int bn, int m) {
  return ((nslot * mp * bn + nslot * mp + nslot + 2 * m * bn + 2 * mp) * 4 + 7) / 8 * 8;
}

// The group epilogue term (dot - xsum * z) * s, one rounding per operation.
__device__ __forceinline__ float group_term(int dot, int xs, float s, float z, int zmode) {
  float t = (float)dot;
  if (zmode) t = __fsub_rn(t, __fmul_rn((float)xs, z));
  return __fmul_rn(t, s);
}

template <int C, int L, int MT>
__global__ void __launch_bounds__(GEMV_THREADS) a8_gemv_kernel(
    const int8_t* __restrict__ xq, const float* __restrict__ scale,
    const void* __restrict__ zero, int zmode, const float* __restrict__ sx, void* __restrict__ out,
    int out_bf16, int M, int K, int N, int gs, int bn, int uw, int rounds, int ring,
    const __grid_constant__ CUtensorMap tmw) {
  constexpr int F = PackOf<C>::F;
  constexpr int UK = L * F, KQ = UK / 32, MP = 8 * MT, RMAX = gemv_rmax(MT);
  extern __shared__ __align__(1024) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, t = lane & 3;
  const l3q::Div ncd(bn / 16), bnd(bn);
  const int nc = ncd.d, kw = GEMV_WARPS / nc;
  const int cw = warp & (nc - 1), kwi = warp >> ncd.sh;
  const l3q::Div ug(gs / F / L), subd(gs / F);  // units, byte rows per group
  const int u0 = 0, u1 = K / UK;  // every unit: K does not split
  const int ru = kw * uw, us = ru * rounds;  // units per round, per stage
  const int nst = (u1 - u0 + us - 1) / us;
  const int ngs = us / ug.d + 2;  // groups one stage can touch
  const int zb = zmode == 2 ? 1 : 4;  // bytes per zero
  const int xsb = l3q::odd_row(us * UK);
  const int wbytes = us * L * bn, xbytes = MP * xsb, sbytes = ngs * bn * 4;
  const int stage_bytes = (wbytes + xbytes + 2 * sbytes + 1023) / 1024 * 1024;
  const int col0 = blockIdx.x * bn, ncol = min(bn, N - col0);
  const int cl = cw * 16 + 2 * gid;
  // after the ring: the slots of a stage's runs (round j, warp row r) [R][kw]
  // of s32 dots [MP][bn], x sums [MP] and group tags; the fold's state: fp32
  // sums and the running s32 dot of each output [M][bn], the running s32 x
  // sum of each row [2][MP] (read one buffer, write the other); the ring's
  // mbarriers
  const int nslot = rounds * kw;
  int* sdot = reinterpret_cast<int*>(smem + (size_t)ring * stage_bytes);
  int* sxs = sdot + nslot * MP * bn;
  int* stag = sxs + nslot * MP;
  float* accs = reinterpret_cast<float*>(stag + nslot);
  int* accd = reinterpret_cast<int*>(accs + M * bn);
  int* accx = accd + M * bn;
  const int fold_bytes = gemv_fold_bytes(nslot, MP, bn, M);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + (size_t)ring * stage_bytes + fold_bytes);

  // stage s into ring slot `slot`: by warp 0 on the slot's mbarrier the
  // units' byte rows of the tile (one TMA box a round, swizzled) and the
  // scales and zeros of the stage's groups (bulk copies); by every thread
  // (cp.async) the xq bytes of the units' k, real rows only, CH k of one
  // group per copy: field-major, or unit-major for L = 8, where a field's
  // run in a unit is shorter than an ldmatrix row
  auto load_stage = [&](int s, int slot) {
    unsigned char* W = smem + (size_t)slot * stage_bytes;
    unsigned char* X = W + wbytes;
    unsigned char* S = X + xbytes;
    unsigned char* Z = S + sbytes;
    const int ua = u0 + s * us, nu = min(us, u1 - ua), nr = (nu + ru - 1) / ru;
    if (warp == 0) {
      const int gf = ug(ua), ng = ug(ua + nu - 1) - gf + 1, zrow = zmode ? ncol * zb : 0;
      if (lane == 0) l3q::mbar_expect_tx(full + slot, nr * ru * L * bn + ng * (ncol * 4 + zrow));
      __syncwarp();
      if (lane < nr)
        l3q::tma_load_2d(W + lane * ru * L * bn, &tmw, col0, (ua + lane * ru) * L, full + slot);
      for (int i = lane; i < (zmode ? 2 : 1) * ng; i += 32) {
        const int gi = zmode ? i >> 1 : i;
        const size_t g = gf + gi;
        if (zmode && (i & 1)) {
          l3q::bulk_load(Z + gi * bn * zb, static_cast<const unsigned char*>(zero) + (g * N + col0) * zb,
                         zrow, full + slot);
        } else {
          l3q::bulk_load(S + gi * bn * 4, scale + g * N + col0, ncol * 4, full + slot);
        }
      }
    }
    constexpr int CH = L < 16 ? L : 16;
    const int cr = nu * L / CH;  // copies per (row, field)
    const l3q::Div crd(cr);
    for (int i = tid; i < M * F * cr; i += GEMV_THREADS) {
      const int mf = crd(i), c = i - mf * cr, m = mf / F, f = mf - m * F;
      const int row = ua * L + CH * c, g = subd(row);
      const int8_t* sp = xq + (size_t)m * K + g * gs + f * subd.d + row - g * subd.d;
      if (CH == 16) {
        l3q::cp_async16(X + m * xsb + f * us * L + CH * c, sp);
      } else {
        l3q::cp_async8_zfill(X + m * xsb + c * UK + f * L, sp, true);
      }
    }
  };

  for (int i = tid; i < M * bn; i += GEMV_THREADS) accs[i] = 0.f, accd[i] = 0;
  for (int i = tid; i < 2 * MP; i += GEMV_THREADS) accx[i] = 0;
  // this warp's s32 sums of its runs since the last fold (set j: round j of
  // a stage with several groups, else every run in set 0) and their groups
  int dots[RMAX][MT][4], xss[RMAX][MT][4], tags[RMAX];
#pragma unroll
  for (int j = 0; j < RMAX; ++j) {
    tags[j] = -1;
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) dots[j][i][e] = xss[j][i][e] = 0;
  }
  int nfold = 0;  // folds so far (the x sums' buffer parity)

  auto unit = [&](const unsigned char* W, const unsigned char* X, int lu, int (&dot)[MT][4],
                  int (&xs)[MT][4]) {
    if (L3Q_ABLATE & 256) return;
    // this lane's two columns of rows (4t + 16j) % L .. + 3, byte-transposed
    uint32_t col[2][2];
#pragma unroll
    for (int j = 0; j < (L == 32 ? 2 : 1); ++j) {
      const int r0 = lu * L + (4 * t + 16 * j) % L;
      uint32_t r[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        r[i] = *reinterpret_cast<const uint16_t*>(W + l3q::swz_off(r0 + i, cl, bn));
      const uint32_t w01 = __byte_perm(r[0], r[1], 0x5410), w23 = __byte_perm(r[2], r[3], 0x5410);
      col[j][0] = __byte_perm(w01, w23, 0x6420);
      col[j][1] = __byte_perm(w01, w23, 0x7531);
    }
    if (L != 32) col[1][0] = col[0][0], col[1][1] = col[0][1];
    // matrix j of k32 steps kp, kp + 1: MMA k 16j.. of the pair, field
    // (32 kp + 16j) / L at row (32 kp + 16j) % L of the unit
    const unsigned char* xr = X + (lane & 7) * xsb;
    auto xpos = [&](int kp) {
      const int e = 32 * kp + 16 * (lane >> 3);
      return L < 16 ? xr + lu * UK + e : xr + (e / L) * us * L + lu * L + e % L;
    };
    const uint32_t ones[4] = {0x01010101u, 0x01010101u, 0x01010101u, 0x01010101u};
#pragma unroll
    for (int kp = 0; kp < KQ; kp += 2) {  // x for k32 steps kp and kp + 1 in one ldmatrix
      uint32_t a[2][4];
#pragma unroll
      for (int h = 0; h < 2 && kp + h < KQ; ++h) {
        const int fa = (32 * (kp + h) + 4 * t) / L, fb = (32 * (kp + h) + 16 + 4 * t) / L;
        if (L3Q_ABLATE & 64) {
          a[h][0] = col[0][0], a[h][1] = col[0][1], a[h][2] = col[1][0], a[h][3] = col[1][1];
        } else {
          a[h][0] = field4<C>(col[0][0], fa), a[h][1] = field4<C>(col[0][1], fa);
          a[h][2] = field4<C>(col[1][0], fb), a[h][3] = field4<C>(col[1][1], fb);
        }
      }
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        uint32_t b[4];
        if (KQ == 1) {
          l3q::ldmatrix_x2(b, xpos(kp) + i * 8 * xsb);
        } else {
          l3q::ldmatrix_x4(b, xpos(kp) + i * 8 * xsb);
        }
#pragma unroll
        for (int h = 0; h < 2 && kp + h < KQ; ++h) {
          if (L3Q_ABLATE & 128) {
            dot[i][0] ^= (int)(a[h][0] ^ a[h][1] ^ a[h][2] ^ a[h][3] ^ b[2 * h] ^ b[2 * h + 1]);
          } else {
            l3q::mma_s8_16832(dot[i], a[h], b + 2 * h);
            l3q::mma_s8_16832(xs[i], ones, b + 2 * h);
          }
        }
      }
    }
  };

  // the stage's slots, round by round and warp row by warp row (the runs'
  // order): s32 sums of one group add up, a group's term joins the fp32 sum
  // when the next group starts, and the last group's when the stage ends at
  // a group boundary (`done`). The last fold stores.
  int cg = -1;  // the group being summed (the same for every output)
  auto fold = [&](const unsigned char* S, const unsigned char* Z, int gf, int nsets, bool done,
                  bool last, int par) {
    for (int i = tid; i < M * bn; i += GEMV_THREADS) {
      const int m = bnd(i), c = i - m * bn, col = col0 + c;
      auto term = [&](int g, int d, int xsum) {
        if (C == U8) d += 128 * xsum;  // back to the promoted dot
        const int o = (g - gf) * bn + c;
        const float z = zmode == 1   ? reinterpret_cast<const float*>(Z)[o]
                        : zmode == 2 ? (float)reinterpret_cast<const int8_t*>(Z)[o]
                                     : 0.f;
        return group_term(d, xsum, reinterpret_cast<const float*>(S)[o], z, zmode);
      };
      float acc = accs[i];
      int d = accd[i], xsum = accx[par * MP + m], g = cg;
      for (int j = 0; j < nsets * kw; ++j) {
        const int tg = stag[j];
        if (tg < 0) continue;
        if (tg != g) {
          if (g >= 0 && col < N) acc = __fadd_rn(acc, term(g, d, xsum));
          g = tg, d = 0, xsum = 0;
        }
        d += sdot[(j * MP + m) * bn + c];
        xsum += sxs[j * MP + m];
      }
      if (done && col < N) {
        acc = __fadd_rn(acc, term(g, d, xsum));
        d = xsum = 0;
      }
      if (last) {
        if (col < N) store_out(out, (size_t)m * N + col, __fmul_rn(acc, sx[m]), out_bf16);
      } else {
        accs[i] = acc, accd[i] = d;
        if (c == 0) accx[(par ^ 1) * MP + m] = xsum;
      }
    }
    for (int j = 0; j < nsets * kw; ++j)  // every thread follows the same tags
      if (stag[j] >= 0) cg = stag[j];
    if (done) cg = -1;
  };

  if (tid == 0)
    for (int i = 0; i < ring; ++i) l3q::mbar_init(full + i, 1);
  __syncthreads();
  for (int s = 0; s < ring - 1; ++s) {
    if (s < nst) load_stage(s, s);
    l3q::cp_async_commit();
  }
  for (int s = 0; s < nst; ++s) {
    l3q::cp_async_wait_upto<5>(ring - 2);  // this thread's xq copies of stage s
    __syncthreads();  // everyone's; and slot (s - 1) % ring is free
    if (s + ring - 1 < nst) load_stage(s + ring - 1, (s + ring - 1) % ring);
    l3q::cp_async_commit();
    l3q::mbar_wait(full + s % ring, (s / ring) & 1);  // its codes, scales and zeros
    const unsigned char* W = smem + (size_t)(s % ring) * stage_bytes;
    const unsigned char* X = W + wbytes;
    const unsigned char* S = X + xbytes;
    const int ua = u0 + s * us, nu = min(us, u1 - ua), gf = ug(ua), nr = (nu + ru - 1) / ru;
    // a stage inside one group adds every run into sums 0 and folds only
    // when the group ends or a stage with several groups follows; such a
    // stage keeps each round's sums apart and folds at its end
    auto multi_at = [&](int a) { return ug(a) != ug(a + min(us, u1 - a) - 1); };
    const bool multi = multi_at(ua), last = s + 1 == nst;
    const bool done = (ua + nu) % ug.d == 0 || last;
#pragma unroll
    for (int j = 0; j < RMAX; ++j) {
      const int lr = j * ru + kwi * uw;  // this warp row's run in round j
      if (j < nr && lr < nu) {
        if (multi) {
          tags[j] = ug(ua + lr);
          for (int v = 0; v < uw; ++v) unit(W, X, lr + v, dots[j], xss[j]);
        } else {
          tags[0] = ug(ua + lr);
          for (int v = 0; v < uw; ++v) unit(W, X, lr + v, dots[0], xss[0]);
        }
      }
    }
    if (!multi && !done && !multi_at(ua + us)) continue;
    const int nsets = multi ? nr : 1;
#pragma unroll
    for (int j = 0; j < RMAX; ++j) {
      if (j >= nsets) break;
      const int sl = j * kw + kwi;
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sdot[(sl * MP + 8 * i + 2 * t + (e & 1)) * bn + cl + (e >> 1)] = dots[j][i][e];
          dots[j][i][e] = 0;
        }
      if (cw == 0 && gid == 0) {
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          sxs[sl * MP + 8 * i + 2 * t] = xss[j][i][0];
          sxs[sl * MP + 8 * i + 2 * t + 1] = xss[j][i][1];
        }
        if (t == 0) stag[sl] = tags[j];
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) xss[j][i][e] = 0;
      tags[j] = -1;
    }
    __syncthreads();
    fold(S, S + sbytes, gf, nsets, done, last, nfold++ & 1);
  }
}

// Rounds per stage and ring depth of a B3 GEMV launch (`l3q::pick_stages`):
// stages of up to 32 KB of codes and 32 KB of xq and at most gemv_rmax
// rounds. Any choice gives the same result (exact s32 sums, terms in group
// order).
template <int C, int L, int MT>
int launch_gemv(const void* xq, const void* data, const void* scale, const void* zero, int zmode,
                const void* sx, void* out, int out_bf16, int M, int K, int N, int gs, int bn,
                int uw, cudaStream_t st) {
  constexpr int F = PackOf<C>::F, UK = L * F, MP = 8 * MT;
  auto kernel = a8_gemv_kernel<C, L, MT>;
  const int kw = GEMV_WARPS * 16 / bn, ru = kw * uw, ug = gs / F / L;
  auto stage = [&](int R) {  // (bytes of a ring slot, code bytes of a stage)
    const int us = ru * R;
    const size_t b = (size_t)us * L * bn + (size_t)MP * l3q::odd_row(us * UK) +
                     2 * (size_t)(us / ug + 2) * bn * 4;
    return std::make_pair((b + 1023) / 1024 * 1024, (size_t)us * L * bn);
  };
  auto fits = [&](int R) {
    const int us = ru * R;
    return R == 1 || (R <= gemv_rmax(MT) && us <= K / UK && (size_t)us * L * bn <= 32768 &&
                      (size_t)MP * l3q::odd_row(us * UK) <= 32768);
  };
  auto fold = [&](int R) { return (size_t)gemv_fold_bytes(R * kw, MP, bn, M) + 64; };
  static const int per_sm = l3q::regs_blocks(kernel, GEMV_THREADS);
  const l3q::GemvStages sg =
      l3q::pick_stages(stage, fits, fold, l3q::gemv_budget(per_sm, (long)(N + bn - 1) / bn, 1));
  CUtensorMap tmw{};  // the codes [K / f, N] in boxes of one round's rows x bn
  int e = l3q::tensor_map_u8(&tmw, data, K / F, N, N, ru * L, bn, l3q::row_swizzle(bn));
  if (e) return e;
  e = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sg.smem);
  if (e) return e;
  kernel<<<(N + bn - 1) / bn, GEMV_THREADS, sg.smem, st>>>(
      (const int8_t*)xq, (const float*)scale, zero, zmode, (const float*)sx, out, out_bf16, M, K, N,
      gs, bn, uw, sg.rounds, sg.ring, tmw);
  return (int)cudaGetLastError();
}

template <int C, int L>
int launch_gemv_mt(const void* xq, const void* data, const void* scale, const void* zero,
                   int zmode, const void* sx, void* out, int out_bf16, int M, int K, int N,
                   int gs, int bn, int uw, cudaStream_t st) {
#define L3Q_GEMV(MT) \
  launch_gemv<C, L, MT>(xq, data, scale, zero, zmode, sx, out, out_bf16, M, K, N, gs, bn, uw, st)
  if (M <= 8) return L3Q_GEMV(1);
  if (M <= 16) return L3Q_GEMV(2);
  if (M <= 32) return L3Q_GEMV(4);
  return L3Q_GEMV(8);
#undef L3Q_GEMV
}

template <int C>
int launch_gemv_l(const void* xq, const void* data, const void* scale, const void* zero, int zmode,
                  const void* sx, void* out, int out_bf16, int M, int K, int N, int gs, int bn,
                  int L, int uw, cudaStream_t st) {
  constexpr int F = PackOf<C>::F;
#define L3Q_GEMV_L(LL) \
  launch_gemv_mt<C, LL>(xq, data, scale, zero, zmode, sx, out, out_bf16, M, K, N, gs, bn, uw, st)
  if (L == 32) return L3Q_GEMV_L(32);
  if (F >= 2 && L == 16) return L3Q_GEMV_L(F >= 2 ? 16 : 32);
  if (F == 4 && L == 8) return L3Q_GEMV_L(F == 4 ? 8 : 32);
  return (int)cudaErrorInvalidValue;
#undef L3Q_GEMV_L
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
    err = l3q::tensor_map_u8(&tmx, xq, M, K, K, BM, KS, CU_TENSOR_MAP_SWIZZLE_128B);
  if (!err) err = l3q::tensor_map_u8(&tmw, data, K / F, N, N, rows, BN, CU_TENSOR_MAP_SWIZZLE_NONE);
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
// fp32 zero [G, N], 2 = int8 zero [G, N]. GEMV form (M <= 64, one launch):
// column tiles of bn = 16, 32, 64 or 128, units of L = 32, 16 or 8 byte
// rows inside a group (L * f a multiple of 32), runs of uw units inside a
// group (a round of 128 / bn runs at most 256 rows). Needs N % 16 == 0 and
// 16-byte aligned codes, activations, scales and zeros.
extern "C" int l3q_a8_gemv(const void* xq, const void* data, const void* scale, const void* zero,
                           int zmode, const void* sx, void* out, int out_bf16, int M, int K, int N,
                           int gs, int code, int bn, int L, int uw, void* stream) {
  const int f = (code == S8 || code == U8) ? 1 : (code == U2 ? 4 : 2);
  const int kw = (bn == 16 || bn == 32 || bn == 64 || bn == 128) ? GEMV_WARPS * 16 / bn : 0;
  const int ug = (f > 0 && L > 0 && gs > 0) ? gs / f / L : 0;
  if (M < 1 || M > 64 || N % 16 || !kw || (L != 8 && L != 16 && L != 32) || gs < 1 || gs % f ||
      K % gs || (gs / f) % L || (L * f) % 32 || uw < 1 || ug % uw || kw * uw * L > 256)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define L3Q_B3(CODE) \
  launch_gemv_l<CODE>(xq, data, scale, zero, zmode, sx, out, out_bf16, M, K, N, gs, bn, L, uw, st)
  if (code == S8) return L3Q_B3(S8);
  if (code == U4) return L3Q_B3(U4);
  if (code == S4) return L3Q_B3(S4);
  if (code == U2) return L3Q_B3(U2);
  if (code == U8) return L3Q_B3(U8);
#undef L3Q_B3
  return (int)cudaErrorInvalidValue;
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
