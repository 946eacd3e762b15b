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
// operation, as the plain version (ops/w4_bd.py) sums them: the result is
// the plain version's bit for bit.
//
// What bounds it on the H100: the packed weight bytes (and scales) over HBM
// at 3.35 TB/s. The dense forms do 2R int8 operations per weight value (R =
// 32 rows: 7.5 G at [4096 x 28672]), more than the CUDA cores' dp4a keeps up
// with, but a small share of the int8 tensor cores' time. The design:
// - Tensor-core dots for every form: mma.sync m16n8k32 s8 with the weight
//   as the 16-row operand (16 columns) and the row operand as the 8-column
//   one (R / 8 n tiles). v4 and tiled have 2 real rows, xh and xl, in one n
//   tile: their work, 4KN, is small and the stream sets their pace, but the
//   same MMA path costs them fewer instructions than dp4a would. Hopper has
//   no int4 MMA: ldmatrix.trans gives each lane four byte rows of one column,
//   and each nibble becomes an s8 in registers scaled by 16 ((w << 4) & 0xF0
//   for the low one, w & 0xF0 for the high one: three operations a word), so
//   every product and P carry a factor 16 that the epilogue shifts out
//   exactly. The integer sums are exact in any k order, so the small operand
//   is permuted and never the weight: MMA k index 4t + i is the low nibble
//   of chunk row rho = {2t, 2t+1, 8+2t, 9+2t}[i] (k = 2 rho), 16 + 4t + i its
//   high nibble (k = 2 rho + 1). With several n tiles the block permutes each
//   stage's operand once in shared memory into that order (its even-k and
//   odd-k halves), and each warp loads its fragments with ldmatrix; with one
//   n tile each warp permutes its own two words in registers.
// - A copy ring that keeps the bytes in flight: one producer warp feeds a
//   ring of `ring` stages on mbarriers; a stage is `sr` byte rows of the
//   block's 128 columns as one TMA box with a 128-byte swizzle (the tiled
//   layout's [bk/2, bn] tiles through a 2-D view of the tile array), and the
//   row operand's bytes for those rows as one TMA box (v4: a bulk copy each
//   of xh and xl), each byte fetched once; the scales of a tile's groups come
//   by bulk copy beside them, into a buffer of their own.
// - A grid from `bd_plan` (ops/w4_bd.py: the shapes alone): 128 columns a
//   block (eight consumer warps of 16), and a K split over a thread-block
//   cluster of ks blocks where the columns alone leave SMs idle: rank q takes
//   byte rows [q, q + 1) * bk / 2ks of every tile, and owns the epilogue of
//   columns [q, q + 1) * 128 / ks. Each warp adds its s32 partials of P into
//   the owner's shared memory (a shared atomic, or a DSMEM `red.add` for
//   another rank's columns: exact in any order), once a tile, or once a stage
//   for v4, whose rows change with the group; a cluster barrier a tile, with
//   P double-buffered by tile parity, hands them over. The owner then runs
//   the epilogue above in its order.

#include "common.cuh"

namespace {

enum Form { V4 = 0, DOT4 = 1, CAST8 = 2, NOSCALE = 3, MULTI = 4 };
constexpr int CWARPS = 8;  // consumer warps, 16 columns each; warp CWARPS copies
constexpr int THREADS = (CWARPS + 1) * 32;
constexpr int GS = 128, MAXR = 32, BN = 128;  // BN: columns of a block (one 128-byte box row)

struct Maps {
  CUtensorMap w[4];  // the packed weight per stream (tiled: stream 0)
  CUtensorMap a[4];  // the row operand per stream, boxes [rows, 2 sr] (not v4)
};

struct Args {
  const int8_t* x[2];  // v4: xh, xl [1, K]
  const float* scale;  // [K / 128, N] (v4, dot4, cast8)
  float* out;          // [1, N]
  int form, K, N, bk, bn_t, streams, rows;
  int ks, sr, ring;  // the plan
};

__host__ __device__ constexpr bool scaled_form(int f) { return f == V4 || f == DOT4 || f == CAST8; }

// Shared memory of a block: the ring's slots (codes [sr][128], swizzled;
// then the row operand [orows][2 sr], swizzled by its own row width, or
// plain for v4's xh and xl), with several n tiles the row operand of the
// last two stages in the MMA's k order [2][8 nt][ost] (rows past orows
// zero), P [2][rp][cpr] s32, the scales [2][gt][cpr] f32, the mbarriers.
// Host and device compute it alike.
struct Layout {
  int rp, cpr, orows, nt, obw, ost, codes, slot, op, pb, sb, bars, total;
  __host__ __device__ explicit Layout(const Args& p) {
    const int gt = p.bk / GS;
    rp = p.form == V4 ? 2 * gt : p.rows;
    cpr = BN / p.ks;
    orows = p.form == V4 ? 2 : p.rows;
    nt = orows <= 8 ? 1 : orows <= 16 ? 2 : 4;
    obw = 2 * p.sr;
    ost = l3q::odd_row(obw);
    codes = p.sr * BN;
    slot = (codes + orows * obw + 1023) / 1024 * 1024;
    op = p.ring * slot;  // the permuted operand [2][8 nt][ost] (several n tiles)
    pb = op + (nt > 1 ? 2 * 8 * nt * ost : 0);
    sb = pb + 2 * rp * cpr * 4;
    bars = sb + (scaled_form(p.form) ? 2 * gt * cpr * 4 : 0);
    total = bars + (2 * p.ring + 4) * 8;
  }
};

// NT: n tiles of 8 rows of the row operand (v4: 1).
template <int NT>
__global__ void __launch_bounds__(THREADS) bd_kernel(const Args p, const __grid_constant__ Maps maps) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const Layout L(p);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, gid = lane >> 2, t = lane & 3;
  const int q = blockIdx.y, n0 = blockIdx.x * BN;  // rank in the cluster (1, ks, 1)
  const int gt = p.bk / GS, ntile = p.K / p.bk, tr = p.bk / 2 / p.ks, nst = tr / p.sr;
  const int rows_s = p.bk / 2 / p.streams;  // byte rows of one stream in a tile
  const bool scaled = scaled_form(p.form), v4 = p.form == V4;
  int* pb = reinterpret_cast<int*>(smem + L.pb);
  float* sb = reinterpret_cast<float*>(smem + L.sb);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bars);
  uint64_t* empty = full + p.ring;
  uint64_t* sfull = empty + p.ring;  // [2] the scales of a tile
  uint64_t* sempty = sfull + 2;      // [2] their buffer read

  if (tid == 0) {
    l3q::mbar_init_n(full, p.ring);
    l3q::mbar_init_n(empty, p.ring, CWARPS);
    l3q::mbar_init_n(sfull, 2);
    l3q::mbar_init_n(sempty, 2, CWARPS);
  }
  for (int i = tid; i < (L.sb - L.op) / 4; i += THREADS) reinterpret_cast<int*>(smem + L.op)[i] = 0;
  __syncthreads();
  l3q::cluster_arrive();  // the start phase: no remote add before every block runs

  if (warp == CWARPS) {  // the producer
    int stage = 0;
    for (int j = 0; j < ntile; ++j) {
      const int par = j & 1;
      if (scaled) {
        if (lane == 0) {
          if (j >= 2) l3q::mbar_wait(sempty + par, ((j >> 1) - 1) & 1);
          l3q::mbar_expect_tx(sfull + par, gt * L.cpr * 4);
        }
        __syncwarp();
        for (int r = lane; r < gt; r += 32)
          l3q::bulk_load(sb + (par * gt + r) * L.cpr,
                         p.scale + (size_t)(j * gt + r) * p.N + n0 + q * L.cpr, L.cpr * 4, sfull + par);
      }
      for (int i = 0; i < nst; ++i, ++stage) {
        const int slot = stage % p.ring;
        unsigned char* W = smem + (size_t)slot * L.slot;
        if (lane == 0) {
          if (stage >= p.ring) l3q::mbar_wait(empty + slot, (stage / p.ring - 1) & 1);
          l3q::mbar_expect_tx(full + slot, L.codes + L.orows * L.obw);
        }
        __syncwarp();
        const int v = q * tr + i * p.sr, s = v / rows_s, vr = v - s * rows_s;
        if (lane == 0) {
          int row = j * rows_s + vr, col = n0;
          if (p.bn_t) {  // tiles [K/bk, N/bn_t, bk/2, bn_t] as rows of bn_t bytes
            const int h = n0 / p.bn_t;
            row = (j * (p.N / p.bn_t) + h) * (p.bk / 2) + v;
            col = n0 - h * p.bn_t;
          }
          l3q::tma_load_2d(W, &maps.w[s], col, row, full + slot);
        } else if (lane == 1 && !v4) {
          l3q::tma_load_2d(W + L.codes, &maps.a[s], j * (p.bk / p.streams) + 2 * vr, 0, full + slot);
        } else if (lane <= 2 && v4) {
          l3q::bulk_load(W + L.codes + (lane - 1) * L.obw, p.x[lane - 1] + (size_t)j * p.bk + 2 * v,
                         L.obw, full + slot);
        }
      }
      l3q::cluster_wait();    // the previous phase (for tile 0: the start)
      l3q::cluster_arrive();  // tile j's
    }
    l3q::cluster_wait();
    return;
  }

  // consumer warp: columns cb .. cb + 15 of the block (lane group g: columns
  // cb + 2g and cb + 2g + 1, the MMA's rows g and g + 8), every unit of 16
  // byte rows of every stage
  const int cb = warp * 16;
  int acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0;
  // this warp's partials into the owners' P rows (v4: row0 = the group, row0
  // + gt its xl row; else the operand rows), zeroed after. Column cb + 2g + h
  // belongs to rank own[h], at offset off[h] of its P rows (cpr: a power of 2).
  int own[2], off[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int col = cb + 2 * gid + h;
    own[h] = col / L.cpr;
    off[h] = col - own[h] * L.cpr;
  }
  auto flush = [&](int par, int row0) {
    if (L3Q_ABLATE & 1024) return;
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = n * 8 + 2 * t + (e & 1);  // operand row of this element
        int* dst = pb + (par * L.rp + (v4 ? row0 + r * gt : r)) * L.cpr + off[e >> 1];
        if (r < L.orows) {
          if (own[e >> 1] == q) {
            atomicAdd(dst, acc[n][e]);
          } else {
            l3q::red_cluster_add(dst, own[e >> 1], acc[n][e]);
          }
        }
        acc[n][e] = 0;
      }
  };
  float oacc = 0.f;
  // per lane: its ldmatrix.trans row of a unit (16 byte rows) of its 16
  // columns; with several n tiles its ldmatrix row of the permuted operand
  // (matrix i = lane / 8: n tile i / 2, the E half for even i, the O half for
  // odd i); with one, the swizzle of the raw operand's row g (v4's are plain)
  const int a_off = (lane & 15) * BN + ((warp ^ (lane & 7)) << 4);
  const int b_off = ((lane >> 4) * 8 + (lane & 7)) * L.ost + ((lane >> 3) & 1) * 16;
  const int rx = v4 ? 0 : ((gid * L.obw) >> 7) & (L.obw / 16 - 1);
  l3q::cluster_wait();  // the start phase
  int stage = 0;
  for (int j = 0; j < ntile; ++j) {
    const int par = j & 1;
    for (int i = 0; i < nst; ++i, ++stage) {
      const int slot = stage % p.ring;
      l3q::mbar_wait(full + slot, (stage / p.ring) & 1);
      const unsigned char* W = smem + (size_t)slot * L.slot;
      const unsigned char* O = W + L.codes;
      unsigned char* E = smem + L.op + (stage & 1) * 8 * L.nt * L.ost;
      if (!(L3Q_ABLATE & 1024)) {
        if (NT > 1) {
          // the stage's operand once into the MMA's k order: unit u of row r
          // (k 32u .. 32u + 31) becomes E[4t + i] = k 32u + 2 rho, O[4t + i]
          // = k 32u + 2 rho + 1, rho = {2t, 2t+1, 8+2t, 9+2t}[i]: the
          // partners of the low and the high nibbles of chunk row rho in the
          // codes' ldmatrix.trans order
          for (int it = tid; it < L.orows * (p.sr / 16); it += CWARPS * 32) {
            const int r = it / (p.sr / 16), u = it - r * (p.sr / 16);
            const uint4 x0 = *reinterpret_cast<const uint4*>(O + l3q::swz_off(r, 32 * u, L.obw));
            const uint4 x1 = *reinterpret_cast<const uint4*>(O + l3q::swz_off(r, 32 * u + 16, L.obw));
            uint4 ev, od;
            ev.x = __byte_perm(x0.x, x1.x, 0x6420); od.x = __byte_perm(x0.x, x1.x, 0x7531);
            ev.y = __byte_perm(x0.y, x1.y, 0x6420); od.y = __byte_perm(x0.y, x1.y, 0x7531);
            ev.z = __byte_perm(x0.z, x1.z, 0x6420); od.z = __byte_perm(x0.z, x1.z, 0x7531);
            ev.w = __byte_perm(x0.w, x1.w, 0x6420); od.w = __byte_perm(x0.w, x1.w, 0x7531);
            *reinterpret_cast<uint4*>(E + r * L.ost + 32 * u) = ev;
            *reinterpret_cast<uint4*>(E + r * L.ost + 32 * u + 16) = od;
          }
          l3q::bar_sync(1, CWARPS * 32);  // (also frees the other buffer: all are past its stage)
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (u >= p.sr / 16) break;
          uint32_t b[NT][2];  // n tile n: b[n][0] against the low nibbles, b[n][1] the high
          if (NT == 1) {  // one n tile: two words of the raw row, permuted in registers
            uint32_t wa = 0u, wb = 0u;
            if (gid < L.orows) {
              const unsigned char* o = O + gid * L.obw + 4 * t;
              wa = *reinterpret_cast<const uint32_t*>(o + (((2 * u) ^ rx) << 4));
              wb = *reinterpret_cast<const uint32_t*>(o + (((2 * u + 1) ^ rx) << 4));
            }
            b[0][0] = __byte_perm(wa, wb, 0x6420);
            b[0][1] = __byte_perm(wa, wb, 0x7531);
          } else {
#pragma unroll
            for (int n = 0; n < NT; n += 2) {
              uint32_t r4[4];
              l3q::ldmatrix_x4(r4, E + b_off + n * 8 * L.ost + 32 * u);
              b[n][0] = r4[0], b[n][1] = r4[1], b[n + 1][0] = r4[2], b[n + 1][1] = r4[3];
            }
          }
          uint32_t rr[2], c[2];
          l3q::ldmatrix_x2_trans(rr, W + a_off + u * 16 * BN);
          l3q::trans_cols(rr[0], rr[1], c);
          const uint32_t a[4] = {(c[0] << 4) & 0xF0F0F0F0u, (c[1] << 4) & 0xF0F0F0F0u,
                                 c[0] & 0xF0F0F0F0u, c[1] & 0xF0F0F0F0u};
#pragma unroll
          for (int n = 0; n < NT; ++n) l3q::mma_s8_16832(acc[n], a, b[n]);
        }
        // v4: a stage lies in one group, whose two P rows it adds to
        if (v4) flush(par, (q * tr + i * p.sr) / 64);
      }
      __syncwarp();
      if (lane == 0) l3q::mbar_arrive(empty + slot);
    }
    if (!v4) flush(par, 0);
    l3q::cluster_arrive();
    l3q::cluster_wait();  // every partial of tile j is in its owner's P
    if (scaled) l3q::mbar_wait(sfull + par, (j >> 1) & 1);
    if (tid < L.cpr) {
      int* P = pb + par * L.rp * L.cpr + tid;
      const float* S = sb + par * gt * L.cpr + tid;
      float tj = 0.f;
      if (!(L3Q_ABLATE & 1024)) {
        if (p.form == V4 || p.form == DOT4) {
          for (int r = 0; r < gt; ++r)  // 16 P[r] + P[gt + r], P carrying its factor 16
            tj = __fadd_rn(tj, __fmul_rn((float)(P[r * L.cpr] + (P[(gt + r) * L.cpr] >> 4)),
                                         S[r * L.cpr]));
        } else if (p.form == CAST8) {
          for (int r = 0; r < gt; ++r)
            tj = __fadd_rn(tj, __fmul_rn((float)(P[r * L.cpr] >> 4), S[r * L.cpr]));
        } else {
          for (int r = 0; r < L.rp; ++r) tj = __fadd_rn(tj, (float)(P[r * L.cpr] >> 4));
        }
        oacc = __fadd_rn(oacc, tj);
      }
      for (int r = 0; r < L.rp; ++r) P[r * L.cpr] = 0;
    }
    if (scaled) {
      __syncwarp();
      if (lane == 0) l3q::mbar_arrive(sempty + par);
    }
  }
  if (tid < L.cpr) p.out[n0 + q * L.cpr + tid] = oacc;
}

template <int NT>
int launch(const Args& p, const Maps& maps, cudaStream_t st) {
  const Layout L(p);
  auto kernel = bd_kernel<NT>;
  int e = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L.total);
  if (e) return e;
  e = l3q::launch_clustered(kernel, dim3(p.N / BN, p.ks), THREADS, L.total, p.ks, st, p, maps);
  return e ? e : (int)cudaGetLastError();
}

}  // namespace

// form: 0 v4, 1 dot4, 2 cast8, 3 noscale, 4 multi. w0..w3: packed weights
// per stream (row-major [K / 2S, N]; with bn_t > 0 the tiles
// [K/bk, N/bn_t, bk/2, bn_t] in w0); a0..a3: the row operand per stream (v4:
// a0 = xh, a1 = xl, each [1, K]; otherwise `rows` rows of `a_ld` bytes);
// scale f32 [K / 128, N]; out f32 [1, N]. The plan (bn = 128, ks, sr, ring)
// comes from `bd_plan` in ops/w4_bd.py, which states its constraints; every
// pointer 16-byte aligned.
extern "C" int l3q_w4_bd(int form, const void* w0, const void* w1, const void* w2,
                         const void* w3, const void* a0, const void* a1, const void* a2,
                         const void* a3, const void* scale, void* out, int K, int N, int bk,
                         int bn_t, int streams, int rows, int a_ld, int bn, int ks, int sr,
                         int ring, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int rows_s = streams ? bk / 2 / streams : 0, tr = ks ? bk / 2 / ks : 0;
  if (form < V4 || form > MULTI || bn != BN || N % BN || K % bk || bk < 256 || bk > 2048 ||
      (bk & (bk - 1)) || (streams != 1 && streams != 2 && streams != 4) || rows < 1 ||
      rows > MAXR || a_ld % 16 || (ks != 1 && ks != 2 && ks != 4 && ks != 8) || sr < 16 ||
      sr > 64 || (sr & (sr - 1)) || tr % sr || rows_s % sr || ring < 2 || ring > 8 ||
      (bn_t && (bn_t % BN || N % bn_t || streams != 1)))
    return (int)cudaErrorInvalidValue;
  Args p;
  p.x[0] = (const int8_t*)a0; p.x[1] = (const int8_t*)a1;
  p.scale = (const float*)scale;
  p.out = (float*)out;
  p.form = form; p.K = K; p.N = N; p.bk = bk; p.bn_t = bn_t; p.streams = streams;
  p.rows = rows; p.ks = ks; p.sr = sr; p.ring = ring;
  const Layout L(p);
  Maps maps;
  const void* w[4] = {w0, w1, w2, w3};
  const void* a[4] = {a0, a1, a2, a3};
  for (int s = 0; s < streams; ++s) {
    const int wrows = bn_t ? (K / bk) * (N / bn_t) * (bk / 2) : K / 2 / streams;
    const int wcols = bn_t ? bn_t : N;
    int e = l3q::tensor_map_u8(&maps.w[s], w[s], wrows, wcols, wcols, sr, BN,
                               CU_TENSOR_MAP_SWIZZLE_128B);
    if (!e && form != V4)
      e = l3q::tensor_map_u8(&maps.a[s], a[s], rows, a_ld, a_ld, rows, L.obw,
                             l3q::row_swizzle(L.obw));
    if (e) return e;
  }
  return L.nt == 1 ? launch<1>(p, maps, st) : L.nt == 2 ? launch<2>(p, maps, st) : launch<4>(p, maps, st);
}
