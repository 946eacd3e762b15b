// Quantized-KV single-token GQA flash decode: kernel B4/B5.
//
// Replaces the TPU kernels `_decode_kernel_s8` / `_decode_kernel_s8_stacked`
// (llama3_quantization_tpu/ops/decode_attention.py:87,274) for the int8
// cache and the T-pair-packed int4 cache, with the optional online-softmax
// statistics (`return_stats`, :208-210) that the windowed decode merges.
// The stacked form B5 is this kernel on the layer view cache[l], which the
// caller passes as a pointer offset (no copy).
//
// Per (b, g) pair, over T blocks of `bt` tokens in order (as the TPU grid):
//   qs = max(amax|q|, 1e-8)/A, qc = clip(rint(q/qs), +-A)
//   s  = f32(qc . k_code) * (qs/sqrt(d)) * k_s + mask           (s32 dot)
//   online softmax: m_new, alpha = exp(m_prev - m_new), p = exp(s - m_new)
//   p*v_s re-quantized to s8 per row per block: ps = max(amax, 1e-20)/A
//   acc = acc*alpha + f32(pc . v_code)*ps;  out = acc / max(l, 1e-30)
// with A = 127 for the int8 cache and 119 for int4 (the TPU splits each s8
// operand into two exact int4 rows, which needs |x| <= 119). Rounding is
// half to even (rintf) and the float steps use the _rn intrinsics, so no
// multiply-add is contracted into an FMA that the TPU kernel does not do.
// With stats, m and l are written after the last block: an all-masked row
// (mask -1e30 everywhere) ends with m = -1e30 and l = T, which the merge
// weights out through exp(m - m*).
//
// What bounds it on the H100: it reads 2*(D + 4) bytes (int8) or
// 2*(D/2 + 4) bytes (int4) per cached token per (b, g) and does about 8
// integer operations per byte, far below the card's ridge: HBM bytes. But
// a decode step's cache is small (1.1 MB at B = 1, T = 512, G = 8, D =
// 128: 0.33 us of HBM time), so what sets the time is the latency of a
// chain of dependent steps: the design spreads each T block over the SMs
// and keeps that chain short.
//
// The design: each (b, g) pair is one thread-block cluster of S blocks
// (`s8_split_plan` in ops/decode_attention.py: S from the T block alone,
// at most 8, never from B, so a row's o, m and l do not depend on the
// batch). Block `rank` owns tokens [rank*sl, (rank+1)*sl) of every T block
// and the output columns [rank*D/S, (rank+1)*D/S). Within a T block the
// split is exact but for the order of the fp32 sum l: the row max and the
// amax of p*v_s are maxima, each probability code depends only on its
// token and those two, and the PV dot is an exact s32 sum. So the T
// blocks stay sequential and every quantization point stays where it is.
// Each block first issues bulk copies (cp.async.bulk on mbarriers) of its
// K and V slices in chunks of up to 64 tokens, a ring of 4 that runs ahead
// into the next T blocks, and of its k_s, v_s and mask slices; then it
// quantizes q. Per T block:
//   1. the scores of its slice with mma.sync m16n8k32 s8 (the tokens as
//      the 16-row operand through ldmatrix, the rep q rows padded to 8);
//   2. its slice row maxima to every block of the cluster;
//   3. p, its slice sum and the amax of p*v_s, one warp per q row (the rep
//      rows at once, warp reductions); the amax and the sum to every block;
//   4. its codes and the PV partial of its slice for every column
//      (mma.sync, V^T as the 16-row operand through ldmatrix.trans); each
//      s32 partial to the block that owns its column, which sums them in
//      rank order and updates its acc. l adds the slice sums in rank order.
// The exchanges are DSMEM stores (st.async) that count their bytes on an
// mbarrier of the receiving block: a block waits for what it receives, not
// for a cluster barrier, and only one cluster barrier, at the start, makes
// sure every block's mbarriers exist before the first store. No atomics:
// every result is deterministic.
//
// Clusters are capped at 8 blocks, the portable size, from the cluster
// sweep of `chip_smoke.py --kernel-bench` (PERF.md): 16-block clusters are
// slower at B = 8, where they make 1,024 blocks.
//
// int4 rows: byte row r holds token 2r in the low nibble and 2r+1 in the
// high nibble, for each of the D columns (ops/kvcache.kv4_pack). The
// nibbles are sign-extended to s8 with per-byte SIMD (__vsub4) into the
// same MMA fragments; the integers equal the TPU's split-row int4 dot,
// which is exact.

#include "common.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_CLUSTER = 16;
constexpr int CHUNK = 64;    // tokens per bulk copy (one K or V load)
constexpr int MAX_RING = 4;  // loads in flight
constexpr bool COPIES_ONLY = (L3Q_ABLATE & 512) != 0;

// Shapes and shared-memory layout of one launch, from (rep, int4, T, D,
// bt, S) on the host.
struct Plan {
  int S, sl, nt, chunk, nc;       // cluster, slice, T blocks, chunk tokens, chunks a slice
  int region, ring, ds;            // bytes a ring slot, loads in flight, output columns a block
  int sst, pst, qst, slr;          // row strides: scores, codes, q codes; scale slice
  int o_sc, o_p, o_q, o_scale, o_xmax, o_xamax, o_xl, o_xpv, o_acc, o_row, o_bar, smem;
};

constexpr int up(int x, int m) { return (x + m - 1) / m * m; }

Plan make_plan(int rep, bool int4, int T, int D, int bt, int S) {
  Plan P{};
  P.S = S;
  P.sl = bt / S;
  P.nt = T / bt;
  P.chunk = std::min(P.sl, CHUNK);
  P.nc = (P.sl + P.chunk - 1) / P.chunk;
  // rows of D bytes; a slot holds its chunk rounded up to 32 tokens (the PV
  // k step) and the 16 bytes a 32-byte q step reads past row D of the last
  P.region = up(up(P.chunk, 32) / (int4 ? 2 : 1) * D + 16, 128);
  P.ring = std::min(MAX_RING, P.nt * 2 * P.nc);
  P.ds = D / S;
  const int slp = up(P.sl, 32);
  P.sst = slp + 4;                 // lanes of a fragment on distinct banks
  P.pst = up(slp, 128) + 16;       // 8 rows x 4 words of a B fragment: distinct banks
  P.qst = up(up(D, 32), 128) + 16;
  P.slr = up(P.sl, 4);
  int o = P.ring * P.region;
  P.o_sc = o;     o += up(rep * P.sst * 4, 16);
  P.o_p = o;      o += 8 * P.pst;
  P.o_q = o;      o += 8 * P.qst;
  P.o_scale = o;  o += 2 * 3 * P.slr * 4;
  P.o_xmax = o;   o += MAX_CLUSTER * 8 * 4;
  P.o_xamax = o;  o += MAX_CLUSTER * 8 * 4;
  P.o_xl = o;     o += MAX_CLUSTER * 8 * 4;
  P.o_xpv = o;    o += up(rep * D * 4, 16);
  P.o_acc = o;    o += up(rep * P.ds * 4, 16);
  P.o_row = o;    o += 4 * 8 * 4;  // qsc, alpha, ps, l by row
  P.o_bar = o;    o += (P.ring + 5) * 8;  // ring, scale slices, exchanges
  P.smem = o;
  return P;
}

enum { QSC = 0, ALPHA = 8, PS = 16, LSUM = 24 };

__device__ __forceinline__ float quant(float v, float s, float a) {
  return fminf(fmaxf(rintf(__fdiv_rn(v, s)), -a), a);
}

// Low / high nibbles of the four bytes of w, each sign-extended to s8.
__device__ __forceinline__ uint32_t nib_lo(uint32_t w) {
  return __vsub4((w & 0x0F0F0F0Fu) ^ 0x08080808u, 0x08080808u);
}
__device__ __forceinline__ uint32_t nib_hi(uint32_t w) {
  return __vsub4(((w >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u, 0x08080808u);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int REP, bool INT4>
__global__ void __launch_bounds__(THREADS, 8) decode_s8_kernel(
    const void* __restrict__ q, int q_bf16, const uint8_t* __restrict__ kq,
    const uint8_t* __restrict__ vq, const float* __restrict__ ks,
    const float* __restrict__ vs, const float* __restrict__ mask, void* __restrict__ out,
    int out_bf16, float* __restrict__ m_out, float* __restrict__ l_out, int G, int T, int D,
    int bt, int bulk, float inv_sqrt_d, float amax, const Plan P) {
  extern __shared__ __align__(1024) unsigned char smem[];
  unsigned char* ring = smem;                                   // [ring] code chunks
  float* Ssc = reinterpret_cast<float*>(smem + P.o_sc);         // [REP][sst] s, then p*v_s
  int8_t* Psm = reinterpret_cast<int8_t*>(smem + P.o_p);        // [8][pst] p codes
  int8_t* Qsm = reinterpret_cast<int8_t*>(smem + P.o_q);        // [8][qst] q codes
  float* scl = reinterpret_cast<float*>(smem + P.o_scale);      // [2][k_s, v_s, mask][slr]
  float* xmax = reinterpret_cast<float*>(smem + P.o_xmax);      // [sender][8] slice maxima
  float* xamax = reinterpret_cast<float*>(smem + P.o_xamax);    // [sender][8] slice amax
  float* xl = reinterpret_cast<float*>(smem + P.o_xl);          // [sender][8] slice sums
  int* xpv = reinterpret_cast<int*>(smem + P.o_xpv);            // [sender][REP][ds]
  float* acc = reinterpret_cast<float*>(smem + P.o_acc);        // [REP][ds]
  float* rowv = reinterpret_cast<float*>(smem + P.o_row);       // [4][8]
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + P.o_bar); // [ring]
  uint64_t* sbar = full + P.ring;                               // [2] scale slices
  uint64_t* xbar = sbar + 2;  // [3] exchanges landed: maxima; amax and sums; PV partials

  const int rank = blockIdx.x, g = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, gid = lane >> 2, tig = lane & 3;
  const int S = P.S, sl = P.sl, hq = G * REP, ds = P.ds;
  const size_t bg = (size_t)b * G + g;
  const int nloads = P.nt * 2 * P.nc;
  constexpr int R = INT4 ? 2 : 1;

  // load n: T block n / (2 nc), K (0) or V (1), chunk n % nc
  auto issue = [&](int n) {
    const int j = n / (2 * P.nc), part = (n / P.nc) & 1, c = n % P.nc, slot = n % P.ring;
    const size_t row = (bg * T + j * bt + rank * sl + c * P.chunk) / R;
    const uint32_t bytes = min(P.chunk, sl - c * P.chunk) / R * D;
    l3q::mbar_expect_tx(full + slot, bytes);
    l3q::bulk_load(ring + slot * P.region, (part ? vq : kq) + row * D, bytes, full + slot);
  };
  // what every block of the cluster sends here in exchange k of a T block,
  // announced before any of it can come: for the first block at the start,
  // for the next once this one has landed
  const uint32_t xbytes[3] = {(uint32_t)(S * REP * 4), (uint32_t)(2 * S * REP * 4),
                              (uint32_t)(S * REP * ds * 4)};
  auto exchange_wait = [&](int k, int j) {
    l3q::mbar_wait(xbar + k, j & 1);
    if (tid == 0 && j + 1 < P.nt) l3q::mbar_expect_tx(xbar + k, xbytes[k]);
  };
  auto issue_scales = [&](int j) {
    float* dst = scl + (j & 1) * 3 * P.slr;
    const size_t o = bg * T + j * bt + rank * sl;
    const uint32_t nb = sl * 4;
    l3q::mbar_expect_tx(sbar + (j & 1), 3 * nb);
    l3q::bulk_load(dst, ks + o, nb, sbar + (j & 1));
    l3q::bulk_load(dst + P.slr, vs + o, nb, sbar + (j & 1));
    l3q::bulk_load(dst + 2 * P.slr, mask + (size_t)b * T + j * bt + rank * sl, nb, sbar + (j & 1));
  };

  if (tid == 0) {
    l3q::mbar_init_n(full, P.ring + 5);
    for (int n = 0; n < P.ring; ++n) issue(n);
    if (!COPIES_ONLY)
      for (int k = 0; k < 3; ++k) l3q::mbar_expect_tx(xbar + k, xbytes[k]);
    if (bulk) {
      issue_scales(0);
      if (P.nt > 1) issue_scales(1);
    }
  }
  // q rows (warp and warp + 4) in flight beside the copies
  float qv[2][8];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = warp + WARPS * i;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int d = lane + 32 * k;
      qv[i][k] = 0.f;
      if (r < REP && d < D) {
        const size_t qi = ((size_t)b * hq + g * REP + r) * D + d;
        qv[i][k] = q_bf16 ? __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(q)[qi])
                          : reinterpret_cast<const float*>(q)[qi];
      }
    }
  }
  if (!COPIES_ONLY) l3q::cluster_arrive_relaxed();

  // q codes (rows >= REP and columns >= D zero), zeroed p codes and acc
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = warp + WARPS * i;
    int8_t* qr = Qsm + r * P.qst;
    float qa = 0.f;
#pragma unroll
    for (int k = 0; k < 8; ++k) qa = fmaxf(qa, fabsf(qv[i][k]));
    const float qs = __fdiv_rn(fmaxf(warp_max(qa), 1e-8f), amax);
#pragma unroll
    for (int k = 0; k < 9; ++k) {  // qst <= 272
      const int d = lane + 32 * k;
      if (d < P.qst) qr[d] = (r < REP && d < D) ? (int8_t)quant(qv[i][k < 8 ? k : 7], qs, amax) : 0;
    }
    if (lane == 0 && r < REP) rowv[QSC + r] = __fmul_rn(qs, inv_sqrt_d);
  }
  for (int i = tid; i < 8 * P.pst / 16; i += THREADS) reinterpret_cast<int4*>(Psm)[i] = make_int4(0, 0, 0, 0);
  for (int e = tid; e < REP * ds; e += THREADS) acc[e] = 0.f;
  // the running m and l of this warp's rows (warp, warp + 4), in every lane
  float m_run[2] = {-1e30f, -1e30f}, l_run[2] = {0.f, 0.f};
  __syncthreads();

  const int KS = (D + 31) / 32, DT = D / 16;
  for (int j = 0; j < P.nt; ++j) {
    const float* ksb = scl + (j & 1) * 3 * P.slr;
    const float* vsb = ksb + P.slr;
    const float* mkb = vsb + P.slr;
    if (bulk) {
      l3q::mbar_wait(sbar + (j & 1), (j >> 1) & 1);
    } else {
      const size_t o = bg * T + j * bt + rank * sl;
      float* dst = scl + (j & 1) * 3 * P.slr;
      for (int t = tid; t < sl; t += THREADS) {
        dst[t] = ks[o + t];
        dst[P.slr + t] = vs[o + t];
        dst[2 * P.slr + t] = mask[(size_t)b * T + j * bt + rank * sl + t];
      }
      __syncthreads();
    }

    // 1. scores of this block's slice, chunk by chunk
    for (int c = 0; c < P.nc; ++c) {
      const int n = 2 * j * P.nc + c, slot = n % P.ring;
      l3q::mbar_wait(full + slot, (n / P.ring) & 1);
      const unsigned char* kt = ring + slot * P.region;
      const int ct = min(P.chunk, sl - c * P.chunk);
      for (int tile = warp; !COPIES_ONLY && tile * 16 < ct; tile += WARPS) {
        int s32[4] = {0, 0, 0, 0};
        for (int k = 0; k < KS; ++k) {
          uint32_t a[4], bq[2];
          if (!INT4) {
            const int row = tile * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
            l3q::ldmatrix_x4(a, kt + row * D + 32 * k + (lane >> 4) * 16);
          } else {
            const int row = tile * 8 + gid;
            const uint32_t w0 = *reinterpret_cast<const uint32_t*>(kt + row * D + 32 * k + 4 * tig);
            const uint32_t w1 = *reinterpret_cast<const uint32_t*>(kt + row * D + 32 * k + 16 + 4 * tig);
            a[0] = nib_lo(w0);
            a[1] = nib_hi(w0);
            a[2] = nib_lo(w1);
            a[3] = nib_hi(w1);
          }
          bq[0] = *reinterpret_cast<const uint32_t*>(Qsm + gid * P.qst + 32 * k + 4 * tig);
          bq[1] = *reinterpret_cast<const uint32_t*>(Qsm + gid * P.qst + 32 * k + 16 + 4 * tig);
          l3q::mma_s8_16832(s32, a, bq);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = 2 * tig + (e & 1);
          const int tl = INT4 ? tile * 16 + 2 * gid + (e >> 1) : tile * 16 + gid + 8 * (e >> 1);
          if (r < REP && tl < ct) {
            const int t = c * P.chunk + tl;
            Ssc[r * P.sst + t] = __fadd_rn(
                __fmul_rn(__fmul_rn((float)s32[e], rowv[QSC + r]), ksb[t]), mkb[t]);
          }
        }
      }
      __syncthreads();
      if (tid == 0 && n + P.ring < nloads) issue(n + P.ring);
    }

    // 2. the block's row max over the cluster
    float alpha[2] = {1.f, 1.f}, m_new[2] = {0.f, 0.f};
    if (!COPIES_ONLY) {
      if (j == 0) l3q::cluster_wait();  // every block has started
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = warp + WARPS * i;
        if (row >= REP) continue;
        float lm = -INFINITY;
#pragma unroll 4
        for (int t = lane; t < sl; t += 32) lm = fmaxf(lm, Ssc[row * P.sst + t]);
        lm = warp_max(lm);
        if (lane < S) l3q::st_async_u32(xmax + rank * 8 + row, xbar, lane, __float_as_uint(lm));
      }
      exchange_wait(0, j);

      // 3. p, the slice sums and the amax of p * v_s
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = warp + WARPS * i;
        if (row >= REP) continue;
        const float mb = warp_max(lane < S ? xmax[lane * 8 + row] : -INFINITY);
        m_new[i] = fmaxf(m_run[i], mb);
        alpha[i] = expf(__fsub_rn(m_run[i], m_new[i]));
        float lsum = 0.f, la = 0.f;
#pragma unroll 4
        for (int t = lane; t < sl; t += 32) {
          const float p = expf(__fsub_rn(Ssc[row * P.sst + t], m_new[i]));
          lsum += p;
          const float pv = __fmul_rn(p, vsb[t]);
          Ssc[row * P.sst + t] = pv;
          la = fmaxf(la, fabsf(pv));
        }
        lsum = warp_sum(lsum);
        la = warp_max(la);
        if (lane < S) {
          l3q::st_async_u32(xamax + rank * 8 + row, xbar + 1, lane, __float_as_uint(la));
          l3q::st_async_u32(xl + rank * 8 + row, xbar + 1, lane, __float_as_uint(lsum));
        }
      }
      exchange_wait(1, j);

      // 4a. the block's ps, l in rank order, this slice's p codes
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = warp + WARPS * i;
        if (row >= REP) continue;
        const float ps = __fdiv_rn(fmaxf(warp_max(lane < S ? xamax[lane * 8 + row] : 0.f), 1e-20f), amax);
        float lb = xl[row];
#pragma unroll 4
        for (int r = 1; r < S; ++r) lb = __fadd_rn(lb, xl[r * 8 + row]);
        l_run[i] = __fadd_rn(__fmul_rn(l_run[i], alpha[i]), lb);
        m_run[i] = m_new[i];
#pragma unroll 4
        for (int t = lane; t < sl; t += 32)
          Psm[row * P.pst + t] = (int8_t)quant(Ssc[row * P.sst + t], ps, amax);
        if (lane == 0) {
          rowv[ALPHA + row] = alpha[i];
          rowv[PS + row] = ps;
          rowv[LSUM + row] = l_run[i];
        }
      }
      __syncthreads();
    }

    // 4b. PV partials of the slice for every column: V^T as the 16-row
    // operand (rows 16 dt + 2 gid and + 1), codes as the 8-column one
    int pv[4][4] = {};
    for (int c = 0; c < P.nc; ++c) {
      const int n = (2 * j + 1) * P.nc + c, slot = n % P.ring;
      l3q::mbar_wait(full + slot, (n / P.ring) & 1);
      const unsigned char* vt = ring + slot * P.region;
      const int ct = min(P.chunk, sl - c * P.chunk);
      for (int kb = 0; !COPIES_ONLY && kb < ct; kb += 32) {
        uint32_t bp[2];
        bp[0] = *reinterpret_cast<const uint32_t*>(Psm + gid * P.pst + c * P.chunk + kb + 4 * tig);
        bp[1] = *reinterpret_cast<const uint32_t*>(Psm + gid * P.pst + c * P.chunk + kb + 16 + 4 * tig);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int dt = warp + WARPS * i;
          if (dt >= DT) break;
          uint32_t a[4];
          if (!INT4) {
            // matrix mi, row j: token kb + 16 (mi >> 1) + 4 (j >> 1) + 2 (mi & 1) + (j & 1),
            // so that a lane's two matrices give it four consecutive tokens
            const int mi = lane >> 3, jr = lane & 7;
            const int tok = kb + 16 * (mi >> 1) + 4 * (jr >> 1) + 2 * (mi & 1) + (jr & 1);
            uint32_t r4[4];
            l3q::ldmatrix_x4_trans(r4, vt + tok * D + 16 * dt);
            a[0] = __byte_perm(r4[0], r4[1], 0x6420);
            a[1] = __byte_perm(r4[0], r4[1], 0x7531);
            a[2] = __byte_perm(r4[2], r4[3], 0x6420);
            a[3] = __byte_perm(r4[2], r4[3], 0x7531);
          } else {
            uint32_t r2[2];
            l3q::ldmatrix_x2_trans(r2, vt + (kb / 2 + (lane & 15)) * D + 16 * dt);
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const uint32_t lo = nib_lo(r2[h]), hi = nib_hi(r2[h]);
              a[2 * h] = __byte_perm(lo, hi, 0x6240);
              a[2 * h + 1] = __byte_perm(lo, hi, 0x7351);
            }
          }
          l3q::mma_s8_16832(pv[i], a, bp);
        }
      }
      __syncthreads();
      if (tid == 0 && n + P.ring < nloads) issue(n + P.ring);
    }
    if (bulk && tid == 0 && j + 2 < P.nt) issue_scales(j + 2);  // buffer j & 1 is read
    if (COPIES_ONLY) continue;

    // 4c. each partial to the block that owns its column; sum in rank order
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int dt = warp + WARPS * i;
      if (dt >= DT) break;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = 2 * tig + (e & 1), d = 16 * dt + 2 * gid + (e >> 1);
        if (r >= REP) continue;
        const int owner = d / ds;
        l3q::st_async_u32(xpv + (rank * REP + r) * ds + d - owner * ds, xbar + 2, owner,
                          (uint32_t)pv[i][e]);
      }
    }
    exchange_wait(2, j);
    for (int e = tid; e < REP * ds; e += THREADS) {
      const int r = e / ds, col = e - r * ds;
      int s = 0;
#pragma unroll 4
      for (int x = 0; x < S; ++x) s += xpv[(x * REP + r) * ds + col];
      acc[e] = __fadd_rn(__fmul_rn(acc[e], rowv[ALPHA + r]), __fmul_rn((float)s, rowv[PS + r]));
    }
  }

  for (int e = tid; e < REP * ds; e += THREADS) {
    const int r = e / ds, col = e - r * ds;
    const float v = __fdiv_rn(acc[e], COPIES_ONLY ? 1.f : fmaxf(rowv[LSUM + r], 1e-30f));
    l3q::store_out(out, ((size_t)b * hq + g * REP + r) * D + rank * ds + col, v, out_bf16);
  }
  if (m_out != nullptr && rank == 0 && lane == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = warp + WARPS * i;
      if (row >= REP) continue;
      m_out[bg * REP + row] = m_run[i];
      l_out[bg * REP + row] = l_run[i];
    }
  }
}

template <int REP, bool INT4>
int launch(const void* q, int q_bf16, const void* kq, const void* ks, const void* vq,
           const void* vs, const void* mask, void* out, int out_bf16, void* m_out, void* l_out,
           int B, int G, int T, int D, int bt, int S, float inv_sqrt_d, float amax,
           cudaStream_t st) {
  const Plan P = make_plan(REP, INT4, T, D, bt, S);
  auto kernel = decode_s8_kernel<REP, INT4>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, P.smem);
  if (e == cudaSuccess && S > 8)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return (int)e;
  const int bulk = P.sl % 4 == 0 && ((uintptr_t)ks | (uintptr_t)vs | (uintptr_t)mask) % 16 == 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(S, G, B);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = P.smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, kernel, q, q_bf16, (const uint8_t*)kq,
                                 (const uint8_t*)vq, (const float*)ks,
                                 (const float*)vs, (const float*)mask, out, out_bf16,
                                 (float*)m_out, (float*)l_out, G, T, D, bt, bulk, inv_sqrt_d,
                                 amax, P);
}

template <bool INT4>
int launch_rep(int rep, const void* q, int q_bf16, const void* kq, const void* ks,
               const void* vq, const void* vs, const void* mask, void* out, int out_bf16,
               void* m_out, void* l_out, int B, int G, int T, int D, int bt, int S,
               float inv_sqrt_d, float amax, cudaStream_t st) {
  switch (rep) {
    case 1: return launch<1, INT4>(q, q_bf16, kq, ks, vq, vs, mask, out, out_bf16, m_out, l_out, B, G, T, D, bt, S, inv_sqrt_d, amax, st);
    case 2: return launch<2, INT4>(q, q_bf16, kq, ks, vq, vs, mask, out, out_bf16, m_out, l_out, B, G, T, D, bt, S, inv_sqrt_d, amax, st);
    case 4: return launch<4, INT4>(q, q_bf16, kq, ks, vq, vs, mask, out, out_bf16, m_out, l_out, B, G, T, D, bt, S, inv_sqrt_d, amax, st);
    case 8: return launch<8, INT4>(q, q_bf16, kq, ks, vq, vs, mask, out, out_bf16, m_out, l_out, B, G, T, D, bt, S, inv_sqrt_d, amax, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q [B, G*rep, D] (bf16 or fp32); kq/vq int8 [B, G, T, D], or with int4 = 1
// uint8 [B, G, T/2, D] (T-pair-packed nibbles), 16-byte aligned; ks/vs fp32
// [B, G, T]; mask fp32 [B, T] (finite); out [B, G*rep, D]; m_out/l_out fp32
// [B, G, rep] or null for no stats. amax is 127 (int8) or 119 (int4).
// D % 16 == 0, D <= 256, T % bt == 0, rep in {1, 2, 4, 8}; `cluster` (the
// plan's S) in {1, 2, 4, 8, 16} divides bt into slices, even for int4.
extern "C" int l3q_decode_s8(const void* q, int q_bf16, const void* kq, const void* ks,
                             const void* vq, const void* vs, const void* mask, void* out,
                             int out_bf16, void* m_out, void* l_out, int B, int G, int rep,
                             int T, int D, int bt, int cluster, int int4, float inv_sqrt_d,
                             float amax, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int S = cluster;
  if (D % 16 || D > 256 || bt <= 0 || T % bt || (m_out == nullptr) != (l_out == nullptr) ||
      S < 1 || S > MAX_CLUSTER || (S & (S - 1)) || bt % S || (int4 && (bt / S) % 2) ||
      ((uintptr_t)kq | (uintptr_t)vq) % 16)
    return (int)cudaErrorInvalidValue;
  if (int4)
    return launch_rep<true>(rep, q, q_bf16, kq, ks, vq, vs, mask, out, out_bf16, m_out, l_out, B, G, T, D, bt, S, inv_sqrt_d, amax, st);
  return launch_rep<false>(rep, q, q_bf16, kq, ks, vq, vs, mask, out, out_bf16, m_out, l_out, B, G, T, D, bt, S, inv_sqrt_d, amax, st);
}
