// Causal flash attention backward: kernels B7.dkv and B7.dq.
//
// Replace the Pallas TPU library's backward kernels, which run wherever the
// JAX package differentiates through `_flash_attention`
// (llama3_quantization_tpu/models/transformer.py:168-181; OmniQuant's block
// loss, quant/omniquant.py:379, and the sharded LWC step,
// parallel/train.py:101): `_flash_attention_dkv_kernel` (flash_attention.py
// :796, via `_flash_attention_bwd_dkv` :941, call :1121) and
// `_flash_attention_dq_kernel` (:1146, via `_flash_attention_bwd_dq` :1287,
// call :1456). Both recompute
//
//   p  = exp(q k^T * scale + mask - m) * (1 / l)      (m, l from B7.stats)
//   ds = (do v^T - di) * p * scale                    (di = sum(o * do))
//
// and form dv = p^T do, dk = ds^T q (B7.dkv) and dq = ds k (B7.dq), with p
// and ds rounded to bf16 only as operands of their products, every product
// summed in fp32, the scale multiplied in before the mask and exp(s - m)
// taken before the multiplication by 1 / l, as the library does (dkv
// :900,918, dq :1258). Masked logits take the library's DEFAULT_MASK_VALUE
// (-0.7 * float32 max), so their p is 0.
//
// Layouts are the model's: q/do/dq [B, S, H, D], k/v/dk/dv [B, S, G, D],
// bf16; m, l, di [B, H, S] fp32. Query head h reads K/V group h / (H / G) in
// place. The library runs on K/V repeated per query head and sums the rep
// heads' dk/dv through the repeat's transpose, each rounded to bf16 first;
// B7.dkv sums a group's rep heads in fp32 in the block and rounds once.
//
// What bounds them on the H100: the tensor cores. B7.dkv does 4 products
// (q k^T, do v^T, p^T do, ds^T q) and B7.dq 3 (q k^T, do v^T, ds k) of 2 * D
// FLOPs per causal (q, k) pair, 8 * D and 6 * D in all, on about
// 2 * S * D * (2 H + 2 G) bytes. Their first form (mma.sync fed by scalar
// shared loads, plain synchronous tile copies between block barriers, one
// warpgroup a block) reached 12% and 19% of those bounds. This form has the
// Hopper shape of B7's forward, and reaches about 45% of both (B7.dkv
// 0.30 ms, B7.dq 0.23 ms at OmniQuant's [2, 2048, 32, 8, 128] on an H100
// at 700 W; PERF.md):
//
// - Tiles come by TMA, in the 128-byte swizzle, on mbarriers, a ring of
//   DKV_STAGES / DQ_STAGES stages ahead of two consumer warpgroups, which
//   release a stage once their products on it are done. Rows past S read
//   as zeros: the maps are 4-D, cut at S per batch.
// - Every product is a wgmma, with both operands' tiles read from shared
//   memory by descriptor, or with P / dS from registers: the same swizzled
//   block is a K-major operand where a product contracts d and an MN-major
//   one (transpose bit) where it contracts rows (flash_wgmma.cuh).
// - Only tiles that cross the diagonal or the sequence's end are masked.
// - Both copy only what the products read, once per block: at this shape
//   the copies alone (L3Q_ABLATE=2048) take 36% (B7.dkv) and 41% (B7.dq)
//   of the kernel's time, the L2 serving each block its q (B7.dkv) or k /
//   v (B7.dq) tiles, and overlap the products.
//
// B7.dkv: one block per (128-key tile, K/V group, batch), launched from the
// first key tile (the one with the most q rows) on. K and V are loaded once
// and stay in shared memory. Each ring stage holds a 64-row Q tile and its
// dO tile; the ring walks the group's rep heads and, for each, the q tiles
// from the block's diagonal on. Warpgroup w holds keys 64 w .. 64 w + 63
// and, per stage, runs S^T = K Q^T and dP^T = V dO^T as wgmma m64n64k16 (K
// and V the A operands, Q and dO K-major B operands), forms P^T and dS^T in
// fp32 registers and rounds them to bf16 as register A operands of dV +=
// P^T dO and dK += dS^T Q (m64nDk16, dO and Q MN-major). dK and dV stay in
// fp32 registers across every rep head and are written once: no atomics,
// one order. The two warpgroups take turns to issue their S^T and dP^T
// products (named barriers), so one's exp overlaps the other's products
// (a few percent faster than no order, measured). Registers set the
// block's shape: a thread holds 2 x (64 + 64) fp32 accumulators at D = 128
// and needs 236 registers, which a block of 256 threads allows and one of
// 288 (two consumer warpgroups and a producer warp) does not: an SM
// sub-partition's 16,384 registers cap 3 warps at 168 each, and ptxas does
// not compile a consumer region for more after a setmaxnreg exchange
// (measured: the same spills at every setmaxnreg setting tried). So there
// is no producer warp: thread 0 issues the TMA copies, refilling the
// previous step's slot DKV_STAGES - 1 steps ahead, and each warpgroup's
// first 64 threads bring the next step's m, l and di by 4-byte cp.async
// (zeros past S) and form 1 / l (1 past S, so a row past S gives p = 1
// times a zero dO: never inf * 0). A producer warp that loaded those rows
// itself paced the ring with its synchronous loads: its copies alone took
// over twice as long.
//
// B7.dq: one block per (128 q rows, query head, batch), the q tiles with
// the most key tiles first and a group's rep heads side by side (they read
// the same K and V, in L2). Q, dO and the rows' m, 1 / l and di are loaded
// once; one producer warp keeps the ring of the group's 64-key K and V
// tiles up to the diagonal. Warpgroup w holds rows 64 w .. 64 w + 63 and
// runs S = Q K^T and dP = dO V^T as wgmma m64n64k16 from shared memory,
// forms P while dP lands, then dS, and adds dQ += dS K (m64nDk16, K
// MN-major). It needs 166 registers, so it keeps its producer warp; taking
// turns made it a few percent slower, and so did dropping the producer
// warp to hold Q and dO as register A operands of S and dP (half the
// shared-memory reads: shared memory's bandwidth does not set its pace).

#include "flash_wgmma.cuh"

namespace {

constexpr float MASK_VALUE = -0.7f * 3.402823466e38f;  // the library's DEFAULT_MASK_VALUE
constexpr int TILE = 64 * 128;  // bytes of a [64 rows][64 d] bf16 block, 128-byte swizzled
constexpr int NWG = 2;          // consumer warpgroups a block
constexpr int MMA_THREADS = NWG * 128;
// B7.dkv: 64 keys a warpgroup, 64-row q stages; no producer warp (see the
// note at the head of the file)
constexpr int DKV_KEYS = 64 * NWG, DKV_STAGES = 4, DKV_THREADS = MMA_THREADS;
// its named barriers (0 is __syncthreads): BAR_STATS + w, warpgroup w's
// rows' statistics are in shared memory; BAR_TURN + w, warpgroup w may
// issue its S^T and dP^T products
constexpr int BAR_STATS = 1, BAR_TURN = 3;
// B7.dq: 64 rows a consumer warpgroup, 64-key stages; one producer warp
constexpr int DQ_ROWS = 64 * NWG, DQ_STAGES = 3, DQ_THREADS = MMA_THREADS + 32;

// K-major descriptor of k step ks (16 d) of a tile, given its 64-d block
// ks / 4: 32 bytes a step along the block's rows
__device__ __forceinline__ uint64_t kdesc(const unsigned char* block, int ks) {
  return l3q::wgmma_desc(block + (ks & 3) * 32, 16, 1024);
}

// A 4-byte copy from global to shared memory, zeros where !valid (the
// source is then not read)
__device__ __forceinline__ void cp_async4_zfill(void* smem, const void* gmem, bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem),
               "r"(valid ? 4 : 0));
}

template <int D>
__device__ __forceinline__ void wgmma_rs_nd(float* acc, const uint32_t* a, uint64_t db) {
  if constexpr (D == 128) wgmma_rs_n128(acc, a, db);
  else wgmma_rs_n64(acc, a, db);
}

// P^T / dS^T (or dS) as the m16n8k16 A fragments of the next product:
// accumulator 4 j + e is row g + 8 (e / 2), column 8 j + 2 t + e % 2, and
// fragment [kc][r] holds columns 16 kc + 8 (r / 2) + 2 t + {0, 1} of row
// g + 8 (r % 2)
__device__ __forceinline__ void pack_a(uint32_t (&a)[4][4], int j, float x0, float x1, float x2,
                                       float x3) {
  a[j >> 1][(j & 1) * 2] = l3q::pack_bf16x2(x0, x1);
  a[j >> 1][(j & 1) * 2 + 1] = l3q::pack_bf16x2(x2, x3);
}

template <int D>
__global__ void __launch_bounds__(DKV_THREADS, 1) flash_bwd_dkv_kernel(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
    const float* __restrict__ m, const float* __restrict__ l, const float* __restrict__ di,
    __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int S, int H, int G,
    float scale) {
  constexpr int DB = D / 64, KB = DKV_KEYS * 128;  // bytes of a [128 keys][64 d] block
  extern __shared__ __align__(1024) unsigned char smem[];
  unsigned char* Ks = smem;                         // [DB] blocks of 128 keys
  unsigned char* Vs = Ks + DB * KB;                 // [DB]
  unsigned char* Qs = Vs + DB * KB;                 // [STAGES][DB] blocks of 64 rows
  unsigned char* Os = Qs + DKV_STAGES * DB * TILE;  // [STAGES][DB]: dO
  // [NWG][step parity][m, 1/l, di][64]: each warpgroup's copy of its
  // step's rows and the next step's
  float* stats = reinterpret_cast<float*>(Os + DKV_STAGES * DB * TILE);
  uint64_t* full = reinterpret_cast<uint64_t*>(stats + NWG * 2 * 3 * 64);  // [STAGES]
  uint64_t* empty = full + DKV_STAGES;                                     // [STAGES]
  uint64_t* kvbar = empty + DKV_STAGES;

  // blockIdx.x walks (group, batch), blockIdx.y the key tiles from the first
  const int gk = blockIdx.x % G, b = blockIdx.x / G, k0 = blockIdx.y * DKV_KEYS;
  const int rep = H / G, nq = (S - k0 + 63) / 64, steps = rep * nq;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wg = warp >> 2, wt = tid & 127, g = lane >> 2, t4 = lane & 3;

  // Step u: head gk * rep + u / nq, q tile from row k0 + 64 (u % nq). Its
  // Q and dO tiles by TMA (thread 0), and its rows' m, l and di by 4-byte
  // cp.async into this warpgroup's buffer u % 2 (threads wt < 64 of each
  // warpgroup, zeros past S).
  auto load_stage = [&](int u) {
    const int r = u / nq, h = gk * rep + r, q0 = k0 + 64 * (u - r * nq), slot = u % DKV_STAGES;
    l3q::mbar_expect_tx(full + slot, 2 * DB * TILE);
    for (int db = 0; db < DB; ++db) {
      l3q::tma_load_4d(Qs + (slot * DB + db) * TILE, &tq, 64 * db, h, q0, b, full + slot);
      l3q::tma_load_4d(Os + (slot * DB + db) * TILE, &tdo, 64 * db, h, q0, b, full + slot);
    }
  };
  auto load_stats = [&](int u) {
    const int r = u / nq, row = k0 + 64 * (u - r * nq) + wt;
    const bool in = row < S;
    const size_t i = ((size_t)b * H + gk * rep + r) * S + (in ? row : 0);
    float* sb = stats + (wg * 2 + (u & 1)) * 3 * 64;
    cp_async4_zfill(sb + wt, m + i, in);
    cp_async4_zfill(sb + 64 + wt, l + i, in);
    cp_async4_zfill(sb + 128 + wt, di + i, in);
    l3q::cp_async_commit();
  };

  if (tid == 0) {
    l3q::mbar_init_n(full, DKV_STAGES);
    l3q::mbar_init_n(empty, DKV_STAGES, MMA_THREADS / 32);
    l3q::mbar_init_n(kvbar, 1);
  }
  __syncthreads();
  if (tid == 0) {
    l3q::mbar_expect_tx(kvbar, 2 * DB * KB);
    for (int db = 0; db < DB; ++db) {
      l3q::tma_load_4d(Ks + db * KB, &tk, 64 * db, gk, k0, b, kvbar);
      l3q::tma_load_4d(Vs + db * KB, &tv, 64 * db, gk, k0, b, kvbar);
    }
    for (int u = 0; u < min(DKV_STAGES, steps); ++u) load_stage(u);
  }
  if (wt < 64) load_stats(0);

  const int kw0 = k0 + 64 * wg;                          // this warpgroup's first key
  const int kr0 = kw0 + 16 * (warp & 3) + g, kr1 = kr0 + 8;  // this thread's keys
  float adk[D / 2], adv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) adk[i] = adv[i] = 0.f;
  const unsigned char* Kw = Ks + wg * TILE;  // rows 64 wg.. of each 128-key block
  const unsigned char* Vw = Vs + wg * TILE;
  mbar_wait_or_trap(kvbar, 0);
  if (wg == 1) l3q::bar_arrive(BAR_TURN, 256);  // warpgroup 0 issues first
  for (int t = 0, q0 = k0; t < steps; ++t) {
    const int slot = t % DKV_STAGES;
    // this step's m, 1 / l (1 past S: p = 1 times a zero dO, never inf * 0)
    // and di, shared in the warpgroup; then the next step's copies start
    float* st = stats + (wg * 2 + (t & 1)) * 3 * 64;
    if (wt < 64) {
      l3q::cp_async_wait<0>();
      st[64 + wt] = q0 + wt < S ? 1.f / st[64 + wt] : 1.f;
    }
    l3q::bar_sync(BAR_STATS + wg, 128);
    if (wt < 64 && t + 1 < steps) load_stats(t + 1);
    mbar_wait_or_trap(full + slot, (t / DKV_STAGES) & 1);
    // else every key of this warpgroup lies past S or past every row
    if (!(L3Q_ABLATE & 2048) && kw0 < S && kw0 <= q0 + 63) {
      const unsigned char* Qt = Qs + slot * DB * TILE;
      const unsigned char* Ot = Os + slot * DB * TILE;
      // S^T = K Q^T and dP^T = V dO^T, [64 keys][64 rows], two groups,
      // issued in turns with the other warpgroup (whose exp then overlaps)
      float sT[32], dpT[32];
      l3q::bar_sync(BAR_TURN + wg, 256);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks)
        wgmma_ss_n64(sT, kdesc(Kw + (ks >> 2) * KB, ks), kdesc(Qt + (ks >> 2) * TILE, ks), ks > 0);
      wgmma_commit();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks)
        wgmma_ss_n64(dpT, kdesc(Vw + (ks >> 2) * KB, ks), kdesc(Ot + (ks >> 2) * TILE, ks), ks > 0);
      wgmma_commit();
      l3q::bar_arrive(BAR_TURN + (wg ^ 1), 256);
      wgmma_wait<1>();
      fence_regs(sT);
      // P^T while dP^T lands: accumulator 4 j + e is key kr0 (e < 2) or
      // kr1, row q0 + 8 j + 2 t4 + e % 2
      const bool mask = kw0 + 63 > q0;  // the tile crosses the diagonal
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 mj = *reinterpret_cast<const float2*>(st + 8 * j + 2 * t4);
        const float2 lj = *reinterpret_cast<const float2*>(st + 64 + 8 * j + 2 * t4);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float s = __fmul_rn(sT[4 * j + e], scale);
          if (mask && ((e & 2) ? kr1 : kr0) > q0 + 8 * j + 2 * t4 + (e & 1)) s += MASK_VALUE;
          sT[4 * j + e] = __expf(s - ((e & 1) ? mj.y : mj.x)) * ((e & 1) ? lj.y : lj.x);
        }
      }
      wgmma_wait<0>();
      fence_regs(dpT);
      uint32_t pa[4][4], sa[4][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 dj = *reinterpret_cast<const float2*>(st + 128 + 8 * j + 2 * t4);
        float ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          ds[e] = (dpT[4 * j + e] - ((e & 1) ? dj.y : dj.x)) * sT[4 * j + e] * scale;
        pack_a(pa, j, sT[4 * j], sT[4 * j + 1], sT[4 * j + 2], sT[4 * j + 3]);
        pack_a(sa, j, ds[0], ds[1], ds[2], ds[3]);
      }
      // dV += P^T dO and dK += dS^T Q: the 64 rows contracted, dO and Q
      // read MN-major (k steps of 16 rows, 64-d blocks TILE apart)
      wgmma_fence();
      fence_regs(adv);
      fence_regs(adk);
#pragma unroll
      for (int kc = 0; kc < 4; ++kc)
        wgmma_rs_nd<D>(adv, pa[kc], l3q::wgmma_desc(Ot + kc * 16 * 128, TILE, 1024));
#pragma unroll
      for (int kc = 0; kc < 4; ++kc)
        wgmma_rs_nd<D>(adk, sa[kc], l3q::wgmma_desc(Qt + kc * 16 * 128, TILE, 1024));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(adv);
      fence_regs(adk);
    } else {  // the turn passes all the same
      l3q::bar_sync(BAR_TURN + wg, 256);
      l3q::bar_arrive(BAR_TURN + (wg ^ 1), 256);
    }
    if (lane == 0) l3q::mbar_arrive(empty + slot);
    // thread 0 refills the slot of the previous step, which the other
    // warpgroup has most likely left by now, DKV_STAGES - 1 steps ahead
    const int u = t - 1 + DKV_STAGES;
    if (tid == 0 && t >= 1 && u < steps) {
      mbar_wait_or_trap(empty + (t - 1) % DKV_STAGES, ((t - 1) / DKV_STAGES) & 1);
      load_stage(u);
    }
    if ((q0 += 64) >= S) q0 = k0;
  }
  if (wg == 0) l3q::bar_sync(BAR_TURN, 256);  // warpgroup 1's last turn

  // accumulator 4 j + e: key kr0 (e < 2) or kr1, d = 8 j + 2 t4 + e % 2
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int key = half ? kr1 : kr0;
    if (key >= S) continue;
    const size_t base = (((size_t)b * S + key) * G + gk) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int d = 8 * j + 2 * t4;
      *reinterpret_cast<uint32_t*>(dk + base + d) =
          l3q::pack_bf16x2(adk[4 * j + 2 * half], adk[4 * j + 2 * half + 1]);
      *reinterpret_cast<uint32_t*>(dv + base + d) =
          l3q::pack_bf16x2(adv[4 * j + 2 * half], adv[4 * j + 2 * half + 1]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(DQ_THREADS, 1) flash_bwd_dq_kernel(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
    const float* __restrict__ m, const float* __restrict__ l, const float* __restrict__ di,
    __nv_bfloat16* __restrict__ dq, int S, int H, int G, float scale) {
  constexpr int DB = D / 64;
  extern __shared__ __align__(1024) unsigned char smem[];
  unsigned char* Qs = smem;                      // [NWG][DB] blocks of 64 rows
  unsigned char* Os = Qs + NWG * DB * TILE;      // [NWG][DB]: dO
  unsigned char* Ks = Os + NWG * DB * TILE;      // [STAGES][DB] blocks of 64 keys
  unsigned char* Vs = Ks + DQ_STAGES * DB * TILE;  // [STAGES][DB]
  uint64_t* full = reinterpret_cast<uint64_t*>(Vs + DQ_STAGES * DB * TILE);  // [STAGES]
  uint64_t* empty = full + DQ_STAGES;                                         // [STAGES]
  uint64_t* qbar = empty + DQ_STAGES;

  // blockIdx.x walks (head, batch), so a group's rep heads run side by
  // side; blockIdx.y the q tiles from the last, the ones with the most keys
  const int h = blockIdx.x % H, b = blockIdx.x / H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * DQ_ROWS;
  const int gk = h / (H / G);
  const int nkv = (min(S, q0 + DQ_ROWS) + 63) / 64;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  if (tid == 0) {
    l3q::mbar_init_n(full, DQ_STAGES);
    l3q::mbar_init_n(empty, DQ_STAGES, MMA_THREADS / 32);
    l3q::mbar_init_n(qbar, 1);
  }
  __syncthreads();

  if (warp == MMA_THREADS / 32) {  // ------------------------ producer warp
    if (lane == 0) {
      l3q::mbar_expect_tx(qbar, 2 * NWG * DB * TILE);
      for (int w = 0; w < NWG; ++w)
        for (int db = 0; db < DB; ++db) {
          l3q::tma_load_4d(Qs + (w * DB + db) * TILE, &tq, 64 * db, h, q0 + 64 * w, b, qbar);
          l3q::tma_load_4d(Os + (w * DB + db) * TILE, &tdo, 64 * db, h, q0 + 64 * w, b, qbar);
        }
      for (int t = 0; t < nkv; ++t) {
        const int slot = t % DQ_STAGES;
        if (t >= DQ_STAGES) mbar_wait_or_trap(empty + slot, (t / DQ_STAGES - 1) & 1);
        l3q::mbar_expect_tx(full + slot, 2 * DB * TILE);
        for (int db = 0; db < DB; ++db) {
          l3q::tma_load_4d(Ks + (slot * DB + db) * TILE, &tk, 64 * db, gk, 64 * t, b, full + slot);
          l3q::tma_load_4d(Vs + (slot * DB + db) * TILE, &tv, 64 * db, gk, 64 * t, b, full + slot);
        }
      }
    }
    return;
  }

  // ------------------------------------------------ consumer warpgroups
  const int wg = warp >> 2, g = lane >> 2, t4 = lane & 3;
  const int wq0 = q0 + 64 * wg;                          // this warpgroup's first row
  const int r0 = wq0 + 16 * (warp & 3) + g, r1 = r0 + 8;  // this thread's rows
  // the rows' max, 1 / l and di (1 / l = 1, m = di = 0 past S)
  float rm[2], rl[2], rd[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = half ? r1 : r0;
    const size_t i = ((size_t)b * H + h) * S + row;
    rm[half] = row < S ? m[i] : 0.f;
    rl[half] = row < S ? 1.f / l[i] : 1.f;
    rd[half] = row < S ? di[i] : 0.f;
  }
  float adq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) adq[i] = 0.f;
  const unsigned char* Qw = Qs + wg * DB * TILE;
  const unsigned char* Ow = Os + wg * DB * TILE;
  mbar_wait_or_trap(qbar, 0);
  for (int t = 0; t < nkv; ++t) {
    const int slot = t % DQ_STAGES, kt0 = 64 * t;
    mbar_wait_or_trap(full + slot, (t / DQ_STAGES) & 1);
    // else the rows lie past S, or the tile wholly past them
    if (!(L3Q_ABLATE & 2048) && wq0 < S && kt0 <= wq0 + 63) {
      const unsigned char* Kt = Ks + slot * DB * TILE;
      const unsigned char* Vt = Vs + slot * DB * TILE;
      // S = Q K^T and dP = dO V^T, [64 rows][64 keys], two groups
      float s[32], dp[32];
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks)
        wgmma_ss_n64(s, kdesc(Qw + (ks >> 2) * TILE, ks), kdesc(Kt + (ks >> 2) * TILE, ks),
                     ks > 0);
      wgmma_commit();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks)
        wgmma_ss_n64(dp, kdesc(Ow + (ks >> 2) * TILE, ks), kdesc(Vt + (ks >> 2) * TILE, ks),
                     ks > 0);
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(s);
      // P while dP lands: accumulator 4 j + e is row r0 (e < 2) or r1, key
      // kt0 + 8 j + 2 t4 + e % 2; the tile crosses the diagonal or S
      const bool mask = kt0 + 63 > wq0 || kt0 + 64 > S;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int half = (i >> 1) & 1;
        float x = __fmul_rn(s[i], scale);
        if (mask && kt0 + 8 * (i >> 2) + 2 * t4 + (i & 1) > (half ? r1 : r0)) x += MASK_VALUE;
        s[i] = __expf(x - rm[half]) * rl[half];
      }
      wgmma_wait<0>();
      fence_regs(dp);
      uint32_t sa[4][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) ds[e] = (dp[4 * j + e] - rd[e >> 1]) * s[4 * j + e] * scale;
        pack_a(sa, j, ds[0], ds[1], ds[2], ds[3]);
      }
      // dQ += dS K: the 64 keys contracted, K read MN-major
      wgmma_fence();
      fence_regs(adq);
#pragma unroll
      for (int kc = 0; kc < 4; ++kc)
        wgmma_rs_nd<D>(adq, sa[kc], l3q::wgmma_desc(Kt + kc * 16 * 128, TILE, 1024));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(adq);
    }
    if (lane == 0) l3q::mbar_arrive(empty + slot);
  }

  // accumulator 4 j + e: row r0 (e < 2) or r1, d = 8 j + 2 t4 + e % 2
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = half ? r1 : r0;
    if (row >= S) continue;
    const size_t base = (((size_t)b * S + row) * H + h) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(dq + base + 8 * j + 2 * t4) =
          l3q::pack_bf16x2(adq[4 * j + 2 * half], adq[4 * j + 2 * half + 1]);
  }
}

// The four operands' tensor maps: q and do in boxes of 64 rows, k and v in
// boxes of `kv_rows`.
int tensor_maps(CUtensorMap* maps, const void* q, const void* k, const void* v, const void* dout,
                int B, int S, int H, int G, int D, int kv_rows) {
  int err = tensor_map_bshd(&maps[0], q, B, S, H, D, 64);
  if (!err) err = tensor_map_bshd(&maps[1], k, B, S, G, D, kv_rows);
  if (!err) err = tensor_map_bshd(&maps[2], v, B, S, G, D, kv_rows);
  if (!err) err = tensor_map_bshd(&maps[3], dout, B, S, H, D, 64);
  return err;
}

template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout, const float* m,
               const float* l, const float* di, void* dk, void* dv, int B, int S, int H, int G,
               float scale, cudaStream_t st) {
  CUtensorMap maps[4];
  int err = tensor_maps(maps, q, k, v, dout, B, S, H, G, D, DKV_KEYS);
  if (err) return err;
  constexpr int DB = D / 64;
  const size_t smem = (size_t)2 * DB * DKV_KEYS * 128 + (size_t)2 * DKV_STAGES * DB * TILE +
                      NWG * 2 * 3 * 64 * sizeof(float) + (2 * DKV_STAGES + 1) * sizeof(uint64_t);
  err = (int)cudaFuncSetAttribute(flash_bwd_dkv_kernel<D>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err) return err;
  dim3 grid(G * B, (S + DKV_KEYS - 1) / DKV_KEYS);
  flash_bwd_dkv_kernel<D><<<grid, DKV_THREADS, smem, st>>>(
      maps[0], maps[1], maps[2], maps[3], m, l, di, (__nv_bfloat16*)dk, (__nv_bfloat16*)dv, S,
      H, G, scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout, const float* m,
              const float* l, const float* di, void* dq, int B, int S, int H, int G, float scale,
              cudaStream_t st) {
  CUtensorMap maps[4];
  int err = tensor_maps(maps, q, k, v, dout, B, S, H, G, D, 64);
  if (err) return err;
  constexpr int DB = D / 64;
  const size_t smem = (size_t)2 * NWG * DB * TILE + (size_t)2 * DQ_STAGES * DB * TILE +
                      (2 * DQ_STAGES + 1) * sizeof(uint64_t);
  err = (int)cudaFuncSetAttribute(flash_bwd_dq_kernel<D>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err) return err;
  dim3 grid(H * B, (S + DQ_ROWS - 1) / DQ_ROWS);
  flash_bwd_dq_kernel<D><<<grid, DQ_THREADS, smem, st>>>(
      maps[0], maps[1], maps[2], maps[3], m, l, di, (__nv_bfloat16*)dq, S, H, G, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q/do [B, S, H, D] bf16; k/v [B, S, G, D] bf16; m/l/di [B, H, S] fp32;
// dk/dv [B, S, G, D] bf16 out; D in {64, 128}; H % G == 0; scale fp32
// 1 / sqrt(D).
extern "C" int l3q_flash_attn_bwd_dkv(const void* q, const void* k, const void* v,
                                      const void* dout, const float* m, const float* l,
                                      const float* di, void* dk, void* dv, int B, int S, int H,
                                      int G, int D, float scale, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (D == 128) return launch_dkv<128>(q, k, v, dout, m, l, di, dk, dv, B, S, H, G, scale, st);
  if (D == 64) return launch_dkv<64>(q, k, v, dout, m, l, di, dk, dv, B, S, H, G, scale, st);
  return (int)cudaErrorInvalidValue;
}

// the same inputs; dq [B, S, H, D] bf16 out
extern "C" int l3q_flash_attn_bwd_dq(const void* q, const void* k, const void* v,
                                     const void* dout, const float* m, const float* l,
                                     const float* di, void* dq, int B, int S, int H, int G, int D,
                                     float scale, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (D == 128) return launch_dq<128>(q, k, v, dout, m, l, di, dq, B, S, H, G, scale, st);
  if (D == 64) return launch_dq<64>(q, k, v, dout, m, l, di, dq, B, S, H, G, scale, st);
  return (int)cudaErrorInvalidValue;
}
