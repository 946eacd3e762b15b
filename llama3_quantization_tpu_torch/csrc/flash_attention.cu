// Causal full-sequence flash attention forward: kernel B7.
//
// Replaces the Pallas TPU library kernel
// jax.experimental.pallas.ops.tpu.flash_attention.flash_attention, called by
// llama3_quantization_tpu/models/transformer._flash_attention (:168-181)
// when S >= 128: softmax(q k^T / sqrt(d) + causal) v per head.
//
// Layouts are the model's own: q/out [B, S, H, D], k/v [B, S, G, D], bf16.
// Head h reads kv group h // (H/G) in place; the JAX side repeats K/V per
// head instead.
//
// What bounds it on the H100: at S = 128..2048 and D = 128 it does
// 2*S*S*D*H FLOPs (half of that causal) on 2*S*D*(H + 2G) bytes, so it is
// bound by the tensor cores, and in practice by what feeds them and by the
// softmax between the two products. The first form (mma.sync, V^T staged
// through scalar shared stores with 16-way bank conflicts, no overlap of
// loads and compute) ran at about a tenth of the bf16 peak. This one has
// the usual Hopper shape: one block per (q tile, head, batch), q tiles of
// 128 rows (two consumer warpgroups of 64) or 64 where 128-row tiles would
// not fill the card, launched longest first; one producer thread keeps a
// 2-slot ring of TMA boxes of K and V tiles of 128 keys (and Q once) in
// flight on mbarriers, in the 128-byte swizzle; each consumer warpgroup
// runs S = Q K^T as wgmma m64n128k16 with Q and K in shared memory, the
// online softmax in fp32 registers (running max and sum per row; the
// scale multiplied in and exp(s - max) taken, by the fast hardware
// exponential, at the TPU kernel's rounding points: folding the scale into
// exp2 moves which of two bf16-tied logits a forward picks), and
// O += P V as wgmma with P from registers (rounded to bf16 only as this
// operand) and V read in its own [key, d] layout as an N-major operand;
// the output is normalised once at the end. Tiles past the diagonal are
// never loaded, a warpgroup skips a tile wholly above its rows, and only
// tiles that cross the diagonal or the sequence's end are masked.
//
// B7.stats: given `m` and `l` ([B, H, S] fp32), the same launch also writes
// each row's max of the scaled logits and its sum of exp(s - max), the
// residuals of the library's forward with `save_residuals=True`
// (flash_attention.py:236-251, the same pallas_call :758) that the
// backward kernels (flash_attention_bwd.cu) read. Without them nothing
// else changes.

#include "flash_wgmma.cuh"

namespace {

constexpr int BKV = 128, STAGES = 2;
constexpr int BLK = 64 * 128;  // bytes of one [64 rows][64 d] bf16 block, 128-byte swizzled
constexpr int KBLK = BKV * 128;  // bytes of one [BKV keys][64 d] block

// Tiles in shared memory are blocks of 64 d (128 bytes a row, in the
// 128-byte swizzle), D / 64 blocks side by side: Q [NWG][D/64] blocks of
// 64 rows, K and V [STAGES][D/64] blocks of BKV keys. TMA writes them in
// that layout.
template <int D, int NWG>
__global__ void __launch_bounds__(NWG * 128 + 32, 1) flash_fwd_kernel(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ out,
    float* __restrict__ mo, float* __restrict__ lo, int S, int H, int G, float scale) {
  constexpr int DB = D / 64, BQ = 64 * NWG;
  extern __shared__ __align__(1024) unsigned char smem[];
  unsigned char* Qs = smem;                        // [NWG][DB] blocks
  unsigned char* Ks = Qs + NWG * DB * BLK;         // [STAGES][DB]
  unsigned char* Vs = Ks + STAGES * DB * KBLK;     // [STAGES][DB]
  uint64_t* full = reinterpret_cast<uint64_t*>(Vs + STAGES * DB * KBLK);  // [STAGES]: K, V landed
  uint64_t* empty = full + STAGES;                 // [STAGES]: every MMA warp done with them
  uint64_t* qbar = empty + STAGES;                 // Q landed

  // blockIdx.x walks (head, batch) fastest and blockIdx.y the q tiles from
  // the last, so the blocks with the most key tiles start first
  const int h = blockIdx.x % H, b = blockIdx.x / H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int gk = h / (H / G);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nkv = (min(S, q0 + BQ) + BKV - 1) / BKV;

  if (tid == 0) {
    for (int i = 0; i < STAGES; ++i) {
      l3q::mbar_init(full + i, 1);
      l3q::mbar_init(empty + i, NWG * 4);
    }
    l3q::mbar_init(qbar, 1);
  }
  __syncthreads();

  if (warp == NWG * 4) {  // ------------------------------- producer warp
    if (lane == 0) {
      l3q::mbar_expect_tx(qbar, NWG * DB * BLK);
      for (int w = 0; w < NWG; ++w)
        for (int db = 0; db < DB; ++db)
          l3q::tma_load_4d(Qs + (w * DB + db) * BLK, &tq, 64 * db, h, q0 + 64 * w, b, qbar);
      for (int t = 0; t < nkv; ++t) {
        const int slot = t % STAGES;
        if (t >= STAGES) l3q::mbar_wait(empty + slot, (t / STAGES - 1) & 1);
        l3q::mbar_expect_tx(full + slot, ((L3Q_ABLATE & 8) ? 1 : 2) * DB * KBLK);
        for (int db = 0; db < DB; ++db) {
          l3q::tma_load_4d(Ks + (slot * DB + db) * KBLK, &tk, 64 * db, gk, t * BKV, b, full + slot);
          if (!(L3Q_ABLATE & 8))
            l3q::tma_load_4d(Vs + (slot * DB + db) * KBLK, &tv, 64 * db, gk, t * BKV, b, full + slot);
        }
      }
    }
    return;
  }

  // ------------------------------------------------ consumer warpgroups
  const int wg = warp >> 2, gid = lane >> 2, tig = lane & 3;
  const int wq0 = q0 + 64 * wg;             // this warpgroup's first row
  const int rw0 = wq0 + 16 * (warp & 3);    // this warp's first row
  const int r0 = rw0 + gid, r1 = r0 + 8;
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  // running max (of scaled scores) and sum per row
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  l3q::mbar_wait(qbar, 0);
  const unsigned char* Qw = Qs + wg * DB * BLK;
  for (int t = 0; t < nkv; ++t) {
    const int slot = t % STAGES, j0 = t * BKV;
    l3q::mbar_wait(full + slot, (t / STAGES) & 1);
    if (j0 <= wq0 + 63 && wq0 < S) {  // else the tile lies wholly above the rows
      const unsigned char* Kt = Ks + slot * DB * KBLK;
      const unsigned char* Vt = Vs + slot * DB * KBLK;
      // S = Q K^T: K-major operands, k steps of 16 d = 32 bytes along a
      // 64-d block's rows, 8-row groups 1024 bytes apart
      float sc[BKV / 2];
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks)
        wgmma_ss_n128(sc, l3q::wgmma_desc(Qw + (ks >> 2) * BLK + (ks & 3) * 32, 16, 1024),
                      l3q::wgmma_desc(Kt + (ks >> 2) * KBLK + (ks & 3) * 32, 16, 1024), ks > 0);
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      fence_regs(sc);
      // accumulator 4 j + e: row r0 (e < 2) or r1, key j0 + 8 j + 2 tig + e % 2;
      // only a tile that crosses the diagonal or the sequence's end is masked
      const bool mask = j0 + BKV - 1 > rw0 || j0 + BKV > S;
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int i = 0; i < BKV / 2; ++i) {  // the scale as the TPU kernel applies it
        sc[i] *= scale;
        if (mask) {
          const int col = j0 + 8 * (i >> 2) + 2 * tig + (i & 1);
          if (col > ((i & 2) ? r1 : r0) || col >= S) sc[i] = -INFINITY;
        }
        if (i & 2) mx1 = fmaxf(mx1, sc[i]); else mx0 = fmaxf(mx0, sc[i]);
      }
#pragma unroll
      for (int o_ = 1; o_ <= 2; o_ <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o_));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o_));
      }
      // key 0 is visible to every row, so the running max is finite after
      // the first tile and exp(-inf) = 0 for masked scores (a row wholly
      // above the tile keeps its max and sum)
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float a0 = __expf(m0 - mn0), a1 = __expf(m1 - mn1);
      float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
      for (int i = 0; i < BKV / 2; ++i) {  // unnormalized p
        const float x = sc[i] - ((i & 2) ? mn1 : mn0);
        sc[i] = (L3Q_ABLATE & 16) ? x : __expf(x);
        if (i & 2) ls1 += sc[i]; else ls0 += sc[i];
      }
      l0 = l0 * a0 + ls0;
      l1 = l1 * a1 + ls1;
      m0 = mn0;
      m1 = mn1;
      // P as the m16n8k16 A fragments of keys 16 kc ..: bf16 only here
      uint32_t pa[BKV / 16][4];
#pragma unroll
      for (int kc = 0; kc < BKV / 16; ++kc)
#pragma unroll
        for (int r = 0; r < 4; ++r) pa[kc][r] = l3q::pack_bf16x2(sc[8 * kc + 2 * r], sc[8 * kc + 2 * r + 1]);
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] *= (i & 2) ? a1 : a0;
      // O += P V: V as an N-major operand, rows of 8 keys 128 bytes apart in
      // groups 1024 bytes apart, 64-d blocks KBLK bytes apart
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
      fence_regs(o);
#pragma unroll
      for (int kc = 0; kc < BKV / 16; ++kc) {
        const uint64_t dv = l3q::wgmma_desc(Vt + kc * 16 * 128, KBLK, 1024);
        if constexpr ((L3Q_ABLATE & 32) != 0) continue;
        if constexpr (D == 128) wgmma_rs_n128(o, pa[kc], dv);
        else wgmma_rs_n64(o, pa[kc], dv);
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      fence_regs(o);
    }
    if (lane == 0) l3q::mbar_arrive(empty + slot);
  }

#pragma unroll
  for (int o_ = 1; o_ <= 2; o_ <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, o_);
    l1 += __shfl_xor_sync(0xffffffffu, l1, o_);
  }
  if (mo != nullptr && tig == 0) {  // B7.stats
    const size_t i = ((size_t)b * H + h) * S;
    if (r0 < S) { mo[i + r0] = m0; lo[i + r0] = l0; }
    if (r1 < S) { mo[i + r1] = m1; lo[i + r1] = l1; }
  }
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int d = 8 * j + 2 * tig;
    if (r0 < S)
      *reinterpret_cast<uint32_t*>(out + ((size_t)b * S + r0) * H * D + (size_t)h * D + d) =
          l3q::pack_bf16x2(o[4 * j] * inv0, o[4 * j + 1] * inv0);
    if (r1 < S)
      *reinterpret_cast<uint32_t*>(out + ((size_t)b * S + r1) * H * D + (size_t)h * D + d) =
          l3q::pack_bf16x2(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
  }
}

template <int D, int NWG>
int launch(const void* q, const void* k, const void* v, void* out, float* m, float* l, int B,
           int S, int H, int G, float scale, cudaStream_t st) {
  CUtensorMap tq{}, tk{}, tv{};
  int err = tensor_map_bshd(&tq, q, B, S, H, D, 64);
  if (!err) err = tensor_map_bshd(&tk, k, B, S, G, D, BKV);
  if (!err) err = tensor_map_bshd(&tv, v, B, S, G, D, BKV);
  if (err) return err;
  const size_t smem = (size_t)NWG * (D / 64) * BLK + 2 * (size_t)STAGES * (D / 64) * KBLK +
                      (2 * STAGES + 1) * sizeof(uint64_t);
  err = (int)cudaFuncSetAttribute(flash_fwd_kernel<D, NWG>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err) return err;
  dim3 grid(H * B, (S + 64 * NWG - 1) / (64 * NWG));
  flash_fwd_kernel<D, NWG><<<grid, NWG * 128 + 32, smem, st>>>(
      tq, tk, tv, (__nv_bfloat16*)out, m, l, S, H, G, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q/out bf16 [B, S, H, D]; k/v bf16 [B, S, G, D]; D in {64, 128}; H % G == 0;
// 16-byte aligned rows; m/l: fp32 [B, H, S] outputs (B7.stats) or both null;
// bq: q rows per block, 128 or 64; scale: fp32 1 / sqrt(D).
extern "C" int l3q_flash_attn_fwd(const void* q, const void* k, const void* v, void* out,
                                  float* m, float* l, int B, int S, int H, int G, int D, int bq,
                                  float scale, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (D == 128 && bq == 128) return launch<128, 2>(q, k, v, out, m, l, B, S, H, G, scale, st);
  if (D == 128 && bq == 64) return launch<128, 1>(q, k, v, out, m, l, B, S, H, G, scale, st);
  if (D == 64 && bq == 128) return launch<64, 2>(q, k, v, out, m, l, B, S, H, G, scale, st);
  if (D == 64 && bq == 64) return launch<64, 1>(q, k, v, out, m, l, B, S, H, G, scale, st);
  return (int)cudaErrorInvalidValue;
}
