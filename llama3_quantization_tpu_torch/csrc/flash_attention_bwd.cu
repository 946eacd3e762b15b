// Causal flash attention backward: kernels B7.dkv and B7.dq.
//
// Replace the Pallas TPU library's backward kernels, which run wherever the
// JAX package differentiates through `_flash_attention`
// (llama3_quantization_tpu/models/transformer.py:168-181; OmniQuant's block
// loss, quant/omniquant.py:379, and the sharded LWC step,
// parallel/train.py:101): `_flash_attention_dkv_kernel` (flash_attention.py
// :796, via `_flash_attention_bwd_dkv` :941) and `_flash_attention_dq_kernel`
// (:1146, via `_flash_attention_bwd_dq` :1287). Both recompute
//
//   p  = exp(q k^T * scale + mask - m) * (1 / l)      (m, l from B7.stats)
//   ds = (do v^T - di) * p * scale                    (di = sum(o * do))
//
// and form dv = p^T do, dk = ds^T q (B7.dkv) and dq = ds k (B7.dq), with p
// and ds rounded to bf16 before their products and every product summed in
// fp32, as the library does (dkv :900,918, dq :1258). Masked logits take the
// library's DEFAULT_MASK_VALUE (-0.7 * float32 max), so their p is 0.
//
// Layouts are the model's: q/do/dq [B, S, H, D], k/v/dk/dv [B, S, G, D],
// bf16; m, l, di [B, H, S] fp32. Query head h reads K/V group h / (H / G) in
// place. The library runs on K/V repeated per query head and sums the rep
// heads' dk/dv through the repeat's transpose, each rounded to bf16 first;
// B7.dkv sums a group's rep heads in fp32 in the block and rounds once.
//
// What bounds it on the H100: 4 (dkv: q k^T, do v^T, p^T do, ds^T q) and 3
// (dq: q k^T, do v^T, ds k) products of 2 * D FLOPs per causal (q, k)
// pair, on about 2 * S * D * (2 H + 2 G) bytes: the tensor cores. This
// first form is the simple one: mma.sync m16n8k16 (bf16, fp32 sums) on
// tiles staged in shared memory by plain 16-byte loads, no copy ring and
// no overlap of loads and products.
//
// B7.dkv: one block per (64-key tile, K/V group, batch), 4 warps of 16 keys.
// It loops over the group's rep query heads and, for each, over the
// 32-row q tiles from the diagonal on, computing S^T = K Q^T and dP^T =
// V dO^T in registers; P^T and dS^T become the A operands of dV += P^T dO
// and dK += dS^T Q, whose B operands are read transposed by ldmatrix. dK
// and dV stay in fp32 registers for the whole block: no atomics, and a
// fixed order from run to run.
//
// B7.dq: one block per (64-row q tile, query head, batch), 4 warps of 16
// rows, looping over the 64-key tiles up to the diagonal; dQ stays in fp32
// registers.

#include "common.cuh"

namespace {

constexpr float MASK_VALUE = -0.7f * 3.402823466e38f;  // the library's DEFAULT_MASK_VALUE
constexpr int BK = 64;   // keys per B7.dkv block, and per B7.dq key tile
constexpr int BQ = 32;   // q rows per B7.dkv step
constexpr int BQD = 64;  // q rows per B7.dq block

template <int D>
struct Row {
  static constexpr int LD = D + 8;  // bf16 per shared row: 16-byte aligned, conflict-free
};

// rows [r0, r0 + n) of one head of a [B, S, heads, D] bf16 tensor into
// shared rows of LD bf16; rows past S read as zeros
template <int D, int NT>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst, const __nv_bfloat16* src, int b,
                                          int r0, int n, int S, int heads, int head) {
  constexpr int V = D / 8;  // 16-byte vectors per row
  for (int i = threadIdx.x; i < n * V; i += NT) {
    const int r = i / V, c = (i % V) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r0 + r < S)
      val = *reinterpret_cast<const uint4*>(src + (((size_t)b * S + r0 + r) * heads + head) * D + c);
    *reinterpret_cast<uint4*>(dst + r * Row<D>::LD + c) = val;
  }
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// A fragment (16 rows from `a`, k columns k0..k0+15) of a row-major shared tile
template <int D>
__device__ __forceinline__ void frag_a(uint32_t* f, const __nv_bfloat16* a, int k0, int g, int t) {
  constexpr int LD = Row<D>::LD;
  f[0] = ld32(a + g * LD + k0 + 2 * t);
  f[1] = ld32(a + (g + 8) * LD + k0 + 2 * t);
  f[2] = ld32(a + g * LD + k0 + 8 + 2 * t);
  f[3] = ld32(a + (g + 8) * LD + k0 + 8 + 2 * t);
}

// B fragment (k = k0..k0+15, n = 8 rows from `bt`) where the tile holds B^T
// row-major ([n][k]: the product contracts its rows' own columns)
template <int D>
__device__ __forceinline__ void frag_bt(uint32_t* f, const __nv_bfloat16* bt, int k0, int g, int t) {
  constexpr int LD = Row<D>::LD;
  f[0] = ld32(bt + g * LD + k0 + 2 * t);
  f[1] = ld32(bt + g * LD + k0 + 8 + 2 * t);
}

// B fragment (k = 16 rows from `b`, n = columns n0..n0+7) where the tile
// holds B row-major ([k][n]): ldmatrix transposes it
template <int D>
__device__ __forceinline__ void frag_b(uint32_t* f, const __nv_bfloat16* b, int n0, int lane) {
  l3q::ldmatrix_x2_trans(f, b + (lane & 15) * Row<D>::LD + n0);
}

template <int D>
__global__ void __launch_bounds__(128) flash_bwd_dkv_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
    const float* __restrict__ m, const float* __restrict__ l, const float* __restrict__ di,
    __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int S, int H, int G,
    float scale) {
  constexpr int LD = Row<D>::LD, NT = 128;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem);  // [BK][LD]
  __nv_bfloat16* Vs = Ks + BK * LD;                             // [BK][LD]
  __nv_bfloat16* Qs = Vs + BK * LD;                             // [BQ][LD]
  __nv_bfloat16* Os = Qs + BQ * LD;                             // [BQ][LD]: dO
  float* ms = reinterpret_cast<float*>(Os + BQ * LD);           // [BQ]
  float* li = ms + BQ;                                          // [BQ]: 1 / l
  float* ds_ = li + BQ;                                         // [BQ]: di

  const int k0 = blockIdx.x * BK, gk = blockIdx.y, b = blockIdx.z;
  const int rep = H / G;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int kw = k0 + 16 * warp;  // this warp's first key

  load_rows<D, NT>(Ks, k, b, k0, BK, S, G, gk);
  load_rows<D, NT>(Vs, v, b, k0, BK, S, G, gk);

  float adk[D / 8][4], adv[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) adk[j][e] = adv[j][e] = 0.f;

  const __nv_bfloat16* Kw = Ks + 16 * warp * LD;
  const __nv_bfloat16* Vw = Vs + 16 * warp * LD;
  for (int r = 0; r < rep; ++r) {
    const int h = gk * rep + r;
    const size_t stat = ((size_t)b * H + h) * S;
    for (int q0 = k0; q0 < S; q0 += BQ) {
      __syncthreads();  // the previous step is done with Qs, Os and the stats
      load_rows<D, NT>(Qs, q, b, q0, BQ, S, H, h);
      load_rows<D, NT>(Os, dout, b, q0, BQ, S, H, h);
      for (int i = threadIdx.x; i < BQ; i += NT) {
        const bool in = q0 + i < S;
        ms[i] = in ? m[stat + q0 + i] : 0.f;
        li[i] = in ? 1.f / l[stat + q0 + i] : 1.f;
        ds_[i] = in ? di[stat + q0 + i] : 0.f;
      }
      __syncthreads();
      if (kw > q0 + BQ - 1) continue;  // every key of this warp lies past every row

      // S^T = K Q^T and dP^T = V dO^T: [16 keys][BQ rows] per warp
      float st[BQ / 8][4], dpt[BQ / 8][4];
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc) {
        uint32_t ak[4], av[4];
        frag_a<D>(ak, Kw, 16 * kc, g, t);
        frag_a<D>(av, Vw, 16 * kc, g, t);
#pragma unroll
        for (int j = 0; j < BQ / 8; ++j) {
          uint32_t bq[2], bo[2];
          frag_bt<D>(bq, Qs + 8 * j * LD, 16 * kc, g, t);
          frag_bt<D>(bo, Os + 8 * j * LD, 16 * kc, g, t);
          l3q::mma_bf16_16816(st[j], ak, bq);
          l3q::mma_bf16_16816(dpt[j], av, bo);
        }
      }
      // P^T and dS^T, rounded to bf16 as the A operands of the next products:
      // element e of tile j is key kw + g (+8 for e >= 2), row q0 + 8 j + 2 t + e % 2
      uint32_t pa[BQ / 16][4], sa[BQ / 16][4];
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j) {
        float p[4], ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = kw + g + ((e & 2) ? 8 : 0), row = 8 * j + 2 * t + (e & 1);
          const float s = st[j][e] * scale + (key > q0 + row ? MASK_VALUE : 0.f);
          p[e] = __expf(s - ms[row]) * li[row];
          ds[e] = (dpt[j][e] - ds_[row]) * p[e] * scale;
        }
        pa[j >> 1][(j & 1) * 2] = l3q::pack_bf16x2(p[0], p[1]);
        pa[j >> 1][(j & 1) * 2 + 1] = l3q::pack_bf16x2(p[2], p[3]);
        sa[j >> 1][(j & 1) * 2] = l3q::pack_bf16x2(ds[0], ds[1]);
        sa[j >> 1][(j & 1) * 2 + 1] = l3q::pack_bf16x2(ds[2], ds[3]);
      }
      // dV += P^T dO and dK += dS^T Q: contract the BQ rows
#pragma unroll
      for (int kc = 0; kc < BQ / 16; ++kc) {
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          uint32_t bo[2], bq[2];
          frag_b<D>(bo, Os + 16 * kc * LD, 8 * n, lane);
          frag_b<D>(bq, Qs + 16 * kc * LD, 8 * n, lane);
          l3q::mma_bf16_16816(adv[n], pa[kc], bo);
          l3q::mma_bf16_16816(adk[n], sa[kc], bq);
        }
      }
    }
  }

  // accumulator (n, e): key kw + g (+8 for e >= 2), d = 8 n + 2 t + e % 2
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int key = kw + g + 8 * half;
    if (key >= S) continue;
    const size_t base = (((size_t)b * S + key) * G + gk) * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const int d = 8 * n + 2 * t;
      *reinterpret_cast<uint32_t*>(dk + base + d) =
          l3q::pack_bf16x2(adk[n][2 * half], adk[n][2 * half + 1]);
      *reinterpret_cast<uint32_t*>(dv + base + d) =
          l3q::pack_bf16x2(adv[n][2 * half], adv[n][2 * half + 1]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(128) flash_bwd_dq_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
    const float* __restrict__ m, const float* __restrict__ l, const float* __restrict__ di,
    __nv_bfloat16* __restrict__ dq, int S, int H, int G, float scale) {
  constexpr int LD = Row<D>::LD, NT = 128;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);  // [BQD][LD]
  __nv_bfloat16* Os = Qs + BQD * LD;                            // [BQD][LD]: dO
  __nv_bfloat16* Ks = Os + BQD * LD;                            // [BK][LD]
  __nv_bfloat16* Vs = Ks + BK * LD;                             // [BK][LD]

  // the q tiles with the most key tiles first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQD, h = blockIdx.y, b = blockIdx.z;
  const int gk = h / (H / G);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int qw = q0 + 16 * warp;  // this warp's first row

  load_rows<D, NT>(Qs, q, b, q0, BQD, S, H, h);
  load_rows<D, NT>(Os, dout, b, q0, BQD, S, H, h);
  // this thread's rows qw + g and qw + g + 8: max, 1 / l, di
  float rm[2], rl[2], rd[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = qw + g + 8 * half;
    const size_t i = ((size_t)b * H + h) * S + row;
    rm[half] = row < S ? m[i] : 0.f;
    rl[half] = row < S ? 1.f / l[i] : 1.f;
    rd[half] = row < S ? di[i] : 0.f;
  }

  float adq[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) adq[j][e] = 0.f;

  const __nv_bfloat16* Qw = Qs + 16 * warp * LD;
  const __nv_bfloat16* Ow = Os + 16 * warp * LD;
  const int kend = min(S, q0 + BQD);
  for (int k0 = 0; k0 < kend; k0 += BK) {
    __syncthreads();  // the previous tile is done with Ks and Vs
    load_rows<D, NT>(Ks, k, b, k0, BK, S, G, gk);
    load_rows<D, NT>(Vs, v, b, k0, BK, S, G, gk);
    __syncthreads();
    if (k0 > qw + 15) continue;  // the tile lies wholly past this warp's rows

    float s[BK / 8][4], dp[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
      uint32_t aq[4], ao[4];
      frag_a<D>(aq, Qw, 16 * kc, g, t);
      frag_a<D>(ao, Ow, 16 * kc, g, t);
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        uint32_t bk[2], bv[2];
        frag_bt<D>(bk, Ks + 8 * j * LD, 16 * kc, g, t);
        frag_bt<D>(bv, Vs + 8 * j * LD, 16 * kc, g, t);
        l3q::mma_bf16_16816(s[j], aq, bk);
        l3q::mma_bf16_16816(dp[j], ao, bv);
      }
    }
    // dS as the A operand of dQ += dS K: element e of tile j is row
    // qw + g (+8 for e >= 2), key k0 + 8 j + 2 t + e % 2
    uint32_t sa[BK / 16][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int half = e >> 1, row = qw + g + 8 * half, key = k0 + 8 * j + 2 * t + (e & 1);
        const float x = s[j][e] * scale + (key > row ? MASK_VALUE : 0.f);
        const float p = __expf(x - rm[half]) * rl[half];
        ds[e] = (dp[j][e] - rd[half]) * p * scale;
      }
      sa[j >> 1][(j & 1) * 2] = l3q::pack_bf16x2(ds[0], ds[1]);
      sa[j >> 1][(j & 1) * 2 + 1] = l3q::pack_bf16x2(ds[2], ds[3]);
    }
#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc) {
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        uint32_t bk[2];
        frag_b<D>(bk, Ks + 16 * kc * LD, 8 * n, lane);
        l3q::mma_bf16_16816(adq[n], sa[kc], bk);
      }
    }
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = qw + g + 8 * half;
    if (row >= S) continue;
    const size_t base = (((size_t)b * S + row) * H + h) * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(dq + base + 8 * n + 2 * t) =
          l3q::pack_bf16x2(adq[n][2 * half], adq[n][2 * half + 1]);
  }
}

template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout, const float* m,
               const float* l, const float* di, void* dk, void* dv, int B, int S, int H, int G,
               float scale, cudaStream_t st) {
  const size_t smem = (size_t)(2 * BK + 2 * BQ) * Row<D>::LD * 2 + 3 * BQ * sizeof(float);
  int err = (int)cudaFuncSetAttribute(flash_bwd_dkv_kernel<D>,
                                      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err) return err;
  dim3 grid((S + BK - 1) / BK, G, B);
  flash_bwd_dkv_kernel<D><<<grid, 128, smem, st>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
      (const __nv_bfloat16*)dout, m, l, di, (__nv_bfloat16*)dk, (__nv_bfloat16*)dv, S, H, G,
      scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout, const float* m,
              const float* l, const float* di, void* dq, int B, int S, int H, int G, float scale,
              cudaStream_t st) {
  const size_t smem = (size_t)(2 * BQD + 2 * BK) * Row<D>::LD * 2;
  int err = (int)cudaFuncSetAttribute(flash_bwd_dq_kernel<D>,
                                      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err) return err;
  dim3 grid((S + BQD - 1) / BQD, H, B);
  flash_bwd_dq_kernel<D><<<grid, 128, smem, st>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
      (const __nv_bfloat16*)dout, m, l, di, (__nv_bfloat16*)dq, S, H, G, scale);
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
