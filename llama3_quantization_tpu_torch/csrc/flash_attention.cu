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
// bound by the tensor cores. Design: one 128-thread block per (q tile of 64
// rows, head, batch); each warp owns 16 query rows with its Q fragments in
// registers; K and V^T tiles of 64 keys are staged in shared memory; QK^T
// and PV run on mma.sync m16n8k16 bf16 with fp32 accumulation; the online
// softmax (running max and sum per row) stays in fp32 registers and P is
// rounded to bf16 only as the PV operand. Tiles past the diagonal are never
// loaded. No TMA, wgmma, or load/compute overlap yet.

#include "common.cuh"

namespace {

constexpr int BQ = 64, BKV = 64, THREADS = 128;

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <int D>
__global__ void __launch_bounds__(THREADS) flash_fwd_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out, int S, int H,
    int G, float scale) {
  constexpr int LDK = D + 8, LDV = BKV + 8, KC = D / 16, DN = D / 8;
  __shared__ __align__(16) __nv_bfloat16 Ks[BKV][LDK];
  __shared__ __align__(16) __nv_bfloat16 Vt[D][LDV];

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int gk = h / (H / G);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int r0 = qt * BQ + warp * 16 + gid, r1 = r0 + 8;
  const int r0c = min(r0, S - 1), r1c = min(r1, S - 1);

  uint32_t qf[KC][4];
  const __nv_bfloat16* q0 = q + ((size_t)b * S + r0c) * H * D + (size_t)h * D;
  const __nv_bfloat16* q1 = q + ((size_t)b * S + r1c) * H * D + (size_t)h * D;
#pragma unroll
  for (int kc = 0; kc < KC; ++kc) {
    const int d = kc * 16 + tig * 2;
    qf[kc][0] = ld32(q0 + d);
    qf[kc][1] = ld32(q1 + d);
    qf[kc][2] = ld32(q0 + d + 8);
    qf[kc][3] = ld32(q1 + d + 8);
  }

  float o[DN][4];
#pragma unroll
  for (int i = 0; i < DN; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[i][e] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  const int kv_end = min(S, (qt + 1) * BQ);
  for (int j0 = 0; j0 < kv_end; j0 += BKV) {
    __syncthreads();
    for (int e = tid; e < BKV * (D / 8); e += THREADS) {
      const int r = e / (D / 8), c = (e % (D / 8)) * 8;
      const int j = j0 + r;
      uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
      if (j < S) {
        const size_t off = (((size_t)b * S + j) * G + gk) * D + c;
        kv = *reinterpret_cast<const uint4*>(k + off);
        vv = *reinterpret_cast<const uint4*>(v + off);
      }
      *reinterpret_cast<uint4*>(&Ks[r][c]) = kv;
      const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vv);
#pragma unroll
      for (int i = 0; i < 8; ++i) Vt[c + i][r] = ve[i];
    }
    __syncthreads();

    float s[8][4];
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[ni][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc)
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) {
        const int n = ni * 8 + gid;
        uint32_t bf[2] = {ld32(&Ks[n][kc * 16 + tig * 2]), ld32(&Ks[n][kc * 16 + 8 + tig * 2])};
        l3q::mma_bf16_16816(s[ni], qf[kc], bf);
      }

    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = e < 2 ? r0 : r1;
        const int col = j0 + ni * 8 + tig * 2 + (e & 1);
        float x = s[ni][e] * scale;
        if (col > row || col >= S) x = -INFINITY;
        s[ni][e] = x;
        if (e < 2) mx0 = fmaxf(mx0, x); else mx1 = fmaxf(mx1, x);
      }
#pragma unroll
    for (int o_ = 1; o_ <= 2; o_ <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o_));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o_));
    }
    // key 0 is visible to every row, so the running max is finite after
    // the first tile and exp(-inf - finite) = 0 for masked scores
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float a0 = expf(m0 - mn0), a1 = expf(m1 - mn1);
    float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
    for (int ni = 0; ni < 8; ++ni) {
      s[ni][0] = expf(s[ni][0] - mn0);
      s[ni][1] = expf(s[ni][1] - mn0);
      s[ni][2] = expf(s[ni][2] - mn1);
      s[ni][3] = expf(s[ni][3] - mn1);
      ls0 += s[ni][0] + s[ni][1];
      ls1 += s[ni][2] + s[ni][3];
    }
    l0 = l0 * a0 + ls0;
    l1 = l1 * a1 + ls1;
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int dn = 0; dn < DN; ++dn) {
      o[dn][0] *= a0;
      o[dn][1] *= a0;
      o[dn][2] *= a1;
      o[dn][3] *= a1;
    }
#pragma unroll
    for (int kc = 0; kc < BKV / 16; ++kc) {
      uint32_t pa[4] = {
          l3q::pack_bf16x2(s[2 * kc][0], s[2 * kc][1]),
          l3q::pack_bf16x2(s[2 * kc][2], s[2 * kc][3]),
          l3q::pack_bf16x2(s[2 * kc + 1][0], s[2 * kc + 1][1]),
          l3q::pack_bf16x2(s[2 * kc + 1][2], s[2 * kc + 1][3]),
      };
#pragma unroll
      for (int dn = 0; dn < DN; ++dn) {
        const int n = dn * 8 + gid;
        uint32_t bf[2] = {ld32(&Vt[n][kc * 16 + tig * 2]), ld32(&Vt[n][kc * 16 + 8 + tig * 2])};
        l3q::mma_bf16_16816(o[dn], pa, bf);
      }
    }
  }

#pragma unroll
  for (int o_ = 1; o_ <= 2; o_ <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, o_);
    l1 += __shfl_xor_sync(0xffffffffu, l1, o_);
  }
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
#pragma unroll
  for (int dn = 0; dn < DN; ++dn) {
    const int d = dn * 8 + tig * 2;
    if (r0 < S) {
      *reinterpret_cast<uint32_t*>(out + ((size_t)b * S + r0) * H * D + (size_t)h * D + d) =
          l3q::pack_bf16x2(o[dn][0] * inv0, o[dn][1] * inv0);
    }
    if (r1 < S) {
      *reinterpret_cast<uint32_t*>(out + ((size_t)b * S + r1) * H * D + (size_t)h * D + d) =
          l3q::pack_bf16x2(o[dn][2] * inv1, o[dn][3] * inv1);
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, int B, int S, int H, int G,
           float scale, cudaStream_t st) {
  dim3 grid((S + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<D><<<grid, THREADS, 0, st>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
      (__nv_bfloat16*)out, S, H, G, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q/out bf16 [B, S, H, D]; k/v bf16 [B, S, G, D]; D in {64, 128}; H % G == 0.
extern "C" int l3q_flash_attn_fwd(const void* q, const void* k, const void* v, void* out,
                                  int B, int S, int H, int G, int D, float scale,
                                  void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (D == 128) return launch<128>(q, k, v, out, B, S, H, G, scale, st);
  if (D == 64) return launch<64>(q, k, v, out, B, S, H, G, scale, st);
  return (int)cudaErrorInvalidValue;
}
