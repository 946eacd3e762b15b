// fp-cache single-token GQA flash decode: kernel B6.
//
// Replaces the TPU kernels `_decode_kernel` / `_decode_kernel_stacked`
// (llama3_quantization_tpu/ops/decode_attention.py:37,379), reached through
// `flash_decode_gqa` / `flash_decode_gqa_stacked`, on a bf16 or fp32 cache.
// The stacked form is this kernel on the layer view cache[l], which the
// caller passes as a pointer offset (no copy).
//
// Per (b, g) pair, over T blocks of `bt` tokens in order (as the TPU grid):
//   s     = f32(q[rep, D] . k[bt, D]^T)          q already in the cache dtype
//   s     = s * f32(1/sqrt(D)) + mask[b, block]   multiply, then add
//   m_new = max(m, rowmax(s)); alpha = exp(m - m_new); p = exp(s - m_new)
//   l     = l * alpha + rowsum(p); m = m_new
//   acc   = acc * alpha + f32(cast(p, cache dtype) . v[bt, D])
//   out   = cast(acc / l, cache dtype)              (no floor on l)
// with m = -1e30 and l = acc = 0 at the start. The float steps outside the
// dots use the _rn intrinsics, so no multiply-add is contracted into an FMA
// that the TPU kernel does not do; exp is expf. An all-masked row (mask
// -1e30 everywhere) gives p = 1 for every slot: the mean of v, l = T.
//
// What bounds it on the H100: it reads 2 * T * D * itemsize bytes per
// (b, g) and does 4 * rep * T * D flops on them (rep <= 8), far below the
// card's ~295 flops per byte, so it is bound by HBM bytes. This first
// design gives each (b, g) pair one 256-thread block that walks its T
// blocks in order: scores are one thread per token over 16-byte loads of
// its key row, with the rep query rows in shared memory; one warp per
// query row then runs the online softmax over the block; PV spreads 16-byte
// column chunks of each value row over a half-warp (neighbouring threads on
// neighbouring addresses) and sums the per-thread partials in a fixed order
// through shared memory. With B*G blocks only (8 at batch 1, 64 at the
// serving engine's 8 slots) it cannot fill the 132 SMs. Unlike B5, B6
// quantizes nothing per block, so splitting T across blocks (flash-decoding
// with a combine pass) would change only the fp32 summation order: that is
// the lever for a later redesign.

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

template <typename T>
struct Vec;
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;  // 16 bytes
  __device__ static void load(const __nv_bfloat16* p, float* f) {
    const int4 w = __ldg(reinterpret_cast<const int4*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&w);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 x = __bfloat1622float2(h[i]);
      f[2 * i] = x.x;
      f[2 * i + 1] = x.y;
    }
  }
  __device__ static float round(float v) { return l3q::bf16_round(v); }
  __device__ static void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
  __device__ static float get(const __nv_bfloat16* p) { return __bfloat162float(*p); }
};
template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void load(const float* p, float* f) {
    const float4 w = __ldg(reinterpret_cast<const float4*>(p));
    f[0] = w.x;
    f[1] = w.y;
    f[2] = w.z;
    f[3] = w.w;
  }
  __device__ static float round(float v) { return v; }
  __device__ static void store(float* p, float v) { *p = v; }
  __device__ static float get(const float* p) { return *p; }
};

template <typename T, int REP>
__global__ void __launch_bounds__(THREADS) decode_fp_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ mask, T* __restrict__ out, int G, int Tlen, int D, int bt,
    float scale) {
  constexpr int VN = Vec<T>::N;
  extern __shared__ __align__(16) unsigned char smem[];
  const int chunks = D / VN;            // 16-byte column chunks of a row
  const int nsl = THREADS / chunks;     // token slices of the PV pass
  float* S = reinterpret_cast<float*>(smem);  // [REP][bt] scores, then rounded p
  float* qs = S + REP * bt;                   // [REP][D]
  float* acc = qs + REP * D;                  // [REP][D]
  float* part = acc + REP * D;                // [nsl][REP][D]
  float* m_s = part + (size_t)nsl * REP * D;  // [REP]
  float* l_s = m_s + REP;
  float* al = l_s + REP;

  const int g = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int hq = G * REP;
  const size_t bg = (size_t)b * G + g;
  const T* kb = k + bg * Tlen * D;
  const T* vb = v + bg * Tlen * D;
  const float* mb = mask + (size_t)b * Tlen;

  for (int e = tid; e < REP * D; e += THREADS) {
    qs[e] = Vec<T>::get(q + ((size_t)b * hq + g * REP) * D + e);
    acc[e] = 0.f;
  }
  if (tid < REP) {
    m_s[tid] = -1e30f;
    l_s[tid] = 0.f;
  }
  __syncthreads();

  for (int t0 = 0; t0 < Tlen; t0 += bt) {
    // scores: one thread per token, 16-byte loads of its key row
    for (int t = tid; t < bt; t += THREADS) {
      const T* krow = kb + (size_t)(t0 + t) * D;
      float s[REP];
#pragma unroll
      for (int r = 0; r < REP; ++r) s[r] = 0.f;
      for (int c = 0; c < chunks; ++c) {
        float kf[VN];
        Vec<T>::load(krow + c * VN, kf);
#pragma unroll
        for (int r = 0; r < REP; ++r) {
          const float* qr = qs + r * D + c * VN;
#pragma unroll
          for (int j = 0; j < VN; ++j) s[r] = fmaf(qr[j], kf[j], s[r]);
        }
      }
      const float mt = __ldg(mb + t0 + t);
#pragma unroll
      for (int r = 0; r < REP; ++r) S[r * bt + t] = __fadd_rn(__fmul_rn(s[r], scale), mt);
    }
    __syncthreads();

    // online softmax: warp r takes query row r
    if (warp < REP) {
      float* Sr = S + warp * bt;
      float lm = -INFINITY;
      for (int t = lane; t < bt; t += 32) lm = fmaxf(lm, Sr[t]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) lm = fmaxf(lm, __shfl_xor_sync(0xffffffffu, lm, o));
      const float m_prev = m_s[warp];
      const float m_new = fmaxf(m_prev, lm);
      const float alpha = expf(__fsub_rn(m_prev, m_new));
      float ls = 0.f;
      for (int t = lane; t < bt; t += 32) {
        const float p = expf(__fsub_rn(Sr[t], m_new));
        ls = __fadd_rn(ls, p);
        Sr[t] = Vec<T>::round(p);  // p in the cache dtype for PV
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) ls = __fadd_rn(ls, __shfl_xor_sync(0xffffffffu, ls, o));
      if (lane == 0) {
        l_s[warp] = __fadd_rn(__fmul_rn(l_s[warp], alpha), ls);
        m_s[warp] = m_new;
        al[warp] = alpha;
      }
    }
    __syncthreads();

    // PV: thread (slice, chunk) sums its tokens; slices add up in order below
    {
      const int c = tid % chunks, sl = tid / chunks;
      if (sl < nsl) {
        float a[REP][VN];
#pragma unroll
        for (int r = 0; r < REP; ++r)
#pragma unroll
          for (int j = 0; j < VN; ++j) a[r][j] = 0.f;
        for (int t = sl; t < bt; t += nsl) {
          float vf[VN];
          Vec<T>::load(vb + (size_t)(t0 + t) * D + c * VN, vf);
#pragma unroll
          for (int r = 0; r < REP; ++r) {
            const float p = S[r * bt + t];
#pragma unroll
            for (int j = 0; j < VN; ++j) a[r][j] = fmaf(p, vf[j], a[r][j]);
          }
        }
#pragma unroll
        for (int r = 0; r < REP; ++r)
#pragma unroll
          for (int j = 0; j < VN; ++j) part[((size_t)sl * REP + r) * D + c * VN + j] = a[r][j];
      }
    }
    __syncthreads();
    for (int e = tid; e < REP * D; e += THREADS) {
      float pv = 0.f;
      for (int sl = 0; sl < nsl; ++sl) pv = __fadd_rn(pv, part[(size_t)sl * REP * D + e]);
      acc[e] = __fadd_rn(__fmul_rn(acc[e], al[e / D]), pv);
    }
    __syncthreads();
  }

  for (int e = tid; e < REP * D; e += THREADS) {
    const float o = __fdiv_rn(acc[e], l_s[e / D]);
    Vec<T>::store(out + ((size_t)b * hq + g * REP) * D + e, o);
  }
}

size_t smem_bytes(int rep, int d, int bt, int vn) {
  const int nsl = THREADS / (d / vn);
  return 4 * ((size_t)rep * bt + 2 * (size_t)rep * d + (size_t)nsl * rep * d + 3 * rep);
}

template <typename T, int REP>
int launch(const void* q, const void* k, const void* v, const void* mask, void* out, int B,
           int G, int Tlen, int D, int bt, float scale, cudaStream_t st) {
  const size_t smem = smem_bytes(REP, D, bt, Vec<T>::N);
  cudaError_t err = cudaFuncSetAttribute(
      decode_fp_kernel<T, REP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(G, B);
  decode_fp_kernel<T, REP><<<grid, THREADS, smem, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (const float*)mask, (T*)out, G, Tlen, D, bt, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_rep(int rep, const void* q, const void* k, const void* v, const void* mask, void* out,
               int B, int G, int Tlen, int D, int bt, float scale, cudaStream_t st) {
  switch (rep) {
    case 1: return launch<T, 1>(q, k, v, mask, out, B, G, Tlen, D, bt, scale, st);
    case 2: return launch<T, 2>(q, k, v, mask, out, B, G, Tlen, D, bt, scale, st);
    case 4: return launch<T, 4>(q, k, v, mask, out, B, G, Tlen, D, bt, scale, st);
    case 8: return launch<T, 8>(q, k, v, mask, out, B, G, Tlen, D, bt, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q [B, G*rep, D], k/v [B, G, T, D] and out [B, G*rep, D], all bf16 (bf16 = 1)
// or all fp32; mask fp32 [B, T] (finite). D % 8 == 0, D <= 256, T % bt == 0,
// rep in {1, 2, 4, 8}; scale is f32(1/sqrt(D)).
extern "C" int l3q_decode_fp(const void* q, const void* k, const void* v, const void* mask,
                             void* out, int bf16, int B, int G, int rep, int T, int D, int bt,
                             float scale, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (D % 8 || D > 256 || bt <= 0 || T % bt) return (int)cudaErrorInvalidValue;
  if (bf16) return launch_rep<__nv_bfloat16>(rep, q, k, v, mask, out, B, G, T, D, bt, scale, st);
  return launch_rep<float>(rep, q, k, v, mask, out, B, G, T, D, bt, scale, st);
}
