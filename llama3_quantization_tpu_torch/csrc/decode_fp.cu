// fp-cache single-token GQA flash decode: kernel B6, split along T.
//
// Replaces the TPU kernels `_decode_kernel` / `_decode_kernel_stacked`
// (llama3_quantization_tpu/ops/decode_attention.py:37,379), reached through
// `flash_decode_gqa` / `flash_decode_gqa_stacked`, on a bf16 or fp32 cache.
// The stacked form is this kernel on the layer view cache[l], which the
// caller passes as a pointer offset (no copy).
//
// The TPU kernel walks T blocks of `bt` tokens in order, per (b, g):
//   s     = f32(q[rep, D] . k[bt, D]^T)          q already in the cache dtype
//   s     = s * f32(1/sqrt(D)) + mask[b, block]   multiply, then add
//   m_new = max(m, rowmax(s)); alpha = exp(m - m_new); p = exp(s - m_new)
//   l     = l * alpha + rowsum(p); m = m_new
//   acc   = acc * alpha + f32(cast(p, cache dtype) . v[bt, D])
//   out   = cast(acc / l, cache dtype)              (no floor on l)
// with m = -1e30 and l = acc = 0 at the start. An all-masked row (mask
// -1e30 everywhere) gives p = 1 for every slot: the mean of v, l = T.
//
// What bounds it on the H100: it reads 2 * T * D * itemsize bytes per
// (b, g) and does 4 * rep * T * D flops on them (rep <= 8), far below the
// card's ~295 flops per byte, so it is bound by HBM bytes. To stream them
// at the card's rate it must keep all 132 SMs reading: B * G blocks (8 at
// batch 1) cannot. So the T axis is split into chunks of `c` tokens that
// tile each T block, chosen by the wrapper from (B * G, T) so that the grid
// (chunk, g, b) holds at least 132 blocks, in three launches:
//   1. scores: s for the chunk, with the rounding points above, into an
//      fp32 scratch [B, G, rep, T], and the chunk's row maxima;
//   2. probabilities and PV: each block forms the prefix max of the chunk
//      maxima of every T block up to and including its own, from -1e30:
//      exactly the m_new the sequential kernel holds in that T block. So
//      p = exp(s - m_prefix), rounded to the cache dtype, is the p the TPU
//      kernel forms from the same scores, bit for bit (the catch of a naive
//      split: a chunk-local max would round every p of a bf16 cache
//      differently). The block
//      writes its l partial (unrounded p), its PV partial [rep, D] (fp32)
//      and m_prefix;
//   3. combine, per (b, g, row): every chunk's partials scaled by
//      exp(m_prefix - M), M the last chunk's m_prefix, summed in chunk
//      order, acc / l cast to the cache dtype.
// The result differs from the sequential recurrence only in fp32 order: a
// product of the per-block alphas becomes one exp per chunk. An all-masked
// row keeps m_prefix = -1e30 in every chunk: p = 1, weights 1, l = T.
// Three launches of small blocks: their latency, not bytes, sets the floor
// at these sizes. Loads: a half-warp reads one key or value row as 16-byte vectors,
// neighbouring threads on neighbouring addresses. Float steps outside the
// dots use the _rn intrinsics, so no multiply-add is contracted into an
// FMA that the TPU kernel does not do; exp is expf. The kernels allocate
// nothing: the wrapper hands in the scratch.

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int TEAM = 16;               // threads reading one row
constexpr int TEAMS = THREADS / TEAM;  // rows in flight per block
constexpr float NEG = -1e30f;

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

// Scratch of one call, fp32, [B, G] leading:
//   S   [B, G, REP, T]       scores
//   CM  [B, G, REP, NC]      chunk row maxima
//   MP  [B, G, REP, NC]      m_prefix of each chunk
//   LP  [B, G, REP, NC]      l partials
//   PVP [B, G, NC, REP, D]   PV partials
struct Scratch {
  float *S, *CM, *MP, *LP, *PVP;
};

__device__ __forceinline__ float team_sum(float v) {
#pragma unroll
  for (int o = TEAM / 2; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// 1. scores and chunk maxima; grid (NC, G, B)
template <typename T, int REP>
__global__ void __launch_bounds__(THREADS) fp_scores_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const float* __restrict__ mask,
    Scratch sc, int G, int Tlen, int D, int c, float scale) {
  constexpr int VN = Vec<T>::N;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;              // [REP][D]
  float* tmax = qs + REP * D;    // [TEAMS][REP]
  const int j = blockIdx.x, g = blockIdx.y, b = blockIdx.z, nc = gridDim.x;
  const int tid = threadIdx.x, team = tid / TEAM, tl = tid % TEAM;
  const size_t bg = (size_t)b * G + g;
  const int t0 = j * c;
  for (int e = tid; e < REP * D; e += THREADS)
    qs[e] = Vec<T>::get(q + (bg * REP) * D + e);  // q [B, G*REP, D]: rows g*REP.. of b
  __syncthreads();

  const int chunks = D / VN;
  const T* kb = k + (bg * Tlen + t0) * D;
  const float* mb = mask + (size_t)b * Tlen + t0;
  float* Sb = sc.S + bg * REP * Tlen + t0;
  float mx[REP];
#pragma unroll
  for (int r = 0; r < REP; ++r) mx[r] = -INFINITY;
  for (int tb = 0; tb < c; tb += TEAMS) {  // every lane of a warp runs team_sum
    const int t = tb + team;
    const bool ok = t < c;
    float s[REP];
#pragma unroll
    for (int r = 0; r < REP; ++r) s[r] = 0.f;
    for (int cc = tl; ok && cc < chunks; cc += TEAM) {
      float kf[VN];
      Vec<T>::load(kb + (size_t)t * D + cc * VN, kf);
#pragma unroll
      for (int r = 0; r < REP; ++r) {
        const float* qr = qs + r * D + cc * VN;
#pragma unroll
        for (int i = 0; i < VN; ++i) s[r] = fmaf(qr[i], kf[i], s[r]);
      }
    }
    const float mt = ok ? __ldg(mb + t) : 0.f;
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      const float v = __fadd_rn(__fmul_rn(team_sum(s[r]), scale), mt);
      if (ok) {
        if (tl == 0) Sb[(size_t)r * Tlen + t] = v;
        mx[r] = fmaxf(mx[r], v);
      }
    }
  }
  if (tl == 0) {
#pragma unroll
    for (int r = 0; r < REP; ++r) tmax[team * REP + r] = mx[r];
  }
  __syncthreads();
  if (tid < REP) {
    float m = -INFINITY;
    for (int w = 0; w < TEAMS; ++w) m = fmaxf(m, tmax[w * REP + tid]);
    sc.CM[(bg * REP + tid) * nc + j] = m;
  }
}

// 2. prefix max, probabilities, l and PV partials; grid (NC, G, B)
template <typename T, int REP>
__global__ void __launch_bounds__(THREADS) fp_pv_kernel(
    const T* __restrict__ v, Scratch sc, int G, int Tlen, int D, int bt, int c) {
  constexpr int VN = Vec<T>::N;
  extern __shared__ __align__(16) float smem[];
  const int chunks = D / VN;
  const int nsl = THREADS / chunks;  // token slices of the PV pass
  float* P = smem;                   // [REP][c] rounded p
  float* part = P + REP * c;         // [nsl][REP][D]
  float* mp_s = part + (size_t)nsl * REP * D;  // [REP]
  const int j = blockIdx.x, g = blockIdx.y, b = blockIdx.z, nc = gridDim.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t bg = (size_t)b * G + g;
  const int t0 = j * c;
  const int upto = (t0 / bt + 1) * (bt / c);  // chunks of T blocks 0..own

  // m_prefix: warp r reduces row r's chunk maxima up to its own T block
  for (int r = warp; r < REP; r += THREADS / 32) {
    const float* cm = sc.CM + (bg * REP + r) * nc;
    float m = NEG;
    for (int i = lane; i < upto; i += 32) m = fmaxf(m, cm[i]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    if (lane == 0) mp_s[r] = m;
  }
  __syncthreads();

  // p = exp(s - m_prefix): l from the unrounded p, P rounded for PV
  for (int r = warp; r < REP; r += THREADS / 32) {
    const float* Sr = sc.S + (bg * REP + r) * Tlen + t0;
    const float m = mp_s[r];
    float ls = 0.f;
    for (int t = lane; t < c; t += 32) {
      const float p = expf(__fsub_rn(Sr[t], m));
      ls = __fadd_rn(ls, p);
      P[r * c + t] = Vec<T>::round(p);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) ls = __fadd_rn(ls, __shfl_xor_sync(0xffffffffu, ls, o));
    if (lane == 0) {
      sc.LP[(bg * REP + r) * nc + j] = ls;
      sc.MP[(bg * REP + r) * nc + j] = m;
    }
  }
  __syncthreads();

  // PV: thread (slice, column chunk) sums its tokens; slices in order below
  const T* vb = v + (bg * Tlen + t0) * D;
  {
    const int cc = tid % chunks, sl = tid / chunks;
    if (sl < nsl) {
      float a[REP][VN];
#pragma unroll
      for (int r = 0; r < REP; ++r)
#pragma unroll
        for (int i = 0; i < VN; ++i) a[r][i] = 0.f;
      for (int t = sl; t < c; t += nsl) {
        float vf[VN];
        Vec<T>::load(vb + (size_t)t * D + cc * VN, vf);
#pragma unroll
        for (int r = 0; r < REP; ++r) {
          const float p = P[r * c + t];
#pragma unroll
          for (int i = 0; i < VN; ++i) a[r][i] = fmaf(p, vf[i], a[r][i]);
        }
      }
#pragma unroll
      for (int r = 0; r < REP; ++r)
#pragma unroll
        for (int i = 0; i < VN; ++i) part[((size_t)sl * REP + r) * D + cc * VN + i] = a[r][i];
    }
  }
  __syncthreads();
  float* out = sc.PVP + (bg * nc + j) * REP * D;
  for (int e = tid; e < REP * D; e += THREADS) {
    float pv = 0.f;
    for (int sl = 0; sl < nsl; ++sl) pv = __fadd_rn(pv, part[(size_t)sl * REP * D + e]);
    out[e] = pv;
  }
}

// 3. combine in chunk order; grid (REP, G, B), D threads
template <typename T>
__global__ void fp_combine_kernel(Scratch sc, T* __restrict__ out, int G, int REP, int D,
                                  int nc) {
  const int r = blockIdx.x, g = blockIdx.y, b = blockIdx.z, col = threadIdx.x;
  const size_t bg = (size_t)b * G + g;
  const float* mp = sc.MP + (bg * REP + r) * nc;
  const float* lp = sc.LP + (bg * REP + r) * nc;
  const float* pvp = sc.PVP + bg * nc * REP * D + (size_t)r * D + col;
  const float M = mp[nc - 1];
  float acc = 0.f, l = 0.f;
  for (int i = 0; i < nc; ++i) {
    const float w = expf(__fsub_rn(mp[i], M));
    l = __fadd_rn(l, __fmul_rn(lp[i], w));
    acc = __fadd_rn(acc, __fmul_rn(pvp[(size_t)i * REP * D], w));
  }
  Vec<T>::store(out + (bg * REP + r) * D + col, __fdiv_rn(acc, l));
}

template <typename T, int REP>
int launch(const void* q, const void* k, const void* v, const void* mask, void* out,
           float* scratch, int B, int G, int Tlen, int D, int bt, int c, float scale,
           cudaStream_t st) {
  const int nc = Tlen / c;
  const size_t bgr = (size_t)B * G * REP;
  Scratch sc;
  sc.S = scratch;
  sc.CM = sc.S + bgr * Tlen;
  sc.MP = sc.CM + bgr * nc;
  sc.LP = sc.MP + bgr * nc;
  sc.PVP = sc.LP + bgr * nc;
  const dim3 grid(nc, G, B);

  const size_t smem1 = 4 * ((size_t)REP * D + TEAMS * REP);
  fp_scores_kernel<T, REP><<<grid, THREADS, smem1, st>>>(
      (const T*)q, (const T*)k, (const float*)mask, sc, G, Tlen, D, c, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const int nsl = THREADS / (D / Vec<T>::N);
  const size_t smem2 = 4 * ((size_t)REP * c + (size_t)nsl * REP * D + REP);
  err = cudaFuncSetAttribute(fp_pv_kernel<T, REP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem2);
  if (err != cudaSuccess) return (int)err;
  fp_pv_kernel<T, REP><<<grid, THREADS, smem2, st>>>((const T*)v, sc, G, Tlen, D, bt, c);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  fp_combine_kernel<T><<<dim3(REP, G, B), D, 0, st>>>(sc, (T*)out, G, REP, D, nc);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_rep(int rep, const void* q, const void* k, const void* v, const void* mask, void* out,
               float* scratch, int B, int G, int Tlen, int D, int bt, int c, float scale,
               cudaStream_t st) {
  switch (rep) {
    case 1: return launch<T, 1>(q, k, v, mask, out, scratch, B, G, Tlen, D, bt, c, scale, st);
    case 2: return launch<T, 2>(q, k, v, mask, out, scratch, B, G, Tlen, D, bt, c, scale, st);
    case 4: return launch<T, 4>(q, k, v, mask, out, scratch, B, G, Tlen, D, bt, c, scale, st);
    case 8: return launch<T, 8>(q, k, v, mask, out, scratch, B, G, Tlen, D, bt, c, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q [B, G*rep, D], k/v [B, G, T, D] and out [B, G*rep, D], all bf16 (bf16 = 1)
// or all fp32; mask fp32 [B, T] (finite). D % 8 == 0, D <= 256, T % bt == 0,
// bt % c == 0, rep in {1, 2, 4, 8}; scale is f32(1/sqrt(D)). scratch: fp32,
// B*G*rep*(T + 3*T/c) + B*G*(T/c)*rep*D elements (see Scratch).
extern "C" int l3q_decode_fp(const void* q, const void* k, const void* v, const void* mask,
                             void* out, void* scratch, int bf16, int B, int G, int rep, int T,
                             int D, int bt, int c, float scale, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (D % 8 || D > 256 || bt <= 0 || c <= 0 || T % bt || bt % c) return (int)cudaErrorInvalidValue;
  float* s = (float*)scratch;
  if (bf16)
    return launch_rep<__nv_bfloat16>(rep, q, k, v, mask, out, s, B, G, T, D, bt, c, scale, st);
  return launch_rep<float>(rep, q, k, v, mask, out, s, B, G, T, D, bt, c, scale, st);
}
