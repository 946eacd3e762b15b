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
// The T blocks stay sequential because each block's probabilities are
// quantized against its own running max. With stats, m and l are written
// after the last block: an all-masked row (mask -1e30 everywhere) ends with
// m = -1e30 and l = T, which the merge weights out through exp(m - m*).
//
// int4 rows: byte row r holds token 2r in the low nibble and 2r+1 in the
// high nibble, for each of the D columns (ops/kvcache.kv4_pack). A 16-byte
// load of row r gives 16 columns of both tokens; the nibbles are sign-
// extended to s8 with per-byte SIMD (__vsub4) and take the same __dp4a /
// exact integer PV path as int8. The integers equal the TPU's split-row
// int4 dot, which is exact.
//
// What bounds it on the H100: it reads 2*(D + 4) bytes (int8) or
// 2*(D/2 + 4) bytes (int4) per cached token per (b, g) and does 4*rep*D
// integer operations on them, so it is bound by HBM bytes. This first
// design gives each (b, g) pair one 256-thread block: the QK dot is one
// thread per token (a token pair for int4) with __dp4a over 16-byte loads,
// the PV dot spreads D/4 column quads over the threads with integer
// partials summed exactly in shared memory. With B*G blocks only (8 at
// batch 1, 64 at the serving engine's 8 slots) it cannot fill the card;
// splitting T across blocks changes the numerics and is left to a later
// redesign.

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

template <bool MAX>
__device__ float block_reduce(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float u = __shfl_xor_sync(0xffffffffu, v, o);
    v = MAX ? fmaxf(v, u) : v + u;
  }
  __syncthreads();  // red may still be read from the previous reduction
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = red[0];
#pragma unroll
  for (int w = 1; w < WARPS; ++w) r = MAX ? fmaxf(r, red[w]) : r + red[w];
  return r;
}

__device__ __forceinline__ float quant(float v, float s, float a) {
  return fminf(fmaxf(rintf(__fdiv_rn(v, s)), -a), a);
}

__device__ __forceinline__ int sx8(int w, int i) { return (int)(int8_t)((w >> (8 * i)) & 0xff); }

// Low / high nibbles of the four bytes of w, each sign-extended to s8.
__device__ __forceinline__ int nib_lo(int w) {
  return (int)__vsub4(((unsigned)w & 0x0F0F0F0Fu) ^ 0x08080808u, 0x08080808u);
}
__device__ __forceinline__ int nib_hi(int w) {
  return (int)__vsub4((((unsigned)w >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u, 0x08080808u);
}

template <int REP, bool INT4>
__global__ void __launch_bounds__(THREADS) decode_s8_kernel(
    const void* __restrict__ q, int q_bf16, const uint8_t* __restrict__ kq,
    const float* __restrict__ ks, const uint8_t* __restrict__ vq, const float* __restrict__ vs,
    const float* __restrict__ mask, void* __restrict__ out, int out_bf16,
    float* __restrict__ m_out, float* __restrict__ l_out, int G, int T, int D, int bt,
    float inv_sqrt_d, float amax) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* S = reinterpret_cast<float*>(smem);        // [REP][bt]
  float* acc = S + REP * bt;                         // [REP][D]
  int* pvi = reinterpret_cast<int*>(acc + REP * D);  // [REP][D]
  float* m_s = reinterpret_cast<float*>(pvi + REP * D);
  float* l_s = m_s + REP;
  float* qsc = l_s + REP;
  float* al = qsc + REP;
  float* ps_s = al + REP;
  float* red = ps_s + REP;                           // [WARPS]
  int* qw = reinterpret_cast<int*>(red + WARPS);     // [REP][D/4] packed s8
  int8_t* P = reinterpret_cast<int8_t*>(qw + REP * D / 4);  // [REP][bt]

  const int g = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int hq = G * REP, d4 = D / 4;

  for (int r = 0; r < REP; ++r) {
    const size_t qi = ((size_t)b * hq + g * REP + r) * D + tid;
    float qv = 0.f;
    if (tid < D) {
      qv = q_bf16 ? __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(q)[qi])
                  : reinterpret_cast<const float*>(q)[qi];
    }
    const float qa = block_reduce<true>(fabsf(qv), red);
    const float qs = __fdiv_rn(fmaxf(qa, 1e-8f), amax);
    if (tid < D) reinterpret_cast<int8_t*>(qw)[r * D + tid] = (int8_t)quant(qv, qs, amax);
    if (tid == 0) {
      qsc[r] = __fmul_rn(qs, inv_sqrt_d);
      m_s[r] = -1e30f;
      l_s[r] = 0.f;
    }
  }
  for (int e = tid; e < REP * D; e += THREADS) acc[e] = 0.f;
  __syncthreads();

  const size_t bg = (size_t)b * G + g;
  const size_t rows = INT4 ? T / 2 : T;  // code rows per (b, g)
  const uint8_t* kb = kq + bg * rows * D;
  const uint8_t* vb = vq + bg * rows * D;
  const float* ksb = ks + bg * T;
  const float* vsb = vs + bg * T;
  const float* mb = mask + (size_t)b * T;

  for (int t0 = 0; t0 < T; t0 += bt) {
    // scores: s32 dots via dp4a, one thread per token (per token pair for int4)
    if (!INT4) {
      for (int t = tid; t < bt; t += THREADS) {
        const int4* krow = reinterpret_cast<const int4*>(kb + (size_t)(t0 + t) * D);
        int s32[REP];
#pragma unroll
        for (int r = 0; r < REP; ++r) s32[r] = 0;
        for (int w = 0; w < d4 / 4; ++w) {
          const int4 kv = __ldg(krow + w);
#pragma unroll
          for (int r = 0; r < REP; ++r) {
            const int* qr = qw + r * d4 + 4 * w;
            s32[r] = __dp4a(kv.x, qr[0], s32[r]);
            s32[r] = __dp4a(kv.y, qr[1], s32[r]);
            s32[r] = __dp4a(kv.z, qr[2], s32[r]);
            s32[r] = __dp4a(kv.w, qr[3], s32[r]);
          }
        }
        const float kst = __ldg(ksb + t0 + t), mt = __ldg(mb + t0 + t);
#pragma unroll
        for (int r = 0; r < REP; ++r)
          S[r * bt + t] = __fadd_rn(__fmul_rn(__fmul_rn((float)s32[r], qsc[r]), kst), mt);
      }
    } else {
      for (int rr = tid; rr < bt / 2; rr += THREADS) {
        const int4* krow = reinterpret_cast<const int4*>(kb + (size_t)(t0 / 2 + rr) * D);
        int s0[REP], s1[REP];
#pragma unroll
        for (int r = 0; r < REP; ++r) s0[r] = s1[r] = 0;
        for (int w = 0; w < d4 / 4; ++w) {
          const int4 kv = __ldg(krow + w);
          const int kx[4] = {kv.x, kv.y, kv.z, kv.w};
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int lo = nib_lo(kx[c]), hi = nib_hi(kx[c]);
#pragma unroll
            for (int r = 0; r < REP; ++r) {
              const int qv = qw[r * d4 + 4 * w + c];
              s0[r] = __dp4a(lo, qv, s0[r]);
              s1[r] = __dp4a(hi, qv, s1[r]);
            }
          }
        }
        const int t = t0 + 2 * rr;
        const float k0 = __ldg(ksb + t), k1 = __ldg(ksb + t + 1);
        const float m0 = __ldg(mb + t), m1 = __ldg(mb + t + 1);
#pragma unroll
        for (int r = 0; r < REP; ++r) {
          S[r * bt + 2 * rr] = __fadd_rn(__fmul_rn(__fmul_rn((float)s0[r], qsc[r]), k0), m0);
          S[r * bt + 2 * rr + 1] = __fadd_rn(__fmul_rn(__fmul_rn((float)s1[r], qsc[r]), k1), m1);
        }
      }
    }
    __syncthreads();

    // online softmax and per-block probability quantization, row by row
    for (int r = 0; r < REP; ++r) {
      float* Sr = S + r * bt;
      float lm = -INFINITY;
      for (int t = tid; t < bt; t += THREADS) lm = fmaxf(lm, Sr[t]);
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, block_reduce<true>(lm, red));
      const float alpha = expf(__fsub_rn(m_prev, m_new));
      float lsum = 0.f, la = 0.f;
      for (int t = tid; t < bt; t += THREADS) {
        const float p = expf(__fsub_rn(Sr[t], m_new));
        lsum += p;
        const float pv = __fmul_rn(p, __ldg(vsb + t0 + t));
        Sr[t] = pv;
        la = fmaxf(la, fabsf(pv));
      }
      const float psum = block_reduce<false>(lsum, red);
      const float ps = __fdiv_rn(fmaxf(block_reduce<true>(la, red), 1e-20f), amax);
      for (int t = tid; t < bt; t += THREADS) P[r * bt + t] = (int8_t)quant(Sr[t], ps, amax);
      if (tid == 0) {
        l_s[r] = __fadd_rn(__fmul_rn(l_s[r], alpha), psum);
        m_s[r] = m_new;
        al[r] = alpha;
        ps_s[r] = ps;
      }
    }
    for (int e = tid; e < REP * D; e += THREADS) pvi[e] = 0;
    __syncthreads();

    // PV: s32 partials per column quad and token slice, summed exactly
    {
      const int dq = tid % d4, sl = tid / d4, nsl = THREADS / d4;
      int a[REP][4];
#pragma unroll
      for (int r = 0; r < REP; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) a[r][c] = 0;
      if (!INT4) {
        for (int t = sl; t < bt; t += nsl) {
          const int vw = __ldg(reinterpret_cast<const int*>(vb + (size_t)(t0 + t) * D) + dq);
          const int v0 = sx8(vw, 0), v1 = sx8(vw, 1), v2 = sx8(vw, 2), v3 = sx8(vw, 3);
#pragma unroll
          for (int r = 0; r < REP; ++r) {
            const int p = P[r * bt + t];
            a[r][0] += p * v0;
            a[r][1] += p * v1;
            a[r][2] += p * v2;
            a[r][3] += p * v3;
          }
        }
      } else {
        for (int rr = sl; rr < bt / 2; rr += nsl) {
          const int vw = __ldg(reinterpret_cast<const int*>(vb + (size_t)(t0 / 2 + rr) * D) + dq);
          const int lo = nib_lo(vw), hi = nib_hi(vw);
          const int v0 = sx8(lo, 0), v1 = sx8(lo, 1), v2 = sx8(lo, 2), v3 = sx8(lo, 3);
          const int u0 = sx8(hi, 0), u1 = sx8(hi, 1), u2 = sx8(hi, 2), u3 = sx8(hi, 3);
#pragma unroll
          for (int r = 0; r < REP; ++r) {
            const int p0 = P[r * bt + 2 * rr], p1 = P[r * bt + 2 * rr + 1];
            a[r][0] += p0 * v0 + p1 * u0;
            a[r][1] += p0 * v1 + p1 * u1;
            a[r][2] += p0 * v2 + p1 * u2;
            a[r][3] += p0 * v3 + p1 * u3;
          }
        }
      }
#pragma unroll
      for (int r = 0; r < REP; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) atomicAdd(&pvi[r * D + dq * 4 + c], a[r][c]);
    }
    __syncthreads();
    for (int e = tid; e < REP * D; e += THREADS) {
      const int r = e / D;
      acc[e] = __fadd_rn(__fmul_rn(acc[e], al[r]), __fmul_rn((float)pvi[e], ps_s[r]));
    }
    __syncthreads();
  }

  for (int e = tid; e < REP * D; e += THREADS) {
    const int r = e / D, d = e % D;
    const float v = __fdiv_rn(acc[e], fmaxf(l_s[r], 1e-30f));
    l3q::store_out(out, ((size_t)b * hq + g * REP + r) * D + d, v, out_bf16);
  }
  if (m_out != nullptr && tid < REP) {
    m_out[bg * REP + tid] = m_s[tid];
    l_out[bg * REP + tid] = l_s[tid];
  }
}

size_t smem_bytes(int rep, int d, int bt) {
  return (size_t)rep * bt * 4 + 2 * (size_t)rep * d * 4 + 5 * rep * 4 + WARPS * 4 +
         (size_t)rep * d + (size_t)rep * bt;
}

template <int REP, bool INT4>
int launch(const void* q, int q_bf16, const void* kq, const void* ks, const void* vq,
           const void* vs, const void* mask, void* out, int out_bf16, void* m_out, void* l_out,
           int B, int G, int T, int D, int bt, float inv_sqrt_d, float amax, cudaStream_t st) {
  const size_t smem = smem_bytes(REP, D, bt);
  cudaError_t err = cudaFuncSetAttribute(
      decode_s8_kernel<REP, INT4>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(G, B);
  decode_s8_kernel<REP, INT4><<<grid, THREADS, smem, st>>>(
      q, q_bf16, (const uint8_t*)kq, (const float*)ks, (const uint8_t*)vq, (const float*)vs,
      (const float*)mask, out, out_bf16, (float*)m_out, (float*)l_out, G, T, D, bt, inv_sqrt_d,
      amax);
  return (int)cudaGetLastError();
}

template <bool INT4>
int launch_rep(int rep, const void* q, int q_bf16, const void* kq, const void* ks,
               const void* vq, const void* vs, const void* mask, void* out, int out_bf16,
               void* m_out, void* l_out, int B, int G, int T, int D, int bt, float inv_sqrt_d,
               float amax, cudaStream_t st) {
  switch (rep) {
    case 1: return launch<1, INT4>(q, q_bf16, kq, ks, vq, vs, mask, out, out_bf16, m_out, l_out, B, G, T, D, bt, inv_sqrt_d, amax, st);
    case 2: return launch<2, INT4>(q, q_bf16, kq, ks, vq, vs, mask, out, out_bf16, m_out, l_out, B, G, T, D, bt, inv_sqrt_d, amax, st);
    case 4: return launch<4, INT4>(q, q_bf16, kq, ks, vq, vs, mask, out, out_bf16, m_out, l_out, B, G, T, D, bt, inv_sqrt_d, amax, st);
    case 8: return launch<8, INT4>(q, q_bf16, kq, ks, vq, vs, mask, out, out_bf16, m_out, l_out, B, G, T, D, bt, inv_sqrt_d, amax, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q [B, G*rep, D] (bf16 or fp32); kq/vq int8 [B, G, T, D], or with int4 = 1
// uint8 [B, G, T/2, D] (T-pair-packed nibbles); ks/vs fp32 [B, G, T]; mask
// fp32 [B, T] (finite); out [B, G*rep, D]; m_out/l_out fp32 [B, G, rep] or
// null for no stats. amax is 127 (int8) or 119 (int4). D % 16 == 0,
// D <= 256, T % bt == 0 (and bt even for int4), rep in {1, 2, 4, 8}.
extern "C" int l3q_decode_s8(const void* q, int q_bf16, const void* kq, const void* ks,
                             const void* vq, const void* vs, const void* mask, void* out,
                             int out_bf16, void* m_out, void* l_out, int B, int G, int rep,
                             int T, int D, int bt, int int4, float inv_sqrt_d, float amax,
                             void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (D % 16 || D > 256 || bt <= 0 || T % bt || (int4 && bt % 2) || (m_out == nullptr) != (l_out == nullptr))
    return (int)cudaErrorInvalidValue;
  if (int4)
    return launch_rep<true>(rep, q, q_bf16, kq, ks, vq, vs, mask, out, out_bf16, m_out, l_out, B, G, T, D, bt, inv_sqrt_d, amax, st);
  return launch_rep<false>(rep, q, q_bf16, kq, ks, vq, vs, mask, out, out_bf16, m_out, l_out, B, G, T, D, bt, inv_sqrt_d, amax, st);
}
