// Shared helpers for the port's hand-written Hopper kernels (sm_90a).
#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

// A timing switch, 0 in the normal build: each bit removes one phase of a
// kernel so that the rest can be timed without it (the results are then
// wrong). B3's tiled form: 1 the unpack, 2 the group epilogue, 4 the
// wgmma; B7: 8 the V loads, 16 the exp, 32 the PV wgmma; the GEMVs (B1
// and B3's GEMV form): 64 the unpack, 128 the mma.sync, 256 all compute
// (copies only); B4/B5: 512 all compute and the cluster exchanges (copies
// only); B9/B10 (the weight-stream probes): 1024 all compute, the
// exchanges and the epilogue (copies only); B7.dkv and B7.dq: 2048 every
// wgmma, exp and epilogue product (copies only: the TMA ring, the rows'
// statistics, the stores). `ops/_build.py` passes it from the environment
// variable of the same name.
#ifndef L3Q_ABLATE
#define L3Q_ABLATE 0
#endif

namespace l3q {

// Round a float to the nearest bf16 and back (round half to even).
__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// The bits of a bf16 pair as one register, and back.
__device__ __forceinline__ __nv_bfloat162 as_bf162(uint32_t v) {
  return *reinterpret_cast<__nv_bfloat162*>(&v);
}
__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void store_out(void* out, size_t i, float v, int out_bf16) {
  if (out_bf16) {
    reinterpret_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16_rn(v);
  } else {
    reinterpret_cast<float*>(out)[i] = v;
  }
}

// D += A * B for one m16n8k16 tile: bf16 operands, fp32 accumulation.
// A: 4 regs (row-major fragment), B: 2 regs (column fragment), D: 4 floats.
__device__ __forceinline__ void mma_bf16_16816(float* d, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Four 8x8 b16 matrices from shared memory: lanes 8i..8i+7 give the row
// addresses of matrix i, whose fragment lands in r[i].
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* smem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

// Two 8x8 b16 matrices: lanes 8i..8i+7 give the row addresses of matrix i
// (lanes 16-31 are ignored).
__device__ __forceinline__ void ldmatrix_x2(uint32_t* r, const void* smem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(s));
}

// The same, transposed: lane (g, t) of matrix i gets elements (2t, g) and
// (2t + 1, g), i.e. for byte rows of 16 bytes the bytes 2g, 2g + 1 of rows
// 2t and 2t + 1.
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t* r, const void* smem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(s));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* smem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}
__device__ __forceinline__ void ldmatrix_x1_trans(uint32_t* r, const void* smem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("ldmatrix.sync.aligned.m8n8.x1.trans.shared.b16 {%0}, [%1];\n"
               : "=r"(r[0])
               : "r"(s));
}

// Byte columns of two ldmatrix.trans matrices of byte rows: r0 from rows
// 0-7, r1 from rows 8-15 of one 16-byte column block. c[0] gets column 2g
// of rows 2t, 2t + 1, 8 + 2t, 9 + 2t (row 2t in the low byte), c[1] column
// 2g + 1 of the same rows (lane (g, t)).
__device__ __forceinline__ void trans_cols(uint32_t r0, uint32_t r1, uint32_t* c) {
  c[0] = __byte_perm(r0, r1, 0x6420);
  c[1] = __byte_perm(r0, r1, 0x7531);
}

// n / d for n >= 0, by a shift where d is a power of 2.
struct Div {
  int d, sh;
  __host__ __device__ explicit Div(int d_) : d(d_), sh(-1) {
    if (d_ > 0 && (d_ & (d_ - 1)) == 0)
      for (sh = 0; (1 << sh) < d_;) ++sh;
  }
  __device__ __forceinline__ int operator()(int n) const { return sh >= 0 ? n >> sh : n / d; }
};

// Launch `kernel` on `grid` with thread-block clusters of (1, cy, 1) blocks
// (cy == 1: an ordinary launch).
template <typename... Params, typename... Args>
inline int launch_clustered(void (*kernel)(Params...), dim3 grid, int threads, size_t smem,
                            int cy, cudaStream_t st, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = cy;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, kernel, static_cast<Params>(args)...);
}

// Thread-block cluster: the barrier (release / acquire: shared memory
// written before it is visible to the cluster after it), and a load from
// the shared memory of block `rank` at the address of `p` in this one.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// (Not volatile: after cluster_sync the loads of one element from every
// rank can be in flight together.)
__device__ __forceinline__ uint32_t ld_cluster_u32(const void* p, unsigned rank) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  unsigned ra;
  uint32_t v;
  asm("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(ra) : "r"(a), "r"(rank));
  asm("ld.shared::cluster.u32 %0, [%1];\n" : "=r"(v) : "r"(ra));
  return v;
}

// The cluster barrier split in two: arrive without ordering memory, and
// wait (acquire). Between them a block may work on; remote shared memory
// may be touched only once every block of the cluster has arrived.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}
// Arrive with release: this thread's writes, remote ones included, are
// visible to the cluster once its wait returns.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

// An s32 add to the shared memory of block `rank` at the address of `p` in
// this one, without a return value (exact in any order).
__device__ __forceinline__ void red_cluster_add(int* p, unsigned rank, int v) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  unsigned ra;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(ra) : "r"(a), "r"(rank));
  asm volatile("red.relaxed.cluster.shared::cluster.add.s32 [%0], %1;\n" ::"r"(ra), "r"(v)
               : "memory");
}

// An asynchronous 4-byte store to the shared memory of block `rank` at the
// address of `p` in this one, counted as 4 bytes of the transaction on the
// mbarrier at the address of `bar` there: a point-to-point exchange that
// needs no cluster barrier (the receiver waits on its own mbarrier).
__device__ __forceinline__ void st_async_u32(void* p, uint64_t* bar, unsigned rank, uint32_t v) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  const unsigned m = (unsigned)__cvta_generic_to_shared(bar);
  unsigned ra, rm;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(ra) : "r"(a), "r"(rank));
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(rm) : "r"(m), "r"(rank));
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];\n"
               ::"r"(ra), "r"(v), "r"(rm) : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// D += A * B for one m16n8k32 tile: s8 operands, s32 accumulation.
__device__ __forceinline__ void mma_s8_16832(int* d, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// r[i] holds columns 0..3 (one byte each) of row i; c[j] gets rows 0..3 of
// column j, row 0 in the low byte.
__device__ __forceinline__ void transpose4(const uint32_t* r, uint32_t* c) {
  const uint32_t t0 = __byte_perm(r[0], r[1], 0x5140);
  const uint32_t t1 = __byte_perm(r[2], r[3], 0x5140);
  const uint32_t t2 = __byte_perm(r[0], r[1], 0x7362);
  const uint32_t t3 = __byte_perm(r[2], r[3], 0x7362);
  c[0] = __byte_perm(t0, t1, 0x5410);
  c[1] = __byte_perm(t0, t1, 0x7632);
  c[2] = __byte_perm(t2, t3, 0x5410);
  c[3] = __byte_perm(t2, t3, 0x7632);
}

// Bytes of a shared-memory row of `bytes`, padded to an odd number of
// 16-byte chunks: rows 2 apart and 8 consecutive rows (ldmatrix) fall on
// distinct banks.
__host__ __device__ constexpr int odd_row(int bytes) { return 16 * (((bytes + 15) / 16) | 1); }

// Asynchronous 16-byte copy from global to shared memory (L2 only), and its
// group fence: `cp_async_wait<N>` returns once at most N groups of this
// thread are still in flight.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

// The same copy with a zero fill in place of the source when !valid (the
// source address is then not read).
__device__ __forceinline__ void cp_async16_zfill(void* smem, const void* gmem, bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}

// The same for 8 bytes (through L1: .cg takes 16-byte copies only).
__device__ __forceinline__ void cp_async8_zfill(void* smem, const void* gmem, bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  const int n = valid ? 8 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// cp_async_wait<n> for a run-time n in 0..N.
template <int N>
__device__ __forceinline__ void cp_async_wait_upto(int n) {
  if (n >= N) {
    cp_async_wait<N>();
  } else if constexpr (N > 0) {
    cp_async_wait_upto<N - 1>(n);
  }
}

// Named barrier `id` over `n` threads: wait for all of them, or arrive
// without waiting (0 is __syncthreads).
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// mbarrier and TMA (cp.async.bulk.tensor) helpers. A barrier completes a
// phase when its one arrival (`mbar_expect_tx`) and the announced bytes
// have come in; waiters pass the phase's parity.
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(bar);
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(a), "r"(count) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Barriers `bar[0..n)` each with `count` arrivals, behind a single fence
// (the fence costs hundreds of cycles: one for all of them).
__device__ __forceinline__ void mbar_init_n(uint64_t* bar, int n, int count = 1) {
  for (int i = 0; i < n; ++i) {
    const unsigned a = (unsigned)__cvta_generic_to_shared(bar + i);
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(a), "r"(count) : "memory");
  }
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(bar);
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(a), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(bar);
  asm volatile(
      "{\n.reg .pred p;\nWAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT_%=;\n}\n" ::"r"(a), "r"(parity)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(bar);
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(a) : "memory");
}

// One 4-D box of `map` at (c0 innermost, .., c3) into shared memory at
// `dst`, completing its bytes on `bar`.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, int c3, uint64_t* bar) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  const unsigned b = (unsigned)__cvta_generic_to_shared(bar);
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(d), "l"(reinterpret_cast<uint64_t>(map)),
      "r"(b), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// `bytes` (a multiple of 16, 16-byte aligned) from global memory to
// shared memory at `dst`, completing on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  const unsigned b = (unsigned)__cvta_generic_to_shared(bar);
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(d), "l"(src), "r"(bytes), "r"(b)
      : "memory");
}

// wgmma shared-memory descriptor: start `p`, 128-byte swizzle (tiles
// 1024-byte aligned), leading and stride byte offsets `lbo`, `sbo`.
__device__ __forceinline__ uint64_t wgmma_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  return (uint64_t)((a & 0x3FFFF) >> 4) | (uint64_t)((lbo >> 4) & 0x3FFF) << 16 |
         (uint64_t)((sbo >> 4) & 0x3FFF) << 32 | (uint64_t)1 << 62;
}

// One 2-D tile of `map` at (c0 innermost, c1) into shared memory at `dst`,
// completing its bytes on `bar`.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            uint64_t* bar) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  const unsigned b = (unsigned)__cvta_generic_to_shared(bar);
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(d), "l"(reinterpret_cast<uint64_t>(map)), "r"(b),
      "r"(c0), "r"(c1)
      : "memory");
}

// Host side: a tiled tensor map of `rank` dimensions (innermost first;
// `pitch` holds the byte strides of dimensions 1..rank-1), boxes `box`,
// element strides 1, out-of-bounds elements read as zeros. The encoder is
// looked up through the CUDA runtime's entry-point query, so nothing links
// libcuda.
inline int encode_tensor_map(CUtensorMap* map, CUtensorMapDataType type, int rank, const void* base,
                             const cuuint64_t* dims, const cuuint64_t* pitch, const cuuint32_t* box,
                             CUtensorMapSwizzle swizzle) {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      return (int)cudaErrorNotSupported;
    fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }
  const cuuint32_t estr[5] = {1, 1, 1, 1, 1};
  const CUresult r = fn(map, type, rank, const_cast<void*>(base), dims, pitch, box, estr,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// A 2-D u8 tensor map of rows x cols (row pitch `pitch` bytes), boxes of
// box_rows x box_cols.
inline int tensor_map_u8(CUtensorMap* map, const void* base, int rows, int cols, int pitch,
                         int box_rows, int box_cols, CUtensorMapSwizzle swizzle) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows}, strides[1] = {(cuuint64_t)pitch};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  return encode_tensor_map(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, base, dims, strides, box, swizzle);
}

// The swizzle that keeps a code tile of `bytes`-byte rows (a TMA box) free
// of bank conflicts: 16-byte chunk c of row r lands at chunk c ^ swz(r).
inline CUtensorMapSwizzle row_swizzle(int bytes) {
  return bytes >= 128 ? CU_TENSOR_MAP_SWIZZLE_128B
         : bytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
         : bytes == 32 ? CU_TENSOR_MAP_SWIZZLE_32B
                       : CU_TENSOR_MAP_SWIZZLE_NONE;
}
// Byte offset of byte b of row r in such a tile (rows of `bytes` bytes, the
// box's inner size; 1024-byte aligned base).
__device__ __forceinline__ int swz_off(int r, int b, int bytes) {
  return r * bytes + ((((b >> 4) ^ (r * bytes >> 7)) & (bytes / 16 - 1)) << 4) + (b & 15);
}

// Rounds per stage and ring depth of a GEMV launch (B1, B3's GEMV form):
// each block gets the shared memory that lets the grid run in one wave
// where the registers allow (`gemv_budget`), and in it the largest stage
// (`stage(R)` = (bytes of a ring slot, code bytes) for R rounds, while
// `fits(R)`), 3 deep where that fits, else 2, plus `extra(R)` bytes. Fewer
// stages mean fewer block barriers per byte; measured on an H100, a deeper
// ring than 2 or 3 moves nothing, and a block more on each SM does.
struct GemvStages {
  int rounds, ring;
  size_t smem;
};

// The shared memory one block may take: the SM's, shared by as many blocks
// as the grid puts on each SM in one wave, at most `regs_blocks` (what the
// registers allow), at least two where K splits.
inline size_t gemv_budget(int regs_blocks, long blocks, int ksplit) {
  static int sms = 0, per_sm = 0, per_block = 0;
  if (!sms) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaDeviceGetAttribute(&per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
    cudaDeviceGetAttribute(&per_block, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  // a K split's cluster starts only where all its blocks fit at once: leave
  // room for two blocks an SM
  const long b = std::max(ksplit > 1 ? 2L : 1L, std::min<long>(regs_blocks, (blocks + sms - 1) / sms));
  return std::min((size_t)per_sm / b - 1024, (size_t)per_block);  // 1 KB per block is the runtime's
}

// Blocks of `kernel` one SM holds by its registers.
template <typename Kernel>
int regs_blocks(Kernel kernel, int threads) {
  int n = 1;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, threads, 0);
  return std::max(n, 1);
}

template <typename Stage, typename Fits, typename Extra>
GemvStages pick_stages(Stage stage, Fits fits, Extra extra, size_t budget) {
  GemvStages best{1, 2, 2 * stage(1).first + extra(1)};
  for (int R = 1; fits(R); R *= 2)
    for (int ring = 3; ring >= 2; --ring) {
      const size_t smem = ring * stage(R).first + extra(R);
      if (smem <= budget) {
        best = {R, ring, smem};
        break;
      }
    }
  return best;
}

}  // namespace l3q
