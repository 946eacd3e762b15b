// Weight-stream probes: kernel B8.
//
// Replaces the DMA-only TPU kernels of the repo's weight-stream
// microbenches, each of which copies every block of an int8 array into VMEM
// and reads one row of it:
//   scripts/microbench_w4_variants.py `_dma_kernel` (packed W4 [K/2, N],
//     blocks [bk/2, bn], "w4");
//   scripts/microbench_w4_tiled.py `_dma_kernel` (tile-contiguous
//     [K/bk, N/bn, bk/2, bn], "tiled");
//   scripts/microbench_dma_depth.py `kernel` (int8 [R, W] in chunks of C
//     rows with D copies in flight, "depth").
// The function: out (f32, zeroed by the caller) gets, for every block
// (chunk), its first row added, as the signed low nibble of each byte (the
// w4 forms: row 0 of the block's int4 bitcast) or as the byte (depth).
//
// What bounds it on the H100: the bytes over HBM (3.35 TB/s). The function
// reads one row per block, but the kernel streams EVERY byte of every
// block, as the TPU kernel DMAs every block: that stream is what the probe
// measures. Each block of threads walks its rows of the array in stages of
// STAGE bytes, copied into a shared-memory ring with `cp.async.cg` (16 bytes
// per thread per copy) and kept D stages deep (`commit_group` /
// `wait_group<D-1>`); D is the "depth" form's one parameter (1, 2, 4, 8),
// the w4 forms run at depth 4. When a stage lands, the rows in it that
// start a block add their first row to `out` with float atomics: small
// integers, exact in any order.

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int STAGE = 8192;  // bytes per pipeline stage

using l3q::cp_async16;
using l3q::cp_async_commit;
using l3q::cp_async_wait;

// The array is seen as rows of `row_bytes` bytes; block x of the grid
// copies the `width` bytes at column width * x of each of its rows, block
// y the rows [y * rows_per_cta, ...). A row r with r % chunk_rows == 0
// starts a block of the TPU kernel; its byte c adds to out[idx], idx =
// width * x + c, or, for the tiled layout (nn > 0), (r / chunk_rows % nn)
// * width + c.
template <int D>
__global__ void __launch_bounds__(THREADS) stream_kernel(
    const int8_t* __restrict__ src, float* __restrict__ out, int rows_total, int row_bytes,
    int width, int chunk_rows, int rows_per_cta, int nibble, int nn) {
  extern __shared__ __align__(16) int8_t ring[];
  const int stage_rows = STAGE / width, pieces = STAGE / 16, per_row = width / 16;
  const int r_begin = blockIdx.y * rows_per_cta;
  const int r_end = min(rows_total, r_begin + rows_per_cta);
  if (r_begin >= r_end) return;
  const int nstages = (r_end - r_begin + stage_rows - 1) / stage_rows;
  const size_t col0 = (size_t)blockIdx.x * width;

  auto issue = [&](int st) {
    int8_t* dst = ring + (st % D) * STAGE;
    const int row0 = r_begin + st * stage_rows;
    for (int i = threadIdx.x; i < pieces; i += THREADS) {
      const int r = i / per_row, c = (i - r * per_row) * 16;
      if (row0 + r < r_end) cp_async16(dst + r * width + c, src + (size_t)(row0 + r) * row_bytes + col0 + c);
    }
  };

#pragma unroll
  for (int st = 0; st < D - 1; ++st) {
    if (st < nstages) issue(st);
    cp_async_commit();
  }
  for (int st = 0; st < nstages; ++st) {
    if (st + D - 1 < nstages) issue(st + D - 1);
    cp_async_commit();
    cp_async_wait<D - 1>();  // this thread's copies of stage st have landed
    __syncthreads();         // and every other thread's
    const int8_t* slot = ring + (st % D) * STAGE;
    const int row0 = r_begin + st * stage_rows;
    const int first = (row0 + chunk_rows - 1) / chunk_rows * chunk_rows;
    for (int r = first; r < min(row0 + stage_rows, r_end); r += chunk_rows) {
      const size_t base = nn > 0 ? (size_t)(r / chunk_rows % nn) * width : col0;
      for (int c = threadIdx.x; c < width; c += THREADS) {
        const int b = slot[(r - row0) * width + c];
        const int v = nibble ? ((b & 15) ^ 8) - 8 : b;
        atomicAdd(out + base + c, (float)v);
      }
    }
    __syncthreads();  // the slot is read before it is refilled
  }
}

template <int D>
int launch(const void* src, void* out, int rows_total, int row_bytes, int width, int cols,
           int chunk_rows, int rows_per_cta, int nibble, int nn, cudaStream_t st) {
  static bool attr_set = false;
  const int smem = D * STAGE;
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        stream_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  dim3 grid(cols / width, (rows_total + rows_per_cta - 1) / rows_per_cta);
  stream_kernel<D><<<grid, THREADS, smem, st>>>((const int8_t*)src, (float*)out, rows_total,
                                                row_bytes, width, chunk_rows, rows_per_cta,
                                                nibble, nn);
  return (int)cudaGetLastError();
}

}  // namespace

// src: int8 rows of `row_bytes` bytes, `rows_total` of them; `cols` bytes of
// each row are streamed (cols % width == 0, width % 16 == 0, STAGE % width
// == 0), `rows_per_cta` rows per block (a multiple of STAGE / width); out:
// f32, zeroed. depth in {1, 2, 4, 8}; nibble: 1 = the signed low nibble, 0
// = the byte; nn: blocks along N of the tiled layout, 0 for row-major.
extern "C" int l3q_w4_stream(const void* src, void* out, int rows_total, int row_bytes, int width,
                             int cols, int chunk_rows, int rows_per_cta, int nibble, int nn,
                             int depth, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (width % 16 || STAGE % width || cols % width || rows_per_cta % (STAGE / width))
    return (int)cudaErrorInvalidValue;
  switch (depth) {
    case 1: return launch<1>(src, out, rows_total, row_bytes, width, cols, chunk_rows, rows_per_cta, nibble, nn, st);
    case 2: return launch<2>(src, out, rows_total, row_bytes, width, cols, chunk_rows, rows_per_cta, nibble, nn, st);
    case 4: return launch<4>(src, out, rows_total, row_bytes, width, cols, chunk_rows, rows_per_cta, nibble, nn, st);
    case 8: return launch<8>(src, out, rows_total, row_bytes, width, cols, chunk_rows, rows_per_cta, nibble, nn, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
