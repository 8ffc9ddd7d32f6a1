// Bounded window copies out of large tables (Hopper, sm_90a).
//
// Replaces two Pallas TPU kernels of topo_renderer_tpu/ops/pallas_dma.py:
// window_slice_multi (one launch, L levels) and window_slice (one table; the
// TPU build's probe), which is the L = 1 launch of the same kernel here.
//
// What it computes: for each level l, dst_l = src_l[:, sy:sy+wsy, sx:sx+wsx]
// with the origin (sy, sx) read from an int32 device array (no host sync)
// and clamped into the table as XLA's DynamicSlice clamps it. The copy
// moves 32-bit words: plane 1 of the panorama's tables holds packed normals
// bitcast to float32, some of them denormal, so nothing here is float
// arithmetic and the result is bit-exact.
//
// What bounds it on this card: bytes. The panorama copies four 2 x 272 x 512
// windows (12001^2, 6000^2, 3000^2, 1500^2 tables): 4.46 MB read and
// 4.46 MB written, ~2.7 us at 3.35 TB/s; launch latency dominates.
//
// Design: one launch covers every level; the grid runs over (output rows,
// level), one block per output row. Per-level source pointers and table
// sizes travel by value in a fixed-size parameter struct. The level-0 table
// is 12001 words wide, so its row starts are not 16-byte aligned: each row
// takes the 16-byte vector path only when both its source and destination
// are aligned, and otherwise copies word by word, coalesced across the warp.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_LEVELS = 16;
constexpr int THREADS = 128;

struct SliceParams {
  const uint32_t* src[MAX_LEVELS];
  uint32_t* dst[MAX_LEVELS];
  int planes[MAX_LEVELS];
  int h[MAX_LEVELS];
  int w[MAX_LEVELS];
};

__global__ void __launch_bounds__(THREADS)
window_slice_kernel(const SliceParams p, const int* __restrict__ origins,
                    int wsy, int wsx) {
  const int level = blockIdx.y;
  const int row = blockIdx.x;  // plane * wsy + y
  if (row >= p.planes[level] * wsy) return;
  const int h = p.h[level], w = p.w[level];
  const int sy = min(max(origins[2 * level], 0), h - wsy);
  const int sx = min(max(origins[2 * level + 1], 0), w - wsx);
  const int plane = row / wsy, y = row - plane * wsy;
  const uint32_t* s = p.src[level] + ((size_t)plane * h + sy + y) * (size_t)w + sx;
  uint32_t* d = p.dst[level] + (size_t)row * wsx;
  if (((reinterpret_cast<uintptr_t>(s) | reinterpret_cast<uintptr_t>(d)) & 15) == 0 &&
      (wsx & 3) == 0) {
    const uint4* s4 = reinterpret_cast<const uint4*>(s);
    uint4* d4 = reinterpret_cast<uint4*>(d);
    for (int i = threadIdx.x; i < (wsx >> 2); i += THREADS) d4[i] = s4[i];
  } else {
    for (int i = threadIdx.x; i < wsx; i += THREADS) d[i] = s[i];
  }
}

}  // namespace

extern "C" {

const char* error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// n levels; srcs/dsts: host arrays of device pointers; planes/hs/ws: host
// arrays of each table's leading size and (h, w); origins: device int32
// [n, 2] (sy, sx). Returns cudaGetLastError(), or cudaErrorInvalidValue
// when n is out of range.
int window_slice_multi(int n, const void* const* srcs, void* const* dsts,
                       const int* planes, const int* hs, const int* ws,
                       const int* origins, int wsy, int wsx, void* stream) {
  if (n < 1 || n > MAX_LEVELS) return (int)cudaErrorInvalidValue;
  SliceParams p = {};
  int max_rows = 0;
  for (int l = 0; l < n; ++l) {
    p.src[l] = static_cast<const uint32_t*>(srcs[l]);
    p.dst[l] = static_cast<uint32_t*>(dsts[l]);
    p.planes[l] = planes[l];
    p.h[l] = hs[l];
    p.w[l] = ws[l];
    if (planes[l] * wsy > max_rows) max_rows = planes[l] * wsy;
  }
  dim3 grid(max_rows, n);
  window_slice_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(p, origins, wsy, wsx);
  return (int)cudaGetLastError();
}

}  // extern "C"
