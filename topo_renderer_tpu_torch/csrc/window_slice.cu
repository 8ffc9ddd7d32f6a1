// Bounded window copies out of large tables (Hopper, sm_90a).
//
// Replaces three Pallas TPU kernels of topo_renderer_tpu/ops/pallas_dma.py:
// window_slice_multi (one launch, L levels), window_slice_multi_batched (the
// same copies for B viewpoints in one launch) and window_slice (one table;
// the TPU build's probe). All three are launches of one kernel here: the
// single-eye forms are the B = 1 launch, window_slice the L = 1 launch.
//
// What it computes: for each viewpoint b and level l,
// dst_l[b] = src_l[:, sy:sy+wsy, sx:sx+wsx] with the origin (sy, sx) read
// from an int32 device array (no host sync) and clamped into the table as
// XLA's DynamicSlice clamps it. The copy moves 32-bit words: plane 1 of the
// panorama's tables holds packed normals bitcast to float32, some of them
// denormal, so nothing here is float arithmetic and the result is bit-exact.
//
// What bounds it on this card: bytes. A single panorama copies four
// 2 x 272 x 512 windows (12001^2, 6000^2, 3000^2, 1500^2 tables): 4.46 MB
// each way, ~2.7 us at 3.35 TB/s. On an H100 the kernel takes ~3 us
// (chip_smoke.py's device_ms), so a call costs what the host spends on it,
// and the wrapper caches what it can. The batch of 256 viewpoints copies
// 1.14 GB each way, 0.68 ms at 3.35 TB/s: there the copy itself is the cost.
//
// Design: the grid runs over (groups of output rows, level, viewpoint); each
// warp copies one output row, so a block of 8 warps covers 8 rows. Per-level
// source and destination pointers and table sizes travel by value in a
// fixed-size parameter struct. The level-0 table is 12001 words wide, so its
// row starts are not 16-byte aligned: a row takes the 16-byte vector path
// only when both its source and destination are aligned, and otherwise
// copies word by word, coalesced across the warp. Each lane issues its loads
// for a chunk of the row before its stores, so several loads are in flight.
// gridDim.z caps the batch at 65535 viewpoints.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_LEVELS = 16;
constexpr int MAX_BATCH = 65535;  // gridDim.z limit
constexpr int WARPS = 8;          // output rows per block
constexpr int THREADS = 32 * WARPS;
constexpr int UNROLL = 4;

struct SliceParams {
  const uint32_t* src[MAX_LEVELS];
  uint32_t* dst[MAX_LEVELS];
  int planes[MAX_LEVELS];
  int h[MAX_LEVELS];
  int w[MAX_LEVELS];
};

template <typename T>
__device__ __forceinline__ void copy_row(const T* __restrict__ s, T* __restrict__ d, int n,
                                         int lane) {
  int i = lane;
  for (; i + 32 * (UNROLL - 1) < n; i += 32 * UNROLL) {
    T v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) v[u] = __ldg(s + i + 32 * u);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) d[i + 32 * u] = v[u];
  }
  for (; i < n; i += 32) d[i] = __ldg(s + i);
}

__global__ void __launch_bounds__(THREADS)
window_slice_kernel(const SliceParams p, const int* __restrict__ origins, int n_levels,
                    int wsy, int wsx) {
  const int level = blockIdx.y;
  const int b = blockIdx.z;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * WARPS + (threadIdx.x >> 5);  // plane * wsy + y
  const int planes = p.planes[level];
  if (row >= planes * wsy) return;
  const int h = p.h[level], w = p.w[level];
  const int* org = origins + 2 * ((size_t)b * n_levels + level);
  const int sy = min(max(org[0], 0), h - wsy);
  const int sx = min(max(org[1], 0), w - wsx);
  const int plane = row / wsy, y = row - plane * wsy;
  const uint32_t* s = p.src[level] + ((size_t)plane * h + sy + y) * (size_t)w + sx;
  uint32_t* d = p.dst[level] + ((size_t)b * planes * wsy + row) * (size_t)wsx;
  if (((reinterpret_cast<uintptr_t>(s) | reinterpret_cast<uintptr_t>(d)) & 15) == 0 &&
      (wsx & 3) == 0) {
    copy_row(reinterpret_cast<const uint4*>(s), reinterpret_cast<uint4*>(d), wsx >> 2, lane);
  } else {
    copy_row(s, d, wsx, lane);
  }
}

}  // namespace

extern "C" {

const char* error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// n levels, batch viewpoints; srcs: host array of the tables' device
// pointers; dst: one device buffer holding the levels one after another,
// level l as [batch, planes_l, wsy, wsx]; planes/hs/ws: host arrays of each
// table's leading size and (h, w); origins: device int32 [batch, n, 2]
// (sy, sx); the single-viewpoint copies are batch = 1. Returns
// cudaGetLastError(), or cudaErrorInvalidValue when n or batch is out of
// range.
int window_slice_multi_batched(int n, int batch, const void* const* srcs, void* dst,
                               const int* planes, const int* hs, const int* ws,
                               const int* origins, int wsy, int wsx, void* stream) {
  if (n < 1 || n > MAX_LEVELS || batch < 1 || batch > MAX_BATCH || wsy < 1 || wsx < 1)
    return (int)cudaErrorInvalidValue;
  SliceParams p = {};
  int max_rows = 0;
  uint32_t* d = static_cast<uint32_t*>(dst);
  for (int l = 0; l < n; ++l) {
    p.src[l] = static_cast<const uint32_t*>(srcs[l]);
    p.dst[l] = d;
    d += (size_t)batch * planes[l] * wsy * wsx;
    p.planes[l] = planes[l];
    p.h[l] = hs[l];
    p.w[l] = ws[l];
    if (planes[l] * wsy > max_rows) max_rows = planes[l] * wsy;
  }
  dim3 grid((max_rows + WARPS - 1) / WARPS, n, batch);
  window_slice_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(p, origins, n, wsy, wsx);
  return (int)cudaGetLastError();
}

}  // extern "C"
