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
// each way, ~2.7 us at 3.35 TB/s, near the card's launch floor. The batch
// of 256 viewpoints writes 1.14 GB of windows. Its viewpoints lie close
// together, so their windows overlap: the source bytes it must read, each
// covered texel once, are a small part of what reading every window costs.
//
// Design:
// - Work order. The grid is (eye, group of 8 output rows, level), the eye
//   fastest: the blocks resident at one time copy the same few rows of
//   every eye's window of one level, so the source rows that neighbouring
//   eyes' windows share are read again while they are still in the L2. The
//   eyes are taken in their own order: at 256 eyes (the batch path's chunk)
//   every eye's blocks of a row group are resident together, and sorting
//   the eyes by origin cost more device time than it saved.
// - Streaming stores. The windows are stored with an evict-first hint
//   (st.global.cs), so the output does not push the shared source lines out
//   of the L2.
// - 16-byte vectors on unaligned rows. Level 0's table is 12001 words wide,
//   so most of its rows start off a 16-byte boundary. A warp copies one row:
//   it loads the aligned 16-byte vectors that hold the row and realigns them
//   in registers, each lane taking the words it lacks from the next lane's
//   vector (one warp shuffle per word). Destination rows are aligned when
//   wsx % 4 == 0 (the path's 512); other widths copy word by word.
// gridDim.y caps a window at 65535 x 8 output rows (planes x wsy).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_LEVELS = 16;
constexpr int MAX_BATCH = 65535;  // the wrappers' limit on viewpoints
constexpr int MAX_GROUPS = 65535;  // gridDim.y limit
constexpr int WARPS = 8;           // output rows per block
constexpr int THREADS = 32 * WARPS;
constexpr int UNROLL = 4;          // 16-byte vectors in flight per lane
constexpr unsigned FULL = 0xffffffffu;

struct SliceParams {
  const uint32_t* src[MAX_LEVELS];
  uint32_t* dst[MAX_LEVELS];
  int planes[MAX_LEVELS];
  int h[MAX_LEVELS];
  int w[MAX_LEVELS];
};

// Words M..M+3 of the eight words (lo, hi).
template <int M>
__device__ __forceinline__ uint4 realign(uint4 lo, uint4 hi) {
  if (M == 1) return make_uint4(lo.y, lo.z, lo.w, hi.x);
  if (M == 2) return make_uint4(lo.z, lo.w, hi.x, hi.y);
  return make_uint4(lo.w, hi.x, hi.y, hi.z);
}

// Copies n 16-byte vectors of one row whose first word lies M words past
// the aligned vector a[0]; the row spans a[0..n] when M > 0. Lane i of a
// chunk holds vector i and takes words 0..M-1 of vector i + 1 from lane
// i + 1; lane 31 takes them from lane 0, which offers the next chunk's
// first vector instead of its own.
template <int M>
__device__ __forceinline__ void copy_row_vec(const uint4* __restrict__ a, uint4* __restrict__ d, int n,
                                             int lane) {
  const int src_lane = (lane + 1) & 31;
  for (int i0 = 0; i0 < n; i0 += 32 * UNROLL) {
    uint4 v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int j = i0 + 32 * u + lane;
      v[u] = (j < n || (M > 0 && j == n)) ? __ldg(a + j) : make_uint4(0, 0, 0, 0);
    }
    uint4 tail = make_uint4(0, 0, 0, 0);
    if (M > 0 && lane == 0 && i0 + 32 * UNROLL <= n) tail = __ldg(a + i0 + 32 * UNROLL);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      uint4 out = v[u];
      if constexpr (M > 0) {
        const uint4 give = lane == 0 ? (u + 1 < UNROLL ? v[u + 1] : tail) : v[u];
        uint4 hi;
        hi.x = __shfl_sync(FULL, give.x, src_lane);
        hi.y = M > 1 ? __shfl_sync(FULL, give.y, src_lane) : 0u;
        hi.z = M > 2 ? __shfl_sync(FULL, give.z, src_lane) : 0u;
        hi.w = 0u;
        out = realign<M>(v[u], hi);
      }
      const int j = i0 + 32 * u + lane;
      if (j < n) __stcs(d + j, out);
    }
  }
}

__device__ __forceinline__ void copy_row_words(const uint32_t* __restrict__ s, uint32_t* __restrict__ d,
                                               int n, int lane) {
  int i = lane;
  for (; i + 32 * (UNROLL - 1) < n; i += 32 * UNROLL) {
    uint32_t v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) v[u] = __ldg(s + i + 32 * u);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) __stcs(d + i + 32 * u, v[u]);
  }
  for (; i < n; i += 32) __stcs(d + i, __ldg(s + i));
}

__global__ void __launch_bounds__(THREADS)
window_slice_kernel(const SliceParams p, const int* __restrict__ origins, int n_levels, int wsy, int wsx) {
  const int b = blockIdx.x;
  const int level = blockIdx.z;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.y * WARPS + (threadIdx.x >> 5);  // plane * wsy + y
  const int planes = p.planes[level];
  if (row >= planes * wsy) return;
  const int h = p.h[level], w = p.w[level];
  const int* org = origins + 2 * ((size_t)b * n_levels + level);
  const int sy = min(max(org[0], 0), h - wsy);
  const int sx = min(max(org[1], 0), w - wsx);
  const int plane = row / wsy, y = row - plane * wsy;
  const uint32_t* s = p.src[level] + ((size_t)plane * h + sy + y) * (size_t)w + sx;
  uint32_t* d = p.dst[level] + ((size_t)b * planes * wsy + row) * (size_t)wsx;
  if ((wsx & 3) == 0 && (reinterpret_cast<uintptr_t>(d) & 15) == 0) {
    const int m = (int)(reinterpret_cast<uintptr_t>(s) >> 2) & 3;  // the same for the whole warp
    const uint4* a = reinterpret_cast<const uint4*>(s - m);
    uint4* d4 = reinterpret_cast<uint4*>(d);
    const int n = wsx >> 2;
    switch (m) {
      case 0: copy_row_vec<0>(a, d4, n, lane); break;
      case 1: copy_row_vec<1>(a, d4, n, lane); break;
      case 2: copy_row_vec<2>(a, d4, n, lane); break;
      default: copy_row_vec<3>(a, d4, n, lane); break;
    }
  } else {
    copy_row_words(s, d, wsx, lane);
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
// cudaGetLastError(), or cudaErrorInvalidValue when n, batch or the window
// is out of range.
int window_slice_multi_batched(int n, int batch, const void* const* srcs, void* dst,
                               const int* planes, const int* hs, const int* ws,
                               const int* origins, int wsy, int wsx, void* stream) {
  if (n < 1 || n > MAX_LEVELS || batch < 1 || batch > MAX_BATCH || wsy < 1 || wsx < 1)
    return (int)cudaErrorInvalidValue;
  SliceParams p = {};
  long long max_rows = 0;
  uint32_t* d = static_cast<uint32_t*>(dst);
  for (int l = 0; l < n; ++l) {
    p.src[l] = static_cast<const uint32_t*>(srcs[l]);
    p.dst[l] = d;
    d += (size_t)batch * planes[l] * wsy * wsx;
    p.planes[l] = planes[l];
    p.h[l] = hs[l];
    p.w[l] = ws[l];
    if ((long long)planes[l] * wsy > max_rows) max_rows = (long long)planes[l] * wsy;
  }
  const long long groups = (max_rows + WARPS - 1) / WARPS;
  if (groups > MAX_GROUPS) return (int)cudaErrorInvalidValue;
  dim3 grid(batch, (unsigned)groups, n);
  window_slice_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(p, origins, n, wsy, wsx);
  return (int)cudaGetLastError();
}

}  // extern "C"
