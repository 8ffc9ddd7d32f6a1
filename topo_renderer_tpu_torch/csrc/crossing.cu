// First-crossing search over per-column terrain profiles (Hopper, sm_90a).
//
// Replaces the Pallas TPU kernel topo_renderer_tpu/ops/pallas_crossing.py,
// function crossing_search_pallas (kernel body _make_kernel).
//
// What it computes. For every column c of the profile e[N, W], the running
// max M_k = max(M_{k-1}, e[k, c]) with M_{-1} = -3e38 (NaN-propagating, as
// jnp.maximum is). Row r crosses at the first k with t[r] < M_k and
// t[r] >= M_{k-1}; there the outputs take kstar = k, theta = e[k, c],
// m_lo = M_{k-1} and the three payloads a0..a2 at [k, c]. Rows that never
// cross keep the sky defaults: kstar = N, everything else 0. The row
// thresholds t are constant across columns and may come in any order.
//
// What bounds it on this card: bytes. At the panorama's shapes (N = 512,
// W = 2048, H = 1024) it reads the 4 MiB profile and the payloads where rows
// crossed, and writes 6 x 8 MiB of outputs: 54.75 MB for chip_smoke.py's
// profile (its crossing_bytes), 0.0163 ms at 3.35 TB/s. The arithmetic is a
// max per (step, column) and a short search per pixel.
//
// Why a binary search gives the band walk's answer. Up to a column's first
// NaN the running max is non-decreasing, and from that NaN on it stays NaN,
// against which every compare is false. So the predicate P(k) = !(M_k <= t)
// is false up to some step and true from there on: its first true step k is
// the only candidate. There M_{k-1} <= t < M_k when M_k is a number and
// t >= M_INIT, which is the crossing; otherwise (M_k NaN, t NaN, t below
// M_INIT) the row never crosses, and the same compares as the serial scan's
// (t < M_k && t >= M_{k-1}) at k say so. Ties t == M_k do not cross. At a
// crossing M_k > M_{k-1}, so M_k = e[k, c]: theta is the running max there,
// and the chunk's profile values need not be kept beside it.
//
// Design.
//  * A block owns COLS = 32 columns (one per lane) and a band of
//    WARPS * RPT rows; warp w holds rows w, w + WARPS, ... of the band and
//    keeps their six outputs in registers. The grid runs over (column
//    tiles, row bands); the C entry picks the largest RPT (8, 4, 2) that
//    still gives two blocks per SM, else 1.
//  * The profile streams through shared memory in chunks of CHUNK steps,
//    requested with cp.async (16-byte copies where rows are 16-byte
//    aligned), so a chunk costs one memory latency, not one per step.
//  * Each chunk's running max is a scan in place in shared memory: every
//    warp scans CHUNK / WARPS steps, then takes in the maxima of the
//    segments before it and the previous chunk's carry.
//  * A (row, column) pair still open is searched in the chunk whose last
//    running max satisfies P: a binary search over the chunk's CHUNK steps
//    (steps past N are -inf, so the running max stays flat there).
//  * The next chunk is requested only when some pair of the block is still
//    open after this one, and its load overlaps this chunk's searches: the
//    block reads the profile up to its rows' last crossing, to the chunk.
//  * Payloads are gathered at the end, only where a row crossed, all loads
//    issued before the stores. Each warp then stores its rows: one
//    instruction writes 32 adjacent words of one output row.
// Any N (<= 2^24, checked by the wrapper), W and H are accepted: the TPU's
// W % 128 and H % 8 rules are tiling rules of that chip.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int COLS = 32;             // columns per block, one per lane
constexpr int WARPS = 8;             // warps per block
constexpr int THREADS = 32 * WARPS;
constexpr int CHUNK = 128;           // profile steps per streamed chunk
constexpr int SEG = CHUNK / WARPS;   // steps each warp scans
constexpr int MAX_RPT = 8;           // rows per warp, at most
constexpr float M_INIT = -3.0e38f;   // running-max start, as in the TPU kernel

__device__ __forceinline__ float nan_max(float a, float b) {
  // jnp.maximum propagates NaN; fmaxf does not.
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

// Request steps [k0, k0 + CHUNK) of columns [c0, c0 + COLS) into buf. Words
// past N or W are not loaded: the scan reads steps past N as -inf, and
// columns past W have no open pairs.
__device__ __forceinline__ void load_chunk(float (*buf)[COLS], const float* __restrict__ e,
                                           int n, int w, int k0, int c0, bool vec) {
  const int len = min(CHUNK, n - k0);
  if (vec) {  // w % 4 == 0 and e 16-byte aligned: a 4-word group is all in or all out
    for (int i = threadIdx.x; i < CHUNK * (COLS / 4); i += THREADS) {
      const int r = i / (COLS / 4), q = 4 * (i % (COLS / 4));
      if (r < len && c0 + q < w) cp_async16(&buf[r][q], e + (size_t)(k0 + r) * w + c0 + q);
    }
  } else {
    for (int i = threadIdx.x; i < CHUNK * COLS; i += THREADS) {
      const int r = i / COLS, q = i % COLS;
      if (r < len && c0 + q < w) cp_async4(&buf[r][q], e + (size_t)(k0 + r) * w + c0 + q);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int RPT>
__global__ void __launch_bounds__(THREADS)
crossing_kernel(const float* __restrict__ e, const float* __restrict__ a0,
                const float* __restrict__ a1, const float* __restrict__ a2,
                const float* __restrict__ t, int n, int w, int h, bool vec,
                float* __restrict__ out) {
  // Profile chunks, double-buffered; each becomes its running max in place.
  __shared__ __align__(16) float s_m[2][CHUNK][COLS];
  __shared__ float s_seg[WARPS][COLS];  // each warp's segment max

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c0 = blockIdx.x * COLS, col = c0 + lane;
  const int r0 = blockIdx.y * (WARPS * RPT) + warp;

  float tr[RPT], theta[RPT], mlo[RPT];
  int ks[RPT];
  unsigned open = 0;  // bit i: row r0 + WARPS * i has not been decided yet
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = r0 + WARPS * i;
    tr[i] = row < h ? t[row] : 0.0f;
    ks[i] = n;
    theta[i] = 0.0f;
    mlo[i] = 0.0f;
    if (row < h && col < w) open |= 1u << i;
  }

  float carry = M_INIT;  // running max before the current chunk
  if (n > 0) load_chunk(s_m[0], e, n, w, 0, c0, vec);
  for (int k0 = 0, buf = 0; k0 < n; k0 += CHUNK, buf ^= 1) {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();

    // Running max of the chunk: segment scans, then the segments' prefix.
    float (*m)[COLS] = s_m[buf];
    const int len = min(CHUNK, n - k0);
    float run = -INFINITY;
#pragma unroll
    for (int s = 0; s < SEG; ++s) {
      const int k = warp * SEG + s;
      run = nan_max(run, k < len ? m[k][lane] : -INFINITY);
      m[k][lane] = run;
    }
    s_seg[warp][lane] = run;
    __syncthreads();
    float pre = carry;
    for (int q = 0; q < warp; ++q) pre = nan_max(pre, s_seg[q][lane]);
#pragma unroll
    for (int s = 0; s < SEG; ++s) {
      const int k = warp * SEG + s;
      m[k][lane] = nan_max(pre, m[k][lane]);
    }
    __syncthreads();

    // Pairs whose predicate is still false at the chunk's end stay open;
    // the next chunk is requested only if the block has one.
    const float mlast = m[CHUNK - 1][lane];
    bool pending = false;
#pragma unroll
    for (int i = 0; i < RPT; ++i) pending |= ((open >> i) & 1u) && mlast <= tr[i];
    const bool more = __syncthreads_or(pending) && k0 + CHUNK < n;
    if (more) load_chunk(s_m[buf ^ 1], e, n, w, k0 + CHUNK, c0, vec);

    // The others are decided in this chunk: first step with !(M <= t).
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      if (!((open >> i) & 1u) || mlast <= tr[i]) continue;
      int idx = 0;
#pragma unroll
      for (int step = CHUNK / 2; step > 0; step >>= 1)
        if (m[idx + step - 1][lane] <= tr[i]) idx += step;
      const float mk = m[idx][lane];
      const float mp = idx > 0 ? m[idx - 1][lane] : carry;
      if (tr[i] < mk && tr[i] >= mp) {
        ks[i] = k0 + idx;
        theta[i] = mk;
        mlo[i] = mp;
      }
      open &= ~(1u << i);
    }
    carry = mlast;
    if (!more) break;
  }

  // Payloads where a row crossed, then the six outputs of each row.
  float p0[RPT], p1[RPT], p2[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const bool hit = ks[i] < n;
    const size_t src = (size_t)(hit ? ks[i] : 0) * w + col;
    p0[i] = hit ? __ldg(a0 + src) : 0.0f;
    p1[i] = hit ? __ldg(a1 + src) : 0.0f;
    p2[i] = hit ? __ldg(a2 + src) : 0.0f;
  }
  const size_t plane = (size_t)h * w;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = r0 + WARPS * i;
    if (row >= h || col >= w) continue;
    float* o = out + (size_t)row * w + col;
    o[0] = (float)ks[i];
    o[plane] = theta[i];
    o[2 * plane] = mlo[i];
    o[3 * plane] = p0[i];
    o[4 * plane] = p1[i];
    o[5 * plane] = p2[i];
  }
}

template <int RPT>
void launch(dim3 grid, cudaStream_t s, const float* e, const float* a0, const float* a1,
            const float* a2, const float* t, int n, int w, int h, bool vec, float* out) {
  crossing_kernel<RPT><<<grid, THREADS, 0, s>>>(e, a0, a1, a2, t, n, w, h, vec, out);
}

}  // namespace

extern "C" {

const char* error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// e, a0..a2: f32[n, w]; t: f32[h] row thresholds; out: f32[6, h, w], the
// planes kstar, theta, m_lo, n0, n1, n2. Returns cudaGetLastError(), or
// cudaErrorInvalidValue for shapes out of range.
int crossing_search(const float* e, const float* a0, const float* a1, const float* a2,
                    const float* t, int n, int w, int h, float* out, void* stream) {
  if (n < 0 || w < 1 || h < 1) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  // The most rows per warp that still gives two blocks per SM.
  const long tiles = (w + COLS - 1) / COLS;
  int rpt = MAX_RPT;
  while (rpt > 1 && tiles * ((h + WARPS * rpt - 1) / (WARPS * rpt)) < 2L * sms) rpt /= 2;
  const int bands = (h + WARPS * rpt - 1) / (WARPS * rpt);
  if (bands > 65535 || tiles > 0x7fffffffL) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)tiles, (unsigned)bands);
  const bool vec = w % 4 == 0 && (reinterpret_cast<uintptr_t>(e) & 15) == 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (rpt) {
    case 8: launch<8>(grid, s, e, a0, a1, a2, t, n, w, h, vec, out); break;
    case 4: launch<4>(grid, s, e, a0, a1, a2, t, n, w, h, vec, out); break;
    case 2: launch<2>(grid, s, e, a0, a1, a2, t, n, w, h, vec, out); break;
    default: launch<1>(grid, s, e, a0, a1, a2, t, n, w, h, vec, out); break;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
