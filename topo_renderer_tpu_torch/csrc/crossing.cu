// First-crossing search over per-column terrain profiles (Hopper, sm_90a).
//
// Replaces the Pallas TPU kernel topo_renderer_tpu/ops/pallas_crossing.py,
// function crossing_search_pallas (kernel body _make_kernel).
//
// What it computes. For every column c of the profile e[N, W], the running
// max m_k = max(m_{k-1}, e[k, c]) with m_{-1} = -3e38 (NaN-propagating, as
// jnp.maximum is). Row r crosses at the first k with t[r] < m_k and
// t[r] >= m_{k-1}; there the outputs take kstar = k, theta = e[k, c],
// m_lo = m_{k-1} and the three payloads a0..a2 at [k, c]. Rows that never
// cross keep the sky defaults: kstar = N, everything else 0. The row
// thresholds t are constant across columns.
//
// What bounds it on this card: bytes. At the panorama's shapes (N = 512,
// W = 2048, H = 1024) it reads 4 x 4 MiB of profile and payload planes and
// writes 6 x 8 MiB of outputs, ~67 MB, about 20 us at 3.35 TB/s. The
// arithmetic is a compare per (step, column) and per crossed pixel.
//
// Design. The TPU kernel walks band cursors over 128-lane blocks and masks
// RC-row chunks, because a TPU core runs one lane block at a time. On SIMT
// each thread keeps its own cursor instead:
//  * a first small kernel ranks the H thresholds (stable, descending, NaN
//    first), so the rows whose threshold lies below the running max always
//    form a suffix of the ranked order, whatever order the rows came in;
//  * each thread owns one (column, band of BAND ranked rows). Per step it
//    updates the running max and walks its cursor up while the next ranked
//    threshold lies below it, writing the six outputs of every row it
//    passes; it stops early once its band has crossed. Work per thread is
//    O(N + BAND), every output pixel is written exactly once;
//  * W = 2048 columns alone are 64 warps for 132 SMs; the H rows split into
//    H / BAND bands so that enough threads are in flight;
//  * adjacent threads own adjacent columns, so profile reads are coalesced.
// Any W and H are accepted: the TPU's W % 128 and H % 8 rules are tiling
// rules of that chip.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BAND = 32;          // ranked rows per thread
constexpr int COLS_PER_BLOCK = 128;
constexpr float M_INIT = -3.0e38f;  // running-max start, as in the TPU kernel

__device__ __forceinline__ bool rank_before(float a, int ia, float b, int ib) {
  // Descending order with NaN first; ties keep row order (stable).
  const bool na = a != a, nb = b != b;
  if (na || nb) return na && (!nb || ia < ib);
  return a > b || (a == b && ia < ib);
}

__global__ void rank_rows_kernel(const float* __restrict__ t, int h,
                                 float* __restrict__ t_ranked,
                                 int* __restrict__ row_of_rank) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= h) return;
  const float tr = t[r];
  int rank = 0;
  for (int j = 0; j < h; ++j) rank += rank_before(t[j], j, tr, r) ? 1 : 0;
  t_ranked[rank] = tr;
  row_of_rank[rank] = r;
}

__device__ __forceinline__ float nan_max(float a, float b) {
  // jnp.maximum propagates NaN; fmaxf does not.
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}

__global__ void __launch_bounds__(COLS_PER_BLOCK)
crossing_kernel(const float* __restrict__ e, const float* __restrict__ a0,
                const float* __restrict__ a1, const float* __restrict__ a2,
                const float* __restrict__ t_ranked,
                const int* __restrict__ row_of_rank, int n, int w, int h,
                float* __restrict__ kstar, float* __restrict__ theta,
                float* __restrict__ mlo, float* __restrict__ n0,
                float* __restrict__ n1, float* __restrict__ n2) {
  __shared__ float s_t[BAND];
  __shared__ int s_row[BAND];
  const int b0 = blockIdx.y * BAND;
  const int nb = min(BAND, h - b0);
  for (int i = threadIdx.x; i < nb; i += blockDim.x) {
    s_t[i] = t_ranked[b0 + i];
    s_row[i] = row_of_rank[b0 + i];
  }
  __syncthreads();
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= w) return;

  // Ranked rows [r, nb) lie below the running max. Rows already below its
  // starting value never cross: they keep the sky defaults.
  float m_prev = M_INIT;
  int r = nb;
  while (r > 0 && s_t[r - 1] < m_prev) --r;
  const int r_never = r;

  for (int k = 0; k < n && r > 0; ++k) {
    const size_t src = (size_t)k * w + col;
    const float ek = e[src];
    const float m_new = nan_max(m_prev, ek);
    if (s_t[r - 1] < m_new) {
      const float kf = (float)k, p0 = a0[src], p1 = a1[src], p2 = a2[src];
      do {
        --r;
        const size_t o = (size_t)s_row[r] * w + col;
        kstar[o] = kf;
        theta[o] = ek;
        mlo[o] = m_prev;
        n0[o] = p0;
        n1[o] = p1;
        n2[o] = p2;
      } while (r > 0 && s_t[r - 1] < m_new);
    }
    m_prev = m_new;
  }

  const float sky = (float)n;
  for (int i = 0; i < nb; ++i) {
    if (i >= r && i < r_never) continue;  // crossed
    const size_t o = (size_t)s_row[i] * w + col;
    kstar[o] = sky;
    theta[o] = 0.0f;
    mlo[o] = 0.0f;
    n0[o] = 0.0f;
    n1[o] = 0.0f;
    n2[o] = 0.0f;
  }
}

}  // namespace

extern "C" {

const char* error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// e, a0..a2: f32[n, w]; t: f32[h] row thresholds; scratch: t_ranked f32[h],
// row_of_rank i32[h]; outputs f32[h, w] each. Returns cudaGetLastError().
int crossing_search(const float* e, const float* a0, const float* a1,
                    const float* a2, const float* t, float* t_ranked,
                    int* row_of_rank, int n, int w, int h, float* kstar,
                    float* theta, float* mlo, float* n0, float* n1, float* n2,
                    void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  rank_rows_kernel<<<(h + 255) / 256, 256, 0, s>>>(t, h, t_ranked, row_of_rank);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dim3 grid((w + COLS_PER_BLOCK - 1) / COLS_PER_BLOCK, (h + BAND - 1) / BAND);
  crossing_kernel<<<grid, COLS_PER_BLOCK, 0, s>>>(e, a0, a1, a2, t_ranked,
                                                  row_of_rank, n, w, h, kstar,
                                                  theta, mlo, n0, n1, n2);
  return (int)cudaGetLastError();
}

}  // extern "C"
