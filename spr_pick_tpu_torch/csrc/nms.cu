// K1: exact greedy disk NMS on Hopper (sm_90a), one thread block per map.
//
// Replaces the TPU kernel `spr_pick_tpu/ops/nms_pallas.py:_nms_kernel`
// (called through `non_maximum_suppression_pallas`).  Same function: repeat
// { take the global maximum m, ties to the highest flat index (the last row
// holding m, then the last column in that row); record (m, x, y); set every
// pixel with dy^2 + dx^2 <= r^2 to -inf; refresh the cached row maxima of
// the touched rows } while k < max_peaks and m > threshold (strictly).
// Slots past the count hold score 0 and coords (0, 0).
//
// What bounds it: a serial chain of picks.  Each pick reads the row-max
// cache (H floats, shared memory), row y (W floats), writes the disk's
// (2r+1)^2 bounding box and re-reads the (2r+1) touched rows to refresh
// their maxima: about H + W + (2r+1)*W L2 reads and two block-wide
// reductions, with four block barriers.  The initial row-max pass reads the
// map once.  The minimum the function must move (the map once, the pick
// lists once) is microseconds; the chain of dependent picks, not bandwidth,
// sets the time.
//
// What the design does about it: the TPU kernel keeps the whole map in
// VMEM; a block's 227 KB of shared memory cannot hold a 1024^2 f32 map
// (4 MB), so the map stays in device memory, where it sits in the 50 MB L2
// after the first pass, and only the row-max cache (H floats: 8 KB at 2048
// rows) lives in shared memory.  Per pick only the disk's bounding box is
// written (not K1's full-width band) and only the touched rows are rescanned,
// one warp per row with coalesced loads.  A batch takes one launch with one
// block per map (grid = B), so maps run in parallel on separate SMs.  Faster
// variants (a thread-block cluster sharing one map, shared-memory tiles of
// the band) are later work.
//
// Interface: plain C, loaded with ctypes.  The caller (ops/nms_cuda.py)
// passes a contiguous (B, H, W) float32 work copy that this kernel
// overwrites, and preallocated outputs; the launch goes on the caller's
// stream and nothing is synchronised.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

struct Best {
  float v;
  int i;
};

// Larger value wins; among equal values the larger index wins.
__device__ __forceinline__ Best better(Best a, Best b) {
  return (b.v > a.v || (b.v == a.v && b.i > a.i)) ? b : a;
}

__device__ __forceinline__ Best warp_best(Best b) {
  for (int off = 16; off > 0; off >>= 1) {
    Best o;
    o.v = __shfl_xor_sync(kFull, b.v, off);
    o.i = __shfl_xor_sync(kFull, b.i, off);
    b = better(b, o);
  }
  return b;
}

// Block-wide `better` reduction; every thread gets the result.  All threads
// of the block must call it.  The two barriers also order the shared and
// global reads before it against the writes after it.
__device__ Best block_best(Best b, Best* scratch, Best* out) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  b = warp_best(b);
  if (lane == 0) scratch[warp] = b;
  __syncthreads();
  if (warp == 0) {
    Best c = lane < kWarps ? scratch[lane] : Best{-CUDART_INF_F, -1};
    c = warp_best(c);
    if (lane == 0) *out = c;
  }
  __syncthreads();
  return *out;
}

// Maximum of one row, computed by one warp; every lane gets it.
__device__ __forceinline__ float warp_row_max(const float* row, int w,
                                              int lane) {
  float m = -CUDART_INF_F;
  for (int c = lane; c < w; c += 32) m = fmaxf(m, row[c]);
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(kFull, m, off));
  return m;
}

__global__ void __launch_bounds__(kThreads)
    nms_greedy_kernel(float* __restrict__ work, int h, int w, int radius,
                      float threshold, int max_peaks,
                      float* __restrict__ scores, int* __restrict__ coords,
                      int* __restrict__ counts) {
  extern __shared__ float rowmax[];  // h floats
  __shared__ Best scratch[kWarps];
  __shared__ Best result;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  float* map = work + (size_t)blockIdx.x * h * w;
  float* sc = scores + (size_t)blockIdx.x * max_peaks;
  int* co = coords + (size_t)blockIdx.x * max_peaks * 2;

  for (int i = tid; i < max_peaks; i += kThreads) {
    sc[i] = 0.f;
    co[2 * i] = 0;
    co[2 * i + 1] = 0;
  }
  for (int r = warp; r < h; r += kWarps) {
    const float m = warp_row_max(map + (size_t)r * w, w, lane);
    if (lane == 0) rowmax[r] = m;
  }
  __syncthreads();

  const int r2 = radius * radius;
  int k = 0;
  while (k < max_peaks) {
    // Global maximum from the row cache: the last row holding it.
    Best cand{-CUDART_INF_F, -1};
    for (int r = tid; r < h; r += kThreads)
      cand = better(cand, Best{rowmax[r], r});
    const Best top = block_best(cand, scratch, &result);
    if (!(top.v > threshold)) break;  // uniform: every thread sees `top`
    const int y = top.i;

    // The last column of row y holding it.
    const float* row = map + (size_t)y * w;
    Best col{-CUDART_INF_F, -1};
    for (int c = tid; c < w; c += kThreads) col = better(col, Best{row[c], c});
    const int x = block_best(col, scratch, &result).i;

    if (tid == 0) {
      sc[k] = top.v;
      co[2 * k] = x;
      co[2 * k + 1] = y;
    }

    // Suppress the disk inside its bounding box, clipped to the map.
    const int y0 = max(0, y - radius), y1 = min(h - 1, y + radius);
    const int x0 = max(0, x - radius), x1 = min(w - 1, x + radius);
    const int bw = x1 - x0 + 1;
    const int n = (y1 - y0 + 1) * bw;
    for (int i = tid; i < n; i += kThreads) {
      const int yy = y0 + i / bw;
      const int xx = x0 + i % bw;
      const int dy = yy - y, dx = xx - x;
      if (dy * dy + dx * dx <= r2) map[(size_t)yy * w + xx] = -CUDART_INF_F;
    }
    __syncthreads();

    // Refresh the touched rows' maxima, one warp per row.
    for (int r = y0 + warp; r <= y1; r += kWarps) {
      const float m = warp_row_max(map + (size_t)r * w, w, lane);
      if (lane == 0) rowmax[r] = m;
    }
    __syncthreads();
    ++k;
  }
  if (tid == 0) counts[blockIdx.x] = k;
}

}  // namespace

extern "C" {

// Rows the shared-memory row-max cache can hold on `device`, or minus the
// cudaError_t code when a query fails.
int spr_nms_max_rows(int device) {
  int optin = 0;
  cudaError_t e = cudaDeviceGetAttribute(
      &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (e != cudaSuccess) return -(int)e;
  cudaFuncAttributes attr;
  e = cudaFuncGetAttributes(&attr, nms_greedy_kernel);
  if (e != cudaSuccess) return -(int)e;
  return (optin - (int)attr.sharedSizeBytes) / (int)sizeof(float);
}

// Greedy NMS over `batch` maps of (h, w) in `work` (overwritten).  Returns a
// cudaError_t code; 0 when the launch was accepted.
int spr_nms_greedy(float* work, int batch, int h, int w, int radius,
                   float threshold, int max_peaks, float* scores, int* coords,
                   int* counts, cudaStream_t stream) {
  const size_t smem = (size_t)h * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        nms_greedy_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  nms_greedy_kernel<<<batch, kThreads, smem, stream>>>(
      work, h, w, radius, threshold, max_peaks, scores, coords, counts);
  return (int)cudaGetLastError();
}

const char* spr_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
