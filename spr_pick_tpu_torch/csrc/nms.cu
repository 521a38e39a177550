// K1: exact greedy disk NMS on Hopper (sm_90a): a tile-key table in shared
// memory, one L2 round trip per pick, and a pre-pass over the whole card.
//
// Replaces the TPU kernel `spr_pick_tpu/ops/nms_pallas.py:_nms_kernel`
// (called through `non_maximum_suppression_pallas`).  Same function: repeat
// { take the global maximum m, ties to the highest flat index; record
// (m, x, y); set every pixel with dy^2 + dx^2 <= r^2 to -inf } while
// k < max_peaks and m > threshold (strictly).  Slots past the count hold
// score 0 and coords (0, 0).  Pixels in `suppressed` are -inf from the start.
//
// What bounds it: a serial chain of picks.  Each pick depends on the one
// before, so one map runs on one SM, and its time is picks x (the latency
// of finding the next maximum + the latency of suppressing the disk).  The
// bytes the function must move (the map once, the pick lists once) take
// about a microsecond at 3.35 TB/s; the chain, not bandwidth, sets the time.
//
// What the design does about it.  The TPU kernel keeps the whole map in
// VMEM; a 1024^2 f32 map (4 MB) exceeds a block's 227 KB of shared memory
// and a 16-block cluster's 3.6 MB, so the map stays in device memory, where
// it sits in the 50 MB L2, and shared memory holds what the chain needs:
//
//   * Keys.  A pixel's key is a 64-bit word: the order-preserving bits of
//     its value in the high word, its row and column (16 bits each, the
//     same order as the flat index) in the low word.  Unsigned key order is
//     (value, index) order, so a plain max gives the greedy pick with its
//     tie rule, and the winning key carries the score and the coordinates:
//     no second argmax.  -0.0 becomes +0.0 first, since the greedy order
//     treats them as equal.
//   * Launch 1, the pre-pass: one block per (map, T x T tile), over the whole
//     card.  It reads the caller's strided view, writes a contiguous work
//     map padded to whole tiles with -inf at suppressed pixels, at pixels
//     not above the threshold (never picked, never suppress anything) and
//     in the padding, and writes each tile's best key.
//   * Launch 2, the greedy chain: one block per map.  It loads the tile-key
//     table into shared memory with a second level, one key per group of 32
//     consecutive tiles; every warp holds the winning key.  Per pick, the
//     disk's box is a fixed bx x by tiles (2 x 2 at T = 32 and r = 15,
//     4096 pixels), and each thread loads its 32 bytes of it at once: one
//     L2 round trip.  A box tile whose best pixel lies in the disk is
//     "redone": its threads write -inf inside the disk and reduce what
//     survives into chunk keys (`redux.sync`, no atomics); the other box
//     tiles only take the -inf writes, since their best key stands.  After
//     a barrier, one warp for each redone tile writes the new tile keys and
//     recomputes that tile's group key; after a second barrier every warp
//     takes the maximum of the group keys, the next winner.  Two barriers
//     per pick.
//   * T is the smallest of 32, 64, 128 and 256 whose table fits in shared
//     memory and whose box has at most 32 tiles (chosen by the wrapper,
//     `ops/nms_cuda.py:tile_edge`).  Maps are at most 65536 pixels a side,
//     so a key's row and column fit 16 bits each.
//
// Interface: plain C, loaded with ctypes.  The caller passes the heatmaps
// as a strided view (unit column stride), an optional contiguous bool mask,
// and preallocated work map, tile keys and outputs; both launches go on the
// caller's stream and nothing is synchronised.  The caller's maps are only
// read.  NaN pixels count as not above the threshold.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

typedef unsigned long long Key;

constexpr int kPrepassThreads = 256;
constexpr int kThreads = 512;  // the greedy chain's block, one per map
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

// Quads (4 pixels, one 16-byte load) a thread takes in a round of the
// greedy chain, consecutive in one tile row.
__host__ __device__ constexpr int quads_per_thread(int t) {
  return t * t / kThreads < 8 ? t * t / kThreads : 8;
}

// Keys per tile of a pick's chunk slots: one per warp-round of quads.
__host__ __device__ constexpr int chunks_per_tile(int t) {
  return t * t / 4 / (32 * quads_per_thread(t));
}

// Tiles of edge t that a disk of radius r can touch along an axis of n tiles.
__host__ __device__ inline int box_tiles(int r, int t, int n) {
  const int k = cdiv(2 * r, t) + 1;
  return k < n ? k : n;
}

struct Layout {
  int ntx, nty, pitch, tiles, groups, bx, by, chunks;

  __host__ __device__ Layout(int h, int w, int radius, int t)
      : ntx(cdiv(w, t)),
        nty(cdiv(h, t)),
        pitch(ntx * t),
        tiles(ntx * nty),
        groups(cdiv(ntx * nty, 32)),
        bx(box_tiles(radius, t, ntx)),
        by(box_tiles(radius, t, nty)),
        chunks(bx * by * chunks_per_tile(t)) {}

  // Shared memory of the greedy chain: tile keys, group keys and the pick's
  // chunk keys.
  __host__ __device__ size_t smem_bytes() const {
    return sizeof(Key) * ((size_t)tiles + groups + chunks);
  }
};

__device__ __forceinline__ Key make_key(float v, unsigned idx) {
  const unsigned b = __float_as_uint(v);
  const unsigned o = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  return ((Key)o << 32) | idx;
}

__device__ __forceinline__ float key_value(Key k) {
  const unsigned o = (unsigned)(k >> 32);
  return __uint_as_float((o & 0x80000000u) ? (o & 0x7fffffffu) : ~o);
}

__device__ __forceinline__ Key key_max(Key a, Key b) { return a > b ? a : b; }

// Warp-wide key maximum; every lane gets it.  All 32 lanes must call it.
__device__ __forceinline__ Key warp_max(Key k) {
  const unsigned hi = (unsigned)(k >> 32);
  const unsigned top = __reduce_max_sync(kFull, hi);
  const unsigned lo = __reduce_max_sync(kFull, hi == top ? (unsigned)k : 0u);
  return ((Key)top << 32) | lo;
}

// Maximum of `n` keys in shared memory, by one warp; every lane gets it.
__device__ __forceinline__ Key warp_max_of(const Key* keys, int n, int lane) {
  Key m0 = 0, m1 = 0;
  int i = lane;
  for (; i + 32 < n; i += 64) {
    m0 = key_max(m0, keys[i]);
    m1 = key_max(m1, keys[i + 32]);
  }
  if (i < n) m0 = key_max(m0, keys[i]);
  return warp_max(key_max(m0, m1));
}

// A pixel's place in a key's low word: row and column, 16 bits each, in the
// same order as the flat index.
__device__ __forceinline__ unsigned pack(int y, int x) {
  return ((unsigned)y << 16) | (unsigned)x;
}

template <int T>
__global__ void __launch_bounds__(kPrepassThreads)
    nms_prepass_kernel(const float* __restrict__ src, long long batch_stride,
                       long long row_stride,
                       const unsigned char* __restrict__ suppressed, int h,
                       int w, float threshold, float* __restrict__ work,
                       Key* __restrict__ tile_keys) {
  __shared__ Key scratch[kPrepassThreads / 32];
  const Layout L(h, w, 0, T);
  const int tile = blockIdx.x, map = blockIdx.y;
  const int ty = tile / L.ntx, tx = tile - ty * L.ntx;
  const float* in = src + map * batch_stride;
  const unsigned char* sup =
      suppressed ? suppressed + (size_t)map * h * w : nullptr;
  float* out = work + (size_t)map * L.nty * T * L.pitch;

  Key best = 0;
  for (int e = threadIdx.x; e < T * T; e += kPrepassThreads) {
    const int y = ty * T + e / T, x = tx * T + e % T;
    float v = -CUDART_INF_F;
    if (y < h && x < w) {
      const float s = in[y * row_stride + x];
      if (s > threshold && !(sup && sup[(size_t)y * w + x]))
        v = s == 0.f ? 0.f : s;  // -0.0 -> +0.0
    }
    out[(size_t)y * L.pitch + x] = v;
    best = key_max(best, make_key(v, pack(y, x)));
  }
  best = warp_max(best);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) scratch[warp] = best;
  __syncthreads();
  if (warp == 0) {
    best = warp_max(lane < kPrepassThreads / 32 ? scratch[lane] : 0);
    if (lane == 0) tile_keys[(size_t)map * L.tiles + tile] = best;
  }
}

// Where quad q (4 pixels) of the pick's box lies, relative to the box's
// first pixel: quads run tile by tile (bx tiles a box row), row-major inside.
template <int T>
__device__ __forceinline__ void quad_origin(int q, int bx, int& oy, int& ox) {
  constexpr int kQuadsPerRow = T / 4, kQuadsPerTile = T * T / 4;
  const int t = q / kQuadsPerTile, e = q % kQuadsPerTile;
  oy = (t / bx) * T + e / kQuadsPerRow;
  ox = (t % bx) * T + (e % kQuadsPerRow) * 4;
}

template <int T>
__global__ void __launch_bounds__(kThreads)
    nms_greedy_kernel(float* __restrict__ work,
                      const Key* __restrict__ tile_keys, int h, int w,
                      int radius, float threshold, int max_peaks,
                      float* __restrict__ scores, int* __restrict__ coords,
                      int* __restrict__ counts) {
  constexpr int kQuadsPerTile = T * T / 4;
  constexpr int kLoads = quads_per_thread(T);
  constexpr int kRound = kThreads * kLoads;  // quads a round covers
  constexpr int kChunks = chunks_per_tile(T);
  constexpr unsigned kDead = 0x007fffffu;    // high word of a -inf key
  extern __shared__ Key smem[];
  const Layout L(h, w, radius, T);
  Key* tkey = smem;              // L.tiles
  Key* gkey = tkey + L.tiles;    // L.groups: max of tiles [32g, 32g + 32)
  Key* chunk = gkey + L.groups;  // L.chunks: per warp-round of the box

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float* map = work + (size_t)blockIdx.x * L.nty * T * L.pitch;
  const Key* keys = tile_keys + (size_t)blockIdx.x * L.tiles;
  float* sc = scores + (size_t)blockIdx.x * max_peaks;
  int* co = coords + (size_t)blockIdx.x * max_peaks * 2;

  for (int i = tid; i < L.tiles; i += kThreads) tkey[i] = keys[i];
  __syncthreads();
  for (int g = warp; g < L.groups; g += kWarps) {
    const int i = g * 32 + lane;
    const Key k = warp_max(i < L.tiles ? tkey[i] : 0);
    if (lane == 0) gkey[g] = k;
  }
  __syncthreads();

  // The box is a fixed bx x by tiles (at most 32), shifted inside the map
  // at its edges, so each thread's quads keep their place in it from pick
  // to pick: lane t < nt stands for box tile t, at `rel` from the first.
  const int bx = L.bx, nt = L.bx * L.by, nq = nt * kQuadsPerTile;
  const int rel = lane < nt ? (lane / bx) * L.ntx + lane % bx : 0;
  int oy0, ox0;
  quad_origin<T>(tid * kLoads, bx, oy0, ox0);

  const int r2 = radius * radius;
  Key top = warp_max_of(gkey, L.groups, lane);  // every warp holds the winner
  int k = 0;
  for (; k < max_peaks; ++k) {
    const float v = key_value(top);
    if (!(v > threshold)) break;  // uniform: every warp computed `top`
    const int y = (unsigned)top >> 16, x = (unsigned)top & 0xffffu;
    const int ty0 = min(max(y - radius, 0) / T, L.nty - L.by);
    const int tx0 = min(max(x - radius, 0) / T, L.ntx - bx);
    const int t0 = ty0 * L.ntx + tx0;

    // Suppress the disk: rounds of 16-byte loads over the box (one round
    // at T = 32 and r = 15), -inf written inside the disk.  A box tile
    // needs its key recomputed only when its best pixel lies in the disk
    // (the winner's tile always does); the others only take the writes.
    bool redo_mine = false;
    for (int base = 0; base < nq; base += kRound) {
      const int q = base + tid * kLoads;  // this thread's first quad
      int py, px;
      if (base == 0) {
        py = oy0;
        px = ox0;
      } else {
        quad_origin<T>(q, bx, py, px);
      }
      py += ty0 * T;
      px += tx0 * T;
      float4 q4[kLoads];
      if (q < nq) {
        const float4* src =
            reinterpret_cast<const float4*>(map + (size_t)py * L.pitch + px);
#pragma unroll
        for (int j = 0; j < kLoads; ++j) q4[j] = src[j];
      }
      if (base == 0) {
        if (tid == kThreads - 1) {  // record the pick while the loads fly
          sc[k] = v;
          co[2 * k] = x;
          co[2 * k + 1] = y;
        }
        if (lane < nt) {
          const Key tk = tkey[t0 + rel];
          const int dy = (int)((unsigned)tk >> 16) - y;
          const int dx = (int)((unsigned)tk & 0xffffu) - x;
          redo_mine = (unsigned)(tk >> 32) > kDead && dy * dy + dx * dx <= r2;
        }
      }
      const unsigned redo = __ballot_sync(kFull, redo_mine);
      if (q >= nq) continue;  // warp-uniform: a warp's quads share a tile
      const int dy = py - y;
      float* row = map + (size_t)py * L.pitch + px;
      if ((redo >> (q / kQuadsPerTile)) & 1u) {
        float bv = -CUDART_INF_F;
        int bi = 0;
#pragma unroll
        for (int j = 0; j < kLoads; ++j) {
          float c[4] = {q4[j].x, q4[j].y, q4[j].z, q4[j].w};
          bool dirty = false;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int dx = px + 4 * j + i - x;
            if (dy * dy + dx * dx <= r2) {
              c[i] = -CUDART_INF_F;
              dirty = true;
            }
            // Increasing index order: `>=` keeps the last of equal values.
            if (c[i] >= bv) {
              bv = c[i];
              bi = 4 * j + i;
            }
          }
          if (dirty)
            reinterpret_cast<float4*>(row)[j] =
                make_float4(c[0], c[1], c[2], c[3]);
        }
        const Key kk = warp_max(make_key(bv, pack(py, px + bi)));
        if (lane == 0) chunk[q / (32 * kLoads)] = kk;
      } else if (dy * dy <= r2) {
#pragma unroll
        for (int i = 0; i < 4 * kLoads; ++i) {
          const int dx = px + i - x;
          if (dy * dy + dx * dx <= r2) row[i] = -CUDART_INF_F;
        }
      }
    }
    __syncthreads();

    // New keys of the redone tiles: lane t of every warp holds box tile t's.
    // Warp w then recomputes the group of redone box tile w (w + kWarps,
    // ...), after writing every redone tile's key itself, so that two warps
    // on one group both see both tiles (and write the same group key).
    {
      Key nk = 0;
      const int tile = t0 + rel;
      if (redo_mine) {
#pragma unroll
        for (int c = 0; c < kChunks; ++c)
          nk = key_max(nk, chunk[lane * kChunks + c]);
      }
      const unsigned redo = __ballot_sync(kFull, redo_mine);
      for (int t = warp; t < nt; t += kWarps) {
        if (!((redo >> t) & 1u)) continue;
        if (redo_mine) tkey[tile] = nk;
        __syncwarp();
        const int g = __shfl_sync(kFull, tile, t) >> 5;
        const int i = g * 32 + lane;
        const Key gk = warp_max(i < L.tiles ? tkey[i] : 0);
        if (lane == 0) gkey[g] = gk;
      }
    }
    __syncthreads();
    top = warp_max_of(gkey, L.groups, lane);
  }
  for (int i = k + tid; i < max_peaks; i += kThreads) {
    sc[i] = 0.f;
    co[2 * i] = 0;
    co[2 * i + 1] = 0;
  }
  if (tid == 0) counts[blockIdx.x] = k;
}

template <int T>
int launch(const float* src, long long batch_stride, long long row_stride,
           const unsigned char* suppressed, int batch, int h, int w,
           int radius, float threshold, int max_peaks, float* work,
           Key* tile_keys, float* scores, int* coords, int* counts,
           cudaStream_t stream) {
  const Layout L(h, w, radius, T);
  if (L.bx * L.by > 32 || L.ntx * T > 65536 || L.nty * T > 65536)
    return (int)cudaErrorInvalidValue;
  const size_t smem = L.smem_bytes();
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        nms_greedy_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  nms_prepass_kernel<T><<<dim3(L.tiles, batch), kPrepassThreads, 0, stream>>>(
      src, batch_stride, row_stride, suppressed, h, w, threshold, work,
      tile_keys);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  nms_greedy_kernel<T><<<batch, kThreads, smem, stream>>>(
      work, tile_keys, h, w, radius, threshold, max_peaks, scores, coords,
      counts);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory a block may opt in to on `device`, in bytes, or minus the
// cudaError_t code when the query fails.
int spr_nms_smem_optin(int device) {
  int optin = 0;
  const cudaError_t e = cudaDeviceGetAttribute(
      &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  return e == cudaSuccess ? optin : -(int)e;
}

// Greedy NMS over `batch` maps of (h, w) at tile edge `tile` (32, 64, 128 or
// 256).  `work` holds batch x (cdiv(h, tile) * tile) x (cdiv(w, tile) * tile)
// floats and `tile_keys` batch x cdiv(h, tile) x cdiv(w, tile) keys; both
// are overwritten.  Returns a cudaError_t code; 0 when both launches were
// accepted.
int spr_nms(const float* src, long long batch_stride, long long row_stride,
            const unsigned char* suppressed, int batch, int h, int w,
            int tile, int radius, float threshold, int max_peaks, float* work,
            Key* tile_keys, float* scores, int* coords, int* counts,
            cudaStream_t stream) {
  switch (tile) {
#define SPR_NMS_TILE(T)                                                     \
  case T:                                                                   \
    return launch<T>(src, batch_stride, row_stride, suppressed, batch, h, w, \
                     radius, threshold, max_peaks, work, tile_keys, scores,  \
                     coords, counts, stream);
    SPR_NMS_TILE(32)
    SPR_NMS_TILE(64)
    SPR_NMS_TILE(128)
    SPR_NMS_TILE(256)
#undef SPR_NMS_TILE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* spr_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
