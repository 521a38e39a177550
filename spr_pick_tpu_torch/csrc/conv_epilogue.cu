// The U-Net conv step's epilogue on Hopper (sm_90a): the bias, the LeakyReLU
// and the hand-off to the consuming conv in one pass over channels-last bf16,
// written straight into the consumer's padded input buffer.  Beside it, the
// fold's input launch, which writes the first conv's buffer and the input's
// slot of the last stage's.
//
// Replaces no Pallas kernel.  On the TPU, XLA fuses the bias add, the
// LeakyReLU, the blind-spot shift, the pool, the upsample, the concatenation
// and the next conv's pad into the conv's output (the JAX package's
// `ops/dense_unet.py`); eager PyTorch runs each as a pass of its own over the
// activation.  This kernel is that fusion, written by hand: the conv reads
// the buffer this kernel wrote, already padded, concatenated and
// channels-last, and writes unpadded NHWC.
//
// Function, bit for bit the port's staged ops (`models/blindspot.py`:
// `conv2d`'s bf16 bias add, `leaky_relu` with the slope rounded to bf16,
// `shift_down`, `F.max_pool2d`, the nearest upsample, `rot4_unstack`, then a
// copy into the zero-padded concatenation): each value is
//     z = bf16(y + b),   a = z > 0 ? z : bf16(z * slope)
// (a = z where the activation is off), then moved by the hand-off:
//   copy      out[i, j] = a[i, j]
//   pool      out[i, j] = the 2x2 max of a over rows 2i, 2i + 1, columns
//             2j, 2j + 1, scanned in that order, a tap replacing the max
//             where it is greater or NaN (as `F.max_pool2d` on the card)
//   upsample  out[i, j] = a[i / 2, j / 2]
//   unrotate  the four rot4 lanes k of an image side by side in channels
//             [k c, (k + 1) c), lane k rotated by (0, 270, 180, 90) degrees
// With `shift`, a is first shifted down a row (a zero row on top, the last
// row dropped), as the blind-spot net does before each pool and at the end.
// `out` is the consumer's contiguous padded buffer: every element of its
// border (all its channels) is written as zero, and channels [0, c) (4c:
// unrotate) of its interior with the values; other channels of the
// interior are left to their writers.  A pool also writes its values into
// a `skip` slot (the decoder's concatenation at that level), interior only.
//
// What bounds it: bytes.  Each conv output element is read once and each
// destination element written once; the least time is (bytes read + bytes
// written) / 3.35 TB/s.  The arithmetic is a few instructions an element.
//
// The design: one block a row of the padded destination, so the border's
// zeros are written in the same pass and no fill runs before it.  A thread
// moves 8 channels (16 bytes) an access.  The block's 192 threads are a
// multiple of the 8-channel groups a destination pixel takes (6, 12 or 48
// for c = 48, 96 and the unrotated 4 x 96), so each thread keeps one group
// over the whole row and holds its bias in registers.  A pool reads two
// source rows, an upsample reads its source row twice (the second from L2);
// the unrotate reads lanes 1 and 3 down a column, 192 contiguous bytes a
// pixel.  (The network's last conv, 96 -> 1 with a float32 output, keeps a
// plain PyTorch add: it moves 2^20 elements a 1024^2 image.)

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 192;  // a block; a multiple of the groups a pixel
constexpr int kVec = 8;        // bf16 channels a 16-byte access

enum Handoff { kCopy = 0, kPool = 1, kUpsample = 2, kUnrotate = 3 };

// A channel slot of a contiguous padded NHWC bf16 buffer.
struct Slot {
  __nv_bfloat16* ptr;  // null: no such destination
  int rows, cols, ch;  // padded rows and columns of an image, channels
  int top, left, off;  // the interior's origin; the slot's first channel
};

__device__ __forceinline__ __nv_bfloat16 finish(float y, float b, bool act,
                                                float slope) {
  const __nv_bfloat16 z = __float2bfloat16_rn(y + b);
  if (!act) return z;
  const float zf = __bfloat162float(z);
  return zf > 0.f ? z : __float2bfloat16_rn(zf * slope);
}

// Two channels packed in a 32-bit word.
__device__ __forceinline__ uint32_t finish2(uint32_t word, float b0, float b1,
                                            bool act, float slope) {
  const float2 y = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&word));
  __nv_bfloat162 z = __halves2bfloat162(finish(y.x, b0, act, slope),
                                        finish(y.y, b1, act, slope));
  return *reinterpret_cast<uint32_t*>(&z);
}

__device__ __forceinline__ uint4 finish8(uint4 u, const float* b, bool act,
                                         float slope) {
  uint4 v;
  v.x = finish2(u.x, b[0], b[1], act, slope);
  v.y = finish2(u.y, b[2], b[3], act, slope);
  v.z = finish2(u.z, b[4], b[5], act, slope);
  v.w = finish2(u.w, b[6], b[7], act, slope);
  return v;
}

// One step of the pool's scan on two channels: the tap `v` replaces the max
// `m` where it is greater or NaN; the bits of the winner are kept.
__device__ __forceinline__ uint32_t scan2(uint32_t m, uint32_t v) {
  const float2 mf = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&m));
  const float2 vf = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v));
  const uint32_t lo = (vf.x > mf.x || vf.x != vf.x) ? v : m;
  const uint32_t hi = (vf.y > mf.y || vf.y != vf.y) ? v : m;
  return (lo & 0xffffu) | (hi & 0xffff0000u);
}

__device__ __forceinline__ uint4 scan8(uint4 m, uint4 v) {
  return make_uint4(scan2(m.x, v.x), scan2(m.y, v.y), scan2(m.z, v.z),
                    scan2(m.w, v.w));
}

__device__ __forceinline__ uint4* slot_at(const Slot& s, long long img, int y,
                                          int x) {
  return reinterpret_cast<uint4*>(
      s.ptr + ((img * s.rows + y + s.top) * s.cols + x + s.left) * s.ch +
      s.off);
}

template <int kHandoff>
__global__ void __launch_bounds__(kThreads) conv_epilogue_kernel(
    const __nv_bfloat16* __restrict__ in, long long in_sn, long long in_sh,
    const float* __restrict__ bias, int h, int c, int act, float slope,
    int shift, int ho, int wo, int lanes, Slot out, Slot skip) {
  const long long row = blockIdx.x;  // over images * out.rows padded rows
  const long long img = row / out.rows;
  const int y = (int)(row - img * out.rows) - out.top;
  const int vecs = out.ch / kVec;  // 16-byte vectors a destination pixel
  uint4* dst = reinterpret_cast<uint4*>(out.ptr + row * out.cols * out.ch);
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  if (y < 0 || y >= ho) {
    for (int j = threadIdx.x; j < out.cols * vecs; j += kThreads)
      dst[j] = zero;
    return;
  }
  for (int j = threadIdx.x; j < out.left * vecs; j += kThreads) dst[j] = zero;
  for (int j = (out.left + wo) * vecs + threadIdx.x; j < out.cols * vecs;
       j += kThreads)
    dst[j] = zero;

  const int src_groups = c / kVec;
  const int groups = kHandoff == kUnrotate ? 4 * src_groups : src_groups;
  const int g = threadIdx.x % groups;
  const int sg = g % src_groups;  // the source's 8-channel group
  float b[kVec];
  {
    const float4* bv = reinterpret_cast<const float4*>(bias + sg * kVec);
    const float4 lo = bv[0], hi = bv[1];
    const float f[kVec] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
    for (int k = 0; k < kVec; ++k)
      b[k] = __bfloat162float(__float2bfloat16_rn(f[k]));
  }
  const bool on = act != 0;
  // The activated 8 channels of source pixel (n, sy, sx); zero above row 0
  // (the shifted-in row).
  auto value = [&](long long n, int sy, int sx) -> uint4 {
    if (sy < 0) return zero;
    const uint4* src = reinterpret_cast<const uint4*>(
        in + n * in_sn + sy * in_sh + (long long)sx * c);
    return finish8(__ldg(src + sg), b, on, slope);
  };
  const int step = kThreads / groups;  // pixels a pass of the block
#pragma unroll 2
  for (int x = threadIdx.x / groups; x < wo; x += step) {
    uint4 v;
    if (kHandoff == kCopy) {
      v = value(img, y - shift, x);
    } else if (kHandoff == kPool) {
      const int r0 = 2 * y - shift, r1 = r0 + 1;
      v = value(img, r0, 2 * x);
      v = scan8(v, value(img, r0, 2 * x + 1));
      v = scan8(v, value(img, r1, 2 * x));
      v = scan8(v, value(img, r1, 2 * x + 1));
    } else if (kHandoff == kUpsample) {
      v = value(img, y >> 1, x >> 1);
    } else {
      // Lane k of this image, un-rotated by (0, 270, 180, 90) degrees: the
      // lane pixel (r, q) that lands on (y, x) of a square of side h.
      const int k = g / src_groups, e = h - 1;
      const int r = k == 0 ? y : k == 1 ? e - x : k == 2 ? e - y : x;
      const int q = k == 0 ? x : k == 1 ? y : k == 2 ? e - x : e - y;
      v = value(k * lanes + img, r - shift, q);
    }
    dst[(out.left + x) * vecs + g] = v;
    if (kHandoff == kPool && skip.ptr) slot_at(skip, img, y, x)[g] = v;
  }
}

// The fold's input: lane l of `lanes` (rot4: image l % n rotated by 0, 90,
// 180 or 270 degrees, l / n; else image l), cast to bf16, into `first`
// (every element: zeros in the border and past channel cin) and into the
// interior of `last`'s slot (x, then zeros to the buffer's last channel).
// One thread a pixel of `first`.
__global__ void fold_input_kernel(const float* __restrict__ x, long long sn,
                                  long long sh, long long sw, long long sc,
                                  int n, int h, int w, int cin, int rot4,
                                  long long pixels, Slot first, Slot last) {
  const long long p = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (p >= pixels) return;
  const long long lane = p / ((long long)first.rows * first.cols);
  const int py = (int)(p / first.cols % first.rows);
  const int px = (int)(p % first.cols);
  const int i = py - first.top, j = px - first.left;
  uint4* dst = reinterpret_cast<uint4*>(first.ptr + p * first.ch);
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  if (i < 0 || i >= h || j < 0 || j >= w) {
    for (int k = 0; k < first.ch / kVec; ++k) dst[k] = zero;
    return;
  }
  const int k = rot4 ? (int)(lane / n) : 0, e = h - 1;
  const int r = k == 0 ? i : k == 1 ? j : k == 2 ? e - i : e - j;
  const int q = k == 0 ? j : k == 1 ? e - i : k == 2 ? e - j : i;
  const float* src = x + (lane % n) * sn + r * sh + q * sw;
  auto pack = [&](int c0) {
    alignas(16) __nv_bfloat16 v[kVec];
#pragma unroll
    for (int t = 0; t < kVec; ++t)
      v[t] = __float2bfloat16_rn(c0 + t < cin ? src[(c0 + t) * sc] : 0.f);
    return *reinterpret_cast<uint4*>(v);
  };
  for (int c0 = 0; c0 < first.ch; c0 += kVec) dst[c0 / kVec] = pack(c0);
  uint4* tail = slot_at(last, lane, i, j);
  for (int c0 = 0; c0 < last.ch - last.off; c0 += kVec)
    tail[c0 / kVec] = pack(c0);
}

Slot make_slot(void* ptr, int rows, int cols, int ch, int top, int left,
               int off) {
  return Slot{static_cast<__nv_bfloat16*>(ptr), rows, cols, ch, top, left,
              off};
}

}  // namespace

extern "C" {

// The epilogue of one conv step.  `in` is the conv's (n, h, w, c) bf16
// output with element strides `in_sn` and `in_sh` over images and rows
// (pixels and channels contiguous), `bias` c float32 values.  `handoff`: 0
// copy, 1 pool (h, w even), 2 upsample, 3 unrotate (n a multiple of 4, h ==
// w).  `out` is the contiguous (n', ho + top + bottom, wo + left + right,
// out_ch) buffer (n' = n / 4 for unrotate, else n; ho, wo the hand-off's
// size), whose border and channels [0, c) (4c: unrotate) of the interior
// are written.  `skip` (pool only, may be null): a contiguous (n,
// ho + skip_top + skip_bottom, wo + skip_left + skip_right, skip_ch) buffer
// whose channels [skip_off, skip_off + c) of the interior are written.  c a
// multiple of 8 whose groups of 8 (4x for unrotate) divide 192; channel
// counts and offsets multiples of 8; pointers and `in_sn`, `in_sh` 16-byte
// aligned.  `shift` (the blind-spot shift) takes no upsample: the U-Net
// shifts before a pool and at its end.  `act` 0: no LeakyReLU.  Returns a
// cudaError_t code; 0 when the launch was accepted.
int spr_conv_epilogue(const void* in, long long in_sn, long long in_sh,
                      const void* bias, int n, int h, int w, int c, int act,
                      float slope, int handoff, int shift, void* out,
                      int out_ch, int top, int bottom, int left, int right,
                      void* skip, int skip_ch, int skip_off,
                      int skip_top, int skip_bottom, int skip_left,
                      int skip_right, cudaStream_t stream) {
  const int groups = (handoff == kUnrotate ? 4 : 1) * (c / kVec);
  if (c <= 0 || c % kVec || kThreads % groups || n < 0 || h < 0 || w < 0 ||
      top < 0 || bottom < 0 || left < 0 || right < 0 || handoff < kCopy ||
      handoff > kUnrotate || (shift && handoff == kUpsample) ||
      out_ch % kVec || groups * kVec > out_ch || skip_ch % kVec ||
      skip_off % kVec)
    return (int)cudaErrorInvalidValue;
  int ho = h, wo = w, images = n;
  if (handoff == kPool) {
    if (h % 2 || w % 2) return (int)cudaErrorInvalidValue;
    ho = h / 2;
    wo = w / 2;
  } else if (handoff == kUpsample) {
    ho = 2 * h;
    wo = 2 * w;
  } else if (handoff == kUnrotate) {
    if (n % 4 || h != w) return (int)cudaErrorInvalidValue;
    images = n / 4;
  }
  if (handoff == kPool && skip && skip_off + c > skip_ch)
    return (int)cudaErrorInvalidValue;
  const int rows = ho + top + bottom, cols = wo + left + right;
  const long long blocks = (long long)images * rows;
  if (blocks == 0 || cols == 0) return 0;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const Slot o = make_slot(out, rows, cols, out_ch, top, left, 0);
  const Slot s = make_slot(handoff == kPool ? skip : nullptr,
                           ho + skip_top + skip_bottom,
                           wo + skip_left + skip_right, skip_ch, skip_top,
                           skip_left, skip_off);
  const auto* x = static_cast<const __nv_bfloat16*>(in);
  const auto* bv = static_cast<const float*>(bias);
  const int lanes = images;
  switch (handoff) {
    case kCopy:
      conv_epilogue_kernel<kCopy><<<(unsigned)blocks, kThreads, 0, stream>>>(
          x, in_sn, in_sh, bv, h, c, act, slope, shift, ho, wo, lanes, o, s);
      break;
    case kPool:
      conv_epilogue_kernel<kPool><<<(unsigned)blocks, kThreads, 0, stream>>>(
          x, in_sn, in_sh, bv, h, c, act, slope, shift, ho, wo, lanes, o, s);
      break;
    case kUpsample:
      conv_epilogue_kernel<kUpsample>
          <<<(unsigned)blocks, kThreads, 0, stream>>>(
              x, in_sn, in_sh, bv, h, c, act, slope, shift, ho, wo, lanes, o,
              s);
      break;
    default:
      conv_epilogue_kernel<kUnrotate>
          <<<(unsigned)blocks, kThreads, 0, stream>>>(
              x, in_sn, in_sh, bv, h, c, act, slope, shift, ho, wo, lanes, o,
              s);
  }
  return (int)cudaGetLastError();
}

// The fold's input.  `x` is (n, h, w, cin) float32 with element strides
// `sn`, `sh`, `sw`, `sc`; `first` the contiguous (n * (rot4 ? 4 : 1), h +
// top + bottom, w + left + right, first_ch) buffer, every element written;
// `last` a contiguous (same lanes, h + last_top + last_bottom, w + last_left
// + last_right, last_ch) buffer whose channels [last_off, last_ch) of the
// interior are written.  rot4 needs h == w.  Channel counts and `last_off`
// multiples of 8, at least cin; pointers 16-byte aligned.
int spr_fold_input(const void* x, long long sn, long long sh, long long sw,
                   long long sc, int n, int h, int w, int cin, int rot4,
                   void* first, int first_ch, int top, int bottom, int left,
                   int right, void* last, int last_ch, int last_off,
                   int last_top, int last_bottom, int last_left,
                   int last_right, cudaStream_t stream) {
  if (n < 0 || h < 0 || w < 0 || cin <= 0 || first_ch % kVec ||
      first_ch < cin || last_ch % kVec || last_off % kVec ||
      last_ch - last_off < cin || (rot4 && h != w) || top < 0 || bottom < 0 ||
      left < 0 || right < 0)
    return (int)cudaErrorInvalidValue;
  const long long lanes = (long long)n * (rot4 ? 4 : 1);
  const int rows = h + top + bottom, cols = w + left + right;
  const long long pixels = lanes * rows * cols;
  if (pixels == 0) return 0;
  const int threads = 256;
  const long long blocks = (pixels + threads - 1) / threads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  fold_input_kernel<<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const float*>(x), sn, sh, sw, sc, n, h, w, cin, rot4,
      pixels, make_slot(first, rows, cols, first_ch, top, left, 0),
      make_slot(last, h + last_top + last_bottom, w + last_left + last_right,
                last_ch, last_top, last_left, last_off));
  return (int)cudaGetLastError();
}

const char* spr_conv_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
