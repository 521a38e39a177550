// The U-Net conv step's epilogue on Hopper (sm_90a): the bias, the LeakyReLU
// and the consuming conv's zero pad in one pass over channels-last bf16.
//
// Replaces no Pallas kernel.  On the TPU, XLA fuses the bias add, the
// LeakyReLU and the next conv's pad into the conv's output (the JAX
// package's `ops/dense_unet.py:_shift_conv_xla` and `_leaky`); eager
// PyTorch runs each as a pass of its own over the activation, and cuDNN
// transposes an NCHW activation into NHWC and back around every conv.  This
// kernel is that fusion, written by hand: the conv reads the buffer this
// kernel wrote, already padded and channels-last, and writes unpadded NHWC.
//
// Function, bit for bit the port's two-op chain (`models/blindspot.py`:
// `conv2d`'s bf16 bias add, then `leaky_relu` with the slope rounded to
// bf16): `out` is the (n, h + top + bottom, w + left + right, c) input of
// the next conv, zeros in the pad, and in the interior
//     z = bf16(y + b),   out = z > 0 ? z : bf16(z * slope)
// or out = z where the activation is off.  The bias is the layer's float32
// parameter, rounded to bf16 here as `conv2d` casts it (no cast launch).
//
// What bounds it: bytes.  Each interior element is read once and written
// once (2 + 2 bytes), each pad element written once; the least time is
// (bytes read + bytes written) / 3.35 TB/s.  The arithmetic is a few
// instructions an element.
//
// The design: one block a row of the padded output, so the pad's zeros are
// written in the same pass and no fill runs before it.  A thread moves 8
// channels (16 bytes) an access.  The block's 192 threads are a multiple of
// c / 8 for c = 48, 96 and 384 (the U-Net's widths), so each thread keeps
// one group of 8 channels over the whole row and holds their bias in
// registers.  (The network's last conv, 96 -> 1 with a float32 output,
// keeps a plain PyTorch add: it moves 2^20 elements a 1024^2 image.)

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 192;  // a block; a multiple of c / 8
constexpr int kVec = 8;        // bf16 channels a 16-byte access

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

__global__ void __launch_bounds__(kThreads) conv_epilogue_kernel(
    const __nv_bfloat16* __restrict__ in, long long in_sn, long long in_sh,
    const float* __restrict__ bias, __nv_bfloat16* __restrict__ out,
    int hp, int h, int w, int c, int top, int left, int right, int act,
    float slope) {
  const int wp = w + left + right;
  const int groups = c / kVec;  // 8-channel groups a pixel
  const long long row = blockIdx.x;  // over n * hp padded rows
  const long long n = row / hp;
  const int y = (int)(row - n * hp) - top;
  uint4* dst = reinterpret_cast<uint4*>(out + row * wp * c);
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  if (y < 0 || y >= h) {
    for (int j = threadIdx.x; j < wp * groups; j += kThreads) dst[j] = zero;
    return;
  }
  const int g = threadIdx.x % groups;
  float b[kVec];
  {
    const float4* bv = reinterpret_cast<const float4*>(bias + g * kVec);
    const float4 lo = bv[0], hi = bv[1];
    const float f[kVec] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
    for (int k = 0; k < kVec; ++k)
      b[k] = __bfloat162float(__float2bfloat16_rn(f[k]));
  }
  const uint4* src = reinterpret_cast<const uint4*>(in + n * in_sn + y * in_sh);
  const int step = kThreads / groups;  // pixels a pass of the block
  const bool on = act != 0;
#pragma unroll 4
  for (int xp = threadIdx.x / groups; xp < wp; xp += step) {
    const int x = xp - left;
    uint4 v = zero;
    if (x >= 0 && x < w) {
      const uint4 u = __ldg(src + (long long)x * groups + g);
      v.x = finish2(u.x, b[0], b[1], on, slope);
      v.y = finish2(u.y, b[2], b[3], on, slope);
      v.z = finish2(u.z, b[4], b[5], on, slope);
      v.w = finish2(u.w, b[6], b[7], on, slope);
    }
    dst[(long long)xp * groups + g] = v;
  }
}

}  // namespace

extern "C" {

// The epilogue of one conv step.  `in` is the conv's (n, h, w, c) bf16
// output with element strides `in_sn` and `in_sh` over images and rows
// (pixels and channels contiguous), `bias` c float32 values, `out` the
// contiguous (n, h + top + bottom, w + left + right, c) buffer, every
// element of which is written.  c a multiple of 8 that divides 8 * 192
// into whole groups; `in`, `bias`, `out`, `in_sn` and `in_sh` 16-byte
// aligned.  `act` 0: no LeakyReLU.  Returns a cudaError_t code; 0 when the
// launch was accepted.
int spr_conv_epilogue(const void* in, long long in_sn, long long in_sh,
                      const void* bias, void* out, int n, int h, int w, int c,
                      int top, int bottom, int left, int right, int act,
                      float slope, cudaStream_t stream) {
  if (c <= 0 || c % kVec || kThreads % (c / kVec) || n < 0 || h < 0 ||
      w < 0 || top < 0 || bottom < 0 || left < 0 || right < 0)
    return (int)cudaErrorInvalidValue;
  const long long rows = (long long)n * (h + top + bottom);
  if (rows == 0 || w + left + right == 0) return 0;
  if (rows > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  conv_epilogue_kernel<<<(unsigned)rows, kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(in), in_sn, in_sh,
      static_cast<const float*>(bias),
      static_cast<__nv_bfloat16*>(out), h + top + bottom, h, w, c, top, left,
      right, act, slope);
  return (int)cudaGetLastError();
}

const char* spr_conv_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
