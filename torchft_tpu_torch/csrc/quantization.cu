// Blockwise fp8/int8 codec for Hopper (sm_90a): quantize and dequantize.
//
// Replaces the two Pallas TPU kernels of torchft_tpu/ops/quantization.py:
//   quantize_blocks_kernel   <- quantize_blocks_pallas   (B1)
//   dequantize_blocks_kernel <- dequantize_blocks_pallas (B2)
// and gives the host codec's bytes. Each 256-element row of f32 gets one
// scale, maxabs / qmax (qmax 448 for fp8 e4m3fn, 127 for int8), or 1.0 when
// maxabs is 0 or NaN; the payload is x / scale cast to fp8 with round to
// nearest even, or rounded half-to-even to int8. Dequantize is
// payload * scale per row. Where a naive CUDA version would differ:
//   - the max lets NaN win (fmaxf drops it), so a row holding a NaN gets
//     scale 1.0 exactly as numpy's and jnp's max give it;
//   - x / scale and maxabs / qmax are IEEE divisions (no reciprocal, no
//     --use_fast_math), or a payload byte could differ from the host's;
//   - fp8: NaN, +-inf and anything that rounds past 448 become NaN with
//     the value's sign, as the reference's non-saturating cast gives; the
//     rest goes through the hardware's round-to-nearest-even convert;
//   - a NaN quotient's sign is the x86 host's: a NaN input keeps its own
//     sign, an invalid division (inf/inf, 0/0) gives the negative default
//     NaN, where CUDA's division returns a positive NaN in both cases;
//   - int8: rintf (half to even), then saturate to [-128, 127] with NaN to
//     0, as XLA's convert does.
//
// What bounds them on the H100: about one operation per byte moved, far
// below the card's ~295 operations per byte, so memory is the bound:
// quantize reads 4 bytes and writes 1 + 4/256 per element, dequantize the
// reverse. The design is the simple one: one warp per row, each lane
// loading two float4 (the row's two 512-byte halves, coalesced), a
// warp-shuffle max, then the scale and the eight conversions in registers;
// dequantize gives each thread four consecutive elements of one row.
//
// Build (plain C interface, loaded with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libquantization.so quantization.cu

#include <cstdint>

#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 256;        // elements per row (one scale each)
constexpr int kRowsPerCta = 8;     // quantize: one warp per row
constexpr int kDequantThreads = 256;
enum Wire : int { kFp8 = 0, kInt8 = 1 };

__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;  // a NaN on either side wins
}

// v = x / scale.
__device__ __forceinline__ uint8_t to_fp8(float v, float x) {
  if (v != v) return (x == x || signbit(x)) ? 0xFF : 0x7F;
  if (fabsf(v) > 464.0f) return signbit(v) ? 0xFF : 0x7F;
  return static_cast<uint8_t>(__nv_cvt_float_to_fp8(v, __NV_SATFINITE, __NV_E4M3));
}

__device__ __forceinline__ uint8_t to_int8(float v) {
  float r = rintf(v);
  if (r != r) r = 0.0f;
  r = fminf(fmaxf(r, -128.0f), 127.0f);
  return static_cast<uint8_t>(static_cast<int8_t>(static_cast<int>(r)));
}

template <int kWire>
__global__ void quantize_blocks_kernel(const float* __restrict__ x,
                                       uint8_t* __restrict__ payload,
                                       float* __restrict__ scales, int64_t n_blocks) {
  const int lane = threadIdx.x & 31;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kRowsPerCta + (threadIdx.x >> 5);
  if (row >= n_blocks) return;
  const float* src = x + row * kBlock;
  const float4 lo = reinterpret_cast<const float4*>(src)[lane];
  const float4 hi = reinterpret_cast<const float4*>(src + kBlock / 2)[lane];
  const float v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};

  float m = fabsf(v[0]);
#pragma unroll
  for (int i = 1; i < 8; ++i) m = nan_max(m, fabsf(v[i]));
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1)
    m = nan_max(m, __shfl_xor_sync(0xffffffffu, m, offset));

  const float qmax = kWire == kFp8 ? 448.0f : 127.0f;
  const float scale = m > 0.0f ? m / qmax : 1.0f;
  if (lane == 0) scales[row] = scale;

  uint8_t q[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float s = v[i] / scale;
    q[i] = kWire == kFp8 ? to_fp8(s, v[i]) : to_int8(s);
  }
  uint8_t* dst = payload + row * kBlock;
  reinterpret_cast<uchar4*>(dst)[lane] = make_uchar4(q[0], q[1], q[2], q[3]);
  reinterpret_cast<uchar4*>(dst + kBlock / 2)[lane] = make_uchar4(q[4], q[5], q[6], q[7]);
}

// Two e4m3 bytes to two floats (exact: every e4m3 value is a half).
__device__ __forceinline__ float2 from_fp8x2(uint8_t lo, uint8_t hi) {
  const __nv_fp8x2_storage_t pair =
      static_cast<__nv_fp8x2_storage_t>(lo | (static_cast<uint16_t>(hi) << 8));
  return __half22float2(__half2(__nv_cvt_fp8x2_to_halfraw2(pair, __NV_E4M3)));
}

template <int kWire>
__global__ void dequantize_blocks_kernel(const uint8_t* __restrict__ payload,
                                         const float* __restrict__ scales,
                                         float* __restrict__ out, int64_t n_quads) {
  const int64_t quad = static_cast<int64_t>(blockIdx.x) * kDequantThreads + threadIdx.x;
  if (quad >= n_quads) return;
  const float scale = scales[quad / (kBlock / 4)];
  const uchar4 b = reinterpret_cast<const uchar4*>(payload)[quad];
  float4 r;
  if (kWire == kFp8) {
    const float2 a = from_fp8x2(b.x, b.y);
    const float2 c = from_fp8x2(b.z, b.w);
    r = make_float4(a.x, a.y, c.x, c.y);
  } else {
    r = make_float4(static_cast<int8_t>(b.x), static_cast<int8_t>(b.y),
                    static_cast<int8_t>(b.z), static_cast<int8_t>(b.w));
  }
  r.x *= scale;
  r.y *= scale;
  r.z *= scale;
  r.w *= scale;
  reinterpret_cast<float4*>(out)[quad] = r;
}

}  // namespace

extern "C" {

// x: (n_blocks, 256) f32; payload: (n_blocks, 256) bytes; scales: n_blocks f32.
// Returns the launch's CUDA error (0 on success).
int tpuft_quantize_blocks(const float* x, void* payload, float* scales, int64_t n_blocks,
                          int wire, void* stream) {
  if (n_blocks <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((n_blocks + kRowsPerCta - 1) / kRowsPerCta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* p = static_cast<uint8_t*>(payload);
  if (wire == kFp8) {
    quantize_blocks_kernel<kFp8><<<grid, 32 * kRowsPerCta, 0, s>>>(x, p, scales, n_blocks);
  } else if (wire == kInt8) {
    quantize_blocks_kernel<kInt8><<<grid, 32 * kRowsPerCta, 0, s>>>(x, p, scales, n_blocks);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// payload: (n_blocks, 256) bytes; scales: n_blocks f32; out: (n_blocks, 256) f32.
int tpuft_dequantize_blocks(const void* payload, const float* scales, float* out,
                            int64_t n_blocks, int wire, void* stream) {
  if (n_blocks <= 0) return (int)cudaErrorInvalidValue;
  const int64_t n_quads = n_blocks * (kBlock / 4);
  const dim3 grid((n_quads + kDequantThreads - 1) / kDequantThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* p = static_cast<const uint8_t*>(payload);
  if (wire == kFp8) {
    dequantize_blocks_kernel<kFp8><<<grid, kDequantThreads, 0, s>>>(p, scales, out, n_quads);
  } else if (wire == kInt8) {
    dequantize_blocks_kernel<kInt8><<<grid, kDequantThreads, 0, s>>>(p, scales, out, n_quads);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
