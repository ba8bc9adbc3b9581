// FMA-chain microkernel (K3) for NVIDIA Hopper (sm_90a): the instrument that
// measures the card's f32 fused multiply-add rate.
//
// Replaces the TPU kernel tpu_rt/utils/roofline.py:_fma_kernel (compiled by
// _timed_fma, driven by measure_vpu_fma_ops). Thread e computes element e of
// that kernel for any length n (the TPU's one (8, 128) block is n = 1024):
// 32 independent chains v_c = a + (float)(0.01 c), stepped `depth` times as
// v <- fma(v, 1.0000001f, a), then summed in chain order v_0 + v_1 + ....
// The seed rounds 0.01 c in double to f32 before the add, as JAX applies the
// weak-typed Python scalar. Each step rounds once (fmaf); the plain version
// (tpu_rt_torch/utils/roofline.py:fma_chains_reference) computes the step in
// float64 and rounds once, which is the same value, so the two agree bit for
// bit.
//
// What bounds it: FP32 instructions, by design. It reads 4 bytes and writes
// 4 bytes per thread and executes 32 * depth FFMAs; at any depth worth
// timing the bytes are nothing.
//
// What the design does about it:
//   * every step is an explicit __fmaf_rn, so the library's --fmad=false
//     (which keeps the path-trace kernels from contracting) does not split
//     it into FMUL + FADD: one step is one FFMA instruction;
//   * 32 independent chains per thread cover the FFMA latency, so a single
//     warp per scheduler could keep its pipe busy; the caller launches one
//     full wave of blocks (tpurt_fma_device gives the resident blocks per
//     SM), so no tail wave runs at partial occupancy;
//   * `depth` is a runtime argument (nothing can be folded), and the depth
//     loop is unrolled 16 times: 512 FFMAs per trip against about three
//     loop instructions, so the slope between two depths counts FFMAs
//     within 1%.

#include <cuda_runtime.h>

namespace {

constexpr int kCarries = 32;
constexpr int kBlock = 256;
constexpr int kUnroll = 16;
constexpr float kMul = 1.0000001f;

__device__ __forceinline__ void step(float (&v)[kCarries], float a) {
#pragma unroll
  for (int c = 0; c < kCarries; ++c) v[c] = __fmaf_rn(v[c], kMul, a);
}

__global__ void __launch_bounds__(kBlock)
fma_chains(const float* __restrict__ x, float* __restrict__ out, int n,
           int depth) {
  const int e = blockIdx.x * kBlock + threadIdx.x;
  if (e >= n) return;
  const float a = x[e];
  float v[kCarries];
#pragma unroll
  for (int c = 0; c < kCarries; ++c) v[c] = a + (float)(0.01 * c);
  int i = 0;
  for (; i + kUnroll <= depth; i += kUnroll) {
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) step(v, a);
  }
  for (; i < depth; ++i) step(v, a);
  float o = v[0];
#pragma unroll
  for (int c = 1; c < kCarries; ++c) o = o + v[c];
  out[e] = o;
}

}  // namespace

extern "C" {

// Launches the FMA chains on `stream`: `x` and `out` are (n,) f32 on the
// device, one thread per element. Allocates nothing and does not
// synchronise. Returns cudaGetLastError() of the launch.
int tpurt_fma_launch(const float* x, float* out, int n, int depth,
                     void* stream) {
  if (n < 1 || depth < 0) return (int)cudaErrorInvalidValue;
  const int blocks = (n + kBlock - 1) / kBlock;
  fma_chains<<<blocks, kBlock, 0, (cudaStream_t)stream>>>(x, out, n, depth);
  return (int)cudaGetLastError();
}

// The card's SM count, its maximum SM clock in kHz, and how many blocks of
// the FMA kernel one SM holds at once. Returns the first CUDA error, or 0.
int tpurt_fma_device(int device, int* sms, int* clock_khz,
                     int* blocks_per_sm) {
  cudaError_t err =
      cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(clock_khz, cudaDevAttrClockRate, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm,
                                                        fma_chains, kBlock, 0);
  return (int)err;
}

}  // extern "C"
