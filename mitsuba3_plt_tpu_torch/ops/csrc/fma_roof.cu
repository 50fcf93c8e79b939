// The FP32 FMA roof probe: four independent chains of x = min(x a + c,
// 3e38), 512 steps each, per element of x [rows, 128].
//
// Replaces: tools/experiments/kernel_mfu.py::vpu_fma_roof (Pallas body
// _fma_kernel), the JAX tool's measure of the TPU's vector FMA rate.
//
// Function: per element x0 = x[r, l] with a = a[r % 8, l] (the tool's
// whole [8, 128] block against each [8, 128] tile of x), three derived
// chains x1 = x0 1.0000001 + 0.25, x2 = x0 0.9999999 + 0.5,
// x3 = x0 1.0000002 + 0.75, then FMA_STEPS steps of
// x_i = min(x_i a + c_i, 3e38) with c_i = 1e-9 i, and the output
// (x0 + x1) + (x2 + x3). Here every x a + c is one fmaf, rounded once:
// the contraction into FFMA is what the probe measures (the intersection
// kernels round each product on its own). The plain version
// (ops/mfu.py::fma_roof_plain) forms x a + c in float64 and rounds it to
// float32 once more, so the two can differ where the float64 sum lands on
// a float32 rounding midpoint: at most an ulp.
//
// What bounds it on the H100: issue slots. Each step is one FFMA and one
// FMNMX per chain, and an SM issues one warp instruction a clock in each
// of its four partitions, so the probe reaches at most half of the
// published 67 TFLOP/s counted in FMA FLOP alone, and its issued
// instructions a second (read from this kernel's SASS by
// ops/mfu.py::fma_roof_sass) are the card's slot roof. Design: one thread
// per element, four chains for ILP, `a` read from memory so that nvcc
// cannot fold the chains, the step loop unrolled 32 deep.
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 256;
constexpr int kLanes = 128;
constexpr int kSub = 8;  // rows of a
constexpr int kSteps = 512;

__global__ void __launch_bounds__(kBlock)
    fma_roof_kernel(const float* __restrict__ x, const float* __restrict__ a,
                    float* __restrict__ out, int n) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= n) return;
  const int lane = i % kLanes;
  const int row = i / kLanes;
  const float av = a[(row % kSub) * kLanes + lane];
  float x0 = x[i];
  float x1 = fmaf(x0, 1.0000001f, 0.25f);
  float x2 = fmaf(x0, 0.9999999f, 0.5f);
  float x3 = fmaf(x0, 1.0000002f, 0.75f);
#pragma unroll 32
  for (int k = 0; k < kSteps; ++k) {
    x0 = fminf(fmaf(x0, av, 1e-9f), 3e38f);
    x1 = fminf(fmaf(x1, av, 2e-9f), 3e38f);
    x2 = fminf(fmaf(x2, av, 3e-9f), 3e38f);
    x3 = fminf(fmaf(x3, av, 4e-9f), 3e38f);
  }
  out[i] = __fadd_rn(__fadd_rn(x0, x1), __fadd_rn(x2, x3));
}

}  // namespace

// x, out [rows, 128], a [8, 128] float32; rows a multiple of 8
extern "C" int plt_fma_roof(const float* x, const float* a, float* out,
                            int rows, void* stream) {
  if (rows % kSub) return (int)cudaErrorInvalidValue;
  const int n = rows * kLanes;
  if (n > 0)
    fma_roof_kernel<<<(n + kBlock - 1) / kBlock, kBlock, 0,
                      (cudaStream_t)stream>>>(x, a, out, n);
  return (int)cudaGetLastError();
}
