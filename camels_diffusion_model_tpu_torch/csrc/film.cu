// FiLM modulation out = scale * x + shift over NHWC (K3).
//
// Replaces camels_diffusion_model_tpu/ops/pallas/film.py :: fused_film
// (Pallas TPU kernel, body :23-25, pallas_call :37).  The ContextUnet's
// decoder applies FiLM at stages 0 and 1 (context_unet.py:304-307); stage 0
// is the epilogue of the GroupNorm kernel (groupnorm.cu), so this kernel
// runs at stage 1.  scale is the context embedding, one row per sample, and
// shift the time embedding, one row broadcast over the batch
// (sampler.py:144-160).  A row stride of 0 broadcasts, of C reads one row
// per sample.
//
// Bound on the H100: bytes at 3.35 TB/s (one multiply-add per 8 bytes).
// Design: grid.y walks the samples and a block covers whole pixels, so a
// thread keeps the same channels for the whole pass: its scale and shift
// values are loaded once into registers and the loop does no division.
// x is read and out written once, 16 bytes a thread (float4) with four
// loads in flight, and the grid is one full wave of the card
// (ops/film.py::launch_plan).  Rows whose channels are not a multiple of 4,
// or pointers not 16-byte aligned, take the scalar instance (V = 1).

#include <cuda_runtime.h>

#include "pack.cuh"

namespace {

template <int V>
__global__ void film_kernel(const float* __restrict__ x,
                            const float* __restrict__ scale,
                            const float* __restrict__ shift,
                            float* __restrict__ out, int hw, int c,
                            int scale_stride, int shift_stride) {
  const int vpp = c / V;                 // vectors per pixel
  const int pstride = blockDim.x / vpp;  // pixels the block covers per step
  if ((int)threadIdx.x >= pstride * vpp) return;
  const int j = (threadIdx.x % vpp) * V;
  const int n = blockIdx.y;
  const Pack<V> s = load<V>(scale + (long long)n * scale_stride + j);
  const Pack<V> h = load<V>(shift + (long long)n * shift_stride + j);
  const float* xs = x + (long long)n * hw * c + j;
  float* os = out + (long long)n * hw * c + j;
#pragma unroll 4
  for (int p = blockIdx.x * pstride + threadIdx.x / vpp; p < hw;
       p += gridDim.x * pstride) {
    Pack<V> v = load<V>(xs + p * c);
#pragma unroll
    for (int i = 0; i < V; ++i) v.v[i] = v.v[i] * s.v[i] + h.v[i];
    store<V>(os + p * c, v);
  }
}

}  // namespace

// x/out: (n, hw, c) contiguous NHWC, hw * c < 2^31 and n <= 65535;
// scale/shift rows of c floats with the given strides (0 or c).  vec,
// threads and blocks_per_sample come from ops/film.py::launch_plan, which
// also checks those limits (vec 4 needs c % 4 == 0 and 16-byte aligned
// pointers).  Returns the cudaError_t of the launch.
extern "C" int camels_film(const float* x, const float* scale,
                           const float* shift, float* out, int n, int hw,
                           int c, int scale_stride, int shift_stride, int vec,
                           int threads, int blocks_per_sample, void* stream) {
  if (n <= 0 || hw <= 0) return (int)cudaSuccess;
  dim3 grid((unsigned)blocks_per_sample, (unsigned)n);
  cudaStream_t s = (cudaStream_t)stream;
  if (vec == 4)
    film_kernel<4><<<grid, threads, 0, s>>>(x, scale, shift, out, hw, c,
                                            scale_stride, shift_stride);
  else if (vec == 1)
    film_kernel<1><<<grid, threads, 0, s>>>(x, scale, shift, out, hw, c,
                                            scale_stride, shift_stride);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
