// FiLM modulation out = scale * x + shift over NHWC (K3).
//
// Replaces camels_diffusion_model_tpu/ops/pallas/film.py :: fused_film
// (Pallas TPU kernel, body :23-25, pallas_call :36).  The ContextUnet's
// decoder applies it at stages 0 and 1 (context_unet.py:304-307): scale is
// the context embedding, one row per sample, and shift the time embedding,
// one row broadcast over the batch (sampler.py:144-160).  A row stride of 0
// broadcasts, of C reads one row per sample.
//
// Bound on the H100: bytes at 3.35 TB/s (one multiply-add per 8 bytes).
// Design: one grid-stride pass per sample (grid.y), x read once and out
// written once, coalesced, 32-bit index math; scale and shift rows are a few
// KB and stay in L1/L2.

#include <cuda_runtime.h>

namespace {

// grid.y walks the samples, so a thread needs no 64-bit division to find its
// row: within a sample, the channel of element j is j % c.
__global__ void film_kernel(const float* __restrict__ x,
                            const float* __restrict__ scale,
                            const float* __restrict__ shift,
                            float* __restrict__ out, int per_sample, int c,
                            int scale_stride, int shift_stride) {
  const long long base = (long long)blockIdx.y * per_sample;
  const float* sc = scale + (long long)blockIdx.y * scale_stride;
  const float* sh = shift + (long long)blockIdx.y * shift_stride;
  for (int j = blockIdx.x * blockDim.x + threadIdx.x; j < per_sample;
       j += gridDim.x * blockDim.x) {
    int ch = j % c;
    out[base + j] = x[base + j] * sc[ch] + sh[ch];
  }
}

}  // namespace

// x/out: (N, H, W, C) contiguous; scale/shift rows of C floats with the given
// strides (0 or C).  Returns the cudaError_t of the launch.
extern "C" int camels_film(const float* x, const float* scale,
                           const float* shift, float* out, long long n,
                           long long hw, int c, int scale_stride,
                           int shift_stride, void* stream) {
  long long per_sample = hw * c;
  if (n <= 0 || per_sample <= 0) return (int)cudaSuccess;
  if (per_sample > 0x7fffffffLL || n > 65535) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  long long bx = (per_sample + threads - 1) / threads;
  if (bx > 1024) bx = 1024;
  dim3 grid((unsigned)bx, (unsigned)n);
  film_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      x, scale, shift, out, (int)per_sample, c, scale_stride, shift_stride);
  return (int)cudaGetLastError();
}
