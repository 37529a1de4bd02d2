// Reverse-diffusion step with the classifier-free-guidance combine (K1).
//
// Replaces camels_diffusion_model_tpu/ops/pallas/sampler_step.py ::
// fused_p_sample_step (Pallas TPU kernel, body :25-30, pallas_call :60), and
// takes over the CFG combine of diffusion/sampler.py:137-141 and the strided
// "beta" update of diffusion/ddim.py:100-106, so one kernel serves both
// serving samplers:
//
//   e    = cfg ? eps_u + w * (eps_c - eps_u) : eps      (w scalar or per sample)
//   out  = (x - c_eps * e) * inv_sqrt_a + sigma * z      (z skipped when null)
//
// with eps = [eps_c; eps_u] stacked on the batch axis (the decoder's doubled
// batch) and the three step coefficients computed on the host.
//
// Bound on the H100: bytes at 3.35 TB/s.  It does 6 flops per element
// against 16-20 bytes moved, far below the card's ridge point.  Design: one
// grid-stride pass, each input element read once and the output written
// once, neighbouring threads on neighbouring addresses; the combine happens
// in registers, so the guided eps never goes to device memory, and z is not
// read at all on the last step (sigma = 0).

#include <cuda_runtime.h>

namespace {

__global__ void sampler_step_kernel(const float* __restrict__ x,
                                    const float* __restrict__ eps,
                                    const float* __restrict__ z,
                                    const float* __restrict__ w_per_sample,
                                    float w, float* __restrict__ out,
                                    long long n, long long per_sample, int cfg,
                                    float c_eps, float inv_sqrt_a, float sigma) {
  long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    float e = eps[i];
    if (cfg) {
      float eu = eps[i + n];
      float wi = w_per_sample ? w_per_sample[i / per_sample] : w;
      e = eu + wi * (e - eu);
    }
    float v = (x[i] - e * c_eps) * inv_sqrt_a;
    if (z) v += sigma * z[i];
    out[i] = v;
  }
}

}  // namespace

// n: elements of x (= batch * per_sample).  eps holds n elements, or 2n
// when cfg is set.  w_per_sample: null for a scalar w.  z: null to skip the
// noise term.  Returns the cudaError_t of the launch.
extern "C" int camels_sampler_step(const float* x, const float* eps,
                                   const float* z, const float* w_per_sample,
                                   float w, float* out, long long n,
                                   long long per_sample, int cfg, float c_eps,
                                   float inv_sqrt_a, float sigma,
                                   void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 4096) blocks = 4096;
  sampler_step_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      x, eps, z, w_per_sample, w, out, n, per_sample, cfg, c_eps, inv_sqrt_a,
      sigma);
  return (int)cudaGetLastError();
}
