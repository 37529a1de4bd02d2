// The C entries of K1 (head_step.cuh): each takes cout, the output channels
// (the model's in_channels), and launches the kernel of group_size(cout)
// channels a CTA; those kernels at one channel are built here, at 2, 3 and
// 4 in head_step_cout<N>.cu.

#include "head_step.cuh"

template struct HeadStep<1>;

// Returns HeadStep<group_size(cout)>::fn of the arguments that follow;
// cudaErrorInvalidValue for cout < 1.
#define CAMELS_HEAD_STEP_DISPATCH(cout, fn, ...)            \
  switch ((cout) < 1 ? 0 : group_size(cout)) {              \
    case 1: return HeadStep<1>::fn(__VA_ARGS__);            \
    case 2: return HeadStep<2>::fn(__VA_ARGS__);            \
    case 3: return HeadStep<3>::fn(__VA_ARGS__);            \
    case 4: return HeadStep<4>::fn(__VA_ARGS__);            \
    default: return (int)cudaErrorInvalidValue;             \
  }

// h: (cfg ? 2 * batch : batch, height, width, c) NHWC float, 16-byte
// aligned; wt: (cout * 9, c) weights, row o * 9 + tap (tap = ky * 3 + kx),
// and bias: (cout,); x, z, out: (batch, height, width, cout) float; z null
// to skip the noise term; w_per_sample: null for the scalar w (floats);
// tanh_out: 1 to take eps = tanh(conv).  rows, ck, stages, threads and
// smem_bytes come from ops/sampler_step.py::launch_plan.  Returns the
// cudaError_t of the launch.  The float unsharded launch.
extern "C" int camels_head_step(const float* h, const float* wt, const float* bias,
                                const float* x, const float* z, const float* w_per_sample,
                                float w, float* out, int batch, int height, int width, int c,
                                int cout, int rows, int cfg, int ck, int stages, int threads,
                                int smem_bytes, float c_eps, float inv_sqrt_a, float sigma,
                                int tanh_out, void* stream) {
  CAMELS_HEAD_STEP_DISPATCH(cout, step, h, wt, bias, x, z, w_per_sample, w, out, batch, height,
                            width, c, cout, rows, cfg, ck, stages, threads, smem_bytes, c_eps,
                            inv_sqrt_a, sigma, tanh_out, stream)
}

// The split launch (both modes): camels_head_step_halo's arguments (top and
// bottom null for the unsharded launch or at the image's edge), then
// partials, a (splits, cfg ? 2 : 1, cout, batch * height * width) float
// workspace, and span and splits (ranges of span channels, the last
// shorter; splits = ceil(c / span)) in place of nothing; rows, threads
// (256), span and smem_bytes from ops/sampler_step.py::split_plan.  bf16:
// items of 64 channels where c and span are multiples of 64, else of 32
// (the last block of a range masked past it).  Returns the cudaError_t of
// the first failed launch.
extern "C" int camels_head_step_split(const float* h, const float* top, const float* bottom,
                                      const float* wt, const float* bias, const float* x,
                                      const float* z, const float* w_per_sample, float w,
                                      float* out, float* partials, int batch, int height,
                                      int width, int c, int cout, int rows, int cfg, int span,
                                      int splits, int threads, int smem_bytes, float c_eps,
                                      float inv_sqrt_a, float sigma, int tanh_out,
                                      void* stream) {
  if (threads != F32_THREADS || c % 4 || span % F32_CK) return (int)cudaErrorInvalidValue;
  CAMELS_HEAD_STEP_DISPATCH(cout, f32_split, h, top, bottom, wt, bias, x, z, w_per_sample, w,
                            out, partials, batch, height, width, c, cout, rows, cfg, span,
                            splits, threads, smem_bytes, c_eps, inv_sqrt_a, sigma, tanh_out,
                            stream)
}

extern "C" int camels_head_step_split_bf16(const bf16* h, const bf16* top, const bf16* bottom,
                                           const bf16* wt, const bf16* bias, const float* x,
                                           const float* z, const float* w_per_sample, float w,
                                           float* out, float* partials, int batch, int height,
                                           int width, int c, int cout, int rows, int cfg,
                                           int span, int splits, int threads, int smem_bytes,
                                           float c_eps, float inv_sqrt_a, float sigma,
                                           int tanh_out, void* stream) {
  if (threads != BF16_THREADS || c % 8 || span % BLOCK) return (int)cudaErrorInvalidValue;
  CAMELS_HEAD_STEP_DISPATCH(cout, bf16_split, c % BLOCK == 0 ? BLOCK : NARROW_BLOCK, h, top,
                            bottom, wt, bias, x, z, w_per_sample, w, out, partials, batch,
                            height, width, c, cout, rows, cfg, span, splits, threads,
                            smem_bytes, c_eps, inv_sqrt_a, sigma, tanh_out, stream)
}

// The bf16 instance (h, wt, bias bf16; c a multiple of 64): the arguments
// of camels_head_step without ck and stages; threads 256; rows and
// smem_bytes come from ops/sampler_step.py::bf16_plan.
extern "C" int camels_head_step_bf16(const bf16* h, const bf16* wt, const bf16* bias,
                                     const float* x, const float* z,
                                     const float* w_per_sample, float w, float* out,
                                     int batch, int height, int width, int c, int cout,
                                     int rows, int cfg, int threads, int smem_bytes,
                                     float c_eps, float inv_sqrt_a, float sigma, int tanh_out,
                                     void* stream) {
  if (batch <= 0) return (int)cudaSuccess;
  if (threads != BF16_THREADS || c % BLOCK) return (int)cudaErrorInvalidValue;
  CAMELS_HEAD_STEP_DISPATCH(cout, bf16_step, BLOCK, h, wt, bias, x, z, w_per_sample, w, out,
                            batch, height, width, c, cout, rows, cfg, threads, smem_bytes,
                            c_eps, inv_sqrt_a, sigma, tanh_out, stream)
}

// The narrow bf16 instance (c a multiple of 8 but not of 64: items of
// NARROW_BLOCK channels, the last block masked past c):
// camels_head_step_bf16's arguments; rows and smem_bytes from
// ops/sampler_step.py::bf16_plan.
extern "C" int camels_head_step_bf16_narrow(const bf16* h, const bf16* wt, const bf16* bias,
                                            const float* x, const float* z,
                                            const float* w_per_sample, float w, float* out,
                                            int batch, int height, int width, int c, int cout,
                                            int rows, int cfg, int threads, int smem_bytes,
                                            float c_eps, float inv_sqrt_a, float sigma,
                                            int tanh_out, void* stream) {
  if (batch <= 0) return (int)cudaSuccess;
  if (threads != BF16_THREADS || c % 8 || c % BLOCK == 0) return (int)cudaErrorInvalidValue;
  CAMELS_HEAD_STEP_DISPATCH(cout, bf16_step, NARROW_BLOCK, h, wt, bias, x, z, w_per_sample, w,
                            out, batch, height, width, c, cout, rows, cfg, threads, smem_bytes,
                            c_eps, inv_sqrt_a, sigma, tanh_out, stream)
}

// The halo mode of the kernels of their own: camels_head_step_bf16's
// arguments with top and bottom after h, each (cfg ? 2 * batch : batch,
// width, c) of h's type, or null (zero rows) at the image's edge.  bf16:
// head_step_bf16_halo_kernel (c a multiple of 64 here, any other multiple
// of 8 in camels_head_step_halo_bf16_narrow below; threads 256, rows and
// smem_bytes from ops/sampler_step.py::bf16_plan); float:
// head_step_halo_f32_kernel (c a multiple of 4, threads 256, rows and
// smem_bytes from ops/sampler_step.py::halo_plan).
extern "C" int camels_head_step_halo_bf16(const bf16* h, const bf16* top, const bf16* bottom,
                                          const bf16* wt, const bf16* bias, const float* x,
                                          const float* z,
                                          const float* w_per_sample, float w, float* out,
                                          int batch, int height, int width, int c, int cout,
                                          int rows, int cfg, int threads, int smem_bytes,
                                          float c_eps, float inv_sqrt_a, float sigma,
                                          int tanh_out, void* stream) {
  if (threads != BF16_THREADS || c % BLOCK) return (int)cudaErrorInvalidValue;
  CAMELS_HEAD_STEP_DISPATCH(cout, bf16_halo, BLOCK, h, top, bottom, wt, bias, x, z,
                            w_per_sample, w, out, batch, height, width, c, cout, rows, cfg,
                            threads, smem_bytes, c_eps, inv_sqrt_a, sigma, tanh_out, stream)
}

// The narrow bf16 halo mode (c a multiple of 8 but not of 64): the
// arguments of camels_head_step_halo_bf16.
extern "C" int camels_head_step_halo_bf16_narrow(
    const bf16* h, const bf16* top, const bf16* bottom, const bf16* wt, const bf16* bias,
    const float* x, const float* z, const float* w_per_sample, float w, float* out, int batch,
    int height, int width, int c, int cout, int rows, int cfg, int threads, int smem_bytes,
    float c_eps, float inv_sqrt_a, float sigma, int tanh_out, void* stream) {
  if (threads != BF16_THREADS || c % 8 || c % BLOCK == 0) return (int)cudaErrorInvalidValue;
  CAMELS_HEAD_STEP_DISPATCH(cout, bf16_halo, NARROW_BLOCK, h, top, bottom, wt, bias, x, z,
                            w_per_sample, w, out, batch, height, width, c, cout, rows, cfg,
                            threads, smem_bytes, c_eps, inv_sqrt_a, sigma, tanh_out, stream)
}

extern "C" int camels_head_step_halo(const float* h, const float* top, const float* bottom,
                                     const float* wt, const float* bias, const float* x,
                                     const float* z,
                                     const float* w_per_sample, float w, float* out,
                                     int batch, int height, int width, int c, int cout,
                                     int rows, int cfg, int threads, int smem_bytes,
                                     float c_eps, float inv_sqrt_a, float sigma, int tanh_out,
                                     void* stream) {
  if (threads != F32_THREADS || c % 4) return (int)cudaErrorInvalidValue;
  CAMELS_HEAD_STEP_DISPATCH(cout, f32_halo, h, top, bottom, wt, bias, x, z, w_per_sample, w,
                            out, batch, height, width, c, cout, rows, cfg, threads, smem_bytes,
                            c_eps, inv_sqrt_a, sigma, tanh_out, stream)
}

// The fp32 unsharded launch at widths from 128 (head_step_f32_band_kernel):
// camels_head_step_bf16's arguments on float features (c a multiple of 4,
// threads 256; rows and smem_bytes from ops/sampler_step.py::halo_plan).
extern "C" int camels_head_step_f32_band(const float* h, const float* wt, const float* bias,
                                         const float* x, const float* z,
                                         const float* w_per_sample, float w, float* out,
                                         int batch, int height, int width, int c, int cout,
                                         int rows, int cfg, int threads, int smem_bytes,
                                         float c_eps, float inv_sqrt_a, float sigma,
                                         int tanh_out, void* stream) {
  if (batch <= 0) return (int)cudaSuccess;
  if (threads != F32_THREADS || c % 4) return (int)cudaErrorInvalidValue;
  CAMELS_HEAD_STEP_DISPATCH(cout, f32_band, h, wt, bias, x, z, w_per_sample, w, out, batch,
                            height, width, c, cout, rows, cfg, threads, smem_bytes, c_eps,
                            inv_sqrt_a, sigma, tanh_out, stream)
}
