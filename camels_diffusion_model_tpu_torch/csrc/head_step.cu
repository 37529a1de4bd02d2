// The C entries of K1 (head_step.cuh): each takes cout, the output channels
// (the model's in_channels).  The bf16 band kernels and the split launch
// run the kernel of group_size(cout) channels a CTA: those kernels at one
// channel are built here, at 2, 3 and 4 in head_step_cout<N>.cu.  The float
// template and the fp32 band kernels (defined here) take one channel.
// camels_head_step_os[_bf16] launch the output-stationary kernel at several
// output channels (head_step_os_*.cu).

#include "head_step.cuh"

template struct HeadStep<1>;

namespace {

// The fp32 band kernels (head_step.cuh, "The float halo mode") at one
// output channel; several take the output-stationary kernel or the split
// launch (ops/sampler_step.py::route).
//
// The fp32 halo mode: a band's row -1 or `height` copied from the halo rows
// (band_source).  Two CTAs an SM.
__global__ void __launch_bounds__(F32_THREADS, 2) head_step_halo_f32_kernel(
    const float* __restrict__ h, const float* __restrict__ top,
    const float* __restrict__ bottom, const float* __restrict__ wt,
    const float* __restrict__ bias, const float* __restrict__ x, const float* __restrict__ z,
    const float* __restrict__ w_per_sample, float w, float* __restrict__ out, int batch,
    int height, int width, int c, int cout, int rows, int cfg, float c_eps, float inv_sqrt_a,
    float sigma, int tanh_out) {
  const int bands = (height + rows - 1) / rows;
  const OutGroup og = out_group<1>(cout);
  const int unit = og.blk / bands;
  const int y0 = (og.blk - unit * bands) * rows;
  const Band band = band_of(unit, batch, height, width, c, rows, cfg, y0);
  auto source_of = [&](int p) { return band_source<float>(band, h, top, bottom, p, c); };
  f32_step_body<false, 1>(source_of, unit, y0, band.pb, band.m, cout, og.o0, h, wt, bias, x,
                          z, w_per_sample, w, out, height, width, c, rows, cfg, c_eps,
                          inv_sqrt_a, sigma, tanh_out);
}

// The fp32 unsharded launch at widths from 128 (ops/sampler_step.py::route):
// the same body with the unsharded copy map of head_step_bf16_kernel, rows
// outside the map zero, in a kernel of its own so that the halo kernel keeps
// its text.  Against the template (head_step_kernel) at 128-wide maps, whose
// band of (rows + 2) x 128 pixel pairs under CFG fits MAX_THREADS only at one
// row (three rows staged for each row computed) and whose ring held one CTA
// an SM: bands of any height whatever the width (2 rows at up to 128
// channels, two CTAs an SM; 4 over them, where rows staged again from L2 cost
// more: ops/sampler_step.py::BAND_ROWS), warp-private rings.  Without CFG
// the template's band of 4 rows fits, and at 256 channels it stays faster
// (ops/sampler_step.py::route keeps it there).
__global__ void __launch_bounds__(F32_THREADS, 2) head_step_f32_band_kernel(
    const float* __restrict__ h, const float* __restrict__ wt, const float* __restrict__ bias,
    const float* __restrict__ x, const float* __restrict__ z,
    const float* __restrict__ w_per_sample, float w, float* __restrict__ out, int batch,
    int height, int width, int c, int cout, int rows, int cfg, float c_eps, float inv_sqrt_a,
    float sigma, int tanh_out) {
  const int bands = (height + rows - 1) / rows;
  const OutGroup og = out_group<1>(cout);
  const int unit = og.blk / bands;
  const int y0 = (og.blk - unit * bands) * rows;
  const int pb = (rows + 2) * width, m = (cfg ? 2 : 1) * pb;
  // As head_step_bf16_kernel's: a branch's band pixel q is pixel q of the
  // run that starts at its sample's row y0 - 1, read where inside the map.
  const int base0 = ((unit * height + y0 - 1) * width) * c;
  const int base1 = cfg ? (((unit + batch) * height + y0 - 1) * width) * c : 0;
  const int q_lo = y0 == 0 ? width : 0, q_hi = min(pb, (height - y0 + 1) * width);
  auto source_of = [&](int p) {
    const int s = p >= pb, qq = p - s * pb;
    return Source<float>{h, (s ? base1 : base0) + qq * c, p < m && qq >= q_lo && qq < q_hi};
  };
  f32_step_body<false, 1>(source_of, unit, y0, pb, m, cout, og.o0, h, wt, bias, x, z,
                          w_per_sample, w, out, height, width, c, rows, cfg, c_eps, inv_sqrt_a,
                          sigma, tanh_out);
}

}  // namespace

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
// cudaError_t of the launch.  The float unsharded launch of one output
// channel (the float template; several take camels_head_step_os).
extern "C" int camels_head_step(const float* h, const float* wt, const float* bias,
                                const float* x, const float* z, const float* w_per_sample,
                                float w, float* out, int batch, int height, int width, int c,
                                int cout, int rows, int cfg, int ck, int stages, int threads,
                                int smem_bytes, float c_eps, float inv_sqrt_a, float sigma,
                                int tanh_out, void* stream) {
  if (cout != 1) return (int)cudaErrorInvalidValue;
  return entry<float>(h, wt, bias, x, z, w_per_sample, w, out, batch, height, width, c, cout,
                      rows, cfg, ck, stages, threads, smem_bytes, c_eps, inv_sqrt_a, sigma,
                      tanh_out, stream);
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
// head_step_halo_f32_kernel (c a multiple of 4, one output channel,
// threads 256, rows and smem_bytes from ops/sampler_step.py::halo_plan).
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
  if (threads != F32_THREADS || c % 4 || cout != 1) return (int)cudaErrorInvalidValue;
  return band_launch<float>(head_step_halo_f32_kernel, h, top, bottom, wt, bias, x, z,
                            w_per_sample, w, out, batch, height, width, c, cout, 1, rows, cfg,
                            threads, smem_bytes, c_eps, inv_sqrt_a, sigma, tanh_out, stream);
}

// The fp32 unsharded launch at widths from 128 (head_step_f32_band_kernel):
// camels_head_step_bf16's arguments on float features (c a multiple of 4,
// one output channel, threads 256; rows and smem_bytes from
// ops/sampler_step.py::halo_plan).
extern "C" int camels_head_step_f32_band(const float* h, const float* wt, const float* bias,
                                         const float* x, const float* z,
                                         const float* w_per_sample, float w, float* out,
                                         int batch, int height, int width, int c, int cout,
                                         int rows, int cfg, int threads, int smem_bytes,
                                         float c_eps, float inv_sqrt_a, float sigma,
                                         int tanh_out, void* stream) {
  if (threads != F32_THREADS || c % 4 || cout != 1) return (int)cudaErrorInvalidValue;
  return unsharded_launch<float>(head_step_f32_band_kernel, h, wt, bias, x, z, w_per_sample, w,
                                 out, batch, height, width, c, cout, 1, rows, cfg, threads,
                                 smem_bytes, c_eps, inv_sqrt_a, sigma, tanh_out, stream);
}

// The output-stationary kernel at cout >= 2 output channels, both modes:
// camels_head_step_split's arguments without partials, span and splits;
// top and bottom null for the unsharded launch.  rows, threads (256) and
// smem_bytes come from
// ops/sampler_step.py::os_plan.  A CTA takes a group of up to OS_COUT_MAX
// channels (equal groups, the last masked past cout): fp32 the instance of
// the group's channels, bf16 that of 8 or 16.
#define CAMELS_HEAD_STEP_OS_ARGS                                                          \
  h, top, bottom, wt, bias, x, z, w_per_sample, w, out, batch, height, width, c, cout, rows, \
      cfg, threads, smem_bytes, c_eps, inv_sqrt_a, sigma, tanh_out, stream

inline int os_group(int cout) {
  const int groups = (cout + OS_COUT_MAX - 1) / OS_COUT_MAX;
  return (cout + groups - 1) / groups;
}

extern "C" int camels_head_step_os(const float* h, const float* top, const float* bottom,
                                   const float* wt, const float* bias, const float* x,
                                   const float* z, const float* w_per_sample, float w,
                                   float* out, int batch, int height, int width, int c,
                                   int cout, int rows, int cfg, int threads, int smem_bytes,
                                   float c_eps, float inv_sqrt_a, float sigma, int tanh_out,
                                   void* stream) {
  if (cout < 2 || c % 4) return (int)cudaErrorInvalidValue;
  switch (os_group(cout)) {
#define CAMELS_HEAD_STEP_OS_CASE(N) \
    case N: return HeadStepOs<float, N>::launch(CAMELS_HEAD_STEP_OS_ARGS);
    CAMELS_HEAD_STEP_OS_CASE(2) CAMELS_HEAD_STEP_OS_CASE(3) CAMELS_HEAD_STEP_OS_CASE(4)
    CAMELS_HEAD_STEP_OS_CASE(5) CAMELS_HEAD_STEP_OS_CASE(6) CAMELS_HEAD_STEP_OS_CASE(7)
    CAMELS_HEAD_STEP_OS_CASE(8) CAMELS_HEAD_STEP_OS_CASE(9) CAMELS_HEAD_STEP_OS_CASE(10)
    CAMELS_HEAD_STEP_OS_CASE(11) CAMELS_HEAD_STEP_OS_CASE(12) CAMELS_HEAD_STEP_OS_CASE(13)
    CAMELS_HEAD_STEP_OS_CASE(14) CAMELS_HEAD_STEP_OS_CASE(15) CAMELS_HEAD_STEP_OS_CASE(16)
#undef CAMELS_HEAD_STEP_OS_CASE
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int camels_head_step_os_bf16(const bf16* h, const bf16* top, const bf16* bottom,
                                        const bf16* wt, const bf16* bias, const float* x,
                                        const float* z, const float* w_per_sample, float w,
                                        float* out, int batch, int height, int width, int c,
                                        int cout, int rows, int cfg, int threads,
                                        int smem_bytes, float c_eps, float inv_sqrt_a,
                                        float sigma, int tanh_out, void* stream) {
  if (cout < 2 || c % 8) return (int)cudaErrorInvalidValue;
  return os_group(cout) <= 8 ? HeadStepOs<bf16, 8>::launch(CAMELS_HEAD_STEP_OS_ARGS)
                             : HeadStepOs<bf16, 16>::launch(CAMELS_HEAD_STEP_OS_ARGS);
}
#undef CAMELS_HEAD_STEP_OS_ARGS
