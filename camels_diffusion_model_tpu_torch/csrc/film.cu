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
// (ops/film.py::launch_plan).  Rows whose channels are not a multiple of
// one 16-byte access (4 floats, 8 bf16), or pointers not 16-byte aligned,
// take the scalar instance (V = 1).
//
// A pixel of over 1024 accesses (c over 4096 fp32 or 8192 bf16 channels;
// MULTI): a thread takes accesses t, t + blockDim.x, ... of each pixel, its
// scale and shift values loaded once for each, and the block walks pixels
// one at a time, so every width a sample of under 2^31 elements takes a
// kernel.
//
// The element type T is float or bf16.  The bf16 instance (the bf16 model,
// where scale and shift are cast to x's type as the Pallas kernel casts
// them, film.py:50) rounds as the JAX program does: scale * x to bf16, then
// + shift to bf16; 16-byte accesses of 8 values.

#include <cuda_runtime.h>

#include "pack.cuh"

namespace {

template <typename T, int V, bool MULTI>
__global__ void film_kernel(const T* __restrict__ x,
                            const T* __restrict__ scale,
                            const T* __restrict__ shift,
                            T* __restrict__ out, int hw, int c,
                            int scale_stride, int shift_stride) {
  const int vpp = c / V;                 // vectors per pixel
  const int n = blockIdx.y;
  if constexpr (MULTI) {
    for (int j = threadIdx.x * V; j < c; j += blockDim.x * V) {
      const Pack<V> s = load<V>(scale + (long long)n * scale_stride + j);
      const Pack<V> h = load<V>(shift + (long long)n * shift_stride + j);
      const T* xs = x + (long long)n * hw * c + j;
      T* os = out + (long long)n * hw * c + j;
#pragma unroll 4
      for (int p = blockIdx.x; p < hw; p += gridDim.x) {
        Pack<V> v = load<V>(xs + p * c);
#pragma unroll
        for (int i = 0; i < V; ++i) v.v[i] = round_to<T>(round_to<T>(v.v[i] * s.v[i]) + h.v[i]);
        store<V>(os + p * c, v);
      }
    }
    return;
  }
  const int pstride = blockDim.x / vpp;  // pixels the block covers per step
  if ((int)threadIdx.x >= pstride * vpp) return;
  const int j = (threadIdx.x % vpp) * V;
  const Pack<V> s = load<V>(scale + (long long)n * scale_stride + j);
  const Pack<V> h = load<V>(shift + (long long)n * shift_stride + j);
  const T* xs = x + (long long)n * hw * c + j;
  T* os = out + (long long)n * hw * c + j;
#pragma unroll 4
  for (int p = blockIdx.x * pstride + threadIdx.x / vpp; p < hw;
       p += gridDim.x * pstride) {
    Pack<V> v = load<V>(xs + p * c);
#pragma unroll
    for (int i = 0; i < V; ++i) v.v[i] = round_to<T>(round_to<T>(v.v[i] * s.v[i]) + h.v[i]);
    store<V>(os + p * c, v);
  }
}

template <typename T, int V>
void film_launch(dim3 grid, int threads, cudaStream_t s, const T* x, const T* scale,
                 const T* shift, T* out, int hw, int c, int scale_stride, int shift_stride) {
  if (threads < c / V)  // several accesses of a pixel a thread
    film_kernel<T, V, true><<<grid, threads, 0, s>>>(x, scale, shift, out, hw, c, scale_stride,
                                                     shift_stride);
  else
    film_kernel<T, V, false><<<grid, threads, 0, s>>>(x, scale, shift, out, hw, c,
                                                      scale_stride, shift_stride);
}

template <typename T>
int entry(const T* x, const T* scale, const T* shift, T* out, int n, int hw, int c,
          int scale_stride, int shift_stride, int vec, int threads,
          int blocks_per_sample, void* stream) {
  if (n <= 0 || hw <= 0) return (int)cudaSuccess;
  dim3 grid((unsigned)blocks_per_sample, (unsigned)n);
  cudaStream_t s = (cudaStream_t)stream;
  if (threads <= 0 || threads > 1024) return (int)cudaErrorInvalidValue;
  if (vec == kVec<T>)
    film_launch<T, kVec<T>>(grid, threads, s, x, scale, shift, out, hw, c, scale_stride,
                            shift_stride);
  else if (vec == 1)
    film_launch<T, 1>(grid, threads, s, x, scale, shift, out, hw, c, scale_stride,
                      shift_stride);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // namespace

// x/out: (n, hw, c) contiguous NHWC of float (camels_film) or bf16
// (camels_film_bf16), hw * c < 2^31 and n <= 65535; scale/shift rows of c
// elements of x's type with the given strides (0 or c).  vec, threads and
// blocks_per_sample come from ops/film.py::launch_plan, which also checks
// those limits (vec 4 for float, 8 for bf16, needs c % vec == 0 and
// 16-byte aligned pointers).  Returns the cudaError_t of the launch.
#define CAMELS_FILM_ENTRY(NAME, T)                                                   \
  extern "C" int NAME(const T* x, const T* scale, const T* shift, T* out, int n,    \
                      int hw, int c, int scale_stride, int shift_stride, int vec,   \
                      int threads, int blocks_per_sample, void* stream) {           \
    return entry<T>(x, scale, shift, out, n, hw, c, scale_stride, shift_stride, vec, \
                    threads, blocks_per_sample, stream);                             \
  }
CAMELS_FILM_ENTRY(camels_film, float)
CAMELS_FILM_ENTRY(camels_film_bf16, bf16)
#undef CAMELS_FILM_ENTRY
