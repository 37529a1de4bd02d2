// GroupNorm + affine + activation over NHWC, with an optional FiLM epilogue
// (K2).
//
// Replaces camels_diffusion_model_tpu/ops/pallas/groupnorm.py ::
// fused_groupnorm_act (Pallas TPU kernel, body _make_kernel :33-59,
// pallas_call :89), which GroupNormAct uses at up0_norm and out_norm
// (models/blocks.py:315-321).  It is held against the two-pass XLA path
// (blocks.py:322-330): fp32 statistics, mean first and then the centred
// variance, not the Pallas kernel's E[x^2] - E[x]^2 (a Mosaic workaround).
//
//   y = act((x - mean_g) * rsqrt(var_g + eps) * gamma_c + beta_c)
//   out = film ? y * scale[n, c] + shift[n, c] : y
//   act: 0 none, 1 relu, 2 erf-gelu, 3 leaky_relu(0.2)
//
// The FiLM epilogue is decoder stage 0 (context_unet.py:300,305: up0_norm,
// then cemb1 * u + temb1); scale/shift rows have stride C (one per sample)
// or 0 (one row for the batch).
//
// Bound on the H100: bytes at 3.35 TB/s, x read once and out written once
// (about ten flops per element).  Design:
//  - One (sample, group) is split over a thread-block cluster of 1-8 CTAs,
//    each taking a contiguous run of pixels, so that even 4 samples x 8
//    groups give 256 CTAs.  The launch plan (cluster size, pixels per CTA,
//    vector width) is chosen in ops/groupnorm.py::launch_plan.
//  - Each CTA reads its slice from device memory once, 16 bytes a thread,
//    into dynamic shared memory; the sum and then the centred sum of squares
//    come from that on-chip copy, and the CTAs of a cluster add their
//    partials through distributed shared memory in rank order, so every CTA
//    gets the same statistics.  Device memory sees one read and one write.
//  - A slice larger than a CTA's shared memory (the big model's out_norm,
//    (N, 128, 128, 256): 2 MiB a group, 256 KiB a CTA in a cluster of 8)
//    keeps its first resident_pixels in shared memory and spills the rest:
//    the variance and output passes read the spilled pixels again from
//    device memory (12% of that slice, so 1.23 reads of x in all).  The
//    alternative, a non-portable cluster of 16 at 128 KiB a CTA, needs 16
//    free SMs of one GPC for each group and was not taken: the plan could
//    not know before the launch whether the card schedules it.  The sums
//    are the same, in the same order, on both paths.
//  - A thread keeps the same channels for its whole slice (the block covers
//    whole pixels), so gamma, beta, scale and shift sit in registers and the
//    loops do no division.  Shapes whose channels per group are not a
//    multiple of one 16-byte access (4 floats, 8 bf16), or pointers not
//    16-byte aligned, take the scalar instance (V = 1) of the same kernel.
//
// The I/O type T is float or bf16 (the bf16 model, blocks.py:316-321 with
// dtype=bfloat16).  Whatever T, the statistics, gamma/beta and the
// activation are fp32 and y is rounded to T once, as the Pallas kernel
// does (ops/pallas/groupnorm.py:52-57); the FiLM epilogue then runs in T
// as context_unet.py:300-307 does: scale * y rounded, + shift rounded
// (rows of T).  Shared memory holds the slice as T, exact: a bf16 group is
// half the bytes, so the big model's out_norm (1 MiB a group in bf16,
// 128 KiB a CTA in a cluster of 8) stays resident; the spill path serves
// the fp32 instance.
//
// Sharded statistics (a height shard of a spatial mesh, whose GroupNorm
// statistics span every shard; XLA's SPMD partitioner inserts them in JAX):
// the kernel's MODE template argument.  MODE 0 is the single launch above.
// MODE 1 (statistics) reads the shard once into shared memory as MODE 0
// does, takes its local mean and then its local centred sum of squares
// M2, writes (count, mean, M2) of each (sample, group) in fp32, and stops.
// The host all-reduces the shards' triples into an (n_parts, n, groups, 3)
// buffer.  MODE 2 (apply) merges the n_parts triples of its (sample,
// group) in shard order by Chan's formula in its prologue:
//   n = na + nb, d = mb - ma, mean = ma + d * (nb / n),
//   M2 = M2a + M2b + d * d * (na * nb / n),
// which keeps the centred variance of MODE 0 (no E[x^2] - E[x]^2
// cancellation), then normalises, applies gamma/beta, the activation and
// the FiLM epilogue as MODE 0 does, reading x once from device memory
// (no slice in shared memory: it reads each pixel once).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "pack.cuh"

namespace cg = cooperative_groups;

namespace {

// Sum over the block (a multiple of 32 threads), returned to every thread.
__device__ float block_sum(float v, float* shared) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();  // shared may still be read from a previous call
  if (lane == 0) shared[warp] = v;
  __syncthreads();
  v = (threadIdx.x < (blockDim.x >> 5)) ? shared[threadIdx.x] : 0.0f;
  if (warp == 0) {
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) shared[0] = v;
  }
  __syncthreads();
  return shared[0];
}

// This CTA's partial plus every other CTA's of the cluster, in rank order.
__device__ float cluster_sum(cg::cluster_group& cluster, float* partial,
                             float block_total, int cluster_size) {
  if (threadIdx.x == 0) *partial = block_total;
  cluster.sync();
  float s = 0.0f;
  for (int r = 0; r < cluster_size; ++r) s += *cluster.map_shared_rank(partial, r);
  return s;
}

__device__ __forceinline__ float activate(float y, int act) {
  switch (act) {
    case 1: return fmaxf(y, 0.0f);
    case 2: return 0.5f * y * (1.0f + erff(y * 0.70710678118654752f));
    case 3: return y > 0.0f ? y : 0.2f * y;
    default: return y;
  }
}

// Grid: (sample, group) major, cluster rank minor.  Dynamic shared memory:
// resident_pixels * cg elements of T, the CTA's slice as [pixel][channel of
// group].  MODE: 0 the single launch, 1 statistics into stats (float
// triples per (sample, group)), 2 apply with the n_parts triples of
// partials.
template <typename T, int V, int MODE>
__global__ void groupnorm_act_kernel(
    const T* __restrict__ x, const float* __restrict__ gamma,
    const float* __restrict__ beta, const T* __restrict__ scale,
    const T* __restrict__ shift, T* __restrict__ out, int hw, int c,
    int groups, int cluster_size, int pixels_per_cta, int resident_pixels,
    int scale_stride, int shift_stride, float eps, int act,
    float* __restrict__ stats, const float* __restrict__ parts, int n_parts) {
  extern __shared__ float4 slice_storage[];
  __shared__ float warp_sums[32];
  __shared__ float partials[2];
  cg::cluster_group cluster = cg::this_cluster();

  const int cgroup = c / groups, vpp = cgroup / V;  // vectors per pixel
  const int ng = blockIdx.x / cluster_size;
  const int n = ng / groups, g = ng - n * groups;
  const int rank = (int)cluster.block_rank();
  const int p0 = min(hw, rank * pixels_per_cta);
  const int np = min(hw, p0 + pixels_per_cta) - p0;
  const int pstride = blockDim.x / vpp;  // pixels the block covers per step
  const int j = (threadIdx.x % vpp) * V;  // this thread's channels in the group
  // Threads past the last whole pixel of the block only join the sums.
  const int first = threadIdx.x < pstride * vpp ? threadIdx.x / vpp : np;
  const int ch = g * cgroup + j;
  const long long base = ((long long)n * hw + p0) * c + ch;
  T* mine = reinterpret_cast<T*>(slice_storage) + j;
  const T* xs = x + base;  // this thread's channels of the slice
  // Pixels [0, res) of the slice sit in shared memory, [res, np) spill;
  // spill is this thread's first pixel at or past res.
  const int res = min(np, resident_pixels);
  const int spill =
      first >= res ? first : first + (res - first + pstride - 1) / pstride * pstride;
  // Second and third passes: this thread's pixels in order, each with its
  // values, from shared memory and then (spilled) from device memory.
  auto sweep = [&](auto&& body) {
    for (int p = first; p < res; p += pstride) body(p, load<V>(mine + p * cgroup));
    for (int p = spill; p < np; p += pstride) body(p, load<V>(xs + (long long)p * c));
  };

  float mean, rstd;
  if constexpr (MODE == 2) {
    // Chan's merge of the shards' (count, mean, M2), in shard order.
    const long long ngs = (long long)gridDim.x / cluster_size;
    const float* p = parts + (long long)ng * 3;
    float cnt = p[0], m2 = p[2];
    mean = p[1];
    for (int k = 1; k < n_parts; ++k) {
      const float* q = parts + ((long long)k * ngs + ng) * 3;
      const float nb = q[0], nab = cnt + nb, delta = q[1] - mean;
      mean = mean + delta * (nb / nab);
      m2 = m2 + q[2] + delta * delta * (cnt * nb / nab);
      cnt = nab;
    }
    rstd = rsqrtf(m2 / cnt + eps);
    asm volatile("barrier.cluster.arrive.aligned;" ::: "memory");
  } else {
    float s = 0.0f;
#pragma unroll 4
    for (int p = first; p < np; p += pstride) {
      Pack<V> v = load<V>(xs + (long long)p * c);
      if (p < res) store<V>(mine + p * cgroup, v);  // only this thread reads it back
#pragma unroll
      for (int i = 0; i < V; ++i) s += v.v[i];
    }
    const float count = (float)((long long)hw * cgroup);
    mean = cluster_sum(cluster, &partials[0], block_sum(s, warp_sums), cluster_size) / count;

    float q = 0.0f;
    sweep([&](int, const Pack<V>& v) {
#pragma unroll
      for (int i = 0; i < V; ++i) {
        float d = v.v[i] - mean;
        q += d * d;
      }
    });
    const float m2 = cluster_sum(cluster, &partials[1], block_sum(q, warp_sums), cluster_size);
    rstd = rsqrtf(m2 / count + eps);
    // Done with the other CTAs' shared memory; wait for them before exiting,
    // so no CTA's partials vanish while another still reads them.
    asm volatile("barrier.cluster.arrive.aligned;" ::: "memory");
    if constexpr (MODE == 1) {
      if (rank == 0 && threadIdx.x == 0) {
        stats[(long long)ng * 3] = count;
        stats[(long long)ng * 3 + 1] = mean;
        stats[(long long)ng * 3 + 2] = m2;
      }
      asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
      return;
    }
  }

  const Pack<V> ga = load<V>(gamma + ch), be = load<V>(beta + ch);
  const bool film = scale != nullptr;
  Pack<V> sc{}, sh{};
  if (film) {
    sc = load<V>(scale + (long long)n * scale_stride + ch);
    sh = load<V>(shift + (long long)n * shift_stride + ch);
  }
  sweep([&](int p, Pack<V> v) {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      float y = activate((v.v[i] - mean) * rstd * ga.v[i] + be.v[i], act);
      v.v[i] = film ? round_to<T>(round_to<T>(round_to<T>(y) * sc.v[i]) + sh.v[i]) : y;
    }
    store<V>(out + base + (long long)p * c, v);
  });
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
}

template <typename T, int V, int MODE>
cudaError_t launch(cudaLaunchConfig_t* cfg, const T* x, const float* gamma,
                   const float* beta, const T* scale, const T* shift,
                   T* out, int hw, int c, int groups, int cluster,
                   int pixels_per_cta, int resident_pixels, int scale_stride,
                   int shift_stride, float eps, int act, float* stats,
                   const float* parts, int n_parts) {
  cudaError_t err = cudaSuccess;
  if (cfg->dynamicSmemBytes > 48 * 1024)
    err = cudaFuncSetAttribute(groupnorm_act_kernel<T, V, MODE>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)cfg->dynamicSmemBytes);
  if (err == cudaSuccess)
    err = cudaLaunchKernelEx(cfg, groupnorm_act_kernel<T, V, MODE>, x, gamma, beta, scale,
                             shift, out, hw, c, groups, cluster, pixels_per_cta,
                             resident_pixels, scale_stride, shift_stride, eps, act, stats,
                             parts, n_parts);
  cudaError_t last = cudaGetLastError();
  return err != cudaSuccess ? err : last;
}

template <typename T, int MODE>
int entry(const T* x, const float* gamma, const float* beta, const T* scale,
          const T* shift, T* out, int n, int hw, int c, int groups,
          int scale_stride, int shift_stride, float eps, int act, int vec,
          int cluster, int threads, int pixels_per_cta, int resident_pixels,
          int smem_bytes, float* stats, const float* parts, int n_parts, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(n * groups * cluster));
  cfg.blockDim = dim3((unsigned)threads);
  cfg.dynamicSmemBytes = (size_t)smem_bytes;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (vec == kVec<T>)
    return (int)launch<T, kVec<T>, MODE>(&cfg, x, gamma, beta, scale, shift, out, hw, c,
                                         groups, cluster, pixels_per_cta, resident_pixels,
                                         scale_stride, shift_stride, eps, act, stats, parts,
                                         n_parts);
  if (vec == 1)
    return (int)launch<T, 1, MODE>(&cfg, x, gamma, beta, scale, shift, out, hw, c, groups,
                                   cluster, pixels_per_cta, resident_pixels, scale_stride,
                                   shift_stride, eps, act, stats, parts, n_parts);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// x/out: (n, hw, c) contiguous NHWC of float (camels_groupnorm_act) or bf16
// (camels_groupnorm_act_bf16); gamma/beta: (c,) float; scale/shift: null,
// or rows of c elements of x's type with strides 0 or c.  vec, cluster,
// threads, pixels_per_cta, resident_pixels and smem_bytes come from
// ops/groupnorm.py::launch_plan (vec 4 for float, 8 for bf16, needs
// c/groups % vec == 0 and 16-byte aligned pointers).  Returns the
// cudaError_t of the launch.
#define CAMELS_GROUPNORM_ENTRY(NAME, T)                                              \
  extern "C" int NAME(const T* x, const float* gamma, const float* beta,            \
                      const T* scale, const T* shift, T* out, int n, int hw, int c, \
                      int groups, int scale_stride, int shift_stride, float eps,    \
                      int act, int vec, int cluster, int threads,                   \
                      int pixels_per_cta, int resident_pixels, int smem_bytes,      \
                      void* stream) {                                               \
    return entry<T, 0>(x, gamma, beta, scale, shift, out, n, hw, c, groups,         \
                       scale_stride, shift_stride, eps, act, vec, cluster, threads, \
                       pixels_per_cta, resident_pixels, smem_bytes, nullptr,        \
                       nullptr, 0, stream);                                         \
  }
CAMELS_GROUPNORM_ENTRY(camels_groupnorm_act, float)
CAMELS_GROUPNORM_ENTRY(camels_groupnorm_act_bf16, bf16)
#undef CAMELS_GROUPNORM_ENTRY

// The sharded mode.  Statistics: the arguments above (gamma, beta, the rows
// and out unused, null) and stats, (n, groups, 3) float: count, mean, M2.
// Apply: the arguments above with resident_pixels and smem_bytes 0, then
// parts, (n_parts, n, groups, 3) float in shard order, and n_parts.
#define CAMELS_GROUPNORM_SHARDED_ENTRIES(STATS, APPLY, T)                            \
  extern "C" int STATS(const T* x, const float* gamma, const float* beta,           \
                       const T* scale, const T* shift, T* out, int n, int hw,       \
                       int c, int groups, int scale_stride, int shift_stride,       \
                       float eps, int act, int vec, int cluster, int threads,       \
                       int pixels_per_cta, int resident_pixels, int smem_bytes,     \
                       float* stats, void* stream) {                                \
    return entry<T, 1>(x, gamma, beta, scale, shift, out, n, hw, c, groups,         \
                       scale_stride, shift_stride, eps, act, vec, cluster, threads, \
                       pixels_per_cta, resident_pixels, smem_bytes, stats, nullptr, \
                       0, stream);                                                  \
  }                                                                                 \
  extern "C" int APPLY(const T* x, const float* gamma, const float* beta,           \
                       const T* scale, const T* shift, T* out, int n, int hw,       \
                       int c, int groups, int scale_stride, int shift_stride,       \
                       float eps, int act, int vec, int cluster, int threads,       \
                       int pixels_per_cta, int resident_pixels, int smem_bytes,     \
                       const float* parts, int n_parts, void* stream) {             \
    return entry<T, 2>(x, gamma, beta, scale, shift, out, n, hw, c, groups,         \
                       scale_stride, shift_stride, eps, act, vec, cluster, threads, \
                       pixels_per_cta, resident_pixels, smem_bytes, nullptr, parts, \
                       n_parts, stream);                                            \
  }
CAMELS_GROUPNORM_SHARDED_ENTRIES(camels_groupnorm_stats, camels_groupnorm_apply, float)
CAMELS_GROUPNORM_SHARDED_ENTRIES(camels_groupnorm_stats_bf16, camels_groupnorm_apply_bf16,
                                 bf16)
#undef CAMELS_GROUPNORM_SHARDED_ENTRIES
