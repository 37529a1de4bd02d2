// K2's sharded launches (ops/groupnorm.py::groupnorm_stats, groupnorm_apply,
// and the pair on one card where the single launches refuse a shape).
// With groupnorm.cu's single launches they replace
// camels_diffusion_model_tpu/ops/pallas/groupnorm.py :: fused_groupnorm_act
// (Pallas TPU kernel, pallas_call :89) on a height shard of a spatial mesh,
// whose statistics span every shard.  Bound: bytes.  A source of their own,
// so that the build compiles them beside groupnorm.cu.

#include <algorithm>

#include "groupnorm.cuh"

namespace {

// ---- The sharded launches: statistics, then apply. ----
//
// Statistics (groupnorm_stats_kernel).  Bound: bytes, the shard read once.
// A unit is a (sample, segment): seg consecutive groups of one sample, the
// fewest whose slice of a pixel is 64 bytes where the groups allow (the
// out_norm's 16 channels a group: one group in fp32, two in bf16).  Its
// pixels split over a cluster of `cluster` CTAs, a part of part_px each,
// and the cluster is 1 (no barrier at all) wherever the units alone give
// every SM a CTA (ops/groupnorm.py::stats_plan).  A thread keeps one pack
// of the segment (one group's channels) and streams its pixels STATS_LOADS
// packs at a time, all requested before any is used, straight into
// registers: the statistics need one read, so no copy of the slice goes
// to shared memory (two rounds in flight, the next requested before this
// one merges, ran slower: 100 registers against 71, fewer CTAs an SM).
// Each pack's centred moments (count, mean, M2) merge into the thread's by
// Chan's formula as it lands; then the lanes of one group (a butterfly),
// the block's warps in order and the cluster's CTAs in rank order, as
// groupnorm_bf16_kernel does.  Rank 0 writes the unit's triples.
//
// Apply (groupnorm_apply_kernel).  Bound: bytes, the shard read once and
// its output written once.  A streaming pass: no cluster and no barrier.
// A CTA takes part_px whole pixels (all c channels) of one sample, so its
// loads and stores are 16-byte packs running contiguously along the rows;
// a thread keeps the same pack of every pixel, so its prologue merges, in
// shard order by Chan's formula, the n_parts triples of the one group its
// channels belong to (the formula and order of ops/groupnorm.py::
// merge_stats), and gamma, beta and the FiLM rows then sit in registers.
// The first APPLY_LOADS packs are requested before the prologue, so its
// reads of the partials pass under them.  The activation (ACT, as
// activate's act) and the FiLM epilogue (FILM) are template arguments, as
// in groupnorm_bf16_kernel: a runtime choice costs a launch that follows a
// conv its cold instruction fetch.  y rounds to T once, then the epilogue
// rounds scale * y and + shift in T, as the single launches do.
//
// Packs that straddle groups (STRADDLE; a pixel's channels whole packs and
// the pointers aligned, a group's channels not: n_feat 1032's up0_norm, 258
// channels a group, n_feat 136's 17 and 34, 264's 33 and 66).  Both
// launches read 16-byte packs and the apply launch writes them.  The
// statistics keep one group a unit: its threads take the packs that
// overlap the group (the first and last of them shared with the
// neighbouring groups' units, whose CTAs run beside it, so those packs'
// second reads meet in L2), each lane masking the channels outside its
// group, so a lane's moments are still its unit's one group and the warp,
// block and cluster merges are those of seg 1.  In the apply launch a
// thread's pack spans at most two groups (groups at least a pack wide);
// its prologue merges both groups' triples and finds the pack's split
// point once, as it keeps the same pack of every pixel, and each element
// takes its own group's (mean, rstd); gamma, beta and FiLM stay per
// channel.
//
// Both take V = 1 (a thread one channel) where a pixel's channels are not
// whole 16-byte packs, a pointer is unaligned, or a group is narrower than
// a pack (n_feat 40's 5 channels in bf16).  Where whole
// warps of whole pixels would exceed the launch bound (a statistics unit
// of one group of 17 or 33 elements, an apply pixel of 264), the block is
// whole warps and the lanes past its last whole pixel idle
// (ops/groupnorm.py::idle_lane_threads): in the statistics they hold
// empty moments (the unit is one group, so every lane's merge is the
// group's), in the apply they return at once.  Where one pixel's accesses
// outnumber the block (MULTI: a statistics group of over 512 of them, an
// apply pixel of over 1024 elements or 512 packs, as n_feat 1032's
// up0_norm: 2064 channels), a thread takes accesses t, t + blockDim.x, ...
// of each pixel of its part, one access at a time over the part's pixels:
// the statistics merge each into the thread's moments by Chan's formula
// before the warp and block merges (the unit is one group), the apply
// merges each access's group's triples and reads its gamma, beta and FiLM
// values anew.  The pair then takes every width on one card as well
// (ops/groupnorm.py::single_route: where the single launches refuse).

constexpr int STATS_LOADS = 8;  // packs a thread requests at once
constexpr int STATS_THREADS = 512;  // a CTA at most
constexpr int APPLY_LOADS = 4;

// The packs of a pixel that overlap group g of cgroup channels (STRADDLE):
// the first, and how many.
__device__ __forceinline__ int first_pack(int g, int cgroup, int v) { return g * cgroup / v; }
__device__ __forceinline__ int packs_of(int g, int cgroup, int v) {
  return ((g + 1) * cgroup - 1) / v - first_pack(g, cgroup, v) + 1;
}

// Grid: unit (sample major, segment minor) major, cluster rank minor.
// Thread t < pstride * vs holds pack t % vs (vs = the segment's packs a
// pixel; the block a multiple of it but where IDLE, seg 1) of pixels t /
// vs, + pstride, ... of its part; with MULTI (seg 1, vs over the block)
// packs t, t + blockDim.x, ... of every pixel of its part.  IDLE is a
// template argument so that the plans of whole pixels compile as they did
// without idle lanes (their launch read 5% slower with the test,
// scripts/compare_torch_kernels.py --sharded); MULTI likewise.  STRADDLE
// (seg 1; a group's channels not whole packs): vs is the most packs that
// overlap a group (ops/groupnorm.py::straddle_packs), pack t % vs of the
// unit is the group's first_pack + t % vs, its channels outside the group
// masked, and the threads past the group's packs_of hold empty moments.
template <typename T, int V, bool IDLE, bool MULTI, bool STRADDLE>
__global__ void __launch_bounds__(STATS_THREADS) groupnorm_stats_kernel(
    const T* __restrict__ x, float* __restrict__ stats, int hw, int c, int groups, int seg,
    int cluster_size, int part_px) {
  __shared__ Moments warp_moments[STATS_THREADS / 32][MAX_SEG];
  __shared__ Moments block_moments[MAX_SEG];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cgroup = c / groups;
  int vpg = cgroup / V;  // a group's packs (STRADDLE: the most that overlap one)
  if constexpr (STRADDLE) {
    vpg = 0;
    for (int g = 0; g < groups; ++g) vpg = max(vpg, packs_of(g, cgroup, V));
  }
  const int vs = vpg * seg;
  const int segs = groups / seg;
  const int unit = blockIdx.x / cluster_size, rank = blockIdx.x - unit * cluster_size;
  const int nn = unit / segs, sg = unit - nn * segs;
  const int p0 = min(hw, rank * part_px);
  const int np = min(hw, p0 + part_px) - p0;
  const int pstride = blockDim.x / vs;  // pixels the block covers per step
  const int j = tid % vs, gl = j / vpg;  // this thread's pack and group in the segment
  const int chan0 = STRADDLE ? first_pack(sg, cgroup, V) * V : sg * seg * cgroup;
  const T* xs = x + ((long long)nn * hw + p0) * c + chan0 + j * V;

  Moments m{0.0f, 0.0f, 0.0f};
  // Pixels p, p + stride, ... (STATS_LOADS of them requested at once) of
  // the pack at src, merged into m; STRADDLE: its elements e_lo .. e_hi - 1
  // (the group's), count k = e_hi - e_lo.
  auto stream = [&](const T* src, int p, int stride, int e_lo, int e_hi) {
    const float k = (float)(e_hi - e_lo), inv_k = 1.0f / k;
    for (; p < np; p += STATS_LOADS * stride) {
      Raw<T, V> raw[STATS_LOADS];
#pragma unroll
      for (int i = 0; i < STATS_LOADS; ++i)
        if (p + i * stride < np) raw[i] = load_raw<T, V>(src + (long long)(p + i * stride) * c);
#pragma unroll
      for (int i = 0; i < STATS_LOADS; ++i) {
        if (p + i * stride < np) {
          const Pack<V> v = unpack<T, V>(raw[i]);
          if constexpr (STRADDLE) {
            float sum = 0.0f;
#pragma unroll
            for (int e = 0; e < V; ++e) sum += e >= e_lo && e < e_hi ? v.v[e] : 0.0f;
            const float pm = sum * inv_k;
            float pq = 0.0f;
#pragma unroll
            for (int e = 0; e < V; ++e) {
              const float d = e >= e_lo && e < e_hi ? v.v[e] - pm : 0.0f;
              pq += d * d;
            }
            m = merge(m, Moments{k, pm, pq});
          } else {
            float sum = 0.0f;
#pragma unroll
            for (int e = 0; e < V; ++e) sum += v.v[e];
            const float pm = sum * (1.0f / V);
            float pq = 0.0f;
#pragma unroll
            for (int e = 0; e < V; ++e) {
              const float d = v.v[e] - pm;
              pq += d * d;
            }
            m = merge(m, Moments{(float)V, pm, pq});
          }
        }
      }
    }
  };
  // Pack jj of the unit's elements inside its group (STRADDLE; past the
  // group's packs, none): [lo, hi).
  auto span = [&](int jj, int& lo, int& hi) {
    lo = 0;
    hi = V;
    if constexpr (STRADDLE) {
      const int ch = chan0 + jj * V;
      lo = max(0, sg * cgroup - ch);
      hi = jj < packs_of(sg, cgroup, V) ? min(V, (sg + 1) * cgroup - ch) : lo;
    }
  };
  if constexpr (MULTI) {  // seg 1: every pack is the one group's
    for (int jj = tid; jj < vs; jj += blockDim.x) {
      int lo, hi;
      span(jj, lo, hi);
      if (hi > lo) stream(xs + (jj - j) * V, 0, 1, lo, hi);
    }
  } else {
    int lo, hi;
    span(j, lo, hi);
    stream(xs, (!IDLE || tid < pstride * vs) && hi > lo ? tid / vs : np, pstride, lo, hi);
  }
  // The lanes of one group, as in groupnorm_bf16_kernel: the butterfly
  // skips the lane bits that change the group (vpg and vs powers of two
  // where seg > 1; with seg 1 every lane holds the one group).
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    if (off >= vpg && off < vs) continue;
    const Moments o{__shfl_xor_sync(0xffffffffu, m.n, off),
                    __shfl_xor_sync(0xffffffffu, m.mean, off),
                    __shfl_xor_sync(0xffffffffu, m.m2, off)};
    m = (lane & off) ? merge(o, m) : merge(m, o);
  }
  // A warp holds every group of the segment where vs <= 32, else 32 / vpg
  // of them; the others stay empty.
  if (lane < seg) warp_moments[warp][lane] = Moments{0.0f, 0.0f, 0.0f};
  __syncwarp();
  if (lane % vpg == 0 && lane < vs) warp_moments[warp][gl] = m;
  __syncthreads();
  const float count = (float)((long long)hw * cgroup);
  float* out = stats + ((long long)nn * groups + sg * seg) * 3;
  Moments b{0.0f, 0.0f, 0.0f};
  if (tid < seg) {
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) b = merge(b, warp_moments[w][tid]);
    block_moments[tid] = b;
  }
  if (cluster_size == 1) {
    if (tid < seg) {
      out[3 * tid] = count;
      out[3 * tid + 1] = b.mean;
      out[3 * tid + 2] = b.m2;
    }
    return;
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every CTA's block_moments is written
  if (rank == 0 && tid < seg) {
    for (int r = 1; r < cluster_size; ++r)
      b = merge(b, *cluster.map_shared_rank(&block_moments[tid], r));
    out[3 * tid] = count;
    out[3 * tid + 1] = b.mean;
    out[3 * tid + 2] = b.m2;
  }
  // Rank 0 is done with the others' shared memory: no CTA leaves before.
  asm volatile("barrier.cluster.arrive.aligned;" ::: "memory");
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
}

template <typename T>
struct ApplyArgs {
  const T* x;
  const float* parts;  // (n_parts, n, groups, 3): count, mean, M2 of each shard
  const float* gamma;
  const float* beta;
  const T* scale;  // FiLM rows, strides scale_stride and shift_stride (0 or c)
  const T* shift;
  T* out;
  int n_parts, n, hw, c, groups, part_px, scale_stride, shift_stride;
  float eps;
};

// Grid: sample major, part minor.  Thread t < pstride * (c / V) holds
// pack t % (c / V) of pixels t / (c / V), + pstride, ... of its part; with
// MULTI (c / V over the block) packs t, t + blockDim.x, ... of every pixel
// of its part.  STRADDLE: a pack's elements before its split point are
// one group's, those from it the next group's.
template <typename T, int V, int ACT, bool FILM, bool MULTI, bool STRADDLE>
__global__ void __launch_bounds__(V == 1 ? 1024 : 512)
    groupnorm_apply_kernel(const ApplyArgs<T> a) {
  const int tid = threadIdx.x;
  const int vpp = a.c / V;  // packs a pixel
  const int ctas = (a.hw + a.part_px - 1) / a.part_px;  // a sample's
  const int nn = blockIdx.x / ctas;
  const int p0 = (blockIdx.x - nn * ctas) * a.part_px;
  const int np = min(a.hw, p0 + a.part_px) - p0;

  // Pack j of pixels first, first + pstride, ... of the part.
  auto run = [&](int j, int first, int pstride) {
    const int cgroup = a.c / a.groups;
    const int ch = j * V, g = ch / cgroup;
    const T* xs = a.x + ((long long)nn * a.hw + p0) * a.c + ch;
    T* os = a.out + ((long long)nn * a.hw + p0) * a.c + ch;

    Raw<T, V> raw[APPLY_LOADS];
    auto fetch = [&](int p) {
#pragma unroll
      for (int i = 0; i < APPLY_LOADS; ++i)
        if (p + i * pstride < np)
          raw[i] = load_raw<T, V>(xs + (long long)(p + i * pstride) * a.c);
    };
    fetch(first);

    // Chan's merge of the shards' (count, mean, M2) of (sample, group gg),
    // in shard order: its mean and rstd.
    const long long ngs = (long long)a.n * a.groups;
    auto merged = [&](int gg, float& mean, float& rstd) {
      const long long ng = (long long)nn * a.groups + gg;
      float cnt = a.parts[ng * 3], m2 = a.parts[ng * 3 + 2];
      mean = a.parts[ng * 3 + 1];
      for (int k = 1; k < a.n_parts; ++k) {
        const float* q = a.parts + (k * ngs + ng) * 3;
        const float nb = q[0], nab = cnt + nb, delta = q[1] - mean;
        mean = mean + delta * (nb / nab);
        m2 = m2 + q[2] + delta * delta * (cnt * nb / nab);
        cnt = nab;
      }
      rstd = rsqrtf(m2 / cnt + a.eps);
    };
    float mean, rstd;
    merged(g, mean, rstd);
    // STRADDLE: the elements from split on are group g + 1's.
    int split = V;
    float mean1 = mean, rstd1 = rstd;
    if constexpr (STRADDLE) {
      split = (g + 1) * cgroup - ch;
      if (split < V) merged(g + 1, mean1, rstd1);
    }
    const Pack<V> ga = load<V>(a.gamma + ch), be = load<V>(a.beta + ch);
    Pack<V> sc{}, sh{};
    if constexpr (FILM) {
      sc = load<V>(a.scale + (long long)nn * a.scale_stride + ch);
      sh = load<V>(a.shift + (long long)nn * a.shift_stride + ch);
    }

    for (int p = first; p < np; p += APPLY_LOADS * pstride) {
      if (p != first) fetch(p);
#pragma unroll
      for (int i = 0; i < APPLY_LOADS; ++i) {
        const int q = p + i * pstride;
        if (q < np) {
          Pack<V> v = unpack<T, V>(raw[i]);
#pragma unroll
          for (int e = 0; e < V; ++e) {
            const float me = STRADDLE && e >= split ? mean1 : mean;
            const float re = STRADDLE && e >= split ? rstd1 : rstd;
            const float y = activate((v.v[e] - me) * re * ga.v[e] + be.v[e], ACT);
            if constexpr (FILM)
              v.v[e] = round_to<T>(round_to<T>(round_to<T>(y) * sc.v[e]) + sh.v[e]);
            else
              v.v[e] = y;
          }
          store<V>(os + (long long)q * a.c, v);
        }
      }
    }
  };
  if constexpr (MULTI) {
    for (int j = tid; j < vpp; j += blockDim.x) run(j, 0, 1);
  } else {
    const int pstride = blockDim.x / vpp;  // pixels the block covers per step
    if (tid >= pstride * vpp) return;  // an idle lane past the last whole pixel
    run(tid % vpp, tid / vpp, pstride);
  }
}

template <typename T, int V, bool STRADDLE>
cudaError_t apply_launch(dim3 grid, int threads, cudaStream_t stream, const ApplyArgs<T>& a,
                         int act) {
  const bool multi = threads < a.c / V;  // a thread takes several packs of a pixel
#define CAMELS_GROUPNORM_APPLY(A)                                                         \
  if (act == A) {                                                                         \
    if (multi && a.scale)                                                                 \
      groupnorm_apply_kernel<T, V, A, true, true, STRADDLE><<<grid, threads, 0, stream>>>(a);  \
    else if (multi)                                                                       \
      groupnorm_apply_kernel<T, V, A, false, true, STRADDLE><<<grid, threads, 0, stream>>>(a); \
    else if (a.scale)                                                                     \
      groupnorm_apply_kernel<T, V, A, true, false, STRADDLE><<<grid, threads, 0, stream>>>(a); \
    else                                                                                  \
      groupnorm_apply_kernel<T, V, A, false, false, STRADDLE><<<grid, threads, 0, stream>>>(a);\
    return cudaGetLastError();                                                            \
  }
  CAMELS_GROUPNORM_APPLY(0)
  CAMELS_GROUPNORM_APPLY(1)
  CAMELS_GROUPNORM_APPLY(2)
  CAMELS_GROUPNORM_APPLY(3)
#undef CAMELS_GROUPNORM_APPLY
  return cudaErrorInvalidValue;
}

template <typename T, int V, bool STRADDLE>
cudaError_t stats_launch(const cudaLaunchConfig_t* cfg, bool idle, bool multi, const T* x,
                         float* stats, int hw, int c, int groups, int seg, int cluster,
                         int part_px) {
  return multi ? cudaLaunchKernelEx(cfg, groupnorm_stats_kernel<T, V, false, true, STRADDLE>,
                                    x, stats, hw, c, groups, seg, cluster, part_px)
         : idle ? cudaLaunchKernelEx(cfg, groupnorm_stats_kernel<T, V, true, false, STRADDLE>,
                                     x, stats, hw, c, groups, seg, cluster, part_px)
                : cudaLaunchKernelEx(cfg, groupnorm_stats_kernel<T, V, false, false, STRADDLE>,
                                     x, stats, hw, c, groups, seg, cluster, part_px);
}

// The most 16-byte packs of kVec<T> elements that overlap one of the groups
// of cgroup channels (host side of the kernel's packs_of).
inline int straddle_packs(int groups, int cgroup, int v) {
  int most = 0;
  for (int g = 0; g < groups; ++g)
    most = std::max(most, ((g + 1) * cgroup - 1) / v - g * cgroup / v + 1);
  return most;
}

template <typename T>
int stats_entry(const T* x, float* stats, int n, int hw, int c, int groups, int vec, int seg,
                int cluster, int threads, int part_px, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if ((vec != 1 && vec != kVec<T>) || groups <= 0 || c % groups || c % vec ||
      c / groups < vec)
    return (int)cudaErrorInvalidValue;
  // Packs that straddle groups: seg 1, vs the most packs that overlap a group.
  const bool straddle = c / groups % vec != 0;
  if (straddle && seg != 1) return (int)cudaErrorInvalidValue;
  const int vpg = straddle ? straddle_packs(groups, c / groups, vec) : c / groups / vec;
  const int vs = vpg * seg;
  const bool multi = threads < vs;  // seg 1: a thread takes several packs of a pixel
  if (seg < 1 || seg > MAX_SEG || groups % seg || (seg > 1 && (vs & (vs - 1))) ||
      threads <= 0 || threads > STATS_THREADS || threads % 32 || (multi && seg > 1) ||
      (seg > 1 && threads % vs) || cluster < 1 || cluster > 8 || part_px < 1)
    return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(n * (groups / seg) * cluster));
  cfg.blockDim = dim3((unsigned)threads);
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;  // a cluster of 1 is launched as a plain grid
  const bool idle = !multi && threads % vs != 0;  // lanes past the last whole pixel
  cudaError_t err =
      vec == 1 ? stats_launch<T, 1, false>(&cfg, idle, multi, x, stats, hw, c, groups, seg,
                                           cluster, part_px)
      : straddle ? stats_launch<T, kVec<T>, true>(&cfg, idle, multi, x, stats, hw, c, groups,
                                                  seg, cluster, part_px)
                 : stats_launch<T, kVec<T>, false>(&cfg, idle, multi, x, stats, hw, c, groups,
                                                   seg, cluster, part_px);
  cudaError_t last = cudaGetLastError();
  return (int)(err != cudaSuccess ? err : last);
}

template <typename T>
int apply_entry(const T* x, const float* parts, const float* gamma, const float* beta,
                const T* scale, const T* shift, T* out, int n_parts, int n, int hw, int c,
                int groups, int scale_stride, int shift_stride, float eps, int act, int vec,
                int threads, int part_px, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if ((vec != 1 && vec != kVec<T>) || groups <= 0 || c % groups || c % vec ||
      c / groups < vec || n_parts < 1 || part_px < 1 || threads <= 0 || threads % 32 ||
      threads > (vec == 1 ? 1024 : 512))
    return (int)cudaErrorInvalidValue;
  const bool straddle = c / groups % vec != 0;  // a pack may span two groups
  const ApplyArgs<T> a{x,  parts, gamma,  beta,    scale,        shift,        out, n_parts,
                       n,  hw,    c,      groups,  part_px,      scale_stride, shift_stride,
                       eps};
  const dim3 grid((unsigned)(n * ((hw + part_px - 1) / part_px)));
  const cudaStream_t st = (cudaStream_t)stream;
  return (int)(vec == 1   ? apply_launch<T, 1, false>(grid, threads, st, a, act)
               : straddle ? apply_launch<T, kVec<T>, true>(grid, threads, st, a, act)
                          : apply_launch<T, kVec<T>, false>(grid, threads, st, a, act));
}

}  // namespace

// The sharded launches.  Statistics: x (n, hw, c) contiguous NHWC of T;
// stats (n, groups, 3) float: each (sample, group)'s count, mean and
// centred M2; vec, seg, cluster, threads and part_px from
// ops/groupnorm.py::stats_plan.  Apply: x and out as the single launch's,
// parts (n_parts, n, groups, 3) float in shard order, gamma/beta and the
// rows as camels_groupnorm_act's (groupnorm.cu), act as activate's; vec, threads and part_px from
// ops/groupnorm.py::apply_plan.  Each returns the cudaError_t of its
// launch.
#define CAMELS_GROUPNORM_SHARDED_ENTRIES(STATS, APPLY, T)                                  \
  extern "C" int STATS(const T* x, float* stats, int n, int hw, int c, int groups,        \
                       int vec, int seg, int cluster, int threads, int part_px,           \
                       void* stream) {                                                    \
    return stats_entry<T>(x, stats, n, hw, c, groups, vec, seg, cluster, threads,         \
                          part_px, stream);                                               \
  }                                                                                       \
  extern "C" int APPLY(const T* x, const float* parts, const float* gamma,                \
                       const float* beta, const T* scale, const T* shift, T* out,         \
                       int n_parts, int n, int hw, int c, int groups, int scale_stride,   \
                       int shift_stride, float eps, int act, int vec, int threads,        \
                       int part_px, void* stream) {                                       \
    return apply_entry<T>(x, parts, gamma, beta, scale, shift, out, n_parts, n, hw, c,    \
                          groups, scale_stride, shift_stride, eps, act, vec, threads,     \
                          part_px, stream);                                               \
  }
CAMELS_GROUPNORM_SHARDED_ENTRIES(camels_groupnorm_stats, camels_groupnorm_apply, float)
CAMELS_GROUPNORM_SHARDED_ENTRIES(camels_groupnorm_stats_bf16, camels_groupnorm_apply_bf16,
                                 bf16)
#undef CAMELS_GROUPNORM_SHARDED_ENTRIES
