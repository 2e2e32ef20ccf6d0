// GroupNorm(+SiLU) on channels-last feature maps, hand-written for Hopper
// (sm_90a).
//
//   K5 md_group_norm  replaces mikudance_tpu/kernels/group_norm.py
//      _stats_kernel (:51) + _apply_kernel (:61) and the glue between them.
//      x is (N, rows, C) with rows = H * W, bf16 or fp32; per image and group
//      the mean and the variance max(E[x^2] - mean^2, 0) over rows x (C / G)
//      values, from per-channel fp32 sums in runs of at most 256 values an
//      accumulator, folded over channels and rows in double in a fixed order;
//      y = x * a + b with a = w * rsqrt(var + eps), b = bias - mean * a,
//      optionally y * sigmoid(y), all in fp32 before the one cast to x's type.
//      No atomics: two runs give the same bits.
//
// What bounds it on the card: memory. The least it can move is one read of
// x and one write of y; a design that reads x twice pays 1.5x that. The
// wrapper (kernels/group_norm.py::group_norm_plan) picks one of two variants
// a call, by bytes.
//
// R, resident: a slab is a run of channels that is a multiple of both the
// group width and the 16-byte vector, so it holds whole groups (at most 8)
// and whole vectors; the wrapper takes the smallest such run that is also a
// whole number of 32-byte sectors a row where that fits (80 channels at 320,
// 640 and 1280 in 32 groups, 120 at 960, 80 at 2560, 16 at 128): slabs of 80
// bytes a row, which split sectors between two clusters, moved 1.2-1.4x
// fewer bytes a second on an H100. Where one image's slab fits the shared
// memory of a thread-block cluster (1-16 blocks), a cluster takes one
// (image, slab) and its blocks split the rows: each loads its rows x slab
// into shared memory once by 16-byte cp.async in four runs, sums each run
// per channel as it lands, folds the channels into its groups' partial sums,
// and after one cluster barrier every block folds all ranks' partials
// through distributed shared memory in rank order. Then it writes y from
// shared memory. x is read once, y written once, no scratch in device
// memory, one launch; clusters are independent, so nothing waits across the
// grid. Tiles are sized for four blocks an SM, else two, else one, so that
// one block's loads overlap another's stores.
//
// S, streamed, where a slab does not fit (the VAEs' maps from 768^2 up, the
// temporal decoder's joint norm): x is read twice, in two launches. The
// statistics kernel cuts each image's rows into splits (about four blocks
// an SM in all) and writes per (image, split, group) sums in double; the
// apply kernel folds them in split order in its prologue (no third launch,
// no buffer of a and b), then walks the image's 16-byte vectors, eight a
// thread in flight, with a and b read from shared memory as vectors.
//
// Every kernel here runs 256 threads a block with registers capped for four
// blocks an SM, so that as many R blocks as their tiles allow share an SM
// and S keeps enough 16-byte loads in flight.

#include <cooperative_groups.h>

#include "norm_core.cuh"

namespace cg = cooperative_groups;
using namespace md_norm;

namespace {

constexpr int kResidentThreads = 256;
constexpr int kStreamThreads = 256;
constexpr int kBlocksPerSM = 4;       // registers a thread capped at 64 for this many blocks
constexpr int kMaxSlabGroups = 8;     // a slab holds V / gcd(group width, V) <= 8 groups
constexpr int kMaxSlabVectors = 256;  // a slab row's 16-byte vectors at most
constexpr int kRun = 256;             // fp32 adds into one accumulator before a fold to double
constexpr int kInFlight = 8;          // 16-byte vectors a thread of S has in flight
constexpr int kChunks = 4;            // runs of rows an R block loads as separate groups
constexpr int kMaxSmem = 232448;      // 227 KB, a block's most on sm_90

// A resident block's shared memory: its partial sums, the warps' partials,
// the cluster's totals (doubles), a and b for the slab, then its tile.
__host__ __device__ constexpr size_t resident_head(int slab) {
  return sizeof(double) * (2 * kMaxSlabGroups * (2 + kResidentThreads / 32)) +
         sizeof(float) * 2 * (size_t)slab;
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

template <typename S>
__device__ __forceinline__ S warp_sum(S v) {
  return group_sum(v, 32);
}

// Grid: clusters of cs blocks, cluster id = (image, slab) with the slab
// fastest. Block rank r takes rows [r * rows_per_block, ...) of its slab.
template <typename T, typename P, bool SILU>
__global__ void __launch_bounds__(kResidentThreads, kBlocksPerSM)
gn_resident_kernel(const T* __restrict__ x, const P* __restrict__ w, const P* __restrict__ b,
                   T* __restrict__ y, long long rows, int C, int gw, int slab, int rows_per_block,
                   double count, float eps) {
  constexpr int V = Vec16<T>::N;
  constexpr int kWarps = kResidentThreads / 32;
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int slabs = C / slab, nvs = slab / V, ngs = slab / gw;
  const long long cid = blockIdx.x / cs;
  const long long n = cid / slabs;
  const int c0 = (int)(cid % slabs) * slab;
  const long long r0 = (long long)rank * rows_per_block;
  const int nr = (int)max(0LL, min((long long)rows_per_block, rows - r0));

  extern __shared__ __align__(16) unsigned char smem[];
  double* part = reinterpret_cast<double*>(smem);     // [2 * kMaxSlabGroups]
  double* red = part + 2 * kMaxSlabGroups;            // [kWarps][2 * kMaxSlabGroups]
  double* tot = red + kWarps * 2 * kMaxSlabGroups;    // [2 * kMaxSlabGroups]
  float* ab = reinterpret_cast<float*>(tot + 2 * kMaxSlabGroups);  // a [slab], b [slab]
  T* tile = reinterpret_cast<T*>(smem + resident_head(slab));     // [nr][slab]

  // 1. rows x slab into shared memory, 16 bytes a copy, in kChunks runs of
  //    rows, each its own cp.async group
  const T* xs = x + (n * rows + r0) * C + c0;
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    for (int i = c * nr / kChunks * nvs + threadIdx.x; i < (c + 1) * nr / kChunks * nvs;
         i += kResidentThreads) {
      const int r = i / nvs;
      cp_async16(tile + (size_t)i * V, xs + (long long)r * C + (i - r * nvs) * V);
    }
    cp_async_commit();
  }

  // 2. thread (lane, col) sums column vector col over rows lane, lane +
  //    lanes, ...: at most ceil(rows_per_block / lanes) <= kRun values an
  //    fp32 accumulator (the launcher checks). Each run of rows as soon as
  //    it has landed, while the later runs load.
  const int lanes = kResidentThreads / nvs;
  const int lane = threadIdx.x / nvs, col = threadIdx.x - lane * nvs;
  float s[V], q[V];
#pragma unroll
  for (int i = 0; i < V; ++i) s[i] = q[i] = 0.f;
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    cp_async_wait_pending(kChunks - 1 - c);
    __syncthreads();
    const int r_end = (c + 1) * nr / kChunks, r_first = c * nr / kChunks;
    if (lane < lanes) {
      for (int r = r_first + (lane - r_first % lanes + lanes) % lanes; r < r_end; r += lanes) {
        float v[V];
        load16(tile + ((size_t)r * nvs + col) * V, v);
#pragma unroll
        for (int i = 0; i < V; ++i) {
          s[i] += v[i];
          q[i] = fmaf(v[i], v[i], q[i]);
        }
      }
    }
  }

  // 3. the block's partial sums a group: a thread's channels in double, in
  //    order, then warps by shuffles, then warps in order
  const int warp = threadIdx.x / 32;
  for (int k = 0; k < ngs; ++k) {  // uniform over the block
    double ps = 0.0, pq = 0.0;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      if ((col * V + i) / gw == k) {
        ps += (double)s[i];
        pq += (double)q[i];
      }
    }
    ps = warp_sum(ps);
    pq = warp_sum(pq);
    if (threadIdx.x % 32 == 0) {
      red[warp * 2 * kMaxSlabGroups + k] = ps;
      red[warp * 2 * kMaxSlabGroups + kMaxSlabGroups + k] = pq;
    }
  }
  __syncthreads();
  if (threadIdx.x < 2 * kMaxSlabGroups) {
    double acc = 0.0;
    if (threadIdx.x % kMaxSlabGroups < ngs)
      for (int i = 0; i < kWarps; ++i) acc += red[i * 2 * kMaxSlabGroups + threadIdx.x];
    part[threadIdx.x] = acc;
  }

  // 4. every block folds all ranks' partials in rank order: the same totals
  //    in every block, the same bits on every run
  cluster.sync();
  if (threadIdx.x < 2 * kMaxSlabGroups) {
    double acc = 0.0;
    for (int r = 0; r < cs; ++r) acc += cluster.map_shared_rank(part, r)[threadIdx.x];
    tot[threadIdx.x] = acc;
  }
  cluster_arrive();  // done with the other blocks' shared memory
  __syncthreads();

  // 5. a and b for the slab's channels
  for (int j = threadIdx.x; j < slab; j += kResidentThreads) {
    const int g = j / gw;
    const double mu = tot[g] / count;
    const double var = fmax(tot[kMaxSlabGroups + g] / count - mu * mu, 0.0);
    const float inv = (float)(1.0 / sqrt(var + (double)eps));
    const float a = inv * param(w, c0 + j, sizeof(P) == 4);
    ab[j] = a;
    ab[slab + j] = param(b, c0 + j, sizeof(P) == 4) - (float)mu * a;
  }
  __syncthreads();

  // 6. y from shared memory, 16 bytes a store
  if (lane < lanes) {
    float a[V], bb[V];
    load_params<V>(ab, col * V, a);
    load_params<V>(ab + slab, col * V, bb);
    T* ys = y + (n * rows + r0) * C + c0 + col * V;
    for (int r = lane; r < nr; r += lanes) {
      float v[V];
      load16(tile + ((size_t)r * nvs + col) * V, v);
#pragma unroll
      for (int i = 0; i < V; ++i) v[i] = affine<SILU>(v[i], a[i], bb[i]);
      store16(ys + (long long)r * C, v);
    }
  }
  cluster_wait();  // no block leaves while another may still read its partials
}

// S, statistics. Grid (splits, chunks, N); a chunk is chunk_w column vectors
// of whole slabs; thread (lane, col) sums its column over the split's rows
// lane, lane + lanes, ..., kInFlight vectors in flight, fp32 runs of at
// most kRun values folded into double in shared memory. Writes
// part[n][split][g][2] in double.
template <typename T>
__global__ void __launch_bounds__(kStreamThreads, kBlocksPerSM)
gn_stream_stats_kernel(const T* __restrict__ x, double* __restrict__ part, long long rows, int C,
                       int G, int gw, int chunk_w, long long rows_per_split) {
  constexpr int V = Vec16<T>::N;
  __shared__ double sm[kStreamThreads * 2 * V];  // [lane][col][sums V, squares V]
  const int split = blockIdx.x, splits = gridDim.x, n = blockIdx.z;
  const int lanes = kStreamThreads / chunk_w;
  const int lane = threadIdx.x / chunk_w, col = threadIdx.x - lane * chunk_w;
  const int cv = blockIdx.y * chunk_w + col;
  double* mine = sm + (size_t)threadIdx.x * 2 * V;
#pragma unroll
  for (int i = 0; i < 2 * V; ++i) mine[i] = 0.0;
  if (lane < lanes && cv * V < C) {
    const long long r0 = (long long)split * rows_per_split;
    const long long r1 = min(rows, r0 + rows_per_split);
    const T* base = x + (long long)n * rows * C + (long long)cv * V;
    float s[V], q[V];
#pragma unroll
    for (int i = 0; i < V; ++i) s[i] = q[i] = 0.f;
    int run = 0;
    for (long long r = r0 + lane; r < r1; r += (long long)kInFlight * lanes) {
      uint4 raw[kInFlight];
#pragma unroll
      for (int u = 0; u < kInFlight; ++u)
        raw[u] = r + u * lanes < r1 ? load_raw16(base + (r + u * lanes) * C)
                                    : make_uint4(0u, 0u, 0u, 0u);  // +0 in bf16 and fp32
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        float v[V];
        unpack(raw[u], v);
#pragma unroll
        for (int i = 0; i < V; ++i) {
          s[i] += v[i];
          q[i] = fmaf(v[i], v[i], q[i]);
        }
      }
      run += kInFlight;
      if (run >= kRun) {
#pragma unroll
        for (int i = 0; i < V; ++i) {
          mine[i] += (double)s[i];
          mine[V + i] += (double)q[i];
          s[i] = q[i] = 0.f;
        }
        run = 0;
      }
    }
#pragma unroll
    for (int i = 0; i < V; ++i) {
      mine[i] += (double)s[i];
      mine[V + i] += (double)q[i];
    }
  }
  __syncthreads();
  // output o = 2 * (group within the chunk) + (0 sums, 1 squares): lanes, then
  // the group's channels, in order
  const int c_first = blockIdx.y * chunk_w * V;
  const int c_last = min(C, c_first + chunk_w * V);
  const int groups_here = (c_last - c_first) / gw;
  for (int o = threadIdx.x; o < 2 * groups_here; o += kStreamThreads) {
    const int gl = o / 2, which = o % 2;
    double acc = 0.0;
    for (int l = 0; l < lanes; ++l) {
      for (int j = 0; j < gw; ++j) {
        const int ch = gl * gw + j;  // channel within the chunk
        acc += sm[((size_t)l * chunk_w + ch / V) * 2 * V + which * V + ch % V];
      }
    }
    part[(((size_t)n * splits + split) * G + c_first / gw + gl) * 2 + which] = acc;
  }
}

// S, apply. Grid (blocks an image, N). The prologue folds the splits' sums
// in split order into a and b for every channel (shared memory), then the
// block walks the image's 16-byte vectors, kInFlight a thread at once.
template <typename T, typename P, bool SILU>
__global__ void __launch_bounds__(kStreamThreads, kBlocksPerSM)
gn_stream_apply_kernel(const T* __restrict__ x, const double* __restrict__ part,
                       const P* __restrict__ w, const P* __restrict__ b, T* __restrict__ y,
                       long long rows, int C, int G, int gw, int splits, double count,
                       float eps) {
  constexpr int V = Vec16<T>::N;
  extern __shared__ __align__(16) unsigned char smem[];
  float* ab = reinterpret_cast<float*>(smem);                  // a [C], b [C]
  double* red = reinterpret_cast<double*>(ab + 2 * (size_t)C);  // [kStreamThreads]
  double* tot = red + kStreamThreads;                           // [2 G]
  const int n = blockIdx.y, nval = 2 * G;
  const double* pn = part + (size_t)n * splits * nval;
  if (nval <= kStreamThreads) {  // kStreamThreads / nval threads a value, each a stride of splits
    const int parts = kStreamThreads / nval;
    const int j = threadIdx.x % nval, p = threadIdx.x / nval;
    if (p < parts) {
      double acc = 0.0;
#pragma unroll 8
      for (int s = p; s < splits; s += parts) acc += pn[(size_t)s * nval + j];
      red[p * nval + j] = acc;
    }
    __syncthreads();
    if (threadIdx.x < nval) {
      double acc = 0.0;
      for (int i = 0; i < parts; ++i) acc += red[i * nval + threadIdx.x];
      tot[threadIdx.x] = acc;
    }
  } else {
    for (int j = threadIdx.x; j < nval; j += kStreamThreads) {
      double acc = 0.0;
      for (int s = 0; s < splits; ++s) acc += pn[(size_t)s * nval + j];
      tot[j] = acc;
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += kStreamThreads) {
    const int g = c / gw;
    const double mu = tot[2 * g] / count;
    const double var = fmax(tot[2 * g + 1] / count - mu * mu, 0.0);
    const float inv = (float)(1.0 / sqrt(var + (double)eps));
    const float a = inv * param(w, c, sizeof(P) == 4);
    ab[c] = a;
    ab[C + c] = param(b, c, sizeof(P) == 4) - (float)mu * a;
  }
  __syncthreads();

  const int nvc = C / V, hop = kStreamThreads % nvc;  // column vector steps between u and u + 1
  const long long vecs = rows * nvc;
  const T* xi = x + (long long)n * rows * C;
  T* yi = y + (long long)n * rows * C;
  const long long step = (long long)gridDim.x * kStreamThreads * kInFlight;
  for (long long i0 = (long long)blockIdx.x * kStreamThreads * kInFlight + threadIdx.x;
       i0 < vecs; i0 += step) {
    uint4 raw[kInFlight];
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const long long i = i0 + (long long)u * kStreamThreads;
      if (i < vecs) raw[u] = load_raw16(xi + i * V);
    }
    int cv = (int)(i0 % nvc);
#pragma unroll
    for (int u = 0; u < kInFlight; ++u, cv = cv + hop < nvc ? cv + hop : cv + hop - nvc) {
      const long long i = i0 + (long long)u * kStreamThreads;
      if (i < vecs) {
        const int c = cv * V;
        float v[V], a[V], bb[V];
        unpack(raw[u], v);
        load_params<V>(ab, c, a);
        load_params<V>(ab + C, c, bb);
#pragma unroll
        for (int k = 0; k < V; ++k) v[k] = affine<SILU>(v[k], a[k], bb[k]);
        store16(yi + i * V, v);
      }
    }
  }
}

// A kernel's attributes: the shared memory a block may take and, for the
// cluster kernel, clusters past the portable 8. Each instantiation sets them
// once per process (the statics below).
template <typename K>
cudaError_t set_attributes(K kernel, bool cluster) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       kMaxSmem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (e == cudaSuccess && cluster)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return e;
}

template <typename T, typename P, bool SILU>
cudaError_t resident_config(int cs, int clusters, size_t smem, cudaStream_t stream,
                            cudaLaunchConfig_t& cfg, cudaLaunchAttribute& attr) {
  static const cudaError_t set = set_attributes(gn_resident_kernel<T, P, SILU>, true);
  if (set != cudaSuccess) return set;
  cfg = {};
  cfg.gridDim = dim3((unsigned)(clusters * cs));
  cfg.blockDim = dim3(kResidentThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = (unsigned)cs;
  attr.val.clusterDim.y = attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaSuccess;
}

template <typename T, typename P, bool SILU>
int resident(const void* x, const void* w, const void* b, void* y, int N, long long rows, int C,
             int G, int cs, int slab, int rows_per_block, float eps, cudaStream_t stream) {
  constexpr int V = Vec16<T>::N;
  const size_t smem = resident_head(slab) + (size_t)rows_per_block * slab * sizeof(T);
  const int lanes = kResidentThreads / (slab / V);
  if (smem > (size_t)kMaxSmem || (long long)rows_per_block * cs < rows || slab % V ||
      slab / V > kMaxSlabVectors || slab % (C / G) || C % slab ||
      slab / (C / G) > kMaxSlabGroups || (rows_per_block + lanes - 1) / lanes > kRun)
    return cudaErrorInvalidValue;
  const long long clusters = (long long)N * (C / slab);
  if (clusters * cs > 2147483647LL) return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t e = resident_config<T, P, SILU>(cs, (int)clusters, smem, stream, cfg, attr);
  if (e != cudaSuccess) return e;
  e = cudaLaunchKernelEx(&cfg, gn_resident_kernel<T, P, SILU>, static_cast<const T*>(x),
                         static_cast<const P*>(w), static_cast<const P*>(b), static_cast<T*>(y),
                         rows, C, C / G, slab, rows_per_block, (double)rows * (C / G), eps);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <typename T, typename P, bool SILU>
int streamed(const void* x, const void* w, const void* b, void* y, double* part, int N,
             long long rows, int C, int G, int splits, long long rows_per_split, int chunk_w,
             int apply_blocks, float eps, cudaStream_t stream) {
  constexpr int V = Vec16<T>::N;
  const int gw = C / G;
  const size_t smem = sizeof(float) * 2 * (size_t)C + sizeof(double) * (kStreamThreads + 2 * G);
  if (smem > (size_t)kMaxSmem || chunk_w < 1 || chunk_w > kStreamThreads ||
      (chunk_w * V) % gw || (long long)splits * rows_per_split < rows || splits < 1 ||
      apply_blocks < 1 || N > 65535)
    return cudaErrorInvalidValue;
  const int chunks = (C / V + chunk_w - 1) / chunk_w;
  gn_stream_stats_kernel<T><<<dim3(splits, chunks, N), kStreamThreads, 0, stream>>>(
      static_cast<const T*>(x), part, rows, C, G, gw, chunk_w, rows_per_split);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  static const cudaError_t set = set_attributes(gn_stream_apply_kernel<T, P, SILU>, false);
  if (set != cudaSuccess) return set;
  gn_stream_apply_kernel<T, P, SILU><<<dim3(apply_blocks, N), kStreamThreads, smem, stream>>>(
      static_cast<const T*>(x), part, static_cast<const P*>(w), static_cast<const P*>(b),
      static_cast<T*>(y), rows, C, G, gw, splits, (double)rows * gw, eps);
  return cudaGetLastError();
}

template <typename T, typename P, bool SILU>
int group_norm(const void* x, const void* w, const void* b, void* y, void* scratch, int N,
               long long rows, int C, int G, float eps, int cluster, int slab,
               int rows_per_block, int splits, long long rows_per_split, int chunk_w,
               int apply_blocks, cudaStream_t s) {
  if (cluster > 0)
    return resident<T, P, SILU>(x, w, b, y, N, rows, C, G, cluster, slab, rows_per_block, eps, s);
  return streamed<T, P, SILU>(x, w, b, y, static_cast<double*>(scratch), N, rows, C, G, splits,
                              rows_per_split, chunk_w, apply_blocks, eps, s);
}

template <typename T, typename P>
int by_silu(int silu, const void* x, const void* w, const void* b, void* y, void* scratch, int N,
            long long rows, int C, int G, float eps, int cluster, int slab, int rows_per_block,
            int splits, long long rows_per_split, int chunk_w, int apply_blocks,
            cudaStream_t s) {
  if (silu)
    return group_norm<T, P, true>(x, w, b, y, scratch, N, rows, C, G, eps, cluster, slab,
                                  rows_per_block, splits, rows_per_split, chunk_w, apply_blocks,
                                  s);
  return group_norm<T, P, false>(x, w, b, y, scratch, N, rows, C, G, eps, cluster, slab,
                                 rows_per_block, splits, rows_per_split, chunk_w, apply_blocks, s);
}

template <typename T, typename P, bool SILU>
int max_clusters(int cs, int slab, int rows_per_block, int* out) {
  const size_t smem = resident_head(slab) + (size_t)rows_per_block * slab * sizeof(T);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t e = resident_config<T, P, SILU>(cs, 1, smem, nullptr, cfg, attr);
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveClusters(out, gn_resident_kernel<T, P, SILU>, &cfg);
}

}  // namespace

extern "C" {

// x, y: (N, rows, C) contiguous, bf16 (x_fp32 = 0) or fp32, 16-byte aligned;
// w, b: (C,) fp32 (w_fp32 = 1) or bf16, 16-byte aligned. The wrapper
// guarantees C % G == 0, C a multiple of the 16-byte vector, and picks the
// variant: cluster > 0 is R (clusters of that many blocks, slab channels,
// rows_per_block rows a block; scratch unused); cluster == 0 is S (splits of
// rows_per_split rows, chunks of chunk_w column vectors, apply_blocks blocks
// an image; scratch: N * splits * 2 * G doubles).
int md_group_norm(const void* x, const void* w, const void* b, void* y, void* scratch, int N,
                  long long rows, int C, int G, float eps, int silu, int x_fp32, int w_fp32,
                  int cluster, int slab, int rows_per_block, int splits, long long rows_per_split,
                  int chunk_w, int apply_blocks, void* stream) {
  const int vec = x_fp32 ? 4 : 8;
  if (G < 1 || C % G != 0 || C % vec != 0 || N < 1 || rows < 1 || cluster < 0 || cluster > 16)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_fp32)
    return w_fp32 ? by_silu<float, float>(silu, x, w, b, y, scratch, N, rows, C, G, eps, cluster,
                                          slab, rows_per_block, splits, rows_per_split, chunk_w,
                                          apply_blocks, s)
                  : by_silu<float, bf16>(silu, x, w, b, y, scratch, N, rows, C, G, eps, cluster,
                                         slab, rows_per_block, splits, rows_per_split, chunk_w,
                                         apply_blocks, s);
  return w_fp32 ? by_silu<bf16, float>(silu, x, w, b, y, scratch, N, rows, C, G, eps, cluster,
                                       slab, rows_per_block, splits, rows_per_split, chunk_w,
                                       apply_blocks, s)
                : by_silu<bf16, bf16>(silu, x, w, b, y, scratch, N, rows, C, G, eps, cluster, slab,
                                      rows_per_block, splits, rows_per_split, chunk_w,
                                      apply_blocks, s);
}

// How many clusters of the R kernel the card holds at once for this
// configuration (cudaOccupancyMaxActiveClusters), into *out.
int md_group_norm_clusters(int x_fp32, int w_fp32, int silu, int cluster, int slab,
                           int rows_per_block, int* out) {
  *out = 0;
  if (cluster < 1 || cluster > 16 || slab < 1 || rows_per_block < 1) return cudaErrorInvalidValue;
  if (x_fp32) {
    if (w_fp32)
      return silu ? max_clusters<float, float, true>(cluster, slab, rows_per_block, out)
                  : max_clusters<float, float, false>(cluster, slab, rows_per_block, out);
    return silu ? max_clusters<float, bf16, true>(cluster, slab, rows_per_block, out)
                : max_clusters<float, bf16, false>(cluster, slab, rows_per_block, out);
  }
  if (w_fp32)
    return silu ? max_clusters<bf16, float, true>(cluster, slab, rows_per_block, out)
                : max_clusters<bf16, float, false>(cluster, slab, rows_per_block, out);
  return silu ? max_clusters<bf16, bf16, true>(cluster, slab, rows_per_block, out)
              : max_clusters<bf16, bf16, false>(cluster, slab, rows_per_block, out);
}

}  // extern "C"
