// Forward kernels of the serving path, written for Hopper (sm_90a).
//
// They replace the three Pallas kernels of mmlrec_tpu/ops/pallas_kernels.py:
//
//   embed_concat      <- fused_embed_concat (:43)  gather + flatten + concat
//   gated_expert_mix  <- gated_expert_mix   (:123) softmax(logits) @ experts
//   multihead_score   <- multihead_score    (:164) tower . w + b, then sigmoid
//
// Every one of them moves a few MB and does a few FLOPs per byte, so each is
// bound by memory traffic (and, at serving batch sizes, by launch latency).
// The designs keep each input read once from device memory and each output
// written once, with neighbouring threads on neighbouring addresses; nothing
// here uses tensor cores, TMA or clusters.  embed_concat's byte bound lies
// below what a launch alone takes, so its design is about latency: 16-byte
// accesses only, all of a tile's loads in flight together, the tile put
// together in shared memory and stored as one run (it needs D % 4 == 0 and
// 16-byte-aligned table, dense block and output; every other shape, and a
// last tile whose row count is no multiple of 4, takes a scalar body).
// multihead_score is below the floor too: a group of H / 4 lanes per row,
// every load asked for before any arithmetic (H % 4 == 0 and 16-byte-aligned
// tower and w; a scalar body otherwise).
// mmlrec_empty_launch launches a kernel that does nothing, to time that floor.
//
// Interface: plain C, one entry per kernel, called through ctypes from
// mmlrec_tpu_torch/ops/kernels.py.  Each entry launches on the stream it is
// given, allocates nothing, never synchronises, and returns
// cudaGetLastError() so that a refused launch is reported by the caller.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC -o librecsys_kernels.so recsys_kernels.cu

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// Batch rows of one embed_concat tile: a multiple of 4, so that a whole
// tile's output and dense block are 16-byte multiples whatever the widths
// are; ops/kernels.py mirrors it as _EMBED_ROWS_PER_BLOCK.
#ifndef MMLREC_EMBED_TILE_ROWS
#define MMLREC_EMBED_TILE_ROWS 8
#endif
constexpr int kEmbedRowsPerBlock = MMLREC_EMBED_TILE_ROWS;
static_assert(kEmbedRowsPerBlock > 0 && kEmbedRowsPerBlock % 4 == 0,
              "a tile is a multiple of 4 batch rows");
constexpr int kEmbedThreads = kEmbedRowsPerBlock >= 8 ? 256 : 128;
#ifndef MMLREC_SCORE_THREADS
#define MMLREC_SCORE_THREADS 256
#endif
constexpr int kScoreThreads = MMLREC_SCORE_THREADS;  // _SCORE_THREADS in ops/kernels.py
static_assert(kScoreThreads % 32 == 0 && kScoreThreads >= 32 && kScoreThreads <= 1024,
              "a block is whole warps");
constexpr int kStaticSmem = 48 * 1024;  // launch limit without an opt-in

// Wrap a negative id once; -1 for an id that is then outside [0, rows), as
// jnp.take's fill mode does.
__device__ __forceinline__ long long resolve_row(long long r, long long rows) {
  if (r < 0) r += rows;
  return (r >= 0 && r < rows) ? r : -1;
}

// ---------------------------------------------------------------------------
// embed_concat: out[b] = concat(table[ids[b, 0]], ..., table[ids[b, F-1]],
//                               dense[b])
//
// One block per tile of kEmbedRowsPerBlock batch rows, in one of two bodies.
// A missing row is written as NaN; the table is never read outside its
// bounds.  Both bodies move bits only, so they give the same output.
//
// Vector body (the wrapper passes vec = 1 when D % 4 == 0, the table, the
// dense block and the output start on 16-byte boundaries and the tile's
// image fits the static shared memory; the tile holds a multiple of 4 rows):
// every access to device memory is 16 bytes and a tile's loads are started at
// once.  A thread first loads one float4 of the dense block, then its id and
// one float4 of that id's table row (the id is range-checked before it
// becomes an address), and only then writes both into a shared-memory image
// of the tile's output; after one __syncthreads() the image is stored as one
// contiguous run of float4.  At 8 rows a tile and the flagship widths that
// is one table load a thread, half a dense load, 1.5 stores and 6 KB of
// shared memory.  The integer divisions are per float4 of the gather, none
// is left in the store loop.
//
// Scalar body (D % 4 != 0, a misaligned view, or a last tile whose row count
// is no multiple of 4): the tile's ids are resolved into shared memory, then
// the threads walk the tile's output row-major one float at a time.
// ---------------------------------------------------------------------------
__device__ __forceinline__ void embed_tile_vector(
    const float* __restrict__ table, long long rows, int dim,
    const int* __restrict__ tile_ids, int nb, int n_feat,
    const float* __restrict__ tile_dense, int n_dense,
    float* __restrict__ tile_out, float* img) {
  const int sparse_w = n_feat * dim;
  const int width = sparse_w + n_dense;
  const int parts = dim >> 2;  // float4 per table row
  const int n_tab = nb * n_feat * parts;
  const int n_den = (nb * n_dense) >> 2;
  const float4* table4 = reinterpret_cast<const float4*>(table);
  const float4* dense4 = reinterpret_cast<const float4*>(tile_dense);
  const float nan = __int_as_float(0x7fc00000);
  const int n_max = n_tab > n_den ? n_tab : n_den;
  for (int q0 = 0; q0 < n_max; q0 += kEmbedThreads) {
    const int q = q0 + threadIdx.x;
    const bool has_d = q < n_den, has_t = q < n_tab;
    float4 dv = make_float4(0.f, 0.f, 0.f, 0.f), tv = make_float4(nan, nan, nan, nan);
    int pair = 0, part = 0;
    if (has_d) dv = dense4[q];
    if (has_t) {
      pair = q / parts;
      part = q - pair * parts;
      const long long r = resolve_row(tile_ids[pair], rows);
      if (r >= 0) tv = table4[r * parts + part];
    }
    if (has_t) {
      const int b = pair / n_feat;
      float* dst = img + b * width + (pair - b * n_feat) * dim + 4 * part;
      dst[0] = tv.x, dst[1] = tv.y, dst[2] = tv.z, dst[3] = tv.w;
    }
    if (has_d) {  // 4 consecutive floats of the dense block may span two rows
      int b = (4 * q) / n_dense;
      int j = 4 * q - b * n_dense;
      const float v[4] = {dv.x, dv.y, dv.z, dv.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        img[b * width + sparse_w + j] = v[k];
        if (++j == n_dense) j = 0, ++b;
      }
    }
  }
  __syncthreads();
  float4* out4 = reinterpret_cast<float4*>(tile_out);
  const float4* img4 = reinterpret_cast<const float4*>(img);
  const int n_out = (nb * width) >> 2;
  for (int i = threadIdx.x; i < n_out; i += kEmbedThreads) out4[i] = img4[i];
}

__device__ __forceinline__ void embed_tile_scalar(
    const float* __restrict__ table, long long rows, int dim,
    const int* __restrict__ tile_ids, int nb, int n_feat,
    const float* __restrict__ tile_dense, int n_dense,
    float* __restrict__ tile_out, long long* s_row) {
  const int sparse_w = n_feat * dim;
  const int width = sparse_w + n_dense;
  for (int i = threadIdx.x; i < nb * n_feat; i += kEmbedThreads)
    s_row[i] = resolve_row(tile_ids[i], rows);
  __syncthreads();
  const float nan = __int_as_float(0x7fc00000);
  for (int i = threadIdx.x; i < nb * width; i += kEmbedThreads) {
    const int b = i / width;
    const int c = i - b * width;
    float v;
    if (c < sparse_w) {
      const int f = c / dim;
      const long long r = s_row[b * n_feat + f];
      v = r >= 0 ? table[r * dim + (c - f * dim)] : nan;
    } else {
      v = tile_dense[static_cast<long long>(b) * n_dense + (c - sparse_w)];
    }
    tile_out[i] = v;
  }
}

__global__ void __launch_bounds__(kEmbedThreads)
embed_concat_kernel(const float* __restrict__ table, long long rows, int dim,
                    const int* __restrict__ ids, int batch, int n_feat,
                    const float* __restrict__ dense, int n_dense,
                    float* __restrict__ out, int vec) {
  // the vector body's image of the tile [nb * width] f32, or the scalar
  // body's resolved rows [nb * n_feat] int64
  extern __shared__ __align__(16) unsigned char s_tile[];
  const int b0 = blockIdx.x * kEmbedRowsPerBlock;
  const int nb = min(kEmbedRowsPerBlock, batch - b0);
  const int width = n_feat * dim + n_dense;
  const int* tile_ids = ids + static_cast<long long>(b0) * n_feat;
  const float* tile_dense = dense + static_cast<long long>(b0) * n_dense;
  float* tile_out = out + static_cast<long long>(b0) * width;
  if (vec && (nb & 3) == 0) {  // uniform over the block
    embed_tile_vector(table, rows, dim, tile_ids, nb, n_feat, tile_dense, n_dense,
                      tile_out, reinterpret_cast<float*>(s_tile));
  } else {
    embed_tile_scalar(table, rows, dim, tile_ids, nb, n_feat, tile_dense, n_dense,
                      tile_out, reinterpret_cast<long long*>(s_tile));
  }
}

// The launch floor's probe: a kernel that does nothing.
__global__ void empty_kernel() {}

// ---------------------------------------------------------------------------
// gated_expert_mix: out[b, t, :] = sum_e softmax(logits[b, t, :])[e]
//                                  * experts[b, e, :]
//
// One block per batch row.  The first T threads each compute one task's
// max-subtracted softmax over E into shared memory; then every thread owns
// feature columns d and accumulates the T mixes in f32, reading each expert
// row coalesced.
// ---------------------------------------------------------------------------
__global__ void gated_mix_kernel(const float* __restrict__ logits,
                                 const float* __restrict__ experts,
                                 int n_tasks, int n_exp, int dim,
                                 float* __restrict__ out) {
  extern __shared__ float s_gate[];  // [n_tasks * n_exp]
  const long long b = blockIdx.x;
  const float* lg = logits + b * n_tasks * n_exp;
  for (int t = threadIdx.x; t < n_tasks; t += blockDim.x) {
    const float* l = lg + t * n_exp;
    float* g = s_gate + t * n_exp;
    float m = l[0];
    for (int e = 1; e < n_exp; ++e) m = fmaxf(m, l[e]);
    float s = 0.f;
    for (int e = 0; e < n_exp; ++e) {
      const float u = expf(l[e] - m);
      g[e] = u;
      s += u;
    }
    for (int e = 0; e < n_exp; ++e) g[e] = g[e] / s;
  }
  __syncthreads();

  const float* x = experts + b * n_exp * dim;
  float* o = out + b * n_tasks * dim;
  for (int d = threadIdx.x; d < dim; d += blockDim.x) {
    for (int t = 0; t < n_tasks; ++t) {
      const float* g = s_gate + t * n_exp;
      float acc = 0.f;
      for (int e = 0; e < n_exp; ++e) acc = fmaf(g[e], x[e * dim + d], acc);
      o[t * dim + d] = acc;
    }
  }
}

// ---------------------------------------------------------------------------
// multihead_score: z = sum_h tower[b, t, h] * w[t, h] + bias[t]
//                  out[b, t] = binary[t] * sigmoid(z) + (1 - binary[t]) * z
//
// binary[t] is 1 for a binary head and 0 for a regression head
// (PredictionHeads).  2 MB at the flagship batch: its byte bound lies below
// what a launch alone takes, so the design is about the chain of dependent
// steps a row goes through, in one of two bodies.
//
// Vector body (the wrapper passes vec = 1 when H % 4 == 0 and tower and w
// start on 16-byte boundaries, and B * T fits 31 bits): a group of lanes no
// wider than the row needs takes R rows of one head.  With 16-byte loads a row
// of H floats is H / 4 float4, so the group is the next power of two (16 lanes
// at H = 64, 32 at H >= 128, 4 at H = 16) and a warp carries 32 / group
// groups.  R is 1 while a group is narrower than a warp and 2 once a row
// takes a whole warp, so a warp always carries two rows or more: the time
// follows the number of blocks more than the bytes (-D
// MMLREC_SCORE_ROWS_PER_GROUP=n forces R = n).  A lane asks for its float4 of
// w[t], its float4 of every row of the group, bias[t] and binary[t] before any
// arithmetic, so the chain has one memory round trip; log2(group) shuffle
// steps follow, and lane j of the group applies the epilogue of row j and
// stores it.  Groups are numbered head fastest, so with one row a group a
// row's address needs no division and a warp's results leave as one run.
//
// Scalar body (any other H, or a misaligned view): one warp per (b, t) row,
// lanes striding over H 4 bytes at a time, bias and mask asked for up front.
// ---------------------------------------------------------------------------
#ifndef MMLREC_SCORE_ROWS_PER_GROUP
#define MMLREC_SCORE_ROWS_PER_GROUP 0  // 0: by the rule above
#endif
#ifndef MMLREC_SCORE_MIN_LANES
#define MMLREC_SCORE_MIN_LANES 1
#endif
constexpr int kScoreRowsPerGroup = MMLREC_SCORE_ROWS_PER_GROUP;
constexpr int kScoreMinLanes = MMLREC_SCORE_MIN_LANES;
static_assert(kScoreRowsPerGroup >= 0 && kScoreRowsPerGroup <= 8, "rows of one group");
static_assert(kScoreMinLanes >= 1 && kScoreMinLanes <= 32 &&
                  (kScoreMinLanes & (kScoreMinLanes - 1)) == 0,
              "a group is a power of two of lanes within a warp");

__device__ __forceinline__ float head_epilogue(float z, float m) {
  const float s = 1.f / (1.f + expf(-z));
  return m * s + (1.f - m) * z;
}

template <int kLanes, int R>
__global__ void __launch_bounds__(kScoreThreads)
multihead_score_vector_kernel(const float4* __restrict__ tower4,
                              const float4* __restrict__ w4,
                              const float* __restrict__ bias,
                              const float* __restrict__ binary, int batch,
                              int n_tasks, int parts, float* __restrict__ out) {
  // 32-bit group arithmetic: the entry checked that B * T fits
  const unsigned group = (blockIdx.x * kScoreThreads + threadIdx.x) / kLanes;
  const int lane = threadIdx.x & (kLanes - 1);
  const unsigned n_groups = static_cast<unsigned>((batch + R - 1) / R) * n_tasks;
  // a group past the end keeps its lanes for the shuffles and has no rows
  const bool live = group < n_groups;
  const int t = live ? static_cast<int>(group % n_tasks) : 0;
  const int b0 = live ? static_cast<int>(group / n_tasks) * R : batch;
  const float bs = bias[t], m = binary[t];
  float acc[R];
#pragma unroll
  for (int j = 0; j < R; ++j) acc[j] = 0.f;
  float4 xv[R];
  // with one row a group the row is the group: its address waits for no division
  const long long row0 = R == 1 ? group : static_cast<long long>(b0) * n_tasks + t;
  for (int q = lane; q < parts; q += kLanes) {  // once for H <= 4 * kLanes
#pragma unroll
    for (int j = 0; j < R; ++j)
      xv[j] = (R == 1 ? live : b0 + j < batch)
                  ? tower4[(row0 + static_cast<long long>(j) * n_tasks) * parts + q]
                  : make_float4(0.f, 0.f, 0.f, 0.f);
    const float4 wv = w4[static_cast<long long>(t) * parts + q];
#pragma unroll
    for (int j = 0; j < R; ++j) {
      acc[j] = fmaf(xv[j].x, wv.x, acc[j]);
      acc[j] = fmaf(xv[j].y, wv.y, acc[j]);
      acc[j] = fmaf(xv[j].z, wv.z, acc[j]);
      acc[j] = fmaf(xv[j].w, wv.w, acc[j]);
    }
  }
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1) {
#pragma unroll
    for (int j = 0; j < R; ++j) acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], off);
  }
#pragma unroll
  for (int j = 0; j < R; ++j) {  // every lane holds every sum: lane j takes row j
    if ((j & (kLanes - 1)) == lane && b0 + j < batch)
      out[row0 + static_cast<long long>(j) * n_tasks] = head_epilogue(acc[j] + bs, m);
  }
}

__global__ void __launch_bounds__(kScoreThreads)
multihead_score_scalar_kernel(const float* __restrict__ tower,
                              const float* __restrict__ w,
                              const float* __restrict__ bias,
                              const float* __restrict__ binary, long long n_rows,
                              int n_tasks, int hidden, float* __restrict__ out) {
  const long long row =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= n_rows) return;  // whole warps leave together
  const int t = static_cast<int>(row % n_tasks);
  const float bs = bias[t], m = binary[t];
  const float* x = tower + row * hidden;
  const float* wt = w + static_cast<long long>(t) * hidden;
  float acc = 0.f;
  for (int h = lane; h < hidden; h += 32) acc = fmaf(x[h], wt[h], acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_down_sync(0xffffffffu, acc, off);
  if (lane == 0) out[row] = head_epilogue(acc + bs, m);
}

template <int kLanes, int R>
void launch_score_vector(const float* tower, const float* w, const float* bias,
                         const float* binary, int batch, int n_tasks, int hidden,
                         float* out, cudaStream_t stream) {
  const long long groups = static_cast<long long>((batch + R - 1) / R) * n_tasks;
  const long long blocks = (groups * kLanes + kScoreThreads - 1) / kScoreThreads;
  multihead_score_vector_kernel<kLanes, R>
      <<<static_cast<unsigned>(blocks), kScoreThreads, 0, stream>>>(
          reinterpret_cast<const float4*>(tower), reinterpret_cast<const float4*>(w), bias,
          binary, batch, n_tasks, hidden / 4, out);
}

template <int kLanes>
void launch_score_lanes(const float* tower, const float* w, const float* bias,
                        const float* binary, int batch, int n_tasks, int hidden,
                        float* out, cudaStream_t stream) {
  constexpr int kRows = kScoreRowsPerGroup > 0 ? kScoreRowsPerGroup : (kLanes == 32 ? 2 : 1);
  launch_score_vector<kLanes, kRows>(tower, w, bias, binary, batch, n_tasks, hidden, out,
                                     stream);
}

}  // namespace

extern "C" {

// `vec` = 1 asks for the vector body (see embed_concat_kernel for what the
// caller must have checked).
int mmlrec_embed_concat(const float* table, long long rows, int dim,
                        const int* ids, int batch, int n_feat,
                        const float* dense, int n_dense, float* out, int vec,
                        void* stream) {
  const int blocks = (batch + kEmbedRowsPerBlock - 1) / kEmbedRowsPerBlock;
  size_t smem = sizeof(long long) * kEmbedRowsPerBlock * n_feat;
  if (vec) {
    if (dim % 4) return static_cast<int>(cudaErrorInvalidValue);
    const size_t image =
        sizeof(float) * kEmbedRowsPerBlock * (static_cast<size_t>(n_feat) * dim + n_dense);
    smem = image > smem ? image : smem;
  }
  if (smem > kStaticSmem) return static_cast<int>(cudaErrorInvalidValue);
  embed_concat_kernel<<<blocks, kEmbedThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      table, rows, dim, ids, batch, n_feat, dense, n_dense, out, vec);
  return static_cast<int>(cudaGetLastError());
}

// An empty kernel of `blocks` x `threads`, to time what a launch alone costs.
int mmlrec_empty_launch(int blocks, int threads, void* stream) {
  empty_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

int mmlrec_gated_expert_mix(const float* logits, const float* experts,
                            int batch, int n_tasks, int n_exp, int dim,
                            float* out, void* stream) {
  int threads = ((dim + 31) / 32) * 32;
  threads = threads < 32 ? 32 : (threads > 256 ? 256 : threads);
  const size_t smem = sizeof(float) * n_tasks * n_exp;
  gated_mix_kernel<<<batch, threads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      logits, experts, n_tasks, n_exp, dim, out);
  return static_cast<int>(cudaGetLastError());
}

// `vec` = 1 asks for the vector body (see multihead_score_vector_kernel for
// what the caller must have checked); the lanes of a group follow from H.
int mmlrec_multihead_score(const float* tower, const float* w,
                           const float* bias, const float* binary, int batch,
                           int n_tasks, int hidden, float* out, int vec,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec) {
    if (hidden % 4 || static_cast<long long>(batch) * n_tasks * 32 >= (1ll << 31))
      return static_cast<int>(cudaErrorInvalidValue);
    int lanes = kScoreMinLanes;
    while (lanes < 32 && lanes * 4 < hidden) lanes *= 2;
    switch (lanes) {
      case 1: launch_score_lanes<1>(tower, w, bias, binary, batch, n_tasks, hidden, out, s); break;
      case 2: launch_score_lanes<2>(tower, w, bias, binary, batch, n_tasks, hidden, out, s); break;
      case 4: launch_score_lanes<4>(tower, w, bias, binary, batch, n_tasks, hidden, out, s); break;
      case 8: launch_score_lanes<8>(tower, w, bias, binary, batch, n_tasks, hidden, out, s); break;
      case 16: launch_score_lanes<16>(tower, w, bias, binary, batch, n_tasks, hidden, out, s); break;
      default: launch_score_lanes<32>(tower, w, bias, binary, batch, n_tasks, hidden, out, s);
    }
    return static_cast<int>(cudaGetLastError());
  }
  const long long n_rows = static_cast<long long>(batch) * n_tasks;
  const long long warps_per_block = kScoreThreads / 32;
  const long long blocks = (n_rows + warps_per_block - 1) / warps_per_block;
  multihead_score_scalar_kernel<<<static_cast<unsigned>(blocks), kScoreThreads, 0, s>>>(
      tower, w, bias, binary, n_rows, n_tasks, hidden, out);
  return static_cast<int>(cudaGetLastError());
}

const char* mmlrec_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
