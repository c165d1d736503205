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
// here uses tensor cores, TMA or clusters.
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

constexpr int kEmbedThreads = 256;
constexpr int kEmbedRowsPerBlock = 16;
constexpr int kScoreThreads = 256;

// ---------------------------------------------------------------------------
// embed_concat: out[b] = concat(table[ids[b, 0]], ..., table[ids[b, F-1]],
//                               dense[b])
//
// One block per tile of kEmbedRowsPerBlock batch rows.  The block first
// resolves its tile's ids into shared memory (wrap a negative id once, mark an
// id outside [0, rows) as missing, as jnp.take's fill mode does), then its
// threads walk the tile's output row-major, so the stores are contiguous and
// each table row of D floats is read by D neighbouring threads.  A missing
// row is written as NaN; the table is never read outside its bounds.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kEmbedThreads)
embed_concat_kernel(const float* __restrict__ table, long long rows, int dim,
                    const int* __restrict__ ids, int batch, int n_feat,
                    const float* __restrict__ dense, int n_dense,
                    float* __restrict__ out) {
  extern __shared__ long long s_row[];  // [kEmbedRowsPerBlock * n_feat]
  const int b0 = blockIdx.x * kEmbedRowsPerBlock;
  const int nb = min(kEmbedRowsPerBlock, batch - b0);
  const int sparse_w = n_feat * dim;
  const int width = sparse_w + n_dense;

  const int* tile_ids = ids + static_cast<long long>(b0) * n_feat;
  for (int i = threadIdx.x; i < nb * n_feat; i += blockDim.x) {
    long long r = tile_ids[i];
    if (r < 0) r += rows;
    s_row[i] = (r >= 0 && r < rows) ? r : -1;
  }
  __syncthreads();

  const float* tile_dense = dense + static_cast<long long>(b0) * n_dense;
  float* tile_out = out + static_cast<long long>(b0) * width;
  const float nan = __int_as_float(0x7fc00000);
  for (int i = threadIdx.x; i < nb * width; i += blockDim.x) {
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
// One warp per (b, t) row: lanes stride over H (coalesced), then a shuffle
// reduction; lane 0 applies the head's epilogue.  binary[t] is 1 for a
// binary head and 0 for a regression head (PredictionHeads).
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kScoreThreads)
multihead_score_kernel(const float* __restrict__ tower,
                       const float* __restrict__ w,
                       const float* __restrict__ bias,
                       const float* __restrict__ binary, long long n_rows,
                       int n_tasks, int hidden, float* __restrict__ out) {
  const long long row =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= n_rows) return;  // whole warps leave together
  const int t = static_cast<int>(row % n_tasks);
  const float* x = tower + row * hidden;
  const float* wt = w + static_cast<long long>(t) * hidden;
  float acc = 0.f;
  for (int h = lane; h < hidden; h += 32) acc = fmaf(x[h], wt[h], acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_down_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const float z = acc + bias[t];
    const float m = binary[t];
    const float s = 1.f / (1.f + expf(-z));
    out[row] = m * s + (1.f - m) * z;
  }
}

}  // namespace

extern "C" {

int mmlrec_embed_concat(const float* table, long long rows, int dim,
                        const int* ids, int batch, int n_feat,
                        const float* dense, int n_dense, float* out,
                        void* stream) {
  const int blocks = (batch + kEmbedRowsPerBlock - 1) / kEmbedRowsPerBlock;
  const size_t smem = sizeof(long long) * kEmbedRowsPerBlock * n_feat;
  embed_concat_kernel<<<blocks, kEmbedThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      table, rows, dim, ids, batch, n_feat, dense, n_dense, out);
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

int mmlrec_multihead_score(const float* tower, const float* w,
                           const float* bias, const float* binary, int batch,
                           int n_tasks, int hidden, float* out, void* stream) {
  const long long n_rows = static_cast<long long>(batch) * n_tasks;
  const long long warps_per_block = kScoreThreads / 32;
  const long long blocks = (n_rows + warps_per_block - 1) / warps_per_block;
  multihead_score_kernel<<<static_cast<unsigned>(blocks), kScoreThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      tower, w, bias, binary, n_rows, n_tasks, hidden, out);
  return static_cast<int>(cudaGetLastError());
}

const char* mmlrec_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
