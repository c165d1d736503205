// Probe kernels of benchmarks/, written for Hopper (sm_90a).
//
// They replace the five Pallas kernels of the JAX package's probe scripts,
// A/B variants of the row kernels that measured what the TPU's DMA issue
// rate costs the 40 M-row table update:
//
//   probe_rows_write_kernel   <- benchmarks/probe_dma_issue_floor.py::
//                                _kernel_rows (pallas_call at :88): in place,
//                                table[ids[j] + r] = values[j * run + r],
//                                r < run (runs of 1-16 rows)
//   probe_pairs_write_kernel  <- benchmarks/probe_dma_issue_floor.py::
//                                _kernel_dual (:144): in place,
//                                stacked[p, ids[j]] = values[p, j], p < 2
//   probe_rows_gather_kernel  <- benchmarks/probe_row_gather_scan.py::
//                                _hbm_gather_kernel (:77): out[j] = table[ids[j]]
//   probe_pairs_gather_kernel <- benchmarks/probe_row_gather_scan.py::
//                                _dual_gather_kernel (:122):
//                                out[p, j] = stacked[p, ids[j]], p < 2
//   probe_window_add_kernel   <- benchmarks/probe_pallas_row_windows.py::
//                                _kernel (:66): in place,
//                                arr[k * ids[j] + r] += deltas[j * k + r], r < k
//
// All five are bound by memory traffic: every row they touch is read once
// and written once (the window add reads the window and its deltas), 512
// bytes a row at the scripts' 128 f32 lanes.  On the TPU each row (or run,
// or pair, or window) was one DMA issued by the scalar core; here one warp
// takes one id: its run, both rows of its pair or its window are
// contiguous bytes, which the warp moves as 16-byte words on neighbouring
// addresses, each lane keeping kInFlight loads in flight before its stores.
// A block of 8 warps takes 8 consecutive ids.
//
// Contracts (the scripts' own draws): run starts are distinct and runs do
// not overlap, pair-write and window ids are distinct, gather ids may
// repeat.  Overlapping writes are undefined, as on the TPU.  Ids lie in
// [0, rows) (a run start in [0, rows - run]): any other id stops the
// kernel before an address is formed from it (__trap: the launch fails,
// and the error shows at the next synchronisation).  The plain versions
// raise on an id past the end and, being PyTorch indexing, count a
// negative one from the end; no kernel answers where its plain version
// raises.  Row offsets are 64-bit: the tables pass 2^32 bytes.
// Rows must be a whole number of 16-byte words and every array 16-byte
// aligned; the wrappers (mmlrec_tpu_torch/tools/probe_rows.py) check that.
//
// Interface: plain C, called through ctypes.  Each entry launches on the
// stream it is given, allocates nothing, never synchronises, and returns
// cudaGetLastError().
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC -o libprobe_kernels.so probe_kernels.cu

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarpsPerBlock = kThreads / 32;  // one warp per id
constexpr int kInFlight = 4;                   // 16-byte loads a lane issues before storing

// The warp copies n 16-byte words from src to dst.
__device__ __forceinline__ void warp_copy(uint4* __restrict__ dst,
                                          const uint4* __restrict__ src,
                                          long long n, int lane) {
  for (long long base = lane; base < n; base += 32LL * kInFlight) {
    uint4 v[kInFlight];
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const long long i = base + 32LL * u;
      if (i < n) v[u] = src[i];
    }
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const long long i = base + 32LL * u;
      if (i < n) dst[i] = v[u];
    }
  }
}

// The warp copies two rows of n words each (one per plane), both loaded
// before either is stored.
__device__ __forceinline__ void warp_copy_pair(uint4* __restrict__ dst0,
                                               const uint4* __restrict__ src0,
                                               uint4* __restrict__ dst1,
                                               const uint4* __restrict__ src1,
                                               long long n, int lane) {
  for (long long i = lane; i < n; i += 32) {
    const uint4 a = src0[i];
    const uint4 b = src1[i];
    dst0[i] = a;
    dst1[i] = b;
  }
}

__device__ __forceinline__ int warp_id() {
  return blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
}

// The id, if the `span` rows from it lie inside [0, n); else the kernel
// stops.
__device__ __forceinline__ long long inside(long long id, long long span,
                                            long long n) {
  if (id < 0 || id + span > n) __trap();
  return id;
}

// P1: table[ids[j] + r] = values[j * run + r] for r < run: one warp per run.
__global__ void __launch_bounds__(kThreads)
probe_rows_write_kernel(uint4* __restrict__ table, long long rows,
                        long long row_words, int run,
                        const uint4* __restrict__ values,
                        const int* __restrict__ ids, int n_runs) {
  const int j = warp_id();
  if (j >= n_runs) return;  // whole warps leave together
  const long long start = inside(ids[j], run, rows);
  const long long n = run * row_words;
  warp_copy(table + start * row_words, values + j * n, n, threadIdx.x & 31);
}

// P2: stacked[p, ids[j]] = values[p, j] for both planes p.
__global__ void __launch_bounds__(kThreads)
probe_pairs_write_kernel(uint4* __restrict__ stacked, long long rows,
                         long long row_words,
                         const uint4* __restrict__ values,
                         const int* __restrict__ ids, int n_ids) {
  const int j = warp_id();
  if (j >= n_ids) return;
  const long long r = inside(ids[j], 1, rows);
  warp_copy_pair(stacked + r * row_words, values + j * row_words,
                 stacked + (rows + r) * row_words,
                 values + (static_cast<long long>(n_ids) + j) * row_words,
                 row_words, threadIdx.x & 31);
}

// P3: out[j] = table[ids[j]].
__global__ void __launch_bounds__(kThreads)
probe_rows_gather_kernel(const uint4* __restrict__ table, long long rows,
                         long long row_words, uint4* __restrict__ out,
                         const int* __restrict__ ids, int n_ids) {
  const int j = warp_id();
  if (j >= n_ids) return;
  const long long r = inside(ids[j], 1, rows);
  warp_copy(out + j * row_words, table + r * row_words, row_words,
            threadIdx.x & 31);
}

// P4: out[p, j] = stacked[p, ids[j]] for both planes p.
__global__ void __launch_bounds__(kThreads)
probe_pairs_gather_kernel(const uint4* __restrict__ stacked, long long rows,
                          long long row_words, uint4* __restrict__ out,
                          const int* __restrict__ ids, int n_ids) {
  const int j = warp_id();
  if (j >= n_ids) return;
  const long long r = inside(ids[j], 1, rows);
  warp_copy_pair(out + j * row_words, stacked + r * row_words,
                 out + (static_cast<long long>(n_ids) + j) * row_words,
                 stacked + (rows + r) * row_words, row_words,
                 threadIdx.x & 31);
}

// P5: the window of k rows at k * ids[j] of arr ([k * windows, W] f32) gets
// the k delta rows at j * k added, one f32 add per element (the TPU
// kernel's scratch + deltas: the same bits in any order of elements).
__global__ void __launch_bounds__(kThreads)
probe_window_add_kernel(float4* __restrict__ arr, long long windows, int k,
                        long long row_words,
                        const float4* __restrict__ deltas,
                        const int* __restrict__ ids, int n_ids) {
  const int j = warp_id();
  if (j >= n_ids) return;
  const long long w = inside(ids[j], 1, windows);
  const int lane = threadIdx.x & 31;
  const long long n = k * row_words;
  float4* a = arr + w * n;
  const float4* d = deltas + j * n;
  for (long long base = lane; base < n; base += 32LL * kInFlight) {
    float4 x[kInFlight], y[kInFlight];
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const long long i = base + 32LL * u;
      if (i < n) {
        x[u] = a[i];
        y[u] = d[i];
      }
    }
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const long long i = base + 32LL * u;
      if (i < n) {
        a[i] = make_float4(x[u].x + y[u].x, x[u].y + y[u].y, x[u].z + y[u].z,
                           x[u].w + y[u].w);
      }
    }
  }
}

unsigned blocks_for(int n) {
  return static_cast<unsigned>((n + kWarpsPerBlock - 1) / kWarpsPerBlock);
}

// 0, or cudaErrorInvalidValue for rows that are not whole 16-byte words or
// an empty launch (the wrappers never launch one).
int check_rows(long long row_bytes, int n) {
  if (row_bytes <= 0 || row_bytes % 16 != 0 || n < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

}  // namespace

extern "C" {

int mmlrec_probe_rows_write(void* table, long long rows, long long row_bytes,
                            int run, const void* values, const int* ids,
                            int n_runs, void* stream) {
  if (int bad = check_rows(row_bytes, n_runs)) return bad;
  if (run < 1) return static_cast<int>(cudaErrorInvalidValue);
  probe_rows_write_kernel<<<blocks_for(n_runs), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint4*>(table), rows, row_bytes / 16, run,
      static_cast<const uint4*>(values), ids, n_runs);
  return static_cast<int>(cudaGetLastError());
}

int mmlrec_probe_pairs_write(void* stacked, long long rows, long long row_bytes,
                             const void* values, const int* ids, int n_ids,
                             void* stream) {
  if (int bad = check_rows(row_bytes, n_ids)) return bad;
  probe_pairs_write_kernel<<<blocks_for(n_ids), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint4*>(stacked), rows, row_bytes / 16,
      static_cast<const uint4*>(values), ids, n_ids);
  return static_cast<int>(cudaGetLastError());
}

int mmlrec_probe_rows_gather(const void* table, long long rows,
                             long long row_bytes, void* out, const int* ids,
                             int n_ids, void* stream) {
  if (int bad = check_rows(row_bytes, n_ids)) return bad;
  probe_rows_gather_kernel<<<blocks_for(n_ids), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(table), rows, row_bytes / 16,
      static_cast<uint4*>(out), ids, n_ids);
  return static_cast<int>(cudaGetLastError());
}

int mmlrec_probe_pairs_gather(const void* stacked, long long rows,
                              long long row_bytes, void* out, const int* ids,
                              int n_ids, void* stream) {
  if (int bad = check_rows(row_bytes, n_ids)) return bad;
  probe_pairs_gather_kernel<<<blocks_for(n_ids), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(stacked), rows, row_bytes / 16,
      static_cast<uint4*>(out), ids, n_ids);
  return static_cast<int>(cudaGetLastError());
}

// `windows` = the array's rows / k; `row_bytes` of one row of the array.
int mmlrec_probe_window_add(void* arr, long long windows, int k,
                            long long row_bytes, const void* deltas,
                            const int* ids, int n_ids, void* stream) {
  if (int bad = check_rows(row_bytes, n_ids)) return bad;
  if (k < 1) return static_cast<int>(cudaErrorInvalidValue);
  probe_window_add_kernel<<<blocks_for(n_ids), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<float4*>(arr), windows, k, row_bytes / 16,
      static_cast<const float4*>(deltas), ids, n_ids);
  return static_cast<int>(cudaGetLastError());
}

const char* mmlrec_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
