// Row kernels of the two-phase SparseAdam step, written for Hopper (sm_90a).
//
// They replace four Pallas kernels of the JAX package:
//
//   rows_gather  <- ops/pallas_gather.py::pallas_rows_gather_dual (:171)
//                   (planes = 2, optional [lo, hi) window) and
//                   ops/pallas_gather.py::pallas_rows_gather_hbm (:90)
//                   (planes = 1, no window)
//   rows_write   <- ops/pallas_scatter.py::pallas_rows_write_dual (:532)
//                   (one array of 2 planes) and
//                   ops/pallas_scatter.py::pallas_rows_write (:194)
//                   (up to kMaxArrays arrays of 1 plane each)
//
// All four are pure row copies: each touched row is read once and written
// once, so each is bound by memory traffic (a 512-byte row per id and plane
// at the production width of 128 f32 lanes).  On the TPU each row was one
// DMA issued by the scalar core; here one warp moves one slot's rows, its 32
// lanes on neighbouring 16-byte words (a 512-byte row is one uint4 per
// lane), and a block of 8 warps takes 8 consecutive slots.  Duplicate ids are
// legal in the gathers (reads do not race); the writes rely on the
// caller's contract that ids are unique inside the window.
//
// Windows: the gathers and writes take the window [lo, hi) from DEVICE
// memory (lo_p / hi_p; a null pointer means 0 / K), so the host never waits
// for the step's unique-row count.  A gather writes the poison pattern
// (NaN, or int-min for integers) outside the window and for an id outside
// [0, rows) after wrapping a negative id once, as jnp.take's fill mode does.
// A write drops every slot outside the window, and every id outside
// [0, rows) after the same wrap, BEFORE the id is used as an address: the
// step's device metadata pads its unique-row list with rows (one past the
// last row), and those slots must never be stored.
//
// Interface: plain C, called through ctypes from mmlrec_tpu_torch/ops/
// row_gather.py and row_scatter.py.  Each entry launches on the stream it is
// given, allocates nothing, never synchronises, and returns
// cudaGetLastError().
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC -o librow_kernels.so row_kernels.cu

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSlotsPerBlock = kThreads / 32;  // one warp per slot
constexpr int kMaxArrays = 8;

// One array of a write, as the wrapper lays it out: every field a 64-bit
// integer so that the host side is a flat array of long longs.
struct WriteArray {
  long long dst;        // address of row 0 of plane 0 of the array
  long long src;        // address of value row 0 of plane 0
  long long rows;       // rows of one plane of the array
  long long row_bytes;  // bytes of one row (array and values alike)
  long long src_row;    // bytes between consecutive value rows
  long long dst_plane;  // bytes between the array's planes
  long long src_plane;  // bytes between the values' planes
  long long planes;     // 1, or 2 for the stacked (table, moment) container
  long long unit;       // 16, 4 or 1: the widest copy every address allows
};

struct WriteArgs {
  WriteArray a[kMaxArrays];
  long long n;
};

__device__ __forceinline__ void read_window(const int* lo_p, const int* hi_p,
                                            int n_slots, int& lo, int& hi) {
  lo = lo_p ? *lo_p : 0;
  hi = hi_p ? *hi_p : n_slots;
}

// Wrap a negative id once; -1 for an id that is then outside [0, rows).
__device__ __forceinline__ long long resolve(long long r, long long rows) {
  if (r < 0) r += rows;
  return (r >= 0 && r < rows) ? r : -1;
}

template <typename T>
__device__ __forceinline__ void warp_copy_as(char* dst, const char* src,
                                             long long n, int lane) {
  T* d = reinterpret_cast<T*>(dst);
  const T* s = reinterpret_cast<const T*>(src);
  for (long long i = lane; i < n; i += 32) d[i] = s[i];
}

// The warp copies `bytes` from src to dst in units of `unit` bytes.
__device__ __forceinline__ void warp_copy(char* dst, const char* src,
                                          long long bytes, long long unit,
                                          int lane) {
  if (unit == 16) {
    warp_copy_as<uint4>(dst, src, bytes >> 4, lane);
  } else if (unit == 4) {
    warp_copy_as<uint32_t>(dst, src, bytes >> 2, lane);
  } else {
    warp_copy_as<unsigned char>(dst, src, bytes, lane);
  }
}

// The warp fills `bytes` (a multiple of 4) at dst with a 32-bit pattern.
__device__ __forceinline__ void warp_fill(char* dst, long long bytes,
                                          long long unit, uint32_t pattern,
                                          int lane) {
  if (unit == 16) {
    uint4* d = reinterpret_cast<uint4*>(dst);
    const uint4 v = make_uint4(pattern, pattern, pattern, pattern);
    for (long long i = lane; i < (bytes >> 4); i += 32) d[i] = v;
  } else {
    uint32_t* d = reinterpret_cast<uint32_t*>(dst);
    for (long long i = lane; i < (bytes >> 2); i += 32) d[i] = pattern;
  }
}

// out[p, k] = src[p, ids[k]] for every plane p, slot k in [lo, hi) and id
// inside the table; the poison pattern everywhere else.
__global__ void __launch_bounds__(kThreads)
rows_gather_kernel(const char* __restrict__ src, char* __restrict__ out,
                   long long rows, long long row_bytes, long long src_plane,
                   long long out_plane, int planes, long long unit,
                   uint32_t poison, const int* __restrict__ ids, int n_slots,
                   const int* lo_p, const int* hi_p) {
  const int slot = blockIdx.x * kSlotsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (slot >= n_slots) return;  // whole warps leave together
  int lo, hi;
  read_window(lo_p, hi_p, n_slots, lo, hi);
  const long long r =
      (slot >= lo && slot < hi) ? resolve(ids[slot], rows) : -1;
  for (int p = 0; p < planes; ++p) {
    char* dst = out + p * out_plane + static_cast<long long>(slot) * row_bytes;
    if (r >= 0) {
      warp_copy(dst, src + p * src_plane + r * row_bytes, row_bytes, unit,
                lane);
    } else {
      warp_fill(dst, row_bytes, unit, poison, lane);
    }
  }
}

// arrays[a][p, ids[k]] = values[a][p, k] for every array a, plane p and slot
// k in [lo, hi) whose id lies inside the array; nothing else is stored.
__global__ void __launch_bounds__(kThreads)
rows_write_kernel(const WriteArgs w, const int* __restrict__ ids, int n_slots,
                  const int* lo_p, const int* hi_p) {
  const int slot = blockIdx.x * kSlotsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (slot >= n_slots) return;
  int lo, hi;
  read_window(lo_p, hi_p, n_slots, lo, hi);
  if (slot < lo || slot >= hi) return;  // pads and other windows: untouched
  const long long id = ids[slot];
  for (int i = 0; i < w.n; ++i) {
    const WriteArray& a = w.a[i];
    const long long r = resolve(id, a.rows);  // checked BEFORE any address
    if (r < 0) continue;
    for (int p = 0; p < a.planes; ++p) {
      char* dst = reinterpret_cast<char*>(a.dst) + p * a.dst_plane +
                  r * a.row_bytes;
      const char* src = reinterpret_cast<const char*>(a.src) +
                        p * a.src_plane + slot * a.src_row;
      warp_copy(dst, src, a.row_bytes, a.unit, lane);
    }
  }
}

unsigned blocks_for(int n_slots) {
  return static_cast<unsigned>((n_slots + kSlotsPerBlock - 1) / kSlotsPerBlock);
}

}  // namespace

extern "C" {

int mmlrec_rows_gather(const void* src, void* out, long long rows,
                       long long row_bytes, long long src_plane,
                       long long out_plane, int planes, long long unit,
                       unsigned poison, const int* ids, int n_slots,
                       const int* lo_p, const int* hi_p, void* stream) {
  rows_gather_kernel<<<blocks_for(n_slots), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const char*>(src), static_cast<char*>(out), rows, row_bytes,
      src_plane, out_plane, planes, unit, poison, ids, n_slots, lo_p, hi_p);
  return static_cast<int>(cudaGetLastError());
}

// `args` is a host array of 9 * kMaxArrays + 1 long longs laid out as
// WriteArgs; it is copied into the launch's parameters.
int mmlrec_rows_write(const long long* args, const int* ids, int n_slots,
                      const int* lo_p, const int* hi_p, void* stream) {
  WriteArgs w;
  static_assert(sizeof(WriteArgs) == sizeof(long long) * (9 * kMaxArrays + 1),
                "WriteArgs must be a flat array of long longs");
  memcpy(&w, args, sizeof(WriteArgs));
  if (w.n < 1 || w.n > kMaxArrays) return static_cast<int>(cudaErrorInvalidValue);
  rows_write_kernel<<<blocks_for(n_slots), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(w, ids, n_slots,
                                                           lo_p, hi_p);
  return static_cast<int>(cudaGetLastError());
}

const char* mmlrec_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
