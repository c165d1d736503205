// Row kernels of the embedding-table update, written for Hopper (sm_90a).
//
// They replace seven Pallas kernels of the JAX package.  Four carry the
// two-phase SparseAdam step:
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
// and three are library functions of the package's ops/ (its trainer calls
// none of them), each a __global__ function of its own further down:
//
//   row_gather_staged_kernel    <- ops/pallas_gather.py::pallas_row_gather
//                                  (:39): the gather with its rows staged in
//                                  shared memory and stored as blocks
//   rows_write_pipelined_kernel <- ops/pallas_scatter.py::
//                                  pallas_rows_write_pipelined (:349): the
//                                  write with double-buffered value chunks
//   rows_update_kernel          <- ops/pallas_scatter.py::pallas_rows_update
//                                  (:397) and pallas_rows_add (:479): the
//                                  fused read-modify-write
//
// The first four are pure row copies: each touched row is read once and written
// once, so each is bound by memory traffic (a 512-byte row per id and plane
// at the production width of 128 f32 lanes).  On the TPU each row was one
// DMA issued by the scalar core.  Here the writes give one warp a slot, its
// 32 lanes on neighbouring 16-byte words (a 512-byte row is one uint4 per
// lane), and a block of 8 warps takes 8 consecutive slots; the gather's
// design is set out at rows_gather_kernel.  Duplicate ids are legal in the
// gathers (reads do not race); the writes rely on the caller's contract that
// ids are unique inside the window.
//
// rows_update is bound by bytes too (old row and delta read, new row written).
// A group of lanes takes a slot (a whole warp for a 128-wide f32 row, half a
// warp for a 128-wide bf16 row), with one wide access per operand and lane
// on every pair of element types: a lane owns 4 consecutive elements of a
// 4-byte pair (16 bytes per operand) and kLaneElems elements where a bf16
// operand takes part (16 bytes of the bf16 operand, 2 x 16 of an f32 one,
// at 8); the N sums of a lane are rounded to bf16 in integer arithmetic and
// packed into one store, a bf16 "set" is a select on packed 16-bit lanes.
// The wide path needs the row width to be a multiple of the lane's run and
// every row address (array, deltas, mask: base and row stride) to be aligned
// to the access, min(16, run x element size) bytes; the wrapper decides that
// per array from the shapes and addresses.  Every other array takes the path
// of one element a lane.  Both give the same bits.
//
// Windows: the gathers and writes take the window [lo, hi) from DEVICE
// memory (lo_p / hi_p; a null pointer means 0 / K), so the host never waits
// for the step's unique-row count.  A gather stores nothing outside the
// window (those slots of its output stay as torch.empty left them, as the
// TPU kernel leaves them uninitialised: pallas_gather.py:186-192), and
// writes the poison pattern (NaN, or int-min for integers) for an id outside
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

// Row groups a warp of rows_gather_kernel takes a pass (1, 2, 4, 8, 16 or
// 32): each lane keeps planes x this many loads in flight before its first
// store.  ops/row_gather.py mirrors it as _GATHER_SLOTS_PER_PASS.
#ifndef MMLREC_GATHER_SLOTS_PER_PASS
#define MMLREC_GATHER_SLOTS_PER_PASS 4
#endif
constexpr int kGatherPass = MMLREC_GATHER_SLOTS_PER_PASS;
static_assert(kGatherPass >= 1 && kGatherPass <= 32 &&
                  (kGatherPass & (kGatherPass - 1)) == 0,
              "a power of two from 1 to 32 row groups a pass");
// 1: the gather's stores are streaming stores (st.global.cs, evict first);
// 0: default write-back stores.  tools/tune_kernels.py --only gather times
// both (each with 2-16 row groups a pass and 2-8 blocks an SM); streaming
// stores with 4 groups and 8 blocks an SM came out fastest over B1's full
// and window modes and B4, by about 1% (PERF.md, PR 17).
#ifndef MMLREC_GATHER_STREAMING_STORES
#define MMLREC_GATHER_STREAMING_STORES 1
#endif

// Elements a lane owns on the wide path of rows_update where a bf16 operand
// takes part (4, 8 or 16); ops/row_scatter.py mirrors it as _LANE_ELEMS.
#ifndef MMLREC_UPDATE_LANE_ELEMS
#define MMLREC_UPDATE_LANE_ELEMS 8
#endif
constexpr int kLaneElems = MMLREC_UPDATE_LANE_ELEMS;
static_assert(kLaneElems == 4 || kLaneElems == 8 || kLaneElems == 16,
              "a lane owns 4, 8 or 16 elements");

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

// The poison of unit e of a row: the 32-bit pattern in every word, and for
// byte units byte e % 4 of it (little-endian, rows start on an element).
template <typename T>
__device__ __forceinline__ T poison_unit(uint32_t p, long long e);
template <>
__device__ __forceinline__ uint4 poison_unit<uint4>(uint32_t p, long long) {
  return make_uint4(p, p, p, p);
}
template <>
__device__ __forceinline__ uint32_t poison_unit<uint32_t>(uint32_t p, long long) {
  return p;
}
template <>
__device__ __forceinline__ unsigned char poison_unit<unsigned char>(uint32_t p,
                                                                    long long e) {
  return static_cast<unsigned char>(p >> (8 * (e & 3)));
}

template <typename T>
__device__ __forceinline__ void gather_store(T* p, T v) {
#if MMLREC_GATHER_STREAMING_STORES
  __stcs(p, v);
#else
  *p = v;
#endif
}

// out[p, k] = src[p, ids[k]] for every plane p and slot k in [lo, hi) (the
// poison row for an id outside the table); no other slot is stored.
//
// Replaces ops/pallas_gather.py::pallas_rows_gather_dual (:171; 2 planes,
// the [lo, hi) window of n_real / bounds) and ::pallas_rows_gather_hbm (:90;
// 1 plane, no window).  Bound by bytes: the window's ids, and each of its
// rows read once and written once (2 x 512 B a slot at 128 f32 lanes).
// What a warp moves per chain of dependent loads (the window, the ids, then
// the rows) decides the time, so:
//
// * the grid is sized to the card, not to K (the wrapper passes the blocks,
//   a few per SM), and its warps stride over [lo, hi) alone: a shard's
//   launch does no work for slots outside its window;
// * a pass of a warp takes kGatherPass row groups: their ids are loaded
//   first, one per lane, and broadcast with __shfl_sync; then every load of
//   both planes of all of them is issued on the read-only path (__ldg; out
//   never aliases src, as the wrapper checks) before the first store, so a
//   lane has 2 x kGatherPass 16-byte loads in flight;
// * a row takes 2^lane_shift neighbouring lanes, the fewest that cover it in
//   one access each (at most a warp, looping over wider rows), so a narrow
//   row leaves no lane idle: a group of 32 >> lane_shift rows fills the warp.
//   At 512 B a row a lane moves one uint4 a plane a row group.  A warp's
//   pass is min(kGatherPass, 2^lane_shift) groups, at most 32 slots, so one
//   id per lane suffices.
//
// T is the widest unit every address allows (uint4, uint32_t or a byte; one
// body each, chosen once per launch); row offsets are 64-bit (a plane of the
// 40 M-row container is 5.1 GB).
template <typename T, int PLANES>
__device__ __forceinline__ void gather_rows(
    const T* __restrict__ src, T* __restrict__ out, long long rows,
    long long row_units, long long src_plane, long long out_plane,
    int lane_shift, uint32_t poison, const int* __restrict__ ids, int lo,
    int hi) {
  const int lane = threadIdx.x & 31;
  const int lanes = 1 << lane_shift;          // lanes a row
  const int group_rows = 32 >> lane_shift;    // rows a group
  const int row_in_group = lane >> lane_shift;
  const int sub = lane & (lanes - 1);
  const int groups = kGatherPass < lanes ? kGatherPass : lanes;
  const int per_pass = groups * group_rows;  // slots a pass, at most 32
  const long long warp = (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  const long long warps = (static_cast<long long>(gridDim.x) * kThreads) >> 5;
  for (long long base = lo + warp * per_pass; base < hi; base += warps * per_pass) {
    // no id is read at or past hi (<= the slot count)
    const int mine = (lane < per_pass && base + lane < hi) ? __ldg(ids + base + lane) : 0;
    long long r[kGatherPass];  // the source row; -1 the poison; -2 not stored
#pragma unroll
    for (int j = 0; j < kGatherPass; ++j) {
      const int q = j * group_rows + row_in_group;
      const int id = __shfl_sync(0xffffffffu, mine, q & 31);
      r[j] = (j < groups && base + q < hi) ? resolve(id, rows) : -2;
    }
    for (long long e = sub; e < row_units; e += lanes) {
      T v[kGatherPass][PLANES];
#pragma unroll
      for (int j = 0; j < kGatherPass; ++j) {
#pragma unroll
        for (int p = 0; p < PLANES; ++p) {
          v[j][p] = r[j] >= 0 ? __ldg(src + p * src_plane + r[j] * row_units + e)
                              : poison_unit<T>(poison, e);
        }
      }
#pragma unroll
      for (int j = 0; j < kGatherPass; ++j) {
        if (r[j] == -2) continue;
        const long long slot = base + j * group_rows + row_in_group;
#pragma unroll
        for (int p = 0; p < PLANES; ++p)
          gather_store(out + p * out_plane + slot * row_units + e, v[j][p]);
      }
    }
  }
}

template <typename T>
__device__ __forceinline__ void gather_unit(
    const char* src, char* out, long long rows, long long row_bytes,
    long long src_plane, long long out_plane, int planes, int lane_shift,
    uint32_t poison, const int* ids, int lo, int hi) {
  const long long u = sizeof(T);
  const T* s = reinterpret_cast<const T*>(src);
  T* o = reinterpret_cast<T*>(out);
  if (planes == 2) {
    gather_rows<T, 2>(s, o, rows, row_bytes / u, src_plane / u, out_plane / u,
                      lane_shift, poison, ids, lo, hi);
  } else {
    gather_rows<T, 1>(s, o, rows, row_bytes / u, src_plane / u, out_plane / u,
                      lane_shift, poison, ids, lo, hi);
  }
}

__global__ void __launch_bounds__(kThreads)
rows_gather_kernel(const char* __restrict__ src, char* __restrict__ out,
                   long long rows, long long row_bytes, long long src_plane,
                   long long out_plane, int planes, long long unit,
                   int lane_shift, uint32_t poison, const int* __restrict__ ids,
                   int n_slots, const int* lo_p, const int* hi_p) {
  int lo, hi;
  read_window(lo_p, hi_p, n_slots, lo, hi);
  if (lo < 0) lo = 0;
  if (hi > n_slots) hi = n_slots;
  if (unit == 16) {
    gather_unit<uint4>(src, out, rows, row_bytes, src_plane, out_plane, planes,
                       lane_shift, poison, ids, lo, hi);
  } else if (unit == 4) {
    gather_unit<uint32_t>(src, out, rows, row_bytes, src_plane, out_plane,
                          planes, lane_shift, poison, ids, lo, hi);
  } else {
    gather_unit<unsigned char>(src, out, rows, row_bytes, src_plane, out_plane,
                               planes, lane_shift, poison, ids, lo, hi);
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

// ---------------------------------------------------------------------------
// Asynchronous copies into shared memory (cp.async): 16 bytes bypass L1
// (.cg), 4 bytes go through it (.ca; .cg takes 16 only).
// ---------------------------------------------------------------------------
__device__ __forceinline__ void cp_async_16(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_4(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's commit groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The warp starts the copy of `bytes` from global src into shared dst, in
// units of `unit` bytes; a unit of 1 has no asynchronous form and is copied
// with plain loads and stores.
__device__ __forceinline__ void warp_stage(unsigned char* dst, const char* src,
                                           long long bytes, long long unit,
                                           int lane) {
  if (unit == 16) {
    for (long long i = lane; i < (bytes >> 4); i += 32)
      cp_async_16(dst + (i << 4), src + (i << 4));
  } else if (unit == 4) {
    for (long long i = lane; i < (bytes >> 2); i += 32)
      cp_async_4(dst + (i << 2), src + (i << 2));
  } else {
    for (long long i = lane; i < bytes; i += 32) dst[i] = src[i];
  }
}

__device__ __forceinline__ long long round16(long long x) {
  return (x + 15) & ~15LL;
}

// out[k] = table[ids[k]], staged: a block takes `slots_per_block` consecutive
// slots, brings their rows into shared memory with cp.async (poison rows for
// ids outside the table are written there directly), and then stores the
// whole chunk as one contiguous stretch, every thread on the 16 bytes after
// its neighbour's.  rows_gather_kernel above is the other design of the same
// gather (rows through registers, many loads in flight a lane); the two are
// timed side by side.
__global__ void __launch_bounds__(kThreads)
row_gather_staged_kernel(const char* __restrict__ table, char* __restrict__ out,
                         long long rows, long long row_bytes, long long unit,
                         uint32_t poison, const int* __restrict__ ids,
                         int n_slots, int slots_per_block) {
  extern __shared__ __align__(16) unsigned char stage[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long first = static_cast<long long>(blockIdx.x) * slots_per_block;
  const long long left = n_slots - first;
  const int n = left < slots_per_block ? static_cast<int>(left) : slots_per_block;
  for (int j = warp; j < n; j += kSlotsPerBlock) {
    const long long r = resolve(ids[first + j], rows);
    unsigned char* dst = stage + j * row_bytes;
    if (r >= 0) {
      warp_stage(dst, table + r * row_bytes, row_bytes, unit, lane);
    } else {
      warp_fill(reinterpret_cast<char*>(dst), row_bytes, unit, poison, lane);
    }
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  char* o = out + first * row_bytes;
  const long long total = n * row_bytes;
  if (unit == 16) {
    uint4* d = reinterpret_cast<uint4*>(o);
    const uint4* s = reinterpret_cast<const uint4*>(stage);
    for (long long i = threadIdx.x; i < (total >> 4); i += kThreads) d[i] = s[i];
  } else {
    uint32_t* d = reinterpret_cast<uint32_t*>(o);
    const uint32_t* s = reinterpret_cast<const uint32_t*>(stage);
    for (long long i = threadIdx.x; i < (total >> 2); i += kThreads) d[i] = s[i];
  }
}

// The write of rows_write_kernel with its values staged: a persistent block
// walks over chunks of `chunk` slots (the loop takes the place of the TPU
// kernel's sequential grid).  While the rows of chunk c are stored from one
// shared-memory buffer into the arrays, the values of the block's next chunk
// arrive in the other (cp.async, one commit group per chunk).  Only slots in
// [lo, hi) are staged and stored, and the id's range is checked before the id
// becomes an address, exactly as in rows_write_kernel.  Each array's region
// of a buffer starts on a 16-byte boundary.
__global__ void __launch_bounds__(kThreads)
rows_write_pipelined_kernel(const WriteArgs w, const int* __restrict__ ids,
                            int n_slots, int chunk, int n_chunks,
                            long long buffer_bytes, const int* lo_p,
                            const int* hi_p) {
  extern __shared__ __align__(16) unsigned char stage[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  int lo, hi;
  read_window(lo_p, hi_p, n_slots, lo, hi);
  if (hi > n_slots) hi = n_slots;

  auto stage_chunk = [&](int c, unsigned char* buf) {
    const long long c0 = static_cast<long long>(c) * chunk;
    if (c0 >= hi || c0 + chunk <= lo) return;  // no slot of it is in the window
    long long off = 0;
    for (int i = 0; i < w.n; ++i) {
      const WriteArray& a = w.a[i];
      for (int j = warp; j < chunk; j += kSlotsPerBlock) {
        const long long slot = c0 + j;
        if (slot < lo || slot >= hi) continue;
        warp_stage(buf + off + j * a.row_bytes,
                   reinterpret_cast<const char*>(a.src) + slot * a.src_row,
                   a.row_bytes, a.unit, lane);
      }
      off += round16(chunk * a.row_bytes);
    }
  };

  auto store_chunk = [&](int c, const unsigned char* buf) {
    const long long c0 = static_cast<long long>(c) * chunk;
    if (c0 >= hi || c0 + chunk <= lo) return;
    for (int j = warp; j < chunk; j += kSlotsPerBlock) {
      const long long slot = c0 + j;
      if (slot < lo || slot >= hi) continue;  // pads and other windows
      const long long id = ids[slot];
      long long off = 0;
      for (int i = 0; i < w.n; ++i) {
        const WriteArray& a = w.a[i];
        const long long r = resolve(id, a.rows);  // checked BEFORE any address
        if (r >= 0) {
          warp_copy(reinterpret_cast<char*>(a.dst) + r * a.row_bytes,
                    reinterpret_cast<const char*>(buf) + off + j * a.row_bytes,
                    a.row_bytes, a.unit, lane);
        }
        off += round16(chunk * a.row_bytes);
      }
    }
  };

  int c = blockIdx.x;
  int b = 0;
  if (c < n_chunks) stage_chunk(c, stage);
  cp_async_commit();
  for (; c < n_chunks; c += gridDim.x) {
    const int next = c + gridDim.x;
    if (next < n_chunks) stage_chunk(next, stage + (b ^ 1) * buffer_bytes);
    cp_async_commit();   // possibly empty: one group per iteration
    cp_async_wait<1>();  // all but the newest group: chunk c has landed
    __syncthreads();
    store_chunk(c, stage + b * buffer_bytes);
    __syncthreads();  // this buffer is staged again in the next iteration
    b ^= 1;
  }
  cp_async_wait<0>();
}

// One array of a read-modify-write; every field a 64-bit integer, as in
// WriteArray.  `kind` and `delta_kind`: 0 = float32, 1 = bfloat16, 2 = opaque
// 32-bit lanes (int32; "set" only).
struct UpdateArray {
  long long dst;         // address of row 0 of the array
  long long delta;       // address of delta (or set-value) row 0
  long long mask;        // address of mask row 0 ("set"), else 0
  long long rows;        // rows of the array
  long long width;       // elements of one row
  long long delta_row;   // bytes between consecutive delta rows
  long long mask_row;    // bytes between consecutive mask rows
  long long mode;        // 0 = "add", 1 = "set"
  long long kind;        // element type of the array (and of the mask)
  long long delta_kind;  // element type of the deltas
  long long vec;         // 1: width and every address allow the wide path
};

struct UpdateArgs {
  UpdateArray a[kMaxArrays];
  long long n;
};

// f32 -> the 16 bits of its round-to-nearest-even bfloat16 in integer
// arithmetic: denormals keep their bits, a NaN becomes the quiet NaN of its
// sign (0x7FC0 / 0xFFC0), as XLA's convert does.  (__float2bfloat16_rn
// writes 0x7FFF for every NaN.)
__device__ __forceinline__ uint32_t bf16_bits_rne(float x) {
  const uint32_t b = __float_as_uint(x);
  if ((b & 0x7FFFFFFFu) > 0x7F800000u) return ((b >> 16) & 0x8000u) | 0x7FC0u;
  return ((b + 0x7FFFu + ((b >> 16) & 1u)) >> 16) & 0xFFFFu;
}

// ---- one element a lane: the path of rows whose width or addresses allow
// no wide access.  The element types are template parameters, so no loop
// below branches on a type.
template <bool kBf16>
__device__ __forceinline__ float load_one(const char* p, int e) {
  if constexpr (kBf16) {
    return __uint_as_float(
        static_cast<uint32_t>(reinterpret_cast<const unsigned short*>(p)[e]) << 16);
  } else {
    return reinterpret_cast<const float*>(p)[e];
  }
}

template <bool kRowBf16, bool kDeltaBf16>
__device__ __forceinline__ void add_scalar(char* row, const char* d, int width,
                                           int lane, int lanes) {
  for (int e = lane; e < width; e += lanes) {
    const float sum = load_one<kRowBf16>(row, e) + load_one<kDeltaBf16>(d, e);
    if constexpr (kRowBf16) {
      reinterpret_cast<unsigned short*>(row)[e] =
          static_cast<unsigned short>(bf16_bits_rne(sum));
    } else {
      reinterpret_cast<float*>(row)[e] = sum;
    }
  }
}

// T = unsigned short or uint32_t; abs_mask drops the sign bit of a float
// mask so that -0.0 compares as zero.
template <typename T>
__device__ __forceinline__ void set_scalar(char* row, const char* d,
                                           const char* m, T abs_mask, int width,
                                           int lane, int lanes) {
  T* o = reinterpret_cast<T*>(row);
  const T* dv = reinterpret_cast<const T*>(d);
  const T* mv = reinterpret_cast<const T*>(m);
  for (int e = lane; e < width; e += lanes)
    if (mv[e] & abs_mask) o[e] = dv[e];
}

// ---- N consecutive elements a lane, one access of up to 16 bytes per
// operand.  WORDS 32-bit words at p (aligned to 4 * WORDS bytes, at most 16
// per access).
template <int WORDS>
__device__ __forceinline__ void load_words(const char* p, uint32_t (&w)[WORDS]) {
  static_assert(WORDS == 2 || WORDS % 4 == 0, "8 bytes, or a multiple of 16");
  if constexpr (WORDS == 2) {
    const uint2 t = *reinterpret_cast<const uint2*>(p);
    w[0] = t.x, w[1] = t.y;
  } else {
#pragma unroll
    for (int i = 0; i < WORDS / 4; ++i) {
      const uint4 t = reinterpret_cast<const uint4*>(p)[i];
      w[4 * i] = t.x, w[4 * i + 1] = t.y, w[4 * i + 2] = t.z, w[4 * i + 3] = t.w;
    }
  }
}

template <int WORDS>
__device__ __forceinline__ void store_words(char* p, const uint32_t (&w)[WORDS]) {
  if constexpr (WORDS == 2) {
    *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
  } else {
#pragma unroll
    for (int i = 0; i < WORDS / 4; ++i)
      reinterpret_cast<uint4*>(p)[i] =
          make_uint4(w[4 * i], w[4 * i + 1], w[4 * i + 2], w[4 * i + 3]);
  }
}

// Elements [e, e + N) of a row as f32.  A bf16 pair shares one word in
// little-endian order: element 2i is the low half of word i, element 2i + 1
// the high half.
template <int N, bool kBf16>
__device__ __forceinline__ void load_lane(const char* p, int e, float (&v)[N]) {
  if constexpr (kBf16) {
    uint32_t w[N / 2];
    load_words<N / 2>(p + 2 * e, w);
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
    }
  } else {
    uint32_t w[N];
    load_words<N>(p + 4 * e, w);
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = __uint_as_float(w[i]);
  }
}

template <int N, bool kBf16>
__device__ __forceinline__ void store_lane(char* p, int e, const float (&v)[N]) {
  if constexpr (kBf16) {
    uint32_t w[N / 2];
#pragma unroll
    for (int i = 0; i < N / 2; ++i)
      w[i] = bf16_bits_rne(v[2 * i]) | (bf16_bits_rne(v[2 * i + 1]) << 16);
    store_words<N / 2>(p + 2 * e, w);
  } else {
    uint32_t w[N];
#pragma unroll
    for (int i = 0; i < N; ++i) w[i] = __float_as_uint(v[i]);
    store_words<N>(p + 4 * e, w);
  }
}

// row[e] = row[e] + d[e], N elements a lane: both operands are loaded
// before the first add, the sums run in f32, and the N results are rounded
// and packed into one store.
template <int N, bool kRowBf16, bool kDeltaBf16>
__device__ __forceinline__ void add_wide(char* __restrict__ row,
                                         const char* __restrict__ d, int width,
                                         int lane, int lanes) {
  for (int e = lane * N; e < width; e += lanes * N) {
    float o[N], dv[N];
    load_lane<N, kRowBf16>(row, e, o);
    load_lane<N, kDeltaBf16>(d, e, dv);
#pragma unroll
    for (int i = 0; i < N; ++i) o[i] = o[i] + dv[i];
    store_lane<N, kRowBf16>(row, e, o);
  }
}

// where(mask != 0, d, row) on 32-bit payloads, 4 a lane.
__device__ __forceinline__ void set_wide32(char* __restrict__ row,
                                           const char* __restrict__ d,
                                           const char* __restrict__ m,
                                           uint32_t abs_mask, int width, int lane,
                                           int lanes) {
  for (int e = lane * 4; e < width; e += lanes * 4) {
    uint32_t o[4], dv[4], mv[4];
    load_words<4>(row + 4 * e, o);
    load_words<4>(d + 4 * e, dv);
    load_words<4>(m + 4 * e, mv);
#pragma unroll
    for (int i = 0; i < 4; ++i) o[i] = (mv[i] & abs_mask) ? dv[i] : o[i];
    store_words<4>(row + 4 * e, o);
  }
}

// The same select on bf16 payloads, N a lane, two 16-bit lanes per word;
// each half of the mask is compared as a value (& 0x7FFF).
template <int N>
__device__ __forceinline__ void set_wide16(char* __restrict__ row,
                                           const char* __restrict__ d,
                                           const char* __restrict__ m, int width,
                                           int lane, int lanes) {
  for (int e = lane * N; e < width; e += lanes * N) {
    uint32_t o[N / 2], dv[N / 2], mv[N / 2];
    load_words<N / 2>(row + 2 * e, o);
    load_words<N / 2>(d + 2 * e, dv);
    load_words<N / 2>(m + 2 * e, mv);
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const uint32_t take = ((mv[i] & 0x00007FFFu) ? 0x0000FFFFu : 0u) |
                            ((mv[i] & 0x7FFF0000u) ? 0xFFFF0000u : 0u);
      o[i] = (dv[i] & take) | (o[i] & ~take);
    }
    store_words<N / 2>(row + 2 * e, o);
  }
}

// arrays[a][clamp(ids[k])] = f(old row, deltas[a][k]) for every array a and
// slot k < n_real, in one pass: "add" is old + delta in f32, stored in the
// array's type; "set" is where(mask != 0, delta, old) on the bits of the
// payload (the mask compared as a value: -0.0 is zero, a NaN is not).
//
// A group of `1 << lane_shift` neighbouring lanes takes one slot and walks
// the arrays; the wrapper picks the smallest group that covers the widest
// row in one pass, so a warp holds 32 >> lane_shift slots.  A slot's work is
// a chain of dependent loads (n_real and the id, then the rows, then the
// store), so what a warp moves per chain decides the kernel's time: at 8
// elements a lane a 128-wide bf16 row is one 16-byte access of 16 lanes,
// and a warp carries two slots through each chain.  Per array the wrapper
// says whether every address allows the wide path (`vec`); the pair of
// element types is dispatched once per array, outside the element loops.  On
// the wide path a lane owns a run of consecutive elements: 4 for 4-byte
// pairs (16 bytes per operand), kLaneElems where a bf16 operand takes part.
// A wide "set" rewrites the whole word (old bits where the mask is zero):
// the row is this slot's alone.  Slots >= n_real are left alone EXACTLY:
// -0.0 + 0.0 is +0.0, so a pad slot that were processed with a zero delta
// could change bits.  Ids must be unique below n_real.
__global__ void __launch_bounds__(kThreads)
rows_update_kernel(const UpdateArgs u, const int* __restrict__ ids, int n_slots,
                   const int* n_real_p, int lane_shift) {
  const long long thread = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long slot = thread >> lane_shift;
  const int lanes = 1 << lane_shift;
  const int lane = threadIdx.x & (lanes - 1);
  if (slot >= n_slots) return;
  const int n_real = n_real_p ? *n_real_p : n_slots;
  if (slot >= n_real) return;
  const long long id = ids[slot];
  for (int i = 0; i < u.n; ++i) {
    const UpdateArray& a = u.a[i];
    const long long r = id < 0 ? 0 : (id >= a.rows ? a.rows - 1 : id);
    const bool row16 = a.kind == 1, delta16 = a.delta_kind == 1;
    const int width = static_cast<int>(a.width);
    const bool wide = a.vec != 0;
    char* row = reinterpret_cast<char*>(a.dst) + r * a.width * (row16 ? 2 : 4);
    const char* d = reinterpret_cast<const char*>(a.delta) + slot * a.delta_row;
    if (a.mode == 1) {  // "set": a select on bits, no arithmetic
      const char* m = reinterpret_cast<const char*>(a.mask) + slot * a.mask_row;
      if (row16) {
        if (wide) set_wide16<kLaneElems>(row, d, m, width, lane, lanes);
        else set_scalar<unsigned short>(row, d, m, 0x7FFFu, width, lane, lanes);
      } else {
        const uint32_t abs_mask = a.kind == 0 ? 0x7FFFFFFFu : 0xFFFFFFFFu;
        if (wide) set_wide32(row, d, m, abs_mask, width, lane, lanes);
        else set_scalar<uint32_t>(row, d, m, abs_mask, width, lane, lanes);
      }
    } else if (!row16 && !delta16) {  // f32 += f32
      if (wide) add_wide<4, false, false>(row, d, width, lane, lanes);
      else add_scalar<false, false>(row, d, width, lane, lanes);
    } else if (!row16) {  // f32 += bf16
      if (wide) add_wide<kLaneElems, false, true>(row, d, width, lane, lanes);
      else add_scalar<false, true>(row, d, width, lane, lanes);
    } else if (!delta16) {  // bf16 += f32: the sum in f32, rounded once
      if (wide) add_wide<kLaneElems, true, false>(row, d, width, lane, lanes);
      else add_scalar<true, false>(row, d, width, lane, lanes);
    } else {  // bf16 += bf16
      if (wide) add_wide<kLaneElems, true, true>(row, d, width, lane, lanes);
      else add_scalar<true, true>(row, d, width, lane, lanes);
    }
  }
}

unsigned blocks_for(int n_slots) {
  return static_cast<unsigned>((n_slots + kSlotsPerBlock - 1) / kSlotsPerBlock);
}

}  // namespace

extern "C" {

// `blocks` persistent blocks (the wrapper sizes them to the card); `unit`
// 16, 4 or 1 divides row_bytes and both planes' sizes.
int mmlrec_rows_gather(const void* src, void* out, long long rows,
                       long long row_bytes, long long src_plane,
                       long long out_plane, int planes, long long unit,
                       unsigned poison, const int* ids, int n_slots,
                       const int* lo_p, const int* hi_p, int blocks,
                       void* stream) {
  if ((unit != 16 && unit != 4 && unit != 1) || (planes != 1 && planes != 2) ||
      blocks < 1 || row_bytes % unit || src_plane % unit || out_plane % unit)
    return static_cast<int>(cudaErrorInvalidValue);
  int lane_shift = 0;  // the fewest lanes (a power of two) that cover a row
  while ((1LL << lane_shift) < row_bytes / unit && lane_shift < 5) ++lane_shift;
  rows_gather_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const char*>(src), static_cast<char*>(out), rows, row_bytes,
      src_plane, out_plane, planes, unit, lane_shift, poison, ids, n_slots,
      lo_p, hi_p);
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

// The staged gather; `smem` = slots_per_block * row_bytes (at most 48 KB).
int mmlrec_row_gather_staged(const void* table, void* out, long long rows,
                             long long row_bytes, long long unit,
                             unsigned poison, const int* ids, int n_slots,
                             int slots_per_block, void* stream) {
  if (slots_per_block < 1 || unit == 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long smem = slots_per_block * row_bytes;
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks =
      static_cast<unsigned>((n_slots + slots_per_block - 1) / slots_per_block);
  row_gather_staged_kernel<<<blocks, kThreads, static_cast<size_t>(smem),
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const char*>(table), static_cast<char*>(out), rows, row_bytes,
      unit, poison, ids, n_slots, slots_per_block);
  return static_cast<int>(cudaGetLastError());
}

// The pipelined write; `args` as for mmlrec_rows_write (one plane per array),
// `chunk` slots per stage, `blocks` persistent blocks.
int mmlrec_rows_write_pipelined(const long long* args, const int* ids,
                                int n_slots, int chunk, int blocks,
                                const int* lo_p, const int* hi_p,
                                void* stream) {
  WriteArgs w;
  memcpy(&w, args, sizeof(WriteArgs));
  if (w.n < 1 || w.n > kMaxArrays || chunk < 1 || blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  long long buffer_bytes = 0;
  for (int i = 0; i < w.n; ++i) {
    if (w.a[i].planes != 1) return static_cast<int>(cudaErrorInvalidValue);
    buffer_bytes += (chunk * w.a[i].row_bytes + 15) & ~15LL;
  }
  if (2 * buffer_bytes > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  const int n_chunks = (n_slots + chunk - 1) / chunk;
  const int grid = blocks < n_chunks ? blocks : n_chunks;
  rows_write_pipelined_kernel<<<static_cast<unsigned>(grid), kThreads,
                                static_cast<size_t>(2 * buffer_bytes),
                                static_cast<cudaStream_t>(stream)>>>(
      w, ids, n_slots, chunk, n_chunks, buffer_bytes, lo_p, hi_p);
  return static_cast<int>(cudaGetLastError());
}

// `args` is a host array of 11 * kMaxArrays + 1 long longs laid out as
// UpdateArgs; `lanes_per_slot` (a power of two up to 32) lanes take one slot.
int mmlrec_rows_update(const long long* args, const int* ids, int n_slots,
                       const int* n_real_p, int lanes_per_slot, void* stream) {
  UpdateArgs u;
  static_assert(sizeof(UpdateArgs) == sizeof(long long) * (11 * kMaxArrays + 1),
                "UpdateArgs must be a flat array of long longs");
  memcpy(&u, args, sizeof(UpdateArgs));
  if (u.n < 1 || u.n > kMaxArrays) return static_cast<int>(cudaErrorInvalidValue);
  int lane_shift = 0;
  while ((1 << lane_shift) < lanes_per_slot) ++lane_shift;
  if (lanes_per_slot < 1 || lanes_per_slot > 32 || (1 << lane_shift) != lanes_per_slot)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long threads = static_cast<long long>(n_slots) << lane_shift;
  const unsigned blocks = static_cast<unsigned>((threads + kThreads - 1) / kThreads);
  rows_update_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      u, ids, n_slots, n_real_p, lane_shift);
  return static_cast<int>(cudaGetLastError());
}

const char* mmlrec_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
