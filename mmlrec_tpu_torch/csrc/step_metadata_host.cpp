// The two-phase step's host metadata in one native pass a call, for the
// port's sparse_embedding.py::batch_step_metadata and staging.py's epoch
// builds.  The caller holds no interpreter lock while it runs (ctypes
// releases it) and the steps are spread over threads.
//
// For each step b of the call the pass
//   1. reads the step's K = B * F logical ids: id[j] = src[row(b, r), f] +
//      offsets[f] for j = r * F + f, with row(b, r) = rows[b * B + r]
//      (the epoch's rows of the ids matrix) or b * B + r without rows (the
//      flat [steps, K] ids), offsets 0 without offsets;
//   2. sorts the composite (id << idx_bits) | j.  Its keys are unique (the
//      position is in the low bits), so any correct sort gives numpy's
//      order; this one is an LSD radix sort over the bits of the step's
//      largest id alone: the keys start in position order and every pass
//      is stable;
//   3. runs the single fill pass of native/step_metadata.cpp's sm_fill over
//      the sorted keys: inv / rep; with pids, pinv / nuniq / prep and the
//      distinct untouched rows at pids' tail; with the route lists,
//      accperm, resid_pos / resid_slot and gdup_pos / gdup_tgt, their pads
//      written here too ((0, drop_slot), (0, drop_tgt); accperm 0).
//
// Each of the eleven outputs has a width: 4 (int32, or float for the
// masks rep and prep), 2 (uint16), 1 (uint8, the masks only) or 0 (not
// written), so the pass writes the upload form of the fit's codec
// (staging.py MetaCodec) as well as the raw arrays.  pids and nuniq are
// always int32.
//
// The gather route's list widths depend on the call's largest counts, so
// that route takes two calls on the caller's composite buffer: smh_sort
// (steps 1-2 and the counts), then smh_fill reading the sorted composite.
// Every other call is one smh_fill with a null composite, which keeps each
// step's keys in the thread's own buffers.
//
// Return codes: 0, or 1 when an id is at least 2^(63 - idx_bits) (the
// composite would overflow), or 2 when an id is negative; the outputs are
// then undefined.

#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr int kDigitBits = 11;
constexpr int kOutputs = 11;
constexpr int64_t kPrefetchRows = 16;

struct Source {
  const void* src;
  int32_t src_bytes;  // 4 (int32) or 8 (int64)
  int64_t stride;     // elements from one row of src to the next
  int64_t F;          // ids taken from each row
  const int64_t* offsets;
  const int64_t* rows;
  int64_t B;          // rows a step
  int32_t idx_bits;
};

// One step's composite keys, in position order, into keys[0, K); the
// step's largest id into *vmax.  Returns a return code.
template <typename T>
int32_t read_step(const Source& s, const T* src, int64_t b, int64_t* keys, int64_t* vmax) {
  const int64_t limit = int64_t(1) << (63 - s.idx_bits);
  int64_t hi = 0, lo = 0;
  int64_t j = 0;
  for (int64_t r = 0; r < s.B; ++r) {
    const int64_t row = s.rows ? s.rows[b * s.B + r] : b * s.B + r;
    if (s.rows && r + kPrefetchRows < s.B) {  // the epoch's rows lie anywhere in src
      const T* ahead = src + s.rows[b * s.B + r + kPrefetchRows] * s.stride;
      __builtin_prefetch(ahead);
      __builtin_prefetch(ahead + s.F - 1);
    }
    const T* p = src + row * s.stride;
    for (int64_t f = 0; f < s.F; ++f, ++j) {
      const int64_t v = int64_t(p[f]) + (s.offsets ? s.offsets[f] : 0);
      hi = v > hi ? v : hi;
      lo = v < lo ? v : lo;
      keys[j] = int64_t((uint64_t(v) << s.idx_bits) | uint64_t(j));
    }
  }
  *vmax = hi;
  if (lo < 0) return 2;
  return hi >= limit ? 1 : 0;
}

// Physical rows v / P, by a shift where P is a power of two (every pack
// factor the port makes), without a division a key.
struct PhysRow {
  int64_t P;
  int shift;
  explicit PhysRow(int64_t p) : P(p < 1 ? 1 : p), shift(-1) {
    if ((P & (P - 1)) == 0)
      for (shift = 0; (int64_t(1) << shift) < P; ++shift) {
      }
  }
  int64_t operator()(int64_t v) const { return shift >= 0 ? v >> shift : v / P; }
};

int bit_length(int64_t v) {
  int n = 0;
  while (v > 0) {
    ++n;
    v >>= 1;
  }
  return n;
}

// Stable LSD radix sort of keys[0, K) by bits [lo, lo + vbits), with tmp
// as the second buffer; returns the buffer that holds the sorted keys.
int64_t* radix_sort(int64_t* keys, int64_t* tmp, int64_t K, int lo, int vbits,
                    std::vector<uint32_t>& hist) {
  if (vbits <= 0 || K < 2) return keys;
  const int passes = (vbits + kDigitBits - 1) / kDigitBits;
  const int width = (vbits + passes - 1) / passes;
  const int64_t buckets = int64_t(1) << width;
  const int64_t mask = buckets - 1;
  hist.assign(size_t(passes * buckets), 0);
  for (int64_t j = 0; j < K; ++j) {
    const int64_t v = keys[j] >> lo;
    for (int p = 0; p < passes; ++p) ++hist[size_t(p * buckets + ((v >> (p * width)) & mask))];
  }
  int64_t* from = keys;
  int64_t* to = tmp;
  for (int p = 0; p < passes; ++p) {
    uint32_t* h = hist.data() + p * buckets;
    const int shift = lo + p * width;
    if (h[(from[0] >> shift) & mask] == uint32_t(K)) continue;  // one digit: in order
    uint32_t sum = 0;
    for (int64_t d = 0; d < buckets; ++d) {
      const uint32_t c = h[d];
      h[d] = sum;
      sum += c;
    }
    for (int64_t j = 0; j < K; ++j) {
      const int64_t k = from[j];
      to[h[(k >> shift) & mask]++] = k;
    }
    int64_t* t = from;
    from = to;
    to = t;
  }
  return from;
}

inline void put_index(void* base, int32_t width, int64_t i, int64_t v) {
  if (width == 4) static_cast<int32_t*>(base)[i] = int32_t(v);
  else if (width == 2) static_cast<uint16_t*>(base)[i] = uint16_t(v);
}

inline void put_mask(void* base, int32_t width, int64_t i, bool on) {
  if (width == 4) static_cast<float*>(base)[i] = on ? 1.0f : 0.0f;
  else if (width == 1) static_cast<uint8_t*>(base)[i] = on ? 1 : 0;
}

inline char* row_of(void* base, int32_t width, int64_t b, int64_t n) {
  return base && width ? static_cast<char*>(base) + b * n * width : nullptr;
}

// The counts of one sorted step: the gather route's pruned residuals and
// the non-first logical occurrences (sm_counts).
void count_step(const int64_t* c, int64_t K, int32_t idx_bits, int32_t P, int64_t* n_resid,
                int64_t* n_ldup) {
  const PhysRow phys_row(P);
  int64_t prev_v = -1, prev_pv = -1, nres = 0, nld = 0;
  for (int64_t j = 0; j < K; ++j) {
    const int64_t v = c[j] >> idx_bits;
    const int64_t pv = phys_row(v);
    const bool lnew = j == 0 || v != prev_v;
    const bool pnew = j == 0 || pv != prev_pv;
    if (lnew && !pnew) ++nres;
    if (!lnew) ++nld;
    prev_v = v;
    prev_pv = pv;
  }
  *n_resid = nres;
  *n_ldup = nld;
}

struct Fill {
  int64_t K, Kp, R_cap, G_cap, drop_slot, drop_tgt;
  int32_t idx_bits, P;
  void* out[kOutputs];
  int32_t width[kOutputs];
};

// The fill pass of one sorted step (sm_fill), every entry of each output
// row written.  The sorted scan writes what lies in sorted order (pids,
// accperm, the route lists) and one 8-byte record a position into rec:
// its first occurrence, its slot and whether it starts the slot; a second,
// sequential scan over the positions writes inv, rep, pinv and prep from
// the records, so the sorted scan's scattered writes go to one array.
// rec: K entries of scratch; present: Kp + 1 bytes of scratch.
void fill_step(const Fill& f, const int64_t* c, int64_t b, uint64_t* rec,
               std::vector<uint8_t>& present) {
  enum { INV, REP, PIDS, PINV, NUNIQ, PREP, ACC, RPOS, RSLOT, GPOS, GTGT };
  const int64_t K = f.K, Kp = f.Kp, R_cap = f.R_cap, G_cap = f.G_cap;
  const int32_t* w = f.width;
  void* inv = row_of(f.out[INV], w[INV], b, K);
  void* rep = row_of(f.out[REP], w[REP], b, K);
  int32_t* pids = reinterpret_cast<int32_t*>(row_of(f.out[PIDS], w[PIDS], b, Kp));
  void* pinv = row_of(f.out[PINV], w[PINV], b, K);
  void* prep = row_of(f.out[PREP], w[PREP], b, K);
  void* acc = row_of(f.out[ACC], w[ACC], b, Kp);
  void* rpos = row_of(f.out[RPOS], w[RPOS], b, R_cap);
  void* rslot = row_of(f.out[RSLOT], w[RSLOT], b, R_cap);
  void* gpos = row_of(f.out[GPOS], w[GPOS], b, G_cap);
  void* gtgt = row_of(f.out[GTGT], w[GTGT], b, G_cap);
  const bool phys = pids != nullptr;
  const int64_t idx_mask = (int64_t(1) << f.idx_bits) - 1;
  const PhysRow phys_row(f.P);
  if (phys) std::memset(present.data(), 0, present.size());
  int64_t prev_v = -1, prev_pv = -1, U = 0, nres = 0, nld = 0;
  int64_t cur_first = 0;
  for (int64_t j = 0; j < K; ++j) {
    const int64_t key = c[j];
    const int64_t ob = key & idx_mask;
    const int64_t v = key >> f.idx_bits;
    const int64_t pv = phys_row(v);
    const bool lnew = j == 0 || v != prev_v;
    const bool pnew = j == 0 || pv != prev_pv;
    if (lnew) cur_first = ob;
    if (phys) {
      if (pnew) {
        pids[U] = int32_t(pv);
        put_index(acc, w[ACC], U, ob);
        if (pv <= Kp) present[size_t(pv)] = 1;
        ++U;
      }
      if (lnew && !pnew && nres < R_cap) {
        put_index(rpos, w[RPOS], nres, ob);
        put_index(rslot, w[RSLOT], nres, U - 1);
        ++nres;
      }
      if (!lnew && nld < G_cap) {
        put_index(gpos, w[GPOS], nld, ob);
        put_index(gtgt, w[GTGT], nld, cur_first);
        ++nld;
      }
    }
    rec[ob] = uint64_t(cur_first) | uint64_t(U - 1) << 32 | uint64_t(pnew) << 63;
    prev_v = v;
    prev_pv = pv;
  }
  for (int64_t i = 0; i < K; ++i) {
    const uint64_t r = rec[i];
    const int64_t first = int64_t(r & 0xFFFFFFFFu);
    put_index(inv, w[INV], i, first);
    put_mask(rep, w[REP], i, first == i);  // a first occurrence is its own
    put_index(pinv, w[PINV], i, int64_t((r >> 32) & 0x7FFFFFFFu));
    put_mask(prep, w[PREP], i, r >> 63);
  }
  if (!phys) return;
  static_cast<int32_t*>(f.out[NUNIQ])[b] = int32_t(U);
  for (int64_t i = U; i < Kp; ++i) put_index(acc, w[ACC], i, 0);
  for (int64_t i = nres; i < R_cap; ++i) {
    put_index(rpos, w[RPOS], i, 0);
    put_index(rslot, w[RSLOT], i, f.drop_slot);
  }
  for (int64_t i = nld; i < G_cap; ++i) {
    put_index(gpos, w[GPOS], i, 0);
    put_index(gtgt, w[GTGT], i, f.drop_tgt);
  }
  // distinct untouched rows at the tail: the first non-members of pids in
  // [0, Kp]
  for (int64_t r = 0; U < Kp; ++r)
    if (!present[size_t(r)]) pids[U++] = int32_t(r);
}

// Runs work(b, scratch) for every step b on n_threads threads, each taking
// the next step as it finishes one; the largest return code wins.
template <typename Work>
int32_t for_steps(int64_t steps, int32_t n_threads, Work work) {
  std::atomic<int64_t> next{0};
  std::atomic<int32_t> code{0};
  auto loop = [&]() {
    typename Work::Scratch scratch;
    for (int64_t b; (b = next.fetch_add(1)) < steps;) {
      const int32_t rc = work(b, scratch);
      int32_t seen = code.load();
      while (rc > seen && !code.compare_exchange_weak(seen, rc)) {
      }
    }
  };
  int64_t nt = n_threads < 1 ? 1 : n_threads;
  if (nt > steps) nt = steps;
  if (nt <= 1) {
    loop();
    return code.load();
  }
  std::vector<std::thread> ts;
  for (int64_t t = 0; t < nt; ++t) ts.emplace_back(loop);
  for (auto& th : ts) th.join();
  return code.load();
}

struct Scratch {
  std::vector<int64_t> keys, tmp;
  std::vector<uint32_t> hist;
  std::vector<uint8_t> present;
};

// Steps 1-2 of one step: its sorted composite, in dst when dst is given,
// else in one of the scratch's buffers; *sorted points at it.
int32_t sort_step(const Source& s, int64_t b, int64_t K, int64_t* dst, Scratch& sc,
                  const int64_t** sorted) {
  sc.keys.resize(size_t(K));
  sc.tmp.resize(size_t(K));
  int64_t vmax = 0;
  const int32_t rc = s.src_bytes == 4
      ? read_step(s, static_cast<const int32_t*>(s.src), b, sc.keys.data(), &vmax)
      : read_step(s, static_cast<const int64_t*>(s.src), b, sc.keys.data(), &vmax);
  if (rc) return rc;
  int64_t* out = radix_sort(sc.keys.data(), sc.tmp.data(), K, s.idx_bits, bit_length(vmax),
                            sc.hist);
  if (dst) {
    std::memcpy(dst, out, size_t(K) * sizeof(int64_t));
    out = dst;
  }
  *sorted = out;
  return 0;
}

}  // namespace

extern "C" {

// Steps 1-2 of every step into comp [steps, K], and the gather route's
// counts n_resid, n_ldup [steps] of each.
int32_t smh_sort(const void* src, int32_t src_bytes, int64_t stride, int64_t F,
                 const int64_t* offsets, const int64_t* rows, int64_t B, int64_t steps,
                 int32_t idx_bits, int32_t P, int64_t* comp, int64_t* n_resid,
                 int64_t* n_ldup, int32_t n_threads) {
  const Source s{src, src_bytes, stride, F, offsets, rows, B, idx_bits};
  const int64_t K = B * F;
  struct Work {
    using Scratch = ::Scratch;
    const Source& s;
    int64_t K;
    int32_t P;
    int64_t *comp, *n_resid, *n_ldup;
    int32_t operator()(int64_t b, Scratch& sc) const {
      const int64_t* c = nullptr;
      const int32_t rc = sort_step(s, b, K, comp + b * K, sc, &c);
      if (!rc) count_step(c, K, s.idx_bits, P, n_resid + b, n_ldup + b);
      return rc;
    }
  };
  return for_steps(steps, n_threads, Work{s, K, P, comp, n_resid, n_ldup});
}

// The fill pass of every step into the eleven outputs (inv, rep, pids,
// pinv, nuniq, prep, accperm, resid_pos, resid_slot, gdup_pos, gdup_tgt;
// a null pointer or width 0 is not written), from comp [steps, K] sorted
// by smh_sort, or with a null comp from src, each step read and sorted
// first.
int32_t smh_fill(const void* src, int32_t src_bytes, int64_t stride, int64_t F,
                 const int64_t* offsets, const int64_t* rows, int64_t B, int64_t steps,
                 int32_t idx_bits, int32_t P, const int64_t* comp, int64_t Kp, int64_t R_cap,
                 int64_t G_cap, int64_t drop_slot, int64_t drop_tgt, void* inv, void* rep,
                 void* pids, void* pinv, void* nuniq, void* prep, void* accperm,
                 void* resid_pos, void* resid_slot, void* gdup_pos, void* gdup_tgt,
                 const int32_t* widths, int32_t n_threads) {
  const Source s{src, src_bytes, stride, F, offsets, rows, B, idx_bits};
  Fill f{B * F, Kp, R_cap, G_cap, drop_slot, drop_tgt, idx_bits, P,
         {inv, rep, pids, pinv, nuniq, prep, accperm, resid_pos, resid_slot, gdup_pos,
          gdup_tgt},
         {}};
  for (int i = 0; i < kOutputs; ++i) f.width[i] = f.out[i] ? widths[i] : 0;
  struct Work {
    using Scratch = ::Scratch;
    const Source& s;
    const Fill& f;
    const int64_t* comp;
    int32_t operator()(int64_t b, Scratch& sc) const {
      const int64_t* c = comp ? comp + b * f.K : nullptr;
      if (!c) {
        const int32_t rc = sort_step(s, b, f.K, nullptr, sc, &c);
        if (rc) return rc;
      }
      sc.keys.resize(size_t(f.K));
      sc.tmp.resize(size_t(f.K));
      // the records go to whichever buffer does not hold the sorted keys
      int64_t* rec = c == sc.keys.data() ? sc.tmp.data() : sc.keys.data();
      if (f.out[2]) sc.present.resize(size_t(f.Kp) + 1);
      fill_step(f, c, b, reinterpret_cast<uint64_t*>(rec), sc.present);
      return 0;
    }
  };
  return for_steps(steps, n_threads, Work{s, f, comp});
}

}  // extern "C"
