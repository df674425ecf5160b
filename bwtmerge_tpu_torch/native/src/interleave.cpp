// Streaming run-level interleave of two RLE BWTs by a rank array.
//
// The host backend of the merge phase: equivalent to the reference's
// mergeBWT consumer loop (bwt.cpp:215-282) but over flat run arrays instead of
// byte streams — walks RLE(A) and RLE(B) once, emitting the merged maximal
// runs.  Unlike the reference's single consumer thread, the parallel variant
// splits the rank array into T slices whose A/B/output start offsets are all
// prefix-sum expressions, so every slice interleaves independently.
//
// Error contract (negative return values; no partial-result trust):
//   -1  rank array inconsistent with the inputs (value > |A| or count sum
//       != |B| for the batch entry points; mid-stream exhaustion for the
//       chunked entry point)
//   -2  output capacity exceeded (callers size with the documented bound,
//       so this indicates a caller bug rather than data-dependent overflow)

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>

#define EXPORT extern "C" __attribute__((visibility("default")))

namespace {

template <typename LenT>
struct RunEmitterT {
  uint8_t* out_syms;
  LenT* out_lens;
  int64_t cap;  // capacity of out_syms/out_lens; writes beyond set overflow
  int64_t count = 0;
  uint8_t cur_sym = 0;
  int64_t cur_len = 0;
  bool overflow = false;

  inline void emit(uint8_t s, int64_t l) {
    if (l == 0) return;
    if (cur_len > 0 && s == cur_sym) {
      cur_len += l;
    } else {
      flush();
      cur_sym = s;
      cur_len = l;
    }
  }

  inline void flush() {
    // int32 outputs SPLIT over-wide runs into adjacent same-symbol entries
    // (the stateful format writers re-coalesce them); int64 never splits
    while (cur_len > 0) {
      int64_t take = cur_len;
      if (sizeof(LenT) == 4 && take > 0x7FFFFFFFLL) take = 0x7FFFFFFFLL;
      if (count >= cap) {
        overflow = true;
        cur_len = 0;
        return;
      }
      out_syms[count] = cur_sym;
      out_lens[count] = static_cast<LenT>(take);
      count++;
      cur_len -= take;
    }
  }
};

using RunEmitter = RunEmitterT<int64_t>;

struct Cursor {  // position within one RLE stream
  int64_t run = 0;   // current run index
  int64_t rem = 0;   // positions remaining in the current run
};

// Serial interleave of RA runs [t0, t1) given stream cursors; returns false on
// emitter overflow or if a stream is exhausted while positions are still owed
// (corrupt rank array).
template <typename Emitter>
bool interleave_span(const uint8_t* a_syms, const int64_t* a_lens, int64_t na,
                     const uint8_t* b_syms, const int64_t* b_lens, int64_t nb,
                     const int64_t* ra_vals, const int64_t* ra_cnts,
                     int64_t t0, int64_t t1, int64_t a_pos0, Cursor& a,
                     Cursor& b, Emitter& out) {
  int64_t a_pos = a_pos0;
  for (int64_t t = t0; t < t1; t++) {
    int64_t v = ra_vals[t];
    int64_t k = ra_cnts[t];
    while (a_pos < v) {
      if (a.rem == 0) return false;  // RA value beyond |A|
      int64_t take = std::min(v - a_pos, a.rem);
      out.emit(a_syms[a.run], take);
      a.rem -= take;
      a_pos += take;
      if (a.rem == 0 && ++a.run < na) a.rem = a_lens[a.run];
    }
    while (k > 0) {
      if (b.rem == 0) return false;  // RA counts beyond |B|
      int64_t take = std::min(k, b.rem);
      out.emit(b_syms[b.run], take);
      b.rem -= take;
      k -= take;
      if (b.rem == 0 && ++b.run < nb) b.rem = b_lens[b.run];
    }
  }
  return !out.overflow;
}

template <typename Emitter>
void drain_a(const uint8_t* a_syms, const int64_t* a_lens, int64_t na,
             Cursor& a, Emitter& out) {
  while (a.run < na && a.rem > 0) {  // append the rest of A (bwt.cpp:266-276)
    out.emit(a_syms[a.run], a.rem);
    if (++a.run < na) a.rem = a_lens[a.run];
  }
}

// Parallel exclusive prefix sum: dst[0] = 0, dst[i+1] = sum(src[0..i]).
// Two passes (block sums, then offset fill), both threaded — the fill is
// memory-bandwidth-bound and was the dominant cost of the parallel
// interleave when done serially.
void prefix_sum_parallel(const int64_t* src, int64_t n, int64_t* dst,
                         int64_t T) {
  T = std::max<int64_t>(1, std::min(T, n / (1 << 16) + 1));
  std::vector<int64_t> partial(T + 1, 0);
  {
    std::vector<std::thread> ws;
    ws.reserve(T);
    for (int64_t i = 0; i < T; i++) {
      ws.emplace_back([&, i] {
        int64_t lo = n * i / T, hi = n * (i + 1) / T, s = 0;
        for (int64_t j = lo; j < hi; j++) s += src[j];
        partial[i + 1] = s;
      });
    }
    for (auto& w : ws) w.join();
  }
  for (int64_t i = 0; i < T; i++) partial[i + 1] += partial[i];
  dst[0] = 0;
  {
    std::vector<std::thread> ws;
    ws.reserve(T);
    for (int64_t i = 0; i < T; i++) {
      ws.emplace_back([&, i] {
        int64_t lo = n * i / T, hi = n * (i + 1) / T, s = partial[i];
        for (int64_t j = lo; j < hi; j++) {
          s += src[j];
          dst[j + 1] = s;
        }
      });
    }
    for (auto& w : ws) w.join();
  }
}

// Locate the cursor for absolute position `pos` via the exclusive prefix sums
// `cum` (cum[i] = positions before run i; cum[n] = total).
Cursor cursor_at(const int64_t* cum, int64_t n, int64_t pos) {
  const int64_t* it = std::upper_bound(cum, cum + n + 1, pos);
  int64_t run = (it - cum) - 1;
  Cursor c;
  c.run = run;
  c.rem = (run < n) ? cum[run + 1] - pos : 0;
  return c;
}

}  // namespace

// Interleave A and B according to sorted-unique rank-array runs
// (ra_vals strictly increasing, sum(ra_cnts) == |B|, ra_vals[last] <= |A|).
// Output arrays must have capacity >= na + nb + 2 * nra + 1.
// Returns the number of merged maximal runs, or a negative error code.
EXPORT int64_t interleave_runs(const uint8_t* a_syms, const int64_t* a_lens,
                               int64_t na, const uint8_t* b_syms,
                               const int64_t* b_lens, int64_t nb,
                               const int64_t* ra_vals, const int64_t* ra_cnts,
                               int64_t nra, uint8_t* out_syms,
                               int64_t* out_lens) {
  RunEmitter out{out_syms, out_lens, na + nb + 2 * nra + 1};
  Cursor a{0, na > 0 ? a_lens[0] : 0};
  Cursor b{0, nb > 0 ? b_lens[0] : 0};
  if (!interleave_span(a_syms, a_lens, na, b_syms, b_lens, nb, ra_vals,
                       ra_cnts, 0, nra, 0, a, b, out)) {
    return out.overflow ? -2 : -1;
  }
  if (b.run < nb && b.rem > 0) return -1;  // counts did not cover |B|
  drain_a(a_syms, a_lens, na, a, out);
  out.flush();
  return out.overflow ? -2 : out.count;
}

// -- parallel batch interleave ------------------------------------------------
//
// Splits the RA into `n_threads` contiguous slices.  Every slice's starting
// state is pure arithmetic: before RA run t, A has been consumed up to
// position ra_vals[t-1] and B up to sum(ra_cnts[0:t]); run cursors come from
// binary searches over the RLE length prefix sums.  Slices emit into disjoint
// regions of the output (offsets from the same prefix sums), then the seams
// are stitched by coalescing the boundary runs.
//
// Output capacity must be >= na + nb + 2 * nra + 1 + n_threads (each seam can
// leave one extra run before stitching).  Returns merged run count or a
// negative error code.
EXPORT int64_t interleave_runs_parallel(
    const uint8_t* a_syms, const int64_t* a_lens, int64_t na,
    const uint8_t* b_syms, const int64_t* b_lens, int64_t nb,
    const int64_t* ra_vals, const int64_t* ra_cnts, int64_t nra,
    int64_t n_threads, uint8_t* out_syms, int64_t* out_lens) {
  int64_t T = std::max<int64_t>(1, n_threads);
  if (nra < 4 * T || T == 1) {
    return interleave_runs(a_syms, a_lens, na, b_syms, b_lens, nb, ra_vals,
                           ra_cnts, nra, out_syms, out_lens);
  }

  // prefix sums of the RLE lengths and the RA counts (threaded: at large
  // inputs these three O(n) fills otherwise cost as much as the interleave)
  std::vector<int64_t> a_cum(na + 1), b_cum(nb + 1), rc_cum(nra + 1);
  prefix_sum_parallel(a_lens, na, a_cum.data(), T);
  prefix_sum_parallel(b_lens, nb, b_cum.data(), T);
  prefix_sum_parallel(ra_cnts, nra, rc_cum.data(), T);

  if (rc_cum[nra] != b_cum[nb]) return -1;          // counts must cover |B|
  if (nra > 0 && ra_vals[nra - 1] > a_cum[na]) return -1;

  struct Slice {
    int64_t t0, t1;        // RA run range
    int64_t a_pos0;        // A text position at slice start
    Cursor a, b;
    std::unique_ptr<uint8_t[]> syms;   // uninitialized (new[]): zeroing the
    std::unique_ptr<int64_t[]> lens;   // slice buffers costs a full pass
    int64_t cap = 0;
    int64_t count = 0;
    bool ok = true;
  };
  std::vector<Slice> slices(T);
  for (int64_t i = 0; i < T; i++) {
    Slice& s = slices[i];
    s.t0 = nra * i / T;
    s.t1 = nra * (i + 1) / T;
    s.a_pos0 = (s.t0 > 0) ? ra_vals[s.t0 - 1] : 0;
    s.a = cursor_at(a_cum.data(), na, s.a_pos0);
    s.b = cursor_at(b_cum.data(), nb, rc_cum[s.t0]);
    // per-slice run bound: A fragments + B fragments + slack
    int64_t a_end = (s.t1 > 0) ? ra_vals[s.t1 - 1] : 0;
    Cursor a_hi = cursor_at(a_cum.data(), na, a_end);
    Cursor b_hi = cursor_at(b_cum.data(), nb, rc_cum[s.t1]);
    int64_t len = s.t1 - s.t0;
    int64_t cap = (a_hi.run - s.a.run + 2) + (b_hi.run - s.b.run + 2) +
                  2 * len + 4;
    if (i == T - 1) cap += na - a_hi.run + 2;  // A tail
    s.cap = cap;
    s.syms.reset(new uint8_t[cap]);
    s.lens.reset(new int64_t[cap]);
  }

  std::vector<std::thread> workers;
  workers.reserve(T);
  for (int64_t i = 0; i < T; i++) {
    workers.emplace_back([&, i] {
      Slice& s = slices[i];
      RunEmitter out{s.syms.get(), s.lens.get(), s.cap};
      s.ok = interleave_span(a_syms, a_lens, na, b_syms, b_lens, nb, ra_vals,
                             ra_cnts, s.t0, s.t1, s.a_pos0, s.a, s.b, out);
      if (s.ok && i == T - 1) drain_a(a_syms, a_lens, na, s.a, out);
      out.flush();
      s.ok = s.ok && !out.overflow;
      s.count = out.count;
    });
  }
  for (auto& w : workers) w.join();
  for (auto& s : slices) {
    if (!s.ok) return -1;
  }

  // stitch: copy slices into the shared output, coalescing seam runs
  int64_t out_cap = na + nb + 2 * nra + 1 + T;
  int64_t n = 0;
  for (auto& s : slices) {
    int64_t from = 0;
    if (n > 0 && s.count > 0 && s.syms[0] == out_syms[n - 1]) {
      out_lens[n - 1] += s.lens[0];
      from = 1;
    }
    int64_t add = s.count - from;
    if (n + add > out_cap) return -2;
    std::memcpy(out_syms + n, s.syms.get() + from, add);
    std::memcpy(out_lens + n, s.lens.get() + from, add * sizeof(int64_t));
    n += add;
  }
  return n;
}

// -- stateful chunked interleave (out-of-core path) ---------------------------
//
// Consumes the rank array in ascending chunks (RankArraySpill.stream) with
// bounded memory. state layout (int64[7]):
//   [0]=ai  [1]=a_rem  [2]=bi  [3]=b_rem  [4]=a_pos  [5]=cur_sym  [6]=cur_len
// Initialize with interleave_state_init; call interleave_chunk per RA chunk;
// finish with interleave_chunk(nra=0, finish=1) to drain A's tail and flush.
// out_cap is the capacity of out_syms/out_lens; the documented bound per call
// is chunk positions + 2*nra + 2 (+ A-tail runs when finishing).  Returns the
// emitted run count, or a negative error code (state is then unusable).

EXPORT void interleave_state_init(const int64_t* a_lens, int64_t na,
                                  const int64_t* b_lens, int64_t nb,
                                  int64_t* state) {
  state[0] = 0;
  state[1] = (na > 0) ? a_lens[0] : 0;
  state[2] = 0;
  state[3] = (nb > 0) ? b_lens[0] : 0;
  state[4] = 0;
  state[5] = 0;
  state[6] = 0;
}

EXPORT int64_t interleave_chunk(const uint8_t* a_syms, const int64_t* a_lens,
                                int64_t na, const uint8_t* b_syms,
                                const int64_t* b_lens, int64_t nb,
                                const int64_t* ra_vals, const int64_t* ra_cnts,
                                int64_t nra, int64_t finish, int64_t out_cap,
                                int64_t* state, uint8_t* out_syms,
                                int64_t* out_lens) {
  RunEmitter out{out_syms, out_lens, out_cap};
  Cursor a{state[0], state[1]};
  Cursor b{state[2], state[3]};
  int64_t a_pos = state[4];
  out.cur_sym = static_cast<uint8_t>(state[5]);
  out.cur_len = state[6];

  if (!interleave_span(a_syms, a_lens, na, b_syms, b_lens, nb, ra_vals,
                       ra_cnts, 0, nra, a_pos, a, b, out)) {
    return out.overflow ? -2 : -1;
  }
  if (nra > 0) a_pos = ra_vals[nra - 1];
  if (finish) {
    if (b.run < nb && b.rem > 0) return -1;  // RA never covered all of B
    drain_a(a_syms, a_lens, na, a, out);
    out.flush();
    if (out.overflow) return -2;
  }
  state[0] = a.run;
  state[1] = a.rem;
  state[2] = b.run;
  state[3] = b.rem;
  state[4] = a_pos;
  state[5] = out.cur_sym;
  state[6] = out.cur_len;
  return out.count;
}

// -- context-based chunked parallel interleave --------------------------------
//
// The chunk-parallel interleave for one-shot merges.  A naive parallel
// decomposition needs full-length prefix sums over A and B (O(|A|+|B|)
// bytes) whose first-touch page faults cost more
// than the interleave itself.  The context walks only each chunk's span into small ROLLING
// prefix buffers (reused across chunks), and slices write DIRECTLY into the
// caller's output buffer at arithmetic cap offsets — zero per-chunk
// allocation.  Same state/withholding/error contract as interleave_chunk.

struct ILCtx {
  const uint8_t* a_syms;
  const int64_t* a_lens;
  int64_t na;
  const uint8_t* b_syms;
  const int64_t* b_lens;
  int64_t nb;
  int64_t T;
  Cursor a, b;          // absolute cursors (rem==0 iff run==n)
  int64_t a_pos = 0;    // A positions consumed (last RA value seen)
  uint8_t w_sym = 0;    // withheld trailing run
  int64_t w_len = 0;
  std::vector<int64_t> a_cum, b_cum, rc_cum;  // chunk-local scratch
};

EXPORT void* interleave_ctx_new(const uint8_t* a_syms, const int64_t* a_lens,
                                int64_t na, const uint8_t* b_syms,
                                const int64_t* b_lens, int64_t nb,
                                int64_t n_threads) {
  ILCtx* c = new ILCtx();
  c->a_syms = a_syms;
  c->a_lens = a_lens;
  c->na = na;
  c->b_syms = b_syms;
  c->b_lens = b_lens;
  c->nb = nb;
  c->T = std::max<int64_t>(1, n_threads);
  c->a = Cursor{0, na > 0 ? a_lens[0] : 0};
  c->b = Cursor{0, nb > 0 ? b_lens[0] : 0};
  return c;
}

EXPORT void interleave_ctx_free(void* ctx) { delete static_cast<ILCtx*>(ctx); }

namespace {

// Walk `lens` from cursor `cur` building the local exclusive prefix sum
// (local run 0 = the current run's REMAINING positions) until it covers
// `need` positions.  Returns false if the stream ends first.
bool walk_local_cum(const int64_t* lens, int64_t n, Cursor cur, int64_t need,
                    std::vector<int64_t>& cum) {
  cum.clear();
  cum.push_back(0);
  if (cur.rem > 0) cum.push_back(cur.rem);
  int64_t r = cur.run + 1;
  while (cum.back() < need && r < n) {
    cum.push_back(cum.back() + lens[r++]);
  }
  return cum.back() >= need;
}

}  // namespace

namespace {

template <typename LenT>
int64_t ctx_chunk_impl(void* vctx, const int64_t* ra_vals,
                       const int64_t* ra_cnts, int64_t nra,
                       int64_t finish, int64_t out_cap,
                       uint8_t* out_syms, LenT* out_lens) {
  ILCtx& c = *static_cast<ILCtx*>(vctx);
  const int64_t na = c.na, nb = c.nb;

  c.rc_cum.resize(nra + 1);
  c.rc_cum[0] = 0;
  for (int64_t t = 0; t < nra; t++) c.rc_cum[t + 1] = c.rc_cum[t] + ra_cnts[t];
  const int64_t need_a = (nra > 0) ? ra_vals[nra - 1] - c.a_pos : 0;
  const int64_t need_b = c.rc_cum[nra];
  if (need_a < 0) return -1;
  if (!walk_local_cum(c.a_lens, na, c.a, need_a, c.a_cum)) return -1;
  if (!walk_local_cum(c.b_lens, nb, c.b, need_b, c.b_cum)) return -1;
  const int64_t nla = static_cast<int64_t>(c.a_cum.size()) - 1;
  const int64_t nlb = static_cast<int64_t>(c.b_cum.size()) - 1;

  int64_t T = c.T;
  if (nra < 4 * T) T = 1;

  struct Slice {
    int64_t t0, t1, a_pos0, off;
    Cursor a, b;
    int64_t cap = 0;
    int64_t count = 0;
    bool ok = true;
    uint8_t first_sym = 0;  // pre-stitch seam info
  };
  std::vector<Slice> slices(T);

  // local -> absolute cursor translation: local run k of A is absolute run
  // (a.run + k); local rem IS the absolute rem (run 0 is the partial run).
  // A position at the end of the WALKED region maps to local run nla with
  // rem 0 even though more absolute runs may follow — re-establish the
  // (rem==0 iff run==n) cursor invariant by pre-loading the next run.
  auto a_at = [&](int64_t local_pos) {
    Cursor l = cursor_at(c.a_cum.data(), nla, local_pos);
    Cursor abs{c.a.run + l.run, l.rem};
    if (abs.rem == 0 && abs.run < na) abs.rem = c.a_lens[abs.run];
    return abs;
  };
  auto b_at = [&](int64_t local_pos) {
    Cursor l = cursor_at(c.b_cum.data(), nlb, local_pos);
    Cursor abs{c.b.run + l.run, l.rem};
    if (abs.rem == 0 && abs.run < nb) abs.rem = c.b_lens[abs.run];
    return abs;
  };

  int64_t off = 0;
  for (int64_t i = 0; i < T; i++) {
    Slice& s = slices[i];
    s.t0 = nra * i / T;
    s.t1 = nra * (i + 1) / T;
    if (i == 0) {
      s.a_pos0 = c.a_pos;
      s.a = c.a;
      s.b = c.b;
    } else {
      s.a_pos0 = ra_vals[s.t0 - 1];
      s.a = a_at(s.a_pos0 - c.a_pos);
      s.b = b_at(c.rc_cum[s.t0]);
    }
    int64_t a_end_local = (s.t1 > 0) ? ra_vals[s.t1 - 1] - c.a_pos : 0;
    Cursor a_hi = a_at(a_end_local);
    Cursor b_hi = b_at(c.rc_cum[s.t1]);
    int64_t cap = (a_hi.run - s.a.run + 2) + (b_hi.run - s.b.run + 2) +
                  2 * (s.t1 - s.t0) + 4;
    if (finish && i == T - 1) cap += na - a_hi.run + 2;  // A tail
    s.off = off;
    s.cap = cap;
    off += cap;
  }
  if (off > out_cap) return -2;

  auto run_slice = [&](int64_t i) {
    Slice& s = slices[i];
    RunEmitterT<LenT> out{out_syms + s.off, out_lens + s.off, s.cap};
    if (i == 0) {  // resume the withheld trailing run
      out.cur_sym = c.w_sym;
      out.cur_len = c.w_len;
    }
    s.ok = interleave_span(c.a_syms, c.a_lens, na, c.b_syms, c.b_lens, nb,
                           ra_vals, ra_cnts, s.t0, s.t1, s.a_pos0, s.a, s.b,
                           out);
    if (s.ok && finish && i == T - 1) {
      if (s.b.run < nb && s.b.rem > 0) {
        s.ok = false;  // RA never covered all of B
      } else {
        drain_a(c.a_syms, c.a_lens, na, s.a, out);
      }
    }
    out.flush();
    s.ok = s.ok && !out.overflow;
    s.count = out.count;
    if (s.count > 0) s.first_sym = out_syms[s.off];
  };
  if (T == 1) {
    run_slice(0);
  } else {
    std::vector<std::thread> workers;
    workers.reserve(T);
    for (int64_t i = 0; i < T; i++) workers.emplace_back(run_slice, i);
    for (auto& w : workers) w.join();
  }
  for (auto& s : slices) {
    if (!s.ok) return -1;
  }

  // compact left in place, coalescing seam runs (memmove: regions overlap)
  int64_t n = slices[0].count;
  for (int64_t i = 1; i < T; i++) {
    Slice& s = slices[i];
    int64_t from = 0;
    if (n > 0 && s.count > 0 && s.first_sym == out_syms[n - 1]) {
      int64_t summed = static_cast<int64_t>(out_lens[n - 1])
                       + static_cast<int64_t>(out_lens[s.off]);
      if (sizeof(LenT) == 8 || summed <= 0x7FFFFFFFLL) {
        // int32 seams too wide to coalesce stay as adjacent same-symbol
        // entries; the stateful format writers re-coalesce them
        out_lens[n - 1] = static_cast<LenT>(summed);
        from = 1;
      }
    }
    int64_t add = s.count - from;
    std::memmove(out_syms + n, out_syms + s.off + from, add);
    std::memmove(out_lens + n, out_lens + s.off + from,
                 add * sizeof(LenT));
    n += add;
  }

  // advance the shared cursors to the chunk end
  if (nra > 0) {
    c.a = a_at(need_a);
    c.a_pos = ra_vals[nra - 1];
  }
  c.b = b_at(need_b);
  if (finish) {
    c.a = Cursor{na, 0};
    c.w_sym = 0;
    c.w_len = 0;
  } else if (n > 0) {
    // withhold the trailing MAXIMAL run for cross-chunk coalescing — the
    // whole trailing same-symbol GROUP, since the int32 emitter may have
    // split an over-wide run into adjacent entries (a partial withhold
    // would leak same-symbol adjacency ACROSS chunks, which the format
    // writers' contract excludes)
    c.w_sym = out_syms[n - 1];
    c.w_len = 0;
    while (n > 0 && out_syms[n - 1] == c.w_sym) {
      c.w_len += static_cast<int64_t>(out_lens[n - 1]);
      n--;
    }
  } else {
    c.w_sym = 0;
    c.w_len = 0;
  }
  return n;
}

}  // namespace

EXPORT int64_t interleave_ctx_chunk(void* vctx, const int64_t* ra_vals,
                                    const int64_t* ra_cnts, int64_t nra,
                                    int64_t finish, int64_t out_cap,
                                    uint8_t* out_syms, int64_t* out_lens) {
  return ctx_chunk_impl<int64_t>(vctx, ra_vals, ra_cnts, nra, finish,
                                 out_cap, out_syms, out_lens);
}

// int32 run lengths: HALF the dominant store/load traffic of the
// memory-bound merge phase (the host interleave+writer chain moves
// ~9 B/run of (sym, len) twice).  Runs wider than int32 split into
// adjacent same-symbol entries; the int32-aware format writers
// (writer.cpp *_32) re-coalesce them, so the encoded bytes stay
// canonical (maximal-run).
EXPORT int64_t interleave_ctx_chunk32(void* vctx, const int64_t* ra_vals,
                                      const int64_t* ra_cnts, int64_t nra,
                                      int64_t finish, int64_t out_cap,
                                      uint8_t* out_syms, int32_t* out_lens) {
  return ctx_chunk_impl<int32_t>(vctx, ra_vals, ra_cnts, nra, finish,
                                 out_cap, out_syms, out_lens);
}
