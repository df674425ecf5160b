// Sanitizer self-test for the port's native runtime (built with
// -fsanitize=address,undefined by tests/test_torch_sanitizer.py).
//
// The ctypes API is raw pointers + caller-allocated buffers; this harness
// exercises every exported entry point with randomized round trips, boundary
// shapes, and deliberately corrupt inputs under ASan+UBSan so memory-safety
// contracts (capacity bounds, error sentinels instead of overruns/hangs) are
// machine-checked — the sanitizer CI the reference never had (SURVEY.md §5).
//
// Exits 0 on success; any sanitizer report aborts with a nonzero status.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <random>
#include <vector>

extern "C" {
int64_t rle_encode_size(const uint8_t*, const int64_t*, int64_t);
int64_t rle_encode(const uint8_t*, const int64_t*, int64_t, uint8_t*);
int64_t rle_encode_size_at(const uint8_t*, const int64_t*, int64_t, int64_t);
int64_t rle_encode_at(const uint8_t*, const int64_t*, int64_t, uint8_t*,
                      int64_t);
int64_t rle_decode_count(const uint8_t*, int64_t);
int64_t rle_decode(const uint8_t*, int64_t, uint8_t*, int64_t*, int64_t*);
uint64_t rle_hash_runs(const uint8_t*, const int64_t*, int64_t);
uint64_t fnv1a_bytes(const uint8_t*, int64_t, uint64_t);
int64_t ra_encode_size(const int64_t*, const int64_t*, int64_t);
int64_t ra_encode(const int64_t*, const int64_t*, int64_t, uint8_t*);
int64_t ra_decode_chunk(const uint8_t*, int64_t, int64_t, int64_t*, int64_t*,
                        int64_t*);
int64_t interleave_runs(const uint8_t*, const int64_t*, int64_t,
                        const uint8_t*, const int64_t*, int64_t,
                        const int64_t*, const int64_t*, int64_t, uint8_t*,
                        int64_t*);
int64_t interleave_runs_parallel(const uint8_t*, const int64_t*, int64_t,
                                 const uint8_t*, const int64_t*, int64_t,
                                 const int64_t*, const int64_t*, int64_t,
                                 int64_t, uint8_t*, int64_t*);
void interleave_state_init(const int64_t*, int64_t, const int64_t*, int64_t,
                           int64_t*);
int64_t interleave_chunk(const uint8_t*, const int64_t*, int64_t,
                         const uint8_t*, const int64_t*, int64_t,
                         const int64_t*, const int64_t*, int64_t, int64_t,
                         int64_t, int64_t*, uint8_t*, int64_t*);
int64_t rope_runs_count(const uint8_t*, int64_t, int64_t, int64_t, int64_t,
                        int64_t, int64_t, int64_t, const int64_t*);
int64_t rope_runs_fill(const uint8_t*, int64_t, int64_t, int64_t, int64_t,
                       int64_t, int64_t, int64_t, int64_t*, uint8_t*,
                       int64_t*, int64_t*);
int64_t run_sym_sums(const uint8_t*, const int64_t*, int64_t, int64_t*);
int64_t sga_stream_chunk(const uint8_t*, const int64_t*, int64_t, int64_t*,
                         uint8_t*, int64_t);
int64_t sga_stream_chunk_totals(const uint8_t*, const int64_t*, int64_t,
                                int64_t*, uint8_t*, int64_t);
}

namespace {

std::mt19937_64 rng(12345);

#define CHECK(cond)                                                       \
  do {                                                                    \
    if (!(cond)) {                                                        \
      std::fprintf(stderr, "selftest FAILED at %s:%d: %s\n", __FILE__,    \
                   __LINE__, #cond);                                      \
      std::exit(1);                                                       \
    }                                                                     \
  } while (0)

struct Runs {
  std::vector<uint8_t> syms;
  std::vector<int64_t> lens;
};

Runs random_runs(int64_t n, int64_t max_len) {
  Runs r;
  uint8_t prev = 255;
  for (int64_t i = 0; i < n; i++) {
    uint8_t s;
    do {
      s = static_cast<uint8_t>(rng() % 6);
    } while (s == prev);
    prev = s;
    r.syms.push_back(s);
    r.lens.push_back(1 + static_cast<int64_t>(rng() % max_len));
  }
  return r;
}

void test_rle_round_trip() {
  for (int64_t max_len : {1, 3, 41, 42, 43, 64, 5000}) {
    Runs r = random_runs(200, max_len);
    int64_t n = r.syms.size();
    int64_t size = rle_encode_size(r.syms.data(), r.lens.data(), n);
    std::vector<uint8_t> buf(size);
    CHECK(rle_encode(r.syms.data(), r.lens.data(), n, buf.data()) == size);

    int64_t stored = rle_decode_count(buf.data(), size);
    std::vector<uint8_t> syms(stored);
    std::vector<int64_t> lens(stored), offs(stored);
    CHECK(rle_decode(buf.data(), size, syms.data(), lens.data(),
                     offs.data()) == stored);
    // decoded stored runs must cover exactly the input positions
    int64_t want = 0, got = 0;
    for (auto l : r.lens) want += l;
    for (auto l : lens) got += l;
    CHECK(want == got);
    CHECK(rle_hash_runs(r.syms.data(), r.lens.data(), n) ==
          rle_hash_runs(syms.data(), lens.data(), stored));
  }
}

void test_rle_chunked_resume() {
  Runs r = random_runs(300, 200);
  int64_t n = r.syms.size();
  int64_t full = rle_encode_size(r.syms.data(), r.lens.data(), n);
  std::vector<uint8_t> whole(full);
  rle_encode(r.syms.data(), r.lens.data(), n, whole.data());

  // encode in two chunks resuming the block rule at the split offset
  int64_t split = n / 2;
  int64_t s1 = rle_encode_size(r.syms.data(), r.lens.data(), split);
  std::vector<uint8_t> part(full);
  rle_encode(r.syms.data(), r.lens.data(), split, part.data());
  int64_t s2 = rle_encode_size_at(r.syms.data() + split, r.lens.data() + split,
                                  n - split, s1);
  CHECK(s1 + s2 == full);
  rle_encode_at(r.syms.data() + split, r.lens.data() + split, n - split,
                part.data() + s1, s1);
  CHECK(std::memcmp(whole.data(), part.data(), full) == 0);
}

void test_ra_codec() {
  int64_t n = 5000;
  std::vector<int64_t> values(n), counts(n);
  int64_t v = 0;
  for (int64_t i = 0; i < n; i++) {
    v += 1 + static_cast<int64_t>(rng() % 1000);
    values[i] = v;
    counts[i] = 1 + static_cast<int64_t>(rng() % (1 << 20));
  }
  int64_t size = ra_encode_size(values.data(), counts.data(), n);
  std::vector<uint8_t> buf(size);
  CHECK(ra_encode(values.data(), counts.data(), n, buf.data()) == size);

  std::vector<int64_t> dv(n), dc(n);
  int64_t state[2] = {0, 0};
  int64_t done = 0;
  while (done < n) {  // chunked decode with small chunks
    int64_t k = ra_decode_chunk(buf.data(), size, 137, state, dv.data() + done,
                                dc.data() + done);
    CHECK(k > 0);
    done += k;
  }
  CHECK(done == n);
  CHECK(std::memcmp(values.data(), dv.data(), n * 8) == 0);
  CHECK(std::memcmp(counts.data(), dc.data(), n * 8) == 0);
}

void test_interleave() {
  Runs a = random_runs(400, 30), b = random_runs(300, 30);
  int64_t na = a.syms.size(), nb = b.syms.size();
  int64_t a_total = 0, b_total = 0;
  for (auto l : a.lens) a_total += l;
  for (auto l : b.lens) b_total += l;

  // random sorted-unique RA covering exactly |B|
  int64_t nra = 64;
  std::vector<int64_t> rv(nra), rc(nra, 0);
  for (int64_t i = 0; i < nra; i++) {
    rv[i] = (a_total * i) / nra + static_cast<int64_t>(rng() % 3);
    if (i && rv[i] <= rv[i - 1]) rv[i] = rv[i - 1] + 1;
  }
  for (int64_t left = b_total, i = 0; left > 0; i = (i + 1) % nra) {
    int64_t take = 1 + static_cast<int64_t>(rng() % static_cast<uint64_t>(left));
    rc[i] += take;
    left -= take;
  }

  int64_t cap = na + nb + 2 * nra + 1 + 16;
  std::vector<uint8_t> os1(cap), os2(cap);
  std::vector<int64_t> ol1(cap), ol2(cap);
  int64_t n1 = interleave_runs(a.syms.data(), a.lens.data(), na, b.syms.data(),
                               b.lens.data(), nb, rv.data(), rc.data(), nra,
                               os1.data(), ol1.data());
  CHECK(n1 > 0);
  for (int64_t T : {2, 4, 8}) {
    int64_t n2 = interleave_runs_parallel(
        a.syms.data(), a.lens.data(), na, b.syms.data(), b.lens.data(), nb,
        rv.data(), rc.data(), nra, T, os2.data(), ol2.data());
    CHECK(n2 == n1);
    CHECK(std::memcmp(os1.data(), os2.data(), n1) == 0);
    CHECK(std::memcmp(ol1.data(), ol2.data(), n1 * 8) == 0);
  }

  // corrupt RA: value beyond |A| must error, not hang or overrun
  std::vector<int64_t> bad_v(rv);
  bad_v[nra - 1] = a_total + 1000;
  CHECK(interleave_runs(a.syms.data(), a.lens.data(), na, b.syms.data(),
                        b.lens.data(), nb, bad_v.data(), rc.data(), nra,
                        os1.data(), ol1.data()) == -1);
  // counts not covering |B| must error
  std::vector<int64_t> bad_c(rc);
  bad_c[0] -= 1;
  CHECK(interleave_runs(a.syms.data(), a.lens.data(), na, b.syms.data(),
                        b.lens.data(), nb, rv.data(), bad_c.data(), nra,
                        os1.data(), ol1.data()) == -1);

  // chunked interleave with a capacity too small must return -2 cleanly
  int64_t state[7];
  interleave_state_init(a.lens.data(), na, b.lens.data(), nb, state);
  std::vector<uint8_t> tiny_s(4);
  std::vector<int64_t> tiny_l(4);
  CHECK(interleave_chunk(a.syms.data(), a.lens.data(), na, b.syms.data(),
                         b.lens.data(), nb, rv.data(), rc.data(), nra, 1, 4,
                         state, tiny_s.data(), tiny_l.data()) == -2);
}

// rope_runs over the whole payload at once (seams every `seam` bytes)
// must give the runs of one call a chunk, in buffers of exactly the size
// its count pass asked for; the counts sum every code's length.
void test_rope_runs() {
  for (int64_t n : {0, 1, 2, 31, 64, 1000}) {
    std::vector<uint8_t> codes(n);
    std::vector<int64_t> want(8, 0);
    for (auto& c : codes) {
      uint8_t s = static_cast<uint8_t>(rng() % 3);
      uint8_t l = rng() % 4 ? static_cast<uint8_t>(rng() % 32) : 0;
      c = static_cast<uint8_t>((s << 5) | l);
      want[s] += l;
    }
    for (int64_t seam : {1, 3, 64, 1 << 20}) {
      int64_t st[3] = {-1, 0, 0};
      int64_t m = rope_runs_count(codes.data(), n, seam, 5, 7, 0, 31, 1, st);
      CHECK(m >= 0 && st[0] == -1);
      std::vector<uint8_t> syms(m);
      std::vector<int64_t> lens(m), counts(8, 0);
      CHECK(rope_runs_fill(codes.data(), n, seam, 5, 7, 0, 31, 1, st,
                           syms.data(), lens.data(), counts.data()) == m);
      CHECK(counts == want && st[0] == -1 && st[1] == 0);

      std::vector<uint8_t> cs;
      std::vector<int64_t> cl;
      int64_t ct[3] = {-1, 0, 0};
      for (int64_t at = 0; at <= n; at += seam) {
        const int64_t k = n - at < seam ? n - at : seam;
        const int64_t fin = at + seam > n;
        const int64_t step = k ? k : 1;
        int64_t got = rope_runs_count(codes.data() + at, k, step, 5, 7, 0, 31,
                                      fin, ct);
        std::vector<uint8_t> s(got);
        std::vector<int64_t> l(got);
        CHECK(rope_runs_fill(codes.data() + at, k, step, 5, 7, 0, 31, fin, ct,
                             s.data(), l.data(), nullptr) == got);
        cs.insert(cs.end(), s.begin(), s.end());
        cl.insert(cl.end(), l.begin(), l.end());
      }
      CHECK(cs == syms && cl == lens);
    }
  }
  int64_t st[3] = {-1, 0, 0};
  uint8_t code = 0;
  CHECK(rope_runs_count(&code, 1, 0, 5, 7, 0, 31, 1, st) == -1);
  CHECK(rope_runs_fill(&code, 1, 1, 5, 8, 0, 31, 1, st, &code, st,
                       nullptr) == -1);
  CHECK(st[0] == -1 && st[1] == 0 && st[2] == 0);
}

void test_run_sym_sums() {
  for (int64_t n : {0, 1, 5, 1000}) {
    Runs r = random_runs(n, 1 << 20);
    std::vector<int64_t> want(256, 0), got(256);
    int64_t top = 0;
    for (int64_t i = 0; i < n; i++) {
      want[r.syms[i]] += r.lens[i];
      if (r.syms[i] + 1 > top) top = r.syms[i] + 1;
    }
    CHECK(run_sym_sums(r.syms.data(), r.lens.data(), n, got.data()) == top);
    CHECK(got == want);
  }
}

// sga_stream_chunk_totals writes sga_stream_chunk's codes and adds the
// bases and sequences; a buffer too small leaves the state as it was.
void test_sga_totals() {
  Runs r = random_runs(500, 200);
  int64_t n = r.syms.size(), bases = 0, seqs = 0;
  for (int64_t i = 0; i < n; i++) {
    bases += r.lens[i];
    if (r.syms[i] == 0) seqs += r.lens[i];
  }
  std::vector<uint8_t> a(n * 16), b(n * 16);
  int64_t sa[1] = {7}, sb[3] = {7, 100, 10};
  int64_t na = sga_stream_chunk(r.syms.data(), r.lens.data(), n, sa, a.data(),
                                a.size());
  CHECK(na > 0);
  CHECK(sga_stream_chunk_totals(r.syms.data(), r.lens.data(), n, sb, b.data(),
                                b.size()) == na);
  CHECK(std::memcmp(a.data(), b.data(), na) == 0);
  CHECK(sb[0] == sa[0] && sb[1] == 100 + bases && sb[2] == 10 + seqs);
  int64_t sc[3] = {7, 1, 2};
  CHECK(sga_stream_chunk_totals(r.syms.data(), r.lens.data(), n, sc, b.data(),
                                na - 1) == -2);
  CHECK(sc[0] == 7 && sc[1] == 1 && sc[2] == 2);
}

}  // namespace

int main() {
  test_rle_round_trip();
  test_rle_chunked_resume();
  test_ra_codec();
  test_interleave();
  test_rope_runs();
  test_run_sym_sums();
  test_sga_totals();
  std::puts("native selftest: OK");
  return 0;
}
