// Native host Pippenger MSM for short-Weierstrass a=0 curves (BN254 G1,
// Grumpkin) over arbitrary 256-bit prime fields.
//
// This is the runtime-side (CPU) commitment engine — the role the reference's
// Rust `best_multiexp` plays (/root/reference/src/commitment.rs:78-87 via
// halo2curves); the GPU path (msm_gpu.cu) is separate.  Plain
// (non-Montgomery) little-endian 4x64 limbs in, Jacobian plain limbs out;
// Montgomery conversion happens internally so the ABI stays representation-
// agnostic.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 -pthread msm.cpp -o libmiramsm.so

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

typedef unsigned __int128 u128;

namespace {

struct Fp {
  uint64_t v[4];
};

struct Field {
  Fp p;        // modulus
  Fp r2;       // R^2 mod p (to enter Montgomery form)
  uint64_t n0; // -p^-1 mod 2^64
};

inline bool geq(const Fp &a, const Fp &b) {
  for (int i = 3; i >= 0; --i) {
    if (a.v[i] != b.v[i]) return a.v[i] > b.v[i];
  }
  return true;
}

inline void sub_nored(Fp &out, const Fp &a, const Fp &b) {
  u128 borrow = 0;
  for (int i = 0; i < 4; ++i) {
    u128 d = (u128)a.v[i] - b.v[i] - borrow;
    out.v[i] = (uint64_t)d;
    borrow = (d >> 64) ? 1 : 0;
  }
}

inline void add(const Field &f, Fp &out, const Fp &a, const Fp &b) {
  u128 carry = 0;
  for (int i = 0; i < 4; ++i) {
    u128 s = (u128)a.v[i] + b.v[i] + (uint64_t)carry;
    out.v[i] = (uint64_t)s;
    carry = s >> 64;
  }
  if (carry || geq(out, f.p)) sub_nored(out, out, f.p);
}

inline void sub(const Field &f, Fp &out, const Fp &a, const Fp &b) {
  if (geq(a, b)) {
    sub_nored(out, a, b);
  } else {
    Fp t;
    sub_nored(t, b, a);
    sub_nored(out, f.p, t);
  }
}

inline bool is_zero(const Fp &a) {
  return (a.v[0] | a.v[1] | a.v[2] | a.v[3]) == 0;
}

// CIOS Montgomery multiplication, 4x64 (classic 256-bit form).
inline void mul(const Field &f, Fp &out, const Fp &a, const Fp &b) {
  uint64_t t[6] = {0, 0, 0, 0, 0, 0};
  for (int i = 0; i < 4; ++i) {
    u128 carry = 0;
    for (int j = 0; j < 4; ++j) {
      u128 s = (u128)a.v[j] * b.v[i] + t[j] + (uint64_t)carry;
      t[j] = (uint64_t)s;
      carry = s >> 64;
    }
    u128 s = (u128)t[4] + (uint64_t)carry;
    t[4] = (uint64_t)s;
    t[5] = (uint64_t)(s >> 64);

    uint64_t m = t[0] * f.n0;
    carry = ((u128)m * f.p.v[0] + t[0]) >> 64;
    for (int j = 1; j < 4; ++j) {
      u128 s2 = (u128)m * f.p.v[j] + t[j] + (uint64_t)carry;
      t[j - 1] = (uint64_t)s2;
      carry = s2 >> 64;
    }
    s = (u128)t[4] + (uint64_t)carry;
    t[3] = (uint64_t)s;
    t[4] = t[5] + (uint64_t)(s >> 64);
  }
  Fp r{{t[0], t[1], t[2], t[3]}};
  if (t[4] || geq(r, f.p)) sub_nored(r, r, f.p);
  out = r;
}

inline void sqr(const Field &f, Fp &out, const Fp &a) { mul(f, out, a, a); }

inline void to_mont(const Field &f, Fp &out, const Fp &a) {
  mul(f, out, a, f.r2);
}

inline void from_mont(const Field &f, Fp &out, const Fp &a) {
  Fp one{{1, 0, 0, 0}};
  mul(f, out, a, one);
}

inline void dbl_fp(const Field &f, Fp &out, const Fp &a) { add(f, out, a, a); }

// Jacobian point; infinity encoded as Z == 0.
struct Pt {
  Fp X, Y, Z;
};

inline bool pt_is_inf(const Pt &p) { return is_zero(p.Z); }

// dbl-2009-l (a = 0)
inline void pt_double(const Field &f, Pt &out, const Pt &p) {
  if (pt_is_inf(p)) {
    out = p;
    return;
  }
  // `out` may alias `p` (acc = 2*acc): compute into a local first
  Pt r;
  Fp A, B, C, D, E, F2, t;
  sqr(f, A, p.X);
  sqr(f, B, p.Y);
  sqr(f, C, B);
  add(f, t, p.X, B);
  sqr(f, t, t);
  sub(f, t, t, A);
  sub(f, t, t, C);
  dbl_fp(f, D, t);
  dbl_fp(f, E, A);
  add(f, E, E, A);
  sqr(f, F2, E);
  // X3 = F - 2D
  dbl_fp(f, t, D);
  sub(f, r.X, F2, t);
  // Y3 = E*(D - X3) - 8C
  sub(f, t, D, r.X);
  mul(f, t, E, t);
  dbl_fp(f, C, C);
  dbl_fp(f, C, C);
  dbl_fp(f, C, C);
  sub(f, r.Y, t, C);
  // Z3 = 2*Y*Z
  mul(f, t, p.Y, p.Z);
  dbl_fp(f, r.Z, t);
  out = r;
}

// add-2007-bl, with identity / doubling / opposite handling.
inline void pt_add(const Field &f, Pt &out, const Pt &p, const Pt &q) {
  if (pt_is_inf(p)) {
    out = q;
    return;
  }
  if (pt_is_inf(q)) {
    out = p;
    return;
  }
  Fp Z1Z1, Z2Z2, U1, U2, S1, S2, H, R, HH, HHH, V, t;
  sqr(f, Z1Z1, p.Z);
  sqr(f, Z2Z2, q.Z);
  mul(f, U1, p.X, Z2Z2);
  mul(f, U2, q.X, Z1Z1);
  mul(f, t, p.Y, q.Z);
  mul(f, S1, t, Z2Z2);
  mul(f, t, q.Y, p.Z);
  mul(f, S2, t, Z1Z1);
  sub(f, H, U2, U1);
  sub(f, R, S2, S1);
  if (is_zero(H)) {
    if (is_zero(R)) {
      pt_double(f, out, p);
    } else {
      std::memset(&out, 0, sizeof(out)); // infinity
    }
    return;
  }
  sqr(f, HH, H);
  mul(f, HHH, H, HH);
  mul(f, V, U1, HH);
  // `out` may alias `p` or `q`: compute into a local first
  Pt r;
  sqr(f, t, R);
  sub(f, t, t, HHH);
  Fp V2;
  dbl_fp(f, V2, V);
  sub(f, r.X, t, V2);
  sub(f, t, V, r.X);
  mul(f, t, R, t);
  Fp t2;
  mul(f, t2, S1, HHH);
  sub(f, r.Y, t, t2);
  mul(f, t, p.Z, q.Z);
  mul(f, r.Z, t, H);
  out = r;
}

inline void pt_add_mixed_affine(const Field &f, Pt &acc, const Fp &x,
                                const Fp &y, const Fp &one_mont) {
  Pt q{x, y, one_mont};
  pt_add(f, acc, acc, q);
}

void field_setup(Field &f, const uint64_t *modulus) {
  std::memcpy(f.p.v, modulus, 32);
  // n0 = -p^-1 mod 2^64 via Newton iteration
  uint64_t p0 = f.p.v[0];
  uint64_t inv = 1;
  for (int i = 0; i < 6; ++i) inv *= 2 - p0 * inv;
  f.n0 = ~inv + 1; // -inv
  // r2 = 2^512 mod p, by repeated doubling of (2^256 mod p)
  Fp r{{0, 0, 0, 0}};
  // 2^256 mod p: start from p < 2^256 -> r = 2^256 - p ... compute by
  // doubling 1, 256 times (cheap, setup-only)
  Fp acc{{1, 0, 0, 0}};
  for (int i = 0; i < 512; ++i) add(f, acc, acc, acc);
  f.r2 = acc;
}

struct Job {
  const Field *f;
  const uint64_t *scalars; // n * 4 limbs
  const Fp *xs, *ys;       // Montgomery affine
  const uint8_t *inf;      // 1 = point at infinity / skip
  size_t n;
  int window;
  int nwin;
  Pt *win_out; // per-window partial sums
  Fp one_mont;
};

void window_worker(const Job &job, int w) {
  int nbuckets = (1 << job.window) - 1;
  std::vector<Pt> buckets(nbuckets);
  std::memset(buckets.data(), 0, sizeof(Pt) * nbuckets);
  int shift = w * job.window;
  for (size_t i = 0; i < job.n; ++i) {
    if (job.inf[i]) continue;
    // extract window bits from the 256-bit scalar
    int limb = shift >> 6, off = shift & 63;
    uint64_t lo = job.scalars[i * 4 + limb];
    uint64_t d = lo >> off;
    if (off && limb < 3) d |= job.scalars[i * 4 + limb + 1] << (64 - off);
    d &= (uint64_t)nbuckets;
    if (!d) continue;
    pt_add_mixed_affine(*job.f, buckets[d - 1], job.xs[i], job.ys[i],
                        job.one_mont);
  }
  // running-sum bucket reduction: sum_{d} d * bucket[d]
  Pt run, total;
  std::memset(&run, 0, sizeof(run));
  std::memset(&total, 0, sizeof(total));
  for (int d = nbuckets - 1; d >= 0; --d) {
    pt_add(*job.f, run, run, buckets[d]);
    pt_add(*job.f, total, total, run);
  }
  job.win_out[w] = total;
}

} // namespace

extern "C" {

// scalars: n*4 u64 (plain, LE); xs/ys: n*4 u64 (plain affine; x=y=0 means
// infinity); modulus: 4 u64; out: 12 u64 Jacobian (plain).  nthreads <= 0
// picks hardware concurrency.
void mira_msm(const uint64_t *scalars, const uint64_t *xs, const uint64_t *ys,
              size_t n, const uint64_t *modulus, int window, int nthreads,
              uint64_t *out) {
  Field f;
  field_setup(f, modulus);
  Fp one{{1, 0, 0, 0}}, one_mont;
  to_mont(f, one_mont, one);

  // convert points to Montgomery once
  std::vector<Fp> mx(n), my(n);
  std::vector<uint8_t> inf(n);
  for (size_t i = 0; i < n; ++i) {
    Fp x, y;
    std::memcpy(x.v, xs + i * 4, 32);
    std::memcpy(y.v, ys + i * 4, 32);
    inf[i] = (uint8_t)(is_zero(x) && is_zero(y));
    to_mont(f, mx[i], x);
    to_mont(f, my[i], y);
  }

  if (window <= 0) {
    window = 3;
    for (size_t t = n; t > 32; t >>= 4) window += 2; // ~log2(n)/2
    if (window > 16) window = 16;
  }
  int nwin = (256 + window - 1) / window;
  std::vector<Pt> win_out(nwin);

  Job job{&f,   scalars, mx.data(), my.data(), inf.data(), n,
          window, nwin,  win_out.data(), one_mont};

  if (nthreads <= 0) nthreads = (int)std::thread::hardware_concurrency();
  if (nthreads < 1) nthreads = 1;
  if (nthreads > nwin) nthreads = nwin;
  std::vector<std::thread> threads;
  std::vector<int> next(1, 0);
  for (int t = 0; t < nthreads; ++t) {
    threads.emplace_back([&job, t, nthreads]() {
      for (int w = t; w < job.nwin; w += nthreads) window_worker(job, w);
    });
  }
  for (auto &th : threads) th.join();

  // horner over windows: acc = acc * 2^window + win_out[w]
  Pt acc;
  std::memset(&acc, 0, sizeof(acc));
  for (int w = nwin - 1; w >= 0; --w) {
    for (int b = 0; b < window; ++b) pt_double(f, acc, acc);
    pt_add(f, acc, acc, win_out[w]);
  }

  Fp X, Y, Z;
  from_mont(f, X, acc.X);
  from_mont(f, Y, acc.Y);
  from_mont(f, Z, acc.Z);
  std::memcpy(out + 0, X.v, 32);
  std::memcpy(out + 4, Y.v, 32);
  std::memcpy(out + 8, Z.v, 32);
}

} // extern "C"
