// Bucket Pippenger MSM for the GPU, written once for two executors.
//
// msm_gpu.cu runs it as CUDA kernels (one thread per body call) with CUB's
// radix sort and scan; msm_gpu_host.cpp runs the very same bodies and driver
// serially on the host, which is how the CPU tests check the index math,
// the recoding and the group law without a card.
//
// Algorithm (after the host Pippenger in msm.cpp, reorganised for a GPU whose
// blocks run in no order):
//   1. digits: every point is packed from the repo's 16 x 16-bit Montgomery
//      limbs into 8 x 32-bit limbs, and its scalar is recoded into W signed
//      c-bit digits.  Entry (window w, point i) gets the key
//      w * B + |d| - 1 (B = 2^(c-1) buckets per window); zero digits and
//      identity points get the sentinel key W * B.
//   2. the (key, point | sign) pairs are radix-sorted by key, so each bucket
//      is a contiguous run.
//   3. bucket sums: every run is cut into chunks of at most L entries, one
//      thread per chunk; the chunk partials are summed by the same pass
//      again until every bucket holds one point.  A bucket that holds half
//      the points (real witnesses are full of 0/1 cells) thus costs
//      log_L(n) passes, never a serial chain of n additions.
//   4. window sums: each window's buckets are split into G groups of B/G;
//      a group is one running sum, plus lo * (sum of its buckets), and the G
//      group results are summed by step 3's pass.
//   5. Horner across windows on one thread.
// Points are XYZZ (x = X/ZZ, y = Y/ZZZ).  Every addition is complete:
// duplicate points double, opposite points cancel, identities pass through.
#pragma once

#include <cstddef>
#include <cstdint>

#if defined(__CUDACC__)
#define MHD __host__ __device__ __forceinline__
// rarely taken paths (doublings inside an addition): a call, not a copy
#define MHD_COLD __host__ __device__ __noinline__
#define UNROLL _Pragma("unroll")
#else
#define MHD inline
#define MHD_COLD inline
#define UNROLL
#endif

namespace mira_msm {

typedef uint32_t u32;
typedef uint64_t u64;

// Base fields of the two curves, 8 x 32-bit little-endian limbs, Montgomery
// radix R = 2^256 (the radix of fields/limbs.py).  N0 = -p^-1 mod 2^32.
struct Bn254Fq {
  static constexpr u32 N0 = 0xe4866389u;
  MHD static u32 p(int i) {
    const u32 v[8] = {0xd87cfd47u, 0x3c208c16u, 0x6871ca8du, 0x97816a91u,
                      0x8181585du, 0xb85045b6u, 0xe131a029u, 0x30644e72u};
    return v[i];
  }
  MHD static u32 one(int i) {  // R mod p
    const u32 v[8] = {0xc58f0d9du, 0xd35d438du, 0xf5c70b3du, 0x0a78eb28u,
                      0x7879462cu, 0x666ea36fu, 0x9a07df2fu, 0x0e0a77c1u};
    return v[i];
  }
};

struct GrumpkinFq {  // = the BN254 scalar field
  static constexpr u32 N0 = 0xefffffffu;
  MHD static u32 p(int i) {
    const u32 v[8] = {0xf0000001u, 0x43e1f593u, 0x79b97091u, 0x2833e848u,
                      0x8181585du, 0xb85045b6u, 0xe131a029u, 0x30644e72u};
    return v[i];
  }
  MHD static u32 one(int i) {
    const u32 v[8] = {0x4ffffffbu, 0xac96341cu, 0x9f60cd29u, 0x36fc7695u,
                      0x7879462eu, 0x666ea36fu, 0x9a07df2fu, 0x0e0a77c1u};
    return v[i];
  }
};

// ---------------------------------------------------------------------------
// Field: canonical values in [0, p), p < 2^254.

struct fe {
  u32 v[8];
};

MHD bool fe_is_zero(const fe& a) {
  u32 x = 0;
  UNROLL for (int i = 0; i < 8; ++i) x |= a.v[i];
  return x == 0;
}

MHD void fe_set_zero(fe& a) {
  UNROLL for (int i = 0; i < 8; ++i) a.v[i] = 0;
}

template <class F>
MHD void fe_set_one(fe& a) {
  UNROLL for (int i = 0; i < 8; ++i) a.v[i] = F::one(i);
}

// t (< 2p, with t8 the bit above limb 7) -> t mod p
template <class F>
MHD void fe_reduce_once(fe& r, const u32 t[8], u32 t8) {
  u32 s[8];
  u64 br = 0;
  UNROLL for (int i = 0; i < 8; ++i) {
    u64 d = (u64)t[i] - F::p(i) - br;
    s[i] = (u32)d;
    br = d >> 63;
  }
  bool keep = (t8 == 0) && br;  // t < p
  UNROLL for (int i = 0; i < 8; ++i) r.v[i] = keep ? t[i] : s[i];
}

template <class F>
MHD void fe_add(fe& r, const fe& a, const fe& b) {
  u32 t[8];
  u64 c = 0;
  UNROLL for (int i = 0; i < 8; ++i) {
    c += (u64)a.v[i] + b.v[i];
    t[i] = (u32)c;
    c >>= 32;
  }
  fe_reduce_once<F>(r, t, (u32)c);
}

template <class F>
MHD void fe_sub(fe& r, const fe& a, const fe& b) {
  u32 t[8];
  u64 br = 0;
  UNROLL for (int i = 0; i < 8; ++i) {
    u64 d = (u64)a.v[i] - b.v[i] - br;
    t[i] = (u32)d;
    br = d >> 63;
  }
  u32 m = 0u - (u32)br;  // add p back on borrow
  u64 c = 0;
  UNROLL for (int i = 0; i < 8; ++i) {
    c += (u64)t[i] + (F::p(i) & m);
    r.v[i] = (u32)c;
    c >>= 32;
  }
}

template <class F>
MHD void fe_neg(fe& r, const fe& a) {
  fe z;
  fe_set_zero(z);
  fe_sub<F>(r, z, a);
}

// CIOS Montgomery multiplication: a * b * R^-1 mod p.
template <class F>
MHD void fe_mul(fe& r, const fe& a, const fe& b) {
  u32 t[10];
  UNROLL for (int i = 0; i < 10; ++i) t[i] = 0;
  UNROLL for (int i = 0; i < 8; ++i) {
    u64 c = 0;
    UNROLL for (int j = 0; j < 8; ++j) {
      c += (u64)a.v[j] * b.v[i] + t[j];
      t[j] = (u32)c;
      c >>= 32;
    }
    c += t[8];
    t[8] = (u32)c;
    t[9] = (u32)(c >> 32);
    u32 m = t[0] * F::N0;
    c = ((u64)m * F::p(0) + t[0]) >> 32;
    UNROLL for (int j = 1; j < 8; ++j) {
      c += (u64)m * F::p(j) + t[j];
      t[j - 1] = (u32)c;
      c >>= 32;
    }
    c += t[8];
    t[7] = (u32)c;
    t[8] = t[9] + (u32)(c >> 32);
  }
  fe_reduce_once<F>(r, t, t[8]);
}

// ---------------------------------------------------------------------------
// XYZZ points on y^2 = x^3 + b; identity <=> ZZ == 0.

struct xyzz {
  fe x, y, zz, zzz;
};

struct aff {
  fe x, y;
};

MHD bool pt_is_id(const xyzz& p) { return fe_is_zero(p.zz); }

MHD void pt_set_id(xyzz& p) {
  fe_set_zero(p.x);
  fe_set_zero(p.y);
  fe_set_zero(p.zz);
  fe_set_zero(p.zzz);
}

// r = 2 * (x, y) for an affine point (mdbl-2008-s-1, a = 0)
template <class F>
MHD_COLD void pt_mdbl(xyzz& r, const fe& x, const fe& y) {
  fe U, V, W, S, M, t, X3, Y3;
  fe_add<F>(U, y, y);
  fe_mul<F>(V, U, U);
  fe_mul<F>(W, U, V);
  fe_mul<F>(S, x, V);
  fe_mul<F>(t, x, x);
  fe_add<F>(M, t, t);
  fe_add<F>(M, M, t);
  fe_mul<F>(X3, M, M);
  fe_add<F>(t, S, S);
  fe_sub<F>(X3, X3, t);
  fe_sub<F>(t, S, X3);
  fe_mul<F>(Y3, M, t);
  fe_mul<F>(t, W, y);
  fe_sub<F>(Y3, Y3, t);
  r.x = X3;
  r.y = Y3;
  r.zz = V;
  r.zzz = W;
}

// r = 2 * p (dbl-2008-s-1, a = 0); r may alias p
template <class F>
MHD_COLD void pt_dbl(xyzz& r, const xyzz& p) {
  if (pt_is_id(p)) {
    r = p;
    return;
  }
  fe U, V, W, S, M, t, X3, Y3;
  fe_add<F>(U, p.y, p.y);
  fe_mul<F>(V, U, U);
  fe_mul<F>(W, U, V);
  fe_mul<F>(S, p.x, V);
  fe_mul<F>(t, p.x, p.x);
  fe_add<F>(M, t, t);
  fe_add<F>(M, M, t);
  fe_mul<F>(X3, M, M);
  fe_add<F>(t, S, S);
  fe_sub<F>(X3, X3, t);
  fe_sub<F>(t, S, X3);
  fe_mul<F>(Y3, M, t);
  fe_mul<F>(t, W, p.y);
  fe_sub<F>(Y3, Y3, t);
  fe_mul<F>(r.zz, V, p.zz);
  fe_mul<F>(r.zzz, W, p.zzz);
  r.x = X3;
  r.y = Y3;
}

// p += (x2, y2), complete (madd-2008-s with the equal / opposite cases)
template <class F>
MHD void pt_madd(xyzz& p, const fe& x2, const fe& y2) {
  if (pt_is_id(p)) {
    p.x = x2;
    p.y = y2;
    fe_set_one<F>(p.zz);
    fe_set_one<F>(p.zzz);
    return;
  }
  fe U2, S2, P, R;
  fe_mul<F>(U2, x2, p.zz);
  fe_mul<F>(S2, y2, p.zzz);
  fe_sub<F>(P, U2, p.x);
  fe_sub<F>(R, S2, p.y);
  if (fe_is_zero(P)) {
    if (fe_is_zero(R))
      pt_mdbl<F>(p, x2, y2);
    else
      pt_set_id(p);
    return;
  }
  fe PP, PPP, Q, t, X3, Y3;
  fe_mul<F>(PP, P, P);
  fe_mul<F>(PPP, P, PP);
  fe_mul<F>(Q, p.x, PP);
  fe_mul<F>(X3, R, R);
  fe_sub<F>(X3, X3, PPP);
  fe_add<F>(t, Q, Q);
  fe_sub<F>(X3, X3, t);
  fe_sub<F>(t, Q, X3);
  fe_mul<F>(t, R, t);
  fe_mul<F>(Y3, p.y, PPP);
  fe_sub<F>(Y3, t, Y3);
  fe_mul<F>(p.zz, p.zz, PP);
  fe_mul<F>(p.zzz, p.zzz, PPP);
  p.x = X3;
  p.y = Y3;
}

// p += q, complete (add-2008-s with the equal / opposite cases)
template <class F>
MHD void pt_add(xyzz& p, const xyzz& q) {
  if (pt_is_id(q)) return;
  if (pt_is_id(p)) {
    p = q;
    return;
  }
  fe U1, U2, S1, S2, P, R;
  fe_mul<F>(U1, p.x, q.zz);
  fe_mul<F>(U2, q.x, p.zz);
  fe_mul<F>(S1, p.y, q.zzz);
  fe_mul<F>(S2, q.y, p.zzz);
  fe_sub<F>(P, U2, U1);
  fe_sub<F>(R, S2, S1);
  if (fe_is_zero(P)) {
    if (fe_is_zero(R))
      pt_dbl<F>(p, p);
    else
      pt_set_id(p);
    return;
  }
  fe PP, PPP, Q, t, X3, Y3;
  fe_mul<F>(PP, P, P);
  fe_mul<F>(PPP, P, PP);
  fe_mul<F>(Q, U1, PP);
  fe_mul<F>(X3, R, R);
  fe_sub<F>(X3, X3, PPP);
  fe_add<F>(t, Q, Q);
  fe_sub<F>(X3, X3, t);
  fe_sub<F>(t, Q, X3);
  fe_mul<F>(t, R, t);
  fe_mul<F>(Y3, S1, PPP);
  fe_sub<F>(Y3, t, Y3);
  fe_mul<F>(t, p.zz, q.zz);
  fe_mul<F>(p.zz, t, PP);
  fe_mul<F>(t, p.zzz, q.zzz);
  fe_mul<F>(p.zzz, t, PPP);
  p.x = X3;
  p.y = Y3;
}

// p += k * q for a small k (MSB-first double-and-add)
template <class F>
MHD_COLD void pt_add_small_multiple(xyzz& p, const xyzz& q, u32 k) {
  xyzz r;
  pt_set_id(r);
  for (int bit = 31; bit >= 0; --bit) {
    pt_dbl<F>(r, r);
    if ((k >> bit) & 1u) pt_add<F>(r, q);
  }
  pt_add<F>(p, r);
}

// ---------------------------------------------------------------------------
// 16 x 16-bit limb rows (the repo's layout) <-> 8 x 32-bit limbs

MHD void fe_from_limbs16(fe& r, const u32* l16) {
  UNROLL for (int i = 0; i < 8; ++i) r.v[i] = (l16[2 * i] & 0xffffu) | (l16[2 * i + 1] << 16);
}

MHD void fe_to_limbs16(u32* l16, const fe& a) {
  UNROLL for (int i = 0; i < 8; ++i) {
    l16[2 * i] = a.v[i] & 0xffffu;
    l16[2 * i + 1] = a.v[i] >> 16;
  }
}

// bits [lo, lo + c) of a 256-bit scalar, c <= 16
MHD u32 scalar_bits(const u32 s[8], u32 lo, u32 c) {
  u32 w = lo >> 5, off = lo & 31u;
  if (w >= 8) return 0;
  u64 v = s[w];
  if (w + 1 < 8) v |= (u64)s[w + 1] << 32;
  return (u32)(v >> off) & ((1u << c) - 1u);
}

// ---------------------------------------------------------------------------
// Plan: sizes and the layout of the one scratch buffer.

constexpr u32 CHUNK = 32;       // entries one thread sums in a reduction pass
constexpr u32 GROUP_SIZE = 32;  // buckets per group in the window sums
constexpr u32 SCALAR_BITS = 255;  // both scalar fields are < 2^254

struct Plan {
  u64 n, M, pmax;
  u32 c, W, B, nb, G, key_bits, levels1, levels2;
  size_t o_pts, o_keys_a, o_vals_a, o_keys_b, o_vals_b, o_start, o_cnt;
  size_t o_nch[2], o_choff[2], o_part[2], o_temp, temp_bytes, total;
};

inline u32 ceil_div_u32(u64 a, u64 b) { return (u32)((a + b - 1) / b); }

inline u32 reduction_levels(u64 m) {
  u32 levels = 0;
  while (m > 1) {
    m = (m + CHUNK - 1) / CHUNK;
    ++levels;
  }
  return levels;
}

inline Plan make_plan(u64 n, u32 c, size_t temp_bytes) {
  Plan pl{};
  pl.n = n;
  pl.c = c;
  pl.W = (SCALAR_BITS + c - 1) / c;
  pl.B = 1u << (c - 1);
  pl.nb = pl.W * pl.B;
  pl.G = pl.B > GROUP_SIZE ? pl.B / GROUP_SIZE : 1;
  pl.key_bits = 0;
  while ((1ull << pl.key_bits) <= pl.nb) ++pl.key_bits;  // sentinel key = nb
  pl.M = (u64)pl.W * n;
  pl.levels1 = reduction_levels(n);
  if (pl.levels1 == 0) pl.levels1 = 1;  // one pass turns affine into XYZZ
  pl.levels2 = reduction_levels(pl.G);
  pl.pmax = (pl.M + CHUNK - 1) / CHUNK + pl.nb + 1;
  size_t off = 0;
  auto take = [&off](size_t bytes) {
    size_t at = off;
    off += (bytes + 255) & ~(size_t)255;
    return at;
  };
  pl.o_pts = take(n * sizeof(aff));
  pl.o_keys_a = take(pl.M * 4);
  pl.o_vals_a = take(pl.M * 4);
  pl.o_keys_b = take(pl.M * 4);
  pl.o_vals_b = take(pl.M * 4);
  pl.o_start = take((pl.nb + 1) * 4);
  pl.o_cnt = take((pl.nb + 1) * 4);
  for (int i = 0; i < 2; ++i) {
    pl.o_nch[i] = take((pl.nb + 1) * 4);
    pl.o_choff[i] = take((pl.nb + 1) * 4);
    pl.o_part[i] = take(pl.pmax * sizeof(xyzz));
  }
  pl.temp_bytes = temp_bytes;
  pl.o_temp = take(temp_bytes ? temp_bytes : 1);
  pl.total = off;
  return pl;
}

// ---------------------------------------------------------------------------
// Per-thread bodies.  Each is called once per thread index t.

// point i: pack x, y; recode scalar i into W signed digits
struct DigitsBody {
  const u32 *sc16, *x16, *y16, *z16;
  aff* pts;
  u32 *keys, *vals;
  u64 n;
  u32 c, W, B, sentinel;
  MHD void operator()(u64 i) const {
    u32 zor = 0;
    for (int k = 0; k < 16; ++k) zor |= z16[i * 16 + k];
    bool ident = zor == 0;
    fe_from_limbs16(pts[i].x, x16 + i * 16);
    fe_from_limbs16(pts[i].y, y16 + i * 16);
    u32 s[8];
    for (int k = 0; k < 8; ++k)
      s[k] = (sc16[i * 16 + 2 * k] & 0xffffu) | (sc16[i * 16 + 2 * k + 1] << 16);
    u32 carry = 0;
    for (u32 w = 0; w < W; ++w) {
      u32 raw = scalar_bits(s, w * c, c) + carry;
      u32 mag, neg;
      if (raw > B) {  // digit raw - 2^c, in (-B, 0]
        mag = (2u * B) - raw;
        neg = 1;
        carry = 1;
      } else {
        mag = raw;
        neg = 0;
        carry = 0;
      }
      u64 e = (u64)w * n + i;
      keys[e] = (ident || mag == 0) ? sentinel : w * B + mag - 1;
      vals[e] = (u32)i | (neg << 31);
    }
  }
};

// sorted entry j: mark where its bucket starts and ends
struct BoundsBody {
  const u32* keys;
  u32 *start, *cnt;  // cnt holds the end index until CountBody
  u64 M;
  u32 sentinel;
  MHD void operator()(u64 j) const {
    u32 k = keys[j];
    if (k == sentinel) return;
    if (j == 0 || keys[j - 1] != k) start[k] = (u32)j;
    if (j == M - 1 || keys[j + 1] != k) cnt[k] = (u32)(j + 1);
  }
};

struct CountBody {  // cnt[b] = end[b] - start[b]
  const u32* start;
  u32* cnt;
  MHD void operator()(u64 b) const { cnt[b] -= start[b]; }
};

struct ChunkCountBody {  // chunks per segment; entry nseg is 0 for the scan
  const u32* cnt;
  u32* nch;
  u32 nseg;
  MHD void operator()(u64 b) const {
    nch[b] = b < nseg ? (cnt[b] + CHUNK - 1) / CHUNK : 0;
  }
};

struct SegmentsBody {  // the window pass input: W segments of G groups
  u32 *start, *cnt;
  u32 G;
  MHD void operator()(u64 w) const {
    start[w] = (u32)w * G;
    cnt[w] = G;
  }
};

// One reduction pass: chunk t of segment b sums at most CHUNK entries.
// Affine = true reads the sorted (point | sign) entries of step 1.
template <class F, bool Affine>
struct ReduceBody {
  const aff* pts;
  const u32* vals;
  const xyzz* in;
  const u32 *start, *cnt, *choff;
  xyzz* out;
  u32 nseg;
  MHD void operator()(u64 t) const {
    if (t >= choff[nseg]) return;
    u32 lo = 0, hi = nseg;  // last segment whose first chunk is <= t
    while (hi - lo > 1) {
      u32 mid = (lo + hi) / 2;
      if (choff[mid] <= t)
        lo = mid;
      else
        hi = mid;
    }
    u32 b = lo;
    u32 first = start[b] + ((u32)t - choff[b]) * CHUNK;
    u32 last = start[b] + cnt[b];
    if (last > first + CHUNK) last = first + CHUNK;
    xyzz acc;
    pt_set_id(acc);
    for (u32 j = first; j < last; ++j) {
      if (Affine) {
        u32 v = vals[j];
        const aff& q = pts[v & 0x7fffffffu];
        fe y = q.y;
        if (v >> 31) fe_neg<F>(y, q.y);
        pt_madd<F>(acc, q.x, y);
      } else {
        pt_add<F>(acc, in[j]);
      }
    }
    out[t] = acc;
  }
};

// group (w, g): sum over its buckets b of (b + 1) * bucket[b]
template <class F>
struct GroupBody {
  const xyzz* part;
  const u32 *start, *cnt;
  xyzz* out;
  u32 B, G;
  MHD void operator()(u64 t) const {
    u32 w = (u32)(t / G), g = (u32)(t % G);
    u32 size = B / G, lo = g * size;
    xyzz run, acc;
    pt_set_id(run);
    pt_set_id(acc);
    for (u32 b = lo + size; b-- > lo;) {
      u32 k = w * B + b;
      if (cnt[k]) pt_add<F>(run, part[start[k]]);
      pt_add<F>(acc, run);
    }
    // acc = sum (b - lo + 1) * bucket[b]; add lo * sum bucket[b]
    pt_add_small_multiple<F>(acc, run, lo);
    out[t] = acc;
  }
};

// Horner across windows; writes the Jacobian result as 3 x 16 limbs
template <class F>
struct FinalBody {
  const xyzz* win;
  const u32 *start, *cnt;
  u32* out16;
  u32 W, c;
  MHD void operator()(u64) const {
    xyzz acc;
    pt_set_id(acc);
    for (u32 w = W; w-- > 0;) {
      for (u32 i = 0; i < c; ++i) pt_dbl<F>(acc, acc);
      if (cnt[w]) pt_add<F>(acc, win[start[w]]);
    }
    fe X, Y, Z, t, u;
    if (pt_is_id(acc)) {
      fe_set_zero(X);
      fe_set_zero(Y);
      fe_set_zero(Z);
    } else {
      // Jacobian Z = ZZ * ZZZ: X = x ZZ ZZZ^2, Y = y ZZ^3 ZZZ^2
      fe_mul<F>(Z, acc.zz, acc.zzz);
      fe_mul<F>(t, acc.zzz, acc.zzz);
      fe_mul<F>(u, acc.x, acc.zz);
      fe_mul<F>(X, u, t);
      fe_mul<F>(u, acc.zz, acc.zz);
      fe_mul<F>(u, u, acc.zz);
      fe_mul<F>(u, u, t);
      fe_mul<F>(Y, acc.y, u);
    }
    fe_to_limbs16(out16, X);
    fe_to_limbs16(out16 + 16, Y);
    fe_to_limbs16(out16 + 32, Z);
  }
};

// ---------------------------------------------------------------------------
// Driver.  Exec provides launch(body, nthreads), sort_pairs, exclusive_scan
// and zero; it only enqueues work.

template <class F, class Exec>
void run_msm(Exec& ex, const Plan& pl, char* scratch, const u32* sc16,
             const u32* x16, const u32* y16, const u32* z16, u32* out16) {
  aff* pts = (aff*)(scratch + pl.o_pts);
  u32* keys_a = (u32*)(scratch + pl.o_keys_a);
  u32* vals_a = (u32*)(scratch + pl.o_vals_a);
  u32* keys_b = (u32*)(scratch + pl.o_keys_b);
  u32* vals_b = (u32*)(scratch + pl.o_vals_b);
  u32* start = (u32*)(scratch + pl.o_start);
  u32* cnt = (u32*)(scratch + pl.o_cnt);
  u32* nch[2] = {(u32*)(scratch + pl.o_nch[0]), (u32*)(scratch + pl.o_nch[1])};
  u32* choff[2] = {(u32*)(scratch + pl.o_choff[0]), (u32*)(scratch + pl.o_choff[1])};
  xyzz* part[2] = {(xyzz*)(scratch + pl.o_part[0]), (xyzz*)(scratch + pl.o_part[1])};
  const u32 sentinel = pl.nb;

  // 1-2. digits, sort by bucket
  ex.launch(DigitsBody{sc16, x16, y16, z16, pts, keys_a, vals_a, pl.n, pl.c,
                       pl.W, pl.B, sentinel},
            pl.n);
  ex.sort_pairs(keys_a, keys_b, vals_a, vals_b, pl.M, (int)pl.key_bits);
  ex.zero(start, (pl.nb + 1) * 4);
  ex.zero(cnt, (pl.nb + 1) * 4);
  ex.launch(BoundsBody{keys_b, start, cnt, pl.M, sentinel}, pl.M);
  ex.launch(CountBody{start, cnt}, pl.nb);

  // 3. bucket sums: passes until every bucket holds at most one point
  const u32 *seg_start = start, *seg_cnt = cnt;
  const xyzz* in = nullptr;
  u64 bound = pl.M;
  int cur = 0;
  for (u32 level = 0; level < pl.levels1; ++level) {
    ex.launch(ChunkCountBody{seg_cnt, nch[cur], pl.nb}, (u64)pl.nb + 1);
    ex.exclusive_scan(nch[cur], choff[cur], (u64)pl.nb + 1);
    bound = (bound + CHUNK - 1) / CHUNK + pl.nb;
    if (level == 0)
      ex.launch(ReduceBody<F, true>{pts, vals_b, nullptr, seg_start, seg_cnt,
                                    choff[cur], part[cur], pl.nb},
                bound);
    else
      ex.launch(ReduceBody<F, false>{nullptr, nullptr, in, seg_start, seg_cnt,
                                     choff[cur], part[cur], pl.nb},
                bound);
    in = part[cur];
    seg_start = choff[cur];
    seg_cnt = nch[cur];
    cur ^= 1;
  }

  // 4. window sums: groups, then passes over each window's G groups
  xyzz* groups = part[cur];
  ex.launch(GroupBody<F>{in, seg_start, seg_cnt, groups, pl.B, pl.G},
            (u64)pl.W * pl.G);
  ex.launch(SegmentsBody{start, cnt, pl.G}, pl.W);
  ex.zero(start + pl.W, 4);
  ex.zero(cnt + pl.W, 4);
  seg_start = start;
  seg_cnt = cnt;
  in = groups;
  cur ^= 1;
  bound = (u64)pl.W * pl.G;
  for (u32 level = 0; level < pl.levels2; ++level) {
    ex.launch(ChunkCountBody{seg_cnt, nch[cur], pl.W}, (u64)pl.W + 1);
    ex.exclusive_scan(nch[cur], choff[cur], (u64)pl.W + 1);
    bound = (bound + CHUNK - 1) / CHUNK + pl.W;
    ex.launch(ReduceBody<F, false>{nullptr, nullptr, in, seg_start, seg_cnt,
                                   choff[cur], part[cur], pl.W},
              bound);
    in = part[cur];
    seg_start = choff[cur];
    seg_cnt = nch[cur];
    cur ^= 1;
  }

  // 5. Horner
  ex.launch(FinalBody<F>{in, seg_start, seg_cnt, out16, pl.W, pl.c}, 1);
}

}  // namespace mira_msm
