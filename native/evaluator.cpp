// Native host gate-evaluator VM: row-parallel evaluation of a compiled
// expression op-list over circuit columns, at multiple fold points.
//
// This is the CPU runtime analog of the reference's GraphEvaluator — the
// rayon-parallel row interpreter that is the hot inner loop of folding
// (/root/reference/src/polynomial/graph_evaluator.rs:93-149,
// /root/reference/src/nifs/vanilla/mod.rs:109-116).  It is the fold_eval
// route on both platforms (mira_tpu/routes.py); on CPU hosts XLA:CPU's
// vectorized 16-bit-limb CIOS is far slower than 4x64-bit __int128 scalar
// Montgomery.
//
// All field values are little-endian 4x64 limbs in Montgomery form
// (R = 2^256) — bit-identical to the 16x16-bit device layout reinterpreted
// as bytes.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 -pthread evaluator.cpp -o libmiraeval.so

#include <atomic>
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
  Fp p;
  uint64_t n0;
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

inline void neg(const Field &f, Fp &out, const Fp &a) {
  bool zero = !(a.v[0] | a.v[1] | a.v[2] | a.v[3]);
  if (zero) {
    out = a;
  } else {
    sub_nored(out, f.p, a);
  }
}

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

// Op list entry: {opcode, a, b, dst} int32 each.
// Sources/dest are register indices unless noted.
enum Op : int32_t {
  OP_LOAD_STATIC = 0,  // a = static col slot      -> regs[dst]
  OP_LOAD_FOLD = 1,    // a = advice slot: w1+j*w2 -> regs[dst]
  OP_LOAD_CH = 2,      // a = challenge slot       -> regs[dst]
  OP_LOAD_CONST = 3,   // a = constant slot        -> regs[dst]
  OP_ADD = 4,          // regs[a] + regs[b]        -> regs[dst]
  OP_MUL = 5,          // regs[a] * regs[b]        -> regs[dst]
  OP_NEG = 6,          // -regs[a]                 -> regs[dst]
  OP_OUTPUT = 7,       // regs[a]                  -> out row
};

struct Ctx {
  Field f;
  const int32_t *ops;
  size_t n_ops;
  size_t n_regs;
  const Fp *statics;  // n_sq * nrow
  const Fp *w1;       // n_aq * nrow
  const Fp *w2;       // n_aq * nrow
  const Fp *ch;       // n_j * n_ch
  const Fp *jm;       // n_j
  const Fp *consts;   // n_consts
  size_t nrow;
  size_t n_ch;
  Fp *out;            // n_j * nrow
};

void eval_rows(const Ctx &c, size_t jidx, size_t row_lo, size_t row_hi) {
  std::vector<Fp> regs(c.n_regs);
  const Fp &jmont = c.jm[jidx];
  const Fp *chj = c.ch + jidx * c.n_ch;
  Fp *out = c.out + jidx * c.nrow;
  for (size_t r = row_lo; r < row_hi; ++r) {
    for (size_t k = 0; k < c.n_ops; ++k) {
      const int32_t *op = c.ops + 4 * k;
      Fp &dst = regs[op[3]];
      switch (op[0]) {
        case OP_LOAD_STATIC:
          dst = c.statics[(size_t)op[1] * c.nrow + r];
          break;
        case OP_LOAD_FOLD: {
          Fp t;
          mul(c.f, t, jmont, c.w2[(size_t)op[1] * c.nrow + r]);
          add(c.f, dst, c.w1[(size_t)op[1] * c.nrow + r], t);
          break;
        }
        case OP_LOAD_CH:
          dst = chj[op[1]];
          break;
        case OP_LOAD_CONST:
          dst = c.consts[op[1]];
          break;
        case OP_ADD:
          add(c.f, dst, regs[op[1]], regs[op[2]]);
          break;
        case OP_MUL:
          mul(c.f, dst, regs[op[1]], regs[op[2]]);
          break;
        case OP_NEG:
          neg(c.f, dst, regs[op[1]]);
          break;
        case OP_OUTPUT:
          out[r] = regs[op[1]];
          break;
      }
    }
  }
}

}  // namespace

namespace {

inline void field_init(Field &f, const uint64_t *modulus) {
  std::memcpy(f.p.v, modulus, 32);
  uint64_t p0 = f.p.v[0];
  uint64_t inv = 1;
  for (int i = 0; i < 6; ++i) inv *= 2 - p0 * inv;
  f.n0 = (uint64_t)(0 - inv);
}

template <typename Fn>
void parallel_chunks(size_t n, int nthreads, Fn fn) {
  int hw = nthreads > 0 ? nthreads
                        : (int)std::thread::hardware_concurrency();
  if (hw < 1) hw = 1;
  size_t nchunks = (size_t)hw * 4;
  if (nchunks > n) nchunks = n ? n : 1;
  size_t chunk = (n + nchunks - 1) / nchunks;
  std::atomic<size_t> next(0);
  std::vector<std::thread> threads;
  for (int t = 0; t < hw; ++t) {
    threads.emplace_back([&]() {
      for (;;) {
        size_t ci = next.fetch_add(1);
        size_t lo = ci * chunk;
        if (lo >= n) break;
        size_t hi = lo + chunk;
        if (hi > n) hi = n;
        fn(ci, lo, hi);
      }
    });
  }
  for (auto &th : threads) th.join();
}

}  // namespace

// acc = sum_i mont_mul(w[i], v[i]) over 4x64 Montgomery limbs; out is the
// Montgomery-form inner product.  (The homomorphic mock commitment's
// <weights, witness> — mira_tpu/ops/mock_commitment.py.)
extern "C" void mira_inner_product_mont(
    const uint64_t *modulus, const uint64_t *w, const uint64_t *v,
    size_t n, int nthreads, uint64_t *out) {
  Field f;
  field_init(f, modulus);
  const Fp *wp = (const Fp *)w;
  const Fp *vp = (const Fp *)v;
  size_t maxp = 4096;  // > hw*4 for any plausible core count: one slot per
                       // chunk index, each written by exactly one thread
  std::vector<Fp> partial(maxp);
  for (auto &x : partial) x = Fp{{0, 0, 0, 0}};
  parallel_chunks(n, nthreads, [&](size_t ci, size_t lo, size_t hi) {
    Fp acc{{0, 0, 0, 0}}, t;
    for (size_t i = lo; i < hi; ++i) {
      mul(f, t, wp[i], vp[i]);
      add(f, acc, acc, t);
    }
    add(f, partial[ci % maxp], partial[ci % maxp], acc);
  });
  Fp acc{{0, 0, 0, 0}};
  for (auto &x : partial) add(f, acc, acc, x);
  std::memcpy(out, acc.v, 32);
}

// out[i] = mont_mul(a[i], c) — one constant Montgomery multiply per element
// (to-Montgomery with c = R^2, from-Montgomery with c = 1).
extern "C" void mira_mul_const_mont(
    const uint64_t *modulus, const uint64_t *a, const uint64_t *c,
    size_t n, int nthreads, uint64_t *out) {
  Field f;
  field_init(f, modulus);
  const Fp *ap = (const Fp *)a;
  Fp cv;
  std::memcpy(cv.v, c, 32);
  Fp *op = (Fp *)out;
  parallel_chunks(n, nthreads, [&](size_t, size_t lo, size_t hi) {
    for (size_t i = lo; i < hi; ++i) mul(f, op[i], ap[i], cv);
  });
}

// out[k][i] = sum_j mont_mul(coef[k][j], in[j][i]) — batched linear
// combination of m_in stacked vectors into m_out outputs (the
// inverse-Vandermonde cross-term combine, nifs/vanilla.py).
// 16-bit-limb I/O twins: witness vectors live device-side as (n, 16)
// uint32 16-bit-limb planes; these kernels pack/unpack to 4x64 in registers
// so the layout conversion costs no numpy temporaries (it was the dominant
// cost of the Montgomery witness encode at 2^19-row tables).
static inline void load16(const uint32_t *in, Fp &v) {
  for (int k = 0; k < 4; ++k) {
    v.v[k] = (uint64_t)(uint16_t)in[4 * k] |
             ((uint64_t)(uint16_t)in[4 * k + 1] << 16) |
             ((uint64_t)(uint16_t)in[4 * k + 2] << 32) |
             ((uint64_t)(uint16_t)in[4 * k + 3] << 48);
  }
}

static inline void store16(uint32_t *out, const Fp &v) {
  for (int k = 0; k < 4; ++k) {
    out[4 * k] = (uint32_t)(v.v[k] & 0xffff);
    out[4 * k + 1] = (uint32_t)((v.v[k] >> 16) & 0xffff);
    out[4 * k + 2] = (uint32_t)((v.v[k] >> 32) & 0xffff);
    out[4 * k + 3] = (uint32_t)((v.v[k] >> 48) & 0xffff);
  }
}

extern "C" void mira_mul_const_mont16(
    const uint64_t *modulus, const uint32_t *a16, const uint64_t *c,
    size_t n, int nthreads, uint32_t *out16) {
  Field f;
  field_init(f, modulus);
  Fp cv;
  std::memcpy(cv.v, c, 32);
  parallel_chunks(n, nthreads, [&](size_t, size_t lo, size_t hi) {
    Fp v, o;
    for (size_t i = lo; i < hi; ++i) {
      load16(a16 + 16 * i, v);
      mul(f, o, v, cv);
      store16(out16 + 16 * i, o);
    }
  });
}

extern "C" void mira_inner_product_mont16(
    const uint64_t *modulus, const uint64_t *w_plain64, const uint32_t *v16,
    size_t n, int nthreads, uint64_t *out) {
  Field f;
  field_init(f, modulus);
  const Fp *wp = (const Fp *)w_plain64;
  size_t maxp = 4096;  // one slot per chunk index (see mira_inner_product_mont)
  std::vector<Fp> partial(maxp);
  for (auto &x : partial) x = Fp{{0, 0, 0, 0}};
  parallel_chunks(n, nthreads, [&](size_t ci, size_t lo, size_t hi) {
    Fp acc{{0, 0, 0, 0}}, v, t;
    for (size_t i = lo; i < hi; ++i) {
      load16(v16 + 16 * i, v);
      mul(f, t, wp[i], v);
      add(f, acc, acc, t);
    }
    add(f, partial[ci % maxp], partial[ci % maxp], acc);
  });
  Fp acc{{0, 0, 0, 0}};
  for (auto &x : partial) add(f, acc, acc, x);
  std::memcpy(out, acc.v, 32);
}

extern "C" void mira_lincomb_mont(
    const uint64_t *modulus,
    const uint64_t *ins,    // m_in * n * 4 (Montgomery)
    const uint64_t *coefs,  // m_out * m_in * 4 (Montgomery)
    size_t m_in, size_t m_out, size_t n, int nthreads,
    uint64_t *out           // m_out * n * 4
) {
  Field f;
  field_init(f, modulus);
  const Fp *ip = (const Fp *)ins;
  const Fp *cp = (const Fp *)coefs;
  Fp *op = (Fp *)out;
  parallel_chunks(n, nthreads, [&](size_t, size_t lo, size_t hi) {
    Fp t;
    for (size_t i = lo; i < hi; ++i) {
      for (size_t k = 0; k < m_out; ++k) {
        Fp acc{{0, 0, 0, 0}};
        for (size_t j = 0; j < m_in; ++j) {
          mul(f, t, cp[k * m_in + j], ip[j * n + i]);
          add(f, acc, acc, t);
        }
        op[k * n + i] = acc;
      }
    }
  });
}

// out[i] = a[i] + mont_mul(r, b[i]) — the witness RLC fold kernel
// (reference plonk/mod.rs:1097-1134).
extern "C" void mira_rlc_mont(
    const uint64_t *modulus, const uint64_t *a, const uint64_t *b,
    const uint64_t *r, size_t n, int nthreads, uint64_t *out) {
  Field f;
  field_init(f, modulus);
  const Fp *ap = (const Fp *)a;
  const Fp *bp = (const Fp *)b;
  Fp rv;
  std::memcpy(rv.v, r, 32);
  Fp *op = (Fp *)out;
  parallel_chunks(n, nthreads, [&](size_t, size_t lo, size_t hi) {
    Fp t;
    for (size_t i = lo; i < hi; ++i) {
      mul(f, t, rv, bp[i]);
      add(f, op[i], ap[i], t);
    }
  });
}

extern "C" void mira_eval_fold(
    const uint64_t *modulus,      // 4 limbs
    const int32_t *ops,           // n_ops * 4
    size_t n_ops,
    size_t n_regs,
    const uint64_t *static_cols,  // n_sq * nrow * 4 (Montgomery)
    const uint64_t *w1_cols,      // n_aq * nrow * 4
    const uint64_t *w2_cols,      // n_aq * nrow * 4
    const uint64_t *ch,           // n_j * n_ch * 4
    size_t n_ch,
    const uint64_t *jm,           // n_j * 4
    size_t n_j,
    size_t nrow,
    const uint64_t *consts,       // n_consts * 4
    int nthreads,
    uint64_t *out                 // n_j * nrow * 4
) {
  Ctx c;
  std::memcpy(c.f.p.v, modulus, 32);
  // n0 = -p^{-1} mod 2^64 via Newton iteration
  uint64_t p0 = c.f.p.v[0];
  uint64_t inv = 1;
  for (int i = 0; i < 6; ++i) inv *= 2 - p0 * inv;
  c.f.n0 = (uint64_t)(0 - inv);
  c.ops = ops;
  c.n_ops = n_ops;
  c.n_regs = n_regs;
  c.statics = (const Fp *)static_cols;
  c.w1 = (const Fp *)w1_cols;
  c.w2 = (const Fp *)w2_cols;
  c.ch = (const Fp *)ch;
  c.jm = (const Fp *)jm;
  c.consts = (const Fp *)consts;
  c.nrow = nrow;
  c.n_ch = n_ch;
  c.out = (Fp *)out;

  int hw = nthreads > 0 ? nthreads
                        : (int)std::thread::hardware_concurrency();
  if (hw < 1) hw = 1;
  size_t total = n_j * nrow;
  size_t nchunks = (size_t)hw * 4;
  if (nchunks > total) nchunks = total ? total : 1;
  std::vector<std::thread> threads;
  std::atomic<size_t> next(0);
  // chunk over (j, row-range) work items
  size_t chunk_rows = (nrow + nchunks - 1) / nchunks;
  if (chunk_rows == 0) chunk_rows = 1;
  size_t items_per_j = (nrow + chunk_rows - 1) / chunk_rows;
  size_t n_items = n_j * items_per_j;
  for (int t = 0; t < hw; ++t) {
    threads.emplace_back([&]() {
      for (;;) {
        size_t it = next.fetch_add(1);
        if (it >= n_items) break;
        size_t jidx = it / items_per_j;
        size_t ci = it % items_per_j;
        size_t lo = ci * chunk_rows;
        size_t hi = lo + chunk_rows;
        if (hi > nrow) hi = nrow;
        if (lo < hi) eval_rows(c, jidx, lo, hi);
      }
    });
  }
  for (auto &th : threads) th.join();
}
