// Serial host build of the GPU Pippenger (msm_gpu.cuh): the same bodies and
// driver as the CUDA kernels, run one thread index at a time, with std::sort
// and a serial scan in place of CUB.  The CPU tests compare it with the host
// MSM; it is not a production engine.
//
// Build: g++ -O2 -shared -fPIC -std=c++17 msm_gpu_host.cpp -o libmiramsm_gpu_host.so

#include <algorithm>
#include <cstring>
#include <numeric>
#include <vector>

#include "msm_gpu.cuh"

namespace {

using namespace mira_msm;

struct HostExec {
  template <class Body>
  void launch(const Body& body, u64 n) {
    for (u64 t = 0; t < n; ++t) body(t);
  }
  void sort_pairs(const u32* kin, u32* kout, const u32* vin, u32* vout, u64 m,
                  int /*bits*/) {
    std::vector<u64> idx(m);
    std::iota(idx.begin(), idx.end(), 0);
    std::stable_sort(idx.begin(), idx.end(),
                     [kin](u64 a, u64 b) { return kin[a] < kin[b]; });
    for (u64 j = 0; j < m; ++j) {
      kout[j] = kin[idx[j]];
      vout[j] = vin[idx[j]];
    }
  }
  void exclusive_scan(const u32* in, u32* out, u64 n) {
    u32 acc = 0;
    for (u64 i = 0; i < n; ++i) {
      u32 v = in[i];
      out[i] = acc;
      acc += v;
    }
  }
  void zero(void* p, size_t bytes) { std::memset(p, 0, bytes); }
};

template <class F>
void emulate(const u32* sc16, const u32* x16, const u32* y16, const u32* z16,
             u64 n, u32 c, u32* out16) {
  Plan pl = make_plan(n, c, 0);
  std::vector<char> scratch(pl.total);
  HostExec ex;
  run_msm<F>(ex, pl, scratch.data(), sc16, x16, y16, z16, out16);
}

}  // namespace

extern "C" {

// curve: 0 = BN254 G1, 1 = Grumpkin.  Inputs as for the CUDA call: (n, 16)
// plain scalar limbs and (n, 16) Montgomery point limbs; out: 3 x 16 limbs.
int mira_msm_gpu_emulate(const uint32_t* sc16, const uint32_t* x16,
                         const uint32_t* y16, const uint32_t* z16, uint64_t n,
                         int curve, uint32_t c, uint32_t* out16) {
  if (c < 2 || c > 16) return 1;
  if (curve == 0)
    emulate<Bn254Fq>(sc16, x16, y16, z16, n, c, out16);
  else if (curve == 1)
    emulate<GrumpkinFq>(sc16, x16, y16, z16, n, c, out16);
  else
    return 2;
  return 0;
}

// the digit pass alone: keys/vals are (W, n); points are not packed
void mira_msm_gpu_digits(const uint32_t* sc16, const uint32_t* z16,
                         uint64_t n, uint32_t c, uint32_t* keys,
                         uint32_t* vals) {
  Plan pl = make_plan(n, c, 0);
  std::vector<uint32_t> xy(n * 16, 0);
  std::vector<aff> pts(n);
  HostExec ex;
  ex.launch(DigitsBody{sc16, xy.data(), xy.data(), z16, pts.data(), keys,
                       vals, n, c, pl.W, pl.B, pl.nb},
            n);
}

}  // extern "C"
