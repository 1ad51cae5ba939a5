// CUDA build of the bucket Pippenger MSM (msm_gpu.cuh), called from JAX
// through the XLA FFI as the custom call "mira_msm_gpu".
//
// Operands: scalars (n, 16) plain 16-bit limbs; X, Y, Z (n, 16) Montgomery
// 16-bit limbs of affine points (Z = 1 in Montgomery form, or Z = 0 for the
// identity).  Results: (3, 16) Jacobian Montgomery limbs, and a uint8 scratch
// buffer of mira_msm_gpu_scratch_bytes(n, c) bytes.  Attributes: curve
// (0 = BN254 G1, 1 = Grumpkin) and window c.  The handler only enqueues work
// on XLA's stream: it neither allocates nor synchronises.
//
// Build (ops/cuda_msm.py runs this at first use):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -I <jax.ffi.include_dir()> msm_gpu.cu -o ...

#include <cuda_runtime.h>

#include <cub/device/device_radix_sort.cuh>
#include <cub/device/device_scan.cuh>

#include "msm_gpu.cuh"
#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;
using namespace mira_msm;

namespace {

constexpr int BLOCK = 128;

template <class Body>
__global__ void __launch_bounds__(BLOCK) k_launch(Body body, u64 n) {
  u64 t = (u64)blockIdx.x * BLOCK + threadIdx.x;
  if (t < n) body(t);
}

struct CudaExec {
  cudaStream_t stream;
  void* temp;
  size_t temp_bytes;
  cudaError_t err = cudaSuccess;

  void note(cudaError_t e) {
    if (err == cudaSuccess && e != cudaSuccess) err = e;
  }
  template <class Body>
  void launch(const Body& body, u64 n) {
    if (n == 0) return;
    k_launch<Body><<<(unsigned)((n + BLOCK - 1) / BLOCK), BLOCK, 0, stream>>>(body, n);
    note(cudaGetLastError());
  }
  void sort_pairs(const u32* kin, u32* kout, const u32* vin, u32* vout, u64 m,
                  int bits) {
    size_t bytes = temp_bytes;
    note(cub::DeviceRadixSort::SortPairs(temp, bytes, kin, kout, vin, vout,
                                         (int)m, 0, bits, stream));
  }
  void exclusive_scan(const u32* in, u32* out, u64 n) {
    size_t bytes = temp_bytes;
    note(cub::DeviceScan::ExclusiveSum(temp, bytes, in, out, (int)n, stream));
  }
  void zero(void* p, size_t bytes) { note(cudaMemsetAsync(p, 0, bytes, stream)); }
};

// CUB's temporary storage for the largest sort and scan of a plan
size_t cub_temp_bytes(u64 n, u32 c) {
  Plan pl = make_plan(n, c, 0);
  size_t sort_bytes = 0, scan_bytes = 0;
  cub::DeviceRadixSort::SortPairs(nullptr, sort_bytes, (const u32*)nullptr,
                                  (u32*)nullptr, (const u32*)nullptr,
                                  (u32*)nullptr, (int)pl.M, 0,
                                  (int)pl.key_bits);
  cub::DeviceScan::ExclusiveSum(nullptr, scan_bytes, (const u32*)nullptr,
                                (u32*)nullptr, (int)pl.nb + 1);
  return sort_bytes > scan_bytes ? sort_bytes : scan_bytes;
}

template <class F>
ffi::Error run(cudaStream_t stream, const u32* sc, const u32* x, const u32* y,
               const u32* z, u64 n, u32 c, u32* out, char* scratch,
               size_t scratch_bytes) {
  Plan pl = make_plan(n, c, cub_temp_bytes(n, c));
  if (scratch_bytes < pl.total)
    return ffi::Error::InvalidArgument("mira_msm_gpu: scratch too small");
  CudaExec ex{stream, scratch + pl.o_temp, pl.temp_bytes};
  run_msm<F>(ex, pl, scratch, sc, x, y, z, out);
  if (ex.err != cudaSuccess)
    return ffi::Error::Internal(std::string("mira_msm_gpu: ") +
                                cudaGetErrorString(ex.err));
  return ffi::Error::Success();
}

ffi::Error MsmImpl(cudaStream_t stream, ffi::Buffer<ffi::U32> sc,
                   ffi::Buffer<ffi::U32> x, ffi::Buffer<ffi::U32> y,
                   ffi::Buffer<ffi::U32> z, ffi::ResultBuffer<ffi::U32> out,
                   ffi::ResultBuffer<ffi::U8> scratch, int32_t curve,
                   int32_t window) {
  u64 n = sc.element_count() / 16;
  if (n == 0 || x.element_count() != n * 16 || y.element_count() != n * 16 ||
      z.element_count() != n * 16 || out->element_count() != 48)
    return ffi::Error::InvalidArgument("mira_msm_gpu: bad operand shapes");
  if (window < 2 || window > 16)
    return ffi::Error::InvalidArgument("mira_msm_gpu: window out of range");
  char* s = reinterpret_cast<char*>(scratch->typed_data());
  size_t sb = scratch->element_count();
  if (curve == 0)
    return run<Bn254Fq>(stream, sc.typed_data(), x.typed_data(),
                        y.typed_data(), z.typed_data(), n, (u32)window,
                        out->typed_data(), s, sb);
  if (curve == 1)
    return run<GrumpkinFq>(stream, sc.typed_data(), x.typed_data(),
                           y.typed_data(), z.typed_data(), n, (u32)window,
                           out->typed_data(), s, sb);
  return ffi::Error::InvalidArgument("mira_msm_gpu: unknown curve");
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(MiraMsmGpu, MsmImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::U32>>()
                                  .Arg<ffi::Buffer<ffi::U32>>()
                                  .Arg<ffi::Buffer<ffi::U32>>()
                                  .Arg<ffi::Buffer<ffi::U32>>()
                                  .Ret<ffi::Buffer<ffi::U32>>()
                                  .Ret<ffi::Buffer<ffi::U8>>()
                                  .Attr<int32_t>("curve")
                                  .Attr<int32_t>("window"));

extern "C" uint64_t mira_msm_gpu_scratch_bytes(uint64_t n, uint32_t c) {
  return make_plan(n, c, cub_temp_bytes(n, c)).total;
}
