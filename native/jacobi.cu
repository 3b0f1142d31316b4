// Exact temporal-blocked Jacobi sweeps for the stable-fluids step (sm_90a).
//
// One launch loads a (TH + 2K) x (TW + 2K) tile of a field into shared memory
// and runs up to K Jacobi sweeps on it before writing the TH x TW core back:
// K sweeps per trip to device memory instead of one.  Sweep s updates only
// the cells at least s cells inside the tile edge (the trapezoid), so the
// stale tile edge never reaches the core and the core is global Jacobi up to
// FMA contraction.  The clamped-edge Neumann neighbours of ops/stencil.py are
// re-applied at the true domain edges on every sweep.
//
// The reference CUDA solver iterates 16x16 shared-memory tiles 20-30 times
// without refreshing their halos (GPUFluidSim.cu:316-429, 445-495), which is
// approximate; the trapezoid makes the same idea exact.
//
// Two XLA FFI targets (bound in cudafluidsimulation_tpu/ops/jacobi_cuda.py):
//   FluidsJacobiDiffuse(x, alpha, inv_beta) -> (out, scratch)
//       x' = (l + r + b + t + alpha[c] * x) * inv_beta[c]
//   FluidsJacobiPressure(p0, rhs) -> (out, scratch)
//       p' = (l + r + b + t - rhs) * 0.25, from p0 (or zero, attr zero_init)
// Every leading dimension of x is a channel (a vmapped batch folds in).
// Attributes: iters (total sweeps), th, tw, k (the tile, one of kTiles).
//
// Build: make -C native libjacobi.so

#include <cuda_runtime.h>

#include <cstdint>
#include <string>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr int kThreadsX = 32;
constexpr int kThreadsY = 8;

template <int TH, int TW, int K, bool kPressure>
__global__ void __launch_bounds__(kThreadsX * kThreadsY)
    JacobiBurst(const float* __restrict__ src, const float* __restrict__ rhs,
                const float* __restrict__ alpha,
                const float* __restrict__ inv_beta, float* __restrict__ dst,
                int h, int w, int sweeps, bool zero_src) {
  constexpr int SH = TH + 2 * K;
  constexpr int SW = TW + 2 * K;
  extern __shared__ float smem[];
  float* a = smem;
  float* b = smem + SH * SW;
  float* r = smem + 2 * SH * SW;  // rhs tile (pressure only)

  const size_t plane = static_cast<size_t>(h) * w;
  const size_t c = blockIdx.z;
  src += c * plane;
  dst += c * plane;
  if (kPressure) rhs += c * plane;
  const int oy = static_cast<int>(blockIdx.y) * TH - K;
  const int ox = static_cast<int>(blockIdx.x) * TW - K;
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;

  // Load the tile; cells outside the domain take the clamped edge value and
  // are never read by a cell inside it.
  for (int i = ty; i < SH; i += kThreadsY) {
    const size_t row = static_cast<size_t>(min(max(oy + i, 0), h - 1)) * w;
    for (int j = tx; j < SW; j += kThreadsX) {
      const size_t g = row + min(max(ox + j, 0), w - 1);
      a[i * SW + j] = zero_src ? 0.0f : src[g];
      if (kPressure) r[i * SW + j] = rhs[g];
    }
  }
  const float al = kPressure ? 0.0f : alpha[c];
  const float ib = kPressure ? 0.25f : inv_beta[c];
  __syncthreads();

  for (int s = 1; s <= sweeps; ++s) {
    for (int i = s + ty; i < SH - s; i += kThreadsY) {
      const int gy = oy + i;
      const int ib_ = (gy > 0 ? i - 1 : i) * SW;
      const int it_ = (gy < h - 1 ? i + 1 : i) * SW;
      for (int j = s + tx; j < SW - s; j += kThreadsX) {
        const int gx = ox + j;
        const int jl = gx > 0 ? j - 1 : j;
        const int jr = gx < w - 1 ? j + 1 : j;
        const float sum =
            a[i * SW + jl] + a[i * SW + jr] + a[ib_ + j] + a[it_ + j];
        b[i * SW + j] = kPressure ? (sum - r[i * SW + j]) * 0.25f
                                  : (sum + a[i * SW + j] * al) * ib;
      }
    }
    __syncthreads();
    float* t = a;
    a = b;
    b = t;
  }

  for (int i = K + ty; i < K + TH; i += kThreadsY) {
    const int gy = oy + i;
    if (gy >= h) break;
    for (int j = K + tx; j < K + TW; j += kThreadsX) {
      const int gx = ox + j;
      if (gx < w) dst[static_cast<size_t>(gy) * w + gx] = a[i * SW + j];
    }
  }
}

// Runs ceil(iters / K) launches, ping-ponging between out and scratch so the
// last one writes out.
template <int TH, int TW, int K, bool kPressure>
cudaError_t RunTile(cudaStream_t stream, const float* x, const float* rhs,
                    const float* alpha, const float* inv_beta, float* out,
                    float* scratch, int64_t n, int h, int w, int iters,
                    bool zero_init) {
  constexpr int SH = TH + 2 * K;
  constexpr int SW = TW + 2 * K;
  const size_t smem = (kPressure ? 3 : 2) * sizeof(float) * SH * SW;
  auto kernel = JacobiBurst<TH, TW, K, kPressure>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((w + TW - 1) / TW, (h + TH - 1) / TH,
                  static_cast<unsigned>(n));
  const dim3 block(kThreadsX, kThreadsY);
  const int launches = (iters + K - 1) / K;
  const float* in = x;
  for (int l = 0; l < launches; ++l) {
    float* dst = ((launches - 1 - l) % 2 == 0) ? out : scratch;
    const int sweeps = min(K, iters - l * K);
    kernel<<<grid, block, smem, stream>>>(in, rhs, alpha, inv_beta, dst, h, w,
                                          sweeps, zero_init && l == 0);
    in = dst;
  }
  return cudaGetLastError();
}

// The compiled tiles: (TH, TW, K).  ops/jacobi_cuda.py's TILE table picks
// one per mode; adding a row here makes it selectable there.
#define FLUIDS_JACOBI_TILES(X) \
  X(32, 64, 4)                 \
  X(32, 64, 8)                 \
  X(32, 128, 8)                \
  X(64, 64, 8)                 \
  X(64, 128, 8)                \
  X(64, 128, 16)

template <bool kPressure>
ffi::Error Run(cudaStream_t stream, const float* x, const float* rhs,
               const float* alpha, const float* inv_beta, float* out,
               float* scratch, ffi::Span<const int64_t> dims, int32_t iters,
               int32_t th, int32_t tw, int32_t k, bool zero_init) {
  if (dims.size() < 2) return ffi::Error::InvalidArgument("rank < 2");
  int64_t n = 1;
  for (size_t d = 0; d + 2 < dims.size(); ++d) n *= dims[d];
  const int h = static_cast<int>(dims[dims.size() - 2]);
  const int w = static_cast<int>(dims[dims.size() - 1]);
  if (iters < 1) return ffi::Error::InvalidArgument("iters must be >= 1");
  if (n < 1 || n > 65535) {
    return ffi::Error::InvalidArgument("channel count out of range");
  }
  cudaError_t err = cudaErrorInvalidConfiguration;
  bool found = false;
#define FLUIDS_JACOBI_CASE(TH, TW, K)                                        \
  if (!found && th == TH && tw == TW && k == K) {                            \
    found = true;                                                            \
    err = RunTile<TH, TW, K, kPressure>(stream, x, rhs, alpha, inv_beta, out, \
                                        scratch, n, h, w, iters, zero_init); \
  }
  FLUIDS_JACOBI_TILES(FLUIDS_JACOBI_CASE)
#undef FLUIDS_JACOBI_CASE
  if (!found) {
    return ffi::Error::InvalidArgument(
        "tile " + std::to_string(th) + "x" + std::to_string(tw) + " k=" +
        std::to_string(k) + " is not compiled into libjacobi");
  }
  if (err != cudaSuccess) {
    return ffi::Error::Internal(std::string("jacobi launch: ") +
                                cudaGetErrorString(err));
  }
  return ffi::Error::Success();
}

ffi::Error DiffuseImpl(cudaStream_t stream, ffi::Buffer<ffi::F32> x,
                       ffi::Buffer<ffi::F32> alpha,
                       ffi::Buffer<ffi::F32> inv_beta,
                       ffi::ResultBuffer<ffi::F32> out,
                       ffi::ResultBuffer<ffi::F32> scratch, int32_t iters,
                       int32_t th, int32_t tw, int32_t k) {
  const auto dims = x.dimensions();
  const size_t plane = static_cast<size_t>(dims[dims.size() - 1]) *
                       static_cast<size_t>(dims[dims.size() - 2]);
  if (alpha.element_count() * plane != x.element_count() ||
      inv_beta.element_count() != alpha.element_count()) {
    return ffi::Error::InvalidArgument("need one alpha/inv_beta per channel");
  }
  return Run<false>(stream, x.typed_data(), nullptr, alpha.typed_data(),
                    inv_beta.typed_data(), out->typed_data(),
                    scratch->typed_data(), dims, iters, th, tw, k, false);
}

ffi::Error PressureImpl(cudaStream_t stream, ffi::Buffer<ffi::F32> p0,
                        ffi::Buffer<ffi::F32> rhs,
                        ffi::ResultBuffer<ffi::F32> out,
                        ffi::ResultBuffer<ffi::F32> scratch, int32_t iters,
                        int32_t th, int32_t tw, int32_t k, bool zero_init) {
  if (p0.element_count() != rhs.element_count()) {
    return ffi::Error::InvalidArgument("p0 and rhs differ in size");
  }
  return Run<true>(stream, p0.typed_data(), rhs.typed_data(), nullptr,
                   nullptr, out->typed_data(), scratch->typed_data(),
                   rhs.dimensions(), iters, th, tw, k, zero_init);
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(FluidsJacobiDiffuse, DiffuseImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()
                                  .Ret<ffi::Buffer<ffi::F32>>()
                                  .Ret<ffi::Buffer<ffi::F32>>()
                                  .Attr<int32_t>("iters")
                                  .Attr<int32_t>("th")
                                  .Attr<int32_t>("tw")
                                  .Attr<int32_t>("k"));

XLA_FFI_DEFINE_HANDLER_SYMBOL(FluidsJacobiPressure, PressureImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()
                                  .Ret<ffi::Buffer<ffi::F32>>()
                                  .Ret<ffi::Buffer<ffi::F32>>()
                                  .Attr<int32_t>("iters")
                                  .Attr<int32_t>("th")
                                  .Attr<int32_t>("tw")
                                  .Attr<int32_t>("k")
                                  .Attr<bool>("zero_init"));
