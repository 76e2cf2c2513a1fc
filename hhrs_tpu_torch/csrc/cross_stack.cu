// Fused L-layer feature-cross stack, forward and backward: one launch for the
// forward of all L layers, two for the backward (per-block sums, then one
// ordered sum over the blocks).
//
// Replaces the TPU kernel hhrs_tpu/ops/pallas/cross_kernel.py::
// cross_stack_pallas (pallas_call at :56) and its custom_vjp backward (_bwd
// at :82). It computes, for each row of x0 [B, d] with w, b [L, d]:
//
//   x = x0;  L times:  g_l = w_l . x_l  (one scalar per row)
//            code:      x_{l+1} = (x_l + x_l * g_l) + b_l
//            canonical: x_{l+1} = (x0 * g_l + b_l) + x_l
//
// and, given dy = dL/dx_L, the gradients dx0 [B, d], dw [L, d], db [L, d].
// Like the JAX backward, the kernel recomputes the layer inputs x_l from x0
// instead of saving them. Walking l = L-1 ... 0 with dy the running gradient:
//
//   code:      s = dy . x_l;  dw_l += s x_l;  db_l += dy;  dy = dy (1 + g_l) + s w_l
//   canonical: s = dy . x0;   dw_l += s x_l;  db_l += dy;  dx0 += dy g_l;
//              dy = dy + s w_l;                   at the end dx0 += dy
//
// What bounds it on an H100: bytes, and in practice launch latency. At the
// training shapes (B = 512, d = 113, L = 3) a forward moves 0.46 MB and does
// 0.9 MFLOP: 0.14 us at 3.35 TB/s, far below the ~5 us a launch costs. The
// plain PyTorch version issues ~5 launches a layer (~15 for the forward) and
// autograd about twice that for the backward; this design issues 1 and 2.
//
// Design (simple and correct first):
//  * one warp per row; lane k owns columns k, k + 32, ... (NPL = ceil(d/32)
//    of them, a template parameter), so the row, x0 and, in the backward,
//    every x_l stay in registers across the layers; a gate is a warp-shuffle
//    reduction;
//  * the elementwise steps use __fmul_rn / __fadd_rn, never a contracted
//    FMA, so they round exactly as the plain version's separate operations;
//    only the order of the d-term gate sums differs;
//  * dw and db are sums over the batch, made without float atomics so two
//    runs give bit-identical gradients: each warp sums its rows in order in
//    registers, each block sums its warps in order into a scratch
//    [n_blocks, 2, L, d] (allocated by the caller), and a second kernel sums
//    the blocks in order. The number of blocks depends on B alone;
//  * a row's instruction sequence does not depend on where it sits in the
//    batch, so y and dx0 of a row are the same at any position.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kWarps = 8;             // warps per block
constexpr int kThreads = kWarps * 32;
constexpr int kMaxLayers = 6;         // the JAX search space's largest stack
constexpr int kMaxPerLane = 8;        // d <= 256
constexpr int kTargetBlocks = 256;    // backward: blocks of partial sums, about
constexpr int kReduceRows = 8;        // reduce kernel: threads along the blocks

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// sum_c a[c] * v[c] over the row, a held by the lanes, v in global memory.
template <int NPL>
__device__ __forceinline__ float row_dot(const float (&a)[NPL],
                                         const float* __restrict__ v, int lane,
                                         int d) {
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < NPL; ++j) {
    const int c = lane + 32 * j;
    if (c < d) s = fmaf(a[j], __ldg(v + c), s);
  }
  return warp_sum(s);
}

template <int NPL>
__device__ __forceinline__ float row_dot(const float (&a)[NPL],
                                         const float (&v)[NPL]) {
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < NPL; ++j) s = fmaf(a[j], v[j], s);
  return warp_sum(s);
}

// One cross layer on a row held in registers. Columns past d stay zero.
template <int NPL>
__device__ __forceinline__ void layer_step(float (&x)[NPL],
                                           const float (&x0)[NPL], float g,
                                           const float* __restrict__ b,
                                           int lane, int d, int canonical) {
#pragma unroll
  for (int j = 0; j < NPL; ++j) {
    const int c = lane + 32 * j;
    if (c < d) {
      const float bc = __ldg(b + c);
      x[j] = canonical ? __fadd_rn(__fadd_rn(__fmul_rn(x0[j], g), bc), x[j])
                       : __fadd_rn(__fadd_rn(x[j], __fmul_rn(x[j], g)), bc);
    }
  }
}

template <int NPL>
__device__ __forceinline__ void load_row(float (&r)[NPL],
                                         const float* __restrict__ src,
                                         int lane, int d) {
#pragma unroll
  for (int j = 0; j < NPL; ++j) {
    const int c = lane + 32 * j;
    r[j] = c < d ? src[c] : 0.f;
  }
}

template <int NPL>
__device__ __forceinline__ void store_row(float* __restrict__ dst,
                                          const float (&r)[NPL], int lane,
                                          int d) {
#pragma unroll
  for (int j = 0; j < NPL; ++j) {
    const int c = lane + 32 * j;
    if (c < d) dst[c] = r[j];
  }
}

template <int NPL>
__global__ void __launch_bounds__(kThreads)
    cross_fwd_kernel(const float* __restrict__ x0, const float* __restrict__ w,
                     const float* __restrict__ b, float* __restrict__ y, int B,
                     int d, int L, int canonical) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= B) return;  // uniform across the warp; no block barrier follows
  float xin[NPL], x[NPL];
  load_row<NPL>(xin, x0 + (size_t)row * d, lane, d);
#pragma unroll
  for (int j = 0; j < NPL; ++j) x[j] = xin[j];
  for (int l = 0; l < L; ++l) {
    const float g = row_dot<NPL>(x, w + (size_t)l * d, lane, d);
    layer_step<NPL>(x, xin, g, b + (size_t)l * d, lane, d, canonical);
  }
  store_row<NPL>(y + (size_t)row * d, x, lane, d);
}

// Rows of block k: k * kWarps * rpw + r * kWarps + warp for r < rpw.
// Writes dx0 for those rows and the block's sums of dw, db to
// partial[k][0 | 1][L][d].
template <int NPL>
__global__ void __launch_bounds__(kThreads)
    cross_bwd_kernel(const float* __restrict__ x0, const float* __restrict__ w,
                     const float* __restrict__ b, const float* __restrict__ dy,
                     float* __restrict__ dx0, float* __restrict__ partial,
                     int B, int d, int L, int canonical, int rpw) {
  extern __shared__ float smem[];  // [kWarps][2][L][d]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float dw_acc[kMaxLayers][NPL], db_acc[kMaxLayers][NPL];
#pragma unroll
  for (int l = 0; l < kMaxLayers; ++l) {
#pragma unroll
    for (int j = 0; j < NPL; ++j) dw_acc[l][j] = db_acc[l][j] = 0.f;
  }

  for (int r = 0; r < rpw; ++r) {
    const int row = (blockIdx.x * rpw + r) * kWarps + warp;
    if (row >= B) break;  // uniform across the warp
    float xin[NPL], x[NPL], dx[NPL], dx0_acc[NPL];
    float xs[kMaxLayers][NPL], g[kMaxLayers];
    load_row<NPL>(xin, x0 + (size_t)row * d, lane, d);
    load_row<NPL>(dx, dy + (size_t)row * d, lane, d);
#pragma unroll
    for (int j = 0; j < NPL; ++j) {
      x[j] = xin[j];
      dx0_acc[j] = 0.f;
    }
    // Recompute the layer inputs x_l and gates g_l, as the forward does.
#pragma unroll
    for (int l = 0; l < kMaxLayers; ++l) {
      if (l < L) {
#pragma unroll
        for (int j = 0; j < NPL; ++j) xs[l][j] = x[j];
        g[l] = row_dot<NPL>(x, w + (size_t)l * d, lane, d);
        layer_step<NPL>(x, xin, g[l], b + (size_t)l * d, lane, d, canonical);
      }
    }
    // Walk back through the layers.
#pragma unroll
    for (int l = kMaxLayers - 1; l >= 0; --l) {
      if (l < L) {
        const float* wl = w + (size_t)l * d;
        const float s = canonical ? row_dot<NPL>(dx, xin) : row_dot<NPL>(dx, xs[l]);
#pragma unroll
        for (int j = 0; j < NPL; ++j) {
          const int c = lane + 32 * j;
          const float wc = c < d ? __ldg(wl + c) : 0.f;
          db_acc[l][j] += dx[j];
          dw_acc[l][j] = fmaf(s, xs[l][j], dw_acc[l][j]);
          if (canonical) {
            dx0_acc[j] = fmaf(dx[j], g[l], dx0_acc[j]);
            dx[j] = fmaf(s, wc, dx[j]);
          } else {
            dx[j] = fmaf(s, wc, dx[j] * (1.f + g[l]));
          }
        }
      }
    }
    if (canonical) {
#pragma unroll
      for (int j = 0; j < NPL; ++j) dx[j] += dx0_acc[j];
    }
    store_row<NPL>(dx0 + (size_t)row * d, dx, lane, d);
  }

  // The block's sums: each warp writes its own slot, then the warps are
  // added in order 0 .. kWarps-1.
  const int n = L * d;
  float* mine = smem + (size_t)warp * 2 * n;
#pragma unroll
  for (int l = 0; l < kMaxLayers; ++l) {
    if (l < L) {
      store_row<NPL>(mine + (size_t)l * d, dw_acc[l], lane, d);
      store_row<NPL>(mine + n + (size_t)l * d, db_acc[l], lane, d);
    }
  }
  __syncthreads();
  float* out = partial + (size_t)blockIdx.x * 2 * n;
  for (int i = threadIdx.x; i < 2 * n; i += blockDim.x) {
    float s = 0.f;
    for (int k = 0; k < kWarps; ++k) s += smem[(size_t)k * 2 * n + i];
    out[i] = s;
  }
}

// dw | db [2n] = sum over the blocks of partial[k][2n], in a fixed order:
// thread (tx, ty) adds blocks ty, ty + kReduceRows, ... of column i, then the
// kReduceRows sums of a column are added in order ty = 0, 1, ...
__global__ void __launch_bounds__(32 * kReduceRows)
    cross_bwd_reduce_kernel(const float* __restrict__ partial,
                            float* __restrict__ dw, float* __restrict__ db,
                            int n_blocks, int n) {
  __shared__ float sums[kReduceRows][32];
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int i = blockIdx.x * 32 + tx;
  float s = 0.f;
  if (i < 2 * n) {
#pragma unroll 4
    for (int k = ty; k < n_blocks; k += kReduceRows) s += partial[(size_t)k * 2 * n + i];
  }
  sums[ty][tx] = s;
  __syncthreads();
  if (ty == 0 && i < 2 * n) {
    float t = 0.f;
#pragma unroll
    for (int k = 0; k < kReduceRows; ++k) t += sums[k][tx];
    if (i < n) {
      dw[i] = t;
    } else {
      db[i - n] = t;
    }
  }
}

int rows_per_warp(int B) {
  const int per_block = (B + kTargetBlocks - 1) / kTargetBlocks;
  const int rpw = (per_block + kWarps - 1) / kWarps;
  return rpw < 1 ? 1 : rpw;
}

template <int NPL>
cudaError_t launch_fwd(const float* x0, const float* w, const float* b,
                       float* y, int B, int d, int L, int canonical,
                       cudaStream_t stream) {
  const int grid = (B + kWarps - 1) / kWarps;
  cross_fwd_kernel<NPL><<<grid, kThreads, 0, stream>>>(x0, w, b, y, B, d, L,
                                                       canonical);
  return cudaGetLastError();
}

template <int NPL>
cudaError_t launch_bwd(const float* x0, const float* w, const float* b,
                       const float* dy, float* dx0, float* dw, float* db,
                       float* partial, int B, int d, int L, int canonical,
                       cudaStream_t stream) {
  const int rpw = rows_per_warp(B);
  const int n_blocks = (B + kWarps * rpw - 1) / (kWarps * rpw);
  const size_t smem = (size_t)kWarps * 2 * L * d * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        cross_bwd_kernel<NPL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  cross_bwd_kernel<NPL><<<n_blocks, kThreads, smem, stream>>>(
      x0, w, b, dy, dx0, partial, B, d, L, canonical, rpw);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n = L * d;
  cross_bwd_reduce_kernel<<<(2 * n + 31) / 32, 32 * kReduceRows, 0, stream>>>(
      partial, dw, db, n_blocks, n);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int hhrs_cross_max_dim() { return 32 * kMaxPerLane; }
int hhrs_cross_max_layers() { return kMaxLayers; }

// Blocks of partial sums the backward uses for a batch of B rows: the
// scratch it takes is [blocks, 2, L, d] float32.
int hhrs_cross_bwd_blocks(int B) {
  const int rpw = rows_per_warp(B);
  return (B + kWarps * rpw - 1) / (kWarps * rpw);
}

const char* hhrs_cross_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

#define HHRS_CROSS_DISPATCH(NPL_MAX_CALL)                                  \
  switch ((d + 31) / 32) {                                                 \
    case 1: return static_cast<int>(NPL_MAX_CALL(1));                      \
    case 2: return static_cast<int>(NPL_MAX_CALL(2));                      \
    case 3: return static_cast<int>(NPL_MAX_CALL(3));                      \
    case 4: return static_cast<int>(NPL_MAX_CALL(4));                      \
    case 5: return static_cast<int>(NPL_MAX_CALL(5));                      \
    case 6: return static_cast<int>(NPL_MAX_CALL(6));                      \
    case 7: return static_cast<int>(NPL_MAX_CALL(7));                      \
    case 8: return static_cast<int>(NPL_MAX_CALL(8));                      \
    default: return static_cast<int>(cudaErrorInvalidValue);               \
  }

// Launches on `stream` and returns cudaGetLastError() (0 on success). All
// pointers are device pointers to contiguous float32 arrays: x0, y [B, d],
// w, b [L, d]. Needs 1 <= d <= 256 and 0 <= L <= 6.
int hhrs_cross_fwd(const void* x0, const void* w, const void* b, void* y,
                   int B, int d, int L, int canonical, void* stream) {
  if (B <= 0) return 0;
  if (L < 0 || L > kMaxLayers) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
#define HHRS_FWD(NPL)                                                        \
  launch_fwd<NPL>(static_cast<const float*>(x0), static_cast<const float*>(w), \
                  static_cast<const float*>(b), static_cast<float*>(y), B, d, \
                  L, canonical, s)
  HHRS_CROSS_DISPATCH(HHRS_FWD)
#undef HHRS_FWD
}

// dy, dx0 [B, d]; dw, db [L, d]; partial [hhrs_cross_bwd_blocks(B), 2, L, d].
// Two launches; returns the first error.
int hhrs_cross_bwd(const void* x0, const void* w, const void* b,
                   const void* dy, void* dx0, void* dw, void* db,
                   void* partial, int B, int d, int L, int canonical,
                   void* stream) {
  if (B <= 0 || L <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (L > kMaxLayers) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
#define HHRS_BWD(NPL)                                                          \
  launch_bwd<NPL>(static_cast<const float*>(x0), static_cast<const float*>(w), \
                  static_cast<const float*>(b), static_cast<const float*>(dy), \
                  static_cast<float*>(dx0), static_cast<float*>(dw),           \
                  static_cast<float*>(db), static_cast<float*>(partial), B, d, \
                  L, canonical, s)
  HHRS_CROSS_DISPATCH(HHRS_BWD)
#undef HHRS_BWD
}

}  // extern "C"
