// Fused eval-mode DCN-R tower: one launch turns a [B, d] feature batch into
// [B] logits.
//
// Replaces the TPU kernel hhrs_tpu/ops/pallas/tower_kernel.py::
// dcnr_tower_eval_pallas. It computes the same function, with eval-mode
// BatchNorm folded into the residual blocks' linear weights on the host
// (hhrs_tpu_torch/ops/tower.py::fold_eval_params):
//
//   deep = x0 @ W0 + b0
//   R times:  h = relu(deep @ W1'[r] + b1'[r]);  deep = relu(h @ W2'[r] + b2'[r] + deep)
//   x = x0;  L times:  g = x . w_l  (one scalar per row)
//            code:      x = (x + x * g) + b_l
//            canonical: x = (x0 * g + b_l) + x
//   logit = (deep . fw[:H] + x . fw[H:]) + fb
//
// What bounds it on an H100: operations. A row costs about
// 2 (d H + 2 R H^2 + 3 L d + H + d) flops (1.3 MFLOP at d=113, H=320, R=3,
// L=3) against ~2.6 MB of weights that every tile reads again from L2, so
// above a few dozen rows the f32 CUDA-core rate is the limit. Full f32 FMA
// throughout, no TF32: the parity bar with the JAX reference is 2e-5.
//
// Design (simple and correct first):
//  * one thread block per tile of kTileRows rows; the tile's x0, deep, h and
//    cross activations live in shared memory (dynamic, above 48 KB opt-in);
//  * the folded weights are read from global memory, where they stay in L2;
//  * a matrix product gives each thread one output column (strided by the
//    block size) and kTileRows accumulators in registers; the activation row
//    is read as float4 from shared memory (a broadcast: every thread reads
//    the same address), the weight row coalesced across the threads;
//  * cross gates and the head are per-row reductions, one warp per row;
//  * every row runs the same instruction sequence over k in ascending order
//    and the same butterfly reduction, so a row's logit does not depend on
//    its position in the tile or on B: equal rows give equal logits.
//
// Left to later work: wgmma/TMA tiles, pulling the build_x0 embedding
// gathers into the prologue, and filling all 132 SMs at B = 128.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kTileRows = 16;
constexpr int kMaxThreads = 512;

__host__ __device__ inline int round4(int x) { return (x + 3) & ~3; }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// out[r][j] = act(sum_k a[r][k] * W[k][j] + bias[j]  (+ out[r][j] if RESID))
// for the tile's rows. a: shared [kTileRows][lda], lda % 4 == 0.
// W: global [K][N] row-major (the JAX kernel layout [in, out]).
template <bool RELU, bool RESID>
__device__ __forceinline__ void tile_matmul(const float* a, int lda, int K,
                                            const float* __restrict__ W,
                                            const float* __restrict__ bias,
                                            int N, float* out, int ldo) {
  const int K4 = K & ~3;
  for (int j = threadIdx.x; j < N; j += blockDim.x) {
    float acc[kTileRows];
#pragma unroll
    for (int r = 0; r < kTileRows; ++r) acc[r] = 0.f;
    for (int k = 0; k < K4; k += 4) {
      const float w0 = __ldg(W + (size_t)k * N + j);
      const float w1 = __ldg(W + (size_t)(k + 1) * N + j);
      const float w2 = __ldg(W + (size_t)(k + 2) * N + j);
      const float w3 = __ldg(W + (size_t)(k + 3) * N + j);
#pragma unroll
      for (int r = 0; r < kTileRows; ++r) {
        const float4 v = *reinterpret_cast<const float4*>(a + r * lda + k);
        acc[r] = fmaf(v.x, w0, acc[r]);
        acc[r] = fmaf(v.y, w1, acc[r]);
        acc[r] = fmaf(v.z, w2, acc[r]);
        acc[r] = fmaf(v.w, w3, acc[r]);
      }
    }
    for (int k = K4; k < K; ++k) {
      const float w = __ldg(W + (size_t)k * N + j);
#pragma unroll
      for (int r = 0; r < kTileRows; ++r) acc[r] = fmaf(a[r * lda + k], w, acc[r]);
    }
    const float b = __ldg(bias + j);
#pragma unroll
    for (int r = 0; r < kTileRows; ++r) {
      float y = acc[r] + b;
      if (RESID) y += out[r * ldo + j];
      if (RELU) y = y < 0.f ? 0.f : y;  // keeps NaN, like torch.relu
      out[r * ldo + j] = y;
    }
  }
}

__global__ void __launch_bounds__(kMaxThreads) tower_eval_kernel(
    const float* __restrict__ x0, const float* __restrict__ w0,
    const float* __restrict__ b0, const float* __restrict__ w1,
    const float* __restrict__ b1, const float* __restrict__ w2,
    const float* __restrict__ b2, const float* __restrict__ cw,
    const float* __restrict__ cb, const float* __restrict__ fw,
    const float* __restrict__ fb, float* __restrict__ out, int B, int d, int H,
    int R, int L, int canonical) {
  extern __shared__ float4 smem4[];
  const int d4 = round4(d), h4 = round4(H);
  float* xs0 = reinterpret_cast<float*>(smem4);  // [kTileRows][d4] x0
  float* xc = xs0 + kTileRows * d4;              // [kTileRows][d4] cross x
  float* deep = xc + kTileRows * d4;             // [kTileRows][h4]
  float* hs = deep + kTileRows * h4;             // [kTileRows][h4]
  const int row0 = blockIdx.x * kTileRows;

  // x0 tile; rows past B and columns past d are zero.
  for (int i = threadIdx.x; i < kTileRows * d4; i += blockDim.x) {
    const int r = i / d4, k = i - r * d4;
    const int row = row0 + r;
    const float v = (row < B && k < d) ? x0[(size_t)row * d + k] : 0.f;
    xs0[i] = v;
    xc[i] = v;
  }
  __syncthreads();

  // Deep tower.
  tile_matmul<false, false>(xs0, d4, d, w0, b0, H, deep, h4);
  __syncthreads();
  for (int r = 0; r < R; ++r) {
    const size_t wo = (size_t)r * H * H, bo = (size_t)r * H;
    tile_matmul<true, false>(deep, h4, H, w1 + wo, b1 + bo, H, hs, h4);
    __syncthreads();
    tile_matmul<true, true>(hs, h4, H, w2 + wo, b2 + bo, H, deep, h4);
    __syncthreads();
  }

  // Cross stack and head: one warp per row. A lane only ever touches its
  // own columns k = lane (mod 32) of the row, so no block barrier is needed.
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int r = warp; r < kTileRows; r += nwarps) {
    float* x = xc + r * d4;
    const float* xr0 = xs0 + r * d4;
    for (int l = 0; l < L; ++l) {
      const float* w = cw + (size_t)l * d;
      const float* b = cb + (size_t)l * d;
      float g = 0.f;
      for (int k = lane; k < d; k += 32) g = fmaf(x[k], __ldg(w + k), g);
      g = warp_sum(g);
      for (int k = lane; k < d; k += 32) {
        const float xk = x[k];
        x[k] = canonical ? (xr0[k] * g + __ldg(b + k)) + xk
                         : (xk + xk * g) + __ldg(b + k);
      }
    }
    float s = 0.f, t = 0.f;
    for (int k = lane; k < H; k += 32) s = fmaf(deep[r * h4 + k], __ldg(fw + k), s);
    for (int k = lane; k < d; k += 32) t = fmaf(x[k], __ldg(fw + H + k), t);
    s = warp_sum(s);
    t = warp_sum(t);
    if (lane == 0 && row0 + r < B) out[row0 + r] = (s + t) + __ldg(fb);
  }
}

}  // namespace

extern "C" {

int hhrs_tower_eval_max_threads() { return kMaxThreads; }

long long hhrs_tower_eval_smem_bytes(int d, int H) {
  return (long long)kTileRows * (2 * round4(d) + 2 * round4(H)) * sizeof(float);
}

const char* hhrs_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Launches on `stream` and returns cudaGetLastError() (0 on success). All
// pointers are device pointers to contiguous float32 arrays:
// x0 [B, d], w0 [d, H], b0 [H], w1/w2 [R, H, H], b1/b2 [R, H],
// cw/cb [L, d], fw [H + d], fb [1], out [B].
int hhrs_tower_eval(const void* x0, const void* w0, const void* b0,
                    const void* w1, const void* b1, const void* w2,
                    const void* b2, const void* cw, const void* cb,
                    const void* fw, const void* fb, void* out, int B, int d,
                    int H, int R, int L, int canonical, int threads,
                    void* stream) {
  if (B <= 0) return 0;
  if (threads <= 0 || threads > kMaxThreads || threads % 32 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(hhrs_tower_eval_smem_bytes(d, H));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        tower_eval_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int grid = (B + kTileRows - 1) / kTileRows;
  tower_eval_kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x0), static_cast<const float*>(w0),
      static_cast<const float*>(b0), static_cast<const float*>(w1),
      static_cast<const float*>(b1), static_cast<const float*>(w2),
      static_cast<const float*>(b2), static_cast<const float*>(cw),
      static_cast<const float*>(cb), static_cast<const float*>(fw),
      static_cast<const float*>(fb), static_cast<float*>(out), B, d, H, R, L,
      canonical);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
