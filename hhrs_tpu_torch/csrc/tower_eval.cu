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
// What bounds it on an H100. A row costs about 2 (d H + 2 R H^2 + 3 L d +
// H + d) flops (1.3 MFLOP at d = 113, H = 320, R = 3, L = 3) against
// ~2.6 MB of folded weights, so above a few dozen rows the f32 CUDA-core
// rate is the limit. Below that, at one request (B = 128), the bound is a
// few microseconds and the kernel is bound by latency: seven dependent
// products, each as fast as the blocks that share it.
//
// Design. Every launch spreads its batch over the whole card:
//  * a tile of ROWS (16, 32 or 64) rows, chosen with the cluster size on
//    the host from B (ops/tower.py::tower_plan: the least time, counted
//    in waves of as many clusters as the card holds at once, each as long
//    as the plan's wave took when timed at first use);
//  * at serving sizes a cluster of C blocks (2, 4 or 8) shares a tile: block
//    c owns output columns [c Nc, (c + 1) Nc) of every product (Nc a
//    multiple of 4, the last slice ragged). Each block keeps a full copy of
//    the tile's activations (x0, deep, h) in shared memory and, after each
//    product, writes its slice into every peer's copy through distributed
//    shared memory, then cluster.sync(). deep and h alternate as source and
//    destination, and the residual reads only the block's own columns, so
//    one sync per product is enough. One request (128 rows) runs on 64 SMs
//    instead of 8;
//  * at batched sizes (C = 1) the tiles alone fill the card; 64-row tiles
//    read each weight from L2 once per 64 rows;
//  * each product is register-tiled: 8 warps, 4 row groups x 2 column
//    groups; a thread owns ROWS/4 rows x CN columns (columns lane + 32 (cg
//    + 2 c)). The block's weight slices of all products stream, as one
//    sequence of 16- to 64-row k-panels, through a ring of 2 to 8 panels in
//    the shared memory the activations leave (at most 96 KB), filled with
//    cp.async (16 bytes where the slice is aligned, 4 bytes otherwise)
//    stages - 1 panels ahead of use and across the products' boundaries.
//    Activations are kept transposed, [k][row] with a padded stride, and
//    read as float4 broadcasts; x0 and the cross rows live in h's buffer
//    until the first product is done;
//  * the cross stack and its half of the head run first, from the x0 tile
//    and vectors staged in the (not yet used) weight ring: one warp per
//    row, lane-strided fmaf, a butterfly warp_sum. The head's other half
//    and (s + t) + fb come last. In a cluster, block c takes the rows
//    r = c (mod C).
//
// The arithmetic is held to the port's first tower kernel, bit for bit:
// every output of every product is acc = 0, then fmaf(a[r][k], W[k][j],
// acc) for k = 0 .. K-1 in order, then acc + b (+ the residual), then a
// ReLU that keeps NaN; the cross and head expressions are written as they
// were, so nvcc contracts them the same way. No TF32, no split-K, no
// reassociation. Tiling and the cluster split change where operands come
// from, never this sequence, so a row's logit depends only on its features:
// not on its place in the batch, on B, or on the plan. That keeps the
// serving answers, the 2e-5 bar against the JAX reference and the golden
// tie rule exactly where the first kernel left them.
//
// Left to later work: wgmma/TMA tiles (they need TF32 or bf16 inputs and a
// parity bar of their own), and pulling the build_x0 gathers into the
// prologue.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 8;  // 4 row groups x 2 column groups
constexpr int kThreads = 32 * kWarps;
constexpr int kChunk = 16;     // k rows per unrolled step; a panel is 1 to 4 of them
constexpr int kMaxStages = 8;  // panels in the ring

__host__ __device__ inline int round4(int x) { return (x + 3) & ~3; }
// Stride of a transposed activation [k][row]: a multiple of 4 (float4
// rows) that is not a multiple of 32 (lane-strided k spreads over banks).
__host__ __device__ inline int act_ld(int rows) { return rows + 4; }
__host__ __device__ inline int slice_cols(int N, int C) { return round4((N + C - 1) / C); }
__host__ __device__ inline int lane_cols(int N, int C) { return (slice_cols(N, C) + 63) / 64; }
// Columns a lane may own per tile height (registers: ROWS/4 x CN sums).
__host__ __device__ constexpr int max_lane_cols(int rows) { return rows == 64 ? 5 : 8; }

// Floats of a block's shared memory before the weight ring: deep [H][ld];
// h [H][ld], which holds x0 [d][ld] and the cross rows [rows][round4(d)]
// until the first product is done; the cross rows' x . fw[H:] [rows].
__host__ __device__ inline int fixed_floats(int d, int H, int rows) {
  const int h = H * act_ld(rows), x = d * act_ld(rows) + rows * round4(d);
  return h + (h > x ? h : x) + rows;
}

long long smem_bytes(int d, int H, int rows, int C, int kp, int stages) {
  return 4LL * (fixed_floats(d, H, rows) + (long long)stages * kp * 64 * lane_cols(H, C));
}

struct TowerArgs {
  const float *x0, *w0, *b0, *w1, *b1, *w2, *b2, *cw, *cb, *fw, *fb;
  float* out;
  int B, d, H, R, L, canonical, cluster, vec, kp, stages;
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Wait until at most n of this thread's copy groups are pending.
__device__ __forceinline__ void cp_async_wait_at_most(int n) {
  switch (n) {
    case 6: cp_async_wait<6>(); break;
    case 5: cp_async_wait<5>(); break;
    case 4: cp_async_wait<4>(); break;
    case 3: cp_async_wait<3>(); break;
    case 2: cp_async_wait<2>(); break;
    case 1: cp_async_wait<1>(); break;
    default: cp_async_wait<0>(); break;
  }
}

// One block barrier, or a cluster barrier (which also orders the peers'
// distributed shared-memory writes before the reads that follow).
__device__ __forceinline__ void tile_sync(int C) {
  if (C > 1)
    cg::this_cluster().sync();
  else
    __syncthreads();
}

// Rows [k0, k0 + kn) of W's columns [c0, c0 + width) → dst [kn][np].
__device__ __forceinline__ void load_panel(float* dst, const float* W, int N, int c0, int width,
                                           int k0, int kn, int vec, int np) {
  if (width <= 0 || kn <= 0) return;
  if (vec) {  // N, c0 and width are multiples of 4 and W is 16-byte aligned
    const int w4 = width >> 2, n = kn * w4;
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const int kk = i / w4, q = i - kk * w4;
      cp_async16(dst + kk * np + 4 * q, W + (size_t)(k0 + kk) * N + c0 + 4 * q);
    }
  } else {
    const int n = kn * width;
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const int kk = i / width, q = i - kk * width;
      cp_async4(dst + kk * np + q, W + (size_t)(k0 + kk) * N + c0 + q);
    }
  }
}

// The block's column slices of all 1 + 2R weight matrices, as one sequence
// of kp-row panels through a ring of `stages` panels. Loads run stages - 1
// panels ahead of use, across the products' boundaries.
struct PanelStream {
  const float *w0, *w1, *w2;
  float* ring;
  int d, H, c0, width, vec, np, kp, stages;
  int n0, nh, total;  // panels of x0 @ W0, of an H-row product, of all
  int issued, used;

  // Panel `issued` into its stage; one copy group per panel, empty past
  // the end, so a group's age says which panel it holds.
  __device__ __forceinline__ void issue() {
    const int t = issued++;
    if (t < total) {
      const float* W = w0;
      int K = d, k0 = t * kp;
      if (t >= n0) {
        const int u = t - n0, p = u / nh;  // p: W1[0], W2[0], W1[1], ...
        W = ((p & 1) ? w2 : w1) + (size_t)(p >> 1) * H * H;
        K = H;
        k0 = (u - p * nh) * kp;
      }
      load_panel(ring + (t % stages) * kp * np, W, H, c0, width, k0, min(kp, K - k0), vec, np);
    }
    cp_async_commit();
  }
};

// RM consecutive floats of shared memory, RM a multiple of 4.
template <int RM>
__device__ __forceinline__ void load_rows(float (&v)[RM], const float* p) {
#pragma unroll
  for (int q = 0; q < RM / 4; ++q) {
    const float4 x = reinterpret_cast<const float4*>(p)[q];
    v[4 * q] = x.x;
    v[4 * q + 1] = x.y;
    v[4 * q + 2] = x.z;
    v[4 * q + 3] = x.w;
  }
}

template <int RM>
__device__ __forceinline__ void store_rows(float* p, const float (&v)[RM]) {
#pragma unroll
  for (int q = 0; q < RM / 4; ++q)
    reinterpret_cast<float4*>(p)[q] = make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
}

// One k step of a thread's RM x CN outputs: a = &act[k][first row],
// w = &panel[k][first column]; the thread's columns are 64 apart.
template <int RM, int CN>
__device__ __forceinline__ void fma_step(float (&acc)[RM][CN], const float* a, const float* w) {
  float av[RM];
  load_rows<RM>(av, a);
  float wv[CN];
#pragma unroll
  for (int c = 0; c < CN; ++c) wv[c] = w[64 * c];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int c = 0; c < CN; ++c) acc[i][c] = fmaf(av[i], wv[c], acc[i][c]);
}

// dst[j][r] = act(sum_k act_in[k][r] W[k][j] + bias[j] (+ dst[j][r] if RESID))
// for the tile's rows and this block's columns j in [c0, c0 + width), W
// coming from the panel stream; the result goes into the copy of dst of
// every block of the cluster. act_in, dst: shared, transposed [K][ROWS + 4].
template <int ROWS, int CN, bool RELU, bool RESID>
__device__ __forceinline__ void product(const float* act_in, int K, PanelStream& w,
                                        const float* __restrict__ bias, float* dst, int C) {
  constexpr int RM = ROWS / 4, LDA = ROWS + 4, NP = 64 * CN;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rg = warp & 3, cgp = warp >> 2;
  float acc[RM][CN];
  float bj[CN];  // loaded now, used after the last panel
#pragma unroll
  for (int c = 0; c < CN; ++c) {
    const int j = lane + 32 * (cgp + 2 * c);
    bj[c] = j < w.width ? __ldg(bias + w.c0 + j) : 0.f;
#pragma unroll
    for (int i = 0; i < RM; ++i) acc[i][c] = 0.f;
  }

  const int kp = w.kp, np = (K + kp - 1) / kp;
  for (int p = 0; p < np; ++p) {
    const int k0 = p * kp, kn = min(kp, K - k0);
    cp_async_wait_at_most(w.stages - 2);  // this thread's copies of the panel landed
    __syncthreads();  // everyone's have, and everyone is done with the last panel
    const int t = w.used++;
    w.issue();  // panel t + stages - 1, into the last panel's stage
    const float* wp = w.ring + (t % w.stages) * kp * NP + lane + 32 * cgp;
    const float* ap = act_in + k0 * LDA + rg * RM;
    int kk = 0;
    for (; kk + kChunk <= kn; kk += kChunk) {
#pragma unroll
      for (int u = 0; u < kChunk; ++u) fma_step<RM, CN>(acc, ap + (kk + u) * LDA, wp + (kk + u) * NP);
    }
    for (; kk < kn; ++kk) fma_step<RM, CN>(acc, ap + kk * LDA, wp + kk * NP);
  }

#pragma unroll
  for (int c = 0; c < CN; ++c) {
    const int j = lane + 32 * (cgp + 2 * c);
    if (j < w.width) {
      float* own = dst + (w.c0 + j) * LDA + rg * RM;
      float y[RM];
      if (RESID) load_rows<RM>(y, own);  // the block's own column: no peer writes it
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        float v = acc[i][c] + bj[c];
        if (RESID) v += y[i];
        if (RELU) v = v < 0.f ? 0.f : v;  // keeps NaN, like torch.relu
        y[i] = v;
      }
      for (int peer = 0; peer < C; ++peer)
        store_rows<RM>(C > 1 ? cg::this_cluster().map_shared_rank(own, peer) : own, y);
    }
  }
}

template <int ROWS, int CN>
__global__ void __launch_bounds__(kThreads, 1) tower_eval_kernel(TowerArgs a) {
  extern __shared__ float4 smem4[];
  constexpr int LDA = ROWS + 4;
  const int d = a.d, H = a.H, L = a.L, C = a.cluster;
  const int d4 = round4(d);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* deep = reinterpret_cast<float*>(smem4);  // [H][LDA]
  float* hs = deep + H * LDA;                     // [H][LDA], first x0t and xc:
  float* x0t = hs;                                // [d][LDA] x0, transposed
  float* xc = x0t + d * LDA;                      // [ROWS][d4] cross x, row-major
  float* xfw = deep + fixed_floats(d, H, ROWS) - ROWS;  // [ROWS] x . fw[H:] per cross row
  float* ring = xfw + ROWS;                        // [stages][kp][64 CN] weight panels,
  float* cws = ring;                              // first the cross weights [L][d],
  float* cbs = cws + L * d;                       // biases [L][d]
  float* fwx = cbs + L * d;                       // and fw[H:] [d]
  const int rank = C > 1 ? static_cast<int>(cg::this_cluster().block_rank()) : 0;
  const int row0 = (blockIdx.x / C) * ROWS;

  // The x0 tile (rows past B are zero and never written out) and the
  // cross stack's vectors.
  for (int i = threadIdx.x; i < ROWS * d; i += kThreads) {
    const int r = i / d, k = i - r * d;
    const int row = row0 + r;
    const float v = row < a.B ? a.x0[(size_t)row * d + k] : 0.f;
    x0t[k * LDA + r] = v;
    xc[r * d4 + k] = v;
  }
  for (int i = threadIdx.x; i < L * d; i += kThreads) {
    cws[i] = __ldg(a.cw + i);
    cbs[i] = __ldg(a.cb + i);
  }
  for (int i = threadIdx.x; i < d; i += kThreads) fwx[i] = __ldg(a.fw + H + i);
  __syncthreads();

  // Cross stack and its half of the head first, while x0 is at hand: one
  // warp per row, rows r = rank (mod C). A lane only ever touches its own
  // columns k = lane (mod 32) of the row.
  for (int r = rank + C * warp; r < ROWS; r += C * kWarps) {
    float* x = xc + r * d4;
    for (int l = 0; l < L; ++l) {
      const float* wl = cws + l * d;
      const float* bl = cbs + l * d;
      float g = 0.f;
      for (int k = lane; k < d; k += 32) g = fmaf(x[k], wl[k], g);
      g = warp_sum(g);
      for (int k = lane; k < d; k += 32) {
        const float xk = x[k];
        x[k] = a.canonical ? (x0t[k * LDA + r] * g + bl[k]) + xk : (xk + xk * g) + bl[k];
      }
    }
    float t = 0.f;
    for (int k = lane; k < d; k += 32) t = fmaf(x[k], fwx[k], t);
    t = warp_sum(t);
    if (lane == 0) xfw[r] = t;
  }
  // The ring is free again; and, as the cluster's start barrier, every
  // block runs before a peer writes into its shared memory.
  tile_sync(C);

  // Deep tower, this block's column slice of every product.
  PanelStream w;
  w.w0 = a.w0;
  w.w1 = a.w1;
  w.w2 = a.w2;
  w.ring = ring;
  w.d = d;
  w.H = H;
  const int nc = slice_cols(H, C);
  w.c0 = min(rank * nc, H);
  w.width = min(nc, H - w.c0);
  w.vec = a.vec;
  w.np = 64 * CN;
  w.kp = a.kp;
  w.stages = a.stages;
  w.n0 = (d + a.kp - 1) / a.kp;
  w.nh = (H + a.kp - 1) / a.kp;
  w.total = w.n0 + 2 * a.R * w.nh;
  w.issued = w.used = 0;
  for (int i = 0; i < w.stages - 1; ++i) w.issue();

  product<ROWS, CN, false, false>(x0t, d, w, a.b0, deep, C);
  tile_sync(C);  // from here on h may be written: x0 and the cross rows are done
  for (int r = 0; r < a.R; ++r) {
    product<ROWS, CN, true, false>(deep, H, w, a.b1 + (size_t)r * H, hs, C);
    tile_sync(C);
    product<ROWS, CN, true, true>(hs, H, w, a.b2 + (size_t)r * H, deep, C);
    tile_sync(C);
  }
  // The last peer write is behind the sync above, so from here on a block
  // only touches its own shared memory and may leave when it is done.

  for (int r = rank + C * warp; r < ROWS; r += C * kWarps) {
    float s = 0.f;
    for (int k = lane; k < H; k += 32) s = fmaf(deep[k * LDA + r], __ldg(a.fw + k), s);
    s = warp_sum(s);
    if (lane == 0 && row0 + r < a.B) a.out[row0 + r] = (s + xfw[r]) + __ldg(a.fb);
  }
}

using KernelFn = void (*)(TowerArgs);

template <int ROWS, int CN>
KernelFn instance() {
  if constexpr (CN <= max_lane_cols(ROWS))
    return tower_eval_kernel<ROWS, CN>;
  else
    return nullptr;
}

template <int ROWS>
KernelFn pick_cn(int cn) {
  switch (cn) {
    case 1: return instance<ROWS, 1>();
    case 2: return instance<ROWS, 2>();
    case 3: return instance<ROWS, 3>();
    case 4: return instance<ROWS, 4>();
    case 5: return instance<ROWS, 5>();
    case 6: return instance<ROWS, 6>();
    case 7: return instance<ROWS, 7>();
    case 8: return instance<ROWS, 8>();
    default: return nullptr;
  }
}

bool valid_cluster(int C) { return C == 1 || C == 2 || C == 4 || C == 8; }

// The kernel instance for a plan, or nullptr when the plan is not one.
KernelFn pick(int H, int rows, int C) {
  if (!valid_cluster(C) || H <= 0) return nullptr;
  switch (rows) {
    case 16: return pick_cn<16>(lane_cols(H, C));
    case 32: return pick_cn<32>(lane_cols(H, C));
    case 64: return pick_cn<64>(lane_cols(H, C));
    default: return nullptr;
  }
}

bool valid_ring(int kp, int stages) {
  return kp >= kChunk && kp <= 4 * kChunk && kp % kChunk == 0 && stages >= 2 && stages <= kMaxStages;
}

// How many clusters of `cluster` blocks of k, with `smem` bytes of shared
// memory each, the card runs at once.
cudaError_t active_clusters(KernelFn k, int cluster, size_t smem, int* n) {
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaOccupancyMaxActiveClusters(n, k, &cfg);
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

}  // namespace

extern "C" {

long long hhrs_tower_eval_smem_bytes(int d, int H, int rows, int cluster, int kp, int stages) {
  return smem_bytes(d, H, rows, cluster, kp, stages);
}

const char* hhrs_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Once per plan and process, before its first launch: lets the plan's
// kernel instance use up to `smem_optin` bytes of dynamic shared memory and
// returns how many of its clusters (C = 1: blocks per SM) fit on the card
// at once, or -(CUDA error) when that cannot be set or asked.
int hhrs_tower_eval_prepare(int d, int H, int rows, int cluster, int kp, int stages, int smem_optin) {
  const KernelFn k = pick(H, rows, cluster);
  if (k == nullptr || !valid_ring(kp, stages)) return -static_cast<int>(cudaErrorInvalidValue);
  const long long smem = smem_bytes(d, H, rows, cluster, kp, stages);
  if (smem > smem_optin) return -static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_optin);
  if (err != cudaSuccess) return -static_cast<int>(err);
  int n = 0;
  if (cluster == 1)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, k, kThreads, static_cast<size_t>(smem));
  else
    err = active_clusters(k, cluster, static_cast<size_t>(smem), &n);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

// How many clusters of `cluster` blocks (2, 4 or 8), each block taking a
// whole SM's shared memory (`smem_optin` bytes), the card runs at once; or
// -(CUDA error). Clusters are placed within a GPC, so this is not simply
// the SM count over `cluster`. ops/tower.py::tower_plan counts waves with it.
int hhrs_tower_eval_resident_clusters(int cluster, int smem_optin) {
  if (cluster < 2 || !valid_cluster(cluster)) return -static_cast<int>(cudaErrorInvalidValue);
  const KernelFn k = tower_eval_kernel<16, 1>;
  cudaError_t err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_optin);
  if (err != cudaSuccess) return -static_cast<int>(err);
  int n = 0;
  err = active_clusters(k, cluster, static_cast<size_t>(smem_optin), &n);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

// Launches on `stream` and returns cudaGetLastError() (0 on success). All
// pointers are device pointers to contiguous float32 arrays:
// x0 [B, d], w0 [d, H], b0 [H], w1/w2 [R, H, H], b1/b2 [R, H],
// cw/cb [L, d], fw [H + d], fb [1], out [B]. The plan (rows per tile: 16,
// 32 or 64; cluster size: 1, 2, 4 or 8; panel rows and ring stages)
// comes from ops/tower.py and was prepared with hhrs_tower_eval_prepare.
int hhrs_tower_eval(const void* x0, const void* w0, const void* b0, const void* w1,
                    const void* b1, const void* w2, const void* b2, const void* cw,
                    const void* cb, const void* fw, const void* fb, void* out, int B, int d,
                    int H, int R, int L, int canonical, int rows, int cluster, int kp, int stages,
                    void* stream) {
  if (B <= 0) return 0;
  const KernelFn k = pick(H, rows, cluster);
  // The cross stack's vectors are staged in the ring before the weights.
  if (k == nullptr || d <= 0 || !valid_ring(kp, stages) ||
      (2LL * L + 1) * d > (long long)stages * kp * 64 * lane_cols(H, cluster))
    return static_cast<int>(cudaErrorInvalidValue);
  TowerArgs a;
  a.x0 = static_cast<const float*>(x0);
  a.w0 = static_cast<const float*>(w0);
  a.b0 = static_cast<const float*>(b0);
  a.w1 = static_cast<const float*>(w1);
  a.b1 = static_cast<const float*>(b1);
  a.w2 = static_cast<const float*>(w2);
  a.b2 = static_cast<const float*>(b2);
  a.cw = static_cast<const float*>(cw);
  a.cb = static_cast<const float*>(cb);
  a.fw = static_cast<const float*>(fw);
  a.fb = static_cast<const float*>(fb);
  a.out = static_cast<float*>(out);
  a.B = B;
  a.d = d;
  a.H = H;
  a.R = R;
  a.L = L;
  a.canonical = canonical;
  a.cluster = cluster;
  a.vec = (H % 4 == 0) && aligned16(w0) && aligned16(w1) && aligned16(w2);
  a.kp = kp;
  a.stages = stages;

  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(((B + rows - 1) / rows) * cluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem_bytes(d, H, rows, cluster, kp, stages));
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = &attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;  // C = 1: a plain launch, no cluster
  const cudaError_t err = cudaLaunchKernelEx(&cfg, k, a);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
