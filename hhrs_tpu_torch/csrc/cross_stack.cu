// Fused L-layer feature-cross stack, forward and backward, for Hopper: one
// launch each way.
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
// What bounds it on an H100: bytes at large batches, and latency below. At
// B = 8192, d = 113, L = 3 a forward moves 7.4 MB (2.2 us at 3.35 TB/s) and
// does 14 MFLOP; at the training batch (B = 512) the bytes take 0.14 us, far
// less than a launch, and a backward row is a chain of 2L dependent shuffle
// reductions (about 1.3 us), after which the batch sums cross the blocks.
// The first kernels waited on L2 for w and b in every layer, loaded one row
// at a time per warp, and summed dw, db in a second launch. This design:
//
//  * loads w and b once per block into shared memory, with plain coalesced
//    loads issued while the first tile's copy is in flight;
//  * brings rows in tiles of T consecutive rows (T a multiple of 4, so a
//    tile is a multiple of 16 bytes and starts on a 16-byte boundary): one
//    thread issues one bulk copy (cp.async.bulk, the copy engine of TMA)
//    per tile and input into a ring of `stages` buffers, each completing on
//    its stage's mbarrier. The last rows of the batch that do not fill a
//    multiple of 4 are read from global memory by the warps that own them;
//  * runs a persistent grid: block k walks tiles k, k + grid, ...; the plan
//    (T, grid, stages) comes from ops/cross.py::cross_plan, which sizes T so
//    that the batch fills the blocks the card runs at once (asked of the
//    card, hhrs_cross_capacity), in one wave;
//  * sends outputs as coalesced stores from registers (on an H100 these beat
//    a bulk store per tile from shared memory at every timed size);
//  * sums dw and db over the batch in the same launch, without float
//    atomics, so two runs give bit-identical gradients: each warp sums its
//    rows in order in registers; each block sums its warps in order 0..7 in
//    shared memory; the backward runs in clusters of 8 blocks (a trial plan
//    may take 2: the cluster size CL is a template parameter), and each
//    block of a cluster adds one slice of the columns over the CL blocks in
//    rank order, through distributed shared memory, into the cluster's row
//    of `partial`; the block that draws the last ticket of an integer
//    counter adds the clusters' rows in order and writes dw, db. A round
//    through global memory (writes, a ticket, reads) costs about a
//    microsecond, so summing the cluster on chip saves one. The order
//    depends on the plan alone, and the ticket counter is back at 0 when
//    the launch ends, so a captured CUDA graph replays correctly.
//
// The row arithmetic is the first kernel's, operation for operation: lane k
// of a warp owns columns k, k + 32, ... of a row (NPL = ceil(d/32) of them,
// a template parameter), the gate is one fmaf chain and a shuffle tree, the
// updates use __fmul_rn / __fadd_rn (never a contracted FMA, so they round as
// the plain version's separate operations). So y and dx0 are bit for bit
// those of the earlier kernels, at any position in any tile and under any
// plan.
//
// The element type T is a template parameter beside NPL: float, or
// __nv_bfloat16 for a model run at model.compute_dtype=bfloat16, where the
// Pallas kernel computes on bf16 refs. A bf16 instance loads bf16 rows, w
// and b and rounds each result to bf16 where the plain version (ops/cross.py,
// the JAX ops and their VJP) rounds: after each elementwise product and sum,
// a gate or row sum once after its f32 sum (the product of two bf16 values
// is exact in f32), dw and db once after the same deterministic f32 batch
// sums. Its tiles hold bf16 rows, so a tile is a multiple of 16 bytes when
// its row count is a multiple of 8 (kRowAlign<T>).
//
// bf16 on pairs. Rounding every elementwise f32 result through an f32 ->
// bf16 -> f32 round trip costs two or three instructions a value. Both bf16
// instances keep a row as bf16x2 pairs from load to store (a lane's columns
// k + 64q and k + 64q + 32 in pair q) and do the elementwise products and
// sums with mul.rn / add.rn.bf16x2: one instruction for two values, rounded
// once, as the plain version's f32 operation rounded to bf16 is (the f32 sum
// of two bf16 values rounds to the same bf16; so does their f32 product,
// which is exact unless it falls below f32's normal range, |p| < 2^-126).
// One device function (layer_pairs) is a layer of the bf16 forward and of
// the bf16 backward's recompute, so the two cannot drift apart. What the
// plain version sums in f32 stays in f32, in the same order: the gates' fmaf
// chains, the row sums of bf16-rounded products, dw and db. So y and dx0 are
// the earlier f32-rounding instance's bit for bit on every input whose
// products stay above 2^-126. b reaches the update as pairs in the lanes'
// layout, w the gates as f32 values.
//
// A warp's rows (PERF.md, section 6). A row is a chain of dependent shuffle
// reductions (L forward, 2L backward) with little work between them, so a
// warp walking one row at a time leaves the chain's latency between every
// two of its rows. A warp walks R rows at once (rows r, r + 8, ... of its
// tile, interleaved: each reduction's butterfly steps of the R rows issue
// together and overlap), then its last rows one at a time. R is 2 where two
// rows' registers fit the instance's budget, else 1 (fwd_rows_at_once,
// bwd_rows_at_once). The backward's rows' terms enter the warp's dw, db sums
// one row after another, in row order, so dw and db do not depend on R; its
// per-row arrays are sized by the instance's most layers, LMAX = 3 or 6 (the
// launch takes the smaller that holds L).
//
// The forward's weights and small batches. A forward layer reads the lane's
// columns of w_l and b_l into registers once for its R rows (the two rows'
// reads of one shared address are not merged otherwise, and the shared
// memory pipe then carries twice the loads). Where the plan gives every
// block one tile of at most R rows a warp (B up to about 16 rows a block:
// the training batch, 4487 and 8192 rows, K trials of 512), a second kernel,
// cross_fwd_direct_kernel, reads the rows, w and b straight from global
// memory (w and b through L1, which the trial's blocks on an SM share): no
// shared memory, mbarrier or barrier, so every warp starts on its rows at
// once. Larger batches stream through the ring, whose bulk copies keep a
// tile's loads in flight together, at most 64 rows a block
// (ops/cross.py::fwd_plan evens the tiles out where a block takes several),
// so four blocks fit an SM at d = 145 in float32.

// The trial axis. Vectorized HPO trains K trials of one architecture as one
// program: x0 [K, B, d] with w, b [K, L, d], the counterpart of jax.vmap of
// cross_stack_pallas, which Pallas batches by adding a grid axis. Here grid
// axis y is the trial: block (x, k) runs block x of a single-trial plan on
// trial k's rows and weights, and the backward's sums of trial k go through
// its own slice of `partial` and its own ticket counter. The blocks of one
// trial do what the single-trial launch's blocks do, in the same order, so
// lane k's y, dx0, dw and db are bit for bit the single-trial kernel's on
// lane k's inputs under the same plan. No block waits for another outside
// its cluster (the ticket decides who sums, nobody spins on it), so the K
// grids need not be resident at once: past the card's capacity they run in
// waves. The single-trial entry points are the launches with K = 1.
//
// The trial axis's plans (ops/cross.py::fwd_trial_plan, trial_plan) give
// each of the K grids capacity / K blocks (the backward's in whole
// clusters), so the K grids fit the card in one wave and a block carries
// more rows; lane k is the single-trial launch under that plan, bit for bit
// (y under any plan). The backward's clusters are of 8 blocks unless that
// rounding leaves over a third of the card idle: the card holds 15 clusters
// of 8 at d = 145 (one block an SM), so 8 trials would get 8 blocks each;
// clusters of 2 give them 16. A cluster of 2 sums more partial rows, which
// costs where blocks have few rows.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

namespace {

namespace cg = cooperative_groups;

constexpr int kWarps = 8;             // warps per block
constexpr int kThreads = kWarps * 32;
constexpr int kMaxLayers = 6;         // the JAX search space's largest stack
constexpr int kMaxPerLane = 8;        // d <= 256
constexpr int kMaxRows = 48;          // rows per tile
constexpr int kMaxStages = 3;         // tiles in flight per block
constexpr int kMaxRing = 96;          // stages x rows
constexpr int kFwdRing = 64;          // stages x rows of the forward's plans
constexpr int kHeadBytes = 128;       // the stages' mbarriers, padded
constexpr int kCluster = 8;           // backward: blocks that sum through shared memory
constexpr int kSmallCluster = 2;      // a trial plan's other cluster size
constexpr int kFewLayers = 3;         // the backward's instance for L <= 3 (beside kMaxLayers)
constexpr int kPairs = kMaxPerLane / 2;  // bf16x2 pairs of a lane's columns

__host__ __device__ constexpr size_t round_up(size_t x, size_t m) { return (x + m - 1) / m * m; }

using bf16 = __nv_bfloat16;

// Rows of T a bulk copy moves at a time: 16 bytes for any row width d.
template <class T>
constexpr int kRowAlign = 16 / static_cast<int>(sizeof(T));

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

template <class T>
__device__ __forceinline__ T from_f(float v) {
  if constexpr (std::is_same_v<T, float>) {
    return v;
  } else {
    return __float2bfloat16_rn(v);
  }
}

// Shared memory: mbarriers | w, b [L][d] each | (bf16: w, b again as bf16x2
// pairs in the lanes' layout [L][kPairs][32] each) | the ring of tiles
// [stages][streams][T][d], which the backward reuses for the warps' sums
// [kWarps][2][L][d] once the tiles are done. The direct forward kernel
// uses none of it.
__host__ __device__ constexpr size_t weights_bytes(int d, int L) {
  return round_up(2 * sizeof(float) * L * d, 128);
}

__host__ __device__ constexpr size_t pairs_bytes(int L) {
  return 2 * sizeof(uint32_t) * L * kPairs * 32;
}

size_t smem_bytes(int rows, int stages, int d, int L, bool backward, size_t elem) {
  const size_t streams = backward ? 2 : 1;
  size_t body = elem * stages * streams * rows * d;
  if (backward) {
    const size_t sums = sizeof(float) * kWarps * 2 * L * d;
    if (sums > body) body = sums;
  }
  const size_t pairs = elem == sizeof(bf16) ? pairs_bytes(L) : 0;
  return kHeadBytes + weights_bytes(d, L) + pairs + body;
}

// ---- mbarriers and bulk copies (PTX) -------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(1u) : "memory");
}

// The phase's one arrival, which also expects `bytes` of copies to land.
__device__ __forceinline__ void mbar_arrive_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "WAIT:\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n\t"
      "@!p bra WAIT;\n\t"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// global -> shared: `bytes` a multiple of 16, both addresses 16-byte aligned.
__device__ __forceinline__ void copy_in(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// ---- the tile stream -------------------------------------------------------

// The block's tiles k = 0, 1, ... are tiles blockIdx.x + k * gridDim.x of the
// batch. Tile k lands in stage k % stages, whose mbarrier completes phase
// (k / stages) & 1 when the tile's bulk copies have arrived. Only the first
// rows & ~(kRowAlign - 1) rows of a tile are copied; the rest (the batch's
// last rows, fewer than kRowAlign) stay in global memory.
template <class T>
struct TileRing {
  uint64_t* bars;
  T* buf;
  int B, d, rows, stages, streams;

  __device__ int first_row(int k) const { return (blockIdx.x + k * gridDim.x) * rows; }
  __device__ int n_rows(int k) const { return min(rows, B - first_row(k)); }
  __device__ int copied_rows(int k) const { return n_rows(k) & ~(kRowAlign<T> - 1); }
  __device__ T* tile(int k, int stream) const {
    return buf + ((size_t)(k % stages) * streams + stream) * rows * d;
  }
  // One thread: the copies of tile k from a (and, with two streams, c).
  __device__ void issue(int k, const T* a, const T* c) const {
    const size_t r0 = first_row(k);
    const uint32_t bytes = copied_rows(k) * d * sizeof(T);
    uint64_t* bar = bars + k % stages;
    mbar_arrive_expect(bar, bytes * streams);
    if (bytes == 0) return;
    copy_in(tile(k, 0), a + r0 * d, bytes, bar);
    if (streams == 2) copy_in(tile(k, 1), c + r0 * d, bytes, bar);
  }
  __device__ void wait(int k) const { mbar_wait(bars + k % stages, (k / stages) & 1); }
};

// Block set-up: thread 0 starts the first tiles' copies, then every thread
// loads w and b into shared memory (as f32) while they fly.
template <class T>
__device__ __forceinline__ void start(const TileRing<T>& ring, int mine, const T* a,
                                      const T* c, const T* __restrict__ w,
                                      const T* __restrict__ b, float* ws, float* bs,
                                      int n) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < ring.stages; ++s) mbar_init(ring.bars + s);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int k = 0; k < min(ring.stages, mine); ++k) ring.issue(k, a, c);
  }
  for (int i = threadIdx.x; i < n; i += kThreads) {
    ws[i] = to_f(w[i]);
    bs[i] = to_f(b[i]);
  }
  __syncthreads();
}

// After tile k: once the block's warps are done with its buffer, thread 0
// refills it with tile k + stages, if the block has one.
template <class T>
__device__ __forceinline__ void finish_tile(const TileRing<T>& ring, int k, int mine,
                                            const T* a, const T* c) {
  if (k + ring.stages >= mine) return;  // uniform across the block
  __syncthreads();
  if (threadIdx.x == 0) ring.issue(k + ring.stages, a, c);
}

// ---- the row arithmetic -----------------------------------------------------

// The lane's share of sum_c a[c] * v[c] over the row, a held by the lanes,
// v(j) the value at the lane's column j (c = lane + 32 j): one fmaf chain.
template <int NPL, class V>
__device__ __forceinline__ float lane_dot(const float (&a)[NPL], V v, int lane, int d) {
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < NPL; ++j) {
    if (lane + 32 * j < d) s = fmaf(a[j], v(j), s);
  }
  return s;
}

// One float32 cross layer on a row held in registers, each product and sum
// rounded on its own (b(j): b_l at the lane's column j). Columns past d stay
// zero.
template <int NPL, class Bias>
__device__ __forceinline__ void layer_step(float (&x)[NPL], const float (&x0)[NPL], float g, Bias b, int lane,
                                           int d, int canonical) {
#pragma unroll
  for (int j = 0; j < NPL; ++j) {
    if (lane + 32 * j < d) {
      const float bc = b(j);
      x[j] = canonical ? __fadd_rn(__fadd_rn(__fmul_rn(x0[j], g), bc), x[j])
                       : __fadd_rn(__fadd_rn(x[j], __fmul_rn(x[j], g)), bc);
    }
  }
}

template <int NPL>
__device__ __forceinline__ void load_row(float (&r)[NPL], const float* src, int lane, int d) {
#pragma unroll
  for (int j = 0; j < NPL; ++j) {
    const int c = lane + 32 * j;
    r[j] = c < d ? src[c] : 0.f;
  }
}

template <int NPL>
__device__ __forceinline__ void store_row(float* dst, const float (&r)[NPL], int lane, int d) {
#pragma unroll
  for (int j = 0; j < NPL; ++j) {
    const int c = lane + 32 * j;
    if (c < d) dst[c] = r[j];
  }
}

// ---- the kernels -------------------------------------------------------------

struct Layout {
  uint64_t* bars;
  float *ws, *bs;
  uint32_t* pairs;  // bf16: w, b as bf16x2 pairs [2][L][kPairs][32]
  unsigned char* ring;
  __device__ Layout(unsigned char* smem, int d, int L, bool with_pairs = false)
      : bars(reinterpret_cast<uint64_t*>(smem)),
        ws(reinterpret_cast<float*>(smem + kHeadBytes)),
        bs(ws + L * d),
        pairs(reinterpret_cast<uint32_t*>(smem + kHeadBytes + weights_bytes(d, L))),
        ring(smem + kHeadBytes + weights_bytes(d, L) + (with_pairs ? pairs_bytes(L) : 0)) {}
};

__device__ __forceinline__ int tiles_of_block(int B, int rows) {
  const int n_tiles = (B + rows - 1) / rows;
  return n_tiles > (int)blockIdx.x ? (n_tiles - blockIdx.x + gridDim.x - 1) / gridDim.x : 0;
}

// Thread 0 takes a ticket on `counter`; true in every thread of the block
// that drew the last of `expected` tickets, which also puts the counter back
// to 0. Every block's global writes before the call are visible to that
// block: the barrier, then thread 0's ticket, an atomic add with release
// (cumulative over the barrier) and acquire semantics at GPU scope.
__device__ __forceinline__ bool last_to_arrive(unsigned int* counter, unsigned int expected) {
  __shared__ int last;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned int ticket;
    asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;\n"
                 : "=r"(ticket)
                 : "l"(counter)
                 : "memory");
    last = ticket == expected - 1;
    if (last) *counter = 0;
  }
  __syncthreads();
  return last;
}

// out(i, sum over k < count of src[k * stride + i]) for every i < n, each sum
// added in order k = 0, 1, ... A thread takes kSumCols columns kThreads apart
// and loads kSumTerms terms of each before it adds them, so the L2 reads of a
// sum overlap instead of following one another.
constexpr int kSumCols = 4, kSumTerms = 8;

template <class Out>
__device__ __forceinline__ void ordered_sums(const float* src, size_t stride, int count, int n,
                                             Out out) {
  for (int i0 = threadIdx.x; i0 < n; i0 += kThreads * kSumCols) {
    float t[kSumCols];
#pragma unroll
    for (int m = 0; m < kSumCols; ++m) t[m] = 0.f;
    for (int k0 = 0; k0 < count; k0 += kSumTerms) {
      float v[kSumCols][kSumTerms];
#pragma unroll
      for (int m = 0; m < kSumCols; ++m) {
#pragma unroll
        for (int q = 0; q < kSumTerms; ++q) {
          const int i = i0 + m * kThreads, k = k0 + q;
          v[m][q] = i < n && k < count ? __ldcg(src + (size_t)k * stride + i) : 0.f;
        }
      }
#pragma unroll
      for (int m = 0; m < kSumCols; ++m) {
#pragma unroll
        for (int q = 0; q < kSumTerms; ++q) {
          if (k0 + q < count) t[m] += v[m][q];
        }
      }
    }
#pragma unroll
    for (int m = 0; m < kSumCols; ++m) {
      if (i0 + m * kThreads < n) out(i0 + m * kThreads, t[m]);
    }
  }
}

// ---- a warp's rows, R at once --------------------------------------------

// R sums over the warp at once: the R sums' butterfly steps issue together,
// so their shuffles overlap; each sum adds as warp_sum adds.
template <int R>
__device__ __forceinline__ void warp_sums(float (&v)[R]) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
    for (int i = 0; i < R; ++i) v[i] += __shfl_xor_sync(0xffffffffu, v[i], o);
  }
}

// Rows a warp of the backward walks at once: 2 where two rows' registers
// (x_l for every layer, x0, dy, the canonical dx0 sum, the gates) and the
// warp's dw, db sums fit the instance's budget (128 registers a thread where
// two blocks share an SM, else 255, less a margin for addresses), else 1.
template <int NPL, int LMAX>
__host__ __device__ constexpr int bwd_rows_at_once() {
  constexpr int per_row = NPL * (LMAX + 3) + LMAX;
  constexpr int budget = NPL <= 4 ? 128 : 240;
  return 2 * per_row + 2 * LMAX * NPL + 32 <= budget ? 2 : 1;
}

// float32: R rows of the backward, interleaved, each with the row
// arithmetic the header describes (fmaf chains, the updates as fused
// multiply-adds), so y and dx0 do not depend on R. Row i's terms enter
// dw_acc, db_acc after row i - 1's.
template <int NPL, int LMAX, int R>
__device__ __forceinline__ void rows_f32(const float* (&xr)[R], const float* (&dyr)[R], float* (&out)[R],
                                         const float* ws, const float* bs, int lane, int d, int L,
                                         int canonical, float (&dw_acc)[LMAX][NPL],
                                         float (&db_acc)[LMAX][NPL]) {
  float xin[R][NPL], x[R][NPL], dx[R][NPL], dx0_acc[R][NPL], xs[R][LMAX][NPL], g[R][LMAX];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    load_row<NPL>(xin[i], xr[i], lane, d);
    load_row<NPL>(dx[i], dyr[i], lane, d);
#pragma unroll
    for (int j = 0; j < NPL; ++j) {
      x[i][j] = xin[i][j];
      dx0_acc[i][j] = 0.f;
    }
  }
  // Recompute the layer inputs x_l and gates g_l, as the forward does.
#pragma unroll
  for (int l = 0; l < LMAX; ++l) {
    if (l < L) {
      float t[R];
#pragma unroll
      for (int i = 0; i < R; ++i) {
#pragma unroll
        for (int j = 0; j < NPL; ++j) xs[i][l][j] = x[i][j];
        t[i] = lane_dot<NPL>(x[i], [=](int j) { return ws[l * d + lane + 32 * j]; }, lane, d);
      }
      warp_sums<R>(t);
#pragma unroll
      for (int i = 0; i < R; ++i) {
        g[i][l] = t[i];
        layer_step<NPL>(
            x[i], xin[i], g[i][l], [=](int j) { return bs[l * d + lane + 32 * j]; }, lane, d, canonical);
      }
    }
  }
  // Walk back through the layers.
#pragma unroll
  for (int l = LMAX - 1; l >= 0; --l) {
    if (l < L) {
      const float* wl = ws + l * d;
      float t[R];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        t[i] = 0.f;
#pragma unroll
        for (int j = 0; j < NPL; ++j) t[i] = fmaf(dx[i][j], canonical ? xin[i][j] : xs[i][l][j], t[i]);
      }
      warp_sums<R>(t);
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const float sl = t[i];
#pragma unroll
        for (int j = 0; j < NPL; ++j) {
          const int c = lane + 32 * j;
          const float wc = c < d ? wl[c] : 0.f;
          db_acc[l][j] += dx[i][j];
          dw_acc[l][j] = fmaf(sl, xs[i][l][j], dw_acc[l][j]);
          if (canonical) {
            dx0_acc[i][j] = fmaf(dx[i][j], g[i][l], dx0_acc[i][j]);
            dx[i][j] = fmaf(sl, wc, dx[i][j]);
          } else {
            dx[i][j] = fmaf(sl, wc, dx[i][j] * (1.f + g[i][l]));
          }
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
    if (canonical) {
#pragma unroll
      for (int j = 0; j < NPL; ++j) dx[i][j] = dx[i][j] + dx0_acc[i][j];
    }
    store_row<NPL>(out[i], dx[i], lane, d);
  }
}

// bf16x2 pairs: pair q of a lane holds its columns j = 2q (low half) and
// 2q + 1 (high half), columns lane + 64q and lane + 64q + 32 of the row.
__device__ __forceinline__ uint32_t mul2(uint32_t a, uint32_t b) {
  uint32_t r;
  asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}

__device__ __forceinline__ uint32_t add2(uint32_t a, uint32_t b) {
  uint32_t r;
  asm("add.rn.bf16x2 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}

// Two f32 values rounded to bf16 (as __float2bfloat16_rn rounds) and packed,
// lo in the low half.
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

__device__ __forceinline__ float lo_f(uint32_t p) { return __uint_as_float(p << 16); }
__device__ __forceinline__ float hi_f(uint32_t p) { return __uint_as_float(p & 0xffff0000u); }

// Pair q of a lane's columns of the row at src (0 past d).
template <int NPL>
__device__ __forceinline__ uint32_t pair_at(const bf16* src, int q, int lane, int d) {
  const int c0 = lane + 64 * q, c1 = c0 + 32;
  const uint32_t lo = c0 < d ? __bfloat16_as_ushort(src[c0]) : 0u;
  const uint32_t hi = 2 * q + 1 < NPL && c1 < d ? __bfloat16_as_ushort(src[c1]) : 0u;
  return lo | hi << 16;
}

template <int NPL>
__device__ __forceinline__ void load_pairs(uint32_t (&p)[(NPL + 1) / 2], const bf16* src, int lane, int d) {
#pragma unroll
  for (int q = 0; q < (NPL + 1) / 2; ++q) p[q] = pair_at<NPL>(src, q, lane, d);
}

template <int NPL>
__device__ __forceinline__ void store_pairs(bf16* dst, const uint32_t (&p)[(NPL + 1) / 2], int lane, int d) {
#pragma unroll
  for (int q = 0; q < (NPL + 1) / 2; ++q) {
    const int c0 = lane + 64 * q, c1 = c0 + 32;
    if (c0 < d) dst[c0] = __ushort_as_bfloat16(static_cast<unsigned short>(p[q] & 0xffffu));
    if (2 * q + 1 < NPL && c1 < d) dst[c1] = __ushort_as_bfloat16(static_cast<unsigned short>(p[q] >> 16));
  }
}

// w and b of every layer as bf16x2 pairs in the lanes' layout (0 past d),
// from their f32 copies in shared memory.
__device__ __forceinline__ void pack_weights(uint32_t* wp, uint32_t* bp, const float* ws, const float* bs,
                                             int d, int L) {
  for (int i = threadIdx.x; i < L * kPairs * 32; i += kThreads) {
    const int l = i / (kPairs * 32), c0 = i % 32 + 64 * (i / 32 % kPairs), c1 = c0 + 32;
    wp[i] = pack2(c0 < d ? ws[l * d + c0] : 0.f, c1 < d ? ws[l * d + c1] : 0.f);
    bp[i] = pack2(c0 < d ? bs[l * d + c0] : 0.f, c1 < d ? bs[l * d + c1] : 0.f);
  }
  __syncthreads();
}

// One cross layer on R rows of bf16x2 pairs, interleaved: the bf16
// forward's layer, and the bf16 backward's recompute of its layer inputs.
// Each row's gate is an f32 fmaf chain of exact products (x_l's bf16 values
// times w_l's, wl(j) the f32 value of w_l at the lane's column j) in column
// order j = 0, 1, ..., the R sums go over the warp together and are rounded once to
// bf16 (g2, the gate in both halves); then the update on pairs, each
// elementwise product and sum one mul.rn / add.rn.bf16x2, rounded once where
// the plain version rounds (bl(q): pair q of b_l in the lane's layout).
template <int NPL, int R, class W, class Bias>
__device__ __forceinline__ void layer_pairs(uint32_t (&x)[R][(NPL + 1) / 2],
                                            const uint32_t (&xin)[R][(NPL + 1) / 2], uint32_t (&g2)[R],
                                            W wl, Bias bl, int lane, int d, int canonical) {
  constexpr int P = (NPL + 1) / 2;
  float t[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    t[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NPL; ++j) {
      const int c = lane + 32 * j;
      const float xj = j % 2 ? hi_f(x[i][j / 2]) : lo_f(x[i][j / 2]);
      if (c < d) t[i] = fmaf(xj, wl(j), t[i]);
    }
  }
  warp_sums<R>(t);
#pragma unroll
  for (int i = 0; i < R; ++i) {
    g2[i] = pack2(t[i], t[i]);
#pragma unroll
    for (int q = 0; q < P; ++q) {
      const uint32_t b2 = bl(q);
      x[i][q] = canonical ? add2(add2(mul2(xin[i][q], g2[i]), b2), x[i][q])
                          : add2(add2(x[i][q], mul2(x[i][q], g2[i])), b2);
    }
  }
}

// bfloat16: R rows of the backward on bf16x2 pairs. The gates (f32 products
// of bf16 values, exact, in the forward's fmaf chain), the row sums (each
// product rounded to bf16, summed in f32 in column order j = 0, 1, ...) and
// dw, db (f32) add in the order the header describes; every elementwise
// product and sum is one mul2 / add2 for two columns.
template <int NPL, int LMAX, int R>
__device__ __forceinline__ void rows_bf16(const bf16* (&xr)[R], const bf16* (&dyr)[R], bf16* (&out)[R],
                                          const float* ws, const uint32_t* wp, const uint32_t* bp,
                                          int lane, int d, int L, int canonical,
                                          float (&dw_acc)[LMAX][NPL], float (&db_acc)[LMAX][NPL]) {
  constexpr int P = (NPL + 1) / 2;
  uint32_t xin[R][P], x[R][P], dx[R][P], dx0_acc[R][P], xs[R][LMAX][P], g2[R][LMAX];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    load_pairs<NPL>(xin[i], xr[i], lane, d);
    load_pairs<NPL>(dx[i], dyr[i], lane, d);
#pragma unroll
    for (int q = 0; q < P; ++q) {
      x[i][q] = xin[i][q];
      dx0_acc[i][q] = 0u;
    }
  }
#pragma unroll
  for (int l = 0; l < LMAX; ++l) {
    if (l < L) {
      uint32_t gl[R];
#pragma unroll
      for (int i = 0; i < R; ++i) {
#pragma unroll
        for (int q = 0; q < P; ++q) xs[i][l][q] = x[i][q];
      }
      const float* wl = ws + l * d;
      const uint32_t* bl = bp + l * kPairs * 32;
      layer_pairs<NPL, R>(
          x, xin, gl, [=](int j) { return wl[lane + 32 * j]; }, [=](int q) { return bl[q * 32 + lane]; }, lane,
          d, canonical);
#pragma unroll
      for (int i = 0; i < R; ++i) g2[i][l] = gl[i];
    }
  }
#pragma unroll
  for (int l = LMAX - 1; l >= 0; --l) {
    if (l < L) {
      float t[R];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        t[i] = 0.f;
#pragma unroll
        for (int q = 0; q < P; ++q) {
          const uint32_t p = mul2(dx[i][q], canonical ? xin[i][q] : xs[i][l][q]);
          t[i] = __fadd_rn(t[i], lo_f(p));
          if (2 * q + 1 < NPL) t[i] = __fadd_rn(t[i], hi_f(p));
        }
      }
      warp_sums<R>(t);
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const uint32_t s2 = pack2(t[i], t[i]);
        const float sl = lo_f(s2);
#pragma unroll
        for (int q = 0; q < P; ++q) {
          const int j = 2 * q;
          db_acc[l][j] += lo_f(dx[i][q]);
          dw_acc[l][j] = fmaf(sl, lo_f(xs[i][l][q]), dw_acc[l][j]);
          if (j + 1 < NPL) {
            db_acc[l][j + 1] += hi_f(dx[i][q]);
            dw_acc[l][j + 1] = fmaf(sl, hi_f(xs[i][l][q]), dw_acc[l][j + 1]);
          }
          const uint32_t sw = mul2(s2, wp[(l * kPairs + q) * 32 + lane]);
          if (canonical) {
            dx0_acc[i][q] = add2(dx0_acc[i][q], mul2(dx[i][q], g2[i][l]));
            dx[i][q] = add2(dx[i][q], sw);
          } else {
            dx[i][q] = add2(add2(dx[i][q], mul2(dx[i][q], g2[i][l])), sw);
          }
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
    if (canonical) {
#pragma unroll
      for (int q = 0; q < P; ++q) dx[i][q] = add2(dx[i][q], dx0_acc[i][q]);
    }
    store_pairs<NPL>(out[i], dx[i], lane, d);
  }
}

// The warp's rows r, r + 8, ..., r + 8 (R - 1) of the block's tile k: staged
// rows from the ring, the batch's last unstaged rows from global memory.
template <class T, int NPL, int LMAX, int R>
__device__ __forceinline__ void tile_rows(int r, int k, const TileRing<T>& ring, const Layout& s,
                                          const T* x0, const T* dy, T* dx0, int lane, int d, int L,
                                          int canonical, float (&dw_acc)[LMAX][NPL],
                                          float (&db_acc)[LMAX][NPL]) {
  const int r0 = ring.first_row(k), copied = ring.copied_rows(k);
  const T* xr[R];
  const T* dyr[R];
  T* out[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int rr = r + kWarps * i;
    const size_t row = r0 + rr;
    const bool staged = rr < copied;
    xr[i] = staged ? ring.tile(k, 0) + rr * d : x0 + row * d;
    dyr[i] = staged ? ring.tile(k, 1) + rr * d : dy + row * d;
    out[i] = dx0 + row * d;
  }
  if constexpr (std::is_same_v<T, bf16>) {
    rows_bf16<NPL, LMAX, R>(xr, dyr, out, s.ws, s.pairs, s.pairs + L * kPairs * 32, lane, d, L, canonical,
                            dw_acc, db_acc);
  } else {
    rows_f32<NPL, LMAX, R>(xr, dyr, out, s.ws, s.bs, lane, d, L, canonical, dw_acc, db_acc);
  }
}

// Writes dx0 for the block's rows; partial[c] gets cluster c's sums of
// dw | db ([2][L][d]), and the block that draws the last ticket on
// counters[0] sums the clusters' rows in order into dw, db. Up to d = 128
// two blocks fit on an SM (at most 128 registers a thread); wider rows need
// more registers than that. LMAX: the most layers the instance takes; CL:
// its blocks a cluster.
template <class T, int NPL, int LMAX, int CL>
__global__ void __cluster_dims__(CL, 1, 1) __launch_bounds__(kThreads, NPL <= 4 ? 2 : 1)
    cross_bwd_kernel(const T* __restrict__ x0, const T* __restrict__ w,
                     const T* __restrict__ b, const T* __restrict__ dy,
                     T* __restrict__ dx0, T* __restrict__ dw, T* __restrict__ db,
                     float* partial, unsigned int* counters, int B,
                     int d, int L, int canonical, int rows, int stages, long long x_stride) {
  extern __shared__ __align__(128) unsigned char smem[];
  // This block's trial (grid axis y): its rows, weights and gradients, and
  // its own cluster sums and ticket.
  const size_t weights_at = (size_t)blockIdx.y * L * d;
  x0 += blockIdx.y * x_stride;
  dy += blockIdx.y * x_stride;
  dx0 += blockIdx.y * x_stride;
  w += weights_at;
  b += weights_at;
  dw += weights_at;
  db += weights_at;
  partial += (size_t)blockIdx.y * (gridDim.x / CL) * 2 * L * d;
  counters += blockIdx.y;
  constexpr bool kBf16 = std::is_same_v<T, bf16>;
  const Layout s(smem, d, L, kBf16);
  const TileRing<T> ring{s.bars, reinterpret_cast<T*>(s.ring), B, d, rows, stages, 2};
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int mine = tiles_of_block(B, rows);
  start(ring, mine, x0, dy, w, b, s.ws, s.bs, L * d);
  if constexpr (kBf16) pack_weights(s.pairs, s.pairs + L * kPairs * 32, s.ws, s.bs, d, L);

  float dw_acc[LMAX][NPL], db_acc[LMAX][NPL];
#pragma unroll
  for (int l = 0; l < LMAX; ++l) {
#pragma unroll
    for (int j = 0; j < NPL; ++j) dw_acc[l][j] = db_acc[l][j] = 0.f;
  }

  constexpr int R = bwd_rows_at_once<NPL, LMAX>();
  for (int k = 0; k < mine; ++k) {
    ring.wait(k);
    const int n = ring.n_rows(k);
    // The warp's rows warp, warp + 8, ... of the tile: R at a time, then the
    // last ones one at a time, each row's sums after the rows' before it.
    int r = warp;
    if constexpr (R > 1) {
      for (; r + kWarps * (R - 1) < n; r += kWarps * R)
        tile_rows<T, NPL, LMAX, R>(r, k, ring, s, x0, dy, dx0, lane, d, L, canonical, dw_acc, db_acc);
    }
    for (; r < n; r += kWarps)
      tile_rows<T, NPL, LMAX, 1>(r, k, ring, s, x0, dy, dx0, lane, d, L, canonical, dw_acc, db_acc);
    finish_tile(ring, k, mine, x0, dy);
  }

  // The block's sums: each warp writes its own slot of the (now idle) ring,
  // then the warps are added in order 0 .. kWarps-1, into slot 0.
  __syncthreads();
  const int n = L * d, n2 = 2 * n;
  float* sums = reinterpret_cast<float*>(s.ring);
  float* own = sums + (size_t)warp * n2;
#pragma unroll
  for (int l = 0; l < LMAX; ++l) {
    if (l < L) {
      store_row<NPL>(own + (size_t)l * d, dw_acc[l], lane, d);
      store_row<NPL>(own + n + (size_t)l * d, db_acc[l], lane, d);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n2; i += kThreads) {
    float t = 0.f;
    for (int k = 0; k < kWarps; ++k) t += sums[(size_t)k * n2 + i];
    sums[i] = t;
  }

  // The cluster's sums: block `rank` adds the CL blocks' sums of its slice
  // of the columns, in rank order, through distributed shared memory, into
  // the cluster's row of partial.
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int slice = (n2 + CL - 1) / CL;
  const int c0 = static_cast<int>(cluster.block_rank()) * slice, c1 = min(n2, c0 + slice);
  float* row = partial + (size_t)(blockIdx.x / CL) * n2;
  for (int i = c0 + threadIdx.x; i < c1; i += kThreads) {
    float v[CL];
#pragma unroll
    for (int q = 0; q < CL; ++q) v[q] = cluster.map_shared_rank(sums, q)[i];
    float t = 0.f;
#pragma unroll
    for (int q = 0; q < CL; ++q) t += v[q];
    row[i] = t;
  }

  // The clusters' sum, in order, by the block that draws the last ticket.
  const bool last = last_to_arrive(counters, gridDim.x);
  cluster.sync();  // a block's sums stay until its peers have read them
  if (!last) return;
  ordered_sums(partial, n2, gridDim.x / CL, n2, [=](int i, float t) {
    if (i < n) {
      dw[i] = from_f<T>(t);
    } else {
      db[i - n] = from_f<T>(t);
    }
  });
}

// ---- the forward -----------------------------------------------------------

// Rows a warp of the forward walks at once: 2 where two rows' registers (x0
// and x_l of each, f32 values or bf16x2 pairs) and a layer's w and b (the
// lane's columns) fit 64 registers a thread (four blocks an SM) with 24 to
// spare for addresses, the gates and the loop; else 1.
template <class T, int NPL>
__host__ __device__ constexpr int fwd_rows_at_once() {
  constexpr bool kBf16 = std::is_same_v<T, bf16>;
  constexpr int pairs = (NPL + 1) / 2, per_row = 2 * (kBf16 ? pairs : NPL);
  constexpr int weights = kBf16 ? NPL + pairs : 2 * NPL;
  return 2 * per_row + weights + 24 <= 64 ? 2 : 1;
}

// float32: R rows of the forward, interleaved. Each layer's w and b (the
// lane's columns) come into registers once for the R rows; the R gates (fmaf
// chains) go over the warp together, then each row's update as layer_step
// makes it, so y does not depend on R. wl(l, j), bl(l, j): w_l, b_l at the
// lane's column j.
template <int NPL, int R, class W, class Bias>
__device__ __forceinline__ void fwd_rows_f32(const float* (&xr)[R], float* (&out)[R], W wl, Bias bl, int lane,
                                             int d, int L, int canonical) {
  float xin[R][NPL], x[R][NPL];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    load_row<NPL>(xin[i], xr[i], lane, d);
#pragma unroll
    for (int j = 0; j < NPL; ++j) x[i][j] = xin[i][j];
  }
#pragma unroll 1
  for (int l = 0; l < L; ++l) {
    float wr[NPL], br[NPL], t[R];
#pragma unroll
    for (int j = 0; j < NPL; ++j) {
      wr[j] = lane + 32 * j < d ? wl(l, j) : 0.f;
      br[j] = lane + 32 * j < d ? bl(l, j) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < R; ++i) t[i] = lane_dot<NPL>(x[i], [&](int j) { return wr[j]; }, lane, d);
    warp_sums<R>(t);
#pragma unroll
    for (int i = 0; i < R; ++i)
      layer_step<NPL>(x[i], xin[i], t[i], [&](int j) { return br[j]; }, lane, d, canonical);
  }
#pragma unroll
  for (int i = 0; i < R; ++i) store_row<NPL>(out[i], x[i], lane, d);
}

// bfloat16: R rows of the forward on bf16x2 pairs from load to store. Each
// layer's w (f32 values, exact) and b (pairs) come into registers once for
// the R rows. wl(l, j): w_l's f32 value at the lane's column j; bl(l, q):
// pair q of b_l in the lane's layout.
template <int NPL, int R, class W, class Bias>
__device__ __forceinline__ void fwd_rows_bf16(const bf16* (&xr)[R], bf16* (&out)[R], W wl, Bias bl, int lane,
                                              int d, int L, int canonical) {
  constexpr int P = (NPL + 1) / 2;
  uint32_t xin[R][P], x[R][P];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    load_pairs<NPL>(xin[i], xr[i], lane, d);
#pragma unroll
    for (int q = 0; q < P; ++q) x[i][q] = xin[i][q];
  }
#pragma unroll 1
  for (int l = 0; l < L; ++l) {
    float wr[NPL];
    uint32_t br[P], g2[R];
#pragma unroll
    for (int j = 0; j < NPL; ++j) wr[j] = lane + 32 * j < d ? wl(l, j) : 0.f;
#pragma unroll
    for (int q = 0; q < P; ++q) br[q] = bl(l, q);
    layer_pairs<NPL, R>(
        x, xin, g2, [&](int j) { return wr[j]; }, [&](int q) { return br[q]; }, lane, d, canonical);
  }
#pragma unroll
  for (int i = 0; i < R; ++i) store_pairs<NPL>(out[i], x[i], lane, d);
}

// Where a forward block's lanes read w and b: its shared memory (s: the f32
// copies, and b's pairs for bf16), or global memory through L1 (s null).
template <class T>
struct FwdWeights {
  const T* w;
  const T* b;
  const Layout* s;
};

// The warp's rows r, r + 8, ..., r + 8 (R - 1) of a tile of rows from row
// r0: its first `copied` rows from `staged` (the ring), the rest from x0.
template <class T, int NPL, int R, bool kShared>
__device__ __forceinline__ void fwd_tile_rows(int r, const T* staged, int copied, int r0,
                                              const T* __restrict__ x0, T* __restrict__ y,
                                              const FwdWeights<T>& wb, int lane, int d, int L, int canonical) {
  const T* xr[R];
  T* out[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int rr = r + kWarps * i;
    const size_t row = r0 + rr;
    xr[i] = rr < copied ? staged + rr * d : x0 + row * d;
    out[i] = y + row * d;
  }
  if constexpr (std::is_same_v<T, bf16>) {
    if constexpr (kShared) {
      const float* ws = wb.s->ws;
      const uint32_t* bp = wb.s->pairs + L * kPairs * 32;
      fwd_rows_bf16<NPL, R>(
          xr, out, [=](int l, int j) { return ws[l * d + lane + 32 * j]; },
          [=](int l, int q) { return bp[(l * kPairs + q) * 32 + lane]; }, lane, d, L, canonical);
    } else {
      const bf16* w = wb.w;
      const bf16* b = wb.b;
      fwd_rows_bf16<NPL, R>(
          xr, out, [=](int l, int j) { return to_f(w[l * d + lane + 32 * j]); },
          [=](int l, int q) { return pair_at<NPL>(b + l * d, q, lane, d); }, lane, d, L, canonical);
    }
  } else {
    const float* w = kShared ? wb.s->ws : wb.w;
    const float* b = kShared ? wb.s->bs : wb.b;
    fwd_rows_f32<NPL, R>(
        xr, out, [=](int l, int j) { return w[l * d + lane + 32 * j]; },
        [=](int l, int j) { return b[l * d + lane + 32 * j]; }, lane, d, L, canonical);
  }
}

// A tile's rows through the forward: the warp's rows warp, warp + 8, ... R
// at a time, then the last ones one at a time.
template <class T, int NPL, bool kShared>
__device__ __forceinline__ void fwd_tile(const T* staged, int copied, int r0, int n, const T* __restrict__ x0,
                                         T* __restrict__ y, const FwdWeights<T>& wb, int lane, int warp, int d,
                                         int L, int canonical) {
  constexpr int R = fwd_rows_at_once<T, NPL>();
  int r = warp;
  if constexpr (R > 1) {
    for (; r + kWarps * (R - 1) < n; r += kWarps * R)
      fwd_tile_rows<T, NPL, R, kShared>(r, staged, copied, r0, x0, y, wb, lane, d, L, canonical);
  }
  for (; r < n; r += kWarps) fwd_tile_rows<T, NPL, 1, kShared>(r, staged, copied, r0, x0, y, wb, lane, d, L, canonical);
}

// The forward through the ring: w and b into shared memory once a block,
// tiles by bulk copies. Four blocks an SM (64 registers a thread at most),
// as the plans take them.
template <class T, int NPL>
__global__ void __launch_bounds__(kThreads, 4)
    cross_fwd_kernel(const T* __restrict__ x0, const T* __restrict__ w,
                     const T* __restrict__ b, T* __restrict__ y, int B, int d, int L,
                     int canonical, int rows, int stages, long long x_stride) {
  extern __shared__ __align__(128) unsigned char smem[];
  // This block's trial (grid axis y): its rows and its weights.
  x0 += blockIdx.y * x_stride;
  y += blockIdx.y * x_stride;
  w += (size_t)blockIdx.y * L * d;
  b += (size_t)blockIdx.y * L * d;
  constexpr bool kBf16 = std::is_same_v<T, bf16>;
  const Layout s(smem, d, L, kBf16);
  const TileRing<T> ring{s.bars, reinterpret_cast<T*>(s.ring), B, d, rows, stages, 1};
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int mine = tiles_of_block(B, rows);
  start(ring, mine, x0, static_cast<const T*>(nullptr), w, b, s.ws, s.bs, L * d);
  if constexpr (kBf16) pack_weights(s.pairs, s.pairs + L * kPairs * 32, s.ws, s.bs, d, L);
  const FwdWeights<T> wb{w, b, &s};
  for (int k = 0; k < mine; ++k) {
    ring.wait(k);
    fwd_tile<T, NPL, true>(ring.tile(k, 0), ring.copied_rows(k), ring.first_row(k), ring.n_rows(k), x0, y, wb,
                           lane, warp, d, L, canonical);
    finish_tile(ring, k, mine, x0, static_cast<const T*>(nullptr));
  }
}

// The forward where every block has one tile of at most R rows a warp: the
// block reads its rows, w and b straight from global memory (w and b
// through L1, where the trial's blocks on an SM share them), with no shared
// memory, mbarrier or barrier, so its warps start on their rows at once.
template <class T, int NPL>
__global__ void __launch_bounds__(kThreads, 4)
    cross_fwd_direct_kernel(const T* __restrict__ x0, const T* __restrict__ w,
                            const T* __restrict__ b, T* __restrict__ y, int B, int d, int L,
                            int canonical, int rows, long long x_stride) {
  x0 += blockIdx.y * x_stride;
  y += blockIdx.y * x_stride;
  const FwdWeights<T> wb{w + (size_t)blockIdx.y * L * d, b + (size_t)blockIdx.y * L * d, nullptr};
  const int r0 = blockIdx.x * rows;
  fwd_tile<T, NPL, false>(nullptr, 0, r0, min(rows, B - r0), x0, y, wb, threadIdx.x & 31, threadIdx.x >> 5, d, L,
                          canonical);
}

bool valid_cluster(int cluster) {
  return cluster == kCluster || cluster == kSmallCluster;
}

bool valid_plan(int rows, int grid, int stages, int align) {
  return rows >= align && rows <= kMaxRows && rows % align == 0 && grid >= 1 && stages >= 1 &&
         stages <= kMaxStages && stages * rows <= kMaxRing;
}

template <class T, int NPL>
cudaError_t prepare_typed(int bytes) {
  const void* kernels[] = {
      reinterpret_cast<const void*>(cross_fwd_kernel<T, NPL>),
      reinterpret_cast<const void*>(cross_bwd_kernel<T, NPL, kFewLayers, kCluster>),
      reinterpret_cast<const void*>(cross_bwd_kernel<T, NPL, kMaxLayers, kCluster>),
      reinterpret_cast<const void*>(cross_bwd_kernel<T, NPL, kFewLayers, kSmallCluster>),
      reinterpret_cast<const void*>(cross_bwd_kernel<T, NPL, kMaxLayers, kSmallCluster>)};
  cudaError_t err = cudaSuccess;
  for (const void* k : kernels) {
    if ((err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes)) != cudaSuccess)
      break;
  }
  return err;
}

template <int NPL>
cudaError_t prepare_instance(int bytes) {
  const cudaError_t err = prepare_typed<float, NPL>(bytes);
  return err != cudaSuccess ? err : prepare_typed<bf16, NPL>(bytes);
}

// Blocks of the backward the card runs at once, in whole clusters of CL
// blocks (the instance's compile-time cluster size), for its instance of the
// most layers (the other takes as many registers or fewer under the same
// launch bounds).
template <class T, int NPL, int CL>
cudaError_t bwd_capacity(size_t smem, int* n) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CL);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  int clusters = 0;
  const cudaError_t err =
      cudaOccupancyMaxActiveClusters(&clusters, cross_bwd_kernel<T, NPL, kMaxLayers, CL>, &cfg);
  *n = clusters * CL;
  return err;
}

// Blocks of the forward the card runs at once: blocks an SM times SMs.
template <class T, int NPL>
cudaError_t fwd_capacity(size_t smem, int* n) {
  int per_sm = 0, device = 0, sms = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, cross_fwd_kernel<T, NPL>, kThreads, smem);
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  *n = per_sm * sms;
  return err;
}

// The direct kernel where the plan gives every block one tile of at most R
// rows a warp, else the ring's.
template <class T, int NPL>
cudaError_t launch_fwd(const T* x0, const T* w, const T* b, T* y, int K, long long x_stride, int B,
                       int d, int L, int canonical, int rows, int grid, int stages,
                       cudaStream_t stream) {
  const int tiles = (B + rows - 1) / rows;
  if (tiles <= grid && rows <= kWarps * fwd_rows_at_once<T, NPL>()) {
    cross_fwd_direct_kernel<T, NPL>
        <<<dim3(tiles, K), kThreads, 0, stream>>>(x0, w, b, y, B, d, L, canonical, rows, x_stride);
  } else {
    cross_fwd_kernel<T, NPL>
        <<<dim3(grid, K), kThreads, smem_bytes(rows, stages, d, L, false, sizeof(T)), stream>>>(
            x0, w, b, y, B, d, L, canonical, rows, stages, x_stride);
  }
  return cudaGetLastError();
}

template <class T, int NPL, int CL>
void launch_bwd_cluster(const T* x0, const T* w, const T* b, const T* dy, T* dx0, T* dw, T* db,
                        float* partial, unsigned int* counters, int K, long long x_stride, int B,
                        int d, int L, int canonical, int rows, int grid, int stages,
                        cudaStream_t stream) {
  const dim3 blocks(grid, K);
  const size_t smem = smem_bytes(rows, stages, d, L, true, sizeof(T));
  if (L <= kFewLayers) {
    cross_bwd_kernel<T, NPL, kFewLayers, CL><<<blocks, kThreads, smem, stream>>>(
        x0, w, b, dy, dx0, dw, db, partial, counters, B, d, L, canonical, rows, stages, x_stride);
  } else {
    cross_bwd_kernel<T, NPL, kMaxLayers, CL><<<blocks, kThreads, smem, stream>>>(
        x0, w, b, dy, dx0, dw, db, partial, counters, B, d, L, canonical, rows, stages, x_stride);
  }
}

template <class T, int NPL>
cudaError_t launch_bwd(const T* x0, const T* w, const T* b, const T* dy, T* dx0, T* dw, T* db,
                       float* partial, unsigned int* counters, int K, long long x_stride, int B,
                       int d, int L, int canonical, int rows, int grid, int stages, int cluster,
                       cudaStream_t stream) {
  if (cluster == kCluster) {
    launch_bwd_cluster<T, NPL, kCluster>(x0, w, b, dy, dx0, dw, db, partial, counters, K, x_stride,
                                         B, d, L, canonical, rows, grid, stages, stream);
  } else {
    launch_bwd_cluster<T, NPL, kSmallCluster>(x0, w, b, dy, dx0, dw, db, partial, counters, K,
                                              x_stride, B, d, L, canonical, rows, grid, stages,
                                              stream);
  }
  return cudaGetLastError();
}

#define HHRS_CROSS_DISPATCH(CALL)                      \
  switch ((d + 31) / 32) {                             \
    case 1: return static_cast<int>(CALL(1));          \
    case 2: return static_cast<int>(CALL(2));          \
    case 3: return static_cast<int>(CALL(3));          \
    case 4: return static_cast<int>(CALL(4));          \
    case 5: return static_cast<int>(CALL(5));          \
    case 6: return static_cast<int>(CALL(6));          \
    case 7: return static_cast<int>(CALL(7));          \
    case 8: return static_cast<int>(CALL(8));          \
    default: return static_cast<int>(cudaErrorInvalidValue); \
  }

template <class T>
int capacity_typed(int d, bool backward, int cluster, int* n) {
  const size_t smem = smem_bytes(backward ? kMaxRing : kFwdRing, 1, d, kMaxLayers, backward, sizeof(T));
#define HHRS_CAPACITY(NPL)                                                                 \
  (!backward                ? fwd_capacity<T, NPL>(smem, n)                                 \
   : cluster == kCluster ? bwd_capacity<T, NPL, kCluster>(smem, n)                       \
                            : bwd_capacity<T, NPL, kSmallCluster>(smem, n))
  HHRS_CROSS_DISPATCH(HHRS_CAPACITY)
#undef HHRS_CAPACITY
}

template <class T>
int fwd_typed(const void* x0, const void* w, const void* b, void* y, int K, long long x_stride,
              int B, int d, int L, int canonical, int rows, int grid, int stages, cudaStream_t s) {
#define HHRS_FWD(NPL)                                                                      \
  launch_fwd<T, NPL>(static_cast<const T*>(x0), static_cast<const T*>(w),                  \
                     static_cast<const T*>(b), static_cast<T*>(y), K, x_stride, B, d, L,    \
                     canonical, rows, grid, stages, s)
  HHRS_CROSS_DISPATCH(HHRS_FWD)
#undef HHRS_FWD
}

template <class T>
int bwd_typed(const void* x0, const void* w, const void* b, const void* dy, void* dx0, void* dw,
              void* db, void* partial, void* counters, int K, long long x_stride, int B, int d,
              int L, int canonical, int rows, int grid, int stages, int cluster, cudaStream_t s) {
#define HHRS_BWD(NPL)                                                                          \
  launch_bwd<T, NPL>(static_cast<const T*>(x0), static_cast<const T*>(w),                      \
                     static_cast<const T*>(b), static_cast<const T*>(dy), static_cast<T*>(dx0), \
                     static_cast<T*>(dw), static_cast<T*>(db), static_cast<float*>(partial),    \
                     static_cast<unsigned int*>(counters), K, x_stride, B, d, L, canonical,     \
                     rows, grid, stages, cluster, s)
  HHRS_CROSS_DISPATCH(HHRS_BWD)
#undef HHRS_BWD
}

}  // namespace

extern "C" {

int hhrs_cross_max_dim() { return 32 * kMaxPerLane; }
int hhrs_cross_max_layers() { return kMaxLayers; }

const char* hhrs_cross_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Once per device, before the first launch there: lets every kernel take the
// shared memory of the largest plan (96 rows in flight, d 256, 6 layers).
int hhrs_cross_prepare() {
  const int bytes =
      static_cast<int>(smem_bytes(kMaxRing, 1, 32 * kMaxPerLane, kMaxLayers, true, sizeof(float)));
  cudaError_t (*const instances[])(int) = {prepare_instance<1>, prepare_instance<2>,
                                           prepare_instance<3>, prepare_instance<4>,
                                           prepare_instance<5>, prepare_instance<6>,
                                           prepare_instance<7>, prepare_instance<8>};
  cudaError_t err = cudaSuccess;
  for (auto f : instances) {
    if ((err = f(bytes)) != cudaSuccess) break;
  }
  return static_cast<int>(err);
}

// Blocks of the forward or the backward for rows of width d (1 <= d <= 256)
// and the element type (is_bf16 != 0: bfloat16, else float32) that the current
// device runs at once (the backward in whole clusters of `cluster` blocks, 8
// or 2), at the shared memory of the largest plan (6 layers; 96 rows in
// flight, the forward's plans 64), so that every plan's grid fits; a
// negative CUDA error code on failure. Call after hhrs_cross_prepare.
int hhrs_cross_capacity(int d, int backward, int is_bf16, int cluster) {
  if (backward && !valid_cluster(cluster)) return -static_cast<int>(cudaErrorInvalidValue);
  int n = 0;
  const int err = is_bf16 ? capacity_typed<bf16>(d, backward != 0, cluster, &n)
                          : capacity_typed<float>(d, backward != 0, cluster, &n);
  return err != 0 ? -err : n;
}

// Launches on `stream` and returns cudaGetLastError() (0 on success). All
// pointers are device pointers to contiguous arrays of one element type,
// bfloat16 when is_bf16 != 0, else float32: x0, y [B, d] (16-byte aligned), w,
// b [L, d]. Needs 1 <= d <= 256, 0 <= L <= 6 and a plan: rows per tile a
// multiple of 4 (float32) or 8 (bfloat16) in [4, 48], 1 <= stages <= 3 with
// stages x rows <= 96, grid >= 1.
//
// The trial axis (the *_trials entry points): K >= 1 trials of the same B, d,
// L in one launch of K grids of the plan, the arrays stacked: trial k's rows
// of x0, y at k * x_stride elements (x_stride >= B * d, a multiple of 16
// bytes), w, b [K, L, d] contiguous. Trial k's y is the single-trial launch's
// on its rows; hhrs_cross_fwd is the launch with K = 1.
int hhrs_cross_fwd_trials(const void* x0, const void* w, const void* b, void* y, int K,
                          long long x_stride, int B, int d, int L, int canonical, int rows,
                          int grid, int stages, int is_bf16, void* stream) {
  if (B <= 0 || K == 0) return 0;
  const int align = is_bf16 ? kRowAlign<bf16> : kRowAlign<float>;
  const size_t elem = is_bf16 ? sizeof(bf16) : sizeof(float);
  if (L < 0 || L > kMaxLayers || !valid_plan(rows, grid, stages, align) || K < 0 || K > 65535 ||
      (K > 1 && (x_stride < (long long)B * d || x_stride * elem % 16 != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? fwd_typed<bf16>(x0, w, b, y, K, x_stride, B, d, L, canonical, rows, grid, stages, s)
                 : fwd_typed<float>(x0, w, b, y, K, x_stride, B, d, L, canonical, rows, grid, stages, s);
}

int hhrs_cross_fwd(const void* x0, const void* w, const void* b, void* y, int B, int d, int L,
                   int canonical, int rows, int grid, int stages, int is_bf16, void* stream) {
  return hhrs_cross_fwd_trials(x0, w, b, y, 1, 0, B, d, L, canonical, rows, grid, stages, is_bf16,
                               stream);
}

// dy, dx0 [B, d] (16-byte aligned); dw, db [L, d], all of the element type;
// partial [grid / cluster, 2, L, d] float32 and one unsigned int counter, 0
// before the first launch (each launch leaves it at 0). The grid is a
// multiple of the cluster size (8 or 2 blocks that sum on chip). One launch.
// With the trial axis: dy, dx0 laid out as x0, dw, db [K, L, d], partial [K,
// grid / cluster, 2, L, d] and K counters; trial k's dx0, dw and db are the
// single-trial launch's on its inputs under the same plan.
int hhrs_cross_bwd_trials(const void* x0, const void* w, const void* b, const void* dy,
                          void* dx0, void* dw, void* db, void* partial, void* counters, int K,
                          long long x_stride, int B, int d, int L, int canonical, int rows,
                          int grid, int stages, int cluster, int is_bf16, void* stream) {
  const int align = is_bf16 ? kRowAlign<bf16> : kRowAlign<float>;
  const size_t elem = is_bf16 ? sizeof(bf16) : sizeof(float);
  if (B <= 0 || L <= 0 || L > kMaxLayers || !valid_plan(rows, grid, stages, align) ||
      !valid_cluster(cluster) || grid % cluster != 0 || K < 1 || K > 65535 ||
      (K > 1 && (x_stride < (long long)B * d || x_stride * elem % 16 != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? bwd_typed<bf16>(x0, w, b, dy, dx0, dw, db, partial, counters, K, x_stride, B,
                                   d, L, canonical, rows, grid, stages, cluster, s)
                 : bwd_typed<float>(x0, w, b, dy, dx0, dw, db, partial, counters, K, x_stride, B,
                                    d, L, canonical, rows, grid, stages, cluster, s);
}

int hhrs_cross_bwd(const void* x0, const void* w, const void* b, const void* dy, void* dx0,
                   void* dw, void* db, void* partial, void* counters, int B, int d, int L,
                   int canonical, int rows, int grid, int stages, int cluster, int is_bf16,
                   void* stream) {
  return hhrs_cross_bwd_trials(x0, w, b, dy, dx0, dw, db, partial, counters, 1, 0, B, d, L,
                               canonical, rows, grid, stages, cluster, is_bf16, stream);
}

}  // extern "C"
