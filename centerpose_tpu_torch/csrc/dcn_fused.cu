// Modulated deformable convolution v2 (DCNv2) forward for Hopper: the
// om-fused forward (K1) and the forward from explicit offsets (K2).
//
// K1 replaces the TPU kernels of centerpose_tpu/ops/dcn_pallas.py that
// dcn_v2_pallas_fused dispatches to: _dcn_pallas_fwd_fom_impl (row-major,
// W = 128; kernel body _dcn_kernel_fom) and _dcn_pallas_grouped_fom_impl
// (row-grouped, W in {16, 32, 64}; kernel body _dcn_grouped_kernel_fom).
// K2 replaces those dcn_v2_pallas dispatches to, the training forward:
// _dcn_pallas_fwd_impl (W = 128; _dcn_kernel) and _dcn_pallas_grouped_impl
// (W in {16, 32, 64}; _dcn_grouped_kernel).  K1 computes
//
//   om   = conv3x3(x; omw[3,3,Cin,27]) + omb            (offset/mask conv)
//   dy_k = clip(om[2k], -R, R), dx_k = om[2k+1], m_k = sigmoid(om[18+k])
//   y    = bias + sum_k W_k^T . m_k . bilinear(x, p + p_k + (dy_k, dx_k))
//
// and K2 the last line given offset [B,H,W,18] (dy, dx per tap) and the
// sigmoid-ed mask [B,H,W,9].  Every bilinear corner outside the image
// contributes zero; R < 0 means "no clamp".  Each sample is summed over
// its four corners in f32, in corner order, and rounded once to the input
// type (the reference's im2col column; the backward's pass A rebuilds it
// with the same expression from the same tap_geo); products accumulate in
// f32 and the f32 bias is added before the output's rounding.  K1 also
// writes om [B,H,W,27] in f32 (raw offsets, then the sigmoid-ed mask) for
// its backward.  The TPU layouts (row grouping, lane one-hots, the slab
// DMA) existed only to fit VMEM and the 128-lane vector unit; none of them
// is carried over.
//
// What bounds it on an H100.  One batch-8 forward of dla_34 @512 does
// 113.5 GFLOP of main product (0.115 ms at the 989 TFLOP/s bf16 rate) and
// about a third more in the om conv; its HBM bytes are small (~41 MB, 0.012
// ms, at 64->64 @128).  The real floor at the Cin <= 128 sites is the
// gather: 4 corners x 9 taps x Cin x 2 bytes per pixel (~600 MB per call
// at 64->64 @128, batch 8), scattered 128-byte rows served by L2 and L1.
// On the card the gather's request rate, not its latency, is what the
// kernel runs into (chip_smoke.py prints each call's gathered bytes beside
// its time).
//
// bfloat16 (dcn_gemm_wgmma; the main path), one launch per K1 or K2 call:
//   * A block owns one 64-pixel tile and all of Cout (N = Cout padded to
//     64k, k <= 4): each sample is gathered once, whatever Cout is.  The
//     product runs as 64-column sub-tiles of wgmma m64n64k16 (the
//     instruction the backward already uses) on one A stage.
//   * Warp specialisation.  Warpgroup 1 produces: per (tap, 64-channel
//     chunk) it computes the tile's corner table once per tap (indices and
//     weights in shared memory), gathers the four corner rows of each pixel
//     with 16-byte loads (8 lanes read one pixel's 128-byte row: one L2
//     request per row; 16 loads in flight a lane), weights and sums them in
//     f32, rounds to bf16 and stores the samples in wgmma's packed K-major
//     layout; the weight chunk [64 x N] arrives in the same stage by
//     cp.async and is read by wgmma as an MN-major B (no transpose).
//     Warpgroup 0 consumes: wgmma on each stage as it fills, one group in
//     flight.  A ring of 2-4 stages with full/empty mbarriers lets the
//     gather of chunk i+1 run under the product of chunk i.  Cin % 8 != 0
//     (or an unaligned x) takes a scalar-load variant in the same kernel.
//   * The om conv is the same machinery: integer taps, one corner, weight
//     1, so its A stages are plain copies (cp.async with zero fill, issued
//     up to two items ahead), its B the omw rows [64 x 32] (27 columns
//     padded; the rows arrive by cp.async into small slots and are packed
//     by the producers), wgmma m64n32k16.  It is the first phase of the
//     block: the om tile stays in shared memory as f32 for the product
//     phase and is written once to device memory for the backward.
//   * Sites with few tiles (fewer than fill the SMs) split the 9*Cin
//     reduction: the `split` blocks of a tile form a thread-block cluster,
//     each takes a contiguous range of the (tap, chunk) sequence for both
//     the om conv and the product, and the partials are summed through
//     distributed shared memory in rank order (every rank sums the om
//     partials alike; rank r sums rows r*64/split .. of the output).  So
//     a call stays one launch, there are no float atomics, and two calls on
//     the same inputs give the same bits.  The launch plan (split, stages,
//     shared memory) is computed from the shapes in Python
//     (ops/dcn_cuda.forward_plan) and checked here.
//   Choices, and why.  M = 64 with one consumer warpgroup keeps two blocks
//   per SM where N <= 128, where most of the time goes.  The gather goes
//   through registers with L1-cached loads: variants that copied the corner
//   rows by cp.async into staging slots several items ahead (one block per
//   SM, dedicated loader warps) were slower in development runs on the
//   card (their copies bypass L1, and the staging leaves one block per
//   SM); TMA cannot express the gather.  8 lanes per row halve the L2
//   requests of 8 pixels per quarter-warp; the price, an 8-way bank
//   conflict on one 16-byte store per sample group, is small beside it.
//   The om phase costs more than its one-corner gather suggests; giving
//   its copies to separate loader warps, so that the threads that fence
//   (fence.proxy.async waits for a thread's copies in flight) have none,
//   did not make it faster.
//
// float32 (dcn_gemm_f32), one launch per K1 or K2 call, the same frame
// with the products on the CUDA cores (full f32 FMA: a single TF32 pass
// would not keep float32's accuracy):
//   * A block owns one 64-pixel tile and up to 256 columns (N = Cout
//     padded to 64k, k <= 4; a wider Cout takes column tiles, grid.y, each
//     gathering the tile again).  A chunk is (tap, 32 channels): one
//     128-byte row per corner, read by 8 producer lanes with 16-byte loads
//     (4 channels a lane; twice bf16's requests per channel), so each
//     sample is still gathered once per column tile.
//   * Warp specialisation as in bf16: warpgroup 1 builds the tap's corner
//     table (tap_geo), gathers, sums the four corners in f32 in corner
//     order times the mask (the expression pass A of the backward
//     rebuilds) and stores the samples pixel-major, A [64 px][32 ch] with a
//     row stride of 36 floats; the weight rows B [32 ch][N] arrive in the
//     same stage by cp.async, tracked by the stage's full mbarrier
//     (cp.async.mbarrier.arrive), so a producer never waits for its own
//     copies.  Warpgroup 0 consumes: each thread owns 8 pixels x 4 columns
//     of each 64-column sub-tile (8 x 4N/64 outputs, up to 8 x 16) in
//     registers and runs FFMA from float4 reads of A and B.  A ring of 2-4
//     stages with full/empty mbarriers overlaps the gather of chunk i+1
//     with the product of chunk i.
//   * K1's om conv is the block's first phase on the same ring: x at the
//     integer tap and the omw rows [32][27] as they lie in memory, both by
//     cp.async (an item's copies complete its stage's barrier), 4 x 4
//     outputs a consumer thread; om stays in shared memory as f32 for the
//     product and is written once for the backward.
//   * Small sites split the 9*Cin reduction over a cluster of at most 8
//     blocks, partials summed through distributed shared memory in rank
//     order, as in bf16: no float atomics, the same bits on every call.
//     ops/dcn_cuda.forward_plan gives tile, split, stages and shared
//     memory; check_plan_f32 checks them.
//   Why FFMA and not 3xTF32 on wgmma: the f32 products are 67 TFLOP/s of
//   FMA against the gather's requests, twice bf16's per sample; the
//   tensor-core route (three TF32 products a step) is taken only if the
//   card shows the FMA, not the gather, setting the time.
//
// Layouts follow the JAX op: x NHWC [B,H,W,Cin], weight [3,3,Cin,Cout]
// (= row-major [9*Cin, Cout]), omw [3,3,Cin,27], y NHWC [B,H,W,Cout].
// Element types: float or bf16 for x, weights and y (all one type); the
// bias and om are always f32.  Entry points return cudaGetLastError() or
// the launch's error.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "dcn_hopper.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kOm = 27;          // offset/mask channels: 18 offsets + 9 mask

// om[p, 0:18] = offsets, om[p, 18:27] = sigmoid(mask logits), p = pixel.
__device__ __forceinline__ float om_out(int o, float v) {
  return o >= 18 ? 1.f / (1.f + expf(-v)) : v;
}

// ---------------------------------------------------------------------------
// Beside the shared helpers: zero-filling cp.async, a 32-wide wgmma, wgmma's
// fence, commit and wait, mbarriers.
// ---------------------------------------------------------------------------

// 16 bytes from global to shared memory, or 16 zero bytes where n == 0 (g
// must still be a valid address); the caller commits and waits
__device__ __forceinline__ void cp_async16_zfill(void* s, const void* g,
                                                 int n) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(s);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(a),
               "l"(g), "r"(n)
               : "memory");
}

// D [64 x 32] += A . B over one k16 step (accumulator layout as above,
// v < 16); TA, TB as wgmma_tile's
template <int TA, int TB>
__device__ __forceinline__ void wgmma_n32(float (&d)[16], uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, %16, %17, p, 1, 1, %19, %20;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N of this warpgroup's committed groups are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(uint64_t* b, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(b)),
               "r"(count)
               : "memory");
}
// the inits visible to every thread (and to the async proxy) before use
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* b) {
  uint64_t state;
  asm volatile("mbarrier.arrive.shared::cta.b64 %0, [%1];\n"
               : "=l"(state)
               : "r"(smem_u32(b))
               : "memory");
  (void)state;
}
// wait until the phase of parity `parity` of b has completed
__device__ __forceinline__ void mbar_wait(uint64_t* b, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(b)), "r"(parity)
        : "memory");
  } while (!done);
}

// ---------------------------------------------------------------------------
// bfloat16: one block per 64-pixel tile and all of Cout (see the note).
// ---------------------------------------------------------------------------

constexpr int kTM = 64;         // pixels per tile: the wgmma M
constexpr int kKC = 64;         // input channels per chunk: one stage's K
constexpr int kWThreads = 256;  // warpgroup 0 consumes, warpgroup 1 produces
constexpr int kProd = 128;      // producer threads (warpgroup 1)
constexpr int kOmN = 32;        // om columns: 27 padded to a wgmma N
constexpr int kMaxSplit = 8;    // blocks of one cluster (the portable limit)
constexpr int kOmRaw = kKC * kOm * 2;  // an om item's omw rows (bytes)
constexpr int kOmSlots = 3;     // om items whose omw rows are in flight

// Shared memory of a block, in bytes from the dynamic base (the host's plan
// computes the same; the entry point checks the total).  A ring of
// `stages` stages, each an A tile [64 px x 64 ch] and a B tile [64 ch x kp]
// (packed bf16); the full and empty mbarriers; two corner tables [4][64]
// (element offsets, then weights); the om tile [64][27] f32 (offsets and
// sigmoid-ed mask: K1 computes it, K2 loads it); the om partial [64][32]
// f32; three slots for om items' omw rows [64][27] bf16 as they arrive.
// After the product a split block's f32 partial [64][kp + 4] reuses the
// ring.
struct FwdLayout {
  int b_off, stage, bars, tab, om, omp, omraw, bytes;
  __host__ __device__ FwdLayout(int kp, int stages) {
    b_off = kTM * kKC * 2;
    stage = b_off + kKC * kp * 2;
    bars = stages * stage;
    tab = bars + align128(16 * stages);
    om = tab + 2 * 4 * kTM * (8 + 4);
    omp = om + kTM * kOm * 4;
    omraw = omp + kTM * kOmN * 4;
    bytes = omraw + kOmSlots * kOmRaw;
  }
};

// the producers' own barrier (named barrier 1, warpgroup 1)
__device__ __forceinline__ void producer_sync() {
  asm volatile("bar.sync 1, 128;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// p in the shared memory of cluster rank r (p itself without a cluster)
__device__ __forceinline__ float* rank_smem(float* p, int r, int split) {
  return split > 1 ? cg::this_cluster().map_shared_rank(p, r) : p;
}

__device__ __forceinline__ void cluster_or_block_sync(int split) {
  if (split > 1)
    cg::this_cluster().sync();
  else
    __syncthreads();
}

// Grid: split * tiles blocks; block b takes tile b / split and cluster rank
// b % split, which owns the (tap, chunk) items [rank * nck / split,
// (rank + 1) * nck / split) of the sequence j -> tap j / nslice, channels
// (j % nslice) * 64 .. + 63.  FUSED: K1 (om computed here from x, omw,
// omb and written to om); else K2 (offsets and mask read from off, msk).
template <int NT, bool FUSED>
__global__ void __launch_bounds__(kWThreads, NT <= 2 ? 2 : 1)
dcn_gemm_wgmma(const __nv_bfloat16* __restrict__ x,
               const __nv_bfloat16* __restrict__ omw,
               const __nv_bfloat16* __restrict__ omb,
               const __nv_bfloat16* __restrict__ off,
               const __nv_bfloat16* __restrict__ msk,
               const __nv_bfloat16* __restrict__ wt,
               const float* __restrict__ bias, float* __restrict__ om,
               __nv_bfloat16* __restrict__ y, int B, int H, int W, int Cin,
               int Cout, float max_dy, int split, int stages) {
  using bf16 = __nv_bfloat16;
  constexpr int kp = NT * 64;  // N: Cout padded
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float s_omb[kOm];  // K1: the om bias, once
  const FwdLayout L(kp, stages);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bars);
  uint64_t* empty = full + stages;
  long long* tab_idx = reinterpret_cast<long long*>(smem + L.tab);
  float* tab_w = reinterpret_cast<float*>(smem + L.tab + 2 * 4 * kTM * 8);
  float* omt = reinterpret_cast<float*>(smem + L.om);
  float* omp = reinterpret_cast<float*>(smem + L.omp);
  auto stage_a = [&](int s) {
    return reinterpret_cast<bf16*>(smem + s * L.stage);
  };
  auto stage_b = [&](int s) {
    return reinterpret_cast<bf16*>(smem + s * L.stage + L.b_off);
  };

  const int tid = threadIdx.x;
  const int npix = B * H * W;
  const int rank = blockIdx.x % split;
  const int m0 = (blockIdx.x / split) * kTM;
  const int nslice = cdiv(Cin, kKC);
  const int nck = 9 * nslice;
  const int j0 = rank * nck / split, j1 = (rank + 1) * nck / split;
  const bool vec =
      (Cin & 7) == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  const bool wvec =
      (Cout & 7) == 0 && (reinterpret_cast<uintptr_t>(wt) & 15) == 0;
  const bf16 zero = __float2bfloat16(0.f);
  const bool producer = tid >= kWThreads - kProd;
  const int pt = tid - (kWThreads - kProd);  // producer thread
  const int lane = tid & 31, pw = pt >> 5;
  // a producer lane: pixels 4 pw + pq + 16 i (i < 4) of the tile, channels
  // 8 g .. 8 g + 7 of the chunk: 8 lanes read one pixel's corner row, all
  // 128 bytes of the chunk (one L2 request per row)
  const int pq = lane >> 3, g = lane & 7;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + s, kProd);
      mbar_init(empty + s, kWThreads - kProd);
    }
    mbar_init_fence();
  }
  if constexpr (FUSED) {
    if (tid < kOm) s_omb[tid] = to_f(omb[tid]);
  } else {  // K2: the tile's offsets and mask, as f32
    for (int e = tid; e < kTM * kOm; e += kWThreads) {
      const int p = e / kOm, o = e - p * kOm, m = m0 + p;
      float v = 0.f;
      if (m < npix)
        v = to_f(o < 18 ? off[(long long)m * 18 + o]
                        : msk[(long long)m * 9 + o - 18]);
      omt[e] = v;
    }
  }
  __syncthreads();

  // the ring: items go through it in one order for both roles; item i
  // uses stage i % stages in phase i / stages
  int it = 0;        // consumer: items taken
  int issued = 0;    // producer: stages acquired
  int pending = -1;  // consumer: the stage of the product in flight
  auto acquire = [&]() {  // producer: the next stage, once empty
    const int s = issued % stages;
    mbar_wait(empty + s, ((issued / stages) & 1) ^ 1);
    ++issued;
    return s;
  };
  auto publish = [&](int s) {  // producer: this thread's part is written
    fence_async_smem();
    mbar_arrive(full + s);
  };
  auto take = [&]() {  // consumer: the next stage, once full
    const int s = it % stages;
    mbar_wait(full + s, (it / stages) & 1);
    __syncwarp();
    return s;
  };
  auto retire = [&](int s) {  // consumer, after wgmma_wait<1>: the product
    if (pending >= 0) mbar_arrive(empty + pending);  // before s is done
    pending = s;
    ++it;
  };
  auto retire_all = [&]() {  // consumer, after wgmma_wait<0>
    if (pending >= 0) mbar_arrive(empty + pending);
    pending = -1;
  };

  if constexpr (FUSED) {
    // --- phase 1: the om conv, its partial over this rank's items ---------
    if (producer) {
      // items in flight ahead of the one published: each thread's copies
      // of item j are waited for `depth` items later (the ring holds the
      // item being published, those in flight and the consumer's two)
      const int depth = min(2, stages - 2);
      const bool ovec =
          vec && (reinterpret_cast<uintptr_t>(omw) & 15) == 0;
      int pb[4], py[4], px[4];
      bool pin[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int m = m0 + pw * 4 + pq + 16 * i;
        const int t = m / W;
        pin[i] = m < npix;
        px[i] = m - t * W;
        py[i] = t % H;
        pb[i] = t / H;
      }
      auto om_slot = [&](int j) {
        return reinterpret_cast<bf16*>(smem + L.omraw +
                                       ((j - j0) % kOmSlots) * kOmRaw);
      };
      // issue item j: A = x at the integer tap (zero outside the image and
      // past Cin) into the item's stage, its omw rows (contiguous [rows]
      // [27]) into an om slot, all by cp.async
      auto om_issue = [&](int j) {
        const int k = j / nslice, c0 = (j - k * nslice) * kKC;
        bf16* A = stage_a(acquire());
        const int c = c0 + 8 * g;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int p = pw * 4 + pq + 16 * i;
          const int sy = py[i] + k / 3 - 1, sx = px[i] + k % 3 - 1;
          const bool in =
              pin[i] && sy >= 0 && sy < H && sx >= 0 && sx < W;
          const long long row =
              in ? (((long long)pb[i] * H + sy) * W + sx) * Cin : 0;
          bf16* d = A + pack_off<bf16>(p, 8 * g, kKC);
          if (vec) {
            const bool ok = in && c < Cin;
            cp_async16_zfill(d, ok ? x + row + c : x, ok ? 16 : 0);
          } else {
#pragma unroll
            for (int e = 0; e < 8; ++e)
              d[e] = (in && c + e < Cin) ? x[row + c + e] : zero;
          }
        }
        const int rows = min(kKC, Cin - c0);
        const bf16* src = omw + ((long long)k * Cin + c0) * kOm;
        bf16* raw = om_slot(j);
        if (ovec) {  // rows * 54 bytes: a multiple of 16 (Cin % 8 == 0)
          for (int e = pt; e < rows * kOm / 8; e += kProd)
            cp_async16(raw + 8 * e, src + 8 * e);
        } else {
          for (int e = pt; e < rows * kOm; e += kProd) raw[e] = src[e];
        }
        cp_async_commit();
      };
      // publish item j: its omw rows into the stage's B [64 x 32] (zero
      // past Cin and in the padding columns)
      auto om_publish = [&](int j) {
        const int c0 = (j % nslice) * kKC;
        const int s = (j - j0) % stages;  // the om items come first
        if (depth >= 2)
          cp_async_wait_group<2>();
        else if (depth == 1)
          cp_async_wait_group<1>();
        else
          cp_async_wait_group<0>();
        producer_sync();  // every thread's rows have landed
        const bf16* raw = om_slot(j);
        bf16* Bt = stage_b(s);
        for (int e = pt; e < kKC * (kOmN / 8); e += kProd) {
          // row kk, columns n .. n + 7: one 16-byte store
          const int kk = e / (kOmN / 8), n = (e % (kOmN / 8)) * 8;
          const bool in = c0 + kk < Cin;
          union {
            uint4 u;
            bf16 h[8];
          } pk;
#pragma unroll
          for (int i = 0; i < 8; ++i)
            pk.h[i] = (in && n + i < kOm) ? raw[kk * kOm + n + i] : zero;
          *reinterpret_cast<uint4*>(Bt + pack_off<bf16>(kk, n, kOmN)) = pk.u;
        }
        producer_sync();  // the slot is read before it is refilled
        publish(s);
      };
      // one cp.async group per item, empty past the last: the group of
      // item j is complete once at most `depth` newer ones are pending
      for (int j = j0; j < j0 + depth; ++j) {
        if (j < j1)
          om_issue(j);
        else
          cp_async_commit();
      }
      for (int j = j0; j < j1; ++j) {
        if (j + depth < j1)
          om_issue(j + depth);
        else
          cp_async_commit();
        om_publish(j);
      }
      cp_async_wait_all();
    } else {
      float oacc[16];
#pragma unroll
      for (int v = 0; v < 16; ++v) oacc[v] = 0.f;
      for (int j = j0; j < j1; ++j) {
        const int s = take();
        const uint64_t a = smem_desc(stage_a(s), 128, kKC * 16);
        const uint64_t b = smem_desc(stage_b(s), kOmN * 16, 128);
        fence_operands(oacc);
        wgmma_fence();
#pragma unroll
        for (int q = 0; q < 4; ++q)  // k16 steps: 2 core matrices along K
          wgmma_n32<0, 1>(oacc, a + 16 * q, b + 2 * kOmN * q);
        wgmma_commit();
        wgmma_wait<1>();
        fence_operands(oacc);
        retire(s);
      }
      wgmma_wait<0>();
      fence_operands(oacc);
      retire_all();
#pragma unroll
      for (int v = 0; v < 16; ++v)
        omp[frag_row(v) * kOmN + frag_col(v)] = oacc[v];
    }
    cluster_or_block_sync(split);
    // om = the ranks' partials summed in rank order, + omb; the mask
    // through the sigmoid.  Every rank computes the same tile.
    for (int e = tid; e < kTM * kOm; e += kWThreads) {
      const int p = e / kOm, o = e - p * kOm;
      float part[kMaxSplit];
#pragma unroll
      for (int r = 0; r < kMaxSplit; ++r)  // all loads in flight first
        part[r] = r < split ? rank_smem(omp, r, split)[p * kOmN + o] : 0.f;
      float v = 0.f;
#pragma unroll
      for (int r = 0; r < kMaxSplit; ++r)
        if (r < split) v += part[r];
      v = om_out(o, v + s_omb[o]);
      omt[e] = v;
      if (rank == 0 && m0 + p < npix) om[(long long)(m0 + p) * kOm + o] = v;
    }
    __syncthreads();
  }

  // --- phase 2: the product over this rank's items -------------------------
  if (producer) {
    int tap = -1, buf = 1;
    for (int j = j0; j < j1; ++j) {
      const int k = j / nslice, c0 = (j - k * nslice) * kKC;
      if (k != tap) {  // the tile's corners at tap k, once per tap (two
        tap = k;       // tables: the other may still be read)
        buf ^= 1;
        if (pt < kTM) {
          const int m = m0 + pt;
          long long* ti = tab_idx + buf * 4 * kTM;
          float* tw = tab_w + buf * 4 * kTM;
          if (m < npix) {
            const float* o = omt + pt * kOm;
            const TapGeo geo = tap_geo(m, k, o[2 * k], o[2 * k + 1],
                                       o[18 + k], H, W, Cin, max_dy, 1.f);
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              // outside: a valid row with weight 0, as the backward has it
              const bool in = geo.idx[q] >= 0;
              ti[q * kTM + pt] = in ? geo.idx[q] : 0;
              tw[q * kTM + pt] = in ? geo.wq[q] * geo.mk : 0.f;
            }
          } else {
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              ti[q * kTM + pt] = 0;
              tw[q * kTM + pt] = 0.f;
            }
          }
        }
        producer_sync();
      }
      const int s = acquire();
      bf16* A = stage_a(s);
      bf16* Bt = stage_b(s);
      // B (kk, n) = W[k * Cin + c0 + kk, n], zero past Cin and Cout
      const bf16* wk = wt + ((long long)k * Cin + c0) * Cout;
      for (int e = pt; e < kKC * (kp / 8); e += kProd) {
        const int kk = e / (kp / 8), n = (e - kk * (kp / 8)) * 8;
        bf16* d = Bt + pack_off<bf16>(kk, n, kp);
        const bool row_in = c0 + kk < Cin;
        if (wvec && row_in && n < Cout) {
          cp_async16(d, wk + (long long)kk * Cout + n);
        } else {
#pragma unroll
          for (int e2 = 0; e2 < 8; ++e2)
            d[e2] = (row_in && n + e2 < Cout)
                        ? wk[(long long)kk * Cout + n + e2] : zero;
        }
      }
      // A (p, c) = sum over the corners q, in order, of w_q . x[idx_q + c]
      const long long* ti = tab_idx + buf * 4 * kTM;
      const float* tw = tab_w + buf * 4 * kTM;
      const int c = c0 + 8 * g;
      if (vec) {
        uint4 raw[4][4];  // [pixel][corner]
        float wq[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int p = pw * 4 + pq + 16 * i;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const long long idx = ti[q * kTM + p];
            wq[i][q] = tw[q * kTM + p];
            raw[i][q] = c < Cin ? *reinterpret_cast<const uint4*>(x + idx + c)
                                : make_uint4(0u, 0u, 0u, 0u);
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float v[8];
#pragma unroll
          for (int e = 0; e < 8; ++e) v[e] = 0.f;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            float xv[8];
            unpack8(raw[i][q], xv);
#pragma unroll
            for (int e = 0; e < 8; ++e) v[e] = fmaf(wq[i][q], xv[e], v[e]);
          }
          store_packed8<bf16>(A, pw * 4 + pq + 16 * i, 8 * g, kKC, v);
        }
      } else {  // Cin % 8 != 0: element loads
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int p = pw * 4 + pq + 16 * i;
          float v[8];
#pragma unroll
          for (int e = 0; e < 8; ++e) v[e] = 0.f;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const long long idx = ti[q * kTM + p];
            const float w = tw[q * kTM + p];
#pragma unroll
            for (int e = 0; e < 8; ++e)
              if (c + e < Cin) v[e] = fmaf(w, to_f(x[idx + c + e]), v[e]);
          }
          store_packed8<bf16>(A, p, 8 * g, kKC, v);
        }
      }
      cp_async_wait_all();  // this thread's part of B
      publish(s);
    }
  } else {
    float acc[NT][32];
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int v = 0; v < 32; ++v) acc[t][v] = 0.f;
    for (int j = j0; j < j1; ++j) {
      const int s = take();
      const uint64_t a = smem_desc(stage_a(s), 128, kKC * 16);
      const bf16* Bt = stage_b(s);
#pragma unroll
      for (int t = 0; t < NT; ++t) fence_operands(acc[t]);
      wgmma_fence();
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        // B read as MN-major: the next 8 k kp * 16 bytes on, the next 8 n
        // 128 bytes on; a k16 step is 2 kp in the address field
        const uint64_t b =
            smem_desc(Bt + pack_off<bf16>(0, t * 64, kp), kp * 16, 128);
        wgmma_k64<0, 1>(acc[t], a, a + 16, a + 32, a + 48, b, b + 2 * kp,
                        b + 4 * kp, b + 6 * kp);
      }
      wgmma_commit();
      wgmma_wait<1>();
#pragma unroll
      for (int t = 0; t < NT; ++t) fence_operands(acc[t]);
      retire(s);
    }
    wgmma_wait<0>();
#pragma unroll
    for (int t = 0; t < NT; ++t) fence_operands(acc[t]);
    retire_all();
    if (split == 1) {  // y = bf16(acc + bias), two columns a store
      const bool pair = (Cout & 1) == 0;
#pragma unroll
      for (int t = 0; t < NT; ++t) {
#pragma unroll
        for (int v = 0; v < 32; v += 2) {
          const int m = m0 + frag_row(v), n = t * 64 + frag_col(v);
          if (m >= npix || n >= Cout) continue;
          bf16* o = y + (long long)m * Cout + n;
          const float a0 = acc[t][v] + bias[n];
          if (pair) {
            *reinterpret_cast<__nv_bfloat162*>(o) =
                __floats2bfloat162_rn(a0, acc[t][v + 1] + bias[n + 1]);
          } else {
            o[0] = __float2bfloat16(a0);
            if (n + 1 < Cout)
              o[1] = __float2bfloat16(acc[t][v + 1] + bias[n + 1]);
          }
        }
      }
    } else {  // the partial into the (now idle) ring
      float* part = reinterpret_cast<float*>(smem);
#pragma unroll
      for (int t = 0; t < NT; ++t)
#pragma unroll
        for (int v = 0; v < 32; ++v)
          part[frag_row(v) * (kp + 4) + t * 64 + frag_col(v)] = acc[t][v];
    }
  }
  if (split > 1) {
    // rank r: rows r * 64 / split .. of the tile, the partials summed in
    // rank order, + bias
    cg::this_cluster().sync();
    float* part = reinterpret_cast<float*>(smem);
    const int r0 = rank * kTM / split, r1 = (rank + 1) * kTM / split;
    for (int e = tid; e < (r1 - r0) * Cout; e += kWThreads) {
      const int r = r0 + e / Cout, n = e % Cout, m = m0 + r;
      if (m >= npix) continue;
      float v[kMaxSplit];
#pragma unroll
      for (int q = 0; q < kMaxSplit; ++q)  // all loads in flight first
        v[q] = q < split ? rank_smem(part, q, split)[r * (kp + 4) + n] : 0.f;
      float sum = 0.f;
#pragma unroll
      for (int q = 0; q < kMaxSplit; ++q)
        if (q < split) sum += v[q];
      y[(long long)m * Cout + n] = __float2bfloat16(sum + bias[n]);
    }
    cg::this_cluster().sync();  // no rank leaves while others read it
  }
}

// ---------------------------------------------------------------------------
// float32: one block per 64-pixel tile and up to 256 columns, FFMA on the
// CUDA cores (see the note).
// ---------------------------------------------------------------------------

constexpr int kFC = 32;       // f32 input channels per chunk: a 128-byte row
constexpr int kLDA = 36;      // row stride of the pixel-major A tile (floats)
constexpr int kColMax = 256;  // columns of one block; more take column tiles

// Shared memory of a float32 block, in bytes from the dynamic base (the
// host's plan computes the same; the entry point checks the total).  A ring
// of `stages` stages, each an A tile [64 px][kLDA] f32 (the samples; for an
// om item, x at the integer tap) and a B tile [32 ch][kp] f32 (the weight
// rows; for an om item, the omw rows [32][27] as they lie in memory); the
// full and empty mbarriers; two corner tables [4][64] (element offsets,
// then weights); the om tile [64][27] f32; the om partial [64][32] f32.
// After the product a split block's f32 partial [64][kp + 4] reuses the
// ring.
struct F32Layout {
  int b_off, stage, bars, tab, om, omp, bytes;
  __host__ __device__ F32Layout(int kp, int stages) {
    b_off = kTM * kLDA * 4;
    stage = b_off + kFC * kp * 4;
    bars = stages * stage;
    tab = bars + align128(16 * stages);
    om = tab + 2 * 4 * kTM * (8 + 4);
    omp = om + kTM * kOm * 4;
    bytes = omp + kTM * kOmN * 4;
  }
};

// An arrival on b once every cp.async this thread has issued has landed.
// NOINC: that arrival is the thread's own; else it only holds the phase
// open until the copies land, and the thread arrives as well.
template <bool NOINC>
__device__ __forceinline__ void mbar_arrive_cp_async(uint64_t* b) {
  if constexpr (NOINC)
    asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::
                     "r"(smem_u32(b))
                 : "memory");
  else
    asm volatile("cp.async.mbarrier.arrive.shared::cta.b64 [%0];\n" ::"r"(
                     smem_u32(b))
                 : "memory");
}

// the consumers' own barrier (named barrier 2, warpgroup 0)
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 2, 128;\n" ::: "memory");
}

__device__ __forceinline__ float f4_at(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// Grid: (split * tiles, column tiles); block (b, c) takes pixel tile
// b / split, cluster rank b % split and columns c * kp .. c * kp + kp - 1;
// the rank owns the (tap, chunk) items [rank * nck / split, (rank + 1) *
// nck / split) of the sequence j -> tap j / nslice, channels (j % nslice)
// * 32 .. + 31.  FUSED: K1 (om computed here from x, omw, omb and written
// to om by column tile 0); else K2 (offsets and mask read from off, msk).
template <int NT, bool FUSED>
__global__ void __launch_bounds__(kWThreads, NT <= 2 ? 2 : 1)
dcn_gemm_f32(const float* __restrict__ x, const float* __restrict__ omw,
             const float* __restrict__ omb, const float* __restrict__ off,
             const float* __restrict__ msk, const float* __restrict__ wt,
             const float* __restrict__ bias, float* __restrict__ om,
             float* __restrict__ y, int B, int H, int W, int Cin, int Cout,
             float max_dy, int split, int stages) {
  constexpr int kp = NT * 64;  // N: this block's columns, padded
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float s_omb[kOm];  // K1: the om bias, once
  const F32Layout L(kp, stages);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bars);
  uint64_t* empty = full + stages;
  long long* tab_idx = reinterpret_cast<long long*>(smem + L.tab);
  float* tab_w = reinterpret_cast<float*>(smem + L.tab + 2 * 4 * kTM * 8);
  float* omt = reinterpret_cast<float*>(smem + L.om);
  float* omp = reinterpret_cast<float*>(smem + L.omp);
  auto stage_a = [&](int s) {
    return reinterpret_cast<float*>(smem + s * L.stage);
  };
  auto stage_b = [&](int s) {
    return reinterpret_cast<float*>(smem + s * L.stage + L.b_off);
  };

  const int tid = threadIdx.x;
  const int npix = B * H * W;
  const int rank = blockIdx.x % split;
  const int m0 = (blockIdx.x / split) * kTM;
  const int n0 = blockIdx.y * kp;
  const int ncol = min(kp, Cout - n0);  // this block's columns
  const int nslice = cdiv(Cin, kFC);
  const int nck = 9 * nslice;
  const int j0 = rank * nck / split, j1 = (rank + 1) * nck / split;
  const bool vec =
      (Cin & 3) == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  const bool wvec =
      (Cout & 3) == 0 && (reinterpret_cast<uintptr_t>(wt) & 15) == 0;
  const bool producer = tid >= kWThreads - kProd;
  const int pt = tid - (kWThreads - kProd);  // producer thread
  const int lane = tid & 31, pw = pt >> 5;
  // a producer lane: pixels 4 pw + pq + 16 i (i < 4) of the tile, channels
  // 4 g .. 4 g + 3 of the chunk: 8 lanes read one pixel's corner row, all
  // 128 bytes of the chunk (one L2 request per row)
  const int pq = lane >> 3, g = lane & 7;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + s, kProd);
      mbar_init(empty + s, kWThreads - kProd);
    }
    mbar_init_fence();
  }
  if constexpr (FUSED) {
    if (tid < kOm) s_omb[tid] = omb[tid];
  } else {  // K2: the tile's offsets and mask
    for (int e = tid; e < kTM * kOm; e += kWThreads) {
      const int p = e / kOm, o = e - p * kOm, m = m0 + p;
      float v = 0.f;
      if (m < npix)
        v = o < 18 ? off[(long long)m * 18 + o]
                   : msk[(long long)m * 9 + o - 18];
      omt[e] = v;
    }
  }
  __syncthreads();

  // the ring: items go through it in one order for both roles; item i
  // uses stage i % stages in phase i / stages
  int it = 0;      // consumer: items taken
  int issued = 0;  // producer: stages acquired
  auto acquire = [&]() {  // producer: the next stage, once empty
    const int s = issued % stages;
    mbar_wait(empty + s, ((issued / stages) & 1) ^ 1);
    ++issued;
    return s;
  };
  auto take = [&]() {  // consumer: the next stage, once full
    const int s = it % stages;
    mbar_wait(full + s, (it / stages) & 1);
    ++it;
    return s;
  };

  if constexpr (FUSED) {
    // --- phase 1: the om conv, its partial over this rank's items ---------
    if (producer) {
      const bool ovec =
          vec && (reinterpret_cast<uintptr_t>(omw) & 15) == 0;
      int pb[4], py[4], px[4];
      bool pin[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int m = m0 + pw * 4 + pq + 16 * i;
        const int t = m / W;
        pin[i] = m < npix;
        px[i] = m - t * W;
        py[i] = t % H;
        pb[i] = t / H;
      }
      for (int j = j0; j < j1; ++j) {
        const int k = j / nslice, c0 = (j - k * nslice) * kFC;
        const int s = acquire();
        float* A = stage_a(s);
        float* Bw = stage_b(s);
        // A = x at the integer tap, zero outside the image and past Cin
        const int c = c0 + 4 * g;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int p = pw * 4 + pq + 16 * i;
          const int sy = py[i] + k / 3 - 1, sx = px[i] + k % 3 - 1;
          const bool in =
              pin[i] && sy >= 0 && sy < H && sx >= 0 && sx < W;
          const long long row =
              in ? (((long long)pb[i] * H + sy) * W + sx) * Cin : 0;
          float* d = A + p * kLDA + 4 * g;
          if (ovec) {
            const bool ok = in && c < Cin;
            cp_async16_zfill(d, ok ? x + row + c : x, ok ? 16 : 0);
          } else {
#pragma unroll
            for (int e = 0; e < 4; ++e)
              d[e] = (in && c + e < Cin) ? x[row + c + e] : 0.f;
          }
        }
        // B = the item's omw rows, contiguous [rows][27], zero past Cin
        const int n = min(kFC, Cin - c0) * kOm;
        const float* src = omw + ((long long)k * Cin + c0) * kOm;
        if (ovec) {  // n: a multiple of 4 (Cin % 4 == 0)
          for (int e = pt; e < kFC * kOm / 4; e += kProd) {
            const bool ok = 4 * e < n;
            cp_async16_zfill(Bw + 4 * e, ok ? src + 4 * e : omw,
                             ok ? 16 : 0);
          }
          mbar_arrive_cp_async<true>(full + s);  // once the copies land
        } else {
          for (int e = pt; e < kFC * kOm; e += kProd)
            Bw[e] = e < n ? src[e] : 0.f;
          mbar_arrive(full + s);
        }
      }
      cp_async_wait_all();
    } else {
      // 4 x 4 outputs a thread: pixels tr + 16 i, om columns tc + 8 jj
      // (columns past 26 read column 26 and are never kept)
      const int tr = tid >> 3, tc = tid & 7;
      int col[4];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) col[jj] = min(tc + 8 * jj, kOm - 1);
      float oacc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) oacc[i][jj] = 0.f;
      for (int j = j0; j < j1; ++j) {
        const int s = take();
        const float* A = stage_a(s);
        const float* Bw = stage_b(s);
#pragma unroll 2
        for (int kq = 0; kq < kFC / 4; ++kq) {
          float4 a[4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            a[i] = *reinterpret_cast<const float4*>(
                A + (tr + 16 * i) * kLDA + 4 * kq);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float* brow = Bw + (4 * kq + e) * kOm;
            float bv[4];
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) bv[jj] = brow[col[jj]];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const float av = f4_at(a[i], e);
#pragma unroll
              for (int jj = 0; jj < 4; ++jj)
                oacc[i][jj] = fmaf(av, bv[jj], oacc[i][jj]);
            }
          }
        }
        mbar_arrive(empty + s);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          omp[(tr + 16 * i) * kOmN + tc + 8 * jj] = oacc[i][jj];
    }
    cluster_or_block_sync(split);
    // om = the ranks' partials summed in rank order, + omb; the mask
    // through the sigmoid.  Every rank computes the same tile.
    for (int e = tid; e < kTM * kOm; e += kWThreads) {
      const int p = e / kOm, o = e - p * kOm;
      float part[kMaxSplit];
#pragma unroll
      for (int r = 0; r < kMaxSplit; ++r)  // all loads in flight first
        part[r] = r < split ? rank_smem(omp, r, split)[p * kOmN + o] : 0.f;
      float v = 0.f;
#pragma unroll
      for (int r = 0; r < kMaxSplit; ++r)
        if (r < split) v += part[r];
      v = om_out(o, v + s_omb[o]);
      omt[e] = v;
      if (rank == 0 && blockIdx.y == 0 && m0 + p < npix)
        om[(long long)(m0 + p) * kOm + o] = v;
    }
    __syncthreads();
  }

  // --- phase 2: the product over this rank's items -------------------------
  if (producer) {
    int tap = -1, buf = 1;
    for (int j = j0; j < j1; ++j) {
      const int k = j / nslice, c0 = (j - k * nslice) * kFC;
      if (k != tap) {  // the tile's corners at tap k, once per tap (two
        tap = k;       // tables: the other may still be read)
        buf ^= 1;
        if (pt < kTM) {
          const int m = m0 + pt;
          long long* ti = tab_idx + buf * 4 * kTM;
          float* tw = tab_w + buf * 4 * kTM;
          if (m < npix) {
            const float* o = omt + pt * kOm;
            const TapGeo geo = tap_geo(m, k, o[2 * k], o[2 * k + 1],
                                       o[18 + k], H, W, Cin, max_dy, 1.f);
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              // outside: a valid row with weight 0, as the backward has it
              const bool in = geo.idx[q] >= 0;
              ti[q * kTM + pt] = in ? geo.idx[q] : 0;
              tw[q * kTM + pt] = in ? geo.wq[q] * geo.mk : 0.f;
            }
          } else {
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              ti[q * kTM + pt] = 0;
              tw[q * kTM + pt] = 0.f;
            }
          }
        }
        producer_sync();
      }
      const int s = acquire();
      float* A = stage_a(s);
      float* Bt = stage_b(s);
      // B (kk, n) = W[k * Cin + c0 + kk, n0 + n], zero past Cin and Cout
      const float* wk = wt + ((long long)k * Cin + c0) * Cout + n0;
      for (int e = pt; e < kFC * (kp / 4); e += kProd) {
        const int kk = e / (kp / 4), n = (e - kk * (kp / 4)) * 4;
        float* d = Bt + kk * kp + n;
        const bool row_in = c0 + kk < Cin;
        if (wvec) {  // ncol: a multiple of 4 (Cout % 4 == 0)
          const bool ok = row_in && n < ncol;
          cp_async16_zfill(d, ok ? wk + (long long)kk * Cout + n : wt,
                           ok ? 16 : 0);
        } else {
#pragma unroll
          for (int e2 = 0; e2 < 4; ++e2)
            d[e2] = (row_in && n + e2 < ncol)
                        ? wk[(long long)kk * Cout + n + e2] : 0.f;
        }
      }
      if (wvec) mbar_arrive_cp_async<false>(full + s);  // B holds the stage
      // A (p, c) = sum over the corners q, in order, of w_q . x[idx_q + c]
      const long long* ti = tab_idx + buf * 4 * kTM;
      const float* tw = tab_w + buf * 4 * kTM;
      const int c = c0 + 4 * g;
      if (vec) {
        float4 raw[4][4];  // [pixel][corner]
        float wq[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int p = pw * 4 + pq + 16 * i;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const long long idx = ti[q * kTM + p];
            wq[i][q] = tw[q * kTM + p];
            raw[i][q] = c < Cin
                            ? *reinterpret_cast<const float4*>(x + idx + c)
                            : make_float4(0.f, 0.f, 0.f, 0.f);
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float v[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            v[0] = fmaf(wq[i][q], raw[i][q].x, v[0]);
            v[1] = fmaf(wq[i][q], raw[i][q].y, v[1]);
            v[2] = fmaf(wq[i][q], raw[i][q].z, v[2]);
            v[3] = fmaf(wq[i][q], raw[i][q].w, v[3]);
          }
          *reinterpret_cast<float4*>(A + (pw * 4 + pq + 16 * i) * kLDA +
                                     4 * g) =
              make_float4(v[0], v[1], v[2], v[3]);
        }
      } else {  // Cin % 4 != 0 (or an unaligned x): element loads
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int p = pw * 4 + pq + 16 * i;
          float v[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const long long idx = ti[q * kTM + p];
            const float w = tw[q * kTM + p];
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (c + e < Cin) v[e] = fmaf(w, x[idx + c + e], v[e]);
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) A[p * kLDA + 4 * g + e] = v[e];
        }
      }
      mbar_arrive(full + s);
    }
    cp_async_wait_all();
  } else {
    // 8 x 4 outputs a thread in each 64-column sub-tile t: pixels tr + 8 i,
    // columns 64 t + 4 tc .. + 3 (a warp reads two A rows, 36 floats
    // apart, and 16 neighbouring float4 of a B row: no bank conflict)
    const int tr = tid >> 4, tc = tid & 15;
    float acc[8][4 * NT];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int v = 0; v < 4 * NT; ++v) acc[i][v] = 0.f;
    for (int j = j0; j < j1; ++j) {
      const int s = take();
      const float* A = stage_a(s);
      const float* Bt = stage_b(s);
#pragma unroll 2
      for (int kq = 0; kq < kFC / 4; ++kq) {
        float4 a[8];
#pragma unroll
        for (int i = 0; i < 8; ++i)
          a[i] = *reinterpret_cast<const float4*>(A + (tr + 8 * i) * kLDA +
                                                  4 * kq);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float* brow = Bt + (4 * kq + e) * kp + 4 * tc;
#pragma unroll
          for (int t = 0; t < NT; ++t) {
            const float4 b = *reinterpret_cast<const float4*>(brow + 64 * t);
#pragma unroll
            for (int i = 0; i < 8; ++i) {
              const float av = f4_at(a[i], e);
              acc[i][4 * t] = fmaf(av, b.x, acc[i][4 * t]);
              acc[i][4 * t + 1] = fmaf(av, b.y, acc[i][4 * t + 1]);
              acc[i][4 * t + 2] = fmaf(av, b.z, acc[i][4 * t + 2]);
              acc[i][4 * t + 3] = fmaf(av, b.w, acc[i][4 * t + 3]);
            }
          }
        }
      }
      mbar_arrive(empty + s);
    }
    if (split == 1) {  // y = acc + bias
      const bool cvec =
          (Cout & 3) == 0 && (reinterpret_cast<uintptr_t>(y) & 15) == 0;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int m = m0 + tr + 8 * i;
        if (m >= npix) continue;
        float* yr = y + (long long)m * Cout + n0;
        const float* br = bias + n0;
#pragma unroll
        for (int t = 0; t < NT; ++t) {
          const int n = 64 * t + 4 * tc;
          if (cvec && n < ncol) {
            *reinterpret_cast<float4*>(yr + n) = make_float4(
                acc[i][4 * t] + br[n], acc[i][4 * t + 1] + br[n + 1],
                acc[i][4 * t + 2] + br[n + 2],
                acc[i][4 * t + 3] + br[n + 3]);
          } else {
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (n + e < ncol) yr[n + e] = acc[i][4 * t + e] + br[n + e];
          }
        }
      }
    } else {  // the partial into the ring, once no consumer reads it
      consumer_sync();
      float* part = reinterpret_cast<float*>(smem);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int t = 0; t < NT; ++t)
          *reinterpret_cast<float4*>(part + (tr + 8 * i) * (kp + 4) +
                                     64 * t + 4 * tc) =
              make_float4(acc[i][4 * t], acc[i][4 * t + 1],
                          acc[i][4 * t + 2], acc[i][4 * t + 3]);
    }
  }
  if (split > 1) {
    // rank r: rows r * 64 / split .. of the tile, the partials summed in
    // rank order, + bias
    cg::this_cluster().sync();
    float* part = reinterpret_cast<float*>(smem);
    const int r0 = rank * kTM / split, r1 = (rank + 1) * kTM / split;
    for (int e = tid; e < (r1 - r0) * ncol; e += kWThreads) {
      const int r = r0 + e / ncol, n = e % ncol, m = m0 + r;
      if (m >= npix) continue;
      float v[kMaxSplit];
#pragma unroll
      for (int q = 0; q < kMaxSplit; ++q)  // all loads in flight first
        v[q] = q < split ? rank_smem(part, q, split)[r * (kp + 4) + n] : 0.f;
      float sum = 0.f;
#pragma unroll
      for (int q = 0; q < kMaxSplit; ++q)
        if (q < split) sum += v[q];
      y[(long long)m * Cout + n0 + n] = sum + bias[n0 + n];
    }
    cg::this_cluster().sync();  // no rank leaves while others read it
  }
}

unsigned blocks(long long n, int per_block) {
  return (unsigned)((n + per_block - 1) / per_block);
}

// ---------------------------------------------------------------------------
// Host: launches.
// ---------------------------------------------------------------------------

// 0, or cudaErrorInvalidValue where the plan (split, stages, smem: see
// ops/dcn_cuda.forward_plan) does not fit the shape
int check_plan(int B, int H, int W, int Cin, int Cout, int split,
               int stages, int smem) {
  const int bad = (int)cudaErrorInvalidValue;
  if (B < 1 || H < 1 || W < 1 || Cin < 1 || Cout < 1 || Cout > 256)
    return bad;
  const long long npix = (long long)B * H * W;
  if (npix >= (1LL << 31) / 8) return bad;  // pixels and grid in int
  if (split < 1 || split > kMaxSplit || split > 9 * cdiv(Cin, kKC))
    return bad;
  const int kp = round_up(Cout, 64);
  const FwdLayout L(kp, stages);
  if (stages < 2 || stages > 8 || L.bytes != smem || smem > kSmemMax)
    return bad;
  if (split > 1 && L.bars < kTM * (kp + 4) * 4) return bad;
  return 0;
}

// 0, or cudaErrorInvalidValue where the float32 plan does not fit the
// shape (any Cout: more than 256 columns take column tiles)
int check_plan_f32(int B, int H, int W, int Cin, int Cout, int split,
                   int stages, int smem) {
  const int bad = (int)cudaErrorInvalidValue;
  if (B < 1 || H < 1 || W < 1 || Cin < 1 || Cout < 1) return bad;
  const long long npix = (long long)B * H * W;
  if (npix >= (1LL << 31) / 8) return bad;  // pixels and grid in int
  if (split < 1 || split > kMaxSplit || split > 9 * cdiv(Cin, kFC))
    return bad;
  const int kp = round_up(Cout < kColMax ? Cout : kColMax, 64);
  const F32Layout L(kp, stages);
  if (stages < 2 || stages > 8 || L.bytes != smem || smem > kSmemMax)
    return bad;
  if (split > 1 && L.bars < kTM * (kp + 4) * 4) return bad;
  return 0;
}

// One launch of kern: grid.x in clusters of `split` blocks, `smem` bytes
// of dynamic shared memory a block.
template <typename... Params, typename... Args>
cudaError_t launch_clusters(void (*kern)(Params...), dim3 grid, int split,
                            int smem, cudaStream_t st, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kWThreads);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kern, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int NT, bool FUSED>
cudaError_t launch_wgmma(const void* x, const void* omw, const void* omb,
                         const void* off, const void* msk, const void* w,
                         const void* bias, void* om, void* y, int B, int H,
                         int W, int Cin, int Cout, float max_dy, int split,
                         int stages, int smem, cudaStream_t st) {
  using bf16 = __nv_bfloat16;
  return launch_clusters(
      dcn_gemm_wgmma<NT, FUSED>,
      dim3(blocks((long long)B * H * W, kTM) * (unsigned)split), split, smem,
      st, static_cast<const bf16*>(x), static_cast<const bf16*>(omw),
      static_cast<const bf16*>(omb), static_cast<const bf16*>(off),
      static_cast<const bf16*>(msk), static_cast<const bf16*>(w),
      static_cast<const float*>(bias), static_cast<float*>(om),
      static_cast<bf16*>(y), B, H, W, Cin, Cout, max_dy, split, stages);
}

template <int NT, bool FUSED>
cudaError_t launch_ffma(const void* x, const void* omw, const void* omb,
                        const void* off, const void* msk, const void* w,
                        const void* bias, void* om, void* y, int B, int H,
                        int W, int Cin, int Cout, float max_dy, int split,
                        int stages, int smem, cudaStream_t st) {
  return launch_clusters(
      dcn_gemm_f32<NT, FUSED>,
      dim3(blocks((long long)B * H * W, kTM) * (unsigned)split,
           blocks(Cout, NT * 64)),
      split, smem, st, static_cast<const float*>(x),
      static_cast<const float*>(omw), static_cast<const float*>(omb),
      static_cast<const float*>(off), static_cast<const float*>(msk),
      static_cast<const float*>(w), static_cast<const float*>(bias),
      static_cast<float*>(om), static_cast<float*>(y), B, H, W, Cin, Cout,
      max_dy, split, stages);
}

template <bool FUSED>
int launch_f32(const void* x, const void* omw, const void* omb,
               const void* off, const void* msk, const void* w,
               const void* bias, void* om, void* y, int B, int H, int W,
               int Cin, int Cout, float max_dy, int split, int stages,
               int smem, cudaStream_t st) {
  const int rc = check_plan_f32(B, H, W, Cin, Cout, split, stages, smem);
  if (rc) return rc;
  switch (cdiv(Cout < kColMax ? Cout : kColMax, 64)) {
#define CP_NT(N)                                                            \
  case N:                                                                   \
    return (int)launch_ffma<N, FUSED>(x, omw, omb, off, msk, w, bias, om,  \
                                      y, B, H, W, Cin, Cout, max_dy, split, \
                                      stages, smem, st);
    CP_NT(1)
    CP_NT(2)
    CP_NT(3)
    CP_NT(4)
#undef CP_NT
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <bool FUSED>
int launch_bf16(const void* x, const void* omw, const void* omb,
                const void* off, const void* msk, const void* w,
                const void* bias, void* om, void* y, int B, int H, int W,
                int Cin, int Cout, float max_dy, int split, int stages,
                int smem, cudaStream_t st) {
  const int rc = check_plan(B, H, W, Cin, Cout, split, stages, smem);
  if (rc) return rc;
  switch (cdiv(Cout, 64)) {
#define CP_NT(N)                                                             \
  case N:                                                                    \
    return (int)launch_wgmma<N, FUSED>(x, omw, omb, off, msk, w, bias, om,  \
                                       y, B, H, W, Cin, Cout, max_dy, split, \
                                       stages, smem, st);
    CP_NT(1)
    CP_NT(2)
    CP_NT(3)
    CP_NT(4)
#undef CP_NT
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// K1.  dtype: 0 = float32, 1 = bfloat16 (x, omw, omb, w, y); bias is
// float32, added to the f32 accumulator before the output's rounding; om:
// f32 [B*H*W, 27], written.  max_dy < 0: unclamped.  split, stages, smem:
// the launch plan of the dtype (ops/dcn_cuda.forward_plan).  Returns 0 or
// the CUDA error of the launch.
extern "C" int cp_dcn_v2_fused_forward(int dtype, const void* x,
                                       const void* omw, const void* omb,
                                       const void* w, const void* bias,
                                       void* om, void* y, int B, int H, int W,
                                       int Cin, int Cout, float max_dy,
                                       int split, int stages, int smem,
                                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_f32<true>(x, omw, omb, nullptr, nullptr, w, bias, om, y, B,
                            H, W, Cin, Cout, max_dy, split, stages, smem, s);
  if (dtype == 1)
    return launch_bf16<true>(x, omw, omb, nullptr, nullptr, w, bias, om, y,
                             B, H, W, Cin, Cout, max_dy, split, stages, smem,
                             s);
  return (int)cudaErrorInvalidValue;
}

// K2.  dtype: 0 = float32, 1 = bfloat16 (x, offset, mask, w, y); bias is
// float32.  offset [B*H*W, 18] (dy, dx per tap), mask [B*H*W, 9] already
// sigmoid-ed.  max_dy < 0: unclamped.  split, stages, smem as for K1.
// Returns 0 or the CUDA error of the launch.
extern "C" int cp_dcn_v2_forward(int dtype, const void* x, const void* off,
                                 const void* msk, const void* w,
                                 const void* bias, void* y, int B, int H,
                                 int W, int Cin, int Cout, float max_dy,
                                 int split, int stages, int smem,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_f32<false>(x, nullptr, nullptr, off, msk, w, bias, nullptr,
                             y, B, H, W, Cin, Cout, max_dy, split, stages,
                             smem, s);
  if (dtype == 1)
    return launch_bf16<false>(x, nullptr, nullptr, off, msk, w, bias,
                              nullptr, y, B, H, W, Cin, Cout, max_dy, split,
                              stages, smem, s);
  return (int)cudaErrorInvalidValue;
}
