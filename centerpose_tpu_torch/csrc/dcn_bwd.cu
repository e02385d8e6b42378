// Modulated deformable convolution v2 (DCNv2) backward for Hopper,
// deterministic.
//
// Replaces the three TPU backward kernels of
// centerpose_tpu/ops/dcn_pallas.py: _dcn_pallas_grouped_bwd_impl (K3, the
// fused backward of the row-grouped sites, W in {16, 32, 64}; body
// _dcn_grouped_bwd_kernel), and the split backward of the W = 128 sites,
// _dcn_rowmajor_grads_impl (K4, pass A: doffset, dmask, dW; body
// _dcn_rowmajor_grads_kernel) and _dcn_rowmajor_dx_impl (K5, pass B: dx;
// body _dcn_rowmajor_dx_kernel).  One call computes the gradients of the
// forward
//
// y = bias + sum_k W_k^T . m_k . bilinear(x, p + p_k + (clip(dy_k,-R,R), dx_k))
//
// for a cotangent ct [B,H,W,Cout]:
//
//   dcols_k = ct . W_k^T                        [P, Cin] per tap k
//   dx      = transpose of the bilinear gather of m_k . dcols_k (4 corners,
//             zero outside the image)
//   dmask_k = sum_c dcols_k . sample_k          (sample before the mask)
//   ddy_k   = m_k . sum_c dcols_k . d(sample_k)/dy . clamp'(dy_k)
//   ddx_k   = m_k . sum_c dcols_k . d(sample_k)/dx
//   dW_k    = cols_k^T . ct                     (cols = m_k . sample_k, the
//                                                forward's im2col column,
//                                                rounded as it rounds it)
//   dbias   = sum_p ct
//
// clamp'(dy) is 1 where |dy| < R, 0 where |dy| > R, and `edge` at exactly
// |dy| = R: 1 where the reference runs its backward kernels (their
// clamp_pass), 0.5 where it falls back to the VJP of jnp.clip (the caller
// picks it per site).
//
// Determinism.  No float atomics: every output element is summed by one
// thread in an order fixed by the shapes and the offsets, so two runs on
// the same inputs give the same bits.  Integer atomics only count and
// place list entries; the dx pass puts each list in key order before it
// sums it.
//
// The launches, each owning what it writes:
//
//   A. dcn_bwd_grads (doffset, dmask, dW, dbias, and dcols for dx; K4's
//      output-owned pass and K3's gradients), 128 threads: a block owns
//      one tap k, one 64-channel slice of Cin and a fixed chunk of the
//      pixels.  Its W_k slice stays in shared memory; each 64-pixel tile's
//      cotangent, offset and mask rows arrive by cp.async during the
//      previous tile, and dcols [64 x 64] runs on wgmma (m64n64k16, K =
//      Cout).  dcols goes to G [P, 9, Cin] in x's type (the reference's K5
//      keeps its dcols in bf16 too).  A warp then walks 16 pixels, a lane 8
//      channels of one (16-byte loads, with no branch: an outside corner
//      reads a valid row and gets weight 0, as the plain version's clamped
//      index does); one gather serves three uses: dmask, ddy and ddx
//      summed over the channels (lane sums, then a fixed butterfly over the
//      pixel's eight lanes), and the column m . sample, rounded as the
//      forward rounds it, written to a pixel-major tile in shared memory
//      (one 16-byte store per lane and pixel).  dW_k [64 x Cout] += cols^T
//      . ct then runs on wgmma (K = pixels) in registers across the chunk,
//      both operands read in place as transposed (MN-major) tiles.  The
//      tap-k blocks of the first slice also sum dbias's columns k, k + 9,
//      ... in pixel order, and count the corners
//      that land on each pixel for pass B (integer atomics into counts
//      cleared before).  The number of chunks depends on the shape only:
//      one wave of two blocks per SM.
//   B. dx, the transpose of the gather as a gather (K5's idea, without
//      its band: the lists say exactly which sources reach a pixel).
//      dcn_bwd_scan_sums and dcn_bwd_scan turn pass A's counts into row
//      pointers, dcn_bwd_fill writes each corner's (key = the source's
//      G row m * 9 + k, weight w_q . m_k) into its pixel's list, and
//      dcn_bwd_dx gives each pixel a group of 8-32 lanes: it ranks the
//      list by key in shared memory and sums weight . G[key] over it in
//      that order, four rows in flight, a lane 8 channels.
//   C. dcn_bwd_sum_chunks: dW and dbias = the chunks' partials summed in
//      chunk order (none when there is one chunk: pass A then writes them).
//   D. dcn_bwd_sum_slices: doffset and dmask = the channel slices'
//      partials summed in slice order (none when Cin <= 64).
//
// float32 runs the same passes with the products on the CUDA cores (FMA,
// in wgmma's fragment layout, so the epilogues are shared): TF32 would not
// keep float32's accuracy.
//
// What bounds it on an H100: the products (dcols and dW) are twice the
// forward's, 4 * P * 9 * Cin * Cout operations, ~28 GFLOP per image at
// dla_34 512x512, ~29 us at the bf16 tensor-core rate; the bytes (x, ct,
// offsets, mask, W in; dx, doffset, dmask, dW out) are ~60 MB per image in
// bf16, ~18 us.  G adds its write and one read of 9 * P * Cin values (~100
// MB per image in bf16; its repeated reads, four per row, mostly hit L2).
// What this design does about the PR-5 kernel's costs: no float atomics
// (~302 M per call for dx and ~75 M for dW at 64->64 @128, batch 8,
// before; now ~4.7 M integer ones to count and place corners); the W_k
// slice loaded once per block and the corner gather done once for dmask,
// doffset and dW; wgmma with cp.async-staged operands instead of
// synchronous 16x16 WMMA; grids sized from the shape, so that pass A fills
// the SMs at batch 1 too.
//
// Layouts follow the JAX op: x NHWC [B,H,W,Cin], offset [P, 18] with
// (dy, dx) of tap k at 2k, 2k+1, mask [P, 9], weight [3,3,Cin,Cout]
// (= row-major [9*Cin, Cout]), ct [P, Cout].  x, weight and ct share one
// type T (float or bf16); offset and mask have type TO (float or bf16).
// Outputs are f32 and written in full: dx [P, Cin], doffset [P, 18], dmask
// [P, 9], dW [9*Cin, Cout], dbias [Cout].

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "dcn_hopper.cuh"

namespace {

constexpr int kThreads = 128;  // one warpgroup per block
constexpr int kTile = 64;      // pixels per tile: the M of every product
constexpr int kCA = 64;        // channels per pass-A product (its N)
constexpr int kDS = 68;        // row stride of pass A's dcols tile (floats)
constexpr int kGradPerSM = 2;  // pass A: blocks per SM in its one wave

// rows [row0, row0 + rows) of a row-major [*, ld] matrix into a packed tile
// with K = kp: element (r, k) = src[(row0 + r) * ld + k] where row0 + r <
// row_end and k < ld, else 0.  16-byte chunks go by cp.async where aligned
// (the caller commits and waits), the rest by plain loads.
template <typename T>
__device__ __forceinline__ void load_tile(T* dst, const T* __restrict__ src,
                                          long long row0, int rows,
                                          long long row_end, int ld, int kp) {
  constexpr int E = 16 / (int)sizeof(T);
  const int chunks = kp / E;
  const T zero = from_f<T>(0.f);
  for (int e = threadIdx.x; e < rows * chunks; e += blockDim.x) {
    const int r = e / chunks, k = (e % chunks) * E;
    T* d = dst + pack_off<T>(r, k, kp);
    const long long row = row0 + r;
    const T* g = src + row * ld + k;
    if (row < row_end && k + E <= ld &&
        (reinterpret_cast<uintptr_t>(g) & 15) == 0) {
      cp_async16(d, g);
    } else {
#pragma unroll
      for (int i = 0; i < E; ++i)
        d[i] = (row < row_end && k + i < ld) ? g[i] : zero;
    }
  }
}



// bf16: issue the product on the tensor cores (asynchronous; mma_wait
// ends it)
template <int M>
__device__ __forceinline__ void mma_issue(float (&d)[M],
                                          const __nv_bfloat16* A,
                                          const __nv_bfloat16* B, int kp) {
  const int sbo = kp * 16;
  fence_operands(d);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
  int kk = 0;
  for (; kk + 64 <= kp; kk += 64) {
    const uint64_t a = smem_desc(A + kk * 8, 128, sbo);
    const uint64_t b = smem_desc(B + kk * 8, 128, sbo);
    // the next k16 step starts 256 bytes on: 16 in the address field
    wgmma_k64<0, 0>(d, a, a + 16, a + 32, a + 48, b, b + 16, b + 32,
                    b + 48);
  }
  for (; kk < kp; kk += 16)
    wgmma_tile<0, 0>(d, smem_desc(A + kk * 8, 128, sbo),
                     smem_desc(B + kk * 8, 128, sbo));
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// bf16: D [64 x 64] += A . B over k < kTile, with A (m, k) =
// Akm[pack_off(k, m, kCA)] and B (k, n) = Bkn[pack_off(k, n0 + n, kp)]:
// two packed [kTile x *] tiles read as their transposes (wgmma's MN-major
// operands: a core matrix is 8 k by 16 bytes of m or n, the next along m
// or n 128 bytes on, the next along k ld * 16 bytes on); asynchronous
__device__ __forceinline__ void mma_issue_kn(float (&d)[32],
                                             const __nv_bfloat16* Akm,
                                             const __nv_bfloat16* Bkn,
                                             int kp, int n0) {
  fence_operands(d);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
  const uint64_t a = smem_desc(Akm, kCA * 16, 128);
  const uint64_t b =
      smem_desc(Bkn + pack_off<__nv_bfloat16>(0, n0, kp), kp * 16, 128);
  // a k16 step: two core matrices along k
  const int sa = 2 * kCA, sb = 2 * kp;
  wgmma_k64<1, 1>(d, a, a + sa, a + 2 * sa, a + 3 * sa, b, b + sb,
                  b + 2 * sb, b + 3 * sb);
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// float32: the same on the CUDA cores, done on return
__device__ __forceinline__ void mma_issue_kn(float (&d)[32], const float* Akm,
                                             const float* Bkn, int kp,
                                             int n0) {
  const int lane = threadIdx.x & 31;
  const int r0 = ((threadIdx.x & 127) >> 5) * 16 + (lane >> 2);
  const int cq = n0 + 2 * (lane & 3);
  for (int k = 0; k < kTile; ++k) {
    const float a0 = Akm[pack_off<float>(k, r0, kCA)];
    const float a1 = Akm[pack_off<float>(k, r0 + 8, kCA)];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float b0 = Bkn[pack_off<float>(k, 8 * j + cq, kp)];
      const float b1 = Bkn[pack_off<float>(k, 8 * j + cq + 1, kp)];
      d[4 * j] = fmaf(a0, b0, d[4 * j]);
      d[4 * j + 1] = fmaf(a0, b1, d[4 * j + 1]);
      d[4 * j + 2] = fmaf(a1, b0, d[4 * j + 2]);
      d[4 * j + 3] = fmaf(a1, b1, d[4 * j + 3]);
    }
  }
}

// float32: the same product on the CUDA cores, in the same layout, done on
// return
template <int M>
__device__ __forceinline__ void mma_issue(float (&d)[M], const float* A,
                                          const float* B, int kp) {
  const int lane = threadIdx.x & 31;
  const int r0 = ((threadIdx.x & 127) >> 5) * 16 + (lane >> 2);
  const int cq = 2 * (lane & 3);
  for (int k = 0; k < kp; ++k) {
    const float a0 = A[pack_off<float>(r0, k, kp)];
    const float a1 = A[pack_off<float>(r0 + 8, k, kp)];
#pragma unroll
    for (int j = 0; j < M / 4; ++j) {
      const float b0 = B[pack_off<float>(8 * j + cq, k, kp)];
      const float b1 = B[pack_off<float>(8 * j + cq + 1, k, kp)];
      d[4 * j] = fmaf(a0, b0, d[4 * j]);
      d[4 * j + 1] = fmaf(a0, b1, d[4 * j + 1]);
      d[4 * j + 2] = fmaf(a1, b0, d[4 * j + 2]);
      d[4 * j + 3] = fmaf(a1, b1, d[4 * j + 3]);
    }
  }
}

// wait until at most N products of this warpgroup are in flight
template <typename T, int N, int M>
__device__ __forceinline__ void mma_wait(float (&d)[M]) {
  if constexpr (sizeof(T) == 2)
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
  fence_operands(d);
}


// the weight with which corner q of g (made with Cin = 1: idx = the
// corners' pixels) adds to its pixel's dx; pass A's count and the fill
// list exactly the corners where it is nonzero, by this one expression
__device__ __forceinline__ float corner_weight(const TapGeo& g, int q) {
  return g.idx[q] >= 0 ? g.wq[q] * g.mk : 0.f;
}

// n contiguous elements from global to shared memory: 16-byte chunks by
// cp.async where aligned (the caller commits and waits), the rest plainly
template <typename TO>
__device__ __forceinline__ void copy_rows(TO* dst, const TO* __restrict__ src,
                                          int n) {
  constexpr int E = 16 / (int)sizeof(TO);
  const bool vec = ((reinterpret_cast<uintptr_t>(src) |
                     reinterpret_cast<uintptr_t>(dst)) & 15) == 0;
  const int nv = vec ? n / E : 0;
  for (int e = threadIdx.x; e < nv; e += blockDim.x)
    cp_async16(dst + e * E, src + e * E);
  for (int e = nv * E + threadIdx.x; e < n; e += blockDim.x) dst[e] = src[e];
}

// ---------------------------------------------------------------------------
// Shared-memory layouts, in bytes from the dynamic base (host and device).
// ---------------------------------------------------------------------------


struct LayoutA {  // W_k slice, inputs (one or two sets: ct tile, offset
                  // and mask rows), cols, dcols, geometry
  int ct[2], offs[2], msks[2], at, dc, geo, bytes;
  __host__ __device__ LayoutA(int kp, int elem, int oelem, bool two) {
    const int in = align128(kTile * kp * elem) +
                   align128(kTile * 18 * oelem) + align128(kTile * 9 * oelem);
    int o = align128(kCA * kp * elem);
    for (int i = 0; i < 2; ++i) {
      ct[i] = o;
      offs[i] = ct[i] + align128(kTile * kp * elem);
      msks[i] = offs[i] + align128(kTile * 18 * oelem);
      if (two) o += in;
    }
    o += in;
    at = o;
    dc = at + align128(kCA * kTile * elem);
    geo = dc + align128(kTile * kDS * 4);
    bytes = geo + 4 * kTile * 8 + 18 * kTile * 4;
  }
};

// ---------------------------------------------------------------------------
// Pass A: doffset, dmask, dW, dbias and G = dcols.  Grid [pixel chunks,
// taps, 64-channel slices]; chunk ch holds pixel tiles [ch * tiles / n,
// (ch + 1) * tiles / n).  NT: 64-wide column tiles of dW the block holds
// (Cout <= 64 NT).  dW and dbias go to chunk ch's partial (cstride floats
// apart; cstride 0: one chunk, the outputs themselves).
// ---------------------------------------------------------------------------

template <typename T, typename TO, int NT>
__global__ void __launch_bounds__(kThreads)
dcn_bwd_grads(const T* __restrict__ x, const TO* __restrict__ off,
             const TO* __restrict__ msk, const T* __restrict__ wt,
             const T* __restrict__ ct, float* __restrict__ doff,
             float* __restrict__ dmask, float* __restrict__ ompart,
             float* __restrict__ dwout, float* __restrict__ dbout,
             long long cstride, T* __restrict__ gcol, int gstride,
             int* __restrict__ cnt, int B, int H, int W, int Cin, int Cout,
             float max_dy, float edge, int nchunks, int two) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int kp = round_up(Cout, 16);
  const LayoutA L(kp, (int)sizeof(T), (int)sizeof(TO), two != 0);
  T* wsl = reinterpret_cast<T*>(smem);              // W_k slice [64 x kp]
  T* at = reinterpret_cast<T*>(smem + L.at);        // cols [64 p x 64 c]
  float* dc = reinterpret_cast<float*>(smem + L.dc);  // dcols [64][kDS]
  // per pixel: the corners' x rows (a valid row where the corner is
  // outside: its weights are 0 there, as the plain version's clamped
  // index); per corner the weights of the sample, of the column (the
  // sample's times the mask) and of the sample's y and x derivatives; the
  // mask; the clamp's gradient factor
  long long* gidx = reinterpret_cast<long long*>(smem + L.geo);  // [4][64]
  float* gw = reinterpret_cast<float*>(smem + L.geo + 4 * kTile * 8);
  float* s_mk = gw + 16 * kTile;
  float* s_pass = gw + 17 * kTile;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int k = blockIdx.y, slice = blockIdx.z, c0 = slice * kCA;
  const int ch = blockIdx.x;
  const bool one_slice = gridDim.z == 1;
  const int npix = B * H * W;
  const int tiles = cdiv(npix, kTile);
  const int j0 = (int)((long long)ch * tiles / nchunks);
  const int j1 = (int)((long long)(ch + 1) * tiles / nchunks);
  // dbias: the block of tap k (first slice) sums columns k, k + 9, ...
  const int nb = k + 9 * tid;
  const bool sums_bias = slice == 0 && nb < Cout;
  float bacc = 0.f;

  // cotangent, offset and mask rows of a tile into input set `buf`
  auto load_inputs = [&](int m0, int buf) {
    const int rows = min(kTile, npix - m0);
    load_tile(reinterpret_cast<T*>(smem + L.ct[buf]), ct, m0, kTile, npix,
              Cout, kp);
    copy_rows(reinterpret_cast<TO*>(smem + L.offs[buf]),
              off + (long long)m0 * 18, rows * 18);
    copy_rows(reinterpret_cast<TO*>(smem + L.msks[buf]),
              msk + (long long)m0 * 9, rows * 9);
  };

  load_tile(wsl, wt + k * (long long)Cin * Cout, c0, kCA, Cin, Cout, kp);
  if (j0 < j1) load_inputs(j0 * kTile, 0);
  cp_async_commit();

  float dw[NT][32];
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int v = 0; v < 32; ++v) dw[t][v] = 0.f;
  auto retire_dw = [&]() {  // wait for this warpgroup's dW products
    if constexpr (sizeof(T) == 2)
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
    for (int t = 0; t < NT; ++t) fence_operands(dw[t]);
  };

  for (int j = j0; j < j1; ++j) {
    const int m0 = j * kTile;
    const int buf = two ? (j - j0) & 1 : 0;
    T* cts = reinterpret_cast<T*>(smem + L.ct[buf]);      // ct tile
    const TO* offs = reinterpret_cast<TO*>(smem + L.offs[buf]);
    const TO* msks = reinterpret_cast<TO*>(smem + L.msks[buf]);
    retire_dw();  // the last tile's products read its inputs and cols
    cp_async_wait_all();
    fence_async_smem();
    __syncthreads();
    if (two && j + 1 < j1) {  // the next tile's inputs load during this one
      load_inputs(m0 + kTile, buf ^ 1);
      cp_async_commit();
    }
    if (tid < kTile) {  // the tile's geometry at tap k
      const int m = m0 + tid;
      if (m < npix) {
        const TapGeo g = tap_geo(m, k, to_f(offs[tid * 18 + 2 * k]),
                                 to_f(offs[tid * 18 + 2 * k + 1]),
                                 to_f(msks[tid * 9 + k]), H, W, 1, max_dy,
                                 edge);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          // the dx pass's count of the corners that land on each pixel
          if (slice == 0 && corner_weight(g, q) != 0.f)
            atomicAdd(cnt + g.idx[q], 1);
          const float e = g.idx[q] >= 0 ? 1.f : 0.f;
          const float wy = q < 2 ? -1.f : 1.f, wx = q % 2 ? 1.f : -1.f;
          gidx[q * kTile + tid] = g.idx[q] >= 0 ? g.idx[q] * Cin : 0;
          gw[q * kTile + tid] = g.wq[q] * e;
          gw[(4 + q) * kTile + tid] = g.wq[q] * e * g.mk;
          gw[(8 + q) * kTile + tid] =
              wy * (q % 2 ? g.wx1 : 1.f - g.wx1) * e;
          gw[(12 + q) * kTile + tid] =
              wx * (q < 2 ? 1.f - g.wy1 : g.wy1) * e;
        }
        s_mk[tid] = g.mk;
        s_pass[tid] = g.pass;
      } else {  // past the last pixel: nothing sampled
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          gidx[q * kTile + tid] = 0;
#pragma unroll
          for (int r = 0; r < 4; ++r) gw[(4 * r + q) * kTile + tid] = 0.f;
        }
        s_mk[tid] = s_pass[tid] = 0.f;
      }
    }
    if (sums_bias)  // in pixel order (rows past the last pixel are 0)
      for (int p = 0; p < kTile; ++p) bacc += to_f(cts[pack_off<T>(p, nb, kp)]);

    // a warp walks 16 pixels, four at a time; a lane owns 8 channels of one
    // of them (16-byte loads; eight lanes cover the 64-channel slice).
    // Every load is from a valid address: the weights mask the rest
    // (channels past Cin read channel 0; their dcols are 0).  bf16 with
    // Cout <= 128: the rows of all four of the lane's pixels are loaded at
    // once, raw, before the dcols product, so that their latency overlaps
    // it; otherwise two pixels' rows at a time, after it.
    const int cg = (lane >> 2) * 8, ps = lane & 3, c = c0 + cg;
    const bool vec = (Cin & 7) == 0;  // 16-byte aligned, whole groups
    constexpr bool kEarly = sizeof(T) == 2 && NT <= 2;
    uint4 raw[kEarly ? 4 : 1][4];  // [pixel][corner]
    if constexpr (kEarly) {
      __syncthreads();  // the geometry
      if (vec) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int q = 0; q < 4; ++q)
            raw[i][q] = *reinterpret_cast<const uint4*>(
                x + gidx[q * kTile + warp * 16 + 4 * i + ps] +
                (c < Cin ? c : 0));
      }
    }

    // dcols [64 pixels x 64 channels] of tap k
    float d[32];
#pragma unroll
    for (int v = 0; v < 32; ++v) d[v] = 0.f;
    mma_issue(d, cts, wsl, kp);
    mma_wait<T, 0>(d);
#pragma unroll
    for (int v = 0; v < 32; ++v) dc[frag_row(v) * kDS + frag_col(v)] = d[v];
    __syncthreads();
    // G rows (m, k), channels c0.., in x's type, for the dx pass
    for (int e = tid; e < kTile * (kCA / 8); e += kThreads) {
      const int p = e >> 3, cq = (e & 7) * 8;
      if (m0 + p < npix && c0 + cq < gstride) {
        float v[8];
        const float4* q = reinterpret_cast<const float4*>(dc + p * kDS + cq);
        const float4 a = q[0], b = q[1];
        v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
        v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
        store8(gcol + ((long long)(m0 + p) * 9 + k) * gstride + c0 + cq, v);
      }
    }

    // per pixel: corners, sample, its derivatives; dmask, ddy, ddx summed
    // over the channels (the lane's eight, then the eight lanes' by a fixed
    // butterfly), and the column m . sample into the cols tile
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // two pixels of the lane at a time
      float va[2][4][8];  // [pixel][corner][channel]
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int p = warp * 16 + 4 * (2 * h + i) + ps;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const long long idx = gidx[q * kTile + p];
          if constexpr (kEarly) {
            if (vec) {
              unpack8(raw[2 * h + i][q], va[i][q]);
              continue;
            }
          }
          if (vec) {
            load8_aligned(x + idx + (c < Cin ? c : 0), va[i][q]);
          } else {
#pragma unroll
            for (int j = 0; j < 8; ++j)
              va[i][q][j] = c + j < Cin ? to_f(x[idx + c + j]) : 0.f;
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int p = warp * 16 + 4 * (2 * h + i) + ps, m = m0 + p;
        float w[4][4];  // [sample, column, d/dy, d/dx][corner]
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int q = 0; q < 4; ++q) w[r][q] = gw[(4 * r + q) * kTile + p];
        const float mk = s_mk[p];
        float pa = 0.f, pb = 0.f, pc = 0.f, cv[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float sv = 0.f, col = 0.f, gy = 0.f, gx = 0.f;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float v = va[i][q][j];
            sv = fmaf(w[0][q], v, sv);
            col = fmaf(w[1][q], v, col);
            gy = fmaf(w[2][q], v, gy);
            gx = fmaf(w[3][q], v, gx);
          }
          const float dd = dc[p * kDS + cg + j];
          pa = fmaf(dd, sv, pa);
          pb = fmaf(dd, gy, pb);
          pc = fmaf(dd, gx, pc);
          cv[j] = col;
        }
        store_packed8(at, p, cg, kCA, cv);
#pragma unroll
        for (int o = 16; o > 2; o >>= 1) {
          pa += __shfl_xor_sync(0xffffffffu, pa, o);
          pb += __shfl_xor_sync(0xffffffffu, pb, o);
          pc += __shfl_xor_sync(0xffffffffu, pc, o);
        }
        if (lane < 4 && m < npix) {
          const float ddy = pb * mk * s_pass[p], ddx = pc * mk;
          if (one_slice) {
            dmask[(long long)m * 9 + k] = pa;
            doff[(long long)m * 18 + 2 * k] = ddy;
            doff[(long long)m * 18 + 2 * k + 1] = ddx;
          } else {
            float* o3 = ompart + (((long long)slice * npix + m) * 9 + k) * 3;
            o3[0] = pa;
            o3[1] = ddy;
            o3[2] = ddx;
          }
        }
      }
    }
    // dW_k[c, n] += cols^T . ct on the tensor cores (K = the tile's
    // pixels), the cotangent tile read as its transpose, one 64-wide column
    // tile at a time; the products run on into the next tile
    fence_async_smem();
    __syncthreads();
#pragma unroll
    for (int t = 0; t < NT; ++t) mma_issue_kn(dw[t], at, cts, kp, t * 64);
    if (!two && j + 1 < j1) {  // the products read the one input set
      retire_dw();
      __syncthreads();
      load_inputs(m0 + kTile, 0);
      cp_async_commit();
    }
  }
  retire_dw();
#pragma unroll
  for (int t = 0; t < NT; ++t) {
#pragma unroll
    for (int v = 0; v < 32; ++v) {
      const int cc = c0 + frag_row(v), n = t * 64 + frag_col(v);
      if (cc < Cin && n < Cout)
        dwout[ch * cstride + ((long long)k * Cin + cc) * Cout + n] = dw[t][v];
    }
  }
  if (sums_bias) dbout[ch * cstride + nb] = bacc;
}

// ---------------------------------------------------------------------------
// dx by destination.  Pass A wrote dcols_k of every pixel (G [P, 9, cg]);
// the corners of every (pixel, tap) are listed by the pixel they land on
// (count, scan, fill: the transpose of the gather in CSR form), and each
// destination sums m . w_q . dcols over its list in key order (key = the
// source's row m * 9 + k of G).
// ---------------------------------------------------------------------------

// geometry of item i = m * 9 + k (pixel m, tap k); idx = the corners' pixels
template <typename TO>
__device__ __forceinline__ TapGeo item_geo(const TO* __restrict__ off,
                                           const TO* __restrict__ msk,
                                           long long i, int H, int W,
                                           float max_dy) {
  const int m = (int)(i / 9), k = (int)(i - 9LL * m);
  return tap_geo(m, k, to_f(off[2 * i]), to_f(off[2 * i + 1]),
                 to_f(msk[i]), H, W, 1, max_dy, 1.f);
}

// rowptr = the exclusive prefix sum of cnt [n] (rowptr [n + 1]), in two
// launches: the sum of each kScan-element block, then each block's scan
// from the sum of the blocks before it
constexpr int kScan = 1024;

__device__ __forceinline__ int block_sum(int v, int* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();  // red may still be read from a previous call
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = lane < (int)(blockDim.x >> 5) ? red[lane] : 0;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(kScan)
dcn_bwd_scan_sums(const int* __restrict__ cnt, int* __restrict__ bsum,
                  long long n) {
  __shared__ int red[32];
  const long long i = (long long)blockIdx.x * kScan + threadIdx.x;
  const int s = block_sum(i < n ? cnt[i] : 0, red);
  if (threadIdx.x == 0) bsum[blockIdx.x] = s;
}

__global__ void __launch_bounds__(kScan)
dcn_bwd_scan(const int* __restrict__ cnt, const int* __restrict__ bsum,
             int* __restrict__ rowptr, long long n) {
  __shared__ int red[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int base = 0;
  for (int j = threadIdx.x; j < (int)blockIdx.x; j += kScan) base += bsum[j];
  base = block_sum(base, red);
  const long long i = (long long)blockIdx.x * kScan + threadIdx.x;
  const int v = i < n ? cnt[i] : 0;
  int inc = v;  // inclusive scan within the warp
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o) inc += u;
  }
  __syncthreads();
  if (lane == 31) red[warp] = inc;
  __syncthreads();
  int before = 0;
  for (int w = 0; w < warp; ++w) before += red[w];
  if (i <= n) rowptr[i] = base + before + inc - v;
}

// ent[rowptr[d] ..] = (key, weight) of the corners that land on pixel d,
// in the order of their slots (decided by the atomics: the dx pass sorts)
template <typename TO>
__global__ void dcn_bwd_fill(const TO* __restrict__ off,
                             const TO* __restrict__ msk,
                             const int* __restrict__ rowptr,
                             int* __restrict__ cnt, int2* __restrict__ ent,
                             int B, int H, int W, float max_dy) {
  const long long n = 9LL * B * H * W;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const TapGeo g = item_geo(off, msk, i, H, W, max_dy);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float w = corner_weight(g, q);
      if (w != 0.f) {
        const int d = (int)g.idx[q];
        const int slot = atomicSub(cnt + d, 1) - 1;
        ent[rowptr[d] + slot] = make_int2((int)i, __float_as_int(w));
      }
    }
  }
}

// dx: a group of GS lanes per destination pixel, a lane 8 channels of G's
// row (16-byte loads) per channel pass.  A list of up to kList entries is
// put in key order in shared memory (each entry's rank = the keys below
// it) and summed four loads at a time; a longer one is walked by selecting
// the next key from device memory each step (slow; not seen at the
// flagship's sites).
constexpr int kDxThreads = 128;
constexpr int kList = 128;

template <typename T, typename OT, int GS>
__global__ void __launch_bounds__(kDxThreads)
dcn_bwd_dx(const T* __restrict__ gcol, const int* __restrict__ rowptr,
           const int2* __restrict__ ent, OT* __restrict__ dx, int npix,
           int Cin, int cg) {
  constexpr int NG = kDxThreads / GS;
  __shared__ int keys[NG][kList + 1];     // +1: groups on different banks
  __shared__ int2 sorted[NG][kList + 1];
  const int gi = threadIdx.x / GS, gl = threadIdx.x % GS;
  const int lane = threadIdx.x & 31;
  const unsigned gmask = (unsigned)((1ull << GS) - 1) << (lane & ~(GS - 1));
  const int d = blockIdx.x * NG + gi;
  int s = 0, n = 0;
  if (d < npix) {
    s = rowptr[d];
    n = rowptr[d + 1] - s;
  }
  const int2* e = ent + s;
  const int npass = cdiv(cg, GS * 8);
  const bool vec = (Cin & 7) == 0;
  auto put = [&](int c, const float (&acc)[8]) {
    if (d >= npix || c >= Cin) return;
    OT* o = dx + (long long)d * Cin + c;
    if (vec) {
      store8(o, acc);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (c + j < Cin) o[j] = from_f<OT>(acc[j]);
    }
  };
  if (n <= kList) {
    for (int i = gl; i < n; i += GS) keys[gi][i] = e[i].x;
    __syncwarp(gmask);
    for (int i = gl; i < n; i += GS) {
      const int2 v = e[i];
      int r = 0;
      for (int j = 0; j < n; ++j) r += keys[gi][j] < v.x;
      sorted[gi][r] = v;
    }
    __syncwarp(gmask);
    const int2* l = sorted[gi];
    for (int ps = 0; ps < npass; ++ps) {
      const int c = (ps * GS + gl) * 8;
      // G's row `key` at channels c.. (zeros past the row's end)
      auto load_row = [&](int key, float (&g)[8]) {
        if (c < cg) {
          load8_aligned(gcol + (long long)key * cg + c, g);
        } else {
#pragma unroll
          for (int j = 0; j < 8; ++j) g[j] = 0.f;
        }
      };
      float acc[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[j] = 0.f;
      int i = 0;
      for (; i + 4 <= n; i += 4) {
        float g[4][8];
#pragma unroll
        for (int u = 0; u < 4; ++u) load_row(l[i + u].x, g[u]);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float w = __int_as_float(l[i + u].y);
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[j] = fmaf(w, g[u][j], acc[j]);
        }
      }
      for (; i < n; ++i) {
        float g[8];
        load_row(l[i].x, g);
        const float w = __int_as_float(l[i].y);
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[j] = fmaf(w, g[j], acc[j]);
      }
      put(c, acc);
    }
  } else {
    for (int ps = 0; ps < npass; ++ps) {
      const int c = (ps * GS + gl) * 8;
      float acc[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[j] = 0.f;
      int prev = -1;
      for (int i = 0; i < n; ++i) {
        unsigned long long best = ~0ull;  // (key, weight) of the next key
        for (int j = gl; j < n; j += GS) {
          const int2 v = e[j];
          const unsigned long long kv =
              ((unsigned long long)(unsigned)v.x << 32) | (unsigned)v.y;
          if (v.x > prev && kv < best) best = kv;
        }
#pragma unroll
        for (int o = GS / 2; o > 0; o >>= 1) {
          const unsigned long long u = __shfl_xor_sync(gmask, best, o);
          best = u < best ? u : best;
        }
        prev = (int)(best >> 32);
        if (c < cg) {
          float g[8];
          load8_aligned(gcol + (long long)prev * cg + c, g);
          const float w = __int_as_float((int)(unsigned)best);
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[j] = fmaf(w, g[j], acc[j]);
        }
      }
      put(c, acc);
    }
  }
}

// dW and dbias = the chunks' partials [chunk][9 * Cin * Cout + Cout],
// summed in chunk order
__global__ void dcn_bwd_sum_chunks(const float* __restrict__ part,
                                   float* __restrict__ dw,
                                   float* __restrict__ dbias, long long nw,
                                   int Cout, int nchunks) {
  const long long n = nw + Cout;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int ch = 0; ch < nchunks; ++ch) s += part[ch * n + i];
    if (i < nw)
      dw[i] = s;
    else
      dbias[i - nw] = s;
  }
}

// dmask, doffset = the channel slices' partials [slice][P][9][3], summed
// in slice order
__global__ void dcn_bwd_sum_slices(const float* __restrict__ part,
                           float* __restrict__ doff, float* __restrict__ dmask,
                           long long npix, int nslices) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < npix * 9; i += (long long)gridDim.x * blockDim.x) {
    float a = 0.f, b = 0.f, c = 0.f;
    for (int s = 0; s < nslices; ++s) {
      const float* p = part + (s * npix * 9 + i) * 3;
      a += p[0];
      b += p[1];
      c += p[2];
    }
    const long long m = i / 9;
    const int k = (int)(i % 9);
    dmask[i] = a;
    doff[m * 18 + 2 * k] = b;
    doff[m * 18 + 2 * k + 1] = c;
  }
}

// ---------------------------------------------------------------------------
// Host: the launch plan (from the shapes alone) and the launches.
// ---------------------------------------------------------------------------

__host__ __device__ constexpr long long align256(long long v) {
  return (v + 255) / 256 * 256;
}

struct Plan {
  int kp, nt, nslices, nchunks, two, smem_a, cg, gs, nscan;
  // the workspace, in bytes from its base: chunk partials of dW and dbias,
  // slice partials of doffset and dmask (floats), G, corner counts, row
  // pointers, scan block sums, corner lists; its size
  long long o_om, o_g, o_cnt, o_rp, o_bs, o_ent, bytes;
  long long cstride;  // floats of one chunk's partial (0: one chunk)
};

// 0, or cudaErrorInvalidValue where the shape does not fit
int make_plan(int elem, int oelem, int B, int H, int W, int Cin, int Cout,
              Plan* pl) {
  if (B < 1 || H < 1 || W < 1 || Cin < 1 || Cout < 1 ||
      9LL * B * H * W >= (1LL << 31) / 4)  // keys and list slots in int
    return (int)cudaErrorInvalidValue;
  const long long npix = (long long)B * H * W;
  const int tiles = cdiv(npix, kTile);
  pl->kp = round_up(Cout, 16);
  pl->nt = cdiv(Cout, 64);
  if (pl->nt > 4) return (int)cudaErrorInvalidValue;
  // pass A: pixel chunks so that the grid fills one wave of blocks (more
  // would start a second, nearly empty wave)
  pl->nslices = cdiv(Cin, kCA);
  const int n = kGradPerSM * kSMs / (9 * pl->nslices);
  pl->nchunks = n < 1 ? 1 : (n > tiles ? tiles : n);
  // two input sets (the next tile loads during this one) where they fit
  pl->two = LayoutA(pl->kp, elem, oelem, true).bytes <= kSmemMax;
  pl->smem_a = LayoutA(pl->kp, elem, oelem, pl->two != 0).bytes;
  if (pl->smem_a > kSmemMax) return (int)cudaErrorInvalidValue;
  // dx: G's rows padded to 8 channels; lanes per destination: one per 8
  // channels, 8 to 32
  pl->cg = round_up(Cin, 8);
  pl->gs = 8;
  while (pl->gs < 32 && pl->gs * 8 < pl->cg) pl->gs *= 2;
  pl->nscan = cdiv(npix + 1, kScan);
  pl->cstride = pl->nchunks > 1 ? 9LL * Cin * Cout + Cout : 0;
  const long long part = pl->nchunks * pl->cstride;
  const long long om = pl->nslices > 1 ? pl->nslices * npix * 27 : 0;
  pl->o_om = align256(4 * part);
  pl->o_g = align256(pl->o_om + 4 * om);
  pl->o_cnt = align256(pl->o_g + npix * 9 * pl->cg * elem);
  pl->o_rp = align256(pl->o_cnt + 4 * npix);
  pl->o_bs = align256(pl->o_rp + 4 * (npix + 1));
  pl->o_ent = align256(pl->o_bs + 4LL * pl->nscan);
  pl->bytes = pl->o_ent + 8 * 36 * npix;  // at most four corners per item
  return 0;
}

template <typename K>
cudaError_t set_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <typename T, typename TO, int NT>
cudaError_t launch_grads(const T* x, const TO* off, const TO* msk,
                         const T* w, const T* ct, float* doff, float* dmask,
                         float* ompart, float* dwout, float* dbout, T* gcol,
                         int* cnt, int B, int H, int W, int Cin, int Cout,
                         float max_dy, float edge, const Plan& pl,
                         cudaStream_t st) {
  auto ka = dcn_bwd_grads<T, TO, NT>;
  cudaError_t err = set_smem(ka, pl.smem_a);
  if (err != cudaSuccess) return err;
  ka<<<dim3(pl.nchunks, 9, pl.nslices), kThreads, pl.smem_a, st>>>(
      x, off, msk, w, ct, doff, dmask, ompart, dwout, dbout, pl.cstride,
      gcol, pl.cg, cnt, B, H, W, Cin, Cout, max_dy, edge, pl.nchunks,
      pl.two);
  return cudaGetLastError();
}

// dx in f32, or in x's type (dx_in_t)
template <typename T, int GS>
cudaError_t launch_dx(const T* gcol, const int* rp, const int2* ent,
                      void* dx, bool dx_in_t, int npix, int Cin, int cg,
                      cudaStream_t st) {
  constexpr int per = kDxThreads / GS;
  if (dx_in_t)
    dcn_bwd_dx<T, T, GS><<<cdiv(npix, per), kDxThreads, 0, st>>>(
        gcol, rp, ent, static_cast<T*>(dx), npix, Cin, cg);
  else
    dcn_bwd_dx<T, float, GS><<<cdiv(npix, per), kDxThreads, 0, st>>>(
        gcol, rp, ent, static_cast<float*>(dx), npix, Cin, cg);
  return cudaGetLastError();
}

int grid_of(long long items, int threads) {
  const long long b = (items + threads - 1) / threads;
  return (int)(b < 4096 ? (b < 1 ? 1 : b) : 4096);
}

template <typename T, typename TO>
int launch_backward(const void* xv, const void* offv, const void* mskv,
                    const void* wv, const void* ctv, void* dx, bool dx_in_t,
                    float* doff, float* dmask, float* dw, float* dbias,
                    void* wsv, int B,
                    int H, int W, int Cin, int Cout, float max_dy,
                    float edge, cudaStream_t st) {
  Plan pl;
  int rc = make_plan((int)sizeof(T), (int)sizeof(TO), B, H, W, Cin, Cout,
                     &pl);
  if (rc) return rc;
  if (wsv == nullptr) return (int)cudaErrorInvalidValue;
  const T* x = static_cast<const T*>(xv);
  const TO* off = static_cast<const TO*>(offv);
  const TO* msk = static_cast<const TO*>(mskv);
  const T* w = static_cast<const T*>(wv);
  const T* ct = static_cast<const T*>(ctv);
  unsigned char* ws = static_cast<unsigned char*>(wsv);
  const long long npix = (long long)B * H * W;
  float* part = reinterpret_cast<float*>(ws);
  float* dwout = pl.cstride ? part : dw;
  float* dbout = pl.cstride ? part + 9LL * Cin * Cout : dbias;
  float* ompart =
      pl.nslices > 1 ? reinterpret_cast<float*>(ws + pl.o_om) : nullptr;
  T* gcol = reinterpret_cast<T*>(ws + pl.o_g);
  int* cnt = reinterpret_cast<int*>(ws + pl.o_cnt);
  int* rp = reinterpret_cast<int*>(ws + pl.o_rp);
  int* bs = reinterpret_cast<int*>(ws + pl.o_bs);
  int2* ent = reinterpret_cast<int2*>(ws + pl.o_ent);
  // pass A counts the corners that land on each pixel
  cudaError_t err = cudaMemsetAsync(cnt, 0, 4 * npix, st);
  if (err != cudaSuccess) return (int)err;

  switch (pl.nt) {
#define CP_GRADS(N)                                                         \
  case N:                                                                   \
    err = launch_grads<T, TO, N>(x, off, msk, w, ct, doff, dmask, ompart,   \
                                 dwout, dbout, gcol, cnt, B, H, W, Cin,     \
                                 Cout, max_dy, edge, pl, st);               \
    break;
    CP_GRADS(1)
    CP_GRADS(2)
    CP_GRADS(3)
    CP_GRADS(4)
#undef CP_GRADS
    default:
      err = cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;

  const int gi = grid_of(npix * 9, 256);
  dcn_bwd_scan_sums<<<pl.nscan, kScan, 0, st>>>(cnt, bs, npix);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  dcn_bwd_scan<<<pl.nscan, kScan, 0, st>>>(cnt, bs, rp, npix);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  dcn_bwd_fill<TO><<<gi, 256, 0, st>>>(off, msk, rp, cnt, ent, B, H, W,
                                       max_dy);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  switch (pl.gs) {
    case 8:
      err = launch_dx<T, 8>(gcol, rp, ent, dx, dx_in_t, (int)npix, Cin,
                            pl.cg, st);
      break;
    case 16:
      err = launch_dx<T, 16>(gcol, rp, ent, dx, dx_in_t, (int)npix, Cin,
                             pl.cg, st);
      break;
    default:
      err = launch_dx<T, 32>(gcol, rp, ent, dx, dx_in_t, (int)npix, Cin,
                             pl.cg, st);
  }
  if (err != cudaSuccess) return (int)err;

  if (pl.cstride) {
    const long long nw = 9LL * Cin * Cout;
    dcn_bwd_sum_chunks<<<grid_of(nw + Cout, 256), 256, 0, st>>>(
        part, dw, dbias, nw, Cout, pl.nchunks);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  if (ompart) {
    dcn_bwd_sum_slices<<<grid_of(npix * 9, 256), 256, 0, st>>>(
        ompart, doff, dmask, npix, pl.nslices);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // namespace

// The launch plan of a backward call: out[0] = the largest dynamic shared
// memory of its blocks in bytes (the caller checks it against the card's
// limit), out[1] = bytes of the workspace the caller allocates.  dtype,
// off_dtype as below.  Returns 0, or cudaErrorInvalidValue for a shape
// that does not fit.
extern "C" int cp_dcn_v2_backward_plan(int dtype, int off_dtype, int B,
                                       int H, int W, int Cin, int Cout,
                                       long long* out) {
  Plan pl;
  const int rc = make_plan(dtype == 1 ? 2 : 4, off_dtype == 1 ? 2 : 4, B, H,
                           W, Cin, Cout, &pl);
  if (rc) return rc;
  out[0] = pl.smem_a;
  out[1] = pl.bytes;
  return 0;
}

// dtype: 0 = float32, 1 = bfloat16 (x, w, ct); off_dtype: the same codes
// for offset [P, 18] and mask [P, 9] (bf16 offsets need bf16 x).  Outputs,
// written in full: dx [P, Cin] in f32, or in x's type where dx_in_x_type
// is nonzero; doffset [P, 18], dmask [P, 9], dw [9*Cin, Cout] and dbias
// [Cout] in f32.  ws: the workspace the plan asks for.  max_dy < 0:
// unclamped; edge: the clamp's gradient at exactly |dy| = max_dy.  Returns
// 0 or the CUDA error of the first launch that failed.
extern "C" int cp_dcn_v2_backward(int dtype, int off_dtype, const void* x,
                                  const void* off, const void* msk,
                                  const void* w, const void* ct, void* dx,
                                  int dx_in_x_type, void* doff, void* dmask,
                                  void* dw, void* dbias, void* ws, int B,
                                  int H, int W, int Cin, int Cout,
                                  float max_dy, float edge, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool dt = dx_in_x_type != 0;
  float* f[4] = {static_cast<float*>(doff), static_cast<float*>(dmask),
                 static_cast<float*>(dw), static_cast<float*>(dbias)};
  if (dtype == 0 && off_dtype == 0)
    return launch_backward<float, float>(x, off, msk, w, ct, dx, dt, f[0],
                                         f[1], f[2], f[3], ws, B, H, W, Cin,
                                         Cout, max_dy, edge, s);
  if (dtype == 1 && off_dtype == 0)
    return launch_backward<__nv_bfloat16, float>(
        x, off, msk, w, ct, dx, dt, f[0], f[1], f[2], f[3], ws, B, H, W, Cin,
        Cout, max_dy, edge, s);
  if (dtype == 1 && off_dtype == 1)
    return launch_backward<__nv_bfloat16, __nv_bfloat16>(
        x, off, msk, w, ct, dx, dt, f[0], f[1], f[2], f[3], ws, B, H, W, Cin,
        Cout, max_dy, edge, s);
  return (int)cudaErrorInvalidValue;
}
