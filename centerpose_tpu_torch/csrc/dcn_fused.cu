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
// sigmoid-ed mask [B,H,W,9]: K2 is K1's second launch, the product kernel,
// instantiated for offsets and mask in the input type instead of K1's f32
// om scratch.  Every bilinear corner outside the image contributes zero;
// R < 0 means "no clamp".  The TPU layouts (row grouping, lane one-hots,
// the slab DMA) existed only to fit VMEM and the 128-lane vector unit; none
// of them is carried over.
//
// What bounds it on an H100: at dla_34 512x512 the 16 calls of one forward
// do 14.2 GFLOP of main product plus 4.6 GFLOP of om conv per image, and
// move about 43 MB in bf16 (activations in and out, weights once): the
// operations dominate, ~19 us per image at the bf16 tensor-core rate and
// ~0.28 ms at the f32 CUDA-core rate.  The design is the simple one: two
// launches per K1 call, one per K2 call.
//   1. the 27-channel om conv, f32 accumulate, writes the raw offsets and
//      the sigmoid-ed mask to an f32 scratch [B*H*W, 27]: f32 FMA for
//      float32 (dcn_om_f32_kernel), WMMA bf16 tiles with N padded to 32 for
//      bfloat16 (dcn_om_bf16_kernel).
//   2. an implicit GEMM over M = B*H*W pixels, N = Cout, K = 9*Cin.  A block
//      owns a 64-pixel x 64-channel output tile; for each tap it computes
//      the four bilinear corners of its pixels once, then for each
//      32-channel slice gathers the modulated samples into shared memory
//      (the im2col column never touches device memory), loads the matching
//      weight slice, and accumulates in f32: with FMA on the CUDA cores for
//      float32 (dcn_gemm_f32_kernel), with WMMA bf16 tiles on the tensor
//      cores for bfloat16 (dcn_gemm_bf16_kernel, samples rounded to bf16).
// No pipelining (each slice is loaded, then multiplied), each tap's input
// gathered again for every 64-channel column tile, 64x64 tiles even where a
// site has few pixels: it sits well above its bound; wgmma with TMA-fed
// stages is the next step.
//
// Layouts follow the JAX op: x NHWC [B,H,W,Cin], weight [3,3,Cin,Cout]
// (= row-major [9*Cin, Cout]), omw [3,3,Cin,27], y NHWC [B,H,W,Cout].
// Element types: float or bf16 for x, weights and y (all one type); the
// bias and the om scratch are always f32 (the reference adds its f32 bias
// before the cast to the output type).  Entry points return
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

namespace wmma = nvcuda::wmma;

constexpr int kOm = 27;          // offset/mask channels: 18 offsets + 9 mask
constexpr int kOmPix = 32;       // pixels per om block
constexpr int kOmCk = 32;        // input channels per om slice
constexpr int kBM = 64;          // GEMM tile: pixels
constexpr int kBN = 64;          // GEMM tile: output channels
constexpr int kBK = 32;          // GEMM tile: input channels per slice
constexpr int kThreads = 256;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

// om[p, 0:18] = offsets, om[p, 18:27] = sigmoid(mask logits), p = pixel.
__device__ __forceinline__ float om_out(int o, float v) {
  return o >= 18 ? 1.f / (1.f + expf(-v)) : v;
}

// float32: the om conv on the CUDA cores, f32 FMA.
__global__ void __launch_bounds__(kThreads)
dcn_om_f32_kernel(const float* __restrict__ x, const float* __restrict__ omw,
                  const float* __restrict__ omb, float* __restrict__ om,
                  int B, int H, int W, int Cin) {
  __shared__ float xs[kOmPix][kOmCk + 1];
  __shared__ float ws[kOmCk][kOm + 1];
  const int tid = threadIdx.x;
  const long long npix = (long long)B * H * W;
  const long long p0 = (long long)blockIdx.x * kOmPix;
  const int lp = tid % kOmPix;   // this thread's pixel in the tile
  const int og = tid / kOmPix;   // its outputs: og, og + 8, og + 16, og + 24
  float acc[4] = {0.f, 0.f, 0.f, 0.f};

  for (int k = 0; k < 9; ++k) {
    const int ky = k / 3 - 1, kx = k % 3 - 1;
    for (int c0 = 0; c0 < Cin; c0 += kOmCk) {
      for (int e = tid; e < kOmPix * kOmCk; e += kThreads) {
        const int pp = e / kOmCk, cc = e % kOmCk;
        const long long p = p0 + pp;
        float v = 0.f;
        if (p < npix && c0 + cc < Cin) {
          const int px = (int)(p % W);
          const long long t = p / W;
          const int py = (int)(t % H);
          const long long b = t / H;
          const int sy = py + ky, sx = px + kx;
          if (sy >= 0 && sy < H && sx >= 0 && sx < W)
            v = x[((b * H + sy) * W + sx) * Cin + c0 + cc];
        }
        xs[pp][cc] = v;
      }
      for (int e = tid; e < kOmCk * kOm; e += kThreads) {
        const int cc = e / kOm, o = e % kOm;
        ws[cc][o] = (c0 + cc < Cin)
            ? omw[((long long)k * Cin + c0 + cc) * kOm + o] : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int cc = 0; cc < kOmCk; ++cc) {
        const float xv = xs[lp][cc];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int o = og + 8 * j;
          if (o < kOm) acc[j] = fmaf(xv, ws[cc][o], acc[j]);
        }
      }
      __syncthreads();
    }
  }
  const long long p = p0 + lp;
  if (p < npix) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int o = og + 8 * j;
      if (o < kOm) om[p * kOm + o] = om_out(o, acc[j] + omb[o]);
    }
  }
}

// bfloat16: the om conv on the tensor cores, an implicit GEMM over
// M = pixels, N = 27 (padded to 32), K = 9*Cin with WMMA bf16 tiles and f32
// accumulators; f32 out.  Warp w owns rows 16*(w%4) .. +15 and columns
// 16*(w/4) .. +15 of the 64x32 tile.
__global__ void __launch_bounds__(kThreads)
dcn_om_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                   const __nv_bfloat16* __restrict__ omw,
                   const __nv_bfloat16* __restrict__ omb,
                   float* __restrict__ om, int B, int H, int W, int Cin) {
  constexpr int kN = 32, kLdA = kBK + 8, kLdB = kN + 8, kLdC = kN + 4;
  __shared__ __align__(32) __nv_bfloat16 As[kBM][kLdA];
  __shared__ __align__(32) __nv_bfloat16 Bs[kBK][kLdB];
  __shared__ __align__(32) float Cs[kBM][kLdC];
  __shared__ long long rowx[kBM];  // element offset of the tap's source pixel

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = warp % 4, wn = warp / 4;
  const long long npix = (long long)B * H * W;
  const long long m0 = (long long)blockIdx.x * kBM;
  const __nv_bfloat16 zero = __float2bfloat16(0.f);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
  wmma::fill_fragment(acc, 0.f);

  for (int k = 0; k < 9; ++k) {
    if (tid < kBM) {
      const long long m = m0 + tid;
      long long idx = -1;
      if (m < npix) {
        const int px = (int)(m % W);
        const long long t = m / W;
        const int py = (int)(t % H);
        const long long b = t / H;
        const int sy = py + k / 3 - 1, sx = px + k % 3 - 1;
        if (sy >= 0 && sy < H && sx >= 0 && sx < W)
          idx = ((b * H + sy) * W + sx) * Cin;
      }
      rowx[tid] = idx;
    }
    __syncthreads();
    for (int c0 = 0; c0 < Cin; c0 += kBK) {
#pragma unroll
      for (int r = 0; r < (kBM * kBK) / kThreads; ++r) {
        const int e = tid + r * kThreads;
        const int kk = e % kBK, mm = e / kBK;
        const long long i = rowx[mm];
        As[mm][kk] = (c0 + kk < Cin && i >= 0) ? x[i + c0 + kk] : zero;
      }
#pragma unroll
      for (int r = 0; r < (kBK * kN) / kThreads; ++r) {
        const int e = tid + r * kThreads;
        const int o = e % kN, kk = e / kN;
        Bs[kk][o] = (c0 + kk < Cin && o < kOm)
            ? omw[((long long)k * Cin + c0 + kk) * kOm + o] : zero;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kBK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> bf;
        wmma::load_matrix_sync(a, &As[wm * 16][kk], kLdA);
        wmma::load_matrix_sync(bf, &Bs[kk][wn * 16], kLdB);
        wmma::mma_sync(acc, a, bf, acc);
      }
      __syncthreads();
    }
  }

  wmma::store_matrix_sync(&Cs[wm * 16][wn * 16], acc, kLdC,
                          wmma::mem_row_major);
  __syncthreads();
  for (int e = tid; e < kBM * kOm; e += kThreads) {
    const int mm = e / kOm, o = e % kOm;
    const long long m = m0 + mm;
    if (m < npix)
      om[m * kOm + o] = om_out(o, Cs[mm][o] + __bfloat162float(omb[o]));
  }
}

// y[p, n] = bias[n] + sum_{k, c} W[k, c, n] * sample_k(p, c), where
// sample_k(p, c) = m_k(p) * sum over the 4 bilinear corners q of
// w_q * x[corner_q, c].  Offsets are read at off[p * ld_off + 2k (+1)],
// the mask at msk[p * ld_msk + k], both of type TO: f32 from K1's om
// scratch, the input type for K2; max_dy < 0 disables the clamp.

// The four bilinear corners of tap k for the tile's pixels m0 .. m0+kBM-1:
// element offset of each corner's channel row (-1 outside the image) and
// its weight times the mask.  Threads 0 .. kBM-1 each take one pixel.
template <typename TO>
__device__ __forceinline__ void tap_corners(
    int k, long long m0, long long npix, const TO* __restrict__ off,
    int ld_off, const TO* __restrict__ msk, int ld_msk, int H, int W,
    int Cin, float max_dy, long long (*cidx)[kBM], float (*cwt)[kBM]) {
  const int tid = threadIdx.x;
  if (tid >= kBM) return;
  const long long m = m0 + tid;
  long long idx[4] = {-1, -1, -1, -1};
  float wq[4] = {0.f, 0.f, 0.f, 0.f};
  if (m < npix) {
    const int px = (int)(m % W);
    const long long t = m / W;
    const int py = (int)(t % H);
    const long long b = t / H;
    float dy = to_f(off[m * ld_off + 2 * k]);
    const float dx = to_f(off[m * ld_off + 2 * k + 1]);
    if (max_dy >= 0.f) dy = fminf(fmaxf(dy, -max_dy), max_dy);
    const float mk = to_f(msk[m * ld_msk + k]);
    const float sy = (float)(py + k / 3 - 1) + dy;
    const float sx = (float)(px + k % 3 - 1) + dx;
    const float y0 = floorf(sy), x0 = floorf(sx);
    const float wy1 = sy - y0, wx1 = sx - x0;
    const float wy[2] = {1.f - wy1, wy1};
    const float wx[2] = {1.f - wx1, wx1};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float yc = y0 + (float)(q / 2), xc = x0 + (float)(q % 2);
      if (yc >= 0.f && yc <= (float)(H - 1) && xc >= 0.f &&
          xc <= (float)(W - 1)) {
        idx[q] = ((b * H + (long long)yc) * W + (long long)xc) * Cin;
        wq[q] = wy[q / 2] * wx[q % 2] * mk;
      }
    }
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    cidx[q][tid] = idx[q];
    cwt[q][tid] = wq[q];
  }
}

// The modulated sample of pixel mm of the tile at channel c (c < Cin).
template <typename T>
__device__ __forceinline__ float gather_sample(
    const T* __restrict__ x, long long (*cidx)[kBM], float (*cwt)[kBM],
    int mm, int c) {
  float v = 0.f;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const long long i = cidx[q][mm];
    if (i >= 0) v += cwt[q][mm] * to_f(x[i + c]);
  }
  return v;
}

// float32: the product on the CUDA cores, f32 FMA, 4x4 outputs a thread.
__global__ void __launch_bounds__(kThreads)
dcn_gemm_f32_kernel(const float* __restrict__ x, const float* __restrict__ off,
                    int ld_off, const float* __restrict__ msk, int ld_msk,
                    const float* __restrict__ wt,
                    const float* __restrict__ bias, float* __restrict__ y,
                    int B, int H, int W, int Cin, int Cout, float max_dy) {
  __shared__ float As[kBK][kBM + 4];
  __shared__ float Bs[kBK][kBN + 4];
  __shared__ long long cidx[4][kBM];
  __shared__ float cwt[4][kBM];

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const long long npix = (long long)B * H * W;
  const long long m0 = (long long)blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k = 0; k < 9; ++k) {
    tap_corners(k, m0, npix, off, ld_off, msk, ld_msk, H, W, Cin, max_dy,
                cidx, cwt);
    __syncthreads();
    for (int c0 = 0; c0 < Cin; c0 += kBK) {
#pragma unroll
      for (int r = 0; r < (kBM * kBK) / kThreads; ++r) {
        const int e = tid + r * kThreads;
        const int kk = e % kBK, mm = e / kBK;
        As[kk][mm] = (c0 + kk < Cin)
            ? gather_sample(x, cidx, cwt, mm, c0 + kk) : 0.f;
      }
#pragma unroll
      for (int r = 0; r < (kBK * kBN) / kThreads; ++r) {
        const int e = tid + r * kThreads;
        const int nn = e % kBN, kk = e / kBN;
        const int c = c0 + kk, n = n0 + nn;
        Bs[kk][nn] = (c < Cin && n < Cout)
            ? wt[((long long)k * Cin + c) * Cout + n] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kBK; ++kk) {
        float a[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = As[kk][ty * 4 + i];
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = Bs[kk][tx * 4 + j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long m = m0 + ty * 4 + i;
    if (m >= npix) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < Cout) y[m * Cout + n] = acc[i][j] + bias[n];
    }
  }
}

// bfloat16: the samples are rounded to bf16 (as the reference's im2col
// product takes them) and the product runs on the tensor cores through
// WMMA 16x16x16 tiles with f32 accumulators.  Warp w owns rows
// 16*(w%4) .. +15 and columns 32*(w/4) .. +31 of the 64x64 output tile.
template <typename TO>
__global__ void __launch_bounds__(kThreads)
dcn_gemm_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                     const TO* __restrict__ off, int ld_off,
                     const TO* __restrict__ msk, int ld_msk,
                     const __nv_bfloat16* __restrict__ wt,
                     const float* __restrict__ bias,
                     __nv_bfloat16* __restrict__ y, int B, int H, int W,
                     int Cin, int Cout, float max_dy) {
  constexpr int kLdA = kBK + 8, kLdB = kBN + 8, kLdC = kBN + 4;
  __shared__ __align__(32) __nv_bfloat16 As[kBM][kLdA];
  __shared__ __align__(32) __nv_bfloat16 Bs[kBK][kLdB];
  __shared__ __align__(32) float Cs[kBM][kLdC];
  __shared__ long long cidx[4][kBM];
  __shared__ float cwt[4][kBM];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = warp % 4, wn = warp / 4;
  const long long npix = (long long)B * H * W;
  const long long m0 = (long long)blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const __nv_bfloat16 zero = __float2bfloat16(0.f);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
  wmma::fill_fragment(acc[0], 0.f);
  wmma::fill_fragment(acc[1], 0.f);

  for (int k = 0; k < 9; ++k) {
    tap_corners(k, m0, npix, off, ld_off, msk, ld_msk, H, W, Cin, max_dy,
                cidx, cwt);
    __syncthreads();
    for (int c0 = 0; c0 < Cin; c0 += kBK) {
#pragma unroll
      for (int r = 0; r < (kBM * kBK) / kThreads; ++r) {
        const int e = tid + r * kThreads;
        const int kk = e % kBK, mm = e / kBK;
        As[mm][kk] = (c0 + kk < Cin)
            ? __float2bfloat16(gather_sample(x, cidx, cwt, mm, c0 + kk))
            : zero;
      }
#pragma unroll
      for (int r = 0; r < (kBK * kBN) / kThreads; ++r) {
        const int e = tid + r * kThreads;
        const int nn = e % kBN, kk = e / kBN;
        const int c = c0 + kk, n = n0 + nn;
        Bs[kk][nn] = (c < Cin && n < Cout)
            ? wt[((long long)k * Cin + c) * Cout + n] : zero;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kBK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> a;
        wmma::load_matrix_sync(a, &As[wm * 16][kk], kLdA);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major> bf;
          wmma::load_matrix_sync(bf, &Bs[kk][wn * 32 + j * 16], kLdB);
          wmma::mma_sync(acc[j], a, bf, acc[j]);
        }
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int j = 0; j < 2; ++j)
    wmma::store_matrix_sync(&Cs[wm * 16][wn * 32 + j * 16], acc[j], kLdC,
                            wmma::mem_row_major);
  __syncthreads();
  for (int e = tid; e < kBM * kBN; e += kThreads) {
    const int mm = e / kBN, nn = e % kBN;
    const long long m = m0 + mm;
    const int n = n0 + nn;
    if (m < npix && n < Cout)
      y[m * Cout + n] = __float2bfloat16(Cs[mm][nn] + bias[n]);
  }
}

unsigned blocks(long long n, int per_block) {
  return (unsigned)((n + per_block - 1) / per_block);
}

void launch_om(const float* x, const float* omw, const float* omb,
               float* om, int B, int H, int W, int Cin, cudaStream_t stream) {
  dcn_om_f32_kernel<<<blocks((long long)B * H * W, kOmPix), kThreads, 0,
                      stream>>>(x, omw, omb, om, B, H, W, Cin);
}

void launch_om(const __nv_bfloat16* x, const __nv_bfloat16* omw,
               const __nv_bfloat16* omb, float* om, int B, int H, int W,
               int Cin, cudaStream_t stream) {
  dcn_om_bf16_kernel<<<blocks((long long)B * H * W, kBM), kThreads, 0,
                       stream>>>(x, omw, omb, om, B, H, W, Cin);
}

void launch_gemm(const float* x, const float* off, int ld_off,
                 const float* msk, int ld_msk, const float* w,
                 const float* bias, float* y, int B, int H, int W, int Cin,
                 int Cout, float max_dy, cudaStream_t stream) {
  const dim3 grid(blocks((long long)B * H * W, kBM), blocks(Cout, kBN));
  dcn_gemm_f32_kernel<<<grid, kThreads, 0, stream>>>(
      x, off, ld_off, msk, ld_msk, w, bias, y, B, H, W, Cin, Cout, max_dy);
}

template <typename TO>
void launch_gemm(const __nv_bfloat16* x, const TO* off, int ld_off,
                 const TO* msk, int ld_msk, const __nv_bfloat16* w,
                 const float* bias, __nv_bfloat16* y, int B, int H, int W,
                 int Cin, int Cout, float max_dy, cudaStream_t stream) {
  const dim3 grid(blocks((long long)B * H * W, kBM), blocks(Cout, kBN));
  dcn_gemm_bf16_kernel<TO><<<grid, kThreads, 0, stream>>>(
      x, off, ld_off, msk, ld_msk, w, bias, y, B, H, W, Cin, Cout, max_dy);
}

template <typename T>
int launch_fused(const void* x, const void* omw, const void* omb,
                 const void* w, const void* bias, void* om, void* y, int B,
                 int H, int W, int Cin, int Cout, float max_dy,
                 cudaStream_t stream) {
  launch_om(static_cast<const T*>(x), static_cast<const T*>(omw),
            static_cast<const T*>(omb), static_cast<float*>(om), B, H, W, Cin,
            stream);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const float* omf = static_cast<const float*>(om);
  launch_gemm(static_cast<const T*>(x), omf, kOm, omf + 18, kOm,
              static_cast<const T*>(w), static_cast<const float*>(bias),
              static_cast<T*>(y), B, H, W, Cin, Cout, max_dy, stream);
  return (int)cudaGetLastError();
}

// K2: the product kernel on offsets [P, 18] and mask [P, 9] of type T.
template <typename T>
int launch_forward(const void* x, const void* off, const void* msk,
                   const void* w, const void* bias, void* y, int B, int H,
                   int W, int Cin, int Cout, float max_dy,
                   cudaStream_t stream) {
  launch_gemm(static_cast<const T*>(x), static_cast<const T*>(off), 18,
              static_cast<const T*>(msk), 9, static_cast<const T*>(w),
              static_cast<const float*>(bias), static_cast<T*>(y), B, H, W,
              Cin, Cout, max_dy, stream);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, omw, omb, w, y); bias is float32 in
// both, added to the f32 accumulator before the output's rounding.  om: f32
// scratch of B*H*W*27 elements.
// max_dy < 0: unclamped.  Returns cudaGetLastError() after the launches.
extern "C" int cp_dcn_v2_fused_forward(int dtype, const void* x,
                                       const void* omw, const void* omb,
                                       const void* w, const void* bias,
                                       void* om, void* y, int B, int H, int W,
                                       int Cin, int Cout, float max_dy,
                                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_fused<float>(x, omw, omb, w, bias, om, y, B, H, W, Cin,
                               Cout, max_dy, s);
  if (dtype == 1)
    return launch_fused<__nv_bfloat16>(x, omw, omb, w, bias, om, y, B, H, W,
                                       Cin, Cout, max_dy, s);
  return (int)cudaErrorInvalidValue;
}

// K2.  dtype: 0 = float32, 1 = bfloat16 (x, offset, mask, w, y); bias is
// float32.  offset [B*H*W, 18] (dy, dx per tap), mask [B*H*W, 9] already
// sigmoid-ed.  max_dy < 0: unclamped.  Returns cudaGetLastError().
extern "C" int cp_dcn_v2_forward(int dtype, const void* x, const void* off,
                                 const void* msk, const void* w,
                                 const void* bias, void* y, int B, int H,
                                 int W, int Cin, int Cout, float max_dy,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_forward<float>(x, off, msk, w, bias, y, B, H, W, Cin, Cout,
                                 max_dy, s);
  if (dtype == 1)
    return launch_forward<__nv_bfloat16>(x, off, msk, w, bias, y, B, H, W,
                                         Cin, Cout, max_dy, s);
  return (int)cudaErrorInvalidValue;
}
