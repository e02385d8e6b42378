// Modulated deformable convolution v2 (DCNv2) backward for Hopper.
//
// Replaces the three TPU backward kernels of
// centerpose_tpu/ops/dcn_pallas.py: _dcn_pallas_grouped_bwd_impl (K3, the
// fused backward of the row-grouped sites, W in {16, 32, 64}; kernel body
// _dcn_grouped_bwd_kernel), and the split backward of the W = 128 sites,
// _dcn_rowmajor_grads_impl (K4, pass A: doffset, dmask, dW, dbias; body
// _dcn_rowmajor_grads_kernel) and _dcn_rowmajor_dx_impl (K5, pass B: dx;
// body _dcn_rowmajor_dx_kernel).  One launch computes every gradient of
// the forward
//
//   y = bias + sum_k W_k^T . m_k . bilinear(x, p + p_k + (clip(dy_k,-R,R), dx_k))
//
// for a cotangent ct [B,H,W,Cout]:
//
//   dcols_k = ct . W_k^T                        [P, Cin] per tap k
//   dx     += transpose of the bilinear gather of m_k . dcols_k (4 corners,
//             zero outside the image)
//   dmask_k = sum_c dcols_k . sample_k          (sample before the mask)
//   ddy_k   = m_k . sum_c dcols_k . d(sample_k)/dy, 0 where |dy| > R
//   ddx_k   = m_k . sum_c dcols_k . d(sample_k)/dx
//   dW_k    = cols_k^T . ct                     (cols = m_k . sample_k, the
//                                                forward's im2col column)
//   dbias   = sum_p ct
//
// The clamp passes the gradient where -R <= dy <= R inclusive, as the TPU
// kernels' clamp_pass does.  cols are recomputed from x and the offsets,
// never stored.  The TPU kernels split this work by width and turn the
// gather and its transpose into one-hot and band matrix products only
// because the TPU's vector unit cannot gather across lanes and its VMEM
// must hold the whole slab (docs/DCN.md); on Hopper one design takes every
// width.  K3's "compact" mode only rounds x and W to bf16 to fit VMEM;
// under bf16 compute they already are bf16, so it has no counterpart here.
//
// Design (the simple one).  A block owns 64 pixels and one tap k (grid
// [P/64, 9]).  It keeps the pixels' cotangent rows in shared memory, and
// for each 32-channel slice of Cin
//   1. loads the slice of W_k and computes dcols [64 x 32] in f32: WMMA
//      bf16 tiles on the tensor cores for bfloat16 (ct and W are bf16
//      exactly, so nothing is rounded), FMA on the CUDA cores for float32;
//   2. gathers the four corners of every (pixel, channel), forms the sample
//      and its two derivatives, adds the dx contributions with atomicAdd
//      into an f32 buffer, keeps per-pixel partial sums of dmask and
//      doffset in registers, and writes the modulated sample, rounded to
//      the input type as the forward rounds it, to shared memory;
//   3. forms the block's dW_k slice partial [32 x Cout] = cols^T . ct (WMMA
//      or FMA) and adds it into an f32 dW with atomicAdd.
// doffset and dmask of (pixel, tap) are written once, by the block that
// owns them; dbias is summed by the tap-0 blocks.
//
// Atomics make the f32 sums of dx, dW and dbias run in an order that
// changes from run to run: results agree with a plain version to the
// rounding of f32 sums, not bit for bit.  The TPU's K5 is deterministic
// (a y-banded gather of the cotangent); a deterministic dx is later work.
//
// What bounds it on an H100: the products (dcols and dW) are twice the
// forward's (4 * P * 9 * Cin * Cout operations), ~28 GFLOP per image at
// dla_34 512x512, ~29 us at the bf16 tensor-core rate; the bytes (x, ct,
// offsets in; dx, doffset, dmask out) are ~60 MB per image in bf16,
// ~18 us.  This kernel is far from that: no pipelining, the corner gather
// repeated per tap, 4 scalar atomics per (pixel, tap, channel) for dx.
//
// Layouts follow the JAX op: x NHWC [B,H,W,Cin], offset [P, ld_off] with
// (dy, dx) of tap k at 2k, 2k+1, mask [P, ld_msk], weight [3,3,Cin,Cout]
// (= row-major [9*Cin, Cout]), ct [P, Cout].  x, weight and ct share one
// type T (float or bf16); offset and mask have type TO (float or bf16).
// Outputs are f32: dx [P, Cin], dW [9*Cin, Cout] and dbias [Cout] zeroed by
// the caller (accumulated with atomics), doffset [P, 18] and dmask [P, 9]
// written in full.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

namespace wmma = nvcuda::wmma;

constexpr int kBM = 64;        // pixels per block
constexpr int kBK = 32;        // input channels per slice
constexpr int kThreads = 256;  // 8 warps
constexpr int kRows = kBM * kBK / kThreads;  // (pixel, channel) items a thread

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float v) {
  return __float2bfloat16(v);
}

__host__ __device__ constexpr int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}

// Shared-memory layout of one block, in bytes from the dynamic base.  bf16
// runs WMMA and pads rows to keep its 32-byte fragment alignment; f32 runs
// FMA and pads rows by one element against bank conflicts.
struct Layout {
  int np;      // Cout padded to the WMMA depth (16) for bf16, Cout for f32
  int ld_ct;   // row stride (elements) of the cotangent tile [kBM][ld_ct]
  int ld_w;    // row stride of the weight slice [kBK][ld_w]
  int ld_dc;   // row stride of dcols [kBM][ld_dc] (f32)
  int ld_cs;   // row stride of the column tile [kBM][ld_cs]
  int ld_dw;   // row stride of the dW partial [kBK][ld_dw] (f32, bf16 only)
  int off_ct, off_w, off_dc, off_cs, off_dw, off_idx, off_f, bytes;

  __host__ __device__ Layout(int cout, bool wmma_path, int elem) {
    np = wmma_path ? round_up(cout, 16) : cout;
    ld_ct = wmma_path ? np + 8 : cout + 1;
    ld_w = ld_ct;
    ld_dc = kBK + 4;
    ld_cs = wmma_path ? kBK + 8 : kBK + 1;
    ld_dw = np + 4;
    off_ct = 0;
    off_w = round_up(off_ct + kBM * ld_ct * elem, 128);
    off_dc = round_up(off_w + kBK * ld_w * elem, 128);
    off_cs = round_up(off_dc + kBM * ld_dc * 4, 128);
    off_dw = round_up(off_cs + kBM * ld_cs * elem, 128);
    off_idx = round_up(off_dw + (wmma_path ? kBK * ld_dw * 4 : 0), 128);
    off_f = round_up(off_idx + 4 * kBM * 8, 128);
    bytes = off_f + 4 * kBM * 4;
  }
};

template <typename T>
__host__ __device__ constexpr bool uses_wmma() { return sizeof(T) == 2; }

// dcols [kBM x kBK] = ct [kBM x Cout] . W_slice^T, f32 into dc.
__device__ __forceinline__ void dcols_tile(const float* ct, const float* ws,
                                           float* dc, const Layout& L,
                                           int cout) {
  const int tid = threadIdx.x;
  const int cc = tid % kBK, g = tid / kBK;  // 8 groups of pixels
  float acc[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) acc[i] = 0.f;
  for (int n = 0; n < cout; ++n) {
    const float wv = ws[cc * L.ld_w + n];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
      acc[i] = fmaf(ct[(g + 8 * i) * L.ld_ct + n], wv, acc[i]);
  }
#pragma unroll
  for (int i = 0; i < kRows; ++i) dc[(g + 8 * i) * L.ld_dc + cc] = acc[i];
}

__device__ __forceinline__ void dcols_tile(const __nv_bfloat16* ct,
                                           const __nv_bfloat16* ws, float* dc,
                                           const Layout& L, int) {
  // 8 warps, one 16x16 output tile each: rows 16*(w%4), columns 16*(w/4).
  const int warp = threadIdx.x / 32;
  const int wm = warp % 4, wn = warp / 4;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
  wmma::fill_fragment(acc, 0.f);
  for (int kk = 0; kk < L.np; kk += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                   wmma::row_major> a;
    // B[n][c] = W_slice[c][n]: the slice read column-major
    wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                   wmma::col_major> b;
    wmma::load_matrix_sync(a, ct + wm * 16 * L.ld_ct + kk, L.ld_ct);
    wmma::load_matrix_sync(b, ws + wn * 16 * L.ld_w + kk, L.ld_w);
    wmma::mma_sync(acc, a, b, acc);
  }
  wmma::store_matrix_sync(dc + wm * 16 * L.ld_dc + wn * 16, acc, L.ld_dc,
                          wmma::mem_row_major);
}

// dW[k, c0 + c, n] += sum_p cols[p][c] * ct[p][n]  (f32 FMA; thread owns
// channel tid / 8 and outputs n = tid % 8 + 8 j of each 64-wide chunk).
__device__ __forceinline__ void dw_tile(const float* ct, const float* cs,
                                        float*, float* __restrict__ dw,
                                        const Layout& L, long long row0,
                                        int cin_left, int cout) {
  const int tid = threadIdx.x;
  const int cc = tid / 8, j0 = tid % 8;
  if (cc >= cin_left) return;
  for (int n0 = 0; n0 < cout; n0 += 64) {
    float acc[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j] = 0.f;
    for (int mm = 0; mm < kBM; ++mm) {
      const float cv = cs[mm * L.ld_cs + cc];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = n0 + j0 + 8 * j;
        if (n < cout) acc[j] = fmaf(cv, ct[mm * L.ld_ct + n], acc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + j0 + 8 * j;
      if (n < cout) atomicAdd(&dw[(row0 + cc) * cout + n], acc[j]);
    }
  }
}

// The same on the tensor cores: [kBK x np] = cols^T [kBK x kBM] . ct.
__device__ __forceinline__ void dw_tile(const __nv_bfloat16* ct,
                                        const __nv_bfloat16* cs, float* dwp,
                                        float* __restrict__ dw,
                                        const Layout& L, long long row0,
                                        int cin_left, int cout) {
  const int warp = threadIdx.x / 32;
  const int ntiles = 2 * (L.np / 16);
  for (int t = warp; t < ntiles; t += kThreads / 32) {
    const int ti = t % 2, tn = t / 2;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.f);
#pragma unroll
    for (int kk = 0; kk < kBM; kk += 16) {
      // A[c][p] = cols[p][c]: the column tile read column-major
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::col_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> b;
      wmma::load_matrix_sync(a, cs + kk * L.ld_cs + ti * 16, L.ld_cs);
      wmma::load_matrix_sync(b, ct + kk * L.ld_ct + tn * 16, L.ld_ct);
      wmma::mma_sync(acc, a, b, acc);
    }
    wmma::store_matrix_sync(dwp + ti * 16 * L.ld_dw + tn * 16, acc, L.ld_dw,
                            wmma::mem_row_major);
  }
  __syncthreads();
  for (int e = threadIdx.x; e < kBK * cout; e += kThreads) {
    const int cc = e / cout, n = e % cout;
    if (cc < cin_left)
      atomicAdd(&dw[(row0 + cc) * cout + n], dwp[cc * L.ld_dw + n]);
  }
}

template <typename T, typename TO>
__global__ void __launch_bounds__(kThreads)
dcn_bwd_kernel(const T* __restrict__ x, const TO* __restrict__ off,
               int ld_off, const TO* __restrict__ msk, int ld_msk,
               const T* __restrict__ wt, const T* __restrict__ ct,
               float* __restrict__ dx, float* __restrict__ doff,
               float* __restrict__ dmask, float* __restrict__ dw,
               float* __restrict__ dbias, int B, int H, int W, int Cin,
               int Cout, float max_dy) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L(Cout, uses_wmma<T>(), (int)sizeof(T));
  T* cts = reinterpret_cast<T*>(smem + L.off_ct);
  T* ws = reinterpret_cast<T*>(smem + L.off_w);
  float* dc = reinterpret_cast<float*>(smem + L.off_dc);
  T* cs = reinterpret_cast<T*>(smem + L.off_cs);
  float* dwp = reinterpret_cast<float*>(smem + L.off_dw);
  long long* cidx = reinterpret_cast<long long*>(smem + L.off_idx);  // [4][kBM]
  float* cf = reinterpret_cast<float*>(smem + L.off_f);  // wy, wx, mk, pass

  const int tid = threadIdx.x;
  const int k = blockIdx.y;
  const long long npix = (long long)B * H * W;
  const long long m0 = (long long)blockIdx.x * kBM;
  const T zero = from_f<T>(0.f);

  // the block's cotangent rows, zero past the last pixel and the padding
  for (int e = tid; e < kBM * L.np; e += kThreads) {
    const int mm = e / L.np, n = e % L.np;
    const long long m = m0 + mm;
    cts[mm * L.ld_ct + n] = (m < npix && n < Cout) ? ct[m * Cout + n] : zero;
  }
  // the tap's four corners per pixel (as the forward's tap_corners), the
  // fractional weights, the mask and whether the clamp passes the gradient
  if (tid < kBM) {
    const long long m = m0 + tid;
    long long idx[4] = {-1, -1, -1, -1};
    float wy1 = 0.f, wx1 = 0.f, mk = 0.f, pass = 0.f;
    if (m < npix) {
      const int px = (int)(m % W);
      const long long t = m / W;
      const int py = (int)(t % H);
      const long long b = t / H;
      float dy = to_f(off[m * ld_off + 2 * k]);
      const float dxo = to_f(off[m * ld_off + 2 * k + 1]);
      pass = 1.f;
      if (max_dy >= 0.f) {
        pass = (dy >= -max_dy && dy <= max_dy) ? 1.f : 0.f;
        dy = fminf(fmaxf(dy, -max_dy), max_dy);
      }
      mk = to_f(msk[m * ld_msk + k]);
      const float sy = (float)(py + k / 3 - 1) + dy;
      const float sx = (float)(px + k % 3 - 1) + dxo;
      const float y0 = floorf(sy), x0 = floorf(sx);
      wy1 = sy - y0;
      wx1 = sx - x0;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float yc = y0 + (float)(q / 2), xc = x0 + (float)(q % 2);
        if (yc >= 0.f && yc <= (float)(H - 1) && xc >= 0.f &&
            xc <= (float)(W - 1))
          idx[q] = ((b * H + (long long)yc) * W + (long long)xc) * Cin;
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) cidx[q * kBM + tid] = idx[q];
    cf[tid] = wy1;
    cf[kBM + tid] = wx1;
    cf[2 * kBM + tid] = mk;
    cf[3 * kBM + tid] = pass;
  }
  __syncthreads();

  if (k == 0) {  // dbias: the tap-0 blocks sum their cotangent rows
    for (int n = tid; n < Cout; n += kThreads) {
      float s = 0.f;
      for (int mm = 0; mm < kBM; ++mm) s += to_f(cts[mm * L.ld_ct + n]);
      atomicAdd(&dbias[n], s);
    }
  }

  // item r of this thread: pixel warp + 8 r, channel lane of the slice
  const int lane = tid % 32, warp = tid / 32;
  float p_mask[kRows], p_dy[kRows], p_dx[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) p_mask[r] = p_dy[r] = p_dx[r] = 0.f;

  for (int c0 = 0; c0 < Cin; c0 += kBK) {
    const int cin_left = min(kBK, Cin - c0);
    for (int e = tid; e < kBK * L.np; e += kThreads) {
      const int cc = e / L.np, n = e % L.np;
      ws[cc * L.ld_w + n] = (cc < cin_left && n < Cout)
          ? wt[((long long)k * Cin + c0 + cc) * Cout + n] : zero;
    }
    __syncthreads();
    dcols_tile(cts, ws, dc, L, Cout);
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int mm = warp + 8 * r, cc = lane, c = c0 + cc;
      float col = 0.f;
      if (m0 + mm < npix && cc < cin_left) {
        float v[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const long long i = cidx[q * kBM + mm];
          v[q] = i >= 0 ? to_f(x[i + c]) : 0.f;
        }
        const float wy1 = cf[mm], wx1 = cf[kBM + mm], mk = cf[2 * kBM + mm];
        const float wy0 = 1.f - wy1, wx0 = 1.f - wx1;
        const float s = wy0 * (wx0 * v[0] + wx1 * v[1]) +
                        wy1 * (wx0 * v[2] + wx1 * v[3]);
        const float gy = wx0 * (v[2] - v[0]) + wx1 * (v[3] - v[1]);
        const float gx = wy0 * (v[1] - v[0]) + wy1 * (v[3] - v[2]);
        const float d = dc[mm * L.ld_dc + cc];
        p_mask[r] = fmaf(d, s, p_mask[r]);
        p_dy[r] = fmaf(d, gy, p_dy[r]);
        p_dx[r] = fmaf(d, gx, p_dx[r]);
        const float dm = d * mk;
        const float wq[4] = {wy0 * wx0, wy0 * wx1, wy1 * wx0, wy1 * wx1};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const long long i = cidx[q * kBM + mm];
          if (i >= 0) atomicAdd(&dx[i + c], dm * wq[q]);
        }
        col = mk * s;
      }
      cs[mm * L.ld_cs + cc] = from_f<T>(col);
    }
    __syncthreads();
    dw_tile(cts, cs, dwp, dw, L, (long long)k * Cin + c0, cin_left, Cout);
    __syncthreads();
  }

  // reduce the per-lane partials over the slice's channels; lane 0 writes
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    float a = p_mask[r], b = p_dy[r], c = p_dx[r];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      a += __shfl_xor_sync(0xffffffffu, a, o);
      b += __shfl_xor_sync(0xffffffffu, b, o);
      c += __shfl_xor_sync(0xffffffffu, c, o);
    }
    const int mm = warp + 8 * r;
    const long long m = m0 + mm;
    if (lane == 0 && m < npix) {
      const float mk = cf[2 * kBM + mm], pass = cf[3 * kBM + mm];
      dmask[m * 9 + k] = a;
      doff[m * 18 + 2 * k] = b * mk * pass;
      doff[m * 18 + 2 * k + 1] = c * mk;
    }
  }
}

template <typename T, typename TO>
int launch_backward(const void* x, const void* off, int ld_off,
                    const void* msk, int ld_msk, const void* w,
                    const void* ct, float* dx, float* doff, float* dmask,
                    float* dw, float* dbias, int B, int H, int W, int Cin,
                    int Cout, float max_dy, cudaStream_t stream) {
  const Layout L(Cout, uses_wmma<T>(), (int)sizeof(T));
  auto kernel = dcn_bwd_kernel<T, TO>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L.bytes);
  if (err != cudaSuccess) return (int)err;
  const long long npix = (long long)B * H * W;
  const dim3 grid((unsigned)((npix + kBM - 1) / kBM), 9);
  kernel<<<grid, kThreads, L.bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const TO*>(off), ld_off,
      static_cast<const TO*>(msk), ld_msk, static_cast<const T*>(w),
      static_cast<const T*>(ct), dx, doff, dmask, dw, dbias, B, H, W, Cin,
      Cout, max_dy);
  return (int)cudaGetLastError();
}

}  // namespace

// The shared memory one block of the backward needs, in bytes (the caller
// checks it against the card's limit).  dtype as below.
extern "C" int cp_dcn_v2_backward_smem(int dtype, int Cout) {
  return dtype == 1 ? Layout(Cout, true, 2).bytes
                    : Layout(Cout, false, 4).bytes;
}

// dtype: 0 = float32, 1 = bfloat16 (x, w, ct); off_dtype: the same codes
// for offset and mask (bf16 offsets need bf16 x).  Offsets [P, ld_off],
// mask [P, ld_msk].  dx [P, Cin], dw [9*Cin, Cout] and dbias [Cout] f32 and
// zeroed by the caller; doffset [P, 18] and dmask [P, 9] f32.  max_dy < 0:
// unclamped.  Returns cudaGetLastError() after the launch.
extern "C" int cp_dcn_v2_backward(int dtype, int off_dtype, const void* x,
                                  const void* off, int ld_off,
                                  const void* msk, int ld_msk, const void* w,
                                  const void* ct, void* dx, void* doff,
                                  void* dmask, void* dw, void* dbias, int B,
                                  int H, int W, int Cin, int Cout,
                                  float max_dy, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* f[5] = {static_cast<float*>(dx), static_cast<float*>(doff),
                 static_cast<float*>(dmask), static_cast<float*>(dw),
                 static_cast<float*>(dbias)};
  if (dtype == 0 && off_dtype == 0)
    return launch_backward<float, float>(x, off, ld_off, msk, ld_msk, w, ct,
                                         f[0], f[1], f[2], f[3], f[4], B, H,
                                         W, Cin, Cout, max_dy, s);
  if (dtype == 1 && off_dtype == 0)
    return launch_backward<__nv_bfloat16, float>(
        x, off, ld_off, msk, ld_msk, w, ct, f[0], f[1], f[2], f[3], f[4], B,
        H, W, Cin, Cout, max_dy, s);
  if (dtype == 1 && off_dtype == 1)
    return launch_backward<__nv_bfloat16, __nv_bfloat16>(
        x, off, ld_off, msk, ld_msk, w, ct, f[0], f[1], f[2], f[3], f[4], B,
        H, W, Cin, Cout, max_dy, s);
  return (int)cudaErrorInvalidValue;
}
