// Hopper building blocks shared by the DCNv2 kernels (dcn_fused.cu, the
// bf16 forward; dcn_bwd.cu, the backward): the packed K-major operand
// layout and its 16-byte stores, cp.async, wgmma on shared-memory
// descriptors and its accumulator layout, and the bilinear tap geometry.
// Everything is in an anonymous namespace: each source that includes it is
// compiled into a library of its own.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSmemMax = 232448;   // dynamic shared memory a block may use
constexpr int kSMs = 132;

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
__host__ __device__ constexpr int cdiv(long long v, long long m) {
  return (int)((v + m - 1) / m);
}

__host__ __device__ constexpr int align128(int v) { return round_up(v, 128); }

// ---------------------------------------------------------------------------
// Operand tiles in shared memory: "K-major packed".  A tile of R rows by K
// (a multiple of 16) is cut into core matrices of 8 rows by 16 bytes, each
// stored as 128 contiguous bytes; core matrices follow each other along K,
// then along the rows.  This is wgmma's layout without swizzle (leading
// byte offset 128: the next core matrix along K; stride byte offset K * 16
// for bf16: the next 8 rows), and the FMA path reads the same layout.
// ---------------------------------------------------------------------------

template <typename T>
__host__ __device__ __forceinline__ int pack_off(int r, int k, int kdim) {
  constexpr int E = 16 / (int)sizeof(T);
  return ((r >> 3) * (kdim / E) + k / E) * (8 * E) + (r & 7) * E + (k % E);
}

// the 8 elements (r, k .. k + 7) of a packed tile (k a multiple of 8) =
// v, in the tile's type: one 16-byte store per core-matrix row
__device__ __forceinline__ void store8(float* p, const float (&v)[8]);
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&v)[8]);
template <typename T>
__device__ __forceinline__ void store_packed8(T* tile, int r, int k,
                                              int kdim, const float (&v)[8]) {
  if constexpr (sizeof(T) == 2) {
    store8(tile + pack_off<T>(r, k, kdim), v);
  } else {
    *reinterpret_cast<float4*>(tile + pack_off<T>(r, k, kdim)) =
        make_float4(v[0], v[1], v[2], v[3]);
    *reinterpret_cast<float4*>(tile + pack_off<T>(r, k + 4, kdim)) =
        make_float4(v[4], v[5], v[6], v[7]);
  }
}

__device__ __forceinline__ void cp_async16(void* s, const void* g) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(s);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(a),
               "l"(g)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}
// generic-proxy writes to shared memory (st.shared, cp.async) made visible
// to wgmma's reads (the async proxy); each thread, before the barrier
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// v[0..7] = the eight bf16 in u as float
__device__ __forceinline__ void unpack8(const uint4& u, float (&v)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
// v[0..7] = p[0..7] as float, p aligned to 16 bytes (no branch)
__device__ __forceinline__ void load8_aligned(const __nv_bfloat16* p,
                                              float (&v)[8]) {
  unpack8(*reinterpret_cast<const uint4*>(p), v);
}
__device__ __forceinline__ void load8_aligned(const float* p, float (&v)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// p[0..7] = v[0..7] in p's type, p aligned to 16 bytes
__device__ __forceinline__ void store8(float* p, const float (&v)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&v)[8]) {
  union {
    uint4 u;
    __nv_bfloat16 h[8];
  } pk;
#pragma unroll
  for (int j = 0; j < 8; ++j) pk.h[j] = __float2bfloat16(v[j]);
  *reinterpret_cast<uint4*>(p) = pk.u;
}

// ---------------------------------------------------------------------------
// The 64 x N product of one warpgroup, D += A . B^T with A [64 x kp] and B
// [N x kp] packed tiles.  D lives in registers in wgmma's accumulator
// layout: d[v] of thread t (t counted within its warpgroup) holds row
// 16 (t / 32) + (t % 32) / 4 + 8 ((v / 2) % 2), column 8 (v / 4) + 2 (t % 4)
// + v % 2.
// ---------------------------------------------------------------------------

__device__ __forceinline__ int frag_row(int v) {
  return ((threadIdx.x & 127) >> 5) * 16 + ((threadIdx.x & 31) >> 2) +
         8 * ((v >> 1) & 1);
}
__device__ __forceinline__ int frag_col(int v) {
  return 8 * (v >> 2) + 2 * (threadIdx.x & 3) + (v & 1);
}

template <int M>
__device__ __forceinline__ void fence_operands(float (&d)[M]) {
#pragma unroll
  for (int i = 0; i < M; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// K-major operand: lbo = 128 (the next core matrix along K), sbo = the
// next 8 rows; MN-major (transposed B): lbo = the next 8 along K, sbo = the
// next 16 bytes along N
__device__ __forceinline__ uint64_t smem_desc(const void* p, int lbo,
                                              int sbo) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  uint64_t d = (uint64_t)((a >> 4) & 0x3FFF);
  d |= (uint64_t)(((uint32_t)lbo >> 4) & 0x3FFF) << 16;
  d |= (uint64_t)(((uint32_t)sbo >> 4) & 0x3FFF) << 32;
  return d;  // base offset 0, layout type 0 (no swizzle)
}

#define CP_R8(i)                                                       \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),          \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// TA, TB: A, B MN-major (1) or K-major (0)
template <int TA, int TB>
__device__ __forceinline__ void wgmma_tile(float (&d)[32], uint64_t da,
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : CP_R8(0), CP_R8(8), CP_R8(16), CP_R8(24)
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_k64(float (&d)[32], uint64_t a0,
                                          uint64_t a1, uint64_t a2,
                                          uint64_t a3, uint64_t b0,
                                          uint64_t b1, uint64_t b2,
                                          uint64_t b3) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %40, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31"
      "}, %32, %36, p, 1, 1, %41, %42;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31"
      "}, %33, %37, p, 1, 1, %41, %42;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31"
      "}, %34, %38, p, 1, 1, %41, %42;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31"
      "}, %35, %39, p, 1, 1, %41, %42;\n"
      "}\n"
      : CP_R8(0), CP_R8(8), CP_R8(16), CP_R8(24)
      : "l"(a0), "l"(a1), "l"(a2), "l"(a3), "l"(b0), "l"(b1), "l"(b2),
        "l"(b3), "r"(1), "n"(TA), "n"(TB));
}

#undef CP_R8

// ---------------------------------------------------------------------------
// Geometry of one (pixel, tap): the clamped sample point, its four corners
// (index of the corner's x row, -1 outside the image), bilinear weights,
// mask, and the clamp's gradient factor.  The bf16 forward and the
// backward both take their corners from here, so the backward's pass A
// rebuilds the forward's im2col column bit for bit.
// ---------------------------------------------------------------------------

struct TapGeo {
  long long idx[4];
  float wq[4];
  float wy1, wx1, mk, pass;
  int y0, x0;
};

// pixel (b, py, px) of a [B, H, W] grid at tap k, with its raw offset
// (dy, dxo) and mask mk
__device__ __forceinline__ TapGeo tap_geo(int b, int py, int px, int k,
                                          float dy, float dxo, float mk,
                                          int H, int W, int Cin, float max_dy,
                                          float edge) {
  TapGeo g;
  g.pass = 1.f;
  if (max_dy >= 0.f) {
    const float a = fabsf(dy);
    g.pass = a > max_dy ? 0.f : (a == max_dy ? edge : 1.f);
    dy = fminf(fmaxf(dy, -max_dy), max_dy);
  }
  g.mk = mk;
  const float sy = (float)(py + k / 3 - 1) + dy;
  const float sx = (float)(px + k % 3 - 1) + dxo;
  const float y0 = floorf(sy), x0 = floorf(sx);
  g.wy1 = sy - y0;
  g.wx1 = sx - x0;
  // clamped before the int conversion; a clamped corner is outside anyway
  g.y0 = (int)fminf(fmaxf(y0, -4.f), (float)H + 4.f);
  g.x0 = (int)fminf(fmaxf(x0, -4.f), (float)W + 4.f);
  const float wy0 = 1.f - g.wy1, wx0 = 1.f - g.wx1;
  g.wq[0] = wy0 * wx0;
  g.wq[1] = wy0 * g.wx1;
  g.wq[2] = g.wy1 * wx0;
  g.wq[3] = g.wy1 * g.wx1;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int yc = g.y0 + q / 2, xc = g.x0 + q % 2;
    g.idx[q] = (yc >= 0 && yc < H && xc >= 0 && xc < W)
                   ? (((long long)b * H + yc) * W + xc) * Cin
                   : -1;
  }
  return g;
}

// pixel m (< 2^31) of a [B, H, W] grid
__device__ __forceinline__ TapGeo tap_geo(int m, int k, float dy, float dxo,
                                          float mk, int H, int W, int Cin,
                                          float max_dy, float edge) {
  const int t = m / W;
  return tap_geo(t / H, t % H, m - t * W, k, dy, dxo, mk, H, W, Cin, max_dy,
                 edge);
}

}  // namespace
