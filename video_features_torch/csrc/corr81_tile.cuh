// corr81_tile.cuh: the output tile of PWC-Net's 81-tap cost volume, shared by
// corr81.cu and warp_corr81.cu (each is built into its own library; both
// include this header, and the build cache hashes it with them).
//
// A block owns a TY x TX = 8 x (4*NX) output tile of one image; its 288
// threads are (8 rows) x (9 dy) x (4 x-groups of NX consecutive x). Per channel
// chunk of `cc` channels (a power of two, >= 8) a ring stage holds the
// (TY+8) x (TX+8) haloed window of the second input and the TY x TX tile of
// f1, channels innermost, each row padded to an odd number of 16-byte units
// so that the 8 lanes of a quarter-warp (8 output rows at one x) load from 8
// distinct bank groups. The inner loop (`tile_fma`) sums one fmaf per channel
// in ascending channel order, 4 channels per shared-memory load; the epilogue
// (`store_tile`) stages the fp32 tile through shared memory and stores each
// output row's TX*81 values coalesced. Both kernels share these, so with zero
// flow warp_corr81 equals corr81 bit for bit by construction.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int R = 4;
constexpr int D = 2 * R + 1;  // 9
constexpr int K = D * D;      // 81
constexpr int TY = 8;         // output rows per tile
constexpr int XG = 4;         // x-groups per tile row
constexpr int VEC = 4;        // channels per shared-memory load in the inner loop
constexpr int NTHREADS = TY * XG * D;  // 288
constexpr int MAX_SMEM = 232448;       // a block's shared-memory limit on Hopper

// One ring stage for a channel chunk of `cc` channels: the (TY+8) x (TX+8)
// window of the second input (s2 bytes a value), then the TY x TX f1 tile.
struct Ring {
  int ru1, ru2;             // 16-byte units per f1 / window row
  int slot1, slot2;         // bytes of one pixel's chunk
  int f2_bytes, stage_bytes;
};

__host__ __device__ inline Ring ring(int tx, int cc, int s1, int s2) {
  Ring r;
  r.slot1 = cc * s1;
  r.slot2 = cc * s2;
  r.ru1 = (tx * r.slot1 / 16) | 1;
  r.ru2 = ((tx + 2 * R) * r.slot2 / 16) | 1;
  r.f2_bytes = (TY + 2 * R) * r.ru2 * 16;
  r.stage_bytes = r.f2_bytes + TY * r.ru1 * 16;
  return r;
}

// A thread's place in the tile: output row fastest, then dy, then x-group.
struct Lane {
  int ty, dy, xg;
};

__device__ __forceinline__ Lane lane() {
  const int tid = threadIdx.x;
  return {tid % TY, (tid / TY) % D, tid / (TY * D)};
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

template <int BYTES>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src, bool valid) {
  const int n = valid ? BYTES : 0;  // src-size 0: the destination is zero-filled
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
                 "r"(n));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst), "l"(src),
                 "n"(BYTES), "r"(n));
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// VEC = 4 consecutive channels from shared memory, widened to float: one
// 16-byte (fp32) or 8-byte (bf16) load
struct Vec { float v[VEC]; };

__device__ __forceinline__ Vec ldv(const float* p) {
  const float4 u = *reinterpret_cast<const float4*>(p);
  return {{u.x, u.y, u.z, u.w}};
}
__device__ __forceinline__ Vec ldv(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return {{a.x, a.y, b.x, b.y}};
}

// Stage one channel chunk of an input's `rows` x `cols` pixel window, whose
// top-left pixel is (y0, x0) of image `img`, into `dst` (row stride `ru`
// 16-byte units). WIDTH bytes per copy (16, 8, 4; 0 = synchronous element
// loads). The copies form a [pixel][piece] array; thread (p, q) of a P x Q
// grid (Q = min(pieces, 32)) takes pixels p, p+P, ... and pieces q, q+Q, ...,
// so a pixel's address is worked out once for all of its pieces, and Q
// neighbouring threads copy neighbouring 16-byte pieces of one pixel.
template <int WIDTH, typename T>
__device__ __forceinline__ void stage_w(unsigned char* dst, const T* __restrict__ src,
                                        int rows, int cols, int ru, int cc, int y0, int x0,
                                        int c0, int H, int W, int C, size_t img) {
  constexpr int BYTES = WIDTH > 0 ? WIDTH : (int)sizeof(T);
  constexpr int ELEMS = BYTES / (int)sizeof(T);
  const int pieces = cc / ELEMS;  // a power of two
  const int q_lanes = pieces < 32 ? pieces : 32;
  const int p_lanes = NTHREADS / q_lanes;  // NTHREADS = 9 * 32
  const int q = threadIdx.x % q_lanes;
  const int slot = cc * (int)sizeof(T);
#pragma unroll 1  // unrolled, the copies' addresses would all be live at once
  for (int pix = threadIdx.x / q_lanes; pix < rows * cols; pix += p_lanes) {
    const int row = pix / cols, col = pix - row * cols;
    const int y = y0 + row, x = x0 + col;
    const bool inside = y >= 0 && y < H && x >= 0 && x < W;
    const T* s = src + img + ((size_t)(inside ? y : 0) * W + (inside ? x : 0)) * C + c0;
    unsigned char* d = dst + row * ru * 16 + col * slot;
#pragma unroll 1
    for (int j = q; j < pieces; j += q_lanes) {
      const int c = j * ELEMS;
      const bool valid = inside && c0 + c < C;
      if constexpr (WIDTH > 0) {
        cp_async<WIDTH>(smem_addr(d + j * BYTES), valid ? s + c : src, valid);
      } else {
        *reinterpret_cast<T*>(d + j * BYTES) = valid ? s[c] : from_f<T>(0.f);
      }
    }
  }
}

template <typename T>
__device__ __forceinline__ void stage(int width, unsigned char* dst, const T* __restrict__ src,
                                      int rows, int cols, int ru, int cc, int y0, int x0,
                                      int c0, int H, int W, int C, size_t img) {
  switch (width) {
    case 16: stage_w<16>(dst, src, rows, cols, ru, cc, y0, x0, c0, H, W, C, img); break;
    case 8: stage_w<8>(dst, src, rows, cols, ru, cc, y0, x0, c0, H, W, C, img); break;
    case 4: stage_w<4>(dst, src, rows, cols, ru, cc, y0, x0, c0, H, W, C, img); break;
    default: stage_w<0>(dst, src, rows, cols, ru, cc, y0, x0, c0, H, W, C, img); break;
  }
}

// acc[x][dx] += f1[ty, xg*NX + x, c] * win[ty + dy, xg*NX + x + dx, c] for the
// chunk's first `cn` channels, one fmaf per channel in ascending order. `st` is
// the ring stage; channels past C are zero up to a multiple of VEC.
template <int NX, typename T1, typename T2>
__device__ __forceinline__ void tile_fma(float (&acc)[NX][D], const unsigned char* st,
                                         const Ring& rg, const Lane& ln, int cc, int cn) {
  const T2* r2 = reinterpret_cast<const T2*>(st + (ln.ty + ln.dy) * rg.ru2 * 16 +
                                             ln.xg * NX * rg.slot2);
  const T1* r1 = reinterpret_cast<const T1*>(st + rg.f2_bytes + ln.ty * rg.ru1 * 16 +
                                             ln.xg * NX * rg.slot1);
  for (int q = 0; q < cn; q += VEC) {
    Vec a[NX];
#pragma unroll
    for (int x = 0; x < NX; ++x) a[x] = ldv(r1 + x * cc + q);
#pragma unroll
    for (int p = 0; p < NX + 2 * R; ++p) {
      const Vec v = ldv(r2 + p * cc + q);
#pragma unroll
      for (int x = 0; x < NX; ++x) {
        const int dx = p - x;
        if (dx >= 0 && dx < D) {
#pragma unroll
          for (int j = 0; j < VEC; ++j) acc[x][dx] = fmaf(a[x].v[j], v.v[j], acc[x][dx]);
        }
      }
    }
  }
}

// Scale the sums by 1/C and store the tile at (y0, x0) of image b: staged
// through `smem` (free for TY*TX*81 floats: the caller syncs first), then each
// output row's contiguous run of TX*81 values is stored coalesced.
template <int NX, typename T1>
__device__ __forceinline__ void store_tile(const float (&acc)[NX][D], unsigned char* smem,
                                           T1* __restrict__ out, const Lane& ln, int b,
                                           int H, int W, int C, int y0, int x0) {
  constexpr int TX = XG * NX;
  const int tid = threadIdx.x;
  float* so = reinterpret_cast<float*>(smem);
  const float scale = 1.0f / (float)C;
#pragma unroll
  for (int x = 0; x < NX; ++x)
#pragma unroll
    for (int dx = 0; dx < D; ++dx)
      so[(ln.ty * TX + ln.xg * NX + x) * K + ln.dy * D + dx] = acc[x][dx] * scale;
  __syncthreads();

  const int nx = min(TX, W - x0);
  const int ny = min(TY, H - y0);
  for (int row = 0; row < ny; ++row) {
    T1* o = out + (((size_t)b * H + y0 + row) * W + x0) * K;
    const float* src = so + row * TX * K;
    for (int i = tid; i < nx * K; i += NTHREADS) o[i] = from_f<T1>(src[i]);
  }
}

// Let `kernel` take up to MAX_SMEM of dynamic shared memory on the current
// device; `done` holds one bit per device already set.
template <typename Kernel>
cudaError_t allow_max_smem(Kernel kernel, unsigned long long& done) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 64 && ((done >> dev) & 1ull)) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
  if (e == cudaSuccess && dev < 64) done |= 1ull << dev;
  return e;
}

// A copy width the staging takes: 16, 8 or 4 bytes, or 0 for element loads.
inline bool width_ok(int w) { return w == 0 || w == 4 || w == 8 || w == 16; }

}  // namespace
