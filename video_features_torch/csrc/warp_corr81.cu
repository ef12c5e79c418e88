// warp_corr81: PWC-Net's fused backward warp + 81-tap cost volume, written by
// hand for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas kernel video_features_tpu/ops/pallas_corr.py
// `warp_corr81_pallas` (:325, `_warp_corr81_kernel` :250):
//
//   out = corr81(f1, warp_backward(f2, flow))
//
// warp_backward samples f2 bilinearly at (x + u, y + v) in pixels, out-of-image
// corner taps weighted 0, and zeroes a pixel whose in-bounds weight sum is
// <= 0.999 (the reference's ones-channel mask). The warped f2 is never written
// to device memory. f1, f2 (B,H,W,C) float32 or bfloat16 (in any of the four
// pairs), flow (B,H,W,2) float32, out (B,H,W,81) in f1's type; fp32 sums.
//
// The 0.999 threshold: a pixel whose weight sum sits near 0.999 flips from
// zero to full value if the coordinate or weight arithmetic differs by one
// ulp from the plain version's (ops/warp.py `bilinear_sample`, `warp_backward`).
// So the coordinates, the floors, the fractions, the four corner weights, the
// mask sum and the value blend (0, then the corners (0,0), (0,1), (1,0), (1,1)
// in that order) are computed exactly as there, each product and sum rounded
// on its own (__fmul_rn / __fadd_rn / __fsub_rn: nvcc would otherwise contract
// a*b+c into one fma). The warped values then equal the plain version's bit
// for bit, in fp32.
//
// What bounds it: the bytes of corr81 (f1 and f2 read once, 81 outputs
// written) plus the flow, 8 bytes a pixel: under the fp32 ridge at every C.
// The design is corr81's (corr81_tile.cuh) with the f2 window replaced by the
// warped one:
// 1. Tiles and threads. 8 x (4*NX) output tiles (NX = 4, 3, 1, picked per
//    level by ops/corr.py `warp_corr81_plan`), 288 threads, at most 112
//    registers a thread (__launch_bounds__(288, 2)), so two blocks fit an SM.
// 2. Corner tables. Once per block, for each of the (8+8) x (TX+8) window
//    positions, the four corner pixel indices and weights in the plain
//    version's rounding; a position outside the image, a corner outside it and
//    a masked pixel get weight 0 and index -1 (the correlation's zero padding).
// 3. The warped window, one channel chunk at a time, in a ring of two fp32
//    stages laid out as corr81's. The corner reads of chunk k+1 are cp.async
//    copies (16 bytes fp32 / 8 bytes bf16 a corner, narrowed by the plan's
//    copy width; index -1 or channels past C zero-fill) into a staging area
//    in shared memory, issued with the f1 tile's copies before chunk k is
//    multiplied. After the multiply each thread blends the items it copied
//    (4 channels of one position: its own copies, so no barrier) into the
//    other stage. One __syncthreads per chunk.
// 4. The inner loop and the epilogue are corr81's: NX x per thread, one dy,
//    4-channel shared loads, one fmaf per channel in ascending order, the tile
//    stored coalesced. With zero flow the warped window is f2 itself, so the
//    output equals corr81's bit for bit.

#include "corr81_tile.cuh"

namespace {

constexpr int STAGES = 2;
constexpr int CORNERS = 4;

// Dynamic shared memory a launch needs: the corner tables (an int4 of indices
// and a float4 of weights per window position), the staging of the corner
// reads, and min(STAGES, chunks) ring stages with an fp32 window; or the
// TY x TX x 81 fp32 output tile that reuses them, whichever is larger.
__host__ __device__ inline int smem_bytes(int tx, int cc, int C, int s1, int s2) {
  const int npos = (TY + 2 * R) * (tx + 2 * R);
  const int chunks = (C + cc - 1) / cc;
  const int stages = chunks < STAGES ? chunks : STAGES;
  const int used = npos * 32 + CORNERS * npos * cc * s2 +
                   stages * ring(tx, cc, s1, 4).stage_bytes;
  const int out_bytes = TY * tx * K * 4;
  return used > out_bytes ? used : out_bytes;
}

// Issue the corner reads of one chunk. Item i is (window position p, group q
// of VEC channels), `groups` per position; corner k of item i goes to
// raw + k * plane + i * VEC values. WIDTH bytes per copy (16, 8, 4; 0 =
// synchronous element loads); a corner with index -1, or channels past C,
// are zero-filled.
template <int WIDTH, typename T2>
__device__ __forceinline__ void gather_w(unsigned char* raw, const int4* s_idx,
                                         const T2* __restrict__ f2, int npos, int plane,
                                         int groups, int c0, int C, size_t img) {
  constexpr int ITEM = VEC * (int)sizeof(T2);
  constexpr int BYTES = WIDTH > 0 ? WIDTH : (int)sizeof(T2);
  constexpr int PIECES = ITEM / BYTES;
  constexpr int ELEMS = BYTES / (int)sizeof(T2);
#pragma unroll 1
  for (int i = threadIdx.x; i < npos * groups; i += NTHREADS) {
    const int p = i / groups;
    const int c = c0 + (i - p * groups) * VEC;
    const int4 id4 = s_idx[p];
    const int ids[CORNERS] = {id4.x, id4.y, id4.z, id4.w};
    unsigned char* d = raw + i * ITEM;
#pragma unroll
    for (int k = 0; k < CORNERS; ++k) {
      const T2* s = f2 + img + (size_t)(ids[k] >= 0 ? ids[k] : 0) * C + c;
#pragma unroll
      for (int j = 0; j < PIECES; ++j) {
        const bool valid = ids[k] >= 0 && c + j * ELEMS < C;
        if constexpr (WIDTH > 0) {
          cp_async<WIDTH>(smem_addr(d + k * plane + j * BYTES), valid ? s + j * ELEMS : f2,
                          valid);
        } else {
          *reinterpret_cast<T2*>(d + k * plane + j * BYTES) = valid ? s[j] : from_f<T2>(0.f);
        }
      }
    }
  }
}

template <typename T2>
__device__ __forceinline__ void gather(int width, unsigned char* raw, const int4* s_idx,
                                       const T2* __restrict__ f2, int npos, int plane,
                                       int groups, int c0, int C, size_t img) {
  switch (width) {
    case 16:
      if constexpr (sizeof(T2) == 4)
        gather_w<16, T2>(raw, s_idx, f2, npos, plane, groups, c0, C, img);
      break;
    case 8: gather_w<8, T2>(raw, s_idx, f2, npos, plane, groups, c0, C, img); break;
    case 4: gather_w<4, T2>(raw, s_idx, f2, npos, plane, groups, c0, C, img); break;
    default: gather_w<0, T2>(raw, s_idx, f2, npos, plane, groups, c0, C, img); break;
  }
}

// Blend the items this thread gathered into the fp32 window `win` (row stride
// `ru` 16-byte units, `slot` bytes a position), in the plain version's order:
// v = 0, then v = v + corner * weight for the corners in order, each product
// and sum rounded on its own.
template <int HX, typename T2>
__device__ __forceinline__ void blend(unsigned char* win, int ru, int slot,
                                      const unsigned char* raw, const float4* s_wt,
                                      int npos, int plane, int groups) {
  constexpr int ITEM = VEC * (int)sizeof(T2);
#pragma unroll 1
  for (int i = threadIdx.x; i < npos * groups; i += NTHREADS) {
    const int p = i / groups;
    const float4 w4 = s_wt[p];
    const float wt[CORNERS] = {w4.x, w4.y, w4.z, w4.w};
    float v[VEC] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int k = 0; k < CORNERS; ++k) {
      const Vec c = ldv(reinterpret_cast<const T2*>(raw + k * plane + i * ITEM));
#pragma unroll
      for (int j = 0; j < VEC; ++j) v[j] = __fadd_rn(v[j], __fmul_rn(c.v[j], wt[k]));
    }
    const int row = p / HX, col = p - row * HX;
    *reinterpret_cast<float4*>(win + row * ru * 16 + col * slot + (i - p * groups) * 16) =
        make_float4(v[0], v[1], v[2], v[3]);
  }
}

template <int NX, typename T1, typename T2>
__global__ void __launch_bounds__(NTHREADS, 2)
warp_corr81_kernel(const T1* __restrict__ f1, const T2* __restrict__ f2,
                   const float* __restrict__ flow, T1* __restrict__ out, int H, int W, int C,
                   int cc, int w1, int w2) {
  constexpr int TX = XG * NX;
  constexpr int HX = TX + 2 * R;              // window columns
  constexpr int NPOS = (TY + 2 * R) * HX;     // window positions
  extern __shared__ __align__(16) unsigned char smem[];
  const Ring rg = ring(TX, cc, sizeof(T1), 4);  // the window is fp32
  int4* s_idx = reinterpret_cast<int4*>(smem);
  float4* s_wt = reinterpret_cast<float4*>(smem + NPOS * 16);
  unsigned char* raw = smem + NPOS * 32;
  const int plane = NPOS * cc * (int)sizeof(T2);  // staging bytes of one corner
  unsigned char* ring0 = raw + CORNERS * plane;

  const int x0 = blockIdx.x * TX;
  const int y0 = blockIdx.y * TY;
  const int b = blockIdx.z;
  const size_t img = (size_t)b * H * W * C;
  const Lane ln = lane();
  const int nchunks = (C + cc - 1) / cc;

  // corner indices and weights of every window position, in the order and
  // rounding of ops/warp.py bilinear_sample + warp_backward
  for (int p = threadIdx.x; p < NPOS; p += NTHREADS) {
    const int gy = y0 - R + p / HX;
    const int gx = x0 - R + p % HX;
    int idx[CORNERS] = {-1, -1, -1, -1};
    float wts[CORNERS] = {0.f, 0.f, 0.f, 0.f};
    if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
      const float* fl = flow + (((size_t)b * H + gy) * W + gx) * 2;
      const float x = __fadd_rn((float)gx, fl[0]);
      const float y = __fadd_rn((float)gy, fl[1]);
      const float fx = floorf(x), fy = floorf(y);
      const float wx = __fsub_rn(x, fx), wy = __fsub_rn(y, fy);
      const float omx = __fsub_rn(1.f, wx), omy = __fsub_rn(1.f, wy);
      const float w4[CORNERS] = {__fmul_rn(omy, omx), __fmul_rn(omy, wx),
                                 __fmul_rn(wy, omx), __fmul_rn(wy, wx)};
      float mask = 0.f;
#pragma unroll
      for (int k = 0; k < CORNERS; ++k) {
        const float xi = __fadd_rn(fx, (float)(k & 1));
        const float yi = __fadd_rn(fy, (float)(k >> 1));
        const bool inb = xi >= 0.f && xi <= (float)(W - 1) && yi >= 0.f &&
                         yi <= (float)(H - 1);
        wts[k] = inb ? w4[k] : 0.f;
        idx[k] = inb ? (int)yi * W + (int)xi : -1;
        mask = __fadd_rn(mask, wts[k]);
      }
      if (!(mask > 0.999f)) {
#pragma unroll
        for (int k = 0; k < CORNERS; ++k) { wts[k] = 0.f; idx[k] = -1; }
      }
    }
    s_idx[p] = make_int4(idx[0], idx[1], idx[2], idx[3]);
    s_wt[p] = make_float4(wts[0], wts[1], wts[2], wts[3]);
  }
  __syncthreads();

  auto groups = [&](int k) { return (min(cc, C - k * cc) + VEC - 1) / VEC; };
  // copies of chunk k: the corner reads into the staging, f1 into its stage
  auto issue = [&](int k) {
    gather<T2>(w2, raw, s_idx, f2, NPOS, plane, groups(k), k * cc, C, img);
    stage<T1>(w1, ring0 + (k % STAGES) * rg.stage_bytes + rg.f2_bytes, f1, TY, TX, rg.ru1,
              cc, y0, x0, k * cc, H, W, C, img);
    cp_async_commit();
  };
  // this thread's corner reads of chunk k have landed: blend them into its stage
  auto warp = [&](int k) {
    cp_async_wait<0>();
    blend<HX, T2>(ring0 + (k % STAGES) * rg.stage_bytes, rg.ru2, rg.slot2, raw, s_wt, NPOS,
                  plane, groups(k));
  };

  float acc[NX][D];
#pragma unroll
  for (int x = 0; x < NX; ++x)
#pragma unroll
    for (int dx = 0; dx < D; ++dx) acc[x][dx] = 0.f;

  issue(0);
  warp(0);
  for (int k = 0; k < nchunks; ++k) {
    __syncthreads();  // chunk k's window and f1 are in; chunk k-1's stage is free
    if (k + 1 < nchunks) issue(k + 1);
    tile_fma<NX, T1, float>(acc, ring0 + (k % STAGES) * rg.stage_bytes, rg, ln, cc,
                            min(cc, C - k * cc));
    if (k + 1 < nchunks) warp(k + 1);
  }
  __syncthreads();  // the tables, staging and ring are free: reuse them for the output
  store_tile<NX, T1>(acc, smem, out, ln, b, H, W, C, y0, x0);
}

template <int NX, typename T1, typename T2>
int launch(const void* f1, const void* f2, const float* flow, void* out, int B, int H, int W,
           int C, int cc, int w1, int w2, int grid_x, int grid_y, int smem,
           cudaStream_t stream) {
  constexpr int TX = XG * NX;
  // the plan must cover the image, give the kernel the memory it needs, and
  // copy at most one corner's VEC channels of f2 at a time
  if (grid_x * TX < W || grid_y * TY < H || B > 65535 ||
      smem < smem_bytes(TX, cc, C, sizeof(T1), sizeof(T2)) || smem > MAX_SMEM ||
      w2 > VEC * (int)sizeof(T2))
    return (int)cudaErrorInvalidValue;
  static unsigned long long attr_set = 0;  // one bit per device, per instantiation
  const cudaError_t e = allow_max_smem(warp_corr81_kernel<NX, T1, T2>, attr_set);
  if (e != cudaSuccess) return (int)e;
  warp_corr81_kernel<NX, T1, T2><<<dim3(grid_x, grid_y, B), NTHREADS, smem, stream>>>(
      static_cast<const T1*>(f1), static_cast<const T2*>(f2), flow, static_cast<T1*>(out),
      H, W, C, cc, w1, w2);
  return (int)cudaGetLastError();
}

template <typename T1, typename T2>
int launch_nx(int nx, const void* f1, const void* f2, const float* flow, void* out, int B,
              int H, int W, int C, int cc, int w1, int w2, int gx, int gy, int smem,
              cudaStream_t s) {
  switch (nx) {
    case 4: return launch<4, T1, T2>(f1, f2, flow, out, B, H, W, C, cc, w1, w2, gx, gy, smem, s);
    case 3: return launch<3, T1, T2>(f1, f2, flow, out, B, H, W, C, cc, w1, w2, gx, gy, smem, s);
    case 1: return launch<1, T1, T2>(f1, f2, flow, out, B, H, W, C, cc, w1, w2, gx, gy, smem, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// The launch plan, as the wrapper's `warp_corr81_plan` computes it and packs it:
// plan[] = {B, H, W, C, t1, t2, nx, cc, w1, w2, grid_x, grid_y, threads, smem},
// dtype codes 0 = float32, 1 = bfloat16 (flow is float32), w1 the f1 tile's
// copy width and w2 the corner reads' (bytes; 0 = element loads). A plan that
// does not cover the image or gives too little shared memory is refused.
// Returns cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for a bad type pair or plan.
extern "C" int warp_corr81_launch(const void* f1, const void* f2, const void* flow,
                                  void* out, const int* plan, void* stream) {
  const int B = plan[0], H = plan[1], W = plan[2], C = plan[3], t1 = plan[4], t2 = plan[5];
  const int nx = plan[6], cc = plan[7], w1 = plan[8], w2 = plan[9];
  const int grid_x = plan[10], grid_y = plan[11], threads = plan[12], smem = plan[13];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* fl = static_cast<const float*>(flow);
  if (B == 0 || H == 0 || W == 0) return 0;
  if (threads != NTHREADS || !width_ok(w1) || !width_ok(w2) || C < 1 || cc < 8 ||
      (cc & (cc - 1)))
    return (int)cudaErrorInvalidValue;
#define VFT_LAUNCH(A, Bt) \
  launch_nx<A, Bt>(nx, f1, f2, fl, out, B, H, W, C, cc, w1, w2, grid_x, grid_y, smem, s)
  if (t1 == 0 && t2 == 0) return VFT_LAUNCH(float, float);
  if (t1 == 1 && t2 == 1) return VFT_LAUNCH(__nv_bfloat16, __nv_bfloat16);
  if (t1 == 1 && t2 == 0) return VFT_LAUNCH(__nv_bfloat16, float);
  if (t1 == 0 && t2 == 1) return VFT_LAUNCH(float, __nv_bfloat16);
#undef VFT_LAUNCH
  return (int)cudaErrorInvalidValue;
}

// The dynamic shared-memory bytes of a launch, by the kernel's own layout, so
// the wrapper's plan can be checked against it on the card.
extern "C" int warp_corr81_smem_bytes(int nx, int cc, int C, int t1, int t2) {
  return smem_bytes(XG * nx, cc, C, t1 ? 2 : 4, t2 ? 2 : 4);
}

extern "C" const char* vft_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
