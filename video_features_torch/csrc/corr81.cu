// corr81: PWC-Net's 81-tap cost volume, written by hand for Hopper (sm_90a).
//
// Replaces the JAX package's two Pallas kernels of the same function,
// video_features_tpu/ops/pallas_corr.py `corr81_pallas` (:85, one block per
// image, levels <= 16x16) and `corr81_pallas_tiled` (:138, 16x16 tiles that
// read a 24x24 f2 halo). One kernel serves every pyramid level.
//
//   out[b,y,x,k] = (sum_c f1[b,y,x,c] * f2[b,y+dy,x+dx,c]) * (1/C)
//   dy, dx in [-4, 4], k = (dy+4)*9 + (dx+4), f2 zero outside the image.
//
// f1, f2 (B,H,W,C) float32 or bfloat16, in any of the four pairs; out
// (B,H,W,81) in f1's type. Sums are fp32, one fmaf per channel in ascending
// channel order. The ring layout, inner loop and epilogue are corr81_tile.cuh's,
// which warp_corr81.cu shares, so zero flow there equals this bit for bit.
//
// The bound: per pixel the function must read C values of f1 and C of f2 and
// write 81 values, (2C + 81)*4 bytes in fp32, and it does 162*C flops: under
// the card's fp32 ridge (67 TFLOP/s over 3.35 TB/s = 20 flop/byte) at every
// C, so bytes bound it. What the design does about each way a kernel falls
// short of that bound:
//
// 1. f2 re-reads. A block owns a TY x TX = 8 x (4*NX) output tile of one image
//    and stages the (TY+8) x (TX+8) haloed f2 window and the tile's f1 in
//    shared memory, one channel chunk at a time. Each f2 value comes from L2
//    or device memory (TY+8)(TX+8)/(TY*TX) times: 3.0x at 8x16, 3.3x at 8x12
//    (a 32-wide strip of one output row read it 11.25x).
// 2. Shared-memory loads per FMA. A thread owns NX consecutive x of one output
//    row and one dy, with 9*NX accumulators. Per 4 channels it reads NX f1 and
//    NX+8 f2 vectors of 16 bytes (8 in bf16) for 36*NX FMAs: 0.11 loads per
//    FMA at NX=4, against 1.1 scalar loads per FMA with one x per lane.
//    Channels are innermost in shared memory. Every staged row (the pixels of
//    one window row, one chunk of channels each) is padded to an odd number
//    of 16-byte units, and the 8 lanes of each quarter-warp are 8 consecutive
//    output rows at one x, so their 16-byte loads fall on 8 distinct bank
//    groups (lanes of one warp that share a row share an address).
// 3. Staging overlaps compute. Copies are cp.async into a ring of up to 3
//    chunks, one __syncthreads per chunk: chunk k+2 is in flight while chunk
//    k is multiplied. The chunk (a power of two, >= 8 channels) comes from the
//    launch plan: as large as the shared memory of the blocks an SM must hold
//    allows, and at most C/2 when the grid runs in more than one wave. Halo
//    pixels outside the image are copied with src-size 0 (zero fill) from a
//    clamped, valid address: that is the zero padding, with no padded copy of
//    f2 and no branch on data. bf16 stays bf16 in shared memory and is widened
//    at the FMA. Each input's copy width (16, 8 or 4 bytes; 0 = plain loads
//    when even 4 is impossible, bf16 with an odd C) comes from the plan, by
//    C*itemsize and the pointer's alignment.
// 4. Idle lanes at narrow levels. NX is 4, 3 or 1 (tiles 8x16, 8x12, 8x4),
//    picked per level by the plan (ops/corr.py `corr81_plan`) for the least
//    shared-memory time on the busiest SM; every block has 288 threads (8 rows
//    x 4 x-groups x 9 dy), whole warps, and at most 96 registers a thread, so
//    two blocks fit an SM. Rows of a tile below the image still run (the
//    4-row level 6 idles half its lanes).
// 5. Its time is the kernel's own: chip_smoke.py times it in a CUDA graph,
//    apart from the wrapper's host cost.
//
// Epilogue: the ring's shared memory is reused to stage the tile's TY*TX*81
// outputs, and each output row's contiguous run of TX*81 values is stored
// coalesced (the output is 56% of the bytes at level 2).
// No tensor cores: the fp32 tolerance (rtol 1e-5) rules out TF32.

#include "corr81_tile.cuh"

namespace {

constexpr int STAGES = 3;

// Dynamic shared memory a launch needs: min(STAGES, chunks) ring stages, or the
// TY x TX x 81 fp32 output tile that reuses them, whichever is larger.
__host__ __device__ inline int smem_bytes(int tx, int cc, int C, int s1, int s2) {
  const int chunks = (C + cc - 1) / cc;
  const int ring_bytes = (chunks < STAGES ? chunks : STAGES) * ring(tx, cc, s1, s2).stage_bytes;
  const int out_bytes = TY * tx * K * 4;
  return ring_bytes > out_bytes ? ring_bytes : out_bytes;
}

template <int NX, typename T1, typename T2>
__global__ void __launch_bounds__(NTHREADS, 2)
corr81_kernel(const T1* __restrict__ f1, const T2* __restrict__ f2, T1* __restrict__ out,
              int H, int W, int C, int cc, int w1, int w2) {
  constexpr int TX = XG * NX;
  extern __shared__ __align__(16) unsigned char smem[];
  const Ring rg = ring(TX, cc, sizeof(T1), sizeof(T2));

  const int x0 = blockIdx.x * TX;
  const int y0 = blockIdx.y * TY;
  const int b = blockIdx.z;
  const size_t img = (size_t)b * H * W * C;
  const Lane ln = lane();  // see note, point 2
  const int nchunks = (C + cc - 1) / cc;

  // stage channel chunk k of the f2 window and the f1 tile into its ring slot
  auto load_chunk = [&](int k) {
    unsigned char* st = smem + (k % STAGES) * rg.stage_bytes;
    stage<T2>(w2, st, f2, TY + 2 * R, TX + 2 * R, rg.ru2, cc, y0 - R, x0 - R, k * cc, H, W,
              C, img);
    stage<T1>(w1, st + rg.f2_bytes, f1, TY, TX, rg.ru1, cc, y0, x0, k * cc, H, W, C, img);
  };

  float acc[NX][D];
#pragma unroll
  for (int x = 0; x < NX; ++x)
#pragma unroll
    for (int dx = 0; dx < D; ++dx) acc[x][dx] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nchunks) load_chunk(s);
    cp_async_commit();
  }
  for (int k = 0; k < nchunks; ++k) {
    cp_async_wait<STAGES - 2>();  // this thread's copies of chunk k have landed
    __syncthreads();              // everyone's have, and chunk k-1's slot is free
    if (k + STAGES - 1 < nchunks) load_chunk(k + STAGES - 1);
    cp_async_commit();
    // channels past C are zero-filled up to VEC
    tile_fma<NX, T1, T2>(acc, smem + (k % STAGES) * rg.stage_bytes, rg, ln, cc,
                         min(cc, C - k * cc));
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: reuse it for the output tile
  store_tile<NX, T1>(acc, smem, out, ln, b, H, W, C, y0, x0);
}

template <int NX, typename T1, typename T2>
int launch(const void* f1, const void* f2, void* out, int B, int H, int W, int C, int cc,
           int w1, int w2, int grid_x, int grid_y, int smem, cudaStream_t stream) {
  constexpr int TX = XG * NX;
  // the plan must cover the image and give the kernel the memory it needs
  if (grid_x * TX < W || grid_y * TY < H || B > 65535 ||
      smem < smem_bytes(TX, cc, C, sizeof(T1), sizeof(T2)) || smem > MAX_SMEM)
    return (int)cudaErrorInvalidValue;
  static unsigned long long attr_set = 0;  // one bit per device, per instantiation
  const cudaError_t e = allow_max_smem(corr81_kernel<NX, T1, T2>, attr_set);
  if (e != cudaSuccess) return (int)e;
  corr81_kernel<NX, T1, T2><<<dim3(grid_x, grid_y, B), NTHREADS, smem, stream>>>(
      static_cast<const T1*>(f1), static_cast<const T2*>(f2), static_cast<T1*>(out),
      H, W, C, cc, w1, w2);
  return (int)cudaGetLastError();
}

template <typename T1, typename T2>
int launch_nx(int nx, const void* f1, const void* f2, void* out, int B, int H, int W,
              int C, int cc, int w1, int w2, int gx, int gy, int smem, cudaStream_t s) {
  switch (nx) {
    case 4: return launch<4, T1, T2>(f1, f2, out, B, H, W, C, cc, w1, w2, gx, gy, smem, s);
    case 3: return launch<3, T1, T2>(f1, f2, out, B, H, W, C, cc, w1, w2, gx, gy, smem, s);
    case 1: return launch<1, T1, T2>(f1, f2, out, B, H, W, C, cc, w1, w2, gx, gy, smem, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// The launch plan, as the wrapper's `corr81_plan` computes it and packs it:
// plan[] = {B, H, W, C, t1, t2, nx, cc, w1, w2, grid_x, grid_y, threads, smem},
// dtype codes 0 = float32, 1 = bfloat16, copy widths w1/w2 in bytes. A plan
// that does not cover the image or gives too little shared memory is refused.
// Returns cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for a bad type pair or plan.
extern "C" int corr81_launch(const void* f1, const void* f2, void* out, const int* plan,
                             void* stream) {
  const int B = plan[0], H = plan[1], W = plan[2], C = plan[3], t1 = plan[4], t2 = plan[5];
  const int nx = plan[6], cc = plan[7], w1 = plan[8], w2 = plan[9];
  const int grid_x = plan[10], grid_y = plan[11], threads = plan[12], smem = plan[13];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B == 0 || H == 0 || W == 0) return 0;
  if (threads != NTHREADS || !width_ok(w1) || !width_ok(w2) || C < 1 || cc < 8 ||
      (cc & (cc - 1)))
    return (int)cudaErrorInvalidValue;
#define VFT_LAUNCH(A, Bt) \
  launch_nx<A, Bt>(nx, f1, f2, out, B, H, W, C, cc, w1, w2, grid_x, grid_y, smem, s)
  if (t1 == 0 && t2 == 0) return VFT_LAUNCH(float, float);
  if (t1 == 1 && t2 == 1) return VFT_LAUNCH(__nv_bfloat16, __nv_bfloat16);
  if (t1 == 1 && t2 == 0) return VFT_LAUNCH(__nv_bfloat16, float);
  if (t1 == 0 && t2 == 1) return VFT_LAUNCH(float, __nv_bfloat16);
#undef VFT_LAUNCH
  return (int)cudaErrorInvalidValue;
}

// The dynamic shared-memory bytes of a launch, by the kernel's own layout, so
// the wrapper's plan can be checked against it on the card.
extern "C" int corr81_smem_bytes(int nx, int cc, int C, int t1, int t2) {
  return smem_bytes(XG * nx, cc, C, t1 ? 2 : 4, t2 ? 2 : 4);
}

extern "C" const char* vft_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
