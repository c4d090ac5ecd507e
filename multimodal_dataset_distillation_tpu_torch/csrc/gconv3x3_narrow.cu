// Grouped 3x3, stride-1, TF-SAME convolution for Hopper (sm_90a) at 8 input
// and 8 output channels per group (every grouped site of NF-RegNet-B1):
// forward and weight gradient, NHWC activations x HWIO weights, float32 or
// bfloat16 operands, float32 sums, output in the operands' dtype.
//
// Replaces the two Pallas TPU kernels of
// multimodal_dataset_distillation_tpu/ops/pallas_gconv.py at that width:
//   * _spatial_kernel (the pallas_call in _pallas_spatial)
//       -> gconv3x3_narrow_fwd_bf16_kernel / gconv3x3_narrow_fwd_f32_kernel.
//          Also the input gradient (dgrad): the forward conv on
//          rot_swap(w) (ops/gconv.py).
//   * _wgrad_kernel (the pallas_call in _pallas_wgrad)
//       -> gconv3x3_narrow_wgrad_bf16_kernel /
//          gconv3x3_narrow_wgrad_f32_kernel + gconv3x3_narrow_reduce_kernel.
// ops/gconv.py::use_narrow sends these shapes here; gconv3x3.cu keeps every
// other width outside the 64-wide tensor-core kernels.
//
// What bounds it on the card.  Each output element costs 2 * 9 * 8 = 144
// FLOP against 2 (bf16) or 4 (float32) bytes of input and as many of
// output: 36 FLOP per byte in bf16, far below the H100's ridge (~295), so
// the bound is the bytes, ~0.16 ms per NF-RegNet-B1 tower pass at mb=100
// in bf16 and ~0.32 ms in float32.  float32 on the CUDA cores has an
// operations bound just below that (~0.29 ms at 67 TFLOP/s).
// gconv3x3.cu's tiles (one group per block, 128 x 64 outputs, K in slices
// of 16) do 1/16 useful FMAs at this width and read every pixel from
// device memory once per tap.  Measured (tools/gconv_narrow_probe.py,
// PERF.md): the forwards are held by their instruction stream (address,
// mask and TF32 split arithmetic around each load), not by their copies;
// the wgrads by their copy pipeline.
//
// Design.
//   * A block owns a chunk of up to 8 groups (64 channels: 128 bytes of a
//     pixel in bf16, 256 in float32; G = 11, 23, 45, 92 split into chunks
//     of 5-8 whose sizes differ by at most one, so no block holds a
//     sliver) and a run of consecutive tiles of flattened (n, h, w)
//     pixels; runs differ by at most one tile.  A tile's taps read its
//     halo, the pixel rows m0-W-1 .. m0+tile+W: one contiguous run of
//     rows.  The block keeps a ring of pixel rows in shared memory; the
//     first tile copies its whole halo, every later tile only its `tile`
//     new rows, so each pixel row is copied once per run.  Copies are
//     16-byte cp.async, neighbouring threads on neighbouring addresses, and
//     the next tile's copy is in flight while this tile computes.  Rows
//     outside [0, M) and channels past the chunk's groups are zero-filled
//     by the copy; no padded copy is made.  The padding of 1 around each
//     image comes from a 9-bit tap mask per pixel.
//   * Shared rows are 64 channels and 16 bytes of padding, and the ring has
//     a multiple of 8 slots: the 8 rows of consecutive pixels that one
//     ldmatrix phase or one quarter-warp of 16-byte loads reads start in 8
//     different bank groups, across the ring's wrap too, and a lane's
//     address for a tap is its row's byte offset plus a constant.
//   * bf16 on the tensor cores, mma.sync m16n8k16 (f32 sums).  Forward:
//     warp w serves group w of the chunk; M is 16 pixels, N the group's 8
//     outputs, K two taps x 8 channels, so 5 MMAs per 16 pixels (the last
//     with a zero tap).  A comes from ldmatrix on the shifted halo rows
//     (padding rows point at a zero row); B, the group's weights, stays in
//     10 registers.  Outputs are staged in shared memory and leave in
//     16-byte stores.  Wgrad: the same instruction with M = tap x channel
//     (72 rows, 5 m-tiles), K = 16 pixels; A from ldmatrix.trans of the
//     ring, B from ldmatrix.trans of the ybar tile (double-buffered).
//   * float32 forward on the tensor cores, mma.sync m16n8k8 TF32 in three
//     passes (hi*hi + (hi*lo + lo*hi) of operands split into two TF32
//     parts: float32 accuracy), one tap (K = 8 channels) per MMA, A from
//     ldmatrix on the f32 rows, the split weights in 36 registers.  (A
//     CUDA-core FMA forward, 4 pixels x 8 outputs a lane, was timed slower
//     beside it.)  Wgrad on CUDA-core FMAs, float32-exact sums:
//     warp t serves tap t, lane l group l & 7 and every fourth pixel, all
//     64 (c, o) sums of its tap in registers, 64 FMAs per 4 loads, tiles of
//     64 pixels (two blocks fit on an SM).  The upper four groups read
//     their second chunk first, so a quarter-warp's eight 16-byte loads
//     land on eight bank groups; their sums are held rotated by 4 and put
//     back when written.
//   * Wgrad blocks run in no order: block (run, chunk) sums its tiles into
//     a float32 partial, and gconv3x3_narrow_reduce_kernel adds the
//     partials in run order.  No atomics: the result is bit-identical on
//     repeat.
//
// Interface: plain C functions (ctypes), launched on the caller's stream;
// each returns cudaGetLastError() after its launches.  The caller allocates
// outputs and the wgrad workspace and plans the runs
// (ops/gconv.py::narrow_runs, which mirrors tile_of and smem_bytes here);
// any plan is correct, the plan only balances the work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gconv_mma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kCpg = 8;                     // channels per group, in and out
constexpr int kChunk = 8;                   // groups per block
constexpr int kWGroup = 9 * kCpg * kCpg;    // 576 weights of one group
constexpr int kThreads = 256;               // 8 warps, one per group
constexpr int kWgradF32Threads = 288;       // 9 warps, one per tap

// pixels per tile: 64 for the float32 wgrad (its ybar tiles are
// double-buffered beside the ring), 128 otherwise.  kind 0 = fwd, 1 = wgrad
__host__ __device__ constexpr int tile_of(int kind, int itemsize) {
  return kind == 1 && itemsize == 4 ? 64 : 128;
}

// pixel rows a tile reads: one image row and one pixel beyond each end
__host__ __device__ constexpr int halo_rows(int tile, int W) {
  return tile + 2 * W + 2;
}

// ring slots: one tile's halo and the next tile's new rows, rounded up to
// a multiple of 8
__host__ __device__ constexpr int ring_rows(int tile, int W) {
  return (halo_rows(tile, W) + tile + 7) / 8 * 8;
}

// bytes of a shared pixel row: 64 channels and 16 bytes of padding, so that
// 8 consecutive rows start in 8 different 16-byte bank groups
__host__ __device__ constexpr int pitch_of(int itemsize) {
  return kChunk * kCpg * itemsize + 16;
}

// [ring][bf16 forward: its out tile; wgrads: 2 ybar tiles][tap masks][zero
// row]
__host__ __device__ constexpr int smem_bytes(int kind, int itemsize, int W) {
  return (ring_rows(tile_of(kind, itemsize), W) +
          (kind == 1 ? 2 : itemsize == 2 ? 1 : 0) * tile_of(kind, itemsize)) *
             pitch_of(itemsize) +
         tile_of(kind, itemsize) * 2 + 16;
}

// first group of chunk c: the G groups split into ceil(G / 8) chunks of at
// most 8 whose sizes differ by at most one
__host__ __device__ constexpr int chunk_first(int c, int G) {
  return c * G / ((G + kChunk - 1) / kChunk);
}

// halo row of tap t (dy, dx) = (t/3 - 1, t%3 - 1) of tile pixel p, less p
__device__ __forceinline__ int tap_off(int t, int W) {
  return (t / 3) * W + t % 3;
}

// ring slot of halo row r of the tile whose row 0 sits in slot base
__device__ __forceinline__ int slot_of(int base, int r, int R) {
  const int s = base + r;
  return s >= R ? s - R : s;
}

// byte offset, within a ring of rb bytes, of a row at byte offset row plus
// the tap offset off (both within the ring)
__device__ __forceinline__ int ring_add(int row, int off, int rb) {
  const int a = row + off;
  return a >= rb ? a - rb : a;
}

// Copy halo rows [r0, r1) of the tile at pixel m0 (pixel rows m0-W-1+r,
// channels [c0, c0 + 64), zeros from c1 on) into ring slots (base + r)
// mod R.
template <typename T>
__device__ __forceinline__ void stage_ring(uint32_t ring, const T* src, int m0,
                                           int r0, int r1, int base, int R,
                                           int W, int M, int C, int c0,
                                           int c1) {
  constexpr int kChunks = kChunk * kCpg * sizeof(T) / 16;
  constexpr int kPer = 16 / sizeof(T);
  for (int i = threadIdx.x; i < (r1 - r0) * kChunks; i += blockDim.x) {
    const int r = r0 + i / kChunks, j = i % kChunks;
    const int q = m0 - W - 1 + r, c = c0 + j * kPer;
    const bool ok = q >= 0 && q < M && c < c1;
    cp_async16(ring + slot_of(base, r, R) * pitch_of(sizeof(T)) + j * 16,
               ok ? src + (size_t)q * C + c : src, ok);
  }
}

// Copy pixel rows m0 .. m0 + rows - 1 (channels [c0, c0 + 64), zeros from
// c1 on) to dst.
template <typename T>
__device__ __forceinline__ void stage_rows(uint32_t dst, const T* src, int m0,
                                           int rows, int M, int C, int c0,
                                           int c1) {
  constexpr int kChunks = kChunk * kCpg * sizeof(T) / 16;
  constexpr int kPer = 16 / sizeof(T);
  for (int i = threadIdx.x; i < rows * kChunks; i += blockDim.x) {
    const int r = i / kChunks, j = i % kChunks;
    const int q = m0 + r, c = c0 + j * kPer;
    const bool ok = q < M && c < c1;
    cp_async16(dst + r * pitch_of(sizeof(T)) + j * 16,
               ok ? src + (size_t)q * C + c : src, ok);
  }
}

// mask[p]: bit t set when tap t of pixel m0 + p reads inside its image; 0
// for pixels past M.
template <int kTile>
__device__ __forceinline__ void tap_masks(uint16_t* mask, int m0, int M,
                                          int H, int W) {
  for (int p = threadIdx.x; p < kTile; p += blockDim.x) {
    const int m = m0 + p;
    uint32_t bits = 0;
    if (m < M) {
      const int wc = m % W, hr = (m / W) % H;
      const uint32_t rows = (hr > 0 ? 1u : 0u) | 2u | (hr < H - 1 ? 4u : 0u);
      const uint32_t cols = (wc > 0 ? 1u : 0u) | 2u | (wc < W - 1 ? 4u : 0u);
#pragma unroll
      for (int dy = 0; dy < 3; ++dy)
        if (rows >> dy & 1u) bits |= cols << (3 * dy);
    }
    mask[p] = static_cast<uint16_t>(bits);
  }
}

// A block's run of tiles: run r of R' = gridDim.y covers tiles
// [r * tiles / R', (r + 1) * tiles / R'), so that runs differ by at most
// one tile.  The first tile's whole halo and stage_tile(t0, 0), then per
// tile the next tile's new ring rows and stage_tile(t + 1, buffer) in
// flight while compute(t, base, buffer) reads this one (base: the ring
// slot of its halo row 0).  Every thread of the block calls it.
template <int kTile, typename T, typename StageTile, typename Compute>
__device__ __forceinline__ void walk_run(uint32_t ring, const T* x,
                                         uint16_t* mask, int N,
                                         int H, int W, int G,
                                         StageTile stage_tile,
                                         Compute compute) {
  const int M = N * H * W, C = G * kCpg;
  const int c0 = chunk_first(blockIdx.x, G) * kCpg;
  const int c1 = chunk_first(blockIdx.x + 1, G) * kCpg;
  const int halo = halo_rows(kTile, W), R = ring_rows(kTile, W);
  const int tiles = (M + kTile - 1) / kTile;
  const int t0 = blockIdx.y * tiles / gridDim.y;
  const int t1 = (blockIdx.y + 1) * tiles / gridDim.y;
  if (t0 >= t1) return;
  stage_ring(ring, x, t0 * kTile, 0, halo, 0, R, W, M, C, c0, c1);
  stage_tile(t0, 0);
  cp_async_commit();
  int base = 0;
  for (int t = t0, i = 0; t < t1; ++t, ++i) {
    const int next = slot_of(base, kTile, R);
    if (t + 1 < t1) {
      stage_ring(ring, x, (t + 1) * kTile, halo - kTile, halo, next, R, W, M,
                 C, c0, c1);
      stage_tile(t + 1, (i + 1) & 1);
    }
    cp_async_commit();
    tap_masks<kTile>(mask, t * kTile, M, H, W);
    cp_async_wait_prev();
    __syncthreads();
#ifndef MDD_NARROW_COPIES_ONLY   // tools/gconv_narrow_probe.py: copies alone
    compute(t, base, i & 1);
#endif
    __syncthreads();   // this tile's rows are free for the next prefetch
    base = next;
  }
}

// ---------------------------------------------------------------------------
// bf16 forward: grid (chunks, runs), 256 threads
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads, 3)
gconv3x3_narrow_fwd_bf16_kernel(const bf16* __restrict__ x,
                                const bf16* __restrict__ w,
                                bf16* __restrict__ y, int N, int H, int W,
                                int G) {
  constexpr int kTile = tile_of(0, 2), kP = pitch_of(2);
  extern __shared__ __align__(16) uint8_t smem[];
  const int C = G * kCpg, M = N * H * W, R = ring_rows(kTile, W);
  const int cg0 = chunk_first(blockIdx.x, G);
  const int cg1 = chunk_first(blockIdx.x + 1, G);
  uint8_t* out = smem + R * kP;
  uint16_t* mask = reinterpret_cast<uint16_t*>(out + kTile * kP);
  uint32_t* zero = reinterpret_cast<uint32_t*>(mask + kTile);
  const uint32_t s_zero = smem_u32(zero);
  if (threadIdx.x < 4) zero[threadIdx.x] = 0u;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = cg0 + warp, gid = lane >> 2, tig = lane & 3;
  // B of k-step s: k = (tap - 2s) * 8 + c, n = o; b[s][h] holds taps 2s + h,
  // channels 2tig, 2tig + 1, output gid
  uint32_t b[5][2];
#pragma unroll
  for (int s = 0; s < 5; ++s)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int t = 2 * s + h;
      b[s][h] = 0u;
      if (g < cg1 && t < 9) {
        const bf16* p = w + (size_t)(t * kCpg + 2 * tig) * C + g * kCpg + gid;
        b[s][h] = pack_bf16(__ldg(p), __ldg(p + C));
      }
    }
  // ldmatrix rows of this lane: matrix lane >> 3 = (pixels 0-7 | 8-15) x
  // (tap 2s | 2s + 1); byte offsets in the ring of its taps
  const int hi = lane >> 4, rb = R * kP;
  const uint32_t col = smem_u32(smem) + warp * 16;
  int off[5];
#pragma unroll
  for (int s = 0; s < 5; ++s) off[s] = tap_off(2 * s + hi, W) * kP;

  walk_run<kTile>(smem_u32(smem), x, mask, N, H, W, G, [](int, int) {},
                  [&](int t, int base, int) {
    if (g < cg1) {
#pragma unroll 2
      for (int mt = 0; mt < kTile / 16; ++mt) {
        const int p = mt * 16 + (lane & 15);
        const int row = slot_of(base, p, R) * kP;
        const uint32_t bits = mask[p];
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int s = 0; s < 5; ++s) {
          uint32_t a[4];
          ldsm_x4(bits >> (2 * s + hi) & 1u   // tap 9: never set
                      ? col + ring_add(row, off[s], rb) : s_zero, a);
          mma_bf16(acc, a, b[s][0], b[s][1]);
        }
        // rows gid and gid + 8 of the m-tile, outputs 2tig, 2tig + 1
        uint8_t* o = out + (mt * 16 + gid) * kP + warp * 16 + tig * 4;
        *reinterpret_cast<uint32_t*>(o) = pack_bf16(acc[0], acc[1]);
        *reinterpret_cast<uint32_t*>(o + 8 * kP) = pack_bf16(acc[2], acc[3]);
      }
    }
    __syncthreads();
    const int m0 = t * kTile;
    for (int i = threadIdx.x; i < kTile * kChunk; i += kThreads) {
      const int p = i / kChunk, j = i % kChunk;
      const int m = m0 + p, gg = cg0 + j;
      if (m < M && gg < cg1)
        *reinterpret_cast<uint4*>(y + (size_t)m * C + gg * kCpg) =
            *reinterpret_cast<const uint4*>(out + p * kP + j * 16);
    }
  });
}

// ---------------------------------------------------------------------------
// float32 forward on the tensor cores, three TF32 passes (hi*hi + (hi*lo +
// lo*hi)): grid (chunks, runs), 256 threads; warp w serves group w, 16
// pixels x 8 outputs x one tap (K = 8 channels) per mma.m16n8k8.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads, 2)
gconv3x3_narrow_fwd_f32_kernel(const float* __restrict__ x,
                               const float* __restrict__ w,
                               float* __restrict__ y, int N, int H, int W,
                               int G) {
  constexpr int kTile = tile_of(0, 4), kP = pitch_of(4);
  extern __shared__ __align__(16) uint8_t smem[];
  const int C = G * kCpg, M = N * H * W, R = ring_rows(kTile, W);
  const int cg0 = chunk_first(blockIdx.x, G);
  const int cg1 = chunk_first(blockIdx.x + 1, G);
  uint16_t* mask = reinterpret_cast<uint16_t*>(smem + R * kP);
  uint32_t* zero = reinterpret_cast<uint32_t*>(mask + kTile);
  const uint32_t s_zero = smem_u32(zero);
  if (threadIdx.x < 4) zero[threadIdx.x] = 0u;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = cg0 + warp, gid = lane >> 2, tig = lane & 3;
  // B of tap t: k = c, n = o; b0 channel tig, b1 channel tig + 4, output gid
  uint32_t bh[9][2], bl[9][2];
#pragma unroll
  for (int t = 0; t < 9; ++t)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float v = g < cg1 ? __ldg(w + (size_t)(t * kCpg + tig + 4 * h) * C +
                                    g * kCpg + gid)
                            : 0.f;
      split_tf32(__float_as_uint(v), bh[t][h], bl[t][h]);
    }
  // ldmatrix rows of this lane: matrix lane >> 3 = (pixels 0-7 | 8-15) x
  // (channels 0-3 | 4-7); byte offsets in the ring of the taps
  const int rb = R * kP;
  const uint32_t col = smem_u32(smem) + (2 * warp + (lane >> 4)) * 16;
  int off[9];
#pragma unroll
  for (int t = 0; t < 9; ++t) off[t] = tap_off(t, W) * kP;

  walk_run<kTile>(smem_u32(smem), x, mask, N, H, W, G, [](int, int) {},
                  [&](int tile, int base, int) {
    if (g >= cg1) return;
#pragma unroll 2
    for (int mt = 0; mt < kTile / 16; ++mt) {
      const int p = mt * 16 + (lane & 15);
      const int row = slot_of(base, p, R) * kP;
      const uint32_t bits = mask[p];
      // hi*hi, hi*lo and lo*hi in three chains, the small ones added first
      float big[4] = {0.f, 0.f, 0.f, 0.f}, s1[4] = {0.f, 0.f, 0.f, 0.f};
      float s2[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int t = 0; t < 9; ++t) {
        uint32_t a[4], ah[4], al[4];
        ldsm_x4(bits >> t & 1u ? col + ring_add(row, off[t], rb) : s_zero, a);
#pragma unroll
        for (int k = 0; k < 4; ++k) split_tf32(a[k], ah[k], al[k]);
        mma_tf32(big, ah, bh[t][0], bh[t][1]);
        mma_tf32(s1, ah, bl[t][0], bl[t][1]);
        mma_tf32(s2, al, bh[t][0], bh[t][1]);
      }
      float small[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) small[k] = s1[k] + s2[k];
      // rows gid and gid + 8, outputs 2tig, 2tig + 1
      const int m = tile * kTile + mt * 16 + gid;
      float* yr = y + (size_t)m * C + g * kCpg + 2 * tig;
      if (m < M)
        *reinterpret_cast<float2*>(yr) =
            make_float2(big[0] + small[0], big[1] + small[1]);
      if (m + 8 < M)
        *reinterpret_cast<float2*>(yr + (size_t)8 * C) =
            make_float2(big[2] + small[2], big[3] + small[3]);
    }
  });
}

// ---------------------------------------------------------------------------
// bf16 wgrad partials: grid (chunks, runs), 256 threads.  Run s sums its
// tiles into ws[s, g, tap * 8 + c, o].
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads, 2)
gconv3x3_narrow_wgrad_bf16_kernel(const bf16* __restrict__ x,
                                  const bf16* __restrict__ dy,
                                  float* __restrict__ ws, int N, int H, int W,
                                  int G) {
  constexpr int kTile = tile_of(1, 2), kP = pitch_of(2);
  extern __shared__ __align__(16) uint8_t smem[];
  const int C = G * kCpg, M = N * H * W, R = ring_rows(kTile, W);
  const int cg0 = chunk_first(blockIdx.x, G);
  const int cg1 = chunk_first(blockIdx.x + 1, G);
  uint8_t* ybs = smem + R * kP;   // 2 tiles
  uint16_t* mask = reinterpret_cast<uint16_t*>(ybs + 2 * kTile * kP);
  uint32_t* zero = reinterpret_cast<uint32_t*>(mask + kTile);
  const uint32_t s_yb = smem_u32(ybs), s_zero = smem_u32(zero);
  if (threadIdx.x < 4) zero[threadIdx.x] = 0u;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = cg0 + warp;
  // A of m-tile i: rows (tap 2i | 2i + 1) x 8 channels, k = 16 pixels;
  // this lane's ldmatrix.trans row: matrix lane >> 3 = (tap 2i + jt) x
  // (pixels jp .. of the k-step); byte offsets in the ring of its taps
  const int jt = (lane >> 3) & 1, jp = ((lane >> 4) << 3) + (lane & 7);
  const int rb = R * kP;
  const uint32_t col = smem_u32(smem) + warp * 16;
  int off[5];
#pragma unroll
  for (int i = 0; i < 5; ++i) off[i] = tap_off(2 * i + jt, W) * kP;
  float acc[5][4];
#pragma unroll
  for (int i = 0; i < 5; ++i)
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[i][k] = 0.f;

  walk_run<kTile>(
      smem_u32(smem), x, mask, N, H, W, G,
      [&](int t, int buf) {
        stage_rows(s_yb + buf * kTile * kP, dy, t * kTile, kTile, M, C,
                   cg0 * kCpg, cg1 * kCpg);
      },
      [&](int, int base, int buf) {
        if (g >= cg1) return;
        const uint32_t yb = s_yb + buf * kTile * kP + warp * 16;
#pragma unroll 2
        for (int ks = 0; ks < kTile / 16; ++ks) {
          uint32_t bb[2];
          ldsm_x2_t(yb + (ks * 16 + (lane & 15)) * kP, bb);
          const int p = ks * 16 + jp;
          const int row = slot_of(base, p, R) * kP;
          const uint32_t bits = mask[p];
#pragma unroll
          for (int i = 0; i < 5; ++i) {
            uint32_t a[4];
            ldsm_x4_t(bits >> (2 * i + jt) & 1u   // tap 9: never set
                          ? col + ring_add(row, off[i], rb) : s_zero, a);
            mma_bf16(acc[i], a, bb[0], bb[1]);
          }
        }
      });
  if (g >= cg1) return;
  // D rows gid (tap 2i, channel gid) and gid + 8 (tap 2i + 1), columns
  // o = 2tig, 2tig + 1
  const int gid = lane >> 2, tig = lane & 3;
  float* wsg = ws + ((size_t)blockIdx.y * G + g) * kWGroup;
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    *reinterpret_cast<float2*>(wsg + ((2 * i) * kCpg + gid) * kCpg +
                               2 * tig) = make_float2(acc[i][0], acc[i][1]);
    if (2 * i + 1 < 9)
      *reinterpret_cast<float2*>(wsg + ((2 * i + 1) * kCpg + gid) * kCpg +
                                 2 * tig) = make_float2(acc[i][2], acc[i][3]);
  }
}

// ---------------------------------------------------------------------------
// float32 wgrad partials: grid (chunks, runs), 288 threads; same runs and
// workspace layout as the bf16 one.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kWgradF32Threads, 2)
gconv3x3_narrow_wgrad_f32_kernel(const float* __restrict__ x,
                                 const float* __restrict__ dy,
                                 float* __restrict__ ws, int N, int H, int W,
                                 int G) {
  constexpr int kTile = tile_of(1, 4), kP = pitch_of(4);
  extern __shared__ __align__(16) uint8_t smem[];
  const int C = G * kCpg, M = N * H * W, R = ring_rows(kTile, W);
  const int cg0 = chunk_first(blockIdx.x, G);
  const int cg1 = chunk_first(blockIdx.x + 1, G);
  uint8_t* ybs = smem + R * kP;   // 2 tiles
  uint16_t* mask = reinterpret_cast<uint16_t*>(ybs + 2 * kTile * kP);
  const uint32_t s_yb = smem_u32(ybs);

  const int tap = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grp = lane & 7, phase = lane >> 3, g = cg0 + grp;
  const int off = tap_off(tap, W) * kP, rb = R * kP;
  // this lane's two chunks; the upper four groups take the second first, so
  // that a quarter-warp's eight loads of one row land on eight bank groups,
  // and their sums hold channels and outputs rotated by 4
  const int rot = grp >> 2;
  const int ja = (2 * grp + rot) * 16, jb = (2 * grp + 1 - rot) * 16;
  float acc[8][8];
#pragma unroll
  for (int c = 0; c < 8; ++c)
#pragma unroll
    for (int o = 0; o < 8; ++o) acc[c][o] = 0.f;

  walk_run<kTile>(
      smem_u32(smem), x, mask, N, H, W, G,
      [&](int t, int buf) {
        stage_rows(s_yb + buf * kTile * kP, dy, t * kTile, kTile, M, C,
                   cg0 * kCpg, cg1 * kCpg);
      },
      [&](int, int base, int buf) {
        if (g >= cg1) return;
        const uint8_t* yt = ybs + buf * kTile * kP;
        const int row0 = base * kP;
#pragma unroll 2
        for (int p = phase; p < kTile; p += 4) {
          if (!(mask[p] >> tap & 1u)) continue;
          const uint8_t* xr = smem + ring_add(row0, p * kP + off, rb);
          const float4 xa = *reinterpret_cast<const float4*>(xr + ja);
          const float4 xb = *reinterpret_cast<const float4*>(xr + jb);
          const float4 ya =
              *reinterpret_cast<const float4*>(yt + p * kP + ja);
          const float4 yb =
              *reinterpret_cast<const float4*>(yt + p * kP + jb);
          const float xv[8] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
          const float yv[8] = {ya.x, ya.y, ya.z, ya.w, yb.x, yb.y, yb.z, yb.w};
#pragma unroll
          for (int c = 0; c < 8; ++c)
#pragma unroll
            for (int o = 0; o < 8; ++o)
              acc[c][o] = fmaf(xv[c], yv[o], acc[c][o]);
        }
      });
  // add the four pixel phases (lanes l, l ^ 8, l ^ 16, l ^ 24) in a fixed
  // pattern: every lane of the four ends with the same bits
#pragma unroll
  for (int c = 0; c < 8; ++c)
#pragma unroll
    for (int o = 0; o < 8; ++o) {
      acc[c][o] += __shfl_xor_sync(0xffffffffu, acc[c][o], 8);
      acc[c][o] += __shfl_xor_sync(0xffffffffu, acc[c][o], 16);
    }
  if (g >= cg1) return;
  // phase q writes held rows 2q, 2q + 1 (true channels (2q + 4 rot) % 8 ..)
  float* wsg = ws + ((size_t)blockIdx.y * G + g) * kWGroup + tap * kCpg * kCpg;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    if (c >> 1 != phase) continue;
    float* row = wsg + ((c + 4 * rot) & 7) * kCpg;
#pragma unroll
    for (int o = 0; o < 8; ++o) row[(o + 4 * rot) & 7] = acc[c][o];
  }
}

// dw[tap, c, g*8 + o] = sum over runs, in run order, of
// ws[run, g, tap*8 + c, o].
template <typename T>
__global__ void gconv3x3_narrow_reduce_kernel(const float* __restrict__ ws,
                                              T* __restrict__ dw, int G,
                                              int runs) {
  const int total = G * kWGroup;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  float s = ws[idx];
  for (int sp = 1; sp < runs; ++sp) s += ws[(size_t)sp * total + idx];
  const int g = idx / kWGroup, r = idx % kWGroup;
  const size_t at = (size_t)(r / kCpg) * G * kCpg + g * kCpg + r % kCpg;
  if constexpr (sizeof(T) == 2)
    dw[at] = __float2bfloat16(s);
  else
    dw[at] = s;
}

int set_smem(const void* kernel, int bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

}  // namespace

// Dynamic shared memory of the forward (kind 0) or wgrad (kind 1) kernel
// of operand size itemsize (2 or 4 bytes) at image width W;
// ops/gconv.py::narrow_smem_bytes mirrors it.
extern "C" int mdd_gconv3x3_narrow_smem(int kind, int itemsize, int W) {
  return smem_bytes(kind, itemsize, W);
}

// dtype: 0 = float32, 1 = bfloat16.  Grid: ceil(G / 8) chunks x runs (at
// most the number of 128-pixel tiles).
extern "C" int mdd_gconv3x3_fwd_narrow(const void* x, const void* w, void* y,
                                       int N, int H, int W, int G, int runs,
                                       int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((G + kChunk - 1) / kChunk, runs);
  if (dtype == 1) {
    const int smem = smem_bytes(0, 2, W);
    const int err = set_smem(
        reinterpret_cast<const void*>(gconv3x3_narrow_fwd_bf16_kernel), smem);
    if (err) return err;
    gconv3x3_narrow_fwd_bf16_kernel<<<grid, kThreads, smem, s>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(w),
        static_cast<bf16*>(y), N, H, W, G);
  } else if (dtype == 0) {
    const int smem = smem_bytes(0, 4, W);
    const int err = set_smem(
        reinterpret_cast<const void*>(gconv3x3_narrow_fwd_f32_kernel), smem);
    if (err) return err;
    gconv3x3_narrow_fwd_f32_kernel<<<grid, kThreads, smem, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<float*>(y), N, H, W, G);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// ws: float32 workspace of runs * G * 576 elements; every element is
// written before it is read.  runs: at most the number of tiles of
// tile_of(1, itemsize) pixels.
extern "C" int mdd_gconv3x3_wgrad_narrow(const void* x, const void* dy,
                                         void* ws, void* dw, int N, int H,
                                         int W, int G, int runs, int dtype,
                                         void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((G + kChunk - 1) / kChunk, runs);
  float* wsf = static_cast<float*>(ws);
  const int blocks = (G * kWGroup + 255) / 256;
  int err;
  if (dtype == 1) {
    const int smem = smem_bytes(1, 2, W);
    err = set_smem(
        reinterpret_cast<const void*>(gconv3x3_narrow_wgrad_bf16_kernel), smem);
    if (err) return err;
    gconv3x3_narrow_wgrad_bf16_kernel<<<grid, kThreads, smem, s>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(dy), wsf, N, H,
        W, G);
    err = static_cast<int>(cudaGetLastError());
    if (err) return err;
    gconv3x3_narrow_reduce_kernel<bf16><<<blocks, 256, 0, s>>>(
        wsf, static_cast<bf16*>(dw), G, runs);
  } else if (dtype == 0) {
    const int smem = smem_bytes(1, 4, W);
    err = set_smem(
        reinterpret_cast<const void*>(gconv3x3_narrow_wgrad_f32_kernel), smem);
    if (err) return err;
    gconv3x3_narrow_wgrad_f32_kernel<<<grid, kWgradF32Threads, smem,
                                       s>>>(
        static_cast<const float*>(x), static_cast<const float*>(dy), wsf, N,
        H, W, G);
    err = static_cast<int>(cudaGetLastError());
    if (err) return err;
    gconv3x3_narrow_reduce_kernel<float><<<blocks, 256, 0, s>>>(
        wsf, static_cast<float*>(dw), G, runs);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
