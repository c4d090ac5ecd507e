// Grouped 3x3, stride-1, TF-SAME convolution for Hopper (sm_90a), any
// group width and any image width: forward and weight gradient, NHWC
// activations x HWIO weights, float32 or bfloat16 operands, float32 sums,
// output in the operands' dtype.  The generic route of ops/gconv.py.
//
// Replaces the two Pallas TPU kernels of
// multimodal_dataset_distillation_tpu/ops/pallas_gconv.py:
//   * _spatial_kernel (the pallas_call in _pallas_spatial)
//       -> gconv3x3_fwd_kernel.  It is also the input gradient (dgrad): the
//          forward conv on the spatially rotated, per-group in/out-swapped
//          weight (_rot_swap there, rot_swap in ops/gconv.py here).
//   * _wgrad_kernel (the pallas_call in _pallas_wgrad)
//       -> gconv3x3_wgrad_kernel + gconv3x3_wgrad_reduce_kernel.
//
// Which calls reach these kernels.  ops/gconv.py sends 64/64 channels per
// group to gconv3x3_tc.cu (bf16) and gconv3x3_tf32.cu (float32), and 8/8
// to gconv3x3_narrow.cu, while their flattened halo of 128 + 2 W + 2
// pixel rows fits a block (width <= 242 / 321 bf16 forward / wgrad, 64 /
// 32 float32 forward / wgrad, 547 / 295 at 8/8).  Everything else comes
// here: other group widths, wider images (NFNet-L0's float32 stage-1
// wgrad from 288^2 on, 36 wide), and tc=False.  The Pallas kernel takes
// any width; so does this one: its shared memory depends on the tile
// alone.
//
// What bounds it on the card.  At 64 channels per group an output element
// costs 2 * 9 * 64 = 1152 FLOP against ~4 bytes in and out in float32
// (~2 in bf16): ~144 (~288) FLOP per byte, at or above the H100's ridge,
// so the bound is the operations: bf16 on the tensor cores at 989 TFLOP/s;
// float32 as three TF32 passes (hi*hi + hi*lo + lo*hi of operands split by
// cvt.rna.tf32, float32-accurate) at 495 / 3 = 165 TFLOP/s effective.  At
// narrower groups the bytes bound.  The first version of these kernels
// ran the float32 FMA units (67 TFLOP/s peak) from a 128 x 64 shared tile
// and reached 0.007-0.40 of the bound.
//
// Design.
//   * Tensor cores through mma.sync: m16n8k8 TF32 in three passes for
//     float32 (a big accumulator for hi*hi, a small one for hi*lo +
//     lo*hi), m16n8k16 bf16 for bfloat16, float32 sums.  The operands
//     are split (or taken as bf16) as they are loaded from shared memory.
//   * 2-D spatial tiles.  A tile is th x tw output pixels of tn images
//     (tn > 1 only where whole images are small; at most 128 pixels and
//     192 halo pixels; ops/gconv.py::generic_tile picks them per shape,
//     e.g. 3 x 36 at 36^2, 4 x 28 at 28^2, 8 x 14 at 14^2, two whole 7 x 7
//     images at 7^2).  The block stages the tile's halos from NHWC
//     rows with 16-byte cp.async (narrower plain loads where channel
//     counts or pointers are not 16-byte aligned), looking each pixel up
//     in a table the block fills once; the image border's zeros are the
//     copies' zero fill.  Shared memory depends on the tile bound, never
//     on the image width.
//   * Channels in stages of 64 bytes (16 float32 or 32 bf16), K padded to
//     the MMA depth and N to 8 with zeros in shared memory; two stages in
//     flight (double-buffered cp.async).
//   * Forward: grid (blocks, ceil(opg / 64), G), 8 warps as 4 x 2, each
//     owning 2 m-tiles (32 pixels) x 4 n-tiles (32 output channels) of a
//     128-pixel x 64-output block tile (8 x 1 warps of 16 pixels x 8
//     outputs where opg <= 8).  Per channel stage the block holds the halo
//     and the weight of all 9 taps for those channels; A comes from
//     ldmatrix on the shifted halo rows, B from the weight rows.  Blocks
//     are persistent: block b walks tiles b, b + blocks, ..., and its
//     (tile, channel stage) steps run through one double-buffered pipeline,
//     so the next copy is always in flight.
//   * Wgrad: grid (splits, channel stages x ceil(opg / 64), G), 6 warps:
//     warp (r, h) owns the three taps of tap row r and 32 of the 64 output
//     channels (3 warps and 8 outputs where opg <= 8), so each ybar
//     fragment, split once, feeds three taps: M = the stage's channels of
//     each tap, K = the pixels of a run of tiles (split s takes tiles
//     [s * T / S, (s + 1) * T / S)), both operands from shared tiles (the
//     x halo and the ybar tile).  Each block writes its float32 partial;
//     gconv3x3_wgrad_reduce_kernel adds the partials in split order.  No
//     atomics: the result is bit-identical on repeat.
//
// Interface: plain C functions (ctypes), launched on the caller's stream.
// Each returns cudaGetLastError() after its launches; the caller allocates
// every output and the wgrad workspace and plans the tiles and splits
// (ops/gconv.py::generic_tile, generic_fwd_blocks, generic_wgrad_splits);
// any valid plan is correct, the plan only balances the work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "gconv_mma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kTilePix = 128;       // output pixels of a tile, at most
constexpr int kHaloMax = 192;       // halo pixels of a tile, at most
constexpr int kStageBytes = 64;     // channels staged per step, in bytes
constexpr int kNT = 64;             // output channels per block
constexpr int kFwdThreads = 256;    // the forward's 8 warps

// channels per stage and MMA depth of an operand type
template <typename T>
struct Op;
template <>
struct Op<float> {
  static constexpr int kc = 16, kstep = 8;
};
template <>
struct Op<bf16> {
  static constexpr int kc = 32, kstep = 16;
};

// Row pitches in shared memory, in bytes.  Halo rows read by ldmatrix
// (the forward's A, the bf16 wgrad's A) are 80 bytes: 8 consecutive pixels
// start in 8 different 16-byte bank groups.  The float32 wgrad reads its
// halo by 4-byte loads whose lanes step over pixels: 96 bytes (24 words)
// puts 4 consecutive pixels in 4 different 8-word windows.  Rows of 64
// output channels (weights, ybar): 64 * size + 32 bytes in float32 (4-byte
// loads over k rows: 72 words), + 16 in bf16 (ldmatrix.trans: 9 units).
constexpr int kFwdHaloPitch = kStageBytes + 16;
template <typename T>
__host__ __device__ constexpr int wgrad_halo_pitch() {
  return sizeof(T) == 4 ? kStageBytes + 32 : kStageBytes + 16;
}
template <typename T>
__host__ __device__ constexpr int n_pitch() {
  return kNT * static_cast<int>(sizeof(T)) + (sizeof(T) == 4 ? 32 : 16);
}

// one stage of the forward: [halo][weights of 9 taps x kc channels]
template <typename T>
__host__ __device__ constexpr int fwd_stage_bytes() {
  return kHaloMax * kFwdHaloPitch + 9 * Op<T>::kc * n_pitch<T>();
}
// one stage of the wgrad: [halo][ybar tile]
template <typename T>
__host__ __device__ constexpr int wgrad_stage_bytes() {
  return kHaloMax * wgrad_halo_pitch<T>() + kTilePix * n_pitch<T>();
}
// A pixel of a tile relative to its origin: image i, row r, column c
// (halo pixels count r and c from the halo's corner, one row and column
// before the tile's first), packed as i << 20 | r << 10 | c, and its pixel
// index relative to the origin's, (i * H + r) * W + c (halo pixels: less
// W + 1).  A block fills a table of them once: the copies then look their
// pixels up instead of dividing.
struct PixRef {
  int packed, rel;
};

// dynamic shared memory: two stages and the halo's PixRef table (the
// wgrad: also its tile pixels' table and their pixel -> halo map)
template <typename T>
__host__ __device__ constexpr int smem_bytes(int kind) {
  return kind == 0 ? 2 * fwd_stage_bytes<T>() + kHaloMax * 8
                   : 2 * wgrad_stage_bytes<T>() + kHaloMax * 8 +
                         kTilePix * (8 + 4);
}

template <typename T>
using Raw = typename std::conditional<sizeof(T) == 4, uint32_t,
                                      uint16_t>::type;

// The tile shape: tn images x th rows x tw columns of output pixels (tn > 1
// only where whole images are small).  Tile pixel p is pixel q = p %
// (th * tw) of image p / (th * tw); each image has its own halo of (th + 2)
// x (tw + 2) pixels, the images' halos one after another.
struct Geom {
  int tn, th, tw;
  __host__ __device__ int per_img() const { return th * tw; }
  __host__ __device__ int npix() const { return tn * th * tw; }
  __host__ __device__ int hw() const { return tw + 2; }
  __host__ __device__ int img_halo() const { return (th + 2) * (tw + 2); }
  // halo pixel of tile pixel p (< npix) at tap (0, 0)
  __device__ int hoff(int p) const {
    const int q = p % per_img();
    return p / per_img() * img_halo() + q / tw * hw() + q % tw;
  }
};

// The tile of a block: first image n, first output row h0 and column w0.
struct Tile {
  int n, h0, w0;
};
__device__ __forceinline__ Tile tile_of(int t, int H, int W, Geom geo) {
  const int tiles_w = (W + geo.tw - 1) / geo.tw;
  const int tiles_h = (H + geo.th - 1) / geo.th;
  Tile r;
  r.w0 = (t % tiles_w) * geo.tw;
  t /= tiles_w;
  r.h0 = (t % tiles_h) * geo.th;
  r.n = t / tiles_h * geo.tn;
  return r;
}

// element offset of tile pixel p's channel 0, or -1 where p lies past the
// tile or outside the images (rows of C channels)
__device__ __forceinline__ long long pixel_at(Tile tl, int p, Geom geo, int N,
                                              int H, int W, int C) {
  if (p >= geo.npix()) return -1;
  const int q = p % geo.per_img();
  const int n = tl.n + p / geo.per_img();
  const int gh = tl.h0 + q / geo.tw, gw = tl.w0 + q % geo.tw;
  return n < N && gh < H && gw < W ? ((long long)(n * H + gh) * W + gw) * C
                                   : -1;
}

// Fill the PixRef tables: the halo pixels' (tn images of (th + 2) x (tw +
// 2)) and, given pix, the tile pixels'.
__device__ __forceinline__ void fill_tables(PixRef* halo, PixRef* pix,
                                            Geom geo, int H, int W) {
  const int hw = geo.hw(), ih = geo.img_halo();
  for (int hp = threadIdx.x; hp < geo.tn * ih; hp += blockDim.x) {
    const int i = hp / ih, r = hp % ih / hw, c = hp % ih % hw;
    halo[hp] = {i << 20 | r << 10 | c, (i * H + r - 1) * W + c - 1};
  }
  if (pix == nullptr) return;
  for (int p = threadIdx.x; p < geo.npix(); p += blockDim.x) {
    const int i = p / geo.per_img(), q = p % geo.per_img();
    const int r = q / geo.tw, c = q % geo.tw;
    pix[p] = {i << 20 | r << 10 | c, (i * H + r) * W + c};
  }
}

// pixel index of the tile origin, to which a PixRef's rel is added
__device__ __forceinline__ long long origin_pix(Tile tl, int H, int W) {
  return ((long long)tl.n * H + tl.h0) * W + tl.w0;
}

// whether PixRef e lies inside the images, for the tile at tl; off is 1
// for halo pixels (their r and c start one before the tile)
__device__ __forceinline__ bool inside(PixRef e, Tile tl, int off, int N,
                                       int H, int W) {
  const int gh = tl.h0 - off + (e.packed >> 10 & 1023);
  const int gw = tl.w0 - off + (e.packed & 1023);
  return tl.n + (e.packed >> 20) < N && (unsigned)gh < (unsigned)H &&
         (unsigned)gw < (unsigned)W;
}

// Copy the halos of tile tl, channels [c0, c0 + kc) of group g (zeros past
// cpg and outside the images), into rows of `pitch` bytes at dst.
template <typename T, bool kVec>
__device__ __forceinline__ void stage_halo(uint8_t* dst, int pitch,
                                           const T* x, const PixRef* tab,
                                           Tile tl, Geom geo, int N, int H,
                                           int W, int C, int g, int cpg,
                                           int c0) {
  constexpr int kc = Op<T>::kc;
  const int halo = geo.tn * geo.img_halo();
  const long long base = origin_pix(tl, H, W);
  auto src_of = [&](int hp, int c) -> long long {
    const PixRef e = tab[hp];
    return c < cpg && inside(e, tl, 1, N, H, W)
               ? (base + e.rel) * C + g * cpg + c
               : -1;
  };
  if constexpr (kVec) {
    constexpr int kSeg = kStageBytes / 16, kPer = 16 / sizeof(T);
    for (int i = threadIdx.x; i < halo * kSeg; i += blockDim.x) {
      const int hp = i / kSeg, s = i % kSeg;
      const long long at = src_of(hp, c0 + s * kPer);
      cp_async16(smem_u32(dst + hp * pitch + s * 16), at >= 0 ? x + at : x,
                 at >= 0);
    }
  } else {
    const Raw<T>* xr = reinterpret_cast<const Raw<T>*>(x);
    for (int i = threadIdx.x; i < halo * kc; i += blockDim.x) {
      const int hp = i / kc, k = i % kc;
      const long long at = src_of(hp, c0 + k);
      reinterpret_cast<Raw<T>*>(dst + hp * pitch)[k] = at >= 0 ? xr[at] : 0;
    }
  }
}

// Copy `rows` rows of kCols output channels [o0, o0 + kCols) of group g
// (zeros past opg and where row_src returns -1) into rows of n_pitch bytes
// at dst; row_src(r) is the element offset of row r's channel 0 of group 0.
template <typename T, bool kVec, int kCols, typename RowSrc>
__device__ __forceinline__ void stage_nrows(uint8_t* dst, const T* src,
                                            int rows, int g, int opg, int o0,
                                            RowSrc row_src) {
  constexpr int kP = n_pitch<T>();
  if constexpr (kVec) {
    constexpr int kSeg = kCols * sizeof(T) / 16, kPer = 16 / sizeof(T);
    for (int i = threadIdx.x; i < rows * kSeg; i += blockDim.x) {
      const int r = i / kSeg, s = i % kSeg;
      const int o = o0 + s * kPer;
      const long long at = row_src(r);
      const bool ok = at >= 0 && o < opg;
      cp_async16(smem_u32(dst + r * kP + s * 16),
                 ok ? src + at + g * opg + o : src, ok);
    }
  } else {
    const Raw<T>* sr = reinterpret_cast<const Raw<T>*>(src);
    for (int i = threadIdx.x; i < rows * kCols; i += blockDim.x) {
      const int r = i / kCols, k = i % kCols;
      const int o = o0 + k;
      const long long at = row_src(r);
      reinterpret_cast<Raw<T>*>(dst + r * kP)[k] =
          at >= 0 && o < opg ? sr[at + g * opg + o] : 0;
    }
  }
}

__device__ __forceinline__ uint32_t lds32(const uint8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(bf16* p, float v) {
  *p = __float2bfloat16(v);
}

// ---------------------------------------------------------------------------
// forward: y[n,h,w,g*opg+o] = sum_{dy,dx,c} x[n,h+dy-1,w+dx-1,g*cpg+c] *
// w[dy,dx,c,g*opg+o].  grid (blocks, column blocks, G), 256 threads.
// kWN n-tiles per warp: 4 (warps 4 x 2 over 128 pixels x 64 outputs, each
// 2 m-tiles x 4 n-tiles) or 1 (8 x 1 over 128 pixels x 8 outputs, for
// opg <= 8).  Block b walks tiles b, b + gridDim.x, ...; its (tile, channel
// stage) steps run through one double-buffered pipeline.
// ---------------------------------------------------------------------------
template <typename T, bool kVec, int kWN>
__global__ void __launch_bounds__(kFwdThreads, 2)
gconv3x3_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
                    T* __restrict__ y, int N, int H, int W, int G, int cpg,
                    int opg, Geom geo) {
  constexpr int kc = Op<T>::kc, kks = Op<T>::kstep;
  constexpr bool kF32 = sizeof(T) == 4;
  constexpr int kWarpsN = kWN == 4 ? 2 : 1, kWarpsM = 8 / kWarpsN;
  constexpr int kWM = 8 / kWarpsM;                // m-tiles per warp
  constexpr int kBN = kWarpsN * kWN * 8;          // outputs per block
  constexpr int kHP = kFwdHaloPitch, kWP = n_pitch<T>();
  constexpr int kHalo = kHaloMax * kHP, kStage = fwd_stage_bytes<T>();
  extern __shared__ __align__(16) uint8_t smem[];
  PixRef* halo_tab = reinterpret_cast<PixRef*>(smem + 2 * kStage);
  const int C = G * cpg, F = G * opg;
  const int g = blockIdx.z, o0 = blockIdx.y * kBN;
  const int hw = geo.hw(), npix = geo.npix();
  const int cstages = (cpg + kc - 1) / kc;
  const int tiles = (N + geo.tn - 1) / geo.tn * ((H + geo.th - 1) / geo.th) *
                    ((W + geo.tw - 1) / geo.tw);
  const int steps =
      (tiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x *
      cstages;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int wm = warp % kWarpsM, wn = warp / kWarpsM;
  const bool busy = wm * kWM * 16 < npix && wn * kWN * 8 < opg - o0;
  // this lane's ldmatrix row of each m-tile: pixel (lane & 7) + 8 ((lane >>
  // 3) & 1) (rows past the tile read halo pixel 0 and are never stored),
  // 16-byte column lane >> 4 of the k-step.  Every tile has the same
  // geometry, so these hold for the whole walk.
  int hbase[kWM];
#pragma unroll
  for (int i = 0; i < kWM; ++i) {
    const int p = (wm * kWM + i) * 16 + (lane & 7) + 8 * ((lane >> 3) & 1);
    hbase[i] = p < npix ? geo.hoff(p) : 0;
  }
  const int a_col = 16 * (lane >> 4);
  // bf16 B (ldmatrix.trans): k row and n-tile half of this lane
  const int b_k = (lane & 7) + 8 * ((lane >> 3) & 1), b_j = lane >> 4;
  const int nb = wn * kWN;   // the warp's first n-tile

  float big[kWM][kWN][4], small[kWM][kWN][4];

  auto stage = [&](int s, int buf) {
    uint8_t* hs = smem + buf * kStage;
    const Tile tl = tile_of(blockIdx.x + (s / cstages) * gridDim.x, H, W,
                            geo);
    const int c0 = (s % cstages) * kc;
    stage_halo<T, kVec>(hs, kHP, x, halo_tab, tl, geo, N, H, W, C, g, cpg,
                        c0);
    // weight rows (tap, k): w[tap, c0 + k, :]
    stage_nrows<T, kVec, kBN>(hs + kHalo, w, 9 * kc, g, opg, o0,
                              [&](int r) -> long long {
                                const int c = c0 + r % kc;
                                return c < cpg ? (long long)((r / kc) * cpg +
                                                             c) * F
                                               : -1;
                              });
  };

  fill_tables(halo_tab, nullptr, geo, H, W);
  __syncthreads();
  if (steps > 0) stage(0, 0);
  cp_async_commit();
  for (int s = 0; s < steps; ++s) {
    if (s + 1 < steps) stage(s + 1, (s + 1) & 1);
    cp_async_commit();
    cp_async_wait_prev();
    __syncthreads();
    const int cs = s % cstages;
    if (cs == 0) {
#pragma unroll
      for (int i = 0; i < kWM; ++i)
#pragma unroll
        for (int j = 0; j < kWN; ++j)
#pragma unroll
          for (int k = 0; k < 4; ++k) big[i][j][k] = small[i][j][k] = 0.f;
    }
    const uint8_t* hs = smem + (s & 1) * kStage;
    const uint8_t* ws = hs + kHalo;
    const int nks = min(kc / kks, (cpg - cs * kc + kks - 1) / kks);
    if (busy) {
      for (int tap = 0; tap < 9; ++tap) {
        const int toff = (tap / 3) * hw + tap % 3;
#pragma unroll
        for (int ks = 0; ks < kc / kks; ++ks) {
          if (ks >= nks) continue;
          uint32_t a[kWM][4];
#pragma unroll
          for (int i = 0; i < kWM; ++i)
            ldsm_x4(smem_u32(hs) + (hbase[i] + toff) * kHP + a_col + ks * 32,
                    a[i]);
          const uint8_t* wk = ws + (tap * kc + ks * kks) * kWP;
          if constexpr (kF32) {
            uint32_t ah[kWM][4], al[kWM][4];
#pragma unroll
            for (int i = 0; i < kWM; ++i)
#pragma unroll
              for (int k = 0; k < 4; ++k)
                split_tf32(a[i][k], ah[i][k], al[i][k]);
            // b0 = (k tig, n gid), b1 = (k tig + 4, n gid)
            const uint8_t* wb = wk + tig * kWP + (nb * 8 + gid) * 4;
#pragma unroll
            for (int j = 0; j < kWN; ++j) {
              uint32_t bh0, bl0, bh1, bl1;
              split_tf32(lds32(wb + j * 32), bh0, bl0);
              split_tf32(lds32(wb + 4 * kWP + j * 32), bh1, bl1);
#pragma unroll
              for (int i = 0; i < kWM; ++i) {
                mma_tf32(big[i][j], ah[i], bh0, bh1);
                mma_tf32(small[i][j], ah[i], bl0, bl1);
                mma_tf32(small[i][j], al[i], bh0, bh1);
              }
            }
          } else {
            const uint32_t wb =
                smem_u32(wk) + b_k * kWP + nb * 16 + b_j * 16;
            if constexpr (kWN == 1) {
              uint32_t b[2];
              ldsm_x2_t(wb, b);   // lanes 0-15: n-tile nb
#pragma unroll
              for (int i = 0; i < kWM; ++i)
                mma_bf16(big[i][0], a[i], b[0], b[1]);
            } else {
#pragma unroll
              for (int jj = 0; jj < kWN / 2; ++jj) {
                uint32_t b[4];
                ldsm_x4_t(wb + jj * 32, b);
#pragma unroll
                for (int i = 0; i < kWM; ++i) {
                  mma_bf16(big[i][2 * jj], a[i], b[0], b[1]);
                  mma_bf16(big[i][2 * jj + 1], a[i], b[2], b[3]);
                }
              }
            }
          }
        }
      }
    }
    if (busy && cs == cstages - 1) {
      // D rows gid and gid + 8 of each m-tile, columns 2 tig, 2 tig + 1
      const Tile tl = tile_of(blockIdx.x + (s / cstages) * gridDim.x, H, W,
                              geo);
#pragma unroll
      for (int i = 0; i < kWM; ++i) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const long long at = pixel_at(
              tl, (wm * kWM + i) * 16 + gid + 8 * half, geo, N, H, W, F);
          if (at < 0) continue;
          T* yr = y + at + (size_t)g * opg;
#pragma unroll
          for (int j = 0; j < kWN; ++j) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int o = o0 + (nb + j) * 8 + 2 * tig + e;
              if (o < opg)
                store_out(yr + o, big[i][j][2 * half + e] +
                                      small[i][j][2 * half + e]);
            }
          }
        }
      }
    }
    __syncthreads();   // this step's buffer is free for the next copy
  }
}

// ---------------------------------------------------------------------------
// wgrad partials: ws[s, g, tap * cpg + c, o] = sum over the pixels of split
// s's tiles of x[pixel + tap shift, g*cpg + c] * dy[pixel, g*opg + o].
// grid (splits, channel stages x column blocks, G); kNT n-tiles per block:
// 8 (64 outputs; 6 warps, warp (r, h) owns the 3 taps of tap row r and
// n-tiles 4h .. 4h + 3) or 1 (8 outputs for opg <= 8; 3 warps, one per
// tap row).
// ---------------------------------------------------------------------------
template <int kNT>
constexpr int wgrad_threads() {
  return 3 * (kNT == 8 ? 2 : 1) * 32;
}

template <typename T, bool kVec, int kNT>
__global__ void __launch_bounds__(wgrad_threads<kNT>(), 2)
gconv3x3_wgrad_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                      float* __restrict__ ws, int N, int H, int W, int G,
                      int cpg, int opg, Geom geo) {
  constexpr int kc = Op<T>::kc, kks = Op<T>::kstep;
  constexpr bool kF32 = sizeof(T) == 4;
  constexpr int kBN = kNT * 8;
  constexpr int kWNT = kNT == 8 ? 4 : 1;   // n-tiles per warp
  constexpr int kMT = kc / 16;             // m-tiles per tap: f32 1, bf16 2
  constexpr int kHP = wgrad_halo_pitch<T>(), kNP = n_pitch<T>();
  constexpr int kHalo = kHaloMax * kHP, kStage = wgrad_stage_bytes<T>();
  extern __shared__ __align__(16) uint8_t smem[];
  PixRef* halo_tab = reinterpret_cast<PixRef*>(smem + 2 * kStage);
  PixRef* pix_tab = halo_tab + kHaloMax;
  int* hoff = reinterpret_cast<int*>(pix_tab + kTilePix);
  const int C = G * cpg, F = G * opg;
  const int g = blockIdx.z;
  const int cstages = (cpg + kc - 1) / kc;
  const int c0 = (blockIdx.y % cstages) * kc;
  const int o0 = (blockIdx.y / cstages) * kBN;
  const int hw = geo.hw(), npix = geo.npix();
  const int tiles = (N + geo.tn - 1) / geo.tn * ((H + geo.th - 1) / geo.th) *
                    ((W + geo.tw - 1) / geo.tw);
  const int t0 = (int)((long long)blockIdx.x * tiles / gridDim.x);
  const int t1 = (int)((long long)(blockIdx.x + 1) * tiles / gridDim.x);
  const int nks = (npix + kks - 1) / kks;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int trow = warp % 3, nb = warp / 3 * kWNT;   // tap row, first n-tile
  const int toff = trow * hw;                        // tap (trow, dx): + dx
  // halo pixel of tile pixel p (pixels past the tile: halo pixel 0, whose
  // products meet zero ybar rows)
  for (int p = threadIdx.x; p < kTilePix; p += blockDim.x)
    hoff[p] = p < npix ? geo.hoff(p) : 0;

  // float32: acc[0] big (hi*hi), acc[1] small (hi*lo + lo*hi), one m-tile
  // of 16 channels per tap; bf16: acc[m] is m-tile m of 32 channels
  float acc[2][3][kWNT][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int d = 0; d < 3; ++d)
#pragma unroll
      for (int j = 0; j < kWNT; ++j)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[m][d][j][k] = 0.f;
  const int mtiles = min(kMT, (cpg - c0 + 15) / 16);   // bf16: 1 or 2

  auto stage = [&](int t, int buf) {
    uint8_t* s = smem + buf * kStage;
    const Tile tl = tile_of(t, H, W, geo);
    const long long base = origin_pix(tl, H, W);
    stage_halo<T, kVec>(s, kHP, x, halo_tab, tl, geo, N, H, W, C, g, cpg,
                        c0);
    stage_nrows<T, kVec, kBN>(s + kHalo, dy, kTilePix, g, opg, o0,
                              [&](int p) -> long long {
                                if (p >= npix) return -1;
                                const PixRef e = pix_tab[p];
                                return inside(e, tl, 0, N, H, W)
                                           ? (base + e.rel) * F
                                           : -1;
                              });
  };

  fill_tables(halo_tab, pix_tab, geo, H, W);
  __syncthreads();
  if (t0 < t1) stage(t0, 0);
  cp_async_commit();
  for (int t = t0, i = 0; t < t1; ++t, ++i) {
    if (t + 1 < t1) stage(t + 1, (i + 1) & 1);
    cp_async_commit();
    cp_async_wait_prev();
    __syncthreads();
    const uint8_t* hs = smem + (i & 1) * kStage;
    const uint8_t* ys = hs + kHalo;
    if constexpr (kF32) {
      for (int ks = 0; ks < nks; ++ks) {
        // tap dx: a0 = (c gid, p tig), a1 = (c gid + 8, p tig), a2 = (c
        // gid, p tig + 4), a3 = (c gid + 8, p tig + 4)
        const int p0 = ks * 8 + tig;
        const uint8_t* xa = hs + (hoff[p0] + toff) * kHP + gid * 4;
        const uint8_t* xb = hs + (hoff[p0 + 4] + toff) * kHP + gid * 4;
        uint32_t ah[3][4], al[3][4];
#pragma unroll
        for (int d = 0; d < 3; ++d) {
          const uint32_t a[4] = {lds32(xa + d * kHP), lds32(xa + d * kHP + 32),
                                 lds32(xb + d * kHP), lds32(xb + d * kHP + 32)};
#pragma unroll
          for (int k = 0; k < 4; ++k) split_tf32(a[k], ah[d][k], al[d][k]);
        }
        // b0 = (p tig, o gid), b1 = (p tig + 4, o gid)
        const uint8_t* yb = ys + p0 * kNP + (nb * 8 + gid) * 4;
#pragma unroll
        for (int j = 0; j < kWNT; ++j) {
          uint32_t bh0, bl0, bh1, bl1;
          split_tf32(lds32(yb + j * 32), bh0, bl0);
          split_tf32(lds32(yb + 4 * kNP + j * 32), bh1, bl1);
#pragma unroll
          for (int d = 0; d < 3; ++d) {
            mma_tf32(acc[0][d][j], ah[d], bh0, bh1);
            mma_tf32(acc[1][d][j], ah[d], bl0, bl1);
            mma_tf32(acc[1][d][j], al[d], bh0, bh1);
          }
        }
      }
    } else {
      // A (ldmatrix.trans of halo rows): matrix q = lane >> 3 holds
      // channels 8 (q & 1) .. of pixels 8 (q >> 1) .. of the k-step;
      // B (ldmatrix.trans of ybar rows): pixels 8 ((lane >> 3) & 1) ..,
      // n-tile nb + 2 jj + (lane >> 4)
      const int a_p = (lane & 7) + 8 * (lane >> 4);
      const int a_c = 16 * ((lane >> 3) & 1);
      const int b_p = (lane & 7) + 8 * ((lane >> 3) & 1);
      const uint32_t ybase = smem_u32(ys) + nb * 16 + (lane >> 4) * 16;
      for (int ks = 0; ks < nks; ++ks) {
        const uint32_t xrow =
            smem_u32(hs) + (hoff[ks * 16 + a_p] + toff) * kHP + a_c;
        uint32_t a[3][2][4];
#pragma unroll
        for (int d = 0; d < 3; ++d) {
          ldsm_x4_t(xrow + d * kHP, a[d][0]);
          if (mtiles > 1) ldsm_x4_t(xrow + d * kHP + 32, a[d][1]);
        }
        const uint32_t yrow = ybase + (ks * 16 + b_p) * kNP;
        if constexpr (kWNT == 1) {
          uint32_t b[2];
          ldsm_x2_t(yrow, b);   // lanes 0-15
#pragma unroll
          for (int d = 0; d < 3; ++d) {
            mma_bf16(acc[0][d][0], a[d][0], b[0], b[1]);
            if (mtiles > 1) mma_bf16(acc[1][d][0], a[d][1], b[0], b[1]);
          }
        } else {
#pragma unroll
          for (int jj = 0; jj < kWNT / 2; ++jj) {
            uint32_t b[4];
            ldsm_x4_t(yrow + jj * 32, b);
#pragma unroll
            for (int d = 0; d < 3; ++d) {
              mma_bf16(acc[0][d][2 * jj], a[d][0], b[0], b[1]);
              mma_bf16(acc[0][d][2 * jj + 1], a[d][0], b[2], b[3]);
              if (mtiles > 1) {
                mma_bf16(acc[1][d][2 * jj], a[d][1], b[0], b[1]);
                mma_bf16(acc[1][d][2 * jj + 1], a[d][1], b[2], b[3]);
              }
            }
          }
        }
      }
    }
    __syncthreads();   // this tile's buffers are free for the next copy
  }
  // D rows gid, gid + 8 (channels), columns 2 tig, 2 tig + 1 (outputs)
  const int K9 = 9 * cpg;
  float* wsg = ws + ((size_t)blockIdx.x * G + g) * K9 * opg;
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    if (kF32 ? m > 0 : m >= mtiles) continue;
#pragma unroll
    for (int d = 0; d < 3; ++d) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int c = c0 + m * 16 + gid + 8 * half;
        if (c >= cpg) continue;
        float* row = wsg + (size_t)((3 * trow + d) * cpg + c) * opg;
#pragma unroll
        for (int j = 0; j < kWNT; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int o = o0 + (nb + j) * 8 + 2 * tig + e;
            if (o < opg)
              row[o] = kF32 ? acc[0][d][j][2 * half + e] +
                                  acc[1][d][j][2 * half + e]
                            : acc[m][d][j][2 * half + e];
          }
        }
      }
    }
  }
}

// dw[tap, c, g*opg+o] = sum_split ws[split, g, tap*cpg+c, o], in split order.
template <typename T>
__global__ void gconv3x3_wgrad_reduce_kernel(const float* __restrict__ ws,
                                             T* __restrict__ dw, int G,
                                             int cpg, int opg, int splits) {
  const int K9 = 9 * cpg;
  const int total = G * K9 * opg;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int o = idx % opg;
  const int r = (idx / opg) % K9;
  const int g = idx / (opg * K9);
  float s = 0.f;
  for (int sp = 0; sp < splits; ++sp) s += ws[(size_t)sp * total + idx];
  store_out(dw + (size_t)r * G * opg + (size_t)g * opg + o, s);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// 16-byte staging needs 16-byte channel rows of a group and 16-byte
// aligned operands; otherwise the plain-load staging
template <typename T>
bool vec_ok(int cpg, int opg, const void* a, const void* b) {
  return cpg * sizeof(T) % 16 == 0 && opg * sizeof(T) % 16 == 0 &&
         aligned16(a) && aligned16(b);
}

bool tile_ok(Geom geo) {
  return geo.tn >= 1 && geo.th >= 1 && geo.tw >= 1 &&
         geo.npix() <= kTilePix && geo.tn * geo.img_halo() <= kHaloMax;
}

template <typename K>
int set_smem(K kernel, int bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      reinterpret_cast<const void*>(kernel),
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

// output channels of a block: 64, or 8 where opg <= 8
int block_cols(int opg) { return opg <= 8 ? 8 : kNT; }

template <typename T, bool kVec, int kWN>
int launch_fwd(const void* x, const void* w, void* y, int N, int H, int W,
               int G, int cpg, int opg, Geom geo, int blocks,
               cudaStream_t stream) {
  const int smem = smem_bytes<T>(0);
  const int err = set_smem(gconv3x3_fwd_kernel<T, kVec, kWN>, smem);
  if (err) return err;
  const dim3 grid(blocks, (opg + block_cols(opg) - 1) / block_cols(opg), G);
  gconv3x3_fwd_kernel<T, kVec, kWN><<<grid, kFwdThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(y),
      N, H, W, G, cpg, opg, geo);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kVec, int kNT>
int launch_wgrad(const void* x, const void* dy, float* ws, void* dw, int N,
                 int H, int W, int G, int cpg, int opg, Geom geo,
                 int splits, cudaStream_t stream) {
  const int smem = smem_bytes<T>(1);
  int err = set_smem(gconv3x3_wgrad_kernel<T, kVec, kNT>, smem);
  if (err) return err;
  const int cstages = (cpg + Op<T>::kc - 1) / Op<T>::kc;
  const dim3 grid(splits, cstages * ((opg + kNT * 8 - 1) / (kNT * 8)), G);
  constexpr int kThreads = wgrad_threads<kNT>();
  gconv3x3_wgrad_kernel<T, kVec, kNT><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), ws, N, H, W, G,
      cpg, opg, geo);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  const int total = G * 9 * cpg * opg;
  gconv3x3_wgrad_reduce_kernel<T><<<(total + 255) / 256, 256, 0, stream>>>(
      ws, static_cast<T*>(dw), G, cpg, opg, splits);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int fwd_dtype(const void* x, const void* w, void* y, int N, int H, int W,
              int G, int cpg, int opg, Geom geo, int blocks,
              cudaStream_t s) {
  const bool vec = vec_ok<T>(cpg, opg, x, w) && aligned16(y);
  if (opg <= 8)
    return vec ? launch_fwd<T, true, 1>(x, w, y, N, H, W, G, cpg, opg, geo,
                                        blocks, s)
               : launch_fwd<T, false, 1>(x, w, y, N, H, W, G, cpg, opg, geo,
                                         blocks, s);
  return vec ? launch_fwd<T, true, 4>(x, w, y, N, H, W, G, cpg, opg, geo,
                                      blocks, s)
             : launch_fwd<T, false, 4>(x, w, y, N, H, W, G, cpg, opg, geo,
                                       blocks, s);
}

template <typename T>
int wgrad_dtype(const void* x, const void* dy, float* ws, void* dw, int N,
                int H, int W, int G, int cpg, int opg, Geom geo,
                int splits, cudaStream_t s) {
  const bool vec = vec_ok<T>(cpg, opg, x, dy);
  if (opg <= 8)
    return vec ? launch_wgrad<T, true, 1>(x, dy, ws, dw, N, H, W, G, cpg,
                                          opg, geo, splits, s)
               : launch_wgrad<T, false, 1>(x, dy, ws, dw, N, H, W, G, cpg,
                                           opg, geo, splits, s);
  return vec ? launch_wgrad<T, true, 8>(x, dy, ws, dw, N, H, W, G, cpg, opg,
                                        geo, splits, s)
             : launch_wgrad<T, false, 8>(x, dy, ws, dw, N, H, W, G, cpg, opg,
                                         geo, splits, s);
}

}  // namespace

// Dynamic shared memory of the forward (kind 0) or the wgrad (kind 1) in
// dtype 0 = float32, 1 = bfloat16, at group widths cpg -> opg: a constant
// of the tile bound (the widths are staged in 64-byte stages and 64-wide
// column blocks); ops/gconv.py::generic_smem_bytes mirrors it.
extern "C" int mdd_gconv3x3_generic_smem(int kind, int dtype, int cpg,
                                         int opg) {
  (void)cpg;
  (void)opg;
  return dtype == 0 ? smem_bytes<float>(kind) : smem_bytes<bf16>(kind);
}

// dtype: 0 = float32, 1 = bfloat16.  Tiles of tn images x th x tw output
// pixels (at most 128 pixels and 200 halo pixels); blocks per group and
// column block (at most the number of tiles): block b takes tiles b,
// b + blocks, ...
extern "C" int mdd_gconv3x3_fwd(const void* x, const void* w, void* y, int N,
                                int H, int W, int G, int cpg, int opg, int tn,
                                int th, int tw, int blocks, int dtype,
                                void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Geom geo{tn, th, tw};
  if (!tile_ok(geo) || blocks < 1 ||
      blocks > (long long)((N + tn - 1) / tn) * ((H + th - 1) / th) *
                   ((W + tw - 1) / tw))
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return fwd_dtype<float>(x, w, y, N, H, W, G, cpg, opg, geo, blocks, s);
  if (dtype == 1)
    return fwd_dtype<bf16>(x, w, y, N, H, W, G, cpg, opg, geo, blocks, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// ws: float32 workspace of splits * G * 9 * cpg * opg elements; every
// element is written before it is read.  Split s sums the tiles [s * T /
// splits, (s + 1) * T / splits) of the T tiles of tn x th x tw pixels.
extern "C" int mdd_gconv3x3_wgrad(const void* x, const void* dy, void* ws,
                                  void* dw, int N, int H, int W, int G,
                                  int cpg, int opg, int tn, int th, int tw,
                                  int splits, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* wsf = static_cast<float*>(ws);
  const Geom geo{tn, th, tw};
  if (!tile_ok(geo) || splits < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return wgrad_dtype<float>(x, dy, wsf, dw, N, H, W, G, cpg, opg, geo,
                              splits, s);
  if (dtype == 1)
    return wgrad_dtype<bf16>(x, dy, wsf, dw, N, H, W, G, cpg, opg, geo,
                             splits, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
