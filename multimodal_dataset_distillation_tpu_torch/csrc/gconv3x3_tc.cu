// Grouped 3x3, stride-1, TF-SAME convolution on Hopper's tensor cores
// (sm_90a): forward and weight gradient for bfloat16 operands with 64 input
// and 64 output channels per group (every grouped site of NFNet-L0), NHWC
// activations x HWIO weights, float32 accumulation, bfloat16 output.
//
// Replaces the two Pallas TPU kernels of
// multimodal_dataset_distillation_tpu/ops/pallas_gconv.py at that width:
//   * _spatial_kernel (the pallas_call in _pallas_spatial)
//       -> gconv3x3_fwd_tc_kernel.  It is also the input gradient (dgrad):
//          the forward conv on rot_swap(w) (ops/gconv.py).
//   * _wgrad_kernel (the pallas_call in _pallas_wgrad)
//       -> gconv3x3_wgrad_tc_kernel + gconv3x3_wgrad_tc_reduce_kernel.
// Other widths and float32 stay on the CUDA-core kernels of gconv3x3.cu;
// ops/gconv.py picks by dtype and shape.
//
// What bounds it on the card.  Each output element costs 2 * 9 * 64 = 1152
// FLOP against ~4 bytes of bf16 activations in and out: ~288 FLOP per byte,
// at the H100's ridge (~295), so the tensor-core rate and the bytes set
// about the same bound (~12 us at 100x28x28x128).  The CUDA-core kernels
// of gconv3x3.cu are 35-85x above it: f32 FMAs, and every input pixel read
// from device memory once per tap.  These kernels reach 0.3-0.4 of the
// bound (PERF.md); what is left is the per-tile synchronisation and, for
// the wgrad, the f32 partials (PERF.md, ROADMAP.md B1/B2).
//
// Design.
//   * Implicit GEMM per group on wgmma m64n64k16 (bf16 in, f32 sums in
//     registers).  A comes from registers, loaded with ldmatrix from
//     per-lane row addresses; B from shared memory through a descriptor.
//   * Forward: a block keeps its group's whole weight (9 x 64 x 64 bf16 =
//     72 KB, the B operand) resident in shared memory and walks pixel tiles
//     (persistent blocks, grid = (blocks per group, groups)).  A tile of
//     128 flattened (n, h, w) pixels needs the pixel rows m0-W-1 ..
//     m0+128+W: one contiguous run, copied once into shared memory with
//     cp.async (16 B per lane).  Each tap is a shifted window of that halo.
//     The halo is double-buffered: the next tile's copy runs under this
//     tile's MMAs.  Two warpgroups of 64 pixels each; per tap a warpgroup
//     issues its 4 k16 steps as one wgmma group while the next tap's A
//     fragments load.  The outputs are staged in the read halo buffer and
//     leave in 16-byte coalesced stores (4-byte stores straight from the
//     accumulators cost a third of the time).
//   * Padding comes from indices: each lane knows the (h, w) of the pixel
//     row it feeds to ldmatrix and, per tap, points at the halo row or at a
//     zero row in shared memory (a shift of -1 at w = 0 would otherwise
//     land on the previous row's last pixel, -W at h = 0 in the previous
//     image).
//   * Every 128-byte shared row (64 channels) is stored with its 16-byte
//     chunks XOR-swizzled by (row & 7), rows 1024-byte aligned in groups of
//     8: the 8 rows one ldmatrix phase reads hit 8 different bank groups for
//     every shift, and the weight and ybar tiles are in wgmma's 128-byte
//     swizzle layout.
//   * Wgrad: dW_tap[c, o] = sum_m x[m + shift_tap, c] * ybar[m, o].  A block
//     owns one group and a fixed range of pixel tiles (split-K over
//     pixels); per tile it copies the x halo and the ybar tile into shared
//     memory once and accumulates all 9 taps from them: warpgroup q owns
//     the taps of row dy = q - 1, 3 x 64 x 64 f32 accumulators (96
//     registers a thread).  A (x^T) comes from the x halo through
//     ldmatrix.trans with a per-pixel row address (zero row for padding),
//     B is the ybar tile (o contiguous: N-major, transposed B).  Each block
//     writes its f32 partial; a second kernel adds the partials in split
//     order: no atomics, bit-identical on repeat.
//   * One rounding: f32 sums are rounded to bf16 in the epilogue.
//
// Interface: plain C functions (ctypes), launched on the caller's stream;
// each returns cudaGetLastError() after its launches.  The caller
// allocates outputs and the wgrad workspace and plans the grids
// (ops/gconv.py); any grid is correct, the plan only balances the work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kCh = 64;                      // channels per group, in and out
constexpr int kRow = kCh * 2;                // bytes of one pixel's group row
constexpr int kTile = 128;                   // pixels per tile
constexpr int kWBytes = 9 * kCh * kRow;      // one group's weight: 73,728 B
constexpr int kFwdThreads = 256;             // 2 warpgroups x 64 pixels
constexpr int kWgThreads = 384;              // 3 warpgroups x 3 taps (one dy)
constexpr int kAlign = 1024;                 // 128-byte swizzle atom

// pixel rows a tile reads: one image row and one pixel beyond each end
__host__ __device__ constexpr int halo_rows(int W) { return kTile + 2 * W + 2; }

// [align slack][weights][2 x halo][zero row]
__host__ __device__ constexpr int fwd_smem_bytes(int W) {
  return kAlign + kWBytes + 2 * halo_rows(W) * kRow + kRow;
}

// [align slack][2 x ybar tile][2 x halo][2 x tap masks][zero row]
__host__ __device__ constexpr int wgrad_smem_bytes(int W) {
  return kAlign + 2 * (kTile + halo_rows(W)) * kRow + 2 * kTile * 2 + kRow;
}

// byte offset of 16-byte chunk `chunk` of shared row `row`
__device__ __forceinline__ uint32_t swz(int row, int chunk) {
  return static_cast<uint32_t>(row * kRow + ((chunk ^ (row & 7)) << 4));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; when !ok the 16 bytes are zero-filled and
// nothing is read (src must still be a valid address).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// wgmma: D (64 x 64, f32, 32 registers a thread) += A (64 x 16 bf16, from
// registers: warp w of the warpgroup holds rows 16w..16w+15 in the
// mma.m16n8k16 A-fragment layout) x B (16 x 64 bf16 in shared memory).
// B is N-major (64 outputs of one k row contiguous, 128 bytes), stored
// with the 128-byte swizzle (16-byte chunk ^ (row & 7), rows 1024-byte
// aligned in groups of 8): descriptor stride between 8-row groups 1024 B,
// one 64-wide atom along N, transposed B (imm-trans-b = 1).
__device__ __forceinline__ uint64_t desc_b128(uint32_t saddr) {
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps registers read by an in-flight wgmma alive (and in place) until
// here: the compiler does not know the instruction is asynchronous
__device__ __forceinline__ void keep(uint32_t (&r)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(r[i])::"memory");
}
__device__ __forceinline__ void keep(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// all writes this thread made to shared memory (cp.async included, once
// waited for) become visible to wgmma's reads
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma64(float (&d)[32], const uint32_t (&a)[4],
                                        uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// 9-bit mask of the taps (dy, dx) = (t/3 - 1, t%3 - 1) whose source pixel
// of output pixel m lies inside the image; 0 for m outside [0, M).
__device__ __forceinline__ uint32_t tap_mask(int m, int M, int H, int W) {
  if (m < 0 || m >= M) return 0u;
  const int wc = m % W, hr = (m / W) % H;
  uint32_t mask = 0u;
#pragma unroll
  for (int t = 0; t < 9; ++t) {
    const int hh = hr + t / 3 - 1, ww = wc + t % 3 - 1;
    if (hh >= 0 && hh < H && ww >= 0 && ww < W) mask |= 1u << t;
  }
  return mask;
}

// Copy the halo of the pixel tile starting at m0 (rows m0-W-1 ..
// m0+kTile+W of group g) into the swizzled buffer at dst; rows outside
// [0, M) are zero.
template <int kThreads>
__device__ __forceinline__ void load_halo(const bf16* __restrict__ x,
                                          uint32_t dst, int m0, int M, int W,
                                          int C, int g) {
  const int rows = halo_rows(W);
  const int p0 = m0 - W - 1;
  for (int i = threadIdx.x; i < rows * 8; i += kThreads) {
    const int j = i >> 3, ch = i & 7;
    const int p = p0 + j;
    const bool ok = p >= 0 && p < M;
    cp_async16(dst + swz(j, ch),
               x + (size_t)(ok ? p : 0) * C + g * kCh + ch * 8, ok);
  }
}

// y[n,h,w,g*64+o] = sum_{dy,dx,c} x[n,h+dy-1,w+dx-1,g*64+c] * w[dy,dx,c,g*64+o]
// grid: (blocks per group, G); each block walks tiles blockIdx.x,
// blockIdx.x + gridDim.x, ... of 128 pixels of M = N*H*W.  Warpgroup q
// computes pixels 64q .. 64q+63 of a tile, all 64 outputs.  Per tap, a warp
// loads the A fragments of all 4 k16 steps and the warpgroup issues the 4
// wgmmas as one group; the next tap's fragments are loaded while that
// group runs (A double-buffered by tap parity).
__global__ void __launch_bounds__(kFwdThreads, 2)
gconv3x3_fwd_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                       bf16* __restrict__ y, int N, int H, int W, int G) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + kAlign - 1) & ~(kAlign - 1);
  const int C = G * kCh, M = N * H * W;
  const int g = blockIdx.y;
  const int tiles = (M + kTile - 1) / kTile;
  const int halo_bytes = halo_rows(W) * kRow;
  const uint32_t s_w = base;
  const uint32_t s_halo = base + kWBytes;
  const uint32_t s_zero = s_halo + 2 * halo_bytes;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  if (tid < 8)
    *reinterpret_cast<uint4*>(smem_raw + (s_zero - raw) + tid * 16) =
        make_uint4(0u, 0u, 0u, 0u);
  const bf16* wg = w + g * kCh;
  for (int i = tid; i < 9 * kCh * 8; i += kFwdThreads) {
    const int r = i >> 3, ch = i & 7;   // r = tap*64 + c
    cp_async16(s_w + swz(r, ch), wg + (size_t)r * C + ch * 8, true);
  }
  int tile = blockIdx.x;
  if (tile < tiles) load_halo<kFwdThreads>(x, s_halo, tile * kTile, M, W, C, g);
  cp_async_commit();

  // this lane's A row (ldmatrix, mma.m16n8k16 A layout): pixel `local` of
  // the tile, channel chunk 2*ks + (lane >> 4) of k16 step ks
  const int local = (warp >> 2) * 64 + (warp & 3) * 16 + (lane & 15);
  const int a_hi = lane >> 4;

  for (int it = 0; tile < tiles; ++it, tile += gridDim.x) {
    const uint32_t s_cur = s_halo + (it & 1) * halo_bytes;
    const int next = tile + gridDim.x;
    if (next < tiles)
      load_halo<kFwdThreads>(x, s_halo + ((it + 1) & 1) * halo_bytes,
                             next * kTile, M, W, C, g);
    cp_async_commit();
    cp_async_wait<1>();
    fence_async_shared();
    __syncthreads();

    const int m0 = tile * kTile;
    const uint32_t vmask = tap_mask(m0 + local, M, H, W);
    float acc[32];
    uint32_t a[2][4][4] = {};
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    keep(acc);

#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int buf = tap & 1;
      const int j = local + W + 1 + (tap / 3 - 1) * W + (tap % 3 - 1);
      const uint32_t a_addr = ((vmask >> tap) & 1u)
                                  ? s_cur + j * kRow + ((a_hi ^ (j & 7)) << 4)
                                  : s_zero + (a_hi << 4);
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) ldsm_x4(a_addr ^ (ks << 5), a[buf][ks]);
      wgmma_fence();
      const uint32_t b_tap = s_w + tap * (kCh * kRow);
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        wgmma64(acc, a[buf][ks], desc_b128(b_tap + ks * (16 * kRow)));
      wgmma_commit();
      wgmma_wait<1>();   // the previous tap's A registers are free
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) keep(a[buf ^ 1][ks]);
    }
    wgmma_wait<0>();
    keep(acc);
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      keep(a[0][ks]);
      keep(a[1][ks]);
    }

    // Epilogue through shared memory: the tile's halo is read, so its
    // buffer takes the 128 x 64 bf16 outputs (row r, 16-byte chunk
    // ^ (r & 7)), which leave in 16-byte coalesced stores.  acc[4j + e] is
    // tile row 64*(warp>>2) + 16*(warp&3) + (lane>>2) (+8 for e >= 2),
    // output 8j + 2*(lane&3) + (e&1).
    __syncthreads();
    uint8_t* const st = smem_raw + (s_cur - raw);
#pragma unroll
    for (int h8 = 0; h8 < 2; ++h8) {
      const int r = (warp >> 2) * 64 + (warp & 3) * 16 + (lane >> 2) + h8 * 8;
#pragma unroll
      for (int jn = 0; jn < 8; ++jn)
        *reinterpret_cast<__nv_bfloat162*>(
            st + r * kRow + ((jn ^ (r & 7)) << 4) + (lane & 3) * 4) =
            __floats2bfloat162_rn(acc[jn * 4 + h8 * 2],
                                  acc[jn * 4 + h8 * 2 + 1]);
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kTile * 8 / kFwdThreads; ++i) {
      const int idx = i * kFwdThreads + tid;
      const int r = idx >> 3, ch = idx & 7;
      if (m0 + r < M)
        *reinterpret_cast<uint4*>(y + (size_t)(m0 + r) * C + g * kCh +
                                  ch * 8) =
            *reinterpret_cast<const uint4*>(st + r * kRow +
                                            ((ch ^ (r & 7)) << 4));
    }
    __syncthreads();  // s_cur is refilled two tiles on
  }
  cp_async_wait<0>();
}

// Partial weight gradient of group blockIdx.y over the pixel tiles
// [blockIdx.x * tiles_per_split, +tiles_per_split):
// ws[split, g, tap, c, o] = sum_m x[m + shift_tap, g*64+c] * dy[m, g*64+o].
// Warpgroup q accumulates the taps (dy, dx) = (q - 1, -1..1): 64 c x 64 o
// each.
__global__ void __launch_bounds__(kWgThreads, 1)
gconv3x3_wgrad_tc_kernel(const bf16* __restrict__ x,
                         const bf16* __restrict__ dy, float* __restrict__ ws,
                         int N, int H, int W, int G, int tiles_per_split) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + kAlign - 1) & ~(kAlign - 1);
  const int C = G * kCh, M = N * H * W;
  const int split = blockIdx.x, g = blockIdx.y;
  const int tiles = (M + kTile - 1) / kTile;
  const int t0 = split * tiles_per_split;
  const int t1 = min(tiles, t0 + tiles_per_split);
  const int halo_bytes = halo_rows(W) * kRow;
  const uint32_t s_y = base;                           // 2 x ybar tile
  const uint32_t s_x = s_y + 2 * kTile * kRow;         // 2 x halo
  const uint32_t s_mask = s_x + 2 * halo_bytes;        // 2 x uint16[128]
  uint16_t* const mask = reinterpret_cast<uint16_t*>(smem_raw + (s_mask - raw));
  const uint32_t s_zero = s_mask + 2 * kTile * 2;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q = warp >> 2;  // warpgroup: taps 3q .. 3q+2

  if (tid < 8)
    *reinterpret_cast<uint4*>(smem_raw + (s_zero - raw) + tid * 16) =
        make_uint4(0u, 0u, 0u, 0u);

  auto load_stage = [&](int t, int buf) {
    const int m0 = t * kTile;
    load_halo<kWgThreads>(x, s_x + buf * halo_bytes, m0, M, W, C, g);
    const uint32_t dst = s_y + buf * (kTile * kRow);
    for (int i = tid; i < kTile * 8; i += kWgThreads) {
      const int j = i >> 3, ch = i & 7;
      const int p = m0 + j;
      const bool ok = p < M;
      cp_async16(dst + swz(j, ch),
                 dy + (size_t)(ok ? p : 0) * C + g * kCh + ch * 8, ok);
    }
    if (tid < kTile) mask[buf * kTile + tid] = tap_mask(m0 + tid, M, H, W);
  };

  float acc[3][32];
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[a][i] = 0.f;
#pragma unroll
  for (int a = 0; a < 3; ++a) keep(acc[a]);

  // A (x^T: 64 c x 16 pixels) rows of this lane, for ldmatrix.trans:
  // pixel (lane & 7) + 8 * (lane >> 4) of a k16 step, channel chunk
  // 2 * (warp & 3) + ((lane >> 3) & 1), i.e. c rows 16*(warp&3) .. +15.
  const int a_pix = (lane & 7) + ((lane >> 4) << 3);
  const int a_chunk = 2 * (warp & 3) + ((lane >> 3) & 1);
  int shift[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) shift[a] = W + 1 + (q - 1) * W + (a - 1);
  uint32_t af[2][3][4] = {};

  if (t0 < t1) load_stage(t0, 0);
  cp_async_commit();
  for (int t = t0, it = 0; t < t1; ++t, ++it) {
    const int buf = it & 1;
    if (t + 1 < t1) load_stage(t + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    fence_async_shared();
    __syncthreads();

    const uint32_t sx = s_x + buf * halo_bytes;
    const uint32_t sy = s_y + buf * (kTile * kRow);
    const uint16_t* mk = mask + buf * kTile;
#pragma unroll
    for (int ks = 0; ks < kTile / 16; ++ks) {
      const int ab = ks & 1;
      const int pix = ks * 16 + a_pix;
      const uint32_t vm = mk[pix] >> (q * 3);
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const int j = pix + shift[a];
        ldsm_x4_t(((vm >> a) & 1u)
                      ? sx + j * kRow + ((a_chunk ^ (j & 7)) << 4)
                      : s_zero + (a_chunk << 4),
                  af[ab][a]);
      }
      wgmma_fence();
      const uint64_t desc = desc_b128(sy + ks * (16 * kRow));
#pragma unroll
      for (int a = 0; a < 3; ++a) wgmma64(acc[a], af[ab][a], desc);
      wgmma_commit();
      wgmma_wait<1>();   // the previous step's A registers are free
#pragma unroll
      for (int a = 0; a < 3; ++a) keep(af[ab ^ 1][a]);
    }
    wgmma_wait<0>();   // this stage's ybar tile is read: it may be refilled
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      keep(af[0][a]);
      keep(af[1][a]);
    }
    __syncthreads();
  }
  cp_async_wait<0>();
#pragma unroll
  for (int a = 0; a < 3; ++a) keep(acc[a]);

  // acc[a][4j + e]: c = 16*(warp&3) + (lane>>2) (+8 for e >= 2),
  // o = 8j + 2*(lane&3) + (e&1)
  float* const wsg = ws + ((size_t)split * G + g) * 9 * kCh * kCh;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    float* const wt = wsg + (size_t)(q * 3 + a) * kCh * kCh;
#pragma unroll
    for (int h8 = 0; h8 < 2; ++h8) {
      const int c = (warp & 3) * 16 + (lane >> 2) + h8 * 8;
#pragma unroll
      for (int jn = 0; jn < 8; ++jn)
        *reinterpret_cast<float2*>(wt + c * kCh + jn * 8 + (lane & 3) * 2) =
            make_float2(acc[a][jn * 4 + h8 * 2], acc[a][jn * 4 + h8 * 2 + 1]);
    }
  }
}

// dw[tap, c, g*64 + o] = sum over splits, in split order, of
// ws[split, g, tap, c, o]; four outputs per thread.
__global__ void gconv3x3_wgrad_tc_reduce_kernel(const float* __restrict__ ws,
                                                bf16* __restrict__ dw, int G,
                                                int splits) {
  const int per_group = 9 * kCh * kCh;
  const int total4 = G * per_group / 4;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total4) return;
  const int e = idx * 4;
  const int g = e / per_group, r = e % per_group;  // r = (tap*64 + c)*64 + o
  const float4* src = reinterpret_cast<const float4*>(ws) + idx;
  float4 s = *src;
  for (int sp = 1; sp < splits; ++sp) {
    const float4 v = src[(size_t)sp * total4];
    s.x += v.x;
    s.y += v.y;
    s.z += v.z;
    s.w += v.w;
  }
  const int tc = r / kCh, o = r % kCh;
  __nv_bfloat162* out = reinterpret_cast<__nv_bfloat162*>(
      dw + (size_t)tc * G * kCh + g * kCh + o);
  out[0] = __floats2bfloat162_rn(s.x, s.y);
  out[1] = __floats2bfloat162_rn(s.z, s.w);
}

int set_smem(const void* kernel, int bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

}  // namespace

// Dynamic shared memory of each kernel at image width W (the wrapper
// refuses widths whose need exceeds the card's 227 KB per block).
extern "C" int mdd_gconv3x3_tc_smem(int which, int W) {
  return which == 0 ? fwd_smem_bytes(W) : wgrad_smem_bytes(W);
}

extern "C" int mdd_gconv3x3_fwd_tc(const void* x, const void* w, void* y,
                                   int N, int H, int W, int G,
                                   int blocks_per_group, void* stream) {
  const int smem = fwd_smem_bytes(W);
  int err = set_smem(reinterpret_cast<const void*>(gconv3x3_fwd_tc_kernel),
                     smem);
  if (err) return err;
  gconv3x3_fwd_tc_kernel<<<dim3(blocks_per_group, G), kFwdThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w),
      static_cast<bf16*>(y), N, H, W, G);
  return static_cast<int>(cudaGetLastError());
}

// ws: float32 workspace of splits * G * 9 * 64 * 64 elements; every
// element is written before it is read.  Split s covers pixel tiles
// [s * tiles_per_split, (s + 1) * tiles_per_split) of 128 pixels.
extern "C" int mdd_gconv3x3_wgrad_tc(const void* x, const void* dy, void* ws,
                                     void* dw, int N, int H, int W, int G,
                                     int splits, int tiles_per_split,
                                     void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int smem = wgrad_smem_bytes(W);
  int err = set_smem(reinterpret_cast<const void*>(gconv3x3_wgrad_tc_kernel),
                     smem);
  if (err) return err;
  gconv3x3_wgrad_tc_kernel<<<dim3(splits, G), kWgThreads, smem, s>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(dy),
      static_cast<float*>(ws), N, H, W, G, tiles_per_split);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  const int total4 = G * 9 * kCh * kCh / 4;
  gconv3x3_wgrad_tc_reduce_kernel<<<(total4 + 255) / 256, 256, 0, s>>>(
      static_cast<const float*>(ws), static_cast<bf16*>(dw), G, splits);
  return static_cast<int>(cudaGetLastError());
}
