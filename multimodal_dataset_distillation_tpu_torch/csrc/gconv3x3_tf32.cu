// Grouped 3x3, stride-1, TF-SAME convolution on Hopper's tensor cores
// (sm_90a) for float32 operands with 64 input and 64 output channels per
// group (every grouped site of NFNet-L0), NHWC activations, HWIO weights,
// float32 in and out, at float32 accuracy through three TF32 passes: the
// forward (also the input gradient, on rot_swap(w)) and the weight gradient.
//
// Replaces the two Pallas TPU kernels of
// multimodal_dataset_distillation_tpu/ops/pallas_gconv.py for float32
// operands at that width:
//   * _spatial_kernel (the pallas_call in _pallas_spatial)
//       -> gconv3x3_fwd_tf32_prep_kernel + gconv3x3_fwd_tf32_kernel;
//   * _wgrad_kernel (the pallas_call in _pallas_wgrad)
//       -> gconv3x3_wgrad_tf32_kernel + gconv3x3_wgrad_tf32_reduce_kernel.
// Other widths stay on the CUDA-core kernels of gconv3x3.cu, bfloat16 on
// gconv3x3_tc.cu; ops/gconv.py picks by dtype and shape.
//
// What bounds them on the card.  The tensor cores take float32 only as TF32
// (10 mantissa bits): one pass misses by ~3e-4 of the largest value, too
// coarse for float32.  Each operand is split into hi + lo, both TF32, and
// hi*hi + hi*lo + lo*hi is summed in float32 (lo*lo, ~2^-22 relative, is
// dropped): three times the products, so the bound is 3 x 2 * 9 * 64 FLOP
// per output element at the card's 495 TFLOP/s TF32 rate (0.854 ms per
// NFNet-L0 tower pass at mini-batch 100, against 2.103 ms for one float32
// pass at the CUDA cores' 67 TFLOP/s).  The float32 operands take a third
// of that at 3.35 TB/s.
//
// Shared by both (the operand path):
//   * wgmma m64n64k8 tf32, A from registers, B from shared memory through a
//     descriptor.  The activation x cannot be the descriptor operand: a
//     tap's one-pixel shift is 256 bytes (forward) or 4 bytes (wgrad), and
//     the swizzle's phase would have to follow it.  Per k8 step a thread
//     loads its 4 A values with 32-bit shared loads from the halo row its
//     pixel (forward) or its channel (wgrad) needs, or from a zero row
//     where the tap falls outside the image, and splits them in registers.
//   * TF32 wgmma has no transposed B, so B must be K-major.
//   * The rounding to TF32 is cvt.rna.tf32.f32's (nearest, ties away from
//     zero) written as integer ops on the bits, which leaves the 13 low bits
//     zero so that a - hi is exact; ops/gconv.py's tf32_split is the same
//     rounding in PyTorch.
//   * The x halo of a 128-pixel tile (rows m0-W-1 .. m0+128+W, 256 bytes
//     each) is copied with cp.async into shared memory, double-buffered.
//
// Forward: y[m, g*64+o] = sum_tap sum_c x[m + shift_tap, g*64+c] *
// w[tap, c, g*64+o].
//   * The weight in float32 is 147,456 B per group, 294,912 B as hi + lo:
//     more than a block's 227 KB.  So a pre-pass kernel splits it once per
//     call and writes it K-major ([g][tap][o][c], c contiguous), already in
//     the 128-byte swizzle, to a global workspace (32 KB per group and tap);
//     the main kernel streams one tap's hi + lo at a time from L2 into a
//     ring of three 32 KB slots with plain 16-byte cp.async.  Three slots
//     let the copy of tap t+1 start as soon as every warpgroup has passed
//     tap t's barrier, while tap t-1's last wgmma group may still read its
//     slot: one barrier per tap and no drain of the MMA pipe between taps.
//   * Persistent blocks (grid = (blocks per group, groups)) walk 128-pixel
//     tiles; two warpgroups of 64 pixels each, all 64 outputs.  Per tap, 8
//     k8 steps in groups of 2: the A values of a group are loaded and split
//     while the previous group's 6 wgmmas run (A double-buffered).
//   * Two accumulators a thread (2 x 32 f32): hi*hi in one, hi*lo + lo*hi
//     in the other, added in the epilogue.  The tensor cores' f32 sum
//     drops low bits of a small addend; kept apart from the large one, the
//     small terms lose less (a smaller max abs error than one accumulator).
//   * The m64n8k8 A fragment reads 8 consecutive pixel rows x 4 channels,
//     so halo rows have their 16-byte chunks XOR-ed with (row & 7): the 8
//     rows land on 8 different chunk columns, all 32 banks.
//   * The epilogue stages the 128 x 64 float32 tile (32 KB) in the halo
//     buffer it has read, in the same swizzle, and writes it with 16-byte
//     coalesced stores.
//   * No split-K and no atomics: the same bits on every run.
//
// Weight gradient: the tile walk of gconv3x3_tc.cu's bf16 wgrad.
//   * dW_tap[c, o] = sum_m x[m + shift_tap, c] * ybar[m, o].  A block owns
//     one group and a contiguous run of 128-pixel tiles (split-K over
//     pixels); per tile it copies the x halo and the ybar tile into shared
//     memory with cp.async, double-buffered, and accumulates all 9 taps
//     from them: warpgroup q owns the taps of row dy = q - 1, 3 x 64 x 64
//     f32 accumulators (96 registers a thread).  Each block writes its f32
//     partial; a second kernel adds the partials in split order: no
//     atomics, the same bits on every run.
//   * A is x^T (64 c x 8 pixels); ybar arrives o-contiguous, so once per
//     tile the threads read the staged ybar tile, split it, and write hi
//     and lo K-major in the 128-byte swizzle layout (32 pixels per 128-byte
//     row, a k8 step moves the descriptor by 32 bytes); a proxy fence makes
//     those plain stores visible to wgmma.
//   * The 4 threads of a fragment column read 4 consecutive pixel rows,
//     which without a swizzle hit the same banks: the 16-byte chunks of
//     halo row j are XOR-ed with (j & 3) << 1, which spreads the 4 rows'
//     chunk pairs over all 32 banks.
//
// Interface: plain C functions (ctypes), launched on the caller's stream;
// each returns cudaGetLastError() after its launches.  The caller allocates
// the output and the workspaces and plans the grids (ops/gconv.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCh = 64;                  // channels per group, in and out
constexpr int kRow = kCh * 4;            // bytes of one pixel's group row
constexpr int kTile = 128;               // pixels per tile
constexpr int kTileBytes = kTile * kRow;  // one float32 ybar tile: 32,768 B
constexpr int kThreads = 384;            // wgrad: 3 warpgroups x 3 taps
constexpr int kFwdThreads = 256;         // forward: 2 warpgroups x 64 pixels
constexpr int kAlign = 1024;             // 128-byte swizzle atom
constexpr int kAtom = kCh * 128;         // 32 k values of all 64 n, K-major
constexpr int kSlot = 2 * kCh * kCh * 4;  // one tap's weight, hi + lo: 32 KB
// depth of the forward's tap-weight ring: a tap's copy goes to the slot
// two taps back, so the wgmma groups still reading the previous slot need
// not drain before the barrier
constexpr int kSlots = 3;
// k8 steps per wgmma group of the forward; the A buffers alternate by
// group, so a tap (8 steps) holds an even number of groups
constexpr int kStepsPerGroup = 2;

// pixel rows a tile reads: one image row and one pixel beyond each end
__host__ __device__ constexpr int halo_rows(int W) { return kTile + 2 * W + 2; }

// [align slack][3 x tap weight slot][2 x halo][zero row]
__host__ __device__ constexpr int fwd_smem_bytes(int W) {
  return kAlign + kSlots * kSlot + 2 * halo_rows(W) * kRow + kRow;
}

// [align slack][ybar hi, ybar lo (K-major)][2 x ybar tile][2 x halo]
// [2 x tap masks][zero row]
__host__ __device__ constexpr int wgrad_smem_bytes(int W) {
  return kAlign + 4 * kTileBytes + 2 * halo_rows(W) * kRow + 2 * kTile * 2 +
         kRow;
}

// byte offset of 16-byte chunk `chunk` of halo row `row`: the wgrad's
// swizzle (4 rows a fragment column) and the forward's (8 rows)
__device__ __forceinline__ int swz(int row, int chunk) {
  return row * kRow + ((chunk ^ ((row & 3) << 1)) << 4);
}
__device__ __forceinline__ int swz8(int row, int chunk) {
  return row * kRow + ((chunk ^ (row & 7)) << 4);
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

// a rounded to TF32 (nearest, ties away from zero), as float32 bits
__device__ __forceinline__ uint32_t tf32_bits(float a) {
  return (__float_as_uint(a) + 0x1000u) & 0xFFFFE000u;
}
__device__ __forceinline__ void split(float a, uint32_t& hi, uint32_t& lo) {
  hi = tf32_bits(a);
  lo = tf32_bits(a - __uint_as_float(hi));
}

// B (8 pixels x 64 outputs, TF32) in shared memory, K-major: output o's
// pixels contiguous, 128-byte rows (32 pixels) with the 128-byte swizzle
// (16-byte chunk ^ (o & 7)), 8-row groups 1024 B apart.
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
// this thread's writes to shared memory (cp.async included, once waited
// for) become visible to wgmma's reads
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// D (64 x 64, f32, 32 registers a thread) += A (64 x 8 TF32 from registers:
// warp w of the warpgroup holds rows 16w..16w+15 in the mma.m16n8k8 A
// layout) x B (8 x 64 TF32 in shared memory, K-major).
__device__ __forceinline__ void wgmma_tf32(float (&d)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n"
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

// Partial weight gradient of group blockIdx.y over the pixel tiles
// [blockIdx.x * tiles_per_split, +tiles_per_split):
// ws[split, g, tap, c, o] = sum_m x[m + shift_tap, g*64+c] * dy[m, g*64+o].
// Warpgroup q accumulates the taps (dy, dx) = (q - 1, -1..1): 64 c x 64 o
// each.
__global__ void __launch_bounds__(kThreads, 1)
gconv3x3_wgrad_tf32_kernel(const float* __restrict__ x,
                           const float* __restrict__ dy,
                           float* __restrict__ ws, int N, int H, int W, int G,
                           int tiles_per_split) {
  extern __shared__ __align__(16) uint8_t smem[];
  const uint32_t raw = smem_u32(smem);
  // byte offsets into smem; the K-major tiles start 1024-byte aligned
  const int o_bhi = static_cast<int>(((raw + kAlign - 1) & ~(kAlign - 1)) -
                                     raw);
  const int o_blo = o_bhi + kTileBytes;
  const int o_y = o_blo + kTileBytes;                    // 2 x ybar tile
  const int halo_bytes = halo_rows(W) * kRow;
  const int o_x = o_y + 2 * kTileBytes;                  // 2 x halo
  const int o_mask = o_x + 2 * halo_bytes;               // 2 x uint16[128]
  const int o_zero = o_mask + 2 * kTile * 2;             // 256-byte aligned
  uint16_t* const mask = reinterpret_cast<uint16_t*>(smem + o_mask);
  const int C = G * kCh, M = N * H * W;
  const int split_id = blockIdx.x, g = blockIdx.y;
  const int tiles = (M + kTile - 1) / kTile;
  const int t0 = split_id * tiles_per_split;
  const int t1 = min(tiles, t0 + tiles_per_split);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q = warp >> 2;  // warpgroup: taps 3q .. 3q+2

  if (tid < kRow / 16)
    *reinterpret_cast<uint4*>(smem + o_zero + tid * 16) =
        make_uint4(0u, 0u, 0u, 0u);

  auto load_stage = [&](int t, int buf) {
    const int m0 = t * kTile;
    const int p0 = m0 - W - 1;
    const uint32_t hx = raw + o_x + buf * halo_bytes;
    for (int i = tid; i < halo_rows(W) * 16; i += kThreads) {
      const int j = i >> 4, ch = i & 15;
      const int p = p0 + j;
      const bool ok = p >= 0 && p < M;
      cp_async16(hx + swz(j, ch), x + (size_t)(ok ? p : 0) * C + g * kCh +
                                      ch * 4, ok);
    }
    const uint32_t hy = raw + o_y + buf * kTileBytes;
    for (int i = tid; i < kTile * 16; i += kThreads) {
      const int j = i >> 4, ch = i & 15;
      const int p = m0 + j;
      const bool ok = p < M;
      cp_async16(hy + j * kRow + ch * 16,
                 dy + (size_t)(ok ? p : 0) * C + g * kCh + ch * 4, ok);
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

  // This thread's A values (mma.m16n8k8 A layout): channels c and c + 8,
  // c = 16 * (warp & 3) + (lane >> 2), of pixels 8 ks + (lane & 3) (+4) of
  // k8 step ks.  Tap a's halo row of pixel p is p + shift[a]; the row's
  // swizzle depends on it mod 4 only, so one byte offset per tap serves
  // every k step (+8 rows = 2048 B) and the pixel 4 rows on (+1024 B), and
  // channel c + 8 lies a_c8[a] (+-32) bytes from channel c.
  const int pt = lane & 3;
  const int c = 16 * (warp & 3) + (lane >> 2);
  int a_off[3], a_c8[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const int j = pt + W + 1 + (q - 1) * W + (a - 1);
    a_off[a] = swz(j, c >> 2) + (c & 3) * 4;
    a_c8[a] = swz(j, (c >> 2) + 2) + (c & 3) * 4 - a_off[a];
  }
  const int z_off = o_zero + 64 + (c & 15) * 4;  // +-32 stays in the zero row
  uint32_t ahi[2][4] = {}, alo[2][4] = {};
  auto ld = [&](int off) {
    return *reinterpret_cast<const float*>(smem + off);
  };

  if (t0 < t1) load_stage(t0, 0);
  cp_async_commit();
  for (int t = t0, it = 0; t < t1; ++t, ++it) {
    const int buf = it & 1;
    if (t + 1 < t1) load_stage(t + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    // ybar tile -> hi and lo, K-major: item i is output o's pixels
    // 4 kc .. 4 kc + 3, one 16-byte chunk of o's 128-byte row in atom kc / 8
    const float* yt = reinterpret_cast<const float*>(smem + o_y +
                                                     buf * kTileBytes);
    for (int i = tid; i < kTile * kCh / 4; i += kThreads) {
      const int o = i & (kCh - 1), kc = i >> 6;
      uint32_t h[4], l[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) split(yt[(4 * kc + r) * kCh + o], h[r], l[r]);
      const int off = (kc >> 3) * kAtom + o * 128 + (((kc & 7) ^ (o & 7)) << 4);
      *reinterpret_cast<uint4*>(smem + o_bhi + off) =
          make_uint4(h[0], h[1], h[2], h[3]);
      *reinterpret_cast<uint4*>(smem + o_blo + off) =
          make_uint4(l[0], l[1], l[2], l[3]);
    }
    fence_async_shared();
    __syncthreads();

    const int o_hx = o_x + buf * halo_bytes;
    const uint16_t* const mk = mask + buf * kTile;
#pragma unroll
    for (int ks = 0; ks < kTile / 8; ++ks) {
      const uint32_t m_lo = mk[ks * 8 + pt] >> (3 * q);
      const uint32_t m_hi = mk[ks * 8 + pt + 4] >> (3 * q);
      const uint32_t b_off = (ks >> 2) * kAtom + (ks & 3) * 32;
      const uint64_t d_hi = desc_b128(raw + o_bhi + b_off);
      const uint64_t d_lo = desc_b128(raw + o_blo + b_off);
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const int s = (ks * 3 + a) & 1;
        const int r = o_hx + a_off[a] + ks * 8 * kRow;
        const int p_lo = ((m_lo >> a) & 1u) ? r : z_off;
        const int p_hi = ((m_hi >> a) & 1u) ? r + 4 * kRow : z_off;
        // a0: (c, p), a1: (c + 8, p), a2: (c, p + 4), a3: (c + 8, p + 4)
        const float v[4] = {ld(p_lo), ld(p_lo + a_c8[a]), ld(p_hi),
                            ld(p_hi + a_c8[a])};
#pragma unroll
        for (int e = 0; e < 4; ++e) split(v[e], ahi[s][e], alo[s][e]);
        wgmma_fence();
        wgmma_tf32(acc[a], ahi[s], d_hi);
        wgmma_tf32(acc[a], ahi[s], d_lo);
        wgmma_tf32(acc[a], alo[s], d_hi);
        wgmma_commit();
        wgmma_wait<1>();   // the previous step's A registers are free
        keep(ahi[s ^ 1]);
        keep(alo[s ^ 1]);
      }
    }
    wgmma_wait<0>();   // hi/lo and this stage's halo are read
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      keep(ahi[s]);
      keep(alo[s]);
    }
    __syncthreads();
  }
  cp_async_wait<0>();
#pragma unroll
  for (int a = 0; a < 3; ++a) keep(acc[a]);

  // acc[a][4j + e]: c = 16*(warp&3) + (lane>>2) (+8 for e >= 2),
  // o = 8j + 2*(lane&3) + (e&1)
  float* const wsg = ws + ((size_t)split_id * G + g) * 9 * kCh * kCh;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    float* const wt = wsg + (size_t)(q * 3 + a) * kCh * kCh;
#pragma unroll
    for (int h8 = 0; h8 < 2; ++h8) {
      const int cc = (warp & 3) * 16 + (lane >> 2) + h8 * 8;
#pragma unroll
      for (int jn = 0; jn < 8; ++jn)
        *reinterpret_cast<float2*>(wt + cc * kCh + jn * 8 + (lane & 3) * 2) =
            make_float2(acc[a][jn * 4 + h8 * 2], acc[a][jn * 4 + h8 * 2 + 1]);
    }
  }
}

// dw[tap, c, g*64 + o] = sum over splits, in split order, of
// ws[split, g, tap, c, o]; four outputs per thread.
__global__ void gconv3x3_wgrad_tf32_reduce_kernel(const float* __restrict__ ws,
                                                  float* __restrict__ dw,
                                                  int G, int splits) {
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
  *reinterpret_cast<float4*>(dw + (size_t)tc * G * kCh + g * kCh + o) = s;
}


// The forward's weight pre-pass: w (HWIO, [3][3][64][G*64]) -> wp, per group
// and tap one 32 KB slot image [hi | lo], each 16 KB the B operand K-major
// (output o's 64 channels contiguous) in the 128-byte swizzle: channels
// 32a .. 32a+31 in atom a (8 KB), o's 128-byte row at o * 128, 16-byte chunk
// kc at (kc ^ (o & 7)).  One thread per (g, tap, 4 channels, o): the reads
// are coalesced across o.
__global__ void gconv3x3_fwd_tf32_prep_kernel(const float* __restrict__ w,
                                              uint4* __restrict__ wp, int G) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= G * 9 * kCh * (kCh / 4)) return;
  const int o = i & (kCh - 1), ch = (i >> 6) & 15, gt = i >> 10;
  const int tap = gt % 9, g = gt / 9, C = G * kCh;
  uint32_t h[4], l[4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
    split(w[(size_t)(tap * kCh + ch * 4 + r) * C + g * kCh + o], h[r], l[r]);
  uint4* const slot = wp + (size_t)(g * 9 + tap) * (kSlot / 16);
  const int off = (ch >> 3) * (kAtom / 16) + o * 8 + ((ch & 7) ^ (o & 7));
  slot[off] = make_uint4(h[0], h[1], h[2], h[3]);
  slot[kSlot / 32 + off] = make_uint4(l[0], l[1], l[2], l[3]);
}

// y[n,h,w,g*64+o] = sum_{dy,dx,c} x[n,h+dy-1,w+dx-1,g*64+c] * w[dy,dx,c,g*64+o]
// from the pre-pass's wp.  grid: (blocks per group, G); each block walks
// tiles blockIdx.x, blockIdx.x + gridDim.x, ... of 128 pixels of
// M = N*H*W.  Warpgroup q computes pixels 64q .. 64q+63 of a tile, all 64
// outputs.  Stage k (the k-th tap this block computes) reads weight slot
// k % 3; its copy is issued right after stage k-1's barrier.
__global__ void __launch_bounds__(kFwdThreads, 1)
gconv3x3_fwd_tf32_kernel(const float* __restrict__ x,
                         const uint4* __restrict__ wp, float* __restrict__ y,
                         int N, int H, int W, int G) {
  extern __shared__ __align__(16) uint8_t smem[];
  const uint32_t raw = smem_u32(smem);
  // byte offsets into smem; the weight slots start 1024-byte aligned
  const int o_w = static_cast<int>(((raw + kAlign - 1) & ~(kAlign - 1)) - raw);
  const int halo_bytes = halo_rows(W) * kRow;
  const int o_x = o_w + kSlots * kSlot;                  // 2 x halo
  const int o_zero = o_x + 2 * halo_bytes;               // zero row
  const int C = G * kCh, M = N * H * W;
  const int g = blockIdx.y;
  const int tiles = (M + kTile - 1) / kTile;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const uint4* const wg = wp + (size_t)g * 9 * (kSlot / 16);

  if (tid < kRow / 16)
    *reinterpret_cast<uint4*>(smem + o_zero + tid * 16) =
        make_uint4(0u, 0u, 0u, 0u);

  auto load_halo = [&](int t, int buf) {
    const int p0 = t * kTile - W - 1;
    const uint32_t hx = raw + o_x + buf * halo_bytes;
    for (int i = tid; i < halo_rows(W) * 16; i += kFwdThreads) {
      const int j = i >> 4, ch = i & 15;
      const int p = p0 + j;
      const bool ok = p >= 0 && p < M;
      cp_async16(hx + swz8(j, ch), x + (size_t)(ok ? p : 0) * C + g * kCh +
                                       ch * 4, ok);
    }
  };
  auto load_tap = [&](int tap, int sl) {
    const uint32_t dst = raw + o_w + sl * kSlot;
    const uint4* const src = wg + tap * (kSlot / 16);
#pragma unroll
    for (int i = 0; i < kSlot / 16 / kFwdThreads; ++i) {
      const int e = i * kFwdThreads + tid;
      cp_async16(dst + e * 16, src + e, true);
    }
  };

  // This thread's A values (mma.m16n8k8 A layout): pixel rows `local` and
  // local + 8 of the tile, channels 8 ks + t and 8 ks + t + 4 of k8 step ks
  const int local = (warp >> 2) * 64 + (warp & 3) * 16 + (lane >> 2);
  const int t4 = (lane & 3) * 4;
  uint32_t ahi[2][kStepsPerGroup][4] = {}, alo[2][kStepsPerGroup][4] = {};
  // hi*hi in acc_hi, hi*lo + lo*hi in acc_small: the small terms are
  // summed apart and added once, in the epilogue
  float acc_hi[32], acc_small[32];
  auto ld = [&](int off) {
    return *reinterpret_cast<const float*>(smem + off);
  };

  int tile = blockIdx.x;
  if (tile < tiles) {
    load_halo(tile, 0);
    load_tap(0, 0);
  }
  cp_async_commit();
  int slot = 0;   // weight slot of the current stage
  for (int it = 0; tile < tiles; ++it, tile += gridDim.x) {
    const int hb = it & 1, m0 = tile * kTile;
    const int next = tile + gridDim.x;
    const uint32_t vm_lo = tap_mask(m0 + local, M, H, W);
    const uint32_t vm_hi = tap_mask(m0 + local + 8, M, H, W);
    const int o_hx = o_x + hb * halo_bytes;
#pragma unroll
    for (int i = 0; i < 32; ++i) acc_hi[i] = acc_small[i] = 0.f;
    keep(acc_hi);
    keep(acc_small);

#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      cp_async_wait<0>();   // this stage's slot (and at tap 1 the next halo)
      fence_async_shared();
      __syncthreads();      // ... and every thread's earlier stages are read
      const int nslot = slot == kSlots - 1 ? 0 : slot + 1;
      if (tap < 8)
        load_tap(tap + 1, nslot);
      else if (next < tiles)
        load_tap(0, nslot);
      if (tap == 0 && next < tiles) load_halo(next, hb ^ 1);
      cp_async_commit();

      // halo row of this thread's pixel under the tap, or the zero row;
      // rows j and j + 8 share their swizzle phase j & 7
      const int j = local + W + 1 + (tap / 3 - 1) * W + (tap % 3 - 1);
      const int ph = (j & 7) << 4;
      const int r_lo = ((vm_lo >> tap) & 1u) ? o_hx + j * kRow : o_zero;
      const int r_hi = ((vm_hi >> tap) & 1u) ? o_hx + (j + 8) * kRow : o_zero;
      const uint32_t b_slot = raw + o_w + slot * kSlot;
#pragma unroll
      for (int grp = 0; grp < 8 / kStepsPerGroup; ++grp) {
        const int s = grp & 1;
#pragma unroll
        for (int q = 0; q < kStepsPerGroup; ++q) {
          const int ks = grp * kStepsPerGroup + q;
          const int c0 = ((ks * 32) ^ ph) + t4;        // chunk 2 ks
          const int c1 = ((ks * 32 + 16) ^ ph) + t4;   // chunk 2 ks + 1
          // a0: (p, c), a1: (p + 8, c), a2: (p, c + 4), a3: (p + 8, c + 4)
          const float v[4] = {ld(r_lo + c0), ld(r_hi + c0), ld(r_lo + c1),
                              ld(r_hi + c1)};
#pragma unroll
          for (int e = 0; e < 4; ++e) split(v[e], ahi[s][q][e], alo[s][q][e]);
        }
        wgmma_fence();
#pragma unroll
        for (int q = 0; q < kStepsPerGroup; ++q) {
          const int ks = grp * kStepsPerGroup + q;
          const uint64_t d_hi =
              desc_b128(b_slot + (ks >> 2) * kAtom + (ks & 3) * 32);
          const uint64_t d_lo = desc_b128(b_slot + kSlot / 2 +
                                          (ks >> 2) * kAtom + (ks & 3) * 32);
          wgmma_tf32(acc_hi, ahi[s][q], d_hi);
          wgmma_tf32(acc_small, ahi[s][q], d_lo);
          wgmma_tf32(acc_small, alo[s][q], d_hi);
        }
        wgmma_commit();
        wgmma_wait<1>();   // the previous group's A registers are free
#pragma unroll
        for (int q = 0; q < kStepsPerGroup; ++q) {
          keep(ahi[s ^ 1][q]);
          keep(alo[s ^ 1][q]);
        }
      }
      slot = nslot;
    }
    wgmma_wait<0>();
    keep(acc_hi);
    keep(acc_small);
#pragma unroll
    for (int i = 0; i < 32; ++i) acc_hi[i] += acc_small[i];
#pragma unroll
    for (int s = 0; s < 2; ++s)
#pragma unroll
      for (int q = 0; q < kStepsPerGroup; ++q) {
        keep(ahi[s][q]);
        keep(alo[s][q]);
      }

    // Epilogue through shared memory: the tile's halo is read, so its
    // buffer takes the 128 x 64 float32 outputs (row r, 16-byte chunk
    // ^ (r & 7)), which leave in 16-byte coalesced stores.  acc_hi[4j + e] is
    // tile row 64*(warp>>2) + 16*(warp&3) + (lane>>2) (+8 for e >= 2),
    // output 8j + 2*(lane&3) + (e&1).
    __syncthreads();
    uint8_t* const st = smem + o_hx;
#pragma unroll
    for (int h8 = 0; h8 < 2; ++h8) {
      const int r = local + h8 * 8;
#pragma unroll
      for (int jn = 0; jn < 8; ++jn)
        *reinterpret_cast<float2*>(
            st + r * kRow + (((2 * jn + ((lane & 3) >> 1)) ^ (r & 7)) << 4) +
            (lane & 1) * 8) =
            make_float2(acc_hi[jn * 4 + h8 * 2], acc_hi[jn * 4 + h8 * 2 + 1]);
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kTile * 16 / kFwdThreads; ++i) {
      const int idx = i * kFwdThreads + tid;
      const int r = idx >> 4, ch = idx & 15;
      if (m0 + r < M)
        *reinterpret_cast<uint4*>(y + (size_t)(m0 + r) * C + g * kCh +
                                  ch * 4) =
            *reinterpret_cast<const uint4*>(st + r * kRow +
                                            ((ch ^ (r & 7)) << 4));
    }
    // the next refill of this buffer follows the next tile's first barrier
  }
  cp_async_wait<0>();
}

}  // namespace

// Dynamic shared memory of the forward (which 0) or the wgrad (which 1) at
// image width W (the wrapper refuses widths whose need exceeds the card's
// 227 KB per block).
extern "C" int mdd_gconv3x3_tf32_smem(int which, int W) {
  return which == 0 ? fwd_smem_bytes(W) : wgrad_smem_bytes(W);
}

// wp: float32 workspace of G * 9 * 2 * 64 * 64 elements (the split weight),
// written by the pre-pass before the main kernel reads it.
extern "C" int mdd_gconv3x3_fwd_tf32(const void* x, const void* w, void* wp,
                                     void* y, int N, int H, int W, int G,
                                     int blocks_per_group, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int items = G * 9 * kCh * (kCh / 4);
  gconv3x3_fwd_tf32_prep_kernel<<<(items + 255) / 256, 256, 0, s>>>(
      static_cast<const float*>(w), static_cast<uint4*>(wp), G);
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  const int smem = fwd_smem_bytes(W);
  err = static_cast<int>(cudaFuncSetAttribute(
      reinterpret_cast<const void*>(gconv3x3_fwd_tf32_kernel),
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
  if (err) return err;
  gconv3x3_fwd_tf32_kernel<<<dim3(blocks_per_group, G), kFwdThreads, smem,
                             s>>>(
      static_cast<const float*>(x), static_cast<const uint4*>(wp),
      static_cast<float*>(y), N, H, W, G);
  return static_cast<int>(cudaGetLastError());
}

// ws: float32 workspace of splits * G * 9 * 64 * 64 elements; every element
// is written before it is read.  Split s covers pixel tiles
// [s * tiles_per_split, (s + 1) * tiles_per_split) of 128 pixels.
extern "C" int mdd_gconv3x3_wgrad_tf32(const void* x, const void* dy, void* ws,
                                       void* dw, int N, int H, int W, int G,
                                       int splits, int tiles_per_split,
                                       void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int smem = wgrad_smem_bytes(W);
  int err = static_cast<int>(cudaFuncSetAttribute(
      reinterpret_cast<const void*>(gconv3x3_wgrad_tf32_kernel),
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
  if (err) return err;
  gconv3x3_wgrad_tf32_kernel<<<dim3(splits, G), kThreads, smem, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(dy),
      static_cast<float*>(ws), N, H, W, G, tiles_per_split);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  const int total4 = G * 9 * kCh * kCh / 4;
  gconv3x3_wgrad_tf32_reduce_kernel<<<(total4 + 255) / 256, 256, 0, s>>>(
      static_cast<const float*>(ws), static_cast<float*>(dw), G, splits);
  return static_cast<int>(cudaGetLastError());
}
