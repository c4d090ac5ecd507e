// Grouped 3x3, stride-1, TF-SAME convolution for Hopper (sm_90a): forward
// and weight gradient, NHWC activations x HWIO weights, float32 or bfloat16
// operands, float32 accumulation, output in the operands' dtype.
//
// Replaces the two Pallas TPU kernels of
// multimodal_dataset_distillation_tpu/ops/pallas_gconv.py:
//   * _spatial_kernel (the pallas_call in _pallas_spatial)
//       -> gconv3x3_fwd_kernel.  It is also the input gradient (dgrad): the
//          forward conv on the spatially rotated, per-group in/out-swapped
//          weight (_rot_swap there, rot_swap in ops/gconv.py here).
//   * _wgrad_kernel (the pallas_call in _pallas_wgrad)
//       -> gconv3x3_wgrad_partial_kernel + gconv3x3_wgrad_reduce_kernel.
//
// What bounds it on the card.  At NFNet-L0's shapes (64 channels per group)
// each output element costs 2 * 9 * 64 = 1152 FLOP, about 288 FLOP per byte
// of bf16 activation moved: right at the H100's ridge (~295), so on tensor
// cores the FLOPs and the bytes would both set a bound of ~10 us per site.
// This first version computes on the CUDA cores (float32 FMA, 67 TFLOP/s
// peak), so it is bound by operations, far above that tensor-core bound.
// The wgmma/TMA redesign is queued in ROADMAP.md.
//
// Design.
//   * Implicit GEMM, one group per block: rows are output pixels (forward)
//     or (tap, input channel) pairs (wgrad), columns are up to 64 output
//     channels of the group, and the reduction runs over 9 taps x input
//     channels (forward) or over pixels (wgrad).  Operands are staged
//     through shared memory as float32 in slices of 16; each of the 256
//     threads keeps an 8 x 4 tile of accumulators in registers.
//   * The zero padding of 1 on each side is computed from indices while a
//     slice is staged: no padded copy of the activations is made.
//   * The TPU kernel packed two groups into one 128-lane block with a
//     block-diagonal weight (_pack_w_pairs) to fill the MXU, doubling the
//     FLOPs.  Hopper has no such lane constraint, so each block serves one
//     group and computes no zero blocks.
//   * The TPU wgrad carried its sum in VMEM scratch across a sequential grid.
//     Blocks here run in no order, so each block sums a contiguous slice of
//     pixels into its own float32 partial tile, and a second kernel adds the
//     partials in a fixed order (deterministic, no atomics) and casts.
//
// Interface: plain C functions (ctypes), launched on the caller's stream.
// Each returns cudaGetLastError() after its launches; the caller allocates
// every output and the wgrad workspace.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTileM = 128;        // GEMM rows per block
constexpr int kTileN = 64;         // GEMM columns (output channels) per block
constexpr int kTileK = 16;         // reduction slice staged per step
constexpr int kThreads = 256;      // 16 x 16 threads, 8 x 4 outputs each
constexpr int kPadM = kTileM + 4;  // row stride of the A stage: keeps float4
                                   // alignment, breaks the 128-word bank stride

__device__ __forceinline__ float load_f(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// acc[i][j] += sum_k As[k][ty*8 + i] * Bs[k][tx*4 + j]
__device__ __forceinline__ void tile_fma(float (*As)[kPadM],
                                         float (*Bs)[kTileN],
                                         float (&acc)[8][4], int ty, int tx) {
#pragma unroll
  for (int k = 0; k < kTileK; ++k) {
    const float4 a0 = *reinterpret_cast<const float4*>(&As[k][ty * 8]);
    const float4 a1 = *reinterpret_cast<const float4*>(&As[k][ty * 8 + 4]);
    const float4 b = *reinterpret_cast<const float4*>(&Bs[k][tx * 4]);
    const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float bb[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bb[j], acc[i][j]);
    }
  }
}

// y[n,h,w,g*opg+o] = sum_{dy,dx,c} x[n,h+dy-1,w+dx-1,g*cpg+c] * w[dy,dx,c,g*opg+o]
// grid: (ceil(M/128), ceil(opg/64), G), M = N*H*W.
template <typename T>
__global__ void __launch_bounds__(kThreads)
gconv3x3_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
                    T* __restrict__ y, int N, int H, int W, int G, int cpg,
                    int opg) {
  __shared__ __align__(16) float As[kTileK][kPadM];   // [channel][pixel]
  __shared__ __align__(16) float Bs[kTileK][kTileN];  // [channel][out]
  const int C = G * cpg, F = G * opg, M = N * H * W;
  const int g = blockIdx.z;
  const int m0 = blockIdx.x * kTileM;
  const int o0 = blockIdx.y * kTileN;
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  // staging roles: A -> channel a_k of pixels a_r + 16*i (16 threads read
  // 16 consecutive channels of one pixel); B -> out channel b_o of rows
  // b_k + 4*i (64 threads read 64 consecutive out channels)
  const int a_k = tid & 15, a_r = tid >> 4;
  const int b_o = tid & 63, b_k = tid >> 6;
  const bool b_ok = o0 + b_o < opg;
  const T* xg = x + (size_t)g * cpg + a_k;
  const T* wg = w + (size_t)g * opg + o0 + b_o;

  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int tap = 0; tap < 9; ++tap) {
    const int dy = tap / 3 - 1, dx = tap % 3 - 1;
    // source pixel of each staged row for this tap; -1 reads the padding
    int src[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int m = m0 + a_r + 16 * i;
      src[i] = -1;
      if (m < M) {
        const int wc = m % W, hr = (m / W) % H;
        const int hh = hr + dy, ww = wc + dx;
        if (hh >= 0 && hh < H && ww >= 0 && ww < W) src[i] = m + dy * W + dx;
      }
    }
    for (int c0 = 0; c0 < cpg; c0 += kTileK) {
      const bool a_ok = c0 + a_k < cpg;
#pragma unroll
      for (int i = 0; i < 8; ++i)
        As[a_k][a_r + 16 * i] =
            (a_ok && src[i] >= 0) ? load_f(xg + (size_t)src[i] * C + c0) : 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int k = b_k + 4 * i;
        Bs[k][b_o] = (b_ok && c0 + k < cpg)
                         ? load_f(wg + (size_t)(tap * cpg + c0 + k) * F)
                         : 0.f;
      }
      __syncthreads();
      tile_fma(As, Bs, acc, ty, tx);
      __syncthreads();
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + ty * 8 + i;
    if (m >= M) continue;
    T* yr = y + (size_t)m * F + (size_t)g * opg;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int o = o0 + tx * 4 + j;
      if (o < opg) store_f(yr + o, acc[i][j]);
    }
  }
}

// Partial weight gradient over the pixel slice [split*mchunk, +mchunk):
// ws[split,g,r,o] = sum_m xwin[m, r] * dy[m, g*opg+o], r = tap*cpg + c.
// grid: (ceil(9*cpg/128), ceil(opg/64), G * splits).
template <typename T>
__global__ void __launch_bounds__(kThreads)
gconv3x3_wgrad_partial_kernel(const T* __restrict__ x,
                              const T* __restrict__ dy,
                              float* __restrict__ ws, int N, int H, int W,
                              int G, int cpg, int opg, int mchunk) {
  __shared__ __align__(16) float As[kTileK][kPadM];   // [pixel][tap, channel]
  __shared__ __align__(16) float Bs[kTileK][kTileN];  // [pixel][out]
  const int C = G * cpg, F = G * opg, M = N * H * W, K9 = 9 * cpg;
  const int split = blockIdx.z / G, g = blockIdx.z % G;
  const int r0 = blockIdx.x * kTileM;
  const int o0 = blockIdx.y * kTileN;
  const int ms = split * mchunk;
  const int me = min(M, ms + mchunk);
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  // staging roles: A -> row a_r (one tap and channel) of pixels a_kk + 2*i,
  // 128 threads reading consecutive channels; B -> out channel b_o of
  // pixels b_kk + 4*i
  const int a_r = tid & 127, a_kk = tid >> 7;
  const int b_o = tid & 63, b_kk = tid >> 6;
  const int r = r0 + a_r;
  const bool r_ok = r < K9;
  const int tap = r_ok ? r / cpg : 0;
  const int c = r - tap * cpg;
  const int ddy = tap / 3 - 1, ddx = tap % 3 - 1;
  const T* xr = x + (size_t)g * cpg + c;
  const bool b_ok = o0 + b_o < opg;
  const T* dyg = dy + (size_t)g * opg + o0 + b_o;

  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int mb = ms; mb < me; mb += kTileK) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int kk = a_kk + 2 * i;
      const int m = mb + kk;
      float v = 0.f;
      if (r_ok && m < me) {
        const int wc = m % W, hr = (m / W) % H;
        const int hh = hr + ddy, ww = wc + ddx;
        if (hh >= 0 && hh < H && ww >= 0 && ww < W)
          v = load_f(xr + (size_t)(m + ddy * W + ddx) * C);
      }
      As[kk][a_r] = v;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kk = b_kk + 4 * i;
      const int m = mb + kk;
      Bs[kk][b_o] = (b_ok && m < me) ? load_f(dyg + (size_t)m * F) : 0.f;
    }
    __syncthreads();
    tile_fma(As, Bs, acc, ty, tx);
    __syncthreads();
  }
  float* wsg = ws + ((size_t)split * G + g) * K9 * opg;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int rr = r0 + ty * 8 + i;
    if (rr >= K9) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int o = o0 + tx * 4 + j;
      if (o < opg) wsg[(size_t)rr * opg + o] = acc[i][j];
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
  store_f(dw + (size_t)r * G * opg + (size_t)g * opg + o, s);
}

template <typename T>
int launch_fwd(const void* x, const void* w, void* y, int N, int H, int W,
               int G, int cpg, int opg, cudaStream_t stream) {
  const int M = N * H * W;
  const dim3 grid((M + kTileM - 1) / kTileM, (opg + kTileN - 1) / kTileN, G);
  gconv3x3_fwd_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(y),
      N, H, W, G, cpg, opg);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_wgrad(const void* x, const void* dy, float* ws, void* dw, int N,
                 int H, int W, int G, int cpg, int opg, int splits,
                 int mchunk, cudaStream_t stream) {
  const dim3 grid((9 * cpg + kTileM - 1) / kTileM, (opg + kTileN - 1) / kTileN,
                  G * splits);
  gconv3x3_wgrad_partial_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), ws, N, H, W, G, cpg,
      opg, mchunk);
  const int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  const int total = G * 9 * cpg * opg;
  gconv3x3_wgrad_reduce_kernel<T><<<(total + 255) / 256, 256, 0, stream>>>(
      ws, static_cast<T*>(dw), G, cpg, opg, splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.
extern "C" int mdd_gconv3x3_fwd(const void* x, const void* w, void* y, int N,
                                int H, int W, int G, int cpg, int opg,
                                int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_fwd<float>(x, w, y, N, H, W, G, cpg, opg, s);
  if (dtype == 1)
    return launch_fwd<__nv_bfloat16>(x, w, y, N, H, W, G, cpg, opg, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// ws: float32 workspace of splits * G * 9 * cpg * opg elements; every
// element is written before it is read.  Pixel slice s covers
// [s * mchunk, min(M, (s + 1) * mchunk)).
extern "C" int mdd_gconv3x3_wgrad(const void* x, const void* dy, void* ws,
                                  void* dw, int N, int H, int W, int G,
                                  int cpg, int opg, int splits, int mchunk,
                                  int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* wsf = static_cast<float*>(ws);
  if (dtype == 0)
    return launch_wgrad<float>(x, dy, wsf, dw, N, H, W, G, cpg, opg, splits,
                               mchunk, s);
  if (dtype == 1)
    return launch_wgrad<__nv_bfloat16>(x, dy, wsf, dw, N, H, W, G, cpg, opg,
                                       splits, mchunk, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
