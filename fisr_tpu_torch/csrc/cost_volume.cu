// PWC-Net partial cost volume (local correlation) for Hopper, sm_90a.
//
//   out[b,y,x,(dy+d)*(2d+1)+(dx+d)] = (1/C) * sum_c c1[b,y,x,c] * c2[b,y+dy,x+dx,c]
//
// for |dy|,|dx| <= d, zero outside the frame. NHWC in, NHWC out; f32 or bf16
// in and out; products and sums in f32, times 1/C in f32, one cast at the end.
//
// Replaces fisr_tpu/kernels/cost_volume_pallas.py:_kernel (the TPU kernel's
// [B,H,C,W] transpose, 128-lane apron and lane roll exist for the TPU's vector
// unit and are not carried over).
//
// What bounds it on this card: device-memory bytes. Per output pixel it reads
// 2C input values, writes 81 and does 81*C multiply-adds: in f32 that is 9
// flops per byte at C = 32 (PWC level 2, the largest plane) and 17 at C = 196,
// under the H100's f32 ridge of 67 TFLOP/s / 3.35 TB/s = 20; in bf16 the bytes
// halve against a 15x higher bf16 peak. What the design does about it:
// * each input byte is fetched from device memory about once: a block stages
//   the c1 row segment and the 2d+1 zero-haloed c2 rows it needs in shared
//   memory, a channel chunk at a time, and the 2d+1 blocks of neighbouring
//   rows that read the same c2 row find it in L2;
// * each output byte is written once, through a shared-memory tile, so the
//   81 values of consecutive pixels go out as one contiguous coalesced run;
// * the inner loop keeps a 4-pixel x (2d+1)-shift tile of sums in registers,
//   so one shared-memory vector load feeds several multiply-adds and the
//   shared-memory port does not become the limit in place of device memory.
// wgmma and TMA are not used: there is no matrix product here.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TX = 128;  // output pixels per block: one segment of one row
constexpr int PX = 4;    // consecutive pixels per thread
constexpr int CC = 8;    // channels staged per pass

template <int D>
struct Geo {
  static constexpr int N = 2 * D + 1;            // shifts per axis
  static constexpr int NN = N * N;               // output channels
  static constexpr int PW = TX + 2 * D;          // staged c2 columns
  // row stride in floats: a multiple of 4 for float4 reads, and 4 mod 8 so
  // the transposing stores of a warp meet at most 2-way bank conflicts
  static constexpr int PWS = (PW + 7) / 8 * 8 + 4;
  static constexpr int THREADS = (TX / PX) * N;  // one warp per dy
  static constexpr int STAGE = N * CC * PWS + CC * TX;
  static constexpr int OUT = TX * NN;
  static constexpr int SMEM_FLOATS = STAGE > OUT ? STAGE : OUT;
  static_assert(D % 2 == 0, "float4 reads of PX + 2D columns need D even");
  static_assert(SMEM_FLOATS * 4 <= 48 * 1024, "static shared-memory limit");
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T, int D>
__global__ void __launch_bounds__(Geo<D>::THREADS)
cost_volume_kernel(const T* __restrict__ c1, const T* __restrict__ c2,
                   T* __restrict__ out, int H, int W, int C, float inv_c) {
  using G = Geo<D>;
  extern __shared__ float4 smem_f4[];
  float* smem = reinterpret_cast<float*>(smem_f4);
  float* c2s = smem;                        // [N][CC][PWS]: rows y-D..y+D
  float* c1s = smem + G::N * CC * G::PWS;   // [CC][TX]
  float* outs = smem;                       // [TX][NN], reused after the loop

  const int xbase = blockIdx.x * TX;
  const int y = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int tx = tid % (TX / PX);  // pixel group: pixels 4*tx .. 4*tx+3
  const int ty = tid / (TX / PX);  // dy index 0..2D

  float acc[PX][G::N];
#pragma unroll
  for (int j = 0; j < PX; ++j)
#pragma unroll
    for (int k = 0; k < G::N; ++k) acc[j][k] = 0.f;

  const int64_t img = static_cast<int64_t>(b) * H;
  for (int c0 = 0; c0 < C; c0 += CC) {
    __syncthreads();  // the previous chunk's readers are done
    for (int i = tid; i < G::N * G::PW * CC; i += G::THREADS) {
      const int c = i % CC;
      const int rest = i / CC;
      const int p = rest % G::PW;
      const int r = rest / G::PW;
      const int gy = y + r - D;
      const int gx = xbase + p - D;
      const int ch = c0 + c;
      float v = 0.f;
      if (gy >= 0 && gy < H && gx >= 0 && gx < W && ch < C)
        v = to_f32(c2[((img + gy) * W + gx) * C + ch]);
      c2s[(r * CC + c) * G::PWS + p] = v;
    }
    for (int i = tid; i < TX * CC; i += G::THREADS) {
      const int c = i % CC;
      const int p = i / CC;
      const int gx = xbase + p;
      const int ch = c0 + c;
      float v = 0.f;
      if (gx < W && ch < C) v = to_f32(c1[((img + y) * W + gx) * C + ch]);
      c1s[c * TX + p] = v;
    }
    __syncthreads();

#pragma unroll
    for (int c = 0; c < CC; ++c) {
      const float4 a4 = reinterpret_cast<const float4*>(c1s + c * TX)[tx];
      const float a[PX] = {a4.x, a4.y, a4.z, a4.w};
      const float4* row =
          reinterpret_cast<const float4*>(c2s + (ty * CC + c) * G::PWS + PX * tx);
      float v[PX + 2 * D];
#pragma unroll
      for (int q = 0; q < (PX + 2 * D) / 4; ++q) {
        const float4 t = row[q];
        v[4 * q] = t.x;
        v[4 * q + 1] = t.y;
        v[4 * q + 2] = t.z;
        v[4 * q + 3] = t.w;
      }
#pragma unroll
      for (int j = 0; j < PX; ++j)
#pragma unroll
        for (int k = 0; k < G::N; ++k) acc[j][k] = fmaf(a[j], v[j + k], acc[j][k]);
    }
  }

  __syncthreads();  // staging buffers become the output tile
#pragma unroll
  for (int j = 0; j < PX; ++j)
#pragma unroll
    for (int k = 0; k < G::N; ++k)
      outs[(PX * tx + j) * G::NN + ty * G::N + k] = acc[j][k] * inv_c;
  __syncthreads();

  const int valid = min(TX, W - xbase);
  T* dst = out + ((img + y) * W + xbase) * G::NN;
  for (int i = tid; i < valid * G::NN; i += G::THREADS) dst[i] = from_f32<T>(outs[i]);
}

template <typename T, int D>
cudaError_t launch(const void* c1, const void* c2, void* out, int B, int H, int W,
                   int C, cudaStream_t stream) {
  using G = Geo<D>;
  const dim3 grid((W + TX - 1) / TX, H, B);
  cost_volume_kernel<T, D><<<grid, G::THREADS, G::SMEM_FLOATS * sizeof(float), stream>>>(
      static_cast<const T*>(c1), static_cast<const T*>(c2), static_cast<T*>(out), H, W, C,
      1.0f / static_cast<float>(C));
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. search_range: 2 or 4. Returns a
// cudaError_t value: 0 when the launch was accepted.
extern "C" int fisr_cost_volume(const void* c1, const void* c2, void* out, int B, int H,
                                int W, int C, int search_range, int dtype, void* stream) {
  if (B < 1 || H < 1 || W < 1 || C < 1 || H > 65535 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && search_range == 4) return launch<float, 4>(c1, c2, out, B, H, W, C, s);
  if (dtype == 0 && search_range == 2) return launch<float, 2>(c1, c2, out, B, H, W, C, s);
  if (dtype == 1 && search_range == 4)
    return launch<__nv_bfloat16, 4>(c1, c2, out, B, H, W, C, s);
  if (dtype == 1 && search_range == 2)
    return launch<__nv_bfloat16, 2>(c1, c2, out, B, H, W, C, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* fisr_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
