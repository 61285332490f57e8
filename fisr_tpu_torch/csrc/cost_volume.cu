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
// 2C input values and writes 81. But the 81*C multiply-adds a pixel stay under
// the byte time only on the tensor cores: at the f32 FMA peak (67 TFLOP/s)
// they alone take as long as the bf16 bytes at C = 32 and longer from C = 64.
//
// Two kernels, chosen by type alone (never by whether a launch succeeded):
//
// bf16: cost_volume_kernel_mma_bf16, a banded matrix product. For one output
//   row, one dy and 8 consecutive pixels x0..x0+7, the 8 x (2d+1) costs are a
//   band of the 16 x 8 product A * B, with A the 16 c2 pixels x0-d .. x0-d+15
//   of row y+dy [16, C] and B the 8 c1 pixels [C, 8]: element (p, n) is the
//   cost of pixel x0+n at dx index k = p - n, where 0 <= k <= 2d. NHWC is the
//   layout mma.sync.m16n8k16 wants on both sides (A row-major, B column-major,
//   both with channels contiguous). What the design does about the bound:
//   * the arithmetic runs on the tensor cores (72 of a product's 128 elements
//     are useful at d = 4, still several times the f32 FMA peak), with bf16
//     products exact in f32 and f32 sums: the plain version's arithmetic in
//     another summation order;
//   * a block owns 4 output rows x 32 pixels and stages the 4+2d c2 rows it
//     needs once, so a c2 row comes from L2 3 times (d = 4), not 2d+1 times;
//   * staging is a straight asynchronous copy (cp.async) of raw bf16, 16
//     bytes at a time where C allows, no transpose and no conversion, 32
//     channels a pass through two buffers, so the next pass's copies fly
//     while this one is multiplied;
//   * a fragment register is one 32-bit shared-memory load of two consecutive
//     channels; each pixel's channel run is padded by 16 bytes so a warp's
//     fragment load meets 32 different banks; the windows of two neighbouring
//     8-pixel tiles overlap by 8 pixels, so a warp (one row, 16 pixels) loads
//     6 A registers for 2 products;
//   * a warp keeps all (2d+1)^2 displacements of its 16 pixels in registers
//     (9 dy x 2 n-tiles x 4 f32 = 72), across channel passes; that fits 128
//     registers a thread, so two blocks share an SM and one's copies and
//     write-out overlap the other's products;
//   * the output tile is cast once and goes out through shared memory as one
//     contiguous run per row, in 16-byte stores.
//   The c2 window is the 16-row operand because 8 + 2d <= 16: with the c1
//   pixels as the 16 rows the window needs 24 columns (3 products instead of
//   2, 108 sums a thread instead of 72, one block an SM).
//   No wgmma or TMA: the tiles are 8 pixels wide and the product is banded.
//
// f32: cost_volume_kernel_fma_f32. f32 inputs need f32 products (TF32 would
//   break the 1e-5 agreement with the plain version), so they keep the
//   CUDA-core kernel: a block stages one c1 row segment and its 2d+1 c2 rows
//   in shared memory, 8 channels a pass, and each thread keeps a 4-pixel x
//   (2d+1)-shift tile of sums in registers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ---- f32: FMAs on the CUDA cores ---------------------------------------------

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

template <int D>
__global__ void __launch_bounds__(Geo<D>::THREADS)
cost_volume_kernel_fma_f32(const float* __restrict__ c1, const float* __restrict__ c2,
                           float* __restrict__ out, int H, int W, int C, float inv_c) {
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
        v = c2[((img + gy) * W + gx) * C + ch];
      c2s[(r * CC + c) * G::PWS + p] = v;
    }
    for (int i = tid; i < TX * CC; i += G::THREADS) {
      const int c = i % CC;
      const int p = i / CC;
      const int gx = xbase + p;
      const int ch = c0 + c;
      float v = 0.f;
      if (gx < W && ch < C) v = c1[((img + y) * W + gx) * C + ch];
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
  float* dst = out + ((img + y) * W + xbase) * G::NN;
  for (int i = tid; i < valid * G::NN; i += G::THREADS) dst[i] = outs[i];
}

template <int D>
cudaError_t launch_fma_f32(const void* c1, const void* c2, void* out, int B, int H, int W,
                           int C, cudaStream_t stream) {
  using G = Geo<D>;
  const dim3 grid((W + TX - 1) / TX, H, B);
  cost_volume_kernel_fma_f32<D><<<grid, G::THREADS, G::SMEM_FLOATS * sizeof(float), stream>>>(
      static_cast<const float*>(c1), static_cast<const float*>(c2), static_cast<float*>(out),
      H, W, C, 1.0f / static_cast<float>(C));
  return cudaGetLastError();
}

// ---- bf16: the banded product on the tensor cores ---------------------------

constexpr int MR = 4;          // output rows per block
constexpr int MTX = 32;        // output pixels per row per block: 4 n-tiles of 8
constexpr int MPW = MTX + 8;   // staged c2 pixels per row: 16 from each n-tile's x0
constexpr int MKC = 32;        // channels per pass: 2 k-steps of 16
constexpr int MWARPS = 8;      // MR rows x 2 groups of 16 pixels
constexpr int MTHREADS = 32 * MWARPS;
static_assert(MWARPS == MR * MTX / 16, "one warp per row and 16 pixels");

template <int D>
struct MmaGeo {
  static constexpr int N = 2 * D + 1;
  static constexpr int NN = N * N;
  static constexpr int C2_ROWS = MR + 2 * D;     // staged c2 rows y0-D .. y0+MR-1+D
  static constexpr int C2_PIX = C2_ROWS * MPW;   // staged c2 pixels
  static constexpr int PIX = C2_PIX + MR * MTX;  // then the c1 tile
  // bf16 per staged pixel: MKC channels + 16 bytes (80 bytes), so 8 pixels x 4
  // channel pairs of one fragment load fall in 32 different banks
  static constexpr int S = MKC + 8;
  // one output row of the tile as bf16, plus room to shift it by up to 7 values
  static constexpr int OUT_ROW = MTX * NN + 8;
  static constexpr int STAGE = PIX * S;  // bf16 in one of the two staging buffers
  // two staging buffers, reused as the output tile; 2 bytes a value
  static constexpr int SMEM_BYTES = 2 * (2 * STAGE > MR * OUT_ROW ? 2 * STAGE : MR * OUT_ROW);
  static_assert(MKC % 16 == 0, "a pass is whole k-steps of 16 channels");
  static_assert(STAGE % 8 == 0 && OUT_ROW % 8 == 0, "buffers start on 16-byte units");
  static_assert(8 + 2 * D <= 16 && MTX + 2 * D <= MPW, "an n-tile's window is 16 c2 pixels");
  static_assert(2 * (SMEM_BYTES + 1024) <= 228 * 1024, "two blocks share an SM");
};

// The block's tile of the output: rows y0 .. y0+MR-1, pixels xbase .. xbase+MTX-1
struct Tile {
  int64_t img;    // b * H: the image's first row among all rows
  int y0, xbase;
};

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// D[16x8] += A[16x16] * B[16x8]; A row-major, B column-major, bf16 in, f32 sums.
// With lane = 4g + t: A registers hold (row g, k 2t..2t+1), (row g+8, same k),
// (row g, k 2t+8..2t+9), (row g+8, same k); B registers (k 2t..2t+1, col g),
// (k 2t+8..2t+9, col g); D registers (row g, col 2t), (g, 2t+1), (g+8, 2t),
// (g+8, 2t+1).
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], uint32_t a0, uint32_t a1,
                                               uint32_t a2, uint32_t a3, uint32_t b0,
                                               uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// One asynchronous copy of BYTES (16 or 8) from device to shared memory, or
// BYTES of zeros when `real` is false (a source size of 0 fills with zeros).
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool real) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  const int n = real ? BYTES : 0;
  if (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(n)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d), "l"(src), "r"(n)
                 : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Copy channels c0 .. c0+kc-1 of every staged pixel into shared memory, VEC
// bf16 at a time; zeros outside the frame and beyond C. A warp takes whole
// staged rows (the c2 rows, then the c1 rows), so one row base serves its
// copies. Copies of 16 and 8 bytes are asynchronous (all of a thread's copies
// are in flight together; the caller waits for them); single values go
// through registers.
template <int D, int VEC>
__device__ __forceinline__ void stage_chunk(const __nv_bfloat16* __restrict__ c1,
                                            const __nv_bfloat16* __restrict__ c2,
                                            __nv_bfloat16* stage, const Tile& tile, int H,
                                            int W, int C, int c0, int kc) {
  using G = MmaGeo<D>;
  constexpr int SLOTS = MKC / VEC;  // a power of two: the divisions below are shifts
  const int lane = threadIdx.x & 31;
  for (int row = threadIdx.x >> 5; row < G::C2_ROWS + MR; row += MWARPS) {
    const bool is_c2 = row < G::C2_ROWS;
    const int gy = tile.y0 + (is_c2 ? row - D : row - G::C2_ROWS);
    const int gx0 = tile.xbase - (is_c2 ? D : 0);
    const bool row_ok = gy >= 0 && gy < H;
    const __nv_bfloat16* src = is_c2 ? c2 : c1;
    const int64_t base = ((tile.img + gy) * W + gx0) * C + c0;
    __nv_bfloat16* dst =
        stage + (is_c2 ? row * MPW : G::C2_PIX + (row - G::C2_ROWS) * MTX) * G::S;
#pragma unroll 5
    for (int it = lane; it < (is_c2 ? MPW : MTX) * SLOTS; it += 32) {
      const int px = it / SLOTS;
      const int ch = (it % SLOTS) * VEC;
      if (ch >= kc) continue;
      const bool real = row_ok && gx0 + px >= 0 && gx0 + px < W && c0 + ch < C;
      const __nv_bfloat16* from = src + (real ? base + px * C + ch : 0);
      if constexpr (VEC == 1)
        dst[px * G::S + ch] = real ? *from : __nv_bfloat16(0.f);
      else
        cp_async<2 * VEC>(dst + px * G::S + ch, from, real);
    }
  }
}

// Stage channel pass `pass` of the tile. vec: bf16 values per copy, 8 (C % 8
// == 0, 16-byte aligned bases), 4 (C % 4 == 0, 8-byte aligned) or 1.
template <int D>
__device__ __forceinline__ void stage_pass(const __nv_bfloat16* __restrict__ c1,
                                           const __nv_bfloat16* __restrict__ c2,
                                           __nv_bfloat16* stage, const Tile& tile, int H, int W,
                                           int C, int pass, int vec) {
  const int c0 = pass * MKC;
  const int kc = min(MKC, (C - c0 + 15) / 16 * 16);
  if (vec == 8)
    stage_chunk<D, 8>(c1, c2, stage, tile, H, W, C, c0, kc);
  else if (vec == 4)
    stage_chunk<D, 4>(c1, c2, stage, tile, H, W, C, c0, kc);
  else
    stage_chunk<D, 1>(c1, c2, stage, tile, H, W, C, c0, kc);
}

template <int D>
__global__ void __launch_bounds__(MTHREADS, 2)
cost_volume_kernel_mma_bf16(const __nv_bfloat16* __restrict__ c1,
                            const __nv_bfloat16* __restrict__ c2,
                            __nv_bfloat16* __restrict__ out, int H, int W, int C, int vec,
                            float inv_c) {
  using G = MmaGeo<D>;
  extern __shared__ uint4 smem_u4[];
  __nv_bfloat16* stage = reinterpret_cast<__nv_bfloat16*>(smem_u4);  // [2][PIX][S]
  __nv_bfloat16* outs = stage;  // [MR][OUT_ROW], reused after the loop

  const Tile tile = {static_cast<int64_t>(blockIdx.z) * H, static_cast<int>(blockIdx.y * MR),
                     static_cast<int>(blockIdx.x * MTX)};
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = warp >> 1;  // output row of the tile
  const int m = warp & 1;   // pixels 16m .. 16m+15 of the row: n-tiles 2m and 2m+1
  const int g = lane >> 2, t = lane & 3;  // the fragment's group and thread in group

  // For n-tile nt (output pixels 16m+8nt .. +7) and dy index i, A is the c2
  // window: staged pixels 16m+8nt .. +15 of staged row r+i, so the two
  // n-tiles share the middle one of three groups of 8 pixels; B is the 8 c1
  // pixels. Both are read at channels 2t, 2t+1 (and +8).
  const int a_off = (r * MPW + 16 * m + g) * G::S + 2 * t;
  const int b_off = (G::C2_PIX + r * MTX + 16 * m + g) * G::S + 2 * t;

  float acc[G::N][2][4];
#pragma unroll
  for (int i = 0; i < G::N; ++i)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][nt][e] = 0.f;

  // Channel passes go through two buffers: the copies of pass p+1 are in
  // flight while pass p is multiplied.
  const int passes = (C + MKC - 1) / MKC;
  stage_pass<D>(c1, c2, stage, tile, H, W, C, 0, vec);
  for (int p = 0; p < passes; ++p) {
    cp_async_wait_all();
    // pass p has landed, and every warp is past pass p-1: its buffer is free
    __syncthreads();
    if (p + 1 < passes)
      stage_pass<D>(c1, c2, stage + ((p + 1) & 1) * G::STAGE, tile, H, W, C, p + 1, vec);
    const __nv_bfloat16* a_ptr = stage + (p & 1) * G::STAGE + a_off;
    const __nv_bfloat16* b_ptr = stage + (p & 1) * G::STAGE + b_off;
    const int kc = min(MKC, (C - p * MKC + 15) / 16 * 16);
    for (int k0 = 0; k0 < kc; k0 += 16) {
      uint32_t b[2][2];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        b[nt][0] = lds32(b_ptr + 8 * nt * G::S + k0);
        b[nt][1] = lds32(b_ptr + 8 * nt * G::S + k0 + 8);
      }
#pragma unroll
      for (int i = 0; i < G::N; ++i) {
        uint32_t a[3][2];  // [group of 8 window pixels][channels k0.. or k0+8..]
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          a[q][0] = lds32(a_ptr + (i * MPW + 8 * q) * G::S + k0);
          a[q][1] = lds32(a_ptr + (i * MPW + 8 * q) * G::S + k0 + 8);
        }
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
          mma_bf16_16816(acc[i][nt], a[nt][0], a[nt + 1][0], a[nt][1], a[nt + 1][1], b[nt][0],
                         b[nt][1]);
      }
    }
  }

  __syncthreads();  // the staging buffer becomes the output tile
  // Row r's run of out starts `shift` values into its OUT_ROW, so that the
  // 16-byte units of the tile are the 16-byte units of device memory.
  __nv_bfloat16* out_row = out + ((tile.img + tile.y0 + r) * W + tile.xbase) * G::NN;
  const int shift = (reinterpret_cast<uintptr_t>(out_row) >> 1) & 7;
  __nv_bfloat16* tile_row = outs + r * G::OUT_ROW;
  // D element e of n-tile nt: window pixel p = g + 8*(e/2) against output pixel
  // n = 2t + e%2 of the n-tile: the cost at dx index k = p - n, where that lies
  // in the band
#pragma unroll
  for (int i = 0; i < G::N; ++i)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = 2 * t + (e & 1);
        const int k = g + 8 * (e >> 1) - n;
        if (k >= 0 && k <= 2 * D)
          tile_row[shift + (16 * m + 8 * nt + n) * G::NN + i * G::N + k] =
              __float2bfloat16(acc[i][nt][e] * inv_c);
      }
  __syncthreads();

  // the two warps of row r write it out, 16 bytes a thread where a unit lies
  // wholly inside the run
  if (tile.y0 + r < H) {
    const int run = min(MTX, W - tile.xbase) * G::NN;  // the row's pixels, contiguous in out
    for (int u = 32 * m + lane; u < G::OUT_ROW / 8; u += 64) {
      const int e0 = 8 * u - shift;  // the unit's first value in the run
      if (e0 >= 0 && e0 + 8 <= run) {
        *reinterpret_cast<uint4*>(out_row + e0) =
            *reinterpret_cast<const uint4*>(tile_row + 8 * u);
      } else {
#pragma unroll
        for (int v = 0; v < 8; ++v)
          if (e0 + v >= 0 && e0 + v < run) out_row[e0 + v] = tile_row[8 * u + v];
      }
    }
  }
}

template <int D>
cudaError_t launch_mma_bf16(const void* c1, const void* c2, void* out, int B, int H, int W,
                            int C, cudaStream_t stream) {
  using G = MmaGeo<D>;
  auto kernel = cost_volume_kernel_mma_bf16<D>;
  // more than 48 KB of dynamic shared memory is opted into once per device:
  // the current one, which the caller makes the tensors' device. Two threads
  // that race here both opt in, which is harmless.
  static bool opted[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (!opted[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               G::SMEM_BYTES);
    if (err != cudaSuccess) return err;
    opted[dev] = true;
  }
  const uintptr_t bits = reinterpret_cast<uintptr_t>(c1) | reinterpret_cast<uintptr_t>(c2);
  const int vec = (C % 8 == 0 && bits % 16 == 0) ? 8 : (C % 4 == 0 && bits % 8 == 0) ? 4 : 1;
  const dim3 grid((W + MTX - 1) / MTX, (H + MR - 1) / MR, B);
  kernel<<<grid, MTHREADS, G::SMEM_BYTES, stream>>>(
      static_cast<const __nv_bfloat16*>(c1), static_cast<const __nv_bfloat16*>(c2),
      static_cast<__nv_bfloat16*>(out), H, W, C, vec, 1.0f / static_cast<float>(C));
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32 (the FMA kernel), 1 = bfloat16 (the tensor-core kernel),
// for every shape. search_range: 2 or 4. Returns a cudaError_t value: 0 when
// the launch was accepted.
extern "C" int fisr_cost_volume(const void* c1, const void* c2, void* out, int B, int H,
                                int W, int C, int search_range, int dtype, void* stream) {
  if (B < 1 || H < 1 || W < 1 || C < 1 || H > 65535 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && search_range == 4) return launch_fma_f32<4>(c1, c2, out, B, H, W, C, s);
  if (dtype == 0 && search_range == 2) return launch_fma_f32<2>(c1, c2, out, B, H, W, C, s);
  if (dtype == 1 && search_range == 4) return launch_mma_bf16<4>(c1, c2, out, B, H, W, C, s);
  if (dtype == 1 && search_range == 2) return launch_mma_bf16<2>(c1, c2, out, B, H, W, C, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* fisr_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
