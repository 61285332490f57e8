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
// Two forward kernels and two backward kernels, chosen by type alone (never
// by whether a launch succeeded):
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
//   break the 1e-5 agreement with the plain version), so the products stay on
//   the CUDA cores; at the FMA peak a frame pair's 9 GFLOP take about half its
//   byte time, so FMAs can reach the byte bound if the staging keeps up:
//   * a block owns 8 output rows x 16 pixels and stages the 8+2d c2 rows it
//     needs once (a c2 row comes from L2 twice at d = 4, not 2d+1 times; of
//     the tiles tried, 4 x 32 and 8 x 32 pixels among them, the fastest);
//   * staging is cp.async of raw NHWC runs, 16 bytes at a time where C % 4 ==
//     0 and the bases are 16-byte aligned (4 bytes otherwise), 16 channels a
//     pass through two buffers; halo zeros come from source-size-0 copies;
//   * warp i computes dy index i; lane (pixel group g, row r) keeps a 4-pixel
//     x (2d+1)-dx tile of sums and reads float4s of 4 channels: 4 c1 and
//     4+2d c2 loads give 16 (2d+1) FMAs. A staged pixel is 16+4 floats and a
//     staged row an odd number of pixels, so the 8 lanes of a quarter warp
//     (the 8 rows of one pixel group) meet 8 different 16-byte bank groups;
//   * small levels fill the card: where the tiles alone give fewer than two
//     blocks an SM, the channel passes are split over a cluster of up to 8
//     blocks on one tile; each keeps its partial tile in shared memory and,
//     after a cluster barrier, sums a share of the tile over the cluster's
//     blocks in rank order (distributed shared memory: no atomics, the same
//     result every run);
//   * the tile is scaled by 1/C once and goes out through shared memory as one
//     contiguous run per row, in 16-byte stores;
//   * where the tiles need no split, the blocks are persistent (two an SM) and
//     each walks its tiles with one stream of channel passes through the two
//     buffers: the next tile's first copies fly while this tile is finished
//     and written out (staging alone took as long as the FMAs and the
//     write-out together when every block staged its first pass cold).
//   Each (pixel, shift) is summed with FMAs in channel order within a split.
//
// backward: both input gradients of the cost volume, in one launch,
//
//   dc1[b,y,x,c] = (1/C) sum_k g[b,y,x,k] * c2[b,y+dy,x+dx,c]
//   dc2[b,y,x,c] = (1/C) sum_k g[b,y-dy,x-dx,k] * c1[b,y-dy,x-dx,c]
//
//   for k = (dy+d)(2d+1)+(dx+d). It stands for the JAX package's VJP of the
//   TPU kernel (_cv_bwd, fisr_tpu/kernels/cost_volume_pallas.py:81-86), an XLA
//   composition of 81 shifted products. Each output element is summed in f32
//   by one thread (no atomics: the same bits every run). What bounds it on
//   this card: bytes, g, c1 and c2 read once and dc1 and dc2 written once
//   (81 + 4C values a pixel); the 4*81*C FMAs a pixel take about as long at
//   the f32 FMA peak, so the design keeps shared-memory loads per FMA low.
//
// f32: cost_volume_bwd_f32, source rows streamed through register tiles:
//   * a block owns a tile of r output rows (r or 2r for dc2) x tx pixels (tx <=
//     32, sized to W so that narrow levels waste no pixel slots) x one chunk
//     of 4*cq channels of one gradient, and walks the source rows the tile
//     needs in order (rows outside the frame skipped): c2 rows for dc1, c1
//     rows and g rows together for dc2. So a source row comes from L2 about
//     (rows + 2d)/rows times, where a gather by dy fetched it 2d+1 times.
//     dc2's blocks come first in the grid: theirs is the longer work;
//   * staging is a two-stage cp.async ring (the next row's copies fly while
//     this row is summed): raw NHWC runs of the chunk's channels, 16 bytes a
//     copy where C % 4 == 0 and the bases are 16-byte aligned (4 bytes
//     otherwise), halo zeros from copies of source size 0; g as contiguous
//     pixel runs (a pixel's 81 values are contiguous), one run a row in
//     16-byte copies with 4-byte copies at its two ends, placed in shared
//     memory at the run's own 16-byte phase. For dc1 the tile's r g rows are
//     staged once with the first source row; for dc2 each source row brings
//     its g row, and the g of pixels outside the frame is stored as zeros;
//   * register tiles: a thread keeps r consecutive pixels x 4 channels (a
//     float4) for each of its rows, across all (2d+1)^2 displacements. For
//     each staged row it reads the r + 2d staged pixels it needs as float4s
//     once and adds them into every output row the staged row touches, with
//     g as shared-memory broadcasts (the channel lanes of a pixel read one
//     address). The tiles (r = 2 or 1; dc2's rows r or 2r) are the coarsest
//     whose threads give each SM 8 warps or more. Of the tiles tried on the
//     H100 at the training levels (4 x 4, 2 x 2, 1 x 1 for both gradients,
//     dc2's rows 1, 2 or 4 times dc1's; two or three stages), these were the
//     fastest or near it at every level. dc2 alone took most of the time
//     with equal tiles, hence its taller ones;
//   * small levels fill the card by splitting the output channels over
//     blocks: each output channel is independent (the sum is over
//     displacements), so the split needs no reduction. The chunk shrinks
//     (32, 16, 8, 4 channels) until every level launches two blocks an SM; a
//     block has one warp at least, for the staging;
//   * the tile is scaled by 1/C once and written out once, float4s where C
//     % 4 == 0.
//   Sums run in source-row order, then staged-pixel order: the plain
//   version's (dy, dx) order for dc1, another order for dc2.
//
// bf16: cost_volume_bwd_bf16, a banded product on the tensor cores, streamed
//   like the f32 kernel. For one output row, one source row at dy index i and
//   8 output pixels x0..x0+7, the gradient is one mma.sync.m16n8k16,
//   D[16 channels x 8 pixels] += A * B, with A the 16 staged source pixels
//   x0-d .. x0-d+15 transposed [16 channels x 16 pixels] (8 + 2d <= 16: one
//   k-step holds the window) and B the band of g [16 pixels x 8 pixels]:
//   dc1: B[k][n] = g[y, x0+n, i, k-n], dc2: B[k][n] = g[y-dy, x0-d+k, i,
//   n-k+2d], zero where the dx index lies outside [0, 2d] (9 of a column's 16
//   k at d = 4). The source window is the 16-row operand for the reason the
//   forward's c2 window is. What the design does about the bound:
//   * A comes from the source row staged as it lies in memory ([pixel]
//     [channels], raw bf16) through one ldmatrix.x4.trans a 16-channel
//     m-tile: no transpose in the staging. A staged pixel is 16 mt + 8
//     values, an odd number of 16-byte units, so ldmatrix meets 8 different
//     bank groups; neighbouring n-tiles share 8 of their 16 window pixels;
//   * B is built per (source row, output row, n-tile) from g staged raw in
//     shared memory (bf16, so exact): each lane loads its 4 band entries at
//     offsets fixed for the lane, and the B serves every m-tile of the block;
//   * a block owns r output rows x 8 nt pixels (nt <= 4 n-tiles, a warp
//     each) x one chunk of m-tiles of one gradient, and walks the source rows
//     y0-d .. y0+r-1+d through a two-stage cp.async ring (a deeper one was no
//     faster on a scratch variant); for dc2 each source row brings
//     its g row, for dc1 each g row of the tile comes with the first source
//     row that needs it. A thread keeps r x m-tiles x 4 f32 sums (16 products,
//     64 registers, no spills at four blocks an SM);
//   * g's 81 values a pixel are 2-byte aligned only: a row's run is staged as
//     the whole 16-byte units that hold it, at the run's own phase (the few
//     values of the neighbouring pixels that share its first and last unit
//     come along and are never read); the band reads of dc2 are zero for
//     pixels outside the frame instead of stored zeros. Copying those partial
//     units one value at a time, synchronously, cost every row step a trip
//     to device memory;
//   * tiles (r1, r2) of (8, 8), (2, 4), (1, 1): the one whose launch needs
//     the fewest waves (four blocks an SM) times the longest chain of row
//     steps; then the output channels split into chunks until the launch
//     gives two blocks an SM (no reduction: channels are independent). At
//     the pwc_train levels: (8, 8) at level 2, (2, 4) at level 3, (1, 1)
//     below (scripts/time_cost_volume_backward.py times each tile forced).
//     On scratch variants of this kernel a row step took about as long
//     whether a launch ran in one wave or in two, so the chain's length and
//     the step's own work set the time; the band build and the products were
//     half of a step at level 2 until the lane's and the row's offsets were
//     precomputed and the rows predicated instead of branched;
//   * the f32 sums are scaled by 1/C once, cast once, and go out through
//     shared memory as NHWC runs, 16-byte stores where C % 8 == 0.
//   Sums run in f32 in source-row order, 16 window pixels a product. What
//   keeps it above its byte bound (chip_smoke.py prints each level against
//   it): each row step's staging and band build, and at the small levels a
//   floor of launch, first copies and write-out.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

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

// ---- f32: FMAs on the CUDA cores ---------------------------------------------

constexpr int FR = 8;          // output rows per block
constexpr int FTX = 16;        // output pixels per row per block
constexpr int FPX = 4;         // consecutive pixels per thread
constexpr int FKC = 16;        // channels per pass
constexpr int FS = FKC + 4;    // floats per staged pixel
constexpr int FMAX_SPLIT = 8;  // blocks of a cluster (the portable most)

template <int D>
struct FmaGeo {
  static constexpr int N = 2 * D + 1;
  static constexpr int NN = N * N;
  static constexpr int THREADS = 32 * N;       // warp i: dy index i
  static constexpr int C2_ROWS = FR + 2 * D;   // staged c2 rows y0-D .. y0+FR-1+D
  static constexpr int RP2 = FTX + 2 * D + 1;  // staged pixels per c2 row, one of them padding
  static constexpr int RP1 = FTX + 1;          // staged pixels per c1 row, one of them padding
  static constexpr int C1_PIX = C2_ROWS * RP2; // the c1 rows start after this many pixels
  static constexpr int STAGE = (C1_PIX + FR * RP1) * FS;  // floats in one staging buffer
  // one output row of the tile, plus room to shift it by up to 3 values
  static constexpr int OUT_ROW = FTX * NN + 4;
  static constexpr int SMEM_BYTES = 4 * 2 * STAGE;
  static_assert(FR * (FTX / FPX) == 32, "a warp's lanes are the tile's rows x pixel groups");
  static_assert(RP2 % 2 == 1 && RP1 % 2 == 1 && FS % 8 == 4, "odd row strides of FS % 8 == 4 floats");
  static_assert(STAGE % 4 == 0 && OUT_ROW % 4 == 0, "buffers start on 16-byte units");
  static_assert(FR * OUT_ROW <= STAGE, "a tile's output fits in one staging buffer");
  static_assert(2 * (SMEM_BYTES + 1024) <= 228 * 1024, "two blocks share an SM");
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool real) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(real ? 4 : 0)
               : "memory");
}

// Copy channels c0 .. c0+kc-1 of the block's staged pixels into one buffer,
// VEC floats a copy (4: 16-byte copies, 1: 4-byte copies); zeros outside the
// frame and beyond C. A warp takes whole staged rows.
template <int D, int VEC>
__device__ __forceinline__ void fma_stage(const float* __restrict__ c1,
                                          const float* __restrict__ c2, float* stage,
                                          int64_t img, int y0, int x0, int H, int W, int C,
                                          int c0, int kc) {
  using G = FmaGeo<D>;
  constexpr int SLOTS = FKC / VEC;
  const int lane = threadIdx.x & 31;
  for (int row = threadIdx.x >> 5; row < G::C2_ROWS + FR; row += G::THREADS / 32) {
    const bool is_c2 = row < G::C2_ROWS;
    const int gy = is_c2 ? y0 + row - D : y0 + row - G::C2_ROWS;
    const int gx0 = is_c2 ? x0 - D : x0;
    const int npx = is_c2 ? FTX + 2 * D : FTX;
    const bool row_ok = gy >= 0 && gy < H;
    const float* src = is_c2 ? c2 : c1;
    const int64_t base = ((img + gy) * W + gx0) * C + c0;
    float* dst = stage + (is_c2 ? row * G::RP2 : G::C1_PIX + (row - G::C2_ROWS) * G::RP1) * FS;
    for (int it = lane; it < npx * SLOTS; it += 32) {
      const int px = it / SLOTS;
      const int ch = (it % SLOTS) * VEC;
      if (ch >= kc) continue;
      const bool real = row_ok && gx0 + px >= 0 && gx0 + px < W && c0 + ch < C;
      const float* from = src + (real ? base + static_cast<int64_t>(px) * C + ch : 0);
      if constexpr (VEC == 4)
        cp_async<16>(dst + px * FS + ch, from, real);
      else
        cp_async4(dst + px * FS + ch, from, real);
    }
  }
}

// The tile a block works on: rows y0 .. y0+FR-1, pixels x0 .. x0+FTX-1 of image b
struct FmaTile {
  int64_t img;  // b * H
  int y0, x0;
};

__device__ __forceinline__ FmaTile fma_tile(int t, int tiles_x, int tiles_y, int H) {
  return {static_cast<int64_t>(t / (tiles_x * tiles_y)) * H, (t / tiles_x) % tiles_y * FR,
          t % tiles_x * FTX};
}

// Grid: split == 1: persistent blocks, each walking the tiles t = blockIdx.x,
// blockIdx.x + gridDim.x, ...; split > 1: one tile per cluster of `split`
// blocks, rank = blockIdx.x % split. A block's channel passes of all its
// tiles form one stream through the two buffers, so the next tile's first
// pass is in flight while this tile is finished and written out.
// VEC: floats a copy, 4 (C % 4 == 0, 16-byte aligned bases) or 1.
template <int D, int VEC>
__global__ void __launch_bounds__(FmaGeo<D>::THREADS, 2)
cost_volume_kernel_fma_f32(const float* __restrict__ c1, const float* __restrict__ c2,
                           float* __restrict__ out, int B, int H, int W, int C, int split,
                           float inv_c) {
  using G = FmaGeo<D>;
  namespace cg = cooperative_groups;
  extern __shared__ float4 fsmem_f4[];
  float* smem = reinterpret_cast<float*>(fsmem_f4);  // [2][STAGE]; a tile's output in one

  const int tiles_x = (W + FTX - 1) / FTX, tiles_y = (H + FR - 1) / FR;
  const int tiles = tiles_x * tiles_y * B;
  const int rank = blockIdx.x % split;  // the block's share of the channel passes
  const int stride = gridDim.x / split;
  const int i = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = lane % FR, g = lane / FR;  // output row r of the tile, pixels 4g .. 4g+3

  // c1 pixel 4g of row r; c2 staged pixel 4g (image pixel x0+4g-D) of row r+i
  const int a_off = (G::C1_PIX + r * G::RP1 + FPX * g) * FS;
  const int b_off = ((r + i) * G::RP2 + FPX * g) * FS;

  const int passes = (C + FKC - 1) / FKC;
  const int p0 = rank * passes / split, p1 = (rank + 1) * passes / split;
  auto stage_pass = [&](int t, int p, float* buf) {
    const FmaTile tl = fma_tile(t, tiles_x, tiles_y, H);
    const int c0 = p * FKC;
    fma_stage<D, VEC>(c1, c2, buf, tl.img, tl.y0, tl.x0, H, W, C, c0,
                      (min(FKC, C - c0) + 3) / 4 * 4);
  };

  int s = 0;  // this block's stages so far: stage s lives in buffer s & 1
  int t = blockIdx.x / split;
  if (t < tiles) stage_pass(t, p0, smem);
  for (; t < tiles; t += stride) {
    float acc[FPX][G::N];
#pragma unroll
    for (int j = 0; j < FPX; ++j)
#pragma unroll
      for (int k = 0; k < G::N; ++k) acc[j][k] = 0.f;

    for (int p = p0; p < p1; ++p, ++s) {
      cp_async_wait_all();
      // stage s has landed, and every warp is past stage s-1 (and the last
      // tile's write-out): the other buffer is free
      __syncthreads();
      float* next = smem + ((s + 1) & 1) * G::STAGE;
      if (p + 1 < p1)
        stage_pass(t, p + 1, next);
      else if (t + stride < tiles)
        stage_pass(t + stride, p0, next);
      const float* buf = smem + (s & 1) * G::STAGE;
      const int kq = (min(FKC, C - p * FKC) + 3) / 4;
      for (int q4 = 0; q4 < kq; ++q4) {
        float4 a[FPX];
#pragma unroll
        for (int j = 0; j < FPX; ++j)
          a[j] = *reinterpret_cast<const float4*>(buf + a_off + j * FS + 4 * q4);
#pragma unroll
        for (int q = 0; q < FPX + 2 * D; ++q) {
          const float4 v = *reinterpret_cast<const float4*>(buf + b_off + q * FS + 4 * q4);
#pragma unroll
          for (int j = 0; j < FPX; ++j) {
            const int k = q - j;  // dx index of pixel 4g+j against c2 pixel 4g+q
            if (k >= 0 && k < G::N) {
              acc[j][k] = fmaf(a[j].x, v.x, acc[j][k]);
              acc[j][k] = fmaf(a[j].y, v.y, acc[j][k]);
              acc[j][k] = fmaf(a[j].z, v.z, acc[j][k]);
              acc[j][k] = fmaf(a[j].w, v.w, acc[j][k]);
            }
          }
        }
      }
    }

    // The buffer of the last stage becomes the (partial) output tile; the
    // other one holds the next tile's first pass, in flight. A cluster's
    // blocks (one tile each, no next pass) all use the first buffer, so that
    // one address names the tile in each of them, whatever their pass counts.
    // Row rr's run of out starts shift(rr) values into its OUT_ROW, so that
    // the 16-byte units of the tile are the 16-byte units of device memory.
    __syncthreads();
    const FmaTile tl = fma_tile(t, tiles_x, tiles_y, H);
    float* tile = split > 1 ? smem : smem + ((s - 1) & 1) * G::STAGE;
    auto out_row = [&](int rr) { return out + ((tl.img + tl.y0 + rr) * W + tl.x0) * G::NN; };
    auto shift = [&](int rr) {
      return static_cast<int>((reinterpret_cast<uintptr_t>(out_row(rr)) >> 2) & 3);
    };
#pragma unroll
    for (int j = 0; j < FPX; ++j)
#pragma unroll
      for (int k = 0; k < G::N; ++k)
        tile[r * G::OUT_ROW + shift(r) + (FPX * g + j) * G::NN + i * G::N + k] = acc[j][k];
    if (split > 1)
      cg::this_cluster().sync();  // every block's partial tile is complete
    else
      __syncthreads();

    // this block's share of the tile's 16-byte units, summed over the cluster
    constexpr int ROW_UNITS = G::OUT_ROW / 4;
    const int units = FR * ROW_UNITS;
    const int u0 = rank * units / split, u1 = (rank + 1) * units / split;
    const int run = min(FTX, W - tl.x0) * G::NN;  // a row's values, contiguous in out
    for (int u = u0 + static_cast<int>(threadIdx.x); u < u1; u += G::THREADS) {
      const int rr = u / ROW_UNITS, uu = u % ROW_UNITS;
      if (tl.y0 + rr >= H) continue;
      const int e0 = 4 * uu - shift(rr);  // the unit's first value in the run
      if (e0 + 4 <= 0 || e0 >= run) continue;
      float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int src = 0; src < split; ++src) {
        const float* from = split > 1 ? cg::this_cluster().map_shared_rank(tile, src) : tile;
        const float4 v = *reinterpret_cast<const float4*>(from + rr * G::OUT_ROW + 4 * uu);
        sum.x += v.x;
        sum.y += v.y;
        sum.z += v.z;
        sum.w += v.w;
      }
      sum = make_float4(sum.x * inv_c, sum.y * inv_c, sum.z * inv_c, sum.w * inv_c);
      float* dst = out_row(rr);
      if (e0 >= 0 && e0 + 4 <= run) {
        *reinterpret_cast<float4*>(dst + e0) = sum;
      } else {
        const float vals[4] = {sum.x, sum.y, sum.z, sum.w};
#pragma unroll
        for (int v = 0; v < 4; ++v)
          if (e0 + v >= 0 && e0 + v < run) dst[e0 + v] = vals[v];
      }
    }
    // no block leaves (or restages) while another reads its tile
    if (split > 1) cg::this_cluster().sync();
  }
}

// The channel split: the smallest power of two (at most FMAX_SPLIT) that gives
// two blocks an SM, keeping two channel passes a block or more.
inline int fma_split(int64_t tiles, int passes, int sms) {
  int split = 1;
  while (split < FMAX_SPLIT && tiles * split < 2 * sms && passes >= 2 * split) split *= 2;
  return split;
}

template <int D, int VEC>
cudaError_t launch_fma_f32_vec(const float* c1, const float* c2, float* out, int B, int H, int W,
                           int C, cudaStream_t stream) {
  using G = FmaGeo<D>;
  auto kernel = cost_volume_kernel_fma_f32<D, VEC>;
  // more than 48 KB of dynamic shared memory is opted into once per device
  // (as for the bf16 kernel), and the SM count read then
  static bool opted[64] = {};
  static int sms[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (!opted[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               G::SMEM_BYTES);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    opted[dev] = true;
  }
  const int64_t tiles = static_cast<int64_t>((W + FTX - 1) / FTX) * ((H + FR - 1) / FR) * B;
  if (tiles * FMAX_SPLIT > INT32_MAX) return cudaErrorInvalidValue;
  const int split = fma_split(tiles, (C + FKC - 1) / FKC, sms[dev]);
  // split 1: two persistent blocks an SM (or one a tile); else a cluster a tile
  const int64_t blocks = split == 1 ? std::min<int64_t>(tiles, 2 * sms[dev]) : tiles * split;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(blocks));
  cfg.blockDim = dim3(G::THREADS);
  cfg.dynamicSmemBytes = G::SMEM_BYTES;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, c1, c2, out, B, H, W, C, split,
                           1.0f / static_cast<float>(C));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_fma_f32(const void* c1, const void* c2, void* out, int B, int H, int W,
                           int C, cudaStream_t stream) {
  const uintptr_t bits = reinterpret_cast<uintptr_t>(c1) | reinterpret_cast<uintptr_t>(c2);
  const float* a = static_cast<const float*>(c1);
  const float* b = static_cast<const float*>(c2);
  float* o = static_cast<float*>(out);
  if (C % 4 == 0 && bits % 16 == 0) return launch_fma_f32_vec<D, 4>(a, b, o, B, H, W, C, stream);
  return launch_fma_f32_vec<D, 1>(a, b, o, B, H, W, C, stream);
}

// ---- backward, f32: streamed source rows, register tiles ----------------------

constexpr int BTILE_PX = 32;  // pixels of a tile row, at most
constexpr int BMAX_CQ = 8;    // channel quads of a block, at most: 32 channels
constexpr int BMIN_THREADS = 32;  // a block stages with one warp at least
constexpr int BSTAGES = 2;        // source rows in the cp.async ring: 1 in flight (3 was no faster)

// The register tile of a thread: tr consecutive pixels x 4 channels for
// each of its output rows, tr rows for dc1 and m * tr for dc2 (whose source
// rows bring their g rows: taller tiles stage each g row fewer times, where
// dc1 keeps its tile's g rows in shared memory). tr = 2 reads a staged float4
// for 2 to 8 sums of it; tr = 1 and m = 1 spread smaller levels over more
// threads. (4 x 4 for both gradients was no faster than 2 x 2: fewer warps
// an SM.)
template <int TR, int M>
struct BwdTile {
  static constexpr int P = TR;
  static constexpr int R1 = TR, R2 = M * TR;
  static constexpr int MAX_THREADS = BTILE_PX / P * BMAX_CQ;
};

// The launch plan of cost_volume_bwd_f32.
struct BwdPlan {
  int r1, r2;       // tile rows of dc1 and of dc2
  int pg, cq;       // pixel groups, channel quads: pg * cq threads compute
  int cq_log2;
  int threads;      // at least BMIN_THREADS
  int tiles_x, tiles_y1, tiles_y2, chunks;
  int tx, s;        // tile width in pixels; floats a staged pixel of c (4 cq + 4)
  int g_row;        // floats a staged g row of dc2: (tx + 2d) x 81 + its 16-byte phase
  int g_tile_row;   // floats a g row of dc1's tile: tx x 81 + its 16-byte phase
  int smem_floats;
  int cvec, gvec;   // 16-byte copies of c1/c2 (and float4 stores), of g
  int64_t blocks1, blocks2;  // tiles x chunks of dc1 and of dc2 (0 where not asked for)
};

inline int round4(int v) { return (v + 3) / 4 * 4; }

// Tiles: rows of r1 (dc1) or r2 (dc2), columns of at most 32 pixels, as even
// as W allows, in whole pixel groups of p. Channels: the smallest
// power-of-two count of quads (up to 8) that covers C, halved while the
// launch gives fewer than two blocks an SM.
inline BwdPlan bwd_plan(int B, int H, int W, int C, int d, bool need1, bool need2, int sms,
                        int r1, int r2, int p) {
  BwdPlan pl;
  pl.r1 = r1;
  pl.r2 = r2;
  pl.tiles_x = (W + BTILE_PX - 1) / BTILE_PX;
  const int tx = (W + pl.tiles_x - 1) / pl.tiles_x;
  pl.pg = (tx + p - 1) / p;
  pl.tx = pl.pg * p;
  pl.tiles_y1 = (H + r1 - 1) / r1;
  pl.tiles_y2 = (H + r2 - 1) / r2;
  const int64_t tiles1 = need1 ? static_cast<int64_t>(B) * pl.tiles_x * pl.tiles_y1 : 0;
  const int64_t tiles2 = need2 ? static_cast<int64_t>(B) * pl.tiles_x * pl.tiles_y2 : 0;
  auto blocks = [&](int cq) { return (tiles1 + tiles2) * ((C + 4 * cq - 1) / (4 * cq)); };
  pl.cq = BMAX_CQ;
  while (pl.cq > 1 && 4 * (pl.cq / 2) >= C) pl.cq /= 2;
  while (pl.cq > 1 && blocks(pl.cq) < 2 * sms) pl.cq /= 2;
  pl.cq_log2 = 0;
  while ((1 << pl.cq_log2) < pl.cq) ++pl.cq_log2;
  pl.threads = std::max(pl.pg * pl.cq, BMIN_THREADS);
  pl.chunks = (C + 4 * pl.cq - 1) / (4 * pl.cq);
  pl.blocks1 = tiles1 * pl.chunks;
  pl.blocks2 = tiles2 * pl.chunks;
  pl.s = 4 * pl.cq + 4;
  const int nn = (2 * d + 1) * (2 * d + 1);
  const int win = pl.tx + 2 * d;  // staged pixels of a source row
  pl.g_row = round4(win * nn + 3);
  pl.g_tile_row = round4(pl.tx * nn + 3);
  pl.smem_floats = BSTAGES * win * pl.s + std::max(r1 * pl.g_tile_row, BSTAGES * pl.g_row);
  pl.cvec = pl.gvec = 0;
  return pl;
}

// The register tiles for a launch of `outputs` output values: the first of
// (tr, m) = (2, 2), (2, 1), (1, 2), (1, 1) whose threads give each SM 8
// warps or more, else (1, 1). A thread has 4 tr^2 outputs of dc1 and 4 tr^2 m
// of dc2: 2 tr^2 (1 + m) on the mean.
inline int bwd_tile_choice(int64_t outputs, int sms) {
  constexpr int per_thread[3] = {24, 16, 6};
  for (int k = 0; k < 3; ++k)
    if (outputs / per_thread[k] >= static_cast<int64_t>(8) * 32 * sms) return k;
  return 3;
}

__device__ __forceinline__ int mod4(int64_t v) { return static_cast<int>(((v % 4) + 4) % 4); }

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copy floats first .. first+n-1 of the g run that starts at index e_row
// into shared memory at dst + (e_row mod 4), in the run's order, so that
// 16-byte units of g are 16-byte units there: 16-byte copies for the whole
// units and 4-byte copies at the two ends (gvec), or 4-byte copies
// throughout (g not 16-byte aligned). Nothing else is written.
__device__ __forceinline__ void stage_g_run(const float* __restrict__ g, int64_t e_row,
                                            int first, int n, float* dst, bool gvec, int tid,
                                            int nthreads) {
  const int64_t e0 = e_row + first;
  dst += mod4(e_row) + first;
  if (gvec) {
    const int sh = mod4(e0);
    const int units = (sh + n + 3) / 4;  // the 16-byte units that the copies touch
    for (int u = tid; u < units; u += nthreads) {
      const int lo = 4 * u - sh;  // the unit's first float, counted from e0
      if (lo >= 0 && lo + 4 <= n) {
        cp_async<16>(dst + lo, g + e0 + lo, true);
      } else {
        for (int v = max(lo, 0); v < min(lo + 4, n); ++v) cp_async4(dst + v, g + e0 + v, true);
      }
    }
  } else {
    for (int e = tid; e < n; e += nthreads) cp_async4(dst + e, g + e0 + e, true);
  }
}

// Stage source row sy of a tile into ring buffer `buf`: the chunk's channels
// of its tx + 2D staged pixels (image pixels x0-D ..), zeros outside the
// frame [q_lo, q_hi) and beyond C; for dc2 (WHICH 1) also its g row, the run
// of its pixels in the frame and zeros for the others.
template <int D, int WHICH>
__device__ __forceinline__ void bwd_stage_row(const float* __restrict__ src,
                                              const float* __restrict__ g, float* cring,
                                              float* gs, int64_t img, int sy, int buf, int x0,
                                              int c0, int W, int C, int q_lo, int q_hi,
                                              const BwdPlan& pl) {
  constexpr int NN = (2 * D + 1) * (2 * D + 1);
  const int tid = threadIdx.x, nthreads = pl.threads;
  const int win = pl.tx + 2 * D;
  float* cdst = cring + buf * win * pl.s;
  const int64_t base = ((img + sy) * W + x0 - D) * C + c0;
  const int kc = 4 * pl.cq;
  if (pl.cvec) {
    for (int it = tid; it < win * pl.cq; it += nthreads) {
      const int px = it >> pl.cq_log2, ch = 4 * (it & (pl.cq - 1));
      const bool real = px >= q_lo && px < q_hi && c0 + ch < C;
      cp_async<16>(cdst + px * pl.s + ch, src + (real ? base + int64_t{px} * C + ch : 0), real);
    }
  } else {
    for (int it = tid; it < win * kc; it += nthreads) {
      const int px = it >> (pl.cq_log2 + 2), ch = it & (kc - 1);
      const bool real = px >= q_lo && px < q_hi && c0 + ch < C;
      cp_async4(cdst + px * pl.s + ch, src + (real ? base + int64_t{px} * C + ch : 0), real);
    }
  }
  if constexpr (WHICH == 1) {
    float* gdst = gs + buf * pl.g_row;
    const int64_t e_row = ((img + sy) * W + x0 - D) * NN;  // staged pixel 0
    stage_g_run(g, e_row, q_lo * NN, (q_hi - q_lo) * NN, gdst, pl.gvec, tid, nthreads);
    const int sh = mod4(e_row);
    for (int e = tid; e < q_lo * NN; e += nthreads) gdst[sh + e] = 0.f;
    for (int e = q_hi * NN + tid; e < win * NN; e += nthreads) gdst[sh + e] = 0.f;
  }
}

// One block's tile of one gradient. WHICH 0: dc1 from the c2 rows y0-D ..
// y0+R-1+D and the tile's own g rows; WHICH 1: dc2 from the c1 and g rows
// y0-D .. y0+R-1+D. Staged pixel q of a source row is image pixel x0-D+q.
template <int D, int R, int P, int WHICH>
__device__ __forceinline__ void bwd_f32_tile(const float* __restrict__ src,
                                             const float* __restrict__ g, float* __restrict__ dst,
                                             float* smem, int b, int y0, int x0, int c0, int H,
                                             int W, int C, const BwdPlan& pl, float inv_c) {
  constexpr int N = 2 * D + 1, NN = N * N;
  const int tid = threadIdx.x, nthreads = pl.threads;
  const int q = tid & (pl.cq - 1), pgi = tid >> pl.cq_log2;  // channel quad, pixel group
  const bool computes = pgi < pl.pg;            // the others only stage
  const int win = pl.tx + 2 * D;
  const int c_stage = win * pl.s;
  float* cring = smem;                   // [BSTAGES][win][s]
  float* gs = smem + BSTAGES * c_stage;  // dc1: [R][g_tile_row]; dc2: [BSTAGES][g_row]
  const int64_t img = static_cast<int64_t>(b) * H;
  const int q_lo = max(0, D - x0), q_hi = min(win, W - x0 + D);  // staged pixels in the frame

  // the source rows in the frame, one cp.async group each, the first with
  // dc1's g tile (rows y0 .. y0+R-1 in the frame, pixels x0 .. x0+tx-1 in
  // the frame)
  const int s_lo = max(0, D - y0), s_hi = min(R + 2 * D, H - y0 + D);
  if constexpr (WHICH == 0) {
    const int n_px = min(pl.tx, W - x0);
    for (int r = 0; r < R && y0 + r < H; ++r)
      stage_g_run(g, ((img + y0 + r) * W + x0) * NN, 0, n_px * NN, gs + r * pl.g_tile_row,
                  pl.gvec, tid, nthreads);
  }
#pragma unroll
  for (int st = 0; st < BSTAGES - 1; ++st) {
    if (s_lo + st < s_hi)
      bwd_stage_row<D, WHICH>(src, g, cring, gs, img, y0 - D + s_lo + st, st, x0, c0, W, C,
                              q_lo, q_hi, pl);
    cp_async_commit();
  }

  float4 acc[R][P];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int p = 0; p < P; ++p) acc[r][p] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int s = s_lo; s < s_hi; ++s) {
    cp_async_wait_group<BSTAGES - 2>();
    // row s has landed, and every thread is past row s-1: its buffer is free
    __syncthreads();
    const int buf = (s - s_lo) % BSTAGES;
    if (s + BSTAGES - 1 < s_hi)
      bwd_stage_row<D, WHICH>(src, g, cring, gs, img, y0 - D + s + BSTAGES - 1,
                              (s - s_lo + BSTAGES - 1) % BSTAGES, x0, c0, W, C, q_lo, q_hi, pl);
    cp_async_commit();
    if (!computes) continue;
    const float* cw = cring + buf * c_stage + pgi * P * pl.s + 4 * q;
    // output row r takes this source row at dy index i; its g values are at
    // gs[gb[r] + (pixel) * NN + (dx index)]
    int gb[R];
    bool live[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = WHICH == 0 ? s - r : r - s + 2 * D;
      live[r] = i >= 0 && i < N;
      gb[r] = (WHICH == 0
                   ? r * pl.g_tile_row + mod4(((img + y0 + r) * W + x0) * NN)
                   : buf * pl.g_row + mod4(((img + y0 - D + s) * W + x0 - D) * NN)) +
              pgi * P * NN + i * N;
    }
#pragma unroll
    for (int k = 0; k < P + 2 * D; ++k) {
      const float4 v = *reinterpret_cast<const float4*>(cw + k * pl.s);
#pragma unroll
      for (int p = 0; p < P; ++p) {
        // dc1: staged pixel pgi*P+k against output pixel pgi*P+p at dx index
        // j = k - p, g at the output pixel; dc2: j = p + 2D - k, g at the
        // staged pixel
        const int j = WHICH == 0 ? k - p : p + 2 * D - k;
        if (j < 0 || j >= N) continue;
        const int off = (WHICH == 0 ? p : k) * NN + j;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          if (!live[r]) continue;
          const float gv = gs[gb[r] + off];
          acc[r][p].x = fmaf(gv, v.x, acc[r][p].x);
          acc[r][p].y = fmaf(gv, v.y, acc[r][p].y);
          acc[r][p].z = fmaf(gv, v.z, acc[r][p].z);
          acc[r][p].w = fmaf(gv, v.w, acc[r][p].w);
        }
      }
    }
  }

  const int c = c0 + 4 * q;
  if (!computes || c >= C) return;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (y0 + r >= H) break;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int x = x0 + pgi * P + p;
      if (x >= W) break;
      const float vals[4] = {acc[r][p].x * inv_c, acc[r][p].y * inv_c, acc[r][p].z * inv_c,
                             acc[r][p].w * inv_c};
      float* to = dst + ((img + y0 + r) * W + x) * C + c;
      if (pl.cvec) {
        *reinterpret_cast<float4*>(to) = make_float4(vals[0], vals[1], vals[2], vals[3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (c + e < C) to[e] = vals[e];
      }
    }
  }
}

// Grid: one block a (tile, channel chunk) of each gradient asked for, the
// chunk fastest; dc2's blocks first (they take longer: each source row
// brings a g row), then dc1's; pl.threads threads.
// (Two blocks an SM as the compiler's target: without it, ptxas spilled 8
// bytes in the (2, 2) tiles at 96 registers.)
template <int D, int TR, int M>
__global__ void __launch_bounds__(BwdTile<TR, M>::MAX_THREADS, 2)
cost_volume_bwd_f32(const float* __restrict__ c1, const float* __restrict__ c2,
                    const float* __restrict__ g, float* __restrict__ dc1,
                    float* __restrict__ dc2, int H, int W, int C, BwdPlan pl, float inv_c) {
  using T = BwdTile<TR, M>;
  extern __shared__ float4 bsmem_f4[];
  float* smem = reinterpret_cast<float*>(bsmem_f4);
  const bool is_dc2 = blockIdx.x < pl.blocks2;
  const int64_t z = is_dc2 ? blockIdx.x : blockIdx.x - pl.blocks2;
  const int chunk = static_cast<int>(z % pl.chunks);
  const int64_t t = z / pl.chunks;
  const int tiles_y = is_dc2 ? pl.tiles_y2 : pl.tiles_y1;
  const int x0 = static_cast<int>(t % pl.tiles_x) * pl.tx;
  const int y0 = static_cast<int>(t / pl.tiles_x % tiles_y) * (is_dc2 ? pl.r2 : pl.r1);
  const int b = static_cast<int>(t / pl.tiles_x / tiles_y);
  const int c0 = chunk * 4 * pl.cq;
  if (is_dc2)
    bwd_f32_tile<D, T::R2, T::P, 1>(c1, g, dc2, smem, b, y0, x0, c0, H, W, C, pl, inv_c);
  else
    bwd_f32_tile<D, T::R1, T::P, 0>(c2, g, dc1, smem, b, y0, x0, c0, H, W, C, pl, inv_c);
}

template <int D, int TR, int M>
cudaError_t launch_bwd_f32_tile(const float* c1, const float* c2, const float* g, float* dc1,
                                float* dc2, int B, int H, int W, int C, bool cvec, bool gvec,
                                int sms, cudaStream_t stream) {
  using T = BwdTile<TR, M>;
  auto kernel = cost_volume_bwd_f32<D, TR, M>;
  // the most shared memory a plan of this tile takes (32 pixels x 32
  // channels), opted into once per device
  const int most = 4 * bwd_plan(1, T::R2, BTILE_PX, 4 * BMAX_CQ, D, true, true, 0, T::R1, T::R2,
                                T::P).smem_floats;
  static bool opted[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (!opted[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    if (err != cudaSuccess) return err;
    opted[dev] = true;
  }
  BwdPlan pl = bwd_plan(B, H, W, C, D, dc1 != nullptr, dc2 != nullptr, sms, T::R1, T::R2, T::P);
  pl.cvec = cvec;
  pl.gvec = gvec;
  const int64_t blocks = pl.blocks1 + pl.blocks2;
  if (blocks > INT32_MAX || 4 * pl.smem_floats > most) return cudaErrorInvalidValue;
  kernel<<<static_cast<unsigned>(blocks), pl.threads, 4 * pl.smem_floats, stream>>>(
      c1, c2, g, dc1, dc2, H, W, C, pl, 1.0f / static_cast<float>(C));
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bwd_f32(const void* c1, const void* c2, const void* g, void* dc1, void* dc2,
                           int B, int H, int W, int C, cudaStream_t stream) {
  const int grads = (dc1 ? 1 : 0) + (dc2 ? 1 : 0);
  if (grads == 0) return cudaSuccess;
  static int sms[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (!sms[dev]) {
    err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
  }
  const uintptr_t bits = reinterpret_cast<uintptr_t>(c1) | reinterpret_cast<uintptr_t>(c2) |
                         reinterpret_cast<uintptr_t>(dc1) | reinterpret_cast<uintptr_t>(dc2);
  const bool cvec = C % 4 == 0 && bits % 16 == 0;
  const bool gvec = reinterpret_cast<uintptr_t>(g) % 16 == 0;
  const auto* a = static_cast<const float*>(c1);
  const auto* b = static_cast<const float*>(c2);
  const auto* gf = static_cast<const float*>(g);
  auto* o1 = static_cast<float*>(dc1);
  auto* o2 = static_cast<float*>(dc2);
  switch (bwd_tile_choice(static_cast<int64_t>(B) * H * W * C * grads, sms[dev])) {
    case 0:
      return launch_bwd_f32_tile<D, 2, 2>(a, b, gf, o1, o2, B, H, W, C, cvec, gvec, sms[dev],
                                          stream);
    case 1:
      return launch_bwd_f32_tile<D, 2, 1>(a, b, gf, o1, o2, B, H, W, C, cvec, gvec, sms[dev],
                                          stream);
    case 2:
      return launch_bwd_f32_tile<D, 1, 2>(a, b, gf, o1, o2, B, H, W, C, cvec, gvec, sms[dev],
                                          stream);
    default:
      return launch_bwd_f32_tile<D, 1, 1>(a, b, gf, o1, o2, B, H, W, C, cvec, gvec, sms[dev],
                                          stream);
  }
}

// ---- backward, bf16: banded products on the tensor cores ---------------------

constexpr int QTX = 32;            // pixels of a tile row, at most: 4 n-tiles of 8, one warp each
constexpr int QACC = 16;           // (output row, m-tile) products a thread keeps: rows x m-tiles
constexpr int QMIN_THREADS = 128;  // a block stages with four warps (two were slower at level 5)

// The launch plan of cost_volume_bwd_bf16. A tile is r rows x 8 nt pixels of
// one gradient; its block takes one chunk of C's m-tiles (16 channels each):
// chunk k of n takes m-tiles k mts / n .. (k + 1) mts / n - 1.
struct BwdBf16Plan {
  int r1, r2;              // output rows of dc1's tiles and of dc2's
  int nt;                  // n-tiles of a tile: 8 nt pixels, a computing warp each
  int threads;             // 32 nt, at least QMIN_THREADS
  int tiles_x, tiles_y1, tiles_y2;
  int mts;                 // m-tiles that cover C
  int chunks1, chunks2;    // channel chunks of dc1 and of dc2
  int vec;                 // bf16 a copy of c1/c2 and a store of dc1/dc2: 8, 4 or 1
  int gvec;                // g 16-byte aligned: its runs go in 16-byte copies
  int64_t blocks1, blocks2;
  int smem_bytes;
};

__host__ __device__ inline int round8(int v) { return (v + 7) / 8 * 8; }

// Shared memory of a block of `rows` output rows, nt n-tiles and mt m-tiles,
// in bf16 values: the ring of BSTAGES source rows (8 nt + 8 staged pixels of
// 16 mt + 8 channels; for dc2 each with its g row) and, for dc1, the tile's
// g rows; or, after the loop, the output tile.
inline int bwd_bf16_smem(int d, int nt, int rows, int mt, bool dc2) {
  const int nn = (2 * d + 1) * (2 * d + 1);
  const int tx = 8 * nt, win = tx + 8, s = 16 * mt + 8;
  const int per_row = win * s + (dc2 ? round8(win * nn + 7) : 0);
  const int fixed = dc2 ? 0 : rows * round8(tx * nn + 7);
  return std::max(BSTAGES * per_row + fixed, rows * tx * s);
}

// Tiles: rows of r1 (dc1) or r2 (dc2), columns of 8 nt pixels, nt <= 4 as
// even as W allows. Channels: each gradient starts from the fewest chunks
// whose m-tiles fit a thread's QACC products (rows x m-tiles); both grow by
// one chunk at a time while the launch gives fewer than two blocks an SM.
inline BwdBf16Plan bwd_bf16_plan(int B, int H, int W, int C, int d, bool need1, bool need2,
                                 int sms, int r1, int r2) {
  BwdBf16Plan pl = {};
  pl.r1 = r1;
  pl.r2 = r2;
  pl.tiles_x = (W + QTX - 1) / QTX;
  pl.nt = ((W + 7) / 8 + pl.tiles_x - 1) / pl.tiles_x;
  pl.threads = std::max(32 * pl.nt, QMIN_THREADS);
  pl.tiles_y1 = (H + r1 - 1) / r1;
  pl.tiles_y2 = (H + r2 - 1) / r2;
  const int64_t tiles1 = need1 ? static_cast<int64_t>(B) * pl.tiles_x * pl.tiles_y1 : 0;
  const int64_t tiles2 = need2 ? static_cast<int64_t>(B) * pl.tiles_x * pl.tiles_y2 : 0;
  pl.mts = (C + 15) / 16;
  pl.chunks1 = (pl.mts + QACC / r1 - 1) / (QACC / r1);
  pl.chunks2 = (pl.mts + QACC / r2 - 1) / (QACC / r2);
  while (tiles1 * pl.chunks1 + tiles2 * pl.chunks2 < 2 * sms &&
         (pl.chunks1 < pl.mts || pl.chunks2 < pl.mts)) {
    pl.chunks1 = std::min(pl.mts, pl.chunks1 + 1);
    pl.chunks2 = std::min(pl.mts, pl.chunks2 + 1);
  }
  pl.blocks1 = tiles1 * pl.chunks1;
  pl.blocks2 = tiles2 * pl.chunks2;
  const int mt1 = (pl.mts + pl.chunks1 - 1) / pl.chunks1;
  const int mt2 = (pl.mts + pl.chunks2 - 1) / pl.chunks2;
  pl.smem_bytes = 2 * std::max(need1 ? bwd_bf16_smem(d, pl.nt, r1, mt1, false) : 0,
                               need2 ? bwd_bf16_smem(d, pl.nt, r2, mt2, true) : 0);
  return pl;
}

// The tiles (r1, r2) of a launch: of (8, 8), (2, 4), (1, 1), the one whose
// blocks (QMIN_BLOCKS resident an SM) need the fewest waves times the longest
// chain of source rows a block walks (the rows' steps take about the same
// time whatever the tile); the first of equals. ((4, 8) and (1, 2) were
// never the fastest at a training level, nor chosen.)
constexpr int BF16_TILES[3][2] = {{8, 8}, {2, 4}, {1, 1}};
constexpr int QMIN_BLOCKS = 4;  // blocks an SM: 128 registers a thread, <= 48 KB each

inline int bwd_bf16_tile_choice(int B, int H, int W, int C, int d, bool need1, bool need2,
                                int sms) {
  int best = 0;
  int64_t best_cost = INT64_MAX;
  for (int k = 0; k < 3; ++k) {
    const int r1 = BF16_TILES[k][0], r2 = BF16_TILES[k][1];
    const BwdBf16Plan pl = bwd_bf16_plan(B, H, W, C, d, need1, need2, sms, r1, r2);
    const int64_t slots = static_cast<int64_t>(QMIN_BLOCKS) * sms;
    const int chain = std::min((need2 ? r2 : r1) + 2 * d, H + 2 * d);
    const int64_t cost = (pl.blocks1 + pl.blocks2 + slots - 1) / slots * chain;
    if (cost < best_cost) {
      best = k;
      best_cost = cost;
    }
  }
  return best;
}

__device__ __forceinline__ int mod8(int64_t v) { return static_cast<int>(((v % 8) + 8) % 8); }

// Four 8x8 matrices of 16-bit values, transposed: lanes 8q .. 8q+7 give the
// addresses of matrix q's 8 rows (16 bytes each), and lane 4g+t receives in
// register q the values at column g of rows 2t and 2t+1 (2t in the low half).
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&a)[4], const __nv_bfloat16* p) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(s)
               : "memory");
}

// Copy channels c_lo .. c_lo+kc-1 of the win staged pixels of one source row
// (`base`: the index of staged pixel 0's channel c_lo) into dst [win][s], VEC
// bf16 a copy: zeros outside the frame [q_lo, q_hi) and beyond C. Copies of 16
// and 8 bytes are asynchronous; single values go through registers.
template <int VEC>
__device__ __forceinline__ void bf16_stage_c(const __nv_bfloat16* __restrict__ src,
                                             __nv_bfloat16* dst, int64_t base, int win, int kc,
                                             int s, int c_lo, int C, int q_lo, int q_hi, int tid,
                                             int nthreads) {
  // copy it = px * slots + cu of the row, it = tid, tid + nthreads, ...:
  // (px, cu) advance by (step_px, step_cu) with a carry, no division a copy
  const int slots = kc / VEC;
  const int step_px = nthreads / slots, step_cu = nthreads - step_px * slots;
  int px = tid / slots, cu = tid - px * slots;
  for (; px < win; px += step_px) {
    const int ch = cu * VEC;
    const bool real = px >= q_lo && px < q_hi && c_lo + ch < C;
    const __nv_bfloat16* from = src + (real ? base + int64_t{px} * C + ch : 0);
    if constexpr (VEC == 1)
      dst[px * s + ch] = real ? *from : __nv_bfloat16(0.f);
    else
      cp_async<2 * VEC>(dst + px * s + ch, from, real);
    cu += step_cu;
    if (cu >= slots) {
      cu -= slots;
      ++px;
    }
  }
}

// Copy values first .. first+n-1 of the g run that starts at index e_row into
// shared memory at dst + (e_row mod 8), in the run's order, so that 16-byte
// units of g are 16-byte units there. Where g is 16-byte aligned, whole units
// in asynchronous copies: the up to 7 values on either side of the run that
// share its first and last unit come along (into the row's slack, never
// read; a unit never crosses the end of an allocation). Otherwise the run's
// values one at a time.
__device__ __forceinline__ void bf16_stage_g_run(const __nv_bfloat16* __restrict__ g,
                                                 int64_t e_row, int first, int n,
                                                 __nv_bfloat16* dst, bool gvec, int tid,
                                                 int nthreads) {
  const int64_t e0 = e_row + first;
  dst += mod8(e_row) + first;
  if (gvec) {
    const int sh = mod8(e0);
    const int units = (sh + n + 7) / 8;
    for (int u = tid; u < units; u += nthreads)
      cp_async<16>(dst + 8 * u - sh, g + e0 + 8 * u - sh, true);
  } else {
    for (int e = tid; e < n; e += nthreads) dst[e] = g[e0 + e];
  }
}

// One block's tile of one gradient: R output rows from y0, pixels x0 ..
// x0+8nt-1, m-tiles m_lo .. m_hi-1. WHICH 0: dc1 from the c2 rows y0-D ..
// y0+R-1+D and the tile's own g rows; WHICH 1: dc2 from the c1 and g rows
// y0-D .. y0+R-1+D. Staged pixel q of a source row is image pixel x0-D+q.
// Warp w < nt owns n-tile w (output pixels x0+8w .. x0+8w+7): for each staged
// source row and each output row it touches (dy index i), the product
// D[16 ch x 8 px] += A[16 ch x 16 px] B[16 px x 8 px] with A the row's
// staged pixels 8w .. 8w+15 transposed and B the band of g:
//   dc1: B[k][n] = g[y0+r, x0+8w+n, i, k-n]
//   dc2: B[k][n] = g[sy, x0-D+8w+k, i, n-k+2D],
// zero off the band (dx index outside [0, 2D]) and, for dc2, where staged
// pixel 8w+k lies outside the frame.
template <int D, int R, int MTC, int WHICH>
__device__ __forceinline__ void bwd_bf16_tile(const __nv_bfloat16* __restrict__ src,
                                              const __nv_bfloat16* __restrict__ g,
                                              __nv_bfloat16* __restrict__ dst,
                                              __nv_bfloat16* smem, int b, int y0, int x0,
                                              int m_lo, int m_hi, int H, int W, int C,
                                              const BwdBf16Plan& pl, float inv_c) {
  constexpr int N = 2 * D + 1, NN = N * N;
  static_assert(8 + 2 * D <= 16, "a band column spans 16 staged pixels");
  const int tid = threadIdx.x, nthreads = pl.threads;
  const int warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, t = lane & 3;  // the fragments' group and thread in group
  const int tx = 8 * pl.nt, win = tx + 8;
  // s: bf16 a staged pixel, an odd number of 16-byte units, so the 8 rows of
  // an ldmatrix matrix fall in 8 different bank groups
  const int mtc = m_hi - m_lo, kc = 16 * mtc, s = kc + 8, c_lo = 16 * m_lo;
  const int c_stage = win * s;
  __nv_bfloat16* cring = smem;                    // [BSTAGES][win][s]
  __nv_bfloat16* gs = smem + BSTAGES * c_stage;   // dc1: [R][g_tile_row]; dc2: [BSTAGES][g_row]
  const int g_tile_row = round8(tx * NN + 7), g_row = round8(win * NN + 7);
  const int64_t img = static_cast<int64_t>(b) * H;
  const int q_lo = max(0, D - x0), q_hi = min(win, W - x0 + D);  // staged pixels in the frame
  const bool computes = warp < pl.nt && x0 + 8 * warp < W;  // the other warps only stage

  const int s_lo = max(0, D - y0), s_hi = min(R + 2 * D, H - y0 + D);  // rows in the frame
  auto stage_row = [&](int st, int slot) {  // staged row st: image row y0-D+st
    const int sy = y0 - D + st;
    const int64_t base = ((img + sy) * W + x0 - D) * C + c_lo;
    __nv_bfloat16* cdst = cring + slot * c_stage;
    if (pl.vec == 8)
      bf16_stage_c<8>(src, cdst, base, win, kc, s, c_lo, C, q_lo, q_hi, tid, nthreads);
    else if (pl.vec == 4)
      bf16_stage_c<4>(src, cdst, base, win, kc, s, c_lo, C, q_lo, q_hi, tid, nthreads);
    else
      bf16_stage_c<1>(src, cdst, base, win, kc, s, c_lo, C, q_lo, q_hi, tid, nthreads);
    if constexpr (WHICH == 1) {
      bf16_stage_g_run(g, ((img + sy) * W + x0 - D) * NN, q_lo * NN, (q_hi - q_lo) * NN,
                       gs + slot * g_row, pl.gvec, tid, nthreads);
    } else {
      // dc1: the g rows of the output rows that this source row is the first
      // to reach (row r from source row r, the rows above s_lo with s_lo)
      const int n_px = min(tx, W - x0);
      for (int r = st == s_lo ? 0 : st; r <= st && r < R && y0 + r < H; ++r)
        bf16_stage_g_run(g, ((img + y0 + r) * W + x0) * NN, 0, n_px * NN, gs + r * g_tile_row,
                         pl.gvec, tid, nthreads);
    }
  };

  // the source rows in the frame, one cp.async group each; dc1's g rows
  // (pixels in the frame) come with them
#pragma unroll
  for (int st = 0; st < BSTAGES - 1; ++st) {
    if (s_lo + st < s_hi) stage_row(s_lo + st, st);
    cp_async_commit();
  }

  // The lane's band entries: B registers hold k = 2t + c, c = 0, 1, 8, 9, at
  // n = gq, where the dx index j lies in the band (and, for dc2, staged pixel
  // 8w+k in the frame). Their g values sit at lane_g + c STEP past the row's
  // base (dc1: j = k - gq at output pixel 8w+gq; dc2: j = gq + 2D - k at
  // staged pixel 8w+k, so k NN + j = 2t (NN - 1) + gq + 2D + c (NN - 1))
  constexpr int CS[4] = {0, 1, 8, 9};
  constexpr int STEP = WHICH == 0 ? 1 : NN - 1;
  bool band[4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int k = 2 * t + CS[kk];
    const int j = WHICH == 0 ? k - gq : gq + 2 * D - k;
    band[kk] = j >= 0 && j < N && (WHICH == 0 || (8 * warp + k >= q_lo && 8 * warp + k < q_hi));
  }
  const int lane_g = WHICH == 0 ? (8 * warp + gq) * NN + 2 * t - gq
                                : 8 * warp * NN + 2 * t * (NN - 1) + gq + 2 * D;
  const uint16_t* g16 = reinterpret_cast<const uint16_t*>(gs) + lane_g;
  // A g row's run starts at its own 16-byte phase, which moves by W NN mod 8
  // from one image row to the next. dc1: output row r's values of dy index
  // i = st - r at g16 + r (g_tile_row - N) + phase of row y0+r + st N; dc2:
  // source row st's at g16 + its slot + its phase + (2D - st + r) N for
  // output row r
  const int dphase = static_cast<int>((static_cast<int64_t>(W) * NN) % 8);
  const int phase1 = mod8(((img + y0) * W + x0) * NN);
  int phase = mod8(((img + y0 - D + s_lo) * W + x0 - D) * NN);
  // ldmatrix: lane 8q+rr gives row rr of matrix q: staged pixel 8w + rr +
  // 8 (q >> 1), channels 8 (q & 1) .. +7 of the m-tile, so register q is A's
  // (channels 8 (q & 1) + gq, pixels 8 (q >> 1) + 2t, +1): the mma's A layout
  const int a_off = (8 * warp + (lane & 7) + 8 * (lane >> 4)) * s + 8 * ((lane >> 3) & 1);

  float acc[R][MTC][4];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int mt = 0; mt < MTC; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[r][mt][e] = 0.f;

  for (int st = s_lo; st < s_hi; ++st) {
    cp_async_wait_group<BSTAGES - 2>();
    // row st has landed, and every thread is past row st-1: its slot is free
    __syncthreads();
    const int slot = (st - s_lo) % BSTAGES;
    if (st + BSTAGES - 1 < s_hi)
      stage_row(st + BSTAGES - 1, (st - s_lo + BSTAGES - 1) % BSTAGES);
    cp_async_commit();
    if (computes) {
      // the output rows in the frame that this source row reaches (dy index
      // in [0, 2D] for both gradients): r_lo .. r_hi, the same for the block
      const int r_lo = max(0, st - 2 * D), r_hi = min(min(R, H - y0) - 1, st);
      const uint16_t* gb =
          g16 + (WHICH == 0 ? st * N : slot * g_row + phase + (2 * D - st) * N);
      // B of output row r (zeros where r is not reached)
      auto band_b = [&](int r, uint32_t(&b)[2]) {
        const bool live = r >= r_lo && r <= r_hi;
        const uint16_t* p =
            gb + (WHICH == 0 ? r * (g_tile_row - N) + ((phase1 + r * dphase) & 7) : r * N);
        uint32_t v[4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) v[kk] = live && band[kk] ? p[CS[kk] * STEP] : 0u;
        b[0] = v[0] | (v[1] << 16);
        b[1] = v[2] | (v[3] << 16);
      };
      const __nv_bfloat16* aw = cring + slot * c_stage + a_off;
      // keep whichever operand takes fewer registers for the whole step: A
      // of every m-tile (4 MTC) or B of every row (2 R)
      if constexpr (4 * MTC < 2 * R) {
        uint32_t a[MTC][4];
#pragma unroll
        for (int mt = 0; mt < MTC; ++mt)
          if (mt < mtc) ldmatrix_x4_trans(a[mt], aw + 16 * mt);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          uint32_t b[2];
          band_b(r, b);
          if (r < r_lo || r > r_hi) continue;
#pragma unroll
          for (int mt = 0; mt < MTC; ++mt)
            if (mt < mtc)
              mma_bf16_16816(acc[r][mt], a[mt][0], a[mt][1], a[mt][2], a[mt][3], b[0], b[1]);
        }
      } else {
        uint32_t bq[R][2];
#pragma unroll
        for (int r = 0; r < R; ++r) band_b(r, bq[r]);
#pragma unroll
        for (int mt = 0; mt < MTC; ++mt) {
          if (mt >= mtc) break;
          uint32_t a[4];
          ldmatrix_x4_trans(a, aw + 16 * mt);
#pragma unroll
          for (int r = 0; r < R; ++r)
            if (r >= r_lo && r <= r_hi)
              mma_bf16_16816(acc[r][mt], a[0], a[1], a[2], a[3], bq[r][0], bq[r][1]);
        }
      }
    }
    if constexpr (WHICH == 1) phase = (phase + dphase) & 7;
  }

  // D element e of (row r, m-tile mt): channel 16 mt + gq + 8 (e >> 1),
  // pixel 8w + 2t + (e & 1); scaled by 1/C, cast once, into the output tile
  // [R][tx][s], which then goes out as NHWC runs
  __syncthreads();  // every warp is done with the ring and g
  __nv_bfloat16* outs = smem;
  if (computes) {
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int mt = 0; mt < MTC; ++mt) {
        if (mt >= mtc) break;
        __nv_bfloat16* o = outs + (r * tx + 8 * warp + 2 * t) * s + 16 * mt + gq;
        o[0] = __float2bfloat16(acc[r][mt][0] * inv_c);
        o[s] = __float2bfloat16(acc[r][mt][1] * inv_c);
        o[8] = __float2bfloat16(acc[r][mt][2] * inv_c);
        o[s + 8] = __float2bfloat16(acc[r][mt][3] * inv_c);
      }
  }
  __syncthreads();
  const int vec = pl.vec;
  const int units = min(kc, C - c_lo) / vec;  // whole: C % vec == 0, c_lo % 16 == 0
  const int per_row = min(tx, W - x0) * units;
  for (int u = tid; u < R * per_row; u += nthreads) {
    const int r = u / per_row, px = (u - r * per_row) / units;
    const int ch = (u - r * per_row - px * units) * vec;
    if (y0 + r >= H) break;
    const __nv_bfloat16* from = outs + (r * tx + px) * s + ch;
    __nv_bfloat16* to = dst + ((img + y0 + r) * W + x0 + px) * C + c_lo + ch;
    if (vec == 8)
      *reinterpret_cast<uint4*>(to) = *reinterpret_cast<const uint4*>(from);
    else if (vec == 4)
      *reinterpret_cast<uint2*>(to) = *reinterpret_cast<const uint2*>(from);
    else
      *to = *from;
  }
}

// Grid: one block a (tile, channel chunk) of each gradient asked for, the
// chunk fastest; dc2's blocks first (each of its source rows brings a g row),
// then dc1's; pl.threads threads.
template <int D, int R1, int R2>
__global__ void __launch_bounds__(32 * QTX / 8, QMIN_BLOCKS)
cost_volume_bwd_bf16(const __nv_bfloat16* __restrict__ c1, const __nv_bfloat16* __restrict__ c2,
                     const __nv_bfloat16* __restrict__ g, __nv_bfloat16* __restrict__ dc1,
                     __nv_bfloat16* __restrict__ dc2, int H, int W, int C, BwdBf16Plan pl,
                     float inv_c) {
  extern __shared__ uint4 qsmem_u4[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(qsmem_u4);
  const bool is_dc2 = blockIdx.x < pl.blocks2;
  const int64_t z = is_dc2 ? blockIdx.x : blockIdx.x - pl.blocks2;
  const int chunks = is_dc2 ? pl.chunks2 : pl.chunks1;
  const int chunk = static_cast<int>(z % chunks);
  const int64_t tl = z / chunks;
  const int tiles_y = is_dc2 ? pl.tiles_y2 : pl.tiles_y1;
  const int x0 = static_cast<int>(tl % pl.tiles_x) * 8 * pl.nt;
  const int y0 = static_cast<int>(tl / pl.tiles_x % tiles_y) * (is_dc2 ? R2 : R1);
  const int b = static_cast<int>(tl / pl.tiles_x / tiles_y);
  const int m_lo = chunk * pl.mts / chunks, m_hi = (chunk + 1) * pl.mts / chunks;
  if (is_dc2)
    bwd_bf16_tile<D, R2, QACC / R2, 1>(c1, g, dc2, smem, b, y0, x0, m_lo, m_hi, H, W, C, pl,
                                       inv_c);
  else
    bwd_bf16_tile<D, R1, QACC / R1, 0>(c2, g, dc1, smem, b, y0, x0, m_lo, m_hi, H, W, C, pl,
                                       inv_c);
}

template <int D, int R1, int R2>
cudaError_t launch_bwd_bf16_tile(const __nv_bfloat16* c1, const __nv_bfloat16* c2,
                                 const __nv_bfloat16* g, __nv_bfloat16* dc1, __nv_bfloat16* dc2,
                                 int B, int H, int W, int C, int vec, bool gvec, int sms,
                                 cudaStream_t stream) {
  auto kernel = cost_volume_bwd_bf16<D, R1, R2>;
  // the most shared memory a plan of these tiles takes (4 n-tiles, all of
  // a thread's m-tiles), opted into once per device
  const int most = 2 * std::max(bwd_bf16_smem(D, QTX / 8, R1, QACC / R1, false),
                                bwd_bf16_smem(D, QTX / 8, R2, QACC / R2, true));
  static bool opted[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (!opted[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    if (err != cudaSuccess) return err;
    opted[dev] = true;
  }
  BwdBf16Plan pl = bwd_bf16_plan(B, H, W, C, D, dc1 != nullptr, dc2 != nullptr, sms, R1, R2);
  pl.vec = vec;
  pl.gvec = gvec;
  const int64_t blocks = pl.blocks1 + pl.blocks2;
  if (blocks > INT32_MAX || pl.smem_bytes > most) return cudaErrorInvalidValue;
  kernel<<<static_cast<unsigned>(blocks), pl.threads, pl.smem_bytes, stream>>>(
      c1, c2, g, dc1, dc2, H, W, C, pl, 1.0f / static_cast<float>(C));
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bwd_bf16(const void* c1, const void* c2, const void* g, void* dc1, void* dc2,
                            int B, int H, int W, int C, cudaStream_t stream) {
  if (!dc1 && !dc2) return cudaSuccess;
  static int sms[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (!sms[dev]) {
    err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
  }
  const uintptr_t bits = reinterpret_cast<uintptr_t>(c1) | reinterpret_cast<uintptr_t>(c2) |
                         reinterpret_cast<uintptr_t>(dc1) | reinterpret_cast<uintptr_t>(dc2);
  const int vec = (C % 8 == 0 && bits % 16 == 0) ? 8 : (C % 4 == 0 && bits % 8 == 0) ? 4 : 1;
  const bool gvec = reinterpret_cast<uintptr_t>(g) % 16 == 0;
  const auto* a = static_cast<const __nv_bfloat16*>(c1);
  const auto* b = static_cast<const __nv_bfloat16*>(c2);
  const auto* gb = static_cast<const __nv_bfloat16*>(g);
  auto* o1 = static_cast<__nv_bfloat16*>(dc1);
  auto* o2 = static_cast<__nv_bfloat16*>(dc2);
  switch (bwd_bf16_tile_choice(B, H, W, C, D, dc1 != nullptr, dc2 != nullptr, sms[dev])) {
    case 0:
      return launch_bwd_bf16_tile<D, 8, 8>(a, b, gb, o1, o2, B, H, W, C, vec, gvec, sms[dev],
                                           stream);
    case 1:
      return launch_bwd_bf16_tile<D, 2, 4>(a, b, gb, o1, o2, B, H, W, C, vec, gvec, sms[dev],
                                           stream);
    default:
      return launch_bwd_bf16_tile<D, 1, 1>(a, b, gb, o1, o2, B, H, W, C, vec, gvec, sms[dev],
                                           stream);
  }
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

// The gradients of fisr_cost_volume for the output gradient g [B, H, W,
// (2d+1)^2], contiguous, of the inputs' type: dc1 and dc2 [B, H, W, C]. A null
// dc1 or dc2 is not computed. dtype and search_range as for fisr_cost_volume.
extern "C" int fisr_cost_volume_backward(const void* c1, const void* c2, const void* g,
                                         void* dc1, void* dc2, int B, int H, int W, int C,
                                         int search_range, int dtype, void* stream) {
  if (B < 1 || H < 1 || W < 1 || C < 1 || H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && search_range == 4) return launch_bwd_f32<4>(c1, c2, g, dc1, dc2, B, H, W, C, s);
  if (dtype == 0 && search_range == 2) return launch_bwd_f32<2>(c1, c2, g, dc1, dc2, B, H, W, C, s);
  if (dtype == 1 && search_range == 4)
    return launch_bwd_bf16<4>(c1, c2, g, dc1, dc2, B, H, W, C, s);
  if (dtype == 1 && search_range == 2)
    return launch_bwd_bf16<2>(c1, c2, g, dc1, dc2, B, H, W, C, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* fisr_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
