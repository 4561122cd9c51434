// Shared main loop of the two banded polyphase kernels (polyphase_banded.cu,
// polyphase_fused16.cu), for sm_90a:
//
//   out[m, 128 i + j] = sum_k x[m, starts[i] + k] * Wt[i, k, j]
//
// One block of 8 warps computes a BM x BN = 128 x 128 block of outputs for
// weight tile i (blockIdx.y) and rows m0 = 128 * blockIdx.x; warp w owns rows
// 16 w .. 16 w + 15 and all 128 columns, so every warp has the same work in
// every stage (warps that split the columns instead idle in turn along the
// band's diagonal: 53 % of the tensor pipe's time was used that way).
//
// Band skipping. Only a band of each column's K weights is nonzero (about 205
// of K = 768 at the main shape). band_ranges.cu writes, per tile and column
// group of GROUP = 32 columns, the first and last K-row holding a nonzero
// weight (as partials over BAND_ROWS-row pieces, reduced here). The block
// stages the slab only over the union of its groups' ranges, copies weight
// rows and runs mma only for the (8-row step, group) pairs that meet the
// group's range. Products whose weight is exactly +-0 are what is skipped, so
// every sum is unchanged; the one difference is that a NaN or Inf in x at a
// zero-weight position no longer reaches the output (no PCM input holds one).
//
// Tensor cores, 3xTF32: mma.sync.m16n8k8 TF32 with both operands split in
// registers after the shared-memory load, big = rna_tf32(a), small =
// rna_tf32(a - big). Each 8-row step of a group sums small*big + big*small +
// big*big (small terms first) from zero in the tensor core and adds that
// fragment to the accumulator with FADD (round to nearest): the tensor core's
// own adds truncate, and letting it carry the running sum measured 3.05 times
// the banded tolerance on random operands at the main shape, against 0.32
// this way (H100, against an f64 sum). One-pass TF32 would break the 1-LSB
// output contract and is not used. An int16 sample's split is exact.
// mma.sync and not wgmma: band skipping is per warp-uniform (step, group)
// pair, the splits happen in registers, and Wt's N-major tile needs no
// transposed shared copy (TF32 wgmma reads B K-major from shared memory
// only). On the H100 (tools/kernel_variants.py) an m16n8k8 TF32 mma.sync
// costs about 5.3 ns of an SM sub-partition (10.5 cycles at 1980 MHz): the
// three passes take about half of the main loop's time, the operand splits
// and flushes most of the rest; the copies alone take less than either.
//
// Pipeline. A ring of STAGES = 3 shared-memory stages, each holding a
// BK = 32-row piece of the slab (128 rows x (BK + one 16-byte chunk), f32 or
// int16) and of the weight tile (BK x 128 f32), filled with 16-byte cp.async
// copies whose completion arrives on one mbarrier per stage
// (cp.async.mbarrier.arrive.noinc): two pieces are in flight while the block
// computes on the third, and two blocks fit on an SM (MIN_BLOCKS), so one
// block's loads and barriers overlap the other's mma. The slab start is
// unaligned, so each row is staged from the 16-byte chunk that holds
// start + k0 and the fragments read it at a shift; this needs a row pitch
// L * itemsize that is a multiple of 16 bytes and 16-byte aligned bases (the
// wrappers check both). cp.async's zero fill covers rows past M, slab columns
// outside [0, L) and weight rows past K. Shared pitches (36 f32 / 40 int16
// slab columns, 136 weight columns) keep the fragment reads free of bank
// conflicts.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace eal {

constexpr int BM = 128;        // rows of the output block
constexpr int BN = 128;        // columns: one weight tile
constexpr int BK = 32;         // K rows per pipeline stage
constexpr int STAGES = 3;
constexpr int MIN_BLOCKS = 2;  // blocks per SM (__launch_bounds__); the ring fits twice
constexpr int THREADS = 256;   // 8 warps of 16 rows x 128 columns
constexpr int GROUP = 32;      // columns of one band range: four n8 mma fragments
constexpr int NGROUPS = BN / GROUP;
constexpr int BAND_ROWS = 64;  // K rows per band-range partial
constexpr int B_PITCH = BN + 8;
constexpr int C_PITCH = BN + 8;

// Launches band_ranges.cu's kernel: parts int32 [ntw, ceil(K / BAND_ROWS),
// NGROUPS, 2] (first, last nonzero K-row of each piece; K, -1 when empty).
void launch_band_ranges(const float* wt, long long wt_tile_stride, int ntw, int K, int* parts,
                        cudaStream_t stream);

inline int band_parts(int K) { return (K + BAND_ROWS - 1) / BAND_ROWS; }

template <typename Tin>
struct Ring {
  static constexpr int VEC = 16 / sizeof(Tin);          // elements per 16-byte chunk
  static constexpr int COLS = BK + VEC;                  // staged slab columns = pitch
  static constexpr int CHUNKS = COLS / VEC;
  static constexpr int A_BYTES = BM * COLS * sizeof(Tin);
  static constexpr int B_BYTES = BK * B_PITCH * 4;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int SMEM_BYTES = STAGES * STAGE_BYTES;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
// Exact for |v| < 2^22 in two full-rate instructions (an I2F is quarter rate):
// 1.5 * 2^23 + v holds v in its low mantissa bits.
__device__ __forceinline__ float to_f32(int16_t v) {
  return __int_as_float(0x4B400000 + v) - 12582912.0f;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte copy, zero-filled when !valid (src is then not read).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}

// Arrives on bar once this thread's earlier cp.async copies have landed.
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" :: "r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" :: "r"(bar), "r"(parity) : "memory");
}

// cvt.rna.tf32.f32 on the bits (round the magnitude to 10 mantissa bits,
// ties away from zero) in two integer instructions; the cvt itself compiles
// to four on sm_90. Finite values, infinities and the usual NaNs come out as
// the cvt gives them; a NaN whose low 13 bits carry out may come out as
// another NaN or as -0.0, and then the small half stays NaN.
__device__ __forceinline__ uint32_t tf32_rna(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xFFFFE000u;
}

__device__ __forceinline__ void split_tf32(float v, uint32_t& big, uint32_t& small) {
  big = tf32_rna(v);
  small = tf32_rna(v - __uint_as_float(big));
}

// d += a (16 x 8, row) * b (8 x 8, col), TF32 in, f32 out.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The accumulator of one warp: 16 m16n8 fragments over its 16 x 128 outputs.
// acc[j][e] is block row 16 * warp + g + 8 * (e / 2) and block column
// 8 * j + 2 * t + e % 2, with g = lane / 4, t = lane % 4; column group
// j / 4.
using Acc = float[16][4];

// Calls f(row, col, v0, v1) for each pair of adjacent outputs (row, col),
// (row, col + 1) of the block that this thread holds.
template <typename F>
__device__ __forceinline__ void for_each_pair(const Acc& acc, F&& f) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      f(16 * warp + g + 8 * h, 8 * j + 2 * t, acc[j][2 * h], acc[j][2 * h + 1]);
}

// Computes the block's outputs into acc. `parts` points at this tile's band
// partials; `smem` is the dynamic shared memory, Ring<Tin>::SMEM_BYTES long.
// Leaves no copy in flight; the caller synchronises before reusing smem.
template <typename Tin>
__device__ __forceinline__ void banded_tile(const Tin* __restrict__ x, const float* __restrict__ wt,
                                            const int* __restrict__ parts, int nparts, int start,
                                            int M, int L, int K, int m0, unsigned char* smem,
                                            Acc& acc) {
  using R = Ring<Tin>;
  __shared__ uint64_t full[STAGES];
  __shared__ int range[NGROUPS][2];
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;

  if (tid < NGROUPS) {
    int lo = K, hi = -1;
    for (int p = 0; p < nparts; ++p) {
      lo = min(lo, parts[(p * NGROUPS + tid) * 2]);
      hi = max(hi, parts[(p * NGROUPS + tid) * 2 + 1]);
    }
    range[tid][0] = lo;
    range[tid][1] = hi;
  }
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) mbar_init(smem_u32(&full[s]), THREADS);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
  __syncthreads();

  int lo[NGROUPS], hi[NGROUPS];
  int kb = K, ke = -1;
#pragma unroll
  for (int q = 0; q < NGROUPS; ++q) {
    lo[q] = range[q][0];
    hi[q] = range[q][1];
    kb = min(kb, lo[q]);
    ke = max(ke, hi[q]);
  }
  if (kb > ke) return;                       // an empty block: all zeros
  // does the 8-row step at ka meet group q's band? (block-uniform)
  auto meets = [&](int q, int ka) { return ka <= hi[q] && ka + 7 >= lo[q]; };
  const int kbase = (kb / BK) * BK;
  const int nsteps = (ke - kbase) / BK + 1;
  // the weight chunk this thread copies in each 8-row step: row (tid / 8) % 8,
  // 16-byte chunk tid % 8 of group (tid / 64) % 4
  const int cq = (tid / 64) % NGROUPS, crow = (tid / 8) % 8;
  const int ccol = cq * GROUP + (tid % 8) * 4;
  const int cq_lo = range[cq][0], cq_hi = range[cq][1];

  auto load = [&](int step) {
    const int s = step % STAGES;
    unsigned char* base = smem + s * R::STAGE_BYTES;
    const int k0 = kbase + step * BK;
    const int c0 = (start + k0) & ~(R::VEC - 1);
    Tin* As = reinterpret_cast<Tin*>(base);
    for (int idx = tid; idx < BM * R::CHUNKS; idx += THREADS) {
      const int r = idx / R::CHUNKS, ch = idx % R::CHUNKS;
      const int m = m0 + r;
      const int c = c0 + ch * R::VEC;
      const bool ok = m < M && c >= 0 && c + R::VEC <= L;
      cp_async16(smem_u32(As + r * R::COLS + ch * R::VEC), ok ? x + (size_t)m * L + c : x, ok);
    }
    // weight rows only for the (8-row step, group) pairs the compute reads
    float* Bs = reinterpret_cast<float*>(base + R::A_BYTES);
#pragma unroll
    for (int sub = 0; sub < BK / 8; ++sub) {
      const int ka = k0 + 8 * sub;
      if (ka > cq_hi || ka + 7 < cq_lo) continue;
      const int k = ka + crow;
      cp_async16(smem_u32(Bs + (8 * sub + crow) * B_PITCH + ccol),
                 k < K ? wt + (size_t)k * BN + ccol : wt, k < K);
    }
    cp_async_arrive(smem_u32(&full[s]));
  };

  for (int p = 0; p < STAGES - 1 && p < nsteps; ++p) load(p);

  for (int j = 0; j < nsteps; ++j) {
    const int s = j % STAGES;
    mbar_wait(smem_u32(&full[s]), (j / STAGES) & 1);
    __syncthreads();                         // every warp is done with stage (j - 1) % STAGES
    if (j + STAGES - 1 < nsteps) load(j + STAGES - 1);

    const unsigned char* base = smem + s * R::STAGE_BYTES;
    const Tin* As = reinterpret_cast<const Tin*>(base);
    const float* Bs = reinterpret_cast<const float*>(base + R::A_BYTES);
    const int k0 = kbase + j * BK;
    const int sh = (start + k0) & (R::VEC - 1);
#pragma unroll
    for (int sub = 0; sub < BK / 8; ++sub) {
      const int ka = k0 + 8 * sub;
      if (ka > ke || ka + 7 < kb) continue;
      uint32_t ab[4], as[4];
      const Tin* ap = As + (16 * warp + g) * R::COLS + sh + 8 * sub + t;
      split_tf32(to_f32(ap[0]), ab[0], as[0]);
      split_tf32(to_f32(ap[8 * R::COLS]), ab[1], as[1]);
      split_tf32(to_f32(ap[4]), ab[2], as[2]);
      split_tf32(to_f32(ap[8 * R::COLS + 4]), ab[3], as[3]);
#pragma unroll
      for (int q = 0; q < NGROUPS; ++q) {
        if (!meets(q, ka)) continue;
        uint32_t bb[4][2], bs[4][2];
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          const float* bp = Bs + (8 * sub + t) * B_PITCH + q * GROUP + ni * 8 + g;
          split_tf32(bp[0], bb[ni][0], bs[ni][0]);
          split_tf32(bp[4 * B_PITCH], bb[ni][1], bs[ni][1]);
        }
        // pass by pass, so that the three dependent mma of a fragment
        // stand four issues apart
        float d[4][4];
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
          for (int e = 0; e < 4; ++e) d[ni][e] = 0.0f;
          mma_tf32(d[ni], as, bb[ni]);
        }
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_tf32(d[ni], ab, bs[ni]);
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_tf32(d[ni], ab, bb[ni]);
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[4 * q + ni][e] = __fadd_rn(acc[4 * q + ni][e], d[ni][e]);
      }
    }
  }
}

}  // namespace eal
