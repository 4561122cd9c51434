// Exact polyphase kernel for sm_90a: the resampler's bit-exact contraction,
// ordered dot products per output, bit-exact against the JAX package.
//
// Replaces the per-tap lax.scan of polyphase_apply(exact=True)
// (esp_audio_libs_tpu/ops/polyphase.py:236-260). There it is XLA, not
// Pallas: taps passes over the whole [rows, T] output, each a gather and a
// multiply-add. In one pass this kernel gathers the windows, computes both
// ordered dots, the lerp and the mode select:
//   acc1 = ((+0 + x[w0]*f1[0]) + x[w0+1]*f1[1]) + ...   (k = 0 .. taps-1)
//   acc2 likewise with f2 (only with compute_second)
//   mode 0: x[w0 + half - 1] (a copy); mode 1: acc1;
//   otherwise: acc2*w + acc1*(1 - w) with (1 - w) rounded first
//   (acc1 when compute_second is off).
// Every product and sum is its own mul.rn / add.rn instruction (never
// contracted into an FMA), in the C reference's order; the .ftz forms flush
// subnormal operands and results to a zero of their own sign, the JAX
// package's rule (ops/scan.py).
//
// What bounds it: at the resampler's main shape (4096 rows, about 2980
// outputs, 64 taps, two dots) it does 4 separately rounded FP32 ops per tap
// and output (about 3.1 G), about 0.05 ms at the card's 67 TFLOP/s FP32
// peak, beside about 0.055 ms of bytes (x once, outputs once); an FMA-free
// loop can issue at most half that FP32 peak. Neighbouring outputs' windows
// overlap (64 taps at a step of about 2.76 samples), so the design reuses
// each input from shared memory:
// - A block is TT = 128 threads, one per output of a tile of 128
//   consecutive outputs, over R = 8 rows. Each thread keeps its 2 x R
//   accumulators in registers and walks k in order. Per tap and warp that
//   is 8 shared loads (1 KB) beside 32 FP32 instructions, so shared-memory
//   bandwidth and the FP32 pipes each need about 8 cycles: the kernel's
//   floor, about 0.12 ms at the main shape.
// - The rows' input span of the tile is staged in shared memory (up to cap
//   samples per row); the dots read their windows from there. A tile whose
//   windows span more than cap (very low ratios) takes several passes, each
//   staging from the lowest window still to do; every window fits one pass
//   because cap >= taps + 448.
// - The filterbank is staged in shared memory with a padded row pitch
//   (taps + 1: threads on different rows hit different banks) when it fits
//   in 64 KB (33 x 64 at the main shape); larger banks are read through the
//   cache.
// - Mode-0 outputs take no dot. Windows outside [0, L) read NaN, as the JAX
//   package's jnp.take fills them.

#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

namespace {

constexpr int TT = 128;              // outputs per block, one thread each
constexpr int R = 8;                 // rows per block
constexpr int SLACK = 448;           // cap = taps + SLACK samples per staged row
constexpr int BANK_SMEM_MAX = 64 * 1024;

__device__ __forceinline__ float mul_ftz(float a, float b) {
  float r;
  asm("mul.rn.ftz.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float add_ftz(float a, float b) {
  float r;
  asm("add.rn.ftz.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float sub_ftz(float a, float b) {
  float r;
  asm("sub.rn.ftz.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

struct PolyArgs {
  const float* x;          // [M, L] history + chunk
  const float* filters;    // [nf, taps]
  const int32_t* win0;     // [T] window starts in x coordinates
  const int32_t* idx1;     // [T] filterbank rows
  const int32_t* idx2;     // [T]
  const float* weight;     // [T] lerp weights
  const int32_t* mode;     // [T] 0 copy, 1 one dot, else lerp
  float* out;              // [M, T]
  long long M;
  int L, T, nf, taps, half, cap;
  bool bank_smem;
};

__device__ __forceinline__ float x_at(const PolyArgs& a, long long m, long long col) {
  return (col >= 0 && col < a.L) ? a.x[m * a.L + col] : NAN;
}

template <bool SECOND>
__global__ void __launch_bounds__(TT) polyphase_exact_kernel(PolyArgs a) {
  extern __shared__ float smem[];
  float* xs = smem;                          // [R][cap]
  float* fs = smem + R * a.cap;              // [nf][taps + 1] when bank_smem
  __shared__ int s_base, s_hi;
  const int tid = threadIdx.x;
  const int t = blockIdx.x * TT + tid;
  const long long m0 = static_cast<long long>(blockIdx.y) * R;

  const float* fb = a.filters;
  int fpitch = a.taps;
  if (a.bank_smem) {
    for (int i = tid; i < a.nf * a.taps; i += TT) {
      const int r = i / a.taps;
      fs[r * (a.taps + 1) + (i - r * a.taps)] = a.filters[i];
    }
    fb = fs;
    fpitch = a.taps + 1;
  }

  int w0 = 0, i1 = 0, i2 = 0, md = 0;
  float w = 0.f;
  if (t < a.T) {
    w0 = a.win0[t];
    i1 = a.idx1[t];
    i2 = a.idx2[t];
    md = a.mode[t];
    w = a.weight[t];
  }
  bool pending = t < a.T && md != 0;
  float acc1[R], acc2[R];
#pragma unroll
  for (int r = 0; r < R; ++r) acc1[r] = acc2[r] = 0.0f;

  while (true) {
    if (tid == 0) {
      s_base = INT_MAX;
      s_hi = INT_MIN;
    }
    __syncthreads();                 // (the first time: the filterbank is staged too)
    if (pending) atomicMin(&s_base, w0);
    __syncthreads();
    const int base = s_base;
    if (base == INT_MAX) break;      // uniform: every thread read the same base
    const bool fits = pending && static_cast<long long>(w0) + a.taps <=
                                     static_cast<long long>(base) + a.cap;
    if (fits) atomicMax(&s_hi, w0 + a.taps);
    __syncthreads();
    const int span = s_hi - base;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const long long m = m0 + r;
      for (int c = tid; c < span; c += TT)
        xs[r * a.cap + c] = m < a.M ? x_at(a, m, static_cast<long long>(base) + c) : 0.0f;
    }
    __syncthreads();
    if (fits) {
      const float* f1 = fb + static_cast<long long>(i1) * fpitch;
      const float* f2 = fb + static_cast<long long>(i2) * fpitch;
      const float* xw = xs + (w0 - base);
#pragma unroll 2
      for (int k = 0; k < a.taps; ++k) {
        const float c1 = f1[k];
        const float c2 = SECOND ? f2[k] : 0.0f;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float xv = xw[r * a.cap + k];
          acc1[r] = add_ftz(acc1[r], mul_ftz(xv, c1));
          if (SECOND) acc2[r] = add_ftz(acc2[r], mul_ftz(xv, c2));
        }
      }
      pending = false;
    }
    __syncthreads();                 // xs and s_base are free again
  }

  if (t >= a.T) return;
  const float omw = sub_ftz(1.0f, w);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const long long m = m0 + r;
    if (m >= a.M) break;
    float v;
    if (md == 0)
      v = x_at(a, m, static_cast<long long>(w0) + a.half - 1);
    else if (md == 1 || !SECOND)
      v = acc1[r];
    else
      v = add_ftz(mul_ftz(acc2[r], w), mul_ftz(acc1[r], omw));
    a.out[m * a.T + t] = v;
  }
}

template <bool SECOND>
cudaError_t launch(const PolyArgs& a, cudaStream_t stream) {
  const size_t bytes = sizeof(float) * (static_cast<size_t>(R) * a.cap +
                                        (a.bank_smem ? static_cast<size_t>(a.nf) * (a.taps + 1) : 0));
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        polyphase_exact_kernel<SECOND>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((a.T + TT - 1) / TT, static_cast<unsigned>((a.M + R - 1) / R));
  polyphase_exact_kernel<SECOND><<<grid, TT, bytes, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// x f32 [M, L]; filters f32 [nf, taps]; win0, idx1, idx2, mode int32 [T];
// weight f32 [T]; out f32 [M, T]. Launches on `stream` and returns
// cudaGetLastError() (cudaErrorInvalidValue for arguments it does not take).
extern "C" int eal_polyphase_exact(const void* x, const void* filters, const void* win0,
                                   const void* idx1, const void* idx2, const void* weight,
                                   const void* mode, void* out, long long M, int L, int T, int nf,
                                   int taps, int half, int compute_second, void* stream) {
  if (M < 1 || L < 1 || T < 1 || nf < 1 || taps < 1 || taps > 4096 ||
      (M + R - 1) / R > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  PolyArgs a;
  a.x = static_cast<const float*>(x);
  a.filters = static_cast<const float*>(filters);
  a.win0 = static_cast<const int32_t*>(win0);
  a.idx1 = static_cast<const int32_t*>(idx1);
  a.idx2 = static_cast<const int32_t*>(idx2);
  a.weight = static_cast<const float*>(weight);
  a.mode = static_cast<const int32_t*>(mode);
  a.out = static_cast<float*>(out);
  a.M = M;
  a.L = L;
  a.T = T;
  a.nf = nf;
  a.taps = taps;
  a.half = half;
  a.cap = (taps + SLACK + 31) / 32 * 32;
  a.bank_smem = static_cast<long long>(nf) * (taps + 1) * 4 <= BANK_SMEM_MAX;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(compute_second ? launch<true>(a, s) : launch<false>(a, s));
}
