// The two kernels of one granule step of the MXU tier for sm_90a, around
// its two FP32 GEMMs.
//
// Replace the lax.scan step of _granules_scan_mxu_for and its body
// _granule_body_mxu (esp_audio_libs_tpu/models/mp3_pipeline.py:174, :315)
// except the parts that carry no state, which ops/mp3mxu.py::mxu_run does
// once per run (the dequantizer and the x-side product x @ AX), and the two
// phase-indexed products [of | vc] @ S[v] and of @ W[v], which it leaves to
// torch.matmul in FP32 (JAX computes them outside any Pallas kernel, at
// HIGHEST precision). Per granule:
//
//   eal_mp3_mxu_pre: the carried half of imdct_granule_mxu (ops/mp3mxu.py
//     imdct_tail): the overlap product over @ PX (9 -> 18 for the block's
//     previous window), the window selects, the long / short /
//     previous-only masks, FreqInvert, the new overlap, the previous block
//     type, window switch and block count (n_blocks_out: a warp maximum over
//     the 32 blocks); it writes the GEMMs' left operand [of | vc]: the
//     IMDCT output in the S operator's order (column t * 32 + block), then
//     the channel's block of the FIFO (column 576 + row * 32 + slot). One
//     warp per (stream, channel), lane = block.
//   eal_mp3_mxu_post: the tail of subband_granule_mxu: the written FIFO
//     slots (of @ W[v]) merged into the interleaved [34, 64] FIFO where
//     keep[v] is 0, and the accumulators ([of | vc] @ S[v], PCM units)
//     quantized, floor(acc + 0.5) clipped to int16, channels interleaved.
//
// What bounds them: bytes. pre reads the granule's x-side products (108
// floats a block) and writes the 1664-float GEMM row of each stream and
// channel; post reads the GEMMs' 1664 outputs a row and the FIFO and
// writes it back and the PCM. Both are simple, one pass, no shared memory;
// the GEMMs take most of a step's arithmetic (2 * 1664 * 576 + 2 * 576 *
// 1088 flop a row). Sums run in the plain version's order; nvcc may contract
// a product and a sum into one FMA, so they are held to the plain versions
// by tolerance, not bit for bit.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int NB = 32;                   // subband blocks
constexpr int AX_COLS = 4 * 18 + 18 + 9 + 9;   // A36 x 4 windows | A12 | C36 | C12
constexpr int N_OUT = 576;
constexpr int N_V = 34 * 32;             // one channel's FIFO block
constexpr int ROW = N_OUT + N_V;         // one GEMM row
constexpr int PRE_ROWS = 4;              // (stream, channel) rows per block of eal_mp3_mxu_pre
constexpr int POST_THREADS = 256;
constexpr unsigned FULL = 0xffffffffu;

// the four-way select of a window type: 0, 1, 2, else 3 (ops/mp3fast.py _sel4_index)
__device__ __forceinline__ int sel4(int bt) { return (bt >= 0 && bt <= 2) ? bt : 3; }

struct PreArgs {
  const float* yx;       // [B nch, 32, 108]
  const int32_t* ip;     // [B nch, 5]: n_blocks_long, n_blocks_total, curr_win_switch,
                         //   block_type, mixed
  float* over;           // [B, 2, 288]
  int32_t* prev_type;    // [B, 2]
  int32_t* prev_ws;      // [B, 2]
  int32_t* num_prev;     // [B, 2]
  const float* vbuf;     // [B, 2176]
  const float* px;       // [9, 72]
  float* ofvc;           // [B nch, 1664]
  int B, nch;
};

__global__ void __launch_bounds__(32 * PRE_ROWS) mp3_mxu_pre_kernel(PreArgs a) {
  const int row = blockIdx.x * PRE_ROWS + static_cast<int>(threadIdx.x >> 5);
  const int blk = threadIdx.x & 31;
  if (row >= a.B * a.nch) return;        // whole warps: the warp maximum below is full
  const int b = row / a.nch, ch = row % a.nch;
  const int32_t* ip = a.ip + 5 * row;
  const int nbl = ip[0], nbt = ip[1], cws = ip[2], bt = ip[3], mixed = ip[4];
  const int pt = a.prev_type[2 * b + ch], pws = a.prev_ws[2 * b + ch];
  const int npv = a.num_prev[2 * b + ch];
  const int m_lim = max(nbl, nbt);
  const bool in_long = blk < nbl;
  const bool in_short = !in_long && blk < nbt;
  const bool in_prev = !in_long && !in_short && blk >= m_lim && blk < npv;
  const int curr_win = (mixed == 1 && blk < cws) ? 0 : bt;
  const int prev_win = blk < pws ? 0 : pt;

  float* over = a.over + (size_t)b * 576 + ch * 288 + 9 * blk;
  float xp[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) xp[k] = over[k];
  // ypo = xp @ PX[:, 18 prev_win : +18], the sum over the 9 inputs in order
  const float* px = a.px + 18 * sel4(prev_win);
  float ypo[18];
  bool po_nonzero = false;
#pragma unroll
  for (int j = 0; j < 18; ++j) {
    float t = 0.0f;
#pragma unroll
    for (int i = 0; i < 9; ++i) t += xp[i] * px[72 * i + j];
    ypo[j] = t;
    po_nonzero = po_nonzero || t != 0.0f;
  }
  const float* yx = a.yx + ((size_t)row * NB + blk) * AX_COLS;
  const float* y36 = yx + 18 * sel4(curr_win);
  float* of = a.ofvc + (size_t)row * ROW;
  const bool flip = (blk & 1) != 0;
#pragma unroll
  for (int t = 0; t < 18; ++t) {
    const float y0 = in_long ? y36[t] : (in_short ? yx[72 + t] : 0.0f);
    float y = y0 + ((in_long || in_short || in_prev) ? ypo[t] : 0.0f);
    if (flip && (t & 1)) y = -y;           // FreqInvert (operators probed at an even band)
    of[t * NB + blk] = y;
  }
#pragma unroll
  for (int k = 0; k < 9; ++k)
    over[k] = in_long ? yx[90 + k] : (in_short ? yx[99 + k] : (in_prev ? 0.0f : xp[k]));
  const int ext = __reduce_max_sync(FULL, (in_prev && po_nonzero) ? blk : -1);
  if (blk == 0) {
    a.prev_type[2 * b + ch] = bt;
    a.prev_ws[2 * b + ch] = cws;
    a.num_prev[2 * b + ch] = max(m_lim, ext);
  }
  // the channel's FIFO block, row-major [34, 32], lane = slot
  const float* vb = a.vbuf + (size_t)b * 2176 + 32 * ch + blk;
  float* vc = of + N_OUT + blk;
#pragma unroll 2
  for (int r = 0; r < 34; ++r) vc[32 * r] = vb[64 * r];
}

struct PostArgs {
  const float* acc;      // [B nch, 576]
  const float* newv;     // [B nch, 1088]
  float* vbuf;           // [B, 2176]
  const float* keep;     // [1088]
  int16_t* pcm;          // [B, pitch]: 576 nch samples a row
  long long pitch;
  int B, nch;
};

// one block per (stream, channel)
__global__ void __launch_bounds__(POST_THREADS) mp3_mxu_post_kernel(PostArgs a) {
  const int row = blockIdx.x;
  const int b = row / a.nch, ch = row % a.nch;
  const float* nv = a.newv + (size_t)row * N_V;
  float* vb = a.vbuf + (size_t)b * 2176 + 32 * ch;
  for (int e = threadIdx.x; e < N_V; e += POST_THREADS)
    if (a.keep[e] != 1.0f) vb[64 * (e >> 5) + (e & 31)] = nv[e];
  const float* acc = a.acc + (size_t)row * N_OUT;
  int16_t* out = a.pcm + (size_t)b * a.pitch;
  for (int e = threadIdx.x; e < N_OUT; e += POST_THREADS) {
    const float q = fminf(fmaxf(floorf(acc[e] + 0.5f), -32768.0f), 32767.0f);
    const int t = e >> 5, i = e & 31;
    out[t * 32 * a.nch + i * a.nch + ch] = static_cast<int16_t>(q);
  }
}

}  // namespace

extern "C" int eal_mp3_mxu_pre(const void* yx, const void* ip, void* over, void* prev_type,
                               void* prev_ws, void* num_prev, const void* vbuf, const void* px,
                               void* ofvc, int B, int nch, void* stream) {
  if (B < 1 || (nch != 1 && nch != 2)) return static_cast<int>(cudaErrorInvalidValue);
  PreArgs a;
  a.yx = static_cast<const float*>(yx);
  a.ip = static_cast<const int32_t*>(ip);
  a.over = static_cast<float*>(over);
  a.prev_type = static_cast<int32_t*>(prev_type);
  a.prev_ws = static_cast<int32_t*>(prev_ws);
  a.num_prev = static_cast<int32_t*>(num_prev);
  a.vbuf = static_cast<const float*>(vbuf);
  a.px = static_cast<const float*>(px);
  a.ofvc = static_cast<float*>(ofvc);
  a.B = B;
  a.nch = nch;
  const int blocks = (B * nch + PRE_ROWS - 1) / PRE_ROWS;
  mp3_mxu_pre_kernel<<<blocks, 32 * PRE_ROWS, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int eal_mp3_mxu_post(const void* acc, const void* newv, void* vbuf, const void* keep,
                                void* pcm, long long pitch, int B, int nch, void* stream) {
  if (B < 1 || (nch != 1 && nch != 2) || pitch < 576LL * nch)
    return static_cast<int>(cudaErrorInvalidValue);
  PostArgs a;
  a.acc = static_cast<const float*>(acc);
  a.newv = static_cast<const float*>(newv);
  a.vbuf = static_cast<float*>(vbuf);
  a.keep = static_cast<const float*>(keep);
  a.pcm = static_cast<int16_t*>(pcm);
  a.pitch = pitch;
  a.B = B;
  a.nch = nch;
  mp3_mxu_post_kernel<<<B * nch, POST_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
