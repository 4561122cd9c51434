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
//     the channel's block of the FIFO (column 576 + row * 32 + slot).
//   eal_mp3_mxu_post: the tail of subband_granule_mxu: the written FIFO
//     slots (of @ W[v]) merged into the interleaved [34, 64] FIFO where
//     keep[v] is not 1, and the accumulators ([of | vc] @ S[v], PCM units)
//     quantized, floor(acc + 0.5) clipped to int16, channels interleaved.
//
// pre runs one block of 288 threads per (stream, channel) row, every access
// coalesced: the row's overlap (288 contiguous floats) in 16-byte loads, PX,
// and of each long or short block only the 27 x-side floats it reads (its
// window's 18 outputs, its 9 new overlap values), threads laid out over
// (block, column), all into shared memory; the FIFO block copied into the
// GEMM row as float4s by all the threads; then a thread per two outputs
// (t, block), stored at t * 32 + block, and per new overlap value. The
// first design (a warp per row, lane = block, four rows a block) read the
// x-side products 108 floats apart and copied the FIFO 34 rows a lane: 0.0123
// ms at B = 256 on an H100, half of it that copy (tools/kernel_variants.py
// --mxu-pre, PERF.md). The overlap product is a chain of FMAs over the nine
// inputs in order, as the plain version's FP32 GEMM forms it.
//
// post runs two blocks of 288 threads per stream, both channels, and moves
// everything in 16-byte words. A thread takes four consecutive positions of
// the granule's PCM: one float4 of each channel's accumulators, and for
// stereo the eight int16 (channels interleaved in registers) leave as one
// 16-byte store, for mono four as one 8-byte store. The FIFO merge goes by
// aligned groups of four slots: a group that keep[v] keeps whole is not
// touched (no read of newv, no write), a group it writes whole is one float4
// load and one float4 store, and a group mixed within itself goes slot by
// slot (the probed masks have none: each phase keeps 32 slots, four whole
// groups a channel). The groups are laid out so that a warp's stores cover
// whole FIFO rows of both channels. Each thread starts its loads (keep's
// groups through the read-only path, the accumulators, the written newv
// groups) before its first store. Two blocks a stream beat one (more loads
// in flight at B = 2048, more blocks than SMs at B = 256). The first design
// (a block per (stream, channel), a thread per int16 stored nch samples
// apart, every slot of newv and keep read four bytes at a time) took 0.0046
// ms at B = 256 (queued, its operands in L2) and 0.0262 ms at B = 2048 (past
// L2) on an H100, this one 0.0032 and 0.0197 (tools/kernel_variants.py
// --mxu-post, PERF.md).
//
// What bounds them. pre: bytes; it reads the granule's x-side products (27
// floats a long or short block) and writes the 1664-float GEMM row of each
// stream and channel. post: where its operands miss L2 (B = 2048), bytes:
// the accumulators, the written newv slots, the FIFO slots it writes and the
// PCM; at B = 256 the GEMMs have just written its 6.1 MB, which L2 holds, and
// the latency of its few loads a thread and the launch set its time. The
// GEMMs take most of a step's arithmetic (2 * 1664 * 576 + 2 * 576 * 1088
// flop a row). pre's sums run in the plain version's order and post rounds
// nothing but floor(acc + 0.5), so through tools/cuda_cpu_shim.h both equal
// their plain versions bit for bit; on the card pre is held to its plain
// version by tolerance (nvcc may contract), post bit for bit.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int NB = 32;                   // subband blocks
constexpr int AX_COLS = 4 * 18 + 18 + 9 + 9;   // A36 x 4 windows | A12 | C36 | C12
constexpr int N_OUT = 576;
constexpr int N_V = 34 * 32;             // one channel's FIFO block
constexpr int ROW = N_OUT + N_V;         // one GEMM row
constexpr int PRE_THREADS = 288;         // one block per (stream, channel): 2 outputs a thread
constexpr int YS = 27;                   // x-side values a long or short block reads: 18 | 9
constexpr int POST_THREADS = 288;        // a block's threads
constexpr int POST_PARTS = 2;            // blocks a stream
constexpr int POST_SPAN = POST_THREADS * POST_PARTS;                 // threads a stream
constexpr int POST_GROUPS = (2 * N_V / 4 + POST_SPAN - 1) / POST_SPAN;   // FIFO groups a thread
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

// What block blk of a (stream, channel) row does this granule
struct Blk {
  bool in_long, in_short, in_prev;
  int curr_win, prev_win;
};
struct Row {
  int nbl, nbt, cws, bt, mixed, pt, pws, npv;
  __device__ Blk at(int blk) const {
    Blk k;
    k.in_long = blk < nbl;
    k.in_short = !k.in_long && blk < nbt;
    k.in_prev = !k.in_long && !k.in_short && blk >= max(nbl, nbt) && blk < npv;
    k.curr_win = (mixed == 1 && blk < cws) ? 0 : bt;
    k.prev_win = blk < pws ? 0 : pt;
    return k;
  }
};

// One block per (stream, channel) row. Stage: the row's overlap (16-byte
// loads), PX, and of each long or short block the 27 x-side values it
// reads (its window's 18 outputs, its 9 new overlap values), threads laid
// out over (block, column); the FIFO block goes straight into the GEMM row
// as float4s. Then each thread forms two outputs (t, blk), stored at
// t * 32 + blk, and one new overlap value; warp 0 reduces the block count.
__global__ void __launch_bounds__(PRE_THREADS) mp3_mxu_pre_kernel(PreArgs a) {
  __shared__ float4 xps4[72];                // the carried overlap, [32][9]
  float* xps = reinterpret_cast<float*>(xps4);
  __shared__ float pxs[9 * 72];
  __shared__ float ys[32 * YS];
  __shared__ int po[32];                     // the block's overlap product has a nonzero
  const int tid = threadIdx.x;
  const int row = blockIdx.x;
  const int b = row / a.nch, ch = row % a.nch;
  const int32_t* ip = a.ip + 5 * row;
  Row r;
  r.nbl = ip[0];
  r.nbt = ip[1];
  r.cws = ip[2];
  r.bt = ip[3];
  r.mixed = ip[4];
  r.pt = a.prev_type[2 * b + ch];
  r.pws = a.prev_ws[2 * b + ch];
  r.npv = a.num_prev[2 * b + ch];
  float* over = a.over + (size_t)b * 576 + ch * 288;
  float* of = a.ofvc + (size_t)row * ROW;
  const float* vb = a.vbuf + (size_t)b * 2176 + 32 * ch;

  // the channel's FIFO block, row-major [34, 32], after the IMDCT output
  for (int e = tid; e < N_V / 4; e += PRE_THREADS)
    reinterpret_cast<float4*>(of + N_OUT)[e] =
        reinterpret_cast<const float4*>(vb + 64 * (e >> 3))[e & 7];
  if (tid < 72) xps4[tid] = reinterpret_cast<const float4*>(over)[tid];
  for (int e = tid; e < 9 * 72; e += PRE_THREADS) pxs[e] = a.px[e];
  for (int e = tid; e < 32 * YS; e += PRE_THREADS) {
    const int blk = e / YS, c = e % YS;
    const Blk k = r.at(blk);
    if (k.in_long || k.in_short) {
      const int col = c < 18 ? (k.in_long ? 18 * sel4(k.curr_win) : 72) + c
                             : (k.in_long ? 90 : 99) + c - 18;
      ys[e] = a.yx[((size_t)row * NB + blk) * AX_COLS + col];
    }
  }
  if (tid < 32) po[tid] = 0;
  __syncthreads();

  // outputs (t, blk) and (t + 9, blk): ypo = xp @ PX[:, 18 prev_win : +18],
  // a chain of FMAs over the 9 inputs in order, as the plain version's GEMM
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int blk = tid & 31, t = (tid >> 5) + 9 * h;
    const Blk k = r.at(blk);
    const float* xp = xps + 9 * blk;
    const int col = 18 * sel4(k.prev_win) + t;
    float ypo = 0.0f;
#pragma unroll
    for (int i = 0; i < 9; ++i) ypo = fmaf(xp[i], pxs[72 * i + col], ypo);
    if (ypo != 0.0f) atomicOr(&po[blk], 1);
    const float y0 = (k.in_long || k.in_short) ? ys[YS * blk + t] : 0.0f;
    float y = y0 + ((k.in_long || k.in_short || k.in_prev) ? ypo : 0.0f);
    if ((blk & 1) && (t & 1)) y = -y;          // FreqInvert (operators probed at an even band)
    of[t * NB + blk] = y;
  }
  {   // the new overlap, value tid % 9 of block tid / 9
    const int blk = tid / 9, kk = tid % 9;
    const Blk k = r.at(blk);
    over[tid] = (k.in_long || k.in_short) ? ys[YS * blk + 18 + kk]
                                          : (k.in_prev ? 0.0f : xps[tid]);
  }
  __syncthreads();
  if (tid < 32) {
    const Blk k = r.at(tid);
    const int ext = __reduce_max_sync(FULL, (k.in_prev && po[tid]) ? tid : -1);
    if (tid == 0) {
      a.prev_type[2 * b + ch] = r.bt;
      a.prev_ws[2 * b + ch] = r.cws;
      a.num_prev[2 * b + ch] = max(max(r.nbl, r.nbt), ext);
    }
  }
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

__device__ __forceinline__ uint32_t pcm_pair(float lo, float hi) {   // floor(x + 0.5), int16
  const float a = fminf(fmaxf(floorf(lo + 0.5f), -32768.0f), 32767.0f);
  const float b = fminf(fmaxf(floorf(hi + 0.5f), -32768.0f), 32767.0f);
  return static_cast<uint32_t>(static_cast<uint16_t>(static_cast<int16_t>(a))) |
         (static_cast<uint32_t>(static_cast<uint16_t>(static_cast<int16_t>(b))) << 16);
}

__device__ __forceinline__ bool kept(float k) { return k == 1.0f; }
__device__ __forceinline__ bool all_kept(float4 k) {
  return kept(k.x) && kept(k.y) && kept(k.z) && kept(k.w);
}
__device__ __forceinline__ bool none_kept(float4 k) {
  return !kept(k.x) && !kept(k.y) && !kept(k.z) && !kept(k.w);
}

// POST_PARTS blocks per stream (blockIdx.y). Thread u of the stream takes
// FIFO groups j = u + POST_SPAN r: FIFO row j / (8 NCH), channel (j / 8) %
// NCH, slots 4 (j % 8) .. + 3 of the channel's 32 (so a warp's stores cover
// whole rows of the interleaved FIFO), and PCM quad k = u: positions 4k ..
// 4k + 3 of every channel.
template <int NCH>
__global__ void __launch_bounds__(POST_THREADS) mp3_mxu_post_kernel(PostArgs a) {
  static_assert(POST_SPAN >= N_OUT / 4, "one PCM quad a thread");
  constexpr int GROUPS = NCH * N_V / 4;
  const int b = blockIdx.x;
  const int u = blockIdx.y * POST_THREADS + threadIdx.x;
  const float4* __restrict__ keep4 = reinterpret_cast<const float4*>(a.keep);
  const float4* __restrict__ acc4 =
      reinterpret_cast<const float4*>(a.acc) + (size_t)b * NCH * (N_OUT / 4);
  const float4* __restrict__ nv4 =
      reinterpret_cast<const float4*>(a.newv) + (size_t)b * NCH * (N_V / 4);
  float* __restrict__ vb = a.vbuf + (size_t)b * 2176;
  const int k = u;
  const bool quad = k < N_OUT / 4;

  // every load before the first store: keep's groups, the accumulators, then
  // the newv groups that keep does not keep whole
  float4 kp[POST_GROUPS], nv[POST_GROUPS], x[NCH];
  int vi[POST_GROUPS];   // the group's first slot in the stream's FIFO, -1 past the end
#pragma unroll
  for (int r = 0; r < POST_GROUPS; ++r) {
    const int j = u + r * POST_SPAN;
    vi[r] = -1;
    if (j < GROUPS) {
      const int row = j / (8 * NCH), ch = (j / 8) % NCH, c4 = j % 8;
      kp[r] = __ldg(keep4 + 8 * row + c4);
      vi[r] = 64 * row + 32 * ch + 4 * c4;
    }
  }
  if (quad) {
#pragma unroll
    for (int ch = 0; ch < NCH; ++ch) x[ch] = acc4[ch * (N_OUT / 4) + k];
  }
#pragma unroll
  for (int r = 0; r < POST_GROUPS; ++r) {
    const int j = u + r * POST_SPAN;
    if (vi[r] >= 0 && !all_kept(kp[r]))
      nv[r] = nv4[((j / 8) % NCH) * (N_V / 4) + 8 * (j / (8 * NCH)) + j % 8];
  }

#pragma unroll
  for (int r = 0; r < POST_GROUPS; ++r) {
    if (vi[r] < 0 || all_kept(kp[r])) continue;
    float* v = vb + vi[r];
    if (none_kept(kp[r])) {
      *reinterpret_cast<float4*>(v) = nv[r];
    } else {   // mixed: slot by slot
      if (!kept(kp[r].x)) v[0] = nv[r].x;
      if (!kept(kp[r].y)) v[1] = nv[r].y;
      if (!kept(kp[r].z)) v[2] = nv[r].z;
      if (!kept(kp[r].w)) v[3] = nv[r].w;
    }
  }
  if (!quad) return;
  int16_t* out = a.pcm + (size_t)b * a.pitch;
  if constexpr (NCH == 2) {
    const uint4 w = make_uint4(pcm_pair(x[0].x, x[1].x), pcm_pair(x[0].y, x[1].y),
                               pcm_pair(x[0].z, x[1].z), pcm_pair(x[0].w, x[1].w));
    reinterpret_cast<uint4*>(out)[k] = w;
  } else {
    const uint2 w = make_uint2(pcm_pair(x[0].x, x[0].y), pcm_pair(x[0].z, x[0].w));
    reinterpret_cast<uint2*>(out)[k] = w;
  }
}

}  // namespace

extern "C" int eal_mp3_mxu_pre(const void* yx, const void* ip, void* over, void* prev_type,
                               void* prev_ws, void* num_prev, const void* vbuf, const void* px,
                               void* ofvc, int B, int nch, void* stream) {
  // the kernel moves the overlap, the FIFO and the GEMM row in 16-byte words
  if (B < 1 || (nch != 1 && nch != 2) ||
      ((reinterpret_cast<uintptr_t>(over) | reinterpret_cast<uintptr_t>(vbuf) |
        reinterpret_cast<uintptr_t>(ofvc)) & 15) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
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
  mp3_mxu_pre_kernel<<<B * nch, PRE_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int eal_mp3_mxu_post(const void* acc, const void* newv, void* vbuf, const void* keep,
                                void* pcm, long long pitch, int B, int nch, void* stream) {
  // the kernel moves acc, newv, vbuf and keep in 16-byte words and stores the
  // PCM 8 nch bytes at a time: pitch is in int16 samples
  const uintptr_t words = reinterpret_cast<uintptr_t>(acc) | reinterpret_cast<uintptr_t>(newv) |
                          reinterpret_cast<uintptr_t>(vbuf) | reinterpret_cast<uintptr_t>(keep);
  if (B < 1 || (nch != 1 && nch != 2) || pitch < 576LL * nch || (words & 15) != 0 ||
      (reinterpret_cast<uintptr_t>(pcm) & (8 * nch - 1)) != 0 || (pitch * 2) % (8 * nch) != 0)
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
  const dim3 grid(B, POST_PARTS);
  const auto kernel = nch == 2 ? mp3_mxu_post_kernel<2> : mp3_mxu_post_kernel<1>;
  kernel<<<grid, POST_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
