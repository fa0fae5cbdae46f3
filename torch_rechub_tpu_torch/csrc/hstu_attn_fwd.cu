// HSTU silu attention with a materialised bias: forward, hand-written for
// Hopper (sm_90a), fp32.
//
// Replaces the TPU kernel torch_rechub_tpu/ops/pallas/hstu_attention.py:
// _fwd_kernel.  For every (b, h, l):
//
//   out[b,h,l,:] = sum_{m <= l, mask[b,m]} silu(alpha * q[b,h,l,:].k[b,h,m,:] + bias[b',h,l,m]) / norm * v[b,h,m,:]
//
// with b' = b for a per-batch bias (B, H, L, L) and b' = 0 for a shared
// (1, H, L, L) one (the TPU indexes it by the flat batch*head index mod H).
// Masked pairs (m > l, or key m masked) get s = -1e4, whose silu is -0
// (expf overflows to inf, so the sigmoid is exactly 0), and their bias is
// never read: a NaN or inf in the upper triangle or at a masked key cannot
// reach the output, and a fully masked row yields zeros.  No softmax, so the
// accumulator is a plain sum.
//
// What bounds it on an H100: the bias.  At the serving shape (B8 H8 L256,
// dqk = dv = 32) a per-batch bias is 16.8 MB, of which a causal kernel needs
// the lower triangle, 8.4 MB, against 8.4 MB of q/k/v/out and 0.25 GFLOP of
// FMAs (128 FLOP per valid pair): bytes at 3.35 TB/s (0.005 ms) are above
// operations at 67 TFLOP/s (0.0037 ms).  A shared bias (1 MB of triangle)
// or L1024 (bias and FLOPs both grow as L^2, but q/k/v only as L) leave it
// bound by operations, as K1 is.  The TPU kernel brings the whole
// (block_q, L) strip of the bias into VMEM; this one reads only the 64 x 64
// tiles at or below the diagonal, each row of a tile by consecutive threads
// (coalesced along the key axis), and skips the elements of masked pairs.
//
// The rest is K1's loop (csrc/hstu_rab_fwd.cu): one CTA of 256 threads per
// (b*h, 64-row q tile); K/V tiles of 64 keys staged in shared memory up to
// the causal frontier; each thread owns a 4x4 block of the score tile and
// 4 x ceil(dv/16) outputs in registers (any dv <= 128, any dqk that fits
// shared memory).  The bias tile is staged into the P tile, which each
// thread then overwrites with silu of its own scores.  This first version
// is simple and exact; wgmma (tf32/bf16), TMA staging of the bias and a
// balanced causal schedule are the later steps.
//
// Ragged shapes need no host padding: rows and keys past L are masked here.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 256;       // 16 x 16 threads, each a 4 x 4 block of the 64 x 64 score tile
constexpr int kLd = kBlockQ + 1;    // row stride of the transposed Q/K tiles and the P tile (bank spread)
constexpr size_t kMaxSmem = 232448; // per-block dynamic shared memory limit on sm_90

static_assert(kBlockQ == kBlockK, "the transposed Q and K tiles share one row stride");
static_assert(kThreads % kBlockK == 0, "a pass of the bias load covers whole tile rows");

// Dynamic shared memory, in 4-byte words (vw = dv rounded up to 16, 32, 64 or 128):
//   Qt[dqk][kLd]  Kt[dqk][kLd]  Vs[kBlockK][vw]  Ps[kBlockQ][kLd]  km[kBlockK] (int)
inline size_t smem_bytes(int dqk, int vw) {
  return sizeof(float) * (2 * (size_t)dqk * kLd + (size_t)kBlockK * vw + (size_t)kBlockQ * kLd + kBlockK);
}

template <int NV>  // each thread owns output columns tx + 16*j, j < NV: dv <= 16 * NV
__global__ void __launch_bounds__(kThreads)
hstu_attn_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                     const float* __restrict__ bias, const uint8_t* __restrict__ mask, float* __restrict__ out,
                     int H, int L, int dqk, int dv, int shared_bias, float alpha, float norm) {
  constexpr int VW = 16 * NV;  // row width of the V tile in shared memory, zero past dv
  extern __shared__ float smem[];
  float* Qt = smem;
  float* Kt = Qt + dqk * kLd;
  float* Vs = Kt + dqk * kLd;
  float* Ps = Vs + kBlockK * VW;
  int* km = reinterpret_cast<int*>(Ps + kBlockQ * kLd);

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = blockIdx.x * kBlockQ;
  const int q_end = min(q0 + kBlockQ, L);  // one past the tile's last real row
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const float* qb = q + (size_t)bh * L * dqk;
  const float* kb = k + (size_t)bh * L * dqk;
  const float* vb = v + (size_t)bh * L * dv;
  const float* bb = bias + (size_t)(shared_bias ? h : bh) * L * L;
  const uint8_t* mb = mask == nullptr ? nullptr : mask + (size_t)b * L;

  // Stage the Q tile, transposed.
  for (int i = tid; i < kBlockQ * dqk; i += kThreads) {
    const int r = i / dqk, d = i - r * dqk;
    Qt[d * kLd + r] = q0 + r < L ? qb[(size_t)(q0 + r) * dqk + d] : 0.f;
  }

  float acc[4][NV];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NV; ++j) acc[i][j] = 0.f;

  const int n_kt = (q_end - 1) / kBlockK + 1;  // k tiles up to the causal frontier
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBlockK;
    __syncthreads();  // staging above is visible; the last tile's Kt/Vs/Ps are consumed
    for (int i = tid; i < kBlockK * dqk; i += kThreads) {
      const int c = i / dqk, d = i - c * dqk;
      Kt[d * kLd + c] = k0 + c < L ? kb[(size_t)(k0 + c) * dqk + d] : 0.f;
    }
    for (int i = tid; i < kBlockK * VW; i += kThreads) {
      const int c = i / VW, d = i - c * VW;
      Vs[c * VW + d] = k0 + c < L && d < dv ? vb[(size_t)(k0 + c) * dv + d] : 0.f;  // zeros: 0 * garbage could be NaN
    }
    if (tid < kBlockK) {
      const int m = k0 + tid;
      km[tid] = m < L && (mb == nullptr || mb[m] != 0);
    }
    // The bias tile into Ps: 64 consecutive threads per row, valid pairs only
    // (elements left unwritten are never read below).
    {
      const int c = tid % kBlockK, m = k0 + c;
      const bool key_ok = m < L && (mb == nullptr || mb[m] != 0);
      for (int r = tid / kBlockK; r < kBlockQ; r += kThreads / kBlockK) {
        const int l = q0 + r;
        if (key_ok && m <= l && l < L) Ps[r * kLd + c] = bb[(size_t)l * L + m];
      }
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < dqk; ++d) {
      float a[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Qt[d * kLd + ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Kt[d * kLd + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], kv[j], s[i][j]);
    }

    // Each thread reads and overwrites only its own 4x4 elements of Ps.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i, l = q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j, m = k0 + c;
        float x = -1e4f;
        if (l < L && m <= l && km[c]) x = s[i][j] * alpha + Ps[r * kLd + c];
        Ps[r * kLd + c] = x / (1.f + expf(-x)) / norm;
      }
    }
    __syncthreads();

    for (int c = 0; c < kBlockK; ++c) {
      float vv[NV];
#pragma unroll
      for (int j = 0; j < NV; ++j) vv[j] = Vs[c * VW + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = Ps[(ty * 4 + i) * kLd + c];
#pragma unroll
        for (int j = 0; j < NV; ++j) acc[i][j] = fmaf(p, vv[j], acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int l = q0 + ty * 4 + i;
    if (l < L) {
#pragma unroll
      for (int j = 0; j < NV; ++j)
        if (tx + 16 * j < dv) out[((size_t)bh * L + l) * dv + tx + 16 * j] = acc[i][j];
    }
  }
}

template <int NV>
cudaError_t launch(const float* q, const float* k, const float* v, const float* bias, const uint8_t* mask, float* out,
                   int B, int H, int L, int dqk, int dv, int shared_bias, float alpha, float norm,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes(dqk, 16 * NV);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(hstu_attn_fwd_kernel<NV>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((L + kBlockQ - 1) / kBlockQ, B * H);
  hstu_attn_fwd_kernel<NV><<<grid, kThreads, smem, stream>>>(q, k, v, bias, mask, out, H, L, dqk, dv, shared_bias,
                                                              alpha, norm);
  return cudaGetLastError();
}

}  // namespace

// q, k: (B, H, L, dqk); v, out: (B, H, L, dv); bias: (B, H, L, L), or
// (1, H, L, L) when shared_bias is nonzero; all fp32, contiguous.  mask:
// (B, L) bool or null (all keys valid).  norm: the silu normaliser
// (max_seq_len).  Returns the cudaError_t of the launch (0 on success).
extern "C" int hstu_attn_fwd(const void* q, const void* k, const void* v, const void* bias, const void* mask, void* out,
                             int B, int H, int L, int dqk, int dv, int shared_bias, float alpha, float norm,
                             void* stream) {
  const auto* qf = static_cast<const float*>(q);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  const auto* bf = static_cast<const float*>(bias);
  const auto* m = static_cast<const uint8_t*>(mask);
  auto* o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  if (dv < 1 || dv > 128 || dqk < 1 || L < 1 || B * H < 1 || B * H > 65535) return cudaErrorInvalidValue;
  if (dv <= 16) return launch<1>(qf, kf, vf, bf, m, o, B, H, L, dqk, dv, shared_bias, alpha, norm, st);
  if (dv <= 32) return launch<2>(qf, kf, vf, bf, m, o, B, H, L, dqk, dv, shared_bias, alpha, norm, st);
  if (dv <= 64) return launch<4>(qf, kf, vf, bf, m, o, B, H, L, dqk, dv, shared_bias, alpha, norm, st);
  return launch<8>(qf, kf, vf, bf, m, o, B, H, L, dqk, dv, shared_bias, alpha, norm, st);
}

extern "C" const char* hstu_attn_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }
