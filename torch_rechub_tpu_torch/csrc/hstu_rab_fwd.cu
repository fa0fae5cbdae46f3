// HSTU silu attention with on-the-fly relative position/time bias: forward,
// hand-written for Hopper (sm_90a), fp32.
//
// Replaces the TPU kernel torch_rechub_tpu/ops/pallas/hstu_rab_attention.py:
// _fwd_kernel.  For every (b, h, l):
//
//   out[b,h,l,:] = sum_{m <= l, mask[b,m]} silu(s_lm) / max_seq_len * v[b,h,m,:]
//   s_lm = alpha * q[b,h,l,:].k[b,h,m,:] + (pos_w[m-l+maxL-1, h] + ts_w[bucket(t_l - t_m), h])
//
// with bucket(x) = max u such that thr[u] <= |x|, x the int32 difference
// t_l - t_m (wrapping, as in the reference).  The integer thresholds come
// from the host (compute_bucket_thresholds, an exact bisection against the
// f32 bucketize function), so the kernel takes no sqrt or log and matches
// the dense reference bucket for bucket.  Masked pairs get s = -1e4, whose
// silu is -0 (expf overflows to inf, so the sigmoid is exactly 0): a fully
// masked row yields zeros, never NaN.  There is no softmax, hence no running
// max or denominator: the accumulator is a plain sum.
//
// What bounds it on an H100: at the serving shape (B8 H8 L256, dqk = dv = 32)
// the causal work is 2*B*H*(L^2/2)*(dqk+dv) = 0.27 GFLOP against 8.4 MB of
// q/k/v/out, about 32 FLOP per byte, so fp32 FMA throughput (67 TFLOP/s
// outside the tensor cores) is the roofline, not HBM.  This first version
// is simple and exact: one CTA of 256 threads per (b*h, 64-row q tile);
// K/V tiles of 64 keys staged in shared memory up to the causal frontier;
// each thread owns a 4x4 block of the score tile and 4 x ceil(dv/16) outputs
// in registers (any dv <= 128, any dqk); the time-bucket lookup is a binary search over the threshold
// table in shared memory.  It runs at about 19x its bound (PERF.md); the
// likely limits are shared-memory loads per FMA, the bucket search and the
// causal imbalance between q tiles, not HBM.  wgmma (tf32/bf16), TMA
// staging and a cheaper bucket walk are the later steps.
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

// Dynamic shared memory, in 4-byte words (vw = dv rounded up to 16, 32, 64 or 128):
//   Qt[dqk][kLd]  Kt[dqk][kLd]  Vs[kBlockK][vw]  Ps[kBlockQ][kLd]
//   pw[L] (position bias by causal distance)  tw[nb+1]  th[nb+1] (int)
//   tq[kBlockQ] tk[kBlockK] km[kBlockK] (int)
inline size_t smem_bytes(int dqk, int vw, int L, int num_buckets) {
  return sizeof(float) * (2 * (size_t)dqk * kLd + (size_t)kBlockK * vw + (size_t)kBlockQ * kLd + (size_t)L +
                          2 * (size_t)(num_buckets + 1) + kBlockQ + 2 * kBlockK);
}

template <int NV>  // each thread owns output columns tx + 16*j, j < NV: dv <= 16 * NV
__global__ void __launch_bounds__(kThreads)
hstu_rab_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                    const float* __restrict__ pos_w, const float* __restrict__ ts_w, const int* __restrict__ thr,
                    const int* __restrict__ ts, const uint8_t* __restrict__ mask, float* __restrict__ out,
                    int H, int L, int dqk, int dv, int max_seq_len, int num_buckets, float alpha) {
  constexpr int VW = 16 * NV;  // row width of the V tile in shared memory, zero past dv
  extern __shared__ float smem[];
  float* Qt = smem;
  float* Kt = Qt + dqk * kLd;
  float* Vs = Kt + dqk * kLd;
  float* Ps = Vs + kBlockK * VW;
  float* pw = Ps + kBlockQ * kLd;
  float* tw = pw + L;
  int* th = reinterpret_cast<int*>(tw + num_buckets + 1);
  int* tq = th + num_buckets + 1;
  int* tk = tq + kBlockQ;
  int* km = tk + kBlockK;

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = blockIdx.x * kBlockQ;
  const int q_end = min(q0 + kBlockQ, L);  // one past the tile's last real row
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const bool has_time = ts != nullptr;
  const float* qb = q + (size_t)bh * L * dqk;
  const float* kb = k + (size_t)bh * L * dqk;
  const float* vb = v + (size_t)bh * L * dv;
  const float norm = (float)max_seq_len;

  // Stage the Q tile (transposed), this head's position bias for the causal
  // distances 0 .. q_end-1, its time table column and the thresholds.
  for (int i = tid; i < kBlockQ * dqk; i += kThreads) {
    const int r = i / dqk, d = i - r * dqk;
    Qt[d * kLd + r] = q0 + r < L ? qb[(size_t)(q0 + r) * dqk + d] : 0.f;
  }
  for (int d = tid; d < q_end; d += kThreads) pw[d] = pos_w[(size_t)(max_seq_len - 1 - d) * H + h];
  if (has_time) {
    for (int u = tid; u <= num_buckets; u += kThreads) {
      tw[u] = ts_w[(size_t)u * H + h];
      th[u] = thr[u];
    }
    for (int r = tid; r < kBlockQ; r += kThreads) tq[r] = q0 + r < L ? ts[(size_t)b * L + q0 + r] : 0;
  }
  int top = 1;  // largest power of two <= num_buckets: first step of the bucket search
  while (2 * top <= num_buckets) top *= 2;

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
      km[tid] = m < L && (mask == nullptr || mask[(size_t)b * L + m] != 0);
      if (has_time) tk[tid] = m < L ? ts[(size_t)b * L + m] : 0;
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

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i, l = q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j, m = k0 + c;
        float x = -1e4f;
        if (l < L && m <= l && km[c]) {
          float bias = pw[l - m];
          if (has_time) {
            // t_l - t_m wraps in int32, as the reference's int32 subtraction does;
            // its magnitude is taken in 64 bits so that -2^31 gives 2^31
            const int dt = (int)((unsigned)tq[r] - (unsigned)tk[c]);
            const long long adt = llabs((long long)dt);
            int u = 0;
            for (int step = top; step > 0; step >>= 1) {
              const int cand = u + step;
              if (cand <= num_buckets && (long long)th[cand] <= adt) u = cand;
            }
            bias += tw[u];
          }
          x = s[i][j] * alpha + bias;
        }
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
cudaError_t launch(const float* q, const float* k, const float* v, const float* pos_w, const float* ts_w,
                   const int* thr, const int* ts, const uint8_t* mask, float* out, int B, int H, int L, int dqk,
                   int dv, int max_seq_len, int num_buckets, float alpha, cudaStream_t stream) {
  const size_t smem = smem_bytes(dqk, 16 * NV, L, num_buckets);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(hstu_rab_fwd_kernel<NV>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((L + kBlockQ - 1) / kBlockQ, B * H);
  hstu_rab_fwd_kernel<NV><<<grid, kThreads, smem, stream>>>(q, k, v, pos_w, ts_w, thr, ts, mask, out, H, L, dqk, dv,
                                                             max_seq_len, num_buckets, alpha);
  return cudaGetLastError();
}

}  // namespace

// q, k: (B, H, L, dqk); v, out: (B, H, L, dv); pos_w: (2*max_seq_len-1, H);
// ts_w: (num_buckets+1, H); all fp32, contiguous.  thr: (num_buckets+1,) int32.
// ts: (B, L) int32 or null (position bias only); mask: (B, L) bool or null
// (all keys valid).  Returns the cudaError_t of the launch (0 on success).
extern "C" int hstu_rab_fwd(const void* q, const void* k, const void* v, const void* pos_w, const void* ts_w,
                            const void* thr, const void* ts, const void* mask, void* out, int B, int H, int L,
                            int dqk, int dv, int max_seq_len, int num_buckets, float alpha, void* stream) {
  const auto* qf = static_cast<const float*>(q);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  const auto* pf = static_cast<const float*>(pos_w);
  const auto* tf = static_cast<const float*>(ts_w);
  const auto* th = static_cast<const int*>(thr);
  const auto* t = static_cast<const int*>(ts);
  const auto* m = static_cast<const uint8_t*>(mask);
  auto* o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  if (dv < 1 || dv > 128 || dqk < 1) return cudaErrorInvalidValue;
  if (dv <= 16) return launch<1>(qf, kf, vf, pf, tf, th, t, m, o, B, H, L, dqk, dv, max_seq_len, num_buckets, alpha, st);
  if (dv <= 32) return launch<2>(qf, kf, vf, pf, tf, th, t, m, o, B, H, L, dqk, dv, max_seq_len, num_buckets, alpha, st);
  if (dv <= 64) return launch<4>(qf, kf, vf, pf, tf, th, t, m, o, B, H, L, dqk, dv, max_seq_len, num_buckets, alpha, st);
  return launch<8>(qf, kf, vf, pf, tf, th, t, m, o, B, H, L, dqk, dv, max_seq_len, num_buckets, alpha, st);
}

extern "C" const char* hstu_rab_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }
