// HSTU silu attention with on-the-fly relative position/time bias: the three
// backward kernels, hand-written for Hopper (sm_90a), fp32.
//
// Replaces the TPU kernels of torch_rechub_tpu/ops/pallas/hstu_rab_attention.py:
//   K2  _bwd_fused_kernel -> hstu_rab_bwd      dq, dk, dv, dpos, dts in one pass
//   K2a _bwd_dq_kernel    -> hstu_rab_bwd_dq   dq, dpos, dts
//   K2b _bwd_dkv_kernel   -> hstu_rab_bwd_dkv  dk, dv
//
// With s = alpha q_l.k_m + pos_w[m-l+maxL-1, h] + ts_w[bucket(t_l - t_m), h]
// on valid pairs (m <= l < L, mask[m]) and -1e4 elsewhere, the forward is
// out_l = sum_m silu(s_lm) / N v_m (N = max_seq_len).  Given g = dL/dout:
//
//   P_lm  = silu(s_lm) / N                   dattn_lm = g_l . v_m
//   dS_lm = valid ? dattn_lm silu'(s_lm) / N : 0
//   dv_m  = sum_l P_lm g_l        dk_m = alpha sum_l dS_lm q_l
//   dq_l  = alpha sum_m dS_lm k_m
//   dpos[maxL-1-(l-m), h] += dS_lm           dts[bucket(t_l - t_m), h] += dS_lm
//
// bucket() is the binary search over the integer thresholds of K1
// (hstu_rab_fwd.cu; the helper is copied here), with the int32 difference
// wrapping and its magnitude taken in 64 bits.
//
// Design.  One CTA of 256 threads works on 64 x 64 tiles of (query, key)
// pairs; each thread owns a 4 x 4 block of the tile and rebuilds the scores,
// the bias and dattn from operand tiles staged transposed in shared memory
// (zero past L and past the feature width, so ragged shapes need no host
// padding).  P and dS go to shared memory for the products that follow.
//   K2b: one CTA per (b*h, 64-key tile), looping over the q tiles from the
//        diagonal to L; dk and dv stay in registers and are written once.
//   K2a: one CTA per (b*h, 64-row q tile), looping over the k tiles up to the
//        causal frontier, as K1 does; dq stays in registers, written once.
//   K2:  K2b's grid and loop, plus dq and the table gradients.  The TPU
//        kernel carries dq across the k steps of a grid that runs in order;
//        Hopper CTAs run concurrently, so here dq is an fp32 buffer that the
//        wrapper zeroes and every (k tile, q tile) pair adds its partial to
//        with atomicAdd.  The order of those sums changes from run to run.
// Table gradients (K2a, K2) are cross-CTA reductions: each CTA sums into
// shared memory (dpos by causal distance l-m, one thread per diagonal of the
// tile, no atomics; dts per bucket, each thread first folding its own run of
// equal buckets and a warp whose lanes all hold one bucket summing by
// shuffles, so sorted stamps cost one shared atomic per warp per tile), then
// adds its nonzero slots to the zeroed fp32 outputs with one global
// atomicAdd each.
//
// What bounds it on an H100: at B8 H8 L256, dqk = dv = 32 there are
// B*H*L(L+1)/2 = 2.10 M causal pairs.  Per pair K2 does 3 dqk + 2 dv FMAs
// (320 FLOP, 0.671 GFLOP, 0.0100 ms at 67 TFLOP/s fp32), K2a 2 dqk + dv (192,
// 0.0060 ms), K2b 2 dqk + 2 dv (256, 0.0080 ms), against 7 x 2.10 MB of
// q/k/v/g/dq/dk/dv for K2 (0.0044 ms at 3.35 TB/s): all three are bound by
// operations.  This first version is simple and exact (fp32 FMAs, no wgmma,
// no TMA); its time beside the bound is in PERF.md.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 64;           // q and k tiles
constexpr int kThreads = 256;        // 16 x 16 threads, each a 4 x 4 block of the tile
constexpr int kLd = kBlock + 1;      // row stride of the transposed tiles and of P / dS (bank spread)
constexpr size_t kMaxSmem = 232448;  // per-block dynamic shared memory limit on sm_90

enum Mode { kFused = 0, kDkv = 1 };

struct Args {
  const float *q, *k, *v, *g, *pos_w, *ts_w;
  const int *thr, *ts;
  const uint8_t* mask;
  float *dq, *dk, *dv, *dpos, *dts;
  int H, L, dqk, dv_dim, max_seq_len, num_buckets;
  float alpha;
};

// Dynamic shared memory, in 4-byte words (DW = 16 * N >= dqk, dv):
//   Qt Kt Gt Vt [DW][kLd]   Ps Ds [kBlock][kLd]
//   pw[L] (position bias by causal distance)  gpos[L] (its gradient)
//   tw[nb+1]  gts[nb+1]  th[nb+1] (int)  tq tk km [kBlock] (int)
inline size_t smem_bytes(int dw, int L, int num_buckets) {
  return sizeof(float) * (4 * (size_t)dw * kLd + 2 * (size_t)kBlock * kLd + 2 * (size_t)L +
                          3 * (size_t)(num_buckets + 1) + 3 * kBlock);
}

struct Smem {
  float *Qt, *Kt, *Gt, *Vt, *Ps, *Ds, *pw, *gpos, *tw, *gts;
  int *th, *tq, *tk, *km;
};

__device__ __forceinline__ Smem carve(float* smem, int dw, int L, int num_buckets) {
  Smem s;
  s.Qt = smem;
  s.Kt = s.Qt + dw * kLd;
  s.Gt = s.Kt + dw * kLd;
  s.Vt = s.Gt + dw * kLd;
  s.Ps = s.Vt + dw * kLd;
  s.Ds = s.Ps + kBlock * kLd;
  s.pw = s.Ds + kBlock * kLd;
  s.gpos = s.pw + L;
  s.tw = s.gpos + L;
  s.gts = s.tw + num_buckets + 1;
  s.th = reinterpret_cast<int*>(s.gts + num_buckets + 1);
  s.tq = s.th + num_buckets + 1;
  s.tk = s.tq + kBlock;
  s.km = s.tk + kBlock;
  return s;
}

// dst[d * kLd + r] = src[row0 + r, d] for r < kBlock, d < DW; zero past L or width
template <int DW>
__device__ __forceinline__ void stage_t(float* dst, const float* src, int row0, int L, int width) {
  for (int i = threadIdx.x; i < kBlock * DW; i += kThreads) {
    const int r = i / DW, d = i - r * DW;
    dst[d * kLd + r] = row0 + r < L && d < width ? src[(size_t)(row0 + r) * width + d] : 0.f;
  }
}

// The head's tables and the zeroed gradient accumulators.
__device__ __forceinline__ void stage_tables(const Args& a, const Smem& s, int h, bool has_time) {
  for (int d = threadIdx.x; d < a.L; d += kThreads) {
    s.pw[d] = a.pos_w[(size_t)(a.max_seq_len - 1 - d) * a.H + h];
    s.gpos[d] = 0.f;
  }
  if (has_time) {
    for (int u = threadIdx.x; u <= a.num_buckets; u += kThreads) {
      s.tw[u] = a.ts_w[(size_t)u * a.H + h];
      s.th[u] = a.thr[u];
      s.gts[u] = 0.f;
    }
  }
}

// Rows (or keys) r0 .. r0+63 of batch b: stamps into t, and for keys the validity into valid.
__device__ __forceinline__ void stage_rows(const Args& a, int b, int r0, int* t, int* valid, bool has_time) {
  if (threadIdx.x < kBlock) {
    const int m = r0 + threadIdx.x;
    if (valid != nullptr) valid[threadIdx.x] = m < a.L && (a.mask == nullptr || a.mask[(size_t)b * a.L + m] != 0);
    if (has_time) t[threadIdx.x] = m < a.L ? a.ts[(size_t)b * a.L + m] : 0;
  }
}

// bucket(t_l - t_m): the largest u with thr[u] <= |t_l - t_m|.  The int32
// difference wraps, as the reference's int32 subtraction does; its magnitude
// is taken in 64 bits so that -2^31 gives 2^31.
__device__ __forceinline__ int bucket_of(int tl, int tm, const int* th, int num_buckets, int top) {
  const int dt = (int)((unsigned)tl - (unsigned)tm);
  const long long adt = llabs((long long)dt);
  int u = 0;
  for (int step = top; step > 0; step >>= 1) {
    const int cand = u + step;
    if (cand <= num_buckets && (long long)th[cand] <= adt) u = cand;
  }
  return u;
}

// One 64 x 64 tile (rows q0.., keys k0..): dS (and P when want_p) into shared
// memory, and this thread's 4 x 4 block of dS and buckets (-1 where invalid)
// in registers for the table gradients.
__device__ __forceinline__ void tile_grads(const Args& a, const Smem& s, int q0, int k0, bool has_time, int top,
                                           bool want_p, float ds[4][4], int bk[4][4]) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const float norm = (float)a.max_seq_len;
  float sc[4][4], da[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) sc[i][j] = da[i][j] = 0.f;
  for (int d = 0; d < a.dqk; ++d) {
    float x[4], y[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = s.Qt[d * kLd + ty * 4 + i];
#pragma unroll
    for (int j = 0; j < 4; ++j) y[j] = s.Kt[d * kLd + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(x[i], y[j], sc[i][j]);
  }
  for (int d = 0; d < a.dv_dim; ++d) {
    float x[4], y[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = s.Gt[d * kLd + ty * 4 + i];
#pragma unroll
    for (int j = 0; j < 4; ++j) y[j] = s.Vt[d * kLd + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) da[i][j] = fmaf(x[i], y[j], da[i][j]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i, l = q0 + r;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j, m = k0 + c;
      const bool valid = l < a.L && m <= l && s.km[c];
      float x = -1e4f;
      int u = -1;
      if (valid) {
        float bias = s.pw[l - m];
        if (has_time) {
          u = bucket_of(s.tq[r], s.tk[c], s.th, a.num_buckets, top);
          bias += s.tw[u];
        }
        x = sc[i][j] * a.alpha + bias;
      }
      const float e = expf(-x);  // inf at -1e4: the sigmoid is exactly 0 and silu is -0
      const float sig = 1.f / (1.f + e);
      const float d = valid ? da[i][j] * (sig * (1.f + x * (1.f - sig))) / norm : 0.f;
      if (want_p) s.Ps[r * kLd + c] = x / (1.f + e) / norm;
      s.Ds[r * kLd + c] = d;
      ds[i][j] = d;
      bk[i][j] = u;
    }
  }
}

// Table gradients of one tile into the CTA's shared accumulators.  Call after
// the tile's dS is complete in shared memory (a __syncthreads after
// tile_grads) and before the next tile overwrites it.
__device__ __forceinline__ void tile_table_grads(const Smem& s, int q0, int k0, int L, bool has_time,
                                                 const float ds[4][4], const int bk[4][4]) {
  // dpos: thread t < 127 owns the diagonal r - c = t - 63 of the tile, i.e.
  // the causal distance q0 - k0 + t - 63; each distance has one owner, so a
  // plain add suffices (tiles are separated by __syncthreads).
  const int t = threadIdx.x;
  if (t < 2 * kBlock - 1) {
    const int o = t - (kBlock - 1);
    const int dist = q0 - k0 + o;
    if (dist >= 0 && dist < L) {
      float acc = 0.f;
      const int n = kBlock - (o >= 0 ? o : -o);
      const int r0 = o >= 0 ? o : 0, c0 = o >= 0 ? 0 : -o;
      for (int i = 0; i < n; ++i) acc += s.Ds[(r0 + i) * kLd + c0 + i];
      s.gpos[dist] += acc;
    }
  }
  if (!has_time) return;
  // dts: fold this thread's runs of equal buckets, then the warp's if uniform
  int cur = -1;
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int u = bk[i][j];
      if (u < 0) continue;
      if (u != cur) {
        if (cur >= 0) atomicAdd(&s.gts[cur], acc);
        cur = u;
        acc = 0.f;
      }
      acc += ds[i][j];
    }
  const unsigned full = 0xffffffffu;
  const int top = __reduce_max_sync(full, cur);
  if (__all_sync(full, cur == top || cur < 0)) {
    float sum = acc;  // 0 where cur < 0
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(full, sum, off);
    if ((threadIdx.x & 31) == 0 && top >= 0) atomicAdd(&s.gts[top], sum);
  } else if (cur >= 0) {
    atomicAdd(&s.gts[cur], acc);
  }
}

// The CTA's table gradients into the global fp32 outputs (zeroed by the wrapper).
__device__ __forceinline__ void flush_table_grads(const Args& a, const Smem& s, int h, bool has_time) {
  for (int d = threadIdx.x; d < a.L; d += kThreads)
    if (s.gpos[d] != 0.f) atomicAdd(&a.dpos[(size_t)(a.max_seq_len - 1 - d) * a.H + h], s.gpos[d]);
  if (has_time)
    for (int u = threadIdx.x; u <= a.num_buckets; u += kThreads)
      if (s.gts[u] != 0.f) atomicAdd(&a.dts[(size_t)u * a.H + h], s.gts[u]);
}

__device__ __forceinline__ int top_step(int num_buckets) {
  int top = 1;  // largest power of two <= num_buckets: first step of the bucket search
  while (2 * top <= num_buckets) top *= 2;
  return top;
}

// K2 (MODE = kFused) and K2b (MODE = kDkv): one CTA per (b*h, 64-key tile).
template <int N, int MODE>
__global__ void __launch_bounds__(kThreads) bwd_kv_kernel(Args a) {
  constexpr int DW = 16 * N;
  extern __shared__ float smem[];
  const Smem s = carve(smem, DW, a.L, a.num_buckets);
  const int bh = blockIdx.y, b = bh / a.H, h = bh - b * a.H;
  const int kt = blockIdx.x, k0 = kt * kBlock;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const bool has_time = a.ts != nullptr;
  const int top = top_step(a.num_buckets);
  const float* qb = a.q + (size_t)bh * a.L * a.dqk;
  const float* gb = a.g + (size_t)bh * a.L * a.dv_dim;

  stage_t<DW>(s.Kt, a.k + (size_t)bh * a.L * a.dqk, k0, a.L, a.dqk);
  stage_t<DW>(s.Vt, a.v + (size_t)bh * a.L * a.dv_dim, k0, a.L, a.dv_dim);
  stage_rows(a, b, k0, s.tk, s.km, has_time);
  stage_tables(a, s, h, has_time);

  float dk_acc[4][N], dv_acc[4][N];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  const int n_q = (a.L + kBlock - 1) / kBlock;
  for (int qt = kt; qt < n_q; ++qt) {  // the q tiles at or below the diagonal
    const int q0 = qt * kBlock;
    __syncthreads();  // staging above is visible; the last tile's Qt/Gt/Ps/Ds are consumed
    stage_t<DW>(s.Qt, qb, q0, a.L, a.dqk);
    stage_t<DW>(s.Gt, gb, q0, a.L, a.dv_dim);
    stage_rows(a, b, q0, s.tq, nullptr, has_time);
    __syncthreads();

    float ds[4][4];
    int bk[4][4];
    tile_grads(a, s, q0, k0, has_time, top, true, ds, bk);
    __syncthreads();

    // dk[c] += alpha sum_r dS[r][c] q[r], dv[c] += sum_r P[r][c] g[r]: this thread's keys ty*4+i, features tx+16j
    for (int r = 0; r < kBlock; ++r) {
      float qv[N], gv[N];
#pragma unroll
      for (int j = 0; j < N; ++j) {
        qv[j] = s.Qt[(tx + 16 * j) * kLd + r];
        gv[j] = s.Gt[(tx + 16 * j) * kLd + r];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float d = s.Ds[r * kLd + ty * 4 + i];
        const float p = s.Ps[r * kLd + ty * 4 + i];
#pragma unroll
        for (int j = 0; j < N; ++j) {
          dk_acc[i][j] = fmaf(d, qv[j], dk_acc[i][j]);
          dv_acc[i][j] = fmaf(p, gv[j], dv_acc[i][j]);
        }
      }
    }
    if (MODE == kFused) {
      // dq[r] += alpha sum_c dS[r][c] k[c] for this thread's rows ty*4+i: a
      // partial sum that other CTAs also add to, hence the atomics
      float dq_part[4][N];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < N; ++j) dq_part[i][j] = 0.f;
      for (int c = 0; c < kBlock; ++c) {
        float kv[N];
#pragma unroll
        for (int j = 0; j < N; ++j) kv[j] = s.Kt[(tx + 16 * j) * kLd + c];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float d = s.Ds[(ty * 4 + i) * kLd + c];
#pragma unroll
          for (int j = 0; j < N; ++j) dq_part[i][j] = fmaf(d, kv[j], dq_part[i][j]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int l = q0 + ty * 4 + i;
        if (l < a.L) {
#pragma unroll
          for (int j = 0; j < N; ++j)
            if (tx + 16 * j < a.dqk) atomicAdd(&a.dq[((size_t)bh * a.L + l) * a.dqk + tx + 16 * j], dq_part[i][j] * a.alpha);
        }
      }
      tile_table_grads(s, q0, k0, a.L, has_time, ds, bk);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = k0 + ty * 4 + i;
    if (m < a.L) {
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const int d = tx + 16 * j;
        if (d < a.dqk) a.dk[((size_t)bh * a.L + m) * a.dqk + d] = dk_acc[i][j] * a.alpha;
        if (d < a.dv_dim) a.dv[((size_t)bh * a.L + m) * a.dv_dim + d] = dv_acc[i][j];
      }
    }
  }
  if (MODE == kFused) {
    __syncthreads();
    flush_table_grads(a, s, h, has_time);
  }
}

// K2a: one CTA per (b*h, 64-row q tile), the heaviest (last) tiles first.
template <int N>
__global__ void __launch_bounds__(kThreads) bwd_q_kernel(Args a) {
  constexpr int DW = 16 * N;
  extern __shared__ float smem[];
  const Smem s = carve(smem, DW, a.L, a.num_buckets);
  const int bh = blockIdx.y, b = bh / a.H, h = bh - b * a.H;
  const int qt = gridDim.x - 1 - blockIdx.x, q0 = qt * kBlock;
  const int q_end = min(q0 + kBlock, a.L);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const bool has_time = a.ts != nullptr;
  const int top = top_step(a.num_buckets);
  const float* kb = a.k + (size_t)bh * a.L * a.dqk;
  const float* vb = a.v + (size_t)bh * a.L * a.dv_dim;

  stage_t<DW>(s.Qt, a.q + (size_t)bh * a.L * a.dqk, q0, a.L, a.dqk);
  stage_t<DW>(s.Gt, a.g + (size_t)bh * a.L * a.dv_dim, q0, a.L, a.dv_dim);
  stage_rows(a, b, q0, s.tq, nullptr, has_time);
  stage_tables(a, s, h, has_time);

  float dq_acc[4][N];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) dq_acc[i][j] = 0.f;

  const int n_kt = (q_end - 1) / kBlock + 1;  // k tiles up to the causal frontier
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBlock;
    __syncthreads();
    stage_t<DW>(s.Kt, kb, k0, a.L, a.dqk);
    stage_t<DW>(s.Vt, vb, k0, a.L, a.dv_dim);
    stage_rows(a, b, k0, s.tk, s.km, has_time);
    __syncthreads();

    float ds[4][4];
    int bk[4][4];
    tile_grads(a, s, q0, k0, has_time, top, false, ds, bk);
    __syncthreads();

    for (int c = 0; c < kBlock; ++c) {
      float kv[N];
#pragma unroll
      for (int j = 0; j < N; ++j) kv[j] = s.Kt[(tx + 16 * j) * kLd + c];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float d = s.Ds[(ty * 4 + i) * kLd + c];
#pragma unroll
        for (int j = 0; j < N; ++j) dq_acc[i][j] = fmaf(d, kv[j], dq_acc[i][j]);
      }
    }
    tile_table_grads(s, q0, k0, a.L, has_time, ds, bk);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int l = q0 + ty * 4 + i;
    if (l < a.L) {
#pragma unroll
      for (int j = 0; j < N; ++j)
        if (tx + 16 * j < a.dqk) a.dq[((size_t)bh * a.L + l) * a.dqk + tx + 16 * j] = dq_acc[i][j] * a.alpha;
    }
  }
  __syncthreads();
  flush_table_grads(a, s, h, has_time);
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, const Args& a, int B, int dw, cudaStream_t stream) {
  const size_t smem = smem_bytes(dw, a.L, a.num_buckets);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((a.L + kBlock - 1) / kBlock, B * a.H);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int N>
cudaError_t dispatch(int which, const Args& a, int B, cudaStream_t st) {
  if (which == 0) return launch(bwd_kv_kernel<N, kFused>, a, B, 16 * N, st);
  if (which == 1) return launch(bwd_q_kernel<N>, a, B, 16 * N, st);
  return launch(bwd_kv_kernel<N, kDkv>, a, B, 16 * N, st);
}

int run(int which, const void* q, const void* k, const void* v, const void* g, const void* pos_w, const void* ts_w,
        const void* thr, const void* ts, const void* mask, void* dq, void* dk, void* dv, void* dpos, void* dts, int B,
        int H, int L, int dqk, int dv_dim, int max_seq_len, int num_buckets, float alpha, void* stream) {
  Args a;
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.g = static_cast<const float*>(g);
  a.pos_w = static_cast<const float*>(pos_w);
  a.ts_w = static_cast<const float*>(ts_w);
  a.thr = static_cast<const int*>(thr);
  a.ts = static_cast<const int*>(ts);
  a.mask = static_cast<const uint8_t*>(mask);
  a.dq = static_cast<float*>(dq);
  a.dk = static_cast<float*>(dk);
  a.dv = static_cast<float*>(dv);
  a.dpos = static_cast<float*>(dpos);
  a.dts = static_cast<float*>(dts);
  a.H = H;
  a.L = L;
  a.dqk = dqk;
  a.dv_dim = dv_dim;
  a.max_seq_len = max_seq_len;
  a.num_buckets = num_buckets;
  a.alpha = alpha;
  auto st = static_cast<cudaStream_t>(stream);
  const int width = dqk > dv_dim ? dqk : dv_dim;
  if (dqk < 1 || dv_dim < 1 || width > 128 || L < 1 || L > max_seq_len) return cudaErrorInvalidValue;
  if (width <= 16) return dispatch<1>(which, a, B, st);
  if (width <= 32) return dispatch<2>(which, a, B, st);
  if (width <= 64) return dispatch<4>(which, a, B, st);
  return dispatch<8>(which, a, B, st);
}

}  // namespace

// All three take the same arguments.  q, k, g-shaped (B, H, L, dqk / dv)
// inputs and outputs are fp32 and contiguous; pos_w (2*max_seq_len-1, H),
// ts_w (num_buckets+1, H); thr (num_buckets+1,) int32; ts (B, L) int32 or
// null (position bias only); mask (B, L) bool or null (all keys valid).
// Outputs a kernel does not produce are ignored (pass null).  dq of
// hstu_rab_bwd, and dpos / dts, must be zeroed by the caller: they are
// accumulated with atomics.  Each returns the cudaError_t of its launch.
extern "C" int hstu_rab_bwd(const void* q, const void* k, const void* v, const void* g, const void* pos_w,
                            const void* ts_w, const void* thr, const void* ts, const void* mask, void* dq, void* dk,
                            void* dv, void* dpos, void* dts, int B, int H, int L, int dqk, int dv_dim,
                            int max_seq_len, int num_buckets, float alpha, void* stream) {
  return run(0, q, k, v, g, pos_w, ts_w, thr, ts, mask, dq, dk, dv, dpos, dts, B, H, L, dqk, dv_dim, max_seq_len,
             num_buckets, alpha, stream);
}

extern "C" int hstu_rab_bwd_dq(const void* q, const void* k, const void* v, const void* g, const void* pos_w,
                               const void* ts_w, const void* thr, const void* ts, const void* mask, void* dq, void* dk,
                               void* dv, void* dpos, void* dts, int B, int H, int L, int dqk, int dv_dim,
                               int max_seq_len, int num_buckets, float alpha, void* stream) {
  return run(1, q, k, v, g, pos_w, ts_w, thr, ts, mask, dq, dk, dv, dpos, dts, B, H, L, dqk, dv_dim, max_seq_len,
             num_buckets, alpha, stream);
}

extern "C" int hstu_rab_bwd_dkv(const void* q, const void* k, const void* v, const void* g, const void* pos_w,
                                const void* ts_w, const void* thr, const void* ts, const void* mask, void* dq, void* dk,
                                void* dv, void* dpos, void* dts, int B, int H, int L, int dqk, int dv_dim,
                                int max_seq_len, int num_buckets, float alpha, void* stream) {
  return run(2, q, k, v, g, pos_w, ts_w, thr, ts, mask, dq, dk, dv, dpos, dts, B, H, L, dqk, dv_dim, max_seq_len,
             num_buckets, alpha, stream);
}

extern "C" const char* hstu_rab_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
