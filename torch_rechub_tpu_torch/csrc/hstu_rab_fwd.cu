// HSTU silu attention with on-the-fly relative position/time bias: forward,
// hand-written for Hopper (sm_90a), fp32 in and out.
//
// Replaces the TPU kernel torch_rechub_tpu/ops/pallas/hstu_rab_attention.py:
// _fwd_kernel.  For every (b, h, l):
//
//   out[b,h,l,:] = sum_{m <= l, mask[b,m]} silu(s_lm) / max_seq_len * v[b,h,m,:]
//   s_lm = alpha * q[b,h,l,:].k[b,h,m,:] + (pos_w[m-l+maxL-1, h] + ts_w[bucket(t_l - t_m), h])
//
// bucket() is exact: a guess from the f32 steps of bucketize_time, moved
// to the largest u with thr[u] <= |t_l - t_m| against the host's integer
// thresholds (hstu_rab_common.cuh).  Masked pairs contribute 0 (silu of
// -1e4 is -0): a fully masked row yields zeros, never NaN.  There is no
// softmax, hence no running max or denominator: the accumulator is a sum.
//
// What bounds it on an H100: at the serving shape (B8 H8 L256, dqk = dv =
// 32) the valid pairs need 0.25 GFLOP of products against 8.4 MB of
// q/k/v/out.  On the tensor cores in 3xTF32 (3 passes at 495 TFLOP/s) the
// products take 0.0015 ms and the bytes 0.0025 ms at 3.35 TB/s, so the
// least time is bytes.  What the kernel really spends is the per-score
// work the tensor cores do not do (bias, bucket, silu) and latency, which
// is why the design fills the card with warps.
//
// Design (the earlier version: fp32 FMAs on a 64 x 64 tile per 256-thread
// CTA, registers-staged transposed tiles, a binary search per score):
// - Products on tensor cores: S = Q K^T and O += P V with mma.sync m16n8k8
//   TF32, each operand split into a TF32 high part and residual (3xTF32),
//   so fp32 accuracy holds.  mma.sync rather than wgmma: a warp owns 16
//   rows and 16 keys, far below wgmma's 64-row tile, and wgmma takes TF32
//   operands only from K-major shared memory, which P (in registers) is not.
// - P stays in registers: the accumulator fragment of S (rows g, g+8;
//   columns 2t, 2t+1) is the A fragment of P V once the keys of each
//   8-column group are read in the order 0,2,4,6,1,3,5,7; V's rows for the
//   B fragment are loaded in that order.
// - CTA = 8 warps over a 32-row q tile: 2 row groups of 16 x 4 key splits,
//   each warp 16 of every 64 staged keys (8 of 32 for wide heads or long
//   sequences); the four partial outputs are summed in a fixed order at the
//   end.  At the serving
//   shape that is 512 CTAs and 4096 warps, issued heaviest q tile first
//   (grid y reversed), so the causal imbalance is spread over the card and
//   no warp walks more than a quarter of its row's keys.
// - K, V, the key stamps and the mask bytes of the next tile are copied with
//   cp.async (16-byte .cg, zero-filled past L) into a two-stage ring while
//   the current tile's math runs: one __syncthreads per tile.  The mask
//   words are found from the bytes' address, so a mask view at any byte
//   offset is read right.  Tiles keep
//   the row-major layout the fragments read, with a row stride of 4 mod 8
//   words, so fragment loads are free of bank conflicts.
// - Widths that are not a multiple of 8 are zero-padded in shared memory;
//   rows and keys past L are masked here: no host padding.
// Registers, shared memory and CTAs per SM: ptxas's report in the build log
// (chip_smoke.py prints it, with cudaOccupancyMaxActiveBlocksPerMultiprocessor).

#include "hstu_rab_common.cuh"
#include "hstu_wide.cuh"

namespace {

using namespace rab;

constexpr int kRowGroups = 2;                        // 16-row groups per CTA
constexpr int kKeySplits = 4;                        // warps sharing a row group, each its own keys
constexpr int kBlockQ = 16 * kRowGroups;             // q rows per CTA
constexpr int kWarps = kRowGroups * kKeySplits;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxNt = 64 / 8 / kKeySplits;          // 8-key n-tiles per warp of a 64-key stage
static_assert(kKeySplits == 4, "the partial outputs are summed as (0 + 2) + (1 + 3)");

struct Params {
  const float *q, *k, *v, *pos_w, *ts_w;
  const int *thr, *ts;
  const uint8_t* mask;
  float* out;
  int B, H, L, dqk, dv, max_seq_len;
  float alpha;
  Buckets bk;
  int block_k;      // keys per stage: 64, or 32 where two 64-key stages do not fit (wide heads, long L)
  int ldk, ldv;     // shared row strides, 4 mod 8 words
  int vec_k, vec_v; // 16-byte copies for q/k and v
};

inline int stride_of(int width) { return ((width + 7) & ~7) + 4; }

// Shared memory, in 4-byte words (each part a multiple of 4 words):
//   Q [kBlockQ][ldk]  tq [kBlockQ]  pw [L]  tw [nb+1]  thr [nb+1]
//   2 stages of { K [bk][ldk]  V [bk][ldv]  tk [bk]  mask words [bk/4 + 4] },
//   the stages also holding two slots of partial outputs per row group at
//   the end.  With 32-key stages this is never more than the first design
//   (fp32 FMAs over 64 x 64 tiles) took, so K1 takes every shape it took;
//   a wider head, or a shape that still does not fit, takes the width-tiled
//   variant (hstu_wide.cuh).
struct Layout {
  int q, tq, pw, tw, th, stage, stage_words, k, v, tk, km, total;
};

__host__ __device__ inline Layout layout(int block_k, int ldk, int ldv, int L, int nb) {
  Layout o;
  o.q = 0;
  o.tq = o.q + kBlockQ * ldk;
  o.pw = o.tq + kBlockQ;
  o.tw = o.pw + ((L + 3) & ~3);
  o.th = o.tw + ((nb + 1 + 3) & ~3);
  o.stage = o.th + ((nb + 1 + 3) & ~3);
  o.k = 0;
  o.v = o.k + block_k * ldk;
  o.tk = o.v + block_k * ldv;
  o.km = o.tk + block_k;
  o.stage_words = o.km + block_k / 4 + 4;
  int stages = 2 * o.stage_words;
  const int partials = 2 * kRowGroups * 16 * ldv;  // two slots per row group
  if (partials > stages) stages = partials;
  o.total = o.stage + stages;
  return o;
}

template <int NV>  // output n-tiles of 8 columns per warp: dv <= 8 * NV
__global__ void __launch_bounds__(kThreads, NV <= 4 ? 3 : 2) hstu_rab_fwd_kernel(Params p) {
  extern __shared__ __align__(16) float smem[];
  const Layout lay = layout(p.block_k, p.ldk, p.ldv, p.L, p.bk.nb);
  float* Qs = smem + lay.q;
  int* tq = reinterpret_cast<int*>(smem + lay.tq);
  float* pw = smem + lay.pw;
  float* tw = smem + lay.tw;
  int* th = reinterpret_cast<int*>(smem + lay.th);
  float* stages = smem + lay.stage;

  const int L = p.L, ldk = p.ldk, ldv = p.ldv, BK = p.block_k;
  const int bh = blockIdx.x, b = bh / p.H, h = bh - b * p.H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlockQ;  // heaviest q tiles first
  const int q_end = min(q0 + kBlockQ, L);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int rg = warp % kRowGroups, ks = warp / kRowGroups;
  const bool has_time = p.ts != nullptr;
  const float* qb = p.q + (size_t)bh * L * p.dqk;
  const float* kb = p.k + (size_t)bh * L * p.dqk;
  const float* vb = p.v + (size_t)bh * L * p.dv;
  const int* tsb = has_time ? p.ts + (size_t)b * L : nullptr;
  const int dk8 = (p.dqk + 7) >> 3, nvt = (p.dv + 7) >> 3;
  const int kw = BK / kKeySplits, n_nt = kw >> 3;  // keys per warp per stage, in 8-key n-tiles
  const float norm = (float)p.max_seq_len;
  const Lookup bucket(th, p.bk);

  auto stage_ptr = [&](int s) { return stages + s * lay.stage_words; };
  auto issue = [&](int kt) {
    float* st = stage_ptr(kt & 1);
    const int k0 = kt * BK;
    copy_rows(st + lay.k, ldk, kb, k0, BK, L, p.dqk, p.vec_k, tid, kThreads);
    copy_rows(st + lay.v, ldv, vb, k0, BK, L, p.dv, p.vec_v, tid, kThreads);
    if (has_time) copy_stamps(reinterpret_cast<int*>(st + lay.tk), tsb, k0, BK, L, tid);
    if (p.mask != nullptr) copy_mask(reinterpret_cast<int*>(st + lay.km), p.mask, (size_t)p.B * L, (size_t)b * L + k0, BK, tid);
  };

  // Zero the padding columns that no copy writes (dqk .. 8*dk8, dv .. 8*nvt)
  // of Q and of both stages; then the Q tile, its stamps and the first k tile.
  for (int r = tid; r < kBlockQ + 2 * BK; r += kThreads) {
    float* row = r < kBlockQ ? Qs + r * ldk : stage_ptr((r - kBlockQ) / BK) + lay.k + ((r - kBlockQ) % BK) * ldk;
    for (int d = p.dqk; d < 8 * dk8; ++d) row[d] = 0.f;
    if (r >= kBlockQ) {
      float* vrow = stage_ptr((r - kBlockQ) / BK) + lay.v + ((r - kBlockQ) % BK) * ldv;
      for (int d = p.dv; d < 8 * nvt; ++d) vrow[d] = 0.f;
    }
  }
  copy_rows(Qs, ldk, qb, q0, kBlockQ, L, p.dqk, p.vec_k, tid, kThreads);
  if (has_time) copy_stamps(tq, tsb, q0, kBlockQ, L, tid);
  issue(0);
  cp_commit();
  for (int d = tid; d < q_end; d += kThreads) pw[d] = p.pos_w[(size_t)(p.max_seq_len - 1 - d) * p.H + h];
  if (has_time)
    for (int u = tid; u <= p.bk.nb; u += kThreads) {
      tw[u] = p.ts_w[(size_t)u * p.H + h];
      th[u] = p.thr[u];
    }

  float o[NV][4];
#pragma unroll
  for (int j = 0; j < NV; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;

  const int r0 = q0 + 16 * rg;              // this warp's first row
  const int r_last = min(r0 + 15, L - 1);   // its last real row
  const int n_kt = (q_end - 1) / BK + 1;    // k tiles up to the causal frontier
  for (int kt = 0; kt < n_kt; ++kt) {
    cp_wait_all();
    __syncthreads();  // tile kt is visible to all; every warp is done with tile kt-1's stage
    if (kt + 1 < n_kt) issue(kt + 1);
    cp_commit();

    const float* st = stage_ptr(kt & 1);
    const float* Ks = st + lay.k;
    const float* Vs = st + lay.v;
    const int* tk = reinterpret_cast<const int*>(st + lay.tk);
    const uint8_t* km =
        reinterpret_cast<const uint8_t*>(st + lay.km) + (p.mask != nullptr ? mask_offset(p.mask, (size_t)b * L + kt * BK) : 0);
    const int c0 = ks * kw, m0 = kt * BK + c0;  // this warp's first key
    if (r0 >= L || m0 > r_last) continue;      // no valid pair: all keys after all rows

    float s[kMaxNt][4];
#pragma unroll
    for (int nt = 0; nt < kMaxNt; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
    for (int dd = 0; dd < dk8; ++dd) {
      uint32_t ah[4], al[4];
      load_a(Qs, ldk, 16 * rg, 8 * dd, g, t, ah, al);
#pragma unroll
      for (int nt = 0; nt < kMaxNt; ++nt) {
        if (nt < n_nt) {
          const float* kp = Ks + (c0 + 8 * nt + g) * ldk + 8 * dd + t;
          uint32_t bh_[2], bl_[2];
          split(kp[0], bh_[0], bl_[0]);
          split(kp[4], bh_[1], bl_[1]);
          mma3(s[nt], ah, al, bh_, bl_);
        }
      }
    }

    // scores -> P in place: s[nt][i] is row g + 8*(i>>1), key c0 + 8nt + 2t + (i&1)
    const int tq_r[2] = {has_time ? tq[16 * rg + g] : 0, has_time ? tq[16 * rg + g + 8] : 0};
#pragma unroll
    for (int nt = 0; nt < kMaxNt; ++nt) {
      if (nt < n_nt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int l = r0 + g + 8 * (i >> 1);
          const int c = c0 + 8 * nt + 2 * t + (i & 1);
          const int m = kt * BK + c;
          float pv = 0.f;
          if (l < L && m <= l && (p.mask == nullptr || km[c])) {
            float x = pw[l - m];
            if (has_time) x += tw[bucket(tq_r[i >> 1], tk[c])];
            x = fmaf(s[nt][i], p.alpha, x);
            pv = __fdividef(x, (1.f + __expf(-x)) * norm);  // exp overflow: x / inf = -0
          }
          s[nt][i] = pv;
        }
      }
    }

    // O += P V: keys 2t and 2t+1 of each 8-key group are A columns t and t+4
#pragma unroll
    for (int kk = 0; kk < kMaxNt; ++kk) {
      if (kk < n_nt) {
        uint32_t ah[4], al[4];
        split(s[kk][0], ah[0], al[0]);
        split(s[kk][2], ah[1], al[1]);
        split(s[kk][1], ah[2], al[2]);
        split(s[kk][3], ah[3], al[3]);
        const float* vp = Vs + (c0 + 8 * kk + 2 * t) * ldv + g;
#pragma unroll
        for (int j = 0; j < NV; ++j) {
          if (j < nvt) {
            uint32_t bh_[2], bl_[2];
            split(vp[8 * j], bh_[0], bl_[0]);
            split(vp[ldv + 8 * j], bh_[1], bl_[1]);
            mma3(o[j], ah, al, bh_, bl_);
          }
        }
      }
    }
  }

  // Sum the key splits' partial outputs in a fixed order, (0 + 2) + (1 + 3),
  // through two slots per row group: splits 2 and 3 hand theirs to 0 and 1,
  // then split 1 its sum to split 0
  cp_wait_all();
  __syncthreads();  // the stages are free
  auto slot = [&](int i) { return stages + (i * kRowGroups + rg) * 16 * ldv; };
  auto put = [&](float* dst) {
#pragma unroll
    for (int j = 0; j < NV; ++j)
      if (j < nvt) {
        dst[g * ldv + 8 * j + 2 * t] = o[j][0];
        dst[g * ldv + 8 * j + 2 * t + 1] = o[j][1];
        dst[(g + 8) * ldv + 8 * j + 2 * t] = o[j][2];
        dst[(g + 8) * ldv + 8 * j + 2 * t + 1] = o[j][3];
      }
  };
  auto take = [&](const float* src) {
#pragma unroll
    for (int j = 0; j < NV; ++j)
      if (j < nvt) {
        o[j][0] += src[g * ldv + 8 * j + 2 * t];
        o[j][1] += src[g * ldv + 8 * j + 2 * t + 1];
        o[j][2] += src[(g + 8) * ldv + 8 * j + 2 * t];
        o[j][3] += src[(g + 8) * ldv + 8 * j + 2 * t + 1];
      }
  };
  if (ks >= 2) put(slot(ks - 2));
  __syncthreads();
  if (ks < 2) take(slot(ks));
  __syncthreads();
  if (ks == 1) put(slot(0));
  __syncthreads();
  if (ks == 0 && r0 < L) {
    take(slot(0));
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int l = r0 + g + 8 * i;
      if (l < L) {
        float* dst = p.out + ((size_t)bh * L + l) * p.dv;
#pragma unroll
        for (int j = 0; j < NV; ++j) {
          const int c = 8 * j + 2 * t;
          if (c < p.dv) dst[c] = o[j][2 * i];
          if (c + 1 < p.dv) dst[c + 1] = o[j][2 * i + 1];
        }
      }
    }
  }
}

template <int NV>
cudaError_t launch(Params p, cudaStream_t stream, int* info) {
  const int nb = p.bk.nb;
  p.block_k = 64;
  size_t smem = sizeof(float) * layout(64, p.ldk, p.ldv, p.L, nb).total;
  if (smem > kMaxSmem) {
    p.block_k = 32;
    smem = sizeof(float) * layout(32, p.ldk, p.ldv, p.L, nb).total;
  }
  if (smem > kMaxSmem) return kNoFit;
  cudaError_t err = cudaFuncSetAttribute(hstu_rab_fwd_kernel<NV>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  if (info != nullptr) return occupancy(hstu_rab_fwd_kernel<NV>, kThreads, smem, info);
  const dim3 grid(p.B * p.H, (p.L + kBlockQ - 1) / kBlockQ);
  hstu_rab_fwd_kernel<NV><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

int run_narrow(const void* q, const void* k, const void* v, const void* pos_w, const void* ts_w, const void* thr,
               const void* ts, const void* mask, void* out, int B, int H, int L, int dqk, int dv, int max_seq_len,
               int num_buckets, float alpha, int fn_log, int minutes, float divisor, void* stream, int* info) {
  if (dv > 128 || dqk > 256) return kNoFit;
  Params p;
  p.q = static_cast<const float*>(q);
  p.k = static_cast<const float*>(k);
  p.v = static_cast<const float*>(v);
  p.pos_w = static_cast<const float*>(pos_w);
  p.ts_w = static_cast<const float*>(ts_w);
  p.thr = static_cast<const int*>(thr);
  p.ts = static_cast<const int*>(ts);
  p.mask = static_cast<const uint8_t*>(mask);
  p.out = static_cast<float*>(out);
  p.B = B;
  p.H = H;
  p.L = L;
  p.dqk = dqk;
  p.dv = dv;
  p.max_seq_len = max_seq_len;
  p.alpha = alpha;
  p.bk = Buckets{num_buckets, fn_log, minutes, divisor};
  p.ldk = stride_of(dqk);
  p.ldv = stride_of(dv);
  const auto aligned = [](const void* ptr) { return ((uintptr_t)ptr & 15) == 0; };
  p.vec_k = dqk % 4 == 0 && aligned(q) && aligned(k);
  p.vec_v = dv % 4 == 0 && aligned(v);
  auto st = static_cast<cudaStream_t>(stream);
  if (dv <= 8) return launch<1>(p, st, info);
  if (dv <= 16) return launch<2>(p, st, info);
  if (dv <= 32) return launch<4>(p, st, info);
  if (dv <= 64) return launch<8>(p, st, info);
  return launch<16>(p, st, info);
}

// The tensor-core kernel where it takes the shape, else the width-tiled variant (hstu_wide.cuh)
int run(const void* q, const void* k, const void* v, const void* pos_w, const void* ts_w, const void* thr,
        const void* ts, const void* mask, void* out, int B, int H, int L, int dqk, int dv, int max_seq_len,
        int num_buckets, float alpha, int fn_log, int minutes, float divisor, void* stream, int* info, int* taken) {
  if (dv < 1 || dqk < 1 || L < 1 || L > max_seq_len || num_buckets < 0) return cudaErrorInvalidValue;
  return wide::dispatch(
      [&] {
        return static_cast<cudaError_t>(run_narrow(q, k, v, pos_w, ts_w, thr, ts, mask, out, B, H, L, dqk, dv,
                                                   max_seq_len, num_buckets, alpha, fn_log, minutes, divisor, stream, info));
      },
      [&] {
        wide::Args w{};
        w.q = q, w.k = k, w.v = v;
        w.pos_w = static_cast<const float*>(pos_w), w.ts_w = static_cast<const float*>(ts_w);
        w.thr = static_cast<const int*>(thr), w.ts = static_cast<const int*>(ts);
        w.mask = static_cast<const uint8_t*>(mask), w.out0 = out;
        w.B = B, w.H = H, w.L = L, w.dqk = dqk, w.dv = dv, w.max_seq_len = max_seq_len;
        w.alpha = alpha, w.norm = (float)max_seq_len, w.bk = Buckets{num_buckets, fn_log, minutes, divisor};
        return wide::launch<float, wide::kFwd, true>(w, static_cast<cudaStream_t>(stream), info);
      },
      taken, info);
}

}  // namespace

// q, k: (B, H, L, dqk); v, out: (B, H, L, dv); pos_w: (2*max_seq_len-1, H);
// ts_w: (num_buckets+1, H); all fp32, contiguous.  thr: (num_buckets+1,) int32.
// ts: (B, L) int32 or null (position bias only); mask: (B, L) bool or null
// (all keys valid).  The bucket config: fn_log (0 sqrt, 1 log), minutes (1:
// |dt| / 60 first), divisor.  *taken (may be null): 0 the tensor-core kernel
// ran, 1 the width-tiled variant.  Returns the cudaError_t of the launch (0
// on success).
extern "C" int hstu_rab_fwd(const void* q, const void* k, const void* v, const void* pos_w, const void* ts_w,
                            const void* thr, const void* ts, const void* mask, void* out, int B, int H, int L,
                            int dqk, int dv, int max_seq_len, int num_buckets, float alpha, int fn_log, int minutes,
                            float divisor, void* stream, int* taken) {
  return run(q, k, v, pos_w, ts_w, thr, ts, mask, out, B, H, L, dqk, dv, max_seq_len, num_buckets, alpha, fn_log,
             minutes, divisor, stream, nullptr, taken);
}

// The kernel that this shape would launch, without launching it: info[0]
// resident CTAs per SM, info[1] registers per thread, info[2] dynamic
// shared memory bytes per CTA, info[4] 0 the tensor-core kernel, 1 the
// width-tiled variant (info holds 5 ints).  Returns the cudaError_t.
extern "C" int hstu_rab_fwd_occupancy(int L, int dqk, int dv, int max_seq_len, int num_buckets, int* info) {
  return run(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, 1, 1, L, dqk, dv,
             max_seq_len, num_buckets, 1.f, 0, 0, 1.f, nullptr, info, nullptr);
}

extern "C" const char* hstu_rab_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }
