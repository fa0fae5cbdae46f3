// HSTU silu attention with a materialised bias: forward, hand-written for
// Hopper (sm_90a), fp32 in and out.
//
// Replaces the TPU kernel torch_rechub_tpu/ops/pallas/hstu_attention.py:
// _fwd_kernel.  For every (b, h, l):
//
//   out[b,h,l,:] = sum_{m <= l, mask[b,m]} silu(alpha * q[b,h,l,:].k[b,h,m,:] + bias[b',h,l,m]) / norm * v[b,h,m,:]
//
// with b' = b for a per-batch bias (B, H, L, L) and b' = 0 for a shared
// (1, H, L, L) one (the TPU indexes it by the flat batch*head index mod H).
// Only a valid pair (l < L, m <= l, key m unmasked) reaches arithmetic:
// any other pair's p is 0, and its bias, whether copied into shared memory
// or not, is never read into arithmetic.  So a NaN or inf in the upper
// triangle or at a masked key cannot reach the output, and a fully masked
// row yields zeros.  No softmax: the accumulator is a plain sum.
//
// What bounds it on an H100: bytes.  At the serving shape (B8 H8 L256,
// dqk = dv = 32, a per-batch bias) the valid pairs read about 8 MB of the
// bias's lower triangle beside 8.4 MB of q/k/v/out, 0.0047 ms at 3.35 TB/s,
// against 0.25 GFLOP of products, 0.0015 ms as 3xTF32 on the tensor cores
// (3 passes at 495 TFLOP/s).  What the kernel really spends is the
// per-score work the tensor cores do not do (mask, bias, silu) and
// latency, which is why the design fills the card with warps.
//
// Design: K1's (csrc/hstu_rab_fwd.cu), with the bias tile in place of the
// position and time tables and the bucket lookup.
// - Products on tensor cores: S = Q K^T and O += P V with mma.sync m16n8k8
//   TF32, each operand split into a TF32 high part and residual (3xTF32),
//   so fp32 accuracy holds.
// - P stays in registers: the accumulator fragment of S (rows g, g+8;
//   columns 2t, 2t+1) is the A fragment of P V once the keys of each
//   8-column group are read in the order 0,2,4,6,1,3,5,7; V's rows for the
//   B fragment are loaded in that order.
// - CTA = 8 warps over a 32-row q tile: 2 row groups of 16 x 4 key splits,
//   each warp 16 of every 64 staged keys (8 of 32 where two 64-key stages
//   do not fit, as at dqk 256 with dv 128); the four partial outputs are
//   summed in the fixed order (0 + 2) + (1 + 3): no atomics, the same bits
//   every run.  At the serving shape that is 512 CTAs, issued heaviest q
//   tile first (grid y reversed).
// - K, V, the mask words and the bias tile (32 rows x the stage's keys) of
//   the next key tile are copied with cp.async into a two-stage ring while
//   the current tile's math runs: one __syncthreads per tile.  The bias
//   copy (copy_causal_tile, hstu_rab_common.cuh) moves 16-byte chunks where
//   L % 4 == 0 and the bias is 16-byte aligned, else 4-byte ones; it
//   zero-fills past L in both dimensions and reads no chunk that lies
//   wholly above its row's diagonal.  Tiles above the causal frontier are
//   never issued.  The mask words are found from the bytes' address, so a
//   mask view at any byte offset is read right.
// - Row strides: K, V and Q 4 mod 8 words (fragment loads free of bank
//   conflicts, as in K1); the bias tile keys + 8, which is 8 mod 32 words:
//   a lane reads keys 2t, 2t+1 of rows g and g+8 as two 8-byte loads, and
//   the 16 lanes of each half-warp (4 rows x 4 lanes) cover all 32 banks.
// - Shared memory does not grow with L; widths that are not a multiple of
//   8 are zero-padded in shared memory; rows and keys past L are masked
//   here: any L, dqk <= 256 and dv <= 128, no host padding.
// The first design (PR 3: fp32 FMAs over a 64 x 64 tile per 256-thread
// CTA, Q and K staged transposed by scalar loads, the bias by predicated
// scalar loads into a shared P tile, three barriers per key tile, 256 CTAs
// at the serving shape issued lightest first) took 0.0549 ms there.
// Registers, shared memory and CTAs per SM: ptxas's report in the build log
// (chip_smoke.py prints it, with hstu_attn_fwd_occupancy).

#include "hstu_rab_common.cuh"

namespace {

using namespace rab;

constexpr int kRowGroups = 2;                        // 16-row groups per CTA
constexpr int kKeySplits = 4;                        // warps sharing a row group, each its own keys
constexpr int kBlockQ = 16 * kRowGroups;             // q rows per CTA
constexpr int kWarps = kRowGroups * kKeySplits;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxNt = 64 / 8 / kKeySplits;          // 8-key n-tiles per warp of a 64-key stage
constexpr int kMaxGridY = 65535;                     // q tiles: L <= 2,097,120
static_assert(kKeySplits == 4, "the partial outputs are summed as (0 + 2) + (1 + 3)");

struct Params {
  const float *q, *k, *v, *bias;
  const uint8_t* mask;
  float* out;
  int B, H, L, dqk, dv, shared_bias;
  float alpha, norm;
  int block_k;             // keys per stage: 64, or 32 where two 64-key stages do not fit
  int stages;              // the K/V/bias ring: 2 (tools/rab_kernel_ablation.py times 1: the next tile copied once this one is consumed)
  int ldk, ldv, ldb;       // shared row strides: 4 mod 8 words (Q, K, V), 8 mod 32 (the bias tile)
  int vec_k, vec_v, vec_b; // 16-byte copies for q/k, v and the bias
};

inline int stride_of(int width) { return ((width + 7) & ~7) + 4; }

// Shared memory, in 4-byte words (each part a multiple of 4 words):
//   Q [kBlockQ][ldk]
//   stages x { K [bk][ldk]  V [bk][ldv]  bias [kBlockQ][ldb]  mask words [bk/4 + 4] },
//   the stages also holding two slots of partial outputs per row group at
//   the end.
struct Layout {
  int q, stage, stage_words, k, v, b, km, total;
};

__host__ __device__ inline Layout layout(const Params& p) {
  Layout o;
  o.q = 0;
  o.stage = o.q + kBlockQ * p.ldk;
  o.k = 0;
  o.v = o.k + p.block_k * p.ldk;
  o.b = o.v + p.block_k * p.ldv;
  o.km = o.b + kBlockQ * p.ldb;
  o.stage_words = o.km + p.block_k / 4 + 4;
  int stages = p.stages * o.stage_words;
  const int partials = 2 * kRowGroups * 16 * p.ldv;  // two slots per row group
  if (partials > stages) stages = partials;
  o.total = o.stage + stages;
  return o;
}

template <int NV>  // output n-tiles of 8 columns per warp: dv <= 8 * NV
__global__ void __launch_bounds__(kThreads, NV <= 4 ? 3 : 2) hstu_attn_fwd_kernel(Params p) {
  extern __shared__ __align__(16) float smem[];
  const Layout lay = layout(p);
  float* Qs = smem + lay.q;
  float* stages = smem + lay.stage;

  const int L = p.L, ldk = p.ldk, ldv = p.ldv, ldb = p.ldb, BK = p.block_k;
  const int bh = blockIdx.x, b = bh / p.H, h = bh - b * p.H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlockQ;  // heaviest q tiles first
  const int q_end = min(q0 + kBlockQ, L);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int rg = warp % kRowGroups, ks = warp / kRowGroups;
  const float* qb = p.q + (size_t)bh * L * p.dqk;
  const float* kb = p.k + (size_t)bh * L * p.dqk;
  const float* vb = p.v + (size_t)bh * L * p.dv;
  const float* bb = p.bias + (size_t)(p.shared_bias ? h : bh) * L * L;
  const int dk8 = (p.dqk + 7) >> 3, nvt = (p.dv + 7) >> 3;
  const int kw = BK / kKeySplits, n_nt = kw >> 3;  // keys per warp per stage, in 8-key n-tiles
  const bool ring = p.stages == 2;

  auto stage_ptr = [&](int s) { return stages + s * lay.stage_words; };
  auto issue = [&](int kt, int s) {
    float* st = stage_ptr(s);
    const int k0 = kt * BK;
    copy_rows(st + lay.k, ldk, kb, k0, BK, L, p.dqk, p.vec_k, tid, kThreads);
    copy_rows(st + lay.v, ldv, vb, k0, BK, L, p.dv, p.vec_v, tid, kThreads);
    copy_causal_tile(st + lay.b, ldb, bb, q0, kBlockQ, k0, BK, L, p.vec_b, tid, kThreads);
    if (p.mask != nullptr) copy_mask(reinterpret_cast<int*>(st + lay.km), p.mask, (size_t)p.B * L, (size_t)b * L + k0, BK, tid);
  };

  // Zero the padding columns that no copy writes (dqk .. 8*dk8, dv .. 8*nvt)
  // of Q and of the stages; then the Q tile and the first key tile.
  for (int r = tid; r < kBlockQ + p.stages * BK; r += kThreads) {
    float* row = r < kBlockQ ? Qs + r * ldk : stage_ptr((r - kBlockQ) / BK) + lay.k + ((r - kBlockQ) % BK) * ldk;
    for (int d = p.dqk; d < 8 * dk8; ++d) row[d] = 0.f;
    if (r >= kBlockQ) {
      float* vrow = stage_ptr((r - kBlockQ) / BK) + lay.v + ((r - kBlockQ) % BK) * ldv;
      for (int d = p.dv; d < 8 * nvt; ++d) vrow[d] = 0.f;
    }
  }
  copy_rows(Qs, ldk, qb, q0, kBlockQ, L, p.dqk, p.vec_k, tid, kThreads);
  issue(0, 0);
  cp_commit();

  float o[NV][4];
#pragma unroll
  for (int j = 0; j < NV; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;

  const int r0 = q0 + 16 * rg;              // this warp's first row
  const int r_last = min(r0 + 15, L - 1);   // its last real row
  const int n_kt = (q_end - 1) / BK + 1;    // k tiles up to the causal frontier
  for (int kt = 0; kt < n_kt; ++kt) {
    cp_wait_all();
    __syncthreads();  // tile kt is visible to all; every warp is done with tile kt-1's stage
    if (ring) {
      if (kt + 1 < n_kt) issue(kt + 1, (kt + 1) & 1);
      cp_commit();
    }

    const float* st = stage_ptr(ring ? kt & 1 : 0);
    const float* Ks = st + lay.k;
    const float* Vs = st + lay.v;
    const uint8_t* km =
        reinterpret_cast<const uint8_t*>(st + lay.km) + (p.mask != nullptr ? mask_offset(p.mask, (size_t)b * L + kt * BK) : 0);
    const int c0 = ks * kw, m0 = kt * BK + c0;  // this warp's first key
    if (r0 < L && m0 <= r_last) {              // warp-uniform: some pair with m <= l
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

      // scores -> P in place: s[nt][i] is row r0 + g + 8*(i>>1), key m0 + 8nt + 2t + (i&1);
      // this lane's bias: keys 2t, 2t+1 of rows g and g+8 of each n-tile
      const float* brow[2] = {st + lay.b + (16 * rg + g) * ldb + c0 + 2 * t, st + lay.b + (16 * rg + g + 8) * ldb + c0 + 2 * t};
#pragma unroll
      for (int nt = 0; nt < kMaxNt; ++nt) {
        if (nt < n_nt) {
          const float2 b_lo = *reinterpret_cast<const float2*>(brow[0] + 8 * nt);
          const float2 b_hi = *reinterpret_cast<const float2*>(brow[1] + 8 * nt);
          const float bias[4] = {b_lo.x, b_lo.y, b_hi.x, b_hi.y};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int l = r0 + g + 8 * (i >> 1);
            const int c = c0 + 8 * nt + 2 * t + (i & 1);
            const int m = kt * BK + c;
            float pv = 0.f;
            if (l < L && m <= l && (p.mask == nullptr || km[c])) {
              const float x = fmaf(s[nt][i], p.alpha, bias[i]);
              pv = __fdividef(x, (1.f + __expf(-x)) * p.norm);  // exp overflow: x / inf = -0
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
    if (!ring) {
      __syncthreads();  // the stage is consumed
      if (kt + 1 < n_kt) issue(kt + 1, 0);
      cp_commit();
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

// 64-key stages, or 32-key ones where two 64-key stages do not fit; the
// bias tile's row stride keys + 8 (8 mod 32 words) either way
size_t fit(Params& p) {
  p.stages = 2;
  const int keys[2] = {64, 32};
  size_t smem = 0;
  for (const int bk : keys) {
    p.block_k = bk;
    p.ldb = bk + 8;
    smem = sizeof(float) * layout(p).total;
    if (smem <= kMaxSmem) break;
  }
  return smem;
}

template <int NV>
cudaError_t launch(Params p, cudaStream_t stream, int* info) {
  const size_t smem = fit(p);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(hstu_attn_fwd_kernel<NV>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  if (info != nullptr) return occupancy(hstu_attn_fwd_kernel<NV>, kThreads, smem, info);
  const dim3 grid(p.B * p.H, (p.L + kBlockQ - 1) / kBlockQ);
  hstu_attn_fwd_kernel<NV><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

int run(const void* q, const void* k, const void* v, const void* bias, const void* mask, void* out, int B, int H, int L,
        int dqk, int dv, int shared_bias, float alpha, float norm, void* stream, int* info) {
  Params p;
  p.q = static_cast<const float*>(q);
  p.k = static_cast<const float*>(k);
  p.v = static_cast<const float*>(v);
  p.bias = static_cast<const float*>(bias);
  p.mask = static_cast<const uint8_t*>(mask);
  p.out = static_cast<float*>(out);
  p.B = B;
  p.H = H;
  p.L = L;
  p.dqk = dqk;
  p.dv = dv;
  p.shared_bias = shared_bias;
  p.alpha = alpha;
  p.norm = norm;
  p.ldk = stride_of(dqk);
  p.ldv = stride_of(dv);
  const auto aligned = [](const void* ptr) { return ((uintptr_t)ptr & 15) == 0; };
  p.vec_k = dqk % 4 == 0 && aligned(q) && aligned(k);
  p.vec_v = dv % 4 == 0 && aligned(v);
  p.vec_b = L % 4 == 0 && aligned(bias);  // then every 4-key chunk is 16-byte aligned, and wholly inside or past L
  auto st = static_cast<cudaStream_t>(stream);
  if (dv < 1 || dv > 128 || dqk < 1 || dqk > 256 || L < 1 || (L + kBlockQ - 1) / kBlockQ > kMaxGridY || B * H < 1)
    return cudaErrorInvalidValue;
  if (dv <= 8) return launch<1>(p, st, info);
  if (dv <= 16) return launch<2>(p, st, info);
  if (dv <= 32) return launch<4>(p, st, info);
  if (dv <= 64) return launch<8>(p, st, info);
  return launch<16>(p, st, info);
}

}  // namespace

// q, k: (B, H, L, dqk); v, out: (B, H, L, dv); bias: (B, H, L, L), or
// (1, H, L, L) when shared_bias is nonzero; all fp32, contiguous.  mask:
// (B, L) bool or null (all keys valid).  norm: the silu normaliser
// (max_seq_len).  Returns the cudaError_t of the launch (0 on success).
extern "C" int hstu_attn_fwd(const void* q, const void* k, const void* v, const void* bias, const void* mask, void* out,
                             int B, int H, int L, int dqk, int dv, int shared_bias, float alpha, float norm,
                             void* stream) {
  return run(q, k, v, bias, mask, out, B, H, L, dqk, dv, shared_bias, alpha, norm, stream, nullptr);
}

// The kernel that this shape would launch, without launching it: info[0]
// resident CTAs per SM, info[1] registers per thread, info[2] dynamic
// shared memory bytes per CTA.  Returns the cudaError_t.
extern "C" int hstu_attn_fwd_occupancy(int L, int dqk, int dv, int* info) {
  return run(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, 1, 1, L, dqk, dv, 0, 1.f, 1.f, nullptr, info);
}

extern "C" const char* hstu_attn_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }
