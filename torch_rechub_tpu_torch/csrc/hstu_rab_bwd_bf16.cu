// HSTU silu attention with on-the-fly relative position/time bias: the three
// backward kernels, hand-written for Hopper (sm_90a), on bf16 inputs (the
// mixed-precision policy; the bias tables stay fp32).
//
// Replaces the TPU kernels of torch_rechub_tpu/ops/pallas/hstu_rab_attention.py
// on bf16 inputs:
//   K2  _bwd_fused_kernel -> hstu_rab_bwd_bf16      dq, dk, dv, dpos, dts in one pass
//   K2a _bwd_dq_kernel    -> hstu_rab_bwd_dq_bf16   dq, dpos, dts
//   K2b _bwd_dkv_kernel   -> hstu_rab_bwd_dkv_bf16  dk, dv
//
// With s and the valid pairs as in the forward (hstu_rab_fwd_bf16.cu),
// sig = sigmoid(s), N = max_seq_len and g = dL/dout (bf16), in f32:
//
//   P_lm = s sig / N          dA_lm = g_l . v_m
//   dS_lm = valid ? dA_lm sig (1 + s (1 - sig)) / N : 0
//   dv_m = sum_l bf16(P_lm) g_l          -> bf16
//   dk_m = alpha sum_l bf16(dS_lm) q_l   -> bf16
//   dq_l = alpha sum_m bf16(dS_lm) k_m   -> K2: f32 sums (the caller rounds to bf16); K2a: bf16
//   dpos[N-1-(l-m), h] += dS_lm          dts[bucket(t_l - t_m), h] += dS_lm   (f32, dS unrounded)
//
// which are the Pallas kernels' rounding points: attn and ds cast to the
// input dtype before the dv, dk and dq products, every product summed in
// f32, dq rounded once at the end.
//
// What bounds them on an H100, at B8 H8 L256, dqk = dv = 32 (1.96 M valid
// pairs), in bf16: K2 needs 0.63 GFLOP (0.0006 ms at 989 TFLOP/s) against
// 7.3 MB of bf16 q/k/v/g/dq/dk/dv (0.0022 ms at 3.35 TB/s); K2a 0.38 GFLOP
// against 5.2 MB of q/k/v/g/dq (0.0016 ms), K2b 0.50 GFLOP against 6.3 MB
// of q/k/v/g/dk/dv (0.0019 ms).  All three are
// bounded by bytes; what they really spend is the per-pair work the tensor
// cores do not do (bias, bucket, silu', the table sums) and latency.
//
// Design: the simple first one (no cp.async ring, no wgmma), m16n8k16 bf16
// mma.sync with f32 accumulators, operands staged in shared memory as bf16
// (16-byte loads where the width and address allow, else 2-byte ones: any
// element offset), widths padded with zeros to 16 and rows past L
// zero-filled; one stage, two barriers a tile.
//
// K2 and K2b (key_tile_body<N, kFull>, K2b being K2 with kFull = false: one
// body, so the two cannot drift apart; kFull compiles out the dS store and
// its barrier, the dQ products and atomics, the table sums and their shared
// memory):
// - CTA = 4 warps over a 64-key tile, each warp 16 keys; the CTA walks the
//   64-query tiles from the diagonal to L, low key tiles (which walk the
//   most) first.
// - S^T = K Q^T and dA^T = V G^T with the warp's keys as rows.  P^T and dS^T,
//   rounded to bf16 pairwise, are the A fragments of dV += P^T G and
//   dK += dS^T Q as they are (registers only).
// - K2's dQ: each warp stores its bf16 dS^T to shared memory as [query][key];
//   after a barrier, warp w forms dQ_part = dS K for queries 16w .. 16w+15
//   over the 64 keys and adds alpha dQ_part to the f32 dq with scalar
//   atomics (their order changes from run to run).
// - dK and dV of a key are summed by the one warp that owns it: the same bit
//   for bit from run to run, and K2b's equal K2's.
//
// K2a (bwd_q_kernel) keeps the TPU kernel's ownership: one CTA owns 64 q rows
// and walks the 64-key tiles up to the causal frontier, so dq is summed in
// f32 registers and written once in bf16, with no atomics and no zeroed
// output.  It is K1-bf16's loop (hstu_rab_fwd_bf16.cu) run backward:
// - CTA = 4 warps, each 16 rows, heaviest q tile first (grid y reversed).
// - S = Q K^T and dA = G V^T share one fragment layout, so dS is formed in
//   registers and, rounded to bf16 pairwise, is the A fragment of
//   dQ += dS K as is (K's B fragment pairs two rows of one column): dS never
//   touches shared memory, and dq is the same bit for bit from run to run.
//
// dpos and dts (K2 and K2a): K2's sums (hstu_rab_common.cuh), fragment pair by
// fragment pair, into shared tables (dts one copy per warp and lane column
// where they fit), flushed with one global atomic per nonzero slot into the
// zeroed outputs.  K2a sums by causal distance over its q tile's pairs
// (distances 0 .. q_end-1), as the fp32 K2a does.
// Registers and shared memory: ptxas's report in the build log, and
// hstu_rab_bwd_bf16_occupancy.

#include "hstu_rab_common.cuh"

namespace {

using namespace rab;
using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTileK = 16 * kWarps;  // K2 / K2b: keys per CTA; K2a: keys per stage
constexpr int kTileQ = 64;           // K2 / K2b: queries per q tile; K2a: q rows per CTA
constexpr int kLdS = kTileK + 8;     // dS [query][key] row stride in elements
constexpr int kTsCopies = 4 * kWarps;
static_assert(kTileK == 64 && kTileQ == 64, "8 n-tiles of 8, 4 k-steps of 16 a tile");

struct Args {
  const bf16 *q, *k, *v, *g;
  const float *pos_w, *ts_w;
  const int *thr, *ts;
  const uint8_t* mask;
  float* dq;   // K2: f32 sums
  bf16* dq16;  // K2a: written once
  bf16 *dk, *dv;
  float *dpos, *dts;
  int B, H, L, dqk, dv_dim, max_seq_len;
  float alpha;
  Buckets bk;
  int pk, pv;       // padded widths (multiples of 16)
  int ldk, ldv;     // shared row strides in elements: pk + 8 (Q, K), pv + 8 (G, V)
  int vec_q, vec_k, vec_v, vec_g;
  int ts_copies;    // kTsCopies, or 1 where they do not fit
};

inline int round_up(int x, int m) { return (x + m - 1) / m * m; }
__host__ __device__ inline int align16(int bytes) { return (bytes + 15) & ~15; }

// Shared memory in bytes, each part 16-byte aligned; one layout for the three:
//   K [kTileK][ldk]  V [kTileK][ldv]  Q [kTileQ][ldk]  G [kTileQ][ldv]  dS [kTileQ][kLdS]  (bf16)
//   tk [kTileK]  kv [kTileK]  tq [kTileQ]  (int)  pw [L]  gpos [L]  tw [nb+1]  (f32)  thr [nb+1]  (int)
//   gts [ts_copies][nb4]  (f32)
// dS only for K2; gpos and gts not for K2b.
struct Layout {
  int k, v, q, g, ds, tk, kv, tq, pw, gpos, tw, th, gts, nb4, total;
};

__host__ __device__ inline Layout layout(int ldk, int ldv, int L, int nb, int ts_copies, bool ds, bool tables) {
  Layout o;
  o.nb4 = (nb + 1 + 3) & ~3;
  o.k = 0;
  o.v = o.k + align16(2 * kTileK * ldk);
  o.q = o.v + align16(2 * kTileK * ldv);
  o.g = o.q + align16(2 * kTileQ * ldk);
  o.ds = o.g + align16(2 * kTileQ * ldv);
  o.tk = o.ds + (ds ? align16(2 * kTileQ * kLdS) : 0);
  o.kv = o.tk + 4 * kTileK;
  o.tq = o.kv + 4 * kTileK;
  o.pw = o.tq + 4 * kTileQ;
  o.gpos = o.pw + align16(4 * L);
  o.tw = o.gpos + (tables ? align16(4 * L) : 0);
  o.th = o.tw + 4 * o.nb4;
  o.gts = o.th + 4 * o.nb4;
  o.total = o.gts + (tables ? 4 * ts_copies * o.nb4 : 0);
  return o;
}

// The CTA's table sums into the zeroed global outputs: the dts copies added
// in a fixed order, one atomic per nonzero slot
__device__ __forceinline__ void flush_table_grads(const Args& a, const float* gpos, const float* gts, int n_dist,
                                                  int nb4, int h) {
  for (int d = threadIdx.x; d < n_dist; d += kThreads)
    if (gpos[d] != 0.f) atomicAdd(&a.dpos[(size_t)(a.max_seq_len - 1 - d) * a.H + h], gpos[d]);
  if (a.ts != nullptr)
    for (int u = threadIdx.x; u <= a.bk.nb; u += kThreads) {
      float sum = 0.f;
      for (int w = 0; w < a.ts_copies; ++w) sum += gts[w * nb4 + u];
      if (sum != 0.f) atomicAdd(&a.dts[(size_t)u * a.H + h], sum);
    }
}

// ---------------------------------------------------------------------------
// K2 and K2b: 64-key tiles
// ---------------------------------------------------------------------------

template <int N, bool kFull>  // n-tiles of 8 features: dqk, dv <= 8 * N; kFull: K2, else K2b
__device__ __forceinline__ void key_tile_body(const Args& a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int L = a.L, H = a.H, ldk = a.ldk, ldv = a.ldv;
  const Layout lay = layout(ldk, ldv, L, a.bk.nb, a.ts_copies, kFull, kFull);
  bf16* Ks = reinterpret_cast<bf16*>(smem + lay.k);
  bf16* Vs = reinterpret_cast<bf16*>(smem + lay.v);
  bf16* Qs = reinterpret_cast<bf16*>(smem + lay.q);
  bf16* Gs = reinterpret_cast<bf16*>(smem + lay.g);
  bf16* dSs = reinterpret_cast<bf16*>(smem + lay.ds);
  int* tk = reinterpret_cast<int*>(smem + lay.tk);
  int* kv = reinterpret_cast<int*>(smem + lay.kv);
  int* tq = reinterpret_cast<int*>(smem + lay.tq);
  float* pw = reinterpret_cast<float*>(smem + lay.pw);
  float* gpos = reinterpret_cast<float*>(smem + lay.gpos);
  float* tw = reinterpret_cast<float*>(smem + lay.tw);
  int* th = reinterpret_cast<int*>(smem + lay.th);
  float* gts = reinterpret_cast<float*>(smem + lay.gts);

  const int bh = blockIdx.x, b = bh / H, h = bh - b * H;
  const int k0 = blockIdx.y * kTileK;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const bool has_time = a.ts != nullptr;
  const int dqk = a.dqk, dvd = a.dv_dim;
  const int dk8 = (dqk + 7) >> 3, dv8 = (dvd + 7) >> 3, nkc = a.pk >> 4, nvc = a.pv >> 4;
  const bf16* qb = a.q + (size_t)bh * L * dqk;
  const bf16* gb = a.g + (size_t)bh * L * dvd;
  const int* tsb = has_time ? a.ts + (size_t)b * L : nullptr;
  const float inv_n = 1.f / (float)a.max_seq_len;
  const Lookup bucket(th, a.bk);
  const int n_dist = L - k0;  // causal distances this key tile can see: 0 .. L-1-k0
  float* my_gts = gts + (a.ts_copies > 1 ? 4 * warp + t : 0) * lay.nb4;

  // the key tile, its stamps and validity, the tables; the sums zeroed
  stage_rows_bf16(Ks, ldk, a.k + (size_t)bh * L * dqk, k0, kTileK, L, dqk, a.pk, a.vec_k, tid, kThreads);
  stage_rows_bf16(Vs, ldv, a.v + (size_t)bh * L * dvd, k0, kTileK, L, dvd, a.pv, a.vec_v, tid, kThreads);
  if (tid < kTileK) {
    const int m = k0 + tid;
    tk[tid] = has_time && m < L ? tsb[m] : 0;
    kv[tid] = m < L && (a.mask == nullptr || a.mask[(size_t)b * L + m] != 0);
  }
  for (int d = tid; d < n_dist; d += kThreads) {
    pw[d] = a.pos_w[(size_t)(a.max_seq_len - 1 - d) * H + h];
    if constexpr (kFull) gpos[d] = 0.f;
  }
  if (has_time)
    for (int u = tid; u <= a.bk.nb; u += kThreads) {
      tw[u] = a.ts_w[(size_t)u * H + h];
      th[u] = a.thr[u];
    }
  if constexpr (kFull)
    for (int i = tid; i < a.ts_copies * lay.nb4; i += kThreads) gts[i] = 0.f;

  float dk[N][4], dv[N][4];
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) dk[j][i] = dv[j][i] = 0.f;

  const int kr = 16 * warp, m0 = k0 + kr;  // this warp's first key, in the tile and in L
  const int n_qt = (L + kTileQ - 1) / kTileQ;
  for (int qt = k0 / kTileQ; qt < n_qt; ++qt) {
    const int q0 = qt * kTileQ;
    __syncthreads();  // the last q tile's Q, G and dS are consumed
    stage_rows_bf16(Qs, ldk, qb, q0, kTileQ, L, dqk, a.pk, a.vec_q, tid, kThreads);
    stage_rows_bf16(Gs, ldv, gb, q0, kTileQ, L, dvd, a.pv, a.vec_g, tid, kThreads);
    if (tid < kTileQ) tq[tid] = has_time && q0 + tid < L ? tsb[q0 + tid] : 0;
    __syncthreads();  // the q tile (and, the first time, the key tile and tables) is visible

    // sc: S^T then P^T, da: dA^T then dS^T; element (nt, i) is key kr + g + 8 (i >> 1),
    // query 8 nt + 2t + (i & 1) of the tiles
    float sc[8][4], da[8][4];
    int bk[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        sc[nt][i] = da[nt][i] = 0.f;
        bk[nt][i] = -1;
      }
    const bool active = m0 < L && min(q0 + kTileQ, L) - 1 >= m0;  // warp-uniform: some pair with m <= l
    if (active) {
      for (int kc = 0; kc < nkc; ++kc) {
        const bf16* kp = Ks + (kr + g) * ldk + 16 * kc + 2 * t;
        const uint32_t af[4] = {ld_pair(kp), ld_pair(kp + 8 * ldk), ld_pair(kp + 8), ld_pair(kp + 8 * ldk + 8)};
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const bf16* qp = Qs + (8 * nt + g) * ldk + 16 * kc + 2 * t;
          const uint32_t bf[2] = {ld_pair(qp), ld_pair(qp + 8)};
          mma_bf16(sc[nt], af, bf);
        }
      }
      for (int kc = 0; kc < nvc; ++kc) {
        const bf16* vp = Vs + (kr + g) * ldv + 16 * kc + 2 * t;
        const uint32_t af[4] = {ld_pair(vp), ld_pair(vp + 8 * ldv), ld_pair(vp + 8), ld_pair(vp + 8 * ldv + 8)};
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const bf16* gp = Gs + (8 * nt + g) * ldv + 16 * kc + 2 * t;
          const uint32_t bf[2] = {ld_pair(gp), ld_pair(gp + 8)};
          mma_bf16(da[nt], af, bf);
        }
      }
      const int kl_r[2] = {kr + g, kr + g + 8};
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int kl = kl_r[i >> 1], m = k0 + kl;
          const int ql = 8 * nt + 2 * t + (i & 1), l = q0 + ql;
          float pv = 0.f, dsv = 0.f;
          if (l < L && m <= l && kv[kl]) {
            float x = fmaf(sc[nt][i], a.alpha, pw[l - m]);
            if (has_time) {
              const int u = bucket(tq[ql], tk[kl]);
              x += tw[u];
              bk[nt][i] = u;
            }
            const float sig = 1.f / (1.f + expf(-x));  // exp overflow: 0
            pv = x * sig * inv_n;
            dsv = da[nt][i] * (sig * (1.f + x * (1.f - sig))) * inv_n;
          }
          sc[nt][i] = pv;
          da[nt][i] = dsv;
        }

      // dV += P^T G and dK += dS^T Q over 4 steps of 16 queries
#pragma unroll
      for (int qc = 0; qc < 4; ++qc) {
        const uint32_t pf[4] = {pack_bf16(sc[2 * qc][0], sc[2 * qc][1]), pack_bf16(sc[2 * qc][2], sc[2 * qc][3]),
                                pack_bf16(sc[2 * qc + 1][0], sc[2 * qc + 1][1]), pack_bf16(sc[2 * qc + 1][2], sc[2 * qc + 1][3])};
        const uint32_t sf[4] = {pack_bf16(da[2 * qc][0], da[2 * qc][1]), pack_bf16(da[2 * qc][2], da[2 * qc][3]),
                                pack_bf16(da[2 * qc + 1][0], da[2 * qc + 1][1]), pack_bf16(da[2 * qc + 1][2], da[2 * qc + 1][3])};
        const bf16* gp = Gs + (16 * qc + 2 * t) * ldv + g;
        const bf16* qp = Qs + (16 * qc + 2 * t) * ldk + g;
#pragma unroll
        for (int j = 0; j < N; ++j) {
          if (j < dv8) {
            const uint32_t bf[2] = {ld_column_pair(gp + 8 * j, ldv), ld_column_pair(gp + 8 * ldv + 8 * j, ldv)};
            mma_bf16(dv[j], pf, bf);
          }
          if (j < dk8) {
            const uint32_t bf[2] = {ld_column_pair(qp + 8 * j, ldk), ld_column_pair(qp + 8 * ldk + 8 * j, ldk)};
            mma_bf16(dk[j], sf, bf);
          }
        }
      }

      if constexpr (kFull) {
        // dpos and dts of each 16 x 16 fragment pair (keys kr .., queries 16 qc ..)
#pragma unroll
        for (int qc = 0; qc < 4; ++qc) {
          float part[3][2];
#pragma unroll
          for (int n = 0; n < 3; ++n) part[n][0] = part[n][1] = 0.f;
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int i = 0; i < 4; ++i) part[nt - (i >> 1) + 1][i & 1] += da[2 * qc + nt][i];
          add_pos_grads<1>(gpos, part, q0 + 16 * qc - m0, n_dist, g, t);
          if (has_time) {
            float dsk[8];
            int bkk[8];
#pragma unroll
            for (int e = 0; e < 8; ++e) {
              const int ii = e >> 2, nt = 2 * qc + ((e >> 1) & 1), j = e & 1;
              dsk[e] = da[nt][2 * ii + j];
              bkk[e] = bk[nt][2 * ii + j];
            }
            add_ts_grads<8>(my_gts, dsk, bkk);
          }
        }
      }
    }

    if constexpr (kFull) {
      // dS^T to shared memory as bf16 [query][key] (zeros from an inactive warp)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          dSs[(8 * nt + 2 * t + (i & 1)) * kLdS + kr + g + 8 * (i >> 1)] = __float2bfloat16_rn(da[nt][i]);
      __syncthreads();  // the tile's dS is complete

      // dq += alpha dS K for queries 16 warp .. 16 warp + 15 of the q tile
      const int qr = 16 * warp, lq = q0 + qr;
      if (lq < L && lq + 15 >= k0) {
        float acc[N][4];
#pragma unroll
        for (int j = 0; j < N; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll
        for (int kc = 0; kc < kTileK / 16; ++kc) {
          const bf16* sp = dSs + (qr + g) * kLdS + 16 * kc + 2 * t;
          const uint32_t af[4] = {ld_pair(sp), ld_pair(sp + 8 * kLdS), ld_pair(sp + 8), ld_pair(sp + 8 * kLdS + 8)};
          const bf16* kp = Ks + (16 * kc + 2 * t) * ldk + g;
#pragma unroll
          for (int j = 0; j < N; ++j) {
            if (j < dk8) {
              const uint32_t bf[2] = {ld_column_pair(kp + 8 * j, ldk), ld_column_pair(kp + 8 * ldk + 8 * j, ldk)};
              mma_bf16(acc[j], af, bf);
            }
          }
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int l = lq + g + 8 * i;
          if (l < L) {
            float* dst = a.dq + ((size_t)bh * L + l) * dqk;
#pragma unroll
            for (int j = 0; j < N; ++j) {
              const int c = 8 * j + 2 * t;
              if (c < dqk) atomicAdd(dst + c, acc[j][2 * i] * a.alpha);
              if (c + 1 < dqk) atomicAdd(dst + c + 1, acc[j][2 * i + 1] * a.alpha);
            }
          }
        }
      }
    }
  }

  // dK (times alpha) and dV of the warp's keys, in bf16
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + g + 8 * (i >> 1);
    if (m < L) {
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const int c = 8 * j + 2 * t + (i & 1);
        if (c < dqk) a.dk[((size_t)bh * L + m) * dqk + c] = __float2bfloat16_rn(dk[j][i] * a.alpha);
        if (c < dvd) a.dv[((size_t)bh * L + m) * dvd + c] = __float2bfloat16_rn(dv[j][i]);
      }
    }
  }

  if constexpr (kFull) {
    __syncthreads();  // every warp's table sums are in gpos / gts
    flush_table_grads(a, gpos, gts, n_dist, lay.nb4, h);
  }
}

template <int N>
__global__ void __launch_bounds__(kThreads) hstu_rab_bwd_bf16_kernel(Args a) {
  key_tile_body<N, true>(a);
}

template <int N>
__global__ void __launch_bounds__(kThreads) bwd_kv_kernel(Args a) {
  key_tile_body<N, false>(a);
}

// ---------------------------------------------------------------------------
// K2a: 64-row q tiles
// ---------------------------------------------------------------------------

template <int N>  // n-tiles of 8 features: dqk, dv <= 8 * N
__global__ void __launch_bounds__(kThreads) bwd_q_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int L = a.L, H = a.H, ldk = a.ldk, ldv = a.ldv;
  const Layout lay = layout(ldk, ldv, L, a.bk.nb, a.ts_copies, false, true);
  bf16* Ks = reinterpret_cast<bf16*>(smem + lay.k);
  bf16* Vs = reinterpret_cast<bf16*>(smem + lay.v);
  bf16* Qs = reinterpret_cast<bf16*>(smem + lay.q);
  bf16* Gs = reinterpret_cast<bf16*>(smem + lay.g);
  int* tk = reinterpret_cast<int*>(smem + lay.tk);
  int* kv = reinterpret_cast<int*>(smem + lay.kv);
  int* tq = reinterpret_cast<int*>(smem + lay.tq);
  float* pw = reinterpret_cast<float*>(smem + lay.pw);
  float* gpos = reinterpret_cast<float*>(smem + lay.gpos);
  float* tw = reinterpret_cast<float*>(smem + lay.tw);
  int* th = reinterpret_cast<int*>(smem + lay.th);
  float* gts = reinterpret_cast<float*>(smem + lay.gts);

  const int bh = blockIdx.x, b = bh / H, h = bh - b * H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTileQ;  // heaviest q tiles first
  const int q_end = min(q0 + kTileQ, L);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const bool has_time = a.ts != nullptr;
  const int dqk = a.dqk, dvd = a.dv_dim;
  const int dk8 = (dqk + 7) >> 3, nkc = a.pk >> 4, nvc = a.pv >> 4;
  const bf16* kb = a.k + (size_t)bh * L * dqk;
  const bf16* vb = a.v + (size_t)bh * L * dvd;
  const int* tsb = has_time ? a.ts + (size_t)b * L : nullptr;
  const float inv_n = 1.f / (float)a.max_seq_len;
  const Lookup bucket(th, a.bk);
  float* my_gts = gts + (a.ts_copies > 1 ? 4 * warp + t : 0) * lay.nb4;

  // the q tile, its stamps, the tables; the sums zeroed
  stage_rows_bf16(Qs, ldk, a.q + (size_t)bh * L * dqk, q0, kTileQ, L, dqk, a.pk, a.vec_q, tid, kThreads);
  stage_rows_bf16(Gs, ldv, a.g + (size_t)bh * L * dvd, q0, kTileQ, L, dvd, a.pv, a.vec_g, tid, kThreads);
  if (tid < kTileQ) tq[tid] = has_time && q0 + tid < L ? tsb[q0 + tid] : 0;
  for (int d = tid; d < q_end; d += kThreads) {
    pw[d] = a.pos_w[(size_t)(a.max_seq_len - 1 - d) * H + h];
    gpos[d] = 0.f;
  }
  if (has_time)
    for (int u = tid; u <= a.bk.nb; u += kThreads) {
      tw[u] = a.ts_w[(size_t)u * H + h];
      th[u] = a.thr[u];
    }
  for (int i = tid; i < a.ts_copies * lay.nb4; i += kThreads) gts[i] = 0.f;

  float acc[N][4];  // dq / alpha: rows g, g+8 of the warp's 16, columns 8j + 2t, 8j + 2t + 1
#pragma unroll
  for (int j = 0; j < N; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  const int qr = 16 * warp, r0 = q0 + qr;  // this warp's first row, in the tile and in L
  const int r_last = min(r0 + 15, L - 1);
  const int n_kt = (q_end - 1) / kTileK + 1;  // key tiles up to the causal frontier
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kTileK;
    __syncthreads();  // every warp is done with the last key tile
    stage_rows_bf16(Ks, ldk, kb, k0, kTileK, L, dqk, a.pk, a.vec_k, tid, kThreads);
    stage_rows_bf16(Vs, ldv, vb, k0, kTileK, L, dvd, a.pv, a.vec_v, tid, kThreads);
    if (tid < kTileK) {
      const int m = k0 + tid;
      tk[tid] = has_time && m < L ? tsb[m] : 0;
      kv[tid] = m < L && (a.mask == nullptr || a.mask[(size_t)b * L + m] != 0);
    }
    __syncthreads();  // the key tile (and, at kt = 0, Q, G and the tables) is visible
    if (r0 >= L || k0 > r_last) continue;  // no pair with m <= l for this warp

    // s: S, da: dA then dS; element (nt, i) is row qr + g + 8 (i >> 1), key 8 nt + 2t + (i & 1) of the tiles
    float s[8][4], da[8][4];
    int bk[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[nt][i] = da[nt][i] = 0.f;
        bk[nt][i] = -1;
      }
    for (int kc = 0; kc < nkc; ++kc) {
      const bf16* qp = Qs + (qr + g) * ldk + 16 * kc + 2 * t;
      const uint32_t af[4] = {ld_pair(qp), ld_pair(qp + 8 * ldk), ld_pair(qp + 8), ld_pair(qp + 8 * ldk + 8)};
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const bf16* kp = Ks + (8 * nt + g) * ldk + 16 * kc + 2 * t;
        const uint32_t bf[2] = {ld_pair(kp), ld_pair(kp + 8)};
        mma_bf16(s[nt], af, bf);
      }
    }
    for (int kc = 0; kc < nvc; ++kc) {
      const bf16* gp = Gs + (qr + g) * ldv + 16 * kc + 2 * t;
      const uint32_t af[4] = {ld_pair(gp), ld_pair(gp + 8 * ldv), ld_pair(gp + 8), ld_pair(gp + 8 * ldv + 8)};
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const bf16* vp = Vs + (8 * nt + g) * ldv + 16 * kc + 2 * t;
        const uint32_t bf[2] = {ld_pair(vp), ld_pair(vp + 8)};
        mma_bf16(da[nt], af, bf);
      }
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int rl = qr + g + 8 * (i >> 1), l = q0 + rl;
        const int c = 8 * nt + 2 * t + (i & 1), m = k0 + c;
        float dsv = 0.f;
        if (l < L && m <= l && kv[c]) {
          float x = fmaf(s[nt][i], a.alpha, pw[l - m]);
          if (has_time) {
            const int u = bucket(tq[rl], tk[c]);
            x += tw[u];
            bk[nt][i] = u;
          }
          const float sig = 1.f / (1.f + expf(-x));  // exp overflow: 0
          dsv = da[nt][i] * (sig * (1.f + x * (1.f - sig))) * inv_n;
        }
        da[nt][i] = dsv;
      }

    // dQ += dS K over 4 steps of 16 keys: dS's fragment, rounded to bf16, is the A fragment as is
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      const uint32_t af[4] = {pack_bf16(da[2 * kc][0], da[2 * kc][1]), pack_bf16(da[2 * kc][2], da[2 * kc][3]),
                              pack_bf16(da[2 * kc + 1][0], da[2 * kc + 1][1]), pack_bf16(da[2 * kc + 1][2], da[2 * kc + 1][3])};
      const bf16* kp = Ks + (16 * kc + 2 * t) * ldk + g;
#pragma unroll
      for (int j = 0; j < N; ++j) {
        if (j < dk8) {
          const uint32_t bf[2] = {ld_column_pair(kp + 8 * j, ldk), ld_column_pair(kp + 8 * ldk + 8 * j, ldk)};
          mma_bf16(acc[j], af, bf);
        }
      }
    }

    // dpos and dts of each 16 x 16 fragment pair (rows qr .., keys 16 kc ..), from the unrounded dS:
    // local distance (row - key) = 8 ((i >> 1) - nt) + g - 2t - (i & 1)
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      float part[3][2];
#pragma unroll
      for (int n = 0; n < 3; ++n) part[n][0] = part[n][1] = 0.f;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) part[(i >> 1) - nt + 1][i & 1] += da[2 * kc + nt][i];
      add_pos_grads<-1>(gpos, part, r0 - (k0 + 16 * kc), q_end, g, t);
      if (has_time) {
        // the lane's values key by key along each of its two rows, so that its runs of equal buckets fold
        float dsr[8];
        int bkr[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int ii = e >> 2, nt = 2 * kc + ((e >> 1) & 1), j = e & 1;
          dsr[e] = da[nt][2 * ii + j];
          bkr[e] = bk[nt][2 * ii + j];
        }
        add_ts_grads<8>(my_gts, dsr, bkr);
      }
    }
  }

  // dq (times alpha) of the warp's rows, written once in bf16
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int l = r0 + g + 8 * i;
    if (l < L) {
      bf16* dst = a.dq16 + ((size_t)bh * L + l) * dqk;
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const int c = 8 * j + 2 * t;
        if (c < dqk) dst[c] = __float2bfloat16_rn(acc[j][2 * i] * a.alpha);
        if (c + 1 < dqk) dst[c + 1] = __float2bfloat16_rn(acc[j][2 * i + 1] * a.alpha);
      }
    }
  }

  __syncthreads();  // every warp's table sums are in gpos / gts
  flush_table_grads(a, gpos, gts, q_end, lay.nb4, h);
}

// which: 0 K2, 1 K2a, 2 K2b
template <int N>
cudaError_t launch(int which, Args a, cudaStream_t stream, int* info) {
  const bool ds = which == 0, tables = which != 2;
  a.ts_copies = kTsCopies;
  size_t smem = layout(a.ldk, a.ldv, a.L, a.bk.nb, a.ts_copies, ds, tables).total;
  if (smem > kMaxSmem) {
    a.ts_copies = 1;
    smem = layout(a.ldk, a.ldv, a.L, a.bk.nb, 1, ds, tables).total;
  }
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  const auto kernel = which == 0 ? hstu_rab_bwd_bf16_kernel<N> : which == 1 ? bwd_q_kernel<N> : bwd_kv_kernel<N>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  if (info != nullptr) return occupancy(kernel, kThreads, smem, info);
  // K2 / K2b: one CTA a key tile; K2a: one a q tile (both 64 wide)
  const dim3 grid(a.B * a.H, (a.L + kTileK - 1) / kTileK);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

int run(int which, const void* q, const void* k, const void* v, const void* g, const void* pos_w, const void* ts_w,
        const void* thr, const void* ts, const void* mask, void* dq, void* dk, void* dv, void* dpos, void* dts, int B,
        int H, int L, int dqk, int dv_dim, int max_seq_len, int num_buckets, float alpha, int fn_log, int minutes,
        float divisor, void* stream, int* info) {
  if (which < 0 || which > 2 || dv_dim < 1 || dv_dim > 128 || dqk < 1 || dqk > 128 || L < 1 || L > max_seq_len ||
      num_buckets < 0)
    return cudaErrorInvalidValue;
  Args a;
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.g = static_cast<const bf16*>(g);
  a.pos_w = static_cast<const float*>(pos_w);
  a.ts_w = static_cast<const float*>(ts_w);
  a.thr = static_cast<const int*>(thr);
  a.ts = static_cast<const int*>(ts);
  a.mask = static_cast<const uint8_t*>(mask);
  a.dq = which == 0 ? static_cast<float*>(dq) : nullptr;
  a.dq16 = which == 1 ? static_cast<bf16*>(dq) : nullptr;
  a.dk = static_cast<bf16*>(dk);
  a.dv = static_cast<bf16*>(dv);
  a.dpos = static_cast<float*>(dpos);
  a.dts = static_cast<float*>(dts);
  a.B = B;
  a.H = H;
  a.L = L;
  a.dqk = dqk;
  a.dv_dim = dv_dim;
  a.max_seq_len = max_seq_len;
  a.alpha = alpha;
  a.bk = Buckets{num_buckets, fn_log, minutes, divisor};
  a.pk = round_up(dqk, 16);
  a.pv = round_up(dv_dim, 16);
  a.ldk = a.pk + 8;
  a.ldv = a.pv + 8;
  const auto aligned = [](const void* ptr) { return ((uintptr_t)ptr & 15) == 0; };
  a.vec_q = dqk % 8 == 0 && aligned(q);
  a.vec_k = dqk % 8 == 0 && aligned(k);
  a.vec_v = dv_dim % 8 == 0 && aligned(v);
  a.vec_g = dv_dim % 8 == 0 && aligned(g);
  auto st = static_cast<cudaStream_t>(stream);
  const int w = dqk > dv_dim ? dqk : dv_dim;
  if (w <= 8) return launch<1>(which, a, st, info);
  if (w <= 16) return launch<2>(which, a, st, info);
  if (w <= 32) return launch<4>(which, a, st, info);
  if (w <= 64) return launch<8>(which, a, st, info);
  return launch<16>(which, a, st, info);
}

}  // namespace

// All three take the same arguments.  q, k: (B, H, L, dqk), v, g: (B, H, L,
// dv) bf16, contiguous, at any element offset; pos_w, ts_w fp32; thr, ts,
// mask and the bucket config as hstu_rab_bwd (hstu_rab_bwd.cu).  Outputs a
// kernel does not produce are ignored (pass null).  dq: hstu_rab_bwd_bf16's
// (B, H, L, dqk) fp32 sums, zeroed by the caller; hstu_rab_bwd_dq_bf16's
// bf16, every element written.  dk, dv bf16, every element written; dpos,
// dts fp32, zeroed by the caller.  dqk, dv <= 128.  Each returns the
// cudaError_t of its launch.
#define RAB_BWD_ARGS                                                                                              \
  const void *q, const void *k, const void *v, const void *g, const void *pos_w, const void *ts_w, const void *thr, \
      const void *ts, const void *mask, void *dq, void *dk, void *dv, void *dpos, void *dts, int B, int H, int L,     \
      int dqk, int dv_dim, int max_seq_len, int num_buckets, float alpha, int fn_log, int minutes, float divisor,     \
      void *stream
#define RAB_BWD_PASS                                                                                                 \
  q, k, v, g, pos_w, ts_w, thr, ts, mask, dq, dk, dv, dpos, dts, B, H, L, dqk, dv_dim, max_seq_len, num_buckets, alpha, \
      fn_log, minutes, divisor, stream

extern "C" int hstu_rab_bwd_bf16(RAB_BWD_ARGS) { return run(0, RAB_BWD_PASS, nullptr); }

extern "C" int hstu_rab_bwd_dq_bf16(RAB_BWD_ARGS) { return run(1, RAB_BWD_PASS, nullptr); }

extern "C" int hstu_rab_bwd_dkv_bf16(RAB_BWD_ARGS) { return run(2, RAB_BWD_PASS, nullptr); }

// A backward kernel (which: 0 K2, 1 K2a, 2 K2b) as this shape would launch
// it, without launching it: info[0] resident CTAs per SM, info[1] registers
// per thread, info[2] dynamic shared memory bytes per CTA.  Returns the
// cudaError_t.
extern "C" int hstu_rab_bwd_bf16_occupancy(int which, int L, int dqk, int dv, int max_seq_len, int num_buckets,
                                           int* info) {
  return run(which, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
             nullptr, nullptr, nullptr, 1, 1, L, dqk, dv, max_seq_len, num_buckets, 1.f, 0, 0, 1.f, nullptr, info);
}

extern "C" const char* hstu_rab_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
