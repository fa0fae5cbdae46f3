// HSTU silu attention with on-the-fly relative position/time bias: the three
// backward kernels, hand-written for Hopper (sm_90a), fp32 in and out.
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
// bucket() is K1's exact O(1) lookup (hstu_rab_common.cuh), in all three.
//
// What bounds them on an H100, at B8 H8 L256, dqk = dv = 32 (1.96 M valid
// pairs): K2 needs 0.63 GFLOP of products (five of them), 0.0038 ms on the
// tensor cores in 3xTF32, against 14.7 MB of q/k/v/g/dq/dk/dv (0.0044 ms at
// 3.35 TB/s); K2a 0.38 GFLOP (three products: S, dA, dQ), 0.0023 ms, against
// 10.5 MB of q/k/v/g/dq, 0.0031 ms; K2b 0.50 GFLOP (four: S, dA, dV, dK),
// 0.0030 ms, against 12.6 MB of q/k/v/g/dk/dv, 0.0038 ms.  All three are
// bounded by bytes.  The split pair recomputes S and dA in both kernels, so
// its sum stays above K2.  What the kernels really spend is the per-pair
// work the tensor cores do not do (bias, bucket, silu', the table sums) and
// latency; hence the tensor cores for the products, registers for P and dS,
// and a card full of warps.  K2a and K2b are held to 80 registers at
// dqk, dv <= 32 (launch bounds of 3 CTAs, 24 warps, per SM; K2a 79 with no
// spills, K2b 80 with 12 B of spill stores), which took K2a from 0.068 to
// 0.057 ms and K2b from 0.049 to 0.046 at the serving shape on an H100 at
// 700 W (PERF.md); K2 keeps 2 CTAs per SM at 125 registers.
//
// K2, the default backward (bwd_fused_kernel), and K2b (bwd_kv_kernel): one
// body, key_tile_body<N, kFull>, K2b being K2 with kFull = false.  K2b is
// K2's key-tile loop without dq and the table gradients, so one body keeps
// the two from drifting apart; kFull compiles out the dS store and its
// barrier, the dQ products and atomics, the table sums and their shared
// memory, and K2's instantiation is the code it was.
// - CTA = 8 warps over a 32-key tile: 2 key groups of 16 x 4 query splits,
//   each warp 16 of every 64-query tile, the q tiles walked from the
//   diagonal to L.  Low key tiles walk the most q tiles; they are issued
//   first (grid y), and the 32-key tile gives 512 CTAs at the serving shape.
// - The products on tensor cores (mma.sync m16n8k8 TF32, 3xTF32):
//   S^T = K Q^T and dA^T = V G^T with the warp's keys as rows; P^T and dS^T
//   stay in registers and are the A fragments of dV += P^T G and
//   dK += dS^T Q (the queries of each 8-group read in the order
//   0,2,4,6,1,3,5,7, and the B rows of G and Q loaded in that order).  K2
//   also stores dS to shared memory, [query][key], where dQ_part = dS K
//   reads it as an A fragment after the tile's second barrier; there K is
//   kept with a row stride of 8 mod 32 words so that its B fragment
//   (K[key][feature]) loads without bank conflicts.  K2b reads K only as an
//   A fragment, at 4 mod 8 like Q, G and V.
// - Q, G and the query stamps of the next q tile are copied with cp.async
//   into a two-stage ring during the current tile's math; K2 has two
//   barriers a tile, K2b one.  Where two stages do not fit (long sequences
//   at wide heads) one stage is refilled after the tile's second barrier.
// - K2's dq: each (key tile, q tile) pair adds its partial from the
//   fragments, two lanes swapping halves so each holds four consecutive
//   floats, with one red.global.add.v4.f32 (scalar atomics where dqk % 4 or
//   alignment forbid).  The order of these sums changes from run to run.
// - Table gradients in a fixed order, with no float atomic (so dpos and
//   dts are the same bit for bit from run to run; hstu_rab_common.cuh).
//   dpos by causal distance: each lane folds its fragment by distance (6
//   partials), the lanes that share a distance sum by shuffles along the
//   warp, and the chain's head adds the sum into the warp's own window of
//   31 distances; after the tile's second barrier 95 threads add the 8
//   windows in warp order into the CTA's gpos[L].  dts by each lane's runs
//   of equal buckets, key by key, into a copy of the warp's lane column t
//   (lanes that share a causal distance, and so most often a bucket, lie
//   in different columns; where the 32 copies do not fit, one table per
//   warp): lanes that end a run on one slot at the same step add in lane
//   order, and a warp whose buckets agree adds one butterfly sum.  Where
//   the 8 tables do not fit either, no windows and one table, as the first
//   designs had: the warps add to gpos and the table one at a time in warp
//   order (wait_turn / pass_turn, named barriers).  At the end the copies
//   are added in a fixed order into the CTA's slice of the scratch buffer,
//   and reduce_table_slices adds the slices in CTA order into dpos and dts.
// - dK and dV of the four query splits are summed in a fixed order at the
//   end: they are the same bit for bit from run to run.
//
// K2a (bwd_q_kernel) keeps the TPU kernel's ownership: one CTA owns its q
// rows and walks the key tiles up to the causal frontier, so dq is written
// once, with no atomics and no zeroed output.  It is K1's loop
// (hstu_rab_fwd.cu) run backward:
// - CTA = 8 warps over a 32-row q tile: 2 row groups of 16 x 4 key splits,
//   each warp 16 of every 64 staged keys; 512 CTAs at the serving shape,
//   issued heaviest q tile first (grid y reversed).
// - K, V, the key stamps and the mask words of the next 64-key tile are
//   copied with cp.async into a two-stage ring (one barrier a tile; one
//   stage and two barriers where two do not fit), Q and G once.
// - S = Q K^T and dA = G V^T on the tensor cores in 3xTF32; both
//   accumulators have one fragment layout, so dS = valid dA silu'(S) / N
//   is formed in registers and is the A fragment of dQ += dS K with the
//   keys of each 8-group read in the order 0,2,4,6,1,3,5,7 (K's rows loaded
//   in that order, as K1 does for P V): dS never touches shared memory.
//   Every tile is kept at a row stride of 4 mod 8 words, which loads
//   K[key][feature] both as S's B fragment and, with the key index 2t, as
//   dQ's, without bank conflicts.
// - dq: the four key splits' partials summed in a fixed order, (0 + 2) +
//   (1 + 3), as K1 sums its outputs: the same bit for bit from run to run.
// - dpos and dts: K2's machinery above, per q tile (the windows double
//   buffered by tile parity, as K2a has one barrier a tile; dts copies per
//   warp and lane column t, or one per warp, or one table in turns).
//
// Shapes: dqk, dv <= 128, any L (rows and keys past L are masked here, V/K
// rows past L zero-filled, no host padding), widths that fill neither the
// 8-wide fragments nor the 16-byte copies (zero-padded in shared memory;
// 4-byte copies), masks at any byte offset.  Where shared memory runs
// short the dts copies go first (to one table per warp, then to one table
// in turns, which needs no more than the first designs' one table), then
// the second ring stage.  Wider heads, and shapes whose shared memory still does not
// fit, take the width-tiled variants (hstu_wide.cuh): every entry runs
// every shape.  Kept from the first designs: the ownership (K2a a q tile,
// K2b a key tile), pos_w staged by causal distance, fully masked rows
// giving zeros.
// Registers, shared memory and CTAs per SM: ptxas's report in the build log
// and hstu_rab_bwd_occupancy (chip_smoke.py prints both).

#include "hstu_rab_common.cuh"
#include "hstu_wide.cuh"

namespace {

using namespace rab;

struct Args {
  const float *q, *k, *v, *g, *pos_w, *ts_w;
  const int *thr, *ts;
  const uint8_t* mask;
  float *dq, *dk, *dv, *dpos, *dts;
  float* scratch;  // K2, K2a: a slice of table sums per CTA (write_table_slice)
  int B, H, L, dqk, dv_dim, max_seq_len;
  float alpha;
  Buckets bk;
};

constexpr int kWarps2 = 8;
constexpr int kThreads2 = 32 * kWarps2;
constexpr int kTsCopies = 4 * kWarps2;  // dts sums: one copy per warp and lane column t
static_assert(kWarps2 == kWinWarps, "a dpos window per warp");

// The dts table of this lane: its warp's copy for its lane column t, or its
// warp's one table where the copies do not fit, or the CTA's one table
// (added to in turns) where those do not fit either
__device__ __forceinline__ float* lane_table(float* gts, int copies, int warp, int t, int nb4) {
  return gts + (copies == kTsCopies ? 4 * warp + t : copies == kWarps2 ? warp : 0) * nb4;
}

inline int stride_a(int width) { return ((width + 7) & ~7) + 4; }  // 4 mod 8: A and row-major B fragments
inline int stride_b(int width) {                                      // 8 mod 32: K[key][feature] as a B fragment
  const int w8 = (width + 7) & ~7;
  return w8 + (((8 - w8) % 32) + 32) % 32;
}

inline bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

// ---------------------------------------------------------------------------
// K2 and K2b: 32-key tiles (the source note at the top)
// ---------------------------------------------------------------------------

constexpr int kKeyGroups = 2;                   // 16-key groups per CTA
constexpr int kQuerySplits = 4;                 // warps sharing a key group, each 16 queries of a q tile
constexpr int kTileK = 16 * kKeyGroups;         // keys per CTA
constexpr int kTileQ = 16 * kQuerySplits;       // queries per q tile (stage)
constexpr int kLdS = kTileK + 4;                // dS [query][key] row stride, 4 mod 8
static_assert(kKeyGroups * kQuerySplits == kWarps2, "8 warps a CTA");

struct Fused {
  Args a;
  int ldq, ldg, ldk, ldv;   // shared row strides: Q, G, V 4 mod 8 words; K 8 mod 32 (K2) or 4 mod 8 (K2b)
  int vec_q, vec_k, vec_v, vec_g, red_v4;
  int stages;               // the Q/G ring: 2 stages, or 1 where two do not fit
  int ts_copies;            // dts sums: kTsCopies, or kWarps2 (one table per warp), or 1 (one table, in turns)
};

// Shared memory, in 4-byte words (each part a multiple of 4 words):
//   K [kTileK][ldk]  V [kTileK][ldv]  tk [kTileK]  kvalid [kTileK]  dS [kTileQ][kLdS]
//   pw [L]  tw [nb+1]  thr [nb+1]  gpos [L]  gts [ts_copies][nb+1]  win [8][32] (none in turns)
//   1 or 2 stages of { Q [kTileQ][ldq]  G [kTileQ][ldg]  tq [kTileQ] },
//   the stages also holding the query splits' partial dK, dV at the end.
// K2b (kFull false) has no dS, gpos or gts.  With one stage and one dts
// table this is never more than the first design (fp32 FMAs over 64 x 64
// tiles) took, so K2 and K2b take every shape it took.
struct Layout2 {
  int k, v, tk, kv, ds, pw, tw, th, gpos, gts, win, L4, nb4, stage, stage_words, sq, sg, stq, total;
};

template <bool kFull>
__host__ __device__ inline Layout2 layout2(const Fused& f, int L, int nb) {
  const int L4 = (L + 3) & ~3, nb4 = (nb + 1 + 3) & ~3;
  Layout2 o;
  o.k = 0;
  o.v = o.k + kTileK * f.ldk;
  o.tk = o.v + kTileK * f.ldv;
  o.kv = o.tk + kTileK;
  o.ds = o.kv + kTileK;
  o.pw = o.ds + (kFull ? kTileQ * kLdS : 0);
  o.L4 = L4;
  o.nb4 = nb4;
  o.tw = o.pw + L4;
  o.th = o.tw + nb4;
  o.gpos = o.th + nb4;
  o.gts = o.gpos + (kFull ? L4 : 0);
  o.win = o.gts + (kFull ? f.ts_copies * nb4 : 0);
  o.stage = o.win + (kFull && f.ts_copies > 1 ? kWinWarps * kWin : 0);
  o.sq = 0;
  o.sg = o.sq + kTileQ * f.ldq;
  o.stq = o.sg + kTileQ * f.ldg;
  o.stage_words = o.stq + kTileQ;
  int stages = f.stages * o.stage_words;
  const int partials = (kQuerySplits - 1) * kKeyGroups * 16 * (f.ldq + f.ldg);
  if (partials > stages) stages = partials;
  o.total = o.stage + stages;
  return o;
}

// kFull: K2 (dq, dk, dv, dpos, dts); else K2b (dk, dv)
template <int N, bool kFull>  // n-tiles of 8 features: dqk, dv <= 8 * N
__device__ __forceinline__ void key_tile_body(const Fused& f) {
  constexpr int NH = (N + 1) / 2;  // dQ n-tiles per warp (two warps share a row group)
  extern __shared__ __align__(16) float smem[];
  const Args& a = f.a;
  const int L = a.L, H = a.H;
  const Layout2 lay = layout2<kFull>(f, L, a.bk.nb);
  float* Ks = smem + lay.k;
  float* Vs = smem + lay.v;
  int* tk = reinterpret_cast<int*>(smem + lay.tk);
  int* kvalid = reinterpret_cast<int*>(smem + lay.kv);
  float* dSs = smem + lay.ds;
  float* pw = smem + lay.pw;
  float* gpos = smem + lay.gpos;
  float* tw = smem + lay.tw;
  float* gts = smem + lay.gts;
  float* win = smem + lay.win;
  int* th = reinterpret_cast<int*>(smem + lay.th);
  float* stages = smem + lay.stage;

  const int bh = blockIdx.x, b = bh / H, h = bh - b * H;
  const int k0 = blockIdx.y * kTileK;  // low key tiles, which walk the most q tiles, first
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int kg = warp % kKeyGroups, qs = warp / kKeyGroups;
  const bool has_time = a.ts != nullptr;
  const int dqk = a.dqk, dvd = a.dv_dim, ldq = f.ldq, ldg = f.ldg, ldk = f.ldk, ldv = f.ldv;
  const int dk8 = (dqk + 7) >> 3, dv8 = (dvd + 7) >> 3;
  const float* qb = a.q + (size_t)bh * L * dqk;
  const float* gb = a.g + (size_t)bh * L * dvd;
  const int* tsb = has_time ? a.ts + (size_t)b * L : nullptr;
  const float inv_norm = 1.f / (float)a.max_seq_len;
  const Lookup bucket(th, a.bk);
  const int n_dist = L - k0;  // causal distances this key tile can see: 0 .. L-1-k0
  float* my_gts = lane_table(gts, f.ts_copies, warp, t, lay.nb4);
  const int ts_copy = f.ts_copies == kTsCopies ? t : 0;
  const bool turns = kFull && f.ts_copies == 1;  // one gpos and one dts table, the warps adding in turns
  const bool ring = f.stages == 2;  // else the next q tile is copied once the current one is consumed

  auto stage_ptr = [&](int s) { return stages + s * lay.stage_words; };
  auto issue = [&](int qt, int s) {
    float* st = stage_ptr(s);
    copy_rows(st + lay.sq, ldq, qb, qt * kTileQ, kTileQ, L, dqk, f.vec_q, tid, kThreads2);
    copy_rows(st + lay.sg, ldg, gb, qt * kTileQ, kTileQ, L, dvd, f.vec_g, tid, kThreads2);
    if (has_time) copy_stamps(reinterpret_cast<int*>(st + lay.stq), tsb, qt * kTileQ, kTileQ, L, tid);
  };

  // Zero the padding columns no copy writes, and the table-gradient sums;
  // then the key tile, its stamps and validity, the first q tile, the tables.
  for (int r = tid; r < kTileK + f.stages * kTileQ; r += kThreads2) {
    if (r < kTileK) {
      for (int d = dqk; d < 8 * dk8; ++d) Ks[r * ldk + d] = 0.f;
      for (int d = dvd; d < 8 * dv8; ++d) Vs[r * ldv + d] = 0.f;
    } else {
      const int s = (r - kTileK) / kTileQ, rr = (r - kTileK) % kTileQ;
      for (int d = dqk; d < 8 * dk8; ++d) stage_ptr(s)[lay.sq + rr * ldq + d] = 0.f;
      for (int d = dvd; d < 8 * dv8; ++d) stage_ptr(s)[lay.sg + rr * ldg + d] = 0.f;
    }
  }
  for (int d = tid; d < n_dist; d += kThreads2) pw[d] = a.pos_w[(size_t)(a.max_seq_len - 1 - d) * H + h];
  if constexpr (kFull)
    for (int i = tid; i < lay.stage - lay.gpos; i += kThreads2) gpos[i] = 0.f;  // gpos, gts, win
  if (has_time)
    for (int u = tid; u <= a.bk.nb; u += kThreads2) {
      tw[u] = a.ts_w[(size_t)u * H + h];
      th[u] = a.thr[u];
    }
  if (tid < kTileK) {
    const int m = k0 + tid;
    kvalid[tid] = m < L && (a.mask == nullptr || a.mask[(size_t)b * L + m] != 0);
  }
  copy_rows(Ks, ldk, a.k + (size_t)bh * L * dqk, k0, kTileK, L, dqk, f.vec_k, tid, kThreads2);
  copy_rows(Vs, ldv, a.v + (size_t)bh * L * dvd, k0, kTileK, L, dvd, f.vec_v, tid, kThreads2);
  if (has_time) copy_stamps(tk, tsb, k0, kTileK, L, tid);
  const int qt0 = k0 / kTileQ, n_qt = (L + kTileQ - 1) / kTileQ;
  issue(qt0, 0);
  cp_commit();

  float dk[N][4], dv[N][4];
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) dk[j][i] = dv[j][i] = 0.f;

  const int kk0 = 16 * kg, qq0 = 16 * qs;  // this warp's keys and queries within the tiles
  const int m0 = k0 + kk0;
  const unsigned full = 0xffffffffu;
  for (int qt = qt0; qt < n_qt; ++qt) {
    cp_wait_all();
    __syncthreads();  // B1: q tile qt visible; the last tile's stage and dS consumed
    if (ring) {
      if (qt + 1 < n_qt) issue(qt + 1, (qt + 1 - qt0) & 1);
      cp_commit();
    }
    const float* st = stage_ptr(ring ? (qt - qt0) & 1 : 0);
    const float* Qs = st + lay.sq;
    const float* Gs = st + lay.sg;
    const int* tq = reinterpret_cast<const int*>(st + lay.stq);
    const int q0 = qt * kTileQ, l0 = q0 + qq0;

    // sc: S^T then P^T, da: dA^T then dS^T; element (nt, i) is key kk0 + g + 8(i>>1),
    // query qq0 + 8nt + 2t + (i&1)
    float sc[2][4], da[2][4];
    int bk[2][4];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        sc[nt][i] = da[nt][i] = 0.f;
        bk[nt][i] = -1;
      }
    const bool active = l0 < L && m0 < L && l0 + 15 >= m0;  // warp-uniform: some pair with m <= l
    if (active) {
      for (int dd = 0; dd < dk8; ++dd) {
        uint32_t ah[4], al[4];
        load_a(Ks, ldk, kk0, 8 * dd, g, t, ah, al);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const float* qp = Qs + (qq0 + 8 * nt + g) * ldq + 8 * dd + t;
          uint32_t bh_[2], bl_[2];
          split(qp[0], bh_[0], bl_[0]);
          split(qp[4], bh_[1], bl_[1]);
          mma3(sc[nt], ah, al, bh_, bl_);
        }
      }
      for (int dd = 0; dd < dv8; ++dd) {
        uint32_t ah[4], al[4];
        load_a(Vs, ldv, kk0, 8 * dd, g, t, ah, al);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const float* gp = Gs + (qq0 + 8 * nt + g) * ldg + 8 * dd + t;
          uint32_t bh_[2], bl_[2];
          split(gp[0], bh_[0], bl_[0]);
          split(gp[4], bh_[1], bl_[1]);
          mma3(da[nt], ah, al, bh_, bl_);
        }
      }
      const int tk_r[2] = {has_time ? tk[kk0 + g] : 0, has_time ? tk[kk0 + g + 8] : 0};
      const int kv_r[2] = {kvalid[kk0 + g], kvalid[kk0 + g + 8]};
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int m = m0 + g + 8 * (i >> 1);
          const int qq = qq0 + 8 * nt + 2 * t + (i & 1);
          const int l = q0 + qq;
          float pv = 0.f, dsv = 0.f;
          if (l < L && m <= l && kv_r[i >> 1]) {
            float x = pw[l - m];
            if (has_time) {
              const int u = bucket(tq[qq], tk_r[i >> 1]);
              x += tw[u];
              bk[nt][i] = u;
            }
            x = fmaf(sc[nt][i], a.alpha, x);
            const float sig = __fdividef(1.f, 1.f + __expf(-x));  // exp overflow: 0
            pv = x * sig * inv_norm;
            dsv = da[nt][i] * (sig * (1.f + x * (1.f - sig))) * inv_norm;
          }
          sc[nt][i] = pv;
          da[nt][i] = dsv;
        }

      // dV += P^T G, dK += dS^T Q: queries 2t and 2t+1 of each 8-group are A columns t and t+4
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        uint32_t ph[4], pl[4], sh[4], sl[4];
        split(sc[kk][0], ph[0], pl[0]);
        split(sc[kk][2], ph[1], pl[1]);
        split(sc[kk][1], ph[2], pl[2]);
        split(sc[kk][3], ph[3], pl[3]);
        split(da[kk][0], sh[0], sl[0]);
        split(da[kk][2], sh[1], sl[1]);
        split(da[kk][1], sh[2], sl[2]);
        split(da[kk][3], sh[3], sl[3]);
        const int row = qq0 + 8 * kk + 2 * t;
#pragma unroll
        for (int j = 0; j < N; ++j) {
          if (j < dv8) {
            uint32_t bh_[2], bl_[2];
            split(Gs[row * ldg + 8 * j + g], bh_[0], bl_[0]);
            split(Gs[(row + 1) * ldg + 8 * j + g], bh_[1], bl_[1]);
            mma3(dv[j], ph, pl, bh_, bl_);
          }
          if (j < dk8) {
            uint32_t bh_[2], bl_[2];
            split(Qs[row * ldq + 8 * j + g], bh_[0], bl_[0]);
            split(Qs[(row + 1) * ldq + 8 * j + g], bh_[1], bl_[1]);
            mma3(dk[j], sh, sl, bh_, bl_);
          }
        }
      }

      if constexpr (kFull) {
        // dpos: this lane's values by local distance (query - key) = 8n + (2t - g) + (i&1), n = nt - (i>>1)
        float part[3][2];
#pragma unroll
        for (int n = 0; n < 3; ++n) part[n][0] = part[n][1] = 0.f;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) part[nt - (i >> 1) + 1][i & 1] += da[nt][i];
        wait_turn(turns, warp);
        add_pos_grads<1>(turns ? gpos : win + kWin * warp, turns ? l0 - m0 : 15, turns ? n_dist : kWin, part, g, t);
        if (has_time) {
          // dts into the warp's own sums (in turns, the CTA's), so no other warp adds at once: the lane's
          // values key by key, so that its runs of equal buckets (neighbouring queries) fold before an add
          float dsk[8];
          int bkk[8];
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const int ii = e >> 2, nt = (e >> 1) & 1, j = e & 1;
            dsk[e] = da[nt][2 * ii + j];
            bkk[e] = bk[nt][2 * ii + j];
          }
          add_ts_grads<8>(my_gts, ts_copy, dsk, bkk);
        }
        pass_turn(turns, warp);
      }
    } else {
      wait_turn(turns, warp);  // no pairs: the turn passes on
      pass_turn(turns, warp);
    }

    if constexpr (kFull) {
      // dS to shared memory, [query][key], for dQ (zeros from a warp with no valid pair)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) dSs[(qq0 + 8 * nt + 2 * t + (i & 1)) * kLdS + kk0 + g + 8 * (i >> 1)] = da[nt][i];
    }
    if (kFull || !ring) __syncthreads();  // B2: the tile's dS and dpos windows are complete; Q and G are consumed
    if (kFull && !turns)  // the tile's distances q0 - k0 - 31 + r, r < 95; warp w's window starts at r = 16 (qs - kg + 1)
      flush_pos_windows(gpos, win, q0 - k0 - (kTileK - 1), n_dist,
                        [](int w) { return 16 * (w / kKeyGroups - w % kKeyGroups + 1); });
    if (!ring) {
      if (qt + 1 < n_qt) issue(qt + 1, 0);
      cp_commit();
    }

    if constexpr (kFull) {
      // dQ_part = alpha dS K: warp rows 16 (warp % 4) of the q tile, feature n-tiles of half (warp / 4)
      const int qr = 16 * (warp % 4), lq = q0 + qr;
      const int nh = (dk8 + 1) >> 1, j0 = (warp / 4) * nh;
      if (lq < L && lq + 15 >= k0 && j0 < dk8) {
        float acc[NH][4];
#pragma unroll
        for (int jj = 0; jj < NH; ++jj) acc[jj][0] = acc[jj][1] = acc[jj][2] = acc[jj][3] = 0.f;
#pragma unroll
        for (int kk = 0; kk < kTileK / 8; ++kk) {
          uint32_t ah[4], al[4];
          load_a(dSs, kLdS, qr, 8 * kk, g, t, ah, al);
#pragma unroll
          for (int jj = 0; jj < NH; ++jj) {
            const int j = j0 + jj;
            if (jj < nh && j < dk8) {
              const float* kp = Ks + (8 * kk + t) * ldk + 8 * j + g;
              uint32_t bh_[2], bl_[2];
              split(kp[0], bh_[0], bl_[0]);
              split(kp[4 * ldk], bh_[1], bl_[1]);
              mma3(acc[jj], ah, al, bh_, bl_);
            }
          }
        }
        // lanes t and t^1 swap halves: an even lane holds row g, columns 2t .. 2t+3,
        // an odd lane row g+8, columns 2t-2 .. 2t+1
        const bool odd = t & 1;
        const int l = lq + g + (odd ? 8 : 0);
#pragma unroll
        for (int jj = 0; jj < NH; ++jj) {
          const int j = j0 + jj;
          const float s0 = odd ? acc[jj][0] : acc[jj][2], s1 = odd ? acc[jj][1] : acc[jj][3];
          const float r0 = __shfl_xor_sync(full, s0, 1), r1 = __shfl_xor_sync(full, s1, 1);
          const float x0 = (odd ? r0 : acc[jj][0]) * a.alpha, x1 = (odd ? r1 : acc[jj][1]) * a.alpha;
          const float x2 = (odd ? acc[jj][2] : r0) * a.alpha, x3 = (odd ? acc[jj][3] : r1) * a.alpha;
          const int c = 8 * j + 4 * (t >> 1);
          if (jj < nh && j < dk8 && l < L && c < dqk) {
            float* dst = a.dq + ((size_t)bh * L + l) * dqk + c;
            if (f.red_v4) {
              red_add_v4(dst, x0, x1, x2, x3);
            } else {
              atomicAdd(dst, x0);
              if (c + 1 < dqk) atomicAdd(dst + 1, x1);
              if (c + 2 < dqk) atomicAdd(dst + 2, x2);
              if (c + 3 < dqk) atomicAdd(dst + 3, x3);
            }
          }
        }
      }
    }
  }

  // dK, dV: the query splits' partials summed in a fixed order (split 0 + 1 + 2 + 3)
  cp_wait_all();
  __syncthreads();  // the stages are free
  float* part = stages;
  const int pw_words = 16 * (ldq + ldg);
  if (qs > 0) {
    float* dst = part + ((qs - 1) * kKeyGroups + kg) * pw_words;
#pragma unroll
    for (int j = 0; j < N; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = g + 8 * (i >> 1), c = 8 * j + 2 * t + (i & 1);
        if (j < dk8) dst[r * ldq + c] = dk[j][i];
        if (j < dv8) dst[16 * ldq + r * ldg + c] = dv[j][i];
      }
  }
  __syncthreads();
  if (qs == 0) {
    for (int s2 = 1; s2 < kQuerySplits; ++s2) {
      const float* src = part + ((s2 - 1) * kKeyGroups + kg) * pw_words;
#pragma unroll
      for (int j = 0; j < N; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = g + 8 * (i >> 1), c = 8 * j + 2 * t + (i & 1);
          if (j < dk8) dk[j][i] += src[r * ldq + c];
          if (j < dv8) dv[j][i] += src[16 * ldq + r * ldg + c];
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = m0 + g + 8 * (i >> 1);
      if (m < L) {
#pragma unroll
        for (int j = 0; j < N; ++j) {
          const int c = 8 * j + 2 * t + (i & 1);
          if (c < dqk) a.dk[((size_t)bh * L + m) * dqk + c] = dk[j][i] * a.alpha;
          if (c < dvd) a.dv[((size_t)bh * L + m) * dvd + c] = dv[j][i];
        }
      }
    }
  }
  if constexpr (kFull)
    write_table_slice(a.scratch + ((size_t)bh * gridDim.y + blockIdx.y) * (L + a.bk.nb + 1), gpos, gts, n_dist, L,
                      f.ts_copies, a.bk.nb, lay.nb4, has_time, kThreads2);
}

template <int N>
__global__ void __launch_bounds__(kThreads2, N <= 4 ? 2 : 1) bwd_fused_kernel(Fused f) {
  key_tile_body<N, true>(f);
}

template <int N>  // 3 CTAs (24 warps) per SM where N <= 4, as K2a
__global__ void __launch_bounds__(kThreads2, N <= 4 ? 3 : 1) bwd_kv_kernel(Fused f) {
  key_tile_body<N, false>(f);
}

template <int N, bool kFull>
cudaError_t launch_key_tiles(const Args& a, cudaStream_t stream, int* info) {
  Fused f;
  f.a = a;
  f.ldq = stride_a(a.dqk);
  f.ldg = stride_a(a.dv_dim);
  f.ldv = stride_a(a.dv_dim);
  f.ldk = kFull ? stride_b(a.dqk) : stride_a(a.dqk);  // K2b reads K only as an A fragment
  f.vec_q = a.dqk % 4 == 0 && aligned16(a.q);
  f.vec_k = a.dqk % 4 == 0 && aligned16(a.k);
  f.vec_v = a.dv_dim % 4 == 0 && aligned16(a.v);
  f.vec_g = a.dv_dim % 4 == 0 && aligned16(a.g);
  f.red_v4 = a.dqk % 4 == 0 && aligned16(a.dq);
  // The most that fits: for long sequences or wide heads the dts copies go
  // first (to one table per warp, then one table in turns), then the ring's
  // second stage
  size_t smem = 0;
  for (int option = 0; option < 6; ++option) {
    f.stages = option < 3 ? 2 : 1;
    f.ts_copies = option % 3 == 0 ? kTsCopies : option % 3 == 1 ? kWarps2 : 1;
    smem = sizeof(float) * layout2<kFull>(f, a.L, a.bk.nb).total;
    if (smem <= kMaxSmem) break;
  }
  if (smem > kMaxSmem) return kNoFit;
  const auto kernel = kFull ? bwd_fused_kernel<N> : bwd_kv_kernel<N>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  if (info != nullptr) {
    info[5] = kFull ? f.ts_copies : 0;
    return occupancy(kernel, kThreads2, smem, info);
  }
  const dim3 grid(a.B * a.H, (a.L + kTileK - 1) / kTileK);
  kernel<<<grid, kThreads2, smem, stream>>>(f);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K2a: 32-row q tiles (the source note at the top)
// ---------------------------------------------------------------------------

constexpr int kRowGroups = 2;                    // 16-row groups per CTA
constexpr int kKeySplits = 4;                    // warps sharing a row group, each its own keys
constexpr int kTileQa = 16 * kRowGroups;         // q rows per CTA
constexpr int kTileKa = 64;                      // keys per stage
constexpr int kWarpKeys = kTileKa / kKeySplits;  // keys per warp per stage: two 8-key n-tiles
static_assert(kRowGroups * kKeySplits == kWarps2 && kWarpKeys == 16, "8 warps, 16 keys each a stage");
static_assert(kKeySplits == 4, "the partial dq are summed as (0 + 2) + (1 + 3)");

struct DqArgs {
  Args a;
  int ldq, ldg, ldk, ldv;   // shared row strides, 4 mod 8 words
  int vec_q, vec_k, vec_v, vec_g;
  int stages;               // the K/V ring: 2 stages, or 1 where two do not fit
  int ts_copies;            // dts sums: kTsCopies, or kWarps2 (one table per warp), or 1 (one table, in turns)
};

// Shared memory, in 4-byte words (each part a multiple of 4 words):
//   Q [kTileQa][ldq]  G [kTileQa][ldg]  tq [kTileQa]  pw [L]  tw [nb+1]  thr [nb+1]
//   gpos [L]  gts [ts_copies][nb+1]  win [2][8][32] (a tile's dpos windows, by tile parity; none in turns)
//   1 or 2 stages of { K [kTileKa][ldk]  V [kTileKa][ldv]  tk [kTileKa]  mask words [kTileKa/4 + 4] },
//   the stages also holding two slots of partial dq per row group at the end.
// With one stage and one dts table this is never more than the first design took.
struct LayoutA {
  int q, g, tq, pw, tw, th, gpos, gts, win, L4, nb4, stage, stage_words, k, v, tk, km, total;
};

__host__ __device__ inline LayoutA layout_dq(const DqArgs& f, int L, int nb) {
  const int L4 = (L + 3) & ~3, nb4 = (nb + 1 + 3) & ~3;
  LayoutA o;
  o.q = 0;
  o.g = o.q + kTileQa * f.ldq;
  o.tq = o.g + kTileQa * f.ldg;
  o.pw = o.tq + kTileQa;
  o.L4 = L4;
  o.nb4 = nb4;
  o.tw = o.pw + L4;
  o.th = o.tw + nb4;
  o.gpos = o.th + nb4;
  o.gts = o.gpos + L4;
  o.win = o.gts + f.ts_copies * nb4;
  o.stage = o.win + (f.ts_copies > 1 ? 2 * kWinWarps * kWin : 0);
  o.k = 0;
  o.v = o.k + kTileKa * f.ldk;
  o.tk = o.v + kTileKa * f.ldv;
  o.km = o.tk + kTileKa;
  o.stage_words = o.km + kTileKa / 4 + 4;
  int stages = f.stages * o.stage_words;
  const int partials = 2 * kRowGroups * 16 * f.ldq;  // two slots per row group
  if (partials > stages) stages = partials;
  o.total = o.stage + stages;
  return o;
}

template <int N>  // n-tiles of 8 features: dqk, dv <= 8 * N; 3 CTAs (24 warps) per SM where N <= 4
__global__ void __launch_bounds__(kThreads2, N <= 4 ? 3 : 1) bwd_q_kernel(DqArgs f) {
  extern __shared__ __align__(16) float smem[];
  const Args& a = f.a;
  const int L = a.L, H = a.H;
  const LayoutA lay = layout_dq(f, L, a.bk.nb);
  float* Qs = smem + lay.q;
  float* Gs = smem + lay.g;
  int* tq = reinterpret_cast<int*>(smem + lay.tq);
  float* pw = smem + lay.pw;
  float* tw = smem + lay.tw;
  int* th = reinterpret_cast<int*>(smem + lay.th);
  float* gpos = smem + lay.gpos;
  float* gts = smem + lay.gts;
  float* win = smem + lay.win;
  float* stages = smem + lay.stage;

  const int bh = blockIdx.x, b = bh / H, h = bh - b * H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTileQa;  // heaviest q tiles first
  const int q_end = min(q0 + kTileQa, L);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int rg = warp % kRowGroups, ks = warp / kRowGroups;
  const bool has_time = a.ts != nullptr;
  const int dqk = a.dqk, dvd = a.dv_dim, ldq = f.ldq, ldg = f.ldg, ldk = f.ldk, ldv = f.ldv;
  const int dk8 = (dqk + 7) >> 3, dv8 = (dvd + 7) >> 3;
  const float* kb = a.k + (size_t)bh * L * dqk;
  const float* vb = a.v + (size_t)bh * L * dvd;
  const int* tsb = has_time ? a.ts + (size_t)b * L : nullptr;
  const float inv_norm = 1.f / (float)a.max_seq_len;
  const Lookup bucket(th, a.bk);
  float* my_gts = lane_table(gts, f.ts_copies, warp, t, lay.nb4);
  const int ts_copy = f.ts_copies == kTsCopies ? t : 0;
  const bool turns = f.ts_copies == 1;  // one gpos and one dts table, the warps adding in turns
  const bool ring = f.stages == 2;  // else the next k tile is copied once the current one is consumed
  // k tile kt's distances q0 - 64 kt - 63 + r, r < 95; warp w's window starts at r = 16 (rg - ks + 3)
  const auto win_start = [](int w) { return 16 * (w % kRowGroups - w / kRowGroups + 3); };

  auto stage_ptr = [&](int s) { return stages + s * lay.stage_words; };
  auto issue = [&](int kt, int s) {
    float* st = stage_ptr(s);
    const int k0 = kt * kTileKa;
    copy_rows(st + lay.k, ldk, kb, k0, kTileKa, L, dqk, f.vec_k, tid, kThreads2);
    copy_rows(st + lay.v, ldv, vb, k0, kTileKa, L, dvd, f.vec_v, tid, kThreads2);
    if (has_time) copy_stamps(reinterpret_cast<int*>(st + lay.tk), tsb, k0, kTileKa, L, tid);
    if (a.mask != nullptr)
      copy_mask(reinterpret_cast<int*>(st + lay.km), a.mask, (size_t)a.B * L, (size_t)b * L + k0, kTileKa, tid);
  };

  // Zero the padding columns that no copy writes (dqk .. 8*dk8, dv .. 8*dv8)
  // of Q, G and the stages, and the table-gradient sums; then the q tile,
  // its stamps, the first k tile and the tables.
  for (int r = tid; r < 2 * kTileQa + f.stages * kTileKa; r += kThreads2) {
    if (r < kTileQa) {
      for (int d = dqk; d < 8 * dk8; ++d) Qs[r * ldq + d] = 0.f;
    } else if (r < 2 * kTileQa) {
      for (int d = dvd; d < 8 * dv8; ++d) Gs[(r - kTileQa) * ldg + d] = 0.f;
    } else {
      float* st = stage_ptr((r - 2 * kTileQa) / kTileKa);
      const int rr = (r - 2 * kTileQa) % kTileKa;
      for (int d = dqk; d < 8 * dk8; ++d) st[lay.k + rr * ldk + d] = 0.f;
      for (int d = dvd; d < 8 * dv8; ++d) st[lay.v + rr * ldv + d] = 0.f;
    }
  }
  copy_rows(Qs, ldq, a.q + (size_t)bh * L * dqk, q0, kTileQa, L, dqk, f.vec_q, tid, kThreads2);
  copy_rows(Gs, ldg, a.g + (size_t)bh * L * dvd, q0, kTileQa, L, dvd, f.vec_g, tid, kThreads2);
  if (has_time) copy_stamps(tq, tsb, q0, kTileQa, L, tid);
  issue(0, 0);
  cp_commit();
  for (int d = tid; d < q_end; d += kThreads2) pw[d] = a.pos_w[(size_t)(a.max_seq_len - 1 - d) * H + h];
  for (int i = tid; i < lay.stage - lay.gpos; i += kThreads2) gpos[i] = 0.f;  // gpos, gts, win
  if (has_time)
    for (int u = tid; u <= a.bk.nb; u += kThreads2) {
      tw[u] = a.ts_w[(size_t)u * H + h];
      th[u] = a.thr[u];
    }

  float acc[N][4];  // dq / alpha: rows g, g+8 of the warp's 16, columns 8j + 2t, 8j + 2t + 1
#pragma unroll
  for (int j = 0; j < N; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  const int r0 = q0 + 16 * rg;             // this warp's first row
  const int r_last = min(r0 + 15, L - 1);  // its last real row
  const int n_kt = (q_end - 1) / kTileKa + 1;  // k tiles up to the causal frontier
  for (int kt = 0; kt < n_kt; ++kt) {
    cp_wait_all();
    __syncthreads();  // B1: k tile kt visible; every warp is done with tile kt-1's stage and dpos windows
    if (ring) {
      if (kt + 1 < n_kt) issue(kt + 1, (kt + 1) & 1);
      cp_commit();
    }
    if (kt > 0 && !turns)
      flush_pos_windows(gpos, win + ((kt - 1) & 1) * kWinWarps * kWin, q0 - (kt - 1) * kTileKa - (kTileKa - 1), q_end, win_start);
    const float* st = stage_ptr(ring ? kt & 1 : 0);
    const float* Ks = st + lay.k;
    const float* Vs = st + lay.v;
    const int* tk = reinterpret_cast<const int*>(st + lay.tk);
    const uint8_t* km = reinterpret_cast<const uint8_t*>(st + lay.km) +
                        (a.mask != nullptr ? mask_offset(a.mask, (size_t)b * L + kt * kTileKa) : 0);
    const int c0 = ks * kWarpKeys, m0 = kt * kTileKa + c0;  // this warp's first key
    if (r0 < L && m0 <= r_last) {                            // warp-uniform: some pair with m <= l
      // s: S, da: dA then dS; element (nt, i) is row r0 + g + 8(i>>1), key m0 + 8nt + 2t + (i&1)
      float s[2][4], da[2][4];
      int bk[2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          s[nt][i] = da[nt][i] = 0.f;
          bk[nt][i] = -1;
        }
      for (int dd = 0; dd < dk8; ++dd) {
        uint32_t ah[4], al[4];
        load_a(Qs, ldq, 16 * rg, 8 * dd, g, t, ah, al);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const float* kp = Ks + (c0 + 8 * nt + g) * ldk + 8 * dd + t;
          uint32_t bh_[2], bl_[2];
          split(kp[0], bh_[0], bl_[0]);
          split(kp[4], bh_[1], bl_[1]);
          mma3(s[nt], ah, al, bh_, bl_);
        }
      }
      for (int dd = 0; dd < dv8; ++dd) {
        uint32_t ah[4], al[4];
        load_a(Gs, ldg, 16 * rg, 8 * dd, g, t, ah, al);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const float* vp = Vs + (c0 + 8 * nt + g) * ldv + 8 * dd + t;
          uint32_t bh_[2], bl_[2];
          split(vp[0], bh_[0], bl_[0]);
          split(vp[4], bh_[1], bl_[1]);
          mma3(da[nt], ah, al, bh_, bl_);
        }
      }
      const int tq_r[2] = {has_time ? tq[16 * rg + g] : 0, has_time ? tq[16 * rg + g + 8] : 0};
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int l = r0 + g + 8 * (i >> 1);
          const int c = c0 + 8 * nt + 2 * t + (i & 1);
          const int m = kt * kTileKa + c;
          float dsv = 0.f;
          if (l < L && m <= l && (a.mask == nullptr || km[c])) {
            float x = pw[l - m];
            if (has_time) {
              const int u = bucket(tq_r[i >> 1], tk[c]);
              x += tw[u];
              bk[nt][i] = u;
            }
            x = fmaf(s[nt][i], a.alpha, x);
            const float sig = __fdividef(1.f, 1.f + __expf(-x));  // exp overflow: 0
            dsv = da[nt][i] * (sig * (1.f + x * (1.f - sig))) * inv_norm;
          }
          da[nt][i] = dsv;
        }

      // dQ += dS K: keys 2t and 2t+1 of each 8-key group are A columns t and t+4
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        uint32_t ah[4], al[4];
        split(da[kk][0], ah[0], al[0]);
        split(da[kk][2], ah[1], al[1]);
        split(da[kk][1], ah[2], al[2]);
        split(da[kk][3], ah[3], al[3]);
        const float* kp = Ks + (c0 + 8 * kk + 2 * t) * ldk + g;
#pragma unroll
        for (int j = 0; j < N; ++j) {
          if (j < dk8) {
            uint32_t bh_[2], bl_[2];
            split(kp[8 * j], bh_[0], bl_[0]);
            split(kp[ldk + 8 * j], bh_[1], bl_[1]);
            mma3(acc[j], ah, al, bh_, bl_);
          }
        }
      }

      // dpos: this lane's values by local distance (row - key) = 8n + (g - 2t) - (i&1), n = (i>>1) - nt
      float part[3][2];
#pragma unroll
      for (int n = 0; n < 3; ++n) part[n][0] = part[n][1] = 0.f;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) part[(i >> 1) - nt + 1][i & 1] += da[nt][i];
      wait_turn(turns, warp);
      add_pos_grads<-1>(turns ? gpos : win + ((kt & 1) * kWinWarps + warp) * kWin, turns ? r0 - m0 : 15, turns ? q_end : kWin, part, g, t);
      if (has_time) {
        // dts into the warp's own sums: the lane's values key by key along each of
        // its two rows, so that its runs of equal buckets fold before an add
        float dsr[8];
        int bkr[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int ii = e >> 2, nt = (e >> 1) & 1, j = e & 1;
          dsr[e] = da[nt][2 * ii + j];
          bkr[e] = bk[nt][2 * ii + j];
        }
        add_ts_grads<8>(my_gts, ts_copy, dsr, bkr);
      }
      pass_turn(turns, warp);
    } else {
      wait_turn(turns, warp);  // no pairs: the turn passes on
      pass_turn(turns, warp);
    }
    if (!ring) {
      __syncthreads();  // B2: the stage is consumed
      if (kt + 1 < n_kt) issue(kt + 1, 0);
      cp_commit();
    }
  }

  // Sum the key splits' partial dq in a fixed order, (0 + 2) + (1 + 3),
  // through two slots per row group: splits 2 and 3 hand theirs to 0 and 1,
  // then split 1 its sum to split 0
  cp_wait_all();
  __syncthreads();  // the stages are free; the last tile's dpos windows are complete
  if (!turns)
    flush_pos_windows(gpos, win + ((n_kt - 1) & 1) * kWinWarps * kWin, q0 - (n_kt - 1) * kTileKa - (kTileKa - 1), q_end, win_start);
  auto slot = [&](int i) { return stages + (i * kRowGroups + rg) * 16 * ldq; };
  auto put = [&](float* dst) {
#pragma unroll
    for (int j = 0; j < N; ++j)
      if (j < dk8) {
        dst[g * ldq + 8 * j + 2 * t] = acc[j][0];
        dst[g * ldq + 8 * j + 2 * t + 1] = acc[j][1];
        dst[(g + 8) * ldq + 8 * j + 2 * t] = acc[j][2];
        dst[(g + 8) * ldq + 8 * j + 2 * t + 1] = acc[j][3];
      }
  };
  auto take = [&](const float* src) {
#pragma unroll
    for (int j = 0; j < N; ++j)
      if (j < dk8) {
        acc[j][0] += src[g * ldq + 8 * j + 2 * t];
        acc[j][1] += src[g * ldq + 8 * j + 2 * t + 1];
        acc[j][2] += src[(g + 8) * ldq + 8 * j + 2 * t];
        acc[j][3] += src[(g + 8) * ldq + 8 * j + 2 * t + 1];
      }
  };
  if (ks >= 2) put(slot(ks - 2));
  __syncthreads();
  if (ks < 2) take(slot(ks));
  __syncthreads();
  if (ks == 1) put(slot(0));
  __syncthreads();  // also: every warp's table sums are in gpos / gts
  if (ks == 0 && r0 < L) {
    take(slot(0));
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int l = r0 + g + 8 * i;
      if (l < L) {
        float* dst = a.dq + ((size_t)bh * L + l) * dqk;
#pragma unroll
        for (int j = 0; j < N; ++j) {
          const int c = 8 * j + 2 * t;
          if (c < dqk) dst[c] = acc[j][2 * i] * a.alpha;
          if (c + 1 < dqk) dst[c + 1] = acc[j][2 * i + 1] * a.alpha;
        }
      }
    }
  }
  write_table_slice(a.scratch + ((size_t)bh * gridDim.y + blockIdx.y) * (L + a.bk.nb + 1), gpos, gts, q_end, L,
                    f.ts_copies, a.bk.nb, lay.nb4, has_time, kThreads2);
}

template <int N>
cudaError_t launch_dq(const Args& a, cudaStream_t stream, int* info) {
  DqArgs f;
  f.a = a;
  f.ldq = f.ldk = stride_a(a.dqk);
  f.ldg = f.ldv = stride_a(a.dv_dim);
  f.vec_q = a.dqk % 4 == 0 && aligned16(a.q);
  f.vec_k = a.dqk % 4 == 0 && aligned16(a.k);
  f.vec_v = a.dv_dim % 4 == 0 && aligned16(a.v);
  f.vec_g = a.dv_dim % 4 == 0 && aligned16(a.g);
  // As K2: the dts copies go first, then the ring's second stage
  size_t smem = 0;
  for (int option = 0; option < 6; ++option) {
    f.stages = option < 3 ? 2 : 1;
    f.ts_copies = option % 3 == 0 ? kTsCopies : option % 3 == 1 ? kWarps2 : 1;
    smem = sizeof(float) * layout_dq(f, a.L, a.bk.nb).total;
    if (smem <= kMaxSmem) break;
  }
  if (smem > kMaxSmem) return kNoFit;
  cudaError_t err = cudaFuncSetAttribute(bwd_q_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  if (info != nullptr) {
    info[5] = f.ts_copies;
    return occupancy(bwd_q_kernel<N>, kThreads2, smem, info);
  }
  const dim3 grid(a.B * a.H, (a.L + kTileQa - 1) / kTileQa);
  bwd_q_kernel<N><<<grid, kThreads2, smem, stream>>>(f);
  return cudaGetLastError();
}

template <int N>
cudaError_t dispatch(int which, const Args& a, cudaStream_t st, int* info) {
  if (which == 0) return launch_key_tiles<N, true>(a, st, info);
  if (which == 1) return launch_dq<N>(a, st, info);
  return launch_key_tiles<N, false>(a, st, info);
}

int run_narrow(int which, const void* q, const void* k, const void* v, const void* g, const void* pos_w, const void* ts_w,
        const void* thr, const void* ts, const void* mask, void* dq, void* dk, void* dv, void* dpos, void* dts, void* scratch, int B,
        int H, int L, int dqk, int dv_dim, int max_seq_len, int num_buckets, float alpha, int fn_log, int minutes,
        float divisor, void* stream, int* info) {
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
  a.scratch = static_cast<float*>(scratch);
  a.B = B;
  a.H = H;
  a.L = L;
  a.dqk = dqk;
  a.dv_dim = dv_dim;
  a.max_seq_len = max_seq_len;
  a.alpha = alpha;
  a.bk = Buckets{num_buckets, fn_log, minutes, divisor};
  auto st = static_cast<cudaStream_t>(stream);
  const int width = dqk > dv_dim ? dqk : dv_dim;
  if (width > 128) return kNoFit;
  // N: 8-wide n-tiles of dq / dk / dv per warp
  if (width <= 8) return dispatch<1>(which, a, st, info);
  if (width <= 16) return dispatch<2>(which, a, st, info);
  if (width <= 32) return dispatch<4>(which, a, st, info);
  if (width <= 64) return dispatch<8>(which, a, st, info);
  return dispatch<16>(which, a, st, info);
}

// The backward of one entry (which: 0 K2, 1 K2a, 2 K2b): the tensor-core
// kernel where it takes the shape, then for K2 and K2a the fixed-order sum
// of the CTAs' table slices into dpos and dts; else the width-tiled
// variants (hstu_wide.cuh), K2 being K2a's then K2b's.
int run(int which, const void* q, const void* k, const void* v, const void* g, const void* pos_w, const void* ts_w,
        const void* thr, const void* ts, const void* mask, void* dq, void* dk, void* dv, void* dpos, void* dts,
        void* scratch, int B, int H, int L, int dqk, int dv_dim, int max_seq_len, int num_buckets, float alpha,
        int fn_log, int minutes, float divisor, void* stream, int* info, int* taken) {
  if (which < 0 || which > 2 || dqk < 1 || dv_dim < 1 || L < 1 || L > max_seq_len || num_buckets < 0)
    return cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
  return wide::dispatch(
      [&] {
        const cudaError_t rc = static_cast<cudaError_t>(run_narrow(which, q, k, v, g, pos_w, ts_w, thr, ts, mask, dq, dk, dv,
                                                                   dpos, dts, scratch, B, H, L, dqk, dv_dim, max_seq_len,
                                                                   num_buckets, alpha, fn_log, minutes, divisor, stream, info));
        if (rc != cudaSuccess || info != nullptr || which == 2) return rc;
        return reduce_tables(static_cast<const float*>(scratch), (L + 31) / 32, B, H, L, num_buckets, max_seq_len,
                             ts != nullptr, static_cast<float*>(dpos), static_cast<float*>(dts), st);
      },
      [&] {
        wide::Args w{};
        w.q = q, w.k = k, w.v = v, w.g = g;
        w.pos_w = static_cast<const float*>(pos_w), w.ts_w = static_cast<const float*>(ts_w);
        w.thr = static_cast<const int*>(thr), w.ts = static_cast<const int*>(ts);
        w.mask = static_cast<const uint8_t*>(mask);
        w.scratch = static_cast<float*>(scratch), w.dpos = static_cast<float*>(dpos), w.dts = static_cast<float*>(dts);
        w.B = B, w.H = H, w.L = L, w.dqk = dqk, w.dv = dv_dim, w.max_seq_len = max_seq_len;
        w.alpha = alpha, w.norm = (float)max_seq_len, w.bk = Buckets{num_buckets, fn_log, minutes, divisor};
        w.out_f32 = which == 0;  // K2's dq: f32 either way
        if (which != 2) {
          w.out0 = dq;
          const cudaError_t rc = wide::launch<float, wide::kDq, true>(w, st, info);
          if (rc != cudaSuccess || which == 1) return rc;
        }
        if (info != nullptr && which == 0) return cudaSuccess;  // K2's occupancy: its first kernel's
        w.out0 = dk, w.out1 = dv;
        return wide::launch<float, wide::kDkv, true>(w, st, info);
      },
      taken, info);
}

}  // namespace

// All three take the same arguments.  q, k, g-shaped (B, H, L, dqk / dv)
// inputs and outputs are fp32 and contiguous; pos_w (2*max_seq_len-1, H),
// ts_w (num_buckets+1, H); thr (num_buckets+1,) int32; ts (B, L) int32 or
// null (position bias only); mask (B, L) bool or null (all keys valid); the
// bucket config fn_log (0 sqrt, 1 log), minutes (1: |dt| / 60 first),
// divisor.  Outputs a kernel does not produce are ignored (pass null).  dq
// of hstu_rab_bwd must be zeroed by the caller: it is accumulated with
// vector reductions.  dpos / dts: every row a distance 0 .. L-1 (every
// bucket) reaches is written, the rest of dpos is the caller's (zeros).
// scratch (K2, K2a): B * H * ceil(L / 32) * (L + num_buckets + 1) floats,
// the CTAs' table slices.  *taken (may be null): 0 the tensor-core kernel
// ran, 1 the width-tiled variant (any dqk, dv).  Each returns the
// cudaError_t of its launch.
#define RAB_BWD_ARGS                                                                                              \
  const void *q, const void *k, const void *v, const void *g, const void *pos_w, const void *ts_w, const void *thr, \
      const void *ts, const void *mask, void *dq, void *dk, void *dv, void *dpos, void *dts, void *scratch, int B,    \
      int H, int L, int dqk, int dv_dim, int max_seq_len, int num_buckets, float alpha, int fn_log, int minutes,     \
      float divisor, void *stream, int *taken
#define RAB_BWD_PASS                                                                                                 \
  q, k, v, g, pos_w, ts_w, thr, ts, mask, dq, dk, dv, dpos, dts, scratch, B, H, L, dqk, dv_dim, max_seq_len,      \
      num_buckets, alpha, fn_log, minutes, divisor, stream

extern "C" int hstu_rab_bwd(RAB_BWD_ARGS) { return run(0, RAB_BWD_PASS, nullptr, taken); }

extern "C" int hstu_rab_bwd_dq(RAB_BWD_ARGS) { return run(1, RAB_BWD_PASS, nullptr, taken); }

extern "C" int hstu_rab_bwd_dkv(RAB_BWD_ARGS) { return run(2, RAB_BWD_PASS, nullptr, taken); }

// A backward kernel (which: 0 K2, 1 K2a, 2 K2b) as this shape would launch
// it, without launching it: info[0] resident CTAs per SM, info[1] registers
// per thread, info[2] dynamic shared memory bytes per CTA, info[4] 0 the
// tensor-core kernel, 1 the width-tiled variant, info[5] the tensor-core
// K2's or K2a's dts tables (32, 8, or 1 added to in turns; left as it is
// otherwise).  info holds 6 ints.  Returns the cudaError_t.
extern "C" int hstu_rab_bwd_occupancy(int which, int L, int dqk, int dv_dim, int max_seq_len, int num_buckets, int* info) {
  return run(which, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
             nullptr, nullptr, nullptr, nullptr, 1, 1, L, dqk, dv_dim, max_seq_len, num_buckets, 1.f, 0, 0, 1.f, nullptr,
             info, nullptr);
}

extern "C" const char* hstu_rab_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
