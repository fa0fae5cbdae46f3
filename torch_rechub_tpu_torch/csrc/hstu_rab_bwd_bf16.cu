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
// 7.3 MB of bf16 q/k/v/g/dk/dv and f32 dq (0.0022 ms at 3.35 TB/s); K2a
// 0.38 GFLOP against 5.2 MB of q/k/v/g/dq (0.0016 ms), K2b 0.50 GFLOP
// against 6.3 MB of q/k/v/g/dk/dv (0.0019 ms).  All three are bounded by
// bytes; what they really spend is the per-pair work the tensor cores do
// not do (bias, bucket, silu', the table sums) and latency.
//
// K2 and K2b (key_tile_body<N, kFull>, K2b being K2 with kFull = false: one
// body, so the two cannot drift apart and K2b's dk, dv equal K2's bit for
// bit; kFull compiles out the dS^T store and its barrier, the dQ products
// and reductions, the table sums and their shared memory) take fp32 K2's
// Hopper design (hstu_rab_bwd.cu) in bf16:
// - CTA = 8 warps over a 32-key tile: 2 key groups of 16 x 4 query splits,
//   each warp 16 of every 64-query tile, the q tiles walked from the
//   diagonal to L.  512 CTAs at the serving shape, low key tiles (which walk
//   the most q tiles) first.
// - Latency: Q, G and the query stamps of the next q tile are copied with
//   cp.async (16-byte .cg, zero-filled past L) into a two-stage ring during
//   the current tile's math.  K2 has two barriers a tile (the second for
//   dS^T), K2b one.  An operand whose width is not a multiple of 8, or whose
//   address is not 16-byte aligned, is staged with plain loads into the same
//   ring.  Where two stages do not fit, one stage is refilled after the
//   tile's second barrier.
// - mma.sync m16n8k16 bf16 -> f32, every fragment loaded with ldmatrix
//   (transposed where the product reads a tile along its rows), row strides
//   8 mod 16 elements: no bank conflicts.  S^T = K Q^T and dA^T = V G^T with
//   the warp's keys as rows; P^T and dS^T, rounded to bf16 pairwise, are the
//   A fragments of dV += P^T G and dK += dS^T Q as they are.
// - K2's dq: each warp stores its bf16 dS^T pairs to shared memory as
//   [key][query]; after the tile's second barrier the 8 warps form
//   dQ_part = dS K (dS's A fragment transposed out of dS^T), 16 queries by
//   half the features each, and add alpha dQ_part to the f32 dq with lanes
//   swapping halves so that each holds four consecutive floats: one
//   red.global.add.v4.f32 each (scalar atomics where dqk % 4 or the
//   buffer's alignment forbid).  The order of these sums changes from run
//   to run; the wrapper rounds dq to bf16.
// - dpos and dts from the unrounded dS before the dV and dK products, so
//   the pairs' buckets are dead by then: K2's sums (hstu_rab_common.cuh) into
//   one CTA-wide gpos and a dts copy per warp and lane column (32), or one
//   table where the copies do not fit; one global atomic per nonzero slot
//   at the end.
// - dK and dV: the four query splits' partials summed in f32 in a fixed
//   order, (0 + 2) + (1 + 3), through one slot per key group in the freed
//   ring: the same bits from run to run.
// - Registers: launch bounds of 3 CTAs (24 warps) per SM for K2 and K2b at
//   dqk, dv <= 32.  K2 then spills a little (84 B of stores, 212 B of
//   loads a thread at dqk, dv <= 32), yet ran faster at both the serving
//   shape and L1024 than at 2 CTAs and 128 registers without spills.  At
//   the serving shape on an H100: K2 80 registers, 50,976 B of shared
//   memory, 3 CTAs per SM (the first design: 4 warps, 223 registers, 2
//   CTAs, 8 warps per SM); K2b 80 registers, no spills, 28,448 B, 3 CTAs.
//
// K2a (bwd_q_kernel) keeps the simple first design and the TPU kernel's
// ownership: one CTA owns 64 q rows and walks the 64-key tiles up to the
// causal frontier, so dq is summed in f32 registers and written once in
// bf16, with no atomics and no zeroed output.  It is the first K1-bf16's
// loop run backward:
// - CTA = 4 warps, each 16 rows, heaviest q tile first (grid y reversed);
//   operands staged in shared memory with plain loads (16-byte where the
//   width and address allow, else 2-byte), one stage, two barriers a tile.
// - S = Q K^T and dA = G V^T share one fragment layout, so dS is formed in
//   registers and, rounded to bf16 pairwise, is the A fragment of
//   dQ += dS K as is (K's B fragment pairs two rows of one column): dS never
//   touches shared memory, and dq is the same bit for bit from run to run.
// - dpos and dts by causal distance over its q tile's pairs (distances 0 ..
//   q_end-1), with K2's sums into a dts copy per warp and lane column.
// K2a at the serving shape: 168 registers, 32,800 B, 3 CTAs per SM.
// Registers and shared memory: ptxas's report in the build log, and
// hstu_rab_bwd_bf16_occupancy (with K2's and K2b's ring stages).

#include "hstu_rab_common.cuh"

namespace {

using namespace rab;
using bf16 = __nv_bfloat16;

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
  int ldk, ldv;     // shared row strides in elements, 8 mod 16: pk + 8 (Q, K), pv + 8 (G, V)
  int vec_q, vec_k, vec_v, vec_g;
  int ts_copies;    // dts copies per warp and lane column, or 1 where they do not fit
  int stages;       // K2, K2b: the Q/G ring, 2 stages or 1 where two do not fit
  int red_v4;       // K2: dq by vector reductions
};

inline int round_up(int x, int m) { return (x + m - 1) / m * m; }
__host__ __device__ inline int align16(int bytes) { return (bytes + 15) & ~15; }
inline bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

// The CTA's table sums into the zeroed global outputs: the dts copies added
// in a fixed order, one atomic per nonzero slot
__device__ __forceinline__ void flush_table_grads(const Args& a, const float* gpos, const float* gts, int n_dist,
                                                  int nb4, int h, int nthreads) {
  for (int d = threadIdx.x; d < n_dist; d += nthreads)
    if (gpos[d] != 0.f) atomicAdd(&a.dpos[(size_t)(a.max_seq_len - 1 - d) * a.H + h], gpos[d]);
  if (a.ts != nullptr)
    for (int u = threadIdx.x; u <= a.bk.nb; u += nthreads) {
      float sum = 0.f;
      for (int w = 0; w < a.ts_copies; ++w) sum += gts[w * nb4 + u];
      if (sum != 0.f) atomicAdd(&a.dts[(size_t)u * a.H + h], sum);
    }
}

// ---------------------------------------------------------------------------
// K2 and K2b: 32-key tiles of 8 warps (the source note at the top)
// ---------------------------------------------------------------------------

constexpr int kKeyGroups = 2;                          // 16-key groups per CTA
constexpr int kQuerySplits = 4;                        // warps sharing a key group, each 16 queries of a q tile
constexpr int kWarpsK = kKeyGroups * kQuerySplits;
constexpr int kThreadsK = 32 * kWarpsK;
constexpr int kTileKK = 16 * kKeyGroups;               // keys per CTA
constexpr int kTileQK = 16 * kQuerySplits;             // queries per q tile (stage)
constexpr int kLdST = kTileQK + 8;                     // dS^T [key][query] row stride in elements, 8 mod 16
constexpr int kTsCopiesK = 4 * kWarpsK;                // dts sums: one copy per warp and lane column t
static_assert(kQuerySplits == 4, "the partial dK, dV are summed as (0 + 2) + (1 + 3)");

// Shared memory in bytes, each part 16-byte aligned:
//   K [kTileKK][ldk]  V [kTileKK][ldv] (bf16)  tk [kTileKK]  kvalid [kTileKK] (int)  dS^T [kTileKK][kLdST] (bf16)
//   pw [L]  tw [nb+1] (f32)  thr [nb+1] (int)  gpos [L]  gts [ts_copies][nb+1] (f32)
//   1 or 2 stages of { Q [kTileQK][ldk]  G [kTileQK][ldv] (bf16)  tq [kTileQK] (int) },
//   the stages also holding one slot of partial dK, dV per key group at the
//   end, [kKeyGroups][16][ldk + ldv] f32: no more than a stage's Q and G.
// K2b (kFull false) has no dS^T, gpos or gts.  With one stage and one dts
// table this is never more than the first design (4 warps over 64-key
// tiles, Q, G, K, V and dS 64 rows each) took.
struct KeyLayout {
  int k, v, tk, kv, ds, pw, tw, th, gpos, gts, nb4, stage, stage_bytes, sq, sg, stq, total;
};

template <bool kFull>
__host__ __device__ inline KeyLayout key_layout(int ldk, int ldv, int L, int nb, int ts_copies, int stages) {
  KeyLayout o;
  o.nb4 = (nb + 1 + 3) & ~3;
  o.k = 0;
  o.v = o.k + align16(2 * kTileKK * ldk);
  o.tk = o.v + align16(2 * kTileKK * ldv);
  o.kv = o.tk + 4 * kTileKK;
  o.ds = o.kv + 4 * kTileKK;
  o.pw = o.ds + (kFull ? align16(2 * kTileKK * kLdST) : 0);
  o.tw = o.pw + align16(4 * L);
  o.th = o.tw + 4 * o.nb4;
  o.gpos = o.th + 4 * o.nb4;
  o.gts = o.gpos + (kFull ? align16(4 * L) : 0);
  o.stage = o.gts + (kFull ? 4 * ts_copies * o.nb4 : 0);
  o.sq = 0;
  o.sg = o.sq + align16(2 * kTileQK * ldk);
  o.stq = o.sg + align16(2 * kTileQK * ldv);
  o.stage_bytes = o.stq + 4 * kTileQK;
  int area = stages * o.stage_bytes;
  const int partials = 4 * kKeyGroups * 16 * (ldk + ldv);
  if (partials > area) area = partials;
  o.total = o.stage + area;
  return o;
}

// kFull: K2 (dq, dk, dv, dpos, dts); else K2b (dk, dv)
template <int N, bool kFull>  // n-tiles of 8 features: dqk, dv <= 8 * N
__device__ __forceinline__ void key_tile_body(const Args& a) {
  constexpr int NH = (N + 1) / 2;  // dQ n-tiles per warp (two warps share a row group)
  extern __shared__ __align__(16) unsigned char smem[];
  const int L = a.L, H = a.H, ldk = a.ldk, ldv = a.ldv;
  const KeyLayout lay = key_layout<kFull>(ldk, ldv, L, a.bk.nb, a.ts_copies, a.stages);
  bf16* Ks = reinterpret_cast<bf16*>(smem + lay.k);
  bf16* Vs = reinterpret_cast<bf16*>(smem + lay.v);
  int* tk = reinterpret_cast<int*>(smem + lay.tk);
  int* kvalid = reinterpret_cast<int*>(smem + lay.kv);
  bf16* dST = reinterpret_cast<bf16*>(smem + lay.ds);
  float* pw = reinterpret_cast<float*>(smem + lay.pw);
  float* tw = reinterpret_cast<float*>(smem + lay.tw);
  int* th = reinterpret_cast<int*>(smem + lay.th);
  float* gpos = reinterpret_cast<float*>(smem + lay.gpos);
  float* gts = reinterpret_cast<float*>(smem + lay.gts);
  unsigned char* stages = smem + lay.stage;

  const int bh = blockIdx.x, b = bh / H, h = bh - b * H;
  const int k0 = blockIdx.y * kTileKK;  // low key tiles, which walk the most q tiles, first
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int kg = warp % kKeyGroups, qs = warp / kKeyGroups;
  const bool has_time = a.ts != nullptr;
  const int dqk = a.dqk, dvd = a.dv_dim;
  const int dk8 = (dqk + 7) >> 3, dv8 = (dvd + 7) >> 3, nkc = a.pk >> 4, nvc = a.pv >> 4;
  const bf16* qb = a.q + (size_t)bh * L * dqk;
  const bf16* gb = a.g + (size_t)bh * L * dvd;
  const int* tsb = has_time ? a.ts + (size_t)b * L : nullptr;
  const float inv_n = 1.f / (float)a.max_seq_len;
  const Lookup bucket(th, a.bk);
  const LdsmLane ll(lane);
  const int n_dist = L - k0;  // causal distances this key tile can see: 0 .. L-1-k0
  // lanes of one t share no distance chain; one table for all where the copies do not fit
  float* my_gts = gts + (a.ts_copies > 1 ? 4 * warp + t : 0) * lay.nb4;
  const bool ring = a.stages == 2;  // else the next q tile is copied once the current one is consumed

  auto stage_ptr = [&](int s) { return stages + s * lay.stage_bytes; };
  auto issue = [&](int qt, int s) {
    unsigned char* st = stage_ptr(s);
    copy_rows_bf16(reinterpret_cast<bf16*>(st + lay.sq), ldk, qb, qt * kTileQK, kTileQK, L, dqk, a.pk, a.vec_q, tid, kThreadsK);
    copy_rows_bf16(reinterpret_cast<bf16*>(st + lay.sg), ldv, gb, qt * kTileQK, kTileQK, L, dvd, a.pv, a.vec_g, tid, kThreadsK);
    if (has_time) copy_stamps(reinterpret_cast<int*>(st + lay.stq), tsb, qt * kTileQK, kTileQK, L, tid);
  };

  // Zero the padding columns that the 16-byte copies leave (dqk .. pk-1 of K
  // and Q, dv .. pv-1 of V and G) and the table-gradient sums; then the key
  // tile, its stamps and validity, the first q tile, the tables.
  const bf16 zero = __float2bfloat16(0.f);
  for (int r = tid; r < kTileKK + a.stages * kTileQK; r += kThreadsK) {
    bf16 *kr, *vr;
    if (r < kTileKK) {
      kr = Ks + r * ldk;
      vr = Vs + r * ldv;
    } else {
      unsigned char* st = stage_ptr((r - kTileKK) / kTileQK);
      const int rr = (r - kTileKK) % kTileQK;
      kr = reinterpret_cast<bf16*>(st + lay.sq) + rr * ldk;
      vr = reinterpret_cast<bf16*>(st + lay.sg) + rr * ldv;
    }
    for (int d = dqk; d < a.pk; ++d) kr[d] = zero;
    for (int d = dvd; d < a.pv; ++d) vr[d] = zero;
  }
  for (int d = tid; d < n_dist; d += kThreadsK) {
    pw[d] = a.pos_w[(size_t)(a.max_seq_len - 1 - d) * H + h];
    if constexpr (kFull) gpos[d] = 0.f;
  }
  if constexpr (kFull)
    for (int i = tid; i < a.ts_copies * lay.nb4; i += kThreadsK) gts[i] = 0.f;
  if (has_time)
    for (int u = tid; u <= a.bk.nb; u += kThreadsK) {
      tw[u] = a.ts_w[(size_t)u * H + h];
      th[u] = a.thr[u];
    }
  if (tid < kTileKK) {
    const int m = k0 + tid;
    kvalid[tid] = m < L && (a.mask == nullptr || a.mask[(size_t)b * L + m] != 0);
  }
  copy_rows_bf16(Ks, ldk, a.k + (size_t)bh * L * dqk, k0, kTileKK, L, dqk, a.pk, a.vec_k, tid, kThreadsK);
  copy_rows_bf16(Vs, ldv, a.v + (size_t)bh * L * dvd, k0, kTileKK, L, dvd, a.pv, a.vec_v, tid, kThreadsK);
  if (has_time) copy_stamps(tk, tsb, k0, kTileKK, L, tid);
  const int qt0 = k0 / kTileQK, n_qt = (L + kTileQK - 1) / kTileQK;
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
    __syncthreads();  // B1: q tile qt visible; the last tile's stage and dS^T consumed
    if (ring) {
      if (qt + 1 < n_qt) issue(qt + 1, (qt + 1 - qt0) & 1);
      cp_commit();
    }
    const unsigned char* st = stage_ptr(ring ? (qt - qt0) & 1 : 0);
    const bf16* Qs = reinterpret_cast<const bf16*>(st + lay.sq);
    const bf16* Gs = reinterpret_cast<const bf16*>(st + lay.sg);
    const int* tq = reinterpret_cast<const int*>(st + lay.stq);
    const int q0 = qt * kTileQK, l0 = q0 + qq0;

    uint32_t sf[4] = {0u, 0u, 0u, 0u};  // dS^T as the bf16 A fragment of dK (zeros from a warp with no valid pair)
    const bool active = l0 < L && m0 < L && l0 + 15 >= m0;  // warp-uniform: some pair with m <= l
    if (active) {
      // sc: S^T then P^T, da: dA^T then dS^T; element (nt, i) is key kk0 + g + 8 (i >> 1),
      // query qq0 + 8 nt + 2t + (i & 1) of the tiles
      float sc[2][4], da[2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) sc[nt][i] = da[nt][i] = 0.f;
      for (int kc = 0; kc < nkc; ++kc) {
        uint32_t af[4], bf[4];
        ldsm_x4(af, Ks + (kk0 + ll.a_row) * ldk + 16 * kc + ll.a_col);
        ldsm_x4(bf, Qs + (qq0 + ll.bn_row) * ldk + 16 * kc + ll.bn_col);
        mma_bf16(sc[0], af, bf);
        mma_bf16(sc[1], af, bf + 2);
      }
      for (int kc = 0; kc < nvc; ++kc) {
        uint32_t af[4], bf[4];
        ldsm_x4(af, Vs + (kk0 + ll.a_row) * ldv + 16 * kc + ll.a_col);
        ldsm_x4(bf, Gs + (qq0 + ll.bn_row) * ldv + 16 * kc + ll.bn_col);
        mma_bf16(da[0], af, bf);
        mma_bf16(da[1], af, bf + 2);
      }
      const int tk_r[2] = {has_time ? tk[kk0 + g] : 0, has_time ? tk[kk0 + g + 8] : 0};
      const int kv_r[2] = {kvalid[kk0 + g], kvalid[kk0 + g + 8]};
      int bk[2][4];  // the pairs' buckets (-1: none), for the dts sums only
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int m = m0 + g + 8 * (i >> 1);
          const int qq = qq0 + 8 * nt + 2 * t + (i & 1), l = q0 + qq;
          float pv = 0.f, dsv = 0.f;
          bk[nt][i] = -1;
          if (l < L && m <= l && kv_r[i >> 1]) {
            float x = pw[l - m];
            if (has_time) {
              const int u = bucket(tq[qq], tk_r[i >> 1]);
              x += tw[u];
              bk[nt][i] = u;
            }
            x = fmaf(sc[nt][i], a.alpha, x);
            const float sig = __fdividef(1.f, 1.f + __expf(-x));  // exp overflow: 0
            pv = x * sig * inv_n;
            dsv = da[nt][i] * (sig * (1.f + x * (1.f - sig))) * inv_n;
          }
          sc[nt][i] = pv;
          da[nt][i] = dsv;
        }

      if constexpr (kFull) {
        // dpos and dts from the unrounded dS, before the products, so the buckets die here.
        // dpos: this lane's values by local distance (query - key) = 8n + (2t - g) + (i&1), n = nt - (i>>1)
        float part[3][2];
#pragma unroll
        for (int n = 0; n < 3; ++n) part[n][0] = part[n][1] = 0.f;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) part[nt - (i >> 1) + 1][i & 1] += da[nt][i];
        add_pos_grads<1>(gpos, part, l0 - m0, n_dist, g, t);
        if (has_time) {
          // dts into the warp's own sums: the lane's values key by key, so that its runs of
          // equal buckets (neighbouring queries) fold before an atomic
          float dsk[8];
          int bkk[8];
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const int ii = e >> 2, nt = (e >> 1) & 1, j = e & 1;
            dsk[e] = da[nt][2 * ii + j];
            bkk[e] = bk[nt][2 * ii + j];
          }
          add_ts_grads<8>(my_gts, dsk, bkk);
        }
      }

      // dV += P^T G and dK += dS^T Q over the warp's 16 queries: P^T and dS^T, rounded to bf16
      // pairwise, are the A fragments as they are; G's and Q's B fragments of two n-tiles come
      // in one transposed ldmatrix
      const uint32_t pf[4] = {pack_bf16(sc[0][0], sc[0][1]), pack_bf16(sc[0][2], sc[0][3]), pack_bf16(sc[1][0], sc[1][1]),
                              pack_bf16(sc[1][2], sc[1][3])};
      sf[0] = pack_bf16(da[0][0], da[0][1]);
      sf[1] = pack_bf16(da[0][2], da[0][3]);
      sf[2] = pack_bf16(da[1][0], da[1][1]);
      sf[3] = pack_bf16(da[1][2], da[1][3]);
      const bf16* gp = Gs + (qq0 + ll.bt_row) * ldv + ll.bt_col;
      const bf16* qp = Qs + (qq0 + ll.bt_row) * ldk + ll.bt_col;
#pragma unroll
      for (int j = 0; j < N; j += 2) {
        if (j + 1 < dv8) {
          uint32_t bf[4];
          ldsm_x4_trans(bf, gp + 8 * j);
          mma_bf16(dv[j], pf, bf);
          mma_bf16(dv[j + 1], pf, bf + 2);
        } else if (j < dv8) {
          uint32_t bf[2];
          ldsm_x2_trans(bf, gp + 8 * j);
          mma_bf16(dv[j], pf, bf);
        }
        if (j + 1 < dk8) {
          uint32_t bf[4];
          ldsm_x4_trans(bf, qp + 8 * j);
          mma_bf16(dk[j], sf, bf);
          mma_bf16(dk[j + 1], sf, bf + 2);
        } else if (j < dk8) {
          uint32_t bf[2];
          ldsm_x2_trans(bf, qp + 8 * j);
          mma_bf16(dk[j], sf, bf);
        }
      }
    }

    if constexpr (kFull) {
      // dS^T to shared memory as bf16 [key][query], the fragment's pairs as they are
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int half = 0; half < 2; ++half)
          *reinterpret_cast<uint32_t*>(dST + (kk0 + g + 8 * half) * kLdST + qq0 + 8 * nt + 2 * t) = sf[2 * nt + half];
    }
    if (kFull || !ring) __syncthreads();  // B2: the tile's dS^T is complete; Q and G are consumed
    if (!ring) {
      if (qt + 1 < n_qt) issue(qt + 1, 0);
      cp_commit();
    }

    if constexpr (kFull) {
      // dQ_part = alpha dS K: warp rows 16 (warp % 4) of the q tile, feature n-tiles of half (warp / 4);
      // dS's A fragment comes transposed from dS^T, K's B fragments transposed from K [key][feature]
      const int qr = 16 * (warp % 4), lq = q0 + qr;
      const int nh = (dk8 + 1) >> 1, j0 = (warp / 4) * nh;
      if (lq < L && lq + 15 >= k0 && j0 < dk8) {
        float acc[NH][4];
#pragma unroll
        for (int jj = 0; jj < NH; ++jj) acc[jj][0] = acc[jj][1] = acc[jj][2] = acc[jj][3] = 0.f;
#pragma unroll
        for (int kc = 0; kc < kTileKK / 16; ++kc) {
          uint32_t af[4];
          ldsm_x4_trans(af, dST + (16 * kc + ll.bn_row) * kLdST + qr + ll.bn_col);
          const bf16* kp = Ks + (16 * kc + ll.bt_row) * ldk + ll.bt_col;
#pragma unroll
          for (int jj = 0; jj < NH; jj += 2) {
            const int j = j0 + jj;
            if (jj + 1 < nh && j + 1 < dk8) {
              uint32_t bf[4];
              ldsm_x4_trans(bf, kp + 8 * j);
              mma_bf16(acc[jj], af, bf);
              mma_bf16(acc[jj + 1], af, bf + 2);
            } else if (jj < nh && j < dk8) {
              uint32_t bf[2];
              ldsm_x2_trans(bf, kp + 8 * j);
              mma_bf16(acc[jj], af, bf);
            }
          }
        }
        // lanes t and t^1 swap halves: an even lane holds row g, columns 2t .. 2t+3,
        // an odd lane row g+8, columns 2t-2 .. 2t+1; one vector reduction each
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
            if (a.red_v4) {
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

  // dK and dV: the query splits' partials summed in a fixed order, (0 + 2) + (1 + 3),
  // through one slot per key group: split 2 hands its partial to split 0, split 3 to
  // split 1, then split 1 its sum to split 0
  cp_wait_all();
  __syncthreads();  // the stages are free
  float* slot_k = reinterpret_cast<float*>(stages) + kg * 16 * (ldk + ldv);
  float* slot_v = slot_k + 16 * ldk;
  auto put = [&]() {
#pragma unroll
    for (int j = 0; j < N; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = g + 8 * half, c = 8 * j + 2 * t;
        if (j < dk8) *reinterpret_cast<float2*>(slot_k + r * ldk + c) = make_float2(dk[j][2 * half], dk[j][2 * half + 1]);
        if (j < dv8) *reinterpret_cast<float2*>(slot_v + r * ldv + c) = make_float2(dv[j][2 * half], dv[j][2 * half + 1]);
      }
  };
  auto take = [&]() {
#pragma unroll
    for (int j = 0; j < N; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = g + 8 * half, c = 8 * j + 2 * t;
        if (j < dk8) {
          const float2 x = *reinterpret_cast<const float2*>(slot_k + r * ldk + c);
          dk[j][2 * half] += x.x;
          dk[j][2 * half + 1] += x.y;
        }
        if (j < dv8) {
          const float2 x = *reinterpret_cast<const float2*>(slot_v + r * ldv + c);
          dv[j][2 * half] += x.x;
          dv[j][2 * half + 1] += x.y;
        }
      }
  };
  if (qs == 2) put();
  __syncthreads();
  if (qs == 0) take();
  __syncthreads();
  if (qs == 3) put();
  __syncthreads();
  if (qs == 1) take();
  __syncthreads();
  if (qs == 1) put();
  __syncthreads();  // also: every warp's table sums are in gpos / gts
  if (qs == 0) {
    take();
    // dK (times alpha) and dV of the key group, in bf16
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
  }
  if constexpr (kFull) flush_table_grads(a, gpos, gts, n_dist, lay.nb4, h, kThreadsK);
}

template <int N>  // 3 CTAs (24 warps) per SM where N <= 4
__global__ void __launch_bounds__(kThreadsK, N <= 4 ? 3 : 1) hstu_rab_bwd_bf16_kernel(Args a) {
  key_tile_body<N, true>(a);
}

template <int N>  // 3 CTAs (24 warps) per SM where N <= 4
__global__ void __launch_bounds__(kThreadsK, N <= 4 ? 3 : 1) bwd_kv_kernel(Args a) {
  key_tile_body<N, false>(a);
}

// ---------------------------------------------------------------------------
// K2a: 64-row q tiles of 4 warps (the source note at the top)
// ---------------------------------------------------------------------------

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTileK = 64;  // keys per stage
constexpr int kTileQ = 64;  // q rows per CTA
constexpr int kTsCopies = 4 * kWarps;
static_assert(kTileK == 16 * kWarps && kTileQ == 64, "8 n-tiles of 8, 4 k-steps of 16 a tile");

// Shared memory in bytes, each part 16-byte aligned:
//   K [kTileK][ldk]  V [kTileK][ldv]  Q [kTileQ][ldk]  G [kTileQ][ldv]  (bf16)
//   tk [kTileK]  kv [kTileK]  tq [kTileQ]  (int)  pw [L]  gpos [L]  tw [nb+1]  (f32)  thr [nb+1]  (int)
//   gts [ts_copies][nb4]  (f32)
struct Layout {
  int k, v, q, g, tk, kv, tq, pw, gpos, tw, th, gts, nb4, total;
};

__host__ __device__ inline Layout layout(int ldk, int ldv, int L, int nb, int ts_copies) {
  Layout o;
  o.nb4 = (nb + 1 + 3) & ~3;
  o.k = 0;
  o.v = o.k + align16(2 * kTileK * ldk);
  o.q = o.v + align16(2 * kTileK * ldv);
  o.g = o.q + align16(2 * kTileQ * ldk);
  o.tk = o.g + align16(2 * kTileQ * ldv);
  o.kv = o.tk + 4 * kTileK;
  o.tq = o.kv + 4 * kTileK;
  o.pw = o.tq + 4 * kTileQ;
  o.gpos = o.pw + align16(4 * L);
  o.tw = o.gpos + align16(4 * L);
  o.th = o.tw + 4 * o.nb4;
  o.gts = o.th + 4 * o.nb4;
  o.total = o.gts + 4 * ts_copies * o.nb4;
  return o;
}

template <int N>  // n-tiles of 8 features: dqk, dv <= 8 * N
__global__ void __launch_bounds__(kThreads) bwd_q_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int L = a.L, H = a.H, ldk = a.ldk, ldv = a.ldv;
  const Layout lay = layout(ldk, ldv, L, a.bk.nb, a.ts_copies);
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
  flush_table_grads(a, gpos, gts, q_end, lay.nb4, h, kThreads);
}

template <int N, bool kFull>  // K2 (kFull) or K2b
cudaError_t launch_key_tiles(Args a, cudaStream_t stream, int* info) {
  a.red_v4 = a.dqk % 4 == 0 && aligned16(a.dq);
  // The most that fits: for long sequences or wide heads the dts copies go
  // first, then the ring's second stage
  size_t smem = 0;
  for (int option = 0; option < 4; ++option) {
    a.stages = option < 2 ? 2 : 1;
    a.ts_copies = option % 2 == 0 ? kTsCopiesK : 1;
    smem = key_layout<kFull>(a.ldk, a.ldv, a.L, a.bk.nb, a.ts_copies, a.stages).total;
    if (smem <= kMaxSmem) break;
  }
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  const auto kernel = kFull ? hstu_rab_bwd_bf16_kernel<N> : bwd_kv_kernel<N>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  if (info != nullptr) {
    info[3] = a.stages;
    return occupancy(kernel, kThreadsK, smem, info);
  }
  const dim3 grid(a.B * a.H, (a.L + kTileKK - 1) / kTileKK);
  kernel<<<grid, kThreadsK, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int N>  // K2a
cudaError_t launch_q_tiles(Args a, cudaStream_t stream, int* info) {
  a.ts_copies = kTsCopies;
  size_t smem = layout(a.ldk, a.ldv, a.L, a.bk.nb, a.ts_copies).total;
  if (smem > kMaxSmem) {
    a.ts_copies = 1;
    smem = layout(a.ldk, a.ldv, a.L, a.bk.nb, 1).total;
  }
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(bwd_q_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  if (info != nullptr) return occupancy(bwd_q_kernel<N>, kThreads, smem, info);
  const dim3 grid(a.B * a.H, (a.L + kTileQ - 1) / kTileQ);
  bwd_q_kernel<N><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// which: 0 K2, 1 K2a, 2 K2b
template <int N>
cudaError_t launch(int which, const Args& a, cudaStream_t stream, int* info) {
  if (which == 0) return launch_key_tiles<N, true>(a, stream, info);
  if (which == 1) return launch_q_tiles<N>(a, stream, info);
  return launch_key_tiles<N, false>(a, stream, info);
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
  a.vec_q = dqk % 8 == 0 && aligned16(q);
  a.vec_k = dqk % 8 == 0 && aligned16(k);
  a.vec_v = dv_dim % 8 == 0 && aligned16(v);
  a.vec_g = dv_dim % 8 == 0 && aligned16(g);
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
// per thread, info[2] dynamic shared memory bytes per CTA; for K2 and K2b
// info[3] their Q/G ring stages (2, or 1 where two do not fit).  Returns the
// cudaError_t.
extern "C" int hstu_rab_bwd_bf16_occupancy(int which, int L, int dqk, int dv, int max_seq_len, int num_buckets,
                                           int* info) {
  return run(which, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
             nullptr, nullptr, nullptr, 1, 1, L, dqk, dv, max_seq_len, num_buckets, 1.f, 0, 0, 1.f, nullptr, info);
}

extern "C" const char* hstu_rab_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
