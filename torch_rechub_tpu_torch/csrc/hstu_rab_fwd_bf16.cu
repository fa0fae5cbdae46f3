// HSTU silu attention with on-the-fly relative position/time bias: forward,
// hand-written for Hopper (sm_90a), bf16 in and out (the mixed-precision
// policy; the bias tables stay fp32).
//
// Replaces the TPU kernel torch_rechub_tpu/ops/pallas/hstu_rab_attention.py:
// _fwd_kernel on bf16 inputs.  For every (b, h, l):
//
//   out[b,h,l,:] = bf16( sum_{m <= l, mask[b,m]} bf16(silu(s_lm) / N) * v[b,h,m,:] )
//   s_lm = alpha * q[b,h,l,:].k[b,h,m,:] + pos_w[m-l+N-1, h] + ts_w[bucket(t_l - t_m), h]
//
// with N = max_seq_len, the sums in f32.  It rounds where the Pallas kernel
// rounds: attn to bf16 before the P V product (as `.astype(v.dtype)` there),
// the f32 output to bf16 at the end.  The q.k and P V products are exact
// bf16 x bf16 products summed in f32.  bucket() is K1's exact O(1) lookup
// (hstu_rab_common.cuh); masked pairs contribute 0; a fully masked row gives
// zeros.
//
// What bounds it on an H100, at the serving shape (B8 H8 L256, dqk = dv =
// 32; 1.96 M valid pairs with the serving mask): 0.25 GFLOP of products,
// 0.0003 ms at 989 TFLOP/s bf16, against 4.2 MB of bf16 q/k/v/out and the
// stamps and mask, 0.0013 ms at 3.35 TB/s: bytes.  What the kernel spends is
// the per-score work the tensor cores do not do (bias, bucket, silu) and
// latency, so the design keeps many warps in flight and their loads ahead
// of their math.  Its Hopper design is fp32 K1's (hstu_rab_fwd.cu) in bf16:
// - CTA = 8 warps over a 32-row q tile: 2 row groups of 16 x 4 key splits,
//   each warp 16 of every 64 staged keys (S in two 8-key n-tiles, P V in one
//   k-step of 16).  512 CTAs at the serving shape, issued heaviest q tile
//   first (grid y reversed): no warp walks more than a quarter of its row's
//   keys, and 4096 warps cover the card's causal imbalance.
// - Latency: K, V, the key stamps and the mask words of the next 64-key tile
//   are copied with cp.async (16-byte .cg, zero-filled past L) into a
//   two-stage ring during the current tile's math: one __syncthreads a
//   tile.  An operand whose width is not a multiple of 8, or whose address
//   is not 16-byte aligned (a bf16 view may start at any element), is
//   staged with plain loads into the same ring instead.  Where two stages do
//   not fit (wide heads at long L) one stage is refilled after a second
//   barrier; one stage never needs more than the first design took, so every
//   shape it took fits.
// - mma.sync m16n8k16 bf16 -> f32, every fragment loaded with ldmatrix (V's
//   B fragments transposed on the way): one instruction for four 8 x 8
//   blocks.  Tile row strides are 8 mod 16 elements, so no ldmatrix has a
//   bank conflict.  The accumulator fragment of S, rounded to bf16
//   pairwise, is the A fragment of P V as is: P never leaves registers.
// - The four key splits' partial outputs are summed in f32 in a fixed
//   order, (0 + 2) + (1 + 3), through one slot per row group in the freed
//   ring, then rounded once: the same bits from run to run.
// - Registers: launch bounds of 3 CTAs (24 warps) per SM at dv <= 32, 2
//   above.  At the serving shape on an H100: 77 registers, no spills,
//   25,920 B of shared memory, 3 CTAs per SM (the first design: 4 warps,
//   128 registers, 4 CTAs, 16 warps per SM).  ptxas's report is in the build
//   log; hstu_rab_fwd_bf16_occupancy gives CTAs, registers, shared bytes and
//   ring stages for any shape.

#include "hstu_rab_common.cuh"
#include "hstu_wide.cuh"

namespace {

using namespace rab;
using bf16 = __nv_bfloat16;

constexpr int kRowGroups = 2;                    // 16-row groups per CTA
constexpr int kKeySplits = 4;                    // warps sharing a row group, each its own keys
constexpr int kBlockQ = 16 * kRowGroups;         // q rows per CTA
constexpr int kWarps = kRowGroups * kKeySplits;
constexpr int kThreads = 32 * kWarps;
constexpr int kBlockK = 64;                      // keys per stage
constexpr int kWarpKeys = kBlockK / kKeySplits;  // keys per warp per stage: one k-step of P V
static_assert(kKeySplits == 4 && kWarpKeys == 16, "the partial outputs are summed as (0 + 2) + (1 + 3)");

struct Params {
  const bf16 *q, *k, *v;
  const float *pos_w, *ts_w;
  const int *thr, *ts;
  const uint8_t* mask;
  bf16* out;
  int B, H, L, dqk, dv, max_seq_len;
  float alpha;
  Buckets bk;
  int pk, pv;          // padded widths: dqk to 16 (the mma's k), dv to 8 (its n)
  int ldk, ldv;        // shared row strides in elements, 8 mod 16; ldv floats also the partial outputs'
  int vec_q, vec_k, vec_v;
  int stages;          // the K/V ring: 2, or 1 where two do not fit
};

inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

__host__ __device__ inline int align16(int bytes) { return (bytes + 15) & ~15; }

// Shared memory in bytes, each part 16-byte aligned:
//   Q [kBlockQ][ldk] (bf16)  tq [kBlockQ] (int)  pw [L]  tw [nb+1] (f32)  thr [nb+1] (int)
//   1 or 2 stages of { K [kBlockK][ldk]  V [kBlockK][ldv] (bf16)  tk [kBlockK] (int)  mask words [kBlockK/4 + 4] },
//   the stages also holding one slot of partial outputs per row group at the
//   end, [kRowGroups][16][ldv] f32: no more than a stage's V.
struct Layout {
  int q, tq, pw, tw, th, stage, stage_bytes, k, v, tk, km, total;
};

__host__ __device__ inline Layout layout(int ldk, int ldv, int L, int nb, int stages) {
  Layout o;
  o.q = 0;
  o.tq = align16(2 * kBlockQ * ldk);
  o.pw = o.tq + 4 * kBlockQ;
  o.tw = o.pw + align16(4 * L);
  o.th = o.tw + align16(4 * (nb + 1));
  o.stage = o.th + align16(4 * (nb + 1));
  o.k = 0;
  o.v = o.k + align16(2 * kBlockK * ldk);
  o.tk = o.v + align16(2 * kBlockK * ldv);
  o.km = o.tk + 4 * kBlockK;
  o.stage_bytes = o.km + 4 * (kBlockK / 4 + 4);
  int area = stages * o.stage_bytes;
  const int partials = 4 * kRowGroups * 16 * ldv;
  if (partials > area) area = partials;
  o.total = o.stage + area;
  return o;
}

template <int NV>  // output n-tiles of 8 columns: dv <= 8 * NV
__global__ void __launch_bounds__(kThreads, NV <= 4 ? 3 : 2) hstu_rab_fwd_bf16_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout lay = layout(p.ldk, p.ldv, p.L, p.bk.nb, p.stages);
  bf16* Qs = reinterpret_cast<bf16*>(smem + lay.q);
  int* tq = reinterpret_cast<int*>(smem + lay.tq);
  float* pw = reinterpret_cast<float*>(smem + lay.pw);
  float* tw = reinterpret_cast<float*>(smem + lay.tw);
  int* th = reinterpret_cast<int*>(smem + lay.th);
  unsigned char* stages = smem + lay.stage;

  const int L = p.L, H = p.H, ldk = p.ldk, ldv = p.ldv;
  const int bh = blockIdx.x, b = bh / H, h = bh - b * H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlockQ;  // heaviest q tiles first
  const int q_end = min(q0 + kBlockQ, L);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int rg = warp % kRowGroups, ks = warp / kRowGroups;
  const bool has_time = p.ts != nullptr;
  const bf16* kb = p.k + (size_t)bh * L * p.dqk;
  const bf16* vb = p.v + (size_t)bh * L * p.dv;
  const int* tsb = has_time ? p.ts + (size_t)b * L : nullptr;
  const int nvt = p.pv >> 3, nkc = p.pk >> 4;
  const float norm = (float)p.max_seq_len;
  const Lookup bucket(th, p.bk);
  const LdsmLane ll(lane);
  const bool ring = p.stages == 2;

  auto stage_ptr = [&](int s) { return stages + s * lay.stage_bytes; };
  auto issue = [&](int kt, int s) {
    unsigned char* st = stage_ptr(s);
    const int k0 = kt * kBlockK;
    copy_rows_bf16(reinterpret_cast<bf16*>(st + lay.k), ldk, kb, k0, kBlockK, L, p.dqk, p.pk, p.vec_k, tid, kThreads);
    copy_rows_bf16(reinterpret_cast<bf16*>(st + lay.v), ldv, vb, k0, kBlockK, L, p.dv, p.pv, p.vec_v, tid, kThreads);
    if (has_time) copy_stamps(reinterpret_cast<int*>(st + lay.tk), tsb, k0, kBlockK, L, tid);
    if (p.mask != nullptr)
      copy_mask(reinterpret_cast<int*>(st + lay.km), p.mask, (size_t)p.B * L, (size_t)b * L + k0, kBlockK, tid);
  };

  // Zero the padding columns dqk .. pk-1 of Q and of every stage's K (the
  // 16-byte copies leave them; V needs none: with vec, dv = pv); then the Q
  // tile, its stamps, the first key tile and the tables.
  for (int r = tid; r < kBlockQ + p.stages * kBlockK; r += kThreads) {
    bf16* row = r < kBlockQ ? Qs + r * ldk
                            : reinterpret_cast<bf16*>(stage_ptr((r - kBlockQ) / kBlockK) + lay.k) + ((r - kBlockQ) % kBlockK) * ldk;
    for (int d = p.dqk; d < p.pk; ++d) row[d] = __float2bfloat16(0.f);
  }
  copy_rows_bf16(Qs, ldk, p.q + (size_t)bh * L * p.dqk, q0, kBlockQ, L, p.dqk, p.pk, p.vec_q, tid, kThreads);
  if (has_time) copy_stamps(tq, tsb, q0, kBlockQ, L, tid);
  issue(0, 0);
  cp_commit();
  for (int d = tid; d < q_end; d += kThreads) pw[d] = p.pos_w[(size_t)(p.max_seq_len - 1 - d) * H + h];
  if (has_time)
    for (int u = tid; u <= p.bk.nb; u += kThreads) {
      tw[u] = p.ts_w[(size_t)u * H + h];
      th[u] = p.thr[u];
    }

  float o[NV][4];
#pragma unroll
  for (int j = 0; j < NV; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;

  const int qr = 16 * rg, r0 = q0 + qr;    // this warp's first row, in the tile and in L
  const int r_last = min(r0 + 15, L - 1);  // its last real row
  const int n_kt = (q_end - 1) / kBlockK + 1;  // key tiles up to the causal frontier
  for (int kt = 0; kt < n_kt; ++kt) {
    cp_wait_all();
    __syncthreads();  // B1: key tile kt visible; every warp is done with tile kt-1's stage
    if (ring) {
      if (kt + 1 < n_kt) issue(kt + 1, (kt + 1) & 1);
      cp_commit();
    }
    const unsigned char* st = stage_ptr(ring ? kt & 1 : 0);
    const bf16* Ks = reinterpret_cast<const bf16*>(st + lay.k);
    const bf16* Vs = reinterpret_cast<const bf16*>(st + lay.v);
    const int* tk = reinterpret_cast<const int*>(st + lay.tk);
    const uint8_t* km = st + lay.km + (p.mask != nullptr ? mask_offset(p.mask, (size_t)b * L + kt * kBlockK) : 0);
    const int c0 = ks * kWarpKeys, m0 = kt * kBlockK + c0;  // this warp's first key, in the tile and in L
    if (r0 < L && m0 <= r_last) {                             // warp-uniform: some pair with m <= l
      // S = Q K^T: s[nt][i] is row qr + g + 8 (i >> 1), key c0 + 8 nt + 2t + (i & 1) of the tiles
      float s[2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      for (int kc = 0; kc < nkc; ++kc) {
        uint32_t a[4], bb[4];
        ldsm_x4(a, Qs + (qr + ll.a_row) * ldk + 16 * kc + ll.a_col);
        ldsm_x4(bb, Ks + (c0 + ll.bn_row) * ldk + 16 * kc + ll.bn_col);
        mma_bf16(s[0], a, bb);
        mma_bf16(s[1], a, bb + 2);
      }

      // scores -> P = silu(s) / N in f32 (rounded to bf16 when packed below)
      const int tq_r[2] = {has_time ? tq[qr + g] : 0, has_time ? tq[qr + g + 8] : 0};
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int l = r0 + g + 8 * (i >> 1);
          const int c = c0 + 8 * nt + 2 * t + (i & 1), m = kt * kBlockK + c;
          float pv = 0.f;
          if (l < L && m <= l && (p.mask == nullptr || km[c])) {
            float x = pw[l - m];
            if (has_time) x += tw[bucket(tq_r[i >> 1], tk[c])];
            x = fmaf(s[nt][i], p.alpha, x);
            pv = __fdividef(x, (1.f + __expf(-x)) * norm);  // exp overflow: x / inf = -0
          }
          s[nt][i] = pv;
        }

      // O += P V over the warp's 16 keys: P's fragment is the A fragment as is,
      // V's B fragments of two n-tiles come in one transposed ldmatrix
      const uint32_t a[4] = {pack_bf16(s[0][0], s[0][1]), pack_bf16(s[0][2], s[0][3]), pack_bf16(s[1][0], s[1][1]),
                             pack_bf16(s[1][2], s[1][3])};
      const bf16* vp = Vs + (c0 + ll.bt_row) * ldv + ll.bt_col;
#pragma unroll
      for (int j = 0; j < NV; j += 2) {
        if (j + 1 < nvt) {
          uint32_t bb[4];
          ldsm_x4_trans(bb, vp + 8 * j);
          mma_bf16(o[j], a, bb);
          mma_bf16(o[j + 1], a, bb + 2);
        } else if (j < nvt) {
          uint32_t bb[2];
          ldsm_x2_trans(bb, vp + 8 * j);
          mma_bf16(o[j], a, bb);
        }
      }
    }
    if (!ring) {
      __syncthreads();  // B2: the stage is consumed
      if (kt + 1 < n_kt) issue(kt + 1, 0);
      cp_commit();
    }
  }

  // Sum the key splits' partial outputs in a fixed order, (0 + 2) + (1 + 3),
  // through one slot per row group: split 2 hands its partial to split 0,
  // split 3 to split 1, then split 1 its sum to split 0
  cp_wait_all();
  __syncthreads();  // the stages are free
  float* slot = reinterpret_cast<float*>(stages) + rg * 16 * ldv;
  auto put = [&]() {
#pragma unroll
    for (int j = 0; j < NV; ++j)
      if (j < nvt) {
        *reinterpret_cast<float2*>(slot + g * ldv + 8 * j + 2 * t) = make_float2(o[j][0], o[j][1]);
        *reinterpret_cast<float2*>(slot + (g + 8) * ldv + 8 * j + 2 * t) = make_float2(o[j][2], o[j][3]);
      }
  };
  auto take = [&]() {
#pragma unroll
    for (int j = 0; j < NV; ++j)
      if (j < nvt) {
        const float2 lo = *reinterpret_cast<const float2*>(slot + g * ldv + 8 * j + 2 * t);
        const float2 hi = *reinterpret_cast<const float2*>(slot + (g + 8) * ldv + 8 * j + 2 * t);
        o[j][0] += lo.x;
        o[j][1] += lo.y;
        o[j][2] += hi.x;
        o[j][3] += hi.y;
      }
  };
  if (ks == 2) put();
  __syncthreads();
  if (ks == 0) take();
  __syncthreads();
  if (ks == 3) put();
  __syncthreads();
  if (ks == 1) take();
  __syncthreads();
  if (ks == 1) put();
  __syncthreads();
  if (ks == 0 && r0 < L) {
    take();
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int l = r0 + g + 8 * i;
      if (l < L) {
        bf16* dst = p.out + ((size_t)bh * L + l) * p.dv;
#pragma unroll
        for (int j = 0; j < NV; ++j) {
          const int c = 8 * j + 2 * t;
          if (c < p.dv) dst[c] = __float2bfloat16_rn(o[j][2 * i]);
          if (c + 1 < p.dv) dst[c + 1] = __float2bfloat16_rn(o[j][2 * i + 1]);
        }
      }
    }
  }
}

template <int NV>
cudaError_t launch(Params p, cudaStream_t stream, int* info) {
  size_t smem = 0;
  for (p.stages = 2; p.stages >= 1; --p.stages) {  // two stages where they fit, else one
    smem = layout(p.ldk, p.ldv, p.L, p.bk.nb, p.stages).total;
    if (smem <= kMaxSmem) break;
  }
  if (smem > kMaxSmem) return kNoFit;
  cudaError_t err = cudaFuncSetAttribute(hstu_rab_fwd_bf16_kernel<NV>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  if (info != nullptr) {
    info[3] = p.stages;
    return occupancy(hstu_rab_fwd_bf16_kernel<NV>, kThreads, smem, info);
  }
  const dim3 grid(p.B * p.H, (p.L + kBlockQ - 1) / kBlockQ);
  hstu_rab_fwd_bf16_kernel<NV><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

int run_narrow(const void* q, const void* k, const void* v, const void* pos_w, const void* ts_w, const void* thr,
               const void* ts, const void* mask, void* out, int B, int H, int L, int dqk, int dv, int max_seq_len,
               int num_buckets, float alpha, int fn_log, int minutes, float divisor, void* stream, int* info) {
  if (dv > 128 || dqk > 256) return kNoFit;
  Params p;
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.pos_w = static_cast<const float*>(pos_w);
  p.ts_w = static_cast<const float*>(ts_w);
  p.thr = static_cast<const int*>(thr);
  p.ts = static_cast<const int*>(ts);
  p.mask = static_cast<const uint8_t*>(mask);
  p.out = static_cast<bf16*>(out);
  p.B = B;
  p.H = H;
  p.L = L;
  p.dqk = dqk;
  p.dv = dv;
  p.max_seq_len = max_seq_len;
  p.alpha = alpha;
  p.bk = Buckets{num_buckets, fn_log, minutes, divisor};
  p.pk = round_up(dqk, 16);
  p.pv = round_up(dv, 8);
  p.ldk = p.pk + 8;
  p.ldv = round_up(dv, 16) + 8;
  const auto aligned = [](const void* ptr) { return ((uintptr_t)ptr & 15) == 0; };
  p.vec_q = dqk % 8 == 0 && aligned(q);
  p.vec_k = dqk % 8 == 0 && aligned(k);
  p.vec_v = dv % 8 == 0 && aligned(v);
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
        return wide::launch<bf16, wide::kFwd, true>(w, static_cast<cudaStream_t>(stream), info);
      },
      taken, info);
}

}  // namespace

// q, k: (B, H, L, dqk) and v, out: (B, H, L, dv) bf16, contiguous, at any
// element offset; pos_w: (2*max_seq_len-1, H) and ts_w: (num_buckets+1, H)
// fp32; thr: (num_buckets+1,) int32; ts: (B, L) int32 or null; mask: (B, L)
// bool or null.  The arguments of hstu_rab_fwd (hstu_rab_fwd.cu).  Returns
// the cudaError_t of the launch (0 on success).
extern "C" int hstu_rab_fwd_bf16(const void* q, const void* k, const void* v, const void* pos_w, const void* ts_w,
                                 const void* thr, const void* ts, const void* mask, void* out, int B, int H, int L,
                                 int dqk, int dv, int max_seq_len, int num_buckets, float alpha, int fn_log,
                                 int minutes, float divisor, void* stream, int* taken) {
  return run(q, k, v, pos_w, ts_w, thr, ts, mask, out, B, H, L, dqk, dv, max_seq_len, num_buckets, alpha, fn_log,
             minutes, divisor, stream, nullptr, taken);
}

// info[0] resident CTAs per SM, info[1] registers per thread, info[2]
// dynamic shared memory bytes per CTA of the kernel this shape would launch,
// info[3] its K/V ring stages (2, or 1 where two do not fit), info[4] 0 the
// tensor-core kernel, 1 the width-tiled variant.
extern "C" int hstu_rab_fwd_bf16_occupancy(int L, int dqk, int dv, int max_seq_len, int num_buckets, int* info) {
  return run(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, 1, 1, L, dqk, dv,
             max_seq_len, num_buckets, 1.f, 0, 0, 1.f, nullptr, info, nullptr);
}

extern "C" const char* hstu_rab_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }
