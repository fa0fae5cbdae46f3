// HSTU silu attention with a materialised bias: forward, hand-written for
// Hopper (sm_90a), bf16 q, k, v and output (the mixed-precision policy), the
// bias bf16 or fp32.
//
// Replaces the TPU kernel torch_rechub_tpu/ops/pallas/hstu_attention.py:
// _fwd_kernel on bf16 inputs.  For every (b, h, l):
//
//   out[b,h,l,:] = bf16( sum_{m <= l, mask[b,m]} (silu(s_lm) / N) * v[b,h,m,:] )
//   s_lm = alpha * q[b,h,l,:].k[b,h,m,:] + bias[b',h,l,m]
//
// with b' = b for a per-batch bias (B, H, L, L) and b' = 0 for a shared
// (1, H, L, L) one (the TPU indexes it by the flat batch*head index mod H),
// N the silu normaliser, everything in f32: q.k is exact bf16 x bf16
// products summed in f32, a bf16 bias is promoted, and attn = silu(s) / N
// stays f32 for the P V product, as in the Pallas body (an f32 attn
// against a bf16 v, unlike K1's, which rounds attn to bf16 first).  The
// f32 output is rounded to bf16 at the end.  Only a valid pair (l < L,
// m <= l, key m unmasked) reads its bias, so a NaN or inf in the upper
// triangle or at a masked key cannot reach the output, and a fully masked
// row yields zeros.
//
// f32 attn on bf16 tensor cores: attn = hi + mid + lo, hi = bf16(attn),
// mid = bf16(attn - hi), lo = bf16(attn - hi - mid) (each difference exact
// in f32), and O += lo V + mid V + hi V, three m16n8k16 products whose terms
// are exact in f32.  The three hold attn to about 2^-25 relative, so the
// result is the f32 product's up to its summation order.  (Two terms, hi +
// lo, hold it to 2^-17 only: an output within that of a bf16 rounding
// boundary then rounds the other way, and on an H100 that took the kernel
// 0.052-0.061 of the way from the plain version to fp32.  3xTF32, as the
// fp32 K3 runs it, would need two m16n8k8 products for every one here;
// bf16 v is exact in either.)
//
// What bounds it on an H100: bytes.  At the serving shape (B8 H8 L256,
// dqk = dv = 32, a per-batch f32 bias) the valid pairs read about 8 MB of
// the bias's lower triangle beside 4.2 MB of bf16 q/k/v/out, 0.0038 ms at
// 3.35 TB/s, against 0.25 GFLOP of products, 0.0003 ms at 989 TFLOP/s.
//
// Design: fp32 K3's Hopper design (hstu_attn_fwd.cu) in bf16, built from
// K1-bf16's pieces (hstu_rab_fwd_bf16.cu):
// - CTA = 8 warps over a 32-row q tile: 2 row groups of 16 x 4 key splits,
//   each warp 16 of every 64 staged keys (S in two 8-key n-tiles, P V in one
//   k-step of 16).  512 CTAs at the serving shape, heaviest q tile first
//   (grid y reversed).  The four partial outputs are summed in f32 in the
//   fixed order (0 + 2) + (1 + 3) through the freed ring, then rounded
//   once: no atomics, the same bits every run.
// - Latency: K, V, the mask words and the bias tile (32 rows x 64 keys) of
//   the next key tile are copied into a two-stage ring while the current
//   tile's math runs: one __syncthreads a tile.  K and V by copy_rows_bf16
//   (cp.async where the width is a multiple of 8 and the address 16-byte
//   aligned, else plain loads into the same slot); the bias by
//   copy_causal_tile<TB> (hstu_rab_common.cuh): 16-byte chunks (4 f32 or 8
//   bf16) where L and the alignment allow, else 4-byte ones (1 f32 or 2
//   bf16), else, for a bf16 bias at an odd L or a 2-byte offset, plain
//   2-byte loads; it zero-fills past L and reads no chunk wholly above its
//   row's diagonal.  Tiles above the causal frontier are never issued.  Two
//   stages fit at every shape the kernel takes (dqk <= 256, dv <= 128: at
//   most 137,888 B).
// - mma.sync m16n8k16 bf16 -> f32, every fragment of Q, K and V by ldmatrix
//   (V's transposed), row strides 8 mod 16 elements: no bank conflicts.  The
//   bias tile's row stride is 72 elements: a lane reads keys 2t, 2t+1 of
//   rows g and g+8; for an f32 bias (72 = 8 mod 32 words) each half-warp's
//   8-byte loads cover the 32 banks once, for a bf16 bias (36 = 4 mod 32
//   words) the warp's 4-byte loads do.
// - Shared memory does not grow with L: any L, no host padding.
// - Registers: launch bounds of 3 CTAs (24 warps) per SM at dv <= 32, 2
//   above.  At the serving shape on an H100: 79 registers with an f32 bias
//   (80 with a bf16 one), no spills, 41,632 B (32,416 B) of shared memory,
//   3 CTAs per SM.
// The first design (4 warps over a 64-row q tile, one stage with plain
// loads and two barriers a key tile, the bias read per fragment from device
// memory, 128 registers) took 0.0423 ms on an H100 at the serving shape with
// an f32 bias.  Registers and shared memory: ptxas's report in the build log,
// and hstu_attn_fwd_bf16_occupancy (with the ring stages).

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
constexpr int kLdB = kBlockK + 8;                // the bias tile's row stride in elements
constexpr int kStages = 2;                       // the K/V/bias ring
constexpr int kMaxGridY = 65535;                 // q tiles
static_assert(kKeySplits == 4 && kWarpKeys == 16, "the partial outputs are summed as (0 + 2) + (1 + 3)");

struct Params {
  const bf16 *q, *k, *v;
  const void* bias;
  const uint8_t* mask;
  bf16* out;
  int B, H, L, dqk, dv, shared_bias;
  float alpha, norm;
  int pk, pv;          // padded widths: dqk to 16 (the mma's k), dv to 8 (its n)
  int ldk, ldv;        // shared row strides in elements, 8 mod 16; ldv floats also the partial outputs'
  int vec_q, vec_k, vec_v;
  int vec_b, pairs_b;  // the bias copy: 16-byte chunks, else 4-byte ones where pairs_b, else 2-byte loads
};

inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

// two consecutive bias elements of a shared tile in f32 (p 8-byte aligned for f32, 4-byte for bf16)
__device__ __forceinline__ float2 pair_f32(const float* p) { return *reinterpret_cast<const float2*>(p); }
__device__ __forceinline__ float2 pair_f32(const bf16* p) { return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p)); }

// x0, x1 as bf16 pairs hi + mid + lo (mid the rounding error of hi, lo that
// of hi + mid, each rounded), the lower index in the low halves
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi, uint32_t& mid, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const float r0 = x0 - hf.x, r1 = x1 - hf.y;
  const __nv_bfloat162 m = __floats2bfloat162_rn(r0, r1);
  const float2 mf = __bfloat1622float2(m);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  mid = *reinterpret_cast<const uint32_t*>(&m);
  lo = pack_bf16(r0 - mf.x, r1 - mf.y);
}

__host__ __device__ inline int align16(int bytes) { return (bytes + 15) & ~15; }

// Shared memory in bytes, each part 16-byte aligned:
//   Q [kBlockQ][ldk] (bf16)
//   kStages stages of { K [kBlockK][ldk]  V [kBlockK][ldv] (bf16)  bias [kBlockQ][kLdB] (TB)  mask words [kBlockK/4 + 4] },
//   the stages also holding one slot of partial outputs per row group at the
//   end, [kRowGroups][16][ldv] f32: no more than a stage's V.
struct Layout {
  int q, stage, stage_bytes, k, v, b, km, total;
};

__host__ __device__ inline Layout layout(int ldk, int ldv, int bias_bytes) {
  Layout o;
  o.q = 0;
  o.stage = align16(2 * kBlockQ * ldk);
  o.k = 0;
  o.v = o.k + align16(2 * kBlockK * ldk);
  o.b = o.v + align16(2 * kBlockK * ldv);
  o.km = o.b + align16(bias_bytes * kBlockQ * kLdB);
  o.stage_bytes = o.km + 4 * (kBlockK / 4 + 4);
  o.total = o.stage + kStages * o.stage_bytes;  // the partial outputs fit in a stage's V
  return o;
}

template <int NV, typename TB>  // output n-tiles of 8 columns: dv <= 8 * NV; TB the bias type
__global__ void __launch_bounds__(kThreads, NV <= 4 ? 3 : 2) hstu_attn_fwd_bf16_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout lay = layout(p.ldk, p.ldv, sizeof(TB));
  bf16* Qs = reinterpret_cast<bf16*>(smem + lay.q);
  unsigned char* stages = smem + lay.stage;

  const int L = p.L, ldk = p.ldk, ldv = p.ldv;
  const int bh = blockIdx.x, b = bh / p.H, h = bh - b * p.H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlockQ;  // heaviest q tiles first
  const int q_end = min(q0 + kBlockQ, L);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int rg = warp % kRowGroups, ks = warp / kRowGroups;
  const bf16* kb = p.k + (size_t)bh * L * p.dqk;
  const bf16* vb = p.v + (size_t)bh * L * p.dv;
  const TB* bb = static_cast<const TB*>(p.bias) + (size_t)(p.shared_bias ? h : bh) * L * L;
  const int nvt = p.pv >> 3, nkc = p.pk >> 4;
  const float inv_n = 1.f / p.norm;
  const LdsmLane ll(lane);

  auto stage_ptr = [&](int s) { return stages + s * lay.stage_bytes; };
  auto issue = [&](int kt, int s) {
    unsigned char* st = stage_ptr(s);
    const int k0 = kt * kBlockK;
    copy_rows_bf16(reinterpret_cast<bf16*>(st + lay.k), ldk, kb, k0, kBlockK, L, p.dqk, p.pk, p.vec_k, tid, kThreads);
    copy_rows_bf16(reinterpret_cast<bf16*>(st + lay.v), ldv, vb, k0, kBlockK, L, p.dv, p.pv, p.vec_v, tid, kThreads);
    copy_causal_tile(reinterpret_cast<TB*>(st + lay.b), kLdB, bb, q0, kBlockQ, k0, kBlockK, L, p.vec_b, tid, kThreads, p.pairs_b);
    if (p.mask != nullptr)
      copy_mask(reinterpret_cast<int*>(st + lay.km), p.mask, (size_t)p.B * L, (size_t)b * L + k0, kBlockK, tid);
  };

  // Zero the padding columns dqk .. pk-1 of Q and of every stage's K (the
  // 16-byte copies leave them; V needs none: with vec, dv = pv); then the Q
  // tile and the first key tile.
  for (int r = tid; r < kBlockQ + kStages * kBlockK; r += kThreads) {
    bf16* row = r < kBlockQ ? Qs + r * ldk
                            : reinterpret_cast<bf16*>(stage_ptr((r - kBlockQ) / kBlockK) + lay.k) + ((r - kBlockQ) % kBlockK) * ldk;
    for (int d = p.dqk; d < p.pk; ++d) row[d] = __float2bfloat16(0.f);
  }
  copy_rows_bf16(Qs, ldk, p.q + (size_t)bh * L * p.dqk, q0, kBlockQ, L, p.dqk, p.pk, p.vec_q, tid, kThreads);
  issue(0, 0);
  cp_commit();

  float o[NV][4];
#pragma unroll
  for (int j = 0; j < NV; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;

  const int qr = 16 * rg, r0 = q0 + qr;    // this warp's first row, in the tile and in L
  const int r_last = min(r0 + 15, L - 1);  // its last real row
  const int n_kt = (q_end - 1) / kBlockK + 1;  // key tiles up to the causal frontier
  for (int kt = 0; kt < n_kt; ++kt) {
    cp_wait_all();
    __syncthreads();  // key tile kt visible; every warp is done with tile kt-1's stage
    if (kt + 1 < n_kt) issue(kt + 1, (kt + 1) & 1);
    cp_commit();
    const unsigned char* st = stage_ptr(kt & 1);
    const bf16* Ks = reinterpret_cast<const bf16*>(st + lay.k);
    const bf16* Vs = reinterpret_cast<const bf16*>(st + lay.v);
    const TB* Bs = reinterpret_cast<const TB*>(st + lay.b);
    const uint8_t* km = st + lay.km + (p.mask != nullptr ? mask_offset(p.mask, (size_t)b * L + kt * kBlockK) : 0);
    const int c0 = ks * kWarpKeys, m0 = kt * kBlockK + c0;  // this warp's first key, in the tile and in L
    if (r0 < L && m0 <= r_last) {                             // warp-uniform: some pair with m <= l
      // S = Q K^T: s[nt][i] is row qr + g + 8 (i >> 1), key c0 + 8 nt + 2t + (i & 1) of the tiles
      float s[2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      for (int kc = 0; kc < nkc; ++kc) {
        uint32_t a[4], bfr[4];
        ldsm_x4(a, Qs + (qr + ll.a_row) * ldk + 16 * kc + ll.a_col);
        ldsm_x4(bfr, Ks + (c0 + ll.bn_row) * ldk + 16 * kc + ll.bn_col);
        mma_bf16(s[0], a, bfr);
        mma_bf16(s[1], a, bfr + 2);
      }

      // scores -> P = silu(s) / N in f32.  This lane's bias: keys 2t, 2t+1 of rows g and g+8 of
      // each n-tile, one pair load each; only a valid pair's reaches arithmetic
      const TB* brow = Bs + (qr + g) * kLdB + c0 + 2 * t;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const float2 b_lo = pair_f32(brow + 8 * nt), b_hi = pair_f32(brow + 8 * kLdB + 8 * nt);
        const float bias[4] = {b_lo.x, b_lo.y, b_hi.x, b_hi.y};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int l = r0 + g + 8 * (i >> 1);
          const int c = c0 + 8 * nt + 2 * t + (i & 1), m = kt * kBlockK + c;
          float pv = 0.f;
          if (l < L && m <= l && (p.mask == nullptr || km[c])) {
            const float x = fmaf(s[nt][i], p.alpha, bias[i]);
            pv = x * (1.f / (1.f + expf(-x))) * inv_n;  // exp overflow: x * 0 = -0
          }
          s[nt][i] = pv;
        }
      }

      // O += P V over the warp's 16 keys, P as hi + mid + lo: P's fragment is the A fragment as is,
      // V's B fragments of two n-tiles come in one transposed ldmatrix
      uint32_t ah[4], am[4], al[4];
      split_bf16(s[0][0], s[0][1], ah[0], am[0], al[0]);
      split_bf16(s[0][2], s[0][3], ah[1], am[1], al[1]);
      split_bf16(s[1][0], s[1][1], ah[2], am[2], al[2]);
      split_bf16(s[1][2], s[1][3], ah[3], am[3], al[3]);
      const bf16* vp = Vs + (c0 + ll.bt_row) * ldv + ll.bt_col;
#pragma unroll
      for (int j = 0; j < NV; j += 2) {
        if (j + 1 < nvt) {
          uint32_t bfr[4];
          ldsm_x4_trans(bfr, vp + 8 * j);
          mma_bf16(o[j], al, bfr);
          mma_bf16(o[j], am, bfr);
          mma_bf16(o[j], ah, bfr);
          mma_bf16(o[j + 1], al, bfr + 2);
          mma_bf16(o[j + 1], am, bfr + 2);
          mma_bf16(o[j + 1], ah, bfr + 2);
        } else if (j < nvt) {
          uint32_t bfr[2];
          ldsm_x2_trans(bfr, vp + 8 * j);
          mma_bf16(o[j], al, bfr);
          mma_bf16(o[j], am, bfr);
          mma_bf16(o[j], ah, bfr);
        }
      }
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

template <int NV, typename TB>
cudaError_t launch(const Params& p, cudaStream_t stream, int* info) {
  const size_t smem = layout(p.ldk, p.ldv, sizeof(TB)).total;
  if (smem > kMaxSmem) return kNoFit;
  const auto kernel = hstu_attn_fwd_bf16_kernel<NV, TB>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  if (info != nullptr) {
    info[3] = kStages;
    return occupancy(kernel, kThreads, smem, info);
  }
  const dim3 grid(p.B * p.H, (p.L + kBlockQ - 1) / kBlockQ);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename TB>
cudaError_t dispatch(Params p, cudaStream_t st, int* info) {
  // 16-byte bias chunks where every chunk of 16 / sizeof(TB) keys lies wholly inside or past L and starts
  // aligned; 4-byte ones (two bf16) where L is even and the bias 4-byte aligned
  const uintptr_t addr = reinterpret_cast<uintptr_t>(p.bias);
  p.vec_b = p.L % (16 / (int)sizeof(TB)) == 0 && (addr & 15) == 0;
  p.pairs_b = sizeof(TB) == 4 || (p.L % 2 == 0 && (addr & 3) == 0);
  if (p.dv <= 8) return launch<1, TB>(p, st, info);
  if (p.dv <= 16) return launch<2, TB>(p, st, info);
  if (p.dv <= 32) return launch<4, TB>(p, st, info);
  if (p.dv <= 64) return launch<8, TB>(p, st, info);
  return launch<16, TB>(p, st, info);
}

int run_narrow(const void* q, const void* k, const void* v, const void* bias, const void* mask, void* out, int B, int H,
               int L, int dqk, int dv, int shared_bias, int bias_bf16, float alpha, float norm, void* stream, int* info) {
  if (dv > 128 || dqk > 256 || (L + kBlockQ - 1) / kBlockQ > kMaxGridY) return kNoFit;
  Params p;
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.bias = bias;
  p.mask = static_cast<const uint8_t*>(mask);
  p.out = static_cast<bf16*>(out);
  p.B = B;
  p.H = H;
  p.L = L;
  p.dqk = dqk;
  p.dv = dv;
  p.shared_bias = shared_bias;
  p.alpha = alpha;
  p.norm = norm;
  p.pk = round_up(dqk, 16);
  p.pv = round_up(dv, 8);
  p.ldk = p.pk + 8;
  p.ldv = round_up(dv, 16) + 8;
  const auto aligned = [](const void* ptr) { return ((uintptr_t)ptr & 15) == 0; };
  p.vec_q = dqk % 8 == 0 && aligned(q);
  p.vec_k = dqk % 8 == 0 && aligned(k);
  p.vec_v = dv % 8 == 0 && aligned(v);
  auto st = static_cast<cudaStream_t>(stream);
  return bias_bf16 ? dispatch<bf16>(p, st, info) : dispatch<float>(p, st, info);
}

// The tensor-core kernel where it takes the shape, else the width-tiled variant (hstu_wide.cuh)
int run(const void* q, const void* k, const void* v, const void* bias, const void* mask, void* out, int B, int H, int L,
        int dqk, int dv, int shared_bias, int bias_bf16, float alpha, float norm, void* stream, int* info, int* taken) {
  if (dv < 1 || dqk < 1 || L < 1 || (L + wide::kB - 1) / wide::kB > kMaxGridY || B * H < 1) return cudaErrorInvalidValue;
  return wide::dispatch(
      [&] {
        return static_cast<cudaError_t>(run_narrow(q, k, v, bias, mask, out, B, H, L, dqk, dv, shared_bias, bias_bf16, alpha, norm,
                                                   stream, info));
      },
      [&] {
        wide::Args w{};
        w.q = q, w.k = k, w.v = v, w.bias = bias;
        w.mask = static_cast<const uint8_t*>(mask), w.out0 = out;
        w.B = B, w.H = H, w.L = L, w.dqk = dqk, w.dv = dv, w.max_seq_len = L;
        w.alpha = alpha, w.norm = norm, w.bk = Buckets{0, 0, 0, 1.f};
        w.shared_bias = shared_bias;
        const auto st = static_cast<cudaStream_t>(stream);
        return bias_bf16 ? wide::launch<bf16, wide::kFwd, false, bf16>(w, st, info)
                         : wide::launch<bf16, wide::kFwd, false, float>(w, st, info);
      },
      taken, info);
}

}  // namespace

// q, k: (B, H, L, dqk) and v, out: (B, H, L, dv) bf16, contiguous, at any
// element offset; bias: (B, H, L, L), or (1, H, L, L) when shared_bias is
// nonzero, bf16 when bias_bf16 is nonzero else fp32, contiguous; mask: (B, L)
// bool or null (all keys valid).  norm: the silu normaliser (max_seq_len).
// The tensor-core kernel at dqk <= 256, dv <= 128, else the width-tiled
// variant: *taken (may be null) 0 or 1.  Returns the cudaError_t of the
// launch (0 on success).
extern "C" int hstu_attn_fwd_bf16(const void* q, const void* k, const void* v, const void* bias, const void* mask,
                                  void* out, int B, int H, int L, int dqk, int dv, int shared_bias, int bias_bf16,
                                  float alpha, float norm, void* stream, int* taken) {
  return run(q, k, v, bias, mask, out, B, H, L, dqk, dv, shared_bias, bias_bf16, alpha, norm, stream, nullptr, taken);
}

// The kernel that this shape would launch, without launching it: info[0]
// resident CTAs per SM, info[1] registers per thread, info[2] dynamic shared
// memory bytes per CTA, info[3] its ring stages (2 at every shape the
// tensor-core kernel takes, 1 for the variant), info[4] 0 the tensor-core
// kernel, 1 the width-tiled variant.  Returns the cudaError_t.
extern "C" int hstu_attn_fwd_bf16_occupancy(int L, int dqk, int dv, int bias_bf16, int* info) {
  return run(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, 1, 1, L, dqk, dv, 0, bias_bf16, 1.f, 1.f, nullptr,
             info, nullptr);
}

extern "C" const char* hstu_attn_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }
