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
// Design: the simple first one, FlashAttention-2's register reuse without
// its pipelining.
// - CTA = 4 warps over a 64-row q tile, each warp 16 rows; the CTA walks the
//   64-key tiles up to its causal frontier, heaviest q tile first.
// - Q of the tile, then K and V of each key tile, are staged in shared
//   memory as bf16 (16-byte loads where the width and the address allow,
//   else 2-byte ones, so a matrix may start at any element), widths padded
//   with zeros to the mma's k (16) and rows past L zero-filled.  One stage:
//   two barriers a key tile.
// - S = Q K^T and O += P V with mma.sync m16n8k16 bf16 -> f32.  The
//   accumulator fragment of S (rows g, g+8; keys 2t, 2t+1 of two 8-key
//   tiles) is, rounded to bf16 pairwise, the A fragment of P V as is: P never
//   leaves registers.  V's B fragment pairs two rows of one column.
// - Row strides are 4 mod 8 words (a multiple of 16 elements plus 8), so the
//   32-bit fragment loads of Q and K are free of bank conflicts.
// Registers and shared memory: ptxas's report in the build log, and
// hstu_rab_fwd_bf16_occupancy.

#include "hstu_rab_common.cuh"

namespace {

using namespace rab;
using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBlockQ = 16 * kWarps;  // q rows per CTA
constexpr int kBlockK = 64;           // keys per stage: 8 n-tiles of 8, 4 k-steps of 16

struct Params {
  const bf16 *q, *k, *v;
  const float *pos_w, *ts_w;
  const int *thr, *ts;
  const uint8_t* mask;
  bf16* out;
  int B, H, L, dqk, dv, max_seq_len;
  float alpha;
  Buckets bk;
  int pk, pv;          // padded widths: dqk to 16, dv to 8
  int ldk, ldv;        // shared row strides in elements: pk + 8, pv + 8
  int vec_q, vec_k, vec_v;
};

inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

// Shared memory in bytes, each part 16-byte aligned:
//   Q [kBlockQ][ldk]  K [kBlockK][ldk]  V [kBlockK][ldv]  (bf16)
//   tq [kBlockQ]  tk [kBlockK]  kv [kBlockK]  (int)  pw [L]  tw [nb+1]  (f32)  thr [nb+1]  (int)
struct Layout {
  int q, k, v, tq, tk, kv, pw, tw, th, total;
};

__host__ __device__ inline int align16(int bytes) { return (bytes + 15) & ~15; }

__host__ __device__ inline Layout layout(int ldk, int ldv, int L, int nb) {
  Layout o;
  o.q = 0;
  o.k = o.q + align16(2 * kBlockQ * ldk);
  o.v = o.k + align16(2 * kBlockK * ldk);
  o.tq = o.v + align16(2 * kBlockK * ldv);
  o.tk = o.tq + 4 * kBlockQ;
  o.kv = o.tk + 4 * kBlockK;
  o.pw = o.kv + 4 * kBlockK;
  o.tw = o.pw + align16(4 * L);
  o.th = o.tw + align16(4 * (nb + 1));
  o.total = o.th + align16(4 * (nb + 1));
  return o;
}

template <int NV>  // output n-tiles of 8 columns: dv <= 8 * NV
__global__ void __launch_bounds__(kThreads) hstu_rab_fwd_bf16_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout lay = layout(p.ldk, p.ldv, p.L, p.bk.nb);
  bf16* Qs = reinterpret_cast<bf16*>(smem + lay.q);
  bf16* Ks = reinterpret_cast<bf16*>(smem + lay.k);
  bf16* Vs = reinterpret_cast<bf16*>(smem + lay.v);
  int* tq = reinterpret_cast<int*>(smem + lay.tq);
  int* tk = reinterpret_cast<int*>(smem + lay.tk);
  int* kv = reinterpret_cast<int*>(smem + lay.kv);
  float* pw = reinterpret_cast<float*>(smem + lay.pw);
  float* tw = reinterpret_cast<float*>(smem + lay.tw);
  int* th = reinterpret_cast<int*>(smem + lay.th);

  const int L = p.L, H = p.H, ldk = p.ldk, ldv = p.ldv;
  const int bh = blockIdx.x, b = bh / H, h = bh - b * H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlockQ;  // heaviest q tiles first
  const int q_end = min(q0 + kBlockQ, L);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const bool has_time = p.ts != nullptr;
  const bf16* kb = p.k + (size_t)bh * L * p.dqk;
  const bf16* vb = p.v + (size_t)bh * L * p.dv;
  const int* tsb = has_time ? p.ts + (size_t)b * L : nullptr;
  const int nvt = (p.dv + 7) >> 3, nkc = p.pk >> 4;
  const float inv_n = 1.f / (float)p.max_seq_len;
  const Lookup bucket(th, p.bk);

  stage_rows_bf16(Qs, ldk, p.q + (size_t)bh * L * p.dqk, q0, kBlockQ, L, p.dqk, p.pk, p.vec_q, tid, kThreads);
  if (tid < kBlockQ) tq[tid] = has_time && q0 + tid < L ? tsb[q0 + tid] : 0;
  for (int d = tid; d < q_end; d += kThreads) pw[d] = p.pos_w[(size_t)(p.max_seq_len - 1 - d) * H + h];
  if (has_time)
    for (int u = tid; u <= p.bk.nb; u += kThreads) {
      tw[u] = p.ts_w[(size_t)u * H + h];
      th[u] = p.thr[u];
    }

  float o[NV][4];
#pragma unroll
  for (int j = 0; j < NV; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;

  const int qr = 16 * warp, r0 = q0 + qr;  // this warp's first row, in the tile and in L
  const int r_last = min(r0 + 15, L - 1);
  const int n_kt = (q_end - 1) / kBlockK + 1;  // key tiles up to the causal frontier
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBlockK;
    __syncthreads();  // every warp is done with the last key tile
    stage_rows_bf16(Ks, ldk, kb, k0, kBlockK, L, p.dqk, p.pk, p.vec_k, tid, kThreads);
    stage_rows_bf16(Vs, ldv, vb, k0, kBlockK, L, p.dv, p.pv, p.vec_v, tid, kThreads);
    if (tid < kBlockK) {
      const int m = k0 + tid;
      tk[tid] = has_time && m < L ? tsb[m] : 0;
      kv[tid] = m < L && (p.mask == nullptr || p.mask[(size_t)b * L + m] != 0);
    }
    __syncthreads();  // the key tile (and, at kt = 0, Q and the tables) is visible
    if (r0 >= L || k0 > r_last) continue;  // no pair with m <= l for this warp

    // S = Q K^T: s[nt][i] is row qr + g + 8 (i >> 1), key 8 nt + 2t + (i & 1) of the tile
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
    for (int kc = 0; kc < nkc; ++kc) {
      const bf16* qp = Qs + (qr + g) * ldk + 16 * kc + 2 * t;
      const uint32_t a[4] = {ld_pair(qp), ld_pair(qp + 8 * ldk), ld_pair(qp + 8), ld_pair(qp + 8 * ldk + 8)};
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const bf16* kp = Ks + (8 * nt + g) * ldk + 16 * kc + 2 * t;
        const uint32_t bb[2] = {ld_pair(kp), ld_pair(kp + 8)};
        mma_bf16(s[nt], a, bb);
      }
    }

    // scores -> P = silu(s) / N in f32 (rounded to bf16 when packed below)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int rl = qr + g + 8 * (i >> 1), l = q0 + rl;
        const int c = 8 * nt + 2 * t + (i & 1), m = k0 + c;
        float pv = 0.f;
        if (l < L && m <= l && kv[c]) {
          float x = fmaf(s[nt][i], p.alpha, pw[l - m]);
          if (has_time) x += tw[bucket(tq[rl], tk[c])];
          pv = x * (1.f / (1.f + expf(-x))) * inv_n;  // exp overflow: x * 0 = -0
        }
        s[nt][i] = pv;
      }

    // O += P V over 4 steps of 16 keys: P's fragment is the A fragment as is
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      const uint32_t a[4] = {pack_bf16(s[2 * kc][0], s[2 * kc][1]), pack_bf16(s[2 * kc][2], s[2 * kc][3]),
                             pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]), pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3])};
      const bf16* vp = Vs + (16 * kc + 2 * t) * ldv + g;
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        if (j < nvt) {
          const uint32_t bb[2] = {ld_column_pair(vp + 8 * j, ldv), ld_column_pair(vp + 8 * ldv + 8 * j, ldv)};
          mma_bf16(o[j], a, bb);
        }
      }
    }
  }

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

template <int NV>
cudaError_t launch(const Params& p, cudaStream_t stream, int* info) {
  const size_t smem = layout(p.ldk, p.ldv, p.L, p.bk.nb).total;
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(hstu_rab_fwd_bf16_kernel<NV>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  if (info != nullptr) return occupancy(hstu_rab_fwd_bf16_kernel<NV>, kThreads, smem, info);
  const dim3 grid(p.B * p.H, (p.L + kBlockQ - 1) / kBlockQ);
  hstu_rab_fwd_bf16_kernel<NV><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

int run(const void* q, const void* k, const void* v, const void* pos_w, const void* ts_w, const void* thr,
        const void* ts, const void* mask, void* out, int B, int H, int L, int dqk, int dv, int max_seq_len,
        int num_buckets, float alpha, int fn_log, int minutes, float divisor, void* stream, int* info) {
  if (dv < 1 || dv > 128 || dqk < 1 || dqk > 256 || L < 1 || L > max_seq_len || num_buckets < 0)
    return cudaErrorInvalidValue;
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
  p.ldv = p.pv + 8;
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

}  // namespace

// q, k: (B, H, L, dqk) and v, out: (B, H, L, dv) bf16, contiguous, at any
// element offset; pos_w: (2*max_seq_len-1, H) and ts_w: (num_buckets+1, H)
// fp32; thr: (num_buckets+1,) int32; ts: (B, L) int32 or null; mask: (B, L)
// bool or null.  The arguments of hstu_rab_fwd (hstu_rab_fwd.cu).  Returns
// the cudaError_t of the launch (0 on success).
extern "C" int hstu_rab_fwd_bf16(const void* q, const void* k, const void* v, const void* pos_w, const void* ts_w,
                                 const void* thr, const void* ts, const void* mask, void* out, int B, int H, int L,
                                 int dqk, int dv, int max_seq_len, int num_buckets, float alpha, int fn_log,
                                 int minutes, float divisor, void* stream) {
  return run(q, k, v, pos_w, ts_w, thr, ts, mask, out, B, H, L, dqk, dv, max_seq_len, num_buckets, alpha, fn_log,
             minutes, divisor, stream, nullptr);
}

// info[0] resident CTAs per SM, info[1] registers per thread, info[2]
// dynamic shared memory bytes per CTA of the kernel this shape would launch.
extern "C" int hstu_rab_fwd_bf16_occupancy(int L, int dqk, int dv, int max_seq_len, int num_buckets, int* info) {
  return run(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, 1, 1, L, dqk, dv,
             max_seq_len, num_buckets, 1.f, 0, 0, 1.f, nullptr, info);
}

extern "C" const char* hstu_rab_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }
