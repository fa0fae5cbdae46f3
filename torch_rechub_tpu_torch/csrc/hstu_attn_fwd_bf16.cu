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
// f32 attn on bf16 tensor cores: attn = hi + lo, hi = bf16(attn) and
// lo = bf16(attn - hi), and O += hi V + lo V, two m16n8k16 products whose
// terms are exact in f32.  The pair holds attn to about 2^-17 relative,
// far below the output's bf16 rounding (2^-9), so the result is the f32
// product's up to its summation order.  (3xTF32, as the fp32 K3 runs it,
// would need two m16n8k8 products for every one here; bf16 v is exact in
// either.)
//
// What bounds it on an H100: bytes.  At the serving shape (B8 H8 L256,
// dqk = dv = 32, a per-batch f32 bias) the valid pairs read about 8 MB of
// the bias's lower triangle beside 4.2 MB of bf16 q/k/v/out, 0.0038 ms at
// 3.35 TB/s, against 0.25 GFLOP of products, 0.0003 ms at 989 TFLOP/s.
//
// Design: the simple first one, K1-bf16's loop (hstu_rab_fwd_bf16.cu) with
// the bias read in place of the tables and the bucket lookup.
// - CTA = 4 warps over a 64-row q tile, each warp 16 rows; the CTA walks the
//   64-key tiles up to its causal frontier, heaviest q tile first.
// - Q of the tile, then K and V of each key tile, are staged in shared
//   memory as bf16 (16-byte loads where the width and the address allow,
//   else 2-byte ones, so a matrix may start at any element), widths padded
//   with zeros to the mma's k (16) and rows past L zero-filled.  One stage:
//   two barriers a key tile.
// - S = Q K^T and O += P V with mma.sync m16n8k16 bf16 -> f32.  The
//   accumulator fragment of S (rows g, g+8; keys 2t, 2t+1 of two 8-key
//   tiles), split into hi and lo pairwise, is the A fragment of P V as is:
//   P never leaves registers.
// - The bias: each lane reads the elements of its own fragment (keys 2t,
//   2t+1 of rows g and g+8) straight from device memory, valid pairs only;
//   four lanes cover 8 consecutive keys of a row.
// Registers and shared memory: ptxas's report in the build log, and
// hstu_attn_fwd_bf16_occupancy.

#include "hstu_rab_common.cuh"

namespace {

using namespace rab;
using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBlockQ = 16 * kWarps;  // q rows per CTA
constexpr int kBlockK = 64;           // keys per stage: 8 n-tiles of 8, 4 k-steps of 16
constexpr int kMaxGridY = 65535;      // q tiles

struct Params {
  const bf16 *q, *k, *v;
  const void* bias;
  const uint8_t* mask;
  bf16* out;
  int B, H, L, dqk, dv, shared_bias;
  float alpha, norm;
  int pk, pv;          // padded widths: dqk to 16, dv to 8
  int ldk, ldv;        // shared row strides in elements: pk + 8, pv + 8
  int vec_q, vec_k, vec_v;
};

inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

// x0, x1 as bf16 pairs hi + lo (lo the rounding error of hi, rounded), lo index in the low halves
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(x0 - hf.x, x1 - hf.y);
}

// Shared memory in bytes, each part 16-byte aligned:
//   Q [kBlockQ][ldk]  K [kBlockK][ldk]  V [kBlockK][ldv]  (bf16)  kv [kBlockK]  (int)
struct Layout {
  int q, k, v, kv, total;
};

__host__ __device__ inline int align16(int bytes) { return (bytes + 15) & ~15; }

__host__ __device__ inline Layout layout(int ldk, int ldv) {
  Layout o;
  o.q = 0;
  o.k = o.q + align16(2 * kBlockQ * ldk);
  o.v = o.k + align16(2 * kBlockK * ldk);
  o.kv = o.v + align16(2 * kBlockK * ldv);
  o.total = o.kv + 4 * kBlockK;
  return o;
}

template <int NV, typename TB>  // output n-tiles of 8 columns: dv <= 8 * NV; TB the bias type
__global__ void __launch_bounds__(kThreads) hstu_attn_fwd_bf16_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout lay = layout(p.ldk, p.ldv);
  bf16* Qs = reinterpret_cast<bf16*>(smem + lay.q);
  bf16* Ks = reinterpret_cast<bf16*>(smem + lay.k);
  bf16* Vs = reinterpret_cast<bf16*>(smem + lay.v);
  int* kv = reinterpret_cast<int*>(smem + lay.kv);

  const int L = p.L, ldk = p.ldk, ldv = p.ldv;
  const int bh = blockIdx.x, b = bh / p.H, h = bh - b * p.H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlockQ;  // heaviest q tiles first
  const int q_end = min(q0 + kBlockQ, L);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const bf16* kb = p.k + (size_t)bh * L * p.dqk;
  const bf16* vb = p.v + (size_t)bh * L * p.dv;
  const TB* bb = static_cast<const TB*>(p.bias) + (size_t)(p.shared_bias ? h : bh) * L * L;
  const int nvt = (p.dv + 7) >> 3, nkc = p.pk >> 4;
  const float inv_n = 1.f / p.norm;

  stage_rows_bf16(Qs, ldk, p.q + (size_t)bh * L * p.dqk, q0, kBlockQ, L, p.dqk, p.pk, p.vec_q, tid, kThreads);

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
      kv[tid] = m < L && (p.mask == nullptr || p.mask[(size_t)b * L + m] != 0);
    }
    __syncthreads();  // the key tile (and, at kt = 0, Q) is visible
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
        const uint32_t bfr[2] = {ld_pair(kp), ld_pair(kp + 8)};
        mma_bf16(s[nt], a, bfr);
      }
    }

    // scores -> P = silu(s) / N in f32; the bias of valid pairs only
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int l = r0 + g + 8 * (i >> 1);
        const int c = 8 * nt + 2 * t + (i & 1), m = k0 + c;
        float pv = 0.f;
        if (l < L && m <= l && kv[c]) {
          const float x = fmaf(s[nt][i], p.alpha, to_f32(bb[(size_t)l * L + m]));
          pv = x * (1.f / (1.f + expf(-x))) * inv_n;  // exp overflow: x * 0 = -0
        }
        s[nt][i] = pv;
      }

    // O += P V over 4 steps of 16 keys, P as hi + lo: P's fragment is the A fragment as is
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      uint32_t ah[4], al[4];
      split_bf16(s[2 * kc][0], s[2 * kc][1], ah[0], al[0]);
      split_bf16(s[2 * kc][2], s[2 * kc][3], ah[1], al[1]);
      split_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1], ah[2], al[2]);
      split_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3], ah[3], al[3]);
      const bf16* vp = Vs + (16 * kc + 2 * t) * ldv + g;
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        if (j < nvt) {
          const uint32_t bfr[2] = {ld_column_pair(vp + 8 * j, ldv), ld_column_pair(vp + 8 * ldv + 8 * j, ldv)};
          mma_bf16(o[j], al, bfr);
          mma_bf16(o[j], ah, bfr);
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

template <int NV, typename TB>
cudaError_t launch(const Params& p, cudaStream_t stream, int* info) {
  const size_t smem = layout(p.ldk, p.ldv).total;
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  const auto kernel = hstu_attn_fwd_bf16_kernel<NV, TB>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  if (info != nullptr) return occupancy(kernel, kThreads, smem, info);
  const dim3 grid(p.B * p.H, (p.L + kBlockQ - 1) / kBlockQ);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename TB>
cudaError_t dispatch(const Params& p, cudaStream_t st, int* info) {
  if (p.dv <= 8) return launch<1, TB>(p, st, info);
  if (p.dv <= 16) return launch<2, TB>(p, st, info);
  if (p.dv <= 32) return launch<4, TB>(p, st, info);
  if (p.dv <= 64) return launch<8, TB>(p, st, info);
  return launch<16, TB>(p, st, info);
}

int run(const void* q, const void* k, const void* v, const void* bias, const void* mask, void* out, int B, int H, int L,
        int dqk, int dv, int shared_bias, int bias_bf16, float alpha, float norm, void* stream, int* info) {
  if (dv < 1 || dv > 128 || dqk < 1 || dqk > 256 || L < 1 || (L + kBlockQ - 1) / kBlockQ > kMaxGridY || B * H < 1)
    return cudaErrorInvalidValue;
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
  p.ldv = p.pv + 8;
  const auto aligned = [](const void* ptr) { return ((uintptr_t)ptr & 15) == 0; };
  p.vec_q = dqk % 8 == 0 && aligned(q);
  p.vec_k = dqk % 8 == 0 && aligned(k);
  p.vec_v = dv % 8 == 0 && aligned(v);
  auto st = static_cast<cudaStream_t>(stream);
  return bias_bf16 ? dispatch<bf16>(p, st, info) : dispatch<float>(p, st, info);
}

}  // namespace

// q, k: (B, H, L, dqk) and v, out: (B, H, L, dv) bf16, contiguous, at any
// element offset; bias: (B, H, L, L), or (1, H, L, L) when shared_bias is
// nonzero, bf16 when bias_bf16 is nonzero else fp32, contiguous; mask: (B, L)
// bool or null (all keys valid).  norm: the silu normaliser (max_seq_len).
// dqk <= 256, dv <= 128.  Returns the cudaError_t of the launch (0 on success).
extern "C" int hstu_attn_fwd_bf16(const void* q, const void* k, const void* v, const void* bias, const void* mask,
                                  void* out, int B, int H, int L, int dqk, int dv, int shared_bias, int bias_bf16,
                                  float alpha, float norm, void* stream) {
  return run(q, k, v, bias, mask, out, B, H, L, dqk, dv, shared_bias, bias_bf16, alpha, norm, stream, nullptr);
}

// The kernel that this shape would launch, without launching it: info[0]
// resident CTAs per SM, info[1] registers per thread, info[2] dynamic shared
// memory bytes per CTA.  Returns the cudaError_t.
extern "C" int hstu_attn_fwd_bf16_occupancy(int L, int dqk, int dv, int bias_bf16, int* info) {
  return run(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, 1, 1, L, dqk, dv, 0, bias_bf16, 1.f, 1.f, nullptr,
             info);
}

extern "C" const char* hstu_attn_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }
