// The width-tiled variants of the attention kernels: K1, K2, K2a, K2b and
// K3 for every shape that the tensor-core kernels do not take, in fp32 and
// in bf16.  Those keep a warp's output rows in registers and a tile's full
// width, and the bias tables, in shared memory, so they stop at dv <= 128
// and dqk <= 256 (forward) or dqk, dv <= 128 (backward), and where their
// shared memory outgrows the SM at a long L.  Here nothing grows with the
// width or with L:
// - a CTA of 256 threads owns a 64-row tile (queries for K1, K3 and K2a;
//   keys for K2b) and one chunk of 64 output columns (grid z), and walks
//   the 64-wide tiles of the other side up to the causal frontier;
// - the scores S (and in the backward dA = G V^T) are built by a K-loop over
//   the full width in chunks of 32 features staged in shared memory, each
//   thread holding a 4 x 4 block of the 64 x 64 tile in registers, so the
//   silu (and bf16's rounding of attn and ds) sees the full-width sums;
// - P (and dS) go to shared memory, and the CTA's 64 x 64 output block
//   takes its product with the tile's rows of v (k, q or g) in its chunk's
//   columns: the scores are recomputed once per chunk, the price of taking
//   any width;
// - the bias is read where it lies: pos_w and ts_w from global memory (they
//   are small and stay in cache) with K1's exact bucket lookup against the
//   thresholds in global memory; K3's materialised bias by element.
// Products are fp32 FMAs on the CUDA cores (exact products of bf16 inputs,
// f32 sums), not the tensor cores: these variants are the simple ones.
// K2a's table gradients (chunk 0's CTAs) are summed in a fixed order: dpos
// per tile by diagonal, one thread a distance, into the CTA's slice of the
// scratch buffer; dts by row, one thread a row (or a few) folding runs of
// equal buckets into a table of its own, the tables added in order at the
// end; reduce_tables then adds the slices in CTA order (hstu_rab_common.cuh).
// K2 at these shapes is K2a's variant then K2b's: dq by K2a's fixed order.
#pragma once

#include "hstu_rab_common.cuh"

namespace wide {

using namespace rab;

constexpr int kThreads = 256;
constexpr int kB = 64;            // rows of a tile, columns of a tile, output columns of a CTA
constexpr int kD = 32;            // features a step of the score products stages
constexpr int kLdD = kD + 1;      // row strides in floats: no bank conflicts
constexpr int kLd = kB + 1;
constexpr int kTableFloats = 12288;  // dts tables of K2a's variant: at most 48 KB

enum Role { kFwd = 0, kDq = 1, kDkv = 2 };

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float round_bf16(float x) { return __bfloat162float(__float2bfloat16(x)); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

struct Args {
  const void *q, *k, *v, *g;    // T: float or bf16
  const float *pos_w, *ts_w;    // the rab tables (kRab)
  const int *thr, *ts;
  const void* bias;             // K3's materialised bias, of the kernel's BT
  const uint8_t* mask;
  void *out0, *out1;            // K1, K3: out; K2a: dq; K2b: dk, dv
  float* scratch;               // K2a: a slice of table sums per CTA of chunk 0
  float *dpos, *dts;            // K2a: the table gradients, reduce_tables's sums of the slices
  int out_f32;                  // K2a: dq as f32 sums (bf16 K2's dq buffer)
  int B, H, L, dqk, dv, max_seq_len;
  float alpha, norm;
  Buckets bk;
  int shared_bias;
  int tables;                   // K2a: dts tables
};

// Rows row0 .. row0+kB-1, features d0 .. d0+kD-1 of a row-major (L, width)
// matrix into dst [kB][kLdD] as floats, zero past L or width
template <typename T>
__device__ __forceinline__ void load_features(float* dst, const T* src, int row0, int L, int width, int d0) {
  for (int i = threadIdx.x; i < kB * kD; i += kThreads) {
    const int r = i / kD, c = i - r * kD, row = row0 + r, col = d0 + c;
    dst[r * kLdD + c] = row < L && col < width ? to_f(src[(size_t)row * width + col]) : 0.f;
  }
}

// Rows row0 .. row0+kB-1, columns j0 .. j0+kB-1 into dst [kB][kLd], zero past L or width
template <typename T>
__device__ __forceinline__ void load_block(float* dst, const T* src, int row0, int L, int width, int j0) {
  for (int i = threadIdx.x; i < kB * kB; i += kThreads) {
    const int r = i / kB, c = i - r * kB, row = row0 + r, col = j0 + c;
    dst[r * kLd + c] = row < L && col < width ? to_f(src[(size_t)row * width + col]) : 0.f;
  }
}

// acc[i][j] += sum over the width of A[row0 + ty + 16i] . B[col0 + tx + 16j], K-looped in steps of kD
template <typename T>
__device__ __forceinline__ void score_product(float acc[4][4], float* As, float* Bs, const T* A, const T* Bm, int row0,
                                              int col0, int L, int width, int ty, int tx) {
  for (int d0 = 0; d0 < width; d0 += kD) {
    __syncthreads();  // the last step's reads are done
    load_features(As, A, row0, L, width, d0);
    load_features(Bs, Bm, col0, L, width, d0);
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kD; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = As[(ty + 16 * i) * kLdD + kk];
        b[i] = Bs[(tx + 16 * i) * kLdD + kk];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
}

// acc[i][j] += sum over c of X[ty + 16i][c] Y[c][tx + 16j] (bf16 rounds X first where round)
__device__ __forceinline__ void block_product(float acc[4][4], const float* X, const float* Ys, bool round, int ty, int tx) {
#pragma unroll 4
  for (int c = 0; c < kB; ++c) {
    float x[4], y[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x[i] = X[(ty + 16 * i) * kLd + c];
      if (round) x[i] = round_bf16(x[i]);
      y[i] = Ys[c * kLd + tx + 16 * i];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(x[i], y[j], acc[i][j]);
  }
}

// Shared memory in floats: As, Bs [kB][kLdD]; X0, X1 [kB][kLd] (P, dS); Ys [kB][kLd];
// rstamp, cstamp, rvalid, cvalid [kB] (int); K2a: tables [tables][nb4]
__host__ __device__ inline int smem_floats(int role, int tables, int nb) {
  const int nb4 = (nb + 1 + 3) & ~3;
  return 2 * kB * kLdD + (role == kDkv ? 3 : 2) * kB * kLd + 4 * kB + (role == kDq ? tables * nb4 : 0);
}

// kRole: kFwd (K1, K3), kDq (K2a), kDkv (K2b); kRab: the bias from the tables (K1, K2*), else K3's
// materialised bias of BT
template <typename T, int kRole, bool kRab, typename BT = float>
__global__ void __launch_bounds__(kThreads) wide_kernel(Args a) {
  extern __shared__ __align__(16) float smem[];
  float* As = smem;
  float* Bs = As + kB * kLdD;
  float* X0 = Bs + kB * kLdD;
  float* X1 = X0 + kB * kLd;
  float* Ys = X1 + (kRole == kDkv ? kB * kLd : 0);
  int* rstamp = reinterpret_cast<int*>(Ys + kB * kLd);
  int* cstamp = rstamp + kB;
  int* rvalid = cstamp + kB;  // K2b: the row keys' mask
  int* cvalid = rvalid + kB;  // K1, K3, K2a: the column keys' mask
  float* tabs = reinterpret_cast<float*>(cvalid + kB);

  const int L = a.L, H = a.H, tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int bh = blockIdx.x, b = bh / H, h = bh - b * H;
  const int r0 = (kRole == kDkv ? blockIdx.y : gridDim.y - 1 - blockIdx.y) * kB;  // the heaviest tiles first
  const int j0 = blockIdx.z * kB;
  const bool has_time = kRab && a.ts != nullptr;
  const int* tsb = has_time ? a.ts + (size_t)b * L : nullptr;
  const T* qb = static_cast<const T*>(a.q) + (size_t)bh * L * a.dqk;
  const T* kb = static_cast<const T*>(a.k) + (size_t)bh * L * a.dqk;
  const T* vb = static_cast<const T*>(a.v) + (size_t)bh * L * a.dv;
  const T* gb = kRole == kFwd ? nullptr : static_cast<const T*>(a.g) + (size_t)bh * L * a.dv;
  const float inv_n = 1.f / a.norm;
  const Lookup bucket(a.thr, a.bk);
  const bool tables = kRole == kDq && blockIdx.z == 0;
  const int nb = a.bk.nb, nb4 = (nb + 1 + 3) & ~3;
  float* slice = tables ? a.scratch + ((size_t)bh * gridDim.y + blockIdx.y) * (L + nb + 1) : nullptr;
  const BT* biasb = nullptr;
  if constexpr (!kRab) biasb = static_cast<const BT*>(a.bias) + ((size_t)(a.shared_bias ? 0 : b) * H + h) * L * L;

  // the row side's stamps and key validity, and the table sums zeroed
  if (tid < kB) {
    const int row = r0 + tid;
    rstamp[tid] = has_time && row < L ? tsb[row] : 0;
    rvalid[tid] = row < L && (a.mask == nullptr || a.mask[(size_t)b * L + row] != 0);
  }
  if (tables) {
    for (int i = tid; i < a.tables * nb4; i += kThreads) tabs[i] = 0.f;
    for (int d = tid; d < L; d += kThreads) slice[d] = 0.f;
  }

  float acc0[4][4], acc1[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc0[i][j] = acc1[i][j] = 0.f;

  const int c_first = kRole == kDkv ? r0 : 0, c_last = kRole == kDkv ? L - 1 : min(r0 + kB - 1, L - 1);
  for (int c0 = c_first; c0 <= c_last; c0 += kB) {
    __syncthreads();  // the last tile's X and Ys are consumed; the stamps and sums above are written
    if (tid < kB) {
      const int col = c0 + tid;
      cstamp[tid] = has_time && col < L ? tsb[col] : 0;
      cvalid[tid] = col < L && (a.mask == nullptr || a.mask[(size_t)b * L + col] != 0);
    }
    float s[4][4], da[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = da[i][j] = 0.f;
    if constexpr (kRole == kDkv) {
      score_product(s, As, Bs, kb, qb, r0, c0, L, a.dqk, ty, tx);   // S^T = K Q^T
      score_product(da, As, Bs, vb, gb, r0, c0, L, a.dv, ty, tx);   // dA^T = V G^T
    } else {
      score_product(s, As, Bs, qb, kb, r0, c0, L, a.dqk, ty, tx);   // S = Q K^T
      if constexpr (kRole == kDq) score_product(da, As, Bs, gb, vb, r0, c0, L, a.dv, ty, tx);  // dA = G V^T
    }
    // P and dS of the tile: (l, m) = (row, column), or (column, row) for K2b
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int rr = ty + 16 * i, cc = tx + 16 * j;
        const int l = kRole == kDkv ? c0 + cc : r0 + rr, m = kRole == kDkv ? r0 + rr : c0 + cc;
        const bool key_ok = kRole == kDkv ? rvalid[rr] != 0 : cvalid[cc] != 0;
        float pv = 0.f, dsv = 0.f;
        if (l < L && m <= l && key_ok) {
          float x;
          if constexpr (kRab) {
            x = a.pos_w[(size_t)(a.max_seq_len - 1 - (l - m)) * H + h];
            if (has_time) {
              const int tl = kRole == kDkv ? cstamp[cc] : rstamp[rr], tm = kRole == kDkv ? rstamp[rr] : cstamp[cc];
              x += a.ts_w[(size_t)bucket(tl, tm) * H + h];
            }
          } else {
            x = to_f(biasb[(size_t)l * L + m]);
          }
          x = fmaf(s[i][j], a.alpha, x);
          if constexpr (kRole == kFwd) {
            pv = __fdividef(x, (1.f + __expf(-x)) * a.norm);  // exp overflow: x / inf = -0
          } else {
            const float sig = __fdividef(1.f, 1.f + __expf(-x));  // exp overflow: 0
            pv = x * sig * inv_n;
            dsv = da[i][j] * (sig * (1.f + x * (1.f - sig))) * inv_n;
          }
        }
        if constexpr (kRole == kDq) {
          X0[rr * kLd + cc] = dsv;
        } else {
          X0[rr * kLd + cc] = pv;
          if constexpr (kRole == kDkv) X1[rr * kLd + cc] = dsv;
        }
      }
    __syncthreads();  // P, dS complete

    if (tables) {
      // dpos: thread e < 127 sums the diagonal rr - cc = e - 63 in row order: distance r0 - c0 + e - 63
      if (tid < 2 * kB - 1) {
        const int e = tid - (kB - 1), d = r0 - c0 + e;
        if (d >= 0 && d < L) {
          float sum = 0.f;
          for (int rr = max(0, e); rr < min(kB, kB + e); ++rr) sum += X0[rr * kLd + rr - e];
          slice[d] += sum;
        }
      }
      // dts: thread w < tables walks rows w, w + tables, ... key by key, a run of equal buckets at a time
      if (has_time && tid < a.tables) {
        float* tab = tabs + tid * nb4;
        for (int rr = tid; rr < kB; rr += a.tables) {
          const int l = r0 + rr;
          int cur = -1;
          float run = 0.f;
          for (int cc = 0; cc < kB; ++cc) {
            const int m = c0 + cc;
            if (l >= L || m > l || !cvalid[cc]) continue;
            const int u = bucket(rstamp[rr], cstamp[cc]);
            if (u != cur) {
              if (cur >= 0) tab[cur] += run;
              cur = u;
              run = 0.f;
            }
            run += X0[rr * kLd + cc];
          }
          if (cur >= 0) tab[cur] += run;
        }
      }
    }

    // the CTA's output block: rows of v (K1, K3), k (K2a), q then g (K2b) in the chunk's columns
    constexpr bool kRound = sizeof(T) == 2 && (kRab || kRole != kFwd);  // bf16 rounds attn and ds; K3-bf16 keeps attn f32
    if constexpr (kRole == kFwd) {
      load_block(Ys, vb, c0, L, a.dv, j0);
      __syncthreads();
      block_product(acc0, X0, Ys, kRound, ty, tx);
    } else if constexpr (kRole == kDq) {
      load_block(Ys, kb, c0, L, a.dqk, j0);
      __syncthreads();
      block_product(acc0, X0, Ys, kRound, ty, tx);
    } else {
      if (j0 < a.dqk) {
        load_block(Ys, qb, c0, L, a.dqk, j0);
        __syncthreads();
        block_product(acc0, X1, Ys, kRound, ty, tx);  // dK += dS^T Q
      }
      if (j0 < a.dv) {
        __syncthreads();
        load_block(Ys, gb, c0, L, a.dv, j0);
        __syncthreads();
        block_product(acc1, X0, Ys, kRound, ty, tx);  // dV += P^T G
      }
    }
  }

  // the outputs, each element written once
  const int w0 = kRole == kFwd ? a.dv : a.dqk;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + ty + 16 * i;
    if (row >= L) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = j0 + tx + 16 * j;
      if constexpr (kRole == kDkv) {
        if (col < a.dqk) store(static_cast<T*>(a.out0) + ((size_t)bh * L + row) * a.dqk + col, acc0[i][j] * a.alpha);
        if (col < a.dv) store(static_cast<T*>(a.out1) + ((size_t)bh * L + row) * a.dv + col, acc1[i][j]);
      } else if (col < w0) {
        const float x = kRole == kDq ? acc0[i][j] * a.alpha : acc0[i][j];
        const size_t at = ((size_t)bh * L + row) * w0 + col;
        if (kRole == kDq && a.out_f32)
          static_cast<float*>(a.out0)[at] = x;
        else
          store(static_cast<T*>(a.out0) + at, x);
      }
    }
  }
  if (tables && has_time) {
    __syncthreads();  // every table is complete
    for (int u = tid; u <= nb; u += kThreads) {
      float sum = 0.f;
      for (int w = 0; w < a.tables; ++w) sum += tabs[w * nb4 + u];
      slice[L + u] = sum;
    }
  }
}

// The variant's launch (info: its occupancy instead, info[3] = 1 stage,
// info[4] = 1 the wide variant); K2a's also sums the tables into dpos, dts.
template <typename T, int kRole, bool kRab, typename BT = float>
cudaError_t launch(Args a, cudaStream_t stream, int* info) {
  const int nb4 = (a.bk.nb + 1 + 3) & ~3;
  a.tables = kRole == kDq ? max(1, min(kB, kTableFloats / nb4)) : 0;
  const size_t smem = sizeof(float) * smem_floats(kRole, a.tables, a.bk.nb);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;  // only where nb + 1 > kTableFloats: more buckets than the SM holds
  const auto kernel = wide_kernel<T, kRole, kRab, BT>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  if (info != nullptr) {
    info[3] = 1;
    info[4] = 1;
    return occupancy(kernel, kThreads, smem, info);
  }
  const int width = kRole == kFwd ? a.dv : (kRole == kDq ? a.dqk : max(a.dqk, a.dv));
  const int tiles = (a.L + kB - 1) / kB;
  kernel<<<dim3(a.B * a.H, tiles, (width + kB - 1) / kB), kThreads, smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess || kRole != kDq) return err;
  return reduce_tables(a.scratch, tiles, a.B, a.H, a.L, a.bk.nb, a.max_seq_len, a.ts != nullptr, a.dpos, a.dts, stream);
}

// An entry's dispatch: the tensor-core kernel (narrow()) where it takes the
// shape, else the width-tiled variant (variant()).  *taken (may be null)
// and, for an occupancy query, info[4]: 0 the tensor-core kernel, 1 the
// variant.
template <typename Narrow, typename Variant>
inline int dispatch(Narrow narrow, Variant variant, int* taken, int* info) {
  if (info != nullptr) info[4] = 0;
  cudaError_t rc = narrow();
  const int wide = rc == kNoFit;
  if (wide) rc = variant();
  if (taken != nullptr) *taken = wide;
  return rc;
}

}  // namespace wide
