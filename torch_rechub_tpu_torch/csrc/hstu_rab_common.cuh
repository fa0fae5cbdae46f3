// Building blocks shared by the attention kernels (hstu_rab_fwd.cu,
// hstu_rab_bwd.cu, hstu_attn_fwd.cu and the bf16 variants
// hstu_rab_fwd_bf16.cu, hstu_rab_bwd_bf16.cu, hstu_attn_fwd_bf16.cu): 3xTF32 and bf16 tensor-core
// products with mma.sync, ldmatrix fragment loads, tile copies (cp.async),
// the dq vector reduction, the exact O(1) time-bucket lookup, and the
// backward kernels' table-gradient sums.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rab {

constexpr int kIntMax = 2147483647;
constexpr size_t kMaxSmem = 232448;  // per-block dynamic shared memory limit on sm_90
// a tensor-core kernel's launcher where the shape is not one it takes (its
// width, or shared memory beyond kMaxSmem): the width-tiled variant takes it
constexpr cudaError_t kNoFit = static_cast<cudaError_t>(-1);

// info[0] resident CTAs per SM, info[1] registers per thread, info[2] the
// dynamic shared memory bytes of a launch of kernel with this block and smem
template <typename Kernel>
inline cudaError_t occupancy(Kernel kernel, int threads, size_t smem, int* info) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  info[1] = attr.numRegs;
  info[2] = (int)smem;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info[0], kernel, threads, smem);
}

// ---------------------------------------------------------------------------
// 3xTF32: x = hi + lo with hi, lo TF32 (10-bit mantissa); a product is
// hi*hi + hi*lo + lo*hi in fp32 accumulators (lo*lo, 2^-22 relative, dropped)
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// The residual goes in as fp32 bits: the tensor core reads its top 10
// mantissa bits (an error below 2^-20 of x, as small as the dropped lo*lo).
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// d += a * b, one m16n8k8 TF32 tile.  Fragments (g = lane / 4, t = lane % 4):
//   a: A[g][t], A[g+8][t], A[g][t+4], A[g+8][t+4]   (16 x 8, row major)
//   b: B[t][g], B[t+4][g]                            (8 x 8, k x n)
//   d: D[g][2t], D[g][2t+1], D[g+8][2t], D[g+8][2t+1]
__device__ __forceinline__ void mma_tf32(float d[4], const uint32_t a[4], const uint32_t b[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a * b in 3xTF32, the small terms first
__device__ __forceinline__ void mma3(float d[4], const uint32_t ah[4], const uint32_t al[4], const uint32_t bh[2],
                                     const uint32_t bl[2]) {
  mma_tf32(d, al, bh);
  mma_tf32(d, ah, bl);
  mma_tf32(d, ah, bh);
}

// A fragment of rows row0 + g, row0 + g + 8 and columns col0 + t, col0 + t + 4
// of a row-major shared tile, split into hi and lo
__device__ __forceinline__ void load_a(const float* s, int ld, int row0, int col0, int g, int t, uint32_t ah[4],
                                       uint32_t al[4]) {
  const float* p = s + (row0 + g) * ld + col0 + t;
  split(p[0], ah[0], al[0]);
  split(p[8 * ld], ah[1], al[1]);
  split(p[4], ah[2], al[2]);
  split(p[8 * ld + 4], ah[3], al[3]);
}

// ---------------------------------------------------------------------------
// bf16: one m16n8k16 product with f32 accumulators (the bf16 variants)
// ---------------------------------------------------------------------------

// d += a * b.  Each 32-bit register holds two bf16, the lower column (or
// k) index in the low half.  Fragments (g = lane / 4, t = lane % 4):
//   a: A[g][2t..2t+1], A[g+8][2t..2t+1], A[g][2t+8..2t+9], A[g+8][2t+8..2t+9]  (16 x 16, row major)
//   b: B[2t..2t+1][g], B[2t+8..2t+9][g]                                        (16 x 8, k x n)
//   d: D[g][2t], D[g][2t+1], D[g+8][2t], D[g+8][2t+1]   (the m16n8k8 layout)
__device__ __forceinline__ void mma_bf16(float d[4], const uint32_t a[4], const uint32_t b[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// two floats rounded to bf16 (to nearest even), lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// ldmatrix: four (x4) or two (x2) 8 x 8 bf16 matrices from shared memory,
// matrix i's eight 16-byte rows addressed by lanes 8i .. 8i+7 (each row
// address 16-byte aligned).  Register i holds matrix i as a fragment: lane
// (g, t) gets row g, columns 2t, 2t+1, or with .trans row 2t and 2t+1 of
// column g.  So a row-major 16 x 16 A tile, or the B fragments of two 8-wide
// n-tiles (rows n, columns k: plain; rows k, columns n: .trans), load in one
// instruction.  A tile whose row stride is 8 mod 16 elements (an odd number
// of 16-byte units) is read without bank conflicts.
__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const __nv_bfloat16* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t r[4], const __nv_bfloat16* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

__device__ __forceinline__ void ldsm_x2_trans(uint32_t r[2], const __nv_bfloat16* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];" : "=r"(r[0]), "=r"(r[1]) : "r"(s));
}

// The lane's row and column offsets for those x4 loads (the lane addresses
// matrix lane / 8; x2 uses the first two):
//   a:   a row-major 16 x 16 A tile: rows 0-7, 8-15 of columns 0-7, then of 8-15
//   bn:  B of n-tiles 0, 1 from a [n][k] tile: k 0-7, 8-15 of n 0-7, then of n 8-15;
//        with .trans, also a 16 x 16 A tile from its transpose, a [k][m] tile
//   bt:  B of n-tiles 0, 1 from a [k][n] tile (.trans): k 0-7, 8-15 of n 0-7, then of n 8-15
struct LdsmLane {
  int a_row, a_col, bn_row, bn_col, bt_row, bt_col;
  __device__ __forceinline__ explicit LdsmLane(int lane)
      : a_row(lane & 15), a_col((lane >> 4) << 3),
        bn_row((lane & 7) + ((lane >> 4) << 3)), bn_col(((lane >> 3) & 1) << 3),
        bt_row((lane & 7) + (((lane >> 3) & 1) << 3)), bt_col((lane >> 4) << 3) {}
};

// ---------------------------------------------------------------------------
// cp.async
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {  // bytes 16 or 0 (zero fill)
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(s), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, int bytes) {  // bytes 0..4, the rest zero
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(s), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }

__device__ __forceinline__ void cp_wait_all() { asm volatile("cp.async.wait_group 0;" ::: "memory"); }

// Rows row0 .. row0+rows-1 (columns 0 .. width-1) of a row-major (L, width)
// fp32 matrix into a shared tile of row stride ld; rows at or past L are
// zero-filled.  16-byte copies where width and the source allow (vec),
// else 4-byte ones.  The (row, chunk) walk advances by divmod(nthreads,
// chunks per row), computed once: no integer division per element.
__device__ __forceinline__ void copy_rows(float* dst, int ld, const float* src, int row0, int rows, int L, int width,
                                          bool vec, int tid, int nthreads) {
  const int cpr = vec ? width >> 2 : width;  // chunks per row
  const int total = rows * cpr;
  int r = tid / cpr, c = tid - r * cpr;
  const int dr = nthreads / cpr, dc = nthreads - dr * cpr;
  for (int i = tid; i < total; i += nthreads) {
    const int row = row0 + r;
    const bool in = row < L;
    const float* s = src + (size_t)(in ? row : 0) * width;
    if (vec)
      cp_async16(dst + r * ld + 4 * c, s + 4 * c, in ? 16 : 0);
    else
      cp_async4(dst + r * ld + c, s + c, in ? 4 : 0);
    r += dr;
    c += dc;
    if (c >= cpr) {
      c -= cpr;
      ++r;
    }
  }
}

// Rows row0 .. row0+rows-1 (columns 0 .. width-1) of a row-major (L, width)
// bf16 matrix into a shared tile of row stride ld (a multiple of 8), rows at
// or past L zero, for a ring.  Where vec (width % 8 == 0 and the matrix
// 16-byte aligned): 16-byte cp.async copies (zero-filled past L), which run
// during the math and land at the next cp_wait_all; the columns width ..
// padded-1 are not written, so the caller zeroes them once.  Else 2-byte
// plain loads and stores, so a matrix may start at any element, with the
// columns width .. padded-1 zero; the caller's next barrier makes them
// visible.
__device__ __forceinline__ void copy_rows_bf16(__nv_bfloat16* dst, int ld, const __nv_bfloat16* src, int row0,
                                               int rows, int L, int width, int padded, bool vec, int tid,
                                               int nthreads) {
  if (!vec) {
    for (int i = tid; i < rows * padded; i += nthreads) {
      const int r = i / padded, c = i - r * padded, row = row0 + r;
      dst[r * ld + c] = row < L && c < width ? src[(size_t)row * width + c] : __float2bfloat16(0.f);
    }
    return;
  }
  const int cpr = width >> 3;  // 8-element chunks per row
  const int total = rows * cpr;
  int r = tid / cpr, c = tid - r * cpr;
  const int dr = nthreads / cpr, dc = nthreads - dr * cpr;
  for (int i = tid; i < total; i += nthreads) {
    const int row = row0 + r;
    const bool in = row < L;
    cp_async16(dst + r * ld + 8 * c, src + (size_t)(in ? row : 0) * width + 8 * c, in ? 16 : 0);
    r += dr;
    c += dc;
    if (c >= cpr) {
      c -= cpr;
      ++r;
    }
  }
}

// Four consecutive floats added to global memory in one vector reduction
// (addr 16-byte aligned)
__device__ __forceinline__ void red_add_v4(float* addr, float x, float y, float z, float w) {
  asm volatile("red.global.add.v4.f32 [%0], {%1, %2, %3, %4};" ::"l"(addr), "f"(x), "f"(y), "f"(z), "f"(w) : "memory");
}

// Rows row0 .. row0+rows-1, columns col0 .. col0+cols-1 (cols a multiple
// of 16 / sizeof(T)) of a row-major (L, L) matrix of T (float or bf16) into
// a shared tile of row stride ld, for a causal reader: a chunk at or past L
// in either dimension, or wholly above its row's diagonal (its first column
// past the row), is zero-filled and not read.  16-byte chunks (4 floats or
// 8 bf16) where vec (L a multiple of the chunk and the matrix 16-byte
// aligned, so that a chunk lies wholly inside or wholly past L), else
// 4-byte ones (one float, or two bf16 where pairs: L even and the matrix
// 4-byte aligned), else (bf16 only) plain 2-byte loads and stores, which
// the caller's next barrier makes visible.  The walk is copy_rows's.
template <typename T>
__device__ __forceinline__ void copy_causal_tile(T* dst, int ld, const T* src, int row0, int rows, int col0, int cols,
                                                 int L, bool vec, int tid, int nthreads, bool pairs = true) {
  static_assert(sizeof(T) == 4 || sizeof(T) == 2, "float or bf16");
  const int w = vec ? 16 / (int)sizeof(T) : (pairs ? 4 / (int)sizeof(T) : 1);  // elements per chunk
  const int cpr = cols / w;  // chunks per row
  const int total = rows * cpr;
  int r = tid / cpr, c = tid - r * cpr;
  const int dr = nthreads / cpr, dc = nthreads - dr * cpr;
  for (int i = tid; i < total; i += nthreads) {
    const int row = row0 + r, col = col0 + w * c;
    const bool in = row < L && col <= row;  // col <= row < L
    const T* s = src + (in ? (size_t)row * L + col : 0);
    if (vec)
      cp_async16(dst + r * ld + w * c, s, in ? 16 : 0);
    else if (pairs)
      cp_async4(dst + r * ld + w * c, s, in ? 4 : 0);
    else if constexpr (sizeof(T) == 2)
      dst[r * ld + c] = in ? *s : __float2bfloat16(0.f);
    r += dr;
    c += dc;
    if (c >= cpr) {
      c -= cpr;
      ++r;
    }
  }
}

// int32 stamps ts[b, row0 .. row0+rows-1] (zero at or past L)
__device__ __forceinline__ void copy_stamps(int* dst, const int* ts_row, int row0, int rows, int L, int tid) {
  if (tid < rows) {
    const bool in = row0 + tid < L;
    cp_async4(dst + tid, ts_row + (in ? row0 + tid : 0), in ? 4 : 0);
  }
}

// The mask bytes mask[idx .. idx+rows-1] (rows a multiple of 4) of an n-byte
// mask, as the aligned 4-byte words that hold them.  The words are found
// from the bytes' real address, so the mask need not start at a word (a
// view such as mask[1:]); the bytes of the first word before the mask are
// read and never used, and those past its end are zero-filled.  Byte c of
// the tile is ((const uint8_t*)dst)[mask_offset(mask, idx) + c].
__device__ __forceinline__ int mask_offset(const uint8_t* mask, size_t idx) {
  return (int)(reinterpret_cast<uintptr_t>(mask + idx) & 3);
}

__device__ __forceinline__ void copy_mask(int* dst, const uint8_t* mask, size_t n, size_t idx, int rows, int tid) {
  const uintptr_t first = reinterpret_cast<uintptr_t>(mask + idx) & ~(uintptr_t)3;
  const uintptr_t end = reinterpret_cast<uintptr_t>(mask + n);
  const int words = (rows >> 2) + 1;
  if (tid < words) {
    const uintptr_t w = first + 4 * (uintptr_t)tid;
    const int bytes = w + 4 <= end ? 4 : (w < end ? (int)(end - w) : 0);
    cp_async4(dst + tid, reinterpret_cast<const void*>(bytes > 0 ? w : first), bytes);
  }
}

// ---------------------------------------------------------------------------
// The time bucket, exact in O(1)
// ---------------------------------------------------------------------------

struct Buckets {
  int nb;         // num_buckets
  int fn_log;     // 0: sqrt, 1: log
  int minutes;    // 1: |dt| / 60 first
  float divisor;
};

// bucket(t_l - t_m) = the largest u with thr[u] <= |t_l - t_m|, thr the
// host's exact integer thresholds (compute_bucket_thresholds).  The int32
// difference wraps, as the reference's int32 subtraction does; its
// magnitude, up to 2^31, is clamped to 2^31 - 2, which has the same f32
// value (so the same bucket) and lies below the int32-max sentinel of the
// unreachable buckets.  A guess from the steps of bucketize_time (|dt|,
// minutes, clamp at 1e-6, sqrt or log, divisor, clamp to [0, nb]; here
// with reciprocals and the fast intrinsics, a guess need not round as the
// reference does) is then moved to the exact bucket against the
// thresholds: one or two shared loads, whatever the guess's rounding.
struct Lookup {
  const int* thr;  // shared copy of the thresholds
  int nb, fn_log;
  float scale;     // 1/60 for minutes, else 1
  float inv_div;   // 1 / divisor
  __device__ __forceinline__ Lookup(const int* th, const Buckets& c)
      : thr(th), nb(c.nb), fn_log(c.fn_log), scale(c.minutes ? 1.f / 60.f : 1.f), inv_div(1.f / c.divisor) {}

  __device__ __forceinline__ int operator()(int tl, int tm) const {
    const int dt = (int)((unsigned)tl - (unsigned)tm);
    const unsigned mag = dt < 0 ? 0u - (unsigned)dt : (unsigned)dt;
    const int a = (int)min(mag, (unsigned)(kIntMax - 1));
    float x = fmaxf((float)a * scale, 1e-6f);
    x = (fn_log ? __logf(x) : x * rsqrtf(x)) * inv_div;
    int u = (int)fminf(fmaxf(x, 0.f), (float)nb);
    while (u < nb && thr[u + 1] <= a) ++u;
    while (thr[u] > a) --u;  // thr[0] = 0
    return u;
  }
};

// ---------------------------------------------------------------------------
// Table gradients of a warp's 16 x 16 fragment pair (the backward kernels),
// summed in a fixed order: no float atomic adds into dpos or dts, so both are
// the same bit for bit from run to run.  Within a CTA, where the sums fit:
// each warp adds into its own (a window of 31 distances a tile, a dts table
// per warp or per warp and lane column), lanes that would add to one slot at
// once taking turns in lane order; the tile's windows are added into the
// CTA's gpos in warp order; the dts tables in table order at the end.  Where
// they do not fit (long L, many buckets), one CTA-wide gpos and one dts
// table, which the warps add to one at a time in warp order, a tile at a
// time (wait_turn / pass_turn).  Across CTAs: each CTA writes its sums to a slice of
// its own, and reduce_tables adds the slices in CTA order into dpos and dts.
// ---------------------------------------------------------------------------

constexpr int kWinWarps = 8;      // warps of a backward CTA, each with a 32-float window
constexpr int kWin = 32;          // a window's floats: the 31 local distances -15 .. 15
constexpr int kPosSpan = 95;      // distances a 64 x 32 (K2) or 32 x 64 (K2a) tile spans

// dts of one warp's values (bucket -1: none) into its table gts (this
// lane's copy; copy: which copy it is, 0 .. 3, where the lanes of a warp
// hold different copies, else 0).  All the warp's values on one bucket: one
// butterfly sum, added by lane 0.  Else each lane folds its runs of equal
// buckets, and a run is added where it ends; the lanes that end a run on
// one slot at the same step add theirs one after another in lane order, a
// __syncwarp apart.  Warp-collective.
template <int NVAL>
__device__ __forceinline__ void add_ts_grads(float* gts, int copy, const float* ds, const int* bk) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  int lo = kIntMax, hi = -1;
#pragma unroll
  for (int i = 0; i < NVAL; ++i)
    if (bk[i] >= 0) {
      lo = min(lo, bk[i]);
      hi = max(hi, bk[i]);
    }
  const int wlo = __reduce_min_sync(full, lo), whi = __reduce_max_sync(full, hi);
  if (whi < 0) return;
  if (wlo == whi) {
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < NVAL; ++i) sum += bk[i] >= 0 ? ds[i] : 0.f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(full, sum, off);
    if (lane == 0) gts[whi] += sum;
    __syncwarp();
    return;
  }
  const unsigned below = (1u << lane) - 1u;
  int cur = -1;
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i <= NVAL; ++i) {
    const int u = i < NVAL ? bk[i] : -1;
    const bool close = cur >= 0 && (i == NVAL || (u >= 0 && u != cur));
    const int key = close ? (cur << 2) | copy : -1;
    if (__any_sync(full, close)) {
      const unsigned peers = __match_any_sync(full, key);
      const int rank = __popc(peers & below);
      const int turns = __reduce_max_sync(full, close ? __popc(peers) : 0);
      for (int r = 0; r < turns; ++r) {
        if (close && rank == r) gts[cur] += acc;
        __syncwarp();
      }
    }
    if (close) {
      cur = -1;
      acc = 0.f;
    }
    if (u >= 0) {
      cur = u;
      acc += ds[i];
    }
  }
}

// dpos of one warp's 16 x 16 fragment pair into out: its window (base 15,
// n kWin) or the CTA's gpos (base: the fragment's causal distance, n: the
// distances the tile can see).  part[n][j] holds the lane's values at local
// causal distance 8 (n - 1) + kSign (2t - g + j) (kSign: +1 where the
// fragment is keys x queries, K2; -1 where it is rows x keys, K2a), in
// -15 .. 15; lanes (t, g), (t+1, g+2), (t+2, g+4), (t+3, g+6) hold the same
// distances, so they sum along that chain by shuffles and the chain's head
// adds the sum at out[base + its local distance] where that lies in
// [0, n).  The heads of one (n, j) hold distinct distances; the six (n, j)
// add a __syncwarp apart.  Warp-collective.
template <int kSign>
__device__ __forceinline__ void add_pos_grads(float* out, int base, int n_out, float part[3][2], int g, int t) {
  const unsigned full = 0xffffffffu;
  const bool step1 = t <= 2 && g <= 5, step2 = t <= 1 && g <= 3;
#pragma unroll
  for (int n = 0; n < 3; ++n)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float v = part[n][j];
      const float v1 = __shfl_down_sync(full, v, 9);
      v += step1 ? v1 : 0.f;
      const float v2 = __shfl_down_sync(full, v, 18);
      v += step2 ? v2 : 0.f;
      part[n][j] = v;
    }
  const bool head = t == 0 || g < 2;
#pragma unroll
  for (int n = 0; n < 3; ++n)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int d = base + 8 * (n - 1) + kSign * (2 * t - g + j);
      if (head && d >= 0 && d < n_out) out[d] += part[n][j];
      __syncwarp();
    }
}

// Where a CTA's warps share one gpos and one dts table (turns): each
// warp's adds of a tile between wait_turn and pass_turn, one warp at a time
// in warp order.  Warp w's wait returns once warp w - 1 has passed (named
// barrier w of two warps: the arrive releases warp w - 1's shared stores,
// the sync acquires them).  Every warp of the CTA calls both once a tile,
// between the same two CTA barriers; the non-aligned forms, as warps call
// them from different branches.
__device__ __forceinline__ void wait_turn(bool turns, int warp) {
  if (turns && warp > 0) asm volatile("barrier.sync %0, 64;" ::"r"(warp) : "memory");
}

__device__ __forceinline__ void pass_turn(bool turns, int warp) {
  if (turns && warp + 1 < kWinWarps) asm volatile("barrier.arrive %0, 64;" ::"r"(warp + 1) : "memory");
}

// A tile's windows into the CTA's gpos: thread r < kPosSpan adds, in warp
// order, the window slots that hold distance start + r (warp w's slot
// r - off(w)), zeroes them, and adds their sum to gpos[start + r] when that
// lies in [0, n_dist).  Call between barriers: after every warp's adds of
// the tile, before any warp's adds into the same windows.
template <typename Off>
__device__ __forceinline__ void flush_pos_windows(float* gpos, float* win, int start, int n_dist, Off off) {
  const int r = threadIdx.x;
  if (r < kPosSpan) {
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kWinWarps; ++w) {
      const int x = r - off(w);
      if (x >= 0 && x < kWin - 1) {
        sum += win[w * kWin + x];
        win[w * kWin + x] = 0.f;
      }
    }
    const int d = start + r;
    if (d >= 0 && d < n_dist) gpos[d] += sum;
  }
}

// The CTA's sums into its slice of the scratch buffer, (L + nb + 1) floats:
// gpos by distance 0 .. L-1 (zero from n_dist on), then dts, its tables
// added in table order (not written without stamps).
__device__ __forceinline__ void write_table_slice(float* slice, const float* gpos, const float* gts, int n_dist, int L,
                                                  int tables, int nb, int nb4, bool has_time, int nthreads) {
  for (int d = threadIdx.x; d < L; d += nthreads) slice[d] = d < n_dist ? gpos[d] : 0.f;
  if (has_time)
    for (int u = threadIdx.x; u <= nb; u += nthreads) {
      float sum = 0.f;
      for (int w = 0; w < tables; ++w) sum += gts[w * nb4 + u];
      slice[L + u] = sum;
    }
}

// dpos[max_seq_len-1-d, h] and dts[u, h] as the sums of the slices of head
// h, batch by batch and CTA by CTA in order (slices per (b, h)): one thread
// a slot, writing it (the rows of dpos past L are the caller's zeros).
__global__ void reduce_table_slices(const float* scratch, int slices, int B, int H, int L, int nb, int max_seq_len,
                                    int has_time, float* dpos, float* dts) {
  const int stride = L + nb + 1;
  const int h = blockIdx.y, slot = blockIdx.x * blockDim.x + threadIdx.x;
  if (slot >= (has_time ? stride : L)) return;
  float sum = 0.f;
  for (int b = 0; b < B; ++b) {
    const float* p = scratch + (size_t)(b * H + h) * slices * stride + slot;
#pragma unroll 4
    for (int y = 0; y < slices; ++y) sum += p[(size_t)y * stride];
  }
  if (slot < L)
    dpos[(size_t)(max_seq_len - 1 - slot) * H + h] = sum;
  else
    dts[(size_t)(slot - L) * H + h] = sum;
}

inline cudaError_t reduce_tables(const float* scratch, int slices, int B, int H, int L, int nb, int max_seq_len,
                                 bool has_time, float* dpos, float* dts, cudaStream_t stream) {
  const int slots = has_time ? L + nb + 1 : L;
  reduce_table_slices<<<dim3((slots + 127) / 128, H), 128, 0, stream>>>(scratch, slices, B, H, L, nb, max_seq_len,
                                                                        has_time, dpos, dts);
  return cudaGetLastError();
}

}  // namespace rab
