// Building blocks shared by the attention kernels (hstu_rab_fwd.cu,
// hstu_rab_bwd.cu, hstu_attn_fwd.cu): 3xTF32 tensor-core products with
// mma.sync, cp.async tile copies, and the exact O(1) time-bucket lookup.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace rab {

constexpr int kIntMax = 2147483647;
constexpr size_t kMaxSmem = 232448;  // per-block dynamic shared memory limit on sm_90

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

// Rows row0 .. row0+rows-1, columns col0 .. col0+cols-1 (cols a multiple
// of 4) of a row-major (L, L) fp32 matrix into a shared tile of row stride
// ld, for a causal reader: a chunk at or past L in either dimension, or
// wholly above its row's diagonal (its first column past the row), is
// zero-filled and not read.  16-byte chunks where vec (L % 4 == 0 and the
// matrix 16-byte aligned, so that a chunk lies wholly inside or wholly
// past L), else 4-byte ones.  The walk is copy_rows's.
__device__ __forceinline__ void copy_causal_tile(float* dst, int ld, const float* src, int row0, int rows, int col0,
                                                 int cols, int L, bool vec, int tid, int nthreads) {
  const int w = vec ? 4 : 1;  // floats per chunk
  const int cpr = cols / w;   // chunks per row
  const int total = rows * cpr;
  int r = tid / cpr, c = tid - r * cpr;
  const int dr = nthreads / cpr, dc = nthreads - dr * cpr;
  for (int i = tid; i < total; i += nthreads) {
    const int row = row0 + r, col = col0 + w * c;
    const bool in = row < L && col <= row;  // col <= row < L
    const float* s = src + (in ? (size_t)row * L + col : 0);
    if (vec)
      cp_async16(dst + r * ld + 4 * c, s, in ? 16 : 0);
    else
      cp_async4(dst + r * ld + c, s, in ? 4 : 0);
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

}  // namespace rab
