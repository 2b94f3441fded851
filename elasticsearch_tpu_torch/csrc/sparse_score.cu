// sparse_score: fused quantized sparse scoring for Hopper (sm_90a).
//
// Replaces the TPU kernel elasticsearch_tpu/ops/pallas_kernels.py
// _sparse_score_kernel (reached through sparse_score / _sparse_score_call).
// It computes what that kernel computes, not how it is blocked: the Pallas
// kernel keeps a query's whole candidate accumulator in VMEM (P*12 bytes, up
// to 768 KB at TB = 512), which is more than the 227 KB of shared memory a
// Hopper block can use. Here one thread block owns one query row and a loop
// inside the block stands in for the TPU grid's sequential TB axis; the
// candidates live in a global scratch [Qb, P] that the wrapper allocates
// (the kernel allocates nothing). For each query row the block
//
//   1. decodes its P = TB*128 candidate slots: reads the qblk-selected block
//      row (doc, tf, norm byte), decodes the norm byte through the clause
//      field's 256-entry LUT, computes tfn = tf/(tf+cv) (BM25) or
//      sqrt(tf)*cv (TF-IDF), contrib = w*(const ? 1 : tfn) zeroed where
//      doc >= doc_pad, and the packed should/must/must_not counter;
//   2. bitonic-sorts the 64-bit keys (doc << 32 | slot): the slot makes the
//      order total, so the sort equals a STABLE sort by doc, which the
//      segment-sum order depends on;
//   3. runs exactly `passes` Hillis-Steele doubling steps on contrib and
//      counter (v[i] + (same doc ? v[i-shift] : 0)), double-buffered — the
//      plain version's summation order, so sums match bit for bit;
//   4. applies the bool semantics at each run's last element, the optional
//      coord factor, and counts the matches;
//   5. selects the top k by k rounds of block argmax, ties to the lowest
//      index (jax.lax.top_k's rule).
//
// Arithmetic: IEEE round-to-nearest division and square root (__fdiv_rn,
// __fsqrt_rn), no FMA contraction (built with -fmad=false): bitwise equal to
// the plain torch version in ops/sparse_kernels.py.
//
// Bound on an H100 (3.35 TB/s HBM): the work is a streaming read of the
// touched postings, TB*128*(4 + tf_bytes + 1) bytes per query row, plus the
// [Qb, TB] clause arrays, the LUTs and the [Qb, k] outputs; the arithmetic is
// a few flops per posting, far below the fp32 rate, so the bound is bytes.
// This first version is simple and right rather than fast: the sort and the
// top-k rounds run over a global-memory scratch (mostly L2-resident), not
// over shared memory.

#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kBlock = 128;     // postings per block row
constexpr int kThreads = 1024;  // threads per query row
constexpr int kTfnBm25 = 0;
constexpr int kMustShift = 10;
constexpr int kNotShift = 20;
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float load_tf(const void* tf, int tf_kind, int64_t i) {
  if (tf_kind == 0) return static_cast<float>(static_cast<const uint8_t*>(tf)[i]);
  if (tf_kind == 1) return static_cast<float>(static_cast<const int16_t*>(tf)[i]);
  return static_cast<const float*>(tf)[i];
}

// (value desc, index asc) order: true when (va, ia) ranks before (vb, ib)
__device__ __forceinline__ bool ranks_before(float va, int ia, float vb, int ib) {
  return va > vb || (va == vb && ia < ib);
}

__device__ __forceinline__ unsigned key_doc(unsigned long long key) {
  return static_cast<unsigned>(key >> 32);
}

__global__ void __launch_bounds__(kThreads) sparse_score_kernel(
    const int32_t* __restrict__ qblk, const float* __restrict__ qw,
    const uint8_t* __restrict__ qconst, const int32_t* __restrict__ qcnt,
    const int32_t* __restrict__ qfid, const int32_t* __restrict__ qmode,
    const int32_t* __restrict__ n_must, const int32_t* __restrict__ msm,
    const float* __restrict__ coord, int C1,
    const int32_t* __restrict__ blk_docs, const void* __restrict__ blk_tf,
    int tf_kind, const uint8_t* __restrict__ blk_nb,
    const float* __restrict__ caches,
    int TB, int k, int doc_pad, int passes, int simple, int use_coord,
    unsigned long long* __restrict__ keys_all, float* __restrict__ cbuf,
    int32_t* __restrict__ nbuf,
    float* __restrict__ out_scores, int32_t* __restrict__ out_docs,
    int32_t* __restrict__ out_totals) {
  const int q = blockIdx.x;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int P = TB * kBlock;
  const int64_t plane = static_cast<int64_t>(gridDim.x) * P;
  const int64_t base = static_cast<int64_t>(q) * P;
  unsigned long long* keys = keys_all + base;
  float* cA = cbuf + base;           // candidates in sorted order, then ping
  float* cB = cbuf + plane + base;   // candidates by slot, then pong
  int32_t* nA = simple ? nullptr : nbuf + base;
  int32_t* nB = simple ? nullptr : nbuf + plane + base;

  // 1. decode: slot s = t*128 + lane holds lane `lane` of block row qblk[q, t]
  for (int s = tid; s < P; s += nthreads) {
    const int qt = q * TB + (s >> 7);
    const int64_t off = static_cast<int64_t>(qblk[qt]) * kBlock + (s & (kBlock - 1));
    const int doc = blk_docs[off];
    const float tf = load_tf(blk_tf, tf_kind, off);
    const float cv = caches[qfid[qt] * 256 + blk_nb[off]];
    const float tfn = (qmode[qt] == kTfnBm25)
                          ? __fdiv_rn(tf, __fadd_rn(tf, cv))
                          : __fmul_rn(__fsqrt_rn(tf), cv);
    const float contrib = __fmul_rn(qw[qt], qconst[qt] ? 1.0f : tfn);
    const bool valid = doc < doc_pad;
    cB[s] = valid ? contrib : 0.0f;
    if (!simple) nB[s] = valid ? qcnt[qt] : 0;
    keys[s] = (static_cast<unsigned long long>(static_cast<unsigned>(doc)) << 32) |
              static_cast<unsigned>(s);
  }
  __syncthreads();

  // 2. bitonic sort of the keys, ascending (P is a power of two)
  for (int size = 2; size <= P; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = tid; i < (P >> 1); i += nthreads) {
        const int lo = ((i & ~(stride - 1)) << 1) | (i & (stride - 1));
        const int hi = lo + stride;
        const bool up = (lo & size) == 0;
        const unsigned long long a = keys[lo];
        const unsigned long long b = keys[hi];
        if ((a > b) == up) {
          keys[lo] = b;
          keys[hi] = a;
        }
      }
      __syncthreads();
    }
  }

  // gather the payloads into sorted order
  for (int i = tid; i < P; i += nthreads) {
    const unsigned slot = static_cast<unsigned>(keys[i] & 0xffffffffull);
    cA[i] = cB[slot];
    if (!simple) nA[i] = nB[slot];
  }
  __syncthreads();

  // 3. `passes` doubling segment-sum steps; a run's sum lands on its last element
  float* cin = cA;
  float* cout = cB;
  int32_t* nin = nA;
  int32_t* nout = nB;
  for (int p = 0; p < passes; ++p) {
    const int shift = 1 << p;
    for (int i = tid; i < P; i += nthreads) {
      const bool same = i >= shift && key_doc(keys[i]) == key_doc(keys[i - shift]);
      cout[i] = __fadd_rn(cin[i], same ? cin[i - shift] : 0.0f);
      if (!simple) nout[i] = nin[i] + (same ? nin[i - shift] : 0);
    }
    __syncthreads();
    float* ct = cin; cin = cout; cout = ct;
    int32_t* nt = nin; nin = nout; nout = nt;
  }

  // 4. bool semantics at run ends; masked scores in place, match count
  int my_matches = 0;
  for (int i = tid; i < P; i += nthreads) {
    const unsigned doc = key_doc(keys[i]);
    const bool last = (i == P - 1) || doc != key_doc(keys[i + 1]);
    float c = cin[i];
    bool match;
    if (simple) {
      match = last && doc < static_cast<unsigned>(doc_pad) && c > 0.0f;
    } else {
      const int n = nin[i];
      const int m_should = n & 0x3FF;
      const int m_must = (n >> kMustShift) & 0x3FF;
      const int m_not = n >> kNotShift;
      match = last && doc < static_cast<unsigned>(doc_pad) && m_must == n_must[q] &&
              m_should >= msm[q] && m_not == 0 && (m_should + m_must) > 0;
      if (use_coord) {
        c = __fmul_rn(c, coord[q * C1 + min(m_should + m_must, C1 - 1)]);
      }
    }
    cin[i] = match ? c : -CUDART_INF_F;
    my_matches += match ? 1 : 0;
  }

  __shared__ int s_count[kThreads / 32];
  __shared__ float s_val[kThreads / 32];
  __shared__ int s_idx[kThreads / 32];
  __shared__ float s_win_val;
  __shared__ int s_win_idx;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = nthreads >> 5;

  for (int o = 16; o > 0; o >>= 1) my_matches += __shfl_down_sync(kFullMask, my_matches, o);
  if (lane == 0) s_count[warp] = my_matches;
  __syncthreads();  // also publishes the masked scores of step 4
  if (tid == 0) {
    int total = 0;
    for (int w = 0; w < nwarps; ++w) total += s_count[w];
    out_totals[q] = total;
  }

  // 5. top-k: round r picks the best element ranked after round r-1's winner
  float prev_v = CUDART_INF_F;
  int prev_i = -1;  // (+inf, -1) ranks before every element
  for (int r = 0; r < k; ++r) {
    float bv = -CUDART_INF_F;
    int bi = 0x7fffffff;  // ranks after every element
    for (int i = tid; i < P; i += nthreads) {
      const float v = cin[i];
      if (ranks_before(prev_v, prev_i, v, i) && ranks_before(v, i, bv, bi)) {
        bv = v;
        bi = i;
      }
    }
    for (int o = 16; o > 0; o >>= 1) {
      const float ov = __shfl_down_sync(kFullMask, bv, o);
      const int oi = __shfl_down_sync(kFullMask, bi, o);
      if (ranks_before(ov, oi, bv, bi)) {
        bv = ov;
        bi = oi;
      }
    }
    if (lane == 0) {
      s_val[warp] = bv;
      s_idx[warp] = bi;
    }
    __syncthreads();
    if (warp == 0) {
      bv = lane < nwarps ? s_val[lane] : -CUDART_INF_F;
      bi = lane < nwarps ? s_idx[lane] : 0x7fffffff;
      for (int o = 16; o > 0; o >>= 1) {
        const float ov = __shfl_down_sync(kFullMask, bv, o);
        const int oi = __shfl_down_sync(kFullMask, bi, o);
        if (ranks_before(ov, oi, bv, bi)) {
          bv = ov;
          bi = oi;
        }
      }
      if (lane == 0) {
        s_win_val = bv;
        s_win_idx = bi;
        out_scores[static_cast<int64_t>(q) * k + r] = bv;
        // bi < P always holds for k <= P unless a score is NaN, which ranks
        // nowhere; its slot then reports the sentinel doc
        out_docs[static_cast<int64_t>(q) * k + r] =
            bi < P ? static_cast<int32_t>(key_doc(keys[bi])) : doc_pad;
      }
    }
    __syncthreads();
    prev_v = s_win_val;
    prev_i = s_win_idx;
  }
}

}  // namespace

extern "C" int sparse_score_launch(
    const void* qblk, const void* qw, const void* qconst, const void* qcnt,
    const void* qfid, const void* qmode, const void* n_must, const void* msm,
    const void* coord, int C1,
    const void* blk_docs, const void* blk_tf, int tf_kind, const void* blk_nb,
    const void* caches,
    int Qb, int TB, int k, int doc_pad, int passes, int simple, int use_coord,
    void* keys, void* cbuf, void* nbuf,
    void* out_scores, void* out_docs, void* out_totals, void* stream) {
  sparse_score_kernel<<<Qb, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(qblk), static_cast<const float*>(qw),
      static_cast<const uint8_t*>(qconst), static_cast<const int32_t*>(qcnt),
      static_cast<const int32_t*>(qfid), static_cast<const int32_t*>(qmode),
      static_cast<const int32_t*>(n_must), static_cast<const int32_t*>(msm),
      static_cast<const float*>(coord), C1,
      static_cast<const int32_t*>(blk_docs), blk_tf, tf_kind,
      static_cast<const uint8_t*>(blk_nb), static_cast<const float*>(caches),
      TB, k, doc_pad, passes, simple, use_coord,
      static_cast<unsigned long long*>(keys), static_cast<float*>(cbuf),
      static_cast<int32_t*>(nbuf),
      static_cast<float*>(out_scores), static_cast<int32_t*>(out_docs),
      static_cast<int32_t*>(out_totals));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* sparse_score_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
