// sparse_score: fused quantized sparse scoring for Hopper (sm_90a).
//
// Replaces the TPU kernel elasticsearch_tpu/ops/pallas_kernels.py
// _sparse_score_kernel (reached through sparse_score / _sparse_score_call).
// It computes what that kernel computes, not how it is blocked: the Pallas
// kernel keeps a query's whole candidate accumulator in VMEM (P*12 bytes, up
// to 768 KB at TB = 512). Here one thread block owns one query row of
// P = TB*128 candidate slots, and a loop inside the block stands in for the
// TPU grid's sequential TB axis. For each query row the block
//
//   1. decodes its P candidate slots: reads the qblk-selected block row (doc,
//      tf, norm byte), decodes the norm byte through the clause field's
//      256-entry LUT, computes tfn = tf/(tf+cv) (BM25) or sqrt(tf)*cv
//      (TF-IDF), contrib = w*(const ? 1 : tfn) zeroed where doc >= doc_pad,
//      and the packed should/must/must_not counter;
//   2. bitonic-sorts the 64-bit keys (doc << 32 | slot) ascending: the slot
//      makes the order total, so the sort equals a STABLE sort by doc, which
//      the segment-sum order depends on;
//   3. gathers the payloads into sorted order and runs exactly `passes`
//      Hillis-Steele doubling steps on contrib and counter (v[i] + (same doc ?
//      v[i-shift] : 0)), double-buffered — the plain version's summation
//      order, so sums match bit for bit;
//   4. applies the bool semantics at each run's last element, the optional
//      coord factor, and counts the matches;
//   5. takes the top k by a SECOND sort with the same bitonic network, run
//      descending, over the plain version's own top-k keys (ordered float
//      image of the masked score << 32 | 0xFFFFFFFF - index; see
//      top_k_lowest_index): the first k keys are the winners, ties to the
//      lowest index, -inf fill in ascending index order, a positive NaN
//      first — equal to the plain version by construction. Each winner's doc
//      is read from the doc-sorted keys, which stay intact.
//
// Two variants; ops/sparse_kernels.py `_launch_plan` picks one per launch
// and hands the kernel its thread count and shared bytes:
//
//   smem    P <= 8192 (TB <= 64): the whole reduction in dynamic shared
//           memory, no global scratch. Keys 8P bytes, contributions ping/pong
//           8P, counters ping/pong 8P (not for a simple query): 192 KB at
//           P = 8192 (128 KB simple), under the 232,448 bytes a block may
//           use. The score keys of step 5 overlay the contributions once
//           step 4 has read them. Templated on P and the thread count,
//           min(1024, P/2), so small rungs keep several blocks on each SM and
//           the stage loops have compile-time bounds.
//   global  P >= 16384 (TB >= 128): 1024 threads, candidates in a global
//           scratch [Qb, P] the wrapper allocates (the kernel allocates
//           nothing), both sorts TILED: each 8192-key tile is sorted fully in
//           a 64 KB shared tile, then each larger merge size runs its strides
//           >= 8192 over global memory and all smaller strides in one
//           shared-memory pass per tile. At P = 65,536 that is about 14
//           passes over the keys per sort instead of 136. The segment-sum
//           steps stay in global memory. With one block per query, a rung
//           of few long queries (32 x 512) keeps only as many SMs busy as it
//           has queries, and each block's sorts are bound by the instruction
//           rate of its one SM.
//
// Arithmetic: IEEE round-to-nearest division and square root (__fdiv_rn,
// __fsqrt_rn), no FMA contraction (built with -fmad=false): bitwise equal to
// the plain torch version in ops/sparse_kernels.py.
//
// Bound on an H100 (3.35 TB/s HBM): the work is a streaming read of the
// touched postings, TB*128*(4 + tf_bytes + 1) bytes per query row, plus the
// [Qb, TB] clause arrays, the LUTs and the [Qb, k] outputs; the arithmetic is
// a few flops per posting, far below the fp32 rate, so the bound is bytes.
// What holds the kernel above it is the two sorts: O(P log^2 P)
// compare-exchanges. Each sort runs the bitonic network stage for stage, but
// on keys held in registers (thread tid holds elements e*T + tid): strides
// >= T inside a thread, strides < 32 inside a warp by shuffles, and only the
// strides between take shared memory and a block barrier each (30 of the 91
// stages at 8192 keys).

#include <cstdint>
#include <mutex>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

typedef unsigned long long u64;

constexpr int kBlock = 128;         // postings per block row
constexpr int kTile = 8192;         // keys per shared tile of the global variant
constexpr int kGlobalThreads = 1024;
constexpr int kMaxDevices = 64;
constexpr int kTfnBm25 = 0;
constexpr int kMustShift = 10;
constexpr int kNotShift = 20;
constexpr unsigned kFullMask = 0xffffffffu;

struct Params {
  const int32_t* qblk;
  const float* qw;
  const uint8_t* qconst;
  const int32_t* qcnt;
  const int32_t* qfid;
  const int32_t* qmode;
  const int32_t* n_must;
  const int32_t* msm;
  const float* coord;
  int C1;
  const int32_t* blk_docs;
  const void* blk_tf;
  int tf_kind;
  const uint8_t* blk_nb;
  const float* caches;
  int TB, k, doc_pad, passes, simple, use_coord;
  u64* keys;    // global variant: [Qb, P] doc keys
  u64* skeys;   // global variant: [Qb, P] score keys
  float* cbuf;  // global variant: [2, Qb, P] contributions
  int32_t* nbuf;  // global variant, not simple: [2, Qb, P] counters
  float* out_scores;
  int32_t* out_docs;
  int32_t* out_totals;
};

// the inputs are read-only for the whole launch: read through the read-only
// path (__ldg), which also lets a thread's decode loads overlap
__device__ __forceinline__ float load_tf(const void* tf, int tf_kind, int64_t i) {
  if (tf_kind == 0) return static_cast<float>(__ldg(static_cast<const uint8_t*>(tf) + i));
  if (tf_kind == 1) return static_cast<float>(__ldg(static_cast<const int16_t*>(tf) + i));
  return __ldg(static_cast<const float*>(tf) + i);
}

__device__ __forceinline__ unsigned key_doc(u64 key) {
  return static_cast<unsigned>(key >> 32);
}

// step 1 for slot s of query row q: the doc key, the contribution and the
// counter (0 on an invalid slot)
__device__ __forceinline__ void decode_slot(const Params& p, int q, int s, u64& key,
                                            float& contrib, int& cnt) {
  const int qt = q * p.TB + (s >> 7);
  const int64_t off = static_cast<int64_t>(__ldg(p.qblk + qt)) * kBlock + (s & (kBlock - 1));
  const int doc = __ldg(p.blk_docs + off);
  const float tf = load_tf(p.blk_tf, p.tf_kind, off);
  const float cv = __ldg(p.caches + __ldg(p.qfid + qt) * 256 + __ldg(p.blk_nb + off));
  const float tfn = (__ldg(p.qmode + qt) == kTfnBm25) ? __fdiv_rn(tf, __fadd_rn(tf, cv))
                                                      : __fmul_rn(__fsqrt_rn(tf), cv);
  const float c = __fmul_rn(__ldg(p.qw + qt), __ldg(p.qconst + qt) ? 1.0f : tfn);
  const bool valid = doc < p.doc_pad;
  contrib = valid ? c : 0.0f;
  cnt = valid ? __ldg(p.qcnt + qt) : 0;
  key = (static_cast<u64>(static_cast<unsigned>(doc)) << 32) | static_cast<unsigned>(s);
}

// step 4 at sorted position i: the masked score (-inf unless a match)
__device__ __forceinline__ float masked_score(const Params& p, int q, int P, int i,
                                              const u64* keys, float c, int n,
                                              bool& match) {
  const unsigned doc = key_doc(keys[i]);
  const bool last = (i == P - 1) || doc != key_doc(keys[i + 1]);
  if (p.simple) {
    match = last && doc < static_cast<unsigned>(p.doc_pad) && c > 0.0f;
  } else {
    const int m_should = n & 0x3FF;
    const int m_must = (n >> kMustShift) & 0x3FF;
    const int m_not = n >> kNotShift;
    match = last && doc < static_cast<unsigned>(p.doc_pad) && m_must == p.n_must[q] &&
            m_should >= p.msm[q] && m_not == 0 && (m_should + m_must) > 0;
    if (p.use_coord) c = __fmul_rn(c, p.coord[q * p.C1 + min(m_should + m_must, p.C1 - 1)]);
  }
  return match ? c : -CUDART_INF_F;
}

// The plain version's top-k key (top_k_lowest_index) as an unsigned 64-bit
// integer: the float's order-preserving int32 image in the high half (sign
// bit flipped, so unsigned order is the signed order), 0xFFFFFFFF - index in
// the low half. Keys are unique; descending key order is (score desc, index
// asc).
__device__ __forceinline__ u64 score_key(float v, int i) {
  const int bits = __float_as_int(v);
  const int ord = bits < 0 ? bits ^ 0x7FFFFFFF : bits;
  return (static_cast<u64>(static_cast<unsigned>(ord) ^ 0x80000000u) << 32) |
         (0xFFFFFFFFu - static_cast<unsigned>(i));
}

__device__ __forceinline__ float key_score(u64 key) {
  const int ord = static_cast<int>(static_cast<unsigned>(key >> 32) ^ 0x80000000u);
  return __int_as_float(ord < 0 ? ord ^ 0x7FFFFFFF : ord);
}

__device__ __forceinline__ int key_index(u64 key) {
  return static_cast<int>(0xFFFFFFFFu - static_cast<unsigned>(key & 0xffffffffull));
}

// The compare-exchange steps of one merge size of a bitonic sorting network,
// strides stride_hi down to stride_lo, over t[0, n), which holds elements
// [base, base + n) of the whole sequence (a pair's direction follows its
// index in the whole sequence). A block barrier after each stride.
template <bool kAscending>
__device__ __forceinline__ void bitonic_merge(u64* t, int n, int base, int size,
                                              int stride_hi, int stride_lo) {
  for (int stride = stride_hi; stride >= stride_lo; stride >>= 1) {
    for (int i = threadIdx.x; i < (n >> 1); i += blockDim.x) {
      const int lo = ((i & ~(stride - 1)) << 1) | (i & (stride - 1));
      const int hi = lo + stride;
      const bool up = (((base + lo) & size) == 0) == kAscending;
      const u64 a = t[lo];
      const u64 b = t[hi];
      if ((a > b) == up) {
        t[lo] = b;
        t[hi] = a;
      }
    }
    __syncthreads();
  }
}

// one compare-exchange on registers: (a, b) in ascending order when up
__device__ __forceinline__ void order_pair(u64& a, u64& b, bool up) {
  const u64 lo = a < b ? a : b;
  const u64 hi = a < b ? b : a;
  a = up ? lo : hi;
  b = up ? hi : lo;
}

// A block's share of the network over a tile t[0, n) held in registers:
// thread tid holds elements e*T + tid (e < E, T = n/E threads). For each
// merge size the strides run as in the plain network, high to low, each
// where its pairs meet: strides >= T inside a thread's registers, strides in
// [32, T) through shared memory (one store, a barrier per stride, one load),
// strides < 32 inside a warp by shuffles. Only the shared strides take block
// barriers: 30 of the 91 stages at n = 8192, 38 barriers with the stores.
template <bool kAscending, int E>
__device__ __forceinline__ void merge_regs(u64 (&r)[E], u64* t, int n, int base, int size,
                                           int stride_hi) {
  const int T = n / E;
  const int tid = threadIdx.x;
#pragma unroll
  for (int se = E / 2; se >= 1; se >>= 1) {
    if (se * T <= stride_hi) {
#pragma unroll
      for (int e = 0; e < E; ++e) {
        if ((e & se) == 0) {
          order_pair(r[e], r[e + se], (((base + e * T + tid) & size) == 0) == kAscending);
        }
      }
    }
  }
  int stride = min(stride_hi, T >> 1);
  if (stride >= 32) {
#pragma unroll
    for (int e = 0; e < E; ++e) t[e * T + tid] = r[e];
    __syncthreads();
    bitonic_merge<kAscending>(t, n, base, size, stride, 32);
#pragma unroll
    for (int e = 0; e < E; ++e) r[e] = t[e * T + tid];
    stride = 16;
  }
  for (; stride >= 1; stride >>= 1) {
    const bool lo = (tid & stride) == 0;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const bool up = (((base + e * T + tid) & size) == 0) == kAscending;
      const u64 other = __shfl_xor_sync(kFullMask, r[e], stride);
      const u64 mn = r[e] < other ? r[e] : other;
      const u64 mx = r[e] < other ? other : r[e];
      r[e] = (lo == up) ? mn : mx;
    }
  }
}

// every merge size 2..n of the network over the registers' tile
template <bool kAscending, int E>
__device__ __forceinline__ void sort_regs(u64 (&r)[E], u64* t, int n, int base) {
  for (int size = 2; size <= n; size <<= 1) {
    merge_regs<kAscending, E>(r, t, n, base, size, size >> 1);
  }
}

// the whole network over g[0, P) in global memory, P a multiple of kTile:
// each merge size's strides >= kTile over global memory, every stride below
// through one 8192-key tile at a time in registers and the shared tile
template <bool kAscending>
__device__ void tiled_sort(u64* g, int P, u64* tile) {
  constexpr int E = kTile / kGlobalThreads;
  const int tid = threadIdx.x;
  u64 r[E];
  for (int size = kTile; size <= P; size <<= 1) {
    if (size > kTile) bitonic_merge<kAscending>(g, P, 0, size, size >> 1, kTile);
    for (int t0 = 0; t0 < P; t0 += kTile) {
#pragma unroll
      for (int e = 0; e < E; ++e) r[e] = g[t0 + e * kGlobalThreads + tid];
      if (size == kTile) {
        sort_regs<kAscending, E>(r, tile, kTile, t0);
      } else {
        merge_regs<kAscending, E>(r, tile, kTile, t0, size, kTile >> 1);
      }
#pragma unroll
      for (int e = 0; e < E; ++e) g[t0 + e * kGlobalThreads + tid] = r[e];
      __syncthreads();
    }
  }
}

// block-wide sum into *total (zeroed before the first barrier of the kernel)
__device__ __forceinline__ void add_matches(int matches, int* total) {
  for (int o = 16; o > 0; o >>= 1) matches += __shfl_down_sync(kFullMask, matches, o);
  if ((threadIdx.x & 31) == 0) atomicAdd(total, matches);
}

// step 5's output: the first k score keys, each winner's doc from the
// doc-sorted keys
__device__ __forceinline__ void write_top_k(const Params& p, int q, const u64* skeys,
                                            const u64* keys) {
  for (int r = threadIdx.x; r < p.k; r += blockDim.x) {
    const u64 key = skeys[r];
    const int64_t o = static_cast<int64_t>(q) * p.k + r;
    p.out_scores[o] = key_score(key);
    p.out_docs[o] = static_cast<int32_t>(key_doc(keys[key_index(key)]));
  }
}

// ---------------------------------------------------------------------------
// smem variant: P <= 8192, everything in dynamic shared memory
// ---------------------------------------------------------------------------

template <int P, int T>
__global__ void __launch_bounds__(T) sparse_score_smem(const Params p) {
  static_assert(P % T == 0 && P / T <= 8, "thread count outside the plan");
  extern __shared__ __align__(16) unsigned char smem[];
  u64* keys = reinterpret_cast<u64*>(smem);
  float* cA = reinterpret_cast<float*>(smem + 8 * P);  // sorted order, then ping
  float* cB = cA + P;                                   // by slot, then pong
  int32_t* nA = reinterpret_cast<int32_t*>(smem + 16 * P);  // not simple only
  int32_t* nB = nA + P;
  u64* skeys = reinterpret_cast<u64*>(cA);  // step 5 overlays the contributions
  __shared__ int s_total;
  constexpr int E = P / T;  // keys per thread: slot e*T + tid
  u64 r[E];
  const int q = blockIdx.x;
  const int tid = threadIdx.x;
  const bool simple = p.simple;
  if (tid == 0) s_total = 0;

  // 1. decode, the keys straight into registers
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int s = e * T + tid;
    float c;
    int n;
    decode_slot(p, q, s, r[e], c, n);
    cB[s] = c;
    if (!simple) nB[s] = n;
  }

  // 2. sort by (doc, slot)
  sort_regs<true, E>(r, keys, P, 0);
#pragma unroll
  for (int e = 0; e < E; ++e) keys[e * T + tid] = r[e];
  __syncthreads();

  // 3. gather, `passes` segment-sum steps; a run's sum lands on its last element
  for (int i = tid; i < P; i += T) {
    const unsigned slot = static_cast<unsigned>(keys[i] & 0xffffffffull);
    cA[i] = cB[slot];
    if (!simple) nA[i] = nB[slot];
  }
  __syncthreads();
  float* cin = cA;
  float* cout = cB;
  int32_t* nin = nA;
  int32_t* nout = nB;
  for (int pass = 0; pass < p.passes; ++pass) {
    const int shift = 1 << pass;
    for (int i = tid; i < P; i += T) {
      const bool same = i >= shift && key_doc(keys[i]) == key_doc(keys[i - shift]);
      cout[i] = __fadd_rn(cin[i], same ? cin[i - shift] : 0.0f);
      if (!simple) nout[i] = nin[i] + (same ? nin[i - shift] : 0);
    }
    __syncthreads();
    float* ct = cin; cin = cout; cout = ct;
    int32_t* nt = nin; nin = nout; nout = nt;
  }

  // 4. bool semantics; the masked scores wait in registers until every
  // thread has read the contributions the score keys overwrite
  float m[E];
  int matches = 0;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int i = tid + e * T;
    bool match;
    m[e] = masked_score(p, q, P, i, keys, cin[i], simple ? 0 : nin[i], match);
    matches += match ? 1 : 0;
  }
  add_matches(matches, &s_total);
  __syncthreads();

  // 5. top-k: the same network, descending, over the score keys
#pragma unroll
  for (int e = 0; e < E; ++e) r[e] = score_key(m[e], tid + e * T);
  sort_regs<false, E>(r, skeys, P, 0);
#pragma unroll
  for (int e = 0; e < E; ++e) skeys[e * T + tid] = r[e];
  __syncthreads();
  write_top_k(p, q, skeys, keys);
  if (tid == 0) p.out_totals[q] = s_total;
}

// ---------------------------------------------------------------------------
// global variant: P >= 16384, global scratch, tiled sorts
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kGlobalThreads) sparse_score_global(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  u64* tile = reinterpret_cast<u64*>(smem);
  __shared__ int s_total;
  const int q = blockIdx.x;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const bool simple = p.simple;
  const int P = p.TB * kBlock;
  const int64_t plane = static_cast<int64_t>(gridDim.x) * P;
  const int64_t base = static_cast<int64_t>(q) * P;
  u64* keys = p.keys + base;
  u64* skeys = p.skeys + base;
  float* cA = p.cbuf + base;           // candidates in sorted order, then ping
  float* cB = p.cbuf + plane + base;   // candidates by slot, then pong
  int32_t* nA = simple ? nullptr : p.nbuf + base;
  int32_t* nB = simple ? nullptr : p.nbuf + plane + base;
  if (tid == 0) s_total = 0;

  // 1. decode
  for (int s = tid; s < P; s += nthreads) {
    u64 key;
    float c;
    int n;
    decode_slot(p, q, s, key, c, n);
    keys[s] = key;
    cB[s] = c;
    if (!simple) nB[s] = n;
  }
  __syncthreads();

  // 2. sort by (doc, slot)
  tiled_sort<true>(keys, P, tile);

  // 3. gather, `passes` segment-sum steps
  for (int i = tid; i < P; i += nthreads) {
    const unsigned slot = static_cast<unsigned>(keys[i] & 0xffffffffull);
    cA[i] = cB[slot];
    if (!simple) nA[i] = nB[slot];
  }
  __syncthreads();
  float* cin = cA;
  float* cout = cB;
  int32_t* nin = nA;
  int32_t* nout = nB;
  for (int pass = 0; pass < p.passes; ++pass) {
    const int shift = 1 << pass;
    for (int i = tid; i < P; i += nthreads) {
      const bool same = i >= shift && key_doc(keys[i]) == key_doc(keys[i - shift]);
      cout[i] = __fadd_rn(cin[i], same ? cin[i - shift] : 0.0f);
      if (!simple) nout[i] = nin[i] + (same ? nin[i - shift] : 0);
    }
    __syncthreads();
    float* ct = cin; cin = cout; cout = ct;
    int32_t* nt = nin; nin = nout; nout = nt;
  }

  // 4. bool semantics straight into the score keys (their own scratch)
  int matches = 0;
  for (int i = tid; i < P; i += nthreads) {
    bool match;
    const float v = masked_score(p, q, P, i, keys, cin[i], simple ? 0 : nin[i], match);
    skeys[i] = score_key(v, i);
    matches += match ? 1 : 0;
  }
  add_matches(matches, &s_total);
  __syncthreads();

  // 5. top-k: the same tiled network, descending, over the score keys
  tiled_sort<false>(skeys, P, tile);
  write_top_k(p, q, skeys, keys);
  if (tid == 0) p.out_totals[q] = s_total;
}

// Launch `kernel` with the plan's threads and dynamic shared bytes. Above
// 48 KB, static and dynamic together, a kernel needs its limit raised first:
// done per kernel and device, to the largest size asked for so far. The
// raise is monotonic under the instantiation's lock: two host threads that
// launch one instantiation with different sizes (a simple and a bool bucket
// of one TB) could otherwise both see the limit short and set it in the
// wrong order, leaving it below the larger launch, which is then refused.
struct SharedLimit {
  std::mutex mu;
  int raised[kMaxDevices] = {};
};

template <typename Kernel>
int launch(Kernel kernel, SharedLimit* limit, const Params& p, int Qb, int threads,
           int shared_bytes, cudaStream_t stream) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  {
    std::lock_guard<std::mutex> hold(limit->mu);
    if (limit->raised[dev] < shared_bytes) {
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 shared_bytes);
      if (err != cudaSuccess) return static_cast<int>(err);
      limit->raised[dev] = shared_bytes;
    }
  }
  Params args = p;
  void* argv[] = {&args};
  err = cudaLaunchKernel(reinterpret_cast<const void*>(kernel), dim3(Qb), dim3(threads),
                         argv, shared_bytes, stream);
  if (err != cudaSuccess) cudaGetLastError();  // a refused launch leaves no error behind
  return static_cast<int>(err);
}

template <int P, int T>
int launch_smem(const Params& p, int Qb, int shared_bytes, cudaStream_t stream) {
  static SharedLimit limit;
  return launch(sparse_score_smem<P, T>, &limit, p, Qb, T, shared_bytes, stream);
}

int launch_global(const Params& p, int Qb, int threads, int shared_bytes,
                  cudaStream_t stream) {
  static SharedLimit limit;
  return launch(sparse_score_global, &limit, p, Qb, threads, shared_bytes, stream);
}

}  // namespace

// variant 0 = smem, 1 = global; `threads` and `shared_bytes` come from the
// wrapper's launch plan and pick the instantiation (an unplanned pair is
// refused with cudaErrorInvalidValue). The scratch pointers are null for the
// smem variant, and nbuf for a simple query.
extern "C" int sparse_score_launch(
    const void* qblk, const void* qw, const void* qconst, const void* qcnt,
    const void* qfid, const void* qmode, const void* n_must, const void* msm,
    const void* coord, int C1,
    const void* blk_docs, const void* blk_tf, int tf_kind, const void* blk_nb,
    const void* caches,
    int Qb, int TB, int k, int doc_pad, int passes, int simple, int use_coord,
    int variant, int threads, int shared_bytes,
    void* keys, void* skeys, void* cbuf, void* nbuf,
    void* out_scores, void* out_docs, void* out_totals, void* stream) {
  Params p;
  p.qblk = static_cast<const int32_t*>(qblk);
  p.qw = static_cast<const float*>(qw);
  p.qconst = static_cast<const uint8_t*>(qconst);
  p.qcnt = static_cast<const int32_t*>(qcnt);
  p.qfid = static_cast<const int32_t*>(qfid);
  p.qmode = static_cast<const int32_t*>(qmode);
  p.n_must = static_cast<const int32_t*>(n_must);
  p.msm = static_cast<const int32_t*>(msm);
  p.coord = static_cast<const float*>(coord);
  p.C1 = C1;
  p.blk_docs = static_cast<const int32_t*>(blk_docs);
  p.blk_tf = blk_tf;
  p.tf_kind = tf_kind;
  p.blk_nb = static_cast<const uint8_t*>(blk_nb);
  p.caches = static_cast<const float*>(caches);
  p.TB = TB;
  p.k = k;
  p.doc_pad = doc_pad;
  p.passes = passes;
  p.simple = simple;
  p.use_coord = use_coord;
  p.keys = static_cast<u64*>(keys);
  p.skeys = static_cast<u64*>(skeys);
  p.cbuf = static_cast<float*>(cbuf);
  p.nbuf = static_cast<int32_t*>(nbuf);
  p.out_scores = static_cast<float*>(out_scores);
  p.out_docs = static_cast<int32_t*>(out_docs);
  p.out_totals = static_cast<int32_t*>(out_totals);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int P = TB * kBlock;
  if (variant == 1) {
    if (P % kTile != 0 || threads != kGlobalThreads || shared_bytes < kTile * 8) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    return launch_global(p, Qb, threads, shared_bytes, s);
  }
  if (variant != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (P == 1024 && threads == 512) return launch_smem<1024, 512>(p, Qb, shared_bytes, s);
  if (P == 2048 && threads == 1024) return launch_smem<2048, 1024>(p, Qb, shared_bytes, s);
  if (P == 4096 && threads == 1024) return launch_smem<4096, 1024>(p, Qb, shared_bytes, s);
  if (P == 8192 && threads == 1024) return launch_smem<8192, 1024>(p, Qb, shared_bytes, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* sparse_score_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
