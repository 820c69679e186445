// The legacy per-pod scan solve for NVIDIA Hopper (sm_90a): the cluster
// autoscaler's what-if solve.
//
// Replaces kubernetes_tpu/ops/solver.py::_step as _solve_packed runs it (the
// lax.scan that solve_scan and solve_whatif run as one XLA program). For each
// pod of the packed stream in order: every node column is checked (validity,
// pod-count cap, resource fit, static profile mask, hard topology spread
// against the minimum count over the profile's eligible domain, existing and
// own anti-affinity, required affinity with the first-pod-of-group rule) and
// scored (balanced + least allocation + spread_w * 100/(1+soft count) +
// preferred term weights + static score, summed in that order in f32); the
// best column, lowest index on ties, takes the pod, or -1 when none is
// feasible; then the column's usage gains the pod and the three count tables
// gain it at the column's value codes.
//
// Unlike the planes solve (solve_kernel.cu), the scan's state is indexed by
// topology VALUE, not by node: sc_counts [SC, V+1], term_counts and
// term_owners [T, V+1] (column V, the sentinel, counts the pods placed on
// nodes without the key, as the reference's scatter-add does), read through
// the codes sc_codes / term_codes [., N] clamped to V.
//
// Layout (row-major, all int32 but the f32 scores and weights):
//   alloc [N, R], max_pods [N], masks [U, N], scores [U, N] f32,
//   sc_codes [SC, N], sc_max_skew [SC], sc_hard [SC], sc_domain [U, SC, V+1],
//   term_codes [T, N], node_valid [N];
//   state: requested [N, R], nonzero [N, 2], pod_count [N], the three tables;
//   pods: [B, R+4+2*SC+3*T] rows of pack_podin (no shared-volume columns),
//   weights [B, T] f32.
//
// What bounds it on this card: latency. A what-if is at most a few thousand
// pods over a few thousand columns and the pods are sequential, so the bytes
// and operations are far below the card's rates; a launch costs the length of
// one pod's dependent chain times the pods. The design shortens that chain:
//
// - Column state stays on chip. One block; thread `tid` owns the K columns
//   j = i * threads + tid (K a template parameter: 1, 2 or 4 over at most 512
//   threads, so N up to 2,048; past that K = 8 over up to 1,024 threads). On
//   this latency-bound loop more warps with fewer columns each are faster
//   (at N = 512: K = 1 over 512 threads before K = 2 over 256, K = 4 over 128
//   and K = 8 over 64; PERF.md, PR 10). Each owned column's free resources (alloc - requested, the
//   first four resources; the rest stay in place in global memory), nonzero
//   usage, pods left and f32 allocatable are loaded once into registers, and
//   written back once at the end. The current profile's mask and static
//   score are reloaded only when a pod's profile differs from the last one.
//   The first two terms of a column's score (balanced and least allocation,
//   summed) depend only on its nonzero usage and the pod's nonzero request:
//   each thread keeps them for its columns, and recomputes them (two
//   divisions) only for the column a commit changed or when the pod's
//   request differs from the last pod's, as in a burst of one workload's
//   replicas.
// - Counts at each column's own codes. Beside every column sit its codes
//   and the three tables' counts at them (sc_at, tc_at, to_at, with the codes
//   sc_code and t_code), column-owned, in shared memory when they fit, else
//   in a global scratch buffer. After a commit at column `chosen`, every
//   thread adds the pod's increments to each owned column whose code equals
//   the code at `chosen` (codes are static, so no race). The evaluation reads
//   no table. The value-indexed tables stay authoritative (shared memory when
//   they fit, else in place in global memory): they serve the hard-spread
//   domain minimum, the affinity totals and the write-back.
// - Pod rows are staged ahead of use: chunks of rows and weights are copied
//   into shared memory with cp.async, double-buffered, so chunk c + 1 lands
//   while chunk c is solved. Once a chunk, one thread a pod derives the pod's
//   fixed facts (its active constraints and terms as short lists, has_soft,
//   has_aff, self_all, the entries its commit touches).
// - One block-wide barrier a pod on the common path (no active hard spread
//   constraint and no required affinity): each thread takes the best of its
//   K columns, two warp reductions (redux.sync: the largest of the scores'
//   order-preserving bits, then the least column among those that reach
//   it) give the warp's winner, lane 0 writes it into a scratch array
//   double-buffered by the parity of the winner barriers, one barrier, and
//   every warp reduces the warps' winners itself the same way. The owner of
//   `chosen` commits the usage in its registers. A pod that reads the tables (a hard constraint's domain
//   minimum, or required affinity's totals) first takes a barrier so that
//   the tables hold the previous pod's commit; the minimum adds one more.
//
// Hazards and what answers each: a row buffer is refilled only after the
// barrier that opens the next chunk (every reader of the old chunk is past
// it); the winner scratch's half of barrier c is read between barriers c
// and c + 1 and written again only after barrier c + 1; the tables are
// written after a pod's winner barrier and read only
// after a later barrier; the last chunk copies and solves only the rows that
// exist.
//
// Division and the clamps follow IEEE f32 as the reference, and the file is
// built with --fmad=false, so the scores equal the plain version's and the
// reference's bit for bit, including at the autoscaler's penalty tiers (~1e6,
// where the f32 spacing is 0.0625 and the rounding of the last addition
// decides the argmax).

#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstddef>

namespace {

constexpr int kWarpSlots = 32;      // winner and minimum scratch: one a warp
constexpr int kRegResources = 4;    // resources held in registers
constexpr int kFactsHeader = 16;    // four int4 loads a pod
constexpr int kMaxChunk = 32;
constexpr int kSmallBlock = 512;    // threads of the K = 1, 2, 4 instances
constexpr int kLargeBlock = 1024;   // threads of the K = 8 instance, past 2,048 columns
constexpr int kSmemLimit = 232448;  // one block's shared memory on Hopper

// facts flags
constexpr int kSync = 1, kHasAff = 2, kSelfAll = 4, kHasSoft = 8;

struct ScanDims {
  int r, sc, t, u, v, n, b;
};

struct ScanShape {
  int k, threads, chunk, tables_in_smem, cols_in_smem;
};

struct Weights {
  float balanced, least, spread, affinity, stat;
};

struct ScanArgs {
  const int* pod_ints;
  const float* pod_floats;
  const int* alloc;
  const int* max_pods;
  const int* masks;
  const float* scores;
  const int* sc_codes;
  const int* sc_max_skew;
  const int* sc_hard;
  const int* sc_domain;
  const int* term_codes;
  const int* node_valid;
  int* requested;
  int* nonzero;
  int* pod_count;
  int* sc_counts;
  int* term_counts;
  int* term_owners;
  int* assign;
  int* col_scratch;  // the column arrays when they are not in shared memory
};

// Word offsets of the shared-memory layout (ops/solver.py::scan_smem_words
// computes the same sum).
struct ScanLayout {
  long long win, facts, tables, totals, cols, pod_i, pod_f, minbuf, words;
  int np, w, fw;
};

// An int array that a launch's plan puts in shared memory or in global
// memory. The flag is uniform, so each access is one shared-memory or one
// global-memory instruction, not a generic one.
struct Place {
  int* s;
  int* g;
  bool in_smem;
  __device__ __forceinline__ int ld(size_t i) const { return in_smem ? s[i] : g[i]; }
  __device__ __forceinline__ void st(size_t i, int v) const {
    if (in_smem)
      s[i] = v;
    else
      g[i] = v;
  }
  __device__ __forceinline__ void add(size_t i, int v) const {
    if (in_smem)
      s[i] += v;
    else
      g[i] += v;
  }
};

__host__ __device__ inline int pod_width(int r, int sc, int t) { return r + 4 + 2 * sc + 3 * t; }

// A pod's facts: the header (valid, profile, flags, soft entries | hard,
// term, sc commit and term commit entries | nonzero request [2], 0, 0 |
// request [4], 0 past R), then the lists: soft [SC], hard [SC], term [T],
// sc commit [SC], term commit [T]; rounded up to four words.
__host__ __device__ inline int facts_width(int sc, int t) {
  return (kFactsHeader + 3 * sc + 2 * t + 3) / 4 * 4;
}

__host__ __device__ inline long long col_words(int sc, int t, int np) {
  return (long long)(2 * sc + 3 * t) * np;
}

__host__ __device__ inline ScanLayout scan_layout(const ScanDims& d, const ScanShape& s) {
  ScanLayout l;
  l.np = s.k * s.threads;
  l.w = pod_width(d.r, d.sc, d.t);
  l.fw = facts_width(d.sc, d.t);
  long long o = 0;
  l.win = o;  // first: 8-byte aligned; two halves of a 64-bit slot a warp
  o += 2 * 2 * kWarpSlots;
  l.facts = o;  // 16-byte aligned, rows of a multiple of four words
  o += (long long)s.chunk * l.fw;
  l.tables = o;
  if (s.tables_in_smem) o += (long long)(d.sc + 2 * d.t) * (d.v + 1);
  l.totals = o;
  o += d.t;
  l.cols = o;
  if (s.cols_in_smem) o += col_words(d.sc, d.t, l.np);
  l.pod_i = o;
  o += 2LL * s.chunk * l.w;
  l.pod_f = o;
  o += 2LL * s.chunk * d.t;
  l.minbuf = o;
  o += (long long)d.sc * kWarpSlots;
  l.words = o;
  return l;
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// A float's bits, mapped so that unsigned order is the floats' order (-0
// taken as +0, which compares equal to it; no NaN arises).
__device__ __forceinline__ unsigned order_bits(float s) {
  unsigned u = __float_as_uint(s);
  if (u == 0x80000000u) u = 0;
  return u ^ ((u >> 31) ? 0xffffffffu : 0x80000000u);
}

// The warp's best (score bits, column), in every lane: the larger score,
// the lower column on equal scores.
__device__ __forceinline__ void warp_best(unsigned& bits, unsigned& j) {
  const unsigned top = __reduce_max_sync(0xffffffffu, bits);
  j = __reduce_min_sync(0xffffffffu, bits == top ? j : 0xffffffffu);
  bits = top;
}

// One pod's facts from its staged row (pack_podin's columns).
__device__ __forceinline__ void pod_facts(const int* __restrict__ row,
                                          const float* __restrict__ wr,
                                          const int* __restrict__ sc_hard, int* __restrict__ f,
                                          int R, int SC, int T) {
  const int o_psc = R + 4, o_scm = o_psc + SC, o_mb = o_scm + SC, o_oa = o_mb + T;
  const int o_oan = o_oa + T;
  int* soft = f + kFactsHeader;
  int* hard = soft + SC;
  int* term = hard + SC;
  int* csc = term + T;
  int* cterm = csc + SC;
  int ns = 0, nh = 0, nt = 0, ncs = 0, nct = 0;
  bool has_aff = false, self_all = true;
  for (int k = 0; k < SC; ++k) {
    if (row[o_psc + k]) {
      if (__ldg(sc_hard + k))
        hard[nh++] = k;
      else
        soft[ns++] = k;
    }
    if (row[o_scm + k]) csc[ncs++] = k;
  }
  for (int t = 0; t < T; ++t) {
    const int mb = row[o_mb + t], oa = row[o_oa + t], oan = row[o_oan + t];
    if (mb || oa || oan || wr[t] != 0.0f) term[nt++] = t;
    if (oa) {
      has_aff = true;
      self_all = self_all && mb != 0;
    }
    if (mb || oan) cterm[nct++] = t;
  }
  const int flags = (nh > 0 || has_aff ? kSync : 0) | (has_aff ? kHasAff : 0) |
                    (self_all ? kSelfAll : 0) | (ns > 0 ? kHasSoft : 0);
  int4* h = reinterpret_cast<int4*>(f);
  h[0] = make_int4(row[R + 3] != 0, row[R + 2], flags, ns);
  h[1] = make_int4(nh, nt, ncs, nct);
  h[2] = make_int4(row[R], row[R + 1], 0, 0);
  h[3] = make_int4(row[0], row[1], R > 2 ? row[2] : 0, R > 3 ? row[3] : 0);
}

template <int K, int MAXT>
__global__ void __launch_bounds__(MAXT, 1)
    solve_scan_kernel(ScanArgs a, ScanDims d, ScanShape sh, Weights w) {
  extern __shared__ int smem[];
  const ScanLayout L = scan_layout(d, sh);
  const int tid = threadIdx.x, nth = blockDim.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = nth >> 5;
  const int V = d.v, V1 = d.v + 1, N = d.n, R = d.r, SC = d.sc, T = d.t;
  const int NP = L.np, W = L.w, FW = L.fw, CH = sh.chunk;
  const int o_scm = R + 4 + SC, o_mb = o_scm + SC, o_oa = o_mb + T, o_oan = o_oa + T;
  const int nchunks = (d.b + CH - 1) / CH;
  int* pod_i = smem + L.pod_i;
  float* pod_f = reinterpret_cast<float*>(smem + L.pod_f);
  int* facts = smem + L.facts;
  uint2* win = reinterpret_cast<uint2*>(smem + L.win);
  int* minbuf = smem + L.minbuf;
  int* totals = smem + L.totals;

  // chunk c's rows and weights into buffer c & 1, as one cp.async group;
  // only the rows that exist
  auto stage = [&](int c) {
    const int base = c * CH, cnt = min(CH, d.b - base), buf = c & 1;
    const int* gi = a.pod_ints + (size_t)base * W;
    int* si = pod_i + buf * CH * W;
    for (int x = tid; x < cnt * W; x += nth) cp_async4(si + x, gi + x);
    const float* gf = a.pod_floats + (size_t)base * T;
    float* sf = pod_f + buf * CH * T;
    for (int x = tid; x < cnt * T; x += nth) cp_async4(sf + x, gf + x);
    cp_async_commit();
  };
  if (nchunks > 0) stage(0);

  // ---- the value-indexed tables (authoritative) and the affinity totals
  const bool tin = sh.tables_in_smem;
  const Place scc{smem + L.tables, a.sc_counts, tin};
  const Place tc{smem + L.tables + (size_t)SC * V1, a.term_counts, tin};
  const Place to{smem + L.tables + (size_t)(SC + T) * V1, a.term_owners, tin};
  if (tin) {
    for (int i = tid; i < SC * V1; i += nth) scc.s[i] = a.sc_counts[i];
    for (int i = tid; i < T * V1; i += nth) {
      tc.s[i] = a.term_counts[i];
      to.s[i] = a.term_owners[i];
    }
  }
  // each term's matched pods over the real values (the sentinel left out)
  for (int t = tid; t < T; t += nth) {
    int s = 0;
    for (int v = 0; v < V; ++v) s += a.term_counts[(size_t)t * V1 + v];
    totals[t] = s;
  }

  // ---- column-owned arrays: codes and the tables' counts at them, at
  // these offsets (row x of an array starts x * NP further)
  const Place cols{smem + L.cols, a.col_scratch, sh.cols_in_smem != 0};
  const size_t o_sc_code = 0, o_sc_at = (size_t)SC * NP, o_t_code = 2 * (size_t)SC * NP;
  const size_t o_tc_at = o_t_code + (size_t)T * NP, o_to_at = o_tc_at + (size_t)T * NP;
#pragma unroll
  for (int i = 0; i < K; ++i) {
    const int j = i * nth + tid;
    for (int c = 0; c < SC; ++c) {
      const int code = j < N ? a.sc_codes[(size_t)c * N + j] : V;
      cols.st(o_sc_code + (size_t)c * NP + j, code);
      cols.st(o_sc_at + (size_t)c * NP + j, a.sc_counts[(size_t)c * V1 + code]);
    }
    for (int t = 0; t < T; ++t) {
      const int code = j < N ? a.term_codes[(size_t)t * N + j] : V;
      cols.st(o_t_code + (size_t)t * NP + j, code);
      cols.st(o_tc_at + (size_t)t * NP + j, a.term_counts[(size_t)t * V1 + code]);
      cols.st(o_to_at + (size_t)t * NP + j, a.term_owners[(size_t)t * V1 + code]);
    }
  }

  // ---- the owned columns' usage and static facts, in registers
  int head[K][kRegResources];  // alloc - requested
  int nzc[K], nzm[K], left[K];
  float acpu[K], amem[K], stat[K];
  float part[K];  // balanced and least terms, summed, for the last pod's request
  unsigned valid_bits = 0, fresh = 0;  // fresh: part[i] holds for the request
  int last_nz0 = -1, last_nz1 = -1;
#pragma unroll
  for (int i = 0; i < K; ++i) {
    const int j = i * nth + tid;
    const bool in = j < N;
#pragma unroll
    for (int r = 0; r < kRegResources; ++r)
      head[i][r] = in && r < R
                       ? a.alloc[(size_t)j * R + r] - a.requested[(size_t)j * R + r]
                       : 0;
    nzc[i] = in ? a.nonzero[(size_t)j * 2] : 0;
    nzm[i] = in ? a.nonzero[(size_t)j * 2 + 1] : 0;
    left[i] = in ? a.max_pods[j] - a.pod_count[j] : 0;
    acpu[i] = in ? (float)max(a.alloc[(size_t)j * R], 1) : 1.0f;
    amem[i] = in ? (float)max(a.alloc[(size_t)j * R + 1], 1) : 1.0f;
    stat[i] = 0.0f;
    part[i] = 0.0f;
    if (in && a.node_valid[j] != 0) valid_bits |= 1u << i;
  }

  int cur_profile = -1;
  unsigned ok_bits = 0;  // valid and in the current profile's mask
  int par = 0;           // the winner scratch's half: flips every winner barrier
  for (int c = 0; c < nchunks; ++c) {
    cp_async_wait_all();
    // chunk c has landed in every thread's part; every thread is done with
    // chunk c - 1 (its rows and facts); the setup is done
    __syncthreads();
    if (c + 1 < nchunks) stage(c + 1);
    const int base = c * CH, cnt = min(CH, d.b - base), buf = c & 1;
    const int* rows = pod_i + buf * CH * W;
    const float* wrows = pod_f + buf * CH * T;
    if (tid < cnt) pod_facts(rows + tid * W, wrows + tid * T, a.sc_hard, facts + tid * FW, R, SC, T);
    __syncthreads();  // the facts are visible

    for (int p = 0; p < cnt; ++p) {
      const int* f = facts + p * FW;
      const int b = base + p;
      const int4 h0 = reinterpret_cast<const int4*>(f)[0];
      const int4 h1 = reinterpret_cast<const int4*>(f)[1];
      const int4 h2 = reinterpret_cast<const int4*>(f)[2];
      const int4 h3 = reinterpret_cast<const int4*>(f)[3];
      if (!h0.x) {  // padding or inexpressible: never placed
        if (tid == 0) a.assign[b] = -1;
        continue;
      }
      const int* row = rows + p * W;
      const float* wr = wrows + p * T;
      const int profile = h0.y, flags = h0.z;
      const int n_soft = h0.w, n_hard = h1.x, n_term = h1.y, n_csc = h1.z, n_cterm = h1.w;
      const int* soft_l = f + kFactsHeader;
      const int* hard_l = soft_l + SC;
      const int* term_l = hard_l + SC;
      const int* csc_l = term_l + T;
      const int* cterm_l = csc_l + SC;
      if (profile != cur_profile) {
        cur_profile = profile;
        ok_bits = 0;
#pragma unroll
        for (int i = 0; i < K; ++i) {
          const int j = i * nth + tid;
          if (j < N) {
            if (((valid_bits >> i) & 1u) && a.masks[(size_t)profile * N + j] != 0)
              ok_bits |= 1u << i;
            stat[i] = a.scores[(size_t)profile * N + j];
          }
        }
      }
      const bool has_aff = flags & kHasAff;
      bool first_of_group = false;
      if (flags & kSync) {
        __syncthreads();  // the tables and totals hold every earlier commit
        if (n_hard > 0) {
          // each active hard constraint's minimum count over the profile's
          // eligible domain: a partial a warp, reduced by every warp itself
          for (int e = 0; e < n_hard; ++e) {
            const int k = hard_l[e];
            const int* dom = a.sc_domain + ((size_t)profile * SC + k) * V1;
            int m = INT_MAX;
            for (int v = tid; v < V; v += nth)
              if (dom[v]) m = min(m, scc.ld((size_t)k * V1 + v));
            m = __reduce_min_sync(0xffffffffu, m);
            if (lane == 0) minbuf[e * kWarpSlots + warp] = m;
          }
          __syncthreads();
        }
        if (has_aff) {
          bool no_any = true;
          for (int e = 0; e < n_term; ++e) {
            const int t = term_l[e];
            if (row[o_oa + t] && totals[t] != 0) no_any = false;
          }
          first_of_group = no_any && (flags & kSelfAll);
        }
      }

      // ---- feasibility and scores of the owned columns
      const int preq[kRegResources] = {h3.x, h3.y, h3.z, h3.w};
      bool ok[K], asat[K];
      int soft[K];
      float pref[K];
#pragma unroll
      for (int i = 0; i < K; ++i) {
        bool o = ((ok_bits >> i) & 1u) && left[i] > 0;
#pragma unroll
        for (int r = 0; r < kRegResources; ++r)
          if (r < R) o = o && preq[r] <= head[i][r];
        ok[i] = o;
        asat[i] = true;
        soft[i] = 0;
        pref[i] = 0.0f;
      }
      if (R > kRegResources) {
#pragma unroll
        for (int i = 0; i < K; ++i) {
          const size_t j = (size_t)(i * nth + tid);
          for (int r = kRegResources; ok[i] && r < R; ++r)
            ok[i] = a.requested[j * R + r] + row[r] <= a.alloc[j * R + r];
        }
      }
#pragma unroll 4
      for (int e = 0; e < n_soft; ++e) {
        const size_t rx = (size_t)soft_l[e] * NP + tid;  // + i * nth: owned column i
#pragma unroll
        for (int i = 0; i < K; ++i) soft[i] += cols.ld(o_sc_at + rx + i * nth);
      }
      for (int e = 0; e < n_hard; ++e) {
        const int x = hard_l[e];
        const size_t rx = (size_t)x * NP + tid;
        int m = lane < nwarps ? minbuf[e * kWarpSlots + lane] : INT_MAX;
        m = __reduce_min_sync(0xffffffffu, m);
        const int minc = m == INT_MAX ? 0 : m;
        const int scm = row[o_scm + x], skew = a.sc_max_skew[x];
#pragma unroll
        for (int i = 0; i < K; ++i)
          if (cols.ld(o_sc_at + rx + i * nth) + scm - minc > skew ||
              cols.ld(o_sc_code + rx + i * nth) >= V)
            ok[i] = false;
      }
#pragma unroll 2
      for (int e = 0; e < n_term; ++e) {
        const int x = term_l[e];
        const size_t rx = (size_t)x * NP + tid;
        const int mb = row[o_mb + x], oa = row[o_oa + x], oan = row[o_oan + x];
        const float wt = wr[x];
#pragma unroll
        for (int i = 0; i < K; ++i) {
          const int n_at = cols.ld(o_tc_at + rx + i * nth);
          if (mb && cols.ld(o_to_at + rx + i * nth) > 0) ok[i] = false;
          if (oan && n_at > 0) ok[i] = false;
          if (oa && !(n_at > 0 && cols.ld(o_t_code + rx + i * nth) < V)) asat[i] = false;
          pref[i] += wt * (float)n_at;
        }
      }
      const int pnz0 = h2.x, pnz1 = h2.y;
      if (pnz0 != last_nz0 || pnz1 != last_nz1) {
        fresh = 0;
        last_nz0 = pnz0;
        last_nz1 = pnz1;
      }
      const bool has_soft = flags & kHasSoft;
      float best_s = -INFINITY;
      int best_j = INT_MAX;
#pragma unroll
      for (int i = 0; i < K; ++i) {
        if (has_aff && !(asat[i] || first_of_group)) ok[i] = false;
        if (!ok[i]) continue;
        if (!((fresh >> i) & 1u)) {
          const float cpu_frac = (float)(nzc[i] + pnz0) / acpu[i];
          const float mem_frac = (float)(nzm[i] + pnz1) / amem[i];
          const bool over = cpu_frac >= 1.0f || mem_frac >= 1.0f;
          const float balanced = over ? 0.0f : (1.0f - fabsf(cpu_frac - mem_frac)) * 100.0f;
          const float least = (fminf(fmaxf(1.0f - cpu_frac, 0.0f), 1.0f) +
                               fminf(fmaxf(1.0f - mem_frac, 0.0f), 1.0f)) *
                              50.0f;
          part[i] = w.balanced * balanced + w.least * least;
          fresh |= 1u << i;
        }
        const float spread = has_soft ? 100.0f / (1.0f + (float)soft[i]) : 0.0f;
        float s = part[i];
        s = s + w.spread * spread;
        s = s + w.affinity * pref[i];
        s = s + w.stat * stat[i];
        if (s > best_s) {  // owned columns ascend: the first of equal scores stays
          best_s = s;
          best_j = i * nth + tid;
        }
      }

      // ---- the block's best: one barrier
      unsigned bits = order_bits(best_s), col = (unsigned)best_j;
      warp_best(bits, col);
      if (lane == 0) win[par * kWarpSlots + warp] = make_uint2(bits, col);
      __syncthreads();
      const uint2 other = lane < nwarps ? win[par * kWarpSlots + lane] : make_uint2(0u, 0xffffffffu);
      bits = other.x;
      col = other.y;
      warp_best(bits, col);
      par ^= 1;
      const int chosen = col == (unsigned)INT_MAX ? -1 : (int)col;
      if (tid == 0) a.assign[b] = chosen;
      if (chosen < 0) continue;

      // ---- commit: the owner's usage, every owned column sharing the
      // chosen column's codes, and the tables (a thread an entry)
#pragma unroll
      for (int i = 0; i < K; ++i) {
        if (i * nth + tid != chosen) continue;
#pragma unroll
        for (int r = 0; r < kRegResources; ++r)
          if (r < R) head[i][r] -= preq[r];
        nzc[i] += pnz0;
        nzm[i] += pnz1;
        left[i] -= 1;
        fresh &= ~(1u << i);
        for (int r = kRegResources; r < R; ++r) a.requested[(size_t)chosen * R + r] += row[r];
      }
      for (int e = 0; e < n_csc; ++e) {
        const int x = csc_l[e];
        const size_t rx = (size_t)x * NP;
        const int cc = cols.ld(o_sc_code + rx + chosen), inc = row[o_scm + x];
#pragma unroll
        for (int i = 0; i < K; ++i)
          if (cols.ld(o_sc_code + rx + i * nth + tid) == cc)
            cols.add(o_sc_at + rx + i * nth + tid, inc);
      }
      for (int e = 0; e < n_cterm; ++e) {
        const int x = cterm_l[e];
        const size_t rx = (size_t)x * NP;
        const int cc = cols.ld(o_t_code + rx + chosen), mb = row[o_mb + x], oan = row[o_oan + x];
#pragma unroll
        for (int i = 0; i < K; ++i) {
          if (cols.ld(o_t_code + rx + i * nth + tid) != cc) continue;
          cols.add(o_tc_at + rx + i * nth + tid, mb);
          cols.add(o_to_at + rx + i * nth + tid, oan);
        }
      }
      for (int e = tid; e < n_csc; e += nth) {
        const int x = csc_l[e];
        scc.add((size_t)x * V1 + cols.ld(o_sc_code + (size_t)x * NP + chosen), row[o_scm + x]);
      }
      for (int e = tid; e < n_cterm; e += nth) {
        const int x = cterm_l[e], mb = row[o_mb + x];
        const int cc = cols.ld(o_t_code + (size_t)x * NP + chosen);
        tc.add((size_t)x * V1 + cc, mb);
        to.add((size_t)x * V1 + cc, row[o_oan + x]);
        if (cc < V) totals[x] += mb;
      }
    }
  }
  __syncthreads();

  // ---- write back: each owner its columns, then the tables
#pragma unroll
  for (int i = 0; i < K; ++i) {
    const int j = i * nth + tid;
    if (j >= N) continue;
#pragma unroll
    for (int r = 0; r < kRegResources; ++r)
      if (r < R) a.requested[(size_t)j * R + r] = a.alloc[(size_t)j * R + r] - head[i][r];
    a.nonzero[(size_t)j * 2] = nzc[i];
    a.nonzero[(size_t)j * 2 + 1] = nzm[i];
    a.pod_count[j] = a.max_pods[j] - left[i];
  }
  if (tin) {
    for (int i = tid; i < SC * V1; i += nth) a.sc_counts[i] = scc.s[i];
    for (int i = tid; i < T * V1; i += nth) {
      a.term_counts[i] = tc.s[i];
      a.term_owners[i] = to.s[i];
    }
  }
}

template <int K, int MAXT>
int launch_instance(const ScanArgs& a, const ScanDims& d, const ScanShape& s, const Weights& w,
                    int smem_bytes, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(solve_scan_kernel<K, MAXT>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (e != cudaSuccess) return (int)e;
  solve_scan_kernel<K, MAXT><<<1, s.threads, smem_bytes, stream>>>(a, d, s, w);
  return (int)cudaGetLastError();
}

bool shape_ok(const ScanDims& d, const ScanShape& s) {
  if (d.r < 2 || d.sc < 1 || d.t < 1 || d.u < 1 || d.v < 1 || d.n < 1 || d.b < 0) return false;
  if (s.k != 1 && s.k != 2 && s.k != 4 && s.k != 8) return false;
  const int max_threads = s.k == 8 ? kLargeBlock : kSmallBlock;
  if (s.threads < 32 || s.threads > max_threads || s.threads % 32 != 0) return false;
  if ((long long)s.threads * s.k < d.n) return false;
  return s.chunk >= 1 && s.chunk <= kMaxChunk;
}

}  // namespace

// Shared-memory bytes of the scan kernel's layout at this shape (-1 for a
// shape no instance takes).
extern "C" long long ktt_scan_smem_bytes(int r, int sc, int t, int v, int n, int k, int threads,
                                         int chunk, int tables_in_smem, int cols_in_smem) {
  ScanDims d{r, sc, t, 1, v, n, 0};
  ScanShape s{k, threads, chunk, tables_in_smem, cols_in_smem};
  if (!shape_ok(d, s)) return -1;
  return scan_layout(d, s).words * (long long)sizeof(int);
}

// Launch the scan on `stream`: one block of `threads` threads owning `k`
// columns each, pod rows staged `chunk` at a time, usage and tables updated
// in place, one assignment a pod row. `col_scratch` holds the column arrays
// ((2*sc + 3*t) * k * threads int32) when they are not in shared memory.
// Returns the CUDA error of the launch (0 when it was accepted); a shape the
// kernel cannot run, or a byte count that disagrees with the layout, is
// refused as an invalid value.
extern "C" int ktt_solve_scan_launch(
    const int* pod_ints, const float* pod_floats, const int* alloc, const int* max_pods,
    const int* masks, const float* scores, const int* sc_codes, const int* sc_max_skew,
    const int* sc_hard, const int* sc_domain, const int* term_codes, const int* node_valid,
    int* requested, int* nonzero, int* pod_count, int* sc_counts, int* term_counts,
    int* term_owners, int* assign, int* col_scratch, int r, int sc, int t, int u, int v, int n,
    int b, int k, int threads, int chunk, int tables_in_smem, int cols_in_smem, int smem_bytes,
    float balanced_w, float least_w, float spread_w, float affinity_w, float static_w,
    void* stream) {
  const ScanDims d{r, sc, t, u, v, n, b};
  const ScanShape s{k, threads, chunk, tables_in_smem != 0, cols_in_smem != 0};
  if (!shape_ok(d, s) || (!s.cols_in_smem && col_scratch == nullptr) ||
      smem_bytes != scan_layout(d, s).words * (long long)sizeof(int) || smem_bytes > kSmemLimit)
    return (int)cudaErrorInvalidValue;
  const ScanArgs a{pod_ints,   pod_floats, alloc,     max_pods,    masks,       scores,
                   sc_codes,   sc_max_skew, sc_hard,  sc_domain,   term_codes,  node_valid,
                   requested,  nonzero,    pod_count, sc_counts,   term_counts, term_owners,
                   assign,     col_scratch};
  const Weights w{balanced_w, least_w, spread_w, affinity_w, static_w};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 1:
      return launch_instance<1, kSmallBlock>(a, d, s, w, smem_bytes, st);
    case 2:
      return launch_instance<2, kSmallBlock>(a, d, s, w, smem_bytes, st);
    case 4:
      return launch_instance<4, kSmallBlock>(a, d, s, w, smem_bytes, st);
    default:
      return launch_instance<8, kLargeBlock>(a, d, s, w, smem_bytes, st);
  }
}
