// The legacy per-pod scan solve for NVIDIA Hopper (sm_90a): the cluster
// autoscaler's what-if solve.
//
// Replaces kubernetes_tpu/ops/solver.py::_solve_packed (the lax.scan over
// _step that solve_scan and solve_whatif run as one XLA program). For each
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
// What bounds it on this card: latency. The what-if batches are small (at
// most 2,048 pods over a few hundred columns), the pods are sequential and
// each pod's step is a few barriers and one argmax over N, so the bytes and
// operations are far below the card's rates. The design is the simple one:
// one block, a thread per column (strided when N exceeds 1,024), the pod row
// staged in shared memory, and the three tables in shared memory when they
// fit (else they are read and updated in global memory, in place). A column's
// usage (requested, nonzero, pod count) is read and written only by the
// thread that owns the column, so it needs no fence. Division and the clamps
// follow IEEE f32 as the reference, and the file is built with --fmad=false,
// so the scores equal the plain version's and the reference's bit for bit,
// including at the autoscaler's penalty tiers (~1e6, where the f32 spacing is
// 0.0625 and the rounding of the last addition decides the argmax).

#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstddef>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxWarps = kMaxThreads / 32;

struct ScanDims {
  int r, sc, t, u, v, n, b;
};

struct Weights {
  float balanced, least, spread, affinity, stat;
};

// Word offsets of the shared-memory layout.
struct ScanLayout {
  int tables, totals, minc, pod_i, pod_f, red_f, red_i, words;
};

__host__ __device__ inline int pod_width(int r, int sc, int t) { return r + 4 + 2 * sc + 3 * t; }

__host__ __device__ inline ScanLayout scan_layout(const ScanDims& d, int tables_in_smem) {
  ScanLayout l;
  int o = 0;
  l.tables = o;
  if (tables_in_smem) o += (d.sc + 2 * d.t) * (d.v + 1);
  l.totals = o;
  o += d.t;
  l.minc = o;
  o += d.sc;
  l.pod_i = o;
  o += pod_width(d.r, d.sc, d.t);
  l.pod_f = o;
  o += d.t;
  l.red_f = o;
  o += kMaxWarps + 1;
  l.red_i = o;
  o += kMaxWarps + 1;
  l.words = o;
  return l;
}

__device__ __forceinline__ int warp_min(int x) {
  for (int o = 16; o > 0; o >>= 1) x = min(x, __shfl_down_sync(0xffffffffu, x, o));
  return x;
}

// Block-wide minimum, returned to every thread.
__device__ int block_min(int x, int* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  x = warp_min(x);
  if (lane == 0) scratch[warp] = x;
  __syncthreads();
  if (warp == 0) {
    x = lane < (int)(blockDim.x >> 5) ? scratch[lane] : INT_MAX;
    x = warp_min(x);
    if (lane == 0) scratch[kMaxWarps] = x;
  }
  __syncthreads();
  return scratch[kMaxWarps];
}

// (score, index) pair: the higher score wins, the lower index on equal scores.
__device__ __forceinline__ void better(float& s, int& j, float os, int oj) {
  if (os > s || (os == s && oj < j)) {
    s = os;
    j = oj;
  }
}

__device__ __forceinline__ void warp_best(float& s, int& j) {
  for (int o = 16; o > 0; o >>= 1)
    better(s, j, __shfl_down_sync(0xffffffffu, s, o), __shfl_down_sync(0xffffffffu, j, o));
}

// Block-wide best pair, returned to every thread.
__device__ void block_best(float& s, int& j, float* fs, int* js) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  warp_best(s, j);
  if (lane == 0) {
    fs[warp] = s;
    js[warp] = j;
  }
  __syncthreads();
  if (warp == 0) {
    s = -INFINITY;
    j = INT_MAX;
    if (lane < (int)(blockDim.x >> 5)) {
      s = fs[lane];
      j = js[lane];
    }
    warp_best(s, j);
    if (lane == 0) {
      fs[kMaxWarps] = s;
      js[kMaxWarps] = j;
    }
  }
  __syncthreads();
  s = fs[kMaxWarps];
  j = js[kMaxWarps];
}

__global__ void __launch_bounds__(kMaxThreads)
    solve_scan_kernel(const int* __restrict__ pod_ints, const float* __restrict__ pod_floats,
                      const int* __restrict__ alloc, const int* __restrict__ max_pods,
                      const int* __restrict__ masks, const float* __restrict__ scores,
                      const int* __restrict__ sc_codes, const int* __restrict__ sc_max_skew,
                      const int* __restrict__ sc_hard, const int* __restrict__ sc_domain,
                      const int* __restrict__ term_codes, const int* __restrict__ node_valid,
                      int* requested, int* nonzero, int* pod_count, int* g_sc_counts,
                      int* g_term_counts, int* g_term_owners, int* assign, ScanDims d, Weights w,
                      int tables_in_smem) {
  extern __shared__ int smem[];
  const ScanLayout L = scan_layout(d, tables_in_smem);
  const int tid = threadIdx.x, nth = blockDim.x;
  const int V = d.v, V1 = d.v + 1, N = d.n, R = d.r;
  const int W = pod_width(d.r, d.sc, d.t);
  int* scc = g_sc_counts;
  int* tc = g_term_counts;
  int* to = g_term_owners;
  if (tables_in_smem) {
    scc = smem + L.tables;
    tc = scc + d.sc * V1;
    to = tc + d.t * V1;
    for (int i = tid; i < d.sc * V1; i += nth) scc[i] = g_sc_counts[i];
    for (int i = tid; i < d.t * V1; i += nth) {
      tc[i] = g_term_counts[i];
      to[i] = g_term_owners[i];
    }
  }
  int* totals = smem + L.totals;
  int* minc = smem + L.minc;
  int* pi = smem + L.pod_i;
  float* pf = reinterpret_cast<float*>(smem + L.pod_f);
  float* red_f = reinterpret_cast<float*>(smem + L.red_f);
  int* red_i = smem + L.red_i;
  __syncthreads();
  // each term's matched pods over the real values (the sentinel left out)
  for (int t = tid; t < d.t; t += nth) {
    int s = 0;
    for (int v = 0; v < V; ++v) s += tc[t * V1 + v];
    totals[t] = s;
  }
  // column offsets of a pod row (pack_podin)
  const int o_nz = R, o_prof = R + 2, o_valid = R + 3, o_psc = R + 4;
  const int o_scm = o_psc + d.sc, o_mb = o_scm + d.sc, o_oa = o_mb + d.t, o_oan = o_oa + d.t;

  for (int b = 0; b < d.b; ++b) {
    __syncthreads();  // the previous pod's commit (or the setup) is done
    for (int i = tid; i < W; i += nth) pi[i] = pod_ints[(size_t)b * W + i];
    for (int i = tid; i < d.t; i += nth) pf[i] = pod_floats[(size_t)b * d.t + i];
    __syncthreads();
    if (pi[o_valid] == 0) {  // padding or inexpressible: never placed
      if (tid == 0) assign[b] = -1;
      continue;
    }
    const int profile = pi[o_prof];
    // the minimum count over the profile's eligible domain, for each active
    // hard constraint (0 when the domain is empty)
    for (int c = 0; c < d.sc; ++c) {
      if (!(pi[o_psc + c] && sc_hard[c])) continue;
      const int* dom = sc_domain + ((size_t)profile * d.sc + c) * V1;
      int m = INT_MAX;
      for (int v = tid; v < V; v += nth)
        if (dom[v]) m = min(m, scc[c * V1 + v]);
      m = block_min(m, red_i);
      if (tid == 0) minc[c] = m == INT_MAX ? 0 : m;
    }
    __syncthreads();
    // the pod's uniform facts
    bool has_aff = false, no_any = true, self_all = true, has_soft = false;
    for (int t = 0; t < d.t; ++t) {
      if (pi[o_oa + t]) {
        has_aff = true;
        no_any = no_any && totals[t] == 0;
        self_all = self_all && pi[o_mb + t] != 0;
      }
    }
    for (int c = 0; c < d.sc; ++c)
      if (pi[o_psc + c] && !sc_hard[c]) has_soft = true;
    const bool first_of_group = no_any && self_all;

    float best_s = -INFINITY;
    int best_j = INT_MAX;
    for (int j = tid; j < N; j += nth) {
      bool ok = node_valid[j] != 0 && masks[(size_t)profile * N + j] != 0 &&
                pod_count[j] < max_pods[j];
      for (int r = 0; ok && r < R; ++r)
        ok = requested[(size_t)j * R + r] + pi[r] <= alloc[(size_t)j * R + r];
      if (!ok) continue;
      int soft = 0;
      for (int c = 0; c < d.sc; ++c) {
        if (!pi[o_psc + c]) continue;
        const int code = sc_codes[(size_t)c * N + j];
        const int cnt = scc[c * V1 + code];
        if (sc_hard[c]) {
          if (cnt + pi[o_scm + c] - minc[c] > sc_max_skew[c] || code >= V) ok = false;
        } else {
          soft += cnt;
        }
      }
      bool aff_sat = true;
      float pref = 0.0f;
      for (int t = 0; t < d.t; ++t) {
        const int mb = pi[o_mb + t], oa = pi[o_oa + t], oan = pi[o_oan + t];
        const float wt = pf[t];
        if (!(mb || oa || oan) && wt == 0.0f) continue;
        const int code = term_codes[(size_t)t * N + j];
        const int cnt = tc[t * V1 + code];
        if (mb && to[t * V1 + code] > 0) ok = false;
        if (oan && cnt > 0) ok = false;
        if (oa && !(cnt > 0 && code < V)) aff_sat = false;
        pref += wt * (float)cnt;
      }
      if (has_aff && !(aff_sat || first_of_group)) ok = false;
      if (!ok) continue;
      const float alloc_cpu = (float)max(alloc[(size_t)j * R], 1);
      const float alloc_mem = (float)max(alloc[(size_t)j * R + 1], 1);
      const float cpu_frac = (float)(nonzero[(size_t)j * 2] + pi[o_nz]) / alloc_cpu;
      const float mem_frac = (float)(nonzero[(size_t)j * 2 + 1] + pi[o_nz + 1]) / alloc_mem;
      const bool over = cpu_frac >= 1.0f || mem_frac >= 1.0f;
      const float balanced = over ? 0.0f : (1.0f - fabsf(cpu_frac - mem_frac)) * 100.0f;
      const float least =
          (fminf(fmaxf(1.0f - cpu_frac, 0.0f), 1.0f) + fminf(fmaxf(1.0f - mem_frac, 0.0f), 1.0f)) *
          50.0f;
      const float spread = has_soft ? 100.0f / (1.0f + (float)soft) : 0.0f;
      float s = w.balanced * balanced;
      s = s + w.least * least;
      s = s + w.spread * spread;
      s = s + w.affinity * pref;
      s = s + w.stat * scores[(size_t)profile * N + j];
      if (s > best_s) {  // columns ascend: the first of equal scores stays
        best_s = s;
        best_j = j;
      }
    }
    block_best(best_s, best_j, red_f, red_i);
    const int chosen = best_j == INT_MAX ? -1 : best_j;
    if (tid == 0) assign[b] = chosen;
    if (chosen < 0) continue;
    // commit: the column's owner updates its usage; the tables gain the pod
    // at the column's codes (one thread a row)
    if (tid == chosen % nth) {
      for (int r = 0; r < R; ++r) requested[(size_t)chosen * R + r] += pi[r];
      nonzero[(size_t)chosen * 2] += pi[o_nz];
      nonzero[(size_t)chosen * 2 + 1] += pi[o_nz + 1];
      pod_count[chosen] += 1;
    }
    for (int c = tid; c < d.sc; c += nth)
      if (pi[o_scm + c]) scc[c * V1 + sc_codes[(size_t)c * N + chosen]] += pi[o_scm + c];
    for (int t = tid; t < d.t; t += nth) {
      const int mb = pi[o_mb + t], oan = pi[o_oan + t];
      if (!(mb || oan)) continue;
      const int code = term_codes[(size_t)t * N + chosen];
      tc[t * V1 + code] += mb;
      to[t * V1 + code] += oan;
      if (code < V) totals[t] += mb;
    }
  }
  __syncthreads();
  if (tables_in_smem) {
    for (int i = tid; i < d.sc * V1; i += nth) g_sc_counts[i] = scc[i];
    for (int i = tid; i < d.t * V1; i += nth) {
      g_term_counts[i] = tc[i];
      g_term_owners[i] = to[i];
    }
  }
}

}  // namespace

// Shared-memory bytes of the scan kernel, with the tables in shared memory
// or not.
extern "C" int ktt_scan_smem_bytes(int r, int sc, int t, int v, int tables_in_smem) {
  ScanDims d{r, sc, t, 0, v, 0, 0};
  return scan_layout(d, tables_in_smem).words * (int)sizeof(int);
}

// Launch the scan on `stream`: one block of `threads` threads (a multiple of
// 32, at most 1,024), usage and tables updated in place, one assignment a pod
// row. Returns the CUDA error of the launch (0 when it was accepted); a shape
// the kernel cannot run is refused as an invalid value.
extern "C" int ktt_solve_scan_launch(
    const int* pod_ints, const float* pod_floats, const int* alloc, const int* max_pods,
    const int* masks, const float* scores, const int* sc_codes, const int* sc_max_skew,
    const int* sc_hard, const int* sc_domain, const int* term_codes, const int* node_valid,
    int* requested, int* nonzero, int* pod_count, int* sc_counts, int* term_counts,
    int* term_owners, int* assign, int r, int sc, int t, int u, int v, int n, int b, int threads,
    int tables_in_smem, int smem_bytes, float balanced_w, float least_w, float spread_w,
    float affinity_w, float static_w, void* stream) {
  ScanDims d{r, sc, t, u, v, n, b};
  if (r < 2 || sc < 1 || t < 1 || u < 1 || v < 1 || n < 1 || b < 0 || threads < 32 ||
      threads > kMaxThreads || threads % 32 != 0 ||
      smem_bytes != scan_layout(d, tables_in_smem).words * (int)sizeof(int))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(solve_scan_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (e != cudaSuccess) return (int)e;
  solve_scan_kernel<<<1, threads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      pod_ints, pod_floats, alloc, max_pods, masks, scores, sc_codes, sc_max_skew, sc_hard,
      sc_domain, term_codes, node_valid, requested, nonzero, pod_count, sc_counts, term_counts,
      term_owners, assign, d, Weights{balanced_w, least_w, spread_w, affinity_w, static_w},
      tables_in_smem);
  return (int)cudaGetLastError();
}
