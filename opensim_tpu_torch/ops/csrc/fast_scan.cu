// Bind-scan kernel for Hopper (sm_90a): the whole pod stream in one launch.
//
// Replaces the Pallas megakernel that opensim_tpu/ops/pallas_scan.py:
// _make_kernel generates (reached through run_fast_scan's pl.pallas_call)
// for the flags has_gpu (with gc_row), has_na, has_tt and has_avoid: static
// row gather, NodeResourcesFit (with the dynamic gpu-count allocatable),
// node validity, the Open-Gpu-Share filter, PodTopologySpread (hard and
// soft; hostname plus zone keys), least-allocated + balanced + Simon share
// (min-max, with the gpu-count add-back) + spread + NodeAffinity +
// TaintToleration + NodePreferAvoidPods scores, selectHost (lowest index
// among the maxima, pins for forced pods) and the bind update of the usage,
// selector-count and GPU state.
//
// Variants: the kernel is a template over the five flags, and the host entry
// picks the instantiation, so a variant carries no code of a feature it
// lacks.
//
// What bounds it: not bytes and not operations. A step reads a few hundred
// KB that stay in L2 and does some 70-200 flops per node, but pod i+1 reads
// the state pod i wrote, so the P steps form a serial chain; each step costs
// a fixed number of block-wide barriers and reductions. The design therefore
// keeps the chain inside one persistent CTA (no per-pod launch, no grid
// sync): 1024 threads, thread t owns the nodes n = t (mod 1024), and a step
// is three block reductions plus one barrier after the bind. The state
// (used, node_cnt, zone_cnt, gpu_free) lives in global memory and stays in
// L2. The flag branches add no reduction: the NodeAffinity and
// TaintToleration maxima ride in the second one.
//
// Bit-exactness with the plain PyTorch version (ops/fast_scan.py) and the
// JAX reference: every formula is written in the reference's op order,
// every constant is a float literal, and the file is compiled with
// --fmad=false and without fast math, so each + - * / rounds once as an
// IEEE single op. Equal scores are the rule on a uniform fleet; one ulp
// would flip a tie.

#include <cuda_runtime.h>
#include <stdint.h>

#include <array>
#include <utility>

#define NT 1024
#define NWARP (NT / 32)
#define MAX_R 8
#define MAX_CS 8
#define MAX_GD 8
#define MAX_RED 8  // values one block_reduce call takes: max(MAX_CS, 7)
#define FULL_MASK 0xffffffffu

namespace {

constexpr float BIG = 1e30f;
constexpr float NEG = -1e30f;
constexpr float MAX_SCORE = 100.0f;
constexpr float AVOID_WEIGHT = 10000.0f;
constexpr int RES_CPU = 0;
constexpr int RES_MEMORY = 1;

}  // namespace

// Mirrors the ctypes.Structure in ops/fast_scan.py field for field.
struct FastScanArgs {
    // pod stream [P]
    const int32_t* tmpl;
    const int32_t* valid;
    const int32_t* forced;
    // node tables
    const float* alloc;        // [R, N]
    const float* used0;        // [R, N]
    const float* node_valid;   // [N]
    const int32_t* zone_idx;   // [K, N] zone of node n under zone key k, -1 = no label
    // template tables
    const float* static_pass;  // [U, N]
    const float* aff_mask;     // [U, N]
    const float* share_raw;    // [U, N]
    const float* matches;      // [A, U]
    const float* req;          // [U, R]
    const float* cpu_nz;       // [U]
    const float* mem_nz;       // [U]
    const int32_t* pin;        // [U]
    const int32_t* spr_active; // [U, Cs]
    const int32_t* spr_key;    // [U, Cs] 0 = hostname, 1..K = zone keys
    const int32_t* spr_sel;    // [U, Cs]
    const float* spr_skew;     // [U, Cs]
    const int32_t* spr_hard;   // [U, Cs]
    const float* spr_self;     // [U, Cs]
    const float* spr_weight;   // [U, Cs]
    // gpu share (has_gpu)
    const float* gpu_mem;      // [U] per-GPU memory request
    const float* gpu_cnt;      // [U] GPUs requested
    const float* gpu0;         // [Gd, N] initial free memory per GPU
    // static score tables (has_na, has_tt, has_avoid)
    const float* na_raw;       // [U, N]
    const float* tt_raw;       // [U, N]
    const float* avoid_raw;    // [U, N]
    // outputs and state
    int32_t* chosen;           // [P]
    float* used;               // [R, N]
    float* node_cnt;           // [A, N]
    float* zone_cnt;           // [K * A, Z]
    float* gpu_take;           // [P, Gd] written for bound pods only
    float* gpu_free;           // [Gd, N]
    int32_t P, N, R, U, A, K, Z, Cs, Gd, gc_row;
    int32_t has_gpu, has_na, has_tt, has_avoid;
};

__device__ __forceinline__ float warp_min(float v) {
    for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(FULL_MASK, v, o));
    return v;
}

__device__ __forceinline__ float warp_max(float v) {
    for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL_MASK, v, o));
    return v;
}

// Block-wide min (is_max[j] == 0) or max (is_max[j] == 1) of `nv` values per
// thread; every thread gets the results in `out`. Two barriers.
__device__ void block_reduce(const float* in, const int* is_max, int nv, float* out,
                             float (*buf)[NWARP], float* res) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    for (int j = 0; j < nv; ++j) {
        float v = is_max[j] ? warp_max(in[j]) : warp_min(in[j]);
        if (lane == 0) buf[j][warp] = v;
    }
    __syncthreads();
    if (warp == 0) {
        for (int j = 0; j < nv; ++j) {
            float v = buf[j][lane];
            v = is_max[j] ? warp_max(v) : warp_min(v);
            if (lane == 0) res[j] = v;
        }
    }
    __syncthreads();
    for (int j = 0; j < nv; ++j) out[j] = res[j];
}

// Lowest index among the maxima: (score, index) pairs, ties to the lower
// index. Two barriers.
__device__ __forceinline__ void better(float& s, int& i, float s2, int i2) {
    if (s2 > s || (s2 == s && i2 < i)) {
        s = s2;
        i = i2;
    }
}

__device__ int block_argmax(float s, int i, float* sbuf, int* ibuf, int* res) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    for (int o = 16; o > 0; o >>= 1) better(s, i, __shfl_xor_sync(FULL_MASK, s, o), __shfl_xor_sync(FULL_MASK, i, o));
    if (lane == 0) {
        sbuf[warp] = s;
        ibuf[warp] = i;
    }
    __syncthreads();
    if (warp == 0) {
        s = sbuf[lane];
        i = ibuf[lane];
        for (int o = 16; o > 0; o >>= 1) better(s, i, __shfl_xor_sync(FULL_MASK, s, o), __shfl_xor_sync(FULL_MASK, i, o));
        if (lane == 0) *res = i;
    }
    __syncthreads();
    return *res;
}

// Count of bound pods matching selector `sel` in node n's domain under
// topology key `key` (0 = hostname, 1..K = zone keys), and whether node n
// carries that key's label. The reference gathers zone counts with an f32
// one-hot dot; the counts are integers below 2^24, so this gather by zone
// index gives the same bits.
__device__ __forceinline__ void sel_cnt(const FastScanArgs& a, int sel, int key, int n, float& cnt,
                                        float& has_label) {
    if (key == 0) {
        cnt = a.node_cnt[(size_t)sel * a.N + n];
        has_label = 1.0f;
        return;
    }
    const int k = key - 1;
    const int z = a.zone_idx[(size_t)k * a.N + n];
    cnt = z >= 0 ? a.zone_cnt[((size_t)k * a.A + sel) * a.Z + z] : 0.0f;
    has_label = z >= 0 ? 1.0f : 0.0f;
}

// Dynamic gpu-count allocatable of node n (pallas_scan.py:401-412): the
// count of its devices with free memory left, and whether it has devices.
__device__ __forceinline__ void gc_node(const FastScanArgs& a, int n, float& dyn, float& has_dev) {
    dyn = 0.0f;
    has_dev = 0.0f;
    for (int d = 0; d < a.Gd; ++d) {
        const float valid_d = a.gpu0[(size_t)d * a.N + n] > 0.0f ? 1.0f : 0.0f;
        const float free_d = a.gpu_free[(size_t)d * a.N + n] > 0.0f ? 1.0f : 0.0f;
        dyn = dyn + valid_d * free_d;
        has_dev = fmaxf(has_dev, valid_d);
    }
}

// Filter and soft-spread raw score of node n for template u, given the
// per-constraint minimum counts (pallas_scan.py:400-501), plus node n's
// dynamic gpu-count state for the share add-back.
template <bool GPU, bool GC>
__device__ __forceinline__ void node_filter(const FastScanArgs& a, int u, int n, const float* min_cnt,
                                            float& feasible, float& soft_raw, float& ignored,
                                            float& gc_dyn, float& gc_has_dev) {
    const float valid_row = a.node_valid[n];
    if constexpr (GC) gc_node(a, n, gc_dyn, gc_has_dev);
    float fit = 1.0f;
    for (int r = 0; r < a.R; ++r) {
        const float req_r = a.req[u * a.R + r];
        float alloc_r = a.alloc[(size_t)r * a.N + n];
        if constexpr (GC)
            if (r == a.gc_row) alloc_r = gc_has_dev > 0.0f ? gc_dyn : alloc_r;
        const float over = (a.used[(size_t)r * a.N + n] + req_r > alloc_r) ? 1.0f : 0.0f;
        fit = fit * (req_r > 0.0f ? 1.0f - over : 1.0f);
    }
    feasible = a.static_pass[(size_t)u * a.N + n] * fit * valid_row;
    if constexpr (GPU) {
        // Open-Gpu-Share filter: sum_d floor(free_d / mem) >= count
        const float gmem = a.gpu_mem[u];
        const float gcnt = a.gpu_cnt[u];
        if (gmem > 0.0f) {
            const float gmem1 = fmaxf(gmem, 1.0f);
            float chunks_sum = 0.0f;
            for (int d = 0; d < a.Gd; ++d) chunks_sum = chunks_sum + floorf(a.gpu_free[(size_t)d * a.N + n] / gmem1);
            const bool gpu_ok = chunks_sum >= gcnt && gcnt > 0.0f;
            feasible = feasible * (gpu_ok ? 1.0f : 0.0f);
        }
    }
    soft_raw = 0.0f;
    ignored = 0.0f;
    for (int c = 0; c < a.Cs; ++c) {
        const int uc = u * a.Cs + c;
        if (a.spr_active[uc] != 1) continue;
        float cnt, has_label;
        sel_cnt(a, a.spr_sel[uc], a.spr_key[uc], n, cnt, has_label);
        const float skew = a.spr_skew[uc];
        if (a.spr_hard[uc] == 1) {
            const bool ok = (cnt + a.spr_self[uc] - min_cnt[c] <= skew) && (has_label > 0.0f);
            feasible = feasible * (ok ? 1.0f : 0.0f);
        } else {
            const float contrib = has_label > 0.0f ? cnt * a.spr_weight[uc] + (skew - 1.0f) : 0.0f;
            soft_raw = soft_raw + contrib;
            ignored = fmaxf(ignored, 1.0f - has_label);
        }
    }
}

// Simon share of node n for template u, with the gpu-count share added back
// at the Reserve-updated count (pallas_scan.py:614-630).
template <bool GC>
__device__ __forceinline__ float share_of(const FastScanArgs& a, int u, int n, float gc_dyn, float gc_has_dev) {
    float share_row = a.share_raw[(size_t)u * a.N + n];
    if constexpr (GC) {
        const float gc_req = a.req[u * a.R + a.gc_row];
        const bool declared = a.alloc[(size_t)a.gc_row * a.N + n] > 0.0f;
        const float avail = gc_dyn - gc_req;
        float sh = avail == 0.0f ? (gc_req == 0.0f ? 0.0f : 1.0f) : gc_req / avail;
        sh = ((declared && gc_has_dev > 0.0f) ? fmaxf(sh, 0.0f) : 0.0f) * MAX_SCORE;
        share_row = fmaxf(share_row, gc_req > 0.0f ? sh : 0.0f);
    }
    return share_row;
}

// Device packing of template u on node c (pallas_scan.py:759-782): one GPU
// takes the tightest fit (first among equals), several take greedy chunks
// with reuse, in device order. Writes node c's gpu_free column and pod i's
// gpu_take row.
__device__ __forceinline__ void gpu_bind(const FastScanArgs& a, int i, int u, int c) {
    const float gmem = a.gpu_mem[u];
    const float gcnt = a.gpu_cnt[u];
    float best_free = BIG;
    for (int d = 0; d < a.Gd; ++d) {
        const float free_d = a.gpu_free[(size_t)d * a.N + c];
        if (free_d >= gmem) best_free = fminf(best_free, free_d);
    }
    float assigned = 0.0f, cum = 0.0f;
    for (int d = 0; d < a.Gd; ++d) {
        const float free_d = a.gpu_free[(size_t)d * a.N + c];
        const float fits_d = free_d >= gmem ? 1.0f : 0.0f;
        const float take_tight = fits_d * (free_d == best_free ? 1.0f : 0.0f) * (1.0f - fminf(assigned, 1.0f));
        assigned = assigned + take_tight;
        const float chunks_d = floorf(free_d / fmaxf(gmem, 1.0f));
        const float take_greedy = fminf(fmaxf(gcnt - cum, 0.0f), chunks_d);
        cum = cum + chunks_d;
        float take_d = gcnt == 1.0f ? take_tight : take_greedy;
        take_d = gmem > 0.0f ? take_d : 0.0f;
        a.gpu_free[(size_t)d * a.N + c] = free_d - take_d * gmem;
        a.gpu_take[(size_t)i * a.Gd + d] = take_d;
    }
}

template <bool GPU, bool GC, bool NA, bool TT, bool AV>
__global__ void __launch_bounds__(NT, 1) fast_scan_kernel(FastScanArgs a) {
    __shared__ float buf[MAX_RED][NWARP];
    __shared__ float res[MAX_RED];
    __shared__ float sbuf[NWARP];
    __shared__ int ibuf[NWARP];
    __shared__ int ires;

    const int tid = threadIdx.x;
    const int N = a.N, R = a.R, A = a.A, K = a.K, Z = a.Z, Cs = a.Cs;

    // state init: used <- used0, selector counts <- 0, gpu_free <- gpu0
    for (size_t j = tid; j < (size_t)R * N; j += NT) a.used[j] = a.used0[j];
    for (size_t j = tid; j < (size_t)A * N; j += NT) a.node_cnt[j] = 0.0f;
    for (size_t j = tid; j < (size_t)K * A * Z; j += NT) a.zone_cnt[j] = 0.0f;
    if constexpr (GPU)
        for (size_t j = tid; j < (size_t)a.Gd * N; j += NT) a.gpu_free[j] = a.gpu0[j];
    __syncthreads();

    int all_min[MAX_CS];
    for (int c = 0; c < MAX_CS; ++c) all_min[c] = 0;
    // lo min, hi max, smn min, smx max, any-feasible max, then the
    // NodeAffinity and TaintToleration maxima where the variant has them
    constexpr int NRED = 5 + (NA ? 1 : 0) + (TT ? 1 : 0);
    constexpr int I_NA = 5, I_TT = 5 + (NA ? 1 : 0);
    const int bmode[7] = {0, 1, 0, 1, 1, 1, 1};

    for (int i = 0; i < a.P; ++i) {
        const int u = a.tmpl[i];
        if (a.valid[i] != 1) {
            if (tid == 0) a.chosen[i] = -1;
            continue;  // invalid pods touch no state
        }
        int choice;
        if (a.forced[i] == 1) {
            const int p = a.pin[u];
            choice = p >= 0 ? p : -1;
        } else {
            // --- pass 1: per-constraint min count over eligible nodes
            float min_cnt[MAX_CS];
            bool any_active = false;
            for (int c = 0; c < Cs; ++c) {
                min_cnt[c] = BIG;
                any_active |= a.spr_active[u * Cs + c] == 1;
            }
            if (any_active) {
                for (int n = tid; n < N; n += NT) {
                    const float aff_row = a.aff_mask[(size_t)u * N + n] * a.node_valid[n];
                    for (int c = 0; c < Cs; ++c) {
                        const int uc = u * Cs + c;
                        if (a.spr_active[uc] != 1) continue;
                        float cnt, has_label;
                        sel_cnt(a, a.spr_sel[uc], a.spr_key[uc], n, cnt, has_label);
                        const float elig = aff_row * has_label;
                        min_cnt[c] = fminf(min_cnt[c], elig > 0.0f ? cnt : BIG);
                    }
                }
                block_reduce(min_cnt, all_min, Cs, min_cnt, buf, res);
            }
            bool any_soft = false;
            for (int c = 0; c < Cs; ++c)
                any_soft |= a.spr_active[u * Cs + c] == 1 && a.spr_hard[u * Cs + c] == 0;

            // --- pass 2: share lo/hi over feasible, spread smn/smx over
            // scored, any-feasible, and the score tables' feasible maxima
            float rv[NRED];
            rv[0] = BIG;
            rv[1] = NEG;
            rv[2] = BIG;
            rv[3] = NEG;
            rv[4] = 0.0f;
            if constexpr (NA) rv[I_NA] = NEG;
            if constexpr (TT) rv[I_TT] = NEG;
            for (int n = tid; n < N; n += NT) {
                float feasible, soft_raw, ignored, gc_dyn = 0.0f, gc_has_dev = 0.0f;
                node_filter<GPU, GC>(a, u, n, min_cnt, feasible, soft_raw, ignored, gc_dyn, gc_has_dev);
                if (feasible > 0.0f) {
                    const float sh = share_of<GC>(a, u, n, gc_dyn, gc_has_dev);
                    rv[0] = fminf(rv[0], sh);
                    rv[1] = fmaxf(rv[1], sh);
                    if (ignored == 0.0f) {
                        rv[2] = fminf(rv[2], soft_raw);
                        rv[3] = fmaxf(rv[3], soft_raw);
                    }
                }
                rv[4] = fmaxf(rv[4], feasible);
                if constexpr (NA) rv[I_NA] = fmaxf(rv[I_NA], feasible > 0.0f ? a.na_raw[(size_t)u * N + n] : 0.0f);
                if constexpr (TT) rv[I_TT] = fmaxf(rv[I_TT], feasible > 0.0f ? a.tt_raw[(size_t)u * N + n] : 0.0f);
            }
            block_reduce(rv, bmode, NRED, rv, buf, res);
            const float lo = rv[0], hi = rv[1], smn = rv[2], smx = rv[3];
            const bool any_feasible = rv[4] > 0.0f;
            const float rng = hi - lo;
            float na_max = 0.0f, tt_max = 0.0f;
            if constexpr (NA) na_max = rv[I_NA];
            if constexpr (TT) tt_max = rv[I_TT];

            // --- pass 3: score, then the lowest index among the maxima
            const float cpu_req = a.cpu_nz[u];
            const float mem_req = a.mem_nz[u];
            float best_s = NEG;
            int best_i = N;
            for (int n = tid; n < N; n += NT) {
                float feasible, soft_raw, ignored, gc_dyn = 0.0f, gc_has_dev = 0.0f;
                node_filter<GPU, GC>(a, u, n, min_cnt, feasible, soft_raw, ignored, gc_dyn, gc_has_dev);
                const float alloc_cpu = a.alloc[(size_t)RES_CPU * N + n];
                const float alloc_mem = a.alloc[(size_t)RES_MEMORY * N + n];
                const float used_cpu = a.used[(size_t)RES_CPU * N + n] + cpu_req;
                const float used_mem = a.used[(size_t)RES_MEMORY * N + n] + mem_req;
                const float l_cpu = (alloc_cpu == 0.0f || used_cpu > alloc_cpu)
                                        ? 0.0f
                                        : (alloc_cpu - used_cpu) * MAX_SCORE / fmaxf(alloc_cpu, 1.0f);
                const float l_mem = (alloc_mem == 0.0f || used_mem > alloc_mem)
                                        ? 0.0f
                                        : (alloc_mem - used_mem) * MAX_SCORE / fmaxf(alloc_mem, 1.0f);
                const float least = (l_cpu + l_mem) / 2.0f;
                const float cpu_frac = used_cpu / fmaxf(alloc_cpu, 1.0f);
                const float mem_frac = used_mem / fmaxf(alloc_mem, 1.0f);
                const float balanced = (cpu_frac >= 1.0f || mem_frac >= 1.0f)
                                           ? 0.0f
                                           : (1.0f - fabsf(cpu_frac - mem_frac)) * MAX_SCORE;
                const float sh = share_of<GC>(a, u, n, gc_dyn, gc_has_dev);
                const float share_norm = rng > 0.0f ? (sh - lo) * MAX_SCORE / rng : 0.0f;
                float spread_norm =
                    smx <= 0.0f ? MAX_SCORE : MAX_SCORE * (smx + smn - soft_raw) / fmaxf(smx, 1.0f);
                if (ignored > 0.0f) spread_norm = 0.0f;
                if (!any_soft) spread_norm = 0.0f;
                float score = least + balanced + 2.0f * share_norm + 2.0f * spread_norm;
                if constexpr (NA) {
                    const float na = a.na_raw[(size_t)u * N + n];
                    score = score + (na_max > 0.0f ? na * MAX_SCORE / fmaxf(na_max, 1.0f) : na);
                }
                if constexpr (TT) {
                    const float tt = a.tt_raw[(size_t)u * N + n];
                    score = score + (tt_max > 0.0f ? MAX_SCORE - tt * MAX_SCORE / fmaxf(tt_max, 1.0f) : MAX_SCORE);
                }
                if constexpr (AV) score = score + AVOID_WEIGHT * a.avoid_raw[(size_t)u * N + n];
                better(best_s, best_i, feasible > 0.0f ? score : NEG, n);
            }
            const int best = block_argmax(best_s, best_i, sbuf, ibuf, &ires);
            choice = any_feasible ? best : -1;
        }
        if (tid == 0) a.chosen[i] = choice;

        // --- bind: only the chosen node's column changes
        if (choice >= 0) {
            if (tid < R) a.used[(size_t)tid * N + choice] += a.req[u * R + tid];
            for (int j = tid; j < A; j += NT) {
                const float m = a.matches[(size_t)j * a.U + u];
                a.node_cnt[(size_t)j * N + choice] += m;
                for (int k = 0; k < K; ++k) {
                    const int z = a.zone_idx[(size_t)k * N + choice];
                    if (z >= 0) a.zone_cnt[((size_t)k * A + j) * Z + z] += m;
                }
            }
            // the thread that owns the chosen node packs its devices
            if constexpr (GPU)
                if (tid == choice % NT) gpu_bind(a, i, u, choice);
            __syncthreads();
        }
    }
}

namespace {

typedef cudaError_t (*LaunchFn)(const FastScanArgs&, cudaStream_t);

// Variant index: bit 0 gpu, 1 gc, 2 na, 3 tt, 4 avoid.
template <int V>
cudaError_t launch_variant(const FastScanArgs& a, cudaStream_t stream) {
    constexpr bool GPU = V & 1, GC = V & 2, NA = V & 4, TT = V & 8, AV = V & 16;
    if constexpr (GC && !GPU) {
        return cudaErrorInvalidValue;  // the gpu-count allocatable follows the GPUs
    } else {
        fast_scan_kernel<GPU, GC, NA, TT, AV><<<1, NT, 0, stream>>>(a);
        return cudaGetLastError();
    }
}

template <int... V>
constexpr std::array<LaunchFn, sizeof...(V)> variant_table(std::integer_sequence<int, V...>) {
    return {{&launch_variant<V>...}};
}

constexpr auto kVariants = variant_table(std::make_integer_sequence<int, 32>{});

}  // namespace

extern "C" int fast_scan_launch(const FastScanArgs* args, void* stream) {
    const FastScanArgs& a = *args;
    if (a.R > MAX_R || a.Cs > MAX_CS || a.Gd > MAX_GD || a.gc_row >= a.R) return (int)cudaErrorInvalidValue;
    const int v = (a.has_gpu ? 1 : 0) | (a.gc_row >= 0 ? 2 : 0) | (a.has_na ? 4 : 0) | (a.has_tt ? 8 : 0) |
                  (a.has_avoid ? 16 : 0);
    cudaGetLastError();  // clear a stale error so the check reports this launch
    return (int)kVariants[v](a, (cudaStream_t)stream);
}
