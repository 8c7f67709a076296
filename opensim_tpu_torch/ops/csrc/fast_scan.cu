// Bind-scan kernel for Hopper (sm_90a): the whole pod stream in one launch,
// for one scenario or a grid of them.
//
// Replaces the Pallas megakernel that opensim_tpu/ops/pallas_scan.py:
// _make_kernel generates (reached through run_fast_scan's pl.pallas_call)
// for the flags has_gpu (with gc_row), has_na, has_tt, has_avoid, has_ports,
// has_interpod and has_local: static row gather, NodeResourcesFit (with the
// dynamic gpu-count allocatable), node validity, NodePorts, the
// Open-Gpu-Share filter, the Open-Local filter (LVM in the best VG, one
// exclusive device per volume), PodTopologySpread (hard and soft; hostname
// plus zone keys), InterPodAffinity (required affinity with its bootstrap,
// required anti-affinity, the existing pods' anti terms), least-allocated +
// balanced + Simon share (min-max, with the gpu-count add-back) + spread +
// NodeAffinity + TaintToleration + NodePreferAvoidPods + Open-Local binpack
// + inter-pod preferred scores, selectHost (lowest index among the maxima,
// pins for forced pods) and the bind update of the usage, selector-count,
// host-port, GPU, volume-group, device and inter-pod term state. It also
// replaces that kernel under jax.vmap (opensim_tpu/engine/fastpath.py:
// sweep): block s of the grid runs scenario s.
//
// Variants: the kernel is a template over the eight flags. Each shared
// object holds one instantiation, chosen at compile time by -DFS_VARIANT
// (bit i = flag i in the order of the template; ops/fast_scan.py builds
// the variants a run needs, all at once), so a variant carries no code of a
// feature it lacks and the build does not grow with the number of flags.
//
// What bounds it: not bytes and not operations. A step reads a few hundred
// KB that stay in L2 and does some 70-250 flops per node, but pod i+1 reads
// the state pod i wrote, so the P steps form a serial chain; each step costs
// a fixed number of block-wide barriers and reductions. The design therefore
// keeps the chain inside one persistent CTA (no per-pod launch, no grid
// sync): 1024 threads, thread t owns the nodes n = t (mod 1024), and a step
// is three block reductions plus one barrier after the bind. The state
// (used, node_cnt, zone_cnt, gpu_free, port_used, vg_free, dev_free, the
// inter-pod term counts) lives in global memory and stays in L2. The flag
// branches add no reduction: the NodeAffinity and TaintToleration maxima
// and the binpack and inter-pod scores' ranges ride in the second one, and
// the inter-pod bootstrap reads per-selector totals that the bind keeps
// instead of summing a count row. The GPU, VG and device binds are serial
// loops in the thread that owns the chosen node.
//
// Scenario grid: scenarios are independent chains, so a sweep of S of them
// is S blocks of the same kernel, one per SM at a time (1024 threads at up
// to 64 registers take all of an SM's registers). Block s reads row s of
// valid and forced, shares every template table, and writes its own slice
// of chosen and gpu_take (64-bit offsets: chosen alone is S·P entries). Its
// float state and its rows of node_valid and spr_weight lie in row s of one
// [S, W] arena (ops/fast_scan.py lays it out), so one offset s·W, the same
// for every such buffer, selects the scenario: the argument block stays in
// constant space (__grid_constant__), as in a kernel without a grid, and
// the scan holds one 64-bit offset in registers instead of a pointer per
// buffer. One scan is the grid of S = 1.
//
// Bit-exactness with the plain PyTorch version (ops/fast_scan.py) and the
// JAX reference: every formula is written in the reference's op order,
// every constant is a float literal, and the file is compiled with
// --fmad=false and without fast math, so each + - * / rounds once as an
// IEEE single op (the binpack score's need * size / cap, the VG bind's
// free - lvm * take). Equal scores are the rule on a uniform fleet; one ulp
// would flip a tie. The inter-pod and port sums, dots in the Pallas body,
// add integers below 2^24 (engine/fastpath.why_not), so they are loops
// here over the rows a template touches, exact in any order; so are the
// device counts of the Open-Local filter. Storage byte counts are float32
// as in the reference; GiB multiples stay exact.

#include <cuda_runtime.h>
#include <stdint.h>

#ifndef FS_VARIANT
#error "build one kernel variant per library: nvcc -DFS_VARIANT=<flag bits> (ops/fast_scan.py)"
#endif

#define NT 1024
#define NWARP (NT / 32)
#define MAX_R 8
#define MAX_CS 8
#define MAX_GD 8
#define MAX_DV 64  // devices per node: the bits of the bind's per-pod taken mask
#define MAX_RED 11  // values one block_reduce call takes: max(MAX_CS, 5 + na + tt + 2 local + 2 inter-pod)
#define FULL_MASK 0xffffffffu

namespace {

constexpr float BIG = 1e30f;
constexpr float NEG = -1e30f;
constexpr float MAX_SCORE = 100.0f;
constexpr float AVOID_WEIGHT = 10000.0f;
constexpr int RES_CPU = 0;
constexpr int RES_MEMORY = 1;

}  // namespace

// The scenario this block runs: block s of the grid runs scenario s.
__device__ __forceinline__ size_t scn() { return blockIdx.x; }

// Mirrors the ctypes.Structure in ops/fast_scan.py field for field. The
// per-scenario inputs and every output and state buffer have a leading S
// axis; the shapes below are one scenario's. Those marked "in the arena"
// point into scenario 0's row of the state arena, whose rows are W floats
// apart.
struct FastScanArgs {
    // pod stream: templates [P], per scenario valid and forced [P]
    const int32_t* tmpl;
    const int32_t* valid;
    const int32_t* forced;
    // node tables
    const float* alloc;        // [R, N]
    const float* used0;        // [R, N]
    const float* node_valid;   // [N] per scenario, in the arena
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
    const float* spr_weight;   // [U, Cs] per scenario, in the arena
    // gpu share (has_gpu)
    const float* gpu_mem;      // [U] per-GPU memory request
    const float* gpu_cnt;      // [U] GPUs requested
    const float* gpu0;         // [Gd, N] initial free memory per GPU
    // static score tables (has_na, has_tt, has_avoid)
    const float* na_raw;       // [U, N]
    const float* tt_raw;       // [U, N]
    const float* avoid_raw;    // [U, N]
    // host ports (has_ports)
    const float* port_hu;      // [Hp, U] the template's own port ids
    const float* port_conf;    // [Hp, U] 0/1 port ids that conflict with the template's
    // inter-pod terms of the incoming pod (has_interpod), keys as spr_key
    const int32_t* at_active;  // [U, Ti] required affinity
    const int32_t* at_key;     // [U, Ti]
    const int32_t* at_sel;     // [U, Ti] the conjunction of the template's terms
    const float* at_self;      // [U, Ti] 0/1 the template matches it
    const int32_t* an_active;  // [U, Tn] required anti-affinity
    const int32_t* an_key;     // [U, Tn]
    const int32_t* an_sel;     // [U, Tn]
    const int32_t* pt_active;  // [U, Tp] preferred terms
    const int32_t* pt_key;     // [U, Tp]
    const int32_t* pt_sel;     // [U, Tp]
    const float* pt_w;         // [U, Tp] signed weight
    // existing pods' terms, one row per (selector, key)
    const int32_t* anti_g_key; // [G]
    const float* antig;        // [G, U] 0/1 the template carries anti row g
    const float* gmatch;       // [G, U] 0/1 the template matches row g's selector
    const int32_t* prefg_key;  // [Gp]
    const float* prefg;        // [Gp, U] signed weight the template carries on row g
    const float* pmatch;       // [Gp, U] 0/1 the template matches row g's selector
    // open-local storage (has_local), bytes; media 0 = ssd, 1 = hdd
    const float* lvm_req;      // [U] LVM bytes
    const float* dev_req;      // [U, 2] largest exclusive volume per media
    const float* dev_need;     // [U, 2] exclusive volumes per media
    const float* dev_sizes;    // [U, 2 * Mv] each media's volume sizes, descending, 0-padded
    const float* vg_cap;       // [Vg, N]
    const float* vg0;          // [Vg, N] initial free bytes
    const float* dev_cap;      // [Dv, N]
    const float* dev0;         // [Dv, N] initial free bytes, 0 = taken or absent
    const float* dev_media;    // [2 * Dv, N] 0/1: row m * Dv + d is device d of media m
    // outputs and state, per scenario; all but chosen and gpu_take in the arena
    int32_t* chosen;           // [P]
    float* used;               // [R, N]
    float* node_cnt;           // [A, N]
    float* zone_cnt;           // [K * A, Z]
    float* gpu_take;           // [P, Gd] written for bound pods only
    float* gpu_free;           // [Gd, N]
    float* port_used;          // [Hp, N]
    float* anti_node;          // [G, N]
    float* anti_zone;          // [G, Z] each row under its own key
    float* prefw_node;         // [Gp, N]
    float* prefw_zone;         // [Gp, Z] each row under its own key
    float* sel_total;          // [(K + 1) * A] bound pods per selector: all, then on nodes labelled with key k
    float* vg_free;            // [Vg, N]
    float* dev_free;           // [Dv, N]
    int64_t W;                 // floats per scenario in the arena
    int32_t S, P, N, R, U, A, K, Z, Cs, Gd, gc_row, Hp, Ti, Tn, Tp, G, Gp, Vg, Dv, Mv;
    int32_t has_gpu, has_na, has_tt, has_avoid, has_ports, has_interpod, has_local;
};

__device__ __forceinline__ float warp_min(float v) {
    for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(FULL_MASK, v, o));
    return v;
}

__device__ __forceinline__ float warp_max(float v) {
    for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL_MASK, v, o));
    return v;
}

// Offset of this block's scenario in the state arena.
__device__ __forceinline__ size_t sw(const FastScanArgs& a) { return scn() * a.W; }

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
        cnt = a.node_cnt[sw(a) + (size_t)sel * a.N + n];
        has_label = 1.0f;
        return;
    }
    const int k = key - 1;
    const int z = a.zone_idx[(size_t)k * a.N + n];
    cnt = z >= 0 ? a.zone_cnt[sw(a) + ((size_t)k * a.A + sel) * a.Z + z] : 0.0f;
    has_label = z >= 0 ? 1.0f : 0.0f;
}

// Row g of an inter-pod term table at node n: its node row for a hostname
// row (key 0), else its zone row under its own key, 0 where node n lacks
// that label.
__device__ __forceinline__ float term_cnt(const FastScanArgs& a, const float* node_rows, const float* zone_rows,
                                          int g, int key, int n) {
    if (key == 0) return node_rows[(size_t)g * a.N + n];
    const int z = a.zone_idx[(size_t)(key - 1) * a.N + n];
    return z >= 0 ? zone_rows[(size_t)g * a.Z + z] : 0.0f;
}

// Bind of row g with value v at node c: its node column, and its zone
// column under its own key where node c carries the label (pallas_scan.py:
// 836-854 adds a_col * key_mask * the zone one-hot).
__device__ __forceinline__ void term_bind(const FastScanArgs& a, float* node_rows, float* zone_rows, int g,
                                          int key, int c, float v) {
    node_rows[(size_t)g * a.N + c] += v;
    if (key == 0) return;
    const int z = a.zone_idx[(size_t)(key - 1) * a.N + c];
    if (z >= 0) zone_rows[(size_t)g * a.Z + z] += v;
}

// Dynamic gpu-count allocatable of node n (pallas_scan.py:401-412): the
// count of its devices with free memory left, and whether it has devices.
__device__ __forceinline__ void gc_node(const FastScanArgs& a, int n, float& dyn, float& has_dev) {
    dyn = 0.0f;
    has_dev = 0.0f;
    for (int d = 0; d < a.Gd; ++d) {
        const float valid_d = a.gpu0[(size_t)d * a.N + n] > 0.0f ? 1.0f : 0.0f;
        const float free_d = a.gpu_free[sw(a) + (size_t)d * a.N + n] > 0.0f ? 1.0f : 0.0f;
        dyn = dyn + valid_d * free_d;
        has_dev = fmaxf(has_dev, valid_d);
    }
}

// Inter-pod terms of template u at node n (pallas_scan.py:503-586): the
// filter factor (0 or 1) of the incoming required anti-affinity terms, the
// incoming required affinity terms with the bootstrap (`at_bootstrap`, the
// same for every node), and the existing pods' anti terms against this
// pod; `ip_raw` gets the raw preferred score, the incoming preferred terms
// plus the existing pods' preferred and hard-affinity weights. Rows whose
// selector the template does not match add exact zeros in the Pallas dots
// and are skipped.
__device__ __forceinline__ float interpod_node(const FastScanArgs& a, int u, int n, float at_bootstrap,
                                               float& ip_raw) {
    float ok = 1.0f;
    for (int t = 0; t < a.Tn; ++t) {
        const int ut = u * a.Tn + t;
        if (a.an_active[ut] != 1) continue;
        float cnt, has_label;
        sel_cnt(a, a.an_sel[ut], a.an_key[ut], n, cnt, has_label);
        ok = ok * (1.0f - ((cnt > 0.0f && has_label > 0.0f) ? 1.0f : 0.0f));
    }
    float at_all_ok = 1.0f, at_labels_ok = 1.0f;
    for (int t = 0; t < a.Ti; ++t) {
        const int ut = u * a.Ti + t;
        if (a.at_active[ut] != 1) continue;
        float cnt, has_label;
        sel_cnt(a, a.at_sel[ut], a.at_key[ut], n, cnt, has_label);
        at_all_ok = at_all_ok * ((cnt > 0.0f && has_label > 0.0f) ? 1.0f : 0.0f);
        at_labels_ok = at_labels_ok * (has_label > 0.0f ? 1.0f : 0.0f);
    }
    ok = ok * fmaxf(at_all_ok, at_labels_ok * at_bootstrap);
    float sym_cnt = 0.0f;
    for (int g = 0; g < a.G; ++g) {
        const float m = a.gmatch[(size_t)g * a.U + u];
        if (m != 0.0f)
            sym_cnt = sym_cnt + m * term_cnt(a, a.anti_node + sw(a), a.anti_zone + sw(a), g, a.anti_g_key[g], n);
    }
    ok = ok * (1.0f - (sym_cnt > 0.0f ? 1.0f : 0.0f));
    float ip = 0.0f;
    for (int t = 0; t < a.Tp; ++t) {
        const int ut = u * a.Tp + t;
        if (a.pt_active[ut] != 1) continue;
        float cnt, has_label;
        sel_cnt(a, a.pt_sel[ut], a.pt_key[ut], n, cnt, has_label);
        ip = ip + cnt * a.pt_w[ut] * has_label;
    }
    for (int g = 0; g < a.Gp; ++g) {
        const float m = a.pmatch[(size_t)g * a.U + u];
        if (m != 0.0f)
            ip = ip + m * term_cnt(a, a.prefw_node + sw(a), a.prefw_zone + sw(a), g, a.prefg_key[g], n);
    }
    ip_raw = ip;
    return ok;
}

// Whether device d of media m at node n is free, fits `size` bytes and is
// of that media (pallas_scan.py:474, :692, :812-815 without the taken mask).
__device__ __forceinline__ bool dev_fits(const FastScanArgs& a, int m, int d, int n, float size, float& free_d) {
    free_d = a.dev_free[sw(a) + (size_t)d * a.N + n];
    return a.dev_media[((size_t)m * a.Dv + d) * a.N + n] > 0.0f && free_d >= size && free_d > 0.0f;
}

// Open-Local filter of template u at node n (pallas_scan.py:455-477): the
// LVM request fits the VG with the most free bytes, and for each media the
// i-th largest exclusive volume finds at least i + 1 free devices that fit
// it. Volume slots of size 0 (padding) pass, as in the reference.
__device__ __forceinline__ float local_filter(const FastScanArgs& a, int u, int n) {
    const float lvm = a.lvm_req[u];
    if (lvm > 0.0f) {
        float best = NEG;
        for (int v = 0; v < a.Vg; ++v) best = fmaxf(best, a.vg_free[sw(a) + (size_t)v * a.N + n]);
        if (!(best >= lvm)) return 0.0f;
    }
    for (int m = 0; m < 2; ++m) {
        for (int vi = 0; vi < a.Mv; ++vi) {
            const float size = a.dev_sizes[(size_t)u * 2 * a.Mv + m * a.Mv + vi];
            if (!(size > 0.0f)) continue;
            int cnt_fit = 0;
            for (int d = 0; d < a.Dv; ++d) {
                float free_d;
                cnt_fit += dev_fits(a, m, d, n, size, free_d) ? 1 : 0;
            }
            if (cnt_fit < vi + 1) return 0.0f;
        }
    }
    return 1.0f;
}

// Open-Local binpack raw score of template u at node n (pallas_scan.py:
// 668-698): the mean over the pod's storage units of request / capacity of
// the unit it would take (the tightest fitting VG; per media, the
// smallest-capacity fitting device, for need volumes of the largest size),
// times 10. A template with no storage has count 0 and scores 0; the terms
// the reference multiplies by 0 are skipped.
__device__ __forceinline__ float local_raw_of(const FastScanArgs& a, int u, int n) {
    const float lvm = a.lvm_req[u];
    float parts = 0.0f, count = 0.0f;
    if (lvm > 0.0f) {
        float best_free = BIG, best_cap = 0.0f;
        for (int v = 0; v < a.Vg; ++v) {
            const float free_v = a.vg_free[sw(a) + (size_t)v * a.N + n];
            if (free_v >= lvm && free_v < best_free) {
                best_free = free_v;
                best_cap = a.vg_cap[(size_t)v * a.N + n];
            }
        }
        parts = best_free < BIG ? lvm / fmaxf(best_cap, 1.0f) : 0.0f;
        count = 1.0f;
    }
    for (int m = 0; m < 2; ++m) {
        const float size = a.dev_req[u * 2 + m];
        if (!(size > 0.0f)) continue;
        const float need = a.dev_need[u * 2 + m];
        float first_cap = BIG;
        for (int d = 0; d < a.Dv; ++d) {
            float free_d;
            if (dev_fits(a, m, d, n, size, free_d)) first_cap = fminf(first_cap, a.dev_cap[(size_t)d * a.N + n]);
        }
        parts = parts + need * size / fmaxf(first_cap, 1.0f);
        count = count + need;
    }
    return count > 0.0f ? parts / fmaxf(count, 1.0f) * 10.0f : 0.0f;
}

// Open-Local bind of template u on node c (pallas_scan.py:783-835): the LVM
// request goes to the tightest VG that fits (first among equals); the
// exclusive volumes, each media in ascending size, each to the
// smallest-capacity candidate this pod has not taken yet (ties to the
// lowest index), whose free bytes become 0. Writes node c's vg_free and
// dev_free columns.
__device__ __forceinline__ void local_bind(const FastScanArgs& a, int u, int c) {
    const size_t N = a.N;
    const float lvm = a.lvm_req[u];
    if (lvm > 0.0f) {  // lvm = 0 would subtract 0 from one VG
        float best_free = BIG;
        for (int v = 0; v < a.Vg; ++v) {
            const float free_v = a.vg_free[sw(a) + v * N + c];
            if (free_v >= lvm) best_free = fminf(best_free, free_v);
        }
        float taken_vg = 0.0f;
        for (int v = 0; v < a.Vg; ++v) {
            const float free_v = a.vg_free[sw(a) + v * N + c];
            const float take_v = (free_v >= lvm && free_v == best_free ? 1.0f : 0.0f) * (1.0f - fminf(taken_vg, 1.0f));
            taken_vg = taken_vg + take_v;
            a.vg_free[sw(a) + v * N + c] = free_v - fmaxf(lvm, 0.0f) * take_v;
        }
    }
    unsigned long long taken = 0ull;  // devices this pod took, bit d
    for (int m = 0; m < 2; ++m) {
        for (int vi = a.Mv - 1; vi >= 0; --vi) {  // ascending sizes
            const float size = a.dev_sizes[(size_t)u * 2 * a.Mv + m * a.Mv + vi];
            if (!(size > 0.0f)) continue;
            float best_cap = BIG;
            for (int d = 0; d < a.Dv; ++d) {
                float free_d;
                if (!(taken >> d & 1ull) && dev_fits(a, m, d, c, size, free_d))
                    best_cap = fminf(best_cap, a.dev_cap[d * N + c]);
            }
            for (int d = 0; d < a.Dv; ++d) {
                float free_d;
                if (!(taken >> d & 1ull) && dev_fits(a, m, d, c, size, free_d) && a.dev_cap[d * N + c] == best_cap) {
                    taken |= 1ull << d;
                    a.dev_free[sw(a) + d * N + c] = 0.0f;  // free_d * (1 - 1): free_d > 0, so +0
                    break;
                }
            }
        }
    }
}

// Filter, soft-spread raw score and inter-pod raw score of node n for
// template u, given the per-constraint minimum counts (pallas_scan.py:
// 400-586), plus node n's dynamic gpu-count state for the share add-back.
template <bool GPU, bool GC, bool PORTS, bool IP, bool LOC>
__device__ __forceinline__ void node_filter(const FastScanArgs& a, int u, int n, const float* min_cnt,
                                            float at_bootstrap, float& feasible, float& soft_raw,
                                            float& ignored, float& gc_dyn, float& gc_has_dev, float& ip_raw) {
    const float valid_row = a.node_valid[sw(a) + n];
    if constexpr (GC) gc_node(a, n, gc_dyn, gc_has_dev);
    float fit = 1.0f;
    for (int r = 0; r < a.R; ++r) {
        const float req_r = a.req[u * a.R + r];
        float alloc_r = a.alloc[(size_t)r * a.N + n];
        if constexpr (GC)
            if (r == a.gc_row) alloc_r = gc_has_dev > 0.0f ? gc_dyn : alloc_r;
        const float over = (a.used[sw(a) + (size_t)r * a.N + n] + req_r > alloc_r) ? 1.0f : 0.0f;
        fit = fit * (req_r > 0.0f ? 1.0f - over : 1.0f);
    }
    feasible = a.static_pass[(size_t)u * a.N + n] * fit * valid_row;
    if constexpr (PORTS) {
        // NodePorts: a conflicting port id already used on the node
        float conflicts = 0.0f;
        for (int h = 0; h < a.Hp; ++h) {
            const float mine = a.port_conf[(size_t)h * a.U + u];
            if (mine != 0.0f)
                conflicts = conflicts + mine * (a.port_used[sw(a) + (size_t)h * a.N + n] > 0.0f ? 1.0f : 0.0f);
        }
        feasible = feasible * (conflicts == 0.0f ? 1.0f : 0.0f);
    }
    if constexpr (GPU) {
        // Open-Gpu-Share filter: sum_d floor(free_d / mem) >= count
        const float gmem = a.gpu_mem[u];
        const float gcnt = a.gpu_cnt[u];
        if (gmem > 0.0f) {
            const float gmem1 = fmaxf(gmem, 1.0f);
            float chunks_sum = 0.0f;
            for (int d = 0; d < a.Gd; ++d)
                chunks_sum = chunks_sum + floorf(a.gpu_free[sw(a) + (size_t)d * a.N + n] / gmem1);
            const bool gpu_ok = chunks_sum >= gcnt && gcnt > 0.0f;
            feasible = feasible * (gpu_ok ? 1.0f : 0.0f);
        }
    }
    if constexpr (LOC) feasible = feasible * local_filter(a, u, n);
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
            const float contrib = has_label > 0.0f ? cnt * a.spr_weight[sw(a) + uc] + (skew - 1.0f) : 0.0f;
            soft_raw = soft_raw + contrib;
            ignored = fmaxf(ignored, 1.0f - has_label);
        }
    }
    if constexpr (IP) feasible = feasible * interpod_node(a, u, n, at_bootstrap, ip_raw);
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
        const float free_d = a.gpu_free[sw(a) + (size_t)d * a.N + c];
        if (free_d >= gmem) best_free = fminf(best_free, free_d);
    }
    float assigned = 0.0f, cum = 0.0f;
    for (int d = 0; d < a.Gd; ++d) {
        const float free_d = a.gpu_free[sw(a) + (size_t)d * a.N + c];
        const float fits_d = free_d >= gmem ? 1.0f : 0.0f;
        const float take_tight = fits_d * (free_d == best_free ? 1.0f : 0.0f) * (1.0f - fminf(assigned, 1.0f));
        assigned = assigned + take_tight;
        const float chunks_d = floorf(free_d / fmaxf(gmem, 1.0f));
        const float take_greedy = fminf(fmaxf(gcnt - cum, 0.0f), chunks_d);
        cum = cum + chunks_d;
        float take_d = gcnt == 1.0f ? take_tight : take_greedy;
        take_d = gmem > 0.0f ? take_d : 0.0f;
        a.gpu_free[sw(a) + (size_t)d * a.N + c] = free_d - take_d * gmem;
        a.gpu_take[(scn() * a.P + i) * a.Gd + d] = take_d;
    }
}

// Block s of the grid runs scenario s over the whole pod stream: it reads
// row s of the per-scenario inputs and writes its own slice of every output
// and state buffer. One scan (fast_scan) is the grid of one block and goes
// through the same offsets.
template <bool GPU, bool GC, bool NA, bool TT, bool AV, bool PORTS, bool IP, bool LOC>
__global__ void __launch_bounds__(NT, 1) fast_scan_kernel(const __grid_constant__ FastScanArgs a) {
    static_assert(GPU || !GC, "the gpu-count allocatable follows the GPUs");
    __shared__ float buf[MAX_RED][NWARP];
    __shared__ float res[MAX_RED];
    __shared__ float sbuf[NWARP];
    __shared__ int ibuf[NWARP];
    __shared__ int ires;

    const int tid = threadIdx.x;
    const int N = a.N, R = a.R, A = a.A, K = a.K, Z = a.Z, Cs = a.Cs;
    const size_t sP = scn() * a.P;

    // state init of this scenario's slice: used <- used0, counts <- 0, gpu_free <- gpu0, vg_free <-
    // vg0, dev_free <- dev0
    for (size_t j = tid; j < (size_t)R * N; j += NT) a.used[sw(a) + j] = a.used0[j];
    for (size_t j = tid; j < (size_t)A * N; j += NT) a.node_cnt[sw(a) + j] = 0.0f;
    for (size_t j = tid; j < (size_t)K * A * Z; j += NT) a.zone_cnt[sw(a) + j] = 0.0f;
    if constexpr (GPU)
        for (size_t j = tid; j < (size_t)a.Gd * N; j += NT) a.gpu_free[sw(a) + j] = a.gpu0[j];
    if constexpr (PORTS)
        for (size_t j = tid; j < (size_t)a.Hp * N; j += NT) a.port_used[sw(a) + j] = 0.0f;
    if constexpr (IP) {
        for (size_t j = tid; j < (size_t)a.G * N; j += NT) a.anti_node[sw(a) + j] = 0.0f;
        for (size_t j = tid; j < (size_t)a.G * Z; j += NT) a.anti_zone[sw(a) + j] = 0.0f;
        for (size_t j = tid; j < (size_t)a.Gp * N; j += NT) a.prefw_node[sw(a) + j] = 0.0f;
        for (size_t j = tid; j < (size_t)a.Gp * Z; j += NT) a.prefw_zone[sw(a) + j] = 0.0f;
        for (size_t j = tid; j < (size_t)(K + 1) * A; j += NT) a.sel_total[sw(a) + j] = 0.0f;
    }
    if constexpr (LOC) {
        for (size_t j = tid; j < (size_t)a.Vg * N; j += NT) a.vg_free[sw(a) + j] = a.vg0[j];
        for (size_t j = tid; j < (size_t)a.Dv * N; j += NT) a.dev_free[sw(a) + j] = a.dev0[j];
    }
    __syncthreads();

    int all_min[MAX_CS];
    for (int c = 0; c < MAX_CS; ++c) all_min[c] = 0;
    // lo min, hi max, smn min, smx max, any-feasible max, then the
    // NodeAffinity and TaintToleration maxima, the binpack score's min and
    // max and the inter-pod score's max and min where the variant has them
    constexpr int I_NA = 5, I_TT = I_NA + (NA ? 1 : 0), I_LOC = I_TT + (TT ? 1 : 0);
    constexpr int I_IP = I_LOC + (LOC ? 2 : 0);
    constexpr int NRED = I_IP + (IP ? 2 : 0);
    int bmode[MAX_RED] = {0, 1, 0, 1, 1, 0, 0, 0, 0, 0, 0};
    if constexpr (NA) bmode[I_NA] = 1;
    if constexpr (TT) bmode[I_TT] = 1;
    if constexpr (LOC) bmode[I_LOC + 1] = 1;
    if constexpr (IP) bmode[I_IP] = 1;

    for (int i = 0; i < a.P; ++i) {
        const int u = a.tmpl[i];
        if (a.valid[sP + i] != 1) {
            if (tid == 0) a.chosen[sP + i] = -1;
            continue;  // invalid pods touch no state
        }
        int choice;
        if (a.forced[sP + i] == 1) {
            const int p = a.pin[u];
            choice = p >= 0 ? p : -1;
        } else {
            // --- the inter-pod bootstrap (pallas_scan.py:520-542): no pod
            // yet matches the affinity terms anywhere and the pod matches
            // them itself. The same for every node and thread.
            float at_bootstrap = 0.0f;
            if constexpr (IP) {
                float map_total = 0.0f, self_all = 1.0f;
                for (int t = 0; t < a.Ti; ++t) {
                    const int ut = u * a.Ti + t;
                    if (a.at_active[ut] != 1) continue;
                    map_total = map_total + a.sel_total[sw(a) + (size_t)a.at_key[ut] * A + a.at_sel[ut]];
                    self_all = self_all * (a.at_self[ut] > 0.0f ? 1.0f : 0.0f);
                }
                at_bootstrap = (map_total == 0.0f && self_all > 0.0f) ? 1.0f : 0.0f;
            }

            // --- pass 1: per-constraint min count over eligible nodes
            float min_cnt[MAX_CS];
            bool any_active = false;
            for (int c = 0; c < Cs; ++c) {
                min_cnt[c] = BIG;
                any_active |= a.spr_active[u * Cs + c] == 1;
            }
            if (any_active) {
                for (int n = tid; n < N; n += NT) {
                    const float aff_row = a.aff_mask[(size_t)u * N + n] * a.node_valid[sw(a) + n];
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
            // scored, any-feasible, the score tables' feasible maxima, the
            // binpack score's feasible range, and the inter-pod score's
            // range with both ends seeded at 0
            float rv[NRED];
            rv[0] = BIG;
            rv[1] = NEG;
            rv[2] = BIG;
            rv[3] = NEG;
            rv[4] = 0.0f;
            if constexpr (NA) rv[I_NA] = NEG;
            if constexpr (TT) rv[I_TT] = NEG;
            if constexpr (LOC) {
                rv[I_LOC] = BIG;
                rv[I_LOC + 1] = NEG;
            }
            if constexpr (IP) {
                rv[I_IP] = 0.0f;
                rv[I_IP + 1] = 0.0f;
            }
            for (int n = tid; n < N; n += NT) {
                float feasible, soft_raw, ignored, gc_dyn = 0.0f, gc_has_dev = 0.0f, ip = 0.0f;
                node_filter<GPU, GC, PORTS, IP, LOC>(a, u, n, min_cnt, at_bootstrap, feasible, soft_raw, ignored,
                                                     gc_dyn, gc_has_dev, ip);
                if (feasible > 0.0f) {
                    const float sh = share_of<GC>(a, u, n, gc_dyn, gc_has_dev);
                    rv[0] = fminf(rv[0], sh);
                    rv[1] = fmaxf(rv[1], sh);
                    if (ignored == 0.0f) {
                        rv[2] = fminf(rv[2], soft_raw);
                        rv[3] = fmaxf(rv[3], soft_raw);
                    }
                    if constexpr (LOC) {
                        const float lr = local_raw_of(a, u, n);
                        rv[I_LOC] = fminf(rv[I_LOC], lr);
                        rv[I_LOC + 1] = fmaxf(rv[I_LOC + 1], lr);
                    }
                }
                rv[4] = fmaxf(rv[4], feasible);
                if constexpr (NA) rv[I_NA] = fmaxf(rv[I_NA], feasible > 0.0f ? a.na_raw[(size_t)u * N + n] : 0.0f);
                if constexpr (TT) rv[I_TT] = fmaxf(rv[I_TT], feasible > 0.0f ? a.tt_raw[(size_t)u * N + n] : 0.0f);
                if constexpr (IP) {
                    const float ip_masked = feasible > 0.0f ? ip : 0.0f;
                    rv[I_IP] = fmaxf(rv[I_IP], ip_masked);
                    rv[I_IP + 1] = fminf(rv[I_IP + 1], ip_masked);
                }
            }
            block_reduce(rv, bmode, NRED, rv, buf, res);
            const float lo = rv[0], hi = rv[1], smn = rv[2], smx = rv[3];
            const bool any_feasible = rv[4] > 0.0f;
            const float rng = hi - lo;
            float na_max = 0.0f, tt_max = 0.0f, l_lo = 0.0f, l_rng = 0.0f, ip_lo = 0.0f, ip_rng = 0.0f;
            if constexpr (NA) na_max = rv[I_NA];
            if constexpr (TT) tt_max = rv[I_TT];
            if constexpr (LOC) {
                l_lo = rv[I_LOC];
                l_rng = rv[I_LOC + 1] - l_lo;
            }
            if constexpr (IP) {
                ip_lo = rv[I_IP + 1];
                ip_rng = rv[I_IP] - ip_lo;
            }

            // --- pass 3: score, then the lowest index among the maxima
            const float cpu_req = a.cpu_nz[u];
            const float mem_req = a.mem_nz[u];
            float best_s = NEG;
            int best_i = N;
            for (int n = tid; n < N; n += NT) {
                float feasible, soft_raw, ignored, gc_dyn = 0.0f, gc_has_dev = 0.0f, ip = 0.0f;
                node_filter<GPU, GC, PORTS, IP, LOC>(a, u, n, min_cnt, at_bootstrap, feasible, soft_raw, ignored,
                                                     gc_dyn, gc_has_dev, ip);
                const float alloc_cpu = a.alloc[(size_t)RES_CPU * N + n];
                const float alloc_mem = a.alloc[(size_t)RES_MEMORY * N + n];
                const float used_cpu = a.used[sw(a) + (size_t)RES_CPU * N + n] + cpu_req;
                const float used_mem = a.used[sw(a) + (size_t)RES_MEMORY * N + n] + mem_req;
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
                if constexpr (LOC)
                    score = score + (l_rng > 0.0f ? (local_raw_of(a, u, n) - l_lo) * MAX_SCORE / l_rng : 0.0f);
                if constexpr (IP)
                    score = score + (ip_rng > 0.0f ? MAX_SCORE * (ip - ip_lo) / fmaxf(ip_rng, 1.0f) : 0.0f);
                better(best_s, best_i, feasible > 0.0f ? score : NEG, n);
            }
            const int best = block_argmax(best_s, best_i, sbuf, ibuf, &ires);
            choice = any_feasible ? best : -1;
        }
        if (tid == 0) a.chosen[sP + i] = choice;

        // --- bind: only the chosen node's column changes (and the
        // per-selector totals); each thread writes its own rows
        if (choice >= 0) {
            if (tid < R) a.used[sw(a) + (size_t)tid * N + choice] += a.req[u * R + tid];
            for (int j = tid; j < A; j += NT) {
                const float m = a.matches[(size_t)j * a.U + u];
                a.node_cnt[sw(a) + (size_t)j * N + choice] += m;
                if constexpr (IP) a.sel_total[sw(a) + j] += m;
                for (int k = 0; k < K; ++k) {
                    const int z = a.zone_idx[(size_t)k * N + choice];
                    if (z >= 0) {
                        a.zone_cnt[sw(a) + ((size_t)k * A + j) * Z + z] += m;
                        if constexpr (IP) a.sel_total[sw(a) + (size_t)(k + 1) * A + j] += m;
                    }
                }
            }
            // the template's own ports, not the conflict rows
            if constexpr (PORTS)
                for (int h = tid; h < a.Hp; h += NT)
                    a.port_used[sw(a) + (size_t)h * N + choice] += a.port_hu[(size_t)h * a.U + u];
            if constexpr (IP) {
                for (int g = tid; g < a.G; g += NT)
                    term_bind(a, a.anti_node + sw(a), a.anti_zone + sw(a), g, a.anti_g_key[g], choice,
                              a.antig[(size_t)g * a.U + u]);
                for (int g = tid; g < a.Gp; g += NT)
                    term_bind(a, a.prefw_node + sw(a), a.prefw_zone + sw(a), g, a.prefg_key[g], choice,
                              a.prefg[(size_t)g * a.U + u]);
            }
            // the thread that owns the chosen node packs its GPUs, volume
            // groups and devices
            if (tid == choice % NT) {
                if constexpr (GPU) gpu_bind(a, i, u, choice);
                if constexpr (LOC) local_bind(a, u, choice);
            }
            __syncthreads();
        }
    }
}

extern "C" int fast_scan_launch(const FastScanArgs* args, void* stream) {
    constexpr int V = FS_VARIANT;
    const FastScanArgs& a = *args;
    if (a.S < 1 || a.R > MAX_R || a.Cs > MAX_CS || a.Gd > MAX_GD || a.Dv > MAX_DV || a.gc_row >= a.R)
        return (int)cudaErrorInvalidValue;
    const int v = (a.has_gpu ? 1 : 0) | (a.gc_row >= 0 ? 2 : 0) | (a.has_na ? 4 : 0) | (a.has_tt ? 8 : 0) |
                  (a.has_avoid ? 16 : 0) | (a.has_ports ? 32 : 0) | (a.has_interpod ? 64 : 0) |
                  (a.has_local ? 128 : 0);
    if (v != V) return (int)cudaErrorInvalidValue;  // this library holds one variant
    cudaGetLastError();  // clear a stale error so the check reports this launch
    fast_scan_kernel<(V & 1) != 0, (V & 2) != 0, (V & 4) != 0, (V & 8) != 0, (V & 16) != 0, (V & 32) != 0,
                     (V & 64) != 0, (V & 128) != 0><<<a.S, NT, 0, (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
}
