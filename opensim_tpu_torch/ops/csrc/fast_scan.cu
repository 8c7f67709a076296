// Bind-scan kernels for Hopper (sm_90a): the whole pod stream in one launch,
// for one scenario (fast_scan_kernel) or a grid of them
// (fast_scan_sweep_kernel).
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
// host-port, GPU, volume-group, device and inter-pod term state. The sweep
// kernel replaces that kernel under jax.vmap (opensim_tpu/engine/fastpath.py:
// sweep).
//
// Variants: both kernels are templates over the eight feature flags, then
// CFG (a scheduler config), EXPLAIN (explain mode's counts on every step),
// for the one scan SAMPLE (the sampled tie-break) and for the grid COUNT
// (the counts of the steps that find no node). Each shared object holds one
// instantiation of each (a COUNT object the grid's alone, a SAMPLE object
// the one scan's alone), chosen at compile time by
// -DFS_VARIANT (bit i = flag i in the order of the template;
// ops/fast_scan.py builds the variants a run needs, all at once), so a
// variant carries no code of a feature it lacks and the build does not
// grow with the number of flags.
//
// One scan. What bounds it: not bytes and not operations. A step reads a few
// hundred KB and does some 70-250 flops per node, but pod i+1 reads the
// state pod i wrote, so the P steps form a serial chain, and a step's cost
// is its latency: its node passes, its reductions over the node axis and
// the serial bind. The design keeps the chain in one persistent launch (no
// per-pod launch, no grid sync) and spreads the node axis over a
// thread-block cluster of CL CTAs on CL SMs: CTA r owns the contiguous
// slice of Nc = ceil(N / CL) nodes from r·Nc, one or two nodes a thread,
// and keeps the slice's per-node state (used, node counts, GPU, port,
// inter-pod node rows, VG and device state) and constant node tables
// (allocatable, zone columns, validity, GPU presence, storage tables) in
// its shared memory for the whole scan, so a node visit is a chain of
// shared-memory loads, not of L2 round trips; each CTA keeps a copy of the
// small state every bind touches (zone counts, inter-pod zone rows,
// per-selector totals). A reduction over the node axis is warp shuffles, a
// value per warp in shared memory, each CTA's partial, one cluster barrier,
// then every warp reads the CL partials through distributed shared memory
// (Slice, cluster_reduce, cluster_argmax). A step is two such reductions
// (pass 2's values, selectHost) plus the barrier after the bind, and a
// third for hard spread constraints: pass 1 runs only for them, as its
// minimum is read by nothing else. Pass 2 leaves each owned node's
// feasibility and score values in registers (Kept), so pass 3 neither
// re-runs the filters nor scores an infeasible node. What bounds the step
// now: the cluster barriers, the distributed-shared-memory reads after
// them and the serial bind. A slice past the shared memory keeps its state
// in global memory (Slice<0>), so every N runs. The flag branches add no
// reduction: the NodeAffinity and TaintToleration maxima and the binpack
// and inter-pod scores' ranges ride in pass 2's, and the inter-pod
// bootstrap reads per-selector totals that the bind keeps instead of
// summing a count row. The GPU, VG and device binds are serial loops in the
// thread that owns the chosen node.
//
// Failure attribution. A step whose pod finds no node (pass 2's reduction
// says so, the same in every CTA) skips pass 3 and runs the counting pass
// instead (count_fails, kernels.pod_step's count_fails in the JAX package,
// which runs outside its Pallas kernel): each CTA walks its slice once,
// takes each filter's own verdict from node_feasible (the same helpers and
// float expressions as the feasibility test), attributes each node to the
// first filter it fails in the reference's order, sums the counts over the
// block and then over the cluster through distributed shared memory
// (integer sums, exact in any order), and CTA 0 writes the pod's row. It is
// a function of its own, not inlined, so a step that succeeds pays for it
// neither in time nor in registers.
//
// Explain mode (variant flag EXPLAIN: simulate(explain=True), and the
// grid's for a request batch with an explain rider).
// The reference leaves its Pallas kernel for its XLA scan, whose step
// counts every pod that runs the pipeline (opensim_tpu/ops/kernels.py:
// pod_step's count_all): valid or not, bound or not, only forced pods skip
// it. The EXPLAIN variant runs the counting pass on every such step, right
// after pass 1 (its spread minima are this step's) and before pass 2, pass
// 3 and the bind, so the counts are taken against the state before the
// step's bind and no value of pass 2 is live across the call; a step that
// finds no node does not count again. An invalid pod that is not forced
// runs pass 1 and the count, binds nothing, and pays a cluster barrier so
// that the next counting pass writes its partials only after CTA 0 has
// read these. The other variants compile as before: the flag is a template
// parameter, and every branch on it is folded away.
//
// The grid's counts (variant flags COUNT and EXPLAIN of the sweep kernel: a
// request batch, engine/reqbatch.py, whose riders need their reasons, as
// the reference's batch vmaps its XLA scan with count_fails or count_all,
// opensim_tpu/engine/reqbatch.py: _batched_schedule). These variants run
// one scenario a block (the host gives them B = 1, so S scenarios are S
// blocks in waves of one a SM), and the counting pass is count_fails's
// loop over a one-slot view of the block's scenario (OneSlot, the same
// node_feasible verdicts), all N nodes walked by the block and summed over
// its warps in the first level's scratch, which is free between the
// step's reductions. COUNT counts a step whose pod finds no node, after
// pass 2's reduction says so; EXPLAIN counts every step not forced, valid
// or not, after pass 1 and before pass 2, and an invalid pod then skips
// pass 2, pass 3 and the bind. So the counts are the one scan's with the
// scenario's masks. The variants the sweep consumers launch compile as
// before: both flags are template parameters.
//
// Scenario grid. Scenarios are independent chains over the same pod stream,
// so block b runs B of them (scenarios b·B ... b·B + B - 1; the host picks
// B = ceil(S / SMs), at most BMAX = 4, so 132 scenarios run one to a block
// and 1,000 run as 250 blocks in two waves) in lockstep through the
// same pod, as jax.vmap runs them on the TPU: 512 threads a block. A thread
// loads node n's template-level values (static row, share, allocatable,
// zone columns, score tables, GPU presence) once per node visit, and each
// helper loops over the fields outside and the B slots inside, so the B
// scenarios' loads of one field are in flight together. The step's spread
// constraints and each slot's spread weights are staged in shared memory
// once per step; the block pays one set of barriers per step for all B.
// Per-scenario control (valid, forced, pin, bootstrap, bind) is a bit per
// slot; a slot whose pod is invalid or forced adds nothing to the
// reductions. Each reduction's first level is warp shuffles per (scenario,
// value), its second level spread over the warps, one value per warp. What
// bounds it: instruction throughput and latency, not bytes. A node-slot
// costs some 200 instructions a step (six IEEE divides among them) in
// chains of dependent loads that 16 warps to an SM hide. So a scenario's
// node validity is an N-bit mask in shared memory instead of a float row,
// pass 1 runs only for hard spread constraints (its minimum is read by
// nothing else), pass 2 keeps each node's feasibility bit for pass 3, so
// pass 3 neither re-runs the filters nor scores an infeasible node, and the
// fit loop loads only the rows the pod requests. Scenario s's float state
// lies in row s of one [S, W] arena (ops/fast_scan.py lays it out), so one
// offset s·W selects it; chosen and gpu_take take 64-bit offsets (chosen
// alone is S·P entries). The per-node formulas are one copy: both kernels
// call them through the views Slice or Slots (whose state), Pod and TNode
// (template values, hoisted in the sweep only) and GCons or SCons
// (constraints).
//
// A scheduler config (variant flag CFG: a KubeSchedulerConfiguration other
// than the default, or any segment of a segmented multi-profile run). The
// reference runs such a config on its XLA scan,
// whose step (opensim_tpu/ops/kernels.py: pod_step) sums the weighted
// score parts in score_parts order from 0: balanced, least, node affinity,
// taint toleration, inter-pod, spread, share, local, avoid; a part of
// weight 0 is left out. The CFG variant sums in that order with the
// config's float32 weights, runtime bits switch each dynamic filter off (a
// disabled filter passes every node and counts nothing; with the spread
// filter off no hard constraint is evaluated, so pass 1 does not run), and
// the fit filter skips the ignored resource rows. The weights and bits lie
// in the __grid_constant__ argument block, read from the constant bank, so
// they take no registers. The default variants compile as before: CFG
// false folds every switch to a constant.
//
// Initial state. The CFG variants of both kernels can start from a given
// state (init: one row per scenario, laid out as the state arena) instead
// of the encoded one, so that consecutive launches carry the state: a segmented
// multi-profile stream runs one launch per segment, each on the CFG
// variant (simulator._run_segments in the JAX package runs one scan of
// its XLA engine per segment on the carry, summing in score_parts order
// even for the default config). The one scan loads every CTA's copy of
// the small state from it too. The other variants read no such pointer:
// the branch alone, before the loop, moved two of their timed rows by
// +3% and -5% (an ablation on the card, PERF.md §6).
//
// Sampled tie-break (variant flag SAMPLE, one scan only): selectHost takes
// the node with the highest score, then the highest draw, then the lowest
// index. The draw is Philox-4x32-10 (Salmon et al., SC'11), keyed by the
// seed, with counter (stream index of the pod, node index), so the choice
// is uniform over each step's maxima (the reference's
// generic_scheduler.go:188-210 reservoir sampling, in distribution; the
// JAX package's jax.random bits cannot be reproduced). It adds a word to
// pass 3's reduction and nothing to the other passes.
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
// as in the reference; GiB multiples stay exact. Skipped work is exact too:
// the reference multiplies by 1 for a resource row the pod does not
// request, every value of an infeasible node is masked out of the
// reductions, and a feasible node's score is finite, so it beats any
// infeasible one in selectHost.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#ifndef FS_VARIANT
#error "build one kernel variant per library: nvcc -DFS_VARIANT=<flag bits> (ops/fast_scan.py)"
#endif

namespace cg = cooperative_groups;

// The one scan's cluster, measured among C 4/8/16 at 640 or 1024 threads
// (PERF.md §6); ops/fast_scan.SCAN_CLUSTER and SCAN_THREADS hold the same.
#define CL 8     // CTAs per cluster: the node axis is split CL ways
#define NT 640   // threads per CTA
#define NWARP (NT / 32)
#define SCAN_NPT 2  // owned nodes per thread whose pass-2 values stay in registers for pass 3
#define SCAN_STATIC_SMEM 4096  // bytes the one scan's static shared memory may take (ops/fast_scan.SCAN_STATIC_SMEM)
#define SCAN_UNSCHEDULABLE (-1)  // fast_scan_launch: no cluster of CL CTAs fits on the card
#define MAX_R 8
#define MAX_CS 8
#define MAX_GD 8
#define MAX_DV 64  // devices per node: the bits of the bind's per-pod taken mask
#define MAX_K 4    // zone keys (engine/fastpath.MAX_ZONE_KEYS)
#define MAX_RED 11  // values one step reduction takes: max(MAX_CS, 5 + na + tt + 2 local + 2 inter-pod)
#define N_FAIL 7    // first-fail slots of a failing pod (ops/fast_scan.N_FAIL): ports, fit, spread, inter-pod, gpu, local, extra
#define FULL_MASK 0xffffffffu
// The sweep's shape, measured among B_max 2/4/8 at 512 or 1024 threads
// (PERF.md §6); ops/fast_scan.SWEEP_B_MAX and SWEEP_THREADS hold the same.
#define BMAX 4    // scenarios per sweep block at most
#define SW_NT 512  // threads per sweep block
#define SW_NWARP (SW_NT / 32)
#define SWEEP_STATIC_SMEM 24576  // bytes the sweep kernel's static shared memory may take (ops/fast_scan.SWEEP_STATIC_SMEM)

static_assert(BMAX >= 1 && BMAX <= 4 && SW_NT % 32 == 0 && SW_NT <= 1024, "sweep shape (Slots keeps four slot offsets)");
static_assert(CL >= 2 && CL <= 16 && NT % 32 == 0 && NT <= 1024 && SCAN_NPT >= 1, "scan shape");

namespace {

constexpr float BIG = 1e30f;
constexpr float NEG = -1e30f;
constexpr float MAX_SCORE = 100.0f;
constexpr float AVOID_WEIGHT = 10000.0f;
constexpr int RES_CPU = 0;
constexpr int RES_MEMORY = 1;

}  // namespace

// Mirrors the ctypes.Structure in ops/fast_scan.py field for field. The
// per-scenario inputs and every output and state buffer have a leading S
// axis (S = 1 for one scan); the shapes below are one scenario's. The state
// buffers point into scenario 0's row of the state arena, whose rows are W
// floats apart.
struct FastScanArgs {
    // pod stream: templates [P], per scenario valid and forced [P]
    const int32_t* tmpl;
    const int32_t* valid;
    const int32_t* forced;
    // node tables
    const float* alloc;        // [R, N]
    const float* used0;        // [R, N]
    const float* node_valid;   // [N] one scan's node validity (the sweep reads nv_bits)
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
    const float* spr_weight;   // [U, Cs] per scenario
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
    // the sweep's bit masks: bit n & 31 of word n >> 5 is node n, padding bits 0
    const uint32_t* nv_bits;   // [Nw] per scenario: node validity
    uint32_t* feas_bits;       // [Nw] per scenario: pass 2's feasibility bits for pass 3, when the masks lie in global memory
    float* rep;                // [CL, Wrep] one scan: each CTA's copy of the small state, when its slice lies in global memory
    // the failure attribution, per scenario (a grid of neither COUNT nor
    // EXPLAIN leaves them null): rows of the counted pods, the rest zeroed
    // by the host
    int32_t* fail_counts;      // [P, N_FAIL] nodes that fail each dynamic filter first
    int32_t* insufficient;     // [P, R] nodes that reach fit and lack each resource
    unsigned long long* count_clock;  // [2] one scan: the counting passes' global-timer nanoseconds and their number
    // the initial state (CFG variants; null: the encoded start), one row
    // per scenario at the arena's stride W, laid out as the arena, whose
    // first field is used
    const float* init;
    int64_t W;                 // floats per scenario in the arena
    int32_t S, P, N, R, U, A, K, Z, Cs, Gd, gc_row, Hp, Ti, Tn, Tp, G, Gp, Vg, Dv, Mv;
    int32_t has_gpu, has_na, has_tt, has_avoid, has_ports, has_interpod, has_local;
    int32_t B, Nw, bits_in_smem;  // the sweep: scenarios per block, words per mask, masks in shared memory
    // the one scan (ops/fast_scan.scan_shape): nodes per CTA, whether the
    // slices lie in shared memory, floats of the small state
    int32_t Nc, resident, Wrep;
    // float offsets in dynamic shared memory of the slice's rows (row r of
    // node n at o + r * Nc + n - n0), and of the small state's copy (o_rep)
    int32_t o_used, o_node_cnt, o_gpu_free, o_port_used, o_anti_node, o_prefw_node, o_vg_free, o_dev_free;
    int32_t o_alloc, o_zone, o_nv, o_gpu0, o_vg_cap, o_dev_cap, o_dev_media, o_rep;
    // float offsets of the small state within its copy
    int32_t o_zone_cnt, o_anti_zone, o_prefw_zone, o_sel_total;
    // the variant's two later flags
    int32_t has_cfg, has_sample;
    // a config (CFG): bit V_x set = dynamic filter x on; bit r set = the fit
    // filter skips resource row r
    int32_t filters, fit_ignored;
    // the sampled tie-break (SAMPLE): the first pod's stream index (the
    // draw's counter), the Philox key
    int32_t draw_base;
    uint32_t key0, key1;
    // a config's score weights (CFG), float32, in score_parts order
    float w_balanced, w_least, w_node_affinity, w_taint_toleration, w_interpod, w_spread, w_share, w_local,
        w_prefer_avoid;
    // the variant's last flags (EXPLAIN, COUNT), read by the host-side check only
    int32_t has_explain, has_count;
};

// Value k of a state field in the given initial state's first row: the
// rows are laid out as the arena, so the field lies at its offset from the
// arena's first field, used.
__device__ __forceinline__ float given(const FastScanArgs& a, const float* field, size_t k) {
    return a.init[(field - a.used) + k];
}

// The scans a thread works on at once, and where their state lies. Every
// per-node helper reads and writes state, and the constant node tables,
// through its view: state(j, row, node) for slot j; the small state by
// (j, row, zone) for the inter-pod zone rows, by (j, index) for the zone
// counts (their flat [K·A, Z] index) and per-selector totals.
//
// One scan (Slice<RES>, NB = 1) runs on a cluster of CL CTAs. CTA r owns
// nodes [n0, n1) = [r·Nc, min((r + 1)·Nc, N)): it alone reads and writes
// their per-node rows. Each CTA keeps its own copy of the small state and
// applies every bind to it in the same order, so the copies stay equal.
// RES = 1: the slice's rows (state and constant node tables) lie in the
// CTA's dynamic shared memory, row r of node n at o + r·Nc + n - n0, the
// copy at o_rep; RES = 0 (a slice past the room): the rows stay in global
// memory, the state at offset 0 of its buffers, the copy in row r of the
// [CL, Wrep] scratch `rep`.
//
// A block of the grid (Slots, NB = BMAX) works on its B scenarios' slots at
// once, in global memory: each per-node helper loops over the fields
// outside and the slots inside, so the NB loads of one field are in flight
// together and each slot's ops run in the order of one scan. A load is
// predicated on its slot's bit in `want` (the slots scheduling the pod, or,
// in pass 3, those for which the node is feasible); a slot past a ragged
// block's last scenario reads that scenario's node validity, and its
// results are never used.
extern __shared__ float scan_smem[];

template <int RES>
struct Slice {
    static constexpr int NB = 1;
    const FastScanArgs& a;
    int n0, n1;
    float* rep;  // this CTA's copy of the small state (RES = 0)
    template <class T>
    __device__ __forceinline__ T& sm(int o, int r, int n) const {
        return reinterpret_cast<T*>(scan_smem)[o + r * a.Nc + (n - n0)];
    }
    template <class T>
    __device__ __forceinline__ T& row(T* g, int o, int r, int n) const {
        if constexpr (RES) return sm<T>(o, r, n);
        else return g[(size_t)r * a.N + n];
    }
    __device__ __forceinline__ float& small(int o, int i) const {
        if constexpr (RES) return scan_smem[a.o_rep + o + i];
        else return rep[o + i];
    }
    __device__ __forceinline__ bool owns(int n) const { return n >= n0 && n < n1; }
    __device__ __forceinline__ int owned(int n) const { return n - n0; }
    __device__ __forceinline__ size_t pod0(int) const { return 0; }
    __device__ __forceinline__ float valid(int, int n) const { return row(a.node_valid, a.o_nv, 0, n); }
    __device__ __forceinline__ float alloc(int r, int n) const { return row(a.alloc, a.o_alloc, r, n); }
    __device__ __forceinline__ int zone(int k, int n) const { return row(a.zone_idx, a.o_zone, k, n); }
    __device__ __forceinline__ float gpu0(int d, int n) const { return row(a.gpu0, a.o_gpu0, d, n); }
    __device__ __forceinline__ float vg_cap(int v, int n) const { return row(a.vg_cap, a.o_vg_cap, v, n); }
    __device__ __forceinline__ float dev_cap(int d, int n) const { return row(a.dev_cap, a.o_dev_cap, d, n); }
    __device__ __forceinline__ float dev_media(int md, int n) const { return row(a.dev_media, a.o_dev_media, md, n); }
    __device__ __forceinline__ float& used(int, int r, int n) const { return row(a.used, a.o_used, r, n); }
    __device__ __forceinline__ float& node_cnt(int, int q, int n) const { return row(a.node_cnt, a.o_node_cnt, q, n); }
    __device__ __forceinline__ float& gpu_free(int, int d, int n) const { return row(a.gpu_free, a.o_gpu_free, d, n); }
    __device__ __forceinline__ float& port_used(int, int h, int n) const { return row(a.port_used, a.o_port_used, h, n); }
    __device__ __forceinline__ float& anti_node(int, int g, int n) const { return row(a.anti_node, a.o_anti_node, g, n); }
    __device__ __forceinline__ float& prefw_node(int, int g, int n) const {
        return row(a.prefw_node, a.o_prefw_node, g, n);
    }
    __device__ __forceinline__ float& vg_free(int, int v, int n) const { return row(a.vg_free, a.o_vg_free, v, n); }
    __device__ __forceinline__ float& dev_free(int, int d, int n) const { return row(a.dev_free, a.o_dev_free, d, n); }
    __device__ __forceinline__ float& zone_cnt(int, size_t i) const { return small(a.o_zone_cnt, (int)i); }
    __device__ __forceinline__ float& anti_zone(int, int g, int z) const { return small(a.o_anti_zone, g * a.Z + z); }
    __device__ __forceinline__ float& prefw_zone(int, int g, int z) const { return small(a.o_prefw_zone, g * a.Z + z); }
    __device__ __forceinline__ float& sel_total(int, int k) const { return small(a.o_sel_total, k); }
};

struct Slots {
    static constexpr int NB = BMAX;
    const FastScanArgs& a;
    int s0;                // the block's first scenario
    int last;              // its last slot holding a scenario
    int64_t W;             // arena floats per scenario
    int P, Nw;             // pods, words per mask
    const uint32_t* bits;  // [B, Nw] the block's node-validity masks, in shared or global memory
    // slot j's arena offset scn(j)·W, computed once a block (init_offsets):
    // the grid's loads add it instead of multiplying it out, and as four
    // scalars (not an array) it stays out of local memory (PERF.md §6)
    size_t o0, o1, o2, o3;
    __device__ __forceinline__ void init_offsets() {
        o0 = (size_t)scn(0) * W;
        o1 = (size_t)scn(1) * W;
        o2 = (size_t)scn(2) * W;
        o3 = (size_t)scn(3) * W;
    }
    __device__ __forceinline__ int scn(int j) const { return s0 + min(j, last); }
    __device__ __forceinline__ size_t off(int j) const { return j == 0 ? o0 : j == 1 ? o1 : j == 2 ? o2 : o3; }
    __device__ __forceinline__ size_t pod0(int j) const { return (size_t)scn(j) * P; }
    __device__ __forceinline__ float valid(int j, int n) const {
        return (bits[(size_t)min(j, last) * Nw + (n >> 5)] >> (n & 31)) & 1u ? 1.0f : 0.0f;
    }
    __device__ __forceinline__ bool owns(int) const { return true; }
    __device__ __forceinline__ int owned(int n) const { return n; }
    __device__ __forceinline__ size_t at(int r, int n) const { return (size_t)r * a.N + n; }
    __device__ __forceinline__ float alloc(int r, int n) const { return a.alloc[at(r, n)]; }
    __device__ __forceinline__ int zone(int k, int n) const { return a.zone_idx[at(k, n)]; }
    __device__ __forceinline__ float gpu0(int d, int n) const { return a.gpu0[at(d, n)]; }
    __device__ __forceinline__ float vg_cap(int v, int n) const { return a.vg_cap[at(v, n)]; }
    __device__ __forceinline__ float dev_cap(int d, int n) const { return a.dev_cap[at(d, n)]; }
    __device__ __forceinline__ float dev_media(int md, int n) const { return a.dev_media[at(md, n)]; }
    __device__ __forceinline__ float& used(int j, int r, int n) const { return a.used[off(j) + (size_t)r * a.N + n]; }
    __device__ __forceinline__ float& node_cnt(int j, int q, int n) const { return a.node_cnt[off(j) + (size_t)q * a.N + n]; }
    __device__ __forceinline__ float& gpu_free(int j, int d, int n) const { return a.gpu_free[off(j) + (size_t)d * a.N + n]; }
    __device__ __forceinline__ float& port_used(int j, int h, int n) const { return a.port_used[off(j) + (size_t)h * a.N + n]; }
    __device__ __forceinline__ float& anti_node(int j, int g, int n) const { return a.anti_node[off(j) + (size_t)g * a.N + n]; }
    __device__ __forceinline__ float& prefw_node(int j, int g, int n) const { return a.prefw_node[off(j) + (size_t)g * a.N + n]; }
    __device__ __forceinline__ float& vg_free(int j, int v, int n) const { return a.vg_free[off(j) + (size_t)v * a.N + n]; }
    __device__ __forceinline__ float& dev_free(int j, int d, int n) const { return a.dev_free[off(j) + (size_t)d * a.N + n]; }
    __device__ __forceinline__ float& zone_cnt(int j, size_t i) const { return a.zone_cnt[off(j) + i]; }
    __device__ __forceinline__ float& anti_zone(int j, int g, int z) const {
        return a.anti_zone[off(j) + (size_t)g * a.Z + z];
    }
    __device__ __forceinline__ float& prefw_zone(int j, int g, int z) const {
        return a.prefw_zone[off(j) + (size_t)g * a.Z + z];
    }
    __device__ __forceinline__ float& sel_total(int j, int k) const { return a.sel_total[off(j) + k]; }
};

// The grid's counting pass works on the one slot of a block of the COUNT
// and EXPLAIN variants (B = 1) through this view: the grid's accessors,
// one slot wide, so node_feasible gives that slot's verdicts as it gives
// the one scan's.
struct OneSlot : Slots {
    static constexpr int NB = 1;
};

// The step's spread constraints: bit c of `hard` and `soft` marks an
// active hard or soft constraint, and slot j's spread weight comes with
// each. One scan reads its template's from global memory (GCons); a sweep
// block stages them in shared memory once per step (StepCons, read through
// SCons).
__device__ __forceinline__ void cons_masks(const FastScanArgs& a, int u, unsigned& hard, unsigned& soft) {
    hard = soft = 0u;
    for (int c = 0; c < a.Cs; ++c) {
        if (a.spr_active[u * a.Cs + c] != 1) continue;
        if (a.spr_hard[u * a.Cs + c] == 1)
            hard |= 1u << c;
        else
            soft |= 1u << c;
    }
}

struct GCons {
    const FastScanArgs& a;
    int u;
    unsigned hard, soft;
    __device__ __forceinline__ GCons(const FastScanArgs& a_, int u_) : a(a_), u(u_) { cons_masks(a, u, hard, soft); }
    __device__ __forceinline__ int uc(int c) const { return u * a.Cs + c; }
    __device__ __forceinline__ int key(int c) const { return a.spr_key[uc(c)]; }
    __device__ __forceinline__ int sel(int c) const { return a.spr_sel[uc(c)]; }
    __device__ __forceinline__ float skew(int c) const { return a.spr_skew[uc(c)]; }
    __device__ __forceinline__ float self(int c) const { return a.spr_self[uc(c)]; }
    __device__ __forceinline__ float w(int, int c) const { return a.spr_weight[uc(c)]; }
};

struct StepCons {
    int key[MAX_CS], sel[MAX_CS];
    float skew[MAX_CS], self[MAX_CS];
    float w[BMAX][MAX_CS];
};

struct SCons {
    const StepCons& t;
    unsigned hard, soft;
    __device__ __forceinline__ int key(int c) const { return t.key[c]; }
    __device__ __forceinline__ int sel(int c) const { return t.sel[c]; }
    __device__ __forceinline__ float skew(int c) const { return t.skew[c]; }
    __device__ __forceinline__ float self(int c) const { return t.self[c]; }
    __device__ __forceinline__ float w(int j, int c) const { return t.w[j][c]; }
};

// The step's pod template and node n's template-level values at that step.
// A sweep block (HOIST) loads each once, per step or per node visit, and
// shares it among its slots; one scan reads each where it is used, as
// nothing shares it (its pass 3 reads what pass 2 kept instead).
template <bool HOIST>
struct Pod {
    const FastScanArgs& a;
    int u;
    float req_[MAX_R], gc_req_, cpu_req_, mem_req_;
    __device__ __forceinline__ Pod(const FastScanArgs& a_, int u_) : a(a_), u(u_) {
        if constexpr (HOIST) {
#pragma unroll
            for (int r = 0; r < MAX_R; ++r) req_[r] = r < a.R ? a.req[u * a.R + r] : 0.0f;
            gc_req_ = a.gc_row >= 0 ? a.req[u * a.R + a.gc_row] : 0.0f;
            cpu_req_ = a.cpu_nz[u];
            mem_req_ = a.mem_nz[u];
        }
    }
    __device__ __forceinline__ float req(int r) const { return HOIST ? req_[r] : a.req[u * a.R + r]; }
    __device__ __forceinline__ float gc_req() const { return HOIST ? gc_req_ : a.req[u * a.R + a.gc_row]; }
    __device__ __forceinline__ float cpu_req() const { return HOIST ? cpu_req_ : a.cpu_nz[u]; }
    __device__ __forceinline__ float mem_req() const { return HOIST ? mem_req_ : a.mem_nz[u]; }
};

template <bool HOIST, class Sl>
struct TNode {
    const FastScanArgs& a;
    const Sl* Sp;  // the view one scan's node-table loads go through; null when hoisted (load() takes it)
    int n;
    size_t un;  // u * N + n
    float sp_, share_, alloc_[MAX_R], alloc_cpu_, alloc_mem_, na_, tt_, avoid_, gc_alloc_;
    int zone_[MAX_K];
    unsigned gpu_has_;  // bit d: node n has GPU d
    __device__ __forceinline__ TNode(const FastScanArgs& a_, const Sl& S_, int u, int n_)
        : a(a_), Sp(HOIST ? nullptr : &S_), n(n_), un((size_t)u * a_.N + n_) {}
    __device__ __forceinline__ void load_zones(const Sl& S) {
        if constexpr (HOIST) {
#pragma unroll
            for (int k = 0; k < MAX_K; ++k) {
                if (k >= a.K) break;
                zone_[k] = S.zone(k, n);
            }
        }
    }
    // FIT: what the filters read; SCORES: what pass 3's scores read
    template <bool GC, bool NA, bool TT, bool AV, bool FIT, bool SCORES>
    __device__ __forceinline__ void load(const Pod<HOIST>& p, const Sl& S) {
        if constexpr (HOIST) {
            if constexpr (FIT) {
                sp_ = a.static_pass[un];
#pragma unroll
                for (int r = 0; r < MAX_R; ++r)
                    if (p.req(r) > 0.0f) alloc_[r] = S.alloc(r, n);
            }
            share_ = a.share_raw[un];
            if constexpr (SCORES) {
                alloc_cpu_ = S.alloc(RES_CPU, n);
                alloc_mem_ = S.alloc(RES_MEMORY, n);
            }
            load_zones(S);
            if constexpr (NA) na_ = a.na_raw[un];
            if constexpr (TT) tt_ = a.tt_raw[un];
            if constexpr (AV && SCORES) avoid_ = a.avoid_raw[un];
            if constexpr (GC) {
                gc_alloc_ = S.alloc(a.gc_row, n);
                gpu_has_ = 0u;
                for (int d = 0; d < a.Gd; ++d) gpu_has_ |= (S.gpu0(d, n) > 0.0f ? 1u : 0u) << d;
            }
        }
    }
    __device__ __forceinline__ float sp() const { return HOIST ? sp_ : a.static_pass[un]; }
    __device__ __forceinline__ float share() const { return HOIST ? share_ : a.share_raw[un]; }
    __device__ __forceinline__ float alloc(int r) const { return HOIST ? alloc_[r] : Sp->alloc(r, n); }
    __device__ __forceinline__ float alloc_cpu() const { return HOIST ? alloc_cpu_ : alloc(RES_CPU); }
    __device__ __forceinline__ float alloc_mem() const { return HOIST ? alloc_mem_ : alloc(RES_MEMORY); }
    __device__ __forceinline__ float gc_alloc() const { return HOIST ? gc_alloc_ : alloc(a.gc_row); }
    __device__ __forceinline__ float na() const { return HOIST ? na_ : a.na_raw[un]; }
    __device__ __forceinline__ float tt() const { return HOIST ? tt_ : a.tt_raw[un]; }
    __device__ __forceinline__ float avoid() const { return HOIST ? avoid_ : a.avoid_raw[un]; }
    __device__ __forceinline__ bool gpu(int d) const { return HOIST ? (gpu_has_ >> d & 1u) != 0u : Sp->gpu0(d, n) > 0.0f; }
    __device__ __forceinline__ int zone(int k) const {
        if constexpr (HOIST) return k == 0 ? zone_[0] : k == 1 ? zone_[1] : k == 2 ? zone_[2] : zone_[3];
        return Sp->zone(k, n);
    }
};

__device__ __forceinline__ float warp_min(float v) {
    for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(FULL_MASK, v, o));
    return v;
}

__device__ __forceinline__ float warp_max(float v) {
    for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL_MASK, v, o));
    return v;
}

// Lowest index among the maxima: (score, index) pairs, ties to the lower
// index.
__device__ __forceinline__ void better(float& s, int& i, float s2, int i2) {
    if (s2 > s || (s2 == s && i2 < i)) {
        s = s2;
        i = i2;
    }
}

__device__ __forceinline__ void warp_argmax(float& s, int& i) {
    for (int o = 16; o > 0; o >>= 1) better(s, i, __shfl_xor_sync(FULL_MASK, s, o), __shfl_xor_sync(FULL_MASK, i, o));
}

// One scan's shared scratch for its reductions: each warp's value, and
// this CTA's partials, which its cluster peers read. The partials are
// double-buffered by the parity of the reduction's count, so a CTA that
// runs ahead into the next reduction never overwrites what a slow peer
// still reads: it cannot start the one after before every peer has passed
// the next barrier.
struct ScanShared {
    float wbuf[MAX_RED][NWARP];
    float part[2][MAX_RED];
    float sbuf[NWARP];
    int ibuf[NWARP];
    float ps[2];
    int pi[2];
    // the counting pass: each warp's counts, and this CTA's, which CTA 0
    // reads (one buffer: CTA 0 has read it before any CTA can reach the
    // next counting pass, as pass 2's cluster barrier lies between, or in
    // explain mode the barrier after an invalid pod's count)
    int cwarp[N_FAIL + MAX_R][NWARP];
    int cpart[N_FAIL + MAX_R];
};

// The cluster's min (is_max(k) false) or max of NV values per thread
// (pallas_scan.py's jnp.min/max over the node axis): warp shuffles, one
// value per warp in shared memory, the CTA's partial (warp k reduces value
// k, k + NWARP, ...), one cluster barrier (release/acquire, so the
// partials are visible), then lane k of every warp reads value k of the CL
// CTAs' partials through distributed shared memory and reduces them, and
// the warp broadcasts. Every thread gets the results in v. Min and max are
// exact in any order.
template <int NV, class IsMax>
__device__ __forceinline__ void cluster_reduce(float (&v)[NV], IsMax is_max, ScanShared& sh, int& par,
                                               const cg::cluster_group& cluster) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
        const float x = is_max(k) ? warp_max(v[k]) : warp_min(v[k]);
        if (lane == 0) sh.wbuf[k][warp] = x;
    }
    __syncthreads();
    for (int k = warp; k < NV; k += NWARP) {
        const bool mx = is_max(k);
        float x = lane < NWARP ? sh.wbuf[k][lane] : (mx ? NEG : BIG);
        x = mx ? warp_max(x) : warp_min(x);
        if (lane == 0) sh.part[par][k] = x;
    }
    cluster.sync();
    float x = 0.0f;
    if (lane < NV) {
        const bool mx = is_max(lane);
        float y[CL];
#pragma unroll
        for (int r = 0; r < CL; ++r) y[r] = *cluster.map_shared_rank(&sh.part[par][lane], r);
        x = y[0];
#pragma unroll
        for (int r = 1; r < CL; ++r) x = mx ? fmaxf(x, y[r]) : fminf(x, y[r]);
    }
#pragma unroll
    for (int k = 0; k < NV; ++k) v[k] = __shfl_sync(FULL_MASK, x, k);
    par ^= 1;
}

// The sampled tie-break's draws: the first word of Philox-4x32-10 (Salmon
// et al., SC'11; the Random123 constants) with key (key0, key1) and
// counter (c0, c1, 0, 0). ops/fast_scan.philox_draws computes the same
// words in integer torch ops.
__device__ __forceinline__ unsigned philox_draw(unsigned k0, unsigned k1, unsigned c0, unsigned c1) {
    unsigned c2 = 0u, c3 = 0u;
#pragma unroll
    for (int r = 0; r < 10; ++r) {
        if (r) {
            k0 += 0x9E3779B9u;
            k1 += 0xBB67AE85u;
        }
        const unsigned hi0 = __umulhi(0xD2511F53u, c0), lo0 = 0xD2511F53u * c0;
        const unsigned hi1 = __umulhi(0xCD9E8D57u, c2), lo1 = 0xCD9E8D57u * c2;
        c0 = hi1 ^ c1 ^ k0;
        c1 = lo1;
        c2 = hi0 ^ c3 ^ k1;
        c3 = lo0;
    }
    return c0;
}

// The sampled selectHost's order: (score, draw, index) triples, the highest
// score, then the highest draw, then the lowest index. Without SAMPLE the
// draw is not read: better and warp_argmax above.
template <bool SAMPLE>
__device__ __forceinline__ void better(float& s, unsigned& d, int& i, float s2, unsigned d2, int i2) {
    if constexpr (SAMPLE) {
        if (s2 > s || (s2 == s && (d2 > d || (d2 == d && i2 < i)))) {
            s = s2;
            d = d2;
            i = i2;
        }
    } else {
        better(s, i, s2, i2);
    }
}

template <bool SAMPLE>
__device__ __forceinline__ void warp_argmax(float& s, unsigned& d, int& i) {
    if constexpr (SAMPLE) {
        for (int o = 16; o > 0; o >>= 1)
            better<true>(s, d, i, __shfl_xor_sync(FULL_MASK, s, o), __shfl_xor_sync(FULL_MASK, d, o),
                         __shfl_xor_sync(FULL_MASK, i, o));
    } else {
        warp_argmax(s, i);
    }
}

// One scan's reduction scratch with room for the draws (SAMPLE variants).
struct ScanSharedDrawn : ScanShared {
    unsigned dbuf[NWARP];
    unsigned pd[2];
};

// The cluster's selectHost choice among (s, [d,] i), the same way as
// cluster_reduce: one triple per warp, the CTA's triple, one cluster
// barrier, then lane r of every warp reads CTA r's triple and the warp
// reduces them. Without SAMPLE the lowest index among the maxima of (s, i)
// (d is not read; sh is a ScanShared), with it the sampled order (sh is a
// ScanSharedDrawn). Returns the index in every thread.
template <bool SAMPLE, class SH>
__device__ __forceinline__ int cluster_argmax(float s, unsigned d, int i, int none, SH& sh, int& par,
                                              const cg::cluster_group& cluster) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    warp_argmax<SAMPLE>(s, d, i);
    if (lane == 0) {
        sh.sbuf[warp] = s;
        if constexpr (SAMPLE) sh.dbuf[warp] = d;
        sh.ibuf[warp] = i;
    }
    __syncthreads();
    if (warp == 0) {
        s = lane < NWARP ? sh.sbuf[lane] : NEG;
        if constexpr (SAMPLE) d = lane < NWARP ? sh.dbuf[lane] : 0u;
        i = lane < NWARP ? sh.ibuf[lane] : none;
        warp_argmax<SAMPLE>(s, d, i);
        if (lane == 0) {
            sh.ps[par] = s;
            if constexpr (SAMPLE) sh.pd[par] = d;
            sh.pi[par] = i;
        }
    }
    cluster.sync();
    s = NEG;
    d = 0u;
    i = none;
    if (lane < CL) {
        s = *cluster.map_shared_rank(&sh.ps[par], lane);
        if constexpr (SAMPLE) d = *cluster.map_shared_rank(&sh.pd[par], lane);
        i = *cluster.map_shared_rank(&sh.pi[par], lane);
    }
    warp_argmax<SAMPLE>(s, d, i);
    par ^= 1;
    return i;
}

// The values pass 2 reduces, in order: lo min, hi max, smn min, smx max,
// any-feasible max, then the NodeAffinity and TaintToleration maxima, the
// binpack score's min and max and the inter-pod score's max and min where
// the variant has them.
template <bool NA, bool TT, bool LOC, bool IP>
struct Red {
    static constexpr int I_NA = 5, I_TT = I_NA + (NA ? 1 : 0), I_LOC = I_TT + (TT ? 1 : 0);
    static constexpr int I_IP = I_LOC + (LOC ? 2 : 0), N = I_IP + (IP ? 2 : 0);
    static __host__ __device__ constexpr bool is_max(int k) {
        return k == 1 || k == 3 || k == 4 || (NA && k == I_NA) || (TT && k == I_TT) || (LOC && k == I_LOC + 1) ||
               (IP && k == I_IP);
    }
    // seeds: the share and spread ranges over the feasible nodes, the
    // score-table maxima from -1e30, the inter-pod range with both ends at 0
    static __device__ __forceinline__ void init(float* rv) {
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
    }
};

// The bits a failing node's verdicts take in the counting pass: bit f of
// `fail` is the dynamic filter of slot f (N_FAIL's order, the reference's
// order of attribution) that node n fails, bit r of `shortage` a resource
// row it lacks (req > 0 and used + req > alloc). node_feasible fills them
// where it is given a Verdicts (a counting pass, over one slot);
// NoVerdicts compiles them out.
enum { V_PORTS = 0, V_FIT, V_SPREAD, V_INTERPOD, V_GPU, V_LOCAL };
struct Verdicts {
    static constexpr bool on = true;
    unsigned fail, shortage;
};
struct NoVerdicts {
    static constexpr bool on = false;
};

// Whether dynamic filter v (a V_* bit) runs: always in a default variant;
// in a CFG variant, as the config's bits say.
template <bool CFG>
__device__ __forceinline__ bool filter_on(const FastScanArgs& a, int v) {
    if constexpr (CFG) return (a.filters >> v & 1) != 0;
    return true;
}

// The step's hard spread constraints as the filter takes them: none when
// a config turns the spread filter off.
template <bool CFG>
__device__ __forceinline__ unsigned hard_cons(const FastScanArgs& a, unsigned hard) {
    return filter_on<CFG>(a, V_SPREAD) ? hard : 0u;
}

// Counts of bound pods matching selector `sel` in node n's domain under
// topology key `key` (0 = hostname, 1..K = zone keys), per slot in `want`
// (0 elsewhere); returns whether node n carries that key's label, the same
// for every slot. The reference gathers zone counts with an f32 one-hot
// dot; the counts are integers below 2^24, so this gather by zone index
// gives the same bits.
template <class Sl, class TN>
__device__ __forceinline__ float sel_cnts(const FastScanArgs& a, const Sl& S, const TN& t, int sel, int key, int n,
                                          unsigned want, float (&cnt)[Sl::NB]) {
    if (key == 0) {
#pragma unroll
        for (int j = 0; j < Sl::NB; ++j) cnt[j] = want >> j & 1u ? S.node_cnt(j, sel, n) : 0.0f;
        return 1.0f;
    }
    const int z = t.zone(key - 1);
    const size_t rel = ((size_t)(key - 1) * a.A + sel) * a.Z + z;
#pragma unroll
    for (int j = 0; j < Sl::NB; ++j) cnt[j] = z >= 0 && (want >> j & 1u) ? S.zone_cnt(j, rel) : 0.0f;
    return z >= 0 ? 1.0f : 0.0f;
}

// Row g of an inter-pod term table (the anti rows, or with PREF the
// preferred rows) at node n, per slot in `want`: its node row for a
// hostname row (key 0), else its zone row under its own key, 0 where node n
// lacks that label.
template <bool PREF, class Sl, class TN>
__device__ __forceinline__ void term_cnts(const Sl& S, const TN& t, int g, int key, int n, unsigned want,
                                          float (&cnt)[Sl::NB]) {
    if (key == 0) {
#pragma unroll
        for (int j = 0; j < Sl::NB; ++j)
            cnt[j] = want >> j & 1u ? (PREF ? S.prefw_node(j, g, n) : S.anti_node(j, g, n)) : 0.0f;
        return;
    }
    const int z = t.zone(key - 1);
#pragma unroll
    for (int j = 0; j < Sl::NB; ++j)
        cnt[j] = z >= 0 && (want >> j & 1u) ? (PREF ? S.prefw_zone(j, g, z) : S.anti_zone(j, g, z)) : 0.0f;
}

// Bind of row g with value v at node c: its node column where the view
// owns node c, and its zone column under its own key where node c carries
// the label (pallas_scan.py:836-854 adds a_col * key_mask * the zone
// one-hot). Node c's zone comes from the global table: it may lie outside
// a cluster CTA's slice.
template <bool PREF, class Sl>
__device__ __forceinline__ void term_bind(const FastScanArgs& a, const Sl& S, int j, int g, int key, int c, float v) {
    if (S.owns(c)) (PREF ? S.prefw_node(j, g, c) : S.anti_node(j, g, c)) += v;
    if (key == 0) return;
    const int z = a.zone_idx[(size_t)(key - 1) * a.N + c];
    if (z >= 0) (PREF ? S.prefw_zone(j, g, z) : S.anti_zone(j, g, z)) += v;
}

// Dynamic gpu-count allocatable of node n per slot (pallas_scan.py:
// 401-412): the count of its devices with free memory left; and whether it
// has devices, the same for every slot.
template <class Sl, class TN>
__device__ __forceinline__ void gc_nodes(const FastScanArgs& a, const Sl& S, const TN& t, int n, unsigned want,
                                         float (&dyn)[Sl::NB], float& has_dev) {
#pragma unroll
    for (int j = 0; j < Sl::NB; ++j) dyn[j] = 0.0f;
    has_dev = 0.0f;
    for (int d = 0; d < a.Gd; ++d) {
        const float valid_d = t.gpu(d) ? 1.0f : 0.0f;
#pragma unroll
        for (int j = 0; j < Sl::NB; ++j) {
            const float g = want >> j & 1u ? S.gpu_free(j, d, n) : 0.0f;
            dyn[j] = dyn[j] + valid_d * (g > 0.0f ? 1.0f : 0.0f);
        }
        has_dev = fmaxf(has_dev, valid_d);
    }
}

// Inter-pod filter of template u at node n per slot (pallas_scan.py:
// 503-586), 0 or 1: the incoming required anti-affinity terms, the
// incoming required affinity terms with the bootstrap (bit j of `boot`,
// the same for every node), and the existing pods' anti terms against this
// pod. Rows whose selector the template does not match add exact zeros in
// the Pallas dots and are skipped.
template <class Sl, class TN>
__device__ __forceinline__ void interpod_filter(const FastScanArgs& a, const Sl& S, const TN& t, int u, int n,
                                                unsigned boot, unsigned want, float (&ok)[Sl::NB]) {
    constexpr int NB = Sl::NB;
    float cnt[NB];
#pragma unroll
    for (int j = 0; j < NB; ++j) ok[j] = 1.0f;
    for (int k = 0; k < a.Tn; ++k) {
        const int uk = u * a.Tn + k;
        if (a.an_active[uk] != 1) continue;
        const float has_label = sel_cnts(a, S, t, a.an_sel[uk], a.an_key[uk], n, want, cnt);
#pragma unroll
        for (int j = 0; j < NB; ++j) ok[j] = ok[j] * (1.0f - ((cnt[j] > 0.0f && has_label > 0.0f) ? 1.0f : 0.0f));
    }
    float at_all_ok[NB], at_labels_ok = 1.0f;
#pragma unroll
    for (int j = 0; j < NB; ++j) at_all_ok[j] = 1.0f;
    for (int k = 0; k < a.Ti; ++k) {
        const int uk = u * a.Ti + k;
        if (a.at_active[uk] != 1) continue;
        const float has_label = sel_cnts(a, S, t, a.at_sel[uk], a.at_key[uk], n, want, cnt);
#pragma unroll
        for (int j = 0; j < NB; ++j) at_all_ok[j] = at_all_ok[j] * ((cnt[j] > 0.0f && has_label > 0.0f) ? 1.0f : 0.0f);
        at_labels_ok = at_labels_ok * (has_label > 0.0f ? 1.0f : 0.0f);
    }
#pragma unroll
    for (int j = 0; j < NB; ++j) ok[j] = ok[j] * fmaxf(at_all_ok[j], at_labels_ok * (boot >> j & 1u ? 1.0f : 0.0f));
    float sym_cnt[NB];
#pragma unroll
    for (int j = 0; j < NB; ++j) sym_cnt[j] = 0.0f;
    for (int g = 0; g < a.G; ++g) {
        const float m = a.gmatch[(size_t)g * a.U + u];
        if (m == 0.0f) continue;
        term_cnts<false>(S, t, g, a.anti_g_key[g], n, want, cnt);
#pragma unroll
        for (int j = 0; j < NB; ++j) sym_cnt[j] = sym_cnt[j] + m * cnt[j];
    }
#pragma unroll
    for (int j = 0; j < NB; ++j) ok[j] = ok[j] * (1.0f - (sym_cnt[j] > 0.0f ? 1.0f : 0.0f));
}

// Inter-pod raw preferred score of template u at node n per slot: the
// incoming preferred terms plus the existing pods' preferred and
// hard-affinity weights.
template <class Sl, class TN>
__device__ __forceinline__ void interpod_raw(const FastScanArgs& a, const Sl& S, const TN& t, int u, int n,
                                             unsigned want, float (&ip)[Sl::NB]) {
    constexpr int NB = Sl::NB;
    float cnt[NB];
#pragma unroll
    for (int j = 0; j < NB; ++j) ip[j] = 0.0f;
    for (int k = 0; k < a.Tp; ++k) {
        const int uk = u * a.Tp + k;
        if (a.pt_active[uk] != 1) continue;
        const float has_label = sel_cnts(a, S, t, a.pt_sel[uk], a.pt_key[uk], n, want, cnt);
        const float w = a.pt_w[uk];
#pragma unroll
        for (int j = 0; j < NB; ++j) ip[j] = ip[j] + cnt[j] * w * has_label;
    }
    for (int g = 0; g < a.Gp; ++g) {
        const float m = a.pmatch[(size_t)g * a.U + u];
        if (m == 0.0f) continue;
        term_cnts<true>(S, t, g, a.prefg_key[g], n, want, cnt);
#pragma unroll
        for (int j = 0; j < NB; ++j) ip[j] = ip[j] + m * cnt[j];
    }
}

// Whether device d of media m at node n is free for slot j, fits `size`
// bytes and is of that media (pallas_scan.py:474, :692, :812-815 without
// the taken mask).
template <class Sl>
__device__ __forceinline__ bool dev_fits(const FastScanArgs& a, const Sl& S, int j, int m, int d, int n, float size) {
    const float free_d = S.dev_free(j, d, n);
    return S.dev_media(m * a.Dv + d, n) > 0.0f && free_d >= size && free_d > 0.0f;
}

// Open-Local filter of template u at node n for slot j (pallas_scan.py:
// 455-477): the LVM request fits the VG with the most free bytes, and for
// each media the i-th largest exclusive volume finds at least i + 1 free
// devices that fit it. Volume slots of size 0 (padding) pass, as in the
// reference.
template <class Sl>
__device__ __forceinline__ float local_filter(const FastScanArgs& a, const Sl& S, int j, int u, int n) {
    const float lvm = a.lvm_req[u];
    if (lvm > 0.0f) {
        float best = NEG;
        for (int v = 0; v < a.Vg; ++v) best = fmaxf(best, S.vg_free(j, v, n));
        if (!(best >= lvm)) return 0.0f;
    }
    for (int m = 0; m < 2; ++m) {
        for (int vi = 0; vi < a.Mv; ++vi) {
            const float size = a.dev_sizes[(size_t)u * 2 * a.Mv + m * a.Mv + vi];
            if (!(size > 0.0f)) continue;
            int cnt_fit = 0;
            for (int d = 0; d < a.Dv; ++d) cnt_fit += dev_fits(a, S, j, m, d, n, size) ? 1 : 0;
            if (cnt_fit < vi + 1) return 0.0f;
        }
    }
    return 1.0f;
}

// Open-Local binpack raw score of template u at node n for slot j
// (pallas_scan.py:668-698): the mean over the pod's storage units of
// request / capacity of the unit it would take (the tightest fitting VG;
// per media, the smallest-capacity fitting device, for need volumes of the
// largest size), times 10. A template with no storage has count 0 and
// scores 0; the terms the reference multiplies by 0 are skipped.
template <class Sl>
__device__ __forceinline__ float local_raw_of(const FastScanArgs& a, const Sl& S, int j, int u, int n) {
    const float lvm = a.lvm_req[u];
    float parts = 0.0f, count = 0.0f;
    if (lvm > 0.0f) {
        float best_free = BIG, best_cap = 0.0f;
        for (int v = 0; v < a.Vg; ++v) {
            const float free_v = S.vg_free(j, v, n);
            if (free_v >= lvm && free_v < best_free) {
                best_free = free_v;
                best_cap = S.vg_cap(v, n);
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
        for (int d = 0; d < a.Dv; ++d)
            if (dev_fits(a, S, j, m, d, n, size)) first_cap = fminf(first_cap, S.dev_cap(d, n));
        parts = parts + need * size / fmaxf(first_cap, 1.0f);
        count = count + need;
    }
    return count > 0.0f ? parts / fmaxf(count, 1.0f) * 10.0f : 0.0f;
}

// Open-Local bind of template u on node c for slot j (pallas_scan.py:
// 783-835): the LVM request goes to the tightest VG that fits (first among
// equals); the exclusive volumes, each media in ascending size, each to the
// smallest-capacity candidate this pod has not taken yet (ties to the
// lowest index), whose free bytes become 0. Writes node c's vg_free and
// dev_free columns.
template <class Sl>
__device__ __forceinline__ void local_bind(const FastScanArgs& a, const Sl& S, int j, int u, int c) {
    const float lvm = a.lvm_req[u];
    if (lvm > 0.0f) {  // lvm = 0 would subtract 0 from one VG
        float best_free = BIG;
        for (int v = 0; v < a.Vg; ++v) {
            const float free_v = S.vg_free(j, v, c);
            if (free_v >= lvm) best_free = fminf(best_free, free_v);
        }
        float taken_vg = 0.0f;
        for (int v = 0; v < a.Vg; ++v) {
            const float free_v = S.vg_free(j, v, c);
            const float take_v = (free_v >= lvm && free_v == best_free ? 1.0f : 0.0f) * (1.0f - fminf(taken_vg, 1.0f));
            taken_vg = taken_vg + take_v;
            S.vg_free(j, v, c) = free_v - fmaxf(lvm, 0.0f) * take_v;
        }
    }
    unsigned long long taken = 0ull;  // devices this pod took, bit d
    for (int m = 0; m < 2; ++m) {
        for (int vi = a.Mv - 1; vi >= 0; --vi) {  // ascending sizes
            const float size = a.dev_sizes[(size_t)u * 2 * a.Mv + m * a.Mv + vi];
            if (!(size > 0.0f)) continue;
            float best_cap = BIG;
            for (int d = 0; d < a.Dv; ++d)
                if (!(taken >> d & 1ull) && dev_fits(a, S, j, m, d, c, size))
                    best_cap = fminf(best_cap, S.dev_cap(d, c));
            for (int d = 0; d < a.Dv; ++d) {
                if (!(taken >> d & 1ull) && dev_fits(a, S, j, m, d, c, size) && S.dev_cap(d, c) == best_cap) {
                    taken |= 1ull << d;
                    S.dev_free(j, d, c) = 0.0f;  // free_d * (1 - 1): free_d > 0, so +0
                    break;
                }
            }
        }
    }
}

// Feasibility of node n for the step's pod per slot, 0 or 1, given each
// slot's minimum counts of its hard spread constraints (slot j's at
// min_cnt + j * MAX_CS) (pallas_scan.py:400-586), plus node n's dynamic
// gpu-count state for the share add-back. Given a Verdicts (one scan's
// counting pass), each filter's own verdict as well. With CFG, a filter
// the config turns off passes every node (the caller leaves the hard
// spread constraints out of `cs`), and fit skips the ignored rows
// (kernels.py:188-199).
template <bool GPU, bool GC, bool PORTS, bool IP, bool LOC, bool CFG, class Sl, class Cn, class TN, class PD,
          class VD = NoVerdicts>
__device__ __forceinline__ void node_feasible(const FastScanArgs& a, const Sl& S, const Cn& cs, const TN& t,
                                              const PD& p, int n, const float* min_cnt, unsigned boot, unsigned want,
                                              float (&feasible)[Sl::NB], float (&gc_dyn)[Sl::NB],
                                              float& gc_has_dev, VD* vd = nullptr) {
    constexpr int NB = Sl::NB;
    static_assert(!VD::on || NB == 1, "the counting pass takes one slot");
    const int u = p.u;
    if constexpr (GC) gc_nodes(a, S, t, n, want, gc_dyn, gc_has_dev);
    float fit[NB];
#pragma unroll
    for (int j = 0; j < NB; ++j) fit[j] = 1.0f;
    const bool fit_on = filter_on<CFG>(a, V_FIT);
#pragma unroll
    for (int r = 0; r < MAX_R; ++r) {
        if (r >= a.R || !fit_on) break;
        const float req_r = p.req(r);
        if (!(req_r > 0.0f)) continue;  // the reference multiplies by 1 for a row the pod does not request
        if constexpr (CFG)
            if (a.fit_ignored >> r & 1) continue;  // NodeResourcesFitArgs.ignoredResources
#pragma unroll
        for (int j = 0; j < NB; ++j) {
            const float used_r = want >> j & 1u ? S.used(j, r, n) : 0.0f;
            float alloc_r = t.alloc(r);
            if constexpr (GC)
                if (r == a.gc_row) alloc_r = gc_has_dev > 0.0f ? gc_dyn[j] : alloc_r;
            const float over = (used_r + req_r > alloc_r) ? 1.0f : 0.0f;
            fit[j] = fit[j] * (1.0f - over);
            if constexpr (VD::on) vd->shortage |= (over > 0.0f ? 1u : 0u) << r;
        }
    }
    if constexpr (VD::on) vd->fail |= (fit[0] > 0.0f ? 0u : 1u) << V_FIT;
#pragma unroll
    for (int j = 0; j < NB; ++j) feasible[j] = t.sp() * fit[j] * S.valid(j, n);
    if constexpr (PORTS) {
        if (filter_on<CFG>(a, V_PORTS)) {
            // NodePorts: a conflicting port id already used on the node
            float conflicts[NB];
#pragma unroll
            for (int j = 0; j < NB; ++j) conflicts[j] = 0.0f;
            for (int h = 0; h < a.Hp; ++h) {
                const float mine = a.port_conf[(size_t)h * a.U + u];
                if (mine == 0.0f) continue;
#pragma unroll
                for (int j = 0; j < NB; ++j) {
                    const float used_h = want >> j & 1u ? S.port_used(j, h, n) : 0.0f;
                    conflicts[j] = conflicts[j] + mine * (used_h > 0.0f ? 1.0f : 0.0f);
                }
            }
#pragma unroll
            for (int j = 0; j < NB; ++j) feasible[j] = feasible[j] * (conflicts[j] == 0.0f ? 1.0f : 0.0f);
            if constexpr (VD::on) vd->fail |= (conflicts[0] == 0.0f ? 0u : 1u) << V_PORTS;
        }
    }
    if constexpr (GPU) {
        // Open-Gpu-Share filter: sum_d floor(free_d / mem) >= count
        const float gmem = a.gpu_mem[u];
        const float gcnt = a.gpu_cnt[u];
        if (gmem > 0.0f && filter_on<CFG>(a, V_GPU)) {
            const float gmem1 = fmaxf(gmem, 1.0f);
            float chunks_sum[NB];
#pragma unroll
            for (int j = 0; j < NB; ++j) chunks_sum[j] = 0.0f;
            for (int d = 0; d < a.Gd; ++d) {
#pragma unroll
                for (int j = 0; j < NB; ++j) {
                    const float free_d = want >> j & 1u ? S.gpu_free(j, d, n) : 0.0f;
                    chunks_sum[j] = chunks_sum[j] + floorf(free_d / gmem1);
                }
            }
#pragma unroll
            for (int j = 0; j < NB; ++j) {
                const bool gpu_ok = chunks_sum[j] >= gcnt && gcnt > 0.0f;
                feasible[j] = feasible[j] * (gpu_ok ? 1.0f : 0.0f);
                if constexpr (VD::on) vd->fail |= (gpu_ok ? 0u : 1u) << V_GPU;
            }
        }
    }
    if constexpr (LOC) {
#pragma unroll
        for (int j = 0; j < NB; ++j) {
            if (!(want >> j & 1u) || !filter_on<CFG>(a, V_LOCAL)) continue;
            const float ok = local_filter(a, S, j, u, n);
            feasible[j] = feasible[j] * ok;
            if constexpr (VD::on) vd->fail |= (ok > 0.0f ? 0u : 1u) << V_LOCAL;
        }
    }
    float cnt[NB];
    for (unsigned m = cs.hard; m; m &= m - 1u) {
        const int c = __ffs(m) - 1;
        const float has_label = sel_cnts(a, S, t, cs.sel(c), cs.key(c), n, want, cnt);
        const float self = cs.self(c), skew = cs.skew(c);
#pragma unroll
        for (int j = 0; j < NB; ++j) {
            const bool ok = (cnt[j] + self - min_cnt[j * MAX_CS + c] <= skew) && (has_label > 0.0f);
            feasible[j] = feasible[j] * (ok ? 1.0f : 0.0f);
            if constexpr (VD::on) vd->fail |= (ok ? 0u : 1u) << V_SPREAD;
        }
    }
    if constexpr (IP) {
        if (filter_on<CFG>(a, V_INTERPOD)) {
            float ok[NB];
            interpod_filter(a, S, t, u, n, boot, want, ok);
#pragma unroll
            for (int j = 0; j < NB; ++j) feasible[j] = feasible[j] * ok[j];
            if constexpr (VD::on) vd->fail |= (ok[0] > 0.0f ? 0u : 1u) << V_INTERPOD;
        }
    }
}

// Soft-spread raw score of node n for template u per slot, and whether
// node n lacks a label one of its soft constraints needs, the same for
// every slot (pallas_scan.py:588-612).
template <class Sl, class Cn, class TN>
__device__ __forceinline__ void node_soft(const FastScanArgs& a, const Sl& S, const Cn& cs, const TN& t, int n,
                                          unsigned want, float (&soft_raw)[Sl::NB], float& ignored) {
    constexpr int NB = Sl::NB;
    float cnt[NB];
#pragma unroll
    for (int j = 0; j < NB; ++j) soft_raw[j] = 0.0f;
    ignored = 0.0f;
    for (unsigned m = cs.soft; m; m &= m - 1u) {  // in ascending c, the reference's order
        const int c = __ffs(m) - 1;
        const float has_label = sel_cnts(a, S, t, cs.sel(c), cs.key(c), n, want, cnt);
        const float skew = cs.skew(c);
#pragma unroll
        for (int j = 0; j < NB; ++j) {
            const float contrib = has_label > 0.0f ? cnt[j] * cs.w(j, c) + (skew - 1.0f) : 0.0f;
            soft_raw[j] = soft_raw[j] + contrib;
        }
        ignored = fmaxf(ignored, 1.0f - has_label);
    }
}

// Pass 1 for constraint c at node n, per slot in `want`: the count where
// the node is spread-eligible and carries the key's label, folded into the
// slot's running minimum `mn`.
template <class Sl, class Cn, class TN>
__device__ __forceinline__ void elig_min(const FastScanArgs& a, const Sl& S, const Cn& cs, const TN& t, int c, int n,
                                         float aff, unsigned want, float (&mn)[Sl::NB]) {
    float cnt[Sl::NB];
    const float has_label = sel_cnts(a, S, t, cs.sel(c), cs.key(c), n, want, cnt);
#pragma unroll
    for (int j = 0; j < Sl::NB; ++j) {
        const float elig = aff * S.valid(j, n) * has_label;
        mn[j] = fminf(mn[j], elig > 0.0f ? cnt[j] : BIG);
    }
}

// Simon share of node n for the pod, with the gpu-count share added back
// at the Reserve-updated count (pallas_scan.py:614-630).
template <bool GC, class TN, class PD>
__device__ __forceinline__ float share_of(const TN& t, const PD& p, float gc_dyn, float gc_has_dev) {
    float share_row = t.share();
    if constexpr (GC) {
        const float gc_req = p.gc_req();
        const bool declared = t.gc_alloc() > 0.0f;
        const float avail = gc_dyn - gc_req;
        float sh = avail == 0.0f ? (gc_req == 0.0f ? 0.0f : 1.0f) : gc_req / avail;
        sh = ((declared && gc_has_dev > 0.0f) ? fmaxf(sh, 0.0f) : 0.0f) * MAX_SCORE;
        share_row = fmaxf(share_row, gc_req > 0.0f ? sh : 0.0f);
    }
    return share_row;
}

// What pass 2 leaves in registers for pass 3 at an owned node of one scan:
// its feasibility and, for a feasible node, every value its score reads
// besides the state (share, soft-spread raw score and ignored flag,
// inter-pod and binpack raw scores, score-table values).
struct Kept {
    bool feas;
    float sh, soft, ignored, ip, lr, na, tt, av;
};

// Pass 2 at node n for every slot in `want`: feasibility, then the node's
// share, soft-spread, binpack, score-table and inter-pod values into slot
// j's partial reductions rv[j] (Red's order). Only a feasible node adds to
// them; an infeasible one adds the 0 the reference's masks give the
// score-table maxima. Returns the feasibility in `feasible`, and one scan's
// values for pass 3 in `kept` where given.
template <bool GPU, bool GC, bool NA, bool TT, bool PORTS, bool IP, bool LOC, bool CFG, class Sl, class Cn, class TN,
          class PD>
__device__ __forceinline__ void pass2_node(const FastScanArgs& a, const Sl& S, const Cn& cs, const TN& t,
                                           const PD& p, int n,
                                           const float* min_cnt, unsigned boot, unsigned want,
                                           float (&feasible)[Sl::NB], float (&rv)[Sl::NB][Red<NA, TT, LOC, IP>::N],
                                           Kept* kept = nullptr) {
    constexpr int NB = Sl::NB;
    using RD = Red<NA, TT, LOC, IP>;
    float gc_dyn[NB], gc_has_dev = 0.0f, soft_raw[NB], ignored, ip[NB];
    node_feasible<GPU, GC, PORTS, IP, LOC, CFG>(a, S, cs, t, p, n, min_cnt, boot, want, feasible, gc_dyn,
                                                gc_has_dev);
    node_soft(a, S, cs, t, n, want, soft_raw, ignored);
    if constexpr (IP) interpod_raw(a, S, t, p.u, n, want, ip);
#pragma unroll
    for (int j = 0; j < NB; ++j) {
        if (!(want >> j & 1u)) continue;
        if (feasible[j] > 0.0f) {
            const float sh = share_of<GC>(t, p, GC ? gc_dyn[j] : 0.0f, gc_has_dev);
            rv[j][0] = fminf(rv[j][0], sh);
            rv[j][1] = fmaxf(rv[j][1], sh);
            if (ignored == 0.0f) {
                rv[j][2] = fminf(rv[j][2], soft_raw[j]);
                rv[j][3] = fmaxf(rv[j][3], soft_raw[j]);
            }
            if constexpr (LOC) {
                const float lr = local_raw_of(a, S, j, p.u, n);
                rv[j][RD::I_LOC] = fminf(rv[j][RD::I_LOC], lr);
                rv[j][RD::I_LOC + 1] = fmaxf(rv[j][RD::I_LOC + 1], lr);
                if (kept) kept->lr = lr;
            }
            if constexpr (NA) rv[j][RD::I_NA] = fmaxf(rv[j][RD::I_NA], t.na());
            if constexpr (TT) rv[j][RD::I_TT] = fmaxf(rv[j][RD::I_TT], t.tt());
            if constexpr (IP) {
                rv[j][RD::I_IP] = fmaxf(rv[j][RD::I_IP], ip[j]);
                rv[j][RD::I_IP + 1] = fminf(rv[j][RD::I_IP + 1], ip[j]);
                if (kept) kept->ip = ip[j];
            }
            if (kept) {
                kept->sh = sh;
                kept->soft = soft_raw[j];
                kept->ignored = ignored;
            }
        } else {
            // the inter-pod range is seeded at 0 on both ends, so its masked 0 changes nothing
            if constexpr (NA) rv[j][RD::I_NA] = fmaxf(rv[j][RD::I_NA], 0.0f);
            if constexpr (TT) rv[j][RD::I_TT] = fmaxf(rv[j][RD::I_TT], 0.0f);
        }
        rv[j][4] = fmaxf(rv[j][4], feasible[j]);
        if (kept) kept->feas = feasible[j] > 0.0f;
    }
}

// Pass 3's score of a feasible node for one slot (pallas_scan.py:588-711),
// added in the reference's order: ((least + balanced) + 2 share) + 2
// spread, then the score tables, binpack and inter-pod scores. With CFG,
// each part times the config's weight, summed from 0 in score_parts order
// (opensim_tpu/ops/kernels.py:918-979, pod_step :1073-1075), a part of
// weight 0 left out. `rv` holds the slot's reduced pass-2 values (Red's
// order); `lr()` gives the node's binpack raw score, read only where the
// binpack range is positive and its weight is not 0.
template <bool NA, bool TT, bool AV, bool LOC, bool IP, bool CFG, class PD, class LR>
__device__ __forceinline__ float score_of(const FastScanArgs& a, const PD& p, float alloc_cpu, float alloc_mem,
                                          float used_cpu, float used_mem, float sh, float soft_raw, float ignored,
                                          float ip, LR lr, float na, float tt, float avoid, bool any_soft,
                                          const float* rv) {
    using RD = Red<NA, TT, LOC, IP>;
    const float lo = rv[0], rng = rv[1] - lo, smn = rv[2], smx = rv[3];
    const float ucpu = used_cpu + p.cpu_req();
    const float umem = used_mem + p.mem_req();
    const float l_cpu =
        (alloc_cpu == 0.0f || ucpu > alloc_cpu) ? 0.0f : (alloc_cpu - ucpu) * MAX_SCORE / fmaxf(alloc_cpu, 1.0f);
    const float l_mem =
        (alloc_mem == 0.0f || umem > alloc_mem) ? 0.0f : (alloc_mem - umem) * MAX_SCORE / fmaxf(alloc_mem, 1.0f);
    const float least = (l_cpu + l_mem) / 2.0f;
    const float cpu_frac = ucpu / fmaxf(alloc_cpu, 1.0f);
    const float mem_frac = umem / fmaxf(alloc_mem, 1.0f);
    const float balanced =
        (cpu_frac >= 1.0f || mem_frac >= 1.0f) ? 0.0f : (1.0f - fabsf(cpu_frac - mem_frac)) * MAX_SCORE;
    const float share_norm = rng > 0.0f ? (sh - lo) * MAX_SCORE / rng : 0.0f;
    float spread_norm = smx <= 0.0f ? MAX_SCORE : MAX_SCORE * (smx + smn - soft_raw) / fmaxf(smx, 1.0f);
    if (ignored > 0.0f) spread_norm = 0.0f;
    if (!any_soft) spread_norm = 0.0f;
    if constexpr (CFG) {
        float s = 0.0f;
        if (a.w_balanced != 0.0f) s = s + a.w_balanced * balanced;
        if (a.w_least != 0.0f) s = s + a.w_least * least;
        if constexpr (NA) {
            const float na_max = rv[RD::I_NA];
            if (a.w_node_affinity != 0.0f)
                s = s + a.w_node_affinity * (na_max > 0.0f ? na * MAX_SCORE / fmaxf(na_max, 1.0f) : na);
        }
        if constexpr (TT) {
            const float tt_max = rv[RD::I_TT];
            if (a.w_taint_toleration != 0.0f)
                s = s + a.w_taint_toleration *
                            (tt_max > 0.0f ? MAX_SCORE - tt * MAX_SCORE / fmaxf(tt_max, 1.0f) : MAX_SCORE);
        }
        if constexpr (IP) {
            const float ip_lo = rv[RD::I_IP + 1], ip_rng = rv[RD::I_IP] - ip_lo;
            if (a.w_interpod != 0.0f)
                s = s + a.w_interpod * (ip_rng > 0.0f ? MAX_SCORE * (ip - ip_lo) / fmaxf(ip_rng, 1.0f) : 0.0f);
        }
        if (a.w_spread != 0.0f) s = s + a.w_spread * spread_norm;
        if (a.w_share != 0.0f) s = s + a.w_share * share_norm;
        if constexpr (LOC) {
            const float l_lo = rv[RD::I_LOC], l_rng = rv[RD::I_LOC + 1] - l_lo;
            if (a.w_local != 0.0f) s = s + a.w_local * (l_rng > 0.0f ? (lr() - l_lo) * MAX_SCORE / l_rng : 0.0f);
        }
        if constexpr (AV)
            if (a.w_prefer_avoid != 0.0f) s = s + a.w_prefer_avoid * avoid;
        return s;
    }
    float s = least + balanced + 2.0f * share_norm + 2.0f * spread_norm;
    if constexpr (NA) {
        const float na_max = rv[RD::I_NA];
        s = s + (na_max > 0.0f ? na * MAX_SCORE / fmaxf(na_max, 1.0f) : na);
    }
    if constexpr (TT) {
        const float tt_max = rv[RD::I_TT];
        s = s + (tt_max > 0.0f ? MAX_SCORE - tt * MAX_SCORE / fmaxf(tt_max, 1.0f) : MAX_SCORE);
    }
    if constexpr (AV) s = s + AVOID_WEIGHT * avoid;
    if constexpr (LOC) {
        const float l_lo = rv[RD::I_LOC], l_rng = rv[RD::I_LOC + 1] - l_lo;
        s = s + (l_rng > 0.0f ? (lr() - l_lo) * MAX_SCORE / l_rng : 0.0f);
    }
    if constexpr (IP) {
        const float ip_lo = rv[RD::I_IP + 1], ip_rng = rv[RD::I_IP] - ip_lo;
        s = s + (ip_rng > 0.0f ? MAX_SCORE * (ip - ip_lo) / fmaxf(ip_rng, 1.0f) : 0.0f);
    }
    return s;
}

// Pass 3's score of node n for every slot in `want` (those for which the
// node is feasible), its values computed afresh from the state. Slot j
// normalises with its reduced pass-2 values at red + j * MAX_RED, gc_dyn
// its dynamic gpu-count allocatable.
template <bool GC, bool NA, bool TT, bool AV, bool LOC, bool IP, bool CFG, class Sl, class Cn, class TN, class PD>
__device__ __forceinline__ void node_score(const FastScanArgs& a, const Sl& S, const Cn& cs, const TN& t,
                                           const PD& p, int n,
                                           const float (&gc_dyn)[Sl::NB], float gc_has_dev, bool any_soft,
                                           const float* red, unsigned want, float (&score)[Sl::NB]) {
    constexpr int NB = Sl::NB;
    const float alloc_cpu = t.alloc_cpu();
    const float alloc_mem = t.alloc_mem();
    float used_cpu[NB], used_mem[NB], soft_raw[NB], ignored, ip[NB];
#pragma unroll
    for (int j = 0; j < NB; ++j) {
        const bool on = want >> j & 1u;
        used_cpu[j] = on ? S.used(j, RES_CPU, n) : 0.0f;
        used_mem[j] = on ? S.used(j, RES_MEMORY, n) : 0.0f;
    }
    node_soft(a, S, cs, t, n, want, soft_raw, ignored);
    if constexpr (IP) interpod_raw(a, S, t, p.u, n, want, ip);
#pragma unroll
    for (int j = 0; j < NB; ++j) {
        if (!(want >> j & 1u)) continue;
        const float sh = share_of<GC>(t, p, GC ? gc_dyn[j] : 0.0f, gc_has_dev);
        score[j] = score_of<NA, TT, AV, LOC, IP, CFG>(
            a, p, alloc_cpu, alloc_mem, used_cpu[j], used_mem[j], sh, soft_raw[j], ignored, IP ? ip[j] : 0.0f,
            [&] { return local_raw_of(a, S, j, p.u, n); }, NA ? t.na() : 0.0f, TT ? t.tt() : 0.0f,
            AV ? t.avoid() : 0.0f, any_soft, red + j * MAX_RED);
    }
}

// Device packing of template u on node c for slot j (pallas_scan.py:
// 759-782): one GPU takes the tightest fit (first among equals), several
// take greedy chunks with reuse, in device order. Writes node c's gpu_free
// column and pod i's gpu_take row.
template <class Sl>
__device__ __forceinline__ void gpu_bind(const FastScanArgs& a, const Sl& S, int j, int i, int u, int c) {
    const float gmem = a.gpu_mem[u];
    const float gcnt = a.gpu_cnt[u];
    float best_free = BIG;
    for (int d = 0; d < a.Gd; ++d) {
        const float free_d = S.gpu_free(j, d, c);
        if (free_d >= gmem) best_free = fminf(best_free, free_d);
    }
    float assigned = 0.0f, cum = 0.0f;
    for (int d = 0; d < a.Gd; ++d) {
        const float free_d = S.gpu_free(j, d, c);
        const float fits_d = free_d >= gmem ? 1.0f : 0.0f;
        const float take_tight = fits_d * (free_d == best_free ? 1.0f : 0.0f) * (1.0f - fminf(assigned, 1.0f));
        assigned = assigned + take_tight;
        const float chunks_d = floorf(free_d / fmaxf(gmem, 1.0f));
        const float take_greedy = fminf(fmaxf(gcnt - cum, 0.0f), chunks_d);
        cum = cum + chunks_d;
        float take_d = gcnt == 1.0f ? take_tight : take_greedy;
        take_d = gmem > 0.0f ? take_d : 0.0f;
        S.gpu_free(j, d, c) = free_d - take_d * gmem;
        a.gpu_take[(S.pod0(j) + i) * a.Gd + d] = take_d;
    }
}

// Bind of pod i (template u) on node c for slot j: only node c's column
// changes (and the small state). Threads tid, tid + nt, ... of the block
// write the rows: node c's where the view owns node c (a cluster CTA owns
// its slice), the small state in every block (each cluster CTA keeps a
// copy); the thread that owns node c packs its GPUs, volume groups and
// devices.
template <bool GPU, bool PORTS, bool IP, bool LOC, class Sl>
__device__ __forceinline__ void bind_pod(const FastScanArgs& a, const Sl& S, int j, int i, int u, int c, int tid,
                                         int nt) {
    const bool own = S.owns(c);
    const int A = a.A, K = a.K;
    if (own && tid < a.R) S.used(j, tid, c) += a.req[u * a.R + tid];
    for (int q = tid; q < A; q += nt) {
        const float m = a.matches[(size_t)q * a.U + u];
        if (own) S.node_cnt(j, q, c) += m;
        if constexpr (IP) S.sel_total(j, q) += m;
        for (int k = 0; k < K; ++k) {
            const int z = a.zone_idx[(size_t)k * a.N + c];
            if (z >= 0) {
                S.zone_cnt(j, ((size_t)k * A + q) * a.Z + z) += m;
                if constexpr (IP) S.sel_total(j, (k + 1) * A + q) += m;
            }
        }
    }
    // the template's own ports, not the conflict rows
    if constexpr (PORTS)
        if (own)
            for (int h = tid; h < a.Hp; h += nt) S.port_used(j, h, c) += a.port_hu[(size_t)h * a.U + u];
    if constexpr (IP) {
        for (int g = tid; g < a.G; g += nt) term_bind<false>(a, S, j, g, a.anti_g_key[g], c, a.antig[(size_t)g * a.U + u]);
        for (int g = tid; g < a.Gp; g += nt) term_bind<true>(a, S, j, g, a.prefg_key[g], c, a.prefg[(size_t)g * a.U + u]);
    }
    if (own && tid == S.owned(c) % nt) {
        if constexpr (GPU) gpu_bind(a, S, j, i, u, c);
        if constexpr (LOC) local_bind(a, S, j, u, c);
    }
}

// The inter-pod bootstrap of slot j (pallas_scan.py:520-542): no pod yet
// matches the affinity terms anywhere and the pod matches them itself. The
// same for every node.
template <class Sl>
__device__ __forceinline__ bool at_bootstrap_of(const FastScanArgs& a, const Sl& S, int j, int u) {
    float map_total = 0.0f, self_all = 1.0f;
    for (int k = 0; k < a.Ti; ++k) {
        const int uk = u * a.Ti + k;
        if (a.at_active[uk] != 1) continue;
        map_total = map_total + S.sel_total(j, a.at_key[uk] * a.A + a.at_sel[uk]);
        self_all = self_all * (a.at_self[uk] > 0.0f ? 1.0f : 0.0f);
    }
    return map_total == 0.0f && self_all > 0.0f;
}

// State init of the scan at offset `off`: a copy of the given state's row
// at `off` where there is one (CFG variants), else used <- used0, counts
// <- 0, gpu_free <- gpu0, vg_free <- vg0, dev_free <- dev0.
template <bool GPU, bool PORTS, bool IP, bool LOC, bool CFG>
__device__ __forceinline__ void init_state(const FastScanArgs& a, size_t off, int tid, int nt) {
    if (CFG && a.init != nullptr) {
        for (size_t j = tid; j < (size_t)a.W; j += nt) a.used[off + j] = a.init[off + j];
        return;
    }
    const size_t N = a.N, A = a.A, K = a.K, Z = a.Z;
    for (size_t j = tid; j < (size_t)a.R * N; j += nt) a.used[off + j] = a.used0[j];
    for (size_t j = tid; j < A * N; j += nt) a.node_cnt[off + j] = 0.0f;
    for (size_t j = tid; j < K * A * Z; j += nt) a.zone_cnt[off + j] = 0.0f;
    if constexpr (GPU)
        for (size_t j = tid; j < (size_t)a.Gd * N; j += nt) a.gpu_free[off + j] = a.gpu0[j];
    if constexpr (PORTS)
        for (size_t j = tid; j < (size_t)a.Hp * N; j += nt) a.port_used[off + j] = 0.0f;
    if constexpr (IP) {
        for (size_t j = tid; j < (size_t)a.G * N; j += nt) a.anti_node[off + j] = 0.0f;
        for (size_t j = tid; j < (size_t)a.G * Z; j += nt) a.anti_zone[off + j] = 0.0f;
        for (size_t j = tid; j < (size_t)a.Gp * N; j += nt) a.prefw_node[off + j] = 0.0f;
        for (size_t j = tid; j < (size_t)a.Gp * Z; j += nt) a.prefw_zone[off + j] = 0.0f;
        for (size_t j = tid; j < (K + 1) * A; j += nt) a.sel_total[off + j] = 0.0f;
    }
    if constexpr (LOC) {
        for (size_t j = tid; j < (size_t)a.Vg * N; j += nt) a.vg_free[off + j] = a.vg0[j];
        for (size_t j = tid; j < (size_t)a.Dv * N; j += nt) a.dev_free[off + j] = a.dev0[j];
    }
}

// One scan's state at the start, for the nodes CTA `rank` owns: the
// given state where there is one (INIT variants only), else
// used <- used0, counts <- 0, gpu_free <- gpu0, vg_free <- vg0, dev_free
// <- dev0; its copy of the small state likewise, from the given state or
// 0; with RES = 1, the slice's constant node tables copied into shared
// memory too. Each thread fills its own nodes' rows, so neighbouring
// threads read neighbouring nodes.
template <bool GPU, bool GC, bool PORTS, bool IP, bool LOC, bool INIT, int RES>
__device__ __forceinline__ void load_slice(const FastScanArgs& a, const Slice<RES>& S, int tid) {
    const size_t N = a.N;
    const bool init = INIT && a.init != nullptr;
    for (int n = S.n0 + tid; n < S.n1; n += NT) {
        for (int r = 0; r < a.R; ++r) S.used(0, r, n) = init ? given(a, a.used, r * N + n) : a.used0[r * N + n];
        for (int q = 0; q < a.A; ++q) S.node_cnt(0, q, n) = init ? given(a, a.node_cnt, q * N + n) : 0.0f;
        if constexpr (GPU)
            for (int d = 0; d < a.Gd; ++d)
                S.gpu_free(0, d, n) = init ? given(a, a.gpu_free, d * N + n) : a.gpu0[d * N + n];
        if constexpr (PORTS)
            for (int h = 0; h < a.Hp; ++h) S.port_used(0, h, n) = init ? given(a, a.port_used, h * N + n) : 0.0f;
        if constexpr (IP) {
            for (int g = 0; g < a.G; ++g) S.anti_node(0, g, n) = init ? given(a, a.anti_node, g * N + n) : 0.0f;
            for (int g = 0; g < a.Gp; ++g) S.prefw_node(0, g, n) = init ? given(a, a.prefw_node, g * N + n) : 0.0f;
        }
        if constexpr (LOC) {
            for (int v = 0; v < a.Vg; ++v)
                S.vg_free(0, v, n) = init ? given(a, a.vg_free, v * N + n) : a.vg0[v * N + n];
            for (int d = 0; d < a.Dv; ++d)
                S.dev_free(0, d, n) = init ? given(a, a.dev_free, d * N + n) : a.dev0[d * N + n];
        }
        if constexpr (RES) {
            for (int r = 0; r < a.R; ++r) S.template sm<float>(a.o_alloc, r, n) = a.alloc[r * N + n];
            for (int k = 0; k < a.K; ++k) S.template sm<int32_t>(a.o_zone, k, n) = a.zone_idx[k * N + n];
            S.template sm<float>(a.o_nv, 0, n) = a.node_valid[n];
            if constexpr (GC)
                for (int d = 0; d < a.Gd; ++d) S.template sm<float>(a.o_gpu0, d, n) = a.gpu0[d * N + n];
            if constexpr (LOC) {
                for (int v = 0; v < a.Vg; ++v) S.template sm<float>(a.o_vg_cap, v, n) = a.vg_cap[v * N + n];
                for (int d = 0; d < a.Dv; ++d) S.template sm<float>(a.o_dev_cap, d, n) = a.dev_cap[d * N + n];
                for (int md = 0; md < 2 * a.Dv; ++md)
                    S.template sm<float>(a.o_dev_media, md, n) = a.dev_media[md * N + n];
            }
        }
    }
    if (!init) {
        for (int k = tid; k < a.Wrep; k += NT) S.small(0, k) = 0.0f;
        return;
    }
    const int KA = a.K * a.A, Z = a.Z;
    for (int k = tid; k < KA * Z; k += NT) S.zone_cnt(0, k) = given(a, a.zone_cnt, k);
    if constexpr (IP) {
        for (int k = tid; k < a.G * Z; k += NT) S.anti_zone(0, k / Z, k % Z) = given(a, a.anti_zone, k);
        for (int k = tid; k < a.Gp * Z; k += NT) S.prefw_zone(0, k / Z, k % Z) = given(a, a.prefw_zone, k);
        for (int k = tid; k < KA + a.A; k += NT) S.sel_total(0, k) = given(a, a.sel_total, k);
    }
}

// One scan's state at the end, into its buffers at offset 0: with RES = 1
// each CTA writes its slice's rows; CTA 0 writes its copy of the small
// state (every copy is the same).
template <bool GPU, bool PORTS, bool IP, bool LOC, int RES>
__device__ __forceinline__ void store_slice(const FastScanArgs& a, const Slice<RES>& S, int rank, int tid) {
    const size_t N = a.N;
    if constexpr (RES) {
        for (int n = S.n0 + tid; n < S.n1; n += NT) {
            for (int r = 0; r < a.R; ++r) a.used[r * N + n] = S.used(0, r, n);
            for (int q = 0; q < a.A; ++q) a.node_cnt[q * N + n] = S.node_cnt(0, q, n);
            if constexpr (GPU)
                for (int d = 0; d < a.Gd; ++d) a.gpu_free[d * N + n] = S.gpu_free(0, d, n);
            if constexpr (PORTS)
                for (int h = 0; h < a.Hp; ++h) a.port_used[h * N + n] = S.port_used(0, h, n);
            if constexpr (IP) {
                for (int g = 0; g < a.G; ++g) a.anti_node[g * N + n] = S.anti_node(0, g, n);
                for (int g = 0; g < a.Gp; ++g) a.prefw_node[g * N + n] = S.prefw_node(0, g, n);
            }
            if constexpr (LOC) {
                for (int v = 0; v < a.Vg; ++v) a.vg_free[v * N + n] = S.vg_free(0, v, n);
                for (int d = 0; d < a.Dv; ++d) a.dev_free[d * N + n] = S.dev_free(0, d, n);
            }
        }
    }
    if (rank != 0) return;
    const int KA = a.K * a.A, Z = a.Z;
    for (int k = tid; k < KA * Z; k += NT) a.zone_cnt[k] = S.zone_cnt(0, k);
    if constexpr (IP) {
        for (int k = tid; k < a.G * Z; k += NT) a.anti_zone[k] = S.anti_zone(0, k / Z, k % Z);
        for (int k = tid; k < a.Gp * Z; k += NT) a.prefw_zone[k] = S.prefw_zone(0, k / Z, k % Z);
        for (int k = tid; k < KA + a.A; k += NT) a.sel_total[k] = S.sel_total(0, k);
    }
}

// The step's hard-spread minimum counts, by value: the counting pass is not
// inlined, and a pointer to the step's array would put it in local memory.
struct MinCnt {
    float v[MAX_CS];
};

__device__ __forceinline__ unsigned long long global_ns() {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    return t;
}

// The counting pass of pod i (template u), which found no node
// (kernels.pod_step's count_fails): over the nodes of this CTA's slice that
// pass the static row and node validity, each counts under the first
// dynamic filter it fails, in the reference's order (ports, fit, spread,
// inter-pod, gpu, local; extra has none), and, where it passes ports, under
// each resource it lacks. Each filter's verdict comes from node_feasible
// itself, the same helpers and float expressions as the feasibility test,
// never from another formula. The counts are summed over the block (warp
// reductions, a value per warp in shared memory), then CTA 0 sums the CL
// CTAs' through distributed shared memory after one cluster barrier and
// writes row i. CTA 0's first thread adds the pass's global-timer
// nanoseconds to count_clock[0] and one to count_clock[1].
template <bool GPU, bool GC, bool PORTS, bool IP, bool LOC, bool CFG, int RES>
__device__ __noinline__ void count_fails(const FastScanArgs& a, const Slice<RES> S, int i, int u, const MinCnt mc,
                                         unsigned boot, ScanShared& sh) {
    const cg::cluster_group cluster = cg::this_cluster();
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const bool first = cluster.block_rank() == 0;
    const unsigned long long t0 = first && tid == 0 ? global_ns() : 0ull;
    const Pod<false> p(a, u);
    GCons cs(a, u);
    cs.hard = hard_cons<CFG>(a, cs.hard);
    int cnt[N_FAIL + MAX_R];  // the filters' slots, then the resource rows
#pragma unroll
    for (int k = 0; k < N_FAIL + MAX_R; ++k) cnt[k] = 0;
    for (int n = S.n0 + tid; n < S.n1; n += NT) {
        const TNode<false, Slice<RES>> t(a, S, u, n);
        if (!(t.sp() * S.valid(0, n) > 0.0f)) continue;  // the static row: the template's static_fail counts it
        float feasible[1], gc_dyn[1], gc_has_dev = 0.0f;
        Verdicts vd{0u, 0u};
        node_feasible<GPU, GC, PORTS, IP, LOC, CFG>(a, S, cs, t, p, n, mc.v, boot, 1u, feasible, gc_dyn, gc_has_dev,
                                                    &vd);
        const int f = vd.fail ? __ffs(vd.fail) - 1 : N_FAIL;  // the bits lie in the order of attribution
#pragma unroll
        for (int k = 0; k < N_FAIL; ++k) cnt[k] += k == f ? 1 : 0;
        if (!(vd.fail >> V_PORTS & 1u)) {
#pragma unroll
            for (int r = 0; r < MAX_R; ++r) cnt[N_FAIL + r] += vd.shortage >> r & 1u;
        }
    }
#pragma unroll
    for (int k = 0; k < N_FAIL + MAX_R; ++k) {
        const int x = __reduce_add_sync(FULL_MASK, cnt[k]);
        if (lane == 0) sh.cwarp[k][warp] = x;
    }
    __syncthreads();
    if (tid < N_FAIL + MAX_R) {
        int x = 0;
        for (int w = 0; w < NWARP; ++w) x += sh.cwarp[tid][w];
        sh.cpart[tid] = x;
    }
    cluster.sync();
    if (first && tid < N_FAIL + a.R) {
        int x = 0;
#pragma unroll
        for (int r = 0; r < CL; ++r) x += *cluster.map_shared_rank(&sh.cpart[tid], r);
        if (tid < N_FAIL)
            a.fail_counts[(size_t)i * N_FAIL + tid] = x;
        else
            a.insufficient[(size_t)i * a.R + tid - N_FAIL] = x;
    }
    if (first && tid == 0) {
        a.count_clock[0] += global_ns() - t0;
        a.count_clock[1] += 1ull;
    }
}

// One scan over the whole pod stream, on a cluster of CL CTAs, CTA r
// owning nodes [r·Nc, (r + 1)·Nc) (Slice<RES>). Every CTA walks the same
// pods and takes the same branches; a step's node-axis reductions go
// through the cluster (cluster_reduce, cluster_argmax), so every CTA knows
// the choice, and the bind touches the owner's slice and every CTA's copy
// of the small state.
template <bool GPU, bool GC, bool NA, bool TT, bool AV, bool PORTS, bool IP, bool LOC, bool CFG, bool SAMPLE,
          bool EXPLAIN, int RES>
__global__ void __launch_bounds__(NT, 1) fast_scan_kernel(const __grid_constant__ FastScanArgs a) {
    using SH = std::conditional_t<SAMPLE, ScanSharedDrawn, ScanShared>;
    static_assert(GPU || !GC, "the gpu-count allocatable follows the GPUs");
    static_assert(sizeof(SH) <= SCAN_STATIC_SMEM, "the host budgets the rest of shared memory for the slice");
    using RD = Red<NA, TT, LOC, IP>;
    using SL = Slice<RES>;
    using TN = TNode<false, SL>;
    __shared__ SH sh;
    const cg::cluster_group cluster = cg::this_cluster();
    const int tid = threadIdx.x, rank = (int)cluster.block_rank();
    const int N = a.N;
    const int n0 = min(rank * a.Nc, N), n1 = min(n0 + a.Nc, N);
    const SL S{a, n0, n1, RES ? nullptr : a.rep + (size_t)rank * a.Wrep};
    const bool lead = rank == 0 && tid == 0;  // writes chosen
    int par = 0;                              // parity of the reductions so far

    load_slice<GPU, GC, PORTS, IP, LOC, CFG>(a, S, tid);
    __syncthreads();

    for (int i = 0; i < a.P; ++i) {
        const int u = a.tmpl[i];
        if (a.valid[i] != 1 && (!EXPLAIN || a.forced[i] == 1)) {
            if (lead) a.chosen[i] = -1;
            continue;  // invalid pods touch no state (explain mode counts those not forced)
        }
        int choice;
        if (a.forced[i] == 1) {
            const int p = a.pin[u];
            choice = p >= 0 ? p : -1;
        } else {
            const Pod<false> p(a, u);
            GCons cs(a, u);
            cs.hard = hard_cons<CFG>(a, cs.hard);
            const unsigned boot = IP && at_bootstrap_of(a, S, 0, u) ? 1u : 0u;
            const bool any_soft = cs.soft != 0u;

            // --- pass 1: each hard constraint's min count over eligible
            // nodes (a soft constraint's minimum is read by nothing)
            float min_cnt[MAX_CS];
#pragma unroll
            for (int c = 0; c < MAX_CS; ++c) min_cnt[c] = BIG;
            if (cs.hard) {
                for (int n = n0 + tid; n < n1; n += NT) {
                    const TN t(a, S, u, n);
                    const float aff = a.aff_mask[(size_t)u * N + n];
#pragma unroll
                    for (int c = 0; c < MAX_CS; ++c) {
                        if (!(cs.hard >> c & 1u)) continue;
                        float mn[1] = {min_cnt[c]};
                        elig_min(a, S, cs, t, c, n, aff, 1u, mn);
                        min_cnt[c] = mn[0];
                    }
                }
                cluster_reduce(min_cnt, [](int) { return false; }, sh, par, cluster);
            }
            if constexpr (EXPLAIN) {
                // explain mode: count this step against the state before
                // its bind; an invalid pod binds nothing
                MinCnt mc;
#pragma unroll
                for (int c = 0; c < MAX_CS; ++c) mc.v[c] = min_cnt[c];
                count_fails<GPU, GC, PORTS, IP, LOC, CFG, RES>(a, S, i, u, mc, boot, sh);
                if (a.valid[i] != 1) {
                    if (lead) a.chosen[i] = -1;
                    cluster.sync();  // CTA 0 has read the partials before the next count writes them
                    continue;
                }
            }

            // --- pass 2: the ranges, any-feasible and the maxima; the
            // first SCAN_NPT owned nodes keep their values for pass 3
            float rv[1][RD::N];
            RD::init(rv[0]);
            Kept kept[SCAN_NPT];
#pragma unroll
            for (int k = 0; k < SCAN_NPT; ++k) {
                const int n = n0 + tid + k * NT;
                kept[k].feas = false;
                if (n < n1) {
                    const TN t(a, S, u, n);
                    float feasible[1];
                    pass2_node<GPU, GC, NA, TT, PORTS, IP, LOC, CFG>(a, S, cs, t, p, n, min_cnt, boot, 1u, feasible,
                                                                     rv, &kept[k]);
                    if constexpr (NA) kept[k].na = t.na();
                    if constexpr (TT) kept[k].tt = t.tt();
                    if constexpr (AV) kept[k].av = t.avoid();
                }
            }
            for (int n = n0 + tid + SCAN_NPT * NT; n < n1; n += NT) {
                const TN t(a, S, u, n);
                float feasible[1];
                pass2_node<GPU, GC, NA, TT, PORTS, IP, LOC, CFG>(a, S, cs, t, p, n, min_cnt, boot, 1u, feasible, rv);
            }
            cluster_reduce(rv[0], [](int k) { return RD::is_max(k); }, sh, par, cluster);
            const float* red = rv[0];
            if (!(red[4] > 0.0f)) {
                // no node is feasible, in every CTA alike: count why (explain
                // mode has counted already)
                if constexpr (!EXPLAIN) {
                    MinCnt mc;
#pragma unroll
                    for (int c = 0; c < MAX_CS; ++c) mc.v[c] = min_cnt[c];
                    count_fails<GPU, GC, PORTS, IP, LOC, CFG, RES>(a, S, i, u, mc, boot, sh);
                }
                if (lead) a.chosen[i] = -1;
                continue;
            }

            // --- pass 3: score the feasible nodes (the kept ones from
            // their registers, the rest judged afresh), then the lowest
            // index among the maxima (SAMPLE: the highest draw among them,
            // then the lowest index)
            float best_s = NEG;
            unsigned best_d = 0u;
            int best_i = N;
            const auto keep = [&](float s, int n) {
                if constexpr (SAMPLE)
                    better<true>(best_s, best_d, best_i, s, philox_draw(a.key0, a.key1, (unsigned)(a.draw_base + i), n),
                                 n);
                else
                    better(best_s, best_i, s, n);
            };
#pragma unroll
            for (int k = 0; k < SCAN_NPT; ++k) {
                const Kept& kk = kept[k];
                if (!kk.feas) continue;
                const int n = n0 + tid + k * NT;
                keep(score_of<NA, TT, AV, LOC, IP, CFG>(
                         a, p, S.alloc(RES_CPU, n), S.alloc(RES_MEMORY, n), S.used(0, RES_CPU, n),
                         S.used(0, RES_MEMORY, n), kk.sh, kk.soft, kk.ignored, kk.ip, [&] { return kk.lr; }, kk.na,
                         kk.tt, kk.av, any_soft, red),
                     n);
            }
            for (int n = n0 + tid + SCAN_NPT * NT; n < n1; n += NT) {
                const TN t(a, S, u, n);
                float feasible[1], gc_dyn[1], gc_has_dev = 0.0f, score[1];
                node_feasible<GPU, GC, PORTS, IP, LOC, CFG>(a, S, cs, t, p, n, min_cnt, boot, 1u, feasible, gc_dyn,
                                                           gc_has_dev);
                if (feasible[0] > 0.0f) {
                    node_score<GC, NA, TT, AV, LOC, IP, CFG>(a, S, cs, t, p, n, gc_dyn, gc_has_dev, any_soft, red, 1u,
                                                             score);
                    keep(score[0], n);
                }
            }
            choice = cluster_argmax<SAMPLE>(best_s, best_d, best_i, N, sh, par, cluster);
        }
        if (lead) a.chosen[i] = choice;
        if (choice >= 0) {
            bind_pod<GPU, PORTS, IP, LOC>(a, S, 0, i, u, choice, tid, NT);
            __syncthreads();
        }
    }
    store_slice<GPU, PORTS, IP, LOC>(a, S, rank, tid);
    cluster.sync();  // no CTA leaves while a peer may still read its partials
}

// The grid's counting pass of pod i (template u) for the block's one
// scenario (COUNT: the pod found no node; EXPLAIN: any step not forced):
// count_fails's attribution over all N nodes through the one-slot view,
// the counts summed by warp reductions, then over the block's warps in
// `buf` (the reductions' first-level scratch, free here; ints held as
// float bits), and written into the scenario's row i. Not inlined, as
// count_fails is not.
template <bool GPU, bool GC, bool PORTS, bool IP, bool LOC, bool CFG>
__device__ __noinline__ void sweep_count_fails(const FastScanArgs& a, const OneSlot S, int i, int u, const MinCnt mc,
                                               unsigned boot, float (*buf)[SW_NWARP]) {
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const Pod<false> p(a, u);
    GCons cs(a, u);
    cs.hard = hard_cons<CFG>(a, cs.hard);
    int cnt[N_FAIL + MAX_R];  // the filters' slots, then the resource rows
#pragma unroll
    for (int k = 0; k < N_FAIL + MAX_R; ++k) cnt[k] = 0;
    for (int n = tid; n < a.N; n += SW_NT) {
        const TNode<false, OneSlot> t(a, S, u, n);
        if (!(t.sp() * S.valid(0, n) > 0.0f)) continue;  // the static row: the template's static_fail counts it
        float feasible[1], gc_dyn[1], gc_has_dev = 0.0f;
        Verdicts vd{0u, 0u};
        node_feasible<GPU, GC, PORTS, IP, LOC, CFG>(a, S, cs, t, p, n, mc.v, boot, 1u, feasible, gc_dyn, gc_has_dev,
                                                    &vd);
        const int f = vd.fail ? __ffs(vd.fail) - 1 : N_FAIL;  // the bits lie in the order of attribution
#pragma unroll
        for (int k = 0; k < N_FAIL; ++k) cnt[k] += k == f ? 1 : 0;
        if (!(vd.fail >> V_PORTS & 1u)) {
#pragma unroll
            for (int r = 0; r < MAX_R; ++r) cnt[N_FAIL + r] += vd.shortage >> r & 1u;
        }
    }
#pragma unroll
    for (int k = 0; k < N_FAIL + MAX_R; ++k) {
        const int x = __reduce_add_sync(FULL_MASK, cnt[k]);
        if (lane == 0) buf[k][warp] = __int_as_float(x);
    }
    __syncthreads();
    if (tid < N_FAIL + a.R) {
        int x = 0;
        for (int w = 0; w < SW_NWARP; ++w) x += __float_as_int(buf[tid][w]);
        const size_t row = S.pod0(0) + i;
        if (tid < N_FAIL)
            a.fail_counts[row * N_FAIL + tid] = x;
        else
            a.insufficient[row * a.R + tid - N_FAIL] = x;
    }
    __syncthreads();  // buf is free again for the step's next reduction
}

// Second level of a sweep reduction: warp w reduces values w, w +
// SW_NWARP, ... of the `nv` values whose first level lies in buf[v][warp]
// (v = the value's slot in `out`, from `slot(idx)`), min or max by
// `is_max(idx)`, skipping values `skip(idx)`.
template <class Slot, class IsMax, class Skip>
__device__ __forceinline__ void reduce_level2(float (*buf)[SW_NWARP], int nv, Slot slot, IsMax is_max, Skip skip,
                                              float* out) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    for (int idx = warp; idx < nv; idx += SW_NWARP) {
        if (skip(idx)) continue;
        const int v = slot(idx);
        const bool mx = is_max(idx);
        float x = lane < SW_NWARP ? buf[v][lane] : (mx ? NEG : BIG);
        x = mx ? warp_max(x) : warp_min(x);
        if (lane == 0) out[v] = x;
    }
}

// The scenario grid: block b runs scenarios b·B ... b·B + B - 1 (fewer in
// a ragged last block) in lockstep through the pod stream. Slot j of the
// block is scenario b·B + j. COUNT and EXPLAIN (B = 1) count slot 0's
// steps (sweep_count_fails).
template <bool GPU, bool GC, bool NA, bool TT, bool AV, bool PORTS, bool IP, bool LOC, bool CFG, bool COUNT,
          bool EXPLAIN>
__global__ void __launch_bounds__(SW_NT, 1) fast_scan_sweep_kernel(const __grid_constant__ FastScanArgs a) {
    static_assert(GPU || !GC, "the gpu-count allocatable follows the GPUs");
    static_assert(!(COUNT && EXPLAIN), "explain mode counts every step already");
    using RD = Red<NA, TT, LOC, IP>;
    constexpr int NR = RD::N;
    struct Shared {
        float buf[BMAX * MAX_RED][SW_NWARP];  // first level of a reduction, value-major
        float red[BMAX * MAX_RED];            // slot j's reduced pass-2 values (Red's order) at j * MAX_RED
        float mn[BMAX * MAX_CS];              // slot j's hard-spread minimum counts at j * MAX_CS
        float sbuf[BMAX][SW_NWARP];           // first level of selectHost
        int ibuf[BMAX][SW_NWARP];
        int best[BMAX];
        StepCons cons;                        // the step's spread constraints
    };
    static_assert(sizeof(Shared) <= SWEEP_STATIC_SMEM, "the host budgets the rest of shared memory for the masks");
    __shared__ Shared sh;
    extern __shared__ uint32_t dyn[];  // node-validity bits [B][Nw], then feasibility bits [B][Nw]

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int N = a.N, Cs = a.Cs, Nw = a.Nw;
    const int s0 = blockIdx.x * a.B;
    const int nb = min(a.B, a.S - s0);  // slots holding a scenario
    Slots S{a, s0, nb - 1, a.W, a.P, Nw, a.bits_in_smem ? dyn : a.nv_bits + (size_t)s0 * Nw, 0, 0, 0, 0};
    S.init_offsets();
    SCons cs{sh.cons, 0u, 0u};
    uint32_t* const feas_bits = a.bits_in_smem ? dyn + (size_t)a.B * Nw : a.feas_bits + (size_t)s0 * Nw;

    for (int j = 0; j < nb; ++j) init_state<GPU, PORTS, IP, LOC, CFG>(a, S.off(j), tid, SW_NT);
    if (a.bits_in_smem)
        for (int w = tid; w < nb * Nw; w += SW_NT) dyn[w] = a.nv_bits[(size_t)s0 * Nw + w];
    __syncthreads();

    for (int i = 0; i < a.P; ++i) {
        const int u = a.tmpl[i];
        unsigned act = 0u, frc = 0u, aud = 0u;  // bit j: slot j's pod i is valid; it is forced; EXPLAIN counts it
#pragma unroll
        for (int j = 0; j < BMAX; ++j) {
            if (j >= nb) continue;
            const size_t k = S.pod0(j) + i;
            if (a.valid[k] == 1) {
                act |= 1u << j;
                if (a.forced[k] == 1) frc |= 1u << j;
            }
            if constexpr (EXPLAIN)
                if (a.forced[k] != 1) aud |= 1u << j;
        }
        const unsigned sched = act & ~frc;  // the slots that schedule pod i; the same in every thread
        // the slots that run pass 1: those that schedule, and in explain
        // mode those that count too (invalid and not forced)
        const unsigned run = EXPLAIN ? aud : sched;
        if (run) {
            const Pod<true> p(a, u);
            if (tid < BMAX * MAX_CS) {  // stage the step's constraints and each slot's spread weights
                const int j = tid / MAX_CS, c = tid % MAX_CS;
                if (c < Cs) {
                    const GCons g(a, u);
                    if (j == 0) {
                        sh.cons.key[c] = g.key(c);
                        sh.cons.sel[c] = g.sel(c);
                        sh.cons.skew[c] = g.skew(c);
                        sh.cons.self[c] = g.self(c);
                    }
                    sh.cons.w[j][c] = a.spr_weight[(size_t)S.scn(j) * a.U * Cs + g.uc(c)];
                }
            }
            __syncthreads();
            cons_masks(a, u, cs.hard, cs.soft);
            cs.hard = hard_cons<CFG>(a, cs.hard);
            unsigned boot = 0u;  // bit j: slot j's inter-pod bootstrap
            if constexpr (IP) {
#pragma unroll
                for (int j = 0; j < BMAX; ++j)
                    if (run >> j & 1u && at_bootstrap_of(a, S, j, u)) boot |= 1u << j;
            }
            bool any_soft = false;
            for (int c = 0; c < Cs; ++c) any_soft |= a.spr_active[u * Cs + c] == 1 && a.spr_hard[u * Cs + c] == 0;

            // --- pass 1: each hard constraint's min count over eligible
            // nodes, per slot (a soft constraint's minimum is read by nothing)
            if (cs.hard) {
                for (unsigned m = cs.hard; m; m &= m - 1u) {
                    const int c = __ffs(m) - 1;
                    float mn[BMAX];
#pragma unroll
                    for (int j = 0; j < BMAX; ++j) mn[j] = BIG;
                    for (int n = tid; n < N; n += SW_NT) {
                        TNode<true, Slots> t(a, S, u, n);
                        t.load_zones(S);
                        elig_min(a, S, cs, t, c, n, a.aff_mask[(size_t)u * N + n], run, mn);
                    }
#pragma unroll
                    for (int j = 0; j < BMAX; ++j) {
                        if (!(run >> j & 1u)) continue;
                        const float v = warp_min(mn[j]);
                        if (lane == 0) sh.buf[j * MAX_CS + c][warp] = v;
                    }
                }
                __syncthreads();
                reduce_level2(
                    sh.buf, BMAX * Cs, [&](int idx) { return (idx / Cs) * MAX_CS + idx % Cs; },
                    [](int) { return false; },
                    [&](int idx) { return !(run >> (idx / Cs) & 1u) || !(cs.hard >> (idx % Cs) & 1u); },
                    sh.mn);
                __syncthreads();
            }
            // the counting pass of the block's one slot (B = 1): explain
            // mode counts here, against the state before the step's bind
            const auto count_slot0 = [&] {
                MinCnt mc;
#pragma unroll
                for (int c = 0; c < MAX_CS; ++c) mc.v[c] = sh.mn[c];
                sweep_count_fails<GPU, GC, PORTS, IP, LOC, CFG>(a, OneSlot{S}, i, u, mc, boot & 1u, sh.buf);
            };
            if constexpr (EXPLAIN) count_slot0();
            if (sched) {  // explain mode: an invalid pod has counted and binds nothing

                // --- pass 2: per slot, the ranges, any-feasible and the maxima,
                // and each node's feasibility bit for pass 3
                float rv[BMAX][NR];
#pragma unroll
                for (int j = 0; j < BMAX; ++j) RD::init(rv[j]);
                for (int base = warp * 32; base < N; base += SW_NT) {
                    const int n = base + lane;
                    const bool in = n < N;
                    float feasible[BMAX];
#pragma unroll
                    for (int j = 0; j < BMAX; ++j) feasible[j] = 0.0f;
                    if (in) {
                        TNode<true, Slots> t(a, S, u, n);
                        t.load<GC, NA, TT, AV, true, false>(p, S);
                        pass2_node<GPU, GC, NA, TT, PORTS, IP, LOC, CFG>(a, S, cs, t, p, n, sh.mn, boot, sched,
                                                                         feasible, rv);
                    }
#pragma unroll
                    for (int j = 0; j < BMAX; ++j) {
                        if (!(sched >> j & 1u)) continue;
                        const unsigned word = __ballot_sync(FULL_MASK, feasible[j] > 0.0f);
                        if (lane == 0) feas_bits[(size_t)j * Nw + (base >> 5)] = word;
                    }
                }
#pragma unroll
                for (int j = 0; j < BMAX; ++j) {
                    if (!(sched >> j & 1u)) continue;
#pragma unroll
                    for (int k = 0; k < NR; ++k) {
                        const float v = RD::is_max(k) ? warp_max(rv[j][k]) : warp_min(rv[j][k]);
                        if (lane == 0) sh.buf[j * MAX_RED + k][warp] = v;
                    }
                }
                __syncthreads();
                reduce_level2(
                    sh.buf, BMAX * NR, [](int idx) { return (idx / NR) * MAX_RED + idx % NR; },
                    [](int idx) { return RD::is_max(idx % NR); },
                    [&](int idx) { return !(sched >> (idx / NR) & 1u); }, sh.red);
                __syncthreads();
                // the grid's count: the block's one slot found no node
                if constexpr (COUNT)
                    if (!(sh.red[4] > 0.0f)) count_slot0();

                // --- pass 3: per slot, score the feasible nodes and keep the
                // lowest index among the maxima
                float best_s[BMAX];
                int best_i[BMAX];
#pragma unroll
                for (int j = 0; j < BMAX; ++j) {
                    best_s[j] = NEG;
                    best_i[j] = N;
                }
                for (int base = warp * 32; base < N; base += SW_NT) {
                    const int n = base + lane;
                    if (n >= N) continue;
                    TNode<true, Slots> t(a, S, u, n);
                    t.load<GC, NA, TT, AV, false, true>(p, S);
                    float gc_dyn[BMAX], gc_has_dev = 0.0f, score[BMAX];
                    unsigned feas = 0u;  // bit j: node n is feasible for slot j
#pragma unroll
                    for (int j = 0; j < BMAX; ++j)
                        if (sched >> j & 1u) feas |= (feas_bits[(size_t)j * Nw + (base >> 5)] >> lane & 1u) << j;
                    if constexpr (GC) gc_nodes(a, S, t, n, feas, gc_dyn, gc_has_dev);
                    if (!feas) continue;
                    node_score<GC, NA, TT, AV, LOC, IP, CFG>(a, S, cs, t, p, n, gc_dyn, gc_has_dev, any_soft, sh.red,
                                                             feas, score);
#pragma unroll
                    for (int j = 0; j < BMAX; ++j)
                        if (feas >> j & 1u) better(best_s[j], best_i[j], score[j], n);
                }
#pragma unroll
                for (int j = 0; j < BMAX; ++j) {
                    if (!(sched >> j & 1u)) continue;
                    warp_argmax(best_s[j], best_i[j]);
                    if (lane == 0) {
                        sh.sbuf[j][warp] = best_s[j];
                        sh.ibuf[j][warp] = best_i[j];
                    }
                }
                __syncthreads();
                for (int j = warp; j < BMAX; j += SW_NWARP) {
                    if (!(sched >> j & 1u)) continue;
                    float s = lane < SW_NWARP ? sh.sbuf[j][lane] : NEG;
                    int bi = lane < SW_NWARP ? sh.ibuf[j][lane] : N;
                    warp_argmax(s, bi);
                    if (lane == 0) sh.best[j] = bi;
                }
                __syncthreads();
            }
        }

        // --- per slot: the choice (the pin of a forced pod), then the bind
        bool bound = false;
#pragma unroll
        for (int j = 0; j < BMAX; ++j) {
            if (j >= nb) continue;
            int choice = -1;
            if (frc >> j & 1u) {
                const int pin = a.pin[u];
                choice = pin >= 0 ? pin : -1;
            } else if (sched >> j & 1u) {
                choice = sh.red[j * MAX_RED + 4] > 0.0f ? sh.best[j] : -1;
            }
            if (tid == j) a.chosen[S.pod0(j) + i] = choice;
            if (choice >= 0) {
                bind_pod<GPU, PORTS, IP, LOC>(a, S, j, i, u, choice, tid, SW_NT);
                bound = true;
            }
        }
        if (bound) __syncthreads();
    }
}

namespace {

int check_args(const FastScanArgs& a) {
    if (a.S < 1 || a.R > MAX_R || a.Cs > MAX_CS || a.Gd > MAX_GD || a.Dv > MAX_DV || a.K < 1 || a.K > MAX_K ||
        a.gc_row >= a.R)
        return (int)cudaErrorInvalidValue;
    const int v = (a.has_gpu ? 1 : 0) | (a.gc_row >= 0 ? 2 : 0) | (a.has_na ? 4 : 0) | (a.has_tt ? 8 : 0) |
                  (a.has_avoid ? 16 : 0) | (a.has_ports ? 32 : 0) | (a.has_interpod ? 64 : 0) |
                  (a.has_local ? 128 : 0) | (a.has_cfg ? 256 : 0) | (a.has_sample ? 512 : 0) |
                  (a.has_explain ? 1024 : 0) | (a.has_count ? 2048 : 0);
    if (v != FS_VARIANT) return (int)cudaErrorInvalidValue;  // this library holds one variant
    if (a.init != nullptr && !a.has_cfg) return (int)cudaErrorInvalidValue;  // only a CFG variant takes a state
    return 0;
}

}  // namespace

#define FS_FLAGS                                                                                             \
    (FS_VARIANT & 1) != 0, (FS_VARIANT & 2) != 0, (FS_VARIANT & 4) != 0, (FS_VARIANT & 8) != 0,              \
        (FS_VARIANT & 16) != 0, (FS_VARIANT & 32) != 0, (FS_VARIANT & 64) != 0, (FS_VARIANT & 128) != 0
#define FS_CFG ((FS_VARIANT & 256) != 0)
#define FS_SAMPLE ((FS_VARIANT & 512) != 0)
#define FS_EXPLAIN ((FS_VARIANT & 1024) != 0)
#define FS_COUNT ((FS_VARIANT & 2048) != 0)

// One scan as a cluster of CL CTAs of NT threads, `smem` bytes of dynamic
// shared memory (the slices, with a.resident; else 0 and the slices in
// global memory, each CTA's copy of the small state in a.rep). Returns
// SCAN_UNSCHEDULABLE when no such cluster fits on the card.
template <int RES>
int launch_scan(const FastScanArgs& a, int smem, cudaStream_t stream) {
    auto kernel = fast_scan_kernel<FS_FLAGS, FS_CFG, FS_SAMPLE, FS_EXPLAIN, RES>;
    cudaError_t err;
    if (smem > 48 * 1024 &&
        (err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem)) != cudaSuccess)
        return (int)err;
    if (CL > 8 && (err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1)) != cudaSuccess)
        return (int)err;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(CL, 1, 1);
    cfg.blockDim = dim3(NT, 1, 1);
    cfg.dynamicSmemBytes = (size_t)smem;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = CL;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int clusters = 0;
    if ((err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg)) != cudaSuccess) return (int)err;
    if (clusters < 1) return SCAN_UNSCHEDULABLE;
    if ((err = cudaLaunchKernelEx(&cfg, kernel, a)) != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}

// A COUNT variant holds no one scan: the one scan counts the steps that
// find no node in every variant.
extern "C" int fast_scan_launch(const FastScanArgs* args, int cluster, int threads, int smem, void* stream) {
#if FS_COUNT
    (void)args, (void)cluster, (void)threads, (void)smem, (void)stream;
    return (int)cudaErrorInvalidValue;
#else
    const FastScanArgs& a = *args;
    if (int err = check_args(a)) return err;
    if (a.S != 1 || cluster != CL || threads != NT || a.Nc != (a.N + CL - 1) / CL || a.Wrep < 0 ||
        (a.resident ? smem <= 0 : smem != 0 || a.rep == nullptr) || a.fail_counts == nullptr ||
        a.insufficient == nullptr || a.count_clock == nullptr)
        return (int)cudaErrorInvalidValue;
    cudaGetLastError();  // clear a stale error so the check reports this launch
    return a.resident ? launch_scan<1>(a, smem, (cudaStream_t)stream) : launch_scan<0>(a, 0, (cudaStream_t)stream);
#endif
}

// The scenario grid, shaped by ops/fast_scan.sweep_grid: `blocks` blocks of
// `threads` threads (SW_NT), a.B scenarios each, `smem` bytes of dynamic
// shared memory (the masks of a.B scenarios, or 0 when they lie in global
// memory). A SAMPLE variant holds no grid: no sweep samples. The COUNT and
// EXPLAIN variants run one scenario a block and write the count rows.
extern "C" int fast_scan_sweep_launch(const FastScanArgs* args, int blocks, int threads, int smem, void* stream) {
#if FS_SAMPLE
    (void)args, (void)blocks, (void)threads, (void)smem, (void)stream;
    return (int)cudaErrorInvalidValue;
#else
    const FastScanArgs& a = *args;
    if (int err = check_args(a)) return err;
    const long long want_smem = a.bits_in_smem ? (long long)a.B * a.Nw * 4 * 2 : 0;
    if (a.B < 1 || a.B > BMAX || threads != SW_NT || blocks != (a.S + a.B - 1) / a.B || a.Nw != (a.N + 31) / 32 ||
        smem != want_smem || (!a.bits_in_smem && a.feas_bits == nullptr) || a.nv_bits == nullptr ||
        ((FS_COUNT || FS_EXPLAIN) && (a.B != 1 || a.fail_counts == nullptr || a.insufficient == nullptr)))
        return (int)cudaErrorInvalidValue;
    cudaGetLastError();
    auto kernel = fast_scan_sweep_kernel<FS_FLAGS, FS_CFG, FS_COUNT, FS_EXPLAIN>;
    if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (err != cudaSuccess) return (int)err;
    }
    kernel<<<blocks, SW_NT, smem, (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
#endif
}
