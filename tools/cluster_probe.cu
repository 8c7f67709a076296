// Latency of the one-scan kernel's per-step cluster primitives on the
// card, for PERF.md's per-step floor: one cluster of CL CTAs of NT threads
// (the kernel's shape) runs a loop whose every iteration is one of them, so
// the time per iteration is that primitive's latency. It includes the
// kernel's source, so modes 2 and 3 run the very reductions a step runs.
// Built and timed by tools/cluster_probe.py.
#include "../opensim_tpu_torch/ops/csrc/fast_scan.cu"

// mode 0: cluster.sync(); 1: __syncthreads(); 2: cluster_reduce of the
// base variant's five pass-2 values; 3: cluster_argmax; 4: one
// distributed-shared-memory load from the next CTA, each one's address
// depending on the last.
__global__ void __launch_bounds__(NT, 1) cluster_probe_kernel(float* out, int iters, int mode) {
    __shared__ ScanShared sh;
    const cg::cluster_group cluster = cg::this_cluster();
    const int tid = threadIdx.x, rank = (int)cluster.block_rank();
    int par = 0;
    float acc = 0.0f;
    if (tid < MAX_RED) sh.part[0][tid] = sh.part[1][tid] = 0.0f;
    cluster.sync();
    for (int i = 0; i < iters; ++i) {
        if (mode == 0) {
            cluster.sync();
        } else if (mode == 1) {
            __syncthreads();
        } else if (mode == 2) {
            float v[5];
#pragma unroll
            for (int k = 0; k < 5; ++k) v[k] = acc + (float)((tid + k + i) & 7);
            cluster_reduce(v, [](int k) { return k == 1 || k == 3 || k == 4; }, sh, par, cluster);
            acc += v[0] * 1e-9f;
        } else if (mode == 3) {
            const int best = cluster_argmax(acc + (float)((tid * 7 + i) & 15), rank * NT + tid, CL * NT, sh, par, cluster);
            acc += (float)best * 1e-9f;
        } else {
            acc += *cluster.map_shared_rank(&sh.part[((int)acc) & 1][0], (rank + 1) % CL);  // 0: acc stays 0
        }
    }
    cluster.sync();
    if (tid == 0) out[rank] = acc;
}

extern "C" int cluster_probe_launch(float* out, int iters, int mode, void* stream) {
    auto kernel = cluster_probe_kernel;
    cudaError_t err;
    if (CL > 8 && (err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1)) != cudaSuccess)
        return (int)err;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(CL, 1, 1);
    cfg.blockDim = dim3(NT, 1, 1);
    cfg.stream = (cudaStream_t)stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = CL;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    cudaGetLastError();
    if ((err = cudaLaunchKernelEx(&cfg, kernel, out, iters, mode)) != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}
