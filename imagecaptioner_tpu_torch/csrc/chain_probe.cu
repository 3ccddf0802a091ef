// A timing probe of the grid barrier that the cooperative step chains
// (greedy_decode.cu, decoder_scan.cu, decoder_scan_bwd.cu) cross between
// phases: n empty barriers in one cooperative launch.  chip_smoke.py times
// it at each chain's grid for the chain's floor (barriers a run crosses x
// the median barrier); no path of the package launches it.

#include "chain.cuh"

namespace {

// n empty grid barriers in one launch; block 0 records clock64() after each
// (clk[0..n]) and %globaltimer before the first and after the last (gt[0..1])
// so that the host can turn cycles into nanoseconds.
__global__ void __launch_bounds__(THREADS, 1) barrier_probe_kernel(unsigned* bar, int n,
                                                                  long long* clk,
                                                                  unsigned long long* gt) {
  unsigned long long t0 = 0, t1 = 0;
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t0));
    clk[0] = clock64();
  }
  for (int i = 0; i < n; ++i) {
    grid_barrier(bar, gridDim.x);
    if (blockIdx.x == 0 && threadIdx.x == 0) clk[i + 1] = clock64();
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t1));
    gt[0] = t0;
    gt[1] = t1;
  }
}

}  // namespace

// n empty grid barriers on nblk blocks (barrier_probe_kernel):
// clk (n + 1 int64) and gt (2 uint64) on the device, bar two zeroed words.
extern "C" int ic_chain_barrier_probe(int nblk, int n, void* clk, void* gt, void* bar,
                                      void* stream) {
  unsigned* b = static_cast<unsigned*>(bar);
  long long* c = static_cast<long long*>(clk);
  unsigned long long* g = static_cast<unsigned long long*>(gt);
  void* params[] = {&b, &n, &c, &g};
  return (int)cudaLaunchCooperativeKernel((void*)barrier_probe_kernel, dim3(nblk),
                                          dim3(THREADS), params, 0,
                                          static_cast<cudaStream_t>(stream));
}

extern "C" const char* ic_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
