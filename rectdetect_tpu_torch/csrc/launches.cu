// The library's own count of kernel launches.  Every rd_* entry point adds
// one for each kernel it launches, by <<<>>>, cudaLaunchKernelEx or
// cudaLaunchCooperativeKernel, and rd_launch_count reads the total, so a
// caller can check the launches of a run exactly, without a profiler
// (chip_smoke.py does).

#include <atomic>

#include "common.cuh"

namespace {

std::atomic<long long> g_launches{0};

}  // namespace

namespace rd {

void count_launch() { g_launches.fetch_add(1, std::memory_order_relaxed); }

}  // namespace rd

extern "C" long long rd_launch_count() {
  return g_launches.load(std::memory_order_relaxed);
}
