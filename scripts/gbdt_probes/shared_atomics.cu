// Shared-memory atomic throughput on the card, in lane-ops per SM per cycle:
// a 64-bit atomicAdd (a compare-and-swap loop on sm_90a), a 32-bit one with
// and without its result, a 64-bit add as two 32-bit halves with a carry,
// and a plain load-add-store; every lane of a warp on its own bank.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -o shared_atomics shared_atomics.cu
//   ./shared_atomics
#include <cstdio>
#include <cuda_runtime.h>
constexpr int kWords = 4096;
template <int MODE>
__global__ void __launch_bounds__(512, 2) probe(unsigned long long* out, int iters) {
  __shared__ unsigned long long s64[kWords];
  unsigned* s32 = reinterpret_cast<unsigned*>(s64);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = threadIdx.x; i < kWords; i += blockDim.x) s64[i] = 0;
  __syncthreads();
  unsigned acc = 0;
  long long t0 = clock64();
  for (int i = 0; i < iters; ++i) {
    const int row = (warp * 37 + i * 13) % (kWords / 64);
    const int a = row * 32 + lane;             // distinct, conflict-free in a warp
    const unsigned v = (unsigned)(i * 2654435761u + threadIdx.x);
    if (MODE == 0) atomicAdd(&s64[a], (unsigned long long)v);           // 64-bit (CAS loop)
    if (MODE == 1) atomicAdd(&s32[a], v);                               // 32-bit, no return
    if (MODE == 2) acc += atomicAdd(&s32[a], v);                         // 32-bit, return used
    if (MODE == 3) {                                                     // 64 bits as lo/hi with carry
      const unsigned old = atomicAdd(&s32[2 * a], v);
      const unsigned c = (old + v) < old;
      const unsigned hi = (v >> 30) + c;
      if (hi) atomicAdd(&s32[2 * a + 1], hi);
    }
    if (MODE == 4) { s32[a] += v; }                                      // plain RMW
  }
  long long t1 = clock64();
  __syncthreads();
  if (threadIdx.x == 0) atomicAdd(out, (unsigned long long)(t1 - t0));
  if (acc == 12345u) out[1] = acc;
  if (MODE == 4 && s32[threadIdx.x] == 1u) out[1] = 1;
}
template <int MODE> void run(const char* name, int sms) {
  unsigned long long* d; cudaMalloc(&d, 16); cudaMemset(d, 0, 16);
  const int iters = 4096, blocks = sms * 2;
  probe<MODE><<<blocks, 512>>>(d, 64);
  cudaDeviceSynchronize(); cudaMemset(d, 0, 16);
  cudaEvent_t a, b; cudaEventCreate(&a); cudaEventCreate(&b);
  cudaEventRecord(a);
  probe<MODE><<<blocks, 512>>>(d, iters);
  cudaEventRecord(b); cudaEventSynchronize(b);
  float ms; cudaEventElapsedTime(&ms, a, b);
  unsigned long long cyc; cudaMemcpy(&cyc, d, 8, cudaMemcpyDeviceToHost);
  const double per_block = (double)cyc / blocks;
  const double lanes = 512.0 * iters;                 // lane-ops a block
  printf("%-28s %.3f ms, %.2f lane-ops per SM per cycle (2 blocks an SM)\n", name, ms,
         2 * lanes / per_block);
  cudaFree(d);
}
int main() {
  int sms; cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  run<0>("64-bit atomicAdd", sms);
  run<1>("32-bit atomicAdd", sms);
  run<2>("32-bit atomicAdd, return", sms);
  run<3>("32-bit lo/hi with carry", sms);
  run<4>("plain load-add-store", sms);
  return 0;
}
