// How fast the card reads 800,000 x 28 int32 bins: plainly (16-byte loads,
// grid-stride), and the way the level kernel's accumulate launch reads a
// row chunk a block (8 lanes a row, 16 bytes a lane, and the row's grad).
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -o row_stream row_stream.cu
//   ./row_stream
#include <cstdio>
#include <cuda_runtime.h>
template <int U>
__global__ void __launch_bounds__(512, 2) rows(const int* __restrict__ bins, const float* __restrict__ g,
                                               int R, int F, int chunk, int* out) {
  const int lanes = 8, slot = threadIdx.x / lanes, j0 = (threadIdx.x % lanes) * 4;
  const int lo = blockIdx.x * chunk, hi = min(R, lo + chunk);
  int acc = 0; float ga = 0.f;
  if (j0 < F)
    for (int base = lo + slot; base < hi; base += 64 * U) {
      int4 v[U]; float gv[U];
#pragma unroll
      for (int m = 0; m < U; ++m) {
        const int r = base + m * 64;
        v[m] = r < hi ? __ldg(reinterpret_cast<const int4*>(bins + (size_t)r * F + j0)) : make_int4(0,0,0,0);
        gv[m] = r < hi ? __ldg(g + r) : 0.f;
      }
#pragma unroll
      for (int m = 0; m < U; ++m) { acc += v[m].x ^ v[m].y ^ v[m].z ^ v[m].w; ga += gv[m]; }
    }
  if (acc == 0x12345 || ga == 1.2345f) out[0] = acc;
}
__global__ void linear(const int4* __restrict__ p, long long n, int* out) {
  int acc = 0;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n; i += (long long)gridDim.x * blockDim.x) {
    const int4 v = __ldg(p + i); acc += v.x ^ v.y ^ v.z ^ v.w;
  }
  if (acc == 0x12345) out[0] = acc;
}
int main() {
  const int R = 800000, F = 28; int sms; cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  int* bins; float* g; int* out;
  cudaMalloc(&bins, (size_t)R * F * 4); cudaMalloc(&g, R * 4); cudaMalloc(&out, 4);
  cudaMemset(bins, 1, (size_t)R * F * 4); cudaMemset(g, 0, R * 4);
  cudaEvent_t a, b; cudaEventCreate(&a); cudaEventCreate(&b); float ms;
  auto time = [&](const char* name, auto launch) {
    launch(); cudaDeviceSynchronize(); cudaEventRecord(a);
    for (int i = 0; i < 20; ++i) launch();
    cudaEventRecord(b); cudaEventSynchronize(b); cudaEventElapsedTime(&ms, a, b);
    printf("%-32s %.1f us (%.2f TB/s of bins)\n", name, ms / 20 * 1000, (double)R * F * 4 / (ms / 20 * 1e-3) / 1e12);
  };
  const int blocks = 2 * sms, chunk = (R + blocks - 1) / blocks;
  time("linear int4, 4 blocks an SM", [&] { linear<<<4 * sms, 512>>>(reinterpret_cast<int4*>(bins), (long long)R * F / 4, out); });
  time("rows, unroll 1", [&] { rows<1><<<blocks, 512>>>(bins, g, R, F, chunk, out); });
  time("rows, unroll 4", [&] { rows<4><<<blocks, 512>>>(bins, g, R, F, chunk, out); });
  time("rows, unroll 8", [&] { rows<8><<<blocks, 512>>>(bins, g, R, F, chunk, out); });
  const int b4 = 8 * sms, c4 = (R + b4 - 1) / b4;
  time("rows, unroll 4, 8 blocks an SM", [&] { rows<4><<<b4, 512>>>(bins, g, R, F, c4, out); });
  return 0;
}
