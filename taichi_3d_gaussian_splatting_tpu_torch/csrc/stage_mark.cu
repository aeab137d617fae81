// A timestamp of the device's global nanosecond clock, written by one
// thread into one slot: the start or end of a program stage inside a CUDA
// graph (ops/stages.py).
//
// A graph replay runs no Python, so a stage's profiler range does not show
// on the device. An event-record node between two kernel nodes stalls the
// stream about 4 us on the H100; a one-thread kernel node costs about as
// much as any dependent launch in a graph. stage_mark_kernel reads
// %globaltimer when every earlier node of the stream has finished (stream
// order) and stores it; the host reads the slots after the replay.
#include <cuda_runtime.h>

__global__ void stage_mark_kernel(unsigned long long* slot) {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  *slot = t;
}

extern "C" int stage_mark(void* slot, void* stream) {
  stage_mark_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(
      (unsigned long long*)slot);
  return (int)cudaGetLastError();
}
