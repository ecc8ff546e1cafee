// The device stopwatch of the program's sections (profiling.section), for
// Hopper (sm_90a), plain C interface.
//
// Replaces no TPU kernel: the JAX package reads its layers' device time from
// XLA's own trace. Here a training step is one CUDA graph replay, whose
// kernels the profiler shows by name alone, so the step times itself: each
// mark is one launch of one thread on the current stream that reads the
// card's global timer and charges the time since the previous mark to one
// section slot. Marks on one stream run in order after the work before them,
// so the slots of a step add up to the device time between its first and
// last mark. A graph captured with marks replays them with the step.
//
// What bounds it: the launch, about a microsecond a mark inside a graph; it
// moves 24 bytes.
//
// The buffer is 1 + 2 * n_slots unsigned 64-bit words on the device:
// [last mark's time (ns), time by slot (ns) ..., closed sections by slot ...].
// A mark after the buffer was zeroed (last == 0) charges no time.

#include <cuda_runtime.h>

namespace {

__global__ void span_mark_kernel(unsigned long long* buf, int n_slots, int slot,
                                 int closes) {
  unsigned long long now;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
  const unsigned long long last = buf[0];
  if (last != 0ull && now > last) buf[1 + slot] += now - last;
  if (closes) buf[1 + n_slots + slot] += 1ull;
  buf[0] = now;
}

}  // namespace

extern "C" {

// buf: as above, on the current device. Charges the time since the last
// mark to `slot`; `closes` also counts one closed section there. Launches
// on `stream` and returns the launch error, or 0.
int span_mark(void* buf, int n_slots, int slot, int closes, void* stream) {
  if (buf == nullptr || slot < 0 || slot >= n_slots) return (int)cudaErrorInvalidValue;
  span_mark_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<unsigned long long*>(buf), n_slots, slot, closes);
  return (int)cudaGetLastError();
}

}  // extern "C"
