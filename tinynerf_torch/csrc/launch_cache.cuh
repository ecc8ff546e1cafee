// Launch set-up that the C entries would otherwise repeat on every call,
// kept once per device: a kernel's dynamic shared-memory limit, the card's
// multiprocessor count and a kernel's resident blocks per multiprocessor.
// After the first call at a shape an entry costs a lookup under a mutex,
// and none of it is a stream operation, so the entries stay the same inside
// a CUDA graph's capture as outside it.
#pragma once

#include <cuda_runtime.h>

#include <mutex>
#include <vector>

namespace launch_cache {

struct Entry {
  int dev;
  const void* fn;  // nullptr for the multiprocessor count
  int threads;     // 0 for the shared-memory limit, -1 for the count
  size_t smem;
  int value;       // the limit set, the count, or the blocks
};

inline std::mutex& table_lock() {
  static std::mutex m;
  return m;
}

inline std::vector<Entry>& table() {
  static std::vector<Entry> t;
  return t;
}

// The current device's entry for (fn, threads, smem), or nullptr.
inline const Entry* find(int dev, const void* fn, int threads, size_t smem) {
  for (const Entry& e : table())
    if (e.dev == dev && e.fn == fn && e.threads == threads && e.smem == smem) return &e;
  return nullptr;
}

// Allow `kernel` at least `smem` bytes of dynamic shared memory on the
// current device: cudaFuncSetAttribute only where `smem` exceeds the largest
// limit set so far on that device, so the limit only grows.
template <class Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t smem) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const void* fn = (const void*)kernel;
  std::lock_guard<std::mutex> guard(table_lock());
  for (Entry& e : table()) {
    if (e.dev != dev || e.fn != fn || e.threads != 0) continue;
    if (smem <= (size_t)e.value) return cudaSuccess;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err == cudaSuccess) e.value = (int)smem;
    return err;
  }
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess) table().push_back(Entry{dev, fn, 0, 0, (int)smem});
  return err;
}

// The current device's multiprocessor count, queried once a device.
inline cudaError_t sm_count(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> guard(table_lock());
  if (const Entry* e = find(dev, nullptr, -1, 0)) {
    *sms = e->value;
    return cudaSuccess;
  }
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) table().push_back(Entry{dev, nullptr, -1, 0, *sms});
  return err;
}

// Blocks of `kernel` at `threads` threads and `smem` bytes of dynamic shared
// memory that one multiprocessor of the current device holds at once, with
// the shared-memory limit set (allow_smem): queried once a device and shape.
template <class Kernel>
inline cudaError_t blocks_per_sm(Kernel kernel, int threads, size_t smem, int* per_sm) {
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  int dev = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  const void* fn = (const void*)kernel;
  std::lock_guard<std::mutex> guard(table_lock());
  if (const Entry* e = find(dev, fn, threads, smem)) {
    *per_sm = e->value;
    return cudaSuccess;
  }
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, threads, smem);
  if (err == cudaSuccess) table().push_back(Entry{dev, fn, threads, smem, *per_sm});
  return err;
}

}  // namespace launch_cache
