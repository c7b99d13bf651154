// The current card's SM count, read once a device: the launch shapes of
// scan.cu, mtf.cu and grc_rans.cu are picked on the host at every call.
#pragma once

#include <cuda_runtime.h>

#include <atomic>

namespace {

// -1 if the card does not answer
inline int sm_count() {
  static std::atomic<int> cached[64];  // 0: not read yet
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  if (dev < 64 && (sms = cached[dev].load(std::memory_order_relaxed)) > 0)
    return sms;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
      cudaSuccess)
    return -1;
  if (dev < 64) cached[dev].store(sms, std::memory_order_relaxed);
  return sms;
}

}  // namespace
