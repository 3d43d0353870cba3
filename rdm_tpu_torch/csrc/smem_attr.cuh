// The dynamic shared-memory limit of a kernel, set once per card.
//
// cudaFuncSetAttribute acts on the context of the card current at the call,
// so a limit set once per process holds only on the first card a process
// launched on.  Each launcher keeps one SmemAttr (a function-local static of
// its instantiation, so one per kernel): a small table keyed by
// cudaGetDevice, filled under a lock the first time each card launches, and
// holding that call's result.  Once a card's entry is filled, a launch reads
// it without the lock.
#pragma once

#include <atomic>
#include <mutex>

#include <cuda_runtime.h>

namespace {

class SmemAttr {
 public:
  cudaError_t apply(const void* kern, int bytes) {
    int dev = 0;
    const cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
    if (!set_[dev].load(std::memory_order_acquire)) {
      std::lock_guard<std::mutex> lock(mu_);
      if (!set_[dev].load(std::memory_order_relaxed)) {
        result_[dev] =
            cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
        set_[dev].store(true, std::memory_order_release);
      }
    }
    return result_[dev];
  }

 private:
  static constexpr int kMaxDevices = 64;
  std::mutex mu_;
  std::atomic<bool> set_[kMaxDevices] = {};
  cudaError_t result_[kMaxDevices] = {};
};

}  // namespace
