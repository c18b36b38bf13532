// Symmetric peer buffers for the one-launch collectives of rows 10 and 11
// (rs_bucket.cu, ag_bucket.cu), for paddle_tpu_torch/distributed/peer.py.
//
// A channel is one cudaMalloc per rank, made here and not through
// PyTorch's caching allocator: cudaIpcGetMemHandle does not take memory
// of torch's expandable segments, and a pointer inside a cached segment
// would need base and offset bookkeeping. Its first kPadBytes are the
// signal pad (peer_barrier.cuh), zeroed here; the rest is the staging
// region. Every rank exports the handle of its channel, the ranks swap the
// 64-byte handles (peer.py, over the group), and each opens its peers'
// with cudaIpcMemLazyEnablePeerAccess: over NVLink with a card per rank,
// or on the one device when ranks share a card (IPC between processes on
// one device is allowed). Teardown: every rank's kernels done, a group
// barrier, cudaIpcCloseMemHandle of the peers' mappings, a barrier, then
// cudaFree of its own, so no process frees memory a peer still maps.
//
// Also the error record the kernels write before they trap on a barrier
// that timed out: pinned host memory mapped into the device, so the host
// reads it without a CUDA call (none succeeds after a trap).
//
// No kernel here. Built by paddle_tpu_torch/cuda_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// into a library with a plain C interface, loaded with ctypes.

#include <cuda_runtime.h>
#include <cstring>

#include "peer_barrier.cuh"

namespace {
int g_open = 0;                          // peer mappings open now
peer::ErrorRecord* g_err_host = nullptr;
void* g_err_dev = nullptr;
}  // namespace

extern "C" long long peer_pad_bytes() { return peer::kPadBytes; }

// a channel of kPadBytes + staging_bytes on `device`, its pad zeroed
extern "C" int peer_alloc(int device, long long staging_bytes, void** ptr) {
  cudaError_t rc = cudaSetDevice(device);
  if (rc == cudaSuccess)
    rc = cudaMalloc(ptr, peer::kPadBytes + staging_bytes);
  if (rc == cudaSuccess) rc = cudaMemset(*ptr, 0, peer::kPadBytes);
  if (rc == cudaSuccess) rc = cudaDeviceSynchronize();
  return static_cast<int>(rc);
}

extern "C" int peer_free(int device, void* ptr) {
  cudaError_t rc = cudaSetDevice(device);
  if (rc == cudaSuccess) rc = cudaFree(ptr);
  return static_cast<int>(rc);
}

// the 64-byte IPC handle of a channel made by peer_alloc
extern "C" int peer_handle(int device, void* ptr, void* handle) {
  cudaError_t rc = cudaSetDevice(device);
  cudaIpcMemHandle_t h;
  if (rc == cudaSuccess) rc = cudaIpcGetMemHandle(&h, ptr);
  if (rc == cudaSuccess) std::memcpy(handle, &h, sizeof(h));
  return static_cast<int>(rc);
}

extern "C" int peer_handle_bytes() {
  return static_cast<int>(sizeof(cudaIpcMemHandle_t));
}

// map a peer's channel into this process on `device`
extern "C" int peer_open(int device, const void* handle, void** ptr) {
  cudaError_t rc = cudaSetDevice(device);
  cudaIpcMemHandle_t h;
  std::memcpy(&h, handle, sizeof(h));
  if (rc == cudaSuccess)
    rc = cudaIpcOpenMemHandle(ptr, h, cudaIpcMemLazyEnablePeerAccess);
  if (rc == cudaSuccess) ++g_open;
  return static_cast<int>(rc);
}

extern "C" int peer_close(int device, void* ptr) {
  cudaError_t rc = cudaSetDevice(device);
  if (rc == cudaSuccess) rc = cudaIpcCloseMemHandle(ptr);
  if (rc == cudaSuccess) --g_open;
  return static_cast<int>(rc);
}

extern "C" int peer_open_count() { return g_open; }

extern "C" int peer_can_access(int device, int peer_device, int* ok) {
  return static_cast<int>(cudaDeviceCanAccessPeer(ok, device, peer_device));
}

// the process's error record: host pointer (read by the wrapper) and
// device pointer (given to the kernels); made and zeroed at first call
extern "C" int peer_error_record(void** host, void** dev) {
  if (g_err_host == nullptr) {
    void* h = nullptr;
    cudaError_t rc = cudaHostAlloc(&h, sizeof(peer::ErrorRecord),
                                   cudaHostAllocMapped);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    std::memset(h, 0, sizeof(peer::ErrorRecord));
    rc = cudaHostGetDevicePointer(&g_err_dev, h, 0);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    g_err_host = static_cast<peer::ErrorRecord*>(h);
  }
  *host = g_err_host;
  *dev = g_err_dev;
  return 0;
}

extern "C" const char* peer_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
