// Receive pools of the fused kernels' peer route: symmetric buffers across
// the cards of one host.  Replaces no TPU kernel: on the TPU a remote DMA
// addresses another chip's VMEM / HBM by its semaphore and buffer refs
// (src/repro/backend/lowering.py, make_async_remote_copy); on Hopper a
// kernel stores into another card's memory through a pointer this process
// maps over NVLink.  Plain-C entry points (bound with ctypes by
// kernels/build.py; kernels/peer.py drives them):
//
//   tl_peer_alloc    a region with cudaMalloc (outside PyTorch's caching
//                    allocator: an IPC handle covers a whole cudaMalloc
//                    allocation, not a sub-allocation of a cached block),
//                    zeroed once, synchronised;
//   tl_peer_handle   its cudaIpcMemHandle (64 bytes), which the processes
//                    exchange once per pool over their process group;
//   tl_peer_open     a peer's handle mapped into this process
//                    (cudaIpcMemLazyEnablePeerAccess);
//   tl_peer_close / tl_peer_free   the mapping closed / the region freed;
//   tl_peer_copy     a region's bytes copied on a stream, after the work
//                    enqueued there (a pool's slots copied out for the
//                    training backward before the next launch reuses them).
//
// Every call reports its CUDA error code; the wrapper raises on anything
// but 0 (a failed open is never worked around).
#include <cuda_runtime.h>
#include <string.h>

extern "C" int tl_peer_alloc(long long bytes, void* out_ptr) {
  void* p = nullptr;
  cudaError_t e = cudaMalloc(&p, static_cast<size_t>(bytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  if ((e = cudaMemset(p, 0, static_cast<size_t>(bytes))) != cudaSuccess) return static_cast<int>(e);
  if ((e = cudaDeviceSynchronize()) != cudaSuccess) return static_cast<int>(e);
  *static_cast<unsigned long long*>(out_ptr) = reinterpret_cast<unsigned long long>(p);
  return 0;
}

extern "C" int tl_peer_handle(const void* ptr, void* out_handle) {
  cudaIpcMemHandle_t h;
  cudaError_t e = cudaIpcGetMemHandle(&h, const_cast<void*>(ptr));
  if (e != cudaSuccess) return static_cast<int>(e);
  memcpy(out_handle, &h, sizeof(h));
  return 0;
}

extern "C" int tl_peer_open(const void* handle, void* out_ptr) {
  cudaIpcMemHandle_t h;
  memcpy(&h, handle, sizeof(h));
  void* p = nullptr;
  cudaError_t e = cudaIpcOpenMemHandle(&p, h, cudaIpcMemLazyEnablePeerAccess);
  if (e != cudaSuccess) return static_cast<int>(e);
  *static_cast<unsigned long long*>(out_ptr) = reinterpret_cast<unsigned long long>(p);
  return 0;
}

extern "C" int tl_peer_close(const void* ptr) { return static_cast<int>(cudaIpcCloseMemHandle(const_cast<void*>(ptr))); }

extern "C" int tl_peer_free(const void* ptr) { return static_cast<int>(cudaFree(const_cast<void*>(ptr))); }

extern "C" int tl_peer_copy(void* dst, const void* src, long long bytes, void* stream) {
  return static_cast<int>(cudaMemcpyAsync(dst, src, static_cast<size_t>(bytes), cudaMemcpyDeviceToDevice,
                                          static_cast<cudaStream_t>(stream)));
}
