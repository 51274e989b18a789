// Device buffers that the ranks of one card share by CUDA IPC
// (parallel/peer_staged.py): each rank allocates its own and exports a
// handle, its peers map it, so a collective among ranks on one card moves
// its bytes card to card instead of through host memory and gloo's TCP.
// No kernel: the collectives' copies and sums are PyTorch's, on the mapped
// buffers.  Replaces no TPU kernel (the reference's collectives are XLA's).
#include <cstdint>
#include <cstring>

#include <cuda_runtime.h>

// nbytes of device memory at *ptr, its IPC handle (64 bytes) at handle
extern "C" int peer_buffer_alloc(int64_t nbytes, void* ptr, void* handle) {
    void* p = nullptr;
    cudaError_t err = cudaMalloc(&p, static_cast<size_t>(nbytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    cudaIpcMemHandle_t h;
    err = cudaIpcGetMemHandle(&h, p);
    if (err != cudaSuccess) {
        cudaFree(p);
        return static_cast<int>(err);
    }
    std::memcpy(ptr, &p, sizeof p);
    std::memcpy(handle, &h, sizeof h);
    return 0;
}

// another process's buffer of the same card, by its handle, at *ptr
extern "C" int peer_buffer_open(void* handle, void* ptr) {
    cudaIpcMemHandle_t h;
    std::memcpy(&h, handle, sizeof h);
    void* p = nullptr;
    cudaError_t err = cudaIpcOpenMemHandle(&p, h,
                                           cudaIpcMemLazyEnablePeerAccess);
    if (err != cudaSuccess) return static_cast<int>(err);
    std::memcpy(ptr, &p, sizeof p);
    return 0;
}

extern "C" int peer_buffer_close(void* ptr) {
    return static_cast<int>(cudaIpcCloseMemHandle(ptr));
}

extern "C" int peer_buffer_free(void* ptr) {
    return static_cast<int>(cudaFree(ptr));
}
