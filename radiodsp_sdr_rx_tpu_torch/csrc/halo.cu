// halo.cu: the ring halo exchange of a time-sharded stream, every shard's
// block copied to its right neighbour in one launch.
//
// Replaces the TPU kernel _halo_kernel (radiodsp_sdr_rx_tpu/parallel/
// pallas_halo.py:36), reached through ring_shift_right_pallas (:63) and
// shift_from_left_pallas (:94): each device sends its overlap-save tail to
// its RIGHT ring neighbour with a remote DMA and receives from its LEFT; a
// neighbourhood barrier (:48-53) keeps a fast sender from writing into a
// buffer its neighbour has not entered yet; shift_from_left then gives
// device 0 the stream-start carry instead (:116). Complex tails cross as two
// f32 planes (:106-111).
//
// Here the shards of one mesh line live in one process (parallel/mesh.py).
// The wrapper (parallel/halo.py) allocates every receive buffer before the
// launch and passes a table of (source, destination) pointer pairs; block
// (p, j) copies floats [1024 j, 1024 j + 1024) of pair p. The ring (pair s:
// block s-1 -> buffer s, pair 0 the stream-start carry for shift_from_left)
// is the wrapper's pairing, so on one card the whole exchange is ONE launch,
// and the barrier reduces to stream order: the buffers exist and the
// sources are written before the kernel starts. A complex64 block is its
// interleaved float storage, 2k floats, with no split into planes. The
// table rides in the launch's parameter space (__grid_constant__, up to
// kMaxPairs pairs), so no copy of it precedes the launch. With shards on
// several cards the wrapper launches once per source card, with the
// destinations reachable by peer access (enable_peer_access).
//
// What bounds it on an H100: bytes and, below a few MB, the launch itself.
// A ring of S shards of k floats reads and writes S*k*4 bytes each: 4 shards
// of a (128, 128) complex64 bank tail are 1 MiB in and 1 MiB out (0.6 us at
// 3.35 TB/s); a 1-D stream's tail is 1 KiB a shard. Each thread moves one
// float4 when every pointer is 16-byte aligned and k a multiple of 4, else
// four floats one at a time.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxPairs = 64;
constexpr int kThreads = 256;
constexpr int kPerBlock = 4 * kThreads;   // floats a block moves

struct PairTable {
  const float* src[kMaxPairs];
  float* dst[kMaxPairs];
};

__global__ void __launch_bounds__(kThreads) ring_shift_kernel(
    const __grid_constant__ PairTable table, long long floats, int vec4) {
  const float* __restrict__ src = table.src[blockIdx.x];
  float* __restrict__ dst = table.dst[blockIdx.x];
  const long long base = (long long)blockIdx.y * kPerBlock;
  if (vec4) {
    const long long i = base + 4 * threadIdx.x;
    if (i < floats) {
      *reinterpret_cast<float4*>(dst + i) = __ldg(reinterpret_cast<const float4*>(src + i));
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const long long i = base + j * kThreads + threadIdx.x;
    if (i < floats) dst[i] = __ldg(src + i);
  }
}

}  // namespace

// Copy src[p] -> dst[p] (each `floats` floats) for p < pairs, on `stream` of
// `device`. Returns a cudaError_t (0 on success), or -1 for a table the
// kernel does not take.
extern "C" int ring_shift(const void* const* src, void* const* dst, int pairs,
                          long long floats, int device, void* stream) {
  if (pairs < 1 || pairs > kMaxPairs || floats < 1) return -1;
  const long long chunks = (floats + kPerBlock - 1) / kPerBlock;
  if (chunks > 65535) return -1;
  PairTable table;
  int vec4 = floats % 4 == 0;
  for (int p = 0; p < pairs; ++p) {
    table.src[p] = static_cast<const float*>(src[p]);
    table.dst[p] = static_cast<float*>(dst[p]);
    vec4 &= (reinterpret_cast<unsigned long long>(src[p]) % 16 == 0) &&
            (reinterpret_cast<unsigned long long>(dst[p]) % 16 == 0);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  ring_shift_kernel<<<dim3(pairs, (unsigned)chunks), kThreads, 0, (cudaStream_t)stream>>>(
      table, floats, vec4);
  return (int)cudaGetLastError();
}

// Let `device` write into `peer`'s memory. Returns 0 when it can (already
// enabled included), -1 when the two cards have no peer path, else a
// cudaError_t.
extern "C" int enable_peer_access(int device, int peer) {
  int can = 0;
  cudaError_t err = cudaDeviceCanAccessPeer(&can, device, peer);
  if (err != cudaSuccess) return (int)err;
  if (!can) return -1;
  err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceEnablePeerAccess(peer, 0);
  if (err == cudaErrorPeerAccessAlreadyEnabled) {
    cudaGetLastError();   // clear it, so the next launch check does not report it
    return 0;
  }
  return (int)err;
}
