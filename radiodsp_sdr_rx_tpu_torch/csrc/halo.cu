// halo.cu: the ring halo exchange of a time-sharded stream, every shard's
// block copied to its right neighbour.
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
// One kernel, ring_shift_kernel, copies a table of (source, destination)
// pairs; block (p, j) copies floats [1024 j, 1024 j + 1024) of pair p. A
// complex64 block is its interleaved float storage, 2k floats, with no split
// into planes. The table rides in the launch's parameter space
// (__grid_constant__, up to kMaxPairs pairs), so no copy of it precedes the
// launch. Two entries launch it:
//
//   - ring_shift: the shards of mesh lines in one process (parallel/halo.py).
//     On one card the whole exchange, every ring of it, is ONE launch whose
//     destinations are the blocks of one new allocation, and the barrier
//     reduces to stream order (the output exists and the sources are written
//     before the kernel starts); with shards on several cards, one launch per
//     source card, writing into its neighbours' buffers by peer access
//     (enable_peer_access).
//   - group_ring_*: one shard a process (a process-group mesh). Each rank
//     owns kSlots receive slots that exchanges take in turn, allocated here
//     (a cudaMalloc of their own, so an IPC handle names exactly them) and
//     exported with cudaIpcGetMemHandle; its left neighbour opens them once
//     (cudaIpcOpenMemHandle, lazy peer access for another card) and writes
//     its tail straight into them, as the TPU kernel's remote DMA does. The
//     neighbour barrier: "written[s]", an interprocess event, goes from
//     sender to receiver in stream order (the sender records it after the
//     write, the receiver's stream waits for it); "freed[s]" goes from
//     receiver to sender through the host: the receiver records it on its
//     stream when every use of slot s it has issued is behind it, and tells
//     the sender once the event is done (group_ring_freed), so the write
//     needs no wait on the device. A wait on an event returns at once if its
//     record has not been issued yet, so the wrapper (parallel/halo.GroupRing)
//     orders each record before its wait through flags on the host. No
//     kernel spins on a flag another process sets: with two processes on one
//     card and no MPS their contexts time-slice, and a spinning kernel would
//     hold the card. The contexts take turns on one card, so a
//     record in one context is seen done in another only after a turn of
//     theirs: with the slot-free wait on the sender's stream, and then with
//     a slot freed only one exchange before its write, each exchange waited
//     for such a round trip (diag/halo_group.py). So a rank has kSlots
//     slots, exchange k writes slot k mod kSlots, and the receiver frees the
//     slot of exchange k + kSlots - 2 (last read as exchange k - 2's result)
//     at its exchange k: a sender finds its slot freed kSlots - 2 exchanges
//     ahead.
//
// What bounds it on an H100: bytes and, below a few MB, the launch itself.
// A ring of S shards of k floats reads and writes S*k*4 bytes each: 4 shards
// of a (128, 128) complex64 bank tail are 1 MiB in and 1 MiB out (0.6 us at
// 3.35 TB/s); a 1-D stream's tail is 1 KiB a shard. So the host's cost of an
// exchange decides its time; the wrappers keep it to one launch and no
// allocation but the output. Each thread moves one float4 when every pointer
// is 16-byte aligned and k a multiple of 4, else four floats one at a time.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxPairs = 64;
constexpr int kSlots = 8;     // a rank's receive slots across processes
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

bool aligned16(const void* p) { return reinterpret_cast<unsigned long long>(p) % 16 == 0; }

// Launch the copy of table's first `pairs` pairs on `stream` of the current
// device. Returns a cudaError_t, or -1 for a table the kernel does not take.
int launch_table(const PairTable& table, int pairs, long long floats, cudaStream_t stream) {
  if (pairs < 1 || pairs > kMaxPairs || floats < 1) return -1;
  const long long chunks = (floats + kPerBlock - 1) / kPerBlock;
  if (chunks > 65535) return -1;
  int vec4 = floats % 4 == 0;
  for (int p = 0; p < pairs; ++p) vec4 &= aligned16(table.src[p]) && aligned16(table.dst[p]);
  ring_shift_kernel<<<dim3(pairs, (unsigned)chunks), kThreads, 0, stream>>>(table, floats, vec4);
  return (int)cudaGetLastError();
}

// Makes `device` current for the scope and restores the caller's device
// after it; no call at all when it is current already.
class DeviceScope {
 public:
  explicit DeviceScope(int device) {
    err_ = cudaGetDevice(&prev_);
    if (err_ == cudaSuccess && prev_ != device) {
      err_ = cudaSetDevice(device);
    } else {
      prev_ = -1;
    }
  }
  ~DeviceScope() {
    if (prev_ >= 0) cudaSetDevice(prev_);
  }
  cudaError_t error() const { return err_; }

 private:
  int prev_ = -1;
  cudaError_t err_;
};

}  // namespace

// Copy src[p] -> dst[p] (each `floats` floats) for p < pairs, on `stream` of
// `device`; src and dst are tables of `pairs` pointers. Returns a cudaError_t (0 on success), or -1 for a table the
// kernel does not take.
extern "C" int ring_shift(const void* const* src, void* const* dst, int pairs,
                          long long floats, int device, void* stream) {
  if (pairs < 1 || pairs > kMaxPairs) return -1;
  PairTable table;
  for (int p = 0; p < pairs; ++p) {
    table.src[p] = static_cast<const float*>(src[p]);
    table.dst[p] = static_cast<float*>(dst[p]);
  }
  DeviceScope scope(device);
  if (scope.error() != cudaSuccess) return (int)scope.error();
  return launch_table(table, pairs, floats, (cudaStream_t)stream);
}

// Let `device` write into `peer`'s memory. Returns 0 when it can (already
// enabled included), -1 when the two cards have no peer path, else a
// cudaError_t.
extern "C" int enable_peer_access(int device, int peer) {
  int can = 0;
  cudaError_t err = cudaDeviceCanAccessPeer(&can, device, peer);
  if (err != cudaSuccess) return (int)err;
  if (!can) return -1;
  DeviceScope scope(device);
  if (scope.error() != cudaSuccess) return (int)scope.error();
  err = cudaDeviceEnablePeerAccess(peer, 0);
  if (err == cudaErrorPeerAccessAlreadyEnabled) {
    cudaGetLastError();   // clear it, so the next launch check does not report it
    return 0;
  }
  return (int)err;
}

// ---- the ring across processes: one rank's end of it ----

namespace {

// What a rank shows its neighbours, exchanged once over the process group:
// its slots (for its left neighbour, which writes them) and its written
// events (its right neighbour waits on them).
struct RingHandles {
  cudaIpcMemHandle_t slots;
  cudaIpcEventHandle_t written[kSlots];
};

struct GroupRing {
  int device = 0;
  long long floats = 0;
  float* slots = nullptr;                  // this rank's receive slots, kSlots * floats
  cudaEvent_t freed[kSlots] = {};          // recorded here: slot s may be written again
  cudaEvent_t written[kSlots] = {};        // recorded here after writing the right's slot s
  float* right = nullptr;                  // the right neighbour's slots, opened
  cudaEvent_t left_written[kSlots] = {};   // the left neighbour's written, opened
};

// Close what this rank opened of its neighbours: the right one's slots and
// the left one's written events.
void disconnect(GroupRing* ring) {
  for (int s = 0; s < kSlots; ++s) {
    if (ring->left_written[s]) cudaEventDestroy(ring->left_written[s]);
    ring->left_written[s] = nullptr;
  }
  if (ring->right) cudaIpcCloseMemHandle(ring->right);
  ring->right = nullptr;
}

// Free this rank's own slots and events (after disconnect).
void release(GroupRing* ring) {
  disconnect(ring);
  for (int s = 0; s < kSlots; ++s) {
    if (ring->freed[s]) cudaEventDestroy(ring->freed[s]);
    if (ring->written[s]) cudaEventDestroy(ring->written[s]);
  }
  if (ring->slots) cudaFree(ring->slots);
  delete ring;
}

int slot_of(int slot) { return ((slot % kSlots) + kSlots) % kSlots; }

}  // namespace

extern "C" int group_ring_handles_size() { return (int)sizeof(RingHandles); }

extern "C" int group_ring_slots() { return kSlots; }

// Allocate a rank's end of a ring of `floats`-float blocks on `device`: its
// kSlots slots (returned in *slots, slot s at *slots + s * floats) and its
// events, and write the IPC handles of the slots and the written events to
// `handles` (group_ring_handles_size bytes). Returns a cudaError_t; *ring is
// null unless it returns 0.
extern "C" int group_ring_create(int device, long long floats, void** ring_out,
                                 void** slots, void* handles) {
  *ring_out = nullptr;
  if (floats < 1 || (floats + kPerBlock - 1) / kPerBlock > 65535) return -1;
  DeviceScope scope(device);
  if (scope.error() != cudaSuccess) return (int)scope.error();
  GroupRing* ring = new GroupRing;
  ring->device = device;
  ring->floats = floats;
  RingHandles* h = static_cast<RingHandles*>(handles);
  cudaError_t err = cudaMalloc(&ring->slots, kSlots * floats * sizeof(float));
  if (err == cudaSuccess) err = cudaIpcGetMemHandle(&h->slots, ring->slots);
  for (int s = 0; s < kSlots && err == cudaSuccess; ++s) {
    err = cudaEventCreateWithFlags(&ring->freed[s], cudaEventDisableTiming);
    if (err == cudaSuccess) {
      err = cudaEventCreateWithFlags(&ring->written[s],
                                     cudaEventInterprocess | cudaEventDisableTiming);
    }
    if (err == cudaSuccess) err = cudaIpcGetEventHandle(&h->written[s], ring->written[s]);
  }
  if (err != cudaSuccess) {
    release(ring);
    return (int)err;
  }
  *ring_out = ring;
  *slots = ring->slots;
  return 0;
}

// Open the neighbours' handles: the left one's written events (null for
// the first rank of a line) and the right one's slots (null for the last).
// Returns a cudaError_t.
extern "C" int group_ring_connect(void* ring_ptr, const void* left, const void* right) {
  GroupRing* ring = static_cast<GroupRing*>(ring_ptr);
  DeviceScope scope(ring->device);
  if (scope.error() != cudaSuccess) return (int)scope.error();
  cudaError_t err = cudaSuccess;
  if (left) {
    const RingHandles* h = static_cast<const RingHandles*>(left);
    for (int s = 0; s < kSlots && err == cudaSuccess; ++s)
      err = cudaIpcOpenEventHandle(&ring->left_written[s], h->written[s]);
  }
  if (right && err == cudaSuccess) {
    const RingHandles* h = static_cast<const RingHandles*>(right);
    void* mapped = nullptr;
    err = cudaIpcOpenMemHandle(&mapped, h->slots, cudaIpcMemLazyEnablePeerAccess);
    if (err == cudaSuccess) ring->right = static_cast<float*>(mapped);
  }
  return (int)err;
}

// The receiver's half of the barrier: record that every use of slot `slot`
// issued on `stream` so far is behind it. Returns a cudaError_t.
extern "C" int group_ring_release(void* ring_ptr, int slot, void* stream) {
  GroupRing* ring = static_cast<GroupRing*>(ring_ptr);
  return (int)cudaEventRecord(ring->freed[slot_of(slot)], (cudaStream_t)stream);
}

// Whether the last release of slot `slot` is done: 0 when it is,
// cudaErrorNotReady when not yet, else a cudaError_t.
extern "C" int group_ring_freed(void* ring_ptr, int slot) {
  GroupRing* ring = static_cast<GroupRing*>(ring_ptr);
  return (int)cudaEventQuery(ring->freed[slot_of(slot)]);
}

// One launch: `tail` into the right neighbour's slot `slot` (when the rank
// has a right neighbour; the wrapper has seen the slot freed), and `first`
// (when not null) into this rank's own slot `slot`, the stream-start carry
// of a line's first rank; then the written record. Returns a cudaError_t,
// or -1 for nothing to copy.
extern "C" int group_ring_send(void* ring_ptr, int slot, const void* tail, const void* first,
                               void* stream) {
  GroupRing* ring = static_cast<GroupRing*>(ring_ptr);
  const cudaStream_t s = (cudaStream_t)stream;
  slot = slot_of(slot);
  PairTable table;
  int pairs = 0;
  if (ring->right) {
    table.src[pairs] = static_cast<const float*>(tail);
    table.dst[pairs++] = ring->right + slot * ring->floats;
  }
  if (first) {
    table.src[pairs] = static_cast<const float*>(first);
    table.dst[pairs++] = ring->slots + slot * ring->floats;
  }
  if (!pairs) return -1;
  DeviceScope scope(ring->device);
  if (scope.error() != cudaSuccess) return (int)scope.error();
  const int err = launch_table(table, pairs, ring->floats, s);
  if (err || !ring->right) return err;
  return (int)cudaEventRecord(ring->written[slot], s);
}

// The receiver's wait: `stream` goes on once the left neighbour's write into
// slot `slot` is done. Returns a cudaError_t.
extern "C" int group_ring_wait(void* ring_ptr, int slot, void* stream) {
  GroupRing* ring = static_cast<GroupRing*>(ring_ptr);
  return (int)cudaStreamWaitEvent((cudaStream_t)stream, ring->left_written[slot_of(slot)], 0);
}

// Close the neighbours' handles (the left one's events, the right one's
// slots). The first half of a ring's teardown: every rank of the line
// disconnects before any frees, since the left neighbour's mapping of a
// rank's slots must be closed before the slots are freed (a cudaFree of an
// exported allocation still open in another process is undefined).
extern "C" void group_ring_disconnect(void* ring_ptr) {
  if (!ring_ptr) return;
  GroupRing* ring = static_cast<GroupRing*>(ring_ptr);
  DeviceScope scope(ring->device);
  disconnect(ring);
}

// Disconnect if not yet, then free the slots and events. The caller makes
// sure no neighbour writes into the slots or still maps them: every rank of
// the line has disconnected (parallel/halo.close_rings, or, where the line
// cannot meet, every rank's disconnected flag; without them the caller
// leaks the slots and events rather than call this).
extern "C" void group_ring_destroy(void* ring_ptr) {
  if (!ring_ptr) return;
  GroupRing* ring = static_cast<GroupRing*>(ring_ptr);
  DeviceScope scope(ring->device);
  release(ring);
}
