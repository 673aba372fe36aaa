// Native host-IO runtime of the PyTorch port: a copy of the JAX package's
// native/rdsp_io.cpp, built by radiodsp_sdr_rx_tpu_torch/utils/build.py
// (build_host_library) with g++ into the package's _build/, so that the port
// never writes into native/.
//
// The reference's C++ streaming runtime is the Teensy Audio library's
// ISR-driven block queues (AudioRecordQueue/AudioPlayQueue, ref:
// src/RadioDSP_SDR_RX/RDSP_convolutional.h:22-25, 231-244) and the I2S DMA
// double-buffering that feeds them. On a GPU host the equivalent component is
// a lock-free single-producer/single-consumer ring buffer between a real-time
// capture thread (file, pipe, or SDR device fd) and the Python feeder that
// moves blocks to the card, with explicit overrun drop counters.
//
// Also provides CMSIS-exact q15<->float conversion (arm_q15_to_float /
// arm_float_to_q15 semantics, ref RDSP_convolutional.h:241, 346) and streaming
// 16-bit stereo WAV capture reading so the hot byte-shuffling stays native.
//
// Build: g++ -O3 -std=c++17 -shared -fPIC -o librdsp_io.so rdsp_io.cpp -lpthread

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <new>

namespace {

struct Ring {
  int16_t* data;                 // interleaved I,Q
  size_t capacity;               // in complex samples (pairs)
  std::atomic<uint64_t> head{0}; // write position (complex samples)
  std::atomic<uint64_t> tail{0}; // read position
  std::atomic<uint64_t> dropped{0};
  std::atomic<uint64_t> pushed{0};
  std::atomic<uint64_t> popped{0};
};

inline float q15_to_float(int16_t q) { return static_cast<float>(q) / 32768.0f; }

inline int16_t float_to_q15(float f) {
  // CMSIS arm_float_to_q15: scale, truncate toward zero (C cast), saturate
  float scaled = f * 32768.0f;
  if (scaled >= 32767.0f) return 32767;
  if (scaled <= -32768.0f) return -32768;
  return static_cast<int16_t>(scaled);
}

}  // namespace

extern "C" {

// ---------------- ring buffer ----------------

void* rdsp_ring_create(size_t capacity_samples) {
  Ring* r = new (std::nothrow) Ring();
  if (!r) return nullptr;
  r->data = new (std::nothrow) int16_t[capacity_samples * 2];
  if (!r->data) {
    delete r;
    return nullptr;
  }
  r->capacity = capacity_samples;
  return r;
}

void rdsp_ring_destroy(void* h) {
  Ring* r = static_cast<Ring*>(h);
  if (!r) return;
  delete[] r->data;
  delete r;
}

// Push n interleaved (I,Q) int16 pairs. Returns samples accepted; the
// remainder is counted as dropped (overrun), like the reference queues
// dropping blocks when loop() falls behind.
size_t rdsp_ring_push(void* h, const int16_t* interleaved, size_t n) {
  Ring* r = static_cast<Ring*>(h);
  uint64_t head = r->head.load(std::memory_order_relaxed);
  uint64_t tail = r->tail.load(std::memory_order_acquire);
  size_t free_slots = r->capacity - static_cast<size_t>(head - tail);
  size_t accept = n < free_slots ? n : free_slots;
  for (size_t k = 0; k < accept; ++k) {
    size_t pos = static_cast<size_t>((head + k) % r->capacity);
    r->data[pos * 2] = interleaved[k * 2];
    r->data[pos * 2 + 1] = interleaved[k * 2 + 1];
  }
  r->head.store(head + accept, std::memory_order_release);
  r->pushed.fetch_add(accept, std::memory_order_relaxed);
  if (accept < n) r->dropped.fetch_add(n - accept, std::memory_order_relaxed);
  return accept;
}

// Pop up to n samples as deinterleaved float32 I and Q (q15 scaling).
size_t rdsp_ring_pop_float(void* h, float* out_i, float* out_q, size_t n) {
  Ring* r = static_cast<Ring*>(h);
  uint64_t tail = r->tail.load(std::memory_order_relaxed);
  uint64_t head = r->head.load(std::memory_order_acquire);
  size_t avail = static_cast<size_t>(head - tail);
  size_t take = n < avail ? n : avail;
  for (size_t k = 0; k < take; ++k) {
    size_t pos = static_cast<size_t>((tail + k) % r->capacity);
    out_i[k] = q15_to_float(r->data[pos * 2]);
    out_q[k] = q15_to_float(r->data[pos * 2 + 1]);
  }
  r->tail.store(tail + take, std::memory_order_release);
  r->popped.fetch_add(take, std::memory_order_relaxed);
  return take;
}

size_t rdsp_ring_available(void* h) {
  Ring* r = static_cast<Ring*>(h);
  return static_cast<size_t>(r->head.load(std::memory_order_acquire) -
                             r->tail.load(std::memory_order_acquire));
}

uint64_t rdsp_ring_dropped(void* h) {
  return static_cast<Ring*>(h)->dropped.load(std::memory_order_relaxed);
}

uint64_t rdsp_ring_pushed(void* h) {
  return static_cast<Ring*>(h)->pushed.load(std::memory_order_relaxed);
}

uint64_t rdsp_ring_popped(void* h) {
  return static_cast<Ring*>(h)->popped.load(std::memory_order_relaxed);
}

// ---------------- q15 conversion (CMSIS semantics) ----------------

void rdsp_q15_to_float(const int16_t* in, float* out, size_t n) {
  for (size_t k = 0; k < n; ++k) out[k] = q15_to_float(in[k]);
}

void rdsp_float_to_q15(const float* in, int16_t* out, size_t n) {
  for (size_t k = 0; k < n; ++k) out[k] = float_to_q15(in[k]);
}

// ---------------- streaming WAV reader (16-bit PCM) ----------------

struct WavReader {
  FILE* f = nullptr;
  uint32_t sample_rate = 0;
  uint16_t channels = 0;
  uint16_t bits = 0;
  uint64_t data_remaining = 0;  // bytes
};

void* rdsp_wav_open(const char* path) {
  WavReader* w = new (std::nothrow) WavReader();
  if (!w) return nullptr;
  w->f = std::fopen(path, "rb");
  if (!w->f) {
    delete w;
    return nullptr;
  }
  char id[4];
  uint32_t sz;
  if (std::fread(id, 1, 4, w->f) != 4 || std::memcmp(id, "RIFF", 4) != 0)
    goto fail;
  std::fseek(w->f, 4, SEEK_CUR);  // riff size
  if (std::fread(id, 1, 4, w->f) != 4 || std::memcmp(id, "WAVE", 4) != 0)
    goto fail;
  // chunk walk
  while (std::fread(id, 1, 4, w->f) == 4 && std::fread(&sz, 4, 1, w->f) == 1) {
    if (std::memcmp(id, "fmt ", 4) == 0) {
      uint16_t fmt;
      std::fread(&fmt, 2, 1, w->f);
      std::fread(&w->channels, 2, 1, w->f);
      std::fread(&w->sample_rate, 4, 1, w->f);
      std::fseek(w->f, 6, SEEK_CUR);  // byte rate + block align
      std::fread(&w->bits, 2, 1, w->f);
      std::fseek(w->f, sz - 16, SEEK_CUR);
    } else if (std::memcmp(id, "data", 4) == 0) {
      w->data_remaining = sz;
      return w;
    } else {
      std::fseek(w->f, sz, SEEK_CUR);
    }
  }
fail:
  std::fclose(w->f);
  delete w;
  return nullptr;
}

uint32_t rdsp_wav_sample_rate(void* h) { return static_cast<WavReader*>(h)->sample_rate; }
uint32_t rdsp_wav_channels(void* h) { return static_cast<WavReader*>(h)->channels; }

// Read up to n frames of 16-bit stereo into interleaved int16 pairs.
// Mono files duplicate the channel. Returns frames read.
size_t rdsp_wav_read(void* h, int16_t* interleaved, size_t n_frames) {
  WavReader* w = static_cast<WavReader*>(h);
  if (w->bits != 16) return 0;
  size_t frame_bytes = 2u * w->channels;
  size_t want = n_frames;
  uint64_t frames_left = w->data_remaining / frame_bytes;
  if (want > frames_left) want = static_cast<size_t>(frames_left);
  if (w->channels == 2) {
    size_t got = std::fread(interleaved, frame_bytes, want, w->f);
    w->data_remaining -= got * frame_bytes;
    return got;
  }
  // mono: read then duplicate
  size_t got = 0;
  int16_t v;
  for (; got < want; ++got) {
    if (std::fread(&v, 2, 1, w->f) != 1) break;
    interleaved[got * 2] = v;
    interleaved[got * 2 + 1] = v;
  }
  w->data_remaining -= got * frame_bytes;
  return got;
}

void rdsp_wav_close(void* h) {
  WavReader* w = static_cast<WavReader*>(h);
  if (!w) return;
  if (w->f) std::fclose(w->f);
  delete w;
}

}  // extern "C"
