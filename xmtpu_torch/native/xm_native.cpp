// xmtpu_torch native host runtime: WAV codec + sample conversion + FIFO
// (a copy of xmtpu/native/xm_native.cpp, same C ABI).
//
// Reference analogue: the C host layer of the upstream library —
// `src/codec/audio_decoder.c` (file -> PCM), `src/tools/conversion.*`
// (short<->float with round-half-away), `src/tools/fifo.c` (ring buffer
// between pipeline stages) [upstream, SURVEY.md §2.1]. HOST side only:
// the DSP runs on the GPU (xmtpu_torch/csrc).
//
// Build: g++ -O3 -shared -fPIC -std=c++17 -o libxm_native.so xm_native.cpp
// (xmtpu_torch/native/__init__.py builds it at first use into
// xmtpu_torch/_build/native/<key>/ and binds it with ctypes).

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cmath>

extern "C" {

// ---------------------------------------------------------------------------
// WAV codec (RIFF PCM16 / IEEE f32; chunk-walking parser)
// ---------------------------------------------------------------------------

struct WavInfo {
  int32_t sample_rate;
  int32_t channels;
  int64_t n_frames;
  int32_t bits;
  int32_t format;  // 1 = PCM, 3 = IEEE float
};

static int read_exact(FILE* f, void* p, size_t n) {
  return fread(p, 1, n, f) == n ? 0 : -1;
}

// Parse header; on success the file is positioned at the data payload.
static int wav_open(FILE* f, WavInfo* info, uint32_t* data_bytes) {
  char tag[4];
  uint32_t sz;
  if (read_exact(f, tag, 4) || memcmp(tag, "RIFF", 4)) return -1;
  if (read_exact(f, &sz, 4)) return -1;
  if (read_exact(f, tag, 4) || memcmp(tag, "WAVE", 4)) return -1;
  bool have_fmt = false;
  uint16_t fmt = 0, ch = 0, bits = 0;
  uint32_t rate = 0;
  for (;;) {
    if (read_exact(f, tag, 4) || read_exact(f, &sz, 4)) return -1;
    if (!memcmp(tag, "fmt ", 4)) {
      uint8_t buf[40];
      if (sz < 16 || sz > 40) return -1;
      if (read_exact(f, buf, sz)) return -1;
      memcpy(&fmt, buf + 0, 2);
      memcpy(&ch, buf + 2, 2);
      memcpy(&rate, buf + 4, 4);
      memcpy(&bits, buf + 14, 2);
      if (fmt == 0xFFFE && sz >= 40) memcpy(&fmt, buf + 24, 2);  // extensible
      have_fmt = true;
    } else if (!memcmp(tag, "data", 4)) {
      if (!have_fmt || ch == 0 || bits == 0) return -1;
      if (!((fmt == 1 && (bits == 16 || bits == 24)) ||
            (fmt == 3 && bits == 32)))
        return -2;
      info->sample_rate = (int32_t)rate;
      info->channels = (int32_t)ch;
      info->bits = bits;
      info->format = fmt;
      info->n_frames = (int64_t)sz / (bits / 8) / ch;
      *data_bytes = sz;
      return 0;
    } else {
      if (fseek(f, (long)(sz + (sz & 1)), SEEK_CUR)) return -1;  // pad byte
    }
  }
}

// Decode a WAV file to interleaved int16 (IEEE f32 data is converted with
// the pinned round-half-away rule). Caller frees *out with xm_free.
int xm_wav_read(const char* path, int16_t** out, int64_t* n_frames,
                int32_t* channels, int32_t* sample_rate) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  WavInfo info;
  uint32_t bytes;
  int rc = wav_open(f, &info, &bytes);
  if (rc) { fclose(f); return rc; }
  int64_t n = info.n_frames * info.channels;
  int16_t* pcm = (int16_t*)malloc((size_t)n * 2 + 2);
  if (!pcm) { fclose(f); return -3; }
  if (info.format == 1 && info.bits == 16) {
    if (read_exact(f, pcm, (size_t)n * 2)) { free(pcm); fclose(f); return -1; }
  } else if (info.format == 1 && info.bits == 24) {
    // 24-bit PCM -> int16: keep the top 16 bits (truncate; identical
    // to the stdlib-path convention, cross-checked bit-exact in tests)
    uint8_t* tmp = (uint8_t*)malloc((size_t)n * 3 + 4);
    if (!tmp || read_exact(f, tmp, (size_t)n * 3)) {
      free(tmp); free(pcm); fclose(f); return -1;
    }
    for (int64_t i = 0; i < n; i++) {
      int32_t v = (int32_t)tmp[3 * i] | ((int32_t)tmp[3 * i + 1] << 8) |
                  ((int32_t)tmp[3 * i + 2] << 16);
      pcm[i] = (int16_t)(((v << 8)) >> 16);  // sign via bit23 -> bit31
    }
    free(tmp);
  } else {
    float* tmp = (float*)malloc((size_t)n * 4 + 4);
    if (!tmp || read_exact(f, tmp, (size_t)n * 4)) {
      free(tmp); free(pcm); fclose(f); return -1;
    }
    for (int64_t i = 0; i < n; i++) {
      float s = tmp[i] * 32768.0f;
      s = s >= 0 ? floorf(s + 0.5f) : -floorf(-s + 0.5f);
      if (s > 32767.f) s = 32767.f;
      if (s < -32768.f) s = -32768.f;
      pcm[i] = (int16_t)s;
    }
    free(tmp);
  }
  fclose(f);
  *out = pcm;
  *n_frames = info.n_frames;
  *channels = info.channels;
  *sample_rate = info.sample_rate;
  return 0;
}

int xm_wav_write(const char* path, const int16_t* pcm, int64_t n_frames,
                 int32_t channels, int32_t sample_rate) {
  FILE* f = fopen(path, "wb");
  if (!f) return -1;
  int64_t data64 = n_frames * (int64_t)channels * 2;
  if (data64 < 0 || data64 > 0xFFFFFFFFLL - 36) {
    // RIFF sizes are 32-bit; refuse instead of silently wrapping the
    // header for >= 4 GiB payloads
    fclose(f);
    return -2;
  }
  uint32_t data = (uint32_t)data64;
  uint32_t riff = 36 + data;
  uint16_t fmt = 1, bits = 16, ch = (uint16_t)channels;
  uint32_t rate = (uint32_t)sample_rate;
  uint32_t brate = rate * ch * 2;
  uint16_t balign = ch * 2;
  uint32_t fmtsz = 16;
  int ok = fwrite("RIFF", 1, 4, f) == 4 && fwrite(&riff, 4, 1, f) == 1 &&
           fwrite("WAVE", 1, 4, f) == 4 && fwrite("fmt ", 1, 4, f) == 4 &&
           fwrite(&fmtsz, 4, 1, f) == 1 && fwrite(&fmt, 2, 1, f) == 1 &&
           fwrite(&ch, 2, 1, f) == 1 && fwrite(&rate, 4, 1, f) == 1 &&
           fwrite(&brate, 4, 1, f) == 1 && fwrite(&balign, 2, 1, f) == 1 &&
           fwrite(&bits, 2, 1, f) == 1 && fwrite("data", 1, 4, f) == 4 &&
           fwrite(&data, 4, 1, f) == 1 &&
           fwrite(pcm, 1, data, f) == data;
  fclose(f);
  return ok ? 0 : -1;
}

void xm_free(void* p) { free(p); }

// ---------------------------------------------------------------------------
// Sample conversion — the pinned bit-exact rules (SURVEY.md §4.2; tests
// assert these match the JAX/numpy twins sample-for-sample)
// ---------------------------------------------------------------------------

void xm_i16_to_f32(const int16_t* in, float* out, int64_t n) {
  const float k = 1.0f / 32768.0f;
  for (int64_t i = 0; i < n; i++) out[i] = (float)in[i] * k;
}

void xm_f32_to_i16(const float* in, int16_t* out, int64_t n) {
  for (int64_t i = 0; i < n; i++) {
    float s = in[i] * 32768.0f;
    s = s >= 0 ? floorf(s + 0.5f) : -floorf(-s + 0.5f);  // half away from 0
    if (s > 32767.f) s = 32767.f;
    if (s < -32768.f) s = -32768.f;
    out[i] = (int16_t)s;
  }
}

// ---------------------------------------------------------------------------
// FIFO ring buffer — single-producer single-consumer, lock-free
// (the streaming feeder's host-side buffer; reference `fifo.c`)
// ---------------------------------------------------------------------------

struct XmFifo {
  uint8_t* buf;
  int64_t cap;
  std::atomic<int64_t> head;  // write cursor (monotonic)
  std::atomic<int64_t> tail;  // read cursor (monotonic)
};

void* xm_fifo_create(int64_t capacity) {
  if (capacity <= 0) return nullptr;
  XmFifo* f = new XmFifo();
  f->buf = (uint8_t*)malloc((size_t)capacity);
  if (!f->buf) {  // let the ctypes wrapper raise instead of a later
    delete f;     // memcpy into nullptr
    return nullptr;
  }
  f->cap = capacity;
  f->head.store(0);
  f->tail.store(0);
  return f;
}

void xm_fifo_free(void* p) {
  XmFifo* f = (XmFifo*)p;
  free(f->buf);
  delete f;
}

int64_t xm_fifo_size(void* p) {
  XmFifo* f = (XmFifo*)p;
  return f->head.load(std::memory_order_acquire) -
         f->tail.load(std::memory_order_acquire);
}

int64_t xm_fifo_space(void* p) {
  XmFifo* f = (XmFifo*)p;
  return f->cap - xm_fifo_size(p);
}

int64_t xm_fifo_write(void* p, const void* data, int64_t n) {
  XmFifo* f = (XmFifo*)p;
  int64_t space = f->cap - (f->head.load(std::memory_order_relaxed) -
                            f->tail.load(std::memory_order_acquire));
  if (n > space) n = space;
  if (n <= 0) return 0;
  int64_t h = f->head.load(std::memory_order_relaxed);
  int64_t off = h % f->cap;
  int64_t first = n < f->cap - off ? n : f->cap - off;
  memcpy(f->buf + off, data, (size_t)first);
  if (n > first) memcpy(f->buf, (const uint8_t*)data + first, (size_t)(n - first));
  f->head.store(h + n, std::memory_order_release);
  return n;
}

int64_t xm_fifo_read(void* p, void* data, int64_t n) {
  XmFifo* f = (XmFifo*)p;
  int64_t avail = f->head.load(std::memory_order_acquire) -
                  f->tail.load(std::memory_order_relaxed);
  if (n > avail) n = avail;
  if (n <= 0) return 0;
  int64_t t = f->tail.load(std::memory_order_relaxed);
  int64_t off = t % f->cap;
  int64_t first = n < f->cap - off ? n : f->cap - off;
  memcpy(data, f->buf + off, (size_t)first);
  if (n > first) memcpy((uint8_t*)data + first, f->buf, (size_t)(n - first));
  f->tail.store(t + n, std::memory_order_release);
  return n;
}

}  // extern "C"
