// scl_data: the host data runtime of speech_cloner_tpu_torch.
//
// Serves random window crops out of a memory-mapped packed feature file
// (.sclpack, written by data/packed_cache.py write_pack) with a pool of
// threads, so a training batch is assembled by parallel memcpy instead of
// per-utterance Python reads; and decodes 16-bit PCM from RIFF WAV and
// NIST SPHERE (TIMIT) files in one pass.
//
// Host C++, not a device kernel. Built at first use by data/packed_cache.py
// (c++ -O3 -std=c++17 -fPIC -shared -pthread) into build/torch_kernels/,
// named by a hash of this source. ABI: plain C, bound with ctypes.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr char kMagic[8] = {'S', 'C', 'L', 'P', 'A', 'C', 'K', '1'};

struct Header {
  char magic[8];
  uint32_t n_utts;
  uint32_t n_streams;
};

struct Pack {
  int fd = -1;
  const uint8_t* base = nullptr;
  size_t size = 0;
  uint32_t n_utts = 0;
  uint32_t n_streams = 0;
  std::vector<uint32_t> dims;       // per stream: columns
  std::vector<uint32_t> n_frames;   // per utt: rows (shared by all streams)
  std::vector<uint64_t> offsets;    // per utt: byte offset of its data block
};

// Layout after header: u32 dims[n_streams]; u32 n_frames[n_utts];
// u64 offsets[n_utts]; then data. Utt block = streams concatenated:
// stream0 [T_i, dim0] float32, stream1 [T_i, dim1], ...

const float* utt_stream_ptr(const Pack& p, int utt, int stream) {
  const uint8_t* blk = p.base + p.offsets[utt];
  uint64_t skip = 0;
  for (int s = 0; s < stream; ++s)
    skip += uint64_t(p.n_frames[utt]) * p.dims[s] * sizeof(float);
  return reinterpret_cast<const float*>(blk + skip);
}

}  // namespace

extern "C" {

void* scl_open(const char* path) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0) { ::close(fd); return nullptr; }
  void* mem = mmap(nullptr, st.st_size, PROT_READ, MAP_SHARED, fd, 0);
  if (mem == MAP_FAILED) { ::close(fd); return nullptr; }

  auto* p = new Pack;
  p->fd = fd;
  p->base = static_cast<const uint8_t*>(mem);
  p->size = st.st_size;

  const auto* h = reinterpret_cast<const Header*>(p->base);
  if (memcmp(h->magic, kMagic, 8) != 0) {
    munmap(mem, st.st_size); ::close(fd); delete p; return nullptr;
  }
  p->n_utts = h->n_utts;
  p->n_streams = h->n_streams;

  const uint8_t* cur = p->base + sizeof(Header);
  p->dims.assign(reinterpret_cast<const uint32_t*>(cur),
                 reinterpret_cast<const uint32_t*>(cur) + p->n_streams);
  cur += p->n_streams * sizeof(uint32_t);
  p->n_frames.assign(reinterpret_cast<const uint32_t*>(cur),
                     reinterpret_cast<const uint32_t*>(cur) + p->n_utts);
  cur += p->n_utts * sizeof(uint32_t);
  p->offsets.assign(reinterpret_cast<const uint64_t*>(cur),
                    reinterpret_cast<const uint64_t*>(cur) + p->n_utts);
  return p;
}

void scl_close(void* handle) {
  auto* p = static_cast<Pack*>(handle);
  if (!p) return;
  munmap(const_cast<uint8_t*>(p->base), p->size);
  ::close(p->fd);
  delete p;
}

int scl_n_utts(void* handle) { return static_cast<Pack*>(handle)->n_utts; }
int scl_n_streams(void* handle) { return static_cast<Pack*>(handle)->n_streams; }
int scl_stream_dim(void* handle, int s) { return static_cast<Pack*>(handle)->dims[s]; }
int scl_n_frames(void* handle, int utt) { return static_cast<Pack*>(handle)->n_frames[utt]; }

// Gather B window crops: out[b] = stream[utts[b]][starts[b] : starts[b]+T].
// Rows past the utterance end are zero-filled (short-utterance padding).
// Returns 0 on success.
int scl_gather_batch(void* handle, const int32_t* utts, const int32_t* starts,
                     int B, int T, int stream, float* out, int n_threads) {
  auto* p = static_cast<Pack*>(handle);
  if (!p || stream < 0 || stream >= static_cast<int>(p->n_streams)) return -1;
  const int dim = p->dims[stream];
  const size_t win = size_t(T) * dim;

  std::atomic<int> next{0};
  std::atomic<int> err{0};
  auto work = [&]() {
    for (int b = next.fetch_add(1); b < B; b = next.fetch_add(1)) {
      const int u = utts[b];
      if (u < 0 || u >= static_cast<int>(p->n_utts)) { err = -2; return; }
      const int tf = p->n_frames[u];
      const int s0 = starts[b];
      float* dst = out + size_t(b) * win;
      const int n_copy = std::max(0, std::min(T, tf - s0));
      if (n_copy > 0) {
        const float* src = utt_stream_ptr(*p, u, stream) + size_t(s0) * dim;
        memcpy(dst, src, size_t(n_copy) * dim * sizeof(float));
      }
      if (n_copy < T)
        memset(dst + size_t(n_copy) * dim, 0, size_t(T - n_copy) * dim * sizeof(float));
    }
  };

  if (n_threads <= 1 || B == 1) {
    work();
  } else {
    std::vector<std::thread> ts;
    const int nt = std::min(n_threads, B);
    ts.reserve(nt);
    for (int i = 0; i < nt; ++i) ts.emplace_back(work);
    for (auto& t : ts) t.join();
  }
  return err.load();
}

// ---------------------------------------------------------- audio decode ---

// Decode 16-bit PCM from a RIFF WAV or NIST SPHERE file into out (mono,
// channel-averaged). Returns n_samples, or -1 on error or for any other
// sample coding (the RIFF format tag and bits per sample are read, so an
// 8- or 24-bit file is refused, not read as 16-bit). Pass out=nullptr to
// query the required length. sr_out receives the file's sample rate.
int64_t scl_decode_pcm(const char* path, float* out, int64_t out_cap,
                       int32_t* sr_out) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  uint8_t head[8] = {0};
  if (fread(head, 1, 8, f) != 8) { fclose(f); return -1; }

  int sr = 0, channels = 1, bytes_per = 2, big_endian = 0;
  long data_off = -1;
  int64_t data_len = 0;

  if (memcmp(head, "RIFF", 4) == 0) {
    fseek(f, 12, SEEK_SET);  // skip RIFF size + WAVE
    char id[4]; uint32_t sz;
    while (fread(id, 1, 4, f) == 4 && fread(&sz, 4, 1, f) == 1) {
      if (memcmp(id, "fmt ", 4) == 0) {
        // audio_format, channels, rate, byte_rate, block_align, bits_per_sample
        uint16_t fmt16[2]; uint32_t rate, byte_rate; uint16_t align_bits[2];
        if (sz < 16 || fread(fmt16, 2, 2, f) != 2 || fread(&rate, 4, 1, f) != 1 ||
            fread(&byte_rate, 4, 1, f) != 1 || fread(align_bits, 2, 2, f) != 2) {
          fclose(f);
          return -1;
        }
        if (fmt16[0] != 1) { fclose(f); return -1; }   // integer PCM only
        channels = fmt16[1];
        sr = static_cast<int>(rate);
        bytes_per = align_bits[1] / 8;
        fseek(f, sz - 16 + (sz & 1), SEEK_CUR);
      } else if (memcmp(id, "data", 4) == 0) {
        data_off = ftell(f);
        data_len = sz;
        break;
      } else {
        fseek(f, sz + (sz & 1), SEEK_CUR);
      }
    }
  } else if (memcmp(head, "NIST_1A", 7) == 0) {
    char line[256];
    fseek(f, 0, SEEK_SET);
    fgets(line, sizeof line, f);               // NIST_1A
    fgets(line, sizeof line, f);               // header size
    long hdr = atol(line);
    while (fgets(line, sizeof line, f) && strncmp(line, "end_head", 8) != 0) {
      int v;
      if (sscanf(line, "sample_rate -i %d", &v) == 1) sr = v;
      else if (sscanf(line, "channel_count -i %d", &v) == 1) channels = v;
      else if (sscanf(line, "sample_n_bytes -i %d", &v) == 1) bytes_per = v;
      else if (strstr(line, "sample_byte_format -s2 10")) big_endian = 1;
      else if (strstr(line, "shorten")) { fclose(f); return -1; }
    }
    fseek(f, 0, SEEK_END);
    data_len = ftell(f) - hdr;
    data_off = hdr;
  } else {
    fclose(f);
    return -1;
  }

  if (data_off < 0 || bytes_per != 2) { fclose(f); return -1; }
  const int64_t n_frames_total = data_len / (bytes_per * channels);
  if (sr_out) *sr_out = sr;
  if (!out) { fclose(f); return n_frames_total; }
  if (out_cap < n_frames_total) { fclose(f); return -1; }

  fseek(f, data_off, SEEK_SET);
  std::vector<int16_t> buf(size_t(n_frames_total) * channels);
  size_t got = fread(buf.data(), 2, buf.size(), f);
  fclose(f);
  if (got != buf.size()) return -1;

  for (int64_t i = 0; i < n_frames_total; ++i) {
    float acc = 0.f;
    for (int c = 0; c < channels; ++c) {
      int16_t v = buf[i * channels + c];
      if (big_endian) v = static_cast<int16_t>(((uint16_t)v >> 8) | ((uint16_t)v << 8));
      acc += static_cast<float>(v);
    }
    out[i] = acc / (32768.f * channels);
  }
  return n_frames_total;
}

}  // extern "C"
