// Native wav IO for the data pipeline hot path.
//
// The reference's loader spends its time in Python wavfile.read calls inside
// DataLoader worker processes (`libri2mix.py:173-191`). This library gives
// the host a GIL-free path: a minimal RIFF/PCM parser plus a
// pthread-parallel batch reader that decodes int16/float32 wavs straight
// into a caller-provided float32 tensor (crop/zero-pad included), bound via
// ctypes (sudo_rm_rf_tpu_torch/native/__init__.py).
//
// Build: cc -O3 -shared -fPIC -pthread wavio.cpp -o libwavio.so

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <pthread.h>

namespace {

struct RiffInfo {
  uint16_t format = 0;      // 1 = PCM, 3 = IEEE float
  uint16_t channels = 0;
  uint32_t sample_rate = 0;
  uint16_t bits = 0;
  long data_offset = -1;    // byte offset of sample data
  long data_bytes = 0;
};

bool parse_header(FILE* f, RiffInfo* info) {
  char tag[4];
  uint32_t sz;
  if (fread(tag, 1, 4, f) != 4 || memcmp(tag, "RIFF", 4)) return false;
  if (fread(&sz, 4, 1, f) != 1) return false;
  if (fread(tag, 1, 4, f) != 4 || memcmp(tag, "WAVE", 4)) return false;
  // walk chunks
  while (fread(tag, 1, 4, f) == 4) {
    if (fread(&sz, 4, 1, f) != 1) return false;
    if (!memcmp(tag, "fmt ", 4)) {
      unsigned char buf[16];
      if (sz < 16 || fread(buf, 1, 16, f) != 16) return false;
      memcpy(&info->format, buf + 0, 2);
      memcpy(&info->channels, buf + 2, 2);
      memcpy(&info->sample_rate, buf + 4, 4);
      memcpy(&info->bits, buf + 14, 2);
      if (sz > 16) fseek(f, sz - 16, SEEK_CUR);
    } else if (!memcmp(tag, "data", 4)) {
      info->data_offset = ftell(f);
      info->data_bytes = sz;
      return info->format != 0;
    } else {
      fseek(f, sz + (sz & 1), SEEK_CUR);
    }
  }
  return false;
}

// Read one wav: decode `want` frames starting at frame `start` (zero-pad
// past EOF), average channels to mono, scale int16 by 1/32768.
// Returns: >=0 total frames in file, or a negative error code.
long read_one(const char* path, long start, long want, float* out) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  RiffInfo info;
  if (!parse_header(f, &info) || info.channels == 0) {
    fclose(f);
    return -2;
  }
  const int ch = info.channels;
  const int bytes_per = info.bits / 8;
  if (!(info.format == 1 && info.bits == 16) &&
      !(info.format == 3 && info.bits == 32)) {
    fclose(f);
    return -3;  // unsupported encoding
  }
  const long frame_bytes = (long)ch * bytes_per;
  const long total = info.data_bytes / frame_bytes;

  if (out && want > 0) {
    memset(out, 0, sizeof(float) * want);
    long lo = start < 0 ? 0 : start;
    long n = total - lo;
    if (n > want) n = want;
    if (n > 0) {
      fseek(f, info.data_offset + lo * frame_bytes, SEEK_SET);
      const long CHUNK = 1 << 16;
      char buf[1 << 16];
      long done = 0;
      while (done < n) {
        long todo = n - done;
        long max_frames = CHUNK / frame_bytes;
        if (todo > max_frames) todo = max_frames;
        long got = (long)fread(buf, frame_bytes, todo, f);
        if (got <= 0) break;
        if (info.format == 1) {
          const int16_t* p = (const int16_t*)buf;
          for (long i = 0; i < got; ++i) {
            float acc = 0.f;
            for (int c = 0; c < ch; ++c) acc += (float)p[i * ch + c];
            out[done + i] = acc / (32768.f * ch);
          }
        } else {
          const float* p = (const float*)buf;
          for (long i = 0; i < got; ++i) {
            float acc = 0.f;
            for (int c = 0; c < ch; ++c) acc += p[i * ch + c];
            out[done + i] = acc / ch;
          }
        }
        done += got;
      }
    }
  }
  fclose(f);
  return total;
}

struct Job {
  const char* const* paths;
  const long* starts;
  long want;
  float* out;           // (n, want) row-major
  long* totals;         // (n,)
  int n;
  int begin, step;
};

void* worker(void* arg) {
  Job* job = (Job*)arg;
  for (int i = job->begin; i < job->n; i += job->step) {
    job->totals[i] =
        read_one(job->paths[i], job->starts ? job->starts[i] : 0, job->want,
                 job->out + (long)i * job->want);
  }
  return nullptr;
}

}  // namespace

extern "C" {

// Header-only probe: frames/sr/channels without decoding.
long wav_info(const char* path, int* sample_rate, int* channels) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  RiffInfo info;
  bool ok = parse_header(f, &info);
  fclose(f);
  if (!ok) return -2;
  if (sample_rate) *sample_rate = (int)info.sample_rate;
  if (channels) *channels = (int)info.channels;
  return info.data_bytes / ((long)info.channels * (info.bits / 8));
}

long wav_read(const char* path, long start, long want, float* out) {
  return read_one(path, start, want, out);
}

// Parallel batch decode: n files into out (n, want) float32 mono rows.
// totals[i] receives the file's full frame count (or a negative error).
int wav_read_batch(const char* const* paths, const long* starts, int n,
                   long want, float* out, long* totals, int n_threads) {
  if (n_threads < 1) n_threads = 1;
  if (n_threads > n) n_threads = n;
  Job jobs[64];
  pthread_t tids[64];
  if (n_threads > 64) n_threads = 64;
  for (int t = 0; t < n_threads; ++t) {
    jobs[t] = Job{paths, starts, want, out, totals, n, t, n_threads};
    if (pthread_create(&tids[t], nullptr, worker, &jobs[t])) return -1;
  }
  for (int t = 0; t < n_threads; ++t) pthread_join(tids[t], nullptr);
  int bad = 0;
  for (int i = 0; i < n; ++i)
    if (totals[i] < 0) ++bad;
  return bad;
}

}  // extern "C"
