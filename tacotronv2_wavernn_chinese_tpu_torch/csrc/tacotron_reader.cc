// Row reader of the Tacotron loader's read-ahead (data/loader.py).
//
// One call reads the mel headers of a batch's rows, a second fills the
// batch's arrays from the files: each row's mel read straight into its slot,
// its pad frames, stop targets, symbol ids and lengths, rows spread over a
// few threads.  The caller (a Python worker thread, through ctypes) holds no
// interpreter lock during either call, so the thread that launches the
// device's work is not held up by the batch's file reads and copies.
//
// C API (ctypes-friendly):
//   tr_probe(n, paths, T, M, offset, err, threads)
//     T, M: the array's shape; offset: where its data starts, or -1 when the
//     file is not a C-order 2-D little-endian float32 .npy (the caller loads
//     such a file itself); err: errno of a failed open or read, else 0.
//   tr_fill(n, paths, offset, T, loaded, M, max_out, pad, ref_out, ids,
//           ids_start, ids_len, max_in, mels, stops, inputs, input_lengths,
//           target_lengths, loss_frames, err, threads)
//     loaded[k]: the row's mel in memory (offset -1), else null; err: errno
//     of a failed open or read, -1 for a file shorter than its header says.

#include <errno.h>
#include <fcntl.h>
#include <pthread.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>
#include <unistd.h>

// Plain C headers only: the library is compiled at first use, and the
// standard C++ headers would multiply its compile time.

namespace {

// pread until n bytes are read: 0, errno, or -1 at the end of the file.
int read_at(int fd, void* dst, size_t n, off_t off) {
  char* p = static_cast<char*>(dst);
  while (n > 0) {
    ssize_t got = pread(fd, p, n, off);
    if (got < 0) {
      if (errno == EINTR) continue;
      return errno;
    }
    if (got == 0) return -1;
    p += got;
    off += got;
    n -= static_cast<size_t>(got);
  }
  return 0;
}

// The value after 'key': in a .npy header dict, or null.
const char* value_at(const char* h, const char* key) {
  const char* at = strstr(h, key);
  if (at == nullptr) return nullptr;
  at = strchr(at + strlen(key), ':');
  if (at == nullptr) return nullptr;
  for (++at; *at == ' ';) ++at;
  return at;
}

// Shape and data offset of a C-order 2-D '<f4' array; false otherwise,
// with *err the errno of a failed read.
bool parse_header(int fd, int64_t* T, int64_t* M, int64_t* offset, int* err) {
  unsigned char pre[12];
  int e = read_at(fd, pre, sizeof pre, 0);
  if (e != 0) {
    *err = e > 0 ? e : 0;
    return false;
  }
  if (memcmp(pre, "\x93NUMPY", 6) != 0) return false;
  size_t len, start;
  if (pre[6] == 1) {
    len = pre[8] | (pre[9] << 8);
    start = 10;
  } else if (pre[6] == 2 || pre[6] == 3) {
    len = pre[8] | (pre[9] << 8) | (pre[10] << 16) | (static_cast<size_t>(pre[11]) << 24);
    start = 12;
  } else {
    return false;
  }
  char* h = static_cast<char*>(malloc(len + 1));
  if (h == nullptr) {
    *err = ENOMEM;
    return false;
  }
  e = read_at(fd, h, len, static_cast<off_t>(start));
  h[e == 0 ? len : 0] = 0;
  *err = e > 0 ? e : 0;
  const char *d = value_at(h, "'descr'"), *f = value_at(h, "'fortran_order'"), *s = value_at(h, "'shape'");
  bool ok = d && f && s && strncmp(d, "'<f4'", 5) == 0 && strncmp(f, "False", 5) == 0 && *s == '(';
  int64_t dims[3];
  int nd = 0;
  const char* p = ok ? s + 1 : "";
  while (ok && nd < 3) {
    while (*p == ' ') ++p;
    if (*p == ')') break;
    char* end;
    long long v = strtoll(p, &end, 10);
    if (end == p || v < 0) ok = false;
    dims[nd++] = v;
    for (p = end; *p == ' ';) ++p;
    if (*p == ',') ++p;
  }
  ok = ok && nd == 2 && *p == ')';
  free(h);
  if (!ok) return false;
  *T = dims[0];
  *M = dims[1];
  *offset = static_cast<int64_t>(start + len);
  return true;
}

// fn(k) for k in [0, n) on up to `threads` threads.
template <class F>
struct Rows {
  F* fn;
  int n;
  int next;
  static void* work(void* arg) {
    Rows* r = static_cast<Rows*>(arg);
    for (int k; (k = __atomic_fetch_add(&r->next, 1, __ATOMIC_RELAXED)) < r->n;) (*r->fn)(k);
    return nullptr;
  }
};

template <class F>
void each_row(int n, int threads, F fn) {
  Rows<F> rows{&fn, n, 0};
  int t = threads < n ? threads : n;
  pthread_t pool[64];
  int started = 0;
  for (int i = 1; i < t && i < 64; ++i)
    if (pthread_create(&pool[started], nullptr, Rows<F>::work, &rows) == 0) ++started;
  Rows<F>::work(&rows);
  for (int i = 0; i < started; ++i) pthread_join(pool[i], nullptr);
}

void fill_floats(float* p, int64_t n, float v) {
  for (int64_t i = 0; i < n; ++i) p[i] = v;
}

}  // namespace

extern "C" {

void tr_probe(int n, const char* const* paths, int64_t* T, int64_t* M, int64_t* offset, int32_t* err,
              int threads) {
  each_row(n, threads, [&](int k) {
    T[k] = M[k] = 0;
    offset[k] = -1;
    err[k] = 0;
    int fd = open(paths[k], O_RDONLY | O_CLOEXEC);
    if (fd < 0) {
      err[k] = errno;
      return;
    }
    int e = 0;
    if (!parse_header(fd, &T[k], &M[k], &offset[k], &e)) offset[k] = -1;
    err[k] = e;
    close(fd);
  });
}

void tr_fill(int n, const char* const* paths, const int64_t* offset, const int64_t* T, const float* const* loaded,
             int64_t M, int64_t max_out, float pad, int32_t ref_out, const int32_t* ids, const int64_t* ids_start,
             const int64_t* ids_len, int64_t max_in, float* mels, float* stops, int32_t* inputs,
             int32_t* input_lengths, int32_t* target_lengths, int32_t* loss_frames, int32_t* err, int threads) {
  each_row(n, threads, [&](int k) {
    err[k] = 0;
    const int64_t t = T[k];
    float* mel = mels + static_cast<size_t>(k) * max_out * M;
    if (loaded[k] != nullptr) {
      memcpy(mel, loaded[k], sizeof(float) * t * M);
    } else {
      int fd = open(paths[k], O_RDONLY | O_CLOEXEC);
      if (fd < 0) {
        err[k] = errno;
        return;
      }
      err[k] = read_at(fd, mel, sizeof(float) * t * M, static_cast<off_t>(offset[k]));
      close(fd);
      if (err[k] != 0) return;
    }
    fill_floats(mel + t * M, (max_out - t) * M, pad);
    // stops[k, :t-1] = 0 over a row of ones, with Python's slice rules
    int64_t zero_to = t - 1 >= 0 ? t - 1 : (max_out + t - 1 > 0 ? max_out + t - 1 : 0);
    if (zero_to > max_out) zero_to = max_out;
    float* stop = stops + static_cast<size_t>(k) * max_out;
    fill_floats(stop, zero_to, 0.0f);
    fill_floats(stop + zero_to, max_out - zero_to, 1.0f);
    int32_t* in = inputs + static_cast<size_t>(k) * max_in;
    memcpy(in, ids + ids_start[k], sizeof(int32_t) * ids_len[k]);
    memset(in + ids_len[k], 0, sizeof(int32_t) * (max_in - ids_len[k]));
    input_lengths[k] = static_cast<int32_t>(ids_len[k]);
    target_lengths[k] = static_cast<int32_t>(t);
    loss_frames[k] = ref_out;
  });
}

}  // extern "C"
