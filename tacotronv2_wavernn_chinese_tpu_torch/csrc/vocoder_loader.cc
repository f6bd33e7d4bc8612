// Threaded window sampler of the vocoder trainers (data/native_loader.py).
//
// A worker pool samples random training windows from caller-owned buffers
// and keeps a ring of prefetched batches ready, so the device loop never
// waits on the Python interpreter lock for them.  Two kinds of corpus ride
// in the same buffers:
//   * WaveRNN: mu-law labels and GTA mels; a window is a mel crop, the
//     matching label slice as floats (label_2_float) and the next-sample
//     targets (reference collate_vocoder, dataset.py:107-133);
//   * HiFi-GAN: 16-bit PCM in the label buffer and no mels (n_mels 0, hop
//     1, pad 0): a window is a segment at a random sample offset, as
//     floats times the utterance's gain (meldataset.py's peak
//     normalisation), its mel computed on the device afterwards.
//
// C API (ctypes-friendly, no pybind11):
//   vl_create(...)   -> opaque handle; spawns workers, starts prefetching
//   vl_next_batch    -> blocking copy of the next (x, y, mels) batch
//   vl_destroy       -> join workers, free everything
//
// Data model: the caller passes flat arrays owning all utterance data
//   labels:     int16 concatenated label streams, offsets[i] .. offsets[i]+n
//   mels:       float concatenated mel frames [sum_frames, n_mels]
//   gains:      float per utterance, or null (WaveRNN's label_2_float)
// so the loader itself allocates nothing per-sample except the ring slots.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <random>
#include <thread>
#include <vector>

namespace {

struct Utt {
  float gain;          // x = sample * gain, when the caller gave gains
  int64_t label_off;   // into labels[]
  int64_t label_len;   // samples
  int64_t mel_off;     // frame index into mels[]
  int64_t mel_frames;  // frames
};

struct Batch {
  std::vector<float> x;      // [B, seq_len]
  std::vector<int32_t> y;    // [B, seq_len]
  std::vector<float> mels;   // [B, mel_win, n_mels]
  bool full = false;
};

struct Loader {
  // immutable corpus views (caller-owned memory)
  const int16_t* labels;
  const float* mels;
  bool pcm = false;    // gains given: x = sample * gain, else label_2_float
  std::vector<Utt> utts;
  int n_mels, pad, seq_hops, hop, batch, bits;
  int mel_win;   // seq_hops + 2*pad
  int seq_len;   // seq_hops * hop

  // prefetch ring
  std::vector<Batch> ring;
  size_t head = 0, tail = 0, count = 0;
  std::mutex mu;
  std::condition_variable cv_full, cv_empty;
  std::atomic<bool> stop{false};
  std::vector<std::thread> workers;
  std::atomic<uint64_t> seq{0};
  uint64_t seed;

  // Shuffled epoch permutation shared by all workers: every utterance is
  // visited exactly once per epoch (matching the Python VocoderDataset and
  // the reference torch DataLoader's shuffle=True), instead of sampling
  // with replacement which leaves ~1/e of the corpus unseen per epoch.
  std::vector<uint32_t> order;
  size_t cursor = 0;
  uint64_t epoch = 0;
  std::mutex order_mu;

  uint32_t next_utt_index() {
    std::lock_guard<std::mutex> lk(order_mu);
    if (cursor >= order.size()) {
      std::mt19937_64 erng(seed ^ (0xd1b54a32d192ed03ULL * (epoch + 1)));
      std::shuffle(order.begin(), order.end(), erng);
      cursor = 0;
      ++epoch;
    }
    return order[cursor++];
  }

  void worker(int wid) {
    std::mt19937_64 rng(seed + 0x9e3779b97f4a7c15ULL * (wid + 1));
    const float inv = 2.0f / ((1 << bits) - 1);
    std::vector<float> x(batch * seq_len);
    std::vector<int32_t> y(batch * seq_len);
    std::vector<float> m(batch * mel_win * n_mels);
    while (!stop.load(std::memory_order_relaxed)) {
      for (int b = 0; b < batch; ++b) {
        const Utt& u = utts[next_utt_index()];
        // random window start (mel frame), >= pad frames in; bounded by BOTH
        // the mel length and the label stream (s[t+1] below reads up to
        // start*hop + seq_len, which must stay inside this utterance's
        // label slice even when labels are shorter than the mel implies)
        int64_t max_start = u.mel_frames - mel_win;
        int64_t lab_max = (u.label_len - 1 - seq_len) / hop;
        if (lab_max < max_start) max_start = lab_max;
        int64_t start = pad + (max_start > pad ? (int64_t)(rng() % (max_start - pad + 1)) : 0);
        const float* msrc = mels + (u.mel_off + start - pad) * n_mels;
        std::memcpy(&m[(size_t)b * mel_win * n_mels], msrc,
                    sizeof(float) * mel_win * n_mels);
        int64_t sig_start = u.label_off + start * hop;  // pad*hop offset folded in
        const int16_t* s = labels + sig_start;
        float* xb = &x[(size_t)b * seq_len];
        int32_t* yb = &y[(size_t)b * seq_len];
        if (pcm) {
          for (int t = 0; t < seq_len; ++t) {
            xb[t] = s[t] * u.gain;
            yb[t] = (int32_t)s[t + 1];
          }
        } else {
          for (int t = 0; t < seq_len; ++t) {
            xb[t] = s[t] * inv - 1.0f;       // label_2_float (dsp.py:8-9)
            yb[t] = (int32_t)s[t + 1];       // next-sample target
          }
        }
      }
      std::unique_lock<std::mutex> lk(mu);
      cv_full.wait(lk, [&] { return count < ring.size() || stop; });
      if (stop) return;
      Batch& slot = ring[tail];
      slot.x.swap(x); slot.y.swap(y); slot.mels.swap(m); slot.full = true;
      x.resize((size_t)batch * seq_len);
      y.resize((size_t)batch * seq_len);
      m.resize((size_t)batch * mel_win * n_mels);
      tail = (tail + 1) % ring.size();
      ++count;
      cv_empty.notify_one();
    }
  }
};

}  // namespace

extern "C" {

void* vl_create(const int16_t* labels, const float* mels,
                const int64_t* label_offs, const int64_t* label_lens,
                const int64_t* mel_offs, const int64_t* mel_frames,
                int n_utts, int n_mels, int pad, int seq_hops, int hop,
                int batch, int bits, int n_workers, int ring_size,
                uint64_t seed, const float* gains) {
  auto* L = new Loader();
  L->labels = labels;
  L->mels = mels;
  L->pcm = gains != nullptr;
  L->n_mels = n_mels; L->pad = pad; L->seq_hops = seq_hops; L->hop = hop;
  L->batch = batch; L->bits = bits;
  L->mel_win = seq_hops + 2 * pad;
  L->seq_len = seq_hops * hop;
  L->seed = seed;
  int64_t min_frames = L->mel_win + 2;
  for (int i = 0; i < n_utts; ++i) {
    // filter utterances too short for one window (reference dataset.py:76-79)
    if (mel_frames[i] >= min_frames &&
        label_lens[i] > (int64_t)(L->mel_win) * hop + 1) {
      L->utts.push_back({gains ? gains[i] : 1.0f, label_offs[i], label_lens[i], mel_offs[i], mel_frames[i]});
    }
  }
  if (L->utts.empty()) { delete L; return nullptr; }
  L->order.resize(L->utts.size());
  for (size_t i = 0; i < L->order.size(); ++i) L->order[i] = (uint32_t)i;
  L->cursor = L->order.size();  // forces the first epoch shuffle on first pop
  L->ring.resize(ring_size > 0 ? ring_size : 8);
  int nw = n_workers > 0 ? n_workers : 2;
  for (int w = 0; w < nw; ++w)
    L->workers.emplace_back(&Loader::worker, L, w);
  return L;
}

int vl_num_utts(void* h) { return (int)((Loader*)h)->utts.size(); }

// Blocking: copies the next prefetched batch into caller buffers.
// Returns 1 on success, 0 if the loader was destroyed while waiting (the
// wait predicate must observe `stop`, else a consumer blocked here during
// vl_destroy re-sleeps on a condvar that is about to be deleted).
int vl_next_batch(void* h, float* x, int32_t* y, float* mels) {
  auto* L = (Loader*)h;
  std::unique_lock<std::mutex> lk(L->mu);
  L->cv_empty.wait(lk, [&] { return L->count > 0 || L->stop; });
  if (L->count == 0) return 0;  // stopping and nothing buffered
  Batch& slot = L->ring[L->head];
  std::memcpy(x, slot.x.data(), slot.x.size() * sizeof(float));
  std::memcpy(y, slot.y.data(), slot.y.size() * sizeof(int32_t));
  std::memcpy(mels, slot.mels.data(), slot.mels.size() * sizeof(float));
  slot.full = false;
  L->head = (L->head + 1) % L->ring.size();
  --L->count;
  L->cv_full.notify_one();
  return 1;
}

// Wake workers and any blocked consumers without freeing (consumers return
// 0 from vl_next_batch once the ring drains). Callers that may have another
// thread inside vl_next_batch must call this, wait for that thread to leave,
// and only then vl_destroy — destroying while a consumer is blocked would
// delete the mutex/condvar it sleeps on.
void vl_request_stop(void* h) {
  auto* L = (Loader*)h;
  {
    std::lock_guard<std::mutex> lk(L->mu);
    L->stop = true;
  }
  L->cv_full.notify_all();
  L->cv_empty.notify_all();
}

void vl_destroy(void* h) {
  auto* L = (Loader*)h;
  vl_request_stop(h);
  for (auto& t : L->workers) t.join();
  delete L;
}

// ---- standalone DSP helpers (reference scipy.signal.lfilter hot paths) ----

// preemphasis y[t] = x[t] - k*x[t-1]  (audio.py:60-63)
void vl_preemphasis(const float* x, float* y, int64_t n, float k) {
  float prev = 0.0f;
  for (int64_t i = 0; i < n; ++i) { y[i] = x[i] - k * prev; prev = x[i]; }
}

// inverse preemphasis y[t] = x[t] + k*y[t-1]  (audio.py:66-69)
void vl_inv_preemphasis(const float* x, float* y, int64_t n, float k) {
  float prev = 0.0f;
  for (int64_t i = 0; i < n; ++i) { prev = x[i] + k * prev; y[i] = prev; }
}

// mu-law encode to labels in [0, mu)  — ``mu`` is the CLASS COUNT (e.g.
// 1024 for 10-bit), matching Python dsp.mulaw.encode_mu_law which uses
// m = mu - 1 internally.
void vl_mulaw_encode(const float* x, int16_t* out, int64_t n, int mu) {
  const int m = mu - 1;
  const float lm = std::log1p((float)m);
  for (int64_t i = 0; i < n; ++i) {
    float v = x[i];
    float fx = (v < 0 ? -1.0f : 1.0f) * std::log1p(m * std::abs(v)) / lm;
    int q = (int)((fx + 1.0f) / 2.0f * m + 0.5f);
    out[i] = (int16_t)(q < 0 ? 0 : (q > m ? m : q));
  }
}

}  // extern "C"
