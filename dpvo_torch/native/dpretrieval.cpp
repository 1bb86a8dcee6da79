// Native image-retrieval backend for classical loop closure.
//
// Equivalent of the reference's DPRetrieval pybind module
// (the reference DPRetrieval/src/main.cpp:39-151): bag-of-words database
// insert/query with a minimum index-distance guard. The caller computes
// each frame's ORB keypoints and descriptors (cv2.ORB_create(750, 1.09, 14)
// in retrieval_native.py, the detector dpvo_tpu's copy of this file runs in
// C++) and matches them (cv2.BFMatcher), so this file needs no OpenCV.
//
// Difference by design: the reference requires a pretrained DBoW2 ORB
// vocabulary file; this implementation is vocabulary-free — each 256-bit ORB
// descriptor is quantized into words by fixed bit-sampling into T hash
// tables, scored with tf-idf cosine similarity over an inverted index.
// Self-contained (no external vocabulary download), same API surface.
//
// Exposed as a plain C API for ctypes binding (no pybind11 in this image).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

namespace {

constexpr int kTables = 8;       // independent bit-sample hash tables
constexpr int kBitsPerWord = 12; // 4096 words per table

// fixed pseudo-random bit positions (deterministic across runs)
struct WordSampler {
  int bits[kTables][kBitsPerWord];
  WordSampler() {
    uint64_t state = 0x9E3779B97F4A7C15ull;
    auto next = [&state]() {
      state ^= state << 13;
      state ^= state >> 7;
      state ^= state << 17;
      return state;
    };
    for (int t = 0; t < kTables; t++)
      for (int b = 0; b < kBitsPerWord; b++)
        bits[t][b] = static_cast<int>(next() % 256);
  }
};

const WordSampler kSampler;

inline uint32_t descriptor_word(const uint8_t* d, int table) {
  uint32_t w = 0;
  for (int b = 0; b < kBitsPerWord; b++) {
    const int bit = kSampler.bits[table][b];
    w |= static_cast<uint32_t>((d[bit >> 3] >> (bit & 7)) & 1) << b;
  }
  return w | (static_cast<uint32_t>(table) << kBitsPerWord);
}

struct ImageEntry {
  int rows = 0;                           // descriptors (keypoints)
  std::unordered_map<uint32_t, float> bow;  // word -> tf weight
  float norm = 0.f;
};

}  // namespace

struct DPR {
  int rad;
  std::vector<ImageEntry> images;
  // inverted index: word -> list of (image, tf)
  std::unordered_map<uint32_t, std::vector<std::pair<int, float>>> inverted;
  std::unordered_map<uint32_t, int> doc_freq;

  explicit DPR(int rad_) : rad(rad_) {}

  // one frame's n ORB descriptors, n x 32 bytes (the caller keeps them
  // and the keypoints for matching)
  void insert(const uint8_t* descs, int n) {
    ImageEntry e;
    e.rows = n;

    std::unordered_map<uint32_t, int> counts;
    for (int r = 0; r < e.rows; r++) {
      const uint8_t* d = descs + 32 * static_cast<size_t>(r);
      for (int t = 0; t < kTables; t++) counts[descriptor_word(d, t)]++;
    }
    const float total = std::max<float>(1.f, e.rows * kTables);
    for (const auto& kv : counts) {
      const float tf = kv.second / total;
      e.bow[kv.first] = tf;
      doc_freq[kv.first]++;
    }
    const int idx = static_cast<int>(images.size());
    for (const auto& kv : e.bow)
      inverted[kv.first].emplace_back(idx, kv.second);
    images.push_back(std::move(e));
  }

  // tf-idf cosine score of image i against all db images with |i-j| >= rad
  void query(int i, float* best_score, int* best_j) const {
    *best_score = -1.f;
    *best_j = -1;
    if (i < 0 || i >= static_cast<int>(images.size())) return;
    const auto& q = images[i];
    const int n_docs = static_cast<int>(images.size());

    auto idf = [&](uint32_t word) {
      const auto it = doc_freq.find(word);
      const int df = it == doc_freq.end() ? 1 : it->second;
      return std::log(static_cast<float>(n_docs + 1) / (df + 1));
    };

    float qnorm = 0.f;
    for (const auto& kv : q.bow) {
      const float v = kv.second * idf(kv.first);
      qnorm += v * v;
    }
    qnorm = std::sqrt(std::max(qnorm, 1e-12f));

    std::unordered_map<int, float> scores;
    for (const auto& kv : q.bow) {
      const float widf = idf(kv.first);
      const auto it = inverted.find(kv.first);
      if (it == inverted.end()) continue;
      for (const auto& doc : it->second) {
        if (std::abs(doc.first - i) < rad) continue;
        scores[doc.first] += (kv.second * widf) * (doc.second * widf);
      }
    }

    for (const auto& kv : scores) {
      const auto& t = images[kv.first];
      float tnorm = 0.f;
      for (const auto& tb : t.bow) {
        const float v = tb.second * idf(tb.first);
        tnorm += v * v;
      }
      tnorm = std::sqrt(std::max(tnorm, 1e-12f));
      const float s = kv.second / (qnorm * tnorm);
      if (s > *best_score) {
        *best_score = s;
        *best_j = kv.first;
      }
    }
  }
};

extern "C" {

DPR* dpr_create(int rad) { return new DPR(rad); }
void dpr_destroy(DPR* p) { delete p; }
int dpr_size(DPR* p) { return static_cast<int>(p->images.size()); }

void dpr_insert_features(DPR* p, const uint8_t* descs, int n) {
  p->insert(descs, n);
}

void dpr_query(DPR* p, int i, float* score, int* j) { p->query(i, score, j); }

int dpr_num_keypoints(DPR* p, int i) {
  if (i < 0 || i >= static_cast<int>(p->images.size())) return 0;
  return p->images[i].rows;
}
}
