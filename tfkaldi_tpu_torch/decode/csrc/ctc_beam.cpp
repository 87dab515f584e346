// CTC prefix beam search over frame log-posteriors.
//
// The port's copy of native/ctc_beam.cpp. Host-side decoder consuming the
// [T, V] log-probs the device emits per utterance
// (tfkaldi_tpu_torch/decode/ctc.py). Prefixes are stored in a shared trie
// so beam entries are O(1) to extend; per frame the vocabulary is pruned to
// the top candidates before expansion. Semantics match the pure-Python
// implementation tfkaldi_tpu_torch/decode/ctc_beam.py.
//
// C ABI (ctypes):
//   ctc_beam_search(log_probs, t_len, v, blank_id, beam_width, out, max_out)
//     -> decoded length (>= 0), or -1 on error / out overflow.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <limits>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

constexpr double kNegInf = -std::numeric_limits<double>::infinity();

inline double logsumexp2(double a, double b) {
  if (a == kNegInf) return b;
  if (b == kNegInf) return a;
  const double m = a > b ? a : b;
  return m + std::log1p(std::exp(-std::fabs(a - b)));
}

struct TrieNode {
  int32_t parent;  // -1 for the root (empty prefix)
  int32_t label;   // label appended at this node
};

struct Mass {
  double p_b = kNegInf;   // prefix prob mass ending in blank
  double p_nb = kNegInf;  // ...ending in its last non-blank label
  double total() const { return logsumexp2(p_b, p_nb); }
};

}  // namespace

extern "C" int ctc_beam_search(const float* log_probs, int32_t t_len,
                               int32_t v, int32_t blank_id,
                               int32_t beam_width, int32_t* out,
                               int32_t max_out) {
  if (t_len < 0 || v <= 0 || blank_id < 0 || blank_id >= v || beam_width <= 0)
    return -1;

  std::vector<TrieNode> trie;            // shared prefix storage
  trie.push_back({-1, -1});              // node 0 = empty prefix
  // child lookup: key = node * v + label
  std::unordered_map<int64_t, int32_t> children;

  std::unordered_map<int32_t, Mass> beams;  // node -> mass
  beams[0] = Mass{0.0, kNegInf};

  const int32_t n_cand = std::min<int32_t>(v, std::max<int32_t>(beam_width, 8));
  std::vector<int32_t> cand(v);

  auto child = [&](int32_t node, int32_t label) -> int32_t {
    const int64_t key = static_cast<int64_t>(node) * v + label;
    auto it = children.find(key);
    if (it != children.end()) return it->second;
    const int32_t id = static_cast<int32_t>(trie.size());
    trie.push_back({node, label});
    children.emplace(key, id);
    return id;
  };

  std::unordered_map<int32_t, Mass> next;
  std::vector<std::pair<int32_t, double>> ranked;
  for (int32_t t = 0; t < t_len; ++t) {
    const float* frame = log_probs + static_cast<int64_t>(t) * v;

    for (int32_t i = 0; i < v; ++i) cand[i] = i;
    std::partial_sort(cand.begin(), cand.begin() + n_cand, cand.end(),
                      [&](int32_t a, int32_t b) { return frame[a] > frame[b]; });

    next.clear();
    for (const auto& [node, mass] : beams) {
      const double p_tot = mass.total();
      const int32_t last = trie[node].label;  // -1 at root
      for (int32_t ci = 0; ci < n_cand; ++ci) {
        const int32_t s = cand[ci];
        const double p = frame[s];
        if (s == blank_id) {
          Mass& m = next[node];
          m.p_b = logsumexp2(m.p_b, p_tot + p);
        } else if (s == last) {
          // repeat extends the SAME prefix from non-blank mass...
          Mass& m = next[node];
          m.p_nb = logsumexp2(m.p_nb, mass.p_nb + p);
          // ...and the longer prefix only from blank-ended mass
          Mass& m2 = next[child(node, s)];
          m2.p_nb = logsumexp2(m2.p_nb, mass.p_b + p);
        } else {
          Mass& m = next[child(node, s)];
          m.p_nb = logsumexp2(m.p_nb, p_tot + p);
        }
      }
    }

    ranked.clear();
    ranked.reserve(next.size());
    for (const auto& [node, mass] : next) ranked.emplace_back(node, mass.total());
    const size_t keep = std::min<size_t>(beam_width, ranked.size());
    std::partial_sort(
        ranked.begin(), ranked.begin() + keep, ranked.end(),
        [](const auto& a, const auto& b) { return a.second > b.second; });

    beams.clear();
    for (size_t i = 0; i < keep; ++i) beams[ranked[i].first] = next[ranked[i].first];
  }

  int32_t best = 0;
  double best_p = kNegInf;
  for (const auto& [node, mass] : beams) {
    const double p = mass.total();
    if (p > best_p) {
      best_p = p;
      best = node;
    }
  }

  // walk the trie back to the root
  std::vector<int32_t> rev;
  for (int32_t n = best; n != 0; n = trie[n].parent) rev.push_back(trie[n].label);
  if (static_cast<int32_t>(rev.size()) > max_out) return -1;
  for (size_t i = 0; i < rev.size(); ++i) out[i] = rev[rev.size() - 1 - i];
  return static_cast<int32_t>(rev.size());
}

// Batched convenience: decodes `n` utterances laid out as one padded
// [n, t_max, v] block with per-utterance lengths, fanned out over hardware
// threads (utterances are independent). out is [n, max_out];
// out_lens[i] < 0 signals a per-utterance failure.
extern "C" int ctc_beam_search_batch(const float* log_probs, int32_t n,
                                     int32_t t_max, int32_t v,
                                     const int32_t* lengths, int32_t blank_id,
                                     int32_t beam_width, int32_t* out,
                                     int32_t max_out, int32_t* out_lens) {
  auto decode_range = [&](int32_t lo, int32_t hi) {
    for (int32_t i = lo; i < hi; ++i) {
      const float* lp = log_probs + static_cast<int64_t>(i) * t_max * v;
      const int32_t t_len = std::min(lengths[i], t_max);
      out_lens[i] = ctc_beam_search(lp, t_len, v, blank_id, beam_width,
                                    out + static_cast<int64_t>(i) * max_out,
                                    max_out);
    }
  };
  const int32_t hw = static_cast<int32_t>(std::thread::hardware_concurrency());
  const int32_t workers = std::max<int32_t>(1, std::min(n, hw > 0 ? hw : 4));
  if (workers == 1) {
    decode_range(0, n);
    return 0;
  }
  std::vector<std::thread> pool;
  const int32_t chunk = (n + workers - 1) / workers;
  for (int32_t w = 0; w < workers; ++w) {
    const int32_t lo = w * chunk;
    if (lo >= n) break;
    pool.emplace_back(decode_range, lo, std::min(n, lo + chunk));
  }
  for (auto& t : pool) t.join();
  return 0;
}
