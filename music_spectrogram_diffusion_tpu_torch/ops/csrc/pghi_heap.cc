// PGHI heap integration (Prusa, Balazs, Sondergaard 2017) on the host.
//
// Host C++ with a plain C entry, built by g++ at first use and bound with
// ctypes (ops/_build.py build_host). The phase-gradient estimates (tgrad,
// fgrad, from the log-magnitude) are computed in numpy; this runs the
// sequential part: integrate the gradients outward from the largest-
// magnitude bins through a max-heap.
//
// The order of every step is the JAX package's C heap
// (native/msd_native.cc pghi_heap): the same binary heap, the same
// std::sort seed order (not stable: bins of equal magnitude are taken in
// the order libstdc++'s introsort leaves them), the same neighbour order
// and the same float arithmetic, so the two give the same phase bit for
// bit, ties included. The Python heap of ops/stft.py breaks ties in
// another order.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

class MaxHeap {
 public:
  MaxHeap(const float* key, size_t cap) : key_(key) { items_.reserve(cap); }
  bool empty() const { return items_.empty(); }
  void push(int64_t idx) {
    items_.push_back(idx);
    size_t i = items_.size() - 1;
    while (i > 0) {
      size_t parent = (i - 1) / 2;
      if (key_[items_[parent]] >= key_[items_[i]]) break;
      std::swap(items_[parent], items_[i]);
      i = parent;
    }
  }
  int64_t pop() {
    int64_t top = items_[0];
    items_[0] = items_.back();
    items_.pop_back();
    size_t i = 0, n = items_.size();
    while (true) {
      size_t l = 2 * i + 1, r = l + 1, best = i;
      if (l < n && key_[items_[l]] > key_[items_[best]]) best = l;
      if (r < n && key_[items_[r]] > key_[items_[best]]) best = r;
      if (best == i) break;
      std::swap(items_[best], items_[i]);
      i = best;
    }
    return top;
  }

 private:
  const float* key_;
  std::vector<int64_t> items_;
};

}  // namespace

// S, tgrad, fgrad: float32 [n, nb], C order. phase: float32 [n, nb], out.
// Bins with S <= tol * max(S) keep phase 0. Returns 0.
extern "C" int msd_pghi_heap(const float* S, const float* tgrad,
                             const float* fgrad, int64_t n, int64_t nb,
                             double tol, float* phase) {
  const int64_t total = n * nb;
  std::memset(phase, 0, total * sizeof(float));

  float maxval = 0.0f;
  for (int64_t i = 0; i < total; ++i) maxval = std::max(maxval, S[i]);
  const float thresh = static_cast<float>(tol) * maxval;

  std::vector<uint8_t> done(total);
  int64_t remaining = 0;
  for (int64_t i = 0; i < total; ++i) {
    done[i] = S[i] <= thresh;  // insignificant bins keep phase 0
    remaining += !done[i];
  }
  // Seeds for disconnected regions: walk bins in magnitude order.
  std::vector<int64_t> order(total);
  for (int64_t i = 0; i < total; ++i) order[i] = i;
  std::sort(order.begin(), order.end(),
            [&](int64_t a, int64_t b) { return S[a] > S[b]; });
  size_t seed_pos = 0;

  MaxHeap heap(S, 4096);
  while (remaining > 0) {
    while (seed_pos < order.size() && done[order[seed_pos]]) ++seed_pos;
    if (seed_pos >= order.size()) break;
    const int64_t seed = order[seed_pos];
    phase[seed] = 0.0f;
    done[seed] = 1;
    --remaining;
    heap.push(seed);
    while (!heap.empty()) {
      const int64_t idx = heap.pop();
      const int64_t i = idx / nb, j = idx % nb;
      // Trapezoidal integration to each neighbour not yet done.
      if (i + 1 < n && !done[idx + nb]) {
        phase[idx + nb] = phase[idx] + 0.5f * (tgrad[idx] + tgrad[idx + nb]);
        done[idx + nb] = 1;
        --remaining;
        heap.push(idx + nb);
      }
      if (i > 0 && !done[idx - nb]) {
        phase[idx - nb] = phase[idx] - 0.5f * (tgrad[idx] + tgrad[idx - nb]);
        done[idx - nb] = 1;
        --remaining;
        heap.push(idx - nb);
      }
      if (j + 1 < nb && !done[idx + 1]) {
        phase[idx + 1] = phase[idx] + 0.5f * (fgrad[idx] + fgrad[idx + 1]);
        done[idx + 1] = 1;
        --remaining;
        heap.push(idx + 1);
      }
      if (j > 0 && !done[idx - 1]) {
        phase[idx - 1] = phase[idx] - 0.5f * (fgrad[idx] + fgrad[idx - 1]);
        done[idx - 1] = 1;
        --remaining;
        heap.push(idx - 1);
      }
    }
  }
  return 0;
}
