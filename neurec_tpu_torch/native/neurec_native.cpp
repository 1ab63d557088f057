// neurec_tpu_torch native host tier: thread-pooled ranking evaluation,
// exclusion rejection sampling, and row-parallel arg-topk.
//
// The port's own copy of neurec_tpu/native/neurec_native.cpp, with its fixes:
// the NaN-last, lowest-index-first comparator (eval_one_user, arg_topk) and
// the empty-catalogue pad guard. Capability parity with the reference's
// native components (evaluator/backend/cpp/include/{metric.h,evaluate.h},
// util/cython/{random_choice.pyx,include/arg_topk.h},
// util/cython/include/thread_pool.h), with a plain C ABI so Python binds via
// ctypes (neurec_tpu_torch/native/__init__.py).
//
// The port's primary evaluation path runs on the card
// (neurec_tpu_torch/eval/evaluator.py); this tier is the host backend
// (eval_backend=native) and a differential-testing oracle.
//
// Build: g++ -O3 -std=c++17 -fPIC -pthread -shared, at first use, into
// build/neurec_tpu_torch/ (native/__init__.py::build).

#include <algorithm>
#include <atomic>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <functional>
#include <mutex>
#include <queue>
#include <random>
#include <thread>
#include <unordered_set>
#include <vector>

namespace {

// ---------------------------------------------------------------- thread pool
class ThreadPool {
 public:
  explicit ThreadPool(int n_threads) : stop_(false), pending_(0) {
    if (n_threads < 1) n_threads = 1;
    workers_.reserve(n_threads);
    for (int t = 0; t < n_threads; ++t) {
      workers_.emplace_back([this] {
        for (;;) {
          std::function<void()> job;
          {
            std::unique_lock<std::mutex> lk(mu_);
            cv_.wait(lk, [this] { return stop_ || !jobs_.empty(); });
            if (stop_ && jobs_.empty()) return;
            job = std::move(jobs_.front());
            jobs_.pop();
          }
          job();
          if (pending_.fetch_sub(1) == 1) {
            std::lock_guard<std::mutex> lk(done_mu_);
            done_cv_.notify_all();
          }
        }
      });
    }
  }

  ~ThreadPool() {
    {
      std::lock_guard<std::mutex> lk(mu_);
      stop_ = true;
    }
    cv_.notify_all();
    for (auto& w : workers_) w.join();
  }

  void submit(std::function<void()> job) {
    pending_.fetch_add(1);
    {
      std::lock_guard<std::mutex> lk(mu_);
      jobs_.push(std::move(job));
    }
    cv_.notify_one();
  }

  void wait_all() {
    std::unique_lock<std::mutex> lk(done_mu_);
    done_cv_.wait(lk, [this] { return pending_.load() == 0; });
  }

 private:
  std::vector<std::thread> workers_;
  std::queue<std::function<void()>> jobs_;
  std::mutex mu_, done_mu_;
  std::condition_variable cv_, done_cv_;
  bool stop_;
  std::atomic<int> pending_;
};

// ------------------------------------------------------------- metric kernels
// Metric codes match the reference's dispatch table (metric.h:112-117):
// 1 Precision, 2 Recall, 3 MAP, 4 NDCG, 5 MRR. Each writes a length-K
// cumulative vector for one user's ranked list vs. truth set.
void metric_vector(int code, const std::vector<int>& rank,
                   const std::unordered_set<int>& truth, float* out) {
  const size_t K = rank.size();
  const float truth_len = static_cast<float>(truth.size());
  switch (code) {
    case 1: {  // Precision@r = hits_r / r
      int hits = 0;
      for (size_t i = 0; i < K; ++i) {
        if (truth.count(rank[i])) ++hits;
        out[i] = static_cast<float>(hits) / static_cast<float>(i + 1);
      }
      break;
    }
    case 2: {  // Recall@r = hits_r / |truth|
      int hits = 0;
      for (size_t i = 0; i < K; ++i) {
        if (truth.count(rank[i])) ++hits;
        out[i] = static_cast<float>(hits) / truth_len;
      }
      break;
    }
    case 3: {  // MAP@r with the reference's min(r, |truth|) denominator
      int hits = 0;
      float sum_pre = 0.f;
      for (size_t i = 0; i < K; ++i) {
        if (truth.count(rank[i])) {
          ++hits;
          sum_pre += static_cast<float>(hits) / static_cast<float>(i + 1);
        }
        const float denom = std::min(truth_len, static_cast<float>(i + 1));
        out[i] = hits == 0 ? 0.f : sum_pre / denom;
      }
      break;
    }
    case 4: {  // NDCG@r, iDCG accumulated over the first |truth| ranks
      float dcg = 0.f, idcg = 0.f;
      for (size_t i = 0; i < K; ++i) {
        const float gain = 1.f / std::log2(static_cast<float>(i + 2));
        if (truth.count(rank[i])) dcg += gain;
        if (static_cast<float>(i) < truth_len) idcg += gain;
        out[i] = dcg / idcg;
      }
      break;
    }
    case 5: {  // MRR@r = 1/(first-hit rank), 0 before the first hit
      for (size_t i = 0; i < K; ++i) {
        if (truth.count(rank[i])) {
          const float rr = 1.f / static_cast<float>(i + 1);
          for (size_t j = i; j < K; ++j) out[j] = rr;
          return;
        }
        out[i] = 0.f;
      }
      break;
    }
    default:
      for (size_t i = 0; i < K; ++i) out[i] = 0.f;
  }
}

void eval_one_user(const float* scores, int num_items,
                   const int* truth, int truth_len,
                   const int* metrics, int n_metrics, int top_k,
                   float* out) {
  // rank the top-k item indices by score, ties by lower index
  std::vector<int> idx(num_items);
  for (int i = 0; i < num_items; ++i) idx[i] = i;
  const int k = std::min(top_k, num_items);
  // NaN-aware: a plain `!=` comparator makes NaN "equivalent" to every
  // value while real values still order — a strict-weak-ordering
  // violation (UB in partial_sort). Rank NaN last, ties by lower index.
  std::partial_sort(idx.begin(), idx.begin() + k, idx.end(),
                    [scores](int a, int b) {
                      const float sa = scores[a], sb = scores[b];
                      const bool na = std::isnan(sa), nb = std::isnan(sb);
                      if (na != nb) return nb;
                      if (!na && sa != sb) return sa > sb;
                      return a < b;
                    });
  idx.resize(k);
  std::unordered_set<int> truth_set(truth, truth + truth_len);
  for (int m = 0; m < n_metrics; ++m) {
    metric_vector(metrics[m], idx, truth_set, out + m * top_k);
    // pad (top_k > num_items) positions keep the last value (0 when the
    // catalog is empty and no value was written at all)
    const float last = k > 0 ? out[m * top_k + k - 1] : 0.f;
    for (int r = k; r < top_k; ++r) out[m * top_k + r] = last;
  }
}

}  // namespace

extern "C" {

// scores: (B, num_items) row-major; truth via CSR-style flat+offsets arrays;
// out: (B, n_metrics * top_k).
void eval_score_matrix(const float* scores, int batch, int num_items,
                       const int* truth_flat, const int* truth_offsets,
                       const int* metrics, int n_metrics, int top_k,
                       int n_threads, float* out) {
  ThreadPool pool(n_threads);
  for (int b = 0; b < batch; ++b) {
    pool.submit([=] {
      eval_one_user(scores + static_cast<int64_t>(b) * num_items, num_items,
                    truth_flat + truth_offsets[b],
                    truth_offsets[b + 1] - truth_offsets[b], metrics,
                    n_metrics, top_k, out + static_cast<int64_t>(b) * n_metrics * top_k);
    });
  }
  pool.wait_all();
}

// Uniform sampling in [0, high) excluding per-user exclusion sets.
// counts[u] values are drawn for user u (with replacement among draws).
void batch_randint_choice(int high, const int* counts, int n_users,
                          const int* excl_flat, const int* excl_offsets,
                          uint64_t seed, int* out) {
  std::mt19937_64 rng(seed);
  std::uniform_int_distribution<int> dist(0, high - 1);
  int64_t out_pos = 0;
  for (int u = 0; u < n_users; ++u) {
    std::unordered_set<int> excl(excl_flat + excl_offsets[u],
                                 excl_flat + excl_offsets[u + 1]);
    for (int c = 0; c < counts[u]; ++c) {
      int v = dist(rng);
      while (excl.count(v)) v = dist(rng);
      out[out_pos++] = v;
    }
  }
}

// Row-parallel top-k indices of a (B, num_items) score matrix.
void arg_topk(const float* scores, int batch, int num_items, int k,
              int n_threads, int* out) {
  ThreadPool pool(n_threads);
  const int kk = std::min(k, num_items);
  for (int b = 0; b < batch; ++b) {
    pool.submit([=] {
      const float* row = scores + static_cast<int64_t>(b) * num_items;
      std::vector<int> idx(num_items);
      for (int i = 0; i < num_items; ++i) idx[i] = i;
      std::partial_sort(idx.begin(), idx.begin() + kk, idx.end(),
                        [row](int a, int c) {
                          const float sa = row[a], sc = row[c];
                          const bool na = std::isnan(sa), nc = std::isnan(sc);
                          if (na != nc) return nc;  // NaN ranks last
                          if (!na && sa != sc) return sa > sc;
                          return a < c;
                        });
      for (int i = 0; i < kk; ++i) out[static_cast<int64_t>(b) * k + i] = idx[i];
      for (int i = kk; i < k; ++i) out[static_cast<int64_t>(b) * k + i] = -1;
    });
  }
  pool.wait_all();
}

}  // extern "C"
