// Native BridgeStan bridge for walnuts_tpu_torch (plain C++, no CUDA).
//
// The counterpart of the reference's Stan backend
// (include/walnutpie/load_stan.hpp + the walnutpy C ABI): dlopen a
// compiled BridgeStan model shared object, resolve the public bs_* C API,
// and expose BATCHED log-density/gradient and constrain operations over a
// persistent worker thread pool. The batched entry point is what the
// port's host model (walnuts_tpu_torch/api.py::host_model, through
// models/stan.py) calls once per model evaluation: the chains' positions
// cross to the host once, and the rows fan out across threads (the analog
// of the reference's thread-per-chain evaluation, which requires models
// built with STAN_THREADS=true, stan.py:302-305).
//
// Errors never cross the FFI as exceptions: a failing model evaluation
// yields logp = -inf and zero gradient for that row (the reference's
// NoExceptLogpGrad / load_stan.hpp:132-146 behavior).
//
// Built at first use by walnuts_tpu_torch/ops/_cuda.py::build_host into
// build/walnuts_tpu_torch/ (g++ -O3 -std=c++17 -shared -fPIC ... -ldl -lpthread).

#include <atomic>
#include <cmath>
#include <condition_variable>
#include <cstdio>
#include <cstring>
#include <dlfcn.h>
#include <functional>
#include <limits>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

// Public BridgeStan C ABI (matches thirdparty/bridgestan/bridgestan.h of
// BridgeStan >= 2.x).
struct bs_model;
struct bs_rng;
using bs_model_construct_t = bs_model* (*)(const char*, unsigned int, char**);
using bs_model_destruct_t = void (*)(bs_model*);
using bs_free_error_msg_t = void (*)(char*);
using bs_param_names_t = const char* (*)(const bs_model*, bool, bool);
using bs_param_num_t = int (*)(const bs_model*, bool, bool);
using bs_param_unc_num_t = int (*)(const bs_model*);
using bs_log_density_gradient_t =
    int (*)(const bs_model*, bool, bool, const double*, double*, double*, char**);
using bs_param_constrain_t =
    int (*)(const bs_model*, bool, bool, const double*, double*, bs_rng*, char**);
using bs_param_unconstrain_json_t =
    int (*)(const bs_model*, const char*, double*, char**);
using bs_rng_construct_t = bs_rng* (*)(unsigned int, char**);
using bs_rng_destruct_t = void (*)(bs_rng*);

struct Pool {
  std::vector<std::thread> workers;
  std::mutex mu;
  std::condition_variable cv_work, cv_done;
  std::function<void(int)> task;      // task(row_index)
  int next = 0, total = 0, remaining = 0;
  uint64_t generation = 0;
  bool stop = false;

  explicit Pool(int n_threads) {
    for (int t = 0; t < n_threads; ++t) {
      workers.emplace_back([this] { worker(); });
    }
  }

  ~Pool() {
    {
      std::lock_guard<std::mutex> lk(mu);
      stop = true;
    }
    cv_work.notify_all();
    for (auto& w : workers) w.join();
  }

  void worker() {
    uint64_t seen = 0;
    while (true) {
      int idx = -1;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_work.wait(lk, [&] { return stop || (generation != seen && next < total); });
        if (stop) return;
        if (generation != seen && next >= total) { seen = generation; continue; }
        idx = next++;
      }
      // drain rows without re-locking for each
      while (true) {
        task(idx);
        {
          std::lock_guard<std::mutex> lk(mu);
          if (--remaining == 0) cv_done.notify_all();
          if (next >= total) { seen = generation; break; }
          idx = next++;
        }
      }
    }
  }

  void run(int n, std::function<void(int)> fn) {
    if (n <= 0) return;
    if (workers.empty()) {
      for (int i = 0; i < n; ++i) fn(i);
      return;
    }
    {
      std::lock_guard<std::mutex> lk(mu);
      task = std::move(fn);
      next = 0;
      total = n;
      remaining = n;
      ++generation;
    }
    cv_work.notify_all();
    std::unique_lock<std::mutex> lk(mu);
    cv_done.wait(lk, [&] { return remaining == 0; });
  }
};

struct Handle {
  void* lib = nullptr;
  bs_model* model = nullptr;
  bs_model_destruct_t model_destruct = nullptr;
  bs_free_error_msg_t free_error = nullptr;
  bs_param_names_t param_names = nullptr;
  bs_param_num_t param_num = nullptr;
  bs_param_unc_num_t param_unc_num = nullptr;
  bs_log_density_gradient_t logp_grad = nullptr;
  bs_param_constrain_t constrain = nullptr;
  bs_param_unconstrain_json_t unconstrain_json = nullptr;
  bs_rng_construct_t rng_construct = nullptr;
  bs_rng_destruct_t rng_destruct = nullptr;
  Pool* pool = nullptr;
  std::string last_error;

  ~Handle() {
    delete pool;
    if (model && model_destruct) model_destruct(model);
    if (lib) dlclose(lib);
  }
};

template <typename T>
bool resolve(void* lib, const char* name, T& out) {
  out = reinterpret_cast<T>(dlsym(lib, name));
  return out != nullptr;
}

thread_local std::string g_error;

void set_error(const char* msg) { g_error = msg ? msg : "unknown error"; }

}  // namespace

extern "C" {

const char* wtpu_stan_last_error() { return g_error.c_str(); }

// Open a BridgeStan model shared object. data_json may be NULL/empty.
// n_threads <= 0 selects hardware_concurrency(). Returns NULL on error
// (message via wtpu_stan_last_error).
void* wtpu_stan_open(const char* so_path, const char* data_json,
                     unsigned int seed, int n_threads) {
  auto h = new Handle();
  h->lib = dlopen(so_path, RTLD_NOW | RTLD_LOCAL);
  if (!h->lib) {
    set_error(dlerror());
    delete h;
    return nullptr;
  }
  bs_model_construct_t construct = nullptr;
  bool ok = resolve(h->lib, "bs_model_construct", construct) &&
            resolve(h->lib, "bs_model_destruct", h->model_destruct) &&
            resolve(h->lib, "bs_free_error_msg", h->free_error) &&
            resolve(h->lib, "bs_param_names", h->param_names) &&
            resolve(h->lib, "bs_param_num", h->param_num) &&
            resolve(h->lib, "bs_param_unc_num", h->param_unc_num) &&
            resolve(h->lib, "bs_log_density_gradient", h->logp_grad) &&
            resolve(h->lib, "bs_param_constrain", h->constrain) &&
            resolve(h->lib, "bs_rng_construct", h->rng_construct) &&
            resolve(h->lib, "bs_rng_destruct", h->rng_destruct);
  resolve(h->lib, "bs_param_unconstrain_json", h->unconstrain_json);  // optional
  if (!ok) {
    set_error("missing bs_* symbol in model library");
    delete h;
    return nullptr;
  }
  char* err = nullptr;
  h->model = construct((data_json && data_json[0]) ? data_json : "", seed, &err);
  if (!h->model) {
    set_error(err ? err : "bs_model_construct failed");
    if (err) h->free_error(err);
    delete h;
    return nullptr;
  }
  if (err) h->free_error(err);
  int threads = n_threads > 0
                    ? n_threads
                    : static_cast<int>(std::thread::hardware_concurrency());
  if (threads > 1) h->pool = new Pool(threads);
  return h;
}

void wtpu_stan_close(void* handle) { delete static_cast<Handle*>(handle); }

int wtpu_stan_param_unc_num(void* handle) {
  auto* h = static_cast<Handle*>(handle);
  return h->param_unc_num(h->model);
}

int wtpu_stan_param_num(void* handle, int include_tp, int include_gq) {
  auto* h = static_cast<Handle*>(handle);
  return h->param_num(h->model, include_tp != 0, include_gq != 0);
}

// Comma-separated constrained parameter names; valid until close.
const char* wtpu_stan_param_names(void* handle, int include_tp, int include_gq) {
  auto* h = static_cast<Handle*>(handle);
  return h->param_names(h->model, include_tp != 0, include_gq != 0);
}

// Batched log density + gradient: theta (batch x dim, row-major) ->
// logp (batch), grad (batch x dim). Failing rows get -inf / 0 and the
// call still returns 0 (the NoExceptLogpGrad contract).
int wtpu_stan_logp_grad_batch(void* handle, int batch, int dim,
                              const double* theta, double* logp, double* grad) {
  auto* h = static_cast<Handle*>(handle);
  auto eval_row = [&](int i) {
    char* err = nullptr;
    double val = 0.0;
    int rc = h->logp_grad(h->model, /*propto=*/true, /*jacobian=*/true,
                          theta + static_cast<size_t>(i) * dim, &val,
                          grad + static_cast<size_t>(i) * dim, &err);
    if (rc != 0 || !std::isfinite(val)) {
      logp[i] = -std::numeric_limits<double>::infinity();
      std::memset(grad + static_cast<size_t>(i) * dim, 0, sizeof(double) * dim);
    } else {
      logp[i] = val;
    }
    if (err) h->free_error(err);
  };
  if (h->pool) {
    h->pool->run(batch, eval_row);
  } else {
    for (int i = 0; i < batch; ++i) eval_row(i);
  }
  return 0;
}

// Batched constrain: unc (batch x unc_dim) -> con (batch x con_dim).
// Uses a per-call RNG per thread when include_gq is requested.
int wtpu_stan_constrain_batch(void* handle, int batch, int unc_dim, int con_dim,
                              const double* unc, double* con, int include_tp,
                              int include_gq, unsigned int seed) {
  auto* h = static_cast<Handle*>(handle);
  std::atomic<int> failures{0};
  auto eval_row = [&](int i) {
    char* err = nullptr;
    bs_rng* rng = nullptr;
    if (include_gq) {
      rng = h->rng_construct(seed + static_cast<unsigned int>(i), &err);
      if (err) h->free_error(err);
      err = nullptr;
    }
    int rc = h->constrain(h->model, include_tp != 0, include_gq != 0,
                          unc + static_cast<size_t>(i) * unc_dim,
                          con + static_cast<size_t>(i) * con_dim, rng, &err);
    if (rc != 0) {
      failures.fetch_add(1);
      for (int j = 0; j < con_dim; ++j)
        con[static_cast<size_t>(i) * con_dim + j] =
            std::numeric_limits<double>::quiet_NaN();
    }
    if (err) h->free_error(err);
    if (rng) h->rng_destruct(rng);
  };
  if (h->pool) {
    h->pool->run(batch, eval_row);
  } else {
    for (int i = 0; i < batch; ++i) eval_row(i);
  }
  return failures.load();
}

// Unconstrain one draw given as JSON (used for user-specified inits).
// Returns 0 on success.
int wtpu_stan_unconstrain_json(void* handle, const char* json, double* unc) {
  auto* h = static_cast<Handle*>(handle);
  if (!h->unconstrain_json) {
    set_error("bs_param_unconstrain_json not provided by model");
    return 1;
  }
  char* err = nullptr;
  int rc = h->unconstrain_json(h->model, json, unc, &err);
  if (rc != 0) set_error(err ? err : "unconstrain failed");
  if (err) h->free_error(err);
  return rc;
}

}  // extern "C"
