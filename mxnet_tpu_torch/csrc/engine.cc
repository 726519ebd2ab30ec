// Native dependency engine: the framework's equivalent of the
// reference's src/engine/ (threaded_engine.h:87-189, threaded_engine.cc,
// naive_engine.cc, threaded_engine_perdevice.cc — SURVEY §2.1).
// mxnet_tpu_torch's copy of the JAX package's src/engine.cc, built by
// mxnet_tpu_torch/engine.py with g++ at first use.
//
// Role in this framework: a CUDA stream already orders device work, so
// the engine does NOT schedule device kernels. It schedules *host-side*
// tasks — data pipeline stages, checkpoint writes, kvstore host reductions,
// custom-op callbacks — with the reference's exact read/write-variable
// dependency semantics:
//   - reads on a var accumulate until a write is queued behind them;
//   - a write waits for all prior granted reads to drain and runs alone;
//   - later reads queue behind a pending write (no read-write reordering).
// This is ThreadedVar's versioned queue discipline, implemented with a
// per-var mutex + deque instead of the reference's lock-free linked queue.
//
// Engine types (MXNET_ENGINE_TYPE, ref src/engine/engine.cc:13-39):
//   NaiveEngine     — runs each op inline on the pushing thread (debug).
//   ThreadedEngine  — fixed worker pool + priority dispatch queue
//                     (merges ThreadedEnginePooled/PerDevice; per-device
//                     pools are meaningless with one stream per card).
//
// Exposed as a flat C ABI for ctypes (no pybind11 in this environment).
// Python callbacks are ctypes CFUNCTYPE pointers; ctypes acquires the GIL
// on entry from foreign threads, so worker threads may call Python safely.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <memory>
#include <mutex>
#include <queue>
#include <string>
#include <thread>
#include <unordered_map>
#include <unordered_set>
#include <vector>

namespace {

// fn(arg, token): user work. Must eventually cause EngineOprComplete(token)
// — PushSync-style ops have the engine call it right after fn returns.
typedef void (*EngineFn)(void* arg, void* token);

struct Opr;

struct VarQueueEntry {
  Opr* opr;
  bool is_write;
};

// ThreadedVar equivalent (ref threaded_engine.h:87-189): program-order
// queue of pending ops plus grant state.
struct Var {
  std::mutex m;
  std::deque<VarQueueEntry> queue;
  int pending_reads = 0;     // granted reads not yet completed
  bool write_granted = false;
  bool to_delete = false;    // deferred deletion (ref engine.h:148-160)
};

// OprBlock equivalent (ref threaded_engine.h:42-65).
struct Opr {
  EngineFn fn;
  void* arg;
  std::vector<Var*> const_vars;
  std::vector<Var*> mutable_vars;
  std::atomic<int> wait{0};
  int priority = 0;
  bool sync_complete = false;  // engine completes after fn returns
};

struct Engine;

struct CompletionToken {
  Engine* engine;
  Opr* opr;
};

struct OprCompare {
  bool operator()(Opr* a, Opr* b) const { return a->priority < b->priority; }
};

struct Engine {
  bool threaded;
  std::vector<std::thread> workers;

  std::mutex dispatch_m;
  std::condition_variable dispatch_cv;
  std::priority_queue<Opr*, std::vector<Opr*>, OprCompare> ready;
  bool shutting_down = false;

  std::mutex pending_m;
  std::condition_variable pending_cv;
  int64_t pending = 0;  // pushed, not yet completed

  std::mutex vars_m;
  std::unordered_set<Var*> vars;

  std::string last_error;
  std::mutex err_m;

  explicit Engine(bool thr, int num_workers) : threaded(thr) {
    if (threaded) {
      for (int i = 0; i < num_workers; ++i) {
        workers.emplace_back([this]() { this->WorkerLoop(); });
      }
    }
  }

  ~Engine() {
    WaitForAll();
    {
      std::lock_guard<std::mutex> lk(dispatch_m);
      shutting_down = true;
    }
    dispatch_cv.notify_all();
    for (auto& w : workers) w.join();
    std::lock_guard<std::mutex> lk(vars_m);
    for (Var* v : vars) delete v;
  }

  Var* NewVariable() {
    Var* v = new Var();
    std::lock_guard<std::mutex> lk(vars_m);
    vars.insert(v);
    return v;
  }

  // Grant ops at the head of the var's queue. Caller holds v->m.
  // Returns oprs whose wait count reached zero (to dispatch outside lock).
  void Grant(Var* v, std::vector<Opr*>* runnable) {
    while (!v->queue.empty()) {
      VarQueueEntry& head = v->queue.front();
      if (head.is_write) {
        if (v->pending_reads == 0 && !v->write_granted) {
          v->write_granted = true;
          Opr* o = head.opr;
          v->queue.pop_front();
          if (o->wait.fetch_sub(1) == 1) runnable->push_back(o);
        }
        break;  // a write runs alone; nothing behind it may start
      }
      if (v->write_granted) break;  // reads queued behind an active write
      v->pending_reads += 1;
      Opr* o = head.opr;
      v->queue.pop_front();
      if (o->wait.fetch_sub(1) == 1) runnable->push_back(o);
      // continue: consecutive reads are granted together
    }
  }

  void Dispatch(Opr* o) {
    if (!threaded) {
      RunOpr(o);
      return;
    }
    {
      std::lock_guard<std::mutex> lk(dispatch_m);
      ready.push(o);
    }
    dispatch_cv.notify_one();
  }

  void DispatchAll(std::vector<Opr*>& runnable) {
    for (Opr* o : runnable) Dispatch(o);
  }

  void RunOpr(Opr* o) {
    CompletionToken* tok = new CompletionToken{this, o};
    // read before fn(): an async fn may call EngineOprComplete inline,
    // after which OnComplete has already freed o and tok
    const bool sync = o->sync_complete;
    o->fn(o->arg, tok);
    if (sync) OnComplete(tok);
    // async ops: user code calls EngineOprComplete(tok) later
  }

  void WorkerLoop() {
    for (;;) {
      Opr* o = nullptr;
      {
        std::unique_lock<std::mutex> lk(dispatch_m);
        dispatch_cv.wait(lk, [this]() { return shutting_down || !ready.empty(); });
        if (shutting_down && ready.empty()) return;
        o = ready.top();
        ready.pop();
      }
      RunOpr(o);
    }
  }

  // ref ThreadedEngine::OnComplete (threaded_engine.cc:336): release this
  // op's grants and wake successors.
  void OnComplete(CompletionToken* tok) {
    Opr* o = tok->opr;
    std::vector<Opr*> runnable;
    std::vector<Var*> dead;
    for (Var* v : o->const_vars) {
      std::lock_guard<std::mutex> lk(v->m);
      v->pending_reads -= 1;
      Grant(v, &runnable);
      if (v->to_delete && v->queue.empty() && v->pending_reads == 0 &&
          !v->write_granted) {
        dead.push_back(v);
      }
    }
    for (Var* v : o->mutable_vars) {
      std::lock_guard<std::mutex> lk(v->m);
      v->write_granted = false;
      Grant(v, &runnable);
      if (v->to_delete && v->queue.empty() && v->pending_reads == 0 &&
          !v->write_granted) {
        dead.push_back(v);
      }
    }
    DispatchAll(runnable);
    for (Var* v : dead) FreeVar(v);
    delete o;
    delete tok;
    {
      std::lock_guard<std::mutex> lk(pending_m);
      pending -= 1;
      if (pending == 0) pending_cv.notify_all();
    }
  }

  void FreeVar(Var* v) {
    {
      std::lock_guard<std::mutex> lk(vars_m);
      vars.erase(v);
    }
    delete v;
  }

  // ref ThreadedEngine::CheckDuplicate (threaded_engine.cc:205): aliased
  // vars across const/mutable lists are a usage error.
  bool CheckDuplicate(const std::vector<Var*>& cv, const std::vector<Var*>& mv) {
    std::unordered_set<Var*> seen;
    for (Var* v : cv) if (!seen.insert(v).second) return false;
    for (Var* v : mv) if (!seen.insert(v).second) return false;
    return true;
  }

  int Push(EngineFn fn, void* arg, Var** const_vars, int n_const,
           Var** mutable_vars, int n_mut, int priority, bool sync_complete) {
    Opr* o = new Opr();
    o->fn = fn;
    o->arg = arg;
    o->priority = priority;
    o->sync_complete = sync_complete;
    o->const_vars.assign(const_vars, const_vars + n_const);
    o->mutable_vars.assign(mutable_vars, mutable_vars + n_mut);
    if (!CheckDuplicate(o->const_vars, o->mutable_vars)) {
      delete o;
      std::lock_guard<std::mutex> lk(err_m);
      last_error = "duplicate variable in const/mutable lists";
      return -1;
    }
    {
      std::lock_guard<std::mutex> lk(pending_m);
      pending += 1;
    }
    // +1 sentinel so the op cannot fire while we are still enqueuing it
    o->wait.store(n_const + n_mut + 1);
    std::vector<Opr*> runnable;
    for (Var* v : o->const_vars) {
      std::lock_guard<std::mutex> lk(v->m);
      v->queue.push_back({o, false});
      Grant(v, &runnable);
    }
    for (Var* v : o->mutable_vars) {
      std::lock_guard<std::mutex> lk(v->m);
      v->queue.push_back({o, true});
      Grant(v, &runnable);
    }
    if (o->wait.fetch_sub(1) == 1) runnable.push_back(o);
    DispatchAll(runnable);
    return 0;
  }

  void DeleteVariable(Var* v) {
    bool now;
    {
      std::lock_guard<std::mutex> lk(v->m);
      v->to_delete = true;
      now = v->queue.empty() && v->pending_reads == 0 && !v->write_granted;
    }
    if (now) FreeVar(v);
  }

  void WaitForAll() {
    std::unique_lock<std::mutex> lk(pending_m);
    pending_cv.wait(lk, [this]() { return pending == 0; });
  }

  // ref threaded_engine.cc:300 WaitForVar: push a read op that signals.
  void WaitForVar(Var* v) {
    struct Sync {
      std::mutex m;
      std::condition_variable cv;
      bool done = false;
    } sync;
    EngineFn fn = [](void* arg, void*) {
      Sync* s = static_cast<Sync*>(arg);
      std::lock_guard<std::mutex> lk(s->m);
      s->done = true;
      s->cv.notify_all();
    };
    Var* cv[1] = {v};
    Push(fn, &sync, cv, 1, nullptr, 0, /*priority=*/1 << 20, true);
    std::unique_lock<std::mutex> lk(sync.m);
    sync.cv.wait(lk, [&sync]() { return sync.done; });
  }
};

}  // namespace

extern "C" {

void* EngineCreate(int threaded, int num_workers) {
  if (num_workers <= 0) {
    // host tasks (IO, checkpoint, callbacks) block more than they compute:
    // floor the pool at 4 even on small hosts
    num_workers = static_cast<int>(std::thread::hardware_concurrency());
    if (num_workers < 4) num_workers = 4;
  }
  return new Engine(threaded != 0, num_workers);
}

void EngineDestroy(void* h) { delete static_cast<Engine*>(h); }

void* EngineNewVariable(void* h) {
  return static_cast<Engine*>(h)->NewVariable();
}

void EngineDeleteVariable(void* h, void* var) {
  static_cast<Engine*>(h)->DeleteVariable(static_cast<Var*>(var));
}

int EnginePush(void* h, EngineFn fn, void* arg, void** const_vars, int n_const,
               void** mutable_vars, int n_mut, int priority, int sync_complete) {
  return static_cast<Engine*>(h)->Push(
      fn, arg, reinterpret_cast<Var**>(const_vars), n_const,
      reinterpret_cast<Var**>(mutable_vars), n_mut, priority,
      sync_complete != 0);
}

void EngineOprComplete(void* token) {
  CompletionToken* tok = static_cast<CompletionToken*>(token);
  tok->engine->OnComplete(tok);
}

void EngineWaitForVar(void* h, void* var) {
  static_cast<Engine*>(h)->WaitForVar(static_cast<Var*>(var));
}

void EngineWaitForAll(void* h) { static_cast<Engine*>(h)->WaitForAll(); }

int64_t EnginePendingCount(void* h) {
  Engine* e = static_cast<Engine*>(h);
  std::lock_guard<std::mutex> lk(e->pending_m);
  return e->pending;
}

const char* EngineLastError(void* h) {
  Engine* e = static_cast<Engine*>(h);
  // copy under the lock into a thread-local buffer: the shared string may
  // be reassigned by a concurrent failing Push while the caller reads
  thread_local std::string tl_err;
  {
    std::lock_guard<std::mutex> lk(e->err_m);
    tl_err = e->last_error;
  }
  return tl_err.c_str();
}

}  // extern "C"
