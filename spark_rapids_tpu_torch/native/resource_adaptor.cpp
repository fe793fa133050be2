// Task/memory arbitration state machine (host-side native core), the
// PyTorch port's copy of spark_rapids_tpu/native/resource_adaptor.cpp: the
// same code below the first include, kept in step by a test. It arbitrates
// an H100's memory budget for the port as it does a TPU chip's HBM.
//
// TPU-native re-design of the reference's SparkResourceAdaptor
// (src/main/cpp/src/SparkResourceAdaptorJni.cpp, SURVEY.md
// §2.2): many concurrent framework task threads share one TPU chip's HBM; a
// failed/over-budget reservation must turn into cooperative task-level retry
// instead of a fatal OOM. This file implements the same externally observable
// contract — the 9-state per-thread machine (RUNNING/ALLOC/ALLOC_FREE/
// BLOCKED/BUFN_THROW/BUFN_WAIT/BUFN/SPLIT_THROW/REMOVE_THROW), task-age
// priorities, BUFN ("block until further notice") + split-and-retry deadlock
// escalation, OOM/exception injection for tests, per-task retry metrics with
// get-and-reset drain semantics, and a CSV state-transition log — but as a
// plain C ABI over an admission/reservation layer instead of an RMM
// device_memory_resource wrapper, because XLA dispatch is async: the Python
// side reserves HBM budget *before* dispatch (pool.py) rather than catching a
// synchronous cudaMalloc failure.
//
// Differences from the reference by design:
//  - No JVM: "throw GpuRetryOOM across JNI" becomes status codes returned
//    from the C API; the Python binding raises the matching exception class.
//  - The reverse JNI callback ThreadStateRegistry.isThreadBlocked becomes an
//    explicit per-thread "external blocked" hint (sra_set_thread_blocked_hint)
//    set by the binding when a thread parks in code we cannot observe.
//  - Thread identity is an explicit argument everywhere (the binding passes
//    the OS tid); alloc-path entry points also have _self variants.
#include <algorithm>
#include <chrono>
#include <condition_variable>
#include <cstdarg>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <limits>
#include <map>
#include <memory>
#include <mutex>
#include <set>
#include <sstream>
#include <string>
#include <unordered_map>
#include <unordered_set>
#include <vector>

namespace {

// ---- status codes shared with the Python binding (runtime/adaptor.py) ------
enum Status : int {
  SRA_OK                   = 0,
  SRA_RETRY_OOM            = 1,  // device (HBM) retry-oom
  SRA_SPLIT_RETRY_OOM      = 2,  // device split-and-retry
  SRA_CPU_RETRY_OOM        = 3,  // host off-heap retry-oom
  SRA_CPU_SPLIT_RETRY_OOM  = 4,  // host split-and-retry
  SRA_INJECTED_EXCEPTION   = 5,  // forced framework exception (test hook)
  SRA_THREAD_REMOVED       = 6,  // thread was removed while blocked
  SRA_RETRY_LIMIT_EXCEEDED = 7,  // livelock watchdog tripped: hard OOM
  SRA_INVALID              = 8,  // bad argument / internal error (see last_error)
  SRA_BUSY                 = 9,  // shutdown timed out with threads still live
};

enum class ThreadState : int {
  UNKNOWN      = -1,
  RUNNING      = 0,  // running normally
  ALLOC        = 1,  // mid-allocation
  ALLOC_FREE   = 2,  // mid-allocation and a free happened since it started
  BLOCKED      = 3,  // temporarily blocked waiting for memory
  BUFN_THROW   = 4,  // must throw retry-oom to roll back, then block
  BUFN_WAIT    = 5,  // threw; will move to BUFN at next alloc/block call
  BUFN         = 6,  // blocked until some other task makes progress
  SPLIT_THROW  = 7,  // must throw split-and-retry
  REMOVE_THROW = 8,  // being removed; must throw out of any wait
};

const char* state_name(ThreadState s)
{
  switch (s) {
    case ThreadState::RUNNING: return "THREAD_RUNNING";
    case ThreadState::ALLOC: return "THREAD_ALLOC";
    case ThreadState::ALLOC_FREE: return "THREAD_ALLOC_FREE";
    case ThreadState::BLOCKED: return "THREAD_BLOCKED";
    case ThreadState::BUFN_THROW: return "THREAD_BUFN_THROW";
    case ThreadState::BUFN_WAIT: return "THREAD_BUFN_WAIT";
    case ThreadState::BUFN: return "THREAD_BUFN";
    case ThreadState::SPLIT_THROW: return "THREAD_SPLIT_THROW";
    case ThreadState::REMOVE_THROW: return "THREAD_REMOVE_THROW";
    default: return "UNKNOWN";
  }
}

// Internal control-flow exception; converted to a status code at the C ABI.
struct StatusError {
  int code;
  std::string msg;
  StatusError(int code, std::string msg) : code(code), msg(std::move(msg)) {}
};

thread_local std::string g_last_error;

// Scheduling priority. Spark task ids are assigned in increasing order, so an
// *older* (smaller-id) task outranks newer ones — it is closest to finishing
// and freeing memory. Threads not tied to any task (task_id < 0: shuffle and
// idle pool threads) outrank every task. Ties break on thread id.
struct Priority {
  int64_t task_id;
  int64_t thread_id;
  // rank is monotonically decreasing in task_id; -1 maps above all real tasks
  int64_t rank() const { return -(task_id + 1); }
  bool outranked_by(Priority const& o) const
  {
    if (rank() != o.rank()) return rank() < o.rank();
    return thread_id < o.thread_id;
  }
};

struct Metrics {
  int64_t num_retry        = 0;
  int64_t num_split_retry  = 0;
  int64_t blocked_nanos    = 0;
  int64_t lost_nanos       = 0;  // computation discarded by a retry throw

  void add(Metrics const& o)
  {
    num_retry += o.num_retry;
    num_split_retry += o.num_split_retry;
    blocked_nanos += o.blocked_nanos;
    lost_nanos += o.lost_nanos;
  }
  void clear() { *this = Metrics(); }
};

// Test-hook injection: throw N errors after skipping M matching allocations,
// filtered to host/device/either.
struct Injection {
  int remaining = 0;
  int skip      = 0;
  int filter    = 0;  // 0 = either, 1 = cpu only, 2 = gpu(device) only

  void arm(int num, int skip_count, int filt)
  {
    if (num < 0 || skip_count < 0 || filt < 0 || filt > 2)
      throw StatusError(SRA_INVALID, "bad injection arguments");
    remaining = num;
    skip      = skip_count;
    filter    = filt;
  }
  bool applies(bool is_cpu) const
  {
    return filter == 0 || (is_cpu ? filter == 1 : filter == 2);
  }
  // Returns true when an error should fire for this allocation.
  bool fire(bool is_cpu)
  {
    if (!applies(is_cpu)) return false;
    if (skip > 0) {
      skip--;
      return false;
    }
    if (remaining > 0) {
      remaining--;
      return true;
    }
    return false;
  }
};

using Clock = std::chrono::steady_clock;

struct ThreadRec {
  ThreadState state = ThreadState::RUNNING;
  int64_t thread_id = -1;
  int64_t task_id   = -1;  // >=0: dedicated task thread
  bool is_shuffle   = false;
  std::unordered_set<int64_t> pool_tasks;  // tasks a pool thread serves
  bool is_cpu_alloc     = false;  // current ALLOC is host-side
  bool pool_blocked     = false;  // dedicated thread parked waiting on a pool
  bool external_blocked = false;  // binding says thread is parked elsewhere

  Injection inj_retry;
  Injection inj_split;
  int inj_exception = 0;

  int retries_since_progress = 0;  // livelock watchdog counter

  // retry-block time accounting (metrics only)
  bool in_retry_block = false;
  int64_t pending_retry_nanos = 0;
  Clock::time_point retry_mark;
  Clock::time_point block_start;

  Metrics metrics;
  std::unique_ptr<std::condition_variable> wake =
    std::make_unique<std::condition_variable>();

  Priority priority() const
  {
    if (task_id < 0 && !is_shuffle && !pool_tasks.empty())
      return {*std::min_element(pool_tasks.begin(), pool_tasks.end()), thread_id};
    return {task_id, thread_id};
  }

  void mark_block_start()
  {
    block_start = Clock::now();
    bank_retry_time();
  }
  void mark_block_end()
  {
    auto const now = Clock::now();
    metrics.blocked_nanos +=
      std::chrono::duration_cast<std::chrono::nanoseconds>(now - block_start).count();
    if (in_retry_block) retry_mark = now;
  }
  // move elapsed retry-block wall time into the pending bucket
  void bank_retry_time()
  {
    if (!in_retry_block) return;
    auto const now = Clock::now();
    pending_retry_nanos +=
      std::chrono::duration_cast<std::chrono::nanoseconds>(now - retry_mark).count();
    retry_mark = now;
  }
  // a retry throw discards the work done in this retry block
  void count_lost_time()
  {
    if (!in_retry_block) return;
    bank_retry_time();
    metrics.lost_nanos += pending_retry_nanos;
    pending_retry_nanos = 0;
  }
  void reset_retry_block(bool entering)
  {
    pending_retry_nanos = 0;
    if (entering) retry_mark = Clock::now();
    in_retry_block = entering;
  }
};

class ResourceArbiter {
 public:
  explicit ResourceArbiter(std::string const& log_loc) : retry_limit_(500)
  {
    if (log_loc.empty()) {
      log_ = nullptr;
    } else if (log_loc == "stderr") {
      log_ = stderr;
    } else if (log_loc == "stdout") {
      log_ = stdout;
    } else {
      log_       = std::fopen(log_loc.c_str(), "w");
      owns_log_  = log_ != nullptr;
      if (!log_) throw StatusError(SRA_INVALID, "cannot open log file " + log_loc);
    }
    if (log_) {
      std::fprintf(log_, "time,op,current thread,op thread,op task,from state,to state,notes\n");
      std::fflush(log_);
    }
  }

  ~ResourceArbiter()
  {
    if (owns_log_ && log_) std::fclose(log_);
  }

  void set_retry_limit(int limit)
  {
    std::unique_lock<std::mutex> lock(mu_);
    retry_limit_ = limit;
  }

  // ---- thread / task registration -----------------------------------------

  void start_dedicated_task_thread(int64_t tid, int64_t task_id, int64_t self)
  {
    std::unique_lock<std::mutex> lock(mu_);
    ensure_not_shutting_down();
    auto it = threads_.find(tid);
    if (it != threads_.end() && it->second.task_id >= 0 && it->second.task_id != task_id) {
      // Spark reuses a dedicated thread for a new attempt: detach it first.
      log_status("FIXUP", self, tid, it->second.task_id, it->second.state,
                 "rebinding to task " + std::to_string(task_id));
      remove_thread_association(tid, it->second.task_id, self, lock);
    }
    auto [pos, inserted] = threads_.try_emplace(tid);
    if (inserted) {
      pos->second.thread_id = tid;
      pos->second.task_id   = task_id;
    } else {
      if (pos->second.state == ThreadState::REMOVE_THROW)
        throw StatusError(SRA_INVALID, "thread " + std::to_string(tid) + " is shutting down");
      if (pos->second.task_id != task_id)
        throw StatusError(SRA_INVALID,
                          "thread " + std::to_string(tid) + " already dedicated to task " +
                            std::to_string(pos->second.task_id));
    }
    task_threads_[task_id].insert(tid);
    if (inserted)
      log_transition(self, tid, task_id, ThreadState::UNKNOWN, ThreadState::RUNNING);
  }

  void pool_thread_working_on_tasks(bool is_shuffle, int64_t tid,
                                    std::vector<int64_t> const& task_ids, int64_t self)
  {
    std::unique_lock<std::mutex> lock(mu_);
    ensure_not_shutting_down();
    auto [pos, inserted] = threads_.try_emplace(tid);
    if (inserted) {
      pos->second.thread_id  = tid;
      pos->second.is_shuffle = is_shuffle;
      log_transition(self, tid, -1, ThreadState::UNKNOWN, ThreadState::RUNNING);
    } else if (pos->second.task_id != -1) {
      throw StatusError(SRA_INVALID, "thread is already a dedicated task thread");
    } else if (pos->second.state == ThreadState::REMOVE_THROW) {
      throw StatusError(SRA_INVALID, "thread is shutting down");
    } else if (pos->second.is_shuffle != is_shuffle) {
      throw StatusError(SRA_INVALID, "cannot change shuffle-ness of a live pool thread");
    }
    checkpoint_metrics(pos->second);
    pos->second.pool_tasks.insert(task_ids.begin(), task_ids.end());
  }

  void pool_thread_finished_for_tasks(int64_t tid, std::vector<int64_t> const& task_ids,
                                      int64_t self)
  {
    std::unique_lock<std::mutex> lock(mu_);
    ensure_not_shutting_down();
    auto it = threads_.find(tid);
    if (it == threads_.end()) return;
    checkpoint_metrics(it->second);
    for (auto id : task_ids)
      it->second.pool_tasks.erase(id);
    if (it->second.pool_tasks.empty()) {
      if (remove_thread_association(tid, -1, self, lock)) wake_after_task_finish(self, lock);
    }
  }

  void remove_thread_association(int64_t tid, int64_t task_id, int64_t self)
  {
    std::unique_lock<std::mutex> lock(mu_);
    if (remove_thread_association(tid, task_id, self, lock)) wake_after_task_finish(self, lock);
  }

  void task_done(int64_t task_id, int64_t self)
  {
    std::unique_lock<std::mutex> lock(mu_);
    bool woke_runner = false;
    auto at = task_threads_.find(task_id);
    if (at != task_threads_.end()) {
      std::set<int64_t> const to_remove = at->second;  // copy: we mutate below
      for (auto tid : to_remove)
        woke_runner = remove_thread_association(tid, task_id, self, lock) || woke_runner;
    }
    // detach from pool threads too
    std::vector<int64_t> tids;
    tids.reserve(threads_.size());
    for (auto const& [tid, rec] : threads_)
      tids.push_back(tid);
    for (auto tid : tids) {
      auto it = threads_.find(tid);
      if (it == threads_.end()) continue;
      if (it->second.pool_tasks.erase(task_id) != 0 && it->second.pool_tasks.empty())
        woke_runner = remove_thread_association(tid, task_id, self, lock) || woke_runner;
    }
    if (woke_runner) wake_after_task_finish(self, lock);
    task_threads_.erase(task_id);
    task_metrics_.erase(task_id);
  }

  // Returns true when every thread has exited; callers must not destroy the
  // arbiter after a false return (a straggler may still be blocked on mu_).
  bool all_done(int64_t self)
  {
    std::unique_lock<std::mutex> lock(mu_);
    std::vector<int64_t> tids;
    for (auto const& [tid, rec] : threads_)
      tids.push_back(tid);
    for (auto tid : tids)
      remove_thread_association(tid, -1, self, lock);
    shutting_down_ = true;
    // bounded wait for blocked threads to notice REMOVE_THROW and exit
    return woken_cv_.wait_for(lock, std::chrono::milliseconds(1000),
                              [this] { return threads_.empty(); });
  }

  // ---- pool-wait bracketing and external-block hints ----------------------

  void set_pool_blocked(int64_t tid, bool blocked)
  {
    std::unique_lock<std::mutex> lock(mu_);
    auto it = threads_.find(tid);
    if (it == threads_.end() || it->second.task_id < 0)
      throw StatusError(SRA_INVALID,
                        "thread " + std::to_string(tid) + " is not a dedicated task thread");
    it->second.pool_blocked = blocked;
  }

  void set_external_blocked(int64_t tid, bool blocked)
  {
    std::unique_lock<std::mutex> lock(mu_);
    auto it = threads_.find(tid);
    if (it != threads_.end()) it->second.external_blocked = blocked;
  }

  void start_retry_block(int64_t tid)
  {
    std::unique_lock<std::mutex> lock(mu_);
    auto it = threads_.find(tid);
    if (it != threads_.end()) it->second.reset_retry_block(true);
  }

  void end_retry_block(int64_t tid)
  {
    std::unique_lock<std::mutex> lock(mu_);
    auto it = threads_.find(tid);
    if (it != threads_.end()) it->second.reset_retry_block(false);
  }

  // ---- injection (test hooks) ---------------------------------------------

  void force_retry_oom(int64_t tid, int num, int filter, int skip)
  {
    std::unique_lock<std::mutex> lock(mu_);
    find_registered(tid).inj_retry.arm(num, skip, filter);
  }

  void force_split_retry_oom(int64_t tid, int num, int filter, int skip)
  {
    std::unique_lock<std::mutex> lock(mu_);
    find_registered(tid).inj_split.arm(num, skip, filter);
  }

  void force_exception(int64_t tid, int num)
  {
    std::unique_lock<std::mutex> lock(mu_);
    find_registered(tid).inj_exception = num;
  }

  // ---- allocation path ----------------------------------------------------

  // Returns recursive=true when the thread re-entered the allocator while
  // already mid-allocation (spill code allocating during alloc failure).
  bool pre_alloc(int64_t tid, bool is_cpu, bool blocking, int64_t self)
  {
    std::unique_lock<std::mutex> lock(mu_);
    return pre_alloc_core(tid, is_cpu, blocking, self, lock);
  }

  void post_alloc_success(int64_t tid, bool is_cpu, bool was_recursive, int64_t self)
  {
    std::unique_lock<std::mutex> lock(mu_);
    post_alloc_success_core(tid, is_cpu, was_recursive, self, lock);
  }

  bool post_alloc_failed(int64_t tid, bool is_cpu, bool was_oom, bool blocking,
                         bool was_recursive, int64_t self)
  {
    std::unique_lock<std::mutex> lock(mu_);
    return post_alloc_failed_core(tid, is_cpu, was_oom, blocking, was_recursive, self, lock);
  }

  void dealloc(int64_t tid, bool is_cpu, int64_t self)
  {
    std::unique_lock<std::mutex> lock(mu_);
    dealloc_core(tid, is_cpu, self, lock);
  }

  void block_thread_until_ready(int64_t tid, int64_t self)
  {
    std::unique_lock<std::mutex> lock(mu_);
    block_until_ready(tid, self, lock);
  }

  void check_and_break_deadlocks(int64_t self)
  {
    std::unique_lock<std::mutex> lock(mu_);
    escalate_if_deadlocked(self, lock);
  }

  int get_thread_state(int64_t tid)
  {
    std::unique_lock<std::mutex> lock(mu_);
    auto it = threads_.find(tid);
    return it == threads_.end() ? -1 : static_cast<int>(it->second.state);
  }

  // ---- metrics ------------------------------------------------------------

  int64_t drain_metric(int64_t task_id, int64_t Metrics::*field)
  {
    std::unique_lock<std::mutex> lock(mu_);
    int64_t total = 0;
    auto at = task_threads_.find(task_id);
    if (at != task_threads_.end()) {
      for (auto tid : at->second) {
        auto it = threads_.find(tid);
        if (it != threads_.end()) {
          total += it->second.metrics.*field;
          it->second.metrics.*field = 0;
        }
      }
    }
    auto mt = task_metrics_.find(task_id);
    if (mt != task_metrics_.end()) {
      total += mt->second.*field;
      mt->second.*field = 0;
    }
    return total;
  }

 private:
  // ---- helpers; all require mu_ held --------------------------------------

  void ensure_not_shutting_down() const
  {
    if (shutting_down_) throw StatusError(SRA_INVALID, "resource arbiter is shutting down");
  }

  ThreadRec& find_registered(int64_t tid)
  {
    auto it = threads_.find(tid);
    if (it == threads_.end())
      throw StatusError(SRA_INVALID,
                        "thread " + std::to_string(tid) + " is not associated with any task");
    return it->second;
  }

  static bool is_parked(ThreadState s)
  {
    return s == ThreadState::BLOCKED || s == ThreadState::BUFN;
  }

  void transition(ThreadRec& rec, ThreadState to, int64_t self, char const* note = "")
  {
    auto const from = rec.state;
    rec.state       = to;
    log_transition(self, rec.thread_id, rec.task_id, from, to, note);
  }

  // Aggregate a thread's metrics into its task(s) before membership changes.
  void checkpoint_metrics(ThreadRec& rec)
  {
    if (rec.task_id < 0) {
      for (auto task_id : rec.pool_tasks)
        task_metrics_[task_id].add(rec.metrics);
      rec.metrics.clear();
    } else {
      task_metrics_[rec.task_id].add(rec.metrics);
      rec.metrics.clear();
    }
  }

  // Livelock watchdog: too many consecutive retries without progress means
  // retrying is not converging; surface a hard OOM instead of spinning.
  void watchdog_before_oom(ThreadRec& rec)
  {
    if (rec.retries_since_progress + 1 > retry_limit_) {
      rec.count_lost_time();
      throw StatusError(SRA_RETRY_LIMIT_EXCEEDED, "retry limit exceeded; hard OOM");
    }
    rec.retries_since_progress++;
  }

  [[noreturn]] void throw_retry_oom(ThreadRec& rec)
  {
    rec.metrics.num_retry++;
    watchdog_before_oom(rec);
    rec.count_lost_time();
    throw StatusError(rec.is_cpu_alloc ? SRA_CPU_RETRY_OOM : SRA_RETRY_OOM, "retry-oom");
  }

  [[noreturn]] void throw_split_retry_oom(ThreadRec& rec)
  {
    rec.metrics.num_split_retry++;
    watchdog_before_oom(rec);
    rec.count_lost_time();
    throw StatusError(rec.is_cpu_alloc ? SRA_CPU_SPLIT_RETRY_OOM : SRA_SPLIT_RETRY_OOM,
                      "split-and-retry");
  }

  void park(int64_t tid, ThreadRec* rec, int64_t self, std::unique_lock<std::mutex>& lock)
  {
    log_status("WAITING", self, tid, rec->task_id, rec->state);
    rec->mark_block_start();
    do {
      rec->wake->wait(lock);
      auto it = threads_.find(tid);
      rec     = it == threads_.end() ? nullptr : &it->second;
    } while (rec != nullptr && is_parked(rec->state));
    if (rec != nullptr) rec->mark_block_end();
    woken_cv_.notify_all();
  }

  void block_until_ready(int64_t tid, int64_t self, std::unique_lock<std::mutex>& lock)
  {
    bool first = true;
    while (true) {
      auto it = threads_.find(tid);
      if (it == threads_.end()) return;  // unregistered threads never block
      ThreadRec& rec = it->second;
      switch (rec.state) {
        case ThreadState::BLOCKED:
        case ThreadState::BUFN:
          park(tid, &rec, self, lock);
          break;
        case ThreadState::BUFN_THROW:
          transition(rec, ThreadState::BUFN_WAIT, self);
          rec.count_lost_time();
          throw_retry_oom(rec);
        case ThreadState::BUFN_WAIT: {
          transition(rec, ThreadState::BUFN, self);
          // The rollback may not have freed anything; if everyone is still
          // wedged this may immediately escalate us (or someone) further.
          escalate_if_deadlocked(self, lock);
          auto it2 = threads_.find(tid);
          if (it2 != threads_.end() && is_parked(it2->second.state))
            park(tid, &it2->second, self, lock);
          break;
        }
        case ThreadState::SPLIT_THROW:
          transition(rec, ThreadState::RUNNING, self);
          rec.count_lost_time();
          throw_split_retry_oom(rec);
        case ThreadState::REMOVE_THROW:
          log_transition(self, tid, rec.task_id, rec.state, ThreadState::UNKNOWN);
          threads_.erase(tid);
          woken_cv_.notify_all();
          throw StatusError(SRA_THREAD_REMOVED, "thread removed while blocked");
        default:
          if (!first) log_status("DONE WAITING", self, tid, rec.task_id, rec.state);
          return;
      }
      first = false;
    }
  }

  bool pre_alloc_core(int64_t tid, bool is_cpu, bool blocking, int64_t self,
                      std::unique_lock<std::mutex>& lock)
  {
    auto it = threads_.find(tid);
    if (it == threads_.end()) return false;  // untracked thread: no arbitration
    ThreadRec& rec = it->second;

    if (rec.state == ThreadState::ALLOC || rec.state == ThreadState::ALLOC_FREE) {
      // Re-entered the allocator while mid-allocation: this is spill code
      // running under an allocation failure. On the host side we require the
      // spill path to declare itself non-blocking instead of detecting it.
      if (is_cpu && blocking)
        throw StatusError(SRA_INVALID, "blocking host alloc while already allocating");
      return true;
    }

    if (rec.inj_retry.fire(is_cpu)) {
      rec.metrics.num_retry++;
      log_status(is_cpu ? "INJECTED_RETRY_OOM_CPU" : "INJECTED_RETRY_OOM_GPU", self, tid,
                 rec.task_id, rec.state);
      rec.count_lost_time();
      throw StatusError(is_cpu ? SRA_CPU_RETRY_OOM : SRA_RETRY_OOM, "injected retry-oom");
    }
    if (rec.inj_exception > 0) {
      rec.inj_exception--;
      log_status("INJECTED_EXCEPTION", self, tid, rec.task_id, rec.state);
      rec.count_lost_time();
      throw StatusError(SRA_INJECTED_EXCEPTION, "injected framework exception");
    }
    if (rec.inj_split.fire(is_cpu)) {
      rec.metrics.num_split_retry++;
      log_status(is_cpu ? "INJECTED_SPLIT_AND_RETRY_OOM_CPU" : "INJECTED_SPLIT_AND_RETRY_OOM_GPU",
                 self, tid, rec.task_id, rec.state);
      rec.count_lost_time();
      throw StatusError(is_cpu ? SRA_CPU_SPLIT_RETRY_OOM : SRA_SPLIT_RETRY_OOM,
                        "injected split-and-retry");
    }

    if (blocking) block_until_ready(tid, self, lock);

    auto it2 = threads_.find(tid);
    if (it2 == threads_.end()) return false;
    ThreadRec& rec2 = it2->second;
    if (rec2.state != ThreadState::RUNNING)
      throw StatusError(SRA_INVALID, std::string("unexpected state pre-alloc: ") +
                                       state_name(rec2.state));
    transition(rec2, ThreadState::ALLOC, self);
    rec2.is_cpu_alloc = is_cpu;
    return false;
  }

  void post_alloc_success_core(int64_t tid, bool is_cpu, bool was_recursive, int64_t self,
                               std::unique_lock<std::mutex>& lock)
  {
    if (was_recursive) return;
    auto it = threads_.find(tid);
    if (it != threads_.end()) {
      ThreadRec& rec = it->second;
      if (rec.state == ThreadState::ALLOC || rec.state == ThreadState::ALLOC_FREE) {
        if (rec.is_cpu_alloc != is_cpu)
          throw StatusError(SRA_INVALID, "host/device mismatch in post-alloc");
        transition(rec, ThreadState::RUNNING, self);
        rec.is_cpu_alloc = false;
        // a successful allocation is progress: reset the livelock watchdog
        rec.retries_since_progress = 0;
      }
      wake_next_highest_priority_blocked(self, /*from_free=*/false, is_cpu, lock);
    }
  }

  bool post_alloc_failed_core(int64_t tid, bool is_cpu, bool was_oom, bool blocking,
                              bool was_recursive, int64_t self,
                              std::unique_lock<std::mutex>& lock)
  {
    auto it  = threads_.find(tid);
    bool ret = true;
    if (!was_recursive && it != threads_.end()) {
      ThreadRec& rec = it->second;
      if (rec.is_cpu_alloc != is_cpu)
        throw StatusError(SRA_INVALID, "host/device mismatch in post-alloc-failed");
      switch (rec.state) {
        case ThreadState::ALLOC_FREE:
          // memory was freed while we were failing: retry immediately
          transition(rec, ThreadState::RUNNING, self);
          break;
        case ThreadState::ALLOC:
          if (was_oom && blocking) {
            transition(rec, ThreadState::BLOCKED, self);
          } else {
            transition(rec, ThreadState::RUNNING, self);
          }
          break;
        default:
          throw StatusError(SRA_INVALID, std::string("unexpected state post-alloc-failed: ") +
                                           state_name(rec.state));
      }
    } else {
      ret = false;  // unregistered (or recursive): caller must not retry
    }
    escalate_if_deadlocked(self, lock);
    return ret;
  }

  void dealloc_core(int64_t tid, bool is_cpu, int64_t self, std::unique_lock<std::mutex>& lock)
  {
    auto it = threads_.find(tid);
    if (it != threads_.end()) {
      log_status("DEALLOC", self, tid, it->second.task_id, it->second.state);
    } else {
      log_status("DEALLOC", self, tid, -2, ThreadState::UNKNOWN);
    }
    // Tell every *other* mid-allocation thread of the same kind that memory
    // was just freed (their in-flight failure should be retried). Not our own
    // thread: a recursive free inside our own failed alloc adds nothing for
    // us to retry with.
    for (auto& [other_id, rec] : threads_) {
      if (other_id != tid && rec.state == ThreadState::ALLOC && rec.is_cpu_alloc == is_cpu)
        transition(rec, ThreadState::ALLOC_FREE, self);
    }
    wake_next_highest_priority_blocked(self, /*from_free=*/true, is_cpu, lock);
  }

  void wake_next_highest_priority_blocked(int64_t self, bool from_free, bool is_cpu,
                                          std::unique_lock<std::mutex>& lock)
  {
    // wake the best BLOCKED thread whose allocation kind matches
    ThreadRec* best = nullptr;
    for (auto& [tid, rec] : threads_) {
      if (rec.state == ThreadState::BLOCKED && rec.is_cpu_alloc == is_cpu) {
        if (best == nullptr || best->priority().outranked_by(rec.priority())) best = &rec;
      }
    }
    if (best != nullptr) {
      transition(*best, ThreadState::RUNNING, self);
      best->wake->notify_all();
      return;
    }
    if (!from_free) return;
    // Nothing plain-BLOCKED and memory was freed: if *every* task is wedged
    // at BUFN, restart the best BUFN thread so it retries with the newly
    // freed memory instead of being forced to split. Never self-wake: our own
    // free gives us nothing new to retry with.
    DeadlockScan scan = scan_for_deadlock(lock);
    if (scan.all_tasks.empty() || scan.bufn_tasks.size() != scan.all_tasks.size()) return;
    ThreadRec* wake = nullptr;
    for (auto& [tid, rec] : threads_) {
      if (rec.state == ThreadState::BUFN && rec.is_cpu_alloc == is_cpu) {
        if (wake == nullptr || wake->priority().outranked_by(rec.priority())) wake = &rec;
      }
    }
    if (wake == nullptr || wake->thread_id == self) return;
    switch (wake->state) {
      case ThreadState::BUFN:
        transition(*wake, ThreadState::RUNNING, self);
        wake->wake->notify_all();
        break;
      default: break;
    }
  }

  // A task counts as wedged-at-BUFN when any dedicated thread of it is BUFN
  // (or parked outside our view), or all pool threads serving it are.
  bool thread_bufn_or_worse(ThreadRec const& rec) const
  {
    if (rec.pool_blocked) return true;
    switch (rec.state) {
      case ThreadState::BLOCKED: return false;
      case ThreadState::BUFN: return true;
      default: return rec.external_blocked;
    }
  }

  struct DeadlockScan {
    bool deadlocked = false;
    std::unordered_set<int64_t> all_tasks;
    std::unordered_set<int64_t> bufn_tasks;
    std::map<int64_t, int64_t> pool_threads_per_task;
    std::map<int64_t, int64_t> bufn_pool_threads_per_task;
  };

  DeadlockScan scan_for_deadlock(std::unique_lock<std::mutex> const& /*held*/)
  {
    DeadlockScan out;
    std::unordered_set<int64_t> blocked_tasks;
    // dedicated task threads
    for (auto const& [tid, rec] : threads_) {
      if (rec.task_id < 0) continue;
      out.all_tasks.insert(rec.task_id);
      bool const bufn_plus = thread_bufn_or_worse(rec);
      if (bufn_plus) out.bufn_tasks.insert(rec.task_id);
      if (bufn_plus || rec.state == ThreadState::BLOCKED) blocked_tasks.insert(rec.task_id);
    }
    // pool threads: a task they serve is only truly blocked if every one of
    // its pool threads is
    for (auto const& [tid, rec] : threads_) {
      if (rec.task_id >= 0) continue;
      for (auto task_id : rec.pool_tasks)
        out.pool_threads_per_task[task_id]++;
      bool const bufn_plus = thread_bufn_or_worse(rec);
      if (bufn_plus) {
        for (auto task_id : rec.pool_tasks)
          out.bufn_pool_threads_per_task[task_id]++;
      }
      if (!bufn_plus && rec.state != ThreadState::BLOCKED) {
        for (auto task_id : rec.pool_tasks)
          blocked_tasks.erase(task_id);
      }
    }
    out.deadlocked =
      !out.all_tasks.empty() && out.all_tasks.size() == blocked_tasks.size();
    return out;
  }

  // When every task is blocked: roll back the *lowest-priority* BLOCKED
  // thread (BUFN_THROW — it will throw retry-oom, drop to a spillable state
  // and park). If that leaves every task at BUFN, tell the *highest-priority*
  // BUFN thread to split its input and retry (SPLIT_THROW).
  void escalate_if_deadlocked(int64_t self, std::unique_lock<std::mutex>& lock)
  {
    DeadlockScan scan = scan_for_deadlock(lock);
    if (!scan.deadlocked) return;

    ThreadRec* worst = nullptr;
    for (auto& [tid, rec] : threads_) {
      if (rec.state == ThreadState::BLOCKED) {
        if (worst == nullptr || rec.priority().outranked_by(worst->priority())) worst = &rec;
      }
    }
    if (worst != nullptr) {
      transition(*worst, ThreadState::BUFN_THROW, self);
      worst->wake->notify_all();
      // don't split yet: let the rollback/retry run its course first
    }

    for (auto const& [task_id, bufn_count] : scan.bufn_pool_threads_per_task) {
      auto it = scan.pool_threads_per_task.find(task_id);
      if (it != scan.pool_threads_per_task.end() && it->second <= bufn_count)
        scan.bufn_tasks.insert(task_id);
    }
    // split only when every known task is at BUFN — membership, not size:
    // bufn_tasks may contain pool-only task ids that all_tasks lacks
    for (auto task_id : scan.all_tasks)
      if (scan.bufn_tasks.find(task_id) == scan.bufn_tasks.end()) return;

    ThreadRec* best = nullptr;
    for (auto& [tid, rec] : threads_) {
      if (rec.state == ThreadState::BUFN) {
        if (best == nullptr || best->priority().outranked_by(rec.priority())) best = &rec;
      }
    }
    if (best != nullptr) {
      transition(*best, ThreadState::SPLIT_THROW, self);
      best->wake->notify_all();
    }
  }

  void wake_after_task_finish(int64_t self, std::unique_lock<std::mutex> const& /*held*/)
  {
    // A task finished → progress was made. Restart all plain-BLOCKED threads;
    // only if there were none, restart the BUFN family too.
    bool any_blocked = false;
    for (auto& [tid, rec] : threads_) {
      if (rec.state == ThreadState::BLOCKED) {
        transition(rec, ThreadState::RUNNING, self);
        rec.wake->notify_all();
        any_blocked = true;
      }
    }
    if (any_blocked) return;
    for (auto& [tid, rec] : threads_) {
      switch (rec.state) {
        case ThreadState::BUFN:
        case ThreadState::BUFN_THROW:
        case ThreadState::BUFN_WAIT:
          transition(rec, ThreadState::RUNNING, self);
          rec.wake->notify_all();
          break;
        default: break;
      }
    }
  }

  // Returns true when a normally-RUNNING task thread was fully removed (the
  // signal used to decide whether finishing it should wake other threads).
  bool remove_thread_association(int64_t tid, int64_t remove_task_id, int64_t self,
                                 std::unique_lock<std::mutex> const& /*held*/)
  {
    auto it = threads_.find(tid);
    if (it == threads_.end()) return false;
    ThreadRec& rec = it->second;
    checkpoint_metrics(rec);

    bool remove = false;
    if (remove_task_id < 0) {
      remove = true;
    } else if (rec.task_id >= 0) {
      remove = rec.task_id == remove_task_id;
    } else {
      rec.pool_tasks.erase(remove_task_id);
      remove = rec.pool_tasks.empty();
    }
    if (!remove) return false;

    if (remove_task_id >= 0) {
      auto at = task_threads_.find(remove_task_id);
      if (at != task_threads_.end()) at->second.erase(tid);
    }
    switch (rec.state) {
      case ThreadState::BLOCKED:
      case ThreadState::BUFN:
        // parked: flag it to throw on wake; state is erased then
        transition(rec, ThreadState::REMOVE_THROW, self);
        rec.wake->notify_all();
        return false;
      case ThreadState::RUNNING:
        log_transition(self, tid, rec.task_id, rec.state, ThreadState::UNKNOWN);
        threads_.erase(it);
        return true;
      default:
        log_transition(self, tid, rec.task_id, rec.state, ThreadState::UNKNOWN);
        threads_.erase(it);
        return false;
    }
  }

  // ---- logging ------------------------------------------------------------

  void log_line(char const* op, int64_t self, int64_t tid, int64_t task_id,
                char const* from, char const* to, std::string const& notes)
  {
    if (!log_) return;
    auto const now = std::chrono::system_clock::now();
    auto const us =
      std::chrono::duration_cast<std::chrono::microseconds>(now.time_since_epoch()).count();
    std::time_t const secs = static_cast<std::time_t>(us / 1000000);
    std::tm tm_buf;
    localtime_r(&secs, &tm_buf);
    std::fprintf(log_, "%02d:%02d:%02d.%06lld,%s,%lld,%lld,%lld,%s,%s,%s\n", tm_buf.tm_hour,
                 tm_buf.tm_min, tm_buf.tm_sec, static_cast<long long>(us % 1000000), op,
                 static_cast<long long>(self), static_cast<long long>(tid),
                 static_cast<long long>(task_id), from, to, notes.c_str());
    std::fflush(log_);
  }

  void log_status(std::string const& op, int64_t self, int64_t tid, int64_t task_id,
                  ThreadState state, std::string const& notes = "")
  {
    log_line(op.c_str(), self, tid, task_id, state_name(state), "", notes);
  }

  void log_transition(int64_t self, int64_t tid, int64_t task_id, ThreadState from,
                      ThreadState to, std::string const& notes = "")
  {
    log_line("TRANSITION", self, tid, task_id, state_name(from), state_name(to), notes);
  }

  std::mutex mu_;
  std::condition_variable woken_cv_;
  std::map<int64_t, ThreadRec> threads_;
  std::map<int64_t, std::set<int64_t>> task_threads_;
  std::map<int64_t, Metrics> task_metrics_;
  bool shutting_down_ = false;
  int retry_limit_;
  std::FILE* log_ = nullptr;
  bool owns_log_  = false;
};

template <typename F>
int guarded(F&& f)
{
  try {
    f();
    return SRA_OK;
  } catch (StatusError const& e) {
    g_last_error = e.msg;
    return e.code;
  } catch (std::exception const& e) {
    g_last_error = e.what();
    return SRA_INVALID;
  }
}

}  // namespace

extern "C" {

void* sra_create(char const* log_loc)
{
  try {
    return new ResourceArbiter(log_loc ? log_loc : "");
  } catch (StatusError const& e) {
    g_last_error = e.msg;
    return nullptr;
  } catch (std::exception const& e) {
    g_last_error = e.what();
    return nullptr;
  }
}

void sra_destroy(void* h) { delete static_cast<ResourceArbiter*>(h); }

char const* sra_last_error() { return g_last_error.c_str(); }

void sra_set_retry_limit(void* h, int limit)
{
  static_cast<ResourceArbiter*>(h)->set_retry_limit(limit);
}

int sra_start_dedicated_task_thread(void* h, int64_t tid, int64_t task_id, int64_t self)
{
  return guarded([&] {
    static_cast<ResourceArbiter*>(h)->start_dedicated_task_thread(tid, task_id, self);
  });
}

int sra_pool_thread_working_on_tasks(void* h, int is_shuffle, int64_t tid,
                                     int64_t const* task_ids, int n, int64_t self)
{
  return guarded([&] {
    static_cast<ResourceArbiter*>(h)->pool_thread_working_on_tasks(
      is_shuffle != 0, tid, std::vector<int64_t>(task_ids, task_ids + n), self);
  });
}

int sra_pool_thread_finished_for_tasks(void* h, int64_t tid, int64_t const* task_ids, int n,
                                       int64_t self)
{
  return guarded([&] {
    static_cast<ResourceArbiter*>(h)->pool_thread_finished_for_tasks(
      tid, std::vector<int64_t>(task_ids, task_ids + n), self);
  });
}

int sra_remove_thread_association(void* h, int64_t tid, int64_t task_id, int64_t self)
{
  return guarded(
    [&] { static_cast<ResourceArbiter*>(h)->remove_thread_association(tid, task_id, self); });
}

int sra_task_done(void* h, int64_t task_id, int64_t self)
{
  return guarded([&] { static_cast<ResourceArbiter*>(h)->task_done(task_id, self); });
}

// Returns SRA_OK when quiesced; SRA_BUSY when some thread never exited within
// the bounded wait, in which case the handle must be leaked, not destroyed.
int sra_all_done(void* h, int64_t self)
{
  int rc = SRA_OK;
  int g  = guarded([&] {
    if (!static_cast<ResourceArbiter*>(h)->all_done(self)) rc = SRA_BUSY;
  });
  return g != SRA_OK ? g : rc;
}

int sra_set_pool_blocked(void* h, int64_t tid, int blocked)
{
  return guarded([&] { static_cast<ResourceArbiter*>(h)->set_pool_blocked(tid, blocked != 0); });
}

int sra_set_thread_blocked_hint(void* h, int64_t tid, int blocked)
{
  return guarded(
    [&] { static_cast<ResourceArbiter*>(h)->set_external_blocked(tid, blocked != 0); });
}

int sra_start_retry_block(void* h, int64_t tid)
{
  return guarded([&] { static_cast<ResourceArbiter*>(h)->start_retry_block(tid); });
}

int sra_end_retry_block(void* h, int64_t tid)
{
  return guarded([&] { static_cast<ResourceArbiter*>(h)->end_retry_block(tid); });
}

int sra_force_retry_oom(void* h, int64_t tid, int num, int filter, int skip)
{
  return guarded([&] { static_cast<ResourceArbiter*>(h)->force_retry_oom(tid, num, filter, skip); });
}

int sra_force_split_retry_oom(void* h, int64_t tid, int num, int filter, int skip)
{
  return guarded(
    [&] { static_cast<ResourceArbiter*>(h)->force_split_retry_oom(tid, num, filter, skip); });
}

int sra_force_exception(void* h, int64_t tid, int num)
{
  return guarded([&] { static_cast<ResourceArbiter*>(h)->force_exception(tid, num); });
}

// recursive_out receives 1 when this is a recursive (spill-path) allocation.
int sra_pre_alloc(void* h, int64_t tid, int is_cpu, int blocking, int64_t self,
                  int* recursive_out)
{
  return guarded([&] {
    bool const rec =
      static_cast<ResourceArbiter*>(h)->pre_alloc(tid, is_cpu != 0, blocking != 0, self);
    if (recursive_out) *recursive_out = rec ? 1 : 0;
  });
}

int sra_post_alloc_success(void* h, int64_t tid, int is_cpu, int was_recursive, int64_t self)
{
  return guarded([&] {
    static_cast<ResourceArbiter*>(h)->post_alloc_success(tid, is_cpu != 0, was_recursive != 0,
                                                         self);
  });
}

// retry_out receives 1 when the caller should loop and retry the allocation.
int sra_post_alloc_failed(void* h, int64_t tid, int is_cpu, int was_oom, int blocking,
                          int was_recursive, int64_t self, int* retry_out)
{
  return guarded([&] {
    bool const retry = static_cast<ResourceArbiter*>(h)->post_alloc_failed(
      tid, is_cpu != 0, was_oom != 0, blocking != 0, was_recursive != 0, self);
    if (retry_out) *retry_out = retry ? 1 : 0;
  });
}

int sra_dealloc(void* h, int64_t tid, int is_cpu, int64_t self)
{
  return guarded([&] { static_cast<ResourceArbiter*>(h)->dealloc(tid, is_cpu != 0, self); });
}

int sra_block_thread_until_ready(void* h, int64_t tid, int64_t self)
{
  return guarded([&] { static_cast<ResourceArbiter*>(h)->block_thread_until_ready(tid, self); });
}

int sra_check_and_break_deadlocks(void* h, int64_t self)
{
  return guarded([&] { static_cast<ResourceArbiter*>(h)->check_and_break_deadlocks(self); });
}

int sra_get_thread_state(void* h, int64_t tid)
{
  return static_cast<ResourceArbiter*>(h)->get_thread_state(tid);
}

int64_t sra_get_and_reset_num_retry(void* h, int64_t task_id)
{
  return static_cast<ResourceArbiter*>(h)->drain_metric(task_id, &Metrics::num_retry);
}

int64_t sra_get_and_reset_num_split_retry(void* h, int64_t task_id)
{
  return static_cast<ResourceArbiter*>(h)->drain_metric(task_id, &Metrics::num_split_retry);
}

int64_t sra_get_and_reset_block_time_ns(void* h, int64_t task_id)
{
  return static_cast<ResourceArbiter*>(h)->drain_metric(task_id, &Metrics::blocked_nanos);
}

int64_t sra_get_and_reset_lost_time_ns(void* h, int64_t task_id)
{
  return static_cast<ResourceArbiter*>(h)->drain_metric(task_id, &Metrics::lost_nanos);
}

}  // extern "C"
