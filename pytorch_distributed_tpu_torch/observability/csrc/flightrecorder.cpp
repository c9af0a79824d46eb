// flightrecorder — C++ ring buffer of collective operations + stall watchdog.
//
// The port's own copy of the reference's native/flightrecorder.cpp (the
// same C interface and dump format), built by ops/_build.py's host route
// and loaded by observability/flight_recorder.py.
//
// Capability parity (SURVEY.md §2.6 / §2.8 items 8-9):
//   * c10d::FlightRecorder (FlightRecorder.hpp:117 Entry, record:220,
//     dump_entries:243): every enqueued collective is recorded with op name,
//     sizes, status and timestamps into a fixed-capacity ring buffer that can
//     be dumped on hang for post-mortem ("which rank stopped at which op").
//   * the ProcessGroupNCCL watchdog role (ProcessGroupNCCL.hpp:71-137):
//     a monitor thread that notices when the oldest in-flight op exceeds a
//     timeout, dumps the ring buffer to a file, and flips a stall flag the
//     Python layer polls (abort policy stays in Python).
//
// C API (ctypes-bound, no pybind11): create/free, record/complete, dump to
// a malloc'd JSON string or a file, watchdog start/stop, stall flag.

#include <algorithm>
#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

using Clock = std::chrono::system_clock;

double now_s() {
  return std::chrono::duration<double>(Clock::now().time_since_epoch())
      .count();
}

enum Status : int32_t { SCHEDULED = 0, COMPLETED = 1, FAILED = 2 };

struct Entry {
  int64_t id = -1;
  char op[64] = {0};
  char group[64] = {0};
  int64_t bytes = 0;
  int32_t status = SCHEDULED;
  double t_sched = 0.0;
  double t_done = 0.0;
};

const char* status_str(int32_t s) {
  switch (s) {
    case COMPLETED: return "completed";
    case FAILED: return "failed";
    default: return "scheduled";
  }
}

struct Recorder {
  std::mutex mu;
  std::vector<Entry> ring;
  size_t capacity;
  int64_t next_id = 0;

  // watchdog
  std::thread wd_thread;
  std::condition_variable wd_cv;
  std::mutex wd_mu;
  bool wd_stop = false;
  std::atomic<bool> stalled{false};
  std::string dump_path;
  double stall_timeout_s = 0.0;

  explicit Recorder(size_t cap) : capacity(cap ? cap : 1) {
    ring.reserve(capacity);
  }

  ~Recorder() { stop_watchdog(); }

  int64_t record(const char* op, const char* group, int64_t bytes) {
    std::lock_guard<std::mutex> g(mu);
    Entry e;
    e.id = next_id++;
    snprintf(e.op, sizeof(e.op), "%s", op ? op : "");
    snprintf(e.group, sizeof(e.group), "%s", group ? group : "");
    e.bytes = bytes;
    e.t_sched = now_s();
    if (ring.size() < capacity) {
      ring.push_back(e);
    } else {
      ring[(size_t)(e.id % (int64_t)capacity)] = e;
    }
    return e.id;
  }

  bool complete(int64_t id, bool ok) {
    std::lock_guard<std::mutex> g(mu);
    Entry* e = find(id);
    if (!e) return false;
    e->status = ok ? COMPLETED : FAILED;
    e->t_done = now_s();
    return true;
  }

  Entry* find(int64_t id) {
    if (ring.empty() || id < 0) return nullptr;
    Entry& e = ring[(size_t)(id % (int64_t)capacity)];
    return e.id == id ? &e : nullptr;  // overwritten entries don't match
  }

  // age (seconds) of the oldest still-scheduled entry, or -1 if none
  double oldest_inflight_age() {
    std::lock_guard<std::mutex> g(mu);
    double oldest = -1.0, now = now_s();
    for (const auto& e : ring) {
      if (e.status == SCHEDULED) {
        double age = now - e.t_sched;
        if (age > oldest) oldest = age;
      }
    }
    return oldest;
  }

  std::string dump_json() {
    std::lock_guard<std::mutex> g(mu);
    // entries in id order (ring may wrap)
    std::vector<const Entry*> sorted;
    for (const auto& e : ring) sorted.push_back(&e);
    std::sort(sorted.begin(), sorted.end(),
              [](const Entry* a, const Entry* b) { return a->id < b->id; });
    std::string out = "{\"entries\":[";
    bool first = true;
    char buf[512];
    for (const Entry* e : sorted) {
      snprintf(buf, sizeof(buf),
               "%s{\"id\":%lld,\"op\":\"%s\",\"group\":\"%s\",\"bytes\":%lld,"
               "\"status\":\"%s\",\"t_sched\":%.6f,\"t_done\":%.6f}",
               first ? "" : ",", (long long)e->id, e->op, e->group,
               (long long)e->bytes, status_str(e->status), e->t_sched,
               e->t_done);
      out += buf;
      first = false;
    }
    out += "]}";
    return out;
  }

  bool dump_to_file(const char* path) {
    std::string j = dump_json();
    FILE* f = fopen(path, "w");
    if (!f) return false;
    fwrite(j.data(), 1, j.size(), f);
    fclose(f);
    return true;
  }

  void start_watchdog(double timeout_s, const char* path,
                      double poll_interval_s) {
    stop_watchdog();
    {
      std::lock_guard<std::mutex> g(wd_mu);
      wd_stop = false;
    }
    stall_timeout_s = timeout_s;
    dump_path = path ? path : "";
    stalled = false;
    wd_thread = std::thread([this, poll_interval_s] {
      std::unique_lock<std::mutex> lk(wd_mu);
      while (!wd_cv.wait_for(
          lk, std::chrono::duration<double>(poll_interval_s),
          [this] { return wd_stop; })) {
        double age = oldest_inflight_age();
        if (age >= 0 && age > stall_timeout_s && !stalled.exchange(true)) {
          if (!dump_path.empty()) dump_to_file(dump_path.c_str());
        }
      }
    });
  }

  void stop_watchdog() {
    {
      std::lock_guard<std::mutex> g(wd_mu);
      wd_stop = true;
    }
    wd_cv.notify_all();
    if (wd_thread.joinable()) wd_thread.join();
  }
};

}  // namespace

extern "C" {

void* tpufr_create(int64_t capacity) { return new Recorder((size_t)capacity); }
void tpufr_free(void* r) { delete (Recorder*)r; }

int64_t tpufr_record(void* r, const char* op, const char* group,
                     int64_t bytes) {
  return ((Recorder*)r)->record(op, group, bytes);
}

int tpufr_complete(void* r, int64_t id, int ok) {
  return ((Recorder*)r)->complete(id, ok != 0) ? 0 : -1;
}

// malloc'd JSON; free with tpufr_buf_free
char* tpufr_dump_json(void* r) {
  std::string j = ((Recorder*)r)->dump_json();
  char* out = (char*)malloc(j.size() + 1);
  if (!out) return nullptr;
  memcpy(out, j.data(), j.size());
  out[j.size()] = 0;
  return out;
}

void tpufr_buf_free(char* p) { free(p); }

int tpufr_dump_file(void* r, const char* path) {
  return ((Recorder*)r)->dump_to_file(path) ? 0 : -1;
}

double tpufr_oldest_inflight_age(void* r) {
  return ((Recorder*)r)->oldest_inflight_age();
}

void tpufr_watchdog_start(void* r, double timeout_s, const char* dump_path,
                          double poll_interval_s) {
  ((Recorder*)r)->start_watchdog(timeout_s, dump_path, poll_interval_s);
}

void tpufr_watchdog_stop(void* r) { ((Recorder*)r)->stop_watchdog(); }

int tpufr_stalled(void* r) { return ((Recorder*)r)->stalled ? 1 : 0; }

}  // extern "C"
