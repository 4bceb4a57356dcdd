// Native batched procfs/sysfs readers + text-exposition renderer — the
// host-side hot path.
//
// Reference parity: the per-PID /proc/<pid>/stat scan of
// internal/resource/procfs_reader.go (CPUTime = (utime+stime)/USER_HZ,
// :73-82), the /proc/stat usage-ratio totals (:107-141), the per-zone
// energy_uj reads of internal/device/rapl_sysfs_power_meter.go, and the
// classic-text sample rendering the reference gets from Go's
// prometheus/common/expfmt — but done as ONE C call per tick/scrape
// instead of thousands of Python open/read/parse (or format/append)
// round-trips. The procfs scan, not the device
// math, is the per-node bottleneck; this file is its fast path.
//
// Pure C ABI (called via ctypes — no pybind11 in this toolchain). Callers
// own every OUTPUT buffer; the scan allocates transient working vectors
// (dirent names + per-entry results) and, for large trees, a few
// short-lived threads. All C++ exceptions are caught at the ABI boundary
// and surfaced as -1 (callers fall back to the pure-Python paths) — no
// exception may unwind into ctypes frames.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>

#include <charconv>
#include <cmath>

#include <dirent.h>
#include <fcntl.h>
#include <sys/resource.h>
#include <unistd.h>

#include <algorithm>
#include <atomic>
#include <mutex>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

// Reference hardcodes USER_HZ=100 (procfs_reader.go:73-82); Linux has had
// CONFIG_HZ-independent USER_HZ=100 since 2.6, so parity and correctness
// agree.
constexpr double kUserHz = 100.0;

// comm slot width in the scan output: TASK_COMM_LEN is 16 (15 chars +
// NUL) on every kernel, but test fixtures may write longer names, so
// slots are 32 bytes (31 chars + NUL) to keep native/Python readers
// byte-identical on synthetic trees too.
constexpr int kCommSlot = 32;

// Read a small file fully into buf (NUL-terminated). Returns bytes read or
// -1. procfs files must be read in one pass; short buffers truncate safely.
int ReadSmallFile(const char* path, char* buf, int cap) {
  int fd = open(path, O_RDONLY | O_CLOEXEC);
  if (fd < 0) return -1;
  int n = 0;
  while (n < cap - 1) {
    ssize_t r = read(fd, buf + n, cap - 1 - n);
    if (r < 0) {
      close(fd);
      return -1;
    }
    if (r == 0) break;
    n += static_cast<int>(r);
  }
  close(fd);
  buf[n] = '\0';
  return n;
}

bool AllDigits(const char* s) {
  if (*s == '\0') return false;
  for (; *s; ++s) {
    if (*s < '0' || *s > '9') return false;
  }
  return true;
}

// Worker-thread count for a batch of n independent file operations. The
// work is syscall-latency bound; the kernel serves independent /proc
// files concurrently. Small batches stay single-threaded (threads cost
// more than they save). KEPLER_SCAN_THREADS overrides (0 = auto).
unsigned ThreadsFor(size_t n) {
  static int env_threads = [] {
    const char* s = getenv("KEPLER_SCAN_THREADS");
    return s != nullptr ? atoi(s) : 0;
  }();
  if (env_threads > 0) return std::min<unsigned>(env_threads, 64);
  unsigned hw = std::thread::hardware_concurrency();
  if (n <= 512 || hw <= 1) return 1;
  // one thread per ~1k entries, capped by cores and a sane ceiling
  unsigned want = static_cast<unsigned>((n + 1023) / 1024);
  return std::min({want, hw, 16u});
}

// Run work(lo, hi) over [0, n) on ThreadsFor(n) threads. Exceptions from
// spawning propagate after joining what started (a joinable thread's
// destructor would terminate()).
template <typename Fn>
void ParallelFor(size_t n, Fn work) {
  unsigned nt = ThreadsFor(n);
  if (nt <= 1) {
    work(static_cast<size_t>(0), n);
    return;
  }
  std::vector<std::thread> threads;
  threads.reserve(nt);
  const size_t chunk = (n + nt - 1) / nt;
  try {
    for (unsigned t = 0; t < nt; ++t) {
      const size_t lo = t * chunk;
      if (lo >= n) break;
      threads.emplace_back(work, lo, std::min(lo + chunk, n));
    }
  } catch (...) {
    for (auto& th : threads) th.join();
    throw;
  }
  for (auto& th : threads) th.join();
}

// ---- float formatting (Python-repr + prometheus floatToGoString) --------
//
// The classic-text renderer must be byte-identical to
// prometheus_client.utils.floatToGoString, which is Python repr() plus a
// Go-style mantissa-exponent munge for positive fixed-notation values
// with >6 integer digits. Python repr is shortest-roundtrip digits
// (unique — Ryu/Grisu class algorithms agree) formatted fixed when the
// decimal exponent is in [-4, 16) and scientific (e±XX, ≥2 exponent
// digits) otherwise. std::to_chars(scientific) yields exactly those
// shortest digits; this reformats them per Python's rules.

// Python repr(float). Returns length. out must hold ≥40 bytes.
int PyReprDouble(double v, char* out) {
  if (v == 0.0) {
    if (std::signbit(v)) {
      memcpy(out, "-0.0", 5);
      return 4;
    }
    memcpy(out, "0.0", 4);
    return 3;
  }
  char sci[40];
  auto res = std::to_chars(sci, sci + sizeof(sci), v,
                           std::chars_format::scientific);
  *res.ptr = '\0';
  const char* p = sci;
  bool neg = (*p == '-');
  if (neg) ++p;
  char digits[24];
  int nd = 0;
  digits[nd++] = *p++;
  if (*p == '.') {
    ++p;
    while (*p != '\0' && *p != 'e') digits[nd++] = *p++;
  }
  int exp10 = atoi(p + 1);  // *p == 'e'
  char* q = out;
  if (neg) *q++ = '-';
  if (exp10 >= -4 && exp10 < 16) {
    if (exp10 >= nd - 1) {  // integral: digits, zeros, ".0"
      memcpy(q, digits, nd);
      q += nd;
      for (int i = 0; i < exp10 - (nd - 1); ++i) *q++ = '0';
      *q++ = '.';
      *q++ = '0';
    } else if (exp10 >= 0) {  // dot inside the digit run
      memcpy(q, digits, exp10 + 1);
      q += exp10 + 1;
      *q++ = '.';
      memcpy(q, digits + exp10 + 1, nd - exp10 - 1);
      q += nd - exp10 - 1;
    } else {  // 0.00ddd
      *q++ = '0';
      *q++ = '.';
      for (int i = 0; i < -exp10 - 1; ++i) *q++ = '0';
      memcpy(q, digits, nd);
      q += nd;
    }
  } else {  // scientific, exponent ≥2 digits with sign (Python style)
    *q++ = digits[0];
    if (nd > 1) {
      *q++ = '.';
      memcpy(q, digits + 1, nd - 1);
      q += nd - 1;
    }
    *q++ = 'e';
    *q++ = exp10 < 0 ? '-' : '+';
    int e = exp10 < 0 ? -exp10 : exp10;
    if (e < 10) {
      *q++ = '0';
      *q++ = static_cast<char>('0' + e);
    } else {
      char tmp[8];
      int t = 0;
      while (e > 0) {
        tmp[t++] = static_cast<char>('0' + e % 10);
        e /= 10;
      }
      while (t > 0) *q++ = tmp[--t];
    }
  }
  *q = '\0';
  return static_cast<int>(q - out);
}

// floatToGoString. out must hold ≥48 bytes. Returns length.
int FmtGoDouble(double v, char* out) {
  if (std::isnan(v)) {
    memcpy(out, "NaN", 4);
    return 3;
  }
  if (std::isinf(v)) {
    memcpy(out, v > 0 ? "+Inf" : "-Inf", 5);
    return 4;
  }
  char repr[40];
  int rlen = PyReprDouble(v, repr);
  const char* dot = static_cast<const char*>(memchr(repr, '.', rlen));
  int dotpos = dot != nullptr ? static_cast<int>(dot - repr) : -1;
  if (v > 0 && dotpos > 6) {
    // mantissa = repr[0] '.' (repr digits sans dot), rstrip any of "0."
    char m[44];
    int k = 0;
    m[k++] = repr[0];
    m[k++] = '.';
    for (int i = 1; i < rlen; ++i) {
      if (i != dotpos) m[k++] = repr[i];
    }
    while (k > 0 && (m[k - 1] == '0' || m[k - 1] == '.')) --k;
    m[k] = '\0';
    // Python: f"{mantissa}e+0{dot-1}" — literal '0' prefix, no width pad
    return snprintf(out, 48, "%se+0%d", m, dotpos - 1);
  }
  memcpy(out, repr, rlen + 1);
  return rlen;
}

}  // namespace

extern "C" {

// ABI version for the ctypes loader to sanity-check.
int kepler_native_abi_version() { return 3; }

// Parse a <pid>/stat buffer (mutated in place); true on success.
// Thread-safe: all state is caller-provided. comm receives the
// (NUL-terminated, ≤kCommSlot-1 byte) command name from the stat line —
// the same field /proc/<pid>/comm serves, so readers need no separate
// comm read per tick.
static bool ParseStatBuf(char* buf, const char* name, int32_t* pid,
                         double* cpu_seconds, char* comm) {
  // comm may contain spaces/parens; fields resume after the LAST ')'
  // (same parse as the Python reader and the reference's procfs lib).
  char* lparen = strchr(buf, '(');
  char* rparen = strrchr(buf, ')');
  if (lparen == nullptr || rparen == nullptr || rparen < lparen ||
      rparen[1] == '\0') {
    return false;
  }
  if (comm != nullptr) {
    int clen = std::min<int>(static_cast<int>(rparen - lparen) - 1,
                             kCommSlot - 1);
    if (clen < 0) clen = 0;
    memcpy(comm, lparen + 1, clen);
    memset(comm + clen, 0, kCommSlot - clen);
  }
  char* rest = rparen + 2;
  // After the ')' the next fields are state(0) ... utime(11) stime(12),
  // 0-indexed — i.e. stat fields 14 and 15 in proc(5) numbering.
  unsigned long long utime = 0, stime = 0;
  int tok = 0;
  bool ok = false;
  char* save = nullptr;
  for (char* t = strtok_r(rest, " ", &save); t != nullptr;
       t = strtok_r(nullptr, " ", &save), ++tok) {
    // endptr checks: a corrupt stat line (non-numeric utime/stime) must
    // skip the process, matching the pure-Python reader's raise-and-skip
    // semantics — not admit it with cpu_seconds=0. strtok_r tokens are
    // NUL-terminated, so a fully-numeric token ends exactly at '\0'.
    char* end = nullptr;
    if (tok == 11) {
      utime = strtoull(t, &end, 10);
      if (end == t || *end != '\0') return false;
    } else if (tok == 12) {
      stime = strtoull(t, &end, 10);
      if (end == t || *end != '\0') return false;
      ok = true;
      break;
    }
  }
  if (!ok) return false;
  *pid = static_cast<int32_t>(strtol(name, nullptr, 10));
  *cpu_seconds = static_cast<double>(utime + stime) / kUserHz;
  return true;
}

// Read + parse one <pid>/stat file; true on success.
static bool ParseProcStat(const char* procfs, const char* name,
                          int32_t* pid, double* cpu_seconds, char* comm) {
  char path[512];
  char buf[4096];
  snprintf(path, sizeof(path), "%s/%s/stat", procfs, name);
  if (ReadSmallFile(path, buf, sizeof(buf)) <= 0) return false;
  return ParseStatBuf(buf, name, pid, cpu_seconds, comm);
}

// Scan every numeric entry of `procfs`, parse <pid>/stat, and fill
// pids[i] / cpu_seconds[i] / comms[i*32] with the PID, cpu seconds
// ((utime+stime)/USER_HZ), and command name (NUL-terminated 32-byte
// slots; pass NULL to skip). Returns the number of entries filled, -1 if
// procfs can't be opened, or -2 if more than `cap` processes exist
// (caller retries with a bigger buffer). PIDs that vanish mid-scan are
// skipped, matching the reference's skip-on-ESRCH behavior
// (informer.go:186-190).
//
// Large trees fan the per-PID open/read/parse out to worker threads (see
// ThreadsFor). Output order stays the directory order regardless of
// thread count.
int kepler_scan_procs(const char* procfs, int32_t* pids, double* cpu_seconds,
                      char* comms, int32_t cap) try {
  DIR* dir = opendir(procfs);
  if (dir == nullptr) return -1;
  std::vector<std::string> names;
  struct dirent* entry;
  while ((entry = readdir(dir)) != nullptr) {
    if (AllDigits(entry->d_name)) names.emplace_back(entry->d_name);
  }
  closedir(dir);
  const size_t n = names.size();
  if (cap < 0) return -1;  // -2 would make callers grow-and-retry forever
  if (n > static_cast<size_t>(cap)) return -2;

  std::vector<int32_t> got_pid(n);
  std::vector<double> got_cpu(n);
  std::vector<char> got_comm(comms != nullptr ? n * kCommSlot : 0);
  std::vector<char> ok(n, 0);  // vector<bool> is not thread-writable
  ParallelFor(n, [&](size_t lo, size_t hi) {
    for (size_t i = lo; i < hi; ++i) {
      ok[i] = ParseProcStat(
          procfs, names[i].c_str(), &got_pid[i], &got_cpu[i],
          comms != nullptr ? &got_comm[i * kCommSlot] : nullptr);
    }
  });
  int count = 0;
  for (size_t i = 0; i < n; ++i) {
    if (!ok[i]) continue;
    pids[count] = got_pid[i];
    cpu_seconds[count] = got_cpu[i];
    if (comms != nullptr) {
      memcpy(comms + static_cast<size_t>(count) * kCommSlot,
             &got_comm[i * kCommSlot], kCommSlot);
    }
    ++count;
  }
  return count;
} catch (...) {
  // bad_alloc / system_error must not unwind into ctypes frames; -1 sends
  // callers to the pure-Python reader (graceful-degradation contract)
  return -1;
}

// ---- stateful scan handle (fd cache + pread) ----------------------------
//
// The one-shot scan pays open+read+close (3 syscalls + 2 path walks) per
// PID per tick. A monitoring daemon reads the SAME files every tick, so
// the handle keeps each PID's stat fd open across ticks and does ONE
// pread per live PID (measured 5× faster at 10k procs on a 1-core
// host). procfs semantics make this sound: a stat fd of a dead task
// reads 0/ESRCH (it does not pin the task), which both detects
// termination and guards PID reuse — on any failed pread the fd is
// reopened once via openat before the PID is declared gone. The fd
// budget respects RLIMIT_NOFILE with headroom; PIDs beyond it fall back
// to open/pread/close per tick.

struct ScanHandle {
  std::mutex mu;  // calls are cheap; callers may share a handle
  std::string procfs;
  int dfd = -1;  // procfs dirfd for openat ("<pid>/stat" relative paths)
  struct Entry {
    int fd;
    uint64_t epoch;
  };
  std::unordered_map<int32_t, Entry> fds;
  size_t max_fds = 0;
  uint64_t epoch = 0;
};

// Cached stat fds across ALL handles — many-handle processes (test
// suites over many fake trees) share one RLIMIT_NOFILE.
static std::atomic<size_t> g_cached_fds{0};

// Open a scan handle for `procfs`. max_fds caps the fd cache (0 = derive
// from RLIMIT_NOFILE with 1024 headroom, capped at 65536). NULL on error.
void* kepler_scan_open(const char* procfs, int32_t max_fds) try {
  int dfd = open(procfs, O_RDONLY | O_DIRECTORY | O_CLOEXEC);
  if (dfd < 0) return nullptr;
  auto* h = new ScanHandle();
  h->procfs = procfs;
  h->dfd = dfd;
  if (max_fds > 0) {
    h->max_fds = static_cast<size_t>(max_fds);
  } else {
    // derive from RLIMIT_NOFILE in every case — a flat default could
    // exhaust the whole limit on low-rlimit hosts (the rest of the agent
    // needs sockets/sysfs fds too). Generous limits keep 1024 headroom;
    // tight ones cede half. PIDs past the budget still scan, just via
    // the uncached open/pread/close path.
    rlimit rl{};
    size_t budget = 256;
    if (getrlimit(RLIMIT_NOFILE, &rl) == 0 && rl.rlim_cur > 0) {
      size_t cur = static_cast<size_t>(rl.rlim_cur);
      budget = cur > 2048 ? cur - 1024 : cur / 2;
    }
    h->max_fds = std::min<size_t>(budget, 65536);
  }
  return h;
} catch (...) {
  return nullptr;
}

void kepler_scan_free(void* handle) {
  if (handle == nullptr) return;
  auto* h = static_cast<ScanHandle*>(handle);
  for (auto& kv : h->fds) close(kv.second.fd);
  g_cached_fds.fetch_sub(h->fds.size());
  close(h->dfd);
  delete h;
}

// One tick: enumerate `procfs`, pread every live PID's stat (cached fd
// when available), fill pids/cpu_seconds/comms exactly like
// kepler_scan_procs. Returns count, -1 on error, -2 when cap is too
// small.
int kepler_scan_tick(void* handle, int32_t* pids, double* cpu_seconds,
                     char* comms, int32_t cap) try {
  if (handle == nullptr || cap < 0) return -1;
  auto* h = static_cast<ScanHandle*>(handle);
  std::lock_guard<std::mutex> lock(h->mu);
  DIR* dir = opendir(h->procfs.c_str());
  if (dir == nullptr) return -1;
  std::vector<std::string> names;
  struct dirent* entry;
  while ((entry = readdir(dir)) != nullptr) {
    if (AllDigits(entry->d_name)) names.emplace_back(entry->d_name);
  }
  closedir(dir);
  const size_t n = names.size();
  if (n > static_cast<size_t>(cap)) return -2;
  ++h->epoch;

  // split: rows with a cached fd (pread, parallel-safe — no map writes)
  // vs first-sight rows (openat below, serial map inserts)
  std::vector<int32_t> name_pid(n);
  std::vector<int> row_fd(n, -1);
  for (size_t i = 0; i < n; ++i) {
    name_pid[i] = static_cast<int32_t>(strtol(names[i].c_str(), nullptr, 10));
    auto it = h->fds.find(name_pid[i]);
    if (it != h->fds.end()) {
      row_fd[i] = it->second.fd;
      it->second.epoch = h->epoch;
    }
  }
  std::vector<int32_t> got_pid(n);
  std::vector<double> got_cpu(n);
  std::vector<char> got_comm(comms != nullptr ? n * kCommSlot : 0);
  std::vector<char> ok(n, 0);
  std::vector<char> need_reopen(n, 0);
  ParallelFor(n, [&](size_t lo, size_t hi) {
    char buf[4096];
    for (size_t i = lo; i < hi; ++i) {
      if (row_fd[i] < 0) continue;
      ssize_t r = pread(row_fd[i], buf, sizeof(buf) - 1, 0);
      if (r <= 0) {
        // dead task behind the fd (or PID reuse): retry via openat below
        need_reopen[i] = 1;
        continue;
      }
      buf[r] = '\0';
      ok[i] = ParseStatBuf(buf, names[i].c_str(), &got_pid[i], &got_cpu[i],
                           comms != nullptr ? &got_comm[i * kCommSlot]
                                            : nullptr);
      if (!ok[i]) need_reopen[i] = 1;  // corrupt read: retry once fresh
    }
  });
  // first sight + reopen rows (serial: mutates the fd map)
  char buf[4096];
  char rel[320];
  for (size_t i = 0; i < n; ++i) {
    if (row_fd[i] >= 0 && !need_reopen[i]) continue;
    if (need_reopen[i]) {
      auto it = h->fds.find(name_pid[i]);
      if (it != h->fds.end()) {
        close(it->second.fd);
        g_cached_fds.fetch_sub(1);
        h->fds.erase(it);
      }
      ok[i] = 0;
    }
    snprintf(rel, sizeof(rel), "%s/stat", names[i].c_str());
    int fd = openat(h->dfd, rel, O_RDONLY | O_CLOEXEC);
    if (fd < 0) continue;  // vanished mid-scan
    ssize_t r = pread(fd, buf, sizeof(buf) - 1, 0);
    if (r <= 0) {
      close(fd);
      continue;
    }
    buf[r] = '\0';
    ok[i] = ParseStatBuf(buf, names[i].c_str(), &got_pid[i], &got_cpu[i],
                         comms != nullptr ? &got_comm[i * kCommSlot]
                                          : nullptr);
    if (ok[i] && g_cached_fds.load() < h->max_fds) {
      h->fds.emplace(name_pid[i], ScanHandle::Entry{fd, h->epoch});
      g_cached_fds.fetch_add(1);
    } else {
      close(fd);
    }
  }
  // sweep fds of vanished PIDs
  for (auto it = h->fds.begin(); it != h->fds.end();) {
    if (it->second.epoch != h->epoch) {
      close(it->second.fd);
      g_cached_fds.fetch_sub(1);
      it = h->fds.erase(it);
    } else {
      ++it;
    }
  }
  int count = 0;
  for (size_t i = 0; i < n; ++i) {
    if (!ok[i]) continue;
    pids[count] = got_pid[i];
    cpu_seconds[count] = got_cpu[i];
    if (comms != nullptr) {
      memcpy(comms + static_cast<size_t>(count) * kCommSlot,
             &got_comm[i * kCommSlot], kCommSlot);
    }
    ++count;
  }
  return count;
} catch (...) {
  return -1;
}

// Aggregate 'cpu' line of <procfs>/stat → (active, total) jiffies, where
// active = total − idle − iowait (procfs_reader.go:107-141). Returns 0 on
// success.
int kepler_read_stat_totals(const char* procfs, double* active,
                            double* total) {
  char path[512];
  char buf[8192];
  snprintf(path, sizeof(path), "%s/stat", procfs);
  if (ReadSmallFile(path, buf, sizeof(buf)) <= 0) return -1;
  if (strncmp(buf, "cpu", 3) != 0) return -1;
  char* nl = strchr(buf, '\n');
  if (nl != nullptr) *nl = '\0';
  char* save = nullptr;
  char* t = strtok_r(buf, " ", &save);  // consumes the "cpu" label
  if (t == nullptr) return -1;
  double sum = 0.0, idle = 0.0, iowait = 0.0;
  int i = 0;
  for (t = strtok_r(nullptr, " ", &save); t != nullptr;
       t = strtok_r(nullptr, " ", &save), ++i) {
    double v = strtod(t, nullptr);
    sum += v;
    if (i == 3) idle = v;
    if (i == 4) iowait = v;
  }
  *active = sum - idle - iowait;
  *total = sum;
  return 0;
}

// Batch-read `n` counter files (NUL-separated concatenated `paths`,
// e.g. RAPL energy_uj) into out[i]; failed reads leave UINT64_MAX (the
// batched analog of the reference's per-zone skip-on-error, node.go:39-44).
// Returns the number of successful reads.
int kepler_read_counter_files(const char* paths, int32_t n, uint64_t* out) {
  const char* p = paths;
  int ok = 0;
  char buf[64];
  for (int i = 0; i < n; ++i) {
    out[i] = UINT64_MAX;
    if (ReadSmallFile(p, buf, sizeof(buf)) > 0) {
      char* end = nullptr;
      unsigned long long v = strtoull(buf, &end, 10);
      if (end != buf) {
        out[i] = v;
        ++ok;
      }
    }
    p += strlen(p) + 1;
  }
  return ok;
}

// Batch-read `n` small files (NUL-separated concatenated `paths`) into
// fixed `per_cap`-byte slots of `out` (contents NUL-terminated,
// truncated at per_cap-1). sizes[i] = bytes read, or -1 on failure.
// Threaded like the proc scan — this keeps first-sight classification
// bursts (mass pod reschedule) on the native path: Python hands over the
// cgroup/cmdline/environ paths of every NEW pid and gets all contents in
// one call. Returns the number of successful reads, or -1 on internal
// failure.
int kepler_read_files(const char* paths, int32_t n, char* out,
                      int32_t per_cap, int32_t* sizes) try {
  if (n < 0 || per_cap < 2) return -1;
  std::vector<const char*> ptrs(n);
  const char* p = paths;
  for (int i = 0; i < n; ++i) {
    ptrs[i] = p;
    p += strlen(p) + 1;
  }
  ParallelFor(static_cast<size_t>(n), [&](size_t lo, size_t hi) {
    for (size_t i = lo; i < hi; ++i) {
      sizes[i] = ReadSmallFile(ptrs[i], out + i * per_cap, per_cap);
    }
  });
  int ok = 0;
  for (int i = 0; i < n; ++i) {
    if (sizes[i] >= 0) ++ok;
  }
  return ok;
} catch (...) {
  return -1;
}

// Batch-readlink `n` paths (NUL-separated) into per_cap-byte slots
// (NUL-terminated). sizes[i] = link length (truncated at per_cap-1) or -1.
// Returns successful count, or -1 on internal failure. Used for
// /proc/<pid>/exe on first sight.
int kepler_read_links(const char* paths, int32_t n, char* out,
                      int32_t per_cap, int32_t* sizes) try {
  if (n < 0 || per_cap < 2) return -1;
  std::vector<const char*> ptrs(n);
  const char* p = paths;
  for (int i = 0; i < n; ++i) {
    ptrs[i] = p;
    p += strlen(p) + 1;
  }
  ParallelFor(static_cast<size_t>(n), [&](size_t lo, size_t hi) {
    for (size_t i = lo; i < hi; ++i) {
      ssize_t r = readlink(ptrs[i], out + i * per_cap, per_cap - 1);
      if (r < 0) {
        out[i * per_cap] = '\0';
        sizes[i] = -1;
      } else {
        out[i * per_cap + r] = '\0';
        sizes[i] = static_cast<int32_t>(r);
      }
    }
  });
  int ok = 0;
  for (int i = 0; i < n; ++i) {
    if (sizes[i] >= 0) ++ok;
  }
  return ok;
} catch (...) {
  return -1;
}

// prometheus floatToGoString (Python-repr-compatible) — exposed for the
// byte-parity tests. out must hold ≥48 bytes; returns length.
int kepler_fmt_double(double v, char* out) { return FmtGoDouble(v, out); }

// Render n*nz classic-text sample lines:
//   for i < n, z < nz:
//     out += name + prefix[i] + ztail[z] + fmt(values[i*nz + z] / div) + "\n"
// where prefix/ztail are concatenated blobs addressed by byte offsets
// (prefix_off[i]..prefix_off[i+1], ztail_off[z]..ztail_off[z+1]) and fmt
// is floatToGoString. flags bit0: round the value to 6 decimals first
// (snprintf %.6f → strtod), matching Python's float(f"{v:.6f}") pipeline
// for kepler_process_cpu_seconds_total. Returns bytes written, or -1 if
// `cap` would overflow (caller grows and retries).
//
// This is the scrape hot loop: one call renders a whole metric family
// (10k workloads × Z zones) with zero Python string work. Label blocks
// (the prefixes) are cached Python-side across scrapes; only values are
// formatted here, every scrape.
int64_t kepler_render_samples(const char* name, int32_t name_len,
                              const char* prefix_blob,
                              const int64_t* prefix_off, int32_t n,
                              const char* ztail_blob,
                              const int32_t* ztail_off, int32_t nz,
                              const double* values, double div,
                              int32_t flags, char* out, int64_t cap) try {
  if (n < 0 || nz <= 0 || div == 0.0) return -1;
  char* q = out;
  char* end = out + cap;
  char fbuf[48];
  char rbuf[64];
  const bool round6 = (flags & 1) != 0;
  for (int32_t i = 0; i < n; ++i) {
    const char* prefix = prefix_blob + prefix_off[i];
    const int64_t plen = prefix_off[i + 1] - prefix_off[i];
    for (int32_t z = 0; z < nz; ++z) {
      const char* ztail = ztail_blob + ztail_off[z];
      const int32_t zlen = ztail_off[z + 1] - ztail_off[z];
      double v = values[static_cast<int64_t>(i) * nz + z] / div;
      if (round6) {
        snprintf(rbuf, sizeof(rbuf), "%.6f", v);
        v = strtod(rbuf, nullptr);
      }
      int flen = FmtGoDouble(v, fbuf);
      if (q + name_len + plen + zlen + flen + 1 > end) return -1;
      memcpy(q, name, name_len);
      q += name_len;
      memcpy(q, prefix, plen);
      q += plen;
      memcpy(q, ztail, zlen);
      q += zlen;
      memcpy(q, fbuf, flen);
      q += flen;
      *q++ = '\n';
    }
  }
  return q - out;
} catch (...) {
  return -1;
}

}  // extern "C"
