// ThreadSanitizer harness for the native scanner (the -race analog the
// reference gets for free from `go test -race`, Makefile:131).
//
// Builds scan.cpp with -fsanitize=thread into a standalone binary and
// hammers every exported call from concurrent threads over a fake /proc
// tree. Any data race aborts the run with a TSAN report; a clean exit is
// the pass. Built and run by tests/test_torch_native.py when the
// toolchain supports TSAN:
//
//   g++ -O1 -g -fsanitize=thread -std=c++17 scan.cpp scan_tsan_test.cpp
//
// scan.cpp's thread-safety contract is "no shared mutable state — every
// call works on caller-provided buffers"; this harness exists to keep
// that contract honest as the file grows.

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <sys/stat.h>
#include <thread>
#include <vector>

extern "C" {
int kepler_native_abi_version();
int kepler_scan_procs(const char* procfs, int32_t* pids, double* cpu_seconds,
                      char* comms, int32_t cap);
int kepler_read_stat_totals(const char* procfs, double* active,
                            double* total);
int kepler_read_counter_files(const char* paths, int32_t n, uint64_t* out);
int kepler_read_files(const char* paths, int32_t n, char* out,
                      int32_t per_cap, int32_t* sizes);
int kepler_read_links(const char* paths, int32_t n, char* out,
                      int32_t per_cap, int32_t* sizes);
int kepler_fmt_double(double v, char* out);
int64_t kepler_render_samples(const char* name, int32_t name_len,
                              const char* prefix_blob,
                              const int64_t* prefix_off, int32_t n,
                              const char* ztail_blob,
                              const int32_t* ztail_off, int32_t nz,
                              const double* values, double div,
                              int32_t flags, char* out, int64_t cap);
}

namespace {

void write_file(const std::string& path, const std::string& content) {
  FILE* f = fopen(path.c_str(), "w");
  if (!f) {
    perror(path.c_str());
    exit(2);
  }
  fputs(content.c_str(), f);
  fclose(f);
}

std::string make_fake_proc(const std::string& root, int n_procs) {
  std::string proc = root + "/proc";
  mkdir(proc.c_str(), 0755);
  write_file(proc + "/stat", "cpu  100 20 300 4000 500 60 70 0 0 0\n");
  for (int pid = 100; pid < 100 + n_procs; ++pid) {
    std::string d = proc + "/" + std::to_string(pid);
    mkdir(d.c_str(), 0755);
    char line[256];
    snprintf(line, sizeof(line),
             "%d (proc %d) S 1 1 1 0 -1 4194560 100 0 0 0 "
             "%d %d 0 0 20 0 1 0 100 0 0 0 0 0 0 0 0 0 0 0 0 0 0 0 0 0 "
             "0 0 0 0 0 0 0 0 0 0 0 0 0",
             pid, pid, pid * 7, pid * 3);
    write_file(d + "/stat", line);
  }
  return proc;
}

}  // namespace

int main() {
  if (kepler_native_abi_version() <= 0) return 2;
  char tmpl[] = "/tmp/kepler-tsan-XXXXXX";
  if (!mkdtemp(tmpl)) return 2;
  const std::string root(tmpl);
  const std::string proc = make_fake_proc(root, 64);
  const std::string counter_a = root + "/energy_a";
  const std::string counter_b = root + "/energy_b";
  write_file(counter_a, "1000\n");
  write_file(counter_b, "2000\n");
  // NUL-joined path blob, the read_counter_files wire format
  std::string blob = counter_a;
  blob.push_back('\0');
  blob += counter_b;
  blob.push_back('\0');

  std::atomic<int> failures{0};
  std::vector<std::thread> threads;
  for (int t = 0; t < 8; ++t) {
    threads.emplace_back([&, t] {
      int32_t pids[256];
      double cpu[256];
      char comms[256 * 32];
      double active = 0, total = 0;
      uint64_t counters[2];
      char files_out[2 * 128];
      int32_t files_sizes[2];
      char fmt_out[48];
      char render_out[512];
      const char* prefix_blob = "{pid=\"1\"}{pid=\"2\"}";
      const int64_t prefix_off[3] = {0, 9, 18};
      const char* ztail_blob = ",zone=\"pkg\"} ";
      const int32_t ztail_off[2] = {0, 13};
      const double render_vals[2] = {1.5, 2.5e8};
      for (int i = 0; i < 200; ++i) {
        // pid dirs are never mutated: the scan count is a hard invariant
        int n = kepler_scan_procs(proc.c_str(), pids, cpu, comms, 256);
        if (n != 64) failures.fetch_add(1);
        // stat/counter files race a truncating writer below — transient
        // read errors are the mid-write window (callers skip it); what
        // TSAN checks is that the concurrent calls themselves are clean
        (void)kepler_read_stat_totals(proc.c_str(), &active, &total);
        int ok = kepler_read_counter_files(blob.c_str(), 2, counters);
        if (ok < 0 || ok > 2) failures.fetch_add(1);
        ok = kepler_read_files(blob.c_str(), 2, files_out, 128, files_sizes);
        if (ok < 0 || ok > 2) failures.fetch_add(1);
        if (kepler_fmt_double(1234.5 + i, fmt_out) <= 0) failures.fetch_add(1);
        int64_t r = kepler_render_samples(
            "kepler_x", 8, prefix_blob, prefix_off, 2, ztail_blob, ztail_off,
            1, render_vals, 1.0, 0, render_out, sizeof(render_out));
        if (r <= 0) failures.fetch_add(1);
        if (t == 0 && i % 10 == 0) {
          // one writer mutates the tree while others scan (live /proc)
          write_file(counter_a, std::to_string(1000 + i) + "\n");
          write_file(proc + "/stat",
                     "cpu  " + std::to_string(100 + i) +
                         " 20 300 4000 500 60 70 0 0 0\n");
        }
      }
    });
  }
  for (auto& th : threads) th.join();
  if (failures.load() != 0) {
    fprintf(stderr, "FAIL: %d call failures\n", failures.load());
    return 1;
  }
  printf("tsan harness clean: 8 threads x 200 iterations\n");
  return 0;
}
