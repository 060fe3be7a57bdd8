// Native KITTI velodyne loader — host-side I/O fast path.
//
// TPU-native analogue of the reference's C++ reader stack (reference:
// src/models/io/kitti_reader.cpp + read_file.hpp:307-327 and the dedicated
// reader thread in src/core_node/kitti_reader_nodelet.cpp:60-70). The
// reference reads one float at a time through fstream on a nodelet thread;
// here a single read() pulls the whole file and a pthread pool loads many
// scans concurrently so host I/O overlaps device compute.
//
// Exposed via ctypes:
//   kitti_read_bin(path, out, cap)            -> npoints (finite-filtered)
//   kitti_read_batch(paths, n, out, cap, nthreads) -> per-file counts
//
// tloam_torch's copy of native/kitti_loader.cpp. Built by
// tloam_torch/build.py with g++ (the flags of native/Makefile) into
// build/tloam_torch/ at first use.

#include <cerrno>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <fcntl.h>
#include <pthread.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

// Read one .bin of float32 x,y,z,intensity records into out[cap*4],
// dropping non-finite points. Returns point count or -1 on error.
long read_bin_impl(const char* path, float* out, long cap) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return -1;
  struct stat st;
  if (fstat(fd, &st) != 0) {
    ::close(fd);
    return -1;
  }
  long nrec = static_cast<long>(st.st_size / (4 * sizeof(float)));
  long want = nrec < cap ? nrec : cap;
  long n = 0;
  // stream in 1 MiB chunks, compacting non-finite records in place.
  // read() may return short or be interrupted; carry the partial-record
  // remainder between chunks so record framing never desyncs.
  const size_t REC = 4 * sizeof(float);
  const long CHUNK = (1 << 20) / REC;
  char* buf = new char[CHUNK * REC];
  size_t carry = 0;  // bytes of a partial record held at buf[0..carry)
  long read_recs = 0;
  while (read_recs < want) {
    long todo = want - read_recs < CHUNK ? want - read_recs : CHUNK;
    ssize_t got = ::read(fd, buf + carry, todo * REC - carry);
    if (got < 0) {
      if (errno == EINTR) continue;
      break;
    }
    if (got == 0) break;
    size_t avail = carry + static_cast<size_t>(got);
    long recs = static_cast<long>(avail / REC);
    for (long i = 0; i < recs; ++i) {
      float p[4];
      std::memcpy(p, buf + i * REC, REC);
      if (std::isfinite(p[0]) && std::isfinite(p[1]) && std::isfinite(p[2]) &&
          std::isfinite(p[3])) {
        std::memcpy(out + n * 4, p, REC);
        ++n;
      }
    }
    carry = avail - recs * REC;
    if (carry) std::memmove(buf, buf + recs * REC, carry);
    read_recs += recs;
  }
  delete[] buf;
  ::close(fd);
  return n;
}

struct BatchJob {
  const char* const* paths;
  float* out;        // nfiles * cap * 4 floats
  long* counts;      // nfiles
  long cap;
  long nfiles;
  long next;         // work index
  pthread_mutex_t mu;
};

void* batch_worker(void* arg) {
  BatchJob* job = static_cast<BatchJob*>(arg);
  for (;;) {
    pthread_mutex_lock(&job->mu);
    long i = job->next++;
    pthread_mutex_unlock(&job->mu);
    if (i >= job->nfiles) return nullptr;
    job->counts[i] = read_bin_impl(job->paths[i], job->out + i * job->cap * 4,
                                   job->cap);
  }
}

}  // namespace

extern "C" {

long kitti_read_bin(const char* path, float* out, long cap) {
  return read_bin_impl(path, out, cap);
}

// Load nfiles scans concurrently with nthreads workers.
// out must hold nfiles*cap*4 floats; counts receives per-file point counts.
void kitti_read_batch(const char* const* paths, long nfiles, float* out,
                      long cap, long* counts, long nthreads) {
  if (nthreads < 1) nthreads = 1;
  if (nthreads > nfiles) nthreads = nfiles;
  BatchJob job{paths, out, counts, cap, nfiles, 0, PTHREAD_MUTEX_INITIALIZER};
  pthread_t tids[64];
  if (nthreads > 64) nthreads = 64;
  for (long t = 0; t < nthreads; ++t)
    pthread_create(&tids[t], nullptr, batch_worker, &job);
  for (long t = 0; t < nthreads; ++t) pthread_join(tids[t], nullptr);
}

}  // extern "C"
