// Threaded prefetching point-cloud reader for saccot.
//
// The reference's driver reads each scan synchronously on the main thread
// before registering it (SURVEY.md section 2.1, main loop and cloud I/O). Here
// the device can consume pairs faster than a serial reader parses them,
// so the sweep runner needs host I/O
// running AHEAD of the device: this module is a small native pipeline —
// a worker pool parses scans (KITTI .bin / binary PLY via loader.cpp)
// into an ordered, bounded results window while the Python side feeds the
// accelerator, so disk/parse latency overlaps device compute.
//
// C ABI (ctypes from saccot/io/native.py):
//   saccot_prefetch_create(paths, n, max_pts, fmt, threads, window)
//   saccot_prefetch_next(handle, out, max_pts) -> count | -1 err | -2 done
//   saccot_prefetch_destroy(handle)
//
// Results are delivered strictly in submission order; at most `window`
// scans are buffered beyond the consumer, bounding memory at
// window * max_pts * 12 bytes.

#include <condition_variable>
#include <cstring>
#include <map>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

extern "C" {
long saccot_load_kitti_bin(const char* path, float* out, long max_pts);
long saccot_load_ply_xyz(const char* path, float* out, long max_pts);
}

namespace {

struct Prefetcher {
    std::vector<std::string> paths;
    long max_pts = 0;
    int fmt = 0;  // 0 = kitti bin, 1 = binary PLY
    int window = 4;

    std::mutex mu;
    std::condition_variable cv_worker;   // waits for window space
    std::condition_variable cv_consumer; // waits for the next result
    long next_claim = 0;    // next file index a worker will take
    long next_consume = 0;  // next file index the consumer needs
    bool shutdown = false;
    // file index -> (count, xyz data); count < 0 signals a read error.
    std::map<long, std::pair<long, std::vector<float>>> ready;
    std::vector<std::thread> threads;

    void worker() {
        for (;;) {
            long idx;
            {
                std::unique_lock<std::mutex> lk(mu);
                cv_worker.wait(lk, [&] {
                    return shutdown ||
                           (next_claim < static_cast<long>(paths.size()) &&
                            next_claim < next_consume + window);
                });
                if (shutdown || next_claim >= static_cast<long>(paths.size()))
                    return;
                idx = next_claim++;
            }
            std::vector<float> buf(static_cast<size_t>(max_pts) * 3);
            long n = fmt == 0
                         ? saccot_load_kitti_bin(paths[idx].c_str(), buf.data(), max_pts)
                         : saccot_load_ply_xyz(paths[idx].c_str(), buf.data(), max_pts);
            if (n >= 0) buf.resize(static_cast<size_t>(n) * 3);
            {
                std::lock_guard<std::mutex> lk(mu);
                ready.emplace(idx, std::make_pair(n, std::move(buf)));
            }
            cv_consumer.notify_all();
        }
    }
};

}  // namespace

extern "C" {

void* saccot_prefetch_create(const char** paths, long n_files, long max_pts,
                             int fmt, int n_threads, int window) {
    if (n_files < 0 || max_pts <= 0 || (fmt != 0 && fmt != 1)) return nullptr;
    auto* p = new Prefetcher();
    p->paths.reserve(static_cast<size_t>(n_files));
    for (long i = 0; i < n_files; ++i) p->paths.emplace_back(paths[i]);
    p->max_pts = max_pts;
    p->fmt = fmt;
    p->window = window < 1 ? 1 : window;
    if (n_threads < 1) n_threads = 1;
    if (n_threads > 16) n_threads = 16;
    for (int t = 0; t < n_threads; ++t)
        p->threads.emplace_back(&Prefetcher::worker, p);
    return p;
}

long saccot_prefetch_next(void* handle, float* out, long max_pts) {
    auto* p = static_cast<Prefetcher*>(handle);
    if (!p) return -1;
    std::unique_lock<std::mutex> lk(p->mu);
    if (p->next_consume >= static_cast<long>(p->paths.size())) return -2;
    long idx = p->next_consume;
    p->cv_consumer.wait(lk, [&] { return p->ready.count(idx) > 0; });
    auto node = p->ready.extract(idx);
    p->next_consume++;
    lk.unlock();
    p->cv_worker.notify_all();  // window advanced

    long n = node.mapped().first;
    if (n < 0) return -1;
    if (n > max_pts) n = max_pts;
    std::memcpy(out, node.mapped().second.data(),
                static_cast<size_t>(n) * 3 * sizeof(float));
    return n;
}

void saccot_prefetch_destroy(void* handle) {
    auto* p = static_cast<Prefetcher*>(handle);
    if (!p) return;
    {
        std::lock_guard<std::mutex> lk(p->mu);
        p->shutdown = true;
    }
    p->cv_worker.notify_all();
    for (auto& t : p->threads) t.join();
    delete p;
}

}  // extern "C"
