/*!
 * page_reader.cc — BinaryPage read-ahead over a chain of .bin files.
 *
 * A page is page_ints little-endian int32 words: word 0 is the object
 * count n, words 1..n+1 the cumulative object sizes (word 1 = 0), and
 * object r's bytes lie at [page_bytes - cum[r+1], page_bytes - cum[r]),
 * packed backward from the end of the page (cxxnet_tpu_torch/utils/
 * binary_page.py). A producer thread reads and parses pages of the chain
 * into a bounded queue, `lookahead` pages deep; the consumer (the image
 * page iterator, calling through ctypes without the GIL) pops objects. A
 * short page at the end of a file ends that file; a page whose layout is
 * broken ends the chain with an error.
 */
#include "cxn_host.h"

#include <condition_variable>
#include <cstdio>
#include <cstring>
#include <deque>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Page {
  std::vector<char> buf;
  std::vector<int64_t> off, len;

  bool parse(int64_t page_ints) {
    const int64_t page_bytes = page_ints * 4;
    int32_t n;
    std::memcpy(&n, buf.data(), 4);
    if (n < 0 || int64_t(n) + 2 > page_ints) return false;
    off.clear();
    len.clear();
    int32_t prev = 0;
    for (int32_t r = 0; r < n; ++r) {
      int32_t cum;
      std::memcpy(&cum, buf.data() + 4 * (r + 2), 4);
      if (cum < prev || int64_t(cum) > page_bytes) return false;
      off.push_back(page_bytes - cum);
      len.push_back(cum - prev);
      prev = cum;
    }
    return true;
  }
};

class PageReader {
 public:
  PageReader(std::vector<std::string> paths, int64_t page_ints,
             size_t lookahead)
      : paths_(std::move(paths)), page_ints_(page_ints),
        lookahead_(lookahead) {
    start();
  }

  ~PageReader() { stop(); }

  void before_first() {
    stop();
    start();
  }

  int64_t next(const void **out) {
    while (!cur_ || cur_obj_ >= cur_->off.size()) {
      std::unique_lock<std::mutex> lk(mu_);
      cv_cons_.wait(lk, [this] { return !queue_.empty() || eof_; });
      if (queue_.empty()) return error_ ? -2 : -1;
      cur_ = std::move(queue_.front());
      queue_.pop_front();
      cur_obj_ = 0;
      cv_prod_.notify_all();
    }
    *out = cur_->buf.data() + cur_->off[cur_obj_];
    return cur_->len[cur_obj_++];
  }

 private:
  void start() {
    eof_ = error_ = stop_ = false;
    queue_.clear();
    cur_.reset();
    cur_obj_ = 0;
    worker_ = std::thread([this] { run(); });
  }

  void stop() {
    {
      std::unique_lock<std::mutex> lk(mu_);
      stop_ = true;
      cv_prod_.notify_all();
    }
    if (worker_.joinable()) worker_.join();
  }

  void run() {
    const int64_t page_bytes = page_ints_ * 4;
    for (const std::string &path : paths_) {
      FILE *f = std::fopen(path.c_str(), "rb");
      if (!f) {
        finish(true);
        return;
      }
      for (;;) {
        auto page = std::make_unique<Page>();
        page->buf.resize(page_bytes);
        size_t got = std::fread(page->buf.data(), 1, page_bytes, f);
        if (got < size_t(page_bytes)) break;
        if (!page->parse(page_ints_)) {
          std::fclose(f);
          finish(true);
          return;
        }
        std::unique_lock<std::mutex> lk(mu_);
        cv_prod_.wait(lk,
                      [this] { return queue_.size() < lookahead_ || stop_; });
        if (stop_) {
          std::fclose(f);
          return;
        }
        queue_.push_back(std::move(page));
        cv_cons_.notify_all();
      }
      std::fclose(f);
    }
    finish(false);
  }

  void finish(bool err) {
    std::unique_lock<std::mutex> lk(mu_);
    eof_ = true;
    error_ = err;
    cv_cons_.notify_all();
  }

  std::vector<std::string> paths_;
  int64_t page_ints_;
  size_t lookahead_;
  std::thread worker_;
  std::mutex mu_;
  std::condition_variable cv_prod_, cv_cons_;
  std::deque<std::unique_ptr<Page>> queue_;
  bool eof_ = false, error_ = false, stop_ = false;
  std::unique_ptr<Page> cur_;
  size_t cur_obj_ = 0;
};

}  // namespace

extern "C" void *cxn_page_reader_create(const char *const *paths,
                                        int64_t npath, int64_t page_ints,
                                        int64_t lookahead) {
  std::vector<std::string> p;
  for (int64_t i = 0; i < npath; ++i) {
    FILE *f = std::fopen(paths[i], "rb");
    if (!f) return nullptr;
    std::fclose(f);
    p.emplace_back(paths[i]);
  }
  if (page_ints < 2) return nullptr;
  if (lookahead < 2) lookahead = 2;
  return new PageReader(std::move(p), page_ints, size_t(lookahead));
}

extern "C" void cxn_page_reader_before_first(void *handle) {
  static_cast<PageReader *>(handle)->before_first();
}

extern "C" int64_t cxn_page_reader_next(void *handle, const void **out) {
  return static_cast<PageReader *>(handle)->next(out);
}

extern "C" void cxn_page_reader_free(void *handle) {
  delete static_cast<PageReader *>(handle);
}
