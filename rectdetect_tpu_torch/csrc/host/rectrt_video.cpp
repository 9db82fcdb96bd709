// rectrt_video — the port's native frame pump and video writer, over
// OpenCV's C++ library.
//
// A copy of native/rectrt.cpp:172-319 (rectrt_pump_*, rectrt_writer_*),
// unchanged, with the includes it needs.  rectdetect_tpu_torch/runtime/
// native.py builds it with g++ exactly where `pkg-config --exists opencv4`
// succeeds, with that package's flags, and otherwise runs its cv2 frame
// pump.

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

#include <opencv2/videoio.hpp>
#include <opencv2/imgcodecs.hpp>
#include <opencv2/imgproc.hpp>

extern "C" {

// ------------------------------------------------------------ frame pump --
// Threaded capture into a ring of preallocated BGR frames.  The capture
// thread always overwrites the oldest slot (realtime semantics: consumers
// get the freshest frame, like the reference's grab/retrieve overlap,
// vidrect.cpp:159-172).

struct Pump {
  cv::VideoCapture cap;
  std::thread thread;
  std::mutex mu;
  std::condition_variable cv_;
  std::vector<std::vector<uint8_t>> ring;
  int w = 0, h = 0, ring_n = 0;
  bool drop = true;           // realtime: overwrite; else backpressure
  std::atomic<long> seq{0};   // total frames captured
  long consumed = 0;
  std::atomic<bool> stop{false};
  std::atomic<bool> eof{false};

  void run() {
    cv::Mat frame;
    while (!stop.load()) {
      if (!cap.read(frame)) {
        eof.store(true);
        cv_.notify_all();
        return;
      }
      if (frame.cols != w || frame.rows != h) {
        cv::resize(frame, frame, cv::Size(w, h));
      }
      {
        std::unique_lock<std::mutex> lk(mu);
        if (!drop) {
          cv_.wait(lk, [&] {
            return stop.load() || seq.load() - consumed < ring_n;
          });
          if (stop.load()) return;
        }
        long s = seq.load();
        auto &slot = ring[s % ring_n];
        std::memcpy(slot.data(), frame.data, (size_t)w * h * 3);
        seq.store(s + 1);
      }
      cv_.notify_all();
    }
  }
};

void *rectrt_pump_open(const char *spec, int cam_w, int cam_h, int ring_n,
                       int drop) {
  auto *p = new Pump();
  std::string s = spec ? spec : "";
  if (s.rfind("cam:", 0) == 0) {
    int id = 0, w = 0, h = 0;
    std::sscanf(s.c_str(), "cam:%d,%d,%d", &id, &w, &h);
    p->cap.open(id);
    if (p->cap.isOpened() && w && h) {
      p->cap.set(cv::CAP_PROP_FRAME_WIDTH, w);
      p->cap.set(cv::CAP_PROP_FRAME_HEIGHT, h);
    }
  } else if (!s.empty()) {
    p->cap.open(s);
  } else {
    p->cap.open(0);
  }
  if (!p->cap.isOpened()) {
    delete p;
    return nullptr;
  }
  p->w = (int)p->cap.get(cv::CAP_PROP_FRAME_WIDTH);
  p->h = (int)p->cap.get(cv::CAP_PROP_FRAME_HEIGHT);
  if (cam_w && cam_h && (p->w != cam_w || p->h != cam_h)) {
    p->w = cam_w;
    p->h = cam_h;
  }
  p->ring_n = ring_n > 0 ? ring_n : 4;
  p->drop = drop != 0;
  p->ring.assign(p->ring_n, std::vector<uint8_t>((size_t)p->w * p->h * 3));
  p->thread = std::thread(&Pump::run, p);
  return p;
}

int rectrt_pump_width(void *vp) { return ((Pump *)vp)->w; }
int rectrt_pump_height(void *vp) { return ((Pump *)vp)->h; }

// Copy the next frame into out.  drop mode: the NEWEST unconsumed frame
// (returns frames skipped >= 0); lossless mode: the OLDEST unconsumed
// (always returns 0).  -1 on timeout, -2 on end of stream.
int rectrt_pump_next(void *vp, uint8_t *out, int timeout_ms) {
  auto *p = (Pump *)vp;
  std::unique_lock<std::mutex> lk(p->mu);
  if (!p->cv_.wait_for(lk, std::chrono::milliseconds(timeout_ms), [&] {
        return p->seq.load() > p->consumed || p->eof.load();
      }))
    return -1;
  long s = p->seq.load();
  if (s <= p->consumed) return -2;  // eof with nothing new
  long pick = p->drop ? s - 1 : p->consumed;
  int skipped = (int)(pick - p->consumed);
  std::memcpy(out, p->ring[pick % p->ring_n].data(),
              (size_t)p->w * p->h * 3);
  p->consumed = pick + 1;
  lk.unlock();
  p->cv_.notify_all();  // wake a backpressured capture thread
  return skipped;
}

void rectrt_pump_close(void *vp) {
  auto *p = (Pump *)vp;
  p->stop.store(true);
  p->cv_.notify_all();
  if (p->thread.joinable()) p->thread.join();
  delete p;
}

// ---------------------------------------------------------------- writer --

struct Writer {
  cv::VideoWriter w;
  int iw, ih;
};

void *rectrt_writer_open(const char *path, int w, int h, double fps) {
  auto *wr = new Writer{{}, w, h};
  wr->w.open(path, cv::VideoWriter::fourcc('P', 'I', 'M', '1'), fps,
             cv::Size(w, h), true);
  if (!wr->w.isOpened())
    wr->w.open(path, cv::VideoWriter::fourcc('m', 'p', '4', 'v'), fps,
               cv::Size(w, h), true);
  if (!wr->w.isOpened()) {
    delete wr;
    return nullptr;
  }
  return wr;
}

int rectrt_writer_write(void *vw, const uint8_t *bgr) {
  auto *wr = (Writer *)vw;
  cv::Mat m(wr->ih, wr->iw, CV_8UC3, (void *)bgr);
  wr->w.write(m);
  return 0;
}

void rectrt_writer_close(void *vw) {
  auto *wr = (Writer *)vw;
  wr->w.release();
  delete wr;
}

}  // extern "C"
