// Native TUM RGB-D dataset loader with multithreaded prefetch.
//
// The host-sequential IO path, replacing the reference's in-loop cv::imread
// (Examples/RGB-D/rgbd_my.cpp:90-96) with a producer pool that decodes ahead
// of the tracker: PNG color and 16-bit depth through the decoder in
// png_decode.cc (no libpng), JPEG through libjpeg where its header exists at
// build time, a bounded ring of decoded frames handed over in order, and a
// copy into caller-provided buffers.
//
// Exposed as a C ABI for ctypes: loader_create / loader_size / loader_next /
// loader_destroy, loader_set_size (frames of another size are refused, not
// written past the caller's buffers), and plslam_png_decode (one PNG file
// into a caller's buffer).
//
// Built by plslam_torch/native/loader.py at first use.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <fstream>
#include <mutex>
#include <sstream>
#include <string>
#include <thread>
#include <vector>

#include "png_decode.h"

#if !defined(PLSLAM_NO_JPEG) && defined(__has_include)
#if __has_include(<jpeglib.h>)
#define PLSLAM_HAVE_JPEG 1
#include <csetjmp>
extern "C" {
#include <jpeglib.h>
}
#endif
#endif

namespace {

struct Frame {
  std::vector<float> gray;   // H*W, 0..255
  std::vector<float> depth;  // H*W, metres
  double timestamp = 0.0;
  int width = 0, height = 0;
  bool ok = false;
};

bool ends_with(const std::string& s, const std::string& suf) {
  return s.size() >= suf.size() &&
         s.compare(s.size() - suf.size(), suf.size(), suf) == 0;
}

// ---- JPEG -----------------------------------------------------------------
#ifdef PLSLAM_HAVE_JPEG
struct JpegError {
  jpeg_error_mgr mgr;
  std::jmp_buf jump;
};

// libjpeg's default handler exits the process; a damaged file fails the frame
void jpeg_fail(j_common_ptr cinfo) {
  std::longjmp(reinterpret_cast<JpegError*>(cinfo->err)->jump, 1);
}
#endif

bool decode_jpeg(const std::string& path, std::vector<uint16_t>& out, int& w,
                 int& h, int& channels) {
#ifdef PLSLAM_HAVE_JPEG
  FILE* fp = fopen(path.c_str(), "rb");
  if (!fp) return false;
  jpeg_decompress_struct cinfo;
  JpegError jerr;
  std::vector<uint8_t> row;  // declared before setjmp: the jump skips no destructor
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_fail;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    fclose(fp);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, fp);
  jpeg_read_header(&cinfo, TRUE);
  jpeg_start_decompress(&cinfo);
  w = cinfo.output_width;
  h = cinfo.output_height;
  channels = cinfo.output_components;
  out.resize((size_t)w * h * channels);
  row.resize((size_t)w * channels);
  uint8_t* rp = row.data();
  for (int y = 0; y < h; ++y) {
    jpeg_read_scanlines(&cinfo, &rp, 1);
    for (size_t i = 0; i < row.size(); ++i)
      out[(size_t)y * w * channels + i] = row[i];
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  fclose(fp);
  return true;
#else
  (void)path, (void)out, (void)w, (void)h, (void)channels;
  return false;  // the Python side refuses JPEG associations in this build
#endif
}

struct Loader {
  std::vector<double> timestamps;
  std::vector<std::string> rgb_paths, depth_paths;
  double depth_factor = 5000.0;
  size_t next_submit = 0;   // next index the workers will take
  size_t next_emit = 0;     // next index the consumer wants
  size_t queue_cap = 8;
  int want_w = 0, want_h = 0;  // the caller's buffers; 0: unchecked
  std::deque<std::pair<size_t, Frame>> ready;
  std::mutex mu;
  std::condition_variable cv_ready, cv_space;
  std::vector<std::thread> workers;
  std::atomic<bool> stop{false};

  Frame load_one(size_t i) {
    Frame f;
    f.timestamp = timestamps[i];
    std::vector<uint16_t> rgb_raw, d_raw;
    int w, h, c, bd;
    const std::string& rp = rgb_paths[i];
    bool ok1 = ends_with(rp, ".png") || ends_with(rp, ".PNG")
                   ? plslam_png::decode_file(rp, rgb_raw, w, h, c, bd)
                   : decode_jpeg(rp, rgb_raw, w, h, c);
    if (!ok1) return f;
    f.width = w;
    f.height = h;
    f.gray.resize((size_t)w * h);
    if (c >= 3) {
      for (size_t p = 0; p < f.gray.size(); ++p) {
        // files are RGB; grayscale per ITU-R BT.601, in float
        float r = rgb_raw[p * c + 0], g = rgb_raw[p * c + 1],
              b = rgb_raw[p * c + 2];
        f.gray[p] = 0.299f * r + 0.587f * g + 0.114f * b;
      }
    } else {
      for (size_t p = 0; p < f.gray.size(); ++p) f.gray[p] = rgb_raw[p * c];
    }
    int dw, dh, dc, dbd;
    if (!plslam_png::decode_file(depth_paths[i], d_raw, dw, dh, dc, dbd)) return f;
    if (dw != w || dh != h) return f;
    f.depth.resize((size_t)w * h);
    const float inv = 1.0f / (float)depth_factor;
    for (size_t p = 0; p < f.depth.size(); ++p)
      f.depth[p] = (float)d_raw[p * dc] * inv;
    f.ok = true;
    return f;
  }

  void worker() {
    for (;;) {
      size_t idx;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_space.wait(lk, [&] {
          return stop || (next_submit < timestamps.size() &&
                          next_submit < next_emit + queue_cap);
        });
        if (stop || next_submit >= timestamps.size()) return;
        idx = next_submit++;
      }
      Frame f = load_one(idx);
      {
        std::lock_guard<std::mutex> lk(mu);
        ready.emplace_back(idx, std::move(f));
      }
      cv_ready.notify_all();
    }
  }
};

}  // namespace

// The library is built with hidden visibility and its own static C++ runtime
// (loader.py): only this C ABI is exported, and no C++ runtime symbol of an
// earlier-loaded library can stand in for the one it was built with.
#pragma GCC visibility push(default)
extern "C" {

void* loader_create(const char* assoc_path, const char* root,
                    double depth_factor, int n_threads, int queue) {
  auto* L = new Loader();
  L->depth_factor = depth_factor;
  L->queue_cap = queue > 0 ? (size_t)queue : 8;
  std::ifstream f(assoc_path);
  if (!f) {
    delete L;
    return nullptr;
  }
  std::string line, base(root);
  if (!base.empty() && base.back() != '/') base += '/';
  while (std::getline(f, line)) {
    if (line.empty() || line[0] == '#') continue;
    std::istringstream ss(line);
    double ts, ts2;
    std::string rgb, depth;
    if (!(ss >> ts >> rgb >> ts2 >> depth)) continue;
    L->timestamps.push_back(ts);
    L->rgb_paths.push_back(rgb[0] == '/' ? rgb : base + rgb);
    L->depth_paths.push_back(depth[0] == '/' ? depth : base + depth);
  }
  int nt = n_threads > 0 ? n_threads : 4;
  for (int i = 0; i < nt; ++i)
    L->workers.emplace_back([L] { L->worker(); });
  return L;
}

int loader_size(void* h) {
  return (int)static_cast<Loader*>(h)->timestamps.size();
}

// The size of the caller's buffers: loader_next refuses a frame of another
// size (-2) instead of writing past them.
void loader_set_size(void* h, int w, int hgt) {
  auto* L = static_cast<Loader*>(h);
  L->want_w = w;
  L->want_h = hgt;
}

// Copies the next frame (in order) into the caller's buffers.
// Returns: 1 ok, 0 end of sequence, -1 decode failure (frame skipped),
// -2 a frame of another size than loader_set_size's (frame skipped; *w and
// *hgt hold its size).
int loader_next(void* h, float* gray, float* depth, double* ts, int* w,
                int* hgt) {
  auto* L = static_cast<Loader*>(h);
  std::unique_lock<std::mutex> lk(L->mu);
  if (L->next_emit >= L->timestamps.size()) return 0;
  size_t want = L->next_emit;
  L->cv_ready.wait(lk, [&] {
    for (auto& kv : L->ready)
      if (kv.first == want) return true;
    return false;
  });
  Frame fr;
  for (auto it = L->ready.begin(); it != L->ready.end(); ++it) {
    if (it->first == want) {
      fr = std::move(it->second);
      L->ready.erase(it);
      break;
    }
  }
  L->next_emit++;
  lk.unlock();
  L->cv_space.notify_all();
  if (!fr.ok) return -1;
  *ts = fr.timestamp;
  *w = fr.width;
  *hgt = fr.height;
  if (L->want_w > 0 && (fr.width != L->want_w || fr.height != L->want_h)) return -2;
  std::memcpy(gray, fr.gray.data(), fr.gray.size() * sizeof(float));
  std::memcpy(depth, fr.depth.data(), fr.depth.size() * sizeof(float));
  return 1;
}

void loader_destroy(void* h) {
  auto* L = static_cast<Loader*>(h);
  {
    std::lock_guard<std::mutex> lk(L->mu);
    L->stop = true;
  }
  L->cv_space.notify_all();
  for (auto& t : L->workers) t.join();
  delete L;
}

// Decodes one PNG file into `out` (`cap` samples of 16 bits). Returns 1 when
// decoded, -1 when `cap` is below w * h * channels (the size is set: call
// again with a larger buffer), 0 on a file that fails to decode.
int plslam_png_decode(const char* path, uint16_t* out, long long cap, int* w,
                      int* hgt, int* channels, int* bit_depth) {
  std::vector<uint16_t> buf;
  if (!plslam_png::decode_file(path, buf, *w, *hgt, *channels, *bit_depth)) return 0;
  if ((long long)buf.size() > cap) return -1;
  std::memcpy(out, buf.data(), buf.size() * sizeof(uint16_t));
  return 1;
}

}  // extern "C"
#pragma GCC visibility pop
