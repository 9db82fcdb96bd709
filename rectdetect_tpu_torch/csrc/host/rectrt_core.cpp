// rectrt_core — the port's native host runtime without OpenCV: the clock,
// the plan file and packed-Lab staging.
//
// A copy of native/rectrt.cpp:36-170 (rectrt_time_ms, rectrt_sleep_ms,
// rectrt_plan_load, rectrt_plan_save, rectrt_bgr_to_packedlab), byte for
// byte in its arithmetic, with the includes these functions need and none
// of OpenCV's, so that it builds on any host with a C++17 compiler.
// rectdetect_tpu_torch/runtime/native.py builds it with g++ at first use
// (-O3 -march=native, as native/CMakeLists.txt: without fused
// multiply-adds g++ does not contract the XYZ dot products and the packing
// differs at some colours) and binds it by ctypes.

#include <algorithm>
#include <chrono>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <fstream>
#include <map>
#include <mutex>
#include <sstream>
#include <string>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------- time ----

uint64_t rectrt_time_ms() {
  return std::chrono::duration_cast<std::chrono::milliseconds>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}

void rectrt_sleep_ms(int ms) {
  std::this_thread::sleep_for(std::chrono::milliseconds(ms));
}

// ------------------------------------------------------------ plan cache --
// File format mirrors plan.txt (oclhelper.c:394-527): sections keyed by a
// sanitized device name, "key value" lines.  Other devices' sections are
// preserved on save.

static std::string sanitize(const std::string &s) {
  std::string r;
  for (char c : s) r += (c == ' ' || c == '\t' || c == '\n') ? '_' : c;
  return r;
}

static std::map<std::string, std::map<std::string, std::string>>
read_plan(const char *path) {
  std::map<std::string, std::map<std::string, std::string>> all;
  std::ifstream f(path);
  std::string line, cur;
  while (std::getline(f, line)) {
    if (line.empty()) continue;
    if (line[0] == '[') {
      size_t e = line.find(']');
      cur = line.substr(1, e == std::string::npos ? line.size() - 1 : e - 1);
    } else if (!cur.empty()) {
      size_t sp = line.find(' ');
      if (sp != std::string::npos)
        all[cur][line.substr(0, sp)] = line.substr(sp + 1);
    }
  }
  return all;
}

// Returns the device's section as "key value\n..." into buf; result length
// (or 0 if absent, -1 if buf too small).
int rectrt_plan_load(const char *path, const char *device, char *buf,
                     int buflen) {
  auto all = read_plan(path);
  auto it = all.find(sanitize(device));
  if (it == all.end()) return 0;
  std::string out;
  for (auto &kv : it->second) out += kv.first + " " + kv.second + "\n";
  if ((int)out.size() + 1 > buflen) return -1;
  std::memcpy(buf, out.c_str(), out.size() + 1);
  return (int)out.size();
}

// content: "key value\n..." lines; other devices' sections preserved.
int rectrt_plan_save(const char *path, const char *device,
                     const char *content) {
  auto all = read_plan(path);
  auto &sec = all[sanitize(device)];
  sec.clear();
  std::istringstream is(content);
  std::string line;
  while (std::getline(is, line)) {
    size_t sp = line.find(' ');
    if (sp != std::string::npos) sec[line.substr(0, sp)] = line.substr(sp + 1);
  }
  std::ofstream f(path, std::ios::trunc);
  if (!f) return -1;
  for (auto &s : all) {
    f << "[" << s.first << "]\n";
    for (auto &kv : s.second) f << kv.first << " " << kv.second << "\n";
  }
  return 0;
}

// ------------------------------------------------- packed-Lab staging -----
// Host-side BGR -> packed Lab (L:12b | a:10b | b:10b), same lattice as the
// device path (core/color.py; packlab oclimgutil.cl:28-34).  LUT for the
// sRGB EOTF like the reference's s2l table (oclimgutil.cl:661-695).

static float s2l_lut[256];
static std::once_flag s2l_once;

static void init_s2l() {
  for (int i = 0; i < 256; i++) {
    float s = i / 255.0f;
    s2l_lut[i] =
        s <= 0.04045f ? s / 12.92f : std::pow((s + 0.055f) / 1.055f, 2.4f);
  }
}

static inline float lab_f(float t) {
  return t > 0.008856f ? std::cbrt(t) : 7.787f * t + 16.0f / 116.0f;
}

void rectrt_bgr_to_packedlab(const uint8_t *bgr, int32_t *out, int n,
                             int n_threads) {
  std::call_once(s2l_once, init_s2l);
  if (n_threads < 1) n_threads = (int)std::thread::hardware_concurrency();
  auto work = [&](int t0, int t1) {
    for (int i = t0; i < t1; i++) {
      float b = s2l_lut[bgr[i * 3 + 0]];
      float g = s2l_lut[bgr[i * 3 + 1]];
      float r = s2l_lut[bgr[i * 3 + 2]];
      float x = (0.412453f * r + 0.357580f * g + 0.180423f * b) / 0.950456f;
      float y = 0.212671f * r + 0.715160f * g + 0.072169f * b;
      float z = (0.019334f * r + 0.119193f * g + 0.950227f * b) / 1.088754f;
      float fx = lab_f(x), fy = lab_f(y), fz = lab_f(z);
      float L = y > 0.008856f ? 116.0f * fy - 16.0f : 903.3f * y;
      float A = 500.0f * (fx - fy);
      float B = 200.0f * (fy - fz);
      float lf = L * (1.0f / 256.0f);
      float af = (A + 128.0f) * (1.0f / 256.0f);
      float bf = (B + 128.0f) * (1.0f / 256.0f);
      auto clampi = [](int v, int hi) { return v < 0 ? 0 : (v > hi ? hi : v); };
      int cl = clampi((int)std::floor(lf * 4096.0f), 4095);
      int ca = clampi((int)std::floor(af * 1024.0f), 1023);
      int cb = clampi((int)std::floor(bf * 1024.0f), 1023);
      out[i] = (cb << 22) | (ca << 12) | cl;
    }
  };
  if (n_threads <= 1 || n < (1 << 15)) {
    work(0, n);
    return;
  }
  std::vector<std::thread> th;
  int chunk = (n + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; t++) {
    int a = t * chunk, b = std::min(n, a + chunk);
    if (a < b) th.emplace_back(work, a, b);
  }
  for (auto &t : th) t.join();
}

}  // extern "C"
