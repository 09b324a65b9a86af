// Native streaming runtime: sensor ring buffers + measurement alignment.
//
// Equivalent of the reference's sensor/orchestration layer
// (VINS_ios/ViewController.mm): the accel/gyro callback queues with
// linear interpolation of acceleration to gyro timestamps
// (imuStartUpdate, ViewController.mm:1020-1173, interpolation
// :1081-1095), and getMeasurements' per-image IMU batching
// (ViewController.mm:604-638). Producers (sensor threads) push samples;
// the consumer polls fixed-size, preintegration-ready IMU chunks in the
// exact ImuChunk layout of vins_tpu/core/preintegration.py:35 (row 0 =
// seed sample at the previous image stamp with dt=0, rows 1..k =
// integration steps, dt-0 padding, overflow folded into the last slot so
// total integration time is conserved — mirroring send_imu's dt
// bookkeeping, ViewController.mm:661-681).
//
// The hot path is lock-scoped ring-buffer work in C++ so a live sensor
// feed (or a replay driver) never runs Python between callback and
// device dispatch.
//
// C API (ctypes-friendly):
//   vr_create(max_per_edge, imu_capacity, img_capacity)       -> handle
//   vr_push_accel(h, t, x, y, z)                              -> 0/-1
//   vr_push_gyro(h, t, x, y, z)                               -> 0/-1
//   vr_push_image(h, t, image_id)                             -> 0/-1
//   vr_poll_chunk(h, out_dt[N], out_acc[3N], out_gyr[3N],
//                 out_t_image[1])                              -> image_id or -1
//   vr_pending(h)        -> number of images whose chunks are ready
//   vr_destroy(h)
//
// Build: g++ -O3 -shared -fPIC runtime.cpp -o libvinsruntime.so -lpthread
#include <cmath>
#include <cstdint>
#include <cstring>
#include <deque>
#include <mutex>
#include <vector>

namespace {

struct Sample3 {
  double t;
  double v[3];
};

struct Runtime {
  int max_per_edge;
  size_t imu_capacity;
  size_t img_capacity;

  std::mutex mu;
  // Raw sensor queues (producer side).
  std::deque<Sample3> accel;
  std::deque<Sample3> gyro;
  // Fused IMU samples (accel interpolated to gyro stamps).
  std::deque<Sample3> fused_acc;   // same timestamps as fused_gyr
  std::deque<Sample3> fused_gyr;
  // Image stamps awaiting their IMU chunk.
  struct Img {
    double t;
    long id;
  };
  std::deque<Img> images;
  double last_img_t = -1.0;   // previous consumed image stamp
  bool have_last_img = false;

  explicit Runtime(int n, size_t imu_cap, size_t img_cap)
      : max_per_edge(n), imu_capacity(imu_cap), img_capacity(img_cap) {}

  // Fuse any gyro samples that now have accel on both sides
  // (ViewController.mm:1062-1101): accel linearly interpolated to the
  // gyro timestamp; consumed accel samples are dropped once passed.
  void fuse_locked() {
    while (!gyro.empty() && accel.size() >= 2) {
      const Sample3 g = gyro.front();
      // Drop gyro samples older than the accel span (cannot interpolate).
      if (g.t < accel.front().t) {
        gyro.pop_front();
        continue;
      }
      // Advance accel so that accel[0].t <= g.t <= accel[1].t.
      while (accel.size() >= 2 && accel[1].t < g.t) accel.pop_front();
      if (accel.size() < 2) break;               // need a later accel
      const Sample3 &a0 = accel[0];
      const Sample3 &a1 = accel[1];
      if (g.t < a0.t) {                          // raced past; drop
        gyro.pop_front();
        continue;
      }
      const double span = a1.t - a0.t;
      const double w = span > 0 ? (g.t - a0.t) / span : 0.0;
      Sample3 fa;
      fa.t = g.t;
      for (int i = 0; i < 3; ++i) fa.v[i] = a0.v[i] + w * (a1.v[i] - a0.v[i]);
      // Keep fused stream strictly increasing.
      if (fused_gyr.empty() || g.t > fused_gyr.back().t) {
        fused_acc.push_back(fa);
        fused_gyr.push_back(g);
        if (fused_gyr.size() > imu_capacity) {
          fused_acc.pop_front();
          fused_gyr.pop_front();
        }
      }
      gyro.pop_front();
    }
  }

  // Is a complete chunk available for the oldest image? Complete =
  // at least one fused sample at t >= image stamp exists (so the
  // interval is fully covered), matching getMeasurements' wait
  // condition (ViewController.mm:615-623).
  bool ready_locked() const {
    if (images.empty()) return false;
    return !fused_gyr.empty() && fused_gyr.back().t >= images.front().t;
  }

  long poll_locked(float *out_dt, float *out_acc, float *out_gyr,
                   double *out_t) {
    if (!ready_locked()) return -1;
    const Img img = images.front();
    images.pop_front();
    const int N = max_per_edge;
    std::memset(out_dt, 0, sizeof(float) * N);
    std::memset(out_acc, 0, sizeof(float) * 3 * N);
    std::memset(out_gyr, 0, sizeof(float) * 3 * N);

    // Row 0: seed sample held at the previous image stamp.
    double t_prev = have_last_img ? last_img_t : -1.0;
    // Collect fused samples with t <= img.t (consuming them), tracking
    // one sample before the window as the seed.
    Sample3 seed_a{}, seed_g{};
    bool have_seed = false;
    std::vector<Sample3> win_a, win_g;
    while (!fused_gyr.empty() && fused_gyr.front().t <= img.t) {
      const Sample3 a = fused_acc.front();
      const Sample3 g = fused_gyr.front();
      fused_acc.pop_front();
      fused_gyr.pop_front();
      if (have_last_img && g.t <= t_prev) {
        seed_a = a;
        seed_g = g;
        have_seed = true;
        continue;
      }
      win_a.push_back(a);
      win_g.push_back(g);
    }
    if (!have_last_img) {
      t_prev = win_g.empty() ? img.t : win_g.front().t;
    }
    if (!have_seed) {
      if (!win_g.empty()) {
        seed_a = win_a.front();
        seed_g = win_g.front();
      }
      have_seed = !win_g.empty();
    }
    if (have_seed) {
      for (int i = 0; i < 3; ++i) {
        out_acc[i] = static_cast<float>(seed_a.v[i]);
        out_gyr[i] = static_cast<float>(seed_g.v[i]);
      }
    }

    // Rows 1..: integration steps (dt from the previous stamp).
    int j = 1;
    double t_cursor = t_prev;
    for (size_t k = 0; k < win_g.size(); ++k) {
      const double d = win_g[k].t - t_cursor;
      t_cursor = win_g[k].t;
      if (d < 0) continue;
      if (j >= N) {  // overflow: fold into the last slot (dt conserved)
        out_dt[N - 1] += static_cast<float>(d);
        for (int i = 0; i < 3; ++i) {
          out_acc[3 * (N - 1) + i] = static_cast<float>(win_a[k].v[i]);
          out_gyr[3 * (N - 1) + i] = static_cast<float>(win_g[k].v[i]);
        }
        continue;
      }
      out_dt[j] = static_cast<float>(d);
      for (int i = 0; i < 3; ++i) {
        out_acc[3 * j + i] = static_cast<float>(win_a[k].v[i]);
        out_gyr[3 * j + i] = static_cast<float>(win_g[k].v[i]);
      }
      ++j;
    }
    // Tail sub-interval up to the image stamp (zero-order hold).
    const double tail = img.t - t_cursor;
    if (tail > 1e-9 && j > 1) {
      if (j < N) {
        out_dt[j] = static_cast<float>(tail);
        for (int i = 0; i < 3; ++i) {
          out_acc[3 * j + i] = out_acc[3 * (j - 1) + i];
          out_gyr[3 * j + i] = out_gyr[3 * (j - 1) + i];
        }
      } else {
        out_dt[N - 1] += static_cast<float>(tail);
      }
    }

    last_img_t = img.t;
    have_last_img = true;
    *out_t = img.t;
    return img.id;
  }
};

}  // namespace

extern "C" {

void *vr_create(int max_per_edge, long imu_capacity, long img_capacity) {
  if (max_per_edge < 2 || imu_capacity < 8 || img_capacity < 1) return nullptr;
  return new Runtime(max_per_edge, static_cast<size_t>(imu_capacity),
                     static_cast<size_t>(img_capacity));
}

int vr_push_accel(void *h, double t, double x, double y, double z) {
  auto *rt = static_cast<Runtime *>(h);
  std::lock_guard<std::mutex> lk(rt->mu);
  if (!rt->accel.empty() && t <= rt->accel.back().t) return -1;
  rt->accel.push_back({t, {x, y, z}});
  if (rt->accel.size() > rt->imu_capacity) rt->accel.pop_front();
  rt->fuse_locked();
  return 0;
}

int vr_push_gyro(void *h, double t, double x, double y, double z) {
  auto *rt = static_cast<Runtime *>(h);
  std::lock_guard<std::mutex> lk(rt->mu);
  if (!rt->gyro.empty() && t <= rt->gyro.back().t) return -1;
  rt->gyro.push_back({t, {x, y, z}});
  if (rt->gyro.size() > rt->imu_capacity) rt->gyro.pop_front();
  rt->fuse_locked();
  return 0;
}

int vr_push_image(void *h, double t, long image_id) {
  auto *rt = static_cast<Runtime *>(h);
  std::lock_guard<std::mutex> lk(rt->mu);
  if (rt->images.size() >= rt->img_capacity) return -1;  // backpressure
  if (!rt->images.empty() && t <= rt->images.back().t) return -1;
  rt->images.push_back({t, image_id});
  return 0;
}

long vr_pending(void *h) {
  auto *rt = static_cast<Runtime *>(h);
  std::lock_guard<std::mutex> lk(rt->mu);
  long n = 0;
  // Count images fully covered by the fused stream.
  for (const auto &img : rt->images) {
    if (!rt->fused_gyr.empty() && rt->fused_gyr.back().t >= img.t) {
      ++n;
    } else {
      break;
    }
  }
  return n;
}

long vr_poll_chunk(void *h, float *out_dt, float *out_acc, float *out_gyr,
                   double *out_t_image) {
  auto *rt = static_cast<Runtime *>(h);
  std::lock_guard<std::mutex> lk(rt->mu);
  return rt->poll_locked(out_dt, out_acc, out_gyr, out_t_image);
}

void vr_destroy(void *h) { delete static_cast<Runtime *>(h); }

}  // extern "C"
