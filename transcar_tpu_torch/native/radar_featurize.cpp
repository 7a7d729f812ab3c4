// Native radar token featurizer — the host data-loader hot path.
//
// Same math as data/radar.py (itself the reference's
// in-forward radar block, detr3d_head.py:301-536, moved into the input
// pipeline): per-channel velocity rotation into the lidar frame, relative
// timestamps, velocity·Δt offsets, one-hot state fields, strict range
// filter, and the fixed token buffer filled with the padding sentinel.
//
// The Python loader calls this via ctypes when built (native/__init__.py);
// it removes ~all per-sample numpy overhead from the 5-radar featurization.

#include <algorithm>
#include <cmath>
#include <cstring>

namespace {

constexpr int kRawDims = 18;
constexpr int kFeat = 36;

// v_out = ref_rot^T * (radar_rot * [vx, vy, 0]); z zeroed.
inline void rotate_vel(const double* radar_rot, const double* ref_rot,
                       float vx, float vy, double* out_xy) {
  double v[3] = {0, 0, 0};
  for (int r = 0; r < 3; ++r) {
    v[r] = radar_rot[r * 3 + 0] * vx + radar_rot[r * 3 + 1] * vy;
  }
  // ref_rot^T @ v  →  out[r] = Σ_c ref_rot[c*3+r] * v[c]
  for (int r = 0; r < 2; ++r) {
    out_xy[r] = ref_rot[0 * 3 + r] * v[0] + ref_rot[1 * 3 + r] * v[1] +
                ref_rot[2 * 3 + r] * v[2];
  }
}

}  // namespace

extern "C" {

// points[ch]: [18 * n] row-major (18 rows of n columns, the devkit layout);
// times[ch]: [n]; rots: [n_ch * 9] row-major; ref_rot: [9];
// range: [6] (xmin ymin zmin xmax ymax zmax); out: [num_tokens * 36].
// Returns the number of real (non-padding) tokens written.
int radar_featurize(const float* const* points, const float* const* times,
                    const int* counts, int n_channels,
                    const double* rots, const double* ref_rot,
                    const float* range, float pad_value, int num_tokens,
                    float* out) {
  for (int i = 0; i < num_tokens * kFeat; ++i) out[i] = pad_value;

  int fill = 0;
  for (int ch = 0; ch < n_channels && fill < num_tokens; ++ch) {
    const int n = counts[ch];
    const float* p = points[ch];
    const float* t = times[ch];
    const double* rrot = rots + ch * 9;

    // relative timestamps: t - max(t) (detr3d_head.py:453-455)
    float tmax = 0.0f;
    if (n > 0) {
      tmax = t[0];
      for (int i = 1; i < n; ++i) tmax = std::max(tmax, t[i]);
    }

    for (int i = 0; i < n && fill < num_tokens; ++i) {
      const float x = p[0 * n + i], y = p[1 * n + i], z = p[2 * n + i];
      if (!(x > range[0] && y > range[1] && z > range[2] && x < range[3] &&
            y < range[4] && z < range[5])) {
        continue;
      }
      float* o = out + fill * kFeat;
      // base columns: x y z id rcs is_quality_valid invalid_state
      o[0] = x;
      o[1] = y;
      o[2] = z;
      o[3] = p[4 * n + i];
      o[4] = p[5 * n + i];
      o[5] = p[10 * n + i];
      o[6] = p[14 * n + i];
      const float trel = t[i] - tmax;
      o[7] = trel;
      o[8] = trel;
      double vc[2], vr[2];
      rotate_vel(rrot, ref_rot, p[8 * n + i], p[9 * n + i], vc);  // comp
      rotate_vel(rrot, ref_rot, p[6 * n + i], p[7 * n + i], vr);  // raw
      o[9] = static_cast<float>(vc[0]) * trel;   // offset = v_comp · Δt
      o[10] = static_cast<float>(vc[1]) * trel;
      o[11] = static_cast<float>(vc[0]);
      o[12] = static_cast<float>(vc[1]);
      o[13] = static_cast<float>(vr[0]);
      o[14] = static_cast<float>(vr[1]);
      for (int j = 15; j < kFeat; ++j) o[j] = 0.0f;
      const int dyn = std::clamp(static_cast<int>(p[3 * n + i]), 0, 7);
      const int amb = std::clamp(static_cast<int>(p[11 * n + i]), 0, 4);
      const int pdh = std::clamp(static_cast<int>(p[15 * n + i]), 0, 7);
      o[15 + dyn] = 1.0f;
      o[23 + amb] = 1.0f;
      o[28 + pdh] = 1.0f;
      ++fill;
    }
  }
  return fill;
}

}  // extern "C"
