// Native replay-session loader.
//
// Parses recorded planning-session JSON logs (schema of the reference's
// demo/json_demo.py:255-275: a list of frames with car_position,
// car_direction and slam_cones = 5 per-type cone lists) straight into the
// packed fixed-shape tensors the planner consumes:
//   cones (T, N, 3) float32 [x, y, color], mask (T, N) uint8,
//   positions (T, 2), directions (T, 2).
//
// This is the framework's native data path: zero Python-object churn between
// disk and device buffers. Built as a shared library, bound via ctypes.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Parser {
  const char* p;
  const char* end;
  bool ok = true;

  explicit Parser(const char* data, size_t len) : p(data), end(data + len) {}

  void skip_ws() {
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\n' || *p == '\r' || *p == ','))
      ++p;
  }

  bool expect(char c) {
    skip_ws();
    if (p < end && *p == c) {
      ++p;
      return true;
    }
    ok = false;
    return false;
  }

  bool peek(char c) {
    skip_ws();
    return p < end && *p == c;
  }

  double number() {
    skip_ws();
    char* out = nullptr;
    double v = strtod(p, &out);
    if (out == p) ok = false;
    p = out;
    return v;
  }

  // parse a possibly nested array of numbers, appending all scalars in order
  void flat_number_array(std::vector<double>* out) {
    if (!expect('[')) return;
    while (ok) {
      skip_ws();
      if (p >= end) {
        ok = false;
        return;
      }
      if (*p == ']') {
        ++p;
        return;
      }
      if (*p == '[') {
        flat_number_array(out);
      } else {
        out->push_back(number());
      }
    }
  }

  std::string key() {
    skip_ws();
    if (p >= end || *p != '"') {
      ok = false;
      return {};
    }
    ++p;
    const char* start = p;
    while (p < end && *p != '"') ++p;
    std::string k(start, static_cast<size_t>(p - start));
    if (p < end) ++p;  // closing quote
    expect(':');
    return k;
  }

  void skip_value();  // forward

  void skip_object() {
    if (!expect('{')) return;
    while (ok) {
      skip_ws();
      if (p >= end) {
        ok = false;
        return;
      }
      if (*p == '}') {
        ++p;
        return;
      }
      key();
      skip_value();
    }
  }

  void skip_array() {
    if (!expect('[')) return;
    while (ok) {
      skip_ws();
      if (p >= end) {
        ok = false;
        return;
      }
      if (*p == ']') {
        ++p;
        return;
      }
      skip_value();
    }
  }
};

void Parser::skip_value() {
  skip_ws();
  if (p >= end) {
    ok = false;
    return;
  }
  switch (*p) {
    case '{':
      skip_object();
      return;
    case '[':
      skip_array();
      return;
    case '"': {
      ++p;
      while (p < end && *p != '"') {
        if (*p == '\\') ++p;
        ++p;
      }
      if (p < end) ++p;
      return;
    }
    default:
      number();
  }
}

}  // namespace

extern "C" {

// Returns number of frames parsed (>= 0), or -1 on error.
// Buffers must hold max_frames worth of data; extra frames are dropped.
int rl_load_session(const char* path, int n_max, int max_frames,
                    float* cones /* (T, n_max, 3) */, uint8_t* mask /* (T, n_max) */,
                    float* positions /* (T, 2) */, float* directions /* (T, 2) */) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  fseek(f, 0, SEEK_END);
  long size = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::string data(static_cast<size_t>(size), '\0');
  size_t got = fread(data.data(), 1, static_cast<size_t>(size), f);
  fclose(f);
  if (got != static_cast<size_t>(size)) return -1;

  Parser ps(data.data(), data.size());
  if (!ps.expect('[')) return -1;

  int t = 0;
  std::vector<double> scratch;
  while (ps.ok && t < max_frames) {
    ps.skip_ws();
    if (ps.p >= ps.end) break;
    if (*ps.p == ']') break;
    if (!ps.expect('{')) break;

    double px = 0, py = 0, dx = 1, dy = 0;
    float* frame_cones = cones + static_cast<size_t>(t) * n_max * 3;
    uint8_t* frame_mask = mask + static_cast<size_t>(t) * n_max;
    for (int i = 0; i < n_max; ++i) {
      frame_cones[i * 3 + 0] = 0.f;
      frame_cones[i * 3 + 1] = 0.f;
      frame_cones[i * 3 + 2] = -1.f;
      frame_mask[i] = 0;
    }

    while (ps.ok) {
      ps.skip_ws();
      if (ps.p >= ps.end) {
        ps.ok = false;
        break;
      }
      if (*ps.p == '}') {
        ++ps.p;
        break;
      }
      std::string k = ps.key();
      if (!ps.ok) break;
      if (k == "car_position") {
        scratch.clear();
        ps.flat_number_array(&scratch);
        if (scratch.size() >= 2) {
          px = scratch[0];
          py = scratch[1];
        }
      } else if (k == "car_direction") {
        scratch.clear();
        ps.flat_number_array(&scratch);
        if (scratch.size() >= 2) {
          dx = scratch[0];
          dy = scratch[1];
        }
      } else if (k == "slam_cones") {
        // 5 per-type lists, flattened in type order (matches the reference's
        // flatten_cones_by_type_array, core_trace_sorter.py:37-54)
        if (!ps.expect('[')) break;
        int slot = 0;
        for (int type = 0; type < 5 && ps.ok; ++type) {
          scratch.clear();
          ps.flat_number_array(&scratch);
          for (size_t j = 0; j + 1 < scratch.size(); j += 2) {
            if (slot >= n_max) break;
            frame_cones[slot * 3 + 0] = static_cast<float>(scratch[j]);
            frame_cones[slot * 3 + 1] = static_cast<float>(scratch[j + 1]);
            frame_cones[slot * 3 + 2] = static_cast<float>(type);
            frame_mask[slot] = 1;
            ++slot;
          }
        }
        if (!ps.expect(']')) break;
      } else {
        ps.skip_value();
      }
    }
    if (!ps.ok) return -1;

    positions[t * 2 + 0] = static_cast<float>(px);
    positions[t * 2 + 1] = static_cast<float>(py);
    directions[t * 2 + 0] = static_cast<float>(dx);
    directions[t * 2 + 1] = static_cast<float>(dy);
    ++t;
  }
  return t;
}

}  // extern "C"
