// Fast JSON trace parser (the port's own copy of the JAX package's
// native/trace_parser.cc; the same grammar and return codes).
//
// A single-pass scanner turns a trace file into a packed float32
// (x, y, z, t) array, roughly an order of magnitude faster than json.load.
//
// Grammar subset: any JSON where trace rows are innermost objects holding
// numeric "x"/"y"/"z"/"timestamp" members (bare list or {"traces": [...]}
// / {"trajectory": [...]} wrappers both land here). Strings/escapes are
// skipped correctly; any structural surprise returns an error so the caller
// can hand the file to the python parser.

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

struct Fields {
  double x = 0, y = 0, z = 0, t = 0;
  bool has_x = false, has_y = false, has_z = false, has_t = false;
  // only objects that are array ELEMENTS qualify as trace rows; a metadata
  // object that happens to carry x/y/z/timestamp keys must not inject rows
  bool in_array = false;
  void reset() { has_x = has_y = has_z = has_t = false; x = y = z = t = 0; }
  bool complete() const { return has_x && has_y && has_z && has_t; }
};

const char* skip_ws(const char* p, const char* end) {
  while (p < end && (*p == ' ' || *p == '\t' || *p == '\n' || *p == '\r'))
    ++p;
  return p;
}

// past the opening quote -> pointer past the closing quote; writes the key
// into buf (truncated).
const char* parse_string(const char* p, const char* end, char* buf,
                         size_t buflen) {
  size_t n = 0;
  while (p < end && *p != '"') {
    if (*p == '\\' && p + 1 < end) ++p;  // skip escaped char
    if (buf && n + 1 < buflen) buf[n++] = *p;
    ++p;
  }
  if (buf) buf[n] = 0;
  return p < end ? p + 1 : end;  // past closing quote
}

}  // namespace

extern "C" {

// Parse the file at `path`. On success returns the number of rows and sets
// *out to a malloc'd [rows * 4] float32 array of (x, y, z, t).
// Returns -1 on I/O error, -2 on parse anomaly (caller should fall back).
long parse_trace_file(const char* path, float** out) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  fseek(f, 0, SEEK_END);
  long size = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::vector<char> buf(size + 1);
  if (fread(buf.data(), 1, size, f) != static_cast<size_t>(size)) {
    fclose(f);
    return -1;
  }
  fclose(f);
  buf[size] = 0;

  const char* p = buf.data();
  const char* end = p + size;

  std::vector<float> rows;
  rows.reserve(1 << 16);

  // stack of field accumulators per object depth
  std::vector<Fields> stack;
  stack.reserve(8);
  // container nesting ('[' or '{') so we know whether an object is an
  // array element (a candidate trace row) or an object member (metadata)
  std::vector<char> containers;
  containers.reserve(8);
  char key[32];
  bool have_key = false;
  char cur_key[32] = {0};

  while (p < end) {
    p = skip_ws(p, end);
    if (p >= end) break;
    char c = *p;
    if (c == '{') {
      stack.emplace_back();
      stack.back().in_array =
          !containers.empty() && containers.back() == '[';
      containers.push_back('{');
      have_key = false;
      ++p;
    } else if (c == '}') {
      if (stack.empty() || containers.empty() || containers.back() != '{')
        return -2;
      containers.pop_back();
      Fields& fl = stack.back();
      if (fl.complete()) {
        if (!fl.in_array) return -2;  // x/y/z/t object outside an array
        rows.push_back(static_cast<float>(fl.x));
        rows.push_back(static_cast<float>(fl.y));
        rows.push_back(static_cast<float>(fl.z));
        rows.push_back(static_cast<float>(fl.t));
      }
      stack.pop_back();
      have_key = false;
      ++p;
    } else if (c == '"') {
      ++p;
      p = parse_string(p, end, key, sizeof(key));
      p = skip_ws(p, end);
      if (p < end && *p == ':') {
        std::strncpy(cur_key, key, sizeof(cur_key) - 1);
        have_key = true;
        ++p;
      } else {
        have_key = false;  // string value, not a key
      }
    } else if ((c >= '0' && c <= '9') || c == '-' || c == '+') {
      char* num_end = nullptr;
      double v = strtod(p, &num_end);
      if (num_end == p) return -2;
      p = num_end;
      if (have_key && !stack.empty()) {
        Fields& fl = stack.back();
        if (!std::strcmp(cur_key, "x")) { fl.x = v; fl.has_x = true; }
        else if (!std::strcmp(cur_key, "y")) { fl.y = v; fl.has_y = true; }
        else if (!std::strcmp(cur_key, "z")) { fl.z = v; fl.has_z = true; }
        else if (!std::strcmp(cur_key, "timestamp")) {
          fl.t = v;
          fl.has_t = true;
        }
      }
      have_key = false;
    } else if (c == '[') {
      containers.push_back('[');
      have_key = false;
      ++p;
    } else if (c == ']') {
      if (containers.empty() || containers.back() != '[') return -2;
      containers.pop_back();
      ++p;
    } else if (c == ',' || c == ':') {
      ++p;
    } else if (!std::strncmp(p, "true", 4)) {
      p += 4;
      have_key = false;
    } else if (!std::strncmp(p, "false", 5)) {
      p += 5;
      have_key = false;
    } else if (!std::strncmp(p, "null", 4)) {
      p += 4;
      have_key = false;
    } else {
      return -2;
    }
  }
  if (!stack.empty() || !containers.empty()) return -2;

  long n = static_cast<long>(rows.size() / 4);
  *out = static_cast<float*>(std::malloc(rows.size() * sizeof(float)));
  if (!*out) return -1;
  std::memcpy(*out, rows.data(), rows.size() * sizeof(float));
  return n;
}

void free_trace(float* p) { std::free(p); }

}  // extern "C"
