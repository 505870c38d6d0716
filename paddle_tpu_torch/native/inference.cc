// Native C inference runner: load a saved inference bundle
// (__model__ JSON program + one .npy per persistable, written by
// fluid/io.py save_inference_model) and run forward — with NO Python.
//
// Capability parity with the reference pure-C serving surface:
//   paddle/capi/gradient_machine.h:36  paddle_gradient_machine_create_for_inference
//   paddle/capi/gradient_machine.h:73  paddle_gradient_machine_forward
//   paddle/fluid/inference/io.cc:108   inference::Load (ProgramDesc + persistables)
//
// The JAX package's runner (paddle_tpu/native/inference.cc), copied with
// its C ABI: training and batch serving run on the card; this
// runner is the *edge/embedded* path the reference's capi serves —
// a dependency-free CPU interpreter over the same language-neutral
// bundle, exposed as a C ABI loaded via ctypes/dlopen from any host
// language. f32 compute; integer feeds (embedding ids) are carried as
// a separate int64 payload per tensor.
//
// Build: g++ -O2 -std=c++17 -shared -fPIC -pthread inference.cc -o libptpu_infer.so
// (paddle_tpu_torch/native/__init__.py builds it at first use).

#include <algorithm>
#include <cctype>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <fstream>
#include <map>
#include <memory>
#include <set>
#include <limits>
#include <sstream>
#include <string>
#include <vector>

namespace {

// ---------------------------------------------------------------------
// Minimal JSON value + recursive-descent parser (schema is our own, so
// only the constructs serialization.py emits need to parse).
// ---------------------------------------------------------------------
struct JValue {
  enum Kind { NUL, BOOL, NUM, STR, ARR, OBJ } kind = NUL;
  bool b = false;
  double num = 0;
  std::string str;
  std::vector<JValue> arr;
  std::vector<std::pair<std::string, JValue>> obj;  // ordered

  const JValue* get(const std::string& k) const {
    for (auto& kv : obj)
      if (kv.first == k) return &kv.second;
    return nullptr;
  }
  double as_num(double dflt = 0) const { return kind == NUM ? num : dflt; }
  bool as_bool(bool dflt = false) const { return kind == BOOL ? b : dflt; }
};

struct JParser {
  const char* p;
  const char* end;
  bool ok = true;

  explicit JParser(const std::string& s) : p(s.data()), end(s.data() + s.size()) {}

  void ws() {
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\n' || *p == '\r')) ++p;
  }
  bool eat(char c) {
    ws();
    if (p < end && *p == c) {
      ++p;
      return true;
    }
    return false;
  }
  JValue parse() {
    JValue v;
    ws();
    if (p >= end) {
      ok = false;
      return v;
    }
    char c = *p;
    if (c == '{') {
      ++p;
      v.kind = JValue::OBJ;
      ws();
      if (eat('}')) return v;
      do {
        ws();
        JValue key = parse_string();
        if (!ok || !eat(':')) {
          ok = false;
          return v;
        }
        v.obj.emplace_back(key.str, parse());
      } while (eat(','));
      if (!eat('}')) ok = false;
    } else if (c == '[') {
      ++p;
      v.kind = JValue::ARR;
      ws();
      if (eat(']')) return v;
      do {
        v.arr.push_back(parse());
      } while (eat(','));
      if (!eat(']')) ok = false;
    } else if (c == '"') {
      v = parse_string();
    } else if (c == 't') {
      v.kind = JValue::BOOL;
      v.b = true;
      p += 4;
    } else if (c == 'f') {
      v.kind = JValue::BOOL;
      v.b = false;
      p += 5;
    } else if (c == 'n') {
      v.kind = JValue::NUL;
      p += 4;
    } else {
      v.kind = JValue::NUM;
      char* q = nullptr;
      v.num = strtod(p, &q);
      if (q == p) ok = false;
      p = q;
    }
    return v;
  }
  JValue parse_string() {
    JValue v;
    v.kind = JValue::STR;
    ws();
    if (p >= end || *p != '"') {
      ok = false;
      return v;
    }
    ++p;
    while (p < end && *p != '"') {
      if (*p == '\\' && p + 1 < end) {
        ++p;
        switch (*p) {
          case 'n': v.str += '\n'; break;
          case 't': v.str += '\t'; break;
          case 'r': v.str += '\r'; break;
          case 'u': {  // \uXXXX — bundle names are ASCII; keep low byte
            unsigned code = 0;
            sscanf(p + 1, "%4x", &code);
            p += 4;
            v.str += static_cast<char>(code & 0xff);
            break;
          }
          default: v.str += *p;
        }
      } else {
        v.str += *p;
      }
      ++p;
    }
    ++p;  // closing quote
    return v;
  }
};

// ---------------------------------------------------------------------
// Tensor: f32 buffer + optional i64 view (for embedding ids / labels)
// ---------------------------------------------------------------------
struct Tensor {
  std::vector<int64_t> shape;
  std::vector<float> f;
  std::vector<int64_t> i;  // non-empty when the tensor is integral
  // ragged metadata: sequence start offsets over rows (reference
  // LoDTensor level 0; the Python side's "<name>@LOD0" side-band)
  std::vector<int64_t> lod;
  bool is_int = false;

  int64_t numel() const {
    int64_t n = 1;
    for (auto d : shape) n *= d;
    return n;
  }
  void resize_like_shape() {
    if (is_int)
      i.assign(numel(), 0);
    else
      f.assign(numel(), 0.f);
  }
  float at(int64_t k) const { return is_int ? static_cast<float>(i[k]) : f[k]; }
};

// flatten [d0..dk-1, dk..dn] -> [prod(前), prod(后)]
static void flatten2(const Tensor& t, int num_col_dims, int64_t* rows,
                     int64_t* cols) {
  int64_t r = 1, c = 1;
  for (size_t k = 0; k < t.shape.size(); ++k) {
    if ((int)k < num_col_dims)
      r *= t.shape[k];
    else
      c *= t.shape[k];
  }
  *rows = r;
  *cols = c;
}

// ---------------------------------------------------------------------
// .npy reader (format spec 1.0): magic, header dict, raw little-endian
// ---------------------------------------------------------------------
static bool load_npy(const std::string& path, Tensor* out) {
  std::ifstream fs(path, std::ios::binary);
  if (!fs) return false;
  char magic[6];
  fs.read(magic, 6);
  if (memcmp(magic, "\x93NUMPY", 6) != 0) return false;
  unsigned char ver[2];
  fs.read(reinterpret_cast<char*>(ver), 2);
  uint32_t hlen = 0;
  if (ver[0] == 1) {
    uint16_t h16 = 0;
    fs.read(reinterpret_cast<char*>(&h16), 2);
    hlen = h16;
  } else {
    fs.read(reinterpret_cast<char*>(&hlen), 4);
  }
  std::string header(hlen, '\0');
  fs.read(&header[0], hlen);

  auto find_val = [&](const char* key) -> std::string {
    auto pos = header.find(key);
    if (pos == std::string::npos) return "";
    pos = header.find(':', pos);
    auto endp = header.find(',', pos);
    // shape tuple contains commas: go to matching ')'
    auto paren = header.find('(', pos);
    if (paren != std::string::npos && paren < endp) {
      endp = header.find(')', paren);
      if (endp != std::string::npos) ++endp;
    }
    return header.substr(pos + 1, endp - pos - 1);
  };
  std::string descr = find_val("'descr'");
  std::string shape_s = find_val("'shape'");
  bool fortran = find_val("'fortran_order'").find("True") != std::string::npos;
  if (fortran) return false;  // numpy default is C order; we only emit that

  out->shape.clear();
  for (size_t k = 0; k < shape_s.size();) {
    if (isdigit(shape_s[k])) {
      char* q = nullptr;
      out->shape.push_back(strtoll(&shape_s[k], &q, 10));
      k = q - shape_s.data();
    } else {
      ++k;
    }
  }
  int64_t n = 1;
  for (auto d : out->shape) n *= d;

  auto read_all = [&](void* dst, size_t bytes) {
    fs.read(reinterpret_cast<char*>(dst), bytes);
    return fs.good() || fs.eof();
  };
  if (descr.find("f4") != std::string::npos) {
    out->is_int = false;
    out->f.resize(n);
    return read_all(out->f.data(), n * 4);
  }
  if (descr.find("f8") != std::string::npos) {
    std::vector<double> tmp(n);
    if (!read_all(tmp.data(), n * 8)) return false;
    out->is_int = false;
    out->f.assign(tmp.begin(), tmp.end());
    return true;
  }
  if (descr.find("i8") != std::string::npos) {
    out->is_int = true;
    out->i.resize(n);
    return read_all(out->i.data(), n * 8);
  }
  if (descr.find("i4") != std::string::npos) {
    std::vector<int32_t> tmp(n);
    if (!read_all(tmp.data(), n * 4)) return false;
    out->is_int = true;
    out->i.assign(tmp.begin(), tmp.end());
    return true;
  }
  return false;
}

// io.py _escape: '/' -> "%2F"
static std::string escape_name(const std::string& name) {
  std::string out;
  for (char c : name)
    if (c == '/')
      out += "%2F";
    else
      out += c;
  return out;
}

// ---------------------------------------------------------------------
// Op descriptors + interpreter
// ---------------------------------------------------------------------
struct OpDesc {
  std::string type;
  std::map<std::string, std::vector<std::string>> inputs, outputs;
  JValue attrs;

  const std::string& in(const char* slot, int k = 0) const {
    static const std::string empty;
    auto it = inputs.find(slot);
    return (it != inputs.end() && (int)it->second.size() > k) ? it->second[k]
                                                              : empty;
  }
  const std::string& out(const char* slot, int k = 0) const {
    static const std::string empty;
    auto it = outputs.find(slot);
    return (it != outputs.end() && (int)it->second.size() > k) ? it->second[k]
                                                               : empty;
  }
  double attr_num(const char* k, double dflt = 0) const {
    const JValue* v = attrs.get(k);
    return v ? v->as_num(dflt) : dflt;
  }
  bool attr_bool(const char* k, bool dflt = false) const {
    const JValue* v = attrs.get(k);
    return v ? v->as_bool(dflt) : dflt;
  }
  std::vector<int64_t> attr_ints(const char* k) const {
    std::vector<int64_t> out;
    const JValue* v = attrs.get(k);
    if (v && v->kind == JValue::ARR)
      for (auto& e : v->arr) out.push_back((int64_t)e.as_num());
    return out;
  }
  std::string attr_str(const char* k) const {
    const JValue* v = attrs.get(k);
    return (v && v->kind == JValue::STR) ? v->str : "";
  }
};

struct Model {
  std::vector<OpDesc> ops;  // block 0 only: inference programs are flat
  std::map<std::string, Tensor> vars;  // persistables + runtime values
  std::vector<std::string> feed_names, fetch_names;
  std::map<std::string, bool> var_is_int;
  // names whose lod was set by the caller (ptpu_infer_set_input_lod):
  // every OTHER var's lod is derived and cleared at each forward so a
  // second run with different offsets cannot read run-1's stale LoD
  std::map<std::string, bool> fed_lod;
  std::string error;
};

static Tensor* named(Model& m, const std::string& name) {
  return name.empty() ? nullptr : &m.vars[name];
}

// Integral tensors carry values in .i with .f empty; kernels whose inner
// loops index x.f directly (layer_norm, lrn, gru, lstm) must reject them
// up front instead of reading out of bounds.
static bool require_float(Model& m, const Tensor& t, const char* op_type,
                          const char* slot) {
  if (t.is_int) {
    m.error = std::string(op_type) + ": integral tensor fed to float slot " +
              slot + " (cast it first)";
    return false;
  }
  return true;
}

static void softmax_lastdim(const Tensor& x, Tensor* y) {
  y->shape = x.shape;
  y->is_int = false;
  int64_t C = x.shape.empty() ? 1 : x.shape.back();
  int64_t R = x.numel() / std::max<int64_t>(C, 1);
  y->f.resize(x.numel());
  for (int64_t r = 0; r < R; ++r) {
    const float* px = &x.f[r * C];
    float* py = &y->f[r * C];
    float mx = px[0];
    for (int64_t c = 1; c < C; ++c) mx = std::max(mx, px[c]);
    float s = 0;
    for (int64_t c = 0; c < C; ++c) {
      py[c] = std::exp(px[c] - mx);
      s += py[c];
    }
    for (int64_t c = 0; c < C; ++c) py[c] /= s;
  }
}

static bool eltwise(Model& m, const OpDesc& op, char kind) {
  Tensor& x = m.vars[op.in("X")];
  Tensor& y = m.vars[op.in("Y")];
  Tensor* o = named(m, op.out("Out"));
  o->shape = x.shape;
  o->is_int = false;
  o->f.resize(x.numel());
  int axis = (int)op.attr_num("axis", -1);
  // broadcast y over x starting at `axis` (reference elementwise broadcast)
  int64_t ny = y.numel(), nx = x.numel();
  if (axis < 0) axis = (int)x.shape.size() - (int)y.shape.size();
  int64_t pre = 1, mid = 1, post = 1;
  for (int k = 0; k < (int)x.shape.size(); ++k) {
    if (k < axis)
      pre *= x.shape[k];
    else if (k < axis + (int)y.shape.size())
      mid *= x.shape[k];
    else
      post *= x.shape[k];
  }
  if (mid != ny) {  // same-shape fast path (or scalar)
    pre = 1;
    mid = ny;
    post = nx / std::max<int64_t>(ny, 1);
    if (mid * post != nx) {
      m.error = "elementwise broadcast mismatch on " + op.in("X");
      return false;
    }
  }
  for (int64_t a = 0; a < pre; ++a)
    for (int64_t b = 0; b < mid; ++b) {
      float yv = y.at(b);
      for (int64_t c = 0; c < post; ++c) {
        int64_t k = (a * mid + b) * post + c;
        float xv = x.at(k);
        switch (kind) {
          case '+': o->f[k] = xv + yv; break;
          case '-': o->f[k] = xv - yv; break;
          case '*': o->f[k] = xv * yv; break;
          case '/': o->f[k] = xv / yv; break;
        }
      }
    }
  return true;
}

static bool conv2d(Model& m, const OpDesc& op) {
  Tensor& x = m.vars[op.in("Input")];
  if (!require_float(m, x, "conv2d", "Input")) return false;
  Tensor& w = m.vars[op.in("Filter")];
  Tensor* o = named(m, op.out("Output"));
  auto strides = op.attr_ints("strides");
  auto pads = op.attr_ints("paddings");
  int64_t g = (int64_t)op.attr_num("groups", 1);
  if (g < 1) g = 1;
  int64_t sh = strides.empty() ? 1 : strides[0];
  int64_t sw = strides.size() > 1 ? strides[1] : sh;
  int64_t ph = pads.empty() ? 0 : pads[0];
  int64_t pw = pads.size() > 1 ? pads[1] : ph;
  int64_t N = x.shape[0], C = x.shape[1], H = x.shape[2], W = x.shape[3];
  int64_t M = w.shape[0], Cg = w.shape[1], KH = w.shape[2], KW = w.shape[3];
  int64_t OH = (H + 2 * ph - KH) / sh + 1, OW = (W + 2 * pw - KW) / sw + 1;
  o->shape = {N, M, OH, OW};
  o->is_int = false;
  o->f.assign(N * M * OH * OW, 0.f);
  int64_t Mg = M / g;
  for (int64_t n = 0; n < N; ++n)
    for (int64_t mo = 0; mo < M; ++mo) {
      int64_t grp = mo / Mg;
      for (int64_t oh = 0; oh < OH; ++oh)
        for (int64_t ow = 0; ow < OW; ++ow) {
          float acc = 0;
          for (int64_t ci = 0; ci < Cg; ++ci) {
            int64_t c = grp * Cg + ci;
            for (int64_t kh = 0; kh < KH; ++kh) {
              int64_t ih = oh * sh - ph + kh;
              if (ih < 0 || ih >= H) continue;
              for (int64_t kw = 0; kw < KW; ++kw) {
                int64_t iw = ow * sw - pw + kw;
                if (iw < 0 || iw >= W) continue;
                acc += x.f[((n * C + c) * H + ih) * W + iw] *
                       w.f[((mo * Cg + ci) * KH + kh) * KW + kw];
              }
            }
          }
          o->f[((n * M + mo) * OH + oh) * OW + ow] = acc;
        }
    }
  return true;
}

static bool pool2d(Model& m, const OpDesc& op) {
  Tensor& x = m.vars[op.in("X")];
  if (!require_float(m, x, "pool2d", "X")) return false;
  Tensor* o = named(m, op.out("Out"));
  auto ksize = op.attr_ints("ksize");
  auto strides = op.attr_ints("strides");
  auto pads = op.attr_ints("paddings");
  bool global = op.attr_bool("global_pooling", false);
  bool is_max = op.attr_str("pooling_type") != "avg";
  int64_t N = x.shape[0], C = x.shape[1], H = x.shape[2], W = x.shape[3];
  int64_t kh = global ? H : (ksize.empty() ? 2 : ksize[0]);
  int64_t kw = global ? W : (ksize.size() > 1 ? ksize[1] : kh);
  int64_t sh = strides.empty() ? kh : strides[0];
  int64_t sw = strides.size() > 1 ? strides[1] : sh;
  int64_t ph = (global || pads.empty()) ? 0 : pads[0];
  int64_t pw = (global || pads.size() < 2) ? ph : pads[1];
  int64_t OH = (H + 2 * ph - kh) / sh + 1, OW = (W + 2 * pw - kw) / sw + 1;
  o->shape = {N, C, OH, OW};
  o->is_int = false;
  o->f.assign(N * C * OH * OW, 0.f);
  for (int64_t n = 0; n < N; ++n)
    for (int64_t c = 0; c < C; ++c)
      for (int64_t oh = 0; oh < OH; ++oh)
        for (int64_t ow = 0; ow < OW; ++ow) {
          float best = is_max ? -3.4e38f : 0.f;
          int64_t cnt = 0;
          for (int64_t i = 0; i < kh; ++i) {
            int64_t ih = oh * sh - ph + i;
            if (ih < 0 || ih >= H) continue;
            for (int64_t j = 0; j < kw; ++j) {
              int64_t iw = ow * sw - pw + j;
              if (iw < 0 || iw >= W) continue;
              float v = x.f[((n * C + c) * H + ih) * W + iw];
              if (is_max)
                best = std::max(best, v);
              else
                best += v;
              ++cnt;
            }
          }
          o->f[((n * C + c) * OH + oh) * OW + ow] =
              is_max ? best : best / std::max<int64_t>(cnt, 1);
        }
  return true;
}

static bool run_op(Model& m, const OpDesc& op) {
  const std::string& t = op.type;
  if (t == "feed" || t == "fetch") return true;
  if (t == "mul") {
    Tensor& x = m.vars[op.in("X")];
    Tensor& y = m.vars[op.in("Y")];
    if (!require_float(m, y, "mul", "Y")) return false;
    Tensor* o = named(m, op.out("Out"));
    int xnc = (int)op.attr_num("x_num_col_dims", 1);
    int ync = (int)op.attr_num("y_num_col_dims", 1);
    int64_t Rx, Cx, Ry, Cy;
    flatten2(x, xnc, &Rx, &Cx);
    flatten2(y, ync, &Ry, &Cy);
    if (Cx != Ry) {
      m.error = "mul shape mismatch";
      return false;
    }
    o->shape.clear();
    for (int k = 0; k < xnc; ++k) o->shape.push_back(x.shape[k]);
    for (size_t k = ync; k < y.shape.size(); ++k) o->shape.push_back(y.shape[k]);
    o->is_int = false;
    o->f.assign(Rx * Cy, 0.f);
    for (int64_t r = 0; r < Rx; ++r)
      for (int64_t k = 0; k < Cx; ++k) {
        float xv = x.at(r * Cx + k);
        if (xv == 0.f) continue;
        const float* py = &y.f[k * Cy];
        float* po = &o->f[r * Cy];
        for (int64_t c = 0; c < Cy; ++c) po[c] += xv * py[c];
      }
    return true;
  }
  if (t == "elementwise_add") return eltwise(m, op, '+');
  if (t == "elementwise_sub") return eltwise(m, op, '-');
  if (t == "elementwise_mul") return eltwise(m, op, '*');
  if (t == "elementwise_div") return eltwise(m, op, '/');
  if (t == "relu" || t == "sigmoid" || t == "tanh" || t == "exp" ||
      t == "sqrt" || t == "abs" || t == "square") {
    Tensor& x = m.vars[op.in("X")];
    Tensor* o = named(m, op.out("Out"));
    o->shape = x.shape;
    o->is_int = false;
    o->f.resize(x.numel());
    for (int64_t k = 0; k < x.numel(); ++k) {
      float v = x.at(k);
      if (t == "relu")
        v = v > 0 ? v : 0;
      else if (t == "sigmoid")
        v = 1.f / (1.f + std::exp(-v));
      else if (t == "tanh")
        v = std::tanh(v);
      else if (t == "exp")
        v = std::exp(v);
      else if (t == "sqrt")
        v = std::sqrt(v);
      else if (t == "abs")
        v = std::fabs(v);
      else
        v = v * v;
      o->f[k] = v;
    }
    return true;
  }
  if (t == "softmax") {
    if (!require_float(m, m.vars[op.in("X")], "softmax", "X")) return false;
    softmax_lastdim(m.vars[op.in("X")], named(m, op.out("Out")));
    return true;
  }
  if (t == "scale") {
    Tensor& x = m.vars[op.in("X")];
    Tensor* o = named(m, op.out("Out"));
    float s = (float)op.attr_num("scale", 1.0);
    float bias = (float)op.attr_num("bias", 0.0);
    o->shape = x.shape;
    o->is_int = false;
    o->f.resize(x.numel());
    for (int64_t k = 0; k < x.numel(); ++k) o->f[k] = x.at(k) * s + bias;
    return true;
  }
  if (t == "mean") {
    Tensor& x = m.vars[op.in("X")];
    Tensor* o = named(m, op.out("Out"));
    double s = 0;
    for (int64_t k = 0; k < x.numel(); ++k) s += x.at(k);
    o->shape = {1};
    o->is_int = false;
    o->f = {(float)(s / std::max<int64_t>(x.numel(), 1))};
    return true;
  }
  if (t == "sum") {
    auto it = op.inputs.find("X");
    Tensor* o = named(m, op.out("Out"));
    const Tensor& first = m.vars[it->second[0]];
    o->shape = first.shape;
    o->is_int = false;
    o->f.assign(first.numel(), 0.f);
    for (auto& nm : it->second) {
      Tensor& x = m.vars[nm];
      for (int64_t k = 0; k < x.numel(); ++k) o->f[k] += x.at(k);
    }
    return true;
  }
  if (t == "reshape" || t == "reshape2") {
    Tensor& x = m.vars[op.in("X")];
    Tensor* o = named(m, op.out("Out"));
    auto shape = op.attr_ints("shape");
    int64_t known = 1, infer = -1;
    for (size_t k = 0; k < shape.size(); ++k) {
      if (shape[k] == -1)
        infer = k;
      else
        known *= shape[k];
    }
    if (infer >= 0) shape[infer] = x.numel() / std::max<int64_t>(known, 1);
    *o = x;
    o->shape = shape;
    return true;
  }
  if (t == "dropout") {
    // inference semantics = downscale by keep probability (reference
    // dropout_op.cc default upscale_in_train=False; matches
    // kernels_nn.py _dropout's is_test branch)
    Tensor& x = m.vars[op.in("X")];
    Tensor* o = named(m, op.out("Out"));
    float keep = 1.f - (float)op.attr_num("dropout_prob", 0.5);
    o->shape = x.shape;
    o->is_int = false;
    o->f.resize(x.numel());
    for (int64_t kq = 0; kq < x.numel(); ++kq) o->f[kq] = x.at(kq) * keep;
    return true;
  }
  if (t == "batch_norm") {
    Tensor& x = m.vars[op.in("X")];
    Tensor& scale = m.vars[op.in("Scale")];
    Tensor& bias = m.vars[op.in("Bias")];
    Tensor& mean = m.vars[op.in("Mean")];
    Tensor& var = m.vars[op.in("Variance")];
    Tensor* o = named(m, op.out("Y"));
    float eps = (float)op.attr_num("epsilon", 1e-5);
    int64_t N = x.shape[0], C = x.shape.size() > 1 ? x.shape[1] : 1;
    int64_t inner = x.numel() / std::max<int64_t>(N * C, 1);
    o->shape = x.shape;
    o->is_int = false;
    o->f.resize(x.numel());
    for (int64_t n = 0; n < N; ++n)
      for (int64_t c = 0; c < C; ++c) {
        float inv = 1.f / std::sqrt(var.f[c] + eps);
        float a = scale.f[c] * inv;
        float b2 = bias.f[c] - mean.f[c] * a;
        for (int64_t k = 0; k < inner; ++k) {
          int64_t idx = (n * C + c) * inner + k;
          o->f[idx] = x.at(idx) * a + b2;
        }
      }
    return true;
  }
  if (t == "conv2d") return conv2d(m, op);
  if (t == "pool2d") return pool2d(m, op);
  if (t == "lrn") {
    // cross-channel local response normalisation (reference lrn_op.cc;
    // matches kernels_nn.py _lrn: window n centred with left pad n/2,
    // out = x * (k + alpha * sum(x^2 over window))^-beta)
    Tensor& x = m.vars[op.in("X")];
    if (!require_float(m, x, "lrn", "X")) return false;
    Tensor* o = named(m, op.out("Out"));
    int64_t n = (int64_t)op.attr_num("n", 5);
    float kk = (float)op.attr_num("k", 2.0);
    float alpha = (float)op.attr_num("alpha", 1e-4);
    float beta = (float)op.attr_num("beta", 0.75);
    int64_t N = x.shape[0], C = x.shape[1];
    int64_t inner = x.numel() / std::max<int64_t>(N * C, 1);
    o->shape = x.shape;
    o->is_int = false;
    o->f.resize(x.numel());
    int64_t half = n / 2;
    for (int64_t b = 0; b < N; ++b)
      for (int64_t c = 0; c < C; ++c) {
        int64_t c0 = std::max<int64_t>(c - half, 0);
        int64_t c1 = std::min<int64_t>(c - half + n, C);
        for (int64_t kx = 0; kx < inner; ++kx) {
          float acc = 0.f;
          for (int64_t cc = c0; cc < c1; ++cc) {
            float v = x.f[(b * C + cc) * inner + kx];
            acc += v * v;
          }
          int64_t idx = (b * C + c) * inner + kx;
          o->f[idx] = x.f[idx] * std::pow(kk + alpha * acc, -beta);
        }
      }
    return true;
  }
  if (t == "lookup_table") {
    Tensor& w = m.vars[op.in("W")];
    Tensor& ids = m.vars[op.in("Ids")];
    Tensor* o = named(m, op.out("Out"));
    int64_t V = w.shape[0], D = w.shape[1], n = ids.numel();
    // mirror the Python kernel's shape rule (kernels_tensor.py
    // _lookup_table): [N,1] ids -> [N,D]; otherwise ids.shape + [D]
    // (multi-field CTR ids [B,F] -> [B,F,D])
    o->shape = ids.shape;
    if (!o->shape.empty() && o->shape.back() == 1) o->shape.pop_back();
    o->shape.push_back(D);
    o->is_int = false;
    o->f.resize(n * D);
    int64_t padding_idx = (int64_t)op.attr_num("padding_idx", -1);
    for (int64_t k = 0; k < n; ++k) {
      int64_t id = ids.is_int ? ids.i[k] : (int64_t)ids.f[k];
      if (id < 0 || id >= V) {  // external feeds are untrusted
        m.error = "lookup_table id out of range: " + std::to_string(id) +
                  " (vocab " + std::to_string(V) + ")";
        return false;
      }
      if (id == padding_idx)  // kernels_tensor.py: padding rows read 0
        memset(&o->f[k * D], 0, D * sizeof(float));
      else
        memcpy(&o->f[k * D], &w.f[id * D], D * sizeof(float));
    }
    return true;
  }
  if (t == "reduce_sum" || t == "reduce_mean" || t == "reduce_max") {
    Tensor& x = m.vars[op.in("X")];
    Tensor* o = named(m, op.out("Out"));
    bool keep = op.attr_bool("keep_dim", false);
    int rank = (int)x.shape.size();
    std::vector<bool> red(rank, false);
    if (op.attr_bool("reduce_all", false)) {
      red.assign(rank, true);
    } else {
      std::vector<int64_t> dims = op.attr_ints("dim");
      if (dims.empty()) dims.push_back((int64_t)op.attr_num("dim", 0));
      for (int64_t d : dims) {
        if (d < 0) d += rank;
        if (d < 0 || d >= rank) {  // model files are untrusted input
          m.error = t + " dim out of range for rank " +
                    std::to_string(rank);
          return false;
        }
        red[d] = true;
      }
    }
    std::vector<int64_t> oshape;
    for (int k = 0; k < rank; ++k) {
      if (!red[k])
        oshape.push_back(x.shape[k]);
      else if (keep)
        oshape.push_back(1);
    }
    if (oshape.empty()) oshape.push_back(1);
    int64_t onum = 1;
    for (int64_t s : oshape) onum *= s;
    bool is_max = (t == "reduce_max");
    o->shape = oshape;
    o->is_int = false;
    o->f.assign(onum, is_max ? -std::numeric_limits<float>::infinity()
                             : 0.f);
    std::vector<int64_t> idx(rank, 0);
    for (int64_t k = 0; k < x.numel(); ++k) {
      int64_t oi = 0;
      for (int q = 0; q < rank; ++q)
        if (!red[q]) oi = oi * x.shape[q] + idx[q];
      if (is_max)
        o->f[oi] = std::max(o->f[oi], x.at(k));
      else
        o->f[oi] += x.at(k);
      for (int q = rank - 1; q >= 0; --q) {
        if (++idx[q] < x.shape[q]) break;
        idx[q] = 0;
      }
    }
    if (t == "reduce_mean") {
      // every output cell reduces the same number of input elements
      int64_t div = std::max<int64_t>(x.numel() / onum, 1);
      for (int64_t k = 0; k < onum; ++k) o->f[k] /= div;
    }
    return true;
  }
  if (t == "concat") {
    auto it = op.inputs.find("X");
    Tensor* o = named(m, op.out("Out"));
    int axis = (int)op.attr_num("axis", 0);
    const Tensor& first = m.vars[it->second[0]];
    if (axis < 0) axis += (int)first.shape.size();
    int64_t outer = 1, cat = 0, inner = 1;
    for (int k = 0; k < axis; ++k) outer *= first.shape[k];
    // explicit trailing product: numel()-based division breaks when the
    // first operand has 0 rows (an empty KV cache on decode step 0)
    for (size_t k = axis + 1; k < first.shape.size(); ++k)
      inner *= first.shape[k];
    for (auto& nm : it->second) cat += m.vars[nm].shape[axis];
    o->shape = first.shape;
    o->shape[axis] = cat;
    o->is_int = false;
    o->f.resize(outer * cat * inner);
    int64_t off = 0;
    for (auto& nm : it->second) {
      Tensor& x = m.vars[nm];
      int64_t xc = x.shape[axis];
      for (int64_t a = 0; a < outer; ++a)
        for (int64_t b = 0; b < xc; ++b)
          for (int64_t c = 0; c < inner; ++c)
            o->f[(a * cat + off + b) * inner + c] = x.at((a * xc + b) * inner + c);
      off += xc;
    }
    return true;
  }
  if (t == "im2sequence") {
    // reference operators/im2sequence_op.cc: sliding blocks -> rows in
    // (c, kh, kw) order, one sequence of oh*ow steps per image (matches
    // kernels_tensor.py _im2sequence / conv_general_dilated_patches)
    Tensor& x = m.vars[op.in("X")];
    if (!require_float(m, x, "im2sequence", "X")) return false;
    Tensor* o = named(m, op.out("Out"));
    auto ks = op.attr_ints("kernels");
    auto st = op.attr_ints("strides");
    auto pd = op.attr_ints("paddings");
    int64_t kh = ks.empty() ? 1 : ks[0], kw = ks.size() > 1 ? ks[1] : kh;
    int64_t sh = st.empty() ? 1 : st[0], sw = st.size() > 1 ? st[1] : sh;
    int64_t pu = pd.size() > 0 ? pd[0] : 0, pl = pd.size() > 1 ? pd[1] : 0;
    int64_t pb = pd.size() > 2 ? pd[2] : pu, pr = pd.size() > 3 ? pd[3] : pl;
    int64_t N = x.shape[0], C = x.shape[1], H = x.shape[2], W = x.shape[3];
    int64_t PH = H + pu + pb, PW = W + pl + pr;
    int64_t OH = (PH - kh) / sh + 1, OW = (PW - kw) / sw + 1;
    int64_t D = C * kh * kw;
    o->shape = {N * OH * OW, D};
    o->is_int = false;
    o->f.assign(N * OH * OW * D, 0.f);
    for (int64_t n = 0; n < N; ++n)
      for (int64_t oh = 0; oh < OH; ++oh)
        for (int64_t ow = 0; ow < OW; ++ow) {
          float* row = &o->f[((n * OH + oh) * OW + ow) * D];
          for (int64_t c = 0; c < C; ++c)
            for (int64_t a = 0; a < kh; ++a) {
              int64_t ih = oh * sh + a - pu;
              if (ih < 0 || ih >= H) continue;
              for (int64_t b2 = 0; b2 < kw; ++b2) {
                int64_t iw = ow * sw + b2 - pl;
                if (iw < 0 || iw >= W) continue;
                row[(c * kh + a) * kw + b2] =
                    x.f[((n * C + c) * H + ih) * W + iw];
              }
            }
        }
    o->lod.clear();
    for (int64_t n = 0; n <= N; ++n) o->lod.push_back(n * OH * OW);
    return true;
  }
  if (t == "gru") {
    // full-sequence GRU over a packed ragged batch (reference gru_op;
    // same math as kernels_rnn.py _gru: w[:, :H]=update, [H:2H]=reset,
    // [2H:]=candidate; x already holds the 3H input projection)
    Tensor& x = m.vars[op.in("Input")];
    if (!require_float(m, x, "gru", "Input")) return false;
    Tensor& w = m.vars[op.in("Weight")];
    Tensor* bias = op.in("Bias").empty() ? nullptr : &m.vars[op.in("Bias")];
    Tensor* h0 = op.in("H0").empty() ? nullptr : &m.vars[op.in("H0")];
    Tensor* o = named(m, op.out("Hidden"));
    if (x.lod.empty()) {
      m.error = "gru input has no sequence offsets (lod)";
      return false;
    }
    {
      // only the default activations are compiled in; a model asking
      // for others must fail loudly, not diverge silently
      std::string ga = op.attr_str("gate_activation");
      std::string ca = op.attr_str("activation");
      if ((!ga.empty() && ga != "sigmoid") || (!ca.empty() && ca != "tanh")) {
        m.error = "native gru supports gate_activation=sigmoid / "
                  "activation=tanh only (got " + ga + "/" + ca + ")";
        return false;
      }
    }
    bool reverse = op.attr_bool("is_reverse", false);
    int64_t Hd = w.shape[0];
    int64_t total = x.shape[0];
    o->shape = {total, Hd};
    o->is_int = false;
    o->f.assign(total * Hd, 0.f);
    o->lod = x.lod;
    std::vector<float> h(Hd), hn(Hd), g(3 * Hd);
    for (size_t s = 0; s + 1 < x.lod.size(); ++s) {
      int64_t b0 = x.lod[s], b1 = x.lod[s + 1];
      if (h0)
        memcpy(h.data(), &h0->f[s * Hd], Hd * sizeof(float));
      else
        std::fill(h.begin(), h.end(), 0.f);
      for (int64_t q = 0; q < b1 - b0; ++q) {
        int64_t row = reverse ? (b1 - 1 - q) : (b0 + q);
        const float* xr = &x.f[row * 3 * Hd];
        for (int64_t k = 0; k < 3 * Hd; ++k)
          g[k] = xr[k] + (bias ? bias->f[k] : 0.f);
        // g += h @ w for the update|reset halves
        for (int64_t r = 0; r < Hd; ++r) {
          float hv = h[r];
          if (hv == 0.f) continue;
          const float* wr = &w.f[r * 3 * Hd];
          for (int64_t c = 0; c < 2 * Hd; ++c) g[c] += hv * wr[c];
        }
        for (int64_t k = 0; k < 2 * Hd; ++k)
          g[k] = 1.f / (1.f + std::exp(-g[k]));
        // candidate: xc + (r*h) @ w_c
        for (int64_t r = 0; r < Hd; ++r) {
          float rh = g[Hd + r] * h[r];
          if (rh == 0.f) continue;
          const float* wr = &w.f[r * 3 * Hd];
          for (int64_t c = 0; c < Hd; ++c) g[2 * Hd + c] += rh * wr[2 * Hd + c];
        }
        for (int64_t k = 0; k < Hd; ++k) {
          float u = g[k], c = std::tanh(g[2 * Hd + k]);
          hn[k] = (1.f - u) * h[k] + u * c;
        }
        h = hn;
        memcpy(&o->f[row * Hd], h.data(), Hd * sizeof(float));
      }
    }
    return true;
  }
  if (t == "lstm") {
    // full-sequence LSTM over a packed ragged batch (reference lstm_op;
    // same math as kernels_rnn.py _lstm: gate order i,f,c,o in the 4H
    // axis; optional peephole weights ride in bias[4H:7H])
    Tensor& x = m.vars[op.in("Input")];
    if (!require_float(m, x, "lstm", "Input")) return false;
    Tensor& w = m.vars[op.in("Weight")];
    Tensor* bias = op.in("Bias").empty() ? nullptr : &m.vars[op.in("Bias")];
    Tensor* h0 = op.in("H0").empty() ? nullptr : &m.vars[op.in("H0")];
    Tensor* c0 = op.in("C0").empty() ? nullptr : &m.vars[op.in("C0")];
    Tensor* o = named(m, op.out("Hidden"));
    Tensor* oc = op.out("Cell").empty() ? nullptr : named(m, op.out("Cell"));
    if (x.lod.empty()) {
      m.error = "lstm input has no sequence offsets (lod)";
      return false;
    }
    {
      std::string ga = op.attr_str("gate_activation");
      std::string ca = op.attr_str("cell_activation");
      std::string da = op.attr_str("candidate_activation");
      if ((!ga.empty() && ga != "sigmoid") || (!ca.empty() && ca != "tanh") ||
          (!da.empty() && da != "tanh")) {
        m.error = "native lstm supports sigmoid/tanh activations only";
        return false;
      }
    }
    bool reverse = op.attr_bool("is_reverse", false);
    bool peephole = op.attr_bool("use_peepholes", true) && bias &&
                    bias->numel() >= 7 * w.shape[0];
    int64_t Hd = w.shape[0];
    int64_t total = x.shape[0];
    o->shape = {total, Hd};
    o->is_int = false;
    o->f.assign(total * Hd, 0.f);
    o->lod = x.lod;
    if (oc) {
      oc->shape = o->shape;
      oc->is_int = false;
      oc->f.assign(total * Hd, 0.f);
      oc->lod = x.lod;
    }
    std::vector<float> h(Hd), c(Hd), g(4 * Hd);
    auto sig = [](float v) { return 1.f / (1.f + std::exp(-v)); };
    for (size_t s = 0; s + 1 < x.lod.size(); ++s) {
      int64_t b0 = x.lod[s], b1 = x.lod[s + 1];
      if (h0)
        memcpy(h.data(), &h0->f[s * Hd], Hd * sizeof(float));
      else
        std::fill(h.begin(), h.end(), 0.f);
      if (c0)
        memcpy(c.data(), &c0->f[s * Hd], Hd * sizeof(float));
      else
        std::fill(c.begin(), c.end(), 0.f);
      for (int64_t q = 0; q < b1 - b0; ++q) {
        int64_t row = reverse ? (b1 - 1 - q) : (b0 + q);
        const float* xr = &x.f[row * 4 * Hd];
        for (int64_t k = 0; k < 4 * Hd; ++k)
          g[k] = xr[k] + (bias ? bias->f[k] : 0.f);
        for (int64_t r = 0; r < Hd; ++r) {
          float hv = h[r];
          if (hv == 0.f) continue;
          const float* wr = &w.f[r * 4 * Hd];
          for (int64_t k = 0; k < 4 * Hd; ++k) g[k] += hv * wr[k];
        }
        for (int64_t k = 0; k < Hd; ++k) {
          float gi = g[k], gf = g[Hd + k];
          if (peephole) {
            gi += c[k] * bias->f[4 * Hd + k];
            gf += c[k] * bias->f[5 * Hd + k];
          }
          float i = sig(gi), f2 = sig(gf);
          float cn = f2 * c[k] + i * std::tanh(g[2 * Hd + k]);
          float go = g[3 * Hd + k];
          if (peephole) go += cn * bias->f[6 * Hd + k];
          c[k] = cn;
          h[k] = sig(go) * std::tanh(cn);
        }
        memcpy(&o->f[row * Hd], h.data(), Hd * sizeof(float));
        if (oc) memcpy(&oc->f[row * Hd], c.data(), Hd * sizeof(float));
      }
    }
    return true;
  }
  if (t == "sequence_pool") {
    // per-sequence reduction (reference sequence_pool_op.cc); LAST and
    // FIRST are how sequence_last_step/sequence_first_step lower
    Tensor& x = m.vars[op.in("X")];
    if (!require_float(m, x, "sequence_pool", "X")) return false;
    Tensor* o = named(m, op.out("Out"));
    if (x.lod.empty()) {
      m.error = "sequence_pool input has no sequence offsets (lod)";
      return false;
    }
    std::string pt = op.attr_str("pooltype");
    if (pt.empty()) pt = op.attr_str("pool_type");
    if (pt.empty()) pt = "average";  // reference default
    for (auto& ch : pt) ch = std::tolower(ch);
    if (pt != "last" && pt != "first" && pt != "max" && pt != "sum" &&
        pt != "sqrt" && pt != "average" && pt != "avg" && pt != "mean") {
      m.error = "sequence_pool: unknown pooltype " + pt;
      return false;
    }
    int64_t n = (int64_t)x.lod.size() - 1;
    int64_t D = x.numel() / std::max<int64_t>(x.shape[0], 1);
    o->shape = {n, D};
    o->is_int = false;
    o->f.assign(n * D, 0.f);
    for (int64_t s = 0; s < n; ++s) {
      int64_t b0 = x.lod[s], b1 = x.lod[s + 1];
      if (b1 <= b0) continue;  // empty sequence pools to zeros
      if (pt == "last" || pt == "first") {
        int64_t row = (pt == "last") ? b1 - 1 : b0;
        memcpy(&o->f[s * D], &x.f[row * D], D * sizeof(float));
        continue;
      }
      for (int64_t d = 0; d < D; ++d) {
        float acc = (pt == "max") ? -3.4e38f : 0.f;
        for (int64_t r = b0; r < b1; ++r) {
          float v = x.f[r * D + d];
          if (pt == "max")
            acc = std::max(acc, v);
          else
            acc += v;
        }
        if (pt == "average" || pt == "avg" || pt == "mean")
          acc /= (float)(b1 - b0);
        else if (pt == "sqrt")
          acc /= std::sqrt((float)(b1 - b0));
        o->f[s * D + d] = acc;
      }
    }
    return true;
  }
  if (t == "ctc_align") {
    // CTC greedy decode (reference ctc_align_op.cc): per-step argmax,
    // collapse repeats, drop blanks. Output: packed kept tokens with
    // per-sequence lod (exact ragged — no padding needed host-side).
    Tensor& x = m.vars[op.in("Input")];
    Tensor* o = named(m, op.out("Output"));
    if (x.lod.empty()) {
      m.error = "ctc_align input has no sequence offsets (lod)";
      return false;
    }
    int64_t blank = (int64_t)op.attr_num("blank", 0);
    int64_t C = x.shape.size() > 1 ? x.shape.back() : 1;
    o->is_int = true;
    o->i.clear();
    o->lod.assign(1, 0);
    for (size_t s = 0; s + 1 < x.lod.size(); ++s) {
      int64_t prev = -1;
      for (int64_t r = x.lod[s]; r < x.lod[s + 1]; ++r) {
        int64_t tok = 0;
        if (C > 1) {
          // at() reads the int or float payload uniformly
          for (int64_t c = 1; c < C; ++c)
            if (x.at(r * C + c) > x.at(r * C + tok)) tok = c;
        } else {
          tok = x.is_int ? x.i[r] : (int64_t)x.f[r];
        }
        if (tok != blank && tok != prev) o->i.push_back(tok);
        prev = tok;
      }
      o->lod.push_back((int64_t)o->i.size());
    }
    o->shape = {(int64_t)o->i.size(), 1};
    return true;
  }
  if (t == "matmul") {
    // 2-D (optionally transposed) matmul — the attention building block
    // (reference matmul_op.cc; batched ranks collapse to 2-D here
    // because the serving decoder runs one sequence at a time)
    Tensor& x = m.vars[op.in("X")];
    Tensor& y = m.vars[op.in("Y")];
    Tensor* o = named(m, op.out("Out"));
    bool tx = op.attr_bool("transpose_X", false) ||
              op.attr_bool("transpose_x", false);
    bool ty = op.attr_bool("transpose_Y", false) ||
              op.attr_bool("transpose_y", false);
    if (x.shape.size() != 2 || y.shape.size() != 2) {
      m.error = "native matmul supports rank-2 operands";
      return false;
    }
    int64_t xr = x.shape[0], xc = x.shape[1];
    int64_t yr = y.shape[0], yc = y.shape[1];
    int64_t Mr = tx ? xc : xr, K = tx ? xr : xc;
    int64_t K2 = ty ? yc : yr, Nc = ty ? yr : yc;
    if (K != K2) {
      m.error = "matmul inner-dim mismatch";
      return false;
    }
    o->shape = {Mr, Nc};
    o->is_int = false;
    o->f.assign(Mr * Nc, 0.f);
    for (int64_t r = 0; r < Mr; ++r)
      for (int64_t k = 0; k < K; ++k) {
        float xv = tx ? x.at(k * xc + r) : x.at(r * xc + k);
        if (xv == 0.f) continue;
        for (int64_t c = 0; c < Nc; ++c) {
          float yv = ty ? y.at(c * yc + k) : y.at(k * yc + c);
          o->f[r * Nc + c] += xv * yv;
        }
      }
    return true;
  }
  if (t == "layer_norm") {
    // normalise over trailing dims from begin_norm_axis (reference
    // layer_norm_op.cc), with optional per-feature scale/bias
    Tensor& x = m.vars[op.in("X")];
    if (!require_float(m, x, "layer_norm", "X")) return false;
    Tensor* scale = op.in("Scale").empty() ? nullptr : &m.vars[op.in("Scale")];
    Tensor* bias = op.in("Bias").empty() ? nullptr : &m.vars[op.in("Bias")];
    Tensor* o = named(m, op.out("Y"));
    float eps = (float)op.attr_num("epsilon", 1e-5);
    int bna = (int)op.attr_num("begin_norm_axis", 1);
    int64_t R = 1, C = 1;
    for (size_t k = 0; k < x.shape.size(); ++k)
      ((int)k < bna ? R : C) *= x.shape[k];
    o->shape = x.shape;
    o->is_int = false;
    o->f.resize(x.numel());
    for (int64_t r = 0; r < R; ++r) {
      const float* px = &x.f[r * C];
      float* po = &o->f[r * C];
      double mu = 0;
      for (int64_t c = 0; c < C; ++c) mu += px[c];
      mu /= C;
      double var = 0;
      for (int64_t c = 0; c < C; ++c) var += (px[c] - mu) * (px[c] - mu);
      var /= C;
      float inv = 1.f / std::sqrt((float)var + eps);
      for (int64_t c = 0; c < C; ++c) {
        float v = (px[c] - (float)mu) * inv;
        if (scale) v *= scale->f[c];
        if (bias) v += bias->f[c];
        po[c] = v;
      }
    }
    return true;
  }
  if (t == "top_k") {
    Tensor& x = m.vars[op.in("X")];
    Tensor* vo = named(m, op.out("Out"));
    Tensor* io = named(m, op.out("Indices"));
    int64_t k = (int64_t)op.attr_num("k", 1);
    int64_t C = x.shape.back(), R = x.numel() / C;
    if (k > C) k = C;
    if (k < 1) k = 1;
    vo->shape = {R, k};
    vo->is_int = false;
    vo->f.resize(R * k);
    io->shape = {R, k};
    io->is_int = true;
    io->i.resize(R * k);
    std::vector<int64_t> idx(C);
    for (int64_t r = 0; r < R; ++r) {
      for (int64_t c = 0; c < C; ++c) idx[c] = c;
      std::partial_sort(idx.begin(), idx.begin() + k, idx.end(),
                        [&](int64_t a, int64_t b) {
                          return x.at(r * C + a) > x.at(r * C + b);
                        });
      for (int64_t j = 0; j < k; ++j) {
        vo->f[r * k + j] = x.at(r * C + idx[j]);
        io->i[r * k + j] = idx[j];
      }
    }
    return true;
  }
  if (t == "cast") {
    Tensor& x = m.vars[op.in("X")];
    Tensor* o = named(m, op.out("Out"));
    *o = x;  // numeric value carries; dtype tags only matter at fetch
    return true;
  }
  if (t == "fill_constant") {
    Tensor* o = named(m, op.out("Out"));
    o->shape = op.attr_ints("shape");
    o->is_int = false;
    o->f.assign(o->numel(), (float)op.attr_num("value", 0));
    return true;
  }
  m.error = "unsupported op in native inference: " + t;
  return false;
}

}  // namespace

// ---------------------------------------------------------------------
// C ABI (capi/gradient_machine.h parity)
// ---------------------------------------------------------------------
extern "C" {

void* ptpu_infer_create(const char* dirname) {
  auto m = std::make_unique<Model>();
  std::ifstream fs(std::string(dirname) + "/__model__");
  if (!fs) return nullptr;
  std::stringstream ss;
  ss << fs.rdbuf();
  const std::string text = ss.str();  // JParser keeps pointers into this
  JParser jp(text);
  JValue root = jp.parse();
  if (!jp.ok || root.kind != JValue::OBJ) return nullptr;

  const JValue* meta = root.get("meta");
  if (meta) {
    if (const JValue* f = meta->get("feed_names"))
      for (auto& e : f->arr) m->feed_names.push_back(e.str);
    if (const JValue* f = meta->get("fetch_names"))
      for (auto& e : f->arr) m->fetch_names.push_back(e.str);
  }
  const JValue* blocks = root.get("blocks");
  if (!blocks || blocks->arr.empty()) return nullptr;
  const JValue& b0 = blocks->arr[0];
  if (const JValue* vars = b0.get("vars")) {
    for (auto& v : vars->arr) {
      const JValue* nm = v.get("name");
      if (!nm) continue;
      if (const JValue* dt = v.get("dtype"))
        m->var_is_int[nm->str] = dt->str.find("int") != std::string::npos;
      if (v.get("persistable") && v.get("persistable")->as_bool()) {
        Tensor t;
        if (load_npy(std::string(dirname) + "/" + escape_name(nm->str) + ".npy",
                     &t))
          m->vars[nm->str] = std::move(t);
      }
    }
  }
  if (const JValue* ops = b0.get("ops")) {
    for (auto& o : ops->arr) {
      OpDesc od;
      od.type = o.get("type")->str;
      if (const JValue* ins = o.get("inputs"))
        for (auto& kv : ins->obj) {
          std::vector<std::string> names;
          for (auto& e : kv.second.arr) names.push_back(e.str);
          od.inputs[kv.first] = names;
        }
      if (const JValue* outs = o.get("outputs"))
        for (auto& kv : outs->obj) {
          std::vector<std::string> names;
          for (auto& e : kv.second.arr) names.push_back(e.str);
          od.outputs[kv.first] = names;
        }
      if (const JValue* at = o.get("attrs")) od.attrs = *at;
      m->ops.push_back(std::move(od));
    }
  }
  return m.release();
}

int ptpu_infer_num_feeds(void* h) {
  return (int)static_cast<Model*>(h)->feed_names.size();
}
const char* ptpu_infer_feed_name(void* h, int k) {
  return static_cast<Model*>(h)->feed_names[k].c_str();
}
int ptpu_infer_num_fetch(void* h) {
  return (int)static_cast<Model*>(h)->fetch_names.size();
}
const char* ptpu_infer_fetch_name(void* h, int k) {
  return static_cast<Model*>(h)->fetch_names[k].c_str();
}

// dtype codes: 0 = f32, 1 = i64
int ptpu_infer_set_input(void* h, const char* name, const void* data,
                         int dtype, const int64_t* shape, int ndim) {
  Model& m = *static_cast<Model*>(h);
  Tensor t;
  t.shape.assign(shape, shape + ndim);
  int64_t n = t.numel();
  if (dtype == 1) {
    t.is_int = true;
    t.i.assign(static_cast<const int64_t*>(data),
               static_cast<const int64_t*>(data) + n);
  } else {
    t.is_int = false;
    t.f.assign(static_cast<const float*>(data),
               static_cast<const float*>(data) + n);
  }
  m.vars[name] = std::move(t);
  m.fed_lod.erase(name);  // fresh tensor: any lod must be re-set
  return 0;
}

int ptpu_infer_forward(void* h) {
  Model& m = *static_cast<Model*>(h);
  m.error.clear();
  for (auto& kv : m.vars)
    if (!m.fed_lod.count(kv.first)) kv.second.lod.clear();
  // default LoD propagation (reference ShareLoD; Python _share_lod):
  // restricted to an allowlist of row-preserving op types, mirroring
  // the Python side's barrier logic — a shape-match heuristic alone
  // can hand a reshape/elementwise output a coincidental lod. Sequence
  // ops (im2sequence/gru/lstm/ctc_align/sequence_pool) set or clear
  // their own lod explicitly and are NOT listed.
  static const std::set<std::string> kLodPropagate = {
      "mul",         "matmul",        "elementwise_add", "elementwise_sub",
      "elementwise_mul", "elementwise_div", "relu",      "sigmoid",
      "tanh",        "exp",           "sqrt",            "abs",
      "square",      "softmax",       "scale",           "sum",
      "dropout",     "batch_norm",    "layer_norm",      "lookup_table",
      "cast",        "concat"};
  // reduces over FEATURE axes only stay row-wise (Python _share_lod:
  // dim excludes 0, no reduce_all, no negative dims)
  auto reduce_propagates = [](const OpDesc& op) {
    if (op.attr_bool("reduce_all", false)) return false;
    std::vector<int64_t> dims = op.attr_ints("dim");
    if (dims.empty()) dims.push_back((int64_t)op.attr_num("dim", 0));
    for (int64_t d : dims)
      if (d <= 0) return false;  // row axis (or negative: conservative)
    return true;
  };
  for (auto& op : m.ops) {
    if (!run_op(m, op)) return -1;
    bool is_reduce = op.type == "reduce_sum" || op.type == "reduce_mean" ||
                     op.type == "reduce_max";
    if (is_reduce ? !reduce_propagates(op) : !kLodPropagate.count(op.type))
      continue;
    // pick the ragged source positionally: prefer the canonical data
    // slot ("X" / "Input") over std::map iteration order so e.g.
    // elementwise(X=ragged, Y=broadcast) never inherits from Y.
    const Tensor* src = nullptr;
    for (const char* slot : {"X", "Input", "Ids"}) {
      auto sit = op.inputs.find(slot);
      if (sit == op.inputs.end() || sit->second.empty()) continue;
      auto it = m.vars.find(sit->second[0]);
      if (it != m.vars.end() && !it->second.lod.empty()) {
        src = &it->second;
        break;
      }
    }
    if (!src)
      for (auto& kv : op.inputs) {
        for (auto& nm : kv.second) {
          auto it = m.vars.find(nm);
          if (it != m.vars.end() && !it->second.lod.empty()) {
            src = &it->second;
            break;
          }
        }
        if (src) break;
      }
    if (src)
      for (auto& kv : op.outputs)
        for (auto& nm : kv.second) {
          auto it = m.vars.find(nm);
          if (it != m.vars.end() && it->second.lod.empty() &&
              !it->second.shape.empty() &&
              it->second.shape[0] == src->shape[0])
            it->second.lod = src->lod;
        }
  }
  return 0;
}

const char* ptpu_infer_error(void* h) {
  return static_cast<Model*>(h)->error.c_str();
}

int ptpu_infer_out_rank(void* h, int k) {
  Model& m = *static_cast<Model*>(h);
  return (int)m.vars[m.fetch_names[k]].shape.size();
}
const int64_t* ptpu_infer_out_shape(void* h, int k) {
  Model& m = *static_cast<Model*>(h);
  return m.vars[m.fetch_names[k]].shape.data();
}
// always materialised as f32 for the caller (indices cast)
const float* ptpu_infer_out_data(void* h, int k) {
  Model& m = *static_cast<Model*>(h);
  Tensor& t = m.vars[m.fetch_names[k]];
  if (t.is_int) {
    t.f.assign(t.i.begin(), t.i.end());
    t.is_int = false;
  }
  return t.f.data();
}

void ptpu_infer_destroy(void* h) { delete static_cast<Model*>(h); }

// ragged outputs (CTC decode, RNN sequences): per-sequence start
// offsets of fetch k — length 0 means the output is dense
int ptpu_infer_out_lod_len(void* h, int k) {
  Model& m = *static_cast<Model*>(h);
  return (int)m.vars[m.fetch_names[k]].lod.size();
}
const int64_t* ptpu_infer_out_lod(void* h, int k) {
  Model& m = *static_cast<Model*>(h);
  return m.vars[m.fetch_names[k]].lod.data();
}

// feed a ragged input: offsets for a previously-set input tensor
int ptpu_infer_set_input_lod(void* h, const char* name, const int64_t* lod,
                             int len) {
  Model& m = *static_cast<Model*>(h);
  auto it = m.vars.find(name);
  if (it == m.vars.end()) return -1;
  it->second.lod.assign(lod, lod + len);
  m.fed_lod[name] = true;
  return 0;
}

}  // extern "C"
