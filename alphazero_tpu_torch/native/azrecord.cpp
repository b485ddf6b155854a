// GameRecord JSON encoding in C++ (counterpart of
// alphazero_tpu/native/azrecord.cpp).
//
// Writes exactly the bytes of json.dumps(record.to_json()).encode(): the
// same keys in the same order with ", " and ": " separators, every float as
// Python's repr writes it (the shortest digits that round-trip, from
// std::to_chars, or CPython's own PyOS_double_to_string where the standard
// library has no floating-point to_chars; NaN and +-Infinity as json writes
// them),
// and the timestamp escaped as json's ensure_ascii escapes a str.  The
// floats are read as float64, which is what MoveData holds, so every
// record encodes exactly and round-trips.
//
//   _azrecord.encode_game(game_type, board_size, use_variant_rules,
//                         actions, policies, offsets, values, think_ms,
//                         result, timestamp) -> bytes
//   actions : int64 buffer [T]
//   policies: float64 buffer, every move's policy back to back
//   offsets : int64 buffer [T + 1], move t's policy is
//             policies[offsets[t]:offsets[t + 1]]
//   values  : float64 buffer [T]
//   think_ms: int64 buffer [T]
//   timestamp: str
//
// Built with g++ at first use by alphazero_tpu_torch/native/__init__.py.
#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <charconv>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <string>

namespace {

// Python's repr of a finite double: the shortest digits that round-trip,
// in fixed notation for decimal exponents -4 <= e < 16 (".0" kept on whole
// numbers), else as d[.ddd]e+XX with at least two exponent digits.
void append_float(std::string& out, double v) {
  if (std::isnan(v)) {
    out += "NaN";
    return;
  }
  if (std::isinf(v)) {
    out += v > 0 ? "Infinity" : "-Infinity";
    return;
  }
#if defined(__cpp_lib_to_chars)
  // std::to_chars gives the shortest round-trip digits (as CPython's dtoa
  // does) in the form [-]d[.ddd]e[+-]XX; rearrange them as repr does.
  char buf[40];
  const auto r = std::to_chars(buf, buf + sizeof(buf), v,
                               std::chars_format::scientific);
  const char* p = buf;
  if (*p == '-') {
    out += '-';
    ++p;
  }
  char digits[24];
  int n = 0;
  for (; *p != 'e'; ++p) {
    if (*p != '.') digits[n++] = *p;
  }
  int exp = 0;
  std::from_chars(p + (p[1] == '+' ? 2 : 1), r.ptr, exp);
  if (-4 <= exp && exp < 16) {
    if (exp < 0) {
      out += "0.";
      out.append(-exp - 1, '0');
      out.append(digits, n);
    } else if (exp + 1 >= n) {
      out.append(digits, n);
      out.append(exp + 1 - n, '0');
      out += ".0";
    } else {
      out.append(digits, exp + 1);
      out += '.';
      out.append(digits + exp + 1, n - exp - 1);
    }
    return;
  }
  out += digits[0];
  if (n > 1) {
    out += '.';
    out.append(digits + 1, n - 1);
  }
  char e[8];
  const int k = snprintf(e, sizeof(e), "e%c%02d", exp < 0 ? '-' : '+',
                         exp < 0 ? -exp : exp);
  out.append(e, k);
#else
  char* s = PyOS_double_to_string(v, 'r', 0, Py_DTSF_ADD_DOT_0, nullptr);
  out += s;
  PyMem_Free(s);
#endif
}

void append_int(std::string& out, long long v) {
  char buf[24];
  int n = snprintf(buf, sizeof(buf), "%lld", v);
  out.append(buf, n);
}

void append_hex4(std::string& out, unsigned c) {
  static const char kHex[] = "0123456789abcdef";
  out += "\\u";
  for (int shift = 12; shift >= 0; shift -= 4) out += kHex[(c >> shift) & 0xf];
}

// json's ensure_ascii form of a str, quotes included.
void append_json_str(std::string& out, PyObject* str) {
  out += '"';
  const int kind = PyUnicode_KIND(str);
  const void* data = PyUnicode_DATA(str);
  const Py_ssize_t n = PyUnicode_GET_LENGTH(str);
  for (Py_ssize_t i = 0; i < n; ++i) {
    const Py_UCS4 c = PyUnicode_READ(kind, data, i);
    switch (c) {
      case '"': out += "\\\""; continue;
      case '\\': out += "\\\\"; continue;
      case '\b': out += "\\b"; continue;
      case '\f': out += "\\f"; continue;
      case '\n': out += "\\n"; continue;
      case '\r': out += "\\r"; continue;
      case '\t': out += "\\t"; continue;
      default: break;
    }
    if (c >= ' ' && c <= '~') {
      out += static_cast<char>(c);
    } else if (c >= 0x10000) {
      const Py_UCS4 v = c - 0x10000;
      append_hex4(out, 0xd800 | ((v >> 10) & 0x3ff));
      append_hex4(out, 0xdc00 | (v & 0x3ff));
    } else {
      append_hex4(out, c);
    }
  }
  out += '"';
}

PyObject* encode_game(PyObject*, PyObject* args) {
  int game_type, board_size, use_variant, result;
  Py_buffer actions, policies, offsets, values, think;
  PyObject* timestamp;
  if (!PyArg_ParseTuple(args, "iipy*y*y*y*y*iU", &game_type, &board_size,
                        &use_variant, &actions, &policies, &offsets, &values,
                        &think, &result, &timestamp)) {
    return nullptr;
  }
  Py_buffer* bufs[] = {&actions, &policies, &offsets, &values, &think};
  auto release = [&] {
    for (Py_buffer* b : bufs) PyBuffer_Release(b);
  };

  const auto* act = static_cast<const int64_t*>(actions.buf);
  const auto* pol = static_cast<const double*>(policies.buf);
  const auto* off = static_cast<const int64_t*>(offsets.buf);
  const auto* val = static_cast<const double*>(values.buf);
  const auto* tms = static_cast<const int64_t*>(think.buf);
  const Py_ssize_t T = actions.len / static_cast<Py_ssize_t>(sizeof(int64_t));
  const Py_ssize_t P = policies.len / static_cast<Py_ssize_t>(sizeof(double));

  bool ok = offsets.len == (T + 1) * static_cast<Py_ssize_t>(sizeof(int64_t)) &&
            values.len == T * static_cast<Py_ssize_t>(sizeof(double)) &&
            think.len == T * static_cast<Py_ssize_t>(sizeof(int64_t)) &&
            off[0] == 0 && off[T] == P;
  for (Py_ssize_t t = 0; ok && t < T; ++t) ok = off[t] <= off[t + 1];
  if (!ok) {
    release();
    PyErr_SetString(PyExc_ValueError,
                    "inconsistent actions/policies/offsets/values/think_ms");
    return nullptr;
  }

  std::string out;
  out.reserve(128 + static_cast<size_t>(P) * 12 + static_cast<size_t>(T) * 80);
  out += "{\"game_type\": ";
  append_int(out, game_type);
  out += ", \"board_size\": ";
  append_int(out, board_size);
  out += ", \"use_variant_rules\": ";
  out += use_variant ? "true" : "false";
  out += ", \"moves\": [";
  for (Py_ssize_t t = 0; t < T; ++t) {
    if (t) out += ", ";
    out += "{\"action\": ";
    append_int(out, act[t]);
    out += ", \"policy\": [";
    for (int64_t a = off[t]; a < off[t + 1]; ++a) {
      if (a > off[t]) out += ", ";
      append_float(out, pol[a]);
    }
    out += "], \"value\": ";
    append_float(out, val[t]);
    out += ", \"thinking_time_ms\": ";
    append_int(out, tms[t]);
    out += "}";
  }
  out += "], \"result\": ";
  append_int(out, result);
  out += ", \"timestamp\": ";
  append_json_str(out, timestamp);
  out += "}";
  release();
  return PyBytes_FromStringAndSize(out.data(),
                                   static_cast<Py_ssize_t>(out.size()));
}

PyMethodDef kMethods[] = {
    {"encode_game", encode_game, METH_VARARGS,
     "Encode one game record to the bytes of json.dumps(record.to_json())."},
    {nullptr, nullptr, 0, nullptr},
};

PyModuleDef kModule = {
    PyModuleDef_HEAD_INIT, "_azrecord", "GameRecord JSON encoding", -1,
    kMethods, nullptr, nullptr, nullptr, nullptr,
};

}  // namespace

PyMODINIT_FUNC PyInit__azrecord(void) { return PyModule_Create(&kModule); }
