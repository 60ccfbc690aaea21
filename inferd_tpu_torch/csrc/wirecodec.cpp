// Native tensor-wire codec for the PyTorch port (port of native/wirecodec.cpp).
//
// The data plane moves activation envelopes between nodes every pipeline
// hop and ~600 KB of logits back on the last; serialization sits on that
// hot path. This extension implements inferd wire format v1 (specified in
// inferd_tpu_torch/runtime/wire.py, whose pure-Python codec it must match
// byte for byte) as a single-pass assembler: one output buffer, tensors
// memcpy'd straight out of the source buffer protocol, no per-field
// intermediate byte strings. Nothing on the wire is ever executed.
//
// Tensor handling stays framework-agnostic: the Python side registers two
// hooks, tensor_parts(obj) -> (dtype_name, shape_tuple, buffer) and
// tensor_build(dtype_name, shape_tuple, bytes) -> tensor, so torch's
// bfloat16 (which numpy lacks) needs no C-level knowledge here.
//
// Built at first use by inferd_tpu_torch/native/__init__.py with the host
// C++ compiler and the Python headers.

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cstdint>
#include <cstring>
#include <string>

// The wire format is little-endian by spec (inferd_tpu_torch/runtime/wire.py);
// scalars below are memcpy'd in host order, so refuse to build where that
// would miscode frames.
static_assert(__BYTE_ORDER__ == __ORDER_LITTLE_ENDIAN__,
              "wirecodec requires a little-endian target (wire format is LE)");

namespace {

constexpr uint8_t kMagic0 = 'I';
constexpr uint8_t kMagic1 = 'W';
constexpr uint8_t kVersion = 1;

enum Tag : uint8_t {
  TAG_NONE = 0,
  TAG_TRUE = 1,
  TAG_FALSE = 2,
  TAG_INT = 3,
  TAG_FLOAT = 4,
  TAG_STR = 5,
  TAG_BYTES = 6,
  TAG_LIST = 7,
  TAG_DICT = 8,
  TAG_TENSOR = 9,
};

PyObject* g_tensor_parts = nullptr;  // obj -> (dtype_name, shape, buffer)
PyObject* g_tensor_build = nullptr;  // (dtype_name, shape, bytes) -> array

// Builds the frame directly inside a PyBytes object (realloc growth, no
// zero-initialization, no final copy when the guess was right) — a
// std::vector would zero new bytes on every resize and still need one
// whole-frame copy into the result object.
struct Writer {
  PyObject* bytes = nullptr;
  size_t len = 0;
  size_t cap = 0;

  bool init(size_t initial) {
    cap = initial;
    bytes = PyBytes_FromStringAndSize(nullptr, Py_ssize_t(cap));
    return bytes != nullptr;
  }
  bool ensure(size_t n) {
    if (len + n <= cap) return true;
    size_t want = cap * 2;
    if (want < len + n) want = len + n;
    if (_PyBytes_Resize(&bytes, Py_ssize_t(want)) != 0) return false;
    cap = want;
    return true;
  }
  bool raw(const void* p, size_t n) {
    if (!ensure(n)) return false;
    std::memcpy(PyBytes_AS_STRING(bytes) + len, p, n);
    len += n;
    return true;
  }
  bool u8(uint8_t v) { return raw(&v, 1); }
  bool u64(uint64_t v) { return raw(&v, 8); }  // little-endian hosts (x86/arm)
  bool i64(int64_t v) { return raw(&v, 8); }
  bool f64(double v) { return raw(&v, 8); }
  PyObject* finish() {
    if (len != cap && _PyBytes_Resize(&bytes, Py_ssize_t(len)) != 0) {
      return nullptr;
    }
    PyObject* out = bytes;
    bytes = nullptr;
    return out;
  }
  ~Writer() { Py_XDECREF(bytes); }
};

struct Reader {
  const char* p;
  const char* end;

  bool need(size_t n) const { return size_t(end - p) >= n; }
  uint8_t u8() { return uint8_t(*p++); }
  uint64_t u64() {
    uint64_t v;
    std::memcpy(&v, p, 8);
    p += 8;
    return v;
  }
  int64_t i64() {
    int64_t v;
    std::memcpy(&v, p, 8);
    p += 8;
    return v;
  }
  double f64() {
    double v;
    std::memcpy(&v, p, 8);
    p += 8;
    return v;
  }
};

bool pack_value(Writer& w, PyObject* obj, int depth);

bool pack_str_body(Writer& w, PyObject* s) {
  Py_ssize_t n;
  const char* utf8 = PyUnicode_AsUTF8AndSize(s, &n);
  if (utf8 == nullptr) return false;
  return w.u64(uint64_t(n)) && w.raw(utf8, size_t(n));
}

bool pack_tensor(Writer& w, PyObject* obj) {
  if (g_tensor_parts == nullptr) {
    PyErr_SetString(PyExc_TypeError, "tensor hooks not registered");
    return false;
  }
  PyObject* parts = PyObject_CallFunctionObjArgs(g_tensor_parts, obj, nullptr);
  if (parts == nullptr) return false;
  if (!PyTuple_Check(parts) || PyTuple_GET_SIZE(parts) != 3) {
    Py_DECREF(parts);
    PyErr_SetString(PyExc_TypeError, "tensor_parts must return a 3-tuple");
    return false;
  }
  PyObject* name = PyTuple_GET_ITEM(parts, 0);
  PyObject* shape = PyTuple_GET_ITEM(parts, 1);
  PyObject* bufobj = PyTuple_GET_ITEM(parts, 2);
  if (!PyUnicode_Check(name) || !PyTuple_Check(shape)) {
    Py_DECREF(parts);
    PyErr_SetString(PyExc_TypeError, "tensor_parts: (str, tuple, buffer)");
    return false;
  }
  Py_buffer view;
  if (PyObject_GetBuffer(bufobj, &view, PyBUF_C_CONTIGUOUS) != 0) {
    Py_DECREF(parts);
    return false;
  }
  bool ok = w.u8(TAG_TENSOR) && pack_str_body(w, name);
  if (ok) {
    Py_ssize_t ndim = PyTuple_GET_SIZE(shape);
    if (ndim > 255) {
      PyErr_SetString(PyExc_ValueError, "tensor rank > 255");
      ok = false;
    } else {
      ok = w.u8(uint8_t(ndim));
      for (Py_ssize_t i = 0; ok && i < ndim; i++) {
        PyObject* d = PyTuple_GET_ITEM(shape, i);
        long long dim = PyLong_AsLongLong(d);
        if (dim == -1 && PyErr_Occurred()) ok = false;
        else if (dim < 0) {
          PyErr_SetString(PyExc_ValueError, "negative dim");
          ok = false;
        } else {
          ok = w.u64(uint64_t(dim));
        }
      }
      if (ok) {
        ok = w.u64(uint64_t(view.len)) &&
             w.raw(view.buf, size_t(view.len));  // the single tensor copy
      }
    }
  }
  PyBuffer_Release(&view);
  Py_DECREF(parts);
  return ok;
}

bool pack_value(Writer& w, PyObject* obj, int depth) {
  if (depth > 64) {
    PyErr_SetString(PyExc_ValueError, "nesting too deep");
    return false;
  }
  if (obj == Py_None) return w.u8(TAG_NONE);
  if (obj == Py_True) return w.u8(TAG_TRUE);
  if (obj == Py_False) return w.u8(TAG_FALSE);
  if (PyLong_CheckExact(obj)) {
    int overflow = 0;
    long long v = PyLong_AsLongLongAndOverflow(obj, &overflow);
    if (overflow != 0) {
      PyErr_SetString(PyExc_OverflowError, "int exceeds int64 wire range");
      return false;
    }
    if (v == -1 && PyErr_Occurred()) return false;
    return w.u8(TAG_INT) && w.i64(v);
  }
  if (PyFloat_CheckExact(obj)) {
    return w.u8(TAG_FLOAT) && w.f64(PyFloat_AS_DOUBLE(obj));
  }
  if (PyUnicode_Check(obj)) {
    return w.u8(TAG_STR) && pack_str_body(w, obj);
  }
  if (PyBytes_Check(obj)) {
    return w.u8(TAG_BYTES) && w.u64(uint64_t(PyBytes_GET_SIZE(obj))) &&
           w.raw(PyBytes_AS_STRING(obj), size_t(PyBytes_GET_SIZE(obj)));
  }
  if (PyList_Check(obj) || PyTuple_Check(obj)) {
    PyObject* fast = PySequence_Fast(obj, "sequence");
    if (fast == nullptr) return false;
    Py_ssize_t n = PySequence_Fast_GET_SIZE(fast);
    bool ok = w.u8(TAG_LIST) && w.u64(uint64_t(n));
    for (Py_ssize_t i = 0; ok && i < n; i++) {
      ok = pack_value(w, PySequence_Fast_GET_ITEM(fast, i), depth + 1);
    }
    Py_DECREF(fast);
    return ok;
  }
  if (PyDict_Check(obj)) {
    if (!(w.u8(TAG_DICT) && w.u64(uint64_t(PyDict_Size(obj))))) return false;
    PyObject *key, *value;
    Py_ssize_t pos = 0;
    while (PyDict_Next(obj, &pos, &key, &value)) {
      if (!PyUnicode_Check(key)) {
        PyErr_SetString(PyExc_TypeError, "wire dict keys must be str");
        return false;
      }
      if (!pack_str_body(w, key)) return false;
      if (!pack_value(w, value, depth + 1)) return false;
    }
    return true;
  }
  // anything else: delegate to the tensor hook (torch tensors, numpy arrays
  // and scalars; the hook raises for genuinely unserializable objects)
  return pack_tensor(w, obj);
}

PyObject* unpack_value(Reader& r, PyObject* src, int depth);

PyObject* unpack_str(Reader& r) {
  if (!r.need(8)) {
    PyErr_SetString(PyExc_ValueError, "truncated wire data (str len)");
    return nullptr;
  }
  uint64_t n = r.u64();
  if (!r.need(n)) {
    PyErr_SetString(PyExc_ValueError, "truncated wire data (str)");
    return nullptr;
  }
  PyObject* s = PyUnicode_DecodeUTF8(r.p, Py_ssize_t(n), nullptr);
  r.p += n;
  return s;
}

PyObject* unpack_value(Reader& r, PyObject* src, int depth) {
  if (depth > 64) {
    PyErr_SetString(PyExc_ValueError, "nesting too deep");
    return nullptr;
  }
  if (!r.need(1)) {
    PyErr_SetString(PyExc_ValueError, "truncated wire data (tag)");
    return nullptr;
  }
  uint8_t tag = r.u8();
  switch (tag) {
    case TAG_NONE:
      Py_RETURN_NONE;
    case TAG_TRUE:
      Py_RETURN_TRUE;
    case TAG_FALSE:
      Py_RETURN_FALSE;
    case TAG_INT:
      if (!r.need(8)) break;
      return PyLong_FromLongLong(r.i64());
    case TAG_FLOAT:
      if (!r.need(8)) break;
      return PyFloat_FromDouble(r.f64());
    case TAG_STR:
      return unpack_str(r);
    case TAG_BYTES: {
      if (!r.need(8)) break;
      uint64_t n = r.u64();
      if (!r.need(n)) break;
      PyObject* b = PyBytes_FromStringAndSize(r.p, Py_ssize_t(n));
      r.p += n;
      return b;
    }
    case TAG_LIST: {
      if (!r.need(8)) break;
      uint64_t n = r.u64();
      // sanity: each element needs >= 1 byte
      if (n > size_t(r.end - r.p)) break;
      PyObject* list = PyList_New(Py_ssize_t(n));
      if (list == nullptr) return nullptr;
      for (uint64_t i = 0; i < n; i++) {
        PyObject* v = unpack_value(r, src, depth + 1);
        if (v == nullptr) {
          Py_DECREF(list);
          return nullptr;
        }
        PyList_SET_ITEM(list, Py_ssize_t(i), v);
      }
      return list;
    }
    case TAG_DICT: {
      if (!r.need(8)) break;
      uint64_t n = r.u64();
      if (n > size_t(r.end - r.p)) break;
      PyObject* dict = PyDict_New();
      if (dict == nullptr) return nullptr;
      for (uint64_t i = 0; i < n; i++) {
        PyObject* k = unpack_str(r);
        if (k == nullptr) {
          Py_DECREF(dict);
          return nullptr;
        }
        PyObject* v = unpack_value(r, src, depth + 1);
        if (v == nullptr) {
          Py_DECREF(k);
          Py_DECREF(dict);
          return nullptr;
        }
        int rc = PyDict_SetItem(dict, k, v);
        Py_DECREF(k);
        Py_DECREF(v);
        if (rc != 0) {
          Py_DECREF(dict);
          return nullptr;
        }
      }
      return dict;
    }
    case TAG_TENSOR: {
      if (g_tensor_build == nullptr) {
        PyErr_SetString(PyExc_TypeError, "tensor hooks not registered");
        return nullptr;
      }
      PyObject* name = unpack_str(r);
      if (name == nullptr) return nullptr;
      if (!r.need(1)) {
        Py_DECREF(name);
        break;
      }
      uint8_t ndim = r.u8();
      if (!r.need(size_t(ndim) * 8)) {
        Py_DECREF(name);
        break;
      }
      PyObject* shape = PyTuple_New(ndim);
      if (shape == nullptr) {
        Py_DECREF(name);
        return nullptr;
      }
      for (uint8_t i = 0; i < ndim; i++) {
        PyObject* dim = PyLong_FromUnsignedLongLong(r.u64());
        if (dim == nullptr) {
          Py_DECREF(name);
          Py_DECREF(shape);
          return nullptr;
        }
        PyTuple_SET_ITEM(shape, i, dim);
      }
      if (!r.need(8)) {
        Py_DECREF(name);
        Py_DECREF(shape);
        break;
      }
      uint64_t nbytes = r.u64();
      if (!r.need(nbytes)) {
        Py_DECREF(name);
        Py_DECREF(shape);
        break;
      }
      // zero-copy view into the source bytes; the builder (np.frombuffer, or
      // a copy for bf16) keeps a reference to it, and it keeps `src` alive
      PyObject* mv =
          PyMemoryView_FromObject(src);  // whole-buffer view, then slice
      PyObject* data = nullptr;
      if (mv != nullptr) {
        Py_ssize_t start = r.p - (const char*)PyBytes_AS_STRING(src);
        PyObject* lo = PyLong_FromSsize_t(start);
        PyObject* hi = PyLong_FromSsize_t(start + Py_ssize_t(nbytes));
        if (lo != nullptr && hi != nullptr) {
          PyObject* slice = PySlice_New(lo, hi, nullptr);
          if (slice != nullptr) {
            data = PyObject_GetItem(mv, slice);
            Py_DECREF(slice);
          }
        }
        Py_XDECREF(lo);
        Py_XDECREF(hi);
        Py_DECREF(mv);
      }
      if (data == nullptr) {
        Py_DECREF(name);
        Py_DECREF(shape);
        return nullptr;
      }
      r.p += nbytes;
      PyObject* arr = PyObject_CallFunctionObjArgs(g_tensor_build, name, shape,
                                                   data, nullptr);
      Py_DECREF(name);
      Py_DECREF(shape);
      Py_DECREF(data);
      return arr;
    }
    default:
      PyErr_Format(PyExc_ValueError, "unknown wire tag %d", int(tag));
      return nullptr;
  }
  PyErr_SetString(PyExc_ValueError, "truncated wire data");
  return nullptr;
}

PyObject* py_pack(PyObject*, PyObject* obj) {
  Writer w;
  if (!w.init(4096)) return nullptr;
  if (!(w.u8(kMagic0) && w.u8(kMagic1) && w.u8(kVersion))) return nullptr;
  if (!pack_value(w, obj, 0)) return nullptr;
  return w.finish();
}

PyObject* py_unpack(PyObject*, PyObject* obj) {
  if (!PyBytes_Check(obj)) {
    PyErr_SetString(PyExc_TypeError, "unpack expects bytes");
    return nullptr;
  }
  Reader r{PyBytes_AS_STRING(obj),
           PyBytes_AS_STRING(obj) + PyBytes_GET_SIZE(obj)};
  if (!r.need(3) || r.u8() != kMagic0 || r.u8() != kMagic1 ||
      r.u8() != kVersion) {
    PyErr_SetString(PyExc_ValueError, "bad wire magic/version");
    return nullptr;
  }
  PyObject* out = unpack_value(r, obj, 0);
  if (out != nullptr && r.p != r.end) {
    Py_DECREF(out);
    PyErr_SetString(PyExc_ValueError, "trailing wire bytes");
    return nullptr;
  }
  return out;
}

PyObject* py_set_hooks(PyObject*, PyObject* args) {
  PyObject *parts, *build;
  if (!PyArg_ParseTuple(args, "OO", &parts, &build)) return nullptr;
  Py_XINCREF(parts);
  Py_XINCREF(build);
  Py_XDECREF(g_tensor_parts);
  Py_XDECREF(g_tensor_build);
  g_tensor_parts = parts;
  g_tensor_build = build;
  Py_RETURN_NONE;
}

PyMethodDef kMethods[] = {
    {"pack", py_pack, METH_O, "pack(obj) -> bytes (inferd wire v1)"},
    {"unpack", py_unpack, METH_O, "unpack(bytes) -> obj"},
    {"set_hooks", py_set_hooks, METH_VARARGS,
     "set_hooks(tensor_parts, tensor_build)"},
    {nullptr, nullptr, 0, nullptr},
};

PyModuleDef kModule = {
    PyModuleDef_HEAD_INIT, "wirecodec",
    "Native single-pass codec for the inferd tensor wire format.", -1,
    kMethods, nullptr, nullptr, nullptr, nullptr,
};

}  // namespace

PyMODINIT_FUNC PyInit_wirecodec(void) { return PyModule_Create(&kModule); }
