/*!
 * cxxnet_wrapper.cc — the C ABI of cxxnet_tpu_torch over an embedded
 * CPython: the twin of wrapper/cxxnet_wrapper.cc, driving
 * cxxnet_tpu_torch.api (PyTorch; nothing of JAX is imported or set up).
 *
 * Handle model: every void* is a `Handle` owning a PyObject (api.DataIter or
 * api.Net) plus the buffers of the last returned array/string, so borrowed
 * pointers stay valid until the next call on the same handle (the
 * reference's temp-buffer convention, wrapper/cxxnet_wrapper.cpp:10-76).
 *
 * Threading: every entry point takes the GIL (PyGILState_Ensure); the
 * interpreter is initialized lazily on the first call. Loaded into a
 * running Python (ctypes.CDLL, which releases the GIL around the call),
 * the library finds the interpreter initialized and only takes the GIL.
 *
 * Devices: CXNNetCreate hands its device string to api.Net unchanged, after
 * checking that the machine has it: "cpu" runs on the host, "gpu" on the
 * card, and "gpu" on a machine without a card returns NULL with the error
 * in CXNGetLastError; nothing falls back to the host.
 *
 * Built at first use by cxxnet_tpu_torch.utils.native.wrapper_library()
 * (g++, python3-config --includes / --ldflags --embed). CXN_PYTHON, set by
 * that build to the building interpreter, is the embedded interpreter's
 * program name, so a C program that embeds it finds the same installed
 * packages; CXN_ROOT is the checkout's root, put on sys.path unless
 * CXXNET_TPU_ROOT names another.
 */
#include "cxxnet_wrapper.h"

#include <Python.h>

#include <cstdio>
#include <cstring>
#include <mutex>
#include <string>
#include <vector>

namespace {

std::string g_last_error;

void SetError(const std::string &msg) {
  g_last_error = msg;
  std::fprintf(stderr, "cxxnet_wrapper: %s\n", msg.c_str());
}

/* capture the active Python exception into g_last_error */
void CapturePyError(const char *where) {
  PyObject *type = nullptr, *value = nullptr, *trace = nullptr;
  PyErr_Fetch(&type, &value, &trace);
  std::string msg = where;
  if (value) {
    PyObject *s = PyObject_Str(value);
    if (s) {
      msg += ": ";
      msg += PyUnicode_AsUTF8(s);
      Py_DECREF(s);
    }
  }
  Py_XDECREF(type);
  Py_XDECREF(value);
  Py_XDECREF(trace);
  SetError(msg);
}

#ifndef CXN_ROOT
#define CXN_ROOT ""
#endif

PyObject *g_api = nullptr;     /* module cxxnet_tpu_torch.api */
PyObject *g_device = nullptr;  /* module cxxnet_tpu_torch.device */

/* start the interpreter of this process; the program name, when the build
   gave one, makes the embedded interpreter the one the library was built
   by (its prefix, its site-packages) */
void InitInterpreter() {
#ifdef CXN_PYTHON
  PyConfig config;
  PyConfig_InitPythonConfig(&config);
  config.install_signal_handlers = 0;
  PyStatus st = PyConfig_SetBytesString(&config, &config.program_name,
                                        CXN_PYTHON);
  if (!PyStatus_Exception(st)) st = Py_InitializeFromConfig(&config);
  PyConfig_Clear(&config);
  if (!PyStatus_Exception(st)) return;
#endif
  Py_InitializeEx(0);
}

bool EnsurePython() {
  static std::once_flag once;
  static bool ok = false;
  std::call_once(once, [] {
    bool first_init = false;
    if (!Py_IsInitialized()) {
      InitInterpreter();
      first_init = true;
    }
    PyGILState_STATE gil = PyGILState_Ensure();
    std::string bootstrap =
        "import os, sys\n"
        "_root = os.environ.get('CXXNET_TPU_ROOT') or " "'" CXN_ROOT "'"
        " or os.getcwd()\n"
        "if _root not in sys.path:\n"
        "    sys.path.insert(0, _root)\n";
    if (PyRun_SimpleString(bootstrap.c_str()) != 0) {
      SetError("bootstrap failed");
    } else {
      g_api = PyImport_ImportModule("cxxnet_tpu_torch.api");
      g_device = g_api ? PyImport_ImportModule("cxxnet_tpu_torch.device")
                       : nullptr;
      if (!g_api || !g_device) {
        CapturePyError("import cxxnet_tpu_torch.api");
      } else {
        ok = true;
      }
    }
    PyGILState_Release(gil);
    /* Py_InitializeEx leaves the GIL held by the initializing thread. If we
       did the init, hand it back so (a) GilGuard entry points work from any
       embedder thread and (b) Python worker threads (imgbinx decode pool)
       run while the host app is outside wrapper calls. An embedder that
       initialized Python itself manages its own GIL — don't touch it. */
    if (first_init) (void)PyEval_SaveThread();
  });
  return ok;
}

struct Handle {
  PyObject *obj = nullptr;      /* the api.DataIter / api.Net */
  PyObject *last_array = nullptr;
  Py_buffer last_buf{};
  bool has_buf = false;
  std::string last_str;

  void DropBuf() {
    if (has_buf) {
      PyBuffer_Release(&last_buf);
      has_buf = false;
    }
    Py_CLEAR(last_array);
  }
  ~Handle() {
    PyGILState_STATE gil = PyGILState_Ensure();
    DropBuf();
    Py_CLEAR(obj);
    PyGILState_Release(gil);
  }
};

struct GilGuard {
  PyGILState_STATE state;
  GilGuard() : state(PyGILState_Ensure()) {}
  ~GilGuard() { PyGILState_Release(state); }
};

/* call obj.method(*args); returns new ref or NULL with error captured */
PyObject *Call(PyObject *obj, const char *method, PyObject *args) {
  PyObject *fn = PyObject_GetAttrString(obj, method);
  if (!fn) {
    CapturePyError(method);
    Py_XDECREF(args);
    return nullptr;
  }
  PyObject *ret = PyObject_CallObject(fn, args);
  Py_DECREF(fn);
  Py_XDECREF(args);
  if (!ret) CapturePyError(method);
  return ret;
}

/* wrap a C float buffer as a numpy array (copy) with the given shape */
PyObject *MakeArray(const cxn_real_t *data, const cxn_uint *shape, int ndim) {
  Py_ssize_t total = 1;
  for (int i = 0; i < ndim; ++i) total *= shape[i];
  PyObject *np = PyImport_ImportModule("numpy");
  if (!np) {
    CapturePyError("import numpy");
    return nullptr;
  }
  PyObject *mem = PyMemoryView_FromMemory(
      reinterpret_cast<char *>(const_cast<cxn_real_t *>(data)),
      total * Py_ssize_t(sizeof(cxn_real_t)), PyBUF_READ);
  PyObject *frombuffer = PyObject_GetAttrString(np, "frombuffer");
  PyObject *arr = nullptr;
  if (mem && frombuffer) {
    PyObject *args = Py_BuildValue("(O)", mem);
    PyObject *kw = Py_BuildValue("{s:s}", "dtype", "float32");
    PyObject *flat = PyObject_Call(frombuffer, args, kw);
    Py_DECREF(args);
    Py_DECREF(kw);
    if (flat) {
      PyObject *shp = PyTuple_New(ndim);
      for (int i = 0; i < ndim; ++i)
        PyTuple_SET_ITEM(shp, i, PyLong_FromLong(long(shape[i])));
      PyObject *view = Call(flat, "reshape", Py_BuildValue("(O)", shp));
      Py_DECREF(shp);
      Py_DECREF(flat);
      if (view) {
        /* the trainer dispatches asynchronously (device_put may read the
           host buffer after this call returns), so the array must own its
           data — the ABI lets the caller free the buffer immediately */
        arr = Call(view, "copy", PyTuple_New(0));
        Py_DECREF(view);
      }
    } else {
      CapturePyError("numpy.frombuffer");
    }
  }
  Py_XDECREF(frombuffer);
  Py_XDECREF(mem);
  Py_DECREF(np);
  return arr;
}

/* expose a numpy array's float data on the handle; fills shape_out[0..ndim)
 * padded with the flattened trailing dims when the array has more dims */
const cxn_real_t *ExposeArray(Handle *h, PyObject *arr, cxn_uint *shape_out,
                              int want_dim, cxn_uint *out_total) {
  h->DropBuf();
  /* force float32 C-contiguous */
  PyObject *np = PyImport_ImportModule("numpy");
  if (!np) {
    CapturePyError("import numpy");
    Py_DECREF(arr);
    return nullptr;
  }
  PyObject *asc = PyObject_GetAttrString(np, "ascontiguousarray");
  PyObject *args = Py_BuildValue("(O)", arr);
  PyObject *kw = Py_BuildValue("{s:s}", "dtype", "float32");
  PyObject *carr = asc ? PyObject_Call(asc, args, kw) : nullptr;
  Py_XDECREF(asc);
  Py_DECREF(args);
  Py_DECREF(kw);
  Py_DECREF(np);
  Py_DECREF(arr);
  if (!carr) {
    CapturePyError("ascontiguousarray");
    return nullptr;
  }
  if (PyObject_GetBuffer(carr, &h->last_buf,
                         PyBUF_C_CONTIGUOUS | PyBUF_FORMAT) != 0) {
    CapturePyError("GetBuffer");
    Py_DECREF(carr);
    return nullptr;
  }
  h->has_buf = true;
  h->last_array = carr;
  if (shape_out) {
    for (int i = 0; i < want_dim; ++i) shape_out[i] = 1;
    int nd = int(h->last_buf.ndim);
    for (int i = 0; i < nd && i < want_dim; ++i)
      shape_out[i] = cxn_uint(h->last_buf.shape[i]);
    if (nd > want_dim) { /* flatten extras into the last reported dim */
      for (int i = want_dim; i < nd; ++i)
        shape_out[want_dim - 1] *= cxn_uint(h->last_buf.shape[i]);
    }
  }
  if (out_total)
    *out_total = cxn_uint(h->last_buf.len / Py_ssize_t(sizeof(cxn_real_t)));
  return reinterpret_cast<const cxn_real_t *>(h->last_buf.buf);
}

}  // namespace

extern "C" const char *CXNGetLastError(void) { return g_last_error.c_str(); }

/* ---------------- iterator ---------------- */

extern "C" void *CXNIOCreateFromConfig(const char *cfg) {
  if (!EnsurePython()) return nullptr;
  GilGuard gil;
  PyObject *cls = PyObject_GetAttrString(g_api, "DataIter");
  if (!cls) {
    CapturePyError("DataIter");
    return nullptr;
  }
  PyObject *obj = PyObject_CallFunction(cls, "s", cfg);
  Py_DECREF(cls);
  if (!obj) {
    CapturePyError("DataIter()");
    return nullptr;
  }
  Handle *h = new Handle();
  h->obj = obj;
  return h;
}

extern "C" int CXNIONext(void *handle) {
  GilGuard gil;
  Handle *h = static_cast<Handle *>(handle);
  PyObject *r = Call(h->obj, "next", nullptr);
  if (!r) return -1;
  int ret = PyObject_IsTrue(r);
  Py_DECREF(r);
  return ret;
}

extern "C" int CXNIOBeforeFirst(void *handle) {
  GilGuard gil;
  Handle *h = static_cast<Handle *>(handle);
  PyObject *r = Call(h->obj, "before_first", nullptr);
  if (!r) return -1;
  Py_DECREF(r);
  return 0;
}

extern "C" const cxn_real_t *CXNIOGetData(void *handle, cxn_uint oshape[4]) {
  GilGuard gil;
  Handle *h = static_cast<Handle *>(handle);
  PyObject *arr = Call(h->obj, "get_data", nullptr);
  if (!arr) return nullptr;
  return ExposeArray(h, arr, oshape, 4, nullptr);
}

extern "C" const cxn_real_t *CXNIOGetLabel(void *handle, cxn_uint oshape[2]) {
  GilGuard gil;
  Handle *h = static_cast<Handle *>(handle);
  PyObject *arr = Call(h->obj, "get_label", nullptr);
  if (!arr) return nullptr;
  return ExposeArray(h, arr, oshape, 2, nullptr);
}

extern "C" void CXNIOFree(void *handle) {
  delete static_cast<Handle *>(handle);
}

/* ---------------- net ---------------- */

extern "C" void *CXNNetCreate(const char *device, const char *cfg) {
  if (!EnsurePython()) return nullptr;
  GilGuard gil;
  const char *dev = device ? device : "gpu";
  /* the device must exist: a card spec without a card fails here, with
     the port's own error, and never falls back to the host */
  PyObject *resolved = PyObject_CallMethod(g_device, "resolve_device", "s",
                                           dev);
  if (!resolved) {
    CapturePyError("CXNNetCreate");
    return nullptr;
  }
  Py_DECREF(resolved);
  PyObject *cls = PyObject_GetAttrString(g_api, "Net");
  if (!cls) {
    CapturePyError("Net");
    return nullptr;
  }
  PyObject *obj = PyObject_CallFunction(cls, "ss", dev, cfg ? cfg : "");
  Py_DECREF(cls);
  if (!obj) {
    CapturePyError("Net()");
    return nullptr;
  }
  Handle *h = new Handle();
  h->obj = obj;
  return h;
}

extern "C" void CXNNetFree(void *handle) {
  delete static_cast<Handle *>(handle);
}

static int SimpleCall(void *handle, const char *method, PyObject *args) {
  GilGuard gil;
  Handle *h = static_cast<Handle *>(handle);
  PyObject *r = Call(h->obj, method, args);
  if (!r) return -1;
  Py_DECREF(r);
  return 0;
}

extern "C" int CXNNetSetParam(void *handle, const char *name,
                              const char *val) {
  GilGuard gil;
  return SimpleCall(handle, "set_param", Py_BuildValue("(ss)", name, val));
}

extern "C" int CXNNetInitModel(void *handle) {
  return SimpleCall(handle, "init_model", nullptr);
}

extern "C" int CXNNetSaveModel(void *handle, const char *fname) {
  GilGuard gil;
  return SimpleCall(handle, "save_model", Py_BuildValue("(s)", fname));
}

extern "C" int CXNNetLoadModel(void *handle, const char *fname) {
  GilGuard gil;
  return SimpleCall(handle, "load_model", Py_BuildValue("(s)", fname));
}

extern "C" int CXNNetStartRound(void *handle, int round_counter) {
  GilGuard gil;
  return SimpleCall(handle, "start_round",
                    Py_BuildValue("(i)", round_counter));
}

extern "C" int CXNNetUpdateIter(void *net_handle, void *io_handle) {
  GilGuard gil;
  Handle *net = static_cast<Handle *>(net_handle);
  Handle *io = static_cast<Handle *>(io_handle);
  PyObject *r = Call(net->obj, "update", Py_BuildValue("(O)", io->obj));
  if (!r) return -1;
  Py_DECREF(r);
  return 0;
}

extern "C" int CXNNetUpdateBatch(void *handle, const cxn_real_t *data,
                                 const cxn_uint dshape[4],
                                 const cxn_real_t *label,
                                 const cxn_uint lshape[2]) {
  GilGuard gil;
  Handle *h = static_cast<Handle *>(handle);
  PyObject *darr = MakeArray(data, dshape, 4);
  if (!darr) return -1;
  PyObject *larr = Py_None;
  Py_INCREF(Py_None);
  if (label) {
    Py_DECREF(Py_None);
    larr = MakeArray(label, lshape, 2);
    if (!larr) {
      Py_DECREF(darr);
      return -1;
    }
  }
  PyObject *r = Call(h->obj, "update", Py_BuildValue("(NN)", darr, larr));
  if (!r) return -1;
  Py_DECREF(r);
  return 0;
}

extern "C" const cxn_real_t *CXNNetPredictBatch(void *handle,
                                                const cxn_real_t *data,
                                                const cxn_uint dshape[4],
                                                cxn_uint *out_size) {
  GilGuard gil;
  Handle *h = static_cast<Handle *>(handle);
  PyObject *darr = MakeArray(data, dshape, 4);
  if (!darr) return nullptr;
  PyObject *arr = Call(h->obj, "predict", Py_BuildValue("(N)", darr));
  if (!arr) return nullptr;
  cxn_uint shape1[1] = {0};
  const cxn_real_t *p = ExposeArray(h, arr, shape1, 1, nullptr);
  if (out_size) *out_size = shape1[0];
  return p;
}

extern "C" const cxn_real_t *CXNNetPredictIter(void *net_handle,
                                               void *io_handle,
                                               cxn_uint *out_size) {
  GilGuard gil;
  Handle *net = static_cast<Handle *>(net_handle);
  Handle *io = static_cast<Handle *>(io_handle);
  PyObject *arr = Call(net->obj, "predict", Py_BuildValue("(O)", io->obj));
  if (!arr) return nullptr;
  cxn_uint shape1[1] = {0};
  const cxn_real_t *p = ExposeArray(net, arr, shape1, 1, nullptr);
  if (out_size) *out_size = shape1[0];
  return p;
}

extern "C" const cxn_real_t *CXNNetExtractBatch(void *handle,
                                                const cxn_real_t *data,
                                                const cxn_uint dshape[4],
                                                const char *node_name,
                                                cxn_uint oshape[2]) {
  GilGuard gil;
  Handle *h = static_cast<Handle *>(handle);
  PyObject *darr = MakeArray(data, dshape, 4);
  if (!darr) return nullptr;
  PyObject *arr = Call(h->obj, "extract",
                       Py_BuildValue("(Ns)", darr, node_name));
  if (!arr) return nullptr;
  return ExposeArray(h, arr, oshape, 2, nullptr);
}

extern "C" const cxn_real_t *CXNNetExtractIter(void *net_handle,
                                               void *io_handle,
                                               const char *node_name,
                                               cxn_uint oshape[2]) {
  GilGuard gil;
  Handle *net = static_cast<Handle *>(net_handle);
  Handle *io = static_cast<Handle *>(io_handle);
  PyObject *arr = Call(net->obj, "extract",
                       Py_BuildValue("(Os)", io->obj, node_name));
  if (!arr) return nullptr;
  return ExposeArray(net, arr, oshape, 2, nullptr);
}

extern "C" const cxn_real_t *CXNNetGenerate(void *handle,
                                            const cxn_real_t *prompts,
                                            const cxn_uint pshape[2],
                                            cxn_uint n_new,
                                            float temperature,
                                            cxn_uint top_k, cxn_uint seed,
                                            cxn_uint oshape[2]) {
  GilGuard gil;
  Handle *h = static_cast<Handle *>(handle);
  PyObject *parr = MakeArray(prompts, pshape, 2);
  if (!parr) return nullptr;
  /* api.Net.generate(prompts, n_new, temperature, top_k, seed) — float
   * ids in, float ids out (ExposeArray re-encodes the int result) */
  PyObject *arr = Call(h->obj, "generate",
                       Py_BuildValue("(NIfII)", parr, n_new,
                                     (double)temperature, top_k, seed));
  if (!arr) return nullptr;
  return ExposeArray(h, arr, oshape, 2, nullptr);
}

extern "C" const char *CXNNetEvaluate(void *net_handle, void *io_handle,
                                      const char *data_name) {
  GilGuard gil;
  Handle *net = static_cast<Handle *>(net_handle);
  Handle *io = static_cast<Handle *>(io_handle);
  PyObject *r = Call(net->obj, "evaluate",
                     Py_BuildValue("(Os)", io->obj, data_name));
  if (!r) return nullptr;
  const char *s = PyUnicode_AsUTF8(r);
  net->last_str = s ? s : "";
  Py_DECREF(r);
  return net->last_str.c_str();
}

extern "C" int CXNNetSetWeight(void *handle, const cxn_real_t *weight,
                               const cxn_uint wshape[2],
                               const char *layer_name, const char *tag) {
  GilGuard gil;
  Handle *h = static_cast<Handle *>(handle);
  PyObject *warr = MakeArray(weight, wshape, 2);
  if (!warr) return -1;
  PyObject *r = Call(h->obj, "set_weight",
                     Py_BuildValue("(Nss)", warr, layer_name, tag));
  if (!r) return -1;
  Py_DECREF(r);
  return 0;
}

extern "C" const cxn_real_t *CXNNetGetWeight(void *handle,
                                             const char *layer_name,
                                             const char *tag,
                                             cxn_uint oshape[2]) {
  GilGuard gil;
  Handle *h = static_cast<Handle *>(handle);
  PyObject *arr = Call(h->obj, "get_weight",
                       Py_BuildValue("(ss)", layer_name, tag));
  if (!arr) return nullptr;
  return ExposeArray(h, arr, oshape, 2, nullptr);
}
