// C predict API over the PyTorch port — flat C ABI for running the port's
// exported .mxtpu serving artifacts from C/C++ without writing any Python
// (ref src/c_api/c_predict_api.cc: MXPredCreate/SetInput/Forward/
// GetOutputShape/GetOutput/Free; error convention ref MXGetLastError), and
// the imperative, graph and extended tiers beside it.
//
// Design: the artifact is a torch.export program with its parameters
// baked in (contrib/serving.py), not an op graph, so there is no operator
// registry to re-implement natively. This library embeds a CPython
// interpreter that hosts incubator_mxnet_tpu_torch — the same layering as
// the reference, where c_predict_api.cc is a thin shim over the full core.
// The ABI itself is pure C: opaque handles, raw byte buffers, int return
// codes, thread-local error strings. Every MXTPU* symbol and signature is
// the JAX package's, so cpp_package and the language shims work unchanged
// against either library (MXTPU_PREDICT_LIB picks one).
//
// Build (native/lib.py build_predict): g++ -O3 -std=c++17 -shared -fPIC
//   c_predict_api.cc -I<python include> -lpython3.12
//   -DMXTPU_REPO_ROOT='"<checkout>"' -DMXTPU_BUILD_PYTHON='"<python>"'
// MXTPU_REPO_ROOT goes on sys.path of a booted interpreter; the interpreter
// is MXTPU_PYTHON when set, else MXTPU_BUILD_PYTHON. Loading from an
// already-running Python process (ctypes) also works: the library detects
// the live interpreter and just uses it.
//
// Every embedded call runs under the context MXTPU_CAPI_CONTEXT names
// (default gpu(0); native/__init__.py capi_context).
//
// Thread-safety: calls are serialized through the GIL; distinct handles
// may be used from distinct threads.
#include <Python.h>

#include <cstdint>
#include <cstring>
#include <mutex>
#include <string>

namespace {

thread_local std::string g_err;

int fail(const std::string& msg) {
  g_err = msg;
  return -1;
}

// Fetch the pending Python exception into g_err.
int fail_py(const char* where) {
  std::string msg = std::string(where) + ": python error";
  if (PyErr_Occurred()) {
    PyObject *type = nullptr, *value = nullptr, *tb = nullptr;
    PyErr_Fetch(&type, &value, &tb);
    PyErr_NormalizeException(&type, &value, &tb);
    if (value) {
      PyObject* s = PyObject_Str(value);
      if (s) {
        const char* c = PyUnicode_AsUTF8(s);
        if (c) msg = std::string(where) + ": " + c;
        Py_DECREF(s);
      }
    }
    Py_XDECREF(type);
    Py_XDECREF(value);
    Py_XDECREF(tb);
    PyErr_Clear();
  }
  return fail(msg);
}

std::once_flag g_init_once;
bool g_init_ok = false;
std::string g_init_err;

#ifndef MXTPU_REPO_ROOT
#define MXTPU_REPO_ROOT ""
#endif
#ifndef MXTPU_BUILD_PYTHON
#define MXTPU_BUILD_PYTHON ""
#endif

void init_python() {
  if (Py_IsInitialized()) {  // hosted inside a live interpreter (ctypes)
    g_init_ok = true;
    return;
  }
  PyConfig config;
  PyConfig_InitPythonConfig(&config);
  const char* exe = getenv("MXTPU_PYTHON");
  if (!exe || !*exe) exe = MXTPU_BUILD_PYTHON;
  if (*exe) {
    PyStatus st = PyConfig_SetBytesString(&config, &config.executable, exe);
    if (PyStatus_Exception(st)) {
      PyConfig_Clear(&config);
      g_init_err = "bad MXTPU_PYTHON";
      return;
    }
  }
  PyStatus st = Py_InitializeFromConfig(&config);
  PyConfig_Clear(&config);
  if (PyStatus_Exception(st)) {
    g_init_err = std::string("Py_InitializeFromConfig failed: ") +
                 (st.err_msg ? st.err_msg : "?");
    return;
  }
  std::string root = MXTPU_REPO_ROOT;
  if (!root.empty()) {
    std::string quoted;  // escape for a single-quoted python literal
    for (char ch : root) {
      if (ch == '\\' || ch == '\'') quoted += '\\';
      quoted += ch;
    }
    std::string code = "import sys; sys.path.insert(0, '" + quoted + "')";
    PyRun_SimpleString(code.c_str());
  }
  g_init_ok = true;
  // Drop the GIL acquired by initialization so PyGILState_Ensure works
  // from any caller thread (including this one).
  PyEval_SaveThread();
}

// RAII: ensure interpreter + hold GIL for the scope.
struct Gil {
  PyGILState_STATE state;
  bool ok;
  Gil() : ok(false) {
    std::call_once(g_init_once, init_python);
    if (!g_init_ok) return;
    state = PyGILState_Ensure();
    ok = true;
  }
  ~Gil() {
    if (ok) PyGILState_Release(state);
  }
};

PyObject* embed_module() {  // borrowed-style: cached strong ref
  static PyObject* mod = nullptr;
  if (!mod)
    mod = PyImport_ImportModule(
        "incubator_mxnet_tpu_torch.native._predict_embed");
  return mod;
}

struct PredHandle {
  PyObject* state;  // strong ref to _PredState
};

// Call module fn with args; returns new ref or null.
PyObject* call(const char* fn, PyObject* args) {
  PyObject* mod = embed_module();
  if (!mod) return nullptr;
  PyObject* f = PyObject_GetAttrString(mod, fn);
  if (!f) return nullptr;
  PyObject* r = PyObject_CallObject(f, args);
  Py_DECREF(f);
  return r;
}

int get_int(const char* fn, PredHandle* h, int* out) {
  Gil gil;
  if (!gil.ok) return fail("python init failed: " + g_init_err);
  PyObject* args = Py_BuildValue("(O)", h->state);
  PyObject* r = call(fn, args);
  Py_DECREF(args);
  if (!r) return fail_py(fn);
  *out = (int)PyLong_AsLong(r);
  Py_DECREF(r);
  if (PyErr_Occurred()) return fail_py(fn);
  return 0;
}

int get_shape(const char* fn, PredHandle* h, int index, int64_t* out_shape,
              int cap, int* out_ndim) {
  Gil gil;
  if (!gil.ok) return fail("python init failed: " + g_init_err);
  PyObject* args = Py_BuildValue("(Oi)", h->state, index);
  PyObject* r = call(fn, args);
  Py_DECREF(args);
  if (!r) return fail_py(fn);
  Py_ssize_t n = PyTuple_Size(r);
  *out_ndim = (int)n;
  if (out_shape) {
    if (n > cap) {
      Py_DECREF(r);
      return fail("shape buffer too small");
    }
    for (Py_ssize_t i = 0; i < n; ++i)
      out_shape[i] = PyLong_AsLongLong(PyTuple_GetItem(r, i));
  }
  Py_DECREF(r);
  return 0;
}

int get_dtype(const char* fn, PredHandle* h, int index, char* buf, int cap) {
  Gil gil;
  if (!gil.ok) return fail("python init failed: " + g_init_err);
  PyObject* args = Py_BuildValue("(Oi)", h->state, index);
  PyObject* r = call(fn, args);
  Py_DECREF(args);
  if (!r) return fail_py(fn);
  const char* s = PyUnicode_AsUTF8(r);
  if (!s || (int)strlen(s) + 1 > cap) {
    Py_DECREF(r);
    return fail("dtype buffer too small");
  }
  snprintf(buf, cap, "%s", s);
  Py_DECREF(r);
  return 0;
}

}  // namespace

extern "C" {

const char* MXTPUPredGetLastError() { return g_err.c_str(); }

// Load a .mxtpu serving artifact (contrib/serving.export_model output).
// ≙ MXPredCreate (the artifact replaces symbol-json + param-blob).
int MXTPUPredCreate(const char* artifact_path, void** out) {
  Gil gil;
  if (!gil.ok) return fail("python init failed: " + g_init_err);
  PyObject* args = Py_BuildValue("(s)", artifact_path);
  if (!args) return fail_py("MXTPUPredCreate");
  PyObject* st = call("create", args);
  Py_DECREF(args);
  if (!st) return fail_py("MXTPUPredCreate");
  auto* h = new PredHandle{st};
  *out = h;
  return 0;
}

int MXTPUPredNumInputs(void* handle, int* out) {
  return get_int("num_inputs", static_cast<PredHandle*>(handle), out);
}

int MXTPUPredNumOutputs(void* handle, int* out) {
  return get_int("num_outputs", static_cast<PredHandle*>(handle), out);
}

int MXTPUPredGetInputShape(void* handle, int index, int64_t* shape, int cap,
                           int* out_ndim) {
  return get_shape("input_shape", static_cast<PredHandle*>(handle), index,
                   shape, cap, out_ndim);
}

int MXTPUPredGetOutputShape(void* handle, int index, int64_t* shape, int cap,
                            int* out_ndim) {
  return get_shape("output_shape", static_cast<PredHandle*>(handle), index,
                   shape, cap, out_ndim);
}

// dtype as its numpy name ("float32", "int8", "bfloat16", ...).
int MXTPUPredGetInputDType(void* handle, int index, char* buf, int cap) {
  return get_dtype("input_dtype", static_cast<PredHandle*>(handle), index,
                   buf, cap);
}

int MXTPUPredGetOutputDType(void* handle, int index, char* buf, int cap) {
  return get_dtype("output_dtype", static_cast<PredHandle*>(handle), index,
                   buf, cap);
}

// data: C-contiguous row-major buffer of exactly the input's
// shape-product x dtype-size bytes. ≙ MXPredSetInput.
int MXTPUPredSetInput(void* handle, int index, const void* data,
                      int64_t nbytes) {
  auto* h = static_cast<PredHandle*>(handle);
  Gil gil;
  if (!gil.ok) return fail("python init failed: " + g_init_err);
  PyObject* view = PyMemoryView_FromMemory(
      const_cast<char*>(static_cast<const char*>(data)), nbytes, PyBUF_READ);
  if (!view) return fail_py("MXTPUPredSetInput");
  PyObject* args = Py_BuildValue("(OiN)", h->state, index, view);
  if (!args) {
    Py_DECREF(view);
    return fail_py("MXTPUPredSetInput");
  }
  PyObject* r = call("set_input", args);
  Py_DECREF(args);  // releases view too ("N")
  if (!r) return fail_py("MXTPUPredSetInput");
  Py_DECREF(r);
  return 0;
}

int MXTPUPredForward(void* handle) {
  auto* h = static_cast<PredHandle*>(handle);
  Gil gil;
  if (!gil.ok) return fail("python init failed: " + g_init_err);
  PyObject* args = Py_BuildValue("(O)", h->state);
  PyObject* r = call("forward", args);
  Py_DECREF(args);
  if (!r) return fail_py("MXTPUPredForward");
  Py_DECREF(r);
  return 0;
}

// Copies output `index` into data (must be exactly the output's byte size),
// straight from the device through a writable view of the caller's buffer.
// ≙ MXPredGetOutput.
int MXTPUPredGetOutput(void* handle, int index, void* data, int64_t nbytes) {
  auto* h = static_cast<PredHandle*>(handle);
  Gil gil;
  if (!gil.ok) return fail("python init failed: " + g_init_err);
  PyObject* view = PyMemoryView_FromMemory(static_cast<char*>(data), nbytes,
                                           PyBUF_WRITE);
  if (!view) return fail_py("MXTPUPredGetOutput");
  PyObject* args = Py_BuildValue("(OiN)", h->state, index, view);
  if (!args) {
    Py_DECREF(view);
    return fail_py("MXTPUPredGetOutput");
  }
  PyObject* r = call("output_into", args);
  Py_DECREF(args);  // releases view too ("N")
  if (!r) return fail_py("MXTPUPredGetOutput");
  Py_DECREF(r);
  return 0;
}

int MXTPUPredFree(void* handle) {
  auto* h = static_cast<PredHandle*>(handle);
  if (Py_IsInitialized()) {
    PyGILState_STATE s = PyGILState_Ensure();
    Py_XDECREF(h->state);
    PyGILState_Release(s);
  }
  delete h;
  return 0;
}

int mxtpu_predict_abi_version() { return 2; }

}  // extern "C"

// ---------------------------------------------------------------------------
// Imperative invoke slice (ref include/mxnet/c_api.h MXImperativeInvokeEx,
// MXNDArrayCreateEx, MXNDArraySyncCopyToCPU): name-dispatched EAGER op
// calls on opaque NDArray handles, so non-Python frontends (cpp_package,
// julia_package) can run any registered operator — not just exported
// predict artifacts. Dispatch goes through native/_invoke_embed.py into the
// same nd/nd.contrib op registry the Python frontend uses.
// ---------------------------------------------------------------------------
namespace {

PyObject* invoke_module() {
  static PyObject* mod = nullptr;
  if (!mod)
    mod = PyImport_ImportModule(
        "incubator_mxnet_tpu_torch.native._invoke_embed");
  return mod;
}

struct NDHandle {
  PyObject* arr;  // strong ref to an incubator_mxnet_tpu_torch NDArray
};

PyObject* call_invoke(const char* fn, PyObject* args) {
  PyObject* mod = invoke_module();
  if (!mod) return nullptr;
  PyObject* f = PyObject_GetAttrString(mod, fn);
  if (!f) return nullptr;
  PyObject* r = PyObject_CallObject(f, args);
  Py_DECREF(f);
  return r;
}

}  // namespace

extern "C" {

// Create an NDArray from host bytes (C-contiguous). ≙ MXNDArrayCreateEx.
int MXTPUNDCreate(const char* dtype, const int64_t* shape, int ndim,
                  const void* data, int64_t nbytes, void** out) {
  Gil gil;
  if (!gil.ok) return fail("python init failed: " + g_init_err);
  PyObject* shp = PyTuple_New(ndim);
  if (!shp) return fail_py("MXTPUNDCreate");
  for (int i = 0; i < ndim; ++i)
    PyTuple_SET_ITEM(shp, i, PyLong_FromLongLong(shape[i]));
  PyObject* view = PyMemoryView_FromMemory(
      const_cast<char*>(static_cast<const char*>(data)), nbytes, PyBUF_READ);
  if (!view) {
    Py_DECREF(shp);
    return fail_py("MXTPUNDCreate");
  }
  PyObject* args = Py_BuildValue("(sNN)", dtype, shp, view);
  if (!args) return fail_py("MXTPUNDCreate");
  PyObject* r = call_invoke("nd_create", args);
  Py_DECREF(args);
  if (!r) return fail_py("MXTPUNDCreate");
  *out = new NDHandle{r};
  return 0;
}

int MXTPUNDGetShape(void* handle, int64_t* shape, int cap, int* out_ndim) {
  auto* h = static_cast<NDHandle*>(handle);
  Gil gil;
  if (!gil.ok) return fail("python init failed: " + g_init_err);
  PyObject* args = Py_BuildValue("(O)", h->arr);
  PyObject* r = call_invoke("nd_shape", args);
  Py_DECREF(args);
  if (!r) return fail_py("MXTPUNDGetShape");
  Py_ssize_t n = PyTuple_Size(r);
  *out_ndim = (int)n;
  if (shape) {
    if (n > cap) {
      Py_DECREF(r);
      return fail("shape buffer too small");
    }
    for (Py_ssize_t i = 0; i < n; ++i)
      shape[i] = PyLong_AsLongLong(PyTuple_GetItem(r, i));
  }
  Py_DECREF(r);
  return 0;
}

int MXTPUNDGetDType(void* handle, char* buf, int cap) {
  auto* h = static_cast<NDHandle*>(handle);
  Gil gil;
  if (!gil.ok) return fail("python init failed: " + g_init_err);
  PyObject* args = Py_BuildValue("(O)", h->arr);
  PyObject* r = call_invoke("nd_dtype", args);
  Py_DECREF(args);
  if (!r) return fail_py("MXTPUNDGetDType");
  const char* s = PyUnicode_AsUTF8(r);
  if (!s || (int)strlen(s) + 1 > cap) {
    Py_DECREF(r);
    return fail("dtype buffer too small");
  }
  snprintf(buf, cap, "%s", s);
  Py_DECREF(r);
  return 0;
}

// Copy the array out as contiguous bytes; pass data=null to query size.
// ≙ MXNDArraySyncCopyToCPU.
int MXTPUNDGetData(void* handle, void* data, int64_t cap,
                   int64_t* out_nbytes) {
  auto* h = static_cast<NDHandle*>(handle);
  Gil gil;
  if (!gil.ok) return fail("python init failed: " + g_init_err);
  PyObject* args = Py_BuildValue("(O)", h->arr);
  PyObject* r = call_invoke("nd_bytes", args);
  Py_DECREF(args);
  if (!r) return fail_py("MXTPUNDGetData");
  char* buf = nullptr;
  Py_ssize_t len = 0;
  if (PyBytes_AsStringAndSize(r, &buf, &len) != 0) {
    Py_DECREF(r);
    return fail_py("MXTPUNDGetData");
  }
  if (out_nbytes) *out_nbytes = (int64_t)len;
  if (data) {
    if (len > cap) {
      Py_DECREF(r);
      return fail("data buffer too small: need " + std::to_string(len));
    }
    memcpy(data, buf, len);
  }
  Py_DECREF(r);
  return 0;
}

int MXTPUNDFree(void* handle) {
  auto* h = static_cast<NDHandle*>(handle);
  if (Py_IsInitialized()) {
    PyGILState_STATE s = PyGILState_Ensure();
    Py_XDECREF(h->arr);
    PyGILState_Release(s);
  }
  delete h;
  return 0;
}

// Name-dispatched eager op call. kwargs_json: JSON object of op attributes
// (numbers/strings/lists), may be null/empty. Outputs land in out_handles
// (capacity cap); *n_out reports how many. ≙ MXImperativeInvokeEx.
int MXTPUImperativeInvoke(const char* op_name, void** inputs, int n_inputs,
                          const char* kwargs_json, void** out_handles,
                          int cap, int* n_out) {
  Gil gil;
  if (!gil.ok) return fail("python init failed: " + g_init_err);
  PyObject* ins = PyList_New(n_inputs);
  if (!ins) return fail_py("MXTPUImperativeInvoke");
  for (int i = 0; i < n_inputs; ++i) {
    PyObject* a = static_cast<NDHandle*>(inputs[i])->arr;
    Py_INCREF(a);
    PyList_SET_ITEM(ins, i, a);
  }
  PyObject* args = Py_BuildValue(
      "(sNs)", op_name, ins, kwargs_json ? kwargs_json : "");
  if (!args) return fail_py("MXTPUImperativeInvoke");
  PyObject* r = call_invoke("invoke", args);
  Py_DECREF(args);
  if (!r) return fail_py("MXTPUImperativeInvoke");
  Py_ssize_t n = PyTuple_Size(r);
  if (n > cap) {
    Py_DECREF(r);
    return fail("output handle array too small: need " + std::to_string(n));
  }
  for (Py_ssize_t i = 0; i < n; ++i) {
    PyObject* o = PyTuple_GetItem(r, i);
    Py_INCREF(o);
    out_handles[i] = new NDHandle{o};
  }
  *n_out = (int)n;
  Py_DECREF(r);
  return 0;
}

const char* MXTPUNDGetLastError() { return g_err.c_str(); }

}  // extern "C"

// ---- autograd slice (ref c_api.h MXAutogradSetIsRecording /
// MXAutogradBackwardEx / MXNDArrayGetGrad): with MXTPUImperativeInvoke,
// non-Python frontends can TRAIN from C — tape scope, backward, gradient
// readout, and parameter writeback. -----------------------------------

namespace {

int call_bool(const char* fn, PyObject* args) {
  PyObject* r = call_invoke(fn, args);
  Py_DECREF(args);
  if (!r) return fail_py(fn);
  Py_DECREF(r);
  return 0;
}

}  // namespace

extern "C" int MXTPUNDAttachGrad(void* handle) {
  Gil gil;
  if (!gil.ok) return fail("python init failed: " + g_init_err);
  auto* h = static_cast<NDHandle*>(handle);
  return call_bool("attach_grad", Py_BuildValue("(O)", h->arr));
}

extern "C" int MXTPUAutogradRecordBegin() {
  Gil gil;
  if (!gil.ok) return fail("python init failed: " + g_init_err);
  return call_bool("record_begin", PyTuple_New(0));
}

extern "C" int MXTPUAutogradRecordEnd() {
  Gil gil;
  if (!gil.ok) return fail("python init failed: " + g_init_err);
  return call_bool("record_end", PyTuple_New(0));
}

extern "C" int MXTPUNDBackward(void* handle) {
  Gil gil;
  if (!gil.ok) return fail("python init failed: " + g_init_err);
  auto* h = static_cast<NDHandle*>(handle);
  return call_bool("backward", Py_BuildValue("(O)", h->arr));
}

// Returns a NEW NDArray handle holding the gradient of `handle`.
extern "C" int MXTPUNDGetGrad(void* handle, void** out) {
  Gil gil;
  if (!gil.ok) return fail("python init failed: " + g_init_err);
  auto* h = static_cast<NDHandle*>(handle);
  PyObject* args = Py_BuildValue("(O)", h->arr);
  PyObject* r = call_invoke("grad_of", args);
  Py_DECREF(args);
  if (!r) return fail_py("MXTPUNDGetGrad");
  *out = new NDHandle{r};
  return 0;
}

// Overwrite the array's buffer from host bytes (optimizer writeback).
extern "C" int MXTPUNDSetData(void* handle, const char* dtype,
                              const void* data, int64_t nbytes) {
  Gil gil;
  if (!gil.ok) return fail("python init failed: " + g_init_err);
  auto* h = static_cast<NDHandle*>(handle);
  PyObject* view = PyMemoryView_FromMemory(
      const_cast<char*>(static_cast<const char*>(data)), nbytes, PyBUF_READ);
  if (!view) return fail_py("MXTPUNDSetData");
  PyObject* args = Py_BuildValue("(ONs)", h->arr, view, dtype);
  if (!args) return fail_py("MXTPUNDSetData");
  return call_bool("set_data", args);
}

// ---------------------------------------------------------------------------
// Graph slice (ref include/mxnet/c_api.h MXSymbolCreateAtomicSymbol /
// MXSymbolCompose / MXSymbolListArguments / MXExecutorSimpleBindEx
// (src/c_api/c_api_executor.cc:860) / MXExecutorForward / MXExecutorBackward
// / MXExecutorOutputs): C frontends can BUILD and RUN a graph — compose
// symbols, simple_bind, forward/backward, and read/update bound arrays —
// not just predict or run eager ops. Dispatch goes through
// native/_graph_embed.py into the same symbol/executor stack the Python
// frontend uses; array traffic rides the existing ND ABI handles.
// ---------------------------------------------------------------------------

namespace {

PyObject* graph_module() {
  static PyObject* mod = nullptr;
  if (!mod)
    mod = PyImport_ImportModule(
        "incubator_mxnet_tpu_torch.native._graph_embed");
  return mod;
}

// STEALS the args reference (every call site passes a fresh
// Py_BuildValue tuple; decref here keeps the call sites leak-free —
// same contract as call_bool above). Shared by the graph and extended
// tiers; `modget` is the cached-import accessor for the target module.
PyObject* call_stealing(PyObject* (*modget)(), const char* fn,
                        PyObject* args) {
  if (!args) return nullptr;
  PyObject* mod = modget();
  if (!mod) {
    Py_DECREF(args);
    return nullptr;
  }
  PyObject* f = PyObject_GetAttrString(mod, fn);
  if (!f) {
    Py_DECREF(args);
    return nullptr;
  }
  PyObject* r = PyObject_CallObject(f, args);
  Py_DECREF(f);
  Py_DECREF(args);
  return r;
}

PyObject* call_graph(const char* fn, PyObject* args) {
  return call_stealing(graph_module, fn, args);
}

struct SymHandle {
  PyObject* obj;  // Symbol, atomic token, or Executor (opaque to C)
};

// buf == nullptr: size-probe handshake (required length incl. NUL via
// *needed) — the MXTPUNDGetData convention, so callers can retry with a
// right-sized buffer instead of dead-ending on big graphs.
int str_out(PyObject* r, char* buf, int cap, int64_t* needed,
            const char* where) {
  const char* c = PyUnicode_AsUTF8(r);
  if (!c) {
    Py_DECREF(r);
    return fail_py(where);
  }
  std::string s(c);
  Py_DECREF(r);
  if (needed) *needed = (int64_t)s.size() + 1;
  if (!buf) return 0;
  if ((int)s.size() + 1 > cap) return fail("buffer too small");
  std::snprintf(buf, cap, "%s", s.c_str());
  return 0;
}

}  // namespace

extern "C" {

// ≙ MXSymbolCreateVariable
int MXTPUSymbolCreateVariable(const char* name, void** out) {
  Gil gil;
  if (!gil.ok) return fail("python init failed: " + g_init_err);
  PyObject* r = call_graph("sym_variable", Py_BuildValue("(s)", name));
  if (!r) return fail_py("MXTPUSymbolCreateVariable");
  *out = new SymHandle{r};
  return 0;
}

// ≙ MXSymbolCreateAtomicSymbol (attrs as a JSON object string)
int MXTPUSymbolCreateAtomic(const char* op_name, const char* attrs_json,
                            void** out) {
  Gil gil;
  if (!gil.ok) return fail("python init failed: " + g_init_err);
  PyObject* r = call_graph("sym_atomic",
                           Py_BuildValue("(ss)", op_name, attrs_json));
  if (!r) return fail_py("MXTPUSymbolCreateAtomic");
  *out = new SymHandle{r};
  return 0;
}

// ≙ MXSymbolCompose: mutates `handle` from atomic token to composed node.
// keys[i] names the operator input args[i] binds to (NULL/"" = positional).
int MXTPUSymbolCompose(void* handle, const char* name, int n,
                       const char** keys, void** args) {
  Gil gil;
  if (!gil.ok) return fail("python init failed: " + g_init_err);
  auto* h = static_cast<SymHandle*>(handle);
  PyObject* kl = PyList_New(n);
  PyObject* al = PyList_New(n);
  if (!kl || !al) {
    Py_XDECREF(kl);
    Py_XDECREF(al);
    return fail_py("MXTPUSymbolCompose");
  }
  for (int i = 0; i < n; ++i) {
    PyList_SET_ITEM(kl, i, PyUnicode_FromString(keys && keys[i] ? keys[i]
                                                                : ""));
    PyObject* a = static_cast<SymHandle*>(args[i])->obj;
    Py_INCREF(a);
    PyList_SET_ITEM(al, i, a);
  }
  // N-format only steals kl/al on SUCCESS; drop them ourselves on failure
  PyObject* tup = Py_BuildValue("(OsNN)", h->obj, name ? name : "", kl, al);
  if (!tup) {
    Py_DECREF(kl);
    Py_DECREF(al);
    return fail_py("MXTPUSymbolCompose");
  }
  PyObject* r = call_graph("sym_compose", tup);
  if (!r) return fail_py("MXTPUSymbolCompose");
  Py_DECREF(h->obj);
  h->obj = r;
  return 0;
}

int MXTPUSymbolListArguments(void* handle, char* buf, int cap,
        int64_t* needed) {
  Gil gil;
  if (!gil.ok) return fail("python init failed: " + g_init_err);
  auto* h = static_cast<SymHandle*>(handle);
  PyObject* r = call_graph("sym_list_arguments",
                           Py_BuildValue("(O)", h->obj));
  if (!r) return fail_py("MXTPUSymbolListArguments");
  return str_out(r, buf, cap, needed, "MXTPUSymbolListArguments");
}

int MXTPUSymbolListOutputs(void* handle, char* buf, int cap,
        int64_t* needed) {
  Gil gil;
  if (!gil.ok) return fail("python init failed: " + g_init_err);
  auto* h = static_cast<SymHandle*>(handle);
  PyObject* r = call_graph("sym_list_outputs", Py_BuildValue("(O)", h->obj));
  if (!r) return fail_py("MXTPUSymbolListOutputs");
  return str_out(r, buf, cap, needed, "MXTPUSymbolListOutputs");
}

// ≙ MXSymbolSaveToJSON
int MXTPUSymbolToJSON(void* handle, char* buf, int cap,
        int64_t* needed) {
  Gil gil;
  if (!gil.ok) return fail("python init failed: " + g_init_err);
  auto* h = static_cast<SymHandle*>(handle);
  PyObject* r = call_graph("sym_tojson", Py_BuildValue("(O)", h->obj));
  if (!r) return fail_py("MXTPUSymbolToJSON");
  return str_out(r, buf, cap, needed, "MXTPUSymbolToJSON");
}

int MXTPUSymbolFree(void* handle) {
  Gil gil;
  auto* h = static_cast<SymHandle*>(handle);
  if (gil.ok) Py_XDECREF(h->obj);
  delete h;
  return 0;
}

// ≙ MXExecutorSimpleBindEx: shapes as a JSON object {"name": [dims...]}
int MXTPUExecutorSimpleBind(void* sym, const char* shapes_json,
                            const char* grad_req, void** out) {
  Gil gil;
  if (!gil.ok) return fail("python init failed: " + g_init_err);
  auto* h = static_cast<SymHandle*>(sym);
  PyObject* r = call_graph("executor_simple_bind",
                           Py_BuildValue("(Oss)", h->obj, shapes_json,
                                         grad_req));
  if (!r) return fail_py("MXTPUExecutorSimpleBind");
  *out = new SymHandle{r};
  return 0;
}

// ≙ MXExecutorForward (+ the feed: names/arrays pairs bind data vars)
int MXTPUExecutorForward(void* ex, int is_train, int n, const char** names,
                         void** nd_handles) {
  Gil gil;
  if (!gil.ok) return fail("python init failed: " + g_init_err);
  auto* h = static_cast<SymHandle*>(ex);
  PyObject* kl = PyList_New(n);
  PyObject* al = PyList_New(n);
  if (!kl || !al) {
    Py_XDECREF(kl);
    Py_XDECREF(al);
    return fail_py("MXTPUExecutorForward");
  }
  for (int i = 0; i < n; ++i) {
    PyList_SET_ITEM(kl, i, PyUnicode_FromString(names[i]));
    PyObject* a = static_cast<NDHandle*>(nd_handles[i])->arr;
    Py_INCREF(a);
    PyList_SET_ITEM(al, i, a);
  }
  // N-format only steals kl/al on SUCCESS; drop them ourselves on failure
  PyObject* tup = Py_BuildValue("(OiNN)", h->obj, is_train, kl, al);
  if (!tup) {
    Py_DECREF(kl);
    Py_DECREF(al);
    return fail_py("MXTPUExecutorForward");
  }
  PyObject* r = call_graph("executor_forward", tup);
  if (!r) return fail_py("MXTPUExecutorForward");
  Py_DECREF(r);
  return 0;
}

int MXTPUExecutorNumOutputs(void* ex, int* out) {
  Gil gil;
  if (!gil.ok) return fail("python init failed: " + g_init_err);
  auto* h = static_cast<SymHandle*>(ex);
  PyObject* r = call_graph("executor_num_outputs",
                           Py_BuildValue("(O)", h->obj));
  if (!r) return fail_py("MXTPUExecutorNumOutputs");
  *out = (int)PyLong_AsLong(r);
  Py_DECREF(r);
  return 0;
}

// ≙ MXExecutorOutputs — returns a new ND handle usable with the ND ABI
int MXTPUExecutorOutput(void* ex, int index, void** out) {
  Gil gil;
  if (!gil.ok) return fail("python init failed: " + g_init_err);
  auto* h = static_cast<SymHandle*>(ex);
  PyObject* r = call_graph("executor_output",
                           Py_BuildValue("(Oi)", h->obj, index));
  if (!r) return fail_py("MXTPUExecutorOutput");
  *out = new NDHandle{r};
  return 0;
}

// ≙ MXExecutorBackwardEx (head_grads NULL/0 = ones like the reference)
int MXTPUExecutorBackward(void* ex, int n, void** head_grads) {
  Gil gil;
  if (!gil.ok) return fail("python init failed: " + g_init_err);
  auto* h = static_cast<SymHandle*>(ex);
  PyObject* hl = PyList_New(n);
  if (!hl) return fail_py("MXTPUExecutorBackward");
  for (int i = 0; i < n; ++i) {
    PyObject* a = static_cast<NDHandle*>(head_grads[i])->arr;
    Py_INCREF(a);
    PyList_SET_ITEM(hl, i, a);
  }
  PyObject* r = call_graph("executor_backward",
                           Py_BuildValue("(ON)", h->obj, hl));
  if (!r) return fail_py("MXTPUExecutorBackward");
  Py_DECREF(r);
  return 0;
}

// Bound argument array by name (read/update via the ND ABI; updates are
// seen by the next forward — the executor reads args at call time).
int MXTPUExecutorArg(void* ex, const char* name, void** out) {
  Gil gil;
  if (!gil.ok) return fail("python init failed: " + g_init_err);
  auto* h = static_cast<SymHandle*>(ex);
  PyObject* r = call_graph("executor_arg",
                           Py_BuildValue("(Os)", h->obj, name));
  if (!r) return fail_py("MXTPUExecutorArg");
  *out = new NDHandle{r};
  return 0;
}

// ≙ the grad arrays MXExecutorSimpleBindEx returns
int MXTPUExecutorArgGrad(void* ex, const char* name, void** out) {
  Gil gil;
  if (!gil.ok) return fail("python init failed: " + g_init_err);
  auto* h = static_cast<SymHandle*>(ex);
  PyObject* r = call_graph("executor_arg_grad",
                           Py_BuildValue("(Os)", h->obj, name));
  if (!r) return fail_py("MXTPUExecutorArgGrad");
  *out = new NDHandle{r};
  return 0;
}

int MXTPUExecutorFree(void* handle) { return MXTPUSymbolFree(handle); }

}  // extern "C"

// ---------------------------------------------------------------------------
// Extended tier (ref include/mxnet/c_api.h MXKVStore* (~30 fns), MXProfile*,
// MXNDArraySave/Load, MXSymbolInferShape, MXListAllOpNames, MXRandomSeed,
// MXLoadLib regions): kvstore init/push/pull/broadcast from C, profiler
// control, NDArray file io, shape inference, op-registry listing, custom-op
// library loading. Dispatch through native/_ext_embed.py; arrays ride the
// existing ND ABI handles, symbols the graph-slice handles.
// ---------------------------------------------------------------------------

namespace {

PyObject* ext_module() {
  static PyObject* mod = nullptr;
  if (!mod)
    mod = PyImport_ImportModule(
        "incubator_mxnet_tpu_torch.native._ext_embed");
  return mod;
}

// STEALS args (delegates to the shared stealing-call helper).
PyObject* call_ext(const char* fn, PyObject* args) {
  return call_stealing(ext_module, fn, args);
}

// int keys -> new PyList
PyObject* int_list(const int* keys, int n) {
  PyObject* l = PyList_New(n);
  if (!l) return nullptr;
  for (int i = 0; i < n; ++i)
    PyList_SET_ITEM(l, i, PyLong_FromLong(keys[i]));
  return l;
}

// ND handles -> new PyList of borrowed-then-increfed arrs
PyObject* nd_list(void** handles, int n) {
  PyObject* l = PyList_New(n);
  if (!l) return nullptr;
  for (int i = 0; i < n; ++i) {
    PyObject* a = static_cast<NDHandle*>(handles[i])->arr;
    Py_INCREF(a);
    PyList_SET_ITEM(l, i, a);
  }
  return l;
}

int call_ext_void(const char* fn, PyObject* args, const char* where) {
  PyObject* r = call_ext(fn, args);
  if (!r) return fail_py(where);
  Py_DECREF(r);
  return 0;
}

}  // namespace

extern "C" {

// ------------------------------------------------------- NDArray save/load
// ≙ MXNDArraySave (names may be NULL / empty strings for a positional list)
int MXTPUNDArraySave(const char* fname, int n, void** nd_handles,
                     const char** names) {
  Gil gil;
  if (!gil.ok) return fail("python init failed: " + g_init_err);
  PyObject* kl = PyList_New(n);
  PyObject* al = nd_list(nd_handles, n);
  if (!kl || !al) {
    Py_XDECREF(kl);
    Py_XDECREF(al);
    return fail_py("MXTPUNDArraySave");
  }
  for (int i = 0; i < n; ++i) {
    PyObject* s = PyUnicode_FromString(names && names[i] ? names[i] : "");
    if (!s) {  // invalid UTF-8 etc. — error out, never store a NULL slot
      Py_DECREF(kl);
      Py_DECREF(al);
      return fail_py("MXTPUNDArraySave");
    }
    PyList_SET_ITEM(kl, i, s);
  }
  PyObject* tup = Py_BuildValue("(sNN)", fname, kl, al);
  if (!tup) {
    Py_DECREF(kl);
    Py_DECREF(al);
    return fail_py("MXTPUNDArraySave");
  }
  return call_ext_void("nd_save", tup, "MXTPUNDArraySave");
}

// ≙ MXNDArrayLoad: returns an opaque bundle; read items out, then free it.
int MXTPUNDArrayLoad(const char* fname, void** out_bundle, int* out_count) {
  Gil gil;
  if (!gil.ok) return fail("python init failed: " + g_init_err);
  PyObject* r = call_ext("nd_load_bundle", Py_BuildValue("(s)", fname));
  if (!r) return fail_py("MXTPUNDArrayLoad");
  PyObject* n = call_ext("bundle_len", Py_BuildValue("(O)", r));
  if (!n) {
    Py_DECREF(r);
    return fail_py("MXTPUNDArrayLoad");
  }
  *out_count = (int)PyLong_AsLong(n);
  Py_DECREF(n);
  *out_bundle = new SymHandle{r};  // opaque PyObject carrier
  return 0;
}

// name of item i (empty string for positional lists)
int MXTPUNDArrayLoadName(void* bundle, int index, char* buf, int cap,
                         int64_t* needed) {
  Gil gil;
  if (!gil.ok) return fail("python init failed: " + g_init_err);
  auto* h = static_cast<SymHandle*>(bundle);
  PyObject* r = call_ext("bundle_name", Py_BuildValue("(Oi)", h->obj, index));
  if (!r) return fail_py("MXTPUNDArrayLoadName");
  return str_out(r, buf, cap, needed, "MXTPUNDArrayLoadName");
}

// item i as a NEW ND handle usable with the whole ND ABI
int MXTPUNDArrayLoadItem(void* bundle, int index, void** out) {
  Gil gil;
  if (!gil.ok) return fail("python init failed: " + g_init_err);
  auto* h = static_cast<SymHandle*>(bundle);
  PyObject* r = call_ext("bundle_item", Py_BuildValue("(Oi)", h->obj, index));
  if (!r) return fail_py("MXTPUNDArrayLoadItem");
  *out = new NDHandle{r};
  return 0;
}

int MXTPUNDArrayLoadFree(void* bundle) { return MXTPUSymbolFree(bundle); }

// ------------------------------------------------------------------ Symbol
// ≙ MXSymbolCreateFromJSON
int MXTPUSymbolCreateFromJSON(const char* json_str, void** out) {
  Gil gil;
  if (!gil.ok) return fail("python init failed: " + g_init_err);
  PyObject* r = call_ext("sym_from_json", Py_BuildValue("(s)", json_str));
  if (!r) return fail_py("MXTPUSymbolCreateFromJSON");
  *out = new SymHandle{r};
  return 0;
}

// ≙ MXSymbolSaveToFile
int MXTPUSymbolSaveToFile(void* sym, const char* fname) {
  Gil gil;
  if (!gil.ok) return fail("python init failed: " + g_init_err);
  auto* h = static_cast<SymHandle*>(sym);
  return call_ext_void("sym_save_file",
                       Py_BuildValue("(Os)", h->obj, fname),
                       "MXTPUSymbolSaveToFile");
}

// ≙ MXSymbolListAuxiliaryStates (JSON list out)
int MXTPUSymbolListAuxiliaryStates(void* sym, char* buf, int cap,
                                   int64_t* needed) {
  Gil gil;
  if (!gil.ok) return fail("python init failed: " + g_init_err);
  auto* h = static_cast<SymHandle*>(sym);
  PyObject* r = call_ext("sym_list_aux", Py_BuildValue("(O)", h->obj));
  if (!r) return fail_py("MXTPUSymbolListAuxiliaryStates");
  return str_out(r, buf, cap, needed, "MXTPUSymbolListAuxiliaryStates");
}

// ≙ MXSymbolInferShape: shapes_json {"name": [dims]} in; JSON
// {"arg_shapes": [...], "out_shapes": [...], "aux_shapes": [...]} out.
int MXTPUSymbolInferShape(void* sym, const char* shapes_json, char* buf,
                          int cap, int64_t* needed) {
  Gil gil;
  if (!gil.ok) return fail("python init failed: " + g_init_err);
  auto* h = static_cast<SymHandle*>(sym);
  PyObject* r = call_ext("sym_infer_shape",
                         Py_BuildValue("(Os)", h->obj, shapes_json));
  if (!r) return fail_py("MXTPUSymbolInferShape");
  return str_out(r, buf, cap, needed, "MXTPUSymbolInferShape");
}

// ≙ MXSymbolGetAttr / MXSymbolSetAttr
int MXTPUSymbolGetAttr(void* sym, const char* key, char* buf, int cap,
                       int64_t* needed) {
  Gil gil;
  if (!gil.ok) return fail("python init failed: " + g_init_err);
  auto* h = static_cast<SymHandle*>(sym);
  PyObject* r = call_ext("sym_get_attr", Py_BuildValue("(Os)", h->obj, key));
  if (!r) return fail_py("MXTPUSymbolGetAttr");
  return str_out(r, buf, cap, needed, "MXTPUSymbolGetAttr");
}

int MXTPUSymbolSetAttr(void* sym, const char* key, const char* value) {
  Gil gil;
  if (!gil.ok) return fail("python init failed: " + g_init_err);
  auto* h = static_cast<SymHandle*>(sym);
  return call_ext_void("sym_set_attr",
                       Py_BuildValue("(Oss)", h->obj, key, value),
                       "MXTPUSymbolSetAttr");
}

// ----------------------------------------------------------------- KVStore
// ≙ MXKVStoreCreate / MXKVStoreFree / MXKVStoreGetType / MXKVStoreGetRank /
//   MXKVStoreGetGroupSize
int MXTPUKVStoreCreate(const char* type, void** out) {
  Gil gil;
  if (!gil.ok) return fail("python init failed: " + g_init_err);
  PyObject* r = call_ext("kv_create", Py_BuildValue("(s)", type));
  if (!r) return fail_py("MXTPUKVStoreCreate");
  *out = new SymHandle{r};
  return 0;
}

int MXTPUKVStoreFree(void* kv) { return MXTPUSymbolFree(kv); }

int MXTPUKVStoreGetType(void* kv, char* buf, int cap, int64_t* needed) {
  Gil gil;
  if (!gil.ok) return fail("python init failed: " + g_init_err);
  auto* h = static_cast<SymHandle*>(kv);
  PyObject* r = call_ext("kv_type", Py_BuildValue("(O)", h->obj));
  if (!r) return fail_py("MXTPUKVStoreGetType");
  return str_out(r, buf, cap, needed, "MXTPUKVStoreGetType");
}

int MXTPUKVStoreGetRank(void* kv, int* out) {
  Gil gil;
  if (!gil.ok) return fail("python init failed: " + g_init_err);
  auto* h = static_cast<SymHandle*>(kv);
  PyObject* r = call_ext("kv_rank", Py_BuildValue("(O)", h->obj));
  if (!r) return fail_py("MXTPUKVStoreGetRank");
  *out = (int)PyLong_AsLong(r);
  Py_DECREF(r);
  return 0;
}

int MXTPUKVStoreGetGroupSize(void* kv, int* out) {
  Gil gil;
  if (!gil.ok) return fail("python init failed: " + g_init_err);
  auto* h = static_cast<SymHandle*>(kv);
  PyObject* r = call_ext("kv_num_workers", Py_BuildValue("(O)", h->obj));
  if (!r) return fail_py("MXTPUKVStoreGetGroupSize");
  *out = (int)PyLong_AsLong(r);
  Py_DECREF(r);
  return 0;
}

namespace {

// shared body for init/push/pull-style (kv, keys, arrays) calls
int kv_keys_arrays(const char* fn, const char* where, void* kv, int n,
                   const int* keys, void** nd_handles, PyObject* extra) {
  auto* h = static_cast<SymHandle*>(kv);
  PyObject* kl = int_list(keys, n);
  PyObject* al = nd_list(nd_handles, n);
  if (!kl || !al) {
    Py_XDECREF(kl);
    Py_XDECREF(al);
    Py_XDECREF(extra);
    return fail_py(where);
  }
  PyObject* tup = extra ? Py_BuildValue("(ONNN)", h->obj, kl, al, extra)
                        : Py_BuildValue("(ONN)", h->obj, kl, al);
  if (!tup) {
    Py_DECREF(kl);
    Py_DECREF(al);
    Py_XDECREF(extra);
    return fail_py(where);
  }
  return call_ext_void(fn, tup, where);
}

}  // namespace

// ≙ MXKVStoreInit / MXKVStorePush / MXKVStorePull (int keys)
int MXTPUKVStoreInit(void* kv, int n, const int* keys, void** nd_handles) {
  Gil gil;
  if (!gil.ok) return fail("python init failed: " + g_init_err);
  return kv_keys_arrays("kv_init", "MXTPUKVStoreInit", kv, n, keys,
                        nd_handles, nullptr);
}

int MXTPUKVStorePush(void* kv, int n, const int* keys, void** nd_handles,
                     int priority) {
  Gil gil;
  if (!gil.ok) return fail("python init failed: " + g_init_err);
  return kv_keys_arrays("kv_push", "MXTPUKVStorePush", kv, n, keys,
                        nd_handles, PyLong_FromLong(priority));
}

// pull writes INTO the passed handles (their buffers are rebound)
int MXTPUKVStorePull(void* kv, int n, const int* keys, void** nd_handles) {
  Gil gil;
  if (!gil.ok) return fail("python init failed: " + g_init_err);
  return kv_keys_arrays("kv_pull", "MXTPUKVStorePull", kv, n, keys,
                        nd_handles, nullptr);
}

namespace {

// shared body for (kv, keys, values, outs) two-list calls
int kv_keys_two_lists(const char* fn, const char* where, void* kv, int n,
                      const int* keys, void** values, void** outs) {
  auto* h = static_cast<SymHandle*>(kv);
  PyObject* kl = int_list(keys, n);
  PyObject* vl = nd_list(values, n);
  PyObject* ol = nd_list(outs, n);
  if (!kl || !vl || !ol) {
    Py_XDECREF(kl);
    Py_XDECREF(vl);
    Py_XDECREF(ol);
    return fail_py(where);
  }
  PyObject* tup = Py_BuildValue("(ONNN)", h->obj, kl, vl, ol);
  if (!tup) {
    Py_DECREF(kl);
    Py_DECREF(vl);
    Py_DECREF(ol);
    return fail_py(where);
  }
  return call_ext_void(fn, tup, where);
}

}  // namespace

// ≙ MXKVStorePushPull: values pushed, outs pulled, one call
int MXTPUKVStorePushPull(void* kv, int n, const int* keys, void** values,
                         void** outs) {
  Gil gil;
  if (!gil.ok) return fail("python init failed: " + g_init_err);
  return kv_keys_two_lists("kv_pushpull", "MXTPUKVStorePushPull", kv, n,
                           keys, values, outs);
}

// ≙ MXKVStoreBroadcast
int MXTPUKVStoreBroadcast(void* kv, int n, const int* keys, void** values,
                          void** outs) {
  Gil gil;
  if (!gil.ok) return fail("python init failed: " + g_init_err);
  return kv_keys_two_lists("kv_broadcast", "MXTPUKVStoreBroadcast", kv, n,
                           keys, values, outs);
}

// ≙ MXKVStoreSetGradientCompression (params as JSON object string)
int MXTPUKVStoreSetGradientCompression(void* kv, const char* params_json) {
  Gil gil;
  if (!gil.ok) return fail("python init failed: " + g_init_err);
  auto* h = static_cast<SymHandle*>(kv);
  return call_ext_void("kv_set_compression",
                       Py_BuildValue("(Os)", h->obj, params_json),
                       "MXTPUKVStoreSetGradientCompression");
}

// ---------------------------------------------------------------- Profiler
// ≙ MXSetProcessProfilerConfig (kwargs as JSON object string)
int MXTPUProfilerSetConfig(const char* params_json) {
  Gil gil;
  if (!gil.ok) return fail("python init failed: " + g_init_err);
  return call_ext_void("profiler_set_config",
                       Py_BuildValue("(s)", params_json),
                       "MXTPUProfilerSetConfig");
}

// ≙ MXSetProcessProfilerState ("run"/"stop")
int MXTPUProfilerSetState(const char* state) {
  Gil gil;
  if (!gil.ok) return fail("python init failed: " + g_init_err);
  return call_ext_void("profiler_set_state", Py_BuildValue("(s)", state),
                       "MXTPUProfilerSetState");
}

// ≙ MXDumpProcessProfile
int MXTPUProfilerDump(int finished) {
  Gil gil;
  if (!gil.ok) return fail("python init failed: " + g_init_err);
  return call_ext_void("profiler_dump", Py_BuildValue("(i)", finished),
                       "MXTPUProfilerDump");
}

// ≙ MXAggregateProfileStatsPrint (table string out)
int MXTPUProfilerGetSummary(char* buf, int cap, int64_t* needed) {
  Gil gil;
  if (!gil.ok) return fail("python init failed: " + g_init_err);
  PyObject* r = call_ext("profiler_summary", Py_BuildValue("()"));
  if (!r) return fail_py("MXTPUProfilerGetSummary");
  return str_out(r, buf, cap, needed, "MXTPUProfilerGetSummary");
}

// -------------------------------------------------------------------- misc
// ≙ MXRandomSeed
int MXTPURandomSeed(int seed) {
  Gil gil;
  if (!gil.ok) return fail("python init failed: " + g_init_err);
  return call_ext_void("random_seed", Py_BuildValue("(i)", seed),
                       "MXTPURandomSeed");
}

// ≙ MXListAllOpNames (JSON list out)
int MXTPUListAllOpNames(char* buf, int cap, int64_t* needed) {
  Gil gil;
  if (!gil.ok) return fail("python init failed: " + g_init_err);
  PyObject* r = call_ext("list_all_op_names", Py_BuildValue("()"));
  if (!r) return fail_py("MXTPUListAllOpNames");
  return str_out(r, buf, cap, needed, "MXTPUListAllOpNames");
}

// ≙ MXLoadLib: register a user custom-op extension library/module
int MXTPULoadLib(const char* path) {
  Gil gil;
  if (!gil.ok) return fail("python init failed: " + g_init_err);
  return call_ext_void("load_lib", Py_BuildValue("(s)", path),
                       "MXTPULoadLib");
}

// ≙ MXNDArrayWaitAll
int MXTPUNDArrayWaitAll() {
  Gil gil;
  if (!gil.ok) return fail("python init failed: " + g_init_err);
  return call_ext_void("wait_all", Py_BuildValue("()"),
                       "MXTPUNDArrayWaitAll");
}

}  // extern "C"
