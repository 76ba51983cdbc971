// The host side every kernel source shares: its Python entry points and
// a launch through cuLaunchKernel, or a cooperative one through
// cuLaunchKernelEx (libcuda).
//
// Each csrc/<name>.cu builds into a Python extension module _glt_<name>
// (Python's C API only, no PyTorch headers: a build takes seconds) whose
// functions are the source's extern "C" entry points, called with plain
// Python ints for pointers (None is NULL) and sizes:
//
//   GLT_MODULE(sample_hop, GLT_LAUNCH(glt_sample_hop))
//
// An entry's arguments are parsed by the C types of its own parameters,
// so there is no second list of signatures to keep in step. A call costs
// a fast-call parse, not ctypes' per-argument conversion: on the H100
// machine's host ctypes took 1.1-2.4 us more per launch of the same
// library (PERF.md).
//
// An entry that launches (GLT_LAUNCH) ends in (int device, void* stream)
// and also reads that stream's capture state (cuStreamIsCapturing) in the
// same call, before it launches: it returns 0 when its kernels were
// enqueued to run, kRecorded when the stream was capturing a CUDA graph
// (the launch was recorded into the graph, not run), else the CUresult of
// the failed query or launch. The wrappers count launches by that return
// (ops/cuda_kernels.py count_launch), with no capture query of their own.
#pragma once
#include <Python.h>

#include <atomic>
#include <cstdint>
#include <tuple>
#include <type_traits>
#include <utility>

#include <cuda.h>
#include <cuda_runtime.h>

namespace glt {

// A parameter type of its own converts through its static from_py.
template <typename T> T from_py(PyObject* o) { return T::from_py(o); }
template <> inline void* from_py<void*>(PyObject* o) {
  return o == Py_None ? nullptr : PyLong_AsVoidPtr(o);
}
template <> inline const void* from_py<const void*>(PyObject* o) {
  return from_py<void*>(o);
}
template <> inline int from_py<int>(PyObject* o) {
  return static_cast<int>(PyLong_AsLong(o));
}
template <> inline int64_t from_py<int64_t>(PyObject* o) {
  return PyLong_AsLongLong(o);
}

// Up to N int64 values from a Python sequence of ints (a pointer is its
// address, NULL is 0): a parameter whose length varies per call, such as
// the walk's per-hop planes. More than N raises ValueError.
template <int N> struct Ints {
  int n = 0;
  int64_t v[N];
  static Ints from_py(PyObject* o) {
    Ints r;
    PyObject* seq = PySequence_Fast(o, "expected a sequence of ints");
    if (!seq) return r;
    const Py_ssize_t n = PySequence_Fast_GET_SIZE(seq);
    if (n > N) {
      PyErr_Format(PyExc_ValueError, "at most %d ints, got %d", N,
                   static_cast<int>(n));
    } else {
      PyObject** items = PySequence_Fast_ITEMS(seq);
      for (Py_ssize_t i = 0; i < n; ++i)
        r.v[i] = PyLong_AsLongLong(items[i]);
      r.n = static_cast<int>(n);
    }
    Py_DECREF(seq);
    return r;
  }
};

// One launch of a __global__ function through cuLaunchKernel on
// `device`, the card of the caller's tensors. Every entry point of csrc/
// launches this way (or through CoopLaunch below) and returns the
// CUresult, 0 when the launch was enqueued (a refused configuration shows
// here, with no cudaGetLastError to call).
// A CUfunction belongs to one device's context, so the handle is looked
// up once per device. The launch switches the calling thread to `device`
// only when that is not already its current device, and back after it:
// one cudaGetDevice and a compare on the common path. The caller's stream
// must be `device`'s. The arguments convert to the kernel's own parameter
// types.
constexpr int kMaxDevices = 64;

// Makes `device` current for the scope when it is not; `err` is set when
// the device is out of range or cannot be made current.
struct DeviceGuard {
  int current = 0;
  bool switched = false;
  int err = CUDA_SUCCESS;
  explicit DeviceGuard(int device) {
    if (device < 0 || device >= kMaxDevices
        || cudaGetDevice(&current) != cudaSuccess) {
      err = CUDA_ERROR_INVALID_DEVICE;
      return;
    }
    switched = current != device;
    if (switched && cudaSetDevice(device) != cudaSuccess) {
      switched = false;
      err = CUDA_ERROR_INVALID_DEVICE;
    }
  }
  ~DeviceGuard() {
    if (switched) cudaSetDevice(current);
  }
};

// `device`'s SM count, read once per device (0 <= device < kMaxDevices).
inline int sm_count(int device) {
  static int counts[kMaxDevices];
  if (!counts[device])
    cudaDeviceGetAttribute(&counts[device], cudaDevAttrMultiProcessorCount,
                           device);
  return counts[device] > 0 ? counts[device] : 1;
}

// The kernel's handle in `device`'s context (current), null if missing.
template <auto Kernel> CUfunction kernel_handle(int device) {
  static std::atomic<CUfunction> fns[kMaxDevices];
  CUfunction fn = fns[device].load(std::memory_order_relaxed);
  if (!fn && cudaGetFuncBySymbol(&fn, reinterpret_cast<const void*>(Kernel))
                 == cudaSuccess)
    fns[device].store(fn, std::memory_order_relaxed);
  return fn;
}

template <auto Kernel> struct Launch;
template <typename... P, void (*Kernel)(P...)> struct Launch<Kernel> {
  static int run(dim3 grid, dim3 block, int device, void* stream,
                 P... args) {
    DeviceGuard guard(device);
    if (guard.err != CUDA_SUCCESS) return guard.err;
    CUfunction fn = kernel_handle<Kernel>(device);
    if (!fn) return CUDA_ERROR_NOT_FOUND;
    void* params[] = {&args...};
    return static_cast<int>(cuLaunchKernel(
        fn, grid.x, grid.y, grid.z, block.x, block.y, block.z, 0,
        static_cast<CUstream>(stream), params, nullptr));
  }
};

// A cooperative launch (cuLaunchKernelEx with
// CU_LAUNCH_ATTRIBUTE_COOPERATIVE) of `Kernel` in blocks of `Threads`
// threads: every block starts at once or the launch is refused,
// so the kernel may separate its phases by grid-wide barriers
// (cooperative_groups::this_grid().sync()). The launch may be captured
// into a CUDA graph. The device guard and the handle cache are Launch's.
//
// blocks(device) is the most blocks that can be resident together on
// `device` -- the occupancy calculator's blocks per SM times the SM
// count, cached per device -- or a negative CUresult; a launch takes at
// most that many, and its phases loop grid-stride over their work.
template <auto Kernel, int Threads> struct CoopLaunch;
template <typename... P, void (*Kernel)(P...), int Threads>
struct CoopLaunch<Kernel, Threads> {
  static int blocks(int device) {
    static std::atomic<int> cached[kMaxDevices];
    if (device < 0 || device >= kMaxDevices)
      return -CUDA_ERROR_INVALID_DEVICE;
    int n = cached[device].load(std::memory_order_relaxed);
    if (n > 0) return n;
    DeviceGuard guard(device);
    if (guard.err != CUDA_SUCCESS) return -guard.err;
    CUfunction fn = kernel_handle<Kernel>(device);
    if (!fn) return -CUDA_ERROR_NOT_FOUND;
    int per_sm = 0, sms = 0;
    int err = cuOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn,
                                                           Threads, 0);
    if (err != CUDA_SUCCESS) return -err;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)
        != cudaSuccess)
      return -CUDA_ERROR_INVALID_DEVICE;
    n = per_sm * sms;
    if (n <= 0) return -CUDA_ERROR_INVALID_VALUE;
    cached[device].store(n, std::memory_order_relaxed);
    return n;
  }

  static int run(int grid, int device, void* stream, P... args) {
    DeviceGuard guard(device);
    if (guard.err != CUDA_SUCCESS) return guard.err;
    CUfunction fn = kernel_handle<Kernel>(device);
    if (!fn) return CUDA_ERROR_NOT_FOUND;
    CUlaunchAttribute attr;
    attr.id = CU_LAUNCH_ATTRIBUTE_COOPERATIVE;
    attr.value.cooperative = 1;
    CUlaunchConfig cfg = {};
    cfg.gridDimX = static_cast<unsigned>(grid);
    cfg.gridDimY = cfg.gridDimZ = 1;
    cfg.blockDimX = Threads;
    cfg.blockDimY = cfg.blockDimZ = 1;
    cfg.hStream = static_cast<CUstream>(stream);
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    void* params[] = {&args...};
    return static_cast<int>(cuLaunchKernelEx(&cfg, fn, params, nullptr));
  }
};

// What a launching entry returns when its stream was capturing a CUDA
// graph: its kernels were recorded into the graph, not run. Every other
// return is a CUresult, which is never negative.
constexpr int kRecorded = -1;

// The capture state of `stream`, a stream of `device`, as a launching
// entry returns it: 0 (not capturing), kRecorded (capturing), or the
// CUresult of a query that failed -- such as
// CUDA_ERROR_STREAM_CAPTURE_IMPLICIT for the legacy stream while another
// stream captures in global mode -- or CUDA_ERROR_STREAM_CAPTURE_
// INVALIDATED for a capture already broken. A failed query is never taken
// for "not capturing". The legacy stream (0) is the current context's, so
// `device` is made current for the query.
inline int capture_state(int device, void* stream) {
  DeviceGuard guard(device);
  if (guard.err != CUDA_SUCCESS) return guard.err;
  CUstreamCaptureStatus status;
  const CUresult err =
      cuStreamIsCapturing(static_cast<CUstream>(stream), &status);
  if (err != CUDA_SUCCESS) return err;
  if (status == CU_STREAM_CAPTURE_STATUS_NONE) return CUDA_SUCCESS;
  if (status == CU_STREAM_CAPTURE_STATUS_ACTIVE) return kRecorded;
  return CUDA_ERROR_STREAM_CAPTURE_INVALIDATED;
}

// The Python function of entry point Fn; kLaunches adds the capture
// state of Fn's stream, read before Fn runs (see the header).
template <auto Fn, bool kLaunches> struct Entry;
template <typename... A, int (*Fn)(A...), bool kLaunches>
struct Entry<Fn, kLaunches> {
  static PyObject* call(PyObject*, PyObject* const* args, Py_ssize_t n) {
    if (n != static_cast<Py_ssize_t>(sizeof...(A))) {
      PyErr_Format(PyExc_TypeError, "takes %d arguments, got %d",
                   static_cast<int>(sizeof...(A)), static_cast<int>(n));
      return nullptr;
    }
    return parse(args, std::index_sequence_for<A...>{});
  }
  template <size_t... I>
  static PyObject* parse(PyObject* const* args, std::index_sequence<I...>) {
    // braced initialisers evaluate left to right
    std::tuple<A...> v{from_py<A>(args[I])...};
    if (PyErr_Occurred()) return nullptr;
    if constexpr (kLaunches) {
      constexpr size_t k = sizeof...(A);
      using Args = std::tuple<A...>;
      static_assert(k >= 2
                    && std::is_same_v<std::tuple_element_t<k - 2, Args>, int>
                    && std::is_same_v<std::tuple_element_t<k - 1, Args>,
                                      void*>,
                    "a launching entry ends in (int device, void* stream)");
      const int state = capture_state(std::get<k - 2>(v), std::get<k - 1>(v));
      if (state > 0) return PyLong_FromLong(state);
      const int err = std::apply(Fn, v);
      return PyLong_FromLong(err != CUDA_SUCCESS ? err : state);
    } else {
      return PyLong_FromLong(std::apply(Fn, v));
    }
  }
};

}  // namespace glt

// An entry point that launches nothing (a query, a host registration).
#define GLT_ENTRY(fn)                                                      \
  {#fn, reinterpret_cast<PyCFunction>(reinterpret_cast<void (*)(void)>(    \
            glt::Entry<fn, false>::call)),                                 \
   METH_FASTCALL, nullptr}

// An entry point that launches on its (int device, void* stream).
#define GLT_LAUNCH(fn)                                                     \
  {#fn, reinterpret_cast<PyCFunction>(reinterpret_cast<void (*)(void)>(    \
            glt::Entry<fn, true>::call)),                                  \
   METH_FASTCALL, nullptr}

#define GLT_MODULE(name, ...)                                              \
  static PyMethodDef glt_methods[] = {__VA_ARGS__,                         \
                                      {nullptr, nullptr, 0, nullptr}};     \
  static PyModuleDef glt_module = {PyModuleDef_HEAD_INIT, "_glt_" #name,   \
                                   nullptr, -1, glt_methods};              \
  PyMODINIT_FUNC PyInit__glt_##name() { return PyModule_Create(&glt_module); }
