// The host side every kernel source shares: its Python entry points and
// a launch through cuLaunchKernel (libcuda).
//
// Each csrc/<name>.cu builds into a Python extension module _glt_<name>
// (Python's C API only, no PyTorch headers: a build takes seconds) whose
// functions are the source's extern "C" entry points, called with plain
// Python ints for pointers (None is NULL) and sizes:
//
//   GLT_MODULE(sample_hop, GLT_ENTRY(glt_sample_hop))
//
// An entry's arguments are parsed by the C types of its own parameters,
// so there is no second list of signatures to keep in step. A call costs
// a fast-call parse, not ctypes' per-argument conversion: on the H100
// machine's host ctypes took 1.1-2.4 us more per launch of the same
// library (PERF.md).
#pragma once
#include <Python.h>

#include <atomic>
#include <cstdint>
#include <tuple>
#include <utility>

#include <cuda.h>
#include <cuda_runtime.h>

namespace glt {

template <typename T> T from_py(PyObject* o);
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

template <auto Fn> struct Entry;
template <typename... A, int (*Fn)(A...)> struct Entry<Fn> {
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
    return PyLong_FromLong(std::apply(Fn, v));
  }
};

// One launch of a __global__ function through cuLaunchKernel on
// `device`, the card of the caller's tensors. Every entry point of csrc/
// launches this way and returns the CUresult, 0 when the launch was
// enqueued (a refused configuration shows here, with no cudaGetLastError
// to call).
// A CUfunction belongs to one device's context, so the handle is looked
// up once per device. The launch switches the calling thread to `device`
// only when that is not already its current device, and back after it:
// one cudaGetDevice and a compare on the common path. The caller's stream
// must be `device`'s. The arguments convert to the kernel's own parameter
// types.
constexpr int kMaxDevices = 64;

template <auto Kernel> struct Launch;
template <typename... P, void (*Kernel)(P...)> struct Launch<Kernel> {
  static int run(dim3 grid, dim3 block, int device, void* stream,
                 P... args) {
    static std::atomic<CUfunction> fns[kMaxDevices];
    int current = 0;
    if (device < 0 || device >= kMaxDevices
        || cudaGetDevice(&current) != cudaSuccess)
      return CUDA_ERROR_INVALID_DEVICE;
    const bool switched = current != device;
    if (switched && cudaSetDevice(device) != cudaSuccess)
      return CUDA_ERROR_INVALID_DEVICE;
    int err = CUDA_SUCCESS;
    CUfunction fn = fns[device].load(std::memory_order_relaxed);
    if (!fn) {
      if (cudaGetFuncBySymbol(&fn, reinterpret_cast<const void*>(Kernel))
          == cudaSuccess)
        fns[device].store(fn, std::memory_order_relaxed);
      else
        err = CUDA_ERROR_NOT_FOUND;
    }
    if (err == CUDA_SUCCESS) {
      void* params[] = {&args...};
      err = static_cast<int>(cuLaunchKernel(
          fn, grid.x, grid.y, grid.z, block.x, block.y, block.z, 0,
          static_cast<CUstream>(stream), params, nullptr));
    }
    if (switched) cudaSetDevice(current);
    return err;
  }
};

}  // namespace glt

#define GLT_ENTRY(fn)                                                      \
  {#fn, reinterpret_cast<PyCFunction>(                                     \
            reinterpret_cast<void (*)(void)>(glt::Entry<fn>::call)),       \
   METH_FASTCALL, nullptr}

#define GLT_MODULE(name, ...)                                              \
  static PyMethodDef glt_methods[] = {__VA_ARGS__,                         \
                                      {nullptr, nullptr, 0, nullptr}};     \
  static PyModuleDef glt_module = {PyModuleDef_HEAD_INIT, "_glt_" #name,   \
                                   nullptr, -1, glt_methods};              \
  PyMODINIT_FUNC PyInit__glt_##name() { return PyModule_Create(&glt_module); }
