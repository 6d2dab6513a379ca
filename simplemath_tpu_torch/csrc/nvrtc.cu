// Kernels compiled at run time: NVRTC turns a CUDA source that
// ops/codegen.py generated into a CUBIN for sm_90a, and the runtime loads
// it and hands back the kernel.  The source includes this directory's
// headers (program.cuh, tiles.cuh, reduction.cuh), so a generated kernel
// evaluates every opcode with the very code the compiled kernels run, and a
// generated evaluator runs the compiled walks.  The launches themselves are
// elementwise.cu's (sm_ew_launch_kernel, sm_ew_launch_flat_kernel) and
// reduction.cu's (sm_rd_launch_kernel), beside the geometry of the kernels
// they stand in for.
//
// Nothing here falls back: a failed compile returns NVRTC's code and log,
// a failed load the runtime's error, and the wrapper raises on either.

#include <cuda_runtime.h>
#include <dlfcn.h>
#include <nvrtc.h>

#include <cstdint>
#include <cstdlib>
#include <cstring>

// NVRTC is the toolkit's that built this library, opened by its path
// (sm_rtc_open), not linked by its soname: a process that imported torch
// first holds torch's own libnvrtc.so.12, which a link would bind to.  On
// an H100 host with nvcc 12.9 that was NVRTC 12.8, whose ptxas serialized
// the generated int8 kernels' wgmma (C7515) where 12.9's does not, on the
// same source.
static struct {
  decltype(&nvrtcCreateProgram) create;
  decltype(&nvrtcCompileProgram) compile;
  decltype(&nvrtcGetProgramLogSize) log_size;
  decltype(&nvrtcGetProgramLog) log;
  decltype(&nvrtcGetCUBINSize) cubin_size;
  decltype(&nvrtcGetCUBIN) cubin;
  decltype(&nvrtcDestroyProgram) destroy;
  decltype(&nvrtcVersion) version;
} rtc;

// Opens the NVRTC at ``path`` (once; later calls keep the first) and gives
// its version as major * 1000 + minor * 10 in *version; 0, or -1 with
// dlerror's message (cut to err_cap - 1 bytes) in ``err``.
extern "C" int sm_rtc_open(const char* path, char* err, int err_cap, int* version) {
  static void* handle = nullptr;
  if (!handle) {
    void* h = dlopen(path, RTLD_NOW | RTLD_LOCAL);
    const bool found =
        h && (rtc.create = (decltype(rtc.create))dlsym(h, "nvrtcCreateProgram")) &&
        (rtc.compile = (decltype(rtc.compile))dlsym(h, "nvrtcCompileProgram")) &&
        (rtc.log_size = (decltype(rtc.log_size))dlsym(h, "nvrtcGetProgramLogSize")) &&
        (rtc.log = (decltype(rtc.log))dlsym(h, "nvrtcGetProgramLog")) &&
        (rtc.cubin_size = (decltype(rtc.cubin_size))dlsym(h, "nvrtcGetCUBINSize")) &&
        (rtc.cubin = (decltype(rtc.cubin))dlsym(h, "nvrtcGetCUBIN")) &&
        (rtc.destroy = (decltype(rtc.destroy))dlsym(h, "nvrtcDestroyProgram")) &&
        (rtc.version = (decltype(rtc.version))dlsym(h, "nvrtcVersion"));
    if (!found) {
      const char* why = dlerror();
      if (err_cap > 0) {
        strncpy(err, why ? why : "no NVRTC", (size_t)err_cap - 1);
        err[err_cap - 1] = '\0';
      }
      if (h) dlclose(h);
      return -1;
    }
    handle = h;
  }
  int major = 0, minor = 0;
  rtc.version(&major, &minor);
  *version = major * 1000 + minor * 10;
  return 0;
}

// Compiles ``src`` with ``opts``.  On success *image (malloc'ed: free it
// with sm_rtc_free) holds the CUBIN of *size bytes and 0 is returned;
// otherwise NVRTC's result code, and its log (cut to log_cap - 1 bytes)
// in ``log`` either way.
extern "C" int sm_rtc_compile(const char* src, const char* const* opts, int n_opts, char* log,
                              int log_cap, void** image, size_t* size) {
  *image = nullptr;
  *size = 0;
  if (log_cap > 0) log[0] = '\0';
  if (!rtc.create) return (int)NVRTC_ERROR_INTERNAL_ERROR;  // sm_rtc_open first
  nvrtcProgram prog;
  nvrtcResult rc = rtc.create(&prog, src, "generated.cu", 0, nullptr, nullptr);
  if (rc != NVRTC_SUCCESS) return (int)rc;
  const nvrtcResult compiled = rtc.compile(prog, n_opts, opts);
  size_t log_size = 0;
  if (rtc.log_size(prog, &log_size) == NVRTC_SUCCESS && log_size > 1 && log_cap > 1) {
    char* full = static_cast<char*>(malloc(log_size));
    if (full && rtc.log(prog, full) == NVRTC_SUCCESS) {
      const size_t n = log_size < (size_t)log_cap ? log_size : (size_t)log_cap;
      memcpy(log, full, n - 1);
      log[n - 1] = '\0';
    }
    free(full);
  }
  rc = compiled;
  if (rc == NVRTC_SUCCESS) rc = rtc.cubin_size(prog, size);
  if (rc == NVRTC_SUCCESS) {
    *image = malloc(*size);
    rc = *image ? rtc.cubin(prog, static_cast<char*>(*image)) : NVRTC_ERROR_OUT_OF_MEMORY;
  }
  rtc.destroy(&prog);
  if (rc != NVRTC_SUCCESS) {
    free(*image);
    *image = nullptr;
    *size = 0;
  }
  return (int)rc;
}

extern "C" void sm_rtc_free(void* image) { free(image); }

// Loads a CUBIN and returns its kernel ``name`` in *kernel, the library
// that holds it in *library, and in *resident the blocks of ``threads``
// threads of that kernel the card runs at once.
extern "C" int sm_rtc_load(const void* image, const char* name, int threads, void** library,
                           void** kernel, int64_t* resident) {
  cudaLibrary_t lib = nullptr;
  cudaError_t rc = cudaLibraryLoadData(&lib, image, nullptr, nullptr, 0, nullptr, nullptr, 0);
  if (rc != cudaSuccess) return (int)rc;
  cudaKernel_t k = nullptr;
  int device = 0, sms = 0, per_sm = 0;
  rc = cudaLibraryGetKernel(&k, lib, name);
  if (rc == cudaSuccess) rc = cudaGetDevice(&device);
  if (rc == cudaSuccess) rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (rc == cudaSuccess)
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, reinterpret_cast<const void*>(k),
                                                       threads, 0);
  if (rc == cudaSuccess && per_sm < 1) rc = cudaErrorLaunchOutOfResources;
  if (rc != cudaSuccess) {
    cudaLibraryUnload(lib);
    return (int)rc;
  }
  *library = lib;
  *kernel = k;
  *resident = (int64_t)sms * per_sm;
  return 0;
}

extern "C" int sm_rtc_unload(void* library) {
  return (int)cudaLibraryUnload(static_cast<cudaLibrary_t>(library));
}
