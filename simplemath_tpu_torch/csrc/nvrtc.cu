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
#include <nvrtc.h>

#include <cstdint>
#include <cstdlib>
#include <cstring>

// Compiles ``src`` with ``opts``.  On success *image (malloc'ed: free it
// with sm_rtc_free) holds the CUBIN of *size bytes and 0 is returned;
// otherwise NVRTC's result code, and its log (cut to log_cap - 1 bytes)
// in ``log`` either way.
extern "C" int sm_rtc_compile(const char* src, const char* const* opts, int n_opts, char* log,
                              int log_cap, void** image, size_t* size) {
  *image = nullptr;
  *size = 0;
  if (log_cap > 0) log[0] = '\0';
  nvrtcProgram prog;
  nvrtcResult rc = nvrtcCreateProgram(&prog, src, "generated.cu", 0, nullptr, nullptr);
  if (rc != NVRTC_SUCCESS) return (int)rc;
  const nvrtcResult compiled = nvrtcCompileProgram(prog, n_opts, opts);
  size_t log_size = 0;
  if (nvrtcGetProgramLogSize(prog, &log_size) == NVRTC_SUCCESS && log_size > 1 && log_cap > 1) {
    char* full = static_cast<char*>(malloc(log_size));
    if (full && nvrtcGetProgramLog(prog, full) == NVRTC_SUCCESS) {
      const size_t n = log_size < (size_t)log_cap ? log_size : (size_t)log_cap;
      memcpy(log, full, n - 1);
      log[n - 1] = '\0';
    }
    free(full);
  }
  rc = compiled;
  if (rc == NVRTC_SUCCESS) rc = nvrtcGetCUBINSize(prog, size);
  if (rc == NVRTC_SUCCESS) {
    *image = malloc(*size);
    rc = *image ? nvrtcGetCUBIN(prog, static_cast<char*>(*image)) : NVRTC_ERROR_OUT_OF_MEMORY;
  }
  nvrtcDestroyProgram(&prog);
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
