// The PSD projection's float64 launcher (psd_project.cu has the design;
// psd_project.cuh the kernels), a source of its own so that it compiles
// beside the float32 one.

#include "psd_project.cuh"

int psd_launch_f64(const void* H, void* out, long long batch, int n, double eps,
                   cudaStream_t stream) {
    return psd_launch<double>(H, out, batch, n, eps, stream);
}
