// Instantiations of the PSD projection's thread path (psd_project.cu has the
// design, psd_project.cuh the kernels): the element type PSD_UNIT_T for each
// n from PSD_UNIT_FROM to PSD_UNIT_TO, which come from the command line
// (_build.py::units), so that nvcc compiles the costly fully unrolled
// kernels side by side.

#include "psd_project.cuh"

static_assert(PSD_UNIT_FROM >= 1 && PSD_UNIT_TO <= 12, "an n this file instantiates");

#define PSD_IN(n) (PSD_UNIT_FROM <= (n) && (n) <= PSD_UNIT_TO)
#define PSD_LAUNCHER(n)                                                                  \
    template int psd_thread_launch<PSD_UNIT_T, n>(const PSD_UNIT_T*, PSD_UNIT_T*, long long, \
                                                  PSD_UNIT_T, cudaStream_t)
#if PSD_IN(1)
PSD_LAUNCHER(1);
#endif
#if PSD_IN(2)
PSD_LAUNCHER(2);
#endif
#if PSD_IN(3)
PSD_LAUNCHER(3);
#endif
#if PSD_IN(4)
PSD_LAUNCHER(4);
#endif
#if PSD_IN(5)
PSD_LAUNCHER(5);
#endif
#if PSD_IN(6)
PSD_LAUNCHER(6);
#endif
#if PSD_IN(7)
PSD_LAUNCHER(7);
#endif
#if PSD_IN(8)
PSD_LAUNCHER(8);
#endif
#if PSD_IN(9)
PSD_LAUNCHER(9);
#endif
#if PSD_IN(10)
PSD_LAUNCHER(10);
#endif
#if PSD_IN(11)
PSD_LAUNCHER(11);
#endif
#if PSD_IN(12)
PSD_LAUNCHER(12);
#endif
