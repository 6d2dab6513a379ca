// The PSD projection's kernels and launchers (the design and the algorithm:
// psd_project.cu).  nvcc builds them in units of their own, so that the
// fully unrolled thread-path instantiations compile side by side
// (_build.py::units): psd_thread.cu once for each group of the thread path's
// instantiations (-DPSD_UNIT_T=float -DPSD_UNIT_FROM=1 -DPSD_UNIT_TO=7: the
// section under PSD_UNIT_T), and psd_project.cu the block path of both types
// (PSD_UNIT_BLOCK) and the C entry point, which dispatches on the type and n
// to the launchers declared at the end of this file.

#pragma once

#include <cuda_runtime.h>

#include <cfloat>
#include <cmath>
#include <cstdint>

#define PSD_MAX_SWEEPS 12   // ops/linalg_small.py::MAX_SWEEPS
#define PSD_MAX_N_F32 160   // ops/linalg_small.py::MAX_N
#define PSD_MAX_N_F64 112
#define PSD_TILE 128        // matrices (and threads) of a thread-path block
#ifndef PSD_NREG_F32        // ops/linalg_small.py::N_REG
#define PSD_NREG_F32 10
#endif
#ifndef PSD_NREG_F64
#define PSD_NREG_F64 7
#endif

template <typename T>
struct PsdEps;
template <>
struct PsdEps<float> {
    static __device__ float value() { return FLT_EPSILON; }
};
template <>
struct PsdEps<double> {
    static __device__ double value() { return DBL_EPSILON; }
};

// The rotation of one pair from the round's start values (Algorithm 8.5.1),
// and the pair's new diagonal.
template <typename T>
__device__ __forceinline__ void psd_rotation(T app, T aqq, T apq, T* c, T* s, T* dp, T* dq) {
    T t = 0;
    if (apq != 0) {
        const T tau = (aqq - app) / ((T)2 * apq);
        t = (T)1 / (fabs(tau) + sqrt((T)1 + tau * tau));
        if (!(tau >= 0)) t = -t;
    }
    *c = (T)1 / sqrt((T)1 + t * t);
    *s = t * (*c);
    *dp = app - t * apq;
    *dq = aqq + t * apq;
}

// Lets `kernel` take `smem` bytes of dynamic shared memory above the 48 KB
// default, once a device (`*done` holds a bit a device), so that a launch
// inside a CUDA graph's capture makes no such call.
template <typename K>
static cudaError_t psd_allow_smem(K kernel, size_t smem, unsigned long long* done) {
    if (smem <= 48 * 1024) return cudaSuccess;
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess || (*done >> dev & 1ull)) return err;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err == cudaSuccess) *done |= 1ull << dev;
    return err;
}

// The launchers of the two paths, each defined in its section below and
// instantiated in its unit: the thread path for an n x n matrix (n == N),
// the block path for any n the type takes.
template <typename T, int N>
int psd_thread_launch(const T* H, T* out, long long batch, T eps, cudaStream_t stream);
template <typename T>
int psd_block_launch(const T* H, T* out, long long batch, int n, T eps, cudaStream_t stream);

#if defined(PSD_UNIT_T)
// ------------------------------------------------------------ thread path
// The round-robin schedule of an n x n matrix: pair k of round r is (p, q),
// p < q; q == n (the dummy index of odd n) means no pair.
template <int N>
struct PsdRounds {
    static constexpr int M = N + (N & 1), R = M - 1, H = M / 2;
    int p[R][H], q[R][H];
    __host__ __device__ constexpr PsdRounds() : p(), q() {
        for (int r = 0; r < R; ++r)
            for (int k = 0; k < H; ++k) {
                const int a = k == 0 ? r : (r + k) % R, b = k == 0 ? R : (r - k + R) % R;
                p[r][k] = a < b ? a : b;
                q[r][k] = a < b ? b : a;
            }
    }
};

// One matrix in registers: read from m (n x n, row-major), its projection
// written back there.
template <typename T, int N>
__device__ __forceinline__ void psd_thread_matrix(T* m, T eps) {
    constexpr PsdRounds<N> sched{};
    constexpr int R = PsdRounds<N>::R, HP = PsdRounds<N>::H;
    T S[N][N], V[N][N];
    bool bad = false;
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
        for (int j = i; j < N; ++j) {
            const T v = (m[i * N + j] + m[j * N + i]) * (T)0.5;
            S[i][j] = v;
            S[j][i] = v;
            bad = bad || !isfinite(v);
            V[i][j] = i == j ? (T)1 : (T)0;
            V[j][i] = V[i][j];
        }
    if (bad) {
#pragma unroll
        for (int e = 0; e < N * N; ++e) m[e] = (T)NAN;
        return;
    }
    const T tol = PsdEps<T>::value();
#pragma unroll 1
    for (int sweep = 0; sweep < PSD_MAX_SWEEPS; ++sweep) {
        T off = 0, dg = 0;
#pragma unroll
        for (int i = 0; i < N; ++i)
#pragma unroll
            for (int j = 0; j < N; ++j) {
                const T a = fabs(S[i][j]);
                if (i != j) off = a > off ? a : off;
                else dg = a > dg ? a : dg;
            }
        if (off <= tol * dg) break;
#pragma unroll
        for (int r = 0; r < R; ++r) {
            T c[HP], s[HP], dp[HP], dq[HP];
#pragma unroll
            for (int k = 0; k < HP; ++k) {
                const int p = sched.p[r][k], q = sched.q[r][k];
                if (q < N) psd_rotation(S[p][p], S[q][q], S[p][q], &c[k], &s[k], &dp[k], &dq[k]);
            }
            // The columns of S and V.
#pragma unroll
            for (int k = 0; k < HP; ++k) {
                const int p = sched.p[r][k], q = sched.q[r][k];
                if (q < N) {
#pragma unroll
                    for (int i = 0; i < N; ++i) {
                        T xp = S[i][p], xq = S[i][q];
                        S[i][p] = c[k] * xp - s[k] * xq;
                        S[i][q] = s[k] * xp + c[k] * xq;
                        xp = V[i][p];
                        xq = V[i][q];
                        V[i][p] = c[k] * xp - s[k] * xq;
                        V[i][q] = s[k] * xp + c[k] * xq;
                    }
                }
            }
            // The rows of S; each pair's 2 x 2 block in closed form.
#pragma unroll
            for (int k = 0; k < HP; ++k) {
                const int p = sched.p[r][k], q = sched.q[r][k];
                if (q < N) {
#pragma unroll
                    for (int j = 0; j < N; ++j) {
                        if (j == p) {
                            S[p][p] = dp[k];
                            S[q][p] = 0;
                        } else if (j == q) {
                            S[p][q] = 0;
                            S[q][q] = dq[k];
                        } else {
                            const T xp = S[p][j], xq = S[q][j];
                            S[p][j] = c[k] * xp - s[k] * xq;
                            S[q][j] = s[k] * xp + c[k] * xq;
                        }
                    }
                }
            }
        }
    }
    // out = V diag(max(w, eps)) V^T, summed over k in ascending order.
    T w[N];
#pragma unroll
    for (int k = 0; k < N; ++k) w[k] = S[k][k] < eps ? eps : S[k][k];
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
        for (int j = 0; j < N; ++j) {
            T acc = 0;
#pragma unroll
            for (int k = 0; k < N; ++k) acc = acc + (V[i][k] * w[k]) * V[j][k];
            m[i * N + j] = acc;
        }
}

// A slab of `count` matrices of NN elements between device memory and
// shared memory, where each matrix starts LD elements after the last.
template <typename T, int NN, int LD, bool IN>
__device__ __forceinline__ void psd_stage(T* glob, T* slab, int count) {
    constexpr int W = 16 / sizeof(T);
    union Quad {
        uint4 u;
        T t[W];
    };
    if (count == PSD_TILE && (reinterpret_cast<uintptr_t>(glob) & 15) == 0) {
        for (int v = threadIdx.x; v < PSD_TILE * NN / W; v += PSD_TILE) {
            Quad x;
            if (IN) x.u = reinterpret_cast<const uint4*>(glob)[v];
#pragma unroll
            for (int u = 0; u < W; ++u) {
                const int g = v * W + u;
                if (IN) slab[g + g / NN * (LD - NN)] = x.t[u];
                else x.t[u] = slab[g + g / NN * (LD - NN)];
            }
            if (!IN) reinterpret_cast<uint4*>(glob)[v] = x.u;
        }
    } else {
        for (int g = threadIdx.x; g < count * NN; g += PSD_TILE) {
            if (IN) slab[g + g / NN * (LD - NN)] = glob[g];
            else glob[g] = slab[g + g / NN * (LD - NN)];
        }
    }
}

template <typename T, int N>
__global__ void __launch_bounds__(PSD_TILE)
    psd_thread_kernel(const T* __restrict__ H, T* __restrict__ out, long long batch, T eps) {
    constexpr int NN = N * N, LD = NN | 1;
    extern __shared__ __align__(16) unsigned char psd_smem[];
    T* slab = reinterpret_cast<T*>(psd_smem);
    const long long first = (long long)blockIdx.x * PSD_TILE;
    const int count = batch - first < PSD_TILE ? (int)(batch - first) : PSD_TILE;
    psd_stage<T, NN, LD, true>(const_cast<T*>(H) + first * NN, slab, count);
    __syncthreads();
    if ((int)threadIdx.x < count) psd_thread_matrix<T, N>(slab + threadIdx.x * LD, eps);
    __syncthreads();
    psd_stage<T, NN, LD, false>(out + first * NN, slab, count);
}


template <typename T, int N>
int psd_thread_launch(const T* H, T* out, long long batch, T eps, cudaStream_t stream) {
    const size_t smem = (size_t)PSD_TILE * ((N * N) | 1) * sizeof(T);
    static unsigned long long allowed = 0;
    cudaError_t err = psd_allow_smem(psd_thread_kernel<T, N>, smem, &allowed);
    if (err != cudaSuccess) return (int)err;
    const long long blocks = (batch + PSD_TILE - 1) / PSD_TILE;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    psd_thread_kernel<T, N><<<(unsigned)blocks, PSD_TILE, smem, stream>>>(H, out, batch, eps);
    return (int)cudaGetLastError();
}
#endif  // PSD_UNIT_T

#if defined(PSD_UNIT_BLOCK)
// ------------------------------------------------------------- block path
template <typename T>
__device__ __forceinline__ T psd_warp_max(T v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
        const T x = __shfl_xor_sync(0xffffffffu, v, o);
        v = x > v ? x : v;
    }
    return v;
}

// Shared memory of the block path: S and V (n rows of ld), the round's c,
// s and new diagonals (4 h), the warps' maxima (64), then the round's pairs
// (2 h ints) and the table of i mod (m - 1) (2 (m - 1) ints).
__host__ __device__ __forceinline__ int psd_block_ld(int n) { return n | 1; }
__host__ __device__ __forceinline__ size_t psd_block_smem(int n, size_t size) {
    const int m = n + (n & 1), h = m / 2;
    return (2 * (size_t)n * psd_block_ld(n) + 4 * h + 64) * size + (2 * h + 2 * (m - 1)) * 4;
}

template <typename T>
__global__ void __launch_bounds__(1024)
    psd_block_kernel(const T* __restrict__ H, T* __restrict__ out, int n, T eps) {
    extern __shared__ __align__(16) unsigned char psd_smem[];
    const int ld = psd_block_ld(n), m = n + (n & 1), R = m - 1, h = m / 2;
    const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31, warp = tid >> 5,
              nw = nt >> 5;
    T* S = reinterpret_cast<T*>(psd_smem);
    T* V = S + n * ld;
    T* rc = V + n * ld;
    T* rs = rc + h;
    T* rp = rs + h;
    T* rq = rp + h;
    T* red = rq + h;
    int* pp = reinterpret_cast<int*>(red + 64);
    int* pq = pp + h;
    int* wrap = pq + h;
    const T* Hm = H + (long long)blockIdx.x * n * n;
    T* Om = out + (long long)blockIdx.x * n * n;

    for (int i = tid; i < 2 * R; i += nt) wrap[i] = i < R ? i : i - R;
    for (int i = warp; i < n; i += nw)
        for (int j = lane; j < n; j += 32) S[i * ld + j] = Hm[i * n + j];
    __syncthreads();
    // S = (H + H^T) / 2 in place (each unordered pair by one thread), V = I,
    // and whether S holds a NaN or an inf.
    bool bad = false;
    for (int i = warp; i < n; i += nw)
        for (int j = lane; j < n; j += 32) {
            if (i <= j) {
                const T v = (S[i * ld + j] + S[j * ld + i]) * (T)0.5;
                S[i * ld + j] = v;
                S[j * ld + i] = v;
                bad = bad || !isfinite(v);
            }
            V[i * ld + j] = i == j ? (T)1 : (T)0;
        }
    if (__syncthreads_or(bad)) {
        for (int i = warp; i < n; i += nw)
            for (int j = lane; j < n; j += 32) Om[i * n + j] = (T)NAN;
        return;
    }

    // This thread's slots: S blocks u = k1 h + k2 = tid, tid + nt, ...; V
    // rows u = i h + k, numbered on after the S blocks, so that the slots of
    // a round spread evenly over the threads.  Both are stepped by (sq, sr)
    // with a carry, no division in the loops.
    const int sq = nt / h, sr = nt - sq * h;
    const int k1_0 = tid / h, k2_0 = tid - k1_0 * h;
    const int v0 = ((tid - h * h) % nt + nt) % nt;
    const int i_0 = v0 / h, kv_0 = v0 - i_0 * h;

    const T tol = PsdEps<T>::value();
#pragma unroll 1
    for (int sweep = 0; sweep < PSD_MAX_SWEEPS; ++sweep) {
        T off = 0, dg = 0;
        for (int i = warp; i < n; i += nw)
            for (int j = lane; j < n; j += 32) {
                const T a = fabs(S[i * ld + j]);
                if (i != j) off = a > off ? a : off;
                else dg = a > dg ? a : dg;
            }
        off = psd_warp_max(off);
        dg = psd_warp_max(dg);
        if (lane == 0) {
            red[warp] = off;
            red[32 + warp] = dg;
        }
        __syncthreads();
        off = 0;
        dg = 0;
        for (int w = 0; w < nw; ++w) {
            off = red[w] > off ? red[w] : off;
            dg = red[32 + w] > dg ? red[32 + w] : dg;
        }
        if (off <= tol * dg) break;  // every thread read the same values
#pragma unroll 1
        for (int r = 0; r < R; ++r) {
            // Each pair's rotation from the matrix at the round's start.
            if (tid < h) {
                const int a = tid == 0 ? r : wrap[r + tid], b = tid == 0 ? R : wrap[r - tid + R];
                const int p = a < b ? a : b, q = a < b ? b : a;
                pp[tid] = p;
                pq[tid] = q;
                if (q < n)
                    psd_rotation(S[p * ld + p], S[q * ld + q], S[p * ld + q], &rc[tid], &rs[tid],
                                 &rp[tid], &rq[tid]);
            }
            __syncthreads();
            // The 2 x 2 blocks of S: rows of pair k1 against columns of
            // pair k2, the columns rotated first, then the rows.
            for (int k1 = k1_0, k2 = k2_0; k1 < h;) {
                const int p1 = pp[k1], q1 = pq[k1];
                const bool r1 = q1 < n;
                if (k1 == k2) {
                    if (r1) {
                        S[p1 * ld + p1] = rp[k1];
                        S[q1 * ld + q1] = rq[k1];
                        S[p1 * ld + q1] = 0;
                        S[q1 * ld + p1] = 0;
                    }
                } else {
                    const int p2 = pp[k2], q2 = pq[k2];
                    const bool r2 = q2 < n;
                    T x11 = S[p1 * ld + p2], x12 = 0, x21 = 0, x22 = 0;
                    if (r2) x12 = S[p1 * ld + q2];
                    if (r1) x21 = S[q1 * ld + p2];
                    if (r1 && r2) x22 = S[q1 * ld + q2];
                    if (r2) {
                        const T c = rc[k2], s = rs[k2];
                        T y = c * x11 - s * x12;
                        x12 = s * x11 + c * x12;
                        x11 = y;
                        y = c * x21 - s * x22;
                        x22 = s * x21 + c * x22;
                        x21 = y;
                    }
                    if (r1) {
                        const T c = rc[k1], s = rs[k1];
                        T y = c * x11 - s * x21;
                        x21 = s * x11 + c * x21;
                        x11 = y;
                        y = c * x12 - s * x22;
                        x22 = s * x12 + c * x22;
                        x12 = y;
                    }
                    S[p1 * ld + p2] = x11;
                    if (r2) S[p1 * ld + q2] = x12;
                    if (r1) S[q1 * ld + p2] = x21;
                    if (r1 && r2) S[q1 * ld + q2] = x22;
                }
                k2 += sr;
                k1 += sq;
                if (k2 >= h) {
                    k2 -= h;
                    ++k1;
                }
            }
            // The rows of V.
            for (int i = i_0, k = kv_0; i < n;) {
                const int p = pp[k], q = pq[k];
                if (q < n) {
                    const T c = rc[k], s = rs[k];
                    const T xp = V[i * ld + p], xq = V[i * ld + q];
                    V[i * ld + p] = c * xp - s * xq;
                    V[i * ld + q] = s * xp + c * xq;
                }
                k += sr;
                i += sq;
                if (k >= h) {
                    k -= h;
                    ++i;
                }
            }
            __syncthreads();
        }
    }
    // out = V diag(max(w, eps)) V^T, summed over k in ascending order.
    for (int k = tid; k < n; k += nt) {
        const T w = S[k * ld + k];
        S[k * ld + k] = w < eps ? eps : w;
    }
    __syncthreads();
    for (int i = warp; i < n; i += nw)
        for (int j = lane; j < n; j += 32) {
            T acc = 0;
            for (int k = 0; k < n; ++k) acc = acc + (V[i * ld + k] * S[k * ld + k]) * V[j * ld + k];
            Om[i * n + j] = acc;
        }
}


template <typename T>
int psd_block_launch(const T* H, T* out, long long batch, int n, T eps, cudaStream_t stream) {
    if (batch > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    const int half = (n + 1) / 2, slots = half * half + n * half;
    const int threads = slots >= 1024 ? 1024 : (slots + 31) / 32 * 32;
    // The largest n's shared memory, allowed once: every n of the type
    // fits under it.
    const size_t smem = psd_block_smem(n, sizeof(T));
    static unsigned long long allowed = 0;
    cudaError_t err = psd_allow_smem(
        psd_block_kernel<T>, psd_block_smem(sizeof(T) == 4 ? PSD_MAX_N_F32 : PSD_MAX_N_F64, sizeof(T)),
        &allowed);
    if (err != cudaSuccess) return (int)err;
    psd_block_kernel<T><<<(unsigned)batch, threads, smem, stream>>>(H, out, n, eps);
    return (int)cudaGetLastError();
}
#endif  // PSD_UNIT_BLOCK
