// The solvers' exact PSD projection (ILQRConfig.psd="eigh"), one launch a
// call: for every matrix H of a (..., n, n) float32 or float64 tensor,
//
//     S = (H + H^T) / 2,   S = V diag(w) V^T,   out = V diag(max(w, eps)) V^T,
//
// the eigendecomposition by parallel cyclic Jacobi, in shared memory: w and
// V never reach device memory.
//
// It replaces no TPU kernel.  The JAX package calls jnp.linalg.eigh at
// simplemath_tpu/models/ilqr.py:203 (_eigh_project), which XLA lowers to
// its own eigensolver; torch.linalg.eigh reads its info on the host, so a
// CUDA graph cannot hold it, and this kernel is the port's route on the
// card.  Its plain version, ops/linalg_small.py::psd_project_plain, runs the
// same algorithm in torch ops, operation for operation.
//
// Bound: the function reads each matrix once and writes it once, 2 n^2
// size bytes a matrix, and needs ~11 n^3 flops whatever computes it (9 n^3
// for a symmetric eigendecomposition with its eigenvectors, Golub & Van
// Loan's count, and 2 n^3 for the reconstruction): 7.2 flops a byte at n =
// 5 in float32, under the card's ~20, so bound by bytes up to n = 14 and by
// operations above.  Jacobi itself does more: ~(18 n + 18) flops for each
// of the n (n - 1) / 2 rotations of a sweep and ~2 n^2 for each sweep's
// convergence test, 3-5 times the function's count at the solvers' n (4-16)
// and 4-8 sweeps, so the kernel's own arithmetic, not its bytes, is what
// it waits on.  What the design does about it: the matrix stays in shared
// memory from its load to its store (one read, one write of device
// memory), the bytes' bound; a team of 4-32 lanes
// of one warp (the next power of two at or above n, at least 4) works on
// one matrix, so a warp holds 1-8 matrices and the small solver blocks do
// not leave 27 of 32 lanes idle; a matrix stops at the first sweep that
// passes its convergence test.  A matrix above 32 takes a block.  What it
// does not do: keep S in registers, or use the lanes a team leaves idle
// (n = 5 runs on 8 lanes).
//
// The algorithm (Golub & Van Loan, section 8.5): a sweep is m - 1 rounds
// of the round-robin (circle) ordering of m = n + (n odd) indices, each
// round n/2 disjoint pairs (a pair with the dummy index n is skipped).  A
// round computes each pair's rotation from the matrix at its start
// (Algorithm 8.5.1: tau = (a_qq - a_pp) / (2 a_pq), t = sign(tau) / (|tau|
// + sqrt(1 + tau^2)), c = 1 / sqrt(1 + t^2), s = t c; t = 0 where a_pq =
// 0), rotates the columns of S and V, then the rows of S, and sets each
// pair's diagonal to a_pp - t a_pq and a_qq + t a_pq and its off-diagonal
// to 0.  Each sweep starts with the convergence test: the largest
// off-diagonal magnitude at most the type's epsilon times the largest
// diagonal magnitude; at most PSD_MAX_SWEEPS sweeps.  A matrix with a NaN
// or an inf in S is all NaN in the output, and only its own; the launch
// still ends.  No atomics, no host read, nothing allocated: the same bits
// on every launch, and a CUDA graph can hold it.  Built with --fmad=false,
// so each operation rounds once, as the plain version's torch ops do.

#include <cuda_runtime.h>

#include <cfloat>
#include <cmath>
#include <cstdint>

#define PSD_MAX_SWEEPS 12   // ops/linalg_small.py::MAX_SWEEPS
#define PSD_MAX_N_F32 160   // ops/linalg_small.py::MAX_N
#define PSD_MAX_N_F64 112
#define PSD_WARP_BLOCK 128  // threads of a block of warp teams

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

// The k-th pair of round r of the circle ordering of m indices.
__device__ __forceinline__ void psd_pair(int r, int k, int m, int* p, int* q) {
    int a = r, b = m - 1;
    if (k != 0) {
        a = (r + k) % (m - 1);
        b = (r - k + m - 1) % (m - 1);
    }
    *p = a < b ? a : b;
    *q = a < b ? b : a;
}

// Elements of shared memory a matrix takes: S and V, the round's six
// values a pair, two row maxima a row and a flag; even, so that a team's
// region keeps the type's alignment.
__host__ __device__ __forceinline__ int psd_team_elems(int n) {
    int h = (n + (n & 1)) / 2;
    int e = 2 * n * n + 6 * h + 2 * n + 1;
    return e + (e & 1);
}

template <typename T>
__global__ void psd_project_kernel(const T* __restrict__ H, T* __restrict__ out,
                                   long long batch, int n, int team, T eps) {
    extern __shared__ __align__(16) unsigned char psd_smem[];
    const bool block = team > 32;
    const int size = block ? (int)blockDim.x : team;
    const int team_id = block ? 0 : (int)threadIdx.x / team;
    const int lane = block ? (int)threadIdx.x : (int)threadIdx.x % team;
    const unsigned mask = block || team == 32
        ? 0xffffffffu
        : ((1u << team) - 1u) << ((threadIdx.x % 32) / team * team);
    const long long mat = (long long)blockIdx.x * (block ? 1 : PSD_WARP_BLOCK / team) + team_id;
    if (mat >= batch) return;  // the whole team leaves together
    auto sync = [&]() {
        if (block) __syncthreads();
        else __syncwarp(mask);
    };

    const int nn = n * n, m = n + (n & 1), h = m / 2;
    T* S = reinterpret_cast<T*>(psd_smem) + (long long)team_id * psd_team_elems(n);
    T* V = S + nn;
    T* pc = V + nn;
    T* ps = pc + h;
    T* pt = ps + h;
    T* pa = pt + h;
    T* pb = pa + h;
    T* pd = pb + h;
    T* roff = pd + h;
    T* rdg = roff + n;
    T* bad = rdg + n;
    const T* Hm = H + mat * nn;
    T* Om = out + mat * nn;

    if (lane == 0) *bad = 0;
    for (int e = lane; e < nn; e += size) S[e] = Hm[e];
    sync();
    // S = (H + H^T) / 2 in place, V = I, and whether S holds a NaN or inf.
    for (int e = lane; e < nn; e += size) {
        const int i = e / n, j = e % n;
        if (i <= j) {
            const T v = (S[e] + S[j * n + i]) * (T)0.5;
            S[e] = v;
            S[j * n + i] = v;
            if (!isfinite(v)) *bad = 1;
        }
        V[e] = i == j ? (T)1 : (T)0;
    }
    sync();
    if (*bad != 0) {
        for (int e = lane; e < nn; e += size) Om[e] = (T)NAN;
        return;
    }

    const T tol = PsdEps<T>::value();
    for (int sweep = 0; sweep < PSD_MAX_SWEEPS; ++sweep) {
        // Convergence: max |S_ij|, i != j, against max |S_ii|.
        for (int i = lane; i < n; i += size) {
            T off = 0;
            for (int j = 0; j < n; ++j) {
                const T a = fabs(S[i * n + j]);
                if (j != i && a > off) off = a;
            }
            roff[i] = off;
            rdg[i] = fabs(S[i * n + i]);
        }
        sync();
        T off = 0, dg = 0;
        for (int i = 0; i < n; ++i) {
            off = roff[i] > off ? roff[i] : off;
            dg = rdg[i] > dg ? rdg[i] : dg;
        }
        if (off <= tol * dg) break;  // every lane of the team read the same values
        for (int r = 0; r < m - 1; ++r) {
            // Each pair's rotation from the matrix at the round's start.
            for (int k = lane; k < h; k += size) {
                int p, q;
                psd_pair(r, k, m, &p, &q);
                if (q >= n) continue;
                const T app = S[p * n + p], aqq = S[q * n + q], apq = S[p * n + q];
                T t = 0;
                if (apq != 0) {
                    const T tau = (aqq - app) / ((T)2 * apq);
                    t = (T)1 / (fabs(tau) + sqrt((T)1 + tau * tau));
                    if (!(tau >= 0)) t = -t;
                }
                const T c = (T)1 / sqrt((T)1 + t * t);
                pc[k] = c;
                ps[k] = t * c;
                pt[k] = t;
                pa[k] = app;
                pb[k] = aqq;
                pd[k] = apq;
            }
            sync();
            // The columns of S and V: a row a lane.
            for (int i = lane; i < n; i += size) {
                for (int k = 0; k < h; ++k) {
                    int p, q;
                    psd_pair(r, k, m, &p, &q);
                    if (q >= n) continue;
                    const T c = pc[k], s = ps[k];
                    T xp = S[i * n + p], xq = S[i * n + q];
                    S[i * n + p] = c * xp - s * xq;
                    S[i * n + q] = s * xp + c * xq;
                    xp = V[i * n + p];
                    xq = V[i * n + q];
                    V[i * n + p] = c * xp - s * xq;
                    V[i * n + q] = s * xp + c * xq;
                }
            }
            sync();
            // The rows of S: a column a lane; each pair's 2 x 2 block in
            // closed form.
            for (int j = lane; j < n; j += size) {
                for (int k = 0; k < h; ++k) {
                    int p, q;
                    psd_pair(r, k, m, &p, &q);
                    if (q >= n) continue;
                    if (j == p) {
                        S[p * n + p] = pa[k] - pt[k] * pd[k];
                        S[q * n + p] = 0;
                    } else if (j == q) {
                        S[p * n + q] = 0;
                        S[q * n + q] = pb[k] + pt[k] * pd[k];
                    } else {
                        const T c = pc[k], s = ps[k];
                        const T xp = S[p * n + j], xq = S[q * n + j];
                        S[p * n + j] = c * xp - s * xq;
                        S[q * n + j] = s * xp + c * xq;
                    }
                }
            }
            sync();
        }
    }
    // out = V diag(max(w, eps)) V^T, summed over k in ascending order.
    for (int e = lane; e < nn; e += size) {
        const int i = e / n, j = e % n;
        T acc = 0;
        for (int k = 0; k < n; ++k) {
            T w = S[k * n + k];
            w = w < eps ? eps : w;
            acc = acc + (V[i * n + k] * w) * V[j * n + k];
        }
        Om[e] = acc;
    }
}

template <typename T>
static int psd_launch(const void* H, void* out, long long batch, int n, double eps,
                      cudaStream_t stream) {
    if (n < 1 || n > (sizeof(T) == 4 ? PSD_MAX_N_F32 : PSD_MAX_N_F64) || batch < 1)
        return (int)cudaErrorInvalidValue;
    int team = 4;
    while (team < n && team < 32) team *= 2;
    const bool block = n > 32;
    const int threads = block ? (n + 31) / 32 * 32 : PSD_WARP_BLOCK;
    const long long per_block = block ? 1 : PSD_WARP_BLOCK / team;
    const long long blocks = (batch + per_block - 1) / per_block;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    const size_t smem = (size_t)per_block * psd_team_elems(n) * sizeof(T);
    if (smem > 48 * 1024) {
        cudaError_t err = cudaFuncSetAttribute(
            psd_project_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
    }
    psd_project_kernel<T><<<(unsigned)blocks, threads, smem, stream>>>(
        static_cast<const T*>(H), static_cast<T*>(out), batch, n, block ? 64 : team, (T)eps);
    return (int)cudaGetLastError();
}

extern "C" int sm_psd_project_launch(const void* H, void* out, long long batch, int n,
                                     int f64, double eps, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return f64 ? psd_launch<double>(H, out, batch, n, eps, s)
               : psd_launch<float>(H, out, batch, n, eps, s);
}
