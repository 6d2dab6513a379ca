// The solvers' exact PSD projection (ILQRConfig.psd="eigh"), one launch a
// call: for every matrix H of a (..., n, n) float32 or float64 tensor,
//
//     S = (H + H^T) / 2,   S = V diag(w) V^T,   out = V diag(max(w, eps)) V^T,
//
// the eigendecomposition by parallel cyclic Jacobi, on chip: w and V never
// reach device memory.
//
// It replaces no TPU kernel.  The JAX package calls jnp.linalg.eigh at
// simplemath_tpu/models/ilqr.py:203 (_eigh_project), which XLA lowers to
// its own eigensolver; torch.linalg.eigh reads its info on the host, so a
// CUDA graph cannot hold it, and this kernel is the port's route on the
// card.  Its plain version, ops/linalg_small.py::psd_project_plain, runs the
// same algorithm in torch ops, operation for operation.
//
// Bound: the function reads each matrix once and writes it once, 2 n^2
// size bytes a matrix, and needs 11 n^3 + 2 n^2 + n flops whatever
// computes it (chip_smoke.py::psd_ops: 9 n^3 for a symmetric
// eigendecomposition with its eigenvectors, Golub & Van Loan's count, 2 n^3
// + n^2 for the reconstruction, n^2 + n for the symmetrization): 7.2 flops a
// byte at n = 5 in float32, under the card's ~20, so bound by bytes up to n
// = 14 and by operations above.  Jacobi itself does more: ~(18 n + 18)
// flops for each of the n (n - 1) / 2 rotations of a sweep, two IEEE
// divisions and two square roots among them, and ~2 n^2 for each sweep's
// convergence test, 3-5 times the function's count at the solvers' n (4-16)
// and 3-8 sweeps.  That arithmetic, not the bytes, is what the kernel waits
// on; it keeps the kernel from the byte bound by design.
//
// Two paths, chosen by n at the launch (PSD_NREG_F32 / PSD_NREG_F64 in
// psd_project.cuh: the largest n whose thread-path instantiation ptxas
// builds with 0 bytes of spill; ops/linalg_small.py::N_REG).  The kernels
// are in psd_project.cuh; nvcc builds the thread-path instantiations (a
// type and an n) in units of their own (psd_thread.cu: those of n < 8 of a
// type in one, each larger n alone), side by side, and this source holds
// the block path and the C entry point, which picks the launcher:
//
// * thread path, n <= N_REG: one thread a matrix, S and V in registers.  A
//   template on the type and n, fully unrolled, so every index is a
//   compile-time constant; the round-robin schedule is a constexpr table
//   (PsdRounds), no % at run time.  A block of PSD_TILE threads holds
//   PSD_TILE consecutive matrices: it stages their contiguous slab through
//   shared memory, in and out, with 16-byte accesses where the slab is
//   16-byte aligned and whole (the tail block and a misaligned input take
//   element accesses, in the same kernel), each matrix at an odd stride of
//   elements (n^2, padded by one where n^2 is even) so that the threads'
//   reads of their own matrices hit 32 banks.  An asynchronous copy
//   (cp.async, TMA) was not used: the padded layout breaks the slab into
//   runs that are not 16-byte aligned, and the staging moves the bytes of
//   the byte bound, under a tenth of the kernel's time at 819,200 x 5 x 5.
//   Each thread runs its own sweeps and leaves at its own convergence test;
//   a warp costs its slowest matrix's sweeps.
// * block path, n > N_REG: one block a matrix, S and V in shared memory at
//   an odd row stride (n | 1).  A round is two phases, each ended by one
//   __syncthreads: ceil(n/2) threads compute the round's rotations at once
//   (their pairs from a table of i mod (m - 1) written once per block, no %
//   in the loops); then every thread takes its slots of the round's
//   disjoint 2 x 2 blocks of S (the pair (p, q) of rows against the pair
//   (p', q') of columns: the columns rotated, then the rows, as the plain
//   version does, in registers; a pair's own block in closed form) and of
//   the rows of V.  The convergence test is a block max (warp shuffles,
//   then one value a warp).  Threads: ceil(n/2)^2 + n ceil(n/2) slots
//   rounded up to a warp, at most 1024.
//
// What the earlier design (a team of 4-32 lanes of one warp a matrix, in
// shared memory) lost, and where it went: (1) idle lanes at n = 5 (8 lanes,
// 2 busy in the rotations): the thread path has no team; (2) every step
// serial through shared memory with three syncs a round: the thread path
// has none, the block path two, with each 2 x 2 block kept in registers
// between the column and the row step; (3) two integer % a pair: none; (4)
// a serial convergence test: registers, or a warp-shuffle max; (5) one
// matrix's latency at n = 12-16 (50 or 1 matrices on 132 SMs): the block
// path gives every slot of a round its own thread.
//
// The algorithm (Golub & Van Loan, section 8.5): a sweep is m - 1 rounds
// of the round-robin (circle) ordering of m = n + (n odd) indices, each
// round m/2 disjoint pairs (a pair with the dummy index n is skipped; only
// pair 0 can hold it).  A round computes each pair's rotation from the
// matrix at its start (Algorithm 8.5.1: tau = (a_qq - a_pp) / (2 a_pq), t =
// sign(tau) / (|tau| + sqrt(1 + tau^2)), c = 1 / sqrt(1 + t^2), s = t c; t
// = 0 where a_pq = 0), rotates the columns of S and V, then the rows of S,
// and sets each pair's diagonal to a_pp - t a_pq and a_qq + t a_pq and its
// off-diagonal to 0.  Pairs within a round are disjoint, so each element is
// written once a step, and any mapping of elements to threads keeps the
// bits.  Each sweep starts with the convergence test: the largest
// off-diagonal magnitude at most the type's epsilon times the largest
// diagonal magnitude (a max: order-free); at most PSD_MAX_SWEEPS sweeps.
// The reconstruction sums over k in ascending order from 0.  A matrix with
// a NaN or an inf in S is all NaN in the output, and only its own.  No
// atomics, no host read, nothing allocated: the same bits on every launch,
// and a CUDA graph can hold it.  Built with --fmad=false, so each
// operation rounds once, as the plain version's torch ops do.

#define PSD_UNIT_BLOCK
#include "psd_project.cuh"

// The thread path's launcher of the n x n matrices, N the type's largest n.
template <typename T, int N>
static int psd_thread_dispatch(const T* H, T* out, long long batch, int n, T eps,
                               cudaStream_t stream) {
    if constexpr (N > 1) {
        if (n < N) return psd_thread_dispatch<T, N - 1>(H, out, batch, n, eps, stream);
    }
    return psd_thread_launch<T, N>(H, out, batch, eps, stream);
}

template <typename T>
static int psd_launch(const void* H, void* out, long long batch, int n, double eps,
                      cudaStream_t stream) {
    if (n < 1 || n > (sizeof(T) == 4 ? PSD_MAX_N_F32 : PSD_MAX_N_F64) || batch < 1)
        return (int)cudaErrorInvalidValue;
    const T* h = static_cast<const T*>(H);
    T* o = static_cast<T*>(out);
    if (n <= (sizeof(T) == 4 ? PSD_NREG_F32 : PSD_NREG_F64))
        return psd_thread_dispatch<T, sizeof(T) == 4 ? PSD_NREG_F32 : PSD_NREG_F64>(
            h, o, batch, n, (T)eps, stream);
    return psd_block_launch<T>(h, o, batch, n, (T)eps, stream);
}

extern "C" int sm_psd_project_launch(const void* H, void* out, long long batch, int n,
                                     int f64, double eps, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return f64 ? psd_launch<double>(H, out, batch, n, eps, s)
               : psd_launch<float>(H, out, batch, n, eps, s);
}
