#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py

Runs ``simplemath_tpu_torch`` (never JAX) on ``cuda:0``, the port's default
device:

1. the card (``nvidia-smi``), torch and CUDA versions;
2. builds the kernels from ``simplemath_tpu_torch/csrc``, timed, and starts
   compiling the generated kernels of phases 3d and 5d on other threads;
3. holds the kernel against its plain PyTorch version on the card, same
   inputs: flat and broadcast adds, transposed and negative-step view
   operands, every opcode on float32, int32, uint32 and bfloat16 (integer
   floor division and remainder by 0 and -1 included; a bfloat16 result
   rounded to bfloat16 at each instruction) and every cast between them,
   int32 ``ipow`` with negative exponents and static pow; a bfloat16 chain
   recorded by the lazy queue gives the bits of its ops launched one by
   one, on ``ew_flat`` and on ``ew_strided``; arithmetic must agree
   exactly, transcendentals
   within 2 ulp; the crafted transcendentals are also held against float64
   numpy at the JAX package's "crafted" bounds.  The opcode cases run
   ``ew_flat``'s 16-byte path with a ragged tail, one instruction each (the
   dispatch hoisted out of the loop); a chain, a scalar operand on either
   side, a constant, a bool store and an operand 4 bytes off (the
   per-element path) are held bit for bit against the plain interpreter
   and against ``ew_strided`` on the same program.  ``ew_strided``'s
   kernels (the one generated for the program and compiled with NVRTC,
   ``ops/codegen.py``, which every call takes, and the per-element
   interpreter, ``elementwise.interpret``, kept as its reference) give the
   same bits on every opcode and cast (float32, int32, bool; operands read
   backwards), ranks 1 to 8 with a broadcast row and a negative-step
   operand, a carry over 1 and 16 iterations and a program of
   ``MAX_INSTS`` instructions, each launch on the kernel
   ``elementwise.PATHS`` names; ``ew_flat``'s kernels generated per program
   (every program of more than one instruction) give the interpreter's bits
   (``flat_generated_checks``: every opcode and cast on float32, int32,
   uint32, bool and bfloat16 after a select, scalar operands, a ragged
   tail, bfloat16 operands 2 bytes off, programs of ``MAX_INSTS``
   instructions), each launch counted ``generated`` in
   ``elementwise.FLAT_PATHS``;
4. drives the two workloads of BASELINE.json through the public ``sm`` API
   at full size (the 1M-float ``sm.add``; ``sm.fuse(chain, donate=0,
   iterations=L)`` on 2048x2048 with L = 16 and 400), counts the kernel's
   launches (one per call; both recurrences on ``ew_strided``'s generated
   kernels), prints NVRTC's milliseconds per new signature and the cache's
   counts, and checks the results; then the flat chain ``a * b + c - a`` on
   16M floats through ``sm.fuse``: one launch of ``ew_flat``'s kernel
   generated for it, exact;
5. the reductions: holds the map-reduce kernel (``rd_full``, ``rd_axis``)
   against its plain version on the card (ragged 1-D, (8192, 8192), a
   transposed and a negative-step view, NaN, the f32, int32 (exact, with
   its wraparound) and f32.int32 dots, a map-reduce with a (1, C) row and
   an (R, 1) column operand, axis 0 and 1, bfloat16 and float16 inputs
   full and along both axes (8-byte quads on the ``direct`` loop where the
   operand and its rows allow them, each the bits of the same values 2
   bytes off, gathered by a generated evaluator) and bfloat16 map-reduces on
   a generated evaluator and on ``single`` (rounded on each lane); sums and
   dots within
   2e-5 * sum|x| of the plain version and of float64 numpy, max/min and
   the int32 dot exact, every result bit-identical across two launches),
   each on the path ``reduction.PATHS`` must name: ``direct`` (identity),
   ``single`` (the f32 and int32 dots, ``x * 1.0``), ``generated`` (the
   f32.int32 dot, ``x * 1.0 + 0.0``, the map-reduce, and every launch whose
   operands are gathered: a view one element off, a transposed view, ragged
   rows), for ``rd_full`` and for ``rd_axis`` along both axes of a ragged
   (517, 1030) matrix, all paths giving the bits of the direct one; the
   generated evaluators give ``reduction.interpret``'s bits on every walk
   (``reduction_generated_checks``: flat, rows, strided, flat gathered, axis
   0 and 1 on quads and gathered; sum, max and min; float32, bfloat16 and
   float16),
   then drives bench.py's reduction workloads through the public API at
   full size (``Array.sum()`` of 64M f32, ``sm.dot`` of two 32M vectors,
   the fused squared distance with a 0-d operand, the fused thresholded
   axis sums of (8192, 8192), a lazy ``sm.sum`` of a pending chain, the
   fused ``sum(a * row - col)`` of (8192, 8192)) and
   counts each call's launches by entry point; then, through the public
   API too, the 1M add in bfloat16 and in uint32, int32 ``//`` of 1M, the
   L = 400 recurrence on bfloat16 arrays, ``Array.sum()`` of the 64M
   values in bfloat16 and in float16, their axis-0 sum as an (8192, 8192)
   bfloat16 matrix and ``sm.fuse``'s reduction root ``sum(a * a + a)``
   over the 1M bfloat16 array, each one launch, none on the plain torch
   route, held to their plain versions and to numpy; the bfloat16 add and
   sums on the 2-byte quad paths by their counters (``ew_flat`` "wide",
   ``rd_*`` ``direct``) and bit for bit the element path's on the same
   values 2 bytes off;
5c. ``sm`` ops under ``torch.func`` on each kernel family, under sync
   debug mode ``"error"``: ``sm.fuse``'s matmul root ``tanh(x @ w + b)``
   at (2048, 2048) @ (2048, 2048) under ``grad``, ``jvp`` and ``vmap``
   (``mm``/``bmm`` and the epilogue's derivative programs on ``ew_*``),
   the int32 1-D dot of 1M under ``vmap`` (``rd_axis``'s int32
   accumulator, one pass), a float16 ``Array.sum`` under ``grad``; launches
   counted, no plain-torch route, values held to plain torch's autograd;
6. times every kernel and its plain version with CUDA events (the
   reductions also in GB/s of the bytes each call must read once), and,
   as a yardstick the port never calls, the one PyTorch call that computes
   the same function where there is one (``torch.add``, ``torch.sum``,
   ``torch.dot``, ``torch.sum(dim)``, ``torch.matmul``, ``torch._int_mm``),
   and the recurrences once more on ``ew_strided``'s interpreter; the
   programs on generated kernels (the 16M chain, the distance, ``a * row -
   col``, the thresholded axis sums) beside their interpreters'
   (``elementwise.interpret``, ``reduction.interpret``) on the same inputs,
   with ptxas' registers and spills of each generated kernel.
   The 1M add is timed twice, kernel and ``torch.add`` alike: on the same
   three arrays again and again (12 MB: hot in the 50 MB L2, what a caller
   who adds the same arrays sees), and over a ring of operands and results
   past the L2, which is what the kernels line holds against the bound at
   the device-memory rate; and a chain of three instructions on 16M floats;
   the bfloat16, uint32 and ``//`` workloads of phase 5b the same way,
   the 2-byte quad paths beside their element paths (the same values 2
   bytes off), the 16M bfloat16 add, the bfloat16 axis-0 sum and the
   float16 sum beside ``torch.add``/``torch.sum``;
7. the matmul path: holds the matmul kernel against its plain version on
   the card (f32, bf16, int8/uint8 and a wrapping int32; the ragged
   (300, 270) @ (270, 515); a transposed and a negative-step view operand;
   rank 3; epilogues with a (1, N) row, an (M, 1) column, a full and a 0-d
   extra; bf16 output; the dequantizing epilogue with a scalar and a
   per-channel scale; f32 within 2e-5 * (|A| @ |B|) elementwise of the
   plain version and of float64, integers exact, a bf16 result the f32
   result rounded once, every result bit-identical across two launches);
   for bf16 @ bf16, which runs wgmma in the tensor-core kernel whatever its
   shape or strides (``matmul.VARIANTS``): the four operand orders (each
   operand row-major or a transposed view) at (300, 270) @ (270, 515), read
   element by element and, cut from bases whose rows are multiples of 8,
   16 bytes at a time; an unaligned slice and a negative-step view whose
   results are bit-identical to those of their contiguous clones; K = 1
   and K = 2048 + 5; rank 3 with a per-batch extra and the fused epilogue
   stored as bf16 and as f32; the largest error is printed in units of the
   tolerance; mixed f32/bf16 and int32 products must not take that
   kernel); for int8/uint8 pairs, which run the 8-bit wgmma in the int8
   tensor-core kernel: the four signed/unsigned pairs with values above
   127, the four operand orders at (300, 270) @ (270, 515) copied or
   transposed 16 bytes at a time and byte by byte, K = 1 and K = 2048 + 5,
   a product of uint8 255s at K = 33,280 that wraps int32, rank 3, a view
   one byte off against its clone, and the dequantizing epilogue with a
   scalar and a per-channel scale: all exact against ``int_product``, the
   bits repeating; for the CUDA-core kernel (f32, mixed and int32 pairs):
   the four operand orders at (300, 270) @ (270, 515) on both staging
   paths (16-byte ``cp.async`` copies, element reads), negative-step,
   transposed and 4-bytes-off views, K = 1 and K = 2048 + 5 and rank 3,
   each the bits of its contiguous clone and, for f32, of the parent
   kernel's order (one chain of fused multiply-adds in ascending k),
   epilogues with every extra shape giving ``ew_strided``'s bits on the
   stored product; for the 64-bit kernel on the int8 tensor cores, int64/
   uint64 products exact against the CPU's int64 product, wrapping
   (all-ones at K = 40,000, ragged M and N, K = 1, rank 3, views, each
   mixed pair),
   then drives bench.py's matmul workloads through the public API at full
   width (the fused ``relu(x @ W + bias) * s - c`` at 2048^3 in f32 and
   bf16, ``sm.int8_matmul`` at 2048^3 with and without ``scale=``, the
   fused batched root at (8, 1024, 1024) bf16, an int32 ``sm.dot``; one
   launch per call and no elementwise pass; the bf16 workloads through
   the bf16 tensor-core kernel, ``sm.int8_matmul`` through the int8 one and
   the f32 and int32 ones through neither, by the variant counter; the
   fused batched root at (8, 1024, 1024) in f32 and an int64 ``sm.dot`` of
   full-range values through the CUDA-core kernel;
   ``sm.dot``/``sm.matmul`` of f32 and complex64 through ``torch.matmul``),
   and times them;
8. the solver stack (``simplemath_tpu_torch.models``, plain torch on the
   card; BASELINE.json configs 3-5): a cartpole ``solve_batched`` (64 x
   H=50, 5 iterations) on the card against the same call on the CPU, at
   the CPU tests' tolerance against the JAX package; the pendulum solve in
   float32 on the card against float64 on the CPU (controls within
   ``rtol=0.05, atol=0.05``); then, timed by CUDA-synchronized wall time
   after a one-iteration warm-up, the full-width workloads: cartpole
   ``solve_batched`` 8192 x H=100 and pendulum 4096 x H=50, 10 iterations
   each (the cartpole solve under sync debug mode ``"error"``, so a host
   round trip inside it fails the run; every cost finite, ``cost_trace``
   never rising, the final cost below the initial one), the cartpole
   iteration by stage and its Riccati step's torch ops and kernels, the
   quadrotor RTI tick at H=50 (the difference of a 20- and a 60-tick
   closed loop) beside the 1 ms budget, ``MPCController.replan`` (H=50, 2
   iterations), the port's ``entry()``, and a forward rollout of a
   pendulum written in the ``sm`` API, states (2, 4096), 50 steps, which
   must launch the elementwise kernels and take no plain-torch route, held
   to the plain torch rollout within 1e-5 and timed beside it; prints the
   ``solvers`` JSON line, with the card's name and power limit; and
   BASELINE.json config 2 as the north star writes it: the pendulum batch
   4096 x H=50 with dynamics and costs in the ``sm`` API
   (``models.make_sm_pendulum``) through ``solve_batched``, 10 iterations
   under sync debug mode ``"error"``, its ``sm`` ops under ``torch.func``
   on the kernels (ops/autodiff.py; launches counted, no plain-torch
   route), held to the native pendulum's solve of the same inputs (costs
   within rtol 1e-4, controls within rtol 1e-3 and 1e-4 x the largest) and
   timed beside it;
9. the parallel layer (``simplemath_tpu_torch.parallel``): solves the
   inputs unsharded here (which also caches the generated kernels that the
   ranks load), then starts this script's own ranks (``--rank``, one
   process a rank on the card): an NCCL world of one rank, which runs the
   cartpole ``solve_batched_sharded`` (8192 x H=100, 10 iterations) and
   the compiled programs of the parallel layer, captured as CUDA graphs
   that hold their NCCL collectives (``make_sharded_train_step`` of the
   cartpole and of the ``sm``-written pendulum, 4096 x H=50, its graphs
   holding ``ew_flat`` and ``ew_strided``; ``scenario_mpc_solve`` of the
   quadrotor, 1024 x H=50, 3 iterations), each against its eager loop
   (``graphs.eager()``) in rounds of eager, compiled, compiled, eager as
   phase 11 runs its workloads (the eager bits; every compiled call after
   the first, or for the scenario solve its step's replays, under sync
   debug mode ``"error"``; build seconds, pool MB, kernel launches and
   collectives recorded a replay, the card's busy share in one replay),
   the sharded solves held to the unsharded ones; and a
   gloo world of two ranks on the one card (NCCL takes one rank a device),
   which runs the same solve (4096 a rank), the horizon-sharded Riccati
   backward at H=100 (101 elements over 2 ranks: the padding path) against
   ``backward_associative`` (rtol 1e-5, atol 1e-6), the scenario-consensus
   MPC on the quadrotor (1024 scenarios, H=50, 3 iterations, eagerly:
   ``graphs.eager()``; the consensus ``u0`` equal on every scenario, the
   cost never rising; ms a consensus step; the compiled solve must refuse
   the gloo mesh with ``graphs.CaptureError``), the ``sm``-written
   pendulum sharded (4096 x H=50: ``ew_flat`` and ``ew_strided``
   launched in each rank, no plain-torch route) and the nine
   workloads of tests/test_kernels_sharded.py inside each rank, each on its
   kernel, against its plain version and followed by a collective; every
   sharded solve's costs and controls are held to the unsharded solve's
   (rtol 1e-5, atol 1e-6) and the psum total to their sum; no rank may
   rebuild the kernels; prints the ``parallel`` JSON line;
10. the utils (``simplemath_tpu_torch.utils``): each of the six kernel
   wrappers traced by ``utils.export`` at its main-path shape (the L = 16
   recurrence on ``ew_strided``, the 1M add on ``ew_flat``, the 64M sum on
   ``rd_full``, the thresholded axis-0 sum of (8192, 8192) on ``rd_axis``,
   the fused bf16 ``relu(x @ W + bias)`` at 2048^3 on ``mm`` and at (8, 1024,
   1024) on ``bmm``): the graph holds its ``sm::*`` op and nothing that
   computes besides, and the artifact, loaded in a process that imports
   torch and the port alone, launches that kernel once a call and gives
   the live call's bits; ``export_solver_step`` of the cartpole at 8192 x
   H=100 (BASELINE config 3) and of the ``sm``-written pendulum at 4096 x
   H=50 (config 2), ``ILQRConfig()``'s 10 iterations each: two programs
   (the initial rollout, one iteration) whose horizon loops are ``scan``
   nodes, loaded and served as CUDA graphs (the iteration's replayed once
   an iteration), with ``solve_batched_jit``'s bits, in rounds of served,
   compiled, compiled, served (every served call after the first under sync
   debug mode ``"error"``); export s, nodes of each program, MB, load s,
   the first call's s (warm-up, capture, instantiate), the launches its
   graphs recorded (the ``sm`` pendulum's ``ew_flat`` and ``ew_strided``),
   one profiled replay of each graph, served and compiled solves/s; the
   whole ``solve_batched`` of the ``sm`` pendulum (4096 x H=50, 3
   iterations; the JAX package's ``export_solver_step`` form) exported as
   one program, its iteration and horizon loops nested ``scan`` nodes,
   loaded and called by the same process as the kernels' artifacts (nodes
   at every level, export s, load s, a call's s, its ``ew_flat`` and
   ``ew_strided`` launches), with the eager call's bits (config 4's SQP-MPC
   exported whole is ``tools/probe_torch_export.py``'s ``constrained``);
   ``run_elastic`` over a receding-horizon cartpole loop at 8192 x H=100
   (one iteration and a shift a step, a checkpoint every 2 steps) with an
   injected preemption and a transient corruption, bitwise the plain
   loop's final state, checkpoint save and restore ms; ``benchmark`` of the
   1M add (``bytes_moved=12e6``, roofline fraction at most 1.05), ``trace``
   of one cartpole iteration (CUDA kernels in the Chrome trace),
   ``MetricsLogger.log_ilqr_result`` of card tensors, ``nan_guard`` on a
   card NaN, ``interpret_kernels()`` (no launch, the recurrence within 2 ulp
   of the kernel's); then each example twin (``examples/torch_*.py``) at
   its default size; prints the ``utils`` JSON line.  Every phase runs
   alone on the host: nothing of one overlaps the times of another;
11. the compiled entry points (utils/graphs.py), each captured as CUDA
   graphs at its first call and replayed: ``solve_batched_jit`` of the
   cartpole (8192 x H=100), the pendulum and the ``sm``-written pendulum
   (4096 x H=50), 10 iterations each, against ``solve_batched``;
   ``MPCController.replan`` (quadrotor, H=50, 2 iterations, two replans a
   call), the RTI closed loop (quadrotor, H=50, 20 and 60 ticks: their
   difference times a tick) and ``entry()``'s step against their eager
   body loops (``graphs.eager()``); in rounds of eager, compiled,
   compiled, eager on the same inputs, every compiled result the eager
   bits and every compiled call after the first under sync debug mode
   ``"error"``; for each, the build's seconds (warm-up, capture,
   instantiation), the graphs' pool MB, the kernels' launches a replay
   (recorded at capture: the ``sm`` pendulum's graphs must hold ``ew_flat``
   and ``ew_strided``), the card's busy share in one profiled replay of
   the body's graph; then the six kernel wrappers, each captured once at its
   main-path shape, their replays the eager bits; prints the ``compiled``
   JSON line;
12. ``psd="eigh"`` inside the compiled programs (``psd_phase``): the Jacobi
   PSD projection's kernel (csrc/psd_project.cu) against its plain version
   at the solvers' shapes (819,200 matrices of 5 x 5 and 8,192 of 4 x 4,
   the cartpole at 8192 x H=100; 50 of 16 x 16 and one of 12 x 12, the
   quadrotor at H=50; random symmetric indefinite matrices from the seed,
   then asymmetric, degenerate, NaN and inf ones): the plain version's bits
   and within 8 n eps ||S||_F of float64 ``torch.linalg.eigh``'s
   projection, timed beside the plain version and the library's route
   (eager ``torch.linalg.eigh`` and the reconstruction), with the bound of
   the function (``psd_ops``) and the sweeps this data took; the coupled cartpole (``CROSS`` and ``CONCAVE``: an x-u
   cross term and a concave term, ``separable_cost=False``) through
   ``solve_batched_jit`` at 8192 x H=100, 10 iterations, against its eager
   loop (bits) and phase 11's clamp-diag cartpole, its costs never rising,
   the share of its joint blocks the projection moved, 64 of its scenarios
   solved again on the CPU (costs within rtol 1e-4, controls within rtol
   1e-3 and 1e-4 x the largest); the coupled quadrotor's ``replan`` (H=50,
   2 iterations) and RTI tick (H=50, 20 and 60 ticks) against their eager
   loops; every graph holding the projection's launches; prints the
   ``psd`` JSON line (the served solve, the sharded train step and the
   scenario step of the coupled systems run in tools/time_torch_psd.py);
13. prints the ``generated`` JSON line (``codegen.STATS``, NVRTC's
   milliseconds and the new signatures by kind, a phase at a time, and the
   signatures phases 8-11 generate) and the kernels' JSON line (each
   kernel's launches on the main path,
   its error, its time beside the plain version's, the library call's and
   its bound on this card, and the bound's share of the time, which cannot
   read above 1; ``rd_full`` as the 64M sum and ``rd_full_dot`` as the dot
   beside it; ``ew_strided`` as the L = 400 recurrence on its generated
   kernel, the interpreter's time beside it; ``mm`` and ``bmm`` with their
   bf16 times, ``mm_int8``, ``mm_f32``, ``bmm_f32``, ``mm_int32`` and
   ``mm_int64`` beside them; ``ew_flat_bf16``, ``ew_flat_uint32``,
   ``ew_flat_idiv``, ``ew_strided_bf16``, ``rd_full_bf16``, ``rd_axis_bf16``
   and ``rd_full_f16`` as phase 5b's workloads; ``ew_flat_generated``,
   ``rd_full_generated``, ``rd_full_rows_generated`` and
   ``rd_axis_generated``, the generated routes, as phase 6's programs on
   them, their interpreters' times beside), then
   ``{"ok": true, "device": ...}``.

Exits non-zero, with no result line, when any phase fails or no CUDA device
is visible.
"""

import json
import os
import statistics
import subprocess
import sys
import threading
import time

import numpy as np

N_ADD = 1_000_000
N_FUSED = 2048
N_RAGGED = 4096 * 3 + 777
N_SUM = 64 * 1024 * 1024   # bench.py::bench_reduce_sum
N_DOT = 32 * 1024 * 1024   # bench.py::bench_dot1d, bench_fused_map_reduce
N_AXIS = 8192              # bench.py::bench_reduce_axis
RAGGED_AXIS = (517, 1030)  # rd_axis's path checks: no multiple of 4, 32 or the segment
SEED = 0
SOURCE = "simplemath_tpu_torch/csrc/elementwise.cu"
RD_SOURCE = "simplemath_tpu_torch/csrc/reduction.cu"
RD_OTHER_SOURCES = ["simplemath_tpu_torch/csrc/reduction.cuh",
                    "simplemath_tpu_torch/csrc/reduction_full.cu",
                    "simplemath_tpu_torch/csrc/reduction_cols.cu",
                    "simplemath_tpu_torch/csrc/reduction_rows.cu"]
MM_SOURCE = "simplemath_tpu_torch/csrc/matmul.cu"
MM_OTHER_SOURCES = ["simplemath_tpu_torch/csrc/matmul_fma.cuh",
                    "simplemath_tpu_torch/csrc/matmul_elem.cu"]
WGMMA_SOURCE = "simplemath_tpu_torch/csrc/matmul_wgmma.cu"
CODEGEN_SOURCE = "simplemath_tpu_torch/ops/codegen.py"
NVRTC_SOURCE = "simplemath_tpu_torch/csrc/nvrtc.cu"
MM_GENERATED_SOURCES = ["simplemath_tpu_torch/csrc/matmul_wgmma.cuh",
                        "simplemath_tpu_torch/csrc/matmul_wgmma_s8.cuh",
                        "simplemath_tpu_torch/csrc/matmul_fma.cuh",
                        "simplemath_tpu_torch/csrc/matmul.cuh", NVRTC_SOURCE]
RD_GENERATED_SOURCES = ["simplemath_tpu_torch/csrc/reduction.cuh",
                        "simplemath_tpu_torch/csrc/reduction.cu", NVRTC_SOURCE]
WGMMA_S8_SOURCE = "simplemath_tpu_torch/csrc/matmul_wgmma_s8.cu"
WGMMA_I64_SOURCE = "simplemath_tpu_torch/csrc/matmul_wgmma_i64.cu"
N_CHAIN = 16 * 1024 * 1024  # the flat chain a * b + c - a: 256 MB moved
ADD_RING = 16               # sets of (a, b, result) of the 1M add: 192 MB
N_MM = 2048                # bench.py::bench_matmul, _epilogue, bench_int8_matmul
BMM = (8, 1024, 1024)      # bench.py::bench_bmm
N_INT_DOT = 512
# The solver workloads of BASELINE.json configs 3-5 (bench.py::bench_pendulum,
# bench_cartpole, bench_quadrotor_replan), at full width.
CARTPOLE = (8192, 100)     # scenarios, horizon
PENDULUM = (4096, 50)
SOLVE_ITERS = 10
QUAD_H = 50
RTI_TICKS = (20, 60)       # two closed-loop lengths; their difference times a tick
SM_ROLLOUT = (4096, 50)    # the sm-expressed pendulum: states (2, 4096), 50 steps

# Published peaks of one H100 SXM at its full 700 W (NVIDIA's data sheet):
# the bound of a kernel is the larger of its bytes over the memory rate and
# its operations over the rate for their type.
PEAK_BYTES = 3.35e12
PEAK_OPS = {"f32": 67e12, "bf16": 989e12, "int8": 1979e12}
# Integer multiply-adds on the CUDA cores, which the data sheet does not
# list: the arithmetic throughput table of NVIDIA's CUDA C++ documentation
# gives compute capability 9.0 64 results of a 32-bit integer multiply-add
# (and of a 32-bit add) a clock an SM, half its 128 float32 ones, so at the
# clock of the f32 peak above int32 multiply-adds run at half of it.  (A
# 64-bit product is counted as its 36 byte-limb products on the int8 tensor
# cores: csrc/matmul_wgmma_i64.cu.)
PEAK_OPS["int32"] = PEAK_OPS["f32"] / 2
# Float operations of one crafted transcendental (counted in
# csrc/tiles.cuh); every other opcode counts as one.
CRAFTED_OPS = {"exp": 24, "pow": 55}


def bound(nbytes, ops, kind="f32"):
    """(bound_ms, bound_by): the least time the card could take."""
    t_bytes, t_ops = nbytes / PEAK_BYTES, ops / PEAK_OPS[kind]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


# Integer operations of one rounding to bfloat16 in a register (sm_bf16r in
# csrc/tiles.cuh): the NaN test, the tie bias, the add and the mask.
ROUND_OPS = 4


def program_ops(prog, program):
    """(float operations, rounding operations) per element and pass of
    ``prog``: each instruction once, exp and pow as CRAFTED_OPS, a copy of
    bits (BITS) as none; ROUND_OPS for each result rounded to bfloat16."""
    crafted = {"EXP_F": CRAFTED_OPS["exp"], "POW_F": CRAFTED_OPS["pow"], "BITS": 0}
    f_ops = sum(crafted.get(program.OPCODES[c], 1) for c in prog.kernel_codes)
    return f_ops, ROUND_OPS * sum(prog.kernel_rounds)


def bound_mixed(nbytes, float_ops, int_ops):
    """``bound`` of work with float32 and int32 operations, each at its own
    rate, one after the other."""
    t_bytes = nbytes / PEAK_BYTES
    t_ops = float_ops / PEAK_OPS["f32"] + int_ops / PEAK_OPS["int32"]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def log(msg):
    print(msg, flush=True)


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def max_ulp(got, want):
    """Largest distance in float32 ulps of ``want`` (NaN == NaN)."""
    g = got.detach().float().cpu().numpy().astype(np.float64)
    w = want.detach().float().cpu().numpy().astype(np.float64)
    same = (g == w) | (np.isnan(g) & np.isnan(w))
    sp = np.spacing(np.abs(w).astype(np.float32)).astype(np.float64)
    with np.errstate(invalid="ignore"):
        d = np.where(same, 0.0, np.abs(g - w) / sp)
    return float(np.nan_to_num(d, nan=np.inf).max(initial=0.0))


def ulp_vs_f64(got, want64):
    g = got.detach().cpu().numpy().astype(np.float64)
    sp = np.spacing(np.abs(want64).astype(np.float32)).astype(np.float64)
    return float(np.max(np.abs(g - want64) / sp))


def bits(t):
    """``t``'s bits as a signed integer tensor of its width (torch has few
    uint32 ops on the card)."""
    import torch

    if t.dtype == torch.bool:
        return t
    return t.view({4: torch.int32, 2: torch.int16, 1: torch.int8}[t.element_size()])


def exact(got, want):
    if got.dtype.is_floating_point:
        return max_ulp(got, want) == 0.0
    return bool((bits(got) == bits(want)).all())


def max_bf16_ulp(got, want):
    """Largest distance in bfloat16 ulps (NaN == NaN)."""
    g = got.detach().double().cpu().numpy()
    w = want.detach().double().cpu().numpy()
    same = (g == w) | (np.isnan(g) & np.isnan(w))
    spacing = np.maximum(np.abs(w), 2.0 ** -126) * 2.0 ** -7
    with np.errstate(invalid="ignore"):
        d = np.where(same, 0.0, np.abs(g - w) / spacing)
    return float(np.nan_to_num(d, nan=np.inf).max(initial=0.0))


def time_ms(fn, n=1, reps=5):
    """Device time of one call of ``fn`` by CUDA events: the median over
    ``reps`` samples, each a run of ``n`` back-to-back calls divided by
    ``n``.  A spin kernel queued first holds the card while the host
    enqueues the run, so the events time the device work alone, not the
    host's Python."""
    import torch

    def run():
        for _ in range(n):
            fn()

    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    cycles = int(min(2.0 * host_s + 1e-3, 5.0) * 2e9)
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        run()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / n)
    return statistics.median(times)


def host_ms(fn, reps=5):
    """Median wall time of one call that ends in a synchronize."""
    import torch

    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(out)


def same_bits(a, b):
    import torch

    return torch.equal(a.reshape(-1).view(torch.int32), b.reshape(-1).view(torch.int32))


def two_bytes_off(t):
    """A contiguous copy of the 2-byte tensor ``t`` 2 bytes past a 16-byte
    boundary: the same values on the element path."""
    import torch

    buf = torch.empty(t.numel() + 16, dtype=t.dtype, device=t.device)
    at = (-buf.data_ptr() // 2) % 8 + 1
    return buf[at:at + t.numel()].view(t.shape).copy_(t)


def times_one(shape):
    """The program x * 1.0: the identity's value through one instruction."""
    import torch
    from simplemath_tpu_torch.ops import program

    leaf = program.leaf(shape, torch.float32)
    return program.lower(leaf * 1.0, [leaf])


def times_one_plus_zero(shape):
    """The program x * 1.0 + 0.0: the identity's value (but -0.0 gives +0.0)
    through the interpreter."""
    import torch
    from simplemath_tpu_torch.ops import program

    leaf = program.leaf(shape, torch.float32)
    return program.lower(leaf * 1.0 + 0.0, [leaf])


def on_both_kernels(elementwise, prog, shape, operands, iterations=1, carry=0):
    """The program on ew_strided's two kernels, the interpreter and the
    generated one, each launch on the kernel ``elementwise.PATHS`` must
    name; the generated result, which must be the interpreter's bit for
    bit."""
    import torch

    outs = []
    for name, run in (("interp", elementwise.interpret),
                      ("generated", lambda prog, shape, *ops, **kw: elementwise.elementwise(
                          prog, shape, prog.dtype, *ops, name="check", **kw))):
        before = dict(elementwise.PATHS)
        outs.append(run(prog, shape, *operands, iterations=iterations, carry=carry))
        took = {k: v - before[k] for k, v in elementwise.PATHS.items() if v != before[k]}
        check(took == {name: 1}, f"a strided launch meant for {name} took {took}")
    torch.cuda.synchronize()
    k, g = outs
    check(k.dtype == g.dtype and torch.equal(bits(k), bits(g)),
          "the generated kernel differs from the interpreter")
    return g


def bf16_chain_checks(dev, rng, sm, elementwise):
    """Phase 3c: a bfloat16 chain recorded by the lazy queue (one program,
    one launch) gives the bits of the same ops launched one by one, on
    ew_flat and on ew_strided's generated kernel (transposed operands): the
    kernels round every bfloat16 result, as torch's ops do."""
    import torch

    x, y, z = (torch.from_numpy(rng.standard_normal((512, 768)).astype(np.float32)).to(dev)
               .bfloat16() for _ in range(3))

    def chain(a, b, c):
        return (a + b) * c - a / (b * b + 1.0)

    for label, arrays in (("ew_flat", [sm.Array(t) for t in (x, y, z)]),
                          ("ew_strided", [sm.Array(t).T for t in (x, y, z)])):
        elementwise.reset_launches()
        lazy = chain(*arrays).torch()
        torch.cuda.synchronize()
        launched = dict(elementwise.LAUNCHES)
        check(launched[label] == 1 and sum(launched.values()) == 1,
              f"the bfloat16 chain on {label} launched {launched}")
        old = sm.config.deferred_eager
        sm.configure(deferred_eager=False)
        try:
            eager = chain(*arrays).torch()
        finally:
            sm.configure(deferred_eager=old)
        check(lazy.dtype == torch.bfloat16 and torch.equal(bits(lazy), bits(eager)),
              f"the bfloat16 chain on {label} is not its ops' bits")
    log("check a bfloat16 chain (a+b)*c - a/(b*b+1): one launch of ew_flat and of ew_strided's "
        "generated kernel, the bits of its four ops launched one by one")


def generated_checks(dev, rng, sm, elementwise, program):
    """Phase 3b: ew_strided's generated kernels against its interpreter,
    bit for bit, and against the plain version: ranks 1 to 8 with a
    broadcast (stride 0) and a negative-step operand, a carry over 1 and 16
    iterations, a program of MAX_INSTS instructions.  (Every opcode on
    float32, int32 and bool is held in phase 3's opcode loop.)"""
    import torch

    for rank in range(1, 9):
        shape = tuple(int(d) for d in rng.integers(1, 4, rank - 1)) + (37,)
        base = torch.from_numpy(rng.standard_normal(tuple(2 * d for d in shape)).astype(np.float32)).to(dev)
        steps = tuple(2 * st for st in base.stride())
        view = elementwise.View(base, (shape[-1] - 1) * steps[-1], shape, steps[:-1] + (-steps[-1],))
        row = torch.from_numpy(rng.standard_normal((1,) * (rank - 1) + (37,)).astype(np.float32)).to(dev)
        full = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)
        ls = [program.leaf(shape, torch.float32), program.leaf(row.shape, torch.float32),
              program.leaf(shape, torch.float32)]
        prog = program.lower(sm.maximum(ls[0] * ls[1] - ls[2], 0.25) + sm.exp(ls[1] * 0.5), ls)
        g = on_both_kernels(elementwise, prog, shape, [view, row, full])
        p = program.run_plain(prog, [elementwise.read(view), row, full], shape)
        check(max_ulp(g, p) <= 2.0, f"rank {rank}: the generated kernel is off the plain version")
    log("check ew_strided generated = interpreter, ranks 1-8, a broadcast row and a "
        "negative-step operand: bits equal, within 2 ulp of plain")

    shape = (256, 520)
    acc = torch.zeros(shape, device=dev)
    a = torch.from_numpy(rng.uniform(0.5, 2.0, shape).astype(np.float32)).to(dev)
    e = torch.from_numpy(rng.uniform(-2.0, 2.0, (1, 520)).astype(np.float32)).to(dev)
    ls = [program.leaf(shape, torch.float32), program.leaf(shape, torch.float32),
          program.leaf((1, 520), torch.float32)]
    prog = program.lower(ls[0] * np.float32(1e-3)
                         + sm.exp(sm.pow(ls[1] + ls[0] * np.float32(1e-6), ls[2])), ls)
    for L in (1, 16):
        g = on_both_kernels(elementwise, prog, shape, [acc, a, e], L, 0)
        check(max_ulp(g, program.run_plain(prog, [acc, a, e], shape, L, 0)) <= 2.0,
              f"carry L={L}: the generated kernel is off the plain version")
    check(bool((acc == 0).all()), "the carry wrote into its operand")
    log("check ew_strided generated = interpreter, the recurrence with a carry at L = 1 and 16")

    x, y = program.leaf((77, 50), torch.float32), program.leaf((1, 50), torch.float32)
    root = x
    while len(program.lower(root * y + 0.5, [x, y]).insts) <= program.MAX_INSTS:
        root = root * y + 0.5
    prog = program.lower(root, [x, y])
    check(len(prog.insts) >= program.MAX_INSTS - 1, "the long program is short")
    xs = torch.from_numpy(rng.uniform(-1, 1, (77, 50)).astype(np.float32)).to(dev)
    ys = torch.from_numpy(rng.uniform(-1, 1, (1, 50)).astype(np.float32)).to(dev)
    g = on_both_kernels(elementwise, prog, (77, 50), [xs.T.contiguous().T, ys])
    check(max_ulp(g, program.run_plain(prog, [xs, ys], (77, 50))) == 0.0,
          "the long program is off the plain version")
    log(f"check ew_strided generated = interpreter, a program of {len(prog.insts)} instructions")


def generated_phase(state, phase):
    """The generated kernels of the phase that ends now (``state``: what
    the last call saw, filled by the first): codegen.STATS' counts, the
    milliseconds NVRTC took (on this thread and on compile_ahead's), the new
    signatures by kind, and the phase's wall seconds."""
    from simplemath_tpu_torch.ops import codegen

    now = (dict(codegen.STATS), len(codegen.COMPILE_MS), set(codegen.SEEN), time.perf_counter())
    if "last" in state:
        stats, n_ms, seen, t0 = state["last"]
        new = now[2] - seen
        state.setdefault("phases", {})[phase] = {
            **{k: codegen.STATS[k] - stats[k] for k in stats},
            "compile_ms": sum(codegen.COMPILE_MS[n_ms:]),
            "signatures": {kind: sum(1 for sig in new if sig.kind == kind)
                           for kind in ("strided", "flat", "reduce", "matmul")},
            "phase_s": now[3] - t0}
    state["last"] = now


N_FLAT_GEN = 4096 * 3 + 5  # ew_flat's generated kernel checks: quads and a tail of 1


def flat_generated_cases(dev, seed=0):
    """(label, program, shape, operands) of the checks of ew_flat's generated
    kernel: every opcode of the registry (and every cast) on float32, int32,
    uint32, bool and bfloat16 operands, each after a select (so that it is
    no one-instruction program: those run the compiled kernel; a cast of
    bools before it, since no opcode selects between bools), its second operand full-size
    and a scalar, every operand at a 16-byte boundary; the bfloat16 ones
    also 2 bytes off (no quads); and programs of MAX_INSTS instructions
    over a full-size and a scalar operand.  ``N_FLAT_GEN`` elements: a
    ragged tail."""
    import torch
    from simplemath_tpu_torch.ops import program, registry

    n = N_FLAT_GEN
    rng = np.random.default_rng(seed)

    def aligned(values, dtype):
        t = torch.from_numpy(np.ascontiguousarray(values)).to(dev).to(dtype)
        buf = torch.empty(n + 8, dtype=dtype, device=dev)
        at = (-buf.data_ptr() // buf.element_size()) % (16 // buf.element_size())
        return buf[at:at + n].copy_(t)

    special = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1e-40, 1.0, -1.0, 88.7, -103.9],
                       np.float32)
    f = np.concatenate([rng.uniform(-5, 5, n - special.size), special]).astype(np.float32)
    g = rng.uniform(-4, 4, n).astype(np.float32)
    ints = np.array([0, 1, -1, 2**31 - 1, -2**31, 7, -7, 46341, 65536], np.int64)
    i = np.concatenate([rng.integers(-100, 100, n - ints.size), ints])
    j = np.concatenate([rng.integers(-5, 31, n - ints.size), [0, 5, -3, 2, -1, 0, 31, 2, -5]])
    values = {
        torch.float32: (aligned(f, torch.float32), aligned(g, torch.float32)),
        torch.bfloat16: (aligned(f, torch.bfloat16), aligned(g, torch.bfloat16)),
        torch.int32: (aligned(i.astype(np.int32), torch.int32), aligned(j.astype(np.int32), torch.int32)),
        torch.uint32: (aligned(np.abs(i).astype(np.int32), torch.int32).view(torch.uint32),
                       aligned(np.abs(j).astype(np.int32), torch.int32).view(torch.uint32)),
        torch.bool: (aligned(f > 0, torch.bool), aligned(g > 0, torch.bool)),
    }
    mask = aligned(rng.standard_normal(n) > 0, torch.bool)
    cases = []

    def add(label, build, operands):
        leaves = [program.leaf(tuple(o.shape), o.dtype) for o in operands]
        cases.append((label, program.lower(build(*leaves), leaves), (n,), operands))

    ops = list(registry.registered_ops().items()) + list(registry.INTERNAL.items())
    for name, op in ops:
        for dt, (x, y) in values.items():
            if program.register_type(dt) not in op.opcodes:
                continue
            if dt == torch.bfloat16 and name in ("pow", "ipow"):
                continue  # the engine computes pow in float32 (pow_expr)

            def build(m, x, y, name=name, arity=op.arity, dt=dt):
                first = program.apply("where", m, x, y)
                args = [m, first, y] if name == "where" else [first, y, y][:arity]
                if name in ("pow", "ipow"):
                    return program.Node(name, args, dt, (n,))
                return program.apply(name, *args)

            add(f"{name} {dt}", build, [mask, x, y])
            if op.arity >= 2:
                add(f"{name} {dt}, scalar", build, [mask, x, y[:1].reshape(()).clone()])
            if dt == torch.bfloat16:
                add(f"{name} {dt}, 2 bytes off", build, [mask, two_bytes_off(x), y])
    casts = [(src, dst) for src, dst in program._CASTS if src != dst] + [
        (torch.bfloat16, torch.float32), (torch.float32, torch.bfloat16),
        (torch.int32, torch.bfloat16), (torch.bool, torch.bfloat16), (torch.bfloat16, torch.int32)]
    for src, dst in casts:
        x, y = values[src]
        if src.is_floating_point and dst not in (torch.float32, torch.bfloat16, torch.bool):
            x = torch.nan_to_num(x.float().clamp(0.0 if dst == torch.uint32 else -1e6, 1e6),
                                 nan=0.5).to(src)
            y = torch.nan_to_num(y.float().clamp(0.0, 1e6), nan=0.5).to(src)
        if src == torch.bool:  # no select of bools: the casts first
            def build(m, x, y, dst=dst):
                return program.apply("where", m, program.cast(x, dst), program.cast(y, dst))
        else:
            def build(m, x, y, dst=dst):
                return program.cast(program.apply("where", m, x, y), dst)
        add(f"cast {src}->{dst}", build, [mask, x, y])
    x, y = values[torch.float32]
    for label, second in (("full", y), ("scalar", y[:1].reshape(()).clone())):
        lx, ly = program.leaf((n,), torch.float32), program.leaf(tuple(second.shape), torch.float32)
        root = lx
        while len(program.lower(root * ly + 0.5, [lx, ly]).insts) <= program.MAX_INSTS:
            root = root * ly + 0.5
        cases.append((f"MAX_INSTS program, {label} operand", program.lower(root, [lx, ly]), (n,),
                      [torch.nan_to_num(x.clamp(-1, 1), nan=0.5), second]))
    return cases


def compile_ahead(sigs):
    """The kernels of ``sigs`` compiled into the disk cache, a thread a core
    (NVRTC runs without the GIL): the checks that launch them next load
    them from there."""
    from concurrent.futures import ThreadPoolExecutor

    from simplemath_tpu_torch.ops import codegen, elementwise

    lib = elementwise._library()
    with ThreadPoolExecutor(os.cpu_count() or 1) as pool:
        list(pool.map(lambda src: codegen._cubin(lib, src), {codegen.source(s) for s in sigs}))


def generated_signatures(dev):
    """The signatures of ``flat_generated_cases`` and
    ``reduction_generated_cases``: what ``compile_ahead`` compiles while the
    phases before their checks run."""
    from simplemath_tpu_torch.ops import elementwise, reduction

    flat = [elementwise.signature(prog, prog.kernel_codes, shape, operands, flat=True)
            for _, prog, shape, operands in flat_generated_cases(dev, SEED)]
    return flat + [reduction.signature(prog, prog.kernel_codes, reduction._OP[kind], shape,
                                       operands, axis)
                   for _, prog, kind, axis, shape, operands in reduction_generated_cases(dev, SEED)]


def flat_generated_checks(sm, elementwise, program, cases):
    """Phase 3d: ew_flat's generated kernel against the interpreter
    (``elementwise.interpret``), bit for bit, on ``flat_generated_cases``,
    each launch on the generated kernel.  Returns the number of cases."""
    import torch

    compile_ahead(elementwise.signature(prog, prog.kernel_codes, shape, operands, flat=True)
                  for _, prog, shape, operands in cases)
    for label, prog, shape, operands in cases:
        check(not elementwise.single(prog), f"{label}: a one-instruction program")
        before = dict(elementwise.FLAT_PATHS)
        g = elementwise.elementwise(prog, shape, prog.dtype, *operands, name="check")
        took = {k: v - before[k] for k, v in elementwise.FLAT_PATHS.items() if v != before[k]}
        check(took == {"generated": 1}, f"{label}: ew_flat took {took}")
        i = elementwise.interpret(prog, shape, *operands)
        torch.cuda.synchronize()
        check(g.dtype == i.dtype and torch.equal(bits(g), bits(i)),
              f"{label}: ew_flat's generated kernel differs from the interpreter")
    return len(cases)


def reduction_generated_cases(dev, seed=0):
    """(label, program, kind, axis, shape, operands) of the checks of the
    generated evaluators, every walk (``flat``, ``rows``, ``strided``, the
    gathered flat walk, axis 0 and axis 1, quads and gathered), sum, max and
    min, in float32, bfloat16 and float16 (its programs are the identity,
    which runs a generated evaluator where its elements are gathered), at
    ragged sizes."""
    import torch
    import simplemath_tpu_torch as sm
    from simplemath_tpu_torch.ops import elementwise, program

    rng = np.random.default_rng(seed)
    n, (R, C) = 4096 * 3 + 777, (RAGGED_AXIS[0], 1032)

    def aligned(*shape, dtype=torch.float32):
        vals = rng.standard_normal(shape).astype(np.float32)
        vals.flat[::97] = rng.uniform(-1e-3, 1e-3, vals.flat[::97].size)
        t = torch.from_numpy(vals).to(dev).to(dtype)
        buf = torch.empty(t.numel() + 8, dtype=dtype, device=dev)
        at = (-buf.data_ptr() // buf.element_size()) % (16 // buf.element_size())
        return buf[at:at + t.numel()].view(shape).copy_(t)

    def lowered(fn, *operands):
        leaves = [program.leaf(tuple(o.shape), o.dtype) for o in operands]
        return program.lower(fn(*leaves), leaves)

    cases = []
    for dt in (torch.float32, torch.bfloat16, torch.float16):
        a, b = aligned(n, dtype=dt), aligned(n, dtype=dt)
        m = aligned(R, C, dtype=dt)
        row, col, one = aligned(1, C, dtype=dt), aligned(R, 1, dtype=dt), aligned(1, 1, dtype=dt)
        mt = elementwise.View(m, 0, (C, R), (1, C))  # transposed: gathered through its strides
        a_off = two_bytes_off(a) if dt != torch.float32 else elementwise.View(
            aligned(n + 1, dtype=dt), 1, (n,), (1,))
        m_off = two_bytes_off(m) if dt != torch.float32 else elementwise.View(
            aligned(R * C + 1, dtype=dt), 1, (R, C), (C, 1))
        if dt == torch.float16:
            ident = lambda x: x  # noqa: E731
            progs = [("identity", ident, [a_off], None, (n,)),
                     ("identity transposed", ident, [mt], None, (C, R))]
            progs += [(f"identity axis {ax} 2 bytes off", ident, [m_off], ax, (R, C)) for ax in (0, 1)]
            progs += [(f"identity transposed axis {ax}", ident, [mt], ax, (C, R)) for ax in (0, 1)]
        else:
            dist = lambda x, y, e: sm.square(x + e - y)  # noqa: E731
            fused = lambda x, r, c: x * r - c  # noqa: E731
            thr = lambda x, s: sm.where(x > s, x, 0.0)  # noqa: E731
            chain = lambda x: x * x + x  # noqa: E731
            progs = [("distance", dist, [a, b, one.reshape(())], None, (n,)),
                     ("x*x+x", chain, [a], None, (n,)),
                     ("distance, gathered", dist, [a_off, b, one.reshape(())], None, (n,)),
                     ("m*row-col rows", fused, [m, row, col], None, (R, C)),
                     ("m*row-col strided", fused, [mt, aligned(1, R, dtype=dt),
                                                   aligned(C, 1, dtype=dt)], None, (C, R)),
                     ("identity gathered", lambda x: x, [a_off], None, (n,))]
            for ax in (0, 1):
                progs += [(f"thresholded axis {ax}", thr, [m, one], ax, (R, C)),
                          (f"m*row-col axis {ax}", fused, [m, row, col], ax, (R, C)),
                          (f"thresholded axis {ax}, gathered", thr, [m_off, one], ax, (R, C)),
                          (f"m*row-col transposed axis {ax}", fused,
                           [mt, aligned(1, R, dtype=dt), aligned(C, 1, dtype=dt)], ax, (C, R))]
        for label, fn, operands, axis, shape in progs:
            prog = lowered(fn, *operands)
            for kind in ("sum", "max", "min"):
                cases.append((f"{dt} {label} {kind}", prog, kind, axis, shape, operands))
    return cases


def reduction_generated_checks(reduction, cases):
    """Phase 5d: the generated evaluators against ``reduction.interpret``,
    bit for bit, on ``reduction_generated_cases``, every launch on the
    route ``generated``, every walk and gathered walk among them.  Returns
    the walks seen."""
    import torch

    compile_ahead(reduction.signature(prog, prog.kernel_codes, reduction._OP[kind], shape,
                                      operands, axis)
                  for _, prog, kind, axis, shape, operands in cases)
    walks = set()
    for label, prog, kind, axis, shape, operands in cases:
        before = dict(reduction.PATHS)
        if axis is None:
            g = reduction.map_reduce(prog, kind, shape, *operands)
        else:
            g = reduction.map_reduce_axis(prog, kind, axis, shape, *operands)
        took = {k: v - before[k] for k, v in reduction.PATHS.items() if v != before[k]}
        check(took == {"generated": 1}, f"{label}: took {took}")
        i = reduction.interpret(prog, kind, axis, shape, operands)
        torch.cuda.synchronize()
        check(torch.equal(bits(g), bits(i)), f"{label}: the generated evaluator differs from the "
              "interpreter")
        walks.add(reduction.walk(shape, reduction.layout(operands), axis))
    want = {("flat", False), ("rows", False), ("flat", True), ("strided", True), ("axis0", False),
            ("axis0", True), ("axis1", False), ("axis1", True)}
    check(walks == want, f"the generated evaluator checks ran the walks {sorted(walks)}")
    return walks


def reduction_checks(dev, rng, sm, elementwise, program, reduction):
    """Phase 5a: the map-reduce kernel against its plain version on the card.
    Returns the largest |kernel - plain| of each entry point."""
    import torch

    err = {"rd_full": 0.0, "rd_axis": 0.0}

    def twice(fn):
        k1, k2 = fn(), fn()
        torch.cuda.synchronize()
        check(same_bits(k1, k2), "a reduction differs between two launches")
        return k1

    def on_path(path, fn):
        """``fn()``, launched twice with the same bits, both on ``path``."""
        before = dict(reduction.PATHS)
        k = twice(fn)
        took = {p: c - before[p] for p, c in reduction.PATHS.items() if c != before[p]}
        check(took == {path: 2}, f"expected two launches on path {path}, counted {took}")
        return k

    def agree(entry, label, k, p, ref64, absx, exact_kind):
        k64 = k.double().cpu().numpy()
        p64 = p.double().cpu().numpy()
        if exact_kind:
            check(np.array_equal(k64, p64, equal_nan=True), f"{label}: kernel != plain")
            check(np.array_equal(k64, ref64, equal_nan=True), f"{label}: kernel != numpy")
        else:
            tol = 2e-5 * absx
            check(np.all(np.abs(k64 - p64) <= tol), f"{label}: kernel vs plain beyond 2e-5*sum|x|")
            check(np.all(np.abs(k64 - ref64) <= tol), f"{label}: kernel vs float64 beyond 2e-5*sum|x|")
        d = np.abs(k64 - p64)
        err[entry] = max(err[entry], float(np.nan_to_num(d, nan=0.0).max(initial=0.0)))

    def full(label, x_np, x, kinds=("sum", "max", "min")):
        t = elementwise.read(x)
        x64 = x_np.astype(np.float64)
        whole = isinstance(x, torch.Tensor)  # contiguous, at a 16-byte boundary
        for kind in kinds:
            k = on_path("direct" if whole else "generated", lambda: reduction.reduce(x, kind))
            p = reduction._plain(t, kind)
            ref = {"sum": x64.sum, "max": x64.max, "min": x64.min}[kind]()
            agree("rd_full", f"{label} {kind}", k, p, ref, float(np.abs(x64).sum()), kind != "sum")
            if whole:
                # The identity's direct path, the hoisted loop (x * 1.0 as a
                # sum) and the interpreter combine in one order: the same bits.
                shape = tuple(x.shape)
                k1 = on_path("single" if kind == "sum" else "generated",
                             lambda: reduction.map_reduce(times_one(shape), kind, shape, x))
                check(same_bits(k, k1), f"{label} {kind}: direct path != one instruction")
                k2 = on_path("generated", lambda: reduction.map_reduce(times_one_plus_zero(shape), kind, shape, x))
                check(same_bits(k, k2), f"{label} {kind}: direct path != interpreter path")
        log(f"check rd_full {label}: sum within 2e-5*sum|x|, max/min exact, bits repeat, "
            + ("direct = single = generated" if whole else "generated, gathered"))

    def on(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    v = rng.standard_normal(N_RAGGED).astype(np.float32)
    full(f"ragged n={N_RAGGED}", v, on(v))
    m_np = rng.standard_normal((N_AXIS, N_AXIS)).astype(np.float32)
    m = on(m_np)
    full(f"({N_AXIS},{N_AXIS})", m_np, m)
    arr = sm.Array(m)
    full("transposed view", m_np.T, arr.T._operand())
    full("negative-step view", m_np[::-1, ::-2], arr[::-1, ::-2]._operand())
    # A view one element off is gathered element by element and gives the
    # bits of its contiguous clone.
    longer = on(np.concatenate([np.zeros(1, np.float32), v]))
    shifted = elementwise.View(longer, 1, (N_RAGGED,), (1,))
    for kind in ("sum", "max", "min"):
        k = on_path("generated", lambda: reduction.reduce(shifted, kind))
        check(same_bits(k, reduction.reduce(on(v), kind)), f"{kind}: a view one element off != its clone")
    log(f"check rd_full view one element off, n={N_RAGGED}: gathered, the clone's bits")
    vn = v.copy()
    vn[N_RAGGED - 1] = np.nan
    for kind in ("max", "min", "sum"):
        check(bool(torch.isnan(twice(lambda: reduction.reduce(on(vn), kind)))),
              f"{kind} drops a NaN")
    log("check rd_full NaN: max/min/sum give NaN")

    def dot(label, a_np, b_np, exact_int, path):
        a, b = on(a_np), on(b_np)
        k = on_path(path, lambda: reduction.dot1d(a, b))
        la, lb = program.leaf(a.shape, a.dtype), program.leaf(b.shape, b.dtype)
        prog = program.lower(program.apply("multiply", la, lb), [la, lb])
        vals = program.run_plain(prog, [a, b], tuple(a.shape))
        if exact_int:
            p = reduction._plain_sum_i32(vals)
            ref = int((a_np.astype(np.int64) * b_np.astype(np.int64)).sum()) % (1 << 32)
            ref = ref - (1 << 32) if ref >= 1 << 31 else ref
            check(k.dtype == torch.int32 and int(k) == int(p) == ref, f"{label}: {int(k)} != {ref}")
        else:
            p = reduction._plain(vals, "sum")
            prod = a_np.astype(np.float64) * b_np.astype(np.float64)
            agree("rd_full", label, k, p, prod.sum(), float(np.abs(prod).sum()), False)
        log(f"check rd_full dot {label}: {'exact' if exact_int else 'within 2e-5*sum|ab|'}, "
            f"bits repeat, path {path}")

    a_np = rng.standard_normal(N_RAGGED).astype(np.float32)
    i_np = rng.integers(-1000, 1000, N_RAGGED).astype(np.int32)
    j_np = rng.integers(-1000, 1000, N_RAGGED).astype(np.int32)
    dot("f32.f32", a_np, v, False, "single")
    dot("int32", i_np, j_np, True, "single")
    dot("int32 wraparound", np.full(70_000, 40_000, np.int32), np.full(70_000, 40_000, np.int32),
        True, "single")
    dot("f32.int32", a_np, i_np, False, "generated")

    row_np = rng.standard_normal((1, N_AXIS)).astype(np.float32)
    col_np = rng.standard_normal((N_AXIS, 1)).astype(np.float32)
    row, col = on(row_np), on(col_np)
    shape = (N_AXIS, N_AXIS)
    leaves = [program.leaf(shape, torch.float32), program.leaf((1, N_AXIS), torch.float32),
              program.leaf((N_AXIS, 1), torch.float32)]
    prog = program.lower(leaves[0] * leaves[1] - leaves[2], leaves)
    vals = program.run_plain(prog, [m, row, col], shape)
    w64 = (m_np * row_np - col_np).astype(np.float64)  # f32 ops, each rounded, as the kernel's
    for kind in ("sum", "max", "min"):
        k = on_path("generated", lambda: reduction.map_reduce(prog, kind, shape, m, row, col))
        ref = {"sum": w64.sum, "max": w64.max, "min": w64.min}[kind]()
        agree("rd_full", f"map-reduce {kind}", k, reduction._plain(vals, kind), ref,
              float(np.abs(w64).sum()), kind != "sum")
        for ax in (0, 1):
            k = on_path("generated", lambda: reduction.map_reduce_axis(prog, kind, ax, shape, m, row, col))
            ref = {"sum": w64.sum, "max": w64.max, "min": w64.min}[kind](axis=ax)
            agree("rd_axis", f"map-reduce axis {ax} {kind}", k, reduction._plain(vals, kind, ax),
                  ref, np.abs(w64).sum(axis=ax), kind != "sum")
            k = on_path("generated", lambda: reduction.reduce_axis(arr.T._operand(), kind, ax))
            ref = {"sum": m_np.T.astype(np.float64).sum, "max": m_np.T.max,
                   "min": m_np.T.min}[kind](axis=ax)
            agree("rd_axis", f"transposed axis {ax} {kind}", k,
                  reduction._plain(m.T, kind, ax), ref, np.abs(m_np.T.astype(np.float64)).sum(axis=ax),
                  kind != "sum")
    log(f"check map-reduce m*row-col ({N_AXIS},{N_AXIS}) full, axis 0 and 1 (generated), and axis "
        "reductions of a transposed view (generated, gathered): sums within 2e-5*sum|x|, max/min exact, "
        "bits repeat")

    # rd_axis on a ragged matrix (columns no multiple of 4, rows no multiple
    # of the segment), every path along both axes.  Its rows start at
    # 16-byte boundaries in a wider base, so it is read 16 bytes at a time;
    # its contiguous clone has ragged rows and is gathered element by
    # element; x * 1.0 as a sum runs the hoisted loop, x * 1.0 + 0.0 the
    # interpreter: all give the direct path's bits.
    R, C = RAGGED_AXIS
    base = on(rng.standard_normal((R, (C + 3) // 4 * 4)).astype(np.float32))
    rag = base[:, :C]
    clone = rag.contiguous()
    rag64 = rag.double().cpu().numpy()
    for ax in (0, 1):
        for kind in ("sum", "max", "min"):
            k = on_path("direct", lambda: reduction.reduce_axis(rag, kind, ax))
            ref = {"sum": rag64.sum, "max": rag64.max, "min": rag64.min}[kind](axis=ax)
            agree("rd_axis", f"ragged axis {ax} {kind}", k, reduction._plain(rag, kind, ax), ref,
                  np.abs(rag64).sum(axis=ax), kind != "sum")
            others = [
                ("generated", lambda: reduction.reduce_axis(clone, kind, ax)),
                ("single" if kind == "sum" else "generated",
                 lambda: reduction.map_reduce_axis(times_one((R, C)), kind, ax, (R, C), rag)),
                ("generated", lambda: reduction.map_reduce_axis(times_one_plus_zero((R, C)), kind, ax,
                                                             (R, C), rag)),
                ("generated", lambda: reduction.map_reduce_axis(times_one_plus_zero((R, C)), kind, ax,
                                                              (R, C), clone)),
            ]
            for path, fn in others:
                check(same_bits(k, on_path(path, fn)),
                      f"ragged axis {ax} {kind}: path {path} != the direct path")
    log(f"check rd_axis ragged ({R},{C}) axis 0 and 1: direct = single = generated on quads and gathered, "
        "sums within 2e-5*sum|x|, max/min exact, bits repeat")

    # bfloat16 and float16 inputs: widened exactly at the load and summed in
    # float32.  ``half`` is contiguous: in full the direct loop's 8-byte
    # quads, and along an axis, its rows of 1030 elements being no whole
    # quads, gathered; ``rows`` keeps the rows of the wider base
    # (whole quads): the direct loop along both axes.  Each gives the bits
    # of the same values 2 bytes off (gathered).  A map-reduce of a
    # bfloat16 program rounds each instruction's result in the register
    # (generated), and its sum of one instruction on each lane (single).
    for dtype in (torch.bfloat16, torch.float16):
        half = rag.to(dtype)
        wide_base = base.to(dtype)
        rows, rows_off = wide_base[:, :C], two_bytes_off(wide_base)[:, :C]
        half_off = two_bytes_off(half)
        h64 = half.double().cpu().numpy()
        for kind in ("sum", "max", "min"):
            ref = {"sum": h64.sum, "max": h64.max, "min": h64.min}[kind]
            k = on_path("direct", lambda: reduction.reduce(half, kind))
            agree("rd_full", f"{dtype} ({R},{C}) {kind}", k, reduction._plain(half, kind), ref(),
                  float(np.abs(h64).sum()), kind != "sum")
            check(same_bits(k, on_path("generated", lambda: reduction.reduce(half_off, kind))),
                  f"{dtype} ({R},{C}) {kind}: the direct path != the element path 2 bytes off")
            for ax in (0, 1):
                k = on_path("generated", lambda: reduction.reduce_axis(half, kind, ax))
                agree("rd_axis", f"{dtype} ({R},{C}) axis {ax} {kind}", k,
                      reduction._plain(half, kind, ax), ref(axis=ax), np.abs(h64).sum(axis=ax),
                      kind != "sum")
                k = on_path("direct", lambda: reduction.reduce_axis(rows, kind, ax))
                agree("rd_axis", f"{dtype} rows of a wider base axis {ax} {kind}", k,
                      reduction._plain(rows, kind, ax), ref(axis=ax), np.abs(h64).sum(axis=ax),
                      kind != "sum")
                check(same_bits(k, on_path("generated", lambda: reduction.reduce_axis(rows_off, kind, ax))),
                      f"{dtype} axis {ax} {kind}: the direct path != the element path 2 bytes off")
    hb = rag.bfloat16()
    hb_off = two_bytes_off(hb)
    lh = program.leaf((R, C), torch.bfloat16)
    for label, prog, path in (("x*x+x", program.lower(lh * lh + lh, [lh]), "generated"),
                              ("x*2.5", program.lower(lh * 2.5, [lh]), "single")):
        vals = reduction.values(prog, (R, C), [hb], dev)
        v64 = vals.double().cpu().numpy()
        k = on_path(path, lambda: reduction.map_reduce(prog, "sum", (R, C), hb))
        agree("rd_full", f"bfloat16 map-reduce {label}", k, reduction._plain(vals, "sum"), v64.sum(),
              float(np.abs(v64).sum()), False)
        check(same_bits(k, on_path("generated", lambda: reduction.map_reduce(prog, "sum", (R, C), hb_off))),
              f"bfloat16 map-reduce {label}: path {path} != the element path 2 bytes off")
    log(f"check rd_full/rd_axis on bfloat16 and float16 ({R},{C}): full (direct) and along axis 0 "
        "and 1 (gathered; rows of whole quads: direct), and the bfloat16 map-reduces x*x+x (generated) "
        "and x*2.5 (single, rounded on each lane): sums within 2e-5*sum|x| of the plain version and "
        "of float64, max/min exact, bits repeat, each the bits of the same values 2 bytes off")
    return err


def matmul_checks(dev, rng, sm, program, matmul, elementwise):
    """Phase 7a: the matmul kernel against its plain version on the card.
    Returns the largest |kernel - plain| by (entry point, kernel)."""
    import torch

    err = {(e, k): 0.0 for e in ("mm", "bmm") for k in matmul.VARIANTS}

    def on(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    def f32(*shape):
        return on(rng.standard_normal(shape).astype(np.float32))

    def both(a, b, out_dtype=None, epilogue=None, extras=()):
        """The kernel twice (the bits must repeat) and the plain version."""
        k1 = matmul.matmul(a, b, out_dtype, epilogue=epilogue, extras=extras)
        k2 = matmul.matmul(a, b, out_dtype, epilogue=epilogue, extras=extras)
        torch.cuda.synchronize()
        check(torch.equal(k1, k2), "a product differs between two launches")
        dims = matmul.product_shape(a.shape, b.shape)
        ex = [matmul._extra3(e, dims, len(a.shape) == 3) for e in extras]
        p = matmul.matmul_plain(a, b, k1.dtype, epilogue, ex)
        key = ("bmm" if len(a.shape) == 3 else "mm", matmul.variant(a.dtype, b.dtype))
        err[key] = max(err[key], float((k1.double() - p.double()).abs().max()))
        return k1, p

    def close(label, k, p, ref64, scale64):
        tol = 2e-5 * scale64
        check(bool(((k.double() - p.double()).abs() <= tol).all()),
              f"{label}: kernel vs plain beyond 2e-5*(|A|@|B|)")
        check(bool(((k.double() - ref64).abs() <= tol).all()),
              f"{label}: kernel vs float64 beyond 2e-5*(|A|@|B|)")

    def one_bf16_ulp(label, kb, k32):
        check(kb.dtype == torch.bfloat16 and torch.equal(kb, k32.bfloat16()),
              f"{label}: the bf16 result is not the f32 result rounded once")

    # f32 and bf16, ragged, against the plain version and float64 numpy.
    a_np = rng.standard_normal((300, 270)).astype(np.float32)
    b_np = rng.standard_normal((270, 515)).astype(np.float32)
    a, b = on(a_np), on(b_np)
    scale = on(np.abs(a_np).astype(np.float64) @ np.abs(b_np).astype(np.float64))
    k, p = both(a, b)
    close("f32 ragged", k, p, on(a_np.astype(np.float64) @ b_np.astype(np.float64)), scale)
    ab, bb = a.bfloat16(), b.bfloat16()
    k32, p32 = both(ab, bb, torch.float32)
    ref = ab.double() @ bb.double()
    close("bf16 ragged", k32, p32, ref, ab.double().abs() @ bb.double().abs())
    kb, _ = both(ab, bb, torch.bfloat16)
    one_bf16_ulp("bf16 ragged", kb, k32)
    log("check mm (300,270)@(270,515) f32 and bf16: within 2e-5*(|A|@|B|) of plain and "
        "float64; bf16 output = f32 result rounded once; bits repeat")

    # A transposed view and a negative-step view, read in place.
    base_a, base_b = sm.Array(f32(270, 300)), sm.Array(f32(540, 330))
    va, vb = base_a.T, base_b[::-2, ::-1][:, :300]
    k, p = both(va._operand(), vb._operand())
    at, bt = va.torch().double(), vb.torch().double()
    close("views", k, p, at @ bt, at.abs() @ bt.abs())
    log(f"check mm views: transposed {va.shape} strides {va.strides} @ negative-step "
        f"{vb.shape} strides {vb.strides}: within tolerance, no copy")

    # Integers: exact against int64 numpy, and an int32 product that wraps.
    matmul.reset_launches()
    for da, db in (("int8", "int8"), ("int8", "uint8"), ("uint8", "uint8")):
        ia = rng.integers(np.iinfo(da).min, np.iinfo(da).max + 1, (130, 200)).astype(da)
        ib = rng.integers(np.iinfo(db).min, np.iinfo(db).max + 1, (200, 129)).astype(db)
        k, p = both(on(ia), on(ib))
        want = on((ia.astype(np.int64) @ ib.astype(np.int64)).astype(np.int32))
        check(k.dtype == torch.int32 and torch.equal(k, want) and torch.equal(k, p),
              f"{da} @ {db} is not exact")
    wa = torch.full((20, 600), 40_000, dtype=torch.int32, device=dev)
    wb = torch.full((600, 17), 40_000, dtype=torch.int32, device=dev)
    want = (40_000 * 40_000 * 600) % (1 << 32)
    want = want - (1 << 32) if want >= 1 << 31 else want
    k, p = both(wa, wb)
    check(bool((k == want).all()) and torch.equal(k, p), "the int32 product does not wrap exactly")
    check(matmul.VARIANTS["wgmma_s8"] == 6 and matmul.VARIANTS["imad_i32"] >= 2,
          f"the integer products launched {matmul.VARIANTS}")
    log("check mm int8@int8, int8@uint8, uint8@uint8: exact int32; int32 wraparound exact")

    # Rank 3, and every epilogue extra shape: a (1, N) row, an (M, 1)
    # column, a full extra, a 0-d extra (and a per-batch one).
    for lead in ((), (3,)):
        M, K, N = 200, 70, 260
        a, b = f32(*lead, M, K), f32(*lead, K, N)
        extras = [f32(1, N), f32(M, 1), f32(*lead, M, N), f32()] + ([f32(3, 1, 1)] if lead else [])
        acc = program.leaf(lead + (M, N), torch.float32)
        ls = [program.leaf(tuple(t.shape), t.dtype) for t in extras]
        root = sm.tanh(sm.maximum(acc * ls[1] + ls[0], 0.0) - ls[2]) * ls[3]
        if lead:
            root = root + ls[4]
        prog = program.lower_epilogue(root, acc, ls)
        k, p = both(a, b, torch.float32, prog, extras)
        # The epilogue is exact given the accumulator, and tanh (slope <= 1)
        # does not amplify the accumulators' difference in summation order.
        tol = (2e-5 * (a.double().abs() @ b.double().abs()) * extras[1].double().abs()
               * extras[3].double().abs() + 1e-6)
        check(bool(((k.double() - p.double()).abs() <= tol).all()),
              f"epilogue rank {len(lead) + 2}: kernel vs plain beyond tolerance")
        kb, _ = both(a, b, torch.bfloat16, prog, extras)
        one_bf16_ulp(f"epilogue rank {len(lead) + 2}", kb, k)
    log("check mm/bmm epilogue tanh(relu(acc*col+row)-full)*scalar(+batch): within tolerance, "
        "bf16 output rounded once, bits repeat")

    # The dequantizing epilogue, scalar and per-channel (1, N) scale.
    ia = rng.integers(-127, 128, (130, 200)).astype(np.int8)
    ib = rng.integers(0, 256, (200, 129)).astype(np.uint8)
    acc64 = (ia.astype(np.int64) @ ib.astype(np.int64)).astype(np.float32)
    for s_np in (np.float32(0.5), np.abs(rng.standard_normal((1, 129))).astype(np.float32)):
        k = matmul.int8_matmul(on(ia), on(ib), scale=on(np.asarray(s_np)))
        check(k.dtype == torch.float32 and np.array_equal(k.cpu().numpy(), acc64 * s_np),
              "the dequantizing epilogue is not exact")
    log("check mm dequant epilogue, scalar and (1, N) scale: exact")

    # bf16 @ bf16: the tensor-core kernel, whatever the shape or the strides.
    worst = [0.0]  # the largest error found, in units of the tolerance

    def bf16(*shape):
        return f32(*shape).bfloat16()

    def tensor_core(label, a, b):
        """f32 and bf16 results of one bf16 product, held to the tolerance."""
        matmul.reset_launches()
        k32, p32 = both(a, b, torch.float32)
        kb, _ = both(a, b, torch.bfloat16)
        check(matmul.VARIANTS == {"wgmma_bf16": 4, "wgmma_s8": 0, "fma_f32": 0, "imad_i32": 0, "wgmma_i64": 0},
              f"{label}: launched {matmul.VARIANTS}, not the tensor-core kernel")
        at, bt = elementwise.read(a).double(), elementwise.read(b).double()
        ref, scale = at @ bt, at.abs() @ bt.abs()
        close(label, k32, p32, ref, scale)
        one_bf16_ulp(label, kb, k32)
        worst[0] = max(worst[0], float(((k32.double() - ref).abs() / (2e-5 * scale)).max()))
        return k32

    def round8(n):
        return n + (-n % 8)

    for path, width in (("element by element", lambda n: n), ("16 bytes at a time", round8)):
        def operand(rows, cols, transposed):
            if transposed:  # (rows, cols) with the rows contiguous
                return bf16(cols, width(rows))[:, :rows].T
            return bf16(rows, width(cols))[:, :cols]
        for ta, tb in ((False, False), (True, False), (False, True), (True, True)):
            tensor_core(f"bf16 {'a.T' if ta else 'a'} @ {'b.T' if tb else 'b'}, {path}",
                        operand(300, 270, ta), operand(270, 515, tb))
    log("check mm bf16 (300,270)@(270,515), each operand row-major or a transposed view, read "
        "element by element and 16 bytes at a time: wgmma, within tolerance, bits repeat")
    base_a, base_b = sm.Array(bf16(270, 304)), sm.Array(bf16(540, 336))
    va = base_a.T[:300]._operand()
    for label, vb in (("unaligned slice", base_b[::2, 10:310]),
                      ("negative-step view", base_b[::-2, ::-1][:, :300])):
        vb = vb._operand()
        check(not matmul.staging(matmul._strides3(vb.shape, vb.strides, False), 1,
                                 vb.base.data_ptr() + 2 * vb.offset)[1],
              f"{label}: not on the element path")
        k = tensor_core(f"bf16 {label}", va, vb)
        clone = matmul.matmul(elementwise.read(va).contiguous(), elementwise.read(vb).contiguous(),
                              torch.float32)
        check(torch.equal(k, clone), f"bf16 {label}: the view and its clone differ in bits")
    log("check mm bf16 unaligned slice and negative-step view (element path): the bits of "
        "their contiguous clones")
    tensor_core("bf16 K=1", bf16(130, 1), bf16(1, 70))
    tensor_core(f"bf16 K={N_MM + 5}", bf16(100, N_MM + 5), bf16(N_MM + 5, 264))
    tensor_core("bf16 rank 3", bf16(3, 70, 33), bf16(3, 33, 136))
    a, b = bf16(3, 200, 70), bf16(3, 70, 264)
    extras = [bf16(1, 1, 264), f32(3, 1, 1)]
    acc = program.leaf((3, 200, 264), torch.float32)
    ls = [program.leaf(tuple(t.shape), t.dtype) for t in extras]
    prog = program.lower_epilogue(sm.maximum(acc + ls[0], 0.0) * 0.5 - ls[1], acc, ls)
    matmul.reset_launches()
    k, p = both(a, b, torch.float32, prog, extras)
    check(bool(((k.double() - p.double()).abs()
                <= 2e-5 * (a.double().abs() @ b.double().abs()) * 0.5 + 1e-6).all()),
          "bf16 fused epilogue: kernel vs plain beyond tolerance")
    kb, _ = both(a, b, torch.bfloat16, prog, extras)
    one_bf16_ulp("bf16 fused epilogue", kb, k)
    check(matmul.VARIANTS["wgmma_bf16"] == 4, "the bf16 fused epilogue left the tensor-core kernel")
    # The epilogue runs four columns at a time: a short and a long program
    # must both give the elementwise kernel's bits on the stored product.
    a2, b2, row2 = a[0], b[0], f32(1, 264)
    acc2, lrow2 = program.leaf((200, 264), torch.float32), program.leaf((1, 264), torch.float32)
    stored = matmul.matmul(a2, b2, torch.float32)
    for terms in (1, 12):
        root = acc2
        for i in range(terms):
            root = sm.minimum(root * (0.5 + 0.01 * i) + lrow2, 3.0 + i)
        fused = matmul.matmul(a2, b2, torch.float32,
                              epilogue=program.lower_epilogue(root, acc2, [lrow2]), extras=[row2])
        after = elementwise.elementwise(program.lower(root, [acc2, lrow2]), (200, 264),
                                        torch.float32, stored, row2)
        check(torch.equal(fused, after),
              f"bf16 epilogue of {terms} terms differs from ew_strided on the stored product")
    log(f"check mm bf16 K=1, K={N_MM + 5}, rank 3, fused epilogue with a per-batch extra "
        "stored as f32 and bf16: wgmma, within tolerance; a short and a long epilogue give "
        "ew_strided's bits on the stored product")
    # Mixed operands and pairs with an int32 operand keep the CUDA-core kernels.
    matmul.reset_launches()
    x32, y32 = f32(130, 70), f32(70, 90)
    check(torch.equal(matmul.matmul(x32, y32.bfloat16()), matmul.matmul(x32, y32.bfloat16().float())),
          "f32 @ bf16 is not the f32 product of the widened operand")
    k, p = both(x32.to(torch.int32), y32.to(torch.int8))
    check(torch.equal(k, p), "int32 @ int8 is not exact")
    check(matmul.VARIANTS == {"wgmma_bf16": 0, "wgmma_s8": 0, "fma_f32": 2, "imad_i32": 2, "wgmma_i64": 0},
          f"mixed and int32 products launched {matmul.VARIANTS}")
    log(f"check mm bf16: largest error {worst[0]:.4f} of the tolerance 2e-5*(|A|@|B|) "
        "against float64; f32 @ bf16 and int32 @ int8 keep the CUDA-core kernels")
    cuda_core_checks(dev, rng, sm, program, matmul, elementwise, both)
    int8_checks(dev, rng, sm, matmul, elementwise, both)
    return err


def in_order(a, b):
    """The parent kernel's f32 product: every element one chain of fused
    multiply-adds from 0 in ascending k, k padded with zero products to a
    multiple of 16.  Emulated in float64, where a product of two floats is
    exact: each step's sum is rounded to odd in float64 (the nearest sum,
    moved one float64 ulp towards the exact one where that is inexact and
    its last bit even), then to float32, which is the exact sum rounded to
    float32 once, as a fused multiply-add rounds it (float64 has more than
    float32's 24 + 2 bits); rounding the float64 sum to nearest first could
    round twice."""
    import torch

    from simplemath_tpu_torch.ops import elementwise

    a, b = elementwise.read(a).double(), elementwise.read(b).double()
    acc = torch.zeros(a.shape[0], b.shape[1], dtype=torch.float32, device=a.device)
    inf = torch.tensor(float("inf"), dtype=torch.float64, device=a.device)
    for k in range((a.shape[1] + 15) // 16 * 16):
        if k >= a.shape[1]:
            acc = acc + 0.0
            continue
        term, c = a[:, k:k + 1] * b[k:k + 1], acc.double()
        total = term + c
        back = total - term
        err = (term - (total - back)) + (c - back)  # the exact sum is total + err
        even = (total.view(torch.int64) & 1) == 0
        towards = torch.where(err > 0, inf, -inf)
        total = torch.where((err != 0) & even, torch.nextafter(total, towards), total)
        acc = total.float()
    return acc


MM_GEN = (3, 200, 96, 264)  # B, M, K, N of the generated epilogues' checks (ragged: N 259)


def matmul_generated_cases(dev, seed=0):
    """(label, a, b, out_dtype, epilogue, extras) of the checks of the matmul
    kernels generated per epilogue (ops/codegen.py, kind "matmul"): each
    variant that takes an epilogue (bf16 and int8/uint8 on the tensor
    cores, float32, mixed and int32 on the CUDA cores), rank 2 and 3, every
    stored type (float32, bfloat16, int32, bool), extras of every shape
    (1|B, 1|M, 1|N) and of each type the epilogue reads (float32, bfloat16,
    int32, bool), ragged N (rows not 16-byte aligned), operands on other
    staging orders and on the element path, the dequantizing epilogue of
    ``int8_matmul(scale=)``, and programs of ~100 instructions.  From their
    own generator (``seed``), so that no other check's draws move."""
    import torch

    import simplemath_tpu_torch as sm
    from simplemath_tpu_torch.ops import matmul, program

    rng = np.random.default_rng(seed)
    B, M, K, N = MM_GEN

    def on(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    def values(shape, dtype):
        if dtype in (torch.float32, torch.bfloat16):
            return on(rng.standard_normal(shape).astype(np.float32)).to(dtype)
        if dtype == torch.bool:
            return on(rng.standard_normal(shape) > 0)
        lo, hi = {torch.int8: (-128, 128), torch.uint8: (0, 256)}.get(dtype, (-1000, 1000))
        return on(rng.integers(lo, hi, shape)).to(dtype)

    def pair(da, db, batch=None, n=N):
        lead = () if batch is None else (batch,)
        return values(lead + (M, K), da), values(lead + (K, n), db)

    cases = []

    def add(label, a, b, out_dtype, build, extras):
        acc_dtype = matmul.accumulator(a.dtype, b.dtype)
        shape = tuple(a.shape[:-1]) + (b.shape[-1],)
        acc = program.leaf(shape, acc_dtype)
        leaves = [program.leaf(tuple(e.shape), e.dtype) for e in extras]
        cases.append((label, a, b, out_dtype, program.lower_epilogue(build(acc, *leaves), acc, leaves),
                      extras))

    def long_program(acc, e):
        root = acc
        for _ in range(50):  # two instructions a turn, and the extras' widening
            root = root * e + 0.5
        return root

    def relu_bias(acc, e):
        return sm.maximum(acc + e, 0.5) * 0.25 - 0.5

    f32, bf16, i32 = torch.float32, torch.bfloat16, torch.int32
    # bf16 @ bf16 (wgmma_bf16)
    a, b = pair(bf16, bf16)
    for out in (f32, bf16):
        add(f"bf16 mm relu(acc+bias) -> {out}", a, b, out, relu_bias, [values((1, N), f32)])
    add("bf16 mm acc > row -> bool", a, b, torch.bool, lambda acc, e: acc > e, [values((1, N), f32)])
    add("bf16 mm column, scalar, full bf16", a, b, f32, lambda acc, c, s, f: (acc * c - f) / s,
        [values((M, 1), f32), values((), f32) + 3.0, values((M, N), bf16)])
    add("bf16 mm bool and int32 extras", a, b, f32,
        lambda acc, m, i: program.apply("where", m, acc, program.cast(i, f32)),
        [values((M, N), torch.bool), values((1, N), i32)])
    add("bf16 mm ~100 instructions", a, b, f32, long_program, [values((1, N), f32) * 0.1])
    ar, br = pair(bf16, bf16, n=N - 5)
    add("bf16 mm ragged N -> bf16", ar, br, bf16, relu_bias, [values((1, N - 5), f32)])
    ta, tb = values((K, M), bf16).T, values((N, K), bf16).T
    add("bf16 mm transposed views", ta, tb, f32, relu_bias, [values((1, N), bf16)])
    a3, b3 = pair(bf16, bf16, batch=B)
    add("bf16 bmm (B,1,N) (1,M,1) (B,1,1)", a3, b3, f32, lambda acc, r, c, s: (acc + r) * c - s,
        [values((B, 1, N), f32), values((1, M, 1), f32), values((B, 1, 1), f32)])
    add("bf16 bmm (1,1,N) bf16 (B,M,N) -> bf16", a3, b3, bf16, lambda acc, r, f: acc * r + f,
        [values((1, 1, N), bf16), values((B, M, N), f32)])
    # int8 / uint8 pairs (wgmma_s8)
    q, w = pair(torch.int8, torch.int8)
    deq2, deq3 = matmul._dequant_epilogue(2), matmul._dequant_epilogue(3)
    cases.append(("int8 mm dequant (1,N)", q, w, f32, deq2, [values((1, N), f32).abs()]))
    cases.append(("int8 mm dequant scalar", q, w, f32, deq2, [values((), f32).abs()]))
    q3, w3 = pair(torch.int8, torch.int8, batch=B)
    cases.append(("int8 bmm dequant (B,1,N)", q3, w3, f32, deq3, [values((B, 1, N), f32).abs()]))
    add("int8 mm (acc+column)*3 -> int32", q, w, i32, lambda acc, c: (acc + c) * 3, [values((M, 1), i32)])
    add("int8 mm acc > row -> bool", q, w, torch.bool, lambda acc, r: acc > r, [values((1, N), i32)])
    uq, uw = pair(torch.uint8, torch.int8, n=N - 5)
    add("uint8 @ int8 mm ragged N, float -> bf16", uq, uw, bf16,
        lambda acc, s: program.cast(acc, f32) * s, [values((1, N - 5), f32)])
    add("int8 mm transposed B, full int32", q, values((N, K), torch.int8).T, i32,
        lambda acc, f: acc - f, [values((M, N), i32)])
    # float32 and mixed pairs (fma_f32), int32 pairs (imad_i32)
    x, y = pair(f32, f32)
    for out in (f32, bf16):
        add(f"f32 mm relu(acc+bias) -> {out}", x, y, out, relu_bias, [values((1, N), f32)])
    add("f32 mm acc > full -> bool", x, y, torch.bool, lambda acc, f: acc > f, [values((M, N), f32)])
    x3, y3 = pair(f32, f32, batch=B)
    add("f32 bmm (B,M,1) (1,1,N)", x3, y3, f32, lambda acc, c, r: acc * c + r,
        [values((B, M, 1), f32), values((1, 1, N), f32)])
    xr, yr = pair(f32, f32, n=N - 5)
    add("f32 mm ragged N, full and scalar", xr, yr, f32, lambda acc, f, s: acc * s - f,
        [values((M, N - 5), f32), values((), f32)])
    off = values((M, K + 1), f32)[:, 1:]
    add("f32 mm transposed B, A 4 bytes off", off, values((N, K), f32).T, f32, relu_bias,
        [values((1, N), f32)])
    add("f32 mm transposed A", values((K, M), f32).T, y, f32, relu_bias, [values((1, N), bf16)])
    add("f32 @ bf16 mm row", x, values((K, N), bf16), f32, relu_bias, [values((1, N), f32)])
    add("f32 mm ~100 instructions", x, y, f32, long_program, [values((1, N), f32) * 0.1])
    ia, ib = pair(i32, i32)
    add("int32 mm acc*row+7 -> int32", ia, ib, i32, lambda acc, r: acc * r + 7, [values((1, N), i32)])
    add("int32 @ int8 mm acc > column -> bool", ia, values((K, N), torch.int8), torch.bool,
        lambda acc, c: acc > c, [values((M, 1), i32)])
    ia3, ib3 = pair(i32, i32, batch=B)
    add("int32 bmm float (B,1,1)", ia3, ib3, f32, lambda acc, s: program.cast(acc, f32) * s,
        [values((B, 1, 1), f32)])
    iar, ibr = pair(i32, i32, n=N - 5)
    add("int32 mm ragged N, bool where", iar, ibr, i32,
        lambda acc, m: program.apply("where", m, acc, -acc), [values((M, N - 5), torch.bool)])
    return cases


def matmul_generated_signatures(dev):
    """The signatures of ``matmul_generated_cases``: what ``compile_ahead``
    compiles before their checks run."""
    from simplemath_tpu_torch.ops import matmul

    return [matmul.launch_signature(a, b, out, epi, extras)
            for _, a, b, out, epi, extras in matmul_generated_cases(dev, SEED + 21)]


def matmul_generated_checks(matmul, cases):
    """Phase 7: each case on its generated kernel (``EPILOGUE_PATHS``
    "generated") against the compiled kernel's interpreter
    (``matmul.interpret``, "interp"), bit for bit.  Returns the number of
    cases and the variants, ranks and stored types they covered."""
    import torch

    covered = set()
    for label, a, b, out_dtype, epi, extras in cases:
        matmul.reset_launches()
        g = matmul.matmul(a, b, out_dtype, epilogue=epi, extras=extras)
        check(matmul.EPILOGUE_PATHS == {"generated": 1, "interp": 0},
              f"{label}: the epilogue ran {matmul.EPILOGUE_PATHS}")
        i = matmul.interpret(a, b, out_dtype, epilogue=epi, extras=extras)
        torch.cuda.synchronize()
        check(matmul.EPILOGUE_PATHS == {"generated": 1, "interp": 1},
              f"{label}: the reference ran {matmul.EPILOGUE_PATHS}")
        check(g.dtype == i.dtype == out_dtype and torch.equal(bits(g), bits(i)),
              f"{label}: the generated epilogue differs from the interpreter")
        covered.add((matmul.variant(a.dtype, b.dtype), a.dim(), str(out_dtype)))
    return len(cases), covered


def cuda_core_checks(dev, rng, sm, program, matmul, elementwise, both):
    """Phase 7a, the CUDA-core kernel (csrc/matmul.cu): f32, mixed f32/bf16
    and int32 products on both staging paths (16-byte cp.async copies and
    element reads) in the four operand orders; views (transposed,
    negative-step, 4 bytes off) give the bits of their contiguous clones
    and f32 products the parent kernel's order; K = 1 and K = 2048 + 5;
    rank 3; epilogues with (1, N), (M, 1), full and 0-d extras give
    ew_strided's bits on the stored product.  Then the 64-bit kernel
    (csrc/matmul_wgmma_i64.cu): int64 and uint64 products exact against the
    CPU's int64 product, wrapping.  ``both`` is matmul_checks'."""
    import torch

    def f32(*shape):
        return torch.from_numpy(np.asarray(rng.standard_normal(shape), np.float32)).to(dev)

    def i32(*shape):
        return torch.from_numpy(np.asarray(rng.integers(-2**31, 2**31, shape), np.int32)).to(dev)

    def vec16(x, contraction):
        s3 = matmul._strides3(tuple(x.shape), tuple(x.stride()), x.dim() == 3)
        return matmul.staging(s3, contraction, x.data_ptr(), x.element_size())[1]

    def clone_bits(label, a, b, out_dtype=None):
        k = matmul.matmul(a, b, out_dtype)
        c = matmul.matmul(elementwise.read(a).contiguous(), elementwise.read(b).contiguous(), out_dtype)
        torch.cuda.synchronize()
        check(torch.equal(k, c), f"{label}: the product differs in bits from its clones'")
        return k

    widths = {"element by element": lambda n: n + 1 if n % 4 == 0 else n,
              "16 bytes at a time": lambda n: n + (-n % 4)}
    matmul.reset_launches()
    for path, width in widths.items():
        def operand(make, rows, cols, transposed):
            if transposed:  # (rows, cols) with the rows contiguous
                return make(cols, width(rows))[:, :rows].T
            return make(rows, width(cols))[:, :cols]
        for ta, tb in ((False, False), (True, False), (False, True), (True, True)):
            label = f"{'a.T' if ta else 'a'} @ {'b.T' if tb else 'b'}, {path}"
            a, b = operand(f32, 300, 270, ta), operand(f32, 270, 515, tb)
            check(vec16(a, 2) == vec16(b, 1) == (path != "element by element"),
                  f"f32 {label}: staged otherwise")
            k = clone_bits(f"f32 {label}", a, b)
            want = in_order(a, b)
            check(torch.equal(k, want), f"f32 {label}: not the parent kernel's order at "
                  f"{int((k != want).sum())} elements, largest difference {max_ulp(k, want)} ulp")
            ia, ib = operand(i32, 300, 270, ta), operand(i32, 270, 515, tb)
            k = clone_bits(f"int32 {label}", ia, ib)
            want = matmul._wrap_int32(ia.cpu().long() @ ib.cpu().long())
            check(torch.equal(k.cpu(), want), f"int32 {label}: not the product mod 2**32")
        # Mixed pairs: the bf16 operand widened at the load, read element by
        # element beside a copied f32 one.
        a, b = operand(f32, 300, 270, False), operand(f32, 270, 515, False)
        check(torch.equal(matmul.matmul(a, b.bfloat16()), matmul.matmul(a, b.bfloat16().float())),
              f"f32 @ bf16, {path}: not the f32 product of the widened operand")
        k = matmul.matmul(a.to(torch.int32), b.to(torch.int8))
        check(torch.equal(k.cpu(), matmul._wrap_int32(a.cpu().long() @ b.to(torch.int8).cpu().long())),
              f"int32 @ int8, {path}: not exact")
    check(matmul.VARIANTS["fma_f32"] == 20 and matmul.VARIANTS["imad_i32"] == 18
          and sum(matmul.VARIANTS.values()) == 38, f"the CUDA-core checks launched {matmul.VARIANTS}")
    log("check mm f32 and int32 (300,270)@(270,515), the four operand orders, 16-byte copies "
        "and element reads: the bits of the contiguous clones, f32 in the parent kernel's "
        "order, int32 mod 2**32; f32 @ bf16 and int32 @ int8: the widened products")

    base = sm.Array(f32(540, 336))
    a = f32(300, 270)
    for label, b in (("negative-step", base[::-2, ::-1][:, :300]),
                     ("4 bytes off", base[:270, 1:301]), ("transposed", base.T[:270, :300])):
        b = b._operand()
        k = clone_bits(f"f32 {label}", a, b)
        check(torch.equal(k, in_order(a, b)), f"f32 {label}: not the parent kernel's order")
    x = f32(300 * 270 + 1)[1:].reshape(300, 270)  # A's first element 4 bytes off 16
    check(not vec16(x, 2), "the operand 4 bytes off is copied")
    y = f32(270, 515)
    check(torch.equal(clone_bits("f32 A 4 bytes off", x, y), in_order(x, y)),
          "f32 A 4 bytes off: not the parent kernel's order")
    for K in (1, N_MM + 5):
        a, b = f32(64, K), f32(K, 72)
        k, p = both(a, b)
        check(torch.equal(k, in_order(a, b)), f"f32 K={K}: not the parent kernel's order")
        scale = a.double().abs() @ b.double().abs()
        check(bool(((k.double() - a.double() @ b.double()).abs() <= 2e-5 * scale).all()),
              f"f32 K={K}: beyond 2e-5*(|A|@|B|) of float64")
    a3, b3 = f32(3, 70, 33), f32(3, 136, 33).transpose(1, 2)
    k3 = clone_bits("f32 rank 3, B a transposed view", a3, b3)
    for i in range(3):
        check(torch.equal(k3[i], in_order(a3[i], b3[i])), "f32 rank 3: not the parent kernel's order")
    log(f"check mm f32 views (negative-step, 4 bytes off, transposed), K=1, K={N_MM + 5}, rank 3: "
        "the clones' bits and the parent kernel's order")

    # Epilogues over the f32 and int32 accumulators, every extra shape:
    # the fused result is ew_strided's on the stored product, bit for bit.
    M, K, N = 200, 70, 260
    for dtype, make in ((torch.float32, f32), (torch.int32, lambda *s: i32(*s) >> 20)):
        a, b = make(M, K), make(K, N)
        extras = [make(1, N), make(M, 1), make(M, N), make()]
        acc = program.leaf((M, N), dtype)
        ls = [program.leaf(tuple(t.shape), dtype) for t in extras]
        if dtype == torch.float32:
            root = sm.tanh(sm.maximum(acc * ls[1] + ls[0], 0.0) - ls[2]) * ls[3]
        else:
            root = sm.maximum(acc * ls[1] + ls[0], 0) - ls[2] * ls[3]
        fused = matmul.matmul(a, b, dtype, epilogue=program.lower_epilogue(root, acc, ls),
                              extras=extras)
        stored = matmul.matmul(a, b, dtype)
        after = elementwise.elementwise(program.lower(root, [acc, *ls]), (M, N), dtype, stored,
                                        *extras)
        check(torch.equal(fused, after),
              f"{dtype} epilogue: the fused product differs from ew_strided on the stored one")
    log("check mm f32 and int32 epilogues with (1, N), (M, 1), full and 0-d extras: "
        "ew_strided's bits on the stored product")

    # 64-bit products: full-range values, wrapping mod 2**64.
    def wide(dtype, *shape):
        if dtype == "uint64":
            x = rng.integers(0, 2**63, shape, dtype=np.uint64) * np.uint64(2) + np.uint64(1)
        elif dtype == "int64":
            x = rng.integers(-2**63, 2**63 - 1, shape, dtype=np.int64)
        else:
            info = np.iinfo(dtype)
            x = rng.integers(info.min, info.max, shape, dtype=np.int64, endpoint=True).astype(dtype)
        return torch.from_numpy(x).to(dev)

    def exact(label, a, b):
        k = matmul.matmul(a, b, torch.int64)
        want = torch.matmul(matmul._int64(a).cpu(), matmul._int64(b).cpu())
        check(k.dtype == torch.int64 and torch.equal(k.cpu(), want),
              f"{label}: not the CPU's int64 product")
        return k

    matmul.reset_launches()
    for da, db in (("int64", "int64"), ("uint64", "uint64"), ("int64", "uint64")):
        exact(f"{da} @ {db}", wide(da, 130, 200), wide(db, 200, 129))
    a, i8 = wide("int64", 3, 70, 33), torch.from_numpy(
        rng.integers(-128, 128, (3, 33, 136)).astype(np.int8)).to(dev)
    exact("int64 @ int8 rank 3", a, i8)
    ua = sm.Array(wide("uint64", 96, 64))
    got = sm.matmul(ua.T, ua[::-1])
    want = (ua.torch().cpu().view(torch.int64).T @ ua.torch().cpu().view(torch.int64).flip(0))
    check(got.dtype == torch.uint64 and torch.equal(got.torch().cpu().view(torch.int64), want),
          "sm.matmul of uint64 views is not exact")
    # The tensor-core kernel's edges: every limb 0xFF at K = 40,000 (each
    # diagonal passes 2**32 unless folded every 16,384 of K), M and N off
    # 64, 128 and 256, K = 1, rank 3, and each narrow operand beside a
    # 64-bit one (sign- or zero-extended), at full range.
    ones = exact("all-ones (5,40000)@(40000,7)",
                 torch.full((5, 40000), -1, dtype=torch.int64, device=dev),
                 torch.full((40000, 7), -1, dtype=torch.int64, device=dev).view(torch.uint64))
    check(int(ones[0, 0]) == 40000, "all-ones at K = 40,000 lost its folds")
    exact("ragged (65,100)@(100,127)", wide("int64", 65, 100), wide("uint64", 100, 127))
    exact("ragged (129,7)@(7,191)", wide("uint64", 129, 7), wide("int64", 7, 191))
    exact("K = 1 (200,1)@(1,130)", wide("int64", 200, 1), wide("int64", 1, 130))
    exact("rank 3 (3,70,33)@(3,33,136)", wide("uint64", 3, 70, 33), wide("int64", 3, 33, 136))
    mixed = (("int8", "int64"), ("int64", "int8"), ("uint8", "uint64"), ("uint64", "uint8"),
             ("int32", "int64"), ("int64", "int32"), ("int32", "uint64"), ("uint8", "int64"))
    for da, db in mixed:
        exact(f"{da} @ {db}", wide(da, 100, 150), wide(db, 150, 90))
    launched = 10 + len(mixed)
    check(matmul.VARIANTS["wgmma_i64"] == launched and sum(matmul.VARIANTS.values()) == launched,
          f"the 64-bit products launched {matmul.VARIANTS}")
    log("check mm int64 @ int64, uint64 @ uint64, int64 @ uint64 (130,200)@(200,129), "
        "int64 @ int8 rank 3, sm.matmul of uint64 views, all-ones at K = 40,000, ragged M and N, "
        "K = 1, rank 3, the mixed pairs " + ", ".join(f"{a} @ {b}" for a, b in mixed) +
        ": the CPU's int64 product, wrapping")


def int8_checks(dev, rng, sm, matmul, elementwise, both):
    """Phase 7a, int8/uint8 pairs: the int8 tensor-core kernel against the
    exact product (``matmul.int_product``), whatever the shape or the
    strides.  ``both`` is matmul_checks' (two launches whose bits must
    repeat, and the plain version)."""
    import torch

    def i8(dtype, *shape):
        info = np.iinfo(dtype)
        x = rng.integers(info.min, info.max + 1, shape).astype(dtype)
        return torch.from_numpy(x).to(dev)

    def tensor_core(label, a, b):
        matmul.reset_launches()
        k, p = both(a, b)
        check(matmul.VARIANTS == {"wgmma_bf16": 0, "wgmma_s8": 2, "fma_f32": 0, "imad_i32": 0, "wgmma_i64": 0},
              f"{label}: launched {matmul.VARIANTS}, not the int8 tensor-core kernel")
        want = matmul.int_product(elementwise.read(a), elementwise.read(b))
        check(k.dtype == torch.int32 and torch.equal(k, want) and torch.equal(k, p),
              f"{label}: not the exact int32 product")
        return k

    for da in ("int8", "uint8"):
        for db in ("int8", "uint8"):
            a, b = i8(da, 130, 200), i8(db, 200, 129)
            check(da == "int8" or int(a.max()) > 127, "no uint8 value above 127")
            k = tensor_core(f"{da} @ {db}", a, b)
            want = a.cpu().numpy().astype(np.int64) @ b.cpu().numpy().astype(np.int64)
            check(np.array_equal(k.cpu().numpy(), want), f"{da} @ {db} differs from int64 numpy")
    log("check mm int8/uint8, the four pairs with values above 127: wgmma, exact")

    def round16(n):
        return n + (-n % 16)

    for path, width in (("byte by byte", lambda n: n), ("16 bytes at a time", round16)):
        def operand(dtype, rows, cols, transposed):
            if transposed:  # (rows, cols) with the rows contiguous
                return i8(dtype, cols, width(rows))[:, :rows].T
            return i8(dtype, rows, width(cols))[:, :cols]
        for ta, tb in ((False, False), (True, False), (False, True), (True, True)):
            a, b = operand("int8", 300, 270, ta), operand("uint8", 270, 515, tb)
            for x, contraction in ((a, 2), (b, 1)):
                vec16 = matmul.staging(matmul._strides3(x.shape, x.stride(), False), contraction,
                                       x.data_ptr(), 1)[1]
                check(vec16 == (path != "byte by byte"), f"int8 {path}: staged otherwise")
            tensor_core(f"int8 {'a.T' if ta else 'a'} @ {'b.T' if tb else 'b'}, {path}", a, b)
    log("check mm int8 (300,270)@(270,515), each operand row-major or a transposed view, read "
        "byte by byte and 16 bytes at a time (copied or transposed): wgmma, exact, bits repeat")
    tensor_core("int8 K=1", i8("int8", 130, 1), i8("uint8", 1, 70))
    tensor_core(f"int8 K={N_MM + 5}", i8("uint8", 100, N_MM + 5), i8("int8", N_MM + 5, 264))
    tensor_core("int8 rank 3", i8("int8", 3, 70, 33), i8("uint8", 3, 33, 136))
    ones = torch.full((20, 33_280), 255, dtype=torch.uint8, device=dev)
    k = tensor_core("uint8 wraparound", ones, ones.T[:, :24])
    want = (255 * 255 * 33_280) % (1 << 32) - (1 << 32)
    check(255 * 255 * 33_280 >= 1 << 31 and bool((k == want).all()),
          "the uint8 product does not wrap int32 exactly")
    base = sm.Array(i8("int8", 540, 337))
    va, vb = sm.Array(i8("uint8", 270, 304)).T[:300]._operand(), base[::2, 1:301]._operand()
    k = tensor_core("int8 view one byte off", va, vb)
    clone = matmul.matmul(elementwise.read(va).contiguous(), elementwise.read(vb).contiguous())
    check(torch.equal(k, clone), "int8: the view and its clone differ")
    log(f"check mm int8 K=1, K={N_MM + 5}, rank 3, uint8 255s at K=33280 (wraps int32), a view "
        "one byte off: wgmma, exact")
    ia, ib = i8("int8", 3, 130, 200), i8("uint8", 3, 200, 136)
    acc = matmul.int_product(ia, ib).float()
    for rank in (2, 3):
        x, y, want = (ia, ib, acc) if rank == 3 else (ia[0], ib[0], acc[0])
        for s in (torch.tensor(0.5, device=dev),
                  torch.from_numpy(np.abs(rng.standard_normal((1,) * (rank - 1) + (136,)))
                                   .astype(np.float32)).to(dev)):
            matmul.reset_launches()
            k1, k2 = matmul.int8_matmul(x, y, scale=s), matmul.int8_matmul(x, y, scale=s)
            check(k1.dtype == torch.float32 and torch.equal(k1, want * s) and torch.equal(k1, k2),
                  "int8_matmul with scale= is not the scaled exact product")
            check(matmul.VARIANTS["wgmma_s8"] == 2 and sum(matmul.VARIANTS.values()) == 2,
                  f"int8_matmul with scale= launched {matmul.VARIANTS}")
    log("check mm/bmm int8 dequantizing epilogue, scalar and per-channel scale: the scaled "
        "exact product, inside the tensor-core kernel")


def matmul_root_grad_bound(x, w, b):
    """The float64 gradient of ``sum(tanh(x @ w + b) * 2 - b)`` in (x, w,
    b), and the bound of each part that its float32 computations give: dx =
    g @ w^T and dw = x^T @ g (g = 2 (1 - tanh^2)) are products, within 2e-5
    (|A| @ |B|); db = sum_i (g_i - 1) is a sum over the rows, within 2e-5
    sum_i (|g_i| + 1) (``PERF.md`` §2's product and sum bounds)."""
    import torch

    x, w, b = (v.double() for v in (x, w, b))
    t = torch.tanh(x @ w + b)
    g = 2.0 * (1.0 - t * t)
    grads = (g @ w.T, x.T @ g, g.sum(0, keepdim=True) - x.shape[0])
    bound = (2e-5 * (g.abs() @ w.abs().T), 2e-5 * (x.abs().T @ g.abs()),
             2e-5 * (g.abs() + 1.0).sum(0, keepdim=True))
    return grads, bound


def transform_checks(dev, rng, sm, elementwise, reduction, matmul, dispatch):
    """Phase 5c: an sm op under each torch.func transform on each kernel
    family, under sync debug mode "error", counted and held to plain
    torch's autograd (float32 products in the kernel's order: within 1e-4
    relative and absolute at K = 2048; bfloat16 results within one
    bfloat16 rounding).  The gradient, whose parts are float32 products and
    a sum over K = 2048 terms of O(45) partial sums, is held instead, on
    both sides, to its float64 value within the bounds of those
    computations (``matmul_root_grad_bound``): two float32 orders of such a
    sum differ by ~1e-4 near 0, beyond 1e-4 (1 + |v|)."""
    import torch

    def on(v):
        return torch.from_numpy(np.ascontiguousarray(v)).to(dev)

    n = N_MM
    scale = n ** -0.5
    x, t_x, w = (on((scale ** k * rng.standard_normal((n, n))).astype(np.float32))
                 for k in (0, 0, 1))
    b = on(rng.standard_normal((1, n)).astype(np.float32))
    layer = sm.fuse(lambda x, w, b: sm.tanh(x @ w + b) * 2.0 - b)

    def f_sm(x, w, b):
        return layer(x, w, b).torch()

    def f_plain(x, w, b):
        x, w, b = x.float(), w.float(), b.float()
        return torch.tanh(x @ w + b) * 2.0 - b

    def counted(label, fn):
        for reset in (elementwise.reset_launches, reduction.reset_launches,
                      matmul.reset_launches, dispatch.reset):
            reset()
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        counts = dispatch.counts()
        check(not any(k.startswith("torch_path") for k in counts),
              f"{label} took the plain torch route: {counts}")
        launches = {**elementwise.LAUNCHES, **reduction.LAUNCHES, **matmul.LAUNCHES}
        check("matmul root" not in label or (matmul.EPILOGUE_PATHS["interp"] == 0
                                             and matmul.EPILOGUE_PATHS["generated"] > 0),
              f"{label}: the fused root's epilogue ran {matmul.EPILOGUE_PATHS}")
        return got, launches, counts

    out = {}
    xb, tb, wb, bb = (v.bfloat16() for v in (x, t_x, w, b))
    cases = (
        ("grad f32", lambda f: torch.func.grad(lambda *a: f(*a).float().sum(), (0, 1, 2))(x, w, b), None),
        ("jvp f32", lambda f: torch.func.jvp(f, (x, w, b), (t_x, w, b))[1], 1e-4),
        ("vmap f32", lambda f: torch.func.vmap(f, (0, None, 0))(torch.stack([x, t_x]), w,
                                                              torch.stack([b, -b])), 1e-4),
        ("vmap bf16", lambda f: torch.func.vmap(f, (0, None, None))(torch.stack([xb, tb]), wb, bb),
         2.0 ** -7),
    )
    with matmul.exact_float32():
        for label, run, tol in cases:
            got, launches, counts = counted(f"fused matmul root {label}", lambda: run(f_sm))
            want = run(f_plain)
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            err = max(float((u.float() - v.float()).abs().max()) for u, v in zip(got, want))
            check(launches["mm"] + launches["bmm"] > 0 and counts.get("transform:matmul", 0) > 0,
                  f"the fused matmul root under {label} launched no matmul kernel: {launches}")
            check(label.startswith("vmap") or launches["ew_flat"] + launches["ew_strided"] > 0,
                  f"the fused matmul root under {label} ran no derivative program: {launches}")
            row = {"launches": {k: v for k, v in launches.items() if v}, "max_abs_err": err}
            if label == "grad f32":
                want64, bound = matmul_root_grad_bound(x, w, b)
                for side, vals in (("port", got), ("torch", want)):
                    over = max(float(((u.double() - r).abs() / bd).max())
                               for u, r, bd in zip(vals, want64, bound))
                    check(over <= 1.0, f"the fused matmul root's gradient ({side}) is {over} x "
                          "the float32 computations' bound from float64")
                    row[f"{side}_over_bound"] = over
            else:
                for u, v in zip(got, want):
                    check(bool(((u.float() - v.float()).abs() <= tol * (1.0 + v.float().abs())).all()),
                          f"the fused matmul root under {label} is beyond {tol} of plain torch: {err}")
            out[f"matmul root {label}"] = row
    del xb, tb, wb, bb

    rows, m = 16, 65536
    a = rng.integers(-2**31, 2**31, (rows, m), dtype=np.int64).astype(np.int32)
    c = rng.integers(-1000, 1000, m).astype(np.int32)
    at, ct = on(a), on(c)
    got, launches, _ = counted("int32 dot under vmap", lambda: torch.func.vmap(
        lambda v: sm.dot(sm.Array(v), sm.Array(ct)).torch())(at))
    want = ((a.astype(np.int64) * c).sum(1) + 2**31) % 2**32 - 2**31
    check(launches["rd_axis"] == 1 and launches["rd_full"] == 0 and launches["ew_flat"] == 0,
          f"the int32 dot under vmap is not one rd_axis pass: {launches}")
    check(np.array_equal(got.cpu().numpy(), want.astype(np.int32)),
          "the int32 dot under vmap does not wrap as numpy's int64 product mod 2**32")
    out["int32 dot vmap (16, 65536)"] = {"launches": {k: v for k, v in launches.items() if v}}

    h = on(rng.standard_normal(N_ADD).astype(np.float32)).half()
    got, launches, _ = counted("float16 sum under grad", lambda: torch.func.grad(
        lambda v: sm.Array(v).sum().torch().float())(h))
    check(launches["rd_full"] > 0 and launches["ew_flat"] > 0 and got.dtype == torch.float16
          and bool((got == 1.0).all()), f"the float16 sum's gradient: {launches}")
    out["float16 sum grad 1M"] = {"launches": {k: v for k, v in launches.items() if v}}
    log(f"check sm ops under torch.func (no plain-torch route, no host sync): {json.dumps(out)}")


def wall_s(fn, sync_debug=None):
    """(wall seconds of one call ended by a synchronize, its result).  With
    ``sync_debug``, the call runs under that CUDA sync debug mode, so that a
    call that waits for the card inside raises ("error")."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if sync_debug:
        torch.cuda.set_sync_debug_mode(sync_debug)
    try:
        out = fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def solver_close(card, cpu, what):
    """The card's solve against the CPU's, at the CPU tests' tolerance
    against the JAX package: costs within rtol 1e-4, controls within rtol
    1e-3 and 1e-4 x the largest control.  Returns (cost rel err, us err)."""
    c_card, c_cpu = card.cost.cpu().double(), cpu.cost.double()
    cost_err = float(((c_card - c_cpu).abs() / c_cpu.abs()).max())
    u_card, u_cpu = card.us.cpu().double(), cpu.us.double()
    scale = max(1.0, float(u_cpu.abs().max()))
    u_err = float((u_card - u_cpu).abs().max())
    check(cost_err <= 1e-4, f"{what}: costs {cost_err} (relative) from the CPU's")
    check(bool(((u_card - u_cpu).abs() <= 1e-3 * u_cpu.abs() + 1e-4 * scale).all()),
          f"{what}: controls {u_err} from the CPU's")
    return cost_err, u_err


def solver_phase(dev, card):
    """The solver stack on the card (BASELINE.json configs 3-5): checks
    against the CPU and float64, then the full-width workloads, timed."""
    import torch
    from simplemath_tpu_torch import entry as port_entry
    from simplemath_tpu_torch.models import (
        ILQRConfig, MPCController, ilqr, make_cartpole, make_pendulum, make_quadrotor,
        make_sm_pendulum, rti,
    )
    from simplemath_tpu_torch.ops import dispatch, elementwise, reduction
    from simplemath_tpu_torch.utils import graphs

    rng = np.random.default_rng(SEED)
    out = {"card": card}
    cartpole, pendulum, quad = make_cartpole(), make_pendulum(), make_quadrotor()

    # Card against CPU: a small cartpole batch, the same inputs.
    x0 = torch.from_numpy((0.2 * rng.standard_normal((64, 4))).astype(np.float32))
    us0 = torch.zeros((64, 50, 1))
    cfg = ILQRConfig(iterations=5)
    card_s, r_card = wall_s(lambda: ilqr.solve_batched(cartpole, x0.to(dev), us0.to(dev), cfg))
    r_cpu = ilqr.solve_batched(cartpole, x0, us0, cfg)
    errs = solver_close(r_card, r_cpu, "cartpole 64 x H=50, 5 iterations")
    out["card_vs_cpu"] = {"batch": 64, "horizon": 50, "iterations": 5, "cost_rel_err": errs[0],
                          "us_abs_err": errs[1], "card_s": card_s}
    log(f"solver check: cartpole 64 x 50 on the card against the CPU: {out['card_vs_cpu']}")

    # Float32 on the card against float64 on the CPU (tests/test_numerical_parity.py).
    x0p = torch.tensor([0.4, 0.0])
    r32 = ilqr.solve(pendulum, x0p.to(dev), torch.zeros((40, 1), device=dev),
                     ILQRConfig(iterations=20))
    r64 = ilqr.solve(pendulum, x0p.double(), torch.zeros((40, 1), dtype=torch.float64),
                     ILQRConfig(iterations=20))
    cost_rel = abs(float(r32.cost) - float(r64.cost)) / float(r64.cost)
    check(r32.us.dtype == torch.float32 and r32.us.device.type == dev.type, "the f32 solve left the card")
    check(cost_rel < 1e-3, f"pendulum f32 cost {cost_rel} (relative) from float64")
    np.testing.assert_allclose(r32.us.cpu().numpy(), r64.us.numpy(), rtol=0.05, atol=0.05,
                               err_msg="pendulum f32 controls against float64")
    out["f32_vs_f64"] = {"cost_rel_err": cost_rel,
                         "us_abs_err": float((r32.us.cpu().double() - r64.us).abs().max())}
    log(f"solver check: pendulum f32 (card) against f64 (CPU): {out['f32_vs_f64']}")

    # Full width, timed: one warm-up call (one iteration) first.  The
    # cartpole solve runs under sync debug mode "error".
    def batched(system, shape, key, x0b=None):
        batch, horizon = shape
        if x0b is None:
            x0b = torch.from_numpy((0.2 * rng.standard_normal((batch, system.nx))).astype(np.float32)).to(dev)
        usb = torch.zeros((batch, horizon, system.nu), device=dev)
        warm_s, _ = wall_s(lambda: ilqr.solve_batched(system, x0b, usb, ILQRConfig(iterations=1)))
        error_mode = key in ("cartpole", "sm_pendulum")
        solve_s, res = wall_s(
            lambda: ilqr.solve_batched(system, x0b, usb, ILQRConfig(iterations=SOLVE_ITERS)),
            sync_debug="error" if error_mode else None)
        init = torch.func.vmap(lambda x, u: ilqr.trajectory_cost(
            system, ilqr.rollout(system.step, x, u), u))(x0b, usb)
        trace = res.cost_trace
        check(bool(torch.isfinite(res.cost).all()) and bool(torch.isfinite(trace).all()),
              f"{key}: non-finite costs")
        check(bool((trace[:, 1:] <= trace[:, :-1]).all()), f"{key}: cost_trace increased")
        check(bool((res.cost <= init + 1e-6 * init.abs()).all())
              and float(res.cost.sum()) < float(init.sum()),
              f"{key}: final cost not below the initial one")
        row = {"batch": batch, "horizon": horizon, "iterations": SOLVE_ITERS,
               "wall_s": solve_s, "solves_per_s": batch / solve_s,
               "s_per_iteration": solve_s / SOLVE_ITERS, "warmup_1_iteration_s": warm_s,
               "sync_debug_mode": "error" if error_mode else "default",
               "mean_initial_cost": float(init.mean()), "mean_final_cost": float(res.cost.mean()),
               "improved_share": float((res.cost < init).double().mean())}
        log(f"solver {key} {batch} x H={horizon}, {SOLVE_ITERS} iterations on {card}: {row}")
        return row, res

    out["cartpole"], rc = batched(cartpole, CARTPOLE, "cartpole")

    # Where one cartpole iteration's time goes: each stage once at full
    # width on the solved trajectory, and the Riccati step's torch ops
    # (dispatched) and kernels (profiled) at full width.
    cfg = ILQRConfig()
    stages = {}
    stages["linearize_soa"], lin = wall_s(lambda: ilqr.linearize_soa(cartpole, rc.xs, rc.us))
    A, B, lx, lu, lxx, luu, lux, VxT, VxxT = lin
    stages["psd_cost_hessians"], psd = wall_s(
        lambda: ilqr.psd_cost_hessians(lxx, luu, lux, VxxT, "clamp_diag", cfg.psd_eps))
    lxx, luu, lux, VxxT = psd
    reg = torch.full((CARTPOLE[0],), cfg.reg_init, device=dev)
    stages["backward_sequential_soa"], gains = wall_s(
        lambda: ilqr.backward_sequential_soa(A, B, lx, lu, lxx, luu, lux, VxT, VxxT, reg))
    stages["forward_linesearch_soa"], _ = wall_s(
        lambda: ilqr.forward_linesearch_soa(cartpole, rc.xs, rc.us, *gains, cfg.alphas))
    from torch.utils._python_dispatch import TorchDispatchMode

    class CountOps(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += 1
            return func(*args, **(kwargs or {}))

    with CountOps() as ops:
        ilqr.backward_sequential_soa(A, B, lx, lu, lxx, luu, lux, VxT, VxxT, reg)
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        ilqr.backward_sequential_soa(A, B, lx, lu, lxx, luu, lux, VxT, VxxT, reg)
        torch.cuda.synchronize()
    kernels = sum(1 for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA)
    busy_ms = sum(e.time_range.elapsed_us() for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    H = CARTPOLE[1]
    out["cartpole"]["stages_s"] = stages
    out["cartpole"]["riccati_step"] = {
        "torch_ops": ops.n / H, "kernels": kernels / H if kernels else None,
        "device_busy_ms": busy_ms / H if kernels else None,
        "wall_ms": 1e3 * stages["backward_sequential_soa"] / H}
    log(f"cartpole iteration by stage on {card}: {stages}; per Riccati step: "
        f"{out['cartpole']['riccati_step']}")

    x0p = torch.from_numpy((0.2 * rng.standard_normal((PENDULUM[0], 2))).astype(np.float32)).to(dev)
    out["pendulum"], r_native = batched(pendulum, PENDULUM, "pendulum", x0p)

    # BASELINE.json config 2 in the north star's form: the same pendulum
    # batch, its dynamics and costs written in the sm API
    # (models.make_sm_pendulum), through solve_batched: linearize_soa's jvp
    # and forward-over-reverse and rollout_b's vmap run its sm ops through
    # ops/autodiff.py on the kernels, under sync debug mode "error".  Held to
    # the native solve of the same inputs at the CPU tests' tolerance.
    elementwise.reset_launches()
    reduction.reset_launches()
    dispatch.reset()
    out["sm_pendulum"], r_sm = batched(make_sm_pendulum(), PENDULUM, "sm_pendulum", x0p)
    sm_launches = {**elementwise.LAUNCHES, **reduction.LAUNCHES}
    counts = dispatch.counts()
    check(elementwise.LAUNCHES["ew_flat"] + elementwise.LAUNCHES["ew_strided"] > 0,
          f"the sm pendulum solve launched no elementwise kernel: {sm_launches}")
    check(not any(k.startswith("torch_path") for k in counts),
          f"the sm pendulum solve took the plain torch route: "
          f"{ {k: v for k, v in counts.items() if k.startswith('torch_path')} }")
    transforms = sum(v for k, v in counts.items() if k.startswith("transform:"))
    check(transforms > 0, "the sm pendulum solve ran no sm op under a transform")
    native_cpu = ilqr.ILQRResult(*(t.cpu() for t in r_native))
    cost_err, u_err = solver_close(r_sm, native_cpu, "sm pendulum against the native pendulum")
    c_sm, c_nat = r_sm.cost.double().cpu(), r_native.cost.double().cpu()
    u_sm, u_nat = r_sm.us.double().cpu(), r_native.us.double().cpu()
    strict = float(((u_sm - u_nat).abs() - (1e-3 * u_nat.abs() + 1e-4)).clamp(min=0).max())
    out["sm_pendulum"].update({
        "launches": sm_launches, "transform_calls": transforms,
        "cost_rel_err_vs_native": cost_err, "us_abs_err_vs_native": u_err,
        "us_beyond_rtol_1e-3_atol_1e-4": strict,
        "max_abs_control": float(u_nat.abs().max()),
        "native_solves_per_s": out["pendulum"]["solves_per_s"],
        "over_native": out["sm_pendulum"]["wall_s"] / out["pendulum"]["wall_s"]})
    check(float(((c_sm - c_nat).abs() / c_nat.abs()).max()) <= 1e-4, "sm pendulum costs")
    log(f"sm pendulum (config 2) against the native pendulum on {card}: {out['sm_pendulum']}")

    # Quadrotor RTI: the time of a tick is the difference of two closed-loop
    # lengths over their difference in ticks (bench.py::bench_quadrotor_replan).
    # Phase 8 times the eager loops (graphs.eager()), as before the compiled
    # entry points; phase 11 times them compiled beside the eager ones.
    x0q = torch.from_numpy((0.1 * rng.standard_normal(12)).astype(np.float32)).to(dev)
    with graphs.eager():
        rti.rti_closed_loop(quad, x0q, QUAD_H, 2)
        loops = {}
        for ticks in RTI_TICKS:
            loops[ticks], res = wall_s(lambda: rti.rti_closed_loop(quad, x0q, QUAD_H, ticks))
            check(bool(torch.isfinite(res[2]).all()), f"RTI quadrotor {ticks} ticks: non-finite costs")
        tick_ms = 1e3 * (loops[RTI_TICKS[1]] - loops[RTI_TICKS[0]]) / (RTI_TICKS[1] - RTI_TICKS[0])
        out["quadrotor_rti"] = {"horizon": QUAD_H, "ticks": list(RTI_TICKS),
                                "wall_s": [loops[t] for t in RTI_TICKS], "per_tick_ms": tick_ms,
                                "budget_ms": 1.0, "within_budget": tick_ms <= 1.0}
        log(f"quadrotor RTI H={QUAD_H} on {card}: {out['quadrotor_rti']}")

        ctrl = MPCController(quad, horizon=QUAD_H, replan_iters=2)
        ctrl.replan(x0q)
        times = []
        for _ in range(5):
            t, (u0, cost) = wall_s(lambda: ctrl.replan(x0q))
            check(bool(torch.isfinite(u0).all()) and np.isfinite(float(cost)), "replan: non-finite")
            times.append(1e3 * t)
        out["quadrotor_replan"] = {"horizon": QUAD_H, "iterations": 2, "ms": statistics.median(times),
                                   "ms_all": times, "budget_ms": 1.0}
        log(f"quadrotor MPCController.replan H={QUAD_H} on {card}: {out['quadrotor_replan']}")

        step, args = port_entry.entry()
        check(all(a.device.type == dev.type for a in args), "entry() built its arguments off the card")
        step(*args)
        times = []
        for _ in range(3):
            t, cost = wall_s(lambda: step(*args))
            check(tuple(cost.shape) == (32,) and bool(torch.isfinite(cost).all()), "entry(): bad cost")
            times.append(1e3 * t)
    out["entry"] = {"batch": 32, "horizon": 20, "iterations": 3, "wall_ms": statistics.median(times),
                    "wall_ms_all": times}
    log(f"entry() on {card}: {out['entry']}")

    # The sm-expressed pendulum, a forward rollout with no AD, batch-minor:
    # the public sm API on the card launches the port's elementwise kernels.
    batch, horizon = SM_ROLLOUT
    sm_step = make_sm_pendulum().step
    xs0 = torch.from_numpy((0.2 * rng.standard_normal((2, batch))).astype(np.float32)).to(dev)
    us_r = torch.from_numpy((0.5 * rng.standard_normal((horizon, 1, batch))).astype(np.float32)).to(dev)

    def sm_rollout():
        x = xs0
        for t in range(horizon):
            x = sm_step(x, us_r[t])
        return x

    def plain_rollout():
        x = xs0
        for t in range(horizon):
            x = pendulum.step(x, us_r[t])
        return x

    sm_rollout(), plain_rollout()  # warm-up: NVRTC compiles each new signature once
    elementwise.reset_launches()
    dispatch.reset()
    sm_s, x_sm = wall_s(sm_rollout)
    sm_launches, sm_paths, counts = dict(elementwise.LAUNCHES), dict(elementwise.PATHS), dispatch.counts()
    plain_s, x_plain = wall_s(plain_rollout)
    err = float((x_sm - x_plain).abs().max())
    check(sm_launches["ew_flat"] + sm_launches["ew_strided"] > 0,
          f"the sm rollout launched no elementwise kernel: {sm_launches}")
    check(not any(k.startswith("torch_path") for k in counts),
          f"the sm rollout took the plain torch route: {counts}")
    # States of about 0.2-1 after 50 steps; the crafted sin is within 2 ulp
    # of torch.sin, everything else exact.
    check(err <= 1e-5, f"the sm rollout is {err} from the plain torch rollout")
    out["sm_rollout"] = {"batch": batch, "horizon": horizon, "launches": sm_launches,
                         "ew_strided_paths": sm_paths, "ms": 1e3 * sm_s, "plain_ms": 1e3 * plain_s,
                         "max_abs_err": err,
                         "dispatch": {k: v for k, v in counts.items() if k.startswith("engine")}}
    log(f"sm pendulum rollout on {card}: {out['sm_rollout']}")
    return out


# ---------------------------------------------------------------- phase 9
# The parallel layer (simplemath_tpu_torch.parallel): worlds of processes of
# this script (``--rank``), one device a rank.
SHARDED_CARTPOLE = CARTPOLE  # BASELINE.json config 3's width, 10 iterations
SCENARIO_MPC = (1024, QUAD_H, 3)  # scenarios (a count chosen here), horizon, iterations
HORIZON_H = 100            # 101 elements over 2 ranks: the identity-padding path
RANKS = 2
WORLD_TIMEOUT = 420


def _rank_args(argv):
    opts = dict(zip(argv[::2], argv[1::2]))
    return (int(opts["--rank"]), int(opts["--world"]), opts["--port"], opts["--backend"],
            opts["--device"], opts["--out"], opts.get("--parts", "all").split(","))


def _sync(dev):
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize()


def _timed(dev, fn):
    """(wall seconds of ``fn()`` ended by a synchronize after a barrier, its
    result)."""
    import torch.distributed as dist

    _sync(dev)
    dist.barrier()
    t0 = time.perf_counter()
    out = fn()
    _sync(dev)
    return time.perf_counter() - t0, out


def _kernel_cases(dev, n, rng):
    """The nine workloads of tests/test_kernels_sharded.py for a mesh of
    ``n`` ranks: name -> (kernel, the sm function of a rank's blocks, its
    plain torch version of the global inputs, in-specs, out-spec, the
    global inputs, rtol, atol).  A reduction (out-spec ``P()``) gives each
    rank's partial, which the rank psums; the others' blocks are
    gathered."""
    import torch
    import simplemath_tpu_torch as sm
    from simplemath_tpu_torch.parallel.mesh import PartitionSpec as P

    S, R = P("scenario"), P()

    def t(*shape, lo=None, hi=None, scale=1.0, dtype=torch.float32):
        x = rng.uniform(lo, hi, shape) if lo is not None else rng.standard_normal(shape) * scale
        return torch.from_numpy(x.astype(np.float32)).to(dev).to(dtype)

    f64, bf = torch.float64, torch.bfloat16
    fused = sm.fuse(lambda x, y: sm.exp(sm.pow(x, y)))
    product = sm.fuse(lambda x, y: x @ y)
    layer = sm.fuse(lambda x, w, b: sm.maximum(x @ w + b, 0.0))
    return {
        "add": ("ew_flat", lambda a, b: sm.add(sm.Array(a), sm.Array(b)).torch(),
                lambda a, b: a + b, (S, S), S, [t(n * 512, 1024), t(n * 512, 1024)], 0, 0),
        "fused_exp_pow": ("ew_flat", lambda a, e: fused(a, e).torch(),
                          lambda a, e: torch.exp(torch.pow(a.to(f64), e.to(f64))), (S, S), S,
                          [t(n * 512, 1024, lo=0.5, hi=2.0), t(n * 512, 1024, lo=-1, hi=1)],
                          3e-5, 0),
        "sum": ("rd_full", lambda x: sm.Array(x).sum().torch(),
                lambda x: x.to(f64).sum(), (S,), R, [t(n * 1024, 1000)], 1e-5, 1e-3),
        "mm_bf16": ("mm", lambda a, b: product(a, b).torch(),
                    lambda a, b: a.to(f64) @ b.to(f64), (S, R), S,
                    [t(n * 1024, 1024, scale=1 / 32, dtype=bf),
                     t(1024, 1024, scale=1 / 32, dtype=bf)], 2.0 ** -7, 1e-4),
        "bmm_bf16": ("bmm", lambda a, b: product(a, b).torch(),
                     lambda a, b: a.to(f64) @ b.to(f64), (S, S), S,
                     [t(n * 4, 512, 512, scale=1 / 16, dtype=bf),
                      t(n * 4, 512, 512, scale=1 / 16, dtype=bf)], 2.0 ** -7, 1e-4),
        "dot": ("rd_full", lambda a, b: sm.dot(sm.Array(a), sm.Array(b)).torch(),
                lambda a, b: torch.dot(a.to(f64), b.to(f64)), (S, S), R,
                [t(n * (1 << 20)), t(n * (1 << 20))], 1e-5, 1e-2),
        "matmul_epilogue": ("mm", lambda x, w, b: layer(x, w, b).torch(),
                            lambda x, w, b: torch.clamp_min(x.to(f64) @ w.to(f64) + b.to(f64), 0.0),
                            (S, R, R), S, [t(n * 1024, 512), t(512, 512), t(1, 512)], 1e-4, 1e-3),
        "axis_sum": ("rd_axis", lambda a: sm.array(a).sum(axis=1).torch(),
                     lambda a: a.to(f64).sum(dim=1), (S,), S, [t(n * 1024, 1024)], 1e-4, 1e-4),
        "transposed_view_add": ("ew_strided", lambda a, b: sm.add(sm.Array(a).T, sm.Array(b)).torch(),
                                lambda a, b: a.T + b, (P(None, "scenario"), S), S,
                                [t(1024, n * 512), t(n * 512, 1024)], 0, 0),
    }


def _rank_kernels(dev, mesh, rng):
    """The nine workloads inside this rank: each on its kernel (launches of
    the call alone counted), followed by a collective (the psum of the
    reductions' partials; of each rank's block sum for the others), held
    against its plain version on the global inputs."""
    import torch
    import torch.distributed as dist
    from simplemath_tpu_torch import parallel
    from simplemath_tpu_torch.ops import elementwise, matmul, reduction
    from simplemath_tpu_torch.parallel.mesh import PartitionSpec as P

    out = {}
    cases = _kernel_cases(dev, mesh.shape["scenario"], rng)
    for name, (kernel, fn, plain, specs, out_spec, args, rtol, atol) in cases.items():
        def body(*blocks):
            y = fn(*blocks)
            if out_spec == P():  # a partial of the reduction
                y = parallel.psum(y, "scenario")
                return y, y.double()
            return y, parallel.psum(torch.sum(y.double()), "scenario")

        elementwise.reset_launches()
        reduction.reset_launches()
        matmul.reset_launches()
        y, total = parallel.shard_map(body, mesh=mesh, in_specs=specs,
                                      out_specs=(out_spec, P()))(*args)
        _sync(dev)
        launches = {**elementwise.LAUNCHES, **reduction.LAUNCHES, **matmul.LAUNCHES}
        want = plain(*args).double()
        d = (y.double() - want).abs()
        err = float(d.max())
        check(bool((d <= atol + rtol * want.abs()).all()),
              f"{name}: {err} from its plain version, rank {dist.get_rank()}")
        whole = float(y.double().sum())  # the gathered blocks' sum, in float64
        check(abs(float(total) - whole) <= 1e-9 * abs(whole) + 1e-9,
              f"{name}: the collective gave {float(total)} against {whole}")
        if dev.type == "cuda":
            check(launches[kernel] > 0, f"{name}: no {kernel} launch in rank {dist.get_rank()}: {launches}")
        out[name] = {"kernel": kernel, "launches": launches[kernel], "max_abs_err": err,
                     "collective": float(total)}
    return out


def _consensus_checks(system, x0, us, us_new, history, what):
    """The scenario MPC's own checks: the consensus first control the same
    on every scenario, the consensus cost never rising, the first cost not
    above the initial controls' cost."""
    import torch
    from simplemath_tpu_torch.models import ilqr

    u0 = us_new[:, 0, :]
    spread = float((u0 - u0[:1]).abs().max())
    check(spread <= 1e-6 * max(1.0, float(u0.abs().max())),
          f"{what}: the consensus u0 differs across scenarios by {spread}")
    check(all(b <= a + 1e-5 * abs(a) for a, b in zip(history, history[1:])),
          f"{what}: the consensus cost rose: {history}")
    init = float(torch.func.vmap(lambda x, u: ilqr.trajectory_cost(
        system, ilqr.rollout(system.step, x, u), u))(x0, us).sum())
    check(history[0] <= init + 1e-5 * abs(init), f"{what}: {history[0]} above {init}")
    return {"initial_cost": init, "u0_spread": spread}


SHARDED_ROUNDS = 1  # rounds of eager, compiled, compiled, eager of each phase-9 compiled workload


def _rank_compiled(dev, mesh, on, saved):
    """Phase 9's compiled part, in an NCCL world: the sharded train step of
    the cartpole (8192 x H=100) and of the sm pendulum (4096 x H=50), 10
    iterations, and scenario_mpc_solve of the quadrotor (1024 x H=50, 3
    iterations), each compiled against its eager loop (graphs.eager()) in
    rounds of eager, compiled, compiled, eager, as phase 11 runs its
    workloads (compiled_workload): the compiled results the eager bits,
    every compiled call after the first under sync debug mode "error" (for
    the scenario solve its step's replays, since it reads each total on
    the host), the collectives recorded a replay; the sharded solves'
    results go to the parent, which holds them to the unsharded ones."""
    import contextlib

    import torch
    from simplemath_tpu_torch import parallel
    from simplemath_tpu_torch.models import (
        ILQRConfig, ilqr, make_cartpole, make_quadrotor, make_sm_pendulum, sqp_mpc,
    )
    from simplemath_tpu_torch.parallel import collectives, sharded
    from simplemath_tpu_torch.parallel.mesh import PartitionSpec as P
    from simplemath_tpu_torch.utils import graphs

    card = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    cfg = ILQRConfig(iterations=SOLVE_ITERS)
    out = {}
    solves = (ilqr._BATCHED_INIT, ilqr._BATCHED_ITERATIONS, sharded._STATS_AND_GATHERS)
    for key, system, prefix in (("cartpole", make_cartpole(), "cartpole"),
                                ("sm_pendulum", make_sm_pendulum(), "sm")):
        x0, us = on(f"{prefix}_x0"), on(f"{prefix}_us")
        step = parallel.make_sharded_train_step(system, mesh, cfg, "scenario")

        def eager(step=step, x0=x0, us=us):
            with graphs.eager():
                return step(x0, us)

        row, (r, stats) = compiled_workload(
            f"sharded {key}", card, solves, eager, lambda step=step, x0=x0, us=us: step(x0, us),
            lambda t, n=x0.shape[0]: n / t, SHARDED_ROUNDS, profiled=ilqr._BATCHED_ITERATIONS)
        check(row["collectives"].get("psum", 0) > 0 and row["collectives"].get("all_gather", 0) > 0,
              f"sharded {key}: its graphs hold no collective: {row['collectives']}")
        if key == "sm_pendulum" and dev.type == "cuda":
            for name in ("ew_flat", "ew_strided"):
                check(row["launches"].get(name, 0) > 0,
                      f"the sharded sm pendulum's graphs hold no {name} launch: {row['launches']}")
        # Where a compiled call's time goes: the rank's block solved alone
        # (the step's own graphs) and the statistics-and-gathers program
        # alone, each the median of 3 calls after one untimed.
        xb, ub = collectives.local_blocks(mesh, (P("scenario"), P("scenario")), (x0, us))
        block = ilqr.solve_batched_jit(system, xb, ub, cfg)
        static = (system, mesh, ("scenario",), cfg, x0.shape[0])
        for name, fn in (("block_solve_s", lambda: ilqr.solve_batched_jit(system, xb, ub, cfg)),
                         ("stats_and_gathers_s",
                          lambda: sharded._STATS_AND_GATHERS(static, *block))):
            fn()
            row[name] = statistics.median(wall_s(fn, sync_debug="error")[0] for _ in range(3))
        saved.update({f"compiled_{prefix}_cost": r.cost, f"compiled_{prefix}_us": r.us,
                      f"compiled_{prefix}_total": stats["total_cost"]})
        row.update({"batch": x0.shape[0], "horizon": us.shape[1], "iterations": SOLVE_ITERS,
                    "rate": "solves/s"})
        out[key] = row

    quad = make_quadrotor()
    x0, us = on("mpc_x0"), on("mpc_us")
    iters = SCENARIO_MPC[2]

    def solve():
        return sqp_mpc.scenario_mpc_solve(quad, x0, us, mesh, iterations=iters)

    def solve_eager():
        with graphs.eager():
            return solve()

    @contextlib.contextmanager
    def replays_checked():
        # The step's calls (copies in, the replay, clones out) under sync
        # debug mode "error"; the solve reads each total between them.
        program = sqp_mpc._SCENARIO_STEP

        def step(*args):
            torch.cuda.set_sync_debug_mode("error")
            try:
                return program(*args)
            finally:
                torch.cuda.set_sync_debug_mode("default")

        sqp_mpc._SCENARIO_STEP = step
        try:
            yield
        finally:
            sqp_mpc._SCENARIO_STEP = program

    def checked():
        with replays_checked():
            return wall_s(solve)

    row, (us_new, du0, history) = compiled_workload(
        "scenario MPC", card, (sqp_mpc._SCENARIO_STEP,), solve_eager, solve,
        lambda t: 1e3 * t / iters, SHARDED_ROUNDS, checked=checked)
    check(row["collectives"].get("psum", 0) == 3,
          f"the consensus step's graph holds {row['collectives']}, not its three psums")
    row.update(_consensus_checks(quad, x0, us, us_new, history, "compiled scenario MPC"))
    row.update({"scenarios": x0.shape[0], "horizon": us.shape[1], "iterations": iters,
                "history": history, "du0": du0.cpu().tolist(), "rate": "ms a consensus step"})
    out["scenario_mpc"] = row
    return out


def rank_main(argv):
    """One rank of a phase-9 world: joins it, runs its parts and prints one
    JSON line of results; rank 0 writes the sharded solves' results to
    ``--out`` for the parent to hold against the unsharded ones."""
    rank, world, port, backend, device, out_dir, parts = _rank_args(argv)
    import torch
    import torch.distributed as dist

    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=world)
    import simplemath_tpu_torch as sm
    from simplemath_tpu_torch import _build, parallel
    from simplemath_tpu_torch.models import (
        ILQRConfig, ilqr, make_cartpole, make_quadrotor, make_sm_pendulum,
    )
    from simplemath_tpu_torch.models import sqp_mpc
    from simplemath_tpu_torch.models.sqp_mpc import make_scenario_mpc_step, scenario_mpc_solve
    from simplemath_tpu_torch.ops import codegen, dispatch, elementwise
    from simplemath_tpu_torch.parallel import collectives
    from simplemath_tpu_torch.utils import graphs

    check("jax" not in sys.modules, "a rank imported jax")
    sm.configure(device=device)
    res = {"rank": rank, "world": world, "backend": backend, "device": device}
    if dev.type == "cuda":
        _build.library()
        res["kernel_library_rebuilt"] = _build.BUILD_SECONDS is not None
    inputs = dict(np.load(os.path.join(out_dir, "inputs.npz")))
    mesh = parallel.make_mesh()
    saved = {}
    cfg = ILQRConfig(iterations=SOLVE_ITERS)

    def on(name):
        return torch.from_numpy(inputs[name]).to(dev)

    if "cartpole" in parts:
        cartpole = make_cartpole()
        x0, us = on("cartpole_x0"), on("cartpole_us")
        warm_s, _ = _timed(dev, lambda: parallel.solve_batched_sharded(
            cartpole, x0, us, ILQRConfig(iterations=1), mesh))
        collectives.COUNTS.clear()
        wall, (r, stats) = _timed(dev, lambda: parallel.solve_batched_sharded(
            cartpole, x0, us, cfg, mesh))
        saved.update(cartpole_cost=r.cost, cartpole_us=r.us, cartpole_total=stats["total_cost"])
        res["cartpole"] = {"batch": x0.shape[0], "per_rank": x0.shape[0] // world,
                           "horizon": us.shape[1], "iterations": SOLVE_ITERS, "wall_s": wall,
                           "solves_per_s": x0.shape[0] / wall, "warmup_1_iteration_s": warm_s,
                           "collectives": dict(collectives.COUNTS),
                           "total_cost": float(stats["total_cost"])}
    if "horizon" in parts:
        cartpole = make_cartpole()
        hus = 0.01 * torch.ones((HORIZON_H, 1), device=dev)
        xs = ilqr.rollout(cartpole.step, torch.zeros(4, device=dev), hus)
        A, B, lx, lu, lxx, luu, lux, VxT, VxxT = ilqr.linearize(cartpole, xs, hus)
        lxx, luu, lux, VxxT = ilqr.psd_cost_hessians(lxx, luu, lux, VxxT, "clamp_diag", 1e-6)
        args = (A, B, lx, lu, lxx, luu, lux, VxT, VxxT, torch.tensor(1e-6, device=dev))
        hmesh = parallel.make_mesh((world,), ("h",))
        parallel.backward_associative_sharded(hmesh, "h", *args)
        wall, (ks, Ks) = _timed(dev, lambda: parallel.backward_associative_sharded(hmesh, "h", *args))
        ref_s, (rk, rK) = _timed(dev, lambda: ilqr.backward_associative(*args))
        errs = []
        for got, want, what in ((ks, rk, "ks"), (Ks, rK, "Ks")):
            d = (got.double() - want.double()).abs()
            errs.append(float(d.max()))
            check(bool((d <= 1e-6 + 1e-5 * want.double().abs()).all()),
                  f"horizon-sharded {what} {errs[-1]} from backward_associative")
        res["horizon"] = {"horizon": HORIZON_H, "elements": HORIZON_H + 1, "ranks": world,
                          "padded_to": -(-(HORIZON_H + 1) // world) * world, "ms": 1e3 * wall,
                          "one_device_ms": 1e3 * ref_s, "max_abs_err": max(errs)}
    if "mpc" in parts:
        quad = make_quadrotor()
        x0, us = on("mpc_x0"), on("mpc_us")
        step = make_scenario_mpc_step(quad, mesh)
        warm_s, _ = _timed(dev, lambda: step(x0, us))
        # scenario_mpc_solve is compiled; gloo cannot be captured, so this
        # world runs it eagerly (graphs.eager()), and the compiled call
        # must refuse it before building anything.
        with graphs.eager():
            wall, (us_new, du0, history) = _timed(dev, lambda: scenario_mpc_solve(
                quad, x0, us, mesh, iterations=SCENARIO_MPC[2]))
        row = _consensus_checks(quad, x0, us, us_new, history, "scenario MPC")
        refused = ""
        if dev.type == "cuda":
            try:
                scenario_mpc_solve(quad, x0, us, mesh, iterations=1)
            except graphs.CaptureError as e:
                refused = str(e)
            check("gloo" in refused and not sqp_mpc._SCENARIO_STEP.cached(),
                  f"the compiled scenario solve did not refuse a gloo mesh on the card: {refused!r}")
        res["scenario_mpc"] = {"scenarios": x0.shape[0], "per_rank": x0.shape[0] // world,
                               "horizon": us.shape[1], "iterations": SCENARIO_MPC[2],
                               **row, "history": history,
                               "ms_per_consensus_step": 1e3 * wall / SCENARIO_MPC[2],
                               "first_step_ms": 1e3 * warm_s, "du0": du0.cpu().tolist(),
                               "compiled_on_gloo_refused": refused}
    if "sm_pendulum" in parts:
        sm_pend = make_sm_pendulum()
        x0, us = on("sm_x0"), on("sm_us")
        _timed(dev, lambda: parallel.solve_batched_sharded(sm_pend, x0, us, ILQRConfig(iterations=1), mesh))
        elementwise.reset_launches()
        dispatch.reset()
        stats0 = dict(codegen.STATS)
        wall, (r, stats) = _timed(dev, lambda: parallel.solve_batched_sharded(sm_pend, x0, us, cfg, mesh))
        launches, counts = dict(elementwise.LAUNCHES), dispatch.counts()
        if dev.type == "cuda":
            check(launches["ew_flat"] > 0 and launches["ew_strided"] > 0,
                  f"the sharded sm pendulum launched {launches} in rank {rank}")
        check(not any(k.startswith("torch_path") for k in counts),
              f"the sharded sm pendulum took the plain torch route in rank {rank}")
        saved.update(sm_cost=r.cost, sm_us=r.us)
        res["sm_pendulum"] = {"batch": x0.shape[0], "per_rank": x0.shape[0] // world,
                              "horizon": us.shape[1], "iterations": SOLVE_ITERS, "wall_s": wall,
                              "solves_per_s": x0.shape[0] / wall, "launches": launches,
                              "nvrtc": {k: codegen.STATS[k] - stats0[k] for k in stats0}}
    if "kernels" in parts:
        res["kernels"] = _rank_kernels(dev, mesh, np.random.default_rng(SEED + 90))
    if "compiled" in parts:
        res["compiled"] = _rank_compiled(dev, mesh, on, saved)
    res["nvrtc_since_start"] = dict(codegen.STATS)
    if rank == 0 and saved:
        np.savez(os.path.join(out_dir, f"world{world}_{backend}.npz"),
                 **{k: v.detach().cpu().numpy() for k, v in saved.items()})
    res["graphs_released"] = graphs.release()  # before the group: its graphs hold NCCL work
    dist.barrier()
    dist.destroy_process_group()
    print(json.dumps({"rank_result": res}), flush=True)
    return 0


def _world(n, backend, device, out_dir, parts):
    """Run ``n`` ranks of this script; returns their results.  A rank that
    fails or outlives WORLD_TIMEOUT fails the phase, every rank killed."""
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    # Each rank's output goes to a file: a rank blocked on a full pipe would
    # stall the collectives of the others.
    logs = [(open(os.path.join(out_dir, f"{backend}{n}_rank{r}.out"), "w+"),
             open(os.path.join(out_dir, f"{backend}{n}_rank{r}.err"), "w+")) for r in range(n)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--rank", str(r), "--world", str(n),
         "--port", str(port), "--backend", backend, "--device", device, "--out", out_dir,
         "--parts", ",".join(parts)],
        stdout=so, stderr=se, cwd=os.path.dirname(os.path.abspath(__file__)))
        for r, (so, se) in enumerate(logs)]
    outs, failed = [], []
    deadline = time.perf_counter() + WORLD_TIMEOUT
    try:
        for r, p in enumerate(procs):
            try:
                p.wait(timeout=max(1.0, deadline - time.perf_counter()))
            except subprocess.TimeoutExpired:
                failed.append(f"rank {r} of the {backend} world ran past {WORLD_TIMEOUT} s")
                continue
            for f in logs[r]:
                f.seek(0)
            so, se = (f.read() for f in logs[r])
            lines = [ln for ln in so.splitlines() if ln.startswith('{"rank_result"')]
            if p.returncode != 0 or not lines:
                failed.append(f"rank {r} of the {backend} world exited {p.returncode}:\n"
                              f"{se[-3000:]}")
            else:
                outs.append(json.loads(lines[-1])["rank_result"])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for so, se in logs:
            so.close()
            se.close()
    check(not failed, "\n".join(failed))
    return outs


def _close(got, want, what, rtol=1e-5, atol=1e-6):
    """``got`` within ``rtol``/``atol`` of ``want``; returns the largest
    difference."""
    d = np.abs(got.astype(np.float64) - want.astype(np.float64))
    err = float(d.max())
    check(bool((d <= atol + rtol * np.abs(want.astype(np.float64))).all()),
          f"{what}: {err} from the unsharded solve")
    return err


def parallel_phase(dev, card):
    """Phase 9: the parallel layer on the card.  The parent (this process)
    makes the inputs, solves them unsharded (which also builds what the
    ranks load: the kernel library at phase 2, the generated kernels' CUBINs
    here), then runs two worlds: NCCL over one rank, and two ranks on the
    one card over gloo (NCCL takes one rank a device)."""
    import tempfile

    import torch
    from simplemath_tpu_torch.models import ILQRConfig, ilqr, make_cartpole, make_sm_pendulum

    rng = np.random.default_rng(SEED + 9)
    batch, horizon = SHARDED_CARTPOLE
    n_mpc, h_mpc, _ = SCENARIO_MPC
    inputs = {
        "cartpole_x0": (0.2 * rng.standard_normal((batch, 4))).astype(np.float32),
        "cartpole_us": np.zeros((batch, horizon, 1), np.float32),
        "sm_x0": (0.2 * rng.standard_normal((PENDULUM[0], 2))).astype(np.float32),
        "sm_us": np.zeros((PENDULUM[0], PENDULUM[1], 1), np.float32),
        "mpc_x0": (0.1 * rng.standard_normal((n_mpc, 12))).astype(np.float32),
        "mpc_us": np.zeros((n_mpc, h_mpc, 4), np.float32),
    }
    out = {"card": card}
    cfg = ILQRConfig(iterations=SOLVE_ITERS)
    with tempfile.TemporaryDirectory() as out_dir:
        np.savez(os.path.join(out_dir, "inputs.npz"), **inputs)
        on = {k: torch.from_numpy(v).to(dev) for k, v in inputs.items()}
        ref_s, ref = wall_s(lambda: ilqr.solve_batched(make_cartpole(), on["cartpole_x0"],
                                                       on["cartpole_us"], cfg))
        sm_s, sm_ref = wall_s(lambda: ilqr.solve_batched(make_sm_pendulum(), on["sm_x0"],
                                                         on["sm_us"], cfg))
        out["unsharded"] = {"cartpole_wall_s": ref_s, "sm_pendulum_wall_s": sm_s}
        # The in-rank kernel workloads once here, unsharded, so that their
        # generated kernels' CUBINs are on disk before the ranks start.
        for _, fn, _, _, _, args, _, _ in _kernel_cases(dev, RANKS, np.random.default_rng(SEED)).values():
            fn(*args)
        _sync(dev)
        worlds = {}
        t0 = time.perf_counter()
        worlds["nccl_1"] = _world(1, "nccl", dev.type, out_dir, ["cartpole", "compiled"])
        worlds["gloo_2"] = _world(RANKS, "gloo", dev.type, out_dir,
                                  ["cartpole", "horizon", "mpc", "sm_pendulum", "kernels"])
        out["worlds_s"] = time.perf_counter() - t0
        ref_cost, ref_us = ref.cost.cpu().numpy(), ref.us.cpu().numpy()
        for key, ranks in worlds.items():
            n, backend = len(ranks), ranks[0]["backend"]
            saved = dict(np.load(os.path.join(out_dir, f"world{n}_{backend}.npz")))
            w = {"ranks": n, "backend": backend, "device": ranks[0]["device"],
                 "cartpole": ranks[0]["cartpole"],
                 "cartpole_cost_err": _close(saved["cartpole_cost"], ref_cost, f"{key} costs"),
                 "cartpole_us_err": _close(saved["cartpole_us"], ref_us, f"{key} controls"),
                 "kernel_library_rebuilt": [r.get("kernel_library_rebuilt") for r in ranks],
                 "nvrtc": [r["nvrtc_since_start"] for r in ranks]}
            total = float(saved["cartpole_total"])
            check(abs(total - float(ref_cost.astype(np.float64).sum()))
                  <= 1e-5 * abs(float(ref_cost.sum())),
                  f"{key}: psum total {total} against the unsharded sum")
            w["psum_total"], w["unsharded_sum"] = total, float(ref_cost.astype(np.float64).sum())
            if "sm_pendulum" in ranks[0]:
                w["sm_pendulum"] = [r["sm_pendulum"] for r in ranks]
                w["sm_cost_err"] = _close(saved["sm_cost"], sm_ref.cost.cpu().numpy(),
                                          f"{key} sm pendulum costs")
                w["sm_us_err"] = _close(saved["sm_us"], sm_ref.us.cpu().numpy(),
                                        f"{key} sm pendulum controls")
            for part in ("horizon", "scenario_mpc", "kernels"):
                if part in ranks[0]:
                    w[part] = [r[part] for r in ranks]
            if "compiled" in ranks[0]:
                # The compiled sharded solves, held to the unsharded ones
                # as the eager sharded solve is.
                c = w["compiled"] = ranks[0]["compiled"]
                for prefix, name, want in (("cartpole", "cartpole", ref),
                                           ("sm", "sm_pendulum", sm_ref)):
                    c[name]["cost_err"] = _close(saved[f"compiled_{prefix}_cost"],
                                                 want.cost.cpu().numpy(), f"{key} compiled {name} costs")
                    c[name]["us_err"] = _close(saved[f"compiled_{prefix}_us"],
                                               want.us.cpu().numpy(), f"{key} compiled {name} controls")
                    total = float(saved[f"compiled_{prefix}_total"])
                    whole = float(want.cost.cpu().double().sum())
                    check(abs(total - whole) <= 1e-5 * abs(whole),
                          f"{key}: the compiled {name}'s psum total {total} against {whole}")
            if dev.type == "cuda":
                check(not any(w["kernel_library_rebuilt"]), f"{key}: a rank rebuilt the kernels")
            out[key] = w
            log(f"parallel {key} on {card}: {json.dumps(w)}")
    return out


# ------------------------------------------------------------ phase 10
SERVED_ROUNDS = 3          # rounds of served, compiled, compiled, served of each served solve
ELASTIC_STEPS = 6          # receding-horizon steps of the elastic run, 2 a checkpoint
VIEW_OPS = ("view", "alias", "slice", "expand", "reshape", "unsqueeze", "select", "permute",
            "t", "transpose")   # ops that move no data: what else a kernel's graph may hold
EXAMPLES = ("quickstart", "fused_pipeline", "quantized_views", "batched_cartpole",
            "constrained_pendulum", "mpc_quadrotor", "rti_mpc")

# The whole solve exported as one program, its loops nested scan nodes,
# and served by the loader below: BASELINE config 2 (the sm pendulum, 4096 x
# H=50) as the JAX package's export_solver_step writes it, its 10 iterations
# cut to 3 (the program's nodes are the same at any count; the run's time
# limit): tools/probe_torch_export.py's sm_pendulum_solve takes any depth.
NESTED_SM = (4096, 50, 3)

# Loads each artifact in a process that imports torch and the port alone,
# runs it on the saved inputs, counts the wrappers' launches around each
# call and saves the results (argv: the artifacts' directory).
LOADER = r"""
import json, os, sys, time
import torch
import simplemath_tpu_torch
from simplemath_tpu_torch.ops import elementwise, linalg_small, matmul, reduction
from simplemath_tpu_torch.utils import export
d = sys.argv[1]
sync = torch.cuda.synchronize if torch.cuda.is_available() else (lambda: None)
inputs = torch.load(os.path.join(d, "inputs.pt"))
out, info = {}, {}
for name, args in inputs.items():
    t0 = time.perf_counter()
    run = export.load_step(os.path.join(d, name + ".pt2"))
    load_s = time.perf_counter() - t0
    run(*args)  # the first call: an ew_strided kernel is read from the CUBIN cache here
    sync()
    for w in (elementwise, reduction, matmul, linalg_small):
        w.reset_launches()
    t0 = time.perf_counter()
    out[name] = run(*args)
    sync()
    info[name] = {"load_s": load_s, "call_s": time.perf_counter() - t0,
                  "launches": {**elementwise.LAUNCHES, **reduction.LAUNCHES, **matmul.LAUNCHES,
                               **linalg_small.LAUNCHES},
                  "epilogue_paths": dict(matmul.EPILOGUE_PATHS),
                  "nodes": export.program_nodes(run)}
torch.save(out, os.path.join(d, "outputs.pt"))
mods = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "simplemath_tpu"))
print(json.dumps({"loaded": info, "foreign_modules": mods}))
"""


def _bits_equal(a, b):
    import torch

    return (a.dtype == b.dtype and a.shape == b.shape and
            torch.equal(a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8)))


def _export_cases(dev, rng, sm):
    """(artifact name, function of tensors, its arguments, the sm op it
    must be, the wrapper counter it moves): one call of each kernel
    wrapper at its main-path shape."""
    import torch

    def on(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    def chain(acc, a, e_row):
        return acc * np.float32(1e-3) + sm.exp(sm.pow(a + acc * np.float32(1e-6), e_row))

    fused16 = sm.fuse(chain, donate=0, iterations=16)
    axis0 = sm.fuse(lambda a, s: sm.sum(sm.where(a > s, a, 0.0), axis=0))
    layer = sm.fuse(lambda x, w, bias: sm.maximum(x @ w + bias, 0.0))
    sq = (N_FUSED, N_FUSED)
    x64m = on(rng.standard_normal(N_SUM).astype(np.float32))
    n, (b, m, k) = N_MM, BMM
    return [
        ("ew_strided", lambda acc, a, e: fused16(sm.Array(acc), sm.Array(a), sm.Array(e)).torch(),
         (torch.zeros(sq, device=dev), on(rng.uniform(0.5, 2.0, sq).astype(np.float32)),
          on(rng.uniform(-2.0, 2.0, (1, N_FUSED)).astype(np.float32))), "sm.ew_strided.default",
         "ew_strided"),
        ("ew_flat", lambda a, b_: sm.add(sm.Array(a), sm.Array(b_)).torch(),
         (on(rng.standard_normal(N_ADD).astype(np.float32)),
          on(rng.standard_normal(N_ADD).astype(np.float32))), "sm.ew_flat.default", "ew_flat"),
        ("rd_full", lambda x: sm.Array(x).sum().torch(), (x64m,), "sm.rd_full.default", "rd_full"),
        ("rd_axis", lambda a, s: axis0(sm.Array(a), sm.Array(s)).torch(),
         (x64m.reshape(N_AXIS, N_AXIS), torch.full((1, 1), 0.25, device=dev)),
         "sm.rd_axis.default", "rd_axis"),
        ("mm", lambda x, w, bias: layer(sm.Array(x), sm.Array(w), sm.Array(bias)).torch(),
         tuple(on(rng.standard_normal(s).astype(np.float32)).bfloat16()
               for s in ((n, n), (n, n), (1, n))), "sm.mm.default", "mm"),
        ("bmm", lambda x, w, bias: layer(sm.Array(x), sm.Array(w), sm.Array(bias)).torch(),
         tuple(on(rng.standard_normal(s).astype(np.float32)).bfloat16()
               for s in ((b, m, k), (b, k, m), (1, 1, m))), "sm.bmm.default", "bmm"),
    ]


def _nested_cases(dev, rng):
    """(artifact name, function of tensors, its arguments): the whole solve
    of ``NESTED_SM``, one program whose iteration and horizon loops are
    nested scan nodes."""
    import torch
    from simplemath_tpu_torch.models import ILQRConfig, ilqr, make_sm_pendulum

    pendulum, (b, h, iters) = make_sm_pendulum(), NESTED_SM
    cfg = ILQRConfig(iterations=iters)
    x0 = torch.from_numpy((0.2 * rng.standard_normal((b, 2))).astype(np.float32)).to(dev)
    return [("nested_sm_pendulum", lambda x, u: tuple(ilqr.solve_batched(pendulum, x, u, cfg)[:3]),
             (x0, torch.zeros((b, h, 1), device=dev)))]


def utils_phase(dev, card):
    """Phase 10: the utils on the card.  The six kernel wrappers through
    torch.export and a loaded artifact; the cartpole and the sm pendulum
    solves served from artifacts; elastic checkpoint/resume of a receding-horizon cartpole run;
    profiling, metrics and debug; the examples' twins."""
    import io
    import runpy
    import tempfile

    import torch
    import simplemath_tpu_torch as sm
    from simplemath_tpu_torch.models import ILQRConfig, ilqr, make_cartpole, make_sm_pendulum
    from simplemath_tpu_torch.ops import dispatch, elementwise, library, matmul, reduction
    from simplemath_tpu_torch.utils import (
        ElasticConfig, MetricsLogger, benchmark, checkpoint, debug, export, run_elastic, trace,
    )

    out = {"card": card}
    rng = np.random.default_rng(SEED + 10)
    counters = {"ew_flat": elementwise, "ew_strided": elementwise, "rd_full": reduction,
                "rd_axis": reduction, "mm": matmul, "bmm": matmul}

    # ------------------------------------ 10a. the kernels through export
    with tempfile.TemporaryDirectory(dir=os.path.dirname(os.path.abspath(__file__))) as d:
        cases = _export_cases(dev, rng, sm)
        live, inputs, exported = {}, {}, {}
        for name, fn, args, op, _ in cases:
            live[name] = fn(*args)
            t0 = time.perf_counter()
            ep = export.export_program(fn, *args)
            export_s = time.perf_counter() - t0
            nodes = [str(nd.target) for nd in ep.graph.nodes if nd.op == "call_function"]
            computing = [t for t in nodes if t.split(".")[1] not in VIEW_OPS]
            check(computing == [op], f"{name}: the exported graph calls {nodes}, not {op} alone")
            buf = io.BytesIO()
            torch.export.save(ep, buf)
            with open(os.path.join(d, name + ".pt2"), "wb") as f:
                f.write(buf.getvalue())
            inputs[name] = args
            exported[name] = {"export_s": export_s, "nodes": len(ep.graph.nodes),
                              "MB": len(buf.getvalue()) / 1e6, "program": library.sm_nodes(ep.graph)}
        # The nested solve, exported whole, its eager result kept (inputs
        # from a generator of their own: the later workloads keep theirs).
        nested_cases = _nested_cases(dev, np.random.default_rng(SEED + 19))
        nested = {}
        for name, fn, args in nested_cases:
            live[name] = fn(*args)
            _sync(dev)
            t0 = time.perf_counter()
            blob = export.export_step(fn, *args)
            export_s = time.perf_counter() - t0
            with open(os.path.join(d, name + ".pt2"), "wb") as f:
                f.write(blob)
            inputs[name] = args
            nested[name] = {"export_s": export_s, "MB": len(blob) / 1e6}
        torch.save(inputs, os.path.join(d, "inputs.pt"))
        _sync(dev)
        env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.abspath(__file__)))
        proc = subprocess.run([sys.executable, "-c", LOADER, d], capture_output=True, text=True,
                              timeout=600, env=env)
        check(proc.returncode == 0, f"the artifact loader failed:\n{proc.stderr[-4000:]}")
        loaded = json.loads(proc.stdout.strip().splitlines()[-1])
        check(not loaded["foreign_modules"], f"the loader imported {loaded['foreign_modules']}")
        served = torch.load(os.path.join(d, "outputs.pt"))
    for name, _, _, op, counter in cases:
        info = loaded["loaded"][name]
        got = {k: v for k, v in info["launches"].items() if v}
        check(got == {counter: 1}, f"{name}: the loaded artifact launched {got}, not {counter} once")
        if counter in ("mm", "bmm"):  # its sm::mm / sm::bmm runs the generated epilogue
            check(info["epilogue_paths"] == {"generated": 1, "interp": 0},
                  f"{name}: the loaded artifact's epilogue ran {info['epilogue_paths']}")
        check(_bits_equal(served[name].to(dev), live[name]),
              f"{name}: the loaded artifact's result differs from the live call's bits")
        exported[name].update(info, op=op)
        log(f"export {name} on {card}: {json.dumps(exported[name])}")
    out["exported"] = exported
    for name, _, _ in nested_cases:
        row = nested[name]
        row.update(loaded["loaded"][name], card=card,
                   bits_equal=_same_bits([t.to(dev) for t in served[name]], live[name]))
        row["launches"] = {k: v for k, v in row["launches"].items() if v}
        check(row["bits_equal"], f"{name}: the loaded program's result differs from the eager bits")
        check(all(bool(torch.isfinite(t).all()) for t in _leaves(live[name])),
              f"{name}: non-finite results")
        log(f"nested {name} on {card}: {json.dumps(row)}")
    for name in ("ew_flat", "ew_strided"):
        check(nested["nested_sm_pendulum"]["launches"].get(name, 0) > 0,
              f"the loaded nested sm pendulum launched no {name}")
    out["nested"] = nested

    # ------------------------- 10b. the solves served from artifacts
    # BASELINE config 3 whole and config 2 as the north star writes it, at
    # ILQRConfig()'s 10 iterations: each exported as two programs whose
    # horizon loops are scan nodes, loaded, its first call capturing them,
    # then in rounds of served, compiled, compiled, served beside
    # solve_batched_jit on the same inputs, with its bits.
    batch, horizon = CARTPOLE
    system = make_cartpole()
    x0s = torch.from_numpy(
        (0.2 * rng.standard_normal((batch, 4))).astype(np.float32)).to(dev)
    us0 = torch.zeros((batch, horizon, 1), device=dev)
    programs = (export._SERVED_INIT, export._SERVED_ITERATIONS)
    out["served"] = {}
    for key, sys_, (b, h) in (("cartpole", system, CARTPOLE),
                              ("sm_pendulum", make_sm_pendulum(), PENDULUM)):
        cfg = ILQRConfig()
        x0 = torch.from_numpy((0.2 * rng.standard_normal((b, sys_.nx))).astype(np.float32)).to(dev)
        us = torch.zeros((b, h, sys_.nu), device=dev)
        t0 = time.perf_counter()
        blob = export.export_solver_step(sys_, cfg, b, h)
        export_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        step = export.load_step(blob)
        load_s = time.perf_counter() - t0
        before = {id(e): e for p in programs for e in p.cached()}
        first_s, first = wall_s(lambda: step(x0, us))
        built = _new_entries(programs, before)
        stats = _graph_stats(built)
        _, ref = wall_s(lambda: ilqr.solve_batched_jit(sys_, x0, us, cfg))  # its own first call
        served_s, jit_s, same = [], [], _same_bits(first, (ref.us, ref.cost))
        for _ in range(SERVED_ROUNDS):
            for mode in ("served", "compiled", "compiled", "served"):
                if mode == "served":
                    t, res = wall_s(lambda: step(x0, us), sync_debug="error")
                    served_s.append(t)
                    same = same and _same_bits(res, first)
                else:
                    jit_s.append(wall_s(lambda: ilqr.solve_batched_jit(sys_, x0, us, cfg))[0])
        check(same, f"served {key}: not solve_batched_jit's bits")
        check(bool(torch.isfinite(first[1]).all()), f"served {key}: non-finite costs")
        row = {"batch": b, "horizon": h, "iterations": cfg.iterations, "export_s": export_s,
               "nodes": step.nodes, "MB": len(blob) / 1e6, "load_s": load_s,
               "first_call_s": first_s, **{k: stats[k] for k in (
                   "warmup_s", "capture_s", "instantiate_s", "pool_mb", "launches")},
               "launches_per_graph": [e.graph.stats["launches"] for e in built],
               "served_s": served_s, "compiled_s": jit_s,
               "served_solves_per_s": b / statistics.median(served_s),
               "compiled_solves_per_s": b / statistics.median(jit_s), "bits_equal": same,
               "card": card}
        if key == "sm_pendulum":
            for name in ("ew_flat", "ew_strided"):
                check(stats["launches"].get(name, 0) > 0,
                      f"the served sm pendulum's graphs hold no {name} launch: {stats['launches']}")
        # One replay of each graph (rollout, iteration): kernels, busy and
        # wall ms, beside phase 11's replays of solve_batched_jit's graphs.
        row["replays"] = [dict(zip(("kernels", "busy_ms", "wall_ms", "psd_ms"), _profiled_replay(
            e.graph, e.counter.zero_ if hasattr(e, "counter") else None))) for e in built]
        out["served"][key] = row
        del step, blob, built
        log(f"served {key} on {card}: {json.dumps(row)}")

    # ----------------------------------------- 10c. elastic at full width
    one = ILQRConfig(iterations=1)

    def mpc_step(state, i):
        """One receding-horizon step: an iteration from the warm start,
        then the plan shifted by one step."""
        us_warm, k = state
        r = ilqr.solve_batched(system, x0s, us_warm, one)
        return torch.cat([r.us[:, 1:], r.us[:, -1:]], dim=1), k + 1

    init = (us0, torch.zeros((), dtype=torch.int32, device=dev))
    mpc_step(init, 0)  # warm-up, so that neither run below pays first-call costs
    _sync(dev)
    t0 = time.perf_counter()
    plain = init
    for i in range(ELASTIC_STEPS):
        plain = mpc_step(plain, i)
    _sync(dev)
    plain_s = time.perf_counter() - t0
    fired = []

    def fault(i):
        if i == 3 and "preempt" not in fired:
            fired.append("preempt")
            raise RuntimeError("injected preemption")
        if i == 4 and "corrupt" not in fired:
            fired.append("corrupt")
            return lambda s: (s[0] + torch.inf, s[1])
        return None

    with tempfile.TemporaryDirectory(dir=os.path.dirname(os.path.abspath(__file__))) as d:
        t0 = time.perf_counter()
        clean = run_elastic(mpc_step, init, ELASTIC_STEPS,
                            ElasticConfig(directory=os.path.join(d, "clean"), checkpoint_every=2))
        elastic_s = time.perf_counter() - t0
        faulted = run_elastic(mpc_step, init, ELASTIC_STEPS,
                              ElasticConfig(directory=os.path.join(d, "faulted"), checkpoint_every=2),
                              inject_fault=fault)
        check(fired == ["preempt", "corrupt"], f"the faults fired {fired}")
        for what, s in (("uninterrupted elastic", clean), ("faulted elastic", faulted)):
            check(torch.equal(s[0], plain[0]) and int(s[1]) == ELASTIC_STEPS,
                  f"{what} run: not bitwise the plain loop's final state")
        save_ms, restore_ms = [], []
        for r in range(5):
            _sync(dev)
            t0 = time.perf_counter()
            checkpoint.save(os.path.join(d, f"ck{r}"), faulted)
            save_ms.append(1e3 * (time.perf_counter() - t0))
            t0 = time.perf_counter()
            back = checkpoint.restore(os.path.join(d, f"ck{r}"), like=faulted)
            _sync(dev)
            restore_ms.append(1e3 * (time.perf_counter() - t0))
        check(torch.equal(back[0], faulted[0]), "a checkpoint did not restore the state's bits")
        ck_mb = os.path.getsize(os.path.join(d, "ck0", "state.pt")) / 1e6
    out["elastic"] = {"batch": batch, "horizon": horizon, "steps": ELASTIC_STEPS,
                      "checkpoint_every": 2, "faults": fired, "bitwise": True,
                      "plain_loop_s": plain_s, "elastic_s": elastic_s,
                      "overhead": elastic_s / plain_s - 1.0, "checkpoint_MB": ck_mb,
                      "save_ms": save_ms, "restore_ms": restore_ms}
    log(f"elastic on {card}: {json.dumps(out['elastic'])}")

    # --------------------------------- 10d. profiling, metrics and debug
    a = sm.Array(rng.standard_normal(N_ADD).astype(np.float32))
    b = sm.Array(rng.standard_normal(N_ADD).astype(np.float32))
    res = benchmark(lambda: sm.add(a, b).torch(), warmup=5, repeats=50, bytes_moved=12e6)
    check(res.roofline_fraction <= 1.05, f"the 1M add reads {res.roofline_fraction} of the roofline")
    out["benchmark_add"] = {"median_s": res.median_s, "best_s": res.best_s, "gbps": res.gbps,
                            "roofline_fraction": res.roofline_fraction}
    with tempfile.TemporaryDirectory(dir=os.path.dirname(os.path.abspath(__file__))) as d:
        with trace(d) as prof:
            r1 = ilqr.solve_batched(system, x0s, us0, one)
        on_device = (torch.autograd.DeviceType.CUDA if dev.type == "cuda"
                     else torch.autograd.DeviceType.CPU)
        kernels = sorted({e.key for e in prof.key_averages() if e.device_type == on_device})
        with open(os.path.join(d, "trace.json")) as f:
            text = f.read()
    check(bool(kernels) and (dev.type != "cuda" or '"kernel"' in text),
          "the solver iteration's trace holds no CUDA kernel")
    out["trace"] = {"cuda_kernels": len(kernels), "first": kernels[:5], "trace_MB": len(text) / 1e6}
    mlog = MetricsLogger("cartpole")
    mlog.log_ilqr_result(0, r1)
    summary = mlog.summary()
    check(np.isfinite(summary["cost"]) and np.isfinite(summary["grad_norm"]),
          f"log_ilqr_result of card tensors: {summary}")
    guarded = debug.nan_guard(lambda x: x / 0.0)
    try:
        guarded(torch.zeros(4, device=dev))
        check(False, "nan_guard let a card NaN through")
    except FloatingPointError:
        pass
    name, fn, args, _, _ = cases[0]
    kernel_out = live[name]
    for w in (elementwise, reduction, matmul):
        w.reset_launches()
    dispatch.reset()
    with debug.interpret_kernels():
        interp = fn(*args)
        _sync(dev)
    moved = {**elementwise.LAUNCHES, **reduction.LAUNCHES, **matmul.LAUNCHES}
    check(not any(moved.values()), f"interpret_kernels() launched {moved}")
    check(dispatch.count("interpret", "elementwise") == 1, f"dispatch {dispatch.counts()}")
    u = max_ulp(kernel_out, interp)
    check(u <= 2.0, f"the interpreted recurrence is {u} ulp from the kernel's")
    out["debug"] = {"metrics": summary, "nan_guard": "raised", "interpret_ulp": u,
                    "interpret_dispatch": dispatch.counts()}
    log(f"profiling/metrics/debug on {card}: {json.dumps({k: out[k] for k in ('benchmark_add', 'trace', 'debug')})}")

    # ---------------------------------------------- 10e. the examples
    root = os.path.dirname(os.path.abspath(__file__))
    out["examples_s"] = {}
    for name in EXAMPLES:
        t0 = time.perf_counter()
        runpy.run_path(os.path.join(root, "examples", f"torch_{name}.py"))["main"](
            [] if dev.type == "cuda" else ["--device", dev.type])
        _sync(dev)
        out["examples_s"][name] = time.perf_counter() - t0
        check(sm.config.device == dev.type, f"torch_{name}.py left the device {sm.config.device}")
    log(f"examples on {card}: {json.dumps(out['examples_s'])}")

    return out


# ----------------------------------------------------------- phase 11
# The compiled entry points (utils/graphs.py): each captured as CUDA graphs
# and replayed, held to its eager body loop on the same inputs.
COMPILED_ROUNDS = {"cartpole": 1, "pendulum": 1, "sm_pendulum": 1, "replan": 2,
                   "rti": 1, "entry": 2}  # rounds of eager, compiled, compiled, eager each


def _leaves(tree):
    import torch
    from torch.utils import _pytree

    return [t for t in _pytree.tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _same_bits(a, b):
    la, lb = _leaves(a), _leaves(b)
    return len(la) == len(lb) and all(_bits_equal(x, y) for x, y in zip(la, lb))


def _new_entries(programs, before):
    """The entries of ``programs`` that are not in ``before`` (by id; its
    values keep the entries alive, so no id is reused)."""
    return [e for p in programs for e in p.cached() if id(e) not in before]


def _graph_stats(entries):
    """The stats of the graphs of ``entries``, summed: seconds, pool MB,
    kernel launches and collectives a replay."""
    out = {"graphs": 0, "warmup_s": 0.0, "capture_s": 0.0, "instantiate_s": 0.0,
           "pool_mb": 0.0, "launches": {}, "collectives": {}}
    for entry in entries:
        st = entry.graph.stats
        out["graphs"] += 1
        for k in ("warmup_s", "capture_s", "instantiate_s", "pool_mb"):
            out[k] += st[k]
        for field in ("launches", "collectives"):
            for k, v in st[field].items():
                out[field][k] = out[field].get(k, 0) + v
    return out


def _profiled_replay(graph, reset=None):
    """(kernels, busy ms, wall ms, psd ms) of one replay of ``graph``: the
    CUDA kernel events of torch.profiler over one replay (psd ms: those of
    the PSD projection's kernels, csrc/psd_project.cu), and the median
    synchronized wall time of three replays without the profiler (it slows
    the host's side of a replay of many kernels).  ``reset`` runs before
    each replay (a scan's step counter back to its first row)."""
    import torch

    def once():
        if reset:
            reset()
        graph.replay()

    walls = [1e3 * wall_s(once)[0] for _ in range(3)]
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        once()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    psd = sum(e.time_range.elapsed_us() for e in kernels if "psd_" in e.name) / 1e3
    return len(kernels), busy, statistics.median(walls), psd


def compiled_workload(key, card, programs, eager, compiled, per, rounds, checked=None,
                      profiled=None):
    """A compiled entry point against its eager loop on the same inputs:
    ``compiled()`` builds its graphs at the first call, then ``rounds`` of
    eager, compiled, compiled, eager; every compiled result must have the
    first one's bits, which must be the eager ones.  ``per(seconds)`` is
    the workload's rate from one call's seconds.  ``checked()`` makes a
    compiled call after the first and returns (seconds, result) with its
    replays under sync debug mode "error" (default: the whole call).  The
    card's busy share is taken over one replay of the last graph built for
    ``profiled`` (default: the last of ``programs``).  Returns (the row,
    the first result)."""
    import torch
    from simplemath_tpu_torch.ops import elementwise, linalg_small, matmul, reduction

    wrappers = (elementwise, reduction, matmul, linalg_small)
    checked = checked or (lambda: wall_s(compiled, sync_debug="error"))
    before = {id(e): e for p in programs for e in p.cached()}
    reserved = torch.cuda.memory_reserved()
    for w in wrappers:
        w.reset_launches()
    build_s, first = wall_s(compiled)
    launches = {k: v for w in wrappers for k, v in w.LAUNCHES.items() if v}
    built = _new_entries(programs, before)
    stats = _graph_stats(built)
    stats["per_graph"] = [e.graph.stats for e in built]
    row = {"build_s": build_s, **stats,
           "reserved_mb_added": (torch.cuda.memory_reserved() - reserved) / 2**20,
           "launches_at_build": launches}
    eager_s, compiled_s, same = [], [], True
    for _ in range(rounds):
        for mode in ("eager", "compiled", "compiled", "eager"):
            if mode == "eager":
                t, res = wall_s(eager)
                eager_s.append(t)
            else:
                t, res = checked()
                compiled_s.append(t)
            same = same and _same_bits(res, first)
    check(same, f"{key}: a compiled call differs from the eager loop's bits")
    # One replay of each graph built: its kernels, the card's busy ms and
    # its wall ms; a call's wall time less its replays' is what runs
    # between them.  The row's busy share is that of the last graph of
    # ``profiled`` (the scan body, or the replan).
    replays = {}
    for entry in built:
        counter = getattr(entry, "counter", None)
        replays[id(entry)] = _profiled_replay(entry.graph,
                                              counter.zero_ if counter is not None else None)
    row["replays"] = [{"kernels": k, "busy_ms": b, "wall_ms": w, "psd_ms": p}
                      for k, b, w, p in replays.values()]
    kernels, busy, wall, psd = replays[id(_new_entries([profiled or programs[-1]], before)[-1])]
    row.update({
        "bits_equal": same, "eager_s": eager_s, "compiled_s": compiled_s,
        "eager_median_s": statistics.median(eager_s),
        "compiled_median_s": statistics.median(compiled_s),
        "eager_rate": per(statistics.median(eager_s)),
        "compiled_rate": per(statistics.median(compiled_s)),
        "replay_kernels": kernels, "replay_busy_ms": busy, "replay_wall_ms": wall,
        "replay_psd_ms": psd,
        "busy_share": busy / wall})
    log(f"compiled {key} on {card}: {row}")
    return row, first


def compiled_replan_and_rti(dev, card, rng, quad, tag, replan_rounds, rti_rounds):
    """``MPCController.replan`` (H=50, 2 iterations, two replans a call)
    and the RTI tick (the difference of a 20- and a 60-tick closed loop,
    each a graph of its own: the tick count is a static argument) of
    ``quad``, compiled against their eager loops (``compiled_workload``).
    Returns (the replan's row, the RTI's figures)."""
    import torch
    from simplemath_tpu_torch.models import MPCController, rti, sqp_mpc
    from simplemath_tpu_torch.utils import graphs

    # A controller each, the same states in turn.
    xq = [torch.from_numpy((0.1 * rng.standard_normal(12)).astype(np.float32)).to(dev)
          for _ in range(2)]
    ctrl_c = MPCController(quad, horizon=QUAD_H, replan_iters=2)
    ctrl_e = MPCController(quad, horizon=QUAD_H, replan_iters=2)

    def replan(ctrl):
        ctrl.reset()
        return [ctrl.replan(x) for x in xq], ctrl.us_warm.clone()

    def replan_eager():
        with graphs.eager():
            return replan(ctrl_e)

    row, _ = compiled_workload(f"replan{tag}", card, (sqp_mpc._REPLAN,), replan_eager,
                               lambda: replan(ctrl_c), lambda t: 1e3 * t / len(xq),
                               replan_rounds)
    row.update({"horizon": QUAD_H, "iterations": 2, "replans_a_call": len(xq),
                "rate": "ms a replan", "budget_ms": 1.0})
    x0q = torch.from_numpy((0.1 * rng.standard_normal(12)).astype(np.float32)).to(dev)
    loops = {}
    for ticks in RTI_TICKS:
        def loop(ticks=ticks):
            return rti.rti_closed_loop(quad, x0q, QUAD_H, ticks)

        def loop_eager(loop=loop):
            with graphs.eager():
                return loop()

        loops[ticks], res = compiled_workload(f"rti{tag}_{ticks}", card, (rti._TICKS,), loop_eager,
                                              loop, lambda t: 1e3 * t, rti_rounds)
        check(bool(torch.isfinite(res[2]).all()), f"compiled RTI{tag} {ticks} ticks: non-finite costs")
    short, long_ = RTI_TICKS
    ticks_out = {"horizon": QUAD_H, "ticks": list(RTI_TICKS), "loops": loops, "budget_ms": 1.0,
                 **{f"{m}_tick_ms": (loops[long_][f"{m}_median_s"] - loops[short][f"{m}_median_s"])
                    * 1e3 / (long_ - short) for m in ("eager", "compiled")}}
    log(f"compiled replan{tag} on {card}: {row['compiled_rate']} ms; RTI tick "
        f"eager {ticks_out['eager_tick_ms']} ms, compiled {ticks_out['compiled_tick_ms']} ms")
    return row, ticks_out


def compiled_phase(dev, card):
    """Phase 11: the compiled entry points on the card at full width, each
    captured once and replayed, against its eager body loop on the same
    inputs in alternating rounds (eager, compiled, compiled, eager): bits,
    wall times, capture and instantiate seconds, pool MB, launches a
    replay, the card's busy share in one profiled replay of the body's
    graph; every compiled call after the first under sync debug mode
    "error".  Then each
    of the six kernel wrappers captured once, its replay the eager bits."""
    import torch
    import simplemath_tpu_torch as sm
    from simplemath_tpu_torch import entry as port_entry
    from simplemath_tpu_torch.models import (
        ILQRConfig, ilqr, make_cartpole, make_pendulum, make_quadrotor, make_sm_pendulum,
    )
    from simplemath_tpu_torch.models import dynamics
    from simplemath_tpu_torch.ops import codegen, elementwise, matmul, reduction
    from simplemath_tpu_torch.utils import graphs

    rng = np.random.default_rng(SEED + 11)
    out = {"card": card}
    quad = make_quadrotor()

    # Batched solves: solve_batched_jit against solve_batched.
    solves = ilqr._BATCHED_INIT, ilqr._BATCHED_ITERATIONS
    for key, system, (batch, horizon) in (("cartpole", make_cartpole(), CARTPOLE),
                                          ("pendulum", make_pendulum(), PENDULUM),
                                          ("sm_pendulum", make_sm_pendulum(), PENDULUM)):
        x0 = torch.from_numpy((0.2 * rng.standard_normal((batch, system.nx))).astype(np.float32)).to(dev)
        us = torch.zeros((batch, horizon, system.nu), device=dev)
        cfg = ILQRConfig(iterations=SOLVE_ITERS)
        row, res = compiled_workload(key, card, solves,
                                     lambda: ilqr.solve_batched(system, x0, us, cfg),
                                     lambda: ilqr.solve_batched_jit(system, x0, us, cfg),
                                     lambda t: batch / t, COMPILED_ROUNDS[key])
        check(bool(torch.isfinite(res.cost).all()), f"compiled {key}: non-finite costs")
        row.update({"batch": batch, "horizon": horizon, "iterations": SOLVE_ITERS,
                    "rate": "solves/s"})
        if key == "sm_pendulum":
            for name in ("ew_flat", "ew_strided"):
                check(row["launches"].get(name, 0) > 0,
                      f"the sm pendulum's graphs hold no {name} launch: {row['launches']}")
            # The graphs hold their constants and generated kernels: clear
            # the constant cache, unload every kernel no graph pins, hand
            # the freed memory out again overwritten, and replay.
            pinned = set(codegen._PINS)
            dynamics._cached_constant.cache_clear()
            codegen._evict(elementwise._library())
            junk = [torch.full((n,), float("nan"), device=dev)
                    for n in (4, 64, 1 << 20) for _ in range(256)]
            _, again = wall_s(lambda: ilqr.solve_batched_jit(system, x0, us, cfg),
                              sync_debug="error")
            del junk
            evicted = _same_bits(again, res)
            check(bool(pinned) and pinned <= set(codegen._LOADED) and evicted,
                  "the sm pendulum's replay after the caches' eviction differs from its bits")
            row["replay_after_eviction_bits_equal"] = evicted
            row["pinned_kernels"] = len(pinned)
        out[key] = row

    out["replan"], out["rti"] = compiled_replan_and_rti(
        dev, card, rng, quad, "", COMPILED_ROUNDS["replan"], COMPILED_ROUNDS["rti"])

    # entry(): __graft_entry__.entry()'s twin step, compiled, against it eager.
    step, args = port_entry.entry()

    def step_eager():
        with graphs.eager():
            return step(*args)

    row, cost = compiled_workload("entry", card, solves, step_eager, lambda: step(*args),
                                  lambda t: 1e3 * t, COMPILED_ROUNDS["entry"])
    check(tuple(cost.shape) == (32,) and bool(torch.isfinite(cost).all()), "compiled entry(): bad cost")
    row.update({"batch": 32, "horizon": 20, "iterations": 3, "rate": "ms a call"})
    out["entry"] = row

    # The six kernel wrappers, each captured once at its main-path shape.
    counters = {"ew_flat": elementwise, "ew_strided": elementwise, "rd_full": reduction,
                "rd_axis": reduction, "mm": matmul, "bmm": matmul}
    kernels = {}
    for name, fn, args, _, counter in _export_cases(dev, rng, sm):
        eager = fn(*(a.clone() for a in args))  # the recurrence donates its first operand
        program = graphs.Jit(lambda static, *a, fn=fn: fn(*a))
        program((), *args)
        (built,) = program.cached()
        t, got = wall_s(lambda: program((), *args), sync_debug="error")
        counters[counter].reset_launches()
        same = _bits_equal(got, eager)
        check(same, f"{name} captured: its replay differs from the eager call's bits")
        check(built.graph.stats["launches"].get(counter, 0) > 0,
              f"{name} captured without a launch of its kernel: {built.graph.stats['launches']}")
        kernels[name] = {"bits_equal": same, "launches_a_replay": built.graph.stats["launches"],
                         "capture_s": built.graph.stats["capture_s"], "replay_wall_s": t}
    out["kernels"] = kernels
    log(f"the six kernels captured on {card}: {kernels}")
    return out


# ----------------------------------------------------------------- 12. psd
PSD_SOURCE = "simplemath_tpu_torch/csrc/psd_project.cu"
PSD_EPS = 1e-6             # ILQRConfig.psd_eps
# The projection's shapes on the solvers' path: the coupled cartpole's
# joint blocks (8192 x H=100 of 5 x 5) and terminal Hessians (8192 of 4 x
# 4); the coupled quadrotor's at H=50 (50 of 16 x 16, one of 12 x 12).
PSD_SHAPES = ((CARTPOLE[0] * CARTPOLE[1], 5), (CARTPOLE[0], 4), (QUAD_H, 16), (1, 12))
PSD_CPU_SLICE = 64         # scenarios of the coupled cartpole solved again on the CPU
PSD_ROUNDS = 1             # rounds of eager, compiled, compiled, eager of each workload
# The coupled systems' x-u cross term and concave term
# (tests/test_torch_psd.py::CROSS, CONCAVE): the cartpole's on the cart's
# velocity and the force, the quadrotor's on the roll rate and the roll
# torque.
CROSS = {"cartpole": lambda x, u: 0.1 * x[1] * u[0],
         "quadrotor": lambda x, u: 0.05 * x[9] * u[1]}
CONCAVE = {"cartpole": lambda x: -0.01 * x[1] ** 2, "quadrotor": lambda x: -0.049 * x[9] ** 2}


def coupled(base):
    """``base`` with its ``CROSS`` and ``CONCAVE`` terms in the stage cost
    and ``separable_cost=False``: ``psd="auto"`` takes ``"eigh"``."""
    import dataclasses

    def stage_cost(x, u):
        return base.stage_cost(x, u) + CROSS[base.name](x, u) + CONCAVE[base.name](x)

    return dataclasses.replace(base, name=f"{base.name}_coupled", stage_cost=stage_cost,
                               separable_cost=False)


def psd_ops(n):
    """Float operations of the projection of one n x n matrix, whatever
    algorithm computes it: n (n + 1) for the symmetrization, 9 n^3 for a
    symmetric eigendecomposition with its eigenvectors (Golub & Van Loan's
    count for the symmetric QR algorithm) and 2 n^3 + n^2 for V diag(w)
    V^T."""
    return n * (n + 1) + 9 * n ** 3 + 2 * n ** 3 + n * n


# The largest batch of n x n matrices of a type that cuSOLVER's batched
# eigh took in this run: it refuses 819,200 of 5 x 5 in float64, and 65,536
# too (CUSOLVER_STATUS_INVALID_VALUE).
EIGH_BATCH = {}


def _psd_library(H):
    """The library's route to the same function: eager torch.linalg.eigh
    (it checks its info on the host) and the reconstruction, in as few
    calls as cuSOLVER takes (``EIGH_BATCH``)."""
    import torch

    def one(h):
        w, V = torch.linalg.eigh((h + h.mT) * 0.5)
        return (V * torch.clamp_min(w, PSD_EPS)[..., None, :]) @ V.mT

    key = (H.shape[-1], H.dtype, H.device.type)
    chunk = EIGH_BATCH.get(key, H.shape[0])
    while True:
        try:
            out = torch.cat([one(h) for h in H.split(chunk)])
        except RuntimeError:  # torch.linalg.LinAlgError
            if chunk == 1:
                raise
            chunk = max(1, chunk // 4)
            continue
        EIGH_BATCH[key] = chunk
        return out


def _psd_within(got, H, what):
    """The stated tolerance against float64 torch.linalg.eigh on the CPU: 8
    n eps_f32 (||S||_F + sqrt(n) eps) for each matrix
    (tests/test_torch_psd.py's bound).  Returns the largest error in units
    of it."""
    import torch

    S = ((H + H.mT) * 0.5).double().cpu()
    want = _psd_library(S)
    n = H.shape[-1]
    bound = 8 * n * torch.finfo(H.dtype).eps * (torch.linalg.matrix_norm(S) + n ** 0.5 * PSD_EPS)
    ratio = float(((got.double().cpu() - want).abs().amax((-2, -1)) / bound).max())
    check(ratio <= 1.0, f"{what}: {ratio} x the tolerance from float64 eigh")
    return ratio


def psd_kernel_checks(dev, card, rng):
    """The projection's kernel against its plain version at the solvers'
    shapes (random symmetric indefinite matrices from the seed) and on
    asymmetric, degenerate and non-finite inputs: the plain version's bits,
    within the stated tolerance of float64 eigh; timed beside the plain
    version and the library's route, with the function's bound (``psd_ops``)
    and the Jacobi sweeps this data took."""
    import torch
    from simplemath_tpu_torch.ops import linalg_small

    rows = {}
    for batch, n in PSD_SHAPES:
        A = torch.from_numpy(rng.standard_normal((batch, n, n)).astype(np.float32)).to(dev)
        H = (A + A.mT) * 0.5
        k = linalg_small.psd_project(H, PSD_EPS)
        p = linalg_small.psd_project_plain(H, PSD_EPS)
        _, _, sweeps = linalg_small.jacobi_plain(H)
        torch.cuda.synchronize()
        err = float((k - p).abs().max())
        check(bool(torch.isfinite(k).all()) and k.shape == H.shape, f"psd {batch}x{n}: bad result")
        ratio = _psd_within(k, H, f"psd {batch}x{n}")
        check(torch.equal(linalg_small.psd_project(H, PSD_EPS), k),
              f"psd {batch}x{n}: two launches differ")
        ops = psd_ops(n) * batch
        b = bound(2 * n * n * 4 * batch, ops)
        row = {"batch": batch, "n": n, "path": linalg_small.path(n, H.dtype),
               "bits_equal": torch.equal(k, p), "max_abs_err": err,
               "eigh64_err_over_tol": ratio,
               "sweeps_mean": float(sweeps.double().mean()), "sweeps_max": int(sweeps.max()),
               "ms": time_ms(lambda: linalg_small.psd_project(H, PSD_EPS), n=10),
               "plain_ms": time_ms(lambda: linalg_small.psd_project_plain(H, PSD_EPS), reps=3),
               "library_ms": time_ms(lambda: _psd_library(H), reps=3),
               "library_calls": -(-batch // EIGH_BATCH[(n, H.dtype, H.device.type)]),
               "bound_ms": b[0], "bound_by": b[1], "gflop": ops / 1e9}
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
        check(err <= 8 * n * torch.finfo(torch.float32).eps * float(torch.linalg.matrix_norm(
            H).max()), f"psd {batch}x{n}: kernel {err} from its plain version")
        rows[f"{batch}x{n}"] = row
        log(f"psd kernel {batch} x {n}x{n} on {card}: {row}")
    # Asymmetric, degenerate and non-finite matrices in one batch of 5 x 5.
    eye = torch.eye(5, device=dev)
    Q, _ = torch.linalg.qr(torch.from_numpy(rng.standard_normal((5, 5))).float().to(dev))
    cases = torch.stack([
        torch.from_numpy(rng.standard_normal((5, 5)).astype(np.float32)).to(dev),  # asymmetric
        torch.zeros((5, 5), device=dev), eye,
        (Q * torch.tensor([2.0, 2.0, 2.0, -1.0, 0.5], device=dev)) @ Q.T,  # repeated eigenvalue
        (Q * (PSD_EPS * torch.tensor([0.5, 1.0, 2.0, 0.0, -1.0], device=dev))) @ Q.T,
        eye.masked_fill(eye == 0, float("nan")), eye * float("inf"), -eye])
    k = linalg_small.psd_project(cases, PSD_EPS)
    p = linalg_small.psd_project_plain(cases, PSD_EPS)
    torch.cuda.synchronize()
    bad = torch.tensor([False] * 5 + [True, True, False], device=dev)
    check(bool(k[bad].isnan().all()) and bool(k[~bad].isfinite().all()),
          "psd special cases: a non-finite matrix is not all NaN, or NaN leaked")
    check(torch.equal(k[~bad], p[~bad]), "psd special cases: the kernel differs from its plain version")
    check(torch.equal(k[1], PSD_EPS * eye) and torch.equal(k[7], PSD_EPS * eye),
          "psd special cases: zero or -I does not project to eps I")
    rows["special"] = {"cases": ["asymmetric", "zero", "identity", "repeated", "straddling_eps",
                                 "nan", "inf", "minus_identity"],
                       "bits_equal": True,
                       "eigh64_err_over_tol": _psd_within(k[~bad], cases[~bad], "psd special cases")}
    log(f"psd special cases on {card}: kernel = plain bit for bit; NaN and inf matrices "
        f"all NaN alone; {rows['special']}")
    return rows


def _joint_blocks(system, x0, us):
    """The solver's joint (x, u) Hessian blocks at the trajectory that
    ``us`` rolls out from ``x0``: (batch, H, nx + nu, nx + nu)."""
    import torch
    from simplemath_tpu_torch.models import ilqr

    xs = torch.func.vmap(lambda x, u: ilqr.rollout(system.step, x, u))(x0, us)
    lxx, luu, lux = ilqr.linearize_soa(system, xs, us)[4:7]
    return torch.cat([torch.cat([lxx, lux.mT], -1), torch.cat([lux, luu], -1)], -2)


def _block_sweeps(blk):
    """The Jacobi sweeps (``jacobi_plain``, on the blocks' device) that the
    projection of each of ``blk``'s matrices takes: mean and max."""
    from simplemath_tpu_torch.ops import linalg_small

    _, _, sweeps = linalg_small.jacobi_plain((blk + blk.mT) * 0.5)
    return {"blocks": sweeps.numel(), "n": blk.shape[-1],
            "sweeps_mean": float(sweeps.double().mean()), "sweeps_max": int(sweeps.max())}


def psd_phase(dev, card, compiled):
    """Phase 12: ``psd="eigh"`` through the compiled programs on the card.
    The projection's kernel at the solvers' shapes (``psd_kernel_checks``);
    the coupled cartpole (``CROSS``, ``CONCAVE``) through ``solve_batched_jit`` at
    8192 x H=100, 10 iterations, against its eager loop (bits), beside
    phase 11's clamp-diag cartpole, its costs never rising, the share of
    joint blocks the projection moved, and 64 of its scenarios solved again
    on the CPU with the plain projection (costs within rtol 1e-4, controls
    within rtol 1e-3 and 1e-4 x the largest); the coupled quadrotor's
    ``MPCController.replan`` (H=50, 2 iterations) and RTI tick (H=50, 20
    and 60 ticks) against their eager loops, beside phase 11's; every graph
    must hold the projection's kernel.  The Jacobi sweeps of the solvers'
    own joint blocks at their initial trajectories (``_block_sweeps``)."""
    import torch
    from simplemath_tpu_torch.models import ILQRConfig, ilqr, make_cartpole, make_quadrotor
    from simplemath_tpu_torch.ops import linalg_small

    rng = np.random.default_rng(SEED + 12)
    out = {"card": card, "kernel": psd_kernel_checks(dev, card, rng)}

    # The coupled cartpole, compiled against eager.
    system = coupled(make_cartpole())
    batch, horizon = CARTPOLE
    x0 = torch.from_numpy((0.2 * rng.standard_normal((batch, 4))).astype(np.float32)).to(dev)
    us = torch.zeros((batch, horizon, 1), device=dev)
    cfg = ILQRConfig(iterations=SOLVE_ITERS)
    check(ilqr._psd_mode(cfg, system) == "eigh", "the coupled cartpole does not take eigh")
    solves = ilqr._BATCHED_INIT, ilqr._BATCHED_ITERATIONS
    row, res = compiled_workload("cartpole_eigh", card, solves,
                                 lambda: ilqr.solve_batched(system, x0, us, cfg),
                                 lambda: ilqr.solve_batched_jit(system, x0, us, cfg),
                                 lambda t: batch / t, PSD_ROUNDS)
    check(row["launches"].get("psd_project") == 2,
          f"the coupled cartpole's graphs hold {row['launches']}, not 2 psd_project launches")
    trace = res.cost_trace
    check(bool(torch.isfinite(trace).all()), "coupled cartpole: non-finite costs")
    check(bool((trace[:, 1:] <= trace[:, :-1]).all()), "coupled cartpole: a cost rose")
    # The joint blocks at the initial trajectory that the projection moves
    # by more than the stated tolerance.
    blk = _joint_blocks(system, x0, us)
    out["solver_sweeps"] = {"cartpole": _block_sweeps(blk)}
    n = blk.shape[-1]
    tol = 8 * n * torch.finfo(blk.dtype).eps * (torch.linalg.matrix_norm(blk) + n ** 0.5 * PSD_EPS)
    moved = (linalg_small.psd_project(blk, PSD_EPS) - blk).abs().amax((-2, -1)) > tol
    share = float(moved.double().mean())
    check(share > 0, "the projection moved no joint block of the coupled cartpole")
    # 64 scenarios again on the CPU, the plain projection.
    sl = slice(0, PSD_CPU_SLICE)
    t0 = time.perf_counter()
    cpu = ilqr.solve_batched(system, x0[sl].cpu(), us[sl].cpu(), cfg)
    cpu_s = time.perf_counter() - t0
    sliced = ilqr.ILQRResult(xs=res.xs[sl], us=res.us[sl], cost=res.cost[sl],
                             cost_trace=res.cost_trace[sl], grad_norm=res.grad_norm)
    cost_err, u_err = solver_close(sliced, cpu, "coupled cartpole against the CPU")
    row.update({"batch": batch, "horizon": horizon, "iterations": SOLVE_ITERS, "rate": "solves/s",
                "blocks_moved_share": share, "cpu_slice": PSD_CPU_SLICE, "cpu_s": cpu_s,
                "cpu_cost_rel_err": cost_err, "cpu_us_abs_err": u_err,
                "clamp_diag_compiled_rate": compiled["cartpole"]["compiled_rate"]})
    out["cartpole"] = row
    log(f"coupled cartpole on {card}: {row['compiled_rate']} solves/s compiled "
        f"(clamp-diag, phase 11: {row['clamp_diag_compiled_rate']}), {share} of the joint "
        f"blocks moved, the CPU slice within {cost_err} / {u_err}")

    # The coupled quadrotor's replan and RTI tick; the sweeps of its joint
    # blocks at the replan's first trajectory (two states like the
    # replan's, zero controls).
    quad = coupled(make_quadrotor())
    out["replan"], out["rti"] = compiled_replan_and_rti(
        dev, card, rng, quad, "_eigh", PSD_ROUNDS, PSD_ROUNDS)
    xq = torch.from_numpy((0.1 * rng.standard_normal((2, 12))).astype(np.float32)).to(dev)
    out["solver_sweeps"]["quadrotor"] = _block_sweeps(
        _joint_blocks(quad, xq, torch.zeros((2, QUAD_H, 4), device=dev)))
    log(f"Jacobi sweeps of the solvers' joint blocks on {card}: {out['solver_sweeps']}")
    check(out["replan"]["launches"].get("psd_project") == 2 * 2,
          f"the coupled replan's graph holds {out['replan']['launches']}, not 4 psd_project launches")
    for ticks, row in out["rti"]["loops"].items():
        check(row["launches"].get("psd_project") == 2,
              f"the coupled RTI tick's graph ({ticks} ticks) holds {row['launches']}")
    out["replan"]["clamp_diag_compiled_rate"] = compiled["replan"]["compiled_rate"]
    out["rti"]["clamp_diag_compiled_tick_ms"] = compiled["rti"]["compiled_tick_ms"]
    out["graph_launches"] = {k: (v["launches"] if k != "rti" else
                                 {t: r["launches"] for t, r in v["loops"].items()})
                             for k, v in out.items() if k in ("cartpole", "replan", "rti")}
    return out


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 1
    started = time.perf_counter()
    import simplemath_tpu_torch as sm
    from simplemath_tpu_torch import _build
    from simplemath_tpu_torch.ops import (
        codegen, dispatch, elementwise, engine, matmul, program, reduction, registry,
    )

    check("jax" not in sys.modules, "the port imported jax")
    check(torch.device(sm.config.device).type == "cuda",
          f"the port's default device is {sm.config.device!r}, not the card")
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)

    # ------------------------------------------------------------ 1. card
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")

    # ----------------------------------------------------------- 2. build
    t0 = time.perf_counter()
    _build.library()
    build_s = time.perf_counter() - t0
    log(f"build: {build_s:.2f} s (nvcc {_build.BUILD_SECONDS}); NVRTC {_build.NVRTC_VERSION}")
    units = dict(sorted(_build.UNIT_SECONDS.items(), key=lambda kv: -kv[1]))
    log(f"build units, seconds each beside the others: {json.dumps(units)}")
    for line in _build.BUILD_LOG.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry function" in line:
            log(f"ptxas: {line.strip()}")
    # The kernels of phases 3d and 5d's checks, then the matmul kernels
    # generated for phase 7's checks, compiled into the disk cache on other
    # threads while the phases before them run.  The main path's fused calls
    # compile their kernels where they first launch them.
    ahead = threading.Thread(target=compile_ahead, args=(generated_signatures(dev),), daemon=True)
    ahead.start()
    ahead_mm = threading.Thread(
        target=compile_ahead, args=(matmul_generated_signatures(dev),), daemon=True)
    ahead_mm.start()

    gen = {}
    generated_phase(gen, None)
    # ------------------------------------------------ 3. kernel vs plain
    def both(prog, shape, operands, iterations=1, carry=0):
        k = elementwise.elementwise(prog, shape, prog.dtype, *operands,
                                    name="check", iterations=iterations, carry=carry)
        p = program.run_plain(prog, [elementwise.read(o) for o in operands],
                              shape, iterations, carry)
        torch.cuda.synchronize()
        return k, p

    def on(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    def backwards(x):
        """A 1-D operand read back to front: ew_strided's operand."""
        return elementwise.View(x, x.numel() - 1, (x.numel(),), (-1,))

    def binop(name, shape_a, shape_b, dtype=torch.float32):
        la, lb = program.leaf(shape_a, dtype), program.leaf(shape_b, dtype)
        return program.lower(program.apply(name, la, lb), [la, lb])

    a1 = on(rng.standard_normal(N_ADD).astype(np.float32))
    b1 = on(rng.standard_normal(N_ADD).astype(np.float32))
    k, p = both(binop("add", (N_ADD,), (N_ADD,)), (N_ADD,), [a1, b1])
    check(exact(k, p) and exact(k, a1 + b1), "flat add disagrees with its plain version")
    log("check flat add 1M f32: exact")

    sq = (N_FUSED, N_FUSED)
    m2 = on(rng.standard_normal(sq).astype(np.float32))
    row = on(rng.standard_normal((1, N_FUSED)).astype(np.float32))
    k, p = both(binop("add", sq, (1, N_FUSED)), sq, [m2, row])
    check(exact(k, p) and exact(k, m2 + row), "broadcast add disagrees")
    log("check broadcast add (2048,2048)+(1,2048): exact")

    arr = sm.Array(m2)
    for label, view in (("transposed", arr.T), ("negative-step", arr[::-1, ::-2])):
        op = view._operand()
        prog = binop("add", view.shape, (1, view.shape[1]))
        r = row[:, : view.shape[1]].contiguous()
        k, p = both(prog, view.shape, [op, r])
        check(exact(k, p), f"{label} view operand disagrees")
        check(exact(k, view.torch() + r), f"{label} view operand reads the wrong elements")
        log(f"check {label} view operand {view.shape} strides {view.strides}: exact")

    special = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1e-40, -1e-40, 1.0,
                        -1.0, 2.0, 0.5, 88.7, -103.9, 3e38], np.float32)
    xf = on(np.concatenate([rng.uniform(-5, 5, 1 << 19), rng.uniform(-120, 100, 1 << 18),
                            special]).astype(np.float32))
    yf = on(np.concatenate([rng.uniform(-4, 4, (1 << 19) + (1 << 18)),
                            np.round(rng.uniform(-5, 5, special.size))]).astype(np.float32))
    ints = [0, 1, -1, 2**31 - 1, -2**31, 7, -7, 3, 5, 46341, -46341, 65536]
    xi = on(np.concatenate([rng.integers(-100, 100, 1 << 19), ints]).astype(np.int32))
    yi = on(np.concatenate([rng.integers(-5, 31, 1 << 19),
                            [0, 5, -3, 2, 2, -1, 0, 31, 40, 2, -2**31, -5]]).astype(np.int32))
    xu = on(np.concatenate([rng.integers(0, 200, 1 << 19),
                            [0, 1, 2**32 - 1, 2**31, 2**31 - 1, 7, 3, 5, 65536, 46341, 9, 2]])
            .astype(np.int64)).to(torch.uint32)
    yu = on(np.concatenate([rng.integers(0, 31, 1 << 19),
                            [0, 5, 3, 2, 2, 0, 0, 31, 40, 2, 2**32 - 1, 7]]).astype(np.int64)).to(torch.uint32)
    xb, yb = xf.bfloat16(), yf.bfloat16()
    transcendental = {"exp", "log", "exp2", "log2", "tanh", "sin", "cos", "tan", "pow"}
    worst_tr = 0.0
    n_codes = 0
    ops = list(registry.registered_ops().items()) + list(registry.INTERNAL.items())
    for name, op in ops:
        for dt, (x, y) in ((torch.float32, (xf, yf)), (torch.int32, (xi, yi)),
                           (torch.uint32, (xu, yu)), (torch.bfloat16, (xb, yb))):
            if program.register_type(dt) not in op.opcodes:
                continue
            if dt == torch.bfloat16 and name in ("pow", "ipow"):
                continue  # the engine computes pow in float32 (pow_expr)
            n = x.numel()
            leaves = [program.leaf((n,), dt) for _ in range(op.arity)]
            operands = [x, y][: op.arity]
            if name == "where":
                leaves[0] = program.leaf((n,), torch.bool)
                operands = [bits(x) > 0, x, y]
            if name in ("pow", "ipow"):
                node = program.Node(name, leaves, dt, (n,))
            else:
                node = program.apply(name, *leaves)
            prog = program.lower(node, leaves)
            k, p = both(prog, (n,), operands)
            if name in transcendental and dt == torch.bfloat16:
                u = max_bf16_ulp(k, p)
                check(u <= 1.0, f"{name} {dt}: {u} bfloat16 ulp from its plain version")
            elif name in transcendental:
                u = max_ulp(k, p)
                worst_tr = max(worst_tr, u)
                check(u <= 2.0, f"{name} {dt}: {u} ulp from its plain version")
            else:
                check(exact(k, p), f"{name} {dt} disagrees with its plain version")
            # ew_strided's two kernels on the operands read backwards.
            g = on_both_kernels(elementwise, prog, (n,), [backwards(o) for o in operands])
            check(torch.equal(bits(g).flip(0), bits(k)), f"{name} {dt}: ew_strided differs from ew_flat")
            n_codes += 1
    casts = [(src, dst) for src, dst in program._CASTS if src != dst] + [
        (torch.bfloat16, torch.float32), (torch.float32, torch.bfloat16),
        (torch.int32, torch.bfloat16), (torch.uint32, torch.bfloat16),
        (torch.bool, torch.bfloat16), (torch.bfloat16, torch.int32),
        (torch.bfloat16, torch.uint32), (torch.bfloat16, torch.bool)]
    for (src, dst) in casts:
        x = {torch.float32: xf, torch.bfloat16: xb, torch.int32: xi, torch.uint32: xu,
             torch.bool: xf > 0}[src]
        if src.is_floating_point and dst not in (torch.float32, torch.bfloat16, torch.bool):
            # Within the destination's range: beyond it C++ leaves the value unspecified.
            x = torch.nan_to_num(x.float().clamp(0.0 if dst == torch.uint32 else -1e6, 1e6),
                                 nan=0.5).to(src)
        leaf = program.leaf(tuple(x.shape), src)
        prog = program.lower(program.cast(leaf, dst), [leaf])
        k, p = both(prog, tuple(x.shape), [x])
        check(exact(k, p), f"cast {src}->{dst} disagrees")
        g = on_both_kernels(elementwise, prog, tuple(x.shape), [backwards(x)])
        check(torch.equal(bits(g).flip(0), bits(k)), f"cast {src}->{dst}: ew_strided differs from ew_flat")
        n_codes += 1
    log(f"check {n_codes} opcode/dtype cases (float32, int32, uint32, bfloat16, bool; int32 "
        "and uint32 floor division and remainder with zero and -1 divisors): arithmetic exact, "
        f"transcendentals within {worst_tr} ulp of the plain version (bfloat16 within 1 of its "
        "ulps); ew_flat, ew_strided interpreted and ew_strided generated give the same bits")
    bf16_chain_checks(dev, rng, sm, elementwise)
    generated_checks(dev, rng, sm, elementwise, program)
    ahead.join()
    t0 = time.perf_counter()
    n_gen = flat_generated_checks(sm, elementwise, program, flat_generated_cases(dev, SEED))
    log(f"check ew_flat's generated kernel = interpreter, bit for bit: {n_gen} programs (every "
        "opcode and cast on float32, int32, uint32, bool and bfloat16, scalar operands, bfloat16 "
        f"2 bytes off, MAX_INSTS instructions), n={N_FLAT_GEN}, {time.perf_counter() - t0:.1f} s")

    # ew_flat beyond one instruction on two full operands: bit for bit the
    # plain interpreter's values, and ew_strided's on the same program
    # (operands read backwards take the strided entry point).
    n_flat = xf.numel()
    check(n_flat % 4 != 0, "the flat checks need a ragged tail")
    lx, ly, ls = (program.leaf((n_flat,), torch.float32), program.leaf((n_flat,), torch.float32),
                  program.leaf((), torch.float32))
    scalar = yf[7].reshape(())
    flat_cases = [
        ("chain a*b+a-b", program.lower(lx * ly + lx - ly, [lx, ly]), [xf, yf]),
        ("scalar on the right", program.lower(lx / ls, [lx, ls]), [xf, scalar]),
        ("scalar on the left", program.lower(ls - lx, [ls, lx]), [scalar, xf]),
        ("constant", program.lower(lx * 2.5, [lx]), [xf]),
        ("bool store", program.lower(lx > ly, [lx, ly]), [xf, yf]),
        ("one operand twice", program.lower(lx + lx, [lx]), [xf]),
    ]
    elementwise.reset_launches()
    for label, prog, operands in flat_cases:
        k, p = both(prog, (n_flat,), operands)
        check(k.dtype == p.dtype and exact(k, p), f"ew_flat {label}: differs from the plain interpreter")
        backwards = [elementwise.View(o, n_flat - 1, (n_flat,), (-1,)) if o.dim() else o
                     for o in operands]
        k2 = elementwise.elementwise(prog, (n_flat,), prog.dtype, *backwards, name="check")
        check(exact(k.flip(0), k2), f"ew_flat {label}: differs from ew_strided")
    check(elementwise.LAUNCHES == {"ew_flat": len(flat_cases), "ew_strided": len(flat_cases)},
          f"the flat checks launched {elementwise.LAUNCHES}")
    l_off = program.leaf((n_flat - 1,), torch.float32)
    k, p = both(program.lower(l_off * l_off, [l_off]), (n_flat - 1,), [xf[1:]])
    check(exact(k, p), "ew_flat on an operand 4 bytes off differs from the plain interpreter")
    log(f"check ew_flat n={n_flat} (16-byte path and a tail of {n_flat % 4}): a chain, a scalar on "
        "either side, a constant, a bool store, an operand 4 bytes off: the plain interpreter's "
        "bits, and ew_strided's")

    # Crafted transcendentals against float64 (the JAX package's bounds).
    sweep = np.linspace(0.01, 20.0, N_ADD).astype(np.float32)
    pb = np.linspace(0.5, 4.0, N_ADD).astype(np.float32)
    pe = np.linspace(-3.0, 3.0, N_ADD).astype(np.float32)
    f64 = sweep.astype(np.float64)
    got = sm.exp(sm.Array(-sweep / 4)).numpy()
    np.testing.assert_allclose(got, np.exp(-f64 / 4), rtol=1e-6, err_msg="exp")
    got = sm.log(sm.Array(sweep)).numpy()
    np.testing.assert_allclose(got, np.log(f64), rtol=1e-6, atol=1e-6, err_msg="log")
    got = sm.pow(sm.Array(pb), sm.Array(pe)).numpy()
    np.testing.assert_allclose(got, np.power(pb.astype(np.float64), pe.astype(np.float64)),
                               rtol=4e-6, err_msg="pow")
    wide = np.linspace(-87.0, 88.0, N_ADD).astype(np.float32)
    ulps = {
        "exp": ulp_vs_f64(sm.exp(sm.Array(wide)).torch(), np.exp(wide.astype(np.float64))),
        "log": ulp_vs_f64(sm.log(sm.Array(sweep)).torch(), np.log(f64)),
        "exp2": ulp_vs_f64(sm.exp2(sm.Array(wide)).torch(), np.exp2(wide.astype(np.float64))),
        "log2": ulp_vs_f64(sm.log2(sm.Array(sweep)).torch(), np.log2(f64)),
        "tanh": ulp_vs_f64(sm.tanh(sm.Array(wide / 8)).torch(),
                           np.tanh(wide.astype(np.float64) / 8)),
    }
    for name, u in ulps.items():
        check(u < 4.0, f"crafted {name} is {u} ulp from float64")
    log("check crafted vs float64: exp/log/pow within the crafted bounds; ulps "
        + json.dumps(ulps))

    base = rng.integers(-4, 5, N_ADD).astype(np.int32)
    expo = rng.integers(-6, 12, N_ADD).astype(np.int32)
    got = sm.pow(sm.Array(base), sm.Array(expo))
    lb, le = program.leaf((N_ADD,), torch.int32), program.leaf((N_ADD,), torch.int32)
    k, p = both(program.lower(engine.pow_expr(lb, le), [lb, le]), (N_ADD,), [on(base), on(expo)])
    check(exact(k, p) and exact(got.torch(), p), "int32 ipow disagrees with its plain version")
    want = np.where(expo >= 0, base.astype(np.int64) ** np.maximum(expo, 0),
                    np.where(base == 1, 1, np.where(base == -1, np.where(expo % 2 == 0, 1, -1), 0)))
    check(np.array_equal(got.numpy(), want.astype(np.int32)), "int32 ipow is wrong")
    log("check int32 ipow with negative exponents: exact")

    xs = np.concatenate([rng.uniform(0.5, 2.0, N_ADD - 4), [1.0, -1.5, 0.0, 3.0]]).astype(np.float32)
    for e in (-3, 2, 7):
        leaf = program.leaf((N_ADD,), torch.float32)
        k, p = both(program.lower(engine.pow_expr(leaf, e), [leaf]), (N_ADD,), [on(xs)])
        check(exact(k, p), f"static pow e={e} disagrees with its plain version")
        with np.errstate(divide="ignore"):
            ref = xs.astype(np.float64) ** e
        np.testing.assert_allclose(k.cpu().numpy(), ref, rtol=1e-6, err_msg=f"powi {e}")
    log("check static pow e in (-3, 2, 7): exact")

    generated_phase(gen, "3")
    # -------------------------------------------- 4. the two workloads
    def chain(acc, a, e_row):
        return acc * np.float32(1e-3) + sm.exp(sm.pow(a + acc * np.float32(1e-6), e_row))

    add_a = sm.Array(rng.standard_normal(N_ADD).astype(np.float32))
    add_b = sm.Array(rng.standard_normal(N_ADD).astype(np.float32))
    a_np = rng.uniform(0.5, 2.0, sq).astype(np.float32)
    e_np = rng.uniform(-2.0, 2.0, (1, N_FUSED)).astype(np.float32)
    acc0, fa, fe = sm.zeros(*sq), sm.Array(a_np), sm.Array(e_np)
    fused = {L: sm.fuse(chain, donate=0, iterations=L) for L in (16, 400)}
    torch.cuda.synchronize()

    elementwise.reset_launches()
    dispatch.reset()
    c = sm.add(add_a, add_b).torch()
    after_add = dict(elementwise.LAUNCHES)
    outs = {L: fused[L](acc0, fa, fe).torch() for L in (16, 400)}
    torch.cuda.synchronize()
    launches = dict(elementwise.LAUNCHES)
    strided_paths = dict(elementwise.PATHS)
    log(f"main path launches {launches} ew_strided by kernel {strided_paths} "
        f"dispatch {dispatch.counts()}")
    check(after_add == {"ew_flat": 1, "ew_strided": 0}, f"sm.add launched {after_add}")
    check(launches == {"ew_flat": 1, "ew_strided": 2}, f"main path launched {launches}")
    check(strided_paths == {"interp": 0, "generated": 2},
          f"the recurrences took ew_strided's kernels {strided_paths}")
    compile_ms = list(codegen.COMPILE_MS)
    log(f"generated kernels so far: {codegen.STATS} (NVRTC compiles, CUBINs read from "
        f"build/kernels/generated, launches served by a loaded kernel); NVRTC ms per new "
        f"signature: median {statistics.median(compile_ms) if compile_ms else None}, "
        f"max {max(compile_ms, default=None)}, count {len(compile_ms)}")
    check(bool((acc0.torch() == 0).all()), "donate=0 wrote into the caller's array")
    # The flat chain a * b + c - a on 16M floats through sm.fuse: one ew_flat
    # launch, on the kernel generated for its program.  The data of the
    # generated routes' checks come from a generator of their own, so that
    # every other check draws the inputs it always drew.
    rng_gen = np.random.default_rng(SEED + 20)
    chain_np = [rng_gen.standard_normal(N_CHAIN).astype(np.float32) for _ in range(3)]
    chain_arrays = [sm.Array(on(x)) for x in chain_np]
    flat_chain = sm.fuse(lambda a, b, c: a * b + c - a)
    torch.cuda.synchronize()
    elementwise.reset_launches()
    chain_out = flat_chain(*chain_arrays).torch()
    torch.cuda.synchronize()
    flat_launches = dict(elementwise.FLAT_PATHS)
    check(flat_launches == {"wide": 0, "element": 0, "generated": 1},
          f"the 16M chain took ew_flat's {flat_launches}")
    x0, x1, x2 = (torch.from_numpy(x) for x in chain_np)
    err_chain = float((chain_out.cpu() - (x0 * x1 + x2 - x0)).abs().max())
    check(err_chain == 0.0, f"the 16M chain is off its plain version by {err_chain}")
    del chain_np, x0, x1, x2, chain_arrays
    log("check sm.fuse(a * b + c - a) 16M f32: one launch of ew_flat's generated kernel, exact")

    err_add = float((c - (add_a.torch() + add_b.torch())).abs().max())
    check(err_add == 0.0, f"sm.add is off by {err_add}")
    leaves = [program.leaf(sq, torch.float32), program.leaf(sq, torch.float32),
              program.leaf((1, N_FUSED), torch.float32)]
    prog = program.lower(chain(*leaves), leaves)
    plain_in = [acc0.torch(), fa.torch(), fe.torch()]
    err_fused = 0.0
    for L, out in outs.items():
        check(tuple(out.shape) == sq and out.dtype == torch.float32, "wrong result shape")
        check(bool(torch.isfinite(out).all()), f"L={L}: non-finite values")
        ref = program.run_plain(prog, plain_in, sq, L, 0)
        u = max_ulp(out, ref)
        err_fused = max(err_fused, float((out - ref).abs().max()))
        check(u <= 2.0, f"L={L}: {u} ulp from the plain version")
        acc = np.zeros((64, N_FUSED))
        a64, e64 = a_np[:64].astype(np.float64), e_np.astype(np.float64)
        for _ in range(L):
            acc = acc * 1e-3 + np.exp(np.power(a64 + acc * 1e-6, e64))
        np.testing.assert_allclose(out[:64].cpu().numpy(), acc, rtol=2e-5,
                                   err_msg=f"fused L={L} vs float64")
        log(f"check fused recurrence L={L}: {u} ulp from the plain version, "
            "within 2e-5 of float64 on 64 rows")

    generated_phase(gen, "4")
    # ----------------------------------------------------- 5. reductions
    err_rd = reduction_checks(dev, rng, sm, elementwise, program, reduction)
    t0 = time.perf_counter()
    walks = reduction_generated_checks(reduction, reduction_generated_cases(dev, SEED))
    log(f"check the generated evaluators = reduction.interpret, bit for bit: walks "
        f"{sorted(walks)}, sum/max/min, float32, bfloat16 and float16, "
        f"{time.perf_counter() - t0:.1f} s")

    x_np = rng.standard_normal(N_SUM).astype(np.float32)
    x_big = sm.Array(on(x_np))
    da, db = sm.Array(x_big.torch()[:N_DOT]), sm.Array(x_big.torch()[N_DOT:])
    da_np, db_np = x_np[:N_DOT].astype(np.float64), x_np[N_DOT:].astype(np.float64)
    eps_np = np.asarray(np.float32(1e-3))
    eps = sm.Array(eps_np)
    mat = sm.Array(x_big.torch().reshape(N_AXIS, N_AXIS))
    thr = sm.Array(np.full((1, 1), 0.25, np.float32))
    dist = sm.fuse(lambda a, b, e: sm.sum(sm.square(a + e - b)))
    axis_sum = {ax: sm.fuse(lambda a, s, ax=ax: sm.sum(sm.where(a > s, a, 0.0), axis=ax))
                for ax in (0, 1)}
    mat_np = x_np.reshape(N_AXIS, N_AXIS)
    row_np = rng_gen.standard_normal((1, N_AXIS)).astype(np.float32)
    col_np = rng_gen.standard_normal((N_AXIS, 1)).astype(np.float32)
    row8, col8 = sm.Array(row_np), sm.Array(col_np)
    map_rows = sm.fuse(lambda a, r, c: sm.sum(a * r - c))
    rows64 = (mat_np * row_np - col_np).astype(np.float64)  # f32 ops, each rounded, as the kernel's
    sel64 = np.where(mat_np > np.float32(0.25), mat_np, np.float32(0)).astype(np.float64)
    x64 = x_np.astype(np.float64)
    calls = [
        ("Array.sum() 64M f32", lambda: x_big.sum(), x64.sum(), np.abs(x64).sum(),
         {"rd_full": 1, "rd_axis": 0}),
        ("sm.dot 2x32M f32", lambda: sm.dot(da, db), da_np @ db_np, np.abs(da_np * db_np).sum(),
         {"rd_full": 1, "rd_axis": 0}),
        ("fused sum(square(a+eps-b)) 32M", lambda: dist(da, db, eps),
         ((da_np + 1e-3 - db_np) ** 2).sum(), ((da_np + 1e-3 - db_np) ** 2).sum(),
         {"rd_full": 1, "rd_axis": 0}),
        ("fused sum(where(a>s,a,0),axis=0) 8192^2", lambda: axis_sum[0](mat, thr),
         sel64.sum(0), np.abs(sel64).sum(0), {"rd_full": 0, "rd_axis": 1}),
        ("fused sum(where(a>s,a,0),axis=1) 8192^2", lambda: axis_sum[1](mat, thr),
         sel64.sum(1), np.abs(sel64).sum(1), {"rd_full": 0, "rd_axis": 1}),
        ("lazy sm.sum(sm.square(sm.subtract(a,b))) 32M",
         lambda: sm.sum(sm.square(sm.subtract(da, db))),
         ((da_np - db_np) ** 2).sum(), ((da_np - db_np) ** 2).sum(), {"rd_full": 1, "rd_axis": 0}),
        ("fused sum(a*row-col) 8192^2", lambda: map_rows(mat, row8, col8), rows64.sum(),
         np.abs(rows64).sum(), {"rd_full": 1, "rd_axis": 0}),
    ]
    torch.cuda.synchronize()
    reduction.reset_launches()
    elementwise.reset_launches()
    outs, rd_generated = [], {}
    for label, call, _, _, want in calls:
        before, paths = dict(reduction.LAUNCHES), dict(reduction.PATHS)
        outs.append(call().torch())
        got = {k: reduction.LAUNCHES[k] - before[k] for k in before}
        check(got == want, f"{label}: launched {got}, expected {want}")
        rd_generated[label] = reduction.PATHS["generated"] - paths["generated"]
    torch.cuda.synchronize()
    rd_launches, rd_paths = dict(reduction.LAUNCHES), dict(reduction.PATHS)
    rd_ew = dict(elementwise.LAUNCHES)
    log(f"reduction path launches {rd_launches} by path {rd_paths} elementwise {rd_ew}")
    check(rd_ew == {"ew_flat": 0, "ew_strided": 0}, f"the reduction path launched {rd_ew}")
    # Array.sum() is the identity, sm.dot one instruction; the fused roots
    # and the lazy chain are programs of two and three, on their generated
    # evaluators.
    check(rd_paths == {"direct": 1, "single": 1, "generated": 5, "interp": 0},
          f"the reduction path's launches took {rd_paths}")
    for (label, _, ref, absx, _), out in zip(calls, outs):
        got = out.double().cpu().numpy()
        check(out.dtype == torch.float32 and got.shape == np.shape(ref), f"{label}: wrong result")
        check(bool(np.isfinite(got).all()), f"{label}: non-finite result")
        check(bool(np.all(np.abs(got - ref) <= 2e-5 * absx)), f"{label}: beyond 2e-5*sum|x| of float64")
        log(f"check {label}: within 2e-5*sum|x| of float64, one launch, no elementwise pass")

    generated_phase(gen, "5")
    # ---------------------- 5b. bfloat16, uint32, integer floor division
    # Through the public API: the 1M add in bfloat16 and in uint32, int32 //
    # of 1M (divisors 0 and -1 among them), the L = 400 recurrence on
    # bfloat16 arrays, Array.sum() of the 64M values in bfloat16 and in
    # float16, and the axis-0 sum of them as an (8192, 8192) bfloat16 matrix.
    # The bfloat16 add and sums take the 2-byte quad paths (ew_flat "wide",
    # rd_* "direct"), by their counters, and give the bits of the element
    # path on the same values 2 bytes off.
    bf_a, bf_b = sm.Array(add_a.torch().bfloat16()), sm.Array(add_b.torch().bfloat16())
    u_np = [rng.integers(0, 2**32, N_ADD, dtype=np.uint64).astype(np.uint32) for _ in range(2)]
    u_a, u_b = (sm.Array(x) for x in u_np)
    i_np = rng.integers(-2**31, 2**31, N_ADD, dtype=np.int64).astype(np.int32)
    d_np = rng.integers(-1000, 1000, N_ADD).astype(np.int32)
    d_np[d_np == 0] = 3
    d_np[:4] = [0, -1, 0, -1]
    i_np[:4] = [7, -2**31, 0, 5]
    i_a, i_d = sm.Array(i_np), sm.Array(d_np)
    def chain16(acc, a, e_row):  # the recurrence with weak constants: bfloat16 throughout
        return acc * 1e-3 + sm.exp(sm.pow(a + acc * 1e-6, e_row))

    sq16 = sq
    acc16, fa16, fe16 = sm.zeros(*sq16, dtype="bfloat16"), sm.Array(fa.torch().bfloat16()), \
        sm.Array(fe.torch().bfloat16())
    fused16 = sm.fuse(chain16, donate=0, iterations=400)
    x16 = sm.Array(x_big.torch().bfloat16())
    m16 = sm.Array(x16.torch().reshape(N_AXIS, N_AXIS))
    xh = sm.Array(x_big.torch().half())
    fused16(acc16, fa16, fe16).torch()  # NVRTC compiles the bfloat16 program's kernel once
    torch.cuda.synchronize()
    fsum16 = sm.fuse(lambda a: sm.sum(a * a + a))
    half_calls = [
        ("ew_flat_bf16", "sm.add 1M bfloat16", lambda: sm.add(bf_a, bf_b)),
        ("ew_flat_uint32", "sm.add 1M uint32", lambda: sm.add(u_a, u_b)),
        ("ew_flat_idiv", "int32 // 1M", lambda: i_a // i_d),
        ("ew_strided_bf16", "fused recurrence L=400 bfloat16", lambda: fused16(acc16, fa16, fe16)),
        ("rd_full_bf16", "Array.sum() 64M bfloat16", lambda: x16.sum()),
        ("rd_axis_bf16", "Array.sum(axis=0) (8192, 8192) bfloat16", lambda: m16.sum(axis=0)),
        ("rd_full_f16", "Array.sum() 64M float16", lambda: xh.sum()),
        ("rd_full_bf16_fused", "sm.fuse sum(a*a+a) 1M bfloat16", lambda: fsum16(bf_a)),
    ]
    half_out, half_launches, half_paths = {}, {}, {}
    for key, label, call in half_calls:
        elementwise.reset_launches()
        reduction.reset_launches()
        dispatch.reset()
        half_out[key] = call().torch()
        torch.cuda.synchronize()
        half_launches[key] = {**elementwise.LAUNCHES, **reduction.LAUNCHES}
        half_paths[key] = {**{f"ew_flat:{k}": v for k, v in elementwise.FLAT_PATHS.items() if v},
                           **{f"rd:{k}": v for k, v in reduction.PATHS.items() if v}}
        counts = dispatch.counts()
        check(not any(k.startswith("torch_path") for k in counts),
              f"{label} took the plain torch route: {counts}")
        log(f"{label}: launches {half_launches[key]} paths {half_paths[key]} dispatch {counts}")
    check(half_launches["ew_flat_bf16"]["ew_flat"] == 1 and half_launches["ew_flat_uint32"]["ew_flat"] == 1
          and half_launches["ew_flat_idiv"]["ew_flat"] == 1, "a 1M op did not launch ew_flat once")
    check(half_launches["ew_strided_bf16"]["ew_strided"] == 1, "the bfloat16 recurrence did not "
          "launch ew_strided once")
    check(half_launches["rd_full_bf16"]["rd_full"] == 1, "the bfloat16 sum did not launch rd_full once")
    check(half_launches["rd_axis_bf16"]["rd_axis"] == 1 and half_launches["rd_full_f16"]["rd_full"] == 1,
          "the bfloat16 axis sum or the float16 sum did not launch its kernel once")
    # The 2-byte quad paths, by their counters.
    for key, want in (("ew_flat_bf16", {"ew_flat:wide": 1}), ("rd_full_bf16", {"rd:direct": 1}),
                      ("rd_axis_bf16", {"rd:direct": 1}), ("rd_full_f16", {"rd:direct": 1})):
        check(half_paths[key] == want, f"{key} took {half_paths[key]}, not {want}")
    check(half_launches["rd_full_bf16_fused"]["rd_full"] == 1
          and half_launches["rd_full_bf16_fused"]["ew_flat"] == 0,
          "the bfloat16 fused reduction root did not launch rd_full once, alone")
    half_err = {}
    want = (add_a.torch().bfloat16().float() + add_b.torch().bfloat16().float()).bfloat16()
    check(torch.equal(bits(half_out["ew_flat_bf16"]), bits(want)), "sm.add bfloat16 is not the "
          "float32 sum rounded once")
    half_err["ew_flat_bf16"] = 0.0
    # The same add and sums on the element path: the same values 2 bytes off.
    add16 = binop("add", (N_ADD,), (N_ADD,), torch.bfloat16)
    a_off, b_off = two_bytes_off(bf_a.torch()), two_bytes_off(bf_b.torch())
    elementwise.reset_launches()
    add_off = elementwise.elementwise(add16, (N_ADD,), torch.bfloat16, a_off, b_off)
    torch.cuda.synchronize()
    check(elementwise.FLAT_PATHS == {"wide": 0, "element": 1, "generated": 0}, "the add 2 bytes off took "
          f"{elementwise.FLAT_PATHS}, not the element path")
    check(torch.equal(half_out["ew_flat_bf16"].view(torch.int16), add_off.view(torch.int16)),
          "sm.add bfloat16 on the wide path differs from the element path")
    x16_off = two_bytes_off(x16.torch())
    for key, fn, fn_off in (
            ("rd_full_bf16", lambda: reduction.reduce(x16.torch(), "sum"),
             lambda: reduction.reduce(x16_off, "sum")),
            ("rd_axis_bf16", lambda: reduction.reduce_axis(m16.torch(), "sum", 0),
             lambda: reduction.reduce_axis(x16_off.view(N_AXIS, N_AXIS), "sum", 0))):
        reduction.reset_launches()
        k32, e32 = fn(), fn_off()
        torch.cuda.synchronize()
        check(reduction.PATHS == {"direct": 1, "single": 0, "generated": 1, "interp": 0},
              f"{key}: the quad and element runs took {reduction.PATHS}")
        check(same_bits(k32, e32), f"{key}: the direct path differs from the element path")
        check(torch.equal(bits(k32.bfloat16()), bits(half_out[key])), f"{key}: Array.sum is not "
              "the kernel's float32 sum rounded once")
    del x16_off, a_off, b_off
    want_u = (u_np[0].astype(np.uint64) + u_np[1].astype(np.uint64)) % 2**32
    check(np.array_equal(bits(half_out["ew_flat_uint32"]).cpu().numpy().view(np.uint32),
                         want_u.astype(np.uint32)), "sm.add uint32 does not wrap mod 2**32")
    half_err["ew_flat_uint32"] = 0.0
    li, ld = program.leaf((N_ADD,), torch.int32), program.leaf((N_ADD,), torch.int32)
    idiv_prog = program.lower(li // ld, [li, ld])
    want_i = program.run_plain(idiv_prog, [i_a.torch(), i_d.torch()], (N_ADD,))
    check(exact(half_out["ew_flat_idiv"], want_i), "int32 // differs from its plain version")
    q = np.floor_divide(i_np[4:].astype(np.int64), d_np[4:].astype(np.int64))
    check(np.array_equal(half_out["ew_flat_idiv"].cpu().numpy()[4:], q.astype(np.int32)),
          "int32 // is not numpy's floor division")
    check(half_out["ew_flat_idiv"].cpu().numpy()[:4].tolist() == [-2, -2**31, -1, -5],
          "int32 // by 0 and -1 is not XLA's")
    half_err["ew_flat_idiv"] = 0.0
    leaves16 = [program.leaf(sq16, torch.bfloat16), program.leaf(sq16, torch.bfloat16),
                program.leaf((1, N_FUSED), torch.bfloat16)]
    prog16 = program.lower(chain16(*leaves16), leaves16)
    check(prog16.dtype == torch.bfloat16 and any(prog16.kernel_rounds),
          "the bfloat16 recurrence does not compute in bfloat16")
    plain16_in = [acc16.torch(), fa16.torch(), fe16.torch()]
    ref16 = program.run_plain(prog16, plain16_in, sq16, 400, 0)
    u16 = max_bf16_ulp(half_out["ew_strided_bf16"], ref16)
    check(u16 <= 2.0, f"the bfloat16 recurrence is {u16} bfloat16 ulp from its plain version")
    half_err["ew_strided_bf16"] = float((half_out["ew_strided_bf16"].float() - ref16.float()).abs().max())
    x16_64 = x16.torch().double()
    k16 = half_out["rd_full_bf16"]
    check(k16.dtype == torch.bfloat16, "Array.sum() of bfloat16 is not bfloat16")
    p16 = reduction._plain(x16.torch(), "sum").bfloat16()
    check(abs(float(k16) - float(x16_64.sum())) <= 2e-5 * float(x16_64.abs().sum()),
          "the bfloat16 sum is beyond 2e-5*sum|x| of float64")
    half_err["rd_full_bf16"] = abs(float(k16) - float(p16))
    m16_64 = m16.torch().double()
    ka = half_out["rd_axis_bf16"]
    pa16 = reduction._plain(m16.torch(), "sum", 0).bfloat16()
    check(ka.dtype == torch.bfloat16 and bool((ka.double() - m16_64.sum(0)).abs().le(
        2e-5 * m16_64.abs().sum(0) + 2.0 ** -8 * m16_64.sum(0).abs()).all()),
        "the bfloat16 axis-0 sum is beyond 2e-5*sum|x| and one bfloat16 rounding of float64")
    half_err["rd_axis_bf16"] = float((ka.float() - pa16.float()).abs().max())
    xh64 = xh.torch().double()
    kh = half_out["rd_full_f16"]
    check(kh.dtype == torch.float16 and abs(float(kh) - float(xh64.sum()))
          <= 2e-5 * float(xh64.abs().sum()) + 2.0 ** -11 * abs(float(xh64.sum())),
          "the float16 sum is beyond 2e-5*sum|x| and one float16 rounding of float64")
    half_err["rd_full_f16"] = abs(float(kh) - float(reduction._plain(xh.torch(), "sum").half()))
    la = program.leaf((N_ADD,), torch.bfloat16)
    mapped = program.run_plain(program.lower(la * la + la, [la]), [bf_a.torch()], (N_ADD,)).double()
    kf = half_out["rd_full_bf16_fused"]
    check(kf.dtype == torch.bfloat16 and abs(float(kf) - float(mapped.sum()))
          <= 2e-5 * float(mapped.abs().sum()) + 2.0 ** -8 * abs(float(mapped.sum())),
          "the bfloat16 fused reduction root is beyond 2e-5*sum|v| and one bfloat16 rounding "
          "of float64")
    log(f"check bfloat16/uint32/int32 // main path: the bfloat16 add the float32 sum rounded once, "
        f"uint32 wrapping, // numpy's floor division and XLA's at 0 and -1, the recurrence within "
        f"{u16} bfloat16 ulp of its plain version, the sum and the fused root's within 2e-5*sum|x| "
        f"of float64; |kernel - plain| {half_err}")

    generated_phase(gen, "5b")
    # ---------------------------------------- 5c. sm ops under torch.func
    ahead_mm.join()
    transform_checks(dev, rng, sm, elementwise, reduction, matmul, dispatch)

    generated_phase(gen, "5c")
    # -------------------------------------------------------- 6. timing
    check(not dispatch.INTERPRET.get(), "the wrappers run their plain versions: nothing is timed")
    add_prog = binop("add", (N_ADD,), (N_ADD,))
    at, bt = add_a.torch(), add_b.torch()
    # The add twice.  Hot: its 12 MB stay in the 50 MB L2 across a run, as
    # they do for a caller that adds the same arrays again.  Past the L2: a
    # ring of operands, and of results kept alive so that each call writes
    # other memory, 192 MB in all, as the reductions are timed; that is the
    # time the kernels line holds against the bound at the device-memory
    # rate.  torch.add, the library's call, is timed both ways too.
    ring = [(sm.Array(on(rng.standard_normal(N_ADD).astype(np.float32))),
             sm.Array(on(rng.standard_normal(N_ADD).astype(np.float32)))) for _ in range(ADD_RING)]
    kept, turn = [None] * ADD_RING, [0]

    def rotated(fn):
        def call():
            i = turn[0] = (turn[0] + 1) % ADD_RING
            kept[i] = fn(*ring[i])
        return call

    t = {
        "add_hot_ms": time_ms(lambda: sm.add(add_a, add_b).torch(), n=100),
        "add_hot_plain_ms": time_ms(lambda: program.run_plain(add_prog, [at, bt], (N_ADD,)), n=100),
        "add_hot_library_ms": time_ms(lambda: torch.add(at, bt), n=100),
        "add_ms": time_ms(rotated(lambda a, b: sm.add(a, b).torch()), n=100),
        "add_plain_ms": time_ms(rotated(lambda a, b: program.run_plain(
            add_prog, [a.torch(), b.torch()], (N_ADD,))), n=100),
        "add_library_ms": time_ms(rotated(lambda a, b: torch.add(a.torch(), b.torch())), n=100),
        "add_host_ms": host_ms(lambda: sm.add(add_a, add_b).torch()),
    }
    t["add_hot_over_library"] = t["add_hot_ms"] / t["add_hot_library_ms"]
    t["add_over_library"] = t["add_ms"] / t["add_library_ms"]
    del ring, kept
    # Phase 4's chain of three instructions on 16M floats (256 MB: device
    # memory): ew_flat's kernel generated for its program, beside the
    # interpreter (elementwise.interpret) on the same arrays.
    chain_in = [on(rng.standard_normal(N_CHAIN).astype(np.float32)) for _ in range(3)]
    chain_arrays = [sm.Array(x) for x in chain_in]
    lc = [program.leaf((N_CHAIN,), torch.float32) for _ in range(3)]
    chain_prog = program.lower(lc[0] * lc[1] + lc[2] - lc[0], lc)
    t["chain_16m_ms"] = time_ms(lambda: flat_chain(*chain_arrays).torch(), n=10)
    t["chain_16m_plain_ms"] = time_ms(
        lambda: program.run_plain(chain_prog, chain_in, (N_CHAIN,)), n=10)
    t["chain_16m_interp_ms"] = time_ms(
        lambda: elementwise.interpret(chain_prog, (N_CHAIN,), *chain_in), n=10)
    t["chain_16m_bound_ms"] = bound(16 * N_CHAIN, 3 * N_CHAIN)[0]
    t["chain_16m_ptxas"] = codegen.ptxas(elementwise.signature(
        chain_prog, chain_prog.kernel_codes, (N_CHAIN,), chain_in, flat=True))
    del chain_in, chain_arrays
    for L in (16, 400):
        t[f"fused{L}_ms"] = time_ms(lambda: fused[L](acc0, fa, fe).torch(), n=4 if L == 16 else 1)
        t[f"fused{L}_plain_ms"] = time_ms(
            lambda: program.run_plain(prog, plain_in, sq, L, 0), reps=3 if L == 16 else 1)
        t[f"fused{L}_host_ms"] = host_ms(lambda: fused[L](acc0, fa, fe).torch())
        # The same program on the same arrays through ew_strided's interpreter.
        t[f"fused{L}_interp_ms"] = time_ms(
            lambda: elementwise.interpret(prog, sq, *plain_in, iterations=L, carry=0),
            n=4 if L == 16 else 1)
    log(f"times on {card}: " + json.dumps(t))

    # The reductions: kernel and plain version on the same inputs, each a
    # run of calls over 256 MB (past the 50 MB L2), and the bytes each call
    # must read once.
    xt, at_, bt_ = x_big.torch(), da.torch(), db.torch()
    mt, st = mat.torch(), thr.torch()
    et = eps.torch()

    def leaves_of(*ts):
        return [program.leaf(tuple(x.shape), x.dtype) for x in ts]

    def traced(fn, *ts):
        ls = leaves_of(*ts)
        red = fn(*ls)
        return program.lower(red.expr, ls)

    la, lb = leaves_of(at_, bt_)
    p_dot = program.lower(program.apply("multiply", la, lb), [la, lb])
    p_dist = traced(lambda a, b, e: sm.sum(sm.square(a + e - b)), at_, bt_, et)
    p_thr = {ax: traced(lambda a, s, ax=ax: sm.sum(sm.where(a > s, a, 0.0), axis=ax), mt, st)
             for ax in (0, 1)}
    sq = (N_AXIS, N_AXIS)

    def plain(prog, ops, shape, dim=None):
        return reduction._plain(program.run_plain(prog, ops, shape), "sum", dim)

    gb = {"sum": 4 * N_SUM, "dot": 8 * N_DOT, "dist": 8 * N_DOT, "axis0": 4 * N_SUM,
          "axis1": 4 * N_SUM}
    p_one = times_one((N_SUM,))
    p_two = times_one_plus_zero((N_SUM,))

    def timed_on(path, fn):
        """``time_ms(fn, n=20)``, every launch of it on ``path``."""
        before = dict(reduction.PATHS)
        ms = time_ms(fn, n=20)
        took = {p for p, c in reduction.PATHS.items() if c != before[p]}
        check(took == {path}, f"a timed reduction ran on {took}, not on path {path}")
        return ms

    rt = {
        "sum_ms": timed_on("direct", lambda: reduction.reduce(xt, "sum")),
        "sum_plain_ms": time_ms(lambda: reduction._plain(xt, "sum"), n=20),
        "sum_single_ms": timed_on("single", lambda: reduction.map_reduce(p_one, "sum", (N_SUM,), xt)),
        "sum_generated_ms": timed_on(
            "generated", lambda: reduction.map_reduce(p_two, "sum", (N_SUM,), xt)),
        "sum_interp_ms": timed_on(
            "interp", lambda: reduction.interpret(p_two, "sum", None, (N_SUM,), [xt])),
        "dot_ms": timed_on("single", lambda: reduction.dot1d(at_, bt_)),
        "dot_plain_ms": time_ms(lambda: plain(p_dot, [at_, bt_], (N_DOT,)), n=20),
        "dist_ms": timed_on(
            "generated", lambda: reduction.map_reduce(p_dist, "sum", (N_DOT,), at_, bt_, et)),
        "dist_interp_ms": timed_on(
            "interp", lambda: reduction.interpret(p_dist, "sum", None, (N_DOT,), [at_, bt_, et])),
        "dist_plain_ms": time_ms(lambda: plain(p_dist, [at_, bt_, et], (N_DOT,)), n=20),
    }
    for ax in (0, 1):
        rt[f"axis{ax}_ms"] = timed_on(
            "generated", lambda: reduction.map_reduce_axis(p_thr[ax], "sum", ax, sq, mt, st))
        rt[f"axis{ax}_interp_ms"] = timed_on(
            "interp", lambda: reduction.interpret(p_thr[ax], "sum", ax, sq, [mt, st]))
        rt[f"axis{ax}_plain_ms"] = time_ms(lambda: plain(p_thr[ax], [mt, st], sq, ax), n=20)
    # _build_map_reduce_2d's case, phase 5's: a * row - col over (8192,
    # 8192), a (1, C) row and an (R, 1) column, reduced in full along the
    # rows.
    row8, col8 = on(rng.standard_normal((1, N_AXIS)).astype(np.float32)), \
        on(rng.standard_normal((N_AXIS, 1)).astype(np.float32))
    lm, lr, lc = leaves_of(mt, row8, col8)
    p_rows = program.lower(lm * lr - lc, [lm, lr, lc])
    rt["rows_ms"] = timed_on("generated", lambda: reduction.map_reduce(p_rows, "sum", sq, mt, row8, col8))
    rt["rows_interp_ms"] = timed_on(
        "interp", lambda: reduction.interpret(p_rows, "sum", None, sq, [mt, row8, col8]))
    rt["rows_plain_ms"] = time_ms(lambda: plain(p_rows, [mt, row8, col8], sq), n=20)
    rt["ptxas"] = {key: codegen.ptxas(reduction.signature(prog_, prog_.kernel_codes, 0, shape_,
                                                          ops_, ax_))
                   for key, prog_, shape_, ops_, ax_ in (
                       ("dist", p_dist, (N_DOT,), [at_, bt_, et], None),
                       ("rows", p_rows, sq, [mt, row8, col8], None),
                       ("axis0", p_thr[0], sq, [mt, st], 0), ("axis1", p_thr[1], sq, [mt, st], 1))}
    rt["sum_host_ms"] = host_ms(lambda: x_big.sum().torch())
    rt["dist_host_ms"] = host_ms(lambda: dist(da, db, eps).torch())
    for key, nbytes in gb.items():
        rt[f"{key}_GBps"] = nbytes / (rt[f"{key}_ms"] * 1e-3) / 1e9
        rt[f"{key}_plain_GBps"] = nbytes / (rt[f"{key}_plain_ms"] * 1e-3) / 1e9
    for key in ("sum_single", "sum_generated", "sum_interp"):
        rt[f"{key}_GBps"] = gb["sum"] / (rt[f"{key}_ms"] * 1e-3) / 1e9
    log(f"reduction times on {card}: " + json.dumps(rt))


    # The library yardsticks of the earlier kernels: one PyTorch call that
    # computes the same function on the same inputs (the port never calls
    # them).  The fused chains have none.
    lib = {
        "add": t["add_library_ms"],
        "sum": time_ms(lambda: torch.sum(xt), n=20),
        "dot": time_ms(lambda: torch.dot(at_, bt_), n=20),
        "axis0": time_ms(lambda: torch.sum(mt, 0), n=20),
        "axis1": time_ms(lambda: torch.sum(mt, 1), n=20),
    }
    for ax in (0, 1):
        rt[f"axis{ax}_identity_ms"] = timed_on("direct", lambda: reduction.reduce_axis(mt, "sum", ax))
        rt[f"axis{ax}_identity_plain_ms"] = time_ms(lambda: reduction._plain(mt, "sum", ax), n=20)
    lib["dot_over_library"] = rt["dot_ms"] / lib["dot"]
    lib["sum_over_library"] = rt["sum_ms"] / lib["sum"]
    lib["axis0_over_library"] = rt["axis0_identity_ms"] / lib["axis0"]
    lib["axis1_over_library"] = rt["axis1_identity_ms"] / lib["axis1"]

    # bfloat16, uint32 and int32 //: the 1M ops over a ring of operands and
    # results past the L2 (as the f32 add), the L = 400 bfloat16 recurrence,
    # the 64M bfloat16 sum; each beside its plain version and the one
    # PyTorch call that computes it (torch.add on the int32 views of the
    # uint32 operands, the same bits mod 2**32, as torch has no uint32 add
    # on the card; torch.floor_divide on nonzero divisors: torch's integer
    # division by 0 is not XLA's).
    def ring_of(make):
        return [make() for _ in range(ADD_RING)]

    def ring_time(pairs, fn, n=100):
        keep, at = [None] * len(pairs), [0]

        def call():
            i = at[0] = (at[0] + 1) % len(pairs)
            keep[i] = fn(*pairs[i])
        return time_ms(call, n=n)

    bf_ring = ring_of(lambda: tuple(on(rng.standard_normal(N_ADD).astype(np.float32)).bfloat16()
                                    for _ in range(2)))
    u_ring = ring_of(lambda: tuple(on(rng.integers(0, 2**31, N_ADD).astype(np.int64)).to(torch.uint32)
                                   for _ in range(2)))
    d_ring = ring_of(lambda: (on(rng.integers(-2**31, 2**31, N_ADD, dtype=np.int64).astype(np.int32)),
                              on(rng.choice([-7, -3, -1, 1, 2, 5, 11, 1000], N_ADD).astype(np.int32))))
    addu = binop("add", (N_ADD,), (N_ADD,), torch.uint32)

    def u_library(a, b):  # torch has no uint32 add on the card: the same bits through int32
        return torch.add(a.view(torch.int32), b.view(torch.int32))
    ht = {
        "add_bf16_ms": ring_time(bf_ring, lambda a, b: sm.add(sm.Array(a), sm.Array(b)).torch()),
        "add_bf16_plain_ms": ring_time(bf_ring, lambda a, b: program.run_plain(add16, [a, b], (N_ADD,))),
        "add_bf16_library_ms": ring_time(bf_ring, torch.add),
        "add_uint32_ms": ring_time(u_ring, lambda a, b: sm.add(sm.Array(a), sm.Array(b)).torch()),
        "add_uint32_plain_ms": ring_time(u_ring, lambda a, b: program.run_plain(addu, [a, b], (N_ADD,))),
        "add_uint32_library_ms": ring_time(u_ring, u_library),
        "idiv_ms": ring_time(d_ring, lambda a, b: (sm.Array(a) // sm.Array(b)).torch()),
        "idiv_plain_ms": ring_time(d_ring, lambda a, b: program.run_plain(idiv_prog, [a, b], (N_ADD,))),
        "idiv_library_ms": ring_time(d_ring, torch.floor_divide),
        "fused400_bf16_ms": time_ms(lambda: fused16(acc16, fa16, fe16).torch(), n=1),
        "fused400_bf16_plain_ms": time_ms(lambda: program.run_plain(prog16, plain16_in, sq16, 400, 0),
                                          reps=1),
        "sum_bf16_ms": timed_on("direct", lambda: reduction.reduce(x16.torch(), "sum")),
        "sum_bf16_plain_ms": time_ms(lambda: reduction._plain(x16.torch(), "sum"), n=20),
        "sum_bf16_library_ms": time_ms(lambda: torch.sum(x16.torch()), n=20),
    }
    # The 2-byte quad paths past the L2 beside their element paths (the same
    # values 2 bytes off) and the library: the 1M bfloat16 add over a ring of
    # operands so placed, the 16M add (96 MiB), the axis-0 sum of the 64M
    # bfloat16 values as (8192, 8192), the 64M float16 sum.
    bf_off = [(two_bytes_off(a), two_bytes_off(b)) for a, b in bf_ring]
    ht["add_bf16_element_ms"] = ring_time(bf_off, lambda a, b: elementwise.elementwise(
        add16, (N_ADD,), torch.bfloat16, a, b))
    del bf_off
    big16 = [on(rng.standard_normal(N_CHAIN).astype(np.float32)).bfloat16() for _ in range(2)]
    add16_big = binop("add", (N_CHAIN,), (N_CHAIN,), torch.bfloat16)
    ht["add_bf16_16m_ms"] = time_ms(lambda: sm.add(sm.Array(big16[0]), sm.Array(big16[1])).torch(), n=10)
    ht["add_bf16_16m_plain_ms"] = time_ms(lambda: program.run_plain(add16_big, big16, (N_CHAIN,)), n=10)
    ht["add_bf16_16m_library_ms"] = time_ms(lambda: torch.add(big16[0], big16[1]), n=10)
    del big16
    m16t, xht = m16.torch(), xh.torch()
    x16_off = two_bytes_off(x16.torch())
    ht.update({
        "sum_bf16_element_ms": timed_on("generated", lambda: reduction.reduce(x16_off, "sum")),
        "axis0_bf16_ms": timed_on("direct", lambda: reduction.reduce_axis(m16t, "sum", 0)),
        "axis0_bf16_element_ms": timed_on("generated", lambda: reduction.reduce_axis(
            x16_off.view(N_AXIS, N_AXIS), "sum", 0)),
        "axis0_bf16_plain_ms": time_ms(lambda: reduction._plain(m16t, "sum", 0), n=20),
        "axis0_bf16_library_ms": time_ms(lambda: torch.sum(m16t, 0), n=20),
        "sum_f16_ms": timed_on("direct", lambda: reduction.reduce(xht, "sum")),
        "sum_f16_plain_ms": time_ms(lambda: reduction._plain(xht, "sum"), n=20),
        "sum_f16_library_ms": time_ms(lambda: torch.sum(xht), n=20),
    })
    del x16_off
    for key in ("add_bf16", "add_bf16_16m", "sum_bf16", "axis0_bf16", "sum_f16"):
        ht[f"{key}_over_library"] = ht[f"{key}_ms"] / ht[f"{key}_library_ms"]
    del bf_ring, u_ring, d_ring
    log(f"bfloat16/uint32/int32 // times on {card}: " + json.dumps(ht))
    log(f"library times on {card}: " + json.dumps(lib)
        + f" axis0 identity kernel/plain {rt['axis0_identity_ms']}/{rt['axis0_identity_plain_ms']}"
        + f" axis1 identity kernel/plain {rt['axis1_identity_ms']}/{rt['axis1_identity_plain_ms']}")

    generated_phase(gen, "6")
    # ------------------------------------------------- 7. the matmul path
    err_mm = matmul_checks(dev, rng, sm, program, matmul, elementwise)

    n = N_MM
    s_c, c_c = 1.0 / n, 0.5
    layer = sm.fuse(lambda x, w, bias: sm.maximum(x @ w + bias, 0.0) * s_c - c_c)
    x_np = rng.standard_normal((n, n)).astype(np.float32)
    w_np = rng.standard_normal((n, n)).astype(np.float32)
    bias_np = rng.standard_normal((1, n)).astype(np.float32)
    xf, wf, biasf = sm.Array(x_np), sm.Array(w_np), sm.Array(bias_np)
    xb, wb, biasb = (sm.Array(a.torch().bfloat16()) for a in (xf, wf, biasf))
    x3 = sm.Array(on(rng.standard_normal(BMM[:1] + (BMM[1], BMM[2])).astype(np.float32)).bfloat16())
    w3 = sm.Array(on(rng.standard_normal(BMM[:1] + (BMM[2], BMM[2])).astype(np.float32)).bfloat16())
    bias3 = sm.Array(on(rng.standard_normal((1, 1, BMM[2])).astype(np.float32)).bfloat16())
    x3f = sm.Array(on(rng.standard_normal(BMM[:1] + (BMM[1], BMM[2])).astype(np.float32)))
    w3f = sm.Array(on(rng.standard_normal(BMM[:1] + (BMM[2], BMM[2])).astype(np.float32)))
    bias3f = sm.Array(on(rng.standard_normal((1, 1, BMM[2])).astype(np.float32)))
    qa = sm.Array(rng.integers(-127, 128, (n, n)).astype(np.int8))
    qb = sm.Array(rng.integers(-127, 128, (n, n)).astype(np.int8))
    q_scale = sm.Array(np.abs(rng.standard_normal((1, n))).astype(np.float32) * 1e-3)
    ia = sm.Array(rng.integers(-1000, 1000, (N_INT_DOT, N_INT_DOT)).astype(np.int32))
    ib = sm.Array(rng.integers(-1000, 1000, (N_INT_DOT, N_INT_DOT)).astype(np.int32))
    la = sm.Array(rng.integers(-2**63, 2**63 - 1, (N_INT_DOT, N_INT_DOT), dtype=np.int64))
    lb = sm.Array(rng.integers(-2**63, 2**63 - 1, (N_INT_DOT, N_INT_DOT), dtype=np.int64))
    main_calls = [
        ("fused relu(x@W+bias)*s-c 2048^3 f32", lambda: layer(xf, wf, biasf), {"mm": 1, "bmm": 0}),
        ("fused relu(x@W+bias)*s-c 2048^3 bf16", lambda: layer(xb, wb, biasb), {"mm": 1, "bmm": 0}),
        ("sm.int8_matmul 2048^3", lambda: sm.int8_matmul(qa, qb), {"mm": 1, "bmm": 0}),
        ("sm.int8_matmul 2048^3 scale=(1,N)", lambda: sm.int8_matmul(qa, qb, scale=q_scale),
         {"mm": 1, "bmm": 0}),
        ("fused batched root (8,1024,1024) bf16", lambda: layer(x3, w3, bias3), {"mm": 0, "bmm": 1}),
        ("fused batched root (8,1024,1024) f32", lambda: layer(x3f, w3f, bias3f),
         {"mm": 0, "bmm": 1}),
        ("sm.dot int32 (512,512)", lambda: sm.dot(ia, ib), {"mm": 1, "bmm": 0}),
        ("sm.dot int64 (512,512)", lambda: sm.dot(la, lb), {"mm": 1, "bmm": 0}),
    ]
    torch.cuda.synchronize()
    matmul.reset_launches()
    elementwise.reset_launches()
    reduction.reset_launches()
    dispatch.reset()
    mm_outs = []
    by_kernel = {}  # (entry point, kernel) -> launches on the main path
    fused_launches = {}  # label of a fused call -> its launches on a generated epilogue
    for label, call, want in main_calls:
        before, before_v = dict(matmul.LAUNCHES), dict(matmul.VARIANTS)
        before_e = dict(matmul.EPILOGUE_PATHS)
        mm_outs.append(call().torch())
        got = {k: matmul.LAUNCHES[k] - before[k] for k in before}
        check(got == want, f"{label}: launched {got}, expected {want}")
        took = {k: v - before_v[k] for k, v in matmul.VARIANTS.items() if v != before_v[k]}
        kernel = ("wgmma_bf16" if "bf16" in label else "fma_f32" if "f32" in label else
                  "wgmma_s8" if "int8" in label else "wgmma_i64" if "int64" in label else "imad_i32")
        check(took == {kernel: 1}, f"{label}: ran {took}")
        entry_point = "bmm" if got["bmm"] else "mm"
        by_kernel[entry_point, kernel] = by_kernel.get((entry_point, kernel), 0) + 1
        # Every launch with an epilogue runs the kernel generated for it.
        epilogue = {k: v - before_e[k] for k, v in matmul.EPILOGUE_PATHS.items()}
        fused = "fused" in label or "scale" in label
        check(epilogue == {"generated": int(fused), "interp": 0},
              f"{label}: its epilogue ran {epilogue}")
        fused_launches[label] = epilogue["generated"]
    torch.cuda.synchronize()
    mm_launches, mm_variants = dict(matmul.LAUNCHES), dict(matmul.VARIANTS)
    counts = dispatch.counts()
    log(f"matmul path launches {mm_launches} by kernel {mm_variants} epilogues "
        f"{matmul.EPILOGUE_PATHS} dispatch {counts}")
    check(matmul.EPILOGUE_PATHS == {"generated": 5, "interp": 0},
          f"the matmul path's epilogues ran {matmul.EPILOGUE_PATHS}")
    check(mm_launches == {"mm": 6, "bmm": 2}, f"the matmul path launched {mm_launches}")
    # The two bf16 workloads took the bf16 tensor-core kernel, the two
    # int8_matmul calls the int8 one, and only they.
    check(mm_variants == {"wgmma_bf16": 2, "wgmma_s8": 2, "fma_f32": 2, "imad_i32": 1, "wgmma_i64": 1},
          f"the matmul path's kernels were {mm_variants}")
    check(counts.get("matmul:wgmma_bf16") == 2 and counts.get("matmul:wgmma_s8") == 2,
          f"matmul dispatch {counts}")
    check(counts.get("matmul:mm_epilogue") == 3 and counts.get("matmul:bmm_epilogue") == 2
          and counts.get("matmul:int8") == 2, f"matmul dispatch {counts}")
    check(not any(k.startswith(("elementwise", "torch_path")) for k in counts),
          f"the matmul path left the matmul kernel: {counts}")
    check(sum(elementwise.LAUNCHES.values()) + sum(reduction.LAUNCHES.values()) == 0,
          "the matmul path launched another kernel")

    def relu_layer64(x, w, bias):
        return torch.relu(x.double() @ w.double() + bias.double()) * s_c - c_c

    out_f, out_b, out_q, out_qs, out_3, out_3f, out_i, out_i64 = mm_outs

    # The same calls' plain versions, at the main path's shapes.
    acc_leaf = program.leaf((n, n), torch.float32)
    lf, lb16 = program.leaf((1, n), torch.float32), program.leaf((1, n), torch.bfloat16)
    epi_f = program.lower_epilogue(sm.maximum(acc_leaf + lf, 0.0) * s_c - c_c, acc_leaf, [lf])
    epi_b = program.lower_epilogue(sm.maximum(acc_leaf + lb16, 0.0) * s_c - c_c, acc_leaf, [lb16])
    bias_f3, bias_b3 = biasf.torch().reshape(1, 1, n), biasb.torch().reshape(1, 1, n)
    fused_err = {}  # a fused call's largest |kernel - plain|
    for key, label, out, (x, w, bias), epi in (
            (("mm", "fma_f32"), "f32 2048^3", out_f, (xf, wf, bias_f3), epi_f),
            (("mm", "wgmma_bf16"), "bf16 2048^3", out_b, (xb, wb, bias_b3), epi_b),
            (("bmm", "wgmma_bf16"), "bf16 (8,1024,1024)", out_3, (x3, w3, bias3.torch()), epi_b),
            (("bmm", "fma_f32"), "f32 (8,1024,1024)", out_3f, (x3f, w3f, bias3f.torch()), epi_f)):
        plain = matmul.matmul_plain(x.torch(), w.torch(), out.dtype, epi, [bias])
        diff = (out.double() - plain.double()).abs()
        # f32: two f32 sums in different orders; bf16: one rounding of each on top.
        tol = 2e-5 * (x.torch().double().abs() @ w.torch().double().abs()) * s_c + 1e-7
        if out.dtype == torch.bfloat16:
            tol = tol + 2.0 ** -7 * plain.double().abs()
        check(bool((diff <= tol).all()), f"fused {label}: kernel vs plain beyond tolerance")
        err_mm[key] = max(err_mm[key], float(diff.max()))
        fused_err[label] = float(diff.max())
    log("check fused f32/bf16 2048^3 and f32/bf16 (8,1024,1024): kernel within tolerance of "
        "the plain version at the main path's shapes")
    check(bool(torch.isfinite(out_3f).all()) and tuple(out_3f.shape) == BMM,
          "fused f32 (8,1024,1024): wrong result")
    prod_abs = xf.torch().double().abs() @ wf.torch().double().abs()
    check(out_f.dtype == torch.float32 and tuple(out_f.shape) == (n, n)
          and bool(torch.isfinite(out_f).all()), "fused f32: wrong result")
    ref_f = relu_layer64(xf.torch(), wf.torch(), biasf.torch())
    check(bool(((out_f.double() - ref_f).abs() <= 2e-5 * prod_abs * s_c + 1e-7).all()),
          "fused f32: beyond 2e-5*(|x|@|W|)*s of float64")
    rows = np.maximum(x_np[:64].astype(np.float64) @ w_np.astype(np.float64) + bias_np, 0.0) * s_c - c_c
    np.testing.assert_allclose(out_f[:64].cpu().numpy(), rows, rtol=1e-4, atol=1e-6,
                               err_msg="fused f32 vs float64 numpy on 64 rows")
    log("check fused f32 2048^3: within 2e-5*(|x|@|W|)*s of float64 (torch, all rows; numpy, "
        "64 rows), one launch, no elementwise pass")
    for label, out, (x, w, bias) in (("bf16 2048^3", out_b, (xb, wb, biasb)),
                                     ("bf16 (8,1024,1024)", out_3, (x3, w3, bias3))):
        ref = relu_layer64(x.torch(), w.torch(), bias.torch())
        check(out.dtype == torch.bfloat16 and bool(torch.isfinite(out.float()).all()),
              f"fused {label}: wrong result")
        # One bf16 rounding of a value the f32 accumulator holds to 2e-5*(|x|@|W|).
        tol = (2.0 ** -8) * ref.abs() + 2e-5 * (x.torch().double().abs() @ w.torch().double().abs()) * s_c + 1e-6
        check(bool(((out.double() - ref).abs() <= tol).all()),
              f"fused {label}: beyond one bf16 rounding of float64")
        log(f"check fused {label}: within one bf16 rounding of float64, one launch")
    acc_q = matmul.int_product(qa.torch(), qb.torch())
    check(out_q.dtype == torch.int32 and torch.equal(out_q, acc_q), "int8_matmul is not exact")
    check(torch.equal(out_q[:64].cpu(), (qa.torch()[:64].cpu().long() @ qb.torch().cpu().long()).int()),
          "int8_matmul differs from the int64 product on 64 rows")
    check(out_qs.dtype == torch.float32 and torch.equal(out_qs, acc_q.float() * q_scale.torch()),
          "int8_matmul with scale= is not the scaled exact product")
    fused_err["int8 scaled"] = float((out_qs - acc_q.float() * q_scale.torch()).abs().max())
    want_i = (ia.torch().cpu().long() @ ib.torch().cpu().long())
    check(out_i.dtype == torch.int32 and torch.equal(out_i.cpu().long(), want_i),
          "sm.dot of int32 is not exact")
    want_l = la.torch().cpu() @ lb.torch().cpu()  # wraps mod 2**64
    check(out_i64.dtype == torch.int64 and torch.equal(out_i64.cpu(), want_l),
          "sm.dot of int64 is not the CPU's int64 product")
    for key, out, want in ((("mm", "wgmma_s8"), out_q, acc_q), (("mm", "imad_i32"), out_i, want_i),
                           (("mm", "wgmma_i64"), out_i64, want_l)):
        diff = (out.cpu().long() - want.cpu().long()).abs().max()  # 0 when equal, as checked
        err_mm[key] = max(err_mm[key], float(diff))
    log("check sm.int8_matmul 2048^3 (exact int32; scaled: exact), sm.dot int32 (512,512) and "
        "int64 (512,512), full-range values: exact")

    # The kernels generated per epilogue against the compiled kernels'
    # interpreter, bit for bit, on cases of their own (compiled ahead).
    t0 = time.perf_counter()
    n_gen, covered = matmul_generated_checks(matmul, matmul_generated_cases(dev, SEED + 21))
    for kernel in ("wgmma_bf16", "wgmma_s8", "fma_f32", "imad_i32"):
        check({(kernel, 2), (kernel, 3)} <= {c[:2] for c in covered},
              f"the generated epilogue checks left out {kernel} at rank 2 or 3")
    check({c[2] for c in covered} == {"torch.float32", "torch.bfloat16", "torch.int32", "torch.bool"},
          f"the generated epilogue checks stored {sorted({c[2] for c in covered})}")
    log(f"check the matmul kernels generated per epilogue = the interpreter (matmul.interpret), bit "
        f"for bit: {n_gen} cases (wgmma_bf16, wgmma_s8, fma_f32, imad_i32; mm and bmm; float32, "
        "bfloat16, int32 and bool stored; extras (1|B,1|M,1|N) of float32, bfloat16, int32, bool; "
        "ragged N; transposed and element-path operands; the dequantizing epilogue; ~100 "
        f"instructions), {time.perf_counter() - t0:.1f} s")

    # Float and complex dot/matmul go to torch.matmul: held to numpy.
    small = 512
    f_a, f_b = x_np[:small, :small], w_np[:small, :small]
    ca = (f_a + 1j * w_np[small:2 * small, :small]).astype(np.complex64)
    cb = (f_b + 1j * x_np[small:2 * small, :small]).astype(np.complex64)
    matmul.reset_launches()
    for name, fn in (("dot", sm.dot), ("matmul", sm.matmul)):
        got = fn(sm.Array(f_a), sm.Array(f_b))
        np.testing.assert_allclose(got.numpy(), f_a.astype(np.float64) @ f_b.astype(np.float64),
                                   rtol=1e-4, atol=1e-3, err_msg=f"sm.{name} f32")
        got = fn(sm.Array(ca), sm.Array(cb))
        check(got.dtype == torch.complex64, f"sm.{name} complex64 gives {got.dtype}")
        np.testing.assert_allclose(got.numpy(), ca.astype(np.complex128) @ cb.astype(np.complex128),
                                   rtol=1e-4, atol=1e-3, err_msg=f"sm.{name} complex64")
    check(sum(matmul.LAUNCHES.values()) == 0, "a float dot/matmul launched the matmul kernel")
    log("check sm.dot/sm.matmul f32 and complex64 (512,512) through torch.matmul: "
        "within 1e-4 of float64/complex128 numpy")

    # Times: the bare kernel, the fused epilogue, the plain version and the
    # library call, in turns on this card.
    xt_, wt_, xbt, wbt = xf.torch(), wf.torch(), xb.torch(), wb.torch()
    qat, qbt = qa.torch(), qb.torch()
    qa32, qb32 = qat.int(), qbt.int()
    # The 64-bit product at full range (every limb of every operand varies).
    wa64, wb64 = (on(rng.integers(-2**63, 2**63 - 1, (n, n), dtype=np.int64)) for _ in range(2))
    out64 = matmul.matmul(wa64, wb64, torch.int64)
    plain64 = matmul.matmul_plain(wa64, wb64, torch.int64)
    check(torch.equal(out64, plain64), "the timed 64-bit product is not matmul_plain's")
    err_mm["mm", "wgmma_i64"] = max(err_mm["mm", "wgmma_i64"],
                                    float((out64 != plain64).sum()))  # 0 when equal, as checked
    x3ft, w3ft = x3f.torch(), w3f.torch()
    x3t, w3t = x3.torch(), w3.torch()
    deq2 = matmul._dequant_epilogue(2)
    q3a, q3b = (on(rng.integers(-127, 128, BMM[:1] + (BMM[1], BMM[2])).astype(np.int8))
                for _ in range(2))
    mmt = {
        "mm_f32_ms": time_ms(lambda: matmul.matmul(xt_, wt_, torch.float32), n=5),
        "mm_f32_library_ms": time_ms(lambda: torch.matmul(xt_, wt_), n=5),
        "mm_f32_plain_ms": time_ms(lambda: matmul.matmul_plain(xt_, wt_, torch.float32), n=5),
        "mm_bf16_ms": time_ms(lambda: matmul.matmul(xbt, wbt, torch.bfloat16), n=20),
        "mm_bf16_library_ms": time_ms(lambda: torch.matmul(xbt, wbt), n=20),
        "mm_bf16_plain_ms": time_ms(lambda: matmul.matmul_plain(xbt, wbt, torch.bfloat16), n=5),
        "fused_f32_ms": time_ms(lambda: layer(xf, wf, biasf).torch(), n=5),
        "fused_f32_plain_ms": time_ms(
            lambda: matmul.matmul_plain(xt_, wt_, torch.float32, epi_f, [bias_f3]), n=5),
        "fused_bf16_ms": time_ms(lambda: layer(xb, wb, biasb).torch(), n=5),
        "fused_bf16_plain_ms": time_ms(
            lambda: matmul.matmul_plain(xbt, wbt, torch.bfloat16, epi_b, [bias_b3]), n=5),
        # The same fused calls on the compiled kernels' interpreter.
        "fused_f32_interp_ms": time_ms(
            lambda: matmul.interpret(xt_, wt_, torch.float32, epi_f, [bias_f3[0]]), n=5),
        "fused_bf16_interp_ms": time_ms(
            lambda: matmul.interpret(xbt, wbt, torch.bfloat16, epi_b, [bias_b3[0]]), n=5),
        "int8_scaled_interp_ms": time_ms(
            lambda: matmul.interpret(qat, qbt, torch.float32, deq2, [q_scale.torch()]), n=20),
        "int8_scaled_plain_ms": time_ms(
            lambda: matmul.matmul_plain(qat, qbt, torch.float32, deq2, [q_scale.torch()]), n=3),
        "bmm_fused_bf16_interp_ms": time_ms(
            lambda: matmul.interpret(x3t, w3t, torch.bfloat16, epi_b, [bias3.torch()]), n=5),
        "bmm_fused_bf16_plain_ms": time_ms(
            lambda: matmul.matmul_plain(x3t, w3t, torch.bfloat16, epi_b, [bias3.torch()]), n=5),
        "bmm_fused_f32_interp_ms": time_ms(
            lambda: matmul.interpret(x3ft, w3ft, torch.float32, epi_f, [bias3f.torch()]), n=5),
        "bmm_fused_f32_plain_ms": time_ms(
            lambda: matmul.matmul_plain(x3ft, w3ft, torch.float32, epi_f, [bias3f.torch()]), n=5),
        # int8: the bare kernel as bf16 is timed, then the public calls.
        "mm_int8_ms": time_ms(lambda: matmul.matmul(qat, qbt, torch.int32), n=20),
        "int8_ms": time_ms(lambda: sm.int8_matmul(qa, qb).torch(), n=20),
        "int8_plain_ms": time_ms(lambda: matmul.matmul_plain(qat, qbt, torch.int32), n=3),
        "int8_scaled_ms": time_ms(lambda: sm.int8_matmul(qa, qb, scale=q_scale).torch(), n=20),
        # Its other routes: rank 3, a K-major B (a transposed view: copied,
        # not transposed on the way in), and an operand one byte off, read
        # byte by byte.
        "bmm_int8_ms": time_ms(lambda: matmul.matmul(q3a, q3b, torch.int32), n=20),
        "bmm_int8_plain_ms": time_ms(lambda: matmul.matmul_plain(q3a, q3b, torch.int32), n=3),
        "mm_int8_k_major_b_ms": time_ms(lambda: matmul.matmul(qat, qbt.T, torch.int32), n=20),
        "mm_int8_one_byte_off_ms": time_ms(
            lambda: matmul.matmul(qat[:, 1:], qbt[1:], torch.int32), n=5),
        "bmm_bf16_ms": time_ms(lambda: matmul.matmul(x3t, w3t, torch.bfloat16), n=20),
        "bmm_bf16_library_ms": time_ms(lambda: torch.matmul(x3t, w3t), n=20),
        "bmm_bf16_plain_ms": time_ms(lambda: matmul.matmul_plain(x3t, w3t, torch.bfloat16), n=5),
        "bmm_fused_bf16_ms": time_ms(lambda: layer(x3, w3, bias3).torch(), n=5),
        # The CUDA-core kernel with the batch as a grid dimension, f32.
        "bmm_f32_ms": time_ms(lambda: matmul.matmul(x3ft, w3ft, torch.float32), n=5),
        "bmm_f32_library_ms": time_ms(lambda: torch.matmul(x3ft, w3ft), n=5),
        "bmm_f32_plain_ms": time_ms(lambda: matmul.matmul_plain(x3ft, w3ft, torch.float32), n=5),
        "bmm_fused_f32_ms": time_ms(lambda: layer(x3f, w3f, bias3f).torch(), n=5),
        # The same kernel on 4-byte integers, and reading A through a
        # transposed view: what the narrow loads and the strides cost.
        "mm_int32_ms": time_ms(lambda: matmul.matmul(qa32, qb32, torch.int32), n=3),
        "mm_int32_plain_ms": time_ms(lambda: matmul.matmul_plain(qa32, qb32, torch.int32), n=3),
        # The 64-bit product on the int8 tensor cores (its split passes
        # included), at 2048^3 and at the main path's 512^3; the plain
        # version is the CPU's int64 product.
        "mm_int64_ms": time_ms(lambda: matmul.matmul(wa64, wb64, torch.int64), n=5),
        "mm_int64_512_ms": time_ms(lambda: sm.dot(la, lb), n=20),
        "mm_int64_plain_ms": host_ms(lambda: matmul.matmul_plain(wa64, wb64, torch.int64), reps=1),
        "mm_f32_transposed_a_ms": time_ms(
            lambda: matmul.matmul(xf.T._operand(), wt_, torch.float32), n=5),
        # The tensor-core kernel's other routes: f32 stored, both operands
        # transposed views (the other shared-memory layouts), and an
        # operand read element by element (its first element 2 bytes off).
        "mm_bf16_f32_out_ms": time_ms(lambda: matmul.matmul(xbt, wbt, torch.float32), n=20),
        "mm_bf16_transposed_ms": time_ms(
            lambda: matmul.matmul(xb.T._operand(), wb.T._operand(), torch.bfloat16), n=20),
        "mm_bf16_element_path_ms": time_ms(
            lambda: matmul.matmul(xbt[:, 1:], wbt[1:], torch.bfloat16), n=3),
        "fused_f32_host_ms": host_ms(lambda: layer(xf, wf, biasf).torch()),
        "fused_bf16_host_ms": host_ms(lambda: layer(xb, wb, biasb).torch()),
    }
    # torch._int_mm is the one PyTorch call for int8 x int8 -> int32 on the
    # card; a yardstick only, so a build of torch without it leaves null.
    int_mm = getattr(torch, "_int_mm", None)
    mmt["int8_library_ms"] = time_ms(lambda: int_mm(qat, qbt), n=20) if int_mm else None
    # torch.matmul of two int64 CUDA tensors, where this build of torch has
    # one: the 64-bit product's yardstick (null, with the error kept, where
    # it raises).
    try:
        check(torch.equal(torch.matmul(wa64, wb64), plain64), "torch.matmul int64 is not exact")
        mmt["int64_library_ms"] = time_ms(lambda: torch.matmul(wa64, wb64), n=1, reps=3)
    except RuntimeError as e:
        mmt["int64_library_ms"], mmt["int64_library_error"] = None, str(e).splitlines()[0][:200]
    flop = 2.0 * n ** 3
    for key in ("mm_f32", "mm_bf16", "fused_f32", "fused_bf16", "mm_int8", "int8", "int8_scaled",
                "bmm_int8", "bmm_bf16", "bmm_fused_bf16", "mm_int32", "mm_f32_transposed_a",
                "bmm_f32", "bmm_fused_f32", "mm_int64"):
        mmt[f"{key}_Tops"] = flop / (mmt[f"{key}_ms"] * 1e-3) / 1e12
    b_f32 = bound(3 * 4 * n * n, flop, "f32")
    b_bf16 = bound(3 * 2 * n * n, flop, "bf16")
    b_int8 = bound((2 + 4) * n * n, flop, "int8")
    b_bmm = bound(3 * 2 * BMM[0] * BMM[1] * BMM[2], flop, "bf16")
    b_bmm_f32 = bound(3 * 4 * BMM[0] * BMM[1] * BMM[2], flop, "f32")
    b_int32 = bound(3 * 4 * n * n, flop, "int32")
    # The 64-bit product: 36 u8 x u8 limb products a multiply-add (8 byte
    # limbs of each operand; those whose limbs add up to at most 7 reach the
    # result mod 2**64) on the int8 tensor cores.
    b_int64 = bound(3 * 8 * n * n, 36 * flop, "int8")
    for key, b in (("mm_f32", b_f32), ("fused_f32", b_f32), ("mm_bf16", b_bf16),
                   ("fused_bf16", b_bf16), ("mm_int8", b_int8), ("int8", b_int8),
                   ("int8_scaled", b_int8), ("bmm_bf16", b_bmm), ("bmm_fused_bf16", b_bmm),
                   ("bmm_f32", b_bmm_f32), ("bmm_fused_f32", b_bmm_f32), ("mm_int32", b_int32),
                   ("mm_int64", b_int64)):
        mmt[f"{key}_bound_ms"] = b[0]
        mmt[f"{key}_share_of_bound"] = b[0] / mmt[f"{key}_ms"]
    for key in ("mm_bf16", "bmm_bf16", "mm_f32", "bmm_f32"):
        mmt[f"{key}_over_library"] = mmt[f"{key}_ms"] / mmt[f"{key}_library_ms"]
    if int_mm:
        mmt["mm_int8_over_library"] = mmt["mm_int8_ms"] / mmt["int8_library_ms"]
        check(mmt["mm_int8_over_library"] <= 1.0,
              f"the int8 kernel is slower than torch._int_mm: {mmt['mm_int8_ms']} ms against "
              f"{mmt['int8_library_ms']}")
    log(f"matmul times on {card}: " + json.dumps(mmt))

    # Bounds of the earlier kernels at the timed shapes: the add moves 12 MB;
    # the fused recurrence reads two (2048, 2048) arrays and a row, writes
    # one, and does L * (4 + exp + pow) float operations per element; the
    # reductions read 256 MB once.
    chain_ops = 4 + CRAFTED_OPS["exp"] + CRAFTED_OPS["pow"]
    b_add = bound(12 * N_ADD, N_ADD)
    b_chain = bound(4 * (3 * N_FUSED * N_FUSED + N_FUSED), 400.0 * chain_ops * N_FUSED * N_FUSED)
    b_sum = bound(4 * N_SUM, N_SUM)
    b_dot = bound(8 * N_DOT, 2 * N_DOT)
    b_axis = bound(4 * N_SUM + 4 * N_AXIS, N_SUM)

    # bfloat16, uint32, //: the adds and the division move 12 MB (6 MB in
    # bfloat16) and do one operation an element (// counted as one); the
    # bfloat16 recurrence reads and writes 6 bytes an element and does, per
    # element and pass, each instruction of its program once (exp and pow
    # as CRAFTED_OPS, a copy of bits as none) and ROUND_OPS integer
    # operations for each rounding to bfloat16; the sum reads 128 MiB.
    f_ops, r_ops = program_ops(prog16, program)
    b_add16 = bound(6 * N_ADD, N_ADD)
    b_addu = bound(12 * N_ADD, N_ADD, "int32")
    b_idiv = bound(12 * N_ADD, N_ADD, "int32")
    elems = N_FUSED * N_FUSED
    b_chain16 = bound_mixed(2 * (3 * elems + N_FUSED), 400.0 * f_ops * elems, 400.0 * r_ops * elems)
    b_sum16 = bound(2 * N_SUM, N_SUM)
    b_axis16 = bound(2 * N_SUM + 4 * N_AXIS, N_SUM)
    ht["add_bf16_16m_bound_ms"] = bound(6 * N_CHAIN, N_CHAIN)[0]
    log(f"2-byte quad paths' bounds on {card}: add 1M {b_add16[0]} ms, add 16M "
        f"{ht['add_bf16_16m_bound_ms']} ms, sums 64M {b_sum16[0]} ms, axis 0 {b_axis16[0]} ms")

    # The programs on the generated kernels: the 16M chain reads three
    # operands and writes one (3 operations an element); the distance reads
    # 256 MB and a scalar (add, subtract, square and the sum's add);
    # a * row - col reads the matrix, its row and its column (multiply,
    # subtract, add); the thresholded sums read the matrix and the
    # threshold and write a row of sums (compare, select, add).
    b_chain16m = bound(16 * N_CHAIN, 3 * N_CHAIN)
    b_dist = bound(8 * N_DOT + 4, 4 * N_DOT)
    b_rows = bound(4 * N_SUM + 8 * N_AXIS, 3 * N_SUM)
    b_thr = bound(4 * N_SUM + 4 + 4 * N_AXIS, 3 * N_SUM)

    def entry(name, source, replaces, launched, err, ms, plain_ms, b, library_ms):
        check(b[0] <= ms, f"{name}: {ms} ms is under its bound of {b[0]} ms")
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launched, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": b[0], "bound_by": b[1], "library_ms": library_ms,
                "share_of_bound": b[0] / ms}

    kernels = [
        entry("ew_flat", SOURCE, "simplemath_tpu/ops/elementwise.py:161",
              launches["ew_flat"], err_add, t["add_ms"], t["add_plain_ms"], b_add, lib["add"]),
        # ew_strided as the L = 400 recurrence, on the main path's kernel (the
        # one generated for the program); interp_ms: the interpreter's.
        dict(entry("ew_strided", SOURCE, "simplemath_tpu/ops/elementwise.py:225",
                   launches["ew_strided"], err_fused, t["fused400_ms"], t["fused400_plain_ms"],
                   b_chain, None),
             paths=strided_paths, interp_ms=t["fused400_interp_ms"],
             other_sources=["simplemath_tpu_torch/ops/codegen.py",
                            "simplemath_tpu_torch/csrc/nvrtc.cu"]),
        # ew_flat on the kernel generated for its program (ops/codegen.py,
        # kind "flat"), as phase 4's 16M chain; interp_ms: the interpreter's.
        dict(entry("ew_flat_generated", CODEGEN_SOURCE, "simplemath_tpu/ops/elementwise.py:161",
                   flat_launches["generated"], err_chain, t["chain_16m_ms"],
                   t["chain_16m_plain_ms"], b_chain16m, None),
             interp_ms=t["chain_16m_interp_ms"], ptxas=t["chain_16m_ptxas"],
             other_sources=[SOURCE, "simplemath_tpu_torch/csrc/program.cuh", NVRTC_SOURCE]),
        # rd_full and rd_axis on the evaluators generated for their programs
        # (kind "reduce"): the distance and the lazy chain, a * row - col
        # along the rows, the thresholded sums along axis 0 (axis 1 beside).
        dict(entry("rd_full_generated", CODEGEN_SOURCE, "simplemath_tpu/ops/reduction.py:275",
                   rd_generated["fused sum(square(a+eps-b)) 32M"]
                   + rd_generated["lazy sm.sum(sm.square(sm.subtract(a,b))) 32M"],
                   err_rd["rd_full"], rt["dist_ms"], rt["dist_plain_ms"], b_dist, None),
             interp_ms=rt["dist_interp_ms"], ptxas=rt["ptxas"]["dist"],
             other_sources=RD_GENERATED_SOURCES),
        dict(entry("rd_full_rows_generated", CODEGEN_SOURCE, "simplemath_tpu/ops/reduction.py:333",
                   rd_generated["fused sum(a*row-col) 8192^2"], err_rd["rd_full"], rt["rows_ms"],
                   rt["rows_plain_ms"], b_rows, None),
             interp_ms=rt["rows_interp_ms"], ptxas=rt["ptxas"]["rows"],
             other_sources=RD_GENERATED_SOURCES),
        dict(entry("rd_axis_generated", CODEGEN_SOURCE, "simplemath_tpu/ops/reduction.py:482",
                   sum(rd_generated[f"fused sum(where(a>s,a,0),axis={ax}) 8192^2"] for ax in (0, 1)),
                   err_rd["rd_axis"], rt["axis0_ms"], rt["axis0_plain_ms"], b_thr, None),
             interp_ms=rt["axis0_interp_ms"], axis1_ms=rt["axis1_ms"],
             axis1_interp_ms=rt["axis1_interp_ms"], ptxas=rt["ptxas"]["axis0"],
             axis1_ptxas=rt["ptxas"]["axis1"], other_sources=RD_GENERATED_SOURCES),
        entry("rd_full", RD_SOURCE, "simplemath_tpu/ops/reduction.py:79 :127 :210 :275 :333",
              rd_launches["rd_full"], err_rd["rd_full"], rt["sum_ms"], rt["sum_plain_ms"],
              b_sum, lib["sum"]),
        # rd_full once more, as the dot of two 32M vectors, with the main
        # path's launches of its loop (the hoisted one-instruction one).
        entry("rd_full_dot", RD_SOURCE, "simplemath_tpu/ops/reduction.py:210",
              rd_paths["single"], err_rd["rd_full"], rt["dot_ms"], rt["dot_plain_ms"],
              b_dot, lib["dot"]),
        entry("rd_axis", RD_SOURCE, "simplemath_tpu/ops/reduction.py:482",
              rd_launches["rd_axis"], err_rd["rd_axis"], rt["axis0_identity_ms"],
              rt["axis0_identity_plain_ms"], b_axis, lib["axis0"]),
        # mm and bmm with bf16 operands, at 2048^3 and (8, 1024, 1024): the
        # bf16 tensor-core kernel.  Then the other kernels behind the same
        # entry point, mm at 2048^3: int8 operands (the int8 tensor-core
        # kernel) and f32 operands (the CUDA-core kernel), each with the
        # launches of its kernel on the main path.
        entry("mm", WGMMA_SOURCE, "simplemath_tpu/ops/matmul.py:134",
              mm_launches["mm"], err_mm["mm", "wgmma_bf16"], mmt["mm_bf16_ms"], mmt["mm_bf16_plain_ms"],
              b_bf16, mmt["mm_bf16_library_ms"]),
        entry("bmm", WGMMA_SOURCE, "simplemath_tpu/ops/matmul.py:209",
              mm_launches["bmm"], err_mm["bmm", "wgmma_bf16"], mmt["bmm_bf16_ms"], mmt["bmm_bf16_plain_ms"],
              b_bmm, mmt["bmm_bf16_library_ms"]),
        entry("mm_int8", WGMMA_S8_SOURCE, "simplemath_tpu/ops/matmul.py:134 :457",
              mm_variants["wgmma_s8"], err_mm["mm", "wgmma_s8"], mmt["mm_int8_ms"], mmt["int8_plain_ms"],
              b_int8, mmt["int8_library_ms"]),
        entry("mm_f32", MM_SOURCE, "simplemath_tpu/ops/matmul.py:134",
              by_kernel.get(("mm", "fma_f32"), 0), err_mm["mm", "fma_f32"], mmt["mm_f32_ms"],
              mmt["mm_f32_plain_ms"], b_f32, mmt["mm_f32_library_ms"]),
        entry("bmm_f32", MM_SOURCE, "simplemath_tpu/ops/matmul.py:209",
              by_kernel.get(("bmm", "fma_f32"), 0), err_mm["bmm", "fma_f32"], mmt["bmm_f32_ms"],
              mmt["bmm_f32_plain_ms"], b_bmm_f32, mmt["bmm_f32_library_ms"]),
        entry("mm_int32", MM_SOURCE, "simplemath_tpu/ops/matmul.py:134",
              by_kernel.get(("mm", "imad_i32"), 0), err_mm["mm", "imad_i32"], mmt["mm_int32_ms"],
              mmt["mm_int32_plain_ms"], b_int32, None),
        # The JAX package has no Pallas kernel for 64-bit products: jnp.dot
        # and jnp.matmul in int64.
        entry("mm_int64", WGMMA_I64_SOURCE, "simplemath_tpu/ops/engine.py:495 :557",
              by_kernel.get(("mm", "wgmma_i64"), 0), err_mm["mm", "wgmma_i64"], mmt["mm_int64_ms"],
              mmt["mm_int64_plain_ms"], b_int64, mmt["int64_library_ms"]),
        # The fused calls on the kernels generated per epilogue (ops/codegen.py,
        # kind "matmul"), with their launches on the main path; interp_ms
        # the same call on the compiled kernel's interpreter, bare_ms the
        # product alone; the bound the bare product's.
        *(dict(entry(name, CODEGEN_SOURCE, replaces, fused_launches[label], fused_err[err_key],
                     mmt[f"{key}_ms"], mmt[f"{key}_plain_ms"], b, None),
               interp_ms=mmt[f"{key}_interp_ms"], bare_ms=mmt[bare], other_sources=MM_GENERATED_SOURCES)
          for name, replaces, label, err_key, key, bare, b in (
              ("mm_bf16_epilogue_generated", "simplemath_tpu/ops/matmul.py:134",
               "fused relu(x@W+bias)*s-c 2048^3 bf16", "bf16 2048^3", "fused_bf16", "mm_bf16_ms", b_bf16),
              ("mm_int8_dequant_generated", "simplemath_tpu/ops/matmul.py:134 :451 :457",
               "sm.int8_matmul 2048^3 scale=(1,N)", "int8 scaled", "int8_scaled", "mm_int8_ms", b_int8),
              ("mm_f32_epilogue_generated", "simplemath_tpu/ops/matmul.py:134",
               "fused relu(x@W+bias)*s-c 2048^3 f32", "f32 2048^3", "fused_f32", "mm_f32_ms", b_f32),
              ("bmm_bf16_epilogue_generated", "simplemath_tpu/ops/matmul.py:209",
               "fused batched root (8,1024,1024) bf16", "bf16 (8,1024,1024)", "bmm_fused_bf16",
               "bmm_bf16_ms", b_bmm),
              ("bmm_f32_epilogue_generated", "simplemath_tpu/ops/matmul.py:209",
               "fused batched root (8,1024,1024) f32", "f32 (8,1024,1024)", "bmm_fused_f32",
               "bmm_f32_ms", b_bmm_f32))),
        # bfloat16, uint32 and int32 // on the elementwise and map-reduce
        # kernels (phase 5b's launches).
        entry("ew_flat_bf16", SOURCE, "simplemath_tpu/ops/elementwise.py:161",
              half_launches["ew_flat_bf16"]["ew_flat"], half_err["ew_flat_bf16"], ht["add_bf16_ms"],
              ht["add_bf16_plain_ms"], b_add16, ht["add_bf16_library_ms"]),
        entry("ew_flat_uint32", SOURCE, "simplemath_tpu/ops/elementwise.py:161",
              half_launches["ew_flat_uint32"]["ew_flat"], half_err["ew_flat_uint32"],
              ht["add_uint32_ms"], ht["add_uint32_plain_ms"], b_addu, ht["add_uint32_library_ms"]),
        entry("ew_flat_idiv", SOURCE, "simplemath_tpu/ops/elementwise.py:161",
              half_launches["ew_flat_idiv"]["ew_flat"], half_err["ew_flat_idiv"], ht["idiv_ms"],
              ht["idiv_plain_ms"], b_idiv, ht["idiv_library_ms"]),
        dict(entry("ew_strided_bf16", SOURCE, "simplemath_tpu/ops/elementwise.py:225",
                   half_launches["ew_strided_bf16"]["ew_strided"], half_err["ew_strided_bf16"],
                   ht["fused400_bf16_ms"], ht["fused400_bf16_plain_ms"], b_chain16, None),
             other_sources=["simplemath_tpu_torch/ops/codegen.py",
                            "simplemath_tpu_torch/csrc/nvrtc.cu"]),
        entry("rd_full_bf16", RD_SOURCE, "simplemath_tpu/ops/reduction.py:79 :127",
              half_launches["rd_full_bf16"]["rd_full"], half_err["rd_full_bf16"], ht["sum_bf16_ms"],
              ht["sum_bf16_plain_ms"], b_sum16, ht["sum_bf16_library_ms"]),
        entry("rd_axis_bf16", RD_SOURCE, "simplemath_tpu/ops/reduction.py:482",
              half_launches["rd_axis_bf16"]["rd_axis"], half_err["rd_axis_bf16"], ht["axis0_bf16_ms"],
              ht["axis0_bf16_plain_ms"], b_axis16, ht["axis0_bf16_library_ms"]),
        entry("rd_full_f16", RD_SOURCE, "simplemath_tpu/ops/reduction.py:79 :127",
              half_launches["rd_full_f16"]["rd_full"], half_err["rd_full_f16"], ht["sum_f16_ms"],
              ht["sum_f16_plain_ms"], b_sum16, ht["sum_f16_library_ms"]),
    ]
    for k in kernels:
        if k["name"] in ("mm", "bmm"):
            k["other_sources"] = [WGMMA_S8_SOURCE, WGMMA_I64_SOURCE, MM_SOURCE] + MM_OTHER_SOURCES
        if k["source"] == MM_SOURCE:
            k["other_sources"] = MM_OTHER_SOURCES
        if k["source"] == RD_SOURCE:
            k["other_sources"] = RD_OTHER_SOURCES
    for k in kernels:
        check(k["launches"] > 0, f"{k['name']} was not launched on the main path")

    generated_phase(gen, "7")
    # ------------------------------------------------------ 8. solvers
    t0 = time.perf_counter()
    solvers = solver_phase(dev, card)
    solvers["phase_s"] = time.perf_counter() - t0
    print(json.dumps({"solvers": solvers}))

    generated_phase(gen, "8")
    # ----------------------------------------------------- 9. parallel
    t0 = time.perf_counter()
    par = parallel_phase(dev, card)
    par["phase_s"] = time.perf_counter() - t0
    print(json.dumps({"parallel": par}))

    generated_phase(gen, "9")
    # ------------------------------------------------------- 10. utils
    t0 = time.perf_counter()
    utils = utils_phase(dev, card)
    utils["phase_s"] = time.perf_counter() - t0
    print(json.dumps({"utils": utils}))

    generated_phase(gen, "10")
    # ---------------------------------------------------- 11. compiled
    t0 = time.perf_counter()
    compiled = compiled_phase(dev, card)
    compiled["phase_s"] = time.perf_counter() - t0
    print(json.dumps({"compiled": compiled}))
    for k in kernels:
        if k["name"] in utils["exported"]:
            k["loaded_launches"] = utils["exported"][k["name"]]["launches"]
        if k["name"] in ("ew_flat", "ew_strided"):
            # The sm pendulum's graphs (initial rollout and one iteration):
            # launches recorded at capture, which each replay repeats.
            k["graph_launches"] = compiled["sm_pendulum"]["launches"][k["name"]]
            # The same in phase 9's compiled sharded sm pendulum, whose
            # graphs also hold its collectives over NCCL.
            k["sharded_graph_launches"] = par["nccl_1"]["compiled"]["sm_pendulum"]["launches"][k["name"]]
            # The same in phase 10's served sm pendulum: its loaded programs' graphs.
            k["served_graph_launches"] = utils["served"]["sm_pendulum"]["launches"][k["name"]]
            # One call of phase 10's nested sm pendulum, loaded: the whole
            # solve as one program, its loops nested scan nodes.
            k["nested_loaded_launches"] = utils["nested"]["nested_sm_pendulum"]["launches"][k["name"]]

    generated_phase(gen, "11")
    # -------------------------------------------------------- 12. psd
    t0 = time.perf_counter()
    psd = psd_phase(dev, card, compiled)
    psd["phase_s"] = time.perf_counter() - t0
    print(json.dumps({"psd": psd}))
    # The Jacobi PSD projection: the JAX package computes it with
    # jnp.linalg.eigh (no Pallas kernel).  Its times at the coupled
    # cartpole's joint blocks; its launches those of the coupled cartpole's
    # compiled solve (warm-up and capture), and a replay's in each graph.
    big = psd["kernel"][f"{PSD_SHAPES[0][0]}x{PSD_SHAPES[0][1]}"]
    kernels.append(dict(
        entry("psd_project", PSD_SOURCE, "simplemath_tpu/models/ilqr.py:203",
              psd["cartpole"]["launches_at_build"].get("psd_project", 0),
              max(r["max_abs_err"] for k, r in psd["kernel"].items() if k != "special"),
              big["ms"], big["plain_ms"], (big["bound_ms"], big["bound_by"]), big["library_ms"]),
        graph_launches=psd["graph_launches"],
        other_shapes={k: {f: r[f] for f in ("path", "ms", "plain_ms", "library_ms", "bound_ms")}
                      for k, r in psd["kernel"].items() if k != "special"}))
    check(kernels[-1]["launches"] > 0, "psd_project was not launched on the main path")
    generated_phase(gen, "12")
    phases = gen["phases"]
    # The programs the solver phases (8-11: the sm pendulum's derivative
    # programs among them) generate kernels for.
    gen["phases_8_11_signatures"] = {
        kind: sum(phases[ph]["signatures"][kind] for ph in ("8", "9", "10", "11"))
        for kind in ("strided", "flat", "reduce", "matmul")}
    print(json.dumps({"generated": gen["phases"] | {
        "phases_8_11_signatures": gen["phases_8_11_signatures"]}}))
    print(json.dumps({"kernels": kernels}))
    # Each phase's wall seconds (the build's, then each phase's from the
    # end of the one before), and the whole run's.
    print(json.dumps({"phase_s": {"build": build_s, **{ph: v["phase_s"] for ph, v in phases.items()}},
                      "total_s": time.perf_counter() - started}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if "--rank" in sys.argv:
        sys.exit(rank_main(sys.argv[1:]))
    sys.exit(main())
