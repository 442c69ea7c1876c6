"""Smoke run of the tpufem_torch port on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root, one card

1. Platform: the card's name and power limit (nvidia-smi).
2. Build: nvcc compiles the port's CUDA sources from tpufem_torch/csrc
   (sm_90a), one process per source and generated header, all started
   together.
3. Each kernel against its plain PyTorch version on the card, at every
   shape the paths give it.  Fields within 1e-5 * max|plain| (1e-12 in
   fp64), dots within 1e-4 relative; at each kernel's main shape the
   kernel, its plain version and (where one exists) one PyTorch library
   call computing the same function are timed (medians of 20 launches,
   CUDA events), beside the bound: the larger of the bytes the call must
   move over the HBM rate and its operations over the card's peak rate.
   - 3D, the n=96 and n=8 hierarchies (96..6, 8..4) and the 2-level n=64
     ones: K1 and K2 in fp32 (K2 also in fp64; K1 at n=96 also in fp64,
     timed, and with the interp RHS), K1's planes and RHS bit for bit
     against its plain version (a hard check); B4 (residual, sweep,
     sweep+dot) on every level of the general hierarchy over the built
     operator, fp32 data and bf16 data under fp32 vectors; B5 (matvec,
     residual, sweep, sweep+dot) on every const level; K3/K4 on every
     level pair.
   - 2D, n=1024 and n=8: B7 in fp32 and fp64 (its tile printed), bit for
     bit against its plain version, at n=8 with both RHS modes, the n=1024
     builds timed (the record's "shapes"); K2 on B7's fp32 and fp64
     operators; B5 with 7 offsets on every const level (1024..8) in fp32
     and fp64; B4 on every level of the general hierarchy over B7's
     operator, fp32 and bf16 data.
   - Scale, n=384: K1, bit for bit against its plain version and timed
     (the kernel only: the plain version takes seconds); B3 (matvec,
     matvec+dot, residual, sweep,
     sweep+dot) and B5b (matvec, residual, sweep, sweep+dot) on the finest
     level of the general and const hierarchies (fp32 and bf16 data / code
     under fp32 vectors), each also against the flat kernel (K2/B4, B5)
     on the same inputs (B5b runs B5's kernel: bit for bit); B4 and B5 on
     level 192, B5 timed there; K3/K4 on 384->192->96, timed there too
     (beyond L2: the shape that decides their design).
   - Routed: B3 and B5b at n=64 with the routing threshold set to 0,
     through the routed wrappers, in fp32, bf16-under-fp32 and fp64, also
     against the flat kernels.
   - ELL, at the shapes of the unstructured path (1,002,001 rows, 8 slots,
     half bandwidth 1001, random data from a seeded generator): B9 in fp32
     and fp64 with int16 (R = 8192) and int32 (R = 11008) window indices,
     its B11 route (per_block), the absolute-column (gather) mode, B10
     with q = 3, 1 and 8 on the banded plan and q = 3 in absolute mode
     (each B10 case bit for bit its plain version's, every timed shape
     listed under the record's "shapes"; B10's absolute-column form is
     the record B10g, also held bit for bit in fp64 at q = 8 on the modal
     path's operator and timed there); the library call is a torch.sparse
     CSR product.
   - BCSR, at the elasticity paths' shapes (random data and patterns from
     a seeded generator): B12 on 491,401 block rows (b = 2, K = 8, half
     bandwidth 701) in fp32 and fp64 with int16 (R = 1024, and its
     per_block route) and int32 (R = 11008) window indices, on 68,921 block
     rows (b = 3, K = 16, R = 4096) in fp32 and fp64 (every B12 shape
     timed and listed under the record's "shapes"), and B12g, the gather
     form's own kernel, on randomly numbered patterns of both shapes, fp32
     and fp64,
     each timed beside BSR (the 3D one is the BC correction's and the
     box6 gather's b = 3 build); every output must equal the plain
     version's bit for bit (no fused multiply-add, the reference's order),
     which the field tolerance above contains; the library call is torch's
     BSR product (its CSR expansion where BSR @ x does not run).
   - AMG hierarchies, right after each AMG path below, on the hierarchy
     that path builds: every product of every level (A, Qp, Qr) held once
     against its plain version, bit for bit: B12 (or B12g where a matrix
     rides the gather form) on the 982,802-DOF block hierarchy (3 x 3
     transfers and levels) and the n = 40 box's (6 x 6), B9 and B10 (q =
     3) on the scalar ones (unstructured_amg, p2, p2_tet_robin at n = 30
     and 50, quad_hex's quad and hex); the 982k fine-level Qp (b = 3) and
     the box's first 6 x 6 level timed beside their bounds and BSR (under
     B12's "shapes"), and B9 at every scalar level operator ("# level"
     lines: rows, K, slot planes kept, nonzeros, longest row, empty rows,
     launches per V-cycle, B9's form, ms, the bound on the bytes its
     nonzeros need and on its padded width; under B9's "shapes", beside a
     torch.sparse CSR product of the nonzeros).
   - Assembly: B13 on the embedded element coordinates of the n=96 Kuhn
     box (the assembly path's shape) and of the non-cubic 5 x 4 x 6 box,
     fp32 and fp64 (its tile printed, every shape timed), bit for bit
     against its plain version (no library call computes it).
   - Reduction and SAXPY: B14 on examples/reduction_bench.py's 64 MB
     vector (block = n / 8) in fp32 and fp64 and at an n that is not a
     block multiple, bit for bit against its plain version and within
     1e-5 of the fp64 host sum (library call: torch.sum); B15 at
     examples/saxpy_pallas.py's n = 524,288 and at n = 1,000,003, bit for
     bit and within 1e-4 of the example's golden values, and at the
     bandwidth-sized n = 2^26 (805.3 MB moved) on random data, bit for
     bit, timed (library call: torch.add(y, x, alpha=a)).
   - Sharded build: B8 on every stripe of the n=96 box with its interior
     nodes jittered by +-0.15 h (fp32 and fp64, 1, 4 and 8 shards) and of
     the n=62 box (fp32, 4 shards), bit for bit against its plain version
     on the same extended stripe; the stripes of
     build_poisson_system_sharded, joined,
     must equal K1's planes and RHS bit for bit; at n=96, 4 shards, one
     26-plane stripe is timed, and the four-launch build beside K1 (no
     library call builds it).
4. The paths, each driven with every launch count set to 0 just before it
   and read just after (the per-iteration times are taken after that):
   - main, n=96 (912,673 DOFs): fused build, const MG-PCG (nu1 = nu2 = 1)
     with 10 fixed iterations (relres < 1e-5), the guarded
     solve_poisson_fast (<= 12 iterations), the error against the
     manufactured solution (<= 2.0e-4) and mixed-precision refinement
     (<= 1e-8 in <= 3 outer steps); K1-K4 must launch;
   - general, n=96: the general hierarchy on the built operator (top=):
     10 fixed iterations reach relres < 1e-5; the guarded cg to 1e-5 on
     the fp32 hierarchy and on its bf16 cast (<= the fp32 count + 2); B4
     must launch;
   - dirichlet, n=96: solve_poisson_fast(precond="general", g=L) with
     L = x + 2y + 3z (harmonic: the solution is u + L) converges, error
     against u + L <= 2.0e-4;
   - nu2, n=96: the const hierarchy with the default nu1 = nu2 = 2
     converges to 1e-5 in <= 12 iterations; B5 must launch;
   - jacobi, n=64 with 2 levels: the coarsest level (33^3 nodes) has no
     dense inverse, so 20 Jacobi sweeps stand in for it, on const and on
     general levels; PCG converges to 1e-5; B4 and B5 must launch;
   - 2d, n=1024 (1,050,625 DOFs), fp32: solve_poisson_fast(dim=2), const
     and general, each in <= 8 guarded iterations with rel L2 error
     <= 2.2e-3; the general hierarchy cast to bf16 takes <= the fp32
     count + 2; B7, K2, B4 and B5 must launch;
   - 2d_dirichlet, n=1024, fp64: f = 0 and g = 1 + 2x - 3y, tol 1e-11:
     the solution reproduces g to < 1e-8; B7, K2 and B5 must launch;
   - scale, n=384 (57,066,625 DOFs), fp32: solve_poisson_fast with the
     const hierarchy (<= 12 guarded iterations) and with
     precond="general" (<= 16), each with rel L2 error <= 2.0e-4, its
     phases and peak device memory; then one fused build with the const
     hierarchy at nu1 = nu2 = 2 (<= 12); K1, B3, B5b, K3, K4 and B4 must
     launch;
   - unstructured, 1000 x 1000 perturbed mesh (1,002,001 rows, 2,000,000
     elements), fp32: examples/unstructured_1m.py composed from the port
     (RCM renumbering, ELL pattern, scatter assembly whose rows sum to 0
     within 1e-5 and which repeats bit for bit, apply_dirichlet_ell,
     the banded plan, Chebyshev(14)-PCG with the Gershgorin lmax, cg to
     1e-5 with check_every=2): RCM bandwidth 1001, <= 260 iterations, rel
     L2 error <= 2.0e-5, about 14 banded products per iteration; the
     Chebyshev polynomial on an [n, 3] block (B10) against three single
     applications; then solve_poisson_ell(precond="chebyshev",
     matvec="pallas") on the same mesh within 2 iterations of it; B9, its
     absolute-column mode and B10 must launch;
   - ell_small: solve_poisson_ell in fp64 to 1e-10 (Jacobi) on the 64 x 64
     row-major mesh (bandwidth 65: the banded kernel) and on a randomly
     numbered 96 x 96 perturbed mesh (bandwidth above 4096: the gather
     form), each within one iteration of the JAX package's CPU count;
   - elasticity, examples/elasticity_unstructured.py --precond jacobi at
     full width (perturbed 700 x 700 mesh: 982,802 DOFs, 980,000
     triangles; lam = mu = 1, f = (1, -0.5), tol 1e-6): solve_elasticity
     (matvec="pallas") in fp32 converges within ELAST_MAXITER (see there)
     with B12 launched once per iteration plus the start; its fp64 twin's
     true relative residual <= 1e-5, the fp32 solution within 1e-4 of
     the fp64 one and its own true relative residual within the drift
     limit (see _elasticity_pair; _drift_witness prints what it rests
     on); then matvec="gather" on the random numbering (B12g, the gather
     form's kernel) converges, and its 10-iteration block-Jacobi PCG is
     timed per iteration like the banded one's; B12 and B12g must
     launch;
   - elasticity_3d: the same on the n = 40 box (206,763 DOFs, b = 3,
     block_rows 4096);
   - unstructured_amg: examples/unstructured_1m.py --precond amg on the
     unstructured path's system (1,002,001 rows, fp32): build_amg (greedy,
     strength 0.08, V-cycle; every matrix's plan built at setup, none on
     the gather form), cg to 1e-5 with check_every=2: <= 30 iterations
     (the TPU's F4: 26), rel L2 error within 10% of the same fp32
     system's error at relres 1e-6 (its fp32 assembly leaves about
     2.0e-5), the hierarchy and setup walls printed; apply_multi on an
     [n, 3] block within 1e-5 of three applies; then
     solve_poisson_ell(precond="amg") on the mesh: <= 30 iterations, rel
     L2 error <= 2.0e-5; B9 and B10 must launch;
   - elasticity_amg: examples/elasticity_unstructured.py --precond amg at
     full width (982,802 DOFs, matvec="pallas"), fp32 with its fp64 twin:
     <= 40 iterations (the TPU's F1: 33, coarsest 273 rows), the fp64
     solution's true relres <= 1e-5 and the fp32 one within the drift
     limit and 1e-4 of it (as for elasticity; rounding the fp64 solution
     to fp32 alone leaves a true relres of about 3e-3 here, so the fp32
     solution cannot be held to 1e-5), the hierarchy and setup walls
     printed; then matvec="gather" with AMG converges; B12 must launch,
     at b = 3;
   - elasticity_3d_amg: the n = 40 box with the AMG on the six rigid body
     modes, fp32, converges to 1e-6; B12 must launch at b = 6;
   - elasticity_box: examples/elasticity_1m.py --n 72 --precond mg
     (solve_elasticity_box, 1,167,051 DOFs, fp32, tol 1e-5, the
     manufactured displacement): <= 16 iterations (BENCH_NOTES.md:88:
     14), rel L2 error <= 1e-3 (TPU 7.6e-4); no hand-written kernel (the
     block-stencil product is XLA in the reference);
   - elasticity_small: fp64 to 1e-10 on a 48 x 48 perturbed mesh and a 6^3
     box, both matvec branches, each at the JAX package's CPU count, the
     two solutions within 1e-8;
   - weakform: examples/poisson_2d.py composed from the port (the weak
     form, ELL, apply_dirichlet_ell, Jacobi cg; 64 x 64, fp64) at the JAX
     package's CPU count and nodal rms error, and the weak-form ELL
     assembly of the 1000 x 1000 perturbed mesh within 1e-5 of the
     closed-form P1 assembly (fp32; quadrature against closed form);
   - p2: P2 triangles on rectangle_mesh(-3,3,-3,3,500,500) (1,002,001
     DOFs, fp64), the mixed Dirichlet (|x| = 3) / Neumann (|y| = 3)
     problem of tests/test_boundary.py: WeakForm(format="ell") with the
     boundary load, apply_dirichlet_ell, RCM + reorder_ell, build_amg
     (greedy, strength 0.08, coarse_n=300), PCG to 1e-12: the JAX
     package's CPU count within 1 and its rel L2 error within 1% (JAX_A3);
     then tests/amg_systems.py's 103,041-DOF p2_system(160): <= 40
     iterations and within 1 of the JAX count (BENCH_NOTES.md:490:
     18-19); B9 and B9g (the Dirichlet correction) must launch;
   - p2_tet_robin: P2 tets, the pure Robin problem du/dn + u = g on every
     facet of box_mesh(-3,3,...,n,n,n) (no Dirichlet row), RCM, the same
     AMG, PCG to 1e-10: at n = 30 (226,981 DOFs) the JAX count within 1
     and its error within 1%, at n = 50 (1,030,301 DOFs) an error at or
     under n = 30's; the fine level rides B9 (build_amg primes any band;
     the RCM band is printed against _AUTO_BAND_MAX); B9 must launch;
   - quad_hex: solve_poisson_ell(precond="amg", tol=1e-10, fp64) on
     perturbed_quad_mesh(-3,3,-3,3,1000,1000, jitter=0.25, seed=5)
     (1,002,001 rows) and box_hex_mesh at n = 100 (1,030,301 rows), each
     at the JAX count within 1 and its error within 1%; B9 and B9g must
     launch;
   - nonlinear: examples/nonlinear_poisson.py at its default size through
     tpufem_torch.examples.nonlinear_poisson's main (--n 512, 263,169
     DOFs, fp32: the ELL stiffness, element_nonlinear_load for u³, Jacobi,
     newton_krylov with tol 1e-6, maxiter 40 from 0, run cold and again;
     each inner product is the forward-mode tangent of the residual):
     converged, the Newton and inner CG counts within 1 and 10% of the JAX
     package's CPU run (JAX_NONLINEAR), rel L2 error <= 2e-5, the second
     run's x bit for bit the first's; B9 must launch;
   - nonlinear_amg: the same with --precond amg (the frozen interval-W
     AMG of the linear part), held to the JAX CPU run of that command
     (JAX_NONLINEAR_AMG) in the same way, but its inner count within 10%
     beyond the two packages' CPU runs (396 and 336); every level of its
     hierarchy is checked and timed (B9, B10) and 10 inner iterations
     profiled; B9 must launch;
   - wave: examples/wave_equation.py --cells 1000 --periods 1 through its
     port's main (1,002,001 DOFs, fp32; the weak form's ELL stiffness,
     the lumped mass, stable_dt's step, leapfrog_wave, run cold and
     again): energy drift <= 5e-3, period-return error within 10% of the
     JAX package's CPU run of the same script (JAX_WAVE; its fp32
     assembly's rounding sets it, scripts/wave_operator_swap.py), and
     <= 2e-3 for the same steps on the stiffness and mass assembled in
     fp64 and cast to fp32 (composed here: not an option of the example);
     one B9 launch per step plus the start in each run, the steps printed
     beside the TPU's 2212; then fp64 at --cells 64 and 1000 (composed
     here too): drift <= 1e-10; B9 must launch;
   - modal: examples/modal_analysis.py --n 1000 through its port's main
     (the perturbed mesh RCM-renumbered, 1,002,001 DOFs; the fp64
     assembly cast to fp32, build_amg(strength=0.08), k = 5, buffer 3, 20
     inner AMG-PCG iterations in lockstep, 25 outer steps in chunks of 5,
     mixed precision, a cold pass and a timed one): the eigenvalues
     within 5e-3 + 40/n² of pi² (i² + j²) / 36, max residual <= 1e-2; B10
     must launch on the banded plan at q = 8 and B10g in fp64 at q = 8
     and q = 5;
   - modal_serial: modal_analysis --n 300 --serial (90,601 DOFs, the
     column-serial inner solves): the example's own gate, the
     eigenvalues within 1e-5 of the largest of the JAX CPU run of the
     same command (JAX_MODAL_SERIAL); B9 and B10g must launch, B10 must
     not;
   - coo_matfree: assemble_coo on rectangle_mesh(-3,3,-3,3,1000,10000)
     (20,000,000 triangles, examples/generic_assembly_20m.py's scale,
     fp32) into pattern_unique_keys: max |row sum| / max |a| < 1e-5, within
     1e-4 of max |a| of assemble_ell on the same pattern, a second run bit
     for bit; on the unstructured path's RCM-ordered mesh the matrix-free
     operators (poisson_operator both ways, element_operator) within 1e-5
     of B9's product, each twice bit for bit, a 10-iteration fixed CG on
     each within 1e-4 of the ELL one, their times beside B9's;
     greedy_element_coloring on the 125 x 125 and 250 x 250 meshes of the
     same generator, no node shared within a color; B9 must launch;
   - stokes: examples/stokes_cavity.py through its port's main, which
     calls solve_stokes (the regularized lid, fp32, the scalar-AMG
     velocity preconditioner, tol 1e-6, check_every 4): n = 180
     (260,642 + 32,761 DOFs) at the JAX
     package's CPU count exactly (JAX_STOKES) and its centerline u_x
     minimum within 1e-3; then the TPU's n = 360 (1,039,682 + 130,321
     DOFs): converged, relres <= 1e-6, the TPU's 128 iterations within 8
     (two batches), the JAX n = 180 centerline minimum within 1e-3; the
     scalar-system, AMG-setup and solve walls; B9 must launch (every
     level of the velocity hierarchy is then checked and timed, and 10
     MINRES iterations profiled);
   - stokes_small: the same example at n = 48 with --f64 --tol 1e-8 and
     --vprecond jacobi and amg: the JAX package's CPU counts exactly, u
     and p within 1e-6 relative of its solution (JAX_STOKES_SMALL: norms,
     sampled DOFs, projections); B9 must launch.
     After each of these paths, B9 (and B9g where the band exceeds
     _AUTO_BAND_MAX) is timed at the path's fine operator beside its
     bound on the bytes its nonzeros need (the padded width's printed
     beside) and a torch.sparse CSR product of the padded rows (that of
     the nonzeros printed beside; under "shapes"), every level of its
     hierarchy is checked and timed (above), and 10 AMG-PCG iterations
     are profiled;
   - assembly, n=96 fp32: examples/poisson_3d_multigrid.py composed from
     the port with its stiffness from B13 (mesh, structured_plan(mesh),
     element_coords_bt_embedded, B13 launched exactly once, the host-layout
     RHS with the degree-3 rule, apply_dirichlet_stencil on the mesh's
     flags, the general hierarchy on the built operator, the guarded cg to
     1e-6 with K2): converged within one iteration of the same solve on
     K1's eliminated operator, rel L2 error <= 2.0e-4; B13's raw planes
     within 1e-5 x max of K1's raw ones (apply_bc=False); the weak form's
     stencil format within 1e-5 x max of B13's planes (matched by grid
     offset) and of the structured RHS of its own element vectors; its
     phases (B13's wall beside K1's) and peak device memory; B13, K2 and
     B4 must launch;
   - reduction: examples/reduction_bench.py (reduce_sum, B14 with block =
     n / 8, segment_reduce over 1000 segments) on 64 MB, each within 1e-5
     of the fp64 host sum; B14 must launch;
   - saxpy: examples/saxpy_pallas.py through the port's saxpy_cuda main,
     max |err| < 1e-4; B15 must launch;
   - dist_assembly, n=96 (912,673 DOFs), interior nodes jittered by +-0.15
     h (default_rng(0), as scripts/dist_assembly_hw.py), fp32, 4 z-stripe
     shards of 26 store planes on the one card: build_poisson_system_sharded
     launches B8 exactly 4 times and K1 never, its stripes equal K1's
     build bit for bit; solve_poisson_dist_general (Jacobi halo CG, tol
     1e-6) converges to within 1e-4 of the single-card Jacobi cg on K1's
     operator (tests/test_dist_assembly.py's gate), its counts at 4, 1
     and 8 shards within one iteration of the FMA-contracted build's
     (FMA_BUILD_DIST_COUNTS, printed beside); then n=62, 4 shards (250,047
     DOFs, the TPU
     record's size) converges within 167 iterations (the TPU's 152 + 10%);
   - dist_mg: solve_poisson_dist at n=104 in 3D (1,157,625 DOFs), fp64, 8
     shards on the card, the manufactured solution of
     tests/test_dist_mg.py (seed 3), tol 1e-9: converged in fewer than 30
     iterations, error below 1e-7, at least 2 distributed levels;
   - dryrun: the port's dryrun_multichip(8) on the card (the six stages
     of __graft_entry__.py with their asserts; stage 4, the distributed
     AMG, converges in its 100 iterations, MULTICHIP_r05.json's 24
     printed beside), stage 2 within one iteration of MULTICHIP_r05.json's
     13; B8 launched 8 times.
5. The examples through the port's own entry points: each ex_<name> path
   calls tpufem_torch.examples.<name>.main(argv + ["--device", "cuda"]),
   repeats what it prints on '#' lines and gates on the dict it returns
   (the JAX figures: scripts/examples_jax_reference.py on the CPU, fp32;
   the gates and their evidence beside JAX_EX below):
   - ex_reduction_bench: 64 MB fp32, the three golden checks; B14;
   - ex_poisson_2d --cells 64 (4,225 DOFs): its error within 1% of the
     JAX CPU run's, the count within 10% (fp32 to 1e-8); B9;
   - ex_heat_equation --cells 1000 --steps 20 (1,002,001 DOFs): total CG
     iterations within 1% of the port's CPU run's and 12% of the JAX CPU
     run's, L2^2 decaying, within 1e-4 relative of the JAX states', the
     checkpoint read back bit for bit; B9;
   - ex_poisson_3d_multigrid --n 96 (912,673 DOFs): the JAX CPU count
     within one, its error within 1%; K2, B4;
   - ex_poisson_10m (n = 224, 11,390,625 DOFs): the JAX CPU run's 12
     guarded iterations, its error (1.704e-4) or less; K1-K4;
   - ex_unstructured_1m --n 300, Chebyshev and AMG (90,601 rows): the JAX
     CPU counts within 4% (one), errors within 1.5 times; B9;
   - ex_dist_amg_demo --n 96 --devices 8 (9,409 rows, 8 shards on the
     card): converged, the JAX CPU count within one; no kernel, as in the
     reference;
   - ex_elasticity_unstructured --n 200 --precond amg (80,802 DOFs): the
     JAX CPU count within one; B12;
   - ex_elasticity_1m (n = 69, 1,029,000 DOFs): converged in 278 +- 5%
     iterations, error <= 7.8e-4 (the TPU's 278, 7.4e-4); no kernel;
   - ex_generic_assembly_20m (20M triangles): the two golden checks; no
     kernel.
   B14's bandwidth, the assembly's elements per second and elasticity_1m's
   ms per iteration are printed beside the card's name and power limit.

The second-to-last line is the kernels' JSON record (launches summed over
the paths), the last line {"ok": true, "device": {...}}.  Any failed check
raises and the script exits nonzero; without a CUDA device, or without the
package beside it, it exits nonzero and prints no result.
"""
from __future__ import annotations

import contextlib
import importlib
import io
import json
import math
import resource
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

N_MAIN = 96
N_SMALL = 8
N_JACOBI = 64      # with 2 levels the coarsest has 33^3 > 20,000 nodes
N_2D = 1024
N_SCALE = 384
N_ROUTED = 64      # blocked kernels with the routing threshold at 0
N_DIST_TPU = 62    # scripts/dist_assembly_hw.py: the TPU record's size
DIST_TPU_MAXITER = 167   # its 152 iterations plus 10% (fp32 dot order)
# The Jacobi halo CG counts at n=96 (shards: iterations) and the scale
# path's error when K1 and B8 contracted products into fused multiply-adds
# (their rounding since is their plain version's): printed beside this
# run's, which may differ by the rounding (one iteration for the counts)
FMA_BUILD_DIST_COUNTS = {4: 241, 1: 242, 8: 242}
FMA_BUILD_SCALE_ERR = 1.1225e-05
N_DIST_MG = 104    # tests/test_dist_mg.py: 105^3 = 1,157,625 DOFs
DOMAIN = (-3.0, 3.0)
FIELD_TOL = {"float32": 1e-5, "float64": 1e-12}   # x max|plain|
DOT_TOL = 1e-4                                    # relative
REPS = 20

# NVIDIA H100 SXM data sheet: HBM3 rate and the peak rates outside the
# tensor cores of the types these kernels compute in (bf16 data widens to
# fp32 before any operation)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    try:
        import tpufem_torch  # noqa: F401
    except ImportError as exc:
        print(f"chip_smoke: tpufem_torch not importable ({exc}); run from "
              "the repository root", file=sys.stderr)
        return 3

    # full fp32 for the coarse-level matmul (no TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- 1. platform -------------------------------------------------------
    print(_card())
    kind = torch.cuda.get_device_name(0)
    print(f"# torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {kind} count {torch.cuda.device_count()}")
    dev = torch.device("cuda", 0)

    records = {}
    t0 = time.perf_counter()
    _build_kernels()
    _check_kernels(dev, records)
    _check_2d(dev, records)
    _check_scale(dev, records)
    _check_routed(dev, records)
    _check_ell(dev, records)
    _check_bcsr(dev, records)
    _check_assembly(dev, records)
    _check_reduction_saxpy(dev, records)
    _check_dist_assembly(dev, records)
    print(f"# check phase {time.perf_counter() - t0:.1f} s")
    _paths(dev, records)
    print(f"# all phases {time.perf_counter() - t0:.1f} s")

    print(json.dumps({"kernels": list(records.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


_KERNELS = {
    "K1": ("fused_system", "tpufem_torch/csrc/fused_system.cu",
           "tpufem/ops/fused_system_pallas.py:126"),
    "K2": ("stencil_matvec", "tpufem_torch/csrc/stencil.cu",
           "tpufem/ops/stencil_pallas.py:86"),
    "K3": ("residual_restrict (redesigned with staged tiles)",
           "tpufem_torch/csrc/mg_transfer.cu",
           "tpufem/ops/mg_transfer_pallas.py:113"),
    "K4": ("prolong_add_smooth (redesigned with staged tiles)",
           "tpufem_torch/csrc/mg_transfer.cu",
           "tpufem/ops/mg_transfer_pallas.py:217"),
    "B4": ("stencil_residual_smooth", "tpufem_torch/csrc/stencil.cu",
           "tpufem/ops/stencil_pallas.py:92"),
    "B5": ("const_stencil (redesigned with staged tiles)",
           "tpufem_torch/csrc/const_stencil.cu",
           "tpufem/ops/stencil_pallas.py:530"),
    "B7": ("fused_system_2d", "tpufem_torch/csrc/fused_system_2d.cu",
           "tpufem/ops/fused_system_pallas.py:277"),
    "B3": ("stencil_blocked", "tpufem_torch/csrc/stencil_blocked.cu",
           "tpufem/ops/stencil_pallas.py:333"),
    "B5b": ("const_stencil_blocked (redesigned with staged tiles: B5's "
            "kernel on the blocked route)",
            "tpufem_torch/csrc/const_stencil.cu",
            "tpufem/ops/stencil_pallas.py:651"),
    "B9": ("ell_band (with its B11 per_block route, "
           "tpufem/sparse/ell_pallas.py:288; redesigned, the plan's form: "
           "rows, a thread a row on the slot planes; sliced, a thread a row "
           "on slices of 32 sorted rows; split, lanes a row summed in order "
           "out of shared memory; the non-empty rows alone where few)",
           "tpufem_torch/csrc/ell.cu", "tpufem/sparse/ell_pallas.py:268"),
    "B9g": ("ell_gather, absolute columns (the gather form of ELLMatrix "
            "and the Dirichlet correction; redesigned, by row length on "
            "tall matrices: a thread a row in 16-byte groups, staged "
            "through shared memory, or 4 lanes a row relaying the sum; "
            "else lanes a row; zero values skipped)",
            "tpufem_torch/csrc/ell.cu",
            "tpufem/sparse/ell_pallas.py:268"),
    "B10": ("ell_spmv_multi (redesigned: a thread a row, q sums in "
            "registers, the X window staged)", "tpufem_torch/csrc/ell.cu",
            "tpufem/sparse/ell_pallas.py:275"),
    "B10g": ("ell_gather_multi, absolute columns (B10's kernel in "
             "absolute-column mode: the gather form's multi-column product, "
             "the mixed-precision modal path's fp64 residuals)",
             "tpufem_torch/csrc/ell.cu", "tpufem/sparse/ell_pallas.py:275"),
    "B12": ("bcsr_spmv (with its per_block route, "
            "tpufem/sparse/ell_pallas.py:582; redesigned: slots unrolled and "
            "loaded ahead)", "tpufem_torch/csrc/bcsr.cu",
            "tpufem/sparse/ell_pallas.py:548"),
    "B12g": ("bcsr_gather_spmv (the gather form of BCSRMatrix and the "
             "Dirichlet correction; redesigned with staged tiles)",
             "tpufem_torch/csrc/bcsr.cu", "tpufem/sparse/ell_pallas.py:548"),
    "B13": ("assemble_stencil", "tpufem_torch/csrc/assemble.cu",
            "tpufem/ops/assemble_pallas.py:88"),
    "B14": ("block_reduce (pallas_block_reduce)",
            "tpufem_torch/csrc/reduction.cu", "tpufem/ops/reduction.py:49"),
    "B15": ("saxpy", "tpufem_torch/csrc/saxpy.cu",
            "examples/saxpy_pallas.py:23"),
    "B8": ("fused_system_stripe (build_poisson_system_sharded's build of "
           "one z-stripe shard)", "tpufem_torch/csrc/fused_system.cu",
           "tpufem/dist/assembly.py:96"),
}


def _counters():
    """Each kernel's launch count: (the wrapper that carries it, its
    attribute)."""
    from tpufem_torch.ops import assemble_cuda, reduction, saxpy_cuda
    from tpufem_torch.ops import fused_system_cuda, mg_transfer_cuda
    from tpufem_torch.ops import stencil_cuda
    from tpufem_torch.sparse import ell_cuda

    build = fused_system_cuda.build_poisson_system
    return {"K1": (build, "launches"),
            "K2": (stencil_cuda.stencil_apply, "launches"),
            "K3": (mg_transfer_cuda.const_residual_restrict_embedded,
                   "launches"),
            "K4": (mg_transfer_cuda.const_prolong_add_smooth_embedded,
                   "launches"),
            "B4": (stencil_cuda.stencil_fused_apply, "launches"),
            "B5": (stencil_cuda.const_stencil_apply, "launches"),
            "B7": (build, "launches_2d"),
            "B3": (stencil_cuda.stencil_blocked_apply, "launches"),
            "B5b": (stencil_cuda.const_stencil_blocked_apply, "launches"),
            "B9": (ell_cuda.ell_matvec_cuda, "launches"),
            "B9g": (ell_cuda.ell_gather_matvec_cuda, "launches"),
            "B10": (ell_cuda.ell_matvec_multi_cuda, "launches"),
            "B10g": (ell_cuda.ell_gather_matvec_multi_cuda, "launches"),
            "B12": (ell_cuda.bcsr_matvec_cuda, "launches"),
            "B12g": (ell_cuda.bcsr_gather_matvec_cuda, "launches"),
            "B13": (assemble_cuda.assemble_stencil_cuda, "launches"),
            "B14": (reduction.block_reduce, "launches"),
            "B15": (saxpy_cuda.saxpy, "launches"),
            "B8": (fused_system_cuda.build_poisson_stripe, "launches")}


def _record(records, key):
    if key not in records:
        name, source, replaces = _KERNELS[key]
        records[key] = {"name": f"{key} {name}", "route": "cuda",
                        "source": source, "replaces": replaces,
                        "launches": 0, "max_abs_err": 0.0, "ms": None,
                        "plain_ms": None, "bound_ms": None,
                        "bound_by": None, "library_ms": None}
    return records[key]


def _rhs_2d_zero():
    from tpufem_torch.solve.poisson import RhsFunction

    return RhsFunction(lambda x, y: 0.0 * x, "T(0)")


def _build_kernels():
    from tpufem_torch import native
    from tpufem_torch.fem.quadrature import tetrahedron_rule, triangle_rule
    from tpufem_torch.ops import assemble_cuda, reduction, saxpy_cuda
    from tpufem_torch.ops import fused_system_cuda, mg_transfer_cuda
    from tpufem_torch.ops import stencil_cuda
    from tpufem_torch.ops._build import BUILD_DIR
    from tpufem_torch.solve.poisson import (model_problem_2d_planes,
                                            model_problem_3d_planes)
    from tpufem_torch.sparse import ell_cuda

    plan, plan2 = _plan(N_MAIN), _plan(N_2D, 2)
    builds = {
        "ell.cu": ell_cuda._lib,
        "bcsr.cu": ell_cuda._bcsr_lib,
        "stencil.cu": stencil_cuda._stencil_lib,
        "const_stencil.cu": stencil_cuda._const_lib,
        "stencil_blocked.cu": stencil_cuda._blocked_lib,
        "mg_transfer.cu": mg_transfer_cuda._lib,
        "fused_system.cu": lambda: fused_system_cuda._lib(
            plan, tetrahedron_rule(2), model_problem_3d_planes().c_expr),
        "fused_system_2d.cu": lambda: fused_system_cuda._lib(
            plan2, triangle_rule(2), model_problem_2d_planes().c_expr),
        "fused_system_2d.cu (f = 0)": lambda: fused_system_cuda._lib(
            plan2, triangle_rule(2), _rhs_2d_zero().c_expr),
        "assemble.cu": lambda: assemble_cuda._lib(plan),
        "reduction.cu": reduction._lib,
        "saxpy.cu": saxpy_cuda._lib,
        "meshgen.cpp (g++)": native.build_native,
    }

    def timed(build):
        t0 = time.perf_counter()
        build()
        return time.perf_counter() - t0

    # one nvcc process per source, all at once (each waits in its thread)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(builds)) as pool:
        secs = dict(zip(builds, pool.map(timed, builds.values())))
    print(f"# build (parallel) {time.perf_counter() - t0:.2f} s: "
          + ", ".join(f"{k} {v:.2f} s" for k, v in secs.items()))
    for log in sorted(BUILD_DIR.glob("*.log")):
        for line in log.read_text().splitlines():
            if ("Compiling entry function" in line or "registers" in line
                    or "spill" in line):
                print(f"# ptxas {log.stem}: {line.strip()}")


def _plan(n, dim=3):
    from tpufem_torch.assemble.structured import structured_plan
    from tpufem_torch.solve.multigrid import _light_grid

    return structured_plan(_light_grid(DOMAIN, n, dim, with_coords=False)[0],
                           embed=True)


def _err(out, ref, dtype_name):
    """(max abs error, bound) of a field against its plain version."""
    err = (out.double() - ref.double()).abs().max().item()
    return err, FIELD_TOL[dtype_name] * max(ref.abs().max().item(), 1e-30)


def _bound(inputs, outputs, flops, dtype_name):
    """(ms, "bytes" | "operations"): the least time of a call that reads
    each input once, writes each output once and does ``flops``
    operations of ``dtype_name`` (an int among the inputs: bytes read)."""
    nbytes = sum(t if isinstance(t, int) else t.numel() * t.element_size()
                 for t in inputs + outputs)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / PEAK_FLOPS[dtype_name] * 1e3
    return ((bytes_ms, "bytes") if bytes_ms >= ops_ms
            else (ops_ms, "operations"))


def _compare(records, key, label, kernel, plain, *, timed=False, work=None,
             flat=None, flat_equal=False, library=None, exact=False,
             time_plain=True, shapes=False):
    """Run kernel and plain on the same inputs, check, optionally time.

    ``exact``: every output must equal the plain version's bit for bit
    (a hard check, beside the field tolerance); ``time_plain=False`` times
    the kernel alone (a plain version too slow to repeat at the shape);
    ``work``: (input tensors, operations, arithmetic type) for the bound;
    ``flat``: the flat kernel on the same inputs (the blocked kernels are
    held to it too; with ``flat_equal`` bit for bit, dots included);
    ``library``: one PyTorch call that computes the same
    function (timed beside the kernel, used nowhere in the port).  The
    first timed shape of a kernel is its main one, recorded in the JSON;
    with ``shapes`` every timed shape is also listed under the record's
    "shapes".
    """
    import torch

    from tpufem_torch.utils.timing import cuda_ms

    out, ref = kernel(), plain()
    torch.cuda.synchronize()
    outs = out if isinstance(out, tuple) else (out,)
    refs = ref if isinstance(ref, tuple) else (ref,)
    rec = _record(records, key)
    msg = []
    for o, r in zip(outs, refs):
        if o.dim() == 0:                               # a dot
            rel = abs(o.item() - r.item()) / max(abs(r.item()), 1e-30)
            check(rel <= DOT_TOL, f"{key} {label}: dot rel err {rel:.3e}")
            msg.append(f"dot rel {rel:.2e}")
            continue
        dt = str(o.dtype).replace("torch.", "")
        err, bound = _err(o, r, dt)
        check(math.isfinite(err) and err <= bound,
              f"{key} {label}: max abs err {err:.3e} > {bound:.3e}")
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        msg.append(f"max abs err {err:.3e} (bound {bound:.3e})")
    if exact:
        same = all(torch.equal(o, r) for o, r in zip(outs, refs))
        check(same, f"{key} {label}: not bit for bit equal to its plain "
                    "version")
        msg.append("bit for bit equal to the plain version")
    if flat is not None:
        fl = flat()
        fl = fl if isinstance(fl, tuple) else (fl,)
        torch.cuda.synchronize()
        check(not flat_equal or all(torch.equal(o, f)
                                    for o, f in zip(outs, fl)),
              f"{key} {label}: not bit-identical to the flat route")
        for o, f in zip(outs, fl):
            if o.dim() == 0:
                rel = abs(o.item() - f.item()) / max(abs(f.item()), 1e-30)
                check(rel <= DOT_TOL, f"{key} {label}: dot vs flat {rel:.3e}")
                msg.append(f"dot vs flat rel {rel:.2e}")
                continue
            dt = str(o.dtype).replace("torch.", "")
            err, bound = _err(o, f, dt)
            check(err <= bound, f"{key} {label}: vs flat kernel {err:.3e} "
                                f"> {bound:.3e}")
            msg.append(f"vs flat kernel {err:.3e}"
                       + (" (identical)" if torch.equal(o, f) else ""))
    line = f"# check {key} {label}: " + ", ".join(msg)
    if timed:
        # device time (stream queued ahead), then one call at a time with
        # the host's launch overhead included
        ms = cuda_ms(kernel, reps=REPS)
        host_ms = cuda_ms(kernel, reps=REPS, queue_ahead=False)
        if time_plain:
            plain_ms = cuda_ms(plain, reps=REPS)
            host_plain_ms = cuda_ms(plain, reps=REPS, queue_ahead=False)
            line += (f"; device kernel {ms:.4f} ms, plain {plain_ms:.4f} "
                     f"ms; with launch overhead kernel {host_ms:.4f} ms, "
                     f"plain {host_plain_ms:.4f} ms")
        else:
            plain_ms = None
            line += (f"; device kernel {ms:.4f} ms (plain not timed); with "
                     f"launch overhead kernel {host_ms:.4f} ms")
        bound_ms = bound_by = flat_ms = lib_ms = None
        if work is not None:
            inputs, flops, arith = work
            bound_ms, bound_by = _bound(list(inputs), [
                o for o in outs if o.dim() > 0], flops, arith)
            line += (f"; bound {bound_ms:.4f} ms ({bound_by}), "
                     f"{bound_ms / ms:.0%} of it")
        if flat is not None:
            flat_ms = cuda_ms(flat, reps=REPS)
            line += f"; flat kernel {flat_ms:.4f} ms"
        if library is not None:
            lib_ms = _library_ms(library, outs[0], f"{key} {label}")
            line += ("; library call " + ("failed" if lib_ms is None
                                          else f"{lib_ms:.4f} ms"))
        if rec["ms"] is None:
            rec.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                       bound_by=bound_by, library_ms=lib_ms)
        if shapes:
            rec.setdefault("shapes", []).append(
                {"shape": label, "ms": ms, "plain_ms": plain_ms,
                 "bound_ms": bound_ms, "library_ms": lib_ms})
    print(line)


def _library_ms(library, out, what):
    """Time one PyTorch library call computing the same function (checked
    against the kernel's output first); None, with the reason printed, if
    the library cannot run it here."""
    import torch

    from tpufem_torch.utils.timing import cuda_ms

    try:
        fn = library()
        y = fn()
        torch.cuda.synchronize()
        err, bound = _err(y, out, str(out.dtype).replace("torch.", ""))
        print(f"# library call for {what}: max abs err vs the kernel "
              f"{err:.3e} (bound {bound:.3e})")
        return cuda_ms(fn, reps=REPS)
    except (RuntimeError, NotImplementedError) as exc:
        print(f"# library call for {what} failed: {type(exc).__name__}: "
              f"{str(exc).splitlines()[0][:200]}")
        return None
    finally:
        torch.cuda.empty_cache()


def _library_spmv(data, offsets, x):
    """() -> (() -> A x) through one torch sparse CSR product: A holds the
    stencil's rows with all K entries (columns outside [0, NS) clamped,
    with value 0), int32 indices, built once on the card."""
    import torch

    def make():
        n, k = data.shape[1], len(offsets)
        rows = torch.arange(n, device=data.device)
        cols = torch.empty((n, k), dtype=torch.int32, device=data.device)
        vals = torch.empty((n, k), dtype=data.dtype, device=data.device)
        # ascending offsets give ascending columns in every row
        for j, kk in enumerate(sorted(range(k), key=lambda i: offsets[i])):
            c = rows + offsets[kk]
            vals[:, j] = torch.where((c >= 0) & (c < n), data[kk], 0.0)
            cols[:, j] = c.clamp_(0, n - 1).to(torch.int32)
        del rows, c
        crow = torch.arange(0, n * k + 1, k, dtype=torch.int32,
                            device=data.device)
        A = torch.sparse_csr_tensor(crow, cols.view(-1), vals.view(-1),
                                    size=(n, n))
        return lambda: A @ x

    return make


def _stencil_flops(epilogue, k, with_dot=False):
    """Operations per row: K multiply-adds, and the epilogue's."""
    return 2 * k + {"matvec": 0, "residual": 1, "smooth": 4}[epilogue] + (
        2 if with_dot else 0)


# operations per element of the fused builds (geometry, the element
# stiffness once, the RHS quadrature), counted from the kernels' formulas:
# tetrahedron 60 + 60 + 4 points x 41 + 4; triangle 14 + 24 + 3 x 21 + 3
_ELEMENT_FLOPS = {3: 288, 2: 104}


def _arrays(system):
    A, b = system
    return A.data, b


def _rand_like_code(gen, code, dtype=None):
    """Random vector on the rows where ``code`` is nonzero (the nodes), 0
    on the padding."""
    import torch

    v = torch.randn(code.shape, generator=gen, device=code.device,
                    dtype=dtype or code.dtype)
    return torch.where(code != 0, v, 0.0)


def _check_general_levels(records, levels, n, timed, *, dims=""):
    """B4 (and, with bf16 data, its bf16 entries) on every general level."""
    import torch

    from tpufem_torch.ops.stencil_cuda import (stencil_fused_apply,
                                               stencil_fused_apply_plain)
    from tpufem_torch.solve import multigrid as mg

    gen = torch.Generator(device=levels[0].data.device).manual_seed(1)
    for dname, lvs in (("fp32", levels),
                       ("bf16", mg.cast_hierarchy(levels, torch.bfloat16))):
        for lv in lvs:
            nl = lv.plan.info.cell_grid[0]
            node = lv.data[lv.plan.offsets.index(0)]
            xs = _rand_like_code(gen, node, torch.float32)
            rs = _rand_like_code(gen, node, torch.float32)
            ii = lv.inv_diag
            k = lv.data.shape[0]
            rows = xs.numel()
            for label, ep, kw in (("smooth", "smooth", dict(inv_diag=ii)),
                                  ("smooth+dot", "smooth",
                                   dict(inv_diag=ii, with_dot=True)),
                                  ("residual", "residual", {})):
                if dname == "bf16" and ep == "residual":
                    continue
                args = (ep, lv.data, xs, lv.plan.offsets)
                ins = [lv.data, xs, rs] + ([ii] if "inv_diag" in kw else [])
                _compare(records, "B4",
                         f"{dims}n={n} level {nl} {dname} data {label}",
                         lambda: stencil_fused_apply(*args, b=rs, **kw),
                         lambda: stencil_fused_apply_plain(*args, b=rs,
                                                           **kw),
                         timed=timed and nl == n,
                         work=(ins, rows * _stencil_flops(
                             ep, k, kw.get("with_dot", False)), "float32"))


def _check_const_levels(records, levels, n, timed, *, dims="", at=None):
    """B5 (all four epilogues) on every const level, timed (with
    ``timed``) on level ``at`` (default n); a bf16 code plane must leave
    the sweep bit-identical."""
    import torch

    from tpufem_torch.ops.stencil_cuda import (const_stencil_apply,
                                               const_stencil_apply_plain)

    gen = torch.Generator(device=levels[0].code.device).manual_seed(2)
    for lv in levels:
        nl = lv.plan.info.cell_grid[0]
        xs, rs = (_rand_like_code(gen, lv.code),
                  _rand_like_code(gen, lv.code))
        k, rows = len(lv.weights), xs.numel()
        dt = str(xs.dtype).replace("torch.", "")
        for label, ep, kw in (("smooth", "smooth", dict(b=rs)),
                              ("smooth+dot", "smooth",
                               dict(b=rs, with_dot=True)),
                              ("matvec", "matvec", {}),
                              ("residual", "residual", dict(b=rs))):
            args = (ep, lv.weights, lv.code, xs, lv.plan.offsets)
            ins = [lv.code, xs] + ([rs] if "b" in kw else [])
            _compare(records, "B5", f"{dims}n={n} level {nl} {dt} {label} "
                                    f"(K={k})",
                     lambda: const_stencil_apply(*args, **kw),
                     lambda: const_stencil_apply_plain(*args, **kw),
                     timed=timed and nl == (at or n),
                     work=(ins, rows * _stencil_flops(
                         ep, k, kw.get("with_dot", False)), dt))
        if xs.dtype != torch.float32:
            continue            # bf16 code runs under fp32 vectors only
        code16 = lv.code.to(torch.bfloat16)
        same = torch.equal(
            const_stencil_apply("smooth", lv.weights, code16, xs,
                                lv.plan.offsets, b=rs),
            const_stencil_apply("smooth", lv.weights, lv.code, xs,
                                lv.plan.offsets, b=rs))
        check(same, f"B5 {dims}n={n} level {nl}: a bf16 code plane changed "
                    "the sweep")


def _check_kernels(dev, records):
    """The 3D kernels of the first two slices: K1-K4, B4, B5."""
    import numpy as np
    import torch

    from tpufem_torch.fem.quadrature import tetrahedron_rule
    from tpufem_torch.ops.fused_system_cuda import (
        build_poisson_system, build_poisson_system_plain,
        node_coords_embedded_from_grid)
    from tpufem_torch.ops.stencil_cuda import (stencil_apply,
                                               stencil_apply_plain)
    from tpufem_torch.solve import multigrid as mg
    from tpufem_torch.solve.poisson import model_problem_3d_planes

    f, rule = model_problem_3d_planes(), tetrahedron_rule(2)
    gen = torch.Generator(device=dev).manual_seed(0)

    # every shape the paths give B4, B5, K3 and K4: the 5-level n=96
    # hierarchies, the n=8 ones, and the 2-level n=64 ones of "jacobi"
    for n, depth in ((N_MAIN, dict(coarse_max=8)),
                     (N_SMALL, dict(coarse_max=4)),
                     (N_JACOBI, dict(levels=2))):
        timed = n == N_MAIN
        info, coords, bc = mg._light_grid(DOMAIN, n)
        plan = _plan(n)
        C = torch.as_tensor(node_coords_embedded_from_grid(
            coords, plan, np.float32), device=dev)
        _compare(records, "K1", f"n={n} fp32",
                 lambda: _arrays(build_poisson_system(plan, C, f, rule)),
                 lambda: _arrays(build_poisson_system_plain(plan, C, f,
                                                            rule)),
                 timed=timed, work=([C], 6 * n ** 3 * _ELEMENT_FLOPS[3],
                                    "float32"), exact=True)
        if timed:
            # fp64 and the interp RHS at the main shape, bit for bit too
            C64 = C.double()
            _compare(records, "K1", f"n={n} fp64",
                     lambda: _arrays(build_poisson_system(plan, C64, f,
                                                          rule)),
                     lambda: _arrays(build_poisson_system_plain(
                         plan, C64, f, rule)),
                     timed=True, work=([C64], 6 * n ** 3 * _ELEMENT_FLOPS[3],
                                       "float64"), exact=True)
            del C64
            _compare(records, "K1", f"n={n} fp32 interp RHS",
                     lambda: _arrays(build_poisson_system(
                         plan, C, f, rule, rhs_mode="interp")),
                     lambda: _arrays(build_poisson_system_plain(
                         plan, C, f, rule, rhs_mode="interp")), exact=True)
        A, b = build_poisson_system(plan, C, f, rule)
        code = torch.as_tensor(mg._embed_grid_numpy(
            np.ones(info.node_grid), plan.store_grid), device=dev,
            dtype=torch.float32)
        x = _rand_like_code(gen, code)
        k, rows = plan.width, x.numel()
        _compare(records, "K2", f"n={n} fp32 matvec",
                 lambda: stencil_apply(A.data, x, plan.offsets),
                 lambda: stencil_apply_plain(A.data, x, plan.offsets),
                 timed=timed, work=([A.data, x],
                                    rows * _stencil_flops("matvec", k),
                                    "float32"),
                 library=_library_spmv(A.data, plan.offsets, x))
        _compare(records, "K2", f"n={n} fp32 matvec+dot",
                 lambda: stencil_apply(A.data, x, plan.offsets,
                                       with_dot=True),
                 lambda: stencil_apply_plain(A.data, x, plan.offsets,
                                             with_dot=True), timed=timed,
                 work=([A.data, x], rows * _stencil_flops("matvec", k, True),
                       "float32"))
        raw64 = mg._apply_bc_numpy(
            mg._uniform_stencil_data(plan, mg._uniform_cell_stiffness(
                DOMAIN, n)), plan.offsets,
            mg._embed_grid_numpy(bc, plan.store_grid, fill=False))
        d64 = torch.as_tensor(raw64, device=dev)
        x64 = x.double()
        _compare(records, "K2", f"n={n} fp64 matvec",
                 lambda: stencil_apply(d64, x64, plan.offsets),
                 lambda: stencil_apply_plain(d64, x64, plan.offsets),
                 timed=timed, work=([d64, x64],
                                    rows * _stencil_flops("matvec", k),
                                    "float64"))
        del d64, raw64

        # B4 on every level of the general hierarchy over the built
        # operator (top=), fp32 data, and bf16 data (its cast_hierarchy
        # copy) under fp32 vectors
        bc_mask = torch.as_tensor(mg._embed_grid_numpy(
            bc, plan.store_grid, fill=False), device=dev)
        general = mg.build_poisson_multigrid(DOMAIN, n, top=(A.data, bc_mask),
                                             device=dev, **depth)
        _check_general_levels(records, general, n, timed)
        del general

        levels = mg.build_poisson_multigrid(DOMAIN, n, operator="const",
                                            device=dev, **depth)
        _check_const_levels(records, levels, n, timed)
        _check_transfers(records, gen, levels, timed)


def _check_transfers(records, gen, levels, timed):
    """K3 and K4 (without and with the dot) on every const level pair."""
    from tpufem_torch.ops.mg_transfer_cuda import (
        const_prolong_add_smooth_embedded, const_prolong_add_smooth_plain,
        const_residual_restrict_embedded, const_residual_restrict_plain)

    for lf, lc in zip(levels[:-1], levels[1:]):
        nf, nc = lf.plan.info.cell_grid[0], lc.plan.info.cell_grid[0]
        r, e, ec = (_rand_like_code(gen, lf.code),
                    _rand_like_code(gen, lf.code),
                    _rand_like_code(gen, lc.code))
        rows_f = r.numel()
        a3 = (lf.weights, lf.code, lc.code, r, e, lf.plan, lc.plan)
        # residual (2K + 1) and the 15-point restriction stencil
        _compare(records, "K3", f"{nf}->{nc} fp32",
                 lambda: const_residual_restrict_embedded(*a3),
                 lambda: const_residual_restrict_plain(*a3), timed=timed,
                 work=([lf.code, lc.code, r, e],
                       rows_f * (_stencil_flops("residual", 15) + 15),
                       "float32"))
        a4 = (lf.weights, lf.code, ec, r, e, lf.plan, lc.plan)
        for wd in (False, True):
            # prolongation stencil, the add and the sweep
            _compare(records, "K4",
                     f"{nf}->{nc} fp32{' +dot' if wd else ''}",
                     lambda: const_prolong_add_smooth_embedded(
                         *a4, with_dot=wd),
                     lambda: const_prolong_add_smooth_plain(
                         *a4, with_dot=wd), timed=timed,
                     work=([lf.code, ec, r, e], rows_f * (
                         16 + _stencil_flops("smooth", 15, wd)),
                         "float32"))


def _check_2d(dev, records):
    """B7 at n=1024 and n=8 (fp32, fp64; bit for bit, both RHS modes at
    n=8, the tile it launches printed); B5 with 7 offsets on every 2D
    const level; K2 and B4 on every level of the 2D general hierarchy."""
    import numpy as np
    import torch

    from tpufem_torch.fem.quadrature import triangle_rule
    from tpufem_torch.ops.fused_system_cuda import (
        build_poisson_system, build_poisson_system_plain, fused_2d_tiling,
        node_coords_embedded_from_grid)
    from tpufem_torch.ops.stencil_cuda import (stencil_apply,
                                               stencil_apply_plain)
    from tpufem_torch.solve import multigrid as mg
    from tpufem_torch.solve.poisson import model_problem_2d_planes

    f, rule = model_problem_2d_planes(), triangle_rule(2)
    gen = torch.Generator(device=dev).manual_seed(3)
    for n in (N_2D, N_SMALL):
        info, coords, bc = mg._light_grid(DOMAIN, n, 2)
        plan = _plan(n, 2)
        for np_dt in (np.float32, np.float64):
            C = torch.as_tensor(node_coords_embedded_from_grid(
                coords, plan, np_dt), device=dev)
            dt = str(C.dtype).replace("torch.", "")
            tx, rows, smem, grid = fused_2d_tiling(C.element_size(),
                                                   tuple(plan.store_grid))
            print(f"# tile B7 2D n={n} {dt}: {tx} cells completing "
                  f"{tx - 1} columns, bands of {rows} rows, grid {grid}, "
                  f"{smem} B of shared memory a block")
            for apply_bc in (True, False):
                for mode in ("quadrature", "interp"):
                    if mode == "interp" and n != N_SMALL:
                        continue        # timed at n=1024 in the path's mode
                    _compare(records, "B7",
                             f"2D n={n} {dt}{'' if apply_bc else ' raw'}"
                             + ("" if mode == "quadrature" else " interp"),
                             lambda: _arrays(build_poisson_system(
                                 plan, C, f, rule, apply_bc=apply_bc,
                                 rhs_mode=mode)),
                             lambda: _arrays(build_poisson_system_plain(
                                 plan, C, f, rule, apply_bc=apply_bc,
                                 rhs_mode=mode)),
                             timed=n == N_2D and apply_bc, shapes=True,
                             exact=True,
                             work=([C], 2 * n ** 2 * _ELEMENT_FLOPS[2], dt))
        # K2 on the fp32 operator (2d path) and on the fp64 one
        # (2d_dirichlet path)
        ops = {}
        for np_dt in (np.float32, np.float64):
            C = torch.as_tensor(node_coords_embedded_from_grid(
                coords, plan, np_dt), device=dev)
            A, _ = build_poisson_system(plan, C, f, rule)
            ops[np_dt] = A
            dt = str(C.dtype).replace("torch.", "")
            if np_dt == np.float32:
                x = _rand_like_code(gen, A.data[plan.offsets.index(0)])
            xv = x.to(C.dtype)
            for wd in (False, True):
                _compare(records, "K2", f"2D n={n} {dt} matvec"
                                        f"{'+dot' if wd else ''} (K=7)",
                         lambda: stencil_apply(A.data, xv, plan.offsets,
                                               with_dot=wd),
                         lambda: stencil_apply_plain(A.data, xv,
                                                     plan.offsets,
                                                     with_dot=wd),
                         timed=n == N_2D and np_dt == np.float32,
                         work=([A.data, xv], x.numel()
                               * _stencil_flops("matvec", 7, wd), dt))
        timed = n == N_2D
        A = ops[np.float32]
        bc_mask = torch.as_tensor(mg._embed_grid_numpy(
            bc, plan.store_grid, fill=False), device=dev)
        general = mg.build_poisson_multigrid(DOMAIN, n, 2,
                                             top=(A.data, bc_mask),
                                             device=dev)
        _check_general_levels(records, general, n, timed, dims="2D ")
        del general
        levels = mg.build_poisson_multigrid(DOMAIN, n, 2, operator="const",
                                            device=dev)
        if n == N_2D:
            check(len(levels) == 8 and levels[-1].coarse_inverse is not None
                  and levels[-1].coarse_inverse.shape == (81, 81),
                  "2D hierarchy: expected 8 levels with an 81-node dense "
                  "inverse")
        _check_const_levels(records, levels, n, timed, dims="2D ")
        levels = mg.build_poisson_multigrid(DOMAIN, n, 2, operator="const",
                                            dtype=torch.float64, device=dev)
        _check_const_levels(records, levels, n, False, dims="2D ")


def _blocked_cases(records, label, gen_level, con_level, x, b, timed,
                   data_dtypes):
    """B3's five and B5b's four epilogues on one 3D level pair, each through
    the routed wrappers' blocked call, against the plain version and the
    flat kernel on the same inputs."""
    import torch

    from tpufem_torch.ops import stencil_cuda as sc

    sg = gen_level.plan.store_grid
    offs = gen_level.plan.offsets
    k, rows = len(offs), x.numel()
    arith = str(x.dtype).replace("torch.", "")
    for ddt in data_dtypes:
        dname = str(ddt).replace("torch.", "")
        data = gen_level.data.to(ddt)
        inv_diag = gen_level.inv_diag.to(ddt)
        for ep, wd in (("matvec", False), ("matvec", True),
                       ("residual", False), ("smooth", False),
                       ("smooth", True)):
            kw = dict(with_dot=wd)
            ins = [data, x]
            if ep != "matvec":
                kw["b"] = b
                ins.append(b)
            if ep == "smooth":
                kw["inv_diag"] = inv_diag
                ins.append(inv_diag)
            if ep == "matvec":
                plain = lambda: sc.stencil_apply_plain(data, x, offs,
                                                       with_dot=wd)
                flat = lambda: sc.stencil_apply(data, x, offs, with_dot=wd)
            else:
                plain = lambda: sc.stencil_fused_apply_plain(ep, data, x,
                                                             offs, **kw)
                flat = lambda: sc.stencil_fused_apply(ep, data, x, offs,
                                                      **kw)
            lib = None
            if timed and ep == "matvec" and not wd and ddt == x.dtype:
                lib = _library_spmv(data, offs, x)
            _compare(records, "B3", f"{label} {dname} data {ep}"
                                    f"{'+dot' if wd else ''}",
                     lambda: sc.stencil_blocked_apply(ep, data, x, offs, sg,
                                                      **kw),
                     plain, flat=flat, timed=timed,
                     work=(ins, rows * _stencil_flops(ep, k, wd), arith),
                     library=lib)
        del data, inv_diag
        torch.cuda.empty_cache()
    con = con_level
    for ddt in data_dtypes:
        dname = str(ddt).replace("torch.", "")
        code = con.code.to(ddt)
        for ep, wd in (("smooth", False), ("smooth", True),
                       ("matvec", False), ("residual", False)):
            kw = dict(b=None if ep == "matvec" else b, with_dot=wd)
            args = (ep, con.weights, code, x, con.plan.offsets)
            ins = [code, x] + ([b] if ep != "matvec" else [])
            _compare(records, "B5b", f"{label} {dname} code {ep}"
                                     f"{'+dot' if wd else ''}",
                     lambda: sc.const_stencil_blocked_apply(
                         *args, con.plan.store_grid, **kw),
                     lambda: sc.const_stencil_apply_plain(*args, **kw),
                     flat=lambda: sc.const_stencil_apply(*args, **kw),
                     flat_equal=True, timed=timed,
                     work=(ins, rows * _stencil_flops(ep, 15, wd), arith))


def _check_scale(dev, records):
    """Every kernel at the n=384 shapes of the scale path: K1 against its
    plain version; B3 and B5b (all epilogues) on the finest level of the
    general and const hierarchies, fp32 and bf16 data, also against the
    flat kernels; B4 and B5 on level 192; K3 and K4 on 384->192->96,
    timed."""
    import numpy as np
    import torch

    from tpufem_torch.fem.quadrature import tetrahedron_rule
    from tpufem_torch.ops import stencil_cuda as sc
    from tpufem_torch.ops.fused_system_cuda import (
        build_poisson_system, build_poisson_system_plain,
        node_coords_embedded_from_grid)
    from tpufem_torch.solve import multigrid as mg
    from tpufem_torch.solve.poisson import model_problem_3d_planes

    gen = torch.Generator(device=dev).manual_seed(4)
    f, rule = model_problem_3d_planes(), tetrahedron_rule(2)
    t0 = time.perf_counter()
    _, coords, bc = mg._light_grid(DOMAIN, N_SCALE)
    plan = _plan(N_SCALE)
    C = torch.as_tensor(node_coords_embedded_from_grid(
        coords, plan, np.float32), device=dev)
    del coords
    # K*NS = 1.18e9 rows of stencil data: every index product is 64-bit;
    # the plain version (seconds a call here) is not timed
    _compare(records, "K1", f"n={N_SCALE} fp32",
             lambda: _arrays(build_poisson_system(plan, C, f, rule)),
             lambda: _arrays(build_poisson_system_plain(plan, C, f, rule)),
             timed=True, time_plain=False,
             work=([C], 6 * N_SCALE ** 3 * _ELEMENT_FLOPS[3], "float32"),
             exact=True)
    torch.cuda.empty_cache()
    A, _ = build_poisson_system(plan, C, f, rule)
    del C
    bc_mask = torch.as_tensor(mg._embed_grid_numpy(
        bc, plan.store_grid, fill=False), device=dev)
    general = mg.build_poisson_multigrid(DOMAIN, N_SCALE, top=(A.data,
                                                               bc_mask),
                                         device=dev)
    con = mg.build_poisson_multigrid(DOMAIN, N_SCALE, operator="const",
                                     device=dev)
    check(len(general) == len(con) == 7, "n=384: expected 7 levels")
    check(all(sc._needs_2d(tuple(plan.store_grid), w, e, 4)
              for w, e in ((15, 0), (15, 1), (15, 2), (3, 0), (3, 1))),
          "n=384: the reference's rule must route every call to B3 / B5b")
    check(not any(sc._needs_2d(tuple(lv.plan.store_grid), w, e, 4)
                  for lv in con[1:]
                  for w, e in ((15, 0), (15, 1), (15, 2), (3, 0), (3, 1))),
          "n=384: level 192 and below must take the flat kernels")
    x, b = _rand_like_code(gen, con[0].code), _rand_like_code(gen,
                                                              con[0].code)
    print(f"# scale checks: setup {time.perf_counter() - t0:.2f} s, store "
          f"grid {tuple(plan.store_grid)}")
    _blocked_cases(records, f"n={N_SCALE}", general[0], con[0], x, b, True,
                   (torch.float32, torch.bfloat16))
    del x, b
    torch.cuda.empty_cache()
    _check_general_levels(records, general[1:2], N_SCALE, False)
    _check_const_levels(records, con[1:2], N_SCALE, True, at=N_SCALE // 2)
    _check_transfers(records, gen, con[:3], True)
    del A, general, con, bc_mask
    torch.cuda.empty_cache()


def _check_routed(dev, records):
    """B3 and B5b at n=64 with the routing threshold at 0, through the
    routed wrappers, in fp32, bf16-under-fp32 and fp64."""
    import torch

    from tpufem_torch.ops import stencil_cuda as sc
    from tpufem_torch.solve import multigrid as mg

    gen = torch.Generator(device=dev).manual_seed(5)
    limit = sc._VMEM_1D_LIMIT
    sc._VMEM_1D_LIMIT = 0
    try:
        for vdt, ddts in ((torch.float32, (torch.float32, torch.bfloat16)),
                          (torch.float64, (torch.float64,))):
            gl = mg.build_poisson_multigrid(DOMAIN, N_ROUTED, dtype=vdt,
                                            levels=1, device=dev)[0]
            cl = mg.build_poisson_multigrid(DOMAIN, N_ROUTED, dtype=vdt,
                                            levels=1, operator="const",
                                            device=dev)[0]
            x, b = _rand_like_code(gen, cl.code), _rand_like_code(gen,
                                                                  cl.code)
            _blocked_cases(records, f"n={N_ROUTED} threshold 0", gl, cl, x,
                           b, False, ddts)
            before = (sc.stencil_blocked_apply.launches,
                      sc.const_stencil_blocked_apply.launches)
            sc.stencil_smooth_dot_embedded(gl.data, b, x, gl.inv_diag,
                                           gl.plan)
            sc.const_smooth_dot_embedded(cl.weights, cl.code, b, x, cl.plan)
            check((sc.stencil_blocked_apply.launches - before[0],
                   sc.const_stencil_blocked_apply.launches - before[1])
                  == (1, 1), "threshold 0: the routed wrappers did not "
                             "launch B3 / B5b")
    finally:
        sc._VMEM_1D_LIMIT = limit


N_ELL = 1000                        # mesh lines a side: 1,002,001 rows
ELL_ROWS, ELL_ELEMENTS, ELL_BANDWIDTH = 1_002_001, 2_000_000, 1001
ELL_SLOTS = 8
# The JAX package's own CPU iteration counts of the ell_small solves
# (float64, Jacobi, tol 1e-10), from
#   TPUFEM_BAND_DISPATCH=0 python -c "import jax; jax.config.update(
#   'jax_platforms', 'cpu'); jax.config.update('jax_enable_x64', True);
#   from tpufem.mesh.rectangle import RectangleMesh as R,
#   perturbed_rectangle_mesh as P; from tpufem.solve.poisson import
#   solve_poisson_ell as s; print(int(s(R(-3, 3, -3, 3, 64, 64),
#   tol=1e-10).cg.iterations), int(s(P(-3, 3, -3, 3, 96, 96, jitter=0.2,
#   seed=1), tol=1e-10).cg.iterations))"
# which prints "119 374" (relres 9.96e-11 and 9.91e-11 at the stop).
JAX_ELL_SMALL_ITERS = {"rect64": 119, "perturbed96": 374}


def _library_ell(data, cols, x, nonzeros=False):
    """() -> (() -> A x) through one torch sparse CSR product: the ELL rows
    with their K entries (columns sorted within each row), int32 indices,
    built once on the card; with ``nonzeros`` only the nonzero entries (the
    padding of a padded level left out).  x may be [n] or [n, q]."""
    import torch

    def make():
        n, k = data.shape
        c, order = cols.long().sort(dim=1)
        vals = data.gather(1, order)
        if nonzeros:
            keep = vals != 0
            crow = torch.zeros(n + 1, dtype=torch.int64, device=data.device)
            crow[1:] = keep.sum(1).cumsum(0)
            A = torch.sparse_csr_tensor(
                crow.to(torch.int32), c[keep].to(torch.int32), vals[keep],
                size=(n, x.shape[0]))
        else:
            crow = torch.arange(0, n * k + 1, k, dtype=torch.int32,
                                device=data.device)
            A = torch.sparse_csr_tensor(crow, c.to(torch.int32).reshape(-1),
                                        vals.reshape(-1), size=(n, n))
        del c, order
        return lambda: A @ x

    return make


def _check_ell(dev, records):
    """B9 (fp32 / fp64, int16 / int32 windows, the B11 route), its
    absolute-column mode and B10 (q = 3, 1, 8) against their plain versions
    at the unstructured path's shapes: 1,002,001 rows, 8 slots, columns
    within 1001 of the diagonal, random data from a seeded generator."""
    import torch

    from tpufem_torch.sparse import ell_cuda as ec

    gen = torch.Generator(device=dev).manual_seed(6)
    n, k, band = ELL_ROWS, ELL_SLOTS, ELL_BANDWIDTH
    t0 = time.perf_counter()
    cols = (torch.arange(n, device=dev)[:, None] + torch.randint(
        -band, band + 1, (n, k), generator=gen, device=dev)).clamp_(
        0, n - 1).to(torch.int32)
    data32 = torch.randn((n, k), generator=gen, device=dev)
    x32 = torch.randn(n, generator=gen, device=dev)
    plans = {"int16": ec.ell_band_plan(data32, cols, per_block=True),
             "int32": ec.ell_band_plan(data32, cols, block_rows=11008)}
    print(f"# ell checks: plans {time.perf_counter() - t0:.2f} s (host), "
          + ", ".join(f"{kk} R={p.block_rows} NP={p.np_rows} "
                      f"rel {p.rel.dtype}" for kk, p in plans.items()))
    check(plans["int16"].rel.dtype.name == "int16"
          and plans["int16"].np_rows == 1_007_616
          and plans["int32"].rel.dtype.name == "int32",
          "ell plans: expected R = 8192 with int16 and R = 11008 with int32")
    for dtype in (torch.float32, torch.float64):
        dt = str(dtype).replace("torch.", "")
        data, x = data32.to(dtype), x32.to(dtype)
        for idx, plan in plans.items():
            d_t = torch.as_tensor(plan.data_t, device=dev).to(dtype)
            rel = torch.as_tensor(plan.rel, device=dev)
            args = (plan, d_t, rel)
            lay = ec.ell_band_prepare(*args)
            main = dtype == torch.float32 and idx == "int16"
            for per_block in ((False, True) if idx == "int16" else (False,)):
                _compare(records, "B9", f"{n} rows {dt} {idx} rel"
                                        f"{' B11 per_block' if per_block else ''}",
                         lambda: ec.ell_matvec_cuda(*args, x,
                                                    per_block=per_block,
                                                    layout=lay),
                         lambda: ec.ell_band_matvec_plain(*args, x),
                         timed=True,
                         work=([d_t[:, :n], rel[:, :n], x], 2 * k * n, dt),
                         library=(_library_ell(data, cols, x)
                                  if main and not per_block else None))
            if dtype == torch.float32 and idx == "int16":
                for q in (3, 1, 8):
                    X = torch.randn((n, q), generator=gen, device=dev)
                    _compare(records, "B10", f"{n} rows fp32 int16 rel q={q}",
                             lambda: ec.ell_matvec_multi_cuda(*args, X,
                                                              layout=lay),
                             lambda: ec.ell_band_matvec_multi_plain(*args, X),
                             timed=True, exact=True, shapes=True,
                             work=([d_t[:, :n], rel[:, :n], X],
                                   2 * k * n * q, dt),
                             library=_library_ell(data, cols, X))
            del d_t, rel, lay
        _compare(records, "B9g", f"{n} rows {dt} absolute columns",
                 lambda: ec.ell_gather_matvec_cuda(data, cols, x),
                 lambda: ec.ell_gather_matvec_plain(data, cols, x),
                 timed=True, work=([data, cols, x], 2 * k * n, dt),
                 library=(_library_ell(data, cols, x)
                          if dtype == torch.float32 else None))
        X = torch.randn((n, 3), generator=gen, device=dev, dtype=dtype)
        _compare(records, "B10g", f"{n} rows {dt} absolute columns q=3",
                 lambda: ec.ell_gather_matvec_multi_cuda(data, cols, X),
                 lambda: ec.ell_gather_matvec_multi_plain(data, cols, X),
                 exact=True, timed=dtype == torch.float32, shapes=True,
                 work=([data, cols, X], 2 * k * n * 3, dt),
                 library=_library_ell(data, cols, X))
    del data32, x32, cols
    torch.cuda.empty_cache()


# B12 at the elasticity paths' shapes: the 700 x 700 mesh's 491,401 nodes
# (b = 2, K = 8, its RCM half bandwidth about 700, R = 1024) and the
# n = 40 box's 68,921 nodes (b = 3, K = 16, half bandwidth 1723, R = 4096)
BCSR_2D = dict(n=491_401, k=8, band=701, b=2, block_rows=1024)
BCSR_3D = dict(n=68_921, k=16, band=1723, b=3, block_rows=4096)


def _library_bcsr(data, cols, x, component_major):
    """() -> (() -> A x) through one torch sparse product on the card, built
    once: the BSR tensor of the blocks data [NR, K, b, b] (columns sorted
    within each row) where torch runs BSR @ x on CUDA, else its scalar CSR
    expansion.  x is node-major [NR * b]; with ``component_major`` the
    product is returned as the kernel's [b, NR] view."""
    import torch

    def make():
        nr, k, b, _ = data.shape
        c, order = cols.long().sort(dim=1)
        vals = data[torch.arange(nr, device=data.device)[:, None], order]
        shape = (nr * b, nr * b)
        view = ((lambda y: y.view(nr, b).T) if component_major
                else (lambda y: y))
        try:
            A = torch.sparse_bsr_tensor(
                torch.arange(0, nr * k + 1, k, dtype=torch.int32,
                             device=data.device),
                c.to(torch.int32).reshape(-1), vals.reshape(-1, b, b),
                size=shape)
            A @ x
            torch.cuda.synchronize()
            print("# library call: torch BSR @ x (blocks "
                  f"{b}x{b})")
        except (RuntimeError, NotImplementedError) as exc:
            print(f"# library call: BSR @ x not available here "
                  f"({type(exc).__name__}: {str(exc).splitlines()[0][:120]})"
                  "; the scalar CSR expansion instead")
            # block row i, component cc: the k*b entries (slot, d)
            ccols = (c[:, None, :, None] * b + torch.arange(
                b, device=data.device)).expand(nr, b, k, b)
            A = torch.sparse_csr_tensor(
                torch.arange(0, nr * b * k * b + 1, k * b, dtype=torch.int32,
                             device=data.device),
                ccols.reshape(-1).to(torch.int32),
                vals.permute(0, 2, 1, 3).reshape(-1), size=shape)
        del c, order, vals
        return lambda: view(A @ x)

    return make


def _bcsr_case(gen, n, k, band, b, dev):
    """Random BCSR data [n, k, b, b], int32 cols [n, k] within ``band`` of
    the diagonal and a component-major x [b, n]."""
    import torch

    cols = (torch.arange(n, device=dev)[:, None] + torch.randint(
        -band, band + 1, (n, k), generator=gen, device=dev)).clamp_(0, n - 1)
    data = torch.randn((n, k, b, b), generator=gen, device=dev)
    x = torch.randn((b, n), generator=gen, device=dev)
    return data, cols.to(torch.int32), x


def _check_bcsr(dev, records):
    """B12 against its plain version at the elasticity paths' shapes: the 2D
    one in fp32 and fp64 with int16 (R = 1024) and int32 (R = 11008) window
    indices and the per_block route; the 3D one (b = 3, K = 16, R = 4096);
    at both, the absolute-column mode on a randomly numbered pattern
    (columns anywhere).  The library call is torch's BSR (or CSR)
    product."""
    import torch

    from tpufem_torch.sparse import ell_cuda as ec

    gen = torch.Generator(device=dev).manual_seed(8)
    for label, shape, idx_plans in (
            ("2D", BCSR_2D, {"int16": dict(block_rows=1024, per_block=True),
                             "int32": dict(block_rows=11008)}),
            ("3D", BCSR_3D, {"int16": dict(block_rows=4096)})):
        n, k, b = shape["n"], shape["k"], shape["b"]
        data32, cols, x32 = _bcsr_case(gen, n, k, shape["band"], b, dev)
        t0 = time.perf_counter()
        plans = {kk: ec.bcsr_band_plan(data32, cols, **kw)
                 for kk, kw in idx_plans.items()}
        print(f"# bcsr checks {label}: plans {time.perf_counter() - t0:.2f} "
              "s (host), " + ", ".join(
                  f"{kk} R={p.block_rows} NP={p.np_rows} rel {p.rel.dtype}"
                  for kk, (p, _) in plans.items()))
        check(all(p.rel.dtype.name == kk for kk, (p, _) in plans.items()),
              f"bcsr plans {label}: window index types")
        for dtype in (torch.float32, torch.float64):
            dt = str(dtype).replace("torch.", "")
            data, x = data32.to(dtype), x32.to(dtype)
            for idx, (plan, data_t) in plans.items():
                d_t = torch.as_tensor(data_t, device=dev).to(dtype)
                rel = torch.as_tensor(plan.rel, device=dev)
                args = (plan, d_t, rel)
                lib = idx == "int16"
                for per_block in ((False, True) if plan.dtab is not None
                                  else (False,)):
                    _compare(
                        records, "B12",
                        f"{label} {n} block rows b={b} K={k} {dt} {idx} rel"
                        f"{' per_block' if per_block else ''}",
                        lambda: ec.bcsr_matvec_cuda(*args, x,
                                                    per_block=per_block),
                        lambda: ec.bcsr_band_matvec_plain(*args, x),
                        timed=True, exact=True, shapes=True,
                        work=([d_t[..., :n], rel[:, :n], x],
                              2 * k * b * b * n, dt),
                        library=(_library_bcsr(data, cols,
                                               x.T.reshape(-1), True)
                                 if lib and not per_block else None))
                del d_t, rel
            rcols = torch.randint(0, n, (n, k), generator=gen,
                                  device=dev).to(torch.int32)
            xn = x.T.reshape(-1).contiguous()
            _compare(records, "B12g",
                     f"{label} {n} block rows b={b} K={k} {dt} absolute "
                     "columns, random numbering",
                     lambda: ec.bcsr_gather_matvec_cuda(data, rcols, xn),
                     lambda: ec.bcsr_gather_matvec_plain(data, rcols, xn),
                     timed=True,
                     work=([data, rcols, xn], 2 * k * b * b * n, dt),
                     library=_library_bcsr(data, rcols, xn, False))
            del rcols
            del data, x
        del data32, cols, x32, plans
        torch.cuda.empty_cache()
    check(records["B12"]["max_abs_err"] == 0
          and records["B12g"]["max_abs_err"] == 0,
          "B12: an output differs from its plain version's bits")


def _run_path(name, counters, records, drive, must_launch):
    """Drive one path with every launch count at 0 just before it; read
    the counts just after, check that the path's kernels launched, and
    then run what ``drive`` returned (timing that must not count)."""
    import torch

    torch.cuda.synchronize()
    for fn, attr in counters.values():
        setattr(fn, attr, 0)
    t0 = time.perf_counter()
    after = drive()
    torch.cuda.synchronize()
    launches = {key: getattr(fn, attr)
                for key, (fn, attr) in counters.items()}
    print(f"# {name} launches ({time.perf_counter() - t0:.1f} s): "
          + json.dumps(launches))
    for key in must_launch:
        check(launches[key] > 0, f"{key} was never launched on the "
                                 f"{name} path")
    for key, count in launches.items():
        _record(records, key)["launches"] += count
    if after is not None:
        after()


def _per_iteration(name, pcg10, iters=10, reps=5, solver="pcg"):
    """Per iteration of a 10-iteration run of ``solver`` (``iters``: the
    run's iterations): the time as issued (CUDA events around the run; host
    launch overhead included), the device busy time (the run's kernel
    durations summed, torch.profiler) and the kernel launches.  Events with
    the stream queued ahead would overstate the device time of a run with
    more launches than the launch queue holds."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from tpufem_torch.utils.timing import cuda_ms

    iter_ms = cuda_ms(pcg10, reps=reps, queue_ahead=False) / iters
    queued_ms = cuda_ms(pcg10, reps=reps) / iters
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        pcg10()
        torch.cuda.synchronize()
    kernels = sorted((e for e in prof.key_averages()
                      if e.device_type.name == "CUDA"),
                     key=lambda e: -e.self_device_time_total)
    busy_us = sum(e.self_device_time_total for e in kernels)
    busy_ms = busy_us / 1e3 / iters
    launches = sum(e.count for e in kernels) / iters
    print(f"# {name} {solver}: {iter_ms:.4f} ms/iteration as issued, "
          f"{busy_ms:.4f} ms/iteration device busy, device idle share "
          f"{1.0 - busy_ms / iter_ms:.3f}, {launches:.1f} kernel launches "
          f"per iteration (CUDA events; torch.profiler); events with the "
          f"stream queued ahead {queued_ms:.4f} ms/iteration")
    # device time by kernel (the same profiled run), largest first
    for e in kernels:
        print(f"# {name} {solver} kernel: "
              f"{e.self_device_time_total / busy_us:6.1%}"
              f" {e.self_device_time_total / 1e3 / iters:.4f} ms/iteration "
              f"{e.count / iters:6.1f} launches/iteration  {e.key[:90]}")


def _rel_err(u, ue):
    import torch

    return (torch.linalg.vector_norm(u.double() - ue)
            / torch.linalg.vector_norm(ue)).item()


def _relres(r, b):
    import torch

    return (torch.linalg.vector_norm(r) / torch.linalg.vector_norm(b)).item()


def _paths(dev, records):
    import numpy as np
    import torch

    from tpufem_torch.fem.quadrature import tetrahedron_rule
    from tpufem_torch.ops.fused_system_cuda import (
        build_poisson_system, node_coords_embedded_from_grid)
    from tpufem_torch.ops.stencil_cuda import (stencil_matvec_dot_embedded,
                                               stencil_matvec_embedded)
    from tpufem_torch.solve import multigrid as mg
    from tpufem_torch.solve.cg import cg, cg_fixed
    from tpufem_torch.solve.poisson import (model_problem_3d,
                                            model_problem_3d_planes)
    from tpufem_torch.solve.refine import refined_stencil_solve
    from tpufem_torch.solve.structured_fast import solve_poisson_fast
    from tpufem_torch.utils.timing import PhaseTimer

    counters = _counters()
    n = N_MAIN
    f = model_problem_3d_planes()
    _, exact = model_problem_3d()
    torch.cuda.reset_peak_memory_stats()

    def system(n):
        """(plan, bc grid, coords, fused-build A, b) at n cells a side."""
        info, coords, bc = mg._light_grid(DOMAIN, n)
        plan = _plan(n)
        C = torch.as_tensor(node_coords_embedded_from_grid(
            coords, plan, np.float32), device=dev)
        A, b = build_poisson_system(plan, C, f, tetrahedron_rule(2))
        return plan, bc, coords, A, b

    def solvers(plan, A):
        return (lambda v: stencil_matvec_embedded(A.data, v, plan),
                lambda v: stencil_matvec_dot_embedded(A.data, v, plan))

    relres, rel_err = _relres, _rel_err
    main = {}

    def drive_main():
        timer = PhaseTimer()
        with timer("host_setup"):
            info, coords, bc = mg._light_grid(DOMAIN, n)
            plan = _plan(n)
            C = torch.as_tensor(node_coords_embedded_from_grid(
                coords, plan, np.float32), device=dev)
            torch.cuda.synchronize()
        with timer("assemble"):
            A, b = build_poisson_system(plan, C, f, tetrahedron_rule(2))
            torch.cuda.synchronize()
        with timer("hierarchy"):
            levels = mg.build_poisson_multigrid(
                DOMAIN, n, dtype=torch.float32, operator="const", device=dev)
            M = mg.mg_preconditioner(levels, nu1=1, nu2=1)
            M_dot = mg.mg_preconditioner(levels, nu1=1, nu2=1,
                                         with_dot=True)
            torch.cuda.synchronize()
        check(len(levels) == 5 and levels[-1].coarse_inverse is not None
              and levels[-1].coarse_inverse.shape == (343, 343),
              "hierarchy: expected 5 levels with a 343-node dense inverse")
        mv, mvd = solvers(plan, A)

        def pcg10():
            return cg_fixed(mv, b, 10, M=M, matvec_dot=mvd, M_dot=M_dot)

        with timer("pcg_10_iters"):
            x, r = pcg10()
            torch.cuda.synchronize()
        rr = relres(r, b)
        print(f"# main pcg: 10 iterations relres {rr:.3e}")
        check(rr < 1e-5, f"10-iteration relres {rr:.3e} >= 1e-5")

        ue = torch.as_tensor(exact(coords.reshape(3, -1).T), device=dev)
        err = rel_err(plan.extract_field(x), ue)
        print(f"# main rel L2 error vs exact: {err:.4e}")
        check(err <= 2.0e-4, f"rel L2 error {err:.3e} > 2.0e-4")

        with timer("solve_poisson_fast"):
            sol = solve_poisson_fast(DOMAIN, n, f, tol=1e-5, device=dev)
        print(f"# main guarded solve: {sol.cg.iterations} iterations, "
              f"relres {sol.cg.residual_norm.item():.3e}, phases "
              f"{sol.phases_s}, rel L2 error {rel_err(sol.u, ue):.4e}")
        check(sol.cg.converged and sol.cg.iterations <= 12,
              f"guarded cg: {sol.cg.iterations} iterations, converged "
              f"{sol.cg.converged}")

        with timer("refine_to_1e-8"):
            raw64 = mg._apply_bc_numpy(
                mg._uniform_stencil_data(plan, mg._uniform_cell_stiffness(
                    DOMAIN, n)), plan.offsets,
                mg._embed_grid_numpy(bc, plan.store_grid, fill=False))
            data64 = torch.as_tensor(raw64, device=dev)
            del raw64
            res = refined_stencil_solve(
                A.data, data64, plan.offsets, b.double(), M, tol=1e-8,
                inner_iters=12, max_outer=6, matvec32=mv, matvec_dot32=mvd,
                M_dot=M_dot)
            torch.cuda.synchronize()
        print(f"# main refinement: relres {res.residual_norm:.3e} in "
              f"{res.outer_iterations} outer steps")
        check(res.residual_norm <= 1e-8 and res.outer_iterations <= 3,
              f"refinement: {res.residual_norm:.3e} after "
              f"{res.outer_iterations} outer steps")
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        print("# main phases (s, wall clock ending in a synchronize): "
              + json.dumps({k: round(v, 4)
                            for k, v in timer.report().items()}))
        print(f"# main peak device memory: {peak_gb:.3f} GB "
              "(torch.cuda.max_memory_allocated)")
        main.update(plan=plan, bc=bc, coords=coords, A=A, b=b, ue=ue)
        return lambda: _per_iteration("main", pcg10)

    _run_path("main", counters, records, drive_main,
              ("K1", "K2", "K3", "K4"))
    plan, A, b = main["plan"], main["A"], main["b"]
    mv, mvd = solvers(plan, A)

    def drive_general():
        bc_mask = torch.as_tensor(mg._embed_grid_numpy(
            main["bc"], plan.store_grid, fill=False), device=dev)
        levels = mg.build_poisson_multigrid(
            DOMAIN, n, dtype=torch.float32, top=(A.data, bc_mask),
            device=dev)
        check(len(levels) == 5 and isinstance(levels[0], mg.MGLevel)
              and levels[0].data.data_ptr() == A.data.data_ptr(),
              "general hierarchy: 5 levels sharing the built operator")
        M = mg.mg_preconditioner(levels, nu1=1, nu2=1)
        M_dot = mg.mg_preconditioner(levels, nu1=1, nu2=1, with_dot=True)

        def pcg10():
            return cg_fixed(mv, b, 10, M=M, matvec_dot=mvd, M_dot=M_dot)

        _, r = pcg10()
        rr = relres(r, b)
        print(f"# general pcg: 10 iterations relres {rr:.3e}")
        check(rr < 1e-5, f"general: 10-iteration relres {rr:.3e} >= 1e-5")
        its = _fp32_bf16_counts("general", levels, mv, mvd, b)
        check(its["bf16"] <= its["fp32"] + 2,
              f"general: bf16 {its['bf16']} > fp32 {its['fp32']} + 2")
        check(A.data.dtype == torch.float32 and levels[0].data is A.data,
              "cast_hierarchy touched the shared operator")
        return lambda: _per_iteration("general", pcg10)

    _run_path("general", counters, records, drive_general, ("B4",))

    def drive_dirichlet():
        def lin(x, y, z):
            return x + 2.0 * y + 3.0 * z

        t0 = time.perf_counter()
        sol = solve_poisson_fast(DOMAIN, n, f, precond="general", g=lin,
                                 tol=1e-5, device=dev)
        wall = time.perf_counter() - t0
        xyz = main["coords"].reshape(3, -1)
        err = rel_err(sol.u, main["ue"] + torch.as_tensor(lin(*xyz),
                                                          device=dev))
        print(f"# dirichlet solve: {sol.cg.iterations} iterations, relres "
              f"{sol.cg.residual_norm.item():.3e}, rel L2 error vs u + L "
              f"{err:.4e}, phases {sol.phases_s}, wall {wall:.4f} s")
        check(sol.cg.converged, "dirichlet: not converged")
        check(err <= 2.0e-4, f"dirichlet: rel L2 error {err:.3e} > 2.0e-4")

    _run_path("dirichlet", counters, records, drive_dirichlet,
              ("K1", "K2", "B4"))

    def drive_nu2():
        levels = mg.build_poisson_multigrid(
            DOMAIN, n, dtype=torch.float32, operator="const", device=dev)
        res = cg(mv, b, tol=1e-5, maxiter=60, check_every=1,
                 M=mg.mg_preconditioner(levels), matvec_dot=mvd,
                 M_dot=mg.mg_preconditioner(levels, with_dot=True))
        print(f"# nu2 guarded cg (nu1 = nu2 = 2): {res.iterations} "
              f"iterations, relres {res.residual_norm.item():.3e}")
        check(res.converged and res.iterations <= 12,
              f"nu2: {res.iterations} iterations, converged "
              f"{res.converged}")

    _run_path("nu2", counters, records, drive_nu2, ("B5", "K3", "K4"))

    def drive_jacobi():
        plan64, bc64, _, A64, b64 = system(N_JACOBI)
        mv64, mvd64 = solvers(plan64, A64)
        bc_mask = torch.as_tensor(mg._embed_grid_numpy(
            bc64, plan64.store_grid, fill=False), device=dev)
        for op, top in (("const", None), ("general", (A64.data, bc_mask))):
            levels = mg.build_poisson_multigrid(
                DOMAIN, N_JACOBI, dtype=torch.float32, levels=2,
                operator=op, top=top, device=dev)
            check(len(levels) == 2 and levels[-1].coarse_inverse is None,
                  f"jacobi {op}: expected 2 levels and no dense inverse")
            res = cg(mv64, b64, tol=1e-5, maxiter=200, check_every=1,
                     M=mg.mg_preconditioner(levels, nu1=1, nu2=1),
                     matvec_dot=mvd64,
                     M_dot=mg.mg_preconditioner(levels, nu1=1, nu2=1,
                                                with_dot=True))
            print(f"# jacobi {op} levels (coarsest 33^3, 20 sweeps): "
                  f"{res.iterations} iterations, relres "
                  f"{res.residual_norm.item():.3e}")
            check(res.converged, f"jacobi {op}: not converged")

    _run_path("jacobi", counters, records, drive_jacobi, ("B4", "B5"))

    _run_path("2d", counters, records, lambda: _drive_2d(dev),
              ("B7", "K2", "B4", "B5"))
    _run_path("2d_dirichlet", counters, records,
              lambda: _drive_2d_dirichlet(dev), ("B7", "K2", "B5"))
    _run_path("scale", counters, records, lambda: _drive_scale(dev),
              ("K1", "B3", "B5b", "K3", "K4", "B4"))
    keep = {}
    _run_path("unstructured", counters, records,
              lambda: _drive_unstructured(dev, keep), ("B9", "B9g", "B10"))
    _run_path("unstructured_amg", counters, records,
              lambda: _drive_unstructured_amg(dev, records, keep),
              ("B9", "B10"))
    _run_path("ell_small", counters, records, lambda: _drive_ell_small(dev),
              ("B9", "B9g"))
    _run_path("elasticity", counters, records,
              lambda: _drive_elasticity(dev), ("B12", "B12g"))
    _run_path("elasticity_3d", counters, records,
              lambda: _drive_elasticity_3d(dev), ("B12", "B12g"))
    _run_path("elasticity_small", counters, records,
              lambda: _drive_elasticity_small(dev), ("B12", "B12g"))
    _run_path("elasticity_amg", counters, records,
              lambda: _drive_elasticity_amg(dev, records), ("B12",))
    _run_path("elasticity_3d_amg", counters, records,
              lambda: _drive_elasticity_3d_amg(dev, records), ("B12",))
    _run_path("elasticity_box", counters, records,
              lambda: _drive_elasticity_box(dev), ())
    _run_path("weakform", counters, records, lambda: _drive_weakform(dev),
              ("B9", "B9g"))
    _run_path("p2", counters, records, lambda: _drive_p2(dev, records),
              ("B9", "B9g"))
    _run_path("p2_tet_robin", counters, records,
              lambda: _drive_p2_tet_robin(dev, records), ("B9",))
    _run_path("quad_hex", counters, records,
              lambda: _drive_quad_hex(dev, records), ("B9", "B9g"))
    _run_path("nonlinear", counters, records, _drive_nonlinear, ("B9",))
    _run_path("nonlinear_amg", counters, records,
              lambda: _drive_nonlinear_amg(dev, records), ("B9",))
    _run_path("wave", counters, records, lambda: _drive_wave(dev), ("B9",))
    _run_path("modal", counters, records,
              lambda: _drive_modal(dev, records), ("B10", "B10g"))
    _run_path("modal_serial", counters, records,
              _drive_modal_serial, ("B9", "B10g"))
    _run_path("coo_matfree", counters, records,
              lambda: _drive_coo_matfree(dev, records, keep), ("B9",))
    _run_path("stokes", counters, records,
              lambda: _drive_stokes(dev, records), ("B9",))
    _run_path("stokes_small", counters, records, _drive_stokes_small,
              ("B9",))
    _run_path("assembly", counters, records,
              lambda: _drive_assembly(dev, main), ("B13", "K2", "B4"))
    _run_path("reduction", counters, records,
              lambda: _drive_reduction(dev), ("B14",))
    _run_path("saxpy", counters, records, _drive_saxpy, ("B15",))
    _run_path("dist_assembly", counters, records,
              lambda: _drive_dist_assembly(dev), ("B8", "K1", "K2"))
    _run_path("dist_mg", counters, records, lambda: _drive_dist_mg(dev), ())
    _run_path("dryrun", counters, records, lambda: _drive_dryrun(dev),
              ("B8",))
    _example_paths(counters, records)


def _fp32_bf16_counts(name, levels, mv, mvd, b):
    """Guarded cg (check_every=1) to 1e-5 on a general hierarchy and on its
    bf16 cast: {"fp32": iterations, "bf16": iterations}."""
    import torch

    from tpufem_torch.solve import multigrid as mg
    from tpufem_torch.solve.cg import cg

    its = {}
    for dname, lv in (("fp32", levels),
                      ("bf16", mg.cast_hierarchy(levels, torch.bfloat16))):
        res = cg(mv, b, tol=1e-5, maxiter=60, check_every=1,
                 M=mg.mg_preconditioner(lv, nu1=1, nu2=1), matvec_dot=mvd,
                 M_dot=mg.mg_preconditioner(lv, nu1=1, nu2=1,
                                            with_dot=True))
        its[dname] = res.iterations
        print(f"# {name} guarded cg, {dname} hierarchy: {res.iterations} "
              f"iterations, relres {res.residual_norm.item():.3e}")
        check(res.converged, f"{name} {dname}: not converged")
    return its


def _drive_2d(dev):
    """solve_poisson_fast(dim=2) at n=1024, const and general; the general
    hierarchy over B7's operator in fp32 and bf16."""
    import numpy as np
    import torch

    from tpufem_torch.fem.quadrature import triangle_rule
    from tpufem_torch.ops.fused_system_cuda import (
        build_poisson_system, node_coords_embedded_from_grid)
    from tpufem_torch.ops.stencil_cuda import (stencil_matvec_dot_embedded,
                                               stencil_matvec_embedded)
    from tpufem_torch.solve import multigrid as mg
    from tpufem_torch.solve.cg import cg_fixed
    from tpufem_torch.solve.poisson import (model_problem_2d,
                                            model_problem_2d_planes)
    from tpufem_torch.solve.structured_fast import solve_poisson_fast

    n, f = N_2D, model_problem_2d_planes()
    _, coords, bc = mg._light_grid(DOMAIN, n, 2)
    ue = torch.as_tensor(model_problem_2d()[1](coords.reshape(2, -1).T),
                         device=dev)
    for precond in ("const", "general"):
        t0 = time.perf_counter()
        sol = solve_poisson_fast(DOMAIN, n, f, dim=2, tol=1e-5,
                                 precond=precond, device=dev)
        wall = time.perf_counter() - t0
        err = _rel_err(sol.u, ue)
        print(f"# 2d {precond} guarded solve: {sol.cg.iterations} "
              f"iterations, relres {sol.cg.residual_norm.item():.3e}, rel "
              f"L2 error {err:.4e}, DOFs {sol.num_dofs}, phases "
              f"{sol.phases_s}, wall {wall:.4f} s")
        check(sol.num_dofs == (n + 1) ** 2, "2d: DOF count")
        check(sol.cg.converged and sol.cg.iterations <= 8,
              f"2d {precond}: {sol.cg.iterations} iterations")
        check(err <= 2.2e-3, f"2d {precond}: rel L2 error {err:.3e}")

    plan = _plan(n, 2)
    C = torch.as_tensor(node_coords_embedded_from_grid(
        coords, plan, np.float32), device=dev)
    A, b = build_poisson_system(plan, C, f, triangle_rule(2))
    mv = lambda v: stencil_matvec_embedded(A.data, v, plan)
    mvd = lambda v: stencil_matvec_dot_embedded(A.data, v, plan)
    bc_mask = torch.as_tensor(mg._embed_grid_numpy(
        bc, plan.store_grid, fill=False), device=dev)
    general = mg.build_poisson_multigrid(DOMAIN, n, 2, top=(A.data, bc_mask),
                                         device=dev)
    its = _fp32_bf16_counts("2d general", general, mv, mvd, b)
    check(its["bf16"] <= its["fp32"] + 2,
          f"2d: bf16 {its['bf16']} > fp32 {its['fp32']} + 2")
    levels = mg.build_poisson_multigrid(DOMAIN, n, 2, operator="const",
                                        device=dev)
    M = mg.mg_preconditioner(levels, nu1=1, nu2=1)
    M_dot = mg.mg_preconditioner(levels, nu1=1, nu2=1, with_dot=True)

    def pcg10():
        return cg_fixed(mv, b, 10, M=M, matvec_dot=mvd, M_dot=M_dot)

    _, r = pcg10()
    print(f"# 2d pcg: 10 iterations relres {_relres(r, b):.3e}")
    return lambda: _per_iteration("2d", pcg10)


def _drive_2d_dirichlet(dev):
    """f = 0, g = 1 + 2x - 3y on the 2D box at n=1024 in fp64: P1
    reproduces the harmonic g."""
    import torch

    from tpufem_torch.solve import multigrid as mg
    from tpufem_torch.solve.structured_fast import solve_poisson_fast

    def g(x, y):
        return 1.0 + 2.0 * x - 3.0 * y

    t0 = time.perf_counter()
    sol = solve_poisson_fast(DOMAIN, N_2D, _rhs_2d_zero(), dim=2, g=g,
                             tol=1e-11, maxiter=200, dtype=torch.float64,
                             device=dev)
    wall = time.perf_counter() - t0
    _, coords, _ = mg._light_grid(DOMAIN, N_2D, 2)
    err = (sol.u - torch.as_tensor(g(*coords).reshape(-1),
                                   device=dev)).abs().max().item()
    print(f"# 2d_dirichlet solve (fp64): {sol.cg.iterations} iterations, "
          f"relres {sol.cg.residual_norm.item():.3e}, max error vs g "
          f"{err:.3e}, phases {sol.phases_s}, wall {wall:.4f} s")
    check(sol.cg.converged and err < 1e-8,
          f"2d_dirichlet: max error {err:.3e}, converged {sol.cg.converged}")


def _drive_scale(dev):
    """n=384 through the entry point: solve_poisson_fast with the const
    hierarchy and with precond="general", each with its phases, wall and
    peak device memory; then, composed by hand on one fused build, the
    const hierarchy with nu1 = nu2 = 2 (the entry runs nu = 1) and the
    10-iteration run that the per-iteration times read."""
    import numpy as np
    import torch

    from tpufem_torch.fem.quadrature import tetrahedron_rule
    from tpufem_torch.ops.fused_system_cuda import (
        build_poisson_system, node_coords_embedded_from_grid)
    from tpufem_torch.ops.stencil_cuda import (stencil_matvec_dot_embedded,
                                               stencil_matvec_embedded)
    from tpufem_torch.solve import multigrid as mg
    from tpufem_torch.solve.cg import cg, cg_fixed
    from tpufem_torch.solve.poisson import (model_problem_3d,
                                            model_problem_3d_planes)
    from tpufem_torch.solve.structured_fast import solve_poisson_fast

    n, f = N_SCALE, model_problem_3d_planes()
    t0 = time.perf_counter()
    _, coords, _ = mg._light_grid(DOMAIN, n)
    ue = torch.as_tensor(model_problem_3d()[1](coords.reshape(3, -1).T),
                         device=dev)
    del coords
    print(f"# scale exact solution on the host: "
          f"{time.perf_counter() - t0:.4f} s")
    for precond, limit in (("const", 12), ("general", 16)):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        sol = solve_poisson_fast(DOMAIN, n, f, tol=1e-5, precond=precond,
                                 device=dev)
        wall = time.perf_counter() - t0
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        err = _rel_err(sol.u, ue)
        print(f"# scale {precond} solve_poisson_fast: {sol.cg.iterations} "
              f"iterations, relres {sol.cg.residual_norm.item():.3e}, rel "
              f"L2 error {err:.4e} (TPU reference at n=384: 12 iterations, "
              f"1.1e-5; the FMA-contracted build: 12, "
              f"{FMA_BUILD_SCALE_ERR:.4e}), DOFs {sol.num_dofs}, phases {sol.phases_s}, wall "
              f"{wall:.4f} s, peak device memory {peak_gb:.3f} GB "
              f"(torch.cuda.max_memory_allocated)")
        check(sol.num_dofs == (n + 1) ** 3, "scale: DOF count")
        check(sol.cg.converged and sol.cg.iterations <= limit,
              f"scale {precond}: {sol.cg.iterations} iterations > {limit}")
        check(err <= 2.0e-4, f"scale {precond}: rel L2 error {err:.3e} > "
                             "2.0e-4")
        del sol
    del ue
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    _, coords, _ = mg._light_grid(DOMAIN, n)
    plan = _plan(n)
    C = torch.as_tensor(node_coords_embedded_from_grid(
        coords, plan, np.float32), device=dev)
    del coords
    A, b = build_poisson_system(plan, C, f, tetrahedron_rule(2))
    del C
    levels = mg.build_poisson_multigrid(DOMAIN, n, dtype=torch.float32,
                                        operator="const", device=dev)
    torch.cuda.synchronize()
    print(f"# scale build and const hierarchy by hand: "
          f"{time.perf_counter() - t0:.4f} s")
    mv = lambda v: stencil_matvec_embedded(A.data, v, plan)
    mvd = lambda v: stencil_matvec_dot_embedded(A.data, v, plan)
    res = cg(mv, b, tol=1e-5, maxiter=60, check_every=1,
             M=mg.mg_preconditioner(levels), matvec_dot=mvd,
             M_dot=mg.mg_preconditioner(levels, with_dot=True))
    print(f"# scale const nu1 = nu2 = 2: {res.iterations} iterations, "
          f"relres {res.residual_norm.item():.3e}")
    check(res.converged and res.iterations <= 12,
          f"scale nu2: {res.iterations} iterations > 12")
    del res
    rss_gb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
    print(f"# scale host peak RSS of the process {rss_gb:.2f} GB (getrusage)")
    M = mg.mg_preconditioner(levels, nu1=1, nu2=1)
    M_dot = mg.mg_preconditioner(levels, nu1=1, nu2=1, with_dot=True)

    def pcg10():
        return cg_fixed(mv, b, 10, M=M, matvec_dot=mvd, M_dot=M_dot)

    return lambda: _per_iteration("scale", pcg10)


def _drive_unstructured(dev, keep):
    """examples/unstructured_1m.py's default, composed from the port at full
    size; then the same solve through the entry point.  Keeps (A, b, the
    exact solution) in ``keep`` for the unstructured_amg path."""
    import numpy as np
    import torch

    from tpufem_torch.assemble.dense import assemble_vector
    from tpufem_torch.assemble.ell import ell_values_scatter
    from tpufem_torch.assemble.local import element_load, p1_stiffness
    from tpufem_torch.fem.elements import P1Triangle
    from tpufem_torch.fem.quadrature import triangle_rule
    from tpufem_torch.mesh.adjacency import ell_pattern, reverse_cuthill_mckee
    from tpufem_torch.mesh.core import Mesh
    from tpufem_torch.mesh.rectangle import perturbed_rectangle_mesh
    from tpufem_torch.solve.bc import apply_dirichlet_ell
    from tpufem_torch.solve.cg import cg, cg_fixed
    from tpufem_torch.solve.poisson import model_problem_2d, solve_poisson_ell
    from tpufem_torch.solve.precond import chebyshev, lambda_max_bound
    from tpufem_torch.sparse import ell_cuda
    from tpufem_torch.sparse.ell import ELLMatrix
    from tpufem_torch.utils.timing import PhaseTimer

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    f, exact = model_problem_2d()
    timer = PhaseTimer()
    with timer("host_mesh"):
        mesh0 = perturbed_rectangle_mesh(-3, 3, -3, 3, N_ELL, N_ELL,
                                         jitter=0.25, seed=0)
    with timer("rcm"):
        # RCM on the random numbering's pattern, then the mesh renumbered
        cols0 = ell_pattern(mesh0.conn, mesh0.num_nodes, pad_to=8,
                            with_sort_plan=False).cols
        perm = reverse_cuthill_mckee(cols0)
        inv = np.empty_like(perm)
        inv[perm] = np.arange(perm.size, dtype=perm.dtype)
        mesh = Mesh(coords=mesh0.coords[perm],
                    conn=inv[mesh0.conn].astype(np.int32),
                    node_flags=mesh0.node_flags[perm], cell_type="triangle")
        del cols0
    with timer("pattern"):
        pat = ell_pattern(mesh.conn, mesh.num_nodes, pad_to=8,
                          with_sort_plan=False)
    nn = mesh.num_nodes
    bw = int(np.abs(pat.cols.astype(np.int64)
                    - np.arange(nn)[:, None]).max())
    print(f"# unstructured: {nn} rows, {mesh.num_elements} elements, RCM "
          f"bandwidth {bw}, ELL width {pat.width}")
    check((nn, mesh.num_elements, bw, pat.width) == (
        ELL_ROWS, ELL_ELEMENTS, ELL_BANDWIDTH, ELL_SLOTS),
        f"unstructured: {nn} rows, {mesh.num_elements} elements, bandwidth "
        f"{bw}, width {pat.width}")
    el = P1Triangle()

    def assemble(ec):
        return (ell_values_scatter(pat.slots, p1_stiffness(ec, el), nn,
                                   pat.width),
                assemble_vector(mesh.conn, element_load(
                    ec, el, triangle_rule(5), f), nn))

    with timer("assemble"):
        ec = torch.as_tensor(mesh.element_coords(), dtype=torch.float32,
                             device=dev)
        data, b = assemble(ec)
        torch.cuda.synchronize()
    # golden: stiffness rows sum to 0; the sorted accumulation repeats
    # bit for bit
    row_sum = (data.sum(dim=1).abs().max() / data.abs().max()).item()
    again = assemble(ec)
    same = torch.equal(again[0], data) and torch.equal(again[1], b)
    del ec, again
    print(f"# unstructured assembly: max |row sum| / max |a_ij| "
          f"{row_sum:.3e}, a second assembly bit-identical: {same}")
    check(row_sum <= 1e-5 and same,
          f"unstructured assembly: row sums {row_sum:.3e}, repeatable {same}")
    with timer("bc"):
        A = ELLMatrix(data, torch.as_tensor(pat.cols, device=dev),
                      diag_pos=torch.as_tensor(pat.diag_pos, device=dev))
        A, b = apply_dirichlet_ell(A, b, torch.as_tensor(
            mesh.node_flags != 0, device=dev))
        torch.cuda.synchronize()
    with timer("plan"):
        A.resolve_band()
        torch.cuda.synchronize()
    plan = A._band[0]
    print(f"# unstructured plan: R={plan.block_rows}, NP={plan.np_rows}, "
          f"rel {plan.rel.dtype}, {len(plan.segments or ())} segments")
    check(plan.block_rows == 8192 and plan.rel.dtype.name == "int16",
          "unstructured: expected the R = 8192 int16 plan")
    with timer("precond"):
        lmax = lambda_max_bound(A)
        M = chebyshev(A.matvec, A.diagonal(), degree=14, lmax=lmax)
    before = ell_cuda.ell_matvec_cuda.launches
    with timer("solve"):
        res = cg(A.matvec, b, tol=1e-5, maxiter=3000, M=M, check_every=2)
        torch.cuda.synchronize()
    per_iter = (ell_cuda.ell_matvec_cuda.launches - before) / res.iterations
    ue = torch.as_tensor(exact(mesh.coords), device=dev)
    err = _rel_err(res.x, ue)
    print(f"# unstructured Chebyshev(14)-PCG: {res.iterations} iterations, "
          f"relres {res.residual_norm.item():.3e}, rel L2 error {err:.4e} "
          f"(TPU reference: 242-244 iterations, 1.0e-5), lmax bound "
          f"{lmax:.6g}, {per_iter:.2f} banded products per iteration")
    check(res.converged and res.iterations <= 260,
          f"unstructured: {res.iterations} iterations, converged "
          f"{res.converged}")
    check(err <= 2.0e-5, f"unstructured: rel L2 error {err:.3e} > 2.0e-5")
    check(13.5 <= per_iter <= 14.5,
          f"unstructured: {per_iter:.2f} banded products per iteration")

    # the polynomial on an [n, 3] block: 13 products of B10
    gen = torch.Generator(device=dev).manual_seed(7)
    R3 = torch.randn((nn, 3), generator=gen, device=dev)
    M_multi = chebyshev(A.matvec_multi, A.diagonal(), degree=14, lmax=lmax)
    Z3 = M_multi(R3)
    cols3 = torch.stack([M(R3[:, j].contiguous()) for j in range(3)], 1)
    err3 = ((Z3 - cols3).abs().max() / cols3.abs().max()).item()
    print(f"# unstructured Chebyshev on an [n, 3] block vs 3 single "
          f"applications: max rel difference {err3:.3e}")
    check(err3 <= 1e-6, f"unstructured: [n, 3] Chebyshev differs {err3:.3e}")
    del R3, Z3, cols3
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print("# unstructured phases (s, wall clock ending in a synchronize): "
          + json.dumps({kk: round(v, 4) for kk, v in timer.report().items()})
          + f"; peak device memory {peak_gb:.3f} GB "
          "(torch.cuda.max_memory_allocated)")

    t0 = time.perf_counter()
    sol = solve_poisson_ell(mesh0, precond="chebyshev", matvec="pallas",
                            dtype=torch.float32, tol=1e-5, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    err_e = _rel_err(sol.u, torch.as_tensor(exact(mesh0.coords),
                                            device=dev))
    print(f"# unstructured solve_poisson_ell(chebyshev, pallas, fp32): "
          f"{sol.cg.iterations} iterations, relres "
          f"{sol.cg.residual_norm.item():.3e}, rel L2 error {err_e:.4e}, "
          f"wall {wall:.2f} s (host pattern, RCM and plan included)")
    check(sol.cg.converged
          and abs(sol.cg.iterations - res.iterations) <= 2,
          f"unstructured entry: {sol.cg.iterations} iterations vs "
          f"{res.iterations} by hand")
    check(err_e <= 2.0e-5, f"unstructured entry: rel L2 error {err_e:.3e}")
    del sol

    def pcg10():
        return cg_fixed(A.matvec, b, 10, M=M)

    keep["unstructured"] = (A, b, ue, mesh0)
    keep["unstructured_mesh"] = mesh
    return lambda: _per_iteration("unstructured", pcg10)


def _drive_ell_small(dev):
    """The verify recipe's flagship at its own size, fp64 to 1e-10: the
    64 x 64 row-major mesh (the banded kernel) and a randomly numbered
    96 x 96 perturbed mesh (the gather form)."""
    from tpufem_torch.mesh.rectangle import (RectangleMesh,
                                             perturbed_rectangle_mesh)
    from tpufem_torch.solve.poisson import model_problem_2d, solve_poisson_ell
    from tpufem_torch.sparse import ell_cuda

    import torch

    exact = model_problem_2d()[1]
    for name, mesh, err_max, banded in (
            ("rect64", RectangleMesh(-3, 3, -3, 3, 64, 64), 2.1e-4, True),
            ("perturbed96", perturbed_rectangle_mesh(
                -3, 3, -3, 3, 96, 96, jitter=0.2, seed=1), 1.2e-4, False)):
        before = (ell_cuda.ell_matvec_cuda.launches,
                  ell_cuda.ell_gather_matvec_cuda.launches)
        t0 = time.perf_counter()
        sol = solve_poisson_ell(mesh, tol=1e-10, device=dev)
        wall = time.perf_counter() - t0
        band = ell_cuda.ell_matvec_cuda.launches - before[0]
        gather = ell_cuda.ell_gather_matvec_cuda.launches - before[1]
        err = _rel_err(sol.u, torch.as_tensor(exact(mesh.coords),
                                              device=dev))
        ref = JAX_ELL_SMALL_ITERS[name]
        print(f"# ell_small {name}: {sol.num_dofs} DOFs, "
              f"{sol.cg.iterations} iterations (JAX on the CPU: {ref}), "
              f"relres {sol.cg.residual_norm.item():.4e}, rel L2 error "
              f"{err:.4e}, banded launches {band}, gather launches {gather}, "
              f"wall {wall:.3f} s")
        # the 96 stop sits within 0.5% of the tolerance, where the order of
        # a row sum alone moves the count by one
        check(sol.cg.converged and abs(sol.cg.iterations - ref) <= 1,
              f"ell_small {name}: {sol.cg.iterations} iterations vs {ref}")
        check(err <= err_max, f"ell_small {name}: rel L2 error {err:.3e}")
        if banded:
            check(band >= sol.cg.iterations and gather == 1,
                  f"ell_small {name}: banded {band}, gather {gather}")
        else:
            check(band == 0 and gather > sol.cg.iterations,
                  f"ell_small {name}: banded {band}, gather {gather}")


N_ELAST = 700                   # mesh lines a side: 982,802 DOFs
ELAST_DOFS, ELAST_ELEMENTS = 982_802, 980_000
N_ELAST_3D = 40                 # box cells a side: 206,763 DOFs
ELAST_3D_DOFS = 206_763
# The example's maxiter is 3000 (the TPU reference took 2923 fp32
# iterations).  On the H100 the fp64 solve of the same system takes 3033
# (so exact-arithmetic CG already needs more than 3000), and the fp32 count
# moves with the last bits of the assembly: 3216 with element kernels
# summed by torch's reductions, 2953 with the left-to-right sums the weak
# form now uses.  The cap and the gate are 3300, above both fp32 counts and
# 9% above the fp64 one.
ELAST_MAXITER = 3300
# The gather branch iterates on the mesh's random numbering, whose fp32
# sums round differently: the cap leaves it room, the gate is convergence.
ELAST_GATHER_MAXITER = 4000
# The JAX package's own CPU iteration counts of the elasticity_small solves
# (float64, block-Jacobi, tol 1e-10; the same for matvec="gather" and
# "pallas" with interpret=True): solve_elasticity on
# perturbed_rectangle_mesh(-1, 1, -1, 1, 48, 48, jitter=0.2, seed=0) with
# f = (1, -0.5), and on box_mesh(-1, 1, -1, 1, -1, 1, 6, 6, 6) with
# f = (1, -0.5, 0.25), lam = mu = 1: 305 and 33 iterations.
JAX_ELAST_SMALL_ITERS = {"perturbed48": 305, "box6": 33}
# examples/poisson_2d.py's defaults (64 x 64, Jacobi, tol 1e-8) with the JAX
# package on the CPU in float64: 103 iterations, nodal rms error 8.568e-3.
JAX_WEAKFORM_ITERS, JAX_WEAKFORM_RMS = 103, 8.568e-3


def _body_force(dim):
    """The examples' body force (1, -0.5) as a torch callable; 3D adds
    0.25 along z."""
    import torch

    comps = (1.0, -0.5, 0.25)[:dim]

    def f(x):
        return torch.stack([0 * x[..., i] + c for i, c in enumerate(comps)],
                           dim=-1)

    return f


def _eliminated_rhs(mesh, dim, dtype, dev):
    """The eliminated right-hand side of the clamped body-force problem, as
    solve_elasticity builds it (the Dirichlet rows hold 0)."""
    import torch

    from tpufem_torch.assemble.dense import assemble_vector
    from tpufem_torch.fem.space import VectorFunctionSpace
    from tpufem_torch.solve.elasticity import elasticity_forms

    V = VectorFunctionSpace(mesh)
    wf = elasticity_forms(V, 1.0, 1.0, _body_force(dim))
    wf.dtype, wf.device = dtype, dev
    ec = torch.as_tensor(mesh.element_coords(), dtype=dtype, device=dev)
    b = assemble_vector(V.dof_conn, wf.element_vectors(ec), V.num_dofs)
    return torch.where(torch.as_tensor(V.dof_flags, device=dev), 0.0, b)


def _elasticity_pair(name, mesh, dev, precond="jacobi", **kw):
    """solve_elasticity(matvec="pallas", tol 1e-6, ``precond``: block-Jacobi
    or the block AMG) in fp32 and in fp64 on one mesh: gates convergence,
    B12 once per iteration plus the start (with AMG: more, the cycle's
    products), the fp64 solution's true relative residual (fp64, the
    unpermuted operator) <= 1e-5, the fp32 solution within 1e-4 of the fp64
    one, and the fp32 solution's own true relative residual within the
    drift limit.  Returns the fp32 solution.

    Why the fp32 solution is not held to 1e-5: rounding the fp64 solution
    to fp32 alone leaves a relative residual rr_round (about 3e-3 at
    982,802 DOFs: the stiffness amplifies the rounding's high-frequency
    part), and each of CG's k updates x += alpha p rounds x once more,
    which the recursive residual never sees.  Independent roundings add up
    as a random walk, so the true residual is about sqrt(k) rr_round
    (_drift_witness shows the gap growing so).  The limit is twice that:
    2 sqrt(k) rr_round."""
    import torch

    from tpufem_torch.solve.elasticity import solve_elasticity
    from tpufem_torch.sparse import ell_cuda

    sols = {}
    for dtype in (torch.float32, torch.float64):
        dt = str(dtype).replace("torch.", "")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        before = (ell_cuda.bcsr_matvec_cuda.launches,
                  ell_cuda.bcsr_gather_matvec_cuda.launches)
        t0 = time.perf_counter()
        by_b = dict(ell_cuda.bcsr_matvec_cuda.launches_by_block)
        sol = solve_elasticity(mesh, body_force=_body_force(mesh.dim),
                               dtype=dtype, tol=1e-6, matvec="pallas",
                               precond=precond, device=dev, **kw)
        wall = time.perf_counter() - t0
        band = ell_cuda.bcsr_matvec_cuda.launches - before[0]
        gather = ell_cuda.bcsr_gather_matvec_cuda.launches - before[1]
        by_b = {bb: c - by_b[bb] for bb, c in
                ell_cuda.bcsr_matvec_cuda.launches_by_block.items()
                if c > by_b[bb]}
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        its = sol.cg.iterations
        print(f"# {name} {dt} solve_elasticity(pallas, {precond}): "
              f"{sol.space.num_dofs} DOFs, {its} iterations, relres "
              f"{sol.cg.residual_norm.item():.4e}, B12 launches {band} "
              f"({band / max(its, 1):.4f} per iteration; by block size "
              f"{json.dumps(by_b)}), absolute-mode launches {gather}, phases "
              "(s, each ending in a synchronize) " + _walls_json(sol.walls)
              + f", wall {wall:.2f} s, peak device memory {peak_gb:.3f} GB "
              "(torch.cuda.max_memory_allocated)")
        check(sol.cg.converged, f"{name} {dt}: not converged in {its}")
        check(band == its + 1 if precond == "jacobi" else band > its + 1,
              f"{name} {dt}: {band} B12 launches for {its} iterations")
        sols[dt] = sol
    A64 = sols["float64"].A
    b64 = _eliminated_rhs(mesh, mesh.dim, torch.float64, dev)

    def true_relres(u):
        r = b64 - ell_cuda.bcsr_gather_matvec_cuda(A64.data, A64.cols,
                                                   u.double())
        return (torch.linalg.vector_norm(r)
                / torch.linalg.vector_norm(b64)).item()

    u32, u64 = sols["float32"].u, sols["float64"].u
    rr64, rr32, rr_round = (true_relres(u64), true_relres(u32),
                            true_relres(u64.float()))
    du = (torch.linalg.vector_norm(u32.double() - u64)
          / torch.linalg.vector_norm(u64)).item()
    its32 = sols["float32"].cg.iterations
    drift_max = 2.0 * math.sqrt(its32) * rr_round
    print(f"# {name} true relres in fp64 (the unpermuted operator): fp64 "
          f"solution {rr64:.4e}, fp32 solution {rr32:.4e} (limit 2 sqrt("
          f"{its32}) x rounded = {drift_max:.4e}; sqrt(k) x rounded "
          f"{rr_round * math.sqrt(its32):.4e}), fp64 solution rounded to "
          f"fp32 {rr_round:.4e}; ||u32 - u64|| / ||u64|| {du:.4e}")
    check(rr64 <= 1e-5, f"{name}: fp64 true relres {rr64:.3e} > 1e-5")
    check(du <= 1e-4, f"{name}: fp32 solution {du:.3e} from the fp64 one")
    check(rr32 <= drift_max, f"{name}: fp32 true relres {rr32:.3e} > "
                             f"{drift_max:.3e}")
    return sols["float32"]


def _drift_witness(name, sol, mesh, mv, M, perm, dev):
    """Where the fp32 solution's true residual comes from.  cg_fixed runs
    cg's recurrence step for step (the same operations, so k = its gives
    the solve's iterate) from 0 for k = its/8, its/4, its/2 and its steps;
    at each k: the recursive residual r_k, the true one b - A x_k (the fp32
    operator and iterate, evaluated in fp64) and the gap between them.  If
    the roundings of the x updates add up as a random walk, gap / sqrt(k)
    stays about constant."""
    import torch

    from tpufem_torch.solve.cg import cg_fixed
    from tpufem_torch.sparse import ell_cuda

    A, nb, its = sol.A, sol.A.block_size, sol.cg.iterations
    b = _eliminated_rhs(mesh, mesh.dim, A.dtype, dev)
    perm_t = torch.as_tensor(perm, device=dev)
    inv_t = torch.empty_like(perm_t)
    inv_t[perm_t] = torch.arange(perm_t.numel(), device=dev)
    b_cm = b.reshape(-1, nb)[perm_t].T.contiguous()
    b64, data64 = b.double(), A.data.double()
    b_norm = torch.linalg.vector_norm(b64)
    for k in sorted({max(1, its // 8), max(1, its // 4), max(1, its // 2),
                     its}):
        x, r = cg_fixed(mv, b_cm, k, M=M)
        u = x.T[inv_t].reshape(-1)
        r_true = b64 - ell_cuda.bcsr_gather_matvec_cuda(data64, A.cols,
                                                        u.double())
        r_rec = r.T[inv_t].reshape(-1).double()
        rec, true, gap = (
            (torch.linalg.vector_norm(v) / b_norm).item()
            for v in (r_rec, r_true, r_true - r_rec))
        print(f"# {name} drift witness, fp32, k = {k}: recursive relres "
              f"{rec:.4e}, true relres {true:.4e} (fp64, the fp32 "
              f"operator), gap {gap:.4e}, gap / sqrt(k) "
              f"{gap / math.sqrt(k):.4e}"
              + (f"; x_k equals the solve's iterate: {torch.equal(u, sol.u)}"
                 if k == its else ""))


def _drive_elasticity(dev):
    """examples/elasticity_unstructured.py --precond jacobi at full width
    (982,802 DOFs), fp32 with its fp64 twin; then matvec="gather" on the
    mesh's random numbering (B12's absolute-column mode)."""
    import torch

    from tpufem_torch.mesh.rectangle import perturbed_rectangle_mesh
    from tpufem_torch.solve.elasticity import solve_elasticity
    from tpufem_torch.sparse import ell_cuda

    t0 = time.perf_counter()
    mesh = perturbed_rectangle_mesh(-1.0, 1.0, -1.0, 1.0, N_ELAST, N_ELAST,
                                    jitter=0.2, seed=0)
    print(f"# elasticity mesh: {2 * mesh.num_nodes} DOFs, "
          f"{mesh.num_elements} triangles, {time.perf_counter() - t0:.4f} s")
    check((2 * mesh.num_nodes, mesh.num_elements) == (ELAST_DOFS,
                                                      ELAST_ELEMENTS),
          "elasticity: mesh size")
    sol = _elasticity_pair("elasticity", mesh, dev, maxiter=ELAST_MAXITER)
    its = sol.cg.iterations
    check(its <= ELAST_MAXITER, f"elasticity: {its} iterations")

    before = (ell_cuda.bcsr_matvec_cuda.launches,
              ell_cuda.bcsr_gather_matvec_cuda.launches)
    t0 = time.perf_counter()
    solg = solve_elasticity(mesh, body_force=_body_force(2),
                            dtype=torch.float32, tol=1e-6,
                            maxiter=ELAST_GATHER_MAXITER, matvec="gather",
                            precond="jacobi", device=dev)
    wall = time.perf_counter() - t0
    du = (torch.linalg.vector_norm(solg.u - sol.u)
          / torch.linalg.vector_norm(sol.u)).item()
    print(f"# elasticity fp32 solve_elasticity(gather, jacobi): "
          f"{solg.cg.iterations} iterations, relres "
          f"{solg.cg.residual_norm.item():.4e}, B12 banded launches "
          f"{ell_cuda.bcsr_matvec_cuda.launches - before[0]}, absolute-mode "
          f"launches {ell_cuda.bcsr_gather_matvec_cuda.launches - before[1]}"
          f", phases " + json.dumps({k: round(v, 4)
                                     for k, v in solg.walls.items()})
          + f", wall {wall:.2f} s; ||u_gather - u_pallas|| / ||u_pallas|| "
          f"{du:.4e}")
    check(solg.cg.converged, "elasticity gather: not converged")
    after = _after_elasticity("elasticity", sol, mesh, 1024, dev)

    def after_both():
        after()
        _gather_per_iteration("elasticity gather", solg.A, dev)

    return after_both


def _gather_per_iteration(name, A, dev):
    """The per-iteration numbers of the gather form: 10 fixed iterations of
    block-Jacobi PCG on the node-major operator (B12g once per iteration),
    a random rhs."""
    import torch

    from tpufem_torch.solve.cg import cg_fixed
    from tpufem_torch.solve.precond import block_jacobi

    M = block_jacobi(A.diagonal_blocks())
    gen = torch.Generator(device=dev).manual_seed(9)
    b = torch.randn(A.shape[0], generator=gen, device=dev, dtype=A.dtype)
    _per_iteration(name, lambda: cg_fixed(A.matvec, b, 10, M=M))


def _after_elasticity(name, sol, mesh, block_rows, dev):
    """() -> on the solved fp32 system's pallas operator: the drift witness,
    then the per-iteration numbers (10 fixed iterations of block-Jacobi
    PCG, a random rhs)."""
    import torch

    from tpufem_torch.solve.cg import cg_fixed
    from tpufem_torch.solve.elasticity import banded_block_system

    def after():
        mv, M, perm = banded_block_system(sol.A, sol.A.cols.cpu().numpy(),
                                          block_rows=block_rows)
        _drift_witness(name, sol, mesh, mv, M, perm, dev)
        gen = torch.Generator(device=dev).manual_seed(9)
        b_cm = torch.randn((sol.A.block_size, sol.A.data.shape[0]),
                           generator=gen, device=dev, dtype=sol.A.dtype)
        _per_iteration(name, lambda: cg_fixed(mv, b_cm, 10, M=M))

    return after


def _drive_elasticity_3d(dev):
    """The n = 40 box (206,763 DOFs), fp32 with its fp64 twin, block_rows
    4096: B12 with b = 3."""
    from tpufem_torch.mesh.box import box_mesh

    mesh = box_mesh(-1, 1, -1, 1, -1, 1, N_ELAST_3D, N_ELAST_3D, N_ELAST_3D)
    check(3 * mesh.num_nodes == ELAST_3D_DOFS, "elasticity_3d: DOF count")
    sol = _elasticity_pair("elasticity_3d", mesh, dev, maxiter=3000,
                           block_rows=4096)
    return _after_elasticity("elasticity_3d", sol, mesh, 4096, dev)


def _drive_elasticity_small(dev):
    """fp64 to 1e-10 on the 48 x 48 perturbed mesh and the 6^3 box, both
    matvec branches: the JAX package's CPU counts, the two solutions within
    1e-8."""
    import torch

    from tpufem_torch.mesh.box import box_mesh
    from tpufem_torch.mesh.rectangle import perturbed_rectangle_mesh
    from tpufem_torch.solve.elasticity import solve_elasticity

    for name, mesh in (("perturbed48", perturbed_rectangle_mesh(
            -1, 1, -1, 1, 48, 48, jitter=0.2, seed=0)),
                       ("box6", box_mesh(-1, 1, -1, 1, -1, 1, 6, 6, 6))):
        us = {}
        for matvec in ("pallas", "gather"):
            sol = solve_elasticity(mesh, body_force=_body_force(mesh.dim),
                                   tol=1e-10, matvec=matvec, device=dev)
            ref = JAX_ELAST_SMALL_ITERS[name]
            print(f"# elasticity_small {name} {matvec}: {sol.space.num_dofs}"
                  f" DOFs, {sol.cg.iterations} iterations (JAX on the CPU: "
                  f"{ref}), relres {sol.cg.residual_norm.item():.4e}")
            check(sol.cg.converged and sol.cg.iterations == ref,
                  f"elasticity_small {name} {matvec}: {sol.cg.iterations} "
                  f"iterations vs {ref}")
            us[matvec] = sol.u
        du = ((us["pallas"] - us["gather"]).abs().max()
              / us["gather"].abs().max()).item()
        check(du <= 1e-8, f"elasticity_small {name}: branches differ {du:.3e}")
        del us
    torch.cuda.empty_cache()


def _walls_json(walls):
    """A solve's phase walls (and the AMG setup's detail) as JSON."""
    def rounded(v):
        if isinstance(v, dict):
            return {k: rounded(x) for k, x in v.items()}
        return round(v, 4) if isinstance(v, float) else v

    return json.dumps(rounded(walls))


# The AMG paths.  BENCH_NOTES.md F1 (the TPU's block AMG on the 982,802-DOF
# system: 33 fp32 iterations, a coarsest of 273 rows) and F4 (its
# scalar AMG on the 1,002,001-row system: 26 iterations, hierarchy
# [1002001, 166046, 20629, 2654] + 452) are counts, not times;
# the gates leave room for fp32 counts that move between machines.
ELAST_AMG_MAXITER = 40
UNSTR_AMG_MAXITER = 30
F1_ITERS, F1_COARSE = 33, 273
F4_ITERS, F4_LEVELS = 26, "[1002001, 166046, 20629, 2654] + 452"


def _print_hierarchy(name, detail, setup_s):
    print(f"# {name} hierarchy: levels {detail['levels']} + coarse "
          f"{detail['coarse_rows']} rows, operator complexity "
          f"{detail['operator_complexity']:.4f}, setup {setup_s:.2f} s "
          f"(host stages: " + json.dumps({
              k: round(v, 4) for k, v in detail.items()
              if isinstance(v, float) and k != "operator_complexity"})
          + f"), riding the gather kernel: {detail['gather']}")


def _amg_hierarchy_of(sol, mesh, dev, block_rows):
    """The block AMG hierarchy that solve_elasticity(matvec="pallas",
    precond="amg") builds for ``sol``'s system (the same RCM permutation
    and setup, rebuilt here), with its operator and the component-major
    rhs: (hier, mv, perm, b_cm)."""
    import torch

    from tpufem_torch.solve.amg_block import build_block_amg
    from tpufem_torch.solve.elasticity import banded_block_system
    from tpufem_torch.sparse.bcsr import BCSRMatrix

    A = sol.A
    mv, _, perm, data_p, cols_p = banded_block_system(
        A, A.cols.cpu().numpy(), block_rows=block_rows, permuted=True)
    hier = build_block_amg(BCSRMatrix(torch.as_tensor(data_p, device=dev),
                                      torch.as_tensor(cols_p, device=dev)),
                           coords=mesh.coords[perm])
    gen = torch.Generator(device=dev).manual_seed(9)
    b_cm = torch.randn((A.block_size, A.data.shape[0]), generator=gen,
                       device=dev, dtype=A.dtype)
    return hier, mv, perm, b_cm


def _check_bcsr_levels(records, name, hier, dev, timed=()):
    """Every product of every level of a block AMG hierarchy (A, Qp, Qr)
    against its plain version, bit for bit, on one random vector; the
    matrices named in ``timed`` (e.g. "A1", "Qp0") also timed beside their
    bound and torch's BSR product."""
    import torch

    from tpufem_torch.sparse import ell_cuda as ec

    gen = torch.Generator(device=dev).manual_seed(10)
    for i, lv in enumerate(hier.levels):
        for mname in ("A", "Qp", "Qr"):
            M = getattr(lv, mname)
            if M is None:
                continue
            nr, k, b, _ = M.data.shape
            dt = str(M.dtype).replace("torch.", "")
            x = torch.randn((b, nr), generator=gen, device=dev,
                            dtype=M.dtype)
            xn = x.T.reshape(-1).contiguous()
            label = (f"{name} level {i} {mname} {nr} block rows b={b} K={k} "
                     f"{dt}")
            is_timed = f"{mname}{i}" in timed
            flops = 2 * k * b * b * nr
            if isinstance(M._band, tuple):
                plan, d_t, rel = M._band
                _compare(records, "B12", label + f" R={plan.block_rows}",
                         lambda: ec.bcsr_matvec_cuda(plan, d_t, rel, x),
                         lambda: ec.bcsr_band_matvec_plain(plan, d_t, rel, x),
                         exact=True, timed=is_timed, shapes=is_timed,
                         work=([d_t[..., :nr], rel[:, :nr], x], flops, dt),
                         library=(_library_bcsr(M.data, M.cols, xn, True)
                                  if is_timed else None))
            else:
                _compare(records, "B12g", label + " absolute columns",
                         lambda: ec.bcsr_gather_matvec_cuda(M.data, M.cols,
                                                            xn),
                         lambda: ec.bcsr_gather_matvec_plain(M.data, M.cols,
                                                             xn),
                         exact=True, timed=is_timed, shapes=is_timed,
                         work=([M.data, M.cols, xn], flops, dt),
                         library=(_library_bcsr(M.data, M.cols, xn, False)
                                  if is_timed else None))
    torch.cuda.empty_cache()


def _vcycle_launches(hier, dev):
    """B9 launches of one hier.apply by operator: {id(plan): count}
    (ELLMatrix's banded product wrapped for the call)."""
    import torch

    from tpufem_torch.sparse import ell as ell_mod

    real, seen = ell_mod.ell_matvec_cuda, {}

    def counting(plan, *args, **kw):
        seen[id(plan)] = seen.get(id(plan), 0) + 1
        return real(plan, *args, **kw)

    ell_mod.ell_matvec_cuda = counting
    try:
        hier.apply(torch.ones(hier.levels[0].A.shape[0], device=dev,
                              dtype=hier.levels[0].A.dtype))
        torch.cuda.synchronize()
    finally:
        ell_mod.ell_matvec_cuda = real
    return seen


def _ell_stats(M):
    """(nonzeros, longest row, empty rows) of an ELL matrix: a row's length
    is the slot after its last nonzero value."""
    import torch

    nz = M.data != 0
    slot = torch.arange(1, nz.shape[1] + 1, device=nz.device)
    lens = (nz * slot).amax(1) if nz.shape[1] else nz.sum(1)
    return (int(nz.sum()), int(lens.max()) if lens.numel() else 0,
            int((lens == 0).sum()))


def _check_ell_levels(records, name, hier, dev):
    """Every product of every level of a scalar AMG hierarchy (A, Qp, Qr):
    B9 and B10 (q = 3) against their plain versions, bit for bit; B9 timed
    at each (under B9's "shapes") beside the bound on the bytes its
    nonzeros need (each nonzero's value and index, x and y once; the bound
    on the padded plan printed beside) and a torch.sparse CSR product of
    the nonzeros; the launches per V-cycle and B9's form printed."""
    import torch

    from tpufem_torch.sparse import ell_cuda as ec

    gen = torch.Generator(device=dev).manual_seed(11)
    per_cycle = _vcycle_launches(hier, dev)
    total_ms = 0.0
    mem = [0, 0]                # B9's layouts, the plans' planes (bytes)
    for i, lv in enumerate(hier.levels):
        for mname in ("A", "Qp", "Qr"):
            M = getattr(lv, mname)
            if M is None:
                continue
            check(isinstance(M._band, tuple),
                  f"{name} level {i} {mname}: no banded plan")
            plan, d_t, rel = M._band
            n, k = M.data.shape
            nnz, longest, empty = _ell_stats(M)
            dt = str(M.dtype).replace("torch.", "")
            x = torch.randn(n, generator=gen, device=dev, dtype=M.dtype)
            X = torch.randn((n, 3), generator=gen, device=dev, dtype=M.dtype)
            form = plan.form
            launches = per_cycle.get(id(plan), 0)
            label = (f"{name} level {i} {mname} {n} rows K={k} used "
                     f"{plan.width} {dt} R={plan.block_rows}")
            item = M.data.element_size()
            needed = nnz * (item + rel.element_size()) + 2 * n * item
            padded = plan.width * n * (item + rel.element_size()) \
                + 2 * n * item
            lay = M._band_layout(M._band)
            _compare(records, "B9", label,
                     lambda: ec.ell_matvec_cuda(plan, d_t, rel, x,
                                                layout=lay),
                     lambda: ec.ell_band_matvec_plain(plan, d_t, rel, x),
                     exact=True, timed=True, time_plain=False, shapes=True,
                     work=([needed - n * item], 2 * nnz, dt),
                     library=_library_ell(M.data, M.cols, x, nonzeros=True))
            ms = records["B9"]["shapes"][-1]["ms"]
            total_ms += launches * ms
            print(f"# level {name} {i} {mname}: rows {n}, K {k}, used "
                  f"{plan.width}, nonzeros {nnz}, longest row {longest}, "
                  f"empty rows {empty}, launches per V-cycle {launches}, "
                  f"form {form}, layout {lay.nbytes()} bytes beside the "
                  f"planes' {d_t.nbytes + rel.nbytes}, B9 {ms:.4f} ms, "
                  "needed bound "
                  f"{needed / HBM_BYTES_PER_S * 1e3:.4f} ms, padded bound "
                  f"{padded / HBM_BYTES_PER_S * 1e3:.4f} ms")
            mem[0] += lay.nbytes()
            mem[1] += d_t.nbytes + rel.nbytes
            del lay
            _compare(records, "B10", label + " q=3",
                     lambda: ec.ell_matvec_multi_cuda(plan, d_t, rel, X),
                     lambda: ec.ell_band_matvec_multi_plain(plan, d_t, rel,
                                                            X),
                     exact=True)
    print(f"# level {name}: B9 per V-cycle {total_ms:.4f} ms (launches x "
          f"the timed ms, summed over the operators); B9's layouts "
          f"{mem[0] / 1e6:.1f} MB beside the planes' {mem[1] / 1e6:.1f} MB "
          "on the card")
    torch.cuda.empty_cache()


def _drive_elasticity_amg(dev, records):
    """examples/elasticity_unstructured.py --precond amg at full width
    (982,802 DOFs, lam = mu = 1, f = (1, -0.5), tol 1e-6, matvec="pallas"):
    fp32 with its fp64 twin (_elasticity_pair), <= ELAST_AMG_MAXITER
    iterations, B12 on the 3 x 3 transfers and levels; then
    matvec="gather" with AMG converges."""
    import torch

    from tpufem_torch.mesh.rectangle import perturbed_rectangle_mesh
    from tpufem_torch.solve.elasticity import solve_elasticity
    from tpufem_torch.sparse import ell_cuda

    mesh = perturbed_rectangle_mesh(-1.0, 1.0, -1.0, 1.0, N_ELAST, N_ELAST,
                                    jitter=0.2, seed=0)
    check(2 * mesh.num_nodes == ELAST_DOFS, "elasticity_amg: mesh size")
    b3 = ell_cuda.bcsr_matvec_cuda.launches_by_block[3]
    sol = _elasticity_pair("elasticity_amg", mesh, dev, precond="amg",
                           maxiter=3000)
    detail = sol.walls["precond_setup_detail"]
    _print_hierarchy("elasticity_amg fp32", detail,
                     sol.walls["precond_setup"])
    its = sol.cg.iterations
    print(f"# elasticity_amg fp32: {its} iterations (TPU, BENCH_NOTES F1: "
          f"{F1_ITERS}), coarsest {detail['coarse_rows']} rows "
          f"(F1: {F1_COARSE}); block-Jacobi takes 2953-2955 here")
    check(its <= ELAST_AMG_MAXITER,
          f"elasticity_amg: {its} iterations > {ELAST_AMG_MAXITER}")
    check(ell_cuda.bcsr_matvec_cuda.launches_by_block[3] > b3,
          "elasticity_amg: B12 never ran at b = 3")
    check(detail["gather"] == [], "elasticity_amg: a level rode the gather "
                                  f"kernel: {detail['gather']}")

    t0 = time.perf_counter()
    solg = solve_elasticity(mesh, body_force=_body_force(2),
                            dtype=torch.float32, tol=1e-6, maxiter=3000,
                            matvec="gather", precond="amg", device=dev)
    wall = time.perf_counter() - t0
    dg = solg.walls["precond_setup_detail"]
    _print_hierarchy("elasticity_amg gather fp32", dg,
                     solg.walls["precond_setup"])
    du = (torch.linalg.vector_norm(solg.u - sol.u)
          / torch.linalg.vector_norm(sol.u)).item()
    print(f"# elasticity_amg fp32 solve_elasticity(gather, amg): "
          f"{solg.cg.iterations} iterations, relres "
          f"{solg.cg.residual_norm.item():.4e}, phases "
          + _walls_json(solg.walls) + f", wall {wall:.2f} s; ||u_gather - "
          f"u_pallas|| / ||u_pallas|| {du:.4e}")
    check(solg.cg.converged, "elasticity_amg gather: not converged")
    del solg

    def after():
        from tpufem_torch.solve.cg import cg_fixed

        hier, mv, _, b_cm = _amg_hierarchy_of(sol, mesh, dev, 1024)
        _check_bcsr_levels(records, "elasticity_amg", hier, dev,
                           timed=("Qp0",))
        nb = sol.A.block_size

        def M(r_cm):
            return hier.apply(r_cm.T.reshape(-1)).reshape(-1, nb).T

        _per_iteration("elasticity_amg", lambda: cg_fixed(mv, b_cm, 10,
                                                          M=M))

    return after


def _drive_elasticity_3d_amg(dev, records):
    """The n = 40 box (206,763 DOFs), fp32, the block AMG with the six
    rigid body modes (6 x 6 coarse blocks and transfers), tol 1e-6,
    block_rows 4096: converges; B12 runs at b = 6."""
    import torch

    from tpufem_torch.mesh.box import box_mesh
    from tpufem_torch.solve.elasticity import solve_elasticity
    from tpufem_torch.sparse import ell_cuda

    mesh = box_mesh(-1, 1, -1, 1, -1, 1, N_ELAST_3D, N_ELAST_3D, N_ELAST_3D)
    check(3 * mesh.num_nodes == ELAST_3D_DOFS, "elasticity_3d_amg: DOFs")
    b6 = ell_cuda.bcsr_matvec_cuda.launches_by_block[6]
    t0 = time.perf_counter()
    sol = solve_elasticity(mesh, body_force=_body_force(3),
                           dtype=torch.float32, tol=1e-6, maxiter=3000,
                           matvec="pallas", precond="amg", block_rows=4096,
                           device=dev)
    wall = time.perf_counter() - t0
    detail = sol.walls["precond_setup_detail"]
    _print_hierarchy("elasticity_3d_amg fp32", detail,
                     sol.walls["precond_setup"])
    n6 = ell_cuda.bcsr_matvec_cuda.launches_by_block[6] - b6
    print(f"# elasticity_3d_amg fp32 solve_elasticity(pallas, amg): "
          f"{sol.cg.iterations} iterations (no TPU record at this size; "
          f"block-Jacobi 171), relres {sol.cg.residual_norm.item():.4e}, "
          f"B12 launches at b = 6: {n6}, phases " + _walls_json(sol.walls)
          + f", wall {wall:.2f} s")
    check(sol.cg.converged, "elasticity_3d_amg: not converged")
    check(n6 > 0, "elasticity_3d_amg: B12 never ran at b = 6")

    def after():
        from tpufem_torch.solve.cg import cg_fixed

        hier, mv, _, b_cm = _amg_hierarchy_of(sol, mesh, dev, 4096)
        check(len(hier.levels) >= 2 and hier.levels[1].A.block_size == 6,
              "elasticity_3d_amg: expected a 6 x 6 level")
        _check_bcsr_levels(records, "elasticity_3d_amg", hier, dev,
                           timed=("A1",))

        def M(r_cm):
            return hier.apply(r_cm.T.reshape(-1)).reshape(-1, 3).T

        _per_iteration("elasticity_3d_amg",
                       lambda: cg_fixed(mv, b_cm, 10, M=M))

    return after


def _drive_unstructured_amg(dev, records, keep):
    """examples/unstructured_1m.py --precond amg at full size, on the
    unstructured path's assembled, RCM-ordered system (1,002,001 rows,
    fp32): build_amg (greedy, strength 0.08, V-cycle), cg to 1e-5 with
    check_every=2: <= UNSTR_AMG_MAXITER iterations, its rel L2 error
    within 10% of the same fp32 system solved to relres 1e-6 (the error
    that system's fp32 assembly leaves: about 2.0e-5 here, so the
    absolute 2.0e-5 gate is held on the entry point below);
    apply_multi on an [n, 3] block against three applies (1e-5
    relative).  Then solve_poisson_ell(precond="amg") on the same mesh:
    <= UNSTR_AMG_MAXITER iterations, rel L2 error <= 2.0e-5."""
    import torch

    from tpufem_torch.solve.amg import build_amg
    from tpufem_torch.solve.cg import cg, cg_fixed
    from tpufem_torch.solve.poisson import model_problem_2d, solve_poisson_ell

    A, b, ue, mesh0 = keep.pop("unstructured")
    walls = {}
    t0 = time.perf_counter()
    hier = build_amg(A, aggregation="greedy", cycle="V", strength=0.08,
                     walls_out=walls)
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    _print_hierarchy("unstructured_amg", walls, setup)
    print(f"# unstructured_amg hierarchy on the TPU (BENCH_NOTES F4): "
          f"{F4_LEVELS}")
    check(walls["gather"] == [], "unstructured_amg: a matrix rode the "
                                 f"gather form: {walls['gather']}")
    t0 = time.perf_counter()
    res = cg(A.matvec, b, tol=1e-5, maxiter=3000, M=hier.apply,
             check_every=2)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    err = _rel_err(res.x, ue)
    print(f"# unstructured_amg AMG-PCG (V-cycle): {res.iterations} "
          f"iterations (TPU, F4: {F4_ITERS}; Chebyshev(14) about 242), "
          f"relres {res.residual_norm.item():.3e}, rel L2 error {err:.4e}, "
          f"solve wall {wall:.4f} s")
    check(res.converged and res.iterations <= UNSTR_AMG_MAXITER,
          f"unstructured_amg: {res.iterations} iterations, converged "
          f"{res.converged}")
    tight = cg(A.matvec, b, tol=1e-6, maxiter=200, M=hier.apply)
    err_floor = _rel_err(tight.x, ue)
    print(f"# unstructured_amg the same fp32 system to relres 1e-6: "
          f"{tight.iterations} iterations, rel L2 error {err_floor:.4e} "
          f"(the fp32 assembly's floor; the solve to 1e-5 is "
          f"{err / err_floor:.4f} of it)")
    check(tight.converged, "unstructured_amg: relres 1e-6 not reached")
    check(err <= 1.1 * err_floor,
          f"unstructured_amg: rel L2 error {err:.3e} > 1.1 x the system's "
          f"{err_floor:.3e}")
    del tight
    gen = torch.Generator(device=dev).manual_seed(12)
    R3 = torch.randn((A.shape[0], 3), generator=gen, device=dev)
    Z3 = hier.apply_multi(R3)
    cols3 = torch.stack([hier.apply(R3[:, j].contiguous())
                         for j in range(3)], 1)
    err3 = ((Z3 - cols3).abs().max() / cols3.abs().max()).item()
    print(f"# unstructured_amg apply_multi on an [n, 3] block vs 3 applies: "
          f"max rel difference {err3:.3e}")
    check(err3 <= 1e-5, f"unstructured_amg: apply_multi differs {err3:.3e}")
    del R3, Z3, cols3

    t0 = time.perf_counter()
    sol = solve_poisson_ell(mesh0, precond="amg", dtype=torch.float32,
                            tol=1e-5, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    err_e = _rel_err(sol.u, torch.as_tensor(
        model_problem_2d()[1](mesh0.coords), device=dev))
    print(f"# unstructured_amg solve_poisson_ell(amg, fp32): "
          f"{sol.cg.iterations} iterations, relres "
          f"{sol.cg.residual_norm.item():.3e}, rel L2 error {err_e:.4e}, "
          f"wall {wall:.2f} s (host pattern, RCM, plan and hierarchy "
          "included)")
    check(sol.cg.converged and sol.cg.iterations <= UNSTR_AMG_MAXITER,
          f"unstructured_amg entry: {sol.cg.iterations} iterations")
    check(err_e <= 2.0e-5, f"unstructured_amg entry: rel L2 error "
                           f"{err_e:.3e} > 2.0e-5")
    del sol

    def after():
        _check_ell_levels(records, "unstructured_amg", hier, dev)
        _per_iteration("unstructured_amg",
                       lambda: cg_fixed(A.matvec, b, 10, M=hier.apply))

    return after


# examples/elasticity_1m.py --n 72 --precond mg: 73^3 x 3 = 1,167,051
# DOFs; the TPU record (BENCH_NOTES.md:88): 14 iterations, error 7.6e-4
N_ELAST_BOX = 72
ELAST_BOX_DOFS = 1_167_051
ELAST_BOX_MAXITER = 16


def _drive_elasticity_box(dev):
    """examples/elasticity_1m.py --n 72 --precond mg (lam 1.2, mu 0.8, the
    manufactured displacement, fp32, tol 1e-5): solve_elasticity_box with
    the vector MG in <= ELAST_BOX_MAXITER iterations, rel L2 error <=
    1e-3.  No hand-written kernel runs (the block-stencil product and the
    transfers are XLA in the reference, plain PyTorch here)."""
    import numpy as np
    import torch

    from tpufem_torch.solve.cg import cg_fixed
    from tpufem_torch.solve.elasticity_structured import (
        build_elasticity_multigrid, elastic_mg_preconditioner,
        manufactured_elasticity_3d, solve_elasticity_box)
    from tpufem_torch.solve.multigrid import _light_grid

    lam, mu = 1.2, 0.8
    u_exact, f = manufactured_elasticity_3d(lam, mu)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sol = solve_elasticity_box((-3.0, 3.0), N_ELAST_BOX, lam=lam, mu=mu,
                               body_force=f, dtype=torch.float32, tol=1e-5,
                               maxiter=4000, precond="mg", device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    _, coords_grid, _ = _light_grid((-3.0, 3.0), N_ELAST_BOX, 3)
    ue = u_exact(*coords_grid).reshape(3, -1)
    u = sol.u.double().cpu().numpy()
    err = float(np.linalg.norm(u - ue) / np.linalg.norm(ue))
    print(f"# elasticity_box solve_elasticity_box(n={N_ELAST_BOX}, mg, "
          f"fp32): {sol.num_dofs} DOFs, {sol.cg.iterations} iterations "
          f"(TPU, BENCH_NOTES.md:88: 14), relres "
          f"{sol.cg.residual_norm.item():.3e}, rel L2 error {err:.4e} "
          f"(TPU 7.6e-4), wall {wall:.2f} s (host setup included), peak "
          f"device memory {torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
    check(sol.num_dofs == ELAST_BOX_DOFS, "elasticity_box: DOF count")
    check(sol.cg.converged and sol.cg.iterations <= ELAST_BOX_MAXITER,
          f"elasticity_box: {sol.cg.iterations} iterations")
    check(err <= 1e-3, f"elasticity_box: rel L2 error {err:.3e} > 1e-3")

    def after():
        from tpufem_torch.solve.elasticity_structured import (
            block_stencil_matvec)

        levels = build_elasticity_multigrid((-3.0, 3.0), N_ELAST_BOX,
                                            lam=lam, mu=mu,
                                            dtype=torch.float32, device=dev)
        M = elastic_mg_preconditioner(levels)
        top = levels[0]
        gen = torch.Generator(device=dev).manual_seed(13)
        nn = int(np.prod(top.plan.info.node_grid))
        # random nodal values (zero on the store grid's padding and on
        # the clamped boundary)
        b = torch.stack([top.plan.embed_field(torch.randn(
            nn, generator=gen, device=dev)) for _ in range(3)])
        b = torch.where(top.bc_mask[None], 0.0, b)
        _per_iteration("elasticity_box", lambda: cg_fixed(
            lambda x: block_stencil_matvec(top.data, x, top.plan.offsets),
            b, 10, M=M))

    return after


def _drive_weakform(dev):
    """examples/poisson_2d.py composed from the port at its defaults (fp64);
    then the weak-form ELL assembly of the 1000 x 1000 perturbed mesh
    against the closed-form P1 assembly (``assemble_ell(p1_stiffness)``),
    fp32."""
    import numpy as np
    import torch

    from tpufem_torch.assemble.dense import assemble_vector
    from tpufem_torch.assemble.ell import assemble_ell
    from tpufem_torch.assemble.local import element_load, p1_stiffness
    from tpufem_torch.fem.quadrature import triangle_rule
    from tpufem_torch.fem.space import FunctionSpace
    from tpufem_torch.forms.language import SpatialCoordinate, dot, grad
    from tpufem_torch.forms.weakform import WeakForm
    from tpufem_torch.mesh.adjacency import ell_pattern
    from tpufem_torch.mesh.rectangle import (RectangleMesh,
                                             perturbed_rectangle_mesh)
    from tpufem_torch.solve.bc import apply_dirichlet_ell
    from tpufem_torch.solve.cg import cg
    from tpufem_torch.solve.poisson import model_problem_2d
    from tpufem_torch.solve.precond import jacobi
    from tpufem_torch.utils.timing import PhaseTimer

    mesh = RectangleMesh(-3.0, 3.0, -3.0, 3.0, 64, 64)
    V = FunctionSpace(mesh, "Lagrange", 1)
    X = SpatialCoordinate(V)
    f = -2 * (X[0] * X[0] + X[1] * X[1]) + 36
    t0 = time.perf_counter()
    wf = WeakForm(V, device=dev).build(lambda u, v: dot(grad(u), grad(v)),
                                       lambda v: f * v)
    A, b = wf.assemble(format="ell")
    A, b = apply_dirichlet_ell(A, b, torch.as_tensor(V.dof_flags,
                                                     device=dev))
    res = cg(A.matvec, b, tol=1e-8, maxiter=10_000, M=jacobi(A))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ue = model_problem_2d()[1](mesh.coords)
    rms = float(np.sqrt(np.mean((res.x.cpu().numpy() - ue) ** 2)))
    print(f"# weakform poisson_2d (64 x 64, fp64): {V.num_dofs} DOFs, "
          f"{res.iterations} iterations (JAX on the CPU: "
          f"{JAX_WEAKFORM_ITERS}), nodal rms error {rms:.4e} (JAX: "
          f"{JAX_WEAKFORM_RMS}), wall {wall:.3f} s")
    check(res.converged and res.iterations == JAX_WEAKFORM_ITERS,
          f"weakform: {res.iterations} iterations")
    check(abs(rms - JAX_WEAKFORM_RMS) <= 0.01 * JAX_WEAKFORM_RMS,
          f"weakform: nodal rms error {rms:.4e}")

    timer = PhaseTimer()
    with timer("host_mesh_pattern"):
        mesh = perturbed_rectangle_mesh(-3, 3, -3, 3, N_ELL, N_ELL,
                                        jitter=0.25, seed=0)
        pat = ell_pattern(mesh.conn, mesh.num_nodes, pad_to=8,
                          with_sort_plan=False)
    V = FunctionSpace(mesh)
    X = SpatialCoordinate(V)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with timer("weak_form_assemble"):
        wf = WeakForm(V, dtype=torch.float32, device=dev).build(
            lambda u, v: dot(grad(u), grad(v)),
            lambda v: (36 - 2 * (X[0] * X[0] + X[1] * X[1])) * v)
        A_wf, b_wf = wf.assemble(format="ell", pattern=pat)
        torch.cuda.synchronize()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    with timer("closed_form_assemble"):
        ec = torch.as_tensor(mesh.element_coords(), dtype=torch.float32,
                             device=dev)
        A_p1 = assemble_ell(pat, p1_stiffness(ec, V.element))
        b_p1 = assemble_vector(mesh.conn, element_load(
            ec, V.element, triangle_rule(5), model_problem_2d()[0]),
            mesh.num_nodes)
        torch.cuda.synchronize()
    dA = ((A_wf.data - A_p1.data).abs().max() / A_p1.data.abs().max()).item()
    db = ((b_wf - b_p1).abs().max() / b_p1.abs().max()).item()
    print(f"# weakform ELL assembly at {mesh.num_nodes} rows (fp32): max "
          f"|A_wf - A_p1| / max |A_p1| {dA:.3e}, rhs {db:.3e}; phases (s) "
          + json.dumps({k: round(v, 4) for k, v in timer.report().items()})
          + f"; weak-form peak device memory {peak_gb:.3f} GB")
    check(A_wf.data.shape == A_p1.data.shape and dA <= 1e-5 and db <= 1e-5,
          f"weakform at 1M rows: matrix {dA:.3e}, rhs {db:.3e}")



# -- the weak-form frontend: P2, boundary terms, Q1 cells, COO, matrix-free --

# The JAX package's own CPU numbers on the same systems (float64, the XLA
# gather products), from scripts/weakform_jax_reference.py:
#   python scripts/weakform_jax_reference.py <case> <n>
# p2 500: the 1,002,001-DOF mixed Dirichlet / Neumann P2 system, AMG-PCG
# to 1e-12; p2_dirichlet 160: tests/amg_systems.py's 103,041-DOF
# p2_system, AMG-PCG to 1e-9; quad 1000 and hex 100: the full sizes;
# p2_tet_robin 30: the JAX package's eager CPU assembly of P2 tets holds
# 9.3 GB of host memory there, and its element intermediates grow as n^3
# (about 43 GB at the full size, n = 50, which is gated at or under the
# n = 30 error).
JAX_A3 = {
    "p2": {"n": 500, "iterations": 31, "rel_l2_error": 3.3155634807627187e-10},
    "p2_dirichlet": {"n": 160, "iterations": 18,
                     "rel_l2_error": 9.839361120458458e-10},
    "p2_tet_robin": {"n": 30, "iterations": 30,
                     "rel_l2_error": 2.107809545451627e-05},
    "quad": {"n": 1000, "iterations": 40,
             "rel_l2_error": 8.276420355490981e-07},
    "hex": {"n": 100, "iterations": 14,
            "rel_l2_error": 0.0001652443178493883},
}
N_P2, P2_DOFS = 500, 1_002_001
N_P2_TET, P2_TET_DOFS = 50, 1_030_301
N_QUAD, N_HEX = 1000, 100
QUAD_ROWS, HEX_ROWS = 1_002_001, 1_030_301
N_COO_X, N_COO_Y = 10_000, 1000      # examples/generic_assembly_20m.py
COO_ELEMENTS, COO_NODES = 20_000_000, 10_011_001
COLOR_SIZES = (125, 250)
A3_MAXITER = 500


def _a3_gate(name, key, its, err, n):
    """The JAX package's count within 1 iteration and its error within 1%
    (relative) on the same system."""
    ref = JAX_A3[key]
    check(ref["n"] == n, f"{name}: the JAX record is at n={ref['n']}, "
                         f"not {n}")
    print(f"# {name} n={n}: {its} iterations (JAX on the CPU: "
          f"{ref['iterations']}), rel L2 error {err:.6e} (JAX: "
          f"{ref['rel_l2_error']:.6e}, {err / ref['rel_l2_error']:.5f} of "
          "it)")
    check(abs(its - ref["iterations"]) <= 1,
          f"{name}: {its} iterations, JAX {ref['iterations']}")
    check(abs(err - ref["rel_l2_error"]) <= 0.01 * ref["rel_l2_error"],
          f"{name}: rel L2 error {err:.4e}, JAX {ref['rel_l2_error']:.4e}")


def _rcm_amg(A, b, timer, walls):
    """RCM + reorder_ell (tests/amg_systems.py's p2_system), the greedy
    strength-0.08 AMG with coarse_n=300: (A_p, b_p, perm, hierarchy)."""
    import torch

    from tpufem_torch.mesh.adjacency import reverse_cuthill_mckee
    from tpufem_torch.solve.amg import build_amg
    from tpufem_torch.sparse.ell import ELLMatrix, reorder_ell

    dev = b.device
    with timer("rcm"):
        perm = reverse_cuthill_mckee(A.cols.cpu().numpy())
        data_p, cols_p = reorder_ell(A.data, A.cols, perm)
        A_p = ELLMatrix(torch.as_tensor(data_p, device=dev),
                        torch.as_tensor(cols_p, device=dev))
        perm_t = torch.as_tensor(perm, device=dev)
        b_p = b[perm_t]
        torch.cuda.synchronize()
    with timer("amg_setup"):
        hier = build_amg(A_p, aggregation="greedy", strength=0.08,
                         coarse_n=300, walls_out=walls)
        torch.cuda.synchronize()
    return A_p, b_p, perm_t, hier


def _band_of(M):
    import numpy as np

    cols = M.cols.cpu().numpy().astype(np.int64)
    return int(np.abs(cols - np.arange(cols.shape[0])[:, None]).max())


def _time_ell_shape(records, name, A_p):
    """B9 at the path's finest operator (its banded plan), timed beside its
    bound on the bytes its nonzeros need (the padded plan's printed beside)
    and a torch.sparse CSR product of the padded rows (that of the
    nonzeros printed beside); B9g (the absolute-column form) on the same
    matrix where the band is wider than the automatic rule takes
    (_AUTO_BAND_MAX)."""
    import torch

    from tpufem_torch.sparse import ell as ell_mod
    from tpufem_torch.sparse import ell_cuda as ec

    plan, d_t, rel = A_p._band
    n, k = A_p.data.shape
    dt = str(A_p.dtype).replace("torch.", "")
    gen = torch.Generator(device=A_p.data.device).manual_seed(15)
    x = torch.randn(n, generator=gen, device=A_p.data.device,
                    dtype=A_p.dtype)
    bw = _band_of(A_p)
    nnz = _ell_stats(A_p)[0]
    item = A_p.data.element_size()

    def bounds(index_bytes, width):
        """The bytes the inputs need (the nonzeros and x; _bound adds y)."""
        needed = nnz * (item + index_bytes) + 2 * n * item
        padded = width * n * (item + index_bytes) + 2 * n * item
        print(f"# {name} bounds: needed {needed / HBM_BYTES_PER_S * 1e3:.4f}"
              f" ms ({nnz} nonzeros), padded "
              f"{padded / HBM_BYTES_PER_S * 1e3:.4f} ms ({width} slots)")
        return needed - n * item

    label = f"{name} {n} rows K={k} {dt} band {bw} R={plan.block_rows}"
    lay = A_p._band_layout(A_p._band)
    print(f"# {name}: B9's layout {lay.nbytes()} bytes beside the planes' "
          f"{d_t.nbytes + rel.nbytes}")
    _compare(records, "B9", label,
             lambda: ec.ell_matvec_cuda(plan, d_t, rel, x, layout=lay),
             lambda: ec.ell_band_matvec_plain(plan, d_t, rel, x),
             timed=True, shapes=True, exact=True,
             work=([bounds(rel.element_size(), plan.width)], 2 * nnz, dt),
             library=_library_ell(A_p.data, A_p.cols, x))
    nz_ms = _library_ms(_library_ell(A_p.data, A_p.cols, x, nonzeros=True),
                        ec.ell_band_matvec_plain(plan, d_t, rel, x),
                        f"B9 {label} (CSR of the nonzeros)")
    print(f"# {name}: CSR of the nonzeros "
          + ("failed" if nz_ms is None else f"{nz_ms:.4f} ms"))
    if bw > ell_mod._AUTO_BAND_MAX:
        _compare(records, "B9g", f"{name} {n} rows K={k} {dt} band {bw} "
                                 "absolute columns",
                 lambda: ec.ell_gather_matvec_cuda(A_p.data, A_p.cols, x),
                 lambda: ec.ell_gather_matvec_plain(A_p.data, A_p.cols, x),
                 timed=True, shapes=True, exact=True,
                 work=([bounds(4, k)], 2 * nnz, dt),
                 library=_library_ell(A_p.data, A_p.cols, x))
    del x, lay
    torch.cuda.empty_cache()


def _amg_after(records, name, A_p, b_p, hier, levels=None):
    """After an AMG path: B9 at its fine operator, every level of the
    (label, hierarchy) pairs in ``levels`` (its own hierarchy by default),
    then 10 AMG-PCG iterations profiled."""
    from tpufem_torch.solve.cg import cg_fixed

    def after():
        _time_ell_shape(records, name, A_p)
        for label, h in levels or ((name, hier),):
            _check_ell_levels(records, label, h, A_p.data.device)
        _per_iteration(name, lambda: cg_fixed(A_p.matvec, b_p, 10,
                                              M=hier.apply))

    return after


def _p2_neumann(n, dev, timer, walls):
    """The mixed Dirichlet (|x| = 3) / Neumann (|y| = 3) P2 problem of
    tests/test_boundary.py on rectangle_mesh(-3,3,-3,3,n,n): WeakForm ELL
    assembly with the boundary load, apply_dirichlet_ell, RCM, AMG-PCG.
    Returns (V, u, cg result, A_p, b_p, hier)."""
    import numpy as np
    import torch

    from tpufem_torch.fem.facets import boundary_facets
    from tpufem_torch.fem.space import FunctionSpace
    from tpufem_torch.forms.language import Coefficient, dot, grad
    from tpufem_torch.forms.weakform import WeakForm
    from tpufem_torch.mesh.adjacency import ell_pattern
    from tpufem_torch.mesh.rectangle import rectangle_mesh
    from tpufem_torch.solve.bc import apply_dirichlet_ell
    from tpufem_torch.solve.cg import cg
    from tpufem_torch.solve.poisson import model_problem_2d

    f = model_problem_2d()[0]
    with timer("host_mesh"):
        mesh = rectangle_mesh(-3, 3, -3, 3, n, n)
    with timer("edges"):
        V = FunctionSpace(mesh, degree=2)
    with timer("facets"):
        facets = boundary_facets(mesh)
    with timer("pattern"):
        pat = ell_pattern(V.dof_conn, V.num_dofs, pad_to=8,
                          with_sort_plan=False)
    g = Coefficient(lambda xq: -6.0 * (9.0 - xq[..., 0] ** 2))
    with timer("assemble"):
        wf = WeakForm(V, device=dev).build(
            lambda u, v: dot(grad(u), grad(v)),
            lambda v: Coefficient(f) * v)
        wf.build_boundary(rhs=lambda v: g * v,
                          where=lambda c: np.abs(c[:, 1]) > 3 - 1e-9)
        A, b = wf.assemble(format="ell", pattern=pat)
        bc = torch.as_tensor(np.abs(V.scalar_dof_coords[:, 0]) > 3 - 1e-9,
                             device=dev)
        A, b = apply_dirichlet_ell(A, b, bc)
        torch.cuda.synchronize()
    print(f"# p2 n={n}: {V.num_dofs} DOFs, {mesh.num_elements} triangles, "
          f"{facets.num_facets} boundary facets, ELL width {pat.width}")
    A_p, b_p, perm_t, hier = _rcm_amg(A, b, timer, walls)
    with timer("solve"):
        res = cg(A_p.matvec, b_p, tol=1e-12, maxiter=A3_MAXITER,
                 M=hier.apply)
        torch.cuda.synchronize()
    u = torch.empty_like(res.x)
    u[perm_t] = res.x
    return V, u, res, A_p, b_p, hier


def _drive_p2(dev, records):
    """P2 triangles with a Neumann term at 1,002,001 DOFs (fp64), gated
    against the JAX package's CPU count and error on the same system; then
    the 103,041-DOF pure-Dirichlet p2_system(160) cell (<= 40 iterations;
    the JAX record BENCH_NOTES.md:490: 18-19)."""
    import torch

    from tpufem_torch.solve.poisson import model_problem_2d
    from tpufem_torch.utils.timing import PhaseTimer

    exact = model_problem_2d()[1]
    timer, walls = PhaseTimer(), {}
    t0 = time.perf_counter()
    V, u, res, A_p, b_p, hier = _p2_neumann(N_P2, dev, timer, walls)
    wall = time.perf_counter() - t0
    check(V.num_dofs == P2_DOFS, f"p2: {V.num_dofs} DOFs")
    _print_hierarchy("p2", walls, timer.report()["amg_setup"])
    err = _rel_err(u, torch.as_tensor(exact(V.scalar_dof_coords),
                                      device=dev))
    print(f"# p2 AMG-PCG to 1e-12: {res.iterations} iterations, relres "
          f"{res.residual_norm.item():.3e}, RCM band {_band_of(A_p)}; wall "
          f"{wall:.2f} s; phases (s, wall clock ending in a synchronize): "
          + json.dumps({k: round(v, 4) for k, v in timer.report().items()}))
    check(res.converged, "p2: not converged")
    _a3_gate("p2", "p2", res.iterations, err, N_P2)

    # the 103,041-DOF reference cell: tests/amg_systems.py's p2_system(160)
    import numpy as np

    from tpufem_torch.fem.space import FunctionSpace
    from tpufem_torch.forms.language import SpatialCoordinate, dot, grad
    from tpufem_torch.forms.weakform import WeakForm
    from tpufem_torch.mesh.rectangle import rectangle_mesh
    from tpufem_torch.solve.bc import apply_dirichlet_ell
    from tpufem_torch.solve.cg import cg

    t0 = time.perf_counter()
    V2 = FunctionSpace(rectangle_mesh(-3, 3, -3, 3, 160, 160), degree=2)
    X = SpatialCoordinate(V2)
    fx = 36 - 2 * (X[0] ** 2 + X[1] ** 2)
    A2, b2 = WeakForm(V2, device=dev).build(
        lambda u_, v: dot(grad(u_), grad(v)), lambda v: fx * v).assemble(
        format="ell")
    A2, b2 = apply_dirichlet_ell(A2, b2, torch.as_tensor(V2.dof_flags,
                                                         device=dev))
    A2p, b2p, perm2, hier2 = _rcm_amg(A2, b2, PhaseTimer(), {})
    res2 = cg(A2p.matvec, b2p, tol=1e-9, maxiter=100, M=hier2.apply)
    torch.cuda.synchronize()
    ref = JAX_A3["p2_dirichlet"]
    print(f"# p2 reference cell p2_system(160): {V2.num_dofs} DOFs, "
          f"{res2.iterations} iterations to 1e-9 (gate <= 40; the JAX "
          f"record BENCH_NOTES.md:490: 18-19; the JAX package's CPU run: "
          f"{ref['iterations']}), levels "
          f"{[lv.A.shape[0] for lv in hier2.levels]}, "
          f"{time.perf_counter() - t0:.2f} s")
    check(V2.num_dofs == 103_041 and res2.converged
          and res2.iterations <= 40, f"p2 cell: {res2.iterations}")
    check(abs(res2.iterations - ref["iterations"]) <= 1,
          f"p2 cell: {res2.iterations} iterations, JAX {ref['iterations']}")
    del A2, b2, A2p, b2p, hier2
    return _amg_after(records, "p2", A_p, b_p, hier)


def _robin_data(xq):
    """du/dn on the faces of (-3, 3)^3 of u = (9-x^2)(9-y^2)(9-z^2), where
    u = 0: the Robin data du/dn + u."""
    import torch

    x, y, z = xq[..., 0], xq[..., 1], xq[..., 2]
    on_x = x.abs() > 3 - 1e-9
    on_y = y.abs() > 3 - 1e-9
    return torch.where(on_x, -6.0 * (9 - y ** 2) * (9 - z ** 2),
                       torch.where(on_y, -6.0 * (9 - x ** 2) * (9 - z ** 2),
                                   -6.0 * (9 - x ** 2) * (9 - y ** 2)))


def _p2_tet_robin(n, dev, timer, walls):
    """The pure Robin problem du/dn + u = g on every facet of
    box_mesh(-3,3,...,n,n,n), P2 tets, no Dirichlet row: WeakForm ELL
    assembly, RCM, AMG-PCG to 1e-10.  Returns (V, u, res, A_p, b_p,
    hier)."""
    import torch

    from tpufem_torch.fem.facets import boundary_facets
    from tpufem_torch.fem.space import FunctionSpace
    from tpufem_torch.forms.language import Coefficient, dot, grad
    from tpufem_torch.forms.weakform import WeakForm
    from tpufem_torch.mesh.adjacency import ell_pattern
    from tpufem_torch.mesh.box import box_mesh
    from tpufem_torch.solve.cg import cg
    from tpufem_torch.solve.poisson import model_problem_3d

    f = model_problem_3d()[0]
    with timer("host_mesh"):
        mesh = box_mesh(-3, 3, -3, 3, -3, 3, n, n, n)
    with timer("edges"):
        V = FunctionSpace(mesh, degree=2)
    with timer("facets"):
        facets = boundary_facets(mesh)
    with timer("pattern"):
        pat = ell_pattern(V.dof_conn, V.num_dofs, pad_to=16,
                          with_sort_plan=False)
    with timer("assemble"):
        wf = WeakForm(V, device=dev).build(
            lambda u, v: dot(grad(u), grad(v)),
            lambda v: Coefficient(f) * v)
        wf.build_boundary(lhs=lambda u, v: u * v,
                          rhs=lambda v: Coefficient(_robin_data) * v)
        A, b = wf.assemble(format="ell", pattern=pat)
        torch.cuda.synchronize()
    print(f"# p2_tet_robin n={n}: {V.num_dofs} DOFs, {mesh.num_elements} "
          f"tetrahedra, {facets.num_facets} boundary facets, ELL width "
          f"{pat.width}")
    A_p, b_p, perm_t, hier = _rcm_amg(A, b, timer, walls)
    with timer("solve"):
        res = cg(A_p.matvec, b_p, tol=1e-10, maxiter=A3_MAXITER,
                 M=hier.apply)
        torch.cuda.synchronize()
    u = torch.empty_like(res.x)
    u[perm_t] = res.x
    return V, u, res, A_p, b_p, hier


def _drive_p2_tet_robin(dev, records):
    """P2 tetrahedra with a pure Robin term: at the JAX record's n (its
    count within 1, its error within 1%), then at 1,030,301 DOFs (n = 50;
    error at or under the smaller size's).  Prints whether the fine level
    rides B9 (the banded plan build_amg primes on the card, any band) and
    whether the band exceeds _AUTO_BAND_MAX."""
    import torch

    from tpufem_torch.solve.poisson import model_problem_3d
    from tpufem_torch.sparse import ell as ell_mod
    from tpufem_torch.sparse import ell_cuda
    from tpufem_torch.utils.timing import PhaseTimer

    exact = model_problem_3d()[1]
    ref = JAX_A3["p2_tet_robin"]
    errs = {}
    for n in (ref["n"], N_P2_TET):
        timer, walls = PhaseTimer(), {}
        t0 = time.perf_counter()
        before = (ell_cuda.ell_matvec_cuda.launches,
                  ell_cuda.ell_gather_matvec_cuda.launches)
        V, u, res, A_p, b_p, hier = _p2_tet_robin(n, dev, timer, walls)
        wall = time.perf_counter() - t0
        ran = (ell_cuda.ell_matvec_cuda.launches - before[0],
               ell_cuda.ell_gather_matvec_cuda.launches - before[1])
        bw = _band_of(A_p)
        _print_hierarchy(f"p2_tet_robin n={n}", walls,
                         timer.report()["amg_setup"])
        errs[n] = _rel_err(u, torch.as_tensor(exact(V.scalar_dof_coords),
                                              device=dev))
        print(f"# p2_tet_robin n={n} AMG-PCG to 1e-10: {res.iterations} "
              f"iterations, relres {res.residual_norm.item():.3e}, rel L2 "
              f"error {errs[n]:.6e}; RCM band {bw} ("
              f"{'over' if bw > ell_mod._AUTO_BAND_MAX else 'within'} "
              f"_AUTO_BAND_MAX {ell_mod._AUTO_BAND_MAX}): B9 {ran[0]} and "
              f"B9g {ran[1]} launches in the setup and solve; wall "
              f"{wall:.2f} s; phases (s): "
              + json.dumps({k: round(v, 4)
                            for k, v in timer.report().items()}))
        check(res.converged, f"p2_tet_robin n={n}: not converged")
        if n == ref["n"]:
            _a3_gate("p2_tet_robin", "p2_tet_robin", res.iterations,
                     errs[n], n)
            small = hier               # its levels are checked after
            del A_p, b_p, hier, V, u
            torch.cuda.empty_cache()
    check(V.num_dofs == P2_TET_DOFS, f"p2_tet_robin: {V.num_dofs} DOFs")
    print(f"# p2_tet_robin n={N_P2_TET}: rel L2 error {errs[N_P2_TET]:.6e}"
          f" <= n={ref['n']}'s {errs[ref['n']]:.6e}: "
          f"{errs[N_P2_TET] <= errs[ref['n']]}")
    check(errs[N_P2_TET] <= errs[ref["n"]],
          f"p2_tet_robin: the full-size error {errs[N_P2_TET]:.4e} exceeds "
          f"n={ref['n']}'s")
    return _amg_after(records, "p2_tet_robin", A_p, b_p, hier, levels=(
        (f"p2_tet_robin n={ref['n']}", small),
        (f"p2_tet_robin n={N_P2_TET}", hier)))


def _solve_capturing_amg(mesh, dev):
    """solve_poisson_ell(mesh, precond="amg", tol=1e-10) on the card, with
    the hierarchy it builds and the matrix it builds it from captured
    (solve.amg.build_amg wrapped for the call): (solution, A_p, hierarchy,
    setup walls, wall)."""
    import torch

    from tpufem_torch.solve import amg as amg_mod
    from tpufem_torch.solve.poisson import solve_poisson_ell

    seen, walls = {}, {}
    real = amg_mod.build_amg

    def capture(A, **kw):
        t0 = time.perf_counter()
        seen["A"], seen["hier"] = A, real(A, walls_out=walls, **kw)
        torch.cuda.synchronize()
        walls["setup"] = time.perf_counter() - t0
        return seen["hier"]

    amg_mod.build_amg = capture
    try:
        t0 = time.perf_counter()
        sol = solve_poisson_ell(mesh, precond="amg", tol=1e-10, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        amg_mod.build_amg = real
    return sol, seen["A"], seen["hier"], walls, wall


def _drive_quad_hex(dev, records):
    """solve_poisson_ell(precond="amg", tol=1e-10, fp64) on
    perturbed_quad_mesh(-3,3,-3,3,1000,1000, jitter=0.25, seed=5)
    (1,002,001 rows) and box_hex_mesh(-3,3,...,100,100,100) (1,030,301
    rows), each at the JAX package's count within 1 and its error within
    1%; then B9 (and B9g) at both fine operators and their iterations
    profiled."""
    import torch

    from tpufem_torch.mesh.box import box_hex_mesh
    from tpufem_torch.mesh.rectangle import perturbed_quad_mesh
    from tpufem_torch.solve.poisson import model_problem_2d, model_problem_3d

    keep = {}

    def solve(name, mesh, exact):
        sol, A_p, hier, walls, wall = _solve_capturing_amg(mesh, dev)
        err = _rel_err(sol.u, torch.as_tensor(exact(mesh.coords),
                                              device=dev))
        _print_hierarchy(f"quad_hex {name}", walls, walls["setup"])
        print(f"# quad_hex {name}: {mesh.num_nodes} rows, "
              f"{mesh.num_elements} cells, RCM band {_band_of(A_p)}, ELL "
              f"width {A_p.data.shape[1]}: {sol.cg.iterations} iterations, "
              f"relres {sol.cg.residual_norm.item():.3e}, rel L2 error "
              f"{err:.6e}, wall {wall:.2f} s (host pattern, weak-form "
              f"kernels, RCM and the AMG setup of {walls['setup']:.2f} s "
              "included)")
        check(sol.cg.converged, f"quad_hex {name}: not converged")
        keep[name] = (A_p, hier)
        return sol.cg.iterations, err

    t0 = time.perf_counter()
    quad = perturbed_quad_mesh(-3, 3, -3, 3, N_QUAD, N_QUAD, jitter=0.25,
                               seed=5)
    print(f"# quad_hex quad mesh: {time.perf_counter() - t0:.2f} s (host)")
    check(quad.num_nodes == QUAD_ROWS, f"quad: {quad.num_nodes} rows")
    its, err = solve("quad", quad, model_problem_2d()[1])
    _a3_gate("quad_hex quad", "quad", its, err, N_QUAD)
    hexm = box_hex_mesh(-3, 3, -3, 3, -3, 3, N_HEX, N_HEX, N_HEX)
    check(hexm.num_nodes == HEX_ROWS, f"hex: {hexm.num_nodes} rows")
    its, err = solve("hex", hexm, model_problem_3d()[1])
    _a3_gate("quad_hex hex", "hex", its, err, N_HEX)

    def after():
        from tpufem_torch.solve.cg import cg_fixed

        for name in ("quad", "hex"):
            A_p, hier = keep.pop(name)
            b_p = A_p.matvec(torch.ones(A_p.shape[0], dtype=A_p.dtype,
                                        device=dev))
            _time_ell_shape(records, f"quad_hex {name}", A_p)
            _check_ell_levels(records, f"quad_hex {name}", hier, dev)
            _per_iteration(f"quad_hex {name}",
                           lambda: cg_fixed(A_p.matvec, b_p, 10,
                                            M=hier.apply))
            del A_p, hier, b_p
            torch.cuda.empty_cache()

    return after


# -- the physics solvers (ROADMAP A4a-c) -------------------------------------

# examples/nonlinear_poisson.py's default: rectangle_mesh(-3,3,-3,3,512,512)
# (263,169 DOFs), fp32, Jacobi, tol 1e-6, maxiter 40, from x0 = 0.  The JAX
# package's own CPU run of the same script (fp32, XLA gather products):
#   python scripts/physics_jax_reference.py nonlinear 512
# prints 6 Newton steps, 580 inner CG iterations, relres 2.6996e-07 and a
# rel L2 error of 7.2152e-06 (the TPU's phase 9: 6, 580 and 7.2e-6).
N_NONLINEAR = 512
NONLINEAR_DOFS = 263_169
JAX_NONLINEAR = {"newton": 6, "inner": 580, "relres": 2.6996e-07,
                 "error": 7.2152e-06}
# the same with --precond amg (the frozen interval-W AMG of the linear
# part), the JAX package's CPU run of the same command:
#   python scripts/physics_jax_reference.py nonlinear_amg 512
# 5 Newton steps, 396 inner CG iterations, relres 8.1752e-07, rel L2 error
# 1.5645e-05 (beside the Jacobi run's 7.2152e-06: it stops at a relres
# three times higher, just under the 1e-6 tolerance).  Its inner count is
# held within the spread of the two packages' CPU runs (10% beyond each
# end), not within 10% of the JAX run alone: the frozen AMG of the linear
# part preconditions the reaction-dominated Jacobian poorly, so each inner
# CG nearly stalls near its Eisenstat-Walker tolerance, and that tolerance
# follows the fp32 residual norms, whose terms (u³ ~ 5e5) dwarf them.  Per
# Newton step (python scripts/physics_jax_reference.py nonlinear_steps 512
# amg), the JAX CPU run takes 12, 8, 8, 112, 256 inner iterations at
# tolerances 0.1, 0.049079, 0.1, 0.008205, 4.460e-4; the port's CPU run
# (four torch threads) 12, 8, 8, 92, 208 (328) at 0.1, 0.049106, 0.1,
# 0.008493, 5.153e-4: the first step's fp32 rounding moves the second
# tolerance by 6e-4 and the fourth by 3.5%, and the fourth count by 18%.
# The port's own count moves with the host's threads: python -m
# tpufem_torch.examples.nonlinear_poisson --n 512 --precond amg --device
# cpu with OMP_NUM_THREADS=4 and torch's default threads takes 336, the
# figure kept below.  (In fp64 at n = 40 the two packages' counts differ
# by up to two check batches for the same reason.)
JAX_NONLINEAR_AMG = {"newton": 5, "inner": 396, "relres": 8.1752e-07,
                     "error": 1.5645e-05, "port_cpu_inner": 336}
# examples/wave_equation.py --cells 1000 --periods 1 (1,002,001 DOFs, fp32:
# the TPU's run had x64 off; BENCH_NOTES.md:809-812: 2212 steps, energy
# drift 1.56e-3, period-return error 8e-4, 4305 steps/s); the fp64 case at
# --cells 64 (tests/test_dynamics.py pins the drift near 1e-12).  The JAX
# package's own CPU run of the same script in fp32, and of its steps on the
# stiffness and mass assembled in fp64 and cast to fp32:
#   python scripts/physics_jax_reference.py wave 1000
# (2212 steps; drift 5.6260e-03 and 5.6946e-03, period-return error
# 2.5935e-03 and 3.9545e-06).  scripts/wave_operator_swap.py steps either
# package's fp32 and cast operators with the port's leapfrog_wave: the
# return error follows the operator (its fp32 assembly leaves interior row
# sums near 6e-7 where the cast's are 0), the drift follows the stepping's
# fp32 energy dots.  The fp32 return error is so held to the JAX CPU run's,
# not to the 2e-3 target, which the cast case keeps.
WAVE_CELLS, WAVE_CELLS_FP64 = 1000, 64
WAVE_DOFS = 1_002_001
JAX_WAVE = {"steps": 2212, "drift": 5.6260e-03, "ret": 2.5935e-03,
            "cast_drift": 5.6946e-03, "cast_ret": 3.9545e-06}
# examples/modal_analysis.py --n 1000: k = 5, buffer 3, 20 inner AMG-PCG
# iterations, 25 outer steps, mixed precision (BENCH_NOTES.md:1042-1049,
# the TPU's G2: eigenvalue error 0.26%, max residual 3.1e-3)
N_MODAL = 1000
MODAL_K, MODAL_BUFFER, MODAL_INNER, MODAL_OUTER = 5, 3, 20, 25
# examples/modal_analysis.py --n 300 --serial (90,601 DOFs: the
# column-serial inner solves, AMG, mixed precision), gated by the
# example's own 5e-3 + 40 / n², its eigenvalues within 1e-5 of the
# largest of the JAX package's CPU run of the same command (each run
# draws its own start, and 25 outer steps converge both to the same
# discrete modes at fp32 resolution):
#   python scripts/physics_jax_reference.py modal_serial 300
N_MODAL_SERIAL, MODAL_SERIAL_DOFS = 300, 90_601
JAX_MODAL_SERIAL = {"error": 1.7180396852303767e-04,
                    "max_residual": 9.535609985658657e-05,
                    "eigenvalues": [0.54825383, 1.37060213, 1.37060547,
                                    2.19295073, 2.74108577]}


def _drive_nonlinear():
    """examples/nonlinear_poisson.py at its default size through its
    port's main (--n 512: -Δu + u³ = f on (-3,3)², exact solution
    (9-x²)(9-y²), the ELL stiffness, the semilinear load through
    element_nonlinear_load, Jacobi, newton_krylov to 1e-6, maxiter 40,
    from 0 in fp32, run twice).  Gates: converged, the Newton and inner CG
    counts of the JAX package's CPU run within 1 and 10%, rel L2 error <=
    2e-5, the second run's x bit for bit the first, cold one's; the inner
    CG's products run B9 (on the primal and the tangent of each dual
    residual)."""
    out, _ = _example("nonlinear_poisson", ["--n", str(N_NONLINEAR)])
    return _nonlinear_gates("nonlinear", out, JAX_NONLINEAR)


def _drive_nonlinear_amg(dev, records):
    """nonlinear_poisson --n 512 --precond amg through its port's main: the
    inner CG preconditioned by the frozen interval-W AMG of the linear
    part (build_amg(A_bc, aggregation="interval", cycle="W")).  Gates as
    the Jacobi run's, against the JAX package's CPU run of the same
    command (JAX_NONLINEAR_AMG), but the inner count within 10% beyond
    the spread of the two packages' CPU runs (its comment gives why);
    every level of the hierarchy is then checked and timed (B9, B10) and
    10 inner iterations profiled."""
    out, _ = _example("nonlinear_poisson", ["--n", str(N_NONLINEAR),
                                            "--precond", "amg"])
    hier = out["hier"]
    print(f"# nonlinear_amg hierarchy: levels "
          f"{[lv.A.shape[0] for lv in hier.levels]} + coarse "
          f"{hier.coarse_inv.shape[0]} rows, operator complexity "
          f"{hier.operator_complexity:.4f}, gamma {hier.gamma}")
    after = _nonlinear_gates("nonlinear_amg", out, JAX_NONLINEAR_AMG)

    def then():
        _check_ell_levels(records, "nonlinear_amg", hier, dev)
        after()

    return then


def _nonlinear_gates(name, out, jax):
    """The nonlinear example's gates against the JAX CPU figures ``jax``;
    returns its per-iteration profile (the inner CG at the solution: each
    iteration one dual residual, the primal paid again beside the tangent,
    and the preconditioner)."""
    import torch

    from tpufem_torch.solve.cg import cg_fixed
    from tpufem_torch.solve.newton import _tangent_map
    from tpufem_torch.sparse import ell_cuda

    res, cold = out["result"], out["cold"]
    check(out["dofs"] == NONLINEAR_DOFS, f"{name}: {out['dofs']} DOFs")
    check(isinstance(out["A"]._band, tuple), f"{name}: no banded plan")
    check((cold.iterations, cold.inner_iterations)
          == (res.iterations, res.inner_iterations)
          and torch.equal(cold.x, res.x),
          f"{name}: a second solve differs from the first")
    err = out["rel_l2_error_vs_exact"]
    wall = out["solve_s"]
    spread = (jax["inner"], jax.get("port_cpu_inner", jax["inner"]))
    cpu_runs = f"JAX CPU {jax['inner']}" + (
        f", the port's CPU run {jax['port_cpu_inner']}"
        if "port_cpu_inner" in jax else "")
    print(f"# {name} (n={N_NONLINEAR}, {out['dofs']:,} DOFs, fp32, "
          f"{out['precond']}, tol 1e-6): {res.iterations} Newton steps (JAX "
          f"CPU {jax['newton']}), {res.inner_iterations} inner CG "
          f"iterations ({cpu_runs}), relres "
          f"{res.residual_norm.item():.4e} (JAX CPU {jax['relres']:.4e}), "
          f"converged {res.converged}, rel L2 error {err:.4e} (JAX CPU "
          f"{jax['error']:.4e}); solve wall {wall:.3f} s (the first, cold "
          f"solve {out['walls_s']['compile']:.2f} s, the same x bit for "
          f"bit), {1e3 * wall / max(res.inner_iterations, 1):.4f} ms per "
          f"inner iteration with the line searches; B9 launches in both "
          f"runs {ell_cuda.ell_matvec_cuda.launches}; host mesh and pattern "
          f"{out['walls_s']['host']:.2f} s")
    check(res.converged, f"{name}: not converged")
    check(abs(res.iterations - jax["newton"]) <= 1,
          f"{name}: {res.iterations} Newton steps, JAX {jax['newton']}")
    check(0.9 * min(spread) <= res.inner_iterations <= 1.1 * max(spread),
          f"{name}: {res.inner_iterations} inner iterations, the CPU runs "
          f"{spread}")
    check(err <= 2e-5, f"{name}: rel L2 error {err:.3e} > 2e-5")

    x, residual, M = res.x, out["residual"], out["M"]

    def after():
        jmv = _tangent_map(residual, x)
        r = residual(x)
        _per_iteration(name, lambda: cg_fixed(jmv, -r, 10, M=M))

    return after


def _wave_case(cells, dtype, dev, cast=False):
    """examples/wave_equation.py --cells ``cells`` composed from the port:
    the unit square's P1 stiffness from the weak form (ELL), the lumped
    mass, stable_dt's step, leapfrog_wave over one period of the (1,1)
    standing mode; with ``cast`` the stiffness and the mass are assembled
    in fp64 and cast to ``dtype``.  Returns its numbers and a closure that
    reruns it for a given number of steps."""
    import numpy as np
    import torch

    from tpufem_torch.fem.space import FunctionSpace
    from tpufem_torch.forms.language import dot, grad
    from tpufem_torch.forms.weakform import WeakForm
    from tpufem_torch.mesh.rectangle import unit_square_mesh
    from tpufem_torch.solve.dynamics import (leapfrog_wave, lumped_mass,
                                             stable_dt)
    from tpufem_torch.sparse import ell_cuda
    from tpufem_torch.sparse.ell import ELLMatrix

    t0 = time.perf_counter()
    mesh = unit_square_mesh(cells, cells)
    V = FunctionSpace(mesh, degree=1)
    asm = torch.float64 if cast else dtype
    K, _ = WeakForm(V, dtype=asm, device=dev).build(
        lambda u, v: dot(grad(u), grad(v))).assemble(format="ell")
    mL = lumped_mass(V, asm, device=dev)
    if cast:
        K = ELLMatrix(K.data.to(dtype), K.cols, K.row_lengths, K.diag_pos)
        mL = mL.to(dtype)
    mask = torch.as_tensor(V.dof_flags, device=dev)
    c = mesh.coords
    u0 = torch.where(mask, 0.0, torch.as_tensor(
        np.sin(np.pi * c[:, 0]) * np.sin(np.pi * c[:, 1]), dtype=dtype,
        device=dev))
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0

    omega = np.sqrt(2.0) * np.pi
    period = 2 * np.pi / omega
    t0 = time.perf_counter()
    dt_cap = stable_dt(K.matvec, mL)
    t_dt = time.perf_counter() - t0
    steps = int(np.ceil(period / dt_cap))
    dt = period / steps
    v0 = torch.zeros_like(u0)
    b9 = ell_cuda.ell_matvec_cuda.launches
    t0 = time.perf_counter()
    res = leapfrog_wave(K.matvec, mL, u0, v0, dt, steps, bc_mask=mask)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    b9 = ell_cuda.ell_matvec_cuda.launches - b9
    e = res.energy.double()
    drift = ((e - e[0]).abs().max() / e[0].abs()).item()
    ret = (torch.linalg.vector_norm((res.u - u0).double())
           / torch.linalg.vector_norm(u0.double())).item()
    return dict(dofs=V.num_dofs, steps=steps, dt=dt, drift=drift, ret=ret,
                wall=wall, b9=b9, t_build=t_build, t_dt=t_dt,
                banded=isinstance(K._band, tuple),
                run=lambda s: leapfrog_wave(K.matvec, mL, u0, v0, dt, s,
                                            bc_mask=mask))


def _wave_example():
    """wave_equation --cells 1000 --periods 1 through its port's main (fp32,
    torch's default dtype; a cold run, then the timed one): _wave_case's
    numbers, the drift and the return error summed in fp64 from the state
    it returns, B9's launches counted from the path's start (stable_dt's
    50 products, then the two runs)."""
    import torch

    from tpufem_torch.solve.dynamics import leapfrog_wave
    from tpufem_torch.sparse import ell_cuda

    out, _ = _example("wave_equation", ["--cells", str(WAVE_CELLS),
                                        "--periods", "1"])
    res, u0, K, mL = out["result"], out["u0"], out["K"], out["mL"]
    mask, dt, steps = out["mask"], out["dt"], out["steps"]
    check(res.u.dtype == torch.float32, f"wave: {res.u.dtype}")
    e = res.energy.double()
    v0 = torch.zeros_like(u0)
    return dict(
        dofs=out["dofs"], steps=steps, dt=dt,
        drift=((e - e[0]).abs().max() / e[0].abs()).item(),
        ret=(torch.linalg.vector_norm((res.u - u0).double())
             / torch.linalg.vector_norm(u0.double())).item(),
        wall=out["wall_s"], b9=ell_cuda.ell_matvec_cuda.launches,
        b9_expected=50 + 2 * (steps + 1), t_build=out["walls_s"]["build"],
        t_dt=out["walls_s"]["stable_dt"], banded=isinstance(K._band, tuple),
        run=lambda s: leapfrog_wave(K.matvec, mL, u0, v0, dt, s,
                                    bc_mask=mask))


def _drive_wave(dev):
    """examples/wave_equation.py --cells 1000 --periods 1 in fp32 (1,002,001
    DOFs) through its port's main: stable_dt sets the step (printed beside
    the TPU's 2212), energy drift <= 5e-3 and the period-return error
    within 10% of the JAX package's CPU run of the same script (JAX_WAVE:
    its fp32 assembly's rounding sets it); composed from the port (not
    options of the example), the same steps on the stiffness and mass
    assembled in fp64 and cast to fp32: drift <= 5e-3, return error <=
    2e-3; then fp64 at --cells 64 and 1000: drift <= 1e-10.  B9 launches
    once per step plus the start in each run (and stable_dt's 50 products
    before the example's two runs)."""
    import torch

    kind = torch.cuda.get_device_name(0)
    jax = JAX_WAVE
    cases = {"fp32": _wave_example(),
             "fp64 assembly cast to fp32": _wave_case(
                 WAVE_CELLS, torch.float32, dev, cast=True),
             f"fp64 cells {WAVE_CELLS_FP64}": _wave_case(
                 WAVE_CELLS_FP64, torch.float64, dev),
             "fp64": _wave_case(WAVE_CELLS, torch.float64, dev)}
    for name, w in cases.items():
        print(f"# wave {name} ({w['dofs']:,} DOFs): {w['steps']} steps of dt "
              f"{w['dt']:.4e}, energy drift {w['drift']:.3e}, period-return "
              f"error {w['ret']:.3e}, wall {w['wall']:.3f} s, "
              f"{w['steps'] / w['wall']:.1f} steps/s on {kind}; B9 launches "
              f"{w['b9']}; weak-form build and lumped mass {w['t_build']:.2f} "
              f"s, stable_dt {w['t_dt']:.2f} s")
        check(w["banded"], f"wave {name}: no banded plan")
        check(w["b9"] == w.get("b9_expected", w["steps"] + 1),
              f"wave {name}: {w['b9']} B9 launches for {w['steps']} steps")
    w, wc = cases["fp32"], cases["fp64 assembly cast to fp32"]
    print(f"# wave fp32 beside the references: steps {w['steps']} (TPU 2212, "
          f"JAX CPU {jax['steps']}), drift {w['drift']:.3e} (JAX CPU "
          f"{jax['drift']:.3e}, TPU 1.56e-3), period-return error "
          f"{w['ret']:.3e} (JAX CPU {jax['ret']:.3e}, TPU 8e-4; the 2e-3 "
          f"target {'met' if w['ret'] <= 2e-3 else 'accepted deviation'} "
          f"(ROADMAP C: the port is held to the JAX CPU run on the same fp32 "
          f"operator), gated at 1.1 x JAX CPU; on the fp64 "
          f"assembly cast {wc['ret']:.3e}, JAX CPU {jax['cast_ret']:.3e}), "
          f"{w['steps'] / w['wall']:.1f} steps/s (TPU 4305, not a target)")
    check(w["dofs"] == WAVE_DOFS, f"wave: {w['dofs']} DOFs")
    check(w["drift"] <= 5e-3, f"wave: energy drift {w['drift']:.3e}")
    check(w["ret"] <= 1.1 * jax["ret"],
          f"wave: period-return error {w['ret']:.3e}, JAX CPU "
          f"{jax['ret']:.3e}")
    check(wc["drift"] <= 5e-3 and wc["ret"] <= 2e-3,
          f"wave cast: drift {wc['drift']:.3e}, return {wc['ret']:.3e}")
    for name in (f"fp64 cells {WAVE_CELLS_FP64}", "fp64"):
        check(cases[name]["drift"] <= 1e-10,
              f"wave {name}: energy drift {cases[name]['drift']:.3e}")
    run = w["run"]
    return lambda: _per_iteration("wave", lambda: run(10))


@contextlib.contextmanager
def _multi_widths():
    """The widths q of the multi-column ELL products in the block: B10's
    banded ones and B10g's (the absolute-column form), as ELLMatrix and
    ell_matvec_multi call them: {"banded": {q: calls}, "hi": {q: calls}}."""
    from tpufem_torch.sparse import ell as ell_mod

    widths = {"banded": {}, "hi": {}}
    real = {"banded": ell_mod.ell_matvec_multi_cuda,
            "hi": ell_mod.ell_gather_matvec_multi_cuda}

    def counting(kind):
        def call(*args, **kw):
            q = args[-1].shape[1]
            widths[kind][q] = widths[kind].get(q, 0) + 1
            return real[kind](*args, **kw)
        return call

    ell_mod.ell_matvec_multi_cuda = counting("banded")
    ell_mod.ell_gather_matvec_multi_cuda = counting("hi")
    try:
        yield widths
    finally:
        ell_mod.ell_matvec_multi_cuda = real["banded"]
        ell_mod.ell_gather_matvec_multi_cuda = real["hi"]


def _drive_modal(dev, records):
    """examples/modal_analysis.py --n 1000 through its port's main: the
    perturbed mesh RCM-renumbered (1,002,001 DOFs), the fp64 ELL stiffness
    with its Dirichlet rows eliminated and the lumped mass (unit mass on
    the constrained rows), the fp32 cast on its banded plan,
    build_amg(strength=0.08) on it, and the mixed-precision subspace
    iteration: k = 5, buffer 3, 20 inner AMG-PCG iterations in lockstep
    (cg_fixed_block over B10 at q = 8, the V-cycle's apply_multi), 3
    refinement rounds with fp64 residuals (B10's absolute-column form on
    the fp64 values), 25 outer steps, run cold and then timed.  Gates: the
    eigenvalues within 5e-3 + 40 / n² of pi² (i² + j²) / 36 (the
    example's), max residual <= 1e-2; B10 banded at q = 8 and absolute in
    fp64 at q = 8 and q = 5."""
    import numpy as np
    import torch

    from tpufem_torch.solve.cg import cg_fixed_block
    from tpufem_torch.sparse import ell_cuda
    from tpufem_torch.utils.timing import cuda_ms

    with _multi_widths() as widths:
        out, _ = _example("modal_analysis", ["--n", str(N_MODAL)])
    b10 = (ell_cuda.ell_matvec_multi_cuda.launches,
           ell_cuda.ell_gather_matvec_multi_cuda.launches)
    res, A32, data64 = out["result"], out["A"], out["data64"]
    mL, X, hier = out["mL"], out["X"], out["hier"]
    nn = out["dofs"]
    check(nn == ELL_ROWS, f"modal: {nn} DOFs")
    check(isinstance(A32._band, tuple), "modal: no banded plan")
    check(out["precision"] == "mixed" and out["mode"] == "batched"
          and out["outer_chunk"] == 5 and out["outer_iters"] == MODAL_OUTER,
          f"modal: {out['precision']}, {out['mode']}, chunk "
          f"{out['outer_chunk']}, {out['outer_iters']} outer steps")
    walls = out["walls_s"]
    _print_hierarchy("modal", walls["precond_setup_detail"],
                     walls["precond_setup"])
    check(walls["precond_setup_detail"]["gather"] == [],
          f"modal: a matrix rode the gather form: "
          f"{walls['precond_setup_detail']['gather']}")
    q = MODAL_K + MODAL_BUFFER
    lam = res.eigenvalues.cpu().numpy()
    exact = np.array(sorted(np.pi ** 2 / 36 * (i * i + j * j)
                            for i in range(1, 6)
                            for j in range(1, 6)))[:MODAL_K]
    lam_err = float(np.abs(lam - exact).max() / exact.max())
    max_res = res.residual_norms.max().item()
    gate = 5e-3 + 40.0 / (N_MODAL * N_MODAL)
    solve_s = out["solve_ms"] / 1e3
    print(f"# modal (n={N_MODAL}, {nn:,} DOFs, k={MODAL_K}, buffer "
          f"{MODAL_BUFFER}, {MODAL_INNER} inner AMG-PCG iterations in "
          f"lockstep, {MODAL_OUTER} outer steps in chunks of "
          f"{out['outer_chunk']}, mixed precision): eigenvalues "
          f"{np.round(lam, 8).tolist()} (exact {np.round(exact, 8).tolist()}"
          f"), rel eigenvalue error {lam_err:.4e} (gate {gate:.4e}; TPU G2 "
          f"2.6e-3), max residual {max_res:.4e} (TPU 3.1e-3); solve wall "
          f"{solve_s:.3f} s ({1e3 * solve_s / MODAL_OUTER:.2f} ms per outer "
          f"step; the cold pass {walls['solve_compile']:.2f} s); B10 banded "
          f"launches in both passes {b10[0]} (by width: "
          f"{widths['banded']}), B10 absolute (fp64) launches {b10[1]} (by "
          f"width: {widths['hi']}); walls (s) " + json.dumps(
              {k: v for k, v in walls.items()
               if k != "precond_setup_detail"}))
    check(lam_err <= gate, f"modal: rel eigenvalue error {lam_err:.3e} > "
                           f"{gate:.3e}")
    check(max_res <= 1e-2, f"modal: max residual {max_res:.3e} > 1e-2")
    check(widths["banded"].get(q, 0) > 0 and b10[0] > 0,
          f"modal: B10 banded never ran at q = {q}")
    check(widths["hi"].get(q, 0) > 0 and widths["hi"].get(MODAL_K, 0) > 0
          and b10[1] == sum(widths["hi"].values()),
          f"modal: B10 absolute at q = {q} / {MODAL_K}: {widths['hi']}, "
          f"{b10[1]} launches")
    del out

    def after():
        gen = torch.Generator(device=dev).manual_seed(13)
        Xq = torch.randn((nn, q), generator=gen, device=dev,
                         dtype=torch.float64)
        cols = A32.cols
        k = cols.shape[1]
        # the bound on the bytes the nonzeros need (each nonzero's value
        # and index, X and Y once), the padded plan's printed beside
        nnz = int((data64 != 0).sum())
        xy = 2 * nn * q * 8
        needed, padded = nnz * (8 + 4) + xy, k * nn * (8 + 4) + xy
        print(f"# modal B10g bounds: needed "
              f"{needed / HBM_BYTES_PER_S * 1e3:.4f} ms ({nnz} nonzeros, "
              f"{needed / 1e6:.1f} MB), padded "
              f"{padded / HBM_BYTES_PER_S * 1e3:.4f} ms ({k} slots, "
              f"{padded / 1e6:.1f} MB)")
        label = f"modal {nn} rows fp64 absolute columns q={q}"

        def kernel():
            return ell_cuda.ell_gather_matvec_multi_cuda(data64, cols, Xq)

        _compare(records, "B10g", label, kernel,
                 lambda: ell_cuda.ell_gather_matvec_multi_plain(data64, cols,
                                                                Xq),
                 exact=True, timed=True, shapes=True,
                 work=([needed - nn * q * 8], 2 * nnz * q, "float64"),
                 library=_library_ell(data64, cols, Xq, nonzeros=True))
        ref = kernel()
        pad_ms = _library_ms(_library_ell(data64, cols, Xq), ref,
                             f"B10g {label} (CSR of the padded rows)")
        reps = [cuda_ms(kernel, reps=REPS) for _ in range(3)]
        print("# modal B10g: CSR of the padded rows "
              + ("failed" if pad_ms is None else f"{pad_ms:.4f} ms")
              + "; three more device timings of the kernel (ms) "
              + ", ".join(f"{t:.4f}" for t in reps))
        del ref
        B = (mL[:, None] * X).float()
        _per_iteration("modal", lambda: cg_fixed_block(
            A32.matvec_multi, B, 10, M_multi=hier.apply_multi))

    return after


def _drive_modal_serial():
    """modal_analysis --n 300 --serial through its port's main: the
    example's own gate (its eigenvalue error within 5e-3 + 40 / n², or
    main exits), the eigenvalues within 1e-5 of the largest of the JAX
    package's CPU run (JAX_MODAL_SERIAL); the
    column-serial inner solves and the V-cycles run B9, the fp64
    refinement products B10g, and B10 (the banded multi-column product)
    never launches."""
    from tpufem_torch.sparse import ell_cuda

    out, wall = _example("modal_analysis", ["--n", str(N_MODAL_SERIAL),
                                            "--serial"])
    b9, b10, b10g = (ell_cuda.ell_matvec_cuda.launches,
                     ell_cuda.ell_matvec_multi_cuda.launches,
                     ell_cuda.ell_gather_matvec_multi_cuda.launches)
    jax = JAX_MODAL_SERIAL
    gate = 5e-3 + 40.0 / (N_MODAL_SERIAL * N_MODAL_SERIAL)
    print(f"# modal_serial (n={N_MODAL_SERIAL}, {out['dofs']:,} DOFs, "
          f"column-serial AMG-PCG, mixed precision): rel eigenvalue error "
          f"{out['rel_eig_err_vs_analytic']:.4e} (gate {gate:.4e}; JAX CPU "
          f"{jax['error']:.4e}), max residual {out['max_residual']:.4e} (JAX "
          f"CPU {jax['max_residual']:.4e}), eigenvalues {out['eigenvalues']} "
          f"(JAX CPU {jax['eigenvalues']}); solve {out['solve_ms']:.1f} ms, "
          f"cold pass {out['walls_s']['solve_compile']:.2f} s, main "
          f"{wall:.2f} s; launches in both passes: B9 {b9}, B10 {b10}, "
          f"B10g {b10g}")
    check(out["dofs"] == MODAL_SERIAL_DOFS and out["mode"] == "serial"
          and out["precision"] == "mixed",
          f"modal_serial: {out['dofs']} DOFs, {out['mode']}, "
          f"{out['precision']}")
    check(out["rel_eig_err_vs_analytic"] <= gate,
          f"modal_serial: error {out['rel_eig_err_vs_analytic']:.3e}")
    lam, ref = out["eigenvalues"], jax["eigenvalues"]
    check(max(abs(a - b) for a, b in zip(lam, ref)) <= 1e-5 * max(ref),
          f"modal_serial: eigenvalues {lam}, JAX CPU {ref}")
    check(b10 == 0, f"modal_serial: B10 launched {b10} times")


def _drive_coo_matfree(dev, records, keep):
    """COO assembly at examples/generic_assembly_20m.py's scale (20,000,000
    triangles, 10,011,001 nodes, fp32): assemble_coo into the pattern's
    unique keys, its row sums (< 1e-5 of max |a|) and its agreement with
    assemble_ell on the same pattern (1e-4 of max |a|), a second run bit
    for bit; then on the unstructured path's RCM-ordered 1000 x 1000 mesh
    (fp32) the matrix-free operators (poisson_operator with on_the_fly both
    ways, element_operator) against B9's product (1e-5 relative), a
    10-iteration fixed CG on each against the ELL one, their product times
    beside B9's, each product twice bit for bit; and
    greedy_element_coloring on the same generator's 125 x 125 and 250 x
    250 meshes (no two elements of one color share a node)."""
    import numpy as np
    import torch

    from tpufem_torch.assemble.coo import assemble_coo
    from tpufem_torch.assemble.dense import assemble_vector
    from tpufem_torch.assemble.ell import assemble_ell
    from tpufem_torch.assemble.local import element_load, p1_stiffness
    from tpufem_torch.fem.elements import P1Triangle
    from tpufem_torch.fem.quadrature import triangle_rule
    from tpufem_torch.mesh.adjacency import (ell_pattern,
                                             greedy_element_coloring,
                                             pattern_unique_keys)
    from tpufem_torch.mesh.rectangle import (perturbed_rectangle_mesh,
                                             rectangle_mesh)
    from tpufem_torch.solve.bc import apply_dirichlet_ell
    from tpufem_torch.solve.cg import cg_fixed
    from tpufem_torch.solve.poisson import model_problem_2d
    from tpufem_torch.sparse.matfree import element_operator, poisson_operator
    from tpufem_torch.utils.timing import PhaseTimer, cuda_ms

    el = P1Triangle()
    timer = PhaseTimer()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with timer("host_mesh"):
        mesh = rectangle_mesh(-3.0, 3.0, -3.0, 3.0, N_COO_Y, N_COO_X)
    ne, nn = mesh.num_elements, mesh.num_nodes
    check((ne, nn) == (COO_ELEMENTS, COO_NODES),
          f"coo: {ne} elements, {nn} nodes")
    with timer("pattern"):
        pat = ell_pattern(mesh.conn, nn, pad_to=8, with_sort_plan=False)
    with timer("unique_keys"):
        keys = pattern_unique_keys(pat)
    with timer("element_coords"):
        ec = torch.as_tensor(mesh.element_coords(), dtype=torch.float32,
                             device=dev)
        conn = torch.as_tensor(mesh.conn, device=dev)
        keys_t = torch.as_tensor(keys, device=dev)
        torch.cuda.synchronize()
    with timer("stiffness"):
        Ke = p1_stiffness(ec, el)
        del ec
        torch.cuda.synchronize()
    with timer("assemble_coo"):
        vals = assemble_coo(conn, Ke, keys_t, nn)
        torch.cuda.synchronize()
    again = assemble_coo(conn, Ke, keys_t, nn)
    same = torch.equal(again, vals)
    del again
    rows = keys_t // nn
    scale = vals.abs().max().item()
    row_sum = torch.zeros(nn, dtype=torch.float64, device=dev).index_add_(
        0, rows, vals.double()).abs().max().item() / scale
    with timer("assemble_ell"):
        A = assemble_ell(pat, Ke)
        torch.cuda.synchronize()
    real = torch.as_tensor(np.arange(pat.width)[None, :]
                           < pat.row_lengths[:, None], device=dev)
    d_ell = (A.data[real] - vals).abs().max().item() / scale
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"# coo_matfree COO: {ne} triangles, {nn} nodes, {keys.size} "
          f"unique entries (fp32): max |row sum| / max |a| {row_sum:.3e} "
          f"(gate < 1e-5), max |COO - ELL| / max |a| {d_ell:.3e} (gate "
          f"<= 1e-4), a second run bit-identical: {same}; phases (s): "
          + json.dumps({k: round(v, 4) for k, v in timer.report().items()})
          + f"; peak device memory {peak_gb:.3f} GB")
    check(row_sum < 1e-5, f"coo: row sums {row_sum:.3e}")
    check(d_ell <= 1e-4, f"coo: against assemble_ell {d_ell:.3e}")
    check(same, "coo: a second assembly differs")
    del vals, A, Ke, conn, keys_t, rows, real, pat, keys, mesh
    torch.cuda.empty_cache()

    # the matrix-free operators on the unstructured path's mesh
    mesh = keep.pop("unstructured_mesh")
    nn = mesh.num_nodes
    pat = ell_pattern(mesh.conn, nn, pad_to=8, with_sort_plan=False)
    ec = torch.as_tensor(mesh.element_coords(), dtype=torch.float32,
                         device=dev)
    Ke = p1_stiffness(ec, el)
    A = assemble_ell(pat, Ke)
    A.resolve_band()
    check(isinstance(A._band, tuple), "matfree: the ELL operator has no "
                                      "banded plan")
    t0 = time.perf_counter()
    ops = {"poisson_operator": poisson_operator(ec, mesh.conn, nn, el),
           "poisson_operator(on_the_fly=True)": poisson_operator(
               ec, mesh.conn, nn, el, on_the_fly=True),
           "element_operator": element_operator(mesh.conn, Ke, nn)}
    torch.cuda.synchronize()
    print(f"# coo_matfree matrix-free setup (host node-sum plans, "
          f"3 operators): {time.perf_counter() - t0:.2f} s")
    gen = torch.Generator(device=dev).manual_seed(13)
    x = torch.randn(nn, generator=gen, device=dev)
    y_ell = A.matvec(x)
    ell_ms = cuda_ms(lambda: A.matvec(x), reps=REPS)
    bc = torch.as_tensor(mesh.node_flags != 0, device=dev)
    b = assemble_vector(mesh.conn, element_load(
        ec, el, triangle_rule(5), model_problem_2d()[0]), nn)
    A_bc, b_bc = apply_dirichlet_ell(A, b, bc)
    x_ell = cg_fixed(A_bc.matvec, b_bc, 10)[0]
    for name, op in ops.items():
        y = op(x)
        d = ((y - y_ell).abs().max() / y_ell.abs().max()).item()
        rep = torch.equal(op(x), y)
        ms = cuda_ms(lambda: op(x), reps=REPS)

        def op_bc(v, op=op):
            return torch.where(bc, v, op(torch.where(bc, 0.0, v)))

        x_mf = cg_fixed(op_bc, b_bc, 10)[0]
        dx = ((x_mf - x_ell).abs().max() / x_ell.abs().max()).item()
        print(f"# coo_matfree {name}: max |y - y_B9| / max |y_B9| {d:.3e} "
              f"(gate <= 1e-5), a second product bit-identical: {rep}; "
              f"10 fixed CG iterations against the ELL ones: max rel "
              f"difference {dx:.3e} (gate <= 1e-4); product {ms:.4f} ms "
              f"(B9 {ell_ms:.4f} ms; CUDA events, stream queued ahead)")
        check(d <= 1e-5 and rep, f"coo_matfree {name}: {d:.3e}, {rep}")
        check(dx <= 1e-4, f"coo_matfree {name}: CG differs {dx:.3e}")
    del ops, A, A_bc, Ke, ec
    torch.cuda.empty_cache()
    # the coloring takes 6 n - 4 rounds on the generator's element order,
    # each over the elements left: O(n^3) host work (minutes at n = 1000);
    # it runs on the same generator's meshes at n = 125 and 250, whose
    # walls show the growth
    for n in COLOR_SIZES:
        cmesh = perturbed_rectangle_mesh(-3, 3, -3, 3, n, n, jitter=0.25,
                                         seed=0)
        t0 = time.perf_counter()
        colors = greedy_element_coloring(cmesh.conn, cmesh.num_nodes)
        wall = time.perf_counter() - t0
        ok = True
        for c in range(int(colors.max()) + 1):
            nodes = cmesh.conn[colors == c].ravel()
            ok &= np.unique(nodes).size == nodes.size
        print(f"# coo_matfree greedy_element_coloring n={n}: "
              f"{cmesh.num_elements} elements, {int(colors.max()) + 1} "
              f"colors, no node shared within a color: {ok}, host wall "
              f"{wall:.3f} s")
        check(ok and colors.min() == 0 and (colors >= 0).all(),
              f"coloring n={n}: a color shares a node")


# -- MINRES and Taylor-Hood Stokes (ROADMAP A4d) ------------------------------

# examples/stokes_cavity.py --n 360 --tol 1e-6: the regularized lid, fp32,
# the scalar-AMG velocity preconditioner (1,039,682 velocity and 130,321
# pressure DOFs).  The TPU's run (BENCH_NOTES.md:1053-1062; the reference's
# figures, not targets): 128 MINRES iterations to relres 8.9e-7, centerline
# u_x min -0.1688.  The JAX package's own CPU run of the same solve at n =
# 180 (x64 off, the XLA gather products):
#   python scripts/physics_jax_reference.py stokes 180
# gives the count the card's n = 180 run is held to exactly; n = 360 is
# held to the TPU's count within two check_every batches and to the n = 180
# centerline minimum within 1e-3.
N_STOKES, N_STOKES_MID, N_STOKES_SMALL = 360, 180, 48
STOKES_DOFS = {360: (1_039_682, 130_321), 180: (260_642, 32_761),
               48: (18_818, 2_401)}
TPU_STOKES = {"iterations": 128, "relres": 8.9e-7, "ux_min": -0.1688}
JAX_STOKES = {"iterations": 92, "relres": 7.895787348388694e-07,
              "ux_min": -0.1688971221446991}
# the same cavity at n = 48 in fp64 to tol 1e-8 (check_every 4), once per
# velocity preconditioner:
#   python scripts/physics_jax_reference.py stokes_small 48
# its counts, the norms of u and p, u at every 601st and p at every 151st
# DOF, and the projections of u and p on cos(0.37 k i), k = 1..4
JAX_STOKES_SMALL = {
    "jacobi": {
        "iterations": 1344, "u_norm": 19.06182167475533,
        "p_norm": 132.94370658110284,
        "u_samples": [
            0.0, 0.00825877256503254, -0.05984004869138291,
            0.04893070238241836, -0.16327704560114875, -0.16298997602224102,
            -0.02621332193238809, -0.12956487383226084, 8.176984757096401e-06,
            0.0008094000291243078, -0.009451911934463911,
            0.014191564923036417, -0.0511968766441269, 0.022763550943455554,
            -0.09988292867166639, -0.007157893341257999, -0.11900582147915943,
            -0.07501095456540002, -0.09012438781170552, -0.12808091860878304,
            -0.02913422533936162, -0.06214549937187605, -0.007675431892297671,
            0.16122577044628666, -0.056449963361021795, 0.24711728106866515,
            -0.017451364536332448, 0.13879472221203124, 0.18725092139270813,
            -0.03055774970031828, 0.4817463815850181, -0.024599265881752538
        ],
        "p_samples": [
            -0.29228094228931556, -0.3092039318591382, -0.3224691134093392,
            -0.3134403492903692, -0.2727938445266581, -0.17851013417417325,
            -0.00030173861321620743, 0.29139498030320626, 0.7167252075049922,
            1.2796839890854188, 1.9659539327179127, 2.7527654531050065,
            3.6439624390002106, -5.51850398061405, -6.24580900141189,
            -6.695127190770103
        ],
        "u_proj": [
            0.056452634391606915, -0.012086554150883694, 0.005752974269142119,
            -0.02788445001604016
        ],
        "p_proj": [
            -46.906107915792376, -3.076854113460194, 4.864076910110447,
            -1.3059850019755304
        ],
    },
    "amg": {
        "iterations": 88, "u_norm": 19.061821717698265,
        "p_norm": 132.94370673750993,
        "u_samples": [
            9.465160919824878e-12, 0.008258794060411419, -0.05984004281372941,
            0.04893068718914025, -0.16327705222806077, -0.16298997550121558,
            -0.026213283650413515, -0.1295648504127013, 8.184831654821244e-06,
            0.0008094091928301892, -0.0094519338763906, 0.014191551759048805,
            -0.05119687732267915, 0.022763527470484258, -0.09988293052295426,
            -0.007157885204917267, -0.11900583537571911, -0.07501095095116113,
            -0.09012436930465519, -0.12808091974004573, -0.029134215110394077,
            -0.06214548265459674, -0.007675438760035085, 0.16122576410039638,
            -0.056449949435161115, 0.2471172737969159, -0.01745135451450275,
            0.1387948040214933, 0.1872509408983454, -0.030557759744398144,
            0.48174637768359885, -0.02459926544039547
        ],
        "p_samples": [
            -0.29227081042537606, -0.30920373622408603, -0.3224691348655827,
            -0.3134400901661064, -0.2727935581131054, -0.1785100897617014,
            -0.000302215850447521, 0.2913948943921137, 0.7167254750252391,
            1.2796840916118968, 1.9659540629373078, 2.7527656971464927,
            3.643963704567522, -5.518503994931891, -6.245809348745395,
            -6.695127086887294
        ],
        "u_proj": [
            0.056452722304404124, -0.012086553933553484, 0.005752988861802533,
            -0.027884476828742538
        ],
        "p_proj": [
            -46.90608123515898, -3.076840863305148, 4.864091512695862,
            -1.305984776992199
        ],
    },
}


def _stokes_solve(n, dtype, tol, vprecond):
    """stokes_cavity --n n --tol tol --vprecond vprecond [--f64] through its
    port's main (the regularized lid, maxiter 50,000, check_every 4), with
    the operator and velocity hierarchy solve_stokes builds captured
    (solve.stokes's build_stokes and build_velocity_amg wrapped for the
    call): (solution, captured, wall of main, centerline u_x min)."""
    import torch

    from tpufem_torch.solve import stokes as st

    seen = {}
    real_op, real_amg = st.build_stokes, st.build_velocity_amg

    def capture_op(*args, **kw):
        seen["op"] = real_op(*args, **kw)
        return seen["op"]

    def capture_amg(*args, **kw):
        seen["amg"] = real_amg(*args, **kw)
        return seen["amg"]

    argv = ["--n", str(n), "--tol", str(tol), "--vprecond", vprecond]
    if dtype == torch.float64:
        argv.append("--f64")
    st.build_stokes, st.build_velocity_amg = capture_op, capture_amg
    try:
        out, wall = _example("stokes_cavity", argv)
    finally:
        st.build_stokes, st.build_velocity_amg = real_op, real_amg
    seen["mesh_s"] = out["walls_s"]["mesh"]
    sol = out["solution"]
    check(sol.u.dtype == dtype, f"stokes n={n}: {sol.u.dtype}")
    return sol, seen, wall, out["centerline_ux_min"]


def _stokes_line(name, n, sol, wall, ux_min):
    print(f"# {name} n={n} ({sol.V.num_dofs:,} velocity + "
          f"{sol.Q.num_scalar_dofs:,} pressure DOFs, "
          f"{str(sol.u.dtype).replace('torch.', '')}): "
          f"{sol.res.iterations} MINRES iterations, relres "
          f"{sol.res.residual_norm.item():.4e}, converged "
          f"{sol.res.converged}, centerline u_x min {ux_min:.6f}; wall "
          f"{wall:.2f} s; walls (s, each ending in a synchronize): "
          + _walls_json(sol.walls))


def _drive_stokes(dev, records):
    """examples/stokes_cavity.py through solve_stokes on the card: n = 180
    (fp32, AMG) held to the JAX package's CPU count exactly and its
    centerline minimum within 1e-3; then n = 360, the TPU's size: converged,
    relres <= 1e-6, the DOF counts, the TPU's count within 8 (two
    check_every batches) and the n = 180 JAX centerline minimum within
    1e-3.  The hierarchy's level products run B9."""
    import torch

    jax = JAX_STOKES
    sol, _, wall, ux = _stokes_solve(N_STOKES_MID, torch.float32, 1e-6,
                                     "amg")
    _stokes_line("stokes", N_STOKES_MID, sol, wall, ux)
    print(f"# stokes n={N_STOKES_MID} beside the JAX package's CPU run: "
          f"{jax['iterations']} iterations, relres {jax['relres']:.4e}, "
          f"centerline u_x min {jax['ux_min']:.6f}")
    check(sol.res.converged and sol.res.residual_norm.item() <= 1e-6,
          f"stokes n={N_STOKES_MID}: not converged")
    check((sol.V.num_dofs, sol.Q.num_scalar_dofs)
          == STOKES_DOFS[N_STOKES_MID], f"stokes n={N_STOKES_MID}: DOFs")
    check(sol.res.iterations == jax["iterations"],
          f"stokes n={N_STOKES_MID}: {sol.res.iterations} iterations, JAX "
          f"CPU {jax['iterations']}")
    check(abs(ux - jax["ux_min"]) <= 1e-3,
          f"stokes n={N_STOKES_MID}: centerline {ux:.6f}, JAX CPU "
          f"{jax['ux_min']:.6f}")
    del sol
    torch.cuda.empty_cache()

    sol, seen, wall, ux = _stokes_solve(N_STOKES, torch.float32, 1e-6,
                                        "amg")
    _stokes_line("stokes", N_STOKES, sol, wall, ux)
    tpu = TPU_STOKES
    print(f"# stokes n={N_STOKES} beside the references: iterations "
          f"{sol.res.iterations} (TPU {tpu['iterations']}), relres "
          f"{sol.res.residual_norm.item():.4e} (TPU {tpu['relres']:.1e}), "
          f"centerline u_x min {ux:.6f} (TPU {tpu['ux_min']}, the JAX CPU "
          f"run at n={N_STOKES_MID} {jax['ux_min']:.6f}); mesh "
          f"{seen['mesh_s']:.2f} s")
    detail = sol.walls["precond_setup_detail"]
    _print_hierarchy("stokes", detail, sol.walls["precond_setup"])
    print(f"# stokes walls: scalar system {detail['scalar_system']:.2f} s, "
          f"AMG setup {sol.walls['precond_setup']:.2f} s (the scalar "
          f"system included), operator build {sol.walls['build']:.2f} s, "
          f"solve {sol.walls['solve']:.3f} s, "
          f"{1e3 * sol.walls['solve'] / max(sol.res.iterations, 1):.4f} ms "
          "per MINRES iteration with the host reads")
    check(sol.res.converged and sol.res.residual_norm.item() <= 1e-6,
          f"stokes: not converged (relres "
          f"{sol.res.residual_norm.item():.3e})")
    check((sol.V.num_dofs, sol.Q.num_scalar_dofs) == STOKES_DOFS[N_STOKES],
          f"stokes: {sol.V.num_dofs} + {sol.Q.num_scalar_dofs} DOFs")
    check(abs(sol.res.iterations - tpu["iterations"]) <= 8,
          f"stokes: {sol.res.iterations} iterations, TPU "
          f"{tpu['iterations']}")
    check(abs(ux - jax["ux_min"]) <= 1e-3,
          f"stokes: centerline {ux:.6f}, JAX CPU at n={N_STOKES_MID} "
          f"{jax['ux_min']:.6f}")
    check(bool(torch.isfinite(sol.u).all() and torch.isfinite(sol.p).all()),
          "stokes: non-finite solution")

    op = seen["op"][0]
    hier, perm, inv = seen["amg"]
    V = sol.V
    del sol
    torch.cuda.empty_cache()

    def after():
        import numpy as np

        from tpufem_torch.examples.stokes_cavity import lid
        from tpufem_torch.solve.minres import minres
        from tpufem_torch.solve.stokes import velocity_amg_precond

        _time_ell_shape(records, "stokes", hier.levels[0].A)
        _check_ell_levels(records, "stokes", hier, dev)
        u_bc = torch.as_tensor(np.where(
            V.dof_flags, lid(V.scalar_dof_coords).reshape(-1), 0.0),
            dtype=torch.float32, device=dev)
        b = op.rhs(torch.zeros_like(u_bc), u_bc)
        M = velocity_amg_precond(op, hier, perm, inv, 2)
        _per_iteration("stokes", lambda: minres(
            op.matvec, b, tol=0.0, maxiter=10, M=M, check_every=10),
            solver="minres")

    return after


def _drive_stokes_small():
    """The cavity at n = 48 in fp64 to 1e-8, with "jacobi" and "amg":
    iterations equal to the JAX package's CPU counts, u and p within 1e-6
    relative of its solution (the norms, the sampled DOFs and the
    projections of JAX_STOKES_SMALL)."""
    import numpy as np
    import torch

    def rel(a, ref):
        a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
        return float(np.linalg.norm(a - ref) / np.linalg.norm(ref))

    for vprecond in ("jacobi", "amg"):
        sol, _, wall, ux = _stokes_solve(N_STOKES_SMALL, torch.float64, 1e-8,
                                         vprecond)
        ref = JAX_STOKES_SMALL[vprecond]
        u = sol.u.double().cpu().numpy()
        p = sol.p.double().cpu().numpy()
        i = np.arange(u.size, dtype=np.float64)
        j = np.arange(p.size, dtype=np.float64)
        errs = {"u_norm": rel([np.linalg.norm(u)], [ref["u_norm"]]),
                "p_norm": rel([np.linalg.norm(p)], [ref["p_norm"]]),
                "u_samples": rel(u[::601], ref["u_samples"]),
                "p_samples": rel(p[::151], ref["p_samples"]),
                "u_proj": rel([np.dot(np.cos(0.37 * k * i), u)
                               for k in range(1, 5)], ref["u_proj"]),
                "p_proj": rel([np.dot(np.cos(0.37 * k * j), p)
                               for k in range(1, 5)], ref["p_proj"])}
        _stokes_line(f"stokes_small {vprecond}", N_STOKES_SMALL, sol, wall,
                     ux)
        print(f"# stokes_small {vprecond} against the JAX package's CPU "
              f"run: iterations {sol.res.iterations} (JAX {ref['iterations']}"
              f"), relative differences "
              + json.dumps({k: float(f"{v:.3e}") for k, v in errs.items()}))
        check(sol.res.converged and sol.res.iterations == ref["iterations"],
              f"stokes_small {vprecond}: {sol.res.iterations} iterations, "
              f"JAX CPU {ref['iterations']}")
        check((sol.V.num_dofs, sol.Q.num_scalar_dofs)
              == STOKES_DOFS[N_STOKES_SMALL], "stokes_small: DOFs")
        check(all(v <= 1e-6 for v in errs.values()),
              f"stokes_small {vprecond}: {errs}")


# -- generic structured assembly (B13), the reduction (B14), SAXPY (B15) ----

# operations per tetrahedron of the fused assembly, counted from B13's
# formulas: geometry 57 (J 9, cofactors 27, det 5, reciprocal 1, inverse 9,
# last gradient 6), |det| / 6 2, 16 entries x (5 + 1) and their 16 sums
_ASSEMBLE_FLOPS = 171
N_REDUCE = 64 * 1024 * 1024 // 4     # examples/reduction_bench.py: 64 MB
N_SAXPY = 32 * 128 * 128             # examples/saxpy_pallas.py
N_SAXPY_BIG = 1 << 26                 # B15 at a bandwidth-sized n


def _embedded_coords(n_or_dims, dev):
    """(mesh, embedded plan, X_emb fp64 on the card) of the Kuhn box on
    (-3, 3)^3 with n cells a side, or of tests/test_embedded_pipeline.py's
    box with the given cells (nx, ny, nz)."""
    import numpy as np
    import torch

    from tpufem_torch.assemble.structured import structured_plan
    from tpufem_torch.mesh.box import box_mesh
    from tpufem_torch.ops.assemble_cuda import element_coords_bt_embedded

    if isinstance(n_or_dims, tuple):
        mesh = box_mesh(-1, 2, 0, 1, -2, 0, *n_or_dims)
    else:
        mesh = box_mesh(*DOMAIN, *DOMAIN, *DOMAIN, *(n_or_dims,) * 3)
    plan = structured_plan(mesh, embed=True)
    X = torch.as_tensor(element_coords_bt_embedded(mesh, plan,
                                                   dtype=np.float64),
                        device=dev)
    return mesh, plan, X


def _check_assembly(dev, records):
    """B13 at n=96 (the assembly path's shape) in fp32 and fp64 and on the
    non-cubic 5 x 4 x 6 box: bit for bit against its plain version."""
    import torch

    from tpufem_torch.ops.assemble_cuda import (assemble_stencil_cuda,
                                                assemble_stencil_plain,
                                                assemble_tiling)

    for shape in (N_MAIN, (5, 4, 6)):
        mesh, plan, X64 = _embedded_coords(shape, dev)
        label = (f"n={shape}" if shape == N_MAIN
                 else "box {}x{}x{}".format(*shape))
        for dt in (torch.float32, torch.float64):
            X = X64.to(dt)
            name = str(dt).replace("torch.", "")
            tx, ty, tz, smem, grid = assemble_tiling(
                X.element_size(), tuple(plan.store_grid))
            print(f"# tile B13 {label} {name}: {tx} columns x {ty} rows, "
                  f"{tz} planes, grid {grid}, {smem} B of shared memory a "
                  "block")
            # the bound counts only the coordinates B13 reads: those of
            # cells inside the cell grid (padding cells are skipped)
            m0, m1, m2 = plan.info.cell_grid
            read = X[:, :, :, :m0, 1:1 + m1, 1:1 + m2]
            _compare(records, "B13", f"{label} {name}",
                     lambda: assemble_stencil_cuda(plan, X).data,
                     lambda: assemble_stencil_plain(plan, X).data,
                     timed=True, shapes=True,
                     work=([read], mesh.num_elements * _ASSEMBLE_FLOPS, name))
            same = torch.equal(assemble_stencil_cuda(plan, X).data,
                               assemble_stencil_plain(plan, X).data)
            print(f"# check B13 {label} {name}: bit for bit {same}")
            check(same, f"B13 {label} {name}: differs from its plain version")
            del X
        del X64
        torch.cuda.empty_cache()


def _check_reduction_saxpy(dev, records):
    """B14 on the 64 MB vector of examples/reduction_bench.py (block =
    n / 8) in fp32 and fp64 and at an n that is not a block multiple; B15
    at examples/saxpy_pallas.py's n and at an odd n.  Each bit for bit
    against its plain version; the library calls are torch.sum and
    torch.add(y, x, alpha=a)."""
    import numpy as np
    import torch

    from tpufem_torch.ops.reduction import (block_reduce,
                                            block_reduce_plain,
                                            reduction_check)
    from tpufem_torch.ops.saxpy_cuda import saxpy, saxpy_plain

    gen = torch.Generator(device=dev).manual_seed(14)
    x32 = torch.rand(N_REDUCE, generator=gen, device=dev)
    for label, x, block in (
            ("64 MB fp32", x32, N_REDUCE // 8),
            ("128 MB fp64", x32.double(), N_REDUCE // 8),
            ("fp32, n = 2^24 - 12,345 (padded)", x32[:N_REDUCE - 12345],
             N_REDUCE // 8)):
        name = str(x.dtype).replace("torch.", "")
        _compare(records, "B14", label,
                 lambda: block_reduce(x, block).reshape(1),
                 lambda: block_reduce_plain(x, block).reshape(1),
                 timed="padded" not in label, work=([x], x.numel(), name),
                 library=lambda: (lambda: torch.sum(x).reshape(1)))
        out = block_reduce(x, block)
        golden = reduction_check(x, out)
        same = torch.equal(out, block_reduce_plain(x, block))
        print(f"# check B14 {label}: bit for bit {same}, host fp64 golden "
              f"rel diff {golden['rel_diff']:.3e}")
        check(same and golden["match"], f"B14 {label}: bit for bit {same}, "
                                         f"golden {golden}")

    for label, n in (("n = 524,288 fp32", N_SAXPY),
                     ("n = 1,000,003 fp32", 1_000_003)):
        # the example's data: x = arange, y = 2 x, a = 5.1
        a = torch.tensor([5.1], dtype=torch.float32, device=dev)
        x = torch.arange(n, dtype=torch.float32, device=dev)
        y = x * 2.0
        alpha = a.item()
        _compare(records, "B15", label, lambda: saxpy(a, x, y),
                 lambda: saxpy_plain(a, x, y), timed=n == N_SAXPY,
                 work=([a, x, y], 2 * n, "float32"),
                 library=lambda: (lambda: torch.add(y, x, alpha=alpha)))
        out = saxpy(a, x, y)
        expected = 5.1 * np.arange(n, dtype=np.float32) + 2.0 * np.arange(
            n, dtype=np.float32)
        err = float(np.abs(out.cpu().numpy() - expected).max())
        same = torch.equal(out, saxpy_plain(a, x, y))
        print(f"# check B15 {label}: bit for bit {same}, max |err| vs the "
              f"example's golden {err}")
        check(same and err < 1e-4, f"B15 {label}: bit for bit {same}, "
                                   f"golden error {err}")
    # bandwidth-sized: random data (arange is not exact in fp32 past 2^24)
    n = N_SAXPY_BIG
    a = torch.tensor([5.1], dtype=torch.float32, device=dev)
    x, y = (torch.rand(n, generator=gen, device=dev) for _ in range(2))
    alpha = a.item()
    _compare(records, "B15", "n = 2^26 fp32 (805.3 MB moved)",
             lambda: saxpy(a, x, y), lambda: saxpy_plain(a, x, y),
             timed=True, work=([a, x, y], 2 * n, "float32"),
             library=lambda: (lambda: torch.add(y, x, alpha=alpha)))
    same = torch.equal(saxpy(a, x, y), saxpy_plain(a, x, y))
    print(f"# check B15 n = 2^26 fp32: bit for bit {same}")
    check(same, "B15 n = 2^26: differs from its plain version")
    del x, y, x32
    torch.cuda.empty_cache()


def _drive_assembly(dev, main):
    """examples/poisson_3d_multigrid.py composed from the port at n=96,
    with its stiffness from B13: the mesh and its embedded plan
    (structured_plan(mesh)), element_coords_bt_embedded, B13 (once), the
    host-layout RHS (element_coords_bt, element_load_bt with the degree-3
    rule, assemble_vector_structured_bt), apply_dirichlet_stencil on the
    mesh's boundary flags, the general hierarchy on the built operator
    (top=) and the guarded cg to 1e-6 with K2 as the matvec.  Held to: the
    same solve on K1's eliminated operator (main path) within one
    iteration, the error against the manufactured solution, B13's raw
    planes against K1's raw ones, and the weak form's stencil assembly
    against B13's planes and the structured RHS."""
    import numpy as np
    import torch

    from tpufem_torch.assemble.planar import element_coords_bt, element_load_bt
    from tpufem_torch.assemble.structured import (
        assemble_vector_structured, assemble_vector_structured_bt,
        structured_plan)
    from tpufem_torch.fem.quadrature import tetrahedron_rule
    from tpufem_torch.fem.space import FunctionSpace
    from tpufem_torch.forms.language import Coefficient, dot, grad
    from tpufem_torch.forms.weakform import WeakForm
    from tpufem_torch.mesh.box import box_mesh
    from tpufem_torch.ops.assemble_cuda import (assemble_stencil_cuda,
                                                element_coords_bt_embedded)
    from tpufem_torch.ops.fused_system_cuda import (
        build_poisson_system, node_coords_embedded_from_grid)
    from tpufem_torch.ops.stencil_cuda import stencil_matvec_embedded
    from tpufem_torch.solve import multigrid as mg
    from tpufem_torch.solve.bc import apply_dirichlet_stencil
    from tpufem_torch.solve.cg import cg
    from tpufem_torch.solve.poisson import (model_problem_3d,
                                            model_problem_3d_planes)
    from tpufem_torch.utils.timing import PhaseTimer

    n = N_MAIN
    f_planes = model_problem_3d_planes()
    f, exact = model_problem_3d()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    timer = PhaseTimer()
    with timer("host_mesh_plan"):
        mesh = box_mesh(*DOMAIN, *DOMAIN, *DOMAIN, n, n, n)
        plan = structured_plan(mesh, embed=True)
    with timer("host_element_coords"):
        X_emb = element_coords_bt_embedded(mesh, plan)
    with timer("to_device"):
        X_emb = torch.as_tensor(X_emb, device=dev)
        torch.cuda.synchronize()
    with timer("assemble"):
        t0 = time.perf_counter()
        A_raw = assemble_stencil_cuda(plan, X_emb)
        issue_s = time.perf_counter() - t0
        torch.cuda.synchronize()
    with timer("rhs"):
        X = torch.as_tensor(element_coords_bt(mesh, np.float32), device=dev)
        b = assemble_vector_structured_bt(plan, element_load_bt(
            X, "tetrahedron", tetrahedron_rule(3), f_planes))
        del X
        torch.cuda.synchronize()
    with timer("dirichlet"):
        bc = plan.embed_field(torch.as_tensor(mesh.node_flags != 0,
                                              device=dev), fill=0)
        A, b = apply_dirichlet_stencil(A_raw, b, bc)
        torch.cuda.synchronize()

    def solve(A, b, bc):
        levels = mg.build_poisson_multigrid(DOMAIN, n, dtype=torch.float32,
                                            top=(A.data, bc), device=dev)
        M = mg.mg_preconditioner(levels, nu1=1, nu2=1)
        res = cg(lambda v: stencil_matvec_embedded(A.data, v, plan), b,
                 tol=1e-6, maxiter=100, M=M)
        torch.cuda.synchronize()
        return res

    with timer("hierarchy_and_solve"):
        res = solve(A, b, bc)
    ue = torch.as_tensor(exact(mesh.coords), device=dev)
    err = _rel_err(plan.extract_field(res.x), ue)
    bc_main = torch.as_tensor(mg._embed_grid_numpy(
        main["bc"], plan.store_grid, fill=False), device=dev)
    ref = solve(main["A"], main["b"], bc_main)
    launches = assemble_stencil_cuda.launches
    print(f"# assembly solve (B13 + host RHS, n={n}): {res.iterations} "
          f"iterations, relres {res.residual_norm.item():.3e}, rel L2 "
          f"error {err:.4e}; the same solve on K1's eliminated operator: "
          f"{ref.iterations} iterations, relres "
          f"{ref.residual_norm.item():.3e}; B13 launches {launches}")
    check(launches == 1, f"assembly: B13 launched {launches} times, not 1")
    check(res.converged and ref.converged, "assembly: not converged")
    check(abs(res.iterations - ref.iterations) <= 1,
          f"assembly: {res.iterations} iterations against K1's "
          f"{ref.iterations}")
    check(err <= 2.0e-4, f"assembly: rel L2 error {err:.3e} > 2.0e-4")

    # B13's raw planes against K1's (apply_bc=False): two kernels, one
    # stiffness; K1's build wall at the same n beside B13's
    C = torch.as_tensor(node_coords_embedded_from_grid(
        main["coords"], plan, np.float32), device=dev)
    torch.cuda.synchronize()
    with timer("k1_build"):
        K1, _ = build_poisson_system(plan, C, f_planes, tetrahedron_rule(2),
                                     apply_bc=False)
        torch.cuda.synchronize()
    dk, bound = _err(A_raw.data, K1.data, "float32")
    print(f"# assembly B13 raw vs K1 raw: max abs diff {dk:.3e} (bound "
          f"{bound:.3e})")
    check(dk <= bound, f"assembly: B13 vs K1 raw {dk:.3e} > {bound:.3e}")
    del K1, C

    # the weak form's stencil format (node order, not embedded) against
    # B13's planes and the structured RHS of its own element vectors
    V = FunctionSpace(mesh, degree=1)
    with timer("weak_form_stencil"):
        wf = WeakForm(V, dtype=torch.float32, device=dev).build(
            lambda u, v: dot(grad(u), grad(v)), lambda v: Coefficient(f) * v)
        A_wf, b_wf = wf.assemble(format="stencil")
        torch.cuda.synchronize()
    plan_wf = structured_plan(mesh)
    k_of = {g: k for k, g in enumerate(plan.offsets_grid)}
    diff = max((A_wf.data[k] - plan.extract_field(
        A_raw.data[k_of[g]])).abs().max().item()
        for k, g in enumerate(plan_wf.offsets_grid))
    dmax = A_raw.data.abs().max().item()
    ec = torch.as_tensor(mesh.element_coords(), dtype=torch.float32,
                         device=dev)
    b_st = assemble_vector_structured(plan_wf, wf.element_vectors(ec))
    del ec
    db = (b_wf - b_st).abs().max().item()
    bmax = b_st.abs().max().item()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"# assembly weak form (stencil format, fp32): max |A_wf - B13| "
          f"{diff:.3e} (max |B13| {dmax:.3e}), max |b_wf - b_structured| "
          f"{db:.3e} (max {bmax:.3e})")
    print(f"# assembly phases (s, wall clock ending in a synchronize): "
          + json.dumps({k: round(v, 4) for k, v in timer.report().items()})
          + f"; B13's call returned after {issue_s:.4f} s of the "
          f"assemble phase; peak device memory {peak_gb:.3f} GB")
    check(diff <= 1e-5 * dmax, f"assembly: weak-form stencil vs B13 "
                               f"{diff:.3e}")
    check(db <= 1e-5 * bmax, f"assembly: weak-form b vs structured {db:.3e}")

    def after():
        """Walls of one warm call each (host clock, ending in a
        synchronize), B13 and K1 in turns, beside the path's first call."""
        C = torch.as_tensor(node_coords_embedded_from_grid(
            main["coords"], plan, np.float32), device=dev)
        calls = {"B13": lambda: assemble_stencil_cuda(plan, X_emb),
                 "K1": lambda: build_poisson_system(
                     plan, C, f_planes, tetrahedron_rule(2), apply_bc=False)}
        walls = {key: [] for key in calls}
        for _ in range(5):
            for key in ("B13", "K1", "K1", "B13"):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                calls[key]()
                torch.cuda.synchronize()
                walls[key].append(time.perf_counter() - t0)
        print("# assembly warm walls (ms, median of 10 calls each, in "
              "turns): " + ", ".join(
                  f"{key} {1e3 * sorted(w)[len(w) // 2]:.4f}"
                  for key, w in walls.items()))

    return after


def _drive_reduction(dev):
    """examples/reduction_bench.py composed from the port at its size on
    the card (64 MB fp32, seeded uniform values): reduce_sum,
    pallas_block_reduce (B14) with block = n / 8 and segment_reduce over
    1000 segments, each against the fp64 host golden sum."""
    import torch

    from tpufem_torch.ops.reduction import (pallas_block_reduce, reduce_sum,
                                            reduction_check, segment_reduce)

    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.rand(N_REDUCE, generator=gen, device=dev)
    ids = torch.randint(0, 1000, (N_REDUCE,), generator=gen, device=dev)
    for label, result in (
            ("fused sum", reduce_sum(x)),
            ("block sum (B14)", pallas_block_reduce(x, block=N_REDUCE // 8)),
            ("segment sum", segment_reduce(x, ids, 1000).sum())):
        golden = reduction_check(x, result)
        print(f"# reduction {label}: {golden}")
        check(golden["match"], f"reduction {label}: {golden}")


def _drive_saxpy():
    """examples/saxpy_pallas.py through the port's saxpy_cuda main: n = 32 x
    16,384, a = 5.1, x = arange, y = 2 arange, max |err| against the
    golden values < 1e-4 (the example asserts it too)."""
    out, _ = _example("saxpy_cuda", [])
    check(out["n"] == N_SAXPY and out["max_abs_err"] < 1e-4,
          f"saxpy: max |err| {out['max_abs_err']}")


# -- the multi-device path (tpufem_torch.dist) --------------------------------

def _perturbed_coords(n, dtype, dev, jitter=0.15):
    """(plan, C_emb on the card) of the box with n cells a side, interior
    nodes jittered uniformly by +-jitter h from default_rng(0), as
    scripts/dist_assembly_hw.py makes them."""
    import numpy as np
    import torch

    from tpufem_torch.ops.fused_system_cuda import \
        node_coords_embedded_from_grid
    from tpufem_torch.solve import multigrid as mg

    info, coords, bc = mg._light_grid(DOMAIN, n)
    plan = _plan(n)
    h = (DOMAIN[1] - DOMAIN[0]) / n
    pert = np.random.default_rng(0).uniform(-jitter * h, jitter * h,
                                            size=coords.shape)
    coords = coords + np.where(~np.broadcast_to(bc, coords.shape), pert, 0.0)
    return plan, torch.as_tensor(node_coords_embedded_from_grid(
        coords, plan, dtype), device=dev)


def _extended_stripes(C, shards):
    """[(C_ext, zbase)] of each z-stripe: its planes and one neighbour
    plane on each side, zeros past the grid's ends (built here apart from
    dist.assembly's ring exchange)."""
    import torch

    depth = C.shape[1] // shards
    zero = torch.zeros_like(C[:, :1])
    out = []
    for i in range(shards):
        z = i * depth
        lo = C[:, z - 1:z] if i > 0 else zero
        hi = C[:, z + depth:z + depth + 1] if i < shards - 1 else zero
        out.append((torch.cat([lo, C[:, z:z + depth], hi], 1).contiguous(),
                    z))
    return out


def _check_dist_assembly(dev, records):
    """B8 at n=96 (fp32 and fp64; 1, 4 and 8 shards) and at n=62 (fp32, 4
    shards): each stripe against its plain version on the same extended
    stripe, and the stripes that build_poisson_system_sharded gives,
    joined, against K1's planes and RHS bit for bit.  At the main shape
    (n=96, 4 shards, one 26-plane stripe) B8, its plain version and the
    four-launch build are timed beside K1; no library call builds it."""
    import numpy as np
    import torch

    from tpufem_torch.dist.assembly import build_poisson_system_sharded
    from tpufem_torch.dist.mesh import make_mesh, unshard
    from tpufem_torch.fem.quadrature import tetrahedron_rule
    from tpufem_torch.ops.fused_system_cuda import (
        build_poisson_stripe, build_poisson_stripe_plain,
        build_poisson_system)
    from tpufem_torch.solve.poisson import model_problem_3d_planes
    from tpufem_torch.utils.timing import cuda_ms

    f, rule = model_problem_3d_planes(), tetrahedron_rule(2)
    for n, dtype, shard_counts in ((N_MAIN, np.float32, (1, 4, 8)),
                                   (N_MAIN, np.float64, (1, 4, 8)),
                                   (N_DIST_TPU, np.float32, (4,))):
        plan, C = _perturbed_coords(n, dtype, dev)
        name = np.dtype(dtype).name
        A, b = build_poisson_system(plan, C, f, rule)
        for shards in shard_counts:
            label = f"n={n} {name} {shards} shards"
            mesh = make_mesh(shards, ("z",), device=dev)
            data, rhs = build_poisson_system_sharded(plan, C, mesh, f, rule)
            same = (torch.equal(unshard(data), A.data)
                    and torch.equal(unshard(rhs), b))
            print(f"# check B8 {label}: stripes joined equal K1's planes "
                  f"and RHS bit for bit: {same}")
            check(same, f"B8 {label}: the stripes differ from K1's build")
            main = n == N_MAIN and dtype == np.float32 and shards == 4
            for i, (Cx, z) in enumerate(_extended_stripes(C, shards)):
                timed = main and i == 1
                cells = plan.info.cell_grid
                _compare(records, "B8", f"{label} stripe {i}",
                         lambda: build_poisson_stripe(plan, Cx, z, f, rule),
                         lambda: build_poisson_stripe_plain(plan, Cx, z, f,
                                                            rule),
                         timed=timed,
                         work=([Cx], 6 * cells[1] * cells[2] * (
                             Cx.shape[1] - 2) * _ELEMENT_FLOPS[3], name),
                         exact=True)
            if main:
                build_ms = cuda_ms(lambda: build_poisson_system_sharded(
                    plan, C, mesh, f, rule), reps=REPS)
                k1_ms = cuda_ms(lambda: build_poisson_system(plan, C, f,
                                                             rule), reps=REPS)
                print(f"# B8 {label}: the four-launch build (halo planes, "
                      f"4 stripes) {build_ms:.4f} ms, K1's whole build "
                      f"{k1_ms:.4f} ms (device, queued ahead; K1 at n=96 "
                      f"above: {records['K1']['ms']:.4f} ms)")
            del data, rhs
        del A, b, C
        torch.cuda.empty_cache()


def _drive_dist_assembly(dev):
    """The slice's path at the main path's size: n=96 (912,673 DOFs),
    interior nodes jittered by +-0.15 h, fp32, 4 z-stripe shards of 26
    store planes on the card.  build_poisson_system_sharded launches B8
    exactly 4 times and K1 never, and its stripes equal K1's build bit for
    bit; solve_poisson_dist_general (Jacobi halo CG, tol 1e-6) converges
    to within 1e-4 of the single-card Jacobi cg on K1's operator; the same
    solve at 1 and 8 shards; then n=62, 4 shards (the TPU record's size,
    250,047 DOFs) within DIST_TPU_MAXITER iterations."""
    import numpy as np
    import torch

    from tpufem_torch.dist.assembly import (build_poisson_system_sharded,
                                            solve_poisson_dist_general)
    from tpufem_torch.dist.cg import stencil_cg_sharded
    from tpufem_torch.dist.mesh import make_mesh, unshard
    from tpufem_torch.fem.quadrature import tetrahedron_rule
    from tpufem_torch.ops.fused_system_cuda import (build_poisson_stripe,
                                                    build_poisson_system)
    from tpufem_torch.ops.stencil_cuda import stencil_apply
    from tpufem_torch.solve.cg import cg
    from tpufem_torch.solve.poisson import model_problem_3d_planes
    from tpufem_torch.utils.timing import PhaseTimer

    f, rule = model_problem_3d_planes(), tetrahedron_rule(2)
    timer = PhaseTimer()
    with timer("host_coords"):
        plan, C = _perturbed_coords(N_MAIN, np.float32, dev)
        torch.cuda.synchronize()
    mesh4 = make_mesh(4, ("z",))
    check(all(d.type == "cuda" for d in mesh4.device_list), f"mesh: {mesh4}")
    b8, k1 = build_poisson_stripe.launches, build_poisson_system.launches
    with timer("sharded_build"):
        data, rhs = build_poisson_system_sharded(plan, C, mesh4, f, rule)
        torch.cuda.synchronize()
    b8 = build_poisson_stripe.launches - b8
    k1 = build_poisson_system.launches - k1
    print(f"# dist_assembly build (n={N_MAIN}, 4 shards of "
          f"{plan.store_grid[0] // 4} planes): B8 launches {b8}, K1 "
          f"launches {k1}")
    check(b8 == 4 and k1 == 0, f"dist_assembly: B8 {b8}, K1 {k1} launches")
    A, b = build_poisson_system(plan, C, f, rule)
    same = (torch.equal(unshard(data), A.data)
            and torch.equal(unshard(rhs), b))
    print(f"# dist_assembly stripes equal K1's planes and RHS bit for bit: "
          f"{same}")
    check(same, "dist_assembly: the stripes differ from K1's build")

    counts = {}
    for shards in (4, 1, 8):
        with timer(f"solve_{shards}_shards"):
            u, res = solve_poisson_dist_general(
                plan, C, make_mesh(shards, ("z",)), f, rule, tol=1e-6,
                maxiter=4000)
            torch.cuda.synchronize()
        counts[shards] = res.iterations
        check(res.converged, f"dist_assembly {shards} shards: not converged "
                             f"({res.iterations}, "
                             f"{float(res.residual_norm):.3e})")
        if shards == 4:
            u4, res4 = u, res
    d = A.data[plan.offsets.index(0)]
    inv_d = torch.where(d != 0, 1.0 / d, 1.0)
    with timer("single_card_cg"):
        ref = cg(lambda v: stencil_apply(A.data, v, plan.offsets), b,
                 tol=1e-6, maxiter=4000, M=lambda r: r * inv_d)
        torch.cuda.synchronize()
    u_ref = plan.extract_field(ref.x).double().cpu().numpy()
    rel = float(np.linalg.norm(u4 - u_ref) / np.linalg.norm(u_ref))
    print(f"# dist_assembly solve (n={N_MAIN}, fp32, Jacobi halo CG to "
          f"1e-6): {counts[4]} iterations at 4 shards, relres "
          f"{float(res4.residual_norm):.3e}; {counts[1]} at 1 shard, "
          f"{counts[8]} at 8 (the FMA-contracted build: "
          + ", ".join(f"{FMA_BUILD_DIST_COUNTS[k]} at {k}" for k in (4, 1, 8))
          + f"); the single-card cg on K1's operator {ref.iterations}; rel "
          f"diff of u {rel:.3e}")
    check(ref.converged and rel <= 1e-4,
          f"dist_assembly: u differs from the single-card solve by {rel:.3e}")
    check(all(abs(counts[k] - FMA_BUILD_DIST_COUNTS[k]) <= 1
              for k in FMA_BUILD_DIST_COUNTS),
          f"dist_assembly: counts {counts} more than one iteration from "
          f"the FMA-contracted build's {FMA_BUILD_DIST_COUNTS}")

    plan62, C62 = _perturbed_coords(N_DIST_TPU, np.float32, dev)
    with timer("solve_n62_4_shards"):
        _, res62 = solve_poisson_dist_general(
            plan62, C62, mesh4, f, rule, tol=1e-6, maxiter=4000)
        torch.cuda.synchronize()
    print(f"# dist_assembly n={N_DIST_TPU} "
          f"({int(np.prod(plan62.info.node_grid)):,} DOFs), 4 shards: "
          f"{res62.iterations} iterations, relres "
          f"{float(res62.residual_norm):.3e} (TPU, one-device mesh: 152; "
          f"gate {DIST_TPU_MAXITER})")
    check(res62.converged and res62.iterations <= DIST_TPU_MAXITER,
          f"dist_assembly n={N_DIST_TPU}: {res62.iterations} iterations, "
          f"converged {res62.converged}")
    print("# dist_assembly phases (s, wall clock ending in a synchronize): "
          + json.dumps({k: round(v, 4) for k, v in timer.report().items()}))

    def pcg10():
        return stencil_cg_sharded(data, plan.offsets, rhs, mesh4,
                                  axis_name="z", tol=0.0, maxiter=10)

    return lambda: _per_iteration("dist_assembly", pcg10)


def _drive_dist_mg(dev):
    """The reference's million-DOF claim (README, tests/test_dist_mg.py):
    solve_poisson_dist at n=104 in 3D (1,157,625 DOFs), fp64, 8 shards on
    the card, a manufactured solution (seed 3), tol 1e-9, maxiter 60:
    converged in fewer than 30 iterations, error below 1e-7, at least 2
    distributed levels."""
    import numpy as np
    import torch

    from tpufem_torch.dist import multigrid as dm
    from tpufem_torch.dist.mesh import make_mesh
    from tpufem_torch.utils.timing import PhaseTimer

    n = N_DIST_MG
    timer = PhaseTimer()
    mesh8 = make_mesh(8, ("z",))
    with timer("host_hierarchy"):
        levels = dm.build_dist_hierarchy(DOMAIN, n, 3, 8, dtype=np.float64)
    n_dist = sum(lv.distributed for lv in levels)
    fine = levels[0]
    ng = fine.node_grid
    zp = fine.data.shape[1]
    xt = np.random.default_rng(3).standard_normal(ng)
    xt = np.where(fine.bc_mask[:ng[0]], 0.0, xt)
    xt_p = np.pad(xt, [(0, zp - ng[0]), (0, 0), (0, 0)])
    with timer("manufactured_rhs"):
        b = dm.grid_stencil_matvec(
            torch.as_tensor(fine.data, device=dev),
            torch.as_tensor(xt_p, device=dev), fine.offsets_grid,
            None)[:ng[0]].cpu().numpy()
    with timer("solve"):
        u, res = dm.solve_poisson_dist(DOMAIN, n, 3, mesh8, b.reshape(-1),
                                       dtype=np.float64, tol=1e-9,
                                       maxiter=60)
        torch.cuda.synchronize()
    err = float(np.linalg.norm(u - xt.reshape(-1)) / np.linalg.norm(xt))
    print(f"# dist_mg (n={n}, {int(np.prod(ng)):,} DOFs, fp64, 8 shards, "
          f"{len(levels)} levels, {n_dist} distributed): "
          f"{res.iterations} iterations, relres "
          f"{float(res.residual_norm):.3e}, error {err:.3e}; phases "
          + json.dumps({k: round(v, 4) for k, v in timer.report().items()}))
    check(n_dist >= 2, f"dist_mg: {n_dist} distributed levels")
    check(res.converged and res.iterations < 30,
          f"dist_mg: {res.iterations} iterations, converged "
          f"{res.converged}")
    check(err < 1e-7, f"dist_mg: error {err:.3e} >= 1e-7")

    def after():
        arrs = dm.put_hierarchy(levels, mesh8)
        b_p = np.pad(b, [(0, zp - ng[0]), (0, 0), (0, 0)])
        _per_iteration("dist_mg", lambda: dm.mgpcg_dist(
            levels, arrs, b_p, mesh8, tol=0.0, maxiter=3), iters=3, reps=2)

    return after


def _drive_dryrun(dev):
    """The port's dryrun_multichip(8) on the card: its six stages with the
    reference's asserts (stage 4, the distributed AMG's W-cycle PCG to
    1e-8, converges within 100 iterations); stage 2 (fp64) within one
    iteration of MULTICHIP_r05's 13; stage 3 launches B8 once per
    shard."""
    from tpufem_torch.dist.dryrun import dryrun_multichip
    from tpufem_torch.ops.fused_system_cuda import build_poisson_stripe

    b8 = build_poisson_stripe.launches
    out = dryrun_multichip(8)
    b8 = build_poisson_stripe.launches - b8
    reference = {"stencil_cg": 40, "dist_mg": 13, "dist_assembly": 31,
                 "dist_amg": 24, "dist_bcsr": 72}
    print("# dryrun iterations (MULTICHIP_r05.json, 8 virtual CPU devices, "
          "in brackets): " + ", ".join(
              f"{k} {out[k]['iterations']} ({v})"
              for k, v in reference.items())
          + f"; energy drift {out['dist_dynamics']['drift']:.3e}; B8 "
          f"launches {b8}")
    st4 = out["dist_amg"]
    print(f"# dryrun stage 4 (dist-AMG): {st4['dofs']} DOFs, "
          f"{st4['levels']} levels, {st4['iterations']} W-cycle PCG "
          f"iterations (MULTICHIP_r05: 24), relres {st4['relres']:.3e}")
    check(abs(out["dist_mg"]["iterations"] - 13) <= 1,
          f"dryrun: stage 2 took {out['dist_mg']['iterations']} iterations")
    check(b8 == 8, f"dryrun: B8 launched {b8} times, not 8")


# -- the examples, through the port's own entry points ------------------------
# tpufem_torch.examples.<name>.main(argv + ["--device", "cuda"]), gated on
# the dict it returns.  The JAX examples' own CPU figures at the same argv
# (fp32, x64 off, the XLA gather products, eight virtual CPU devices), and
# with --port first the port's own CPU run (fp32, the plain versions):
#   python scripts/examples_jax_reference.py [--port] <name> <argv>
# (elasticity_unstructured with --interpret --no-aot, poisson_3d_multigrid
# with --no-pallas: the XLA form its tests pin to the kernels).  In fp64
# the tests hold the two packages' counts equal.  In fp32 they round the
# assembly, the products and the dots differently, and a solve to a
# tolerance at or below fp32's resolution ends some iterations apart: the
# JAX run sums its fp32 dots of 1M terms in order (its heat_equation L2^2
# of the initial state, 1.5698, is 6.3e-4 off the 1.5707774 of its own
# state summed in fp64), the port's are blocked sums.  So each gate below
# holds the count within the spread of the two CPU runs, with the
# physics (error, L2^2) held tight; the port's CPU figures are:
#   poisson_2d 144 (JAX 141); unstructured_1m Chebyshev 80 (JAX 82), its
#   errors 1.8213e-5 / 1.5484e-5 (Chebyshev / AMG) with torch's default
#   threads and 1.8097e-5 / 1.3658e-5 with OMP_NUM_THREADS=1 (JAX
#   2.1328e-5 / 1.4637e-5: at tol 1e-5 the algebraic error stands beside
#   the discretization's, and the summation order moves it);
#   heat_equation 17033 (JAX 18990); the others the JAX counts.
JAX_EX = {
    "poisson_2d": {"iterations": 141, "nodal_rms_err": 8.508e-03},
    # L2^2 of the JAX run's initial and final states summed in fp64
    "heat_equation": {"cg_iters_total": 18990,
                      "l2sq0": 1.5707774308315252,
                      "l2sq": 0.28698709472440953},
    "poisson_3d_multigrid": {"iterations": 12, "rel_l2_err": 1.795e-04},
    "unstructured_1m": {"chebyshev": (82, 2.1328232543320778e-05),
                        "amg": (14, 1.4636763085174698e-05)},
    "dist_amg_demo": {"pcg_iters": 30, "rel_l2_error": 1.2654032341362516e-04},
    "elasticity_unstructured": {"pcg_iters": 22},
}
PORT_CPU_HEAT_ITERS = 17033
# examples/poisson_10m.py --n 224 on the CPU (interpret mode), and the
# TPU's record of it, BENCH_NOTES.md:101 (10 iterations, 6.0e-5)
JAX_POISSON_10M = {"iterations": 12, "rel_l2_err": 1.704e-04}
# the TPU's record, the reference's gate (BENCH_NOTES.md:87)
TPU_ELASTICITY_1M = {"pcg_iters": 278, "rel_l2_err": 7.4e-4}


def _example(name, argv):
    """The port's example on the card: (its returned dict, its wall).  Its
    printed lines are repeated as '#' lines."""
    mod = importlib.import_module(f"tpufem_torch.examples.{name}")
    buf = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            out = mod.main(list(argv) + ["--device", "cuda"])
    except SystemExit as exc:          # the example's own gate failed
        out = None
        code = exc.code
    wall = time.perf_counter() - t0
    for line in buf.getvalue().splitlines():
        print(f"# ex_{name} {' '.join(argv)}: {line}")
    print(f"# ex_{name} {' '.join(argv)}: wall {wall:.2f} s")
    check(out is not None, f"ex_{name} {' '.join(argv)}: exited with "
                           f"{code if out is None else 0}")
    return out, wall


def _near(value, ref, rel):
    return abs(value - ref) <= rel * abs(ref)



def _ex_reduction_bench():
    """examples/reduction_bench.py: 16,777,216 fp32 values (64 MB); the
    three golden checks against the fp64 host sum; B14's bandwidth by the
    rep-difference."""
    out, _ = _example("reduction_bench", [])
    check(out["n"] == N_REDUCE and out["match"],
          f"ex_reduction_bench: {out['checks']}")
    return out


def _ex_poisson_2d():
    """examples/poisson_2d.py --cells 64 (4,225 DOFs, fp32, Jacobi CG to
    1e-8): converged, its nodal RMS error within 1% of the JAX CPU run's
    (8.508e-3), the count within 10% of the JAX CPU count (141).  The
    tolerance lies below fp32's resolution, so the last iterations run on
    rounding: the JAX CPU run takes 141, the port's CPU run 144 and the
    card 135 (its first run), with the same error to 0.1%."""
    out, _ = _example("poisson_2d", ["--cells", "64"])
    ref = JAX_EX["poisson_2d"]
    check(out["dofs"] == 4225 and out["converged"]
          and _near(out["iterations"], ref["iterations"], 0.10),
          f"ex_poisson_2d: {out['iterations']} iterations, converged "
          f"{out['converged']} (JAX CPU {ref['iterations']})")
    check(_near(out["nodal_rms_err"], ref["nodal_rms_err"], 0.01),
          f"ex_poisson_2d: error {out['nodal_rms_err']:.4e}")


def _ex_heat_equation():
    """examples/heat_equation.py --cells 1000 --steps 20 (1,002,001 DOFs,
    fp32, CG to 1e-10 a step, below fp32's resolution): the total CG
    iterations within 1% of the port's CPU run's (17033) and within 12% of
    the JAX CPU run's (18990); L2^2 decaying, its initial and final values
    within 1e-4 relative of the JAX run's states' (1.5707774 -> 0.2869871,
    summed in fp64); the checkpoint read back bit for bit."""
    import tempfile

    import torch

    from tpufem_torch.io.checkpoint import load_solution

    ref = JAX_EX["heat_equation"]
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "heat.npz")
        out, _ = _example("heat_equation", ["--cells", "1000", "--steps",
                                            "20", "--checkpoint", path])
        x, info = load_solution(path, device="cuda")
    its = out["cg_iters_total"]
    check(out["dofs"] == 1_002_001 and _near(its, PORT_CPU_HEAT_ITERS, 0.01)
          and _near(its, ref["cg_iters_total"], 0.12),
          f"ex_heat_equation: {its} CG iterations (the port's CPU run "
          f"{PORT_CPU_HEAT_ITERS}, JAX CPU {ref['cg_iters_total']})")
    check(out["decaying"] and _near(out["l2sq0"], ref["l2sq0"], 1e-4)
          and _near(out["l2sq"], ref["l2sq"], 1e-4),
          f"ex_heat_equation: L2^2 {out['l2sq0']} -> {out['l2sq']}")
    check(torch.equal(x, out["u"]) and info["iterations"] == 20,
          "ex_heat_equation: the checkpoint does not read back bit for bit")


def _ex_poisson_3d_multigrid():
    """examples/poisson_3d_multigrid.py --n 96 (912,673 DOFs, fp32, the
    general hierarchy, MG-PCG to 1e-6): the JAX CPU count (12) within one,
    its error (1.795e-4) within 1%; K2 and B4 launch (K3 and K4 fuse the
    transfers of const levels only, as in the reference)."""
    out, _ = _example("poisson_3d_multigrid", ["--n", "96"])
    ref = JAX_EX["poisson_3d_multigrid"]
    check(out["dofs"] == 912_673 and out["converged"]
          and abs(out["iterations"] - ref["iterations"]) <= 1,
          f"ex_poisson_3d_multigrid: {out['iterations']} iterations")
    check(_near(out["rel_l2_err"], ref["rel_l2_err"], 0.01),
          f"ex_poisson_3d_multigrid: error {out['rel_l2_err']:.4e}")


def _ex_poisson_10m():
    """examples/poisson_10m.py at its default n = 224 (11,390,625 DOFs,
    fp32, the guarded const MG-PCG to 1e-5, a check every 4 iterations):
    12 iterations, the JAX CPU run's (the TPU's record: 10, the first
    below the tolerance), and a rel L2 error no larger than the JAX CPU
    run's 1.704e-4.  At this size the fp32 system's rounding sets the
    error: the port's fp64 solve's is 3.2994e-5, its fp32 solve's stays at
    1.0869e-4 from tol 1e-5 to 1e-7, 1.412e-4 from the fp64 solution
    (scripts/poisson_fp32_spread.py 224, on the host); the JAX CPU fp32
    run gives 1.704e-4 and the TPU's record 6.0e-5."""
    out, _ = _example("poisson_10m", [])
    check(out["dofs"] == 11_390_625 and out["converged"]
          and out["iterations"] == JAX_POISSON_10M["iterations"],
          f"ex_poisson_10m: {out['iterations']} iterations")
    check(out["rel_l2_err"] <= JAX_POISSON_10M["rel_l2_err"],
          f"ex_poisson_10m: error {out['rel_l2_err']:.4e} > "
          f"{JAX_POISSON_10M['rel_l2_err']:.4e}")


def _ex_unstructured_1m():
    """examples/unstructured_1m.py --n 300 (90,601 rows, fp32), Chebyshev
    and then --precond amg: the JAX CPU counts (82, 14) within 4% (one),
    their errors (2.1328e-5, 1.4637e-5) within 1.5 times."""
    for precond in ("chebyshev", "amg"):
        argv = ["--n", "300"] + (["--precond", "amg"] if precond == "amg"
                                 else [])
        out, _ = _example("unstructured_1m", argv)
        its, err = JAX_EX["unstructured_1m"][precond]
        check(out["rows"] == 90_601 and out["converged"]
              and abs(out["pcg_iters"] - its) <= max(1, int(0.04 * its)),
              f"ex_unstructured_1m {precond}: {out['pcg_iters']} "
              f"iterations (JAX CPU {its})")
        check(out["rel_l2_error_vs_exact"] <= 1.5 * err,
              f"ex_unstructured_1m {precond}: error "
              f"{out['rel_l2_error_vs_exact']:.4e} (JAX CPU {err:.4e})")


def _ex_dist_amg_demo():
    """examples/dist_amg_demo.py at its defaults, --n 96 --devices 8
    (9,409 rows, fp32, 8 shards on the card): converged, the JAX CPU
    count (30) within one."""
    out, _ = _example("dist_amg_demo", ["--n", "96", "--devices", "8"])
    ref = JAX_EX["dist_amg_demo"]
    print(f"# ex_dist_amg_demo: rel L2 error "
          f"{out['rel_l2_error_vs_exact']:.4e} (JAX CPU "
          f"{ref['rel_l2_error']:.4e})")
    check(out["rows"] == 9409 and out["converged"]
          and abs(out["pcg_iters"] - ref["pcg_iters"]) <= 1,
          f"ex_dist_amg_demo: {out['pcg_iters']} iterations, converged "
          f"{out['converged']}")


def _ex_elasticity_unstructured():
    """examples/elasticity_unstructured.py --n 200 --precond amg (80,802
    DOFs, fp32, the banded block product): the JAX CPU count (22) within
    one."""
    out, _ = _example("elasticity_unstructured", ["--n", "200",
                                                  "--precond", "amg"])
    ref = JAX_EX["elasticity_unstructured"]
    check(out["dofs"] == 80_802 and out["converged"]
          and abs(out["pcg_iters"] - ref["pcg_iters"]) <= 1,
          f"ex_elasticity_unstructured: {out['pcg_iters']} iterations")


def _ex_elasticity_1m():
    """examples/elasticity_1m.py at its default n = 69 (1,029,000 DOFs,
    fp32, block-Jacobi PCG to 1e-5): converged in 278 +- 5% iterations
    with an error <= 7.8e-4 (the TPU's 278 and 7.4e-4); the per-iteration
    time by the rep-difference over cg_fixed."""
    out, _ = _example("elasticity_1m", [])
    ref = TPU_ELASTICITY_1M
    check(out["num_dofs"] == 1_029_000 and out["converged"]
          and _near(out["pcg_iters"], ref["pcg_iters"], 0.05),
          f"ex_elasticity_1m: {out['pcg_iters']} iterations")
    check(out["rel_l2_error_vs_exact"] <= 7.8e-4,
          f"ex_elasticity_1m: error {out['rel_l2_error_vs_exact']:.4e}")
    return out


def _ex_generic_assembly_20m():
    """examples/generic_assembly_20m.py at its default --nx 10000 --ny
    1000 (20,000,000 triangles, 10,011,001 rows, fp32, 8 chunks): the two
    golden checks, the scatter and sorted reductions within 1e-4 of max
    |a|, and max |row sum| / max |a| < 1e-5."""
    out, _ = _example("generic_assembly_20m", [])
    scale = float(out["data"].abs().max())
    check(out["elements"] == 20_000_000
          and out["max_abs_diff_sort_scatter"] <= 1e-4 * scale
          and out["max_rel_row_sum"] < 1e-5,
          f"ex_generic_assembly_20m: sort vs scatter "
          f"{out['max_abs_diff_sort_scatter']}, row sums "
          f"{out['max_rel_row_sum']}")
    return out


def _example_paths(counters, records):
    """One path per example (ex_<name>), with the kernels each must
    launch; the three rates worth keeping printed beside the card."""
    kept = {}

    def keep(key, drive):
        def run():
            kept[key] = drive()
        return run

    for name, drive, must in (
            ("reduction_bench", keep("reduction", _ex_reduction_bench),
             ("B14",)),
            ("poisson_2d", _ex_poisson_2d, ("B9",)),
            ("heat_equation", _ex_heat_equation, ("B9",)),
            ("poisson_3d_multigrid", _ex_poisson_3d_multigrid,
             ("K2", "B4")),
            ("poisson_10m", _ex_poisson_10m, ("K1", "K2", "K3", "K4")),
            ("unstructured_1m", _ex_unstructured_1m, ("B9",)),
            ("dist_amg_demo", _ex_dist_amg_demo, ()),
            ("elasticity_unstructured", _ex_elasticity_unstructured,
             ("B12",)),
            ("elasticity_1m", keep("elasticity", _ex_elasticity_1m), ()),
            ("generic_assembly_20m", keep("assembly",
                                          _ex_generic_assembly_20m), ())):
        _run_path(f"ex_{name}", counters, records, drive, must)
    red, ela, asm = kept["reduction"], kept["elasticity"], kept["assembly"]
    print(f"# ex records ({_card()}): reduction_bench B14 block sum "
          f"{red['bandwidth_gbs']:.1f} GB/s ({red['hbm_fraction']:.3f} of "
          f"3.35 TB/s); generic_assembly_20m {asm['elements_per_sec']:.0f} "
          f"elements/s scatter, {asm['sort_elements_per_sec']:.0f} sorted, "
          f"{asm['emit_elements_per_sec']:.0f} emit-only; elasticity_1m "
          f"{ela['pcg_iter_ms']:.4f} ms per PCG iteration")


def _card():
    """The card's name and power limit, as nvidia-smi gives them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return smi.stdout.strip().splitlines()[0]


if __name__ == "__main__":
    sys.exit(main())
