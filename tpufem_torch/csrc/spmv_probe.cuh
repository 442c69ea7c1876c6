// The build-time probes of the banded SpMV kernels, B12 (bcsr.cu) and B10
// (ell.cu), in one place, and the compiler fence they and B9 share.  Only
// scripts/spmv_ablation.py and scripts/bcsr_amg_ab.py set them (-D... in
// load_library's flags) to build probe copies; the defaults here are the
// shipped designs, measured fastest in those scripts' sweeps.
#pragma once

// B12: slots whose columns and values are loaded ahead of the one being
// summed.  0: 16 bytes of each value plane (4 slots in fp32, 2 in fp64).
#ifndef TPUFEM_BCSR_AHEAD
#define TPUFEM_BCSR_AHEAD 0
#endif

// B12: 1 keeps the compiler fence (keep_order) after each slot's loads;
// 0 leaves it out.
#ifndef TPUFEM_BCSR_ORDER
#define TPUFEM_BCSR_ORDER 1
#endif

// B12's run-time-K instance: slots loaded a group ahead of their sums.
// 0: by the block size and type (kLoopAhead in bcsr.cu); 1: none.  Set by
// scripts/bcsr_amg_ab.py.
#ifndef TPUFEM_BCSR_LOOP_AHEAD
#define TPUFEM_BCSR_LOOP_AHEAD 0
#endif

// B10: slots a group on the banded plan.
#ifndef TPUFEM_ELL_AHEAD
#define TPUFEM_ELL_AHEAD 2
#endif

// Keeps the compiler from moving loads across it: the loads issued ahead
// stay ahead (without it the compiler sinks them to their uses, and the
// slots' loads no longer overlap).  TPUFEM_BCSR_ORDER=0 leaves it out
// (scripts/spmv_ablation.py's probe).
__device__ __forceinline__ void keep_order() {
  if (TPUFEM_BCSR_ORDER) asm volatile("" ::: "memory");
}
