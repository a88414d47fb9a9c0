// The whole CLDDP solve's instantiation for the nonlinear spacecraft model
// (rollout.CLDDP_MODELS, goal form; the kernel template: clddp_solve.cuh),
// a translation unit of its own so that nvcc builds it beside
// clddp_solve.cu; its BoxQP walks 27 active sets in the runtime loop
// (clddp_step.cuh). The other spacecraft models are left out (ROADMAP
// C.13).
#include "clddp_solve.cuh"

CDDP_CLDDP_SOLVE(sc_nonlinear, SpacecraftNonlinear, false, )
static_assert(cddp::clddp_solve_smem<double, cddp::SpacecraftNonlinear>() <= 232448,
              "a block's staging must fit its shared memory");
