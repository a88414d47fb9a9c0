// The whole CLDDP solve's instantiations for the small models
// (rollout.CLDDP_MODELS, goal form; the kernel template: clddp_solve.cuh),
// a translation unit of their own so that nvcc builds them beside
// clddp_solve.cu. The port takes them up to the JAX gate's horizons
// (rollout.WHOLE_MAX_HORIZON).
#include "clddp_solve.cuh"

CDDP_CLDDP_SOLVE(bicycle, Bicycle, false, )
CDDP_CLDDP_SOLVE(dubins_car, DubinsCar, false, )
CDDP_CLDDP_SOLVE(dreyfus_rocket, DreyfusRocket, false, )
CDDP_CLDDP_SOLVE(acrobot, Acrobot, false, )
static_assert(cddp::clddp_solve_smem<double, cddp::Bicycle>() <= 232448 &&
                  cddp::clddp_solve_smem<double, cddp::Acrobot>() <= 232448,
              "a block's staging must fit its shared memory");
