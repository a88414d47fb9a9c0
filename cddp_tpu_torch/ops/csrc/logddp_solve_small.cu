// The whole LogDDP solve's instantiations for the small models' control
// boxes (mega_ipddp.LOG_BOX_ROWS: the bicycle's m4, the others' m2; goal
// form; the kernel template: logddp_solve.cuh), a translation unit of their
// own so that nvcc builds them beside logddp_solve.cu, up to the JAX gate's
// horizons (rollout.WHOLE_MAX_HORIZON).
#include "logddp_solve.cuh"

CDDP_LOGDDP_SOLVE(bicycle, Bicycle, 4, false, )
CDDP_LOGDDP_SOLVE(dubins_car, DubinsCar, 2, false, )
CDDP_LOGDDP_SOLVE(dreyfus_rocket, DreyfusRocket, 2, false, )
CDDP_LOGDDP_SOLVE(acrobot, Acrobot, 2, false, )
static_assert(cddp::logddp_solve_smem<double, cddp::Bicycle>() <= 232448 &&
                  cddp::logddp_solve_smem<double, cddp::Acrobot>() <= 232448,
              "a block's staging must fit its shared memory");
