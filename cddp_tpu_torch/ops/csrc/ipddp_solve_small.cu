// The whole IPDDP solve's instantiations for the small models (the kernel
// template: ipddp_solve.cuh), a translation unit of their own so that nvcc
// builds them beside the others: each model's control box
// (mega_ipddp.IP_BOX_ROWS: the bicycle's m4, the others' m2), goal form, up
// to the JAX gate's horizons (rollout.WHOLE_MAX_HORIZON).
#include "ipddp_solve.cuh"

CDDP_IPDDP_SOLVE(bicycle, Bicycle, 4, -1, false, 0, 0, m4)
CDDP_IPDDP_SOLVE(dubins_car, DubinsCar, 2, -1, false, 0, 0, m2)
CDDP_IPDDP_SOLVE(dreyfus_rocket, DreyfusRocket, 2, -1, false, 0, 0, m2)
CDDP_IPDDP_SOLVE(acrobot, Acrobot, 2, -1, false, 0, 0, m2)
static_assert(cddp::ipddp_solve_smem<double, cddp::Bicycle, 4, -1>() <= 232448 &&
                  cddp::ipddp_solve_smem<double, cddp::Acrobot, 2, -1>() <= 232448,
              "a block's staging must fit its shared memory");
