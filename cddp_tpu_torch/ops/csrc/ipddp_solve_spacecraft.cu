// The whole IPDDP solve's instantiations for the spacecraft models (the
// kernel template: ipddp_solve.cuh), a translation unit of their own so
// that nvcc builds them beside the others: the nonlinear model's control
// box (mega_ipddp.IP_BOX_ROWS: m6), goal form. The other three models' are
// left out (ROADMAP C.13).
#include "ipddp_solve.cuh"

CDDP_IPDDP_SOLVE(sc_nonlinear, SpacecraftNonlinear, 6, -1, false, 0, 0, m6)
static_assert(cddp::ipddp_solve_smem<double, cddp::SpacecraftNonlinear, 6, -1>() <= 232448,
              "a block's staging must fit its shared memory");
