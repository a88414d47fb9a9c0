// The whole IPDDP solve's terminal-constraint instantiations (the kernel
// template: ipddp_solve.cuh), a translation unit of their own so that nvcc
// builds them beside ipddp_solve.cu: on the unicycle's control box (m = 4,
// goal form), one or two linear terminal inequalities (m4_ti1, m4_ti2), the
// terminal equality x_N = target (p = nx = 3; m4_te3), and both (m4_te3_ti1);
// on HCW's control box (m = 6) the rendezvous x_N = target (p = nx = 6;
// m6_te6).
#include "ipddp_solve.cuh"

CDDP_IPDDP_SOLVE(unicycle, Unicycle, 4, -1, false, 1, 0, m4_ti1)
CDDP_IPDDP_SOLVE(unicycle, Unicycle, 4, -1, false, 2, 0, m4_ti2)
CDDP_IPDDP_SOLVE(unicycle, Unicycle, 4, -1, false, 0, 3, m4_te3)
CDDP_IPDDP_SOLVE(unicycle, Unicycle, 4, -1, false, 1, 3, m4_te3_ti1)
CDDP_IPDDP_SOLVE(hcw, HCW, 6, -1, false, 0, 6, m6_te6)
static_assert(cddp::ipddp_solve_smem<double, cddp::Unicycle, 4, -1>() <= 232448 &&
                  cddp::ipddp_solve_smem<double, cddp::HCW, 6, -1>() <= 232448,
              "a block's staging must fit its shared memory");
