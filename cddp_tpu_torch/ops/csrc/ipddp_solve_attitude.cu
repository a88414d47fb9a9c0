// The whole IPDDP solve's instantiations for the quaternion and MRP
// attitude models (the kernel template: ipddp_solve.cuh), a translation
// unit of their own so that nvcc builds them beside ipddp_solve.cu and
// ipddp_solve_terminal.cu: each model's torque box (m6;
// mega_ipddp.IP_BOX_ROWS), goal form. The Euler model's is left out
// (ROADMAP C.12).
#include "ipddp_solve.cuh"

CDDP_IPDDP_SOLVE(quaternion_attitude, QuaternionAttitude, 6, -1, false, 0, 0, m6)
CDDP_IPDDP_SOLVE(mrp_attitude, MrpAttitude, 6, -1, false, 0, 0, m6)
static_assert(cddp::ipddp_solve_smem<double, cddp::QuaternionAttitude, 6, -1>() <= 232448,
              "a block's staging must fit its shared memory");
