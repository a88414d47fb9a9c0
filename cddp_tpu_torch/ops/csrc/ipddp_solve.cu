// The whole IPDDP solve's instantiations without terminal constraints but
// the attitude, spacecraft and small models' (the kernel template:
// ipddp_solve.cuh; those in ipddp_solve_{attitude,spacecraft,small}.cu).
#include "ipddp_solve.cuh"

// On the unicycle a control box (m4), a state box (m6), both (m10), and a
// control box with a ball sorted before it (m5_ball0) or after it
// (m5_ball4), in the goal form and (suffix _track) the tracking form; on the
// pendulum its control box (m2) in both forms (mega_ipddp.IP_BOX_ROWS).
CDDP_IPDDP_SOLVE(unicycle, Unicycle, 4, -1, false, 0, 0, m4)
CDDP_IPDDP_SOLVE(unicycle, Unicycle, 6, -1, false, 0, 0, m6)
CDDP_IPDDP_SOLVE(unicycle, Unicycle, 10, -1, false, 0, 0, m10)
CDDP_IPDDP_SOLVE(unicycle, Unicycle, 5, 0, false, 0, 0, m5_ball0)
CDDP_IPDDP_SOLVE(unicycle, Unicycle, 5, 4, false, 0, 0, m5_ball4)
CDDP_IPDDP_SOLVE(unicycle, Unicycle, 4, -1, true, 0, 0, m4_track)
CDDP_IPDDP_SOLVE(unicycle, Unicycle, 6, -1, true, 0, 0, m6_track)
CDDP_IPDDP_SOLVE(unicycle, Unicycle, 10, -1, true, 0, 0, m10_track)
CDDP_IPDDP_SOLVE(unicycle, Unicycle, 5, 0, true, 0, 0, m5_ball0_track)
CDDP_IPDDP_SOLVE(pendulum, Pendulum, 2, -1, false, 0, 0, m2)
CDDP_IPDDP_SOLVE(pendulum, Pendulum, 2, -1, true, 0, 0, m2_track)
static_assert(cddp::ipddp_solve_smem<double, cddp::Unicycle, 10, -1>() <= 232448 &&
                  cddp::ipddp_solve_smem<double, cddp::Unicycle, 5, 0>() <= 232448 &&
                  cddp::ipddp_solve_smem<double, cddp::Pendulum, 2, -1>() <= 232448,
              "a block's staging must fit its shared memory");
