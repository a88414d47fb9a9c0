// The whole LogDDP solve's instantiations but the spacecraft and small
// models' (the kernel template: logddp_solve.cuh; those in
// logddp_solve_spacecraft.cu and logddp_solve_small.cu).
#include "logddp_solve.cuh"

CDDP_LOGDDP_SOLVE(unicycle, Unicycle, 4, false, )
CDDP_LOGDDP_SOLVE(unicycle, Unicycle, 6, false, )
CDDP_LOGDDP_SOLVE(unicycle, Unicycle, 10, false, )
CDDP_LOGDDP_SOLVE(unicycle, Unicycle, 4, true, _track)
CDDP_LOGDDP_SOLVE(unicycle, Unicycle, 6, true, _track)
CDDP_LOGDDP_SOLVE(unicycle, Unicycle, 10, true, _track)
CDDP_LOGDDP_SOLVE(pendulum, Pendulum, 2, false, )
CDDP_LOGDDP_SOLVE(pendulum, Pendulum, 2, true, _track)
CDDP_LOGDDP_SOLVE(euler_attitude, EulerAttitude, 6, false, )
CDDP_LOGDDP_SOLVE(quaternion_attitude, QuaternionAttitude, 6, false, )
CDDP_LOGDDP_SOLVE(mrp_attitude, MrpAttitude, 6, false, )
static_assert(cddp::logddp_solve_smem<double, cddp::Unicycle>() <= 232448 &&
                  cddp::logddp_solve_smem<double, cddp::Pendulum>() <= 232448 &&
                  cddp::logddp_solve_smem<double, cddp::QuaternionAttitude>() <= 232448,
              "a block's staging must fit its shared memory");
