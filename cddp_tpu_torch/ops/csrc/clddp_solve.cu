// The whole CLDDP solve's instantiations but the spacecraft and small
// models' (the kernel template: clddp_solve.cuh; those in
// clddp_solve_spacecraft.cu and clddp_solve_small.cu).
#include "clddp_solve.cuh"

// The models of rollout.CLDDP_MODELS (goal form) and
// rollout.CLDDP_TRACK_MODELS (tracking form); each one's staging fits a
// block's shared memory in both types. The Euler and quaternion attitude
// models (nu = 3) walk their BoxQP's 27 active sets in the runtime loop
// (clddp_step.cuh); the MRP model is left out (ROADMAP C.12).
CDDP_CLDDP_SOLVE(unicycle, Unicycle, false, )
CDDP_CLDDP_SOLVE(unicycle, Unicycle, true, _track)
CDDP_CLDDP_SOLVE(pendulum, Pendulum, false, )
CDDP_CLDDP_SOLVE(pendulum, Pendulum, true, _track)
CDDP_CLDDP_SOLVE(cartpole, CartPole, false, )
CDDP_CLDDP_SOLVE(cartpole, CartPole, true, _track)
CDDP_CLDDP_SOLVE(euler_attitude, EulerAttitude, false, )
CDDP_CLDDP_SOLVE(quaternion_attitude, QuaternionAttitude, false, )
static_assert(cddp::clddp_solve_smem<double, cddp::Unicycle>() <= 232448 &&
                  cddp::clddp_solve_smem<double, cddp::Pendulum>() <= 232448 &&
                  cddp::clddp_solve_smem<double, cddp::CartPole>() <= 232448 &&
                  cddp::clddp_solve_smem<double, cddp::QuaternionAttitude>() <= 232448,
              "a block's staging must fit its shared memory");
