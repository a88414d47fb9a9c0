// The open-loop rollout's instantiations (the kernel template:
// open_loop_rollout.cuh).
#include "open_loop_rollout.cuh"

// Every model of the registry.
CDDP_OPEN_LOOP_ROLLOUT(unicycle, Unicycle)
CDDP_OPEN_LOOP_ROLLOUT(pendulum, Pendulum)
CDDP_OPEN_LOOP_ROLLOUT(cartpole, CartPole)
CDDP_OPEN_LOOP_ROLLOUT(hcw, HCW)
CDDP_OPEN_LOOP_ROLLOUT(car, Car)
CDDP_OPEN_LOOP_ROLLOUT(forklift, Forklift)
CDDP_OPEN_LOOP_ROLLOUT(quadrotor, Quadrotor)
CDDP_OPEN_LOOP_ROLLOUT(quadrotor_rate, QuadrotorRate)
CDDP_OPEN_LOOP_ROLLOUT(euler_attitude, EulerAttitude)
CDDP_OPEN_LOOP_ROLLOUT(quaternion_attitude, QuaternionAttitude)
CDDP_OPEN_LOOP_ROLLOUT(mrp_attitude, MrpAttitude)
CDDP_OPEN_LOOP_ROLLOUT(sc_linear_fuel, SpacecraftLinearFuel)
CDDP_OPEN_LOOP_ROLLOUT(sc_nonlinear, SpacecraftNonlinear)
CDDP_OPEN_LOOP_ROLLOUT(sc_landing2d, SpacecraftLanding2D)
CDDP_OPEN_LOOP_ROLLOUT(sc_twobody, SpacecraftTwobody)
CDDP_OPEN_LOOP_ROLLOUT(bicycle, Bicycle)
CDDP_OPEN_LOOP_ROLLOUT(dubins_car, DubinsCar)
CDDP_OPEN_LOOP_ROLLOUT(dreyfus_rocket, DreyfusRocket)
CDDP_OPEN_LOOP_ROLLOUT(acrobot, Acrobot)
