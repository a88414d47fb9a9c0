// (nx, nu, m) of ipddp_riccati.KERNEL_SHAPES: the unicycle with a control
// box (m=4), a state box (6), both (10), or a control box and a keep-out
// ball (5); the pendulum with its control box (2, 1, 2); the car's (4, 2,
// 4); the quadrotor's (13, 4, 8) and QuadrotorRate's (10, 4, 8) boxes (the
// attitude trio's in ipddp_backward_attitude.cu). The kernel template:
// ipddp_backward.cuh.
#include "ipddp_backward.cuh"

CDDP_IPDDP_BACKWARD(3, 2, 4)
CDDP_IPDDP_BACKWARD(3, 2, 5)
CDDP_IPDDP_BACKWARD(3, 2, 6)
CDDP_IPDDP_BACKWARD(3, 2, 10)
CDDP_IPDDP_BACKWARD(2, 1, 2)
CDDP_IPDDP_BACKWARD(4, 2, 4)
CDDP_IPDDP_BACKWARD(13, 4, 8)
CDDP_IPDDP_BACKWARD(10, 4, 8)
