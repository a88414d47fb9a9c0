// The condensed IPDDP backward's instantiations for the attitude trio's
// torque box (ipddp_riccati.KERNEL_SHAPES: 6, 3, 6 for Euler angles and
// MRPs; 7, 3, 6 for the quaternion), a translation unit of their own so that
// nvcc builds them beside ipddp_backward.cu (the kernel template:
// ipddp_backward.cuh).
#include "ipddp_backward.cuh"

CDDP_IPDDP_BACKWARD(6, 3, 6)
CDDP_IPDDP_BACKWARD(7, 3, 6)
