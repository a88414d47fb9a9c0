// The condensed IPDDP backward's instantiations for the spacecraft models'
// control boxes (ipddp_riccati.KERNEL_SHAPES: 8, 3, 6 for
// SpacecraftLinearFuel; 10, 3, 6 for SpacecraftNonlinear; 6, 2, 4 for
// SpacecraftLanding2D; SpacecraftTwobody takes the attitude trio's 6, 3, 6),
// a translation unit of their own so that nvcc builds them beside the
// others (the kernel template: ipddp_backward.cuh).
#include "ipddp_backward.cuh"

CDDP_IPDDP_BACKWARD(8, 3, 6)
CDDP_IPDDP_BACKWARD(10, 3, 6)
CDDP_IPDDP_BACKWARD(6, 2, 4)
