// The condensed IPDDP backward's instantiations for the small models'
// control boxes (ipddp_riccati.KERNEL_SHAPES: 3, 1, 2 for DubinsCar; 4, 1,
// 2 for the acrobot; the bicycle and DreyfusRocket take the car's 4, 2, 4
// and the pendulum's 2, 1, 2), a translation unit of their own so that
// nvcc builds them beside the others (the kernel template:
// ipddp_backward.cuh).
#include "ipddp_backward.cuh"

CDDP_IPDDP_BACKWARD(3, 1, 2)
CDDP_IPDDP_BACKWARD(4, 1, 2)
