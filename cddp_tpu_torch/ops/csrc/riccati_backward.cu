// The streamed CLDDP backward pass in its one-thread form (the kernel
// template: riccati_backward.cuh), and the library's exports.
#include "riccati_backward.cuh"

// The library's error-string and attribute exports (one copy per library).
#include "library_exports.cuh"

// (nx, nu) of riccati.KERNEL_SHAPES whose step fits one thread's registers:
// the unicycle (3, 2), the pendulum (2, 1), the cart-pole (4, 1), the car
// and the default LTISystem (4, 2), the attitude trio (6, 3: Euler angles
// and MRPs; 7, 3: the quaternion), SpacecraftLanding2D (6, 2;
// SpacecraftTwobody takes 6, 3), SpacecraftLinearFuel (8, 3) and DubinsCar
// (3, 1; the other small models take 4, 2, 2, 1 and 4, 1). From nu = 3 the
// BoxQP walks its 27 active sets in a runtime loop. The shapes whose step
// one thread spills take the team form (riccati_backward_team.cu).
CDDP_RICCATI_BACKWARD(3, 2)
CDDP_RICCATI_BACKWARD(2, 1)
CDDP_RICCATI_BACKWARD(4, 1)
CDDP_RICCATI_BACKWARD(4, 2)
CDDP_RICCATI_BACKWARD(6, 3)
CDDP_RICCATI_BACKWARD(7, 3)
CDDP_RICCATI_BACKWARD(6, 2)
CDDP_RICCATI_BACKWARD(8, 3)
CDDP_RICCATI_BACKWARD(3, 1)
