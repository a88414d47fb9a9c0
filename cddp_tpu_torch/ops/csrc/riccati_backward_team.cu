// The streamed CLDDP backward pass in its team form (the kernel template:
// riccati_team.cuh), a translation unit of its own so that nvcc builds it
// beside the others: riccati.TEAM_SHAPES, the quadrotor (13, 4),
// QuadrotorRate (10, 4) and SpacecraftNonlinear (10, 3), in teams of 16
// lanes.
#include "riccati_team.cuh"

CDDP_RICCATI_BACKWARD_TEAM(13, 4, 16)
CDDP_RICCATI_BACKWARD_TEAM(10, 4, 16)
CDDP_RICCATI_BACKWARD_TEAM(10, 3, 16)
