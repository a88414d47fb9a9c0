// The whole MSIPDDP solve's instantiations for the small models' control
// boxes (mega_ipddp.MS_BOX_ROWS: the bicycle's m4, DubinsCar's and
// DreyfusRocket's m2; goal form; the kernel template: msipddp_solve.cuh),
// a translation unit of their own so that nvcc builds them beside
// msipddp_solve.cu. The port takes them up to the JAX gate's horizons
// (rollout.WHOLE_MAX_HORIZON), which kernel 8 is held to for the first
// time here. The acrobot's is left out (ROADMAP C.14).
#include "msipddp_solve.cuh"

CDDP_MSIPDDP_SOLVE(bicycle, Bicycle, 4, false, )
CDDP_MSIPDDP_SOLVE(dubins_car, DubinsCar, 2, false, )
CDDP_MSIPDDP_SOLVE(dreyfus_rocket, DreyfusRocket, 2, false, )
