// The whole MSIPDDP solve's instantiations but the small models' (the
// kernel template: msipddp_solve.cuh; those in msipddp_solve_small.cu).
#include "msipddp_solve.cuh"

CDDP_MSIPDDP_SOLVE(unicycle, Unicycle, 4, false, )
CDDP_MSIPDDP_SOLVE(unicycle, Unicycle, 6, false, )
CDDP_MSIPDDP_SOLVE(unicycle, Unicycle, 10, false, )
CDDP_MSIPDDP_SOLVE(unicycle, Unicycle, 4, true, _track)
CDDP_MSIPDDP_SOLVE(unicycle, Unicycle, 6, true, _track)
CDDP_MSIPDDP_SOLVE(unicycle, Unicycle, 10, true, _track)
CDDP_MSIPDDP_SOLVE(pendulum, Pendulum, 2, false, )
CDDP_MSIPDDP_SOLVE(pendulum, Pendulum, 2, true, _track)
