// The whole LogDDP solve's instantiation for the fuel model's control box
// (mega_ipddp.LOG_BOX_ROWS: m6; goal form; the kernel template:
// logddp_solve.cuh), a translation unit of its own so that nvcc builds it
// beside logddp_solve.cu. The other spacecraft models are left out
// (ROADMAP C.13).
#include "logddp_solve.cuh"

CDDP_LOGDDP_SOLVE(sc_linear_fuel, SpacecraftLinearFuel, 6, false, )
static_assert(cddp::logddp_solve_smem<double, cddp::SpacecraftLinearFuel>() <= 232448,
              "a block's staging must fit its shared memory");
