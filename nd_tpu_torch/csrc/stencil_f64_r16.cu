// The stencil's unrolled builds (stencil.cuh, launch_grid) for double at a
// run of 16 outputs.

#define ND_STENCIL_GRID
#include "stencil.cuh"

namespace nd_stencil {
template int launch_grid<double, 16>(int, int, const double*, double*,
                                   const double*, const Taps<double>&,
                                   const Geo&, int, double, cudaStream_t);
}  // namespace nd_stencil
