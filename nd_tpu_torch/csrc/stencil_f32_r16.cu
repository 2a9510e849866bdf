// The stencil's unrolled builds (stencil.cuh, launch_grid) for float at a
// run of 16 outputs.

#define ND_STENCIL_GRID
#include "stencil.cuh"

namespace nd_stencil {
template int launch_grid<float, 16>(int, int, const float*, float*,
                                   const float*, const Taps<float>&,
                                   const Geo&, int, float, cudaStream_t);
}  // namespace nd_stencil
