// K4's line search on the centroidal formulation: line_search_select of
// csrc/linesearch.cu compiled again over csrc/centroidal.cuh, in the
// namespace smpc_cent, with its C entry points renamed
// smpc_centroidal_line_search_select_*.  The merit, the argmin, the pick,
// prim and the BCL update are linesearch.cu's; what it reads of the model
// comes from centroidal.cuh: the terminal AL cost is the 6 momentum rows
// (no terminal equality; the wrapper packs the terminal params as
// x_ref = [com_ref; linmom_ref; angmom_ref]), the x0 gap is the vector
// space's x0 - x, and Dims's nq = 9, nv = 0 with SMPC_LS_NDX = nq + nv make
// the state and its tangent 9 wide.  stage.cuh is included first in its
// own namespace, so linesearch.cu's include of it is skipped (#pragma
// once) and its `namespace smpc` names smpc_cent; SMPC_SELECT_ONLY leaves
// out the free-flyer candidate_integrate and state_difference
// (csrc/centroidal.cu has the vector-space ones).
#include "stage.cuh"
#include "centroidal.cuh"

#define smpc smpc_cent
#define SMPC_SELECT_ONLY
#define SMPC_LS_NDX(nq, nv) (nq + nv)
#define smpc_line_search_select_f32 smpc_centroidal_line_search_select_f32
#define smpc_line_search_select_f64 smpc_centroidal_line_search_select_f64
#include "linesearch.cu"
