// K4's line search at wide shapes: line_search_select of csrc/linesearch.cu
// compiled again over csrc/stage_wide.cuh (32 joints, force size 3 or 6:
// Talos's two 6D feet), in the namespace smpc_wide, with its C entry points
// renamed smpc_wide_*.  It alone reads the model (the terminal state's
// kinematics and centroidal momentum, whose arrays stage.cuh sizes at its
// joint limit); candidate_integrate and state_difference read nq and nv
// alone and serve every model from linesearch.cu, so SMPC_SELECT_ONLY
// leaves them out here.  stage_wide.cuh includes stage.cuh first at the
// wide limits, so linesearch.cu's own include of it is skipped (#pragma
// once) and its `namespace smpc` names smpc_wide.
#include "stage_wide.cuh"

#define smpc smpc_wide
#define SMPC_SELECT_ONLY
#define smpc_line_search_select_f32 smpc_wide_line_search_select_f32
#define smpc_line_search_select_f64 smpc_wide_line_search_select_f64
#include "linesearch.cu"
