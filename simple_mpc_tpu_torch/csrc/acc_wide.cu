// K11 at wide shapes: csrc/acc.cu compiled again over csrc/stage_wide.cuh
// (32 joints, force size 3 or 6: Talos's two 6D feet), in the namespace
// smpc_wide, with its C entry points renamed smpc_wide_state_derivative_*.
// stage_wide.cuh sets the limits and includes stage.cuh first, so acc.cu's
// own include of it is skipped (#pragma once) and its `namespace smpc`
// opens smpc_wide.
#include "stage_wide.cuh"

#define smpc smpc_wide
#define smpc_state_derivative_f32 smpc_wide_state_derivative_f32
#define smpc_state_derivative_f64 smpc_wide_state_derivative_f64
#include "acc.cu"
