// K9 at wide shapes: csrc/tick.cu compiled again over csrc/stage_wide.cuh
// (32 joints, 8 feet, force size 3 or 6: Talos's 23 joints and two 6D quad
// feet), in the namespace smpc_wide, with its C entry points renamed
// smpc_wide_tick_refs_*.  The tick reads the measured positions alone (the
// FK of the base, the feet and the "<foot>_ref" frames), so only the joint
// limit of stage.cuh's kinematics matters here; the force size reaches it
// through the packed constants' layout.  stage_wide.cuh includes stage.cuh
// first at the wide limits, so tick.cu's own include of it is skipped
// (#pragma once) and its `smpc::` names smpc_wide.
#include "stage_wide.cuh"

#define smpc smpc_wide
#define smpc_tick_refs_f32 smpc_wide_tick_refs_f32
#define smpc_tick_refs_f64 smpc_wide_tick_refs_f64
#include "tick.cu"
