// K10 at wide shapes: csrc/sim.cu compiled again over csrc/stage_wide.cuh
// (up to 32 joints: Talos's 23), in the namespace smpc_wide, with its C
// entry points renamed smpc_wide_sim_step_*.  The contacts stay 3D points
// (fulldyn.cuh's constrained dynamics, as the JAX simulator's
// contact_dim=3); only the joint limit grows.  stage_wide.cuh includes
// stage.cuh first at the wide limits, so the includes of sim.cu and
// fulldyn.cuh find it done (#pragma once) and their `namespace smpc`
// opens smpc_wide.
#include "stage_wide.cuh"

#define smpc smpc_wide
#define smpc_sim_step_f32 smpc_wide_sim_step_f32
#define smpc_sim_step_f64 smpc_wide_sim_step_f64
#include "sim.cu"
